"""Data (``repro.data``): synthetic document corpora with planted
semantics, and the LM trainer's deterministic batches."""
from repro_torch.data.loader import (BatchSpec, SyntheticLMLoader,
                                     device_batch, hash_tokenize)
from repro_torch.data.synthetic import (Corpus, Query, make_corpus,
                                       make_query, make_workload)

__all__ = ["BatchSpec", "Corpus", "Query", "SyntheticLMLoader",
           "device_batch", "hash_tokenize", "make_corpus", "make_query",
           "make_workload"]
