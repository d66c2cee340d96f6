from repro_torch.data.synthetic import (Corpus, Query, make_corpus,
                                       make_query, make_workload)

__all__ = ["Corpus", "Query", "make_corpus", "make_query", "make_workload"]
