from repro_torch.data.synthetic import Corpus, Query, make_corpus, make_query

__all__ = ["Corpus", "Query", "make_corpus", "make_query"]
