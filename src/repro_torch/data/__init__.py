from .pipeline import (CorpusDataset, DataConfig, Prefetcher, make_iterator,
                       synth_batch)

__all__ = ["CorpusDataset", "DataConfig", "Prefetcher", "make_iterator",
           "synth_batch"]
