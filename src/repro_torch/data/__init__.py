"""Data: synthetic non-IID token streams and the stacked input pipeline."""

from repro_torch.data.pipeline import Prefetcher, make_batch_fn
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream

__all__ = ["DataConfig", "Prefetcher", "SyntheticTokenStream", "make_batch_fn"]
