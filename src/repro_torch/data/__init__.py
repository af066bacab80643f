"""Data: synthetic non-IID token streams."""

from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream

__all__ = ["DataConfig", "SyntheticTokenStream"]
