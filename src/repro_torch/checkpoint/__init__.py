"""Checkpoint/restore with atomic writes, retention, async saves — the
JAX package's on-disk layout."""

from repro_torch.checkpoint.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save"]
