"""Host-side input pipeline: stacked batch assembly + prefetch.

Counterpart of the JAX package's ``data/pipeline.py``. ``make_batch_fn``
builds the stacked ``[A, k, mb, S+1]`` token batch of one step in numpy,
bitwise the reference's. ``Prefetcher`` keeps ``prefetch`` batches in
flight from a background thread, so step N+1's host work overlaps step
N's device work: where the reference places each batch with
``jax.device_put`` onto its shardings, the thread stages it in pinned
host memory (on a CUDA device) and copies it with
``.to(device, non_blocking=True)``.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch import compat
from repro_torch.data.synthetic import SyntheticTokenStream


def make_batch_fn(
    stream: SyntheticTokenStream,
    batch_shapes: Any,
    vocab_size: int,
) -> Callable[[int], dict]:
    """Build the stacked [A, k, mb, S+1] batch dict for one step."""
    tok_shape = batch_shapes["tokens"].shape

    def fn(step: int) -> dict:
        a, k, mb, s1 = tok_shape
        toks = np.stack(
            [
                np.stack(
                    [
                        stream.batch(agent, step * k + i, mb, s1 - 1)
                        for i in range(k)
                    ]
                )
                for agent in range(a)
            ]
        )
        batch = {"tokens": toks}
        if "patch_embeds" in batch_shapes:
            pe = batch_shapes["patch_embeds"]
            rng = np.random.default_rng((step, 0xBEEF))
            batch["patch_embeds"] = rng.standard_normal(tuple(pe.shape)).astype(
                np.float32
            )
        return batch

    return fn


def place(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy) as tensors on ``device``: through pinned memory
    and an asynchronous copy on a CUDA device."""
    out = {}
    for name, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            t = t.pin_memory()
        out[name] = t.to(device, non_blocking=True)
    return out


class Prefetcher:
    """Background-thread prefetch of device-placed batches.

    Iterating yields ``(step, batch)`` from ``start_step`` on, in order.
    ``close()`` stops the thread. If ``batch_fn`` raises, the thread
    prints its traceback and ends, and the next ``next()`` raises
    ``RuntimeError``.
    """

    def __init__(
        self,
        batch_fn: Callable[[int], dict],
        device: str | torch.device | None = None,
        start_step: int = 0,
        prefetch: int = 2,
    ):
        if prefetch < 1:
            raise ValueError(f"prefetch must be at least 1, got {prefetch}")
        self._fn = batch_fn
        self._device = compat.resolve_device(device)
        self._prefetch = prefetch
        self._ready: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(
            target=self._worker, args=(start_step,), daemon=True
        )
        self._thread.start()

    def _worker(self, step: int) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._stop or len(self._ready) < self._prefetch
                )
                if self._stop:
                    return
            batch = place(self._fn(step), self._device)
            with self._cv:
                if self._stop:          # closed while this batch was made
                    return
                self._ready.append((step, batch))
                self._cv.notify_all()
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        with self._cv:
            # A thread that died notifies nobody: look again every 0.1 s.
            while not (
                self._ready or self._stop or not self._thread.is_alive()
            ):
                self._cv.wait(timeout=0.1)
            if self._ready and not self._stop:
                item = self._ready.popleft()
                self._cv.notify_all()
                return item
        if self._stop:
            raise StopIteration
        raise RuntimeError(
            "the prefetch thread ended: its batch_fn raised (traceback above)"
        )

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._ready.clear()
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
