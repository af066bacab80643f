"""Port `data/pipeline.py` against the JAX package's: the stacked token
batches bitwise, and the prefetch thread's order, placement and close."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import SyntheticTokenStream as JStream
from repro_torch.data import DataConfig, Prefetcher, SyntheticTokenStream
from repro_torch.data import make_batch_fn


def _streams(agents, seq, vocab=97):
    kw = dict(vocab_size=vocab, seq_len=seq, num_agents=agents, seed=4)
    return JStream(JDataConfig(**kw)), SyntheticTokenStream(DataConfig(**kw))


@pytest.mark.parametrize("shape", [(4, 2, 1, 17), (1, 1, 3, 9), (3, 3, 2, 5)])
def test_make_batch_fn_bitwise(shape):
    js, ts = _streams(shape[0], shape[3] - 1)
    jfn = jpipe.make_batch_fn(
        js, {"tokens": jax.ShapeDtypeStruct(shape, jnp.int32)}, 97)
    tfn = make_batch_fn(
        ts, {"tokens": torch.empty(shape, dtype=torch.int32, device="meta")}, 97)
    for step in (0, 1, 7):
        want, got = jfn(step), tfn(step)
        assert got.keys() == want.keys() == {"tokens"}
        assert got["tokens"].dtype == want["tokens"].dtype == np.int32
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_patch_embeds_bitwise():
    shape, pe = (2, 1, 2, 9), (2, 1, 2, 4, 8)
    js, ts = _streams(2, 8)
    jfn = jpipe.make_batch_fn(js, {
        "tokens": jax.ShapeDtypeStruct(shape, jnp.int32),
        "patch_embeds": jax.ShapeDtypeStruct(pe, jnp.bfloat16)}, 97)
    tfn = make_batch_fn(ts, {
        "tokens": torch.empty(shape, dtype=torch.int32, device="meta"),
        "patch_embeds": torch.empty(pe, dtype=torch.bfloat16, device="meta")},
        97)
    want, got = jfn(3), tfn(3)
    np.testing.assert_array_equal(got["patch_embeds"], want["patch_embeds"])


def _batch_fn():
    _, ts = _streams(2, 8)
    return make_batch_fn(
        ts, {"tokens": torch.empty((2, 2, 1, 9), dtype=torch.int32,
                                   device="meta")}, 97)


@pytest.mark.parametrize("start,prefetch", [(0, 2), (5, 1), (3, 4)])
def test_prefetcher_yields_steps_in_order(start, prefetch):
    fn = _batch_fn()
    pf = Prefetcher(fn, "cpu", start_step=start, prefetch=prefetch)
    for want_step in range(start, start + 6):
        step, batch = next(pf)
        assert step == want_step
        assert isinstance(batch["tokens"], torch.Tensor)
        assert batch["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(batch["tokens"].numpy(),
                                      fn(want_step)["tokens"])
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_keeps_at_most_prefetch_batches():
    calls = []
    fn = _batch_fn()

    def counted(step):
        calls.append(step)
        return fn(step)

    pf = Prefetcher(counted, "cpu", prefetch=2)
    time.sleep(0.3)
    assert calls == [0, 1]          # full: the thread waits for a consumer
    next(pf)
    deadline = time.monotonic() + 5
    while len(calls) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert calls == [0, 1, 2]
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_surfaces_a_failing_batch_fn(monkeypatch):
    def broken(step):
        if step == 1:
            raise KeyError("no such batch")
        return _batch_fn()(step)

    seen = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: seen.append(args.exc_type))
    pf = Prefetcher(broken, "cpu")
    assert next(pf)[0] == 0
    with pytest.raises(RuntimeError, match="prefetch thread ended"):
        next(pf)
    assert seen == [KeyError]
    pf.close()
    with pytest.raises(ValueError):
        Prefetcher(broken, "cpu", prefetch=0)


def test_prefetcher_close_while_a_batch_is_made():
    """A batch the thread finishes after ``close()`` is dropped: the next
    ``next()`` stops instead of returning it."""
    fn = _batch_fn()
    entered, release = threading.Event(), threading.Event()

    def slow(step):
        if step == 1:
            entered.set()
            release.wait(timeout=5.0)
        return fn(step)

    pf = Prefetcher(slow, "cpu", prefetch=1)
    assert next(pf)[0] == 0
    assert entered.wait(timeout=5.0)
    threading.Timer(0.2, release.set).start()
    pf.close()                      # returns once the thread has ended
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)
