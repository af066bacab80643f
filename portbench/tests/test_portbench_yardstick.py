"""The yardstick's arithmetic against hand computations, the frozen W and
the token stream."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from portbench import peaks
from portbench.harness import _module
from portbench.reference import dense_lm, xlstm
from portbench.tokens import TokenStream
from repro_torch.configs import xlstm_125m

HERE = pathlib.Path(__file__).resolve().parents[1]
QWEN2 = json.loads((HERE / "configs/qwen2-0.5b.json").read_text())["model"]
# no cell runs xLSTM yet: the program's 12-block configuration
XLSTM = {**dataclasses.asdict(xlstm_125m.CONFIG),
         "block_pattern": list(xlstm_125m.CONFIG.block_pattern)}
MIX = json.loads((HERE / "traffic/dpsgd10-2x4096.json").read_text())


def metric(name):
    return _module(HERE / "metrics" / f"{name}.py", name)


def test_peaks_are_the_data_sheets():
    assert (peaks.BF16_TENSOR_FLOPS, peaks.FP32_FLOPS,
            peaks.HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)


def test_combine_bound_at_the_embedding_leaf():
    # x [8, 136 134 656] bf16 read once, out written once, at 3.35 TB/s
    bound = metric("combine_roofline.train").bound_s(8, 136_134_656, 2)
    assert bound * 1e3 == pytest.approx(1.300, abs=5e-4)


def test_qwen2_flops_a_token():
    # every kernel and the tied head: 494 032 768 parameters less the
    # 71 552 of norms and biases, which meet no product
    assert dense_lm.matmul_weights(QWEN2) == 494_032_768 - 71_552
    attention = 12 * 14 * 64 * 24 * (4096 + 1) / 2
    assert dense_lm.flops_per_token(QWEN2, 4096) == pytest.approx(
        6 * 493_961_216 + attention)
    assert dense_lm.flops_per_token(QWEN2, 4096) == pytest.approx(3.49e9, rel=2e-3)


def test_xlstm_flops_a_token():
    mlstm = 768 * 3072 + 3 * 4 * 384 * 384 + 2 * 768 * 4 + 1536 * 768
    weights = 3 * (3 * mlstm + 9 * 768 * 768) + 50304 * 768
    assert xlstm.matmul_weights(XLSTM) == weights == 102_389_760
    assert xlstm.flops_per_token(XLSTM, 4096) == pytest.approx(
        6 * weights + 12 * 4 * 384 * 9 * 4097 / 2)


def test_slstm_bound_by_hand():
    m = metric("slstm_roofline.train")
    rows, steps, d = 2, 4096, 768
    product = 2 * rows * steps * d * 4 * d / 989e12
    fwd = max(product + 24 * rows * steps * d / 67e12,
              (4 * rows * steps * 5 * d + 4 * d * d * 2) / 3.35e12)
    assert m.bound_s("slstm_fwd", rows, steps, d, 2) == pytest.approx(fwd)
    assert m.bound_s("slstm_bwd", rows, steps, d, 2) > fwd


class Trace:
    def __init__(self, ops):
        self.device_ops = ops
        self.busy_s = sum(d for _, _, d in ops)

    def durations(self, fragment):
        return [d for n, _, d in self.device_ops if fragment in n]


def test_readers_leave_out_what_they_cannot_read():
    reading = {"trace": None, "step_s": [], "window_s": 0.0,
               "profiled_steps": 1}
    for name in ("combine_roofline.train", "slstm_roofline.train",
                 "device_idle_share.train", "step_mfu.train"):
        assert metric(name).read(reading) is None


def test_idle_share_and_mfu():
    reading = {"trace": Trace([("k", 0.0, 1.5)]), "step_s": [2.0, 2.0],
               "window_s": 4.0, "profiled_steps": 1,
               "flops_per_token": 1e9, "tokens_per_step": 989_000}
    assert metric("device_idle_share.train").read(reading) == pytest.approx(25.0)
    assert metric("step_mfu.train").read(reading) == pytest.approx(50.0)


def test_frozen_mixing_matrix():
    w = np.array(MIX["mixing_matrix"])
    assert w.shape == (MIX["agents"],) * 2
    np.testing.assert_allclose(w.sum(axis=0), 1, atol=1e-12)
    np.testing.assert_allclose(w, w.T, atol=1e-12)
    off = {(i, j) for i, j in zip(*np.nonzero(np.abs(w - np.diag(np.diag(w))) > 1e-12)) if i < j}
    assert off == {tuple(link) for link in MIX["design"]["links"]}
    rho = np.sort(np.abs(np.linalg.eigvalsh(w - 1 / len(w))))[-1]
    assert rho == pytest.approx(MIX["design"]["rho"], rel=1e-9)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 3_000_000_001, -5])
def test_token_stream_is_the_seeds(seed):
    a = TokenStream(97, 3, seed).stacked(2, 1, 2, 8)
    b = TokenStream(97, 3, seed).stacked(2, 1, 2, 8)
    assert a.shape == (3, 1, 2, 9) and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, TokenStream(97, 3, seed + 1).stacked(2, 1, 2, 8))
    assert not np.array_equal(a, TokenStream(97, 3, seed).stacked(3, 1, 2, 8))
    assert len({row.tobytes() for row in a.reshape(-1, 9)}) == 6
