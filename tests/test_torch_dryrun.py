"""The dry run (`repro_torch.launch.dryrun`) and what it counts.

(a) The collective counter of `launch/mesh.py` against bytes computed by
    hand is held in the multi-rank modules, on the ranks they already
    run: the sparse gossip's sends in `test_torch_multirank.py`, FSDP's
    gather, its reduce-scattered backward and EP's all-to-all pair in
    `test_torch_multirank_pod.py`, tensor parallelism's all-reduces in
    `test_torch_multirank_tp.py`.
(b) The fake pass against the real run: the same step at the same mesh,
    on fake tensors over a fake process group (one process as rank 0),
    counts the bytes and calls of rank 0 of the real gloo run, its kernel
    launches and its parameter bytes (`dryrun_pod` at (2, 2, 2),
    `dryrun_serve` at (2, 2)).
(c) A production cell at 256 ranks ends `ok` with the reference's record
    keys, and an unsupported one is `skipped` with the reference's reason.
    Qwen2-0.5B × `train_4k` at 512 ranks, whose 8-row microbatches do not
    divide its 16 `model` ranks: rank 0 holds one row of each (the
    launcher's `RowSplit`), as at 256 ranks, and peaks within 1.25× of
    its 256-rank cell.
(d) The kernel wrappers on fake CUDA tensors: the kernel path's output
    layout, one fake call of the design a real call takes, nothing
    launched and no launch counted."""

import json
import math
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import get_config, get_shape, get_train_config
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import mixing_combine as mixing_mod
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, train
from repro_torch.roofline.analysis import COLLECTIVES

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 600
# case -> world size; each also runs as rank 0 of a fake group
CASES = {"dryrun_pod": 8, "dryrun_serve": 4}


def _launch(case: str, rank: int, world: int, init: str, inputs, out_dir):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_rank.py"), case,
         str(rank), str(world), init, str(inputs), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=str(ROOT), env=env)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{case: [rank0, rank1, …]} of the real gloo runs, and {case +
    "/fake": [rank 0 of the fake group]}."""
    work = tmp_path_factory.mktemp("dryrun")
    inputs = work / "none.npz"          # the cases read no input
    np.savez(inputs, none=np.zeros(1))
    procs = {}
    for case, world in CASES.items():
        out = work / case
        out.mkdir()
        init = f"file://{work / (case + '.rendezvous')}"
        procs[case] = (out, [_launch(case, r, world, init, inputs, out)
                             for r in range(world)])
        fake = work / (case + "_fake")
        fake.mkdir()
        procs[case + "/fake"] = (fake, [_launch(case, 0, world, "fake",
                                                inputs, fake)])
    got = {}
    for name, (out, ps) in procs.items():
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in ps]
        for p, log in zip(ps, logs):
            assert p.returncode == 0 and "RANK_OK" in log, log[-4000:]
        got[name] = []
        for r in range(len(ps)):
            with np.load(out / f"rank{r}.npz") as data:
                got[name].append(dict(data))
    return got


def _kinds(rank: dict, key: str) -> tuple[dict, dict]:
    return (dict(zip(COLLECTIVES, rank[f"{key}coll_bytes"].tolist())),
            dict(zip(COLLECTIVES, rank[f"{key}coll_calls"].tolist())))


# ---------------------------------------------------------------------------
# (b) the fake pass against rank 0 of the real run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,runs", [("dryrun_pod", ("train",)),
                                       ("dryrun_serve",
                                        ("prefill", "decode"))])
def test_fake_pass_counts_what_rank0_sends(ranks, case, runs):
    real, fake = ranks[case][0], ranks[case + "/fake"][0]
    for run in runs:
        sent, calls = _kinds(real, f"{run}/")
        assert sum(sent.values()) > 0
        assert _kinds(fake, f"{run}/") == (sent, calls), run
        assert np.array_equal(fake[f"{run}/launches"],
                              real[f"{run}/launches"])
        assert int(fake[f"{run}/param_bytes"]) == \
            int(real[f"{run}/param_bytes"]) > 0


def test_pod_layout_uses_every_data_parallel_collective(ranks):
    """The pod step at (2, 2, 2) gathers (FSDP), reduce-scatters (FSDP's
    backward), all-to-alls (EP), all-reduces (TP) and sends (gossip)."""
    sent, _ = _kinds(ranks["dryrun_pod"][0], "train/")
    assert all(sent[k] > 0 for k in COLLECTIVES), sent


# ---------------------------------------------------------------------------
# (c) production cells
# ---------------------------------------------------------------------------

_CELLS = """
import json, sys
from repro_torch.launch import dryrun as port
recs = [port.run_cell("qwen2-0.5b", "decode_32k", False, device="cpu",
                      verbose=False),
        port.run_cell("qwen2-0.5b", "long_500k", False, device="cpu",
                      verbose=False)]
from repro.launch import dryrun as ref
recs.append(ref.run_cell("qwen2-0.5b", "long_500k", False, verbose=False))
print("CELLS " + json.dumps(recs))
"""


@pytest.fixture(scope="module")
def cells():
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _CELLS], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT,
                          cwd=str(ROOT))
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("CELLS ")]
    assert proc.returncode == 0 and lines, proc.stderr[-4000:]
    return json.loads(lines[0][len("CELLS "):])


def test_production_decode_cell_is_ok_at_256_ranks(cells):
    rec = cells[0]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["mesh"] == "pod16x16"
    # the reference's serving record: arch, shape, mesh, chips, status,
    # lower_s, compile_s, memory, cost_flops, cost_bytes, roofline
    ref_keys = {"arch", "shape", "mesh", "chips", "status", "lower_s",
                "compile_s", "memory", "cost_flops", "cost_bytes",
                "roofline"}
    assert set(rec) == (ref_keys - {"cost_bytes", "lower_s", "compile_s"}) \
        | {"trace_s", "kernel_flops", "collectives", "launches"}
    mem = rec["memory"]
    assert mem["peak"] >= mem["parameters"] + mem["inputs"] > 0
    assert rec["cost_flops"] > 0
    sent = rec["collectives"]["bytes_by_kind"]
    assert sent["all-reduce"] > 0          # the model axis is 16 ranks
    roof = rec["roofline"]
    assert roof["peaks"] == {"flops": 989e12, "hbm_bytes_per_s": 3.35e12,
                             "link_bytes_per_s": 50e9}
    assert roof["collective_bytes_per_chip"] >= sum(sent.values())
    assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"],
                                  roof["collective_s"])


def test_unsupported_cell_is_skipped_with_the_references_reason(cells):
    assert cells[1] == cells[2]
    assert cells[1]["status"] == "skipped" and cells[1]["reason"]


def test_rows_that_do_not_divide_split_at_512_ranks(monkeypatch):
    """Qwen2-0.5B × ``train_4k`` (``data_dp``, one microbatch an agent) on
    fake CPU tensors: 16 rows an agent over 16 ``model`` ranks at
    ``pod16x16``, 8 rows at ``pod2x16x16`` (32 agents), where rank 0 now
    holds one row (g = 8) in place of all 8: an eighth of the agent's
    batch, and its peak within 1.25× of the 256-rank cell's."""
    arch = "qwen2-0.5b"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the cells' processes
    with ThreadPoolExecutor(2) as pool:
        recs = list(pool.map(
            lambda mp: dryrun.run_cell_process(arch, "train_4k", mp,
                                               device="cpu",
                                               budget_s=TIMEOUT),
            (False, True)))
    for rec in recs:
        assert rec["status"] == "ok", rec.get("traceback", rec.get("error"))
    one, two = recs
    assert two["num_agents"] == 32 and two["chips"] == 512
    shape, tcfg = get_shape("train_4k"), get_train_config(arch)
    agent = train._batch_shapes(get_config(arch), shape, 32,
                                tcfg.microbatch)["tokens"]
    k, mb = agent.shape[1:3]
    assert (k, mb) == (1, 8)
    agent_bytes = math.prod(agent.shape[1:]) * 4
    assert two["memory"]["inputs"] * 8 == agent_bytes
    assert one["memory"]["inputs"] == two["memory"]["inputs"]
    assert two["memory"]["peak"] <= 1.25 * one["memory"]["peak"]


# ---------------------------------------------------------------------------
# (d) the kernel wrappers' fake branch
# ---------------------------------------------------------------------------


@pytest.fixture
def nothing_launched(monkeypatch):
    """A launch would need the library: refuse it."""
    def refuse(*args, **kwargs):
        raise AssertionError("a fake tensor reached a kernel launch")

    for mod in (flash_mod, decode_mod, mixing_mod):
        monkeypatch.setattr(mod, "_library", refuse)
    ops.reset_launch_count()
    ops.reset_fake_calls()
    yield
    assert all(ops.launch_count(k) == 0 for k in ops.KERNELS)
    ops.reset_fake_calls()


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 256)])
def test_flash_attention_fake_branch(nothing_launched, dtype, d):
    b, h, kv, s = 2, 8, 2, 300
    with FakeTensorMode():
        q = torch.empty((b, s, h, d), dtype=dtype,
                        device="cuda").transpose(1, 2)
        k = torch.empty((b, kv, s, d), dtype=dtype, device="cuda")
        out = ops.flash_attention(q, k, k, window=128)
        want = torch.empty((b, s, h, d), dtype=dtype,
                           device="cuda").transpose(1, 2)
        assert out.shape == want.shape and out.stride() == want.stride()
        assert out.dtype == dtype and out.device.type == "cuda"
    name = flash_mod.design(dtype, d)
    assert flash_mod.fake_calls_by_design() == {
        n: int(n == name) for n in flash_mod.DESIGNS}
    assert flash_mod.launch_count_by_design() == dict.fromkeys(
        flash_mod.DESIGNS, 0)
    assert flash_mod.fake_flops() == flash_mod.work(
        q, k, True, 128)["flops"] == 4 * d * b * h * (
            flash_mod.live_pairs(s, s, True, 128))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_fake_branch(nothing_launched, dtype):
    b, h, kv, s, d = 3, 16, 4, 1000, 128
    with FakeTensorMode():
        q = torch.empty((b, h, 1, d), dtype=dtype, device="cuda")
        k = torch.empty((b, s, kv, d), dtype=dtype,
                        device="cuda").transpose(1, 2)
        length = torch.full((b,), 777, dtype=torch.int32, device="cuda")
        out = ops.decode_attention(q, k, k, length, softcap=30.0)
        want = torch.empty((b, 1, h, d), dtype=dtype,
                           device="cuda").transpose(1, 2)
        assert out.shape == want.shape and out.stride() == want.stride()
        assert out.dtype == dtype
        ops.decode_attention(q, k, k, 500)
    name = decode_mod.design(dtype, d)
    assert decode_mod.fake_calls_by_design() == {
        n: 2 * int(n == name) for n in decode_mod.DESIGNS}
    assert decode_mod.launch_count_by_design() == dict.fromkeys(
        decode_mod.DESIGNS, 0)
    # a tensor length counts the cache's depth, an int its own
    assert decode_mod.fake_flops() == 4 * d * h * b * (s + 500)


def test_mixing_combine_fake_branch(nothing_launched):
    a, n, r = 4, 1000, 2
    with FakeTensorMode():
        x = torch.empty((a, n), dtype=torch.bfloat16, device="cuda")
        g = torch.empty((a, n), dtype=torch.float32, device="cuda")
        idx = torch.zeros((a, r), dtype=torch.int32, device="cuda")
        w = torch.zeros((a, r + 1), dtype=torch.float32, device="cuda")
        out = ops.mixing_sgd_combine_stacked(x, idx, w, g, lr=0.1)
        assert out.shape == x.shape and out.dtype == x.dtype
        mixed = ops.mixing_sgd_combine_stacked(x, idx, w)
        assert mixed.shape == x.shape
        recv = torch.empty((r, n), dtype=torch.bfloat16, device="cuda")
        own = torch.empty((n,), dtype=torch.bfloat16, device="cuda")
        one = ops.mixing_sgd_combine(
            own, recv, torch.zeros((r + 1,), device="cuda"))
        assert one.shape == (n,) and one.dtype == torch.bfloat16
    assert mixing_mod.fake_call_count() == 3
    assert ops.launch_count("mixing_sgd_combine") == 0
    assert ops.fake_flops("mixing_sgd_combine") == (
        a * n * (2 * (r + 1) + 1) + a * n * 2 * (r + 1) + n * 2 * (r + 1))


def test_work_counts_match_the_chip_scripts_former_bounds():
    """The kernels' work counts give the numbers ``chip_smoke.py``'s
    bounds were computed from: live causal pairs as the sum over query
    rows, ``(2·q + 2·k)`` elements moved by flash, K/V up to ``length``
    plus q and o by decode, and the combine's bytes and FLOPs."""
    q = torch.empty((4, 8, 4096, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((4, 2, 4096, 64), dtype=torch.bfloat16, device="meta")
    for window in (None, 1024):
        pairs = 4 * 8 * sum(min(i + 1, window or i + 1)
                            for i in range(4096))
        got = flash_mod.work(q, k, True, window)
        assert got["pairs"] == pairs and got["flops"] == 4 * 64 * pairs
        assert got["bytes"] == (2 * q.numel() + 2 * k.numel()) * 2
    qd = torch.empty((4, 8, 1, 64), dtype=torch.bfloat16, device="meta")
    got = decode_mod.work(qd, k, 3000)
    assert got["bytes"] == (2 * 4 * 2 * 3000 * 64 + 2 * qd.numel()) * 2
    x = torch.empty((8, 1000), dtype=torch.bfloat16, device="meta")
    g = torch.empty((8, 1000), dtype=torch.float32, device="meta")
    idx = torch.empty((8, 3), dtype=torch.int32, device="meta")
    w = torch.empty((8, 4), dtype=torch.float32, device="meta")
    assert mixing_mod.stacked_work(x, idx, w, g) == {
        "flops": 8000 * 9, "bytes": 2 * 8000 * 2 + 8000 * 4 + 96 + 128}
    assert mixing_mod.work(x[0], 3, False) == {
        "flops": 1000 * 8, "bytes": 5 * 1000 * 2 + 4 * 4}
    assert math.isclose(flash_mod.live_pairs(10, 10, False, None), 100)
