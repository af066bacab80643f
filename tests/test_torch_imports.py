"""The port stands alone: `repro_torch` and `chip_smoke.py` import neither
`jax`, `repro` nor `networkx`; no library attention in the port (only
`chip_smoke.py` times one, as a yardstick), no `torch.compile`, no `try:`
around a kernel launch; and without a GPU `device=None` raises instead of
running on the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN_MODULES = ("jax", "jaxlib", "repro", "networkx")


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def test_package_has_the_slices_modules():
    names = set(_module_names())
    for want in (
        "repro_torch.compat", "repro_torch.configs.base",
        "repro_torch.configs.qwen2_0_5b", "repro_torch.kernels.ref",
        "repro_torch.kernels.build", "repro_torch.kernels.mixing_combine",
        "repro_torch.kernels.ops", "repro_torch.core.mixing",
        "repro_torch.core.gossip", "repro_torch.core.dpsgd",
        "repro_torch.core.priced_training", "repro_torch.models.layers",
        "repro_torch.models.attention", "repro_torch.models.blocks",
        "repro_torch.models.model", "repro_torch.models.convert",
        "repro_torch.data.synthetic", "repro_torch.configs.gemma2_2b",
        "repro_torch.kernels.flash_attention",
        "repro_torch.kernels.decode_attention", "repro_torch.launch",
        "repro_torch.launch.serve", "repro_torch.analysis",
        "repro_torch.analysis.contracts", "repro_torch.net",
        "repro_torch.net.topology", "repro_torch.net.demands",
        "repro_torch.net.categories", "repro_torch.net.routing",
        "repro_torch.net.simulator", "repro_torch.net.stochastic",
        "repro_torch.net.torch_engine", "repro_torch.core.weight_opt",
        "repro_torch.core.fmmd", "repro_torch.core.sca",
        "repro_torch.core.topology_baselines", "repro_torch.core.designer",
        "repro_torch.paper", "repro_torch.paper.scenario",
        "repro_torch.paper.fig5_training",
        "repro_torch.paper.priced_training", "repro_torch.optim",
        "repro_torch.optim.sgd", "repro_torch.optim.schedule",
        "repro_torch.optim.adamw", "repro_torch.launch.mesh",
        "repro_torch.launch.fabric", "repro_torch.launch.train",
        "repro_torch.data", "repro_torch.data.pipeline",
        "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
        "repro_torch.models.moe", "repro_torch.configs.mixtral_8x7b",
        "repro_torch.configs.mixtral_8x22b", "repro_torch.configs.qwen1_5_0_5b",
        "repro_torch.configs.mistral_large_123b", "repro_torch.models.ssm",
        "repro_torch.configs.jamba_1_5_large_398b",
        "repro_torch.configs.xlstm_125m", "repro_torch.configs.llava_next_34b",
        "repro_torch.configs.musicgen_large", "repro_torch.runtime",
        "repro_torch.runtime.events", "repro_torch.runtime.faultinject",
        "repro_torch.runtime.stragglers", "repro_torch.runtime.compression",
        "repro_torch.runtime.fault_tolerance",
        "repro_torch.runtime.design_service", "repro_torch.launch.sharding",
        "repro_torch.models.sharding_hints",
    ):
        assert want in names
    for src in ("mixing_combine", "flash_attention_wgmma",
                "flash_attention_ffma", "decode_attention",
                "decode_attention_mma"):
        assert (PKG / "kernels" / "csrc" / f"{src}.cu").is_file()


def test_importing_everything_pulls_no_forbidden_module():
    """In a fresh interpreter, so this process's own jax does not count."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for name in {_module_names()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN_MODULES!r}]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('IMPORTS_OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "IMPORTS_OK" in proc.stdout


def test_net_imports_scipy_only_on_use():
    """``repro_torch.net`` and its engine import no scipy at load (the
    reference imports it inside ``route_milp``; the port's topology does
    the same inside ``random_geometric_graph``)."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import repro_torch.net, repro_torch.net.torch_engine\n"
        "import repro_torch.core.priced_training\n"
        "assert 'scipy' not in sys.modules, sorted(\n"
        "    m for m in sys.modules if m.startswith('scipy'))\n"
        "from repro_torch.net import random_geometric_underlay\n"
        "random_geometric_underlay(6, seed=0)\n"
        "assert 'scipy' in sys.modules\n"
        "print('LAZY_OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "LAZY_OK" in proc.stdout


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_ast_scan(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            roots = []
        assert not set(roots) & set(FORBIDDEN_MODULES), (path, roots)
        # no library attention (chip_smoke.py times one as a yardstick
        # beside the kernel), no compiler standing in for a kernel
        yardstick = path.name == "chip_smoke.py"
        if isinstance(node, ast.Attribute):
            assert yardstick or node.attr != "scaled_dot_product_attention", path
            assert not (
                node.attr == "compile"
                and isinstance(node.value, ast.Name)
                and node.value.id == "torch"
            ), path
        if isinstance(node, ast.Name):
            assert node.id != "scaled_dot_product_attention", path
        # a kernel launch is never wrapped in a `try` that could fall back
        assert not isinstance(node, ast.Try), (path, node.lineno)


LAUNCHER_SLICE = (
    "optim/__init__.py", "optim/sgd.py", "optim/schedule.py",
    "optim/adamw.py", "launch/mesh.py", "launch/fabric.py", "launch/train.py",
    "launch/sharding.py", "launch/serve.py", "models/sharding_hints.py",
    "data/pipeline.py", "checkpoint/__init__.py", "checkpoint/checkpoint.py",
)


@pytest.mark.parametrize("rel", LAUNCHER_SLICE)
def test_ast_scan_covers_the_launcher_slice(rel):
    """The launcher's modules are among the scanned sources (no forbidden
    import, no `try`), and hold no JAX-only name."""
    path = PKG / rel
    assert path in SOURCES
    names = {n.id for n in ast.walk(ast.parse(path.read_text()))
             if isinstance(n, ast.Name)}
    assert not names & {"jnp", "jax", "NamedSharding", "PartitionSpec"}


def test_sparse_gossip_goes_through_the_kernel():
    """`gossip.mix_sparse` reaches the stacked kernel's entry and mixes
    nothing itself; the launcher's `sparse` mode calls `mix_sparse`."""
    src = (PKG / "core" / "gossip.py").read_text()
    fn = next(
        n for n in ast.walk(ast.parse(src))
        if isinstance(n, ast.FunctionDef) and n.name == "mix_sparse"
    )
    attrs = {n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)}
    assert "mixing_sgd_combine_stacked" in attrs
    assert not attrs & {"addmm", "einsum", "matmul", "index_select"}
    train_src = (PKG / "launch" / "train.py").read_text()
    mix = next(
        n for n in ast.walk(ast.parse(train_src))
        if isinstance(n, ast.FunctionDef) and n.name == "mix_fn"
    )
    assert "mix_sparse" in {
        n.attr for n in ast.walk(mix) if isinstance(n, ast.Attribute)}


def test_default_update_calls_no_dense_mixing_on_the_fused_path():
    """`fused_update` (the default eq. (2) path) reaches the kernel wrapper
    and names neither `addmm` nor `einsum`."""
    src = (PKG / "core" / "dpsgd.py").read_text()
    fn = next(
        n for n in ast.walk(ast.parse(src))
        if isinstance(n, ast.FunctionDef) and n.name == "fused_update"
    )
    attrs = {n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)}
    assert "mixing_sgd_combine_stacked" in attrs
    assert not attrs & {"addmm", "einsum", "matmul"}


@pytest.mark.parametrize(
    "fn,kernel", [("prefill_cache", "flash_attention"),
                  ("apply_decode", "decode_attention")],
)
def test_serving_attention_goes_through_the_kernel(fn, kernel):
    """Prefill and decode reach the kernel wrapper and compute no attention
    of their own (no einsum, softmax or matmul)."""
    src = (PKG / "models" / "attention.py").read_text()
    node = next(
        n for n in ast.walk(ast.parse(src))
        if isinstance(n, ast.FunctionDef) and n.name == fn
    )
    attrs = {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}
    assert kernel in attrs
    assert not attrs & {"einsum", "softmax", "matmul", "_sdpa",
                        "_sdpa_chunked"}


def _no_gpu():
    return not torch.cuda.is_available()


@pytest.mark.parametrize(
    "entry", ["resolve_device", "model_init", "mixing_plan", "train_priced",
              "train", "params_from_jax", "init_caches",
              "build_serve_artifacts", "caches_from_jax",
              "optimize_weights", "design", "gate_main",
              "build_train_artifacts", "prefetcher", "combine_without_g",
              "design_mixing_matrix", "checkpoint_restore",
              "design_service"],
)
def test_device_none_raises_without_a_gpu(entry, tmp_path):
    from repro_torch import checkpoint, compat
    from repro_torch.configs import qwen2_0_5b
    from repro_torch.configs.base import DECODE_32K
    from repro_torch.core import designer, dpsgd, priced_training, weight_opt
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import Prefetcher
    from repro_torch.kernels import ops
    from repro_torch.launch import fabric, mesh, serve, train
    from repro_torch.paper import priced_training as gate
    from repro_torch.models import convert, model

    if not _no_gpu():
        assert compat.resolve_device(None).type == "cuda"
        return
    cfg = qwen2_0_5b.SMOKE_CONFIG
    with pytest.raises(compat.NoCudaDeviceError):
        if entry == "resolve_device":
            compat.resolve_device(None)
        elif entry == "model_init":
            model.init(cfg, 0)
        elif entry == "mixing_plan":
            dpsgd.mixing_plan(np.eye(2))
        elif entry == "train_priced":
            priced_training.train_priced(
                {}, None, None, np.eye(2), priced_training.StaticTau(1.0), 1
            )
        elif entry == "train":
            dpsgd.train({}, None, None, np.eye(2), 1)
        elif entry == "params_from_jax":
            convert.params_from_jax({}, cfg)
        elif entry == "init_caches":
            model.init_caches(cfg, 1, 8)
        elif entry == "build_serve_artifacts":
            serve.build_serve_artifacts(cfg, DECODE_32K)
        elif entry == "optimize_weights":
            weight_opt.optimize_weights(3, [(0, 1), (1, 2)])
        elif entry == "design":
            designer.design("ring", None, 1.0, 4)
        elif entry == "gate_main":
            gate.main([])
        elif entry == "build_train_artifacts":
            train.build_train_artifacts(
                cfg, TrainConfig(), DECODE_32K, mesh.make_test_mesh((1, 1)))
        elif entry == "prefetcher":
            Prefetcher(lambda step: {"tokens": np.zeros((1, 2), np.int32)})
        elif entry == "combine_without_g":
            # the sparse gossip's tables are built for device=None first
            plan = dpsgd.mixing_plan(np.full((2, 2), 0.5))
            ops.mixing_sgd_combine_stacked(
                torch.zeros(2, 4), plan.idx, plan.weights)
        elif entry == "design_mixing_matrix":
            fabric.design_mixing_matrix(4, link_bw=1.0, cross_pod_bw=1.0)
        elif entry == "design_service":
            from repro_torch.net import (build_overlay, lowest_degree_nodes,
                                         roofnet_like)
            from repro_torch.runtime.design_service import DesignService

            u = roofnet_like(seed=0)
            DesignService(build_overlay(u, lowest_degree_nodes(u, 4)), 1e6)
        elif entry == "checkpoint_restore":
            checkpoint.save(str(tmp_path), 1, {"w": torch.zeros(2)})
            checkpoint.restore(str(tmp_path), {"w": torch.zeros(2)})
        else:
            convert.caches_from_jax({}, cfg)


def test_explicit_cpu_and_dtype_names():
    from repro_torch import compat

    assert compat.resolve_device("cpu") == torch.device("cpu")
    assert compat.dtype_of("bfloat16") is torch.bfloat16
    assert compat.dtype_of(torch.float32) is torch.float32
    with pytest.raises(ValueError):
        compat.dtype_of("float8")


def test_build_is_importable_and_raises_without_nvcc(tmp_path, monkeypatch):
    """No quiet fallback when the build cannot happen: the error reaches the
    caller. (Where nvcc exists this only checks the library's name.)"""
    from repro_torch.kernels import build

    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert build.build_dir() == ROOT / "build" / "repro_torch"
    # An installed copy has no checkout around it and must be told where.
    installed = tmp_path / "site-packages" / "repro_torch" / "kernels"
    monkeypatch.setattr(build, "__file__", str(installed / "build.py"))
    with pytest.raises(build.KernelCompileError, match="REPRO_TORCH_BUILD_DIR"):
        build.build_dir()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    lib = build.library_path("mixing_combine")
    assert lib.parent == tmp_path and lib.name.startswith("libmixing_combine-")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    with pytest.raises(build.KernelCompileError):
        build.source_path("no_such_kernel")
    monkeypatch.setenv("PATH", str(tmp_path))
    if not pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(build.KernelCompileError, match="nvcc not found"):
            build.build("mixing_combine")


def test_chip_smoke_refuses_without_a_gpu():
    if not _no_gpu():
        pytest.skip("a GPU is present: chip_smoke.py would run in full")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT),
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
