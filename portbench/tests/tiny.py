"""A benchmark tree at a size the CPU runs in seconds, for the tests: the
repository's ``BENCHMARK.json`` and ``portbench/`` copied under a temporary
root, with a tiny configuration of each architecture, a tiny traffic mix
and a cell of each."""

from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]

MODELS = {
    "tiny-dense": ("dense_lm", {
        "name": "tiny-dense", "family": "dense", "num_layers": 2, "d_model": 32,
        "num_heads": 4, "num_kv_heads": 2, "d_ff": 64, "vocab_size": 97,
        "block_pattern": ["attn"], "head_dim": None, "sliding_window": None,
        "attn_logit_softcap": None, "final_logit_softcap": None,
        "qkv_bias": True, "rope_theta": 10000.0, "norm_eps": 1e-6,
        "tie_embeddings": True, "embed_scale": False, "num_experts": 0,
        "num_experts_per_token": 0, "capacity_factor": 1.25,
        "ssm_state_dim": 16, "ssm_conv_dim": 4, "ssm_expand": 2,
        "mlstm_heads": 4, "frontend": None, "num_patches": 576,
        "param_dtype": "float32", "compute_dtype": "float32"},
        {"agent_layout": "data_dp", "remat": "full", "learning_rate": 0.05,
         "momentum": 0.9, "gossip": "auto", "microbatch": 1,
         "moe_aux_weight": 0.01, "router_z_weight": 0.001}),
    "tiny-xlstm": ("xlstm", {
        "name": "tiny-xlstm", "family": "ssm", "num_layers": 4, "d_model": 32,
        "num_heads": 2, "num_kv_heads": 2, "d_ff": 0, "vocab_size": 97,
        "block_pattern": ["mlstm", "mlstm", "mlstm", "slstm"],
        "head_dim": None, "sliding_window": None, "attn_logit_softcap": None,
        "final_logit_softcap": None, "qkv_bias": False, "rope_theta": 1e6,
        "norm_eps": 1e-6, "tie_embeddings": True, "embed_scale": False,
        "num_experts": 0, "num_experts_per_token": 0, "capacity_factor": 1.25,
        "ssm_state_dim": 16, "ssm_conv_dim": 4, "ssm_expand": 2,
        "mlstm_heads": 2, "frontend": None, "num_patches": 576,
        "param_dtype": "float32", "compute_dtype": "float32"},
        {"agent_layout": "data", "remat": "full", "learning_rate": 0.05,
         "momentum": 0.9, "gossip": "auto", "microbatch": 4,
         "moe_aux_weight": 0.01, "router_z_weight": 0.001}),
}

RING4 = (np.eye(4) / 2 + np.roll(np.eye(4), 1, 1) / 4
         + np.roll(np.eye(4), -1, 1) / 4).tolist()

LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


def make_tree(tmp: pathlib.Path, seq_len: int = 12) -> pathlib.Path:
    """``tmp`` as a checkout holding the benchmark plus the tiny cells
    ``tiny-dense-cell`` and ``tiny-xlstm-cell``; returns it."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    mix = {"name": "tiny-mix", "driver": "dpsgd_train", "agents": 4,
           "rows": 2, "seq_len": seq_len, "num_topics": 4,
           "dirichlet_alpha": 0.3, "gossip": "sparse", "steps_followed": 3,
           "profiled_steps": 1, "mixing_matrix": RING4}
    (tmp / "portbench/traffic/tiny-mix.json").write_text(json.dumps(mix))
    for name, (arch, model, train) in MODELS.items():
        path = f"portbench/configs/{name}.json"
        (tmp / path).write_text(json.dumps(
            {"name": name, "arch": arch, "model": model, "train": train}))
        bench["configs"].append({"name": name, "source": "test", "file": path,
                                 "reduced": [], "why": "test"})
        cell = f"{name}-cell"
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny-mix", "chips": 1,
                                   "why": "test"})
        (tmp / f"portbench/limits/{cell}.json").write_text(
            json.dumps({"cell": cell, "limits": LIMITS}))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
