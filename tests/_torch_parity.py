"""Shared helpers of the port's parity tests (tests/test_torch_*.py): one
set of parameters and tokens, made once, handed to both packages."""

import jax
import numpy as np

from repro.configs import qwen2_0_5b as jax_cfg
from repro.models import model as jax_model
from repro_torch.configs import qwen2_0_5b as torch_cfg
from repro_torch.core import mixing
from repro_torch.data.synthetic import DataConfig, SyntheticTokenStream
from repro_torch.models import convert
from repro_torch.tree import tree_paths

JCFG = jax_cfg.SMOKE_CONFIG
TCFG = torch_cfg.SMOKE_CONFIG


def smoke_params(seed=0):
    """(JAX params, the same values as the port's dict on the CPU)."""
    jp = jax_model.init(JCFG, jax.random.key(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    return jp, tp


def ring(m, alpha=1.0 / 3.0):
    links = [(i, (i + 1) % m) for i in range(m)]
    return mixing.matrix_from_weights(m, links, [alpha] * m)


def stream(m, seq=16):
    return SyntheticTokenStream(
        DataConfig(vocab_size=JCFG.vocab_size, seq_len=seq, num_agents=m,
                   dirichlet_alpha=0.3, seed=1)
    )


def max_param_diff(jax_params, torch_params):
    """Largest |difference| over all leaves, matched by key path."""
    a = dict(tree_paths(jax.tree.map(np.asarray, jax_params)))
    b = dict(tree_paths(convert.params_to_jax(torch_params)))
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)
