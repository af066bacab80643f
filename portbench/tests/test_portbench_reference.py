"""The plain references against the program at its smoke configurations,
on the CPU: the same parameters and tokens give the same loss and
gradients. The program is imported here only, never by the references."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench.drivers.dpsgd_train import make_params
from portbench.reference import dense_lm, dpsgd, xlstm
from portbench.reference.common import Matmul, flatten, nest
from repro_torch.configs import qwen2_0_5b, xlstm_125m
from repro_torch.models import model as port_model

ARCHS = {"qwen2": (dense_lm, qwen2_0_5b), "xlstm": (xlstm, xlstm_125m)}


def _model(config) -> dict:
    m = dataclasses.asdict(config)
    m["block_pattern"] = list(m["block_pattern"])
    return m


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_reference_loss_and_gradients_match_program(name):
    arch, configs = ARCHS[name]
    model = _model(configs.SMOKE_CONFIG)
    shapes = arch.param_shapes(model)
    p0 = make_params(shapes, 11, torch.device("cpu"), torch.float32,
                     lambda path, shape: arch.init_rule(path, shape, model))
    tokens = torch.randint(0, model["vocab_size"], (2, 33),
                           generator=torch.Generator().manual_seed(2))
    leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    loss, _ = port_model.loss(configs.SMOKE_CONFIG, nest(leaves),
                              {"tokens": tokens.to(torch.int32)}, remat=False)
    loss.backward()
    stacked = {k: v[None].clone() for k, v in p0.items()}
    (_, ref_loss, ref_grads), = list(
        arch.agent_grads(stacked, tokens[None].to(torch.int64), model, Matmul()))
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-6)
    for k, g in ref_grads.items():
        torch.testing.assert_close(g, leaves[k].grad, rtol=1e-4, atol=1e-6,
                                   msg=lambda m: f"{k}: {m}")


@pytest.mark.parametrize("name,count", [("qwen2", 494_032_768),
                                        ("xlstm", 102_409_032)])
def test_parameter_tree_is_the_programs(name, count):
    arch, configs = ARCHS[name]
    model = _model(configs.CONFIG)
    shapes = arch.param_shapes(model)
    meta = port_model.init(configs.CONFIG, 0, device="meta")
    assert {k: tuple(v.shape) for k, v in flatten(meta).items()} == shapes
    assert sum(math.prod(s) for s in shapes.values()) == count


def _slstm_plain(pre_x, r):
    """sLSTM's loop as plain differentiable ops (autograd's backward)."""
    a, b, s, d4 = pre_x.shape
    d = d4 // 4
    h = pre_x.new_zeros(a, b, d)
    c, n = torch.zeros_like(h), torch.zeros_like(h)
    m = torch.full_like(h, float("-inf"))
    out = []
    for t in range(s):
        zt, it, ft, ot = (pre_x[:, :, t] + h @ r).chunk(4, dim=-1)
        lfm = F.logsigmoid(ft) + m
        m = torch.maximum(lfm, it)
        iw, fw = torch.exp(it - m), torch.exp(lfm - m)
        c = fw * c + iw * torch.tanh(zt)
        n = fw * n + iw
        h = torch.sigmoid(ot) * c / torch.maximum(n, torch.exp(-m) + 1e-6)
        out.append(h)
    return torch.stack(out, dim=2)


def test_slstm_loop_backward_is_autograds():
    gen = torch.Generator().manual_seed(4)
    pre_x = torch.randn(2, 3, 17, 4 * 5, generator=gen, dtype=torch.float64)
    r = torch.randn(2, 5, 4 * 5, generator=gen, dtype=torch.float64) * 0.5
    up = torch.randn(2, 3, 17, 5, generator=gen, dtype=torch.float64)
    a = (pre_x.clone().requires_grad_(), r.clone().requires_grad_())
    b = (pre_x.clone().requires_grad_(), r.clone().requires_grad_())
    (xlstm.SLSTMLoop.apply(*a, Matmul()) * up).sum().backward()
    (_slstm_plain(*b) * up).sum().backward()
    torch.testing.assert_close(a[0].grad, b[0].grad, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(a[1].grad, b[1].grad, rtol=1e-10, atol=1e-12)


def test_follow_is_sgd_momentum_then_gossip():
    """Two steps of a one-leaf model by hand: m = μ·m + g, x = x − lr·m,
    x = W x, the state stored in the configuration's dtype."""

    class Quadratic:
        @staticmethod
        def agent_grads(params, tokens, model, mm):
            for a in range(tokens.shape[0]):
                x = params[("x",)][a]
                target = tokens[a].to(x.dtype).mean()
                yield a, float(((x - target) ** 2).sum()), {("x",): 2 * (x - target)}

    w = np.array([[0.5, 0.5], [0.5, 0.5]])
    x0 = torch.tensor([1.0, -2.0])
    toks = [torch.tensor([[[3]], [[5]]]), torch.tensor([[[1]], [[0]]])]
    out = dpsgd.follow(Quadratic, {"param_dtype": "float32"}, {("x",): x0}, w,
                       toks, 0.1, 0.9)
    x = torch.stack([x0, x0])
    m = torch.zeros_like(x)
    for t in toks:
        g = 2 * (x - t.reshape(2, 1).to(torch.float32))
        m = 0.9 * m + g
        x = torch.tensor(w, dtype=torch.float32) @ (x - 0.1 * m)
    for a in range(2):
        assert out["change"][("x",)][a] == pytest.approx(float((x[a] - x0).norm()))
