"""Port `launch/sharding.py` and `models/sharding_hints.py` against the
JAX package's, on the host (no processes).

Every partition spec of every `ARCH_IDS` config — the stacked train
params and the train batch in each layout (`data`, `data_dp`, `pod`), the
serving params, decode caches and tokens — on both production meshes and
the (4, 2) and (2, 2, 2) test meshes must equal the reference's entry for
entry. The reference's meshes are `AbstractMesh`es and its shapes come
from `jax.eval_shape`; the port's from the `meta` device. Also the
divisibility guard of `sharding_hints.resolve` (held against the
reference's `constrain` with its `with_sharding_constraint` recorded),
`constrain` returning `x` itself, and `shard_tree` tiling a tree.
"""

import functools
import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import base as jbase
from repro.launch import sharding as jsharding
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.models import sharding_hints as jhints
from repro_torch.configs import base
from repro_torch.launch import mesh, sharding, train
from repro_torch.models import model, sharding_hints
from repro_torch.tree import tree_paths

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
}
LAYOUTS = ("data", "data_dp", "pod")
DECODE_SHAPES = (base.DECODE_32K, base.LONG_500K)


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), mesh.make_test_mesh(shape, axes)


def _want(tree) -> dict:
    """The reference's spec tree as ``{path: tuple}``."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    return {jsharding._path_str(p): tuple(s) for p, s in flat}


def _got(tree) -> dict:
    out = {}
    for path, spec in tree_paths(tree):
        assert isinstance(spec, sharding.P), path
        out[path] = tuple(spec)
    return out


@functools.lru_cache(maxsize=None)
def _train_shapes(arch, m):
    jcfg, tcfg = jbase.get_config(arch), base.get_config(arch)
    return (jtrain._stacked_state_shapes(jcfg, m)["params"],
            train._stacked_state_shapes(tcfg, m)["params"])


@functools.lru_cache(maxsize=None)
def _serve_shapes(arch):
    jcfg, tcfg = jbase.get_config(arch), base.get_config(arch)
    return (jax.eval_shape(lambda k: jmodel.init(jcfg, k), jax.random.key(0)),
            model.init(tcfg, 0, device="meta"))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_train_specs_match(arch, layout, mesh_name):
    jm, tm = _meshes(mesh_name)
    m = mesh.num_agents(tm, layout)
    jparams, tparams = _train_shapes(arch, m)
    want = _want(jsharding.param_specs_train(jparams, jm, layout))
    assert _got(sharding.param_specs_train(tparams, tm, layout)) == want
    # the batch, microbatch dim inserted as the reference's launcher does
    jcfg, tcfg = jbase.get_config(arch), base.get_config(arch)
    mb = jbase.get_train_config(arch).microbatch
    jb = jtrain._batch_shapes(jcfg, jbase.TRAIN_4K, m, mb)
    tb = train._batch_shapes(tcfg, base.TRAIN_4K, m, mb)
    jspecs = jsharding.batch_specs_train(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            (x.shape[0],) + x.shape[2:], x.dtype), jb), jm, layout)
    want = {k: (s[0], None, *s[1:]) for k, s in _want(jspecs).items()}
    assert _got(train._batch_specs(tb, tm, layout)) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_serve_param_and_token_specs_match(arch, mesh_name):
    jm, tm = _meshes(mesh_name)
    jcfg, tcfg = jbase.get_config(arch), base.get_config(arch)
    jparams, tparams = _serve_shapes(arch)
    want = _want(jsharding.param_specs_serve(jparams, jm, jcfg))
    assert _got(sharding.param_specs_serve(tparams, tm, tcfg)) == want
    for b in (1, 2, 8, 128):
        token = jax.ShapeDtypeStruct((b, 1), np.int32)
        got = sharding.token_specs_serve(torch.empty((b, 1), device="meta"),
                                         tm)
        assert tuple(got) == tuple(jsharding.token_specs_serve(token, jm))


@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_cache_specs_match(arch, mesh_name, shape):
    jm, tm = _meshes(mesh_name)
    jcfg, tcfg = jbase.get_config(arch), base.get_config(arch)
    b, s = shape.global_batch, shape.seq_len
    jcaches = jax.eval_shape(lambda: jmodel.init_caches(jcfg, b, s))
    tcaches = model.init_caches(tcfg, b, s, device="meta")
    want = _want(jsharding.cache_specs_serve(jcaches, jm, jcfg))
    assert _got(sharding.cache_specs_serve(tcaches, tm, tcfg)) == want


# ---------------------------------------------------------------------------
# Splits over "data": what each build splits, and the parts tiling it
# ---------------------------------------------------------------------------


def _over_data(specs, tm, from_dim: int) -> bool:
    sizes = mesh.axis_sizes(tm)
    return any(
        a in ("pod", "data") and sizes[a] > 1
        for _, spec in tree_paths(specs) for entry in spec[from_dim:]
        for a in (entry if isinstance(entry, tuple) else (entry,))
        if a is not None)


def _assert_tiled(tree, specs, tm) -> None:
    """The parts ``shard_tree`` gives every coordinate of ``tm`` tile each
    leaf: as many distinct blocks (by storage offset) as the product of
    the axes its spec names, all of one shape, covering it exactly."""
    names, sizes = mesh.axis_names(tm), mesh.axis_sizes(tm)
    parts: dict = {}
    for fixed in itertools.product(*(range(sizes[a]) for a in names)):
        local = sharding.shard_tree(tree, specs, tm, dict(zip(names, fixed)))
        for path, leaf in tree_paths(local):
            parts.setdefault(path, set()).add(
                (leaf.storage_offset(), tuple(leaf.shape)))
    for (path, leaf), (_, spec) in zip(tree_paths(tree), tree_paths(specs)):
        n = int(np.prod([sizes[a] for e in spec if e is not None
                         for a in (e if isinstance(e, tuple) else (e,))]))
        shapes = {shape for _, shape in parts[path]}
        assert len(parts[path]) == n and len(shapes) == 1, (path, spec)
        assert int(np.prod(shapes.pop())) * n == leaf.numel(), (path, spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", ["data", "pod", "serve"])
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_require_whole_over(arch, kind, mesh_name):
    """What each build splits over "data"/"pod" past the agent dim: the
    ``data`` layout nothing (inner dims over "model" alone), the ``pod``
    layout always (FSDP and EP), serving only where its rule picks 2-D
    tensor parallelism (bf16 weights over 8 GB a "model" rank); and the
    local parts ``shard_tree`` gives every coordinate tile each leaf."""
    _, tm = _meshes(mesh_name)
    cfg, sizes = base.get_config(arch), mesh.axis_sizes(tm)
    if kind == "serve":
        tree = _serve_shapes(arch)[1]
        specs = sharding.param_specs_serve(tree, tm, cfg)
        from_dim = 0
        want = model.parameter_count(cfg) * 2 / sizes["model"] > 8e9
    else:
        m = mesh.num_agents(tm, kind)
        tree = _train_shapes(arch, m)[1]
        specs = sharding.param_specs_train(tree, tm, kind)
        from_dim = 1
        want = kind == "pod"
    assert _over_data(specs, tm, from_dim) == want
    _assert_tiled(tree, specs, tm)


# ---------------------------------------------------------------------------
# sharding_hints
# ---------------------------------------------------------------------------

HINTS = {"batch": ("data",), "tp": ("model",), "both": ("pod", "data")}
RESOLVE_CASES = [
    ((8, 16, 32), ("batch", None, "tp")),    # both divide
    ((6, 16, 32), ("batch", "tp", None)),    # 6 % 4: batch dropped
    ((2, 16, 32), ("batch", None, None)),    # 2 < 4: dropped
    ((8, 3, 32), ("both", "tp", None)),      # 3 % 2: tp dropped
    ((8, 16), ("pod", "unknown")),           # roles without axes
    ((16, 16, 2), ("both", None, "tp")),
]


@pytest.mark.parametrize("mesh_name", ["4x2", "2x2x2", "2x16x16"])
@pytest.mark.parametrize("shape,roles", RESOLVE_CASES)
def test_resolve_matches_the_reference_guard(monkeypatch, shape, roles,
                                             mesh_name):
    jm, tm = _meshes(mesh_name)
    pinned = []
    monkeypatch.setattr(jax.sharding, "get_abstract_mesh", lambda: jm)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: pinned.append(tuple(spec)) or x)
    x = np.zeros(shape, np.float32)
    with jhints.hints(HINTS):
        jhints.constrain(x, roles)
    with sharding_hints.hints(HINTS):
        got = sharding_hints.resolve(shape, roles, tm)
    assert pinned == [tuple(got)]


def test_resolve_without_hints_is_none():
    assert sharding_hints.resolve((8, 4), ("batch", None),
                                  mesh.make_test_mesh((4, 2))) is None


@pytest.mark.parametrize("with_hints", [False, True])
def test_constrain_returns_x_itself(with_hints):
    x = torch.randn(8, 4, 2)
    if with_hints:
        with sharding_hints.hints(HINTS):
            assert sharding_hints.constrain(x, ("batch", None, "tp")) is x
    else:
        assert sharding_hints.constrain(x, ("batch", None, "tp")) is x


def test_hints_nest_and_reset():
    with sharding_hints.hints({"batch": ("data",)}):
        with sharding_hints.hints({"batch": ("pod", "data")}):
            assert sharding_hints._HINTS.get() == {"batch": ("pod", "data")}
        assert sharding_hints._HINTS.get() == {"batch": ("data",)}
    assert sharding_hints._HINTS.get() is None


# ---------------------------------------------------------------------------
# shard_tree: the rank's part, with no communication
# ---------------------------------------------------------------------------

SHARD_CASES = {
    "agent_rows": ((2, 2, 2), ("pod", "data", "model"),
                   sharding.P(("pod", "data"), None, "model"), (4, 6, 8)),
    "batch_model": ((4, 2), ("data", "model"),
                    sharding.P("data", None, "model", None), (4, 3, 4, 5)),
    "replicated": ((4, 2), ("data", "model"),
                   sharding.P(None, None), (3, 5)),
}


@pytest.mark.parametrize("name", list(SHARD_CASES))
@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_shard_tree_tiles_the_tree(name, kind):
    shape, axes, spec, leaf_shape = SHARD_CASES[name]
    tm = mesh.make_test_mesh(shape, axes)
    whole = np.arange(np.prod(leaf_shape), dtype=np.float32).reshape(
        leaf_shape)
    leaf = torch.from_numpy(whole) if kind == "torch" else whole
    tree = {"g": {"leaf": leaf}}
    counts = np.zeros(whole.size, np.int64)
    for coords in np.ndindex(*shape):
        part = sharding.shard_tree(tree, {"g": {"leaf": spec}}, tm,
                                   dict(zip(axes, coords)))["g"]["leaf"]
        np.add.at(counts, np.asarray(part).astype(np.int64).ravel(), 1)
    # the parts tile the leaf: each element is held once for every
    # coordinate of the axes the spec does not name
    sizes = dict(zip(axes, shape))
    named = [a for e in spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))]
    assert (counts == np.prod(shape) // np.prod([sizes[a] for a in named])
            ).all()


def test_shard_tree_refuses_uneven_dims():
    tm = mesh.make_test_mesh((4, 2))
    with pytest.raises(ValueError, match="does not divide"):
        sharding.shard_tree({"x": torch.zeros(6, 3)},
                            {"x": sharding.P("data", None)}, tm,
                            {"data": 0, "model": 0})


def test_p_is_a_tree_leaf_and_compares_as_a_tuple():
    spec = sharding.P("data", None, ("pod", "model"))
    assert spec == ("data", None, ("pod", "model"))
    assert tuple(spec) == tuple(jax.sharding.PartitionSpec(
        "data", None, ("pod", "model")))
    assert _got({"a": {"b": spec}}) == {"a/b": ("data", None,
                                                ("pod", "model"))}
