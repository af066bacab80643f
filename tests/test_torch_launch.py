"""Port `launch/mesh.py` and `launch/fabric.py` against the JAX package's.

The mesh is a host-side description in the port; the reference's is a
`jax.sharding.Mesh`, built here as an `AbstractMesh` of the same shape
(the production meshes need 256 and 512 devices). The fabric's W is held
bitwise, with the weight optimiser recorded from the reference and
replayed to the port (`_torch_design.RecordedOptimiser`: the Adam
trajectory is chaotic in the last bit, `tests/test_torch_designer.py`).
"""

import networkx as nx
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.launch import fabric as jfabric
from repro.launch import mesh as jmesh
from repro_torch.launch import fabric, mesh

from _torch_design import RecordedOptimiser

LAYOUTS = ("data", "data_dp", "pod")


@pytest.fixture
def abstract_meshes(monkeypatch):
    """The reference's mesh constructors, building abstract meshes."""
    monkeypatch.setattr(
        jmesh.compat, "make_mesh",
        lambda shape, axes: AbstractMesh(tuple(shape), tuple(axes)),
    )


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches(abstract_meshes, multi_pod):
    want = jmesh.make_production_mesh(multi_pod=multi_pod)
    got = mesh.make_production_mesh(multi_pod=multi_pod)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    for layout in LAYOUTS:
        assert mesh.agent_axes(got, layout) == jmesh.agent_axes(want, layout)
        assert mesh.num_agents(got, layout) == jmesh.num_agents(want, layout)
    assert mesh.num_agents(got, "data") == (32 if multi_pod else 16)


@pytest.mark.parametrize(
    "shape,axes",
    [((2, 2), ("data", "model")), ((4, 1), ("data", "model")),
     ((1, 1), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
     ((3, 1, 2), ("pod", "data", "model"))],
)
def test_test_mesh_matches(abstract_meshes, shape, axes):
    want = jmesh.make_test_mesh(shape, axes)
    got = mesh.make_test_mesh(shape, axes)
    assert got.shape == dict(want.shape)
    for layout in LAYOUTS:
        assert mesh.agent_axes(got, layout) == jmesh.agent_axes(want, layout)
        assert mesh.num_agents(got, layout) == jmesh.num_agents(want, layout)
    with pytest.raises(ValueError):
        mesh.agent_axes(got, "model")


def test_mesh_touches_no_device_and_checks_its_axes():
    m = mesh.make_test_mesh((4, 1))
    assert m == mesh.Mesh(("data", "model"), (4, 1))
    with pytest.raises(ValueError):
        mesh.Mesh(("data",), (2, 2))


@pytest.mark.parametrize("agents,pods", [(2, 1), (4, 1), (8, 1), (6, 2), (8, 2)])
def test_underlay_matches(agents, pods):
    per_pod = agents // pods
    want = jfabric.ring_fabric_underlay(per_pod, pods).graph
    got = fabric.ring_fabric_underlay(
        per_pod, pods, link_bw=jfabric.ICI_BW, cross_pod_bw=jfabric.DCN_BW
    ).graph
    assert list(got.nodes) == list(want.nodes)
    assert list(got.edges(data=True)) == list(want.edges(data=True))
    assert isinstance(want, nx.Graph)


CASES = [(2, 1), (4, 1), (8, 1), (8, 2)]


@pytest.fixture(scope="module")
def designs():
    """The reference's W for every case with its optimiser recorded, and
    the port's with the record replayed."""
    rec = RecordedOptimiser()
    jfabric.design_mixing_matrix.cache_clear()
    fabric.design_mixing_matrix.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        rec.record(mp)
        jw = {c: jfabric.design_mixing_matrix(c[0], c[1], 1e6) for c in CASES}
    with pytest.MonkeyPatch.context() as mp:
        rec.replay(mp)
        tw = {
            c: fabric.design_mixing_matrix(
                c[0], c[1], 1e6, link_bw=jfabric.ICI_BW,
                cross_pod_bw=jfabric.DCN_BW, device="cpu")
            for c in CASES
        }
    jfabric.design_mixing_matrix.cache_clear()
    fabric.design_mixing_matrix.cache_clear()
    return jw, tw


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"m{c[0]}_pods{c[1]}")
def test_design_mixing_matrix_bitwise(designs, case):
    jw, tw = designs
    (want, jdesign), (got, tdesign) = jw[case], tw[case]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tdesign.activated_links == jdesign.activated_links


def test_single_agent_and_cache():
    w, design = fabric.design_mixing_matrix(
        1, link_bw=1.0, cross_pod_bw=1.0, device="cpu")
    np.testing.assert_array_equal(w, np.ones((1, 1)))
    assert design is None
    with pytest.raises(TypeError):
        fabric.design_mixing_matrix(4)      # the bandwidths are the caller's
