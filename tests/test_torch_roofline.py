"""The port's roofline model (`repro_torch.roofline`) against the JAX
package's (`repro.roofline`) on every (arch × shape × mesh × layout).

`analytic.train_model` / `serve_model`, `model_flops` and
`analytic_hlo_flops` are copies and must return exactly the reference's
numbers. `report` takes the collectives the port counts in place of HLO
text: given the `CollectiveStats` that the reference's
`parse_collectives_nested` finds in `tests/test_roofline.py`'s HLO and the
reference's peaks, it must give the reference's report field by field.
The reference's two HLO-parser tests have no counterpart: the port
produces no HLO, and counts every collective where it is called
(`launch/mesh.py`)."""

import dataclasses
import math

import pytest

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.roofline import analysis as janalysis
from repro.roofline import analytic as janalytic

from repro_torch.configs import base as tbase
from repro_torch.models import model as tmodel
from repro_torch.roofline import H100, CollectiveStats, Peaks
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import analytic as tanalytic

from test_roofline import HLO

TPU_PEAKS = Peaks(197e12, 819e9, 50e9)   # the reference's constants
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2})
LAYOUTS = ("data", "data_dp", "pod")
EDGES = (0, 64)
SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


@pytest.fixture(autouse=True)
def _counts_once(monkeypatch):
    """Each package's ``parameter_count`` computed once per config (an
    ``eval_shape`` / meta init per call would dominate the test): the
    same function, its values cached."""
    for mod in (jmodel, tmodel):
        real, seen = mod.parameter_count, {}

        def cached(cfg, params=None, real=real, seen=seen):
            if params is not None:
                return real(cfg, params)
            if cfg not in seen:
                seen[cfg] = real(cfg)
            return seen[cfg]

        monkeypatch.setattr(mod, "parameter_count", cached)


def _agents(mesh: dict, layout: str) -> int:
    axes = (("pod", "data") if layout in ("data", "data_dp")
            else ("pod",))
    return max(math.prod(mesh.get(a, 1) for a in axes), 1)


def _cfgs(arch):
    return jbase.get_config(arch), tbase.get_config(arch)


def _same(got, want) -> bool:
    """Equal, NaN equal to NaN, dicts key by key."""
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            _same(got[k], want[k]) for k in want)
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    return got == want


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_train_model_equals_the_reference(arch):
    jcfg, tcfg_ = _cfgs(arch)
    half = (dataclasses.replace(jbase.TRAIN_4K, global_batch=128),
            dataclasses.replace(tbase.TRAIN_4K, global_batch=128))
    n = 0
    for jshape, tshape in ((jbase.TRAIN_4K, tbase.TRAIN_4K), half):
        for mesh in MESHES:
            for layout in LAYOUTS:
                jt = dataclasses.replace(jbase.get_train_config(arch),
                                         agent_layout=layout)
                tt = dataclasses.replace(tbase.get_train_config(arch),
                                         agent_layout=layout)
                m = _agents(mesh, layout)
                for edges in EDGES:
                    want = janalytic.train_model(jcfg, jshape, jt, mesh, m,
                                                 edges)
                    got = tanalytic.train_model(tcfg_, tshape, tt, mesh, m,
                                                edges)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), (mesh, layout, edges)
                    n += 1
    assert n == 2 * len(MESHES) * len(LAYOUTS) * len(EDGES)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_serve_model_equals_the_reference(arch):
    jcfg, tcfg_ = _cfgs(arch)
    for name in SERVE_SHAPES:
        for mesh in MESHES:
            want = janalytic.serve_model(jcfg, jbase.get_shape(name), mesh)
            got = tanalytic.serve_model(tcfg_, tbase.get_shape(name), mesh)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (name, mesh)


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_model_and_analytic_flops_equal_the_reference(arch):
    jcfg, tcfg_ = _cfgs(arch)
    for shape in jbase.ALL_SHAPES:
        tshape = tbase.get_shape(shape.name)
        assert tanalysis.model_flops(tcfg_, tshape) == \
            janalysis.model_flops(jcfg, shape)
        assert tanalysis.model_flops(tcfg_, tshape, 16) == \
            janalysis.model_flops(jcfg, shape, 16)
        for remat in (True, False):
            assert tanalysis.analytic_hlo_flops(tcfg_, tshape, remat) == \
                janalysis.analytic_hlo_flops(jcfg, shape, remat)


def _reports(arch: str, shape_name: str, peaks):
    """(the reference's report on HLO, the port's on the stats the
    reference parses from it) for the cell at 16 × 16."""
    jcfg, tcfg_ = _cfgs(arch)
    mesh = {"data": 16, "model": 16}
    jshape, tshape = jbase.get_shape(shape_name), tbase.get_shape(shape_name)
    train = jshape.kind == "train"
    m = _agents(mesh, jbase.get_train_config(arch).agent_layout)
    want = janalysis.report(
        arch=arch, shape=jshape, cfg=jcfg, mesh_name="pod16x16", chips=256,
        cost=None, hlo_text=HLO, num_agents=m if train else 1, remat=True,
        tcfg=jbase.get_train_config(arch) if train else None,
        mesh_shape=mesh, gossip_directed_edges=64 if train else 0)
    parsed = janalysis.parse_collectives_nested(HLO)
    got = tanalysis.report(
        arch=arch, shape=tshape, cfg=tcfg_, mesh_name="pod16x16", chips=256,
        collectives=CollectiveStats(dict(parsed.bytes_by_kind),
                                    dict(parsed.count_by_kind)),
        peaks=peaks, num_agents=m if train else 1, remat=True,
        tcfg=tbase.get_train_config(arch) if train else None,
        mesh_shape=mesh, gossip_directed_edges=64 if train else 0)
    return want, got


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_report_equals_the_reference_at_its_peaks(arch):
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        want, got = _reports(arch, name, TPU_PEAKS)
        want, got = want.to_dict(), got.to_dict()
        assert got["peaks"] == dataclasses.asdict(TPU_PEAKS)
        for key in want:
            assert _same(got[key], want[key]), (name, key)
        assert set(got) == set(want) | {"peaks"}


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_report_at_the_h100_peaks(arch):
    """The same report at ``H100``: compute and memory terms scale by the
    peaks' ratios, the collective term (one 50 GB/s link in both) stays,
    and the roofline fraction is the model FLOPs' time at 989 TFLOP/s
    over the new bound — 197/989 of the reference's where the collective
    term binds both."""
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        tpu = _reports(arch, name, TPU_PEAKS)[1]
        h100 = _reports(arch, name, H100)[1]
        assert h100.compute_s == pytest.approx(tpu.compute_s * 197 / 989,
                                               rel=1e-12)
        assert h100.memory_s == pytest.approx(tpu.memory_s * 819e9 / 3.35e12,
                                              rel=1e-12)
        assert h100.collective_s == tpu.collective_s
        ideal = h100.model_flops_global / (256 * 989e12)
        assert h100.roofline_fraction == pytest.approx(ideal / h100.bound_s,
                                                       rel=1e-12)
        if tpu.dominant == h100.dominant == "collective":
            assert h100.roofline_fraction == pytest.approx(
                tpu.roofline_fraction * 197 / 989, rel=1e-12)


def test_h100_peaks_and_no_tpu_constant():
    assert H100 == Peaks(989e12, 3.35e12, 50e9)
    import pathlib

    src = pathlib.Path(tanalysis.__file__).parent
    for path in src.glob("*.py"):
        text = path.read_text()
        for tpu in ("197e12", "819e9", "PEAK_FLOPS", "HBM_BW", "ICI_BW"):
            assert tpu not in text, (path.name, tpu)
