"""repro_torch.distributed against repro.distributed: the launch geometry
and its word counters (exact), the planner's mesh leg and
``explain("conv2d_dist")`` (exact), and the executed halo-exchange conv on
both conv meshes.

The reference's outputs come from one subprocess that gives jax 8 fake host
devices (``repro.launch.fake_devices``) and builds each mesh with Auto axes
(jax 0.9's ``make_mesh`` makes Explicit ones by default, which its
``shard_map`` refuses; ROADMAP queue 3). The port's ``LocalConvMesh`` runs
in this process; its ``GroupConvMesh`` in 4 ranks of a gloo process group,
each a subprocess of its own, joined under a time limit. Inputs are made
with numpy from seeds."""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import distributed as jd
from repro import ops as jops
from repro import plan as jp
from repro.core.conv_model import ConvShape as JShape
from repro.core.parallel_tiling import ParallelBlocking as JBlocking
from repro_torch import distributed as td
from repro_torch import ops
from repro_torch import plan as tp
from repro_torch.core.conv_model import BF16_ACC32, ConvShape
from repro_torch.core.parallel_tiling import ParallelBlocking
from repro_torch.distributed import DistConvGeometry, dist_grid
from repro_torch.launch import make_conv_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH = ops.ExecutionContext(target=tp.H100, backend="torch", device="cpu")
CUDA_CPU = ops.ExecutionContext(target=tp.H100, backend="cuda", device="cpu")
GROUP_TIMEOUT = 120  # seconds for the 4 gloo ranks to finish

SHAPE = dict(N=4, c_I=8, c_O=6, H=18, W=18, f=3, s=1)
# (P, grid): bitwise grids never split cI (the psum reassociates the
# reduction); cI grids are held within 1e-5
BITWISE_GRIDS = [(1, {}), (2, {"hO": 2}), (4, {"hO": 2, "wO": 2}),
                 (8, {"N": 2, "hO": 2, "wO": 2})]
PSUM_GRIDS = [(2, {"cI": 2}), (8, {"cI": 2, "hO": 2, "wO": 2})]
STRIDE_RAGGED = [({"hO": 2}, dict(H=23, W=19, s=2)),
                 ({"hO": 2, "wO": 2}, dict(H=23, W=19, s=2)),
                 ({"hO": 8}, dict(H=15, W=15)),  # ragged
                 ({"hO": 4}, dict(H=15, W=15))]  # 13 rows over 4
ALLGATHER_GRIDS = [{"wO": 2}, {"N": 2, "cI": 2, "hO": 2}]


def _case(kind, grid, backend="xla", **shape_kw):
    return dict(SHAPE, **shape_kw, kind=kind, grid=grid, backend=backend)


# every executed case, held against the reference's output
REF_CASES = (
    [_case("halo", g) for _, g in BITWISE_GRIDS + PSUM_GRIDS]
    + [_case("halo", g, **kw) for g, kw in STRIDE_RAGGED]
    + [_case("allgather", g) for g in ALLGATHER_GRIDS]
    + [_case("halo", {"cI": 2, "hO": 2}, backend="pallas")])


def _case_id(c):
    s = "x".join(str(c[k]) for k in ("H", "W", "s"))
    return f"{c['kind']}-{c['backend']}-{json.dumps(c['grid'])}-{s}"


def _inputs(c):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((c["N"], c["c_I"], c["H"], c["W"]))
    w = rng.standard_normal((c["c_O"], c["c_I"], c["f"], c["f"]))
    return x.astype(np.float32), w.astype(np.float32)


def _shape(c, cls=ConvShape):
    f, s = c["f"], c["s"]
    return cls(N=c["N"], c_I=c["c_I"], c_O=c["c_O"],
               h_O=(c["H"] - f) // s + 1, w_O=(c["W"] - f) // s + 1,
               h_F=f, w_F=f, sh=s, sw=s)


_REF_CODE = textwrap.dedent('''
    import json, sys
    from repro.launch import fake_devices
    fake_devices(8)
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro import distributed, ops
    from repro.core.conv_model import ConvShape
    from repro.core.parallel_tiling import ParallelBlocking
    from repro.distributed import DIST_AXES, dist_grid
    from repro.plan import TPU_V5E
    cases, out = json.load(open(sys.argv[1])), {}
    for i, c in enumerate(cases):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((c["N"], c["c_I"], c["H"], c["W"]))
        w = rng.standard_normal((c["c_O"], c["c_I"], c["f"], c["f"]))
        f, s = c["f"], c["s"]
        shape = ConvShape(N=c["N"], c_I=c["c_I"], c_O=c["c_O"],
                          h_O=(c["H"] - f) // s + 1,
                          w_O=(c["W"] - f) // s + 1, h_F=f, w_F=f,
                          sh=s, sw=s)
        pb = ParallelBlocking.from_grid(shape, c["grid"])
        sizes = dist_grid(pb)
        mesh = jax.make_mesh(sizes, DIST_AXES,
                             axis_types=(AxisType.Auto,) * 4,
                             devices=jax.devices()[:int(np.prod(sizes))])
        ctx = ops.ExecutionContext(target=TPU_V5E, backend=c["backend"])
        fn = (distributed.allgather_conv if c["kind"] == "allgather"
              else distributed.halo_conv)
        y = fn(jnp.asarray(x.astype(np.float32)),
               jnp.asarray(w.astype(np.float32)), stride=(s, s),
               blocking=pb, mesh=mesh, ctx=ctx, local_backend=c["backend"],
               out_dtype=jnp.float32)
        out[f"c{i}"] = np.asarray(y)
    np.savez(sys.argv[2], **out)
    print("REF_OK")
''')


@pytest.fixture(scope="module")
def reference_outputs(tmp_path_factory):
    """Every REF_CASES output of the reference, from one subprocess."""
    d = tmp_path_factory.mktemp("ref_dist")
    (d / "cases.json").write_text(json.dumps(REF_CASES))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # fake_devices sets it
    res = subprocess.run(
        [sys.executable, "-c", _REF_CODE, str(d / "cases.json"),
         str(d / "out.npz")], capture_output=True, text=True, timeout=600,
        env=env)
    assert "REF_OK" in res.stdout, res.stderr[-3000:]
    data = np.load(d / "out.npz")
    return [data[f"c{i}"] for i in range(len(REF_CASES))]


def _run(c, ctx=TORCH, mesh=None):
    x, w = (torch.from_numpy(a) for a in _inputs(c))
    s = c["s"]
    pb = ParallelBlocking.from_grid(_shape(c), c["grid"])
    mesh = mesh or make_conv_mesh(pb)
    if c["kind"] == "allgather":
        out = td.allgather_conv(x, w, stride=(s, s), blocking=pb, mesh=mesh,
                                ctx=ctx, local_backend=ctx.backend)
    else:
        out = ops.conv2d_dist(x, w, stride=(s, s), blocking=pb, mesh=mesh,
                              ctx=ctx, out_dtype=torch.float32)
    return out, x, w, pb, mesh


def _single(x, w, s, ctx=TORCH):
    return ops.conv2d(x, w, stride=(s, s), ctx=ctx, out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# Geometry and counters (shape-only, exact)
# ---------------------------------------------------------------------------

GEOMS = [  # (h_O, ghO, sh, h_F): the reference's padding cases
    (16, 4, 1, 3), (13, 4, 1, 3), (11, 2, 2, 3), (7, 8, 1, 3),
    (56, 4, 1, 1), (112, 4, 2, 7), (9, 3, 3, 5)]
GEOM_GRIDS = [{}, {"hO": 2}, {"wO": 2}, {"cI": 2}, {"N": 2, "cI": 2},
              {"cI": 2, "hO": 2, "wO": 2}, {"N": 4, "hO": 2}]
PROPS = ("P", "bN", "b_cI", "bh", "bw", "Np", "cIp", "hOp", "wOp", "Hp",
         "Wp", "halo_h", "halo_w", "h_ext", "w_ext", "grid")


def _geom_pair(kw, grid):
    return (jd.DistConvGeometry.build(**kw, grid=grid),
            DistConvGeometry.build(**kw, grid=grid))


def _assert_geoms_equal(jg, tg, shape_kw):
    for p in PROPS:
        assert getattr(tg, p) == getattr(jg, p), p
    assert tg.grid_dict() == jg.grid_dict()
    for p_in, p_flt, p_out in ((1.0, 1.0, 1.0), (0.5, 0.5, 1.0),
                               (0.25, 0.25, 0.5)):
        assert tg.halo_words(p_in) == jg.halo_words(p_in)
        assert tg.psum_words(p_out) == jg.psum_words(p_out)
        assert tg.comm_words(p_in, p_out) == jg.comm_words(p_in, p_out)
        assert tg.allgather_words(p_in, p_flt) == \
            jg.allgather_words(p_in, p_flt)
    ts, js = ConvShape(**shape_kw), JShape(**shape_kw)
    assert tg.blocking(ts).grid == jg.blocking(js).grid
    for M in (2.0 ** 15, 2.0 ** 20):
        assert tg.lower_bound(ts, M) == jg.lower_bound(js, M)


@pytest.mark.parametrize("h_O,ghO,sh,h_F", GEOMS)
def test_geometry_padding_cases_equal(h_O, ghO, sh, h_F):
    kw = dict(N=2, c_I=4, c_O=4, h_O=h_O, w_O=8, h_F=h_F, w_F=1, sh=sh, sw=1)
    jg, tg = _geom_pair(kw, {"hO": ghO})
    _assert_geoms_equal(jg, tg, kw)
    # the owned slabs cover the tight VALID input extent
    assert tg.Hp >= (h_O - 1) * sh + h_F
    assert tg.h_ext <= tg.bh * sh + tg.halo_h


@pytest.mark.parametrize("grid", GEOM_GRIDS, ids=json.dumps)
@pytest.mark.parametrize("layer", ["conv1", "conv2_x", "conv5_x"])
def test_geometry_on_resnet_layers_equal(layer, grid):
    from repro_torch.core.conv_model import resnet50_layers

    s = resnet50_layers(1000)[layer]
    kw = dict(N=s.N, c_I=s.c_I, c_O=s.c_O, h_O=s.h_O, w_O=s.w_O, h_F=s.h_F,
              w_F=s.w_F, sh=s.sh, sw=s.sw)
    jg, tg = _geom_pair(kw, grid)
    _assert_geoms_equal(jg, tg, kw)


def test_dist_grid_and_validation_equal():
    with pytest.raises(ValueError, match="cannot split"):
        dist_grid({"cO": 2})
    with pytest.raises(ValueError, match="unknown loop axis"):
        dist_grid({"zz": 2})
    assert dist_grid({"hO": 4, "cI": 2}) == jd.dist_grid({"hO": 4, "cI": 2})
    g = DistConvGeometry.build(N=1, c_I=1, c_O=1, h_O=8, w_O=8, h_F=9,
                               w_F=1, sh=1, sw=1, grid={"hO": 8})
    with pytest.raises(ValueError, match="too fine"):
        g.validate()


# the phase-26 cells: ResNet-50 conv1 and conv2_x at batch 1000, bf16 in,
# P = 8: (halo, psum, comm, all-gather) words a device, from the reference
WORD_TABLE = {
    ("conv1", "lp"): (0, 0, 0, 69_431_250),
    ("conv1", "probe0"): (1_342_500, 0, 1_342_500, 70_644_000),
    ("conv1", "probe1"): (1_185_000, 215_296_000, 216_481_000, 94_195_136),
    ("conv2_x", "lp"): (0, 0, 0, 94_192_000),
    ("conv2_x", "probe0"): (2_944_000, 0, 2_944_000, 97_440_000),
    ("conv2_x", "probe1"): (1_920_000, 53_824_000, 55_744_000, 94_201_216),
}
PROBES = {"probe0": {"hO": 4, "wO": 2}, "probe1": {"cI": 2, "hO": 2, "wO": 2}}
BOUND_2_20 = {"conv1": 2_018_848, "conv2_x": 2_606_848}


@pytest.mark.parametrize("layer,tag", sorted(WORD_TABLE))
def test_phase26_word_table(layer, tag):
    """The full-width words of chip phase 26, on meta tensors: the port's
    counters, the reference's and the table agree exactly; the LP picks
    {"N": 8}."""
    from repro.core.bounds import combined_parallel_bound as jbound
    from repro_torch.core.bounds import combined_parallel_bound
    from repro_torch.core.conv_model import resnet50_layers

    s = resnet50_layers(1000)[layer].with_precision(BF16_ACC32)
    H, W = (s.h_O - 1) * s.sh + s.h_F, (s.w_O - 1) * s.sw + s.w_F
    x = torch.empty((s.N, s.c_I, H, W), dtype=torch.bfloat16, device="meta")
    w = torch.empty((s.c_O, s.c_I, s.h_F, s.w_F), dtype=torch.bfloat16,
                    device="meta")
    xs = jax.ShapeDtypeStruct(tuple(x.shape), jnp.bfloat16)
    ws = jax.ShapeDtypeStruct(tuple(w.shape), jnp.bfloat16)
    if tag == "lp":
        pb = td.default_blocking(x.shape, w.shape, (s.sh, s.sw), 8,
                                 prec=BF16_ACC32)
        assert {k: v for k, v in pb.grid.items() if v > 1} == {"N": 8}
    else:
        pb = ParallelBlocking.from_grid(s, PROBES[tag])
    grid = {k: v for k, v in pb.grid.items() if v > 1}
    geom = DistConvGeometry.from_shape(s, pb)
    halo, psum, comm, ag = WORD_TABLE[layer, tag]
    assert geom.halo_words(0.5) == halo and geom.psum_words(1.0) == psum
    stride = (s.sh, s.sw)
    got = td.conv2d_dist_comm_words(x, w, stride, pb)
    assert got == comm == jd.conv2d_dist_comm_words(
        xs, ws, stride, JBlocking.from_grid(JShape(**{
            k: getattr(s, k) for k in ("N", "c_I", "c_O", "w_O", "h_O",
                                       "w_F", "h_F", "sw", "sh")}), grid))
    assert td.allgather_comm_words(x, w, stride, pb) == ag
    # explain on the H100 with the mesh: words and the plan's own bound
    mesh = make_conv_mesh(pb)
    ctx = ops.ExecutionContext(target=tp.HardwareTarget.from_mesh(mesh),
                               backend="cuda", device="cpu")
    d = ops.explain("conv2d_dist", ctx, dtype=torch.bfloat16,
                    spec_args=(x, w), spec_kw={"stride": stride,
                                               "blocking": pb})
    assert d.measured_words == comm
    assert d.lower_bound == d.plan.parallel.lower_bound
    assert combined_parallel_bound(s, 8, 2.0 ** 20) == BOUND_2_20[layer]
    assert jbound(JShape(**{k: getattr(s, k) for k in (
        "N", "c_I", "c_O", "w_O", "h_O", "w_F", "h_F", "sw", "sh")},
        prec=s.prec), 8, 2.0 ** 20) == BOUND_2_20[layer]


def test_counters_scale_with_dtype_and_ignore_out_dtype():
    c = _case("halo", {"hO": 2})
    x = torch.empty((4, 8, 18, 18), device="meta")
    w = torch.empty((6, 8, 3, 3), device="meta")
    pb = ParallelBlocking.from_grid(_shape(c), {"hO": 2})
    full = td.conv2d_dist_comm_words(x, w, (1, 1), pb)
    half = td.conv2d_dist_comm_words(x.to(torch.bfloat16),
                                     w.to(torch.bfloat16), (1, 1), pb)
    assert half == full / 2 > 0
    pb2 = ParallelBlocking.from_grid(_shape(c), {"cI": 2})
    assert td.conv2d_dist_comm_words(x, w, (1, 1), pb2,
                                     out_dtype=torch.bfloat16) == \
        td.conv2d_dist_comm_words(x, w, (1, 1), pb2) > 0
    pb3 = ParallelBlocking.from_grid(_shape(c), {"N": 4})
    assert td.conv2d_dist_comm_words(x, w, (1, 1), pb3) == 0.0
    assert td.allgather_comm_words(x, w, (1, 1), pb3) > 0.0


# ---------------------------------------------------------------------------
# Plans (the planner's mesh leg) and explain
# ---------------------------------------------------------------------------

CONV = dict(N=8, c_I=16, c_O=16, w_O=16, h_O=16, w_F=3, h_F=3)
MESH = (("N", 2), ("cI", 2), ("hO", 2), ("wO", 1))


@pytest.mark.parametrize("target", ["TPU_V5E", "GEMMINI", "H100"])
def test_mesh_plans_equal_the_reference(target):
    tt = getattr(tp, target).with_mesh(MESH)
    jt = jp.HardwareTarget.from_dict(tt.to_dict())
    for top, jop in ((tp.ConvSpec(**CONV), jp.ConvSpec(**CONV)),
                     (tp.MatmulSpec(64, 128, 256),
                      jp.MatmulSpec(64, 128, 256))):
        a, b = tp.Planner(tt).plan(top), jp.Planner(jt).plan(jop)
        assert a.to_dict() == b.to_dict()
        assert a.sharding is not None
        assert (a.parallel is not None) == isinstance(top, tp.ConvSpec)
        assert tp.ExecutionPlan.from_dict(a.to_dict()) == a
        # a dump of either package loads in the other
        assert tp.ExecutionPlan.from_dict(b.to_dict()) == a
        assert jp.ExecutionPlan.from_dict(a.to_dict()).to_dict() == \
            b.to_dict()
    p = tp.Planner(tt).plan(tp.ConvSpec(**CONV))
    assert p.parallel.P == 8 and math.prod(p.parallel.grid_dict.values()) == 8
    assert p.parallel.comm_words >= 0.0
    assert p.to_dict()["version"] == tp.PLAN_FORMAT_VERSION >= 3


def test_plan_v2_dump_loads_with_parallel_none():
    p = tp.Planner(tp.TPU_V5E).plan(
        tp.ConvSpec(N=4, c_I=8, c_O=8, w_O=8, h_O=8, w_F=3, h_F=3))
    d = p.to_dict()
    d.pop("parallel")
    d["version"] = 2
    restored = tp.ExecutionPlan.from_dict(d)
    assert restored.parallel is None and restored.tiles == p.tiles


def test_single_device_plan_has_no_parallel_section():
    for target in (tp.TPU_V5E, tp.H100):
        p = tp.Planner(target).plan(
            tp.ConvSpec(N=4, c_I=8, c_O=8, w_O=8, h_O=8, w_F=3, h_F=3))
        assert p.parallel is None and p.sharding is None
        assert p.to_dict()["parallel"] is None


def test_conv2d_dist_explain_equals_the_reference():
    tx = torch.empty((4, 8, 18, 18), device="meta")
    tw = torch.empty((6, 8, 3, 3), device="meta")
    jx = jax.ShapeDtypeStruct((4, 8, 18, 18), jnp.float32)
    jw = jax.ShapeDtypeStruct((6, 8, 3, 3), jnp.float32)
    mesh = (("N", 1), ("cI", 2), ("hO", 2), ("wO", 1))
    c = _case("halo", {"cI": 2, "hO": 2})
    tpb = ParallelBlocking.from_grid(_shape(c), c["grid"])
    jpb = JBlocking.from_grid(_shape(c, JShape), c["grid"])
    jctx = jops.ExecutionContext(target=jp.TPU_V5E.with_mesh(mesh),
                                 backend="pallas")
    jdec = jops.explain("conv2d_dist", jctx, dtype="float32",
                        spec_args=(jx, jw),
                        spec_kw={"stride": (1, 1), "blocking": jpb})
    for backend in ("cuda", "torch"):
        tctx = ops.ExecutionContext(target=tp.TPU_V5E.with_mesh(mesh),
                                    backend=backend, device="cpu")
        tdec = ops.explain("conv2d_dist", tctx, dtype=torch.float32,
                           spec_args=(tx, tw),
                           spec_kw={"stride": (1, 1), "blocking": tpb})
        assert tdec.chosen == backend
        assert tdec.measured_words == jdec.measured_words > 0
        assert tdec.measured_words == td.conv2d_dist_comm_words(
            tx, tw, (1, 1), tpb)
        assert tdec.plan.to_dict() == jdec.plan.to_dict()
        assert tdec.lower_bound == jdec.lower_bound == \
            tdec.plan.parallel.lower_bound
        assert tdec.bound_ratio == jdec.bound_ratio
        assert "inter-device words" in tdec.why()
    # planned for a single-device target: no parallel bound to ratio against
    d = ops.explain("conv2d_dist", TORCH, dtype=torch.float32,
                    spec_args=(tx, tw),
                    spec_kw={"stride": (1, 1), "blocking": tpb})
    assert d.lower_bound is None and d.bound_ratio is None


def test_conv2d_shard_rejects_inexact_windows():
    from repro_torch.kernels.conv2d import conv2d_shard, exact_window

    assert exact_window(18, 18, 3, 3, 1, 1)
    assert not exact_window(18, 18, 3, 3, 2, 2)
    x, w = (torch.from_numpy(a) for a in _inputs(SHAPE))
    with pytest.raises(ValueError, match="not exact"):
        conv2d_shard(x, w, stride=(2, 2))
    torch.testing.assert_close(conv2d_shard(x, w), _single(x, w, 1),
                               rtol=1e-5, atol=1e-5)


def test_mesh_layout_and_target_from_mesh():
    pb = {"N": 2, "cI": 1, "hO": 2, "wO": 2}
    mesh = make_conv_mesh(pb)
    assert isinstance(mesh, td.LocalConvMesh)
    assert mesh.sizes == dist_grid(pb) == (2, 1, 2, 2) and mesh.P == 8
    assert mesh.axis_names == td.DIST_AXES
    # device d at the row-major coordinates, as jax.make_mesh lays them out
    ids = np.arange(8).reshape(mesh.sizes)
    for d in range(8):
        assert ids[mesh.coords(d)] == d == mesh.device_at(mesh.coords(d))
    assert mesh.line(5, "hO") == [int(v) for v in ids[1, 0, :, 1]]
    t = tp.HardwareTarget.from_mesh(mesh)
    assert t.mesh_axes == tuple(zip(td.DIST_AXES, mesh.sizes))
    assert t.n_devices == 8 and t.name == tp.H100.name
    x = torch.arange(2 * 3 * 4 * 6.0).reshape(2, 3, 4, 6)
    blocks = mesh.scatter(x, ("N", None, "hO", "wO"))
    assert all(b.shape == (1, 3, 2, 3) for b in blocks)
    assert torch.equal(mesh.assemble(dict(enumerate(blocks)),
                                     ("N", None, "hO", "wO")), x)


# ---------------------------------------------------------------------------
# The halo conv on the in-process mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(REF_CASES)),
                         ids=[_case_id(c) for c in REF_CASES])
def test_halo_and_allgather_conv_equal_the_reference(reference_outputs, i):
    """Each executed case within 1e-5 of the reference's, which ran the
    same numpy inputs on 8 fake devices (its ``xla`` leg against the port's
    ``torch``; its ``pallas`` leg in interpret mode against the port's
    ``cuda`` leg's plain version). Not bit for bit: XLA's CPU convolution
    and aten's sum in other orders (ROADMAP queue 3)."""
    c = REF_CASES[i]
    ctx = CUDA_CPU if c["backend"] == "pallas" else TORCH
    got = _run(c, ctx)[0].numpy()
    want = reference_outputs[i]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P,grid", BITWISE_GRIDS, ids=str)
def test_dist_conv_bitwise_invariant_across_shard_counts(P, grid):
    """The f32 halo-exchange conv equals the single-device conv bit for
    bit when the reduction axis is unsplit, on 1/2/4/8 shards."""
    c = _case("halo", grid)
    got, x, w, pb, mesh = _run(c)
    assert mesh.P == P
    assert torch.equal(got, _single(x, w, 1))


@pytest.mark.parametrize("P,grid", PSUM_GRIDS, ids=str)
def test_dist_conv_psum_grids_allclose(P, grid):
    got, x, w, _, _ = _run(_case("halo", grid))
    torch.testing.assert_close(got, _single(x, w, 1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("grid,shape_kw", STRIDE_RAGGED, ids=str)
def test_dist_conv_stride_and_ragged_h_O(grid, shape_kw):
    """stride > 1 and non-divisible h_O stay bitwise (no cI split)."""
    c = _case("halo", grid, **shape_kw)
    got, x, w, _, _ = _run(c)
    assert torch.equal(got, _single(x, w, c["s"]))


def test_dist_conv_cuda_local_shards():
    """The shard-local conv dispatches through the registry on the
    requested backend: on the CPU the ``cuda`` leg runs the kernel's plain
    version on each shard."""
    c = _case("halo", {"cI": 2, "hO": 2})
    with ops.record_dispatch() as log:
        got, x, w, _, mesh = _run(c, CUDA_CPU)
    dist_decs = [d for d in log if d.op == "conv2d_dist"]
    local = [d for d in log if d.op == "conv2d"]
    assert [d.chosen for d in dist_decs] == ["cuda"]
    assert len(local) == mesh.P and {d.chosen for d in local} == {"cuda"}
    assert all(d.plan.parallel is None and not d.degraded for d in local)
    torch.testing.assert_close(got, _single(x, w, 1, CUDA_CPU), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("grid", ALLGATHER_GRIDS, ids=json.dumps)
def test_allgather_baseline_matches_single_device(grid):
    got, x, w, _, _ = _run(_case("allgather", grid))
    torch.testing.assert_close(got, _single(x, w, 1), rtol=1e-5, atol=1e-5)


WIRE_GRIDS = ([g for _, g in BITWISE_GRIDS + PSUM_GRIDS]
              + [{"wO": 2}, {"cI": 4}, {"N": 2, "cI": 2, "hO": 2}])


@pytest.mark.parametrize("grid", WIRE_GRIDS, ids=json.dumps)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wire_counts_equal_the_counters(grid, dtype):
    """Every device's counted wire words equal the counters exactly, by
    kind: the shifts the halo words, the all-reduce the psum words, the
    all-gathers the baseline's. {"wO": 2} has a live row halo on a
    single-shard hO axis: its window is a local zero fill, never wire."""
    c = _case("halo", grid)
    x, w = (torch.from_numpy(a).to(dtype) for a in _inputs(c))
    pb = ParallelBlocking.from_grid(_shape(c), grid)
    geom = DistConvGeometry.from_shape(_shape(c), pb)
    p = dtype.itemsize / 4.0
    mesh = make_conv_mesh(pb)
    ops.conv2d_dist(x, w, blocking=pb, mesh=mesh, ctx=TORCH)
    want = td.conv2d_dist_comm_words(x, w, (1, 1), pb)
    for d in range(mesh.P):
        assert mesh.wire_words(d) == want
        assert mesh.wire_words(d, "shift") == geom.halo_words(p)
        assert mesh.wire_words(d, "psum") == geom.psum_words(1.0)
        assert mesh.wire_words(d, "all_gather") == 0.0
    mesh = make_conv_mesh(pb)
    td.allgather_conv(x, w, blocking=pb, mesh=mesh, ctx=TORCH,
                      local_backend="torch")
    want = td.allgather_comm_words(x, w, (1, 1), pb)
    for d in range(mesh.P):
        assert mesh.wire_words(d) == mesh.wire_words(d, "all_gather") == want
    if grid == {"wO": 2}:
        assert geom.halo_h > 0 and geom.halo_words(p) == \
            geom.bN * geom.b_cI * geom.bh * geom.halo_w * p


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("grid", [{"hO": 2, "cI": 2},
                                  {"N": 2, "hO": 2, "wO": 2}], ids=json.dumps)
def test_dist_conv_gradients_equal_the_single_device_conv(grid, backend):
    """Gradients flow through the in-process mesh (copies, sums and
    concatenations are autograd ops; the shard conv's backward is the aten
    recompute) and equal the single-device conv's within 1e-5 x max(1,
    max|grad|): a filter gradient sums 1,024 products, in another order on
    the shards."""
    ctx = TORCH if backend == "torch" else CUDA_CPU
    c = _case("halo", grid)
    xn, wn = _inputs(c)
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 6, 16, 16)).astype(np.float32))
    grads = []
    for dist in (True, False):
        x = torch.from_numpy(xn).requires_grad_(True)
        w = torch.from_numpy(wn).requires_grad_(True)
        if dist:
            pb = ParallelBlocking.from_grid(_shape(c), grid)
            y = ops.conv2d_dist(x, w, blocking=pb, mesh=make_conv_mesh(pb),
                                ctx=ctx)
        else:
            y = ops.conv2d(x, w, ctx=ctx)
        (y * r).sum().backward()
        grads.append((x.grad, w.grad))
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-5 * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("grid", [{"N": 2, "hO": 2, "wO": 2},
                                  {"cI": 2, "hO": 2, "wO": 2}],
                         ids=json.dumps)
def test_distributed_conv_leaves_no_reference_cycles(grid):
    """A distributed conv frees its shard blocks when it returns: nothing
    of it waits for the garbage collector (at full width on the card,
    blocks held in a cycle grew phase 26 past the card's memory)."""
    import gc

    c = _case("halo", grid)
    x, w = (torch.from_numpy(a) for a in _inputs(c))
    for fn in (td.halo_conv, td.allgather_conv):
        fn(x, w, blocking=grid, mesh=make_conv_mesh(grid), ctx=TORCH,
           local_backend="torch")  # caches warm
        gc.collect()
        gc.disable()
        try:
            fn(x, w, blocking=grid, mesh=make_conv_mesh(grid), ctx=TORCH,
               local_backend="torch")
            assert gc.collect() == 0
        finally:
            gc.enable()


def test_mesh_must_match_the_blocking():
    c = _case("halo", {"hO": 2})
    x, w = (torch.from_numpy(a) for a in _inputs(c))
    pb = ParallelBlocking.from_grid(_shape(c), {"hO": 2})
    with pytest.raises(ValueError, match="do not match"):
        ops.conv2d_dist(x, w, blocking=pb, mesh=make_conv_mesh({"wO": 2}),
                        ctx=TORCH)
    # no blocking: the LP's grid over the mesh's devices
    mesh = make_conv_mesh({"N": 4})
    with ops.record_dispatch() as log:
        got = ops.conv2d_dist(x, w, mesh=mesh, ctx=TORCH)
    assert [d.op for d in log].count("conv2d") == 4
    torch.testing.assert_close(got, _single(x, w, 1), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The halo conv over a gloo process group (4 ranks, one subprocess each)
# ---------------------------------------------------------------------------

GROUP_GRIDS = [{"hO": 2, "wO": 2}, {"cI": 2, "hO": 2}]

_RANK_CODE = textwrap.dedent('''
    import json, os, sys
    import numpy as np, torch, torch.distributed as dist
    rank, out = int(sys.argv[1]), sys.argv[2]
    grids = json.load(open(os.path.join(out, "grids.json")))
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out, "store"), world_size=4, rank=rank)
    from repro_torch import ops
    from repro_torch.launch import make_conv_mesh
    from repro_torch.plan import H100
    data = np.load(os.path.join(out, "inputs.npz"))
    x, w = torch.from_numpy(data["x"]), torch.from_numpy(data["w"])
    ctx = ops.ExecutionContext(target=H100, backend="torch", device="cpu")
    res = {}
    for i, grid in enumerate(grids):
        mesh = make_conv_mesh(grid, group=dist.group.WORLD)
        res[f"y{i}"] = ops.conv2d_dist(x, w, blocking=grid, mesh=mesh,
                                       ctx=ctx)
        res[f"wire{i}"] = mesh.wire[rank]
    try:
        ops.conv2d_dist(x.clone().requires_grad_(True), w, blocking=grid,
                        mesh=mesh, ctx=ctx)
        res["grad_refused"] = False
    except NotImplementedError:
        res["grad_refused"] = True
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
''')


def test_group_mesh_over_four_gloo_ranks(tmp_path):
    """Each rank returns its own output block; assembled, they equal the
    in-process mesh's output bit for bit (both grids: a two-way sum is
    commutative), and each rank counts the counter's words. A rank refuses
    an input that requires a gradient."""
    c = _case("halo", {})
    xn, wn = _inputs(c)
    np.savez(tmp_path / "inputs.npz", x=xn, w=wn)
    (tmp_path / "grids.json").write_text(json.dumps(GROUP_GRIDS))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_CODE, str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    for i, grid in enumerate(GROUP_GRIDS):
        pb = ParallelBlocking.from_grid(_shape(c), grid)
        local = make_conv_mesh(pb)
        geom = DistConvGeometry.from_shape(_shape(c), pb)
        full = local.assemble({r: ranks[r][f"y{i}"] for r in range(4)},
                              td.halo.OUT_SPEC)
        want = td.halo_conv(x, w, blocking=pb, mesh=local, ctx=TORCH,
                            local_backend="torch", full_output=True)
        assert full.shape == (geom.Np, 6, geom.hOp, geom.wOp)
        assert torch.equal(full, want)
        words = td.conv2d_dist_comm_words(x, w, (1, 1), pb)
        for r in range(4):
            assert ranks[r][f"wire{i}"] == local.wire[r]
            assert sum(ranks[r][f"wire{i}"].values()) == words
    assert all(r["grad_refused"] for r in ranks)
