"""repro_torch.core's multi-device modules against repro.core's: the §4.2
parallel blocking LP (``parallel_tiling``), the mesh sharding selection
(``sharding_opt``), the modeled volumes of the five algorithms
(``algorithms``) and the HBL machinery (``hbl``) are copies, so they must
agree exactly on the paper's layers. One difference is pinned: the port
caps P at the work G, where the reference's LP is infeasible."""

import dataclasses
import math
from fractions import Fraction

import numpy as np
import pytest

from repro.core import algorithms as ja
from repro.core import conv_model as jc
from repro.core import hbl as jh
from repro.core import parallel_tiling as jpt
from repro.core import sharding_opt as jso
from repro_torch.core import algorithms as ta
from repro_torch.core import conv_model as tc
from repro_torch.core import hbl as th
from repro_torch.core import parallel_tiling as tpt
from repro_torch.core import sharding_opt as tso

DIST_AXES = ("N", "cI", "hO", "wO")
LAYERS = sorted(jc.resnet50_layers(1000))
PS = (2, 4, 8, 16, 64)
PRECS = {"fp32": (1.0, 1.0, 1.0), "bf16": (0.5, 0.5, 1.0)}


def _pair(name, prec="bf16", N=1000):
    s = dataclasses.asdict(jc.resnet50_layers(N)[name])
    s.pop("prec")
    return (jc.ConvShape(**s, prec=jc.Precision(*PRECS[prec])),
            tc.ConvShape(**s, prec=tc.Precision(*PRECS[prec])))


# ---------------------------------------------------------------------------
# parallel_tiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("restrict", [None, DIST_AXES],
                         ids=["unrestricted", "dist_axes"])
@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name", LAYERS)
def test_parallel_grids_equal(name, P, restrict):
    js, ts = _pair(name)
    jb = jpt.optimize_parallel_blocking(js, P, restrict_axes=restrict)
    tb = tpt.optimize_parallel_blocking(ts, P, restrict_axes=restrict)
    assert tb.grid == jb.grid and tb.P == jb.P == P
    assert tb.comm_per_processor() == jb.comm_per_processor()
    assert tb.imbalance() == jb.imbalance()
    assert tb.work_per_processor() == jb.work_per_processor()
    for k in tpt.PAR_AXES:
        assert tb.block(k) == jb.block(k)
    assert (tb.in_block_words, tb.filt_block_words, tb.out_block_words) == \
        (jb.in_block_words, jb.filt_block_words, jb.out_block_words)
    if restrict:
        assert all(v == 1 for k, v in tb.grid.items() if k not in restrict)


@pytest.mark.parametrize("P", PS)
@pytest.mark.parametrize("name", LAYERS)
def test_continuous_lp_and_efficiency_equal(name, P):
    js, ts = _pair(name, "fp32")
    assert tpt._lp_parallel(ts, P) == jpt._lp_parallel(js, P)
    assert tpt.parallel_efficiency(ts, P, 2.0 ** 20) == \
        jpt.parallel_efficiency(js, P, 2.0 ** 20)


@pytest.mark.parametrize("P,naxes", [(8, 4), (12, 3), (64, 7), (7, 2)])
def test_factorizations_equal(P, naxes):
    got = tpt._factorizations(P, naxes)
    assert got == jpt._factorizations(P, naxes)
    assert all(math.prod(f) == P for f in got)


def test_from_grid_and_rejection_equal():
    js, ts = _pair("conv2_x")
    for grid in ({}, {"N": 2, "hO": 4}, {"cI": 2, "wF": 3}):
        assert tpt.ParallelBlocking.from_grid(ts, grid).grid == \
            jpt.ParallelBlocking.from_grid(js, grid).grid
    with pytest.raises(ValueError, match="unknown loop axis"):
        tpt.ParallelBlocking.from_grid(ts, {"zz": 2})


def test_work_below_P_is_capped_where_the_reference_raises():
    """ROADMAP queue 3's reference fault: 4 updates over 16 processors make
    the reference's work-balance equality log(G/P) < 0 infeasible; the port
    caps P at G and returns a grid of at most G processors."""
    kw = dict(N=1, c_I=1, c_O=1, w_O=2, h_O=2, w_F=1, h_F=1, sw=1, sh=1)
    js, ts = jc.ConvShape(**kw), tc.ConvShape(**kw)
    with pytest.raises(RuntimeError, match="LP failed"):
        jpt.optimize_parallel_blocking(js, 16)
    pb = tpt.optimize_parallel_blocking(ts, 16)
    assert pb.P == ts.G == 4
    assert pb.work_per_processor() == 1 and pb.imbalance() == 1.0
    # at G the two agree again
    assert pb.grid == jpt.optimize_parallel_blocking(js, 4).grid


# ---------------------------------------------------------------------------
# sharding_opt
# ---------------------------------------------------------------------------

MESHES = {
    "dist_2x2x2": (("N", 2), ("cI", 2), ("hO", 2), ("wO", 1)),
    "data_model": (("data", 4), ("model", 2)),
    "pod": (("pod", 2), ("data", 16), ("model", 16)),
    "one_axis": (("data", 8),),
}


def _plan_fields(p):
    return (p.binding, p.mesh_axes, p.comm_per_processor, p.grid,
            p.input_spec, p.filter_spec, p.output_spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", LAYERS)
def test_conv_sharding_plans_equal(name, mesh):
    js, ts = _pair(name)
    jp = jso.plan_conv_sharding(js, MESHES[mesh])
    tp = tso.plan_conv_sharding(ts, MESHES[mesh])
    assert _plan_fields(tp) == _plan_fields(jp)
    shard = ("N", "cI", "cO")
    assert _plan_fields(tso.plan_conv_sharding(ts, MESHES[mesh], shard)) == \
        _plan_fields(jso.plan_conv_sharding(js, MESHES[mesh], shard))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mnk", [(512, 384, 256), (2048, 2048, 2048),
                                 (49000, 512, 4608)])
def test_gemm_sharding_and_lm_ranking_equal(mnk, mesh):
    m, n, k = mnk
    assert _plan_fields(tso.plan_gemm_sharding(m, n, k, MESHES[mesh])) == \
        _plan_fields(jso.plan_gemm_sharding(m, n, k, MESHES[mesh]))
    assert tso.rank_lm_shardings(8, 2048, 11008, 16, MESHES[mesh]) == \
        jso.rank_lm_shardings(8, 2048, 11008, 16, MESHES[mesh])


# ---------------------------------------------------------------------------
# algorithms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prec", sorted(PRECS))
@pytest.mark.parametrize("name", LAYERS)
def test_algorithm_volumes_equal(name, prec):
    js, ts = _pair(name, prec, N=32)
    for M in (2.0 ** 15, 2.0 ** 20):
        assert ta.single_processor_volumes(ts, M) == \
            ja.single_processor_volumes(js, M)
    for P in (4, 64):
        assert ta.parallel_volumes(ts, P, 2.0 ** 20) == \
            ja.parallel_volumes(js, P, 2.0 ** 20)
    assert ta.gemm_volume(300, 200, 100, 4096.0, 0.5, 0.5, 1.0) == \
        ja.gemm_volume(300, 200, 100, 4096.0, 0.5, 0.5, 1.0)


# ---------------------------------------------------------------------------
# hbl
# ---------------------------------------------------------------------------

PHIS = {
    "conv7nl": lambda m: m.conv7nl_phis(),
    "conv7nl_s2": lambda m: m.conv7nl_phis(2, 2),
    "conv7nl_s21": lambda m: m.conv7nl_phis(2, 1),
    "conv7nl_lifted": lambda m: m.conv7nl_lifted_phis(),
    "matmul": lambda m: m.matmul_phis(),
}


@pytest.mark.parametrize("which", sorted(PHIS))
def test_hbl_constraints_and_exponents_equal(which):
    tphi, jphi = PHIS[which](th), PHIS[which](jh)
    tcons, jcons = th.hbl_constraints(tphi), jh.hbl_constraints(jphi)
    assert tcons == jcons
    assert th.constraint_table(tphi) == jh.constraint_table(jphi)
    ts, tsum = th.solve_exponents(tphi)
    js, jsum = jh.solve_exponents(jphi)
    assert np.array_equal(ts, js) and tsum == jsum
    # the kernels' canonical bases, as Fractions
    for a, b in zip(tphi, jphi):
        assert a.kernel().basis == b.kernel().basis
        assert all(isinstance(x, Fraction) for row in a.kernel().basis
                   for x in row)
        assert a.mat == b.mat and a.name == b.name


def test_hbl_lattice_and_linear_algebra_equal():
    tphi, jphi = th.conv7nl_phis(), jh.conv7nl_phis()
    tl = th.subgroup_lattice([p.kernel() for p in tphi])
    jl = jh.subgroup_lattice([p.kernel() for p in jphi])
    assert [s.basis for s in tl] == [s.basis for s in jl]
    rows = [[Fraction(v) for v in r] for r in ((1, 2, 3), (2, 4, 6),
                                               (0, 1, 1))]
    assert th.rref(rows) == jh.rref(rows)
    assert th.nullspace(rows, 3) == jh.nullspace(rows, 3)
    assert th.rank(rows) == jh.rank(rows) == 2
    a = th.Subspace(3, rows[:1])
    b = th.Subspace(3, rows[2:])
    ja_, jb_ = jh.Subspace(3, rows[:1]), jh.Subspace(3, rows[2:])
    assert a.sum(b).basis == ja_.sum(jb_).basis
    assert a.intersect(b).basis == ja_.intersect(jb_).basis
    # the weighted LP too
    ts, tsum = th.solve_exponents(tphi, weights=[1.0, 2.0, 3.0])
    js, jsum = jh.solve_exponents(jphi, weights=[1.0, 2.0, 3.0])
    assert np.array_equal(ts, js) and tsum == jsum
