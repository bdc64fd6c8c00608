"""repro_torch.models.sharding against repro.models.sharding: every spec
function for every architecture (exact), the static rule tables against
the port's LP with the reference's documented-divergence contract, the
dry-run cells (``SKIPS``, ``cells``, ``all_cells``), the optimizer's specs,
and the specs' DTensor placements.

Meshes are JAX-like stand-ins (``axis_names``, ``devices`` and ``shape``):
both packages' spec functions read only the axes' names and sizes."""

from types import SimpleNamespace

import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jc
from repro.core.sharding_opt import rank_lm_shardings as j_rank
from repro.models import sharding as jshd
from repro.train.optimizer import opt_state_specs as j_opt_specs
from repro_torch import configs as tc
from repro_torch.core.sharding_opt import rank_lm_shardings
from repro_torch.models import sharding as shd
from repro_torch.train.optimizer import opt_state_specs
from repro_torch.train.trainer import reference_leaf

ARCHS = tc.ARCH_IDS
MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
          "2x2": (("data", 2), ("model", 2)),
          "8x8": (("data", 8), ("model", 8))}
# the reference's sharding-rule test: 4096 tokens a data shard, 8 x 8
TOKENS = 4096
KNOWN_DIVERGENT = ("wo", "w_out", "w_down", "wk", "wv")


def _mesh(name):
    axes = MESHES[name]
    return SimpleNamespace(axis_names=tuple(n for n, _ in axes),
                           devices=np.empty(tuple(s for _, s in axes)),
                           shape=dict(axes))


def _ref_leaf(tree, name):
    node = tree
    for k in name.split("."):
        node = node[k]
    return node


def _ref_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _ref_paths(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1]


def test_cells_are_the_reference():
    assert tc.SKIPS == jc.SKIPS
    for arch in ARCHS:
        assert [s.name for s in tc.cells(arch)] == \
            [s.name for s in jc.cells(arch)]
    assert sorted((a, s.name) for a, s in tc.all_cells()) == \
        sorted((a, s.name) for a, s in jc.all_cells())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_reference(arch):
    """A port parameter's spec is the reference's of its stacked leaf with
    the leading repeats ``None`` dropped; every reference leaf is
    covered."""
    cfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    ours, ref = shd.param_specs(cfg), jshd.param_specs(jcfg)
    for name, spec in ours.items():
        want = tuple(_ref_leaf(ref, reference_leaf(name)))
        if name.startswith("layers."):
            assert want[0] is None, (name, want)
            want = want[1:]
        assert isinstance(spec, shd.P) and tuple(spec) == want, (name, spec)
    assert {reference_leaf(n) for n in ours} == set(_ref_paths(ref))


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_param_specs_are_the_reference_tree(arch):
    got = shd.stacked_param_specs(tc.get_config(arch))
    want = jshd.param_specs(jc.get_config(arch))
    assert {k: tuple(v) for k, v in _leaves(got)} == \
        {k: tuple(v) for k, v in _leaves(want)}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_are_the_reference(arch):
    cfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    for mname in MESHES:
        mesh = _mesh(mname)
        assert shd.data_axes(mesh) == jshd.data_axes(mesh)
        assert shd.batch_axes(mesh) == jshd.batch_axes(mesh)
        for batch, seq in ((128, 32768), (32, 32768), (1, 524288),
                           (3, 64)):
            got = shd.cache_specs(cfg, mesh, batch, seq)
            want = jshd.cache_specs(jcfg, mesh, batch, seq)
            assert got.keys() == want.keys()
            for b in got:
                assert {k: tuple(v) for k, v in got[b].items()} == \
                    {k: tuple(v) for k, v in want[b].items()}, (mname, b)
        for kind in ("train", "prefill", "decode"):
            got = shd.batch_specs(cfg, mesh, kind)
            want = jshd.batch_specs(jcfg, mesh, kind)
            assert {k: tuple(v) for k, v in got.items()} == \
                {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_static_rule_gemms_are_the_reference(arch):
    got = shd.static_rule_gemms(tc.get_config(arch), TOKENS)
    want = jshd.static_rule_gemms(jc.get_config(arch), TOKENS)
    assert [(n, mnk, tuple(s)) for n, mnk, s in got] == \
        [(n, mnk, tuple(s)) for n, mnk, s in want]


@pytest.mark.parametrize("arch,mname", [(a, "8x8") for a in ARCHS] + [
    (a, "2x2") for a in ("qwen2_5_3b", "jamba_1_5_large", "xlstm_1_3b")])
def test_gemm_sharding_plan_is_the_reference(arch, mname):
    """The LP's specs of every distinct GEMM of the tables, on the
    reference test's mesh (and on 2 x 2)."""
    mesh = _mesh(mname)
    for name, (m, n, k), _ in shd.static_rule_gemms(tc.get_config(arch),
                                                   TOKENS):
        _, a, b, c = shd.gemm_sharding_plan(m, n, k, mesh)
        _, ja, jb, jc_ = jshd.gemm_sharding_plan(m, n, k, mesh)
        assert (tuple(a), tuple(b), tuple(c)) == \
            (tuple(ja), tuple(jb), tuple(jc_)), name


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "jamba_1_5_large",
                                  "xlstm_1_3b"])
def test_static_tables_match_lp_or_documented(arch):
    """The reference's contract on the port's LP: a table spec the LP does
    not reproduce is one of the documented divergences (paired
    row-parallelism, GQA-narrow projections)."""
    mesh = _mesh("8x8")
    undocumented = []
    for name, (m, n, k), table in shd.static_rule_gemms(
            tc.get_config(arch), TOKENS):
        _, _, lp, _ = shd.gemm_sharding_plan(m, n, k, mesh)
        if tuple(lp) != tuple(table) and not name.endswith(KNOWN_DIVERGENT):
            undocumented.append((name, tuple(table), tuple(lp)))
    assert not undocumented


def test_documented_divergences_still_diverge():
    mesh = _mesh("8x8")
    stale = []
    for name, (m, n, k), table in shd.static_rule_gemms(
            tc.get_config("qwen2_5_3b"), TOKENS):
        if name.endswith(KNOWN_DIVERGENT) and not name.endswith("w_down"):
            _, _, lp, _ = shd.gemm_sharding_plan(m, n, k, mesh)
            if tuple(lp) == tuple(table):
                stale.append(name)
    assert not stale


def test_megatron_ranks_first_at_stack_level():
    cfg = tc.get_config("qwen2_5_3b")
    args = (TOKENS, cfg.d_model, cfg.d_ff, cfg.n_heads, list(MESHES["8x8"]))
    ranking = rank_lm_shardings(*args)
    assert ranking[0][0] == "megatron"
    assert [r[0] for r in ranking] == [r[0] for r in j_rank(*args)]


def test_opt_state_specs_are_the_reference():
    cfg = tc.get_config("qwen2_5_3b")
    got = opt_state_specs(shd.param_specs(cfg))
    want = j_opt_specs(jshd.param_specs(jc.get_config("qwen2_5_3b")))
    assert tuple(got.step) == tuple(want.step) == ()
    for name, spec in got.m.items():
        assert got.v[name] == spec
        assert tuple(spec) == tuple(_ref_leaf(want.m, reference_leaf(
            name)))[(1 if name.startswith("layers.") else 0):]


@pytest.mark.parametrize("spec,mname,want", [
    (shd.P(None, "model"), "16x16", (Replicate(), Shard(1))),
    (shd.P("model", None), "2x16x16", (Replicate(), Replicate(), Shard(0))),
    (shd.P(("pod", "data"), None), "2x16x16",
     (Shard(0), Shard(0), Replicate())),
    (shd.P(None, "data", None, "model", None), "16x16",
     (Shard(1), Shard(3))),
    (shd.P(None, None, None, ("data", "model"), None), "16x16",
     (Shard(3), Shard(3))),
    (shd.P(), "2x2", (Replicate(), Replicate())),
])
def test_placements_of_specs(spec, mname, want):
    mesh = _mesh(mname)
    assert shd.placements(mesh, spec) == want


@pytest.mark.parametrize("spec", [shd.P(("model", "data")),
                                  shd.P("data", "data"), shd.P("expert")])
def test_placements_refuse_bad_specs(spec):
    with pytest.raises(ValueError):
        shd.placements(_mesh("16x16"), spec)


def test_shardings_map_every_spec_leaf():
    mesh = _mesh("2x2")
    tree = {"a": shd.P(None, "model"), "b": {"c": shd.P("data")}}
    out = shd.shardings(mesh, tree)
    assert out["a"].placements == (Replicate(), Shard(1))
    assert out["b"]["c"].spec == shd.P("data")
    assert repr(shd.P(None, "model")) == "P(None, 'model')"
