"""repro_torch.plan against repro.plan: equal plans for every preset on the
paper's layers and their Im2Col GEMMs, plan JSON crossing both ways, and the
port's own rules (H100 default, the autotuner on the CPU)."""

import json

import pytest

import repro.plan as jp
import repro_torch.plan as tp
from repro.core.conv_model import Precision as JPrecision
from repro.core.conv_model import resnet50_layers
from repro_torch.core.conv_model import Precision

PRESETS = ("TPU_V5E", "GEMMINI", "CPU_INTERPRET", "H100")


def _targets(name):
    t = getattr(tp, name)
    # the reference has no H100 preset: rebuild it from the port's JSON
    return jp.HardwareTarget.from_dict(t.to_dict()), t


def _conv_ops(prec):
    out = []
    for k, s in resnet50_layers(1000).items():
        f = dict(N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O, h_O=s.h_O,
                 w_F=s.w_F, h_F=s.h_F, sw=s.sw, sh=s.sh)
        out.append((k, jp.ConvSpec(**f, prec=prec and JPrecision(*prec)),
                    tp.ConvSpec(**f, prec=prec and Precision(*prec))))
    return out


def _gemm_ops():
    """The Im2Col GEMMs of the five layers: (N h_O w_O) x (c_I h_F w_F) x c_O,
    bf16 streams as the kernels build them."""
    out = []
    for k, s in resnet50_layers(1000).items():
        m, kk, n = s.N * s.h_O * s.w_O, s.c_I * s.h_F * s.w_F, s.c_O
        out.append((f"{k}_gemm", jp.MatmulSpec(m, n, kk, JPrecision(.5, .5, 1.)),
                    tp.MatmulSpec(m, n, kk, Precision(.5, .5, 1.))))
    return out


def _assert_same(jplan, tplan):
    assert tplan.tiles == jplan.tiles
    assert tplan.grid == jplan.grid
    assert tplan.blocking == jplan.blocking
    assert tplan.comm_volume == jplan.comm_volume
    assert tplan.lower_bound == jplan.lower_bound
    assert tplan.efficiency == jplan.efficiency
    assert tplan.dtypes == jplan.dtypes


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("prec", [None, (0.5, 0.5, 1.0)],
                         ids=["target_prec", "bf16"])
def test_conv_plans_equal(preset, prec):
    jt, tt = _targets(preset)
    for name, jop, top in _conv_ops(prec):
        _assert_same(jp.Planner(jt).plan(jop), tp.Planner(tt).plan(top))


@pytest.mark.parametrize("preset", PRESETS)
def test_gemm_plans_equal(preset):
    jt, tt = _targets(preset)
    for name, jop, top in _gemm_ops():
        _assert_same(jp.Planner(jt).plan(jop), tp.Planner(tt).plan(top))


@pytest.mark.parametrize("preset", PRESETS)
def test_plan_json_crosses_both_ways(preset):
    jt, tt = _targets(preset)
    for _, jop, top in _conv_ops(None)[:2] + _gemm_ops()[:2]:
        jplan, tplan = jp.Planner(jt).plan(jop), tp.Planner(tt).plan(top)
        from_port = jp.ExecutionPlan.from_json(tplan.to_json())
        from_ref = tp.ExecutionPlan.from_json(jplan.to_json())
        _assert_same(jplan, from_ref)
        _assert_same(from_port, tplan)
        assert from_port.to_dict() == jplan.to_dict()
        assert from_ref.to_dict() == tplan.to_dict()
        assert from_ref.target == tt and from_port.target == jt


def test_tuned_section_round_trips():
    plan = tp.Planner(tp.H100).plan(tp.MatmulSpec(256, 256, 256))
    d = plan.to_dict()
    d["tuned"] = {"source": "device", "candidates_timed": 7,
                  "winner_words": plan.comm_volume, "winner_seconds": 1e-4}
    back = tp.ExecutionPlan.from_dict(json.loads(json.dumps(d)))
    assert back.tuned.candidates_timed == 7 and back.to_dict() == d
    assert jp.ExecutionPlan.from_dict(d).to_dict() == d


def test_plan_cache_dump_crosses(tmp_path):
    tplan = tp.Planner(tp.H100).plan(tp.MatmulSpec(300, 200, 100))
    path = str(tmp_path / "plans.json")
    tp.Planner.cache.save(path)
    assert jp.Planner.cache.load(path) >= 1
    jt = jp.HardwareTarget.from_dict(tp.H100.to_dict())
    _assert_same(jp.Planner(jt).plan(jp.MatmulSpec(300, 200, 100)), tplan)
    jp.Planner(jp.TPU_V5E).plan(jp.MatmulSpec(64, 64, 64))
    jpath = str(tmp_path / "ref.json")
    with open(jpath, "w") as f:  # a reference dump without tuning records
        json.dump({"format": 6, "plans": [
            jp.Planner(jp.TPU_V5E).plan(jp.MatmulSpec(64, 64, 64)).to_dict()],
            "tuning": []}, f)
    assert tp.Planner.cache.load(jpath) == 1
    # a reference dump with a tuning record: the port serves its winner
    # without a search of its own
    from repro.plan import autotune as jat
    from repro_torch.plan import autotune as tat

    jop = jp.MatmulSpec(300, 200, 100, JPrecision(.5, .5, 1.))
    top = tp.MatmulSpec(300, 200, 100, Precision(.5, .5, 1.))
    try:
        jtuned = jp.Planner(jt).autotune(
            jop, policy=jp.AutotunePolicy(timer="roofline"))
        (rec,) = [r for r in jat.records() if r.op == jop]
        with open(jpath, "w") as f:
            json.dump({"format": 6, "plans": [],
                       "tuning": [rec.to_dict()]}, f)
        tp.Planner.cache.clear()
        n0 = tat.search_count()
        assert tp.Planner.cache.load(jpath) == 1
        served, src = tp.Planner(tp.H100).resolve(top)
        assert src == "tuned" and served.tiles == jtuned.tiles
        assert served.tuned.to_dict() == jtuned.tuned.to_dict()
        assert tat.search_count() == n0
    finally:
        jp.Planner.cache.clear()
        tp.Planner.cache.clear()


def test_port_defaults_and_limits():
    assert tp.Planner().target is tp.H100
    assert tp.resolve_plan(tp.MatmulSpec(64, 64, 64))[0].target is tp.H100
    assert tp.H100.memory_model().M_eff == 29056.0
    assert tp.H100.memory_model().M_acc_eff == 16384.0
    assert tp.get_target("h100") is tp.H100
    roofline = tp.AutotunePolicy(timer="roofline")
    try:
        tuned = tp.Planner(tp.H100, autotune=roofline).plan(
            tp.MatmulSpec(64, 64, 64))
        assert tuned.tuned is not None and tuned.tuned.source == "roofline"
        p, src = tp.resolve_plan(tp.MatmulSpec(96, 64, 64), tp.H100,
                                 autotune=roofline)
        assert src == "tuned" and p.tuned is not None
    finally:
        tp.Planner.cache.clear()
    # a mesh target plans its sharding (the reference's mesh leg)
    meshed = tp.Planner(tp.H100.with_mesh([("data", 4)])).plan(
        tp.MatmulSpec(64, 64, 64))
    assert meshed.sharding is not None and meshed.parallel is None
    ep = tp.Planner().plan(tp.ConvSpec(N=2, c_I=64, c_O=64, w_O=56, h_O=56,
                                       w_F=3, h_F=3))
    fp = ep.kernel_footprints()
    assert fp["input"] + fp["filter"] <= 29056.0
    assert fp["output"] <= 16384.0
