"""repro_torch.plan.autotune against repro.plan.autotune on the paper's five
ResNet-50 layers (batch 1000; bf16 or the target's precision, and int8),
their Im2Col GEMMs and the three int8 GEMMs of ``chip_smoke.py`` phase 11,
under ``TPU_V5E``, ``CPU_INTERPRET`` and the H100 target dict: equal
candidate sets element for element, equal words for every candidate, and,
with the port's roofline constants set to the reference's, an equal
frontier and offline ranking. Tuning records load across the packages.

The audit gate is where the packages differ, and every difference is
pinned: the H100 kernels cannot launch some tiles the memory model admits
(``REF_ONLY``), and the reference's Pallas budget refuses conv tiles whose
whole c_I block it would double-buffer, which the CUDA ring stages in parts
(``PORT_ONLY``)."""

import json

import pytest

import repro.plan as jp
import repro_torch.plan as tp
from repro import ops as jops
from repro.core.conv_model import Precision as JPrecision
from repro.core.conv_model import resnet50_layers
from repro.ops import registry as jregistry
from repro.ops.dispatch import DispatchDecision as JDecision
from repro.plan import autotune as jat
from repro.plan import planner as jplanner
from repro.verify import audit as jaudit
from repro_torch import ops as tops
from repro_torch.analysis import roofline
from repro_torch.core.conv_model import Precision
from repro_torch.ops import registry as tregistry
from repro_torch.plan import autotune as tat
from repro_torch.plan import planner as tplanner
from repro_torch.quant import INT8_SPEC as T_INT8

PRESETS = ("TPU_V5E", "CPU_INTERPRET", "H100")
# chip_smoke.py phase 11's int8 GEMMs, (m, k, n)
INT8_GEMMS = ((512, 384, 256), (2048, 2048, 2048), (49000, 4608, 512))


def _specs():
    """label -> (reference spec, port spec, int8?)."""
    out = {}
    for k, s in resnet50_layers(1000).items():
        f = dict(N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O, h_O=s.h_O,
                 w_F=s.w_F, h_F=s.h_F, sw=s.sw, sh=s.sh)
        out[k] = (jp.ConvSpec(**f), tp.ConvSpec(**f), False)
        out[f"{k} int8"] = (jp.ConvSpec(**f, prec=JPrecision(.25, .25, .5)),
                            tp.ConvSpec(**f, prec=Precision(.25, .25, .5)),
                            True)
        m, kk, n = s.N * s.h_O * s.w_O, s.c_I * s.h_F * s.w_F, s.c_O
        out[f"{k} Im2Col"] = (jp.MatmulSpec(m, n, kk, JPrecision(.5, .5, 1.)),
                              tp.MatmulSpec(m, n, kk, Precision(.5, .5, 1.)),
                              False)
    for m, k, n in INT8_GEMMS:
        out[f"int8 {m}x{k}x{n}"] = (
            jp.MatmulSpec(m, n, k, JPrecision(.25, .25, .5)),
            tp.MatmulSpec(m, n, k, Precision(.25, .25, .5)), True)
    return out


SPECS = _specs()


def _targets(preset, int8):
    t = getattr(tp, preset)
    if int8 and preset == "H100":
        t = t.with_quant(T_INT8)
    return jp.HardwareTarget.from_dict(t.to_dict()), t


class _Side:
    """One package's view of a search up to the audit gate."""

    def __init__(self, at, planner, registry, backend, ctx, op, target):
        self.at, self.ctx = at, ctx
        self.op = at._normalize(op, target)
        self.name, self.args, self.kw = at._op_call(self.op, target)
        self.entry = registry.get_backend(backend).ops[self.name]
        self.base = planner.analytic_plan(self.op, target)
        self.tiles = (at._conv_candidates(self.op, target, self.base.tiles)
                      if "conv" in self.name else
                      at._matmul_candidates(self.op, target, self.base.tiles))

    def words(self, tiles):
        cand = self.at._candidate_plan(self.base, self.op, tiles, 0.0)
        return float(self.entry.words_fn(self.ctx, cand, *self.args,
                                         **self.kw))

    def frontier(self, policy):
        """The search's (plan, words) frontier, ranked, and its kept head."""
        at, bw = self.at, self.words(self.base.tiles)
        cap = max(policy.bound_cap * self.base.lower_bound, bw)
        fr = [(at._candidate_plan(self.base, self.op, t, w), w)
              for t, w in ((t, self.words(t)) for t in self.tiles)
              if w <= policy.slack * bw + 1e-9 and w <= cap + 1e-9]
        fr.sort(key=lambda cw: (at._offline_seconds(cw[1], cw[0].grid),
                                cw[1], cw[0].tiles))
        keep = fr[:policy.max_candidates]
        if not any(c.tiles == self.base.tiles for c, _ in keep):
            keep.append((at._candidate_plan(self.base, self.op,
                                            self.base.tiles, bw), bw))
        return fr, keep


def _sides(label, preset):
    jop, top, int8 = SPECS[label]
    jt, tt = _targets(preset, int8)
    ref = _Side(jat, jplanner, jregistry, "pallas",
                jops.ExecutionContext(target=jt, backend="pallas"), jop, jt)
    port = _Side(tat, tplanner, tregistry, "cuda",
                 tops.ExecutionContext(target=tt, backend="cuda",
                                       device="cpu"), top, tt)
    return ref, port, jt, tt


@pytest.fixture
def reference_constants(monkeypatch):
    """The port's roofline priced as the reference's TPU v5e model."""
    monkeypatch.setattr(roofline, "HBM_BW", 819e9)
    monkeypatch.setattr(roofline, "DMA_SETUP_SECONDS", 2e-6)


def _key(fr):
    return [(c.tiles, c.grid, w) for c, w in fr]


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("label", list(SPECS))
def test_candidates_words_frontier_and_ranking_equal(label, preset,
                                                     reference_constants):
    ref, port, _, _ = _sides(label, preset)
    assert port.base.tiles == ref.base.tiles
    assert port.name == ref.name
    assert port.tiles == ref.tiles  # element for element, in order
    assert [port.words(t) for t in port.tiles] == [ref.words(t)
                                                   for t in ref.tiles]
    policy = tp.AutotunePolicy(timer="roofline")
    (jfr, jkeep), (tfr, tkeep) = (ref.frontier(policy),
                                  port.frontier(policy))
    assert _key(tfr) == _key(jfr) and _key(tkeep) == _key(jkeep)
    assert tat.predicted_seconds(port.base) == jat.predicted_seconds(
        ref.base)
    assert [tat._offline_seconds(w, c.grid) for c, w in tfr] == [
        jat._offline_seconds(w, c.grid) for c, w in jfr]


# Kept candidates (reference constants) the reference audits and the H100
# kernels cannot launch, with the launch limit each hits.
_ACC = "accumulators above a CTA's registers"
REF_ONLY = {
    "conv1 Im2Col": {(368, 64, 16): _ACC},
    "conv2_x Im2Col": {(368, 64, 16): _ACC},
    "conv3_x Im2Col": {(176, 128, 32): _ACC, (368, 64, 16): _ACC,
                       (176, 128, 16): _ACC},
    "conv4_x Im2Col": {(176, 128, 32): _ACC, (80, 256, 32): _ACC,
                       (368, 64, 16): _ACC, (176, 128, 16): _ACC,
                       (80, 256, 16): _ACC},
    "conv5_x Im2Col": {(176, 128, 32): _ACC, (176, 128, 16): _ACC},
    "int8 49000x4608x512": {(368, 128, 32): _ACC, (176, 256, 32): _ACC,
                            (368, 128, 16): _ACC, (176, 256, 16): _ACC},
}
# Kept conv candidates with 64-channel c_I blocks the port audits and the
# reference refuses: its Pallas kernel double-buffers the whole block in
# VMEM, past the H100's 58,112 words, where the CUDA ring stages it in parts.
PORT_ONLY = {
    "conv2_x int8": {(1, 64, 64, 8, 56), (1, 64, 64, 56, 8)},
    "conv3_x": {(1, 64, 32, 14, 28), (1, 64, 32, 28, 14)},
    "conv3_x int8": {(5, 64, 64, 7, 14), (5, 64, 64, 14, 7)},
    "conv4_x": {(2, 64, 32, 14, 14)},
    "conv4_x int8": {(5, 64, 64, 7, 14), (5, 64, 64, 14, 7)},
    "conv5_x int8": {(10, 64, 64, 7, 7)},
}


@pytest.mark.parametrize("label", list(SPECS))
def test_audited_sets_differ_only_where_pinned(label, reference_constants):
    ref, port, jt, tt = _sides(label, "H100")
    policy = tp.AutotunePolicy(timer="roofline")
    (_, jkeep), (_, tkeep) = ref.frontier(policy), port.frontier(policy)
    assert _key(tkeep) == _key(jkeep)
    ref_ok, ref_why = set(), {}
    for cand, w in jkeep:
        ap = ref.entry.access_plan_fn(ref.ctx, cand, *ref.args, **ref.kw)
        rep = jaudit.audit_decision(ap, JDecision(
            op=ref.name, requested="pallas", chosen="pallas", plan=cand,
            measured_words=w, plan_source="explicit"), target=jt)
        if rep.ok:
            ref_ok.add(cand.tiles)
        else:
            ref_why[cand.tiles] = rep.problems
    port_why = {c.tiles: tat._audit_failure(port.entry, port.ctx, port.name,
                                            port.args, port.kw, c, w)
                for c, w in tkeep}
    port_ok = {t for t, why in port_why.items() if why is None}
    assert {t: port_why[t] for t in ref_ok - port_ok} == REF_ONLY.get(
        label, {})
    assert port_ok - ref_ok == PORT_ONLY.get(label, set())
    for t in PORT_ONLY.get(label, ()):
        (problem,) = ref_why[t]
        assert "VMEM scratch" in problem and "exceeds the target's 58112" \
            in problem
    assert ref.base.tiles in port_ok  # the analytic tiles always audit


# ---------------------------------------------------------------------------
# records and fingerprints cross the packages
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_caches():
    jp.Planner.cache.clear()
    tp.Planner.cache.clear()
    yield
    jp.Planner.cache.clear()
    tp.Planner.cache.clear()


@pytest.mark.parametrize("preset", PRESETS)
def test_target_fingerprints_equal(preset):
    for int8 in (False, True):
        jt, tt = _targets(preset, int8)
        assert tat.target_fingerprint(tt) == jat.target_fingerprint(jt)


def test_records_load_across_the_packages(fresh_caches):
    jt, tt = _targets("H100", False)
    jop = jp.MatmulSpec(300, 200, 100, JPrecision(.5, .5, 1.))
    top = tp.MatmulSpec(300, 200, 100, Precision(.5, .5, 1.))
    roof = tp.AutotunePolicy(timer="roofline")
    tp.Planner(tt).autotune(top, policy=roof)
    jp.Planner(jt).autotune(jop, policy=jp.AutotunePolicy(timer="roofline"))
    (trec,), (jrec,) = tat.records(), jat.records()
    from_port = jat.TuningRecord.from_dict(json.loads(json.dumps(
        trec.to_dict())))
    from_ref = tat.TuningRecord.from_dict(json.loads(json.dumps(
        jrec.to_dict())))
    assert from_port.to_dict() == trec.to_dict()
    assert from_ref.to_dict() == jrec.to_dict()
    assert from_port.target == jt and from_ref.target == tt
    assert from_port.op == jat._normalize(jop, jt)
    assert from_ref.op == tat._normalize(top, tt)
    # a TPU_V5E record from the reference is served by the port as written
    jp.Planner(jp.TPU_V5E).autotune(
        jp.ConvSpec(N=4, c_I=8, c_O=16, w_O=14, h_O=14, w_F=3, h_F=3),
        policy=jp.AutotunePolicy(timer="roofline"))
    (jtpu,) = [r for r in jat.records() if r.target == jp.TPU_V5E]
    tp.Planner.cache.clear()
    n0 = tat.search_count()
    tat.install_record(tat.TuningRecord.from_dict(jtpu.to_dict()))
    served, src = tp.resolve_plan(
        tp.ConvSpec(N=4, c_I=8, c_O=16, w_O=14, h_O=14, w_F=3, h_F=3),
        tp.TPU_V5E)
    assert src == "tuned" and served.tiles == jtpu.tiles
    assert served.grid == jtpu.grid
    assert tat.search_count() == n0

