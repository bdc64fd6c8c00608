"""The port's measured autotune stage (``repro_torch.plan.autotune``), the
counterpart of ``tests/test_autotune.py`` under the port's ``H100`` target:
candidates that reach the timer audit against their CUDA launch (or are
counted as not auditable), the roofline-timed winner is deterministic,
records persist through the PlanCache, and the shared resolution path
reports where every plan came from. Without a card the ``"auto"`` timer is
the roofline and ``"device"`` raises."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from repro_torch import ops
from repro_torch.core.conv_model import Precision
from repro_torch.ops import registry
from repro_torch.plan import (H100, TPU_V5E, AttentionSpec, AutotunePolicy,
                              ConvSpec, MatmulSpec, Planner, TuningRecord,
                              predicted_seconds, resolve_plan,
                              target_fingerprint)
from repro_torch.plan import autotune as at
from repro_torch.plan import planner as planner_mod
from repro_torch.resilience.errors import DeviceLost

CONV = ConvSpec(N=4, c_I=8, c_O=32, w_O=14, h_O=14, w_F=3, h_F=3)
MM = MatmulSpec(256, 192, 128)
ROOFLINE = AutotunePolicy(timer="roofline")
CPU = ops.ExecutionContext(target=H100, backend="cuda", device="cpu")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_cache():
    Planner.cache.clear()
    yield
    Planner.cache.clear()


# ---------------------------------------------------------------------------
# policy + record plumbing
# ---------------------------------------------------------------------------

def test_policy_coerce():
    assert AutotunePolicy.coerce(None) is None
    assert AutotunePolicy.coerce(False) is None
    assert AutotunePolicy.coerce(True) == AutotunePolicy()
    pol = AutotunePolicy(slack=1.1, timer="roofline")
    assert AutotunePolicy.coerce(pol) is pol
    with pytest.raises(TypeError):
        AutotunePolicy.coerce("yes please")


def test_tuning_record_roundtrip():
    ep = Planner(H100).autotune(CONV, policy=ROOFLINE)
    (rec,) = at.records()
    back = TuningRecord.from_dict(rec.to_dict())
    assert back == rec
    assert back.fingerprint == target_fingerprint(H100)
    assert ep.tiles == rec.tiles and ep.tuned == rec.tuned


def test_tuning_record_rejects_fingerprint_mismatch():
    Planner(H100).autotune(CONV, policy=ROOFLINE)
    (rec,) = at.records()
    d = rec.to_dict()
    d["target_fingerprint"] = "0" * 12
    with pytest.raises(ValueError, match="fingerprint"):
        TuningRecord.from_dict(d)
    d2 = rec.to_dict()
    d2["version"] = at.TUNING_FORMAT_VERSION + 1
    with pytest.raises(ValueError, match="newer"):
        TuningRecord.from_dict(d2)


# ---------------------------------------------------------------------------
# frontier: every timed candidate audits against its CUDA launch
# ---------------------------------------------------------------------------

def _frontier_survivors(spec, target=H100):
    """Re-run the search's enumerate->slack/cap filter and return the
    candidate plans the audit gate would see."""
    op = at._normalize(at.as_op_spec(spec), target)
    base = planner_mod.analytic_plan(op, target)
    op_name, spec_args, spec_kw = at._op_call(op, target)
    ctx = ops.ExecutionContext(target=target, backend="cuda", device="cpu")
    entry = registry.get_backend("cuda").ops[op_name]
    tiles = (at._conv_candidates(op, target, base.tiles)
             if isinstance(op, ConvSpec)
             else at._matmul_candidates(op, target, base.tiles))
    base_words = float(entry.words_fn(ctx, base, *spec_args, **spec_kw))
    cap = max(ROOFLINE.bound_cap * base.lower_bound, base_words)
    out = []
    for t in tiles:
        cand = at._candidate_plan(base, op, t, 0.0)
        w = float(entry.words_fn(ctx, cand, *spec_args, **spec_kw))
        if w <= ROOFLINE.slack * base_words + 1e-9 and w <= cap + 1e-9:
            out.append((entry, ctx, op_name, spec_args, spec_kw,
                        at._candidate_plan(base, op, t, w), w))
    return out


@pytest.mark.parametrize("spec", [CONV, MM], ids=["conv", "matmul"])
def test_frontier_candidates_all_audit_exact(spec):
    from repro_torch.ops.dispatch import DispatchDecision
    from repro_torch.verify import audit

    survivors = _frontier_survivors(spec)
    assert len(survivors) >= 2  # the frontier is non-trivial
    audited = 0
    for entry, ctx, op_name, spec_args, spec_kw, cand, w in survivors:
        try:
            ap = entry.access_plan_fn(ctx, cand, *spec_args, **spec_kw)
        except ValueError as exc:  # a tile the H100 kernels cannot launch
            assert at._reason(str(exc)) in dict(at._LAUNCH_LIMITS).values()
            continue
        decision = DispatchDecision(op=op_name, requested="cuda",
                                    chosen="cuda", plan=cand,
                                    measured_words=w, plan_source="explicit")
        res = audit.audit_decision(ap, decision, target=H100)
        assert res.ok, (cand.tiles, res.problems, res.hazards)
        assert ap.scratch_words() <= H100.vmem_words  # shared memory
        audited += 1
    assert audited >= 2


def test_search_report_accounts_for_every_kept_candidate():
    Planner(H100).autotune(MM, policy=ROOFLINE)
    rep = at.search_report(MM)
    assert rep.timer == "roofline"
    assert rep.enumerated >= rep.frontier >= len(rep.timed) >= 1
    refused = sum(n for _, n in rep.not_auditable)
    assert len(rep.timed) + refused == rep.kept
    assert rep.analytic_candidate.tiles == rep.analytic
    # under the roofline timer the timed seconds are the offline model's
    assert rep.winner == rep.roofline_pick
    assert all(c.seconds == c.offline_seconds for c in rep.timed)
    assert at.search_report(CONV) is None  # never searched


def test_not_auditable_candidates_are_counted_not_timed():
    # conv5_x's Im2Col GEMM: the (176, 128) tiles hold more accumulators
    # than a CTA of the bf16 GEMM has registers
    op = MatmulSpec(49000, 512, 4608, Precision(0.5, 0.5, 1.0))
    Planner(H100).autotune(op, policy=ROOFLINE)
    rep = at.search_report(op)
    assert dict(rep.not_auditable) == {
        "accumulators above a CTA's registers": 2}
    assert (176, 128, 16) not in {c.tiles for c in rep.timed}
    assert rep.analytic == (128, 128, 16)


def test_analytic_tiles_that_do_not_audit_raise():
    # under TPU_V5E the analytic (256, 128, 128) GEMM tile is past the bf16
    # GEMM's 8 warps: the search raises, it never skips the analytic tiles
    assert planner_mod.analytic_plan(MM, TPU_V5E).tiles == (256, 128, 128)
    with pytest.raises(RuntimeError, match="analytic tiles"):
        Planner(TPU_V5E).autotune(MM, policy=ROOFLINE)
    assert not at.records()


NARROW_CONVS = {  # (N, c_I, c_O, H = W), 3 x 3: their H100 analytic tiles
    (4, 8, 16, 16): (4, 8, 16, 14, 14),
    (4, 3, 8, 32): (2, 3, 8, 30, 30),
    (8, 16, 8, 30): (2, 16, 8, 28, 28)}


def test_narrow_conv_analytic_plan_does_not_launch():
    # the name is the open fault's, now a regression pin (ROADMAP queue 3,
    # closed): the H100 plans of convs with few output channels and many
    # pixels a tile (784 x 16, 1800 x 8, 1568 x 8 accumulators) fit the
    # accumulator budget but no rectangular warp block of conv2d_tc_kernel
    # within 8 warps; they take its LINEAR layout, so each audits and the
    # autotuner searches it
    for (N, c_I, c_O, H), tiles in NARROW_CONVS.items():
        narrow = ConvSpec(N=N, c_I=c_I, c_O=c_O, w_O=H - 2, h_O=H - 2,
                          w_F=3, h_F=3)
        assert planner_mod.analytic_plan(narrow, H100).tiles == tiles
        d = ops.explain("conv2d", CPU, audit=True, spec_args=(
            torch.empty((N, c_I, H, H), dtype=torch.bfloat16, device="meta"),
            torch.empty((c_O, c_I, 3, 3), dtype=torch.bfloat16,
                        device="meta")), spec_kw={"stride": (1, 1)})
        assert d.plan.tiles == tiles and d.audited == d.measured_words
        tuned = Planner(H100).autotune(narrow, policy=ROOFLINE)
        rep = at.search_report(narrow)
        assert rep.analytic == tiles and tiles in {c.tiles for c in rep.timed}
        assert tuned.tuned.candidates_timed == len(rep.timed) > 0


def test_device_timer_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    assert not at._use_device_timer(AutotunePolicy())
    assert at._use_device_timer(AutotunePolicy(timer="device"))
    with pytest.raises(DeviceLost):
        Planner(H100).autotune(CONV, policy=AutotunePolicy(timer="device"))
    assert not at.records()  # nothing fell back to the roofline
    tuned = Planner(H100).autotune(CONV)  # "auto": the roofline here
    assert tuned.tuned.source == "roofline"


# ---------------------------------------------------------------------------
# the search: determinism, winner never loses to analytic, counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [CONV, MM], ids=["conv", "matmul"])
def test_roofline_winner_deterministic(spec):
    first = Planner(H100).autotune(spec, policy=ROOFLINE)
    (rec1,) = at.records()
    Planner.cache.clear()
    second = Planner(H100).autotune(spec, policy=ROOFLINE)
    (rec2,) = at.records()
    assert rec1 == rec2
    assert first.tiles == second.tiles
    assert first.tuned.source == "roofline"
    assert at.search_count() >= 2  # both searches actually ran


def test_winner_never_slower_than_analytic_on_the_model():
    op = at._normalize(at.as_op_spec(CONV), H100)
    base = planner_mod.analytic_plan(op, H100)
    base_secs = predicted_seconds(base)
    tuned = Planner(H100).autotune(CONV, policy=ROOFLINE)
    assert tuned.tuned.winner_seconds <= base_secs + 1e-12
    assert tuned.tuned.candidates_timed >= 1
    assert tuned.comm_volume == tuned.tuned.winner_words


def test_autotune_memoizes_and_counts_searches():
    n0 = at.search_count()
    p1 = Planner(H100).autotune(CONV, policy=ROOFLINE)
    p2 = Planner(H100).autotune(CONV, policy=ROOFLINE)
    assert p1 is p2  # record hit materializes the identical cached plan
    assert at.search_count() == n0 + 1


def test_attention_is_unsearchable():
    spec = AttentionSpec(B=1, H=2, KV=2, Lq=128, Lk=128, hd=64)
    assert not at.supports(spec)
    with pytest.raises(TypeError, match="closed-form"):
        Planner(H100).autotune(spec)


# ---------------------------------------------------------------------------
# resolution path: explicit > tuned > analytic, everywhere the same
# ---------------------------------------------------------------------------

def test_resolve_plan_sources():
    p, src = resolve_plan(CONV, H100)
    assert src == "analytic" and p.tuned is None
    explicit, src2 = resolve_plan(CONV, H100, explicit=p)
    assert explicit is p and src2 == "explicit"
    tuned = Planner(H100).autotune(CONV, policy=ROOFLINE)
    p3, src3 = resolve_plan(CONV, H100)
    assert src3 == "tuned" and p3 is tuned


def test_resolve_plan_searches_under_policy():
    n0 = at.search_count()
    p, src = resolve_plan(CONV, H100, autotune=ROOFLINE)
    assert src == "tuned" and p.tuned is not None
    assert at.search_count() == n0 + 1


def _conv_call():
    x = torch.empty((CONV.N, CONV.c_I, 16, 16), dtype=torch.bfloat16,
                    device="meta")
    w = torch.empty((CONV.c_O, CONV.c_I, 3, 3), dtype=torch.bfloat16,
                    device="meta")
    return {"spec_args": (x, w), "spec_kw": {"stride": (1, 1)}}


def test_explain_reports_tuned_vs_analytic():
    before = ops.explain("conv2d", CPU, **_conv_call())
    assert before.plan_source == "analytic"
    tuning = dataclasses.replace(CPU, autotune=ROOFLINE)
    dec = ops.explain("conv2d", tuning, audit=True, **_conv_call())
    assert dec.plan_source == "tuned"
    assert dec.plan.tuned is not None
    assert dec.measured_words == dec.plan.tuned.winner_words
    assert dec.audited == dec.measured_words
    assert "tuned plan" in dec.why() and "candidates timed" in dec.why()
    # the record now serves every context for the pair, sans policy
    after = ops.explain("conv2d", CPU, **_conv_call())
    assert after.plan_source == "tuned"
    assert after.plan.tiles == dec.plan.tiles


def test_explain_explicit_plan_source():
    base = ops.explain("conv2d", CPU, **_conv_call())
    again = ops.explain("conv2d", CPU, plan=base.plan, **_conv_call())
    assert again.plan_source == "explicit"
    assert "explicit plan" in again.why()


def test_dispatch_executes_tuned_plan():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 8, 10, 10), generator=gen)
    w = torch.randn((16, 8, 3, 3), generator=gen)
    want = ops.conv2d(x, w, ctx=CPU)
    spec = ConvSpec(N=2, c_I=8, c_O=16, w_O=8, h_O=8, w_F=3, h_F=3,
                    prec=Precision(1.0, 1.0, 1.0))
    Planner(H100).autotune(spec, policy=ROOFLINE)
    tuning = dataclasses.replace(CPU, autotune=ROOFLINE)
    with ops.record_dispatch() as log:
        got = ops.conv2d(x, w, ctx=tuning)
    assert log[0].plan_source == "tuned"
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# persistence: the zero-re-search serving contract
# ---------------------------------------------------------------------------

def test_cache_roundtrip_serves_without_research(tmp_path):
    tuned = Planner(H100, autotune=ROOFLINE).plan(CONV)
    assert tuned.tuned is not None
    n0 = at.search_count()
    path = str(tmp_path / "cache.json")
    wrote = Planner.cache.save(path)
    assert wrote >= 2  # at least the tuned plan + its record
    Planner.cache.clear()
    assert Planner.cache.size() == 0 and not at.records()
    Planner.cache.load(path)
    served = Planner(H100).plan(CONV)  # no policy: the record serves
    assert served.tuned == tuned.tuned and served.tiles == tuned.tiles
    assert at.search_count() == n0  # zero re-searches
    dump = json.loads(open(path).read())
    assert dump["format"] == planner_mod.PLAN_FORMAT_VERSION
    assert len(dump["tuning"]) == 1


def test_clear_records_keeps_analytic_entries():
    analytic = Planner(H100).plan(MM)
    Planner(H100).autotune(CONV, policy=ROOFLINE)
    at.clear_records()
    assert not at.records() and at.search_report(CONV) is None
    # the matmul's analytic entry survived; the conv re-resolves analytic
    assert Planner(H100).plan(MM) is analytic
    assert Planner(H100).plan(CONV).tuned is None


# ---------------------------------------------------------------------------
# offline cost model + lint
# ---------------------------------------------------------------------------

def test_offline_model_prices_dma_setup():
    from repro_torch.analysis.roofline import (DMA_SETUP_SECONDS,
                                               alpha_beta_seconds,
                                               hbm_seconds)
    assert alpha_beta_seconds(1e6, 0) == hbm_seconds(1e6)
    assert alpha_beta_seconds(1e6, 10) == pytest.approx(
        hbm_seconds(1e6) + 10 * DMA_SETUP_SECONDS)
    ep = Planner(H100).plan(CONV)
    assert predicted_seconds(ep) > 0.0


def test_lint_clean_on_the_time_model_and_the_autotuner():
    # the port's lint has no VRF015 (verify/lint.py says why); its rules
    # hold over the new modules
    from repro_torch.verify.lint import lint_file

    for rel in ("analysis/roofline.py", "analysis/timing.py",
                "plan/autotune.py"):
        path = ROOT / "src" / "repro_torch" / rel
        assert lint_file(path, ROOT) == [], rel
