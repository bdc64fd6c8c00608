"""repro_torch.resilience against repro.resilience: the fault taxonomy,
deterministic seeded campaigns (the same draw streams as the reference's),
the dispatcher's runtime-failure fallback (quarantine, re-priced
degradation to Im2Col, the probe back to the primary, the card's rule that
a fault never demotes to aten), the port's counterpart of tracing
(``ops.traced()``), graceful degradation in the serving engine (retries,
per-row failure, backpressure, pool rebuild, deadlines) and the
``fault_swallowed`` mutant; the mirror of tests/test_resilience.py, without
its distributed case (the halo conv is not ported).

Parity runs: the engines serve the stablelm smoke config in f32 with the
reference's parameters carried over, ``batch_size=2`` and ``max_len=32``,
as the reference's tests do; greedy tokens, finish reasons and every
injection record (site, kind, op, resolution, detail) are then equal. The
reference's conv runs its Pallas kernels in interpret mode, the port's its
plain versions on the CPU; conv outputs agree within 1e-5 (both sum in
f32, in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro.plan as jp
import repro_torch.configs as tc
import repro_torch.plan as tp
from repro import ops as jops
from repro.models import transformer as JT
from repro.resilience import faults as jfj
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import ops
from repro_torch.convert import transformer_from_jax
from repro_torch.ops import registry
from repro_torch.resilience import errors as flt
from repro_torch.resilience import faults as fj
from repro_torch.serving import kv
from repro_torch.serving.engine import Engine, Request

CUDA = ops.ExecutionContext(target=tp.CPU_INTERPRET, backend="cuda",
                            device="cpu")
IM2COL = ops.ExecutionContext(target=tp.CPU_INTERPRET, backend="im2col",
                              device="cpu")
TORCH = ops.ExecutionContext(target=tp.CPU_INTERPRET, backend="torch",
                             device="cpu")
SERVE = ops.ExecutionContext(device="cpu")  # cuda backend: plain versions
P1 = np.array([3, 1, 4, 1, 5], np.int32)
CHAOS = ("launch", "dma", "numeric", "oom", "pool")


@pytest.fixture(autouse=True)
def _clean_slate():
    """Quarantine and campaign state are process-global; isolate tests."""
    for clear, install in ((ops.clear_quarantine, fj.install),
                           (jops.clear_quarantine, jfj.install)):
        clear()
        install(None)
    yield
    for clear, install in ((ops.clear_quarantine, fj.install),
                           (jops.clear_quarantine, jfj.install)):
        clear()
        install(None)


@pytest.fixture(scope="module")
def engine_setup():
    jcfg = dataclasses.replace(jc.get_smoke("stablelm_1_6b"),
                               compute_dtype="float32")
    tcfg = dataclasses.replace(tc.get_smoke("stablelm_1_6b"),
                               compute_dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, transformer_from_jax(jparams, tcfg, "cpu")


def _reqs(n=4, max_new=6, ref=False, **kw):
    cls = JRequest if ref else Request
    return [cls(prompt=P1.copy(), max_new_tokens=max_new, rng_seed=i, **kw)
            for i in range(n)]


def _engine(setup, **kw):
    _, _, tcfg, model = setup
    return Engine(tcfg, model, max_len=32, batch_size=2, ctx=SERVE, **kw)


def _ref_engine(setup, **kw):
    jcfg, jparams, _, _ = setup
    return JEngine(jcfg, jparams, max_len=32, batch_size=2, **kw)


def _conv_np():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, 8, 12, 12)).astype(np.float32),
            rng.standard_normal((8, 8, 3, 3)).astype(np.float32))


def _conv_args():
    return tuple(torch.from_numpy(a) for a in _conv_np())


def _conv_spec(x, w):
    return {"spec_args": tuple(torch.empty(a.shape, dtype=a.dtype,
                                           device="meta") for a in (x, w)),
            "spec_kw": {"stride": (1, 1), "out_dtype": torch.float32}}


def _launch_once(op="conv2d", kinds=("launch",)):
    return fj.FaultCampaign(seed=0, rate=1.0, kinds=kinds, ops=(op,),
                            max_faults=1)


def _records(camp):
    return [(i.seq, i.site, i.kind, i.op, i.resolution, i.detail)
            for i in camp.injections]


# ---------------------------------------------------------------------------
# Taxonomy
# ---------------------------------------------------------------------------

def test_taxonomy_transient_vs_fatal():
    assert issubclass(flt.Fault, RuntimeError)  # legacy except-clauses work
    for cls in (flt.KernelLaunchError, flt.NumericFault, flt.DmaTimeout,
                flt.PoolIntegrityFault):
        assert issubclass(cls, flt.TransientFault) and cls("x").transient
    for cls in (flt.DeviceLost, flt.AdmissionImpossible, flt.SchedulerStall,
                flt.FaultAccountingError):
        assert issubclass(cls, flt.FatalFault) and not cls("x").transient


def test_fault_str_carries_diagnostics():
    e = flt.KernelLaunchError("boom", op="conv2d", backend="cuda",
                              grid=(4, 4))
    s = str(e)
    assert "boom" in s and "op=conv2d" in s and "backend=cuda" in s
    assert "grid=(4, 4)" in s
    assert e.diagnostics["grid"] == (4, 4)


def test_blockoom_reclassified_transient():
    assert issubclass(kv.BlockOOM, flt.TransientFault)
    assert issubclass(kv.BlockOOM, RuntimeError)


def test_allocator_check_raises_typed_fault_with_occupancy():
    alloc = kv.BlockAllocator(8)
    alloc.alloc()
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=("pool",))
    inj = camp.draw("decode/pool")
    camp.corrupt_allocator(alloc, inj)
    with pytest.raises(flt.PoolIntegrityFault) as ei:
        alloc.check()
    assert ei.value.transient
    assert ei.value.diagnostics["num_blocks"] == 8
    assert "corruption" in inj.detail


# ---------------------------------------------------------------------------
# Campaign determinism, spec parsing, and the reference's draw streams
# ---------------------------------------------------------------------------

def test_campaign_is_deterministic_per_seed():
    def run(seed):
        c = fj.FaultCampaign(seed=seed, rate=0.3)
        return [(c.draw(f"site{i}") or None) and (c.injections[-1].site,
                                                  c.injections[-1].kind)
                for i in range(40)]
    assert run(7) == run(7)
    assert run(7) != run(8)


def test_campaign_max_faults_caps_injections():
    c = fj.FaultCampaign(seed=0, rate=1.0, max_faults=3)
    for i in range(10):
        c.draw(f"s{i}")
    assert len(c.injections) == 3 and c.draws == 10


def test_campaign_rejects_bad_config():
    with pytest.raises(ValueError, match="unknown fault kinds"):
        fj.FaultCampaign(kinds=("warp_drive",))
    with pytest.raises(ValueError, match="rate"):
        fj.FaultCampaign(rate=1.5)


def test_campaign_from_spec_round_trip():
    c = fj.campaign_from_spec(
        "rate=0.25,seed=9,kinds=launch+pool,ops=conv2d,max=5")
    assert (c.rate, c.seed, c.kinds, c.ops, c.max_faults) == \
        (0.25, 9, ("launch", "pool"), ("conv2d",), 5)
    with pytest.raises(ValueError, match="unknown REPRO_FAULTS field"):
        fj.campaign_from_spec("rate=0.1,typo=1")
    with pytest.raises(ValueError, match="expected key=value"):
        fj.campaign_from_spec("justarate")


def test_verify_accounted_flags_swallowed_fault():
    c = fj.FaultCampaign(seed=0, rate=1.0, max_faults=1)
    inj = c.draw("dispatch/conv2d")
    assert inj is not None
    with pytest.raises(flt.FaultAccountingError, match="swallowed"):
        c.verify_accounted()
    c.resolve(inj, "retried")
    c.verify_accounted()  # now clean


def test_fault_swallowed_mutant_is_caught():
    from repro_torch.verify.mutants import run_seeded_mutants
    results = {name: caught for name, caught, _ in run_seeded_mutants()}
    assert results["fault_swallowed"]


_SITES = (("dispatch/conv2d", fj.DISPATCH_KINDS, "conv2d"),
          ("dispatch/matmul", fj.DISPATCH_KINDS, "matmul"),
          ("admit/launch", ("launch", "dma"), "prefill"),
          ("admit/numeric", ("numeric",), "prefill"),
          ("admit/oom", ("oom",), None),
          ("decode/numeric", ("numeric",), "decode"),
          ("decode/pool", ("pool",), None),
          ("finish/pool", ("pool",), None),
          ("anywhere", None, None))


@pytest.mark.parametrize("seed,rate,kinds,only,cap", [
    (0, 0.2, CHAOS, None, None),
    (1, 0.5, fj.FAULT_KINDS, ("conv2d", "decode"), None),
    (7, 1.0, ("launch", "numeric"), None, 9),
    (123, 0.05, ("pool", "oom", "device"), ("matmul",), 4),
])
def test_draw_streams_equal_the_reference(seed, rate, kinds, only, cap):
    """Scripted site visits through both packages' campaigns give equal
    injections (seq, site, kind, op) and draw counts; the victims of
    ``corrupt_rows`` and the allocator corruptions, which also consume or
    read the stream's state, are equal too."""
    from repro.serving import kv as jkv

    kw = dict(seed=seed, rate=rate, kinds=kinds, ops=only, max_faults=cap)
    jcamp, tcamp = jfj.FaultCampaign(**kw), fj.FaultCampaign(**kw)
    jalloc, talloc = jkv.BlockAllocator(6), kv.BlockAllocator(6)
    visits = np.random.default_rng(seed + 1).integers(len(_SITES), size=300)
    for v in visits:
        site, site_kinds, op = _SITES[v]
        ji = jcamp.draw(site, kinds=site_kinds, op=op)
        ti = tcamp.draw(site, kinds=site_kinds, op=op)
        assert (ji is None) == (ti is None)
        if ti is None:
            continue
        if ti.kind == "numeric" and site.startswith("decode"):
            logits = np.zeros((4, 3), np.float32)
            jbad = np.asarray(jcamp.corrupt_rows(jnp.asarray(logits),
                                                 [0, 2, 3], ji))
            tbad = tcamp.corrupt_rows(torch.from_numpy(logits), [0, 2, 3],
                                      ti).numpy()
            np.testing.assert_array_equal(np.isnan(jbad), np.isnan(tbad))
        elif ti.kind == "pool":
            jcamp.corrupt_allocator(jalloc, ji)
            tcamp.corrupt_allocator(talloc, ti)
        assert ti.detail == ji.detail
    assert [(i.seq, i.site, i.kind, i.op) for i in tcamp.injections] == \
        [(i.seq, i.site, i.kind, i.op) for i in jcamp.injections]
    assert tcamp.draws == jcamp.draws
    assert tcamp.injections  # the scripts plant something


def test_corrupt_output_copies_the_first_float_leaf():
    """NaN into element 0 of the first floating leaf (the reference's leaf
    order: tuples in order, dicts by key), on a copy: the op's own output
    (a CUDA graph's static buffer on the card) is never written."""
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=("numeric",))
    ints = torch.arange(3)
    a, b = torch.ones(2, 3), torch.ones(4)
    out = {"z": b, "a": (ints, a)}
    inj = camp.draw("dispatch/x")
    bad = camp.corrupt_output(out, inj)
    assert inj.detail == {"leaf": 1}
    assert torch.isnan(bad["a"][1][0, 0]) and not torch.isnan(a).any()
    assert bad["z"] is b and bad["a"][0] is ints
    assert torch.isfinite(bad["a"][1].view(-1)[1:]).all()
    assert not fj._all_finite(bad) and fj._all_finite(out)


# ---------------------------------------------------------------------------
# Dispatch: runtime-failure fallback
# ---------------------------------------------------------------------------

def test_launch_fault_degrades_conv2d_to_im2col_and_reprices():
    x, w = _conv_args()
    want = ops.conv2d(x, w, ctx=IM2COL)
    camp = _launch_once()
    clean = ops.explain("conv2d", CUDA, **_conv_spec(x, w))
    with fj.activate(camp), ops.record_dispatch() as log:
        got = ops.conv2d(x, w, ctx=CUDA)
    camp.verify_accounted()
    assert camp.summary()["resolutions"] == {"degraded": 1}
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # one decision, for the execution that served the call
    assert [(d.chosen, d.degraded) for d in log] == [("im2col", True)]
    # the degradation is visible and re-priced in ops.explain
    dec = ops.explain("conv2d", CUDA, **_conv_spec(x, w))
    assert dec.degraded and dec.fault == "KernelLaunchError"
    assert dec.chosen == "im2col" and dec.requested == "cuda"
    assert dec.missing == ("fault:KernelLaunchError",)
    assert dec.measured_words == ops.explain(
        "conv2d", IM2COL, **_conv_spec(x, w)).measured_words
    assert dec.measured_words > clean.measured_words
    assert dec.bound_ratio > clean.bound_ratio
    assert "degraded" in dec.why() and "re-priced" in dec.why()
    (key,) = ops.quarantined()
    assert key[0] == "conv2d" and key[1] == "cuda"


@pytest.mark.parametrize("target", ["CPU_INTERPRET", "H100"])
def test_conv_degradation_equals_the_reference(target):
    """The degraded decision's fields and measured words, and the quarantine
    key, equal the reference's under the same target; the outputs agree."""
    xn, wn = _conv_np()
    jt = jp.HardwareTarget.from_dict(getattr(tp, target).to_dict())
    jctx = jops.ExecutionContext(target=jt, backend="pallas", interpret=True)
    tctx = ops.ExecutionContext(target=getattr(tp, target), backend="cuda",
                                device="cpu")
    kw = dict(seed=0, rate=1.0, kinds=("launch",), ops=("conv2d",),
              max_faults=1)
    with jfj.activate(jfj.FaultCampaign(**kw)):
        want = np.asarray(jops.conv2d(jnp.asarray(xn), jnp.asarray(wn),
                                      ctx=jctx))
    with fj.activate(fj.FaultCampaign(**kw)):
        got = ops.conv2d(torch.from_numpy(xn), torch.from_numpy(wn),
                         ctx=tctx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jd = jops.explain("conv2d", jctx, spec_args=(
        jax.ShapeDtypeStruct(xn.shape, jnp.float32),
        jax.ShapeDtypeStruct(wn.shape, jnp.float32)),
        spec_kw={"stride": (1, 1), "out_dtype": jnp.float32})
    td = ops.explain("conv2d", tctx, **_conv_spec(*_conv_args()))
    assert (td.degraded, td.fault, td.chosen, td.missing) == \
        (jd.degraded, jd.fault, "im2col", jd.missing)
    assert td.requested == "cuda" and jd.requested == "pallas"
    assert td.plan.tiles == jd.plan.tiles
    assert td.measured_words == jd.measured_words
    assert td.bound_ratio == jd.bound_ratio
    ((tkey, tq),) = ops.quarantined().items()
    ((jkey, jq),) = jops.quarantined().items()
    assert tkey[2][:2] == jkey[2][:2] and tq == jq


def test_quarantine_probes_primary_after_n_dispatches():
    x, w = _conv_args()
    want = ops.conv2d(x, w, ctx=CUDA)
    with fj.activate(_launch_once()):
        ops.conv2d(x, w, ctx=CUDA)
    assert ops.quarantined()
    # the demoting dispatch consumed one probe on its own re-resolve; the
    # quarantine holds (serving im2col) for PROBE_AFTER-2 more dispatches...
    for _ in range(ops.QUARANTINE_PROBE_AFTER - 2):
        with ops.record_dispatch() as log:
            ops.conv2d(x, w, ctx=CUDA)
        assert log[0].chosen == "im2col" and log[0].degraded
        assert ops.quarantined()
    # ...then the next one, the 8th resolution since the fault, probes the
    # primary again and, healthy, restores it
    with ops.record_dispatch() as log:
        got = ops.conv2d(x, w, ctx=CUDA)
    assert not ops.quarantined()
    assert log[0].chosen == "cuda" and not log[0].degraded
    assert torch.equal(got, want)
    dec = ops.explain("conv2d", CUDA, **_conv_spec(x, w))
    assert not dec.degraded and dec.chosen == "cuda"


def test_quarantine_is_shape_keyed():
    x, w = _conv_args()
    with fj.activate(_launch_once()):
        ops.conv2d(x, w, ctx=CUDA)
    # a different launch geometry is untouched by the quarantine
    x2 = torch.cat([x, x])
    dec = ops.explain("conv2d", CUDA, **_conv_spec(x2, w))
    assert not dec.degraded and dec.chosen == "cuda"


def test_terminal_backend_retries_in_place():
    x, w = _conv_args()
    want = ops.conv2d(x, w, ctx=TORCH)
    camp = _launch_once()
    with fj.activate(camp):
        got = ops.conv2d(x, w, ctx=TORCH)
    camp.verify_accounted()
    assert camp.summary()["resolutions"] == {"retried": 1}
    assert not ops.quarantined()  # nothing to demote to: no quarantine
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_persistent_transient_fault_exhausts_attempts():
    x, w = _conv_args()
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=("launch",),
                            ops=("conv2d",))  # unbounded: every attempt fails
    with fj.activate(camp), pytest.raises(flt.KernelLaunchError):
        ops.conv2d(x, w, ctx=TORCH)
    assert camp.draws == ops.MAX_RUNTIME_ATTEMPTS


def test_device_lost_is_fatal_and_propagates():
    x, w = _conv_args()
    camp = _launch_once(kinds=("device",))
    with fj.activate(camp), pytest.raises(flt.DeviceLost):
        ops.conv2d(x, w, ctx=CUDA)
    camp.verify_accounted()  # stamped "fatal" at the raise site
    assert camp.injections[0].resolution == "fatal"
    assert not ops.quarantined()  # fatal faults never demote


def test_numeric_fault_corrupts_then_degrades():
    x, w = _conv_args()
    want = ops.conv2d(x, w, ctx=IM2COL)
    camp = _launch_once(kinds=("numeric",))
    with fj.activate(camp):
        got = ops.conv2d(x, w, ctx=CUDA)
    camp.verify_accounted()
    assert camp.injections[0].resolution == "degraded"
    assert camp.injections[0].detail == {"leaf": 0}
    assert torch.isfinite(got).all()  # the NaN output never escaped
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_faults_never_fire_inside_traced():
    """``ops.traced()``, the port's counterpart of jit tracing: the hook
    makes no draw there (the stream is the reference's, whose jitted calls
    never draw); the same call outside it draws."""
    a = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (8, 8)).astype(np.float32))
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=("launch", "numeric"))
    with fj.activate(camp):
        with ops.traced():
            out = ops.matmul(a, a, ctx=TORCH)
        assert camp.draws == 0 and camp.injections == []
        with pytest.raises(flt.TransientFault):
            ops.matmul(a, a, ctx=TORCH)  # every attempt faulted
    assert camp.draws == ops.MAX_RUNTIME_ATTEMPTS
    torch.testing.assert_close(out, a @ a, rtol=1e-5, atol=1e-5)


def test_quarantine_applies_inside_traced():
    x, w = _conv_args()
    with fj.activate(_launch_once()):
        ops.conv2d(x, w, ctx=CUDA)
    with ops.traced(), ops.record_dispatch() as log:
        ops.conv2d(x, w, ctx=CUDA)
    assert log[0].chosen == "im2col" and log[0].degraded


def test_env_knob_installs_at_the_first_dispatch(monkeypatch):
    from repro_torch.ops import dispatch
    monkeypatch.setattr(dispatch, "_ENV_FAULTS_CHECKED", False)
    monkeypatch.setenv(fj.FAULTS_ENV, "rate=1.0,seed=3,kinds=launch,max=1")
    assert fj.active_campaign() is None
    x, w = _conv_args()
    ops.conv2d(x, w, ctx=CUDA)
    camp = fj.active_campaign()
    assert camp is not None and camp.seed == 3
    assert camp.summary()["resolutions"] == {"degraded": 1}


# -- the card's rule: a fault never demotes to aten ---------------------------

@pytest.fixture
def stub_backends():
    """Two stub backends of ``matmul`` whose fallback is ``torch``:
    ``stub_card`` (no ``degrade_to``) and ``stub_degrading``, which names
    ``stub_card``. Each call is logged by name."""
    calls = []

    def entry(name):
        def fn(ctx, plan, a, b, out_dtype=torch.float32):
            calls.append(name)
            return (a @ b).to(out_dtype)
        return fn

    registry.register_backend(registry.Backend(
        name="stub_card", ops={"matmul": registry.OpEntry(entry(
            "stub_card"))}, fallback="torch"))
    registry.register_backend(registry.Backend(
        name="stub_degrading", ops={"matmul": registry.OpEntry(
            entry("stub_degrading"), degrade_to="stub_card")},
        fallback="torch"))
    yield calls
    for name in ("stub_card", "stub_degrading"):
        registry._BACKENDS.pop(name)


def _matmul_on(ctx):
    a = torch.ones(4, 5)
    return ops.dispatch_call("matmul", ctx, torch.float32, (), (a, a.t()),
                             spec_kw={"out_dtype": torch.float32})


def test_organic_errors_are_not_demoted(stub_backends, monkeypatch):
    """Only the taxonomy's transients degrade a call: any other error from
    an entry (a CUDA wrapper's failed launch raises RuntimeError with its
    cudaError_t) propagates, though the entry has a ``degrade_to``, and
    nothing is quarantined; a real kernel fault never passes as a
    demotion."""
    def fail(ctx, plan, a, b, out_dtype=torch.float32):
        raise RuntimeError("repro_matmul failed with cudaError_t 700")

    monkeypatch.setitem(registry._BACKENDS, "stub_degrading",
                        registry.Backend(name="stub_degrading", ops={
                            "matmul": registry.OpEntry(
                                fail, degrade_to="stub_card")}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for device in ("cuda", "cpu"):
        ctx = ops.ExecutionContext(backend="stub_degrading", device=device)
        with fj.activate(fj.FaultCampaign(rate=0.0)):
            with pytest.raises(RuntimeError, match="cudaError_t 700"):
                _matmul_on(ctx)
        assert not ops.quarantined() and stub_backends == []


def test_card_never_demotes_to_torch(monkeypatch, stub_backends):
    """On a device="cuda" context a transient fault on an entry without
    ``degrade_to`` retries in place (resolved "retried", no quarantine),
    one with it degrades there; a persistent one raises after
    MAX_RUNTIME_ATTEMPTS. The same fault on a device="cpu" context demotes
    to the backend's fallback, ``torch``, as the reference demotes to
    ``xla``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = ops.ExecutionContext(backend="stub_card", device="cuda")
    camp = _launch_once("matmul")
    with fj.activate(camp), ops.record_dispatch() as log:
        out = _matmul_on(card)
    assert [d.chosen for d in log] == ["stub_card"] and not log[0].degraded
    assert camp.summary()["resolutions"] == {"retried": 1}
    assert not ops.quarantined() and stub_backends == ["stub_card"]
    assert torch.equal(out, torch.full((4, 4), 5.0))

    stub_backends.clear()
    degrading = ops.ExecutionContext(backend="stub_degrading", device="cuda")
    camp = _launch_once("matmul")
    with fj.activate(camp), ops.record_dispatch() as log:
        _matmul_on(degrading)
    assert [(d.chosen, d.degraded) for d in log] == [("stub_card", True)]
    assert camp.summary()["resolutions"] == {"degraded": 1}
    assert stub_backends == ["stub_card"]
    ops.clear_quarantine()

    stub_backends.clear()
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=("launch",),
                            ops=("matmul",))
    with fj.activate(camp), pytest.raises(flt.KernelLaunchError):
        _matmul_on(card)
    assert camp.draws == ops.MAX_RUNTIME_ATTEMPTS and stub_backends == []
    assert {i.resolution for i in camp.injections} == {"retried"}

    cpu = ops.ExecutionContext(backend="stub_card", device="cpu")
    camp = _launch_once("matmul")
    with fj.activate(camp), ops.record_dispatch() as log:
        _matmul_on(cpu)
    assert [(d.chosen, d.degraded) for d in log] == [("torch", True)]
    assert camp.summary()["resolutions"] == {"degraded": 1}


# ---------------------------------------------------------------------------
# Serving engine: graceful degradation
# ---------------------------------------------------------------------------

def test_deadline_expires_with_partial_output(engine_setup):
    eng = _engine(engine_setup)
    eng.batch_size = 1
    out = eng.serve([Request(prompt=P1.copy(), max_new_tokens=5000,
                             deadline_s=1e-9)])
    assert out[0].finish_reason == "timeout"
    assert 0 < len(out[0].out_tokens) < 5000


def test_deadline_must_be_positive(engine_setup):
    with pytest.raises(ValueError, match="deadline_s"):
        _engine(engine_setup).serve([Request(prompt=P1.copy(),
                                             deadline_s=0.0)])


def test_admission_retry_exhaustion_fails_one_request(engine_setup):
    # 4 launch faults = 1 admission (3 retries + terminal failure); the
    # remaining requests admit cleanly and complete
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=("launch",),
                            max_faults=4)
    with fj.activate(camp):
        out = _engine(engine_setup).serve(_reqs(3, max_new=4))
    camp.verify_accounted()
    assert [r.finish_reason for r in out] == ["error", "length", "length"]
    assert len(out[0].out_tokens) == 0
    assert camp.summary()["resolutions"] == {"retried": 3, "row_failed": 1}


def test_decode_nan_fails_only_bad_rows_with_clean_prefix(engine_setup):
    clean = _engine(engine_setup).serve(_reqs(2))
    camp = fj.FaultCampaign(seed=3, rate=1.0, kinds=("numeric",),
                            ops=("decode",), max_faults=2)
    with fj.activate(camp):
        out = _engine(engine_setup, numeric_retries=0).serve(_reqs(2))
    camp.verify_accounted()
    assert camp.summary()["resolutions"] == {"row_failed": 2}
    for c, f in zip(clean, out):
        assert f.finish_reason == "error"
        # no tokens recorded from the faulted step; the prefix is the
        # clean run's tokens bit for bit
        assert len(f.out_tokens) < len(c.out_tokens)
        assert np.array_equal(f.out_tokens, c.out_tokens[:len(f.out_tokens)])


def test_decode_nan_retry_recovers_idempotently(engine_setup):
    clean = _engine(engine_setup).serve(_reqs(2))
    camp = fj.FaultCampaign(seed=3, rate=1.0, kinds=("numeric",),
                            ops=("decode",), max_faults=1)
    eng = _engine(engine_setup)
    with fj.activate(camp):
        out = eng.serve(_reqs(2))
    camp.verify_accounted()
    assert camp.summary()["resolutions"] == {"retried": 1}
    for c, f in zip(clean, out):  # the retried step changed nothing
        assert f.finish_reason == c.finish_reason
        assert np.array_equal(f.out_tokens, c.out_tokens)
    assert eng.stats.eager_steps == len(eng.stats.decode_s) + 1  # the retry


def test_injected_oom_rides_backpressure_to_completion(engine_setup):
    clean = _engine(engine_setup).serve(_reqs(3))
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=("oom",), max_faults=3)
    with fj.activate(camp):
        out = _engine(engine_setup).serve(_reqs(3))
    camp.verify_accounted()
    assert camp.summary()["resolutions"] == {"backpressure": 3}
    for c, f in zip(clean, out):
        assert f.finish_reason == c.finish_reason
        assert np.array_equal(f.out_tokens, c.out_tokens)


def test_pool_corruption_triggers_exact_rebuild(engine_setup):
    eng = _engine(engine_setup)
    assert eng.paged  # the rebuild path is the paged engine's
    clean = eng.serve(_reqs(4))
    camp = fj.FaultCampaign(seed=2, rate=0.5, kinds=("pool",))
    eng = _engine(engine_setup)
    with fj.activate(camp):
        out = eng.serve(_reqs(4))
    camp.verify_accounted()
    assert camp.summary()["resolutions"].get("rebuilt", 0) >= 1
    assert eng.stats.rebuilds >= 1
    assert eng.stats.graph_resets == eng.stats.rebuilds
    for c, f in zip(clean, out):  # rebuilds reproduce the cache exactly
        assert f.finish_reason == c.finish_reason
        assert np.array_equal(f.out_tokens, c.out_tokens)


def test_pool_is_checked_every_round_under_a_campaign(engine_setup,
                                                      monkeypatch):
    """With a campaign active the pool is checked at every round, after
    its ``decode/pool`` draw, as in the reference (whose serve draws as
    many times); without one, every 256 rounds."""
    checks = []
    check = kv.BlockAllocator.check
    monkeypatch.setattr(kv.BlockAllocator, "check",
                        lambda self: checks.append(1) or check(self))
    _engine(engine_setup).serve(_reqs(2, max_new=5))
    assert checks == []
    kw = dict(seed=0, rate=0.0, kinds=("pool",))
    camp, jcamp = fj.FaultCampaign(**kw), jfj.FaultCampaign(**kw)
    with fj.activate(camp):
        _engine(engine_setup).serve(_reqs(2, max_new=5))
    with jfj.activate(jcamp):
        _ref_engine(engine_setup).serve(_reqs(2, max_new=5, ref=True))
    # 4 rounds (each admits or decodes); a round draws at decode/pool and
    # decode/numeric, an admission at admit/oom, admit/launch and
    # admit/numeric, a finish at finish/pool
    assert len(checks) == 4
    assert camp.draws == jcamp.draws == 4 * 2 + 2 * 3 + 2
    assert camp.injections == []


def test_admission_impossible_is_typed_with_diagnostics(engine_setup):
    eng = _engine(engine_setup, num_blocks=2)
    eng.batch_size = 1
    with pytest.raises(flt.AdmissionImpossible,
                       match="cannot ever admit") as ei:
        eng.serve([Request(prompt=np.arange(1, 30, dtype=np.int32),
                           max_new_tokens=4)])
    d = ei.value.diagnostics  # block 0 is the reserved garbage block
    assert d["num_blocks"] == 2 and d["blocks_needed"] > d["available_blocks"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_schedule_equals_the_reference(engine_setup, seed):
    """Seeded chaos over every engine site, in both packages: the loops
    terminate, every injection is accounted, the injection records (site,
    kind, op, resolution, detail), draws, finish reasons and tokens are
    equal; completed requests are bit-identical to the fault-free run and
    failed ones a clean prefix of it."""
    clean = _engine(engine_setup).serve(_reqs(5))
    kw = dict(seed=seed, rate=0.2, kinds=CHAOS)
    camp, jcamp = fj.FaultCampaign(**kw), jfj.FaultCampaign(**kw)
    with fj.activate(camp):
        out = _engine(engine_setup).serve(_reqs(5))
    with jfj.activate(jcamp):
        jout = _ref_engine(engine_setup).serve(_reqs(5, ref=True))
    camp.verify_accounted()
    assert _records(camp) == _records(jcamp) and camp.draws == jcamp.draws
    assert camp.injections  # the schedule planted something
    for c, f, j in zip(clean, out, jout):
        assert f.finish_reason == j.finish_reason is not None
        assert np.array_equal(f.out_tokens, np.asarray(j.out_tokens))
        if f.finish_reason == "error":
            assert np.array_equal(f.out_tokens,
                                  c.out_tokens[:len(f.out_tokens)])
        else:
            assert f.finish_reason == c.finish_reason
            assert np.array_equal(f.out_tokens, c.out_tokens)


def test_dispatch_sites_never_draw_while_serving(engine_setup):
    """A campaign on the ops a serve dispatches (rate 1.0) plants nothing:
    the engine's steps run inside ``ops.traced()``, as the reference's are
    jitted; only the engine's pool sites draw, as many times as in the
    reference's serve, and the tokens are the clean ones."""
    clean = _engine(engine_setup).serve(_reqs(3))
    kw = dict(seed=0, rate=1.0, kinds=fj.DISPATCH_KINDS,
              ops=("attention", "attention_decode", "matmul", "conv2d"))
    camp, jcamp = fj.FaultCampaign(**kw), jfj.FaultCampaign(**kw)
    with fj.activate(camp):
        out = _engine(engine_setup).serve(_reqs(3))
    with jfj.activate(jcamp):
        _ref_engine(engine_setup).serve(_reqs(3, ref=True))
    assert camp.injections == [] and camp.draws == jcamp.draws > 0
    for c, f in zip(clean, out):
        assert np.array_equal(f.out_tokens, c.out_tokens)


def test_trainer_step_draws_nothing(engine_setup):
    """The trainer's step runs inside ``ops.traced()`` (the reference jits
    it): a rate-1.0 dispatch campaign plants nothing in it."""
    from repro_torch.train import optimizer as TO
    from repro_torch.train import trainer as TTR

    _, _, tcfg, model = engine_setup
    step = TTR.make_train_step(tcfg, TO.AdamWConfig(),
                               TTR.TrainConfig(ctx=SERVE))
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 8))
    params = transformer_from_jax(
        JT.init_params(jax.random.PRNGKey(0), engine_setup[0]), tcfg, "cpu")
    camp = fj.FaultCampaign(seed=0, rate=1.0, kinds=fj.DISPATCH_KINDS)
    with fj.activate(camp):
        _, _, metrics = step(params, TO.init_state(params),
                             {"tokens": torch.from_numpy(toks)})
    assert camp.draws == 0 and np.isfinite(float(metrics["loss"]))


def test_chaos_schedules_hypothesis(engine_setup):
    """Property-based chaos: any (seed, rate, kinds) campaign terminates
    with full fault accounting and clean-prefix outputs."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    clean = _engine(engine_setup).serve(_reqs(3, max_new=4))

    @hyp.settings(max_examples=10, deadline=None)
    @hyp.given(seed=st.integers(0, 2**31 - 1),
               rate=st.floats(0.0, 0.5),
               kinds=st.sets(st.sampled_from(CHAOS), min_size=1))
    def run(seed, rate, kinds):
        camp = fj.FaultCampaign(seed=seed, rate=rate, kinds=tuple(kinds))
        with fj.activate(camp):
            out = _engine(engine_setup).serve(_reqs(3, max_new=4))
        camp.verify_accounted()
        for c, f in zip(clean, out):
            assert f.finish_reason is not None
            if f.finish_reason == "error":
                assert np.array_equal(f.out_tokens,
                                      c.out_tokens[:len(f.out_tokens)])
            else:
                assert np.array_equal(f.out_tokens, c.out_tokens)

    run()
