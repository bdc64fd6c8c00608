"""repro_torch.serving.graphs: the engine's decode steps through static
buffers (CUDA graphs on the card, the same buffers eagerly on the CPU).

(a) Greedy tokens equal the reference engine's (repro.serving.engine, its
jitted steps) on the smoke configs for the paged bf16 pool, the paged int8
pool, the contiguous cache (split and fused K/V), the hybrid (jamba cut to
one pattern unit), xLSTM's smoke model and OLMoE's MoE model on the paged
pool,
on schedules that cross table widths, admit into used slots and, for the
pools, rebuild the pool once through ``kv.check`` (the reference never
rebuilds: its tokens are the same). (b) The crediting arithmetic: a
capture counts nothing, and replays x its recorded launches and decisions
equal the eager counts; the runner's policy (warm-up, one graph a width,
replays, a rebuild dropping the graphs) under a stand-in for CUDA graphs
that, like one, runs a step's device work only at replay. (c) On the card
(marked ``cuda``): a replayed step equals an eager step bit for bit (OLMoE's
routed FFN included), and a step that reads the device inside a capture
raises.

The parity runs use compute_dtype float32, as tests/test_serving.py runs
the reference.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro.models.config as jconfig
import repro_torch.configs as tc
import repro_torch.models.config as tconfig
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import ops as tops
from repro_torch.convert import transformer_from_jax
from repro_torch.kernels import _build
from repro_torch.ops import dispatch
from repro_torch.resilience import errors as flt
from repro_torch.serving import graphs, kv
from repro_torch.serving.engine import Engine, Request, WaveEngine

CPU = tops.ExecutionContext(device="cpu")  # cuda backend: plain versions


def _smoke(arch, **kw):
    jcfg = dataclasses.replace(jc.get_smoke(arch), compute_dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(tc.get_smoke(arch), compute_dtype="float32",
                               **kw)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, transformer_from_jax(jparams, tcfg, "cpu")


def _qwen():
    return _smoke("qwen2_5_3b")


def _olmoe():
    return _smoke("olmoe_1b_7b")


def _jamba():
    kw = dict(n_experts=0, experts_per_token=0, compute_dtype="float32")
    jcfg = dataclasses.replace(jconfig.reduced(
        jc.get_config("jamba_1_5_large"), layers=8), **kw)
    tcfg = dataclasses.replace(tconfig.reduced(
        tc.get_config("jamba_1_5_large"), layers=8), **kw)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, transformer_from_jax(jparams, tcfg, "cpu")


# engine kwargs and schedule (prompt lengths, max_new_tokens, batch size,
# max_len) of each parity run: the pools' 9 requests of 64 tokens over 2
# slots take about 290 rounds (the engine checks its pool at round 256)
# and widths 1-6 of 16-token blocks
ENGINES = {
    "paged_bf16": (dict(paged=True), "qwen"),
    "paged_int8": (dict(paged=True, kv_dtype="int8"), "qwen"),
    "contiguous": (dict(paged=False), "qwen"),
    "contiguous_fused": ({}, "qwen_fused"),
    "hybrid": ({}, "jamba"),
    "xlstm": ({}, "xlstm"),
    "paged_moe": (dict(paged=True), "olmoe"),
}
MODELS = {"qwen": _qwen, "jamba": _jamba, "olmoe": _olmoe,
          "qwen_fused": lambda: _smoke("qwen2_5_3b", fused_kv_cache=True),
          "xlstm": lambda: _smoke("xlstm_1_3b")}
SCHEDULES = {"qwen": ((5, 29, 3, 17, 30, 8, 21, 12, 26), 64, 2, 96),
             "qwen_fused": ((5, 29, 3, 17, 30), 16, 2, 64),
             "jamba": ((3, 9, 4, 14, 6), 8, 2, 32),
             "xlstm": ((3, 9, 4, 21, 6), 8, 2, 32),
             "olmoe": ((5, 29, 3, 17, 30, 8, 21, 12, 26), 64, 2, 96)}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_greedy_tokens_equal_reference_through_static_buffers(name,
                                                              monkeypatch):
    kw, model_name = ENGINES[name]
    jcfg, jparams, tcfg, model = MODELS[model_name]()
    lens, max_new, batch, max_len = SCHEDULES[model_name]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in lens]
    want = [JRequest(prompt=p, max_new_tokens=max_new) for p in prompts]
    JEngine(jcfg, jparams, max_len=max_len, batch_size=batch,
            **kw).serve(want)

    eng = Engine(tcfg, model, max_len=max_len, batch_size=batch, ctx=CPU,
                 **kw)
    seen = {"buffers": set(), "widths": set(), "prefills": 0, "resets": 0,
            "checks": 0}
    forward, prefill = eng._decode_forward, eng._prefill

    def spy_forward(tok, idx, tables, cache):
        seen["buffers"].add((id(tok), id(idx)))
        if tables is not None:
            seen["widths"].add(tables.shape[1])
        return forward(tok, idx, tables, cache)

    def spy_prefill(*a):
        seen["prefills"] += 1
        return prefill(*a)

    monkeypatch.setattr(eng, "_decode_forward", spy_forward)
    monkeypatch.setattr(eng, "_prefill", spy_prefill)
    reset = graphs.DecodeGraphs.reset

    def spy_reset(self, cache):
        seen["resets"] += 1
        return reset(self, cache)

    def faulty_check(self):  # the first check finds the pool corrupted
        seen["checks"] += 1
        if seen["checks"] == 1:
            raise flt.PoolIntegrityFault("injected by the test")

    monkeypatch.setattr(graphs.DecodeGraphs, "reset", spy_reset)
    monkeypatch.setattr(kv.BlockAllocator, "check", faulty_check)
    got = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    eng.serve(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.out_tokens, a.out_tokens)
        assert b.finish_reason == a.finish_reason == "length"
    st = eng.stats
    # every step ran eagerly on the runner's own buffers
    assert len(seen["buffers"]) == 1
    assert st.eager_steps == len(st.decode_s) > 0
    assert st.warmup_steps == st.replayed_steps == 0 and not st.graphs
    if eng.paged:
        assert len(seen["widths"]) >= 4  # the retrace ladder's widths
        assert seen["resets"] == 1  # the rebuild dropped the graphs
        # the rebuild re-prefilled the live slots' written tokens
        assert seen["prefills"] > len(prompts)
    else:
        assert seen["resets"] == 0 and seen["prefills"] == len(prompts)


def test_wave_engine_runs_the_same_buffers():
    _, _, tcfg, model = _qwen()
    prompts = [np.arange(1, n + 1, dtype=np.int32) for n in (4, 9, 2)]
    a = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    b = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    Engine(tcfg, model, max_len=32, batch_size=2, ctx=CPU).serve(a)
    eng = WaveEngine(tcfg, model, max_len=32, batch_size=2, ctx=CPU)
    eng.serve(b)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.out_tokens, rb.out_tokens)
    assert eng.stats.eager_steps == len(eng.stats.decode_s)


# -- (b) crediting ------------------------------------------------------------

def _stub_kernel(name="stub.cu"):
    k = _build.CudaKernel(name, "stub", [])
    k._fn = lambda *args: 0  # a built library whose launches succeed
    return k


def test_capture_counts_nothing_and_replays_credit_launches():
    k = _stub_kernel()
    with _build.record_launches() as rec:
        k.launch(tensor_core=True, grid=(3,))
        k.launch(tensor_core=True, grid=(5,))
        k.launch()
    assert (k.launches, k.tensor_core_launches) == (0, 0)
    for times in (1, 4):
        rec.credit(times)
    assert (k.launches, k.tensor_core_launches) == (15, 10)
    assert k.last_launch["grid"] == (1, 1, 1)
    k.launch()  # outside a capture a launch counts as ever
    assert (k.launches, k.tensor_core_launches) == (16, 10)


def test_no_build_inside_a_capture():
    k = _build.CudaKernel("stub.cu", "stub", [])  # not built
    with _build.record_launches():
        with pytest.raises(RuntimeError, match="warm-up"):
            k.launch()
    assert k.launches == 0


def test_capture_keeps_decisions_out_of_the_logs():
    a = torch.randn(8, 4)
    b = torch.randn(4, 8)
    with tops.record_dispatch() as log:
        with dispatch.capture_decisions() as cap:
            tops.matmul(a, b, ctx=CPU)
            tops.matmul(a, b, ctx=CPU)
        assert log == [] and len(cap) == 2
        for _ in range(3):
            dispatch.credit_decisions(cap)
        tops.matmul(a, b, ctx=CPU)
    assert len(log) == 7 and {d.op for d in log} == {"matmul"}


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: the step's device
    work is recorded at capture and runs at each replay, never at capture
    (the host code that counts runs at capture only, as on the card)."""

    current = None

    def __init__(self):
        self.work = []

    def capture_begin(self, pool=None):
        _FakeGraph.current = self

    def capture_end(self):
        _FakeGraph.current = None

    def replay(self):
        for fn in self.work:
            fn()


class _FakeStream:
    def wait_stream(self, other):
        pass


def _on_fake_card(monkeypatch, runner):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    runner.on_card, runner._stream = True, _FakeStream()


def test_replays_credit_what_eager_steps_count(monkeypatch):
    """A stub step launches a stub kernel twice (once on the tensor cores),
    makes one dispatch decision and advances a state by its token: over a
    schedule of widths with a rebuild, the counts and the state after the
    runner's steps equal those of the same steps run eagerly."""
    k = _stub_kernel()
    a, b = torch.randn(4, 3), torch.randn(3, 4)
    B = 3

    def step(tok, idx, tables, cache):
        k.launch(tensor_core=True)
        k.launch()
        tops.matmul(a, b, ctx=CPU)
        out = torch.empty(B)
        width = 0 if tables is None else tables.shape[1]

        def work():  # the device's part: read the buffers when it runs
            cache["state"] += tok[:, 0].double()
            out.copy_(cache["state"] + width + idx.double())

        if _FakeGraph.current is not None:
            _FakeGraph.current.work.append(work)
        else:
            work()
        return out

    tables = np.arange(1, 1 + B * 8, dtype=np.int32).reshape(B, 8)
    schedule = [(w, t) for t, w in enumerate((1, 1, 2, 2, 2, 3, 1, 3))]

    def drive(runner, rebuild_at=5):
        outs = []
        for i, (w, t) in enumerate(schedule):
            if i == rebuild_at:
                pool = runner._pool
                runner.reset({"state": runner.cache["state"].clone()})
                # the dropped graphs released their pool: a fresh one
                assert runner._pool is not pool or not runner.on_card
            key = runner.load(np.full(B, t + 1), np.arange(B), tables, w)
            outs.append(runner.run(key).clone())
        return outs, runner.cache["state"]

    with tops.record_dispatch() as eager_log:
        eager = graphs.DecodeGraphs(step, {"state": torch.zeros(
            B, dtype=torch.float64)}, B, "cpu")
        eager_outs, eager_state = drive(eager)
    eager_counts = (k.launches, k.tensor_core_launches)
    k.launches = k.tensor_core_launches = 0

    runner = graphs.DecodeGraphs(step, {"state": torch.zeros(
        B, dtype=torch.float64)}, B, "cpu")
    _on_fake_card(monkeypatch, runner)
    with tops.record_dispatch() as log:
        outs, state = drive(runner)
    assert (k.launches, k.tensor_core_launches) == eager_counts == (16, 8)
    assert len(log) == len(eager_log) == len(schedule)
    assert all(torch.equal(x, y) for x, y in zip(outs, eager_outs))
    assert torch.equal(state, eager_state)  # each step advanced it once
    assert runner.warmups == 1 and runner.replays == len(schedule) - 1
    # widths 1 and 2 before the rebuild; 3 and 1 after it (the rebuild
    # dropped the graphs); width 2 ran no step after it
    assert len(runner.capture_s) == 4 and sorted(runner.graphs) == [1, 3]


def test_capture_failure_raises_and_runs_nothing(monkeypatch):
    def step(tok, idx, tables, cache):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    runner = graphs.DecodeGraphs(step, {}, 2, "cpu")
    _on_fake_card(monkeypatch, runner)
    runner.warmups = 1  # the warm-up ran
    key = runner.load(np.zeros(2), np.zeros(2))
    with pytest.raises(RuntimeError, match="capturing"):
        runner.run(key)
    assert runner.replays == 0 and not runner.graphs


# -- (c) on the card ----------------------------------------------------------

def _card_engines():
    from repro_torch.models import transformer as T

    cfg = tc.get_smoke("qwen2_5_3b")
    model = T.init_params(cfg, seed=0, device="cuda")
    hyb = dataclasses.replace(tconfig.reduced(
        tc.get_config("jamba_1_5_large"), layers=8), n_experts=0,
        experts_per_token=0)
    hmodel = T.init_params(hyb, seed=0, device="cuda")
    return {"paged bf16": Engine(cfg, model, max_len=64, batch_size=3,
                                 paged=True),
            "paged int8": Engine(cfg, model, max_len=64, batch_size=3,
                                 paged=True, kv_dtype="int8"),
            "contiguous": Engine(cfg, model, max_len=64, batch_size=3,
                                 paged=False),
            "hybrid": Engine(hyb, hmodel, max_len=64, batch_size=3)}


@pytest.mark.cuda
def test_replayed_step_equals_eager_step_on_the_card():
    """Each engine: one decode step eagerly and replayed on equal state,
    logits and every written cache leaf equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    for name, eng in _card_engines().items():
        res = graphs.check_replay(eng, *graphs.probe_inputs(eng, seed=1))
        assert res["logits_equal"] and res["leaves_equal"], (name, res)
        assert res["finite"] and res["written_leaves"] > 0, (name, res)


@pytest.mark.cuda
def test_moe_replayed_step_equals_eager_step_on_the_card():
    """OLMoE's smoke config: the routed MoE FFN (sort, cumsum, one-hot
    compares, expert einsums) in a replayed decode step, bit for bit the
    eager step, for the paged pool and the contiguous cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from repro_torch.models import transformer as T

    cfg = tc.get_smoke("olmoe_1b_7b")
    model = T.init_params(cfg, seed=0, device="cuda")
    for paged in (True, False):
        eng = Engine(cfg, model, max_len=64, batch_size=3, paged=paged)
        res = graphs.check_replay(eng, *graphs.probe_inputs(eng, seed=2))
        assert res["logits_equal"] and res["leaves_equal"], (paged, res)
        assert res["finite"] and res["written_leaves"] > 0, (paged, res)


@pytest.mark.cuda
def test_capture_after_a_reset_on_the_card():
    """A pool rebuild drops the graphs (``reset``); the next step captures
    again, into a fresh memory pool (the dropped graphs released theirs),
    and equals an eager step bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    for name, eng in _card_engines().items():
        cache, tok, idx, tables, width = graphs.probe_inputs(eng, seed=3)
        run = eng.decode_graphs(graphs._clone(cache))
        key = run.load(tok, idx, tables, width)
        run.run(key)  # the warm-up
        run.run(key)  # a capture and its replay
        run.reset(graphs._clone(cache))
        key = run.load(tok, idx, tables, width)
        got = run.run(key).clone()  # captured again, then replayed
        assert run.resets == 1 and len(run.capture_s) == 2, name
        ref = eng.decode_graphs(graphs._clone(cache))
        want = ref.eager(ref.load(tok, idx, tables, width))
        assert torch.equal(got, want), name


_DEVICE_READ = """
import numpy as np, torch
from repro_torch.serving import graphs

def step(tok, idx, tables, cache):
    if int(tok.sum()) > 0:  # a host read of a device value
        return tok.float()
    return idx.float()

runner = graphs.DecodeGraphs(step, {}, 2, "cuda")
key = runner.load(np.ones(2), np.zeros(2))
runner.run(key)  # the warm-up runs eagerly: the read is legal there
try:
    runner.run(key)
except RuntimeError as exc:
    assert runner.replays == 0 and not runner.graphs
    print("raised:", exc)
"""


@pytest.mark.cuda
def test_device_read_inside_a_capture_raises():
    """In a process of its own: a failed capture leaves the CUDA
    generator's capture state behind for the rest of its process."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    r = subprocess.run([sys.executable, "-c", _DEVICE_READ], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "raised:" in r.stdout, r.stderr[-2000:]
