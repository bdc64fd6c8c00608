"""repro_torch.serving against repro.serving: the block allocator on the
schedules of tests/test_kv.py, pool and slot sizing equal to the reference,
greedy tokens equal to the reference's Engine (paged and contiguous, bf16
and int8 pools) with the reference's parameters carried over, and the port's
own engine rules:
paged output equal to contiguous output, backpressure, stop / length /
cache_limit accounting, and batch-invariant sampling.

The parity runs use compute_dtype float32, as tests/test_serving.py runs
the reference: greedy tokens are then equal token for token.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro.plan as jp
import repro_torch.configs as tc
import repro_torch.plan as tp
from repro.models import transformer as JT
from repro.serving import kv as jkv
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import plan_batch_size as jplan_batch_size
from repro_torch import ops as tops
from repro_torch.convert import transformer_from_jax
from repro_torch.models import moe
from repro_torch.serving import kv
from repro_torch.serving.engine import (Engine, Request, WaveEngine,
                                        plan_batch_size)

CPU = tops.ExecutionContext(device="cpu")  # cuda backend: plain versions
P1 = np.array([3, 1, 4, 1, 5], np.int32)
P2 = np.array([7], np.int32)
P3 = np.array([2, 7, 1], np.int32)


def _models(arch="stablelm_1_6b"):
    jcfg = dataclasses.replace(jc.get_smoke(arch), compute_dtype="float32")
    tcfg = dataclasses.replace(tc.get_smoke(arch), compute_dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, transformer_from_jax(jparams, tcfg, "cpu")


def _engine(tcfg, model, **kw):
    kw.setdefault("ctx", CPU)
    return Engine(tcfg, model, **kw)


# -- the block allocator (the schedules of tests/test_kv.py) --------------

def test_alloc_free_roundtrip():
    a = kv.BlockAllocator(8)
    got = [a.alloc() for _ in range(7)]
    assert sorted(got) == list(range(1, 8)) and kv.GARBAGE_BLOCK not in got
    with pytest.raises(kv.BlockOOM):
        a.alloc()
    for b in got:
        a.free(b)
    assert a.available() == 7 and a.live_blocks() == 0
    a.check()
    assert sorted(a.alloc() for _ in range(7)) == list(range(1, 8))


def test_double_free_bad_ref_and_reserved():
    a = kv.BlockAllocator(4)
    b = a.alloc()
    a.free(b)
    with pytest.raises(ValueError, match="double free"):
        a.free(b)
    with pytest.raises(ValueError, match="not live or evictable"):
        a.ref(b)
    with pytest.raises(ValueError):
        kv.BlockAllocator(1)
    assert issubclass(kv.BlockOOM, RuntimeError)


def test_prefix_chain_equal():
    for toks, bs in ((list(range(10)), 4), ([9, 9, 9, 9, 4, 5, 6, 7], 4),
                     ([1, 2], 4), (list(range(33)), 16)):
        assert kv.prefix_chain(toks, bs) == jkv.prefix_chain(toks, bs)


def test_sharing_retention_and_lru_eviction():
    a = kv.BlockAllocator(4)
    keys = [(None, (i,)) for i in range(3)]
    blocks = []
    for key in keys:
        b = a.alloc()
        a.register(b, key)
        blocks.append(b)
    assert a.ref(a.lookup(keys[0])) == blocks[0]
    assert a.refcount(blocks[0]) == 2 and a.used_words(10.0) == 30.0
    a.free(blocks[0])
    for b in blocks:
        a.free(b)  # all three evictable, oldest-freed first
    assert a.lookup(keys[1]) == blocks[1] and a.available() == 3
    assert [a.alloc() for _ in range(3)] == blocks  # LRU order
    assert all(a.lookup(k) is None for k in keys)
    a.check()


def test_randomized_schedules_match_reference():
    """The same random admit/finish schedule drives both allocators: every
    allocation, refcount and occupancy agrees, and no block leaks."""
    rng = np.random.default_rng(0)
    for trial in range(40):
        num_blocks = int(rng.integers(4, 25))
        pair = (kv.BlockAllocator(num_blocks), jkv.BlockAllocator(num_blocks))
        holdings = []
        for _ in range(int(rng.integers(1, 41))):
            for a in pair:
                a.check()
            if holdings and rng.random() < 0.5:
                blocks = holdings.pop(int(rng.integers(0, len(holdings))))
                for a in pair:
                    for b in blocks:
                        a.free(b)
                continue
            toks = rng.integers(0, 4, int(rng.integers(1, 13))).tolist()
            need = max(1, -(-len(toks) // 2))
            got = []
            for a, mod in zip(pair, (kv, jkv)):
                chain = mod.prefix_chain(toks, 2)
                hits = []
                for key in chain:
                    hit = a.lookup(key)
                    if hit is None:
                        break
                    hits.append(hit)
                evictable = sum(1 for b in hits if a.refcount(b) == 0)
                if a.available() - evictable < need - len(hits):
                    got.append(None)
                    continue
                blocks = [a.ref(b) for b in hits]
                for key in chain[len(blocks):]:
                    b = a.alloc()
                    a.register(b, key)
                    blocks.append(b)
                while len(blocks) < need:
                    blocks.append(a.alloc())
                got.append(blocks)
            assert got[0] == got[1]
            if got[0] is not None:
                holdings.append(got[0])
            assert pair[0].live_blocks() == pair[1].live_blocks()
            assert pair[0].available() == pair[1].available()
        for blocks in holdings:
            for a in pair:
                for b in blocks:
                    a.free(b)
        for a in pair:
            a.check()
            assert a.live_blocks() == 0 and a.available() == num_blocks - 1


def test_pool_and_batch_sizing_equal():
    for arch in ("stablelm_1_6b", "qwen2_5_3b"):
        tcfg, jcfg = tc.get_smoke(arch), jc.get_smoke(arch)
        assert kv.block_words(tcfg, 16) == jkv.block_words(jcfg, 16)
        for name in ("H100", "TPU_V5E", "CPU_INTERPRET"):
            tt = getattr(tp, name)
            jt = jp.HardwareTarget.from_dict(tt.to_dict())
            for max_len, bs in ((64, None), (24, 16), (512, 16)):
                assert plan_batch_size(tcfg, max_len, tt, block_size=bs) == \
                    jplan_batch_size(jcfg, max_len, jt, block_size=bs)
                assert kv.plan_pool_blocks(tcfg, max_len, 4, 16, target=tt) \
                    == jkv.plan_pool_blocks(jcfg, max_len, 4, 16, target=jt)
    full = tc.get_config("qwen2_5_3b")
    assert kv.block_words(full, 16) == jkv.block_words(
        jc.get_config("qwen2_5_3b"), 16)


# -- greedy parity with the reference engine --------------------------------

def _workload(seed=3):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 200, size=int(rng.integers(2, 30))).astype(
        np.int32) for _ in range(5)]
    shared = rng.integers(1, 200, size=16).astype(np.int32)
    for tail in ([5, 6, 7], [9]):
        prompts.append(np.concatenate([shared, tail]).astype(np.int32))
    return prompts


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "stablelm_1_6b",
                                  "olmoe_1b_7b"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_greedy_tokens_equal_reference_engine(arch, paged):
    """7 requests (two sharing a 16-token prefix) over 3 slots, so admission
    happens mid-flight: every token and finish reason equals the
    reference's."""
    jcfg, jparams, tcfg, model = _models(arch)
    prompts = _workload()
    want = [JRequest(prompt=p, max_new_tokens=7) for p in prompts]
    JEngine(jcfg, jparams, max_len=64, batch_size=3, paged=paged).serve(want)
    got = [Request(prompt=p, max_new_tokens=7) for p in prompts]
    eng = _engine(tcfg, model, max_len=64, batch_size=3, paged=paged)
    assert eng.paged == paged
    eng.serve(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.out_tokens, a.out_tokens)
        assert b.finish_reason == a.finish_reason == "length"
    assert len(eng.stats.prefill_s) == len(prompts)
    assert eng.stats.decode_s


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_moe_dead_rows_take_capacity_as_in_the_reference(paged,
                                                        monkeypatch):
    """OLMoE's smoke config (4 experts, top 2) on 12 slots: a decode step
    routes all 12 rows, dead ones included, into a capacity of 8 a expert,
    so choices are dropped at decode (asserted) — and the tokens are still
    the reference engine's, which routes its dead rows the same way."""
    jcfg, jparams, tcfg, model = _models("olmoe_1b_7b")
    prompts = _workload()
    want = [JRequest(prompt=p, max_new_tokens=7) for p in prompts]
    JEngine(jcfg, jparams, max_len=64, batch_size=12, paged=paged).serve(want)
    got = [Request(prompt=p, max_new_tokens=7) for p in prompts]
    eng = _engine(tcfg, model, max_len=64, batch_size=12, paged=paged)
    forward, drops = eng._decode_forward, []

    def counted(*args):
        with moe.count_drops("cpu") as counts:
            out = forward(*args)
        drops.append(counts.tolist())
        return out

    monkeypatch.setattr(eng, "_decode_forward", counted)
    eng.serve(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.out_tokens, a.out_tokens)
        assert b.finish_reason == a.finish_reason == "length"
    assert moe.capacity(tcfg, 12) == 8
    assert all(routed == 12 * 2 * tcfg.n_layers for _, routed in drops)
    assert max(dropped for dropped, _ in drops) > 0


def test_paged_matches_contiguous_and_dispatches_cuda():
    """Switching the KV layout changes no tokens, across shared prefixes
    and a sampled request; paged decode runs the cuda attention_decode
    entry with no fallback, padded prefill the cuda attention entry."""
    _, _, tcfg, model = _models()

    def reqs():
        out = [Request(prompt=p, max_new_tokens=6) for p in _workload(5)]
        out[-1].temperature, out[-1].rng_seed = 0.9, 11
        return out

    a, b = reqs(), reqs()
    _engine(tcfg, model, max_len=64, batch_size=3, paged=False).serve(a)
    with tops.record_dispatch() as log:
        _engine(tcfg, model, max_len=64, batch_size=3, paged=True).serve(b)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.out_tokens, rb.out_tokens)
        assert ra.finish_reason == rb.finish_reason
    ops_seen = {d.op for d in log}
    assert ops_seen == {"attention", "attention_decode"}
    assert all(d.chosen == "cuda" and not d.fell_back for d in log)


def test_paged_backpressure_completes_all_requests():
    _, _, tcfg, model = _models()
    mk = lambda: [Request(prompt=np.full(20, i + 1, np.int32),
                          max_new_tokens=25) for i in range(5)]
    ref = mk()
    _engine(tcfg, model, max_len=64, batch_size=4, paged=False).serve(ref)
    got = mk()  # 3 blocks each, 7 usable: two concurrent requests at most
    _engine(tcfg, model, max_len=64, batch_size=4, paged=True,
            num_blocks=1 + 7).serve(got)
    for ra, rb in zip(ref, got):
        np.testing.assert_array_equal(ra.out_tokens, rb.out_tokens)
        assert rb.finish_reason == "length"
    eng = _engine(tcfg, model, max_len=64, batch_size=2, paged=True,
                  num_blocks=1 + 2)
    with pytest.raises(RuntimeError, match="cannot ever admit"):
        eng.serve([Request(prompt=np.arange(1, 40, dtype=np.int32),
                           max_new_tokens=20)])


def test_stop_length_and_cache_limit_reasons():
    _, _, tcfg, model = _models()
    full = Request(prompt=P1, max_new_tokens=12)
    _engine(tcfg, model, max_len=32, batch_size=1).serve([full])
    assert full.finish_reason == "length" and len(full.out_tokens) == 12
    eos = int(full.out_tokens[2])
    if eos not in full.out_tokens[:2]:
        stop = Request(prompt=P1, max_new_tokens=12, stop_tokens=(eos,))
        _engine(tcfg, model, max_len=32, batch_size=1).serve([stop])
        assert stop.finish_reason == "stop"
        np.testing.assert_array_equal(stop.out_tokens, full.out_tokens[:3])
    for paged in (True, False):
        trunc = Request(prompt=P1, max_new_tokens=12)
        _engine(tcfg, model, max_len=8, batch_size=1,
                paged=paged).serve([trunc])
        cap = 8 - len(P1) + 1
        assert trunc.finish_reason == "cache_limit"
        np.testing.assert_array_equal(trunc.out_tokens, full.out_tokens[:cap])


def test_sampling_is_batch_invariant_and_seeded():
    _, _, tcfg, model = _models()
    mk = lambda: Request(prompt=P1, max_new_tokens=5, temperature=0.9,
                         rng_seed=42)
    solo = mk()
    _engine(tcfg, model, max_len=32, batch_size=1, seed=7).serve([solo])
    batched = [Request(prompt=P2, max_new_tokens=3), mk(),
               Request(prompt=P3, max_new_tokens=8, temperature=1.3)]
    _engine(tcfg, model, max_len=32, batch_size=3, seed=7).serve(batched)
    np.testing.assert_array_equal(solo.out_tokens, batched[1].out_tokens)
    greedy = Request(prompt=P1, max_new_tokens=5)
    _engine(tcfg, model, max_len=32, batch_size=1).serve([greedy])
    mixed = [Request(prompt=P1, max_new_tokens=5),
             Request(prompt=P3, max_new_tokens=5, temperature=1.0)]
    _engine(tcfg, model, max_len=32, batch_size=2).serve(mixed)
    np.testing.assert_array_equal(greedy.out_tokens, mixed[0].out_tokens)


def test_wave_baseline_and_bucketing_keep_tokens():
    _, _, tcfg, model = _models()
    specs = [(np.arange(1, n + 1, dtype=np.int32) * 3, m)
             for n, m in ((5, 6), (2, 2), (3, 4), (6, 3), (1, 5))]
    a = [Request(prompt=p, max_new_tokens=m) for p, m in specs]
    b = [Request(prompt=p, max_new_tokens=m) for p, m in specs]
    c = [Request(prompt=p, max_new_tokens=m) for p, m in specs]
    _engine(tcfg, model, max_len=32, batch_size=2).serve(a)
    WaveEngine(tcfg, model, max_len=32, batch_size=2, ctx=CPU).serve(b)
    _engine(tcfg, model, max_len=32, batch_size=2,
            prefill_bucket=1).serve(c)
    for ra, rb, rc in zip(a, b, c):
        np.testing.assert_array_equal(ra.out_tokens, rb.out_tokens)
        np.testing.assert_array_equal(ra.out_tokens, rc.out_tokens)


def test_engine_rules():
    _, _, tcfg, model = _models()
    eng = _engine(tcfg, model, max_len=8, batch_size=1)
    with pytest.raises(ValueError):
        eng.serve([Request(prompt=np.arange(9, dtype=np.int32))])
    with pytest.raises(ValueError):
        eng.serve([Request(prompt=P1, max_new_tokens=0)])
    with pytest.raises(ValueError):
        eng.serve([Request(prompt=P2, rng_seed=2**35)])
    with pytest.raises(ValueError, match="paged"):
        _engine(tcfg, model, paged=False, kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(tcfg, model, kv_dtype="fp4")
    with pytest.raises(ValueError, match="context runs on"):
        Engine(tcfg, model, ctx=_CudaCtx())


# -- the int8 KV pool ---------------------------------------------------------

def test_int8_pool_greedy_tokens_equal_reference_and_bf16():
    """The int8 pool's greedy tokens equal the reference's int8 engine on
    the workload with mid-flight admission and a shared prefix, and equal
    the port's own bf16 pool on the reference's quality-gate prompts
    (tests/test_quant.py)."""
    jcfg, jparams, tcfg, model = _models()
    prompts = _workload()
    want = [JRequest(prompt=p, max_new_tokens=7) for p in prompts]
    JEngine(jcfg, jparams, max_len=64, batch_size=3, paged=True,
            kv_dtype="int8").serve(want)
    got = [Request(prompt=p, max_new_tokens=7) for p in prompts]
    eng = _engine(tcfg, model, max_len=64, batch_size=3, kv_dtype="int8")
    assert eng.paged and eng.kv_quant
    eng.serve(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.out_tokens, a.out_tokens)
        assert b.finish_reason == a.finish_reason == "length"

    def run(kv_dtype):
        reqs = [Request(prompt=p, max_new_tokens=8) for p in (P1, P2, P3)]
        _engine(tcfg, model, max_len=64, batch_size=3, paged=True,
                kv_dtype=kv_dtype).serve(reqs)
        return [list(r.out_tokens) for r in reqs]

    assert run("int8") == run("bf16")


def test_int8_pool_sizing_equal_reference():
    for arch in ("stablelm_1_6b", "qwen2_5_3b"):
        tcfg, jcfg = tc.get_smoke(arch), jc.get_smoke(arch)
        assert kv.block_words(tcfg, 16, quantized=True) == \
            jkv.block_words(jcfg, 16, quantized=True)
        for name in ("H100", "TPU_V5E"):
            tt = getattr(tp, name)
            jt = jp.HardwareTarget.from_dict(tt.to_dict())
            assert kv.plan_pool_blocks(tcfg, 512, 4, 16, target=tt,
                                       quantized=True) == \
                jkv.plan_pool_blocks(jcfg, 512, 4, 16, target=jt,
                                     quantized=True)
    _, _, tcfg, model = _models()
    eng = _engine(tcfg, model, max_len=64, batch_size=3, kv_dtype="int8")
    assert eng.num_blocks == kv.plan_pool_blocks(
        tcfg, 64, 3, eng.block_size, target=eng.target, quantized=True)


def test_quantize_kv_row_and_insert_equal_reference():
    """One decode step's row quantizer and the admission's quantizing
    insert (the reference's scatter_q) give equal codes and scales."""
    from repro.models import layers as JL
    from repro.models import transformer as JT_
    from repro.serving.engine import _make_paged_steps
    from repro_torch.models import layers as TL
    from repro_torch.models import transformer as T

    rng = np.random.default_rng(2)
    r = (rng.standard_normal((3, 2, 16)) * 4).astype(np.float32)
    r[1, 0] = 0.0  # an all-zero row: scale 1.0
    jq_, js = JL._quantize_kv_row(jax.numpy.asarray(r))
    tq_, ts = TL._quantize_kv_row(torch.from_numpy(r))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    jcfg, _, tcfg, model = _models()
    max_len, bs, blocks = 40, 16, [5, 2, 7]  # 40 tokens -> 3 blocks, padded
    jrow = JT_.init_cache(jcfg, 1, max_len)
    jrow = jax.tree.map(lambda a: jax.numpy.asarray(
        rng.standard_normal(a.shape).astype(np.float32), a.dtype), jrow)
    insert, _ = _make_paged_steps(jcfg, max_len, None, bs, quantized=True)
    jblocks = jax.numpy.asarray(blocks, jax.numpy.int32)
    with jax.disable_jit():  # the reference's own arithmetic (see below)
        want = insert(JT_.init_paged_cache(jcfg, 9, bs, quantized=True),
                      jrow, jblocks)
    eng = _engine(tcfg, model, max_len=max_len, batch_size=1, block_size=bs,
                  num_blocks=9, kv_dtype="int8")
    pool = T.init_paged_cache(tcfg, 9, bs, quantized=True, device="cpu")
    row = {u: {n: torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for n, a in leaves.items()}
        for u, leaves in jrow.items()}
    eng._paged_insert(pool, row, blocks)
    for u, leaves in pool.items():
        for n, t in leaves.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[u][n]))

    # Compiled, the reference's insert computes the scale as
    # amax * f32(1/127): XLA rewrites the division by the constant 127. The
    # port divides, as the reference's source says (and its eager run
    # does); the scales then differ by at most one ulp, here with equal
    # codes (ROADMAP queue 3, known reference faults).
    jitted = insert(JT_.init_paged_cache(jcfg, 9, bs, quantized=True), jrow,
                    jblocks)
    for u, leaves in pool.items():
        for n in ("kp", "vp"):
            np.testing.assert_array_equal(leaves[n].numpy(),
                                          np.asarray(jitted[u][n]))
        for n, src in (("ks", "k"), ("vs", "v")):
            amax = np.abs(np.asarray(jrow[u][src], np.float32)[:, 0]).max(-1)
            amax = np.pad(amax, ((0, 0), (0, 0), (0, 3 * bs - max_len)))
            amax = amax.reshape(amax.shape[0], -1, 3, bs).transpose(0, 2, 1, 3)
            np.testing.assert_array_equal(
                np.asarray(jitted[u][n])[:, blocks],
                np.where(amax > 0, amax * np.float32(1 / 127), 1.0))
            np.testing.assert_array_max_ulp(leaves[n].numpy(),
                                            np.asarray(jitted[u][n]), 1)


def test_int8_decode_dispatches_torch_by_request():
    """The int8-pool decode runs the torch entry because the layer asks for
    it (requested == chosen, no fallback), while prefill stays on cuda."""
    _, _, tcfg, model = _models()
    reqs = [Request(prompt=p, max_new_tokens=4) for p in (P1, P3)]
    with tops.record_dispatch() as log:
        _engine(tcfg, model, max_len=32, batch_size=2,
                kv_dtype="int8").serve(reqs)
    quant = [d for d in log if d.op == "attention_decode_quant"]
    assert quant and all(d.requested == d.chosen == "torch"
                         and not d.fell_back for d in quant)
    assert quant[0].plan is not None and quant[0].plan.op.prec.p_F == \
        0.25 + 1.0 / tcfg.hd
    assert {d.chosen for d in log if d.op == "attention"} == {"cuda"}
    assert not any(d.op == "attention_decode" for d in log)


class _CudaCtx:
    """A context that claims the card (no GPU needed to hit the check)."""

    device = "cuda"
    target = tp.H100


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", "qwen2_5_3b", "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "8",
                       "--max-new", "4"])
    assert [r.finish_reason for r in reqs] == ["length"] * 3
    assert "served 3 requests on cpu" in capsys.readouterr().out


@pytest.mark.cuda
def test_engine_on_the_card():
    """The smoke config served on the card through both kernels (runs only
    where there is a GPU; chip_smoke.py serves the full-width model)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    cfg = tc.get_smoke("qwen2_5_3b")
    from repro_torch.models import transformer as T

    model = T.init_params(cfg, seed=0, device="cuda")
    cpu = T.init_params(cfg, seed=0, device="cuda").cpu()
    got = [Request(prompt=p, max_new_tokens=4) for p in _workload()]
    Engine(cfg, model, max_len=64, batch_size=3).serve(got)
    want = [Request(prompt=p, max_new_tokens=4) for p in _workload()]
    Engine(cfg, cpu, max_len=64, batch_size=3, ctx=CPU).serve(want)
    assert [len(r.out_tokens) for r in got] == [4] * len(got)
    assert [r.out_tokens[0] for r in got] == [r.out_tokens[0] for r in want]
