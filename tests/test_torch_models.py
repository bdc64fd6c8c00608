"""repro_torch.models against repro.models on the reduced (smoke) configs,
with the reference's own parameters carried over by
``repro_torch.convert.transformer_from_jax``: forward logits with no cache,
prefill into a contiguous cache then per-row decode, decode from the paged
pool, and masked bucketed prefill; plus the configs, layers and cache
helpers.

Tolerance: compute_dtype float32 (as tests/test_serving.py runs the
reference), logits to 1e-4 — both sides accumulate in f32, in a different
order; the bf16 case to 5e-2 (activations round to bf16 at every layer).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro_torch.configs as tc
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import ops as tops
from repro_torch.convert import transformer_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.ops import ExecutionContext

ARCHS = ["qwen2_5_3b", "stablelm_1_6b"]
MOE_ARCHS = ["olmoe_1b_7b", "phi3_5_moe_42b", "jamba_1_5_large"]
CTXS = {"cuda": ExecutionContext(backend="cuda", device="cpu"),
        "torch": ExecutionContext(backend="torch", device="cpu")}
TOL = dict(rtol=1e-4, atol=1e-4)


def _models(arch, compute_dtype="float32"):
    jcfg = dataclasses.replace(jc.get_smoke(arch), compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(tc.get_smoke(arch), compute_dtype=compute_dtype)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, transformer_from_jax(jparams, tcfg, "cpu")


def _tokens(cfg, B, L, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference(arch):
    assert dataclasses.asdict(tc.get_config(arch)) == \
        dataclasses.asdict(jc.get_config(arch))
    assert dataclasses.asdict(tc.get_smoke(arch)) == \
        dataclasses.asdict(jc.get_smoke(arch))


def test_unported_archs_name_their_item():
    # every architecture of the reference is ported: NOT_PORTED is empty,
    # xLSTM's config is registered and its mLSTM/sLSTM blocks build (their
    # parity tests are in test_torch_xlstm.py), and so do hubert's encoder
    # and the vlm's and the encoder's stub frontends; an unknown block kind
    # raises
    assert tc.NOT_PORTED == {}
    assert dataclasses.asdict(tc.get_config("xlstm_1_3b")) == \
        dataclasses.asdict(jc.get_config("xlstm_1_3b"))
    xlstm = dataclasses.replace(tc.get_smoke("qwen2_5_3b"),
                                pattern=("mlstm", "slstm"), n_layers=2)
    with torch.device("meta"):
        unit = T.Transformer(xlstm).layers[0]
    assert [type(unit[b].core).__name__ for b in ("b0", "b1")] == \
        ["MLSTM", "SLSTM"]
    with torch.device("meta"), pytest.raises(ValueError, match="kind"):
        T.Transformer(dataclasses.replace(xlstm, pattern=("conv", "attn")))
    encoder = dataclasses.replace(tc.get_smoke("internvl2_1b"),
                                  family="encoder")
    with torch.device("meta"):
        assert T.Transformer(encoder).embed is None
    # jamba builds whole, with its MoE FFN at every other position
    with torch.device("meta"):
        jamba = T.Transformer(tc.get_config("jamba_1_5_large"))
    unit = jamba.layers[0]
    assert [i for i in range(8) if isinstance(unit[f"b{i}"].ffn, M.MoE)] \
        == [0, 2, 4, 6]
    assert all(isinstance(unit[f"b{i}"].ffn, TL.MLP) for i in (1, 3, 5, 7))
    assert set(tc.ARCH_IDS) == set(jc.ARCH_IDS)
    assert tc.get_config("phi3_medium_14b").hd == 128
    assert tc.get_config("minitron_8b").n_kv_heads == 8


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", sorted(CTXS))
def test_forward_no_cache(arch, backend):
    jcfg, jparams, tcfg, model = _models(arch)
    toks = _tokens(jcfg, 2, 11)
    want, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, cache, aux = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                                    ctx=CTXS[backend])
    assert cache is None and float(aux) == 0.0
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_compute(arch):
    jcfg, jparams, tcfg, model = _models(arch, "bfloat16")
    toks = _tokens(jcfg, 2, 9, seed=1)
    want, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                              ctx=CTXS["cuda"])
    _close(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_cache_prefill_then_per_row_decode(arch):
    """Lockstep prefill into the cache (scalar cache_index), then two
    decode steps with every row at its own depth (per-row offsets)."""
    jcfg, jparams, tcfg, model = _models(arch)
    B, L, Lmax = 3, 6, 16
    toks = _tokens(jcfg, B, L, seed=2)
    jcache = JT.init_cache(jcfg, B, Lmax, dtype=jnp.float32)
    tcache = T.init_cache(tcfg, B, Lmax, dtype=torch.float32, device="cpu")
    want, jcache, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                                 cache=jcache,
                                 cache_index=jnp.zeros((), jnp.int32))
    with torch.no_grad():
        got, tcache, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                                   cache=tcache, cache_index=0,
                                   ctx=CTXS["cuda"])
    _close(got, want)
    _close(tcache["b0"]["k"], jcache["b0"]["k"])
    idx = np.array([6, 4, 5], np.int32)  # rows at their own depths
    for step in range(2):
        nxt = _tokens(jcfg, B, 1, seed=10 + step)
        want, jcache, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(nxt),
                                     cache=jcache,
                                     cache_index=jnp.asarray(idx + step))
        with torch.no_grad():
            got, tcache, _ = T.forward(
                model, tcfg, tokens=torch.from_numpy(nxt), cache=tcache,
                cache_index=torch.from_numpy(idx + step), ctx=CTXS["cuda"])
        _close(got, want)
    _close(tcache["b0"]["v"], jcache["b0"]["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_pool_decode(arch):
    """One decode step from the paged pool, with a dead row on the garbage
    block, against the reference's paged forward."""
    jcfg, jparams, tcfg, model = _models(arch)
    rng = np.random.default_rng(3)
    nb, bs, B = 12, 4, 3
    shape = (jcfg.repeats, nb, jcfg.n_kv_heads, bs, jcfg.hd)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    tables = np.array([[3, 7, 1], [5, 2, 0], [0, 0, 0]], np.int32)
    idx = np.array([9, 5, 0], np.int32)
    toks = _tokens(jcfg, B, 1, seed=4)
    jpool = {"b0": {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)}}
    tpool = {"b0": {"kp": torch.from_numpy(kp.copy()),
                    "vp": torch.from_numpy(vp.copy())}}
    want, jpool, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                                cache=jpool, cache_index=jnp.asarray(idx),
                                block_tables=jnp.asarray(tables))
    with torch.no_grad():
        got, tpool, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                                  cache=tpool,
                                  cache_index=torch.from_numpy(idx),
                                  block_tables=torch.from_numpy(tables),
                                  ctx=CTXS["cuda"])
    _close(got[:2], np.asarray(want)[:2])  # the dead row's output is void
    live = [3, 7, 1, 5, 2]
    _close(tpool["b0"]["kp"][:, live], np.asarray(jpool["b0"]["kp"])[:, live])


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_bucketed_prefill(arch):
    """A prompt padded to a bucket with its pad tail masked (key_mask) gives
    the reference's logits over the real tokens, through the cuda entry."""
    jcfg, jparams, tcfg, model = _models(arch)
    plen, lp, Lmax = 5, 8, 16
    toks = np.zeros((1, lp), np.int32)
    toks[0, :plen] = _tokens(jcfg, 1, plen, seed=5)
    mask = np.zeros((1, lp), bool)
    mask[0, :plen] = True
    want, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                            cache=JT.init_cache(jcfg, 1, Lmax,
                                                dtype=jnp.float32),
                            cache_index=jnp.zeros((), jnp.int32),
                            attn_mask=jnp.asarray(mask))
    with torch.no_grad(), tops.record_dispatch() as log:
        got, _, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                              cache=T.init_cache(tcfg, 1, Lmax,
                                                 dtype=torch.float32,
                                                 device="cpu"),
                              cache_index=0,
                              attn_mask=torch.from_numpy(mask),
                              ctx=CTXS["cuda"])
    _close(got[:, :plen], np.asarray(want)[:, :plen])
    attn = [d for d in log if d.op == "attention"]
    assert len(attn) == tcfg.n_layers
    assert all(d.chosen == "cuda" and not d.fell_back for d in attn)
    exact, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks[:, :plen]))
    _close(got[:, :plen], exact)


def test_layers_match_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = np.array([0, 3, 7, 100, 4095], np.int32)
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), rtol=1e-5,
           atol=1e-5)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)), rtol=1e-5,
           atol=1e-5)
    km = np.array([[True, True, False, False]])
    got = TL._expand_key_mask(torch.from_numpy(km), 3, None, 4, 10, True)
    want = JL._expand_key_mask(jnp.asarray(km), jnp.asarray(3, jnp.int32), 4,
                               10, True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_helpers(arch):
    _, _, tcfg, _ = _models(arch)
    jcfg = jc.get_smoke(arch)
    for max_len, bs in ((24, None), (24, 16), (64, 16)):
        assert T.cache_footprint_words(tcfg, max_len, block_size=bs) == \
            JT.cache_footprint_words(jcfg, max_len, block_size=bs)
    pool = T.init_cache(tcfg, 3, 8, dtype=torch.float32, device="cpu")
    row = {u: {n: torch.full_like(t[:, :1], 2.0) for n, t in leaves.items()}
           for u, leaves in T.init_cache(tcfg, 1, 8, dtype=torch.float32,
                                         device="cpu").items()}
    T.insert_cache_slot(pool, row, 1)
    for t in pool["b0"].values():
        assert (t[:, 1] == 2.0).all() and (t[:, 0] == 0).all()
    T.reset_cache_slot(pool, 1)
    assert all((t == 0).all() for t in pool["b0"].values())
    paged = T.init_paged_cache(tcfg, 5, 4, device="cpu")
    assert paged["b0"]["kp"].shape == (tcfg.repeats, 5, tcfg.n_kv_heads, 4,
                                       tcfg.hd)
    qpool = T.init_paged_cache(tcfg, 5, 4, quantized=True, device="cpu")
    jpool = JT.init_paged_cache(jcfg, 5, 4, quantized=True)
    assert sorted(qpool["b0"]) == sorted(jpool["b0"]) == ["kp", "ks", "vp",
                                                          "vs"]
    for name, leaf in qpool["b0"].items():
        want = np.asarray(jpool["b0"][name])
        assert leaf.shape == want.shape and str(leaf.dtype)[6:] == \
            str(want.dtype)
        np.testing.assert_array_equal(leaf.numpy(), want)


# -- the fused (B, KV, L, 2, hd) KV layout ----------------------------------

def _fused(arch):
    jcfg, jparams, tcfg, model = _models(arch)
    return (dataclasses.replace(jcfg, fused_kv_cache=True), jparams,
            dataclasses.replace(tcfg, fused_kv_cache=True), model, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_kv_cache_decode_matches(arch):
    """The counterpart of tests/test_models.py::
    test_fused_kv_cache_decode_matches: prefill 8 into the fused cache,
    then 8 decode steps. The logits equal the reference's fused run (1e-4),
    the cache-less forward's (1e-4) and the split layout's bit for bit
    (the attention reads the same K/V values), and the kv leaf equals the
    reference's."""
    jcfg, jparams, fcfg, model, scfg = _fused(arch)
    toks = _tokens(jcfg, 2, 16, seed=5)
    jcache = JT.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    runs = {}
    for name, cfg in (("fused", fcfg), ("split", scfg)):
        cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        outs = []
        with torch.no_grad():
            for lo, hi in [(0, 8)] + [(t, t + 1) for t in range(8, 16)]:
                lg, cache, _ = T.forward(
                    model, cfg, tokens=torch.from_numpy(toks[:, lo:hi]),
                    cache=cache, cache_index=lo, ctx=CTXS["cuda"],
                    decode=lo >= 8)
                outs.append(lg)
        runs[name] = (torch.cat(outs, dim=1), cache)
    assert sorted(runs["fused"][1]["b0"]) == ["kv"]
    assert torch.equal(runs["fused"][0], runs["split"][0])
    outs = []
    for lo, hi in [(0, 8)] + [(t, t + 1) for t in range(8, 16)]:
        lg, jcache, _ = JT.forward(jparams, jcfg,
                                   tokens=jnp.asarray(toks[:, lo:hi]),
                                   cache=jcache,
                                   cache_index=jnp.asarray(lo, jnp.int32),
                                   decode=lo >= 8)
        outs.append(lg)
    _close(runs["fused"][0], jnp.concatenate(outs, axis=1))
    _close(runs["fused"][1]["b0"]["kv"], jcache["b0"]["kv"])
    full, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    _close(runs["fused"][0], full)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_kv_cache_per_row_decode(arch):
    """Per-row write offsets (continuous-batching decode) into the fused
    leaf: logits and the leaf against the reference's, and K and V against
    the split layout's leaves."""
    jcfg, jparams, fcfg, model, scfg = _fused(arch)
    B, L, Lmax = 3, 6, 16
    toks = _tokens(jcfg, B, L, seed=2)
    idx = np.array([6, 4, 5], np.int32)
    jcache = JT.init_cache(jcfg, B, Lmax, dtype=jnp.float32)
    _, jcache, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                              cache=jcache,
                              cache_index=jnp.zeros((), jnp.int32))
    caches = {n: T.init_cache(c, B, Lmax, dtype=torch.float32, device="cpu")
              for n, c in (("fused", fcfg), ("split", scfg))}
    with torch.no_grad():
        for n, c in (("fused", fcfg), ("split", scfg)):
            T.forward(model, c, tokens=torch.from_numpy(toks),
                      cache=caches[n], cache_index=0, ctx=CTXS["cuda"])
    for step in range(2):
        nxt = _tokens(jcfg, B, 1, seed=10 + step)
        want, jcache, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(nxt),
                                     cache=jcache,
                                     cache_index=jnp.asarray(idx + step),
                                     decode=True)
        with torch.no_grad():
            got = {n: T.forward(model, c, tokens=torch.from_numpy(nxt),
                                cache=caches[n],
                                cache_index=torch.from_numpy(idx + step),
                                ctx=CTXS["cuda"], decode=True)[0]
                   for n, c in (("fused", fcfg), ("split", scfg))}
        _close(got["fused"], want)
        assert torch.equal(got["fused"], got["split"])
    kv = caches["fused"]["b0"]["kv"]
    _close(kv, jcache["b0"]["kv"])
    assert torch.equal(kv[..., 0, :], caches["split"]["b0"]["k"])
    assert torch.equal(kv[..., 1, :], caches["split"]["b0"]["v"])


def test_fused_cache_helpers_and_engine_rules():
    """``init_cache`` builds the reference's (repeats, B, KV, L, 2, hd)
    leaf; the footprint equals the reference's and the split layout's; the
    slot helpers work on the new leaf; the engine takes the contiguous
    cache and refuses ``paged=True``; its greedy tokens equal the split
    engine's and the reference's fused engine's."""
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import Request as JRequest
    from repro_torch.serving import Engine, Request

    jcfg, jparams, fcfg, model, scfg = _fused("qwen2_5_3b")
    cache = T.init_cache(fcfg, 3, 8, device="cpu")
    jcache = JT.init_cache(jcfg, 3, 8)
    assert list(cache["b0"]) == list(jcache["b0"]) == ["kv"]
    assert cache["b0"]["kv"].shape == jcache["b0"]["kv"].shape == (
        fcfg.repeats, 3, fcfg.n_kv_heads, 8, 2, fcfg.hd)
    assert cache["b0"]["kv"].dtype == torch.bfloat16
    for max_len in (24, 64):
        assert T.cache_footprint_words(fcfg, max_len) == \
            JT.cache_footprint_words(jcfg, max_len) == \
            T.cache_footprint_words(scfg, max_len)
    row = T.init_cache(fcfg, 1, 8, device="cpu")
    row["b0"]["kv"].fill_(2.0)
    T.insert_cache_slot(cache, row, 1)
    kv = cache["b0"]["kv"]
    assert (kv[:, 1] == 2.0).all() and (kv[:, 0] == 0).all()
    T.reset_cache_slot(cache, 1)
    assert (kv == 0).all()
    with pytest.raises(ValueError, match="fused"):
        Engine(fcfg, model, max_len=32, batch_size=2, ctx=CTXS["cuda"],
               paged=True)
    prompts = [np.arange(1, n + 1, dtype=np.int32) * 3 for n in (5, 1, 9, 3)]
    out = {}
    for name, cfg in (("fused", fcfg), ("split", scfg)):
        eng = Engine(cfg, model, max_len=32, batch_size=2, ctx=CTXS["cuda"],
                     paged=None if name == "fused" else False)
        assert not eng.paged
        out[name] = [Request(prompt=p, max_new_tokens=6) for p in prompts]
        eng.serve(out[name])
    want = [JRequest(prompt=p, max_new_tokens=6) for p in prompts]
    JEngine(jcfg, jparams, max_len=32, batch_size=2).serve(want)
    for a, b, w in zip(out["fused"], out["split"], want):
        assert a.finish_reason == "length"
        np.testing.assert_array_equal(a.out_tokens, b.out_tokens)
        np.testing.assert_array_equal(a.out_tokens, w.out_tokens)


def test_compute_params_computes_the_same():
    """The compute-dtype copy the engine keeps gives the logits of casting
    at use, and keeps the norm scales in f32."""
    cfg = tc.get_smoke("qwen2_5_3b")
    model = T.init_params(cfg, seed=1, device="cpu")
    copy = T.compute_params(model, cfg)
    assert copy.layers[0]["b0"].core.wq.dtype == torch.bfloat16
    assert copy.layers[0]["b0"].norm1.dtype == torch.float32
    toks = torch.from_numpy(_tokens(cfg, 1, 7))
    with torch.no_grad():
        a, _, _ = T.forward(model, cfg, tokens=toks, ctx=CTXS["cuda"])
        b, _, _ = T.forward(copy, cfg, tokens=toks, ctx=CTXS["cuda"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the MoE configs and InternVL2's backbone ---------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS[:2] + ["internvl2_1b"])
def test_moe_and_vlm_configs_are_the_reference(arch):
    assert arch in tc.ARCH_IDS and arch not in tc.NOT_PORTED
    for get in ("get_config", "get_smoke"):
        assert dataclasses.asdict(getattr(tc, get)(arch)) == \
            dataclasses.asdict(getattr(jc, get)(arch))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("backend", sorted(CTXS))
def test_moe_forward_equal_reference(arch, backend):
    """Logits and the summed aux loss of the smoke configs with experts
    (jamba: MoE at positions 0, 2, 4 and 6 of its unit), in one group and
    in two; every MoE layer's chosen experts and kept mask as the
    reference's (their sum of drops equal)."""
    jcfg, jparams, tcfg, model = _models(arch)
    toks = _tokens(jcfg, 2, 11, seed=7)
    for n_groups in (1, 2):
        want, _, want_aux = JT.forward(jparams, jcfg,
                                       tokens=jnp.asarray(toks),
                                       n_groups=n_groups)
        with torch.no_grad(), M.record_routing() as log:
            got, _, aux = T.forward(model, tcfg,
                                    tokens=torch.from_numpy(toks),
                                    ctx=CTXS[backend], n_groups=n_groups)
        _close(got, want)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
        moe_layers = tcfg.repeats * sum(
            T._is_moe(tcfg, i) for i in range(len(tcfg.pattern)))
        assert len(log) == moe_layers and float(aux) > 0
        assert all(r.gate_idx.shape[0] == n_groups for r in log)


@pytest.mark.parametrize("arch", MOE_ARCHS[:2])
def test_moe_forward_bf16_compute(arch):
    jcfg, jparams, tcfg, model = _models(arch, "bfloat16")
    toks = _tokens(jcfg, 2, 9, seed=1)
    want, _, want_aux = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _, aux = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                                ctx=CTXS["cuda"])
    _close(got, want, rtol=5e-2, atol=5e-2)
    # the second layer routes bf16 hidden states that differ in their last
    # bits between the packages: its f32 probabilities differ about 2^-8 of
    # that
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3)


@pytest.mark.parametrize("backend", sorted(CTXS))
def test_vlm_embeddings_forward_equal_reference(backend):
    """InternVL2's backbone on stub patch embeddings (``embeds=``) and on
    text tokens through its kept ``embed``, against the reference."""
    jcfg, jparams, tcfg, model = _models("internvl2_1b")
    assert "embed" in jparams and model.embed.shape == jparams["embed"].shape
    emb = np.random.default_rng(8).standard_normal(
        (2, 12, jcfg.d_model)).astype(np.float32)
    want, _, _ = JT.forward(jparams, jcfg, embeds=jnp.asarray(emb))
    with torch.no_grad(), tops.record_dispatch() as log:
        got, cache, aux = T.forward(model, tcfg,
                                    embeds=torch.from_numpy(emb),
                                    ctx=CTXS[backend])
    assert cache is None and float(aux) == 0.0
    _close(got, want)
    assert [d.chosen for d in log if d.op == "attention"] == \
        [backend] * tcfg.n_layers
    toks = _tokens(jcfg, 2, 7, seed=9)
    want, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                              ctx=CTXS[backend])
    _close(got, want)


def test_compute_params_keeps_the_router_f32():
    """The compute-dtype copy casts the experts and keeps the router in f32
    (the reference routes in f32): logits equal to casting at use."""
    cfg = tc.get_smoke("olmoe_1b_7b")
    model = T.init_params(cfg, seed=2, device="cpu")
    copy = T.compute_params(model, cfg)
    ffn = copy.layers[0]["b0"].ffn
    assert ffn.router.dtype == torch.float32
    assert ffn.w_gate.dtype == ffn.w_down.dtype == torch.bfloat16
    assert ffn.w_up.shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    toks = torch.from_numpy(_tokens(cfg, 2, 9, seed=3))
    with torch.no_grad():
        a, _, aux_a = T.forward(model, cfg, tokens=toks, ctx=CTXS["cuda"])
        b, _, aux_b = T.forward(copy, cfg, tokens=toks, ctx=CTXS["cuda"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(aux_a) == float(aux_b)
