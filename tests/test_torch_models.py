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
from repro_torch.convert import transformer_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T
from repro_torch.ops import ExecutionContext

ARCHS = ["qwen2_5_3b", "stablelm_1_6b"]
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
    for arch in ("jamba_1_5_large", "olmoe_1b_7b", "xlstm_1_3b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tc.get_config(arch)
    assert set(tc.ARCH_IDS) | set(tc.NOT_PORTED) == set(jc.ARCH_IDS)
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
    from repro_torch import ops as tops
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
    with pytest.raises(NotImplementedError, match="int8"):
        T.init_paged_cache(tcfg, 5, 4, quantized=True, device="cpu")


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
