"""repro_torch's hybrid mamba slice against repro's: the causal conv1d
(plain version and wrapper on the CPU against the reference's Pallas kernel
in interpret mode and its oracle), its word counter and dispatch, the mamba
block (chunked prefill, decode step, state), the jamba model cut to one
pattern unit with experts off, and the contiguous engine serving it.

Inputs are made with numpy from fixed seeds; the reference's parameters are
carried over leaf by leaf.

Tolerances: the conv1d plain version adds its taps in the Pallas kernel's
order with f32 roundings, so f32 agrees within 1e-6 and bf16 outputs are
bit-equal to the Pallas kernel's (one bf16 ulp would be allowed; none is
needed); the reference's oracle sums in another order (1e-6 in f32, one
bf16 ulp, 2^-7 relative). The mamba block, model and engine compute in f32
on both sides, in different einsum orders: 1e-4, as tests/test_torch_models
holds the dense models; greedy tokens are then equal token for token.
"""

import dataclasses
import importlib

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
from repro.kernels import ref as jref
from repro.models import config as jconfig
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import ops as tops
from repro_torch.convert import params_from_jax, transformer_from_jax
from repro_torch.kernels import (KERNELS, conv1d_causal, conv1d_causal_plain,
                                 conv1d_hbm_words, ref)
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels.conv1d import launch_config
from repro_torch.models import config as tconfig
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.serving import Engine, Request

jconv1d = importlib.import_module("repro.kernels.conv1d")

CPU = tops.ExecutionContext(device="cpu")  # cuda backend: plain versions
TORCH = tops.ExecutionContext(backend="torch", device="cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
TARGETS = ("H100", "TPU_V5E", "GEMMINI")
# (B, L, D, K): tests/test_kernels.py's sweep, then L < K-1, L = 1 and K = 1
CONV_CASES = [(2, 16, 32, 4), (3, 100, 64, 3), (1, 7, 5, 2), (2, 33, 130, 4),
              (2, 2, 40, 4), (3, 1, 17, 4), (2, 9, 24, 1), (20, 5, 3, 8)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _conv_inputs(B, L, D, K, dt, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    w = (rng.standard_normal((K, D)) * K ** -0.5).astype(np.float32)
    jd, td = DTYPES[dt]
    return ((jnp.asarray(x, jd), jnp.asarray(w, jd)),
            (torch.from_numpy(x).to(td), torch.from_numpy(w).to(td)))


def _jt(name):
    return jp.HardwareTarget.from_dict(getattr(tp, name).to_dict())


# -- conv1d: plain version, wrapper and oracle against the reference ---------

@pytest.mark.parametrize("case", CONV_CASES, ids=str)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv1d_against_pallas_kernel(case, dt):
    (jx, jw), (tx, tw) = _conv_inputs(*case, dt)
    want = jconv1d.conv1d_causal(jx, jw, interpret=True)
    for got in (conv1d_causal_plain(tx, tw), conv1d_causal(tx, tw),
                conv1d_causal(tx, tw, tiles=(1, 7))):
        assert got.dtype == tx.dtype and got.shape == tx.shape
        if dt == "bf16":  # same order, same roundings: bit-equal
            np.testing.assert_array_equal(_np(got), _np(want))
        else:
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv1d_oracle_against_reference(case, dt):
    (jx, jw), (tx, tw) = _conv_inputs(*case, dt, seed=1)
    want = _np(jref.conv1d_causal_ref(jx, jw))
    tol = (dict(rtol=1e-6, atol=1e-6) if dt == "f32"
           else dict(rtol=2.0 ** -7, atol=2.0 ** -7))
    np.testing.assert_allclose(_np(ref.conv1d_causal_ref(tx, tw)), want,
                               **tol)
    np.testing.assert_allclose(_np(conv1d_causal_plain(tx, tw)), want, **tol)


def test_conv1d_is_causal_with_zero_left_padding():
    x = torch.zeros((1, 6, 2))
    x[0, 2] = 1.0  # an impulse at t = 2
    w = torch.arange(1.0, 9.0).reshape(4, 2)
    y = conv1d_causal(x, w)
    assert torch.all(y[0, :2] == 0)  # nothing before the impulse
    # y[t] = w[K-1-(t-2)]: the taps in reverse from t = 2 on
    assert torch.equal(y[0, 2:], w.flip(0))


def test_conv1d_reads_a_row_strided_view():
    """The mamba front passes the x half of the in-projection, a view with
    a time stride of 2 di: the wrapper reads it as it lies."""
    xz = torch.randn((2, 9, 2 * 24), generator=torch.Generator().manual_seed(0))
    w = torch.randn((4, 24), generator=torch.Generator().manual_seed(1))
    view = xz[..., :24]
    assert not view.is_contiguous() and view.stride(2) == 1
    assert torch.equal(conv1d_causal(view, w),
                       conv1d_causal_plain(view.contiguous(), w))


def test_conv1d_cuda_tensor_never_takes_the_plain_version():
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    before = {n: k.launches for n, k in KERNELS.items()}
    with pytest.raises(ValueError, match="CUDA device"):
        conv1d_causal(meta(1, 8, 32), meta(4, 32))
    assert {n: k.launches for n, k in KERNELS.items()} == before
    with pytest.raises(ValueError, match="taps"):
        launch_config(9, 16, 16, (1, 1), 2)
    with pytest.raises(ValueError, match="65,535"):
        launch_config(4, 1, 16, (65536, 1), 2)
    # a tile wider than a CTA's 128 bytes of a row is split over CTAs, so
    # its ring fits shared memory
    wide = launch_config(8, 1, 8192, (1, 1), 4)
    assert wide["parts"] == 256 and wide["span"] == 32
    assert wide["smem"] <= MAX_SMEM_BYTES
    # the serve's plan, (1, 16) tiles over D = 16384: 4 tiles a CTA
    serve = launch_config(4, 1, 16, (1, 1024), 2)
    assert {k: serve[k] for k in ("span", "vec", "copy", "threads", "smem",
                                  "grid")} == {
        "span": 64, "vec": 8, "copy": "cp.async.cg", "threads": 256,
        "smem": 8 * 32 * 64 * 2 + 4 * 64 * 4, "grid": (256, 1)}
    assert launch_config(4, 16, 128, (1, 1), 4)["threads"] == 256


# -- the word counter and the dispatch ---------------------------------------

@pytest.mark.parametrize("target", TARGETS + ("tiles",))
def test_conv1d_words_equal_reference(target):
    """The counter, on both sides of the nD == 1 rule (the filter fetched
    once when the channel grid has one column, every step otherwise)."""
    for (B, L, D, K) in [(1, 300, 16384, 4), (3, 100, 64, 3), (20, 5, 16, 4),
                         (2, 33, 130, 4), (40, 7, 8, 2)]:
        for jd, td in DTYPES.values():
            xs = jax.ShapeDtypeStruct((B, L, D), jd)
            ws = jax.ShapeDtypeStruct((K, D), jd)
            xm = torch.empty((B, L, D), dtype=td, device="meta")
            wm = torch.empty((K, D), dtype=td, device="meta")
            if target == "tiles":
                for tiles in ((1, D), (2, 16), (4, 1)):
                    assert conv1d_hbm_words(xm, wm, tiles=tiles) == \
                        jconv1d.conv1d_hbm_words(xs, ws, tiles=tiles)
            else:
                assert conv1d_hbm_words(xm, wm,
                                        target=getattr(tp, target)) == \
                    jconv1d.conv1d_hbm_words(xs, ws, target=_jt(target))
    # the H100 preset's tiles: (min(B, 16), min(D, 16)); nD == 1 -> one fetch
    xm = torch.empty((20, 5, 16), device="meta")
    wm = torch.empty((4, 16), device="meta")
    nB, nD = 2, 1
    assert conv1d_hbm_words(xm, wm) == 2 * nB * nD * 16 * 5 * 16 + 4 * 16


def test_conv1d_explain_and_dispatch(monkeypatch):
    x = torch.randn((1, 37, 64), generator=torch.Generator().manual_seed(2))
    w = torch.randn((4, 64), generator=torch.Generator().manual_seed(3))
    jctx = jops.ExecutionContext(target=_jt("H100"), backend="pallas",
                                 interpret=True)
    want = jops.explain("conv1d_causal", jctx, dtype="float32",
                        spec_args=(jax.ShapeDtypeStruct(x.shape, jnp.float32),
                                   jax.ShapeDtypeStruct(w.shape, jnp.float32)))
    d = tops.explain("conv1d_causal", CPU, dtype=x.dtype, spec_args=(x, w))
    assert d.chosen == "cuda" and not d.fell_back and d.plan is None
    assert d.measured_words == want.measured_words == \
        conv1d_hbm_words(x, w, target=tp.H100)
    t = tops.explain("conv1d_causal", TORCH, dtype=x.dtype, spec_args=(x, w))
    assert t.chosen == "torch" and t.measured_words is None
    with tops.record_dispatch() as log:
        a = tops.conv1d_causal(x, w, ctx=CPU)
        b = tops.conv1d_causal(x, w, ctx=TORCH)
    assert [(r.op, r.chosen) for r in log] == [("conv1d_causal", "cuda"),
                                               ("conv1d_causal", "torch")]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    # cuda takes f32/bf16: another dtype falls back only on the CPU
    h = tops.explain("conv1d_causal", CPU, dtype=torch.float16,
                     spec_args=(x.half(), w.half()))
    assert h.chosen == "torch" and h.missing == ("dtype:float16",)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = tops.ExecutionContext(device="cuda")
    with pytest.raises(NotImplementedError, match="on the card"):
        tops.explain("conv1d_causal", card, dtype=torch.float16)


def test_conv1d_gradient_recomputes_through_aten():
    x = torch.randn((2, 9, 8), requires_grad=True)
    w = torch.randn((4, 8), requires_grad=True)
    tops.conv1d_causal(x, w, ctx=CPU).square().sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    ref.conv1d_causal_ref(x, w).square().sum().backward()
    torch.testing.assert_close(gx, x.grad)
    torch.testing.assert_close(gw, w.grad)


# -- the mamba block ---------------------------------------------------------

def _cfgs(compute_dtype="float32", layers=None):
    """The jamba smoke config with experts off, in both packages."""
    kw = dict(n_experts=0, experts_per_token=0, compute_dtype=compute_dtype)
    jcfg = dataclasses.replace(jconfig.reduced(
        jc.get_config("jamba_1_5_large"), layers=layers), **kw)
    tcfg = dataclasses.replace(tconfig.reduced(
        tc.get_config("jamba_1_5_large"), layers=layers), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _mamba(cfg_pair):
    jcfg, tcfg = cfg_pair
    jp_ = jssm.init_mamba(jax.random.PRNGKey(1), jcfg)
    with torch.device("meta"):
        mod = ssm.Mamba(tcfg)
    mod.load_state_dict(params_from_jax(jp_, "cpu"), assign=True)
    return jp_, mod


def _x(B, L, D, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, L, D)).astype(np.float32)


def _state_np(state):
    return [_np(s) for s in state]


@pytest.mark.parametrize("L", [37, 16, 5])
def test_mamba_block_and_decode_equal_reference(L):
    """Prefill from a zero state (L = 37: three chunks, the last ragged),
    then three decode steps, against the reference's functions."""
    jcfg, tcfg = cfg = _cfgs()
    jp_, mod = _mamba(cfg)
    B = 2
    x = _x(B, L, jcfg.d_model)
    jstate = jssm.init_mamba_state(jcfg, B)
    tstate = ssm.init_mamba_state(tcfg, B, device="cpu")
    for a, b in zip(tstate, jstate):
        assert a.shape == b.shape and a.dtype == torch.float32
    want, jstate = jssm.mamba_block(jp_, jnp.asarray(x), jcfg, jstate)
    with torch.no_grad():
        got, tstate = ssm.mamba_block(mod, torch.from_numpy(x), tcfg, tstate,
                                      ctx=CPU)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for a, b in zip(_state_np(tstate), _state_np(jstate)):
        np.testing.assert_allclose(a, b, **TOL)
    for step in range(3):
        xt = _x(B, 1, jcfg.d_model, seed=10 + step)
        want, jstate = jssm.mamba_decode_step(jp_, jnp.asarray(xt), jcfg,
                                              jstate)
        with torch.no_grad():
            got, tstate = ssm.mamba_decode_step(mod, torch.from_numpy(xt),
                                                tcfg, tstate, ctx=CPU)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        for a, b in zip(_state_np(tstate), _state_np(jstate)):
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("L", [37, 7])
def test_mamba_chunked_scan_equals_sequential_oracle(L):
    jcfg, tcfg = cfg = _cfgs()
    jp_, mod = _mamba(cfg)
    x = torch.from_numpy(_x(2, L, tcfg.d_model, seed=5))
    with torch.no_grad():
        got, none = ssm.mamba_block(mod, x, tcfg, ctx=CPU)
        seq = ssm.mamba_block_ref(mod, x, tcfg)
    assert none is None
    np.testing.assert_allclose(got.numpy(), seq.numpy(), **TOL)
    want = jssm.mamba_block_ref(jp_, jnp.asarray(x.numpy()), jcfg)
    np.testing.assert_allclose(seq.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("L", [1, 2])
def test_short_prompt_tail_is_left_padded(L):
    """A prompt shorter than K-1: the port's tail is K-1 rows, zeros first,
    then the in-projection's x rows; the reference returns only L rows
    (repro/models/ssm.py:145), which its insert then writes at the start
    of the slot's tail."""
    jcfg, tcfg = cfg = _cfgs()
    jp_, mod = _mamba(cfg)
    K, di = tcfg.conv_kernel, tcfg.d_inner
    x = _x(1, L, tcfg.d_model, seed=6)
    with torch.no_grad():
        _, (h, tail) = ssm.mamba_block(
            mod, torch.from_numpy(x), tcfg,
            ssm.init_mamba_state(tcfg, 1, device="cpu"), ctx=CPU)
    x_in = x @ np.asarray(jp_["w_in"])[:, :di]
    assert tail.shape == (1, K - 1, di)
    assert torch.all(tail[0, :K - 1 - L] == 0)
    np.testing.assert_allclose(tail[0, K - 1 - L:].numpy(), x_in[0], **TOL)
    _, (_, jtail) = jssm.mamba_block(jp_, jnp.asarray(x), jcfg,
                                     jssm.init_mamba_state(jcfg, 1))
    assert jtail.shape[1] == L  # the reference's short tail


# -- the model: one jamba pattern unit, experts off --------------------------

def _models(compute_dtype="float32"):
    jcfg, tcfg = _cfgs(compute_dtype, layers=8)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, tcfg, transformer_from_jax(jparams, tcfg, "cpu")


def _tokens(cfg, B, L, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


def test_configs_are_the_reference():
    assert "jamba_1_5_large" in tc.ARCH_IDS
    assert "jamba_1_5_large" not in tc.NOT_PORTED
    for get in ("get_config", "get_smoke"):
        assert dataclasses.asdict(getattr(tc, get)("jamba_1_5_large")) == \
            dataclasses.asdict(getattr(jc, get)("jamba_1_5_large"))
    cfg = tc.get_config("jamba_1_5_large")
    unit = dataclasses.replace(cfg, n_experts=0, experts_per_token=0,
                               n_layers=8)
    assert unit.repeats == 1 and unit.pattern.count("mamba") == 7
    assert unit.d_inner == 16384 and ssm._heads(unit) == (128, 128)
    with torch.device("meta"):
        model = T.Transformer(cfg)  # the MoE FFN too, at published widths
    assert len(model.layers) == 9
    for i in (0, 2, 4, 6):
        ffn = model.layers[0][f"b{i}"].ffn
        assert ffn.w_gate.shape == ffn.w_up.shape == (16, 8192, 24576)
        assert ffn.w_down.shape == (16, 24576, 8192)
        assert ffn.router.shape == (8192, 16)
        assert ffn.router.dtype == torch.float32


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_forward_no_cache_equal_reference(backend):
    jcfg, jparams, tcfg, model = _models()
    toks = _tokens(jcfg, 2, 21)
    want, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    ctx = CPU if backend == "cuda" else TORCH
    with torch.no_grad(), tops.record_dispatch() as log:
        got, cache, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                                  ctx=ctx)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    convs = [d for d in log if d.op == "conv1d_causal"]
    assert len(convs) == 7 and {d.chosen for d in convs} == {backend}


def test_forward_bf16_compute():
    jcfg, jparams, tcfg, model = _models("bfloat16")
    toks = _tokens(jcfg, 1, 19, seed=1)
    want, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _, _ = T.forward(T.compute_params(model, tcfg), tcfg,
                              tokens=torch.from_numpy(toks), ctx=CPU)
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=5e-2,
                               atol=5e-2)


def test_prefill_then_decode_equal_reference():
    """Prefill (3 rows at one depth) into the cache, then two decode steps
    with every row at its own depth: logits and every cache leaf."""
    jcfg, jparams, tcfg, model = _models()
    B, L, Lmax = 3, 6, 16
    toks = _tokens(jcfg, B, L, seed=2)
    jcache = JT.init_cache(jcfg, B, Lmax, dtype=jnp.float32)
    tcache = T.init_cache(tcfg, B, Lmax, dtype=torch.float32, device="cpu")
    assert {k: sorted(v) for k, v in tcache.items()} == \
        {k: sorted(v) for k, v in jcache.items()}
    want, jcache, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                                 cache=jcache,
                                 cache_index=jnp.zeros((), jnp.int32))
    with torch.no_grad():
        got, tcache, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                                   cache=tcache, cache_index=0, ctx=CPU)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    idx = np.array([6, 4, 5], np.int32)
    for step in range(2):
        nxt = _tokens(jcfg, B, 1, seed=10 + step)
        want, jcache, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(nxt),
                                     cache=jcache,
                                     cache_index=jnp.asarray(idx + step),
                                     decode=True)
        with torch.no_grad():
            got, tcache, _ = T.forward(
                model, tcfg, tokens=torch.from_numpy(nxt), cache=tcache,
                cache_index=torch.from_numpy(idx + step), ctx=CPU,
                decode=True)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for u, leaves in tcache.items():
        for name, t in leaves.items():
            np.testing.assert_allclose(t.numpy(), _np(jcache[u][name]),
                                       **TOL)


def test_transformer_from_jax_round_trip_and_compute_params():
    jcfg, jparams, tcfg, model = _models("bfloat16")
    state = model.state_dict()
    assert len(state) == len(jax.tree.leaves(jparams))
    for name, leaf in jparams["layers"]["b4"]["core"].items():  # attention
        np.testing.assert_array_equal(state[f"layers.0.b4.core.{name}"],
                                      np.asarray(leaf)[0])
    for name, leaf in jparams["layers"]["b1"]["core"].items():  # mamba
        np.testing.assert_array_equal(state[f"layers.0.b1.core.{name}"],
                                      np.asarray(leaf)[0])
    cp = T.compute_params(model, tcfg).state_dict()
    for name, t in cp.items():
        keep = name.rsplit(".", 1)[-1] in ("norm1", "norm2", "final_norm",
                                           "conv_w", "b_dt", "log_A",
                                           "D_skip")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), name
    assert {n.rsplit(".", 1)[-1] for n, t in cp.items()
            if ".core." in n and t.dtype == torch.float32} == \
        {"conv_w", "b_dt", "log_A", "D_skip"}


def test_cache_footprint_and_paged_rules_equal_reference():
    jcfg, tcfg = _cfgs(layers=8)
    for max_len in (16, 512):
        assert T.cache_footprint_words(tcfg, max_len) == \
            JT.cache_footprint_words(jcfg, max_len)
    full = dataclasses.replace(tc.get_config("jamba_1_5_large"), n_experts=0,
                               experts_per_token=0, n_layers=8)
    jfull = dataclasses.replace(jc.get_config("jamba_1_5_large"), n_experts=0,
                                experts_per_token=0, n_layers=8)
    assert T.cache_footprint_words(full, 512) == \
        JT.cache_footprint_words(jfull, 512)
    with pytest.raises(ValueError, match="pure-attention"):
        T.init_paged_cache(tcfg, 8, 4, device="cpu")


# -- serving: the contiguous engine, exact-length prefill --------------------

PROMPTS = [np.array(p, np.int32) for p in
           ([1, 2, 3], [9, 8], [5], [4, 7, 1, 9, 2], list(range(3, 23)),
            [11, 12, 13, 14])]


def _serve(engine_cls, req_cls, cfg, params, prompts, batch, **kw):
    reqs = [req_cls(prompt=p, max_new_tokens=5) for p in prompts]
    engine_cls(cfg, params, max_len=48, batch_size=batch, **kw).serve(reqs)
    return reqs


def _forward_gap(model, cfg, r) -> float:
    """Largest gap between a generated token's logit and its row's max
    under the port's cache-less forward over prompt + tokens."""
    seq = np.concatenate([r.prompt, r.out_tokens])[None].astype(np.int64)
    with torch.no_grad():
        lg, _, _ = T.forward(model, cfg, tokens=torch.from_numpy(seq),
                             ctx=TORCH)
    p = len(r.prompt)
    rows = lg[0, p - 1:p - 1 + len(r.out_tokens)]
    out = torch.from_numpy(r.out_tokens.astype(np.int64))
    return float((rows.max(-1).values - rows.gather(1, out[:, None])[:, 0])
                 .max())


def test_engine_greedy_tokens_equal_reference():
    """Six requests over three slots, admitted mid-flight: the hybrid
    pattern takes the contiguous cache and exact-length prefill, and the
    tokens of every prompt of >= 3 tokens equal the reference engine's."""
    jcfg, jparams, tcfg, model = _models()
    want = _serve(JEngine, JRequest, jcfg, jparams, PROMPTS, 3)
    eng = Engine(tcfg, model, max_len=48, batch_size=3, ctx=CPU)
    assert not eng.paged and eng.prefill_bucket == 1
    got = [Request(prompt=p, max_new_tokens=5) for p in PROMPTS]
    with tops.record_dispatch() as log:
        eng.serve(got)
    for a, b in zip(want, got):
        assert b.finish_reason == "length" and len(b.out_tokens) == 5
        if len(a.prompt) >= 3:
            np.testing.assert_array_equal(b.out_tokens, a.out_tokens)
    convs = [d for d in log if d.op == "conv1d_causal"]
    assert len(convs) == 7 * len(PROMPTS)  # prefill only; decode is aten
    assert {d.chosen for d in convs} == {"cuda"}


def test_short_prompts_follow_the_forward_not_the_reference():
    """1- and 2-token prompts: every port token is the argmax of the port's
    own cache-less forward, while the reference engine's decode window
    holds a stale row (its short tail) and leaves its forward."""
    jcfg, jparams, tcfg, model = _models()
    short = [np.array([9, 8], np.int32), np.array([5], np.int32)]
    # a longer request first, so the short ones land in a used slot
    prompts = [PROMPTS[4]] + short
    got = _serve(Engine, Request, tcfg, model, prompts, 1, ctx=CPU)
    for r in got:
        assert _forward_gap(model, tcfg, r) == 0.0
    want = _serve(JEngine, JRequest, jcfg, jparams, prompts, 1)
    ref_gaps = []
    for r in want[1:]:
        seq = np.concatenate([r.prompt, r.out_tokens])[None]
        lg, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(seq))
        p = len(r.prompt)
        rows = np.asarray(lg)[0, p - 1:p - 1 + len(r.out_tokens)]
        ref_gaps.append(float((rows.max(-1) - rows[np.arange(len(rows)),
                                                   r.out_tokens]).max()))
    assert max(ref_gaps) > 1e-3, ref_gaps


def test_solo_and_batched_tokens_equal():
    """Exact-length prefill-into-slot keeps the recurrent pattern batch
    invariant (tests/test_serving.py::test_recurrent_arch_serving)."""
    _, _, tcfg, model = _models()
    solo = [_serve(Engine, Request, tcfg, model, [p], 1, ctx=CPU)[0]
            for p in PROMPTS[:3]]
    batched = _serve(Engine, Request, tcfg, model, PROMPTS[:3], 2, ctx=CPU)
    for a, b in zip(solo, batched):
        np.testing.assert_array_equal(a.out_tokens, b.out_tokens)


# -- the kernel on the card --------------------------------------------------

@pytest.mark.cuda
def test_conv1d_kernel_on_the_card():
    """The kernel against its plain version on the card (runs only where
    there is a GPU; chip_smoke.py checks the main-path shapes): the CPU
    cases, L at one ring chunk and one row past it, more chunks than ring
    slots, K = 8 at a wide D, and row-strided views at an aligned base and
    1, 2 and 4 elements past it (the narrower copies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    before = KERNELS["conv1d_causal"].launches
    cases = CONV_CASES + [(2, 32, 64, 4), (2, 33, 64, 4), (1, 1000, 256, 4),
                          (1, 300, 4096, 8)]
    n = 0
    for dt in sorted(DTYPES):
        operands = [tuple(t.cuda() for t in _conv_inputs(*case, dt)[1])
                    for case in cases]
        (_, (xz, w)) = _conv_inputs(2, 100, 2 * 64 + 8, 4, dt)
        xz, w = xz.cuda(), w[:, :64].contiguous().cuda()
        operands += [(xz[..., off:off + 64], w) for off in (0, 1, 2, 4)]
        for tx, tw in operands:
            got = conv1d_causal(tx, tw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, conv1d_causal_plain(tx, tw),
                                       rtol=0, atol=0)
            n += 1
    assert KERNELS["conv1d_causal"].launches - before == n == \
        2 * (len(cases) + 4)
