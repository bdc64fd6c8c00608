"""repro_torch's xLSTM slice against repro's: ``scan_util.scan``, the mLSTM
and sLSTM blocks (prefill with and without a state, decode steps, the
sequential oracle), the smoke model (logits, prefill + decode from the
cache, bf16 weights at rest), the contiguous engine serving it and the
serving CLI. Inputs are made with numpy from fixed seeds; the reference's
parameters are carried over leaf by leaf, and the gate biases are drawn
non-zero where a test says so (the reference initializes them to zero).

Tolerances, all with compute_dtype float32 on both sides:
  * blocks and decode steps: max |port - ref| <= 1e-5 * max(1, max |ref|),
    states the same. Both accumulate in f32; the sLSTM prefix scan (a
    Hillis-Steele doubling in the port, XLA's associative-scan tree in the
    reference) and the mLSTM ``den`` (a sum over u in the port, an einsum
    against ones in the reference) round in another order;
  * the model's logits, prefill + decode and the cache leaves: 1e-4 (as
    tests/test_torch_models.py holds the dense models);
  * greedy tokens: equal token for token;
  * bf16 compute: the port with bf16 weights at rest
    (``transformer.compute_params``) is bit-equal to the port casting f32
    weights at use, and within 5e-2 of the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro_torch.configs as tc
from repro.models import scan_util as jscan
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro_torch import ops as tops
from repro_torch.convert import params_from_jax, transformer_from_jax
from repro_torch.models import scan_util
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.serving import Engine, Request

ARCH = "xlstm_1_3b"
CPU = tops.ExecutionContext(device="cpu")  # cuda backend: plain versions
TORCH = tops.ExecutionContext(backend="torch", device="cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _block_close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _cfgs(compute_dtype="float32", chunk_size=None):
    """The smoke config in both packages (chunk 16, or ``chunk_size``)."""
    kw = dict(compute_dtype=compute_dtype)
    if chunk_size:
        kw["chunk_size"] = chunk_size
    jcfg = dataclasses.replace(jc.get_smoke(ARCH), **kw)
    tcfg = dataclasses.replace(tc.get_smoke(ARCH), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _biased(tree, seed):
    """``tree`` with its ``b_if``/``b_zifo`` leaves drawn N(0, 1)."""
    rng = np.random.default_rng(seed)
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rng.standard_normal(v.shape), v.dtype)
                    if k in ("b_if", "b_zifo") else _biased(v, seed + 1))
                for k, v in tree.items()}
    return tree


def _block(kind, cfgs, seed=1):
    """The reference's parameters of one ``kind`` block (non-zero biases)
    and the port's module holding them."""
    jcfg, tcfg = cfgs
    init = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    jp_ = _biased(init(jax.random.PRNGKey(seed), jcfg), seed)
    with torch.device("meta"):
        mod = (X.MLSTM if kind == "mlstm" else X.SLSTM)(tcfg)
    mod.load_state_dict(params_from_jax(jp_, "cpu"), assign=True)
    return jp_, mod


def _x(B, L, D, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (B, L, D)).astype(np.float32)


def _state(kind, cfg, B, seed):
    """A random state of a ``kind`` block: (numpy, numpy)."""
    rng = np.random.default_rng(seed)
    H, hd, D = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_model
    shapes = ((B, H, hd, hd), (B, H, hd)) if kind == "mlstm" else \
        ((B, D), (B, D))
    return tuple((0.5 * rng.standard_normal(s)).astype(np.float32)
                 for s in shapes)


FNS = {"mlstm": (JX.mlstm_block, JX.mlstm_decode_step, X.mlstm_block,
                 X.mlstm_decode_step),
       "slstm": (JX.slstm_block, JX.slstm_decode_step, X.slstm_block,
                 X.slstm_decode_step)}


# -- the config --------------------------------------------------------------

def test_config_is_the_reference_and_ported():
    assert ARCH in tc.ARCH_IDS and tc.NOT_PORTED == {}
    for get in ("get_config", "get_smoke"):
        assert dataclasses.asdict(getattr(tc, get)(ARCH)) == \
            dataclasses.asdict(getattr(jc, get)(ARCH))
    cfg = tc.get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.repeats,
            cfg.d_model // cfg.n_heads) == (48, 2048, 4, 24, 512)
    with torch.device("meta"):
        model = T.Transformer(cfg)
    unit = model.layers[0]
    assert isinstance(unit["b0"].core, X.MLSTM)
    assert isinstance(unit["b1"].core, X.SLSTM)
    assert not hasattr(unit["b0"], "ffn") and not hasattr(unit["b1"], "ffn")


def test_param_count_keeps_the_reference_fault():
    """``param_count`` counts the mLSTM projections at d_inner = 2D (the
    reference's formula, kept); both packages build (D, D) projections."""
    cfg, jcfg = tc.get_config(ARCH), jc.get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count() == 1_715_994_624
    with torch.device("meta"):
        model = T.Transformer(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert n == 1_113_229_504
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    assert sum(a.size for a in jax.tree.leaves(shapes)) == n


# -- scan_util ---------------------------------------------------------------

def test_scan_keeps_lax_scan_contract():
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((5, 3)).astype(np.float32),
          rng.standard_normal((5, 2, 3)).astype(np.float32))
    init = (np.zeros(3, np.float32), np.float32(1.0))

    def step(lib):
        def f(carry, x):
            s, p = carry
            a, b = x
            s = s + a * p + b.sum(0)
            return (s, p * 0.5), (s * 2, (a - s, None))
        return f

    jc_, jys = jscan.scan(step(jnp), tuple(map(jnp.asarray, init)),
                          tuple(map(jnp.asarray, xs)))
    tc_, tys = scan_util.scan(step(torch), tuple(map(torch.as_tensor, init)),
                              tuple(map(torch.from_numpy, xs)))
    for got, want in zip((tc_[0], tc_[1], tys[0], tys[1][0]),
                         (jc_[0], jc_[1], jys[0], jys[1][0])):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    assert tys[0].shape == (5, 3) and tys[1][1] is None
    carry, ys = scan_util.scan(lambda c, _: (c + 1, c), torch.tensor(0),
                               None, length=4)
    assert int(carry) == 4 and ys.tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="length"):
        scan_util.scan(lambda c, x: (c, x), 0, None)


# -- the blocks --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("L", [21, 16, 5, 1])
@pytest.mark.parametrize("with_state", [False, True])
def test_block_equals_reference(kind, L, with_state):
    """Prefill at chunk 8 (L = 21: three chunks, the last ragged), from no
    state or a random one (the sLSTM carry as the virtual step -1); output
    and new state against the reference's."""
    jcfg, tcfg = cfgs = _cfgs(chunk_size=8)
    jp_, mod = _block(kind, cfgs)
    jblock, _, tblock, _ = FNS[kind]
    x = _x(2, L, jcfg.d_model)
    st = _state(kind, jcfg, 2, seed=7) if with_state else None
    want, wst = jblock(jp_, jnp.asarray(x), jcfg,
                       None if st is None else tuple(map(jnp.asarray, st)))
    with torch.no_grad():
        got, gst = tblock(mod, torch.from_numpy(x), tcfg,
                          None if st is None
                          else tuple(map(torch.from_numpy, st)), ctx=CPU)
    _block_close(got, want)
    assert (gst is None) == (wst is None) == (st is None)
    for a, b in zip(gst or (), wst or ()):
        assert a.dtype == torch.float32
        _block_close(a, b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_equal_reference(kind):
    """A prefill of 11 into a zero state, then four decode steps."""
    jcfg, tcfg = cfgs = _cfgs(chunk_size=8)
    jp_, mod = _block(kind, cfgs, seed=2)
    jblock, jstep, tblock, tstep = FNS[kind]
    init = X.init_mlstm_state if kind == "mlstm" else X.init_slstm_state
    jinit = JX.init_mlstm_state if kind == "mlstm" else JX.init_slstm_state
    tstate = init(tcfg, 2, device="cpu")
    jstate = jinit(jcfg, 2)
    for a, b in zip(tstate, jstate):
        assert a.shape == b.shape and a.dtype == torch.float32
    x = _x(2, 11, jcfg.d_model, seed=5)
    _, jstate = jblock(jp_, jnp.asarray(x), jcfg, jstate)
    with torch.no_grad():
        _, tstate = tblock(mod, torch.from_numpy(x), tcfg, tstate)
    for step in range(4):
        xt = _x(2, 1, jcfg.d_model, seed=20 + step)
        want, jstate = jstep(jp_, jnp.asarray(xt), jcfg, jstate)
        with torch.no_grad():
            got, tstate = tstep(mod, torch.from_numpy(xt), tcfg, tstate,
                                ctx=CPU)
        _block_close(got, want)
        for a, b in zip(tstate, jstate):
            _block_close(a, b)


@pytest.mark.parametrize("L", [21, 8])
def test_mlstm_oracle_equals_reference_and_the_chunked_block(L):
    jcfg, tcfg = cfgs = _cfgs(chunk_size=8)
    jp_, mod = _block("mlstm", cfgs, seed=3)
    x = _x(2, L, jcfg.d_model, seed=6)
    want = JX.mlstm_block_ref(jp_, jnp.asarray(x), jcfg)
    with torch.no_grad():
        seq = X.mlstm_block_ref(mod, torch.from_numpy(x), tcfg)
        chunked, _ = X.mlstm_block(mod, torch.from_numpy(x), tcfg)
    _block_close(seq, want)
    _block_close(chunked, seq)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_carried_state_equals_the_whole_sequence(kind):
    """A prefill of 13 + 8 from the carried state equals one of 21 (the
    mLSTM's chunks fall elsewhere), and the sLSTM prefix scan equals its
    decode steps one position at a time."""
    _, tcfg = cfgs = _cfgs(chunk_size=8)
    _, mod = _block(kind, cfgs, seed=4)
    _, _, tblock, tstep = FNS[kind]
    init = X.init_mlstm_state if kind == "mlstm" else X.init_slstm_state
    x = torch.from_numpy(_x(2, 21, tcfg.d_model, seed=8))
    with torch.no_grad():
        whole, sw = tblock(mod, x, tcfg, init(tcfg, 2, device="cpu"))
        a, s1 = tblock(mod, x[:, :13], tcfg, init(tcfg, 2, device="cpu"))
        b, s2 = tblock(mod, x[:, 13:], tcfg, s1)
        _block_close(torch.cat([a, b], dim=1), whole)
        for u, v in zip(s2, sw):
            _block_close(u, v)
        if kind == "slstm":
            st, outs = init(tcfg, 2, device="cpu"), []
            for t in range(21):
                o, st = tstep(mod, x[:, t:t + 1], tcfg, st)
                outs.append(o)
            _block_close(torch.cat(outs, dim=1), whole)


def test_chunk_padding_keeps_the_state_at_L():
    """Padded steps have f = i = 1 and k = v = 0: the state after a ragged
    last chunk is the state at L (against the sequential recurrence)."""
    _, tcfg = cfgs = _cfgs(chunk_size=8)
    _, mod = _block("mlstm", cfgs, seed=5)
    x = torch.from_numpy(_x(1, 19, tcfg.d_model, seed=9))
    with torch.no_grad():
        _, (C, n) = X.mlstm_block(mod, x, tcfg,
                                  X.init_mlstm_state(tcfg, 1, device="cpu"))
        st = X.init_mlstm_state(tcfg, 1, device="cpu")
        for t in range(19):
            _, st = X.mlstm_decode_step(mod, x[:, t:t + 1], tcfg, st)
    _block_close(C, st[0])
    _block_close(n, st[1])


# -- the model ---------------------------------------------------------------

def _models(compute_dtype="float32", biased=True):
    jcfg, tcfg = _cfgs(compute_dtype)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    if biased:
        jparams = _biased(jparams, 11)
    return jcfg, jparams, tcfg, transformer_from_jax(jparams, tcfg, "cpu")


def _tokens(cfg, B, L, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, L)).astype(np.int32)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_forward_no_cache_equal_reference(backend):
    """The smoke model (chunk 16) over 37 tokens: three chunks, the last
    ragged. No block dispatches an op."""
    jcfg, jparams, tcfg, model = _models()
    toks = _tokens(jcfg, 2, 37)
    want, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    with torch.no_grad(), tops.record_dispatch() as log:
        got, cache, aux = T.forward(model, tcfg,
                                    tokens=torch.from_numpy(toks),
                                    ctx=CPU if backend == "cuda" else TORCH)
    assert cache is None and float(aux) == 0.0 and not log
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_bf16_weights_at_rest_keep_the_biases_f32():
    """``compute_params`` leaves ``b_if``/``b_zifo`` in f32, as the
    reference adds them: its forward equals the f32 weights cast at use bit
    for bit, and the reference's within bf16's tolerance."""
    jcfg, jparams, tcfg, model = _models("bfloat16")
    cp = T.compute_params(model, tcfg)
    dtypes = {n.rsplit(".", 1)[-1]: t.dtype
              for n, t in cp.state_dict().items()}
    assert dtypes["b_if"] == dtypes["b_zifo"] == torch.float32
    assert dtypes["wq"] == dtypes["w_zifo"] == torch.bfloat16
    assert float(model.layers[0]["b0"].core.b_if.detach().abs().max()) > 0.5
    toks = _tokens(jcfg, 2, 19, seed=1)
    with torch.no_grad():
        got, _, _ = T.forward(cp, tcfg, tokens=torch.from_numpy(toks),
                              ctx=CPU)
        cast, _, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                               ctx=CPU)
    assert torch.equal(got, cast)
    want, _, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=5e-2, atol=5e-2)


def test_prefill_then_decode_equal_reference():
    """Prefill (3 rows at one depth) into the cache, then two decode steps
    with every row at its own depth: logits and every cache leaf."""
    jcfg, jparams, tcfg, model = _models()
    B, L, Lmax = 3, 21, 32
    toks = _tokens(jcfg, B, L, seed=2)
    jcache = JT.init_cache(jcfg, B, Lmax, dtype=jnp.float32)
    tcache = T.init_cache(tcfg, B, Lmax, dtype=torch.float32, device="cpu")
    assert {u: {n: tuple(t.shape) for n, t in lv.items()}
            for u, lv in tcache.items()} == \
        {u: {n: tuple(t.shape) for n, t in lv.items()}
         for u, lv in jcache.items()}
    want, jcache, _ = JT.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                                 cache=jcache,
                                 cache_index=jnp.zeros((), jnp.int32))
    with torch.no_grad():
        got, tcache, _ = T.forward(model, tcfg, tokens=torch.from_numpy(toks),
                                   cache=tcache, cache_index=0, ctx=CPU)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    idx = np.array([21, 19, 20], np.int32)
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


def test_prefill_and_decode_equal_the_full_forward():
    """Prefill 16 tokens, then decode 8 one at a time from the cache: the
    logits are the cache-less forward's over all 24."""
    _, _, tcfg, model = _models()
    toks = torch.from_numpy(_tokens(tcfg, 2, 24, seed=3))
    with torch.no_grad():
        full, _, _ = T.forward(model, tcfg, tokens=toks, ctx=CPU)
        cache = T.init_cache(tcfg, 2, 24, dtype=torch.float32, device="cpu")
        lg, cache, _ = T.forward(model, tcfg, tokens=toks[:, :16],
                                 cache=cache, cache_index=0, ctx=CPU)
        outs = [lg]
        for t in range(16, 24):
            lg, cache, _ = T.forward(model, tcfg, tokens=toks[:, t:t + 1],
                                     cache=cache, cache_index=t, ctx=CPU,
                                     decode=True)
            outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               **TOL)


def test_cache_helpers_and_paged_rule_equal_reference():
    jcfg, tcfg = _cfgs()
    for max_len in (16, 512):
        assert T.cache_footprint_words(tcfg, max_len) == \
            JT.cache_footprint_words(jcfg, max_len)
    assert T.cache_footprint_words(tc.get_config(ARCH), 512) == \
        JT.cache_footprint_words(jc.get_config(ARCH), 512)
    with pytest.raises(ValueError, match="pure-attention"):
        T.init_paged_cache(tcfg, 8, 4, device="cpu")
    _, _, _, model = _models()
    with pytest.raises(ValueError, match="pure-attention"):
        Engine(tcfg, model, max_len=32, batch_size=2, ctx=CPU, paged=True)
    pool = T.init_cache(tcfg, 3, 8, device="cpu")
    row = T.init_cache(tcfg, 1, 8, device="cpu")
    for leaves in row.values():
        for t in leaves.values():
            t.fill_(2.0)
    T.insert_cache_slot(pool, row, 1)
    for leaves in pool.values():
        for t in leaves.values():
            assert torch.all(t[:, 1] == 2.0) and torch.all(t[:, 0] == 0)
    T.reset_cache_slot(pool, 1)
    assert all(torch.all(t == 0) for lv in pool.values() for t in lv.values())


# -- serving -----------------------------------------------------------------

PROMPTS = [np.array(p, np.int32) for p in
           ([1, 2, 3], [9, 8], [5], [4, 7, 1, 9, 2], list(range(3, 23)),
            [11, 12, 13, 14])]


def _serve(engine_cls, req_cls, cfg, params, prompts, batch, **kw):
    reqs = [req_cls(prompt=p, max_new_tokens=5) for p in prompts]
    engine_cls(cfg, params, max_len=48, batch_size=batch, **kw).serve(reqs)
    return reqs


def test_engine_greedy_tokens_equal_reference():
    """Six requests over three slots, admitted mid-flight: the contiguous
    cache, exact-length prefill, every token the reference engine's."""
    jcfg, jparams, tcfg, model = _models()
    want = _serve(JEngine, JRequest, jcfg, jparams, PROMPTS, 3)
    eng = Engine(tcfg, model, max_len=48, batch_size=3, ctx=CPU)
    assert not eng.paged and eng.prefill_bucket == 1
    got = [Request(prompt=p, max_new_tokens=5) for p in PROMPTS]
    eng.serve(got)
    for a, b in zip(want, got):
        assert b.finish_reason == a.finish_reason == "length"
        np.testing.assert_array_equal(b.out_tokens, a.out_tokens)


def test_recurrent_serving_is_batch_invariant():
    """The reference's tests/test_serving.py::test_recurrent_arch_serving:
    a request decoded alone and beside another gives the same tokens, in
    both packages, and the port's equal the reference's."""
    jcfg, jparams, tcfg, model = _models()
    out = {}
    for name, (eng_cls, req_cls, cfg, params, kw) in {
            "ref": (JEngine, JRequest, jcfg, jparams, {}),
            "port": (Engine, Request, tcfg, model, dict(ctx=CPU))}.items():
        solo = req_cls(prompt=np.array([1, 2, 3], np.int32),
                       max_new_tokens=4)
        eng_cls(cfg, params, max_len=32, batch_size=1, **kw).serve([solo])
        reqs = [req_cls(prompt=np.array([1, 2, 3], np.int32),
                        max_new_tokens=4),
                req_cls(prompt=np.array([9, 8], np.int32), max_new_tokens=4)]
        eng_cls(cfg, params, max_len=32, batch_size=2, **kw).serve(reqs)
        assert all(len(r.out_tokens) == 4 for r in reqs)
        np.testing.assert_array_equal(solo.out_tokens, reqs[0].out_tokens)
        out[name] = [r.out_tokens for r in reqs]
    for a, b in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(a, b)


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve

    reqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "8",
                       "--max-new", "4"])
    assert [r.finish_reason for r in reqs] == ["length"] * 3
    assert "served 3 requests on cpu (batch=4, paged=False)" in \
        capsys.readouterr().out
    with pytest.raises(ValueError, match="pure-attention"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "1", "--paged", "on"])
