"""repro_torch.models.moe against repro.models.moe, with the reference's
own parameters carried over by ``repro_torch.convert.params_from_jax`` and
the same numpy-seeded inputs: ``capacity``, ``moe_block``'s output, aux loss,
chosen experts and kept mask, the dense oracle, token dropping, and the
places where torch and JAX differ (top-k ties, one-hots past the last
class).

Tolerance: f32 compute to 1e-5 (both sides accumulate the expert products
in f32, in a different order); bf16 compute to tests/test_torch_models.py's
5e-2 (the expert products round to bf16). Chosen experts and kept masks are
equal exactly: the router runs in f32 on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro_torch.configs as tc
from repro.models import moe as JM
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig

ARCHS = ["olmoe_1b_7b", "phi3_5_moe_42b", "jamba_1_5_large"]
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


def _tiny(**kw):
    """tests/test_models.py's MoE configuration, in both packages."""
    base = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab_size=128, n_experts=4,
                experts_per_token=2, compute_dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _block(jcfg, tcfg, seed=0):
    """The reference's ``init_moe`` leaves and the port's ``MoE`` holding
    them."""
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    with torch.device("meta"):
        block = M.MoE(tcfg)
    block.load_state_dict(params_from_jax(jp, "cpu"), assign=True)
    return jp, block


def _x(shape, dtype, seed=1):
    x = 0.5 * np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _reference_routing(p, x, cfg, n_groups):
    """The reference's routing lines (``repro/models/moe.py:59-89``) for
    the chosen experts and the kept mask, which ``moe_block`` does not
    return."""
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * L
    G = n_groups if T % n_groups == 0 else 1
    Tg = T // G
    C = JM.capacity(cfg, Tg)
    xg = x.reshape(G, Tg, D)
    logits = jnp.einsum("gtd,de->gte", xg.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    kt = onehot.transpose(0, 2, 1, 3).reshape(G, K * Tg, E)
    pos_kt = jnp.cumsum(kt, axis=1) - kt
    pos = pos_kt.reshape(G, K, Tg, E).transpose(0, 2, 1, 3)
    kept = jnp.sum((pos < C).astype(jnp.float32) * onehot, axis=-1)
    return np.asarray(gate_idx), np.asarray(kept), C


@pytest.mark.parametrize("T", [1, 4, 7, 12, 208, 1000])
@pytest.mark.parametrize("E,K", [(4, 2), (16, 2), (64, 8)])
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 8.0])
def test_capacity_equal_reference(T, E, K, cf):
    jcfg, tcfg = _tiny(n_experts=E, experts_per_token=K, capacity_factor=cf)
    assert M.capacity(tcfg, T) == JM.capacity(jcfg, T)
    assert M.capacity(tcfg, T) % 4 == 0 and M.capacity(tcfg, T) >= 4


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_equal_reference(arch, n_groups, dtype):
    """Output, aux loss, chosen experts and kept mask on the smoke config
    (E 4, top 2) at the published capacity factor 1.25, with 2 x 13 tokens
    in one group (capacity 16) or two (capacity 8: choices are dropped,
    asserted)."""
    jcfg = dataclasses.replace(jc.get_smoke(arch), compute_dtype=dtype)
    tcfg = dataclasses.replace(tc.get_smoke(arch), compute_dtype=dtype)
    jp, block = _block(jcfg, tcfg)
    jx, tx = _x((2, 13, jcfg.d_model), dtype)
    want, want_aux = JM.moe_block(jp, jx, jcfg, n_groups=n_groups)
    with torch.no_grad(), M.record_routing() as log:
        got, aux = M.moe_block(block, tx, tcfg, n_groups=n_groups)
    assert got.dtype == tx.dtype and aux.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    idx, kept, C = _reference_routing(jp, jx, jcfg, n_groups)
    (r,) = log
    assert r.capacity == C and r.gate_idx.shape == idx.shape
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    assert kept.min() == (0 if n_groups == 2 else 1)


def test_high_capacity_equals_dense_oracle():
    """tests/test_models.py's case: no token dropped at capacity 8, so the
    grouped block equals the dense oracle (both packages' oracles)."""
    jcfg, tcfg = _tiny(capacity_factor=8.0)
    jp, block = _block(jcfg, tcfg)
    jx, tx = _x((2, 12, 16), "float32")
    with torch.no_grad(), M.count_drops("cpu") as counts:
        out, aux = M.moe_block(block, tx, tcfg, n_groups=2)
        dense = M.moe_block_dense_ref(block, tx, tcfg)
    assert counts.tolist() == [0.0, 2 * 12 * 2]
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(JM.moe_block_dense_ref(jp, jx, jcfg)),
        rtol=1e-5, atol=1e-5)
    assert float(aux) > 0.9


def test_tight_capacity_drops_tokens():
    jcfg, tcfg = _tiny(capacity_factor=0.5)
    jp, block = _block(jcfg, tcfg)
    jx, tx = _x((2, 32, 16), "float32")
    with torch.no_grad(), M.count_drops("cpu") as counts:
        out, _ = M.moe_block(block, tx, tcfg)
        dense = M.moe_block_dense_ref(block, tx, tcfg)
    assert torch.isfinite(out).all()
    assert not np.allclose(out.numpy(), dense.numpy(), atol=1e-5)
    want, _ = JM.moe_block(jp, jx, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # 4 experts of capacity 16 take at most 64 of the 128 choices
    assert M.capacity(tcfg, 64) == 16 and counts.tolist() == [64.0, 128.0]


def test_router_ties_pick_the_reference_experts():
    """Duplicated router columns give exactly equal probabilities: the
    lower expert index wins the tie, as ``jax.lax.top_k`` orders it."""
    jcfg, tcfg = _tiny(n_experts=8, experts_per_token=3, capacity_factor=8.0)
    jp, block = _block(jcfg, tcfg)
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 1]
    router[:, 6] = router[:, 1]
    router[:, 7] = router[:, 2]
    jp = dict(jp, router=jnp.asarray(router))
    block.router = torch.nn.Parameter(torch.from_numpy(router))
    jx, tx = _x((3, 10, 16), "float32", seed=4)
    with torch.no_grad(), M.record_routing() as log:
        out, _ = M.moe_block(block, tx, tcfg)
    idx, kept, _ = _reference_routing(jp, jx, jcfg, 1)
    got = log[0].gate_idx.numpy()
    np.testing.assert_array_equal(got, idx)
    assert np.isin(got, [5, 6, 7]).sum() < np.isin(got, [1, 2]).sum()
    want, _ = JM.moe_block(jp, jx, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # top_k itself on rows of many ties
    probs = np.random.default_rng(5).integers(0, 3, (64, 16)).astype(
        np.float32)
    vals, ix = M.top_k(torch.from_numpy(probs), 5)
    jvals, jix = jax.lax.top_k(jnp.asarray(probs), 5)
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jix))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def test_overflow_position_gives_a_zero_one_hot_row():
    pos = np.array([[0, 3, 4], [7, 2, -1]], np.int64)
    got = M._one_hot(torch.from_numpy(pos), 4)
    want = jax.nn.one_hot(jnp.asarray(pos), 4, dtype=jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 2].sum() == 0 and got[1, 0].sum() == 0


def test_leaves_and_init():
    """The reference's leaf shapes and dtypes (router f32 whatever the
    parameter dtype), and the reference's std."""
    jcfg, tcfg = _tiny(param_dtype="bfloat16", d_model=256, d_ff=512)
    jp = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    block = M.MoE(tcfg, generator=gen)
    for name, leaf in block.state_dict().items():
        want = np.asarray(jp[name])
        assert tuple(leaf.shape) == want.shape
        assert str(leaf.dtype)[6:] == str(want.dtype)
        np.testing.assert_allclose(float(leaf.float().std()),
                                   float(want.astype(np.float32).std()),
                                   rtol=0.05)


def test_given_choices_route_there():
    """``choices`` (the port's own argument, for checks that route a second
    run as a first): the recorded top-k gives the default output bit for
    bit; other experts give the dense evaluation of those experts, gated
    by the router's renormalized probabilities there; a forward threads
    one choice tensor to each MoE layer."""
    _, tcfg = _tiny(n_experts=6, experts_per_token=2, capacity_factor=8.0)
    _, block = _block(*_tiny(n_experts=6, experts_per_token=2,
                             capacity_factor=8.0))
    _, tx = _x((2, 9, 16), "float32", seed=6)
    with torch.no_grad(), M.record_routing() as log:
        free, _ = M.moe_block(block, tx, tcfg, n_groups=2)
        again, _ = M.moe_block(block, tx, tcfg, n_groups=2,
                               choices=log[0].gate_idx)
        other = (log[0].gate_idx + 1) % 6
        moved, _ = M.moe_block(block, tx, tcfg, n_groups=2, choices=other)
    torch.testing.assert_close(again, free, rtol=0, atol=0)
    assert torch.equal(log[2].gate_idx, other)
    probs = log[0].probs.reshape(18, 6)
    idx = other.reshape(18, 2)
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True)
    xf = tx.reshape(18, 16)
    want = torch.zeros_like(xf)
    for t in range(18):
        for k in range(2):
            e = int(idx[t, k])
            h = torch.nn.functional.silu(xf[t] @ block.w_gate[e]) * (
                xf[t] @ block.w_up[e])
            want[t] += gates[t, k] * (h @ block.w_down[e])
    torch.testing.assert_close(moved.reshape(18, 16), want, rtol=1e-5,
                               atol=1e-5)

    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext

    cpu = ExecutionContext(device="cpu")
    cfg = tc.get_smoke("olmoe_1b_7b")
    model = T.init_params(cfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 10)))
    with torch.no_grad(), M.record_routing() as log:
        a, _, _ = T.forward(model, cfg, tokens=toks, ctx=cpu)
        b, _, _ = T.forward(model, cfg, tokens=toks, ctx=cpu,
                            expert_choices=[r.gate_idx for r in log])
    assert len(log) == 2 * cfg.n_layers
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for r, s in zip(log[:cfg.n_layers], log[cfg.n_layers:]):
        assert torch.equal(r.gate_idx, s.gate_idx)
