"""repro_torch's training slice against repro's on the CPU: the data
pipeline, AdamW, the losses, one training step per smoke config, a loss
curve, checkpoints in both directions, the launcher and serving from a
checkpoint. Both packages get the same numpy inputs; weights come from the
reference's ``init_params`` through ``convert.transformer_from_jax``.

Tolerances (f32 compute everywhere; both sides accumulate in f32, in a
different order):
  * batches, checkpoint arrays and quantized gradients: bit-equal;
  * ``schedule``: 1e-6 relative (the reference computes it in f32, the port
    in float64);
  * one ``apply_updates`` on equal gradients: 1e-6 absolute on parameters
    and moments;
  * losses: 1e-5 absolute;
  * a train step: loss and grad norm 1e-4 relative, each leaf's gradient
    within 1e-4 of that leaf's max |g|;
  * a 24-step loss curve: 1e-3 absolute per step.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro_torch.configs as tc
from repro.data import pipeline as JD
from repro.models import transformer as JT
from repro.train import checkpoint as JCK
from repro.train import optimizer as JO
from repro.train import trainer as JTR
from repro_torch import convert
from repro_torch.data import pipeline as TD
from repro_torch.models import transformer as T
from repro_torch.ops import ExecutionContext
from repro_torch.resilience.errors import DeviceLost
from repro_torch.train import checkpoint as TCK
from repro_torch.train import optimizer as TO
from repro_torch.train import trainer as TTR

CPU = ExecutionContext(backend="cuda", device="cpu")
B, L = 2, 32  # the reference's tests/test_models.py _batch shapes


def _cfgs(arch, compute_dtype="float32"):
    return (dataclasses.replace(jc.get_smoke(arch), compute_dtype=compute_dtype),
            dataclasses.replace(tc.get_smoke(arch), compute_dtype=compute_dtype))


def _models(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jparams, tcfg, convert.transformer_from_jax(jparams, tcfg,
                                                             "cpu")


def _batch(cfg, seed=0):
    """The reference's ``_batch`` shapes from numpy: tokens, or stub
    embeddings 0.1 N(0, 1) with tokens (causal) or labels (the encoder)."""
    rng = np.random.default_rng(seed)
    if not cfg.inputs_are_embeddings:
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, L)).astype(
            np.int32)}
    b = {"embeds": (0.1 * rng.standard_normal((B, L, cfg.d_model))).astype(
        np.float32)}
    key = "tokens" if cfg.causal else "labels"
    b[key] = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    return b


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _random_tree(tree, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(
        np.float32), tree)


# -- the data pipeline ------------------------------------------------------

@pytest.mark.parametrize("seed,step,shard,count", [
    (0, 0, 0, 1), (7, 3, 1, 2), (3, 11, 2, 4), (1, 1000, 0, 8)])
def test_synthetic_batches_are_the_reference(seed, step, shard, count):
    cfg = dict(batch_size=4, seq_len=33, vocab_size=257, seed=seed,
               shard_index=shard, shard_count=count)
    want = JD.SyntheticSource(JD.DataConfig(**cfg)).batch(step)
    got = TD.SyntheticSource(TD.DataConfig(**cfg)).batch(step)
    assert got.keys() == want.keys()
    assert got["tokens"].dtype == want["tokens"].dtype
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_file_source_and_iterate_are_the_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    (np.arange(5000, dtype=np.uint32) * 7 % 101).tofile(path)
    cfg = dict(batch_size=2, seq_len=16, vocab_size=101, path=path,
               shard_index=1, shard_count=2)
    jit, tit = (JD.iterate(JD.DataConfig(**cfg), 3),
                TD.iterate(TD.DataConfig(**cfg), 3))
    for _ in range(4):
        np.testing.assert_array_equal(next(tit)["tokens"],
                                      next(jit)["tokens"])
    assert isinstance(TD.make_source(TD.DataConfig(**cfg)), TD.FileSource)


# -- AdamW ------------------------------------------------------------------

def test_schedule_is_the_reference():
    for cfg in (dict(lr=1.0, warmup_steps=10, total_steps=110),
                dict(lr=3e-4, warmup_steps=0, total_steps=7),
                dict(lr=1e-3, warmup_steps=5, total_steps=3)):
        jcfg, tcfg = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
        for step in range(0, 130, 3):
            want = float(JO.schedule(jcfg, jnp.asarray(step)))
            assert TO.schedule(tcfg, step) == pytest.approx(want, rel=1e-6,
                                                            abs=1e-12)


def _one_update(arch, weight_decay, steps=2):
    """``steps`` AdamW steps with the same random gradients in both
    packages; returns the reference's (params, state) and the port's as
    reference trees."""
    jcfg, jparams, tcfg, model = _models(arch)
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10,
               weight_decay=weight_decay, clip_norm=5.0)
    initial = _np(jparams)
    jstate = JO.init_state(jparams)
    tstate = TO.init_state(model)
    update = jax.jit(JO.apply_updates, static_argnums=3)
    for s in range(steps):
        grads = _random_tree(jparams, 10 + s, 0.3)
        jparams, jstate, jm = update(jparams, grads, jstate,
                                     JO.AdamWConfig(**cfg))
        tgrads = convert.named_from_tree(grads, tcfg, "cpu")
        model, tstate, tm = TO.apply_updates(model, tgrads, tstate,
                                             TO.AdamWConfig(**cfg))
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                       rel=1e-6)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tstate.step) == int(jstate.step) == steps
    port = {"params": convert.transformer_to_jax(model),
            "m": convert.transformer_to_jax(model, tstate.m),
            "v": convert.transformer_to_jax(model, tstate.v)}
    ref = {"params": _np(jparams), "m": _np(jstate.m), "v": _np(jstate.v)}
    return ref, port, cfg, initial


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "qwen2_5_3b"])
def test_apply_updates_is_the_reference_without_decay(arch):
    ref, port, _, _ = _one_update(arch, 0.0)
    for part in ("params", "m", "v"):
        for (path, want), got in zip(
                jax.tree_util.tree_flatten_with_path(ref[part])[0],
                jax.tree.leaves(port[part])):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=f"{part} {path}")


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "jamba_1_5_large",
                                  "xlstm_1_3b"])
def test_weight_decay_differs_on_exactly_the_stacked_vectors(arch):
    """The reference decays ``p.ndim >= 2``, and its ``layers`` leaves are
    stacked (repeats, ...): a per-layer norm scale, bias, ``D_skip`` or
    xLSTM gate bias (``b_if``, ``b_zifo``) is (repeats, D) and decays there,
    not in the port (ROADMAP queue 3, known reference faults). Every other leaf is equal; on those the reference's
    parameter is the port's less lr * wd * p (p before the step, one step)."""
    ref, port, cfg, initial = _one_update(arch, 0.1, steps=1)
    before = jax.tree_util.tree_flatten_with_path(initial)[0]
    lr = TO.schedule(TO.AdamWConfig(**cfg), 1)
    differ = []
    for (path, want), got, (_, p0) in zip(
            jax.tree_util.tree_flatten_with_path(ref["params"])[0],
            jax.tree.leaves(port["params"]), before):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        stacked_vector = name.startswith("layers/") and p0.ndim == 2
        if stacked_vector:
            differ.append(name.rsplit("/", 1)[-1])
            np.testing.assert_allclose(got - want, lr * cfg["weight_decay"]
                                       * p0, rtol=1e-4, atol=1e-7,
                                       err_msg=name)
            assert np.abs(got - want).max() > 0
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=name)
    assert "norm1" in differ
    assert set(differ) - {"norm1", "norm2"} == {
        "qwen2_5_3b": {"bq", "bk", "bv"},
        "jamba_1_5_large": {"b_dt", "log_A", "D_skip"},
        "xlstm_1_3b": {"b_if", "b_zifo"}}[arch]


def test_quantize_int8_takes_one_scale_per_reference_leaf():
    jcfg, jparams, tcfg, _ = _models("stablelm_1_6b")
    grads = _random_tree(jparams, 3)
    # one repeat's wq far larger than the other's: a per-repeat scale would
    # quantize the small one finely, the reference's stacked scale does not
    grads["layers"]["b0"]["core"]["wq"][1] *= 100.0
    want = _np(JTR.quantize_int8(jax.tree.map(jnp.asarray, grads)))
    got = TTR.quantize_int8(convert.named_from_tree(grads, tcfg, "cpu"))
    got = convert._numpy_tree(convert.tree_from_named(got))
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(g, w)
    assert TTR.reference_leaf("layers.1.b0.core.wq") == "layers.b0.core.wq"


# -- the losses ---------------------------------------------------------------

def test_token_and_classification_losses_are_the_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 17, 40)).astype(np.float32) * 3
    tokens = rng.integers(0, 40, (3, 17)).astype(np.int32)
    want = float(JT.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens)))
    got = float(T.next_token_loss(torch.from_numpy(logits),
                                  torch.from_numpy(tokens)))
    assert got == pytest.approx(want, abs=1e-5)
    want = float(JT.classification_loss(jnp.asarray(logits),
                                        jnp.asarray(tokens)))
    got = float(T.classification_loss(torch.from_numpy(logits),
                                      torch.from_numpy(tokens)))
    assert got == pytest.approx(want, abs=1e-5)


@pytest.mark.parametrize("n_chunks", [1, 4, 5])
def test_chunked_loss_is_the_reference_and_the_dense_loss(n_chunks):
    """Chunked cross entropy (5 chunks leave a padded tail) against the
    reference's and against the port's dense loss, value and gradient."""
    jcfg, jparams, tcfg, model = _models("qwen2_5_3b")
    toks = _batch(jcfg, 5)["tokens"]
    jx, _, _ = JT.hidden_forward(jparams, jcfg, tokens=jnp.asarray(toks))
    want = float(JT.chunked_next_token_loss(jparams, jcfg, jx,
                                            jnp.asarray(toks), n_chunks))
    x, _, _ = T.hidden_forward(model, tcfg, tokens=torch.from_numpy(toks),
                               ctx=CPU)
    got = T.chunked_next_token_loss(model, tcfg, x, torch.from_numpy(toks),
                                    n_chunks)
    assert float(got) == pytest.approx(want, abs=1e-5)
    dense = T.next_token_loss(T.lm_logits(model.head, x, torch.float32),
                              torch.from_numpy(toks))
    assert float(got) == pytest.approx(float(dense), abs=1e-5)
    g_chunk = torch.autograd.grad(got, model.head, retain_graph=True)[0]
    g_dense = torch.autograd.grad(dense, model.head)[0]
    torch.testing.assert_close(g_chunk, g_dense, rtol=0, atol=1e-6)


def test_loss_fn_chunks_and_aux_are_the_reference():
    """``loss_fn`` with ``loss_chunks=4`` against the dense one and the
    reference's, and with the MoE aux term (``aux_weight``)."""
    for arch, kw in (("stablelm_1_6b", dict(loss_chunks=4)),
                     ("olmoe_1b_7b", dict(aux_weight=0.5))):
        jcfg, jparams, tcfg, model = _models(arch)
        nb = _batch(jcfg, 6)
        jtot, (jl, jaux) = JT.loss_fn(
            jparams, jcfg, {k: jnp.asarray(v) for k, v in nb.items()}, **kw)
        ttot, (tl, taux) = T.loss_fn(
            model, tcfg, {k: torch.from_numpy(v) for k, v in nb.items()},
            ctx=CPU, **kw)
        for got, want in ((ttot, jtot), (tl, jl), (taux, jaux)):
            assert float(got) == pytest.approx(float(want), abs=1e-5)
        if arch == "olmoe_1b_7b":
            assert float(taux) > 0
        else:
            dense, _ = T.loss_fn(model, tcfg, {"tokens": torch.from_numpy(
                nb["tokens"])}, ctx=CPU)
            assert float(ttot) == pytest.approx(float(dense), abs=1e-5)
    # act_spec constrains DTensor activations on a mesh; on one device's
    # plain tensors it changes nothing
    from repro_torch.models.sharding import P
    tb = {"tokens": torch.from_numpy(nb["tokens"])}
    plain, _ = T.loss_fn(model, tcfg, tb, ctx=CPU)
    constrained, _ = T.loss_fn(model, tcfg, tb, ctx=CPU,
                               act_spec=P("data", "model", None))
    assert float(constrained) == float(plain)


# -- one training step a smoke config ----------------------------------------

def _step_both(arch, monkeypatch, ref_kw=None, port_kw=None, nb=None):
    """One reference step (jitted; its gradients returned through the
    metrics) and one port step (its gradients caught at
    ``apply_updates``) on the same weights and batch (``_batch``'s by
    default)."""
    jcfg, jparams, tcfg, model = _models(arch)
    nb = _batch(jcfg) if nb is None else nb
    orig_j = JTR.apply_updates

    def catch_j(p, g, s, c):
        p2, s2, m = orig_j(p, g, s, c)
        return p2, s2, dict(m, grads=g)

    monkeypatch.setattr(JTR, "apply_updates", catch_j)
    ocfg = dict(lr=1e-3)
    jstep = jax.jit(JTR.make_train_step(jcfg, JO.AdamWConfig(**ocfg),
                                        JTR.TrainConfig(**(ref_kw or {}))))
    _, _, jm = jstep(jparams, JO.init_state(jparams),
                     {k: jnp.asarray(v) for k, v in nb.items()})
    caught = {}
    orig_t = TTR.apply_updates

    def catch_t(p, g, s, c):
        caught["g"] = {n: t.clone() for n, t in g.items()}
        return orig_t(p, g, s, c)

    monkeypatch.setattr(TTR, "apply_updates", catch_t)
    tstep = TTR.make_train_step(tcfg, TO.AdamWConfig(**ocfg),
                                TTR.TrainConfig(ctx=CPU, **(port_kw or {})))
    model, state, tm = tstep(model, TO.init_state(model),
                             {k: torch.from_numpy(v) for k, v in nb.items()})
    assert int(state.step) == 1
    jg = convert.named_from_tree(_np(jm["grads"]), tcfg, "cpu")
    return jm, tm, jg, caught["g"]


def _assert_step_close(jm, tm, jg, tg):
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-4)
    assert tg.keys() == jg.keys()
    for n, g in tg.items():
        scale = max(float(jg[n].abs().max()), 1e-30)
        assert float((g - jg[n]).abs().max()) <= 1e-4 * scale, n


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "qwen2_5_3b",
                                  "olmoe_1b_7b", "internvl2_1b"])
def test_train_step_is_the_reference(arch, monkeypatch):
    """Loss (with the MoE aux term), grad norm and every leaf's gradient of
    one step (hubert's and jamba's are in test_torch_hubert.py)."""
    kw = dict(n_groups=2)
    _assert_step_close(*_step_both(arch, monkeypatch, kw, kw))


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "phi3_5_moe_42b"])
def test_microbatched_train_step_is_the_reference(arch, monkeypatch):
    """``microbatches=2`` over B 4 on an MoE config, one routing group a
    microbatch: the group's load-balancing term and capacity span the
    microbatch's two rows, so the loss, grad norm and every leaf's
    gradient are the reference's (1e-5 relative) only where each
    microbatch is the reference's contiguous block."""
    jcfg = _cfgs(arch)[0]
    nb = {k: np.concatenate([a, b]) for (k, a), b in
          zip(_batch(jcfg, 1).items(), _batch(jcfg, 2).values())}  # B 4
    kw = dict(n_groups=1, microbatches=2)
    jm, tm, jg, tg = _step_both(arch, monkeypatch, kw, kw, nb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert tg.keys() == jg.keys()
    for n, g in tg.items():
        scale = max(float(jg[n].abs().max()), 1e-30)
        assert float((g - jg[n]).abs().max()) <= 1e-5 * scale, n


def test_xlstm_loss_and_gradient_are_the_reference(monkeypatch):
    """xLSTM's smoke config (two chunks of 16 a row): ``loss_fn`` and its
    gradient against the reference's ``jax.value_and_grad`` (loss and grad
    norm 1e-4 relative, each leaf within 1e-4 of its max |g|), then one
    training step through ``make_train_step``."""
    jcfg, jparams, tcfg, model = _models("xlstm_1_3b")
    nb = _batch(jcfg, 4)
    (jtot, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in nb.items()}),
        has_aux=True)(jparams)
    ttot, _ = T.loss_fn(model, tcfg, {k: torch.from_numpy(v)
                                      for k, v in nb.items()}, ctx=CPU)
    ttot.backward()
    assert float(ttot.detach()) == pytest.approx(float(jtot), rel=1e-4)
    tg = {n: p.grad for n, p in model.named_parameters()}
    jg = convert.named_from_tree(_np(jgrads), tcfg, "cpu")

    def norm(g):
        return float(torch.sqrt(sum((t.double() ** 2).sum()
                                    for t in g.values())))

    assert norm(tg) == pytest.approx(norm(jg), rel=1e-4)
    assert tg.keys() == jg.keys()
    for n, g in tg.items():
        scale = max(float(jg[n].abs().max()), 1e-30)
        assert float((g - jg[n]).abs().max()) <= 1e-4 * scale, n
    _assert_step_close(*_step_both("xlstm_1_3b", monkeypatch))


def test_xlstm_trainer_steps_are_the_reference(tmp_path):
    """Three ``Trainer`` steps of xLSTM's smoke config at weight_decay=0
    (the reference decays its stacked gate biases): the losses within the
    loss curve's 1e-3, and every parameter moved."""
    jtr, ttr = _trainers(str(tmp_path), steps=3, arch="xlstm_1_3b")
    before = {n: p.detach().clone() for n, p in ttr.params.named_parameters()}
    want, got = jtr.run(), ttr.run()
    assert got["step"] == [0, 1, 2] and ttr.skipped_steps == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-3)
    for n, p in ttr.params.named_parameters():
        assert not torch.equal(p, before[n]), n


def test_microbatches_and_remat_match_the_plain_step():
    """stablelm's smoke config: ``microbatches=2`` and ``remat=True`` give
    the plain step's loss and gradients (1e-5 relative)."""
    jcfg, jparams, tcfg, _ = _models("stablelm_1_6b")
    nb = {k: torch.from_numpy(v) for k, v in _batch(jcfg, 9).items()}
    nb["tokens"] = torch.cat([nb["tokens"], nb["tokens"].flip(0)])  # B 4
    out = {}
    for name, kw in (("plain", {}), ("microbatches", dict(microbatches=2)),
                     ("remat", dict(remat=True))):
        model = convert.transformer_from_jax(jparams, tcfg, "cpu")
        caught = {}

        def catch(p, g, s, c, caught=caught):
            caught["g"] = {n: t.clone() for n, t in g.items()}
            return p, s, {"grad_norm": TO.global_norm(g), "lr": 0.0}

        step = TTR.make_train_step(tcfg, TO.AdamWConfig(),
                                   TTR.TrainConfig(ctx=CPU, **kw))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TTR, "apply_updates", catch)
            _, _, m = step(model, TO.init_state(model), nb)
        out[name] = (float(m["loss"]), caught["g"])
    loss0, g0 = out["plain"]
    for name in ("microbatches", "remat"):
        loss, g = out[name]
        assert loss == pytest.approx(loss0, rel=1e-5), name
        for n in g0:
            scale = max(float(g0[n].abs().max()), 1e-30)
            assert float((g[n] - g0[n]).abs().max()) <= 1e-5 * scale, (name,
                                                                       n)


def test_compressed_step_and_non_finite_skip(monkeypatch):
    """``compress_grads`` hands the optimizer quantized gradients; a
    non-finite loss raises before any parameter moves, and the trainer
    skips that step."""
    jcfg, jparams, tcfg, model = _models("stablelm_1_6b")
    nb = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    seen = {}
    orig = TTR.apply_updates

    def catch(p, g, s, c):
        seen["g"] = g
        return orig(p, g, s, c)

    monkeypatch.setattr(TTR, "apply_updates", catch)
    step = TTR.make_train_step(tcfg, TO.AdamWConfig(),
                               TTR.TrainConfig(ctx=CPU, compress_grads=True))
    step(model, TO.init_state(model), nb)
    g = seen["g"]["head"]
    scale = g.abs().max() / 127.0
    assert torch.equal(torch.round(g / scale) * scale, g)
    with torch.no_grad():
        model.final_norm.fill_(float("nan"))
    before = {n: p.clone() for n, p in model.named_parameters()}
    state = TO.init_state(model)
    with pytest.raises(FloatingPointError):
        step(model, state, nb)
    assert int(state.step) == 0
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) or n == "final_norm"


# -- the loop and checkpoints -------------------------------------------------

def _trainers(tmp, steps=24, arch="stablelm_1_6b", **tkw):
    """The reference's tests/test_train.py mini trainer in both packages,
    f32 compute and no weight decay, the port's carrying the reference's
    initial weights."""
    jcfg, tcfg = _cfgs(arch)
    dcfg = dict(batch_size=8, seq_len=32, vocab_size=jcfg.vocab_size)
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=steps, weight_decay=0.0)
    jtr = JTR.Trainer(jcfg, JO.AdamWConfig(**ocfg), JTR.TrainConfig(
        steps=steps, log_every=0, ckpt_dir=os.path.join(tmp, "ref"),
        ckpt_every=8, **tkw), JD.DataConfig(**dcfg))
    ttr = TTR.Trainer(tcfg, TO.AdamWConfig(**ocfg), TTR.TrainConfig(
        steps=steps, log_every=0, ckpt_dir=os.path.join(tmp, "port"),
        ckpt_every=8, ctx=CPU, **tkw), TD.DataConfig(**dcfg))
    jtr.init(0)
    ttr.init(0)
    ttr.params = convert.transformer_from_jax(jtr.params, tcfg, "cpu")
    ttr.opt_state = TO.init_state(ttr.params)
    return jtr, ttr


def test_loss_curve_is_the_reference(tmp_path):
    jtr, ttr = _trainers(str(tmp_path))
    want, got = jtr.run(), ttr.run()
    assert got["step"] == list(range(24)) and ttr.skipped_steps == 0
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-3)
    assert got["loss"][-1] < got["loss"][0] - 0.2
    assert TCK.committed_steps(str(tmp_path / "port")) == [8, 16, 24]


def test_trainer_checkpoints_load_both_ways(tmp_path):
    """A port run's checkpoint restores in the reference's trainer, and a
    reference run's in the port's, bit for bit; a resumed port trainer takes
    the remaining steps from the newest commit."""
    jtr, ttr = _trainers(str(tmp_path), steps=8)
    jtr.run()
    ttr.run()
    # port -> reference
    jnew, _ = _trainers(str(tmp_path), steps=8)
    jnew.train_cfg.ckpt_dir = str(tmp_path / "port")
    jnew.resume_or_init()
    assert jnew.start_step == 8
    port_tree = convert._numpy_tree(ttr.state_tree()["params"])
    for w, g in zip(jax.tree.leaves(_np(jnew.params)),
                    jax.tree.leaves(port_tree)):
        np.testing.assert_array_equal(w, g)
    np.testing.assert_array_equal(_np(jnew.opt_state.v)["head"],
                                  ttr.opt_state.v["head"].numpy())
    assert int(jnew.opt_state.step) == 8
    # reference -> port
    _, tnew = _trainers(str(tmp_path), steps=12)
    tnew.train_cfg.ckpt_dir = str(tmp_path / "ref")
    tnew.resume_or_init()
    assert tnew.start_step == 8 and int(tnew.opt_state.step) == 8
    for w, g in zip(jax.tree.leaves(_np(jtr.params)),
                    jax.tree.leaves(convert.transformer_to_jax(tnew.params))):
        np.testing.assert_array_equal(w, g)
    hist = tnew.run()
    assert hist["step"] == [8, 9, 10, 11]


def _mixed_tree():
    rng = np.random.default_rng(2)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    h = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32)).to(
        torch.bfloat16)
    return {"b": {"h": h, "i": torch.arange(6, dtype=torch.int32)},
            "a": torch.from_numpy(f), "t": (torch.tensor(7, dtype=torch.int32),
                                            {"z": torch.ones(2)})}


def _jax_tree(tree):
    return {"b": {"h": jnp.asarray(tree["b"]["h"].float().numpy(),
                                   jnp.bfloat16),
                  "i": jnp.asarray(tree["b"]["i"].numpy())},
            "a": jnp.asarray(tree["a"].numpy()),
            "t": (jnp.asarray(7, jnp.int32), {"z": jnp.ones(2)})}


def _bits(x):
    if torch.is_tensor(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint16).view(np.int16) if a.dtype.name == "bfloat16" else a


def test_checkpoint_round_trip_rotation_and_uncommitted(tmp_path):
    tree = _mixed_tree()
    d = str(tmp_path)
    TCK.save(d, 5, tree, extra={"note": "x"})
    restored, extra = TCK.restore(d, tree)
    assert extra == {"note": "x"}
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for s in (6, 7, 8):
        TCK.save(d, s, tree, keep=2)
    assert TCK.committed_steps(d) == [7, 8]
    os.makedirs(tmp_path / "step_00000009")  # a crashed write: no marker
    os.makedirs(tmp_path / "step_00000010.tmp")
    assert TCK.latest_step(d) == 8
    with pytest.raises(KeyError, match="missing"):
        TCK.restore(d, {"nope": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        TCK.restore(str(tmp_path / "empty"), tree)


def test_checkpoints_cross_packages_bit_for_bit(tmp_path):
    """Same keys, order, dtypes and bits on disk; each package restores the
    other's directory."""
    tree = _mixed_tree()
    jtree = _jax_tree(tree)
    TCK.save(str(tmp_path / "port"), 3, tree)
    JCK.save(str(tmp_path / "ref"), 3, jtree)
    manifests = []
    for who in ("port", "ref"):
        with open(tmp_path / who / "step_00000003" / "manifest.json") as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert manifests[0]["keys"] == ["a", "b/h", "b/i", "t/0", "t/1/z"]
    assert "bfloat16" in manifests[0]["dtypes"]
    got_j, _ = JCK.restore(str(tmp_path / "port"), jtree)
    got_t, _ = TCK.restore(str(tmp_path / "ref"), tree)
    for a, b, c in zip(jax.tree.leaves(tree), jax.tree.leaves(got_j),
                       jax.tree.leaves(got_t)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(a), _bits(c))
        assert c.dtype == a.dtype


# -- the launchers --------------------------------------------------------------

def test_launch_train_runs_on_the_cpu_and_refuses_a_mesh(monkeypatch):
    from repro_torch.launch import train as launch_train

    hist = launch_train.main(["--arch", "stablelm_1_6b", "--smoke",
                              "--device", "cpu", "--steps", "3"])
    assert len(hist["loss"]) == 3 and np.isfinite(hist["loss"]).all()
    # a mesh needs its ranks: torchrun's environment, one rank a device
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun's environment"):
        launch_train.main(["--arch", "stablelm_1_6b", "--smoke", "--device",
                           "cpu", "--mesh", "1,1"])


@pytest.mark.skipif(torch.cuda.is_available(), reason="the no-GPU refusal")
def test_training_entry_points_raise_without_a_gpu():
    from repro_torch.launch import train as launch_train

    with pytest.raises(DeviceLost):
        launch_train.main(["--arch", "stablelm_1_6b", "--smoke", "--steps",
                           "1"])
    jcfg, tcfg = _cfgs("stablelm_1_6b")
    with pytest.raises(DeviceLost):
        TTR.Trainer(tcfg, TO.AdamWConfig(), TTR.TrainConfig(),
                    TD.DataConfig(batch_size=1, seq_len=4, vocab_size=8))


def test_serve_from_a_reference_trainers_checkpoint(tmp_path, monkeypatch):
    """Greedy tokens served by the port from a checkpoint that the
    reference's trainer wrote equal the reference serve's from the same
    directory (f32 compute in both, so no near-tie depends on bf16)."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    jcfg, tcfg = _cfgs("qwen2_5_3b")
    jtr = JTR.Trainer(jcfg, JO.AdamWConfig(lr=1e-2, warmup_steps=1,
                                           total_steps=4),
                      JTR.TrainConfig(steps=4, log_every=0,
                                      ckpt_dir=str(tmp_path), ckpt_every=4),
                      JD.DataConfig(batch_size=4, seq_len=16,
                                    vocab_size=jcfg.vocab_size))
    jtr.run()
    monkeypatch.setattr(jc, "get_smoke", lambda arch: jcfg)
    monkeypatch.setattr(tc, "get_smoke", lambda arch: tcfg)
    flags = ["--arch", "qwen2_5_3b", "--smoke", "--ckpt-dir", str(tmp_path),
             "--requests", "4", "--prompt-len", "8", "--max-new", "6"]
    reqs = tserve.main(flags + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["serve"] + flags + ["--backend", "xla"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jserve.main()
    lines = [ln for ln in out.getvalue().splitlines() if "out=" in ln]
    want = [eval(ln.split("out=")[1].split(" (")[0]) for ln in lines]
    assert len(want) == 4
    assert [r.out_tokens[:12].tolist() for r in reqs] == want
    # and not the seed's random weights
    fresh = tserve.main(["--arch", "qwen2_5_3b", "--smoke", "--device",
                         "cpu", "--requests", "4", "--prompt-len", "8",
                         "--max-new", "6"])
    assert [r.out_tokens.tolist() for r in fresh] != want
