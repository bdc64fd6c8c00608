"""HuBERT-xLarge's encoder in repro_torch against repro on the CPU: the
config, the model without an embedding table, forward logits on the smoke
config and on a reduction at head dim 80 (HuBERT's own), a training step
(beside jamba's, the two slowest smoke configs), and the hd-80 instance of
the tensor-core flash kernel: its CPU model
(``flash_attention_tc_emulate``), causal and not, against the reference's
flash kernel in interpret mode and the plain version, its launch
configurations, and the audit of its access plan.

Tolerances: f32 logits 1e-4 (both sides accumulate in f32, in another
order); bf16 logits 5e-2 (activations round to bf16 each layer); bf16
flash outputs 2^-7 x max(1, max|want|) (one bf16 rounding of the output,
P's bf16 rounding inside it); a train step as in test_torch_train.py.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _assert_step_close, _step_both

import repro.configs as jc
import repro_torch.configs as tc
from repro.models import transformer as JT
from repro_torch import ops
from repro_torch.convert import transformer_from_jax
from repro_torch.kernels import flash_attention_plain
from repro_torch.kernels.flash_attention import (FLASH_INSTANCES,
                                                 attention_blocks,
                                                 flash_attention_access_plan,
                                                 flash_attention_tc_emulate,
                                                 flash_tc_instances,
                                                 launch_config)
from repro_torch.models import transformer as T
from repro_torch.ops import ExecutionContext
from repro_torch.plan import H100
from repro_torch.verify.audit import audit_access_plan

jfa = importlib.import_module("repro.kernels.flash_attention")
BF16 = torch.bfloat16
CTXS = {"cuda": ExecutionContext(backend="cuda", device="cpu"),
        "torch": ExecutionContext(backend="torch", device="cpu")}


def _hd80(cfg):
    """HuBERT's head dim at a CPU size: d_model 160, 2 heads, 2 layers."""
    return dataclasses.replace(cfg, n_layers=2, d_model=160, n_heads=2,
                               n_kv_heads=2, d_ff=320, name=cfg.name + "-hd80")


def _pair(reduce, compute_dtype="float32"):
    jcfg = dataclasses.replace(reduce(jc.get_config("hubert_xlarge")),
                               compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(reduce(tc.get_config("hubert_xlarge")),
                               compute_dtype=compute_dtype)
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, jparams, tcfg, transformer_from_jax(jparams, tcfg, "cpu")


REDUCTIONS = {"smoke": jc.reduced, "hd80": _hd80}


def test_config_is_the_reference_and_ported():
    assert dataclasses.asdict(tc.get_config("hubert_xlarge")) == \
        dataclasses.asdict(jc.get_config("hubert_xlarge"))
    assert dataclasses.asdict(tc.get_smoke("hubert_xlarge")) == \
        dataclasses.asdict(jc.get_smoke("hubert_xlarge"))
    cfg = tc.get_config("hubert_xlarge")
    # every architecture of the reference is ported, xLSTM the last
    assert "hubert_xlarge" in tc.ARCH_IDS and "xlstm_1_3b" in tc.ARCH_IDS
    assert tc.NOT_PORTED == {}
    assert (cfg.hd, cfg.causal, cfg.family) == (80, False, "encoder")
    with torch.device("meta"):
        model = T.Transformer(cfg)
    n = sum(p.numel() for p in model.parameters())
    assert model.embed is None and 1.25e9 < n < 1.27e9


@pytest.mark.parametrize("reduce", sorted(REDUCTIONS))
def test_no_embed_leaf_and_the_reference_tree(reduce):
    jcfg, jparams, tcfg, model = _pair(REDUCTIONS[reduce])
    assert "embed" not in jparams and "embed" not in model.state_dict()
    with pytest.raises(ValueError, match="embeds="):
        T.forward(model, tcfg, tokens=torch.zeros((1, 4), dtype=torch.int64),
                  ctx=CTXS["torch"])


@pytest.mark.parametrize("backend", sorted(CTXS))
@pytest.mark.parametrize("reduce", sorted(REDUCTIONS))
def test_forward_is_the_reference(reduce, backend):
    """Non-causal logits over stub frame embeddings, f32 compute."""
    jcfg, jparams, tcfg, model = _pair(REDUCTIONS[reduce])
    emb = (0.1 * np.random.default_rng(3).standard_normal(
        (2, 37, jcfg.d_model))).astype(np.float32)
    want, _, _ = JT.forward(jparams, jcfg, embeds=jnp.asarray(emb))
    with torch.no_grad():
        got, cache, aux = T.forward(model, tcfg, embeds=torch.from_numpy(emb),
                                    ctx=CTXS[backend])
    assert cache is None and float(aux) == 0.0
    assert got.shape == (2, 37, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_forward_bf16_compute_at_hd80():
    jcfg, jparams, tcfg, model = _pair(_hd80, "bfloat16")
    emb = (0.1 * np.random.default_rng(4).standard_normal(
        (2, 50, jcfg.d_model))).astype(np.float32)
    want, _, _ = JT.forward(jparams, jcfg, embeds=jnp.asarray(emb))
    with torch.no_grad():
        got, _, _ = T.forward(model, tcfg, embeds=torch.from_numpy(emb),
                              ctx=CTXS["cuda"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("arch", ["hubert_xlarge", "jamba_1_5_large"])
def test_train_step_is_the_reference(arch, monkeypatch):
    """test_torch_train.py's step parity: HuBERT's classification loss over
    stub embeddings, and jamba's mamba + attention unit with its MoE."""
    kw = dict(n_groups=2)
    _assert_step_close(*_step_both(arch, monkeypatch, kw, kw))


# -- the hd-80 instance of the flash kernel ------------------------------------

def _check(got, want):
    got = got.float().numpy()
    want = (want.float().numpy() if torch.is_tensor(want)
            else np.asarray(want, np.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= 2.0 ** -7 * max(1.0, float(np.abs(want).max())), err


HD80_CASES = {  # (BH, Lq, Lk, block): the warp grid the runtime bq takes
    "prefill_block64": (4, 130, 200, 64),  # bq 64: R 4, C 1, ragged tiles
    "bq24_block64": (3, 20, 150, 64),      # R 2, C 2
    "bq8_block64": (4, 5, 100, 64),        # R 1, C 4
    "resident_block64": (2, 100, 40, 64),  # one key tile, resident
    "bq32_block32": (3, 70, 90, 32),       # R 2, C 2
    "bq8_block32": (2, 3, 41, 32),         # R 1, C 4: 8-key slabs
}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", sorted(HD80_CASES))
def test_hd80_emulate_matches_pallas_interpret(case, causal):
    BH, Lq, Lk, block = HD80_CASES[case]
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((BH, Lq, 80), (BH, Lk, 80), (BH, Lk, 80)))
    off = max(0, Lk - Lq)
    want = jfa.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), causal=causal,
                               q_offset=off, block_q=16, block_k=16,
                               interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    got = flash_attention_tc_emulate(tq, tk, tv, causal, off, block=block)
    _check(got, want)
    _check(got, flash_attention_plain(tq, tk, tv, causal, off))
    assert launch_config(Lq, Lk, 80, block, BF16)["kernel"] == "tensor core"


def test_hd80_instances_and_launch_configs():
    """(80, 32) and (80, 64) are compiled; HuBERT's H100 plan is block 64
    at bf16 and f32 K/V; its prefill takes R 4 x C 1 at two CTAs an SM;
    every runtime bq at hd 80 lands on a compiled (80, block, C); a row is
    10 chunks of 16 bytes, which divide neither 128 nor 256 threads (the
    copies take the per-chunk division), and the pitch is 176 bytes."""
    assert {(80, 32), (80, 64)} <= FLASH_INSTANCES
    assert attention_blocks(80, H100, kv_word=0.5) == (64, 64)
    assert attention_blocks(80, H100, kv_word=1.0) == (64, 64)
    ours = [i for i in flash_tc_instances() if i[0] == 80]
    assert ours == [(80, 32, 2), (80, 32, 4), (80, 64, 1), (80, 64, 2),
                    (80, 64, 4)]
    pre = launch_config(512, 512, 80, 64, BF16, rows=8 * 16)
    assert pre["warp_grid"] == (4, 1) and pre["grid"] == (128, 8)
    assert pre["pitch"] == 88 and (88 * 2) % 32 == 16
    assert pre["smem"] == 5 * 64 * 88 * 2
    assert 2 * (pre["smem"] + 1024) <= 233472
    for block in (32, 64):
        for bq in range(8, block + 1, 8):
            cfg = launch_config(bq, 3 * block, 80, block, BF16, rows=2)
            assert (80, block, cfg["warp_grid"][1]) in ours
            assert (32 * cfg["warps"]) % 10 != 0
            # copy_plan's per-chunk walk: thread t copies chunks t, t + n,
            # ... of the tile's block x 10 chunks, each exactly once
            n = 32 * cfg["warps"]
            seen = sorted(i for t in range(n)
                          for i in range(t, block * 10, n))
            assert seen == list(range(block * 10))
        fma = launch_config(64, 64, 80, block, torch.float32)
        assert fma["kernel"] == "fma"


@pytest.mark.parametrize("Lq,Lk", [(512, 512), (8, 512), (100, 40)])
def test_hd80_access_plan_audits_clean(Lq, Lk):
    """The hd-80 launches' access plans: hazard-free rings, counted words
    equal to the counter, through ``ops.explain(..., audit=True)`` at
    HuBERT's prefill shape and directly at a decode-like and a resident
    shape."""
    ap = flash_attention_access_plan(8 * 16, Lq, Lk, 80, 64, 64, 0.5, 0.5,
                                     0.5)
    rep = audit_access_plan(ap)
    assert rep.hazards == [] and rep.problems == []
    ctx = ExecutionContext(target=H100, backend="cuda", device="cpu")
    q = torch.empty((8, 16, Lq, 80), dtype=BF16, device="meta")
    k = torch.empty((8, 16, Lk, 80), dtype=BF16, device="meta")
    d = ops.explain("attention", ctx, dtype=BF16, spec_args=(q, k, k),
                    audit=True)
    assert d.audited == d.measured_words > 0


@pytest.mark.cuda
def test_hd80_kernel_and_train_step_on_the_card():
    """The hd-80 instances against the plain version, causal and not, on
    the tensor cores; and one training step of the hd-80 reduction on the
    card against the CPU's (runs only where there is a GPU and nvcc;
    chip_smoke.py phase 21 trains the full model)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from repro_torch.kernels import KERNELS, flash_attention
    from repro_torch.train import optimizer as TO
    from repro_torch.train import trainer as TTR

    rng = np.random.default_rng(12)
    for block, (BH, Lq, Lk) in ((64, (4, 130, 200)), (64, (8, 512, 512)),
                                (32, (3, 20, 90))):
        q, k, v = (torch.from_numpy(rng.standard_normal((BH, n, 80)).astype(
            np.float32)).to(BF16).cuda() for n in (Lq, Lk, Lk))
        for causal in (False, True):
            tc = KERNELS["flash_attention"].tensor_core_launches
            got = flash_attention(q, k, v, causal=causal, block_q=block,
                                  block_k=block)
            assert KERNELS["flash_attention"].tensor_core_launches == tc + 1
            _check(got.cpu(), flash_attention_plain(q, k, v, causal).cpu())
    _, jparams, tcfg, _ = _pair(_hd80)
    batch = {"embeds": (0.1 * rng.standard_normal((2, 64, 160))).astype(
        np.float32), "labels": rng.integers(0, 504, (2, 64))}
    out = {}
    for dev in ("cpu", "cuda"):
        model = transformer_from_jax(jparams, tcfg, dev)
        step = TTR.make_train_step(tcfg, TO.AdamWConfig(), TTR.TrainConfig(
            ctx=ExecutionContext(backend="cuda", device=dev)))
        _, _, m = step(model, TO.init_state(model),
                       {k: torch.as_tensor(v, device=dev)
                        for k, v in batch.items()})
        out[dev] = (float(m["loss"]), float(m["grad_norm"]))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-3)
