"""The mesh trainer (``Trainer(..., mesh=)``, ``launch/train.py --mesh``)
on 4 gloo ranks of a (data 2, model 2) mesh on the CPU, held against the
single-device trainer and the dry run's count of the same step.

Qwen2.5-3B's smoke config in f32 (parameters and compute): the first
step's loss and every gradient within 1e-5 of the single-device
trainer's, relative to the largest |value| of the leaf; after 2 AdamW
steps every parameter within 2 x lr x steps (AdamW's first steps move an
element by about lr x sign(g), so a gradient near 0 may flip sign and
still be right); each step's wire bytes by kind and the argument bytes
equal to ``dryrun.count_train_step``'s exactly; a single-device checkpoint
restored onto the mesh with ``shardings=`` and gathered back is
bit-equal; a prefill into and a decode step from a cache sharded along
its sequence match one device's within 1e-5. The ranks are
subprocesses, joined under a time limit."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import dtensors
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import dryrun as dr
from repro_torch.models import transformer as T
from repro_torch.ops import ExecutionContext
from repro_torch.plan import H100
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS, MESH = 4, (2, 2)
B, L, STEPS, LR = 4, 16, 2, 1e-3
CPU = ExecutionContext(target=H100, backend="torch", device="cpu")
SERVE_B, SERVE_LEN, SERVE_PROMPT = 4, 16, 9  # the prompt spans both shards


def serve_tokens(cfg):
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (SERVE_B, SERVE_PROMPT + 1)))


def _cfg():
    return dataclasses.replace(get_smoke("qwen2_5_3b"),
                               param_dtype="float32",
                               compute_dtype="float32")


def _configs(cfg):
    return (AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS),
            TrainConfig(steps=STEPS, ctx=CPU, n_groups=4, log_every=0),
            DataConfig(batch_size=B, seq_len=L, vocab_size=cfg.vocab_size))


_RANK_CODE = textwrap.dedent('''
    import dataclasses, os, sys, torch
    import torch.distributed as dist
    sys.path.insert(0, os.environ["TEST_DIR"])
    from test_torch_mesh_train import (_cfg, _configs, MESH, SERVE_B,
                                       SERVE_LEN, SERVE_PROMPT, serve_tokens)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch import dtensors
    from repro_torch.models import sharding as shd, spmd
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer
    out_dir = sys.argv[1]
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo")
    mesh = make_host_mesh(*MESH, device_type="cpu")
    cfg = _cfg()
    ocfg, tcfg, dcfg = _configs(cfg)
    trainer = Trainer(cfg, ocfg, tcfg, dcfg, mesh=mesh)
    trainer.init(0)
    named = dict(trainer.params.named_parameters())
    # the first step's loss and gradients, reduced as the step reduces them
    batch = trainer.place_batch(trainer.source.batch(0))
    with spmd.replicate_plain(trainer.params.head):
        total, _ = T.loss_fn(trainer.params, cfg, batch, ctx=tcfg.ctx,
                             n_groups=tcfg.n_groups)
        total.backward()
        loss0 = total.full_tensor()
        grads = {n: spmd.like(p.grad, p).full_tensor()
                 for n, p in named.items()}
    for p in named.values():
        p.grad = None
    hist = trainer.run()
    final = {n: p.full_tensor() for n, p in
             trainer.params.named_parameters()}
    # the single-device checkpoint, restored onto the mesh and gathered
    template = trainer.state_tree()
    specs = shd.stacked_param_specs(cfg)
    tree = {"params": specs, "opt": (shd.P(), specs, specs)}
    placed, _ = ckpt.restore(os.path.join(out_dir, "ckpt"), template,
                             device="cpu",
                             shardings=shd.shardings(mesh, tree))
    plain, _ = ckpt.restore(os.path.join(out_dir, "ckpt"), template,
                            device="cpu")
    flat_p = [t for _, t in ckpt._flatten_with_paths(placed)]
    flat_w = [t for _, t in ckpt._flatten_with_paths(plain)]
    restore_equal = all(
        torch.equal(a.full_tensor() if dtensors.is_dtensor(a) else a, b)
        for a, b in zip(flat_p, flat_w))
    sharded = sum(dtensors.is_dtensor(a) and a.to_local().shape != a.shape
                  for a in flat_p)
    # a prefill into a cache sharded along its sequence, then a decode step
    # (sequence-parallel attention, each shard writing its positions)
    model = T.init_params(cfg, seed=1, device="cpu")
    pshard = shd.shardings(mesh, shd.param_specs(cfg))
    for name, p in list(model.named_parameters()):
        mod, leaf = name.rpartition(".")[0], name.rpartition(".")[2]
        owner = model.get_submodule(mod) if mod else model
        owner._parameters[leaf] = torch.nn.Parameter(
            pshard[name].place(p.detach()), requires_grad=False)
    cache = T.init_cache(cfg, SERVE_B, SERVE_LEN, dtype=torch.float32,
                         device="cpu")
    cspecs = shd.shardings(mesh, shd.cache_specs(cfg, mesh, SERVE_B,
                                                 SERVE_LEN))
    cache = {b: {n: cspecs[b][n].place(t) for n, t in leaves.items()}
             for b, leaves in cache.items()}
    toks = serve_tokens(cfg)
    tok_sh = shd.NamedSharding(mesh, shd.P("data", None))
    with torch.no_grad():
        pre, cache, _ = T.forward(model, cfg,
                                  tokens=tok_sh.place(toks[:, :SERVE_PROMPT]),
                                  cache=cache, cache_index=0, ctx=tcfg.ctx)
        dec, cache, _ = T.forward(model, cfg,
                                  tokens=tok_sh.place(
                                      toks[:, SERVE_PROMPT:SERVE_PROMPT + 1]),
                                  cache=cache, cache_index=SERVE_PROMPT,
                                  decode=True, ctx=tcfg.ctx)
        serve = {"prefill": pre.full_tensor(), "decode": dec.full_tensor(),
                 "seq_sharded": cache["b0"]["k"].placements}
    torch.save({"loss0": loss0, "grads": grads, "hist": hist,
                "serve": serve,
                "final": final, "collectives": trainer.collectives,
                "restore_equal": restore_equal, "sharded_leaves": sharded,
                "argument_bytes": __import__(
                    "repro_torch.launch.dryrun", fromlist=["x"]
                ).argument_bytes((trainer.params, trainer.opt_state,
                                  batch))},
               os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(argv, out_dir, timeout=300):
    port = _free_port()
    procs = []
    for r in range(RANKS):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   TEST_DIR=os.path.join(ROOT, "tests"), RANK=str(r),
                   LOCAL_RANK=str(r), WORLD_SIZE=str(RANKS),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(argv + [out_dir], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-6000:]
    return logs


@pytest.fixture(scope="module")
def single_and_mesh(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_train")
    cfg = _cfg()
    ocfg, tcfg, dcfg = _configs(cfg)
    single = Trainer(cfg, ocfg, tcfg, dcfg)
    single.init(0)
    ckpt.save(str(out / "ckpt"), 0, single.state_tree())
    batch = single.place_batch(single.source.batch(0))
    total, _ = T.loss_fn(single.params, cfg, batch, ctx=CPU,
                         n_groups=tcfg.n_groups)
    total.backward()
    grads = {n: p.grad.clone() for n, p in single.params.named_parameters()}
    for p in single.params.parameters():
        p.grad = None
    hist = single.run()
    final = {n: p.detach().clone() for n, p in
             single.params.named_parameters()}
    model = T.init_params(cfg, seed=1, device="cpu")
    cache = T.init_cache(cfg, SERVE_B, SERVE_LEN, dtype=torch.float32,
                         device="cpu")
    toks = serve_tokens(cfg)
    with torch.no_grad():
        pre, cache, _ = T.forward(model, cfg, tokens=toks[:, :SERVE_PROMPT],
                                  cache=cache, cache_index=0, ctx=CPU)
        dec, _, _ = T.forward(model, cfg,
                              tokens=toks[:, SERVE_PROMPT:SERVE_PROMPT + 1],
                              cache=cache, cache_index=SERVE_PROMPT,
                              decode=True, ctx=CPU)
    _run_ranks([sys.executable, "-c", _RANK_CODE], str(out))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    count = dr.count_train_step(
        cfg, MESH, {"tokens": torch.as_tensor(single.source.batch(0)
                                               ["tokens"])}, tcfg, ocfg)
    return {"loss0": total.detach(), "grads": grads, "hist": hist,
            "final": final, "ranks": ranks, "count": count,
            "serve": {"prefill": pre, "decode": dec}}


def test_first_step_loss_and_gradients_match_one_device(single_and_mesh):
    want = single_and_mesh
    for rec in want["ranks"]:
        assert float(rec["loss0"]) == pytest.approx(float(want["loss0"]),
                                                    rel=1e-5)
        for name, g in want["grads"].items():
            got = rec["grads"][name]
            scale = float(g.abs().max())
            assert float((got - g).abs().max()) <= 1e-5 * max(scale, 1e-30), \
                name


def test_updated_parameters_match_one_device(single_and_mesh):
    want = single_and_mesh
    for rec in want["ranks"]:
        assert rec["hist"]["step"] == list(range(STEPS))
        np.testing.assert_allclose(rec["hist"]["loss"], want["hist"]["loss"],
                                   rtol=1e-5)
        for name, p in want["final"].items():
            err = float((rec["final"][name] - p).abs().max())
            assert err <= 2 * LR * STEPS, (name, err)


def test_wire_and_argument_bytes_equal_the_dry_run(single_and_mesh):
    count = single_and_mesh["count"]
    assert count["calls"].keys() == {"all-reduce"}  # what gloo runs on cards
    for rec in single_and_mesh["ranks"]:
        assert len(rec["collectives"]) == STEPS
        for step in rec["collectives"]:
            assert step == count["collectives"]
        assert rec["argument_bytes"] == count["argument_bytes"]


def test_sequence_sharded_cache_serves_as_one_device(single_and_mesh):
    """Prefill into, and a decode step from, a cache whose sequence is
    sharded over ``model`` (``cache_specs``): the sequence-parallel
    attention's merged logits within 1e-5 of one device's."""
    from torch.distributed.tensor import Shard

    want = single_and_mesh["serve"]
    for rec in single_and_mesh["ranks"]:
        assert rec["serve"]["seq_sharded"] == (Shard(1), Shard(3))
        for key in ("prefill", "decode"):
            got, ref = rec["serve"][key], want[key]
            assert float((got - ref).abs().max()) <= \
                1e-5 * float(ref.abs().max()), key


def test_sequence_parallel_attention_refuses_the_cuda_backend():
    """A decode step over K/V sharded along their sequence takes each
    shard's partial through ``ops.attention`` with row statistics on the
    chosen backend: the ``cuda`` route dispatches the flash entry with
    statistics (its plain version on the CPU, one decision a device,
    charged the stats counter) and returns the ``torch`` route's output
    placements; a paged pool on a mesh still raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import ops
    from repro_torch.kernels.flash_attention import (
        attention_blocks, attention_stats_hbm_words)
    from repro_torch.launch.mesh import make_host_mesh

    Bq, H, KV, Lk, hd = 4, 8, 2, 16, 32
    with dr.fake_group(4):
        mesh = make_host_mesh(2, 2, device_type="cpu")
        with FakeTensorMode():
            q = distribute_tensor(torch.empty(Bq, H, 1, hd), mesh,
                                  (Shard(0), Replicate()),
                                  src_data_rank=None)
            k, v = (distribute_tensor(torch.empty(Bq, KV, Lk, hd), mesh,
                                      (Shard(0), Shard(2)),
                                      src_data_rank=None) for _ in "kv")
            cuda = ExecutionContext(target=H100, backend="cuda",
                                    device="cpu")
            outs = {}
            for name, ctx in (("cuda", cuda), ("torch", CPU)):
                with ops.record_dispatch() as log:
                    outs[name] = ops.attention(q, k, v, q_offset=Lk - 1,
                                               ctx=ctx)
                assert [d.chosen for d in log] == [name]
            (d,) = [d for d in log]  # the torch route has no counter
            assert d.measured_words is None
            for out in outs.values():
                assert out.shape == (Bq, H, 1, hd)
                assert out.placements == (Shard(0), Replicate())
            with ops.record_dispatch() as log:
                ops.attention(q, k, v, q_offset=Lk - 1, ctx=cuda)
            assert log[0].measured_words == attention_stats_hbm_words(
                Bq // 2 * KV, H // KV, Lk // 2, hd,
                *attention_blocks(hd, H100, kv_word=1.0))
            pool = distribute_tensor(torch.empty(8, KV, 4, hd), mesh,
                                     (Replicate(), Replicate()),
                                     src_data_rank=None)
            with pytest.raises(NotImplementedError, match="paged"):
                ops.attention_decode(q, pool, pool,
                                     torch.zeros(Bq, 2, dtype=torch.int32),
                                     torch.ones(Bq, dtype=torch.int32),
                                     ctx=cuda)


def test_checkpoint_restores_onto_the_mesh_bit_equal(single_and_mesh):
    for rec in single_and_mesh["ranks"]:
        assert rec["restore_equal"]
        assert rec["sharded_leaves"] > 0


_LAUNCH_CODE = textwrap.dedent('''
    import json, os, sys
    import torch.distributed as dist
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train
    from repro_torch.launch.dryrun import argument_bytes
    flash = KERNELS["flash_attention"]
    flash.launches = 0
    trainer, hist = train.train([
        "--arch", "qwen2_5_3b", "--smoke", "--device", "cpu", "--mesh",
        "2,2", "--steps", "2", "--batch", "4", "--seq", "16"])
    batch = trainer.place_batch(trainer.source.batch(0))
    rec = {"loss": hist["loss"], "collectives": trainer.collectives,
           "argument_bytes": argument_bytes(
               (trainer.params, trainer.opt_state, batch)),
           "flash_launches": flash.launches}
    if os.environ["RANK"] == "0":
        with open(sys.argv[1] + "/report.json", "w") as f:
            json.dump(rec, f)
    dist.destroy_process_group()
''')


def test_launch_train_mesh_matches_one_device_and_the_count(tmp_path):
    """The launcher as ``torchrun --nproc-per-node 4 -m
    repro_torch.launch.train ... --mesh 2,2`` starts it (the smoke config
    as published: bf16 compute, so the losses within 1e-3)."""
    _run_ranks([sys.executable, "-c", _LAUNCH_CODE], str(tmp_path))
    rep = json.loads((tmp_path / "report.json").read_text())
    from repro_torch.launch import train as launch_train

    single = launch_train.main(["--arch", "qwen2_5_3b", "--smoke",
                                "--device", "cpu", "--steps", "2",
                                "--batch", "4", "--seq", "16"])
    np.testing.assert_allclose(rep["loss"], single["loss"], rtol=1e-3)
    cfg = get_smoke("qwen2_5_3b")
    count = dr.count_train_step(
        cfg, MESH, {"tokens": torch.empty((4, 16), dtype=torch.int32)},
        TrainConfig(n_groups=4))
    assert rep["collectives"] == [count["collectives"]] * 2
    assert rep["argument_bytes"] == count["argument_bytes"]
    assert rep["flash_launches"] == 0  # the CPU runs the plain version


def test_gloo_guard_names_what_gloo_cannot_run_on_cards(monkeypatch):
    import torch.distributed as dist

    class CardTensor:
        is_cuda = True

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    monkeypatch.setattr(dtensors, "tensors", lambda args: [CardTensor()])
    with pytest.raises(NotImplementedError, match="all-gather"):
        dtensors.gloo_guard("all-gather", "all_gather_into_tensor", ())
    for kind in dtensors.GLOO_CUDA_COLLECTIVES:
        dtensors.gloo_guard(kind, "op", ())
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    dtensors.gloo_guard("all-gather", "all_gather_into_tensor", ())


def test_unroll_scans_is_always_on(monkeypatch):
    """The port's scans are Python loops: every step runs, whatever
    ``REPRO_UNROLL_SCANS`` says."""
    from repro_torch.models import scan_util

    calls = []

    def step(c, x):
        calls.append(1)
        return c + x, c

    for env in ("0", "1"):
        monkeypatch.setenv("REPRO_UNROLL_SCANS", env)
        assert scan_util.unroll_scans() is True
        calls.clear()
        carry, ys = scan_util.scan(step, torch.zeros(()), torch.arange(5.0))
        assert len(calls) == 5 and float(carry) == 10.0
        assert ys.tolist() == [0.0, 0.0, 1.0, 3.0, 6.0]
