"""The MoE FFN on a device mesh (``repro_torch.models.moe`` on DTensors,
with and without ``moe_shard_hints``) against the reference.

(a) ``moe_block`` on 4 gloo ranks of a (data 2, model 2) CPU mesh equals
the reference's ``moe_block`` (JAX, ``n_groups=4``) on the same numpy
inputs, for the reduced OLMoE-1B-7B and Phi-3.5-MoE configs in f32: each
output within 1e-5 of its largest |value|, the aux loss within 1e-5. The
input comes in the mesh trainer's layout (batch on ``data``) at L 16 and
L 128 (the groups' T_g E C then below and above ``eout``'s E C D a group:
both ways of the combine einsum) and in the dry run's sequence-sharded
layout. With hints every rank's count of a forward and backward holds
all-to-alls; in the trainer's layout neither path all-gathers (gloo
cannot run an all-gather on card tensors). The layout moves of
``dtensors`` (all-to-all, chunk, gather) keep values and gradients. On one
device the hints change nothing, bit for bit.

(b) The mesh trainer with the hints on OLMoE's smoke config in f32
against one device at ``n_groups=4`` (the mesh's): the first step's loss
and every gradient within 1e-5 of the leaf's largest |value|, the losses
of 2 AdamW steps within 1e-5 relative, every parameter after them within
2 x lr x steps; each step's wire bytes by kind (all-to-alls among them)
and the argument bytes equal to ``dryrun.count_train_step``'s.

(c) ``run_cell``'s per-device argument bytes equal the reference's
exactly on 2 x 2 with 2 layers and the hints on, for OLMoE ``train_4k``
and ``decode_32k`` and Phi-3.5-MoE ``train_4k``, both dry runs in one
module-scoped subprocess (the reference on 4 fake XLA devices with an
Auto-axis mesh); wire bytes by kind printed beside the reference's.

The launcher takes the hints and the mesh's dispatch groups on one
device (``--moe-shard-hints``, ``--moe-groups``). The ranks and the dry
runs are subprocesses, started together and joined under a time
limit."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import dryrun as dr
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.ops import ExecutionContext
from repro_torch.plan import H100
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer
from test_torch_mesh_train import _run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 2)
GROUPS = 4  # gcd(tokens, 4 devices): the mesh's, also on one device
ARCHS = ("olmoe_1b_7b", "phi3_5_moe_42b")
# (name, x spec, L): the trainer's layout below and above T_g = D, the
# dry run's sequence-sharded one
LAYOUTS = (("batch", ("data", None, None), 16),
           ("batch", ("data", None, None), 128),
           ("sequence", ("data", "model", None), 16))
# every layout on OLMoE, the trainer's at L 16 on Phi-3.5-MoE
BLOCK_CASES = tuple(("olmoe_1b_7b", lay) for lay in LAYOUTS) + (
    ("phi3_5_moe_42b", LAYOUTS[0]),)
B, L, STEPS, LR = 4, 16, 2, 1e-3
CPU = ExecutionContext(target=H100, backend="torch", device="cpu")
PARITY_CELLS = (("olmoe_1b_7b", "train_4k"), ("olmoe_1b_7b", "decode_32k"),
                ("phi3_5_moe_42b", "train_4k"))


def moe_cfg(arch, hints, package=None):
    """The reduced config in f32 (the port's, or the reference's with
    ``package`` = ``repro.configs``)."""
    cfg = (package.get_smoke(arch) if package else get_smoke(arch))
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32",
                               moe_shard_hints=hints)


def block_inputs(cfg, seq):
    """Seeded numpy leaves of one MoE block (the reference's shapes and
    std), its input x (B, seq, D) and a cotangent for the backward."""
    rng = np.random.default_rng(seq)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts

    def normal(shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    leaves = {"router": normal((D, E), D ** -0.5),
              "w_gate": normal((E, D, F), D ** -0.5),
              "w_up": normal((E, D, F), D ** -0.5),
              "w_down": normal((E, F, D), F ** -0.5)}
    return leaves, normal((B, seq, D), 1.0), normal((B, seq, D), 1.0)


def trainer_configs(cfg):
    return (AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS),
            TrainConfig(steps=STEPS, ctx=CPU, n_groups=GROUPS, log_every=0),
            DataConfig(batch_size=B, seq_len=L, vocab_size=cfg.vocab_size))


_RANK_CODE = textwrap.dedent('''
    import os, sys, torch
    import torch.distributed as dist
    sys.path.insert(0, os.environ["TEST_DIR"])
    from test_torch_moe_mesh import (BLOCK_CASES, GROUPS, MESH,
                                     block_inputs, moe_cfg, trainer_configs)
    from repro_torch import dtensors
    from repro_torch.analysis.roofline import CostMode
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as M, sharding as shd, spmd
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import Trainer
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    out_dir = sys.argv[1]
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo")
    mesh = make_host_mesh(*MESH, device_type="cpu")
    out = {"block": {}, "moves": {}}

    def calls(cost):
        got = {}
        for kind, _ in cost.collectives:
            got[kind] = got.get(kind, 0) + 1
        return got

    # (a) the block
    specs = shd._moe_specs()
    for arch, (name, spec, seq) in BLOCK_CASES:
        for hints in (False, True):
            cfg = moe_cfg(arch, hints)
            leaves, x, cot = block_inputs(cfg, seq)
            with torch.device("meta"):
                block = M.MoE(cfg)
            for leaf, a in leaves.items():
                block._parameters[leaf] = torch.nn.Parameter(
                    shd.NamedSharding(mesh, specs[leaf]).place(
                        torch.from_numpy(a)))
            xs = shd.NamedSharding(mesh, shd.P(*spec))
            xd = xs.place(torch.from_numpy(x)).requires_grad_()
            cost = CostMode(counts_only=True)
            with cost, spmd.replicate_plain(xd):
                y, aux = M.moe_block(block, xd, cfg, n_groups=GROUPS)
                loss = (y * xs.place(torch.from_numpy(cot))).sum() + aux
                loss.backward()
            out["block"][f"{arch}/{hints}/{name}/{seq}"] = {
                "out": y.full_tensor().detach(),
                "aux": aux.full_tensor().detach(),
                "placements": str(y.placements),
                "calls": calls(cost)}
    # the layout moves: values, and gradients of a cotangent
    src = torch.arange(4 * 8 * 8, dtype=torch.float32).reshape(4, 8, 8)
    wt = torch.randn(4, 8, 8, generator=torch.Generator().manual_seed(0))
    for label, start, move in (
            ("all_to_all", (Shard(0), Shard(0)),
             lambda t: dtensors.all_to_all(t, 1, 2)),
            ("chunk", (Shard(1), Replicate()),
             lambda t: dtensors.chunk(t, 1, 1)),
            ("gather", (Shard(1), Shard(1)),
             lambda t: dtensors.gather(t, 1))):
        t = distribute_tensor(src, mesh, start,
                              src_data_rank=None).requires_grad_()
        cost = CostMode(counts_only=True)
        with cost:
            moved = move(t)
            moved.backward(distribute_tensor(wt, mesh, moved.placements,
                                             src_data_rank=None))
        out["moves"][label] = {
            "value": moved.full_tensor().detach(),
            "grad": t.grad.redistribute(mesh, start).full_tensor(),
            "placements": str(moved.placements), "calls": calls(cost)}
    # (b) the mesh trainer with the hints
    cfg = moe_cfg("olmoe_1b_7b", True)
    ocfg, tcfg, dcfg = trainer_configs(cfg)
    trainer = Trainer(cfg, ocfg, tcfg, dcfg, mesh=mesh)
    trainer.init(0)
    named = dict(trainer.params.named_parameters())
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
    out["train"] = {
        "loss0": loss0.detach(), "grads": grads, "hist": hist,
        "final": {n: p.full_tensor().detach() for n, p in
                  trainer.params.named_parameters()},
        "collectives": trainer.collectives,
        "argument_bytes": argument_bytes((trainer.params,
                                          trainer.opt_state, batch))}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
''')

_PARITY_CODE = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["REPRO_UNROLL_SCANS"] = "0"
    which, cells = sys.argv[1], json.loads(sys.argv[2])
    keep = ("bytes_per_device", "collectives", "status", "chips", "mesh")
    ov = {"_n_layers": 2, "moe_shard_hints": True}
    out = {}
    if which == "ref":
        import jax
        from jax.sharding import AxisType
        from repro.launch import dryrun as jdr
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        for arch, shape in cells:
            r = jdr.run_cell(arch, shape, mesh=mesh, save=False,
                             verbose=False, overrides=ov)
            out[arch + "/" + shape] = {k: r[k] for k in keep}
    else:
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_host_mesh
        with dr.fake_group(4):
            tmesh = make_host_mesh(2, 2, device_type="cpu")
            for arch, shape in cells:
                r = dr.run_cell(arch, shape, mesh=tmesh, save=False,
                                verbose=False, overrides=ov)
                out[arch + "/" + shape] = dict(
                    {k: r[k] for k in keep}, calls=r["collective_calls"])
    print("PARITY " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two dry runs (the reference's and the port's, a subprocess
    each) and the 4 ranks, started together."""
    out = tmp_path_factory.mktemp("moe_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    dry = {which: subprocess.Popen(
        [sys.executable, "-c", _PARITY_CODE, which,
         json.dumps(PARITY_CELLS)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for which in ("ref", "port")}
    parity = {}
    try:
        _run_ranks([sys.executable, "-c", _RANK_CODE], str(out))
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(4)]
        for which, proc in dry.items():
            stdout, stderr = proc.communicate(timeout=600)
            line = [x for x in stdout.splitlines()
                    if x.startswith("PARITY ")]
            assert line, stdout[-2000:] + stderr[-4000:]
            parity[which] = json.loads(line[0][len("PARITY "):])
    finally:
        for proc in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"ranks": ranks, "parity": parity}


def _reference_block(arch, seq):
    import jax.numpy as jnp

    from repro import configs as jc
    from repro.models import moe as JM

    jcfg = moe_cfg(arch, False, jc)
    leaves, x, _ = block_inputs(jcfg, seq)
    out, aux = JM.moe_block({k: jnp.asarray(v) for k, v in leaves.items()},
                            jnp.asarray(x), jcfg, n_groups=GROUPS)
    return np.asarray(out), float(aux)


@pytest.mark.parametrize("hints", (False, True), ids=("free", "hints"))
@pytest.mark.parametrize("arch,layout", BLOCK_CASES,
                         ids=lambda c: c if isinstance(c, str)
                         else f"{c[0]}-L{c[2]}")
def test_mesh_block_equals_the_reference(runs, arch, layout, hints):
    name, spec, seq = layout
    want, want_aux = _reference_block(arch, seq)
    for rec in runs["ranks"]:
        got = rec["block"][f"{arch}/{hints}/{name}/{seq}"]
        err = float(np.abs(got["out"].numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (got["placements"],
                                                          err)
        assert float(got["aux"]) == pytest.approx(want_aux, rel=1e-5,
                                                  abs=1e-6)
        calls = got["calls"]
        if hints:
            assert calls.get("all-to-all", 0) > 0, calls
        else:
            assert "all-to-all" not in calls, calls
        if name == "batch":  # what gloo runs on card tensors
            assert "all-gather" not in calls, calls


@pytest.mark.parametrize("label", ("all_to_all", "chunk", "gather"))
def test_layout_moves_keep_values_and_gradients(runs, label):
    """Each move is the identity on the global value, and its gradient
    the cotangent, whatever the layout; each issues its one collective
    kind (a chunk none forward)."""
    src = torch.arange(4 * 8 * 8, dtype=torch.float32).reshape(4, 8, 8)
    wt = torch.randn(4, 8, 8, generator=torch.Generator().manual_seed(0))
    kinds = {"all_to_all": {"all-to-all": 2}, "chunk": {"all-reduce": 1},
             "gather": {"all-reduce": 1}}[label]
    for rec in runs["ranks"]:
        got = rec["moves"][label]
        assert torch.equal(got["value"], src)
        assert torch.equal(got["grad"], wt)
        assert got["calls"] == kinds, got


def test_layout_moves_refuse_an_uneven_or_outer_split():
    """A move splits or joins equal chunks along the innermost mesh dim
    sharding the dim; anything else raises before any wire."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import dtensors
    from repro_torch.launch.mesh import make_host_mesh

    with dr.fake_group(4):
        mesh = make_host_mesh(*MESH, device_type="cpu")
        with FakeTensorMode():
            uneven = distribute_tensor(torch.empty(4, 6, 8), mesh,
                                       (Shard(1), Replicate()),
                                       src_data_rank=None)
            with pytest.raises(ValueError, match="evenly"):
                dtensors.chunk(uneven, 1, 1)
            outer = distribute_tensor(torch.empty(4, 8, 8), mesh,
                                      (Shard(0), Shard(0)),
                                      src_data_rank=None)
            with pytest.raises(ValueError, match="innermost"):
                dtensors.all_to_all(outer, 0, 2)
            with pytest.raises(ValueError, match="innermost"):
                dtensors.gather(outer, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_hints_change_nothing_on_one_device(arch):
    """On plain tensors the hints are no-ops: output, aux and gradients
    bit for bit (``with_sharding_constraint`` changes no value)."""
    runs_ = []
    for hints in (False, True):
        cfg = moe_cfg(arch, hints)
        leaves, x, cot = block_inputs(cfg, 16)
        with torch.device("meta"):
            block = M.MoE(cfg)
        block.load_state_dict({k: torch.from_numpy(v)
                               for k, v in leaves.items()}, assign=True)
        xt = torch.from_numpy(x).requires_grad_()
        out, aux = M.moe_block(block, xt, cfg, n_groups=GROUPS)
        ((out * torch.from_numpy(cot)).sum() + aux).backward()
        runs_.append([out.detach(), aux.detach(), xt.grad] +
                     [p.grad for p in block.parameters()])
    for a, b in zip(*runs_):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def single():
    """The single-device trainer at the mesh's ``n_groups``."""
    cfg = moe_cfg("olmoe_1b_7b", True)
    ocfg, tcfg, dcfg = trainer_configs(cfg)
    trainer = Trainer(cfg, ocfg, tcfg, dcfg)
    trainer.init(0)
    batch = trainer.place_batch(trainer.source.batch(0))
    total, _ = T.loss_fn(trainer.params, cfg, batch, ctx=CPU,
                         n_groups=GROUPS)
    total.backward()
    grads = {n: p.grad.clone() for n, p in trainer.params.named_parameters()}
    for p in trainer.params.parameters():
        p.grad = None
    hist = trainer.run()
    count = dr.count_train_step(
        cfg, MESH, {"tokens": torch.as_tensor(trainer.source.batch(0)
                                               ["tokens"])}, tcfg, ocfg)
    return {"loss0": float(total.detach()), "grads": grads, "hist": hist,
            "final": {n: p.detach().clone() for n, p in
                      trainer.params.named_parameters()},
            "count": count}


def test_mesh_trainer_first_step_matches_one_device(runs, single):
    for rec in runs["ranks"]:
        got = rec["train"]
        assert float(got["loss0"]) == pytest.approx(single["loss0"],
                                                    rel=1e-5)
        for name, g in single["grads"].items():
            scale = float(g.abs().max())
            err = float((got["grads"][name] - g).abs().max())
            assert err <= 1e-5 * max(scale, 1e-30), (name, err, scale)


def test_mesh_trainer_steps_match_one_device(runs, single):
    for rec in runs["ranks"]:
        got = rec["train"]
        assert got["hist"]["step"] == list(range(STEPS))
        np.testing.assert_allclose(got["hist"]["loss"],
                                   single["hist"]["loss"], rtol=1e-5)
        for name, p in single["final"].items():
            err = float((got["final"][name] - p).abs().max())
            assert err <= 2 * LR * STEPS, (name, err)


def test_mesh_trainer_wire_and_argument_bytes_equal_the_dry_run(runs,
                                                                single):
    count = single["count"]
    assert count["calls"]["all-to-all"] > 0
    assert "all-gather" not in count["calls"]  # gloo on card tensors
    for rec in runs["ranks"]:
        got = rec["train"]
        assert got["collectives"] == [count["collectives"]] * STEPS
        assert got["argument_bytes"] == count["argument_bytes"]


@pytest.mark.parametrize("arch,shape", PARITY_CELLS)
def test_run_cell_with_hints_argument_bytes_are_the_reference(runs, arch,
                                                              shape):
    key = f"{arch}/{shape}"
    ref, port = runs["parity"]["ref"][key], runs["parity"]["port"][key]
    assert port["status"] == ref["status"] == "ok"
    assert port["chips"] == 4 and port["mesh"] == "2x2"
    assert port["bytes_per_device"]["argument_bytes"] == \
        ref["bytes_per_device"]["argument_bytes"]
    assert port["calls"]["all-to-all"] > 0
    print(json.dumps({"cell": key, "wire_bytes_port_ref": {
        k: (port["collectives"][k], ref["collectives"][k])
        for k in ref["collectives"]}}))


def test_block_keeps_the_plain_path_of_one_device():
    """The block's value on plain tensors is the reference's (the mesh
    path shares ``_route``): f32 smoke OLMoE at L 16, 1e-5."""
    cfg = moe_cfg("olmoe_1b_7b", False)
    leaves, x, _ = block_inputs(cfg, 16)
    with torch.device("meta"):
        block = M.MoE(cfg)
    block.load_state_dict({k: torch.from_numpy(v) for k, v in leaves.items()},
                          assign=True)
    with torch.no_grad():
        out, aux = M.moe_block(block, torch.from_numpy(x), cfg,
                               n_groups=GROUPS)
    want, want_aux = _reference_block("olmoe_1b_7b", 16)
    assert float(np.abs(out.numpy() - want).max()) <= \
        1e-5 * float(np.abs(want).max())
    assert float(aux) == pytest.approx(want_aux, rel=1e-5)


def test_launcher_takes_the_hints_and_the_groups():
    """``launch/train.py --moe-shard-hints --moe-groups 4`` on one device:
    the config's hints on (a no-op there) and the mesh's 4 dispatch groups
    in place of gcd(batch x seq, 1)."""
    from repro_torch.launch import train as launch_train

    argv = ["--arch", "olmoe_1b_7b", "--smoke", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "8"]
    plain, _ = launch_train.train(argv)
    trainer, hist = launch_train.train(argv + ["--moe-shard-hints",
                                               "--moe-groups", "4"])
    assert not plain.model_cfg.moe_shard_hints
    assert plain.train_cfg.n_groups == 1
    assert trainer.model_cfg.moe_shard_hints
    assert trainer.train_cfg.n_groups == 4
    assert np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 1
