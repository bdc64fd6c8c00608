"""The mamba block on a device mesh (``repro_torch.models.ssm`` on
DTensors) against the reference, one device and the dry run's count.

(a) ``mamba_block`` (with and without a state) and ``mamba_decode_step``
on 4 gloo ranks of a (data 2, model 2) and a (data 1, model 4) CPU mesh:
the reduced Jamba-1.5 config in f32, the reference's parameters
(``repro.models.ssm.init_mamba``) carried across with ``convert``, the
same numpy inputs at L 40 (two chunks of 16 and a ragged one). Each
output and new state within 1e-5 of its largest |value| of the
reference's functions (JAX); the mamba leaves' gradients within 1e-5 of
one device's; both in the trainer's layout (batch on ``data``) and in the
dry run's sequence-sharded one; in the trainer's layout no all-gather
(gloo cannot run one on card tensors) and the x/z split an all-to-all.

(b) The mesh trainer on the reduced Jamba cut to one pattern unit (seven
mamba blocks, an attention block, MoE FFNs) in f32 on (2, 2) against one
device at the mesh's 4 dispatch groups: the first step's loss and every
gradient within 1e-5, the losses of 2 AdamW steps within 1e-5 relative,
every parameter within 2 x lr x steps, each step's wire bytes by kind and
the argument bytes equal to ``dryrun.count_train_step``'s. ``Trainer.init``
on the mesh places each parameter as it is made and makes the moments on
the placed leaves: every rank's chunks bit-equal to one device's
``init_params`` with the same seed, the moments zero in the parameters'
placements.

(c) ``run_cell``'s per-device argument bytes equal the reference's
exactly on 2 x 2 at one pattern unit (``_n_layers`` 8) for ``train_4k``
and ``decode_32k``, at the reduced widths (the reference's lowering of
Jamba at published widths takes minutes: ``tests/dryrun_parity.py --arch
jamba_1_5_large --layers 8`` prints that pair); wire bytes by kind
printed beside the reference's. And the recurrent extrapolation
(``dryrun._extrapolate_cell``: R = 1 and 2 to R = 3) equals a direct run
at 24 layers on every additive cost.

The ranks, the two dry runs and the extrapolation are subprocesses,
started together and joined under a time limit."""

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
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.ops import ExecutionContext
from repro_torch.plan import H100
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer
from test_torch_mesh_train import _run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "jamba_1_5_large"
MESHES = ((2, 2), (1, 4))
# (name, x spec): the trainer's layout and the dry run's sequence-sharded
LAYOUTS = (("batch", ("data", None, None)),
           ("sequence", ("data", "model", None)))
B, L, SEQ, STEPS, LR = 4, 16, 40, 2, 1e-3
GROUPS = 4  # the mesh's MoE dispatch groups, also on one device
CPU = ExecutionContext(target=H100, backend="torch", device="cpu")
PARITY_CELLS = ("train_4k", "decode_32k")
EXTRAPOLATED = ("train_4k",)
EXTRAPOLATED_KEYS = ("hlo_flops", "hlo_bytes", "wire_bytes_per_chip")


def jamba_cfg(package=None, layers=8):
    """The reduced Jamba config in f32 cut to ``layers`` (the port's, or
    the reference's with ``package`` = ``repro.configs``)."""
    cfg = package.get_smoke(ARCH) if package else get_smoke(ARCH)
    return dataclasses.replace(cfg, n_layers=layers, param_dtype="float32",
                               compute_dtype="float32")


def block_inputs(cfg):
    """Seeded numpy x (B, L, D), a start state, and the cotangents of the
    output and the new state."""
    rng = np.random.default_rng(7)
    H, ph = ssm._heads(cfg)
    K, di, S = cfg.conv_kernel, cfg.d_inner, cfg.ssm_state_dim

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"x": normal(B, SEQ, cfg.d_model), "h": normal(B, H, ph, S),
            "tail": normal(B, K - 1, di), "cot": normal(B, SEQ, cfg.d_model),
            "cot_h": normal(B, H, ph, S), "cot_tail": normal(B, K - 1, di)}


def trainer_configs(cfg):
    return (AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS),
            TrainConfig(steps=STEPS, ctx=CPU, n_groups=GROUPS, log_every=0),
            DataConfig(batch_size=B, seq_len=L, vocab_size=cfg.vocab_size))


def plain_block(leaves, inp, with_state: bool):
    """One device's block, prefill (with or without a state) and decode:
    outputs, new states and the leaves' gradients."""
    cfg = jamba_cfg()
    with torch.device("meta"):
        mod = ssm.Mamba(cfg)
    mod.load_state_dict({k: torch.tensor(v) for k, v in leaves.items()},
                        assign=True)
    x = torch.from_numpy(inp["x"])
    state = ((torch.from_numpy(inp["h"]), torch.from_numpy(inp["tail"]))
             if with_state else None)
    y, new = ssm.mamba_block(mod, x, cfg, state, ctx=CPU)
    loss = (y * torch.from_numpy(inp["cot"])).sum()
    if new is not None:
        loss = loss + (new[0] * torch.from_numpy(inp["cot_h"])).sum() + \
            (new[1] * torch.from_numpy(inp["cot_tail"])).sum()
    loss.backward()
    return y.detach(), new, {n: p.grad for n, p in mod.named_parameters()}


_RANK_CODE = textwrap.dedent('''
    import datetime, os, sys, torch
    import numpy as np
    import torch.distributed as dist
    sys.path.insert(0, os.environ["TEST_DIR"])
    from test_torch_mamba_mesh import (CPU, GROUPS, LAYOUTS, MESHES,
                                       block_inputs, jamba_cfg,
                                       trainer_configs)
    from repro_torch.analysis.roofline import CostMode
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as shd, spmd, ssm
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import Trainer, shardings_for
    torch.set_num_threads(1)  # four ranks share the host's cores
    out_dir = sys.argv[1]
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=120))
    cfg = jamba_cfg()
    leaves = params_from_jax(dict(np.load(os.path.join(out_dir,
                                                       "mamba.npz"))), "cpu")
    inp = {k: torch.from_numpy(v) for k, v in block_inputs(cfg).items()}
    specs = shd._mamba_specs()
    out = {"block": {}, "decode": {}}

    def calls(cost):
        got = {}
        for kind, _ in cost.collectives:
            got[kind] = got.get(kind, 0) + 1
        return got

    def full(t):
        return t.full_tensor().detach()

    # (a) the block and its decode step
    for shape in MESHES:
        mesh = make_host_mesh(*shape, device_type="cpu")
        with torch.device("meta"):
            block = ssm.Mamba(cfg)
        for leaf, a in leaves.items():
            block._parameters[leaf] = torch.nn.Parameter(
                shd.NamedSharding(mesh, specs[leaf]).place(a.clone()))

        def place(spec, t):
            return shd.NamedSharding(mesh, shd.P(*spec)).place(t.clone())

        def state():  # the cache's placements (sharding.cache_specs)
            return (place(("data", "model", None, None), inp["h"]),
                    place(("data", None, "model"), inp["tail"]))

        for name, spec in LAYOUTS:
            for with_state in (False, True):
                x = place(spec, inp["x"]).requires_grad_()
                for p in block.parameters():
                    p.grad = None
                cost = CostMode(counts_only=True)
                with cost, spmd.replicate_plain(x):
                    y, new = ssm.mamba_block(block, x, cfg,
                                             state() if with_state else None,
                                             ctx=CPU)
                    loss = (y * place(spec, inp["cot"])).sum()
                    if new is not None:
                        loss = loss + (new[0] * place(
                            ("data", "model", None, None),
                            inp["cot_h"])).sum() + (new[1] * place(
                                ("data", None, "model"),
                                inp["cot_tail"])).sum()
                    loss.backward()
                grads = {n: full(spmd.like(p.grad, p))
                         for n, p in block.named_parameters()}
                out["block"][f"{shape}/{name}/{with_state}"] = {
                    "out": full(y), "placements": str(y.placements),
                    "state": None if new is None else [full(t) for t in new],
                    "state_placements": None if new is None else
                    [str(t.placements) for t in new],
                    "grads": grads, "calls": calls(cost)}
        with torch.no_grad():
            x = place(("data", None, None), inp["x"][:, :1])
            cost = CostMode(counts_only=True)
            with cost, spmd.replicate_plain(x):
                y, new = ssm.mamba_decode_step(block, x, cfg, state(),
                                               ctx=CPU)
            out["decode"][str(shape)] = {
                "out": full(y), "state": [full(t) for t in new],
                "calls": calls(cost)}
    # (b) the mesh trainer: init placed as made, then 2 steps
    tcfg = jamba_cfg(layers=8)
    ocfg, trcfg, dcfg = trainer_configs(tcfg)
    mesh = make_host_mesh(2, 2, device_type="cpu")
    trainer = Trainer(tcfg, ocfg, trcfg, dcfg, mesh=mesh)
    trainer.init(0)
    whole = T.init_params(tcfg, seed=0, device="cpu")
    pspecs = shardings_for(tcfg, mesh)
    named = dict(trainer.params.named_parameters())
    out["init"] = {
        "names": list(named) == [n for n, _ in whole.named_parameters()],
        "bit_equal": all(
            torch.equal(named[n].to_local(),
                        w.detach()[pspecs[n].local_slices(w.shape)])
            and named[n].placements == pspecs[n].placements
            for n, w in whole.named_parameters()),
        "moments_zero": all(
            float(t.to_local().abs().max()) == 0.0 and
            t.placements == named[n].placements and t.dtype == torch.float32
            for tree in (trainer.opt_state.m, trainer.opt_state.v)
            for n, t in tree.items()),
        "owned": all(
            p.to_local().untyped_storage().nbytes()
            == p.to_local().numel() * p.to_local().element_size()
            for p in named.values())}
    del whole
    batch = trainer.place_batch(trainer.source.batch(0))
    with spmd.replicate_plain(trainer.params.head):
        total, _ = T.loss_fn(trainer.params, tcfg, batch, ctx=CPU,
                             n_groups=GROUPS)
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

_DRY_CODE = textwrap.dedent('''
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["REPRO_UNROLL_SCANS"] = "0"
    which, arch, cells = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    keep = ("bytes_per_device", "collectives", "status", "chips", "mesh",
            "hlo_flops", "hlo_bytes", "wire_bytes_per_chip", "extrapolated",
            "n_layers")
    out = {}
    if which == "ref":
        import jax
        from jax.sharding import AxisType
        from repro import configs
        from repro.launch import dryrun as jdr
        jdr.get_config = lambda a: configs.get_smoke(a)
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        for shape in cells:
            r = jdr.run_cell(arch, shape, mesh=mesh, save=False,
                             verbose=False, overrides={"_n_layers": 8})
            out[shape] = {k: r[k] for k in keep if k in r}
    else:
        import torch
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_host_mesh
        layers = 24 if which == "extrapolate" else 8
        dr.get_config = lambda a: dataclasses.replace(
            configs.get_smoke(a), n_layers=layers)
        with dr.fake_group(4):
            tmesh = make_host_mesh(2, 2, device_type="cpu")
            for shape in cells:
                if which == "extrapolate":  # R = 1, 2 -> 3, then R = 3
                    runs = {"extrapolated": {}, "direct": {"_n_layers": 24}}
                else:
                    runs = {"port": {"_n_layers": 8}}
                for tag, ov in runs.items():
                    r = dr.run_cell(arch, shape, mesh=tmesh, save=False,
                                    verbose=False, overrides=ov)
                    out[shape + "/" + tag] = dict(
                        {k: r[k] for k in keep if k in r},
                        calls=r["collective_calls"], run_s=r["run_s"])
    print("DRY " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's mamba leaves (written for the ranks), then the 4
    ranks, the two dry runs and the extrapolation, started together."""
    import jax

    from repro import configs as jc
    from repro.models import ssm as jssm

    out = tmp_path_factory.mktemp("mamba_mesh")
    leaves = jssm.init_mamba(jax.random.PRNGKey(1), jamba_cfg(jc))
    np.savez(out / "mamba.npz", **{k: np.asarray(v)
                                   for k, v in leaves.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    cells = {"ref": PARITY_CELLS, "port": PARITY_CELLS,
             "extrapolate": EXTRAPOLATED}
    dry = {which: subprocess.Popen(
        [sys.executable, "-c", _DRY_CODE, which, ARCH, json.dumps(c)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for which, c in cells.items()}
    got = {}
    try:
        _run_ranks([sys.executable, "-c", _RANK_CODE], str(out))
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(4)]
        for which, proc in dry.items():
            stdout, stderr = proc.communicate(timeout=600)
            line = [x for x in stdout.splitlines() if x.startswith("DRY ")]
            assert line, stdout[-2000:] + stderr[-4000:]
            got[which] = json.loads(line[0][len("DRY "):])
    finally:
        for proc in dry.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"ranks": ranks, "dry": got,
            "leaves": {k: np.asarray(v) for k, v in leaves.items()}}


_REFERENCE = {}


def _reference(leaves, with_state: bool):
    """The reference's block (prefill, with or without a state) and decode
    step on the same numpy inputs (computed once a case)."""
    if with_state not in _REFERENCE:
        _REFERENCE[with_state] = _reference_run(leaves, with_state)
    return _REFERENCE[with_state]


def _reference_run(leaves, with_state: bool):
    import jax.numpy as jnp

    from repro import configs as jc
    from repro.models import ssm as jssm

    jcfg = jamba_cfg(jc)
    inp = block_inputs(jcfg)
    p = {k: jnp.asarray(v) for k, v in leaves.items()}
    state = (jnp.asarray(inp["h"]), jnp.asarray(inp["tail"]))
    out, new = jssm.mamba_block(p, jnp.asarray(inp["x"]), jcfg,
                                state if with_state else None)
    dec, dnew = jssm.mamba_decode_step(p, jnp.asarray(inp["x"][:, :1]), jcfg,
                                       state)
    return (np.asarray(out), None if new is None else [np.asarray(t)
                                                         for t in new],
            np.asarray(dec), [np.asarray(t) for t in dnew])


def _close(got, want, tol=1e-5):
    got = got.numpy() if torch.is_tensor(got) else got
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("with_state", (False, True),
                         ids=("no_state", "state"))
@pytest.mark.parametrize("layout", [n for n, _ in LAYOUTS])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_block_equals_the_reference_and_one_device(runs, shape, layout,
                                                        with_state):
    want, want_state, _, _ = _reference(runs["leaves"], with_state)
    inp = block_inputs(jamba_cfg())
    _, _, grads = plain_block(runs["leaves"], inp, with_state)
    for rec in runs["ranks"]:
        got = rec["block"][f"{shape}/{layout}/{with_state}"]
        _close(got["out"], want)
        if with_state:
            for g, w in zip(got["state"], want_state):
                _close(g, w)
            # the new state lies as the cache's leaves do
            assert got["state_placements"] == [
                "(Shard(dim=0), Shard(dim=1))",
                "(Shard(dim=0), Shard(dim=2))"]
        for name, g in grads.items():
            _close(got["grads"][name], g.numpy())
        calls = got["calls"]
        assert calls.get("all-to-all", 0) == (2 if shape[1] > 1 else 0)
        if layout == "batch":  # what gloo runs on card tensors
            assert "all-gather" not in calls, calls


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_mesh_decode_step_equals_the_reference(runs, shape):
    _, _, want, want_state = _reference(runs["leaves"], True)
    for rec in runs["ranks"]:
        got = rec["decode"][str(shape)]
        _close(got["out"], want)
        for g, w in zip(got["state"], want_state):
            _close(g, w)
        assert "all-gather" not in got["calls"], got["calls"]
        assert got["calls"].get("all-to-all", 0) == 1


def test_split_columns_on_plain_tensors_is_slicing():
    """On one device the x/z split and the channel-local conv are the
    plain ops they stand for (the block's bits do not change)."""
    from repro_torch.models import spmd

    xz = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    x, z = spmd.split_columns(xz, 2)
    assert torch.equal(x, xz[..., :4]) and torch.equal(z, xz[..., 4:])
    assert x.data_ptr() == xz.data_ptr()  # a view, as before
    assert torch.equal(spmd.on_channels(torch.mul, x, z), x * z)


def test_column_exchange_sends_each_piece_to_its_owner():
    """The all-to-all's plan for every device of 2, 4 and 16 (the dry
    run's model axis): each piece leaves its holder once, lands on the
    device whose block it is, and the receivers' order is the parts'."""
    from repro_torch.dtensors import _piece_order

    parts = 2  # x and z
    for m in (2, 4, 16):
        sent = [0] * m
        for s in range(m):
            order, send, recv = _piece_order(s, m, parts)
            assert sorted(order) == list(range(parts))
            assert sum(send) == sum(recv) == parts
            dests = [(s * parts + q) % m for q in order]
            assert dests == sorted(dests)
            for d in range(m):
                sent[d] += send[d]
            sources = [(h * m + s) // parts for h in range(parts)]
            assert sources == sorted(sources)
            assert [sources.count(r) for r in range(m)] == recv
        assert sent == [parts] * m


@pytest.fixture(scope="module")
def single():
    """The single-device trainer at the mesh's dispatch groups, and the
    dry run's count of the same step on (2, 2)."""
    cfg = jamba_cfg(layers=8)
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
        cfg, (2, 2), {"tokens": torch.as_tensor(trainer.source.batch(0)
                                                 ["tokens"])}, tcfg, ocfg)
    return {"loss0": float(total.detach()), "grads": grads, "hist": hist,
            "final": {n: p.detach().clone() for n, p in
                      trainer.params.named_parameters()},
            "count": count}


def test_mesh_init_places_each_leaf_as_made(runs):
    for rec in runs["ranks"]:
        assert rec["init"] == {"names": True, "bit_equal": True,
                               "moments_zero": True, "owned": True}


def test_mesh_trainer_first_step_matches_one_device(runs, single):
    """The loss within 1e-5 relative; each gradient within 1e-5 of the
    largest |value| of its kind's gradients (the leaf's name over the
    unit's blocks: a mamba block's ``log_A`` sums B x L terms that cancel
    to about 1e-3 of their size, so on its own its largest value is no
    scale for f32 rounding in another order)."""
    kinds = {}
    for name, g in single["grads"].items():
        kind = name.split(".", 3)[-1] if name.startswith("layers.") else name
        kinds[kind] = max(kinds.get(kind, 0.0), float(g.abs().max()))
    for rec in runs["ranks"]:
        got = rec["train"]
        assert float(got["loss0"]) == pytest.approx(single["loss0"],
                                                    rel=1e-5)
        for name, g in single["grads"].items():
            kind = name.split(".", 3)[-1] if name.startswith("layers.") \
                else name
            err = float((got["grads"][name] - g).abs().max())
            assert err <= 1e-5 * max(kinds[kind], 1e-30), (name, err)


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
    assert count["calls"]["all-to-all"] > 0  # the x/z splits
    assert "all-gather" not in count["calls"]  # gloo on card tensors
    for rec in runs["ranks"]:
        got = rec["train"]
        assert got["collectives"] == [count["collectives"]] * STEPS
        assert got["argument_bytes"] == count["argument_bytes"]


@pytest.mark.parametrize("shape", PARITY_CELLS)
def test_run_cell_argument_bytes_are_the_reference(runs, shape):
    ref = runs["dry"]["ref"][shape]
    port = runs["dry"]["port"][shape + "/port"]
    assert port["status"] == ref["status"] == "ok"
    assert port["chips"] == 4 and port["mesh"] == "2x2"
    assert port["bytes_per_device"]["argument_bytes"] == \
        ref["bytes_per_device"]["argument_bytes"]
    print(json.dumps({"cell": f"{ARCH}/{shape}", "wire_bytes_port_ref": {
        k: (port["collectives"][k], ref["collectives"][k])
        for k in ref["collectives"]}}))


@pytest.mark.parametrize("shape", EXTRAPOLATED)
def test_extrapolation_equals_a_direct_run(runs, shape):
    """R = 1 and 2 extrapolated to R = 3 against 24 layers run: every
    additive cost is affine in R (relative 1e-9); temp bytes printed."""
    ext = runs["dry"]["extrapolate"][shape + "/extrapolated"]
    direct = runs["dry"]["extrapolate"][shape + "/direct"]
    assert ext["extrapolated"] == "R=1,2 -> R=3"
    assert direct["n_layers"] == 24
    pairs = [(k, ext[k], direct[k]) for k in EXTRAPOLATED_KEYS]
    pairs += [(f"collectives.{k}", ext["collectives"][k],
               direct["collectives"][k]) for k in direct["collectives"]]
    pairs += [(k, ext["bytes_per_device"][k], direct["bytes_per_device"][k])
              for k in ("argument_bytes", "output_bytes")]
    for key, a, b in pairs:
        assert a == pytest.approx(b, rel=1e-9, abs=1e-9), key
    print(json.dumps({"cell": f"{ARCH}/{shape}", "temp_bytes": (
        ext["bytes_per_device"]["temp_bytes"],
        direct["bytes_per_device"]["temp_bytes"])}))
