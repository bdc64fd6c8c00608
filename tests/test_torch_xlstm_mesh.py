"""The xLSTM blocks on a device mesh (``repro_torch.models.xlstm`` on
DTensors) against the reference, one device and the dry run's count, and
a checkpoint saved from a mesh.

(a) ``mlstm_block`` and ``slstm_block`` (with and without a state) and
both decode steps on 4 gloo ranks of a (data 2, model 2) and a (data 1,
model 4) CPU mesh: the reduced xLSTM-1.3B config in f32, seeded numpy
parameters in the reference's layout (biases non-zero) and the same
numpy inputs at L 40 (two mLSTM chunks of 16 and a ragged one). Each
output and new state within 1e-5 of its largest |value| of the
reference's functions (JAX) and of one device's; the leaves' gradients
within 1e-5 of one device's; in the trainer's layout (batch on
``data``) and, on (2, 2), in the dry run's sequence-sharded one; in the
trainer's layout no all-gather (gloo cannot run one on card tensors),
the sLSTM's z/i/f/o split an all-to-all each way, the mLSTM's state
moved to the heads and back by all-to-alls. The mLSTM with 2 heads on
(1, 4), where the heads do not divide ``model`` (xLSTM-1.3B's 4 heads on
the production mesh's 16), takes the gathered route: q/k/v whole on
every device.

(b) The mesh trainer on the reduced config cut to one (mlstm, slstm)
unit in f32 on (2, 2) against one device: the first step's loss and every
gradient within 1e-5 (of the largest |value| of its kind's gradients),
the losses of 2 AdamW steps within 1e-5 relative, every parameter within
2 x lr x steps, each step's wire bytes by kind and the argument bytes
equal to ``dryrun.count_train_step``'s.

(c) After the steps the 4 ranks save a checkpoint
(``Trainer.save_checkpoint``; rank 0 writes): its leaves made whole by
all-reduces, no all-gather counted (CPU gloo could run one; the route is
what gloo runs on card tensors); the reference's
``repro.train.checkpoint.restore`` and the port's read it bit-equal to
the gathered leaves, whose parameters are the trained ones.

(d) ``run_cell``'s per-device argument bytes equal the reference's
exactly on 2 x 2 at two pattern units (``_n_layers`` 4) for the four
cells, at the reduced widths (``tests/dryrun_parity.py --arch xlstm_1_3b
--layers 2`` prints the published widths' figures); wire bytes by kind
printed beside the reference's; the dry run's chunk the reference's. The
recurrent extrapolation (``dryrun._extrapolate_cell``: R = 1 and 2 to R =
3) equals a direct run at 6 layers on every additive cost.

The ranks and the dry runs (the reference's; the port's with the
extrapolation) are subprocesses, started together and joined under a
time limit."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import dryrun as dr
from repro_torch.models import xlstm as X
from repro_torch.models import transformer as T
from repro_torch.models.config import LM_SHAPES
from repro_torch.ops import ExecutionContext
from repro_torch.plan import H100
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer
from test_torch_mesh_train import _run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "xlstm_1_3b"
KINDS = ("mlstm", "slstm")
MESHES = ((2, 2), (1, 4))
# (name, x spec): the trainer's layout and the dry run's sequence-sharded
LAYOUTS = (("batch", ("data", None, None)),
           ("sequence", ("data", "model", None)))
# the layouts each mesh runs the blocks in
BLOCK_CASES = {(2, 2): ("batch", "sequence"), (1, 4): ("batch",)}
TRAIN_LAYERS = 2  # the mesh trainer's cut: one (mlstm, slstm) unit
# the mLSTM whose heads do not divide the model axis: 2 heads on (1, 4)
FEW_HEADS, FEW_HEADS_MESH = 2, (1, 4)
B, L, SEQ, STEPS, LR = 4, 16, 40, 2, 1e-3
CPU = ExecutionContext(target=H100, backend="torch", device="cpu")
DRY_CELLS = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
DRY_LAYERS = 4  # two (mlstm, slstm) units
EXTRAPOLATED = ("train_4k",)
EXTRAPOLATED_KEYS = ("hlo_flops", "hlo_bytes", "wire_bytes_per_chip")
# the cache's placements of each block's state leaves on (data, model)
STATE_SPECS = {"mlstm": (("data", None, "model", None),
                         ("data", None, "model")),
               "slstm": (("data", "model"), ("data", "model"))}


def xlstm_cfg(package=None, heads=None, layers=None):
    """The reduced xLSTM config in f32 (the port's, or the reference's with
    ``package`` = ``repro.configs``), with ``heads`` and ``layers`` if
    given."""
    cfg = package.get_smoke(ARCH) if package else get_smoke(ARCH)
    kw = dict(param_dtype="float32", compute_dtype="float32")
    if heads:
        kw["n_heads"] = heads
    if layers:
        kw["n_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def state_shapes(kind, cfg):
    H, hd, D = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_model
    return (((B, H, hd, hd), (B, H, hd)) if kind == "mlstm"
            else ((B, D), (B, D)))


def block_inputs(kind, cfg):
    """Seeded numpy x (B, SEQ, D), a start state, and the cotangents of
    the output and of the new state."""
    rng = np.random.default_rng(7)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    s0, s1 = state_shapes(kind, cfg)
    return {"x": normal(B, SEQ, cfg.d_model), "s0": normal(*s0, scale=0.5),
            "s1": normal(*s1, scale=0.5), "cot": normal(B, SEQ, cfg.d_model),
            "cot0": normal(*s0), "cot1": normal(*s1)}


def block_leaves(kind, heads=None):
    """Seeded numpy leaves of one ``kind`` block at the reduced widths, in
    the reference's layout (``init_mlstm``/``init_slstm``): weights
    N(0, 1/D), biases N(0, 1) (the reference initializes them to zero)."""
    cfg = xlstm_cfg(heads=heads)
    with torch.device("meta"):
        mod = (X.MLSTM if kind == "mlstm" else X.SLSTM)(cfg)
    rng = np.random.default_rng(3)
    return {n: (rng.standard_normal(p.shape) * (
        1.0 if n.startswith("b_") else cfg.d_model ** -0.5)).astype(
            np.float32) for n, p in mod.named_parameters()}


def trainer_configs(cfg):
    return (AdamWConfig(lr=LR, warmup_steps=1, total_steps=STEPS),
            TrainConfig(steps=STEPS, ctx=CPU, log_every=0),
            DataConfig(batch_size=B, seq_len=L, vocab_size=cfg.vocab_size))


def plain_block(kind, leaves, inp, with_state: bool, heads=None):
    """One device's block (prefill, with or without a state): its output,
    new state and the leaves' gradients."""
    cfg = xlstm_cfg(heads=heads)
    with torch.device("meta"):
        mod = (X.MLSTM if kind == "mlstm" else X.SLSTM)(cfg)
    mod.load_state_dict({k: torch.tensor(v) for k, v in leaves.items()},
                        assign=True)
    block = X.mlstm_block if kind == "mlstm" else X.slstm_block
    state = ((torch.from_numpy(inp["s0"]), torch.from_numpy(inp["s1"]))
             if with_state else None)
    y, new = block(mod, torch.from_numpy(inp["x"]), cfg, state, ctx=CPU)
    loss = (y * torch.from_numpy(inp["cot"])).sum()
    if new is not None:
        loss = loss + (new[0] * torch.from_numpy(inp["cot0"])).sum() + \
            (new[1] * torch.from_numpy(inp["cot1"])).sum()
    loss.backward()
    return y.detach(), new, {n: p.grad for n, p in mod.named_parameters()}


_RANK_CODE = textwrap.dedent('''
    import datetime, os, sys, torch
    import numpy as np
    import torch.distributed as dist
    sys.path.insert(0, os.environ["TEST_DIR"])
    from test_torch_xlstm_mesh import (BLOCK_CASES, CPU, FEW_HEADS,
                                       FEW_HEADS_MESH, KINDS, LAYOUTS,
                                       STATE_SPECS, STEPS, TRAIN_LAYERS,
                                       block_inputs, trainer_configs,
                                       xlstm_cfg)
    from repro_torch.analysis.roofline import CostMode
    from repro_torch.convert import params_from_jax, tree_from_named
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as shd, spmd, xlstm as X
    from repro_torch.models import transformer as T
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer
    torch.set_num_threads(1)  # four ranks share the host's cores
    out_dir = sys.argv[1]
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=120))
    specs = {"mlstm": shd._mlstm_specs(), "slstm": shd._slstm_specs()}
    fns = {"mlstm": (X.MLSTM, X.mlstm_block, X.mlstm_decode_step),
           "slstm": (X.SLSTM, X.slstm_block, X.slstm_decode_step)}
    out = {"block": {}, "decode": {}}

    def calls(cost):
        got = {}
        for kind, _ in cost.collectives:
            got[kind] = got.get(kind, 0) + 1
        return got

    def full(t):
        return t.full_tensor().detach()

    def run(kind, shape, layouts, heads=None):
        cfg = xlstm_cfg(heads=heads)
        inp = {k: torch.from_numpy(v)
               for k, v in block_inputs(kind, cfg).items()}
        leaves = params_from_jax(dict(np.load(os.path.join(
            out_dir, f"{kind}{heads or ''}.npz"))), "cpu")
        mesh = make_host_mesh(*shape, device_type="cpu")
        module, block_fn, decode_fn = fns[kind]
        with torch.device("meta"):
            block = module(cfg)
        for leaf, a in leaves.items():
            block._parameters[leaf] = torch.nn.Parameter(
                shd.NamedSharding(mesh, specs[kind][leaf]).place(a.clone()))

        def place(spec, t):
            return shd.NamedSharding(mesh, shd.P(*spec)).place(t.clone())

        def state(names=("s0", "s1")):  # the cache's placements
            return tuple(place(s, inp[n])
                         for s, n in zip(STATE_SPECS[kind], names))

        tag = f"{kind}{heads or ''}/{shape}"
        for name, spec in layouts:
            for with_state in (False, True):
                x = place(spec, inp["x"]).requires_grad_()
                for p in block.parameters():
                    p.grad = None
                cost = CostMode(counts_only=True)
                with cost, spmd.replicate_plain(x):
                    y, new = block_fn(block, x, cfg,
                                      state() if with_state else None,
                                      ctx=CPU)
                    loss = (y * place(spec, inp["cot"])).sum()
                    if new is not None:
                        cots = state(("cot0", "cot1"))
                        loss = loss + (new[0] * cots[0]).sum() + \\
                            (new[1] * cots[1]).sum()
                    loss.backward()
                grads = {n: full(spmd.like(p.grad, p))
                         for n, p in block.named_parameters()}
                out["block"][f"{tag}/{name}/{with_state}"] = {
                    "out": full(y),
                    "state": None if new is None else [full(t) for t in new],
                    "state_placements": None if new is None else
                    [str(t.placements) for t in new],
                    "grads": grads, "calls": calls(cost)}
        with torch.no_grad():
            x = place(("data", None, None), inp["x"][:, :1])
            cost = CostMode(counts_only=True)
            with cost, spmd.replicate_plain(x):
                y, new = decode_fn(block, x, cfg, state(), ctx=CPU)
            out["decode"][tag] = {
                "out": full(y), "state": [full(t) for t in new],
                "state_placements": [str(t.placements) for t in new],
                "calls": calls(cost)}

    # (a) the blocks and their decode steps
    for shape, layouts in BLOCK_CASES.items():
        for kind in KINDS:
            run(kind, shape, [(n, dict(LAYOUTS)[n]) for n in layouts])
    run("mlstm", FEW_HEADS_MESH, LAYOUTS[:1], heads=FEW_HEADS)
    # (b) the mesh trainer, then (c) its checkpoint
    tcfg = xlstm_cfg(layers=TRAIN_LAYERS)
    ocfg, trcfg, dcfg = trainer_configs(tcfg)
    trcfg.ckpt_dir = os.path.join(out_dir, "ckpt")
    mesh = make_host_mesh(2, 2, device_type="cpu")
    trainer = Trainer(tcfg, ocfg, trcfg, dcfg, mesh=mesh)
    trainer.init(0)
    named = dict(trainer.params.named_parameters())
    batch = trainer.place_batch(trainer.source.batch(0))
    with spmd.replicate_plain(trainer.params.head):
        total, _ = T.loss_fn(trainer.params, tcfg, batch, ctx=CPU)
        total.backward()
        loss0 = total.full_tensor()
        grads = {n: spmd.like(p.grad, p).full_tensor()
                 for n, p in named.items()}
    for p in named.values():
        p.grad = None
    hist = trainer.run()
    final = {n: p.full_tensor().detach() for n, p in
             trainer.params.named_parameters()}
    out["train"] = {
        "loss0": loss0.detach(), "grads": grads, "hist": hist,
        "final": final, "collectives": trainer.collectives,
        "argument_bytes": argument_bytes((trainer.params,
                                          trainer.opt_state, batch))}
    tree = trainer.save_checkpoint(STEPS)
    leaves = dict(ckpt._flatten_with_paths(tree))
    out["ckpt"] = {"collectives": trainer.state_collectives,
                   "params_are_trained": all(
                       torch.equal(a, b) for a, b in zip(
                           (t for k, t in leaves.items()
                            if k.startswith("params/")),
                           (t for _, t in ckpt._flatten_with_paths(
                               {"params": tree_from_named(final)}))))}
    if rank == 0:
        torch.save(leaves, os.path.join(out_dir, "gathered.pt"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
''')

_DRY_CODE = textwrap.dedent('''
    import dataclasses, json, os, sys
    # 4 host devices; XLA on one thread, beside the ranks
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false "
                               "intra_op_parallelism_threads=1")
    os.environ["REPRO_UNROLL_SCANS"] = "0"
    which, arch, cells = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    layers, extrapolated = int(sys.argv[4]), json.loads(sys.argv[5])
    keep = ("bytes_per_device", "collectives", "status", "chips", "mesh",
            "hlo_flops", "hlo_bytes", "wire_bytes_per_chip", "extrapolated",
            "n_layers", "chunk_size")
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
                             verbose=False, overrides={"_n_layers": layers})
            out[shape] = {k: r[k] for k in keep if k in r}
    else:
        import torch
        torch.set_num_threads(1)
        from repro_torch import configs
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_host_mesh
        deep = 3 * layers // 2  # three pattern units

        def cell(shape, tag, n_layers, ov):
            dr.get_config = lambda a: dataclasses.replace(
                configs.get_smoke(a), n_layers=n_layers)
            r = dr.run_cell(arch, shape, mesh=tmesh, save=False,
                            verbose=False, overrides=ov)
            out[shape + "/" + tag] = dict(
                {k: r[k] for k in keep if k in r},
                calls=r["collective_calls"], run_s=r["run_s"])

        with dr.fake_group(4):
            tmesh = make_host_mesh(2, 2, device_type="cpu")
            for shape in cells:
                cell(shape, "port", layers, {"_n_layers": layers})
            for shape in extrapolated:  # R = 1, 2 -> 3, then R = 3
                cell(shape, "extrapolated", deep, {})
                cell(shape, "direct", deep, {"_n_layers": deep})
    print("DRY " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def dry_procs():
    """The dry runs (the reference's cells; the port's and its
    extrapolation), started first and read by :func:`dry`."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = {which: subprocess.Popen(
        [sys.executable, "-c", _DRY_CODE, which, ARCH, json.dumps(DRY_CELLS),
         str(DRY_LAYERS), json.dumps(EXTRAPOLATED)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env) for which in ("ref",
                                                                 "port")}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, dry_procs):
    """The reference's leaves (written for the ranks), then the 4 ranks,
    beside the dry runs."""
    out = tmp_path_factory.mktemp("xlstm_mesh")
    leaves = {}
    for kind, heads in (("mlstm", None), ("slstm", None),
                        ("mlstm", FEW_HEADS)):
        leaves[kind, heads] = block_leaves(kind, heads)
        np.savez(out / f"{kind}{heads or ''}.npz", **leaves[kind, heads])
    _run_ranks([sys.executable, "-c", _RANK_CODE], str(out))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    return {"ranks": ranks, "leaves": leaves, "dir": out}


@pytest.fixture(scope="module")
def dry(dry_procs):
    got = {}
    for which, proc in dry_procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        line = [x for x in stdout.splitlines() if x.startswith("DRY ")]
        assert line, stdout[-2000:] + stderr[-4000:]
        got[which] = json.loads(line[0][len("DRY "):])
    return got


_REFERENCE = {}


def _reference(kind, leaves, with_state: bool, heads=None):
    """The reference's block (prefill, with or without a state) and decode
    step on the same numpy inputs (computed once a case)."""
    key = (kind, with_state, heads)
    if key not in _REFERENCE:
        _REFERENCE[key] = _reference_run(kind, leaves, with_state, heads)
    return _REFERENCE[key]


def _reference_run(kind, leaves, with_state: bool, heads):
    import jax.numpy as jnp

    from repro import configs as jc
    from repro.models import xlstm as JX

    jcfg = xlstm_cfg(jc, heads)
    inp = block_inputs(kind, jcfg)
    block, step = ((JX.mlstm_block, JX.mlstm_decode_step) if kind == "mlstm"
                   else (JX.slstm_block, JX.slstm_decode_step))
    p = {k: jnp.asarray(v) for k, v in leaves.items()}
    state = (jnp.asarray(inp["s0"]), jnp.asarray(inp["s1"]))
    out, new = block(p, jnp.asarray(inp["x"]), jcfg,
                     state if with_state else None)
    dec, dnew = step(p, jnp.asarray(inp["x"][:, :1]), jcfg, state)
    return (np.asarray(out), None if new is None else [np.asarray(t)
                                                         for t in new],
            np.asarray(dec), [np.asarray(t) for t in dnew])


def _close(got, want, tol=1e-5):
    got = got.numpy() if torch.is_tensor(got) else got
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _state_placements(kind):
    """The cache's placements of ``kind``'s state leaves on (data,
    model), as DTensor prints them."""
    dims = {"mlstm": (2, 2), "slstm": (1, 1)}[kind]
    return [f"(Shard(dim=0), Shard(dim={d}))" for d in dims]


# the all-to-alls of a prefill block and its backward in the trainer's
# layout: the sLSTM's z/i/f/o split and its inverse; the mLSTM state's
# four moves (C and n to the heads and back) and the inverses of the two
# back (the new state's gradient; the start state takes none)
BLOCK_ALL_TO_ALL = {("mlstm", False): 0, ("mlstm", True): 6,
                    ("slstm", False): 2, ("slstm", True): 2}


@pytest.mark.parametrize("with_state", (False, True),
                         ids=("no_state", "state"))
@pytest.mark.parametrize("shape,layout", [
    (shape, n) for shape, names in BLOCK_CASES.items() for n in names],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_block_equals_the_reference_and_one_device(runs, kind, shape,
                                                        layout, with_state):
    leaves = runs["leaves"][kind, None]
    want, want_state, _, _ = _reference(kind, leaves, with_state)
    inp = block_inputs(kind, xlstm_cfg())
    one, one_state, grads = plain_block(kind, leaves, inp, with_state)
    for rec in runs["ranks"]:
        got = rec["block"][f"{kind}/{shape}/{layout}/{with_state}"]
        _close(got["out"], want)
        _close(got["out"], one.numpy())
        if with_state:
            for g, w, o in zip(got["state"], want_state, one_state):
                _close(g, w)
                _close(g, o.detach().numpy())
            # the new state lies as the cache's leaves do
            assert got["state_placements"] == _state_placements(kind)
        for name, g in grads.items():
            _close(got["grads"][name], g.numpy())
        if layout == "batch":  # what gloo runs on card tensors
            calls = got["calls"]
            assert "all-gather" not in calls, calls
            assert calls.get("all-to-all", 0) == \
                BLOCK_ALL_TO_ALL[kind, with_state], calls


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_mesh_decode_step_equals_the_reference(runs, kind, shape):
    _, _, want, want_state = _reference(kind, runs["leaves"][kind, None],
                                        True)
    for rec in runs["ranks"]:
        got = rec["decode"][f"{kind}/{shape}"]
        _close(got["out"], want)
        for g, w in zip(got["state"], want_state):
            _close(g, w)
        assert got["state_placements"] == _state_placements(kind)
        assert "all-gather" not in got["calls"], got["calls"]
        # mLSTM: C and n to the heads and back; sLSTM: the z/i/f/o split
        assert got["calls"].get("all-to-all", 0) == \
            (4 if kind == "mlstm" else 1), got["calls"]


@pytest.mark.parametrize("with_state", (False, True),
                         ids=("no_state", "state"))
def test_mlstm_heads_that_do_not_divide_the_model_axis(runs, with_state):
    """2 heads on (1, 4): q/k/v gathered (all-gathers, counted), every
    device runs both heads, the state made whole and chunked back."""
    leaves = runs["leaves"]["mlstm", FEW_HEADS]
    want, want_state, dec, dec_state = _reference("mlstm", leaves, with_state,
                                                  FEW_HEADS)
    cfg = xlstm_cfg(heads=FEW_HEADS)
    one, _, grads = plain_block("mlstm", leaves, block_inputs("mlstm", cfg),
                                with_state, FEW_HEADS)
    tag = f"mlstm{FEW_HEADS}/{FEW_HEADS_MESH}"
    for rec in runs["ranks"]:
        got = rec["block"][f"{tag}/batch/{with_state}"]
        _close(got["out"], want)
        _close(got["out"], one.numpy())
        if with_state:
            for g, w in zip(got["state"], want_state):
                _close(g, w)
            assert got["state_placements"] == _state_placements("mlstm")
        for name, g in grads.items():
            _close(got["grads"][name], g.numpy())
        assert got["calls"].get("all-gather", 0) >= 3  # q, k, v
        got = rec["decode"][tag]
        _close(got["out"], dec)
        for g, w in zip(got["state"], dec_state):
            _close(g, w)


@pytest.fixture(scope="module")
def single():
    """The single-device trainer, and the dry run's count of the same
    step on (2, 2)."""
    cfg = xlstm_cfg(layers=TRAIN_LAYERS)
    ocfg, tcfg, dcfg = trainer_configs(cfg)
    trainer = Trainer(cfg, ocfg, tcfg, dcfg)
    trainer.init(0)
    batch = trainer.place_batch(trainer.source.batch(0))
    total, _ = T.loss_fn(trainer.params, cfg, batch, ctx=CPU)
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


def _kind(name: str) -> str:
    """A leaf's kind: its name within the block (``core.wq``) over the
    model's layers, or the name itself (``embed``)."""
    return name.split(".", 3)[-1] if name.startswith("layers.") else name


def test_mesh_trainer_first_step_matches_one_device(runs, single):
    """The loss within 1e-5 relative; each gradient within 1e-5 of the
    largest |value| of its kind's gradients."""
    kinds = {}
    for name, g in single["grads"].items():
        kinds[_kind(name)] = max(kinds.get(_kind(name), 0.0),
                                 float(g.abs().max()))
    for rec in runs["ranks"]:
        got = rec["train"]
        assert float(got["loss0"]) == pytest.approx(single["loss0"],
                                                    rel=1e-5)
        for name, g in single["grads"].items():
            err = float((got["grads"][name] - g).abs().max())
            assert err <= 1e-5 * max(kinds[_kind(name)], 1e-30), (name, err)


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
    assert count["calls"]["all-to-all"] > 0  # the z/i/f/o splits
    assert "all-gather" not in count["calls"]  # gloo on card tensors
    for rec in runs["ranks"]:
        got = rec["train"]
        assert got["collectives"] == [count["collectives"]] * STEPS
        assert got["argument_bytes"] == count["argument_bytes"]


def test_checkpoint_from_the_mesh_is_read_bit_equal_by_both_packages(runs):
    import jax

    from repro.train import checkpoint as JCK
    from repro_torch.train import checkpoint as ckpt

    for rec in runs["ranks"]:
        got = rec["ckpt"]
        assert got["collectives"]["all-gather"] == 0, got["collectives"]
        assert got["collectives"]["all-reduce"] > 0, got["collectives"]
        assert got["params_are_trained"]
    leaves = torch.load(runs["dir"] / "gathered.pt")
    directory = str(runs["dir"] / "ckpt")
    assert ckpt.latest_step(directory) == STEPS
    # the gathered tree rebuilt from its keys: the restores' template
    tree = {}
    for key, t in leaves.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    tree["opt"] = tuple(tree["opt"][str(i)] for i in range(3))
    port, _ = ckpt.restore(directory, tree, device="cpu")
    jtemplate = jax.tree.map(lambda t: np.zeros(t.shape, t.numpy().dtype),
                             tree)
    ref, _ = JCK.restore(directory, jtemplate)
    port_leaves = dict(ckpt._flatten_with_paths(port))
    ref_leaves = dict(ckpt._flatten_with_paths(
        jax.tree.map(np.asarray, ref)))
    assert list(port_leaves) == list(leaves)
    for key, t in leaves.items():
        assert torch.equal(port_leaves[key], t), key
        assert np.array_equal(ref_leaves[key], t.numpy()), key


@pytest.mark.parametrize("shape", DRY_CELLS)
def test_run_cell_argument_bytes_are_the_reference(dry, shape):
    ref = dry["ref"][shape]
    port = dry["port"][shape + "/port"]
    assert port["status"] == ref["status"] == "ok"
    assert port["chips"] == 4 and port["mesh"] == "2x2"
    assert port["chunk_size"] == ref["chunk_size"]
    assert port["bytes_per_device"]["argument_bytes"] == \
        ref["bytes_per_device"]["argument_bytes"]
    print(json.dumps({"cell": f"{ARCH}/{shape}", "wire_bytes_port_ref": {
        k: (port["collectives"][k], ref["collectives"][k])
        for k in ref["collectives"]}}))


@pytest.mark.parametrize("shape", EXTRAPOLATED)
def test_extrapolation_equals_a_direct_run(dry, shape):
    """R = 1 and 2 extrapolated to R = 3 against 6 layers run: every
    additive cost is affine in R (relative 1e-9)."""
    ext = dry["port"][shape + "/extrapolated"]
    direct = dry["port"][shape + "/direct"]
    assert ext["extrapolated"] == "R=1,2 -> R=3"
    assert direct["n_layers"] == 6
    pairs = [(k, ext[k], direct[k]) for k in EXTRAPOLATED_KEYS]
    pairs += [(f"collectives.{k}", ext["collectives"][k],
               direct["collectives"][k]) for k in direct["collectives"]]
    pairs += [(k, ext["bytes_per_device"][k], direct["bytes_per_device"][k])
              for k in ("argument_bytes", "output_bytes")]
    for key, a, b in pairs:
        assert a == pytest.approx(b, rel=1e-9, abs=1e-9), key


def test_chunk_rule_is_the_references_at_full_width():
    """``choose_chunk`` on xLSTM-1.3B's cells picks the reference's chunk
    (its mLSTM counts 4 heads in the decay tensor)."""
    from repro import configs as jc
    from repro.launch import dryrun as jdr
    from repro.models.config import LM_SHAPES as J_SHAPES

    cfg, jcfg = get_config(ARCH), jc.get_config(ARCH)
    assert dr._recurrent_heads(cfg) == jdr._recurrent_heads(jcfg) == 4
    for name, shape in LM_SHAPES.items():
        assert dr.choose_chunk(cfg, shape) == \
            jdr.choose_chunk(jcfg, J_SHAPES[name]), name
