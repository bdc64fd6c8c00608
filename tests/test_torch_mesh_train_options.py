"""The mesh trainer's step options (``TrainConfig.microbatches``,
``compress_grads`` and ``remat``) on 4 gloo ranks of a (data 2, model 2)
CPU mesh, held against one device and the dry run's count of the same
step, as ``test_torch_mesh_train.py`` holds the plain step.

Qwen2.5-3B's smoke config in f32, B 4, L 16, 2 AdamW steps from the same
init, three trainers in turn: ``microbatches=2``, ``compress_grads=True``
and all three options on. For each: the first step's loss within 1e-5
relative and the gradients it reduces (before any compression) within
1e-5 of the largest |value| of the leaf; after 2 steps every parameter
within 2 x lr x steps; each step's wire bytes by kind and the argument
bytes equal to ``dryrun.count_train_step``'s with the same
``TrainConfig``, all-reduces alone (what gloo runs on card tensors:
``place_on_mesh`` gives every data rank its share of each microbatch).

And ``quantize_int8`` on DTensors: a leaf whose shards have different
absmax (and a second repeat of the same reference leaf) takes one scale
over the whole reference leaf, as on one device, bit for bit."""

import dataclasses
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun as dr
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import Trainer, quantize_int8
from test_torch_mesh_train import (LR, MESH, RANKS, STEPS, _cfg, _configs,
                                   _run_ranks)

OPTIONS = (("microbatches", {"microbatches": 2}),
           ("compress", {"compress_grads": True}),
           ("all", {"microbatches": 2, "compress_grads": True,
                    "remat": True}))
NAMES = [name for name, _ in OPTIONS]
# a (4, 8) leaf in two repeats of one reference leaf, and another leaf;
# the rows of the first repeat grow, so its shards' absmax differ
QUANT_SHAPE = (4, 8)


def quant_tree():
    rng = np.random.default_rng(11)
    rows = np.arange(1, QUANT_SHAPE[0] + 1, dtype=np.float32)[:, None]
    return {"layers.0.b0.core.wq": torch.from_numpy(
                rng.standard_normal(QUANT_SHAPE).astype(np.float32) * rows),
            "layers.1.b0.core.wq": torch.from_numpy(
                rng.standard_normal(QUANT_SHAPE).astype(np.float32)),
            "head": torch.from_numpy(
                rng.standard_normal(QUANT_SHAPE).astype(np.float32))}


def train_config(tcfg, options):
    return dataclasses.replace(tcfg, **options)


def capture_gradients(module, seen):
    """Patch ``module``'s ``quantize_int8`` and ``apply_updates`` so that
    the first step's reduced gradients (before any compression) are kept
    in ``seen`` (copies: nothing goes over the wire inside the step)."""
    orig_q, orig_apply = module.quantize_int8, module.apply_updates

    def copy(g):
        return {n: t.detach().clone() for n, t in g.items()}

    def quant(g):
        seen.setdefault("grads", copy(g))
        return orig_q(g)

    def apply(p, g, s, c):
        seen.setdefault("grads", copy(g))
        return orig_apply(p, g, s, c)

    module.quantize_int8, module.apply_updates = quant, apply
    return lambda: (setattr(module, "quantize_int8", orig_q),
                    setattr(module, "apply_updates", orig_apply))


_RANK_CODE = textwrap.dedent('''
    import os, sys, torch
    import torch.distributed as dist
    sys.path.insert(0, os.environ["TEST_DIR"])
    from test_torch_mesh_train import MESH, _cfg, _configs
    from test_torch_mesh_train_options import (OPTIONS, capture_gradients,
                                               quant_tree, train_config)
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.trainer import Trainer, quantize_int8
    torch.set_num_threads(1)  # four ranks share the host's cores
    out_dir = sys.argv[1]
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo")
    mesh = make_host_mesh(*MESH, device_type="cpu")
    cfg = _cfg()
    ocfg, tcfg, dcfg = _configs(cfg)
    out = {}
    for name, options in OPTIONS:
        trainer = Trainer(cfg, ocfg, train_config(tcfg, options), dcfg,
                          mesh=mesh)
        trainer.init(0)
        seen = {}
        undo = capture_gradients(trainer_mod, seen)
        try:
            hist = trainer.run()
        finally:
            undo()
        batch = trainer.place_batch(trainer.source.batch(0))
        out[name] = {
            "hist": hist, "grads": {n: g.full_tensor() for n, g in
                                    seen["grads"].items()},
            "final": {n: p.detach().full_tensor() for n, p in
                      trainer.params.named_parameters()},
            "collectives": trainer.collectives,
            "argument_bytes": argument_bytes(
                (trainer.params, trainer.opt_state, batch))}
    # quantize_int8 on DTensors: rows on data, columns on model
    tree = quant_tree()
    placed = {n: distribute_tensor(t, mesh, (Shard(0), Shard(1)))
              for n, t in tree.items()}
    q = quantize_int8(placed)
    out["quant"] = {"q": {n: t.full_tensor() for n, t in q.items()},
                    "local_absmax": float(placed["layers.0.b0.core.wq"]
                                          .to_local().abs().max())}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_options")
    cfg = _cfg()
    ocfg, tcfg, dcfg = _configs(cfg)
    single, counts = {}, {}
    for name, options in OPTIONS:
        tc = train_config(tcfg, options)
        trainer = Trainer(cfg, ocfg, tc, dcfg)
        trainer.init(0)
        seen = {}
        undo = capture_gradients(trainer_mod, seen)
        try:
            hist = trainer.run()
        finally:
            undo()
        single[name] = {"hist": hist, "grads": seen["grads"],
                        "final": {n: p.detach().clone() for n, p in
                                  trainer.params.named_parameters()}}
        counts[name] = dr.count_train_step(
            cfg, MESH, {"tokens": torch.as_tensor(
                trainer.source.batch(0)["tokens"])}, tc, ocfg)
    _run_ranks([sys.executable, "-c", _RANK_CODE], str(out))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    return {"single": single, "counts": counts, "ranks": ranks}


@pytest.mark.parametrize("name", NAMES)
def test_first_step_loss_and_gradients_match_one_device(runs, name):
    want = runs["single"][name]
    for rec in runs["ranks"]:
        got = rec[name]
        assert got["hist"]["loss"][0] == pytest.approx(
            want["hist"]["loss"][0], rel=1e-5)
        assert got["grads"].keys() == want["grads"].keys()
        for n, g in want["grads"].items():
            scale = max(float(g.abs().max()), 1e-30)
            assert float((got["grads"][n] - g).abs().max()) <= 1e-5 * scale, n


@pytest.mark.parametrize("name", NAMES)
def test_parameters_after_the_steps_match_one_device(runs, name):
    want = runs["single"][name]
    for rec in runs["ranks"]:
        got = rec[name]
        assert got["hist"]["step"] == want["hist"]["step"] == \
            list(range(STEPS))
        for n, p in want["final"].items():
            err = float((got["final"][n] - p).abs().max())
            assert err <= 2 * LR * STEPS, (n, err)


@pytest.mark.parametrize("name", NAMES)
def test_wire_and_argument_bytes_equal_the_dry_run(runs, name):
    count = runs["counts"][name]
    assert count["calls"].keys() == {"all-reduce"}
    for rec in runs["ranks"]:
        got = rec[name]
        assert got["collectives"] == [count["collectives"]] * STEPS
        assert got["argument_bytes"] == count["argument_bytes"]


def test_compressed_scale_spans_the_whole_reference_leaf(runs):
    """One absmax over both repeats' whole tensors, not one shard's: the
    DTensors' result gathered is one device's, bit for bit."""
    tree = quant_tree()
    want = quantize_int8(tree)
    whole_max = float(torch.stack([tree[n].abs().max() for n in
                                   ("layers.0.b0.core.wq",
                                    "layers.1.b0.core.wq")]).max())
    maxima = set()
    for rec in runs["ranks"]:
        got = rec["quant"]
        maxima.add(got["local_absmax"])
        for n, t in want.items():
            assert torch.equal(got["q"][n], t), n
    assert len(maxima) > 1 and min(maxima) < whole_max  # shards differ


def test_microbatches_are_contiguous_blocks():
    """Microbatch i of m is the reference's contiguous block i, from a
    plain batch and from one stacked by microbatch (what ``place_on_mesh``
    places: each data rank holds its share of every block)."""
    batch = {"tokens": torch.arange(12).reshape(6, 2)}
    stacked = trainer_mod.Microbatches(
        tokens=batch["tokens"].reshape(3, 2, 2))
    for i in range(3):
        want = batch["tokens"][2 * i:2 * i + 2]
        assert torch.equal(trainer_mod._split(batch, 3, i)["tokens"], want)
        assert torch.equal(trainer_mod._split(stacked, 3, i)["tokens"], want)
