"""Training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm_1_6b \\
        --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Runs on the card by default (``--device cuda``; without a GPU it raises);
``--device cpu`` runs every kernel's plain version. Data is the reference's
``SyntheticSource`` (or ``--data``, a uint32 token file); weights are
random, made on the device from the seed, or resumed from the newest
committed checkpoint under ``--ckpt-dir`` (the reference's format: a
directory written by either package resumes in the other).

``--mesh data,model`` trains on a (data, model) device mesh, one process
a rank, as ``torchrun`` starts them (it reads ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; the world size must equal data x
model):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2_5_3b --device cpu --smoke --mesh 2,2

The group is gloo: the ranks may share one card, where NCCL cannot put two
ranks (``--device cuda``: each rank's tensors on ``cuda:LOCAL_RANK`` modulo
the visible cards). ``n_groups`` is gcd(batch x seq, world size), as in the
reference, unless ``--moe-groups`` sets it (a single-device run held
against a mesh run takes the mesh's); ``--moe-shard-hints`` pins the MoE
dispatch layout on the mesh (``cfg.moe_shard_hints``; both are the dry
run's overrides). ``--layers N`` cuts the depth. :func:`train` returns the
``Trainer`` with the group still up: its ``collectives`` hold each step's
counted wire bytes by kind.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import math

import numpy as np


def main(argv=None):
    """Train as the arguments say; returns the history (``Trainer.run``'s).
    A mesh run's process group is destroyed at the end."""
    trainer, hist = train(argv)
    if trainer.mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return hist


def train(argv=None):
    """:func:`main` without the teardown: returns (the ``Trainer``, its
    history); on a mesh the process group stays up for the caller."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of published widths")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default=None, help="token file (uint32)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2,2' -> (data=2, model=2) over the torchrun "
                         "ranks (gloo)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (published "
                         "widths kept)")
    ap.add_argument("--backend", choices=("torch", "cuda", "im2col"),
                    default=None,
                    help="kernel backend override; default resolves from "
                         "REPRO_TORCH_BACKEND and then the --target preset")
    ap.add_argument("--target", default=None,
                    help="hardware target preset (h100 | tpu_v5e | gemmini "
                         "| cpu_interpret; default h100); sets the "
                         "plan/precision policy and the default backend")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--moe-shard-hints", action="store_true",
                    help="pin the MoE dispatch layout on the mesh "
                         "(cfg.moe_shard_hints, the dry run's override)")
    ap.add_argument("--moe-groups", type=int, default=None,
                    help="MoE dispatch groups (the dry run's moe_groups; "
                         "default gcd(batch x seq, world size))")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100, get_target
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    mesh, device = None, args.device
    if args.mesh:
        mesh, device = _rank_mesh(args.mesh, args.device)
    target = get_target(args.target) if args.target else H100
    ctx = ExecutionContext(target=target, backend=args.backend,
                           device=device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.moe_shard_hints:
        cfg = dataclasses.replace(cfg, moe_shard_hints=True)
    dcfg = DataConfig(batch_size=args.batch, seq_len=args.seq,
                      vocab_size=cfg.vocab_size, path=args.data)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)
    world = 1 if mesh is None else mesh.size()
    tcfg = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       remat=args.remat, ctx=ctx,
                       compress_grads=args.compress_grads,
                       n_groups=args.moe_groups or max(
                           1, math.gcd(args.batch * args.seq, world)))
    trainer = Trainer(cfg, ocfg, tcfg, dcfg, mesh=mesh)
    hist = trainer.run()
    if hist["loss"]:
        print(f"final loss {hist['loss'][-1]:.4f} over {len(hist['loss'])} "
              f"steps ({np.mean(hist['step_time'][1:] or hist['step_time']):.3f}"
              f"s/step, skipped={trainer.skipped_steps}) on {device}"
              + ("" if mesh is None else f", mesh {args.mesh} rank "
                 f"{mesh.get_rank()}"))
    return trainer, hist


def _rank_mesh(spec: str, device: str):
    """This rank's (data, model) mesh over a gloo group from torchrun's
    environment, and its device."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    shape = tuple(int(x) for x in spec.split(","))
    if len(shape) != 2:
        raise ValueError(f"--mesh {spec!r}: two sizes, data,model")
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise ValueError(f"--mesh needs torchrun's environment: {missing} "
                         "not set")
    world = int(os.environ["WORLD_SIZE"])
    if world != shape[0] * shape[1]:
        raise ValueError(f"--mesh {spec} needs {shape[0] * shape[1]} ranks, "
                         f"WORLD_SIZE is {world}")
    if device == "cuda":
        if not torch.cuda.is_available():
            from repro_torch.resilience import DeviceLost

            raise DeviceLost("--device cuda: no GPU is visible")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():  # a second run in the same ranks
        dist.init_process_group("gloo", rank=int(os.environ["RANK"]),
                                world_size=world)
    return make_host_mesh(*shape, device_type=device), device


if __name__ == "__main__":
    main()
