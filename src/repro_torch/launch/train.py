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
directory written by either package resumes in the other). ``--mesh`` is
not ported (ROADMAP queue 1, item 13): the launcher runs on one device, so
``n_groups`` is 1.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def main(argv=None):
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
                    help="not ported (ROADMAP queue 1, item 13)")
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
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100, get_target
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    if args.mesh:
        raise NotImplementedError(
            "--mesh: a device mesh is not ported to repro_torch yet (ROADMAP "
            "queue 1, item 13)")
    target = get_target(args.target) if args.target else H100
    ctx = ExecutionContext(target=target, backend=args.backend,
                           device=args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dcfg = DataConfig(batch_size=args.batch, seq_len=args.seq,
                      vocab_size=cfg.vocab_size, path=args.data)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                       total_steps=args.steps)
    tcfg = TrainConfig(steps=args.steps, microbatches=args.microbatches,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       remat=args.remat, ctx=ctx,
                       compress_grads=args.compress_grads)
    trainer = Trainer(cfg, ocfg, tcfg, dcfg)
    hist = trainer.run()
    if hist["loss"]:
        print(f"final loss {hist['loss'][-1]:.4f} over {len(hist['loss'])} "
              f"steps ({np.mean(hist['step_time'][1:] or hist['step_time']):.3f}"
              f"s/step, skipped={trainer.skipped_steps}) on {args.device}")
    return hist


if __name__ == "__main__":
    main()
