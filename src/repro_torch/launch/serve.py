"""Serving launcher: continuous-batching decode with seeded random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \\
        --smoke --device cpu --requests 4 --prompt-len 8 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1_3b \\
        --smoke --device cpu

Runs on the card under the ``h100`` preset by default; ``--device cpu``
runs every kernel's plain version instead. ``--engine wave`` runs the
wave-lockstep baseline scheduler. ``--batch 0`` sizes the slot pool from
the hardware target's memory model. Reported tok/s counts only tokens that
were actually generated. Weights are random, made on the device from
``--seed``, unless ``--ckpt-dir`` names a training run's checkpoints: then
the newest committed step's ``params`` are served (the reference's format,
written by either package's trainer).
"""

from __future__ import annotations

import argparse
import collections
import logging
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config instead of published widths")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest committed checkpoint's params")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4,
                    help="slot-pool size; 0 = plan from the hardware target")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--stop-token", type=int, default=None,
                    help="token id that ends a request (EOS)")
    ap.add_argument("--engine", choices=("slot", "wave"), default="slot",
                    help="continuous batching (slot) or the wave baseline")
    ap.add_argument("--paged", choices=("on", "off"), default=None,
                    help="paged KV pool (on) or per-slot contiguous cache "
                         "(off); default: paged for pure-attention models, "
                         "contiguous for recurrent ones (xLSTM, jamba)")
    ap.add_argument("--target", default="h100",
                    help="hardware target preset (h100 | tpu_v5e | gemmini "
                         "| cpu_interpret); sets plan/precision policy and "
                         "the default backend")
    ap.add_argument("--backend", choices=("torch", "cuda"), default=None,
                    help="kernel backend override; default resolves from "
                         "REPRO_TORCH_BACKEND and then the --target preset")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget from admission; "
                         "expired requests finish with reason 'timeout'")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import get_target
    from repro_torch.serving.engine import Engine, Request, WaveEngine

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.causal:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    target = get_target(args.target)
    ctx = ExecutionContext(target=target, backend=args.backend,
                           device=args.device)
    params = T.init_params(cfg, seed=args.seed, device=args.device)
    if args.ckpt_dir:
        from repro_torch.convert import transformer_from_jax, transformer_tree
        from repro_torch.train import checkpoint as ckpt

        restored, _ = ckpt.restore(args.ckpt_dir,
                                   {"params": transformer_tree(params)},
                                   device=args.device)
        params = transformer_from_jax(restored["params"], cfg, args.device)

    rng = np.random.default_rng(args.seed)
    stop = () if args.stop_token is None else (args.stop_token,)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(2, args.prompt_len + 1)
                                        ).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature,
                    stop_tokens=stop,
                    deadline_s=args.deadline_s)
            for _ in range(args.requests)]
    cls = WaveEngine if args.engine == "wave" else Engine
    eng = cls(cfg, params, max_len=args.max_len,
              batch_size=args.batch or None, target=target, ctx=ctx,
              paged=None if args.paged is None else args.paged == "on")
    del params  # the engine keeps its compute-dtype copy
    t0 = time.perf_counter()
    eng.serve(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in reqs
                    if r.out_tokens is not None)  # real tokens only
    reasons = collections.Counter(r.finish_reason for r in reqs)
    ok = len(reqs) - reasons.get("error", 0) - reasons.get("timeout", 0)
    print(f"[{args.engine}] served {len(reqs)} requests on {args.device} "
          f"(batch={eng.batch_size}, paged={eng.paged}), {total_new} "
          f"generated tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s); "
          f"completed={ok}/{len(reqs)} finish={dict(reasons)}; median "
          f"prefill {1e3 * np.median(eng.stats.prefill_s):.2f} ms, decode "
          f"step {1e3 * np.median(eng.stats.decode_s or [0.0]):.2f} ms")
    for i, r in enumerate(reqs[:4]):
        out = [] if r.out_tokens is None else r.out_tokens[:12].tolist()
        print(f"  req{i}: prompt={r.prompt[:8].tolist()}... "
              f"out={out} ({r.finish_reason})")
    return reqs


if __name__ == "__main__":
    main()
