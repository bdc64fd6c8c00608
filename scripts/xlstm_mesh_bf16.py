"""How far bf16 rounding alone moves xLSTM's gradients: the control for
chip_smoke.py's phase 30 (xLSTM on the mesh).

    python3 scripts/xlstm_mesh_bf16.py [--reduced] [--device cpu]

Phase 30's run on one device (xLSTM-1.3B at published widths cut to two
(mLSTM, sLSTM) units, B 4, L 512, 2 AdamW steps at lr 1e-3, seed 0; with
``--reduced`` the reduced widths), in bf16 compute, twice: as it is, and
with every block's out-projection summed as 4 bf16 partial products over
its rows, the re-association a (data 1, model 4) mesh adds (each rank's
Partial product, then their sum). Nothing else differs. Prints one JSON
line: both runs' losses and, for each kind of leaf (mLSTM, sLSTM,
embedding and head, norms), the largest difference of the AdamW first
moments relative to each leaf's largest |value| (phase 30's measure), and
the same in f32 compute; with the card's name and power limit on
``cuda``.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PARTS = 4  # the mesh's model axis


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced widths (get_smoke)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import xlstm as X
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    get = get_smoke if args.reduced else get_config
    ctx = ExecutionContext(target=H100, device=args.device,
                           backend="cuda" if args.device == "cuda"
                           else "torch")

    def first_moments(cfg):
        trainer = Trainer(cfg, AdamWConfig(lr=cs.MESH_LR, warmup_steps=5,
                                           total_steps=cs.MESH_STEPS),
                          TrainConfig(steps=cs.MESH_STEPS, ctx=ctx,
                                      log_every=0),
                          DataConfig(batch_size=4, seq_len=512,
                                     vocab_size=cfg.vocab_size))
        hist = trainer.run()
        return hist["loss"], {n: m.float().cpu() for n, m in
                              trainer.opt_state.m.items()}

    def split_out(p, h, cfg, x):
        cd = getattr(torch, cfg.compute_dtype)
        w = h.shape[-1] // PARTS
        out = None
        for i in range(PARTS):
            part = h[..., i * w:(i + 1) * w].to(cd) @ \
                p.wo[i * w:(i + 1) * w].to(cd)
            out = part if out is None else out + part
        return out.to(x.dtype)

    row = {"config": "reduced" if args.reduced else "published",
           "device": args.device, "parts": PARTS}
    plain = X._project_out
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get(cs.XLSTM_ARCH),
                                  n_layers=cs.XLSTM_MESH_LAYERS,
                                  compute_dtype=dtype)
        X._project_out = plain
        loss_a, m_a = first_moments(cfg)
        X._project_out = split_out
        try:
            loss_b, m_b = first_moments(cfg)
        finally:
            X._project_out = plain
        kinds = {}
        for name, a in m_a.items():
            scale = a.abs().max().item()
            err = (m_b[name] - a).abs().max().item() / max(scale, 1e-30)
            kind = cs.leaf_kind(name, cfg.pattern)
            kinds[kind] = max(kinds.get(kind, 0.0), err)
        row[dtype] = {"losses": [loss_a, loss_b],
                      "moment_max_rel_err_by_kind": kinds}
    if args.device == "cuda":
        row["card"] = cs.smi()
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
