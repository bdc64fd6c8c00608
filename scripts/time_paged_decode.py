"""Time the port's paged decode on the card.

    python3 scripts/time_paged_decode.py [--root DIR]

``paged_decode_attention`` at two shapes of Qwen2.5-3B's decode (B 4, KV 2,
g 8, hd 128, blocks of 16 keys, bf16): chip_smoke.py's phase 8 operands
(``paged_decode_operands``: the serve's depths, the deepest row's table
width) and every row full at w = 32 (the serve's ``max_len`` 512 / 16);
where the timed package takes a table ``capacity``, phase 8's operands once
more at capacity 32, the launch the paged engine makes (its split from the
table capacity, not from w).
Each is timed as a call (CUDA events around one call, host work included),
a launch (50 back-to-back calls) and on the device (a replayed CUDA graph of
20 calls), beside its bound (the live keys' bytes at 3.35 TB/s) and its
error against ``paged_decode_plain``; one JSON line a shape, with the split
S and the CTA count of the launch (the first form, which has no
``paged_launch_config``: one CTA a (row, kv head)). The measuring code is
always this checkout's; ``--root`` times another checkout's package (its
``src``), so that two versions of the kernel can be compared on one card in
one run: run them in turn, A B B A. Needs a CUDA device.
"""

import argparse
import inspect
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose package is timed (default: this one)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(HERE))

    import torch

    import chip_smoke as cs

    sys.path.insert(0, str(root / "src"))  # ahead of chip_smoke's own src
    # chip_smoke imported this checkout's package (its timing helpers stay
    # in use); the timed package is imported anew from ``root``
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import (KERNELS, paged_decode_attention,
                                     paged_decode_plain)

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        sys.exit(f"repro_torch came from {repro_torch.__file__}, not {root}")
    try:
        from repro_torch.kernels.flash_attention import paged_launch_config
    except ImportError:
        paged_launch_config = None
    KERNELS["paged_decode"].fn()  # build before any timing
    cfg = get_config(cs.ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 20)
    _, lens = cs.serving_prompt_lens()
    q, kp, vp, tables, lengths, _, w = cs.paged_decode_operands(gen, cfg, lens)
    shapes = {"phase 8": (q, kp, vp, tables, lengths, None)}
    if "capacity" in inspect.signature(paged_decode_attention).parameters:
        shapes["phase 8, engine capacity 32"] = (q, kp, vp, tables, lengths,
                                                 512 // 16)
    # every row full at the serve's widest table
    KV, hd, wf = cfg.n_kv_heads, cfg.hd, 512 // 16
    nb = 1 + 4 * wf
    kf = torch.randn((nb, KV, 16, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    vf = torch.randn((nb, KV, 16, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    perm = 1 + torch.randperm(nb - 1, generator=gen, device="cuda")
    shapes["w 32 full"] = (q, kf, vf, perm.reshape(4, wf).to(torch.int32),
                           torch.full((4,), 16 * wf, dtype=torch.int32,
                                      device="cuda"), None)
    for name, (q_, kp_, vp_, tab, lns, cap) in shapes.items():
        B, H, _, hd = q_.shape
        width = tab.shape[1]
        kw = {} if cap is None else {"capacity": cap}

        def paged():
            return paged_decode_attention(q_, kp_, vp_, tab, lns, **kw)

        err = (paged().float() - paged_decode_plain(q_, kp_, vp_, tab, lns)
               .float()).abs().max().item()
        live = float(lns.sum().item())
        entries = sum(-(-int(n) // 16) for n in lns.tolist())
        nbytes = (2 * q_.numel() + 2 * live * KV * hd) * 2 + (entries + B) * 4
        bound, by = cs.bound_ms(4.0 * live * H * hd, nbytes,
                                cs.PEAK_BF16_FLOPS)
        if paged_launch_config is None:
            split, ctas = 1, B * KV
        else:
            lc = paged_launch_config(B, KV, H // KV, hd, 16, width, q_.dtype,
                                     **kw)
            split, ctas = lc["split"], lc["ctas"]
        print(json.dumps({
            "root": str(root), "device": cs.smi(), "kernel": "paged_decode",
            "shape": name, "B": B, "w": width, "capacity": cap or width,
            "lengths": lns.tolist(),
            "split": split, "ctas": ctas,
            "ms": cs.median_ms(paged, 2, 20),
            "ms_per_launch": cs.per_launch_ms(paged),
            "device_ms_per_call": cs.graph_ms_per_call(paged),
            "bound_ms": bound, "bound_by": by, "max_abs_err": err}),
            flush=True)


if __name__ == "__main__":
    main()
