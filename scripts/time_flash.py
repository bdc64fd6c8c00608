"""Time the port's flash-attention wrapper at the Qwen serve's shapes.

    python3 scripts/time_flash.py [--root DIR]

The two calls of chip_smoke.py's phase 8 (Qwen2.5-3B, hd 128, 16 query
heads over 2 KV heads, bf16): a prefill of the first request's bucket (Lq
176 against a 512-key cache, a tensor-scalar offset and a pad-tail key
mask) and a contiguous decode step (4 rows at depths 230/120/60/17 of 512
keys, per-row offsets), each timed as a call (CUDA events around one call,
the wrapper's host work included), a launch (50 back-to-back calls) and on
the device (a replayed CUDA graph of 20 calls). Prints one JSON line a
shape. The measuring code is always this checkout's; ``--root`` times
another checkout's package (its ``src``), so that two versions of the
wrapper can be compared on one card in one run: run them in turn, A B B A.
Needs a CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose package is timed (default: this one)")
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(HERE))

    import torch

    # the timed package first: chip_smoke puts its own src ahead on import
    sys.path.insert(0, str(root / "src"))
    import repro_torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, flash_attention

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        sys.exit(f"repro_torch came from {repro_torch.__file__}, not {root}")
    KERNELS["flash_attention"].fn()  # build before any timing
    cfg = get_config(cs.ARCH)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g, Lk = H // KV, 512
    _, lens = cs.serving_prompt_lens()
    Lq = -(-int(lens[0]) // 16) * 16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 20)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = randn((KV, g * Lq, hd)), randn((KV, Lk, hd)), randn((KV, Lk, hd))
    km = torch.zeros((1, Lk), dtype=torch.bool, device="cuda")
    km[0, :int(lens[0])] = True
    km[0, Lq:] = True
    off0 = torch.zeros((), dtype=torch.int32, device="cuda")
    dq, dk, dv = (randn((4 * KV, g, hd)), randn((4 * KV, Lk, hd)),
                  randn((4 * KV, Lk, hd)))
    depth = torch.tensor([230, 120, 60, 17], dtype=torch.int32,
                         device="cuda")
    rows_off = depth[:, None].expand(4, KV).reshape(-1)
    shapes = {
        "prefill": lambda: flash_attention(q, k, v, q_offset=off0,
                                           q_seq_len=Lq, key_mask=km),
        "contiguous decode": lambda: flash_attention(
            dq, dk, dv, q_offset=rows_off, q_seq_len=1)}
    for name, fn in shapes.items():
        print(json.dumps({
            "root": str(root), "kernel_shape": "flash_attention",
            "phase": name, "Lq": Lq if name == "prefill" else 1, "Lk": Lk,
            "ms": cs.median_ms(fn, 2, 20),
            "ms_per_launch": cs.per_launch_ms(fn),
            "device_ms": cs.graph_ms_per_call(fn),
            "device": cs.smi()}), flush=True)


if __name__ == "__main__":
    main()
