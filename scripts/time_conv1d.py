"""Time the port's causal conv1d at the hybrid serve's prefill shapes.

    python3 scripts/time_conv1d.py [--root DIR]

At each of the 8 prompt lengths of chip_smoke.py's hybrid serve (phase 14),
the Jamba-1.5 operand (1, L, 16384) x (4, 16384), bf16, x the strided half
of a seeded (1, L, 32768) in-projection, goes through the kernel's wrapper
and ``F.conv1d`` (groups = D), each timed as a call, a launch (50
back-to-back calls) and on the device (a replayed CUDA graph of 20 calls):
chip_smoke.py's ``conv1d_shape_times``, the measurement of its phase 15.
Prints one JSON line a shape and one with the sums. The measuring code is
always this checkout's; ``--root`` times another checkout's package (its
``src``), so that two versions of the kernel can be compared on one card
in one run: run them in turn, A B B A. Needs a CUDA device.
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
    from repro_torch.kernels import KERNELS

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        sys.exit(f"repro_torch came from {repro_torch.__file__}, not {root}")
    KERNELS["conv1d_causal"].fn()  # build before any timing
    cfg = get_config(cs.HYBRID_ARCH)
    lens, _ = cs.hybrid_prompts(cfg.vocab_size)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 60)
    K, D = cfg.conv_kernel, cfg.d_inner
    w = (torch.randn((K, D), generator=gen, device="cuda") * K ** -0.5
         ).to(torch.bfloat16)
    keys = ("ms", "ms_per_launch", "device_ms", "library_ms",
            "library_ms_per_launch", "library_device_ms", "bound_ms")
    sums = dict.fromkeys(keys, 0.0)
    for L in sorted({int(n) for n in lens}):
        row, _ = cs.conv1d_shape_times(gen, L, w, plain=False)
        print(json.dumps({"root": str(root), **row}), flush=True)
        for key in keys:
            both = isinstance(row[key], float) and isinstance(sums[key], float)
            sums[key] = sums[key] + row[key] if both else "not measured"
    print(json.dumps({"root": str(root), "device": cs.smi(),
                      "shapes": "sum over the 8 prefill shapes", **sums}),
          flush=True)


if __name__ == "__main__":
    main()
