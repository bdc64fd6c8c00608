"""Time the port's int8 direct conv on the card.

    python3 scripts/time_int8_conv.py [--root DIR]

Each of the five ResNet-50 layers at batch 1000 (chip_smoke.py's
``layer_inputs``, quantized on the card with ``quantize_conv_operands``)
goes through ``ops.conv2d_q`` on the ``cuda`` backend under the H100 int8
plans, bf16 out, as in chip_smoke.py's phase 10, timed as a call (CUDA
events around one call, host work included), a launch (50 back-to-back
calls) and on the device (a replayed CUDA graph of 20 calls): the
measurement of chip_smoke.py's rows 6-7 block. Prints one JSON line a
layer and one with the sums (``scripts/time_paged_decode.py`` times the
paged decode). The measuring code is always this checkout's; ``--root``
times another checkout's package (its ``src``), so that two versions of
the kernel can be compared on one card in one run: run them in turn,
A B B A. Needs a CUDA device.
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
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(HERE))

    import torch

    import chip_smoke as cs

    sys.path.insert(0, str(root / "src"))  # ahead of chip_smoke's own src
    import repro_torch
    from repro_torch import ops
    from repro_torch.core.conv_model import resnet50_layers
    from repro_torch.kernels import KERNELS
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.quant import quantize_conv_operands

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        sys.exit(f"repro_torch came from {repro_torch.__file__}, not {root}")
    KERNELS["conv2d_q"].fn()  # build before any timing
    gen = torch.Generator(device="cuda")
    ctx = ExecutionContext(target=H100, backend="cuda")
    keys = ("ms", "ms_per_launch", "device_ms", "bound_ms")
    sums = dict.fromkeys(keys, 0.0)
    for i, (name, s) in enumerate(resnet50_layers(cs.BATCH).items()):
        x, w = cs.layer_inputs(gen, i, s)
        xq, wq, sc = quantize_conv_operands(x, w)
        del x, w
        torch.cuda.empty_cache()
        stride = (s.sh, s.sw)
        row = {"root": str(root), "kernel_layer": "conv2d_q", "layer": name,
               "ms": cs.median_ms(lambda: ops.conv2d_q(xq, wq, sc, stride,
                                                       ctx=ctx)),
               **cs.int8_conv_times(xq, wq, sc, s, ctx)}
        print(json.dumps(row), flush=True)
        for key in keys:
            both = isinstance(row[key], float) and isinstance(sums[key], float)
            sums[key] = sums[key] + row[key] if both else "not measured"
        del xq, wq, sc
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(root), "device": cs.smi(),
                      "kernel": "conv2d_q",
                      "shapes": "sum over the five ResNet-50 layers at batch "
                                f"{cs.BATCH}, int8 in, bf16 out", **sums}),
          flush=True)


if __name__ == "__main__":
    main()
