"""Time the port's direct conv on the five ResNet-50 layers at batch 1000.

    python3 scripts/time_conv_layers.py [--root DIR]

Each layer's seeded bf16 input (chip_smoke.py's ``layer_inputs``) goes
through ``ops.conv2d`` on the ``cuda`` backend under the H100 plans, as in
chip_smoke.py's phase 4, and through ``F.conv2d`` as the same process's
yardstick. Prints one JSON line: the card, per-layer median ms (CUDA
events) and the sums. ``--root`` times another checkout's package (its
``src`` and ``chip_smoke.py``), so that two versions can be compared on one
card in one session: run them in turn, A B B A. Needs a CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package is timed (default: this one)")
    root = Path(ap.parse_args().root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch import ops
    from repro_torch.core.conv_model import resnet50_layers
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    ctx = ExecutionContext(target=H100, backend="cuda")
    layers = {}
    for i, (name, s) in enumerate(resnet50_layers(cs.BATCH).items()):
        x, w = cs.layer_inputs(gen, i, s)
        stride = (s.sh, s.sw)
        ms = cs.median_ms(lambda: ops.conv2d(x, w, stride, ctx=ctx,
                                             out_dtype=torch.float32))
        lib = cs.median_ms(lambda: F.conv2d(x, w, stride=stride))
        layers[name] = {"ms": ms, "library_ms": lib}
        del x, w
        torch.cuda.empty_cache()
    print(json.dumps({
        "root": str(root), "device": cs.smi(), "layers": layers,
        "ms": sum(v["ms"] for v in layers.values()),
        "library_ms": sum(v["library_ms"] for v in layers.values())}),
        flush=True)


if __name__ == "__main__":
    main()
