"""The port's dry-run records beside the reference's HLO figures, as a
table of ratios (port / reference), for Qwen2.5-3B's cells on one mesh.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_parity.py \\
        --mesh 16,16 --layers 2

The reference lowers on fake XLA host devices with an Auto-axis mesh and
its scans unrolled (``REPRO_UNROLL_SCANS=1``: a rolled body is counted
once); the port runs on a fake process group of the same size. Both at
the same depth cut. Prints one JSON line a cell and side, then the table.
"""

import argparse
import json
import math
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16,16")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--arch", default="qwen2_5_3b")
    ap.add_argument("--shapes", default="train_4k,prefill_32k,decode_32k")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split(","))
    n = math.prod(shape)
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    os.environ["REPRO_UNROLL_SCANS"] = "1"
    import jax
    from jax.sharding import AxisType

    from repro.launch import dryrun as jdr
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh

    keep = ("bytes_per_device", "hlo_flops", "hlo_bytes", "collectives")
    ov = {"_n_layers": args.layers}
    jmesh = jax.make_mesh(shape, ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    recs = {}
    for s in args.shapes.split(","):
        r = jdr.run_cell(args.arch, s, mesh=jmesh, save=False,
                         verbose=False, overrides=ov)
        recs[("ref", s)] = {k: r[k] for k in keep}
    with dr.fake_group(n):
        mesh = make_host_mesh(*shape, device_type="cpu")
        for s in args.shapes.split(","):
            r = dr.run_cell(args.arch, s, mesh=mesh, save=False,
                            verbose=False, overrides=ov)
            recs[("port", s)] = {k: r[k] for k in keep}
    for (side, s), r in recs.items():
        print(json.dumps({"side": side, "arch": args.arch, "shape": s,
                          "mesh": args.mesh, "layers": args.layers, **r}))
    rows = [("argument bytes", lambda r: r["bytes_per_device"]
             ["argument_bytes"]),
            ("output bytes", lambda r: r["bytes_per_device"]
             ["output_bytes"]),
            ("FLOPs", lambda r: r["hlo_flops"]),
            ("bytes accessed", lambda r: r["hlo_bytes"])]
    rows += [(f"wire {k}", (lambda k: lambda r: r["collectives"][k])(k))
             for k in ("all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute", "total")]
    shapes = args.shapes.split(",")
    print("| figure | " + " | ".join(shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    for name, get in rows:
        cells = []
        for s in shapes:
            a, b = get(recs[("port", s)]), get(recs[("ref", s)])
            cells.append(f"{a / b:.3f}" if b else
                         ("0 / 0" if not a else f"{a:.3g} / 0"))
        print(f"| {name} | " + " | ".join(cells) + " |")
    return recs


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
