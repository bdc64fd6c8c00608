"""The port's dry-run records beside the reference's HLO figures, as a
table of ratios (port / reference), one row a cell: one architecture's
cells, or every cell of ``configs.all_cells()`` with ``--arch all``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_parity.py \\
        --mesh 16,16 --layers 2
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/dryrun_parity.py \\
        --mesh 2,2 --layers 2 --arch all

Both sides run through ``dryrun_cells.run_both``, at the same depth cut
(``--layers``, raised to a whole pattern unit: ``dryrun_cells.depth``),
the reference's scans unrolled (``REPRO_UNROLL_SCANS=1``: a rolled body is
counted once). Prints one JSON line a cell and side, then the table.
"""

import argparse
import json
import sys

import dryrun_cells as dc

FIGURES = [("argument bytes", lambda r: r["bytes_per_device"]
            ["argument_bytes"]),
           ("output bytes", lambda r: r["bytes_per_device"]
            ["output_bytes"]),
           ("FLOPs", lambda r: r["hlo_flops"]),
           ("bytes accessed", lambda r: r["hlo_bytes"])]
FIGURES += [(f"wire {k}", (lambda k: lambda r: r["collectives"][k])(k))
            for k in ("all-reduce", "all-gather", "reduce-scatter",
                      "all-to-all", "collective-permute", "total")]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16,16")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--arch", default="qwen2_5_3b",
                    help="an arch id, or 'all': every cell of all_cells()")
    ap.add_argument("--shapes", default="train_4k,prefill_32k,decode_32k",
                    help="one arch's shapes (ignored with --arch all)")
    ap.add_argument("--timeout", type=float, default=3600)
    args = ap.parse_args(argv)
    from repro_torch import configs

    cells = ([(a, s.name) for a, s in configs.all_cells()]
             if args.arch == "all"
             else [(args.arch, s) for s in args.shapes.split(",")])
    got = dc.run_both(cells, tuple(int(x) for x in args.mesh.split(",")),
                      args.layers, unroll=True, timeout=args.timeout)
    for side in ("ref", "port"):
        for arch, s in cells:
            r = got[side][f"{arch}/{s}"]
            print(json.dumps({"side": side, "arch": arch, "shape": s,
                              "mesh": args.mesh, "layers": r["n_layers"],
                              **{k: r[k] for k in ("bytes_per_device",
                                                   "hlo_flops", "hlo_bytes",
                                                   "collectives")}}))
    print("| cell | " + " | ".join(name for name, _ in FIGURES) + " |")
    print("|---|" + "---|" * len(FIGURES))
    for arch, s in cells:
        row = []
        for _, get in FIGURES:
            a = get(got["port"][f"{arch}/{s}"])
            b = get(got["ref"][f"{arch}/{s}"])
            row.append(f"{a / b:.3f}" if b else
                       ("0 / 0" if not a else f"{a:.3g} / 0"))
        print(f"| {arch} {s} | " + " | ".join(row) + " |")
    return got


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
