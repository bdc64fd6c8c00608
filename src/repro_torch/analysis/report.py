"""Tables of the dry-run records in ``results/dryrun_torch/`` (the port of
``repro.analysis.report``; the records are ``repro_torch.launch.dryrun``'s,
with the reference's keys).

    PYTHONPATH=src python -m repro_torch.analysis.report [--cells] [DIR]

``--cells`` prints :func:`cells_table` alone (one row a cell).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch")

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(variant: str = "base", directory: Optional[str] = None
         ) -> List[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(directory or RESULTS,
                                            "*.json"))):
        with open(fn) as f:
            r = json.load(f)
        if r.get("variant", "base") == variant:
            recs.append(r)
    recs.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 9, r["mesh"]))
    return recs


def _fmt_bytes(b: float) -> str:
    if b >= 1e9:
        return f"{b / 1e9:.2f}GB"
    if b >= 1e6:
        return f"{b / 1e6:.1f}MB"
    return f"{b / 1e3:.0f}KB"


def dryrun_table(recs: List[dict]) -> str:
    """FLOPs, bytes and wire bytes a device, temps and the host seconds of
    each record (the reference's ``compile`` column is the port's run:
    ``run_s``)."""
    out = ["| arch | shape | mesh | FLOPs/chip | bytes/chip | wire/chip | "
           "temp/chip | run |",
           "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        chips = r["chips"]
        secs = r.get("run_s", r.get("compile_s", 0))
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['hlo_flops'] / chips:.3e} "
            f"| {r['hlo_bytes'] / chips:.3e} "
            f"| {_fmt_bytes(r['wire_bytes_per_chip'])} "
            f"| {_fmt_bytes(r['bytes_per_device'].get('temp_bytes', 0))} "
            f"| {secs:.0f}s |")
    return "\n".join(out)


_WIRE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _cell_fields(r: dict) -> List[str]:
    mem = r["bytes_per_device"]
    wire = " / ".join(_fmt_bytes(r["collectives"][k])
                      if r["collectives"].get(k) else "0"
                      for k in _WIRE_KINDS)
    return [_fmt_bytes(mem["argument_bytes"]),
            _fmt_bytes(mem["output_bytes"]), _fmt_bytes(mem["temp_bytes"]),
            f"{r['hlo_flops'] / r['chips']:.3e}", wire,
            f"{r.get('host_s', r.get('run_s', 0)):.1f}s"]


def cells_table(recs: List[dict]) -> str:
    """Per device: argument, output and temp bytes, FLOPs and wire bytes by
    kind (all-reduce, all-gather, reduce-scatter, all-to-all,
    collective-permute), with each record's host seconds (``host_s``).
    One row a cell: a cell recorded on several meshes gives each field as
    "16x16 ; 2x16x16" (the meshes in that order)."""
    rows: Dict[tuple, Dict[str, dict]] = {}
    for r in recs:
        rows.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    out = ["| arch | shape | mesh | arguments | outputs | temps | FLOPs | "
           "wire AR / AG / RS / A2A / CP | host |",
           "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), by_mesh in rows.items():
        meshes = sorted(by_mesh, key=len)
        fields = zip(*(_cell_fields(by_mesh[m]) for m in meshes))
        out.append(f"| {arch} | {shape} | {' ; '.join(meshes)} | "
                   + " | ".join(" ; ".join(f) for f in fields) + " |")
    return "\n".join(out)


def roofline_table(recs: List[dict], mesh: str = "16x16") -> str:
    out = ["| arch | shape | compute | memory | collective | dominant | "
           "useful | roofline-MFU |",
           "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['compute_s'] * 1e3:.2f}ms | {r['memory_s'] * 1e3:.2f}ms "
            f"| {r['collective_s'] * 1e3:.2f}ms | **{r['dominant']}** "
            f"| {r['useful_flops_frac']:.3f} | {r['mfu']:.4f} |")
    return "\n".join(out)


def collective_breakdown(recs: List[dict], arch: str, shape: str,
                         mesh: str = "16x16") -> Dict[str, float]:
    for r in recs:
        if (r["arch"], r["shape"], r["mesh"]) == (arch, shape, mesh):
            return r["collectives"]
    return {}


def pick_hillclimb_cells(recs: List[dict], mesh: str = "16x16"
                         ) -> Dict[str, dict]:
    """worst roofline fraction / most collective-bound / paper-representative
    (the conv1d-bearing hybrid: jamba train)."""
    pool = [r for r in recs if r["mesh"] == mesh]
    if not pool:
        return {}
    worst = min(pool, key=lambda r: r["mfu"])
    coll = max(pool, key=lambda r: r["collective_s"] / max(r["step_time_s"],
                                                           1e-12))
    rep = next((r for r in pool
                if r["arch"] == "jamba_1_5_large" and r["shape"] == "train_4k"),
               pool[0])
    return {"worst_mfu": worst, "most_collective": coll, "paper_rep": rep}


if __name__ == "__main__":
    import sys

    args = sys.argv[1:]
    cells_only = "--cells" in args
    dirs = [a for a in args if a != "--cells"]
    recs = load(directory=dirs[0] if dirs else None)
    if cells_only:
        print(cells_table(recs))
        sys.exit(0)
    print(f"{len(recs)} records\n")
    print(dryrun_table(recs))
    print()
    print(roofline_table(recs))
    picks = pick_hillclimb_cells(recs)
    print("\nhillclimb picks:")
    for k, r in picks.items():
        print(f"  {k}: {r['arch']} x {r['shape']} (mfu={r['mfu']:.4f}, "
              f"dominant={r['dominant']})")
