"""Tables of the dry-run records in ``results/dryrun_torch/`` (the port of
``repro.analysis.report``; the records are ``repro_torch.launch.dryrun``'s,
with the reference's keys).

    PYTHONPATH=src python -m repro_torch.analysis.report
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
    recs = load()
    print(f"{len(recs)} records\n")
    print(dryrun_table(recs))
    print()
    print(roofline_table(recs))
    picks = pick_hillclimb_cells(recs)
    print("\nhillclimb picks:")
    for k, r in picks.items():
        print(f"  {k}: {r['arch']} x {r['shape']} (mfu={r['mfu']:.4f}, "
              f"dominant={r['dominant']})")
