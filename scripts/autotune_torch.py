"""The port's autotuner gate on the five ResNet-50 layers at batch 1000 (bf16
in, f32 out, the ``H100`` target): the measured frontier search must never
lose to the analytic LP plan, and serving must never re-search.

For each layer the sweep records the analytic plan (its tiles and the exact
``measured_words`` of ``ops.explain`` on meta tensors) beside the winner of
``Planner(H100, autotune=...)`` and checks:

  * tuned seconds <= analytic seconds under the search's timer: the offline
    alpha-beta model (``--timer roofline``, the default without a card:
    ``predicted_seconds`` of the analytic plan at its measured words) or
    device time (``--timer device``, the default on a card: the analytic
    tiles' time in the same search, from its ``SearchReport``);
  * tuned words <= max(bound_cap, the analytic ratio) x the Thm 2.1 bound;
  * a ``Planner.cache.save()`` / ``clear()`` / ``load()`` round trip, then
    re-planning every layer, runs zero new searches
    (``autotune.search_count()``) and serves the same tiles.

    PYTHONPATH=src python scripts/autotune_torch.py \
        [--timer auto|roofline|device] [--json PATH]

Prints one JSON line a layer and a summary line; exits 2 on a violated
contract, 0 otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import ops  # noqa: E402
from repro_torch.core.conv_model import (  # noqa: E402
    Precision, resnet50_layers)
from repro_torch.plan import (  # noqa: E402
    H100, AutotunePolicy, ConvSpec, Planner, predicted_seconds)
from repro_torch.plan import autotune as plan_autotune  # noqa: E402

BATCH = 1000
EXPLAIN = ops.ExecutionContext(target=H100, backend="cuda", device="cpu")


def layer_specs() -> dict:
    return {name: ConvSpec(N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O,
                           h_O=s.h_O, w_F=s.w_F, h_F=s.h_F, sw=s.sw, sh=s.sh,
                           prec=Precision(0.5, 0.5, 1.0))
            for name, s in resnet50_layers(BATCH).items()}


def explain(spec: ConvSpec):
    """The decision serving would make for the layer (meta tensors)."""
    H = (spec.h_O - 1) * spec.sh + spec.h_F
    W = (spec.w_O - 1) * spec.sw + spec.w_F
    x = torch.empty((spec.N, spec.c_I, H, W), dtype=torch.bfloat16,
                    device="meta")
    w = torch.empty((spec.c_O, spec.c_I, spec.h_F, spec.w_F),
                    dtype=torch.bfloat16, device="meta")
    return ops.explain("conv2d", EXPLAIN, spec_args=(x, w),
                       spec_kw={"stride": (spec.sh, spec.sw),
                                "out_dtype": torch.float32})


def sweep(policy: AutotunePolicy) -> list:
    """Analytic-against-tuned records for every layer, from a cleared cache
    so that the analytic rows are analytic."""
    Planner.cache.clear()
    tuner = Planner(H100, autotune=policy)
    out = []
    for name, spec in layer_specs().items():
        base = explain(spec)
        if base.plan_source != "analytic":
            raise RuntimeError(f"{name}: a cleared cache served a "
                               f"{base.plan_source} plan")
        ep = tuner.plan(spec)
        rep = plan_autotune.search_report(spec, H100)
        after = explain(spec)
        if after.plan_source != "tuned" or \
                after.measured_words != ep.tuned.winner_words:
            raise RuntimeError(f"{name}: serving resolved a "
                               f"{after.plan_source} plan of "
                               f"{after.measured_words} words")
        analytic_s = (rep.analytic_candidate.seconds if rep.timer == "device"
                      else predicted_seconds(base.plan, base.measured_words))
        out.append({
            "layer": name, "timer": rep.timer,
            "analytic_tiles": list(base.plan.tiles),
            "tuned_tiles": list(ep.tiles),
            "analytic_words": base.measured_words,
            "tuned_words": ep.tuned.winner_words,
            "analytic_bound_ratio": base.bound_ratio,
            "tuned_bound_ratio": after.bound_ratio,
            "analytic_seconds": analytic_s,
            "tuned_seconds": ep.tuned.winner_seconds,
            "candidates": {"enumerated": rep.enumerated,
                           "frontier": rep.frontier, "kept": rep.kept,
                           "timed": len(rep.timed),
                           "not_auditable": dict(rep.not_auditable)}})
    return out


def check(records: list, policy: AutotunePolicy) -> list:
    """(layer, problem) pairs; empty when every contract holds."""
    bad = []
    for r in records:
        if r["tuned_seconds"] > r["analytic_seconds"]:
            bad.append((r["layer"], f"tuned {r['tuned_seconds']:.6e} s "
                        f"slower than analytic {r['analytic_seconds']:.6e} s"))
        cap = max(policy.bound_cap, r["analytic_bound_ratio"])
        if r["tuned_bound_ratio"] > cap + 1e-9:
            bad.append((r["layer"], f"tuned words "
                        f"{r['tuned_bound_ratio']:.3f}x the bound exceed "
                        f"the {cap:.3f}x cap"))
    return bad


def check_zero_research(records: list) -> list:
    """save -> clear -> load -> re-plan every layer: zero new searches and
    the same tuned tiles."""
    bad = []
    before = plan_autotune.search_count()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plan_cache.json")
        Planner.cache.save(path)
        Planner.cache.clear()
        Planner.cache.load(path)
    serving = Planner(H100)  # no policy: the records must serve
    for r, spec in zip(records, layer_specs().values()):
        ep = serving.plan(spec)
        if ep.tuned is None or list(ep.tiles) != r["tuned_tiles"]:
            bad.append((r["layer"], "the reloaded cache does not serve the "
                        f"tuned winner (tiles {list(ep.tiles)})"))
    delta = plan_autotune.search_count() - before
    if delta:
        bad.append(("sweep", f"{delta} re-search(es) after a save/clear/load "
                    "round trip; serving must run none"))
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timer", default="auto",
                    choices=("auto", "roofline", "device"))
    ap.add_argument("--json", metavar="PATH",
                    help="write the per-layer records to PATH")
    args = ap.parse_args(argv)
    policy = AutotunePolicy(timer=args.timer)
    records = sweep(policy)
    for r in records:
        print(json.dumps(r), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
    problems = check(records, policy) + check_zero_research(records)
    device = (torch.cuda.get_device_name(0) if records[0]["timer"] == "device"
              else "none (offline model)")
    print(json.dumps({"autotune_gate": "ok" if not problems else "fail",
                      "layers": len(records), "timer": records[0]["timer"],
                      "device": device,
                      "searches": plan_autotune.search_count(),
                      "problems": [f"{k}: {v}" for k, v in problems]}),
          flush=True)
    return 2 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
