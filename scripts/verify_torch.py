"""Static verification sweep of the PyTorch/CUDA port: every instrumented op
of the ``cuda`` and ``im2col`` backends, on the CPU, with meta tensors.

Each dispatch goes through ``repro_torch.ops.explain(audit=True)``: the
``repro_torch.verify`` auditor abstractly interprets the CUDA launch's
access plan and the dispatch fails unless the counted words reproduce
``words_fn`` exactly, the CTA's shared memory fits the target, the walk's
CTAs are the launch's and every ``cp.async`` ring schedule is hazard-free.
The run itself is therefore the assertion; rows are also emitted.

    PYTHONPATH=src python scripts/verify_torch.py              # --target h100
    PYTHONPATH=src python scripts/verify_torch.py --target tpu_v5e --json V.json
    PYTHONPATH=src python scripts/verify_torch.py --mutants   # auditor self-test

``--target h100`` (the default) sweeps the shapes of ``chip_smoke.py``'s
main paths at full width: the five ResNet-50 layers at batch 1000 on
``cuda``, ``im2col`` and ``conv2d_q``, the three int8 GEMMs, Qwen2.5-3B's
prefill and decode attention, paged decode (every slot live: meta tensors
carry no lengths) and the hybrid's eight conv1d prefill shapes. Each row
also carries the issued words, what the counter does not charge and the
shortfall. ``--target tpu_v5e`` sweeps the reference's 29 dispatches
(``scripts/verify.py``) under the reference's target: rows whose plan no
CUDA launch configuration covers carry the counter only, with the reason.

Exit codes: 0 clean; 1 audit/lint violations; 3 a seeded mutant escaped.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_REPO / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import ops  # noqa: E402
from repro_torch.configs.resnet50_convs import RESNET50  # noqa: E402
from repro_torch.plan import H100, TPU_V5E  # noqa: E402
from repro_torch.verify import install_plan_audit  # noqa: E402
from repro_torch.verify.lint import run_lint  # noqa: E402

# The reference's serving-bench geometry (benchmarks/serving_bench.py)
BATCH = 4
MAX_LEN = 512
BLOCK = 16
SNAPSHOTS = (
    ("decode/B4_len12", 4, 12),
    ("decode/B4_len50", 4, 50),
    ("decode/B4_len200", 4, 200),
)
# chip_smoke.py's main-path shapes
CONV_BATCH = 1000
INT8_GEMMS = {"512x384x256": (512, 384, 256),
              "2048x2048x2048": (2048, 2048, 2048),
              "conv5_x Im2Col 49000x4608x512": (CONV_BATCH * 49, 4608, 512)}


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def contexts(target):
    return {be: ops.ExecutionContext(target=target, backend=be, device="cpu")
            for be in ("cuda", "im2col")}


def row(name: str, decision) -> dict:
    """One audited dispatch (``decision`` from ``explain(audit=True)``)."""
    assert decision.audited is not None, f"{name}: dispatch was not audited"
    rep = decision.audit_report
    return {
        "name": name,
        "chosen": decision.chosen,
        "measured_words": decision.measured_words,
        "audited_words": decision.audited,
        "bound_ratio": decision.bound_ratio,
        "issued_words": rep.issued_words,
        "uncounted": rep.uncounted,
        "shortfall": rep.shortfall,
        "grid": list(rep.launch.grid),
        "block": list(rep.launch.block),
        "smem_bytes": rep.launch.smem_bytes,
    }


def counter_row(name: str, decision, reason: str) -> dict:
    """A dispatch no CUDA launch configuration covers: the counter only."""
    return {"name": name, "chosen": decision.chosen,
            "measured_words": decision.measured_words, "audited_words": None,
            "bound_ratio": decision.bound_ratio, "refused": reason}


def audited(name: str, op: str, ctx, **kw) -> dict:
    """Audit one dispatch; under a target the CUDA kernels were not made
    for, a launch configuration may refuse the plan (ValueError), and the
    row keeps the counter only."""
    try:
        return row(name, ops.explain(op, ctx, audit=True, **kw))
    except ValueError as e:
        if ctx.target is H100:
            raise
        return counter_row(name, ops.explain(op, ctx, **kw), str(e))


def conv_inputs(s, dtype):
    H = (s.h_O - 1) * s.sh + s.h_F
    W = (s.w_O - 1) * s.sw + s.w_F
    return (meta((s.N, s.c_I, H, W), dtype),
            meta((s.c_O, s.c_I, s.h_F, s.w_F), dtype))


def sweep_convs(target, batch=None):
    """The five ResNet-50 layers on both conv backends."""
    rows = []
    ctx = contexts(target)
    for lname, s in RESNET50.items():
        if batch is not None:
            s = dataclasses.replace(s, N=batch)
        xs, ws = conv_inputs(s, torch.bfloat16)
        kw = {"spec_args": (xs, ws), "spec_kw": {"stride": (s.sh, s.sw)}}
        rows.append(audited(f"conv2d/{lname}/cuda", "conv2d",
                            ctx["cuda"], **kw))
        rows.append(audited(f"conv2d/{lname}/im2col", "conv2d",
                            ctx["im2col"], **kw))
    return rows


def sweep_gemm_conv1d(target):
    rows = []
    ctx = contexts(target)["cuda"]
    for m, k, n in ((512, 384, 256), (2048, 2048, 2048), (23328, 576, 64)):
        a, b = meta((m, k), torch.bfloat16), meta((k, n), torch.bfloat16)
        rows.append(audited(f"matmul/{m}x{k}x{n}", "matmul", ctx,
                            spec_args=(a, b)))
    for B, L, D, K in ((2, 33, 130, 4), (4, 256, 512, 4)):
        x, w = meta((B, L, D), torch.bfloat16), meta((K, D), torch.bfloat16)
        rows.append(audited(f"conv1d_causal/B{B}_L{L}_D{D}_K{K}",
                            "conv1d_causal", ctx, spec_args=(x, w)))
    return rows


def sweep_quant(target, batch=None, gemms=None):
    rows = []
    ctx = contexts(target)["cuda"]
    for lname, s in RESNET50.items():
        if batch is not None:
            s = dataclasses.replace(s, N=batch)
        xs, ws = conv_inputs(s, torch.int8)
        sc = meta((1, s.c_O), torch.float32)
        rows.append(audited(f"conv2d_q/{lname}/cuda", "conv2d_q", ctx,
                            dtype="int8", spec_args=(xs, ws, sc),
                            spec_kw={"stride": (s.sh, s.sw)}))
    gemms = gemms or {f"{m}x{k}x{n}": (m, k, n)
                      for m, k, n in ((512, 384, 256), (2048, 2048, 2048))}
    for name, (m, k, n) in gemms.items():
        a, b = meta((m, k), torch.int8), meta((k, n), torch.int8)
        sc = meta((1, n), torch.float32)
        rows.append(audited(f"matmul_q/{name}", "matmul_q", ctx,
                            dtype="int8", spec_args=(a, b, sc)))
    return rows


def sweep_attention(target):
    """Prefill + contiguous decode + paged decode, as the reference's
    serving-bench snapshots (the smoke Qwen config)."""
    from repro_torch.configs import get_smoke
    from repro_torch.serving import kv

    rows = []
    ctx = contexts(target)["cuda"]
    dt = torch.bfloat16
    q = meta((2, 8, 128, 64), dt)
    kvs = meta((2, 8, 128, 64), dt)
    rows.append(audited("attention/prefill_B2_H8_L128", "attention", ctx,
                        spec_args=(q, kvs, kvs)))
    cfg = dataclasses.replace(get_smoke("qwen2_5_3b"),
                              compute_dtype="float32")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    num_blocks = kv.plan_pool_blocks(cfg, MAX_LEN, BATCH, BLOCK)
    for name, B, live in SNAPSHOTS:
        w = -(-live // BLOCK)
        qd = meta((B, H, 1, hd), dt)
        rows.append(audited(
            f"attention_decode/{name}", "attention_decode", ctx,
            spec_args=(qd, meta((num_blocks, KV, BLOCK, hd), dt),
                       meta((num_blocks, KV, BLOCK, hd), dt),
                       meta((B, w), torch.int32), meta((B,), torch.int32))))
        rows.append(audited(
            f"attention_contig/{name}", "attention", ctx,
            needs=("per_row_q_offset",),
            spec_args=(qd, meta((B, KV, MAX_LEN, hd), dt),
                       meta((B, KV, MAX_LEN, hd), dt))))
    return rows


def sweep_tpu_v5e() -> list:
    """The reference's 29 dispatches of ``scripts/verify.py``, in its order,
    under ``TPU_V5E``."""
    return (sweep_convs(TPU_V5E) + sweep_gemm_conv1d(TPU_V5E)
            + sweep_quant(TPU_V5E) + sweep_attention(TPU_V5E))


def hybrid_prefill_lengths() -> list:
    """chip_smoke.py's hybrid serve: its 8 prompt lengths, distinct."""
    rng = np.random.default_rng(0)
    lens = rng.integers(3, 257, size=8)
    lens[1] = 300
    lens[5], lens[6] = 1, 2
    return sorted({int(n) for n in lens})


def serving_lengths() -> list:
    """chip_smoke.py's Qwen serve: its 8 prompt lengths."""
    rng = np.random.default_rng(0)
    return [int(n) for n in rng.integers(17, 201, size=8)]


def sweep_h100() -> list:
    """chip_smoke.py's main paths at full width under ``H100``."""
    from repro_torch.configs import get_config

    rows = sweep_convs(H100, CONV_BATCH)
    rows += sweep_quant(H100, CONV_BATCH, INT8_GEMMS)
    ctx = contexts(H100)["cuda"]
    cfg = get_config("qwen2_5_3b")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    lens = serving_lengths()
    Lq, Lk = -(-lens[0] // 16) * 16, 512
    dt = torch.bfloat16
    rows.append(audited(
        f"attention/qwen prefill Lq{Lq}_Lk{Lk}", "attention", ctx,
        needs=("dynamic_q_offset", "key_mask"),
        spec_args=(meta((1, H, Lq, hd), dt), meta((1, KV, Lk, hd), dt),
                   meta((1, KV, Lk, hd), dt))))
    rows.append(audited(
        f"attention/qwen contiguous decode B4_Lk{Lk}", "attention", ctx,
        needs=("per_row_q_offset",),
        spec_args=(meta((4, H, 1, hd), dt), meta((4, KV, Lk, hd), dt),
                   meta((4, KV, Lk, hd), dt))))
    w = -(-(max(lens) + 32) // 16)
    nb = 1 + 4 * w
    rows.append(audited(
        f"attention_decode/qwen paged B4_w{w}", "attention_decode", ctx,
        spec_args=(meta((4, H, 1, hd), dt), meta((nb, KV, 16, hd), dt),
                   meta((nb, KV, 16, hd), dt), meta((4, w), torch.int32),
                   meta((4,), torch.int32))))
    hyb = get_config("jamba_1_5_large")
    D, K = hyb.d_inner, hyb.conv_kernel
    for L in hybrid_prefill_lengths():
        rows.append(audited(
            f"conv1d_causal/jamba prefill L{L}", "conv1d_causal", ctx,
            spec_args=(meta((1, L, D), dt), meta((K, D), dt))))
    return rows


def run_mutants() -> int:
    from repro_torch.verify.mutants import run_seeded_mutants

    escaped = 0
    for name, caught, detail in run_seeded_mutants():
        tag = {True: "caught", False: "ESCAPED", None: "not ported"}[caught]
        print(f"mutant {name:22s} {tag}: {detail[:100]}")
        escaped += caught is False
    return escaped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", choices=("h100", "tpu_v5e"), default="h100")
    ap.add_argument("--json", help="write audited rows to this path")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--mutants", action="store_true",
                    help="run the seeded-mutant self-test and exit")
    args = ap.parse_args(argv)

    if args.mutants:
        escaped = run_mutants()
        if escaped:
            print(f"verify: {escaped} seeded mutant(s) escaped the auditor")
            return 3
        print("verify: all ported seeded mutants caught")
        return 0

    rc = 0
    if not args.skip_lint:
        found = run_lint()
        for viol in found:
            print(viol)
        if found:
            print(f"verify: {len(found)} lint violation(s)")
            rc = 1

    # every plan built below also passes construction-time validation
    install_plan_audit()
    try:
        rows = sweep_h100() if args.target == "h100" else sweep_tpu_v5e()
    except Exception as e:  # the run is the assertion: report and fail
        print(f"verify: FAILED — {type(e).__name__}: {e}")
        return 1

    for r in rows:
        if r["audited_words"] is None:
            print(f"{r['name']:44s} [{r['chosen']:6s}] "
                  f"words={r['measured_words']:.6e} not audited: "
                  f"{r['refused'][:60]}")
            continue
        print(f"{r['name']:44s} [{r['chosen']:6s}] "
              f"words={r['measured_words']:.6e} audited exactly; issued "
              f"{r['issued_words']:.6e}, shortfall {r['shortfall']:.0f}")
    n_audited = sum(r["audited_words"] is not None for r in rows)
    print(f"verify: {len(rows)} dispatches, {n_audited} audited")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json} ({len(rows)} rows)")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
