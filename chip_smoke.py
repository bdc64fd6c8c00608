"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Two paths. The conv path is the paper's experiment: the five ResNet-50
convolutions at their published widths and batch 1000, planned for the H100
preset and run through ``repro_torch.ops.conv2d`` on the ``cuda`` backend
(the hand-written direct conv) and the ``im2col`` backend (patch expansion +
the hand-written GEMM), with bf16 inputs and f32 outputs. The serving path
is ``repro_torch.serving.Engine`` serving Qwen2.5-3B at its published widths
(36 layers, d_model 2048, 16 query heads over 2 KV heads, hd 128) with
seeded random weights, through the hand-written flash-attention and
paged-decode kernels. Phases, each fatal on failure:

  1. device: a CUDA device is required; name, power limit and versions;
  2. build: all four kernels, one nvcc each, started together;
  3. conv and GEMM kernels against their plain PyTorch versions on ragged,
     stride-2 and one main-path shape (TF32 off);
  4. the conv path, launch counters set to 0 just before and read just
     after: one JSON line per layer and backend (tiles, measured words, bound
     ratio, Im2Col/tiled gap, median ms, F.conv2d ms, launches, error);
  5. each conv-path kernel's time beside its plain version, one library call
     and its bound at the conv path's shapes;
  6. flash attention and paged decode against their plain versions (bf16 and
     f32; GQA groups 1 and 8; hd 64 and 128; ragged lengths; int and
     per-row offsets; a pad-tail key mask with one fully masked row; paged
     tables with padding and a dead row on block 0);
  7. the serving path inside ``ops.record_dispatch()``: the paged engine
     and the contiguous engine on the same 8 greedy requests, then a
     cache-less forward of one prompt, the counters set to 0 just before
     and read just after each of the three runs (the paged engine must
     launch both kernels, the other two runs the flash kernel); every
     request must finish "length" with 32 tokens, both engines must give
     each request the same first token, and no attention decision may
     leave ``cuda``; then
     teacher-forced logits of two requests under the ``cuda`` and ``torch``
     backends, and every generated token of both engines against the
     cache-less ``torch`` forward (tolerances below); then the paged
     engine's serve once more under ``torch.profiler``: device time by
     kernel kind and by kernel, the device's busy share against the
     untraced serve's wall time, and the traced serve's own wall time and
     decode step (the profiler's cost on the host);
  8. each attention kernel's time beside its plain version, its library call
     and its bound at the serving shapes, and ``ops.explain``'s words and
     bound ratio for one prefill and one decode call;
  9. the ``kernels`` JSON line, the card's name and power limit, and the
     last line ``{"ok": true, "device": {...}}``.

Inputs are random, made on the device from fixed seeds. Tolerance: an
output agrees when max|kernel - plain| <= tol * max(1, max|plain|), with tol
1e-4 for f32 outputs (both sides accumulate in f32, in a different order;
bf16 x bf16 products are exact in f32) and 2^-7 for bf16 outputs (one bf16
rounding).

Teacher-forced logits: the two backends share every bf16 projection and
differ only in the attention outputs, which may round to neighbouring bf16
values (2^-8 relative). One such rounding enters the residual stream per
attention layer and is carried through the remaining layers, so the logit
difference grows like a random walk over the layers: the check allows
max|cuda - torch| <= 4 * 2^-8 * sqrt(n_layers) * max(1, max|logits|) (four
standard deviations of that walk; 0.094 of the logit scale at 36 layers)
and prints the measured error beside it.

Generated tokens: the engines decode from their KV caches (paged blocks,
shared prefixes, per-row slots), so each request's prompt and generated
tokens go once more through the cache-less forward under the ``torch``
backend. Each greedy token was the argmax of the engine's logits, which
differ from those of that forward only by attention roundings; so the
token's logit there must lie within the same allowance of its row's max
(a near-tie where the two argmaxes differ). A wrong block table, slot
write or shared-block mapping gives the token a logit far from the max.
The check prints how many positions were the exact argmax.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ARCH = "qwen2_5_3b"
BATCH = 1000
WARMUP, TIMED = 1, 5
BLOCK = 8  # images compared with the plain version at each end of the batch
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def median_ms(fn, warmup: int = WARMUP, timed: int = TIMED) -> float:
    """Median of per-call CUDA-event times, after warm-up calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, want: torch.Tensor):
    """(max abs error, allowed error) under the stated tolerance."""
    tol = TOL[want.dtype]
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"shape {tuple(got.shape)} vs {tuple(want.shape)} or "
             "non-finite output")
    err = (got - want).abs().max().item()
    return err, tol * max(1.0, want.abs().max().item())


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def serving_phases(gen: torch.Generator, record) -> list:
    """Phases 6-8 (module docstring): the attention kernels against their
    plain versions, the serving path at full width, and the attention
    kernels' times. Returns the two kernels' entries of the ``kernels``
    line (``max_abs_err`` is filled in by the caller)."""
    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import get_config
    from repro_torch.kernels import (KERNELS, flash_attention,
                                     flash_attention_plain,
                                     paged_decode_attention,
                                     paged_decode_plain)
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    from repro_torch.serving import Engine, Request

    dev = torch.device("cuda")

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    # -- 6. attention kernels against their plain versions ------------------
    gen.manual_seed(SEED + 10)
    B = 2
    for dt in (torch.bfloat16, torch.float32):
        for g in (1, 8):
            for hd in (64, 128):
                for Lq in (1, 37, 200):
                    for Lk in (37, 512):
                        rows = B * 2
                        q = randn((rows, g * Lq, hd), dt)
                        k = randn((rows, Lk, hd), dt)
                        v = randn((rows, Lk, hd), dt)
                        top = max(0, Lk - Lq)
                        km = torch.ones((B, Lk), dtype=torch.bool, device=dev)
                        km[0, Lk - 5:] = False  # a pad tail
                        km[1, :] = False  # a fully masked row: averages V
                        for kind, off, mask in (
                                ("int", top, None),
                                ("rows", randint(0, top + 1, (rows,)), None),
                                ("mask", 0, km)):
                            got = flash_attention(q, k, v, q_offset=off,
                                                  q_seq_len=Lq, key_mask=mask)
                            torch.cuda.synchronize()
                            want = flash_attention_plain(
                                q, k, v, True, off,
                                Lq if g > 1 else None, None, mask)
                            record("flash_attention", got, want,
                                   f"{dt} g={g} hd={hd} Lq={Lq} Lk={Lk} "
                                   f"{kind}")
    Bp, KVp, gp, hdp, bsp, wp = 4, 2, 8, 128, 16, 32
    nb = 1 + Bp * wp
    for dt in (torch.bfloat16, torch.float32):
        kp = randn((nb, KVp, bsp, hdp), dt)
        vp = randn((nb, KVp, bsp, hdp), dt)
        q = randn((Bp, KVp * gp, 1, hdp), dt)
        tables = (1 + torch.randperm(nb - 1, generator=gen, device=dev)
                  [:Bp * wp]).reshape(Bp, wp).to(torch.int32)
        tables[1, 2:] = 0  # padding points at garbage block 0
        tables[3, :] = 0  # a dead row reads garbage block 0
        lengths = torch.tensor([wp * bsp, 17, 1, 1], dtype=torch.int32,
                               device=dev)
        tables[2, 1:] = 0
        got = paged_decode_attention(q, kp, vp, tables, lengths)
        torch.cuda.synchronize()
        record("paged_decode", got, paged_decode_plain(q, kp, vp, tables,
                                                       lengths),
               f"{dt} B={Bp} KV={KVp} g={gp} hd={hdp} bs={bsp} w={wp} "
               "lengths (512, 17, 1, 1 dead)")
    del kp, vp, q, k, v
    torch.cuda.empty_cache()

    # -- 7. the serving path ------------------------------------------------
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    master = T.init_params(cfg, seed=SEED, device="cuda")
    params = T.compute_params(master, cfg)
    del master  # the engines and forwards use the bf16 copy
    torch.cuda.synchronize()
    print(f"serving: {cfg.name} at published widths ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
          f"{cfg.hd}, vocab {cfg.padded_vocab}); random weights made on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(17, 201, size=8)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    shared = rng.integers(0, cfg.vocab_size, size=32).astype(np.int32)
    sharing = [i for i in range(len(prompts)) if lens[i] >= 32][:2]
    for i in sharing:  # two requests share a 32-token prefix
        prompts[i][:32] = shared
    ctx = ExecutionContext(target=H100, backend="cuda")
    attn_names = ("flash_attention", "paged_decode")
    serve_launches = dict.fromkeys(attn_names, 0)

    def counted(run: str, must_launch, fn):
        """Counters to 0 just before ``fn``, read just after; fail unless
        every kernel of ``must_launch`` ran. Returns ``fn()`` and the
        run's launches."""
        for k in KERNELS.values():
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launched = {n: KERNELS[n].launches for n in attn_names}
        for n in attn_names:
            serve_launches[n] += launched[n]
        print(f"{run} launches: {json.dumps(launched)}", flush=True)
        for n in must_launch:
            if launched[n] <= 0:
                fail(f"{run}: the {n} kernel was never launched")
        return out, launched

    engines = {"paged": (dict(paged=True), attn_names),
               "contiguous": (dict(paged=False), ("flash_attention",))}
    served, stats = {}, {}
    with ops.record_dispatch() as log:
        for name, (kw, must) in engines.items():
            reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
            eng = Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx,
                         block_size=16, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, launched = counted(f"{name} engine", must,
                                  lambda: eng.serve(reqs))
            wall = time.perf_counter() - t0
            served[name] = reqs
            ntok = sum(len(r.out_tokens) for r in reqs)
            st = eng.stats
            stats[name] = {
                "engine": name, "requests": len(reqs),
                "prompt_lens": [int(n) for n in lens],
                "shared_prefix_requests": sharing,
                "generated_tokens": ntok, "wall_s": wall,
                "tok_per_s": ntok / wall,
                "prefill_ms_mean": 1e3 * statistics.mean(st.prefill_s),
                "prefill_ms_median": 1e3 * statistics.median(st.prefill_s),
                "decode_step_ms_median": 1e3 * statistics.median(st.decode_s),
                "decode_steps": len(st.decode_s), "launches": launched}
            print(json.dumps(stats[name]), flush=True)
            for r in reqs:
                if r.finish_reason != "length" or len(r.out_tokens) != 32:
                    fail(f"{name} engine: a request finished "
                         f"{r.finish_reason!r} with {len(r.out_tokens)} "
                         "tokens, not 'length' with 32")
            del eng
        tokens = torch.as_tensor(prompts[0][None].astype(np.int64),
                                 device=dev)
        with torch.inference_mode():
            (logits, _, _), _ = counted(
                "cache-less forward", ("flash_attention",),
                lambda: T.forward(params, cfg, tokens=tokens, ctx=ctx))
        if (logits.shape != (1, len(prompts[0]), cfg.padded_vocab)
                or not torch.isfinite(logits).all()):
            fail("cache-less forward: bad logits")
    print(f"serving path launches: {json.dumps(serve_launches)}", flush=True)
    attn = [d for d in log if d.op in ("attention", "attention_decode")]
    off = [d for d in attn if d.chosen != "cuda"]
    print(f"serving path dispatch: {len(attn)} attention decisions, "
          f"{len(off)} off cuda", flush=True)
    if not attn or off:
        fail(f"attention decisions chosen off cuda: {off[:3]}")
    firsts = {n: [int(r.out_tokens[0]) for r in reqs]
              for n, reqs in served.items()}
    if firsts["paged"] != firsts["contiguous"]:
        fail(f"first tokens differ between engines: {firsts}")
    same = sum(int(np.array_equal(a.out_tokens, b.out_tokens))
               for a, b in zip(served["paged"], served["contiguous"]))
    print(f"engines agree on the first token of all {len(prompts)} requests; "
          f"whole outputs equal for {same}", flush=True)

    # teacher-forced logits: cuda against torch on the card
    ref_ctx = ExecutionContext(target=H100, backend="torch")

    def allowance(logits):  # the teacher-forced tolerance (docstring)
        return (4 * 2.0 ** -8 * cfg.n_layers ** 0.5
                * max(1.0, logits.abs().max().item()))

    for i in (0, 1):
        r = served["paged"][i]
        seq = np.concatenate([r.prompt, r.out_tokens]).astype(np.int64)
        toks = torch.as_tensor(seq[None], device=dev)
        with torch.inference_mode():
            a, _, _ = T.forward(params, cfg, tokens=toks, ctx=ctx)
            b, _, _ = T.forward(params, cfg, tokens=toks, ctx=ref_ctx)
        err = (a - b).abs().max().item()
        scale = max(1.0, b.abs().max().item())
        allowed = allowance(b)
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        row = {"teacher_forced": i, "tokens": len(seq),
               "max_abs_err": err, "mean_abs_err": (a - b).abs().mean().item(),
               "allowed": allowed, "max_abs_logit": scale,
               "argmax_agreement": agree}
        print(json.dumps(row), flush=True)
        if not err <= allowed:
            fail(f"teacher-forced logits of request {i}: cuda vs torch "
                 f"error {err} above {allowed}")
    del a, b, logits

    # every generated token of both engines against the cache-less torch
    # forward: a near-tie of that row's max (docstring)
    for name, reqs in served.items():
        exact = total = 0
        gaps = []  # (largest gap, allowed) per request
        for i, r in enumerate(reqs):
            seq = np.concatenate([r.prompt, r.out_tokens]).astype(np.int64)
            with torch.inference_mode():
                b, _, _ = T.forward(params, cfg, ctx=ref_ctx,
                                    tokens=torch.as_tensor(seq[None],
                                                           device=dev))
            n, p = len(r.out_tokens), len(r.prompt)
            rows = b[0, p - 1:p - 1 + n].float()  # the logits each token came from
            out = torch.as_tensor(r.out_tokens.astype(np.int64), device=dev)
            gap = (rows.max(-1).values
                   - rows.gather(1, out[:, None])[:, 0]).max().item()
            allowed = allowance(b)
            exact += int((rows.argmax(-1) == out).sum().item())
            total += n
            gaps.append((gap, allowed))
            if not gap <= allowed:
                fail(f"{name} engine, request {i}: a generated token trails "
                     f"the torch forward's max logit by {gap}, above "
                     f"{allowed}")
            del b, rows
        worst = max(gaps, key=lambda ga: ga[0] / ga[1])
        print(json.dumps({"decode_check": name, "tokens": total,
                          "exact_argmax": exact,
                          "max_gap_to_row_max": worst[0],
                          "allowed": worst[1]}), flush=True)
    torch.cuda.empty_cache()

    # where the paged engine's time goes: the same serve again, traced
    eng = Engine(cfg, params, max_len=512, batch_size=4, ctx=ctx,
                 block_size=16, paged=True)
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        traced = 1e3 * (time.perf_counter() - t0)
    by_name, by_kind = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.device_time_total / 1e3
        kind = ("attention kernels" if "flash_kernel" in e.name
                or "paged_decode_kernel" in e.name else
                "GEMMs (cuBLAS)" if "nvjet" in e.name or "gemm" in e.name
                else "other aten kernels")
        for table, key in ((by_name, e.name[:80]), (by_kind, kind)):
            n, t = table.get(key, (0, 0.0))
            table[key] = (n + 1, t + ms)
    busy = sum(t for _, t in by_kind.values())
    untraced = 1e3 * stats["paged"]["wall_s"]
    print(json.dumps({
        "traced": "paged engine, the same 8 requests",
        "untraced_wall_ms": untraced,
        "traced_wall_ms": traced,
        "traced_decode_step_ms_median":
            1e3 * statistics.median(eng.stats.decode_s),
        "device_kernel_ms": busy or "not measured",
        "device_busy_share": busy / untraced if busy else "not measured",
        "decode_steps": len(eng.stats.decode_s),
        "by_kind": {k: {"launches": n, "ms": t}
                    for k, (n, t) in by_kind.items()},
        "top_kernels": [{"name": k, "launches": n, "ms": t}
                        for k, (n, t) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][1])
                        [:10]]}), flush=True)
    del eng, prof

    # -- 8. kernel times at the serving shapes ------------------------------
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = H // KV
    gen.manual_seed(SEED + 20)
    Lq = -(-int(lens[0]) // 16) * 16  # the first request's prefill bucket
    Lk = 512
    q = randn((1, H, Lq, hd), torch.bfloat16)
    k = randn((1, KV, Lk, hd), torch.bfloat16)
    v = randn((1, KV, Lk, hd), torch.bfloat16)
    km = torch.zeros((1, Lk), dtype=torch.bool, device=dev)
    km[0, :int(lens[0])] = True
    km[0, Lq:] = True  # the cache tail past the window stays valid
    off0 = torch.zeros((), dtype=torch.int32, device=dev)
    qf = q.reshape(KV, g * Lq, hd)
    kf, vf = k.reshape(KV, Lk, hd), v.reshape(KV, Lk, hd)
    flash_ms = median_ms(lambda: flash_attention(
        qf, kf, vf, q_offset=off0, q_seq_len=Lq, key_mask=km), 2, 10)
    flash_plain = median_ms(lambda: flash_attention_plain(
        qf, kf, vf, True, off0, Lq, None, km), 1, 5)
    qpos = torch.arange(Lq, device=dev)
    kpos = torch.arange(Lk, device=dev)
    allowed = (kpos[None, :] <= qpos[:, None]) & km[0][None, :]
    sdpa_mask = allowed[None, None]
    flash_lib = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=sdpa_mask, enable_gqa=True), 2, 10)
    pairs = float(allowed.sum().item()) * H  # (query, key) pairs the data needs
    flash_flops = 4.0 * pairs * hd
    needed_keys = float(allowed.any(0).sum().item())  # keys any query sees
    flash_bytes = (q.numel() * 2 * 2 + 2 * needed_keys * KV * hd * 2
                   + km.numel())
    flash_bound, flash_by = bound_ms(flash_flops, flash_bytes,
                                     PEAK_BF16_FLOPS)
    dec_prefill = ops.explain("attention", ctx, dtype=q.dtype,
                              needs=("dynamic_q_offset", "key_mask"),
                              spec_args=(q, k, v))
    print(json.dumps({"kernel_shape": "flash_attention", "phase": "prefill",
                      "B": 1, "H": H, "KV": KV, "Lq": Lq, "Lk": Lk, "hd": hd,
                      "ms": flash_ms, "plain_ms": flash_plain,
                      "library_ms": flash_lib, "bound_ms": flash_bound,
                      "bound_by": flash_by, "gflop_needed": flash_flops / 1e9,
                      "measured_words": dec_prefill.measured_words,
                      "lower_bound_words": dec_prefill.lower_bound,
                      "bound_ratio": dec_prefill.bound_ratio}), flush=True)
    # contiguous-engine decode: 4 rows at their own depths, Lq = 1
    qd = randn((4, H, 1, hd), torch.bfloat16)
    kd = randn((4, KV, Lk, hd), torch.bfloat16)
    vd = randn((4, KV, Lk, hd), torch.bfloat16)
    depth = torch.tensor([230, 120, 60, 17], dtype=torch.int32, device=dev)
    rows_off = depth.repeat_interleave(KV)
    dq = qd.reshape(4 * KV, g, hd)
    dk, dv = kd.reshape(4 * KV, Lk, hd), vd.reshape(4 * KV, Lk, hd)
    dec_ms = median_ms(lambda: flash_attention(dq, dk, dv, q_offset=rows_off,
                                               q_seq_len=1), 2, 20)
    dec_plain = median_ms(lambda: flash_attention_plain(
        dq, dk, dv, True, rows_off, 1), 1, 5)
    dec_lib = median_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=(kpos[None, :] <= depth[:, None])[:, None, None],
        enable_gqa=True), 2, 20)
    dec_needed = float((depth + 1).sum().item()) * H
    dec_bound, dec_by = bound_ms(4.0 * dec_needed * hd,
                                 (2 * qd.numel() + 2 * float(
                                     (depth + 1).sum().item()) * KV * hd) * 2,
                                 PEAK_BF16_FLOPS)
    print(json.dumps({"kernel_shape": "flash_attention",
                      "phase": "contiguous decode", "B": 4, "Lq": 1,
                      "Lk": Lk, "ms": dec_ms, "plain_ms": dec_plain,
                      "library_ms": dec_lib,
                      "bound_ms": dec_bound, "bound_by": dec_by}), flush=True)
    # paged decode: the serving pool's block size, the deepest row's width
    w = -(-(int(lens.max()) + 32) // 16)
    depths = [int(lens.max()) + 31, int(lens[1]) + 16, int(lens[2]) + 8, 40]
    nb = 1 + 4 * w
    kp = randn((nb, KV, 16, hd), torch.bfloat16)
    vp = randn((nb, KV, 16, hd), torch.bfloat16)
    qp = randn((4, H, 1, hd), torch.bfloat16)
    tables = torch.zeros((4, w), dtype=torch.int32, device=dev)
    perm = 1 + torch.randperm(nb - 1, generator=gen, device=dev)
    used = 0
    for r, d in enumerate(depths):
        n = -(-(d + 1) // 16)
        tables[r, :n] = perm[used:used + n].to(torch.int32)
        used += n
    lengths = torch.tensor([d + 1 for d in depths], dtype=torch.int32,
                           device=dev)
    paged_ms = median_ms(lambda: paged_decode_attention(qp, kp, vp, tables,
                                                        lengths), 2, 20)
    paged_plain = median_ms(lambda: paged_decode_plain(qp, kp, vp, tables,
                                                       lengths), 1, 5)
    live = float(sum(d + 1 for d in depths))
    used_entries = sum(-(-(d + 1) // 16) for d in depths)  # table reads needed
    paged_bytes = ((2 * qp.numel() + 2 * live * KV * hd) * 2
                   + (used_entries + len(depths)) * 4)
    paged_bound, paged_by = bound_ms(4.0 * live * H * hd, paged_bytes,
                                     PEAK_BF16_FLOPS)
    dec_decode = ops.explain("attention_decode", ctx, dtype=qp.dtype,
                             spec_args=(qp, kp, vp, tables, lengths))
    print(json.dumps({"kernel_shape": "paged_decode", "phase": "paged decode",
                      "B": 4, "KV": KV, "g": g, "hd": hd, "block_size": 16,
                      "w": w, "lengths": [d + 1 for d in depths],
                      "ms": paged_ms, "plain_ms": paged_plain,
                      "library_ms": None,
                      "library_note": "no single PyTorch call reads a paged "
                                      "pool",
                      "bound_ms": paged_bound, "bound_by": paged_by,
                      "measured_words": dec_decode.measured_words,
                      "lower_bound_words": dec_decode.lower_bound,
                      "bound_ratio": dec_decode.bound_ratio}), flush=True)
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:48",
         "also_replaces": "src/repro/kernels/flash_attention.py:96",
         "launches": serve_launches["flash_attention"], "ms": flash_ms,
         "plain_ms": flash_plain, "bound_ms": flash_bound,
         "bound_by": flash_by, "library_ms": flash_lib, "ok": True,
         "shapes": f"{cfg.name} prefill: B 1, H {H}/{KV}, Lq {Lq}, Lk {Lk}, "
                   f"hd {hd}, bf16, causal + key mask"},
        {"name": "paged_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/flash_attention.py:257",
         "launches": serve_launches["paged_decode"], "ms": paged_ms,
         "plain_ms": paged_plain, "bound_ms": paged_bound,
         "bound_by": paged_by, "library_ms": None, "ok": True,
         "shapes": f"{cfg.name} decode: B 4, KV {KV}, g {g}, hd {hd}, "
                   f"block 16, w {w}, bf16"},
    ]


def main() -> None:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch import ops
    from repro_torch.core.conv_model import resnet50_layers
    from repro_torch.kernels import KERNELS, conv2d_plain, matmul_plain
    from repro_torch.kernels._build import build_all, nvcc_path
    from repro_torch.kernels.conv2d import conv2d as conv2d_kernel
    from repro_torch.kernels.im2col import im2col_patches
    from repro_torch.kernels.matmul import matmul as matmul_kernel
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {nvcc[-1]}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    # -- 2. build -----------------------------------------------------------
    secs = build_all(KERNELS.values())
    print(f"build: {json.dumps(secs)} seconds (parallel nvcc)", flush=True)
    for name, k in KERNELS.items():
        spills = [ln.strip() for ln in k.build_log.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        regs = sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in k.build_log.splitlines() if "Used " in ln})
        print(f"build {name}: registers per thread {regs}; "
              f"spilling variants {len(spills)}", flush=True)

    max_err = {name: 0.0 for name in KERNELS}

    def record(name, got, want, what):
        err, allowed = rel_err(got, want)
        print(f"check {name} {what}: max_abs_err {err:.3e} "
              f"(allowed {allowed:.3e})", flush=True)
        if not err <= allowed:
            fail(f"{name} {what} disagrees with its plain version")
        max_err[name] = max(max_err[name], err)

    # -- 3. kernels against their plain versions ----------------------------
    gen.manual_seed(SEED)
    conv_cases = [  # (N, c_I, c_O, H, W, h_F, w_F, sh, sw, tiles)
        (2, 4, 8, 25, 25, 3, 3, 1, 1, (1, 4, 8, 5, 7)),   # ragged h/w tiles
        (2, 4, 8, 25, 25, 3, 3, 2, 2, (2, 4, 8, 1, 23)),  # stride 2
        (2, 4, 8, 25, 25, 3, 3, 2, 1, (1, 4, 8, 23, 4)),
        (3, 5, 7, 11, 13, 3, 5, 1, 2, None),              # ragged c_I, c_O
        (4, 3, 32, 20, 20, 7, 7, 2, 2, None),             # c_I = 3, 7x7/2
        (2, 6, 8, 16, 16, 1, 1, 2, 2, (1, 6, 8, 3, 5)),   # h_F = 1
    ]
    for dt in (torch.float32, torch.bfloat16):
        for od in (torch.float32, torch.bfloat16):
            for (N, cI, cO, H, W, hF, wF, sh, sw, tiles) in conv_cases:
                x = randn((N, cI, H, W), dt)
                w = randn((cO, cI, hF, wF), dt, (cI * hF * wF) ** -0.5)
                got = conv2d_kernel(x, w, (sh, sw), out_dtype=od,
                                    tiles=tiles)
                torch.cuda.synchronize()
                record("conv2d", got, conv2d_plain(x, w, (sh, sw), od),
                       f"{dt}->{od} {(N, cI, cO, H, W, hF, wF, sh, sw)} "
                       f"tiles {tiles}")
            for (m, n, k, tiles) in [(100, 300, 77, None),
                                     (130, 257, 129, None),
                                     (1, 128, 64, None),
                                     (130, 257, 129, (32, 48, 16))]:
                a = randn((m, k), dt)
                b = randn((k, n), dt, k ** -0.5)
                got = matmul_kernel(a, b, out_dtype=od, tiles=tiles)
                torch.cuda.synchronize()
                record("matmul", got, matmul_plain(a, b, od),
                       f"{dt}->{od} {(m, n, k)} tiles {tiles}")
    # one main-path shape each: conv2_x, and the GEMM of conv5_x's Im2Col
    ctx_plan = ExecutionContext(target=H100, backend="cuda")
    x = randn((BATCH, 64, 58, 58), torch.bfloat16)
    w = randn((64, 64, 3, 3), torch.bfloat16, 576 ** -0.5)
    got = conv2d_kernel(x, w, ctx=ctx_plan)
    torch.cuda.synchronize()
    for sl in (slice(0, BLOCK), slice(BATCH - BLOCK, BATCH)):
        record("conv2d", got[sl], conv2d_plain(x[sl], w),
               f"conv2_x images {sl.start}..{sl.stop - 1}")
    a = randn((BATCH * 49, 4608), torch.bfloat16)
    b = randn((4608, 512), torch.bfloat16, 4608 ** -0.5)
    got = matmul_kernel(a, b, ctx=ctx_plan)
    torch.cuda.synchronize()
    for sl in (slice(0, 4096), slice(BATCH * 49 - 4096, BATCH * 49)):
        record("matmul", got[sl], matmul_plain(a[sl], b),
               f"conv5_x GEMM rows {sl.start}..{sl.stop - 1}")
    del x, w, a, b, got
    torch.cuda.empty_cache()

    # -- 4. the main path ---------------------------------------------------
    layers = resnet50_layers(BATCH)
    backends = ("cuda", "im2col")
    ctxs = {be: ExecutionContext(target=H100, backend=be) for be in backends}

    def layer_inputs(i, s):
        gen.manual_seed(SEED + 1 + i)
        H = (s.h_O - 1) * s.sh + s.h_F
        W = (s.w_O - 1) * s.sw + s.w_F
        x = randn((s.N, s.c_I, H, W), torch.bfloat16)
        w = randn((s.c_O, s.c_I, s.h_F, s.w_F), torch.bfloat16,
                  (s.c_I * s.h_F * s.w_F) ** -0.5)
        return x, w

    rows = {}
    for k in KERNELS.values():
        k.launches = 0
    for i, (name, s) in enumerate(layers.items()):
        x, w = layer_inputs(i, s)
        stride = (s.sh, s.sw)
        kw = {"stride": stride, "out_dtype": torch.float32}
        dec = {be: ops.explain("conv2d", ctxs[be], dtype=x.dtype,
                               spec_args=(x, w), spec_kw=kw)
               for be in backends}
        gap = dec["im2col"].measured_words / dec["cuda"].measured_words
        library = median_ms(lambda: F.conv2d(x, w, stride=stride))
        for be in backends:
            before = {n: k.launches for n, k in KERNELS.items()}
            out = {}

            def run():
                out["y"] = ops.conv2d(x, w, stride, ctx=ctxs[be],
                                      out_dtype=torch.float32)

            ms = median_ms(run)
            launched = {n: k.launches - before[n]
                        for n, k in KERNELS.items()}
            kernel = "conv2d" if be == "cuda" else "matmul"
            if launched[kernel] <= 0:
                fail(f"{name}/{be}: the {kernel} kernel was not launched")
            y = out.pop("y")
            if y.shape != (s.N, s.c_O, s.h_O, s.w_O):
                fail(f"{name}/{be}: output shape {tuple(y.shape)}")
            errs = []
            for sl in (slice(0, BLOCK), slice(s.N - BLOCK, s.N)):
                err, allowed = rel_err(y[sl], conv2d_plain(x[sl], w, stride))
                if not err <= allowed:
                    fail(f"{name}/{be}: error {err} above {allowed}")
                errs.append(err)
            max_err[kernel] = max(max_err[kernel], *errs)
            d = dec[be]
            row = {"layer": name, "backend": be, "tiles": list(d.plan.tiles),
                   "measured_words": d.measured_words,
                   "lower_bound": d.lower_bound,
                   "bound_ratio": d.bound_ratio,
                   "im2col_over_tiled_words": gap, "ms": ms,
                   "library_ms": library, "launches": launched,
                   "max_abs_err": max(errs),
                   "checked_images": [[0, BLOCK - 1],
                                      [s.N - BLOCK, s.N - 1]]}
            rows[(name, be)] = row
            print(json.dumps(row), flush=True)
            del y
        del x, w
        torch.cuda.empty_cache()
    main_launches = {n: KERNELS[n].launches for n in ("conv2d", "matmul")}
    print(f"main path launches: {json.dumps(main_launches)}", flush=True)
    for n, c in main_launches.items():
        if c <= 0:
            fail(f"the {n} kernel was never launched on the main path")
    for name in layers:
        if not (rows[(name, "cuda")]["measured_words"]
                < rows[(name, "im2col")]["measured_words"]):
            fail(f"{name}: tiled words not below Im2Col words")

    # -- 5. kernel, plain version, library call, bound ----------------------
    totals = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "by": {"bytes": 0.0, "operations": 0.0}}
              for n in KERNELS}
    for i, (name, s) in enumerate(layers.items()):
        x, w = layer_inputs(i, s)
        stride = (s.sh, s.sw)
        flops = 2.0 * s.G
        conv_bytes = (x.numel() + w.numel()) * 2 + s.output_size * 4
        a = im2col_patches(x, s.h_F, s.w_F, stride)
        bmat = w.reshape(s.c_O, -1).t().contiguous()
        mm_bytes = (a.numel() + bmat.numel()) * 2 + a.shape[0] * s.c_O * 4
        timings = {
            "conv2d": (rows[(name, "cuda")]["ms"],
                       median_ms(lambda: conv2d_plain(x, w, stride), 0, 3),
                       rows[(name, "cuda")]["library_ms"], conv_bytes),
            "matmul": (median_ms(lambda: matmul_kernel(a, bmat, ctx=ctx_plan)),
                       median_ms(lambda: matmul_plain(a, bmat), 0, 3),
                       median_ms(lambda: torch.matmul(a, bmat)), mm_bytes),
        }
        for kname, (ms, plain, lib, nbytes) in timings.items():
            bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            f32_ms, _ = bound_ms(flops, 0, PEAK_F32_FLOPS)
            t = totals[kname]
            t["ms"] += ms
            t["plain_ms"] += plain
            t["library_ms"] += lib
            t["bound_ms"] += bms
            t["by"][by] += bms
            print(json.dumps({"kernel_layer": kname, "layer": name, "ms": ms,
                              "plain_ms": plain, "library_ms": lib,
                              "bound_ms": bms, "bound_by": by,
                              "f32_fma_bound_ms": f32_ms,
                              "gflop": flops / 1e9, "gbytes": nbytes / 1e9}),
                  flush=True)
        del x, w, a, bmat
        torch.cuda.empty_cache()

    # -- 6.-8. the serving path --------------------------------------------
    attn_kernels = serving_phases(gen, record)

    # -- 9. summary ---------------------------------------------------------
    meta = {"conv2d": ("src/repro_torch/kernels/csrc/conv2d.cu",
                       "src/repro/kernels/conv2d.py:82"),
            "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:41")}
    kernels = []
    for n, (source, replaces) in meta.items():
        t = totals[n]
        kernels.append({
            "name": n, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[n],
            "max_abs_err": max_err[n], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": max(t["by"], key=t["by"].get),
            "library_ms": t["library_ms"], "ok": True,
            "shapes": "sum over the five ResNet-50 layers at batch 1000"})
    for k in attn_kernels:
        k["max_abs_err"] = max_err[k["name"]]
    kernels += attn_kernels
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
