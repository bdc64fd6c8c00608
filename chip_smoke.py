"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is the paper's experiment: the five ResNet-50 convolutions at
their published widths and batch 1000, planned for the H100 preset and run
through ``repro_torch.ops.conv2d`` on the ``cuda`` backend (the hand-written
direct conv) and the ``im2col`` backend (patch expansion + the hand-written
GEMM), with bf16 inputs and f32 outputs. Phases, each fatal on failure:

  1. device: a CUDA device is required; name, power limit and versions;
  2. build: both kernels, one nvcc each, started together;
  3. each kernel against its plain PyTorch version on ragged, stride-2 and
     one main-path shape (TF32 off);
  4. the main path, launch counters set to 0 just before and read just
     after: one JSON line per layer and backend (tiles, measured words, bound
     ratio, Im2Col/tiled gap, median ms, F.conv2d ms, launches, error);
  5. each kernel's time beside its plain version, one library call and its
     bound at the main path's shapes;
  6. the ``kernels`` JSON line, the card's name and power limit, and the
     last line ``{"ok": true, "device": {...}}``.

Inputs are random, made on the device from fixed seeds. Tolerance: an
output agrees when max|kernel - plain| <= tol * max(1, max|plain|), with tol
1e-4 for f32 outputs (both sides accumulate in f32, in a different order;
bf16 x bf16 products are exact in f32) and 2^-7 for bf16 outputs (one bf16
rounding).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
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
    main_launches = {n: k.launches for n, k in KERNELS.items()}
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

    # -- 6. summary ---------------------------------------------------------
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
