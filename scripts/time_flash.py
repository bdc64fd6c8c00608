"""Time the port's flash-attention wrapper at the Qwen serve's shapes and
at the sequence-sharded decode's.

    python3 scripts/time_flash.py [--root DIR]

The two calls of chip_smoke.py's phase 8 (Qwen2.5-3B, hd 128, 16 query
heads over 2 KV heads, bf16): a prefill of the first request's bucket (Lq
176 against a 512-key cache, a tensor-scalar offset and a pad-tail key
mask) and a contiguous decode step (4 rows at depths 230/120/60/17 of 512
keys, per-row offsets); and phase 31's decode launches over Qwen's
``decode_32k`` cache (16 rows = B 8 x KV 2, 8 folded queries, every key
valid): with row statistics at a rank's 8,192-key shard and at one card's
32,768 keys, and one card's without statistics (bf16 out). Each is timed
as a call (CUDA events around one call, the wrapper's host work
included), a launch (50 back-to-back calls) and on the device (a replayed
CUDA graph of 20 calls). Prints one JSON line a shape, with the launch's
key split and CTAs (``launch_config``; 1 and the unsplit grid for a
package without the split). Last, phase 31's one-card decode step
(Qwen2.5-3B at full depth, B 8 over a 32,768-position cache of random
contents, through ``dryrun.build_decode_step`` on the ``cuda`` backend):
each of 1 + 8 steps on the host clock, ending in a synchronise, and the
flash launches a step. The measuring code is always this
checkout's; ``--root`` times another checkout's package (its ``src``), so
that two versions of the wrapper can be compared on one card in one run:
run them in turn, A B B A. Needs a CUDA device.
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
    root = Path(ap.parse_args().root).resolve()
    sys.path.insert(0, str(HERE))

    import torch

    # the timed package first: chip_smoke puts its own src ahead on import
    sys.path.insert(0, str(root / "src"))
    import repro_torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, flash_attention
    from repro_torch.kernels.flash_attention import launch_config

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a GPU")
    if not Path(repro_torch.__file__).resolve().is_relative_to(root):
        sys.exit(f"repro_torch came from {repro_torch.__file__}, not {root}")
    KERNELS["flash_attention"].fn()  # build before any timing
    cfg = get_config(cs.ARCH)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g, Lk = H // KV, 512
    _, lens = cs.serving_prompt_lens()
    Lq = -(-int(lens[0]) // 16) * 16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 20)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v = randn((KV, g * Lq, hd)), randn((KV, Lk, hd)), randn((KV, Lk, hd))
    km = torch.zeros((1, Lk), dtype=torch.bool, device="cuda")
    km[0, :int(lens[0])] = True
    km[0, Lq:] = True
    off0 = torch.zeros((), dtype=torch.int32, device="cuda")
    dq, dk, dv = (randn((4 * KV, g, hd)), randn((4 * KV, Lk, hd)),
                  randn((4 * KV, Lk, hd)))
    depth = torch.tensor([230, 120, 60, 17], dtype=torch.int32,
                         device="cuda")
    rows_off = depth[:, None].expand(4, KV).reshape(-1)
    rows = cs.SEQ_BATCH * KV
    seq = {n: (randn((rows, g, hd)), randn((rows, n, hd)),
               randn((rows, n, hd)))
           for n in (cs.SEQ_LEN // cs.MESH_RANKS, cs.SEQ_LEN)}

    def seq_call(n, stats):
        sq, sk, sv = seq[n]
        return lambda: flash_attention(sq, sk, sv, True, n - 1, q_seq_len=1,
                                       stats=stats)

    shapes = {  # name: (call, folded rows, folded queries, keys)
        "prefill": (lambda: flash_attention(q, k, v, q_offset=off0,
                                            q_seq_len=Lq, key_mask=km),
                    KV, g * Lq, Lk),
        "contiguous decode": (lambda: flash_attention(
            dq, dk, dv, q_offset=rows_off, q_seq_len=1), 4 * KV, g, Lk),
        "stats rank shard": (seq_call(cs.SEQ_LEN // cs.MESH_RANKS, True),
                             rows, g, cs.SEQ_LEN // cs.MESH_RANKS),
        "stats one card": (seq_call(cs.SEQ_LEN, True), rows, g,
                           cs.SEQ_LEN),
        "one card, bf16 out": (seq_call(cs.SEQ_LEN, False), rows, g,
                               cs.SEQ_LEN)}
    for name, (fn, n_rows, fq, keys) in shapes.items():
        lc = launch_config(fq, keys, hd, 64, torch.bfloat16, rows=n_rows)
        line = {"root": str(root), "kernel_shape": "flash_attention",
                "phase": name, "rows": n_rows, "Lq": fq, "Lk": keys,
                "split": lc.get("split", 1),
                "ctas": lc.get("ctas", lc["grid"][0] * lc["grid"][1]),
                "ms": cs.median_ms(fn, 2, 20),
                "ms_per_launch": cs.per_launch_ms(fn),
                "device_ms": cs.graph_ms_per_call(fn)}
        line["kv_gbytes_per_s_device"] = (2 * n_rows * keys * hd * 2
                                          / line["device_ms"] / 1e6)
        print(json.dumps({**line, "device": cs.smi()}), flush=True)
    del seq
    decode_step(root, gen)


def decode_step(root, gen) -> None:
    """Phase 31's one-card decode step (module docstring), timed."""
    import math
    import statistics
    import time

    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100

    cfg = get_config(cs.SEQ_ARCH)
    params = T.init_params(cfg, seed=cs.SEED, device="cuda")
    cache = T.init_cache(cfg, cs.SEQ_BATCH, cs.SEQ_LEN, device="cuda")
    for leaves in cache.values():
        for t in leaves.values():
            t.normal_(generator=gen)
    step = dr.build_decode_step(cfg, math.gcd(cs.SEQ_BATCH, cs.MESH_RANKS),
                                ctx=ExecutionContext(target=H100,
                                                     backend="cuda"))
    tok = torch.randint(0, cfg.vocab_size, (cs.SEQ_BATCH, 1), generator=gen,
                        device="cuda", dtype=torch.int32)
    step_s = []
    n0 = KERNELS["flash_attention"].launches
    for i in range(1 + cs.SEQ_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = step(params, cache, tok, cs.SEQ_PROMPT + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    print(json.dumps({
        "root": str(root), "kernel_shape": "flash_attention",
        "phase": "one-card decode step", "layers": cfg.n_layers,
        "batch": cs.SEQ_BATCH, "cache": cs.SEQ_LEN,
        "flash_launches_per_step": (KERNELS["flash_attention"].launches
                                    - n0) / (1 + cs.SEQ_STEPS),
        "first_step_s": step_s[0], "step_s": step_s[1:],
        "median_step_s": statistics.median(step_s[1:]),
        "device": cs.smi()}), flush=True)


if __name__ == "__main__":
    main()
