"""The seven ``cp.async`` ring schedules of the port's kernels, as their
access-plan builders write them from the sources (``matmul_tc_kernel``,
``conv2d_tc_kernel``, ``flash_tc_kernel``, ``matmul_q_tc_kernel``,
``conv2d_q_tc_kernel``, ``conv1d_ring_kernel``, the paged decode kernels):
hazard-free at every main-path launch configuration and at the edge cases
the kernels' CPU emulations cover (one stage, fewer stages than slots,
ragged tails, dead slots, length-0 rows); without their waits they read
data that never landed (H1), without their ``__syncthreads`` a warp reads
or refills a slot unfenced (H6), and paged decode without its second
``cluster.sync`` reads partials before they are published (H7). Then the
window copies' run overhang (``conv2d.window_overhang``) against a
run-by-run replay of ``copy_window`` (csrc/tc_common.cuh).
"""

import pytest
import torch

from repro_torch.core.conv_model import resnet50_layers
from repro_torch.kernels.conv1d import conv1d_access_plan
from repro_torch.kernels.conv2d import (_launch_geometry, conv2d_access_plan,
                                        window_overhang)
from repro_torch.kernels.flash_attention import (flash_attention_access_plan,
                                                 paged_decode_access_plan)
from repro_torch.kernels.matmul import matmul_access_plan
from repro_torch.kernels.quant import (conv2d_q_access_plan,
                                       matmul_q_access_plan)
from repro_torch.plan import H100
from repro_torch.verify import hazards as hz
from repro_torch.verify.audit import audit_access_plan
from repro_torch.verify.mutants import drop_cluster_sync

LAYERS = resnet50_layers(1000)


def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _conv_args(s, dtype):
    H = (s.h_O - 1) * s.sh + s.h_F
    W = (s.w_O - 1) * s.sw + s.w_F
    return (meta((s.N, s.c_I, H, W), dtype),
            meta((s.c_O, s.c_I, s.h_F, s.w_F), dtype))


def _conv(shape, tiles=None, stride=(1, 1), dtype=torch.bfloat16):
    N, c_I, c_O, H, W, k = shape
    x, w = meta((N, c_I, H, W), dtype), meta((c_O, c_I, k, k), dtype)
    if dtype == torch.int8:
        return conv2d_q_access_plan(x, w, None, stride, tiles=tiles,
                                    target=H100)
    return conv2d_access_plan(x, w, stride, tiles=tiles, target=H100)


def _gemm(m, k, n, dtype=torch.bfloat16, tiles=None):
    a, b = meta((m, k), dtype), meta((k, n), dtype)
    if dtype == torch.int8:
        return matmul_q_access_plan(a, b, None, tiles=tiles, target=H100)
    return matmul_access_plan(a, b, tiles=tiles, target=H100)


def _conv1d(B, L, D=16384, K=4, tiles=None, offset=0):
    if offset:  # a real tensor whose base is ``offset`` elements off
        x = torch.zeros(B * L * D + offset, dtype=torch.bfloat16)[
            offset:].view(B, L, D)
    else:
        x = meta((B, L, D), torch.bfloat16)
    return conv1d_access_plan(x, meta((K, D), torch.bfloat16), tiles=tiles,
                              target=H100)


def _paged(lengths, w=13, dtype=0.5, capacity=None):
    return paged_decode_access_plan(len(lengths), 2, 8, w, 16, 128,
                                    1 + len(lengths) * w, dtype, dtype,
                                    dtype, lengths=lengths,
                                    capacity=capacity)


CASES = {
    # the GEMM: the five Im2Col GEMMs; one span (fewer than the slots); a k
    # of several spans with a ragged last one
    **{f"matmul/{n}": (lambda s=s: matmul_access_plan(
        meta((s.N * s.h_O * s.w_O, s.c_I * s.h_F * s.w_F), torch.bfloat16),
        meta((s.c_I * s.h_F * s.w_F, s.c_O), torch.bfloat16), target=H100))
       for n, s in LAYERS.items()},
    "matmul/one span": lambda: _gemm(100, 64, 96),
    "matmul/ragged spans": lambda: _gemm(257, 1001, 72),
    # the direct conv: the five layers; one stage in one slot; c_I = 40
    # over stages of 16, the last ragged
    **{f"conv2d/{n}": (lambda s=s: conv2d_access_plan(
        *_conv_args(s, torch.bfloat16), (s.sh, s.sw), target=H100))
       for n, s in LAYERS.items()},
    "conv2d/one stage": lambda: _conv((2, 3, 32, 9, 9, 3), (2, 3, 32, 7, 7)),
    "conv2d/ragged stages": lambda: _conv((3, 40, 48, 12, 12, 3),
                                          (2, 16, 32, 10, 10)),
    # flash: the prefill (R 4 x C 1) and decode (C 4, the merge area); keys
    # resident across q tiles; one q and one key tile
    "flash/prefill": lambda: flash_attention_access_plan(
        2, 8 * 176, 512, 128, 64, 64, 0.5, 0.5, 0.5),
    "flash/decode": lambda: flash_attention_access_plan(
        8, 8, 512, 128, 64, 64, 0.5, 0.5, 0.5),
    "flash/resident": lambda: flash_attention_access_plan(
        8, 8 * 20, 20, 128, 64, 64, 0.5, 0.5, 0.5),
    "flash/one tile": lambda: flash_attention_access_plan(
        4, 24, 40, 64, 64, 64, 0.5, 0.5, 0.5),
    # flash at hd 80: HuBERT-xLarge's prefill (B 8 x 16 heads, 512 frames)
    # and a bq-8 launch (C 4, the merge area)
    "flash/hd 80 prefill": lambda: flash_attention_access_plan(
        128, 512, 512, 80, 64, 64, 0.5, 0.5, 0.5),
    "flash/hd 80 bq 8": lambda: flash_attention_access_plan(
        8, 8, 300, 80, 64, 64, 0.5, 0.5, 0.5),
    # the int8 GEMM: the three GEMMs; one span; two spans (fewer than the
    # A ring's three); a narrow plan's CTA shares
    "matmul_q/512x384x256": lambda: _gemm(512, 384, 256, torch.int8),
    "matmul_q/2048^3": lambda: _gemm(2048, 2048, 2048, torch.int8),
    "matmul_q/conv5_x": lambda: _gemm(49000, 4608, 512, torch.int8),
    "matmul_q/one span": lambda: _gemm(300, 32, 200, torch.int8),
    "matmul_q/two spans": lambda: _gemm(300, 200, 200, torch.int8),
    "matmul_q/shares": lambda: _gemm(1, 4096, 4096, torch.int8),
    # the int8 conv: the five layers; one stage; c_I = 37 over stages of 32
    **{f"conv2d_q/{n}": (lambda s=s: conv2d_q_access_plan(
        *_conv_args(s, torch.int8), None, (s.sh, s.sw), target=H100))
       for n, s in LAYERS.items()},
    "conv2d_q/one stage": lambda: _conv((2, 3, 16, 9, 9, 3), None,
                                        dtype=torch.int8),
    "conv2d_q/ragged stages": lambda: _conv((2, 37, 64, 10, 10, 3), None,
                                            dtype=torch.int8),
    # conv1d: the serve's longest prefill; one chunk; fewer chunks than
    # slots; more chunks than slots; three batch rows (the tail restarts);
    # the 2-byte path (plain stores into the ring)
    "conv1d/L300": lambda: _conv1d(1, 300),
    "conv1d/L1": lambda: _conv1d(1, 1),
    "conv1d/L100": lambda: _conv1d(1, 100),
    "conv1d/L1000": lambda: _conv1d(1, 1000, D=512),
    "conv1d/B3": lambda: _conv1d(3, 70, D=256, tiles=(3, 128)),
    "conv1d/2-byte": lambda: _conv1d(2, 40, D=64, offset=1),
    # paged decode: phase 8's lengths (dead slots, idle CTAs); every row
    # full at w 32; length-0 rows; one slot; the f32 kernel
    "paged/phase 8": lambda: _paged((205, 151, 120, 41)),
    "paged/full w 32": lambda: _paged((512,) * 4, w=32),
    "paged/length 0": lambda: _paged((0, 7, 100, 0), w=25),
    "paged/w 1": lambda: _paged((16,), w=1),
    "paged/f32": lambda: _paged((205, 151, 120, 41), dtype=1.0),
    # the serving engine's launch: its split from the table capacity
    # (max_len 512 / 16 = 32: 4 slots, 2 key tiles a CTA), 4 of 8 ranks
    "paged/engine capacity": lambda: _paged((205, 151, 120, 41),
                                            capacity=32),
}
PLAIN = {"conv1d/2-byte"}  # its ring is written by stores, not copies


@pytest.fixture(scope="module")
def plans():
    return {}


def _plan(name, plans):
    if name not in plans:
        plans[name] = CASES[name]()
    return plans[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_is_hazard_free(name, plans):
    ap = _plan(name, plans)
    assert ap.schedules(), f"{name}: no ring schedule"
    rep = audit_access_plan(ap)
    assert rep.hazards == [] and rep.problems == []


@pytest.mark.parametrize("name", sorted(set(CASES) - PLAIN))
def test_dropped_waits_read_unlanded_data(name, plans):
    found = [h.code for s in _plan(name, plans).schedules()
             for h in hz.check_schedule(hz.without(s, hz.WAIT_GROUP))]
    assert "H1" in found


@pytest.mark.parametrize("name", sorted(CASES))
def test_dropped_barriers_leave_warps_unfenced(name, plans):
    found = [h.code for s in _plan(name, plans).schedules()
             for h in hz.check_schedule(hz.without(s, hz.BARRIER))]
    assert "H6" in found


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if n.startswith("paged")))
@pytest.mark.parametrize("which, code", [(1, "H7"), (2, "H7"), (3, "H7")])
def test_paged_cluster_syncs(name, which, code, plans):
    """Without its first cluster.sync the other ranks read the query group
    before rank 0 has it; without the second rank 0 reads partials before
    they are published (its own too: the other warps wrote it); without the
    third a rank may exit before rank 0 reads it. A cluster of one CTA has
    no peer to fence with the first and the third."""
    ap = _plan(name, plans)
    found = [h.code for s in ap.schedules()
             for h in hz.check_schedule(drop_cluster_sync(s, which))]
    if ap.launch.cluster[0] == 1 and which != 2:
        assert code not in found
    else:
        assert code in found


def test_ring_constants_come_from_the_sources():
    """The schedules' depths and waits are the sources': the GEMM's
    wait_group(slots - 2), the convs' wait_group(0), conv1d's
    wait_group(STAGES - 3), paged decode's wait_group(RING - 2) and (RING -
    1), matmul_q's wait_group(1) then (0)."""
    from pathlib import Path

    import repro_torch.kernels as K

    csrc = Path(K.__file__).parent / "csrc"
    src = {f: (csrc / f).read_text() for f in ("matmul.cu", "conv2d.cu",
                                               "quant.cu", "conv1d.cu",
                                               "paged_decode.cu",
                                               "flash_attention.cu")}
    assert "if (p.slots == 3) cp_async_wait<1>(); else cp_async_wait<0>();" \
        in src["matmul.cu"]
    assert "cp_async_wait<STAGES - 3>();" in src["conv1d.cu"]
    assert "cp_async_wait<RING - 2>();" in src["paged_decode.cu"]
    assert "cp_async_wait<RING - 1>();" in src["paged_decode.cu"]
    assert "cp_async_wait<A_SLOTS - 2>();" in src["quant.cu"]
    assert "cp_async_wait<A_SLOTS - 3>();" in src["quant.cu"]
    assert src["paged_decode.cu"].count("cluster.sync();") == 3
    for f in ("conv2d.cu", "quant.cu", "flash_attention.cu"):
        assert "cp_async_wait<0>();" in src[f]

    def waits(ap):
        return sorted({e.n for s in ap.schedules() for e in s.events
                       if e.kind == hz.WAIT_GROUP})

    assert waits(_gemm(1000, 576, 64)) == [1]  # 3 slots, no drain
    assert waits(_conv((2, 40, 48, 12, 12, 3), (2, 16, 32, 10, 10))) == [0]
    assert waits(_conv1d(1, 300)) == [0, 5]
    assert waits(_paged((205, 151, 120, 41))) == [0, 2, 3]
    assert waits(_gemm(512, 384, 256, torch.int8)) == [0, 1]


# -- the window runs' overhang against a replay of copy_window ----------------

def _replay_overhang(N, c_I, H, W, tiles, stride, h_F, w_F, cs, run):
    """Elements copy_window reads beyond each live window row (or, for a
    whole-plane window, beyond each image's stage planes), run by run, over
    every CTA and stage."""
    bN, _, _, bh, bw = tiles
    sh, sw = stride
    (_, _, _, _, _, _, _, h_in, w_in, grid) = _launch_geometry(
        N, c_I, tiles[2] * 2, H, W, h_F, w_F, sh, sw, tiles)
    nN, nCO, nH, nW = grid[:4]
    whole = h_in == H and w_in == W
    HW, img = H * W, c_I * H * W
    n_st = -(-c_I // cs)
    total = 0
    for n in range(nN):
        for hb in range(nH):
            for wb in range(nW):
                n0, row0, col0 = n * bN, hb * bh * sh, wb * bw * sw
                for s in range(n_st):
                    ci0 = s * cs
                    length = cs * HW if whole else w_in
                    vend = ((c_I - ci0) * HW if whole
                            else min(w_in, W - col0))
                    cv = 1 if whole else min(c_I - ci0, cs)
                    rv = 1 if whole else H - row0
                    chans = 1 if whole else cs
                    rows = 1 if whole else h_in
                    gpr = (length + 2 * run - 2) // run
                    for nl in range(bN):
                        for c in range(chans):
                            for r in range(rows):
                                live = n0 + nl < N and r < rv and c < cv
                                if not live:
                                    continue
                                origin = ((n0 + nl) * img + (ci0 + c) * HW
                                          + (0 if whole else
                                             (row0 + r) * W + col0))
                                a = origin % run
                                read = 0
                                for j in range(gpr):
                                    start = j * run - a
                                    if start >= length:
                                        continue
                                    read += max(0, min(run, vend - start))
                                total += read - max(0, min(vend, length))
    return total * nCO


@pytest.mark.parametrize("case", [
    # N, c_I, H, W, h_F, w_F, stride, tiles, cs, run
    (3, 5, 13, 11, 3, 3, (1, 1), (2, 4, 4, 5, 4), 2, 8),
    (3, 5, 13, 11, 3, 3, (1, 1), (2, 4, 4, 5, 4), 2, 16),
    (2, 3, 17, 17, 3, 3, (2, 2), (1, 3, 8, 3, 5), 3, 16),
    (2, 3, 29, 29, 7, 7, (2, 2), (1, 3, 8, 4, 4), 3, 8),
    (5, 6, 7, 7, 3, 3, (1, 1), (2, 4, 8, 5, 5), 4, 8),
    (5, 6, 7, 7, 3, 3, (1, 1), (2, 4, 8, 5, 5), 4, 16),
    (3, 40, 12, 12, 3, 3, (1, 1), (2, 16, 32, 10, 10), 16, 8),
    (2, 7, 10, 23, 1, 3, (1, 2), (2, 7, 8, 3, 6), 7, 16),
], ids=lambda c: f"{c[0]}x{c[1]}x{c[2]}x{c[3]} run {c[-1]}")
def test_window_overhang_matches_a_replay(case):
    N, c_I, H, W, h_F, w_F, stride, tiles, cs, run = case
    (_, _, _, _, _, _, _, h_in, w_in, grid) = _launch_geometry(
        N, c_I, tiles[2] * 2, H, W, h_F, w_F, *stride, tiles)
    got = window_overhang(N, c_I, H, W, grid, tiles, stride, cs,
                          -(-c_I // cs), h_in, w_in, run)
    want = _replay_overhang(N, c_I, H, W, tiles, stride, h_F, w_F, cs, run)
    assert got == want
