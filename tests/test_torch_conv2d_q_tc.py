"""The int8 tensor-core conv (``conv2d_q_tc_kernel`` in ``csrc/quant.cu``) on
the CPU: its walk, modelled by ``conv2d_q_tc_emulate`` (ring stages of the
kernel's channel count, window slots at ``window_layout``'s int8 pitches
from an unaligned origin with a sentinel in the slack, the zero plane, the
k32 gather through ``gather_table`` and ``row_offsets``, int32 products per
m16n8 tile, the scale at the store), against the reference's
``_conv_q_kernel`` in interpret mode and the port's plain version on the
same numpy inputs; the launch configuration of every H100 int8 plan of the
main path; the window copies' runs; and a bank model of the A gather and
the B ``ldmatrix`` reads.

Tolerance: none. Both sides sum int8 products exactly (the reference adds
int32 partials into f32, exact while every partial sum is below 2^24, as
at these sizes: at most 648 x 127^2 ~ 1.0e7), then convert to f32, scale in
f32 and cast the same way."""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import repro_torch.plan as tp
from repro import ops as jops
from repro_torch.core.conv_model import Precision, resnet50_layers
from repro_torch.kernels import conv2d_q_plain
from repro_torch.kernels._build import MAX_SMEM_BYTES
from repro_torch.kernels.conv2d import gather_table, row_offsets
from repro_torch.kernels.matmul import warp_tiles
from repro_torch.kernels.quant import (CONV_K, CONV_RUN, LINEAR,
                                       conv2d_q_tc_emulate,
                                       conv_launch_config, gather_conflicts)
from test_torch_quant import (CONV_CASES, J_CTX, OUT, TC_CONV_CASES,
                              _conv_operands)

jquant = importlib.import_module("repro.kernels.quant")
CASES = {**CONV_CASES, **TC_CONV_CASES}
# the H100 int8 plans of the five layers (PERF.md §4)
H100_INT8_TILES = {
    "conv1": (2, 3, 64, 16, 16), "conv2_x": (1, 16, 64, 8, 56),
    "conv3_x": (5, 16, 64, 14, 7), "conv4_x": (5, 16, 64, 14, 7),
    "conv5_x": (10, 16, 64, 7, 7)}


def _np(t):
    return t.float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _case_config(case):
    """A case's tiles (the H100 int8 plan where it names none) and its
    launch configuration."""
    N, cI, cO, H, W, hF, wF, sh, sw, tiles = CASES[case]
    h_O, w_O = (H - hF) // sh + 1, (W - wF) // sw + 1
    if tiles is None:
        tiles = tp.Planner(tp.H100).plan(tp.ConvSpec(
            N=N, c_I=cI, c_O=cO, w_O=w_O, h_O=h_O, w_F=wF, h_F=hF, sw=sw,
            sh=sh, prec=Precision(.25, .25, .5))).tiles
    tiles = tuple(tiles)
    if len(tiles) == 3:
        tiles = (*tiles, h_O, w_O)
    tiles = (*tiles[:3], min(tiles[3], h_O), min(tiles[4], w_O))
    h_in, w_in = (tiles[3] - 1) * sh + hF, (tiles[4] - 1) * sw + wF
    return tiles, conv_launch_config(tiles, hF, wF, h_in, w_in, cI, (H, W))


def _layer(name):
    """A ResNet-50 layer's shape, its H100 int8 plan and launch config."""
    s = resnet50_layers(1000)[name]
    H, W = (s.h_O - 1) * s.sh + s.h_F, (s.w_O - 1) * s.sw + s.w_F
    tiles = tp.Planner(tp.H100).plan(tp.ConvSpec(
        N=s.N, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O, h_O=s.h_O, w_F=s.w_F,
        h_F=s.h_F, sw=s.sw, sh=s.sh, prec=Precision(.25, .25, .5))).tiles
    bN, _, _, bh, bw = tiles
    h_in, w_in = (bh - 1) * s.sh + s.h_F, (bw - 1) * s.sw + s.w_F
    return s, tuple(tiles), conv_launch_config(tiles, s.h_F, s.w_F, h_in,
                                               w_in, s.c_I, (H, W))


# -- the model of the kernel against the reference and the plain version ---

@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("out", sorted(OUT))
def test_tc_emulate_matches_reference(case, out):
    N, cI, cO, H, W, hF, wF, sh, sw, tiles = CASES[case]
    jo, to = OUT[out]
    (jx, jw, js), (tx, tw, ts) = _conv_operands(3, (N, cI, H, W),
                                               (cO, cI, hF, wF))
    if tiles is None:
        want = jops.conv2d_q(jx, jw, js, stride=(sh, sw), ctx=J_CTX,
                             out_dtype=jo)
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            want = jquant.conv2d_q(jx, jw, js, stride=(sh, sw), tiles=tiles,
                                   out_dtype=jo)
    got = conv2d_q_tc_emulate(tx, tw, ts, (sh, sw), tiles, to)
    assert got.dtype == to and got.shape == want.shape
    np.testing.assert_array_equal(_np(got), _jnp(want))
    np.testing.assert_array_equal(
        _np(got), _np(conv2d_q_plain(tx, tw, ts, (sh, sw), to)))


def test_edge_cases_walk_what_they_name():
    """The edge cases reach the paths they are there for: several stages,
    a ragged last stage of a channel count that is not a multiple of 4, a
    stage of all c_I (the filter's one run) with the zero plane, whole-plane
    windows, stride 2 over two stages and the LINEAR layout."""
    cfg = {case: _case_config(case)[1] for case in TC_CONV_CASES}
    assert cfg["conv1_tile"]["n_st"] == 1 and cfg["conv1_tile"]["zc"]
    assert cfg["conv1_tile"]["ks"] == 147 and cfg["conv1_tile"]["n32"] == 5
    assert cfg["conv2_x_tile"]["cs"] == 32 and 37 % 32 % 4  # 5 in the last
    assert cfg["conv4_x_tile"]["n_st"] == 3  # slot 0 refilled
    assert (cfg["conv5_x_tile"]["d_row"], cfg["conv5_x_tile"]["d_ch"]) == (
        9, 81)  # a whole-plane window: the planes contiguous
    assert cfg["stride2_stages"]["n_st"] == 2
    assert cfg["linear_tile"]["variant"] == LINEAR
    for case in TC_CONV_CASES:
        if case != "linear_tile":
            assert (cfg[case]["mi"], cfg[case]["ni"]) == (2, 8), case


# -- the launch configuration ------------------------------------------------

@pytest.mark.parametrize("name", sorted(H100_INT8_TILES))
def test_launch_config_of_main_path_plans(name):
    """Every H100 int8 plan of the main path: 16 (conv2_x: 14) warps of
    (2, 8) m16n8 tiles over the whole accumulator tile, 64 int32
    accumulators a thread, at most 512 threads and a block's shared memory;
    a stage of two plan c_I blocks (3 x 3: 32 channels, 288 k, 9 k32 slices,
    no zero plane; conv1: all 3 channels, 147 k padded to 160 through the
    zero plane), two ring slots wherever c_I takes more than one stage,
    filter rows an odd multiple of 16 bytes, and the epilogue's 4-pixel
    stores where b_wO is a multiple of 4."""
    s, tiles, cfg = _layer(name)
    assert tiles == H100_INT8_TILES[name]
    bN, b_cI, b_cO, bh, bw = tiles
    M = bN * bh * bw
    assert cfg["kernel"] == "tensor core" and cfg["variant"] == 0
    assert (cfg["mi"], cfg["ni"], cfg["wn"]) == (2, 8, 1)
    assert cfg["wm"] == -(-M // 32) and cfg["threads"] == 32 * cfg["wm"]
    assert cfg["threads"] <= 512 and cfg["acc_per_thread"] == 64
    assert cfg["rows"] >= M and cfg["cols"] == b_cO == 64
    assert cfg["smem"] <= MAX_SMEM_BYTES
    assert cfg["ks"] == cfg["cs"] * s.h_F * s.w_F
    assert cfg["n32"] * CONV_K >= cfg["ks"] > (cfg["n32"] - 1) * CONV_K
    assert cfg["n_st"] == -(-s.c_I // cfg["cs"])
    assert cfg["slots"] == (2 if cfg["n_st"] > 1 else 1)
    assert cfg["ldb"] % 32 == 16 and cfg["ldb"] >= cfg["n32"] * CONV_K
    assert cfg["vst"] == (4 if bw % 4 == 0 else 1)
    assert cfg["lds"] % 32 == 4 and cfg["lds"] >= cfg["rows"]
    # the epilogue's staged tile and the ring each fit after the scale
    assert cfg["off_koff"] + b_cO * cfg["lds"] * 4 <= cfg["smem"]
    assert cfg["off_ring"] + cfg["slots"] * cfg["slot_bytes"] <= cfg["smem"]
    assert cfg["x_elems"] < 1 << 18  # the row table's 18-bit offsets
    if name == "conv1":
        assert (cfg["cs"], cfg["ks"], cfg["n32"], cfg["zc"]) == (3, 147, 5, 1)
    else:
        assert (cfg["cs"], cfg["ks"], cfg["n32"], cfg["zc"]) == (32, 288, 9,
                                                                0)
    owned = sorted(t for w in range(cfg["wm"] * cfg["wn"])
                   for t in warp_tiles(cfg, w))
    assert owned == [(i, j) for i in range(cfg["rows"] // 16)
                     for j in range(b_cO // 8)]


@pytest.mark.parametrize("case", sorted(TC_CONV_CASES))
def test_warp_layout_covers_the_tile_once(case):
    """The m16n8 tiles of every warp cover the (bN bh bw) x b_cO tile, none
    twice, within 16 warps of 64 accumulators."""
    tiles, cfg = _case_config(case)
    bN, _, b_cO, bh, bw = tiles
    owned = [t for w in range(cfg["wm"] * cfg["wn"])
             for t in warp_tiles(cfg, w)]
    assert len(owned) == len(set(owned))
    assert {(i, j) for i in range(-(-bN * bh * bw // 16))
            for j in range(-(-b_cO // 8))} <= set(owned)
    assert cfg["threads"] <= 512 and cfg["acc_per_thread"] <= 64


def test_a_tile_nothing_covers_raises():
    """More accumulators than 16 warps hold (a plan for another target):
    ValueError, no other kernel."""
    with pytest.raises(ValueError, match="accumulator tile"):
        conv_launch_config((64, 8, 512, 7, 7), 3, 3, 9, 9)
    with pytest.raises(ValueError, match="accumulator tile"):
        conv_launch_config((1, 16, 1, 200, 200), 3, 3, 202, 202)


def test_stage_halves_until_the_ring_fits():
    """A window too large for two stages of two plan c_I blocks takes fewer
    channels a stage, as many as fit, not a refusal."""
    cfg = conv_launch_config((1, 32, 16, 40, 40), 3, 3, 42, 42, 256,
                             (300, 300))
    assert cfg["cs"] == 32 and cfg["slots"] == 2
    assert cfg["smem"] <= MAX_SMEM_BYTES


# -- the window copies and the gather tables ---------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_window_covers_stay_in_their_row(case):
    """The window copies move each row as the 16-byte runs of the input
    that cover it, into a slot whose origin is 16 + (the stage's input
    offset mod 16): for every offset, each run lands aligned inside the
    slot and touches no byte of another row and none of the zero plane."""
    N, cI, cO, H, W, hF, wF, sh, sw, _ = CASES[case]
    tiles, cfg = _case_config(case)
    bN, _, _, bh, bw = tiles
    h_in, w_in = (bh - 1) * sh + hF, (bw - 1) * sw + wF
    g = CONV_RUN
    cs, d_row, d_ch, d_img = cfg["cs"], cfg["d_row"], cfg["d_ch"], cfg["d_img"]
    run = h_in == H and w_in == W
    rows = [(n, 0, 0) for n in range(bN)] if run else [
        (n, c, r) for n in range(bN) for c in range(cs) for r in range(h_in)]
    length = cs * H * W if run else w_in
    for g0m in range(g):
        origin = g + g0m
        owner = np.full(cfg["x_elems"], -1)
        if cfg["zc"]:
            for n in range(bN):
                z = n * d_img + cfg["zero"] + g
                owner[z:z + d_ch + g] = -2  # the zero plane
        for q, (n, c, r) in enumerate(rows):
            d = origin + n * d_img + c * d_ch + r * d_row
            assert (owner[d:d + length] == -1).all()
            owner[d:d + length] = q
        for q, (n, c, r) in enumerate(rows):
            rel = n * cI * H * W + c * H * W + r * W
            d = origin + n * d_img + c * d_ch + r * d_row
            a = (g0m + rel) % g
            assert (d - a) % g == 0  # an aligned run of x lands aligned
            for start in range(-a, length, g):
                run_ = owner[d + start:d + start + g]
                assert d + start >= 0 and d + start + g <= cfg["x_elems"]
                assert np.isin(run_, (-1, q)).all()


def test_gather_tables_index_the_int8_window():
    """koff pads K to 32 for the s8 MMA (16 stays the bf16 default), the
    padded k at the zero plane; conv1's int8 pitches are congruent to its
    229-byte rows modulo 16 bytes, with a run of slack a row."""
    assert gather_table(1, 1, 1, 5, 20, 44) == [0] + [44] * 15
    assert gather_table(1, 1, 1, 5, 20, 44, CONV_K) == [0] + [44] * 31
    _, _, cfg = _layer("conv1")
    d_row, d_ch, d_img = cfg["d_row"], cfg["d_ch"], cfg["d_img"]
    assert d_row >= 37 + 15 and (d_row - 229) % 16 == 0
    assert d_ch >= 36 * d_row + 37 + 15 and (d_ch - 229 ** 2) % 16 == 0
    assert d_img >= 4 * d_ch + 112 and (d_img - 3 * 229 ** 2) % 16 == 0
    koff = gather_table(3, 7, 7, d_row, d_ch, cfg["zero"], CONV_K)
    assert len(koff) == 160 and koff[:3] == [0, 1, 2] and koff[7] == d_row
    assert koff[146] == 2 * d_ch + 6 * d_row + 6
    assert koff[147:] == [3 * d_ch + 64] * 13 == [cfg["zero"]] * 13
    moff = row_offsets(cfg["rows"], H100_INT8_TILES["conv1"], (2, 2), d_img,
                       d_row)
    assert moff[:2] == [0, 2] and moff[16] == 2 * d_row
    assert moff[256] == d_img and len(moff) == 512


# -- bank model ------------------------------------------------------------

def _gather_degrees(cfg, tiles, stride, h_F, w_F):
    """For each byte load of the A gather (a warp's 32 lanes at one k32
    slice, A register and byte), the most distinct 32-bit words any bank
    serves (1: conflict-free), over every warp, slice and window origin mod
    4, as conv2d_q_tc_kernel addresses them: lane (g, t) of m16 tile i reads
    row (wm MI + i) 16 + g (+ 8 in registers 1 and 3) at k = 32 kk + 4 t
    (+ 16 in registers 2 and 3) + byte."""
    koff = np.array(gather_table(cfg["cs"], h_F, w_F, cfg["d_row"],
                                 cfg["d_ch"], cfg["zero"], CONV_K))
    moff = np.array(row_offsets(cfg["rows"], tiles, stride, cfg["d_img"],
                                cfg["d_row"]))
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    degrees = []
    for origin in range(CONV_RUN, CONV_RUN + 4):
        for wm in range(cfg["wm"]):
            for kk in range(cfg["n32"]):
                for i in range(cfg["mi"]):
                    for e in range(4):
                        row = (wm * cfg["mi"] + i) * 16 + g + 8 * (e & 1)
                        for b in range(4):
                            k = 32 * kk + 4 * t + 16 * (e >> 1) + b
                            words = (origin + moff[row] + koff[k]) // 4
                            degrees.append(max(
                                len(set(words[words % 32 == bank]))
                                for bank in set(words % 32)))
    return np.array(degrees)


@pytest.mark.parametrize("name", sorted(H100_INT8_TILES))
def test_gather_and_fragment_reads_bank_model(name):
    """The B fragments' ldmatrix phases (8 filter rows of 16 bytes) hit 8
    distinct bank groups: the rows' pitch is 16 mod 32 bytes. The A gather's
    byte loads, modelled lane by lane, agree with ``gather_conflicts``, the
    model the launch configuration minimizes: conflict-free on conv1 and
    conv2_x (a warp's 8 rows are consecutive pixels of one output row);
    where 8 pixels span two output rows of 7 (conv3_x-conv5_x), at most
    2-way, 1.35 on average, after 16 bytes more between channel planes on
    conv3_x and conv4_x (2-way on almost every load without them): PERF.md
    §5's bank column."""
    s, tiles, cfg = _layer(name)
    pitch = cfg["ldb"]
    assert pitch % 32 == 16
    assert len({(r * pitch // 4) % 32 // 4 for r in range(8)}) == 8
    deg = _gather_degrees(cfg, tiles, (s.sh, s.sw), s.h_F, s.w_F)
    assert gather_conflicts(cfg, tiles, (s.sh, s.sw), s.h_F,
                            s.w_F) == pytest.approx(deg.mean())
    assert cfg["ch_pad"] == (16 if name in ("conv3_x", "conv4_x") else 0)
    if name in ("conv1", "conv2_x"):
        assert deg.max() == 1
    else:
        assert deg.max() <= 2 and deg.mean() <= 1.35
    if cfg["ch_pad"]:  # 16 bytes fewer between channel planes: 2-way
        bare = dict(cfg, d_ch=cfg["d_ch"] - cfg["ch_pad"])
        assert _gather_degrees(bare, tiles, (s.sh, s.sw), s.h_F,
                               s.w_F).mean() > 1.9
