"""The causal conv1d kernel (``conv1d_ring_kernel`` in ``csrc/conv1d.cu``) on
the CPU: its walk, modelled by ``conv1d_ring_emulate`` (per CTA: the filter
block, time chunks issued into the slots of a ``cp.async`` ring, the K - 1
rows before a chunk read from the previous chunk's slot, zero rows before
t = 0, ragged B, D and L masked, every copy checked against its width's
alignment), against the reference's ``_conv1d_kernel`` in interpret mode
and the port's plain version on the same numpy inputs; the words its copies
issue against ``conv1d_hbm_words``; and the launch configuration of every
shape of the hybrid serve and of chip_smoke.py's phase 13.

Tolerances: the emulation adds the taps in the kernel's order with an f32
rounding after each product and each sum, as the plain version does, so
the two are bit-equal in both dtypes. Against the Pallas kernel: bf16
outputs are bit-equal; in f32 XLA's CPU code contracts the reference's
``acc + shifted * w[k]`` into a fused multiply-add (one rounding where the
kernel has two), so f32 outputs agree within 1e-6, as
tests/test_torch_ssm.py holds the plain version.
"""

import importlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import conv1d_causal_plain, conv1d_hbm_words
from repro_torch.kernels._build import CSRC, MAX_SMEM_BYTES, MAX_THREADS
from repro_torch.kernels.conv1d import (CHUNK, STAGES, _conv1d_geometry,
                                        conv1d_ring_emulate, launch_config,
                                        operand_width)

jconv1d = importlib.import_module("repro.kernels.conv1d")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = [  # (B, L, D, K, tiles, view): view = (row pitch, first channel)
    (1, 1, 64, 4, None, None),            # L = 1
    (2, 2, 64, 4, None, None),            # L < K - 1
    (2, 5, 40, 8, None, None),            # L < K - 1 at K = 8
    (2, CHUNK, 64, 4, None, None),        # L = one chunk
    (2, CHUNK + 1, 64, 4, None, None),    # one chunk and a row
    (1, 1000, 48, 4, None, None),         # more chunks than ring slots
    (3, 1000, 37, 3, None, None),         # the same over a ragged, odd D
    (19, 40, 45, 4, None, None),          # ragged B and D, nB = 2
    (20, 30, 16, 4, None, None),          # nD == 1, nB = 2
    (3, 33, 130, 4, (2, 130), None),      # one tile split over CTAs
    (2, 17, 300, 8, (1, 256), None),      # split, one part past D
    (2, 70, 40, 3, (1, 7), None),         # an odd tile width, grouped
    (2, 100, 64, 4, None, (128, 0)),      # the strided x view
    (2, 100, 64, 4, None, (136, 1)),      # 1, 2 and 4 elements past an
    (2, 100, 64, 4, None, (136, 2)),      # aligned base: narrower copies
    (2, 100, 64, 4, None, (136, 4)),
    (1, 70, 300, 4, None, (600, 0)),      # D 300: 8-byte copies in bf16
] + [(2, 40, 24, k, None, None) for k in (1, 2, 5, 6, 7)]
# the hybrid serve's operand: (1, L, 16384) x (4, 16384), the x half of a
# (1, L, 32768) in-projection, at its 8 prefill lengths (chip_smoke.py,
# phases 14-15)
SERVE_LENS = (1, 2, 7, 71, 81, 132, 219, 300)
# chip_smoke.py's phase 13, (B, L, D, K, tiles, view)
PHASE13 = [
    (3, 50, 37, 4, None, None), (19, 40, 45, 4, None, None),
    (2, 64, 64, 1, None, None), (2, 64, 64, 2, None, None),
    (2, 64, 64, 4, None, None), (2, 1, 64, 4, None, None),
    (2, 2, 64, 4, None, None), (2, CHUNK, 64, 4, None, None),
    (2, CHUNK + 1, 64, 4, None, None), (1, 1000, 256, 4, None, None),
    (3, 1000, 40, 8, None, None), (20, 30, 16, 4, None, None),
    (3, 33, 130, 4, (2, 130), None), (2, 17, 300, 8, (1, 256), None),
    (1, 300, 16384, 4, None, None), (1, 300, 16384, 8, None, None),
    (1, 300, 16384, 4, None, (32768, 0)), (2, 100, 64, 4, None, (136, 1)),
    (2, 100, 64, 4, None, (136, 2)), (2, 100, 64, 4, None, (136, 4)),
]


def _operands(B, L, D, K, view, dt, seed=0):
    """numpy inputs for both packages; torch's x is the view (row pitch,
    first channel) of a buffer torch allocated, as the path passes it."""
    pitch, first = view or (D, 0)
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((B, L, pitch)).astype(np.float32)
    w = (rng.standard_normal((K, D)) * K ** -0.5).astype(np.float32)
    jd, td = DTYPES[dt]
    x = buf[..., first:first + D]
    tx = torch.from_numpy(buf).to(td).clone()[..., first:first + D]
    return ((jnp.asarray(np.ascontiguousarray(x), jd), jnp.asarray(w, jd)),
            (tx, torch.from_numpy(w).to(td)))


def _config(x, w, tiles):
    bB, bD, _, _, grid = _conv1d_geometry(x, w, tiles, None)
    return launch_config(w.shape[0], bB, bD, grid, x.element_size(),
                         operand_width(x))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_ring_emulate_matches_reference(case, dt):
    B, L, D, K, tiles, view = case
    (jx, jw), (tx, tw) = _operands(B, L, D, K, view, dt)
    cfg = _config(tx, tw, tiles)
    got, _ = conv1d_ring_emulate(tx, tw, cfg)
    assert got.dtype == tx.dtype and got.shape == (B, L, D)
    np.testing.assert_array_equal(_np(got), _np(conv1d_causal_plain(tx, tw)))
    want = jconv1d.conv1d_causal(jx, jw, tiles=(cfg["bB"], cfg["bD"]),
                                 interpret=True)
    if dt == "bf16":
        np.testing.assert_array_equal(_np(got), _np(want))
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("first,width,copy,f32_bytes", [
    (0, 8, "cp.async.cg", 16), (1, 1, "ld/st", 4), (2, 2, "cp.async.ca", 8),
    (4, 4, "cp.async.ca", 16)])
def test_copy_width_follows_the_operand(first, width, copy, f32_bytes):
    """Views 0, 1, 2 and 4 elements past a 16-byte base: bf16 takes
    16-byte cp.async, 2-byte loads, 4- and 8-byte cp.async; f32 16, 4, 8
    and 16 bytes."""
    _, (tx, tw) = _operands(2, 9, 64, 4, (136, first), "bf16")
    cfg = _config(tx, tw, None)
    assert (cfg["vec"], cfg["copy"], cfg["copy_bytes"]) == (width, copy,
                                                            2 * width)
    _, (fx, fw) = _operands(2, 9, 64, 4, (136, first), "f32")
    assert _config(fx, fw, None)["copy_bytes"] == f32_bytes


def _padding_words(x, w, cfg):
    """Words the counter charges for the tiles' padding, and (nD == 1, nB >
    1) the filter fetches it does not charge."""
    B, L, D = x.shape
    K = w.shape[0]
    bB, bD, Bp, Dp, (nB, nD) = _conv1d_geometry(x, w,
                                                (cfg["bB"], cfg["bD"]), None)
    p = x.element_size() / 4
    pad = 2 * (Bp * Dp - B * D) * L * p
    fetches = nB * nD if nD > 1 else 1
    return pad + fetches * K * bD * p - nB * K * D * p


@pytest.mark.parametrize("case", CASES + [
    (1, L, 16384, 4, None, (32768, 0)) for L in (7, 300)], ids=str)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_issued_words_equal_counter(case, dt):
    """The words the kernel's copies and stores issue: exactly
    ``conv1d_hbm_words`` when nD > 1 and the tiles divide B and D (the
    serve's shapes); otherwise the counter less what it charges for the
    tiles' padding, which the kernel masks, and plus the filter blocks it
    reads in every batch tile when nD == 1."""
    B, L, D, K, tiles, view = case
    _, (tx, tw) = _operands(B, L, D, K, view, dt)
    cfg = _config(tx, tw, tiles)
    y, words = conv1d_ring_emulate(tx, tw, cfg)
    counter = conv1d_hbm_words(tx, tw, tiles=(cfg["bB"], cfg["bD"]))
    assert words == counter - _padding_words(tx, tw, cfg)
    _, _, Bp, Dp, (_, nD) = _conv1d_geometry(tx, tw, tiles, None)
    if nD > 1 and (Bp, Dp) == (B, D):
        assert words == counter
    if D == 16384:
        assert torch.equal(y, conv1d_causal_plain(tx, tw))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_launch_config_fits_every_path_shape(dt):
    """Shared memory, threads, grid and copy geometry at every shape of the
    serve and every case of phase 13; the serve's operand takes 16-byte
    copies, and at L = 300 its ring keeps the bytes in flight that the
    kernel's head comment states."""
    shapes = PHASE13 + [(1, L, 16384, 4, None, (32768, 0))
                        for L in SERVE_LENS]
    for (B, L, D, K, tiles, view) in shapes:
        pitch, first = view or (D, 0)
        x = torch.empty((B, L, pitch), dtype=DTYPES[dt][1])
        x = x[..., first:first + D]
        w = torch.empty((K, D), dtype=x.dtype)
        cfg = _config(x, w, tiles)
        bB, bD, _, _, (nB, nD) = _conv1d_geometry(x, w, tiles, None)
        assert cfg["smem"] <= MAX_SMEM_BYTES
        assert cfg["threads"] <= MAX_THREADS
        assert cfg["threads"] == cfg["rows"] * cfg["cols"]
        assert cfg["rows"] <= CHUNK and cfg["grid"][1] == nB <= 65535
        assert cfg["span"] == cfg["cols"] * cfg["vec"]
        assert cfg["group_width"] % cfg["vec"] == 0
        # the grid's CTAs cover every channel of every tile
        assert cfg["parts"] * cfg["span"] >= cfg["group_width"]
        assert cfg["grid"][0] // cfg["parts"] * cfg["group_width"] >= D
        assert cfg["smem"] >= STAGES * cfg["stage_bytes"] + K * cfg["span"] * 4
    serve = _config(*_operands(1, 300, 16384, 4, (32768, 0), "bf16")[1],
                    None)
    assert serve["copy"] == "cp.async.cg" and serve["copy_bytes"] == 16
    ctas = serve["grid"][0] * serve["grid"][1]
    in_flight = ctas * (STAGES - 2) * serve["stage_bytes"]
    assert (ctas, serve["stage_bytes"], in_flight) == (256, 4096, 6 * 2 ** 20)


def test_source_constants_match():
    """The ring's shape in csrc/conv1d.cu is the one the wrapper sizes."""
    src = (CSRC / "conv1d.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("CHUNK"), const("STAGES"), const("MAX_THREADS")) == \
        (CHUNK, STAGES, MAX_THREADS)
