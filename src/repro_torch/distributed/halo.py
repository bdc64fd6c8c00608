"""Executable distributed conv2d: halo exchange vs. all-gather, over a conv
mesh. The port of ``repro.distributed.halo``.

Two strategies for the same 7NL conv, both driven by one
:class:`~repro_torch.distributed.geometry.DistConvGeometry` and each written
once, as a shard body over the three collectives of a
:class:`~repro_torch.distributed.collectives.ConvMesh`, so the in-process
mesh and the process-group mesh run the same code:

  * :func:`halo_conv` - the paper-§4.2 blocking made runnable. Inputs are
    sharded over ``(N, cI, hO, wO)`` as disjoint owned slabs; each device
    fetches the ``h_F - sh`` overlap rows (and ``w_F - sw`` cols) from its
    spatial successor, runs the shard-local conv through the
    ``repro_torch.ops`` registry (so ``conv2d_tc_kernel`` serves each bf16
    shard on the card), and sums cI-partial outputs.
  * :func:`allgather_conv` - the naive baseline: every device all-gathers
    the full input (and the filter along cI), then computes only its own
    output block. Same sharded inputs, same outputs, (P-1)/P x |I| more
    wire traffic.

On a :class:`~repro_torch.distributed.collectives.LocalConvMesh` both return
the global VALID conv (its padded form with ``full_output=True``). On a
:class:`~repro_torch.distributed.collectives.GroupConvMesh` each rank
returns its own block of the padded output, ``(bN, c_O, bh, bw)``, the
reference's shard of its sharded result; assembling the blocks
(``mesh.assemble``) is the caller's, outside the counted wire. Gradients
flow through the in-process mesh; on a process group ``halo_conv`` raises
when an input requires one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.parallel_tiling import (ParallelBlocking,
                                              optimize_parallel_blocking)
from repro_torch.kernels.conv2d import check_shard_window

from .collectives import ConvMesh, GroupConvMesh
from .geometry import DIST_AXES, DistConvGeometry

# how each array is split over the mesh (the reference's in/out specs)
IN_SPEC = ("N", "cI", "hO", "wO")
FILTER_SPEC = (None, "cI", None, None)
OUT_SPEC = ("N", None, "hO", "wO")


def default_blocking(x_shape, w_shape, stride: Tuple[int, int],
                     P_devices: Optional[int] = None,
                     prec=None) -> ParallelBlocking:
    """The LP-chosen processor grid for this conv over ``P_devices``
    devices (default: the CUDA devices present, at least 1), restricted to
    the axes the distributed conv serves."""
    from repro_torch.core.conv_model import ConvShape, Precision

    N, c_I, H, W = x_shape
    c_O, _, h_F, w_F = w_shape
    sh, sw = stride
    shape = ConvShape(N=N, c_I=c_I, c_O=c_O,
                      w_O=(W - w_F) // sw + 1, h_O=(H - h_F) // sh + 1,
                      w_F=w_F, h_F=h_F, sw=sw, sh=sh,
                      prec=prec or Precision())
    P_devices = P_devices or max(torch.cuda.device_count(), 1)
    return optimize_parallel_blocking(shape, P_devices,
                                      restrict_axes=DIST_AXES)


def _blocking(x, w, stride, blocking, mesh):
    """The caller's blocking, else the LP's over the mesh's devices."""
    if blocking is not None:
        return blocking
    return default_blocking(x.shape, w.shape, stride,
                            P_devices=None if mesh is None else mesh.P)


def _geometry(x, w, stride, blocking) -> DistConvGeometry:
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    return DistConvGeometry.build(
        N=N, c_I=c_I, c_O=c_O,
        h_O=(H - h_F) // sh + 1, w_O=(W - w_F) // sw + 1,
        h_F=h_F, w_F=w_F, sh=sh, sw=sw, grid=blocking).validate()


def _check_mesh(mesh: ConvMesh, geom: DistConvGeometry) -> ConvMesh:
    names = tuple(mesh.axis_names)
    if names != DIST_AXES:
        raise ValueError(f"distributed conv needs mesh axes {DIST_AXES}, "
                         f"got {names} (use launch.make_conv_mesh)")
    if tuple(mesh.sizes) != geom.grid:
        raise ValueError(f"mesh sizes {tuple(mesh.sizes)} do not match the "
                         f"blocking grid {geom.grid}")
    return mesh


def _resolve_mesh(mesh: Optional[ConvMesh],
                  geom: DistConvGeometry) -> ConvMesh:
    if mesh is not None:
        return _check_mesh(mesh, geom)
    from repro_torch.launch.mesh import make_conv_mesh

    return make_conv_mesh(geom.grid_dict())


def _local_ctx(ctx, backend: str):
    """The shard-local execution context: same target, mesh stripped (each
    shard is a single device), the requested local backend pinned."""
    target = dataclasses.replace(ctx.target, mesh_axes=())
    return dataclasses.replace(ctx, target=target, backend=backend)


def _pad_operands(x, w, geom: DistConvGeometry):
    """Pad to the sharded global dims. Input rows/cols beyond the tight
    VALID extent are never consumed by a real output; padded cI channels
    contribute zeros; padded N rows are sliced away."""
    N, c_I, H, W = x.shape
    c_O = w.shape[0]
    x = x[:, :, :min(H, geom.Hp), :min(W, geom.Wp)]
    x = F.pad(x, (0, geom.Wp - x.shape[3], 0, geom.Hp - x.shape[2],
                  0, geom.cIp - c_I, 0, geom.Np - N))
    w = F.pad(w, (0, 0, 0, 0, 0, geom.cIp - c_I))
    return x, w, c_O


def _shard_conv(xs, ws, geom: DistConvGeometry, lctx) -> List[torch.Tensor]:
    """The shard-local conv of each held device, f32 partials: the window
    must be exact (``check_shard_window``, the check ``conv2d_shard`` makes
    too), then ``ops.conv2d`` on the local context, through the dispatcher
    (its plan, counters and fault handling), as the reference asserts
    ``exact_window`` and calls ``ops.conv2d``."""
    from repro_torch import ops

    check_shard_window(geom.h_ext, geom.w_ext, geom.h_F, geom.w_F, geom.sh,
                       geom.sw)
    return [ops.conv2d(xl.contiguous(), wl.contiguous(),
                       stride=(geom.sh, geom.sw), ctx=lctx,
                       out_dtype=torch.float32) for xl, wl in zip(xs, ws)]


def _halo_body(mesh: ConvMesh, geom: DistConvGeometry, xs, ws, lctx,
               out_dtype) -> List[torch.Tensor]:
    """One shard body for every mesh. xs: owned slabs (bN, b_cI, bh*sh,
    bw*sw); ws: filter blocks (c_O, b_cI, h_F, w_F).

    Rows first, then columns over the row-extended height, so corner halos
    ride the second exchange. Single-shard axes skip the wire entirely:
    their windows are completed with a *local* zero fill (those rows/cols
    only ever feed padded outputs), keeping the shifted words equal to
    ``geometry.halo_words`` for every grid."""
    gN, gcI, ghO, gwO = geom.grid
    if geom.halo_h > 0 and ghO > 1:
        got = mesh.shift_from_next([xl[:, :, :geom.halo_h] for xl in xs],
                                   "hO")
        xs = [torch.cat([xl, h], dim=2) for xl, h in zip(xs, got)]
    if geom.halo_w > 0 and gwO > 1:
        got = mesh.shift_from_next([xl[:, :, :, :geom.halo_w] for xl in xs],
                                   "wO")
        xs = [torch.cat([xl, h], dim=3) for xl, h in zip(xs, got)]
    pad_h = max(geom.h_ext - xs[0].shape[2], 0)
    pad_w = max(geom.w_ext - xs[0].shape[3], 0)
    if pad_h or pad_w:
        xs = [F.pad(xl, (0, pad_w, 0, pad_h)) for xl in xs]
    xs = [xl[:, :, :geom.h_ext, :geom.w_ext] for xl in xs]
    outs = _shard_conv(xs, ws, geom, lctx)
    if gcI > 1:
        outs = mesh.psum(outs, "cI")
    return [o.to(out_dtype) for o in outs]


def _allgather_body(mesh: ConvMesh, geom: DistConvGeometry, xs, ws, lctx,
                    out_dtype) -> List[torch.Tensor]:
    gN, gcI, ghO, gwO = geom.grid
    xg = xs
    for name, size, dim in (("N", gN, 0), ("cI", gcI, 1), ("hO", ghO, 2),
                            ("wO", gwO, 3)):
        if size > 1:
            xg = mesh.all_gather(xg, name, dim)
    wg = mesh.all_gather(ws, "cI", 1) if gcI > 1 else ws
    sh, sw = geom.sh, geom.sw
    wins = []
    for a, i_n, i_h, i_w in zip(xg, mesh.axis_index("N"),
                                mesh.axis_index("hO"),
                                mesh.axis_index("wO")):
        # tail windows read past the owned extent: zero-pad locally (free)
        a = F.pad(a, (0, geom.halo_w, 0, geom.halo_h))
        h0, w0 = i_h * geom.bh * sh, i_w * geom.bw * sw
        wins.append(a[i_n * geom.bN:(i_n + 1) * geom.bN, :,
                      h0:h0 + geom.h_ext, w0:w0 + geom.w_ext])
    outs = _shard_conv(wins, wg, geom, lctx)
    return [o.to(out_dtype) for o in outs]


def _run(body, x, w, stride, blocking, mesh, ctx, local_backend, out_dtype,
         full_output):
    from repro_torch import ops

    ctx = ops.default_context() if ctx is None else ctx
    blocking = _blocking(x, w, stride, blocking, mesh)
    geom = _geometry(x, w, stride, blocking)
    mesh = _resolve_mesh(mesh, geom)
    if isinstance(mesh, GroupConvMesh) and torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad):
        raise NotImplementedError(
            "no gradient flows across the ranks of a process-group mesh; "
            "differentiate through a LocalConvMesh")
    N = x.shape[0]
    xp, wp, c_O = _pad_operands(x, w, geom)
    outs = body(mesh, geom, mesh.scatter(xp, IN_SPEC),
                mesh.scatter(wp, FILTER_SPEC), _local_ctx(ctx, local_backend),
                out_dtype)
    if isinstance(mesh, GroupConvMesh):
        return outs[0]
    out = mesh.assemble(dict(zip(mesh.devices, outs)), OUT_SPEC)
    if full_output:
        return out
    return out[:N, :c_O, :geom.h_O, :geom.w_O]


def halo_conv(x, w, stride=(1, 1), blocking=None,
              mesh: Optional[ConvMesh] = None, ctx=None,
              local_backend: str = "cuda", out_dtype=torch.float32,
              full_output: bool = False):
    """Distributed halo-exchange conv2d (NCHW x OIHW, VALID padding).

    ``blocking`` is a :class:`ParallelBlocking` (or axis->procs dict) whose
    grid must match ``mesh`` (an in-process mesh, built by
    ``launch.make_conv_mesh``, when omitted; the LP's grid over the
    mesh's devices when ``blocking`` is omitted). The shard-local conv
    dispatches through ``repro_torch.ops`` with ``local_backend``.

    ``full_output=True`` returns the padded global output
    ``(Np, c_O, hOp, wOp)``; the measured-words counter charges only the
    algorithm's halo + psum traffic. On a process-group mesh the rank's
    own output block is returned (module docstring)."""
    return _run(_halo_body, x, w, stride, blocking, mesh, ctx,
                local_backend, out_dtype, full_output)


def allgather_conv(x, w, stride=(1, 1), blocking=None,
                   mesh: Optional[ConvMesh] = None, ctx=None,
                   local_backend: str = "cuda", out_dtype=torch.float32,
                   full_output: bool = False):
    """The naive all-gather baseline: same sharded inputs as
    :func:`halo_conv`, but every device gathers the *full* input (and the
    filter along cI) before computing its own output block."""
    return _run(_allgather_body, x, w, stride, blocking, mesh, ctx,
                local_backend, out_dtype, full_output)


# ---------------------------------------------------------------------------
# Measured inter-device word counters (shape-only; meta tensors work).
# ---------------------------------------------------------------------------

def _word_widths(x, w, out_dtype):
    return (x.dtype.itemsize / 4.0, w.dtype.itemsize / 4.0,
            out_dtype.itemsize / 4.0)


def conv2d_dist_comm_words(x, w, stride=(1, 1), blocking=None,
                           out_dtype=torch.float32, mesh=None,
                           **_kw) -> float:
    """Measured inter-device words (32-bit, per device) one ``halo_conv``
    dispatch moves: halo shift volume + cI psum volume, computed from the
    same :class:`DistConvGeometry` the execution runs (the blocking, when
    omitted, as :func:`halo_conv` chooses it).

    The psum leg always charges f32 words whatever ``out_dtype`` is: the
    shard-local conv emits f32 partials and the reduction runs *before*
    the cast, so that is what the all-reduce puts on the wire."""
    geom = _geometry(x, w, stride, _blocking(x, w, stride, blocking, mesh))
    p_in, _, _ = _word_widths(x, w, out_dtype)
    return geom.comm_words(p_in=p_in, p_out=1.0)


def allgather_comm_words(x, w, stride=(1, 1), blocking=None,
                         out_dtype=torch.float32, mesh=None,
                         **_kw) -> float:
    """Per-device words the all-gather baseline moves for the same grid."""
    geom = _geometry(x, w, stride, _blocking(x, w, stride, blocking, mesh))
    p_in, p_flt, _ = _word_widths(x, w, out_dtype)
    return geom.allgather_words(p_in=p_in, p_flt=p_flt)
