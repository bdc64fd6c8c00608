"""Mamba block in chunkwise state-space-dual (SSD) form (the counterpart of
``repro.models.ssm``).

The sequence is split into chunks of ``cfg.chunk_size``; within a chunk the
recurrence is two einsums (an attention-like (c x c) masked product), and a
Python loop over the chunks carries the (H, p, S) state, where the reference
``lax.scan``s. Per-head scalar decay a_t = exp(-dt_t * A_h), B/C projections
shared across heads.

Recurrence (per batch, head):
    h_t = a_t h_{t-1} + (dt_t x_t) outer B_t        h in R^{p x S}
    y_t = h_t C_t + D_h x_t

The short causal conv1d in front runs through ``ops.conv1d_causal`` (the
hand-written kernel of ``kernels/csrc/conv1d.cu`` on the ``cuda`` backend).
Decode steps keep the conv's last K-1 inputs as the ``tail`` of the state.

Weights are cast to ``cfg.compute_dtype`` at use, except ``conv_w``,
``b_dt``, ``log_A`` and ``D_skip``, which the decode step reads in f32 (and
``transformer.compute_params`` leaves in the parameter dtype).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.dtensors import is_dtensor, reshard, sharding_dims
from repro_torch.ops import ExecutionContext

from . import spmd
from .layers import _param, dtype_of

State = Tuple[torch.Tensor, torch.Tensor]  # (ssm h, conv tail)


def _heads(cfg) -> Tuple[int, int]:
    di = cfg.d_inner
    H = di // cfg.hd if di % cfg.hd == 0 else 1
    return H, di // H


class Mamba(nn.Module):
    """The parameters of ``repro.models.ssm.init_mamba``: ``w_in`` (D, 2 di:
    x then z), ``conv_w`` (K, di), ``w_dt`` (di, H), ``b_dt`` (H,),
    ``w_B``/``w_C`` (di, S), ``log_A`` (H,), ``D_skip`` (H,), ``w_out``
    (di, D)."""

    def __init__(self, cfg, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, di, S, K = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                       cfg.conv_kernel)
        H, _ = _heads(cfg)
        dtype = dtype_of(cfg.param_dtype)

        def param(shape, std):
            return _param(shape, std, dtype, device, generator)

        self.w_in = param((D, 2 * di), D ** -0.5)
        self.conv_w = param((K, di), K ** -0.5)
        self.w_dt = param((di, H), di ** -0.5)
        self.b_dt = nn.Parameter(torch.zeros(H, dtype=dtype, device=device))
        self.w_B = param((di, S), di ** -0.5)
        self.w_C = param((di, S), di ** -0.5)
        self.log_A = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, device=device)).to(dtype))
        self.D_skip = nn.Parameter(torch.ones(H, dtype=dtype, device=device))
        self.w_out = param((di, D), di ** -0.5)


def _front(p: Mamba, x: torch.Tensor, cfg,
           ctx: Optional[ExecutionContext]):
    """Shared front: in-projection, causal conv, gate projections.

    Returns xi (B,L,di) (the conv's output after SiLU), z (B,L,di), the dt
    projection before its bias and softplus (B,L,H), Bm/Cm (B,L,S) in f32,
    and the in-projection's x half before the conv (B,L,di), from which the
    prefill takes the conv tail of its state. On a mesh: the sequence made
    whole first (``spmd.gather_rows``), x and z each brought to di on
    ``model`` by one all-to-all (``spmd.split_columns``), the conv on each
    device's channels, the row-parallel gate products all-reduced
    (``spmd.like``)."""
    cd = dtype_of(cfg.compute_dtype)
    xc = spmd.gather_rows(x.to(cd))
    xz = xc @ p.w_in.to(cd)
    x_in, z = spmd.split_columns(xz, 2)
    xi = spmd.on_channels(
        lambda a, w: ops.conv1d_causal(a, w, ctx=ctx), x_in, p.conv_w.to(cd))
    xi = F.silu(xi.float()).to(cd)
    dt_raw = spmd.like(xi @ p.w_dt.to(cd), xc)
    Bm = spmd.like(xi @ p.w_B.to(cd), xc).float()
    Cm = spmd.like(xi @ p.w_C.to(cd), xc).float()
    return xi, z, dt_raw, Bm, Cm, x_in


def _gated(y: torch.Tensor, xi: torch.Tensor, z: torch.Tensor,
           D_skip: torch.Tensor, cd) -> torch.Tensor:
    """D-skip and z gate of a (B, L, H, ph) scan output: (B, L, H ph) in
    the compute dtype, before the out-projection."""
    B, L, H, ph = y.shape
    y = y + (xi.reshape(B, L, H, ph).float()
             * D_skip.float()[None, None, :, None])
    return (y.reshape(B, L, H * ph) * F.silu(z.float())).to(cd)


def _scan(xi, z, dt_raw, Bm, Cm, h, b_dt, log_A, D_skip, c: int):
    """The chunked SSD scan over the heads of ``dt_raw`` (B, L, H): xi and
    z (B, L, H ph), Bm/Cm (B, L, S), ``h`` the start state (B, H, ph, S) or
    None (zeros), the (H,) leaves. Returns the gated output (B, L, H ph) in
    xi's dtype and the last state in f32. On a mesh it runs on each
    device's heads (:func:`_on_heads`)."""
    B, L, H = dt_raw.shape
    ph = xi.shape[-1] // H
    S = Bm.shape[-1]
    dt = F.softplus(dt_raw.float() + b_dt.float())
    A = torch.exp(log_A.float())  # (H,)
    loga = -dt * A  # log a_t (<= 0)
    xh = xi.reshape(B, L, H, ph).float() * dt[..., None]

    c = min(c, L)
    pad = -L % c
    if pad:  # pad to a whole number of chunks
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        loga, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (loga, Bm, Cm))
    nc = xh.shape[1] // c
    # causal mask from an index compare, as the reference's iota mask
    ar = torch.arange(c, device=xi.device)
    tri = (ar[None, :] <= ar[:, None]).float()  # (t, u): u <= t
    h = (h.float() if h is not None
         else torch.zeros((B, H, ph, S), dtype=torch.float32,
                          device=xi.device))
    ys = []
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        xb, la, Bc, Cc = xh[:, sl], loga[:, sl], Bm[:, sl], Cm[:, sl]
        Lc = torch.cumsum(la, dim=1)  # inclusive cumulative log-decay
        scores = torch.einsum("bts,bus->btu", Cc, Bc)
        # valid (t >= u) exponents are <= 0; the clamp keeps the upper
        # triangle from overflowing into inf * 0 = NaN under the mask
        decay = torch.exp(torch.clamp(Lc[:, :, None, :] - Lc[:, None, :, :],
                                      max=0.0))  # (B, t, u, H)
        y_intra = torch.einsum("btu,btuh,buhp->bthp", scores * tri[None],
                               decay * tri[None, :, :, None], xb)
        y_inter = torch.einsum("bts,bhps,bth->bthp", Cc, h, torch.exp(Lc))
        Lend = Lc[:, -1:, :]  # (B, 1, H)
        w_end = torch.exp(Lend - Lc)  # decay from u to the chunk's end
        h = (torch.exp(Lend[:, 0, :])[:, :, None, None] * h
             + torch.einsum("buh,buhp,bus->bhps", w_end, xb, Bc))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :L]
    return _gated(y, xi, z, D_skip, xi.dtype), h


def _step(xi, z, dt_raw, Bm, Cm, h, b_dt, log_A, D_skip):
    """One recurrence step over the heads of ``dt_raw`` (B, 1, H): xi and
    z (B, 1, H ph), Bm/Cm (B, S) in f32, ``h`` (B, H, ph, S). Returns the
    gated output (B, 1, H ph) in xi's dtype and the new state in f32. On a
    mesh it runs on each device's heads (:func:`_on_heads`)."""
    B, _, H = dt_raw.shape
    ph = xi.shape[-1] // H
    dt = F.softplus(dt_raw.float() + b_dt.float())[:, 0]  # (B, H)
    a = torch.exp(-dt * torch.exp(log_A.float()))
    xhead = xi.reshape(B, H, ph).float() * dt[..., None]
    h_new = (a[:, :, None, None] * h.float()
             + torch.einsum("bhp,bs->bhps", xhead, Bm))
    y = torch.einsum("bhps,bs->bhp", h_new, Cm)
    return _gated(y[:, None], xi, z, D_skip, xi.dtype), h_new


def _on_heads(fn, xi, z, dt_raw, Bm, Cm, h, b_dt, log_A, D_skip, **kw):
    """``fn`` (:func:`_scan` or :func:`_step`); on a mesh, on each
    device's heads (``local_map``): xi and z in their placements (di on
    ``model``), dt_raw, the (H,) leaves and the state chunked to the same
    heads (``dtensors.reshard``: no wire, each gradient all-reduced), Bm
    and Cm whole there (their gradients Partial over the heads' mesh
    dims). The outputs: the gated (B, L, di) as xi, the state (B, H, ph,
    S) heads on xi's di dims, batch as xi's."""
    if not is_dtensor(xi):
        return fn(xi, z, dt_raw, Bm, Cm, h, b_dt, log_A, D_skip, **kw)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xi.device_mesh
    hdims, bdims = sharding_dims(xi, xi.ndim - 1), sharding_dims(xi, 0)

    def pl(head_dim, batch=True):
        return tuple(Shard(head_dim) if head_dim is not None and i in hdims
                     else Shard(0) if batch and i in bdims else Replicate()
                     for i in range(mesh.ndim))

    def heads(t, head_dim, batch=True):
        return reshard(t, pl(head_dim, batch))

    rows = pl(None)
    rows_grad = tuple(Partial() if i in hdims else p
                      for i, p in enumerate(rows))
    # the (H,) leaves' gradients: each device's rows add theirs
    leaf_grad = tuple(Shard(0) if i in hdims else Partial() if i in bdims
                      else Replicate() for i in range(mesh.ndim))
    args = [xi, z, heads(dt_raw, 2), Bm, Cm]
    in_pl = [pl(2), pl(2), pl(2), rows, rows]
    grad_pl = [pl(2), pl(2), pl(2), rows_grad, rows_grad]
    if h is not None:
        args.append(heads(h, 1))
        in_pl.append(pl(1))
        grad_pl.append(pl(1))
    args += [heads(t, 0, batch=False) for t in (b_dt, log_A, D_skip)]
    in_pl += [pl(0, batch=False)] * 3
    grad_pl += [leaf_grad] * 3

    def local(xi_, z_, dt_, Bm_, Cm_, *rest):
        h_ = rest[0] if h is not None else None
        return fn(xi_, z_, dt_, Bm_, Cm_, h_, *rest[-3:], **kw)

    return local_map(local, out_placements=(pl(2), pl(1)),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def mamba_block(
    p: Mamba,
    x: torch.Tensor,  # (B, L, D)
    cfg,
    state: Optional[State] = None,  # (ssm h, conv tail)
    ctx: Optional[ExecutionContext] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Full-sequence (prefill) mamba block; chunked SSD scan. With a
    ``state``, the scan starts from its h and the new state is the last h
    and the conv tail: the last K-1 rows of the in-projection's x half,
    left-padded with zeros when the sequence is shorter (the conv's own
    zero padding).

    On a device mesh (``x``, the leaves and the state DTensors placed by
    ``models.sharding``; module docstring) the same function runs: the
    front as :func:`_front` says, the scan on each device's heads, the
    out-projection's Partial product reduced to ``x``'s placements (an
    all-reduce, a reduce-scatter where ``x`` is sequence-sharded)."""
    B, L, _ = x.shape
    H, _ = _heads(cfg)
    cd = dtype_of(cfg.compute_dtype)
    xi, z, dt_raw, Bm, Cm, x_in = _front(p, x, cfg, ctx)
    # on a mesh: di gathered where the heads do not divide its axes
    xi, z = spmd.split_heads(xi, H), spmd.split_heads(z, H)
    y, h = _on_heads(_scan, xi, z, dt_raw, Bm, Cm,
                     None if state is None else state[0],
                     p.b_dt, p.log_A, p.D_skip, c=cfg.chunk_size)
    out = spmd.like((y @ p.w_out.to(cd)).to(x.dtype), x)

    new_state = None
    if state is not None:
        rows = state[1].shape[1]  # K - 1
        tail = x_in[:, max(0, L - rows):]
        tail = spmd.pad(tail, (0, 0, rows - tail.shape[1], 0))
        new_state = (h.to(state[0].dtype), tail.to(state[1].dtype))
    return out, new_state


def mamba_decode_step(
    p: Mamba,
    x: torch.Tensor,  # (B, 1, D)
    cfg,
    state: State,  # h (B, H, ph, S), conv tail (B, K-1, di)
    ctx: Optional[ExecutionContext] = None,
) -> Tuple[torch.Tensor, State]:
    """One token per row: the conv over the state's tail and the new input
    (aten, in f32, as the reference), then one step of the recurrence. On a
    mesh (as :func:`mamba_block`) the window's conv runs on each device's
    channels and the step on its heads."""
    H, _ = _heads(cfg)
    cd = dtype_of(cfg.compute_dtype)
    h, tail = state
    K = cfg.conv_kernel

    xz = x.to(cd) @ p.w_in.to(cd)
    x_new, z = spmd.split_columns(xz, 2)  # (B, 1, di)
    window = torch.cat([tail.to(cd), x_new], dim=1)[:, -K:]  # (B, K, di)
    xi = spmd.on_channels(
        lambda a, w: torch.einsum("bkd,kd->bd", a.float(),
                                  w.float())[:, None, :], window, p.conv_w)
    xi = F.silu(xi).to(cd)

    dt_raw = spmd.like(xi @ p.w_dt.to(cd), x)
    Bm = spmd.like(xi @ p.w_B.to(cd), x).float()[:, 0]
    Cm = spmd.like(xi @ p.w_C.to(cd), x).float()[:, 0]
    xi, z = spmd.split_heads(xi, H), spmd.split_heads(z, H)
    y, h_new = _on_heads(_step, xi, z, dt_raw, Bm, Cm, h, p.b_dt, p.log_A,
                         p.D_skip)
    out = spmd.like((y @ p.w_out.to(cd)).to(x.dtype), x)
    new_tail = torch.cat([tail[:, 1:], x_new.to(tail.dtype)], dim=1) \
        if K > 1 else tail
    return out, (h_new.to(h.dtype), new_tail)


def init_mamba_state(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> State:
    H, ph = _heads(cfg)
    h = torch.zeros((batch, H, ph, cfg.ssm_state_dim), dtype=dtype,
                    device=device)
    tail = torch.zeros((batch, max(cfg.conv_kernel - 1, 1), cfg.d_inner),
                       dtype=dtype, device=device)
    return h, tail


# ---------------------------------------------------------------------------
# Sequential oracle (tests): the literal recurrence.
# ---------------------------------------------------------------------------

def mamba_block_ref(p: Mamba, x: torch.Tensor, cfg) -> torch.Tensor:
    B, L, _ = x.shape
    H, ph = _heads(cfg)
    cd = dtype_of(cfg.compute_dtype)
    xi, z, dt_raw, Bm, Cm, _ = _front(
        p, x, cfg, ctx=ExecutionContext(backend="torch",
                                        device=x.device.type))
    dt = F.softplus(dt_raw.float() + p.b_dt.float())
    loga = -dt * torch.exp(p.log_A.float())
    xh = xi.reshape(B, L, H, ph).float() * dt[..., None]
    h = torch.zeros((B, H, ph, cfg.ssm_state_dim), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(L):
        h = (torch.exp(loga[:, t])[:, :, None, None] * h
             + torch.einsum("bhp,bs->bhps", xh[:, t], Bm[:, t]))
        ys.append(torch.einsum("bhps,bs->bhp", h, Cm[:, t]))
    y = _gated(torch.stack(ys, dim=1), xi, z, p.D_skip, cd)
    return (y @ p.w_out.to(cd)).to(x.dtype)
