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
from repro_torch.ops import ExecutionContext

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


def _ssm_inputs(p: Mamba, x: torch.Tensor, cfg,
                ctx: Optional[ExecutionContext]):
    """Shared front: in-projection, causal conv, gate projections.

    Returns xh (B,L,H,ph), xi (B,L,di), z (B,L,di), loga (B,L,H),
    dt (B,L,H), Bm/Cm (B,L,S) as the reference, and the in-projection's x
    half before the conv (B,L,di), from which the prefill takes the conv
    tail of its state."""
    cd = dtype_of(cfg.compute_dtype)
    H, ph = _heads(cfg)
    di = cfg.d_inner
    xz = x.to(cd) @ p.w_in.to(cd)
    x_in, z = xz[..., :di], xz[..., di:]
    xi = ops.conv1d_causal(x_in, p.conv_w.to(cd), ctx=ctx)
    xi = F.silu(xi.float()).to(cd)
    dt = F.softplus((xi @ p.w_dt.to(cd)).float() + p.b_dt.float())
    A = torch.exp(p.log_A.float())  # (H,)
    loga = -dt * A  # log a_t (<= 0)
    Bm = (xi @ p.w_B.to(cd)).float()
    Cm = (xi @ p.w_C.to(cd)).float()
    B, L, _ = x.shape
    xh = xi.reshape(B, L, H, ph).float() * dt[..., None]
    return xh, xi, z, loga, dt, Bm, Cm, x_in


def _output(p: Mamba, y: torch.Tensor, xi: torch.Tensor, z: torch.Tensor,
            cfg, out_dtype) -> torch.Tensor:
    """D-skip, z gate and out-projection of a (B, L, H, ph) scan output."""
    B, L, H, ph = y.shape
    cd = dtype_of(cfg.compute_dtype)
    y = y + (xi.reshape(B, L, H, ph).float()
             * p.D_skip.float()[None, None, :, None])
    y = (y.reshape(B, L, H * ph) * F.silu(z.float())).to(cd)
    return (y @ p.w_out.to(cd)).to(out_dtype)


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
    zero padding)."""
    B, L, _ = x.shape
    H, ph = _heads(cfg)
    S = cfg.ssm_state_dim
    xh, xi, z, loga, dt, Bm, Cm, x_in = _ssm_inputs(p, x, cfg, ctx)

    c = min(cfg.chunk_size, L)
    pad = -L % c
    if pad:  # pad to a whole number of chunks
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        loga, Bm, Cm = (F.pad(a, (0, 0, 0, pad)) for a in (loga, Bm, Cm))
    nc = xh.shape[1] // c
    # causal mask from an index compare, as the reference's iota mask
    ar = torch.arange(c, device=x.device)
    tri = (ar[None, :] <= ar[:, None]).float()  # (t, u): u <= t
    h = (state[0].float() if state is not None
         else torch.zeros((B, H, ph, S), dtype=torch.float32,
                          device=x.device))
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
    out = _output(p, y, xi, z, cfg, x.dtype)

    new_state = None
    if state is not None:
        rows = state[1].shape[1]  # K - 1
        tail = x_in[:, max(0, L - rows):]
        tail = F.pad(tail, (0, 0, rows - tail.shape[1], 0))
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
    (aten, in f32, as the reference), then one step of the recurrence."""
    B = x.shape[0]
    H, ph = _heads(cfg)
    cd = dtype_of(cfg.compute_dtype)
    h, tail = state
    K, di = cfg.conv_kernel, cfg.d_inner

    xz = x.to(cd) @ p.w_in.to(cd)
    x_new, z = xz[..., :di], xz[..., di:]  # (B, 1, di)
    window = torch.cat([tail.to(cd), x_new], dim=1)[:, -K:]  # (B, K, di)
    xi = torch.einsum("bkd,kd->bd", window.float(),
                      p.conv_w.float())[:, None, :]
    xi = F.silu(xi).to(cd)

    dt = F.softplus((xi @ p.w_dt.to(cd)).float()
                    + p.b_dt.float())[:, 0]  # (B, H)
    a = torch.exp(-dt * torch.exp(p.log_A.float()))
    Bm = (xi @ p.w_B.to(cd)).float()[:, 0]
    Cm = (xi @ p.w_C.to(cd)).float()[:, 0]
    xhead = xi.reshape(B, H, ph).float() * dt[..., None]

    h_new = (a[:, :, None, None] * h.float()
             + torch.einsum("bhp,bs->bhps", xhead, Bm))
    y = torch.einsum("bhps,bs->bhp", h_new, Cm)
    out = _output(p, y[:, None], xi, z, cfg, x.dtype)
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
    xh, xi, z, loga, dt, Bm, Cm, _ = _ssm_inputs(
        p, x, cfg, ctx=ExecutionContext(backend="torch",
                                        device=x.device.type))
    h = torch.zeros((B, H, ph, cfg.ssm_state_dim), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(L):
        h = (torch.exp(loga[:, t])[:, :, None, None] * h
             + torch.einsum("bhp,bs->bhps", xh[:, t], Bm[:, t]))
        ys.append(torch.einsum("bhps,bs->bhp", h, Cm[:, t]))
    return _output(p, torch.stack(ys, dim=1), xi, z, cfg, x.dtype)
