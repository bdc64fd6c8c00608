"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory), the
counterpart of ``repro.models.xlstm``.

The reference's two simplifications are part of the function and are kept:
  * mLSTM's exponential input gate is stabilized by clamping its
    pre-activation to [-8, 8] (``_EXP_CLAMP``) instead of xLSTM's running-max
    bookkeeping. The prefill runs the chunkwise-dual form: within a chunk of
    ``cfg.chunk_size`` the recurrence C_t = f_t C_{t-1} + i_t v_t k_t^T is
    two einsums over a (c x c) masked weight, and ``scan_util.scan`` (a
    Python loop) carries the (B, H, hd, hd) state across chunks.
  * sLSTM's gates are conditioned on the input only (no hidden-to-hidden
    recurrence), so its scalar recurrence is associative. The reference
    runs it as ``jax.lax.associative_scan``; torch has none, so the port runs
    a Hillis-Steele prefix over the sequence with the same ``combine``:
    log2 L doubling steps of elementwise ops, not one step a position. The
    rounding order differs from XLA's tree: equal within f32 tolerance, not
    bit for bit.

Everything after the projections is f32: the gates, the states (``C``, ``n``
for mLSTM; ``c``, ``n`` for sLSTM) and their einsums. The biases ``b_if`` and
``b_zifo`` are read in f32, as the reference adds them
(``transformer.compute_params`` leaves them in the parameter dtype). No block
calls a dispatched op: the ``ctx`` argument is carried for the stack's
uniform signature, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.ops import ExecutionContext

from .layers import _param, dtype_of
from .scan_util import scan

State = Tuple[torch.Tensor, torch.Tensor]

_EXP_CLAMP = 8.0


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """The parameters of ``repro.models.xlstm.init_mlstm``: ``wq``/``wk``/
    ``wv``/``wo`` (D, D), ``w_if`` (D, 2H: input then forget gate
    pre-activations), ``b_if`` (2H,)."""

    def __init__(self, cfg, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        dtype = dtype_of(cfg.param_dtype)
        std = D ** -0.5

        def param(shape):
            return _param(shape, std, dtype, device, generator)

        self.wq = param((D, D))
        self.wk = param((D, D))
        self.wv = param((D, D))
        self.w_if = param((D, 2 * H))
        self.b_if = nn.Parameter(torch.zeros(2 * H, dtype=dtype,
                                             device=device))
        self.wo = param((D, D))


def _mlstm_gates(p: MLSTM, x: torch.Tensor, cfg):
    """q (scaled by hd^-1/2), k, v (B, L, H, hd) and log i, log f (B, L, H),
    all f32."""
    cd = dtype_of(cfg.compute_dtype)
    B, L, D = x.shape
    H = cfg.n_heads
    hd = D // H
    xc = x.to(cd)
    q = (xc @ p.wq.to(cd)).reshape(B, L, H, hd)
    k = (xc @ p.wk.to(cd)).reshape(B, L, H, hd)
    v = (xc @ p.wv.to(cd)).reshape(B, L, H, hd)
    gates = (xc @ p.w_if.to(cd)).float() + p.b_if.float()
    ig, fg = gates[..., :H], gates[..., H:]
    logi = torch.clamp(ig, -_EXP_CLAMP, _EXP_CLAMP)  # log of exp input gate
    logf = F.logsigmoid(fg)  # forget in (0, 1)
    return q.float() * hd ** -0.5, k.float(), v.float(), logi, logf


def _project_out(p, h: torch.Tensor, cfg, out_dtype) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    return (h.to(cd) @ p.wo.to(cd)).to(out_dtype)


def _mlstm_chunk(carry: State, inp) -> Tuple[State, torch.Tensor]:
    """One chunk of the chunkwise-dual form: the chunk's outputs (B, c, H,
    hd) and the state at its end."""
    C_prev, n_prev = carry  # (B, H, hd, hd), (B, H, hd)
    qc, kc, vc, lic, lfc = inp  # (B, c, H, *)
    c = qc.shape[1]
    Lc = torch.cumsum(lfc, dim=1)  # cumulative log forget (inclusive)
    # weight of source u at target t: exp(Lc_t - Lc_u + log i_u). Valid
    # (t >= u) entries are <= _EXP_CLAMP; clamping before the exponential
    # keeps the upper triangle from overflowing into inf * 0 = NaN
    w = torch.exp(torch.clamp(Lc[:, :, None, :] - Lc[:, None, :, :]
                              + lic[:, None, :, :], max=_EXP_CLAMP))
    ar = torch.arange(c, device=qc.device)
    tri = (ar[None, :] <= ar[:, None]).float()  # (t, u): u <= t
    sw = torch.einsum("bthd,buhd->btuh", qc, kc) * (w * tri[None, :, :, None])
    num = torch.einsum("btuh,buhd->bthd", sw, vc)
    den = sw.sum(dim=2)[..., None]  # the reference's einsum with ones(k)
    # carry-in contribution
    qs = qc * torch.exp(Lc)[..., None]
    num = num + torch.einsum("bthd,bhde->bthe", qs, C_prev)
    den = den + torch.einsum("bthd,bhd->bth", qs, n_prev)[..., None]
    h = num / torch.clamp(torch.abs(den), min=1.0)
    # state at the chunk's end
    Lend = Lc[:, -1:, :]
    kw = kc * torch.exp(Lend - Lc + lic)[..., None]  # (B, c, H, hd)
    decay = torch.exp(Lend[:, 0])  # (B, H)
    C_new = (decay[:, :, None, None] * C_prev
             + torch.einsum("buhd,buhe->bhde", kw, vc))
    n_new = decay[:, :, None] * n_prev + kw.sum(dim=1)
    return (C_new, n_new), h


def mlstm_block(
    p: MLSTM,
    x: torch.Tensor,  # (B, L, D)
    cfg,
    state: Optional[State] = None,  # C (B, H, hd, hd), n (B, H, hd)
    ctx: Optional[ExecutionContext] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Full-sequence (prefill) mLSTM block in the chunkwise-dual form. The
    sequence is padded to whole chunks with zeros in q, k, v, log i and log
    f: a padded step has f = i = 1 and k = v = 0, so the state at the last
    chunk's end is the state at L. With a ``state``, the scan starts from it
    and the new state is returned."""
    del ctx  # no dispatched kernel in the chunkwise-dual form
    B, L, D = x.shape
    H = cfg.n_heads
    hd = D // H
    q, k, v, logi, logf = _mlstm_gates(p, x, cfg)

    c = min(cfg.chunk_size, L)
    pad = -L % c
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi, logf = (F.pad(a, (0, 0, 0, pad)) for a in (logi, logf))
    nc = q.shape[1] // c

    def to_chunks(a):
        return a.reshape(B, nc, c, *a.shape[2:]).transpose(0, 1)

    if state is None:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    else:
        C0, n0 = (s.float() for s in state)
    (C_last, n_last), hs = scan(
        _mlstm_chunk, (C0, n0), tuple(map(to_chunks, (q, k, v, logi, logf))))
    h = hs.transpose(0, 1).reshape(B, nc * c, H, hd)[:, :L].reshape(B, L, D)
    out = _project_out(p, h, cfg, x.dtype)
    new_state = None
    if state is not None:
        new_state = (C_last.to(state[0].dtype), n_last.to(state[1].dtype))
    return out, new_state


def mlstm_decode_step(p: MLSTM, x: torch.Tensor, cfg, state: State,
                      ctx: Optional[ExecutionContext] = None
                      ) -> Tuple[torch.Tensor, State]:
    """One token a row (x: (B, 1, D)): one step of the recurrence."""
    del ctx  # see mlstm_block
    B = x.shape[0]
    q, k, v, logi, logf = _mlstm_gates(p, x, cfg)  # L = 1
    C_prev, n_prev = (s.float() for s in state)
    f = torch.exp(logf[:, 0])  # (B, H)
    i = torch.exp(logi[:, 0])
    C_new = (f[:, :, None, None] * C_prev + i[:, :, None, None]
             * torch.einsum("bhd,bhe->bhde", k[:, 0], v[:, 0]))
    n_new = f[:, :, None] * n_prev + i[:, :, None] * k[:, 0]
    num = torch.einsum("bhd,bhde->bhe", q[:, 0], C_new)
    den = torch.einsum("bhd,bhd->bh", q[:, 0], n_new)[..., None]
    h = (num / torch.clamp(torch.abs(den), min=1.0)).reshape(B, 1,
                                                             cfg.d_model)
    out = _project_out(p, h, cfg, x.dtype)
    return out, (C_new.to(state[0].dtype), n_new.to(state[1].dtype))


def init_mlstm_state(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> State:
    H = cfg.n_heads
    hd = cfg.d_model // H
    return (torch.zeros((batch, H, hd, hd), dtype=dtype, device=device),
            torch.zeros((batch, H, hd), dtype=dtype, device=device))


def mlstm_block_ref(p: MLSTM, x: torch.Tensor, cfg) -> torch.Tensor:
    """Sequential oracle: the literal recurrence, one position a step."""
    B, L, D = x.shape
    H = cfg.n_heads
    hd = D // H
    q, k, v, logi, logf = _mlstm_gates(p, x, cfg)
    C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(L):
        f = torch.exp(logf[:, t])
        i = torch.exp(logi[:, t])
        C = f[:, :, None, None] * C + i[:, :, None, None] * torch.einsum(
            "bhd,bhe->bhde", k[:, t], v[:, t])
        n = f[:, :, None] * n + i[:, :, None] * k[:, t]
        num = torch.einsum("bhd,bhde->bhe", q[:, t], C)
        den = torch.einsum("bhd,bhd->bh", q[:, t], n)[..., None]
        hs.append(num / torch.clamp(torch.abs(den), min=1.0))
    h = torch.stack(hs, dim=1).reshape(B, L, D)
    return _project_out(p, h, cfg, x.dtype)


# ---------------------------------------------------------------------------
# sLSTM (prefix-scan form)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    """The parameters of ``repro.models.xlstm.init_slstm``: ``w_zifo`` (D,
    4D: z, i, f, o pre-activations), ``b_zifo`` (4D,), ``wo`` (D, D)."""

    def __init__(self, cfg, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D = cfg.d_model
        dtype = dtype_of(cfg.param_dtype)
        std = D ** -0.5
        self.w_zifo = _param((D, 4 * D), std, dtype, device, generator)
        self.b_zifo = nn.Parameter(torch.zeros(4 * D, dtype=dtype,
                                               device=device))
        self.wo = _param((D, D), std, dtype, device, generator)


def _slstm_gates(p: SLSTM, x: torch.Tensor, cfg):
    """tanh(z), sigmoid(i), sigmoid(f), sigmoid(o), each (B, L, D) f32."""
    cd = dtype_of(cfg.compute_dtype)
    pre = (x.to(cd) @ p.w_zifo.to(cd)).float() + p.b_zifo.float()
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    return torch.tanh(z), torch.sigmoid(i), torch.sigmoid(f), \
        torch.sigmoid(o)


def _prefix_scan(f: torch.Tensor, c: torch.Tensor, n: torch.Tensor):
    """Inclusive scan along axis 1 of the reference's ``combine``
    ((fa, ca, na), (fb, cb, nb)) -> (fa fb, fb ca + cb, fb na + nb), a
    before b: Hillis-Steele doubling, after the step at distance d each
    position holds the combination of the 2d positions ending at it."""
    d = 1
    while d < f.shape[1]:
        fa, fb = f[:, :-d], f[:, d:]
        c = torch.cat([c[:, :d], fb * c[:, :-d] + c[:, d:]], dim=1)
        n = torch.cat([n[:, :d], fb * n[:, :-d] + n[:, d:]], dim=1)
        f = torch.cat([f[:, :d], fa * fb], dim=1)
        d *= 2
    return c, n


def slstm_block(
    p: SLSTM,
    x: torch.Tensor,
    cfg,
    state: Optional[State] = None,  # c (B, D), n (B, D)
    ctx: Optional[ExecutionContext] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Full-sequence (prefill) sLSTM block. A ``state`` enters as a virtual
    step -1 holding (1, c0, n0), as in the reference; the new state is the
    scan's last position."""
    del ctx  # the prefix-scan form has no dispatched kernel
    z, i, f, o = _slstm_gates(p, x, cfg)
    fs, cs, ns = f, i * z, i
    if state is not None:
        c0, n0 = (s.float() for s in state)
        fs = torch.cat([torch.ones_like(c0)[:, None], fs], dim=1)
        cs = torch.cat([c0[:, None], cs], dim=1)
        ns = torch.cat([n0[:, None], ns], dim=1)
    cs, ns = _prefix_scan(fs, cs, ns)
    if state is not None:
        cs, ns = cs[:, 1:], ns[:, 1:]
    h = o * cs / torch.clamp(torch.abs(ns), min=1.0)
    out = _project_out(p, h, cfg, x.dtype)
    new_state = None
    if state is not None:
        new_state = (cs[:, -1].to(state[0].dtype),
                     ns[:, -1].to(state[1].dtype))
    return out, new_state


def slstm_decode_step(p: SLSTM, x: torch.Tensor, cfg, state: State,
                      ctx: Optional[ExecutionContext] = None
                      ) -> Tuple[torch.Tensor, State]:
    """One token a row (x: (B, 1, D)): one step of the recurrence."""
    del ctx  # see slstm_block
    z, i, f, o = _slstm_gates(p, x, cfg)  # (B, 1, D)
    c_prev, n_prev = (s.float() for s in state)
    c = f[:, 0] * c_prev + i[:, 0] * z[:, 0]
    n = f[:, 0] * n_prev + i[:, 0]
    h = (o[:, 0] * c / torch.clamp(torch.abs(n), min=1.0))[:, None]
    out = _project_out(p, h, cfg, x.dtype)
    return out, (c.to(state[0].dtype), n.to(state[1].dtype))


def init_slstm_state(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> State:
    return (torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))
