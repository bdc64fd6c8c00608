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

On a device mesh (``x``, the leaves and the state DTensors placed by
``models.sharding``) the same functions run, as the mamba block does
(``models.ssm``):

* mLSTM: the sequence made whole (``spmd.gather_rows``); the
  column-parallel q/k/v products viewed as heads through
  ``spmd.split_heads`` (gathered where the heads do not divide the model
  axis: xLSTM-1.3B's 4 heads on a ``model`` of 16 run whole on every
  device there); the replicated ``w_if``'s gates, whole on every device,
  chunked to each device's heads (``dtensors.reshard``: no wire); the
  chunk loop or the decode step on each device's heads (``local_map``,
  :func:`_on_units`; ``F.logsigmoid`` has no DTensor rule and runs
  there); C and n on the heads inside and in the cache's placements
  outside (an all-to-all each way); the row-parallel ``wo``'s Partial
  product reduced to ``x``'s placements (``spmd.like``).
* sLSTM: the column-parallel ``w_zifo``/``b_zifo`` pre-activations cut
  into z/i/f/o each on ``model`` by one all-to-all (``spmd.split_columns``:
  a device's columns hold pieces of all four blocks), the prefix scan or
  the decode step on each device's channels over the whole sequence
  (:func:`_on_units`), (c, n) on ``model``, ``wo`` as mLSTM's.

On plain tensors each of these hooks is a no-op.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.dtensors import is_dtensor, reshard, sharding_dims
from repro_torch.ops import ExecutionContext

from . import spmd
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


def _mlstm_project(p: MLSTM, x: torch.Tensor, cfg):
    """q, k, v (B, L, D) in the compute dtype and the input and forget gate
    pre-activations (B, L, H) in f32. On a mesh: the sequence whole, q/k/v
    columns on ``model`` (gathered where the heads do not divide it), the
    gates whole on every device (``w_if`` is replicated)."""
    cd = dtype_of(cfg.compute_dtype)
    H = cfg.n_heads
    xc = spmd.gather_rows(x.to(cd))
    q, k, v = (spmd.split_heads(xc @ w.to(cd), H)
               for w in (p.wq, p.wk, p.wv))
    gates = (xc @ p.w_if.to(cd)).float() + p.b_if.float()
    return q, k, v, gates[..., :H], gates[..., H:]


def _mlstm_heads(q, k, v, ig, fg, hd: int):
    """The head view of :func:`_mlstm_project`'s outputs over the heads
    they hold: q (scaled by hd^-1/2), k, v (B, L, h, hd) and log i, log f
    (B, L, h), all f32."""
    B, L = q.shape[:2]
    h = q.shape[-1] // hd
    q, k, v = (a.reshape(B, L, h, hd).float() for a in (q, k, v))
    logi = torch.clamp(ig, -_EXP_CLAMP, _EXP_CLAMP)  # log of exp input gate
    logf = F.logsigmoid(fg)  # forget in (0, 1)
    return q * hd ** -0.5, k, v, logi, logf


def _mlstm_gates(p: MLSTM, x: torch.Tensor, cfg):
    """q (scaled by hd^-1/2), k, v (B, L, H, hd) and log i, log f (B, L, H),
    all f32 (one device)."""
    return _mlstm_heads(*_mlstm_project(p, x, cfg), cfg.d_model // cfg.n_heads)


def _project_out(p, h: torch.Tensor, cfg, x: torch.Tensor) -> torch.Tensor:
    """The out-projection in ``x``'s dtype; on a mesh its Partial product
    (``wo`` is row-parallel) reduced to ``x``'s placements."""
    cd = dtype_of(cfg.compute_dtype)
    return spmd.like((h.to(cd) @ p.wo.to(cd)).to(x.dtype), x)


def _on_units(fn, rows, state, **kw):
    """``fn(*rows, *state, **kw)`` -> (out, *new state): the recurrence on
    ``rows`` (B, L, n), whose last dim holds the units (mLSTM's heads,
    sLSTM's channels), from ``state`` (each (B, units, ...)) or from zeros
    (``state`` None). On a mesh, on each device's units (``local_map``):
    every row tensor and the state brought to ``rows[0]``'s batch and unit
    placements by ``dtensors.reshard`` (a replicated one chunked, no wire;
    the state's units moved to dim 1 by an all-to-all), the output in
    those placements, the new state in ``state``'s (batch and units as
    ``rows[0]``'s where ``state`` is None)."""
    if not is_dtensor(rows[0]):
        return fn(*rows, *(state or (None, None)), **kw)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = rows[0].device_mesh
    udims, bdims = sharding_dims(rows[0], 2), sharding_dims(rows[0], 0)

    def pl(unit_dim):
        return tuple(Shard(unit_dim) if i in udims else Shard(0)
                     if i in bdims else Replicate() for i in range(mesh.ndim))

    args = [reshard(t, pl(2)) for t in rows]
    if state is not None:
        args += [reshard(t, pl(1)) for t in state]

    def local(*a):
        n = len(rows)
        return fn(*a[:n], *(a[n:] or (None, None)), **kw)

    out, *new = local_map(
        local, out_placements=(pl(2), pl(1), pl(1)),
        in_placements=tuple(t.placements for t in args), device_mesh=mesh,
        redistribute_inputs=True)(*args)
    if state is not None:
        new = [reshard(t, s.placements) for t, s in zip(new, state)]
    return (out, *new)


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


def _mlstm_scan(q, k, v, ig, fg, C0, n0, hd: int, c: int):
    """The chunkwise-dual prefill over the heads of q (B, L, h hd): returns
    the output (B, L, h hd) and C, n at L, in f32. The sequence is padded
    to whole chunks with zeros in q, k, v, log i and log f: a padded step
    has f = i = 1 and k = v = 0, so the state at the last chunk's end is
    the state at L. ``C0``/``n0`` None: zeros."""
    q, k, v, logi, logf = _mlstm_heads(q, k, v, ig, fg, hd)
    B, L, H, _ = q.shape
    c = min(c, L)
    pad = -L % c
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi, logf = (F.pad(a, (0, 0, 0, pad)) for a in (logi, logf))
    nc = q.shape[1] // c

    def to_chunks(a):
        return a.reshape(B, nc, c, *a.shape[2:]).transpose(0, 1)

    if C0 is None:
        C0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=q.device)
        n0 = torch.zeros((B, H, hd), dtype=torch.float32, device=q.device)
    (C_last, n_last), hs = scan(
        _mlstm_chunk, (C0.float(), n0.float()),
        tuple(map(to_chunks, (q, k, v, logi, logf))))
    h = hs.transpose(0, 1).reshape(B, nc * c, H, hd)[:, :L]
    return h.reshape(B, L, H * hd), C_last, n_last


def _mlstm_step(q, k, v, ig, fg, C_prev, n_prev, hd: int):
    """One step of the recurrence over the heads of q (B, 1, h hd): the
    output (B, 1, h hd) and the new C, n, in f32."""
    q, k, v, logi, logf = _mlstm_heads(q, k, v, ig, fg, hd)
    B, _, H, _ = q.shape
    C_prev, n_prev = C_prev.float(), n_prev.float()
    f = torch.exp(logf[:, 0])  # (B, H)
    i = torch.exp(logi[:, 0])
    C_new = (f[:, :, None, None] * C_prev + i[:, :, None, None]
             * torch.einsum("bhd,bhe->bhde", k[:, 0], v[:, 0]))
    n_new = f[:, :, None] * n_prev + i[:, :, None] * k[:, 0]
    num = torch.einsum("bhd,bhde->bhe", q[:, 0], C_new)
    den = torch.einsum("bhd,bhd->bh", q[:, 0], n_new)[..., None]
    h = (num / torch.clamp(torch.abs(den), min=1.0)).reshape(B, 1, H * hd)
    return h, C_new, n_new


def mlstm_block(
    p: MLSTM,
    x: torch.Tensor,  # (B, L, D)
    cfg,
    state: Optional[State] = None,  # C (B, H, hd, hd), n (B, H, hd)
    ctx: Optional[ExecutionContext] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Full-sequence (prefill) mLSTM block in the chunkwise-dual form
    (:func:`_mlstm_scan`). With a ``state``, the scan starts from it and
    the new state is returned. On a mesh, on each device's heads (module
    docstring)."""
    del ctx  # no dispatched kernel in the chunkwise-dual form
    hd = cfg.d_model // cfg.n_heads
    h, C_last, n_last = _on_units(_mlstm_scan, _mlstm_project(p, x, cfg),
                                  state, hd=hd, c=cfg.chunk_size)
    out = _project_out(p, h, cfg, x)
    new_state = None
    if state is not None:
        new_state = (C_last.to(state[0].dtype), n_last.to(state[1].dtype))
    return out, new_state


def mlstm_decode_step(p: MLSTM, x: torch.Tensor, cfg, state: State,
                      ctx: Optional[ExecutionContext] = None
                      ) -> Tuple[torch.Tensor, State]:
    """One token a row (x: (B, 1, D)): one step of the recurrence (on a
    mesh, on each device's heads)."""
    del ctx  # see mlstm_block
    h, C_new, n_new = _on_units(_mlstm_step, _mlstm_project(p, x, cfg),
                                state, hd=cfg.d_model // cfg.n_heads)
    out = _project_out(p, h, cfg, x)
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
    return _project_out(p, h, cfg, x)


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
    """tanh(z), sigmoid(i), sigmoid(f), sigmoid(o), each (B, L, D) f32. On
    a mesh: the sequence whole, each of the four on ``model`` (module
    docstring)."""
    cd = dtype_of(cfg.compute_dtype)
    xc = spmd.gather_rows(x.to(cd))
    pre = (xc @ p.w_zifo.to(cd)).float() + p.b_zifo.float()
    z, i, f, o = spmd.split_columns(pre, 4)
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


def _slstm_scan(z, i, f, o, c0, n0):
    """The prefix-scan prefill over the channels of z (B, L, d): the output
    h (B, L, d) and c, n at L. A start state enters as a virtual step -1
    holding (1, c0, n0), as in the reference; ``c0``/``n0`` None: none."""
    fs, cs, ns = f, i * z, i
    if c0 is not None:
        c0, n0 = c0.float(), n0.float()
        fs = torch.cat([torch.ones_like(c0)[:, None], fs], dim=1)
        cs = torch.cat([c0[:, None], cs], dim=1)
        ns = torch.cat([n0[:, None], ns], dim=1)
    cs, ns = _prefix_scan(fs, cs, ns)
    if c0 is not None:
        cs, ns = cs[:, 1:], ns[:, 1:]
    h = o * cs / torch.clamp(torch.abs(ns), min=1.0)
    return h, cs[:, -1], ns[:, -1]


def _slstm_step(z, i, f, o, c_prev, n_prev):
    """One step of the recurrence over the channels of z (B, 1, d)."""
    c = f[:, 0] * c_prev.float() + i[:, 0] * z[:, 0]
    n = f[:, 0] * n_prev.float() + i[:, 0]
    h = (o[:, 0] * c / torch.clamp(torch.abs(n), min=1.0))[:, None]
    return h, c, n


def slstm_block(
    p: SLSTM,
    x: torch.Tensor,
    cfg,
    state: Optional[State] = None,  # c (B, D), n (B, D)
    ctx: Optional[ExecutionContext] = None,
) -> Tuple[torch.Tensor, Optional[State]]:
    """Full-sequence (prefill) sLSTM block (:func:`_slstm_scan`); the new
    state is the scan's last position. On a mesh, on each device's
    channels (module docstring)."""
    del ctx  # the prefix-scan form has no dispatched kernel
    h, c, n = _on_units(_slstm_scan, _slstm_gates(p, x, cfg), state)
    out = _project_out(p, h, cfg, x)
    new_state = None
    if state is not None:
        new_state = (c.to(state[0].dtype), n.to(state[1].dtype))
    return out, new_state


def slstm_decode_step(p: SLSTM, x: torch.Tensor, cfg, state: State,
                      ctx: Optional[ExecutionContext] = None
                      ) -> Tuple[torch.Tensor, State]:
    """One token a row (x: (B, 1, D)): one step of the recurrence (on a
    mesh, on each device's channels)."""
    del ctx  # see slstm_block
    h, c, n = _on_units(_slstm_step, _slstm_gates(p, x, cfg), state)
    out = _project_out(p, h, cfg, x)
    return out, (c.to(state[0].dtype), n.to(state[1].dtype))


def init_slstm_state(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> State:
    return (torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
            torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))
