"""Top-k routed mixture-of-experts (GShard-style grouped dispatch): the
counterpart of ``repro.models.moe``.

Tokens are reshaped into G groups, routed top-k with a capacity limit per
group, and dispatched to experts with one-hot combine einsums, as in the
reference. Router math is f32; the combine tensor is built in f32 and cast
to the compute dtype, and the dispatch mask is its nonzero pattern after
that cast. The expert products are aten einsums (batched GEMMs over the
expert axis), as the reference leaves them to XLA: no kernel of the
reference's sits on this path.

Capacity per group: C = ceil(k * T_g / E * capacity_factor) rounded up to a
multiple of 4, at least 4; overflow tokens fall through the residual. C
depends on every token of the group, dead or padded rows included, exactly
as in the reference.

Where torch and JAX differ, the port keeps JAX's semantics:

* ``jax.lax.top_k`` puts the lower index first among equal values and
  ``torch.topk`` promises no order, so :func:`top_k` takes the first k of a
  stable descending sort;
* ``jax.nn.one_hot`` gives an all-zero row for an index past the last class
  (how a token over capacity vanishes) where ``F.one_hot`` raises (a device
  assert inside a CUDA graph), so the one-hots compare with ``arange``.

Every shape is fixed by the input's: the block reads nothing back to the
host, so a decode step holding it can be captured as a CUDA graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.ops import ExecutionContext

from .layers import _param, dtype_of


class MoE(nn.Module):
    """``router`` (D, E) in f32, ``w_gate``/``w_up`` (E, D, F) and
    ``w_down`` (E, F, D) in ``cfg.param_dtype``: the reference's leaves."""

    def __init__(self, cfg, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        dtype = dtype_of(cfg.param_dtype)
        std = D ** -0.5
        self.router = _param((D, E), std, torch.float32, device, generator)
        self.w_gate = _param((E, D, F), std, dtype, device, generator)
        self.w_up = _param((E, D, F), std, dtype, device, generator)
        self.w_down = _param((E, F, D), F ** -0.5, dtype, device, generator)


def capacity(cfg, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.experts_per_token * cfg.capacity_factor
            / max(cfg.n_experts, 1))
    return max(4, -(-c // 4) * 4)  # multiple of 4, at least 4


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, largest
    first and the lower index first among equals (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives an all-zero row (``jax.nn.one_hot``)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


@dataclasses.dataclass
class Routing:
    """One ``moe_block`` call's routing, per group: ``probs`` (G, Tg, E) the
    router's softmax, ``gate_idx`` (G, Tg, K) the chosen experts, ``kept``
    (G, Tg, K) 1 where the choice fit its expert's capacity, ``capacity``
    C."""

    probs: torch.Tensor
    gate_idx: torch.Tensor
    kept: torch.Tensor
    capacity: int


_RECORDERS: List[List[Routing]] = []
_DROP_COUNTERS: List[torch.Tensor] = []


@contextlib.contextmanager
def record_routing() -> Iterator[List[Routing]]:
    """Collect the :class:`Routing` of every ``moe_block`` call made inside,
    in call order (a forward: one per MoE layer). Eager calls only: a CUDA
    graph's capture would record tensors that its replays overwrite."""
    log: List[Routing] = []
    _RECORDERS.append(log)
    try:
        yield log
    finally:
        _RECORDERS.remove(log)


@contextlib.contextmanager
def count_drops(device) -> Iterator[torch.Tensor]:
    """A float64 tensor ``[dropped, routed]`` on ``device``: the (token, k)
    choices over capacity and all (token, k) choices of every
    ``moe_block`` call made inside. The sums are added on the device, so a
    decode step captured inside adds to them at each of its replays (keep
    the tensor while such a graph lives); reading them is the caller's."""
    counts = torch.zeros(2, dtype=torch.float64, device=device)
    _DROP_COUNTERS.append(counts)
    try:
        yield counts
    finally:
        _DROP_COUNTERS.remove(counts)


def moe_block(
    p: MoE,
    x: torch.Tensor,  # (B, L, D)
    cfg,
    n_groups: int = 1,
    ctx: Optional[ExecutionContext] = None,
    choices: Optional[torch.Tensor] = None,  # (G, Tg, K) expert indices
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, aux_loss). aux_loss is the load-balancing loss.

    ``ctx`` is accepted for uniformity with the other blocks: the grouped
    expert einsums have no dispatched kernel entry, in either package.

    ``choices`` (not in the reference; default None, the reference's
    routing) routes each token to the given experts instead of its top k,
    with the router's probabilities there as gates: a check that compares
    two runs of the model routes the second as the first did, so that a
    near-tie the two runs break differently (and the capacity drops it
    moves) does not count as a difference of the rest."""
    del ctx
    if cfg.moe_shard_hints:
        raise NotImplementedError(
            "moe_shard_hints pins the dispatch layout to the mesh axes "
            "'data'/'model'; the MoE block has not run on a DTensor mesh "
            "yet (ROADMAP queue 1, item 13's leftovers)")
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    cd = dtype_of(cfg.compute_dtype)
    T = B * L
    G = n_groups if T % n_groups == 0 else 1
    Tg = T // G
    C = capacity(cfg, Tg)
    xg = x.reshape(G, Tg, D)

    logits = torch.einsum("gtd,de->gte", xg.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)  # (G, Tg, E)
    if choices is None:
        gate_vals, gate_idx = top_k(probs, K)  # (G, Tg, K)
    else:
        gate_idx = choices.to(device=probs.device, dtype=torch.long).reshape(
            G, Tg, K)
        gate_vals = probs.gather(-1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # position of each (token, k) slot within its expert's capacity buffer;
    # k=0 assignments get priority over k=1 (GShard ordering)
    onehot = _one_hot(gate_idx, E)  # (G, Tg, K, E)
    kt = onehot.transpose(1, 2).reshape(G, K * Tg, E)  # k-major
    pos_kt = torch.cumsum(kt, dim=1) - kt  # 0-based position per expert
    pos = pos_kt.reshape(G, K, Tg, E).transpose(1, 2)  # (G, Tg, K, E)
    within_cap = (pos < C).float() * onehot

    # combine[g,t,e,c] = sum_k gate_k * onehot_e * onehot_c
    pos_idx = (pos * onehot).sum(-1)  # (G, Tg, K) position scalar
    pos_oh = _one_hot(pos_idx.long(), C)  # (G, Tg, K, C)
    kept = within_cap.sum(-1)  # (G, Tg, K) in {0, 1}
    if _RECORDERS and x.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("record_routing records eager calls only")
    for log in _RECORDERS:
        log.append(Routing(probs, gate_idx, kept, C))
    for counts in _DROP_COUNTERS:
        counts[0].add_(kept.numel() - kept.sum().double())
        counts[1].add_(kept.numel())
    combine = torch.einsum("gtk,gtke,gtkc->gtec", gate_vals * kept, onehot,
                           pos_oh).to(cd)
    dispatch = (combine != 0).to(cd)

    # dispatch -> (E, G, C, D)
    ein = torch.einsum("gtec,gtd->egcd", dispatch, xg.to(cd))
    hg = torch.einsum("egcd,edf->egcf", ein, p.w_gate.to(cd))
    hu = torch.einsum("egcd,edf->egcf", ein, p.w_up.to(cd))
    h = torch.nn.functional.silu(hg.float()).to(cd) * hu
    eout = torch.einsum("egcf,efd->egcd", h, p.w_down.to(cd))
    out = torch.einsum("gtec,egcd->gtd", combine, eout)

    # load-balancing auxiliary loss (Switch/GShard)
    frac_tokens = onehot[:, :, 0, :].mean(1)  # top-1 assignment share
    frac_probs = probs.mean(1)
    aux = E * (frac_tokens * frac_probs).sum(-1).mean()
    return out.reshape(B, L, D).to(x.dtype), aux.float()


def moe_block_dense_ref(p: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """Oracle: evaluate every expert on every token, combine by top-k gates
    (no capacity drops) — matches moe_block when capacity_factor is
    large."""
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = torch.einsum("bld,de->ble", x.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    gates = torch.zeros_like(probs)
    for k in range(K):
        gates = gates + gate_vals[..., k:k + 1] * _one_hot(gate_idx[..., k],
                                                           E)
    xf = x.float()
    hg = torch.einsum("bld,edf->blef", xf, p.w_gate.float())
    hu = torch.einsum("bld,edf->blef", xf, p.w_up.float())
    h = torch.nn.functional.silu(hg) * hu
    eout = torch.einsum("blef,efd->bled", h, p.w_down.float())
    return torch.einsum("ble,bled->bld", gates, eout).to(x.dtype)
