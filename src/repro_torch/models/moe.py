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

On a device mesh (``x`` a DTensor; ``moe_block``'s docstring) the routing
runs on each device's groups, the experts on the devices holding their
weights, and ``cfg.moe_shard_hints`` pins the reference's dispatch layout
with all-to-alls. ``record_routing`` and ``count_drops`` then see each
device's own groups.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.dtensors import (as_dtensor, is_dtensor, reshard,
                                  sharding_dims, stacked_placements,
                                  sum_partials)
from repro_torch.ops import ExecutionContext

from . import spmd
from .layers import _param, dtype_of
from .sharding import P


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


# the reference's dispatch layout under ``moe_shard_hints``: the groups of
# the routing, combine and dispatch over (data, model); ein and eout with
# the experts on model and the groups on data
_TOKENS = P(("data", "model"), None, None)
_GROUPS = P(("data", "model"), None, None, None)
_EXPERTS = P("model", "data", None, None)


def _route(xg: torch.Tensor, router: torch.Tensor, cfg, C: int,
           choices: Optional[torch.Tensor] = None):
    """Route the groups of ``xg`` (G, Tg, D): returns the combine tensor
    (G, Tg, E, C) in the compute dtype, the dispatch mask (its nonzero
    pattern) and each group's load-balancing term (G,). Per group only,
    so on a mesh it runs on each device's groups (``local_map``)."""
    G, Tg, _ = xg.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    cd = dtype_of(cfg.compute_dtype)
    logits = torch.einsum("gtd,de->gte", xg.float(), router.float())
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
    if _RECORDERS and xg.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("record_routing records eager calls only")
    for log in _RECORDERS:
        log.append(Routing(probs, gate_idx, kept, C))
    for counts in _DROP_COUNTERS:
        counts[0].add_(kept.numel() - kept.sum().double())
        counts[1].add_(kept.numel())
    combine = torch.einsum("gtk,gtke,gtkc->gtec", gate_vals * kept, onehot,
                           pos_oh).to(cd)
    dispatch = (combine != 0).to(cd)
    # load-balancing term of each group (Switch/GShard)
    frac_tokens = onehot[:, :, 0, :].mean(1)  # top-1 assignment share
    frac_probs = probs.mean(1)
    return combine, dispatch, (frac_tokens * frac_probs).sum(-1)


def _routed(xg, router, cfg, C: int, choices=None):
    """:func:`_route`; on a mesh, on each device's groups (``local_map``):
    ``xg``'s group dim keeps its sharding where it splits evenly, its
    tokens and features whole on each device; the outputs are sharded as
    the groups, and the router's gradient is a Partial sum over the mesh
    dims sharding them (each device's groups add theirs)."""
    if not is_dtensor(xg):
        return _route(xg, router, cfg, C, choices)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = xg.device_mesh
    gdims = sharding_dims(xg, 0)
    while gdims and xg.shape[0] % math.prod(mesh.size(i) for i in gdims):
        gdims = gdims[:-1]  # local_map's outputs need equal chunks
    g_pl = tuple(Shard(0) if i in gdims else Replicate()
                 for i in range(mesh.ndim))
    r_grad = tuple(Partial() if i in gdims else Replicate()
                   for i in range(mesh.ndim))
    args, in_pl = [xg, router], [g_pl, (Replicate(),) * mesh.ndim]
    grad_pl = [g_pl, r_grad]
    if choices is not None:  # each device's groups' choices (no wire)
        args.append(as_dtensor(choices.reshape(xg.shape[0], xg.shape[1], -1),
                               mesh, g_pl))
        in_pl.append(g_pl)
        grad_pl.append(g_pl)

    def route(xg_, router_, *choices_):
        return _route(xg_, router_, cfg, C, *choices_)

    return local_map(route, out_placements=(g_pl, g_pl, g_pl),
                     in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _dispatched(dispatch, xg):
    """``ein[e,g,c,d] = sum_t dispatch[g,t,e,c] xg[g,t,d]``; on a mesh, on
    each device's groups (``local_map``: G keeps ``dispatch``'s sharding;
    DTensor's own einsum views a sharded group dim of one token, as a
    decode step's, which its sharding propagation refuses)."""
    if not is_dtensor(dispatch):
        return torch.einsum("gtec,gtd->egcd", dispatch, xg)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = dispatch.device_mesh
    gdims = sharding_dims(dispatch, 0)
    g_pl = tuple(Shard(0) if i in gdims else Replicate()
                 for i in range(mesh.ndim))
    e_pl = tuple(Shard(1) if i in gdims else Replicate()
                 for i in range(mesh.ndim))
    return local_map(lambda a, b: torch.einsum("gtec,gtd->egcd", a, b),
                     out_placements=(e_pl,), in_placements=(g_pl, g_pl),
                     device_mesh=mesh, redistribute_inputs=True)(dispatch,
                                                                 xg)


def _on_experts(ein, w):
    """On a mesh, ``ein`` with E sharded where the experts' weights ``w``
    shard it and ``ein`` is whole: each device keeps its experts' rows
    (``dtensors.chunk``: no wire, the gradient all-reduced where DTensor's
    own chunk would gather it), and the expert einsums run locally."""
    if not is_dtensor(ein):
        return ein
    from torch.distributed.tensor import Replicate, Shard

    pl = list(ein.placements)
    for i in sharding_dims(w, 0):
        if pl[i] == Replicate():
            pl[i] = Shard(0)
    return reshard(ein, tuple(pl))


def _combined(combine, eout):
    """``out[g,t,d] = sum_ec combine[g,t,e,c] eout[e,g,c,d]``. On a mesh
    each device contracts its local chunks (``local_map``), and ``out``
    comes back with G sharded as in ``eout`` and the rest whole. Where
    ``combine`` shards G on a mesh dim that shards ``eout``'s E (the
    hints' layout), the smaller of the two moves there by one all-to-all
    (``dtensors.reshard``): ``combine`` (T_g E C a group) to E, each
    device then summing its experts' outputs (partial sums stacked on a
    new dim, added by one all-reduce); or ``eout`` (E C D a group) to G,
    the combined groups then made whole by one all-reduce of zero-padded
    chunks (``dtensors.gather``). (DTensor's own einsum flattens E with C
    into a strided shard, whose sharding propagation fails on fake
    tensors, and gathers ``eout`` on a real group.)"""
    if not is_dtensor(eout):
        return torch.einsum("gtec,egcd->gtd", combine, eout)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = eout.device_mesh
    edims, gdims = sharding_dims(eout, 0), sharding_dims(eout, 1)
    g_pl = tuple(Shard(0) if i in gdims else Replicate()
                 for i in range(mesh.ndim))
    moved = set(edims) & set(sharding_dims(combine, 0))
    per_group = combine.shape[1] * combine.shape[2] * combine.shape[3]
    if moved and per_group > eout.shape[0] * eout.shape[2] * eout.shape[3]:
        # eout to combine's groups; each device combines whole groups
        c_pl = tuple(Shard(0) if i in moved or i in gdims else Replicate()
                     for i in range(mesh.ndim))
        e_pl = tuple(Shard(1) if isinstance(p, Shard) else p for p in c_pl)
        out = local_map(lambda c, e: torch.einsum("gtec,egcd->gtd", c, e),
                        out_placements=(c_pl,), in_placements=(c_pl, e_pl),
                        device_mesh=mesh, redistribute_inputs=True)(
            reshard(combine, c_pl), reshard(eout, e_pl))
        return reshard(out, g_pl)
    e_pl = tuple(Shard(0) if i in edims else Shard(1) if i in gdims
                 else Replicate() for i in range(mesh.ndim))
    c_pl = tuple(Shard(2) if i in edims else Shard(0) if i in gdims
                 else Replicate() for i in range(mesh.ndim))
    parts = local_map(
        lambda c, e: torch.einsum("gtec,egcd->gtd", c, e)[None],
        out_placements=(stacked_placements(g_pl, edims),),
        in_placements=(c_pl, e_pl), device_mesh=mesh,
        redistribute_inputs=True)(reshard(combine, c_pl),
                                  reshard(eout, e_pl))
    return sum_partials(parts, mesh, g_pl)


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
    moves) does not count as a difference of the rest.

    On a mesh (``x`` a DTensor) the routing, the dispatch and the combine
    run on each device's local chunks (:func:`_routed`,
    :func:`_dispatched`, :func:`_combined`) and the expert einsums are
    DTensor ops on the devices holding the experts (sharded on ``model``
    by their parameters). ``cfg.moe_shard_hints`` pins the reference's
    dispatch layout (``spmd.reshard``): the groups of the routing,
    ``combine`` and ``dispatch`` over (``data``, ``model``), ``ein`` and
    ``eout`` with E on ``model`` and G on ``data``: the G <-> E reshard an
    all-to-all each way. On a plain tensor the hints change nothing, as
    ``with_sharding_constraint`` changes no value."""
    del ctx
    B, L, D = x.shape
    E = cfg.n_experts
    cd = dtype_of(cfg.compute_dtype)
    T = B * L
    G = n_groups if T % n_groups == 0 else 1
    Tg = T // G
    C = capacity(cfg, Tg)
    hints = cfg.moe_shard_hints
    # on a mesh, groups that cut across or join rows need each row whole
    # (DTensor cannot regroup a sharded sequence; a prefill's groups)
    xs = spmd.gather_rows(x) if Tg != L else x
    # on a mesh with the hints, the groups over every device
    xg = spmd.reshard(xs.reshape(G, Tg, D), _TOKENS if hints else None)
    combine, dispatch, per_group = _routed(xg, p.router, cfg, C, choices)
    combine = spmd.reshard(combine, _GROUPS if hints else None)
    dispatch = spmd.reshard(dispatch, _GROUPS if hints else None)

    # dispatch -> (E, G, C, D), experts sharded on `model` on a mesh
    ein = _dispatched(dispatch, xg.to(cd))
    ein = (spmd.reshard(ein, _EXPERTS) if hints
           else _on_experts(ein, p.w_gate))
    hg = torch.einsum("egcd,edf->egcf", ein, p.w_gate.to(cd))
    hu = torch.einsum("egcd,edf->egcf", ein, p.w_up.to(cd))
    h = torch.nn.functional.silu(hg.float()).to(cd) * hu
    eout = torch.einsum("egcf,efd->egcd", h, p.w_down.to(cd))
    eout = spmd.reshard(eout, _EXPERTS if hints else None)
    out = _combined(combine, eout)
    out = spmd.like(out.reshape(B, L, D).to(x.dtype), x)

    # load-balancing auxiliary loss (Switch/GShard): E x the groups' mean
    aux = E * (spmd.mean(per_group) if is_dtensor(per_group)
               else per_group.mean())
    return out, spmd.replicated(aux.float())


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
