"""What the ops, the cost counter and the trainer need of a device mesh,
independent of any model: DTensor (``torch.distributed.tensor``) helpers
below ``ops`` and ``analysis`` (the model's own layout hooks are
``models.spmd``).

* :func:`is_dtensor` / :func:`is_dtensor_type`, and :func:`tensors`, the
  tensor leaves of a tree.
* :func:`relayout`: a redistribution whose backward brings the gradient to
  the input's layout (a Partial one replicated).
* :func:`reshard`: a layout reached by moves gloo runs on card tensors,
  each an autograd function: :func:`all_to_all` moves a mesh dim's
  sharding to another tensor dim (one all-to-all each way; DTensor's own
  shard-to-shard move all-gathers on a CPU mesh), :func:`chunk` shards a
  replicated dim in place (its gradient summed by an all-reduce where
  DTensor's would all-gather it), :func:`gather` makes a sharded dim
  whole as a sum of zero-padded chunks (one all-reduce); each on dims
  that split evenly. :func:`whole` gathers every sharded dim so (a
  checkpoint's leaves).
* :func:`move` / :func:`make_whole`: a layout move (sharded dims made
  whole) by DTensor's all-gather or, on a gloo group with card tensors
  (gloo's all-gather of CUDA tensors does not return) and inside
  :func:`all_reduce_gathers` (a dry run counting such a group's step), by
  :func:`reshard`'s all-reduce of zero-padded chunks.
* :func:`split_columns`: a column-parallel projection's output cut into
  equal column blocks each sharded as the whole was (the mamba block's x/z
  split): one all-to-all with uneven splits, where slicing would gather.
* :func:`local_channels`: a depthwise op (the mamba block's short conv)
  on each device's channels through ``local_map``, the filter's gradient
  a Partial sum over the rows' mesh dims.
* :func:`local_attention`: the attention kernel sees raw pointers, so it
  runs on each device's local shards through ``local_map``, heads sharded
  on ``model`` (K/V heads expanded to the query heads where the KV heads
  do not divide the axis). Over K/V sharded along their sequence with
  fewer query rows than key rows (a decode step on a sequence-sharded
  cache), :func:`sequence_parallel_attention` merges the shards'
  partials, GSPMD's flash-decode pattern: each device's partial (the
  unnormalised output, the row max and the row sum) comes from the
  chosen backend's attention with ``stats`` (on ``cuda`` the flash
  kernel's launch with row statistics, on ``torch`` aten), and three
  all-reduces merge them.
* :func:`gloo_guard`: ``GLOO_CUDA_COLLECTIVES`` is what gloo runs on CUDA
  tensors (torch 2.11 on the H100 machine: all-reduce, reduce-scatter,
  all-to-all and broadcast; its all-gather does not return); the guard
  raises, naming the collective, before any other is issued on a gloo
  group with card tensors.

Importing this module touches no process group and no device; DTensor's
class is imported at the first call.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch

GLOO_CUDA_COLLECTIVES = ("all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute")
BATCH_AXES = ("pod", "data")

_DTENSOR = []  # the DTensor class, imported at the first call
_ALL_REDUCE_GATHERS: List[bool] = []  # all_reduce_gathers() is active


def _dtensor_class():
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return _DTENSOR[0]


def is_dtensor(t) -> bool:
    return isinstance(t, _dtensor_class())


def is_dtensor_type(cls) -> bool:
    return issubclass(cls, _dtensor_class())


def tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of a tree of lists, tuples and dicts, in order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensors(x)]
    return []


class _Relayout(torch.autograd.Function):
    """``t.redistribute(mesh, placements)`` whose gradient is brought to
    ``t``'s placements, a Partial one replicated. A redistribution is the
    identity on the global value, so any layout of the gradient is right;
    DTensor's own backward keeps a Partial gradient Partial along the
    residual stream, and its backward matmuls then gather the other
    operand. Brought to the input's layout here, at each row-parallel
    output, the backward's reductions are Megatron's: one all-reduce a
    block (with sequence parallelism, the all-gather partner of the
    forward's reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, mesh, placements):
        from torch.distributed.tensor import Partial, Replicate

        ctx.mesh = mesh
        ctx.back = tuple(Replicate() if isinstance(p, Partial) else p
                         for p in t.placements)
        return t.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.back:
            grad = grad.redistribute(ctx.mesh, ctx.back)
        return grad, None, None


def relayout(t, mesh, placements):
    """``t`` redistributed to ``placements`` (no-op if it has them)."""
    if tuple(t.placements) == tuple(placements):
        return t
    return _Relayout.apply(t, mesh, tuple(placements))


def _from_local(local, t, placements):
    """``local`` as a DTensor of ``t``'s mesh, global shape and stride in
    ``placements`` (no wire); ``t`` a DTensor or a (mesh, shape, stride)
    triple."""
    from torch.distributed.tensor import DTensor

    mesh, shape, stride = ((t.device_mesh, t.shape, t.stride())
                           if is_dtensor(t) else t)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=stride)


def _moved(placements, mesh_dim: int, p) -> tuple:
    out = list(placements)
    out[mesh_dim] = p
    return tuple(out)


def _check_inner(t, mesh_dim: int, dims) -> None:
    """``mesh_dim`` must be (or become) the innermost mesh dim sharding
    each of ``dims``, each split evenly: a move along it then splits or
    joins equal chunks of each device's local extent, in the peers'
    order."""
    for d in dims:
        mesh_dims = set(sharding_dims(t, d)) | {mesh_dim}
        if max(mesh_dims) != mesh_dim:
            raise ValueError(f"{t.placements}: mesh dim {mesh_dim} is not "
                             f"the innermost sharding dim {d}")
        n = math.prod(t.device_mesh.size(i) for i in mesh_dims)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"evenly over {n} devices")


def _exchange(t, mesh_dim: int, src: int, dst: int):
    """The all-to-all of :class:`_AllToAll`: each device splits its local
    ``dst`` extent into one chunk a peer along ``mesh_dim`` and joins the
    chunks it receives along ``src``, in the peers' order."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard

    n = t.device_mesh.size(mesh_dim)
    x = t.to_local().movedim(dst, 0).contiguous()
    splits = [x.shape[0] // n] * n
    y = funcol.all_to_all_single(x, splits, splits,
                                 (t.device_mesh, mesh_dim))
    at = src + 1 if src < dst else src  # src's index after the movedim
    out = torch.cat(torch.chunk(y, n, dim=0), dim=at).movedim(0, dst)
    return _from_local(out.contiguous(), t,
                       _moved(t.placements, mesh_dim, Shard(dst)))


class _AllToAll(torch.autograd.Function):
    """Mesh dim ``mesh_dim``'s sharding of ``t`` moved from tensor dim
    ``src`` to ``dst`` by one all-to-all along it; the gradient comes back
    by the inverse one."""

    @staticmethod
    def forward(ctx, t, mesh_dim, src, dst):
        out = _exchange(t, mesh_dim, src, dst)
        ctx.args = (mesh_dim, src, dst, tuple(out.placements))
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh_dim, src, dst, placements = ctx.args
        if tuple(grad.placements) != placements:
            grad = grad.redistribute(grad.device_mesh, placements)
        return _exchange(grad, mesh_dim, dst, src), None, None, None


def all_to_all(t, mesh_dim: int, dst: int):
    """``t`` (sharded along some dim by mesh dim ``mesh_dim``) with that
    mesh dim sharding tensor dim ``dst`` instead: one all-to-all, which
    gloo runs on card tensors (DTensor's own shard-to-shard move gathers
    on a CPU mesh instead). ``mesh_dim`` must be the innermost mesh dim
    sharding either dim."""
    src = sharded_dim(t, mesh_dim)
    if src is None:
        raise ValueError(f"{t.placements}: mesh dim {mesh_dim} shards no "
                         "dim")
    if src == dst:
        return t
    _check_inner(t, mesh_dim, (src, dst))
    return _AllToAll.apply(t, mesh_dim, src, dst)


def _pad_to_outer(local, t, mesh_dim: int, dim: int):
    """This device's chunk ``local`` of ``dim`` placed at its offset in
    zeros of the extent before ``mesh_dim`` split it."""
    n = local.shape[dim]
    at = t.device_mesh.get_local_rank(mesh_dim) * n
    widths = [0, 0] * (local.ndim - dim - 1) + [
        at, (t.device_mesh.size(mesh_dim) - 1) * n - at]
    return torch.nn.functional.pad(local, widths)


def _sum_of_padded(t, mesh_dim: int, dim: int, placements):
    """``t`` (sharded along ``dim`` by ``mesh_dim``) whole along it: each
    device's chunk zero-padded, summed by one all-reduce, in
    ``placements`` (replicated at ``mesh_dim``)."""
    from torch.distributed.tensor import Partial

    padded = _pad_to_outer(t.to_local(), t, mesh_dim, dim)
    meta = (t.device_mesh, t.shape, t.stride())
    part = _from_local(padded, meta, _moved(placements, mesh_dim, Partial()))
    return part.redistribute(t.device_mesh, placements)


class _Chunk(torch.autograd.Function):
    """Replicated along ``mesh_dim`` -> sharded along tensor dim ``dim``
    there: each device keeps its chunk (no wire). The gradient comes back
    zero-padded to the whole dim and summed by one all-reduce, where
    DTensor's backward would all-gather it (which gloo cannot run on card
    tensors)."""

    @staticmethod
    def forward(ctx, t, mesh_dim, dim):
        from torch.distributed.tensor import Shard

        out = t.redistribute(t.device_mesh,
                             _moved(t.placements, mesh_dim, Shard(dim)))
        ctx.args = (mesh_dim, dim, tuple(t.placements), tuple(out.placements))
        return out

    @staticmethod
    def backward(ctx, grad):
        mesh_dim, dim, back, placements = ctx.args
        if tuple(grad.placements) != placements:
            grad = grad.redistribute(grad.device_mesh, placements)
        return _sum_of_padded(grad, mesh_dim, dim, back), None, None


class _Gather(torch.autograd.Function):
    """Sharded along tensor dim ``dim`` by ``mesh_dim`` -> replicated there,
    as a sum of zero-padded chunks (one all-reduce: gloo cannot all-gather
    card tensors); the gradient is each device's chunk of it (no wire)."""

    @staticmethod
    def forward(ctx, t, mesh_dim, dim):
        from torch.distributed.tensor import Replicate

        want = _moved(t.placements, mesh_dim, Replicate())
        ctx.args = (mesh_dim, dim, tuple(t.placements), want)
        return _sum_of_padded(t, mesh_dim, dim, want)

    @staticmethod
    def backward(ctx, grad):
        mesh_dim, dim, back, placements = ctx.args
        if tuple(grad.placements) != placements:
            grad = grad.redistribute(grad.device_mesh, placements)
        return grad.redistribute(grad.device_mesh, back), None, None


def chunk(t, mesh_dim: int, dim: int):
    """``t`` (replicated along mesh dim ``mesh_dim``) sharded along tensor
    dim ``dim`` there, each device keeping its chunk; the gradient is
    all-reduced, not gathered (:class:`_Chunk`). ``mesh_dim`` must become
    the innermost mesh dim sharding ``dim``."""
    _check_inner(t, mesh_dim, (dim,))
    return _Chunk.apply(t, mesh_dim, dim)


def gather(t, mesh_dim: int):
    """``t`` replicated along mesh dim ``mesh_dim``, which shards it: a
    sum of zero-padded chunks, one all-reduce (:class:`_Gather`); the
    inverse of :func:`chunk`. ``mesh_dim`` must be the innermost mesh dim
    sharding that dim."""
    dim = sharded_dim(t, mesh_dim)
    _check_inner(t, mesh_dim, (dim,))
    return _Gather.apply(t, mesh_dim, dim)


def whole(t):
    """``t``'s global value, a plain tensor on every device: gathered over
    each mesh dim sharding it, innermost first (:func:`gather`: one
    all-reduce of zero-padded chunks each; dims that split evenly), a
    Partial sum all-reduced."""
    from torch.distributed.tensor import Replicate

    for i in reversed(range(t.device_mesh.ndim)):
        if sharded_dim(t, i) is not None:
            t = gather(t, i)
    return relayout(t, t.device_mesh,
                    (Replicate(),) * t.device_mesh.ndim).to_local()


def reshard(t, placements):
    """``t`` brought to ``placements`` one mesh dim at a time, by moves gloo
    runs on card tensors: a replicated dim becomes sharded in place
    (:func:`chunk`: no wire, its gradient all-reduced), a dim's sharding
    moves to another tensor dim by one all-to-all (:func:`all_to_all`), a
    sharded dim becomes whole by one all-reduce of zero-padded chunks
    (:func:`gather`), a Partial sum by one all-reduce."""
    from torch.distributed.tensor import Replicate, Shard

    for i, p in enumerate(placements):
        have = t.placements[i]
        if have == p:
            continue
        if isinstance(p, Shard) and have == Replicate():
            t = chunk(t, i, p.dim)
        elif isinstance(p, Shard) and isinstance(have, Shard):
            t = all_to_all(t, i, p.dim)
        elif p == Replicate() and isinstance(have, Shard):
            t = gather(t, i)
    return relayout(t, t.device_mesh, placements)


@contextlib.contextmanager
def all_reduce_gathers():
    """Inside: :func:`move` gathers by all-reduces on any group, as it
    does on its own on a gloo group with card tensors; a dry run's count
    of a step that gloo ranks run on the card is taken inside it."""
    _ALL_REDUCE_GATHERS.append(True)
    try:
        yield
    finally:
        _ALL_REDUCE_GATHERS.pop()


def move(t, placements):
    """``t`` in ``placements``: DTensor's redistribution (an all-gather a
    sharded dim made whole), or, inside :func:`all_reduce_gathers` and on
    a gloo group with ``t`` on the card (``GLOO_CUDA_COLLECTIVES``),
    :func:`reshard`'s moves (one all-reduce of zero-padded chunks a
    sharded dim made whole)."""
    import torch.distributed as dist

    if _ALL_REDUCE_GATHERS or (dist.is_initialized()
                               and dist.get_backend() == "gloo"
                               and t.to_local().is_cuda):
        return reshard(t, tuple(placements))
    return t.redistribute(t.device_mesh, tuple(placements))


def make_whole(t, mesh_dims):
    """``t`` replicated along the mesh dims ``mesh_dims`` (:func:`move`)."""
    from torch.distributed.tensor import Replicate

    pl = list(t.placements)
    for i in mesh_dims:
        pl[i] = Replicate()
    return move(t, pl)


def _piece_order(rank: int, m: int, parts: int):
    """The exchange of :func:`split_columns` seen from device ``rank`` of
    ``m``: its local chunk is ``parts`` pieces, global piece p = rank x
    parts + q, and piece p goes to device p % m as part p // m. Returns
    (the local pieces sorted by destination, the pieces sent to each
    device, the pieces received from each device)."""
    order = sorted(range(parts), key=lambda q: (rank * parts + q) % m)
    send = [0] * m
    for q in order:
        send[(rank * parts + q) % m] += 1
    recv = [0] * m
    for h in range(parts):
        recv[(h * m + rank) // parts] += 1
    return order, send, recv


def _columns_exchange(local, group, rank: int, m: int, parts: int,
                      inverse: bool):
    """One all-to-all (uneven splits) of :func:`split_columns` on this
    device's local tensors: forward, the local (..., n/m) chunk in, its
    ``parts`` parts' (..., n/(parts m)) chunks out; ``inverse``, the
    parts' chunks in (a list), the local chunk out."""
    from torch.distributed import _functional_collectives as funcol

    order, send, recv = _piece_order(rank, m, parts)
    if inverse:
        send, recv = recv, send
        x = torch.stack([g.movedim(-1, 0) for g in local])  # (parts, u, ...)
    else:
        x = local.movedim(-1, 0)
        x = x.reshape(parts, x.shape[0] // parts, *x.shape[1:])
        x = x[order]  # the pieces sorted by destination
    u = x.shape[1]
    y = funcol.all_to_all_single(x.reshape(parts * u, *x.shape[2:])
                                 .contiguous(), [r * u for r in recv],
                                 [s * u for s in send], group)
    y = y.reshape(parts, u, *y.shape[1:])
    if inverse:  # the pieces came back sorted by destination: undo it
        back = torch.empty_like(y)
        back[order] = y
        return back.reshape(parts * u, *y.shape[2:]).movedim(0, -1) \
            .contiguous()
    return [y[h].movedim(0, -1).contiguous() for h in range(parts)]


class _SplitColumns(torch.autograd.Function):
    """:func:`split_columns` on a DTensor whose last dim one mesh dim
    shards; the gradient comes back by the inverse exchange."""

    @staticmethod
    def forward(ctx, t, mesh_dim, parts):
        mesh = t.device_mesh
        m, rank = mesh.size(mesh_dim), mesh.get_local_rank(mesh_dim)
        chunks = _columns_exchange(t.to_local(), (mesh, mesh_dim), rank, m,
                                   parts, inverse=False)
        shape = (*t.shape[:-1], t.shape[-1] // parts)
        stride = torch.empty(shape, device="meta").stride()
        ctx.args = (mesh_dim, parts, tuple(t.placements), tuple(t.shape),
                    t.stride())
        return tuple(_from_local(c, (mesh, shape, stride), t.placements)
                     for c in chunks)

    @staticmethod
    def backward(ctx, *grads):
        mesh_dim, parts, placements, shape, stride = ctx.args
        mesh = next(g for g in grads if g is not None).device_mesh
        m, rank = mesh.size(mesh_dim), mesh.get_local_rank(mesh_dim)
        local = [None if g is None else (
            g if tuple(g.placements) == placements
            else g.redistribute(mesh, placements)).to_local() for g in grads]
        like = next(g for g in local if g is not None)
        local = [torch.zeros_like(like) if g is None else g for g in local]
        whole = _columns_exchange(local, (mesh, mesh_dim), rank, m, parts,
                                  inverse=True)
        return (_from_local(whole, (mesh, torch.Size(shape), stride),
                            placements), None, None)


def split_columns(t, parts: int):
    """``t`` (..., n) cut into ``parts`` equal column blocks, each (...,
    n / parts) sharded along its last dim as ``t`` is: the x/z split of a
    column-parallel projection. Where one mesh dim (m devices) shards the
    last dim, a device's chunk holds pieces of other devices' blocks, so
    the blocks are made by one all-to-all along it (uneven splits: each
    device keeps the pieces that are its own and sends the others; gloo
    runs it on card tensors, where slicing the DTensor would all-gather);
    n must split into parts x m equal pieces. Unsharded, each device
    slices its own copy."""
    n = t.shape[-1]
    dims = sharding_dims(t, t.ndim - 1)
    if not dims:
        w = n // parts
        return tuple(t[..., i * w:(i + 1) * w] for i in range(parts))
    if len(dims) > 1:
        raise ValueError(f"{t.placements}: the columns are split over "
                         f"several mesh dims {dims}")
    m = t.device_mesh.size(dims[0])
    if n % (parts * m):
        raise ValueError(f"{n} columns do not split evenly into {parts} "
                         f"blocks over {m} devices")
    return _SplitColumns.apply(t, dims[0], parts)


def local_channels(fn, x, w):
    """``fn(x, w)`` on each device's channels (``local_map``): ``x``
    (..., C) and ``w`` (K, C) sharded alike along C (a depthwise filter),
    x's other dims as they lie; the result in ``x``'s placements. ``w``'s
    gradient is a Partial sum over the mesh dims sharding x's other dims
    (each device's rows add theirs)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    cdims = sharding_dims(x, x.ndim - 1)
    w_pl = tuple(Shard(1) if i in cdims else Replicate()
                 for i in range(mesh.ndim))
    w_grad = tuple(Shard(1) if i in cdims else
                   Partial() if isinstance(p, Shard) else Replicate()
                   for i, p in enumerate(x.placements))
    return local_map(fn, out_placements=(tuple(x.placements),),
                     in_placements=(tuple(x.placements), w_pl),
                     in_grad_placements=(tuple(x.placements), w_grad),
                     device_mesh=mesh, redistribute_inputs=True)(x, w)


def sharding_dims(t, dim: int) -> Tuple[int, ...]:
    """The mesh dims sharding ``t``'s dim ``dim``."""
    from torch.distributed.tensor import Shard

    return tuple(i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim % t.ndim == dim)


def sharded_dim(t, mesh_dim: int) -> Optional[int]:
    """The tensor dim mesh dim ``mesh_dim`` shards (None if none)."""
    from torch.distributed.tensor import Shard

    p = t.placements[mesh_dim]
    return p.dim % t.ndim if isinstance(p, Shard) else None


def shard_ids(t, dim: int, mesh_dims):
    """Each device's ids along ``t``'s dim ``dim`` (a chunk of arange,
    sharded like that dim over ``mesh_dims``; no wire)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    return distribute_tensor(
        torch.arange(t.shape[dim], device=t.to_local().device),
        t.device_mesh, tuple(Shard(0) if i in mesh_dims else Replicate()
                             for i in range(t.device_mesh.ndim)),
        src_data_rank=None)


def stacked_placements(pl, dims):
    """The placements of a per-device partial stacked on a new leading
    dim: sharded there over the mesh dims ``dims``, ``pl`` (shifted one
    dim) elsewhere."""
    from torch.distributed.tensor import Shard

    return tuple(Shard(0) if i in dims else
                 (Shard(p.dim + 1) if isinstance(p, Shard) else p)
                 for i, p in enumerate(pl))


def sum_partials(parts, mesh, placements):
    """The per-device partials (stacked on dim 0) summed, in
    ``placements``: one all-reduce over the stacking dims. Summed by
    DTensor's own ops (not a Partial ``local_map`` output), the gradient
    of each partial is exact on every torch version."""
    return relayout(parts.sum(dim=0), mesh, placements)


def _head_placements(q, n_heads: int):
    """The placements attention runs in: batch on the axes sharding q's
    dim 0, heads on ``model`` where they divide it, the rest replicated."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    out = []
    model = [i for i, n in enumerate(mesh.mesh_dim_names)
             if n not in BATCH_AXES]
    heads_ok = n_heads % math.prod(mesh.size(i) for i in model) == 0
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim % q.ndim == 0:
            out.append(Shard(0))
        elif i in model and heads_ok:
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return tuple(out)


def as_dtensor(t, mesh, placements):
    """A plain tensor (the same on every device) as a DTensor, each device
    keeping its chunk; a DTensor redistributed."""
    from torch.distributed.tensor import distribute_tensor

    if is_dtensor(t):
        return t.redistribute(mesh, placements)
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def local_attention(fn, q, k, v, key_mask=None, q_offset=0):
    """``fn(q, k, v, key_mask)`` on each device's local shards
    (``local_map``): q, k, v (B, H|KV, L, hd) in :func:`_head_placements`;
    K/V heads that do not divide the axis are gathered and repeated up to
    the query heads (their ``g`` copies are local), so each shard's
    grouping is H/KV's. K/V sharded along their sequence (a cache) are
    gathered, or, where the queries' rows are fewer than the keys' (a
    decode step), take :func:`sequence_parallel_attention` with ``fn``'s
    partials (``fn(q, k, v, key_mask, q_offset=, stats=True)``; ``q_offset``
    is the call's, ``fn``'s own): its three all-reduces move q-sized rows,
    the gather K/V."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, KV = q.shape[1], k.shape[1]
    if sharding_dims(k, 2) and q.shape[2] * H < k.shape[2] * KV:
        # fewer query rows than key rows (decode): merge the shards'
        # partials; else (prefill) gather K/V, as GSPMD chooses
        return sequence_parallel_attention(fn, q, k, v, q_offset, key_mask)
    pl = _head_placements(q, H)
    kv_pl = _head_placements(k, KV) if KV != H else pl
    if kv_pl != pl:
        # gather K/V heads, repeat each to its g query heads, then keep this
        # device's heads (a local chunk)
        rep = tuple(Replicate() if p == Shard(1) else p for p in pl)
        k = k.redistribute(mesh, rep).repeat_interleave(H // KV, dim=1)
        v = v.redistribute(mesh, rep).repeat_interleave(H // KV, dim=1)
    if key_mask is not None:
        key_mask = as_dtensor(key_mask, mesh, tuple(
            Replicate() if p == Shard(1) else p for p in pl))
        run = local_map(fn, out_placements=(pl,),
                        in_placements=(pl, pl, pl, key_mask.placements),
                        device_mesh=mesh, redistribute_inputs=True)
        return run(q, k, v, key_mask)
    run = local_map(lambda a, b, c: fn(a, b, c, None), out_placements=(pl,),
                    in_placements=(pl, pl, pl), device_mesh=mesh,
                    redistribute_inputs=True)
    return run(q, k, v)


def sequence_parallel_attention(fn, q, k, v, q_offset=0, key_mask=None):
    """GQA attention over K/V sharded along their sequence (dim 2): the
    flash-decode pattern GSPMD makes of the reference's attention over a
    sequence-sharded cache. Each device attends its queries (whole along
    the sequence axes) to the keys it holds (``local_map``) through
    ``fn(q, k, v, key_mask, q_offset=, stats=True)``, ``ops.attention``'s
    partial (the unnormalised f32 output, the row max and the row sum): on
    ``cuda`` the flash kernel's launch with row statistics, on ``torch``
    aten. Its causal offset is local: ``q_offset`` (an int, a tensor
    scalar or a (B,) tensor, one a row) less the shard's first key
    position (from :func:`shard_ids`, so any order of sequence axes), which
    may be negative; the shard's key mask rides along. Three all-reduces
    over the sequence axes (a max, then two sums) merge the partials, the
    same on both backends. Masked logits take the finite -1e30, so a shard
    with no valid key reports that max and weighs 0."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    seq = sharding_dims(k, 2)
    batch = sharding_dims(k, 0)
    B = q.shape[0]
    dev = k.to_local().device
    q_pl = tuple(Shard(0) if i in batch else Replicate()
                 for i in range(mesh.ndim))
    # the queries whole along heads (make_whole: by all-reduces on gloo
    # with card tensors); local_map then moves nothing but local chunks
    q = make_whole(q, [i for i, p in enumerate(q.placements)
                       if q_pl[i] == Replicate() and p != Replicate()])
    kv_pl = tuple(Shard(0) if i in batch else Shard(2) if i in seq
                  else Replicate() for i in range(mesh.ndim))
    pos = shard_ids(k, 2, seq)  # each device's key positions
    if key_mask is None:
        key_mask = torch.ones((B, k.shape[2]), dtype=torch.bool, device=dev)
    mask_pl = tuple(Shard(0) if i in batch else Shard(1) if i in seq
                    else Replicate() for i in range(mesh.ndim))
    key_mask = as_dtensor(key_mask, mesh, mask_pl)
    args = [q, k, v, pos, key_mask]
    if torch.is_tensor(q_offset) and q_offset.ndim:
        # one offset a row: each device's rows (a local chunk, no wire)
        args.append(as_dtensor(
            q_offset.to(device=dev, dtype=torch.int32), mesh,
            tuple(Shard(0) if i in batch else Replicate()
                  for i in range(mesh.ndim))))

    def local(q_, k_, v_, pos_, km_, offs_=None):
        # the causal offset from the shard's first key (it may be negative)
        off = (q_offset if offs_ is None else offs_) - pos_[0].to(torch.int32)
        o, m, l_ = fn(q_, k_, v_, km_, q_offset=off, stats=True)
        return o[None], m[..., None][None], l_[..., None][None]

    stacked = stacked_placements(q_pl, seq)
    o, m, l_ = local_map(
        local, out_placements=(stacked, stacked, stacked),
        in_placements=(q_pl, kv_pl, kv_pl)
        + tuple(a.placements for a in args[3:]),
        device_mesh=mesh, redistribute_inputs=True)(*args)
    top = relayout(m.amax(dim=0), mesh, q_pl)  # all-reduce (max)
    w = torch.exp(m - top)
    num = sum_partials(o * w, mesh, q_pl)
    den = sum_partials(l_ * w, mesh, q_pl)
    return (num / den).to(q.dtype)


def gloo_guard(kind: str, func, args) -> None:
    """Raise before a collective that gloo cannot run on CUDA tensors is
    issued on a gloo group (``analysis.roofline.CostMode``'s ``check`` in
    the mesh trainer): no collective is staged through the host
    silently."""
    import torch.distributed as dist

    if kind in GLOO_CUDA_COLLECTIVES or not dist.is_initialized():
        return
    if dist.get_backend() != "gloo":
        return
    if any(t.is_cuda for t in tensors(args)):
        raise NotImplementedError(
            f"gloo cannot run {kind} ({func}) on CUDA tensors; it runs "
            f"{', '.join(GLOO_CUDA_COLLECTIVES)} there")
