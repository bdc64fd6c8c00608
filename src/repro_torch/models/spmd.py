"""The model on a device mesh: what GSPMD does for the reference's jitted
forward, done with DTensor (``torch.distributed.tensor``).

The forward (``models.transformer``) is the same function on a mesh: its
parameters, batches and caches are DTensors placed by
``models.sharding``'s specs, and DTensor issues the collectives. This
module holds the places where the forward tells DTensor what GSPMD would
choose for it, each a no-op on a plain tensor:

* :func:`like` / :func:`constrain` / :func:`gather_rows` /
  :func:`rows_like`: the activation layout. A row-parallel projection's
  Partial result is reduced to the residual stream's placements (one
  all-reduce, Megatron's pattern) by ``dtensors.relayout``, whose backward
  brings the gradient to the input's layout (DTensor's own leaves it
  Partial along the residual stream, and its backward matmuls then
  gather); ``act_spec`` is a redistribution (the reference's
  ``with_sharding_constraint``); a sequence-sharded stream is gathered
  before a column-parallel projection and reduce-scattered after its
  row-parallel partner.
* :func:`embed_lookup` and :func:`token_nll`: the vocabulary-parallel
  embedding and cross entropy. Each device works on the vocabulary rows
  it holds (``local_map``) and returns its partial stacked on a new dim;
  DTensor's sum over that dim and one all-reduce give the result, and
  the gradient of each partial exactly (a Partial ``local_map`` output's
  gradient depends on the torch version; DTensor's own masked lookup
  fails in the backward pass). The cross entropy's max and sum over the
  vocabulary are two more all-reduces.
* :func:`split_heads`: a projection's columns split inside a head cannot
  be viewed as heads (DTensor refuses an uneven unflatten, GSPMD reshards
  silently): where the heads do not divide the axes sharding the columns,
  the columns are gathered first (``dtensors.make_whole``: by all-reduces
  on gloo with card tensors), and the gather is counted.
* :func:`cache_write`: a K/V write into a cache sharded along its
  sequence: each shard writes the positions it holds, one a row for a
  per-row index. :func:`pad` pads shard by shard.
* :func:`split_columns` / :func:`on_channels`: the mamba block's x/z
  split of its in-projection (``dtensors.split_columns``: one all-to-all
  where slicing a sharded dim would gather) and its short conv on each
  device's channels (``dtensors.local_channels``).
* :func:`reshard`: a ``with_sharding_constraint`` that GSPMD would meet
  by all-to-all (the MoE dispatch's ``moe_shard_hints``), by moves gloo
  runs on card tensors (``dtensors.reshard``); :func:`replicated` a
  Partial scalar all-reduced.

The helpers that do not depend on the model (``is_dtensor``, the
attention on local shards, the gloo guard) are ``repro_torch.dtensors``.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.dtensors import (is_dtensor, make_whole, move, relayout,
                                  shard_ids, sharding_dims,
                                  stacked_placements, sum_partials)


@contextlib.contextmanager
def replicate_plain(t):
    """Where ``t`` is a DTensor, plain tensors (positions, RoPE tables,
    scalars) act as replicated DTensors inside the ``with``, as in
    ``implicit_replication()``, whose flag this sets and restores (that
    context manager clears it on exit, also when nested); else a no-op."""
    if not is_dtensor(t):
        yield
        return
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def like(t, ref):
    """``t`` in ``ref``'s placements (a Partial becomes an all-reduce)."""
    if not is_dtensor(t):
        return t
    return relayout(t, ref.device_mesh, ref.placements)


def constrain(x, spec):
    """``x`` redistributed to ``spec`` (a ``sharding.P``) on its mesh: the
    counterpart of ``with_sharding_constraint``; a no-op without a spec or
    on a plain tensor."""
    if spec is None or not is_dtensor(x):
        return x
    from .sharding import placements

    return relayout(x, x.device_mesh, placements(x.device_mesh, spec))


def reshard(x, spec):
    """``x`` brought to ``spec`` by moves gloo runs on card tensors
    (``dtensors.reshard``): the counterpart of ``with_sharding_constraint``
    where GSPMD reshards by all-to-all (the MoE dispatch's G <-> E). A dim
    takes the longest prefix of its spec's axes that splits it evenly (one
    decode step of 128 tokens on 256 devices is one group: it stays
    whole), where GSPMD would pad. A no-op without a spec or on a plain
    tensor."""
    if spec is None or not is_dtensor(x):
        return x
    from repro_torch.dtensors import reshard as to

    from .sharding import P, mesh_axis_sizes, placements

    sizes = mesh_axis_sizes(x.device_mesh)
    even = []
    for n, entry in zip(x.shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        while axes and n % math.prod(sizes[a] for a in axes):
            axes = axes[:-1]
        even.append(axes or None)
    return to(x, placements(x.device_mesh, P(*even)))


def split_columns(t, parts: int):
    """``t`` (..., n) cut into ``parts`` equal column blocks; on a
    DTensor each block sharded along its last dim as ``t`` is
    (``dtensors.split_columns``)."""
    if is_dtensor(t):
        from repro_torch.dtensors import split_columns as split

        return split(t, parts)
    w = t.shape[-1] // parts
    return tuple(t[..., i * w:(i + 1) * w] for i in range(parts))


def on_channels(fn, x, w):
    """``fn(x, w)``, a depthwise op over ``x`` (..., C) with a (K, C)
    filter; on DTensors, on each device's channels
    (``dtensors.local_channels``)."""
    if not is_dtensor(x):
        return fn(x, w)
    from repro_torch.dtensors import local_channels

    return local_channels(fn, x, w)


def gather_rows(x):
    """``x`` with only its batch dim (0) sharded: a sequence-sharded
    activation is all-gathered before a column-parallel projection
    (Megatron's sequence parallelism; its row-parallel partner's
    :func:`like` is then a reduce-scatter)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(p if isinstance(p, Shard) and p.dim % x.ndim == 0
                 else Replicate() if isinstance(p, Shard) else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def pad(t, widths, value=0.0):
    """``F.pad(t, widths, value=value)``; on a DTensor, each device pads
    its local shard (``local_map``), the padded dims being whole there
    (DTensor's own pad fails on torch 2.11)."""
    import torch.nn.functional as F

    if not is_dtensor(t):
        return F.pad(t, widths, value=value)
    from torch.distributed.tensor.experimental import local_map

    padded = {t.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    if any(sharding_dims(t, d) for d in padded):
        raise ValueError(f"pad {widths}: a padded dim of {t.placements} "
                         "is sharded")
    return local_map(lambda a: F.pad(a, widths, value=value),
                     out_placements=(t.placements,),
                     in_placements=(t.placements,),
                     device_mesh=t.device_mesh)(t)


def embed_lookup(table, tokens, compute_dtype):
    """``table[tokens]`` on a vocabulary-sharded (V, D) table: each device
    looks up the tokens its rows hold (zeros for the others), and one
    all-reduce over the vocabulary's axes sums them, into the tokens'
    placements."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    vdims = sharding_dims(table, 0)
    ids = shard_ids(table, 0, vdims)

    def local(table_, tokens_, ids_):
        idx = tokens_.long() - ids_[0]
        inside = (idx >= 0) & (idx < table_.shape[0])
        out = F.embedding(idx.clamp(0, table_.shape[0] - 1), table_)
        return (out * inside[..., None].to(out.dtype))[None]

    # the table's gradient sums over the devices holding other tokens
    grad_pl = tuple(Partial() if i not in vdims and p != Replicate()
                    else table.placements[i]
                    for i, p in enumerate(tokens.placements))
    parts = local_map(local,
                      out_placements=(stacked_placements(tokens.placements,
                                                  vdims),),
                      in_placements=(table.placements, tokens.placements,
                                     ids.placements),
                      in_grad_placements=(grad_pl, tokens.placements,
                                          ids.placements),
                      device_mesh=table.device_mesh,
                      redistribute_inputs=True)(table, tokens, ids)
    return sum_partials(parts, tokens.device_mesh,
                         tokens.placements).to(compute_dtype)


def split_heads(t, n_heads: int):
    """A (B, L, n_heads * hd) projection ready for its head view: where the
    mesh dims sharding its columns do not divide ``n_heads``, the columns
    are gathered (counted) first."""
    if not is_dtensor(t):
        return t
    dims = sharding_dims(t, t.ndim - 1)
    size = math.prod(t.device_mesh.size(i) for i in dims)
    if dims and n_heads % size:
        return make_whole(t, dims)
    return t


def rows_like(x, w):
    """``x`` (..., K) with its last dim sharded as ``w``'s (K, N) rows,
    where it is whole there: the row-parallel product's input as a local
    chunk, so that the gradient coming back is viewed as heads whole (its
    backward gathers it)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    pl = list(x.placements)
    for i in sharding_dims(w, 0):
        if pl[i] == Replicate():
            pl[i] = Shard(x.ndim - 1)
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def token_nll(logits, targets):
    """logsumexp(logits) - logits[target] per position, in f32, on logits
    whose last (vocabulary) dim is sharded: returns a DTensor in the
    targets' placements."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    lg = logits.float()
    mesh = lg.device_mesh
    vdims = sharding_dims(lg, lg.ndim - 1)
    rows = tuple(Replicate() if i in vdims else p
                 for i, p in enumerate(lg.placements))
    m = lg.detach().amax(dim=-1, keepdim=True).redistribute(mesh, rows)
    sumexp = relayout(torch.exp(lg - m).sum(dim=-1), mesh, rows)
    logz = m[..., 0] + torch.log(sumexp)
    ids = shard_ids(lg, lg.ndim - 1, vdims)

    def local(lg_, tg_, ids_):
        idx = tg_.long() - ids_[0]
        inside = (idx >= 0) & (idx < lg_.shape[-1])
        g = torch.gather(lg_, -1, idx.clamp(0, lg_.shape[-1] - 1)[..., None])
        return torch.where(inside, g[..., 0], torch.zeros_like(g[..., 0]))[
            None]

    parts = local_map(local, out_placements=(stacked_placements(rows, vdims),),
                      in_placements=(lg.placements, rows, ids.placements),
                      device_mesh=mesh, redistribute_inputs=True)(
        lg, targets, ids)
    return logz - sum_partials(parts, mesh, rows)


def replicated(t):
    """``t`` replicated on every mesh dim (a Partial sum all-reduced); a
    no-op on a plain tensor."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    return relayout(t, t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def mean(t):
    """The mean of a DTensor as a sum over its elements over their count
    (a Partial sum: gloo has no AVG reduction)."""
    return t.sum() / t.numel()


def cache_write(c, u, start) -> None:
    """``c[:, :, start:start + L] = u`` (L = u.shape[2]) on a cache leaf
    DTensor whose sequence dim (2) may be sharded: ``u`` is redistributed to
    the cache's placements with that dim whole, and each device writes the
    positions its shard holds, in place. ``start`` may be a (B,) tensor, one
    offset a row, for one position a row (a decode step, L == 1): each
    device writes its rows whose position its shard holds."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from .sharding import shard_range

    mesh = c.device_mesh
    seq = sharding_dims(c, 2)
    u_pl = tuple(Replicate() if i in seq else p
                 for i, p in enumerate(c.placements))
    u = (move(u, u_pl) if is_dtensor(u) else
         distribute_tensor(u, mesh, u_pl, src_data_rank=None))
    off, n = shard_range(c.shape[2], mesh, seq)
    if torch.is_tensor(start):
        if u.shape[2] != 1:
            raise NotImplementedError("per-row cache writes of more than "
                                      "one position on a mesh")
        cl, ul = c.to_local(), u.to_local()
        b0, nb = shard_range(c.shape[0], mesh, sharding_dims(c, 0))
        at = start.to(device=cl.device, dtype=torch.long)[b0:b0 + nb] - off
        inside = ((at >= 0) & (at < n)).view(-1, *(1,) * (cl.ndim - 2))
        li = at.clamp(0, max(n - 1, 0))  # a row's one index: no collision
        rows = torch.arange(nb, device=cl.device)
        cl[rows, :, li] = torch.where(inside, ul[:, :, 0].to(cl.dtype),
                                      cl[rows, :, li])
        return
    lo, hi = max(start, off), min(start + u.shape[2], off + n)
    if lo < hi:
        c.to_local()[:, :, lo - off:hi - off] = \
            u.to_local()[:, :, lo - start:hi - start].to(c.dtype)
