"""Sharding rules: parameter / activation / cache PartitionSpecs (the port of
``repro.models.sharding``), and their DTensor placements.

The axis binding follows the paper's parallel blocking LP (the planner's
mesh leg emits it, see ``gemm_sharding_plan``): for every GEMM in the
stack, rows (tokens) -> the data-like axes, columns (features, heads,
experts, vocab) -> the ``model`` axis; the reduction axis is never sharded
in the forward pass. The static rule tables below are that LP solution
written out for the transformer stack, as in the reference.

Conventions:
  mesh axes  = ("pod", "data", "model")  (pod optional)
  batch spec = P(("pod", "data")): the pod axis is an outer pure-DP ring

A spec is a :class:`P`, the counterpart of ``jax.sharding.PartitionSpec``:
one entry a tensor dim, each ``None`` (replicated), an axis name or a tuple
of axis names (the dim split over those axes, the first the major one).

Two differences from the reference:

* The port keeps per-layer parameters (``layers.3.b0.core.wq``), not
  leaves stacked on a leading repeats axis, so :func:`param_specs` is a
  flat ``{parameter name: P}``: the reference's spec of
  ``trainer.reference_leaf(name)`` with its leading repeats ``None``
  dropped. Caches keep the reference's stacked layout in the port, and
  :func:`cache_specs` is the reference's, leading ``None`` included.
* :func:`shardings` turns specs into :class:`NamedSharding`\\ s whose
  ``placements`` are DTensor placements on a
  ``torch.distributed.device_mesh.DeviceMesh``: mesh dim i is ``Shard(d)``
  where the spec names its axis on tensor dim d, else ``Replicate()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from repro_torch.launch.mesh import mesh_axis_sizes

from .config import ModelConfig

PyTree = Any


class P(tuple):
    """A PartitionSpec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    A tuple, so it compares equal to the reference's spec of the same
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + super().__repr__().replace(",)", ")")


def _is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map_specs(fn, tree: PyTree) -> PyTree:
    """``fn`` on every :class:`P` leaf of a nested dict / tuple /
    NamedTuple tree."""
    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map_specs(fn, v) for v in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return tree


def mesh_target(mesh, base=None):
    """HardwareTarget whose mesh_axes mirror a mesh's axes and sizes (a
    ``DeviceMesh`` or a JAX-like mesh): the planner input for every
    sharding decision in this module (default base ``H100``)."""
    from repro_torch.plan import H100

    return (base or H100).with_mesh(tuple(mesh_axis_sizes(mesh).items()))


def gemm_sharding_plan(m: int, n: int, k: int, mesh):
    """LP-derived PartitionSpecs for C[m,n] = A[m,k] B[k,n] on ``mesh``.

    Returns (plan, spec_A, spec_B, spec_C); specs cover the two matrix dims.
    This is the dynamic path behind the static rule tables below."""
    from repro_torch.plan import MatmulSpec, Planner

    ep = Planner(mesh_target(mesh)).plan(MatmulSpec(m, n, k))
    sp = ep.sharding
    return (ep, P(*sp.input_spec[:2]), P(*sp.filter_spec[:2]),
            P(*sp.output_spec[:2]))


def static_rule_gemms(cfg: ModelConfig, tokens: int = 65536):
    """The static rule tables below, re-expressed as the GEMMs they shard:
    ``(name, (m, n, k), weight_spec)`` for every two-axis weight GEMM of the
    stack, ``m`` = tokens, ``(k, n)`` = the weight shape (the reference's
    contract, held against ``gemm_sharding_plan`` by the tests)."""
    from .transformer import _has_ffn, _is_moe

    D = cfg.d_model
    out = []
    for i, kind in enumerate(cfg.pattern):
        if kind == "attn":
            a = _attn_specs(cfg)
            H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
            out += [("attn.wq", (tokens, H * hd, D), a["wq"]),
                    ("attn.wk", (tokens, KV * hd, D), a["wk"]),
                    ("attn.wv", (tokens, KV * hd, D), a["wv"]),
                    ("attn.wo", (tokens, D, H * hd), a["wo"])]
        elif kind == "mamba":
            m = _mamba_specs()
            out += [("mamba.w_in", (tokens, 2 * cfg.d_inner, D), m["w_in"]),
                    ("mamba.w_out", (tokens, D, cfg.d_inner), m["w_out"])]
        elif kind == "mlstm":
            m = _mlstm_specs()
            out += [("mlstm.wq", (tokens, D, D), m["wq"]),
                    ("mlstm.wo", (tokens, D, D), m["wo"])]
        elif kind == "slstm":
            s = _slstm_specs()
            out += [("slstm.w_zifo", (tokens, 4 * D, D), s["w_zifo"]),
                    ("slstm.wo", (tokens, D, D), s["wo"])]
        if _has_ffn(cfg, i) and not _is_moe(cfg, i):
            f = _mlp_specs()
            out += [("mlp.w_gate", (tokens, cfg.d_ff, D), f["w_gate"]),
                    ("mlp.w_down", (tokens, D, cfg.d_ff), f["w_down"])]
    out.append(("head", (tokens, cfg.padded_vocab, D), _HEAD))
    seen, uniq = set(), []  # one check per distinct GEMM
    for name, mnk, spec in out:
        if (name, mnk) not in seen:
            seen.add((name, mnk))
            uniq.append((name, mnk, spec))
    return uniq


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(n for n in mesh_axis_sizes(mesh) if n in ("pod", "data"))


def batch_axes(mesh):
    ax = data_axes(mesh)
    return ax if len(ax) > 1 else (ax[0] if ax else None)


_HEAD = P(None, "model")
_EMBED = P("model", None)


def _attn_specs(cfg: ModelConfig) -> dict:
    s = {"wq": P(None, "model"), "wk": P(None, "model"),
         "wv": P(None, "model"), "wo": P("model", None)}
    if cfg.qkv_bias:
        s.update({"bq": P("model"), "bk": P("model"), "bv": P("model")})
    return s


def _mlp_specs() -> dict:
    return {"w_gate": P(None, "model"), "w_up": P(None, "model"),
            "w_down": P("model", None)}


def _moe_specs() -> dict:
    # expert parallelism: experts sharded over `model`
    return {"router": P(None, None), "w_gate": P("model", None, None),
            "w_up": P("model", None, None), "w_down": P("model", None, None)}


def _mamba_specs() -> dict:
    return {"w_in": P(None, "model"), "conv_w": P(None, "model"),
            "w_dt": P("model", None), "b_dt": P(None),
            "w_B": P("model", None), "w_C": P("model", None),
            "log_A": P(None), "D_skip": P(None), "w_out": P("model", None)}


def _mlstm_specs() -> dict:
    return {"wq": P(None, "model"), "wk": P(None, "model"),
            "wv": P(None, "model"), "w_if": P(None, None),
            "b_if": P(None), "wo": P("model", None)}


def _slstm_specs() -> dict:
    return {"w_zifo": P(None, "model"), "b_zifo": P("model"),
            "wo": P("model", None)}


_CORE_SPECS = {"mamba": _mamba_specs, "mlstm": _mlstm_specs,
               "slstm": _slstm_specs}


def _block_specs(cfg: ModelConfig, i: int) -> Dict[str, P]:
    """Block ``b{i}``'s leaves, flat (``core.wq``), without a repeats
    axis."""
    from .transformer import _has_ffn, _is_moe

    kind = cfg.pattern[i]
    core = _attn_specs(cfg) if kind == "attn" else _CORE_SPECS[kind]()
    out = {"norm1": P(None)}
    out.update({f"core.{k}": v for k, v in core.items()})
    if _has_ffn(cfg, i):
        out["norm2"] = P(None)
        ffn = _moe_specs() if _is_moe(cfg, i) else _mlp_specs()
        out.update({f"ffn.{k}": v for k, v in ffn.items()})
    return out


def param_specs(cfg: ModelConfig) -> Dict[str, P]:
    """``{port parameter name: P}`` in ``Transformer.named_parameters()``
    order (the module is built on the meta device: nothing allocated)."""
    import torch

    from .transformer import Transformer, _has_embed

    blocks = [_block_specs(cfg, i) for i in range(len(cfg.pattern))]
    with torch.device("meta"):
        names = [n for n, _ in Transformer(cfg).named_parameters()]
    out = {}
    for name in names:
        if name == "embed":
            out[name] = _EMBED
        elif name == "head":
            out[name] = _HEAD
        elif name == "final_norm":
            out[name] = P(None)
        else:  # layers.<r>.b<i>.<leaf>
            _, _, blk, leaf = name.split(".", 3)
            out[name] = blocks[int(blk[1:])][leaf]
    if _has_embed(cfg) != ("embed" in out):
        raise AssertionError("param_specs and the model disagree on embed")
    return out


def stacked_param_specs(cfg: ModelConfig) -> PyTree:
    """The reference's ``param_specs`` tree: the port's specs nested as the
    reference's parameter tree, each ``layers`` leaf stacked (a leading
    repeats ``None``), the layout of the port's checkpoints
    (``Trainer.state_tree``): what ``train.checkpoint.restore(shardings=)``
    places them by."""
    tree: dict = {}
    for name, spec in param_specs(cfg).items():
        parts = name.split(".")
        if parts[0] == "layers":
            parts, spec = ["layers"] + parts[2:], P(None, *spec)
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = spec
    return tree


def cache_specs(cfg: ModelConfig, mesh, batch: int, seq_len: int) -> PyTree:
    """Decode cache specs (stacked, as the port's caches are). Attention
    KV: batch on the data axes when it divides, sequence on ``model`` (32k
    decode) or on every axis (500k, batch 1)."""
    sizes = mesh_axis_sizes(mesh)
    ba = batch_axes(mesh)
    dsize = 1
    for a in data_axes(mesh):
        dsize *= sizes[a]
    shard_batch = ba if batch % max(dsize, 1) == 0 and batch > 1 else None
    seq_spec = tuple(sizes) if shard_batch is None else "model"
    c = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "attn":
            if cfg.fused_kv_cache:
                c[f"b{i}"] = {"kv": P(None, shard_batch, None, seq_spec,
                                      None, None)}
            else:
                kv = P(None, shard_batch, None, seq_spec, None)
                c[f"b{i}"] = {"k": kv, "v": kv}
        elif kind == "mamba":
            c[f"b{i}"] = {"h": P(None, shard_batch, "model", None, None),
                          "tail": P(None, shard_batch, None, "model")}
        elif kind == "mlstm":
            c[f"b{i}"] = {"C": P(None, shard_batch, None, "model", None),
                          "n": P(None, shard_batch, None, "model")}
        elif kind == "slstm":
            c[f"b{i}"] = {"c": P(None, shard_batch, "model"),
                          "n": P(None, shard_batch, "model")}
    return c


def batch_specs(cfg: ModelConfig, mesh, kind: str) -> PyTree:
    """Input-batch specs for train/prefill/decode steps."""
    ba = batch_axes(mesh)
    specs = {}
    if cfg.inputs_are_embeddings and kind != "decode":
        specs["embeds"] = P(ba, "model", None)  # sequence-sharded activations
        specs["labels"] = P(ba, "model")
    else:
        specs["tokens"] = P(ba, None)
    return specs


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: P) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where the spec names its axis on tensor dim d, else
    ``Replicate()``. Axes of one tensor dim shard it in mesh-dim order
    (the major axis first), as ``NamedSharding`` orders them when the
    spec lists them in mesh order; a spec that lists them otherwise
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axis_sizes(mesh))
    dim_of = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a)
                                                    for a in axes):
            raise ValueError(f"{spec}: axes of dim {d} not in mesh order "
                             f"{names}")
        for a in axes:
            if a in dim_of:
                raise ValueError(f"{spec}: axis {a!r} used twice")
            dim_of[a] = d
    unknown = set(dim_of) - set(names)
    if unknown:
        raise ValueError(f"{spec}: axes {sorted(unknown)} not in mesh "
                         f"{names}")
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the counterpart of
    ``jax.sharding.NamedSharding``): ``placements`` are its DTensor
    placements, :meth:`place` distributes a full tensor with them."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def place(self, tensor):
        """``tensor`` (the same full value on every rank) as a DTensor
        with these placements: each rank keeps its own chunk, and nothing
        goes over the wire."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(tensor, self.mesh, self.placements,
                                 src_data_rank=None)

    def local_slices(self, shape) -> Tuple[slice, ...]:
        """This device's chunk of a tensor of global ``shape``, as slices
        (DTensor's nested ``torch.chunk`` split: uneven shards are larger
        first)."""
        from torch.distributed.tensor import Shard

        pl = self.placements
        out = []
        for d, n in enumerate(shape):
            dims = [i for i, p in enumerate(pl)
                    if isinstance(p, Shard) and p.dim % len(shape) == d]
            off, length = shard_range(n, self.mesh, dims)
            out.append(slice(off, off + length))
        return tuple(out)


def shard_range(n: int, mesh, dims) -> Tuple[int, int]:
    """(offset, length) of this device's chunk of a dim of size ``n``
    sharded over mesh ``dims`` in order (nested ``torch.chunk``)."""
    coord = mesh.get_coordinate()
    off, length = 0, n
    for i in dims:
        c = -(-length // mesh.size(i))
        first = min(c * coord[i], length)
        off, length = off + first, max(0, min(c, length - first))
    return off, length


def shardings(mesh, specs: PyTree) -> PyTree:
    """``specs`` with every :class:`P` leaf a :class:`NamedSharding` on
    ``mesh``."""
    return tree_map_specs(lambda s: NamedSharding(mesh, s), specs)
