"""Roofline terms of one NVIDIA H100 SXM (the counterpart of
``repro.analysis.roofline``'s time model).

    compute term    = operations / peak rate of their type
    memory term     = bytes / HBM_BW
    collective term = wire bytes a device / LINK_BW

The reference prices a TPU v5e. Here every constant is the H100's, from
NVIDIA's data sheet (SXM part, dense rates, 700 W): an assumption until the
card measures it. ``chip_smoke.py`` reads its bounds from this module, and
``repro_torch.plan.autotune`` its offline cost model
(:func:`alpha_beta_seconds`).

The dry run (``repro_torch.launch.dryrun``) has no HLO to read: it runs one
device's program on fake tensors, and :class:`CostMode` (a
``TorchDispatchMode``) records what that program does, one aten op at a
time, on each op's local shards: its FLOPs (the formulas of
``torch.utils.flop_counter``), the bytes it reads and writes, and the
``_c10d_functional`` collectives DTensor issues, with their result bytes.
:func:`collective_bytes` turns those records into the reference's dict of
wire bytes by kind (its ring multipliers, ``_WIRE_MULT``); ``Roofline``,
``model_flops`` and ``build`` are the reference's, on the H100's rates.
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dtensors import is_dtensor_type, tensors

# NVIDIA H100 SXM, data-sheet figures (assumed, not measured on the card)
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
PEAK_INT8_OPS = 1979e12  # int8 tensor-core OP/s
PEAK_F32_FLOPS = 67e12  # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s
# NVLink 4 of the H100 SXM (data sheet, 700 W part): 900 GB/s over 18
# links, both directions together; one device sends at half of it
LINK_BW = 450e9  # bytes/s a device sends

# The unit every words_fn / bound / static audit counts in: 32-bit words.
WORD_BYTES = 4


def words_to_bytes(words, dtypes=None):
    """32-bit words (the paper's and ``repro_torch.verify``'s unit) -> bytes.

    Scalar form (``dtypes`` omitted): ``words`` is a dtype-weighted word
    count (every ``words_fn`` and audit total already is), so bytes are
    ``words * 4``.

    Per-operand form: ``words`` maps operand -> ELEMENT count and ``dtypes``
    is the plan's per-operand dtype map (``ExecutionPlan.dtypes`` pairs, or
    a dict). Each operand converts at its own storage width (an int8 stream
    moves 1 byte an element) and a dict of per-operand bytes comes back.
    Operands absent from the map price as float32; a ``"words:<x>"``
    placeholder (an exotic plan width) prices at x words."""
    if dtypes is None:
        return float(words) * WORD_BYTES
    from repro_torch.quant.spec import dtype_words

    dmap = dict(dtypes)
    out = {}
    for operand, elems in words.items():
        dt = dmap.get(operand, "float32")
        try:
            w = dtype_words(dt)
        except ValueError:
            w = float(dt.split(":", 1)[1]) if dt.startswith("words:") else 1.0
        out[operand] = float(elems) * w * WORD_BYTES
    return out


def hbm_seconds(words: float, chips: int = 1) -> float:
    """Roofline memory time of a word count: ``bytes / (chips * HBM_BW)``."""
    return words_to_bytes(words) / (chips * HBM_BW)


# The alpha of the alpha-beta model below: the wall time one more transfer
# of ``autotune._transfers`` adds. The reference's 2 us is a TPU DMA issue,
# which one core waits out in turn. On the H100 a transfer is a ring stage
# of one CTA, whose ~1 us of HBM latency overlaps the other resident CTAs'
# (132 SMs x 2): 1e-6 / 264, rounded to 4 ns. An assumption, to be fitted by
# ``chip_smoke.py`` phase 17 (device time - hbm_seconds against transfers).
DMA_SETUP_SECONDS = 4e-9


def alpha_beta_seconds(words: float, transfers: float, chips: int = 1
                       ) -> float:
    """Latency + bandwidth (alpha-beta) time of one kernel launch:
    ``hbm_seconds(words)`` plus ``transfers`` issues at
    ``DMA_SETUP_SECONDS`` each. The offline cost model of
    ``repro_torch.plan.autotune``: the blocking LP minimizes words alone,
    so tiles that trade a few more words for fewer, larger transfers rank
    faster here."""
    return hbm_seconds(words, chips) + float(transfers) * DMA_SETUP_SECONDS


def bound_ms(operations: float, nbytes: float, peak: float
             ) -> Tuple[float, str]:
    """The least time the card could take, in ms: the larger of
    ``operations / peak`` (the rate of their type) and ``nbytes / HBM_BW``,
    and which of the two bounds it (``"operations"`` or ``"bytes"``)."""
    t_ops, t_bytes = operations / peak, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# The dry run's records: FLOPs, bytes and collectives of one device's program
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# wire multiplier per result byte (ring model)
_WIRE_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
              "all-to-all": 1.0, "collective-permute": 1.0}

# the collectives DTensor and torch.distributed issue, by kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# in-place ops whose destination's old value is not read
_OVERWRITES = {torch.ops.aten.copy_, torch.ops.aten.fill_,
               torch.ops.aten.zero_}
# factories whose ``self`` gives only its shape, dtype and device
_METADATA_ONLY = {getattr(torch.ops.aten, f) for f in (
    "empty_like", "zeros_like", "ones_like", "full_like", "rand_like",
    "randn_like", "randint_like", "new_empty", "new_empty_strided",
    "new_zeros", "new_ones", "new_full")}


def storage_key(t) -> int:
    """The identity of ``t``'s storage (shared by its views), unique among
    the storages alive at once."""
    return t.untyped_storage()._cdata


# DTensor derives an op's output metadata by running it on fake tensors of
# the global shapes, through whatever dispatch modes are active: not the
# device's program
_PROPAGATION_FRAMES = ("_propagate_tensor_meta_non_cached",
                       "_propagate_tensor_meta")


def _in_shape_propagation(depth: int = 48) -> bool:
    frame = sys._getframe(2)
    for _ in range(depth):
        if frame is None:
            return False
        if frame.f_code.co_name in _PROPAGATION_FRAMES:
            return True
        frame = frame.f_back
    return False


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a ``c10d`` / ``_c10d_functional`` op, or
    None for any other op."""
    ns = getattr(func, "namespace", "")
    if ns not in ("_c10d_functional", "c10d", "c10d_functional"):
        return None
    return _COLLECTIVE_OPS.get(func._overloadpacket.__name__)


class CostMode:
    """Records one device's program, op by op, on local tensors (DTensor ops
    are passed to DTensor, whose local ops and collectives come back here):

    * ``flops``: the ``torch.utils.flop_counter`` formulas of each op;
    * ``bytes_accessed``: each non-view op's tensor operands and results;
    * ``collectives``: one ``(kind, result bytes)`` a collective;
    * ``peak_live_bytes``: the most bytes of op results alive at once (a
      result is freed when its tensor object is collected; results kept
      for the backward pass stay alive, as they do on the card);
    * ``reads`` and ``writes``: the :func:`storage_key` of the tensor
      operands that some op reads, and of those that some op overwrites
      without reading (a ``copy_``'s or ``fill_``'s destination, an
      ``out=``), so that a caller can tell which of its inputs the program
      used. A view's operand is its base's storage; views, ``prim``
      metadata queries and the ``self`` of a ``*_like`` or ``new_*``
      factory read nothing; an in-place op that updates its operand
      (``add_``) reads it.

    ``counts_only=True`` records the collectives alone (what the mesh
    trainer runs on a real process group: no FLOP formulas on its hot
    path). ``check`` is called with each collective's (kind, result) before
    it is issued (the mesh trainer's gloo guard). Use as a context manager;
    it nests with ``FakeTensorMode`` (enter that first)."""

    def __init__(self, counts_only: bool = False, check=None):
        self.counts_only = counts_only
        self.check = check
        self.reset()

    def reset(self) -> None:
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: List[Tuple[str, int]] = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self.reads: set = set()
        self.writes: set = set()

    def __enter__(self):
        self._mode = _CostDispatch(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)

    # called by the dispatch mode
    def _record(self, func, args, kwargs, out) -> None:
        kind = collective_kind(func)
        if kind is not None:
            self.collectives.append((kind, _nbytes(tensors(out))))
        if self.counts_only or _in_shape_propagation():
            return
        from torch.utils.flop_counter import flop_registry

        if not getattr(func, "is_view", False) and func.namespace != "prim":
            self._note_operands(func, args, kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if getattr(func, "is_view", False):
            return
        outs = tensors(out)
        self.bytes_accessed += _nbytes(tensors((args, kwargs))) + \
            _nbytes(outs)
        for t in outs:
            n = _nbytes([t])
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes,
                                       self.live_bytes)
            weakref.finalize(t, self._free, n)

    def _note_operands(self, func, args, kwargs) -> None:
        overwrites = func._overloadpacket in _OVERWRITES
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        if func._overloadpacket in _METADATA_ONLY:
            named.pop("self", None)
        for arg in func._schema.arguments:
            alias = arg.alias_info
            only_written = alias is not None and alias.is_write and (
                overwrites or arg.kwarg_only)  # the destination, an out=
            for t in tensors(named.get(arg.name)):
                (self.writes if only_written else self.reads).add(
                    storage_key(t))

    def _free(self, n: int) -> None:
        self.live_bytes -= n


class _CostDispatch(TorchDispatchMode):
    """:class:`CostMode`'s dispatch mode: DTensor ops pass to DTensor
    (returning ``NotImplemented``), whose local ops and collectives come
    back here and are recorded."""

    def __init__(self, cost: CostMode):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(is_dtensor_type(t) for t in types):
            return NotImplemented
        if self.cost.check is not None:
            kind = collective_kind(func)
            if kind is not None:
                self.cost.check(kind, func, args)
        out = func(*args, **kwargs)
        self.cost._record(func, args, kwargs, out)
        return out


def collective_bytes(records) -> Dict[str, float]:
    """Per-collective-kind wire bytes of one device: ``records`` are
    :class:`CostMode`'s ``collectives`` ((kind, result bytes) pairs), each
    priced at the reference's ring multiplier (all-reduce 2x)."""
    out = {k: 0.0 for k in _COLLECTIVES}
    for kind, nbytes in records:
        out[kind] += nbytes * _WIRE_MULT[kind]
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    wire_bytes_per_chip: float
    collectives: Dict[str, float]
    model_flops: float
    bytes_per_device: Dict[str, float]

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_chip / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        """model FLOPs / counted FLOPs: how much of the compute is useful."""
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def mfu(self) -> float:
        """Model FLOPs / (roofline step time * peak): the roofline-fraction
        score (an upper bound on real MFU)."""
        return self.model_flops / (
            self.step_time_s * self.chips * PEAK_FLOPS + 1e-30)

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "collectives": self.collectives,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_frac": self.useful_flops_frac,
            "mfu": self.mfu,
        }


def model_flops(arch: str, shape_name: str) -> float:
    """6*N_active*tokens for training; 2*N_active*tokens for serving."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import LM_SHAPES

    cfg = get_config(arch)
    shape = LM_SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def build(arch: str, shape_name: str, mesh_name: str, chips: int,
          cost: dict, mem: dict, records) -> Roofline:
    """The reference's ``build``: ``cost`` is one device's ``{"flops",
    "bytes accessed"}`` and ``records`` its collectives (:class:`CostMode`'s
    in the port, where the reference parses HLO text)."""
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll = collective_bytes(records)
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=flops * chips if flops > 0 else 0.0,
        hlo_bytes=nbytes * chips if nbytes > 0 else 0.0,
        wire_bytes_per_chip=coll["total"],
        collectives=coll,
        model_flops=model_flops(arch, shape_name),
        bytes_per_device=mem,
    )
