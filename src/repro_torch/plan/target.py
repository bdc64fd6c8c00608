"""Hardware targets: one declarative description of the memory hierarchy the
blocking LP optimizes against (paper §3.2/§5) plus the device mesh the
parallel LP shards over (paper §4.2).

A ``HardwareTarget`` is the single input every planner consumer constructs:
kernels and the dispatcher describe *where* they run with this dataclass and
let ``Planner(target).plan(op)`` decide *how* (tiles, grids).

Field names and the JSON form are those of ``repro.plan.HardwareTarget``, so a
target (and a plan carrying one) written by either package loads in the
other. Two fields keep their names but change meaning here:

  * ``use_pallas=True`` means "the default backend is ``cuda``" (the
    hand-written kernels); False means the ``torch`` (aten) backend;
  * ``interpret`` is ignored: a CUDA kernel has no interpret mode, and the
    CPU path is chosen by the tensor's device, not by the target.

Presets:
  * ``H100``         - one NVIDIA H100 SXM: a CTA's shared memory as the
                       scratchpad and its register file as the accumulator,
                       in the paper's §5 split model (derivation below). The
                       port's default target.
  * ``TPU_V5E``      - 16 MiB unified VMEM, bf16 streams / f32 accumulate,
                       MXU (8, 128) alignment. Kept for planner parity.
  * ``GEMMINI``      - the paper's §5 accelerator: 256 KiB scratchpad (int8)
                       + 64 KiB accumulator (f32), split-buffer mode.
  * ``CPU_INTERPRET``- the reference's correctness target, f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.core.conv_model import BF16_ACC32, FP32, INT8_ACC32, Precision
from repro_torch.core.tiling import MemoryModel, TPU_VMEM_WORDS
from repro_torch.quant.spec import PrecisionSpec

MeshAxes = Tuple[Tuple[str, int], ...]


@dataclasses.dataclass(frozen=True)
class HardwareTarget:
    """Full memory-hierarchy + mesh description of one deployment target.

    Capacities are in the paper's unit (words of 32 bits). ``mesh_axes`` is
    empty for single-device targets; the port's planner does not lower mesh
    targets yet and raises ``NotImplementedError`` for them.
    """

    name: str
    vmem_words: float = float(TPU_VMEM_WORDS)  # scratchpad / shared memory
    acc_words: Optional[float] = None  # separate accumulator ("split" only)
    hbm_words: float = 4 * 2**30 / 4.0  # main-memory capacity
    memory: str = "unified"  # "unified" | "split" (paper eq. 6 vs §5)
    double_buffer: bool = True  # §5: halves usable capacity
    precision: Precision = BF16_ACC32  # default when the OpSpec has none
    interpret: bool = True  # kept for plan JSON; ignored by the port
    use_pallas: bool = False  # True: default backend "cuda", else "torch"
    mesh_axes: MeshAxes = ()  # ((name, size), ...) for multi-device targets
    align_sublane: int = 8  # row / c_I tile multiple (1 = no alignment)
    align_lane: int = 128  # column / c_O tile multiple (1 = no alignment)
    # Optional quantized storage policy; its ``.precision`` projection is
    # what the LP and bounds price when set.
    quant: Optional[PrecisionSpec] = None

    def memory_model(self) -> MemoryModel:
        """The capacity model the blocking LP consumes."""
        return MemoryModel(M=self.vmem_words, M_acc=self.acc_words,
                           mode=self.memory, double_buffer=self.double_buffer)

    @property
    def n_devices(self) -> int:
        out = 1
        for _, size in self.mesh_axes:
            out *= size
        return out

    # -- derived targets ------------------------------------------------------
    def with_mesh(self, axes: Sequence[Tuple[str, int]]) -> "HardwareTarget":
        return dataclasses.replace(
            self, mesh_axes=tuple((str(n), int(s)) for n, s in axes))

    @classmethod
    def from_mesh(cls, mesh: Any, base: Optional["HardwareTarget"] = None
                  ) -> "HardwareTarget":
        """Target whose mesh_axes mirror a conv mesh's axes and sizes
        (``repro_torch.distributed.ConvMesh``; default base ``H100``)."""
        base = base or H100
        return base.with_mesh(tuple(zip(mesh.axis_names, mesh.sizes)))

    def with_precision(self, prec: Precision) -> "HardwareTarget":
        return dataclasses.replace(self, precision=prec)

    def with_vmem(self, vmem_words: float) -> "HardwareTarget":
        return dataclasses.replace(self, vmem_words=float(vmem_words))

    def with_quant(self, spec: Optional[PrecisionSpec]) -> "HardwareTarget":
        """Attach (or clear, with None) a quantized storage policy."""
        return dataclasses.replace(self, quant=spec)

    # -- (de)serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "vmem_words": self.vmem_words,
            "acc_words": self.acc_words,
            "hbm_words": self.hbm_words,
            "memory": self.memory,
            "double_buffer": self.double_buffer,
            "precision": list(self.precision.as_tuple()),
            "interpret": self.interpret,
            "use_pallas": self.use_pallas,
            "mesh_axes": [list(ax) for ax in self.mesh_axes],
            "align_sublane": self.align_sublane,
            "align_lane": self.align_lane,
            "quant": None if self.quant is None else self.quant.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "HardwareTarget":
        return cls(
            name=d["name"],
            vmem_words=float(d["vmem_words"]),
            acc_words=None if d.get("acc_words") is None else float(d["acc_words"]),
            hbm_words=float(d.get("hbm_words", 4 * 2**30 / 4.0)),
            memory=d.get("memory", "unified"),
            double_buffer=bool(d.get("double_buffer", True)),
            precision=Precision(*d.get("precision", (0.5, 0.5, 1.0))),
            interpret=bool(d.get("interpret", True)),
            use_pallas=bool(d.get("use_pallas", False)),
            mesh_axes=tuple((str(n), int(s)) for n, s in d.get("mesh_axes", ())),
            align_sublane=int(d.get("align_sublane", 8)),
            align_lane=int(d.get("align_lane", 128)),
            quant=(None if d.get("quant") is None
                   else PrecisionSpec.from_dict(d["quant"])),
        )


# ---------------------------------------------------------------------------
# Presets.
# ---------------------------------------------------------------------------

# One NVIDIA H100 SXM (sm_90), seen by one CTA of the hand-written kernels,
# in the paper's §5 split-buffer model (as GEMMINI):
#   * scratchpad = the opt-in dynamic shared memory of one block, 232,448
#     bytes = 58,112 words. Input windows and filter blocks live there, at
#     their stream width (bf16 = 0.5 words). double_buffer halves it to
#     29,056 words per stage, the room for two stages of a load ring.
#   * accumulator = registers. 32,768 words halve to M_acc_eff = 16,384 f32
#     accumulators per CTA: 256 threads x 64 registers, the per-thread
#     accumulator the kernels compile in (kernels/csrc/*.cu). The other half
#     of a thread's 255-register budget holds addresses and operands.
#   * hbm_words = 80 GB of HBM3.
#   * align 16 on both tile axes: the bf16 depth of a wgmma/mma.sync K step,
#     so a later tensor-core kernel takes the same plans unchanged.
H100 = HardwareTarget(
    name="h100",
    vmem_words=232448 / 4.0,
    acc_words=32768.0,
    hbm_words=80e9 / 4.0,
    memory="split",
    precision=BF16_ACC32,
    interpret=False,
    use_pallas=True,
    align_sublane=16,
    align_lane=16,
)

TPU_V5E = HardwareTarget(
    name="tpu_v5e",
    vmem_words=float(TPU_VMEM_WORDS),
    hbm_words=16 * 2**30 / 4.0,  # 16 GiB HBM per v5e chip
    memory="unified",
    precision=BF16_ACC32,
    interpret=True,
    use_pallas=True,
)

# GEMMINI defaults from the paper §5: 256 KiB scratchpad of 8-bit words and a
# 64 KiB accumulator of 32-bit words, both double buffered. No lane
# alignment — the systolic array constraint is folded into the LP capacities.
GEMMINI = HardwareTarget(
    name="gemmini",
    vmem_words=256 * 1024 / 4.0,
    acc_words=64 * 1024 / 4.0,
    hbm_words=2**30 / 4.0,  # 1 GiB FireSim DRAM

    memory="split",
    precision=INT8_ACC32,
    interpret=True,
    use_pallas=False,
    align_sublane=1,
    align_lane=1,
)

CPU_INTERPRET = HardwareTarget(
    name="cpu_interpret",
    vmem_words=float(TPU_VMEM_WORDS),
    memory="unified",
    precision=FP32,
    interpret=True,
    use_pallas=False,
)

TARGETS: Dict[str, HardwareTarget] = {
    t.name: t for t in (H100, TPU_V5E, GEMMINI, CPU_INTERPRET)
}


def get_target(name: str) -> HardwareTarget:
    """Look up a preset by name (CLI flags)."""
    try:
        return TARGETS[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware target {name!r}; presets: {sorted(TARGETS)}")
