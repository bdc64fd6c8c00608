"""ExecutionContext: the single execution-policy object of the port (the
counterpart of ``repro.ops.context``).

It bundles the inputs of the per-(op, target) decision "which implementation
runs, with which tiles, at which precision, on which device":

  * ``target``  - the :class:`repro_torch.plan.HardwareTarget` whose memory
                  model the blocking LP plans against (default ``H100``) and
                  whose ``precision`` policy sets stream/accumulator dtypes;
  * ``backend`` - an explicit backend (``"torch"`` | ``"cuda"`` |
                  ``"im2col"``). ``None`` defers to ``REPRO_TORCH_BACKEND``
                  and then to the target (``use_pallas`` -> ``"cuda"``);
  * ``autotune`` - the measured-autotune policy (``None``/``False`` = off,
                  ``True`` = the default
                  :class:`repro_torch.plan.AutotunePolicy`, or a policy):
                  a searchable op with no tuning record is searched once;
  * ``device``  - where the entry points run: ``"cuda"`` (the default) or
                  ``"cpu"``. A context for ``"cuda"`` on a machine without a
                  GPU raises ``DeviceLost`` at construction; nothing falls
                  back to the CPU.
                  On ``"cpu"`` every kernel wrapper runs its plain version.

Plans are resolved through ``repro_torch.plan.resolve_plan``, backed by the
process-wide memoized cache, so every consumer of one context converges on
identical ``ExecutionPlan`` objects.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch

from repro_torch.plan import H100, HardwareTarget
from repro_torch.resilience.errors import DeviceLost

BACKEND_ENV = "REPRO_TORCH_BACKEND"
BACKEND_NAMES = ("torch", "cuda", "im2col")

# Paper word-widths (units of 32-bit words) -> torch dtypes.
_WORD_DTYPES = {1.0: torch.float32, 0.5: torch.bfloat16, 0.25: torch.int8}


def dtype_for_words(words: float):
    """The torch dtype of a paper word-width (1.0 -> f32, 0.5 -> bf16, ...)."""
    try:
        return _WORD_DTYPES[float(words)]
    except KeyError:
        raise ValueError(f"no dtype for precision {words} words; "
                         f"known: {sorted(_WORD_DTYPES)}")


def env_backend() -> Optional[str]:
    """Backend requested via ``REPRO_TORCH_BACKEND=torch|cuda|im2col``, or
    None."""
    name = os.environ.get(BACKEND_ENV)
    if name:
        name = name.strip().lower()
        if name not in BACKEND_NAMES:
            raise ValueError(
                f"{BACKEND_ENV}={name!r} is not a known backend "
                f"(expected one of {BACKEND_NAMES})")
        return name
    return None


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """HardwareTarget + precision policy + backend + device. Frozen and
    hashable."""

    target: HardwareTarget = H100
    backend: Optional[str] = None  # "torch" | "cuda" | "im2col" | None
    autotune: Any = None  # None/False | True | repro_torch.plan.AutotunePolicy
    device: str = "cuda"

    def __post_init__(self):
        kind = torch.device(self.device).type
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be 'cuda' or 'cpu', got "
                             f"{self.device!r}")
        if kind == "cuda" and not torch.cuda.is_available():
            raise DeviceLost(
                "ExecutionContext(device='cuda') but no CUDA device is "
                "available; pass device='cpu' to run the plain versions")

    # -- backend resolution ---------------------------------------------------
    def resolved_backend(self) -> str:
        if self.backend is not None:
            return self.backend
        return env_backend() or ("cuda" if self.target.use_pallas else "torch")

    # -- plan-cache handle ----------------------------------------------------
    def plan(self, op, explicit=None):
        """Resolve the ExecutionPlan for ``op`` on this context's target,
        honouring this context's autotune policy."""
        return self.plan_with_source(op, explicit=explicit)[0]

    def plan_with_source(self, op, explicit=None) -> Tuple[Any, str]:
        """``(plan, source)`` with source ``"explicit"`` | ``"tuned"`` |
        ``"analytic"``."""
        from repro_torch.plan import resolve_plan

        return resolve_plan(op, self.target, explicit=explicit,
                            autotune=self.autotune)

    # -- precision policy -----------------------------------------------------
    @property
    def stream_dtype(self):
        """Input/filter stream dtype from the target's precision policy."""
        return dtype_for_words(self.target.precision.p_I)

    @property
    def acc_dtype(self):
        """Output/accumulator dtype from the target's precision policy (the
        default ``out_dtype`` of every dispatched op)."""
        return dtype_for_words(self.target.precision.p_O)


def default_context() -> ExecutionContext:
    """The context used when a consumer passes ``ctx=None``: the H100 target
    on the card, with the backend from ``REPRO_TORCH_BACKEND`` or else the
    target's (``cuda``). Raises where there is no GPU."""
    return ExecutionContext(target=H100, backend=env_backend())
