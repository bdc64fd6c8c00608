"""Roofline terms of one NVIDIA H100 SXM (the counterpart of
``repro.analysis.roofline``'s time model).

    compute term = operations / peak rate of their type
    memory term  = bytes / HBM_BW

The reference prices a TPU v5e. Here every constant is the H100's, from
NVIDIA's data sheet (SXM part, dense rates, 700 W): an assumption until the
card measures it. ``chip_smoke.py`` reads its bounds from this module, and
``repro_torch.plan.autotune`` its offline cost model
(:func:`alpha_beta_seconds`).

The reference's HLO readers (``collective_bytes``, ``Roofline``,
``model_flops``, ``build``) need the multi-device path and are not ported.
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM, data-sheet figures (assumed, not measured on the card)
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
PEAK_INT8_OPS = 1979e12  # int8 tensor-core OP/s
PEAK_F32_FLOPS = 67e12  # float32 FLOP/s outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s

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
