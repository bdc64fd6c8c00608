"""``repro_torch.ops`` — backend-registry op dispatch (ExecutionContext ->
Backend -> kernel), the counterpart of ``repro.ops`` for conv2d, matmul,
attention, attention_decode, the int8 ops conv2d_q, matmul_q and
attention_decode_quant, and conv1d_causal.

    from repro_torch import ops
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100

    ctx = ExecutionContext(target=H100, backend="cuda")   # on the card
    y = ops.conv2d(x, w, stride=(1, 1), ctx=ctx)          # hand-written kernel
    d = ops.explain("conv2d", ctx, spec_args=(x, w),
                    spec_kw={"stride": (1, 1), "out_dtype": torch.float32})
    d.measured_words, d.bound_ratio                       # vs Thm 2.1

Backends (``repro_torch.ops.registry``): ``torch`` (aten oracles),
``cuda`` (the hand-written kernels) and ``im2col`` (the paper's baseline
conv). A call a backend cannot serve falls back to ``torch`` only under
``device="cpu"``; on the card it raises. ``REPRO_TORCH_BACKEND=torch|cuda|im2col`` selects one
from the environment. A runtime ``TransientFault`` quarantines the entry
and demotes the call (a ``cuda`` conv to ``im2col``; on the card never to
``torch``), re-priced in its decision (``degraded``/``fault``);
``REPRO_FAULTS`` or ``resilience.activate`` plant such faults.
"""

from .context import (  # noqa: F401
    BACKEND_ENV,
    ExecutionContext,
    default_context,
    dtype_for_words,
    env_backend,
)
from .dispatch import (  # noqa: F401
    MAX_RUNTIME_ATTEMPTS,
    QUARANTINE_PROBE_AFTER,
    DispatchDecision,
    attention,
    attention_decode,
    attention_decode_quant,
    attention_needs,
    clear_quarantine,
    conv1d_causal,
    conv2d,
    conv2d_q,
    dispatch_call,
    explain,
    matmul,
    matmul_q,
    quarantined,
    record_dispatch,
    resolve,
    set_fault_hook,
    traced,
)
from .registry import (  # noqa: F401
    Backend,
    OpCapabilities,
    OpEntry,
    backends,
    get_backend,
    register_backend,
    registered_ops,
    torch_attention,
)
