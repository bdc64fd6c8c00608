"""Backend registry: named backends, per-op entries, declared capabilities
(the counterpart of ``repro.ops.registry``, conv2d and matmul only).

Three backends ship:

  * ``torch``  - the aten oracles (``F.conv2d``, ``torch.matmul`` in f32,
                 TF32 off). Universal: every dtype. Plays the role of the
                 reference's ``xla``.
  * ``cuda``   - the hand-written CUDA kernels, LP-tiled. Plays the role of
                 ``pallas``. Its entries never call aten for their own work.
  * ``im2col`` - the paper's baseline conv algorithm (aten patch expansion
                 -> the hand-written GEMM), conv2d only.

A backend's ``fallback`` serves the calls it cannot (an op it lacks, a dtype
it does not take) only under a ``device="cpu"`` context. On the card the
dispatcher raises instead: nothing stands in for a hand-written kernel there.

Adapters take ``(ctx, plan, *args, **kw)``: ``plan`` is the ExecutionPlan the
dispatcher resolved from the entry's ``spec_fn``. An instrumented entry
declares a ``words_fn`` — the measured-HBM-words counter of the launch
geometry — which the dispatcher places next to the plan's Thm 2.1 bound.

Gradients: each ``cuda``/``im2col`` entry runs its kernel forward inside a
``torch.autograd.Function`` whose backward recomputes through the aten oracle
(the reference's ``_with_xla_vjp``); there is no backward kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.conv2d import (_conv_spec, conv2d as _conv2d_cuda,
                                        conv2d_hbm_words)
from repro_torch.kernels.im2col import conv2d_im2col, im2col_hbm_words
from repro_torch.kernels.matmul import (_matmul_spec, matmul as _matmul_cuda,
                                        matmul_hbm_words)


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the capability vocabulary)."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class OpCapabilities:
    """What one backend's op entry can serve: its accepted input dtypes
    ("*" = anything)."""

    dtypes: Tuple[str, ...] = ("float32", "bfloat16")

    def missing(self, dtype: Optional[str] = None) -> Tuple[str, ...]:
        """The requirements this entry cannot serve (empty = capable)."""
        if dtype is None or "*" in self.dtypes or dtype in self.dtypes:
            return ()
        return (f"dtype:{dtype}",)


@dataclasses.dataclass(frozen=True)
class OpEntry:
    """One backend's implementation of one op."""

    fn: Callable  # (ctx, plan, *args, **kw) -> result
    caps: OpCapabilities = OpCapabilities()
    # builds the planner OpSpec from the call's tensors; None = no LP plan
    spec_fn: Optional[Callable] = None
    # measured HBM words the kernel's launch geometry moves for this call:
    # (ctx, plan, *spec_args, **spec_kw) -> float. None = not instrumented.
    words_fn: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class Backend:
    """A named op table and the backend that serves its misses on the CPU."""

    name: str
    ops: Dict[str, OpEntry]
    fallback: Optional[str] = None  # device="cpu" only; the card raises


_BACKENDS: Dict[str, Backend] = {}


def register_backend(backend: Backend) -> Backend:
    if not backend.ops:
        raise ValueError(f"backend {backend.name!r} registers no ops")
    _BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; "
                       f"registered: {sorted(_BACKENDS)}")


def backends() -> Tuple[str, ...]:
    return tuple(sorted(_BACKENDS))


def registered_ops() -> Tuple[str, ...]:
    """Op names dispatchable from any backend."""
    names = set()
    for b in _BACKENDS.values():
        names |= set(b.ops)
    return tuple(sorted(names))


# ---------------------------------------------------------------------------
# torch backend: the aten oracles.
# ---------------------------------------------------------------------------

def _torch_matmul(ctx, plan, a, b, out_dtype=torch.float32):
    return ref.matmul_ref(a, b, out_dtype=out_dtype)


def _torch_conv2d(ctx, plan, x, w, stride=(1, 1), out_dtype=torch.float32):
    return ref.conv2d_ref(x, w, stride=stride, out_dtype=out_dtype)


register_backend(Backend(
    name="torch",
    ops={
        "matmul": OpEntry(_torch_matmul, OpCapabilities(dtypes=("*",))),
        "conv2d": OpEntry(_torch_conv2d, OpCapabilities(dtypes=("*",))),
    },
))


# ---------------------------------------------------------------------------
# Kernel forward, aten-recompute backward.
# ---------------------------------------------------------------------------

class _KernelWithAtenGrad(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd through the aten oracle on
    the saved inputs."""

    @staticmethod
    def forward(fctx, kernel_fn, ref_fn, *tensors):
        fctx.ref_fn = ref_fn
        fctx.save_for_backward(*tensors)
        return kernel_fn(*tensors)

    @staticmethod
    def backward(fctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(fctx.saved_tensors, fctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = fctx.ref_fn(*inputs)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, grad))
        return (None, None, *[next(grads) if t.requires_grad else None
                              for t in inputs])


def _with_aten_grad(kernel_fn: Callable, ref_fn: Callable, *tensors):
    """Run ``kernel_fn(*tensors)``; when a gradient is wanted, define it by
    autograd through ``ref_fn`` (both close over their static config)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _KernelWithAtenGrad.apply(kernel_fn, ref_fn, *tensors)
    return kernel_fn(*tensors)


# -- plan specs from call tensors (shared by the instrumented entries) ------

def _matmul_plan_spec(a, b, **kw):
    m, k = a.shape
    n = b.shape[1]
    return _matmul_spec(m, n, k, a.dtype.itemsize * 8)


def _conv2d_plan_spec(x, w, stride=(1, 1), **kw):
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    return _conv_spec(N, c_I, c_O, (H - h_F) // sh + 1, (W - w_F) // sw + 1,
                      h_F, w_F, sh, sw, x.dtype.itemsize * 8)


# ---------------------------------------------------------------------------
# cuda backend: the hand-written kernels, tiled by the plan the dispatcher
# resolved.
# ---------------------------------------------------------------------------

def _cuda_matmul(ctx, plan, a, b, out_dtype=torch.float32):
    return _with_aten_grad(
        lambda a_, b_: _matmul_cuda(a_, b_, out_dtype=out_dtype, plan=plan),
        lambda a_, b_: ref.matmul_ref(a_, b_, out_dtype=out_dtype), a, b)


def _cuda_conv2d(ctx, plan, x, w, stride=(1, 1), out_dtype=torch.float32):
    return _with_aten_grad(
        lambda x_, w_: _conv2d_cuda(x_, w_, stride=stride,
                                    out_dtype=out_dtype, plan=plan),
        lambda x_, w_: ref.conv2d_ref(x_, w_, stride=stride,
                                      out_dtype=out_dtype), x, w)


def _cuda_matmul_words(ctx, plan, a, b, out_dtype=None, **kw):
    return matmul_hbm_words(a, b, plan=plan, target=ctx.target,
                            out_dtype=out_dtype or ctx.acc_dtype)


def _cuda_conv2d_words(ctx, plan, x, w, stride=(1, 1), out_dtype=None, **kw):
    return conv2d_hbm_words(x, w, stride=stride, plan=plan,
                            target=ctx.target,
                            out_dtype=out_dtype or ctx.acc_dtype)


register_backend(Backend(
    name="cuda",
    fallback="torch",
    ops={
        "matmul": OpEntry(_cuda_matmul, spec_fn=_matmul_plan_spec,
                          words_fn=_cuda_matmul_words),
        "conv2d": OpEntry(_cuda_conv2d, spec_fn=_conv2d_plan_spec,
                          words_fn=_cuda_conv2d_words),
    },
))


# ---------------------------------------------------------------------------
# im2col backend: the paper's baseline conv algorithm (aten patches, GEMM on
# the hand-written matmul). Its missing matmul goes to torch on the CPU only.
# ---------------------------------------------------------------------------

def _im2col_conv2d(ctx, plan, x, w, stride=(1, 1), out_dtype=torch.float32):
    return _with_aten_grad(
        lambda x_, w_: conv2d_im2col(x_, w_, stride=stride,
                                     out_dtype=out_dtype, ctx=ctx),
        lambda x_, w_: ref.conv2d_ref(x_, w_, stride=stride,
                                      out_dtype=out_dtype), x, w)


def _im2col_conv2d_words(ctx, plan, x, w, stride=(1, 1), out_dtype=None,
                         **kw):
    return im2col_hbm_words(x, w, stride=stride, target=ctx.target,
                            out_dtype=out_dtype or ctx.acc_dtype)


register_backend(Backend(
    name="im2col",
    fallback="torch",
    ops={
        # spec_fn resolves the same conv plan as the direct path so the
        # decision reports the identical Thm 2.1 lower bound; the GEMM's own
        # matmul plan is solved inside conv2d_im2col (memoized).
        "conv2d": OpEntry(_im2col_conv2d, spec_fn=_conv2d_plan_spec,
                          words_fn=_im2col_conv2d_words),
    },
))
