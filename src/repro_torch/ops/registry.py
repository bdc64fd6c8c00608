"""Backend registry: named backends, per-op entries, declared capabilities
(the counterpart of ``repro.ops.registry`` for conv2d, matmul, attention,
attention_decode, the int8 ops conv2d_q, matmul_q and
attention_decode_quant, and the mamba short conv conv1d_causal).

Each entry's :class:`OpCapabilities` declares its accepted dtypes and the
optional call features (``ATTN_FLAGS``) it serves. Three backends ship:

  * ``torch``  - the aten oracles (``F.conv2d``, ``torch.matmul`` in f32,
                 TF32 off; :func:`torch_attention` and the gathered paged
                 decode). Universal: every dtype and flag. Plays the role of
                 the reference's ``xla``.
  * ``cuda``   - the hand-written CUDA kernels, LP-tiled. Plays the role of
                 ``pallas``. Its entries never call aten for their own work.
                 Like ``pallas``, it has no ``attention_decode_quant``: the
                 int8-pool decode is registered on ``torch`` only, and the
                 model layer requests that backend by name.
                 Its attention entry declares all three flags: unlike the
                 Pallas kernel, the CUDA kernel takes the key mask of padded
                 prefill itself.
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
import numbers
from typing import Callable, Dict, FrozenSet, Optional, Tuple

import torch

from repro_torch.core.conv_model import Precision
from repro_torch.kernels import ref
from repro_torch.kernels.conv1d import (conv1d_access_plan,
                                        conv1d_causal as _conv1d_cuda,
                                        conv1d_hbm_words)
from repro_torch.kernels.conv2d import (_conv_spec, conv2d as _conv2d_cuda,
                                        conv2d_access_plan, conv2d_hbm_words)
from repro_torch.kernels.flash_attention import (NEG_INF, attention_blocks,
                                                 attention_hbm_words,
                                                 flash_attention as _flash_cuda,
                                                 flash_attention_access_plan,
                                                 paged_decode_access_plan,
                                                 paged_decode_attention,
                                                 paged_decode_hbm_words,
                                                 paged_decode_plain)
from repro_torch.kernels.im2col import (conv2d_im2col, im2col_access_plan,
                                        im2col_hbm_words)
from repro_torch.kernels.matmul import (_matmul_spec, matmul as _matmul_cuda,
                                        matmul_access_plan, matmul_hbm_words)
from repro_torch.kernels.quant import (_conv_spec_q, _matmul_spec_q,
                                       conv2d_q as _conv2d_q_cuda,
                                       conv2d_q_access_plan,
                                       conv2d_q_hbm_words,
                                       matmul_q as _matmul_q_cuda,
                                       matmul_q_access_plan,
                                       matmul_q_hbm_words)
from repro_torch.plan import AttentionSpec

# Capability flags a call can require (derived per call in dispatch.*):
#   dynamic_q_offset  - q_offset is a tensor scalar (any in-cache path)
#   per_row_q_offset  - q_offset is a (B,) vector (continuous-batching decode)
#   key_mask          - a (B, Lk) validity mask over the keys (padded prefill)
ATTN_FLAGS = ("dynamic_q_offset", "per_row_q_offset", "key_mask")


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (the capability vocabulary)."""
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class OpCapabilities:
    """What one backend's op entry can serve: its accepted input dtypes
    ("*" = anything) and the optional call features (``flags``) it
    supports. An entry that reads narrow (int8) operands declares the dtype
    it accumulates in (``accum_dtype``), as the reference's do."""

    dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    flags: FrozenSet[str] = frozenset()
    accum_dtype: Optional[str] = None

    def missing(self, dtype: Optional[str] = None,
                needs: Tuple[str, ...] = ()) -> Tuple[str, ...]:
        """The requirements this entry cannot serve (empty = capable)."""
        out = []
        if (dtype is not None and "*" not in self.dtypes
                and dtype not in self.dtypes):
            out.append(f"dtype:{dtype}")
        out.extend(f for f in needs if f not in self.flags)
        return tuple(out)


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
    # structured launch metadata for the static auditor: (ctx, plan,
    # *spec_args, **spec_kw) -> repro_torch.verify.KernelAccessPlan of the
    # CUDA launch the entry makes; the auditor abstractly interprets it and
    # must reproduce words_fn exactly. None = not statically auditable (the
    # aten entries).
    access_plan_fn: Optional[Callable] = None
    # runtime-fault demotion target (repro_torch.ops.dispatch): the backend
    # a TransientFault from this entry degrades the call to, ahead of the
    # backend's CPU-only fallback; the one way off a kernel on the card.
    # None = the fallback on the CPU, a retry in place on the card.
    degrade_to: Optional[str] = None


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


def _torch_conv1d(ctx, plan, x, w):
    return ref.conv1d_causal_ref(x, w)


def torch_attention(q, k, v, causal: bool = True, q_offset=0,
                    key_mask=None) -> torch.Tensor:
    """GQA attention in aten with the grouping kept factored (no KV repeat):
    the counterpart of the reference's ``xla_attention``.

    ``q`` is (B, H, Lq, hd), ``k``/``v`` (B, KV, Lk, hd). ``q_offset`` is the
    absolute position of the first query: an int or tensor scalar for
    lockstep batches, or a (B,) tensor when every row decodes at its own
    depth. ``key_mask`` is an optional (B, Lk) validity mask over the keys.
    Logits, softmax and PV accumulate in f32 (TF32 off); masked logits take
    the finite -1e30, so a fully masked row averages V."""
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    g = H // KV
    dev = q.device
    qg = q.reshape(B, KV, g, Lq, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    with ref.no_tf32():
        logits = torch.einsum("bkgqd,bkld->bkgql", qg.float(),
                              k.float()) * scale.to(dev)
    mask = None
    if causal:
        qpos = torch.arange(Lq, device=dev)
        if isinstance(q_offset, numbers.Integral):
            qpos = (qpos + int(q_offset))[None, :]
        else:
            off = torch.as_tensor(q_offset, device=dev).long()
            qpos = (qpos[None, :] + off[:, None] if off.ndim
                    else (qpos + off)[None, :])
        kpos = torch.arange(Lk, device=dev)
        mask = kpos[None, None, :] <= qpos[:, :, None]  # (B|1, Lq, Lk)
    if key_mask is not None:
        km = key_mask.to(device=dev, dtype=torch.bool)[:, None, :]
        mask = km if mask is None else (mask & km)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    with ref.no_tf32():
        o = torch.einsum("bkgql,bkld->bkgqd", probs, v.float())
    return o.reshape(B, H, Lq, hd).to(q.dtype)


def _torch_attention(ctx, plan, q, k, v, causal=True, q_offset=0,
                     key_mask=None):
    return torch_attention(q, k, v, causal=causal, q_offset=q_offset,
                           key_mask=key_mask)


def _torch_attention_decode(ctx, plan, q, kp, vp, tables, lengths,
                            capacity=None):
    """The counterpart of ``xla_attention_decode``: gather each row's blocks
    (a copy of the live cache) and attend in f32; the paged kernel's plain
    version computes exactly that (``capacity`` shapes only the kernel's
    split)."""
    return paged_decode_plain(q, kp, vp, tables, lengths)


# -- quantized oracles: integer-exact math in f32, scale applied once -------

def _torch_conv2d_q(ctx, plan, x, w, scale, stride=(1, 1),
                    out_dtype=torch.bfloat16):
    out = ref.conv2d_ref(x.float(), w.float(), stride=stride,
                         out_dtype=torch.float32)
    return (out * scale[0][None, :, None, None]).to(out_dtype)


def _torch_matmul_q(ctx, plan, a, b, scale, out_dtype=torch.bfloat16):
    out = ref.matmul_ref(a.float(), b.float(), out_dtype=torch.float32)
    return (out * scale).to(out_dtype)


def _torch_attention_decode_quant(ctx, plan, q, kp, ks, vp, vs, tables,
                                  lengths):
    """Paged decode against an int8-quantized pool (the counterpart of
    ``xla_attention_decode_quant``): ``kp``/``vp`` are (num_blocks, KV, bs,
    hd) int8 and ``ks``/``vs`` the matching (num_blocks, KV, bs) f32
    per-(block, head, position) scales written by the engine's quantizing
    insert. The pool is dequantized in f32; the attention math is then
    exactly the gathered paged decode of :func:`paged_decode_plain`."""
    kf = kp.float() * ks[..., None]
    vf = vp.float() * vs[..., None]
    return paged_decode_plain(q, kf, vf, tables, lengths)


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


def _conv2d_q_plan_spec(x, w, scale=None, stride=(1, 1),
                        out_dtype=torch.bfloat16, **kw):
    N, c_I, H, W = x.shape
    c_O, _, h_F, w_F = w.shape
    sh, sw = stride
    return _conv_spec_q(N, c_I, c_O, (H - h_F) // sh + 1,
                        (W - w_F) // sw + 1, h_F, w_F, sh, sw,
                        x.dtype, w.dtype, out_dtype)


def _matmul_q_plan_spec(a, b, scale=None, out_dtype=torch.bfloat16, **kw):
    m, k = a.shape
    n = b.shape[1]
    return _matmul_spec_q(m, n, k, a.dtype, b.dtype, out_dtype)


def _attention_decode_quant_plan_spec(q, kp, ks, vp, vs, tables, lengths,
                                      **kw):
    """The quantized pool stream priced at its stored width: p_F counts the
    int8 block bytes plus the f32 scale per (head, position) row —
    (0.25 * hd + 1) / hd words per cached element."""
    B, H, _, hd = q.shape
    KV, bs = kp.shape[1], kp.shape[2]
    w = tables.shape[1]
    p_io = q.dtype.itemsize / 4.0
    p_kv = (kp.dtype.itemsize / 4.0) + 1.0 / hd
    return AttentionSpec(B=B, H=H, KV=KV, Lq=1, Lk=w * bs, hd=hd,
                         prec=Precision(p_I=p_io, p_F=p_kv, p_O=p_io))


_INT8 = OpCapabilities(dtypes=("int8",), accum_dtype="float32")
_ANY_F32_ACC = OpCapabilities(dtypes=("*",), accum_dtype="float32")

register_backend(Backend(
    name="torch",
    ops={
        "matmul": OpEntry(_torch_matmul, OpCapabilities(dtypes=("*",))),
        "conv2d": OpEntry(_torch_conv2d, OpCapabilities(dtypes=("*",))),
        "conv1d_causal": OpEntry(_torch_conv1d,
                                 OpCapabilities(dtypes=("*",))),
        "attention": OpEntry(
            _torch_attention,
            OpCapabilities(dtypes=("*",), flags=frozenset(ATTN_FLAGS))),
        "attention_decode": OpEntry(_torch_attention_decode,
                                    OpCapabilities(dtypes=("*",))),
        "attention_decode_quant": OpEntry(
            _torch_attention_decode_quant, _ANY_F32_ACC,
            spec_fn=_attention_decode_quant_plan_spec),
        "conv2d_q": OpEntry(_torch_conv2d_q, _ANY_F32_ACC,
                            spec_fn=_conv2d_q_plan_spec),
        "matmul_q": OpEntry(_torch_matmul_q, _ANY_F32_ACC,
                            spec_fn=_matmul_q_plan_spec),
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


def _attention_plan_spec(q, k, v, **kw):
    B, H, Lq, hd = q.shape
    KV, Lk = k.shape[1], k.shape[2]
    p_io = q.dtype.itemsize / 4.0
    p_kv = k.dtype.itemsize / 4.0
    return AttentionSpec(B=B, H=H, KV=KV, Lq=Lq, Lk=Lk, hd=hd,
                         prec=Precision(p_I=p_io, p_F=p_kv, p_O=p_io))


def _attention_decode_plan_spec(q, kp, vp, tables, lengths, **kw):
    """Paged decode as an AttentionSpec: Lq = 1, Lk = the table window's
    token capacity (w * block_size) — the keys one decode step streams."""
    B, H, _, hd = q.shape
    KV, bs = kp.shape[1], kp.shape[2]
    w = tables.shape[1]
    p_io = q.dtype.itemsize / 4.0
    p_kv = kp.dtype.itemsize / 4.0
    return AttentionSpec(B=B, H=H, KV=KV, Lq=1, Lk=w * bs, hd=hd,
                         prec=Precision(p_I=p_io, p_F=p_kv, p_O=p_io))


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


def _cuda_conv1d(ctx, plan, x, w):
    """No LP plan: the tiles are the target's alignment (the reference's
    closed form, ``kernels.conv1d._conv1d_geometry``)."""
    return _with_aten_grad(
        lambda x_, w_: _conv1d_cuda(x_, w_, target=ctx.target),
        ref.conv1d_causal_ref, x, w)


def _cuda_conv1d_words(ctx, plan, x, w, **kw):
    return conv1d_hbm_words(x, w, target=ctx.target)


def _cuda_attention(ctx, plan, q, k, v, causal=True, q_offset=0,
                    key_mask=None):
    """GQA via group folding: the g query heads sharing one KV head are
    stacked along the query axis ((B*Hkv, g*Lq, Dh)), so K/V stream at their
    (B*Hkv, Lk, Dh) size; the kernel recovers positions with ``q_seq_len``.
    An int ``q_offset`` is the static case, a tensor scalar or (B,) tensor
    the dynamic one (one int32 per folded row); the key mask rides along."""
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = H // Hkv
    row_offs = q_offset
    if torch.is_tensor(q_offset) and q_offset.ndim:
        # row b*Hkv+j: batch b (an expand, no host read: capturable)
        row_offs = q_offset[:, None].expand(B, Hkv).reshape(-1)

    def fwd(q_, k_, v_):
        out = _flash_cuda(q_.reshape(B * Hkv, g * Lq, Dh).contiguous(),
                          k_.reshape(B * Hkv, Lk, Dh).contiguous(),
                          v_.reshape(B * Hkv, Lk, Dh).contiguous(),
                          causal=causal, q_offset=row_offs, q_seq_len=Lq,
                          target=ctx.target, key_mask=key_mask)
        return out.reshape(B, H, Lq, Dh)

    return _with_aten_grad(
        fwd, lambda q_, k_, v_: torch_attention(
            q_, k_, v_, causal=causal, q_offset=q_offset, key_mask=key_mask),
        q, k, v)


def _cuda_attention_decode(ctx, plan, q, kp, vp, tables, lengths,
                           capacity=None):
    """Paged decode on the block-table-walking kernel, its split over the
    table ``capacity``; backward recomputes through the gathered aten
    version."""
    return _with_aten_grad(
        lambda q_, kp_, vp_: paged_decode_attention(q_, kp_, vp_, tables,
                                                    lengths, capacity),
        lambda q_, kp_, vp_: paged_decode_plain(q_, kp_, vp_, tables,
                                                lengths), q, kp, vp)


def _cuda_attention_words(ctx, plan, q, k, v, **kw):
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = H // Hkv
    p_io = q.dtype.itemsize / 4.0
    p_kv = k.dtype.itemsize / 4.0
    bq, bk = attention_blocks(Dh, ctx.target, kv_word=p_kv)
    return attention_hbm_words(B * Hkv, g * Lq, Lk, Dh, bq, bk,
                               p_q=p_io, p_kv=p_kv, p_o=p_io)


def _cuda_attention_decode_words(ctx, plan, q, kp, vp, tables, lengths,
                                 **kw):
    B, H, _, hd = q.shape
    KV, bs = kp.shape[1], kp.shape[2]
    p_io = q.dtype.itemsize / 4.0
    p_kv = kp.dtype.itemsize / 4.0
    return paged_decode_hbm_words(B, KV, H // KV, tables.shape[1], bs, hd,
                                  p_q=p_io, p_kv=p_kv, p_o=p_io)


def _cuda_matmul_words(ctx, plan, a, b, out_dtype=None, **kw):
    return matmul_hbm_words(a, b, plan=plan, target=ctx.target,
                            out_dtype=out_dtype or ctx.acc_dtype)


def _cuda_conv2d_words(ctx, plan, x, w, stride=(1, 1), out_dtype=None, **kw):
    return conv2d_hbm_words(x, w, stride=stride, plan=plan,
                            target=ctx.target,
                            out_dtype=out_dtype or ctx.acc_dtype)


def _cuda_conv2d_q(ctx, plan, x, w, scale, stride=(1, 1),
                   out_dtype=torch.bfloat16):
    """No autograd wrapper: the quantized entries are the inference path,
    as in the reference (int8 operands carry no meaningful gradient)."""
    return _conv2d_q_cuda(x, w, scale, stride=stride, out_dtype=out_dtype,
                          plan=plan)


def _cuda_matmul_q(ctx, plan, a, b, scale, out_dtype=torch.bfloat16):
    return _matmul_q_cuda(a, b, scale, out_dtype=out_dtype, plan=plan)


def _cuda_conv2d_q_words(ctx, plan, x, w, scale=None, stride=(1, 1),
                         out_dtype=torch.bfloat16, **kw):
    return conv2d_q_hbm_words(x, w, scale, stride=stride, plan=plan,
                              target=ctx.target, out_dtype=out_dtype)


def _cuda_matmul_q_words(ctx, plan, a, b, scale=None,
                         out_dtype=torch.bfloat16, **kw):
    return matmul_q_hbm_words(a, b, scale, plan=plan, target=ctx.target,
                              out_dtype=out_dtype)


# -- access plans (repro_torch.verify): the CUDA launch each entry makes, as
# structured data the static auditor can abstractly interpret --------------

def _cuda_matmul_access(ctx, plan, a, b, out_dtype=None, **kw):
    return matmul_access_plan(a, b, plan=plan, target=ctx.target,
                              out_dtype=out_dtype or ctx.acc_dtype)


def _cuda_conv2d_access(ctx, plan, x, w, stride=(1, 1), out_dtype=None,
                        **kw):
    return conv2d_access_plan(x, w, stride=stride, plan=plan,
                              target=ctx.target,
                              out_dtype=out_dtype or ctx.acc_dtype)


def _cuda_conv1d_access(ctx, plan, x, w, **kw):
    return conv1d_access_plan(x, w, target=ctx.target)


def _cuda_attention_access(ctx, plan, q, k, v, **kw):
    # the launch over the GQA-folded view (_cuda_attention)
    B, H, Lq, Dh = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    g = H // Hkv
    p_io = q.dtype.itemsize / 4.0
    p_kv = k.dtype.itemsize / 4.0
    bq, bk = attention_blocks(Dh, ctx.target, kv_word=p_kv)
    return flash_attention_access_plan(B * Hkv, g * Lq, Lk, Dh, bq, bk,
                                       p_q=p_io, p_kv=p_kv, p_o=p_io)


def _host_ints(t):
    """A real tensor's values on the host (None for a meta tensor: only
    its shape is known)."""
    return None if t.device.type == "meta" else t.detach().cpu().tolist()


def _cuda_attention_decode_access(ctx, plan, q, kp, vp, tables, lengths,
                                  capacity=None, **kw):
    # concrete lengths and tables when the call has them (the kernel skips
    # dead slots); meta tensors model every slot live
    B, H, _, hd = q.shape
    KV, bs = kp.shape[1], kp.shape[2]
    p_io = q.dtype.itemsize / 4.0
    p_kv = kp.dtype.itemsize / 4.0
    return paged_decode_access_plan(
        B, KV, H // KV, tables.shape[1], bs, hd, num_blocks=kp.shape[0],
        p_q=p_io, p_kv=p_kv, p_o=p_io, tables=_host_ints(tables),
        lengths=_host_ints(lengths), capacity=capacity)


def _cuda_conv2d_q_access(ctx, plan, x, w, scale=None, stride=(1, 1),
                          out_dtype=torch.bfloat16, **kw):
    return conv2d_q_access_plan(x, w, scale, stride=stride, plan=plan,
                                target=ctx.target, out_dtype=out_dtype)


def _cuda_matmul_q_access(ctx, plan, a, b, scale=None,
                          out_dtype=torch.bfloat16, **kw):
    return matmul_q_access_plan(a, b, scale, plan=plan, target=ctx.target,
                                out_dtype=out_dtype)


register_backend(Backend(
    name="cuda",
    fallback="torch",
    ops={
        "matmul": OpEntry(_cuda_matmul, spec_fn=_matmul_plan_spec,
                          words_fn=_cuda_matmul_words,
                          access_plan_fn=_cuda_matmul_access),
        # runtime faults demote to the instrumented Im2Col baseline (not
        # to aten, which the card never falls back to) so the 2.5-4.0x
        # words cost of degradation stays measured
        "conv2d": OpEntry(_cuda_conv2d, spec_fn=_conv2d_plan_spec,
                          words_fn=_cuda_conv2d_words,
                          access_plan_fn=_cuda_conv2d_access,
                          degrade_to="im2col"),
        "conv1d_causal": OpEntry(_cuda_conv1d, words_fn=_cuda_conv1d_words,
                                 access_plan_fn=_cuda_conv1d_access),
        "attention": OpEntry(
            _cuda_attention, OpCapabilities(flags=frozenset(ATTN_FLAGS)),
            spec_fn=_attention_plan_spec, words_fn=_cuda_attention_words,
            access_plan_fn=_cuda_attention_access),
        "attention_decode": OpEntry(
            _cuda_attention_decode, spec_fn=_attention_decode_plan_spec,
            words_fn=_cuda_attention_decode_words,
            access_plan_fn=_cuda_attention_decode_access),
        # int8 streams only (f32/bf16 callers use the full-precision ops)
        "conv2d_q": OpEntry(_cuda_conv2d_q, _INT8,
                            spec_fn=_conv2d_q_plan_spec,
                            words_fn=_cuda_conv2d_q_words,
                            access_plan_fn=_cuda_conv2d_q_access),
        "matmul_q": OpEntry(_cuda_matmul_q, _INT8,
                            spec_fn=_matmul_q_plan_spec,
                            words_fn=_cuda_matmul_q_words,
                            access_plan_fn=_cuda_matmul_q_access),
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


def _im2col_conv2d_access(ctx, plan, x, w, stride=(1, 1), out_dtype=None,
                          **kw):
    return im2col_access_plan(x, w, stride=stride, target=ctx.target,
                              out_dtype=out_dtype or ctx.acc_dtype)


register_backend(Backend(
    name="im2col",
    fallback="torch",
    ops={
        # spec_fn resolves the same conv plan as the direct path so the
        # decision reports the identical Thm 2.1 lower bound; the GEMM's own
        # matmul plan is solved inside conv2d_im2col (memoized).
        "conv2d": OpEntry(_im2col_conv2d, spec_fn=_conv2d_plan_spec,
                          words_fn=_im2col_conv2d_words,
                          access_plan_fn=_im2col_conv2d_access),
    },
))
