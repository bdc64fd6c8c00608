"""``repro_torch.verify.lint`` — structural invariants over the port's source
tree and op registry, the port of ``repro.verify.lint``. Stdlib-only
(``ast`` + ``inspect``); run as

    PYTHONPATH=src python -m repro_torch.verify.lint [root ...]

and exits 1 on any violation.

Source rules (AST, so prose in comments/docstrings never trips them):

  VRF001  a CUDA launch outside ``kernels/``: constructing a ``CudaKernel``
          or loading a library through ``ctypes`` (``CDLL``,
          ``LoadLibrary``). Every launch lives in the kernel layer, where
          its wrapper counts it and declares a words_fn and access plan.
  VRF002  a CUDA source (``.cu``, ``.cuh``) outside ``kernels/`` — a kernel
          no wrapper builds, counts or audits.
  VRF003  ``repeat``/``repeat_interleave``/``expand`` of a KV-named tensor
          outside ``kernels/`` — GQA wrappers that materialize repeated K/V
          move g x the traffic; the dispatch layer keeps heads factored.
  VRF013  (kernels/ only) ``<acc...>.to(<narrow dtype>)`` (or ``.type``,
          ``.astype``) — casting an accumulator below 32 bits trades the
          quantization error model for a lossy one. Casting the final
          store to a dynamic dtype (``x.dtype``, ``out_dtype``) is fine.
  VRF014  (repro_torch/{ops,serving,distributed}/ only) ``raise
          RuntimeError`` — runtime layers raise the
          ``repro_torch.resilience.errors`` taxonomy so handlers can route
          on recoverability. Re-raises and other exception types are
          untouched.

  The reference's VRF015 (legacy ``plan=``/``target=``/``tiles=`` kernel
  kwargs outside ``kernels/``) is not ported: the port's kernel entries
  never had the reference's one-release shims (no ``interpret=``, no
  ``target=`` but on conv1d; ``tiles=`` and ``plan=`` are their explicit
  handoff, a deliberate difference listed in ROADMAP.md queue 3), so
  there is no retired kwarg to police.

Registry rules (imported live, so they track what is actually registered):

  VRF010  every op entry of an instrumented backend (one with a fallback,
          i.e. not the terminal ``torch`` tier) declares a ``words_fn``.
  VRF011  every ``words_fn`` entry also declares an ``access_plan_fn`` so
          the static auditor can cross-check it — except ``*_dist`` ops.
  VRF012  declared capability flags match the entry fn's signature.
  VRF013  every entry whose declared dtypes include a sub-word storage
          format (int8 / fp8) also declares ``caps.accum_dtype`` at 32 bits
          or wider.
  VRF016  no aten compute in a ``cuda`` entry: the functions the ``cuda``
          backend registers, and the ``repro_torch`` functions they call
          (the kernel wrappers and their launches), call no torch GEMM,
          convolution, attention or softmax (``torch.matmul``, ``@``,
          ``F.conv2d``, ``scaled_dot_product_attention``, ``torch._int_mm``
          ...): that is cuBLAS, cuDNN or SDPA doing the kernel's work. The
          backward recompute (the second argument of ``_with_aten_grad``),
          the ``*_plain`` versions and ``kernels/ref.py`` are exempt: they
          are the aten oracles, and run on the CPU or in the backward only.
"""

from __future__ import annotations

import ast
import dataclasses
import inspect
import sys
import textwrap
import types
from pathlib import Path
from typing import List, Optional, Sequence

# tensors whose repeat re-materializes a KV cache (VRF003)
_KV_NAMES = frozenset({
    "k", "v", "kp", "vp", "kk", "vv", "key", "value", "keys", "values",
    "k_cache", "v_cache", "k_pool", "v_pool", "k_pages", "v_pages",
})
_REPEATS = frozenset({"repeat", "repeat_interleave", "expand"})

# capability flag -> parameter the entry fn must accept (VRF012)
_FLAG_PARAMS = {
    "dynamic_q_offset": "q_offset",
    "per_row_q_offset": "q_offset",
    "key_mask": "key_mask",
}

# storage dtypes that demand a declared accumulation dtype (VRF013)
_QUANT_DTYPES = frozenset({
    "int8", "uint8", "float8_e4m3fn", "float8_e5m2", "fp8", "int4",
})
# dtype literals an accumulator must never be cast down to (VRF013)
_NARROW_DTYPES = frozenset({
    "bfloat16", "float16", "half", "int8", "uint8", "float8_e4m3fn",
    "float8_e5m2",
})
_CASTS = frozenset({"to", "type", "astype"})
# accumulation dtypes wide enough to satisfy VRF013
_WIDE_ACCUM = frozenset({"float32", "float64", "int32", "int64"})

# the ctypes loaders a CUDA launch goes through (VRF001)
_LOADERS = frozenset({"CudaKernel", "CDLL", "LoadLibrary"})
# torch calls that do a kernel's compute (VRF016)
_ATEN_COMPUTE = frozenset({
    "matmul", "mm", "bmm", "einsum", "addmm", "baddbmm", "linear",
    "conv1d", "conv2d", "conv3d", "convolution", "conv_transpose2d",
    "scaled_dot_product_attention", "_int_mm", "softmax", "log_softmax",
    "cudnn_convolution", "tensordot",
})
# tensor methods that do a kernel's compute (VRF016)
_ATEN_METHODS = frozenset({"matmul", "mm", "bmm", "softmax", "__matmul__"})


@dataclasses.dataclass(frozen=True)
class Violation:
    code: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


def _terminal_name(node: ast.AST) -> Optional[str]:
    """`x` -> "x", `a.b.kv` -> "kv"; None for anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _base_name(node: ast.AST) -> Optional[str]:
    """Like :func:`_terminal_name` but seeing through subscripts and calls,
    so ``acc[...]`` and ``acc.sum()`` both resolve to their base name."""
    while isinstance(node, (ast.Subscript, ast.Call)):
        node = node.value if isinstance(node, ast.Subscript) else node.func
    return _terminal_name(node)


def _narrow_dtype_literal(node: ast.AST) -> Optional[str]:
    """The narrow-dtype name if ``node`` is a literal like
    ``torch.bfloat16`` or ``"int8"``; None for dynamic expressions such as
    ``x.dtype`` or ``out_dtype``."""
    name = None
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id in ("torch", "np", "numpy"):
        name = node.attr
    elif isinstance(node, ast.Constant) and isinstance(node.value, str):
        name = node.value
    return name if name in _NARROW_DTYPES else None


class _Checker(ast.NodeVisitor):
    def __init__(self, rel: str, in_kernels: bool, in_runtime: bool = False):
        self.rel = rel
        self.in_kernels = in_kernels
        self.in_runtime = in_runtime
        self.found: List[Violation] = []

    def visit_Raise(self, node: ast.Raise) -> None:
        if self.in_runtime and node.exc is not None:
            raised = node.exc
            if isinstance(raised, ast.Call):
                raised = raised.func
            if _terminal_name(raised) == "RuntimeError":
                self.found.append(Violation(
                    "VRF014", self.rel, node.lineno,
                    "bare RuntimeError in a runtime layer — raise a "
                    "repro_torch.resilience.errors fault (transient/fatal "
                    "classified, diagnostics attached)"))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        callee = _terminal_name(node.func)
        if self.in_kernels:
            if (callee in _CASTS and isinstance(node.func, ast.Attribute)
                    and node.args):
                base = _base_name(node.func.value)
                narrow = _narrow_dtype_literal(node.args[0])
                if base is not None and "acc" in base and narrow is not None:
                    self.found.append(Violation(
                        "VRF013", self.rel, node.lineno,
                        f"accumulator {base!r} cast down to {narrow} — "
                        "accumulate in 32 bits, cast only the final store"))
        else:
            if callee in _LOADERS:
                self.found.append(Violation(
                    "VRF001", self.rel, node.lineno,
                    f"{callee} outside kernels/ (an uncounted, unaudited "
                    "CUDA launch)"))
            elif callee in _REPEATS:
                target = None
                if isinstance(node.func, ast.Attribute):
                    target = _terminal_name(node.func.value)
                    if target in ("torch", None) and node.args:
                        target = _terminal_name(node.args[0])
                if target in _KV_NAMES:
                    self.found.append(Violation(
                        "VRF003", self.rel, node.lineno,
                        f"{callee} of KV tensor {target!r} re-materializes "
                        "the cache (keep GQA heads factored)"))
        self.generic_visit(node)


def lint_file(path: Path, repo_root: Path) -> List[Violation]:
    rel = str(path.relative_to(repo_root)) if path.is_relative_to(repo_root) \
        else str(path)
    parts = set(path.parts)
    in_kernels = "kernels" in parts
    if path.suffix in (".cu", ".cuh"):
        if in_kernels:
            return []
        return [Violation("VRF002", rel, 0, "CUDA source outside kernels/ "
                          "(a kernel no wrapper builds, counts or audits)")]
    try:
        tree = ast.parse(path.read_text(), filename=rel)
    except SyntaxError as e:  # pragma: no cover - broken file
        return [Violation("VRF000", rel, e.lineno or 0, f"syntax error: {e.msg}")]
    checker = _Checker(
        rel, in_kernels=in_kernels,
        in_runtime="repro_torch" in parts
        and bool(parts & {"ops", "serving", "distributed"}))
    checker.visit(tree)
    return checker.found


def lint_sources(roots: Sequence[Path], repo_root: Path) -> List[Violation]:
    out: List[Violation] = []
    for root in roots:
        if root.is_dir():
            files = sorted(p for ext in ("*.py", "*.cu", "*.cuh")
                           for p in root.rglob(ext))
        else:
            files = [root]
        for f in files:
            out.extend(lint_file(f, repo_root))
    return out


def _accepts(fn, param: str) -> bool:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # pragma: no cover - builtins
        return True
    if param in sig.parameters:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in sig.parameters.values())


def _resolve(node: ast.AST, scope: dict):
    """The object an ``a.b.c`` expression names in ``scope`` (None when it
    does not name one: a local tensor, a call result)."""
    if isinstance(node, ast.Name):
        return scope.get(node.id)
    if isinstance(node, ast.Attribute):
        base = _resolve(node.value, scope)
        return None if base is None else getattr(base, node.attr, None)
    return None


def _is_port_function(obj) -> bool:
    mod = getattr(obj, "__module__", "") or ""
    return (isinstance(obj, types.FunctionType)
            and mod.startswith("repro_torch.")
            and mod != "repro_torch.kernels.ref"
            and not obj.__name__.endswith("_plain"))


def aten_work(fn, where: str) -> List[Violation]:
    """VRF016 over ``fn`` and the ``repro_torch`` functions it calls
    (transitively; ``*_plain``, ``kernels/ref.py`` and the backward
    argument of ``_with_aten_grad`` excluded)."""
    out: List[Violation] = []
    seen = set()
    todo = [fn]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        try:
            src = textwrap.dedent(inspect.getsource(f))
            first = inspect.getsourcelines(f)[1]
            path = inspect.getsourcefile(f) or "?"
        except (OSError, TypeError):  # pragma: no cover - no source
            continue
        scope = dict(f.__globals__)
        if f.__closure__:
            scope.update(zip(f.__code__.co_freevars,
                             (c.cell_contents for c in f.__closure__)))
        skip = set()
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and _terminal_name(node.func) == "_with_aten_grad"
                    and len(node.args) > 1):
                skip.update(id(n) for n in ast.walk(node.args[1]))
        rel = Path(path).name
        for node in ast.walk(tree):
            if id(node) in skip:
                continue
            line = first + getattr(node, "lineno", 1) - 1
            if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                          ast.MatMult):
                out.append(Violation("VRF016", rel, line,
                                     f"{where}: '@' (a torch GEMM) in "
                                     f"{f.__name__}"))
                continue
            if not isinstance(node, ast.Call):
                continue
            obj = _resolve(node.func, scope)
            name = _terminal_name(node.func)
            if obj is not None and _is_port_function(obj):
                todo.append(obj)
                continue
            mod = getattr(obj, "__module__", "") or ""
            torch_fn = obj is not None and (
                mod.startswith("torch") or "torch" in repr(obj))
            method = (obj is None and isinstance(node.func, ast.Attribute)
                      and name in _ATEN_METHODS)
            if (torch_fn and name in _ATEN_COMPUTE) or method:
                out.append(Violation(
                    "VRF016", rel, line,
                    f"{where}: {ast.unparse(node.func)} (aten compute: "
                    f"cuBLAS/cuDNN/SDPA doing the kernel's work) in "
                    f"{f.__name__}"))
    return out


def lint_registry() -> List[Violation]:
    """Live checks over the imported op registry (VRF010-VRF013, VRF016)."""
    from repro_torch.ops import registry

    out: List[Violation] = []
    for bname in registry.backends():
        backend = registry.get_backend(bname)
        instrumented_tier = backend.fallback is not None
        for op, entry in sorted(backend.ops.items()):
            where = f"{bname}.{op}"
            if instrumented_tier and entry.words_fn is None:
                out.append(Violation(
                    "VRF010", "repro_torch/ops/registry.py", 0,
                    f"{where}: instrumented backend entry has no words_fn"))
            if (entry.words_fn is not None and entry.access_plan_fn is None
                    and not op.endswith("_dist")):
                out.append(Violation(
                    "VRF011", "repro_torch/ops/registry.py", 0,
                    f"{where}: words_fn without access_plan_fn — the static "
                    "auditor cannot cross-check it"))
            for flag in sorted(entry.caps.flags):
                param = _FLAG_PARAMS.get(flag)
                if param and not _accepts(entry.fn, param):
                    out.append(Violation(
                        "VRF012", "repro_torch/ops/registry.py", 0,
                        f"{where}: declares capability {flag!r} but its fn "
                        f"accepts no {param!r} parameter"))
            quant = sorted(set(entry.caps.dtypes) & _QUANT_DTYPES)
            if quant:
                acc = entry.caps.accum_dtype
                if acc is None:
                    out.append(Violation(
                        "VRF013", "repro_torch/ops/registry.py", 0,
                        f"{where}: declares quantized dtypes {quant} but no "
                        "accum_dtype (accumulation contract unstated)"))
                elif acc not in _WIDE_ACCUM:
                    out.append(Violation(
                        "VRF013", "repro_torch/ops/registry.py", 0,
                        f"{where}: accum_dtype {acc!r} is narrower than "
                        "32 bits for quantized storage dtypes"))
            if bname == "cuda":
                out.extend(aten_work(entry.fn, where))
    return out


def default_roots(repo_root: Path) -> List[Path]:
    return [p for p in (repo_root / "src" / "repro_torch",
                        repo_root / "scripts" / "verify_torch.py")
            if p.exists()]


def run_lint(roots: Optional[Sequence[Path]] = None,
             repo_root: Optional[Path] = None) -> List[Violation]:
    repo_root = repo_root or Path(__file__).resolve().parents[3]
    roots = list(roots) if roots else default_roots(repo_root)
    return lint_sources(roots, repo_root) + lint_registry()


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    repo_root = Path(__file__).resolve().parents[3]
    roots = [Path(a).resolve() for a in argv] or None
    found = run_lint(roots, repo_root)
    for viol in found:
        print(viol)
    if found:
        print(f"repro_torch.verify.lint: {len(found)} violation(s)")
        return 1
    print("repro_torch.verify.lint: clean")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
