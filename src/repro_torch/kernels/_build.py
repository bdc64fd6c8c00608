"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, keyed by a hash of the source and
the flags, under ``kernels/_build/`` (listed in ``.gitignore``), and loaded
with ``ctypes``. Nothing here runs at import: the package imports on a
machine without ``nvcc`` or a GPU, where only the plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``
    (the toolkit's conventional prefix when ``CUDA_HOME`` is unset)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU, at first use")
    return found


class CudaKernel:
    """One ``csrc/<source>`` library: its build, its ctypes entry and the
    count of kernel launches made through it.

    ``launches`` is a plain integer that the kernel's wrapper raises by one
    at each launch and nowhere else, so a run can show that it went through
    the kernel. ``build_seconds`` and ``build_log`` (nvcc's ``-Xptxas -v``
    report: registers, shared memory and spills per kernel) are set by the
    build."""

    def __init__(self, source: str, entry: str, argtypes: Sequence):
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        src = (CSRC / self.source).read_bytes()
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{Path(self.source).stem}-{key[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library exists; returns the
        process (None when there is nothing to build)."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        self._t0 = time.perf_counter()
        self._tmp = tmp
        return subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            self.build_seconds = self.build_seconds or 0.0
            return
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source} "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(self._tmp, self.library_path())
        self.build_seconds = time.perf_counter() - self._t0

    def fn(self):
        """The loaded C entry point, building the library on first use."""
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library_path()))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        """Call the C entry (which launches on the given stream) and raise
        on a non-zero ``cudaError_t``; counts the launch."""
        err = self.fn()(*args)
        if err != 0:
            raise RuntimeError(f"{self.entry} failed with cudaError_t {err}")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Build every given kernel's library with one nvcc each, all started
    together; returns build seconds per source."""
    kernels = list(kernels)
    procs: List = [k.start_build() for k in kernels]
    for k, p in zip(kernels, procs):
        k.finish_build(p)
    for k in kernels:
        k.fn()
    return {k.source: k.build_seconds for k in kernels}


# ---------------------------------------------------------------------------
# Launch geometry shared by the kernels' wrappers.
# ---------------------------------------------------------------------------

MAX_THREADS = 256  # __launch_bounds__ of every kernel in csrc/
ACC_PER_THREAD = 64  # f32 accumulators a thread holds in registers
MAX_SMEM_BYTES = 232448  # opt-in dynamic shared memory of one H100 block


def micro_tile(rows: int, cols: int, variants: Sequence) -> tuple:
    """Pick the kernel's compiled micro-tile for a (rows x cols) accumulator
    tile: the first ``(tr, tc)`` of ``variants`` (each tr * tc =
    ACC_PER_THREAD) whose thread grid ceil(rows/tr) x ceil(cols/tc) fits
    MAX_THREADS. Returns ``(variant, tr, tc, row_groups, col_groups)``;
    raises ValueError when the tile holds more accumulators than a CTA's
    registers (a plan made for another target than the H100)."""
    for v, (tr, tc) in enumerate(variants):
        gr, gc = -(-rows // tr), -(-cols // tc)
        if gr * gc <= MAX_THREADS:
            return v, tr, tc, gr, gc
    raise ValueError(
        f"a {rows} x {cols} accumulator tile does not fit one CTA's "
        f"{MAX_THREADS} x {ACC_PER_THREAD} f32 registers; plan for the H100 "
        "target")


def check_smem(nbytes: int, what: str) -> None:
    if nbytes > MAX_SMEM_BYTES:
        raise ValueError(f"{what} needs {nbytes} bytes of shared memory, "
                         f"more than a block's {MAX_SMEM_BYTES}; plan for "
                         "the H100 target")


def dtype_code(dtype) -> int:
    """The C entries' dtype code (0 = float32, 1 = bfloat16)."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, not "
                        f"{dtype}")
    return codes[dtype]


def check_cuda_operands(op: str, *tensors) -> None:
    """Device, dtype and contiguity checks before pointers go to C."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{op}: all operands must lie on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: operands must be contiguous")
    if len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{op}: operands must share one dtype, got "
                        f"{[t.dtype for t in tensors]}")
