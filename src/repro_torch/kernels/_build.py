"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, keyed by a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, under ``kernels/_build/``
(listed in ``.gitignore``), and loaded with ``ctypes``. Nothing here runs
at import: the package imports on a machine without ``nvcc`` or a GPU,
where only the plain versions run.
"""

from __future__ import annotations

import contextlib
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
    the kernel; ``tensor_core_launches`` counts the launches among them that
    took a tensor-core kernel of the source (the bf16 paths of the GEMM, the
    direct conv and flash attention, and every int8 GEMM), so a run can
    show which kernel its calls took. ``last_launch`` records the launch
    the wrapper made last: ``{"grid": (x, y, z), "block": (x, y, z),
    "smem": dynamic shared-memory bytes, "cluster": (x, y, z)}`` (None
    before the first), as the wrapper computed them for the C entry, so a
    run can hold them against a launch's access plan
    (``repro_torch.verify``).
    ``build_seconds`` and ``build_log`` (nvcc's ``-Xptxas -v`` report:
    registers, shared memory and spills per kernel) are set by the build.

    Inside :func:`record_launches` (a CUDA graph's capture, which executes
    nothing) a launch is recorded there instead of counted; each replay of
    the graph credits the record (:meth:`LaunchRecord.credit`)."""

    def __init__(self, source: str, entry: str, argtypes: Sequence):
        self.source = source
        self.entry = entry
        self.argtypes = list(argtypes)
        self.launches = 0
        self.tensor_core_launches = 0
        self.last_launch: Optional[dict] = None
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        # the source and the headers it may include (csrc/*.cuh)
        src = (CSRC / self.source).read_bytes() + b"".join(
            h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return BUILD_DIR / f"{Path(self.source).stem}-{key[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library exists; returns the
        process (None when there is nothing to build)."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
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

    def launch(self, *args, tensor_core: bool = False,
               grid: Sequence[int] = (1, 1, 1),
               block: Sequence[int] = (1, 1, 1), smem: int = 0,
               cluster: Sequence[int] = (1, 1, 1)) -> None:
        """Call the C entry (which launches on the given stream) and raise
        on a non-zero ``cudaError_t``; counts the launch, and among the
        launches those of a tensor-core kernel, and records its ``grid``,
        ``block``, dynamic shared memory ``smem`` and ``cluster`` (the
        wrapper's, padded to dim3 triples) as ``last_launch``. Under
        :func:`record_launches` the counts go to the record, and a library
        not yet built raises: no build may run inside a capture."""
        if _RECORDS and self._fn is None:
            raise RuntimeError(f"{self.source} is not built: a capture must "
                               "follow an eager warm-up step")
        err = self.fn()(*args)
        if err != 0:
            raise RuntimeError(f"{self.entry} failed with cudaError_t {err}")

        def dim3(v):
            return tuple(int(x) for x in v) + (1,) * (3 - len(v))

        self.last_launch = {"grid": dim3(grid), "block": dim3(block),
                            "smem": int(smem), "cluster": dim3(cluster)}
        if _RECORDS:
            _RECORDS[-1].add(self, tensor_core)
            return
        self.launches += 1
        self.tensor_core_launches += int(tensor_core)


class LaunchRecord:
    """The kernel launches one captured CUDA graph makes: per kernel the
    launches, the tensor-core launches among them and the last launch's
    configuration. A replay runs the launches without the wrappers' host
    code, so it credits them with :meth:`credit`."""

    def __init__(self):
        self.counts: Dict[CudaKernel, List] = {}

    def add(self, kernel: CudaKernel, tensor_core: bool) -> None:
        n = self.counts.setdefault(kernel, [0, 0, None])
        n[0] += 1
        n[1] += int(tensor_core)
        n[2] = kernel.last_launch

    def credit(self, times: int = 1) -> None:
        """Count the recorded launches ``times`` over, as ``times``
        replays of the graph."""
        for k, (n, tc, last) in self.counts.items():
            k.launches += times * n
            k.tensor_core_launches += times * tc
            k.last_launch = last


_RECORDS: List[LaunchRecord] = []  # active recorders, innermost last


@contextlib.contextmanager
def record_launches():
    """While active, every :meth:`CudaKernel.launch` is added to the
    yielded :class:`LaunchRecord` and counted nowhere else."""
    rec = LaunchRecord()
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)


def build_all(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Build every given kernel's library with one nvcc per source (entries
    that share a source share its build), all started together; returns
    build seconds per source."""
    kernels = list(kernels)
    first: Dict[str, CudaKernel] = {}
    for k in kernels:
        first.setdefault(k.source, k)
    procs: List = [k.start_build() for k in first.values()]
    for k, p in zip(first.values(), procs):
        k.finish_build(p)
    for k in kernels:
        built = first[k.source]
        k.build_seconds, k.build_log = built.build_seconds, built.build_log
        k.fn()
    return {k.source: k.build_seconds for k in first.values()}


# ---------------------------------------------------------------------------
# Launch geometry shared by the kernels' wrappers.
# ---------------------------------------------------------------------------

MAX_THREADS = 256  # __launch_bounds__ of the bf16/f32 kernels in csrc/
MAX_THREADS_Q = 512  # __launch_bounds__ of the int8 kernels (csrc/quant.cu)
ACC_PER_THREAD = 64  # accumulators a thread holds in registers
MAX_SMEM_BYTES = 232448  # opt-in dynamic shared memory of one H100 block


def micro_tile(rows: int, cols: int, variants: Sequence) -> tuple:
    """Pick the FMA kernels' compiled micro-tile for a (rows x cols)
    accumulator tile: the first ``(tr, tc)`` of ``variants`` (each tr * tc
    = ACC_PER_THREAD) whose thread grid ceil(rows/tr) x ceil(cols/tc) fits
    MAX_THREADS. Returns ``(variant, tr, tc, row_groups, col_groups)``;
    raises ValueError when the tile holds more accumulators than a CTA's
    registers (a plan made for another target than the H100)."""
    for v, (tr, tc) in enumerate(variants):
        gr, gc = -(-rows // tr), -(-cols // tc)
        if gr * gc <= MAX_THREADS:
            return v, tr, tc, gr, gc
    raise ValueError(
        f"a {rows} x {cols} accumulator tile does not fit one CTA's "
        f"{MAX_THREADS} x {ACC_PER_THREAD} registers; plan for the H100 "
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
