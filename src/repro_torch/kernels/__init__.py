"""Hand-written CUDA kernels for the H100 (``csrc/*.cu``, built with ``nvcc``
for ``sm_90a`` at first use and bound with ``ctypes``), tiled by the
``repro_torch.plan`` planner, each with a plain PyTorch version beside it.

A wrapper launches its kernel for a CUDA tensor, and raises if it cannot; it
runs the plain version only for a tensor on the CPU. Consumers go through
``repro_torch.ops``, which attaches the measured HBM-word counters
(``conv2d_hbm_words``, ``matmul_hbm_words``, ``im2col_hbm_words``) to every
dispatch, and the attention counters (``attention_hbm_words``,
``paged_decode_hbm_words``) to every attention call."""

from . import ref  # noqa: F401
from .conv2d import conv2d, conv2d_hbm_words, conv2d_plain  # noqa: F401
from .flash_attention import (  # noqa: F401
    attention_blocks,
    attention_hbm_words,
    flash_attention,
    flash_attention_plain,
    paged_decode_attention,
    paged_decode_hbm_words,
    paged_decode_plain,
)
from .im2col import conv2d_im2col, im2col_hbm_words  # noqa: F401
from .matmul import matmul, matmul_hbm_words, matmul_plain  # noqa: F401

# The CUDA libraries by kernel name: build state and launch counters. (The
# submodules' names are shadowed by the functions re-exported above.)
from .conv2d import KERNEL as _CONV2D_KERNEL  # noqa: E402
from .flash_attention import FLASH_KERNEL as _FLASH_KERNEL  # noqa: E402
from .flash_attention import PAGED_KERNEL as _PAGED_KERNEL  # noqa: E402
from .matmul import KERNEL as _MATMUL_KERNEL  # noqa: E402

KERNELS = {"conv2d": _CONV2D_KERNEL, "matmul": _MATMUL_KERNEL,
           "flash_attention": _FLASH_KERNEL, "paged_decode": _PAGED_KERNEL}
