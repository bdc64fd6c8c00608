"""``repro_torch`` — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``repro_torch/<sub>/<mod>.py`` is the counterpart of ``repro/<sub>/<mod>.py``)
and never imports it or jax. The pure-Python layers (``core``, ``plan``,
``quant.spec``) are kept as copies held against the reference by the parity
tests; the Pallas kernels become CUDA C++ kernels for ``sm_90a`` under
``kernels/csrc``, built at first use and bound with ``ctypes``.

Entry points run on the card (``ExecutionContext(device="cuda")``, the
default) unless the caller asks for the CPU, where every kernel wrapper runs
its plain PyTorch version instead.
"""
