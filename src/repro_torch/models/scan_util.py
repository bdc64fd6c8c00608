"""``lax.scan``'s contract as a Python loop (the counterpart of
``repro.models.scan_util``).

``scan(f, init, xs)`` calls ``f(carry, x)`` once for each slice of ``xs``
along axis 0 and returns ``(carry, ys)``, each leaf of ``ys`` the step
outputs stacked on a new axis 0. ``xs`` and the step outputs are a tensor,
``None`` or a tuple or list of them (nested as deep as needed).

The reference's ``unroll_scans`` switch (``REPRO_UNROLL_SCANS``) exists
for its dry run's XLA cost analysis, which counts a rolled loop body once.
The port's loops are Python loops, always unrolled: every step runs, and
the dry run (``repro_torch.launch.dryrun``) records every step's ops.
:func:`unroll_scans` says so and reads no switch.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch


def _leaves(tree: Any) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _rebuild(tree: Any, leaves) -> Any:
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def unroll_scans() -> bool:
    """True: the port's scans always run unrolled (module docstring)."""
    return True


def scan(f: Callable[[Any, Any], Tuple[Any, Any]], init: Any, xs: Any,
         length: Optional[int] = None) -> Tuple[Any, Any]:
    flat = _leaves(xs)
    n = flat[0].shape[0] if flat else length
    if n is None:
        raise ValueError("scan needs xs with a leading axis or a length")
    if length is not None and length != n:
        raise ValueError(f"scan length {length} and xs' leading axis {n}")
    carry, outs = init, []
    for i in range(n):
        x = _rebuild(xs, iter([leaf[i] for leaf in flat]))
        carry, y = f(carry, x)
        outs.append(y)
    if not outs:
        raise ValueError("scan over a length-0 axis has no outputs to stack")
    ys = _rebuild(outs[0], iter([torch.stack(column) for column in
                                 zip(*(_leaves(y) for y in outs))]))
    return carry, ys
