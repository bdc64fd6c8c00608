"""Carry weights and plan state across from the JAX package.

``params_from_jax`` turns a nested dict/list/tuple of numpy arrays (the JAX
package's parameters, taken leaf by leaf with ``np.asarray``) into the same
tree of torch tensors. Filters are OIHW in both packages and GEMM operands
(m, k) @ (k, n), so no leaf needs a transpose today; this module is the one
place where a later slice's layout changes go.

``transformer_from_jax`` turns the JAX transformer's parameter tree
(``repro.models.transformer.init_params``) into the port's
``models.transformer.Transformer``: the tree's ``layers`` leaves are stacked
on a leading ``repeats`` axis, and the converter unstacks them into one
module per layer. Every leaf keeps its layout (``embed`` (V, D) and
``head`` (D, V) included): nothing is transposed.

Plan state needs no converter: ``ExecutionPlan.to_json`` / ``from_json``
(and ``Planner.cache.save`` / ``load``) write and read the same format-v6
JSON in both packages.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

_BF16 = "bfloat16"


def _leaf(a: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == _BF16:  # ml_dtypes bfloat16: no numpy counterpart
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable, owned copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Any, device, dtype: Optional[torch.dtype] = None
                    ) -> Any:
    """The same nested structure with every array leaf a tensor on
    ``device`` (cast to ``dtype`` when given). Dict keys, list and tuple
    order are kept; ``None`` leaves stay ``None``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    if tree is None:
        return None
    return _leaf(tree, device, dtype)


def _flatten(tree: Any, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def transformer_from_jax(tree: Any, cfg, device="cuda"):
    """The port's :class:`repro_torch.models.transformer.Transformer` holding
    the JAX parameter tree's values (leaf dtypes kept). ``tree["layers"]`` is
    stacked (repeats, ...) per leaf and lands in ``layers[r]`` for each r."""
    from repro_torch.models.transformer import Transformer

    state = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k != "layers"}):
        state[name] = _leaf(leaf, device, None)
    for name, leaf in _flatten(tree["layers"]):
        stacked = np.asarray(leaf)
        if stacked.shape[0] != cfg.repeats:
            raise ValueError(f"layers.{name} has {stacked.shape[0]} repeats, "
                             f"the config {cfg.repeats}")
        for r in range(cfg.repeats):
            state[f"layers.{r}.{name}"] = _leaf(stacked[r], device, None)
    with torch.device("meta"):
        model = Transformer(cfg)
    missing = set(model.state_dict()) ^ set(state)
    if missing:
        raise ValueError(f"JAX tree and port module differ in {sorted(missing)}")
    model.load_state_dict(state, assign=True)
    return model
