"""Carry weights and plan state across from the JAX package.

``params_from_jax`` turns a nested dict/list/tuple of numpy arrays (the JAX
package's parameters, taken leaf by leaf with ``np.asarray``) into the same
tree of torch tensors. Filters are OIHW in both packages and GEMM operands
(m, k) @ (k, n), so no leaf needs a transpose today; this module is the one
place where a later slice's layout changes go.

``transformer_from_jax`` turns the JAX transformer's parameter tree
(``repro.models.transformer.init_params``) into the port's
``models.transformer.Transformer``: the tree's ``layers`` leaves (``b0`` ..
``b{n-1}``, one per pattern position: attention or mamba leaves, norms and
the FFN, a SwiGLU or an MoE's ``router``/``w_gate``/``w_up``/``w_down``)
are stacked on a leading ``repeats`` axis (an expert leaf is (repeats, E,
D, F)), and the converter unstacks them into one module dict per repeat.
Every leaf keeps its layout (``embed`` (V, D) and ``head`` (D, V)
included): nothing is transposed.

``transformer_to_jax`` is the reverse: the port's module (or, through
``tree_from_named``, any ``{name: tensor}`` of the same names, such as an
``AdamWState``'s moments) as the reference's nested tree, ``layers`` leaves
stacked (repeats, ...) again. ``transformer_tree`` gives that tree with
tensor leaves (what ``repro_torch.train.checkpoint`` writes, bf16 bits
kept); ``transformer_to_jax`` gives numpy leaves, a bf16 leaf as the
float32 array of its exact values (numpy has no bfloat16 without
``ml_dtypes``; ``jnp.asarray(a, jnp.bfloat16)`` gives the bits back).

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
    if torch.is_tensor(a):
        return a.detach().to(device=device, dtype=dtype or a.dtype)
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


def named_from_tree(tree: Any, cfg, device="cuda") -> dict:
    """The reference's nested tree (numpy, ``ml_dtypes`` or tensor leaves)
    as the port's flat ``{name: tensor}`` on ``device``: ``layers`` leaves
    unstacked into ``layers.{r}.{name}``, leaf dtypes kept."""
    state = {}
    for name, leaf in _flatten({k: v for k, v in tree.items()
                                if k != "layers"}):
        state[name] = _leaf(leaf, device, None)
    for name, leaf in _flatten(tree["layers"]):
        stacked = leaf if torch.is_tensor(leaf) else np.asarray(leaf)
        if stacked.shape[0] != cfg.repeats:
            raise ValueError(f"layers.{name} has {stacked.shape[0]} repeats, "
                             f"the config {cfg.repeats}")
        for r in range(cfg.repeats):
            state[f"layers.{r}.{name}"] = _leaf(stacked[r], device, None)
    return state


def tree_from_named(named) -> dict:
    """The reverse of :func:`named_from_tree`: the port's ``{name:
    tensor}`` (a module's parameter names) as the reference's nested tree
    of tensors, each ``layers.{r}.{name}`` family stacked on a leading
    repeats axis (on its own device)."""
    tree: dict = {}

    def put(path, value):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value

    layers: dict = {}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] == "layers":
            layers.setdefault(".".join(parts[2:]), {})[int(parts[1])] = t
        else:
            put(parts, t.detach())
    for name, by_repeat in layers.items():
        n = len(by_repeat)
        if sorted(by_repeat) != list(range(n)):
            raise ValueError(f"layers.*.{name}: repeats {sorted(by_repeat)}")
        put(["layers"] + name.split("."),
            torch.stack([by_repeat[r].detach() for r in range(n)]))
    return tree


def transformer_tree(model) -> dict:
    """The module's parameters as the reference's tree of tensors."""
    return tree_from_named(dict(model.named_parameters()))


def _numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def transformer_to_jax(model, named=None) -> dict:
    """The reference's nested numpy tree of the module's parameters (or of
    ``named``, a ``{name: tensor}`` with the module's parameter names, such
    as an ``AdamWState``'s ``m``), bf16 leaves as float32 (module
    docstring)."""
    named = dict(model.named_parameters()) if named is None else named
    return _numpy_tree(tree_from_named(named))


def transformer_from_jax(tree: Any, cfg, device="cuda"):
    """The port's :class:`repro_torch.models.transformer.Transformer` holding
    the JAX parameter tree's values (leaf dtypes kept). ``tree["layers"]`` is
    stacked (repeats, ...) per leaf and lands in ``layers[r]`` for each r."""
    from repro_torch.models.transformer import Transformer

    state = named_from_tree(tree, cfg, device)
    with torch.device("meta"):
        model = Transformer(cfg)
    missing = set(model.state_dict()) ^ set(state)
    if missing:
        raise ValueError(f"JAX tree and port module differ in {sorted(missing)}")
    model.load_state_dict(state, assign=True)
    return model
