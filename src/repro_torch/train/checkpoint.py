"""Atomic, rotating checkpoints in the reference's on-disk format (the port
of ``repro.train.checkpoint``): a directory written by either package
restores in the other.

Layout (one directory per step):
    <dir>/step_00000123/
        manifest.json      keys, shapes, dtypes, step, extra
        arrays.npz         flat leaf arrays a0, a1, ... (host copies)
        .complete          commit marker

A tree is a nested dict / list / tuple of tensors. Its leaves are
flattened as ``jax.tree_util.tree_flatten_with_path`` flattens
them (dict keys sorted, sequences in order) and keyed by their path joined
with ``/``: ``params/layers/b0/core/wq``, ``opt/0``, ``opt/1/head``. The
trainer writes the reference's trees (``repro_torch.convert``), whose
``layers`` leaves are stacked (repeats, ...). bf16 leaves are stored as
their uint16 bits with ``"bfloat16"`` in ``dtypes`` (the bit views are
torch's, no ``ml_dtypes``).

The write goes to ``step_X.tmp`` and is committed by ``os.replace``; a
directory without ``.complete`` is never restored. ``restore`` places the
leaves on one ``device``, or with ``shardings`` (a tree of
``models.sharding.NamedSharding`` matching the template) onto whatever
mesh those reference (elastic restart): every rank reads the full leaf
and keeps its own chunk, so nothing goes over the wire.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Tree = Any


def _flatten_with_paths(tree: Tree, prefix: Tuple[str, ...] = ()):
    """[(key, leaf)] in the reference's leaf order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, prefix + (str(i),))
        return out
    return [("/".join(prefix), tree)]


def _unflatten(template: Tree, leaves: List[Any]) -> Tree:
    """``template``'s structure with its leaves taken from ``leaves`` in
    flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            vals = [build(v) for v in t]
            if hasattr(t, "_fields"):  # a NamedTuple
                return type(t)(*vals)
            return type(t)(vals)
        return next(it)

    return build(template)


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array npz stores, the leaf's dtype name)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:  # npz has no bfloat16: its raw bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save(directory: str, step: int, tree: Tree, extra: Optional[dict] = None,
         keep: int = 3) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten_with_paths(tree)
    arrays, true_dtypes = {}, []
    for i, (_, leaf) in enumerate(flat):
        a, dt = _to_numpy(leaf)
        true_dtypes.append(dt)
        arrays[f"a{i}"] = a
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": [k for k, _ in flat],
        "dtypes": true_dtypes,
        "shapes": [list(a.shape) for a in arrays.values()],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, ".complete"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit

    _rotate(directory, keep)
    return final


def _rotate(directory: str, keep: int) -> None:
    steps = sorted(committed_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def committed_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, ".complete")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def _to_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def restore(directory: str, template: Tree, step: Optional[int] = None,
            device=None, shardings: Optional[Tree] = None
            ) -> Tuple[Tree, dict]:
    """Restore into the structure of ``template`` (a tree of tensors or
    meta tensors): each leaf a tensor of the template leaf's dtype on
    ``device`` (default: the template leaf's), or with ``shardings`` a
    DTensor placed by the matching ``NamedSharding`` (on ``device``, which
    must be the mesh's device type). Returns (tree, the manifest's
    ``extra``)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    by_key = {k: (i, manifest["dtypes"][i])
              for i, k in enumerate(manifest["keys"])}
    flat = _flatten_with_paths(template)
    missing = [k for k, _ in flat if k not in by_key]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    places = None
    if shardings is not None:
        places = [s for _, s in _flatten_with_paths(shardings)]
        if len(places) != len(flat):
            raise ValueError(f"{len(places)} shardings for {len(flat)} "
                             "leaves")
    leaves = []
    for j, (k, t) in enumerate(flat):
        i, dt = by_key[k]
        a = _to_tensor(data[f"a{i}"], dt)
        a = a.to(device=t.device if device is None else device,
                 dtype=t.dtype)
        leaves.append(a if places is None else places[j].place(a))
    return _unflatten(template, leaves), manifest["extra"]
