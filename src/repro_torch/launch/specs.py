"""Meta-tensor stand-ins for every dry-run cell (the port of
``repro.launch.specs``): shapes and dtypes only, nothing allocated.

``input_specs(arch, shape_name)`` returns the inputs of the step the dry
run drives for the cell:
    train   -> params (f32), opt_state, batch {tokens | embeds + tokens/labels}
    prefill -> params (bf16), cache, batch
    decode  -> params (bf16), cache, token (B, 1), index

Every leaf is a tensor on the ``meta`` device with the reference's shape
and dtype, with one difference: the port keeps per-layer parameters, so a
parameter leaf the reference stacks as (repeats, ...) is ``repeats``
leaves of (...), keyed by the port's parameter names
(``layers.3.b0.core.wq``). Caches keep the reference's stacked layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.config import LM_SHAPES, ModelConfig, ShapeSpec
from repro_torch.train.optimizer import AdamWState

PyTree = Any


def abstract(tree: PyTree) -> PyTree:
    """``tree`` with every tensor leaf a meta tensor of its shape and
    dtype."""
    if torch.is_tensor(tree):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: abstract(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [abstract(v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else \
            type(tree)(vals)
    return tree


def param_structs(arch: str, dtype: str = "float32",
                  cfg=None) -> Dict[str, torch.Tensor]:
    """``{parameter name: meta tensor}`` of ``arch`` in ``dtype`` (the
    leaves the model keeps in their own dtype keep it, as the reference's
    ``init_params`` does)."""
    cfg = cfg or get_config(arch)
    if dtype != cfg.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=dtype)
    with torch.device("meta"):
        model = T.Transformer(cfg)
    return dict(model.named_parameters())


def opt_structs(arch: str, cfg=None) -> AdamWState:
    p = param_structs(arch, "float32", cfg)
    f32 = {n: torch.empty(s.shape, dtype=torch.float32, device="meta")
           for n, s in p.items()}
    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      m=f32, v=dict(f32))


def cache_structs(arch: str, batch: int, max_len: int, cfg=None) -> PyTree:
    cfg = cfg or get_config(arch)
    return T.init_cache(cfg, batch, max_len, device="meta")


def batch_structs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, L = shape.global_batch, shape.seq_len

    def meta(s, dt):
        return torch.empty(s, dtype=dt, device="meta")

    if cfg.inputs_are_embeddings and shape.kind != "decode":
        out = {"embeds": meta((B, L, cfg.d_model), torch.bfloat16)}
        out["labels" if not cfg.causal else "tokens"] = meta((B, L),
                                                             torch.int32)
        return out
    return {"tokens": meta((B, L), torch.int32)}


def input_specs(arch: str, shape_name: str, cfg=None) -> Dict[str, Any]:
    """The abstract inputs of the step driven in this cell."""
    cfg = cfg or get_config(arch)
    shape = LM_SHAPES[shape_name]
    if shape.kind == "train":
        return {"params": param_structs(arch, "float32", cfg),
                "opt_state": opt_structs(arch, cfg),
                "batch": batch_structs(cfg, shape)}
    params = param_structs(arch, "bfloat16", cfg)
    cache = cache_structs(arch, shape.global_batch, shape.seq_len, cfg)
    if shape.kind == "prefill":
        return {"params": params, "cache": cache,
                "batch": batch_structs(cfg, shape)}
    # decode: one new token against a seq_len-deep cache
    return {"params": params, "cache": cache,
            "token": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device="meta"),
            "index": torch.empty((), dtype=torch.int32, device="meta")}


def n_groups_for(shape: ShapeSpec, n_devices: int) -> int:
    return math.gcd(shape.tokens, n_devices)
