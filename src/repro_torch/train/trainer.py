"""Training loop: the step (gradient accumulation, optional int8 gradient
compression, AdamW), skip-on-non-finite-loss, checkpointing (the port of
``repro.train.trainer``) on one device.

The reference jits its step with the parameters and optimizer state
donated; the port runs the step eagerly: ``loss.backward()`` gives the
gradients (attention's kernel runs forward, its backward recomputes
through the aten oracle, as the reference's ``_with_xla_vjp`` recomputes
through XLA) and ``optimizer.apply_updates`` writes the parameters and
moments in place under ``torch.no_grad()``. Microbatches (the reference's
``scan``) are a Python loop that accumulates into ``.grad``.

A non-finite loss raises ``FloatingPointError`` inside the step before any
parameter or moment is written (the reference computes the new state and
its trainer drops it); ``Trainer.run`` skips that step and counts it, as
the reference's does.

``quantize_int8`` (the simulated wire compression) takes one absmax scale
per *reference* leaf: all repeats' tensors of one ``layers.*`` name share
the scale the reference computes over its stacked (repeats, ...) leaf.

``TrainConfig.act_spec`` (sequence-parallel activations) and the
``Trainer``'s ``mesh`` are not ported (ROADMAP queue 1, item 13);
``n_groups`` is kept for the signature and reaches the MoE blocks.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from repro_torch.convert import (named_from_tree, transformer_from_jax,
                                 transformer_tree, tree_from_named)
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.ops import ExecutionContext, default_context

from . import checkpoint as ckpt
from .optimizer import AdamWConfig, AdamWState, apply_updates, init_state

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1  # gradient accumulation
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    remat: bool = False
    n_groups: int = 1
    ctx: Optional[ExecutionContext] = None  # execution policy (repro_torch.ops)
    compress_grads: bool = False
    aux_weight: float = 0.01
    seed: int = 0
    loss_chunks: int = 0  # >1: chunked cross-entropy (big-vocab memory)
    act_spec: Any = None  # not ported: must stay None

    def __post_init__(self):
        if self.act_spec is not None:
            raise NotImplementedError(
                "act_spec (sequence-parallel activations) is not ported to "
                "repro_torch yet (ROADMAP queue 1, item 13)")


def reference_leaf(name: str) -> str:
    """The reference's leaf of a port parameter name: ``layers.3.b0.core.wq``
    -> ``layers.b0.core.wq`` (its stacked leaf), other names unchanged."""
    return re.sub(r"^layers\.\d+\.", "layers.", name)


def quantize_int8(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Simulated wire compression: int8 with one absmax scale per reference
    leaf (module docstring), dequantized to f32."""
    groups: Dict[str, list] = {}
    for name in tree:
        groups.setdefault(reference_leaf(name), []).append(name)
    out = {}
    for names in groups.values():
        amax = torch.stack([tree[n].float().abs().max() for n in names]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for n in names:
            gf = tree[n].float()
            out[n] = torch.round(gf / scale).to(torch.int8).float() * scale
    return out


def _split(batch: Dict[str, torch.Tensor], mb: int, i: int):
    return {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
            for k, v in batch.items()}


def make_train_step(
    model_cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    train_cfg: TrainConfig,
) -> Callable:
    """Builds ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: ``params`` a ``models.transformer.Transformer`` and
    ``opt_state`` an ``optimizer.AdamWState``, both updated in place;
    ``batch`` a dict of tensors on the parameters' device; ``metrics``
    ``loss`` (the total, with the MoE aux term; a device scalar),
    ``grad_norm`` and ``lr``. Microbatching splits the batch's leading dim
    and averages the gradients."""

    def loss_for(params, batch):
        return T.loss_fn(params, model_cfg, batch,
                         n_groups=train_cfg.n_groups,
                         ctx=train_cfg.ctx,
                         remat=train_cfg.remat,
                         aux_weight=train_cfg.aux_weight,
                         loss_chunks=train_cfg.loss_chunks)

    def train_step(params, opt_state: AdamWState, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        mb = train_cfg.microbatches
        if mb > 1:
            loss = 0.0
            for i in range(mb):
                total, _ = loss_for(params, _split(batch, mb, i))
                (total / mb).backward()
                loss = loss + total.detach()
            loss = loss / mb
        else:
            total, _ = loss_for(params, batch)
            total.backward()
            loss = total.detach()
        if not bool(torch.isfinite(loss)):
            for p in named.values():
                p.grad = None
            raise FloatingPointError(f"non-finite loss {float(loss)}")
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in named.items()}
        for p in named.values():
            p.grad = None
        if train_cfg.compress_grads:
            grads = quantize_int8(grads)
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


class Trainer:
    """The training loop on one device: ``train_cfg.ctx``'s (the card by
    default: without a GPU and without a CPU context it raises)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        train_cfg: TrainConfig,
        data_cfg: DataConfig,
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported to repro_torch yet (ROADMAP "
                "queue 1, item 13)")
        if train_cfg.ctx is None:
            train_cfg = dataclasses.replace(train_cfg, ctx=default_context())
        self.model_cfg, self.opt_cfg, self.train_cfg = model_cfg, opt_cfg, train_cfg
        self.data_cfg = data_cfg
        self.device = torch.device(train_cfg.ctx.device)
        self.source = make_source(data_cfg)
        self.skipped_steps = 0
        self.step_fn = make_train_step(model_cfg, opt_cfg, train_cfg)

    # -- state ---------------------------------------------------------------
    def init(self, seed: int = 0):
        self.params = T.init_params(self.model_cfg, seed=seed,
                                    device=self.device)
        self.opt_state = init_state(self.params)
        self.start_step = 0

    def state_tree(self) -> dict:
        """``{"params": ..., "opt": (step, m, v)}`` as the reference's trees
        (``layers`` stacked): what a checkpoint holds."""
        st = self.opt_state
        return {"params": transformer_tree(self.params),
                "opt": (st.step, tree_from_named(st.m), tree_from_named(st.v))}

    def resume_or_init(self):
        tc = self.train_cfg
        self.init(tc.seed)
        if tc.ckpt_dir:
            latest = ckpt.latest_step(tc.ckpt_dir)
            if latest is not None:
                restored, _ = ckpt.restore(tc.ckpt_dir, self.state_tree(),
                                           step=latest, device=self.device)
                self.params = transformer_from_jax(
                    restored["params"], self.model_cfg, self.device)
                step, m, v = restored["opt"]
                self.opt_state = AdamWState(
                    step, named_from_tree(m, self.model_cfg, self.device),
                    named_from_tree(v, self.model_cfg, self.device))
                self.start_step = latest
                log.info("resumed from step %d", latest)

    # -- loop ----------------------------------------------------------------
    def run(self) -> Dict[str, list]:
        """Steps ``start_step .. steps - 1``; returns ``{"loss", "step_time",
        "step"}`` of the steps that ran (skipped ones left out)."""
        tc = self.train_cfg
        if not hasattr(self, "params"):
            self.resume_or_init()
        history = {"loss": [], "step_time": [], "step": []}
        for step in range(self.start_step, tc.steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.source.batch(step).items()}
            t0 = time.time()
            try:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
            except FloatingPointError as e:  # bad step: skip, keep state
                self.skipped_steps += 1
                log.warning("skipping step %d: %s", step, e)
                continue
            dt = time.time() - t0
            history["loss"].append(loss)
            history["step_time"].append(dt)
            history["step"].append(step)
            if tc.log_every and step % tc.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
            if tc.ckpt_dir and tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
                ckpt.save(tc.ckpt_dir, step + 1, self.state_tree(),
                          extra={"skipped": self.skipped_steps},
                          keep=tc.keep_ckpts)
        return history
