"""Training loop: the step (gradient accumulation, optional int8 gradient
compression, AdamW), skip-on-non-finite-loss, checkpointing (the port of
``repro.train.trainer``) on one device or on a device mesh.

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

On a mesh (``Trainer(..., mesh=)``, a ``DeviceMesh`` with the axes
``data`` and ``model``) the parameters and moments are DTensors placed by
``models.sharding.param_specs`` (each device keeps its chunk of the same
seeded values: nothing goes over the wire), each batch is placed with
its batch dim on the data axes (by microbatch: ``place_on_mesh``), and
the same step runs: DTensor issues the forward's and backward's
collectives (``models.spmd``). The
gradients of parameters replicated over the data axes come back Partial
over them, as GSPMD's do before its reduction: the step reduces each one
to its parameter's placements (an all-reduce), and every collective of a
step is counted (``Trainer.collectives``, by
``analysis.roofline.CostMode``; on a gloo group with card tensors a
collective gloo cannot run there raises before it is issued).
``TrainConfig.act_spec`` (a ``sharding.P`` of the (B, L, D) activations)
redistributes the residual stream, as the reference's sharding
constraint does. ``n_groups`` reaches the MoE blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import re
import time
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.analysis.roofline import CostMode, collective_bytes
from repro_torch import dtensors
from repro_torch.convert import (named_from_tree, transformer_from_jax,
                                 tree_from_named)
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.models import sharding as shd
from repro_torch.models import spmd
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.ops import ExecutionContext, default_context, traced

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
    act_spec: Any = None  # activation sharding.P (sequence parallelism)


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


class Microbatches(dict):
    """A batch stacked by microbatch: each leaf is (mb, B / mb, ...), and
    microbatch i is ``leaf[i]`` (:func:`place_on_mesh` makes one)."""


def _split(batch: Dict[str, torch.Tensor], mb: int, i: int):
    """Microbatch ``i`` of ``mb``: the contiguous block i of the batch
    dim, as the reference's ``scan`` takes it."""
    if isinstance(batch, Microbatches):
        return {k: v[i] for k, v in batch.items()}
    return {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
            for k, v in batch.items()}


def place_on_mesh(batch: Dict[str, torch.Tensor], mesh, microbatches: int = 1
                  ) -> Dict[str, torch.Tensor]:
    """``batch`` (the same whole tensors on every rank) on ``mesh`` with
    its batch dim on the data axes: each device keeps its rows, nothing
    goes over the wire. With ``microbatches`` > 1 each leaf is stacked
    first, (mb, B / mb, ...), with the data axes on dim 1 (a
    :class:`Microbatches`): each data rank holds its share of every
    contiguous microbatch, so no microbatch is gathered in the step."""
    ba = shd.batch_axes(mesh)
    lead = ()
    if microbatches > 1:
        batch = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                              *v.shape[1:]) for k, v in batch.items()}
        lead = (None,)
    placed = {k: shd.NamedSharding(mesh, shd.P(
        *lead, ba, *([None] * (v.ndim - 1 - len(lead))))).place(v)
        for k, v in batch.items()}
    return Microbatches(placed) if microbatches > 1 else placed


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
    into contiguous blocks (a :class:`Microbatches` batch comes split)
    and averages the gradients. The step runs inside ``ops.traced()``, as
    the reference jits it: a fault campaign's dispatch hook stands down
    there."""

    def loss_for(params, batch):
        return T.loss_fn(params, model_cfg, batch,
                         n_groups=train_cfg.n_groups,
                         ctx=train_cfg.ctx,
                         remat=train_cfg.remat,
                         aux_weight=train_cfg.aux_weight,
                         loss_chunks=train_cfg.loss_chunks,
                         act_spec=train_cfg.act_spec)

    def train_step(params, opt_state: AdamWState, batch):
        # on a mesh, plain tensors act as replicated, backward included
        with traced(), spmd.replicate_plain(params.head):
            return step(params, opt_state, batch)

    def step(params, opt_state: AdamWState, batch):
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
        if dtensors.is_dtensor(loss):  # the replicated value (an all-reduce)
            loss = loss.full_tensor()
        if not is_fake(loss) and not bool(torch.isfinite(loss)):
            for p in named.values():
                p.grad = None
            raise FloatingPointError(f"non-finite loss {float(loss)}")
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in named.items()}
        # on a mesh: Partial gradients reduced to their parameters'
        # placements (GSPMD's data-parallel reduction)
        grads = {n: spmd.like(g, named[n]) for n, g in grads.items()}
        for p in named.values():
            p.grad = None
        if train_cfg.compress_grads:
            grads = quantize_int8(grads)
        params, opt_state, om = apply_updates(params, grads, opt_state,
                                              opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step


class Trainer:
    """The training loop on ``train_cfg.ctx``'s device (the card by default:
    without a GPU and without a CPU context it raises), or on ``mesh`` (a
    ``DeviceMesh`` over that device type; module docstring)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        train_cfg: TrainConfig,
        data_cfg: DataConfig,
        mesh=None,
    ):
        if train_cfg.ctx is None:
            train_cfg = dataclasses.replace(train_cfg, ctx=default_context())
        self.model_cfg, self.opt_cfg, self.train_cfg = model_cfg, opt_cfg, train_cfg
        self.data_cfg = data_cfg
        self.mesh = mesh
        self.device = torch.device(train_cfg.ctx.device)
        self.source = make_source(data_cfg)
        self.skipped_steps = 0
        self.collectives: list = []  # a mesh step's wire bytes by kind
        # the last state_tree's wire bytes by kind on a mesh
        self.state_collectives: Optional[dict] = None
        self.step_fn = make_train_step(model_cfg, opt_cfg, train_cfg)

    # -- state ---------------------------------------------------------------
    def init(self, seed: int = 0):
        """Seeded parameters and zero moments. On a mesh each parameter is
        placed as it is made (each device keeps its chunk, the whole
        tensor is dropped before the next is made) and the moments are
        made on the placed leaves: no device ever holds the whole model or
        a whole moment, and the values are those of one device's
        ``init_params`` with the same seed, bit for bit."""
        with (contextlib.nullcontext() if self.mesh is None
              else placed_as_made(self.model_cfg, self.mesh)):
            self.params = T.init_params(self.model_cfg, seed=seed,
                                        device=self.device)
        self.opt_state = init_state(self.params)
        self.start_step = 0

    def _place(self) -> None:
        """Whole parameters and moments (a restored checkpoint) onto the
        mesh, leaf by leaf: each device keeps its chunk (no wire), and each
        whole tensor is released once placed."""
        specs = shardings_for(self.model_cfg, self.mesh)
        with torch.no_grad():
            for name in [n for n, _ in self.params.named_parameters()]:
                mod, leaf = _owner(self.params, name)
                mod._parameters[leaf] = torch.nn.Parameter(
                    _own_chunk(specs[name].place(
                        mod._parameters[leaf].detach())))
        st = self.opt_state
        for tree in (st.m, st.v):
            for n in list(tree):
                tree[n] = _own_chunk(specs[n].place(tree[n]))

    def place_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A host batch on the device; on a mesh, placed by
        :func:`place_on_mesh` with ``train_cfg.microbatches``."""
        out = {k: torch.as_tensor(v, device=self.device)
               for k, v in batch.items()}
        if self.mesh is None:
            return out
        return place_on_mesh(out, self.mesh, self.train_cfg.microbatches)

    def state_tree(self) -> dict:
        """``{"params": ..., "opt": (step, m, v)}`` as the reference's trees
        (``layers`` stacked): what a checkpoint holds. On a mesh each leaf
        is made whole on every device by ``dtensors.whole`` (all-reduces of
        zero-padded chunks: gloo cannot all-gather card tensors), under
        the gloo guard, and the wire bytes by kind are kept in
        ``state_collectives``."""
        st = self.opt_state
        named = dict(self.params.named_parameters())
        m, v = st.m, st.v
        if self.mesh is not None:
            count = CostMode(counts_only=True, check=dtensors.gloo_guard)
            with count, torch.no_grad():
                named, m, v = (_gathered(t) for t in (named, m, v))
            self.state_collectives = collective_bytes(count.collectives)
        return {"params": tree_from_named(named),
                "opt": (st.step, tree_from_named(m), tree_from_named(v))}

    def save_checkpoint(self, step: int) -> dict:
        """:meth:`state_tree` committed as ``step`` under ``ckpt_dir``; on
        a mesh every rank gathers and the mesh's rank 0 alone writes.
        Returns the tree."""
        tc = self.train_cfg
        tree = self.state_tree()
        if self.mesh is None or self.mesh.get_rank() == 0:
            ckpt.save(tc.ckpt_dir, step, tree,
                      extra={"skipped": self.skipped_steps},
                      keep=tc.keep_ckpts)
        return tree

    def resume_or_init(self):
        tc = self.train_cfg
        latest = ckpt.latest_step(tc.ckpt_dir) if tc.ckpt_dir else None
        if latest is None:  # on a mesh: placed as made (:meth:`init`)
            self.init(tc.seed)
            return
        mesh, self.mesh = self.mesh, None  # restore whole, then place
        try:
            self.init(tc.seed)
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
        finally:
            self.mesh = mesh
        if mesh is not None:
            self._place()

    # -- loop ----------------------------------------------------------------
    def run(self) -> Dict[str, list]:
        """Steps ``start_step .. steps - 1``; returns ``{"loss", "step_time",
        "step"}`` of the steps that ran (skipped ones left out)."""
        tc = self.train_cfg
        if not hasattr(self, "params"):
            self.resume_or_init()
        history = {"loss": [], "step_time": [], "step": []}
        for step in range(self.start_step, tc.steps):
            batch = self.place_batch(self.source.batch(step))
            t0 = time.time()
            count = CostMode(counts_only=True, check=dtensors.gloo_guard)
            try:
                with (count if self.mesh is not None
                      else contextlib.nullcontext()):
                    self.params, self.opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
            except FloatingPointError as e:  # bad step: skip, keep state
                self.skipped_steps += 1
                log.warning("skipping step %d: %s", step, e)
                continue
            dt = time.time() - t0
            if self.mesh is not None:
                self.collectives.append(collective_bytes(count.collectives))
            history["loss"].append(loss)
            history["step_time"].append(dt)
            history["step"].append(step)
            if tc.log_every and step % tc.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, loss, dt)
            if tc.ckpt_dir and tc.ckpt_every and (step + 1) % tc.ckpt_every == 0:
                self.save_checkpoint(step + 1)
        return history


def shardings_for(cfg: ModelConfig, mesh) -> Dict[str, "shd.NamedSharding"]:
    """``{parameter name: NamedSharding}`` of ``cfg`` on ``mesh`` (the
    moments share their parameter's)."""
    return shd.shardings(mesh, shd.param_specs(cfg))


def _own_chunk(t):
    """A placed DTensor whose local chunk owns its memory: a chunk that is
    a view of the whole tensor (a split along dim 0) would keep the whole
    alive; it is copied."""
    local = t.to_local()
    if local.untyped_storage().nbytes() <= local.numel() * \
            local.element_size():
        return t
    return dtensors._from_local(local.clone(), t, t.placements)


def registration_order(cfg: ModelConfig) -> list:
    """The parameter names of ``Transformer(cfg)`` in the order its
    constructor registers them (each block's leaves before its parent's
    later ones; built on the meta device)."""
    from torch.nn.modules.module import \
        register_module_parameter_registration_hook

    seen = []
    handle = register_module_parameter_registration_hook(
        lambda module, leaf, p: seen.append((module, leaf)))
    try:
        with torch.device("meta"):
            model = T.Transformer(cfg)
    finally:
        handle.remove()
    prefix = {id(m): name for name, m in model.named_modules()}
    return [f"{prefix[id(m)]}.{leaf}".lstrip(".") for m, leaf in seen]


@contextlib.contextmanager
def placed_as_made(cfg: ModelConfig, mesh):
    """Inside the ``with``, each parameter that a ``Transformer(cfg)``
    registers is placed on ``mesh`` by ``param_specs`` as soon as it is
    made (``torch.nn``'s parameter registration hook): the module holds
    the placed leaf, and the whole tensor is dropped. Build one
    ``Transformer`` inside."""
    from torch.nn.modules.module import \
        register_module_parameter_registration_hook

    specs = shardings_for(cfg, mesh)
    names = iter(registration_order(cfg))

    def place(module, leaf, p):
        name = next(names)
        if name.rsplit(".", 1)[-1] != leaf:
            raise AssertionError(f"registered {leaf!r} where {name!r} "
                                 "was expected")
        with torch.no_grad():
            return torch.nn.Parameter(_own_chunk(
                specs[name].place(p.detach())))

    handle = register_module_parameter_registration_hook(place)
    try:
        yield
    finally:
        handle.remove()


def _owner(module: torch.nn.Module, name: str):
    """(the module holding parameter ``name``, its leaf name)."""
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf


def _gathered(named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: (dtensors.whole(t) if dtensors.is_dtensor(t) else t).detach()
            for n, t in named.items()}
