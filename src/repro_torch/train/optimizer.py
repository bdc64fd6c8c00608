"""AdamW with a cosine schedule and global-norm clipping (the port of
``repro.train.optimizer``), on tensors.

Parameters are a module's; gradients and moments are flat ``{name:
tensor}`` mappings keyed by its parameter names (``layers.3.b0.core.wq``).
``apply_updates`` writes the parameters and the moments in place under
``torch.no_grad()`` (the reference returns new trees from a jitted step
whose inputs are donated) and returns them.

Weight decay follows the reference's comment, "no decay on norms/bias":
leaves of ndim >= 2 decay. The reference stacks every ``layers`` leaf on a
leading repeats axis, so there a per-layer norm scale, bias or ``D_skip``
is (repeats, D) and decays, while ``final_norm`` does not (ROADMAP queue 3,
"Known reference faults"). The port holds those leaves per layer at ndim 1
and does not decay them. With ``weight_decay=0`` the two updates are equal.

On a device mesh the parameters, gradients and moments are DTensors of
equal placements (:func:`opt_state_specs`: the moments inherit their
parameter's spec) and the update is local to each shard; only the global
norm crosses devices (one all-reduce a leaf whose squares are Partial).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Mapping, NamedTuple, Tuple, Union

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Dict[str, torch.Tensor]  # f32, one a parameter
    v: Dict[str, torch.Tensor]


def init_state(params: torch.nn.Module) -> AdamWState:
    """Zero moments in f32 beside each parameter, step 0 (int32)."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    zeros = {n: torch.zeros_like(p, dtype=torch.float32)
             for n, p in named.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={n: z.clone() for n, z in zeros.items()})


def schedule(cfg: AdamWConfig, step) -> float:
    """The learning rate at ``step`` (an int or a tensor scalar): linear
    warm-up, then a cosine to ``min_lr_frac`` of ``lr``."""
    step = float(step)
    warm = min(step / max(cfg.warmup_steps, 1), 1.0)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                           1)
    prog = min(max(prog, 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Union[Mapping[str, torch.Tensor],
                            Iterable[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a device scalar;
    a DTensor leaf's sum is made whole first)."""
    leaves = list(tree.values()) if isinstance(tree, Mapping) else list(tree)
    sq = (torch.sum(torch.square(t.float())) for t in leaves)
    return torch.sqrt(sum(s.full_tensor() if hasattr(s, "full_tensor")
                          else s for s in sq))


def apply_updates(params: torch.nn.Module,
                  grads: Mapping[str, torch.Tensor], state: AdamWState,
                  cfg: AdamWConfig) -> Tuple[torch.nn.Module, AdamWState, dict]:
    """One AdamW step, in place: returns (params, state, metrics) with
    ``metrics = {"grad_norm": device scalar, "lr": float}``. Gradients are
    clipped to ``clip_norm`` by their global norm."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = cfg.betas
    # host reads of the step: outside a fake mode (the dry run's step is
    # a real tensor; a no-op otherwise)
    with unset_fake_temporarily():
        step = int(state.step) + 1
        # the bias corrections in f32, as the reference computes them
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** step)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** step)
    lr = schedule(cfg, step)
    with torch.no_grad():
        for name, p in params.named_parameters():
            g = grads[name].float() * scale
            m, v = state.m[name], state.v[name]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            pf = p.float()
            upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            decay = cfg.weight_decay if p.ndim >= 2 else 0.0
            if decay:
                upd = upd + decay * pf
            p.copy_((pf - lr * upd).to(p.dtype))
        with unset_fake_temporarily():
            state.step.fill_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_state_specs(param_specs):
    """Optimizer-state PartitionSpecs: moments inherit their parameter's
    spec (ZeRO-1: states live sharded; the update stays local), the step
    is replicated. ``param_specs`` is ``models.sharding.param_specs``'s
    ``{name: P}``."""
    from repro_torch.models.sharding import P

    return AdamWState(step=P(), m=dict(param_specs), v=dict(param_specs))
