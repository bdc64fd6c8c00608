"""The multi-device dry run (the port of ``repro.launch.dryrun``): one
device's program of a full-size (architecture x shape) cell on a 256- or
512-device mesh, recorded without the devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_5_3b \\
        --shape decode_32k

The reference lowers and compiles the cell's jitted step on fake XLA
devices and reads the compiled module. The port has no compiler between
the step and the devices, so it runs the step itself, once, as the
program of device 0 of the mesh: a fake process group
(``torch.testing._internal.distributed.fake_pg``) of world size ``chips``
stands for the mesh, every input is a DTensor placed by
``models.sharding``'s specs whose local shards are fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory), and DTensor issues
the collectives, which the fake group completes at once.
``analysis.roofline.CostMode`` records what the program does, op by op,
on its local shards. A record holds the reference's keys:

* ``bytes_per_device``: ``argument_bytes`` and ``output_bytes``, exact
  from the local shard shapes (uneven shards counted at device 0's, the
  largest, chunk): the arguments the step uses (an op reads them, or the
  step returns them as they came; the reference's jit prunes the rest),
  the outputs without the reference's 8 bytes a leaf of its output tuple
  (XLA's table of the tuple's buffers); ``temp_bytes``, the most bytes of
  op results alive at once, and ``peak_bytes``, the arguments plus those
  (results freed when their tensor is collected, as the caching allocator
  would reuse them);
* ``hlo_flops``: the FLOPs of every local aten op by
  ``torch.utils.flop_counter``'s formulas (matmuls, attention products;
  elementwise ops count 0, as its formulas do), times ``chips``, as the
  reference scales its per-device cost analysis;
* ``hlo_bytes``: the bytes every non-view local aten op reads and writes
  (its tensor operands and results, each counted at every op: no fusion,
  no cache), times ``chips``;
* ``collectives``: wire bytes by kind, one device's, at the reference's
  ring multipliers (``roofline.collective_bytes``), and
  ``collective_calls``, the number of each;
* the ``Roofline`` terms on the H100's data-sheet rates.

Records go to ``results/dryrun_torch/`` (git-ignored). A decode cell's
``index`` is the last position of its cache (the program's costs do not
depend on it). ``run_s`` is the seconds the step ran, ``host_s`` those of
the whole cell (placing the inputs included; an extrapolated cell sums its
two runs). One default group per process: ``run_cell`` sets up a fake
group for its cell and tears it down, unless a ``mesh`` over a group that
exists is passed in.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import dtensors
from repro_torch.analysis import roofline as rl
from repro_torch.configs import ARCH_IDS, SKIPS, get_config
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as T
from repro_torch.models.config import LM_SHAPES
from repro_torch.ops import ExecutionContext
from repro_torch.plan import H100
from repro_torch.train.optimizer import AdamWConfig, AdamWState
from repro_torch.train.trainer import (TrainConfig, make_train_step,
                                      place_on_mesh)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# the dry run's execution policy: fake shards on the host, plain versions
DRYRUN_CTX = ExecutionContext(target=H100, backend="torch", device="cpu")


def ensure_dryrun_devices() -> int:
    """The largest fake group a dry run sets up (``REPRO_DRYRUN_DEVICES``,
    default 512): the reference's fake-device count. Nothing process-wide
    changes; each cell's group comes and goes with the cell."""
    return int(os.environ.get("REPRO_DRYRUN_DEVICES", "512"))


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake default process group of ``world_size`` ranks (this process
    is rank 0) for the body of the ``with``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if world_size > ensure_dryrun_devices():
        raise ValueError(f"a fake group of {world_size} ranks is above "
                         f"REPRO_DRYRUN_DEVICES={ensure_dryrun_devices()}")
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already: pass "
                           "a mesh over it instead")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Step builders (what runs per cell kind)
# ---------------------------------------------------------------------------

def build_train_step(cfg, mesh, n_groups: int, act_seq_shard: bool = True,
                     loss_chunks: Optional[int] = None, remat: bool = True,
                     ctx: ExecutionContext = DRYRUN_CTX):
    ba = shd.batch_axes(mesh)
    act = shd.P(ba, "model", None) if act_seq_shard else shd.P(ba, None,
                                                               None)
    if loss_chunks is None:
        loss_chunks = 16 if cfg.vocab_size > 32000 else 4
    tc = TrainConfig(remat=remat, n_groups=n_groups, loss_chunks=loss_chunks,
                     act_spec=act, ctx=ctx)
    return make_train_step(cfg, AdamWConfig(), tc)


def build_prefill_step(cfg, n_groups: int, act_spec=None,
                       ctx: ExecutionContext = DRYRUN_CTX):
    @torch.no_grad()
    def prefill_step(params, cache, batch):
        if cfg.causal:
            logits, cache, _ = T.forward(
                params, cfg, tokens=batch.get("tokens"),
                embeds=batch.get("embeds"), cache=cache, cache_index=0,
                n_groups=n_groups, act_spec=act_spec, ctx=ctx)
            return _whole_rows(logits[:, -1]), cache
        # encoder: full bidirectional forward, no cache
        logits, _, _ = T.forward(params, cfg, tokens=batch.get("tokens"),
                                 embeds=batch.get("embeds"),
                                 n_groups=n_groups, act_spec=act_spec,
                                 ctx=ctx)
        return logits, cache
    return prefill_step


def _whole_rows(logits):
    """Last-token logits (B, V) with the batch on the data axes and each
    row whole on every device: the placement the reference's compiled
    prefill returns them in (its output sharding is left to the compiler,
    which gathers the vocabulary)."""
    if not dtensors.is_dtensor(logits):
        return logits
    from repro_torch.models import spmd

    return spmd.constrain(
        logits, shd.P(shd.batch_axes(logits.device_mesh), None))


def build_decode_step(cfg, n_groups: int,
                      ctx: ExecutionContext = DRYRUN_CTX):
    @torch.no_grad()
    def serve_step(params, cache, token, index):
        logits, cache, _ = T.forward(params, cfg, tokens=token, cache=cache,
                                     cache_index=index, decode=True,
                                     n_groups=n_groups, ctx=ctx)
        return logits[:, -1], cache
    return serve_step


# ---------------------------------------------------------------------------
# Sharding assembly per cell
# ---------------------------------------------------------------------------

def cell_shardings(arch: str, shape_name: str, mesh, cfg=None):
    """The cell's specs, as the reference's (parameters and moments keyed
    by the port's parameter names)."""
    cfg = cfg or get_config(arch)
    shape = LM_SHAPES[shape_name]
    ba = shd.batch_axes(mesh)
    P = shd.P
    pspec = shd.param_specs(cfg)
    out: Dict[str, Any] = {}
    if shape.kind == "train":
        out["params"] = pspec
        out["opt_state"] = AdamWState(step=P(), m=pspec, v=dict(pspec))
        bspecs = {}
        if cfg.inputs_are_embeddings:
            bspecs["embeds"] = P(ba, "model", None)
            bspecs["labels" if not cfg.causal else "tokens"] = P(ba, None)
        else:
            bspecs["tokens"] = P(ba, None)
        out["batch"] = bspecs
    elif shape.kind == "prefill":
        out["params"] = pspec
        out["cache"] = shd.cache_specs(cfg, mesh, shape.global_batch,
                                       shape.seq_len)
        bspecs = {}
        if cfg.inputs_are_embeddings:
            bspecs["embeds"] = P(ba, None, None)
            bspecs["labels" if not cfg.causal else "tokens"] = P(ba, None)
        else:
            bspecs["tokens"] = P(ba, None)
        out["batch"] = bspecs
    else:  # decode
        sizes = shd.mesh_axis_sizes(mesh)
        dsize = math.prod(sizes[a] for a in shd.data_axes(mesh))
        tok_spec = P(ba, None) if shape.global_batch % max(dsize, 1) == 0 \
            and shape.global_batch > 1 else P(None, None)
        out["params"] = pspec
        out["cache"] = shd.cache_specs(cfg, mesh, shape.global_batch,
                                       shape.seq_len)
        out["token"] = tok_spec
        out["index"] = P()
    return out


# ---------------------------------------------------------------------------
# Placing fake inputs, counting bytes
# ---------------------------------------------------------------------------

def _leaf_bytes(t) -> int:
    if isinstance(t, int):
        return 4  # an int32 scalar, as the reference's traced index
    if torch.is_tensor(t):
        local = _local(t)
        return local.numel() * local.element_size()
    return 0


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def argument_bytes(tree, reads=None) -> int:
    """The bytes this device holds of ``tree``'s leaves (a DTensor's local
    shard, a module's parameters, an int as an int32 scalar). With
    ``reads`` (the storages a step run on ``tree`` read, or returned
    without overwriting them: ``_drive``'s), only those tensor leaves: the
    reference's jit prunes an argument nothing uses (``keep_unused=False``)
    before it counts."""
    return sum(_leaf_bytes(t) for t in _leaves(tree)
               if reads is None or not torch.is_tensor(t)
               or rl.storage_key(_local(t)) in reads)


def _local(t):
    return t.to_local() if dtensors.is_dtensor(t) else t


def _place(struct, sharding, requires_grad: bool = False):
    """A fake DTensor of ``struct``'s shape and dtype (under the caller's
    ``FakeTensorMode``), placed by ``sharding``."""
    t = torch.empty(struct.shape, dtype=struct.dtype, device="cpu")
    d = sharding.place(t)
    return torch.nn.Parameter(d, requires_grad=True) if requires_grad else d


def _place_tree(structs, shardings_):
    if isinstance(structs, dict):
        return {k: _place_tree(v, shardings_[k]) for k, v in structs.items()}
    return _place(structs, shardings_)


def place_params(cfg, structs: Dict[str, torch.Tensor], shardings_,
                 requires_grad: bool):
    """A ``Transformer`` (built on the meta device) whose parameters are
    fake DTensors placed by ``shardings_`` (call under ``FakeTensorMode``)."""
    from repro_torch.train.trainer import _owner

    with torch.device("meta"):
        model = T.Transformer(cfg)
    for name, s in structs.items():
        mod, leaf = _owner(model, name)
        mod._parameters[leaf] = torch.nn.Parameter(
            shardings_[name].place(torch.empty(s.shape, dtype=s.dtype,
                                               device="cpu")),
            requires_grad=requires_grad)
    return model


def _drive(step, args, chips: int) -> dict:
    """Run ``step(*args)`` once under the cost recorder; the raw record."""
    cost = rl.CostMode()
    t0 = time.time()
    with cost:
        out = step(*args)
    run_s = time.time() - t0
    calls: Dict[str, int] = {}
    for kind, _ in cost.collectives:
        calls[kind] = calls.get(kind, 0) + 1
    return {"out": out, "run_s": run_s, "flops": cost.flops,
            "bytes accessed": cost.bytes_accessed,
            "records": list(cost.collectives), "calls": calls,
            "temp_bytes": cost.peak_live_bytes,
            # what an op read, or the step returns without overwriting it:
            # the arguments the reference's compiled step keeps
            "reads": cost.reads | ({rl.storage_key(_local(t))
                                    for t in _leaves(out)
                                    if torch.is_tensor(t)} - cost.writes)}


def count_train_step(cfg, mesh_shape, batch: Dict[str, torch.Tensor],
                     train_cfg: TrainConfig,
                     opt_cfg: Optional[AdamWConfig] = None) -> dict:
    """One step of ``Trainer(..., mesh=)``'s program on a fake group of
    ``data x model`` ranks: the same step (``make_train_step`` with
    ``train_cfg``, on a CPU context), parameters and moments placed by
    ``param_specs``, ``batch`` (tensors or meta tensors: shapes and
    dtypes) placed as the trainer places it (``trainer.place_on_mesh``).
    Returns ``collectives`` (wire bytes by kind), ``calls`` and
    ``argument_bytes`` of device 0."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    data, model = mesh_shape
    tc = dataclasses.replace(train_cfg, ctx=DRYRUN_CTX)
    step = make_train_step(cfg, opt_cfg or AdamWConfig(), tc)
    with fake_group(data * model):
        mesh = make_host_mesh(data, model, device_type="cpu")
        pshard = shd.shardings(mesh, shd.param_specs(cfg))
        structs = sp.param_structs("", cfg.param_dtype, cfg)
        step0 = torch.zeros((), dtype=torch.int32)  # a real step
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = place_params(cfg, structs, pshard, True)
            f32 = {n: _place(torch.empty(s.shape, dtype=torch.float32,
                                         device="meta"), pshard[n])
                   for n, s in structs.items()}
            opt = AdamWState(step0, f32, {n: torch.zeros_like(t)
                                          for n, t in f32.items()})
            placed = place_on_mesh(
                {k: torch.empty(v.shape, dtype=v.dtype, device="cpu")
                 for k, v in batch.items()}, mesh, tc.microbatches)
            args_b = argument_bytes((params, opt, placed))
            raw = _drive(step, (params, opt, placed), data * model)
    return {"collectives": rl.collective_bytes(raw["records"]),
            "calls": raw["calls"], "argument_bytes": args_b,
            "flops": raw["flops"], "run_s": raw["run_s"]}


def count_decode_step(cfg, mesh_shape, batch: int, seq_len: int,
                      index: Optional[int] = None,
                      cache_dtype=torch.bfloat16) -> dict:
    """One ``build_decode_step`` of ``cfg`` on a fake group of ``data x
    model`` ranks (``mesh_shape``): parameters placed by ``param_specs``
    (in ``cfg.param_dtype``), a ``batch`` x ``seq_len`` cache of
    ``cache_dtype`` by ``cache_specs``, the (batch, 1) int32 token as a
    decode cell places it, the index an int (default the cache's last
    position: the program does not depend on it). Returns
    ``collectives`` (wire bytes by kind), ``calls`` and
    ``argument_bytes`` of device 0: every argument, as a rank of a real
    group counts its own (:func:`argument_bytes` without pruning)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    data, model = mesh_shape
    chips = data * model
    step = build_decode_step(cfg, math.gcd(batch, chips))
    with fake_group(chips):
        mesh = make_host_mesh(data, model, device_type="cpu")
        sizes = shd.mesh_axis_sizes(mesh)
        dsize = math.prod(sizes[a] for a in shd.data_axes(mesh))
        tok_spec = (shd.P(shd.batch_axes(mesh), None)
                    if batch % max(dsize, 1) == 0 and batch > 1
                    else shd.P(None, None))
        pshard = shd.shardings(mesh, shd.param_specs(cfg))
        cshard = shd.shardings(mesh, shd.cache_specs(cfg, mesh, batch,
                                                     seq_len))
        structs = sp.param_structs("", cfg.param_dtype, cfg)
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = place_params(cfg, structs, pshard, False)
            cache = _place_tree(T.init_cache(cfg, batch, seq_len,
                                             dtype=cache_dtype,
                                             device="meta"), cshard)
            token = _place(torch.empty((batch, 1), dtype=torch.int32,
                                       device="meta"),
                           shd.NamedSharding(mesh, tok_spec))
            args = (params, cache, token,
                    seq_len - 1 if index is None else index)
            args_b = argument_bytes(args)
            raw = _drive(step, args, chips)
    return {"collectives": rl.collective_bytes(raw["records"]),
            "calls": raw["calls"], "argument_bytes": args_b,
            "flops": raw["flops"], "run_s": raw["run_s"]}


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _recurrent_heads(cfg) -> int:
    """Largest per-head chunk-decay width among recurrent blocks (0 if none)."""
    h = 0
    for kind in cfg.pattern:
        if kind == "mamba":
            di = cfg.d_inner
            h = max(h, di // cfg.hd if di % cfg.hd == 0 else 1)
        elif kind == "mlstm":
            h = max(h, cfg.n_heads)
    return h


def choose_chunk(cfg, shape) -> int:
    """Dry-run chunk size for recurrent blocks (the reference's rule): the
    chunk count nc = L/c multiplies the program's length, the intra-chunk
    decay tensor (B, c, c, H) its footprint. The largest c with B*c^2*H <=
    ~1.4e11 elements, nc <= 16, c a power-of-two divisor of L in [256,
    4096]."""
    H = _recurrent_heads(cfg)
    if H == 0 or shape.kind == "decode":
        return cfg.chunk_size
    L, B = shape.seq_len, shape.global_batch
    budget = 1.4e11  # global f32 elements for one decay tensor
    c = int(math.sqrt(budget / max(B * H, 1)))
    c = max(256, min(c, 4096, L))
    c2 = 256
    while c2 * 2 <= c and L % (c2 * 2) == 0:
        c2 *= 2
    while L // c2 > 16:
        c2 *= 2
    return min(c2, L)


def _finish(out: dict, chips: int) -> dict:
    out["compute_s"] = out["hlo_flops"] / (chips * rl.PEAK_FLOPS)
    out["memory_s"] = out["hlo_bytes"] / (chips * rl.HBM_BW)
    out["collective_s"] = out["wire_bytes_per_chip"] / rl.LINK_BW
    terms = {"compute": out["compute_s"], "memory": out["memory_s"],
             "collective": out["collective_s"]}
    out["dominant"] = max(terms, key=terms.get)
    out["step_time_s"] = max(terms.values())
    out["useful_flops_frac"] = out["model_flops"] / max(out["hlo_flops"], 1.0)
    out["mfu"] = out["model_flops"] / (
        out["step_time_s"] * chips * rl.PEAK_FLOPS + 1e-30)
    return out


def _save(rec: dict, arch: str, shape_name: str, mesh_name: str,
          variant: str) -> None:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = "" if variant == "base" else f"__{variant}"
    fn = os.path.join(RESULTS_DIR,
                      f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    with open(fn, "w") as f:
        json.dump(rec, f, indent=1)


def _extrapolate_cell(arch: str, shape_name: str, multi_pod: bool,
                      save: bool, verbose: bool, mesh, variant: str,
                      ov: dict) -> dict:
    """Two-point repeat extrapolation for the long recurrent cells (the
    reference's): the program is homogeneous in pattern repeats, so every
    additive cost (FLOPs, bytes, wire bytes by kind) is affine in R:
    cost(R) = cost(2) + (R-2) * (cost(2) - cost(1)). R=1 and R=2 run, the
    real depth is extrapolated."""
    cfg_full = get_config(arch)
    unit = len(cfg_full.pattern)
    R = cfg_full.repeats
    recs = []
    for r in (1, 2):
        ov_r = dict(ov)
        ov_r["_n_layers"] = unit * r
        recs.append(run_cell(arch, shape_name, multi_pod=multi_pod,
                             save=False, verbose=False, mesh=mesh,
                             variant=variant, overrides=ov_r))
    one, two = recs
    out = dict(two)
    out["run_s"] = one["run_s"] + two["run_s"]
    out["host_s"] = one["host_s"] + two["host_s"]

    def lin(a, b):
        return b + (R - 2) * (b - a)

    for key in ("hlo_flops", "hlo_bytes", "wire_bytes_per_chip"):
        out[key] = lin(one[key], two[key])
    out["collectives"] = {k: lin(one["collectives"][k], two["collectives"][k])
                          for k in two["collectives"]}
    out["bytes_per_device"] = {
        k: (lin(one["bytes_per_device"][k], two["bytes_per_device"][k])
            if k in ("argument_bytes", "output_bytes")
            else two["bytes_per_device"][k])  # temps: buffer-reuse bound
        for k in two["bytes_per_device"]}
    out["model_flops"] = rl.model_flops(arch, shape_name)
    _finish(out, out["chips"])
    out["extrapolated"] = f"R=1,2 -> R={R}"
    if verbose:
        print(f"[{arch} x {shape_name} x {out['mesh']}] (extrapolated "
              f"R={R}) compute={out['compute_s']*1e3:.2f}ms "
              f"memory={out['memory_s']*1e3:.2f}ms "
              f"collective={out['collective_s']*1e3:.2f}ms "
              f"dominant={out['dominant']} mfu={out['mfu']:.3f}", flush=True)
    if save:
        _save(out, arch, shape_name, out["mesh"], variant)
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             save: bool = True, verbose: bool = True, mesh=None,
             variant: str = "base", overrides: Optional[dict] = None) -> dict:
    """One cell's record (module docstring). ``overrides`` (recorded under
    ``variant``), as the reference's:
        act_seq_shard: bool   sequence-parallel activations (default True)
        loss_chunks: int      chunked cross-entropy chunk count
        remat: bool           unit recomputation (default True)
        param_dtype: str      "float32" (default) | "bfloat16" train params
        chunk_size: int       recurrent-block chunk length
        moe_groups: int       MoE dispatch group count
        moe_shard_hints: bool pin the MoE dispatch layout (the G <-> E
                              reshard an all-to-all each way)
        cache_seq_axis: str   "model" (default) | "none" decode KV layout
        _n_layers: int        depth cut
    With ``mesh=None`` a fake group of 256 (512 with ``multi_pod``) ranks
    is set up for the cell and torn down after."""
    t_start = time.time()
    ov = overrides or {}
    shape = LM_SHAPES[shape_name]
    cfg = get_config(arch)
    if ("_n_layers" not in ov and shape.kind != "decode"
            and _recurrent_heads(cfg) > 0 and cfg.repeats > 2
            and os.environ.get("REPRO_NO_EXTRAPOLATE", "0") != "1"):
        return _extrapolate_cell(arch, shape_name, multi_pod, save, verbose,
                                 mesh, variant, ov)
    if mesh is None:
        with fake_group(512 if multi_pod else 256):
            return run_cell(arch, shape_name, multi_pod, save, verbose,
                            make_production_mesh(multi_pod=multi_pod,
                                                 device_type="cpu"),
                            variant, overrides)
    from torch._subclasses.fake_tensor import FakeTensorMode

    sizes = shd.mesh_axis_sizes(mesh)
    mesh_name = "x".join(str(s) for s in sizes.values())
    chips = math.prod(sizes.values())
    if "_n_layers" in ov:
        cfg = dataclasses.replace(cfg, n_layers=ov["_n_layers"])
    cfg = dataclasses.replace(
        cfg, chunk_size=ov.get("chunk_size", choose_chunk(cfg, shape)))
    if "param_dtype" in ov and shape.kind == "train":
        cfg = dataclasses.replace(cfg, param_dtype=ov["param_dtype"])
    if ov.get("moe_shard_hints"):
        cfg = dataclasses.replace(cfg, moe_shard_hints=True)
    if ov.get("fused_kv_cache"):
        cfg = dataclasses.replace(cfg, fused_kv_cache=True)
    if "compute_dtype" in ov:
        cfg = dataclasses.replace(cfg, compute_dtype=ov["compute_dtype"])
    n_groups = ov.get("moe_groups", sp.n_groups_for(shape, chips))

    inputs = sp.input_specs(arch, shape_name, cfg)
    specs = cell_shardings(arch, shape_name, mesh, cfg)
    if ov.get("cache_seq_axis") == "none" and "cache" in specs:
        specs["cache"] = shd.tree_map_specs(
            lambda s: shd.P(*[None if ax == "model" else ax for ax in s]),
            specs["cache"])
    sh = shd.shardings(mesh, specs)

    step0 = torch.zeros((), dtype=torch.int32)  # a real step: the schedule
    with FakeTensorMode(allow_non_fake_inputs=True):
        train = shape.kind == "train"
        params = place_params(cfg, inputs["params"], sh["params"], train)
        if train:
            st = inputs["opt_state"]
            opt = AdamWState(
                step0,
                _place_tree(st.m, sh["opt_state"].m),
                _place_tree(st.v, sh["opt_state"].v))
            batch = _place_tree(inputs["batch"], sh["batch"])
            step = build_train_step(
                cfg, mesh, n_groups,
                act_seq_shard=ov.get("act_seq_shard", True),
                loss_chunks=ov.get("loss_chunks"),
                remat=ov.get("remat", True))
            args = (params, opt, batch)
        elif shape.kind == "prefill":
            ba = shd.batch_axes(mesh)
            act = (shd.P(ba, "model", None) if ov.get("act_seq_shard", True)
                   else shd.P(ba, None, None))
            step = build_prefill_step(cfg, n_groups, act_spec=act)
            args = (params, _place_tree(inputs["cache"], sh["cache"]),
                    _place_tree(inputs["batch"], sh["batch"]))
        else:
            step = build_decode_step(cfg, n_groups)
            args = (params, _place_tree(inputs["cache"], sh["cache"]),
                    _place(inputs["token"], sh["token"]), shape.seq_len - 1)
        raw = _drive(step, args, chips)
        # the decode position is a Python int here (the program's costs do
        # not depend on it), which no op reads as a tensor and every
        # forward turns into positions; the reference traces it as an
        # int32 argument that only attention reads
        args_b = argument_bytes(args[:3] if shape.kind == "decode" and
                                "attn" not in cfg.pattern else args,
                                reads=raw.pop("reads"))
        out = raw.pop("out")
        if train:  # (params, opt_state, metrics{loss, grad_norm, lr})
            out_b = argument_bytes(out[:2]) + 4 * len(out[2])
        else:
            out_b = argument_bytes(out)
        del out, args, params

    mem_d = {"argument_bytes": args_b, "output_bytes": out_b,
             "temp_bytes": raw["temp_bytes"],
             "peak_bytes": args_b + raw["temp_bytes"]}
    roof = rl.build(arch, shape_name, mesh_name, chips,
                    {"flops": raw["flops"],
                     "bytes accessed": raw["bytes accessed"]},
                    mem_d, raw["records"])
    rec = roof.to_dict()
    rec.update({
        "run_s": round(raw["run_s"], 2), "n_groups": n_groups,
        "multi_pod": multi_pod, "status": "ok", "variant": variant,
        "overrides": ov, "chunk_size": cfg.chunk_size,
        "collective_calls": raw["calls"], "n_layers": cfg.n_layers,
        "torch": torch.__version__,
        "host_s": round(time.time() - t_start, 2),
    })
    if verbose:  # bytes are one device's already: no division by chips
        print(f"[{arch} x {shape_name} x {mesh_name}] "
              f"compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"dominant={roof.dominant} mfu={roof.mfu:.3f} "
              f"args/dev={args_b/1e9:.2f}GB "
              f"temp/dev={raw['temp_bytes']/1e9:.2f}GB "
              f"(run {raw['run_s']:.0f}s)", flush=True)
    if save:
        _save(rec, arch, shape_name, mesh_name, variant)
    return rec


def main(argv=None):
    ensure_dryrun_devices()
    ap = argparse.ArgumentParser(description="multi-device dry run")
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape cell (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch in archs:
        shapes = [args.shape] if args.shape else \
            [s for s in LM_SHAPES if s not in SKIPS[arch]]
        for shape_name in shapes:
            if shape_name in SKIPS[arch]:
                print(f"[{arch} x {shape_name}] SKIP")
                continue
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                fn = os.path.join(RESULTS_DIR,
                                  f"{arch}__{shape_name}__{mesh_name}.json")
                if args.skip_existing and os.path.exists(fn):
                    print(f"[{arch} x {shape_name} x {mesh_name}] cached")
                    continue
                try:
                    run_cell(arch, shape_name, multi_pod=mp)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape_name, mesh_name, str(e)))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f[:3])
        raise SystemExit(1)
    print("\nALL CELLS GREEN")


if __name__ == "__main__":
    main()
