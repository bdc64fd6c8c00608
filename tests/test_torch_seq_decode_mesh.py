"""Decode over a KV cache sharded along its sequence (``cache_specs``: the
sequence on ``model``, or on every axis at batch 1), on 4 gloo ranks on
the CPU, held against the reference's own steps on one device.

Qwen2.5-3B's smoke config in f32, the reference's parameters carried over
by ``repro_torch.convert.transformer_from_jax``. Three cells: mesh (1, 4)
and (2, 2) at batch 4 (batch on ``data``, sequence on ``model``) and (2, 2)
at batch 1 (sequence on both axes, the long-context layout). Each rank
runs ``launch.dryrun.build_prefill_step`` on a prompt that spans every
shard, then ``build_decode_step`` twice with a scalar index and twice with
a per-row index (one row's query before the last shard: a negative local
offset, a shard with no valid key), on the ``torch`` backend (aten
partials) and on the ``cuda`` backend (the flash entry with row
statistics, its plain version on the CPU). The reference runs
``repro.launch.dryrun.build_prefill_step`` and ``build_decode_step`` on
the same tokens. Logits and the last cache (every shard's writes) agree
within 1e-5 of max(1, max|reference|) (f32 on both sides, the shards'
partials merged in another order); the reference's own mesh runs fail
under jax 0.9 here, so one device is the reference. The ranks are
subprocesses, joined under a time limit."""

import contextlib
import dataclasses
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mesh_train import _run_ranks

import repro.configs as jc
import repro_torch.configs as tc
from repro.launch import dryrun as jdr
from repro.models import transformer as JT
from repro_torch import dtensors
from repro_torch.convert import transformer_from_jax
from repro_torch.launch import dryrun as dr

# (mesh, batch): the sequence on model; on both axes at batch 1
CELLS = {"1x4_b4": ((1, 4), 4), "2x2_b4": ((2, 2), 4),
         "2x2_b1": ((2, 2), 1)}
LMAX, PROMPT = 48, 40  # 12 keys a shard; the prompt reaches the last one
# the per-row steps' indices: row 1 before the last shard (36 .. 47)
ROWS = np.array([42, 30, 45, 38], np.int32)
BACKENDS = ("torch", "cuda")


def _cfg(mod):
    return dataclasses.replace(mod.get_smoke("qwen2_5_3b"),
                               param_dtype="float32",
                               compute_dtype="float32")


def _tokens(cfg, B):
    rng = np.random.default_rng(4)
    return rng.integers(0, cfg.vocab_size, (B, PROMPT + 4)).astype(np.int32)


def _indices(B):
    """The four decode steps' indices: two scalar, two per row."""
    return [PROMPT, PROMPT + 1, ROWS[:B], ROWS[:B] + 1]


_RANK_CODE = textwrap.dedent('''
    import contextlib, os, sys, torch
    import torch.distributed as dist
    from repro_torch import dtensors, ops
    from repro_torch.analysis.roofline import CostMode, collective_bytes
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import sharding as shd
    from repro_torch.models import transformer as T
    from repro_torch.ops import ExecutionContext
    from repro_torch.plan import H100
    import dataclasses
    torch.set_num_threads(1)
    out_dir = sys.argv[1]
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo")
    cfg = dataclasses.replace(get_smoke("qwen2_5_3b"),
                              param_dtype="float32", compute_dtype="float32")
    state = torch.load(os.path.join(out_dir, "inputs.pt"),
                       weights_only=False)
    LMAX, PROMPT = state["lmax"], state["prompt"]
    out = {}
    for cell, (shape, B) in state["cells"].items():
        mesh = make_host_mesh(*shape, device_type="cpu")
        pshard = shd.shardings(mesh, shd.param_specs(cfg))
        with torch.device("meta"):
            model = T.Transformer(cfg)
        for name, _ in list(model.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            owner = model.get_submodule(mod) if mod else model
            owner._parameters[leaf] = torch.nn.Parameter(
                pshard[name].place(state["params"][name]),
                requires_grad=False)
        toks = state["tokens"][cell]
        ba = shd.batch_axes(mesh)
        tok_sh = shd.NamedSharding(mesh, shd.P(ba if B > 1 else None,
                                               None))
        cspecs = shd.shardings(mesh, shd.cache_specs(cfg, mesh, B, LMAX))
        for backend in state["backends"]:
            ctx = ExecutionContext(target=H100, backend=backend,
                                   device="cpu")
            cache = T.init_cache(cfg, B, LMAX, dtype=torch.float32,
                                 device="cpu")
            cache = {b: {n: cspecs[b][n].place(t) for n, t in l.items()}
                     for b, l in cache.items()}
            prefill = dr.build_prefill_step(cfg, 1, ctx=ctx)
            decode = dr.build_decode_step(cfg, 1, ctx=ctx)
            logits, cache = prefill(
                model, cache, {"tokens": tok_sh.place(toks[:, :PROMPT])})
            steps, wires = [logits.full_tensor()], []
            # the cuda route gathers as gloo ranks on the card do
            mode = (dtensors.all_reduce_gathers() if backend == "cuda"
                    else contextlib.nullcontext())
            with mode, ops.record_dispatch() as log:
                for i, idx in enumerate(state["indices"][cell]):
                    tok = tok_sh.place(toks[:, PROMPT + i:PROMPT + i + 1])
                    if i == 0:
                        args_b = dr.argument_bytes((model, cache, tok, idx))
                    count = CostMode(counts_only=True)
                    with count:
                        logits, cache = decode(model, cache, tok, idx)
                    wires.append(collective_bytes(count.collectives))
                    steps.append(logits.full_tensor())
            out[(cell, backend)] = {
                "logits": steps,
                "k": cache["b0"]["k"].full_tensor(),
                "placements": [getattr(p, "dim", None)
                               for p in cache["b0"]["k"].placements],
                "attention": [(d.chosen, d.measured_words) for d in log
                              if d.op == "attention"],
                "wire": wires, "argument_bytes": args_b}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
''')


def _reference(jcfg, jparams, toks, B):
    """The reference's prefill and decode steps on one device: each
    step's last-position logits and the last cache's first K leaf."""
    prefill = jax.jit(jdr.build_prefill_step(jcfg, 1))
    decode = jax.jit(jdr.build_decode_step(jcfg, 1))
    cache = JT.init_cache(jcfg, B, LMAX, dtype=jnp.float32)
    logits, cache = prefill(jparams, cache,
                            {"tokens": jnp.asarray(toks[:, :PROMPT])})
    steps = [np.asarray(logits)]
    for i, idx in enumerate(_indices(B)):
        logits, cache = decode(
            jparams, cache, jnp.asarray(toks[:, PROMPT + i:PROMPT + i + 1]),
            jnp.asarray(idx, jnp.int32))
        steps.append(np.asarray(logits))
    return steps, np.asarray(cache["b0"]["k"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_decode_mesh")
    jcfg, tcfg = _cfg(jc), _cfg(tc)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    model = transformer_from_jax(jparams, tcfg, "cpu")
    toks = {cell: _tokens(jcfg, B) for cell, (_, B) in CELLS.items()}
    batches = {B for _, B in CELLS.values()}  # the cells of a batch agree
    torch.save({"params": {n: p.detach() for n, p in
                           model.named_parameters()},
                "tokens": {c: torch.from_numpy(t) for c, t in toks.items()},
                "cells": CELLS, "lmax": LMAX, "prompt": PROMPT,
                "backends": BACKENDS,
                "indices": {c: [i if isinstance(i, int)
                                else torch.from_numpy(i)
                                for i in _indices(B)]
                            for c, (_, B) in CELLS.items()}},
               out / "inputs.pt")
    _run_ranks([sys.executable, "-c", _RANK_CODE], str(out))
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    ref = {B: _reference(jcfg, jparams, _tokens(jcfg, B), B)
           for B in batches}
    want = {cell: ref[B] for cell, (_, B) in CELLS.items()}
    counts = {}
    for cell, (shape, B) in CELLS.items():
        for backend in BACKENDS:
            mode = (dtensors.all_reduce_gathers() if backend == "cuda"
                    else contextlib.nullcontext())
            with mode:
                counts[cell, backend] = dr.count_decode_step(
                    tcfg, shape, B, LMAX, PROMPT, cache_dtype=torch.float32)
    return ranks, want, counts


def _close(got, want):
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_decode_matches_the_reference_on_one_device(runs, cell, backend):
    """Prefill and four decode steps (scalar, then per-row indices): every
    rank's logits, and the cache its shards wrote, as the reference's."""
    ranks, want, _ = runs
    steps, k = want[cell]
    for rec in ranks:
        got = rec[(cell, backend)]
        assert len(got["logits"]) == len(steps)
        for g, w in zip(got["logits"], steps):
            _close(g, w)
        # the port's cache is the reference's stacked (repeats, ...) leaf
        _close(got["k"], k)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cache_is_sharded_along_its_sequence(runs, cell):
    """``cache_specs``' placements: the sequence (dim 3 of the stacked
    leaf) on ``model``, or on both axes at batch 1."""
    B = CELLS[cell][1]
    want = [1, 3] if B > 1 else [3, 3]  # (data, model): the dims sharded
    for rec in runs[0]:
        for backend in BACKENDS:
            assert rec[(cell, backend)]["placements"] == want


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_shard_attends_through_the_chosen_backend(runs, cell):
    """Each decode step's attention is one dispatch a layer on each rank,
    on the backend asked for; on ``cuda`` the flash entry with row
    statistics (charged its counter), on ``torch`` aten (no counter)."""
    n_layers = 2
    for rec in runs[0]:
        for backend in BACKENDS:
            att = rec[(cell, backend)]["attention"]
            assert len(att) == 4 * n_layers
            assert {c for c, _ in att} == {backend}
            if backend == "cuda":
                assert all(w is not None and w > 0 for _, w in att)
            else:
                assert all(w is None for _, w in att)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_wire_and_argument_bytes_equal_the_dry_run(runs, cell, backend):
    """Every decode step's wire bytes by kind, and the argument bytes,
    equal ``dryrun.count_decode_step``'s count of the step on a fake group
    at the same shapes; the ``cuda`` route inside
    ``dtensors.all_reduce_gathers`` (as gloo ranks on the card gather) and
    its count too: all-reduces only."""
    count = runs[2][cell, backend]
    if backend == "cuda":
        assert set(count["calls"]) == {"all-reduce"}, count["calls"]
    for rec in runs[0]:
        got = rec[(cell, backend)]
        assert len(got["wire"]) == 4
        for step in got["wire"]:
            assert step == count["collectives"]
        assert got["argument_bytes"] == count["argument_bytes"]
