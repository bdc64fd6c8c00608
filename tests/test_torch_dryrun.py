"""repro_torch.launch.{specs,dryrun}, repro_torch.analysis.{roofline,report}
against their reference counterparts.

Exact: ``input_specs`` for every cell of ``all_cells()`` (shapes and
dtypes, the reference's stacked (R, ...) parameter leaves as R leaves),
``n_groups_for``, ``choose_chunk`` and ``model_flops``; the per-device
argument bytes of ``run_cell`` on a 2 x 2 mesh with 2 layers for Qwen2.5-3B
``decode_32k`` and ``train_4k`` and InternVL2-1B ``train_4k``. Reported
side by side, not gated: FLOPs and wire bytes by kind (DTensor and GSPMD
choose their collectives independently). Both dry runs run in one
module-scoped subprocess: the reference on 4 fake XLA devices with an
Auto-axis mesh (jax 0.9's default mesh is Explicit), the port on a fake
process group of 4, then the port on the production (16, 16) mesh."""

import json
import os
import subprocess
import sys
import textwrap
from functools import lru_cache

import jax.numpy as jnp
import pytest
import torch

from repro import configs as jc
from repro.analysis import roofline as jrl
from repro.launch import dryrun as jdr
from repro.launch import specs as jsp
from repro.models.config import LM_SHAPES as J_SHAPES
from repro_torch import configs as tc
from repro_torch.analysis import report
from repro_torch.analysis import roofline as rl
from repro_torch.launch import dryrun as dr
from repro_torch.launch import specs as sp
from repro_torch.models.config import LM_SHAPES
from repro_torch.train.trainer import reference_leaf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = sorted((a, s.name) for a, s in tc.all_cells())


def _sd(x):
    """(shape, dtype name) of a jax struct or a torch tensor."""
    if torch.is_tensor(x):
        return tuple(x.shape), str(x.dtype).replace("torch.", "")
    return tuple(x.shape), jnp.dtype(x.dtype).name


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@lru_cache(maxsize=None)
def _ref_params(arch, dtype):
    return dict(_flat(jsp.param_structs(arch, dtype)))


def _check_params(arch, ours, dtype):
    """Every port leaf is the reference's stacked leaf at one repeat."""
    ref = _ref_params(arch, dtype)
    seen = set()
    for name, t in ours.items():
        leaf = reference_leaf(name)
        shape, dt = _sd(ref[leaf])
        if name.startswith("layers."):
            shape = shape[1:]
        assert _sd(t) == (shape, dt), name
        seen.add(leaf)
    assert seen == set(ref)
    n_port = sum(t.numel() for t in ours.values())
    n_ref = sum(int(torch.tensor(s.shape).prod()) for s in ref.values())
    assert n_port == n_ref


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_are_the_reference(arch, shape):
    got = sp.input_specs(arch, shape)
    s = J_SHAPES[shape]
    kind = s.kind
    jcfg = jc.get_config(arch)
    for t in (x for _, x in _flat({k: v for k, v in got.items()
                                   if k != "opt_state"})):
        assert t.device.type == "meta"
    if kind == "train":
        _check_params(arch, got["params"], "float32")
        st = got["opt_state"]
        assert _sd(st.step) == ((), "int32")
        assert st.m.keys() == got["params"].keys() == st.v.keys()
        assert all(_sd(st.m[n]) == (tuple(p.shape), "float32")
                   for n, p in got["params"].items())
    else:
        _check_params(arch, got["params"], "bfloat16")
        want = jsp.cache_structs(arch, s.global_batch, s.seq_len)
        assert {k: _sd(v) for k, v in _flat(got["cache"])} == \
            {k: _sd(v) for k, v in _flat(want)}
    if kind == "decode":
        assert _sd(got["token"]) == ((s.global_batch, 1), "int32")
        assert _sd(got["index"]) == ((), "int32")
    else:
        want = jsp.batch_structs(jcfg, s)
        assert {k: _sd(v) for k, v in got["batch"].items()} == \
            {k: _sd(v) for k, v in want.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_numbers_are_the_reference(arch, shape):
    s, js = LM_SHAPES[shape], J_SHAPES[shape]
    cfg, jcfg = tc.get_config(arch), jc.get_config(arch)
    for n in (1, 4, 256, 512):
        assert sp.n_groups_for(s, n) == jsp.n_groups_for(js, n)
    assert dr._recurrent_heads(cfg) == jdr._recurrent_heads(jcfg)
    assert dr.choose_chunk(cfg, s) == jdr.choose_chunk(jcfg, js)
    assert rl.model_flops(arch, shape) == jrl.model_flops(arch, shape)


def test_roofline_terms_and_dominance():
    r = rl.Roofline(arch="a", shape="train_4k", mesh="16x16", chips=256,
                    hlo_flops=256 * rl.PEAK_FLOPS,  # exactly 1 s of compute
                    hlo_bytes=0.0, wire_bytes_per_chip=rl.LINK_BW / 2,
                    collectives={}, model_flops=0.5 * 256 * rl.PEAK_FLOPS,
                    bytes_per_device={})
    assert r.compute_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(0.5)
    assert r.memory_s == 0.0
    assert r.dominant == "compute" and r.step_time_s == pytest.approx(1.0)
    assert r.mfu == pytest.approx(0.5)
    assert r.useful_flops_frac == pytest.approx(0.5)
    d = r.to_dict()
    assert d["dominant"] == "compute" and d["mfu"] == pytest.approx(0.5)
    # the reference's arithmetic on the same figures, with its rates
    j = jrl.Roofline(arch="a", shape="train_4k", mesh="16x16", chips=256,
                     hlo_flops=256 * jrl.PEAK_FLOPS, hlo_bytes=0.0,
                     wire_bytes_per_chip=jrl.ICI_BW / 2, collectives={},
                     model_flops=0.5 * 256 * jrl.PEAK_FLOPS,
                     bytes_per_device={})
    assert (j.compute_s, j.collective_s, j.mfu) == pytest.approx(
        (r.compute_s, r.collective_s, r.mfu))


def test_collective_bytes_and_build():
    recs = [("all-reduce", 128 * 256 * 4), ("all-gather", 64 * 512 * 2),
            ("reduce-scatter", 32 * 4), ("all-to-all", 16 * 16 * 2),
            ("collective-permute", 8 * 4), ("all-reduce", 4)]
    out = rl.collective_bytes(recs)
    assert out["all-reduce"] == (128 * 256 * 4 + 4) * 2
    assert out["all-gather"] == 64 * 512 * 2
    assert out["reduce-scatter"] == 32 * 4
    assert out["all-to-all"] == 16 * 16 * 2
    assert out["collective-permute"] == 8 * 4
    assert out["total"] == sum(v for k, v in out.items() if k != "total")
    r = rl.build("qwen2_5_3b", "train_4k", "2x2", 4,
                 {"flops": 10.0, "bytes accessed": 3.0}, {"x": 1}, recs)
    assert (r.hlo_flops, r.hlo_bytes, r.chips) == (40.0, 12.0, 4)
    assert r.wire_bytes_per_chip == out["total"]
    assert r.model_flops == rl.model_flops("qwen2_5_3b", "train_4k")


def test_cost_mode_counts_hand_counted_collectives():
    """Redistributions of known DTensors on a fake 2 x 2 mesh: one
    all-reduce, one all-gather, one reduce-scatter, each at its result's
    bytes; local ops' FLOPs by torch's formulas; nothing on the wire
    for a local chunk."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch.launch.mesh import make_host_mesh

    with dr.fake_group(4):
        mesh = make_host_mesh(2, 2, device_type="cpu")
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(8, 16), mesh,
                                  (Shard(0), Shard(1)), src_data_rank=None)
            cost = rl.CostMode()
            with cost:
                a = x.redistribute(mesh, (Shard(0), Replicate()))  # gather
                b = a.redistribute(mesh, (Shard(0), Shard(1)))  # chunk
                p = torch.nn.functional.linear(
                    b, distribute_tensor(torch.empty(4, 16), mesh,
                                         (Replicate(), Shard(1)),
                                         src_data_rank=None))
                assert p.placements == (Shard(0), Partial())
                p.redistribute(mesh, (Shard(0), Replicate()))  # all-reduce
                p.redistribute(mesh, (Shard(0), Shard(1)))  # reduce-scatter
    kinds = [k for k, _ in cost.collectives]
    assert sorted(kinds) == ["all-gather", "all-reduce", "reduce-scatter"]
    got = dict(cost.collectives)
    assert got["all-gather"] == 4 * 16 * 4  # this device's rows, whole
    assert got["all-reduce"] == 4 * 4 * 4
    assert got["reduce-scatter"] == 4 * 2 * 4
    assert cost.flops == 2 * 4 * 8 * 4  # the local (4, 8) x (8, 4) product
    assert rl.collective_bytes(cost.collectives)["all-reduce"] == 2 * 64


def _records():
    base = dict(chips=256, mesh="16x16", hlo_flops=256e12, hlo_bytes=256e9,
                wire_bytes_per_chip=2e9, model_flops=1e14,
                bytes_per_device={"temp_bytes": 3e9}, run_s=7.0,
                variant="base")
    recs = []
    for i, (arch, shape) in enumerate((("qwen2_5_3b", "decode_32k"),
                                       ("qwen2_5_3b", "train_4k"),
                                       ("jamba_1_5_large", "train_4k"))):
        r = dict(base, arch=arch, shape=shape)
        r["collectives"] = {"all-reduce": float(i), "total": float(i)}
        r.update(compute_s=1e-3 * (i + 1), memory_s=2e-3,
                 collective_s=1e-3 * 3 * i, dominant="memory",
                 step_time_s=max(2e-3, 3e-3 * i), useful_flops_frac=0.5,
                 mfu=0.1 * (i + 1))
        recs.append(r)
    return recs


def test_report_tables_read_the_records(tmp_path):
    recs = _records()
    for r in recs + [dict(recs[0], variant="other", mesh="2x16x16")]:
        name = f"{r['arch']}__{r['shape']}__{r['mesh']}_{r['variant']}.json"
        (tmp_path / name).write_text(json.dumps(r))
    loaded = report.load(directory=str(tmp_path))
    assert [(r["arch"], r["shape"]) for r in loaded] == [
        ("jamba_1_5_large", "train_4k"), ("qwen2_5_3b", "train_4k"),
        ("qwen2_5_3b", "decode_32k")]
    table = report.dryrun_table(loaded).splitlines()
    assert len(table) == 2 + 3
    assert "| qwen2_5_3b | decode_32k | 16x16 | 1.000e+12 | 1.000e+09 | " \
        "2.00GB | 3.00GB | 7s |" in table
    roof = report.roofline_table(loaded).splitlines()
    assert len(roof) == 5 and "**memory**" in roof[2]
    assert report.collective_breakdown(loaded, "qwen2_5_3b", "train_4k") \
        == {"all-reduce": 1.0, "total": 1.0}
    assert report.collective_breakdown(loaded, "x", "y") == {}
    picks = report.pick_hillclimb_cells(loaded)
    assert picks["worst_mfu"]["shape"] == "decode_32k"
    assert picks["most_collective"]["arch"] == "jamba_1_5_large"
    assert picks["paper_rep"]["arch"] == "jamba_1_5_large"
    assert report.pick_hillclimb_cells(loaded, mesh="4x4") == {}


def test_fake_group_refuses_a_second_group_and_too_many_ranks(monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DEVICES", "8")
    assert dr.ensure_dryrun_devices() == 8
    with pytest.raises(ValueError):
        with dr.fake_group(16):
            pass
    with dr.fake_group(4):
        with pytest.raises(RuntimeError):
            with dr.fake_group(4):
                pass


PARITY_CELLS = (("qwen2_5_3b", "decode_32k"), ("qwen2_5_3b", "train_4k"),
                ("internvl2_1b", "train_4k"))
PRODUCTION_CELLS = ("decode_32k", "prefill_32k")

_PARITY_CODE = textwrap.dedent('''
    import json, os, resource, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["REPRO_UNROLL_SCANS"] = "0"
    import jax
    from jax.sharding import AxisType
    from repro.launch import dryrun as jdr
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import make_host_mesh
    cells, prod = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    keep = ("bytes_per_device", "hlo_flops", "hlo_bytes", "collectives",
            "status", "chips", "mesh")
    out = {"ref": {}, "port": {}, "prod": {}}
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for arch, shape in cells:
        r = jdr.run_cell(arch, shape, mesh=mesh, save=False, verbose=False,
                         overrides={"_n_layers": 2})
        out["ref"][arch + "/" + shape] = {k: r[k] for k in keep}
    with dr.fake_group(4):
        tmesh = make_host_mesh(2, 2, device_type="cpu")
        for arch, shape in cells:
            r = dr.run_cell(arch, shape, mesh=tmesh, save=False,
                            verbose=False, overrides={"_n_layers": 2})
            out["port"][arch + "/" + shape] = {k: r[k] for k in keep}
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    for shape in prod:
        r = dr.run_cell("qwen2_5_3b", shape, save=False, verbose=False)
        out["prod"][shape] = {k: r[k] for k in keep}
    out["prod_rss_growth_kb"] = (
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0)
    print("PARITY " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def parity():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _PARITY_CODE, json.dumps(PARITY_CELLS),
         json.dumps(PRODUCTION_CELLS)],
        capture_output=True, text=True, timeout=600, env=env)
    line = [x for x in res.stdout.splitlines() if x.startswith("PARITY ")]
    assert line, res.stdout[-2000:] + res.stderr[-4000:]
    return json.loads(line[0][len("PARITY "):])


@pytest.mark.parametrize("arch,shape", PARITY_CELLS)
def test_run_cell_argument_bytes_are_the_reference(parity, arch, shape):
    """Per-device argument bytes exact; FLOPs and wire bytes by kind
    printed beside the reference's (ratios, not gated)."""
    key = f"{arch}/{shape}"
    ref, port = parity["ref"][key], parity["port"][key]
    assert port["status"] == ref["status"] == "ok"
    assert port["chips"] == 4 and port["mesh"] == "2x2"
    assert port["bytes_per_device"]["argument_bytes"] == \
        ref["bytes_per_device"]["argument_bytes"]
    ratios = {k: (port["collectives"][k], ref["collectives"][k])
              for k in ref["collectives"]}
    print(json.dumps({"cell": key, "flops_port_over_ref":
                      port["hlo_flops"] / max(ref["hlo_flops"], 1.0),
                      "output_bytes": (port["bytes_per_device"]
                                       ["output_bytes"],
                                       ref["bytes_per_device"]
                                       ["output_bytes"]),
                      "wire_bytes_port_ref": ratios}))
    assert port["hlo_flops"] > 0 and port["collectives"]["total"] > 0


@pytest.mark.parametrize("shape", PRODUCTION_CELLS)
def test_run_cell_on_the_production_mesh(parity, shape):
    """Qwen2.5-3B's serving cells at full depth on (16, 16): they run
    (heads that do not divide the model axis are gathered and counted),
    on fake shards: the process grows by far less than one device's
    arguments."""
    rec = parity["prod"][shape]
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["mesh"] == "16x16"
    args = rec["bytes_per_device"]["argument_bytes"]
    assert args > 5e8
    assert parity["prod_rss_growth_kb"] * 1024 < args / 4
    assert rec["collectives"]["all-gather"] > 0


def test_cost_mode_tells_reads_from_overwrites():
    """``CostMode.reads`` and ``writes``: an op's operands are reads, a
    ``copy_``'s or ``fill_``'s destination only a write, an ``add_``'s a
    read; a view reads nothing (its later use reads its base's storage),
    nor does a ``*_like`` or ``new_*`` factory its shape's source.
    ``argument_bytes(reads=)`` counts the leaves read."""
    a, b, c, d, e = (torch.ones(4, 4) for _ in range(5))
    shapes = [torch.ones(4, 4) for _ in range(4)]
    cost = rl.CostMode()
    with cost:
        a.t()  # a view alone
        b.t().sum()  # a view's use reads its base
        c.copy_(a * 2)  # the multiply reads a; the copy overwrites c
        d.add_(1.0)  # reads and writes d
        e.fill_(0.0)
        torch.zeros_like(shapes[0])
        torch.empty_like(shapes[1])
        torch.full_like(shapes[2], 3.0)
        shapes[3].new_zeros((2, 2))
    key = rl.storage_key
    assert cost.reads >= {key(a), key(b), key(d)}
    assert key(c) not in cost.reads and key(e) not in cost.reads
    assert not {key(t) for t in shapes} & cost.reads
    assert {key(c), key(e)} <= cost.writes and key(d) not in cost.writes
    assert dr.argument_bytes((a, b, c, d, e), reads=cost.reads) == 3 * 64
    assert dr.argument_bytes((a, 7), reads=set()) == 4  # an int: kept


def test_cells_table_pairs_a_cells_meshes():
    """``report.cells_table``: one row a cell, each field "16x16 ;
    2x16x16" where both meshes are recorded."""
    recs = []
    for i, r in enumerate(_records()[:2]):
        r = dict(r, bytes_per_device={"argument_bytes": 2e9,
                                      "output_bytes": 1e6,
                                      "temp_bytes": 3e3},
                 collectives={"all-gather": 5e9}, host_s=1.5)
        recs.append(r)
        if i == 0:
            recs.append(dict(r, mesh="2x16x16", chips=512))
    rows = report.cells_table(recs).splitlines()
    assert len(rows) == 2 + 2
    assert rows[2] == ("| qwen2_5_3b | decode_32k | 16x16 ; 2x16x16 | "
                       "2.00GB ; 2.00GB | 1.0MB ; 1.0MB | 3KB ; 3KB | "
                       "1.000e+12 ; 5.000e+11 | 0 / 5.00GB / 0 / 0 / 0 ; "
                       "0 / 5.00GB / 0 / 0 / 0 | 1.5s ; 1.5s |")
    assert rows[3].startswith("| qwen2_5_3b | train_4k | 16x16 | 2.00GB |")
