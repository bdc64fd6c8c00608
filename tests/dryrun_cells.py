"""The port's dry run and the reference's, both sides in subprocesses
started together, over any cells and mesh (``run_both``): what
``test_torch_dryrun_{attention,mixed}.py`` pin on a 2 x 2 mesh at
published widths cut to 2 layers, and what ``dryrun_parity.py`` tabulates.

Depth is cut to ``depth()``: the layers asked for, raised to a whole
number of the architecture's pattern units (Jamba-1.5's unit is 8). The
reference runs on fake XLA host devices with an Auto-axis mesh (its scans
rolled, ``REPRO_UNROLL_SCANS=0``, unless ``unroll``: a rolled body is
counted once), the port on a fake process group of the same size. The
records keep the figures the callers read; the reference's also the number
of leaves of its step's outputs, from its input specs (a step returns its
parameters and moments and three metrics, or its logits and its cache)."""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# cells whose argument bytes other files pin on 2 x 2 at 2 layers
# (test_torch_dryrun.py, test_torch_{moe,mamba,xlstm}_mesh.py); no file
# but the two above pins any cell's output bytes
PINNED = {("qwen2_5_3b", "train_4k"), ("qwen2_5_3b", "decode_32k"),
          ("internvl2_1b", "train_4k"), ("olmoe_1b_7b", "train_4k"),
          ("olmoe_1b_7b", "decode_32k"), ("phi3_5_moe_42b", "train_4k"),
          ("jamba_1_5_large", "train_4k"),
          ("jamba_1_5_large", "decode_32k"), ("xlstm_1_3b", "train_4k"),
          ("xlstm_1_3b", "prefill_32k"), ("xlstm_1_3b", "decode_32k"),
          ("xlstm_1_3b", "long_500k")}
# the bytes XLA counts for each leaf of a step's output tuple: the tuple's
# table of buffer addresses, which an eager step has no counterpart of
TUPLE_ENTRY_BYTES = 8

_CODE = textwrap.dedent('''
    import json, math, os, sys
    which, cells, mesh, unroll = (sys.argv[1], json.loads(sys.argv[2]),
                                  json.loads(sys.argv[3]), sys.argv[4])
    n = math.prod(mesh)
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    os.environ["REPRO_UNROLL_SCANS"] = unroll
    keep = ("bytes_per_device", "hlo_flops", "hlo_bytes", "collectives",
            "status", "chips", "mesh", "n_layers")
    out = {}
    if which == "ref":
        import dataclasses
        import jax
        from jax.sharding import AxisType
        from repro import configs
        from repro.launch import dryrun as jdr
        from repro.launch import specs as jsp
        from repro.models.config import LM_SHAPES
        jmesh = jax.make_mesh(tuple(mesh), ("data", "model"),
                              axis_types=(AxisType.Auto,) * 2)
        for arch, shape, layers in cells:
            r = jdr.run_cell(arch, shape, mesh=jmesh, save=False,
                             verbose=False, overrides={"_n_layers": layers})
            ins = jsp.input_specs(arch, shape, dataclasses.replace(
                configs.get_config(arch), n_layers=layers))
            outs = ((ins["params"], ins["opt_state"], [0] * 3)
                    if LM_SHAPES[shape].kind == "train"
                    else (0, ins["cache"]))
            out[arch + "/" + shape] = dict(
                {k: r[k] for k in keep if k in r},
                n_layers=layers, output_leaves=len(jax.tree.leaves(outs)))
    else:
        import torch
        torch.set_num_threads(1)
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import make_host_mesh
        with dr.fake_group(n):
            tmesh = make_host_mesh(*mesh, device_type="cpu")
            for arch, shape, layers in cells:
                r = dr.run_cell(arch, shape, mesh=tmesh, save=False,
                                verbose=False,
                                overrides={"_n_layers": layers})
                out[arch + "/" + shape] = {k: r[k] for k in keep}
    print("CELLS " + json.dumps(out))
''')


def depth(arch: str, layers: int = 2) -> int:
    """``layers`` raised to a whole number of ``arch``'s pattern units."""
    from repro_torch.configs import get_config

    unit = len(get_config(arch).pattern)
    return max(unit, layers // unit * unit)


def run_both(cells, mesh=(2, 2), layers: int = 2, unroll: bool = False,
             timeout: float = 600) -> dict:
    """``{"ref": {"arch/shape": record}, "port": {...}}`` of ``cells``
    ((arch, shape) pairs) on a (data, model) ``mesh``, each at
    ``depth(arch, layers)``, both sides at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    todo = json.dumps([(a, s, depth(a, layers)) for a, s in cells])
    procs = {which: subprocess.Popen(
        [sys.executable, "-c", _CODE, which, todo, json.dumps(list(mesh)),
         "1" if unroll else "0"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)
        for which in ("ref", "port")}
    got = {}
    try:
        for which, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=timeout)
            line = [x for x in stdout.splitlines() if x.startswith("CELLS ")]
            assert line, stdout[-2000:] + stderr[-4000:]
            got[which] = json.loads(line[0][len("CELLS "):])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return got


def check_argument_bytes(got, arch, shape) -> None:
    """``status`` ok on both sides, 4 chips, the per-device argument bytes
    exactly the reference's; FLOPs and wire bytes by kind printed beside
    the reference's (DTensor and GSPMD choose their collectives
    independently: not gated)."""
    key = f"{arch}/{shape}"
    ref, port = got["ref"][key], got["port"][key]
    assert port["status"] == ref["status"] == "ok"
    assert port["chips"] == 4 and port["mesh"] == "2x2"
    assert port["n_layers"] == ref["n_layers"]
    assert port["bytes_per_device"]["argument_bytes"] == \
        ref["bytes_per_device"]["argument_bytes"]
    print(json.dumps({"cell": key, "flops_port_over_ref":
                      port["hlo_flops"] / max(ref["hlo_flops"], 1.0),
                      "wire_bytes_port_ref": {
                          k: (port["collectives"][k], ref["collectives"][k])
                          for k in ref["collectives"]}}))
    assert port["hlo_flops"] > 0


def check_output_bytes(got, arch, shape) -> None:
    """The per-device output bytes are the reference's less its output
    tuple's table: ``TUPLE_ENTRY_BYTES`` for each leaf of the step's
    outputs."""
    key = f"{arch}/{shape}"
    ref, port = got["ref"][key], got["port"][key]
    assert port["bytes_per_device"]["output_bytes"] == \
        ref["bytes_per_device"]["output_bytes"] - \
        TUPLE_ENTRY_BYTES * ref["output_leaves"]
