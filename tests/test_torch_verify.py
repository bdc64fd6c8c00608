"""The port's static communication auditor (``repro_torch.verify``) on the
CPU: the hazard detector against the reference's on the reference's own
schedules; the port's sweep under ``TPU_V5E`` against the reference's
baseline rows and its live ``ops.explain(..., audit=True)``; every
main-path dispatch of ``chip_smoke.py``'s phase 16 audited under ``H100``
at full width (counted words equal to the counter, the plan's launch equal
to the kernel's launch configuration); the words the counters do not charge
pinned to their formulas; the seeded mutants, the lint, the plan hook, the
sweep script and ``CudaKernel.last_launch``.

Every comparison is exact (words are integers or multiples of 1/4), except
``bound_ratio`` against the baseline, held within 1e-12 (a float quotient).
"""

import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the reference, on the CPU)
import numpy as np
import pytest
import torch

from repro.verify import hazards as ref_hz
from repro_torch import ops
from repro_torch.configs.resnet50_convs import RESNET50
from repro_torch.kernels import KERNELS, paged_decode_hbm_words
from repro_torch.kernels import conv1d as k_conv1d
from repro_torch.kernels.conv2d import _launch_geometry
from repro_torch.kernels.flash_attention import (paged_decode_access_plan,
                                                 paged_decode_issued_words,
                                                 paged_launch_config)
from repro_torch.kernels.quant import (_matmul_spec_q, conv_launch_config,
                                       matmul_launch_config,
                                       matmul_q_access_plan,
                                       matmul_q_hbm_words)
from repro_torch.plan import H100, ConvSpec, Planner
from repro_torch.plan import planner as port_planner
from repro_torch.verify import audit as au
from repro_torch.verify import hazards as hz
from repro_torch.verify import lint, mutants

ROOT = Path(__file__).resolve().parents[1]
BASELINE = json.loads((ROOT / "benchmarks" / "baselines" / "VERIFY.json")
                      .read_text())
PY = sys.executable


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def script():
    return _load("verify_torch_script", ROOT / "scripts" / "verify_torch.py")


@pytest.fixture(scope="module")
def tpu_rows(script):
    return {r["name"]: r for r in script.sweep_tpu_v5e()}


@pytest.fixture(scope="module")
def h100_rows(script):
    return {r["name"]: r for r in script.sweep_h100()}


def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- hazards: the reference's event kinds give the reference's hazards ------

def _forms(sched):
    """The schedule and its three mutated forms: no waits, every start into
    slot 0, no reads."""
    yield sched
    yield dataclasses.replace(sched, events=tuple(
        e for e in sched.events if e.kind != "wait"))
    yield dataclasses.replace(sched, events=tuple(
        dataclasses.replace(e, slot=0) if e.kind == "start" else e
        for e in sched.events))
    yield dataclasses.replace(sched, events=tuple(
        e for e in sched.events if e.kind != "read"))


@pytest.mark.parametrize("n_slots", (2, 3, 4))
@pytest.mark.parametrize("n_steps", range(1, 9))
def test_hazards_parity_with_the_reference(n_steps, n_slots):
    ref = ref_hz.double_buffered_schedule(n_steps, n_slots)
    port = hz.double_buffered_schedule(n_steps, n_slots)
    assert [(e.kind, e.slot, e.step) for e in port.events] == \
        [(e.kind, e.slot, e.step) for e in ref.events]
    for r, p in zip(_forms(ref), _forms(port)):
        want = [(h.code, h.event_index) for h in ref_hz.check_schedule(r)]
        got = [(h.code, h.event_index) for h in hz.check_schedule(p)]
        assert got == want


# -- TPU_V5E: the reference's 29 rows ----------------------------------------

# rows no CUDA launch configuration takes under TPU_V5E: accumulator tiles
# past one CTA's registers (the convs, the GEMMs), flash blocks of 512 (not
# compiled)
REFUSED = {
    "conv2d/conv1/cuda", "conv2d/conv1/im2col", "conv2d/conv2_x/cuda",
    "conv2d/conv2_x/im2col", "conv2d/conv3_x/cuda", "conv2d/conv3_x/im2col",
    "conv2d/conv4_x/cuda", "conv2d/conv4_x/im2col", "conv2d/conv5_x/cuda",
    "conv2d/conv5_x/im2col", "matmul/512x384x256", "matmul/2048x2048x2048",
    "matmul/23328x576x64", "conv2d_q/conv1/cuda", "conv2d_q/conv2_x/cuda",
    "conv2d_q/conv3_x/cuda", "conv2d_q/conv4_x/cuda", "conv2d_q/conv5_x/cuda",
    "matmul_q/512x384x256", "matmul_q/2048x2048x2048",
    "attention/prefill_B2_H8_L128", "attention_contig/decode/B4_len12",
    "attention_contig/decode/B4_len50", "attention_contig/decode/B4_len200",
}


def _port_name(name: str) -> str:
    return name.replace("/pallas", "/cuda")


@pytest.mark.parametrize("ref", BASELINE, ids=[r["name"] for r in BASELINE])
def test_tpu_v5e_rows_reproduce_the_baseline(ref, tpu_rows):
    name = _port_name(ref["name"])
    row = tpu_rows[name]
    assert row["measured_words"] == ref["measured_words"]
    if ref["bound_ratio"] is None:
        assert row["bound_ratio"] is None
    else:
        assert abs(row["bound_ratio"] - ref["bound_ratio"]) <= 1e-12
    if name in REFUSED:
        assert row["audited_words"] is None and row["refused"]
    else:
        assert row["audited_words"] == ref["audited_words"]


def test_tpu_v5e_sweep_order_and_refusals(tpu_rows):
    assert list(tpu_rows) == [_port_name(r["name"]) for r in BASELINE]
    assert {n for n, r in tpu_rows.items()
            if r["audited_words"] is None} == REFUSED


def test_reference_live_audit_agrees(tpu_rows):
    """The reference's own sweep, run live (``ops.explain(...,
    audit=True)``), gives the baseline's words, which the port's rows
    reproduce."""
    ref = _load("reference_verify_script", ROOT / "scripts" / "verify.py")
    live = (ref.sweep_convs() + ref.sweep_gemm_conv1d() + ref.sweep_quant()
            + ref.sweep_attention())
    assert [r["name"] for r in live] == [r["name"] for r in BASELINE]
    for r in live:
        row = tpu_rows[_port_name(r["name"])]
        assert r["audited_words"] == r["measured_words"]
        assert row["measured_words"] == r["measured_words"]
        if row["audited_words"] is not None:
            assert row["audited_words"] == r["audited_words"]


# -- H100: every main-path dispatch of phase 16 ------------------------------

H100_ROWS = (
    [f"conv2d/{n}/{be}" for n in RESNET50 for be in ("cuda", "im2col")]
    + [f"conv2d_q/{n}/cuda" for n in RESNET50]
    + ["matmul_q/512x384x256", "matmul_q/2048x2048x2048",
       "matmul_q/conv5_x Im2Col 49000x4608x512",
       "attention/qwen prefill Lq176_Lk512",
       "attention/qwen contiguous decode B4_Lk512",
       "attention_decode/qwen paged B4_w13"]
    + [f"conv1d_causal/jamba prefill L{L}"
       for L in (1, 2, 7, 71, 81, 132, 219, 300)])


def _conv_shape(name):
    s = dataclasses.replace(RESNET50[name], N=1000)
    H = (s.h_O - 1) * s.sh + s.h_F
    W = (s.w_O - 1) * s.sw + s.w_F
    return s, H, W


def _expected_launch(name, script):
    """(CTAs, threads, smem) of a dispatch from its kernel's launch
    configuration, independently of the access-plan builders."""
    from repro_torch.kernels.conv2d import launch_config as conv_config
    from repro_torch.kernels.flash_attention import launch_config as fa_config
    from repro_torch.kernels.matmul import _matmul_spec
    from repro_torch.kernels.matmul import launch_config as mm_config
    from repro_torch.kernels.quant import _conv_spec_q
    from repro_torch.kernels.conv2d import _conv_spec
    from repro_torch.configs import get_config

    kind, rest = name.split("/", 1)
    if kind in ("conv2d", "conv2d_q"):
        layer, be = rest.split("/")
        s, H, W = _conv_shape(layer)
        if be == "im2col":
            m, n, k = s.N * s.h_O * s.w_O, s.c_O, s.c_I * s.h_F * s.w_F
            bm, bn, bk = Planner(H100).plan(_matmul_spec(m, n, k, 16)).tiles
            cfg = mm_config(bm, bn, bk, 2, k)
            return -(-m // bm) * -(-n // bn), cfg["threads"], cfg["smem"]
        if kind == "conv2d":
            spec = _conv_spec(s.N, s.c_I, s.c_O, s.h_O, s.w_O, s.h_F, s.w_F,
                              s.sh, s.sw, 16)
        else:
            spec = _conv_spec_q(s.N, s.c_I, s.c_O, s.h_O, s.w_O, s.h_F,
                                s.w_F, s.sh, s.sw, torch.int8, torch.int8,
                                torch.bfloat16)
        t = tuple(Planner(H100).plan(spec).tiles)
        geo = _launch_geometry(s.N, s.c_I, s.c_O, H, W, s.h_F, s.w_F, s.sh,
                               s.sw, t)
        cfg = (conv_config(t, s.h_F, s.w_F, geo[7], geo[8], 2, s.c_I, (H, W))
               if kind == "conv2d" else
               conv_launch_config(t, s.h_F, s.w_F, geo[7], geo[8], s.c_I,
                                  (H, W)))
        return int(np.prod(geo[-1][:4])), cfg["threads"], cfg["smem"]
    if kind == "matmul_q":
        m, k, n = script.INT8_GEMMS[rest]
        bm, bn, bk = Planner(H100).plan(
            _matmul_spec_q(m, n, k, torch.int8, torch.int8,
                           torch.bfloat16)).tiles
        cfg = matmul_launch_config(bm, bn, bk, k)
        ctas = -(-m // bm) * cfg["sm"] * -(-n // bn) * cfg["sn"]
        return ctas, cfg["threads"], cfg["smem"]
    cfg = get_config("qwen2_5_3b")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if kind == "attention":
        B, Lq = (1, 176) if "prefill" in rest else (4, 1)
        c = fa_config((H // KV) * Lq, 512, hd, 64, torch.bfloat16,
                      rows=B * KV)
        return c["grid"][0] * c["grid"][1], c["threads"], c["smem"]
    if kind == "attention_decode":
        c = paged_launch_config(4, KV, H // KV, hd, 16, 13, torch.bfloat16)
        return c["ctas"], 32 * c["warps"], c["smem"]
    hyb = get_config("jamba_1_5_large")
    L = int(rest.rsplit("L", 1)[1])
    x = meta((1, L, hyb.d_inner), torch.bfloat16)
    w = meta((hyb.conv_kernel, hyb.d_inner), torch.bfloat16)
    bB, bD, _, _, grid = k_conv1d._conv1d_geometry(x, w, None, H100)
    c = k_conv1d.launch_config(hyb.conv_kernel, bB, bD, grid, 2)
    return c["grid"][0] * c["grid"][1], c["threads"], c["smem"]


def test_h100_sweep_covers_phase_16(h100_rows):
    assert list(h100_rows) == H100_ROWS


@pytest.mark.parametrize("name", H100_ROWS)
def test_h100_main_path_audit(name, h100_rows, script):
    """Audited (explain would raise otherwise), counted words equal to the
    counter, issued = counted - shortfall + uncounted, and the plan's
    launch equal to the kernel's launch configuration, within the card's
    shared memory."""
    row = h100_rows[name]
    assert row["audited_words"] == row["measured_words"]
    assert row["issued_words"] == (row["measured_words"] - row["shortfall"]
                                   + sum(row["uncounted"].values()))
    ctas, threads, smem = _expected_launch(name, script)
    assert int(np.prod(row["grid"])) == ctas
    assert row["block"] == [threads, 1, 1]
    assert row["smem_bytes"] == smem <= 232448


# -- the words the counters do not charge, pinned ----------------------------

@pytest.mark.parametrize("layer, words", [
    ("conv1", 1_567_936), ("conv2_x", 447_936), ("conv3_x", 204_672),
    ("conv4_x", 102_144), ("conv5_x", 50_688)])
def test_conv2d_q_scale_excess(layer, words, h100_rows):
    row = h100_rows[f"conv2d_q/{layer}/cuda"]
    assert row["uncounted"]["scale (per-CTA slices)"] == words
    assert row["shortfall"] == 0


@pytest.mark.parametrize("label, words", [
    ("512x384x256", 768), ("2048x2048x2048", 14_336),
    ("conv5_x Im2Col 49000x4608x512", 195_584)])
def test_matmul_q_scale_excess(label, words, h100_rows):
    row = h100_rows[f"matmul_q/{label}"]
    assert row["uncounted"] == {"scale (per-CTA slices)": words}


@pytest.mark.parametrize("m, k, n, share", [
    (1, 4096, 4096, "a"), (16, 4096, 2048, "a"), (2048, 4096, 16, "b")])
def test_matmul_q_cta_share_rereads(m, k, n, share):
    """A narrow plan's sm x sn CTA shares each read the narrow operand's
    whole slice of the tile: (shares - 1) x its words a tile, uncounted."""
    a, b, sc = meta((m, k), torch.int8), meta((k, n), torch.int8), \
        meta((1, n), torch.float32)
    ap = matmul_q_access_plan(a, b, sc, target=H100)
    rep = au.audit_access_plan(ap)
    assert rep.ok and rep.counted_words == matmul_q_hbm_words(
        a, b, sc, target=H100)
    bm, bn, bk = Planner(H100).plan(_matmul_spec_q(
        m, n, k, torch.int8, torch.int8, torch.bfloat16)).tiles
    cfg = matmul_launch_config(bm, bn, bk, k)
    tiles = -(-m // bm) * -(-n // bn)
    if share == "a":
        want = tiles * (cfg["sn"] - 1) * bm * round(-(-k // bk) * bk) / 4
    else:
        want = tiles * (cfg["sm"] - 1) * bn * round(-(-k // bk) * bk) / 4
    assert want > 0
    assert rep.uncounted[f"{share} (CTA-share re-reads)"] == want
    if (m, k, n) == (1, 4096, 4096):
        assert want == 2 * 4096 / 4  # A's 4 KiB read three times


def test_conv1d_filter_excess_and_serve_shapes(h100_rows):
    """nD == 1 and nB > 1: every batch tile's CTAs read the filter block,
    (nB - 1) x K x bD words beyond the counter's one fetch; none at the
    serve's shapes."""
    x, w = meta((20, 40, 96), torch.bfloat16), meta((3, 96), torch.bfloat16)
    ap = k_conv1d.conv1d_access_plan(x, w, tiles=(4, 96), target=H100)
    rep = au.audit_access_plan(ap)
    assert rep.ok
    assert rep.counted_words == k_conv1d.conv1d_hbm_words(
        x, w, tiles=(4, 96), target=H100)
    assert rep.uncounted == {"w (per-CTA fetches)": (5 - 1) * 3 * 96 * 0.5}
    for name in H100_ROWS:
        if name.startswith("conv1d_causal"):
            row = h100_rows[name]
            assert row["uncounted"] == {} and row["shortfall"] == 0


@pytest.mark.parametrize("lengths", [(205, 151, 120, 41), (208,) * 4,
                                     (0, 3, 17, 208)])
def test_paged_decode_shortfall(lengths):
    """With concrete lengths the plan models the slots the kernel loads;
    the audit's shortfall is the counter less the issued words, and 0 with
    every row full."""
    B, KV, g, w, bs, hd = 4, 2, 8, 13, 16, 128
    ap = paged_decode_access_plan(B, KV, g, w, bs, hd, 53, 0.5, 0.5, 0.5,
                                  lengths=lengths)
    rep = au.audit_access_plan(ap)
    assert rep.ok
    full = paged_decode_hbm_words(B, KV, g, w, bs, hd, 0.5, 0.5, 0.5)
    issued = paged_decode_issued_words(lengths, B, KV, g, w, bs, hd,
                                       0.5, 0.5, 0.5)
    assert rep.counted_words == full
    assert rep.shortfall == full - issued
    assert rep.issued_words == issued
    if lengths == (208,) * 4:
        assert rep.shortfall == 0
    if lengths == (205, 151, 120, 41):
        assert rep.shortfall == 73_746


def test_im2col_gemm_padded_k_step_is_a_shortfall(h100_rows):
    """conv1's Im2Col GEMM plan charges two k-steps of 144 for k = 147; the
    kernel runs one span of 160: the second step's padding is charged and
    never issued (ROADMAP queue 3)."""
    row = h100_rows["conv2d/conv1/im2col"]
    assert row["shortfall"] == 98_000 * (288 - 160) * (128 + 64) * 0.5
    assert row["uncounted"] == {"filter transpose read": 64 * 147 * 0.5,
                                "filter transpose write": 64 * 147 * 0.5}
    for layer in ("conv2_x", "conv3_x", "conv4_x", "conv5_x"):
        assert h100_rows[f"conv2d/{layer}/im2col"]["shortfall"] == 0


# -- mutants, lint, plan hook, script, last_launch ----------------------------

@pytest.mark.parametrize("name", [n for n, _ in mutants.MUTANTS])
def test_seeded_mutants(name):
    caught, detail = dict(mutants.MUTANTS)[name]()
    assert caught, detail


def test_lint_clean_on_the_tree():
    found = lint.run_lint([ROOT / "src" / "repro_torch",
                           ROOT / "scripts" / "verify_torch.py"], ROOT)
    assert found == []
    assert not [v for v in lint.lint_registry() if v.code == "VRF011"]


SEEDS = {
    "VRF001": ("repro_torch/ops/launcher.py",
               "from x import CudaKernel\nK = CudaKernel('a.cu', 'f', [])\n"),
    "VRF002": ("repro_torch/models/stray.cu", "__global__ void f() {}\n"),
    "VRF003": ("repro_torch/models/gqa.py",
               "def f(k, g):\n    return k.repeat_interleave(g, dim=1)\n"),
    "VRF013": ("repro_torch/kernels/bad.py",
               "import torch\ndef f(acc):\n"
               "    return acc.to(torch.bfloat16)\n"),
    "VRF014": ("repro_torch/serving/bad.py",
               "def f():\n    raise RuntimeError('x')\n"),
}


@pytest.mark.parametrize("code", sorted(SEEDS))
def test_lint_rule_fires_on_a_seeded_violation(code, tmp_path):
    rel, text = SEEDS[code]
    path = tmp_path / rel
    path.parent.mkdir(parents=True)
    path.write_text(text)
    found = lint.lint_sources([tmp_path], tmp_path)
    assert [v.code for v in found] == [code]


def test_lint_aten_work_fires_on_a_seeded_entry(tmp_path, monkeypatch):
    """VRF016: a cuda entry whose forward calls a torch GEMM, a convolution
    or SDPA is caught; its backward recompute is not."""
    (tmp_path / "seeded_entry.py").write_text(
        "import torch\nimport torch.nn.functional as F\n"
        "from repro_torch.ops.registry import _with_aten_grad\n"
        "def entry(ctx, plan, a, b):\n"
        "    y = F.scaled_dot_product_attention(a, b, b)\n"
        "    return _with_aten_grad(lambda a_: a_ @ b,\n"
        "                           lambda a_: torch.matmul(a_, b), a)\n"
        "def clean(ctx, plan, a, b):\n"
        "    return _with_aten_grad(lambda a_: a_.clone(),\n"
        "                           lambda a_: torch.matmul(a_, b), a)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    mod = importlib.import_module("seeded_entry")
    found = lint.aten_work(mod.entry, "cuda.seeded")
    assert sorted(v.code for v in found) == ["VRF016", "VRF016"]
    assert lint.aten_work(mod.clean, "cuda.seeded") == []


def test_lint_registry_rules_fire(monkeypatch):
    from repro_torch.ops import registry

    def fn(ctx, plan, a):
        return a

    bad = registry.Backend(name="seeded", fallback="torch", ops={
        "no_words": registry.OpEntry(fn),
        "no_plan": registry.OpEntry(fn, words_fn=lambda *a, **k: 0.0),
        "flag": registry.OpEntry(fn, registry.OpCapabilities(
            flags=frozenset({"key_mask"}))),
        "int8": registry.OpEntry(fn, registry.OpCapabilities(
            dtypes=("int8",))),
    })
    monkeypatch.setitem(registry._BACKENDS, "seeded", bad)
    codes = sorted(v.code for v in lint.lint_registry()
                   if "seeded." in v.message)
    assert codes == ["VRF010", "VRF010", "VRF010", "VRF011", "VRF012",
                     "VRF013"]


def test_plan_hook_accepts_h100_plans_and_rejects_uncovering_grids():
    au.install_plan_audit()
    try:
        assert au._plan_hook in port_planner._PLAN_AUDIT_HOOKS
        for s in RESNET50.values():
            ep = Planner(H100).plan(ConvSpec(
                N=1000, c_I=s.c_I, c_O=s.c_O, w_O=s.w_O, h_O=s.h_O,
                w_F=s.w_F, h_F=s.h_F, sw=s.sw, sh=s.sh))
            assert au.validate_execution_plan(ep) == []
            au._plan_hook(ep)
        short = dataclasses.replace(ep, grid=(ep.grid[0] - 1, *ep.grid[1:]))
        with pytest.raises(au.PlanAuditError, match="does not cover N"):
            au._plan_hook(short)
    finally:
        port_planner._PLAN_AUDIT_HOOKS.remove(au._plan_hook)


@pytest.mark.parametrize("args", [[], ["--target", "tpu_v5e"],
                                  ["--mutants"]])
def test_script_exits_clean(args):
    out = subprocess.run([PY, str(ROOT / "scripts" / "verify_torch.py"),
                          *args], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    if args == ["--mutants"]:
        assert "fault_swallowed" in out.stdout and "not ported" not in \
            out.stdout and "ESCAPED" not in out.stdout
        assert out.stdout.count(" caught: ") == len(mutants.MUTANTS) == 7


def test_explain_stamps_the_audit():
    ctx = ops.ExecutionContext(target=H100, backend="cuda", device="cpu")
    s, H, W = _conv_shape("conv5_x")
    d = ops.explain("conv2d", ctx, dtype=torch.bfloat16,
                    spec_args=(meta((s.N, s.c_I, H, W), torch.bfloat16),
                               meta((s.c_O, s.c_I, 3, 3), torch.bfloat16)),
                    spec_kw={"stride": (1, 1)}, audit=True)
    assert d.audited == d.measured_words
    assert "statically audited" in d.why()
    plain = ops.explain("conv2d", ctx, dtype=torch.bfloat16,
                        spec_args=(meta((s.N, s.c_I, H, W), torch.bfloat16),
                                   meta((s.c_O, s.c_I, 3, 3),
                                        torch.bfloat16)),
                        spec_kw={"stride": (1, 1)})
    assert plain.audited is None and plain == dataclasses.replace(
        d, audited=None)


def test_an_audit_failure_raises():
    """An access plan whose counted words leave the counter raises
    AuditError through explain(audit=True)."""
    from repro_torch.ops import registry

    entry = registry.get_backend("cuda").ops["matmul_q"]

    def skewed(*a, **k):
        ap = entry.access_plan_fn(*a, **k)
        return dataclasses.replace(ap, accesses=ap.accesses[1:])

    ctx = ops.ExecutionContext(target=H100, backend="cuda", device="cpu")
    bad = dataclasses.replace(entry, access_plan_fn=skewed)
    args = (meta((512, 384), torch.int8), meta((384, 256), torch.int8),
            meta((1, 256), torch.float32))
    decision = ops.explain("matmul_q", ctx, dtype=torch.int8,
                           spec_args=args)
    with pytest.raises(au.AuditError, match="!= words_fn"):
        from repro_torch.ops.dispatch import _maybe_audit
        _maybe_audit(bad, decision, ctx, args, None, True)


def test_last_launch_records_the_wrappers_launch(monkeypatch):
    k = KERNELS["paged_decode"]
    monkeypatch.setattr(k, "fn", lambda: (lambda *args: 0))
    before = k.launches
    monkeypatch.setattr(k, "launches", before)
    monkeypatch.setattr(k, "last_launch", None)
    k.launch(1, 2, tensor_core=True, grid=(7, 2, 4), block=(128,),
             smem=73984, cluster=(7, 1, 1))
    assert k.launches == before + 1
    assert k.last_launch == {"grid": (7, 2, 4), "block": (128, 1, 1),
                             "smem": 73984, "cluster": (7, 1, 1)}
