"""repro_torch.ops against repro.ops: the dispatch decisions (measured
words, bound ratio, lower bound) on the paper's five layers, the slice as a
whole through every backend on a narrow 2-image version of those layers, and
the port's device rules. Backends pair up as xla<->torch, pallas<->cuda and
im2col<->im2col; the reference runs its Pallas kernels in interpret mode,
the port its plain versions on the CPU. Tolerances as tests/test_kernels.py
(bf16 inputs: 3e-2; both sides accumulate in f32 in a different order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.plan as jp
import repro_torch.plan as tp
from repro import ops as jops
from repro.core.conv_model import resnet50_layers
from repro_torch import ops as tops
from repro_torch.convert import params_from_jax
from repro_torch.resilience.errors import DeviceLost

LAYERS = resnet50_layers(1000)
BACKENDS = {"torch": "xla", "cuda": "pallas", "im2col": "im2col"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The module's tests on one torch thread: in the suite's parallel
    run (six workers on the host's cores) the plain versions' many small
    parallel regions wait on oversubscribed cores, which took
    ``test_slice_matches_reference[cuda]`` to 498 s against 3 s alone;
    on one thread they do not. Inputs, cases and tolerances are
    unchanged."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jtarget(name):
    return jp.HardwareTarget.from_dict(getattr(tp, name).to_dict())


def _in_hw(s):
    return (s.h_O - 1) * s.sh + s.h_F, (s.w_O - 1) * s.sw + s.w_F


@pytest.mark.parametrize("target", ["H100", "TPU_V5E"])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_explain_matches_reference(target, layer):
    s = LAYERS[layer]
    H, W = _in_hw(s)
    xs, ws = (s.N, s.c_I, H, W), (s.c_O, s.c_I, s.h_F, s.w_F)
    kw_j = {"stride": (s.sh, s.sw), "out_dtype": jnp.float32}
    kw_t = {"stride": (s.sh, s.sw), "out_dtype": torch.float32}
    jx = (jax.ShapeDtypeStruct(xs, jnp.bfloat16),
          jax.ShapeDtypeStruct(ws, jnp.bfloat16))
    # meta tensors: nothing of batch 1000 is allocated
    tx = (torch.empty(xs, dtype=torch.bfloat16, device="meta"),
          torch.empty(ws, dtype=torch.bfloat16, device="meta"))
    words = {}
    for tbe in ("cuda", "im2col"):
        jd = jops.explain("conv2d", jops.ExecutionContext(
            target=_jtarget(target), backend=BACKENDS[tbe]),
            dtype="bfloat16", spec_args=jx, spec_kw=kw_j)
        td = tops.explain("conv2d", tops.ExecutionContext(
            target=getattr(tp, target), backend=tbe, device="cpu"),
            dtype=torch.bfloat16, spec_args=tx, spec_kw=kw_t)
        assert td.chosen == tbe and not td.fell_back
        assert td.plan.tiles == jd.plan.tiles
        assert td.measured_words == jd.measured_words
        assert td.lower_bound == jd.lower_bound
        assert td.bound_ratio == jd.bound_ratio
        words[tbe] = td.measured_words
    assert words["cuda"] < words["im2col"]  # tiled moves fewer words


def _narrow(s):
    """The layer at 2 images and 1/8 of its channels (c_I = 3 kept)."""
    return (2, s.c_I if s.c_I == 3 else s.c_I // 8, s.c_O // 8)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_slice_matches_reference(backend):
    """ops.conv2d over the five narrow layers, bf16 in, f32 out, planned for
    the H100, port against reference."""
    rng = np.random.default_rng(0)
    jctx = jops.ExecutionContext(target=_jtarget("H100"),
                                 backend=BACKENDS[backend], interpret=True)
    tctx = tops.ExecutionContext(target=tp.H100, backend=backend,
                                 device="cpu")
    for name, s in LAYERS.items():
        N, cI, cO = _narrow(s)
        H, W = _in_hw(s)
        x = rng.standard_normal((N, cI, H, W)).astype(np.float32)
        w = (rng.standard_normal((cO, cI, s.h_F, s.w_F))
             / np.sqrt(cI * s.h_F * s.w_F)).astype(np.float32)
        want = jops.conv2d(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(w, jnp.bfloat16), (s.sh, s.sw),
                           ctx=jctx)
        with tops.record_dispatch() as log:
            got = tops.conv2d(torch.from_numpy(x).bfloat16(),
                              torch.from_numpy(w).bfloat16(), (s.sh, s.sw),
                              ctx=tctx)
        assert [d.chosen for d in log] == [backend]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=3e-2, atol=3e-2, err_msg=name)


def test_matmul_dispatch_matches_reference():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((130, 129)).astype(np.float32)
    b = rng.standard_normal((129, 257)).astype(np.float32)
    for tbe in ("torch", "cuda", "im2col"):  # im2col falls back to torch
        tctx = tops.ExecutionContext(target=tp.CPU_INTERPRET, backend=tbe,
                                     device="cpu")
        with tops.record_dispatch() as log:
            got = tops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                              ctx=tctx)
        want = jops.matmul(jnp.asarray(a), jnp.asarray(b),
                           ctx=jops.ExecutionContext(
                               target=jp.CPU_INTERPRET,
                               backend=BACKENDS[tbe]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        assert log[0].chosen == ("torch" if tbe == "im2col" else tbe)
        assert log[0].fell_back == (tbe == "im2col")


_SHAPES = {"conv2d": ((2, 3, 9, 9), (4, 3, 3, 3)), "matmul": ((5, 7), (7, 3))}


@pytest.mark.parametrize("backend,op,dtype", [
    ("cuda", "conv2d", torch.float16),    # a dtype the kernel does not take
    ("im2col", "matmul", torch.bfloat16),  # an op the backend lacks
])
def test_card_raises_where_cpu_falls_back(monkeypatch, backend, op, dtype):
    """A call the requested backend cannot serve goes to the aten oracle
    under device="cpu" only; a context on the card raises before anything
    runs, in explain and in dispatch alike."""
    meta = tuple(torch.empty(s, dtype=dtype, device="meta")
                 for s in _SHAPES[op])
    kw = {"out_dtype": torch.float32}
    cpu = tops.ExecutionContext(backend=backend, device="cpu")
    d = tops.explain(op, cpu, dtype=dtype, spec_args=meta, spec_kw=kw)
    assert d.chosen == "torch" and d.fell_back and d.missing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    card = tops.ExecutionContext(backend=backend, device="cuda")
    with pytest.raises(NotImplementedError, match="on the card"):
        tops.explain(op, card, dtype=dtype, spec_args=meta, spec_kw=kw)
    with pytest.raises(NotImplementedError, match="on the card"):
        tops.dispatch_call(op, card, dtype, (), meta, spec_kw=kw)


def test_call_features_are_not_served():
    ctx = tops.ExecutionContext(device="cpu")
    with pytest.raises(NotImplementedError, match="call features"):
        tops.explain("conv2d", ctx, needs=("traced",))


def test_torch_backend_is_f_conv2d():
    torch.manual_seed(0)
    x = torch.randn(2, 5, 13, 11)
    w = torch.randn(7, 5, 3, 3)
    ctx = tops.ExecutionContext(backend="torch", device="cpu")
    for stride in ((1, 1), (2, 1)):
        torch.testing.assert_close(tops.conv2d(x, w, stride, ctx=ctx),
                                   F.conv2d(x, w, stride=stride),
                                   rtol=0, atol=0)


def test_default_context_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device") as raised:
        tops.ExecutionContext()
    assert type(raised.value) is DeviceLost
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.conv2d(torch.zeros(1, 1, 3, 3), torch.zeros(1, 1, 3, 3))


def test_context_rules():
    ctx = tops.ExecutionContext(device="cpu")
    assert ctx.target is tp.H100 and ctx.resolved_backend() == "cuda"
    assert tops.ExecutionContext(target=tp.CPU_INTERPRET,
                                 device="cpu").resolved_backend() == "torch"
    assert ctx.acc_dtype == torch.float32
    assert ctx.stream_dtype == torch.bfloat16
    tuning = tops.ExecutionContext(device="cpu", autotune=True)
    try:
        plan, src = tuning.plan_with_source(tp.MatmulSpec(64, 64, 64))
        assert src == "tuned" and plan.tuned.source == "roofline"
    finally:
        tp.Planner.cache.clear()
    with pytest.raises(ValueError, match="context runs on"):
        tops.conv2d(torch.zeros(1, 1, 3, 3, device="meta"),
                    torch.zeros(1, 1, 3, 3, device="meta"), ctx=ctx)
    assert tops.backends() == ("cuda", "im2col", "torch")
    assert tops.registered_ops() == ("attention", "attention_decode",
                                     "attention_decode_quant",
                                     "conv1d_causal", "conv2d",
                                     "conv2d_dist", "conv2d_q", "matmul",
                                     "matmul_q")


def test_backend_env_knob(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "im2col")
    assert tops.ExecutionContext(device="cpu").resolved_backend() == "im2col"
    monkeypatch.setenv("REPRO_TORCH_BACKEND", "pallas")
    with pytest.raises(ValueError, match="not a known backend"):
        tops.ExecutionContext(device="cpu").resolved_backend()


def test_gradient_recomputes_through_aten():
    torch.manual_seed(0)
    x = torch.randn(2, 3, 9, 9, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    ctx = tops.ExecutionContext(backend="cuda", device="cpu")
    tops.conv2d(x, w, (2, 2), ctx=ctx).square().sum().backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    F.conv2d(x, w, stride=2).square().sum().backward()
    # the upstream gradient 2*y carries the forward's f32 summation order
    torch.testing.assert_close(gx, x.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gw, w.grad, rtol=1e-4, atol=1e-4)


def test_params_from_jax_keeps_tree_and_values():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 3, 7, 7)).astype(np.float32)
    tree = {"conv1": {"w": jnp.asarray(w), "b": jnp.asarray(w[:, 0, 0, 0],
                                                             jnp.bfloat16)},
            "blocks": [jnp.zeros((2, 2)), None]}
    out = params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    assert out["conv1"]["w"].shape == (8, 3, 7, 7)  # OIHW in both packages
    np.testing.assert_array_equal(out["conv1"]["w"].numpy(), w)
    assert out["conv1"]["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["conv1"]["b"].float().numpy(),
                                  np.asarray(tree["conv1"]["b"], np.float32))
    assert isinstance(out["blocks"], list) and out["blocks"][1] is None
    assert params_from_jax(tree, "cpu", torch.bfloat16)["conv1"]["w"].dtype \
        == torch.bfloat16
