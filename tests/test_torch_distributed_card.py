"""The distributed halo-exchange conv on the card (``cuda``-marked; skips
without a GPU): chip phase 26 (a) on one grid, held against the
single-device ``cuda`` conv. Kept apart from tests/test_torch_distributed.py
so that a card run imports no JAX."""

import pytest
import torch

from repro_torch import ops
from repro_torch import plan as tp
from repro_torch.core.conv_model import BF16_ACC32
from repro_torch.core.parallel_tiling import ParallelBlocking
from repro_torch.launch import make_conv_mesh

# conv2_x's words a device on {"hO": 4, "wO": 2}, bf16 in (the reference's
# counters; tests/test_torch_distributed.py::WORD_TABLE)
CONV2_X_PROBE0_WORDS = 2_944_000


@pytest.mark.cuda
def test_full_width_halo_conv_on_the_card():
    """conv2_x at batch 1000 (bf16 in, f32 out) through ``ops.conv2d_dist``
    on an 8-shard in-process mesh on the card, grid {"hO": 4, "wO": 2}:
    every shard on ``conv2d_tc_kernel``'s tensor-core path, the counted
    wire words equal to the table's and ``explain``'s, the output within
    1e-4 x max(1, max|ref|) of the single-device ``cuda`` conv, and both
    within that of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from repro_torch.core.conv_model import resnet50_layers
    from repro_torch.kernels import KERNELS, conv2d_plain

    s = resnet50_layers(1000)["conv2_x"].with_precision(BF16_ACC32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((s.N, s.c_I, 58, 58), generator=gen,
                    device="cuda").to(torch.bfloat16)
    w = (torch.randn((s.c_O, s.c_I, 3, 3), generator=gen, device="cuda")
         * (s.c_I * 9) ** -0.5).to(torch.bfloat16)
    pb = ParallelBlocking.from_grid(s, {"hO": 4, "wO": 2})
    mesh = make_conv_mesh(pb)
    ctx = ops.ExecutionContext(target=tp.HardwareTarget.from_mesh(mesh),
                               backend="cuda")
    k = KERNELS["conv2d"]
    n0, tc0 = k.launches, k.tensor_core_launches
    with ops.record_dispatch() as log:
        got = ops.conv2d_dist(x, w, blocking=pb, mesh=mesh, ctx=ctx,
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    local = [d for d in log if d.op == "conv2d"]
    assert len(local) == 8 and all(d.chosen == "cuda" and not d.degraded
                                   for d in local)
    assert k.launches - n0 == k.tensor_core_launches - tc0 == 8
    d = ops.explain("conv2d_dist", ctx, dtype=x.dtype, spec_args=(x, w),
                    spec_kw={"stride": (1, 1), "blocking": pb})
    assert {mesh.wire_words(r) for r in range(8)} == {d.measured_words} \
        == {CONV2_X_PROBE0_WORDS}
    ref = ops.conv2d(x, w, ctx=ops.ExecutionContext(target=tp.H100,
                                                    backend="cuda"),
                     out_dtype=torch.float32)
    err = (got - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item())
    # both launches held against the plain version on the same inputs
    plain = conv2d_plain(x, w)
    for y in (got, ref):
        err = (y - plain).abs().max().item()
        assert err <= 1e-4 * max(1.0, plain.abs().max().item())
