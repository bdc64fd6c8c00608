"""repro_torch.core against repro.core: the bounds, the blocking LP and the
kernel-tile fit are copies, so they must agree exactly (not approximately)
on the paper's layers and on the shapes of test_bounds.py / test_tiling.py."""

import dataclasses

import pytest

from repro.core import bounds as jb
from repro.core import conv_model as jc
from repro.core import tiling as jt
from repro_torch.core import bounds as tb
from repro_torch.core import conv_model as tc
from repro_torch.core import tiling as tt

PRECS = {"fp32": (1.0, 1.0, 1.0), "bf16": (0.5, 0.5, 1.0),
         "int8": (0.25, 0.25, 1.0)}

# (name, ConvShape fields) — ResNet-50 and AlexNet at the paper's batches,
# plus the hand-written shapes of test_bounds.py and test_tiling.py
SHAPES = (
    [(f"resnet50/{k}", dataclasses.asdict(s) | {"prec": None})
     for k, s in jc.resnet50_layers(1000).items()]
    + [(f"alexnet/{k}", dataclasses.asdict(s) | {"prec": None})
       for k, s in jc.alexnet_layers(128).items()]
    + [("bounds_standard", dict(N=8, c_I=16, c_O=32, w_O=10, h_O=10, w_F=3,
                                h_F=3, sw=1, sh=1, prec=None)),
       ("bounds_small_filter", dict(N=4, c_I=8, c_O=8, w_O=64, h_O=64,
                                    w_F=3, h_F=3, sw=1, sh=1, prec=None)),
       ("resnet50_b100/conv3_x", dict(N=100, c_I=128, c_O=128, w_O=28,
                                      h_O=28, w_F=3, h_F=3, sw=1, sh=1,
                                      prec=None)),
       ("strided_ragged", dict(N=3, c_I=5, c_O=7, w_O=6, h_O=5, w_F=5,
                               h_F=3, sw=2, sh=1, prec=None))]
)

MEMS = {
    "tpu_vmem": lambda m: m.TPU_VMEM,
    "gemmini": lambda m: m.GEMMINI,
    "unified_2^15": lambda m: m.MemoryModel(M=2 ** 15, mode="unified",
                                            double_buffer=True),
    "h100_split": lambda m: m.MemoryModel(M=232448 / 4.0, M_acc=32768.0,
                                          mode="split", double_buffer=True),
}


def _shapes(fields, prec):
    kw = {k: v for k, v in fields.items() if k != "prec"}
    return (jc.ConvShape(**kw, prec=jc.Precision(*PRECS[prec])),
            tc.ConvShape(**kw, prec=tc.Precision(*PRECS[prec])))


@pytest.mark.parametrize("name,fields", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("prec", sorted(PRECS))
def test_single_processor_bound_equal(name, fields, prec):
    js, ts = _shapes(fields, prec)
    for M in (4096.0, 1e4, 2.0 ** 15, 29056.0, float(jt.TPU_VMEM_WORDS) / 2):
        assert tb.single_processor_bound(ts, M).terms == \
            jb.single_processor_bound(js, M).terms
        assert tb.small_filter_regime(ts, M) == jb.small_filter_regime(js, M)
    assert tb.C_p(ts.prec) == jb.C_p(js.prec)
    assert ts.words() == js.words() and ts.G == js.G


@pytest.mark.parametrize("name,fields", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("mem", sorted(MEMS))
def test_optimize_blocking_and_kernel_fit_equal(name, fields, mem):
    js, ts = _shapes(fields, "int8" if mem == "gemmini" else "bf16")
    jm, tm = MEMS[mem](jt), MEMS[mem](tt)
    align = {"cO": min(16, js.c_O), "cI": min(16, js.c_I)}
    for al in (None, align):
        jblk = jt.optimize_blocking(js, jm, align=al)
        tblk = tt.optimize_blocking(ts, tm, align=al)
        assert tblk.b == jblk.b
        assert tblk.comm_volume() == jblk.comm_volume()
        t = tblk.as_conv_tile()
        assert t == jblk.as_conv_tile()
        tiles = (t["N"], t["cI"], t["cO"], t["hO"], t["wO"])
        assert tt.fit_conv_kernel_tiles(ts, tiles, tm) == \
            jt.fit_conv_kernel_tiles(js, tiles, jm)


def test_matmul_bounds_and_tiles_equal():
    assert tb.matmul_bound(512, 512, 512, 2048.0) == \
        jb.matmul_bound(512, 512, 512, 2048.0)
    for m, n, k in [(4096, 4096, 4096), (512, 11008, 2048), (7, 13, 5),
                    (12544000, 64, 147)]:
        assert tt.matmul_tiles(m, n, k) == jt.matmul_tiles(m, n, k)


def test_parallel_bounds_equal():
    for s_name, fields in SHAPES[:5]:
        js, ts = _shapes(fields, "fp32")
        for P in (1, 4, 16, 256):
            assert tb.parallel_bound(ts, P, 2 ** 16).terms == \
                jb.parallel_bound(js, P, 2 ** 16).terms
            assert tb.combined_parallel_bound(ts, P, 2 ** 16) == \
                jb.combined_parallel_bound(js, P, 2 ** 16)
