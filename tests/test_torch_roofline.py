"""repro_torch.analysis.roofline against repro.analysis.roofline: words to
bytes in both forms, and the bandwidth and alpha-beta times equal to the
reference's under the reference's constants; the port's own constants are
the H100's."""

import pytest

import repro.analysis.roofline as jr
import repro_torch.analysis.roofline as tr
from repro_torch.core.conv_model import Precision
from repro_torch.plan import H100, ConvSpec, MatmulSpec, Planner
from repro_torch.quant import INT8_SPEC

WORDS = (0.0, 1.0, 10.0, 0.25, 1.1193e9, 4.5978e8)


@pytest.fixture
def reference_constants(monkeypatch):
    monkeypatch.setattr(tr, "HBM_BW", jr.HBM_BW)
    monkeypatch.setattr(tr, "DMA_SETUP_SECONDS", jr.DMA_SETUP_SECONDS)


@pytest.mark.parametrize("words", WORDS)
def test_words_to_bytes_scalar_equal(words):
    assert tr.words_to_bytes(words) == jr.words_to_bytes(words)
    assert tr.WORD_BYTES == jr.WORD_BYTES == 4


@pytest.mark.parametrize("prec", [(0.25, 0.25, 0.5), (0.5, 0.5, 1.0),
                                  (1.0, 1.0, 1.0), (0.375, 0.5, 1.0)],
                         ids=["int8", "bf16", "f32", "placeholder"])
def test_words_to_bytes_per_operand_equal(prec):
    ep = Planner(H100).plan(ConvSpec(N=4, c_I=8, c_O=32, w_O=10, h_O=10,
                                     w_F=3, h_F=3, prec=Precision(*prec)))
    elems = {"input": 1000, "filter": 300, "output": 1000, "scale": 7}
    got = tr.words_to_bytes(elems, dtypes=ep.dtypes)
    assert got == jr.words_to_bytes(elems, dtypes=ep.dtypes)
    assert got == jr.words_to_bytes(elems, dtypes=dict(ep.dtypes))
    assert got["scale"] == 28.0  # absent from the map: float32


def test_words_to_bytes_per_operand_widths():
    # the counterpart of tests/test_quant.py's check
    assert tr.words_to_bytes(10) == 40.0
    ep = Planner(H100).plan(ConvSpec(N=4, c_I=8, c_O=32, w_O=10, h_O=10,
                                     w_F=3, h_F=3,
                                     prec=INT8_SPEC.precision))
    per = tr.words_to_bytes({"input": 1000, "output": 1000},
                            dtypes=ep.dtypes)
    assert per["input"] == 1000.0  # int8: one byte per element
    assert per["output"] == 2000.0  # bf16: two
    odd = tr.words_to_bytes({"input": 8}, dtypes={"input": "words:0.375"})
    assert odd == {"input": 12.0}


@pytest.mark.parametrize("words", WORDS)
@pytest.mark.parametrize("chips", [1, 4])
def test_times_equal_under_reference_constants(words, chips,
                                               reference_constants):
    assert tr.hbm_seconds(words, chips) == jr.hbm_seconds(words, chips)
    for transfers in (0, 1, 17, 3.5e6):
        assert tr.alpha_beta_seconds(words, transfers, chips) == \
            jr.alpha_beta_seconds(words, transfers, chips)


def test_h100_constants_and_bound():
    assert tr.HBM_BW == 3.35e12
    assert (tr.PEAK_FLOPS, tr.PEAK_INT8_OPS, tr.PEAK_F32_FLOPS) == (
        989e12, 1979e12, 67e12)
    assert tr.hbm_seconds(3.35e12 / 4) == pytest.approx(1.0)
    assert tr.alpha_beta_seconds(0.0, 1e6) == pytest.approx(
        1e6 * tr.DMA_SETUP_SECONDS)
    # conv5_x's Im2Col GEMM at batch 1000: operations bound it
    m, k, n = 49000, 4608, 512
    ms, by = tr.bound_ms(2.0 * m * k * n, 2 * (m * k + k * n) + 4 * m * n,
                         tr.PEAK_FLOPS)
    assert by == "operations" and ms == pytest.approx(
        2.0 * m * k * n / 989e12 * 1e3)
    ms, by = tr.bound_ms(1.0, 3.35e9, tr.PEAK_FLOPS)
    assert by == "bytes" and ms == pytest.approx(1.0)
    assert tr.bound_ms(0.0, 0.0, tr.PEAK_FLOPS) == (0.0, "operations")


def test_planner_alpha_beta_prices_a_tuned_plan_beside_its_words():
    from repro_torch.plan import predicted_seconds

    ep = Planner(H100).plan(MatmulSpec(512, 256, 384,
                                       Precision(0.25, 0.25, 0.5)))
    assert predicted_seconds(ep) == pytest.approx(
        tr.hbm_seconds(ep.comm_volume)
        + tr.DMA_SETUP_SECONDS * (2 * ep.grid[0] * ep.grid[1] * ep.grid[2]
                                  + ep.grid[0] * ep.grid[1]))
