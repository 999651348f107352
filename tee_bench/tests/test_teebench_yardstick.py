"""The frozen yardstick against counts made by hand."""

import pytest

from teebench import stats, yardstick

SMALL = {"hidden_size": 64, "intermediate_size": 96,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "num_hidden_layers": 3, "vocab_size": 100}


def test_b3_bytes_by_hand():
    # per slot: K and V rows 2 * valid * hk * hd * 2 B, a 4 B table entry
    # a page, q and out 2 * h * hd * 2 B; times the layers
    slot_100 = 2 * 100 * 2 * 16 * 2 + 4 * 7 + 2 * 4 * 16 * 2
    slot_17 = 2 * 17 * 2 * 16 * 2 + 4 * 2 + 2 * 4 * 16 * 2
    assert slot_100 == 13084 and slot_17 == 2440
    assert yardstick.b3_bytes(SMALL, [100, 17], 16) == 3 * (13084 + 2440)


def test_flops_by_hand():
    # one layer: q 64*64, k and v 64*32 each, o 64*64, three FFN 64*96
    assert yardstick.layer_params(SMALL) == 4096 + 2048 + 2048 + 4096 + \
        3 * 6144
    lp = 30720
    # a 5-token prompt: 2 * 3 layers * lp each, causal attention
    # 4 * 3 * 4 * 16 per (query, key) over 1+2+3+4+5 pairs, LM head 2*64*100
    assert yardstick.prefill_flops(SMALL, 5) == \
        2 * 3 * lp * 5 + 768 * 15 + 12800
    assert yardstick.decode_flops(SMALL, [10, 3]) == \
        2 * (2 * 3 * lp + 12800) + 768 * 13


@pytest.mark.parametrize("cfg,params", [
    ({"hidden_size": 4096, "intermediate_size": 11008,
      "num_attention_heads": 32, "num_key_value_heads": 32, "head_dim": 128,
      "num_hidden_layers": 30, "vocab_size": 102400}, 6_490_685_440),
    ({"hidden_size": 5120, "intermediate_size": 14336,
      "num_attention_heads": 32, "num_key_value_heads": 8, "head_dim": 128,
      "num_hidden_layers": 40, "vocab_size": 131072}, 11_576_279_040)])
def test_matmul_params_of_the_configurations(cfg, params):
    """deepseek-7b and mistral-nemo-12b: layers plus the tied table."""
    assert cfg["num_hidden_layers"] * yardstick.layer_params(cfg) + \
        cfg["vocab_size"] * cfg["hidden_size"] == params


def test_peaks_are_the_h100_data_sheet():
    assert yardstick.PEAK_BF16_FLOPS == 989e12
    assert yardstick.PEAK_HBM_BYTES == 3.35e12
    assert yardstick.PEAK_POWER_W == 700.0


def test_percentile_is_numpy_linear():
    np = pytest.importorskip("numpy")
    rng = np.random.default_rng(4)
    for n in (1, 2, 7, 100, 1001):
        xs = rng.exponential(size=n).tolist()
        for q in (50, 90, 95, 99):
            assert stats.percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), rel=1e-12)
    assert stats.percentile([], 90) is None
