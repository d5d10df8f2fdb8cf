"""The benchmark's yardstick against the bound column of the port's kernel table (PERF.md,
the kernels' findings: bytes read and written once at 3.35 TB/s, operations at 1979 TOP/s
int8 or 989 TFLOP/s bf16), and the arithmetic behind its shares."""

import pytest

from benchmark import mfu, roofline as rl

NEMO = dict(hidden_size=5120, num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=8, head_dim=128,
            intermediate_size=14336, vocab_size=131072)


@pytest.mark.parametrize("bound, ms, by", [
    (rl.int8_mm_nt(2048, 14336, 4096), 0.121535, "operations"),
    (rl.int8_mm_nt(4, 14336, 4096), 0.017585, "bytes"),
    (rl.int8_mm_kn(4096, 4096, 1024), 0.0174, "operations"),
    (rl.decode_attention([1, 513, 2048, 4096], 32, 8, 128), 0.008160, "bytes"),
    (rl.decode_attention([1, 513, 2048, 4096], 32, 8, 128, int8_cache=True), 0.004217, "bytes"),
    (rl.flash_fwd(4, 512, 32, 8, 128, 4 * rl.causal_pairs([512])), 0.012599, "bytes"),
    (rl.flash_fwd(1, 4096, 32, 8, 128, rl.causal_pairs([4096])), 0.1390, "operations"),
    (rl.flash_bwd(1, 4096, 32, 8, 128, rl.causal_pairs([4096])), 0.3475, "operations"),
    (rl.flash_bwd(1, 4096, 32, 8, 128, rl.causal_pairs([512] * 8)), 0.0502, "bytes"),
])
def test_bound_column(bound, ms, by):
    digits = len(str(ms).split(".")[1])
    assert round(bound.seconds * 1e3, digits) == ms
    assert bound.bound_by == by


def test_share_of_the_bounds_own_time_is_whole():
    calls = rl.train_step_calls(NEMO, [[256] * 16, [1024] * 4], 4096, 8)
    for name, bounds in calls.items():
        least = sum(b.seconds for b in bounds)
        assert rl.share(bounds, least) == pytest.approx(100.0)
        assert rl.share(bounds, 2 * least) == pytest.approx(50.0)
    assert rl.share(calls["int8_mm_dequant_nt"], 0.0) is None


def test_train_step_calls_count_what_the_step_launches():
    L, chunks = NEMO["num_hidden_layers"], 8
    calls = rl.train_step_calls(NEMO, [[4096], [2048, 2048]], 4096, chunks)
    assert len(calls["int8_mm_dequant_nt"]) == 2 * (2 * 7 * L + 2 * chunks)
    assert len(calls["int8_mm_dequant"]) == 2 * (7 * L - 3 + chunks)
    assert len(calls["flash_attention"]) == 2 * 2 * L
    assert len(calls["flash_attention_bwd"]) == 2 * L


def test_mfu_accounting():
    rows = [[4096], [4096]]
    ops = mfu.train_step_ops(NEMO, 8, rows, 4096, 4096)
    trunk = mfu.trunk_params(NEMO)
    assert trunk == 40 * (2 * 5120 * 4096 + 2 * 5120 * 1024 + 3 * 5120 * 14336)
    assert ops["int8"] == 4.0 * trunk * 8192 + 4.0 * 5120 * 131072 * 4096
    assert ops["bf16"] == 6.0 * mfu.lora_params(NEMO, 8) * 8192 + 12.0 * 40 * 2 * rl.causal_pairs([4096]) * 32 * 128
    least = mfu.least_seconds(ops)
    assert mfu.share(ops, least) == pytest.approx(100.0)
    served = mfu.serve_ops(NEMO, [(0, 10)], [10, 11], 3)
    assert served["int8"] == 2.0 * trunk * 12
    assert served["bf16"] == 4.0 * 40 * (55 + 11 + 12) * 32 * 128 + 2.0 * 5120 * 131072 * 3
