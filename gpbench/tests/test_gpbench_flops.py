"""The frozen bound arithmetic against two bounds of PERF.md's kernel
table, and the model's work."""

import pytest

from gpbench import flops, harness


def test_k1_bound_at_65536_patches():
    f, b = flops.k1_call(65536, 16, 80, 64)
    assert flops.bound_s(f, b) * 1e3 == pytest.approx(0.2066, abs=5e-5)
    assert b / flops.PEAK_HBM_BYTES > f / flops.PEAK_BF16_FLOPS  # bound by bytes


def test_dense_k2_bound_at_65536_patches():
    f, b = flops.k2_call(16, 16, 65536, 80, 80, 65536 * 65536, False)
    assert flops.bound_s(f, b) * 1e3 == pytest.approx(22.2348, abs=5e-5)


def test_calls_per_prefill_match_the_model():
    sp = harness.spec("qwen2_5_vl_7b.q8.hires_vqa")
    shape = {"p": 4096, "n_img": 1024, "s_pad": 1088, "s_valid": 1060, "r_pad": 192,
             "r_valid": 148, "text": 35}
    calls = flops.attention_calls(sp.config["model"], shape)
    assert len(calls["K1"]) == 28 and len(calls["K2"]) == 4 + 28 + 4


def test_int8_products_move_to_the_int8_peak():
    sp = harness.spec("qwen2_5_vl_7b.q8.hires_vqa")
    shape = {"p": 4096, "n_img": 1024, "s_pad": 1088, "s_valid": 1060, "r_pad": 192,
             "r_valid": 148, "text": 35}
    bf = flops.prefill_work(sp.config["model"], shape)
    q8 = flops.prefill_work(sp.config["model"], shape, harness.int8_parts(sp.config["tier"]))
    assert harness.int8_parts(harness.spec("qwen2_5_vl_3b.bf16.hires_vqa").config["tier"]) == []
    assert bf["int8"] == 0 and q8["int8"] > 0
    assert bf["bf16"] == pytest.approx(q8["bf16"] + q8["int8"])
    assert flops.decode_work(sp.config["model"], 100, 2) > 0
