"""The yardsticks against closed forms: model FLOPs, kernel and AdamW
bounds, and the trace's reduction to busy time and per-range device
time."""
import math

import pytest
import torch

from port_bench import flops
from port_bench.harness import ROOT, load_json
from port_bench.metrics import (adamw_roofline, device_idle_share,
                                infer_batch_ms_p95, mfu)
from port_bench.trace import PREFIX, WINDOW, reduce_trace

VIT = load_json(ROOT / "port_bench/configs/soft-moe-b16-128e.json")
LM = load_json(ROOT / "port_bench/configs/granite-moe-1b-a400m-soft.json")


def test_mlp_classic_is_two_thirds_of_gated():
    assert flops.mlp_flops_per_token(8, 16, "classic") == 4 * 8 * 16
    assert flops.mlp_flops_per_token(8, 16, "gated") == 6 * 8 * 16


def test_soft_moe_counts_slots_not_tokens():
    cfg = dict(d_model=8, num_experts=4, slots_per_expert=2, expert_d_ff=16,
               mlp_style="classic")
    m = 10
    expected = 6 * m * 8 * 8 + 8 * (4 * 8 * 16)
    assert flops.soft_moe_flops(cfg, m) == expected
    # twice the tokens: the routing doubles, the experts do not
    assert flops.soft_moe_flops(cfg, 2 * m) - expected == 6 * m * 8 * 8


def test_causal_attention_counts_half_the_square():
    cfg = dict(d_model=8, num_heads=2, num_kv_heads=1, head_dim=4,
               causal=False)
    m = 6
    proj = 2 * m * 8 * (8 + 8) + 2 * m * 8 * 8
    assert flops.attention_flops(cfg, m) == proj + 4 * m * m * 8
    assert flops.attention_flops(dict(cfg, causal=True), m) == \
        proj + 2 * m * m * 8


def test_full_size_counts():
    # B/16: ~31.8 GFLOP an image forward, 3x a training step
    fwd = flops.forward_flops_per_sequence(VIT, 196)
    assert 31.5e9 < fwd < 32.1e9
    assert flops.step_flops(VIT, {"mode": "train", "batch": 64}) == \
        3 * 64 * fwd
    # granite+soft: ~358 MFLOP a token forward at 2048 tokens
    per_token = flops.forward_flops_per_sequence(LM, 2048) / 2048
    assert 350e6 < per_token < 365e6


def test_adamw_bound_is_32_bytes_a_param_in_f32():
    p = [torch.zeros(10), torch.zeros(3, 5)]
    bound = flops.adamw_bound(p, p, p, p)
    assert bound * flops.HBM_BYTES_PER_S == pytest.approx(32 * 25)


def test_kernel_bound_takes_the_larger_term_at_the_operands_peak():
    b, m, d, s = 2, 64, 32, 16
    x = torch.zeros(b, m, d, dtype=torch.bfloat16)
    phi = torch.zeros(d, s)
    slots = torch.zeros(b, s, d, dtype=torch.bfloat16)
    stats = [torch.zeros(b, s), torch.zeros(b, s)], \
        [torch.zeros(b, m), torch.zeros(b, m)]
    out = (slots, *stats)
    moved = (x.numel() * 2 + phi.numel() * 4 + slots.numel() * 2
             + 4 * (2 * b * s + 2 * b * m))
    by_bytes = moved / flops.HBM_BYTES_PER_S
    by_flops = 4 * b * m * d * s / flops.PEAK_FLOPS["bfloat16"]
    assert flops.soft_moe_kernel_bound("routing_fwd", (x, phi, None), out) \
        == pytest.approx(max(by_bytes, by_flops))
    # f32 operands only: TF32's peak
    assert flops.peak_of([phi]) == flops.PEAK_FLOPS["float32"]


def _trace():
    """A window of 100 ns with two ranges; device ops 10-30 (launched in
    range a), 25-40 (in b), 60-70 (outside); a host op 40-60."""
    cpu = [(0, 100, WINDOW, 0, 1),
           (5, 20, PREFIX + "adamw#0", 0, 1),
           (21, 24, PREFIX + "softmoe.routing_fwd#1", 0, 1),
           (6, 7, "cudaLaunchKernel", 501, 1),
           (22, 23, "cudaLaunchKernel", 502, 1),
           (50, 51, "cudaLaunchKernel", 503, 1),
           (40, 60, "aten::mul", 0, 1)]
    dev = [(10, 30, "k_a", 501, 0), (25, 40, "k_b", 502, 0),
           (60, 70, "k_c", 503, 0)]
    return cpu, dev


def test_trace_reduction_unions_and_charges_launches():
    cpu, dev = _trace()
    out = reduce_trace(cpu, dev)
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["busy_s"] == pytest.approx(40e-9)  # 10-40 and 60-70
    assert out["range_device_s"] == {
        PREFIX + "adamw#0": pytest.approx(20e-9),
        PREFIX + "softmoe.routing_fwd#1": pytest.approx(15e-9)}
    assert out["attributed"] == 2
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::mul"] == pytest.approx(20e-9)  # 40-60
    assert sum(gaps.values()) == pytest.approx(60e-9)


def test_readers_on_a_trace():
    cpu, dev = _trace()
    ctx = {"trace": reduce_trace(cpu, dev),
           "bounds": {PREFIX + "adamw#0": 10e-9,
                      PREFIX + "softmoe.routing_fwd#1": 3e-9},
           "flops_per_step": 989e12 * 1e-9, "steps_traced": 10}
    assert device_idle_share.read(ctx) == pytest.approx(60.0)
    assert adamw_roofline.read(ctx) == pytest.approx(50.0)
    assert mfu.read(ctx) == pytest.approx(10.0)
    assert adamw_roofline.read({"trace": None}) is None


def test_p95_is_the_nearest_rank():
    lat = list(range(1, 101))
    ctx = {"window": {"latencies_ms": lat}}
    assert infer_batch_ms_p95.read(ctx) == 95
    ctx["window"]["latencies_ms"] = [3.0]
    assert infer_batch_ms_p95.read(ctx) == 3.0
    assert math.isfinite(infer_batch_ms_p95.read(ctx))
