"""The yardstick's arithmetic: pro-rated rates, the 95th percentile over
every request (the unanswered counted), the operation, byte and bound
counts, the trace reduction, and the traffic's seeded draws."""

import types

import numpy as np
import pytest

from usfbench import counting, generator
from usfbench.trace import DeviceTrace

CONF = {"hidden_size": 960, "intermediate_size": 2560, "num_hidden_layers": 32,
        "num_attention_heads": 15, "num_key_value_heads": 5, "head_dim": 64,
        "vocab_size": 49152}


def test_overlap_rate_prorates_steps_at_both_edges():
    steps = [(0.0, 2.0, 100), (2.0, 4.0, 100), (4.0, 6.0, 100)]
    # window [1, 5): half of the first, all of the second, half of the third
    assert generator.overlap_rate(steps, 1.0, 5.0) == pytest.approx(200 / 4.0)
    assert generator.overlap_rate(steps, 6.0, 8.0) == 0.0


def test_percentile_is_over_all_requests():
    values = list(range(1, 101))
    assert generator.percentile(values, 95) == pytest.approx(95.05)
    assert generator.percentile(values, 75) == pytest.approx(75.25)
    assert generator.percentile([3.0], 75) == 3.0


def test_req_p75_counts_unanswered_at_their_wait():
    from usfbench.harness import load_metric

    sent = []
    for i in range(20):
        s = generator.Sent([1], 1, due=float(i) / 10)
        s.done_at = s.due + 1.0 if i < 14 else None
        sent.append(s)
    traffic = types.SimpleNamespace(due_in=lambda a, b: [s for s in sent if a <= s.due < b])
    ctx = types.SimpleNamespace(traffic=traffic, t_w0=0.0, t_w1=2.0, t_drained=100.0)
    got = load_metric("req_p75_s").read(ctx)
    assert got > 90.0  # the six unanswered requests sit in the tail


def test_model_flops_of_smollm():
    n = counting.matmul_params(CONF)
    assert n == 32 * (960 * 960 * 2 + 960 * 320 * 2 + 3 * 960 * 2560) + 960 * 49152
    attn = counting.attention_flops_per_seq(CONF, 2048)
    assert attn == 32 * 4 * 15 * 64 * (2048 * 2049 // 2)
    assert counting.train_flops_per_token(CONF, 2048) == pytest.approx(6 * n + 3 * attn / 2048)


def test_flash_bound_is_the_larger_term():
    # smollm's training microbatch: B=4 S=2048 H=15 KV=5 D=64, bf16: bound by operations
    flops = 4 * 4 * 15 * 64 * (2048 * 2049 // 2)
    moved = (2 * 4 * 2048 * 15 * 64 + 2 * 4 * 2048 * 5 * 64) * 2
    got = counting.flash_fwd_bound_s(4, 2048, 15, 5, 64, "bfloat16")
    assert got == pytest.approx(max(flops / 989e12, moved / 3.35e12))
    assert got == pytest.approx(flops / 989e12)
    # one query row a head: bound by bytes
    assert counting.flash_fwd_bound_s(1, 1, 1, 1, 64, "bfloat16") == pytest.approx(
        (2 * 64 + 2 * 64) * 2 / 3.35e12)


def test_trace_reduction():
    tr = DeviceTrace(0.0, 0.0)
    tr.t0, tr.t1 = 0.0, 1.0
    ns = 1_000_000  # 1 ms
    tr.events = [("flash_fwd_tma_wgmma", 0, 100 * ns), ("gemm", 50 * ns, 100 * ns),
                 ("gemm", 400 * ns, 100 * ns), ("flash_fwd_tma_wgmma", 900 * ns, 50 * ns)]
    assert tr.busy_s() == pytest.approx(0.30)
    assert tr.launches("flash_fwd") == (2, pytest.approx(0.15))
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["gemm", pytest.approx(0.2)]
    assert bd["idle_gaps"][0] == ["after gemm", pytest.approx(0.4)]
    assert len(bd["idle_gaps"]) == 2


def test_seeds_reorder_the_same_work():
    mix = {"prompt": {"median": 48, "sigma": 0.6, "min": 8, "max": 192},
           "output": {"median": 24, "sigma": 0.6, "min": 8, "max": 96}}
    a = generator.draw(mix, 200, np.random.default_rng(1), 49152)
    b = generator.draw(mix, 200, np.random.default_rng(2), 49152)
    # the same (prompt, output) pairs, in another order
    assert sorted((len(p), n) for p, n in a) == sorted((len(p), n) for p, n in b)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]
    assert all(8 <= len(p) <= 192 and 8 <= n <= 96 for p, n in a)
    ta = generator.arrival_offsets(4.0, 40.0, np.random.default_rng(1))
    tb = generator.arrival_offsets(4.0, 40.0, np.random.default_rng(2))
    assert abs(len(ta) - len(tb)) <= 3 and 150 <= len(ta) <= 160
    assert np.all(np.diff(ta) > 0) and ta[-1] < 40.0
    again = generator.draw(mix, 200, np.random.default_rng(1), 49152)
    assert again == a
