"""The generators are deterministic by seed; the open loop's schedule is
plain Poisson, one schedule for every run; the needed-work count against
numbers worked by hand at a small size."""
import json

import numpy as np
import pytest

from portbench.harness.weights import sub_seed
from portbench.traffic import gen
from portbench.work import needed as W

BIG = 2 ** 31 + 987654321


def test_token_stream_is_the_seeds():
    a, b, c = gen.TokenStream(BIG, 151936), gen.TokenStream(BIG, 151936), gen.TokenStream(7, 151936)
    x, y = [a.next(4096) for _ in range(3)], [b.next(4096) for _ in range(3)]
    assert all(np.array_equal(p, q) for p, q in zip(x, y))
    assert not np.array_equal(x[0], c.next(4096))
    assert x[0].dtype == np.int64 and x[0].min() >= 0 and x[0].max() < 151936


def test_token_stream_is_make_requests_draw():
    """The frozen copy draws what the port's ``make_requests`` draws."""
    from repro_torch.launch.serve import make_requests
    s = gen.TokenStream(11, 1000)
    for r in make_requests(3, 64, 1000, seed=11):
        assert np.array_equal(r.tokens, s.next(64))


def test_poisson_arrivals_is_the_ports():
    from repro_torch.sched.scheduler import poisson_arrivals
    assert gen.poisson_arrivals(2.5, 40, seed=3) == poisson_arrivals(2.5, 40, seed=3)


@pytest.mark.parametrize("rate,seconds", [(1.9, 50.0), (4.0, 3.0), (0.5, 50.0)])
def test_open_loop_schedule_is_plain_poisson_from_the_mix(rate, seconds):
    """One schedule for every run: the Poisson arrivals of the mix's
    ``schedule_seed``, ``round(rate * seconds)`` of them."""
    from conftest import ROOT
    from portbench.harness.layout import Layout
    kind = Layout(ROOT).module("traffic", "open")
    mix = {"rate": rate, "schedule_seed": BIG}
    a = kind.schedule(mix, seconds)
    assert a == kind.schedule(dict(mix), seconds)
    assert a == gen.poisson_arrivals(rate, max(1, round(rate * seconds)), BIG)
    assert a != kind.schedule(dict(mix, schedule_seed=12), seconds)
    assert len(a) == max(1, round(rate * seconds)) and np.all(np.diff(a) > 0)
    # exponential gaps: no smoothing of their spread
    big = np.diff(np.r_[0.0, gen.poisson_arrivals(rate, 20000, BIG)])
    assert abs(big.mean() * rate - 1) < 0.03 and abs(big.std() / big.mean() - 1) < 0.03


def test_sub_seed_takes_any_whole_number():
    assert sub_seed(BIG, "x") == sub_seed(BIG, "x") != sub_seed(BIG + 1, "x")
    assert 0 <= sub_seed(2 ** 70, "layer3") < 2 ** 63


SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             intermediate_size=128, vocab_size=256, num_hidden_layers=3)


def test_needed_work_by_hand():
    # q 64x64, k and v 64x32 each, o 64x64, gate / up / down 64x128 each
    assert W.layer_matmul_weights(SMALL) == 4096 + 2 * 2048 + 4096 + 3 * 8192
    flops, nbytes = W.causal_attention_work(SMALL, 8)
    assert flops == 4 * 16 * 4 * (8 * 9 / 2)                 # 9216
    assert nbytes == 2 * (2 * 8 * 4 * 16 + 2 * 8 * 2 * 16)   # 3072
    assert W.request_flops(SMALL, 8) == 3 * (2 * 36864 * 8 + 9216) + 2 * 64 * 256
    assert W.attention_least_seconds(SMALL, 8) == pytest.approx(3 * 3072 / 3.35e12)


def test_needed_work_at_full_size():
    from conftest import ROOT
    conf = json.loads((ROOT / "portbench/configs/qwen3-8b.json").read_text())
    # 36 layers of 192,937,984 matrix weights; attention 41 % of an S 32768 request
    assert W.layer_matmul_weights(conf) == 192937984
    f = W.request_flops(conf, 32768)
    assert W.causal_attention_work(conf, 32768)[0] * 36 / f == pytest.approx(0.4103, abs=1e-4)
    assert W.attention_least_seconds(conf, 32768) == pytest.approx(0.32019, rel=1e-4)
