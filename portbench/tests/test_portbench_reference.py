"""The plain reference against the port at a small size on the CPU, and the
check's numbers."""
import json

import numpy as np
import torch

from conftest import ROOT, SMOKE_CONF
from portbench.families import dense as fam
from portbench.harness import check as CK
from portbench.reference import dense as ref


def smoke_conf():
    conf = json.loads((ROOT / "portbench/configs/qwen3-8b.json").read_text())
    conf.update(SMOKE_CONF, name="qwen3-8b", source="test")
    return conf


def test_reference_is_the_ports_forward_in_fp32():
    """Same weights (the benchmark's draw, in bf16), each side in float32:
    the reference and the port's own full-sequence forward agree to
    float32 rounding."""
    from repro_torch.models import transformer as T
    conf, seed = smoke_conf(), 2 ** 31 + 5
    cfg = fam.port_config(conf)
    params = fam.port_params(conf, seed, "cpu")
    f32 = {"layers": {k: v.float() for k, v in params["layers"].items()},
           **{k: params[k].float() for k in ("embed", "final_norm", "lm_head")}}
    toks = np.random.default_rng(0).integers(0, conf["vocab_size"], size=(2, 40))
    port = T.forward(cfg, f32, torch.as_tensor(toks))[:, -1].numpy()
    want = ref.next_token_logits(conf, seed, list(toks), "cpu", q_block=16, row_block=24)
    assert np.abs(port - want).max() <= 1e-5 * np.abs(want).max()


def test_reference_blocks_do_not_change_the_result():
    conf = smoke_conf()
    toks = [np.arange(33) % 256, (np.arange(17) * 7) % 256]
    a = ref.next_token_logits(conf, 3, toks, "cpu", q_block=5, row_block=7)
    b = ref.next_token_logits(conf, 3, toks, "cpu", q_block=64, row_block=64)
    assert np.allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


def test_fp8_control_moves_the_logits_more_than_bf16_weights_do():
    conf = smoke_conf()
    toks = [np.random.default_rng(1).integers(0, 256, size=64)]
    want = ref.next_token_logits(conf, 9, toks, "cpu")
    ctrl = ref.next_token_logits(conf, 9, toks, "cpu", precision="fp8")
    assert CK.numbers(ctrl, want)["logit_err"] > 1e-2


def test_numbers_and_judge():
    want = np.array([[1.0, 2.0, 4.0], [0.0, -8.0, 1.0]])
    got = np.array([[1.0, 4.5, 4.0], [0.0, -8.0, 1.0]])
    n = CK.numbers(got, want)
    assert n == {"logit_err": 2.5 / 4.0}
    ok, checks = CK.judge(n, {"logit_err": 0.7})
    assert ok and checks["logit_err"] == {"value": 0.625, "limit": 0.7}
    assert not CK.judge(n, {"logit_err": 0.6})[0]
    ok, checks = CK.judge({"logit_err": float("nan")}, {"logit_err": 0.7})
    assert not ok and checks["logit_err"]["value"] is None


def test_sample_holds_the_longest_and_follows_the_seed():
    from portbench.harness.serve import Served
    # waves of one request each
    served = [Served(i, 100 + (i == 7) * 50, 0.0, start=float(i)) for i in range(20)]
    a, b = CK.sample(served, 5, 42), CK.sample(served, 5, 42)
    assert [s.rid for s in a] == [s.rid for s in b] and 7 in {s.rid for s in a}
    assert len(a) == 5 and len({s.rid for s in a}) == 5
    assert sorted(s.rid for s in CK.sample(served[:2], 5, 1)) == [0, 1]


def test_sample_holds_a_whole_wave_of_the_most_requests():
    """Every row of a fullest batch is compared, however small ``k``: a
    fault in one row of a batch cannot hide behind a sample of the other."""
    from portbench.harness.serve import Served
    starts = [0.0, 1.0, 1.0, 2.0, 3.0, 3.0, 3.0, 4.0, 5.0, 5.0, 5.0]
    served = [Served(i, 64, 0.0, start=t) for i, t in enumerate(starts)]
    for seed in range(20):
        got = {s.rid for s in CK.sample(served, 1, seed)}
        assert got in ({4, 5, 6}, {8, 9, 10})
    assert len(CK.sample(served, 6, 3)) == 6
    # a wave of equal requests, one longer request elsewhere: both are in
    served.append(Served(11, 128, 0.0, start=6.0))
    got = {s.rid for s in CK.sample(served, 1, 0)}
    assert 11 in got and len(got) == 4
