"""The port's side of the frontend parity tests (``tests/test_torch_
frontends.py``, ``tests/test_torch_encdec.py``): the reference's params and
inputs from ``frontend_reference``'s ``.npz``, and ``prefill_pipeline``
held to the reference's pipeline and forward."""
from collections import Counter

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_smoke_config, replace
from repro_torch.core import pipeline as pp
from repro_torch.kernels import ops
from repro_torch.obs import telemetry as obs_t
from tests.helpers.frontend_reference import CASES, C, M

POOLS = ("torch", "cuda", "paged")
EXACT = ("own_chunks", "hosted_chunks", "spill_events", "fetch_events",
         "qship_events", "launches", "prefix_hit")
ATTN_TAGS = ("chunk_attention", "pool_attention", "pool_attention_paged")


def unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def smoke(arch: str):
    return replace(get_smoke_config(arch), dtype="float32")


def params(reference: dict):
    return bridge.params_from_numpy(unflatten(reference, "param/"), device="cpu")


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) / (np.abs(want) + 1e-3)).max())


def check_pipeline(reference: dict, arch: str, case: str, pool: str,
                   encoder_launches: int = 0) -> None:
    """``prefill_pipeline`` of the smoke ``arch`` in fp32 under mocap, the
    case's N and remote attention, the ``pool`` backend (``cuda`` and
    ``paged`` take the kernels' plain versions on the CPU): logits within
    max rel err 2e-3 of the reference's pipeline and of its forward's last
    position, every ledger key at rtol 1e-6, the telemetry equal (the
    counts exactly, the rest at rtol 1e-6). Under the kernel backends the
    reference's ``launches`` (its jnp backend scans slot by slot) are
    replaced by the wrappers' own count: N x the attention kernels' calls
    in the tick loop (``encoder_launches`` more run before it)."""
    n, remote = CASES[case]
    cfg = smoke(arch)
    kernels = pool != "torch"
    run = RunConfig(num_chunks=M, num_stages=n, mbkr=True, remote_attn=remote,
                    attn_backend="cuda" if kernels else "torch", pool_backend=pool)
    plan = pp.build_plan(cfg, n, M * C, run)
    staged = pp.stage_params(cfg, params(reference), plan)
    with ops.timed_launches("cpu") as frame:
        logits, led, tel = pp.prefill_pipeline(
            cfg, staged, reference["tokens"], plan, device="cpu",
            embeds=torch.from_numpy(reference["embeds"]), return_ledger=True,
            return_telemetry=True)
    got = logits.numpy()
    assert got.shape == reference[case + "/logits"].shape and np.isfinite(got).all()
    assert rel_err(got, reference[case + "/logits"]) < 2e-3
    assert rel_err(got, reference["forward"][:, -1]) < 2e-3
    for key, value in led.items():
        np.testing.assert_allclose(value, reference[f"{case}/ledger/{key}"],
                                   rtol=1e-6, err_msg=key)
    # N = 8 is the deep case (p2 = 6: the last chunk reads a remote chunk)
    assert led["spill"] > 0 and (n < 8 or led[{"qship": "qship_q",
                                                 "fetch": "fetch"}[remote]] > 0)
    assert set(tel) == set(obs_t.TELEM_KEYS)
    for key in obs_t.TELEM_KEYS:
        want = reference[f"{case}/tel/{key}"]
        assert tel[key].shape == want.shape == (n, plan.num_ticks), key
        if key == "launches" and kernels:
            calls = Counter(tag for tag, _ in frame["events"])
            attn = sum(calls[t] for t in ATTN_TAGS) - encoder_launches
            assert tel[key][:, -1].sum() == n * attn > 0
        elif key in EXACT:
            np.testing.assert_array_equal(tel[key], want, err_msg=key)
        else:
            np.testing.assert_allclose(tel[key], want, rtol=1e-6, err_msg=key)


def check_decode(reference: dict, arch: str, model, prm) -> None:
    """The reference's decode: from its cache of the prompt (carried over
    by the bridge), 4 steps of the port's ``decode_step`` (K5's plain
    version): logits within 2e-3 of max|logit| every step, every cache leaf
    within 1e-5 of its own max|ref| at the end."""
    cache = bridge.cache_from_numpy(unflatten(reference, "decode/cache0/"), "cpu")
    toks = reference["tokens"]
    p0 = int(reference["decode/cache0/pos"][0]) - (
        reference["embeds"].shape[1] if model.cfg.family == "vlm" else 0)
    steps = sum(1 for k in reference if k.startswith("decode/logits"))
    for t in range(steps):
        logits, cache = model.decode_step(prm, cache, torch.from_numpy(toks[:, p0 + t]))
        want = reference[f"decode/logits{t}"]
        assert np.abs(logits.numpy() - want).max() <= 2e-3 * np.abs(want).max()
    for key, w in unflatten(reference, "decode/cache/").items():
        if key == "pos":
            assert cache[key].tolist() == w.tolist()
            continue
        assert np.abs(cache[key].numpy() - w).max() <= 1e-5 * np.abs(w).max(), key
