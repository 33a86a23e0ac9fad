"""The port's chunked-pipeline prefill at long chunks and at many chunks
(``repro_torch.core.pipeline``) against the JAX reference
``prefill_pipeline``, float32 smoke qwen3-8b, N = 8 stages, B = 2, on two
geometries: the long-chunk one of ``chip_smoke.py``'s ``[long]`` phase cut
to the CPU (M = 8 chunks of C = 256: MBKR keeps 6 slots a stage against
terapipe's 8) and a many-chunk one (M = 32 chunks of C = 16: 30 against 32).

One subprocess (8 fake host devices) runs the reference with the ``jnp``
attention backend for mocap qship, mocap fetch and terapipe qship, each on
``auto``, int8 and fp8 pages, and writes params, tokens, logits, the
CollectiveLedger and the stage telemetry to an ``.npz``; the port runs each
case on the CPU under each pool backend (``torch``; ``cuda`` and ``paged``,
whose wrappers take the kernels' plain versions on the CPU).

Float pages: max rel err < 2e-3 against the reference logits (the bound of
``tests/helpers/pipeline_check.py``). int8 and fp8 pages: argmax equal and
p99 rel err < 1e-2 against the reference's own logits on the same codec
(both sides read the same quantized pages; a last-bit difference in the
fp32 activations can move a stored value by one code, so the tail and the
argmax are held, as ``tests/test_torch_pipeline.py`` holds int8). Every
ledger key equal at rtol 1e-6; the telemetry's ``kv_bytes`` per (stage,
tick) equal at rtol 1e-6 (the reference sums it in fp32, the port in
float64); the largest per-stage peak of ``kv_bytes`` under MBKR against
terapipe's equal to the plan's slot ratio.

Then ``chip_smoke.py``'s split plain versions (``plain_of``: rows, then
blocks of query rows, under a scores cap) against the whole plain call, its
sliced per-launch check (``shadowed(q_block=)``) with the long-only planted
faults, and its tiled P32 witness against the untiled one."""
import importlib.util
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import RunConfig, get_smoke_config, replace
from repro_torch.core import attention
from repro_torch.core import pipeline as pp
from repro_torch.core.staging import init_staged
from repro_torch.kernels import ops, ref
from repro_torch.obs import telemetry as obs_t
from tests.helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
N, B = 8, 2
GEOMETRIES = {"long_chunks": (8, 256), "many_chunks": (32, 16)}   # name: (M, C)
MODES = {   # name: (mode, remote_attn)
    "mocap_qship": ("mocap", "qship"),
    "mocap_fetch": ("mocap", "fetch"),
    "terapipe_qship": ("terapipe", "qship"),
}
KVS = ("auto", "int8", "fp8")
SLOT_RATIO = {"long_chunks": 6 / 8, "many_chunks": 30 / 32}

REFERENCE = r"""
import sys
import jax, numpy as np
from repro import compat
from repro.compat import AxisType
from repro.configs.base import RunConfig, get_smoke_config, replace
from repro.core import pipeline as pp
from repro.core import transport as tx
from repro.models.api import build_model
from repro.models.topology import Topology

N, B = {N}, {B}
GEOMETRIES, MODES, KVS = {GEOMETRIES!r}, {MODES!r}, {KVS!r}
cfg = replace(get_smoke_config("qwen3-8b"), dtype="float32")
mesh = compat.make_mesh((N, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
topo = Topology(mesh=mesh)
params = build_model(cfg).init(jax.random.key(0))
out = {{}}
for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
    out["param/" + "/".join(str(k.key) for k in path)] = np.asarray(leaf)
for geo, (m, c) in GEOMETRIES.items():
    toks = jax.random.randint(jax.random.key(1), (B, m * c), 0, cfg.vocab_size)
    out[geo + "/tokens"] = np.asarray(toks)
    for name, (mode, remote) in MODES.items():
        for kv in KVS:
            run = RunConfig(num_chunks=m, num_stages=N, mbkr=mode == "mocap",
                            remote_attn=remote, attn_backend="jnp", kv_dtype=kv)
            plan = pp.build_plan(cfg, N, m * c, run, mode=mode)
            staged = pp.stage_params(cfg, params, plan)
            with compat.set_mesh(mesh):
                logits, led, tel = jax.jit(lambda st, tk: pp.prefill_pipeline(
                    cfg, st, tk, plan, topo, return_ledger=True,
                    return_telemetry=True))(staged, toks)
            key = f"{{geo}}/{{name}}/{{kv}}"
            out[key + "/logits"] = np.asarray(logits, np.float32)
            for k, v in tx.ledger_to_dict(led).items():
                out[key + "/ledger/" + k] = np.float64(v)
            out[key + "/kv_bytes"] = np.asarray(tel["kv_bytes"], np.float64)
np.savez(sys.argv[1], **out)
print("DONE")
""".format(N=N, B=B, GEOMETRIES=GEOMETRIES, MODES=MODES, KVS=KVS)


def _unflatten(flat, prefix):
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stdout + r.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cfg():
    return replace(get_smoke_config("qwen3-8b"), dtype="float32")


_RUNS: dict = {}


def _run(reference, geo, name, kv, pool_backend):
    """The port's (logits, ledger, telemetry, plan) of one case, run once
    a module (the slot-ratio test reads the pipeline test's runs)."""
    key = (geo, name, kv, pool_backend)
    if key not in _RUNS:
        _RUNS[key] = _run_case(reference, geo, name, kv, pool_backend)
    return _RUNS[key]


def _run_case(reference, geo, name, kv, pool_backend):
    m, c = GEOMETRIES[geo]
    mode, remote = MODES[name]
    cfg = _cfg()
    run = RunConfig(num_chunks=m, num_stages=N, mbkr=mode == "mocap", remote_attn=remote,
                    kv_dtype=kv, attn_backend="torch" if pool_backend == "torch" else "cuda",
                    pool_backend=pool_backend)
    plan = pp.build_plan(cfg, N, m * c, run, mode=mode)
    params = bridge.params_from_numpy(_unflatten(reference, "param/"), device="cpu")
    staged = pp.stage_params(cfg, params, plan)
    logits, led, tel = pp.prefill_pipeline(cfg, staged, reference[geo + "/tokens"], plan,
                                           device="cpu", return_ledger=True,
                                           return_telemetry=True)
    return logits.numpy(), led, tel, plan


@pytest.mark.parametrize("pool_backend", ["torch", "cuda", "paged"])
@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("name", list(MODES))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_pipeline_matches_reference(reference, geo, name, kv, pool_backend):
    m, c = GEOMETRIES[geo]
    got, led, tel, plan = _run(reference, geo, name, kv, pool_backend)
    key = f"{geo}/{name}/{kv}"
    assert plan.p2 == ({8: 6, 32: 30}[m] if MODES[name][0] == "mocap" else m)
    want = reference[key + "/logits"]
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / (np.abs(want) + 1e-3)
    if kv == "auto":
        assert rel.max() < 2e-3, rel.max()
    else:
        assert (got.argmax(-1) == want.argmax(-1)).all()
        assert np.percentile(rel, 99) < 1e-2, np.percentile(rel, 99)
    for k, value in led.items():
        np.testing.assert_allclose(value, reference[f"{key}/ledger/{k}"], rtol=1e-6,
                                   err_msg=k)
    assert tel["kv_bytes"].shape == (N, m + N - 1)
    np.testing.assert_allclose(tel["kv_bytes"], reference[key + "/kv_bytes"], rtol=1e-6)


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_mbkr_peak_is_the_slot_ratio(reference, geo, kv):
    """The largest per-stage peak of ``kv_bytes`` under MBKR over
    terapipe's is the plans' slot ratio (6/8 at M 8, 30/32 at M 32), on
    the port and on the reference."""
    peaks, slots = {}, {}
    for name in ("mocap_qship", "terapipe_qship"):
        _, _, tel, plan = _run(reference, geo, name, kv, "cuda")
        peaks[name] = obs_t.TelemetryProfile.from_run(tel).per_stage_peak("kv_bytes").max()
        slots[name] = plan.num_slots
        want = reference[f"{geo}/{name}/{kv}/kv_bytes"].max(axis=1).max()
        np.testing.assert_allclose(peaks[name], want, rtol=1e-6)
    ratio = peaks["mocap_qship"] / peaks["terapipe_qship"]
    assert slots["mocap_qship"] / slots["terapipe_qship"] == SLOT_RATIO[geo]
    assert ratio == SLOT_RATIO[geo], ratio


# ------------------------------------------------ chip_smoke.py's checks

@pytest.fixture(scope="module")
def cs():
    """``chip_smoke.py`` as a module (it imports the standard library only
    at its top)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _inputs(kind, c=48, t=48, h=4, kvh=2, d=16, slots=3, pt=24):
    """(args, kw) of a call of ``ops.<kind>`` over N stage groups of B rows:
    K1 with a causal offset and kv_len < T, K2 over a stack with a mixed
    valid [N, S] (group 0 reads nothing), K3 off a grouped page store with
    two pages a chunk and shuffled handles."""
    q = _randn(N * B, c, h, d)
    valid = torch.zeros((N, slots), dtype=torch.bool)
    for s in range(N):
        valid[s, :min(s, slots)] = True
    if kind == "chunk_attention":
        return (q, _randn(N * B, t, kvh, d, seed=1), _randn(N * B, t, kvh, d, seed=2)), \
            dict(causal_offset=t - c + 5, kv_len=t - 7, return_state=True)
    if kind == "pool_attention":
        return (q, _randn(slots, N * B, t, kvh, d, seed=1),
                _randn(slots, N * B, t, kvh, d, seed=2), valid), dict(kv_len=t - 7)
    ppc = t // pt
    handles = torch.randperm((slots + 1) * ppc, generator=torch.Generator().manual_seed(3))
    return (q, _randn(N, (slots + 1) * ppc, B, pt, kvh, d, seed=1),
            _randn(N, (slots + 1) * ppc, B, pt, kvh, d, seed=2),
            handles[:slots * ppc].to(torch.int32), valid), dict(ppc=ppc, kv_len=t - 7)


def _close(got, want, rtol=1e-6):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(w <= -1e29, g <= -1e29)
        tol = rtol * max(1.0, w.float().abs().max().item())
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("cap", [1 << 30, 6000, 1500])
@pytest.mark.parametrize("kind", ["chunk_attention", "pool_attention",
                                  "pool_attention_paged"])
def test_split_plain_matches_the_whole_call(cs, monkeypatch, kind, cap):
    """``plain_of(kind)`` under a small PLAIN_SCORES_BYTES splits a call by
    stage groups' rows and then by blocks of query rows (K1's causal
    offset moving with each block's first row); its result equals the
    whole plain call's (rows and query rows are independent: only the fp32
    summation order may differ)."""
    args, kw = _inputs(kind)
    plain = {"chunk_attention": ref.chunk_attention_plain,
             "pool_attention": ref.pool_attention_plain,
             "pool_attention_paged": ref.pool_attention_paged_plain}[kind]
    want = plain(*args, **{k: v for k, v in kw.items() if k != "return_state"})
    want = want[1:] if kind == "chunk_attention" else want
    calls = []

    def counted(*a, **k):
        calls.append(a[0].shape[:2])
        return plain(*a, **k)
    monkeypatch.setattr(cs, "PLAIN_SCORES_BYTES", cap)
    monkeypatch.setattr(ref, plain.__name__, counted)
    got = cs.plain_of(kind)(*args, **kw)
    got = got[1:] if kind == "chunk_attention" else got
    _close(got, want)
    rows, queries = args[0].shape[:2]
    keys = (args[1].shape[1] if kind == "chunk_attention" else
            args[1].shape[0] * args[1].shape[2] if kind == "pool_attention" else
            args[3].numel() * args[1].shape[-3])
    scores = 4 * rows * queries * args[0].shape[2] * keys
    assert (len(calls) == 1) == (cap >= scores), (len(calls), scores)
    assert sum(r * q for r, q in calls) == rows * queries      # each (row, query) once
    if cap <= 1500:                                            # query blocks, not only rows
        assert any(q < queries for _, q in calls)


@pytest.mark.parametrize("kind", ["chunk_attention", "pool_attention_paged"])
def test_sliced_check_holds_the_kernel_and_breaks_the_long_faults(cs, monkeypatch, kind):
    """The sliced per-launch check (``shadowed(q_block=)``, every row's
    last q_block queries against the plain version run on those queries
    alone) passes the wrapper itself and breaks the long-only faults of
    ``long_faults``, which drop the keys past LONG_FAULT_KEYS; the same
    faults drop nothing on a launch of no more keys than that."""
    monkeypatch.setattr(cs, "LONG_FAULT_KEYS", 16)
    args, kw = _inputs(kind, c=64, t=64, pt=64)
    kw.pop("kv_len")
    real = getattr(ops, kind)
    fault = cs.long_faults(ops.chunk_attention, ops.pool_attention_paged)[kind][1]
    for fn, breaks in ((real, False), (fault, True)):
        worst = [0.0]
        got = cs.shadowed(fn, kind, worst, q_block=16)(*args, **kw)
        assert (worst[0] > 1.0) == breaks, worst[0]
        _close(got, fn(*args, **kw), rtol=0)
    short, _ = _inputs(kind, c=16, t=16, pt=16)
    kw = {} if kind == "chunk_attention" else {"ppc": 1}
    _close(fault(*short, **kw), real(*short, **kw), rtol=0)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_tiled_witness_matches_the_untiled_one(cs, monkeypatch, kv):
    """The P32 witness (``p32_witness``) in query tiles smaller than a
    chunk, with its slot and row skips, against the same witness in one
    tile: logits within 1e-6 of max|logit| (fp32 summation order), on the
    deep geometry of M = 8 chunks of 32 under qship and fetch."""
    cfg = _cfg()
    m, c = 8, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, m * c))
    for remote in ("qship", "fetch"):
        run = RunConfig(num_chunks=m, num_stages=N, remote_attn=remote, kv_dtype=kv,
                        attn_backend="torch", pool_backend="torch")
        plan = pp.build_plan(cfg, N, m * c, run)
        staged = init_staged(cfg, plan, torch.Generator().manual_seed(0), device="cpu")
        out = {}
        for tile in (8, 10 ** 6):
            monkeypatch.setattr(cs, "WITNESS_TILE", tile)
            with cs.swapped(attention, "_BACKENDS",
                            dict(attention._BACKENDS, torch=cs.p32_witness())):
                out[tile] = pp.prefill_pipeline(cfg, staged, toks, plan, device="cpu")
        scale = out[10 ** 6].abs().max().item()
        assert (out[8] - out[10 ** 6]).abs().max().item() <= 1e-6 * scale
        assert math.isfinite(scale) and scale > 0


def test_k1_plain_scores_only_the_visible_keys():
    """K1's plain version, block by block over the keys each block of
    query rows can see, equals the masked whole-row state (``_state``
    over every key under the causal and kv_len mask) to 1e-6 of each
    output's max|ref|, sentinel rows (no visible key) included, at offsets
    that leave the first rows empty, cut a block, or see every key."""
    for c, t, off, kv_len in ((300, 300, 0, 300), (300, 600, 300, 550),
                              (200, 200, -5, 200), (130, 1000, 870, 1000),
                              (96, 700, 700, 700)):
        q, k, v = _randn(2, c, 4, 16), _randn(2, t, 2, 16, seed=1), _randn(2, t, 2, 16, seed=2)
        qpos = torch.arange(c)[:, None] + off
        kpos = torch.arange(t)[None, :]
        want = ref._state(q, k, v, (kpos <= qpos) & (kpos < kv_len), 1.0 / math.sqrt(16))
        got = ref.chunk_attention_plain(q, k, v, causal_offset=off, kv_len=kv_len)[1:]
        _close(got, want)
