"""The port's observability closed forms and host-side surfaces against the
JAX reference, in-process (they need no device): telemetry's analytic
twins, the cost model's calibration features, ``obs.calibrate``'s design
matrix, fit and profile JSON, the tick-span collector's ``finalize`` and
``kernel_tag_times`` on synthetic streams, the metrics registry's text
formats, ``HealthMonitor``'s alert streams and the trace recorder.

Every comparison is exact (the same float64 arithmetic on both sides)
unless a tolerance is stated; alert times (``time.perf_counter`` at
detection) are the one field left out."""
import json
from dataclasses import replace as dc_replace

import numpy as np
import pytest

from repro.configs.base import RunConfig as RefRunConfig
from repro.configs.base import get_config as ref_config
from repro.core import costmodel as ref_cm
from repro.core import lbcp as ref_lbcp
from repro.core import mbkr as ref_mbkr
from repro.core import pipeline as ref_pp
from repro.core import transport as ref_tx
from repro.obs import calibrate as ref_cal
from repro.obs import health as ref_health
from repro.obs import metrics as ref_metrics
from repro.obs import profile as ref_profile
from repro.obs import telemetry as ref_t
from repro.obs import trace as ref_trace
from repro.sched.metrics import RequestRecord as RefRecord
from repro_torch.configs import RunConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import lbcp, mbkr
from repro_torch.core import pipeline as pp
from repro_torch.core import transport as tx
from repro_torch.obs import calibrate as cal
from repro_torch.obs import health
from repro_torch.obs import metrics
from repro_torch.obs import telemetry as obs_t
from repro_torch.obs import trace
from repro_torch.obs.profile import TickSpanCollector, kernel_tag_times
from repro_torch.sched.metrics import RequestRecord

ARCHS = ("qwen3-8b", "zamba2-7b", "mamba2-130m", "granite-3-2b")


# ------------------------------------------------------------- telemetry

@pytest.mark.parametrize("m,n,p2,mode,ticks", [
    (8, 8, 6, "mocap", None), (8, 8, 8, "terapipe", None), (16, 16, 12, "mocap", None),
    (4, 8, 3, "mocap", 20), (8, 4, 5, "mocap", 9), (6, 6, 99, "mocap", None)])
def test_analytic_occupancy_matches_reference(m, n, p2, mode, ticks):
    got = obs_t.analytic_occupancy(m, n, p2, mode=mode, ticks=ticks)
    want = ref_t.analytic_occupancy(m, n, p2, mode=mode, ticks=ticks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


PLAN_CASES = [   # (arch, mode, remote, kv_dtype, spill dtype, M, N)
    ("qwen3-8b", "mocap", "qship", "auto", "bfloat16", 8, 8),
    ("qwen3-8b", "mocap", "fetch", "auto", "bfloat16", 8, 8),
    ("qwen3-8b", "mocap", "fetch", "int8", "bfloat16", 8, 8),
    ("qwen3-8b", "mocap", "fetch", "auto", "int8", 16, 16),
    ("qwen3-8b", "terapipe", "qship", "auto", "bfloat16", 8, 8),
    ("zamba2-7b", "mocap", "qship", "fp8", "bfloat16", 8, 8),
    ("granite-3-2b", "mocap", "fetch", "auto", "bfloat16", 16, 8),
]


def _plans(arch, mode, remote, kv, spill, m, n, seq=4096):
    kw = dict(num_chunks=m, num_stages=n, mbkr=mode == "mocap", remote_attn=remote,
              kv_dtype=kv, kv_spill_dtype=spill)
    ours = pp.build_plan(get_config(arch), n, seq, RunConfig(**kw), mode=mode)
    theirs = ref_pp.build_plan(ref_config(arch), n, seq, RefRunConfig(**kw), mode=mode)
    return ours, theirs


@pytest.mark.parametrize("case", PLAN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plan_closed_forms_match_reference(case):
    """``occupancy_model``, ``per_event_wire_bytes``, ``analytic_wire_bytes``
    and ``chunk_stored_bytes`` of the same plan geometry."""
    ours, theirs = _plans(*case)
    arch = case[0]
    assert obs_t.occupancy_model(ours) == ref_t.occupancy_model(theirs)
    for b in (1, 2, 8):
        assert obs_t.per_event_wire_bytes(ours, get_config(arch), b) == \
            ref_t.per_event_wire_bytes(theirs, ref_config(arch), b)
        assert tx.analytic_wire_bytes(ours, get_config(arch), b) == \
            ref_tx.analytic_wire_bytes(theirs, ref_config(arch), b)
    cfg = get_config(arch)
    geom = (ours.layers_per_stage, 2, ours.chunk_len, cfg.num_kv_heads,
            cfg.resolved_head_dim)
    assert obs_t.chunk_stored_bytes(ours, *geom) == ref_t.chunk_stored_bytes(theirs, *geom)


def test_telemetry_profile_matches_reference():
    rng = np.random.default_rng(0)
    data = {k: rng.integers(0, 5, (8, 15)).astype(np.float64) for k in obs_t.TELEM_KEYS}
    ours, theirs = obs_t.TelemetryProfile(data), ref_t.TelemetryProfile(dict(data))
    assert ours.totals() == theirs.totals()
    assert (ours.stages, ours.ticks) == (theirs.stages, theirs.ticks)
    np.testing.assert_array_equal(ours.occupancy(), theirs.occupancy())
    for key in (None, "kv_bytes", "launches"):
        np.testing.assert_array_equal(ours.per_stage_peak(key), theirs.per_stage_peak(key))
        assert ours.peak(key) == theirs.peak(key)
    for key in ("kv_bytes", "own_chunks"):
        assert ours.skew(key) == theirs.skew(key)
    zeros = {k: np.zeros((4, 7)) for k in obs_t.TELEM_KEYS}
    assert obs_t.TelemetryProfile(zeros).skew() == ref_t.TelemetryProfile(zeros).skew() == 0.0
    for num, den in ((0.0, 0.0), (3.0, 0.0), (3.0, 4.0)):
        assert obs_t.safe_ratio(num, den) == ref_t.safe_ratio(num, den)
    assert obs_t.TELEM_KEYS == ref_t.TELEM_KEYS


# ----------------------------------------------------- calibration features

def _sm(arch, n=16, tp=1, ref=False):
    mod, conf = (ref_cm, ref_config) if ref else (cm, get_config)
    return mod.StageModel.build(conf(arch), n, tp)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("use_mbkr", [True, False])
@pytest.mark.parametrize("k", [0, 3])
def test_chunk_cost_features_match_reference(arch, use_mbkr, k):
    """``chunk_cost_features`` equals the reference's, and its product with
    ``profile_theta`` is the analytic per-chunk total (the identity the fit
    inverts)."""
    assert cm.FEATURE_TERMS == ref_cm.FEATURE_TERMS
    chunks = [1024, 2048, 1024, 4096, 2048, 1024, 3072, 2048]
    for hw in ("tpu-v5e", "hgx-b200"):
        got = cm.chunk_cost_features(_sm(arch, 8), chunks, hw, prefix_hit_chunks=k,
                                     mbkr_plan=mbkr.plan(8, 8) if use_mbkr else None)
        want = ref_cm.chunk_cost_features(
            _sm(arch, 8, ref=True), chunks, hw, prefix_hit_chunks=k,
            mbkr_plan=ref_mbkr.plan(8, 8) if use_mbkr else None)
        np.testing.assert_array_equal(got, want)
        dur, comm, _, sp, ft = cm.chunk_cost_arrays(
            _sm(arch, 8), chunks, hw, prefix_hit_chunks=k,
            mbkr_plan=mbkr.plan(8, 8) if use_mbkr else None)
        np.testing.assert_allclose(got @ cm.profile_theta(cm.resolve_profile(hw)),
                                   dur + comm + sp + ft, rtol=1e-12)


def _truth(mod):
    return dc_replace(mod.WSC_PAPER, name="truth",
                      gemm_eff=mod.WSC_PAPER.gemm_eff * 0.8,
                      attn_eff=mod.WSC_PAPER.attn_eff * 1.1,
                      hbm_bw=mod.WSC_PAPER.hbm_bw * 0.9,
                      link_bw=mod.WSC_PAPER.link_bw * 0.95)


def _spans(mod, sm, chunks, mplan, n=16, noise=0.0):
    cost = mod.chunk_cost_features(sm, chunks, mod.WSC_PAPER,
                                   mbkr_plan=mplan) @ mod.profile_theta(_truth(mod), sm.tp)
    m = len(chunks)
    tick_s = np.zeros((n, m + n - 1))
    for s in range(n):
        tick_s[s, s:s + m] = cost
    if noise:
        tick_s *= 1 + noise * np.random.default_rng(0).standard_normal(tick_s.shape)
    return tick_s


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-130m"])
@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_fit_profile_matches_reference(arch, noise):
    """``design_matrix`` and ``fit_profile`` on the same spans give the
    reference's matrix, theta, profile, residuals and MAPEs; noiseless
    spans are recovered to float noise."""
    chunks = [2048] * 16
    mp = mbkr.plan(16, 16) if arch != "mamba2-130m" else None
    rmp = ref_mbkr.plan(16, 16) if arch != "mamba2-130m" else None
    sm, rsm = _sm(arch), _sm(arch, ref=True)
    spans = _spans(cm, sm, chunks, mp, noise=noise)
    np.testing.assert_array_equal(spans, _spans(ref_cm, rsm, chunks, rmp, noise=noise))
    got = cal.design_matrix(sm, chunks, cm.WSC_PAPER, spans, mbkr_plan=mp)
    want = ref_cal.design_matrix(rsm, chunks, ref_cm.WSC_PAPER, spans, mbkr_plan=rmp)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    fit = cal.fit_profile(sm, chunks, spans, cm.WSC_PAPER, mbkr_plan=mp)
    ref = ref_cal.fit_profile(rsm, chunks, spans, ref_cm.WSC_PAPER, mbkr_plan=rmp)
    np.testing.assert_array_equal(fit.theta, ref.theta)
    np.testing.assert_array_equal(fit.residual_s, ref.residual_s)
    assert cm.profile_to_dict(fit.profile) == ref_cm.profile_to_dict(ref.profile)
    assert (fit.mape_nominal, fit.mape_calibrated) == (ref.mape_nominal, ref.mape_calibrated)
    assert fit.rows == ref.rows and fit.residual_records() == ref.residual_records()
    if noise == 0.0 and arch == "qwen3-8b":
        assert fit.mape_nominal > 0.01 and fit.mape_calibrated < 1e-9
    for pred, true in ((spans[spans > 0] * 1.1, spans[spans > 0]), ([0.0], [0.0])):
        assert cal.mape(pred, true) == ref_cal.mape(pred, true)


def test_profile_roundtrip_and_record_match_reference(tmp_path):
    """save -> load keeps the profile bit for bit, so ``plan_partition`` of
    the JSON path gives the in-memory plan (chunks and objective); the
    reference's ``load_profile`` reads the port's file to the same profile,
    and ``calibration_record`` equals the reference's."""
    chunks = [2048] * 16
    sm = _sm("qwen3-8b")
    fit = cal.fit_profile(sm, chunks, _spans(cm, sm, chunks, mbkr.plan(16, 16)),
                          cm.WSC_PAPER, mbkr_plan=mbkr.plan(16, 16))
    path = str(tmp_path / "cal.json")
    cal.save_profile(path, fit.profile, fit=fit, meta={"num_stages": 16, "one_card": True})
    loaded, blob = cal.load_profile(path)
    assert loaded == fit.profile == cm.resolve_profile(path)
    assert blob["meta"] == {"num_stages": 16, "one_card": True}
    assert blob["fit"]["feature_terms"] == list(cm.FEATURE_TERMS)
    assert len(blob["fit"]["residuals"]) == len(fit.rows)
    ref_loaded, _ = ref_cal.load_profile(path)
    assert ref_cm.profile_to_dict(ref_loaded) == cm.profile_to_dict(loaded)
    kw = dict(sa_iters=8, sa_rounds=2, seed=3)
    cfg = get_config("qwen3-8b")
    mem = lbcp.plan_partition(cfg, 32768, 16, 16, fit.profile, **kw)
    disk = lbcp.plan_partition(cfg, 32768, 16, 16, path, **kw)
    ref = ref_lbcp.plan_partition(ref_config("qwen3-8b"), 32768, 16, 16, path, **kw)
    assert disk.chunks == mem.chunks == ref.chunks
    assert disk.dp_objective == mem.dp_objective and disk.t_prefill == mem.t_prefill
    got = cal.calibration_record(sm, chunks, "wsc-gr24", path, mbkr_plan=mbkr.plan(16, 16))
    want = ref_cal.calibration_record(_sm("qwen3-8b", ref=True), chunks, "wsc-gr24", path,
                                      mbkr_plan=ref_mbkr.plan(16, 16))
    assert got == want


# ----------------------------------------------------------- measured spans

STREAMS = {   # (epoch, events, num_stages, num_ticks)
    "one_a_tick": (0.0, [0.1, 0.25, 0.3, 0.5, 0.55, 0.7, 0.9], 4, 7),
    "two_a_tick": (1.0, [1.1, 1.12, 1.3, 1.31, 1.5, 1.52, 1.6, 1.65], 2, 4),
    "short": (0.0, [0.2, 0.4], 3, 6),
    "unsorted": (0.5, [0.9, 0.7, 1.4, 1.1, 2.0], 2, 5),
    "empty": (0.0, [], 4, 7),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_span_finalize_matches_reference(name):
    """``TickSpanCollector.finalize`` on a synthetic stream of arrivals
    equals the reference's on the same stream."""
    epoch, events, n, t = STREAMS[name]
    ours, theirs = TickSpanCollector("cpu"), ref_profile.TickSpanCollector()
    for col in (ours, theirs):
        col.epoch, col.events = epoch, list(events)
    got = ours.finalize(n, t, kernel_s={"k": 1.0})
    want = theirs.finalize(n, t, kernel_s={"k": 1.0})
    np.testing.assert_allclose(got.tick_s, want.tick_s, rtol=1e-12, atol=1e-15)
    assert got.kernel_s == want.kernel_s
    m = t - n + 1
    np.testing.assert_array_equal(got.valid(m), want.valid(m))
    assert got.total() == pytest.approx(want.total(), rel=1e-12)


@pytest.mark.parametrize("frame", [
    {"t0": 0.0, "events": [("chunk_attention", 0.1), ("pool_attention", 0.3),
                           ("chunk_attention", 0.35), ("pool_attention", 0.3)]},
    {"events": [("ssd", 2.0), ("ssd", 2.5), ("chunk_attention", 3.0)]},
    {"t0": 1.0, "events": []}, {}])
def test_kernel_tag_times_matches_reference(frame):
    assert kernel_tag_times(frame) == ref_profile.kernel_tag_times(frame)


def test_timed_frame_on_cpu_stamps_plain_calls():
    """On the CPU a ``timed_launches`` frame stamps each plain-version
    call under its wrapper's tag (host clock); nothing outside a frame."""
    import torch
    from repro_torch.kernels import ops
    q = torch.randn(2, 16, 4, 16)
    k = torch.randn(2, 16, 2, 16)
    with ops.timed_launches("cpu") as frame:
        ops.chunk_attention(q, k, k)
        with ops.timed_launches("cpu") as inner:
            ops.full_attention(q, k, k)
    ops.chunk_attention(q, k, k)
    assert [t for t, _ in frame["events"]] == ["chunk_attention"] * 2
    assert [t for t, _ in inner["events"]] == ["chunk_attention"]
    sec = ops.frame_seconds(frame)
    assert sec["t0"] == 0.0 and all(s >= 0 for _, s in sec["events"])
    assert set(kernel_tag_times(sec)) == {"chunk_attention"}


# ---------------------------------------------------------------- metrics

def _registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("repro_done", "done").inc(3)
    reg.gauge("repro_depth", "queue depth").set(1.5)
    h = reg.histogram("repro_lat_seconds", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    reg.counter("repro_nohelp").inc()
    return reg


def test_metrics_text_formats_match_reference(tmp_path):
    ours, theirs = _registry(metrics), _registry(ref_metrics)
    assert ours.to_jsonl() == theirs.to_jsonl()
    assert ours.to_prom() == theirs.to_prom()
    for ext in (".prom", ".jsonl"):
        a = ours.export(str(tmp_path / f"a{ext}"))
        b = theirs.export(str(tmp_path / f"b{ext}"))
        assert open(a).read() == open(b).read()
    with pytest.raises(TypeError):
        ours.gauge("repro_done")
    summary = {"completed": 3, "rejected": 1, "avg_ttft": 0.7, "flag": True,
               "name": "x", "makespan": 2.5}
    recs = [(0, 0.0, 0.2, 1.0), (1, 0.0, float("inf"), float("inf")), (2, 0.5, 0.6, 3.0)]
    for ext in (".prom", ".jsonl"):
        a = metrics.export_engine_metrics(
            str(tmp_path / f"e{ext}"), summary, extra={"wall_seconds": 1.25},
            records=[RequestRecord(r, arr, 100, 100, admit=ad, finish=f)
                     for r, arr, ad, f in recs])
        b = ref_metrics.export_engine_metrics(
            str(tmp_path / f"r{ext}"), summary, extra={"wall_seconds": 1.25},
            records=[RefRecord(r, arr, 100, 100, admit=ad, finish=f)
                     for r, arr, ad, f in recs])
        assert open(a).read() == open(b).read()


# ----------------------------------------------------------------- health

def _alerts(mon):
    return [{k: v for k, v in a.to_dict().items() if k != "time"} for a in mon.alerts]


def _drive(hmod, mmod, tmod):
    """The same sentinel sequence on one package's monitor: ledger drift,
    SLO burn, occupancy drift (a good and a bad profile), a non-finite
    profile; returns (monitor, registry, recorder, the returned values)."""
    mon = hmod.HealthMonitor(ledger_threshold=0.01, burn_threshold=1.0)
    vals = [mon.check_ledger({"ring": 1.10e9, "fetch": 1.000e8, "x": 0.0},
                             {"ring": 1.00e9, "fetch": 1.001e8, "x": 0.0})]
    h = mmod.Histogram("ttft", buckets=(0.5, 1.0, 2.0))
    for v in (0.1,) * 5 + (1.5,) * 5:
        h.observe(v)
    vals.append(hmod.slo_burn_rate(h, 1.0, target=0.99))
    vals.append(hmod.slo_burn_rate(mmod.Histogram("x"), 1.0))
    vals.append(mon.check_slo(h, 1.0))

    class Plan:
        num_chunks, num_stages, p2, mode = 8, 8, 6, "mocap"

    own, hosted = obs_t.analytic_occupancy(8, 8, 6)
    vals.append(mon.check_occupancy({"own_chunks": own, "hosted_chunks": hosted}, Plan))
    vals.append(mon.check_occupancy({"own_chunks": own * 2, "hosted_chunks": hosted}, Plan))
    counts = np.zeros((8, 15), np.int32)
    counts[3, 3], counts[5, 9] = 7, 2
    mon.note_nonfinite_profile(counts)
    mon.note_nonfinite_profile(np.zeros((8, 15)))
    reg = mmod.MetricsRegistry()
    mon.to_metrics(reg)
    rec = tmod.TraceRecorder(enabled=True)
    mon.to_trace(rec)
    return mon, reg, rec, vals


def test_health_alert_streams_match_reference():
    ours = _drive(health, metrics, trace)
    theirs = _drive(ref_health, ref_metrics, ref_trace)
    assert ours[3] == theirs[3]
    assert _alerts(ours[0]) == _alerts(theirs[0])
    assert [a.kind for a in ours[0].alerts] == ["ledger_drift", "slo_burn", "occupancy_drift",
                                                "nonfinite", "nonfinite"]
    assert ours[0].summary() == theirs[0].summary()
    assert ours[1].to_prom() == theirs[1].to_prom()
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("ts", "dur", "args")}  # noqa: E731
                         for e in evs]
    got, want = (x[2].chrome_trace()["traceEvents"] for x in (ours, theirs))
    assert strip(got) == strip(want) and len(got) == 6
    assert health.ALERT_KINDS == ref_health.ALERT_KINDS


# ------------------------------------------------------------------ trace

def _record(mod):
    rec = mod.TraceRecorder(enabled=True)
    rec.task(rid=1, chunk=0, stage=2, start=0.5, finish=1.0)
    rec.mark(rid=1, kind="arrival", time=0.1)
    rec.span("wave0", pid="engine", tid=0, start=0.0, finish=2.0, cat="wave",
             args={"rids": [1]})
    rec.counter("kv_resident_bytes", pid=2, time=0.5, values={"w0": 42.0})
    rec.process_name("engine", "engine (wall clock)")
    other = mod.TraceRecorder(enabled=True)
    other.task(rid=4, chunk=1, stage=0, start=1.0, finish=1.5)
    other.mark(rid=4, kind="finish", time=1.5)
    other.counter("wire_bytes", pid=0, time=1.0, values={"bytes": 8.0})
    other.process_name("engine", "cell engine")
    rec.absorb(other, pid_prefix="cell1/")
    rec.absorb(other)
    off = mod.TraceRecorder(enabled=False)
    off.task(1, 0, 0, 0.0, 1.0)
    off.span("x", pid=0, tid=0, start=0.0, finish=1.0)
    return rec, off


def test_trace_recorder_matches_reference(tmp_path):
    (rec, off), (ref, ref_off) = _record(trace), _record(ref_trace)
    assert rec.chrome_trace() == ref.chrome_trace()
    assert rec.events() == ref.events()
    assert off.chrome_trace() == ref_off.chrome_trace() == {"traceEvents": [],
                                                           "displayTimeUnit": "ms"}
    out = tmp_path / "nested" / "trace.json"
    path = rec.export(str(out))
    assert json.load(open(path)) == json.loads(json.dumps(ref.chrome_trace()))
    assert [p.name for p in out.parent.iterdir()] == ["trace.json"]
