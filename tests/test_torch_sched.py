"""The port's serving control plane against the JAX package's: the
continuous chunk-level scheduler (``repro_torch.sched``) and both engines
(``repro_torch.runtime.engine``) on ``SimExecutor``, the analytic executor.

Each side runs from its own configs on the same request stream. Everything
here is float64 numpy on the host, so admission orders, lease timelines,
replays and counts must be equal, and finish times and metrics equal at
rtol 1e-12."""
import itertools
import json
import math

import numpy as np
import pytest

from repro.configs.base import get_config as ref_config
from repro.core import costmodel as ref_cm
from repro.runtime import engine as ref_engine
from repro.sched import poisson_arrivals as ref_poisson
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.runtime import engine
from repro_torch.sched import (POLICIES, KVLeaseManager, chunk_page_bytes,
                               poisson_arrivals)

BUCKETS = (8192, 32768, 131072)
# name: (arch, seq_lens cycled over the stream, slow map, lease budget in
# largest chunks of the first request's bucket: None keeps the engine's; 8
# fits one request but not the overlap of the next, so admissions are
# deferred and reordered)
SCENARIOS = {
    "plain": ("qwen3-8b", (30000,), None, None),
    "straggler": ("qwen3-8b", (30000,), {3: 1.7, 11: 1.2}, None),
    "mixed": ("zamba2-7b", (5000, 100000, 20000, 8192), None, None),
    "tight": ("qwen3-8b", (30000, 20000, 32000), None, 8),
}


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, float), np.asarray(want, float),
                               rtol=1e-12, atol=0)


def same_dict(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert (math.isnan(v) and math.isnan(got[k])) or \
                got[k] == pytest.approx(v, rel=1e-12, abs=0), k
        else:
            assert got[k] == v, k


def build(pkg, arch, *, slow=None, fail_at=None, continuous=True, **kw):
    """One engine of ``pkg`` (the port's ``engine`` or the reference's)
    on a SimExecutor, from that package's own config and profile."""
    ours = pkg is engine
    cfg = (get_config if ours else ref_config)(arch)
    hw = (cm if ours else ref_cm).PROFILES["tpu-v5e"]
    ec = pkg.EngineConfig(model=cfg, hw=hw, num_stages=16, tp=16, num_chunks=16,
                          buckets=BUCKETS, sa_iters=8, **kw)
    ex = pkg.SimExecutor(cfg, hw, fail_at=fail_at, slow=slow)
    return (pkg.ContinuousEngine if continuous else pkg.PrefillEngine)(ec, ex)


def stream(pkg, n, seq_lens, rate, seed=0, start=0.0):
    arrivals = (poisson_arrivals if pkg is engine else ref_poisson)(
        rate, n, seed=seed, start=start)
    return [pkg.Request(rid=i, arrival=float(a), seq_len=seq_lens[i % len(seq_lens)])
            for i, a in enumerate(arrivals)]


def check_same(got, want):
    """Two ContinuousEngines after the same run: equal admission orders,
    finish and admit times, lease timelines and metrics."""
    assert [r.rid for r in got.done] == [r.rid for r in want.done]
    assert [r.bucket for r in got.done] == [r.bucket for r in want.done]
    close([r.finish_time for r in got.done], [r.finish_time for r in want.done])
    close([r.admit_time for r in got.scheduler.admitted],
          [r.admit_time for r in want.scheduler.admitted])
    assert [r.state for r in got.scheduler.requests] == \
        [r.state for r in want.scheduler.requests]
    gl, wl = got.lease, want.lease
    close(gl.budget, wl.budget)
    close(gl.hwm, wl.hwm)
    assert gl.refusals == wl.refusals
    assert sorted(gl.leases) == sorted(wl.leases)
    for s, (a, b) in enumerate(zip(gl._timeline, wl._timeline)):
        assert len(a) == len(b), s
        close(a, b) if a else None
    for rid in wl.leases:
        close([(e.stage, e.time, e.nbytes) for e in gl.leases[rid].events],
              [(e.stage, e.time, e.nbytes) for e in wl.leases[rid].events])
    same_dict(got.metrics(), want.metrics())
    assert [(k, r.admit, r.finish, r.deadline, r.rejected) for k, r in
            enumerate(got.records())] == [(k, r.admit, r.finish, r.deadline,
                                           r.rejected) for k, r in
                                          enumerate(want.records())]
    assert (gl.hwm <= gl.budget * (1 + 1e-9)).all(), "a lease exceeded its budget"


@pytest.mark.parametrize("policy,slo,scenario", list(itertools.product(
    sorted(POLICIES), [None, 0.25], sorted(SCENARIOS))))
def test_continuous_engine_matches_reference(policy, slo, scenario):
    arch, seq_lens, slow, budget = SCENARIOS[scenario]
    kw = dict(policy=policy, slo=slo, trace=True,
              partition="lbcp" if scenario != "mixed" else "uniform")
    got, want = (build(pkg, arch, slow=slow, **kw) for pkg in (engine, ref_engine))
    for eng, pkg in ((got, engine), (want, ref_engine)):
        if budget is not None:
            eng.lease.budget[:] = budget * max(eng._chunk_plan(
                engine.bucket_of(BUCKETS, seq_lens[0])).kvb)
        for r in stream(pkg, 14, seq_lens, rate=12.0, seed=5):
            eng.submit(r)
        eng.run_until_drained()
    check_same(got, want)
    m = got.metrics()
    assert m["completed"] + m["rejected"] == 14
    if budget is not None:
        assert m["lease_refusals"] > 0
    if slo is not None:
        assert all(r.deadline == pytest.approx(r.arrival + slo) for r in got.done)
    assert got.trace.chrome_trace() == want.trace.chrome_trace()
    assert got.trace.tasks and got.trace.marks
    assert isinstance(got, engine.CellHandle)


def test_continuous_engine_reentrant_cycles_match_reference():
    """Submit / drain cycles: each drain completes only its own new
    requests, ``poll`` hands each completed request over once, and the
    cumulative state stays equal to the reference's."""
    got, want = (build(pkg, "qwen3-8b", policy="sjf", partition="uniform")
                 for pkg in (engine, ref_engine))
    polled = {id(got): [], id(want): []}
    for cycle in range(3):
        for eng, pkg in ((got, engine), (want, ref_engine)):
            reqs = stream(pkg, 5, (30000, 9000), rate=8.0, seed=cycle,
                          start=2.0 * cycle)
            for r in reqs:
                r.rid += 5 * cycle
                eng.submit(r)
            eng.run_until_drained()
            new = eng.poll()
            assert sorted(r.rid for r in new) == list(range(5 * cycle, 5 * cycle + 5))
            polled[id(eng)] += [r.rid for r in new]
            assert eng.poll() == []
        check_same(got, want)
    assert polled[id(got)] == polled[id(want)]
    for eng in (got, want):
        assert eng.queue_depth() == want.queue_depth()
    assert got.free_lease_bytes() == pytest.approx(want.free_lease_bytes(), rel=1e-12)
    close(got.estimate_admission(30000, 7.0), want.estimate_admission(30000, 7.0))
    got.drain()
    with pytest.raises(RuntimeError):
        got.submit(engine.Request(rid=99, arrival=9.0, seq_len=100))


def test_recalibrate_rebases_future_admissions_like_reference():
    got, want = (build(pkg, "qwen3-8b", partition="uniform")
                 for pkg in (engine, ref_engine))
    for eng, pkg, hw in ((got, engine, "hgx-b200"), (want, ref_engine, "hgx-b200")):
        for r in stream(pkg, 4, (30000,), rate=10.0):
            eng.submit(r)
        eng.run_until_drained()
        eng.recalibrate(hw)
        for r in stream(pkg, 4, (30000,), rate=10.0, seed=1, start=1.0):
            r.rid += 4
            eng.submit(r)
        eng.run_until_drained()
    check_same(got, want)


@pytest.mark.parametrize("case", ["fail", "evict", "replan", "plain"])
def test_prefill_engine_faults_match_reference(case):
    """Batch-synchronous engine: stage failure (re-mesh to N-1 rounded down
    to even, replay), straggler eviction and re-planning give the same
    counts, replays, finish times and checkpoint as the reference, and the
    checkpoint round-trips."""
    kw = {"fail": dict(fail_at={2: 5, 4: 1}), "evict": dict(slow={7: 5.0}),
          "replan": dict(slow={3: 1.5}), "plain": {}}[case]
    got, want = (build(pkg, "qwen3-8b", continuous=False, max_batch=2,
                       partition="lbcp", **kw) for pkg in (engine, ref_engine))
    for eng, pkg in ((got, engine), (want, ref_engine)):
        for r in stream(pkg, 8, (30000, 100000, 6000), rate=0.0):
            eng.submit(r)
        eng.step()
        eng.step()
    sd = got.state_dict()
    assert json.loads(json.dumps(sd)) == json.loads(json.dumps(want.state_dict()))
    for eng in (got, want):
        eng.run_until_drained()
    same_dict(got.metrics(), want.metrics())
    assert [(r.rid, r.replays) for r in got.done] == [(r.rid, r.replays) for r in want.done]
    close([r.finish_time for r in got.done], [r.finish_time for r in want.done])
    assert got.failed_stages == want.failed_stages
    expect = {"fail": (2, 0), "evict": (None, None), "replan": (0, None),
              "plain": (0, 0)}[case]
    m = got.metrics()
    if expect[0] is not None:
        assert m["remeshes"] == expect[0]
    if case == "evict":
        assert m["remeshes"] >= 1
    if case == "replan":
        assert m["replans"] >= 1
    if case == "fail":
        assert m["num_stages"] == 12 and sum(r.replays for r in got.done) == 4
    # restore the mid-run checkpoint into a fresh engine and finish it there
    again = build(engine, "qwen3-8b", continuous=False, max_batch=2,
                  partition="lbcp", **kw)
    again.load_state_dict(json.loads(json.dumps(sd)))
    assert json.loads(json.dumps(again.state_dict())) == json.loads(json.dumps(sd))
    again.run_until_drained()
    assert len(again.done) == 8


def test_lease_manager_and_page_bytes_match_reference():
    from repro.sched.kvlease import KVLeaseManager as RefLease
    from repro.sched.kvlease import Lease as RefLeaseT, LeaseEvent as RefEv
    from repro.sched.kvlease import chunk_page_bytes as ref_page_bytes
    from repro_torch.sched import Lease, LeaseEvent
    kvb, chunks = [100.0, 100.0, 100.0, 60.0], [64, 64, 64, 40]
    for seq, pt, shared in ((None, 0, None), (150, 16, None), (150, 0, [1, 0]),
                            (232, 8, [8, 8, 0, 0]), (None, 16, [2])):
        assert chunk_page_bytes(kvb, chunks, seq, pt, shared) == \
            ref_page_bytes(kvb, chunks, seq, pt, shared)
    ours, ref = KVLeaseManager(2, [250.0, 250.0]), RefLease(2, [250.0, 250.0])
    rng = np.random.default_rng(0)
    for rid in range(12):
        ev = [(int(rng.integers(0, 2)), float(t), float(b))
              for t, b in zip(rng.uniform(0, 10, 3), rng.uniform(10, 120, 3))]
        end = float(rng.uniform(10, 12))
        a = Lease(rid, tuple(LeaseEvent(s, t, b) for s, t, b in ev)
                  + tuple(LeaseEvent(s, end, -b) for s, t, b in ev), end)
        r = RefLeaseT(rid, tuple(RefEv(s, t, b) for s, t, b in ev)
                      + tuple(RefEv(s, end, -b) for s, t, b in ev), end)
        assert ours.admit(a) == ref.admit(r)
        close(ours.headroom(after=5.0), ref.headroom(after=5.0))
        assert ours.next_release(3.0) == ref.next_release(3.0)
    ours.prune(before=11.0)
    ref.prune(before=11.0)
    assert ours._timeline == ref._timeline and ours.refusals == ref.refusals
    assert (ours.hwm <= ours.budget).all()


def test_trace_export_is_the_reference_chrome_json(tmp_path):
    """The scheduler trace written to disk (atomically) is the reference's
    Chrome JSON for the same run."""
    got, want = (build(pkg, "qwen3-8b", partition="uniform", trace=True)
                 for pkg in (engine, ref_engine))
    for eng, pkg in ((got, engine), (want, ref_engine)):
        for r in stream(pkg, 5, (30000, 9000), rate=8.0):
            eng.submit(r)
        eng.run_until_drained()
    path = got.trace.export(str(tmp_path / "sub" / "trace.json"))
    doc = json.loads(open(path).read())
    assert doc == json.loads(json.dumps(want.trace.chrome_trace()))
    assert {e["ph"] for e in doc["traceEvents"]} == {"X", "i", "M"}
    assert not list((tmp_path / "sub").glob("*.tmp"))


def test_unported_options_raise():
    cfg = get_config("qwen3-8b")
    with pytest.raises(ValueError):
        engine.EngineConfig(model=cfg, prefix_cache="on")
    with pytest.raises(ValueError):
        engine.EngineConfig(model=cfg, partition="balanced")
    from repro_torch.sched import ChunkScheduler
    with pytest.raises(ValueError):
        ChunkScheduler(4, lambda b: None, prefix_cache=object())
    with pytest.raises(ValueError):
        ChunkScheduler(4, lambda b: None, policy="lifo")
