"""The port's fleet (``repro_torch.fleet``) and serve options
(``repro_torch.launch.options``): the tests of ``tests/test_fleet.py`` on
the port's fleet, on ``SimExecutor`` with llama3-70b, plus exact parity with
the reference's fleet on the same arrivals.

- the lease/cost-aware router (jsf) strictly beats round-robin on p99 TTFT
  over a heterogeneous hot/cold cell pair at equal offered load,
- drain semantics: a draining cell admits ZERO new requests but completes
  everything in flight; the fabric retires it from routing,
- heterogeneous kv_dtype cells price their KV leases independently,
- the 2-cell sim end-to-end: shared arrival stream, fleet roll-up metrics,
  ONE merged trace with per-cell process rows, elastic resize,
- protocol hygiene: ``repro_torch/launch/serve.py`` and
  ``repro_torch/fleet`` touch engines ONLY through ``CellHandle``
  (source scan),
- ServeOptions: JSON round-trip, explicit-flags-as-overrides, fleet spec,
  and the CLI's fleet path on the analytic executor;
- parity: the port's fabric and the reference's, each from its own
  configs and profiles, on the same arrival stream under every router
  policy (and with the prefix cache's affinity signal, a drain and a
  resize mid-stream): placements, every candidate's signals and score,
  request records and fleet metrics equal, floats at rtol 1e-12.

``tests/test_fleet.py::test_legacy_engine_kwargs_deprecated_but_work`` has
no counterpart: the port's ``ContinuousEngine(ec, executor)`` never had the
reference's deprecated ``policy`` / ``slo`` / ``inflight`` / ``trace``
keyword arguments (they are ``EngineConfig`` fields only)."""
import argparse
import json
import math
import os
import re
import subprocess
import sys
from dataclasses import replace as dc_replace

import numpy as np
import pytest

from repro import fleet as ref_fleet
from repro.configs.base import get_config as ref_config
from repro.core import costmodel as ref_cm
from repro.kvstore import prefix as ref_prefix
from repro.runtime import engine as ref_engine
from repro.sched import poisson_arrivals as ref_poisson
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.fleet import (FleetFabric, FleetRouter, PlacementDecision,
                               score_cells)
from repro_torch.fleet import placement
from repro_torch.kvstore import prefix
from repro_torch.launch.options import (ServeOptions, add_serve_args,
                                        options_from_args, resolve_fleet)
from repro_torch.runtime import engine
from repro_torch.runtime.engine import CellHandle, Request
from repro_torch.sched import fleet_summary, poisson_arrivals
from repro_torch.sched.metrics import RequestRecord

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCH = "llama3-70b"
CFG = get_config(ARCH)


def _slow(mod):
    return dc_replace(mod.WSC_PAPER, name="wsc-degraded",
                      gemm_eff=mod.WSC_PAPER.gemm_eff * 0.55,
                      attn_eff=mod.WSC_PAPER.attn_eff * 0.55)


SLOW_HW = _slow(cm)


def _cell(hw=cm.WSC_PAPER, *, kv_dtype="auto", trace=False, slo=None,
          buckets=(32768,), inflight=2, pkg=engine, prefix_cache="off"):
    cfg = CFG if pkg is engine else ref_config(ARCH)
    ec = pkg.EngineConfig(model=cfg, hw=hw, num_stages=16, tp=1, num_chunks=16,
                          buckets=buckets, partition="uniform", sa_iters=8,
                          kv_dtype=kv_dtype, trace=trace, slo=slo, inflight=inflight,
                          prefix_cache=prefix_cache)
    return pkg.ContinuousEngine(ec, pkg.SimExecutor(cfg, hw))


def _pair(policy, *, trace=False):
    return FleetFabric({"fast": _cell(trace=trace),
                        "slow": _cell(SLOW_HW, trace=trace)},
                       FleetRouter(policy))


def _drive(fab, n=24, rate=6.0, seq=30000, seed=0):
    for i, t in enumerate(poisson_arrivals(rate, n, seed=seed)):
        fab.submit(Request(rid=i, arrival=float(t), seq_len=seq))
    fab.pump()
    return fab.metrics()


# ------------------------------------------------------------ protocol seam

def test_continuous_engine_is_a_cell_handle():
    assert isinstance(_cell(), CellHandle)


def test_estimate_admission_matches_realized_finish():
    """The jsf signal is honest: an empty cell's quoted ETA for a request
    IS the finish time the scheduler then realizes for it."""
    eng = _cell()
    eta, fits = eng.estimate_admission(30000, arrival=0.0)
    assert fits
    eng.submit(Request(rid=0, arrival=0.0, seq_len=30000))
    eng.run_until_drained()
    [done] = eng.poll()
    assert done.finish_time == pytest.approx(eta, rel=1e-9)


def test_protocol_only_access_source_scan():
    """serve.py and the whole fleet package consume engines through the
    CellHandle protocol: no scheduler / lease / executor internals, no
    poking executor observability flags, no reading .done directly."""
    forbidden = re.compile(
        r"\.scheduler\.|\.lease\.|\.collect_telemetry|\.collect_measured"
        r"|\.stage_free|\.metrics\.records|\bexecutor\.[a-z_]+\s*="
        r"|eng\.done\b|cell\.done\b|\.executor\.")
    files = [os.path.join(ROOT, "src", "repro_torch", "launch", "serve.py")]
    fleet_dir = os.path.join(ROOT, "src", "repro_torch", "fleet")
    files += [os.path.join(fleet_dir, f) for f in sorted(os.listdir(fleet_dir))
              if f.endswith(".py")]
    assert len(files) == 5
    for path in files:
        src = open(path).read()
        hits = [(i + 1, line) for i, line in enumerate(src.splitlines())
                if forbidden.search(line)]
        assert not hits, f"engine internals poked in {path}: {hits}"


# ------------------------------------------------------------------ routing

def test_jsf_beats_round_robin_on_hot_cold_pair():
    """Equal offered load, one fast + one degraded cell: the lease/cost-
    aware router strictly beats round-robin on p99 TTFT."""
    m_jsf = _drive(_pair("jsf"))
    m_rr = _drive(_pair("rr"))
    assert m_jsf["completed"] == m_rr["completed"] == 24
    assert m_jsf["p99_ttft"] < m_rr["p99_ttft"], (m_jsf["p99_ttft"], m_rr["p99_ttft"])
    assert (m_jsf["per_cell"]["fast"]["completed"]
            > m_jsf["per_cell"]["slow"]["completed"])


def test_least_loaded_routes_by_queue_depth():
    m = _drive(_pair("least-loaded"))
    assert m["completed"] == 24
    assert all(pc["completed"] > 0 for pc in m["per_cell"].values())


def test_router_rejects_unknown_policy():
    with pytest.raises(ValueError):
        FleetRouter("fifo")
    with pytest.raises(ValueError):
        score_cells("rr", [])


def test_placement_decisions_record_all_candidates():
    fab = _pair("jsf")
    fab.submit(Request(rid=0, arrival=0.0, seq_len=30000))
    [dec] = fab.router.decisions
    assert isinstance(dec, PlacementDecision)
    assert {s.name for s in dec.signals} == {"fast", "slow"}
    assert math.isfinite(dec.eta)


# -------------------------------------------------------------------- drain

def test_drain_admits_zero_completes_inflight():
    """drain() on a cell: everything already submitted finishes; any later
    submit raises; the fabric retires it and routes around it."""
    fab = _pair("jsf")
    for i in range(6):
        fab.submit(Request(rid=i, arrival=0.1 * i, seq_len=30000), pump=False)
    placed_fast = [r for r, c in fab.placements.items() if c == "fast"]
    done = fab.drain_cell("fast")
    assert sorted(r.rid for r in done) == sorted(placed_fast)
    assert all(r.state == "done" and math.isfinite(r.finish_time) for r in done)
    with pytest.raises(RuntimeError):
        fab.retired["fast"].submit(Request(rid=99, arrival=9., seq_len=100))
    dec = fab.submit(Request(rid=50, arrival=1.0, seq_len=30000))
    assert dec.cell == "slow"
    fab.pump()
    assert fab.metrics()["completed"] == 7


def test_all_cells_draining_closes_admission():
    fab = _pair("jsf")
    fab.drain_all()
    with pytest.raises(RuntimeError):
        fab.submit(Request(rid=0, arrival=0.0, seq_len=100))


# -------------------------------------------------------- heterogeneous kv

def test_heterogeneous_kv_dtype_cells_price_leases_independently():
    """An int8 cell's lease for the SAME request costs ~half the bytes of
    the bf16 cell's (stored-byte accounting is per-cell state)."""
    peaks = {}
    for kd in ("auto", "int8"):
        cell = _cell(kv_dtype=kd)
        base = cell.free_lease_bytes()
        cell.submit(Request(rid=0, arrival=0.0, seq_len=32768))
        cell.run_until_drained()
        peaks[kd] = base - float(cell.lease.headroom(after=0.0).min())
    assert peaks["auto"] > 0
    ratio = peaks["int8"] / peaks["auto"]
    assert 0.45 < ratio < 0.60, ratio


# ------------------------------------------------------------------- e2e

def test_two_cell_e2e_metrics_trace_and_resize():
    """Every request of the shared stream completes exactly once, the fleet
    summary reconciles with per-cell counts, the merged trace shows BOTH
    cells' process rows, and resize() grows / drains the fleet
    mid-stream."""
    fab = _pair("jsf", trace=True)
    _drive(fab, n=16)
    m = fab.metrics()
    assert m["completed"] == 16 and m["rejected"] == 0
    assert sum(pc["completed"] for pc in m["per_cell"].values()) == 16
    evs = fab.merged_trace().chrome_trace()["traceEvents"]
    pids = {str(e["pid"]) for e in evs}
    assert any(p.startswith("fast/stage") for p in pids)
    assert any(p.startswith("slow/stage") for p in pids)
    assert any(p == "fast/requests" for p in pids)
    fab.resize(["fast", "extra"], factory=lambda name: _cell(trace=True))
    assert set(fab.cells) == {"fast", "extra"}
    assert "slow" in fab.retired
    for i in range(16, 24):
        fab.submit(Request(rid=i, arrival=3.0 + 0.1 * i, seq_len=30000))
    fab.pump()
    m2 = fab.metrics()
    assert m2["completed"] == 24 and m2["cells"] == 3
    assert m2["per_cell"]["slow"]["completed"] == m["per_cell"]["slow"]["completed"]


def test_fleet_summary_merges_records():
    recs = {
        "a": [RequestRecord(rid=0, arrival=0.0, seq_len=10, bucket=16,
                            admit=0.0, finish=1.0, deadline=2.0)],
        "b": [RequestRecord(rid=1, arrival=0.0, seq_len=10, bucket=16,
                            admit=0.5, finish=4.0, deadline=2.0),
              RequestRecord(rid=2, arrival=1.0, seq_len=10, bucket=16,
                            rejected=True)],
    }
    s = fleet_summary(recs)
    assert s["cells"] == 2 and s["completed"] == 2 and s["rejected"] == 1
    assert s["makespan"] == 4.0
    assert s["throughput"] == pytest.approx(0.5)
    assert s["slo_total"] == 2 and s["slo_met"] == 1
    assert s["per_cell"]["b"]["rejected"] == 1


# ------------------------------------------------------------ serve options

def test_serve_options_json_round_trip():
    opts = ServeOptions(arch="llama3-70b", executor="sim", cells=3,
                        router="least-loaded", buckets=(8192, 32768),
                        slo_ms=750.0, scheduler="continuous")
    back = ServeOptions.from_json(opts.to_json())
    assert back == opts
    assert back.buckets == (8192, 32768)
    with pytest.raises(ValueError):
        ServeOptions.from_dict({"archh": "typo"})


def test_serve_options_cli_flags_are_overrides():
    """SUPPRESS-default parser: only explicitly typed flags override the
    --options-in base; everything else survives untouched."""
    ap = argparse.ArgumentParser()
    add_serve_args(ap)
    base = ServeOptions(executor="sim", requests=40, seq=30000, scheduler="continuous")
    ns = ap.parse_args(["--requests", "8", "--router", "rr"])
    opts = options_from_args(ns, base)
    assert opts.requests == 8 and opts.router == "rr"      # overridden
    assert opts.executor == "sim" and opts.seq == 30000    # inherited
    assert opts.scheduler == "continuous"
    # every parser flag is a field, and a parse of nothing is the defaults
    assert options_from_args(ap.parse_args([])) == ServeOptions()


def test_fleet_spec_per_cell_overrides(tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({
        "router": "least-loaded",
        "cells": [{"kv_dtype": "int8"}, {"buckets": [8192]}],
    }))
    router, cells = resolve_fleet(ServeOptions(executor="sim", fleet_spec=str(spec)))
    assert router == "least-loaded"
    assert len(cells) == 2
    assert cells[0].kv_dtype == "int8" and cells[0].buckets is None
    assert cells[1].buckets == (8192,) and cells[1].kv_dtype == "auto"
    router2, cells2 = resolve_fleet(ServeOptions(cells=3, router="rr"))
    assert router2 == "rr" and len(cells2) == 3


def test_serve_fleet_subprocess_smoke(tmp_path):
    """The CLI fleet path end to end: 2 sim cells, jsf router, merged
    multi-cell trace + fleet metrics JSON on disk; --options-out then an
    --options-in replay prints the same fleet line."""
    trace = tmp_path / "fleet_trace.json"
    metrics = tmp_path / "fleet_metrics.json"
    opts = tmp_path / "opts.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve"]
    r = subprocess.run(
        cmd + ["--executor", "sim", "--scheduler", "continuous", "--cells", "2",
               "--router", "jsf", "--requests", "8", "--seq", "30000", "--arrival-rate",
               "6", "--trace-out", str(trace), "--metrics-out", str(metrics),
               "--options-out", str(opts)],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "[fleet jsf x2]" in r.stdout
    assert "trace ->" in r.stdout and "metrics ->" in r.stdout
    m = json.load(open(metrics))
    assert m["completed"] == 8 and m["cells"] == 2
    pids = {str(e["pid"]) for e in json.load(open(trace))["traceEvents"]}
    assert any(p.startswith("cell0/") for p in pids)
    assert any(p.startswith("cell1/") for p in pids)
    again = subprocess.run(cmd + ["--options-in", str(opts)], capture_output=True,
                           text=True, env=env, timeout=600)
    assert again.returncode == 0, again.stdout + again.stderr
    line = lambda out: re.sub(r"in [0-9.]+ s wall", "", next(
        x for x in out.splitlines() if x.startswith("[fleet")))
    assert line(again.stdout) == line(r.stdout)


# ------------------------------------------------- parity with the reference

# engine module -> (its cost model, its fleet)
PACKAGES = {engine: (cm, FleetFabric, FleetRouter),
            ref_engine: (ref_cm, ref_fleet.FleetFabric, ref_fleet.FleetRouter)}


def _fabric(pkg, policy, *, prefix_cache="off"):
    """The hot / cold pair of ``pkg`` (the port's engine module or the
    reference's) behind ``pkg``'s own fleet, from its own config and
    profiles; the cold cell stores int8 pages."""
    cm_mod, fabric, router = PACKAGES[pkg]
    cells = {"fast": _cell(cm_mod.WSC_PAPER, pkg=pkg, trace=True, slo=2.0,
                           prefix_cache=prefix_cache),
             "slow": _cell(_slow(cm_mod), pkg=pkg, kv_dtype="int8", trace=True, slo=2.0,
                           prefix_cache=prefix_cache)}
    return fabric(cells, router(policy))


def _stream(pkg, n, seed, *, shared=False):
    """n requests of 30000 / 8192 / 32768 tokens at 6 req/s; ``shared``:
    tokens with a common 16384-token prefix, and their chunk-hash chains
    (the bucket's 16 chunks of 2048) set before placement, so that the
    router reads each cell's prefix hits."""
    arrivals = (poisson_arrivals if pkg is engine else ref_poisson)(6.0, n, seed=seed)
    hashes = (prefix.chunk_hashes if pkg is engine else ref_prefix.chunk_hashes)
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 1000, 16384)
    out = []
    for i, t in enumerate(arrivals):
        seq = (30000, 8192, 32768)[i % 3]
        req = pkg.Request(rid=i, arrival=float(t), seq_len=seq)
        if shared:
            req.tokens = rng.integers(0, 1000, seq)
            req.tokens[:min(seq, 16384)] = common[:seq]
            req.prefix_hashes = tuple(hashes(req.tokens, [2048] * 16))
        out.append(req)
    return out


def _same_signals(got, want):
    assert (got.name, got.index, got.lease_fits, got.queue_depth, got.draining,
            got.prefix_hit_pages) == (want.name, want.index, want.lease_fits,
                                      want.queue_depth, want.draining,
                                      want.prefix_hit_pages)
    np.testing.assert_allclose([got.eta, got.free_lease_bytes],
                               [want.eta, want.free_lease_bytes], rtol=1e-12, atol=0)


def _same_decisions(got, want):
    assert len(got.router.decisions) == len(want.router.decisions)
    for d, w in zip(got.router.decisions, want.router.decisions):
        assert (d.rid, d.cell, d.policy, d.rejected) == (w.rid, w.cell, w.policy, w.rejected)
        np.testing.assert_allclose(d.eta, w.eta, rtol=1e-12, atol=0)
        assert len(d.signals) == len(w.signals)
        for s, r in zip(d.signals, w.signals):
            _same_signals(s, r)
        if d.policy != "rr":
            scores = [(sc, s.name) for sc, s in placement.score_cells(d.policy, d.signals)]
            want_scores = [(sc, s.name) for sc, s in ref_fleet.score_cells(w.policy, w.signals)]
            assert [n for _, n in scores] == [n for _, n in want_scores]
            for (a, _), (b, _) in zip(scores, want_scores):
                np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                           rtol=1e-12, atol=0)
    assert got.router.rejections == want.router.rejections


def _same_fleet(got, want):
    assert got.placements == want.placements
    assert set(got.cells) == set(want.cells) and set(got.retired) == set(want.retired)
    assert [r.rid for r in got.completed] == [r.rid for r in want.completed]
    np.testing.assert_allclose([r.finish_time for r in got.completed],
                               [r.finish_time for r in want.completed], rtol=1e-12, atol=0)
    _same_decisions(got, want)
    cells = {**got.cells, **got.retired}
    ref_cells = {**want.cells, **want.retired}
    for name, cell in cells.items():
        rows = [(r.rid, r.seq_len, r.bucket, r.rejected) for r in cell.records()]
        assert rows == [(r.rid, r.seq_len, r.bucket, r.rejected)
                        for r in ref_cells[name].records()], name
        np.testing.assert_allclose(
            [(r.arrival, r.admit, r.finish, r.deadline) for r in cell.records()],
            [(r.arrival, r.admit, r.finish, r.deadline) for r in ref_cells[name].records()],
            rtol=1e-12, atol=0)
    m, rm = got.metrics(), want.metrics()
    assert set(m) == set(rm) and m["per_cell"].keys() == rm["per_cell"].keys()
    for key, v in rm.items():
        if key == "per_cell":
            for name, pc in v.items():
                for k, x in pc.items():
                    y = m["per_cell"][name][k]
                    assert (math.isnan(x) and math.isnan(y)) or y == pytest.approx(
                        x, rel=1e-12, abs=0), (name, k)
        elif isinstance(v, float):
            assert (math.isnan(v) and math.isnan(m[key])) or m[key] == pytest.approx(
                v, rel=1e-12, abs=0), key
        else:
            assert m[key] == v, key
    assert got.merged_trace().chrome_trace() == want.merged_trace().chrome_trace()


@pytest.mark.parametrize("policy", ["jsf", "rr", "least-loaded"])
def test_fleet_matches_reference(policy):
    """The same 18-request stream through both fabrics: placements, every
    candidate's signals and scores, request records, metrics and the merged
    trace equal."""
    got, want = _fabric(engine, policy), _fabric(ref_engine, policy)
    for fab, pkg in ((got, engine), (want, ref_engine)):
        for r in _stream(pkg, 18, seed=4):
            fab.submit(r)
        fab.pump()
    _same_fleet(got, want)
    assert got.metrics()["completed"] == 18
    if policy != "jsf":          # jsf sends this stream to the fast cell alone
        assert len(set(got.placements.values())) == 2


def test_fleet_prefix_affinity_drain_and_resize_match_reference():
    """The prefix cache armed in both cells and requests sharing a 16384-
    token prefix (jsf's prefix-affinity signal); the fast cell drained
    after 6 requests, a fresh cell added, 6 more requests: the same
    decisions, records and metrics in both packages."""
    got = _fabric(engine, "jsf", prefix_cache="on")
    want = _fabric(ref_engine, "jsf", prefix_cache="on")
    for fab, pkg in ((got, engine), (want, ref_engine)):
        reqs = _stream(pkg, 12, seed=7, shared=True)
        for r in reqs[:6]:
            fab.submit(r)
        fab.drain_cell("fast")
        fab.add_cell("extra", _cell(PACKAGES[pkg][0].WSC_PAPER, pkg=pkg, trace=True,
                                    slo=2.0, prefix_cache="on"))
        for r in reqs[6:]:
            fab.submit(r)
        fab.pump()
    _same_fleet(got, want)
    assert any(s.prefix_hit_pages > 0 for d in got.router.decisions for s in d.signals)
    assert "fast" not in {d.cell for d in got.router.decisions[6:]}
    assert got.metrics()["completed"] == 12
