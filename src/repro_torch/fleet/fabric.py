"""Fleet fabric: owns the cells, drives placement, aggregates observability.

The fabric is the mutation side of the fleet split: the router DECIDES
(pure), the fabric ACTS — submit to the chosen cell, pump it so the
scheduler frontier advances (placement signals are only as fresh as the
last ``run_until_drained``), collect completions, retire drained cells.
All cell access goes through the ``CellHandle`` protocol; the fabric never
reaches into a cell's scheduler/lease/executor internals.

Elasticity:
- ``drain_cell(name)`` closes that cell's admission, completes its
  in-flight work and RETIRES it — the handle moves to ``self.retired`` so
  its request records and trace stay in the fleet roll-up, but the router
  never sees it again.
- ``add_cell(name, cell)`` grows the fleet mid-stream (a torch cell is
  one more engine and executor on the same card; sim cells are just more
  engines).
- ``resize(names, factory)`` reconciles toward a target cell set: missing
  names are built by the factory, surplus cells are drained.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from repro_torch.fleet.router import FleetRouter, PlacementDecision
from repro_torch.sched.metrics import fleet_summary


class FleetFabric:

    def __init__(self, cells: Mapping[str, Any],
                 router: Optional[FleetRouter] = None):
        self.cells: Dict[str, Any] = dict(cells)
        self.router = router or FleetRouter()
        self.retired: Dict[str, Any] = {}
        self.completed: List[Any] = []
        self.placements: Dict[int, str] = {}    # rid -> cell name

    # ------------------------------------------------------------ admission
    def submit(self, req: Any, pump: bool = True) -> PlacementDecision:
        """Route one request to a cell and (by default) pump that cell so
        the NEXT placement scores against its post-admission frontier.

        A ``rejected`` decision (every live cell's KV-lease headroom
        exhausted) submits NOTHING — the caller reads ``dec.retry_after``
        and resubmits; the rejection is counted into ``fleet_summary``."""
        dec = self.router.place(
            self.cells, req.rid, req.seq_len, arrival=req.arrival,
            prefix_hashes=getattr(req, "prefix_hashes", None))
        if dec.rejected:
            return dec
        cell = self.cells[dec.cell]
        cell.submit(req)
        self.placements[req.rid] = dec.cell
        if pump:
            cell.run_until_drained()
        return dec

    def pump(self) -> List[Any]:
        """Run every live cell dry and collect newly completed requests."""
        out: List[Any] = []
        for cell in self.cells.values():
            cell.run_until_drained()
            out.extend(cell.poll())
        self.completed.extend(out)
        return out

    # ----------------------------------------------------------- elasticity
    def drain_cell(self, name: str) -> List[Any]:
        """Close ``name``'s admission, finish its in-flight requests, retire
        it from routing. Returns the requests the drain completed."""
        cell = self.cells.pop(name)
        done = cell.drain()
        self.completed.extend(done)
        self.retired[name] = cell
        return done

    def add_cell(self, name: str, cell: Any) -> None:
        if name in self.cells or name in self.retired:
            raise ValueError(f"cell name {name!r} already used")
        self.cells[name] = cell

    def resize(self, names: Sequence[str],
               factory: Callable[[str], Any]) -> None:
        """Reconcile the live cell set toward ``names``: build missing cells
        with ``factory(name)``, drain cells not in the target set."""
        target = list(names)
        for name in [n for n in self.cells if n not in target]:
            self.drain_cell(name)
        for name in target:
            if name not in self.cells and name not in self.retired:
                self.add_cell(name, factory(name))

    def drain_all(self) -> List[Any]:
        out: List[Any] = []
        for name in list(self.cells):
            out.extend(self.drain_cell(name))
        return out

    # -------------------------------------------------------------- metrics
    def _all_cells(self) -> Dict[str, Any]:
        return {**self.cells, **self.retired}

    def metrics(self) -> Dict[str, Any]:
        """Fleet-level SLO/TTFT roll-up over every cell ever part of the
        fleet (live + retired) — ``sched.metrics.fleet_summary`` — plus the
        router's reject-with-retry-after count."""
        return fleet_summary({name: cell.records()
                              for name, cell in self._all_cells().items()},
                             router_rejections=self.router.rejections)

    def configure_obs(self, *, telemetry: Optional[bool] = None,
                      measured: Optional[bool] = None,
                      health: Any = None) -> None:
        for cell in self.cells.values():
            cell.configure_obs(telemetry=telemetry, measured=measured,
                               health=health)

    def recalibrate(self, name: str, hw: Any) -> Any:
        """Swap ONE cell onto a calibrated profile (per-cell calibration is
        the point — heterogeneous fleets quote heterogeneous ETAs)."""
        return self._all_cells()[name].recalibrate(hw)

    # ------------------------------------------------------------ tracing
    def merged_trace(self):
        """ONE Perfetto timeline for the whole fleet: each cell's merged
        trace absorbed under its own ``{name}/`` process namespace
        (``TraceRecorder.absorb``), so ``cell0/stage 3`` and
        ``cell1/engine`` render as separate process rows."""
        from repro_torch.obs.trace import TraceRecorder
        rec = TraceRecorder(enabled=True)
        for name, cell in self._all_cells().items():
            rec.absorb(cell.merged_trace(), pid_prefix=f"{name}/")
        return rec

    def export_obs(self, trace_out: Optional[str] = None,
                   metrics_out: Optional[str] = None) -> Dict[str, str]:
        paths: Dict[str, str] = {}
        if trace_out:
            paths["trace"] = self.merged_trace().export(trace_out)
        if metrics_out:
            from repro_torch.obs._io import atomic_write_text
            import json
            paths["metrics"] = atomic_write_text(
                metrics_out, json.dumps(self.metrics(), default=float,
                                        indent=2))
        return paths
