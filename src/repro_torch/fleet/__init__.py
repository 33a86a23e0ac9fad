"""Multi-cell serving fabric: a fleet router over replicated pipeline cells
(the port's copy of ``repro.fleet``).

One shared arrival stream fans out over N independent serving cells (each a
``runtime.CellHandle`` — canonically a ``ContinuousEngine``), placed by a
router policy:

- ``jsf``  — join-shortest-finish: admit where ``estimate_admission``
  predicts the earliest finish (per-cell LBCP chunk costs, calibrated
  profiles and KV-lease headroom all fold into the quote),
- ``least-loaded`` — smallest ``queue_depth``,
- ``rr``   — round-robin (the baseline the bench gates against).

Cells are heterogeneous (each its own EngineConfig: buckets, kv_dtype,
calibrated profile, pool backend) and dynamic: ``FleetFabric.drain_cell``
closes admission and completes in-flight work; ``resize`` adds/removes
cells mid-stream. On one card the cells share the device and their waves
run one after another. The fabric only ever touches cells through the
``CellHandle`` protocol (source-scan enforced by
``tests/test_torch_fleet.py``).
"""
from repro_torch.fleet.placement import CellSignals, ROUTER_POLICIES, score_cells
from repro_torch.fleet.router import FleetRouter, PlacementDecision
from repro_torch.fleet.fabric import FleetFabric
