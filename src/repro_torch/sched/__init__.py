"""Continuous chunk-level scheduling: cross-request pipelining subsystem.

``ChunkScheduler`` keeps the chunked pipeline bubble-free across request
boundaries; ``KVLeaseManager`` guards the MBKR slot budget under concurrent
in-flight requests; ``SchedMetrics``/``TraceRecorder`` provide TTFT/SLO
accounting and Chrome-format JSON traces (the port's own copy of
``repro.sched``).
"""
from repro_torch.sched.kvlease import (KVLeaseManager, Lease, LeaseEvent,
                                       chunk_page_bytes, request_lease_events,
                                       slot_budget_bytes)
from repro_torch.sched.metrics import RequestRecord, SchedMetrics, fleet_summary
from repro_torch.sched.scheduler import (POLICIES, ChunkPlan, ChunkScheduler,
                                         SchedRequest, poisson_arrivals)
from repro_torch.sched.trace import TraceRecorder
