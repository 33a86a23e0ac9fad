"""Open loop: prompts of ``prompt_tokens`` tokens due at ``rate`` a second
over the window, sent whether or not earlier ones are done. The due times
are Poisson arrivals, ``round(rate * seconds)`` exponential gaps at
``rate`` (``gen.poisson_arrivals``), drawn from the mix's ``schedule_seed``
and not from the run's seed: one schedule for every run, so that a run's
seed changes the prompts' tokens and the weights but not the offered load.
(On an H100, with a schedule of each seed's own, the seed moved the 90th
percentile by up to 40 %; two runs of one seed differed by at most 6 %.)

The engine runs a wave of up to ``max_batch`` of the oldest waiting
requests whenever any wait; once the last one is due, the queue is drained,
and the window ends with the last wave."""
from __future__ import annotations

from portbench.traffic.gen import poisson_arrivals


def warm(server, mix, max_batch: int) -> None:
    """A wave of one request and a wave of ``max_batch``: the two ends of
    the batches the window can form."""
    for n in (1, max_batch):
        for _ in range(n):
            server.submit(mix["prompt_tokens"], 0.0)
        while server.pending():
            server.step()


def schedule(mix, seconds: float) -> list:
    """The due times, in seconds from the window's start."""
    n = max(1, round(mix["rate"] * seconds))
    return poisson_arrivals(mix["rate"], n, mix["schedule_seed"])


def drive(server, mix, seconds: float) -> int:
    due = schedule(mix, seconds)
    i = 0
    while i < len(due) or server.pending():
        now = server.now()
        while i < len(due) and due[i] <= now:
            server.submit(mix["prompt_tokens"], float(due[i]))
            i += 1
        if server.pending():
            server.step()
        elif i < len(due):
            server.wait_until(float(due[i]))
    return len(due)
