"""The client side of the program's serving loop: requests made from the
seed, submitted to ``PrefillEngine``, one ``step()`` (one wave) at a time,
every time on the host clock from the window's start.

A request's logits are on the host when ``step()`` returns:
``TorchExecutor.run`` ends in a synchronize and copies them to numpy. In a
traced run each ``step()`` and each wait for an arrival is a
``record_function`` range of its own (``portbench.step``,
``portbench.wait``), so the trace can say what the host did while the
device idled.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.traffic.gen import TokenStream


@dataclass
class Served:
    rid: int
    seq: int
    due: float                      # s from the window's start
    start: float = math.nan         # when the step that ran it began
    done: float = math.nan          # when its logits were on the host
    result: Optional[np.ndarray] = None


class Server:
    def __init__(self, engine, vocab: int, seed: int):
        from repro_torch.runtime.engine import Request
        self._request = Request
        self.engine = engine
        self.tokens = TokenStream(seed, vocab)
        self.prompts: Dict[int, np.ndarray] = {}
        self.served: Dict[int, Served] = {}
        self.steps: List[tuple] = []
        self.t0 = time.perf_counter()

    def open_window(self) -> None:
        """Starts the window's clock and forgets what set-up served."""
        self.served.clear()
        self.prompts.clear()
        self.steps.clear()
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def submit(self, seq: int, due: float) -> Served:
        rid = len(self.prompts)
        toks = self.tokens.next(seq)
        self.prompts[rid] = toks
        self.engine.submit(self._request(rid=rid, arrival=float(due), seq_len=seq,
                                         tokens=toks))
        s = self.served[rid] = Served(rid, seq, float(due))
        return s

    def pending(self) -> bool:
        return any(r.state == "queued" for r in self.engine.queue)

    def step(self) -> List[Served]:
        """One ``PrefillEngine.step()``; returns the requests it completed."""
        t = self.now()
        with torch.profiler.record_function("portbench.step"):
            self.engine.step()
            done = self.engine.poll()
        t1 = self.now()
        self.steps.append((t, t1))
        out = []
        for r in done:
            s = self.served[r.rid]
            s.start, s.done, s.result = t, t1, r.result
            out.append(s)
        return out

    def wait_until(self, due: float) -> None:
        with torch.profiler.record_function("portbench.wait"):
            while True:
                left = due - self.now()
                if left <= 0:
                    return
                time.sleep(min(left, 0.05))

    def completed(self) -> List[Served]:
        return [s for s in self.served.values() if s.result is not None]
