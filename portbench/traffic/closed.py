"""Closed loop: ``clients`` callers, each sending its next prompt of
``prompt_tokens`` tokens as soon as the logits of its last one are on the
host. Every wave is a full batch when ``clients`` is the engine's
``max_batch``."""
from __future__ import annotations


def warm(server, mix, max_batch: int) -> None:
    """One wave at the window's shapes."""
    for _ in range(mix["clients"]):
        server.submit(mix["prompt_tokens"], 0.0)
    while server.pending():
        server.step()


def drive(server, mix, seconds: float) -> int:
    """Runs whole waves until ``seconds`` have passed; the window ends with
    the last wave. Returns the number of requests sent."""
    sent = 0
    for _ in range(mix["clients"]):
        server.submit(mix["prompt_tokens"], 0.0)
        sent += 1
    while True:
        done = server.step()
        if server.now() >= seconds:
            return sent
        for s in done:
            server.submit(mix["prompt_tokens"], s.done)
            sent += 1
