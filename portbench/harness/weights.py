"""Weights made from the run's seed, on the device, in the type they are
served in.

A group of leaves (one layer, the embedding, the head) is one ``torch.randn``
call of a generator seeded from (seed, group tag), cut into the leaves and
scaled in place. The program's flat copy and the reference draw the same
groups with the same calls, so the reference can remake any one layer
without the rest: the two never hold the whole model at once.

A spec is a list of ``(name, shape, scale)``: a number is the standard
deviation of a matrix; ``"norm"`` is a norm's weight, ``1 + 0.1 z``, so a
dropped or misplaced norm weight shows in the logits.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence, Tuple, Union

import torch

Spec = Sequence[Tuple[str, Tuple[int, ...], Union[float, str]]]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed for (run seed, tag): any whole number works,
    however large, and different tags draw unrelated streams."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    dev = torch.device(device)
    return torch.Generator(device=dev).manual_seed(sub_seed(seed, tag))


def draw(spec: Spec, seed: int, tag: str, device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The leaves of ``spec`` as views of one buffer of ``dtype`` on
    ``device``: one generator call for the whole group."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    buf = torch.randn(sum(sizes), generator=generator(seed, tag, device),
                      device=device, dtype=dtype)
    out, off = {}, 0
    for (name, shape, scale), n in zip(spec, sizes):
        v = buf[off:off + n].view(shape)
        off += n
        if scale == "norm":
            v.mul_(0.1).add_(1.0)
        else:
            v.mul_(float(scale))
        out[name] = v
    return out
