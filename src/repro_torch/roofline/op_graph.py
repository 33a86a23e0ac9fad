"""Eager op-graph cost counter, the counterpart of ``repro.roofline.hlo_graph``.

``hlo_graph`` parses the optimized HLO of a compiled step into a call graph
and costs it (dot FLOPs, HBM bytes, collective wire bytes), rolled up
through ``while`` ops by their trip counts. The port has no compiled graph:
its step is eager PyTorch. ``count`` runs the step once on meta tensors
under a ``TorchDispatchMode`` and costs every aten op the step dispatches,
after autograd and after composite ops have decomposed (einsum and linear
reach the products below). The costing rules, restated for eager PyTorch:

- products: ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` cost 2 * out *
  contracted (batch dims included), as ``hlo_graph``'s ``dot``. Nothing
  else costs FLOPs, but a hand-written kernel's charge
  (``analysis.kernel_work``, charged by its wrapper's meta branch).
- ``bytes_`` (eager; ``hlo_graph``'s as-compiled bytes): operands plus
  outputs of every op that materialises its output. Views and metadata ops
  cost 0: an op whose outputs all alias an input's storage (``view``,
  ``expand``, ``permute``, ``transpose``, ``slice``, ``select``,
  ``as_strided``, ``unsqueeze``, ``squeeze``, ``alias``, ``detach``...) and
  ``empty*``. Gathers and index reads count only what they emit (2 *
  out). An in-place update into an existing buffer (``copy_``,
  ``index_copy_``, ``index_put_``, ``scatter_``...) counts twice the update.
  An operand counts at most its storage's bytes (an expanded view is read
  once).
- ``stream_bytes`` (least traffic; ``hlo_graph``'s ``stream_bytes`` under
  perfect producer-consumer fusion): each op's reads of persistent tensors,
  the in-place updates twice, the step's outputs once and the kernels'
  charges; intermediates cost nothing. Persistent are the tensors named by
  ``persistent`` (params, caches, inputs) and every buffer the step updates
  in place (its KV pools: ``hlo_graph``'s loop carries); a gather from one
  reads what it emits.
- no trip-count scaling: eager Python runs every iteration, so each tick
  and each layer is counted as it runs.
- ``peak_live_bytes``: the largest sum of the ``nbytes`` of live storages
  at an op's outputs, the arguments included (the counterpart of
  ``memory_analysis``' argument + temp + output). Storages are tracked by
  ``StorageWeakRef``, as ``fake_tensor`` tracks them.
- ``by_op``: calls, FLOPs and eager bytes per aten op, and per kernel tag
  (``kernel:<tag>``).
- collectives: none on one card (``analysis``'s docstring).

Host values: the kernels' masks, page handles and lengths come from host
numpy tables (``torch.as_tensor(..., device=...)``). On meta their values
would be lost, so the counter records the data of a meta tensor made from
host data (``_to_copy`` of a CPU tensor; a factory such as ``full`` or
``arange`` with a fill value) by the tensor's identity, and replays small
ops on such tensors on their host copies. A kernel's charge reads them
through ``host_value``; one whose mask or lengths have none makes ``count``
raise: it never charges the most the kernel could do.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils.weak import WeakIdKeyDictionary

aten = torch.ops.aten

_PRODUCTS = {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1}  # -> lhs arg
_GATHERS = {aten.index, aten.gather, aten.index_select, aten.embedding, aten.take}
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}
# in-place updates into a buffer: packet -> the argument whose size is the
# update ("self": the written view itself; "index": one element an index)
_UPDATES = {aten.copy_: "self", aten.index_copy_: 3, aten.index_add_: 3,
            aten.index_put_: 2, aten.masked_scatter_: 2, aten.scatter_: "index",
            aten.scatter_add_: "index", aten.scatter_reduce_: "index"}
_HOST_MAX = 1 << 16        # elements: larger outputs are never replayed on the host
# ops whose outputs hold no values to replay (allocations, random draws)
_NO_VALUES = ("empty", "rand", "normal", "bernoulli", "multinomial", "uniform",
              "exponential", "geometric", "cauchy")


@dataclass
class GraphCost:
    flops: float = 0.0
    bytes_: float = 0.0
    stream_bytes: float = 0.0
    peak_live_bytes: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    kernel_flops: float = 0.0
    launches: Dict[str, int] = field(default_factory=dict)
    by_op: Dict[str, Dict[str, float]] = field(default_factory=dict)
    result: Any = None

    @property
    def product_flops(self) -> float:
        """The products' FLOPs outside the hand-written kernels."""
        return self.flops - self.kernel_flops

    def add(self, name: str, flops: float, nbytes: float) -> None:
        row = self.by_op.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops += flops
        self.bytes_ += nbytes

    def top(self, n: int = 12) -> List[tuple]:
        """The ``n`` rows of ``by_op`` with the most eager bytes."""
        return sorted(self.by_op.items(), key=lambda kv: -kv[1]["bytes"])[:n]


_ACTIVE = threading.local()    # .stack: this thread's counters, innermost last


def _stack() -> List["OpCounter"]:
    if not hasattr(_ACTIVE, "stack"):
        _ACTIVE.stack = []
    return _ACTIVE.stack


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of lists, tuples and dicts, in order (the
    counter's hot path: ``pytree`` costs it a third of its time)."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _key(t: torch.Tensor) -> StorageWeakRef:
    return StorageWeakRef(t.untyped_storage())


def _view_bytes(t: torch.Tensor) -> float:
    """Bytes an op reads of an operand: its elements, at most its storage."""
    return float(min(t.numel() * t.element_size(), t.untyped_storage().nbytes()))


_WRITES: Dict[Any, tuple] = {}     # op overload -> its written arguments


def _written(func, args, kwargs) -> tuple:
    """(tensors the op writes in place, names of its kwarg-only outputs)."""
    spec = _WRITES.get(func)
    if spec is None:
        spec = _WRITES[func] = tuple(
            (i, a.name, a.kwarg_only) for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
    written, outs = [], set()
    for i, name, kwarg_only in spec:
        val = kwargs.get(name) if kwarg_only or i >= len(args) else args[i]
        if kwarg_only:
            outs.add(name)
        written += _tensors(val)
    return written, outs


def _update_bytes(packet, args, written) -> float:
    which = _UPDATES[packet]
    if which == "self":
        return float(sum(t.numel() * t.element_size() for t in written))
    es = written[0].element_size()
    src = args[2] if which == "index" else args[which]
    return float(es * (src.numel() if isinstance(src, torch.Tensor) else 1))


class OpCounter(TorchDispatchMode):
    """The dispatch mode behind ``count``: costs each aten op into
    ``self.cost``, tracks live storages and host values."""

    def __init__(self, persistent=(), args=()):
        super().__init__()
        self.cost = GraphCost()
        self.host = WeakIdKeyDictionary()
        self.persistent = {_key(t) for t in _tensors(persistent)}
        self.live: Dict[StorageWeakRef, float] = {}   # storages born in the call
        self.args: Dict[StorageWeakRef, float] = {}   # the call's arguments
        for t in _tensors(args):
            self.args.setdefault(_key(t), float(t.untyped_storage().nbytes()))
        self.cur = self.cost.argument_bytes = sum(self.args.values())
        self.cost.peak_live_bytes = self.cur

    # ------------------------------------------------------------ storages
    def _sweep(self) -> None:
        for k in [k for k in self.live if k.expired()]:
            self.cur -= self.live.pop(k)
            self.persistent.discard(k)

    def _born(self, outs) -> None:
        """Adds the new storages among ``outs``: the live sum can only rise
        here, so the frees since the last birth are swept first."""
        new = [(k, t) for k, t in ((_key(t), t) for t in outs)
               if k not in self.live and k not in self.args]
        if not new:
            return
        self._sweep()
        for k, t in new:
            self.live[k] = float(t.untyped_storage().nbytes())
            self.cur += self.live[k]
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes, self.cur)

    # ---------------------------------------------------------- host values
    def host_value(self, t: torch.Tensor) -> Optional[torch.Tensor]:
        if t.device.type != "meta":
            return t
        return self.host.get(t)

    def _replay(self, func, args, kwargs, outs, written) -> None:
        """Records the host values of ``outs`` where the op's data is known."""
        name = func.overloadpacket.__name__
        if any(p in name for p in _NO_VALUES) or \
                sum(t.numel() for t in outs) > _HOST_MAX:
            for t in written:
                self.host.pop(t, None)
            return
        ins = _tensors((args, kwargs))
        if func.overloadpacket is aten._to_copy and ins[0].device.type == "cpu":
            self.host[outs[0]] = ins[0].to(outs[0].dtype)
            return
        known = {id(t): self.host_value(t) for t in ins}
        if any(v is None for v in known.values()):
            if func.overloadpacket is aten.copy_ and known.get(id(args[1])) is not None:
                self.host[args[0]] = known[id(args[1])].to(args[0].dtype).expand(
                    args[0].shape).clone()
                return
            for t in written:
                self.host.pop(t, None)
            return

        def to_host(x):
            if isinstance(x, torch.Tensor):
                return known[id(x)]
            return torch.device("cpu") if isinstance(x, torch.device) else x

        h_args, h_kwargs = pytree.tree_map(to_host, (args, kwargs))
        if "device" in h_kwargs:
            h_kwargs["device"] = torch.device("cpu")
        try:
            h_out = func(*h_args, **h_kwargs)
        except (RuntimeError, TypeError, ValueError, IndexError):
            return
        for t, h in zip(outs, _tensors(h_out)):
            self.host[t] = h

    # --------------------------------------------------------------- costs
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        outs = [t for t in _tensors(out) if t.device.type == "meta"]
        written, out_names = _written(func, args, kwargs)
        operands = [t for t in _tensors((args, {k: v for k, v in kwargs.items()
                                                if k not in out_names}))
                    if t.device.type == "meta"]
        in_keys = {_key(t) for t in operands + written}
        flops = nbytes = stream = 0.0
        if packet in _ALLOCS or not outs and not written:
            pass
        elif not written and all(_key(t) in in_keys for t in outs):
            pass                                  # a view: metadata only
        elif packet in _UPDATES:
            upd = _update_bytes(packet, args, written)
            nbytes = stream = 2.0 * upd
            self.persistent.update(_key(t) for t in written)
        elif packet in _GATHERS:
            emitted = sum(float(t.numel() * t.element_size()) for t in outs)
            nbytes = 2.0 * emitted
            if _key(args[0]) in self.persistent:
                stream = emitted
        else:
            nbytes = (sum(_view_bytes(t) for t in operands)
                      + sum(float(t.numel() * t.element_size()) for t in outs))
            stream = sum(_view_bytes(t) for t in operands if _key(t) in self.persistent)
            stream += sum(float(t.numel() * t.element_size()) for t in written
                          if _key(t) in self.persistent)
            if packet in _PRODUCTS:
                lhs = args[_PRODUCTS[packet]]
                flops = 2.0 * outs[0].numel() * lhs.shape[-1]
        self.cost.add(f"aten.{packet.__name__}", flops, nbytes)
        self.cost.stream_bytes += stream
        if outs:
            self._born(outs)
        if outs or written:
            self._replay(func, args, kwargs, outs or written, written)
        return out

    def charge(self, tag: str, flops: float, nbytes: float) -> None:
        self.cost.add(f"kernel:{tag}", flops, nbytes)
        self.cost.kernel_flops += flops
        self.cost.stream_bytes += nbytes
        self.cost.launches[tag] = self.cost.launches.get(tag, 0) + 1


def active() -> Optional[OpCounter]:
    """The innermost counter of a ``count`` under way on this thread, or
    None (a dispatch mode is a thread's own, and so is its counter)."""
    stack = _stack()
    return stack[-1] if stack else None


def host_value(t: torch.Tensor) -> Optional[torch.Tensor]:
    """The values of ``t`` on the host: ``t`` itself off meta; on meta the
    data the active counter recorded for it, or None."""
    if t.device.type != "meta":
        return t
    c = active()
    return None if c is None else c.host_value(t)


def count(fn, *args, persistent=None, **kwargs) -> GraphCost:
    """Runs ``fn(*args, **kwargs)`` once under an ``OpCounter`` and returns
    its ``GraphCost`` (``result`` holds ``fn``'s return). The arguments
    should be meta tensors; ``persistent`` (a pytree of tensors; default
    every tensor of ``args`` and ``kwargs``) are the tensors whose reads
    count as least traffic. The arguments are live throughout."""
    persistent = (args, kwargs) if persistent is None else persistent
    counter = OpCounter(persistent, (args, kwargs))
    _stack().append(counter)
    try:
        with counter:
            result = fn(*args, **kwargs)
    finally:
        _stack().remove(counter)
    cost = counter.cost
    cost.output_bytes = sum(float(t.numel() * t.element_size()) for t in _tensors(result)
                            if _key(t) not in counter.persistent)
    cost.stream_bytes += cost.output_bytes
    cost.result = result
    return cost
