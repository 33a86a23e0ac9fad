"""Atomic, verified checkpoints of nested dicts of tensors (mirrors
``repro.runtime.checkpoint``, whose on-disk layout it keeps file for
file).

Layout:  <dir>/step_<N>/
           manifest.json    tree structure, shapes, dtypes, sha256 per leaf
           <leaf-key>.npy   one file per leaf (copied to the host)

- ATOMIC: written to ``step_<N>.tmp`` then ``os.replace``d — a crash mid-save
  never corrupts the latest checkpoint (restart resumes from the previous one).
- Integrity: sha256 per leaf, verified on load.
- bfloat16 and float8_e4m3fn, which numpy lacks, are stored as their raw
  bits (uint16 / uint8) under the manifest's dtype string and rebuilt with
  torch ``view``s, so each package restores the other's checkpoints.

``restore_checkpoint(device=)`` takes the place of the reference's
``shardings=``: one card has no mesh to re-shard onto.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import device as device_mod

SEP = "/"

# torch dtypes numpy lacks -> (an integer view of their bits: in torch, in
# numpy; the numpy type stored, the reference's)
_BITS = {torch.bfloat16: (torch.int16, np.int16, np.uint16),
         torch.float8_e4m3fn: (torch.uint8, np.uint8, np.uint8)}
_BY_NAME = {str(t).removeprefix("torch."): t for t in _BITS}


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any], structure: Any) -> Any:
    if isinstance(structure, dict):
        if "__leaf__" in structure:
            return flat[structure["__leaf__"]]
        return {k: _unflatten(flat, v) for k, v in structure.items()}
    raise ValueError(f"bad manifest node: {structure}")


def _structure_of(tree: Any, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _structure_of(tree[k], f"{prefix}{k}{SEP}") for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): _structure_of(v, f"{prefix}{i}{SEP}")
                for i, v in enumerate(tree)}
    return {"__leaf__": prefix[:-1]}


def _to_numpy(leaf: Any):
    """(host array to store, logical dtype string) of one leaf."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf)
        return arr, str(arr.dtype)
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _BITS:
        as_int, _, stored = _BITS[t.dtype]
        return t.view(as_int).numpy().view(stored), str(t.dtype).removeprefix("torch.")
    arr = t.numpy()
    return arr, str(arr.dtype)


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Copy every leaf to the host and write atomically. Returns the final
    path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten(tree)
    manifest: Dict[str, Any] = {
        "step": step,
        "structure": _structure_of(tree),
        "leaves": {},
        "extra": extra or {},
    }
    for key, leaf in flat.items():
        arr, logical_dtype = _to_numpy(leaf)
        fname = key.replace(SEP, "__") + ".npy"
        path = os.path.join(tmp, fname)
        np.save(path, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": logical_dtype,
            "sha256": _sha256(path),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None, *,
                       device=None, verify: bool = True):
    """Load (tree, extra): every leaf a tensor on ``device`` (the card
    unless the caller asks for the CPU) in its saved dtype. ``verify``
    checks each file's sha256 against the manifest and raises ``IOError``
    on a mismatch."""
    dev = device_mod.resolve(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for key, meta in manifest["leaves"].items():
        fpath = os.path.join(path, meta["file"])
        if verify and _sha256(fpath) != meta["sha256"]:
            raise IOError(f"checksum mismatch for {key} in {path}")
        arr = np.load(fpath)
        want = meta["dtype"]
        if want in _BY_NAME:                 # raw bits of a dtype numpy lacks
            tdt = _BY_NAME[want]
            t = torch.from_numpy(arr.view(_BITS[tdt][1])).view(tdt)
        else:
            if str(arr.dtype) != want:
                raise IOError(f"{key}: stored {arr.dtype}, manifest says {want}")
            t = torch.from_numpy(arr)
        flat[key] = t.to(dev)
    tree = _unflatten(flat, manifest["structure"])
    return tree, manifest.get("extra", {})
