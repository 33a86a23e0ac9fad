"""Parameter bridge: the reference's param pytrees, as nested dicts of numpy
arrays, into the port's tensors — a plain key-for-key copy.

The reference's trees arrive through ``np.asarray`` (done by the caller);
this module never imports jax. ml_dtypes arrays (bfloat16, float8_e4m3fn)
are reinterpreted bit for bit through an integer view. The Mamba2 leaves
``a_log``, ``dt_bias`` and ``d_skip`` stay fp32 whatever dtype is asked for,
as the reference keeps them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kvstore.pages import PagedPool
from repro_torch.kvstore.quant import torch_dtype
from repro_torch.models.ssm import FP32_PARAMS

_BITCAST = {"bfloat16": (np.uint16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def tensor_from_numpy(a, device=None, dtype=None) -> torch.Tensor:
    """One numpy array (ml_dtypes included) -> tensor on ``device``."""
    a = np.require(a, requirements=("C", "W"))   # torch wants writable memory
    name = a.dtype.name
    if name in _BITCAST:
        as_int, tdt = _BITCAST[name]
        t = torch.from_numpy(a.view(as_int)).view(tdt)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(torch_dtype(dtype))
    return t.to(device)


def params_from_numpy(tree: Dict[str, Any], device=None,
                      dtype=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of tensors. ``dtype``
    (optional) recasts the floating leaves, except ``FP32_PARAMS``."""
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else tensor_from_numpy(v, device,
                                       None if k in FP32_PARAMS else dtype))
            for k, v in tree.items()}


def staged_from_numpy(tree: Dict[str, Any], device=None,
                      dtype=None) -> Dict[str, Any]:
    """The output of ``repro.core.staging.stage_params`` (``stage_layers``
    leaves [N, lps, ...]) -> the port's staged params."""
    return params_from_numpy(tree, device, dtype)


def train_state_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A reference train state {"params", "opt": {"m", "v", "step"}} of
    numpy leaves -> the port's (``train.step.TrainState``), every dtype
    kept: the params and the fp32 moments through ``params_from_numpy``'s
    key-for-key mapping, ``step`` an int32 scalar."""
    opt = tree["opt"]
    return {"params": params_from_numpy(tree["params"], device),
            "opt": {"m": params_from_numpy(opt["m"], device),
                    "v": params_from_numpy(opt["v"], device),
                    "step": tensor_from_numpy(np.asarray(opt["step"]), device)}}


def cache_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A reference KV cache or decode state (numpy leaves: int32 ``pos``,
    fp32 SSM state, k/v in the model's dtype) -> the same dict of tensors
    on ``device``, every dtype kept. The leaves are copied, never shared
    with ``tree``: the port's ``decode_step`` writes into them in place."""
    return {k: tensor_from_numpy(np.array(v, copy=True), device) for k, v in tree.items()}


def pool_from_numpy(pool: Any, device=None) -> PagedPool:
    """A reference ``PagedPool`` (or a dict with k, v, k_scale, v_scale) of
    numpy arrays -> the port's ``PagedPool`` with the storage dtypes kept."""
    get = (pool.get if isinstance(pool, dict)
           else lambda f: getattr(pool, f, None))

    def one(f) -> Optional[torch.Tensor]:
        a = get(f)
        return None if a is None else tensor_from_numpy(a, device)
    return PagedPool(one("k"), one("v"), one("k_scale"), one("v_scale"))
