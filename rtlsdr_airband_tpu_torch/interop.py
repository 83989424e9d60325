"""Carry channel params and demod state across frameworks as numpy arrays.

Dicts are keyed by the JAX package's field names; the CTCSS banks are
flattened as ``"fast.q1"``, ``"slow.count"`` and so on, as the JAX
``Pipeline.save_state`` checkpoint names them (without its ``"state."``
prefix).  The one dtype that differs is the phase pair ``dm_phi`` /
``dm_dphi``: uint32 in the JAX package, int32 in the port (values < 2^24),
so both directions are lossless.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.demod import ChannelParams, CtcssState, DemodState

_PHASE_FIELDS = ("dm_phi", "dm_dphi")


def _to_port(name: str, a, device) -> torch.Tensor:
    a = np.asarray(a)
    if name in _PHASE_FIELDS:
        a = a.astype(np.int32)
    return torch.as_tensor(np.array(a, copy=True), device=device)


def params_from_numpy(d: dict, device="cuda") -> ChannelParams:
    """ChannelParams from a dict of numpy arrays keyed by field name."""
    return ChannelParams(**{k: _to_port(k, d[k], device) for k in ChannelParams._fields})


def state_from_numpy(d: dict, device="cuda") -> DemodState:
    """DemodState from a flat dict of numpy arrays (see module docstring)."""
    kw = {}
    for k in DemodState._fields:
        if k in ("fast", "slow"):
            kw[k] = CtcssState(**{s: _to_port(s, d[f"{k}.{s}"], device) for s in CtcssState._fields})
        else:
            kw[k] = _to_port(k, d[k], device)
    return DemodState(**kw)


def state_to_numpy(state: DemodState) -> dict:
    """Flat dict of numpy arrays with the JAX package's names and dtypes."""
    out = {}
    for k in DemodState._fields:
        v = getattr(state, k)
        if k in ("fast", "slow"):
            for s in CtcssState._fields:
                out[f"{k}.{s}"] = getattr(v, s).detach().cpu().numpy()
        else:
            a = v.detach().cpu().numpy()
            out[k] = a.astype(np.uint32) if k in _PHASE_FIELDS else a
    return out
