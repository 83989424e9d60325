"""Carry channel params and demod state across frameworks as numpy arrays.

Dicts are keyed by the JAX package's field names; the CTCSS banks are
flattened as ``"fast.q1"``, ``"slow.count"`` and so on, as the JAX
``Pipeline.save_state`` checkpoint names them (without its ``"state."``
prefix).  The one dtype that differs is the phase pair ``dm_phi`` /
``dm_dphi``: uint32 in the JAX package, int32 in the port (values < 2^24),
so both directions are lossless.

A tree sharded over a mesh's channel shards (``parallel.sharding.shard_last``)
crosses as the dict of the unsharded tree: ``sharded_to_numpy`` gathers it,
``shard_from_numpy`` scatters one; so a mesh checkpoint, a single-device one
and the JAX package's load into each other.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.demod import ChannelParams, CtcssState, DemodState
from .parallel import sharding

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


def params_to_numpy(params: ChannelParams) -> dict:
    """Dict of numpy arrays with the JAX package's names and dtypes."""
    return {k: (v.detach().cpu().numpy().astype(np.uint32) if k in _PHASE_FIELDS else v.detach().cpu().numpy())
            for k, v in params._asdict().items()}


def sharded_to_numpy(shards: list) -> dict:
    """A channel-sharded DemodState or ChannelParams (one tree a channel
    shard, all in this process) as the flat numpy dict of the unsharded
    tree: each leaf's shards concatenated along its channel axis, in shard
    order; a leaf without a channel dim (the sin/cos LUTs) from the first
    shard."""
    if any(s is None for s in shards):
        raise ValueError("sharded_to_numpy: a shard is held by another process")
    to_np = state_to_numpy if isinstance(shards[0], DemodState) else params_to_numpy
    flat = [to_np(s) for s in shards]
    cb = sharding.infer_channel_dim(shards[0])
    out = {}
    for k, a in flat[0].items():
        ax = sharding.channel_axis(a.shape, cb, k in sharding.PAIR_LEAVES)
        out[k] = a if ax is None else np.concatenate([f[k] for f in flat], axis=ax)
    return out


def shard_from_numpy(d: dict, mesh, kind: str = "state") -> list:
    """The inverse of :func:`sharded_to_numpy`: a flat dict (of either
    framework, sharded or not) as a ``kind`` ('state' or 'params') tree
    sharded over ``mesh``, each shard on its cell."""
    home = mesh.device(mesh.home)
    tree = state_from_numpy(d, device=home) if kind == "state" else params_from_numpy(d, device=home)
    return sharding.shard_last(mesh, tree, channel_dim=(tree.open_count if kind == "state" else tree.is_nfm).shape[0])
