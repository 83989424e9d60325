"""The comparison that decides ``correct``.

An entry hands over ``cases``: blocks that its timed path produced, each with
the raw bytes the block read and, for a sample of channels, what the
program produced (audio, open flags, the per-channel snapshots, the state
after the block and, in the App cell, what the sinks received).
A case either starts from the stream's beginning (``prime`` holds the
priming bytes: the reference works out the initial state itself) or follows
the program from the state the block started from (``state_in``).

The reference (``reference/``) computes the same block for the same channels,
reading the raw bytes in the configuration's ``sample_format`` (``u8``, the
RTL-SDR's; ``s8``, a HackRF's through SoapySDR; ``s16``, a USRP's or a
LimeSDR's; ``f32``) with its ``fullscale`` where it gives one (s16 and f32;
32768 and 1 by default), and ``numbers`` reduces the two to the numbers a cell compares with its
limits.  The control (``control_cases``) puts the reference, computed with a
TF32 channelizer, in the program's place.

The float gaps are 90th percentiles over the sampled channels of all checked
blocks, of each channel's worst reading: ``audio_p90`` (the widest audio
gap), ``state_p90`` (the largest relative error of any float leaf of the
state after the block, and of the level snapshots) and ``sink_p90`` (the
RMS of what a sink received against the reference's i8bf wire format).  Not
the worst channel: the recurrence has steps that a rounding difference can
flip in one channel now and then (the NFM discriminator's wrap at +-pi, the
AM AGC's over-limit step, the Goertzel resonators' long sums), while a
lower precision or a fault moves every channel.  What the configurations
guarantee exactly is counted over every sampled channel: ``exact_channels``,
the channels whose open flags, counters or integer state differ in any
checked block, and ``sink_missing``, the channels a sink was sent audio on
one side only.  The worst float readings are printed as diagnostics.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .reference.channel import Reference, i8bf
from .reference.demod import CtcssState, DemodState

FLOAT_SNAPS = ("signal_level", "noise_level", "squelch_level")
EXACT_SNAPS = ("sig_outside", "open_count", "flappy_count", "ctcss_found", "ctcss_not_found")


def state_leaves(st) -> dict:
    """A DemodState's leaves by name ("fast.q1" for a CTCSS bank's)."""
    out = {}
    for f in st._fields:
        v = getattr(st, f)
        if isinstance(v, tuple):
            out.update({f"{f}.{g}": getattr(v, g) for g in v._fields})
        else:
            out[f] = v
    return out


def take_channels(st, idx) -> dict:
    """The state's leaves for the channels ``idx`` (its own channel order),
    as numpy arrays with the channel last ([rows, S]; iq_tail [A, S, 2])."""
    idx_t = None
    out = {}
    for name, t in state_leaves(st).items():
        if idx_t is None or idx_t.device != t.device:
            idx_t = torch.as_tensor(np.asarray(idx), device=t.device)
        sel = t[:, idx_t] if name == "iq_tail" else t[..., idx_t]
        out[name] = sel.cpu().numpy()
    return out


def to_reference_state(leaves: dict) -> DemodState:
    def leaf(name):
        return torch.from_numpy(np.ascontiguousarray(leaves[name]))

    banks = {b: CtcssState(*(leaf(f"{b}.{g}") for g in CtcssState._fields)) for b in ("fast", "slow")}
    return DemodState(*(banks[f] if f in banks else leaf(f) for f in DemodState._fields))


def reference_case(cfg: dict, case: dict, precision: str = "f64") -> dict:
    """The reference's version of a case: the same keys as the program's."""
    ref = Reference(cfg, case["users"])
    state = ref.prime(case["prime"], precision) if case.get("prime") is not None else to_reference_state(case["state_in"])
    st, audio, flags, snap = ref.block(case["raw"], state, precision)
    out = dict(users=case["users"], audio=audio, open_flags=flags, snap=snap,
               state_out={k: v.numpy() for k, v in state_leaves(st).items()})
    if case.get("delivered") is not None:
        sent = flags.any(axis=0)
        out["delivered"] = dict(sent=sent, audio=i8bf(audio))
    return out


def _rel(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Per channel: the largest |p - r| over a leaf's rows, against the
    larger of the channel's own magnitude and the leaf's median magnitude
    over the channels (a leaf near zero in one channel is measured against
    its typical size)."""
    p = p.reshape(-1, p.shape[-1]).astype(np.float64)
    r = r.reshape(-1, r.shape[-1]).astype(np.float64)
    mag = np.max(np.abs(r), axis=0)
    scale = np.maximum(mag, max(float(np.median(mag)), 1e-30))
    return np.max(np.abs(p - r), axis=0) / scale


def _exact_bad(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    p = p.reshape(-1, p.shape[-1])
    r = r.reshape(-1, r.shape[-1])
    return np.any(p != r, axis=0)


def case_numbers(prog: dict, ref: dict) -> dict:
    """Per channel of one case: audio error, float-state error, exact
    mismatch; and the sinks' numbers."""
    S = len(prog["users"])
    gap = np.abs(prog["audio"].astype(np.float64) - ref["audio"])
    audio_abs = np.max(gap, axis=0)
    t, j = np.unravel_index(np.argmax(gap), gap.shape)
    worst_audio = (float(gap[t, j]), f"channel {int(prog['users'][j])} sample {int(t)}: {float(prog['audio'][t, j])!r} "
                                     f"against {float(ref['audio'][t, j])!r}")
    state_rel = np.zeros(S)
    worst = ("", 0.0, -1)  # the leaf, its error and the user channel of the largest float error
    exact_bad = np.any(prog["open_flags"] != ref["open_flags"], axis=0)
    floats = [(f"snap.{k}", prog["snap"][k][None], ref["snap"][k][None]) for k in FLOAT_SNAPS]
    for k in EXACT_SNAPS:
        exact_bad |= prog["snap"][k] != ref["snap"][k]
    for k, r in ref["state_out"].items():
        p = prog["state_out"][k]
        if k == "iq_tail":
            p, r = np.moveaxis(p, 1, -1), np.moveaxis(r, 1, -1)
        if np.issubdtype(r.dtype, np.floating):
            floats.append((k, p, r))
        else:
            exact_bad |= _exact_bad(p, r)
    for k, p, r in floats:
        e = _rel(p, r)
        state_rel = np.maximum(state_rel, e)
        if e.max() > worst[1]:
            worst = (k, float(e.max()), int(prog["users"][np.argmax(e)]))
    out = dict(audio_abs=audio_abs, state_rel=state_rel, exact_bad=exact_bad, worst=worst, worst_audio=worst_audio)
    if "delivered" in ref:
        # per channel either side sent: the RMS of the difference over the
        # larger RMS of the two (1.0 where only one side sent)
        ps, rs = prog["delivered"]["sent"], ref["delivered"]["sent"]
        p = np.where(ps[None, :], prog["delivered"]["audio"], 0.0).astype(np.float64)[:, ps | rs]
        r = np.where(rs[None, :], ref["delivered"]["audio"], 0.0).astype(np.float64)[:, ps | rs]
        rms = lambda a: np.sqrt(np.mean(a * a, axis=0))  # noqa: E731
        out["sink_rel"] = rms(p - r) / np.maximum(np.maximum(rms(p), rms(r)), 1e-30)
        out["sink_missing"] = int(np.sum(ps != rs))
    return out


def numbers(per_case: list[dict]) -> dict:
    """Every candidate number over all cases (per channel, pooled)."""
    audio = np.concatenate([c["audio_abs"] for c in per_case])
    state = np.concatenate([c["state_rel"] for c in per_case])
    exact = np.concatenate([c["exact_bad"] for c in per_case])
    out = dict(audio_max=float(audio.max()), audio_p90=float(np.percentile(audio, 90)),
               state_max=float(state.max()), state_p90=float(np.percentile(state, 90)),
               exact_channels=float(exact.sum()))
    w = max((c["worst"] for c in per_case), key=lambda t: t[1])
    out["worst_state_leaf"] = f"{w[0]} of channel {w[2]}"
    out["worst_audio"] = max((c["worst_audio"] for c in per_case), key=lambda t: t[0])[1]
    sinks = [c for c in per_case if "sink_rel" in c]
    if sinks:
        rel = np.concatenate([c["sink_rel"] for c in sinks])
        # no sampled channel sent in any case: nothing was delivered to compare
        out["sink_max"] = float(rel.max()) if rel.size else 0.0
        out["sink_p90"] = float(np.percentile(rel, 90)) if rel.size else 0.0
        out["sink_missing"] = float(sum(c["sink_missing"] for c in sinks))
    return out


def all_numbers(cfg: dict, cases: list[dict], against: list[dict] | None = None) -> dict:
    """Every number of the cases against the reference; ``against`` puts
    other outputs (the control's) in the program's place."""
    progs = against if against is not None else cases
    return numbers([case_numbers(p, reference_case(cfg, c)) for p, c in zip(progs, cases)])


def compare_cases(cfg: dict, cases: list[dict], limits: dict, against: list[dict] | None = None) -> dict:
    """The compared numbers, each with its limit; the others are printed as
    diagnostics.  A cell with no case has not been checked: every number
    reads inf."""
    if not cases:
        return {k: {"value": float("inf"), "limit": v} for k, v in limits.items()}
    got = all_numbers(cfg, cases, against)
    extra = sorted(k for k in got if k not in limits)
    if extra:
        print("diagnostics: " + ", ".join(f"{k} = {got[k]!r}" for k in extra), file=sys.stderr)
    return {k: {"value": got.get(k, float("inf")), "limit": v} for k, v in limits.items()}


def control_cases(cfg: dict, cases: list[dict]) -> list[dict]:
    """The control in the program's place: the reference with its
    channelizer in TF32, from the same starts, packed as the program's."""
    return [reference_case(cfg, c, "tf32") for c in cases]
