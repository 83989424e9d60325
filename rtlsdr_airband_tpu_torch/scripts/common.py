"""What the port's driver scripts share: the device a driver runs on, the
card's name and power limit beside every number, and the file-descriptor
limit an App with a socket a channel needs.

A driver runs on the card.  It runs on the CPU (the plain PyTorch versions;
its numbers are then no device metric) only when the caller asks for it by
the script's own switch; without a card and without that request it says
why on stderr and exits non-zero.  Nothing falls back.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def pick_device(on_cpu: bool, driver: str, cpu_switch: str) -> torch.device | None:
    """``cpu`` when the caller asked for it, else ``cuda:0``; None, with the
    reason on stderr, when there is no card and the CPU was not asked for."""
    if on_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print(f"{driver}: no CUDA device; {cpu_switch} runs the plain versions on the CPU", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def require_card(driver: str, why: str) -> torch.device | None:
    """``cuda:0`` for a driver that has no CPU mode; None, with the reason
    on stderr, without a card."""
    if not torch.cuda.is_available():
        print(f"{driver}: no CUDA device; {why}", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def same_outputs(a, b) -> bool:
    """Two demod returns (state, audio, iq, flags) equal bit for bit in every
    output and state leaf (floats compared as their bits)."""
    from ..interop import state_to_numpy

    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x  # noqa: E731
    if not all(torch.equal(bits(x), bits(y)) for x, y in zip(a[1:], b[1:])):
        return False
    sa, sb = state_to_numpy(a[0]), state_to_numpy(b[0])
    return sa.keys() == sb.keys() and all(sa[k].tobytes() == sb[k].tobytes() for k in sa)


def device_fields(device) -> dict:
    """``device`` (the card's name, or "cpu") and ``power_limit`` (the
    card's, from nvidia-smi; None on the CPU) for a driver's JSON line."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    name, _, limit = card_line().partition(",")
    return {"device": name.strip(), "power_limit": limit.strip()}


def raise_fd_limit(need: int) -> None:
    """Soft RLIMIT_NOFILE up to the hard limit; raises if even that is short
    of ``need`` (the App opens one UDP socket a channel)."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if hard != resource.RLIM_INFINITY and hard < need:
        raise RuntimeError(f"RLIMIT_NOFILE hard limit {hard} < {need} (one UDP socket a channel + 256)")
    if soft != resource.RLIM_INFINITY and soft < need:
        resource.setrlimit(resource.RLIMIT_NOFILE, (need if hard == resource.RLIM_INFINITY else hard, hard))


def demod_over_blocks(fn, params, mags: np.ndarray, iqs: np.ndarray, W: int, device):
    """A demod ``fn`` (``demod_block`` or a K1 wrapper) over the blocks of a
    channelizer's outputs (mags, iqs complex: [C, G], the refmodel
    channelizer's layout): the state primed on the first AGC_EXTRA frames,
    then W-sample blocks with the state threaded.  Returns (audio [C, n],
    iq_out [C, n] complex, the final state)."""
    from ..constants import AGC_EXTRA as A
    from ..ops.params import init_demod_state

    def pairs(z):  # [C, n] complex -> [n, C, 2] float32 pairs on the device
        return torch.as_tensor(np.ascontiguousarray(np.stack([z.real.T, z.imag.T], -1), np.float32), device=device)

    def col(a):
        return torch.as_tensor(np.ascontiguousarray(a.T), device=device)

    C, G = mags.shape
    state = init_demod_state(C, col(mags[:, :A]), pairs(iqs[:, :A]))
    audio, iq_out = [], []
    for k in range((G - A) // W):
        lo = A + k * W
        state, a, q, _open = fn(params, state, col(mags[:, lo : lo + W]), pairs(iqs[:, lo : lo + W]))
        audio.append(a.cpu().numpy().T)
        q = q.cpu().numpy()
        iq_out.append((q[..., 0] + 1j * q[..., 1]).T)
    return np.concatenate(audio, axis=1), np.concatenate(iq_out, axis=1), state
