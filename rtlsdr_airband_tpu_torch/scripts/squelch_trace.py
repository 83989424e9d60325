"""Squelch debug trace -- the analog of the reference's DEBUG_SQUELCH binary
trace and numpy reader (reference: squelch.cpp:520-581).

Counterpart of the JAX package's ``scripts/squelch_trace.py``: an IQ
recording (or a synthetic scene with --synth) goes through one channel of
the port's channelizer and the plain demod in trace mode
(``ops.demod.demod_block(..., trace=True)``; the kernel K1 has no trace
mode), and a .npz gets the per-sample squelch internals: current/next
state, noise floor, capped pre-filter moving average, squelch delay
counter, AGC, and the emitted audio.

    python -m rtlsdr_airband_tpu_torch.scripts.squelch_trace --synth trace.npz
    python -m rtlsdr_airband_tpu_torch.scripts.squelch_trace recording.cu8 --freq 120.4e6 \\
        --center 120.0e6 --rate 2.56e6 --format u8 trace.npz
    python -m rtlsdr_airband_tpu_torch.scripts.squelch_trace --device cpu --synth trace.npz

Runs on the card unless ``--device cpu``; without a card it exits non-zero.
Read it back with:

    d = numpy.load("trace.npz")
    # d["cur"], d["nxt"]  int32 squelch state per audio sample
    #   (0 CLOSED, 1 OPENING, 2 CLOSING, 3 LOW_SIGNAL_ABORT, 4 OPEN)
    # d["noise_floor"], d["pre_capped"], d["agc"] float32
    # d["delay"] int32
    # d["waveout"]  raw loop output, index-aligned with the state series
    # d["audio"]    emitted audio (tail-carried + AM fade-out applied);
    #               audio[j] corresponds to state index j - AGC_EXTRA
    # d["open"]     bool, the channel's open flag per sample (not in the
    #               JAX script's file)

and plot e.g. (matplotlib is optional, as in the JAX script):

    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(3, sharex=True)
    ax[0].plot(d["pre_capped"]); ax[0].plot(d["noise_floor"])
    ax[1].plot(d["cur"]); ax[2].plot(d["waveout"])
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .common import pick_device

N = 512
SERIES = ("cur", "nxt", "noise_floor", "pre_capped", "agc", "delay", "waveout", "audio", "open")


def synth_scene(fs: int, offset_hz: float, seconds: float, wr: int) -> np.ndarray:
    """An AM carrier with an 800 Hz tone, keyed on for the middle 60 %, over
    noise: [n, 2] float32 IQ pairs."""
    from ..utils.siggen import am_carrier_iq, complex_noise

    n = int(fs * seconds)
    z = complex_noise(n, 0.02, 0)
    t = np.arange(int(wr * seconds)) / wr
    audio = (0.5 * np.sin(2 * np.pi * 800.0 * t)).astype(np.float32)
    gate = np.zeros(n, np.float32)
    gate[int(n * 0.2) : int(n * 0.8)] = 1.0
    z = z + gate * am_carrier_iq(fs, offset_hz, n, audio=audio, carrier_ampl=0.35, audio_rate=wr)
    return np.stack([z.real, z.imag], -1).astype(np.float32)


def channelized(x: np.ndarray, *, freq: float, center: float, fs: int, modulation: str, device):
    """(params, state, blocks): one channel's params, the state primed on the
    first AGC_EXTRA frames, and the channelizer's (mags, iqs) of every full
    block of ``x`` after them, on ``device``."""
    from ..constants import AGC_EXTRA
    from ..ops.params import ChannelSpec, init_demod_state, make_channel_params
    from ..ops.window import blackman_harris_7
    from ..refmodel.channel_ref import bin_for_freq
    from ..runtime.pipeline import channelize_block

    wr = 8000 if modulation == "am" else 16000
    hop, W, A = round(fs / wr), wr // 8, AGC_EXTRA
    spec = ChannelSpec(frequency=int(freq), modulation=modulation)
    params = make_channel_params([spec], wave_rate=wr, sample_rate=fs, center_freq=int(center), fft_size=N, device=device)
    bins = torch.as_tensor(np.array([bin_for_freq(int(freq), int(center), fs, N)], np.int32), device=device)
    window = torch.as_tensor(blackman_harris_7(N), device=device)
    x = torch.as_tensor(x, device=device)

    prime_len = (A - 1) * hop + N
    mags0, iqs0 = channelize_block(x[:prime_len], bins, window, hop=hop, fft_size=N, n_frames=A)
    state = init_demod_state(1, mags0, iqs0)
    blocks, pos, block_len = [], A * hop, (W - 1) * hop + N
    while pos + block_len <= len(x):
        blocks.append(channelize_block(x[pos : pos + block_len], bins, window, hop=hop, fft_size=N, n_frames=W))
        pos += W * hop
    return params, state, blocks


def trace(params, state, blocks) -> dict:
    """The traced plain demod over ``blocks`` with the state threaded: every
    series of SERIES, concatenated over the blocks, as numpy arrays."""
    from ..ops.demod import demod_block

    keymap = {"noise_floor": "nf"}
    rows = {k: [] for k in SERIES}
    for mags, iqs in blocks:
        state, audio, _iq, open_now, tr = demod_block(params, state, mags, iqs, trace=True)
        for k in SERIES:
            src = audio if k == "audio" else open_now if k == "open" else tr[keymap.get(k, k)]
            rows[k].append(src[:, 0].cpu().numpy())
    return {k: np.concatenate(v) for k, v in rows.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("input", nargs="?", help="raw IQ recording (omit with --synth)")
    ap.add_argument("out", help="output .npz path")
    ap.add_argument("--synth", action="store_true", help="use a synthetic AM scene instead of a recording")
    ap.add_argument("--freq", type=float, default=120.4e6)
    ap.add_argument("--center", type=float, default=120.0e6)
    ap.add_argument("--rate", type=float, default=2.56e6)
    ap.add_argument("--format", default="u8", choices=["u8", "s8", "s16", "f32"])
    ap.add_argument("--modulation", default="am", choices=["am", "nfm"])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.synth == bool(args.input):
        ap.error("give a recording or --synth, not both")
    device = pick_device(args.device == "cpu", "squelch_trace", "--device cpu")
    if device is None:
        return 1

    fs = int(args.rate)
    if args.synth:
        x = synth_scene(fs, args.freq - args.center, args.seconds, 8000 if args.modulation == "am" else 16000)
    else:
        from ..ops.sampleconv import SampleFormat, decode_iq

        dtype = {"u8": np.uint8, "s8": np.uint8, "s16": np.int16, "f32": np.float32}[args.format]
        raw = np.fromfile(args.input, dtype=dtype)
        x = decode_iq(raw.tobytes() if args.format in ("u8", "s8") else raw, SampleFormat(args.format))

    params, state, blocks = channelized(x, freq=args.freq, center=args.center, fs=fs, modulation=args.modulation, device=device)
    if not blocks:
        print("input too short for one block", file=sys.stderr)
        return 1
    series = trace(params, state, blocks)
    np.savez(args.out, **series)
    print(f"wrote {args.out}: {len(series['cur'])} audio samples x {len(series)} series")
    return 0


if __name__ == "__main__":
    sys.exit(main())
