"""End-to-end audio quality: SNR of the port's demodulated audio against
the scalar NumPy refmodel (``refmodel/channel_ref.py``, the sample-exact
transcription of the reference's demod loop).

Counterpart of the JAX package's ``scripts/e2e_snr.py``: the same scene
(four channels: AM, AM with a 6 kHz lowpass and a 1 kHz notch, NFM with an
8 kHz lowpass, NFM with a 100 Hz CTCSS tone; ``SignalGen`` audio, carriers
keyed on after 10 % of the stream, noise), the same ``ChannelizerRef``
outputs fed to both demods (so the number isolates the demod), the same
JSON keys.  The demod is K1 on the card (``--backend cuda``, the default)
or the plain PyTorch version (``--backend plain``).

    python -m rtlsdr_airband_tpu_torch.scripts.e2e_snr [--seconds 1.0] [--backend cuda|plain]
    python -m rtlsdr_airband_tpu_torch.scripts.e2e_snr --device cpu --backend plain --seconds 0.3

Without a card and without ``--device cpu`` it exits non-zero.  Prints ONE
JSON line.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np

from .common import demod_over_blocks, device_fields, pick_device

FS, N, CENTER = 2_560_000, 512, 120_000_000
WAVE_RATE = 16000
SPECS_KW = [
    dict(frequency=120_300_000, modulation="am"),
    dict(frequency=120_500_000, modulation="am", bandwidth=6000, notch=1000.0),
    dict(frequency=120_700_000, modulation="nfm", bandwidth=8000),
    dict(frequency=120_900_000, modulation="nfm", ctcss=100.0),
]


@functools.lru_cache(maxsize=2)
def scene(seconds: float):
    """(mags [C, G], iqs [C, G] complex64, ref_audio [C, n_blocks * W]): the
    reference channelizer's outputs and the refmodel's audio on them.  Kept
    for the last two lengths: the refmodel is a scalar loop.  Read only."""
    from ..constants import AGC_EXTRA
    from ..ops.params import ChannelSpec
    from ..refmodel.channel_ref import ChannelizerRef, ChannelRef, ChannelRefConfig, DeviceRef, bin_for_freq
    from ..utils.siggen import SignalGen, am_carrier_iq, complex_noise, nfm_carrier_iq

    specs = [ChannelSpec(**kw) for kw in SPECS_KW]
    n = int(FS * seconds)
    iq = complex_noise(n, 0.02, seed=0)
    for i, s in enumerate(specs):
        gen = SignalGen(WAVE_RATE, seed=i).add_tone(600.0 + 170 * i, 0.5).add_noise(0.02)
        if s.ctcss > 0:
            gen.add_tone(s.ctcss, 0.25)
        audio = gen.render(int(WAVE_RATE * seconds))
        mk = am_carrier_iq if s.modulation == "am" else nfm_carrier_iq
        kw = dict(audio=audio, carrier_ampl=0.35, audio_rate=WAVE_RATE)
        if s.modulation == "am":
            kw["mod_index"] = 0.8
        else:
            kw["deviation_hz"] = 2500.0
        c = mk(FS, s.frequency - CENTER, n, **kw)
        gate = np.zeros(n, np.float32)
        gate[int(n * 0.1) :] = 1.0
        iq = iq + c * gate

    bins = np.array([bin_for_freq(s.frequency, CENTER, FS, N) for s in specs], np.int32)
    mags, iqs = ChannelizerRef(N, FS, WAVE_RATE, bins).push(iq.astype(np.complex64))
    if (mags.shape[1] - AGC_EXTRA) // (WAVE_RATE // 8) < 1:
        raise ValueError(f"{seconds} s of air is too short for one block")
    fields = ChannelRefConfig.__dataclass_fields__
    refchs = [ChannelRef(ChannelRefConfig(**{k: v for k, v in kw.items() if k in fields}), WAVE_RATE, N, FS, CENTER) for kw in SPECS_KW]
    ref_audio = np.concatenate([b[0] for b in DeviceRef(refchs, WAVE_RATE).push(mags, iqs)], axis=1)
    return mags, iqs, ref_audio


def demod_audio(mags, iqs, backend: str, device) -> np.ndarray:
    """The port's demod over the channelizer outputs, block by block with the
    state threaded: audio [C, n_blocks * W]."""
    from ..ops.demod import demod_block
    from ..ops.demod_cuda import demod_block_cuda
    from ..ops.params import ChannelSpec, make_channel_params

    params = make_channel_params([ChannelSpec(**kw) for kw in SPECS_KW], wave_rate=WAVE_RATE, sample_rate=FS,
                                 center_freq=CENTER, fft_size=N, device=device)
    fn = demod_block_cuda if backend == "cuda" else demod_block
    return demod_over_blocks(fn, params, mags, iqs, WAVE_RATE // 8, device)[0]


def run(seconds: float, backend: str, device) -> tuple[dict, np.ndarray]:
    """(the JSON object, the port's audio [C, n])."""
    mags, iqs, ref_audio = scene(seconds)
    got_audio = demod_audio(mags, iqs, backend, device)
    m = min(ref_audio.shape[1], got_audio.shape[1])
    ref, got = ref_audio[:, :m], got_audio[:, :m]
    snrs = []
    for c in range(len(SPECS_KW)):
        sig = float(np.mean(ref[c].astype(np.float64) ** 2))
        err = float(np.mean((ref[c].astype(np.float64) - got[c]) ** 2))
        snrs.append(float("inf") if err == 0 else 10 * np.log10(max(sig, 1e-30) / err))
    result = {
        "metric": "audio_snr_vs_refmodel",
        "backend": backend,
        "per_channel_snr_db": [s if np.isfinite(s) else "inf" for s in snrs],
        "worst_snr_db": min(snrs) if np.isfinite(min(snrs)) else "inf",
        "squelch_gating_identical": bool(np.array_equal(ref != 0, got != 0)),
        "samples_compared": int(m) * len(SPECS_KW),
        **device_fields(device),
    }
    return result, got_audio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "plain"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = pick_device(args.device == "cpu", "e2e_snr", "--device cpu")
    if device is None:
        return 1
    result, _ = run(args.seconds, args.backend, device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
