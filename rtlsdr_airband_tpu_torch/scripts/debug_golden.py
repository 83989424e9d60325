"""Debug driver: the port's demod against the scalar NumPy refmodel, sample
by sample.

Counterpart of the JAX package's ``scripts/debug_golden.py``, with both of
the port's demods: the plain PyTorch version and the kernel K1 (on the card
``demod_block_cuda``; on the CPU the kernel's own code built with g++,
``demod_cuda.demod_block_host``).  Per channel: the largest audio and IQ
differences from the refmodel, the share of samples where one is silent and
the other not, the first large difference; then each channel's final
squelch state beside the refmodel's.

    python -m rtlsdr_airband_tpu_torch.scripts.debug_golden [am|amlp|nfm|ctcss]
    python -m rtlsdr_airband_tpu_torch.scripts.debug_golden --device cpu ctcss

Runs on the card unless ``--device cpu``; without a card it exits non-zero.
The last line is one JSON object: per demod the largest audio and IQ
differences and the gating mismatches.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .common import demod_over_blocks, pick_device

FS = 2_560_000
N = 512
CENTER = 120_000_000

SCENES = {
    "am": (8000, [
        dict(frequency=120_400_000, modulation="am"),
        dict(frequency=120_700_000, modulation="am", ampfactor=1.2),
    ]),
    "amlp": (8000, [
        dict(frequency=120_400_000, modulation="am", bandwidth=6000, notch=1000.0, has_iq_outputs=True),
        dict(frequency=120_700_000, modulation="am", squelch_threshold_dbfs=-40.0),
    ]),
    "nfm": (16000, [
        dict(frequency=120_300_000, modulation="nfm", bandwidth=8000),
        dict(frequency=120_900_000, modulation="nfm"),
    ]),
    "ctcss": (16000, [
        dict(frequency=120_300_000, modulation="nfm", ctcss=100.0),
    ]),
}


def build_scene(wr, specs, dur=1.0, seed=0):
    from ..utils.siggen import SignalGen, am_carrier_iq, complex_noise, nfm_carrier_iq

    n = int(FS * dur)
    iq = complex_noise(n, 0.02, seed=seed)
    for i, s in enumerate(specs):
        gen = SignalGen(wr, seed=seed + i).add_tone(700.0 + 150 * i, 0.5).add_noise(0.02)
        if s.ctcss > 0:
            gen.add_tone(s.ctcss, 0.25)
        audio = gen.render(int(wr * dur))
        # on/off keying: signal present in the middle of the stream
        if s.modulation == "am":
            c = am_carrier_iq(FS, s.frequency - CENTER, n, audio=audio, carrier_ampl=0.35, mod_index=0.8, audio_rate=wr)
        else:
            c = nfm_carrier_iq(FS, s.frequency - CENTER, n, audio=audio, deviation_hz=2500.0, carrier_ampl=0.35, audio_rate=wr)
        gate = np.zeros(n, np.float32)
        gate[int(n * 0.15) : int(n * 0.8)] = 1.0
        iq = iq + c * gate
    return iq.astype(np.complex64)


def run_compare(wr, specs_kw, device, dur=1.0) -> dict:
    from ..constants import AGC_EXTRA
    from ..ops import demod_cuda
    from ..ops.demod import demod_block
    from ..ops.params import ChannelSpec, make_channel_params
    from ..refmodel.channel_ref import ChannelizerRef, ChannelRef, ChannelRefConfig, DeviceRef, bin_for_freq

    specs = [ChannelSpec(**kw) for kw in specs_kw]
    C = len(specs)
    bins = np.array([bin_for_freq(s.frequency, CENTER, FS, N) for s in specs], np.int32)
    mags, iqs = ChannelizerRef(N, FS, wr, bins).push(build_scene(wr, specs, dur))  # [C, G]
    G = mags.shape[1]
    W = wr // 8
    print(f"frames={G} blocks={(G - AGC_EXTRA) // W} C={C} device={device}")

    fields = ChannelRefConfig.__dataclass_fields__
    refchs = [ChannelRef(ChannelRefConfig(**{k: v for k, v in kw.items() if k in fields}), wr, N, FS, CENTER) for kw in specs_kw]
    ref_batches = DeviceRef(refchs, wr).push(mags, iqs)
    ref_audio = np.concatenate([b[0] for b in ref_batches], axis=1)  # [C, n_blocks * W]
    ref_iqout = np.concatenate([b[1] for b in ref_batches], axis=1)

    params = make_channel_params(specs, wave_rate=wr, sample_rate=FS, center_freq=CENTER, fft_size=N, device=device)
    k1 = demod_cuda.demod_block_cuda if torch.device(device).type == "cuda" else demod_cuda.demod_block_host
    summary = {}
    for name, fn in (("plain", demod_block), ("k1", k1)):
        audio, iq_out, state = demod_over_blocks(fn, params, mags, iqs, W, device)
        n = min(ref_audio.shape[1], audio.shape[1])
        worst = {"audio": 0.0, "iq": 0.0, "gate_mismatch": 0}
        for c in range(C):
            ra, da = ref_audio[c, :n], audio[c, :n]
            d = np.abs(ra - da)
            mism = (ra != 0) != (da != 0)
            print(f"{name} ch{c}: max|d|={d.max():.3e} mean|ref|={np.abs(ra).mean():.3e} nonzero_frac "
                  f"ref={np.mean(ra != 0):.3f} {name}={np.mean(da != 0):.3f} gate_mismatch={mism.mean():.4f}")
            if d.max() > 1e-4:
                print(f"   first big diff at {np.argmax(d > 1e-4)}, worst at {np.argmax(d)}: ref={ra[np.argmax(d)]} {name}={da[np.argmax(d)]}")
            diq = np.abs(ref_iqout[c, :n] - iq_out[c, :n])
            print(f"   iq_out max|d|={diq.max():.3e}")
            worst = {"audio": max(worst["audio"], float(d.max())), "iq": max(worst["iq"], float(diq.max())),
                     "gate_mismatch": worst["gate_mismatch"] + int(mism.sum())}
        for c, rch in enumerate(refchs):
            sq = rch.squelch
            print(f"ch{c} ref: cur={sq.current_state} open_count={sq.open_count} nf={sq.noise_floor:.4f} sc={sq.sample_count}")
            print(f"ch{c} {name}: cur={int(state.cur[c])} open_count={int(state.open_count[c])} "
                  f"nf={float(state.noise_floor[c]):.4f} sc={int(state.sample_count[c])}")
        summary[name] = worst
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="am", choices=sorted(SCENES))
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = pick_device(args.device == "cpu", "debug_golden", "--device cpu")
    if device is None:
        return 1
    wr, specs_kw = SCENES[args.scene]
    summary = run_compare(wr, specs_kw, device, args.seconds)
    print(json.dumps({"scene": args.scene, "device": str(device), **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
