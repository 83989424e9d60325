"""Fuzz parity of the port's demod: random channel configurations and signal
statistics (the scenes of tests/test_demod_pallas_fuzz.py) through the JAX
XLA scan, the port's plain ``demod_block`` and the kernel's own per-channel
code built for the host (``demod_block_host``).  Catches branch and gating
faults the curated cases miss: LSA aborts, flap detection, post-filter
closes, mid-block opens, homogeneous populations.  Bars as everywhere in
the port's tests (``torch_port_common``), and the kernel's code equal to the
plain version bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu.ops.demod import demod_block as jax_demod_block
from rtlsdr_airband_tpu.ops.goertzel import STANDARD_TONES
from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
from rtlsdr_airband_tpu.ops.params import init_demod_state as jax_init_demod_state
from rtlsdr_airband_tpu.ops.params import make_channel_params as jax_make_channel_params
from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import demod_block
from torch_port_common import ATOL, CENTER, FS, N, assert_bitwise, assert_close, jax_flat

A, W = 100, 150


def _random_spec_kw(rng, n, wave_rate):
    """Random channels; a lowpass keeps its cutoff below the audio Nyquist
    (bandwidth < wave_rate).  At the Nyquist the Bessel design degenerates
    and its rounding blows up: there the JAX package's own XLA scan and
    Pallas kernel already disagree beyond the audio bar."""
    specs = [
        dict(
            frequency=int(119e6 + rng.integers(0, 2_000_000)),
            modulation=str(rng.choice(["am", "nfm"])),
            ampfactor=float(rng.uniform(0.5, 1.5)),
            bandwidth=float(rng.choice([0.0, 4000.0, 8000.0])),
            notch=float(rng.choice([0.0, 0.0, 1200.0])),
            ctcss=float(rng.choice([0.0, 0.0, rng.choice(STANDARD_TONES)])),
            squelch_threshold_dbfs=(float(rng.uniform(-50, -20)) if rng.random() < 0.3 else None),
            squelch_snr_threshold_db=(float(rng.uniform(5, 15)) if rng.random() < 0.3 else None),
            has_iq_outputs=bool(rng.random() < 0.2),
        )
        for _ in range(n)
    ]
    for k in specs:
        if k["bandwidth"] >= wave_rate:
            k["bandwidth"] = 0.0
    return specs


def _homogeneous_spec_kw(pop, n):
    extra = {"all_plain_am": dict(modulation="am"), "all_nfm": dict(modulation="nfm"),
             "all_am_notch": dict(modulation="am", bandwidth=6000.0, notch=1200.0)}[pop]
    return [dict(frequency=int(119.5e6 + i * 3e5), **extra) for i in range(n)]


def _run(spec_kw, wave_rate, rng, bases, gap_block=None):
    """Blocks of |N(base, 1)| magnitudes through all three, block by block.

    The IQ is a carrier on each channel: magnitude as the mags, phase turning
    at the channel's derotation rate, plus noise, so channels with a lowpass
    see their signal through it and open too."""
    C = len(spec_kw)
    jp = jax_make_channel_params([JaxSpec(**k) for k in spec_kw], wave_rate=wave_rate, sample_rate=FS, center_freq=CENTER, fft_size=N)
    js = jax_init_demod_state(
        C,
        jnp.asarray(np.abs(rng.normal(0, 1.0, (A, C))).astype(np.float32)),
        jnp.asarray(rng.normal(0, 0.5, (A, C, 2)).astype(np.float32)),
    )
    # a settled noise floor and signal average, so strong blocks open the
    # squelches within the run and quiet ones close them again
    d = jax_flat(js)
    d["noise_floor"] = np.full(C, 0.3, np.float32)
    d["pre_full"] = d["pre_capped"] = np.full(C, 1.2, np.float32)
    bank = lambda b: type(js.fast)(**{s: jnp.asarray(d[f"{b}.{s}"]) for s in js.fast._fields})  # noqa: E731
    js = type(js)(**{k: (bank(k) if k in ("fast", "slow") else jnp.asarray(d[k])) for k in js._fields})
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    st = {name: interop.state_from_numpy(d, device="cpu") for name in ("plain", "host")}
    run = {"plain": demod_block, "host": demod_cuda.demod_block_host}
    turn = 2 * np.pi * np.asarray(jp.dm_dphi, np.float64) / 2**24  # radians a sample
    for blk, base in enumerate(bases):
        mags = np.abs(rng.normal(0, 1.0, (W, C)) + base).astype(np.float32)
        if blk == gap_block:  # flappy: drop the signal in short gaps
            mags[::13] *= 0.05
        phase = turn[None, :] * (blk * W + np.arange(W))[:, None]
        iqs = (mags[..., None] * np.stack([np.cos(phase), np.sin(phase)], axis=-1) + rng.normal(0, 0.1, (W, C, 2))).astype(np.float32)
        jst, ja, jiq, jo = jax_demod_block(jp, js, jnp.asarray(mags), jnp.asarray(iqs))
        js = jst
        want = jax_flat(jst)
        outs = {}
        for name, fn in run.items():
            out = outs[name] = fn(tp, st[name], torch.from_numpy(mags), torch.from_numpy(iqs))
            label = f"{name} block {blk}"
            assert np.array_equal(np.asarray(jo), out[3].numpy()), f"{label}: open flags"
            assert np.abs(np.asarray(ja) - out[1].numpy()).max() < ATOL, f"{label}: audio"
            assert np.abs(np.asarray(jiq) - out[2].numpy()).max() < ATOL, f"{label}: iq"
            assert_close(want, interop.state_to_numpy(out[0]), f"{label}: state")
            st[name] = out[0]
        # the kernel's code repeats the plain version's float operations one
        # for one: every output and state leaf equal bit for bit
        assert_bitwise(outs["plain"], outs["host"], f"block {blk}: the plain version against the kernel's code")
    return np.asarray(js.open_count)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_matches_xla_scan(seed):
    rng = np.random.default_rng(seed)
    C = int(rng.integers(2, 7))
    wave_rate = int(rng.choice([8000, 16000]))
    # alternate bursty / quiet / flappy / quiet statistics to hit many FSM paths
    opens = _run(_random_spec_kw(rng, C, wave_rate), wave_rate, rng, bases=[3.0, 0.0, 2.0, 0.05], gap_block=2)
    assert opens.sum() > 0


@pytest.mark.parametrize("pop", ["all_plain_am", "all_nfm", "all_am_notch"])
def test_homogeneous_population_matches_xla_scan(pop):
    """Populations where a whole warp of the kernel skips a branch: the
    skipped paths' state stays as the reference leaves it."""
    opens = _run(_homogeneous_spec_kw(pop, 5), 16000, np.random.default_rng(7), bases=[3.0, 0.05, 2.5])
    assert opens.sum() > 0
