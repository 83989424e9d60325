"""Port parity: the demod recurrence of ``rtlsdr_airband_tpu_torch``.

The plain PyTorch ``demod_block``, the kernel launcher ``demod_block_cuda``
on CPU tensors (which takes the plain version) and ``demod_block_host`` (the
kernel's own code, csrc/demod_step.cuh and csrc/demod_tiles.cuh, built for
the host with g++ and run in the kernel's shared-memory layout) are held
against the JAX package's XLA scan ``demod_block`` and its Pallas kernel in
interpret mode, on the same inputs fed to both frameworks through
``interop``.  tests/test_torch_demod_tiled.py holds that layout at the
ragged edges.  Bars as in tests/test_demod_pallas.py: audio and IQ within
1e-4 absolute, open flags and int/bool state exact, float state within
1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu.ops.demod import apply_fade_and_tail as jax_apply_fade_and_tail
from rtlsdr_airband_tpu.ops.demod import demod_block as jax_demod_block
from rtlsdr_airband_tpu.ops.demod_pallas import demod_block_pallas
from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
from rtlsdr_airband_tpu.ops.params import init_demod_state as jax_init_demod_state
from rtlsdr_airband_tpu.ops.params import make_channel_params as jax_make_channel_params
from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import CLOSED, CLOSING, LSA, OPEN, OPENING, _set_state_valid, apply_fade_and_tail, demod_block

from torch_port_common import ATOL, BANK_ACCUMULATORS, CENTER, FS, N, SPEC_KW, assert_bitwise, assert_close, jax_flat

A = 100


def _assert_state_close(jax_state, port_state, label):
    want, got = jax_flat(jax_state), interop.state_to_numpy(port_state)
    assert want.keys() == got.keys(), label
    assert_close(want, got, f"{label}: state")


def _assert_block_close(jax_out, port_out, label):
    _, ja, jiq, jo = jax_out
    _, ta, tiq, to = port_out
    assert np.abs(np.asarray(ja) - ta.numpy()).max() < ATOL, label
    assert np.abs(np.asarray(jiq) - tiq.numpy()).max() < ATOL, label
    assert np.array_equal(np.asarray(jo), to.numpy()), label


def _setup(spec_kw, wave_rate, seed, active=False):
    """JAX params + state and the same through interop.  ``active`` lowers
    the noise floor and raises the signal averages so strong input opens the
    squelches within a block and weak input closes them within two, and
    starts the CTCSS channels OPEN with both Goertzel windows nearly full, so
    the window decisions and the close-time bank resets happen in a short
    run."""
    C = len(spec_kw)
    jp = jax_make_channel_params([JaxSpec(**k) for k in spec_kw], wave_rate=wave_rate, sample_rate=FS, center_freq=CENTER, fft_size=N)
    rng = np.random.default_rng(seed)
    js = jax_init_demod_state(
        C,
        jnp.asarray(np.abs(rng.normal(0, 1.0, (A, C))).astype(np.float32)),
        jnp.asarray(rng.normal(0, 0.5, (A, C, 2)).astype(np.float32)),
    )
    if active:
        d = jax_flat(js)
        ct = np.asarray(jp.ctcss_enabled)
        d["noise_floor"] = np.full(C, 0.3, np.float32)
        d["pre_full"] = d["pre_capped"] = np.full(C, 1.2, np.float32)
        d["cur"] = np.where(ct, OPEN, d["cur"]).astype(np.int32)
        d["nxt"] = d["cur"].copy()
        for bank, win, left in (("fast", jp.fast_window, 40), ("slow", jp.slow_window, 100)):
            d[f"{bank}.count"] = np.where(ct, np.asarray(win) - left, 0).astype(np.int32)
        from rtlsdr_airband_tpu.ops.demod import CtcssState, DemodState

        bank = lambda b: CtcssState(**{s: jnp.asarray(d[f"{b}.{s}"]) for s in CtcssState._fields})  # noqa: E731
        js = DemodState(**{k: (bank(k) if k in ("fast", "slow") else jnp.asarray(d[k])) for k in DemodState._fields})
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    return jp, js, tp, interop.state_from_numpy(jax_flat(js), device="cpu"), rng


def _block_inputs(rng, W, C, strong):
    mags = np.abs(rng.normal(0, 1.0, (W, C)) + (3.0 if strong else 0.0)).astype(np.float32)
    iqs = rng.normal(0, 0.5, (W, C, 2)).astype(np.float32)
    return mags, iqs


def test_transition_specializations():
    """The kernel and the plain version inline set_state(upd) with the
    validity table; the collapsed forms equal the general table
    (reference: squelch.cpp:297-361) for every current state."""
    cur = torch.arange(5)
    spec = {
        CLOSING: torch.where((cur == CLOSED) | (cur == LSA), CLOSED, CLOSING),
        OPENING: torch.where(cur == LSA, CLOSED, torch.where(cur == OPEN, OPEN, OPENING)),
        LSA: torch.where((cur == CLOSED) | (cur == OPENING), CLOSED, LSA),
        CLOSED: torch.where(cur == OPEN, CLOSING, CLOSED),
    }
    for upd, got in spec.items():
        assert torch.equal(_set_state_valid(cur, upd), got), upd
        assert torch.equal(_set_state_valid(cur, torch.full_like(cur, upd)), got), upd
    assert int(_set_state_valid(torch.tensor([OPEN]), CLOSING)[0]) == CLOSING
    assert int(_set_state_valid(torch.tensor([CLOSED]), OPENING)[0]) == OPENING
    for c in (OPENING, CLOSING, OPEN):
        want = CLOSED if c == OPENING else LSA
        assert int(_set_state_valid(torch.tensor([c]), LSA)[0]) == want


@pytest.mark.parametrize("with_ctcss", [True, False])
def test_matches_xla_scan_three_blocks(with_ctcss):
    """Strong signal on block 0 (opens, AGC bootstraps), weak after (closes,
    fade-outs), CTCSS windows deciding: plain, launcher-on-CPU and host-built
    kernel code all against the XLA scan, block by block."""
    W, wr = 200, 8000
    jp, js, tp, ts, rng = _setup(SPEC_KW, wr, seed=0, active=True)
    C = len(SPEC_KW)
    st = {"plain": ts, "launcher": ts, "host": ts}
    outs = {}
    run = {
        "plain": lambda s, m, q: demod_block(tp, s, m, q, with_ctcss=with_ctcss),
        "launcher": lambda s, m, q: demod_cuda.demod_block_cuda(tp, s, m, q, with_ctcss=with_ctcss),
        "host": lambda s, m, q: demod_cuda.demod_block_host(tp, s, m, q, with_ctcss=with_ctcss),
    }
    for blk in range(3):
        mags, iqs = _block_inputs(rng, W, C, strong=blk == 0)
        jout = jax_demod_block(jp, js, jnp.asarray(mags), jnp.asarray(iqs), with_ctcss=with_ctcss)
        js = jout[0]
        for name, fn in run.items():
            out = fn(st[name], torch.from_numpy(mags), torch.from_numpy(iqs))
            _assert_block_close(jout, out, f"{name} block {blk}")
            _assert_state_close(js, out[0], f"{name} block {blk}")
            st[name] = out[0]
            outs[name] = out
        # the kernel's code repeats the plain version's float operations one for
        # one (no FMA contraction on either side): equal bit for bit
        assert_bitwise(outs["plain"], outs["host"], f"block {blk}")
    # the scene exercised what it claims to: squelches opened and closed again
    opened_then_closed = (np.asarray(js.open_count) > 0) & (np.asarray(js.cur) == CLOSED)
    assert opened_then_closed.sum() >= 2
    if with_ctcss:
        decided = np.asarray(js.fast.not_found) + np.asarray(js.slow.not_found) + np.asarray(js.fast.found) + np.asarray(js.slow.found)
        assert decided.sum() >= 2


def test_matches_pallas_interpret():
    """The Pallas kernel in interpret mode against the plain version, the
    launcher on CPU tensors and the host-built kernel code, over two blocks
    of the active scene."""
    W, wr = 200, 8000
    jp, js, tp, ts, rng = _setup(SPEC_KW, wr, seed=1, active=True)
    st = {"plain": ts, "launcher": ts, "host": ts}
    run = {
        "plain": lambda s, m, q: demod_block(tp, s, m, q),
        "launcher": lambda s, m, q: demod_cuda.demod_block_cuda(tp, s, m, q),
        "host": lambda s, m, q: demod_cuda.demod_block_host(tp, s, m, q),
    }
    C = len(SPEC_KW)
    for blk in range(2):
        mags, iqs = _block_inputs(rng, W, C, strong=blk == 0)
        jout = demod_block_pallas(jp, js, jnp.asarray(mags), jnp.asarray(iqs), interpret=True)
        js = jout[0]
        for name, fn in run.items():
            out = fn(st[name], torch.from_numpy(mags), torch.from_numpy(iqs))
            _assert_block_close(jout, out, f"{name} block {blk}")
            _assert_state_close(js, out[0], f"{name} block {blk}")
            st[name] = out[0]


@pytest.mark.parametrize("fm_quadri", [False, True])
def test_ragged_channel_count(fm_quadri):
    """C = 3 (not a multiple of the kernel's 64-thread block), both NFM
    discriminators."""
    spec_kw = SPEC_KW[:3]
    W, wr = 120, 8000
    jp, js, tp, ts, rng = _setup(spec_kw, wr, seed=2)
    mags = np.abs(rng.normal(0, 1.0, (W, 3)) + 2.0).astype(np.float32)
    iqs = rng.normal(0, 0.5, (W, 3, 2)).astype(np.float32)
    jout = jax_demod_block(jp, js, jnp.asarray(mags), jnp.asarray(iqs), fm_quadri=fm_quadri)
    for fn in (demod_block, demod_cuda.demod_block_host):
        out = fn(tp, ts, torch.from_numpy(mags), torch.from_numpy(iqs), fm_quadri=fm_quadri)
        assert tuple(out[1].shape) == (W, 3)
        _assert_block_close(jout, out, fn.__name__)
        _assert_state_close(jout[0], out[0], fn.__name__)


def test_nan_input_matches_xla_scan():
    """A NaN magnitude row and a NaN IQ sample: the state takes the NaN where
    the JAX package's does (its minimum propagates NaN, as the kernel's
    min_nan does), and flags and int state stay equal."""
    W, wr = 200, 8000
    jp, js, tp, ts, rng = _setup(SPEC_KW, wr, seed=0, active=True)
    mags, iqs = _block_inputs(rng, W, len(SPEC_KW), strong=True)
    mags[50, :] = np.nan
    iqs[150, 2, 0] = np.nan
    jout = jax_demod_block(jp, js, jnp.asarray(mags), jnp.asarray(iqs))
    assert np.isnan(np.asarray(jout[0].noise_floor)).any()
    for fn in (demod_block, demod_cuda.demod_block_cuda, demod_cuda.demod_block_host):
        out = fn(tp, ts, torch.from_numpy(mags), torch.from_numpy(iqs))
        _assert_block_close(jout, out, fn.__name__)
        _assert_state_close(jout[0], out[0], fn.__name__)


def test_bank_bar_is_the_jax_packages_own_spread():
    """Why the Goertzel accumulators are held to 1e-4 of their bank's scale
    (torch_port_common.BANK_ACCUMULATORS): on the active scene the JAX
    package's own XLA scan and Pallas kernel differ there by more than 1e-4
    absolute, and stay within 1e-4 of the bank's scale."""
    jp, xs, _tp, _ts, rng = _setup(SPEC_KW, 8000, seed=0, active=True)
    ps = xs
    spread = []
    for blk in range(3):
        mags, iqs = _block_inputs(rng, 200, len(SPEC_KW), strong=blk == 0)
        xs = jax_demod_block(jp, xs, jnp.asarray(mags), jnp.asarray(iqs))[0]
        ps = demod_block_pallas(jp, ps, jnp.asarray(mags), jnp.asarray(iqs), interpret=True)[0]
        x, p = jax_flat(xs), jax_flat(ps)
        for k in BANK_ACCUMULATORS:
            d = np.abs(x[k].astype(np.float64) - p[k])
            spread.append((d.max(), (d / np.maximum(1.0, np.abs(x[k].astype(np.float64)).max(axis=0))).max()))
    assert max(a for a, _ in spread) > ATOL
    assert max(r for _, r in spread) <= ATOL


def test_apply_fade_and_tail_matches_jax():
    rng = np.random.default_rng(5)
    W, C = 600, 4
    tail = rng.normal(size=(A, C)).astype(np.float32)
    wave = rng.normal(size=(W, C)).astype(np.float32)
    fade = np.zeros((W, C), bool)
    fade[[3, 250, 480], 0] = True  # marks >= 197 apart, first inside the tail region
    fade[[120, 599], 1] = True  # last one's fade runs into the new tail
    fade[0, 2] = True
    want_audio, want_tail = jax_apply_fade_and_tail(jnp.asarray(tail), jnp.asarray(wave), jnp.asarray(fade))
    audio, new_tail = apply_fade_and_tail(torch.from_numpy(tail), torch.from_numpy(wave), torch.from_numpy(fade))
    np.testing.assert_array_equal(audio.numpy(), np.asarray(want_audio))
    np.testing.assert_array_equal(new_tail.numpy(), np.asarray(want_tail))
    assert not np.array_equal(audio.numpy()[:, 0], np.concatenate([tail, wave])[:W, 0])  # rewrites happened


def test_cpu_tensors_do_not_launch():
    W, wr = 120, 8000
    _jp, _js, tp, ts, rng = _setup(SPEC_KW[:2], wr, seed=3)
    mags, iqs = _block_inputs(rng, W, 2, strong=True)
    before = demod_cuda.LAUNCHES
    st, audio, iq, flags = demod_cuda.demod_block_cuda(tp, ts, torch.from_numpy(mags), torch.from_numpy(iqs), with_iq=False)
    assert demod_cuda.LAUNCHES == before
    assert not iq.any() and tuple(iq.shape) == (W, 2, 2)
    ref = demod_block(tp, ts, torch.from_numpy(mags), torch.from_numpy(iqs))
    assert torch.equal(audio, ref[1]) and torch.equal(flags, ref[3])


def test_launcher_rejects_bad_inputs():
    W, wr = 120, 8000
    _jp, _js, tp, ts, rng = _setup(SPEC_KW[:2], wr, seed=4)
    mags, iqs = _block_inputs(rng, W, 2, strong=False)
    m, q = torch.from_numpy(mags), torch.from_numpy(iqs)
    with pytest.raises(ValueError, match="shape"):
        demod_cuda.demod_block_host(tp, ts, m, q[:, :1])
    with pytest.raises(ValueError, match="dtype"):
        demod_cuda.demod_block_host(tp, ts._replace(cur=ts.cur.long()), m, q)
    with pytest.raises(ValueError, match="contiguous"):
        demod_cuda.demod_block_host(tp, ts, m.t().contiguous().t(), q)
    with pytest.raises(ValueError, match="W >= 100"):
        demod_cuda.demod_block_host(tp, ts, m[:50], q[:50])
    with pytest.raises(ValueError, match="device"):
        demod_cuda.demod_block_cuda(tp, ts, m.to("meta"), q.to("meta"))
