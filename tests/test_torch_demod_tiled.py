"""The shared-memory design of the demod kernel K1, run on the host.

``demod_block_host(block_width=...)`` runs the kernel's own code
(csrc/demod_step.cuh with csrc/demod_tiles.cuh, built with g++) in the
layout the card runs: channel groups of the block width, [row][width] rings,
Goertzel banks and tone tables, and input staged in tiles of 32 samples with
the iq_tail / iqs switch at n = 100.  It must equal the plain ``demod_block``
bit for bit in every output and state leaf, and both must stay within the
port's bars of the JAX package's XLA scan and Pallas kernel (interpret mode).
The cases cross the ragged edges: channel counts that the block width does
not divide, W that the tile does not divide, a tile that straddles n = 100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu.ops.demod import CtcssState as JaxCtcss
from rtlsdr_airband_tpu.ops.demod import DemodState as JaxState
from rtlsdr_airband_tpu.ops.demod import demod_block as jax_demod_block
from rtlsdr_airband_tpu.ops.demod_pallas import demod_block_pallas
from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
from rtlsdr_airband_tpu.ops.params import make_channel_params as jax_make_channel_params
from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import CLOSED, demod_block
from torch_port_common import ATOL, CENTER, FS, N, active_state, assert_bitwise, assert_close, jax_flat, spec_population

WAVE_RATE = 16000  # above every lowpass of SPEC_KW: at the audio Nyquist the Bessel design degenerates (tests/test_torch_demod_fuzz.py)
H100_SMEM_PER_BLOCK = 232_448  # bytes of shared memory one block may use on Hopper

# (C, W, fm_quadri, with_iq, closes): C = 3, 65 and 130 leave a ragged last
# group at both widths, 64 a whole one at 32 and 64; W = 100 ends on the
# iq_tail rows, 131 and 257 leave a partial last tile and cross n = 100
# inside tile 3 (rows 96-127); at W = 257 the CTCSS channels also close, so
# their banks reset
CASES = [
    (3, 100, False, True, False),
    (64, 131, False, False, False),
    (65, 257, True, True, True),
    (130, 131, True, False, False),
]


def _scene(C, seed):
    """JAX and port params and the active state of tests/test_torch_cuda.py,
    the same numbers in both."""
    jp = jax_make_channel_params([JaxSpec(**k) for k in spec_population(C)], wave_rate=WAVE_RATE, sample_rate=FS, center_freq=CENTER, fft_size=N)
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    rng = np.random.default_rng(seed)
    ts = active_state(tp, C, rng, "cpu")
    d = interop.state_to_numpy(ts)
    bank = lambda b: JaxCtcss(**{s: jnp.asarray(d[f"{b}.{s}"]) for s in JaxCtcss._fields})  # noqa: E731
    js = JaxState(**{k: (bank(k) if k in ("fast", "slow") else jnp.asarray(d[k])) for k in JaxState._fields})
    return jp, js, tp, ts, rng


def _inputs(rng, W, C, strong):
    mags = np.abs(rng.normal(0, 1.0, (W, C)) + (3.0 if strong else 0.0)).astype(np.float32)
    iqs = rng.normal(0, 0.5, (W, C, 2)).astype(np.float32)
    return mags, iqs


def _assert_within_bars(jout, out, label):
    _, ja, jiq, jo = jout
    assert np.array_equal(np.asarray(jo), out[3].numpy()), f"{label}: open flags"
    assert np.abs(np.asarray(ja) - out[1].numpy()).max() < ATOL, f"{label}: audio"
    if out[2].any():
        assert np.abs(np.asarray(jiq) - out[2].numpy()).max() < ATOL, f"{label}: iq"
    assert_close(jax_flat(jout[0]), interop.state_to_numpy(out[0]), f"{label}: state")


@pytest.mark.parametrize("block_width", demod_cuda.BLOCK_WIDTHS)
@pytest.mark.parametrize("C, W, fm_quadri, with_iq, closes", CASES)
def test_tiled_matches_plain_and_xla_scan(block_width, C, W, fm_quadri, with_iq, closes):
    """Three blocks threading the state, strong then weak: squelches open,
    the CTCSS windows decide and latch, and at W = 257 the CTCSS channels
    close and their banks reset."""
    jp, js, tp, ts, rng = _scene(C, seed=C + W)
    ps = hs = ts
    for blk in range(3):
        mags, iqs = _inputs(rng, W, C, strong=blk == 0)
        m, q = torch.from_numpy(mags), torch.from_numpy(iqs)
        jout = jax_demod_block(jp, js, jnp.asarray(mags), jnp.asarray(iqs), fm_quadri=fm_quadri)
        pout = demod_block(tp, ps, m, q, fm_quadri=fm_quadri)
        hout = demod_cuda.demod_block_host(tp, hs, m, q, fm_quadri=fm_quadri, with_iq=with_iq, block_width=block_width)
        label = f"C={C} W={W} width {block_width} block {blk}"
        assert_bitwise(pout if with_iq else (pout[0], pout[1], torch.zeros_like(pout[2]), pout[3]), hout, label)
        _assert_within_bars(jout, hout, label)
        js, ps, hs = jout[0], pout[0], hout[0]
    ct = tp.ctcss_enabled
    assert int((hs.open_count > 0).sum()) >= 1
    decided = hs.fast.found + hs.fast.not_found + hs.slow.found + hs.slow.not_found
    assert int(decided[ct].min()) > 0  # every CTCSS window decided
    if closes:  # they started OPEN, so closing ran the bank reset
        assert bool((hs.cur[ct] == CLOSED).any())
    else:
        assert bool(hs.slow.enough[ct].all())  # latched


@pytest.mark.parametrize("block_width", demod_cuda.BLOCK_WIDTHS)
def test_tiled_matches_pallas_interpret(block_width):
    """The JAX package's Pallas kernel in interpret mode against the tiled
    layout, over two blocks of 131 samples at C = 65 (a ragged group at
    both widths)."""
    C, W = 65, 131
    jp, js, tp, ts, rng = _scene(C, seed=11)
    ps = hs = ts
    for blk in range(2):
        mags, iqs = _inputs(rng, W, C, strong=blk == 0)
        m, q = torch.from_numpy(mags), torch.from_numpy(iqs)
        jout = demod_block_pallas(jp, js, jnp.asarray(mags), jnp.asarray(iqs), interpret=True)
        pout = demod_block(tp, ps, m, q)
        hout = demod_cuda.demod_block_host(tp, hs, m, q, block_width=block_width)
        label = f"width {block_width} block {blk}"
        assert_bitwise(pout, hout, label)
        _assert_within_bars(jout, hout, label)
        js, ps, hs = jout[0], pout[0], hout[0]


def test_device_memory_design_matches_plain():
    """The first design (rings and banks in device-memory rows), kept as the
    card's yardstick, through the host build: equal bit for bit too."""
    _jp, _js, tp, ts, rng = _scene(65, seed=3)
    ps = hs = ts
    for blk in range(2):
        m, q = (torch.from_numpy(a) for a in _inputs(rng, 131, 65, strong=blk == 0))
        pout = demod_block(tp, ps, m, q)
        hout = demod_cuda.demod_block_host(tp, hs, m, q, block_width=None)
        assert_bitwise(pout, hout, f"block {blk}")
        ps, hs = pout[0], hout[0]


def test_shared_memory_fits_a_hopper_block():
    """Rings 202 rows, banks 4 x 52, tone tables 2 x 52 (+ 2 x 52 mask
    bytes), two input tiles of 32 samples (mags and IQ pairs) and the
    sin/cos table, per channel of the block."""
    lib = demod_cuda.host_library()
    per_channel = 4 * (102 + 100 + 4 * 52 + 2 * 52 + 2 * 32 * 3) + 2 * 52
    for width in demod_cuda.BLOCK_WIDTHS:
        got = demod_cuda.smem_bytes(lib, width)
        assert got == 4 * 516 + width * per_channel
        assert got <= H100_SMEM_PER_BLOCK
    assert 2 * demod_cuda.smem_bytes(lib, 32) <= 228 * 1024  # two 32-channel blocks share an SM


def test_unbuilt_block_width_is_refused():
    _jp, _js, tp, ts, rng = _scene(3, seed=4)
    m, q = (torch.from_numpy(a) for a in _inputs(rng, 120, 3, strong=True))
    before = demod_cuda.LAUNCHES
    for call in (demod_cuda.demod_block_cuda, demod_cuda.demod_block_host):
        with pytest.raises(ValueError, match="block width 48"):
            call(tp, ts, m, q, block_width=48)
    with pytest.raises(ValueError, match="block width"):
        demod_cuda.smem_bytes(demod_cuda.host_library(), 16)
    assert demod_cuda.LAUNCHES == before


def test_misaligned_iq_is_refused():
    """The kernel stages each IQ pair with one 8-byte copy."""
    _jp, _js, tp, ts, rng = _scene(3, seed=5)
    m, q = (torch.from_numpy(a) for a in _inputs(rng, 120, 3, strong=True))
    shifted = torch.empty(q.numel() + 1)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="8-byte aligned"):
        demod_cuda.demod_block_host(tp, ts, m, shifted)
