"""The demod kernel K1, run on the host.

``demod_block_host`` runs the kernel's own code (csrc/demod_step.cuh with
csrc/demod_tiles.cuh, built with g++) in the layout the card runs: channel
groups of the block width (64), [row][width] rings, Goertzel banks and tone
tables, and input staged in tiles of 32 samples with the iq_tail / iqs
switch at n = 100; in the default schedule and at unroll 4, whose loop
leaves a remainder of W % 4 samples.  It must equal the plain
``demod_block`` bit for bit in every output and state leaf, and both must
stay within the port's bars of the JAX package's XLA scan and Pallas kernel
(interpret mode).  The cases cross the ragged edges: channel counts that
the block width does not divide, W that the tile does not divide, a tile
that straddles n = 100.
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
# group, 64 a whole one; W = 100 ends on the iq_tail rows, 131 and 257 leave
# a partial last tile and cross n = 100 inside tile 3 (rows 96-127), and
# leave 3 and 1 samples after the last trip of 4; at W = 257 the CTCSS
# channels also close, so their banks reset
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


@pytest.mark.parametrize("unroll", [1, 4])
@pytest.mark.parametrize("C, W, fm_quadri, with_iq, closes", CASES)
def test_tiled_matches_plain_and_xla_scan(unroll, C, W, fm_quadri, with_iq, closes):
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
        hout = demod_cuda.demod_block_host(tp, hs, m, q, fm_quadri=fm_quadri, with_iq=with_iq, unroll=unroll)
        label = f"C={C} W={W} unroll {unroll} block {blk}"
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


@pytest.mark.parametrize("unroll", [1, 4])
def test_tiled_matches_pallas_interpret(unroll):
    """The JAX package's Pallas kernel in interpret mode against the tiled
    layout, over two blocks of 131 samples at C = 65 (a ragged group) with
    the state carried."""
    C, W = 65, 131
    jp, js, tp, ts, rng = _scene(C, seed=11)
    ps = hs = ts
    for blk in range(2):
        mags, iqs = _inputs(rng, W, C, strong=blk == 0)
        m, q = torch.from_numpy(mags), torch.from_numpy(iqs)
        jout = demod_block_pallas(jp, js, jnp.asarray(mags), jnp.asarray(iqs), interpret=True)
        pout = demod_block(tp, ps, m, q)
        hout = demod_cuda.demod_block_host(tp, hs, m, q, unroll=unroll)
        label = f"unroll {unroll} block {blk}"
        assert_bitwise(pout, hout, label)
        _assert_within_bars(jout, hout, label)
        js, ps, hs = jout[0], pout[0], hout[0]


def test_shared_memory_fits_a_hopper_block():
    """Rings 202 rows and two input tiles of 32 samples (mags and IQ pairs)
    per channel of the block, and the sin/cos table: the 64-channel block,
    and the 32-channel tile image the pair block holds twice (the second
    16-byte aligned).  The Goertzel banks and tone tables are the CTCSS
    pass's, in its registers."""
    lib = demod_cuda.host_library()
    per_channel = 4 * (102 + 100 + 2 * 32 * 3)
    got = demod_cuda.smem_bytes(lib)
    assert got == 4 * 516 + demod_cuda.BLOCK_WIDTH * per_channel
    assert got <= H100_SMEM_PER_BLOCK
    tile = 4 * 516 + demod_cuda.PAIR_TILE * per_channel
    assert demod_cuda.pair_smem_bytes(lib) == (tile + 15) // 16 * 16 + tile


def test_misaligned_iq_is_refused():
    """The kernel stages each IQ pair with one 8-byte copy."""
    _jp, _js, tp, ts, rng = _scene(3, seed=5)
    m, q = (torch.from_numpy(a) for a in _inputs(rng, 120, 3, strong=True))
    shifted = torch.empty(q.numel() + 1)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="8-byte aligned"):
        demod_cuda.demod_block_host(tp, ts, m, shifted)
