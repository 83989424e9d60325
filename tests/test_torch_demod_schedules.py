"""K1's schedules, run on the host: ``unroll`` (U samples a loop trip) and
``pair`` (two 32-channel tiles a block, each thread stepping one channel of
each tile together), the counterparts of the JAX kernel's ``unroll`` and
``pair`` options (``demod_pallas.py:157-166, :633-646, :695-709``).

``demod_block_host(..., unroll=, pair=)`` runs the kernel's own code
(csrc/demod_step.cuh, csrc/demod_tiles.cuh, built with g++) in the
schedule's order and layout.  Each schedule is the default's arithmetic in
another order, so it must equal the plain ``demod_block`` bit for bit in
every output and state leaf; the JAX package's Pallas kernel in interpret
mode, in the same schedule, must agree within the port's parity bars, flags
and integer state exact.

The scenes are those of ``tests/test_demod_pallas.py:122-179``: 2048 mixed
channels (AM, NFM, CTCSS, lowpass, notch; the JAX pair scene, with
``RTLSDR_DEMOD_SUBL=8`` so the JAX kernel has two tiles to pair) and the
16-channel flagship at W = 128 (the JAX unroll scene).  The mixed scene runs
at W = 128, not 64: the port refuses a block shorter than the 100-sample IQ
look-back (``ops/demod.py::demod_block``).  Both start closed and stay closed
over their blocks, so a third, live scene (256 channels from an active
state) holds every schedule where squelches open and close and the CTCSS
banks decide.  Against the plain version each scene runs three blocks
threading the state.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu.constants import AGC_EXTRA
from rtlsdr_airband_tpu.models.flagship import build_flagship as jax_build_flagship
from rtlsdr_airband_tpu.ops.demod_pallas import demod_block_pallas
from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
from rtlsdr_airband_tpu.ops.params import init_demod_state as jax_init_demod_state
from rtlsdr_airband_tpu.ops.params import make_channel_params as jax_make_channel_params
from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.models.flagship import build_flagship
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import demod_block
from torch_port_common import ATOL, CENTER, FS, N, active_state, assert_bitwise, assert_close, jax_flat, spec_population

H100_SMEM_PER_BLOCK = 232_448
# (unroll, pair): every schedule the card builds
SCHEDULES = [(1, False), (2, False), (4, False), (1, True), (2, True), (4, True)]


def _port_params(jp):
    return interop.params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")


def _mixed_scene():
    """tests/test_demod_pallas.py::test_pair_parity_bit_identical's channels,
    state and inputs (seed 7), at W = 128, three blocks."""
    C, W = 2048, 128
    specs = [
        JaxSpec(
            frequency=CENTER + 1000 * (i - C // 2),
            modulation="nfm" if i % 3 == 0 else "am",
            ctcss=100.0 if i % 7 == 0 else 0.0,
            bandwidth=6000.0 if i % 5 == 0 else 0.0,
            notch=1000.0 if i % 11 == 0 else 0.0,
        )
        for i in range(C)
    ]
    jp = jax_make_channel_params(specs, wave_rate=8000, sample_rate=FS, center_freq=CENTER, fft_size=N)
    rng = np.random.default_rng(7)
    js = jax_init_demod_state(
        C,
        jnp.asarray(np.abs(rng.normal(0, 1.0, (AGC_EXTRA, C))).astype(np.float32)),
        jnp.asarray(rng.normal(0, 0.5, (AGC_EXTRA, C, 2)).astype(np.float32)),
    )
    blocks = [
        (np.abs(rng.normal(0, 1.0, (W, C)) + 2.0).astype(np.float32), rng.normal(0, 0.5, (W, C, 2)).astype(np.float32))
        for _ in range(3)
    ]
    return dict(jp=jp, js=js, state=interop.state_from_numpy(jax_flat(js), device="cpu"), blocks=blocks, kw={})


def _flagship_scene():
    """tests/test_demod_pallas.py::test_unroll_parity_bit_identical's
    flagship (16 channels, W = 128) and inputs (seed 0), three blocks."""
    bk, (_x, _bins, _window, jp, js) = jax_build_flagship(n_channels=16, wave_batch=128)
    rng = np.random.default_rng(0)
    W, C = 128, 16
    blocks = [(rng.random((W, C), np.float32) * 0.1, rng.random((W, C, 2), np.float32) * 0.1) for _ in range(3)]
    kw = dict(fm_quadri=bk["fm_quadri"], with_ctcss=bk["with_ctcss"])
    return dict(jp=jp, js=js, state=interop.state_from_numpy(jax_flat(js), device="cpu"), blocks=blocks, kw=kw)


def _active_scene():
    """A live scene: 256 channels of tests/test_demod_pallas.py::SPECS' six
    kinds from the active state of tests/test_torch_cuda.py (squelches
    open, closing and opening, CTCSS windows part-way), strong then weak
    blocks of W = 131 (a remainder after the trips of 2 and 4): squelches
    open and close, CTCSS windows decide, AGC bootstraps run."""
    C, W = 256, 131
    jp = jax_make_channel_params([JaxSpec(**k) for k in spec_population(C)], wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N)
    rng = np.random.default_rng(21)
    st = active_state(_port_params(jp), C, rng, "cpu")
    blocks = [
        (np.abs(rng.normal(0, 1.0, (W, C)) + (3.0 if k == 0 else 0.0)).astype(np.float32), rng.normal(0, 0.5, (W, C, 2)).astype(np.float32))
        for k in range(3)
    ]
    return dict(jp=jp, js=None, state=st, blocks=blocks, kw={})


SCENES = {"mixed2048": _mixed_scene, "flagship16": _flagship_scene, "active256": _active_scene}


@pytest.fixture(scope="module")
def scenes():
    """Each scene with its plain-version outputs, block after block."""
    out = {}
    for name, make in SCENES.items():
        s = make()
        tp, st = _port_params(s["jp"]), s["state"]
        out[name] = dict(s, tp=tp, plain=[])
        for mags, iqs in s["blocks"]:
            o = demod_block(tp, st, torch.from_numpy(mags), torch.from_numpy(iqs), **s["kw"])
            out[name]["plain"].append(o)
            st = o[0]
    return out


@pytest.mark.parametrize("unroll, pair", SCHEDULES)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_schedule_matches_plain_bitwise(scenes, scene, unroll, pair):
    """The host build in each schedule against the plain version, three
    blocks threading the state, bit for bit.  The 16-channel flagship has
    one tile: pair runs the default schedule there (an odd tile count)."""
    s = scenes[scene]
    st = s["state"]
    C = s["blocks"][0][0].shape[1]
    want = demod_cuda.schedule_name(unroll, pair and C > demod_cuda.PAIR_TILE)
    for blk, ((mags, iqs), pout) in enumerate(zip(s["blocks"], s["plain"])):
        hout = demod_cuda.demod_block_host(s["tp"], st, torch.from_numpy(mags), torch.from_numpy(iqs), unroll=unroll, pair=pair, **s["kw"])
        assert demod_cuda.HOST_SCHEDULE == want
        assert_bitwise(pout, hout, f"{scene} {want} block {blk}")
        st = hout[0]
    if scene == "active256":  # the scene is live: squelches opened and closed, CTCSS windows decided
        s0, ct = s["state"], s["tp"].ctcss_enabled
        assert int((st.open_count > s0.open_count).sum()) > 0 and bool((st.cur == 0).any())
        assert int((st.fast.found + st.fast.not_found + st.slow.found + st.slow.not_found)[ct].min()) > 0


@pytest.mark.parametrize(
    "scene, unroll, pair",
    [("mixed2048", 1, False), ("mixed2048", 1, True), ("flagship16", 1, False), ("flagship16", 2, False), ("flagship16", 4, False)],
)
def test_schedule_matches_jax_pallas_interpret(scenes, monkeypatch, scene, unroll, pair):
    """The JAX kernel in interpret mode as tests/test_demod_pallas.py runs it
    (one block; the mixed scene with two 1024-lane tiles, so JAX pairs
    them) against the host build in the same schedule: within the parity
    bars, open flags and integer/bool state exact."""
    monkeypatch.setenv("RTLSDR_DEMOD_SUBL", "8")
    s = scenes[scene]
    mags, iqs = s["blocks"][0]
    jout = demod_block_pallas(s["jp"], s["js"], jnp.asarray(mags), jnp.asarray(iqs), interpret=True, pair=pair, unroll=unroll, **s["kw"])
    hout = demod_cuda.demod_block_host(s["tp"], s["state"], torch.from_numpy(mags), torch.from_numpy(iqs), unroll=unroll, pair=pair, **s["kw"])
    label = f"{scene} unroll {unroll} pair {pair}"
    assert np.array_equal(np.asarray(jout[3]), hout[3].numpy()), f"{label}: open flags"
    assert np.abs(np.asarray(jout[1]) - hout[1].numpy()).max() < ATOL, f"{label}: audio"
    assert np.abs(np.asarray(jout[2]) - hout[2].numpy()).max() < ATOL, f"{label}: iq"
    assert_close(jax_flat(jout[0]), interop.state_to_numpy(hout[0]), f"{label}: state")


def _small(C, W, seed):
    jp = jax_make_channel_params([JaxSpec(**k) for k in spec_population(C)], wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N)
    tp = _port_params(jp)
    rng = np.random.default_rng(seed)
    st = active_state(tp, C, rng, "cpu")
    blocks = [
        (torch.from_numpy(np.abs(rng.normal(0, 1.0, (W, C)) + (3.0 if k == 0 else 0.0)).astype(np.float32)),
         torch.from_numpy(rng.normal(0, 0.5, (W, C, 2)).astype(np.float32)))
        for k in range(2)
    ]
    return tp, st, blocks


@pytest.mark.parametrize(
    "C, unroll, want",
    [
        (96, 1, "single_u1"),  # three tiles: odd, the default schedule runs
        (96, 4, "single_u4"),
        (100, 1, "pair_u1"),  # four tiles, the last of 4 channels: lanes 4-31 of the last block step one channel
        (100, 4, "pair_u4"),
    ],
)
def test_pair_at_odd_and_ragged_tile_counts(C, unroll, want):
    """pair=True where the tile count is odd runs the default schedule (the
    JAX rule); where it is even with a ragged last tile, the pair block's
    lanes without a second channel step their first alone.  W = 131 leaves
    a remainder after the unrolled trips.  Both bit for bit."""
    tp, ps, blocks = _small(C, 131, seed=C + unroll)
    hs = ps
    for blk, (m, q) in enumerate(blocks):
        pout = demod_block(tp, ps, m, q)
        hout = demod_cuda.demod_block_host(tp, hs, m, q, unroll=unroll, pair=True)
        assert demod_cuda.HOST_SCHEDULE == want
        assert_bitwise(pout, hout, f"C={C} {want} block {blk}")
        ps, hs = pout[0], hout[0]
    assert demod_cuda.resolve_schedule(C, unroll, True) == (unroll, want.startswith("pair"))


@pytest.mark.parametrize("call", ["demod_block_cuda", "demod_block_host"])
@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(unroll=3), "unroll 3"),
        (dict(unroll=8), "unroll 8"),
    ],
)
def test_unbuilt_schedule_raises(call, kw, match):
    """An unroll the kernel is not built for raises ValueError before any
    launch, on the CPU too: nothing falls back to another schedule."""
    tp, st, ((m, q), _) = _small(3, 120, seed=1)
    before = demod_cuda.LAUNCHES
    with pytest.raises(ValueError, match=match):
        getattr(demod_cuda, call)(tp, st, m, q, **kw)
    assert demod_cuda.LAUNCHES == before


@pytest.mark.parametrize("env, want", [(None, "single_u1"), ("0", "single_u1"), ("1", "pair_u1")])
def test_pair_none_reads_the_environment(monkeypatch, env, want):
    """pair=None reads RTLSDR_DEMOD_PAIR, the JAX package's own variable;
    an explicit pair wins over it."""
    if env is None:
        monkeypatch.delenv(demod_cuda.PAIR_ENV, raising=False)
    else:
        monkeypatch.setenv(demod_cuda.PAIR_ENV, env)
    tp, st, ((m, q), _) = _small(64, 120, seed=2)
    demod_cuda.demod_block_host(tp, st, m, q)
    assert demod_cuda.HOST_SCHEDULE == want
    demod_cuda.demod_block_host(tp, st, m, q, pair=False)
    assert demod_cuda.HOST_SCHEDULE == "single_u1"
    demod_cuda.demod_block_host(tp, st, m, q, pair=True)
    assert demod_cuda.HOST_SCHEDULE == "pair_u1"


def test_pipeline_honours_the_environment(monkeypatch):
    """The flagship block program (FlagshipBlock -> pipeline_block -> the
    K1 wrapper, here its host build) with RTLSDR_DEMOD_PAIR=1 runs the pair
    schedule, and its outputs equal the run without the variable bit for
    bit (64 channels, two tiles; two blocks threading the state)."""
    import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline

    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    block, x, state0 = build_flagship(n_channels=64, wave_batch=128, device="cpu")
    runs = {}
    for env in ("0", "1"):
        monkeypatch.setenv(demod_cuda.PAIR_ENV, env)
        st, outs = state0, []
        for k in range(2):
            st, out = block(x * (1.0 + 0.5 * k), st)
            outs.append(out)
        runs[env] = (st, outs, demod_cuda.HOST_SCHEDULE)
    assert runs["0"][2] == "single_u1" and runs["1"][2] == "pair_u1"
    for a, b in zip(runs["0"][1], runs["1"][1]):
        assert a.keys() == b.keys()
        for k in a:
            x0, x1 = a[k], b[k]
            if x0.dtype == torch.float32:
                x0, x1 = x0.view(torch.int32), x1.view(torch.int32)
            assert torch.equal(x0, x1), k
    s0, s1 = interop.state_to_numpy(runs["0"][0]), interop.state_to_numpy(runs["1"][0])
    assert all(s0[k].tobytes() == s1[k].tobytes() for k in s0)


def test_pair_block_fits_a_hopper_block():
    """The pair block's shared memory: two 32-channel block images, the
    second 16-byte aligned; about the 64-channel block's ~103 KB, the same
    grid at the same channel count."""
    lib = demod_cuda.host_library()
    one = 4 * 516 + 32 * 4 * (102 + 100 + 2 * 32 * 3)  # a 32-channel block image
    got = demod_cuda.pair_smem_bytes(lib)
    assert got == (one + 15) // 16 * 16 + one
    assert got <= H100_SMEM_PER_BLOCK
    assert abs(got - demod_cuda.smem_bytes(lib)) < 4096


def test_schedules_leave_the_default_alone(monkeypatch):
    """Without the variable and without arguments the default schedule
    runs: the main path changes only when a caller asks."""
    monkeypatch.delenv(demod_cuda.PAIR_ENV, raising=False)
    assert demod_cuda.resolve_schedule(8192, 1, None) == (1, False)
    assert demod_cuda.schedule_name(1, False) == "single_u1"
    for C in (64, 8192):
        assert demod_cuda.resolve_schedule(C, 1, True) == (1, True)
    assert os.environ.get(demod_cuda.PAIR_ENV) is None
