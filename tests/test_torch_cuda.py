"""The nvcc-built kernels against their plain PyTorch versions, on the card:
the demod kernel K1 and the chain-latency probe K2; the streaming Pipeline
on the card (chunked dispatch with a copy stream equal to single-block
dispatch, K1 once a block) and the FFT channelizer's precision; the App
from a libconfig file (K1 once a block, per-device demod threads equal to
one thread bit for bit, no multi-GPU mesh); K1 refusing trace mode, which
the plain version has; K1 and the CTCSS pass after it against the plain
version at 8192 channels in mixed8192's and am8192's populations, and the
pass's launch counter; K1's unroll and pair schedules against the default at
8192 channels and the pair rule at an odd tile count; the fade-tail kernel
against the plain assembly, once a K1 launch; scripts/bench.py's,
bench_pair.py's and bench_unroll.py's lines on the card.

Needs an NVIDIA GPU and nvcc; skips without a card.  The file imports
neither jax nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

K1 and K2 round every operation as their plain versions do: equal bit for
bit, K1 in every output and state leaf.
"""

import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import apply_fade_and_tail, demod_block
from rtlsdr_airband_tpu_torch.ops.channelizer import block_input_len, channelize_fft
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, init_demod_state, make_channel_params
from rtlsdr_airband_tpu_torch.ops.window import blackman_harris_7
from rtlsdr_airband_tpu_torch.runtime.config import loads_config
from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig
from rtlsdr_airband_tpu_torch.scripts import bench_chain_probe as probe
from rtlsdr_airband_tpu_torch.utils.siggen import am_carrier_iq, complex_noise
from torch_port_common import (
    CENTER, FS, N, SPEC_KW, active_state, assert_bitwise, assert_channelizer_close, dft_at_bins, drive_app, feed_all,
    spec_population, to_u8,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_channels, W, fm_quadri, with_ctcss, with_iq",
    [
        (6, 200, False, True, True),
        (6, 200, True, False, True),
        (3, 100, False, True, False),
        (64, 131, False, True, False),
        (65, 257, True, True, True),
        (130, 131, True, True, False),
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, n_channels, W, fm_quadri, with_ctcss, with_iq):
    """Three blocks, strong then weak signal, bit for bit in every output and
    state leaf.  C = 3, 6, 65 and 130 leave a ragged last block; W = 100
    ends on the iq_tail rows, W = 131 and 257 end inside a 32-sample input
    tile and cross n = 100 inside one."""
    specs = [ChannelSpec(**k) for k in spec_population(n_channels)]
    params = make_channel_params(specs, wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")
    rng = np.random.default_rng(6)
    ks = ps = active_state(params, n_channels, rng, cuda_device)
    params = type(params)(*(t.to(cuda_device) for t in params))
    for blk in range(3):
        mags = np.abs(rng.normal(0, 1.0, (W, n_channels)) + (3.0 if blk == 0 else 0.0)).astype(np.float32)
        iqs = rng.normal(0, 0.5, (W, n_channels, 2)).astype(np.float32)
        m, q = torch.from_numpy(mags).to(cuda_device), torch.from_numpy(iqs).to(cuda_device)
        before = demod_cuda.LAUNCHES
        kout = demod_cuda.demod_block_cuda(params, ks, m, q, fm_quadri=fm_quadri, with_ctcss=with_ctcss, with_iq=with_iq)
        assert demod_cuda.LAUNCHES == before + 1
        pout = demod_block(params, ps, m, q, fm_quadri=fm_quadri, with_ctcss=with_ctcss)
        torch.cuda.synchronize()
        if not with_iq:
            assert not kout[2].any()
            pout = (pout[0], pout[1], torch.zeros_like(pout[2]), pout[3])
        assert_bitwise(pout, kout, f"block {blk}")
        ks, ps = kout[0], pout[0]
    assert int(ps.open_count.sum()) > 0


def _population_8192(name: str) -> list:
    """8192 channels in the main path's order: ``mixed`` is the flagship's
    four kinds (a quarter NFM with CTCSS, grouped last by
    cost_group_permutation), ``am_one_ctcss`` am8192's (AM, channel 0 with
    CTCSS 100 Hz)."""
    from rtlsdr_airband_tpu_torch.models.flagship import flagship_specs
    from rtlsdr_airband_tpu_torch.ops.params import cost_group_permutation

    specs = flagship_specs(8192)
    if name == "am_one_ctcss":
        specs = [ChannelSpec(frequency=s.frequency, modulation="am", ctcss=100.0 if i == 0 else 0.0) for i, s in enumerate(specs)]
    return [specs[i] for i in cost_group_permutation(specs)]


@pytest.mark.cuda
@pytest.mark.parametrize("population", ["mixed", "am_one_ctcss"])
def test_k1_and_ctcss_pass_match_plain_at_8192(cuda_device, population):
    """K1 and the CTCSS pass after it at 8192 channels and W = 2000, in the
    populations of mixed8192 and am8192, against the plain version over two
    blocks (strong, then weak: the CTCSS channels start open with their
    windows nearly full, decide, and close): every output and state leaf bit
    for bit, the pass launched once a block."""
    specs = _population_8192(population)
    C, W = len(specs), 2000
    params = make_channel_params(specs, wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")
    rng = np.random.default_rng(21)
    ks = ps = active_state(params, C, rng, cuda_device)
    params = type(params)(*(t.to(cuda_device) for t in params))
    for blk in range(2):
        m = torch.from_numpy(np.abs(rng.normal(0, 1.0, (W, C)) + (3.0 if blk == 0 else 0.0)).astype(np.float32)).to(cuda_device)
        q = torch.from_numpy(rng.normal(0, 0.5, (W, C, 2)).astype(np.float32)).to(cuda_device)
        before = demod_cuda.CTCSS_LAUNCHES
        kout = demod_cuda.demod_block_cuda(params, ks, m, q)
        assert demod_cuda.CTCSS_LAUNCHES == before + 1
        pout = demod_block(params, ps, m, q)
        torch.cuda.synchronize()
        assert_bitwise(pout, kout, f"{population} block {blk}")
        ks, ps = kout[0], pout[0]
    ct = params.ctcss_enabled
    assert int((ps.fast.found + ps.fast.not_found + ps.slow.found + ps.slow.not_found)[ct].min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_ctcss", [True, False])
def test_ctcss_pass_launches_once_a_block_with_the_banks(cuda_device, with_ctcss):
    """``CTCSS_LAUNCHES`` rises by one a ``demod_block_cuda`` call with
    ``with_ctcss`` and by none without it; K1 launches once either way."""
    specs = [ChannelSpec(**k) for k in SPEC_KW]
    params = make_channel_params(specs, wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N, device=cuda_device)
    st = active_state(params, len(specs), np.random.default_rng(9), cuda_device)
    m, q = torch.ones(150, len(specs), device=cuda_device), torch.zeros(150, len(specs), 2, device=cuda_device)
    k1, ct = demod_cuda.LAUNCHES, demod_cuda.CTCSS_LAUNCHES
    for _ in range(3):
        demod_cuda.demod_block_cuda(params, st, m, q, with_ctcss=with_ctcss)
    torch.cuda.synchronize()
    assert (demod_cuda.LAUNCHES - k1, demod_cuda.CTCSS_LAUNCHES - ct) == (3, 3 if with_ctcss else 0)


@pytest.mark.cuda
def test_launcher_rejects_cpu_state_with_cuda_data(cuda_device):
    """A CUDA tensor launches the kernel or raises: a state left on the CPU
    is refused, not run on the plain path."""
    specs = [ChannelSpec(**k) for k in SPEC_KW[:2]]
    params = make_channel_params(specs, wave_rate=8000, sample_rate=FS, center_freq=CENTER, fft_size=N, device=cuda_device)
    st = init_demod_state(2, torch.zeros(AGC_EXTRA, 2), torch.zeros(AGC_EXTRA, 2, 2))
    m, q = torch.zeros(120, 2, device=cuda_device), torch.zeros(120, 2, 2, device=cuda_device)
    before = demod_cuda.LAUNCHES
    with pytest.raises(ValueError, match="cpu"):
        demod_cuda.demod_block_cuda(params, st, m, q)
    assert demod_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_k1_refuses_to_trace_on_card(cuda_device):
    """K1 has no trace mode: asked for one, the wrapper raises before any
    launch; the plain version traces on the card and leaves its other
    outputs bit for bit K1's."""
    specs = [ChannelSpec(**k) for k in SPEC_KW]
    params = make_channel_params(specs, wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N, device=cuda_device)
    rng = np.random.default_rng(8)
    st = active_state(params, len(specs), rng, cuda_device)
    m = torch.from_numpy(np.abs(rng.normal(0, 1.0, (150, len(specs))) + 3.0).astype(np.float32)).to(cuda_device)
    q = torch.from_numpy(rng.normal(0, 0.5, (150, len(specs), 2)).astype(np.float32)).to(cuda_device)
    before = demod_cuda.LAUNCHES
    with pytest.raises(ValueError, match="no trace mode"):
        demod_cuda.demod_block_cuda(params, st, m, q, trace=True)
    assert demod_cuda.LAUNCHES == before
    traced = demod_block(params, st, m, q, trace=True)
    assert traced[4]["cur"].shape == (150, len(specs)) and traced[4]["cur"].device.type == "cuda"
    assert_bitwise(demod_cuda.demod_block_cuda(params, st, m, q), traced[:4], "traced plain against K1")


@pytest.fixture(scope="module")
def flagship_scene_8192():
    """Two blocks of the 8192-channel active scene (chip_smoke.py's parity
    scene): the channelizer's outputs and the state entering each block,
    threaded by the default schedule, with the default's outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship_stream
    from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul

    dev = torch.device("cuda")
    block, state, xs, _hot = build_flagship_stream(n_channels=8192, wave_batch=2000, n_blocks=2, device=dev)
    kw = block.block_kwargs
    blocks = []
    for x in xs:
        mags, iqs = channelize_matmul(x, block.bins, block.window, hop=kw["hop"], fft_size=kw["fft_size"], n_frames=kw["n_frames"],
                                      taps=(block.taps_re, block.taps_im))
        out = demod_cuda.demod_block_cuda(block.params, state, mags, iqs, pair=False)
        blocks.append((state, mags, iqs, out))
        state = out[0]
    return block.params, blocks


@pytest.mark.cuda
@pytest.mark.parametrize("unroll, pair", [(4, False), (1, True), (4, True)])
def test_schedule_matches_default_on_card_at_8192(cuda_device, flagship_scene_8192, unroll, pair):
    """K1's unroll and pair schedules at the flagship width (8192 channels,
    W = 2000, CTCSS banks on) against the default schedule: every output and
    state leaf bit for bit, and the schedule counter names the one that ran."""
    params, blocks = flagship_scene_8192
    name = demod_cuda.schedule_name(unroll, pair)
    for k, (st, mags, iqs, want) in enumerate(blocks):
        before = demod_cuda.SCHEDULE_LAUNCHES[name]
        got = demod_cuda.demod_block_cuda(params, st, mags, iqs, unroll=unroll, pair=pair)
        torch.cuda.synchronize()
        assert demod_cuda.SCHEDULE_LAUNCHES[name] == before + 1
        assert_bitwise(want, got, f"{name} block {k}")


@pytest.mark.cuda
def test_pair_runs_the_default_at_an_odd_tile_count_on_card(cuda_device, monkeypatch):
    """RTLSDR_DEMOD_PAIR=1 at 96 channels (three 32-channel tiles) runs the
    default schedule, at 100 (four, the last ragged) the pair schedule; both
    bit for bit the plain version."""
    monkeypatch.setenv(demod_cuda.PAIR_ENV, "1")
    for C, want in ((96, "single_u1"), (100, "pair_u1")):
        specs = [ChannelSpec(**k) for k in spec_population(C)]
        params = make_channel_params(specs, wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")
        rng = np.random.default_rng(C)
        st = active_state(params, C, rng, cuda_device)
        params = type(params)(*(t.to(cuda_device) for t in params))
        m = torch.from_numpy(np.abs(rng.normal(0, 1.0, (131, C)) + 3.0).astype(np.float32)).to(cuda_device)
        q = torch.from_numpy(rng.normal(0, 0.5, (131, C, 2)).astype(np.float32)).to(cuda_device)
        before = demod_cuda.SCHEDULE_LAUNCHES[want]
        got = demod_cuda.demod_block_cuda(params, st, m, q)
        torch.cuda.synchronize()
        assert demod_cuda.SCHEDULE_LAUNCHES[want] == before + 1
        assert_bitwise(demod_block(params, st, m, q), got, f"C={C}")


def _fade_inputs(W, C, seed, device):
    """A carried tail, K1's audio and flag bytes with squelch bits on about
    half the samples and close marks on about one in a hundred, plus marks at
    row 0, inside rows 1-99, 50 rows apart and at W - 1."""
    rng = np.random.default_rng(seed)
    tail = rng.normal(0, 0.5, (AGC_EXTRA, C)).astype(np.float32)
    raw = rng.normal(0, 0.5, (W, C)).astype(np.float32)
    flags = (rng.random((W, C)) < 0.5).astype(np.uint8) | ((rng.random((W, C)) < 0.01).astype(np.uint8) << 1)
    for c, rows in ((0, (0,)), (C // 2, (37, 87)), (C - 1, (W - 1,))):
        flags[list(rows), c] |= 2
    return tuple(torch.from_numpy(x).to(device) for x in (tail, raw, flags))


@pytest.mark.cuda
@pytest.mark.parametrize("W, C", [(2000, 8192), (2000, 2280), (257, 65), (100, 3)])
def test_fade_tail_kernel_matches_plain_on_card(cuda_device, W, C):
    """The fade-tail kernel at the shape it plans for (W, C) against the
    plain assembly on the card, bit for bit in audio, new tail and open
    flags; one launch, counted."""
    tail, raw, flags = _fade_inputs(W, C, C, cuda_device)
    before = demod_cuda.FADE_LAUNCHES
    got = demod_cuda.fade_and_tail(tail, raw, flags)
    assert demod_cuda.FADE_LAUNCHES == before + 1
    audio, new_tail = apply_fade_and_tail(tail, raw, (flags & 2) != 0)
    torch.cuda.synchronize()
    for name, x, y in zip(("audio", "new_tail", "open_now"), (audio, new_tail, (flags & 1) != 0), got):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y), f"{name} differs at W={W}, C={C}"
    assert bool((audio != torch.cat([tail, raw])[:W]).any())  # the scene's marks rewrote rows


@pytest.mark.cuda
def test_demod_block_cuda_launches_the_fade_tail_kernel_once_a_block(cuda_device, monkeypatch):
    """Every K1 launch of demod_block_cuda is followed by one launch of the
    fade-tail kernel, and the CUDA path runs no torch.cummax."""
    C, W = 65, 257
    specs = [ChannelSpec(**k) for k in spec_population(C)]
    params = make_channel_params(specs, wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")
    rng = np.random.default_rng(19)
    st = active_state(params, C, rng, cuda_device)
    params = type(params)(*(t.to(cuda_device) for t in params))

    def no_cummax(*a, **k):
        raise AssertionError("torch.cummax ran on the CUDA path")

    monkeypatch.setattr(torch, "cummax", no_cummax)
    k1, fade = demod_cuda.LAUNCHES, demod_cuda.FADE_LAUNCHES
    for blk in range(3):
        m = torch.from_numpy(np.abs(rng.normal(0, 1.0, (W, C)) + (3.0 if blk == 0 else 0.0)).astype(np.float32)).to(cuda_device)
        q = torch.from_numpy(rng.normal(0, 0.5, (W, C, 2)).astype(np.float32)).to(cuda_device)
        st = demod_cuda.demod_block_cuda(params, st, m, q)[0]
        assert (demod_cuda.LAUNCHES - k1, demod_cuda.FADE_LAUNCHES - fade) == (blk + 1, blk + 1)
    torch.cuda.synchronize()


def _jax_line_keys(script: str) -> set:
    """The keys of the dict literal a JAX script hands to ``json.dumps``,
    read from its source (this file imports no JAX)."""
    import ast
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for node in ast.walk(ast.parse(open(os.path.join(root, script)).read())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps" and node.args and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(script)


@pytest.mark.cuda
def test_schedule_drivers_print_the_jax_keys_on_card(cuda_device, monkeypatch, capsys):
    """bench_pair and bench_unroll at 256 channels: the JAX scripts' keys,
    parity bit for bit, the card's name and power limit."""
    import json

    from rtlsdr_airband_tpu_torch.scripts import bench_pair, bench_unroll

    for k, v in (("BENCH_PAIR_CHANNELS", "256"), ("BENCH_PAIR_K", "2"), ("BENCH_CHANNELS", "256"), ("BENCH_UNROLLS", "1,4")):
        monkeypatch.setenv(k, v)
    assert bench_pair.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert _jax_line_keys("scripts/bench_pair.py") <= line.keys() and line["parity"]["bit_for_bit"] and line["schedule"] == "pair_u1"
    assert line["device"] == torch.cuda.get_device_name(0) and line["ms_pair"] > 0
    assert bench_unroll.main() == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [x["unroll"] for x in lines] == [1, 4] and all(x["equal_to_default_bit_for_bit"] for x in lines)
    assert all(_jax_line_keys("scripts/bench_unroll.py") <= x.keys() for x in lines)


@pytest.mark.cuda
def test_bench_prints_its_line_on_card(cuda_device, monkeypatch, capsys):
    """scripts/bench.py at 256 channels on the card: K1 once a block, the JSON
    line with the card's name and power limit."""
    import json

    from rtlsdr_airband_tpu_torch.scripts import bench

    for k, v in (("BENCH_CHANNELS", "256"), ("BENCH_BLOCKS", "4"), ("BENCH_REPS", "2")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    before = demod_cuda.LAUNCHES
    assert bench.main() == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert demod_cuda.LAUNCHES - before == 4 * 3  # warm-up and two reps of K = 4
    d = line["detail"]
    assert d["demod_backend"] == "cuda" and d["n_channels"] == 256 and d["block_ms"] > 0 and line["unit"] == "channel-Msps/GPU"
    assert line["device"] == torch.cuda.get_device_name(0) and line["power_limit"].endswith("W")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind, subl, w_trips, links",
    [("chain1", 32, 20, 40), ("chain2", 32, 20, 4), ("chain1w", 64, 20, 40), ("chain2", 1, 7, 40), ("chain1", 32, 2000, 40)],
)
def test_chain_probe_matches_plain_on_card(cuda_device, kind, subl, w_trips, links):
    """Both rows, every element, bit for bit; the last case is the probe's
    own W and L; SUBL = 1 is two 64-thread blocks."""
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, subl, 128)).astype(np.float32)).to(cuda_device)
    before = probe.LAUNCHES
    got = probe.chain_probe(x, kind, w_trips, links)
    assert probe.LAUNCHES == before + 1
    want = probe.chain_probe_plain(x, kind, w_trips, links)
    torch.cuda.synchronize()
    assert got.shape == x.shape and torch.equal(got, want)
    assert torch.equal(got[1], x[1]) == (kind != "chain2")


@pytest.mark.cuda
def test_chain_probe_rejects_what_the_kernel_does_not_take(cuda_device):
    before = probe.LAUNCHES
    with pytest.raises(ValueError, match="contiguous"):
        probe.chain_probe(torch.zeros(2, 128, 32, device=cuda_device).transpose(1, 2), "chain1", 5)
    with pytest.raises(ValueError, match="compiled"):
        probe.chain_probe(torch.zeros(2, 32, 128, device=cuda_device), "chain1", 5, links=7)
    assert probe.LAUNCHES == before


def _card_stream(specs, wave_rate, n_blocks):
    """A u8 stream of ``n_blocks`` blocks after priming: AM carriers on three
    channels, gated off for the middle third, over noise."""
    hop = int(round(FS / wave_rate))
    n = 100 * hop + n_blocks * (wave_rate // 8) * hop + N
    z = complex_noise(n, 0.01, 3)
    gate = np.ones(n, np.float32)
    gate[n // 3 : 2 * n // 3] = 0.0
    for i in (0, 1, 4):
        z += gate * am_carrier_iq(FS, specs[i].frequency - CENTER, n, carrier_ampl=0.3)
    return to_u8(z)


@pytest.mark.cuda
def test_pipeline_chunked_async_equals_single_block_on_card(cuda_device):
    """C = 130, W = 257: chunk_blocks=4 with async_depth=1 (outputs fetched
    on the copy stream behind the next chunk) equals chunk_blocks=1 with
    async_depth=0 in every yielded key, bit for bit, and K1 ran once a
    block."""
    specs = [ChannelSpec(**k) for k in spec_population(130)]
    wave_rate = 8 * 257
    raw = _card_stream(specs, wave_rate, n_blocks=10)
    runs = {}
    for chunk, depth in ((1, 0), (4, 1)):
        cfg = PipelineConfig(sample_rate=FS, center_freq=CENTER, wave_rate=wave_rate, sample_format="u8",
                             fullscale=127.5, chunk_blocks=chunk, async_depth=depth, fetch_open_flags=True)
        p = Pipeline(cfg, specs)
        before = demod_cuda.LAUNCHES
        runs[chunk] = feed_all(p, raw, 200_000)
        assert demod_cuda.LAUNCHES - before == p.blocks_processed == len(runs[chunk]) >= 9
    assert any(o["active"].any() for o in runs[1])
    for i, (a, b) in enumerate(zip(runs[1], runs[4])):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), f"block {i} {k}"


@pytest.mark.cuda
def test_pipeline_launches_k1_once_a_block(cuda_device):
    """The production fetch economy on the card: K1 launches equal the
    blocks processed, the state stays on the card, every block has finite
    audio."""
    specs = [ChannelSpec(**k) for k in spec_population(130)]
    cfg = PipelineConfig(sample_rate=FS, center_freq=CENTER, wave_rate=16000, sample_format="u8", fullscale=127.5,
                         chunk_blocks=2, async_depth=1, active_slots=16, fetch_audio_fmt="i8bf",
                         suppress_fade_tails=True, fetch_meta_per_chunk=True)
    p = Pipeline(cfg, specs)
    p.warm()
    before = demod_cuda.LAUNCHES
    outs = feed_all(p, _card_stream(specs, 16000, n_blocks=5), 200_000)
    assert demod_cuda.LAUNCHES - before == p.blocks_processed == len(outs) == 5
    assert p.state.noise_floor.device.type == "cuda" and p.cfg.demod_backend == "cuda"
    for o in outs:
        assert o["audio"].shape == (2000, 130) and np.isfinite(o["audio"]).all()


@pytest.mark.cuda
def test_channelize_fft_reaches_the_bar_on_card(cuda_device):
    """cuFFT in complex64 against the float64 DFT at the bins: >= 80 dB."""
    rng = np.random.default_rng(11)
    W, hop, C = 500, 160, 1024
    x = rng.normal(0, 0.3, (block_input_len(W, hop, N), 2)).astype(np.float32)
    bins = rng.integers(0, N, C).astype(np.int32)
    window = blackman_harris_7(N)
    m, iq = channelize_fft(torch.from_numpy(x).to(cuda_device), torch.from_numpy(bins).to(cuda_device),
                           torch.from_numpy(window).to(cuda_device), hop=hop, fft_size=N, n_frames=W)
    assert m.device.type == "cuda"
    assert_channelizer_close(m.cpu(), iq.cpu(), dft_at_bins(x, bins, window, hop=hop, fft_size=N, n_frames=W), "cuFFT")


def file_device(path, channels: str, centerfreq: str = "120.0") -> str:
    """A libconfig ``file`` device block reading u8 at FS, unpaced."""
    return (f'{{ type = "file"; filepath = "{path}"; sample_format = "u8"; sample_rate = {FS}; '
            f"centerfreq = {centerfreq}; speedup_factor = 0.0; channels: ( {channels} ); }}")


def population_channels(C: int, port: int) -> str:
    """libconfig channels for spec_population(C), each with a udp_stream sink
    to ``port``."""
    out = []
    for kw in spec_population(C):
        opts = [f"freq = {kw['frequency']}", f'modulation = "{kw["modulation"]}"']
        if "bandwidth" in kw:  # an int is Hz (a float would be MHz)
            opts.append(f"bandwidth = {int(kw['bandwidth'])}")
        for key, conf in (("notch", "notch"), ("ctcss", "ctcss"), ("squelch_threshold_dbfs", "squelch_threshold"),
                          ("ampfactor", "ampfactor")):
            if key in kw:
                opts.append(f"{conf} = {float(kw[key])}")
        opts.append(f'outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {port}; }} )')
        out.append("{ " + "; ".join(opts) + "; }")
    return ", ".join(out)


def population_u8(path, C: int, secs: float, seed: int = 3) -> None:
    """AM carriers on channels 0, 1 and 4 of spec_population(C), gated off
    for the middle third, over noise, as a u8 file centred on CENTER."""
    n = int(FS * secs)
    z = complex_noise(n, 0.01, seed)
    gate = np.ones(n, np.float32)
    gate[n // 3 : 2 * n // 3] = 0.0
    for i in (0, 1, 4):
        z += gate * am_carrier_iq(FS, spec_population(C)[i]["frequency"] - CENTER, n, carrier_ampl=0.3)
    with open(path, "wb") as fh:
        fh.write(to_u8(z))


def _app_config(paths, C, extra=""):
    devs = ", ".join(file_device(p, population_channels(C, 57400 + i)) for i, p in enumerate(paths))
    return (f"fft_size = 512;\nwave_rate = 16000;\nblocks_per_dispatch = 4;\nactive_fetch_slots = 32;\n"
            f'fetch_audio_fmt = "i8bf";\nsuppress_fade_tails = true;\nfetch_meta_per_chunk = true;\n{extra}devices: ( {devs} );\n')


def _recording_app(text):
    """An App on the card whose handled blocks are kept per device."""
    app = App(loads_config(text))
    blocks = {rt.stats.index: [] for rt in app.devices}
    handle = app._handle_block

    def record(rt, out):
        blocks[rt.stats.index].append({k: np.array(v) for k, v in out.items()})
        handle(rt, out)

    app._handle_block = record
    return app, blocks


@pytest.mark.cuda
def test_app_launches_k1_once_a_block(cuda_device, tmp_path):
    """App from a libconfig file at C = 130 on the card: K1 launches equal
    the blocks processed and handled, every block finite, squelch opens."""
    iq = tmp_path / "iq.cu8"
    population_u8(iq, 130, secs=1.6)
    app, blocks = _recording_app(_app_config([iq], 130))
    p = app.devices[0].pipeline
    assert p.device.type == "cuda" and p.cfg.demod_backend == "cuda"
    want = [ChannelSpec(**dict(k, has_iq_outputs=False)) for k in spec_population(130)]
    assert [vars(x) for x in p.specs] == [vars(x) for x in want]
    p.warm()
    before = demod_cuda.LAUNCHES
    drive_app(app)
    outs = blocks[0]
    assert demod_cuda.LAUNCHES - before == p.blocks_processed == len(outs) >= 10
    assert all(o["audio"].shape == (2000, 130) and np.isfinite(o["audio"]).all() for o in outs)
    assert max(int(o["active"].sum()) for o in outs) > 0
    assert p.gather_overflow_count == 0


@pytest.mark.cuda
def test_app_multiple_demod_threads_equal_one_thread_on_card(cuda_device, tmp_path):
    """Two devices with multiple_demod_threads: each device's pipeline is fed
    on its own worker thread and flushed on the main thread (each Pipeline
    runs on its own stream); every handled block equals the single-threaded
    run's bit for bit."""
    paths = [tmp_path / "a.cu8", tmp_path / "b.cu8"]
    for i, path in enumerate(paths):
        population_u8(path, 65, secs=1.6, seed=3 + i)
    runs = {}
    for mdt in ("false", "true"):
        app, blocks = _recording_app(_app_config(paths, 65, f"multiple_demod_threads = {mdt};\n"))
        drive_app(app)
        assert all(rt.pipeline.blocks_processed == len(blocks[rt.stats.index]) >= 10 for rt in app.devices)
        runs[mdt] = blocks
    for di in (0, 1):
        assert len(runs["true"][di]) == len(runs["false"][di])
        for k, (a, b) in enumerate(zip(runs["false"][di], runs["true"][di])):
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), f"device {di} block {k} {key}"


@pytest.mark.cuda
def test_app_mesh_devices_raises_on_card(cuda_device, tmp_path):
    """mesh_devices beyond the distinct GPUs present: App raises rather than
    repeating a GPU in its mesh."""
    iq = tmp_path / "iq.cu8"
    population_u8(iq, 8, secs=0.3)
    n = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"mesh_devices = {n} but only {n - 1} GPU"):
        App(loads_config(_app_config([iq], 8, f"mesh_devices = {n};\n")))


def _mesh_runs(devices, C=130):
    """The chained mesh Pipeline on ``devices`` (chunk 4, one chunk in
    flight, flags fetched) and the single-device one (chunk 1), on one u8
    stream: (mesh pipeline, its blocks, K1 launches a block, reference
    blocks)."""
    from rtlsdr_airband_tpu_torch.parallel.sharding import make_pipeline_mesh

    specs = [ChannelSpec(**k) for k in spec_population(C)]
    wave_rate = 8 * 256
    raw = _card_stream(specs, wave_rate, n_blocks=8)
    base = dict(sample_rate=FS, center_freq=CENTER, wave_rate=wave_rate, sample_format="u8", fullscale=127.5, fetch_open_flags=True)
    ref = feed_all(Pipeline(PipelineConfig(**base), specs), raw, 200_000)
    p = Pipeline(PipelineConfig(**base, chunk_blocks=4, async_depth=1, mesh=make_pipeline_mesh(devices)), specs)
    before = demod_cuda.LAUNCHES
    got = feed_all(p, raw, 200_000)
    return p, got, (demod_cuda.LAUNCHES - before) / max(1, p.blocks_processed), ref


def _assert_blocks_equal(ref, got):
    assert len(ref) == len(got) >= 7 and any(o["active"].any() for o in ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), f"block {i} {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 130])
def test_mesh_pipeline_on_one_card_equals_single(cuda_device, C):
    """A 2x2 mesh of one card ([cuda:0] * 4, each cell on its own stream),
    K1 launched once a channel shard a block.  C = 128: every yielded key
    bit for bit as the single-device Pipeline's.  C = 130, padded to 132:
    the matched filter's GEMM is 132 columns wide on the mesh and 130 on one
    device, and cuBLAS rounds the two otherwise (ROADMAP H12), so the
    parity bars hold: audio within 1e-4; IQ and the levels, which scale
    with the carrier (IQ reaches tens here, where 1e-4 is tens of ulps),
    within 1e-4 of max(1, |value|), as the Goertzel accumulators are held;
    flags, active and the int counters exact."""
    p, got, per_block, ref = _mesh_runs([torch.device("cuda", 0)] * 4, C)
    assert p.C_dev == -(-C // 4) * 4 and p.mesh.shape == {"time": 2, "chan": 2} and per_block == 4
    assert all(s.noise_floor.device.type == "cuda" for s in p.state)
    if C % 4 == 0:
        _assert_blocks_equal(ref, got)
        return
    assert len(ref) == len(got) >= 7 and any(o["active"].any() for o in ref)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert a.keys() == b.keys()
        for k in a:
            if a[k].dtype.kind == "f":
                scale = 1.0 if k == "audio" else np.maximum(1.0, np.abs(a[k]))
                err = (np.abs(a[k] - b[k]) / scale).max()
                assert err <= 1e-4, f"block {i} {k}: {err:.3e}"
            else:
                assert np.array_equal(a[k], b[k]), f"block {i} {k}"


@pytest.mark.cuda
def test_mesh_pipeline_over_distinct_gpus_equals_single(cuda_device):
    """The mesh over two or more distinct GPUs (the shards' copies cross
    devices), C = 128 (no pad, see the test above): bit for bit as one
    device."""
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two or more GPUs")
    p, got, per_block, ref = _mesh_runs([torch.device("cuda", i) for i in range(n)], C=128)
    assert per_block == n and {s.noise_floor.device.index for s in p.state} == set(range(n))
    _assert_blocks_equal(ref, got)
