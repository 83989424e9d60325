"""The port's mesh (``rtlsdr_airband_tpu_torch.parallel.sharding``) on meshes
of CPU cells, 1x2, 2x2 and 2x4, the counterparts of tests/test_sharding.py:
the time-sharded overlap-save channelizer and the sharded block step (the
reshard to channel shards, the demod once per shard) equal the port's
single-device path bit for bit, and the JAX package's mesh (the 2x4 mesh of
conftest.py's 8 virtual CPU devices) at the JAX tests' bars.

Against JAX the two block programs share one channelizer output, as in
tests/test_torch_pipeline.py: the JAX mesh's time-sharded channelizer
output for the block is handed to the port's time shards, row block by row
block, after the port's own rows are held to it at the channelizer's bar
(>= 80 dB SNR; torch and XLA round their CPU GEMMs differently, up to 2e-5
absolute on these scenes, so the JAX tests' 1e-6 bar, which compares XLA
with itself, does not apply across frameworks).  Both demods then start
from the JAX package's params and state."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import rtlsdr_airband_tpu.parallel.sharding as jsh
import rtlsdr_airband_tpu_torch.parallel.sharding as sh
import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu.models.flagship import build_flagship as jax_build_flagship
from rtlsdr_airband_tpu.models.flagship import build_flagship_stream as jax_build_flagship_stream
from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.models.flagship import build_flagship, build_flagship_stream
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.runtime.pipeline import channelize_block, pipeline_block
from torch_port_common import assert_bitwise, assert_channelizer_close, jax_flat

MESHES = {"1x2": 2, "2x2": 4, "2x4": 8}
INT_STATE = ("cur", "nxt", "delay", "low_signal_count", "sample_count",
             "open_count", "flappy_count", "recent_open_count", "closed_sample_count")
BANK_INT = [f"{b}.{f}" for b in ("fast", "slow") for f in ("count", "enough", "has_tone", "found", "not_found")]
KW = ("hop", "fft_size", "n_frames", "fm_quadri", "with_ctcss")


@pytest.fixture(params=list(MESHES), ids=list(MESHES))
def mesh(request):
    return sh.make_pipeline_mesh(["cpu"] * MESHES[request.param])


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jsh.make_pipeline_mesh(jax.devices()[:8])


def _step(mesh, kw):
    return sh.make_sharded_pipeline_step(mesh, **{k: kw[k] for k in KW})


def _single(x, bins, window, params, state, kw):
    return pipeline_block(x, bins, window, params, state, **{k: kw[k] for k in KW})


class JaxRows:
    """Hands the JAX mesh's channelizer rows to the port's time shards: each
    call of the port's channelizer (one a time shard, in order) computes its
    own rows, holds them to the JAX rows at the channelizer's bar, and
    returns the JAX rows."""

    def __init__(self, monkeypatch):
        self.queue = []
        monkeypatch.setattr(sh, "channelize_matmul", self._replay)

    def push(self, mags, iqs, T):
        w = mags.shape[0] // T
        self.queue += [(mags[t * w : (t + 1) * w], iqs[t * w : (t + 1) * w]) for t in range(T)]

    def _replay(self, x, bins, window, **kw):
        m, z = port_pipeline.channelize_matmul(x, bins, window, **kw)
        jm, jz = self.queue.pop(0)
        assert_channelizer_close(m, z, jz[..., 0] + 1j * jz[..., 1].astype(np.float64), "port time shard against jax")
        return torch.from_numpy(jm.copy()), torch.from_numpy(jz.copy())


def _assert_jax_bars(st_shards, audio, iq, active, want, label):
    """tests/test_sharding.py's bars against a JAX mesh block ``want`` (flat
    state, audio, iq, active): audio and IQ to rtol 1e-5 / atol 1e-6,
    active and int/bool state exact, the noise floor to rtol 1e-6."""
    jst, jaudio, jiq, jactive = want
    np.testing.assert_allclose(audio.numpy(), jaudio, rtol=1e-5, atol=1e-6, err_msg=f"{label}: audio")
    np.testing.assert_allclose(iq.numpy(), jiq, rtol=1e-5, atol=1e-6, err_msg=f"{label}: iq")
    np.testing.assert_array_equal(active.numpy(), jactive, err_msg=f"{label}: active")
    got = interop.sharded_to_numpy(st_shards)
    for name in INT_STATE + tuple(BANK_INT):
        np.testing.assert_array_equal(got[name], jst[name], err_msg=f"{label}: {name}")
    np.testing.assert_allclose(got["noise_floor"], jst["noise_floor"], rtol=1e-6, err_msg=f"{label}: noise_floor")


def _jax_run(jax_mesh, jkw, jparams, jstate, blocks):
    """The JAX mesh step over ``blocks`` ((x, bins) pairs) with the state
    carried, and the JAX mesh channelizer's rows for each: per block
    (flat state, audio, iq, active) and (mags, iqs), as numpy arrays."""
    jstep = jsh.make_sharded_pipeline_step(jax_mesh, **{k: jkw[k] for k in KW})
    jchan = jax.jit(functools.partial(jsh.channelize_time_sharded, jax_mesh, hop=jkw["hop"], fft_size=jkw["fft_size"],
                                      n_frames=jkw["n_frames"]))
    rep = functools.partial(jsh.replicate, jax_mesh)
    jps, jst = jsh.shard_last(jax_mesh, jparams), jsh.shard_last(jax_mesh, jstate)
    outs, rows = [], []
    for jx, jb in blocks:
        xs, bs, ws = rep(jx), rep(jax.numpy.asarray(jb)), rep(jkw["window"])
        jst, audio, iq, act = jstep(xs, bs, ws, jps, jst)
        outs.append((jax_flat(jst), np.asarray(audio), np.asarray(iq), np.asarray(act)))
        rows.append(tuple(np.asarray(a) for a in jchan(xs, bs, ws)))
    return outs, rows


def _port_inputs(jparams, jstate):
    return (interop.params_from_numpy({k: np.asarray(v) for k, v in jparams._asdict().items()}, device="cpu"),
            interop.state_from_numpy(jax_flat(jstate), device="cpu"))


@pytest.fixture(scope="module")
def jax_flagship(jax_mesh):
    """The JAX mesh on build_flagship(16, W = 128): one input, three blocks
    with the state carried (as tests/test_sharding.py runs it)."""
    jkw, (jx, jbins, jwin, jparams, jstate) = jax_build_flagship(n_channels=16, wave_batch=128)
    outs, rows = _jax_run(jax_mesh, dict(jkw, window=jwin), jparams, jstate, [(jx, jbins)] * 3)
    return dict(x=torch.from_numpy(np.array(jx)), inputs=_port_inputs(jparams, jstate), outs=outs, rows=rows)


@pytest.fixture(scope="module")
def jax_scene(jax_mesh):
    """The JAX mesh on build_flagship_stream(16, 12 blocks), a quiet channel
    retuned onto the AM carrier's bin from block 4."""
    jkw, jbins, jwin, jparams, jstate, jxbl, hot = jax_build_flagship_stream(n_channels=16, n_blocks=12)
    quiet = next(i for i in range(16) if i not in hot)
    bins2 = np.asarray(jbins).copy()
    bins2[quiet] = np.asarray(jbins)[hot[0]]
    blocks = [(jx, np.asarray(jbins) if k < 4 else bins2) for k, jx in enumerate(jxbl)]
    outs, rows = _jax_run(jax_mesh, dict(jkw, window=jwin), jparams, jstate, blocks)
    return dict(blocks=[(torch.from_numpy(np.array(x)), torch.from_numpy(b)) for x, b in blocks], hot=hot,
                inputs=_port_inputs(jparams, jstate), outs=outs, rows=rows)


@pytest.mark.parametrize("n, shape", [(2, {"time": 1, "chan": 2}), (4, {"time": 2, "chan": 2}), (8, {"time": 2, "chan": 4})])
def test_mesh_shape(n, shape, jax_mesh):
    """The JAX default: 2 time shards from 4 devices on; channel shards hold
    the blocks of channels JAX's P(None, pick_channel_axes) gives each
    device."""
    mesh = sh.make_pipeline_mesh(["cpu"] * n)
    jmesh = jsh.make_pipeline_mesh(jax.devices()[:n])
    assert mesh.shape == shape == dict(jmesh.shape) and mesh.size == n
    assert mesh.cells == [torch.device("cpu")] * n
    flat = list(np.asarray(jmesh.devices).ravel())
    for C in (16, 8, 6, 3, 1):
        axes = sh.pick_channel_axes(mesh, C)
        assert axes == jsh.pick_channel_axes(jmesh, C), C
        held = {d: idx[1] for d, idx in NamedSharding(jmesh, P(None, axes or None)).devices_indices_map((4, C)).items()}
        layout = sh.channel_layout(mesh, C)
        for cell, sl in layout:
            got = held[flat[cell]]
            assert (got.start or 0, got.stop if got.stop is not None else C) == (sl.start, sl.stop), (C, cell)
        assert sorted((s.start, s.stop) for _, s in layout) == sorted({(s.start or 0, s.stop or C) for s in held.values()})


def test_time_sharded_channelizer_matches_unsharded(mesh, jax_flagship):
    W, C = 128, 16
    block, x, _ = build_flagship(n_channels=C, wave_batch=W, device="cpu")
    kw = block.block_kwargs
    hop, N = kw["hop"], kw["fft_size"]
    m_ref, z_ref = channelize_block(x, block.bins, block.window, hop=hop, fft_size=N, n_frames=W)
    m_sh, z_sh = sh.channelize_time_sharded(mesh, x, block.bins, block.window, hop=hop, fft_size=N, n_frames=W)
    assert torch.equal(m_sh, m_ref) and torch.equal(z_sh, z_ref)
    # the parts: one row block a time shard
    body, tail = sh.split_block(mesh, x, hop=hop, n_frames=W)
    parts, zparts = sh.channelize_time_sharded_parts(mesh, body, tail, block.bins, block.window, hop=hop, fft_size=N, n_frames=W)
    assert len(parts) == mesh.shape["time"] and torch.equal(torch.cat(parts), m_ref) and torch.equal(torch.cat(zparts), z_ref)
    # precomputed taps, as one (re, im) pair or one a cell (replicate)
    taps = (block.taps_re, block.taps_im)
    for tp in (taps, sh.replicate(mesh, taps)):
        parts, _ = sh.channelize_time_sharded_parts(mesh, body, tail, None, None, hop=hop, fft_size=N, n_frames=W, taps=tp)
        assert torch.equal(torch.cat(parts), m_ref)

    assert torch.equal(jax_flagship["x"], x)
    jz = jax_flagship["rows"][0][1]
    assert_channelizer_close(m_sh, z_sh, jz[..., 0] + 1j * jz[..., 1].astype(np.float64), "port mesh against jax mesh")


def test_sharded_step_matches_unsharded_pipeline(mesh, jax_flagship, monkeypatch):
    W, C = 128, 16
    block, x, state = build_flagship(n_channels=C, wave_batch=W, device="cpu")
    kw = block.block_kwargs
    step = _step(mesh, kw)
    got = step(x, block.bins, block.window, sh.shard_last(mesh, block.params), sh.shard_last(mesh, state))
    assert len(got[0]) == len(sh.channel_layout(mesh, C))
    want = _single(x, block.bins, block.window, block.params, state, kw)
    assert_bitwise((want[0], want[1]["audio"], want[1]["iq_out"], want[1]["active"]),
                   (sh.gather_last(mesh, got[0]), got[1], got[2], got[3]), "mesh step against one device")

    # against the JAX mesh, on the JAX package's params, state and channelizer rows
    rows = JaxRows(monkeypatch)
    rows.push(*jax_flagship["rows"][0], mesh.shape["time"])
    params, st = jax_flagship["inputs"]
    got = step(jax_flagship["x"], block.bins, block.window, sh.shard_last(mesh, params), sh.shard_last(mesh, st))
    assert not rows.queue
    _assert_jax_bars(*got, jax_flagship["outs"][0], "mesh step against the jax mesh")


def test_sharded_active_scene_opens_closes_and_retunes(mesh, jax_scene, monkeypatch):
    """Squelch opens and closes across the reshard with carriers in
    different channel shards (plain AM, NFM+CTCSS, filtered AM), a
    mid-stream retune (new bins, same step), K1's host build running once a
    channel shard; bit for bit against one device and within the JAX bars
    of the JAX mesh on every block."""
    launches = []

    def host_k1(*a, **k):
        launches.append(a[2].shape[1])
        return demod_cuda.demod_block_host(*a, **k)

    monkeypatch.setattr(port_pipeline, "demod_block_cuda", host_k1)
    C, K = 16, 12
    block, state, xbl, hot = build_flagship_stream(C, n_blocks=K, device="cpu")
    kw = block.block_kwargs
    step = _step(mesh, kw)
    ps, st_sh, st_ref = sh.shard_last(mesh, block.params), sh.shard_last(mesh, state), state
    quiet = next(i for i in range(C) if i not in hot)
    bins2 = block.bins.clone()
    bins2[quiet] = block.bins[hot[0]]
    shards = len(sh.channel_layout(mesh, C))

    ever_active = np.zeros(C, bool)
    outs = []
    for k, x in enumerate(xbl):
        b = block.bins if k < 4 else bins2
        got = step(x, b, block.window, ps, st_sh)
        st_ref, out = _single(x, b, block.window, block.params, st_ref, kw)
        assert_bitwise((st_ref, out["audio"], out["iq_out"], out["active"]),
                       (sh.gather_last(mesh, got[0]), got[1], got[2], got[3]), f"block {k}")
        st_sh = got[0]
        outs.append(got)
        ever_active |= got[3].numpy()
    assert launches == ([C // shards] * shards + [C]) * K  # K1 once a channel shard (then once on one device)
    assert ever_active[hot].all(), (hot, np.flatnonzero(ever_active))
    assert ever_active[quiet]
    shard_of = np.flatnonzero(ever_active) // (C // mesh.shape["chan"])
    assert len(set(shard_of.tolist())) >= min(3, mesh.shape["chan"]), shard_of
    assert int(st_ref.open_count[hot[0]]) >= 1 and int(st_ref.cur[hot[0]]) == 0  # CLOSED again after the gate-off

    # against the JAX mesh: the JAX package's scene, params, state and rows
    assert jax_scene["hot"] == hot
    rows = JaxRows(monkeypatch)
    params, st = jax_scene["inputs"]
    ps, st = sh.shard_last(mesh, params), sh.shard_last(mesh, st)
    for k, ((x, b), want, r) in enumerate(zip(jax_scene["blocks"], jax_scene["outs"], jax_scene["rows"])):
        rows.push(*r, mesh.shape["time"])
        st, audio, iq, act = step(x, b, block.window, ps, st)
        _assert_jax_bars(st, audio, iq, act, want, f"block {k} against the jax mesh")


def test_sharded_step_multi_block_state_carry(mesh, jax_flagship, monkeypatch):
    """Three blocks with the state carried, K1's host build once a channel
    shard: bit for bit against one device, within the JAX bars of the JAX
    mesh."""
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    W, C = 128, 16
    block, x, state = build_flagship(n_channels=C, wave_batch=W, device="cpu")
    kw = block.block_kwargs
    step = _step(mesh, kw)
    ps, st, st_ref = sh.shard_last(mesh, block.params), sh.shard_last(mesh, state), state
    for k in range(3):
        st, audio, iq, act = step(x, block.bins, block.window, ps, st)
        st_ref, out = _single(x, block.bins, block.window, block.params, st_ref, kw)
        assert_bitwise((st_ref, out["audio"], out["iq_out"], out["active"]), (sh.gather_last(mesh, st), audio, iq, act), f"block {k}")

    rows = JaxRows(monkeypatch)
    params, st = jax_flagship["inputs"]
    ps, st = sh.shard_last(mesh, params), sh.shard_last(mesh, st)
    for k in range(3):
        rows.push(*jax_flagship["rows"][k], mesh.shape["time"])
        st, audio, iq, act = step(jax_flagship["x"], block.bins, block.window, ps, st)
        _assert_jax_bars(st, audio, iq, act, jax_flagship["outs"][k], f"block {k} against the jax mesh")


def test_sharded_pytrees_round_trip(mesh):
    """shard_last cuts every channel leaf into the layout's blocks (the
    LUTs replicated); gather_last and interop.sharded_to_numpy restore the
    whole tree; replicate gives every cell a copy."""
    block, _, state = build_flagship(n_channels=16, wave_batch=128, device="cpu")
    ps, ss = sh.shard_last(mesh, block.params), sh.shard_last(mesh, state)
    k = len(sh.channel_layout(mesh, 16))
    assert len(ps) == len(ss) == k
    assert all(p.sin_lut.shape == (257,) and p.is_nfm.shape == (16 // k,) for p in ps)
    assert all(s.iq_tail.shape[1:] == (16 // k, 2) and s.fast.q1.shape[1] == 16 // k for s in ss)
    assert_bitwise((state,), (sh.gather_last(mesh, ss),), "state")
    assert interop.sharded_to_numpy(ps).keys() == interop.params_to_numpy(block.params).keys()
    for key, v in interop.sharded_to_numpy(ps).items():
        assert np.array_equal(v, interop.params_to_numpy(block.params)[key]), key
    again = interop.shard_from_numpy(interop.sharded_to_numpy(ss), mesh)
    assert_bitwise((state,), (sh.gather_last(mesh, again),), "numpy round trip")
    reps = sh.replicate(mesh, block.window)
    assert len(reps) == mesh.size and all(torch.equal(r, block.window) for r in reps)
