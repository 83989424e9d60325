"""The port's production multi-device path on meshes of CPU cells, the
counterparts of tests/test_mesh_app.py: ``Pipeline`` with
``PipelineConfig.mesh`` (chained dispatch, the time-sharded channelizer with
its halo exchange, the demod once per channel shard, packed meta, the
active-channel gather) and the ``App`` choosing it by ``mesh_devices``,
held bit for bit against the single-device path; plus
``__graft_entry__.dryrun_multichip``'s contract on the port's App and
checkpoints that load across mesh and single-device pipelines, in both
packages.

The demod runs as K1's host build (``demod_cuda.demod_block_host``, the
kernel's own code built with g++, bit for bit equal to the plain version:
tests/test_torch_demod_tiled.py), once a channel shard.  The port's single
device path is held against the JAX package's by
tests/test_torch_pipeline_parity.py and tests/test_torch_app_*.py, and its
mesh against the JAX mesh by tests/test_torch_sharding.py."""

import time

import numpy as np
import pytest

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec
from rtlsdr_airband_tpu_torch.parallel.sharding import make_pipeline_mesh
from rtlsdr_airband_tpu_torch.runtime.config import loads_config
from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig
from rtlsdr_airband_tpu_torch.utils.siggen import am_carrier_iq, complex_noise
from torch_port_common import to_u8

# small-rate scene so the CPU mesh stays fast: hop=32, W=1000, halo=480
FS, CENTER, WR = 256_000, 120_000_000, 8000
SECONDS = 1.1
MESHES = {"1x2": 2, "2x2": 4, "2x4": 8}
CHECK = ("active", "open_count", "flappy_count", "ctcss_found", "ctcss_not_found", "sig_outside")


@pytest.fixture(autouse=True)
def host_demod(monkeypatch):
    launches = []

    def host_k1(params, state, mags, iqs, **kw):
        launches.append(mags.shape[1])
        return demod_cuda.demod_block_host(params, state, mags, iqs, **kw)

    monkeypatch.setattr(port_pipeline, "demod_block_cuda", host_k1)
    return launches


def _freqs(n):
    return [CENTER - 96_000 + (192_000 // max(1, n - 1)) * i if n > 1 else CENTER + 40_000 for i in range(n)]


@pytest.fixture(scope="module")
def scene_u8():
    """u8 raw stream: AM carriers on channels {0, 3, 6} of 8 (three different
    'chan' shards), the first gated OFF mid-stream so squelch opens AND
    closes across chunk boundaries; channel 5 is NFM with CTCSS."""
    n = int(FS * SECONDS)
    freqs = _freqs(8)
    z = complex_noise(n, 0.01, seed=3)
    gate = np.ones(n, np.float32)
    gate[int(n * 0.5) :] = 0.0
    z += am_carrier_iq(FS, freqs[0] - CENTER, n, carrier_ampl=0.4) * gate
    z += am_carrier_iq(FS, freqs[3] - CENTER, n, carrier_ampl=0.4)
    z += am_carrier_iq(FS, freqs[6] - CENTER, n, carrier_ampl=0.4)
    return to_u8(z)


def _specs():
    freqs = _freqs(8)
    kinds = {5: dict(modulation="nfm", ctcss=100.0), 2: dict(modulation="am", bandwidth=6000.0)}
    return [ChannelSpec(frequency=f, **kinds.get(i, dict(modulation="am"))) for i, f in enumerate(freqs)]


def _run(raw, mesh, chunk, depth=0, slots=0, i16=False, specs=None):
    cfg = PipelineConfig(
        sample_rate=FS, center_freq=CENTER, wave_rate=WR, sample_format="u8", fullscale=127.5,
        chunk_blocks=chunk, async_depth=depth, active_slots=slots, fetch_audio_i16=i16, mesh=mesh, device="cpu",
    )
    p = Pipeline(cfg, specs or _specs())
    outs = []

    def keep(gen):  # slot-mode audio buffers are reused between blocks: copy
        outs.extend({k: np.array(v) for k, v in o.items()} for o in gen)

    for i in range(0, len(raw), 128_000):
        keep(p.feed(raw[i : i + 128_000]))
    keep(p.flush())
    return p, outs


@pytest.fixture(scope="module")
def ref_blocks(scene_u8):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
        return _run(scene_u8, None, chunk=1)[1]


def _assert_equal(ref, got, C=8):
    assert len(ref) == len(got) >= 8
    ever = np.zeros(C, bool)
    for k, (a, b) in enumerate(zip(ref, got)):
        assert a.keys() == b.keys(), k
        for key in a:
            assert a[key].dtype == b[key].dtype and a[key].tobytes() == b[key].tobytes(), f"block {k} {key}"
        ever |= a["active"]
    # the scene opens AND closes across >= 3 chan shards
    assert ever[[0, 3, 6]].all(), ever
    assert not ref[-1]["active"][0]  # the gated-off carrier closed again


@pytest.mark.parametrize("cells", list(MESHES.values()), ids=list(MESHES))
def test_mesh_chain_matches_unsharded(scene_u8, ref_blocks, cells, host_demod):
    """Chained mesh dispatch (k=4, one chunk in flight) == single-block
    single-device dispatch, every key bit for bit; K1 runs once a channel
    shard a block."""
    mesh = make_pipeline_mesh(["cpu"] * cells)
    p, got = _run(scene_u8, mesh, chunk=4, depth=1)
    _assert_equal(ref_blocks, got)
    assert p.C == p.C_dev == 8 and len(p.state) == cells
    assert host_demod == [8 // cells] * (cells * p.blocks_processed)


def test_mesh_chain_active_slots(scene_u8, ref_blocks):
    """Active-channel gather on the mesh: the [W, S] slot fetch, selected
    over the gathered [C] scores, rebuilds the identical dense audio.  S = C,
    so even block 0's 0.5 startup tail (config.cpp:315) fits."""
    p, got = _run(scene_u8, make_pipeline_mesh(["cpu"] * 8), chunk=4, depth=1, slots=8)
    assert len(ref_blocks) == len(got)
    for k, (a, b) in enumerate(zip(ref_blocks, got)):
        for key in ("audio",) + CHECK:
            assert a[key].tobytes() == b[key].tobytes(), f"block {k} {key}"
    assert p.gather_overflow_count == 0


def test_mesh_chain_scarce_slots_prioritize_open(scene_u8, ref_blocks):
    """With S < C the squelch-OPEN channels outrank fade-tail-only ones (the
    stable descending order, H1): the three carriers stay bit for bit in
    every block; only block 0's startup tail on quiet channels overflows."""
    p, got = _run(scene_u8, make_pipeline_mesh(["cpu"] * 8), chunk=4, depth=1, slots=3)
    assert len(ref_blocks) == len(got)
    hot = [0, 3, 6]
    for k, (a, b) in enumerate(zip(ref_blocks, got)):
        if k == 0:
            assert np.array_equal(a["audio"][:, hot], b["audio"][:, hot]), "block 0 hot"
        else:
            assert np.array_equal(a["audio"], b["audio"]), f"block {k}"
    assert p.gather_overflow_count == 5  # 8 startup tails - 3 slots at block 0


@pytest.mark.parametrize("unroll", [1, 2])
def test_mesh_chain_k1_per_channel_shard(scene_u8, ref_blocks, monkeypatch, unroll):
    """The deployment configuration (the JAX package's Pallas kernel under
    shard_map): K1's own code in the default schedule and at unroll 2,
    launched once a channel shard on one-channel shards; every key bit for
    bit."""
    calls = []

    def k1(params, state, mags, iqs, **kw):
        calls.append(mags.shape[1])
        return demod_cuda.demod_block_host(params, state, mags, iqs, unroll=unroll, **kw)

    monkeypatch.setattr(port_pipeline, "demod_block_cuda", k1)
    p, got = _run(scene_u8, make_pipeline_mesh(["cpu"] * 8), chunk=2)
    _assert_equal(ref_blocks, got)
    assert calls == [1] * (8 * p.blocks_processed)


def _app_config(iq, mesh_devices, extra=""):
    chans = ", ".join(
        f'{{ freq = {f}; modulation = "{"nfm" if i == 5 else "am"}";'
        + (" ctcss = 100.0;" if i == 5 else "")
        + (" bandwidth = 6000;" if i == 2 else "")
        + f' outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {23000 + i}; }} ); }}'
        for i, f in enumerate(_freqs(8))
    )
    return loads_config(
        f'fft_size = 512;\nwave_rate = {WR};\nmesh_devices = {mesh_devices};\n{extra}'
        f'blocks_per_dispatch = 2;\n'
        f'devices: ( {{ type = "file"; filepath = "{iq}"; centerfreq = {CENTER}; '
        f'sample_rate = {FS}; sample_format = "u8"; speedup_factor = 0.0; '
        f'channels: ( {chans} ); }} );\n'
    )


def _run_app(cfg):
    app = App(cfg, device="cpu")
    got = []
    orig = app._handle_block

    def record(rt, out):
        got.append((np.array(out["audio"]), np.array(out["active"])))
        orig(rt, out)

    app._handle_block = record
    app.run(max_seconds=120.0)
    return app, got


def test_mesh_app_matches_single_device_app(scene_u8, tmp_path):
    """Full production path: libconfig 'mesh_devices = 8' -> App -> mesh-mode
    Pipeline -> sinks.  Audio and active bit for bit as the single-device
    App's."""
    iq = tmp_path / "scene.cu8"
    iq.write_bytes(scene_u8)
    app1, single = _run_app(_app_config(iq, 0))
    assert app1.mesh is None
    app8, meshed = _run_app(_app_config(iq, 8))
    assert app8.mesh is not None and app8.mesh.size == 8 and app8.mesh.shape == {"time": 2, "chan": 4}
    assert app8.devices[0].pipeline.mesh.cells == app8.mesh.cells
    assert len(single) == len(meshed) >= 4
    ever = np.zeros(8, bool)
    for k, ((a_audio, a_act), (b_audio, b_act)) in enumerate(zip(single, meshed)):
        assert a_audio.tobytes() == b_audio.tobytes(), f"block {k}"
        assert np.array_equal(a_act, b_act), f"block {k}"
        ever |= a_act
    assert ever[[0, 3, 6]].all(), ever


def test_mesh_production_fetch_config(scene_u8, ref_blocks):
    """Active gather + int16 audio on the mesh (what examples/multichip.conf
    prescribes): audio within one int16 step of the dense float32 reference,
    gating and meta bit for bit."""
    p, got = _run(scene_u8, make_pipeline_mesh(["cpu"] * 8), chunk=4, depth=1, slots=8, i16=True)
    assert len(ref_blocks) == len(got)
    for k, (a, b) in enumerate(zip(ref_blocks, got)):
        assert np.array_equal(a["active"], b["active"]), f"block {k}"
        assert np.abs(a["audio"] - b["audio"]).max() <= 1.0 / 32767.0 + 1e-7, f"block {k}"
        for key in ("open_count", "ctcss_found"):
            assert np.array_equal(a[key], b[key]), f"block {k} {key}"
    assert p.gather_overflow_count == 0


@pytest.mark.parametrize("cells", [8, 2], ids=["2x4", "1x2"])
def test_mesh_prime_channel_count_shards_and_matches(scene_u8, cells, host_demod):
    """An indivisible population (7 channels on 8 cells; 7 on 2) is padded on
    the device to a multiple of the cell count with inert channels, so the
    demod still shards over every cell; the pad never reaches an output and
    the blocks equal the single-device path's bit for bit."""
    specs7 = _specs()[:7]
    p1, ref = _run(scene_u8, None, chunk=2, specs=specs7)
    assert p1.C_dev == p1.C == 7
    del host_demod[:]
    p, got = _run(scene_u8, make_pipeline_mesh(["cpu"] * cells), chunk=2, specs=specs7)
    assert p.C == 7 and p.C_dev == 8 and len(p.state) == cells
    assert host_demod == [8 // cells] * (cells * p.blocks_processed)
    assert len(ref) == len(got) >= 4
    ever = np.zeros(7, bool)
    for k, (a, b) in enumerate(zip(ref, got)):
        assert b["audio"].shape[1] == 7
        for key in a:
            assert a[key].tobytes() == b[key].tobytes(), f"block {k} {key}"
        ever |= a["active"]
    assert ever[[0, 3, 6]].all(), ever


def test_mesh_prime_channel_count_with_slots(scene_u8):
    """Active gather over a padded population: pad channels never take a
    slot (not even for block 0's startup tail)."""
    p, got = _run(scene_u8, make_pipeline_mesh(["cpu"] * 8), chunk=2, slots=7, specs=_specs()[:7])
    assert p.gather_overflow_count == 0
    assert any(o["active"].any() for o in got)


def test_mesh_scan_mode_retunes(tmp_path):
    """A scan-mode device on the mesh: each hop calls Pipeline.retune, which
    rebuilds and re-shards params, bins and taps and re-primes the sharded
    state; it behaves as the single-device scan App does under the same
    scan clock."""
    freqs = _freqs(8)
    n = int(FS * 3.0)
    bin_w = FS / 512.0
    z = complex_noise(n, 0.01, seed=9)
    gate = (np.arange(n) >= int(n * (2.0 / 3.0))).astype(np.float32)
    z += am_carrier_iq(FS, -20.0 * bin_w, n, carrier_ampl=0.4) * gate
    iq = tmp_path / "scan_scene.cu8"
    iq.write_bytes(to_u8(z))

    def build(mesh_devices):
        cfg = loads_config(
            f'fft_size = 512;\nwave_rate = {WR};\nmesh_devices = {mesh_devices};\n'
            f'devices: ( {{ type = "file"; filepath = "{iq}"; mode = "scan"; '
            f'sample_rate = {FS}; sample_format = "u8"; speedup_factor = 0.0; channels: ( '
            f'{{ freqs = ( {freqs[1]}, {freqs[3]} ); outputs: ( {{ type = "udp_stream"; '
            f'dest_address = "127.0.0.1"; dest_port = 25011; }} ); }} ); }} );\n'
        )
        app = App(cfg, device="cpu")
        sc = app.devices[0].scan
        t = [time.time()]
        sc._clock = lambda: t[0]
        blocks = []
        orig = app._handle_block

        def record(rt, out):
            blocks.append((np.array(out["audio"]), bool(np.asarray(out["active"])[0])))
            orig(rt, out)

        app._handle_block = record
        return app, sc, t, blocks

    def run(app, t):
        app.start()
        t0 = time.time()
        try:
            while time.time() - t0 < 120:
                t[0] += 0.25  # a fake 250 ms per service tick
                app._service_once()
                if not any(rt.alive for rt in app.devices):
                    break
        finally:
            app.stop()

    app1, sc1, t1, blocks1 = build(0)
    run(app1, t1)
    assert app1.mesh is None and sc1.st.freq_idx == 1, "single-device scan never hopped"
    app8, sc8, t8, blocks8 = build(8)
    assert app8.mesh is not None
    retunes = []
    retune = app8.devices[0].pipeline.retune
    app8.devices[0].pipeline.retune = lambda *a, **k: (retunes.append(a), retune(*a, **k))
    run(app8, t8)
    assert sc8.st.freq_idx == 1 and app8.devices[0].channels[0].freq_idx == 1, "mesh scan never hopped"
    assert retunes and len(app8.devices[0].pipeline.params) == 8
    assert len(blocks1) == len(blocks8) >= 3
    for k, ((a_audio, a_act), (b_audio, b_act)) in enumerate(zip(blocks1, blocks8)):
        # tests/test_mesh_app.py's bar for this test: the lone scan channel
        # is padded to 8 on the mesh, and the CPU's one-column matched
        # filter (a matrix-vector product) rounds otherwise than its
        # 8-column one; gating must be identical
        np.testing.assert_allclose(a_audio, b_audio, atol=1e-6, err_msg=f"block {k}")
        assert a_act == b_act, k
    assert any(act for _, act in blocks1)  # the carrier opened squelch after the hop


def test_dryrun_multichip_contract(tmp_path):
    """__graft_entry__.dryrun_multichip's contract on the port: the same
    8-channel scene (AM carriers on channels 0, 3 and 6, in different channel
    shards; channel 0 gated off mid-stream) through App with mesh_devices = 8
    on CPU cells; audio and active equal a single-device App run bit for bit
    over all 6 blocks, the carriers open and channel 0 closes again."""
    fs, center, wr = 256_000, 120_000_000, 8000
    C, n_blocks = 8, 6
    hop = fs // wr
    n = 100 * hop + n_blocks * 1000 * hop + 512  # prime + blocks + halo
    freqs = [center - 96_000 + 24_000 * i for i in range(C)]
    hot = [0, 3, 6]
    z = complex_noise(n, 0.01, seed=3)
    gate = np.ones(n, np.float32)
    gate[int(n * 0.55) :] = 0.0
    z += am_carrier_iq(fs, freqs[hot[0]] - center, n, carrier_ampl=0.4) * gate
    for ci in hot[1:]:
        z += am_carrier_iq(fs, freqs[ci] - center, n, carrier_ampl=0.4)
    iq = tmp_path / "scene.cu8"
    iq.write_bytes(to_u8(z))
    chans = ", ".join(
        f'{{ freq = {f}; modulation = "am"; outputs: ( {{ type = "udp_stream"; '
        f'dest_address = "127.0.0.1"; dest_port = {24000 + i}; }} ); }}'
        for i, f in enumerate(freqs)
    )

    def make_cfg(mesh_devices):
        return loads_config(
            f'fft_size = 512;\nwave_rate = {wr};\nmesh_devices = {mesh_devices};\n'
            f'blocks_per_dispatch = 2;\n'
            f'devices: ( {{ type = "file"; filepath = "{iq}"; centerfreq = {center}; '
            f'sample_rate = {fs}; sample_format = "u8"; speedup_factor = 0.0; '
            f'channels: ( {chans} ); }} );\n'
        )

    app, blocks = _run_app(make_cfg(8))
    assert app.mesh is not None and app.mesh.size == 8
    assert len(blocks) == n_blocks
    ever = np.zeros(C, bool)
    for audio, act in blocks:
        assert audio.shape == (wr // 8, C) and np.isfinite(audio).all()
        ever |= act
    assert ever[hot].all(), (hot, np.flatnonzero(ever))
    assert len({h // (C // app.mesh.shape["chan"]) for h in hot}) == 3
    assert not blocks[-1][1][hot[0]]  # the gated-off carrier closed again
    app1, single = _run_app(make_cfg(0))
    assert app1.mesh is None and len(single) == len(blocks)
    for k, ((sa, sact), (ma, mact)) in enumerate(zip(single, blocks)):
        assert sa.tobytes() == ma.tobytes(), f"block {k} audio"
        assert np.array_equal(sact, mact), f"block {k} active"


def test_mesh_checkpoints_load_into_each_other(scene_u8, tmp_path, monkeypatch):
    """A mesh checkpoint is the single-device npz (the shards gathered), bit
    for bit; either loads into the other and the stream resumes bit for bit;
    the JAX package's mesh and single-device checkpoints load into the
    port's mesh and save back unchanged, and the port's mesh checkpoint
    loads into a JAX mesh Pipeline, which saves it back unchanged."""
    import jax
    from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
    from rtlsdr_airband_tpu.parallel.sharding import make_pipeline_mesh as jax_mesh
    from rtlsdr_airband_tpu.runtime.pipeline import Pipeline as JaxPipeline
    from rtlsdr_airband_tpu.runtime.pipeline import PipelineConfig as JaxConfig

    half = 2 * (100 * 32 + 4 * 1000 * 32)  # priming + 4 blocks of u8 bytes
    head, rest = scene_u8[:half], scene_u8[half:]
    mesh = make_pipeline_mesh(["cpu"] * 8)

    def pipe(m):
        return Pipeline(PipelineConfig(sample_rate=FS, center_freq=CENTER, wave_rate=WR, sample_format="u8", fullscale=127.5,
                                       mesh=m, device="cpu"), _specs())

    def drain(p, raw):
        outs = []
        for gen in (p.feed(raw), p.flush()):
            outs.extend({k: np.array(v) for k, v in o.items()} for o in gen)
        return outs

    saved = {}
    for name, m in (("mesh", mesh), ("single", None)):
        p = pipe(m)
        drain(p, head)
        p.save_state(tmp_path / f"{name}.npz")
        saved[name] = (p, drain(p, rest))
    a, b = np.load(tmp_path / "mesh.npz"), np.load(tmp_path / "single.npz")
    assert a.files == b.files
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    for src, dst in (("mesh", None), ("single", mesh)):
        p = pipe(dst)
        p.load_state(tmp_path / f"{src}.npz")
        got, want = drain(p, rest), saved[src][1]
        assert len(got) == len(want) > 0
        for k, (x, y) in enumerate(zip(want, got)):
            for key in x:
                assert x[key].tobytes() == y[key].tobytes(), f"{src} -> {'mesh' if dst else 'single'}: block {k} {key}"

    jm = jax_mesh(jax.devices()[:8])
    jspecs = [JaxSpec(**{f: getattr(s, f) for f in ("frequency", "modulation", "bandwidth", "ctcss")}) for s in _specs()]
    jp = JaxPipeline(JaxConfig(sample_rate=FS, center_freq=CENTER, wave_rate=WR, sample_format="u8", fullscale=127.5,
                               mesh=jm, demod_backend="xla"), jspecs)
    list(jp.feed(head))
    list(jp.flush())
    jp.save_state(str(tmp_path / "jax_mesh.npz"))
    p = pipe(mesh)
    p.load_state(tmp_path / "jax_mesh.npz")
    p.save_state(tmp_path / "port_again.npz")
    j, q = np.load(tmp_path / "jax_mesh.npz"), np.load(tmp_path / "port_again.npz")
    assert sorted(j.files) == sorted(q.files)
    for k in j.files:
        assert j[k].dtype == q[k].dtype and j[k].tobytes() == q[k].tobytes(), k
    jp.load_state(str(tmp_path / "mesh.npz"))
    jp.save_state(str(tmp_path / "jax_again.npz"))
    j2 = np.load(tmp_path / "jax_again.npz")
    for k in a.files:
        assert a[k].dtype == j2[k].dtype and a[k].tobytes() == j2[k].tobytes(), k
    # a JAX single-device checkpoint into the port's mesh, and back unchanged
    js = JaxPipeline(JaxConfig(sample_rate=FS, center_freq=CENTER, wave_rate=WR, sample_format="u8", fullscale=127.5,
                               demod_backend="xla"), jspecs)
    list(js.feed(head))
    list(js.flush())
    js.save_state(str(tmp_path / "jax_single.npz"))
    p = pipe(mesh)
    p.load_state(tmp_path / "jax_single.npz")
    p.save_state(tmp_path / "port_mesh_again.npz")
    j, q = np.load(tmp_path / "jax_single.npz"), np.load(tmp_path / "port_mesh_again.npz")
    assert sorted(j.files) == sorted(q.files)
    for k in j.files:
        assert j[k].dtype == q[k].dtype and j[k].tobytes() == q[k].tobytes(), k
