"""The port's App with its control loops, against the JAX App on the same u8
file, on the CPU: scan mode hopping (the port's first test of
``Pipeline.retune``), AFC moving a channel's bin mid-stream
(``Pipeline.set_bins``, as tests/golden/e2e_ref.py::run_tpu_afc drives the
JAX side), and the fetch economy shifting rungs (``Pipeline.apply_rung``,
``warm_async``)."""

import numpy as np

from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.runtime.config import loads_config
from rtlsdr_airband_tpu_torch.utils.siggen import am_carrier_iq, complex_noise
from torch_app_common import assert_f32_close, parity_apps, udp_receiver, udp_received
from torch_port_common import FS, to_u8, write_am_u8


def _tracking(tracks: list, clock_step: float = 0.0):
    """App setup: each App gets a list in ``tracks`` recording its retunes
    (new center, the scan's frequency index) and set_bins calls (user-order
    bins), and its clock advances ``clock_step`` a handled block, so the
    scan controller's 200 ms checks follow the blocks, not the wall (as
    tests/test_app.py drives the scan clock by hand)."""

    def setup(app):
        rt, track = app.devices[0], []
        tracks.append(track)
        retune, set_bins, handle = rt.pipeline.retune, rt.pipeline.set_bins, app._handle_block

        def on_retune(specs, center_freq=None):
            track.append(("retune", center_freq, rt.channels[0].freq_idx))
            retune(specs, center_freq=center_freq)

        def on_set_bins(bins):
            track.append(("bins", [int(b) for b in bins]))
            set_bins(bins)

        def on_block(r, out):
            handle(r, out)
            app._clock.t += clock_step

        rt.pipeline.retune, rt.pipeline.set_bins, app._handle_block = on_retune, on_set_bins, on_block

    return setup


def test_scan_mode_hops(tmp_path, monkeypatch):
    """Scan mode over two frequencies: both Apps hop on the same blocks to
    the same centers (channelizer inputs and bins equal call for call), and
    the first hop reaches the second frequency."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=4.0, freq_off=0)

    def cfg(tag):
        return f'''
fft_size = 512;
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 121.5; mode = "scan"; speedup_factor = 0.0;
  channels: ({{
    freqs = ( 118.0, 121.5 );
    outputs: ( {{ type = "file"; directory = "{tmp_path}/outs_{tag}"; filename_template = "scan"; include_freq = true; }} );
  }});
}});
'''

    tracks = []
    jax_app, app = parity_apps(monkeypatch, cfg("jax"), cfg("port"), setup=_tracking(tracks, clock_step=0.25))
    jax_track, track = tracks
    assert track == jax_track and track, tracks
    assert track[0][0] == "retune" and track[0][2] == 1, "scan never hopped to the second frequency"
    assert app.devices[0].scan.st.freq_idx == jax_app.devices[0].scan.st.freq_idx
    assert app.devices[0].pipeline.cfg.center_freq == jax_app.devices[0].pipeline.cfg.center_freq


def _afc_scene(path, secs=3.0):
    """An AM carrier 3.2 kHz above the AFC channel's frequency (120.4 MHz),
    keyed on from 25 % to 80 % of the file, and an on-bin AM carrier at
    120.1 MHz throughout, over noise."""
    n = int(FS * secs)
    tone = np.sin(2 * np.pi * 500.0 * np.arange(int(8000 * secs)) / 8000)
    gate = np.zeros(n, np.float32)
    gate[int(0.25 * n) : int(0.8 * n)] = 1.0
    z = gate * am_carrier_iq(FS, 403_200, n, audio=tone, carrier_ampl=0.3, audio_rate=8000)
    z = z + am_carrier_iq(FS, 100_000, n, carrier_ampl=0.2) + complex_noise(n, 0.01, 4)
    with open(path, "wb") as fh:
        fh.write(to_u8(z))


def test_afc_moves_the_bin_mid_stream(tmp_path, monkeypatch):
    """AFC (afc = 4) on a channel whose carrier sits 3.2 kHz off its bin: on
    the opening edge both Apps move it to the same bin (Pipeline.set_bins)
    and back when it closes; the channelizer sees the same bins call for
    call, and the AFC channel's UDP audio equals the JAX App's within 1e-4."""
    iq = tmp_path / "iq.bin"
    _afc_scene(iq)
    rxs = [udp_receiver(), udp_receiver()]

    def cfg(rx):
        port = rx.getsockname()[1]
        return f'''
fft_size = 512;
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: (
    {{ freq = 120.4; afc = 4;
       outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {port}; }} ); }},
    {{ freq = 120.1;
       outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 57320; }} ); }}
  );
}});
'''

    tracks = []
    jax_app, app = parity_apps(monkeypatch, cfg(rxs[0]), cfg(rxs[1]), setup=_tracking(tracks))
    jax_track, track = tracks
    assert track == jax_track, tracks
    base = int(app.devices[0].pipeline.base_bins[0])
    moved = [b[0] for kind, b in track if kind == "bins"]
    assert moved and moved[0] != base and moved[-1] == base, (base, track)
    assert app.devices[0].channels[0].afc is not None
    want, got = (udp_received(rx) for rx in rxs)
    assert_f32_close(want, got, "AFC channel UDP audio")


def test_app_attaches_economy_and_shifts(tmp_path):
    """fetch_economy = 'auto' attaches a controller to gather-mode devices;
    a sustained over-budget observation stream shifts the pipeline's live
    fetch knobs (apply_rung) and warms the neighbours (warm_async)."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=0.3)
    cfg = loads_config(
        f'active_fetch_slots = 4; fetch_audio_fmt = "i16"; fetch_economy = "auto";\n'
        f'devices: ( {{ type = "file"; filepath = "{iq}"; sample_format = "u8"; '
        'sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0; '
        'channels: ( { freq = 120.4; outputs: ( { type = "udp_stream"; '
        'dest_address = "127.0.0.1"; dest_port = 4102; } ); } ); } );'
    )
    app = App(cfg, device="cpu")
    rt = app.devices[0]
    assert rt.economy is not None
    assert rt.pipeline.cfg.active_slots == 4 and rt.pipeline.cfg.audio_fmt == "i16"
    for _ in range(30):
        app._observe_economy(rt, 400.0)
    assert rt.pipeline.cfg.audio_fmt == "i8bf"
    assert rt.economy.shift_count >= 1
    rt.pipeline.close()
