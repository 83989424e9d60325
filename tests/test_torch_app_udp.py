"""The port's App on the CPU with UDP sinks (tests/test_app.py's scenes):
the UDP audio against the JAX App's on the same u8 file within 1e-4 (the
payload is float32); the TUI's status grid; the ring-overflow counter in
the stats file; the vectorized block handler against the per-channel loop,
bit for bit."""

import numpy as np
import pytest

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.inputs.base import RingBuffer
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.runtime.config import loads_config
from torch_app_common import assert_f32_close, parity_apps, udp_receiver, udp_received
from torch_port_common import drive_app, write_am_u8


@pytest.fixture
def host_demod(monkeypatch):
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)


def test_udp_output_streams(tmp_path, monkeypatch):
    """The 800 Hz tone dominates the UDP stream, which equals the JAX App's
    within 1e-4."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=1.5)
    rxs = [udp_receiver(), udp_receiver()]

    def cfg(port):
        return f'''
fft_size = 512;
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: ({{
    freq = 120.4;
    outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {port}; }} );
  }});
}});
'''

    parity_apps(monkeypatch, *(cfg(rx.getsockname()[1]) for rx in rxs))
    want, audio = (udp_received(rx) for rx in rxs)
    assert audio.size, "no UDP audio received"
    seg = audio[:4096] * np.hanning(min(4096, audio.size))
    freqs = np.fft.rfftfreq(seg.size, 1 / 8000)
    peak = freqs[np.argmax(np.abs(np.fft.rfft(seg))[5:]) + 5]
    assert abs(peak - 800) < 25
    assert_f32_close(want, audio, "UDP audio")


def test_tui_renders_status_grid(tmp_path, capsys, host_demod):
    """Per-channel signal/noise dBFS and the state glyph, '~' for signal
    outside the filter (reference: rtl_airband.cpp:632-643, 1033-1048;
    squelch.cpp:152-154)."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=1.0)
    cfg = f'''
fft_size = 512;
stats_filepath = "{tmp_path}/stats.txt";
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: (
    {{ freq = 120.4; label = "TWR";
       outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 57311; }} ); }},
    {{ freq = 119.1; label = "GND";
       outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 57312; }} ); }},
    {{ freq = 120.398; label = "OFF"; bandwidth = 2000;
       outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 57313; }} ); }}
  );
}});
'''
    app = drive_app(App(loads_config(cfg), device="cpu"))
    capsys.readouterr()
    app._draw_tui()
    out = capsys.readouterr().out
    assert "rtlsdr-airband-tpu" in out
    assert "device 0 [file] center=120.000 MHz" in out
    assert " 120.4000 MHz" in out and " 119.1000 MHz" in out
    assert "TWR" in out and "GND" in out
    assert out.count("dBFS") == 6
    twr = [l for l in out.splitlines() if "TWR" in l][0]
    assert "[*]" in twr
    sig = float(twr.split("sig")[1].split("dBFS")[0])
    noise = float(twr.split("noise")[1].split("dBFS")[0])
    assert sig > noise + 6
    off = [l for l in out.splitlines() if "OFF" in l][0]
    assert "[~]" in off
    app.stats_writer.write([rt.stats for rt in app.devices])
    text = open(tmp_path / "stats.txt").read()
    lvl_lines = [l for l in text.splitlines() if l.startswith("channel_squelch_level{")]
    assert len(lvl_lines) == 3
    assert all(float(l.split("\t")[1]) > 0 for l in lvl_lines)


def test_buffer_overflow_count_reaches_stats(tmp_path, host_demod):
    """Ring overflow -> DeviceStats.buffer_overflow_count -> stats file
    (reference: input-helpers.cpp:56-61, output.cpp:787-800)."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=0.5)
    cfg = f'''
fft_size = 512;
stats_filepath = "{tmp_path}/stats.txt";
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: ({{ freq = 120.4;
    outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 57314; }} ); }});
}});
'''
    app = App(loads_config(cfg), device="cpu")
    rt = app.devices[0]
    rt.input.ring = RingBuffer(1024)
    assert not rt.input.ring.append(np.zeros(2048, np.uint8))
    app._service_once()
    assert rt.stats.buffer_overflow_count == 1
    app.stats_writer.write([d.stats for d in app.devices])
    assert 'buffer_overflow_count{device="0"}\t1' in open(tmp_path / "stats.txt").read()


def test_fast_path_matches_slow_path(tmp_path, host_demod):
    """The vectorized O(open) block handler is observably identical to the
    per-channel loop for control-free devices: the same UDP audio, mixer
    output, continuous IQ file and stats file."""
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=1.5, gate=(0.2, 0.75))  # squelch opens and closes

    def build_cfg(port, stats_path, outdir):
        return f'''
fft_size = 512;
stats_filepath = "{stats_path}";
mixers: {{ mx: {{ outputs: ( {{ type = "file"; directory = "{outdir}"; filename_template = "mix"; continuous = true; }} ); }} }};
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: (
    {{ freq = 120.4;
       outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {port}; }},
                  {{ type = "rawfile"; directory = "{outdir}"; filename_template = "iq0"; continuous = true; }},
                  {{ type = "mixer"; name = "mx"; }} ); }},
    {{ freq = 120.7;
       outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {port + 1}; }} ); }}
  );
}});
'''

    def run_once(force_slow):
        rx = udp_receiver()
        port = rx.getsockname()[1]
        outdir = tmp_path / ("slow" if force_slow else "fast")
        stats_path = tmp_path / ("stats_slow.txt" if force_slow else "stats_fast.txt")
        app = App(loads_config(build_cfg(port, stats_path, outdir)), device="cpu")
        if force_slow:
            for rt in app.devices:
                rt.fast_path = False
        else:
            assert app.devices[0].fast_path
            assert 0 in app.devices[0].idle_tick_idx.tolist()
        app.run(max_seconds=90.0)
        audio = udp_received(rx)
        stats = "\n".join(l for l in open(stats_path).read().splitlines() if not l.startswith("buffer_overflow_count{"))
        files = sorted(outdir.iterdir()) if outdir.exists() else []
        mix = b"".join(f.read_bytes() for f in files if f.name.startswith("mix"))
        iqs = b"".join(f.read_bytes() for f in files if f.name.startswith("iq0"))
        return audio, stats, mix, iqs

    fast_audio, fast_stats, fast_mix, fast_iq = run_once(force_slow=False)
    slow_audio, slow_stats, slow_mix, slow_iq = run_once(force_slow=True)
    assert len(fast_audio) == len(slow_audio) and len(fast_audio) > 4000
    np.testing.assert_array_equal(fast_audio, slow_audio)
    assert fast_stats == slow_stats
    assert len(fast_mix) == len(slow_mix) > 1000 and fast_mix == slow_mix
    assert len(fast_iq) == len(slow_iq) > 1000 and fast_iq == slow_iq
