"""The port's App against the JAX App on the same u8 file: file and mixer
sinks (tests/test_app.py's file-input scenes), on the CPU.  The sinks' audio
is held within WAV_LSB codes (tests/torch_app_common.py), the counters of
the stats file exactly; and the port's App alone is deterministic."""

import os

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.runtime.config import loads_config
from torch_app_common import FrozenClock, assert_stats_close, assert_wav_close, blocks_of, parity_apps, write_wav_everywhere
from torch_port_common import drive_app, write_am_u8


def _file_scene(tmp_path, secs):
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=secs)
    return iq


def test_end_to_end_file_to_wav(tmp_path, monkeypatch):
    """Config -> file input -> Pipeline -> file sink and stats file: the WAV
    and the stats equal the JAX App's within the bars."""
    iq = _file_scene(tmp_path, 2.0)

    def cfg(tag):
        return f'''
fft_size = 512;
stats_filepath = "{tmp_path}/stats_{tag}.txt";
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: ({{
    freq = 120.4;
    outputs: ( {{ type = "file"; directory = "{tmp_path}/out_{tag}"; filename_template = "twr"; }} );
  }});
}});
'''

    jax_app, app = parity_apps(monkeypatch, cfg("jax"), cfg("port"))
    assert blocks_of(app) == blocks_of(jax_app) and blocks_of(app)[0] >= 10
    files = {tag: sorted(os.listdir(tmp_path / f"out_{tag}")) for tag in ("jax", "port")}
    assert len(files["port"]) == len(files["jax"]) == 1 and files["port"][0].endswith(".wav")
    assert os.path.getsize(tmp_path / "out_port" / files["port"][0]) > 1000
    assert_wav_close(tmp_path / "out_jax" / files["jax"][0], tmp_path / "out_port" / files["port"][0], "file sink")
    text = open(tmp_path / "stats_port.txt").read()
    line = [l for l in text.splitlines() if l.startswith('channel_activity_counter{freq="120.400"}')][0]
    assert int(line.split("\t")[1]) > 0
    assert_stats_close(tmp_path / "stats_jax.txt", tmp_path / "stats_port.txt", "stats")


def test_mixer_end_to_end(tmp_path, monkeypatch):
    """A channel feeding a mixer with a continuous file sink: the mixed WAV
    equals the JAX App's within the bars."""
    iq = _file_scene(tmp_path, 1.5)

    def cfg(tag):
        return f'''
fft_size = 512;
mixers: {{
  mx: {{ outputs: ( {{ type = "file"; directory = "{tmp_path}/outm_{tag}"; filename_template = "mixed"; continuous = true; }} ); }};
}};
devices: ({{
  type = "file"; filepath = "{iq}"; sample_format = "u8";
  sample_rate = 2560000; centerfreq = 120.0; speedup_factor = 0.0;
  channels: ({{
    freq = 120.4;
    outputs: ( {{ type = "mixer"; name = "mx"; }} );
  }});
}});
'''

    parity_apps(monkeypatch, cfg("jax"), cfg("port"))
    files = {tag: sorted(os.listdir(tmp_path / f"outm_{tag}")) for tag in ("jax", "port")}
    assert len(files["port"]) == len(files["jax"]) == 1
    assert os.path.getsize(tmp_path / "outm_port" / files["port"][0]) > 500
    assert_wav_close(tmp_path / "outm_jax" / files["jax"][0], tmp_path / "outm_port" / files["port"][0], "mixer sink")


def test_port_app_is_deterministic(tmp_path, monkeypatch):
    """Two runs of the port's App on the same file and config (its own
    channelizer, K1's host build) write the same WAV bytes."""
    write_wav_everywhere(monkeypatch)
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    iq = _file_scene(tmp_path, 1.5)
    runs = []
    for k in range(2):
        out = tmp_path / f"out{k}"
        drive_app(App(loads_config(
            f'devices: ({{ type = "file"; filepath = "{iq}"; sample_format = "u8"; sample_rate = 2560000; centerfreq = 120.0; '
            f'speedup_factor = 0.0; channels: ({{ freq = 120.4; outputs: ( {{ type = "file"; directory = "{out}"; '
            f'filename_template = "twr"; }} ); }}); }});'), clock=FrozenClock(), device="cpu"))
        (f,) = out.iterdir()
        runs.append(f.read_bytes())
    assert len(runs[0]) > 1000 and runs[0] == runs[1]
