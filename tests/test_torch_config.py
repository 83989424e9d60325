"""The port's libconfig parser and GlobalConfig against the JAX package's, on
the CPU: every example and a set of scene texts parse to equal configs field
by field (the ChannelSpecs included), and demod_backend takes the JAX
package's values and the port's, mapped for the port's PipelineConfig."""

import dataclasses
import glob
import os

import pytest

from rtlsdr_airband_tpu.runtime import config as jax_config
from rtlsdr_airband_tpu_torch.runtime import config
from rtlsdr_airband_tpu_torch.runtime.config import ConfigError, loads_config, pipeline_backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.conf")))

TEXTS = {
    "scan": '''fft_size = 1024; log_scan_activity = true; shout_metadata_delay = 2;
devices: ({ type = "file"; filepath = "/tmp/x.cu8"; sample_rate = 2.56; mode = "scan";
  channels: ({ freqs = ( 118.0, "121.5M", 124000000 ); labels = ( "A", "B", "C" );
    modulations = ( "am", "nfm", "am" ); squelch_threshold = ( -30.0, 0.0, -40.0 ); ctcss = ( 0.0, 100.0, 0.0 );
    outputs: ( { type = "icecast"; server = "localhost"; mountpoint = "/s"; send_scan_freq_tags = true; } ); }); });''',
    "mixers": '''localtime = true; multiple_output_threads = true; tau = 100;
mixers: { m1: { outputs: ( { type = "file"; directory = "/tmp"; filename_template = "mix"; continuous = true; } ); highpass = 200; lowpass = 3000; };
          off: { disable = true; outputs: ( { type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 1; } ); }; };
devices: ({ type = "rtlsdr"; index = 1; gain = 30.5; correction = 2.0; buffers = 8; centerfreq = 120.0;
  channels: ( { freq = 120.4; afc = 3; notch = 1000.0; notch_q = 5.0; bandwidth = "6k"; ampfactor = 1.5; tau = 50;
    outputs: ( { type = "mixer"; name = "m1"; balance = -0.5; ampfactor = 0.7; }, { type = "rawfile"; directory = "/tmp"; filename_template = "iq"; } ); },
    { freq = 120.7; disable = true; outputs: ( { type = "pulse"; } ); },
    { freq = 120.9; label = "X"; squelch_snr_threshold = 12.0;
      outputs: ( { type = "pulse"; sink = "s"; stream_name = "n"; }, { type = "udp_stream"; disable = true; } ); } ); });''',
    "fetch": '''blocks_per_dispatch = 8; active_fetch_slots = 256; fetch_audio_fmt = "i8bf"; suppress_fade_tails = true;
fetch_meta_per_chunk = true; fetch_economy = "auto"; mesh_devices = 2; mesh_time_shards = 2; demod_backend = "xla";
wave_rate = 16000; stats_filepath = "/tmp/stats.txt"; pidfile = "/tmp/pid"; multiple_demod_threads = true;
devices: ({ type = "soapysdr"; device_string = "driver=x"; antenna = "A"; channel = 1; centerfreq = 120.0; sample_rate = 2400000;
  channels: ({ freq = 120.1; outputs: ( { type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 5; } ); }); },
  { type = "mirisdr"; num_buffers = 4; centerfreq = 100.0; channels: ({ freq = 100.1; modulation = "nfm";
    outputs: ( { type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = 6; } ); }); });''',
}


def _fields(obj):
    """A config as nested plain data: dataclasses by field, and each
    channel's ChannelSpec for every one of its frequencies."""
    if dataclasses.is_dataclass(obj):
        out = {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        if hasattr(obj, "spec_for"):
            out["specs"] = [vars(obj.spec_for(i)) for i in range(len(obj.freqs))]
        return out
    if isinstance(obj, dict):
        return {k: _fields(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fields(v) for v in obj]
    return obj


@pytest.mark.parametrize("path", EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_example_parses_as_in_jax(path):
    ours, theirs = config.load_config(path), jax_config.load_config(path)
    assert ours.devices and all(d.channels for d in ours.devices)
    assert _fields(ours) == _fields(theirs)
    assert ours.resolved_wave_rate() == theirs.resolved_wave_rate()


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_config_text_parses_as_in_jax(name):
    ours, theirs = loads_config(TEXTS[name]), jax_config.loads_config(TEXTS[name])
    assert _fields(ours) == _fields(theirs)


@pytest.mark.parametrize("bad", [
    'fft_size = 300; devices: ();',
    'devices: ({ type = "file"; centerfreq = 1.0; channels: ({ freq = 1.0; outputs: ( { type = "udp_stream"; dest_address = "h"; dest_port = 1; } ); }); });',
    'fetch_audio_fmt = "i4"; devices: ({ type = "rtlsdr"; centerfreq = 1.0; channels: ({ freq = 1.0; outputs: ( { type = "pulse"; } ); }); });',
    'devices: ({ type = "rtlsdr"; channels: ({ freq = 1.0; outputs: ( { type = "pulse"; } ); }); });',
])
def test_config_errors_as_in_jax(bad):
    with pytest.raises(jax_config.ConfigError) as theirs:
        jax_config.loads_config(bad)
    with pytest.raises(ConfigError) as ours:
        loads_config(bad)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("value, backend", [("auto", "cuda"), ("pallas", "cuda"), ("cuda", "cuda"), ("xla", "plain"), ("plain", "plain")])
def test_demod_backend_maps_to_the_port(value, backend):
    """The JAX package's Pallas kernel (and 'auto', which picks it) is K1,
    its XLA scan the plain version; the port's own names map to themselves."""
    cfg = loads_config(f'demod_backend = "{value}";\n' + TEXTS["fetch"].replace('demod_backend = "xla";', ""))
    assert cfg.demod_backend == value and pipeline_backend(cfg.demod_backend) == backend


@pytest.mark.parametrize("value", ["tpu", "XLA", "", "triton"])
def test_unknown_demod_backend_raises(value):
    with pytest.raises(ConfigError, match="demod_backend"):
        loads_config(f'demod_backend = "{value}";\n' + TEXTS["fetch"].replace('demod_backend = "xla";', ""))
    with pytest.raises(ConfigError, match="demod_backend"):
        pipeline_backend(value)


def test_the_jax_values_run_in_both_packages():
    """A file written for the JAX package (its three values) loads in the
    port; the port's own two are the port's additions."""
    for value in ("auto", "xla", "pallas"):
        text = f'demod_backend = "{value}";\n' + TEXTS["fetch"].replace('demod_backend = "xla";', "")
        assert loads_config(text).demod_backend == jax_config.loads_config(text).demod_backend == value
    for value in ("cuda", "plain"):
        with pytest.raises(jax_config.ConfigError):
            jax_config.loads_config(f'demod_backend = "{value}";\n' + TEXTS["fetch"].replace('demod_backend = "xla";', ""))
