"""The port's CLI (``python -m rtlsdr_airband_tpu_torch``) on the CPU: -v,
--check-config on every example, a foreground run that writes a WAV, a
torch.profiler trace, and the default device (the card) raising without
one."""

import glob
import json
import os
import subprocess
import sys

import pytest
import torch

import rtlsdr_airband_tpu_torch.outputs.encoders as port_encoders
import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch import __version__, cli
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.runtime.config import load_config
from torch_app_common import read_wav
from torch_port_common import write_am_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*.conf")))


@pytest.fixture
def small_config(tmp_path, monkeypatch):
    """A one-channel file device with a file sink, WAV, demod as K1's host
    build."""
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    monkeypatch.setattr(port_encoders, "_LAME", None)
    iq = tmp_path / "iq.bin"
    write_am_u8(iq, secs=1.5)
    conf = tmp_path / "run.conf"
    conf.write_text(
        f'fft_size = 512;\ndevices: ({{ type = "file"; filepath = "{iq}"; sample_format = "u8"; sample_rate = 2560000; '
        f'centerfreq = 120.0; speedup_factor = 0.0; channels: ({{ freq = 120.4; outputs: ( {{ type = "file"; '
        f'directory = "{tmp_path / "out"}"; filename_template = "twr"; }} ); }}); }});\n'
    )
    return conf


def test_version_names_the_port(capsys):
    assert cli.main(["-v"]) == 0
    out = capsys.readouterr().out
    assert out.strip() == f"rtlsdr-airband-tpu-torch {__version__} (PyTorch/CUDA port)"
    assert cli.build_parser().prog == "rtl-airband-gpu"


@pytest.mark.parametrize("path", EXAMPLES, ids=[os.path.basename(p) for p in EXAMPLES])
def test_check_config_on_every_example(path, capsys):
    assert cli.main(["--check-config", "-c", path]) == 0
    cfg = load_config(path)
    n_ch = sum(len(d.channels) for d in cfg.devices)
    assert capsys.readouterr().out.strip() == f"{path}: OK ({len(cfg.devices)} devices, {n_ch} channels, {len(cfg.mixers)} mixers)"


def test_bad_config_exits_2(tmp_path, capsys):
    bad = tmp_path / "bad.conf"
    bad.write_text('demod_backend = "tpu";\n')
    assert cli.main(["--check-config", "-c", str(bad)]) == 2
    assert "demod_backend" in capsys.readouterr().err


def test_foreground_cpu_run_writes_wav(small_config, tmp_path):
    assert cli.main(["--device", "cpu", "-F", "-e", "-c", str(small_config), "--max-seconds", "60"]) == 0
    files = os.listdir(tmp_path / "out")
    assert len(files) == 1 and files[0].endswith(".wav")
    assert os.path.getsize(tmp_path / "out" / files[0]) > 1000 and read_wav(tmp_path / "out" / files[0]).any()


def test_profile_writes_a_trace(small_config, tmp_path):
    prof = tmp_path / "prof"
    assert cli.main(["--device", "cpu", "-F", "-e", "-c", str(small_config), "--max-seconds", "60", "--profile", str(prof)]) == 0
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(prof / traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("pipeline_chain" in e.get("name", "") or "aten::" in e.get("name", "") for e in events)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_default_device_is_the_card_and_raises_without_one(small_config):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-F", "-e", "-c", str(small_config), "--max-seconds", "5"])


def test_module_entry_point_runs(tmp_path):
    """``python -m rtlsdr_airband_tpu_torch`` is the CLI (a fresh process)."""
    r = subprocess.run([sys.executable, "-m", "rtlsdr_airband_tpu_torch", "--check-config", "-c", EXAMPLES[0]],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith("mixers)"), r.stdout + r.stderr


def test_console_script_names_the_port():
    """``pip install`` puts the port's CLI on PATH as rtl-airband-gpu."""
    import importlib
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        target = tomllib.load(fh)["project"]["scripts"]["rtl-airband-gpu"]
    mod, _, fn = target.partition(":")
    assert getattr(importlib.import_module(mod), fn) is cli.main
