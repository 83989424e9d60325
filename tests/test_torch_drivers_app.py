"""The port's App drivers on the CPU, with their explicit CPU switches and
at 32-64 channels: ``scripts/bench_app.py`` (its JSON keys those of the JAX
script, every block handled, ``BENCH_APP_DEVICES`` choosing a mesh) and
``scripts/soak.py`` (a paced run of a few seconds passing its checks).  The
demod runs as K1's host build, as in tests/test_torch_drivers.py."""

import json

import pytest
import torch

from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.scripts import bench_app, soak
from test_torch_drivers import _jax_keys, _last_json, host_k1  # noqa: F401  (host_k1 is a fixture)


def test_bench_app_prints_its_keys_and_handles_every_block(host_k1, monkeypatch, capsys):
    for k, v in (("BENCH_APP_CPU", "1"), ("BENCH_APP_CHANNELS", "64"), ("BENCH_APP_SECONDS", "2"),
                 ("BENCH_APP_BLOCKS_PER_DISPATCH", "4"), ("BENCH_APP_ACTIVE_SLOTS", "32"), ("BENCH_APP_FMT", "i8bf"),
                 ("BENCH_APP_SUPPRESS", "1"), ("BENCH_APP_METAPC", "1")):
        monkeypatch.setenv(k, v)
    assert bench_app.main() == 0
    line = _last_json(capsys)
    keys, detail = _jax_keys("scripts/bench_app.py", "result")
    assert keys <= line.keys() and detail <= line["detail"].keys()
    d = line["detail"]
    assert line["metric"] == "app_block_time" and line["unit"] == "ms/block" and line["value"] > 0
    assert d["blocks"] == d["blocks_expected"] == 16 and d["gather_overflows"] == 0
    assert d["hot_channels"] == 4 and 4 <= d["channels_opened"] <= 32
    assert line["device"] == "cpu" and demod_cuda.LAUNCHES == 16 + 4  # the blocks and warm()'s chunk


def test_bench_app_devices_set_mesh_devices(host_k1, monkeypatch, capsys):
    """BENCH_APP_DEVICES = 2 runs the population over a mesh (of CPU cells
    here): K1 once a channel shard."""
    for k, v in (("BENCH_APP_CPU", "1"), ("BENCH_APP_CHANNELS", "32"), ("BENCH_APP_SECONDS", "1"),
                 ("BENCH_APP_BLOCKS_PER_DISPATCH", "2"), ("BENCH_APP_DEVICES", "2")):
        monkeypatch.setenv(k, v)
    assert bench_app.main() == 0
    d = _last_json(capsys)["detail"]
    assert d["n_devices"] == 2 and d["blocks"] == d["blocks_expected"] == 8
    assert demod_cuda.LAUNCHES == 2 * (8 + 2)


@pytest.fixture
def one_thread():
    """One intra-op thread for a paced run: the suite's workers share the
    host's cores, and small operations over all of them in every worker
    thrash (a block then takes seconds, not milliseconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_soak_passes_its_checks(host_k1, one_thread, monkeypatch, capsys, tmp_path):
    for k, v in (("SOAK_CPU", "1"), ("SOAK_CHANNELS", "64"), ("SOAK_MINUTES", "0.15"), ("SOAK_BLOCKS_PER_DISPATCH", "4"),
                 ("SOAK_SAMPLE_S", "1"), ("SOAK_SCENE_SECONDS", "2")):
        monkeypatch.setenv(k, v)
    out = tmp_path / "soak.json"
    assert soak.main(["--out", str(out)]) == 0
    line = _last_json(capsys)
    keys, _ = _jax_keys("scripts/soak.py", "out")
    assert keys - {"samples"} <= line.keys()
    saved = json.loads(out.read_text())
    assert saved["pass"] and all(saved["checks"].values()) and saved["samples"]
    assert line["blocks_handled"] >= 40 and line["ring_overflow_total"] == 0  # 9 s of air looped 4 times
    assert {"rss_mb", "threads", "fds", "cuda_reserved_mb"} <= saved["samples"][0].keys()
