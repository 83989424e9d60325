"""The port's drivers on the CPU, each with its explicit CPU switch and at a
small size: ``scripts/bench.py``, ``entry.py`` (``entry``,
``dryrun_multichip``), ``scripts/bench_scaling.py``,
``scripts/squelch_trace.py``, ``scripts/debug_golden.py`` and
``scripts/bench_bf16.py``; and every driver, without a card and without
that switch, failing rather than running anywhere else
(``scripts/bench_pair.py`` and ``scripts/bench_unroll.py``, which time K1's
schedules, have no CPU mode at all).  ``scripts/bench_app.py`` and ``scripts/soak.py`` are in
tests/test_torch_drivers_app.py; the demod's trace mode and
``scripts/e2e_snr.py``, held against the JAX package, in
tests/test_torch_demod_trace.py.

Where a driver runs the App or the block program, the demod runs as K1's
host build (``demod_cuda.demod_block_host``, the kernel's own code built
with g++, bit for bit equal to the plain version:
tests/test_torch_demod_tiled.py): the plain version is some 200 times
slower at these sizes.  The JSON keys are read from the JAX scripts' own
sources.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch import entry as port_entry
from rtlsdr_airband_tpu_torch.interop import state_to_numpy
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.scripts import (
    bench, bench_app, bench_bf16, bench_pair, bench_scaling, bench_unroll, debug_golden, e2e_snr, soak, squelch_trace,
)
from torch_port_common import assert_close, jax_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def host_k1(monkeypatch):
    """K1's host build in place of the launcher on the port's paths; counts
    its calls as the launcher counts launches."""

    def k1(*args, **kw):
        demod_cuda.LAUNCHES += 1
        return demod_cuda.demod_block_host(*args, **kw)

    monkeypatch.setattr(port_pipeline, "demod_block_cuda", k1)
    monkeypatch.setattr(demod_cuda, "LAUNCHES", 0)


def _jax_keys(script: str, var: str) -> tuple[set, set]:
    """The top-level and ``detail`` keys of the dict literal assigned to
    ``var`` in one of the JAX scripts."""
    tree = ast.parse(open(os.path.join(ROOT, script)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) and node.targets[0].id == var \
                and isinstance(node.value, ast.Dict):
            keys = {k.value for k in node.value.keys}
            detail = next((v for k, v in zip(node.value.keys, node.value.values) if k.value == "detail"), None)
            return keys, ({k.value for k in detail.keys} if isinstance(detail, ast.Dict) else set())
    raise AssertionError(f"{script}: no dict literal assigned to {var}")


def jax_dumps_keys(script: str) -> set:
    """The keys of the dict literal a JAX script hands to ``json.dumps``."""
    tree = ast.parse(open(os.path.join(ROOT, script)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps" and node.args and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"{script}: no json.dumps of a dict literal")


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_prints_every_key_of_the_jax_line(host_k1, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    for k, v in (("BENCH_CHANNELS", "64"), ("BENCH_BLOCKS", "2"), ("BENCH_REPS", "1")):
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    line = _last_json(capsys)
    keys, detail = _jax_keys("bench.py", "result")
    assert keys <= line.keys() and detail <= line["detail"].keys()
    assert {"device", "power_limit"} <= line.keys() and line["device"] == "cpu" and line["power_limit"] is None
    d = line["detail"]
    assert d["n_channels"] == 64 and d["blocks_per_dispatch"] == 2 and d["demod_backend"] == "plain" and d["backend"] == "cpu"
    assert d["block_ms"] > 0 and line["value"] > 0 and line["unit"] == "channel-Msps/CPU"
    assert demod_cuda.LAUNCHES == 2 * 2  # warm-up and one rep of K = 2 blocks


def test_bench_blocks_are_the_jax_bench_blocks():
    """The K distinct blocks and the state the bench threads are the JAX
    bench's: the flagship input plus seed-7 noise, equal bit for bit."""
    from rtlsdr_airband_tpu.models.flagship import build_flagship as jax_build_flagship

    _kw, (jx, _bins, _window, _params, jstate) = jax_build_flagship(n_channels=32, sample_rate=2_560_000, wave_rate=16000)
    xs_jax = np.asarray(jx)[None] + np.random.default_rng(7).normal(0, 0.01, (3,) + jx.shape).astype(np.float32)
    _block, xs, state = bench.flagship_blocks(32, 3, "cpu")
    assert all(np.asarray(xs_jax[k]).tobytes() == xs[k].numpy().tobytes() for k in range(3))
    assert_close(jax_flat(jstate), state_to_numpy(state), "initial state")


def test_entry_defaults_are_the_jax_entry():
    """entry()'s example args at full width (8192 channels) are the JAX
    entry()'s: input block bit for bit, the same initial state, bins and
    params; the defaults put it on the card."""
    import inspect

    import __graft_entry__

    jfn, (jx, jbins, _jwindow, jparams, jstate) = __graft_entry__.entry()
    fn, (x, state) = port_entry.entry(device="cpu")
    assert x.numpy().tobytes() == np.asarray(jx).tobytes()
    assert fn.bins.numpy().tolist() == np.asarray(jbins).tolist()
    assert_close(jax_flat(jstate), state_to_numpy(state), "entry state")
    for name in jparams._fields:
        a, b = np.asarray(getattr(jparams, name)), getattr(fn.params, name).numpy()
        assert np.array_equal(a.astype(b.dtype) if name == "dm_dphi" else a, b), name
    assert fn.block_kwargs == {k: jfn.keywords[k] for k in fn.block_kwargs}
    assert fn.inv_perm.numpy().tolist() == np.asarray(jfn.keywords["inv_perm"]).tolist()
    assert inspect.signature(port_entry.entry).parameters["device"].default == "cuda"


def test_entry_block_matches_the_jax_block(host_k1):
    """fn(*example_args) of entry() against the JAX entry()'s function on the
    same build at 64 channels (the JAX block takes ~20 s on the CPU at 8192):
    every output within the parity bars."""
    from rtlsdr_airband_tpu.models.flagship import build_flagship as jax_build_flagship
    from rtlsdr_airband_tpu.runtime.pipeline import pipeline_block as jax_pipeline_block

    kw, (jx, jbins, jwindow, jparams, jstate) = jax_build_flagship(n_channels=64, wave_rate=16000)
    jst, jout = jax_pipeline_block(jx, jbins, jwindow, jparams, jstate, **kw)
    fn, args = port_entry.entry(device="cpu", n_channels=64)
    st, out = fn(*args)
    assert demod_cuda.LAUNCHES == 1
    assert_close(jax_flat(jst), state_to_numpy(st), "entry block state")
    assert_close({k: np.asarray(v) for k, v in jout.items()}, out, "entry block outputs")
    assert float(np.abs(np.asarray(jout["audio"])).sum()) > 0


def test_dryrun_multichip_on_cpu_cells(host_k1, capsys):
    port_entry.dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip OK" in out and "mesh==single bit-identical over 6 blocks" in out
    assert demod_cuda.LAUNCHES > 6


def test_bench_scaling_sweeps_on_the_cpu(host_k1, capsys):
    assert bench_scaling.main(["--device", "cpu", "--channels", "32,64"]) == 0
    assert bench_scaling.main(["--device", "cpu", "--devices", "1", "2", "4"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    chans, devs = lines[:2], lines[2:]
    assert [p["n_channels"] for p in chans] == [32, 64] and all(p["block_ms"] > 0 for p in chans)
    assert [p["n_devices"] for p in devs] == [1, 2, 4] and devs[2]["mesh"] == {"time": 2, "chan": 2}
    assert len({p["audio_checksum"] for p in devs}) == 1  # one population, any mesh


def test_squelch_trace_synth_on_the_cpu(tmp_path):
    """--synth at 0.3 s (two blocks at wave_rate 8000): the JAX script's
    series, aligned, and the traced plain demod's audio and open flags equal
    bit for bit to K1's (its host build) on the same channelizer output, the
    check chip_smoke.py makes on the card."""
    path = tmp_path / "trace.npz"
    assert squelch_trace.main(["--device", "cpu", "--synth", "--seconds", "0.3", str(path)]) == 0
    d = np.load(path)
    assert {"cur", "nxt", "noise_floor", "pre_capped", "agc", "delay", "waveout", "audio"} <= set(d.files)
    assert len({d[k].shape for k in d.files}) == 1 and d["cur"].shape == (2000,)
    assert d["cur"].dtype == np.int32 and d["agc"].dtype == np.float32 and d["open"].dtype == bool
    assert d["open"].any() and (d["cur"] == 4).any()  # the carrier opened the squelch
    x = squelch_trace.synth_scene(2_560_000, 400_000.0, 0.3, 8000)
    params, state, blocks = squelch_trace.channelized(x, freq=120.4e6, center=120.0e6, fs=2_560_000, modulation="am", device="cpu")
    audio, opened = [], []
    for mags, iqs in blocks:
        state, a, _iq, o = demod_cuda.demod_block_host(params, state, mags, iqs)
        audio.append(a[:, 0].numpy())
        opened.append(o[:, 0].numpy())
    assert np.concatenate(audio).tobytes() == d["audio"].tobytes()
    assert np.array_equal(np.concatenate(opened), d["open"])


def test_debug_golden_on_the_cpu(capsys):
    """The plain demod and K1's host build against the refmodel on the AM
    scene at 0.3 s: gating identical, audio and IQ within the golden bars
    (tests/test_demod_golden.py)."""
    assert debug_golden.main(["--device", "cpu", "--seconds", "0.3", "am"]) == 0
    line = _last_json(capsys)
    for name in ("plain", "k1"):
        assert line[name]["gate_mismatch"] == 0 and line[name]["audio"] <= 2e-5 and line[name]["iq"] <= 5e-4


def test_bench_bf16_on_the_cpu(monkeypatch, capsys):
    """BENCH_DEVICE=cpu at 64 channels: one line a mode, in the JAX order
    plus tf32, with every key of the JAX line; float32 (``highest``) clears
    the 80 dB gate against the float64 DFT and bfloat16 does not; the lines
    say what ran on the CPU.  The port's channelizer settings are left as
    they were."""
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_CHANNELS", "64")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    assert bench_bf16.main() == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [x["mode"] for x in lines] == ["default", "high", "highest", "bf16", "tf32"]
    keys = jax_dumps_keys("scripts/bench_bf16.py")
    for x in lines:
        assert keys <= x.keys() and x["n_channels"] == 64 and x["chan_ms"] > 0 and x["device"] == "cpu"
        assert x["gate_db"] == 80.0 and x["passes_gate"] == (x["snr_db"] >= 80.0) and x["runs"] == bench_bf16.RUNS["cpu"][x["mode"]]
    snr = {x["mode"]: x["snr_db"] for x in lines}
    assert snr["highest"] >= 80.0 and snr["high"] >= 80.0 and snr["bf16"] < 80.0
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


def test_bench_bf16_tf32_split_is_exact():
    """``high``'s split: the head keeps TF32's 10 mantissa bits, the rest is
    exact, head + rest == t bit for bit."""
    t = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (64, 32)).astype(np.float32))
    head, rest = bench_bf16._tf32_split(t)
    assert torch.equal(head + rest, t)
    assert not bool((head.view(torch.int32) & 0x1FFF).any())
    assert float((rest.abs() / t.abs().clamp_min(1e-30)).max()) < 2.0**-10


DRIVERS = {
    "bench": lambda: bench.main(),
    "bench_pair": lambda: bench_pair.main(),
    "bench_unroll": lambda: bench_unroll.main(),
    "bench_bf16": lambda: bench_bf16.main(),
    "bench_app": lambda: bench_app.main(),
    "soak": lambda: soak.main([]),
    "bench_scaling": lambda: bench_scaling.main([]),
    "e2e_snr": lambda: e2e_snr.main([]),
    "squelch_trace": lambda: squelch_trace.main(["--synth", "unused.npz"]),
    "debug_golden": lambda: debug_golden.main([]),
    "entry": lambda: port_entry.main([]),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_driver_without_a_card_fails(driver, monkeypatch, capsys, tmp_path):
    """No card and no CPU switch: a non-zero exit and the reason, before any
    work (nothing falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.chdir(tmp_path)
    for k in ("BENCH_DEVICE", "BENCH_APP_CPU", "SOAK_CPU"):
        monkeypatch.delenv(k, raising=False)
    assert DRIVERS[driver]() != 0
    err = capsys.readouterr().err
    assert "CUDA device" in err or "GPUs" in err, err
    assert not os.listdir(tmp_path)


def test_drivers_exit_non_zero_as_programs(tmp_path):
    """The same through ``python -m``, as a user starts them; skipped where
    a card is present (they would run on it)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the drivers would run on it")
    env = {k: v for k, v in os.environ.items() if k not in ("BENCH_DEVICE", "BENCH_APP_CPU", "SOAK_CPU")}
    mods = [f"rtlsdr_airband_tpu_torch.scripts.{m}" for m in (
        "bench", "bench_app", "soak", "bench_scaling", "e2e_snr", "bench_pair", "bench_unroll", "bench_bf16")]
    cmds = [[sys.executable, "-m", m] for m in mods] + [
        [sys.executable, "-m", "rtlsdr_airband_tpu_torch.scripts.squelch_trace", "--synth", str(tmp_path / "t.npz")],
        [sys.executable, "-m", "rtlsdr_airband_tpu_torch.scripts.debug_golden"],
        [sys.executable, "-m", "rtlsdr_airband_tpu_torch.entry"],
    ]
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    for c, p in zip(cmds, procs):
        out, err = p.communicate(timeout=120)
        assert p.returncode != 0 and not out.strip(), (c, p.returncode, out, err)
    assert not os.listdir(tmp_path)
