"""Port parity: channel params, initial state and the interop round trip of
``rtlsdr_airband_tpu_torch`` against the JAX package, plus the port's
import boundary (it imports neither jax nor the JAX package)."""

import ast
import fnmatch
import os
import re
import subprocess
import sys
import tomllib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu.models.flagship import flagship_specs as jax_flagship_specs
from rtlsdr_airband_tpu.ops.params import ChannelSpec as JaxSpec
from rtlsdr_airband_tpu.ops.params import cost_group_permutation as jax_cost_group_permutation
from rtlsdr_airband_tpu.ops.params import init_demod_state as jax_init_demod_state
from rtlsdr_airband_tpu.ops.params import make_channel_params as jax_make_channel_params
from rtlsdr_airband_tpu_torch import interop
from rtlsdr_airband_tpu_torch.models.flagship import flagship_specs
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, cost_group_permutation, init_demod_state, make_channel_params
from torch_port_common import CENTER, FS, N, SPEC_KW, jax_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spec_sets():
    flag = [dict(frequency=s.frequency, modulation=s.modulation, bandwidth=s.bandwidth, notch=s.notch, ctcss=s.ctcss)
            for s in jax_flagship_specs(8)]
    return {"specs": SPEC_KW, "flagship": flag}


@pytest.mark.parametrize("which", ["specs", "flagship"])
@pytest.mark.parametrize("wave_rate", [8000, 16000])
def test_channel_params_match_jax(which, wave_rate):
    kws = _spec_sets()[which]
    jp = jax_make_channel_params([JaxSpec(**k) for k in kws], wave_rate=wave_rate, sample_rate=FS, center_freq=CENTER, fft_size=N)
    tp = make_channel_params([ChannelSpec(**k) for k in kws], wave_rate=wave_rate, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")
    assert tp._fields == jp._fields
    for name in jp._fields:
        a, b = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert a.shape == b.shape, name
        if name == "dm_dphi":  # uint32 there, int32 here; values < 2^24
            assert b.dtype == np.int32 and np.array_equal(a.astype(np.int64), b.astype(np.int64)), name
        else:
            assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_flagship_specs_and_permutation_match_jax():
    ours, theirs = flagship_specs(24), jax_flagship_specs(24)
    assert [vars(s) for s in ours] == [vars(s) for s in theirs]
    assert np.array_equal(cost_group_permutation(ours), jax_cost_group_permutation(theirs))


def test_init_state_matches_jax():
    C, A = 6, 100
    rng = np.random.default_rng(3)
    pm = np.abs(rng.normal(0, 1.0, (A, C))).astype(np.float32)
    pi = rng.normal(0, 0.5, (A, C, 2)).astype(np.float32)
    js = jax_flat(jax_init_demod_state(C, jnp.asarray(pm), jnp.asarray(pi)))
    ts = interop.state_to_numpy(init_demod_state(C, torch.from_numpy(pm), torch.from_numpy(pi)))
    assert js.keys() == ts.keys()
    for k in js:
        assert js[k].dtype == ts[k].dtype and np.array_equal(js[k], ts[k]), k


def test_interop_round_trip_is_lossless():
    C, A = 5, 100
    rng = np.random.default_rng(4)
    js = jax_flat(jax_init_demod_state(
        C, jnp.asarray(rng.random((A, C), np.float32)), jnp.asarray(rng.random((A, C, 2), np.float32))
    ))
    # arbitrary values in every leaf, the phase at its 24-bit extremes
    for k, v in js.items():
        if v.dtype == bool:
            js[k] = rng.random(v.shape) < 0.5
        elif v.dtype.kind in "iu":
            js[k] = rng.integers(0, 1000, v.shape).astype(v.dtype)
        else:
            js[k] = rng.normal(size=v.shape).astype(v.dtype)
    js["dm_phi"] = np.array([0, 1, 0x7FFFFF, 0xFFFFFE, 0xFFFFFF], np.uint32)
    st = interop.state_from_numpy(js, device="cpu")
    assert st.dm_phi.dtype == torch.int32
    back = interop.state_to_numpy(st)
    assert back.keys() == js.keys()
    for k in js:
        assert back[k].dtype == js[k].dtype and np.array_equal(back[k], js[k]), k

    jp = jax_make_channel_params([JaxSpec(**k) for k in SPEC_KW], wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N)
    tp = interop.params_from_numpy({k: np.asarray(v) for k, v in jp._asdict().items()}, device="cpu")
    ref = make_channel_params([ChannelSpec(**k) for k in SPEC_KW], wave_rate=16000, sample_rate=FS, center_freq=CENTER, fft_size=N, device="cpu")
    for name in ref._fields:
        assert torch.equal(getattr(tp, name), getattr(ref, name)), name


# the drivers and what they alone import: entry points, refmodel, siggen
_DRIVERS = {f"rtlsdr_airband_tpu_torch.{m}" for m in (
    "entry", "refmodel.channel_ref", "refmodel.squelch_ref", "refmodel.ctcss_ref", "refmodel.filters_ref", "utils.siggen",
    *(f"scripts.{s}" for s in ("common", "bench", "bench_app", "soak", "bench_scaling", "e2e_snr", "squelch_trace", "debug_golden",
                               "bench_pair", "bench_unroll", "bench_bf16")),
)}

_PORT_MODULES = [
    "rtlsdr_airband_tpu_torch." + os.path.relpath(os.path.join(d, f), os.path.join(ROOT, "rtlsdr_airband_tpu_torch"))[:-3].replace(os.sep, ".")
    for d, _, files in os.walk(os.path.join(ROOT, "rtlsdr_airband_tpu_torch"))
    for f in files
    if f.endswith(".py") and f != "__init__.py"
]


def test_port_import_pulls_in_no_jax():
    """The test process already holds jax (conftest.py): import the port in a
    fresh interpreter and look at what it loaded; every module of the port
    is imported, the multi-device ones among them."""
    assert {"rtlsdr_airband_tpu_torch.parallel.sharding", "rtlsdr_airband_tpu_torch.parallel.multihost",
            "rtlsdr_airband_tpu_torch.scripts.run_multihost"} | _DRIVERS <= set(_PORT_MODULES)
    code = (
        "import importlib, sys\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'rtlsdr_airband_tpu' or m.startswith('rtlsdr_airband_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_package_data_ships_every_kernel_source():
    """``pip install .`` must carry csrc/, or an installed port cannot build
    its kernels."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"]["rtlsdr_airband_tpu_torch"]
    csrc = os.path.join(ROOT, "rtlsdr_airband_tpu_torch", "csrc")
    sources = [f"csrc/{f}" for f in sorted(os.listdir(csrc))]
    assert {"csrc/demod.cu", "csrc/demod_sched.cu", "csrc/demod_kernels.cuh", "csrc/chain_probe.cu", "csrc/demod_step.cuh",
            "csrc/demod_host.cpp"} <= set(sources)
    for src in sources:
        assert any(fnmatch.fnmatchcase(src, g) for g in globs), f"{src} matches none of {globs}"


_PORT_FILES = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "tests/test_torch_cuda.py", "tests/torch_port_common.py",
                                                 "tests/torch_multihost_worker.py")] + [
    os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, "rtlsdr_airband_tpu_torch")) for f in fs if f.endswith(".py")
]


def test_port_sources_import_nothing_of_jax():
    """The port, chip_smoke.py and the card-only tests (which run where there
    is no JAX) import neither jax nor the JAX package."""
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax\b|rtlsdr_airband_tpu(?!_torch)\b)")
    assert len(_PORT_FILES) > 10
    port = os.path.join(ROOT, "rtlsdr_airband_tpu_torch")
    assert {os.path.join(port, f) for f in ("parallel/sharding.py", "parallel/multihost.py", "scripts/run_multihost.py")} <= set(_PORT_FILES)
    assert {os.path.join(port, *m.split(".")[1:]) + ".py" for m in _DRIVERS} <= set(_PORT_FILES)
    for path in _PORT_FILES:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                assert not pat.search(line), f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}"


# a module of the JAX package named in a string (importlib, __import__, an
# entry point): "rtlsdr_airband_tpu" alone or followed by a dot
_JAX_PACKAGE_NAME = re.compile(r"^rtlsdr_airband_tpu$|rtlsdr_airband_tpu\.|^jax$|^jax\.")


@pytest.mark.parametrize("path", _PORT_FILES, ids=[os.path.relpath(p, ROOT) for p in _PORT_FILES])
def test_port_sources_name_no_jax_module_in_a_string(path):
    """No string literal of the port (docstrings included) names a module of
    the JAX package or of jax, so no run-time import can reach them
    (rtlsdr_airband_tpu/inputs/base.py imports its drivers by such a
    string)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and _JAX_PACKAGE_NAME.search(node.value):
            raise AssertionError(f"{os.path.relpath(path, ROOT)}:{node.lineno}: {node.value[:120]!r}")


def test_the_string_check_catches_the_drivers_import():
    """The check above flags the JAX package's own driver import string."""
    src = open(os.path.join(ROOT, "rtlsdr_airband_tpu", "inputs", "base.py")).read()
    hits = [n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and _JAX_PACKAGE_NAME.search(n.value)]
    assert any(n.value == "rtlsdr_airband_tpu.inputs." for n in hits)


def test_port_run_time_imports_pull_in_no_jax(tmp_path):
    """The port's driver factory and config loader, called in a fresh
    interpreter: a file input through input_new and every example through
    loads_config leave neither jax nor the JAX package in sys.modules."""
    iq = tmp_path / "iq.cu8"
    iq.write_bytes(bytes(4096))
    code = (
        "import glob, sys\n"
        "from rtlsdr_airband_tpu_torch.inputs.base import input_new\n"
        "from rtlsdr_airband_tpu_torch.runtime.config import loads_config\n"
        f"inp = input_new('file', filepath={str(iq)!r}, sample_rate=2560000, centerfreq=0, speedup_factor=0.0)\n"
        "assert type(inp).__module__ == 'rtlsdr_airband_tpu_torch.inputs.filesrc', type(inp).__module__\n"
        "for p in sorted(glob.glob('examples/*.conf')): loads_config(open(p).read())\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'rtlsdr_airband_tpu' or m.startswith('rtlsdr_airband_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
