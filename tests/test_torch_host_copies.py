"""The port's copies of the JAX package's host modules (logutil, io/wav,
inputs/, outputs/, runtime/{libconfig,config,mixer,control,economy},
refmodel/, utils/siggen, native), on the CPU.

- Drift: each copy's code equals its JAX module's once the few lines the
  port changes are mapped back (comments and docstrings aside: the copies
  say "device" where their originals say TPU).
- The JAX package's own tests of these modules (tests/test_mixer.py,
  test_control.py, test_economy.py, test_outputs.py, test_inputs.py,
  test_native.py) run again on the copies, one parametrised case each: the
  JAX module names are pointed at the port's modules for the test's
  duration, nothing is duplicated.
- The fetch economy's live rung switch on the port's Pipeline
  (tests/test_economy.py::test_live_rung_switch_mid_stream):
  ``Pipeline.apply_rung`` and ``warm_async`` mid-stream.
"""

import ast
import importlib
import inspect
import os
import sys
import time

import numpy as np
import pytest

import rtlsdr_airband_tpu_torch.runtime.pipeline as port_pipeline
from rtlsdr_airband_tpu_torch import native
from rtlsdr_airband_tpu_torch.app import App
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec
from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig
from torch_port_common import CENTER, FS, SCENE_SPECS, feed_all, scene_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# copy -> the lines the port changes, as (port text, JAX text), and the
# top-level names only the port has
COPIES = {
    "logutil": ([('"rtlsdr_airband_tpu_torch"', '"rtlsdr_airband_tpu"')], ()),
    "io": ([], ()),
    "io.wav": ([], ()),
    "runtime.libconfig": ([], ()),
    "runtime.config": ([(
        """    if str(doc.get("demod_backend", "auto")) not in PIPELINE_BACKENDS:
        raise ConfigError("demod_backend must be auto, xla, pallas, cuda, or plain")""",
        """    if str(doc.get("demod_backend", "auto")) not in ("auto", "xla", "pallas"):
        raise ConfigError("demod_backend must be auto, xla, or pallas")""",
    )], ("PIPELINE_BACKENDS", "pipeline_backend")),
    "runtime.mixer": ([], ()),
    "runtime.control": ([], ()),
    "runtime.economy": ([], ()),
    "inputs": ([], ()),
    "inputs.base": ([('f"{__package__}.{mod_name}"', 'f"rtlsdr_airband_tpu.inputs.{mod_name}"')], ()),
    "inputs.filesrc": ([], ()),
    "inputs.rtlsdr": ([], ()),
    "inputs.soapysdr": ([], ()),
    "inputs.mirisdr": ([], ()),
    **{f"outputs.{m}": ([], ()) for m in ("dispatch", "encoders", "filemgr", "icecast", "pulse", "pulse_async", "stats", "udp")},
    "outputs": ([], ()),
    **{f"refmodel.{m}": ([], ()) for m in ("channel_ref", "squelch_ref", "ctcss_ref", "filters_ref")},
    "utils.siggen": ([], ()),
}


def _source(pkg: str, mod: str) -> str:
    path = os.path.join(ROOT, pkg, *mod.split("."))
    return open(path + "/__init__.py" if os.path.isdir(path) else path + ".py").read()


def _code(src: str, drop=(), keep=None) -> str:
    """The module's AST without docstrings (and without the top-level
    definitions named in ``drop``, or only those in ``keep``)."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]

    def name(n):
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            return n.name
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name):
            return n.targets[0].id
        return None

    tree.body = [n for n in tree.body if name(n) not in drop and (keep is None or name(n) in keep)]
    return ast.dump(tree)


@pytest.mark.parametrize("mod", sorted(COPIES))
def test_copy_matches_its_jax_module(mod):
    edits, port_only = COPIES[mod]
    port = _source("rtlsdr_airband_tpu_torch", mod)
    for ours, theirs in edits:
        assert port.count(ours) == 1, f"{mod}: the port's change {ours!r} is not there once"
        port = port.replace(ours, theirs)
    assert _code(port, drop=port_only) == _code(_source("rtlsdr_airband_tpu", mod)), f"{mod} drifted from its JAX module"


def test_native_binding_matches_its_jax_module():
    """native.py builds ingest.cpp itself and binds no sample converter (the
    port decodes by ops/sampleconv.py); the ring buffer and the file reader
    are the JAX package's code."""
    keep = ("NativeRingBuffer", "NativeFileReader", "native_available")
    assert _code(_source("rtlsdr_airband_tpu_torch", "native"), keep=keep) == _code(_source("rtlsdr_airband_tpu", "native"), keep=keep)
    assert native.native_available()
    built = native._build()
    assert built.parent == native._BUILD_DIR and built.parent.parent.name == "rtlsdr_airband_tpu_torch"


# ---- the JAX package's tests of these modules, run on the copies ----

_ALIASED = [m for m in COPIES if m != "io"] + ["native", "app"]
_SUITES = {
    "test_mixer": (), "test_control": (), "test_outputs": (),
    "test_economy": ("test_live_rung_switch_mid_stream", "test_app_attaches_economy_and_shifts"),  # below / test_torch_app_control.py
    "test_inputs": (),
    "test_native": ("test_convert_parity",),  # the port binds no converter
}


def _cases():
    out = []
    for suite, skip in _SUITES.items():
        mod = importlib.import_module(suite)
        for name, obj in vars(mod).items():
            if name.startswith("test_") and inspect.isfunction(obj) and name not in skip:
                out.append((suite, name))
            elif name.startswith("Test") and inspect.isclass(obj):
                out += [(suite, f"{name}.{m}") for m in vars(obj) if m.startswith("test_")]
    return out


CASES = _cases()


@pytest.mark.parametrize("suite, case", CASES, ids=[f"{s}::{c}" for s, c in CASES])
def test_jax_suite_case_on_the_copies(suite, case, monkeypatch, request):
    tests = importlib.import_module(suite)
    pairs = [(mod, importlib.import_module(f"rtlsdr_airband_tpu.{mod}"), importlib.import_module(f"rtlsdr_airband_tpu_torch.{mod}"))
             for mod in _ALIASED]
    parents = {mod: importlib.import_module(f"rtlsdr_airband_tpu.{mod}".rpartition(".")[0]) for mod, _, _ in pairs}
    for mod, jax_mod, port_mod in pairs:
        for name, value in list(vars(tests).items()):
            if not name.startswith("__") and getattr(jax_mod, name, object()) is value:
                monkeypatch.setattr(tests, name, getattr(port_mod, name))
        # `from rtlsdr_airband_tpu.x import y` finds y in sys.modules, and
        # `from rtlsdr_airband_tpu import y` on the package
        monkeypatch.setattr(parents[mod], mod.rpartition(".")[2], port_mod)
        monkeypatch.setitem(sys.modules, f"rtlsdr_airband_tpu.{mod}", port_mod)
    left = [n for n, v in vars(tests).items() if getattr(v, "__module__", "").startswith("rtlsdr_airband_tpu.")]
    assert not left, f"{suite} still holds the JAX package's {left}"
    # the App tests among them build Apps from config text: on the CPU here
    monkeypatch.setattr(App.__init__, "__defaults__", (False, False, time.time, "cpu"))
    owner, _, method = case.partition(".")
    fn = getattr(getattr(tests, owner)(), method) if method else getattr(tests, owner)
    fn(**{arg: request.getfixturevalue(arg) for arg in inspect.signature(fn).parameters})


def test_suites_run_on_the_port():
    """The aliasing above really hands the JAX suites the port's objects."""
    import test_mixer

    from rtlsdr_airband_tpu_torch.runtime.mixer import Mixer

    assert test_mixer.Mixer is not Mixer and len(CASES) > 60
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(sys.modules, "rtlsdr_airband_tpu.runtime.mixer", sys.modules["rtlsdr_airband_tpu_torch.runtime.mixer"])
        from rtlsdr_airband_tpu.runtime.mixer import Mixer as aliased

        assert aliased is Mixer
    finally:
        mp.undo()
    import rtlsdr_airband_tpu

    from rtlsdr_airband_tpu_torch import app as port_app

    try:
        mp.setattr(rtlsdr_airband_tpu, "app", port_app)
        from rtlsdr_airband_tpu import app as aliased_app

        assert aliased_app is port_app
    finally:
        mp.undo()


# ---- the fetch economy on the port's Pipeline ----

def _config(**kw):
    return PipelineConfig(sample_rate=FS, center_freq=CENTER, wave_rate=8000, sample_format="u8", fullscale=127.5,
                          chunk_blocks=2, async_depth=0, device="cpu", **kw)


def test_live_rung_switch_mid_stream(monkeypatch):
    """apply_rung mid-stream (and warm_async for the neighbour rungs): the
    next dispatch uses the new slots and format, and the rebuilt audio stays
    within the i8bf rung's step of the dense fetch
    (tests/test_economy.py::test_live_rung_switch_mid_stream)."""
    monkeypatch.setattr(port_pipeline, "demod_block_cuda", demod_cuda.demod_block_host)
    specs = [ChannelSpec(**k) for k in SCENE_SPECS]
    raw = scene_u8()
    dense = feed_all(Pipeline(_config(), specs), raw)
    p = Pipeline(_config(active_slots=3, fetch_audio_fmt="i16"), specs)
    half = len(raw) // 2
    outs = [np.array(o["audio"]) for o in p.feed(raw[:half])]
    n_before = len(outs)
    p.apply_rung(6, "i8bf")
    p.warm_async(slots=3, fmt="i16")
    assert p.cfg.active_slots == 6 and p.cfg.audio_fmt == "i8bf"
    outs += [np.array(o["audio"]) for o in p.feed(raw[half:])]
    outs += [np.array(o["audio"]) for o in p.flush()]
    p.close()
    assert 0 < n_before < len(outs) == len(dense)
    for d, a in zip(dense, outs):
        step = np.abs(d["audio"]).max(axis=0) / 127.0
        assert (np.abs(d["audio"] - a) <= step[None, :] * 0.5 + 1.0 / 32767.0 + 1e-7).all()
