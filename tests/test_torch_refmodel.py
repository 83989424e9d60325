"""The port's copy of the scalar NumPy refmodel (``refmodel/{channel_ref,
squelch_ref,ctcss_ref,filters_ref}.py``) and of ``utils/siggen.py``, on the
CPU.

- The JAX package's own tests of the refmodel (tests/test_refmodel.py) run
  again on the copies, one case each (parametrised cases expanded): the JAX
  module names are pointed at the port's modules for the test's duration,
  nothing is duplicated.  ``test_full_matrix`` is marked slow there and the
  Tier-1 run deselects it, so it is not among them.
- The copies' code equals their JAX modules' (comments and docstrings
  aside): tests/test_torch_host_copies.py's drift check, which lists them.
- The refmodel's outputs on a scene are the JAX refmodel's, bit for bit.
"""

import importlib
import inspect
import sys

import numpy as np
import pytest

import test_refmodel
from rtlsdr_airband_tpu.refmodel import channel_ref as jax_channel_ref
from rtlsdr_airband_tpu_torch.refmodel import channel_ref
from rtlsdr_airband_tpu_torch.utils import siggen

_ALIASED = ["refmodel.channel_ref", "refmodel.squelch_ref", "refmodel.ctcss_ref", "refmodel.filters_ref", "utils.siggen"]


def _cases():
    """(case, kwargs) of every test of tests/test_refmodel.py not marked
    slow, one a parametrised value set."""
    out = []
    for name, obj in vars(test_refmodel).items():
        if name.startswith("Test") and inspect.isclass(obj):
            fns = [(f"{name}.{m}", f) for m, f in vars(obj).items() if m.startswith("test_")]
        elif name.startswith("test_") and inspect.isfunction(obj):
            fns = [(name, obj)]
        else:
            continue
        for case, fn in fns:
            marks = getattr(fn, "pytestmark", [])
            if any(m.name == "slow" for m in marks):
                continue
            sets = [{}]
            for m in marks:
                if m.name == "parametrize":
                    argnames = [a.strip() for a in m.args[0].split(",")] if isinstance(m.args[0], str) else list(m.args[0])
                    values = [v if len(argnames) > 1 else (v,) for v in m.args[1]]
                    sets = [dict(s, **dict(zip(argnames, v))) for s in sets for v in values]
            out += [(case, s) for s in sets]
    return out


CASES = _cases()


@pytest.mark.parametrize("case, kwargs", CASES, ids=[f"{c}[{'-'.join(map(str, k.values()))}]" if k else c for c, k in CASES])
def test_refmodel_case_on_the_copies(case, kwargs, monkeypatch):
    for mod in _ALIASED:
        jax_mod = importlib.import_module(f"rtlsdr_airband_tpu.{mod}")
        port_mod = importlib.import_module(f"rtlsdr_airband_tpu_torch.{mod}")
        for name, value in list(vars(test_refmodel).items()):
            if not name.startswith("__") and getattr(jax_mod, name, object()) is value:
                monkeypatch.setattr(test_refmodel, name, getattr(port_mod, name))
        monkeypatch.setitem(sys.modules, f"rtlsdr_airband_tpu.{mod}", port_mod)
    left = [n for n, v in vars(test_refmodel).items() if getattr(v, "__module__", "").startswith("rtlsdr_airband_tpu.")]
    assert not left, f"test_refmodel still holds the JAX package's {left}"
    owner, _, method = case.partition(".")
    fn = getattr(getattr(test_refmodel, owner)(), method) if method else getattr(test_refmodel, owner)
    fn(**kwargs)


def test_cases_cover_the_suite():
    """Every non-slow test of tests/test_refmodel.py is here, each parametrised
    value set once, and the aliasing hands them the port's classes."""
    assert len(CASES) == 12
    assert sum(c == "TestCTCSSRef.test_tone_detection" for c, _ in CASES) == 4
    assert not any(c.endswith("test_full_matrix") for c, _ in CASES)
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(sys.modules, "rtlsdr_airband_tpu.refmodel.channel_ref", channel_ref)
        from rtlsdr_airband_tpu.refmodel.channel_ref import ChannelRef

        assert ChannelRef is channel_ref.ChannelRef is not jax_channel_ref.ChannelRef
    finally:
        mp.undo()


def test_refmodel_outputs_equal_the_jax_refmodel():
    """A 0.3 s AM + NFM/CTCSS scene through both packages' ChannelizerRef and
    DeviceRef: channelizer outputs, audio and IQ taps equal bit for bit."""
    import rtlsdr_airband_tpu.utils.siggen as jax_siggen

    fs, n_fft, center, wr = 2_560_000, 512, 120_000_000, 16000
    kws = [dict(frequency=120_300_000, modulation="am", bandwidth=6000, notch=1000.0, has_iq_outputs=True),
           dict(frequency=120_700_000, modulation="nfm", ctcss=100.0)]
    n = int(fs * 0.3)
    outs = []
    for ref, gen in ((channel_ref, siggen), (jax_channel_ref, jax_siggen)):
        audio = gen.SignalGen(wr, seed=1).add_tone(700.0, 0.5).add_tone(100.0, 0.2).add_noise(0.02).render(wr)
        iq = gen.complex_noise(n, 0.02, seed=2)
        iq = iq + gen.am_carrier_iq(fs, kws[0]["frequency"] - center, n, audio=audio, carrier_ampl=0.35, audio_rate=wr)
        iq = iq + gen.nfm_carrier_iq(fs, kws[1]["frequency"] - center, n, audio=audio, carrier_ampl=0.35, audio_rate=wr)
        bins = np.array([ref.bin_for_freq(k["frequency"], center, fs, n_fft) for k in kws])
        mags, iqs = ref.ChannelizerRef(n_fft, fs, wr, bins).push(iq)
        chans = [ref.ChannelRef(ref.ChannelRefConfig(**k), wr, n_fft, fs, center) for k in kws]
        batches = ref.DeviceRef(chans, wr).push(mags, iqs)
        outs.append([mags, iqs, *(b for batch in batches for b in batch[:2]), gen.iq_to_u8(iq)])
    assert len(outs[0]) == len(outs[1]) > 4
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
