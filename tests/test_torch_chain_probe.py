"""Port parity: the chain-latency probe K2
(``rtlsdr_airband_tpu_torch/scripts/bench_chain_probe.py``) against the JAX
script ``scripts/bench_chain_probe.py``, its Pallas kernel run in interpret
mode on the CPU, plus the wrapper's CPU path and the script's output line.

The JAX script builds its kernel inside ``main()`` and reads W, L, K and REPS
as module globals, so the test loads it from its file, shrinks those, and
records the callables ``pallas_call`` returns (chain1, chain2, chain1w, in
the order main() makes them).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rtlsdr_airband_tpu_torch.scripts import bench_chain_probe as probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_SMALL, L_SMALL = 16, 4
KINDS = {"chain1": 32, "chain2": 32, "chain1w": 64}  # kind -> SUBL, as the script runs them

# XLA on the CPU contracts v * a + b into one fused multiply-add; the port
# rounds the product and the sum separately (as the kernel under --fmad=false
# does).  Each link then differs by at most half an ulp of |v| <= 4, and
# W_SMALL * L_SMALL = 64 links add up to well under 5e-5.
JAX_ATOL = 5e-5


@pytest.fixture(scope="module")
def jax_kernels():
    spec = importlib.util.spec_from_file_location("jax_bench_chain_probe", os.path.join(ROOT, "scripts", "bench_chain_probe.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    made = []
    real_pallas_call = pl.pallas_call

    def recording_pallas_call(*args, **kwargs):
        f = real_pallas_call(*args, **kwargs)
        made.append(f)
        return f

    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("W", W_SMALL), ("L", L_SMALL), ("K", 1), ("REPS", 1)):
            mp.setattr(script, name, value)
        mp.setenv("PROBE_CPU", "1")
        mp.setattr(pl, "pallas_call", recording_pallas_call)
        assert script.main() == 0
    assert len(made) == 3
    return dict(zip(KINDS, made))


def _input(subl: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(2, subl, 128)).astype(np.float32)


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_jax_kernel(jax_kernels, kind):
    x = _input(KINDS[kind], 11)
    want = np.asarray(jax_kernels[kind](x))
    got = probe.chain_probe_plain(torch.from_numpy(x), kind, W_SMALL, L_SMALL).numpy()
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ATOL)
    if kind != "chain2":  # row 1 is never touched
        assert np.array_equal(want[1], x[1]) and np.array_equal(got[1], x[1])
    else:
        assert not np.array_equal(got[1], x[1])


def _numpy_chain(x: np.ndarray, kind: str, w_trips: int, links: int) -> np.ndarray:
    """The recurrence in numpy float32, each product and sum rounded once."""
    f = np.float32
    a, b = x[0].copy(), x[1].copy()
    xa, xb = a * f(1e-4), b * f(1e-4)
    for _ in range(w_trips * links):
        a = a * f(0.9995) + xa
        if kind == "chain2":
            b = b * f(0.9997) + xb
    return np.stack([a, b])


@pytest.mark.parametrize("kind, w_trips, links", [("chain1", 30, 7), ("chain2", 25, 4), ("chain1w", 3, 40)])
def test_plain_equals_numpy_recurrence_bit_for_bit(kind, w_trips, links):
    x = _input(KINDS[kind], 12)
    got = probe.chain_probe_plain(torch.from_numpy(x), kind, w_trips, links).numpy()
    assert np.array_equal(got, _numpy_chain(x, kind, w_trips, links))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x = torch.from_numpy(_input(2, 13))
    before = probe.LAUNCHES
    for kind in KINDS:
        assert torch.equal(probe.chain_probe(x, kind, 5, L_SMALL), probe.chain_probe_plain(x, kind, 5, L_SMALL))
    assert probe.LAUNCHES == before
    assert torch.equal(probe.chain_probe(x, "chain1", 0, L_SMALL), x)


@pytest.mark.parametrize(
    "x, kind, error",
    [
        (torch.zeros(2, 4, 128, device="meta"), "chain1", "unsupported device"),
        (torch.zeros(2, 4, 64), "chain1", "shape"),
        (torch.zeros(3, 4, 128), "chain1", "shape"),
        (torch.zeros(2, 4, 128, dtype=torch.float64), "chain1", "dtype"),
        (torch.zeros(2, 128, 4).transpose(1, 2), "chain1", "contiguous"),
        (torch.zeros(2, 4, 128), "chain3", "kind"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(x, kind, error):
    before = probe.LAUNCHES
    with pytest.raises(ValueError, match=error):
        probe.chain_probe(x, kind, 5)
    assert probe.LAUNCHES == before


def test_main_on_cpu_prints_the_jax_scripts_keys(monkeypatch, capsys):
    for name, value in (("W", 3), ("L", 2), ("REPS", 1), ("K", 2), ("SUBL", 1)):
        monkeypatch.setattr(probe, name, value)
    monkeypatch.setenv("PROBE_CPU", "1")
    assert probe.main() == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "W", "L", "kinds", "chain2_vs_chain1", "wide_vs_chain1", "verdict", "device"}
    assert (last["metric"], last["W"], last["L"], last["device"]) == ("chain_probe", 3, 2, "cpu")
    assert list(last["kinds"]) == ["chain1", "chain2", "chain1w"]
    assert [last["kinds"][k]["subl"] for k in last["kinds"]] == [1, 1, 2]
    assert all(v["ms_per_block"] > 0 for v in last["kinds"].values())
    assert last["verdict"].startswith(("latency-bound", "issue/ordering-bound"))


def test_main_without_a_card_fails_rather_than_fall_back(monkeypatch, capsys):
    monkeypatch.delenv("PROBE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main() == 1
    assert capsys.readouterr().out == ""
