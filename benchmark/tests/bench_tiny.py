"""Small versions of the cells for the CPU tests: the same entries, traffic
generator, checks and metrics at 32 channels, with K1's host
build (``demod_cuda.demod_block_host``) in place of the card's kernel."""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json

from benchmark import harness

ROOT = harness.ROOT


def load(name: str) -> dict:
    return harness.load_json(harness.HERE / name)


def tiny_config(name: str, sample_format: str | None = None, fullscale: float | None = None) -> dict:
    """The configuration at 32 channels; in another sample format (and full
    scale) where one is given."""
    cfg = copy.deepcopy(load(f"configs/{name}.json"))
    cfg["channels"]["count"] = 32
    if sample_format is not None:
        cfg["sample_format"] = sample_format
    if fullscale is not None:
        cfg["fullscale"] = fullscale
    if "app" in cfg:
        cfg["app"].update(blocks_per_dispatch=2, active_fetch_slots=16)
    return cfg


def tiny_workload(cell: str) -> dict:
    w = copy.deepcopy(load(f"workloads/{cell}.json"))
    w["check"]["channels"] = 8
    return w


def tiny_scene(name: str) -> dict:
    s = copy.deepcopy(load(f"scenes/{name}.json"))
    s["segment_blocks"] = 4
    return s


def tiny_files(cell: str, sample_format: str | None = None, fullscale: float | None = None) -> tuple[dict, dict, dict]:
    """(workload, configuration, scene) of ``cell`` at the small size."""
    w = tiny_workload(cell)
    return w, tiny_config(w["config"], sample_format, fullscale), tiny_scene(w["scene"])


def run(cell: str, *, seed: int = 5, seconds: float = 1.0, trace: int = 0, sample_format: str | None = None,
        fullscale: float | None = None):
    """(exit code, result line or None, stderr) of one CPU run of ``cell``."""
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace, device="cpu")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.run_cell(args, files=tiny_files(cell, sample_format, fullscale))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def load_bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


@contextlib.contextmanager
def host_kernel():
    """K1's host build in place of the card's kernel, as the repo's CPU tests run it."""
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.runtime import pipeline

    orig = pipeline.demod_block_cuda
    pipeline.demod_block_cuda = demod_cuda.demod_block_host
    try:
        yield
    finally:
        pipeline.demod_block_cuda = orig
