"""What the benchmark loads: never JAX or the JAX package, and its reference
nothing of the port; without the card a run prints no result."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT

RUN_TINY = """
import json, sys
import torch
torch.set_num_threads(2)
from benchmark.tests import bench_tiny as bt
with bt.host_kernel():
    rc, res, err = bt.run("mixed8192.block")
assert rc == 0 and res["correct"], err[-2000:]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", RUN_TINY], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "rtlsdr_airband_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_port_or_jax():
    ref = ROOT / "benchmark" / "reference"
    for f in sorted(ref.glob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] in ("numpy", "torch", "__future__", "dataclasses", "functools", "typing"), (f.name, name)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for f in sorted((ROOT / "benchmark").rglob("*.py")):
        for name in _imports(f):
            assert name.split(".")[0] not in harness.FORBIDDEN, (f, name)


def test_without_a_card_a_run_exits_without_a_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", "mixed8192.block", "--seed", str(2**31 + 99),
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # a directory that holds only BENCHMARK.json and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_an_unknown_cell_exits_without_a_result():
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", "no.such.cell", "--seed", "1", "--seconds", "1"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
