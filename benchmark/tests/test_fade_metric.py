"""The readers of ``fade_ms.block`` and ``fade_ms.app``: the fade-tail
kernel's device time a block, and None with nothing to read (no trace, or a
program without the kernel), whatever the other operations are called."""

from __future__ import annotations

import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests.test_trace_metrics import reader

K1 = "void (anonymous namespace)::demod_kernel<64, 1>(DemodArgs)"
FADE = "void (anonymous namespace)::fade_tail_kernel(FadeTailArgs, int)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32"
CUMMAX = "void at::native::tensor_kernel_scan_outer_dim_with_indices<long, long>(...)"


def context(ops, blocks=4, found=True, traced=True):
    tr = harness.Trace(10.0, 1.0, {k: [v, 1] for k, v in ops.items()}, {}, found) if traced else None
    return SimpleNamespace(trace_result=tr, blocks_in_window=blocks)


READERS = ("fade_ms.block", "fade_ms.app")


@pytest.mark.parametrize("name", READERS)
def test_reads_the_fade_tail_kernels_time_a_block(name):
    ctx = context({K1: 0.0118, FADE: 0.00036, GEMM: 0.0058})
    assert reader(name).read(ctx) == pytest.approx(0.09, rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reads_none_without_the_kernel_or_a_trace(name):
    assert reader(name).read(context({K1: 0.0118, CUMMAX: 0.0036})) is None  # the plain assembly
    assert reader(name).read(context({FADE: 0.00036}, traced=False)) is None  # --trace 0
    assert reader(name).read(context({}, found=False)) is None  # the CPU: no device operation
    assert reader(name).read(context({FADE: 0.00036}, blocks=0)) is None


def test_the_kernel_stays_out_of_the_k1_and_gemm_readers():
    """The kernel's name, its argument struct and its namespaces hold
    neither "demod" nor "gemm", the words the readers of ``k1_roofline_pct``
    and ``gemm_roofline_pct`` match, and its name holds ``fade_tail``."""
    src = (Path(harness.HERE).parent / "rtlsdr_airband_tpu_torch" / "csrc" / "fade_tail.cu").read_text()
    kernels = re.findall(r"(\w+)\(\s*const __grid_constant__ (\w+)", src)
    assert kernels == [("fade_tail_kernel", "FadeTailArgs")]
    for word in ("demod", "gemm"):
        assert not re.search(rf"namespace \w*{word}", src, re.I) and all(word not in n.lower() for k in kernels for n in k)
