"""The fade-tail kernel's own code on the host.

``demod_cuda.fade_tail_host`` runs ``csrc/fade_tail.cuh`` (built with g++
from ``csrc/demod_host.cpp``) segment after segment, as the card runs its
segments side by side.  It must equal the plain assembly,
``ops.demod.apply_fade_and_tail`` with the flag decode, bit for bit in the
audio, the new tail and the open flags, whatever the segment length: each
segment finds the marks before it by itself.  The cases put marks where the
look-back and the carry can go wrong: at row 0, inside the carried tail's
rows, at W - 1, 1, 98, 99 and 100 rows before a segment's start, two marks
closer than a fade, and a tail that an earlier block rewrote.
"""

import numpy as np
import pytest
import torch

from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
from rtlsdr_airband_tpu_torch.ops import demod_cuda
from rtlsdr_airband_tpu_torch.ops.demod import apply_fade_and_tail

A = AGC_EXTRA
H100_SMS = 132


def _scene(W, C, seed, marks=(), mark_rate=0.0):
    """A carried tail, K1's audio and its flag bytes: open bits on about half
    the samples, close marks at ``marks`` ((row, channel) pairs) and on a
    share ``mark_rate`` of the samples."""
    rng = np.random.default_rng(seed)
    tail = rng.normal(0, 0.5, (A, C)).astype(np.float32)
    raw = rng.normal(0, 0.5, (W, C)).astype(np.float32)
    flags = (rng.random((W, C)) < 0.5).astype(np.uint8) | ((rng.random((W, C)) < mark_rate).astype(np.uint8) << 1)
    for n, c in marks:
        flags[n, c] |= 2
    return torch.from_numpy(tail), torch.from_numpy(raw), torch.from_numpy(flags)


def _plain(tail, raw, flags):
    audio, new_tail = apply_fade_and_tail(tail, raw, (flags & 2) != 0)
    return audio, new_tail, (flags & 1) != 0


def _assert_same(want, got, label):
    for name, x, y in zip(("audio", "new_tail", "open_now"), want, got):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{label}: {name} {x.dtype}{tuple(x.shape)} vs {y.dtype}{tuple(y.shape)}"
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), f"{label}: {name} differs"


def _rewritten(tail, raw, audio, new_tail):
    """Rows the assembly changed, over the whole [A + W] buffer."""
    return (torch.cat([audio, new_tail]) != torch.cat([tail, raw])).any(dim=1)


SEGMENTS = (1, 8, 64, 99, 100, 128)

# (W, C, marks, what the case holds)
PLACED = {
    "mark_at_row_0": (257, 3, [(0, 1)], "a mark at row 0 rewrites rows 1-99 from the carried tail's first row"),
    "marks_in_tail_rows": (257, 3, [(37, 0), (99, 2), (1, 1)], "marks in rows 1-99 take their base from the carried tail"),
    "mark_at_last_row": (257, 65, [(256, 0), (256, 64), (200, 5)], "a mark at W - 1 rewrites the whole new tail"),
    "marks_197_apart": (2000, 3, [(300, 0), (497, 0), (1703, 1), (1900, 1)], "two fades that do not overlap"),
    "marks_50_apart": (257, 3, [(120, 0), (170, 0), (10, 2), (60, 2)], "the latest mark wins, its base un-rewritten"),
    "no_marks": (2000, 65, [], "nothing is rewritten: the buffer shifts by W rows"),
}


@pytest.mark.parametrize("case", sorted(PLACED))
def test_placed_marks_match_plain(case):
    W, C, marks, _ = PLACED[case]
    tail, raw, flags = _scene(W, C, seed=len(case), marks=marks)
    want = _plain(tail, raw, flags)
    rows = _rewritten(tail, raw, *want[:2])
    assert bool(rows.any()) == bool(marks)
    for seg in SEGMENTS + (demod_cuda.fade_tail_segment_rows(W, C), A + W):
        _assert_same(want, demod_cuda.fade_tail_host(tail, raw, flags, seg), f"{case}, {seg} rows a segment")


@pytest.mark.parametrize("seg", (64, 128, 200))
def test_marks_just_before_a_segment_start(seg):
    """Marks 1, 98, 99 and 100 rows before a segment's start, in segments of
    ``seg`` rows: the first three reach into the segment, the fourth not."""
    W, C = 2000, 4
    marks = [(seg - 1, 0), (2 * seg - 98, 1), (3 * seg - 99, 2), (4 * seg - 100, 3)]
    tail, raw, flags = _scene(W, C, seed=seg, marks=marks)
    want = _plain(tail, raw, flags)
    full_out, full_in = torch.cat([want[0], want[1]]), torch.cat([tail, raw])
    for (n, c), k in zip(marks, (1, 2, 3, 4)):
        start = k * seg
        assert (full_out[start, c] != full_in[start, c]) == (start - n < A), (n, c)
    _assert_same(want, demod_cuda.fade_tail_host(tail, raw, flags, seg), f"{seg} rows a segment")


@pytest.mark.parametrize("C", (1, 3, 65, 130))
@pytest.mark.parametrize("W", (100, 257, 2000))
def test_random_population_matches_plain(W, C):
    """Marks on 2 % of the samples from a seed (many closer than a fade),
    at the segment length the card would take and at others."""
    tail, raw, flags = _scene(W, C, seed=1000 * W + C, mark_rate=0.02)
    want = _plain(tail, raw, flags)
    for seg in (demod_cuda.fade_tail_segment_rows(W, C), 8, 99, 256):
        _assert_same(want, demod_cuda.fade_tail_host(tail, raw, flags, seg), f"W={W}, C={C}, {seg} rows a segment")


@pytest.mark.parametrize("C", (3, 130))
def test_three_chained_blocks_carry_a_rewritten_tail(C):
    """Three blocks of W = 100, each taking the tail the last one left: a
    mark in the last rows of a block rewrites the tail the next block
    carries in, and a mark in its first rows takes that rewritten value."""
    W = A
    tail_p = tail_h = torch.from_numpy(np.random.default_rng(C).normal(0, 0.5, (A, C)).astype(np.float32))
    prev_raw = None
    for blk in range(3):
        _, raw, flags = _scene(W, C, seed=10 * C + blk, marks=[(90, 0), (5, C - 1), (40 + blk, C // 2)], mark_rate=0.01)
        if prev_raw is not None:
            assert not torch.equal(tail_p[:, 0], prev_raw[:, 0])  # the mark at row 90 rewrote the carried tail
        want = _plain(tail_p, raw, flags)
        got = demod_cuda.fade_tail_host(tail_h, raw, flags, 8)
        _assert_same(want, got, f"C={C}, block {blk}")
        tail_p, tail_h, prev_raw = want[1], got[1], raw


def test_wrapper_on_cpu_is_the_plain_assembly():
    """``fade_and_tail`` on CPU tensors: the plain version and the flag
    decode, no kernel launch."""
    tail, raw, flags = _scene(257, 65, seed=5, mark_rate=0.02)
    before = demod_cuda.FADE_LAUNCHES
    _assert_same(_plain(tail, raw, flags), demod_cuda.fade_and_tail(tail, raw, flags), "wrapper")
    assert demod_cuda.FADE_LAUNCHES == before


@pytest.mark.parametrize("what", ("dtype", "shape", "layout", "width"))
def test_host_build_rejects_bad_inputs(what):
    tail, raw, flags = _scene(257, 8, seed=6)
    if what == "dtype":
        flags = flags.to(torch.int32)
    elif what == "shape":
        flags = flags[:-1]
    elif what == "layout":
        raw = raw.t().contiguous().t()
    else:
        tail = torch.zeros((A + 1, 8))
    with pytest.raises(ValueError):
        demod_cuda.fade_tail_host(tail, raw, flags, 8)


@pytest.mark.parametrize("C, want", ((1, 64), (65, 64), (2048, 64), (2280, 64), (8192, 128), (65536, 704)))
def test_segment_rows_fill_the_card(C, want):
    """The planned segments at W = 2000 on an H100's 132 SMs: a multiple of
    the 8 rows loaded ahead, at least 64 rows, and about 1024 threads an SM
    where the rows allow."""
    W = 2000
    rows = demod_cuda.fade_tail_segment_rows(W, C, A, H100_SMS)
    assert rows == want
    assert -(-(A + W) // rows) * C >= H100_SMS * 1024 or rows <= 72
