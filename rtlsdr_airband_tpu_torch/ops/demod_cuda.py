"""Launcher of the demod kernel K1 (``csrc/demod.cu``).

Counterpart of ``rtlsdr_airband_tpu/ops/demod_pallas.py::demod_block_pallas``:
same arguments and returns, its schedule options ``unroll`` and ``pair``
included, ``interpret`` left out.  For CUDA tensors ``demod_block_cuda``
launches the kernel or raises; for CPU tensors it runs the plain PyTorch
version, ``ops.demod.demod_block``.

The kernel keeps a block's rings and input tiles in shared memory,
``BLOCK_WIDTH`` channels a block.  A CTCSS channel's Goertzel banks, tone
gate and what the gate feeds run after it in the CTCSS pass
(``csrc/demod_ctcss.cu``, one warp a channel, the tones over its lanes),
launched on the same stream when ``with_ctcss`` is on.  :func:`launch_k1`
launches both, K1 in any schedule.

The schedules (``csrc/demod_sched.cu``, a library of their own built at
first use): ``unroll`` U in ``UNROLLS`` steps U samples a loop trip;
``pair`` runs blocks of two ``PAIR_TILE``-channel tiles on one tile's
threads, each thread stepping one channel of each tile together.  Both are
the default's arithmetic in another order, so every output and state leaf
is the same, bit for bit; the default stays the default.  ``pair=None``
reads ``RTLSDR_DEMOD_PAIR`` ("1" turns it on), as the JAX package does, so
``Pipeline`` and ``App`` honour the variable; as in the JAX package the pair
schedule runs only where the tile count is even, and the default otherwise.

The kernel reads the state from the input tensors and writes a fresh state,
so the caller's state is never modified.  ``LAUNCHES`` counts kernel
launches, so a run can show that its main path went through the kernel;
``SCHEDULE_LAUNCHES`` counts them by schedule (``schedule_name``), so a run
can show which schedule ran; ``CTCSS_LAUNCHES`` counts the CTCSS pass's.

After K1 the block is assembled by ``fade_and_tail``: the AM close fade
rewrite, the carried tail and the open flags.  For CUDA tensors it launches
the fade-tail kernel (``csrc/fade_tail.cu``, built beside K1's library) or
raises, counted in ``FADE_LAUNCHES``; for CPU tensors it runs the plain
``ops.demod.apply_fade_and_tail``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os

import torch

from .. import _build
from ..constants import AGC_EXTRA
from .demod import FADE_DECAY, SQ_BUF, ChannelParams, CtcssState, DemodState, _fade_decay, apply_fade_and_tail, demod_block
from .goertzel import MAX_TONES

LAUNCHES = 0
CTCSS_LAUNCHES = 0  # CTCSS pass launches, one a K1 launch with with_ctcss
FADE_LAUNCHES = 0  # fade-tail kernel launches; the plain assembly never counts
SCHEDULE_LAUNCHES: collections.Counter = collections.Counter()
HOST_SCHEDULE = None  # the schedule demod_block_host ran last (a test aid)

BLOCK_WIDTH = 64  # channels a block at every unroll (csrc/demod_tiles.cuh's BLOCK_WIDTH)
UNROLLS = (1, 2, 4)  # samples a loop trip the kernel is built for
PAIR_TILE = 32  # channels a tile in the pair schedule; a pair block holds two
PAIR_ENV = "RTLSDR_DEMOD_PAIR"

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
_INT_ARGS = ("W", "C", "fm_quadri", "with_ctcss", "with_iq")

# DemodState leaves that are not [C] float32, by flat name (banks as fast_* / slow_*)
_STATE_ROWS = {"sq_buffer": SQ_BUF, "wavein_delay": AGC_EXTRA}
_STATE_ROWS.update({f: 3 for f in ("lp_xr", "lp_xi", "lp_yr", "lp_yi", "notch_x", "notch_y")})
_STATE_ROWS.update({f"{b}_{q}": MAX_TONES for b in ("fast", "slow") for q in ("q1", "q2")})
_STATE_INT = {
    "cur", "nxt", "delay", "low_signal_count", "sample_count", "open_count", "flappy_count",
    "recent_open_count", "closed_sample_count", "dm_phi",
} | {f"{b}_{k}" for b in ("fast", "slow") for k in ("count", "found", "not_found")}
_STATE_BOOL = {"using_post_filter"} | {f"{b}_{k}" for b in ("fast", "slow") for k in ("enough", "has_tone")}
_KERNEL_STATE = (  # DemodState leaves the kernel carries (iq_tail / waveout_tail are assembled here)
    [f for f in DemodState._fields if f not in ("fast", "slow", "iq_tail", "waveout_tail")]
    + [f"{b}_{k}" for b in ("fast", "slow") for k in CtcssState._fields]
)

_PARAM_BOOL = {"is_nfm", "needs_raw_iq", "has_iq_outputs", "using_manual", "lp_enabled", "notch_enabled", "ctcss_enabled", "fast_mask", "slow_mask"}
_PARAM_INT = {"dm_dphi", "fast_window", "slow_window"}


def _state_spec(name: str, C: int):
    dtype = _I32 if name in _STATE_INT else _BOOL if name in _STATE_BOOL else _F32
    return dtype, ((_STATE_ROWS[name], C) if name in _STATE_ROWS else (C,))


def _param_spec(name: str, C: int):
    dtype = _BOOL if name in _PARAM_BOOL else _I32 if name in _PARAM_INT else _F32
    if name in ("sin_lut", "cos_lut"):
        return dtype, (257,)
    return dtype, ((MAX_TONES, C) if name.endswith(("_coeff", "_mask")) else (C,))


def _flat_state(state: DemodState) -> dict:
    flat = {}
    for f in _KERNEL_STATE:
        bank, _, leaf = f.partition("_")
        flat[f] = getattr(getattr(state, bank), leaf) if bank in ("fast", "slow") and leaf in CtcssState._fields else getattr(state, f)
    return flat


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _struct_type(lib: ctypes.CDLL, struct: str, names_fn: str, ints) -> type:
    """ctypes mirror of the C struct ``struct``, built from the field names
    the library's ``names_fn`` reports, so the two cannot disagree on order;
    fields in ``ints`` are int32, the others pointers."""
    attr = f"_{struct}_type"
    cached = getattr(lib, attr, None)
    if cached is None:
        fn = getattr(lib, names_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = []
        fields = [(n, ctypes.c_int32 if n in ints else ctypes.c_void_p) for n in fn().decode().split(",")]
        cached = type(struct, (ctypes.Structure,), {"_fields_": fields})
        setattr(lib, attr, cached)
    return cached


def _args_type(lib: ctypes.CDLL) -> type:
    """ctypes mirror of the C ``DemodArgs``."""
    return _struct_type(lib, "DemodArgs", "demod_arg_names", _INT_ARGS)


def run_with(launch, lib, params: ChannelParams, state: DemodState, mags, iqs, fm_quadri, with_ctcss, with_iq):
    """Check the inputs, allocate the outputs, call ``launch(args)``
    and assemble (new_state, audio, iq_out, open_flags).  ``launch`` gets the
    ctypes ``DemodArgs``; a caller that times the kernel alone wraps
    :func:`launch_k1` in its own ``launch``."""
    if mags.dim() != 2:
        raise ValueError(f"mags: expected [W, C], got shape {tuple(mags.shape)}")
    W, C = mags.shape
    A = AGC_EXTRA
    if W < A or C < 1:
        raise ValueError(f"need W >= {A} samples and C >= 1 channels, got W={W}, C={C}")
    dev = mags.device
    t = {"mags": mags, "iqs": iqs, "iq_tail": state.iq_tail}
    _check("mags", mags, _F32, (W, C), dev)
    _check("iqs", iqs, _F32, (W, C, 2), dev)
    _check("iq_tail", state.iq_tail, _F32, (A, C, 2), dev)
    _check("waveout_tail", state.waveout_tail, _F32, (A, C), dev)
    for name in ChannelParams._fields:
        v = getattr(params, name)
        _check(f"params.{name}", v, *_param_spec(name, C), dev)
        t[f"p_{name}"] = v
    out = {}
    for name, v in _flat_state(state).items():
        dtype, shape = _state_spec(name, C)
        _check(f"state.{name}", v, dtype, shape, dev)
        t[f"s_{name}"] = v
        out[name] = t[f"o_{name}"] = torch.empty(shape, dtype=dtype, device=dev)
    for name in ("iqs", "iq_tail"):  # the kernel stages each IQ pair with one 8-byte copy
        if t[name].data_ptr() % 8:
            raise ValueError(f"{name}: not 8-byte aligned")
    t["audio_raw"] = audio_raw = torch.empty((W, C), dtype=_F32, device=dev)
    t["flags"] = flags = torch.empty((W, C), dtype=torch.uint8, device=dev)
    iq_out = torch.empty((W, C, 2), dtype=_F32, device=dev) if with_iq else torch.zeros((W, C, 2), dtype=_F32, device=dev)
    t["iq_out"] = iq_out if with_iq else None

    Args = _args_type(lib)
    ints = dict(W=W, C=C, fm_quadri=int(fm_quadri), with_ctcss=int(with_ctcss), with_iq=int(with_iq))
    args = Args(**{n: (ints[n] if n in ints else (t[n].data_ptr() if t[n] is not None else None)) for n, _ in Args._fields_})
    launch(args)  # t keeps every buffer alive until the call is queued

    audio, new_tail, open_now = fade_and_tail(state.waveout_tail, audio_raw, flags)
    bank = lambda b: CtcssState(**{k: out[f"{b}_{k}"] for k in CtcssState._fields})  # noqa: E731
    new_state = DemodState(
        **{f: out[f] for f in DemodState._fields if f not in ("fast", "slow", "iq_tail", "waveout_tail")},
        fast=bank("fast"),
        slow=bank("slow"),
        iq_tail=iqs[W - A :].clone(),
        waveout_tail=new_tail,
    )
    return new_state, audio, iq_out, open_now


def fade_and_tail(waveout_tail: torch.Tensor, waveout: torch.Tensor, flags: torch.Tensor):
    """The block's assembly after K1: :func:`ops.demod.apply_fade_and_tail`
    with the close marks and open flags read from K1's flag bytes (bit 0
    open, bit 1 AM close mark).

    waveout_tail: [A, C] float32; waveout: [W, C] float32 (K1's audio);
    flags: [W, C] uint8.  Returns (audio [W, C], new_tail [A, C], open_now
    [W, C] bool).  CUDA tensors launch the fade-tail kernel or raise; CPU
    tensors take the plain version, which the kernel equals bit for bit.
    """
    if waveout.device.type == "cpu":
        audio, new_tail = apply_fade_and_tail(waveout_tail, waveout, (flags & 2) != 0)
        return audio, new_tail, (flags & 1) != 0
    if waveout.device.type != "cuda":
        raise ValueError(f"fade_and_tail: unsupported device {waveout.device}")
    global FADE_LAUNCHES
    dev = waveout.device
    lib = fade_library()
    with torch.cuda.device(dev):
        audio, new_tail, open_now, args = _fade_tail_args(lib, waveout_tail, waveout, flags)
        launch_fade_tail(lib, args)
    FADE_LAUNCHES += 1
    return audio, new_tail, open_now


def _fade_tail_args(lib: ctypes.CDLL, waveout_tail, waveout, flags):
    """Check the inputs of the fade-tail kernel, allocate its outputs and
    fill its ``FadeTailArgs``: (audio, new_tail, open_now, args)."""
    if waveout.dim() != 2 or waveout_tail.dim() != 2:
        raise ValueError(f"fade_and_tail: expected [W, C] and [A, C], got {tuple(waveout.shape)} and {tuple(waveout_tail.shape)}")
    (W, C), A = waveout.shape, waveout_tail.shape[0]
    if not 1 <= A <= len(FADE_DECAY) or W < 1 or C < 1:
        raise ValueError(f"fade_and_tail: need 1 <= A <= {len(FADE_DECAY)}, W >= 1, C >= 1, got A={A}, W={W}, C={C}")
    dev = waveout.device
    _check("waveout_tail", waveout_tail, _F32, (A, C), dev)
    _check("waveout", waveout, _F32, (W, C), dev)
    _check("flags", flags, torch.uint8, (W, C), dev)
    audio = torch.empty((W, C), dtype=_F32, device=dev)
    new_tail = torch.empty((A, C), dtype=_F32, device=dev)
    open_now = torch.empty((W, C), dtype=_BOOL, device=dev)
    ptrs = dict(tail=waveout_tail, raw=waveout, flags=flags, decay=_fade_decay(dev), audio=audio, new_tail=new_tail, open_now=open_now)
    Args = _struct_type(lib, "FadeTailArgs", "fade_tail_arg_names", ("W", "C", "A"))
    args = Args(W=W, C=C, A=A, **{n: t.data_ptr() for n, t in ptrs.items()})
    return audio, new_tail, open_now, args


def launch_fade_tail(lib: ctypes.CDLL, args) -> None:
    """One launch of the fade-tail kernel on the current stream, in the
    segments it plans from (W, C) and the card; raises if it was refused."""
    rc = lib.fade_tail_launch(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fade-tail kernel launch failed: CUDA error {rc}")


def fade_tail_host(waveout_tail, waveout, flags, seg_rows: int):
    """Test aid: the fade-tail kernel's code (``csrc/fade_tail.cuh``) built
    for the host with g++ and run on CPU tensors, segment after segment, in
    segments of ``seg_rows`` rows.  Same returns as :func:`fade_and_tail`."""
    lib = host_library()
    audio, new_tail, open_now, args = _fade_tail_args(lib, waveout_tail, waveout, flags)
    if lib.fade_tail_host(ctypes.addressof(args), seg_rows) != 0:
        raise ValueError(f"host build: no segments of {seg_rows} rows")
    return audio, new_tail, open_now


def fade_tail_segment_rows(W: int, C: int, A: int = AGC_EXTRA, sms: int = 132) -> int:
    """The segment length the kernel plans for (W, C) on a card of ``sms``
    SMs (the H100 SXM's 132 by default), from the host build."""
    return int(host_library().fade_tail_segment_rows(W, C, A, sms))


def resolve_schedule(C: int, unroll: int, pair: bool | None) -> tuple[int, bool]:
    """The schedule that runs for ``C`` channels: (unroll, pair).

    ``pair=None`` reads ``RTLSDR_DEMOD_PAIR``.  Pair runs only where the
    count of ``PAIR_TILE``-channel tiles is even (the JAX package's rule,
    ``demod_pallas.py:708``); otherwise the default schedule runs at the
    same unroll.  Raises ``ValueError`` for an unroll not in ``UNROLLS``."""
    if unroll not in UNROLLS:
        raise ValueError(f"unroll {unroll!r}: the kernel is built for {UNROLLS} samples a loop trip")
    if pair is None:
        pair = os.environ.get(PAIR_ENV, "0") == "1"
    tiles = -(-C // PAIR_TILE)
    return unroll, bool(pair) and tiles % 2 == 0


def schedule_name(unroll: int, pair: bool) -> str:
    """"single_u1" (the default), "single_u2", ..., "pair_u1", ... ."""
    return f"{'pair' if pair else 'single'}_u{unroll}"


def demod_block_cuda(
    params: ChannelParams,
    state: DemodState,
    mags: torch.Tensor,  # [W, C]
    iqs: torch.Tensor,  # [W, C, 2]
    *,
    fm_quadri: bool = False,
    with_ctcss: bool = True,
    with_iq: bool = True,
    trace: bool = False,
    unroll: int = 1,
    pair: bool | None = None,
):
    """Drop-in replacement for :func:`ops.demod.demod_block`.

    Returns (new_state, audio [W, C], iq_out [W, C, 2], open_flags [W, C]).
    with_iq=False skips the per-sample IQ-tap stores (use when no channel has
    IQ outputs); iq_out is then zeros.  CUDA tensors launch the kernel in the
    schedule ``unroll`` / ``pair`` ask for (:func:`resolve_schedule`); CPU
    tensors take the plain version, which no schedule changes.  The kernel
    has no trace output: ``trace=True`` raises on any device (trace mode is
    the plain version's, as the JAX package traces through its XLA scan
    only).
    """
    if trace:
        raise ValueError("demod_block_cuda: K1 has no trace mode; call ops.demod.demod_block(..., trace=True)")
    unroll, pair = resolve_schedule(mags.shape[-1], unroll, pair)
    if mags.device.type == "cpu":
        st, audio, iq_out, open_now = demod_block(params, state, mags, iqs, fm_quadri=fm_quadri, with_ctcss=with_ctcss)
        return st, audio, (iq_out if with_iq else torch.zeros_like(iq_out)), open_now
    if mags.device.type != "cuda":
        raise ValueError(f"demod_block_cuda: unsupported device {mags.device}")

    def launch(args):
        global LAUNCHES, CTCSS_LAUNCHES
        launch_k1(args, unroll, pair)
        LAUNCHES += 1
        CTCSS_LAUNCHES += int(bool(args.with_ctcss))  # launch_k1's own condition for the pass
        SCHEDULE_LAUNCHES[schedule_name(unroll, pair)] += 1

    with torch.cuda.device(mags.device):
        return run_with(launch, _k1_library(unroll, pair), params, state, mags, iqs, fm_quadri, with_ctcss, with_iq)


def _bind_common(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ("demod_smem_bytes", "demod_pair_smem_bytes"):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_size_t
            fn.argtypes = []
    return lib


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """The nvcc-built ``csrc/demod.cu``, built at first use and kept; the
    CTCSS pass and the fade-tail kernel that follow it build beside it, in
    the same parallel call."""
    _build.build_kernels(("demod.cu", "demod_ctcss.cu", "fade_tail.cu"))
    lib = _bind_common(_build.load_kernel("demod.cu"))
    lib.demod_launch.restype = ctypes.c_int
    lib.demod_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


@functools.cache
def schedule_library() -> ctypes.CDLL:
    """The nvcc-built ``csrc/demod_sched.cu`` (K1's unroll and pair
    schedules), built at first use and kept."""
    lib = _bind_common(_build.load_kernel("demod_sched.cu"))
    lib.demod_launch_schedule.restype = ctypes.c_int
    lib.demod_launch_schedule.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


@functools.cache
def ctcss_library() -> ctypes.CDLL:
    """The nvcc-built ``csrc/demod_ctcss.cu`` (built with K1's library by
    :func:`cuda_library`, or here at first use) and kept."""
    lib = _build.load_kernel("demod_ctcss.cu")
    lib.demod_ctcss_launch.restype = ctypes.c_int
    lib.demod_ctcss_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


@functools.cache
def fade_library() -> ctypes.CDLL:
    """The nvcc-built ``csrc/fade_tail.cu`` (built with K1's library by
    :func:`cuda_library`, or here at first use) and kept."""
    lib = _build.load_kernel("fade_tail.cu")
    lib.fade_tail_launch.restype = ctypes.c_int
    lib.fade_tail_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


@functools.cache
def host_library() -> ctypes.CDLL:
    """The g++ build of ``csrc/demod_host.cpp``, a test aid."""
    lib = _bind_common(_build.load_host("demod_host.cpp"))
    lib.fade_tail_host.restype = ctypes.c_int
    lib.fade_tail_host.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fade_tail_segment_rows.restype = ctypes.c_int
    lib.fade_tail_segment_rows.argtypes = [ctypes.c_int] * 4
    lib.demod_host_tiled.restype = ctypes.c_int
    lib.demod_host_tiled.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    return lib


def smem_bytes(lib: ctypes.CDLL) -> int:
    """Dynamic shared memory of one block of ``BLOCK_WIDTH`` channels."""
    return int(lib.demod_smem_bytes())


def pair_smem_bytes(lib: ctypes.CDLL) -> int:
    """Dynamic shared memory of one pair block (two ``PAIR_TILE``-channel
    tiles); ``lib`` the schedule library or the host build."""
    return int(lib.demod_pair_smem_bytes())


def _k1_library(unroll: int = 1, pair: bool = False) -> ctypes.CDLL:
    """The library that holds K1 in schedule (unroll, pair): the default's,
    :func:`cuda_library`, or :func:`schedule_library` for the others."""
    return cuda_library() if unroll == 1 and not pair else schedule_library()


def launch_k1(args, unroll: int = 1, pair: bool = False) -> None:
    """One launch of K1 in schedule (unroll, pair), resolved already
    (:func:`resolve_schedule`), on the current stream, then, when
    ``args.with_ctcss`` is set, one of the CTCSS pass on the same stream:
    the whole demod.  Raises if either was refused.  Counts nothing:
    :func:`demod_block_cuda` counts its own."""
    lib = _k1_library(unroll, pair)
    stream = torch.cuda.current_stream().cuda_stream
    if unroll == 1 and not pair:
        rc = lib.demod_launch(ctypes.addressof(args), stream)
    else:
        rc = lib.demod_launch_schedule(ctypes.addressof(args), unroll, int(pair), stream)
    if rc != 0:
        raise RuntimeError(f"demod kernel launch ({schedule_name(unroll, pair)}) failed: CUDA error {rc}")
    if args.with_ctcss:
        rc = ctcss_library().demod_ctcss_launch(ctypes.addressof(args), stream)
        if rc != 0:
            raise RuntimeError(f"CTCSS pass launch failed: CUDA error {rc}")


def demod_block_host(params, state, mags, iqs, *, fm_quadri=False, with_ctcss=True, with_iq=True, unroll=1, pair=None):
    """Test aid: the kernel's code (``csrc/demod_step.cuh``,
    ``csrc/demod_tiles.cuh``) built for the host with g++ and run on CPU
    tensors as the kernel runs it (channel groups of ``BLOCK_WIDTH`` or
    pair blocks, [row][width] rings, input tiles), in the schedule
    ``unroll`` / ``pair`` resolve to, as :func:`demod_block_cuda` resolves
    them; then, with ``with_ctcss``, the CTCSS pass's code
    (``csrc/demod_ctcss.cuh``) tile by tile as a warp runs it.  Same returns as :func:`demod_block_cuda`; the schedule that ran
    is left in ``HOST_SCHEDULE``.  Not used by the port's own paths."""
    global HOST_SCHEDULE
    lib = host_library()
    unroll, pair = resolve_schedule(mags.shape[-1], unroll, pair)

    def launch(args):
        if lib.demod_host_tiled(ctypes.addressof(args), unroll, int(pair)) != 0:
            raise RuntimeError(f"host build: schedule {schedule_name(unroll, pair)} not built")
    HOST_SCHEDULE = schedule_name(unroll, pair)
    return run_with(launch, lib, params, state, mags, iqs, fm_quadri, with_ctcss, with_iq)
