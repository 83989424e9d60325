"""Launcher of the demod kernel K1 (``csrc/demod.cu``).

Counterpart of ``rtlsdr_airband_tpu/ops/demod_pallas.py::demod_block_pallas``:
same arguments and returns, minus the TPU schedule knobs.  For CUDA tensors
``demod_block_cuda`` launches the kernel or raises; for CPU tensors it runs
the plain PyTorch version, ``ops.demod.demod_block``.

The kernel keeps a block's rings, Goertzel banks and input tiles in shared
memory; it is built at the block widths ``BLOCK_WIDTHS`` and launched at
``BLOCK_WIDTH`` unless the caller names another built width.  The first
design, with rings and banks in device memory, stays launchable through
``launch_global_kernel`` only, as the yardstick ``chip_smoke.py`` times the
kernel against.

The kernel reads the state from the input tensors and writes a fresh state,
so the caller's state is never modified.  ``LAUNCHES`` counts kernel
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..constants import AGC_EXTRA
from .demod import SQ_BUF, ChannelParams, CtcssState, DemodState, apply_fade_and_tail, demod_block
from .goertzel import MAX_TONES

LAUNCHES = 0

BLOCK_WIDTHS = (32, 64)  # channels a block, the widths csrc/demod.cu instantiates
BLOCK_WIDTH = 64  # the default: the faster of the two on the card (PERF.md, section 6)

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


def _args_type(lib: ctypes.CDLL) -> type:
    """ctypes mirror of the C ``DemodArgs``, built from the field names the
    library reports, so the two cannot disagree on order."""
    cached = getattr(lib, "_demod_args_type", None)
    if cached is None:
        lib.demod_arg_names.restype = ctypes.c_char_p
        lib.demod_arg_names.argtypes = []
        names = lib.demod_arg_names().decode().split(",")
        fields = [(n, ctypes.c_int32 if n in _INT_ARGS else ctypes.c_void_p) for n in names]
        cached = type("DemodArgs", (ctypes.Structure,), {"_fields_": fields})
        lib._demod_args_type = cached
    return cached


def run_with(launch, lib, params: ChannelParams, state: DemodState, mags, iqs, fm_quadri, with_ctcss, with_iq):
    """Check the inputs, allocate outputs and scratch, call ``launch(args)``
    and assemble (new_state, audio, iq_out, open_flags).  ``launch`` gets the
    ctypes ``DemodArgs``; a caller that times the kernel alone wraps
    :func:`launch_kernel` in its own ``launch``."""
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

    open_now = (flags & 1) != 0
    fade = (flags & 2) != 0
    audio, new_tail = apply_fade_and_tail(state.waveout_tail, audio_raw, fade)
    bank = lambda b: CtcssState(**{k: out[f"{b}_{k}"] for k in CtcssState._fields})  # noqa: E731
    new_state = DemodState(
        **{f: out[f] for f in DemodState._fields if f not in ("fast", "slow", "iq_tail", "waveout_tail")},
        fast=bank("fast"),
        slow=bank("slow"),
        iq_tail=iqs[W - A :].clone(),
        waveout_tail=new_tail,
    )
    return new_state, audio, iq_out, open_now


def _check_width(block_width: int) -> None:
    if block_width not in BLOCK_WIDTHS:
        raise ValueError(f"block width {block_width}: the kernel is built for {BLOCK_WIDTHS} channels a block")


def demod_block_cuda(
    params: ChannelParams,
    state: DemodState,
    mags: torch.Tensor,  # [W, C]
    iqs: torch.Tensor,  # [W, C, 2]
    *,
    fm_quadri: bool = False,
    with_ctcss: bool = True,
    with_iq: bool = True,
    block_width: int = BLOCK_WIDTH,
):
    """Drop-in replacement for :func:`ops.demod.demod_block`.

    Returns (new_state, audio [W, C], iq_out [W, C, 2], open_flags [W, C]).
    with_iq=False skips the per-sample IQ-tap stores (use when no channel has
    IQ outputs); iq_out is then zeros.  CUDA tensors launch the kernel with
    ``block_width`` channels a block (one of ``BLOCK_WIDTHS``); CPU tensors
    take the plain version.
    """
    _check_width(block_width)
    if mags.device.type == "cpu":
        st, audio, iq_out, open_now = demod_block(params, state, mags, iqs, fm_quadri=fm_quadri, with_ctcss=with_ctcss)
        return st, audio, (iq_out if with_iq else torch.zeros_like(iq_out)), open_now
    if mags.device.type != "cuda":
        raise ValueError(f"demod_block_cuda: unsupported device {mags.device}")
    lib = cuda_library()

    def launch(args):
        global LAUNCHES
        launch_kernel(lib, args, block_width)
        LAUNCHES += 1

    with torch.cuda.device(mags.device):
        return run_with(launch, lib, params, state, mags, iqs, fm_quadri, with_ctcss, with_iq)


def _bind_common(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.demod_smem_bytes.restype = ctypes.c_size_t
    lib.demod_smem_bytes.argtypes = [ctypes.c_int]
    lib.demod_global_scratch_rows.restype = ctypes.c_int
    lib.demod_global_scratch_rows.argtypes = []
    return lib


@functools.cache
def cuda_library() -> ctypes.CDLL:
    """The nvcc-built ``csrc/demod.cu``, built at first use and kept."""
    lib = _bind_common(_build.load_kernel("demod.cu"))
    lib.demod_launch.restype = ctypes.c_int
    lib.demod_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.demod_launch_global.restype = ctypes.c_int
    lib.demod_launch_global.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return lib


@functools.cache
def host_library() -> ctypes.CDLL:
    """The g++ build of ``csrc/demod_host.cpp``, a test aid."""
    lib = _bind_common(_build.load_host("demod_host.cpp"))
    lib.demod_host_tiled.restype = ctypes.c_int
    lib.demod_host_tiled.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.demod_host_global.restype = ctypes.c_int
    lib.demod_host_global.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def smem_bytes(lib: ctypes.CDLL, block_width: int) -> int:
    """Dynamic shared memory of one block of the kernel at ``block_width``."""
    _check_width(block_width)
    return int(lib.demod_smem_bytes(block_width))


def _global_scratch(lib: ctypes.CDLL, args, device) -> torch.Tensor:
    return torch.empty((lib.demod_global_scratch_rows(), args.C), dtype=_F32, device=device)


def launch_kernel(lib: ctypes.CDLL, args, block_width: int = BLOCK_WIDTH) -> None:
    """One launch of K1 on the current stream; raises if it was refused."""
    _check_width(block_width)
    rc = lib.demod_launch(ctypes.addressof(args), block_width, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"demod kernel launch failed: CUDA error {rc}")


def launch_global_kernel(lib: ctypes.CDLL, args) -> None:
    """One launch of the first, device-memory design of K1 on the current
    stream (the yardstick; no path of the port calls it); raises if it was
    refused.  Its scratch is freed in stream order after the launch."""
    scratch = _global_scratch(lib, args, torch.device("cuda", torch.cuda.current_device()))
    rc = lib.demod_launch_global(ctypes.addressof(args), scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"demod (device-memory design) launch failed: CUDA error {rc}")


def demod_block_host(params, state, mags, iqs, *, fm_quadri=False, with_ctcss=True, with_iq=True, block_width=BLOCK_WIDTH):
    """Test aid: the kernel's code (``csrc/demod_step.cuh``,
    ``csrc/demod_tiles.cuh``) built for the host with g++ and run on CPU
    tensors.  ``block_width`` 32 or 64 runs the shared-memory design as the
    kernel does (channel groups of that width, [row][width] rings and banks,
    input tiles); None runs the first, device-memory design.  Same returns
    as :func:`demod_block_cuda`.  Not used by the port's own paths."""
    lib = host_library()
    if block_width is None:
        def launch(args):
            scratch = _global_scratch(lib, args, mags.device)
            lib.demod_host_global(ctypes.addressof(args), scratch.data_ptr())
    else:
        _check_width(block_width)

        def launch(args):
            lib.demod_host_tiled(ctypes.addressof(args), block_width)
    return run_with(launch, lib, params, state, mags, iqs, fm_quadri, with_ctcss, with_iq)
