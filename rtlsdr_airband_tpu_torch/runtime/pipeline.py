"""Streaming block pipeline: raw IQ in -> per-channel audio blocks out.

Counterpart of ``rtlsdr_airband_tpu/runtime/pipeline.py``, which replaces
the reference's demodulate() thread and ring-buffer protocol (reference: src/rtl_airband.cpp:286-672) with a block
program ``(raw_block, bins, params, state) -> (state', outputs)`` and a
host-side framer that carries stream alignment between blocks:

 - ``pipeline_block``: decode, channelizer (matched filter or FFT), the demod
   recurrence (the CUDA kernel K1 for CUDA tensors), the user-order restore,
   the per-channel snapshots and, with AFC, the last frame's spectrum; over
   a mesh of devices (``parallel.sharding``) a time-sharded channelizer and
   K1 once per channel shard;
 - ``pipeline_chain``: k blocks in one call, threading the state, with the
   fetch economy (active-channel gather, int16 / block-float audio, fade-tail
   suppression, one meta snapshot a chunk) packed on the device;
 - ``Pipeline``: the framer.  It primes the state from the stream, dispatches
   chunks, fetches them on a copy stream behind the dispatch front, rebuilds
   dense per-block dicts on the host, and checkpoints.

Block structure (all sizes fixed per pipeline): one block emits
WAVE_BATCH = wave_rate/8 audio samples per channel (reference:
rtl_airband.h:73); the channelizer consumes hop = round(sample_rate /
wave_rate) input samples per audio sample with an fft_size-hop look-ahead
halo (rtl_airband.cpp:394); priming computes the first AGC_EXTRA
channelizer outputs to seed the demod's look-back delay lines.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from .. import interop
from ..constants import AGC_EXTRA
from ..ops import demod_cuda
from ..ops.channelizer import (
    block_input_len,
    channelize_fft,
    channelize_matmul,
    decode_raw_iq,
    last_frame_spectrum_power,
    make_taps,
)
from ..ops.demod import ChannelParams, DemodState, _levels, demod_block
from ..ops.demod_cuda import demod_block_cuda
from ..ops.params import ChannelSpec, cost_group_permutation, init_demod_state, make_channel_params
from ..ops.sampleconv import SampleFormat, decode_iq
from ..ops.window import blackman_harris_7
from ..parallel import sharding
from ..refmodel.channel_ref import bin_for_freq
from . import trace

META_F = ("signal_level", "noise_level", "squelch_level")  # f32 [C] gauges
META_I = ("open_count", "flappy_count", "ctcss_found", "ctcss_not_found")  # i32 [C] counters

_RAW_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16, np.dtype(np.float32): torch.float32}


def channelize_block(x, bins, window, *, hop, fft_size, n_frames, use_fft=False, taps=None):
    """The block program's channelizer step: (mags [W, C], iq [W, C, 2]).
    ``taps`` (precomputed ``make_taps(bins, window)``) serves the
    matched-filter path only."""
    if use_fft:
        return channelize_fft(x, bins, window, hop=hop, fft_size=fft_size, n_frames=n_frames)
    return channelize_matmul(x, bins, window, hop=hop, fft_size=fft_size, n_frames=n_frames, taps=taps)


def _state_meta(params: ChannelParams, state: DemodState):
    """(squelch_level, sig_outside) snapshots from a carried state (device
    channel order): Squelch::squelch_level() (squelch.cpp:164-177) and
    signal_outside_filter() (squelch.cpp:152-154)."""
    squelch_level = _levels(params, state.noise_floor, state.recent_open_count)
    sig_outside = state.using_post_filter & (state.pre_capped >= squelch_level) & (state.post_capped < state.sq_buffer[0])
    return squelch_level, sig_outside


def _snapshots(params: ChannelParams, state: DemodState, inv_perm) -> dict:
    """The per-channel observability snapshots of a carried state, in user
    order: what the reference's stats and TUI read from the live Squelch
    (output.cpp:598-869, rtl_airband.cpp:632-643)."""
    squelch_level, sig_outside = _state_meta(params, state)
    perm = (lambda a: a[inv_perm]) if inv_perm is not None else (lambda a: a)  # noqa: E731
    return dict(
        signal_level=perm(state.pre_full),
        noise_level=perm(state.noise_floor),
        squelch_level=perm(squelch_level),
        sig_outside=perm(sig_outside),
        open_count=perm(state.open_count),
        flappy_count=perm(state.flappy_count),
        ctcss_found=perm(state.slow.found),
        ctcss_not_found=perm(state.slow.not_found),
    )


def pipeline_block(
    x: torch.Tensor,  # [L, 2] f32 IQ pairs, or [2L] raw when sample_fmt is set
    bins: torch.Tensor,  # [C] int32 FFT bin per channel
    window: torch.Tensor,  # [N] f32
    params: ChannelParams,
    state: DemodState,
    *,
    hop: int,
    fft_size: int,
    n_frames: int,
    use_fft: bool = False,
    fm_quadri: bool = False,
    with_ctcss: bool = True,
    with_afc: bool = False,
    with_iq: bool = True,
    demod_backend: str = "cuda",
    sample_fmt: str = "pairs",
    fullscale: float = 1.0,
    taps: tuple[torch.Tensor, torch.Tensor] | None = None,
    inv_perm: torch.Tensor | None = None,
    mesh=None,
):
    """Fused channelize + demod for one block; returns (state', outputs).

    demod_backend: 'cuda' (the kernel for CUDA tensors, the plain version for
    CPU tensors) or 'plain' (the plain PyTorch version on either device).
    use_fft selects the FFT channelizer.  with_afc adds ``spectrum_power``,
    |X|^2 of the block's last frame.  with_iq=False elides the per-sample
    IQ-tap output.  sample_fmt: 'pairs' (x is [L, 2] f32) or
    'u8'/'s8'/'s16'/'f32' raw interleaved IQ decoded on the device.  taps:
    optional precomputed ``make_taps(bins, window)``.  inv_perm: optional [C]
    index restoring user channel order on every per-channel output (channels
    run grouped by cost_group_permutation).

    MESH MODE (``mesh`` a ``parallel.sharding.PipelineMesh``): ``x`` is a
    (body, tail) pair, body a list with each time shard's slice of the block
    (raw when ``sample_fmt`` is set) on its cell, tail [fft_size - hop, 2]
    pairs; ``params`` and ``state`` are sharded over channels
    (``sharding.shard_last``); ``bins``/``window``/``taps`` tensors or
    per-cell lists (``sharding.replicate``).  Decode per time shard, the
    time-sharded channelizer with its halo exchange, the reshard to channel
    shards, the demod (K1 on the card) once per channel shard on its cell,
    then the per-channel outputs gathered: see :func:`_mesh_block`.  The
    channelizer is always the matched filter here (``use_fft`` is ignored,
    as in the JAX package).
    """
    if mesh is not None:
        return _mesh_block(x, bins, window, params, state, mesh=mesh, hop=hop, fft_size=fft_size, n_frames=n_frames,
                           fm_quadri=fm_quadri, with_ctcss=with_ctcss, with_afc=with_afc, with_iq=with_iq,
                           demod_backend=demod_backend, sample_fmt=sample_fmt, fullscale=fullscale, taps=taps, inv_perm=inv_perm)
    if sample_fmt != "pairs":
        x = decode_raw_iq(x, sample_fmt, fullscale)
    mags, iqs = channelize_block(x, bins, window, hop=hop, fft_size=fft_size, n_frames=n_frames, use_fft=use_fft, taps=taps)
    state, audio, iq_out, open_flags = _demod(params, state, mags, iqs, fm_quadri, with_ctcss, with_iq, demod_backend)
    if inv_perm is not None:
        audio = audio[:, inv_perm]
        open_flags = open_flags[:, inv_perm]
        iq_out = iq_out[:, inv_perm] if with_iq else iq_out
    out = dict(
        audio=audio,  # [W, C]
        iq_out=iq_out,  # [W, C, 2] f32 IQ pairs
        open_flags=open_flags,  # [W, C] bool
        active=torch.any(open_flags, dim=0),  # [C]
        **_snapshots(params, state, inv_perm),
    )
    if with_afc:
        out["spectrum_power"] = last_frame_spectrum_power(x, window, hop=hop, fft_size=fft_size, n_frames=n_frames)
    return state, out


def _demod(params, state, mags, iqs, fm_quadri, with_ctcss, with_iq, demod_backend):
    if demod_backend == "cuda":
        return demod_block_cuda(params, state, mags, iqs, fm_quadri=fm_quadri, with_ctcss=with_ctcss, with_iq=with_iq)
    if demod_backend == "plain":
        return demod_block(params, state, mags, iqs, fm_quadri=fm_quadri, with_ctcss=with_ctcss)
    raise ValueError(f"unknown demod_backend {demod_backend!r}")


def _shard_layout(mesh, shards: list) -> list:
    """The channel layout of a sharded params or state list."""
    cb = sharding.infer_channel_dim(next(s for s in shards if s is not None))
    layout = sharding.channel_layout(mesh, cb * len(shards))
    if len(layout) != len(shards):
        raise ValueError(f"{len(shards)} channel shards of {cb}, the mesh's layout has {len(layout)}")
    return layout


def _gather_meta(mesh, layout, parts: list, inv_perm):
    """Per-shard (meta_f [3, Cb], meta_i [5, Cb]) gathered into the [3, C] /
    [5, C] rows in user order, replicated."""
    perm = (lambda a: a.index_select(1, inv_perm)) if inv_perm is not None else (lambda a: a)  # noqa: E731
    return tuple(perm(mesh.transport.gather(mesh, [p[i] if p is not None else None for p in parts], layout, 1)) for i in (0, 1))


def _on_shards(mesh, layout, fn, params: list, *shard_lists) -> list:
    """``fn(params[j], *(lst[j] for lst in shard_lists))`` on shard j's cell
    for every shard this process holds (None for the others)."""
    out = []
    for j, (cell, _) in enumerate(layout):
        if params[j] is None:
            out.append(None)
            continue
        with mesh.on(cell):
            out.append(fn(params[j], *(lst[j] for lst in shard_lists)))
    return out


def _shard_meta(mesh, layout, params: list, state: list) -> list:
    """Each shard's snapshot rows (``_meta_rows``), on its cell."""
    return _on_shards(mesh, layout, lambda p, st: _meta_rows(_snapshots(p, st, None)), params, state)


def _mesh_must_ship(mesh, params: list, state: list, inv_perm):
    """Fade-tail suppression's must-ship channels ([C], user order) from the
    sharded entry state: see :func:`pack_block`."""
    layout = _shard_layout(mesh, params)
    must = mesh.transport.gather(mesh, _on_shards(mesh, layout, lambda p, st: _must_ship(st, p, None), params, state), layout, 0)
    return must[inv_perm] if inv_perm is not None else must


def _mesh_block(x, bins, window, params: list, state: list, *, mesh, hop, fft_size, n_frames, fm_quadri, with_ctcss,
                with_afc, with_iq, demod_backend, sample_fmt, fullscale, taps, inv_perm):
    """The block program over a mesh (:func:`pipeline_block`, mesh mode).
    Returns (state' sharded, outputs).  ``active`` and the per-channel
    snapshots are gathered into [C] tensors in user order (replicated).  The
    dense [W, C] audio, IQ and flags are gathered onto the home cell and put
    in user order when one process drains every channel (the transport's
    ``gathers_dense``); across processes they stay with their shards in
    device order (``sharding.ChannelShards``)."""
    if demod_backend not in ("cuda", "plain"):
        raise ValueError(f"unknown demod_backend {demod_backend!r}")
    gathers = mesh.transport.gathers_dense
    if with_afc and not gathers:
        raise ValueError("AFC reads the spectrum in one process: a multi-process mesh runs without it")
    body, tail = x
    with mesh.scope():
        rows = sharding.time_sharded_rows(mesh, body, tail, bins, window, hop=hop, fft_size=fft_size, n_frames=n_frames,
                                          taps=taps, sample_fmt=sample_fmt, fullscale=fullscale)
        C = (next(b for b in bins if b is not None) if isinstance(bins, list) else bins).shape[0]
        layout = sharding.channel_layout(mesh, C)
        if len(params) != len(layout) or len(state) != len(layout):
            raise ValueError(f"params/state in {len(params)}/{len(state)} shards; {C} channels on this mesh take {len(layout)}")
        shards = sharding.reshard_rows(mesh, rows, layout, n_frames)
        demod = _on_shards(mesh, layout, lambda p, st, sh: _demod(p, st, *sh, fm_quadri, with_ctcss, with_iq, demod_backend),
                           params, state, shards)
        new_state = [d[0] if d is not None else None for d in demod]
        dense = {k: [d[i] if d is not None else None for d in demod] for i, k in enumerate(("audio", "iq_out", "open_flags"), 1)}
        dense["active"] = _on_shards(mesh, layout, lambda _, f: torch.any(f, dim=0), params, dense["open_flags"])
        meta_f, meta_i = _gather_meta(mesh, layout, _shard_meta(mesh, layout, params, new_state), inv_perm)
        active = mesh.transport.gather(mesh, dense["active"], layout, 0)
        out = dict(active=active[inv_perm] if inv_perm is not None else active)
        if gathers:
            home = mesh.device(mesh.home)
            for k in ("audio", "iq_out", "open_flags"):
                if k == "iq_out" and not with_iq:
                    out[k] = torch.zeros((n_frames, C, 2), device=home)
                    continue
                a = mesh.transport.gather(mesh, dense[k], layout, 1)
                out[k] = a.index_select(1, inv_perm) if inv_perm is not None else a
        else:
            for k in ("audio", "iq_out", "open_flags"):
                out[k] = sharding.ChannelShards(dense[k], [sl for _, sl in layout])
        out = {k: out[k] for k in ("audio", "iq_out", "open_flags", "active")}
        out.update({name: meta_f[i] for i, name in enumerate(META_F)})
        out["sig_outside"] = meta_i[len(META_I)].to(torch.bool)
        out.update({name: meta_i[i] for i, name in enumerate(META_I)})
        if with_afc:
            last = mesh.time_cell(mesh.shape["time"] - 1)
            with mesh.on(last):
                sp = last_frame_spectrum_power(rows[-1][2], sharding.on_cell(mesh, window, last), hop=hop, fft_size=fft_size,
                                               n_frames=n_frames // mesh.shape["time"])
            out["spectrum_power"] = sharding.copy_to(sp, mesh.device(mesh.home), mesh.stream(last),
                                                     sharding.current_stream(mesh.device(mesh.home)))
    return new_state, out


def _meta_rows(snap: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Snapshots packed into meta_f [3, C] f32 and meta_i [5, C] i32 (the
    four counters, then sig_outside)."""
    meta_f = torch.stack([snap[k] for k in META_F])
    meta_i = torch.stack([snap[k].to(torch.int32) for k in META_I] + [snap["sig_outside"].to(torch.int32)])
    return meta_f, meta_i


def select_slots(score: torch.Tensor, slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``slots`` best channels by score, ties to the lower channel index,
    as ``jax.lax.top_k`` orders them: (values [S], channel indices [S]).  A
    stable descending sort keeps equal scores in index order on every
    device; ``torch.topk`` promises no order among ties."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:slots], idx[:slots]


def quantize_audio(a: torch.Tensor, audio_fmt: str) -> dict:
    """The audio wire format of the device-to-host fetch: 'f32' as is,
    'i16' (linear int16, ~90 dB quantization SNR, half the bytes) or 'i8bf'
    (block-float: int8 mantissas and one f32 scale per column of the block,
    ~49 dB SNR against the column's peak, a quarter of the bytes; exact
    zeros stay exact).  ``Pipeline._to_host`` restores float by dtype."""
    if audio_fmt == "i16":
        # audio is already NaN-scrubbed and clamped to +-1.0
        # (rtl_airband.cpp:594-604); clip, then cast
        return dict(audio=torch.clamp(torch.round(a * 32767.0), -32768.0, 32767.0).to(torch.int16))
    if audio_fmt == "i8bf":
        scale = torch.amax(torch.abs(a), dim=0)  # [S or C]
        # 127 / scale as a true division of two tensors: PyTorch may turn a
        # Python scalar operand into a multiply by a reciprocal, which can
        # move a mantissa by one at a .5 boundary
        inv = torch.where(scale > 0.0, torch.full_like(scale, 127.0) / scale, torch.zeros_like(scale))
        return dict(audio=torch.round(a * inv[None, :]).to(torch.int8), audio_scale=scale * float(np.float32(1.0 / 127.0)))
    if audio_fmt == "f32":
        return dict(audio=a)
    raise ValueError(f"unknown audio_fmt {audio_fmt!r}")


def _must_ship(st_in: DemodState, params: ChannelParams, inv_perm):
    csc, ocnt, nfm = st_in.closed_sample_count, st_in.open_count, params.is_nfm
    if inv_perm is not None:
        csc, ocnt, nfm = csc[inv_perm], ocnt[inv_perm], nfm[inv_perm]
    return nfm & (ocnt > 0) & (csc < AGC_EXTRA + 2)


def pack_block(
    out: dict,
    st_in: DemodState,
    params: ChannelParams,
    *,
    inv_perm: torch.Tensor | None = None,
    active_slots: int = 0,
    with_flags: bool = False,
    with_iq: bool = True,
    with_afc: bool = False,
    audio_fmt: str = "f32",
    suppress_fade_tails: bool = False,
    meta_per_chunk: bool = False,
    must_ship: torch.Tensor | None = None,
) -> dict:
    """One block's outputs packed for the device-to-host fetch (see
    :func:`pipeline_chain`).  ``st_in`` is the state the block started from:
    fade-tail suppression reads its squelch fields, unless the caller passes
    their verdict as ``must_ship`` ([C], user order; a mesh gathers it from
    its shards)."""
    packed = dict(audio=out["audio"], active=out["active"])
    if not meta_per_chunk:
        packed["meta_f"], packed["meta_i"] = _meta_rows(out)
    if with_flags:
        packed["open_flags"] = out["open_flags"]
    if active_slots:
        audio = out["audio"]
        slots = min(active_slots, audio.shape[1])
        # gather channels with ANY nonzero audio, not just squelch-open ones:
        # the AM squelch-close fade tail (and the reference's 0.5 waveout
        # init, config.cpp:315) emits audio on channels whose squelch is
        # already closed.  Squelch-open channels outrank fade-tail-only ones
        # when slots are scarce.
        nonzero = torch.amax(torch.abs(audio), dim=0) > 0.0
        if suppress_fade_tails:
            # a closed channel's block audio lives only in its first
            # AGC_EXTRA samples (the carried waveout tail), which the host
            # synthesizes, except when the tail holds real delayed audio: an
            # NFM channel that closed within the last ~AGC_EXTRA samples
            # (closed_sample_count at block entry); open_count == 0 excludes
            # the never-opened startup tail
            if must_ship is None:
                must_ship = _must_ship(st_in, params, inv_perm)
            nonzero = nonzero & (out["active"] | must_ship)
        score = out["active"].to(torch.int32) * 2 + nonzero.to(torch.int32)
        vals, idx = select_slots(score, slots)
        valid = vals > 0
        idx = torch.where(valid, idx, -1).to(torch.int32)
        g = torch.clamp(idx, min=0).long()
        packed["audio"] = torch.where(valid[None, :], audio[:, g], 0.0)
        packed["slot_channel"] = idx
        packed["n_active"] = torch.sum(score > 0).to(torch.int32)
        if with_iq:
            packed["iq_out"] = torch.where(valid[None, :, None], out["iq_out"][:, g], 0.0)
    elif with_iq:
        packed["iq_out"] = out["iq_out"]
    packed.update(quantize_audio(packed["audio"], audio_fmt))
    if with_afc:
        packed["spectrum_power"] = out["spectrum_power"]
    return packed


def pipeline_chain(
    x: torch.Tensor,  # flat raw [(2·)L_total] or pairs [L_total, 2] covering k_blocks overlapping blocks
    bins: torch.Tensor,
    window: torch.Tensor,
    params: ChannelParams,
    state: DemodState,
    *,
    k_blocks: int,
    hop: int,
    fft_size: int,
    n_frames: int,
    use_fft: bool = False,
    fm_quadri: bool = False,
    with_ctcss: bool = True,
    with_afc: bool = False,
    with_iq: bool = True,
    demod_backend: str = "cuda",
    sample_fmt: str = "pairs",
    fullscale: float = 1.0,
    taps: tuple[torch.Tensor, torch.Tensor] | None = None,
    inv_perm: torch.Tensor | None = None,
    active_slots: int = 0,
    with_flags: bool = False,
    audio_fmt: str = "f32",
    suppress_fade_tails: bool = False,
    meta_per_chunk: bool = False,
    mesh=None,
):
    """``k_blocks`` streaming blocks in one call, threading the demod state
    (a Python loop over the blocks; the reference decouples the same stages
    with threads, rtl_airband.cpp:1093-1112).  Returns (state', packed),
    every packed output stacked [K, ...] with the JAX package's keys.

    Per-channel scalars are packed into ``meta_f`` [K, 3, C] f32 (META_F)
    and ``meta_i`` [K, 5, C] i32 (META_I, then sig_outside);
    ``meta_per_chunk`` ships one [3, C] / [5, C] snapshot of the final state
    instead (stats read them at a 15 s cadence, output.cpp:833-869).

    ``active_slots`` = S > 0 enables the active-channel gather: audio for at
    most S channels with audio ([K, W, S]), their channel indices
    (``slot_channel`` [K, S] i32, -1 = empty) and the count of channels that
    wanted a slot (``n_active`` [K], for overflow accounting); closed
    channels reconstruct as silence on the host, as the reference's outputs
    consume nothing while squelch is closed (output.cpp:598-660).
    ``with_flags`` also ships the per-sample [K, W, C] open_flags.
    ``audio_fmt``: 'f32', 'i16' or 'i8bf' (:func:`quantize_audio`).
    ``suppress_fade_tails`` (gather mode only): channels whose block audio is
    only the deterministic squelch-closed tail (the AM close fade 0.94^i,
    rtl_airband.cpp:542-546, or the 0.5-initialized startup tail,
    config.cpp:315) are not shipped; ``Pipeline._to_host`` synthesizes them.

    MESH MODE (``mesh`` set): ``x`` is a (bodies, tails) pair of stacked
    per-block inputs, ``bodies`` a list with each time shard's [K, body/T]
    slices (raw, or [K, body/T, 2] pairs) on its cell and ``tails`` [K,
    fft_size - hop, 2] pairs (blocks overlap by the halo, so the stacked
    layout re-ships ~0.1% of the stream; in exchange every time shard's
    slice boundary is fixed).  Each block runs the mesh block program of
    :func:`pipeline_block`; params and state are sharded.  ``active`` and
    the meta rows are replicated [C] in user order.  In one process the
    dense audio is gathered and packed as above (the slot selection runs
    over the gathered [C] scores); across processes it stays channel-sharded
    (``sharding.ChannelShards`` of [K, W, Cb], device order) so each
    process drains only the channels it holds, and the fetch economy (slots,
    quantized audio, flags, AFC) is not offered.
    """
    if mesh is not None:
        return _mesh_chain(x, bins, window, params, state, mesh=mesh, k_blocks=k_blocks, hop=hop, fft_size=fft_size,
                           n_frames=n_frames, fm_quadri=fm_quadri, with_ctcss=with_ctcss, with_afc=with_afc, with_iq=with_iq,
                           demod_backend=demod_backend, sample_fmt=sample_fmt, fullscale=fullscale, taps=taps,
                           inv_perm=inv_perm, active_slots=active_slots, with_flags=with_flags, audio_fmt=audio_fmt,
                           suppress_fade_tails=suppress_fade_tails, meta_per_chunk=meta_per_chunk)
    need = block_input_len(n_frames, hop, fft_size)
    step = n_frames * hop
    per = 1 if sample_fmt == "pairs" else 2  # entries of x a sample
    block_kw = dict(
        hop=hop, fft_size=fft_size, n_frames=n_frames, use_fft=use_fft, fm_quadri=fm_quadri,
        with_ctcss=with_ctcss, with_afc=with_afc, with_iq=with_iq, demod_backend=demod_backend,
        sample_fmt=sample_fmt, fullscale=fullscale, taps=taps, inv_perm=inv_perm,
    )
    pack_kw = dict(
        inv_perm=inv_perm, active_slots=active_slots, with_flags=with_flags, with_iq=with_iq, with_afc=with_afc,
        audio_fmt=audio_fmt, suppress_fade_tails=suppress_fade_tails, meta_per_chunk=meta_per_chunk,
    )
    packs = []
    st = state
    for k in range(k_blocks):
        st_in = st  # the block's entry state: fade-tail suppression reads it
        st, out = pipeline_block(x[per * k * step : per * (k * step + need)], bins, window, params, st, **block_kw)
        packs.append(pack_block(out, st_in, params, **pack_kw))
    packed = {key: torch.stack([p[key] for p in packs]) for key in packs[0]}
    if meta_per_chunk:
        packed["meta_f"], packed["meta_i"] = _meta_rows(_snapshots(params, st, inv_perm))
    return st, packed


def _mesh_chain(x, bins, window, params, state, *, mesh, k_blocks, inv_perm, active_slots, with_flags, with_iq, with_afc,
                audio_fmt, suppress_fade_tails, meta_per_chunk, **block_kw):
    """:func:`pipeline_chain` over a mesh (see its docstring)."""
    gathers = mesh.transport.gathers_dense
    if not gathers and (active_slots or with_flags or with_afc or audio_fmt != "f32"):
        raise ValueError("a multi-process mesh ships dense float32 audio only: no active slots, flags, AFC or quantized audio")
    bodies, tails = x
    pack_kw = dict(inv_perm=inv_perm, active_slots=active_slots, with_flags=with_flags, with_iq=with_iq, with_afc=with_afc,
                   audio_fmt=audio_fmt, suppress_fade_tails=suppress_fade_tails, meta_per_chunk=meta_per_chunk)
    packs = []
    st = state
    for k in range(k_blocks):
        must = _mesh_must_ship(mesh, params, st, inv_perm) if active_slots and suppress_fade_tails else None
        xk = ([b[k] if b is not None else None for b in bodies], tails[k])
        st, out = pipeline_block(xk, bins, window, params, st, mesh=mesh, inv_perm=inv_perm, with_iq=with_iq, with_afc=with_afc,
                                 **block_kw)
        if gathers:
            packs.append(pack_block(out, None, None, must_ship=must, **pack_kw))
        else:
            p = dict(audio=out["audio"], active=out["active"])
            if not meta_per_chunk:
                p["meta_f"], p["meta_i"] = _meta_rows(out)
            if with_iq:
                p["iq_out"] = out["iq_out"]
            packs.append(p)

    def stack(key):
        first = packs[0][key]
        if isinstance(first, sharding.ChannelShards):
            return sharding.ChannelShards(
                [torch.stack([p[key].parts[j] for p in packs]) if part is not None else None for j, part in enumerate(first.parts)],
                first.slices)
        return torch.stack([p[key] for p in packs])

    packed = {key: stack(key) for key in packs[0]}
    if meta_per_chunk:
        layout = _shard_layout(mesh, params)
        packed["meta_f"], packed["meta_i"] = _gather_meta(mesh, layout, _shard_meta(mesh, layout, params, st), inv_perm)
    return st, packed


def _torch_device(name) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Pipeline: no CUDA device; pass PipelineConfig(device='cpu') for the plain PyTorch version")
    return dev


@dataclass
class PipelineConfig:
    sample_rate: int = 2_560_000
    center_freq: int = 120_000_000
    fft_size: int = 512
    wave_rate: int = 8000
    sample_format: str = "f32c"  # 'u8' | 's8' | 's16' | 'f32' | 'f32c' (complex64 in)
    fullscale: float = 1.0
    channelizer: str = "matmul"  # 'matmul' | 'fft'
    fm_quadri: bool = False
    chunk_blocks: int = 1  # blocks chained per dispatch
    async_depth: int = 0  # in-flight chunks before feed() yields (0 = sync)
    active_slots: int = 0  # >0: fetch only open channels' audio (S slots)
    fetch_open_flags: bool = False  # ship per-sample [W, C] flags (diagnostic)
    fetch_audio_i16: bool = False  # legacy alias for fetch_audio_fmt='i16'
    fetch_audio_fmt: str = ""  # '' | 'f32' | 'i16' | 'i8bf' (see pipeline_chain)
    suppress_fade_tails: bool = False  # host-synthesize closed-channel tails
    fetch_meta_per_chunk: bool = False  # one meta snapshot per chunk, not per block
    demod_backend: str = "cuda"  # 'cuda' (K1 on the card) | 'plain'
    device: str = "cuda"  # 'cuda' | 'cpu' (the plain versions, for tests)
    # multi-device (reference analog: multiple_demod_threads device-data
    # parallelism, rtl_airband.cpp:1052-1090 — here one device's channels
    # span a ('time', 'chan') mesh of devices of the ``device`` type)
    mesh: object = None  # parallel.sharding.PipelineMesh | None

    @property
    def hop(self) -> int:
        return int(round(self.sample_rate / self.wave_rate))

    @property
    def wave_batch(self) -> int:
        return self.wave_rate // 8

    @property
    def audio_fmt(self) -> str:
        return self.fetch_audio_fmt or ("i16" if self.fetch_audio_i16 else "f32")


class Pipeline:
    """One device's streaming channelizer + demod pipeline (over a mesh of
    devices when ``cfg.mesh`` is set)."""

    def __init__(self, cfg: PipelineConfig, specs: list[ChannelSpec]):
        if cfg.demod_backend not in ("cuda", "plain"):
            raise ValueError(f"unknown demod_backend {cfg.demod_backend!r}")
        self.cfg = cfg
        self.specs = specs
        self.device = _torch_device(cfg.device)
        # mesh mode: every cell has compute streams of this pipeline's own;
        # the home cell's device is where the pipeline primes, gathers and
        # packs its outputs (on the pipeline's own stream, below)
        self.mesh = cfg.mesh.with_own_streams() if cfg.mesh is not None else None
        if self.mesh is not None:
            home = self.mesh.device(self.mesh.home)
            if home.type != self.device.type:
                raise ValueError(f"PipelineConfig.device {cfg.device!r} but the mesh's cells are {home.type} devices")
            self.device = home
        # the pipeline's own compute stream on the card: every launch, copy
        # and allocation of its tensors is made on it (see _on_stream), so
        # feed/flush may be called from any thread (the App's per-device
        # demod workers feed, its main thread flushes at stop)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.C = len(specs)
        self.W = cfg.wave_batch
        self.A = AGC_EXTRA
        self.hop = cfg.hop
        self.N = cfg.fft_size
        # mesh mode: the device-side channel population is padded up to a
        # multiple of the FULL cell count, so the per-channel demod always
        # shards over every cell (an indivisible C, a prime population or a
        # lone scan channel, would otherwise fall back to fewer shards).  The
        # pad is inert AM channels at the device center (bin 0, ampfactor 0),
        # appended AFTER the cost-grouped user channels and dropped by the
        # _inv_perm gather, so nothing downstream (slot gather, meta, host)
        # ever sees them.
        self.C_dev = self.C
        self._pad_specs: list[ChannelSpec] = []
        if self.mesh is not None:
            T = self.mesh.shape["time"]
            if self.W % T:
                raise ValueError(f"wave_batch {self.W} not divisible by time shards {T}")
            if self.C % self.mesh.size:
                self.C_dev = -(-self.C // self.mesh.size) * self.mesh.size
                self._pad_specs = [ChannelSpec(frequency=cfg.center_freq, modulation="am", ampfactor=0.0)
                                   for _ in range(self.C_dev - self.C)]
        with self._on_stream():
            self.window = torch.as_tensor(blackman_harris_7(self.N), device=self.device)
            self._set_channels(specs)
        self.any_ctcss = bool(any(s.ctcss > 0 for s in specs))
        self.any_afc = bool(any(s.afc for s in specs))

        self._pending: np.ndarray | None = None  # raw 1-D or [L, 2] f32 pairs
        self._ship: str | None = None  # 'u8' | 's8' | 's16' | 'pairs' (lazy)
        self._inflight: list = []  # [(k_blocks, first block id, fetch)] FIFO
        self._primed = False
        self.state: DemodState | None = None
        self.blocks_processed = 0
        self.last_yielded = -1  # id of the block most recently yielded (ids count from 0 as blocks_processed does)
        self.gather_overflow_count = 0  # active-gather slot overflows (see _to_host)
        self.fetched_bytes = 0  # device-to-host bytes of every chunk dispatched
        self._warm_threads: list = []  # background kernel builds (joined in close())
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        # reused buffers of active-gather mode (see _to_host): one block's
        # fetched slots restored slot-major [S, W] (and their integer
        # copy), and the channel-major dense [C, W] audio / [C, W, 2] iq
        # they are copied into; yielded audio/iq are views of these, valid
        # until the NEXT block
        self._slot_rows: np.ndarray | None = None
        self._slot_ints: np.ndarray | None = None
        self._dense_audio: np.ndarray | None = None
        self._dense_dirty: np.ndarray = np.zeros(0, np.int64)
        self._dense_iq: np.ndarray | None = None
        self._dense_iq_dirty: np.ndarray = np.zeros(0, np.int64)
        # fade-tail suppression host state (cfg.suppress_fade_tails): per
        # channel, the last emitted sample of the most recent SHIPPED block
        # (0 = nothing pending) and the one-time startup-prefix flag; the
        # factors 0.94^i are those of the device's fade (ops/demod.py)
        self._tail_pending = np.zeros(self.C, np.float32)
        self._tail_startup = True
        self._pow94 = np.power(np.float32(0.94), np.arange(1, AGC_EXTRA, dtype=np.float32))

        self._prime_len = (self.A - 1) * self.hop + self.N
        self._block_need = self.W * self.hop  # new samples consumed per block
        self._block_len = block_input_len(self.W, self.hop, self.N)

    def _sharded(self, state: DemodState):
        """A full [C_dev] state as the pipeline carries it: sharded over the
        mesh's cells in mesh mode."""
        return sharding.shard_last(self.mesh, state, channel_dim=self.C_dev) if self.mesh is not None else state

    def _on_stream(self):
        """Context of every device operation of the pipeline: its compute
        stream on the card, whatever the calling thread's current stream;
        nothing on the CPU."""
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def _set_channels(self, specs: list[ChannelSpec]) -> None:
        """Channel order, params, bins and taps.  Device slot j processes
        user channel _order[j] (cost-class grouping keeps the kernel's warps
        uniform on their per-channel branches); every per-channel output is
        restored to user order by _inv_perm."""
        cfg = self.cfg
        self.any_iq = bool(any(s.has_iq_outputs for s in specs))
        self._order = cost_group_permutation(specs)
        self._unperm = np.argsort(self._order).astype(np.int32)
        identity = np.array_equal(self._order, np.arange(self.C, dtype=np.int32))
        # a [C] gather over [C_dev] channels: it also drops the mesh pad
        self._inv_perm = None if identity and not self._pad_specs else torch.as_tensor(self._unperm.astype(np.int64), device=self.device)
        self.params = make_channel_params(
            [specs[i] for i in self._order] + self._pad_specs,
            wave_rate=cfg.wave_rate, sample_rate=cfg.sample_rate, center_freq=cfg.center_freq, fft_size=cfg.fft_size,
            device=self.device,
        )
        if self.mesh is not None:  # one ChannelParams a channel shard, on its cell
            self.params = sharding.shard_last(self.mesh, self.params, channel_dim=self.C_dev)
        # FFT bin per channel in USER order (reference: config.cpp:661-664);
        # mutable for AFC/scan.  self.bins is the device-order copy.
        self.base_bins = np.array(
            [bin_for_freq(s.frequency, cfg.center_freq, cfg.sample_rate, cfg.fft_size) for s in specs], np.int32
        )
        self._set_device_bins(self._device_bins(self.base_bins))

    def _device_bins(self, user_bins: np.ndarray) -> np.ndarray:
        """User-order bins -> device order, with the mesh pad on bin 0."""
        return np.concatenate([np.asarray(user_bins, np.int32)[self._order], np.zeros(len(self._pad_specs), np.int32)])

    def _set_device_bins(self, dev_bins: np.ndarray) -> None:
        self.bins = torch.as_tensor(np.asarray(dev_bins, np.int32), device=self.device)
        self.user_bins = np.asarray(dev_bins, np.int32)[self._unperm]
        self._taps = make_taps(self.bins, self.window)  # bins change at control cadence, not per block
        if self.mesh is not None:  # the channelizer's inputs on every cell
            self._cell_inputs = sharding.replicate(self.mesh, (self.bins, self.window, self._taps))

    def _block_args(self) -> tuple:
        """(bins, window, taps) as the chain takes them: on the device, or
        one copy a mesh cell."""
        if self.mesh is None:
            return self.bins, self.window, self._taps
        return tuple([c[i] if c is not None else None for c in self._cell_inputs] for i in range(3))

    # ----------------------------------------------------------------- host

    def _decode(self, raw) -> np.ndarray:
        """Decode to [L, 2] float32 IQ pairs (complex values never cross to
        the device: IQ travels as float32 pairs, as in the JAX package)."""
        if self.cfg.sample_format == "f32c" or (isinstance(raw, np.ndarray) and np.iscomplexobj(raw)):
            z = np.asarray(raw, np.complex64)
            return np.stack([z.real, z.imag], axis=-1).astype(np.float32)
        if isinstance(raw, np.ndarray) and raw.ndim == 2 and raw.shape[1] == 2 and raw.dtype == np.float32:
            return raw
        if self.cfg.sample_format == "f32" and isinstance(raw, np.ndarray) and raw.dtype == np.uint8:
            raw = raw.view("<f4")  # a ring's bytes: the values are little-endian float32, not one a byte
        return decode_iq(raw, SampleFormat(self.cfg.sample_format), self.cfg.fullscale)

    # -- raw-domain helpers: _pending holds either [L, 2] f32 pairs or the
    # -- raw interleaved stream (u8/s8 bytes as uint8, s16 as int16) that is
    # -- decoded on the device (decode_raw_iq) to quarter the H2D traffic.

    def _resolve_ship(self, raw) -> str:
        if isinstance(raw, (bytes, bytearray)) or (isinstance(raw, np.ndarray) and raw.dtype == np.uint8 and raw.ndim == 1):
            if self.cfg.sample_format in ("u8", "s8", "s16"):
                return self.cfg.sample_format
        return "pairs"

    def _ingest(self, raw) -> None:
        if self._ship is None:
            self._ship = self._resolve_ship(raw)
        if self._ship == "pairs":
            x = self._decode(raw)
        elif self._ship == "s16":
            b = bytes(raw) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, np.uint8).tobytes()
            x = np.frombuffer(b, np.int16)
        else:  # u8 / s8 ship as the byte stream
            x = np.frombuffer(raw, np.uint8) if isinstance(raw, (bytes, bytearray)) else np.asarray(raw, np.uint8)
        if self._pending is None or len(self._pending) == 0:
            self._pending = x
        else:
            self._pending = np.concatenate([self._pending, x], axis=0)

    def _pending_samples(self) -> int:
        if self._pending is None:
            return 0
        return self._pending.shape[0] if self._ship == "pairs" else self._pending.shape[0] // 2

    def _pending_slice(self, n_samples: int):
        """First n_samples of the pending stream, in ship domain."""
        return self._pending[:n_samples] if self._ship == "pairs" else self._pending[: 2 * n_samples]

    def _pending_consume(self, n_samples: int) -> None:
        self._pending = self._pending[n_samples:] if self._ship == "pairs" else self._pending[2 * n_samples :]

    def _chain_kwargs(self, ship: str | None = None) -> dict:
        if ship is None:
            ship = self._ship
        return dict(
            hop=self.hop, fft_size=self.N, n_frames=self.W,
            use_fft=self.cfg.channelizer == "fft", fm_quadri=self.cfg.fm_quadri,
            with_ctcss=self.any_ctcss, with_afc=self.any_afc, with_iq=self.any_iq,
            sample_fmt=ship if ship != "pairs" else "pairs",
            fullscale=float(self.cfg.fullscale),
            active_slots=max(0, int(self.cfg.active_slots)),
            with_flags=bool(self.cfg.fetch_open_flags),
            audio_fmt=self.cfg.audio_fmt,
            suppress_fade_tails=bool(self.cfg.suppress_fade_tails) and int(self.cfg.active_slots) > 0,
            meta_per_chunk=bool(self.cfg.fetch_meta_per_chunk),
            demod_backend=self.cfg.demod_backend,
            mesh=self.mesh,
        )

    def _to_device(self, a: np.ndarray, device: torch.device | None = None) -> torch.Tensor:
        """A host array on the pipeline's device (or ``device``).  To the
        card it is staged through pinned memory and copied without blocking
        the host (the caching host allocator keeps the staging buffer until
        the copy has run); on the CPU it is copied, since pending arrays may
        view the caller's bytes."""
        device = device if device is not None else self.device
        if device.type == "cpu":
            return torch.from_numpy(np.array(a))
        staged = torch.empty(a.shape, dtype=_RAW_DTYPES[a.dtype], pin_memory=True)
        staged.numpy()[...] = a
        return staged.to(device, non_blocking=True)

    def _stacked_input(self, k: int):
        """Mesh-mode chain input: per-block (bodies, tails) stacks.  Time
        shard t's [k, body/T] slices go to its cell, so each shard's slice
        boundary is fixed (blocks overlap by the halo, so ~0.1% of the stream
        ships twice); the tails [k, halo, 2] are small and ship as float32
        pairs whatever the raw format."""
        body, halo = self._block_need, self.N - self.hop
        T = self.mesh.shape["time"]
        lb = body // T
        p = self._pending
        per = 1 if self._ship == "pairs" else 2  # entries a sample
        bodies = []
        for t in range(T):
            cell = self.mesh.time_cell(t)
            if not self.mesh.is_local(cell):
                bodies.append(None)
                continue
            sl = np.stack([p[per * (j * body + t * lb) : per * (j * body + (t + 1) * lb)] for j in range(k)])
            bodies.append(self._to_device(sl, self.mesh.device(cell)))
        if self._ship == "pairs":
            tails = np.stack([p[(j + 1) * body : (j + 1) * body + halo] for j in range(k)])
        else:
            tails = np.stack([self._decode(p[2 * (j + 1) * body : 2 * ((j + 1) * body + halo)].tobytes()) for j in range(k)])
        return bodies, self._to_device(tails.astype(np.float32))

    def _start_fetch(self, outs: dict):
        """Start the device-to-host copy of one chunk's outputs.  On the card
        the copies run on a side stream, after an event recorded behind the
        chunk on the compute stream, into pinned buffers, so the copy of
        chunk n-1 does not queue behind chunk n's compute.  Returns (host
        tensors, copy-done event, the device outputs, held until the copy
        has landed so the allocator cannot reuse them)."""
        self.fetched_bytes += sum(v.numel() * v.element_size() for v in outs.values())
        if self.device.type == "cpu":
            return outs, None, None
        ready = torch.cuda.Event()
        ready.record(self._stream)
        host = {}
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            for k, v in outs.items():
                host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record()
        return host, landed, outs

    def _dispatch(self, k: int) -> None:
        """Launch one k-block chained dispatch on the pending stream."""
        b0 = self.blocks_processed
        with trace.span("pipeline.dispatch", b0):
            self._join_warm()
            n_in = (k * self.W - 1) * self.hop + self.N
            with self._on_stream():
                with trace.span("pipeline.stage", b0):
                    xb = self._stacked_input(k) if self.mesh is not None else self._to_device(self._pending_slice(n_in))
                bins, window, taps = self._block_args()
                with trace.span("pipeline.launch", b0):
                    self.state, outs = pipeline_chain(
                        xb, bins, window, self.params, self.state,
                        k_blocks=k, taps=taps, inv_perm=self._inv_perm, **self._chain_kwargs(),
                    )
                with trace.span("pipeline.fetch_start", b0):
                    fetch = self._start_fetch(outs)
            self._pending_consume(k * self._block_need)
            self.blocks_processed += k
            self._inflight.append((k, b0, fetch))
            if k > 1:
                self._warm_flush_path()

    def _needs_library(self) -> bool:
        return (
            self.device.type == "cuda"
            and self.cfg.demod_backend == "cuda"
            and demod_cuda.cuda_library.cache_info().currsize == 0
        )

    def _warm_library_async(self) -> None:
        if not self._needs_library() or any(t.is_alive() for t in self._warm_threads):
            return
        t = threading.Thread(target=demod_cuda.cuda_library, daemon=False, name="kernel-build")
        self._warm_threads.append(t)
        t.start()

    def _join_warm(self) -> None:
        for t in self._warm_threads:
            t.join()
        self._warm_threads = []

    def warm(self, k_blocks: int | None = None, *, slots: int | None = None, fmt: str | None = None) -> None:
        """Before streaming starts: build and load the kernel library (nvcc,
        seconds) and run the k-block chain and the priming channelizer once
        on zeroed inputs and a zeroed state, so the first ``feed`` does not
        stall on the build or on first-call set-up.  Nothing observable
        changes: the pipeline's own state is not touched."""
        with trace.span("setup.warm", always=True):
            self._warm(k_blocks, slots, fmt)

    def _warm(self, k_blocks: int | None, slots: int | None, fmt: str | None) -> None:
        k = k_blocks if k_blocks is not None else max(1, int(self.cfg.chunk_blocks))
        # guess the ship format without pinning self._ship: decoded arrays
        # are accepted even when cfg.sample_format is raw, and _resolve_ship
        # must still see the actual first payload
        ship = self._ship or (self.cfg.sample_format if self.cfg.sample_format in ("u8", "s8", "s16") else "pairs")
        kwargs = self._chain_kwargs(ship)
        if slots is not None:  # fetch-economy rung (see apply_rung)
            kwargs["active_slots"] = max(0, int(slots))
        if fmt is not None:
            kwargs["audio_fmt"] = fmt
        self._join_warm()
        if self._needs_library():
            with trace.span("setup.library", always=True):
                demod_cuda.cuda_library()
        dev = self.device
        n_in = (k * self.W - 1) * self.hop + self.N
        raw_dtype = torch.int16 if kwargs["sample_fmt"] == "s16" else torch.uint8
        with self._on_stream():
            state = self._sharded(init_demod_state(self.C_dev, torch.zeros((self.A, self.C_dev), device=dev),
                                                   torch.zeros((self.A, self.C_dev, 2), device=dev)))
            if self.mesh is not None:
                lb = self._block_need // self.mesh.shape["time"]
                xb = ([torch.zeros((k, lb, 2) if kwargs["sample_fmt"] == "pairs" else (k, 2 * lb),
                                   dtype=torch.float32 if kwargs["sample_fmt"] == "pairs" else raw_dtype, device=c)
                       for c in (self.mesh.device(self.mesh.time_cell(t)) for t in range(self.mesh.shape["time"]))],
                      torch.zeros((k, self.N - self.hop, 2), device=dev))
            elif kwargs["sample_fmt"] == "pairs":
                xb = torch.zeros((n_in, 2), device=dev)
            else:
                xb = torch.zeros(2 * n_in, dtype=raw_dtype, device=dev)
            bins, window, taps = self._block_args()
            pipeline_chain(xb, bins, window, self.params, state, k_blocks=k, taps=taps, inv_perm=self._inv_perm, **kwargs)
            prime = torch.zeros((self._prime_len, 2), device=dev)
            channelize_block(prime, self.bins, self.window, hop=self.hop, fft_size=self.N, n_frames=self.A,
                             use_fft=self.cfg.channelizer == "fft", taps=self._taps)
        if dev.type == "cuda":
            for d in {dev} if self.mesh is None else {c for c in self.mesh.cells if c is not None}:
                torch.cuda.synchronize(d)

    def _warm_flush_path(self) -> None:
        """flush() (stream end, retune drain) dispatches single blocks.  A
        k=1 chain runs the same kernels as the k-block chain, so there is no
        program to prepare for it: this only starts a background build of
        the kernel library if that is still not loaded, and otherwise (after
        any dispatch that launched K1) does nothing."""
        self._warm_library_async()

    def warm_async(self, k_blocks: int | None = None, *, slots: int | None = None, fmt: str | None = None) -> None:
        """Prepare an alternate (active_slots, audio_fmt) rung of the fetch
        economy without stalling streaming.  Every rung runs the same
        kernels, so the only thing that can be left to do is the kernel
        library's build: started in a background thread (joined in close()
        or before the next dispatch) if the library is not loaded yet, and
        otherwise nothing is done.  Arguments as :meth:`warm`."""
        self._warm_library_async()

    def apply_rung(self, slots: int, fmt: str) -> None:
        """Fetch-economy shift: the NEXT dispatch uses the new active_slots /
        audio_fmt (both are read from cfg per dispatch; in-flight chunks
        drain as they were packed — _to_host unpacks by content)."""
        self.cfg.active_slots = int(slots)
        self.cfg.fetch_audio_fmt = fmt

    def close(self) -> None:
        """Join background build threads.  Call at shutdown; idempotent.
        The in-flight chunk queue is left alone — iterate :meth:`flush`
        first if the dispatched audio matters."""
        self._join_warm()

    def _to_host(self, item) -> Iterator[dict]:
        """Fetch one in-flight chunk and unpack it into per-block dicts with
        the same keys pipeline_block returns.  In active-gather mode
        (cfg.active_slots > 0) each block's valid slots are restored to
        float32 as the rows of a slot-major buffer (``_dequant_slots``) and
        copied, a row a slot, into a reused channel-major [C, W] buffer over
        silence: the yielded ``audio`` is that buffer's [W, C] view, and
        ``iq_out`` the [W, C, 2] view of a [C, W, 2] one.  Slot overflow
        (more open channels than slots) is counted in
        ``gather_overflow_count`` and the overflowed channels stay silent for
        the block.  Every span closes before a yield, so none holds the
        consumer's time."""
        k, b0, (host, landed, _held) = item
        with trace.span("pipeline.copy_wait", b0):
            if landed is not None:
                landed.synchronize()
        host = {key: v.numpy() for key, v in host.items()}
        gather = "slot_channel" in host
        if not gather:
            with trace.span("pipeline.dequant", b0):
                if host["audio"].dtype == np.int16:  # i16 fetch -> restore float
                    host["audio"] = host["audio"].astype(np.float32) * (1.0 / 32767.0)
                elif host["audio"].dtype == np.int8:  # block-float fetch -> restore
                    host["audio"] = host["audio"].astype(np.float32) * host["audio_scale"][:, None, :]
        for i in range(k):
            rows = None
            if gather:
                with trace.span("pipeline.dequant", b0 + i):
                    rows = self._dequant_slots(host, i)
            with trace.span("pipeline.scatter", b0 + i):
                out = self._unpack_block(host, i, b0 + i, rows)
            self.last_yielded = b0 + i
            yield out

    def _dequant_slots(self, host: dict, i: int) -> np.ndarray:
        """Block ``i``'s valid slots restored to float32, transposed into the
        reused slot-major buffer: [n, W], a row a slot.  The valid slots are
        a prefix (``select_slots`` sorts them first).  Each format keeps the
        product of the dense fetch's restore: i8bf mantissas times their
        slot's scale, i16 times 1/32767, f32 as fetched."""
        a = host["audio"][i]  # [W, S]
        n = int(np.count_nonzero(host["slot_channel"][i] >= 0))
        shape = a.shape[::-1]
        if self._slot_rows is None or self._slot_rows.shape != shape:
            self._slot_rows = np.empty(shape, np.float32)
        rows = self._slot_rows[:n]
        if a.dtype == np.float32:
            rows[...] = a[:, :n].T
            return rows
        # transpose the narrow integers, then restore them in one pass
        if self._slot_ints is None or self._slot_ints.shape != shape or self._slot_ints.dtype != a.dtype:
            self._slot_ints = np.empty(shape, a.dtype)
        ints = self._slot_ints[:n]
        ints[...] = a[:, :n].T
        scale = host["audio_scale"][i][:n, None] if a.dtype == np.int8 else np.float32(1.0 / 32767.0)
        np.multiply(ints, scale, out=rows, dtype=np.float32)
        return rows

    def _unpack_block(self, host: dict, i: int, block: int, rows: np.ndarray | None = None) -> dict:
        """Block ``i`` of a fetched chunk as the dict ``_to_host`` yields;
        in active-gather mode ``rows`` are its restored valid slots."""
        out = dict(active=host["active"][i])
        if "slot_channel" in host:
            cols = host["slot_channel"][i][: len(rows)]
            # the dense [C, W] buffer is REUSED between blocks (yielded
            # audio is valid until the next block is yielded): re-zeroing
            # only the previously written rows moves far less memory than a
            # fresh buffer a block
            audio = self._dense_audio
            if audio is None or audio.shape != (self.C, self.W):
                audio = self._dense_audio = np.zeros((self.C, self.W), np.float32)
            else:
                audio[self._dense_dirty] = 0.0
            audio[cols] = rows
            self._dense_dirty = cols
            trace.count("pipeline.unpacked_rows", len(cols))
            if self.cfg.suppress_fade_tails:
                with trace.span("pipeline.fade", block):
                    self._fade_tails(audio, cols)
            out["audio"] = audio.T
            dropped = int(host["n_active"][i]) - len(cols)
            out["gather_overflow"] = max(0, dropped)
            self.gather_overflow_count += out["gather_overflow"]
            if "iq_out" in host:
                iq = self._dense_iq
                if iq is None or iq.shape != (self.C, self.W, 2):
                    iq = self._dense_iq = np.zeros((self.C, self.W, 2), np.float32)
                else:
                    iq[self._dense_iq_dirty] = 0.0
                iq[cols] = host["iq_out"][i][:, : len(cols)].transpose(1, 0, 2)
                self._dense_iq_dirty = cols
                out["iq_out"] = iq.transpose(1, 0, 2)
        else:
            out["audio"] = host["audio"][i]
            if "iq_out" in host:
                out["iq_out"] = host["iq_out"][i]
        if "open_flags" in host:
            out["open_flags"] = host["open_flags"][i]
        # meta is [K, rows, C] per block, or [rows, C] once per chunk
        # (cfg.fetch_meta_per_chunk): chunk-end values stand in for every
        # block of the chunk
        mf = host["meta_f"] if host["meta_f"].ndim == 2 else host["meta_f"][i]
        mi = host["meta_i"] if host["meta_i"].ndim == 2 else host["meta_i"][i]
        for j, name in enumerate(META_F):
            out[name] = mf[j]
        for j, name in enumerate(META_I):
            out[name] = mi[j]
        out["sig_outside"] = mi[len(META_I)].astype(bool)
        if "spectrum_power" in host:
            out["spectrum_power"] = host["spectrum_power"][i]
        return out

    def _fade_tails(self, audio: np.ndarray, cols: np.ndarray) -> None:
        """Synthesize the fade tails the device did not ship (cfg.suppress_fade_tails)
        into the channel-major dense block ``audio`` [C, W], whose shipped
        rows are ``cols``."""
        A = self.A
        if self._tail_startup:
            # block 0: every unshipped channel carries the
            # 0.5-initialized waveout tail (config.cpp:315) in its
            # first AGC_EXTRA samples
            mask = np.ones(self.C, bool)
            mask[cols] = False
            synth = np.flatnonzero(mask)
            audio[synth, :A] = np.float32(0.5)
            self._tail_startup = False
        else:
            synth = np.flatnonzero(self._tail_pending)
            if len(synth):
                synth = synth[~np.isin(synth, cols, assume_unique=False)]
            if len(synth):
                # AM squelch-close fade continuation v·0.94^(i+1)
                # from the channel's last shipped sample; like the
                # JAX package, also for a still-open channel the
                # slots dropped (reference behaviour, ROADMAP H4)
                audio[synth, : A - 1] = self._tail_pending[synth][:, None] * self._pow94[None, :]
        self._tail_pending[:] = 0.0
        if len(cols):
            self._tail_pending[cols] = audio[cols, -1]
        if len(synth):
            self._dense_dirty = np.concatenate([cols, synth])

    def feed(self, raw) -> Iterator[dict]:
        """Feed IQ (complex64 array, [L, 2] f32 pairs, or raw bytes in the
        configured sample format).  Yields one result dict per completed
        block.

        Blocks are dispatched ``cfg.chunk_blocks`` at a time and results are
        yielded ``cfg.async_depth`` chunks behind the dispatch front, so the
        host fetch of chunk n-1 overlaps the device compute of chunk n.  Call
        :meth:`flush` at stream end to drain.

        In active-gather mode (cfg.active_slots > 0) the yielded dense
        ``audio`` [W, C] and ``iq_out`` [W, C, 2] are views of channel-major
        buffers REUSED between blocks — they are valid until the next block
        is yielded; copy if retained."""
        with trace.span("pipeline.ingest"):
            self._ingest(raw)
        trace.count("pipeline.ingest_bytes", raw.nbytes if isinstance(raw, np.ndarray) else len(raw))

        if not self._primed:
            if self._pending_samples() < self._prime_len:
                return
            prime = self._pending_slice(self._prime_len)
            if self._ship != "pairs":
                prime = self._decode(prime.tobytes())
            with self._on_stream():
                mags, iqs = channelize_block(
                    self._to_device(prime), self.bins, self.window,
                    hop=self.hop, fft_size=self.N, n_frames=self.A, use_fft=self.cfg.channelizer == "fft", taps=self._taps,
                )
                self.state = self._sharded(init_demod_state(self.C_dev, mags, iqs))
            self._pending_consume(self.A * self.hop)
            self._primed = True

        K = max(1, int(self.cfg.chunk_blocks))
        chunk_len = (K * self.W - 1) * self.hop + self.N
        while self._pending_samples() >= chunk_len:
            self._dispatch(K)
            while len(self._inflight) > max(0, int(self.cfg.async_depth)):
                yield from self._to_host(self._inflight.pop(0))

    def flush(self) -> Iterator[dict]:
        """Drain: process any remaining complete single blocks, then fetch
        every in-flight chunk.  Call at stream end / shutdown / retune."""
        if self._primed:
            while self._pending_samples() >= self._block_len:
                self._dispatch(1)
        while self._inflight:
            yield from self._to_host(self._inflight.pop(0))

    # -------------------------------------------------------- checkpointing

    def save_state(self, path: str) -> None:
        """Checkpoint the carried DSP state (squelch/AGC/filter/Goertzel
        recurrences + stream alignment) so a restarted process can resume
        gaplessly.  The npz keys and dtypes are the JAX package's
        (``dm_phi`` uint32), so either framework loads the other's file."""
        if self.state is None:
            raise RuntimeError("pipeline not primed; nothing to checkpoint")
        if self._inflight:
            raise RuntimeError("in-flight chunks pending; iterate flush() before save_state")
        with self._on_stream():
            st = interop.sharded_to_numpy(self.state) if self.mesh is not None else interop.state_to_numpy(self.state)
            flat = {f"state.{k}": v for k, v in st.items()}
            flat["bins"] = self.bins.cpu().numpy()  # device order
        flat["pending"] = self._pending if self._pending is not None else np.zeros((0, 2), np.float32)
        flat["ship"] = np.str_(self._ship or "")
        flat["tail_pending"] = self._tail_pending
        flat["tail_startup"] = np.bool_(self._tail_startup)
        flat["blocks_processed"] = np.int64(self.blocks_processed)
        np.savez(path, **flat)

    def load_state(self, path: str) -> None:
        """Resume from :meth:`save_state` of either framework (same channel
        config and shapes)."""
        d = np.load(path)
        with self._on_stream():
            self.state = self._sharded(interop.state_from_numpy(
                {k[len("state.") :]: d[k] for k in d.files if k.startswith("state.")}, device=self.device))
            self._set_device_bins(d["bins"])
        self._pending = np.asarray(d["pending"])
        ship = str(d["ship"]) if "ship" in d else "pairs"
        self._ship = ship or None
        self.blocks_processed = int(d["blocks_processed"])
        if "tail_pending" in d:
            self._tail_pending = np.asarray(d["tail_pending"], np.float32).copy()
            self._tail_startup = bool(d["tail_startup"])
        else:  # older checkpoint: past startup, no fade pending
            self._tail_pending[:] = 0.0
            self._tail_startup = False
        self._primed = True

    # ------------------------------------------------------------ mutation

    def set_bins(self, bins) -> None:
        """AFC / scan retune: move channels to new FFT bins (USER channel
        order); the matched-filter taps are rebuilt (bins change at 200 ms /
        2 s control cadence, not per block)."""
        with self._on_stream():
            self._set_device_bins(self._device_bins(bins))

    def retune(self, specs: list[ChannelSpec], center_freq: int | None = None) -> None:
        """Scan-mode retune: new channel frequencies and/or device center.
        Rebuilds params and bins; shapes are unchanged (reference analog:
        controller_thread changing freq_idx + input centerfreq,
        rtl_airband.cpp:112-123)."""
        if center_freq is not None:
            self.cfg.center_freq = center_freq
        if len(specs) != self.C:
            raise ValueError("retune cannot change channel count")
        self.specs = specs
        # the feature set may change with the new freq entries -> regroup
        # (safe: the carried state is dropped and re-primed below)
        with self._on_stream():
            self._set_channels(specs)
        # drop buffered samples from the old tuning and re-prime; in-flight
        # chunks from the old tuning stay queued and drain in FIFO order
        self._pending = None
        self._primed = False
        # re-priming re-creates the 0.5-initialized waveout tail -> the
        # fade-suppression host state starts over
        self._tail_pending[:] = 0.0
        self._tail_startup = True
