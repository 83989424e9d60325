"""Entry ``block``: the block program, ``models/flagship.py::FlagshipBlock``.

The configuration's channels, grouped by cost class with the user-order
restore as the program lays them out, decode the configuration's sample
format (u8, s8, s16 or f32, with its ``fullscale``) on the device, channelize
with the four float32 GEMMs, demodulate with K1 and assemble.  The scene's
segment is made on the device in set-up and its blocks are fed in a cycle,
the state threaded through every block.  Set-up primes the state from the
stream's first frames as ``Pipeline`` does and runs one cycle of the
segment, which builds and loads every kernel and shape.  The window feeds
blocks until ``--seconds`` have passed on the host clock and ends in a
``synchronize``: ``block_ms`` is the window over the blocks in it.

Checked: the window's first block, against the reference from the stream's
start; a block drawn from the seed among those the carriers key on, and the
window's last block, each from the state it started from.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


def build(ctx, scene):
    """(block, inputs, state0, inv_perm): the program set up for the cell."""
    import torch

    from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
    from rtlsdr_airband_tpu_torch.models.flagship import FlagshipBlock
    from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul, decode_raw_iq
    from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, cost_group_permutation, init_demod_state, make_channel_params
    from rtlsdr_airband_tpu_torch.ops.window import blackman_harris_7
    from rtlsdr_airband_tpu_torch.refmodel.channel_ref import bin_for_freq

    from benchmark.reference.channel import DEFAULT_FULLSCALE, channel_spec

    cfg, dev = ctx.config, ctx.device
    fmt = cfg.get("sample_format", "u8")
    fullscale = float(cfg.get("fullscale") or DEFAULT_FULLSCALE.get(fmt, 127.5))  # u8 and s8 decode by a fixed rule
    fs, N, wave_rate, center = cfg["sample_rate"], cfg["fft_size"], cfg["wave_rate"], cfg["center_freq"]
    hop, W = scene.hop, scene.W
    specs = [ChannelSpec(**dataclasses.asdict(channel_spec(cfg, i))) for i in range(cfg["channels"]["count"])]
    order = cost_group_permutation(specs)
    specs = [specs[i] for i in order]
    inv_perm = torch.as_tensor(np.argsort(order).astype(np.int64), device=dev)
    params = make_channel_params(specs, wave_rate=wave_rate, sample_rate=fs, center_freq=center, fft_size=N, device=dev)
    bins = torch.as_tensor(np.array([bin_for_freq(s.frequency, center, fs, N) for s in specs], np.int32), device=dev)
    window = torch.as_tensor(blackman_harris_7(N), device=dev)
    block = FlagshipBlock(bins, window, params, inv_perm, hop=hop, fft_size=N, n_frames=W, fm_quadri=False,
                          with_ctcss=any(s.ctcss > 0 for s in specs), with_iq=False, sample_fmt=fmt, fullscale=fullscale)
    seg = scene.segment
    # the raw values as decode_raw_iq takes them, 2 a sample: bytes for u8 and s8
    raw_dtype = {"s16": torch.int16, "f32": torch.float32}.get(fmt, torch.uint8)
    ext = torch.cat([seg, seg[: scene.bps * (scene.block_offset(0) + N)]]).view(raw_dtype)
    xs = [ext[2 * scene.block_offset(j) : 2 * (scene.block_offset(j) + scene.block_len)] for j in range(ctx.traffic["segment_blocks"])]
    prime = decode_raw_iq(ext[: 2 * scene.prime_len], fmt, fullscale)
    mags, iqs = channelize_matmul(prime, bins, window, hop=hop, fft_size=N, n_frames=AGC_EXTRA, taps=(block.taps_re, block.taps_im))
    state0 = init_demod_state(len(specs), mags, iqs)
    return block, xs, state0, inv_perm


def outputs(out: dict, state, users, dev_idx) -> dict:
    """The sampled channels of one block's outputs and following state."""
    import torch

    from benchmark.check import EXACT_SNAPS, FLOAT_SNAPS, take_channels

    u = torch.as_tensor(users, device=out["audio"].device)
    return dict(users=users, audio=out["audio"][:, u].cpu().numpy(), open_flags=out["open_flags"][:, u].cpu().numpy(),
                snap={k: out[k][u].cpu().numpy() for k in FLOAT_SNAPS + EXACT_SNAPS},
                state_out=take_channels(state, dev_idx))


def run(ctx) -> None:
    import torch

    from benchmark.check import take_channels

    scene = ctx.scene()
    ctx.mark("scene")
    block, xs, state0, inv_perm = build(ctx, scene)
    ctx.mark("program")
    sync = torch.cuda.synchronize if ctx.on_card else (lambda: None)

    st = state0
    for x in xs:  # set-up: one cycle of the segment builds and warms every kernel
        st, _ = block(x, st)
    sync()
    del st
    ctx.mark("warm")

    target = ctx.draw_block(1, 8 * len(xs))
    kept = {}
    ctx.start_profiler()
    t0 = ctx.begin_window()
    st, k, n = state0, 0, len(xs)
    while True:
        st_in = st
        st, out = block(xs[k % n], st)
        if k in (0, target):
            kept[k] = (st_in, out, st)
        k += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    sync()
    t1 = time.perf_counter()
    ctx.end_window(t1)
    last = k - 1
    kept[last] = (st_in, out, st)
    while k <= target:  # a window too short to reach the drawn block: run on to it, untimed
        st_in = st
        st, out = block(xs[k % n], st)
        kept[k] = (st_in, out, st)
        k += 1

    ctx.e2e["block_ms"] = (t1 - t0) / (last + 1) * 1e3
    ctx.e2e["setup_s"] = t0 - ctx.t_start
    ctx.attempted = ctx.blocks_in_window = last + 1
    users = ctx.sample_channels(scene, ctx.workload["check"]["channels"])
    dev_idx = inv_perm[torch.as_tensor(users, device=inv_perm.device)].cpu().numpy()
    for b in sorted(kept):
        st_in, out, st = kept[b]
        c = outputs(out, st, users, dev_idx)
        c["raw"] = scene.block_bytes(b)
        if b == 0:
            c["prime"] = scene.prime_bytes()
        else:
            c["state_in"] = take_channels(st_in, dev_idx)
        ctx.cases.append(c)
    ctx.counters.update(W=scene.W, N=scene.N, C=int(inv_perm.numel()), n_ctcss=int(block.p_ctcss_enabled.sum()),
                        checked_blocks=sorted(kept))
