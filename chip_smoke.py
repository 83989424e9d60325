"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (sm_90a, H100).

    python3 chip_smoke.py

Runs from the repository root and needs one CUDA device (phase 9 uses more
where they are present); it exits non-zero without one, and without the
port's package beside it.  It imports nothing of JAX and nothing of the JAX
package.  Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: nvcc builds every kernel from csrc/ (one process per source: K1's
   default schedule, K1's other schedules, K2); per kernel its registers and
   spills (ptxas), K1's dynamic shared memory a block of BLOCK_WIDTH channels
   and a pair block, its SASS memory instructions and the instructions of its
   step loop (cuobjdump), for every schedule; the CTCSS pass's registers and
   spills;
3. parity: on the 8192-channel active scene (build_flagship_stream, W = 2000,
   4 blocks: squelch opens and closes on the carriers, CTCSS banks decide)
   the demod kernel K1, in its default schedule, against its plain
   PyTorch version on the same inputs: every output and state leaf equal
   bit for bit;
4. channelizer: torch.matmul in float32 against float64, SNR >= 80 dB at
   C = 8192, N = 512, W = 2000;
5. main path: build_flagship(8192) on the card, K = 8 distinct blocks
   through the FlagshipBlock with the launch counters at 0, then timings
   with CUDA events on the same blocks and states (warm-up, min over reps):
   the block, the channelizer GEMMs, K1 alone on each block in the default
   schedule and in its other five (unroll 2 and 4, pair at unroll 1, 2 and
   4), each with the CTCSS banks (K1 and the CTCSS pass after it) and
   without them, each equal to the default bit for bit; K1 alone and the
   CTCSS pass alone at (2000, 8192) in mixed8192's and am8192's populations
   and K1 at (2000, 2280) in vhf2280's (no CTCSS), beside K1 without the
   banks, each split run bit for bit the launcher's, with the pass's bound;
   the CTCSS pass one launch a K1 launch on the main path; the plain demod on the last
   block; K1's bytes bound and issue bound; the fade-tail kernel (one
   launch a K1 launch) on the last block's assembly inputs at 8192 and
   2280 channels, bit for bit against the plain assembly, alone and plain
   timed, with its bytes bound; a torch.profiler view of the K blocks by
   kernel;
6. chain probe K2: the probe's own entry point (bench_chain_probe.main, its
   full W = 2000, L = 40, K = 4, REPS = 5) with its launch counter at 0, for
   the three kinds; then on one block of its inputs per kind the kernel
   against its plain version, bit for bit, the plain version timed; its
   bound; the probe's us/step beside K1's;
7. streaming: the port's Pipeline on the flagship population
   (flagship_specs(8192), wave_rate 16000, N = 512, u8 input from siggen:
   six AM carriers on channels, gated on and off, over noise; 17 blocks
   after priming):
   (a) production settings (chunk_blocks 8, async_depth 1, 256 active slots,
       i8bf audio, fade-tail suppression, meta per chunk): K1 launches
       against blocks processed with the counter at 0, keys and finite
       audio of every block, active channels and overflows, D2H bytes a
       block; wall time a block of feed + flush after warm() and its
       realtime factor; the host's split of that wall (enqueue, waiting for
       copies, rebuilding blocks, the rest); device time a block
       (torch.profiler) and the idle share it implies;
   (b) determinism: dense f32, chunk_blocks 8 / async_depth 1 against
       chunk_blocks 1 / async_depth 0, every yielded key equal bit for bit;
   (c) FFT and AFC: channelizer 'fft' with AFC on one channel in four, 4
       blocks: channelize_fft against float64 (>= 80 dB), each block's
       spectrum_power against the float64 spectrum of its decoded last
       frame, channelize_fft timed beside channelize_matmul on one block,
       the chain's packing timed on one block, with their bounds;
8. the App, as a user runs it: libconfig text as scripts/bench_app.py
   writes it (flagship_specs(8192) frequencies, all AM with a manual
   squelch threshold, one CTCSS channel among the hot ones, a udp_stream
   sink on every channel, wave_rate 16000, chunk 8, i8bf, fade-tail
   suppression, meta per chunk, APP_SLOTS active slots) and a u8 file of
   about 4 s of air (4 AM carriers keyed on over noise, sized so the chunks
   consume it exactly); App(cfg) on the card after a warm() of its
   pipeline, start(), _service_once() until the input is spent, stop():
   K1 launches = blocks processed = what the file gives, the input ended by
   EOF, the modulating tone at two hot channels' UDP ports, nothing but
   silence at a cold one, no overflow; the wall a block (first chunk
   dropped) and its realtime factor, D2H bytes and channels open a block,
   the host split between Pipeline.feed and the block handler.  Then the
   CLI: ``python3 -m rtlsdr_airband_tpu_torch -F -e -c <conf>`` on a small
   config with a file sink (exit 0, an audio file over 1000 bytes), and
   ``--check-config`` on every examples/*.conf;
9. the mesh (``parallel/sharding.py``), at full width:
   (1) the flagship block program through a 2x2 mesh of one card ([cuda:0] *
       4, each cell on its own stream): the time-sharded channelizer with
       its halo exchange, the reshard, K1 once per channel shard (4 launches
       a block at 2048 channels), 8 blocks with the state threaded, held
       against the single-device program bit for bit (or, should the card's
       GEMMs round otherwise at W/T rows, H12, within the parity bars with
       flags and int/bool state exact); the mesh's block ms beside the
       single device's, K1 alone at 2048 channels per shard and its bound,
       the halo exchange and the reshard timed, a profile;
   (2) phase 7's stream at production settings through the same mesh: K1 4
       launches a block, every key against the single-device Pipeline, D2H
       bytes a block equal, the stream wall a block of both;
   (3) with two or more GPUs: (1) over distinct GPUs, the phase-8 App with
       mesh_devices = min(4, count) against the single-GPU App block for
       block, and a 2-rank NCCL run of scripts/run_multihost.py on the
       phase-8 file against a 1-rank run; with one GPU a line says why not;
10. the drivers (``rtlsdr_airband_tpu_torch/scripts/`` and ``entry.py``), each
    through its main() in this process with K1's launch counter at 0 just
    before it, its JSON line printed, a failure fatal:
    (1) bench.py at 8192 channels, K = 16, 3 reps (block_ms beside phase 5's);
    (2) bench_scaling --channels 512,2048,8192,16384 (block_ms, K1 alone a
        block by CUDA events);
    (3) e2e_snr with K1 and with the plain version on the same scene:
        squelch gating identical to the refmodel, worst SNR >= 80 dB, K1's
        audio equal to the plain version's bit for bit;
    (4) squelch_trace --synth: the traced plain run's audio and open flags
        equal to K1's on the same channelizer output, bit for bit;
    (5) entry(): fn(*example_args) once, equal bit for bit to phase 5's
        block program on the same (un-noised) input and state;
    (6) bench_app at 8192 channels over 8 s of air, unpaced, phase 8's
        settings;
    (7) soak at 2048 channels paced at real time for SOAK_MINUTES (default
        1 here): its RSS, thread, fd and allocator samples; a failed check
        fails the phase;
11. K1's schedules (``demod_block_cuda(unroll=, pair=)``, csrc/demod_sched.cu):
    (a) on phase 3's scene (8192 channels, W = 2000, CTCSS banks on, 4
        blocks) unroll 2, unroll 4, pair, pair at unroll 2 and pair at
        unroll 4 against the plain version and against the default schedule:
        audio, IQ, flags and every state leaf bit for bit;
    (b) the streaming flagship (phase 7's population and u8 scene, 4 blocks,
        dense float32, chunk 4) with RTLSDR_DEMOD_PAIR=1 against the same run
        without it, every key bit for bit, and the schedule counter showing
        that pair ran once a block;
    (c) the three drivers through their main(): bench_pair at 8192 and 512
        channels, bench_unroll at 512 and 8192, bench_bf16 at 8192 (float32
        must clear its 80 dB gate; the other precisions are evidence);
12. the kernels line, the JSON kernels line (K1's schedules in K1's entry;
    K2; the fade-tail kernel; the CTCSS pass),
    the card line and the result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np

W_FLAGSHIP = 2000
C_FLAGSHIP = 8192
K_BLOCKS = 8
BANK_ACCUMULATORS = ("fast.q1", "fast.q2", "slow.q1", "slow.q2")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
# latency of a float32 FMUL or FADD that waits on the one before, in cycles:
# the figure microbenchmark studies report from Volta to Hopper (Jia et al.
# 2018, Luo et al. 2024), not measured here; it sets K2's latency bound
FP32_DEP_LATENCY_CYCLES = 4
# float operations of one demod step for one channel outside the Goertzel
# banks (counted from csrc/demod_step.cuh: squelch ~25, derotation ~12,
# lowpass ~14, magnitude 4, post-filter MAs ~8, AM or NFM ~20, notch 9,
# ampfactor and clamp 3)
DEMOD_STEP_FLOPS = 95
STREAM_BLOCKS = 17  # after priming: two chunks of 8 and one block for flush()
STREAM_SLOTS = 256
APP_SECONDS = 4.0  # of air in the App phase's input file
APP_CHUNK = 8
APP_HOT = 4  # carriers; each opens ~80-150 channels at 8192 (scripts/bench_app.py)
APP_SLOTS = 1024
APP_UDP_BASE = 20000  # channel i streams to 127.0.0.1:APP_UDP_BASE + i
SWEEP_COUNTS = (512, 2048, 8192, 16384)  # phase 10's channel sweep
SOAK_CHANNELS = 2048
SCHEDULES = ((2, False), (4, False), (1, True), (2, True), (4, True))  # K1's, besides the default (unroll, pair)
SCHEDULE_COUNTS = (512, C_FLAGSHIP)  # phase 11's driver channel counts
FADE_CHANNELS = (C_FLAGSHIP, 2280)  # the fade-tail kernel's timed widths: the flagship's and vhf2280's
PAIR_STREAM_BLOCKS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(field: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def sass_listing(path) -> dict:
    """Per kernel in a built library, its SASS as [(address, opcode, line)]
    (cuobjdump); empty where the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, timeout=120, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    listing, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = listing.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", ln)
        if fn is not None and m:
            fn.append((int(m.group(1), 16), m.group(2), ln))
    return listing


def sass_ops(path, ops=("FMUL", "FADD", "FFMA")) -> dict:
    """Per kernel in a built library, how many of ``ops`` its SASS holds."""
    return {fn: {op: sum(1 for _, o, _ in ins if o == op) for op in ops} for fn, ins in sass_listing(path).items()}


def step_loop_instructions(ins) -> int | None:
    """SASS instructions of one trip of a kernel's main loop: the widest
    backward branch's span, less the spans of the loops nested in it (K1's
    AGC bootstrap, the input tile's copy loop).
    It still holds both the AM and the NFM arm and the straight-line parts
    of the rare branches, which a warp's step does not all run.  None when
    the listing shows no backward branch."""
    import re

    loops = []
    for addr, op, ln in ins:
        m = re.search(r"0x([0-9a-f]+)\s*;", ln) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    if not loops:
        return None
    lo, hi = max(loops, key=lambda b: b[1] - b[0])
    inner = [(a, b) for a, b in loops if lo <= a and b <= hi and (a, b) != (lo, hi)]
    return sum(1 for addr, _, _ in ins if lo <= addr <= hi and not any(a <= addr <= b for a, b in inner))


def ptxas_summary(log: str) -> dict:
    """Per kernel, the registers / shared memory line and the spill line
    that ``nvcc -Xptxas -v`` printed."""
    import re

    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([A-Za-z0-9_]+)", ln)
        if m:
            fn = m.group(1)
            continue
        if fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return out


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Min over ``reps`` of one call's device time, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def state_diffs(a_state, b_state) -> dict:
    """Per-leaf max difference (float) or mismatch count (int/bool)."""
    from rtlsdr_airband_tpu_torch.interop import state_to_numpy

    a, b = state_to_numpy(a_state), state_to_numpy(b_state)
    out = {}
    for k in a:
        if a[k].dtype.kind in "iub":
            out[k] = int(np.sum(a[k] != b[k]))
        else:
            d = np.abs(a[k].astype(np.float64) - b[k])
            if k in BANK_ACCUMULATORS:  # relative to the bank's scale, see tests/test_torch_demod.py
                d = d / np.maximum(1.0, np.abs(b[k].astype(np.float64)).max(axis=0))
            out[k] = float(d.max())
    return out


def k1_schedule_of(fn: str) -> str | None:
    """The schedule name (``demod_cuda.schedule_name``) of a K1 kernel by its
    mangled name."""
    import re

    m = re.search(r"demod_kernelILi\d+ELi(\d+)EE", fn)
    if m:
        return f"single_u{m.group(1)}"
    m = re.search(r"demod_pair_kernelILi(\d+)EE", fn)
    return f"pair_u{m.group(1)}" if m else None


def phase_k1_build(built) -> tuple[int | None, dict]:
    """K1's instantiations as built: dynamic shared memory a block, SASS
    memory instructions (LDS/STS shared, LDG/STG device, LD/ST generic,
    LDGSTS the cp.async copies) and the instructions of one step's loop body;
    per schedule its registers and spill bytes (ptxas).  Returns the step
    loop's count for the default schedule (None if not counted) and
    {schedule: registers, spill_bytes, sass_instructions, step_loop}."""
    import re

    from rtlsdr_airband_tpu_torch.ops import demod_cuda

    log(f"K1 block ({demod_cuda.BLOCK_WIDTH} channels): {demod_cuda.smem_bytes(demod_cuda.cuda_library())} bytes of "
        f"dynamic shared memory a block")
    log(f"K1 pair block (2 x {demod_cuda.PAIR_TILE} channels): {demod_cuda.pair_smem_bytes(demod_cuda.schedule_library())} "
        f"bytes of dynamic shared memory a block")
    info = {}
    for source in ("demod.cu", "demod_sched.cu"):
        ptxas = ptxas_summary(built[source].log)
        for fn, ins in sass_listing(built[source].path).items():
            ops = {op: sum(1 for _, o, _ in ins if o == op) for op in ("LDS", "STS", "LDG", "STG", "LD", "ST", "LDGSTS")}
            loop = step_loop_instructions(ins)
            log(f"sass {fn}: {len(ins)} instructions, memory {ops}, step loop body {loop}")
            name = k1_schedule_of(fn)
            if name is None:
                continue
            text = " ".join(ptxas.get(fn, []))
            regs = re.search(r"Used (\d+) registers", text)
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", text)]
            info[name] = dict(registers=int(regs.group(1)) if regs else None, spill_bytes=sum(spills),
                              sass_instructions=len(ins), step_loop_instructions=loop)
    for name, v in sorted(info.items()):
        log(f"K1 schedule {name}: {v['registers']} registers, {v['spill_bytes']} bytes spilled, {v['sass_instructions']} SASS "
            f"instructions, step loop body {v['step_loop_instructions']}")
    for fn, lines in ptxas_summary(built["demod_ctcss.cu"].log).items():
        if "demod_ctcss_kernel" in fn:
            text = " ".join(lines)
            regs = re.search(r"Used (\d+) registers", text)
            spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill (?:stores|loads)", text))
            log(f"CTCSS pass {fn}: {regs.group(1) if regs else '?'} registers, {spills} bytes spilled ({text})")
    return info.get("single_u1", {}).get("step_loop_instructions"), info


def phase_parity(device) -> tuple[dict, dict]:
    """K1 against the plain version on the 8192-channel active scene.
    Returns the errors and the scene (params, and per block the state in,
    the inputs and both versions' outputs) for phase 11."""
    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship_stream
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul
    from rtlsdr_airband_tpu_torch.ops.demod import demod_block

    block, state, x_blocks, hot = build_flagship_stream(n_channels=C_FLAGSHIP, wave_batch=W_FLAGSHIP, n_blocks=4, device=device)
    kw = block.block_kwargs
    params = block.params
    ks = ps = state
    err = {"audio": 0.0, "iq": 0.0, "flags_mismatch": 0, "bitwise": True}
    scene = dict(params=params, blocks=[])
    for k, x in enumerate(x_blocks):
        mags, iqs = channelize_matmul(x, block.bins, block.window, hop=kw["hop"], fft_size=kw["fft_size"], n_frames=kw["n_frames"], taps=(block.taps_re, block.taps_im))
        t0 = time.perf_counter()
        kout = demod_cuda.demod_block_cuda(params, ks, mags, iqs, with_iq=True)
        pout = demod_block(params, ps, mags, iqs)
        if device.type == "cuda":
            torch.cuda.synchronize()
        err["audio"] = max(err["audio"], (kout[1] - pout[1]).abs().max().item())
        err["iq"] = max(err["iq"], (kout[2] - pout[2]).abs().max().item())
        err["flags_mismatch"] += int((kout[3] != pout[3]).sum().item())
        diffs = state_diffs(kout[0], pout[0])
        worst = max((v for v in diffs.values() if isinstance(v, float)), default=0.0)
        err["bitwise"] &= same_bits(kout, pout)
        log(f"parity block {k}: audio {err['audio']:.3e} iq {err['iq']:.3e} flag mismatches {err['flags_mismatch']} "
            f"int/bool leaves differing {sum(1 for v in diffs.values() if isinstance(v, int) and v)} "
            f"worst float state {worst:.3e}; bit for bit so far: {err['bitwise']} ({time.perf_counter() - t0:.1f} s)")
        if not err["bitwise"]:
            raise AssertionError(f"parity block {k}: K1 (block width {demod_cuda.BLOCK_WIDTH}) is not bit for bit the plain "
                                 f"version: {err}; state differences {({n: v for n, v in diffs.items() if v})}")
        scene["blocks"].append((ks, mags, iqs, kout, pout))
        ks, ps = kout[0], pout[0]
    opens = ps.open_count[hot].tolist()
    ct = [h for h in hot if bool(params.ctcss_enabled[h])]
    decided = [int(b.found[h] + b.not_found[h]) for h in ct for b in (ps.fast, ps.slow)]
    log(f"parity scene: hot channels {hot} open_count {opens}; CTCSS channel {ct} fast/slow decisions {decided}")
    if min(opens) <= 0 or len(ct) != 1 or sum(decided) <= 0:
        raise AssertionError("parity scene did not open every hot squelch or decide a CTCSS window")
    return err, scene


def phase_snr(device) -> float:
    """The channelizer's float32 GEMMs against float64 at the flagship shape."""
    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship
    from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul, make_frames, make_taps

    block, x, _ = build_flagship(n_channels=C_FLAGSHIP, wave_rate=16000, device=device)
    kw = block.block_kwargs
    _, iq = channelize_matmul(x, block.bins, block.window, hop=kw["hop"], fft_size=kw["fft_size"], n_frames=kw["n_frames"])
    frames = make_frames(x, kw["hop"], kw["fft_size"], kw["n_frames"]).double()
    tr, ti = (t.double() for t in make_taps(block.bins, block.window))
    fr, fi = frames[..., 0], frames[..., 1]
    ref_r = fr @ tr.T - fi @ ti.T
    ref_i = fr @ ti.T + fi @ tr.T
    err = (iq[..., 0].double() - ref_r) ** 2 + (iq[..., 1].double() - ref_i) ** 2
    snr = 10.0 * torch.log10((ref_r**2 + ref_i**2).sum() / err.sum()).item()
    log(f"channelizer SNR vs float64: {snr:.2f} dB (C={C_FLAGSHIP}, N={kw['fft_size']}, W={kw['n_frames']})")
    if not snr >= 80.0:
        raise AssertionError(f"channelizer SNR {snr:.2f} dB < 80 dB")
    return snr


def demod_bound(params, state, mags) -> tuple[float, str, str]:
    """(bound_ms, bound_by, reckoning) of K1 on one block.

    Bytes: every input read once (mags, the W IQ pairs it consumes, params,
    state) and every output written once (state, audio, one flag byte).
    Operations: DEMOD_STEP_FLOPS per channel-sample, plus the two Goertzel
    banks (3 per tone and sample each) on every sample of every CTCSS
    channel - the most the banks could need, so the operations' time is an
    upper bound, and it stays below the bytes' time at the flagship shape."""
    from rtlsdr_airband_tpu_torch.ops.demod_cuda import _flat_state

    W, C = mags.shape
    state_bytes = sum(t.numel() * t.element_size() for t in _flat_state(state).values())
    param_bytes = sum(t.numel() * t.element_size() for t in params)
    nbytes = W * C * 4 + W * C * 2 * 4 + param_bytes + 2 * state_bytes + W * C * 4 + W * C * 1
    n_ctcss = int(params.ctcss_enabled.sum().item())
    tones = params.fast_mask.shape[0]
    flops = DEMOD_STEP_FLOPS * W * C + 2 * 3 * tones * W * n_ctcss
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    how = (f"{nbytes} B / 3.35 TB/s = {bytes_ms:.4f} ms; at most {flops} flop / 67 TFLOP/s = {ops_ms:.4f} ms")
    return max(bytes_ms, ops_ms), by, how


def k1_schedules() -> dict:
    """K1's schedules by name (``demod_cuda.schedule_name``): the default and
    SCHEDULES, as (unroll, pair); the pair schedule needs an even count of
    32-channel tiles, as every count here has."""
    from rtlsdr_airband_tpu_torch.ops import demod_cuda

    return {demod_cuda.schedule_name(u, p): (u, p) for u, p in ((1, False),) + SCHEDULES}


def same_bits(a, b) -> bool:
    """Two demod returns equal bit for bit in every output and state leaf."""
    from rtlsdr_airband_tpu_torch.scripts.common import same_outputs

    return same_outputs(a, b)


def phase_main_path(device, card: str, clock_mhz: float, step_instructions: int | None) -> dict:
    """The port's main path at full width, then its timings."""
    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.ops.channelizer import channelize_matmul
    from rtlsdr_airband_tpu_torch.ops.demod import demod_block
    from rtlsdr_airband_tpu_torch.scripts.bench_scaling import kernel_ms  # K1 alone, not counted in LAUNCHES

    block, x, state0 = build_flagship(n_channels=C_FLAGSHIP, wave_rate=16000, device=device)
    kw = block.block_kwargs
    W, hop = kw["n_frames"], kw["hop"]
    rng = np.random.default_rng(7)
    noise = torch.as_tensor(rng.normal(0, 0.01, (K_BLOCKS,) + tuple(x.shape)).astype(np.float32), device=device)
    xs = [x + noise[k] for k in range(K_BLOCKS)]  # K distinct blocks

    def run_chain(states_in=None):
        st, outs = state0, []
        for xb in xs:
            if states_in is not None:
                states_in.append(st)
            st, out = block(xb, st)
            outs.append(out)
        return st, outs

    states_in, fade_in = [], []
    assemble = demod_cuda.fade_and_tail

    def recording(tail, raw, flags):  # keeps the last block's assembly inputs for fade_tail_timings
        fade_in[:] = [v.clone() for v in (tail, raw, flags)]
        return assemble(tail, raw, flags)

    demod_cuda.LAUNCHES = demod_cuda.CTCSS_LAUNCHES = demod_cuda.FADE_LAUNCHES = 0
    demod_cuda.fade_and_tail = recording
    try:
        _, outs = run_chain(states_in)
    finally:
        demod_cuda.fade_and_tail = assemble
    torch.cuda.synchronize()
    launches, ctcss_launches, fade_launches = demod_cuda.LAUNCHES, demod_cuda.CTCSS_LAUNCHES, demod_cuda.FADE_LAUNCHES
    if (launches, ctcss_launches, fade_launches) != (K_BLOCKS,) * 3:  # the flagship has CTCSS channels
        raise AssertionError(f"main path launched K1 {launches} times, the CTCSS pass {ctcss_launches} times and the "
                             f"fade-tail kernel {fade_launches} times for {K_BLOCKS} blocks")
    for k, out in enumerate(outs):
        if tuple(out["audio"].shape) != (W, C_FLAGSHIP) or not bool(torch.isfinite(out["audio"]).all()):
            raise AssertionError(f"main path block {k}: audio not finite or misshapen")
        for key in ("signal_level", "noise_level", "squelch_level"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"main path block {k}: {key} not finite")
    active = [int(out["active"].sum().item()) for out in outs]
    log(f"main path: {K_BLOCKS} blocks, K1 launches {launches}, CTCSS pass launches {ctcss_launches}, "
        f"fade-tail launches {fade_launches}, outputs finite, "
        f"channels active per block {active}")

    # ---- timings, on the main path's own blocks and states ----
    block_ms = time_ms(run_chain, reps=3) / K_BLOCKS
    block_s = block_ms / 1e3
    params = block.params
    taps = (block.taps_re, block.taps_im)
    inputs = [channelize_matmul(xb, block.bins, block.window, hop=hop, fft_size=kw["fft_size"], n_frames=W, taps=taps) for xb in xs]
    gemm_ms = time_ms(lambda: channelize_matmul(xs[0], block.bins, block.window, hop=hop, fft_size=kw["fft_size"], n_frames=W, taps=taps), reps=10)
    # K1 alone in each schedule on each block, with and without the Goertzel
    # banks (how much of K1 the CTCSS channels cost); every schedule's
    # outputs on a block equal the default's bit for bit
    default = demod_cuda.schedule_name(1, False)
    per = {(d, ct): [] for d in k1_schedules() for ct in (True, False)}
    for k, (st, (m, q)) in enumerate(zip(states_in, inputs)):
        for ct in (True, False):
            outs_k = {}
            for d, (unroll, pair) in k1_schedules().items():
                ms, outs_k[d] = kernel_ms(params, st, m, q, reps=3, with_ctcss=ct, unroll=unroll, pair=pair)
                per[d, ct].append(ms)
            if not all(same_bits(outs_k[default], o) for o in outs_k.values()):
                raise AssertionError(f"block {k} (with_ctcss={ct}): K1's schedules differ: " + ", ".join(
                    f"{d} {'=' if same_bits(outs_k[default], o) else '!='} {default}" for d, o in outs_k.items()))
    mean = {key: sum(v) / K_BLOCKS for key, v in per.items()}
    last_mags, last_iqs = inputs[-1]
    plain_ms = time_ms(lambda: demod_block(params, states_in[-1], last_mags, last_iqs), reps=1, warmup=0)
    bound_ms, bound_by, how = demod_bound(params, states_in[-1], last_mags)
    issue_ms = W * step_instructions / (clock_mhz * 1e3) if step_instructions else None
    fade = fade_tail_timings(*fade_in, card)
    split = ctcss_split_timings(device, card)
    t = dict(
        block_ms=block_ms,
        channel_msps=C_FLAGSHIP * W * hop / block_s / 1e6,
        realtime_factor=(W / 16000) / block_s,
        k1_ms=mean[default, True],
        k1_no_ctcss_ms=mean[default, False],
        gemm_ms=gemm_ms,
        plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by=bound_by,
        issue_bound_ms=issue_ms,
        launches=launches,
        ctcss_launches=ctcss_launches,
        fade_launches=fade_launches,
        fade=fade,
        ctcss_split=split,
        flagship=(block, x, state0),
        schedule_ms={d: mean[d, True] for d in k1_schedules() if d != default},
        schedule_no_ctcss_ms={d: mean[d, False] for d in k1_schedules() if d != default},
    )
    for (d, ct), v in per.items():
        log(f"K1 {d:<9s} {'with' if ct else 'without'} the CTCSS banks, per main-path block (ms): "
            f"{' '.join(f'{x:.4f}' for x in v)}; mean {mean[d, ct]:.4f}")
    log(f"K1 schedules against the default [{card}], equal to it bit for bit on all {K_BLOCKS} main-path blocks; their mean "
        "with / without the CTCSS banks: " + "; ".join(
            f"{n} {t['schedule_ms'][n]:.4f} / {t['schedule_no_ctcss_ms'][n]:.4f} ms ({t['schedule_ms'][n] / mean[default, True]:.3f}x)"
            for n in t["schedule_ms"]))
    log(f"K1 bound ({bound_by}): {how}")
    if issue_ms is not None:
        log(f"K1 issue bound: W x {step_instructions} SASS instructions of one step's loop body / {clock_mhz:.0f} MHz "
            f"= {issue_ms:.4f} ms ({1e3 * issue_ms / W:.4f} us a step)")
    gemm_flop = 4 * 2 * W * kw["fft_size"] * C_FLAGSHIP
    log(f"channelizer GEMMs' bound (operations): 4 x 2*W*N*C = {gemm_flop} flop / 67 TFLOP/s = {gemm_flop / FP32_FLOPS * 1e3:.4f} ms")
    profile_chain(run_chain, card)
    log(
        f"timing [{card}]: block_ms {block_ms:.3f} channel_msps {t['channel_msps']:.1f} realtime_factor {t['realtime_factor']:.2f} "
        f"k1_ms {t['k1_ms']:.4f} gemm_ms {gemm_ms:.3f} "
        f"plain_demod_ms {plain_ms:.1f} k1_bound_ms {bound_ms:.4f}"
    )
    return t


def fade_tail_timings(tail, raw, flags, card: str) -> dict:
    """The fade-tail kernel on the main path's last block (K1's audio, flag
    bytes and carried tail as ``run_with`` handed them over), at each width
    of FADE_CHANNELS (the block's first C channels): its outputs against the
    plain assembly's with the flag decode, bit for bit; the kernel alone
    (CUDA events right around its launch, min of 20) and the plain version
    (min of 5); its bytes bound 10 W C + 8 A C at HBM_BYTES_PER_S.  Keyed by
    C; not counted in FADE_LAUNCHES."""
    import torch

    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.ops.demod import apply_fade_and_tail

    def bits(v):
        return v.view(torch.int32) if v.is_floating_point() else v

    lib = demod_cuda.fade_library()
    r = {}
    for C in FADE_CHANNELS:
        tl, rw, fl = (v[:, :C].contiguous() for v in (tail, raw, flags))
        A, W = tl.shape[0], rw.shape[0]
        *got, args = demod_cuda._fade_tail_args(lib, tl, rw, fl)

        def plain():
            return (*apply_fade_and_tail(tl, rw, (fl & 2) != 0), (fl & 1) != 0)

        ms = time_ms(lambda: demod_cuda.launch_fade_tail(lib, args), reps=20)
        plain_ms = time_ms(plain, reps=5)
        want = plain()
        if not all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want)):
            raise AssertionError(f"fade-tail kernel at (W, C) = ({W}, {C}): audio, new tail or open flags differ from the plain assembly")
        marks = int(((fl & 2) != 0).sum())
        bound_ms = (10 * W * C + 8 * A * C) / HBM_BYTES_PER_S * 1e3
        r[C] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, marks=marks)
        log(f"fade-tail kernel at (W, C, A) = ({W}, {C}, {A}) [{card}]: {ms:.4f} ms alone, plain assembly {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms (bytes: 10 W C + 8 A C = {10 * W * C + 8 * A * C} B); {marks} close marks, "
            f"audio, new tail and open flags equal bit for bit")
    return r


SPLIT_SCENES = (  # (label, channels, population, with_ctcss): the cells' populations
    ("mixed8192", C_FLAGSHIP, "mixed", True),
    ("am8192", C_FLAGSHIP, "am_one_ctcss", True),
    ("vhf2280", 2280, "am", False),
)


def split_scene(population: str, C: int, device, seed: int):
    """(params, state, mags, iqs) of a block of W_FLAGSHIP samples at C
    channels in the main path's order: ``mixed`` the flagship's four kinds
    (a quarter NFM with CTCSS), ``am_one_ctcss`` AM with channel 0 on CTCSS
    100 Hz (am8192's), ``am`` AM alone (vhf2280's).  Every channel's air is
    strong, so every squelch opens; the CTCSS channels start open with
    their windows 40 (fast) and 100 (slow) samples from their end, so both
    decide and the fast bank stops: the most the banks can cost."""
    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import CENTER_FREQ, flagship_specs
    from rtlsdr_airband_tpu_torch.ops.demod import OPEN
    from rtlsdr_airband_tpu_torch.ops.params import ChannelSpec, cost_group_permutation, init_demod_state, make_channel_params

    specs = flagship_specs(C)
    if population != "mixed":
        specs = [ChannelSpec(frequency=sp.frequency, modulation="am", ctcss=100.0 if population == "am_one_ctcss" and i == 0 else 0.0)
                 for i, sp in enumerate(specs)]
    specs = [specs[i] for i in cost_group_permutation(specs)]
    params = make_channel_params(specs, wave_rate=16000, sample_rate=2_560_000, center_freq=CENTER_FREQ, fft_size=512, device=device)
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    st = init_demod_state(C, f32(np.abs(rng.normal(0, 1.0, (100, C)))), f32(rng.normal(0, 0.5, (100, C, 2))))
    ct = params.ctcss_enabled
    cur = torch.where(ct, torch.full_like(st.cur, OPEN), st.cur)

    def left(b, name: str, samples: int):  # the bank's window `samples` from its end on the CTCSS channels
        return b._replace(count=torch.where(ct, getattr(params, f"{name}_window") - samples, b.count))

    fast, slow = left(st.fast, "fast", 40), left(st.slow, "slow", 100)
    st = st._replace(noise_floor=torch.full_like(st.noise_floor, 0.3), pre_full=torch.full_like(st.pre_full, 1.2),
                     pre_capped=torch.full_like(st.pre_capped, 1.2), cur=cur, nxt=cur.clone(), fast=fast, slow=slow)
    mags = f32(np.abs(rng.normal(0, 1.0, (W_FLAGSHIP, C)) + 3.0))
    iqs = f32(rng.normal(0, 0.5, (W_FLAGSHIP, C, 2)))
    return params, st, mags, iqs


def demod_split_ms(params, state, mags, iqs, with_ctcss: bool, reps: int = 5) -> tuple[float, float | None, tuple]:
    """K1 alone (default schedule) and the CTCSS pass alone on one block:
    CUDA events right around each launch, min over ``reps`` after one
    warm-up; the pass None when ``with_ctcss`` is off (not launched).
    Returns (k1_ms, pass_ms, the last run's outputs)."""
    import ctypes

    import torch

    from rtlsdr_airband_tpu_torch.ops import demod_cuda

    lib, plib = demod_cuda.cuda_library(), demod_cuda.ctcss_library()
    times = []

    def launch(args):
        stream = torch.cuda.current_stream().cuda_stream
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        if lib.demod_launch(ctypes.addressof(args), stream):
            raise RuntimeError("K1 launch failed")
        ev[1].record()
        if with_ctcss and plib.demod_ctcss_launch(ctypes.addressof(args), stream):
            raise RuntimeError("CTCSS pass launch failed")
        ev[2].record()
        times.append(ev)

    for _ in range(reps + 1):
        out = demod_cuda.run_with(launch, lib, params, state, mags, iqs, False, with_ctcss, False)
    torch.cuda.synchronize()
    k1 = min(e[0].elapsed_time(e[1]) for e in times[1:])
    ps = min(e[1].elapsed_time(e[2]) for e in times[1:]) if with_ctcss else None
    return k1, ps, out


def ctcss_pass_bound(n_ctcss: int, tones: int) -> tuple[float, str, str]:
    """(bound_ms, bound_by, reckoning) of the CTCSS pass on a block of
    W_FLAGSHIP samples with every squelch open.  Bytes: each CTCSS channel's
    audio and flag bytes read and written (10 W), and its two banks' q1 and q2
    read and written and coefficients and masks read (2 tones (16 + 4 + 1)).
    Operations: 2 * 3 flop a tone a sample in both banks."""
    nbytes = n_ctcss * (10 * W_FLAGSHIP + 2 * tones * 21)
    flops = 2 * 3 * tones * W_FLAGSHIP * n_ctcss
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    how = f"{nbytes} B / 3.35 TB/s = {bytes_ms:.4f} ms; {flops} flop / 67 TFLOP/s = {ops_ms:.4f} ms"
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), how


def ctcss_split_timings(device, card: str) -> dict:
    """K1 alone and the CTCSS pass alone in each of SPLIT_SCENES, beside K1
    with the banks off (``kernel_ms``, with_ctcss False); the split run's
    outputs against ``demod_block_cuda``'s (K1 and the pass through
    ``launch_k1``) bit for bit.  Keyed by label."""
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.scripts.bench_scaling import kernel_ms

    r = {}
    for k, (label, C, population, with_ctcss) in enumerate(SPLIT_SCENES):
        params, st, mags, iqs = split_scene(population, C, device, seed=31 + k)
        k1, ps, out = demod_split_ms(params, st, mags, iqs, with_ctcss)
        no_banks, _ = kernel_ms(params, st, mags, iqs, reps=5, with_ctcss=False)
        want = demod_cuda.demod_block_cuda(params, st, mags, iqs, with_ctcss=with_ctcss, with_iq=False)
        if not same_bits(want, out):
            raise AssertionError(f"{label}: K1 and the CTCSS pass launched apart differ from launch_k1's")
        n_ct = int(params.ctcss_enabled.sum())
        bound_ms, bound_by, how = ctcss_pass_bound(n_ct, params.fast_mask.shape[0])
        r[label] = dict(C=C, n_ctcss=n_ct, k1_ms=k1, pass_ms=ps, k1_no_banks_ms=no_banks, pass_bound_ms=bound_ms, pass_bound_by=bound_by)
        log(f"demod split [{card}] {label} (W, C) = ({W_FLAGSHIP}, {C}), {n_ct} CTCSS channels, every squelch open: K1 alone "
            f"{k1:.4f} ms, CTCSS pass alone {'not launched' if ps is None else f'{ps:.4f} ms'}, K1 without the banks "
            f"{no_banks:.4f} ms; bit for bit the launcher's; the pass's bound ({bound_by}): {how}")
    return r


def profile_chain(run_chain, card: str) -> None:
    """Device time of the K-block main path by kernel, from torch.profiler,
    and the device's busy share of the wall time (the profiler's own cost
    included).  A profiler that records no device time is reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_chain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [
        (e.key, e.device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
    ]
    if not rows:
        log("profile: torch.profiler recorded no device time")
        return
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"profile of {K_BLOCKS} main-path blocks [{card}]: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
        f"({100 * busy / wall_ms:.1f}%, profiler on); by kernel:")
    for key, ms, n in rows[:10]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key[:110]}")


def probe_bound(x, kind: str, clock_mhz: float) -> tuple[float, str, float, str]:
    """(bound_ms, bound_by, latency_ms, reckoning) of K2 on one block.

    Bytes: the [2, SUBL, 128] tile read once and written once.  Operations:
    two float32 operations a link, W * L links a trip, on each chain of each
    lane.  Neither binds: each thread's W * L * 2 operations depend each on
    the one before, so the least time is that chain at the dependent
    latency, at the card's highest SM clock."""
    from rtlsdr_airband_tpu_torch.scripts import bench_chain_probe as probe

    W, L = probe.W, probe.L
    nbytes = 2 * x.numel() * x.element_size()
    flops = probe.CHAINS[kind] * (x.numel() // 2) * W * L * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOPS * 1e3
    latency_ms = W * L * 2 * FP32_DEP_LATENCY_CYCLES / (clock_mhz * 1e6) * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    how = (f"{nbytes} B / 3.35 TB/s = {bytes_ms:.6f} ms; {flops} flop / 67 TFLOP/s = {ops_ms:.6f} ms; "
           f"dependency chain W*L*2 = {W * L * 2} operations x {FP32_DEP_LATENCY_CYCLES} cycles / {clock_mhz:.0f} MHz "
           f"= {latency_ms:.6f} ms")
    return max(bytes_ms, ops_ms), by, latency_ms, how


def phase_probe(device, card: str, t: dict, clock_mhz: float) -> dict:
    """K2 through the probe's entry point, then against its plain version."""
    import contextlib
    import io

    import torch

    from rtlsdr_airband_tpu_torch.scripts import bench_chain_probe as probe

    out = io.StringIO()
    probe.LAUNCHES = 0
    with contextlib.redirect_stdout(out):
        rc = probe.main(device)
    launches = probe.LAUNCHES
    lines = out.getvalue().splitlines()
    if rc != 0 or not lines:
        raise AssertionError(f"bench_chain_probe.main exited {rc}")
    res = json.loads(lines[-1])
    want_launches = 3 * (probe.REPS + 1) * probe.K
    if launches != want_launches:
        raise AssertionError(f"the probe launched K2 {launches} times, expected {want_launches}")
    if lines[0] != card or res["device"] != torch.cuda.get_device_name(device):
        raise AssertionError(f"the probe ran on {lines[0]!r} / {res['device']!r}, not on {card!r}")
    kinds = res["kinds"]
    log(f"probe (bench_chain_probe.main, W={res['W']} L={res['L']} K={probe.K} REPS={probe.REPS}), K2 launches {launches}: "
        + "; ".join(f"{k} {v['ms_per_block']:.4f} ms/block {v['us_per_step']:.4f} us/step (SUBL {v['subl']})" for k, v in kinds.items()))
    log(f"probe: chain2_vs_chain1 {res['chain2_vs_chain1']:.4f} wide_vs_chain1 {res['wide_vs_chain1']:.4f}; {res['verdict']}")

    err, plain_ms, bounds = 0.0, {}, {}
    for kind, xs in probe.probe_inputs(device).items():
        x = xs[0]
        got = probe.chain_probe(x, kind, probe.W, probe.L)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = probe.chain_probe_plain(x, kind, probe.W, probe.L)
        end.record()
        end.synchronize()
        plain_ms[kind] = start.elapsed_time(end)
        diff = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 {kind}: kernel differs from the plain version (max |diff| {diff:.3e}, "
                                 f"{int((got != want).sum().item())} of {got.numel()} elements)")
        err = max(err, diff)
        bounds[kind] = probe_bound(x, kind, clock_mhz)
        log(f"K2 {kind}: equal to the plain version bit for bit (both rows, {got.numel()} elements); "
            f"plain {plain_ms[kind]:.1f} ms; bound {bounds[kind][0]:.6f} ms ({bounds[kind][1]}), "
            f"latency bound {bounds[kind][2]:.6f} ms; {bounds[kind][3]}")
    c1_ms = kinds["chain1"]["ms_per_block"]
    if c1_ms < 0.5 * bounds["chain1"][2]:
        raise AssertionError(f"chain1 took {c1_ms:.4f} ms, under half its latency bound: the chain was optimised away")
    W1 = W_FLAGSHIP
    log(f"step [{card}]: K2 chain1 {kinds['chain1']['us_per_step']:.4f} us (latency bound "
        f"{bounds['chain1'][2] / res['W'] * 1e3:.4f} us at {FP32_DEP_LATENCY_CYCLES} cycles, {clock_mhz:.0f} MHz); "
        f"K1 {t['k1_ms'] / W1 * 1e3:.4f} us with the CTCSS banks, {t['k1_no_ctcss_ms'] / W1 * 1e3:.4f} us without "
        f"({t['k1_no_ctcss_ms'] / W1 * 1e3 / kinds['chain1']['us_per_step']:.2f}x the 40-link chain)")
    return dict(launches=launches, err=err, ms=c1_ms, plain_ms=plain_ms["chain1"], bound_ms=bounds["chain1"][0],
                bound_by=bounds["chain1"][1], latency_bound_ms=bounds["chain1"][2])


def stream_bytes(specs, n_blocks: int, seed: int, *, sample_rate=2_560_000, wave_rate=16000, fft_size=512) -> bytes:
    """The streaming phase's input, a u8 stream as an RTL-SDR hands it over:
    priming plus ``n_blocks`` blocks; six AM carriers, each on one channel's
    frequency with its own tone, gated on and off at their own times (so
    squelch opens and closes), over noise; all from ``seed``."""
    from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
    from rtlsdr_airband_tpu_torch.models.flagship import CENTER_FREQ
    from rtlsdr_airband_tpu_torch.utils.siggen import am_carrier_iq, complex_noise

    hop, W = int(round(sample_rate / wave_rate)), wave_rate // 8
    n = AGC_EXTRA * hop + (n_blocks * W - 1) * hop + fft_size
    rng = np.random.default_rng(seed)
    z = complex_noise(n, 0.02, seed)
    t = np.arange(int(n * wave_rate / sample_rate) + 2) / wave_rate
    for j, ch in enumerate(np.linspace(7, len(specs) - 9, 6).astype(int)):
        gate = np.zeros(n, np.float32)
        gate[int(rng.uniform(0.02, 0.3) * n) : int(rng.uniform(0.5, 0.75) * n)] = 1.0
        if j % 2 == 0:
            gate[int(0.88 * n) :] = 1.0
        tone = 0.7 * np.sin(2 * np.pi * (300.0 + 150.0 * j) * t)
        z += gate * am_carrier_iq(sample_rate, specs[ch].frequency - CENTER_FREQ, n, audio=tone, carrier_ampl=0.1, audio_rate=wave_rate)
    u8 = np.empty(2 * n, np.uint8)
    u8[0::2] = np.clip(np.round(z.real * 127.5 + 127.5), 0, 255)
    u8[1::2] = np.clip(np.round(z.imag * 127.5 + 127.5), 0, 255)
    return u8.tobytes()


def stream(p, raw: bytes, on_block=None) -> tuple[int, float]:
    """Feed ``raw`` one block of bytes a call, then flush; (blocks yielded,
    wall seconds of feed + flush, the device synchronised at the end)."""
    import torch

    step = 2 * p.W * p.hop
    blocks = []
    t0 = time.perf_counter()
    for gen in [p.feed(raw[i : i + step]) for i in range(0, len(raw), step)] + [p.flush()]:
        for o in gen:
            if on_block is not None:
                on_block(o)
            blocks.append(None)
    torch.cuda.synchronize()
    return len(blocks), time.perf_counter() - t0


def host_split(p, raw: bytes) -> tuple[dict, int, float]:
    """Where the host's wall time of one streaming run goes: enqueueing the
    chunks (``_dispatch``: H2D staging and the chain's launches), waiting
    for a chunk's copy to land, rebuilding the yielded blocks
    (``_to_host`` less that wait), and the rest (ingest, priming, the
    generators).  Host seconds, by wrapping the pipeline's own methods."""
    import torch

    spent = {"dispatch": 0.0, "wait": 0.0, "rebuild": 0.0}
    dispatch, to_host, event_sync = p._dispatch, p._to_host, torch.cuda.Event.synchronize

    def timed_dispatch(k):
        t = time.perf_counter()
        dispatch(k)
        spent["dispatch"] += time.perf_counter() - t

    def timed_sync(event):
        t = time.perf_counter()
        event_sync(event)
        spent["wait"] += time.perf_counter() - t

    def timed_to_host(item):
        gen = to_host(item)
        while True:
            t, w = time.perf_counter(), spent["wait"]
            o = next(gen, None)
            spent["rebuild"] += time.perf_counter() - t - (spent["wait"] - w)
            if o is None:
                return
            yield o

    p._dispatch, p._to_host = timed_dispatch, timed_to_host
    torch.cuda.Event.synchronize = timed_sync
    n, wall = stream(p, raw)
    torch.cuda.Event.synchronize = event_sync
    spent["rest"] = wall - sum(spent.values())
    return spent, n, wall


def profile_stream(p, raw: bytes, card: str) -> tuple[float, float, float]:
    """torch.profiler over one streaming run: (kernel device ms, copy device
    ms, wall ms of the run with the profiler on); the top kernels logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        n, wall = stream(p, raw)
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    if not rows:
        raise AssertionError("torch.profiler recorded no device time for the streaming run")
    rows.sort(key=lambda r: -r[1])
    copies = sum(ms for key, ms, _ in rows if key.startswith(("Memcpy", "Memset")))
    kernels = sum(ms for key, ms, _ in rows) - copies
    log(f"profile of the streaming run ({n} blocks) [{card}]: kernels {kernels:.3f} ms, copies {copies:.3f} ms "
        f"(copy stream, overlapping), wall {wall * 1e3:.3f} ms with the profiler on; by kernel:")
    for key, ms, cnt in rows[:12]:
        log(f"  {ms:9.3f} ms  x{cnt:<5d} {key[:110]}")
    return kernels, copies, wall * 1e3


def phase_stream(device, card: str) -> dict:
    """The port's Pipeline at full width (phase 7 of the module docstring)."""
    import dataclasses

    import torch

    from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
    from rtlsdr_airband_tpu_torch.models.flagship import CENTER_FREQ, flagship_specs
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.ops.channelizer import block_input_len, channelize_fft, channelize_matmul, make_frames
    from rtlsdr_airband_tpu_torch.ops.sampleconv import SampleFormat, decode_iq
    from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig, pack_block, pipeline_block

    specs = flagship_specs(C_FLAGSHIP)
    t0 = time.perf_counter()
    raw = stream_bytes(specs, STREAM_BLOCKS, seed=11)
    base = dict(sample_rate=2_560_000, center_freq=CENTER_FREQ, fft_size=512, wave_rate=16000,
                sample_format="u8", fullscale=127.5)
    prod = dict(base, chunk_blocks=8, async_depth=1, active_slots=STREAM_SLOTS, fetch_audio_fmt="i8bf",
                suppress_fade_tails=True, fetch_meta_per_chunk=True)

    def pipe(cfg, chan_specs=specs):
        p = Pipeline(PipelineConfig(**cfg), chan_specs)
        p.warm()
        return p

    p = pipe(prod)
    W, hop, N, A = p.W, p.hop, p.N, AGC_EXTRA
    log(f"stream: {len(raw)} u8 bytes, {STREAM_BLOCKS} blocks after priming, C={C_FLAGSHIP} W={W} hop={hop} N={N} "
        f"(made in {time.perf_counter() - t0:.1f} s)")

    # ---- (a) production settings: the counted run ----
    want_keys = {"audio", "active", "gather_overflow", "sig_outside"} | {
        "signal_level", "noise_level", "squelch_level", "open_count", "flappy_count", "ctcss_found", "ctcss_not_found"}
    per_block = []

    def check(o):
        k = len(per_block)
        if set(o) != want_keys:
            raise AssertionError(f"stream block {k}: keys {sorted(o)}, expected {sorted(want_keys)}")
        if o["audio"].shape != (W, C_FLAGSHIP) or not np.isfinite(o["audio"]).all():
            raise AssertionError(f"stream block {k}: audio {o['audio'].shape} not finite or misshapen")
        per_block.append((int(o["active"].sum()), int(o["gather_overflow"]), int(np.count_nonzero(np.abs(o["audio"]).max(axis=0)))))

    demod_cuda.LAUNCHES = 0
    n, _ = stream(p, raw, check)
    launches = demod_cuda.LAUNCHES
    if not (launches == p.blocks_processed == n == STREAM_BLOCKS):
        raise AssertionError(f"stream: K1 launches {launches}, blocks processed {p.blocks_processed}, yielded {n}, "
                             f"expected {STREAM_BLOCKS}")
    if max(a for a, _, _ in per_block) == 0:
        raise AssertionError("stream: no channel opened")
    d2h = p.fetched_bytes / p.blocks_processed
    log(f"stream (a) [{card}]: {n} blocks, K1 launches {launches} = blocks processed; active channels a block "
        f"{[a for a, _, _ in per_block]}; channels with audio {[c for _, _, c in per_block]}; overflows "
        f"{[o for _, o, _ in per_block]} (total {p.gather_overflow_count}); D2H {d2h:.0f} B a block")
    walls = []
    for _ in range(2):
        q = pipe(prod)
        n_t, wall = stream(q, raw)
        walls.append(wall / n_t * 1e3)
    wall_ms = min(walls)
    split, n_s, wall_s = host_split(pipe(prod), raw)
    log(f"stream (a) host [{card}]: per block " + ", ".join(f"{k} {v / n_s * 1e3:.3f} ms" for k, v in split.items())
        + f" of {wall_s / n_s * 1e3:.3f} ms wall")
    kernels_ms, copies_ms, prof_wall_ms = profile_stream(pipe(prod), raw, card)
    device_ms = kernels_ms / STREAM_BLOCKS
    log(f"stream (a) timing [{card}]: wall a block of feed + flush {' '.join(f'{w:.3f}' for w in walls)} ms "
        f"(min {wall_ms:.3f}), realtime factor {(W / 16000) / (wall_ms / 1e3):.2f}; device time a block "
        f"{device_ms:.3f} ms of kernels (+ {copies_ms / STREAM_BLOCKS:.3f} ms of copies on the copy stream), "
        f"idle share {100 * (1 - device_ms / wall_ms):.1f} % (1 - device / wall)")

    # ---- (b) determinism: chunked + async against single-block dispatch ----
    ref = []
    stream(pipe(dict(base, chunk_blocks=1, async_depth=0)), raw, lambda o: ref.append({k: np.array(v) for k, v in o.items()}))
    same = []

    def compare(o):
        r = ref[len(same)]
        bad = [k for k in r if k not in o or r[k].dtype != np.asarray(o[k]).dtype or r[k].tobytes() != np.asarray(o[k]).tobytes()]
        same.append(not bad and r.keys() == o.keys())
        if bad:
            raise AssertionError(f"determinism: block {len(same) - 1} differs in {bad} (chunk_blocks 8 against 1)")

    n_b, _ = stream(pipe(dict(base, chunk_blocks=8, async_depth=1)), raw, compare)
    if n_b != len(ref) or not all(same):
        raise AssertionError(f"determinism: {n_b} against {len(ref)} blocks")
    log(f"stream (b) [{card}]: dense f32, chunk_blocks 8 / async_depth 1 equals chunk_blocks 1 / async_depth 0 bit for bit "
        f"in every key ({sorted(ref[0])}) of all {n_b} blocks")

    # ---- (c) the FFT channelizer and the AFC spectrum ----
    afc_specs = [dataclasses.replace(s, afc=1) if i % 4 == 0 else s for i, s in enumerate(specs)]
    p = pipe(dict(prod, channelizer="fft", chunk_blocks=4), afc_specs)
    L = block_input_len(W, hop, N)
    raw4 = raw[: 2 * (A * hop + (4 * W - 1) * hop + N)]
    spectra = []
    launches_before = demod_cuda.LAUNCHES
    n_c, _ = stream(p, raw4, lambda o: spectra.append(np.array(o["spectrum_power"])))
    if n_c != 4 or demod_cuda.LAUNCHES - launches_before != 4:
        raise AssertionError(f"fft stream: {n_c} blocks, {demod_cuda.LAUNCHES - launches_before} K1 launches, expected 4")
    worst = 0.0
    for k, got in enumerate(spectra):
        off = A * hop + k * W * hop
        frame = decode_iq(raw[2 * (off + (W - 1) * hop) : 2 * (off + (W - 1) * hop + N)], SampleFormat.U8).astype(np.float64)
        ref_p = np.abs(np.fft.fft((frame[:, 0] + 1j * frame[:, 1]) * p.window.cpu().double().numpy())) ** 2
        if got.shape != (N,) or not np.isfinite(got).all():
            raise AssertionError(f"fft stream block {k}: spectrum_power {got.shape} not finite or misshapen")
        worst = max(worst, float(np.linalg.norm(got - ref_p) / np.linalg.norm(ref_p)))
    if not worst <= 1e-4:
        raise AssertionError(f"AFC spectrum: relative error {worst:.3e} against float64 > 1e-4")
    x0 = torch.from_numpy(decode_iq(raw[2 * A * hop : 2 * (A * hop + L)], SampleFormat.U8)).to(device)
    mags, iq = channelize_fft(x0, p.bins, p.window, hop=hop, fft_size=N, n_frames=W)
    frames = make_frames(x0.double(), hop, N, W) * p.window.double()[:, None]
    spec = torch.fft.fft(torch.view_as_complex(frames.contiguous()))[:, p.bins.long()]
    got = torch.complex(iq[..., 0].double(), iq[..., 1].double())
    snr_iq = 10 * torch.log10((spec.abs() ** 2).sum() / ((got - spec).abs() ** 2).sum()).item()
    snr_mag = 10 * torch.log10((spec.abs() ** 2).sum() / ((mags.double() - spec.abs()) ** 2).sum()).item()
    if not min(snr_iq, snr_mag) >= 80.0:
        raise AssertionError(f"channelize_fft SNR iq {snr_iq:.2f} dB, mags {snr_mag:.2f} dB < 80 dB")
    fft_ms = time_ms(lambda: channelize_fft(x0, p.bins, p.window, hop=hop, fft_size=N, n_frames=W), reps=10)
    mm_ms = time_ms(lambda: channelize_matmul(x0, p.bins, p.window, hop=hop, fft_size=N, n_frames=W, taps=p._taps), reps=10)
    out_bytes = W * C_FLAGSHIP * 12  # mags [W, C] f32 + iq [W, C, 2] f32
    fft_bytes = L * 8 + N * 4 + C_FLAGSHIP * 4 + out_bytes
    fft_flop = W * 5 * N * int(np.log2(N)) + 3 * W * C_FLAGSHIP
    fft_bound = max(fft_bytes / HBM_BYTES_PER_S, fft_flop / FP32_FLOPS) * 1e3
    mm_bound = max((L * 8 + 2 * C_FLAGSHIP * N * 4 + out_bytes) / HBM_BYTES_PER_S, 8 * W * N * C_FLAGSHIP / FP32_FLOPS) * 1e3
    log(f"stream (c) [{card}]: channelizer fft + AFC on {sum(1 for s in afc_specs if s.afc)} channels, {n_c} blocks, "
        f"K1 launches 4; channelize_fft SNR against float64 iq {snr_iq:.2f} dB, mags {snr_mag:.2f} dB; AFC spectrum "
        f"relative error against float64 {worst:.3e} (worst of {n_c} blocks)")
    log(f"channelizer on one block [{card}]: channelize_fft {fft_ms:.4f} ms (bound {fft_bound:.4f} ms, bytes: {fft_bytes} B; "
        f"{fft_flop} flop), channelize_matmul {mm_ms:.4f} ms (bound {mm_bound:.4f} ms, operations)")

    # the chain's packing on one block of production output
    st_in = p.state
    _, out = pipeline_block(x0, p.bins, p.window, p.params, st_in, hop=hop, fft_size=N, n_frames=W, use_fft=True,
                            with_ctcss=p.any_ctcss, with_afc=True, with_iq=False, taps=p._taps, inv_perm=p._inv_perm)
    pack_kw = dict(inv_perm=p._inv_perm, active_slots=STREAM_SLOTS, with_iq=False, with_afc=True, audio_fmt="i8bf",
                   suppress_fade_tails=True, meta_per_chunk=True)
    pack_ms = time_ms(lambda: pack_block(out, st_in, p.params, **pack_kw), reps=10)
    pack_bytes = W * C_FLAGSHIP * 4 + C_FLAGSHIP * (1 + 4 + 4 + 1) + W * STREAM_SLOTS + STREAM_SLOTS * 8 + 4 + C_FLAGSHIP + N * 4
    pack_bound = pack_bytes / HBM_BYTES_PER_S * 1e3
    log(f"chain packing on one block [{card}]: {pack_ms:.4f} ms (slots {STREAM_SLOTS}, i8bf, suppression); bound "
        f"{pack_bound:.4f} ms, bytes: {pack_bytes} B")
    return dict(launches=launches, wall_ms=wall_ms, device_ms=device_ms, d2h=d2h, fft_ms=fft_ms, mm_ms=mm_ms,
                fft_bound=fft_bound, pack_ms=pack_ms, pack_bound=pack_bound, snr=min(snr_iq, snr_mag), afc_err=worst)


def app_scene(path: str, freqs: list[int], hot: list[int], total: int, *, center: int, fs: int) -> list[float]:
    """The App phase's input, written by ``scripts/bench_app.py::build_scene``:
    noise, and one AM carrier a hot channel, keyed on after a quarter of the
    file (an always-on carrier would become the noise floor), its tone at the
    full IQ rate, the carriers' sum inside the u8 range.  Returns the tones."""
    from rtlsdr_airband_tpu_torch.scripts.bench_app import build_scene

    build_scene(path, freqs, hot, center, fs, total, 16000)
    return [500.0 + 130.0 * k for k in range(len(hot))]


def app_config(iq_path: str, freqs: list[int], ctcss_channel: int, *, center: int, fs: int, wave_rate: int) -> str:
    """libconfig text for the App phase (scripts/bench_app.py's, with a UDP
    port of its own for every channel)."""
    from rtlsdr_airband_tpu_torch.ops.levels import level_to_dbfs

    # manual squelch midway (log scale) between the noise and the carrier bin
    # levels: a deterministic open set (scripts/bench_app.py)
    thr = round(float(level_to_dbfs(1.0, 512)), 1)
    chans = ", ".join(
        f'{{ freq = {f}; modulation = "am";{" ctcss = 100.0;" if i == ctcss_channel else ""} squelch_threshold = {thr}; '
        f'outputs: ( {{ type = "udp_stream"; dest_address = "127.0.0.1"; dest_port = {APP_UDP_BASE + i}; }} ); }}'
        for i, f in enumerate(freqs)
    )
    return (
        f"fft_size = 512;\nwave_rate = {wave_rate};\nblocks_per_dispatch = {APP_CHUNK};\n"
        f'active_fetch_slots = {APP_SLOTS};\nfetch_audio_fmt = "i8bf";\nsuppress_fade_tails = true;\n'
        f"fetch_meta_per_chunk = true;\n"
        f'devices: ( {{ type = "file"; filepath = "{iq_path}"; centerfreq = {center}; sample_rate = {fs}; '
        f'sample_format = "u8"; speedup_factor = 0.0; channels: ( {chans} ); }} );\n'
    )


class UdpListener:
    """Collects the datagrams sent to one local UDP port, on a thread."""

    def __init__(self, port: int):
        import socket
        import threading

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        self.sock.bind(("127.0.0.1", port))
        self.sock.settimeout(0.05)
        self.chunks: list[bytes] = []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.chunks.append(self.sock.recv(65536))
            except OSError:
                continue

    def audio(self) -> np.ndarray:
        """Stop listening (after a last drain) and return the float32 audio."""
        import time as _t

        _t.sleep(0.2)
        self._stop.set()
        self._t.join()
        self.sock.close()
        return np.frombuffer(b"".join(self.chunks), np.float32)


def tone_peak(audio: np.ndarray, rate: int) -> float:
    """The strongest frequency of ``audio`` above the lowest few bins."""
    seg = audio[-min(8192, audio.size):].astype(np.float64)
    spec = np.abs(np.fft.rfft(seg * np.hanning(seg.size)))
    return float(np.fft.rfftfreq(seg.size, 1 / rate)[np.argmax(spec[5:]) + 5])


def phase_app(card: str, workdir: str) -> dict:
    """The port's App at full width on the card (phase 8 of the module
    docstring)."""
    import os
    import resource

    import torch

    from rtlsdr_airband_tpu_torch.app import App
    from rtlsdr_airband_tpu_torch.constants import AGC_EXTRA
    from rtlsdr_airband_tpu_torch.inputs.base import InputState
    from rtlsdr_airband_tpu_torch.scripts.common import raise_fd_limit
    from rtlsdr_airband_tpu_torch.models.flagship import CENTER_FREQ, flagship_specs
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.runtime.config import load_config

    fs, wave_rate, N = 2_560_000, 16000, 512
    hop, W = fs // wave_rate, wave_rate // 8
    raise_fd_limit(C_FLAGSHIP + 256)
    log(f"app: RLIMIT_NOFILE {resource.getrlimit(resource.RLIMIT_NOFILE)}")
    freqs = [s.frequency for s in flagship_specs(C_FLAGSHIP, CENTER_FREQ, fs)]
    hot = [int(i) for i in np.linspace(0, C_FLAGSHIP - 1, APP_HOT).astype(int)]
    n_chunks = max(1, round(APP_SECONDS / 0.125 / APP_CHUNK))
    total = AGC_EXTRA * hop + n_chunks * APP_CHUNK * W * hop + (N - hop)
    want_blocks = (total - AGC_EXTRA * hop - (N - hop)) // (W * hop)
    t0 = time.perf_counter()
    iq_path = os.path.join(workdir, "app_scene.cu8")
    tones = app_scene(iq_path, freqs, hot, total, center=CENTER_FREQ, fs=fs)
    conf = os.path.join(workdir, "app.conf")
    with open(conf, "w") as fh:
        fh.write(app_config(iq_path, freqs, min(hot), center=CENTER_FREQ, fs=fs, wave_rate=wave_rate))
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = load_config(conf)
    t_parse = time.perf_counter() - t0
    # two hot channels that are not the CTCSS one (its squelch waits for a
    # tone the carriers do not carry), and a cold channel between carriers
    listen = {hot[1]: tones[1], hot[2]: tones[2]}
    cold = (hot[0] + hot[1]) // 2
    listeners = {ci: UdpListener(APP_UDP_BASE + ci) for ci in [*listen, cold]}

    t0 = time.perf_counter()
    app = App(cfg)
    rt = app.devices[0]
    p = rt.pipeline
    p.warm()
    t_build = time.perf_counter() - t0
    log(f"app: input file {os.path.getsize(iq_path)} B ({total} samples, {APP_SECONDS} s of air, "
        f"made in {t_scene:.1f} s), config {os.path.getsize(conf)} B parsed in {t_parse:.1f} s, App + warm() {t_build:.1f} s; "
        f"C={p.C} W={p.W} hop={p.hop} chunk {p.cfg.chunk_blocks} slots {p.cfg.active_slots} {p.cfg.audio_fmt} "
        f"backend {p.cfg.demod_backend} on {p.device}; hot channels {hot} (CTCSS {min(hot)}), tones {tones}")

    stamps, per_block = [], []
    spent = {"service": 0.0, "handler": 0.0}
    handle, service = app._handle_block, app._service_device

    def timed_handle(r, out):
        t = time.perf_counter()
        handle(r, out)
        now = time.perf_counter()
        spent["handler"] += now - t
        stamps.append(now)
        per_block.append((int(np.asarray(out["active"]).sum()), int(out.get("gather_overflow", 0))))

    def timed_service(r):
        t = time.perf_counter()
        worked = service(r)
        spent["service"] += time.perf_counter() - t
        return worked

    app._handle_block, app._service_device = timed_handle, timed_service
    demod_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    app.start()
    try:
        while any(r.alive for r in app.devices):
            if not app._service_once():
                time.sleep(0.002)
            if time.perf_counter() - t0 > 300:
                raise AssertionError("app: the input was not spent within 300 s")
        t_loop = time.perf_counter() - t0
    finally:
        app.stop()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = demod_cuda.LAUNCHES
    heard = {ci: lst.audio() for ci, lst in listeners.items()}

    if not (launches == p.blocks_processed == len(stamps) == want_blocks):
        raise AssertionError(f"app: K1 launches {launches}, blocks processed {p.blocks_processed}, handled {len(stamps)}, "
                             f"the file gives {want_blocks}")
    if rt.input.state != InputState.FAILED or rt.input.available_bytes() or p._inflight:
        raise AssertionError(f"app: the device did not end by its input's EOF (input {rt.input.state}, "
                             f"{rt.input.available_bytes()} B unread, {len(p._inflight)} chunks in flight)")
    overflows = p.gather_overflow_count
    if overflows:
        raise AssertionError(f"app: {overflows} slot overflows at {APP_SLOTS} slots")
    for ci, tone in listen.items():
        a = heard[ci]
        if a.size < W or not np.isfinite(a).all():
            raise AssertionError(f"app: channel {ci}'s UDP port got {a.size} samples")
        peak = tone_peak(a, wave_rate)
        if abs(peak - tone) > 25.0:
            raise AssertionError(f"app: channel {ci}'s UDP audio peaks at {peak:.1f} Hz, not at its {tone:.0f} Hz tone")
        log(f"app: channel {ci} UDP port {APP_UDP_BASE + ci}: {a.size} samples, peak {peak:.1f} Hz (tone {tone:.0f} Hz)")
    c = heard[cold]
    if c.size and float(np.abs(c).max()) > 1e-3:
        raise AssertionError(f"app: cold channel {cold} streamed audio up to {np.abs(c).max():.3e}")
    log(f"app: cold channel {cold}: {c.size} samples{' (silence)' if c.size else ''}")

    k = min(APP_CHUNK, len(stamps) // 2)  # the first chunk dropped: pipeline fill
    steady_ms = (stamps[-1] - stamps[k - 1]) / (len(stamps) - k) * 1e3
    d2h = p.fetched_bytes / p.blocks_processed
    feed_ms = (spent["service"] - spent["handler"]) / len(stamps) * 1e3
    log(f"app [{card}]: {len(stamps)} blocks, K1 launches {launches} = blocks processed = the file's {want_blocks}; "
        f"input ended by EOF; channels open a block {[a for a, _ in per_block]}; overflows {overflows}; "
        f"D2H {d2h:.0f} B a block")
    log(f"app timing [{card}]: wall a block {steady_ms:.3f} ms steady (first {k} blocks dropped), realtime factor "
        f"{(W / wave_rate) / (steady_ms / 1e3):.2f}; loop {t_loop:.3f} s, with stop() {wall:.3f} s; host a block: "
        f"Pipeline.feed {feed_ms:.3f} ms, block handler {spent['handler'] / len(stamps) * 1e3:.3f} ms")
    return dict(launches=launches, steady_ms=steady_ms, d2h=d2h, blocks=len(stamps))


def phase_cli(workdir: str) -> None:
    """The CLI as a user starts it, on a small config with a file sink, and
    --check-config on every example."""
    import glob
    import os

    from rtlsdr_airband_tpu_torch.utils.siggen import am_carrier_iq, complex_noise

    fs, wr, secs = 2_560_000, 8000, 2.0
    n = int(fs * secs)
    tone = (0.9 * np.sin(2 * np.pi * 800 * np.arange(int(wr * secs)) / wr)).astype(np.float32)
    z = am_carrier_iq(fs, 400_000, n, audio=tone, carrier_ampl=0.4, mod_index=0.8, audio_rate=wr) + complex_noise(n, 0.005, seed=7)
    u8 = np.empty(2 * n, np.uint8)
    u8[0::2] = np.clip(np.round(z.real * 127.5 + 127.5), 0, 255)
    u8[1::2] = np.clip(np.round(z.imag * 127.5 + 127.5), 0, 255)
    iq = os.path.join(workdir, "cli.cu8")
    u8.tofile(iq)
    out = os.path.join(workdir, "cli_out")
    conf = os.path.join(workdir, "cli.conf")
    with open(conf, "w") as fh:
        fh.write(f'fft_size = 512;\ndevices: ({{ type = "file"; filepath = "{iq}"; sample_format = "u8"; '
                 f'sample_rate = {fs}; centerfreq = 120.0; speedup_factor = 0.0; channels: ({{ freq = 120.4; '
                 f'outputs: ( {{ type = "file"; directory = "{out}"; filename_template = "twr"; }} ); }}); }});\n')
    cmd = [sys.executable, "-m", "rtlsdr_airband_tpu_torch"]
    examples = sorted(glob.glob("examples/*.conf"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["-F", "-e", "-c", conf, "--max-seconds", "60"], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(cmd + ["--check-config", "-c", ex], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for ex in examples]
    outs = [pr.communicate(timeout=300)[0] for pr in procs]
    for pr, o, what in zip(procs, outs, ["the run"] + examples):
        if pr.returncode != 0:
            raise AssertionError(f"cli {what}: exit {pr.returncode}\n{o[-3000:]}")
    files = sorted(os.listdir(out)) if os.path.isdir(out) else []
    sizes = [os.path.getsize(os.path.join(out, f)) for f in files]
    if len(files) != 1 or sizes[0] <= 1000:
        raise AssertionError(f"cli: audio files {dict(zip(files, sizes))}, expected one over 1000 B\n{outs[0][-3000:]}")
    log(f"cli: python3 -m rtlsdr_airband_tpu_torch -F -e -c cli.conf exit 0, wrote {files[0]} ({sizes[0]} B); "
        f"--check-config exit 0 on {', '.join(os.path.basename(e) for e in examples)}; {time.perf_counter() - t0:.1f} s")
    for e, o in zip(examples, outs[1:]):
        log(f"  {o.strip().splitlines()[-1]}")


def out_diffs(a: dict, b: dict) -> dict:
    """Per key of two block outputs: max |difference| (float) or mismatch
    count (int/bool); bit for bit where every value is 0."""
    import torch

    d = {}
    for k in a:
        x, y = a[k], b[k]
        if x.dtype.is_floating_point:
            d[k] = 0.0 if torch.equal(x.view(torch.int32), y.view(torch.int32)) else float((x - y).abs().max().item())
        else:
            d[k] = int((x != y).sum().item())
    return d


def mesh_profile(run, card: str) -> tuple[float, int, float]:
    """torch.profiler over one mesh run: (K1 device ms, K1 kernel launches,
    copy device ms), the top rows logged."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    if not rows:
        log("mesh profile: torch.profiler recorded no device time")
        return float("nan"), 0, float("nan")
    rows.sort(key=lambda r: -r[1])
    k1 = [(ms, n) for key, ms, n in rows if "demod_kernel" in key]
    copies = sum(ms for key, ms, _ in rows if key.startswith("Memcpy"))
    log(f"mesh profile of {K_BLOCKS} blocks [{card}]: K1 {sum(m for m, _ in k1):.3f} ms in {sum(n for _, n in k1)} launches, "
        f"copies {copies:.3f} ms; by kernel:")
    for key, ms, n in rows[:10]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {key[:110]}")
    return sum(m for m, _ in k1), sum(n for _, n in k1), copies


def mesh_block_program(devices, card: str, timed: bool) -> dict:
    """Phase 9 (1): the flagship block program through a mesh of
    ``devices``, 8 distinct blocks with the state threaded, against the
    single-device program on the same blocks."""
    import torch

    from rtlsdr_airband_tpu_torch.interop import state_to_numpy
    from rtlsdr_airband_tpu_torch.models.flagship import build_flagship
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.parallel import sharding
    from rtlsdr_airband_tpu_torch.runtime.pipeline import pipeline_block
    from rtlsdr_airband_tpu_torch.scripts.bench_scaling import kernel_ms

    device = torch.device(devices[0])
    block, x, state0 = build_flagship(n_channels=C_FLAGSHIP, wave_rate=16000, device=device)
    kw = block.block_kwargs
    W, hop, N = kw["n_frames"], kw["hop"], kw["fft_size"]
    rng = np.random.default_rng(7)
    noise = torch.as_tensor(rng.normal(0, 0.01, (K_BLOCKS,) + tuple(x.shape)).astype(np.float32), device=device)
    xs = [x + noise[k] for k in range(K_BLOCKS)]  # phase 5's K distinct blocks
    mesh = sharding.make_pipeline_mesh(devices, time_shards=2 if len(devices) >= 4 else 1)
    layout = sharding.channel_layout(mesh, C_FLAGSHIP)
    cells = sharding.replicate(mesh, (block.bins, block.window, (block.taps_re, block.taps_im)))
    bins, window, taps = ([c[i] for c in cells] for i in range(3))
    params = sharding.shard_last(mesh, block.params)
    st0 = sharding.shard_last(mesh, state0)

    def run_mesh(outs=None, states=None):
        st = st0
        for xb in xs:
            if states is not None:
                states.append(st)
            st, out = pipeline_block(sharding.split_block(mesh, xb, hop=hop, n_frames=W), bins, window, params, st,
                                     taps=taps, inv_perm=block.inv_perm, mesh=mesh, **kw)
            if outs is not None:
                outs.append((st, out))
        return st

    def run_single(outs=None):
        st = state0
        for xb in xs:
            st, out = block(xb, st)
            if outs is not None:
                outs.append((st, out))
        return st

    single, meshed, states_in = [], [], []
    run_single(single)
    demod_cuda.LAUNCHES = 0
    run_mesh(meshed, states_in)
    for d in set(mesh.cells):
        torch.cuda.synchronize(d)
    launches = demod_cuda.LAUNCHES
    if launches != len(layout) * K_BLOCKS:
        raise AssertionError(f"mesh: K1 launched {launches} times for {K_BLOCKS} blocks over {len(layout)} channel shards")
    widths = sorted({sl.stop - sl.start for _, sl in layout})
    worst, flips, int_bad, bitwise = {}, 0, 0, True
    for k, ((st_s, out_s), (st_m, out_m)) in enumerate(zip(single, meshed)):
        if not all(bool(torch.isfinite(out_m[key]).all()) for key in ("audio", "signal_level", "noise_level", "squelch_level")):
            raise AssertionError(f"mesh block {k}: outputs not finite")
        d = out_diffs(out_s, out_m)
        sd = state_diffs(sharding.gather_last(mesh, st_m), st_s)
        for key, v in list(d.items()) + [(f"state.{n}", v) for n, v in sd.items()]:
            worst[key] = max(worst.get(key, 0), v)
        flips += d["open_flags"]
        int_bad += sum(v for v in sd.values() if isinstance(v, int)) + sum(v for k2, v in d.items() if isinstance(v, int))
        a, b = state_to_numpy(sharding.gather_last(mesh, st_m)), state_to_numpy(st_s)
        bitwise &= all(v == 0 for v in d.values()) and all(a[n].tobytes() == b[n].tobytes() for n in a)
    floats = {k: v for k, v in worst.items() if isinstance(v, float) and v}
    log(f"mesh {mesh.shape} over {[str(c) for c in mesh.cells]} [{card}]: {K_BLOCKS} blocks, K1 launches {launches} = "
        f"{len(layout)} a block at {widths} channels; against one device: bit for bit {bitwise}"
        + ("" if bitwise else f" (H12: flags differing {flips}, int/bool values differing {int_bad}, worst float {floats})"))
    if not bitwise:
        # H12: the card's GEMMs may round otherwise at M = W/T rows; then
        # the ROADMAP parity bars hold, flags and int/bool state exact
        bad = {k: v for k, v in worst.items() if (isinstance(v, int) and v) or (isinstance(v, float) and v > 1e-4)}
        if bad:
            raise AssertionError(f"mesh against one device beyond the parity bars: {bad}")
    r = dict(launches=launches, bitwise=bitwise, widths=widths, shards=len(layout))
    if not timed:
        return r
    mesh_ms = time_ms(run_mesh, reps=3) / K_BLOCKS
    single_ms = time_ms(run_single, reps=3) / K_BLOCKS
    halo = N - hop
    body, tail = sharding.split_block(mesh, xs[0], hop=hop, n_frames=W)

    def halo_once():
        with mesh.scope():
            mesh.transport.halo(mesh, [(body[1][:halo], mesh.time_cell(1), mesh.time_cell(0), (halo, 2), torch.float32)])

    with mesh.scope():
        rows = sharding.time_sharded_rows(mesh, body, tail, bins, window, hop=hop, fft_size=N, n_frames=W, taps=taps)

    def reshard_once():
        with mesh.scope():
            sharding.reshard_rows(mesh, rows, layout, W)

    halo_ms = time_ms(halo_once, reps=10) if mesh.shape["time"] > 1 else float("nan")
    reshard_ms = time_ms(reshard_once, reps=10)
    with mesh.scope():
        shards = sharding.reshard_rows(mesh, rows, layout, W)
    for d in set(mesh.cells):
        torch.cuda.synchronize(d)
    shard_ms = []
    for j, (cell, _) in enumerate(layout):
        with torch.cuda.device(mesh.device(cell)):  # K1 alone, on the shard's own GPU
            shard_ms.append(kernel_ms(params[j], states_in[0][j], *shards[j], reps=3)[0])
    bound_ms, bound_by, how = demod_bound(params[0], states_in[0][0], shards[0][0])
    k1_total, k1_n, copy_ms = mesh_profile(run_mesh, card)
    log(f"mesh timing [{card}]: block {mesh_ms:.3f} ms through the mesh against {single_ms:.3f} ms on one device "
        f"(x{mesh_ms / single_ms:.2f}); K1 alone at {widths[0]} channels, per shard (ms): "
        f"{' '.join(f'{v:.4f}' for v in shard_ms)}, bound {bound_ms:.4f} ms ({bound_by}: {how}); profile: K1 "
        f"{k1_total / max(1, k1_n):.4f} ms a launch over {k1_n} launches, copies {copy_ms / K_BLOCKS:.4f} ms a block; "
        f"halo exchange {halo_ms:.4f} ms, reshard {reshard_ms:.4f} ms (CUDA events, one block)")
    r.update(mesh_ms=mesh_ms, single_ms=single_ms, shard_ms=sum(shard_ms) / len(shard_ms), shard_bound_ms=bound_ms, halo_ms=halo_ms,
             reshard_ms=reshard_ms, copy_ms=copy_ms / K_BLOCKS, k1_profile_ms=k1_total / max(1, k1_n))
    return r


def mesh_stream(device, card: str) -> dict:
    """Phase 9 (2): phase 7's streaming scene and production settings
    through a [card] * 4 mesh, against the single-device Pipeline."""
    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import CENTER_FREQ, flagship_specs
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.parallel.sharding import make_pipeline_mesh
    from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig

    specs = flagship_specs(C_FLAGSHIP)
    raw = stream_bytes(specs, STREAM_BLOCKS, seed=11)
    prod = dict(sample_rate=2_560_000, center_freq=CENTER_FREQ, fft_size=512, wave_rate=16000, sample_format="u8",
                fullscale=127.5, chunk_blocks=8, async_depth=1, active_slots=STREAM_SLOTS, fetch_audio_fmt="i8bf",
                suppress_fade_tails=True, fetch_meta_per_chunk=True)
    mesh = make_pipeline_mesh([device] * 4)
    runs = {}
    for name, m in (("single", None), ("mesh", mesh)):
        p = Pipeline(PipelineConfig(**prod, mesh=m), specs)
        p.warm()
        blocks = []
        demod_cuda.LAUNCHES = 0
        n, _ = stream(p, raw, lambda o: blocks.append({k: np.array(v) for k, v in o.items()}))
        launches = demod_cuda.LAUNCHES
        walls = []
        for _ in range(2):
            q = Pipeline(PipelineConfig(**prod, mesh=m), specs)
            q.warm()
            n_t, wall = stream(q, raw)
            walls.append(wall / n_t * 1e3)
        runs[name] = dict(blocks=blocks, launches=launches, n=n, d2h=p.fetched_bytes / p.blocks_processed, wall_ms=min(walls),
                          overflows=p.gather_overflow_count)
    s, m = runs["single"], runs["mesh"]
    if not (m["n"] == s["n"] == STREAM_BLOCKS and m["launches"] == 4 * STREAM_BLOCKS and s["launches"] == STREAM_BLOCKS):
        raise AssertionError(f"mesh stream: {m['n']} / {s['n']} blocks, K1 launches {m['launches']} / {s['launches']}")
    same = all(a.keys() == b.keys() and all(a[k].tobytes() == b[k].tobytes() for k in a) for a, b in zip(s["blocks"], m["blocks"]))
    audio_diff = max(float(np.abs(a["audio"] - b["audio"]).max()) for a, b in zip(s["blocks"], m["blocks"]))
    active_same = all(np.array_equal(a["active"], b["active"]) for a, b in zip(s["blocks"], m["blocks"]))
    log(f"mesh stream [{card}]: {m['n']} blocks at production settings over {mesh.shape} on one card, K1 launches "
        f"{m['launches']} (4 a block); every key against one device bit for bit {same} (audio max |diff| {audio_diff:.3e}, "
        f"active equal {active_same}); D2H {m['d2h']:.0f} B a block (one device {s['d2h']:.0f}); overflows {m['overflows']} "
        f"({s['overflows']}); wall a block {m['wall_ms']:.3f} ms (one device {s['wall_ms']:.3f} ms)")
    if m["d2h"] != s["d2h"] or not active_same or (not same and audio_diff > 1e-4):
        raise AssertionError("mesh stream: D2H bytes, active or audio beyond the parity bars against one device")
    return dict(launches=m["launches"], same=same, wall_ms=m["wall_ms"], single_wall_ms=s["wall_ms"], d2h=m["d2h"])


def app_digests(conf_text: str, workdir: str, name: str) -> tuple[list, int]:
    """An App run to the input's end: per handled block (audio digest,
    active digest), and the K1 launches."""
    import hashlib
    import os

    from rtlsdr_airband_tpu_torch.app import App
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.runtime.config import load_config

    path = os.path.join(workdir, f"{name}.conf")
    with open(path, "w") as fh:
        fh.write(conf_text)
    app = App(load_config(path))
    app.devices[0].pipeline.warm()
    got = []
    handle = app._handle_block

    def record(r, out):
        got.append((hashlib.sha1(np.ascontiguousarray(out["audio"]).tobytes()).hexdigest(),
                    hashlib.sha1(np.asarray(out["active"]).tobytes()).hexdigest()))
        handle(r, out)

    app._handle_block = record
    demod_cuda.LAUNCHES = 0
    app.start()
    try:
        t0 = time.perf_counter()
        while any(r.alive for r in app.devices) and time.perf_counter() - t0 < 300:
            if not app._service_once():
                time.sleep(0.002)
    finally:
        app.stop()
    return got, demod_cuda.LAUNCHES


def mesh_multi_gpu(card: str, workdir: str) -> dict:
    """Phase 9 (3), with two or more GPUs: the block program over distinct
    GPUs, the phase-8 App with mesh_devices = min(4, count) against the
    single-GPU App, and a 2-rank NCCL run of the multi-process runner on the
    phase-8 file against a 1-rank run."""
    import glob
    import os

    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import CENTER_FREQ, flagship_specs

    n = min(4, torch.cuda.device_count())
    r = mesh_block_program([torch.device("cuda", i) for i in range(n)], card, timed=False)
    conf = open(os.path.join(workdir, "app.conf")).read()
    single, l1 = app_digests(conf, workdir, "app_single")
    meshed, ln = app_digests(f"mesh_devices = {n};\n" + conf, workdir, "app_mesh")
    same = single == meshed
    log(f"mesh App over {n} GPUs [{card}]: {len(meshed)} blocks, K1 launches {ln} (single GPU {l1}); audio and active "
        f"equal the single-GPU App's block for block: {same}")
    if not same or len(single) == 0:
        raise AssertionError("mesh App differs from the single-GPU App")
    # the runner on the phase-8 file, 64 channels around the hot ones (it writes a WAV a channel)
    fs, wr = 2_560_000, 16000
    freqs = [sp.frequency for sp in flagship_specs(C_FLAGSHIP, CENTER_FREQ, fs)]
    hot = [int(i) for i in np.linspace(0, C_FLAGSHIP - 1, APP_HOT).astype(int)]
    keep = sorted({min(C_FLAGSHIP - 1, max(0, h + d)) for h in hot for d in range(-8, 8)})
    sub = os.path.join(workdir, "multihost.conf")
    with open(sub, "w") as fh:
        fh.write(app_config(os.path.join(workdir, "app_scene.cu8"), [freqs[i] for i in keep], -1, center=CENTER_FREQ, fs=fs,
                            wave_rate=wr))
    import socket

    def runner(nproc, outdir):
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            port = s_.getsockname()[1]
        cmd = [sys.executable, "-m", "rtlsdr_airband_tpu_torch.scripts.run_multihost", "--coordinator", f"127.0.0.1:{port}",
               "--nproc", str(nproc), "-c", sub, "--device", "cuda", "--chunk", "4"]
        procs = [subprocess.Popen(cmd + ["--pid", str(i), "--outdir", os.path.join(workdir, f"{outdir}{i}")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(nproc)]
        outs = []
        try:
            outs = [pr.communicate(timeout=300)[0] for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
        for pr, o in zip(procs, outs):
            if pr.returncode != 0:
                raise AssertionError(f"run_multihost ({nproc} rank(s)): exit {pr.returncode}\n{o[-3000:]}")
        return {os.path.basename(f): open(f, "rb").read() for i in range(nproc) for f in glob.glob(os.path.join(workdir, f"{outdir}{i}", "*.wav"))}

    t0 = time.perf_counter()
    one, two = runner(1, "mh1_"), runner(2, "mh2_")
    same_wav = one.keys() == two.keys() and all(one[k] == two[k] for k in one)
    log(f"run_multihost [{card}]: 2 NCCL ranks wrote {len(two)} WAVs, equal byte for byte to 1 rank's {len(one)}: "
        f"{same_wav} ({time.perf_counter() - t0:.1f} s)")
    if not same_wav or len(one) != len(keep):
        raise AssertionError("run_multihost: the 2-rank WAVs differ from the 1-rank run's")
    return dict(r, app_launches=ln)


def run_driver(name: str, main_fn, env: dict | None = None) -> tuple[list[dict], int]:
    """One driver's ``main()`` in this process with ``env`` set for the call
    and K1's launch counter at 0 just before it: its standard output echoed
    (each line prefixed with the driver's name), a non-zero exit fatal.
    Returns the JSON objects it printed and the K1 launches it made."""
    import contextlib
    import io
    import os

    from rtlsdr_airband_tpu_torch.ops import demod_cuda

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    buf = io.StringIO()
    t0 = time.perf_counter()
    demod_cuda.LAUNCHES = 0
    try:
        with contextlib.redirect_stdout(buf):
            rc = main_fn()
    finally:
        launches = demod_cuda.LAUNCHES
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"{name}: {line}")
    log(f"{name}: exit {rc}, K1 launches {launches}, {time.perf_counter() - t0:.1f} s")
    if rc != 0:
        raise AssertionError(f"{name}: exit {rc}")
    return [json.loads(x) for x in lines if x.startswith("{")], launches


def phase_drivers(device, card: str, t: dict, workdir: str) -> dict:
    """Phase 10: each driver of the port at full width through its main(),
    in this process, on the card."""
    import os

    import torch

    from rtlsdr_airband_tpu_torch import entry
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.scripts import bench, bench_app, bench_scaling, e2e_snr, soak, squelch_trace

    launches = {}
    # (1) bench.py: the flagship, K = 16 blocks, 3 reps, wall / K
    (b,), launches["bench"] = run_driver("bench", bench.main, dict(BENCH_CHANNELS=str(C_FLAGSHIP), BENCH_BLOCKS="16", BENCH_REPS="3"))
    if b["detail"]["demod_backend"] != "cuda" or launches["bench"] != 16 * 4:
        raise AssertionError(f"bench: backend {b['detail']['demod_backend']}, K1 launches {launches['bench']} (expected 64)")
    log(f"bench [{card}]: block_ms {b['detail']['block_ms']:.4f} (host clock, wall / K of 16 blocks) beside phase 5's "
        f"{t['block_ms']:.4f} (CUDA events, 8 blocks); {b['value']:.1f} channel-Msps, realtime factor {b['detail']['realtime_factor']:.2f}")

    # (2) the channel sweep: block_ms and K1 alone a point
    counts = list(SWEEP_COUNTS)
    sweep, launches["bench_scaling"] = run_driver("bench_scaling", lambda: bench_scaling.main(["--channels", ",".join(map(str, counts))]))
    if [p["n_channels"] for p in sweep] != counts or not all(p["k1_ms"] > 0 and p["backend"] == "cuda" for p in sweep):
        raise AssertionError(f"bench_scaling: points {[p['n_channels'] for p in sweep]}")
    for p in sweep:
        log(f"sweep [{card}]: C={p['n_channels']} block_ms {p['block_ms']:.4f} K1 {p['k1_ms']:.4f} ms (wrapper {p['demod_ms']:.4f}) "
            f"channel-Msps {p['channel_msps']:.1f} realtime {p['realtime_factor']:.2f}")

    # (3) e2e_snr with K1 and with the plain version, on the same scene
    audio = {}
    demod_audio = e2e_snr.demod_audio

    def keep(mags, iqs, backend, dev):
        audio[backend] = demod_audio(mags, iqs, backend, dev)
        return audio[backend]

    e2e_snr.demod_audio = keep
    try:
        (e_k1,), launches["e2e_snr"] = run_driver("e2e_snr", lambda: e2e_snr.main(["--backend", "cuda"]))
        (e_plain,), plain_launches = run_driver("e2e_snr plain", lambda: e2e_snr.main(["--backend", "plain"]))
    finally:
        e2e_snr.demod_audio = demod_audio
    for e in (e_k1, e_plain):
        worst = e["worst_snr_db"]
        if not e["squelch_gating_identical"] or not (worst == "inf" or worst >= 80.0):
            raise AssertionError(f"e2e_snr {e['backend']}: gating identical {e['squelch_gating_identical']}, worst {worst} dB")
    if audio["cuda"].tobytes() != audio["plain"].tobytes() or plain_launches or not launches["e2e_snr"]:
        raise AssertionError(f"e2e_snr: K1's audio is not the plain version's bit for bit "
                             f"(max |diff| {np.abs(audio['cuda'] - audio['plain']).max():.3e}), launches {launches['e2e_snr']} / {plain_launches}")
    log(f"e2e_snr [{card}]: K1 and plain: worst SNR {e_k1['worst_snr_db']} / {e_plain['worst_snr_db']} dB, gating identical to "
        f"the refmodel, K1's audio equal to the plain version's bit for bit over {e_k1['samples_compared']} samples")

    # (4) squelch_trace --synth: the traced plain demod on the card, then K1
    # on the same channelizer outputs (comparison launches, not counted)
    npz = os.path.join(workdir, "trace.npz")
    secs = 1.0
    _, launches["squelch_trace"] = run_driver("squelch_trace", lambda: squelch_trace.main(["--synth", "--seconds", str(secs), npz]))
    tr = np.load(npz)
    params, st, blocks = squelch_trace.channelized(squelch_trace.synth_scene(2_560_000, 400_000.0, secs, 8000), freq=120.4e6,
                                                   center=120.0e6, fs=2_560_000, modulation="am", device=device)
    before = demod_cuda.LAUNCHES
    k1_audio, k1_open = [], []
    for mags, iqs in blocks:
        st, a, _iq, o = demod_cuda.demod_block_cuda(params, st, mags, iqs)
        k1_audio.append(a[:, 0].cpu().numpy())
        k1_open.append(o[:, 0].cpu().numpy())
    demod_cuda.LAUNCHES = before
    k1_audio, k1_open = np.concatenate(k1_audio), np.concatenate(k1_open)
    if k1_audio.tobytes() != tr["audio"].tobytes() or not np.array_equal(k1_open, tr["open"]) or not tr["open"].any():
        raise AssertionError(f"squelch_trace: the traced plain run differs from K1 (audio max |diff| "
                             f"{np.abs(k1_audio - tr['audio']).max():.3e}, open flags differing {int((k1_open != tr['open']).sum())})")
    log(f"squelch_trace [{card}]: {tr['cur'].size} samples, {len(tr.files)} series, open {int(tr['open'].sum())} samples; the "
        f"traced plain audio and open flags equal K1's bit for bit")

    # (5) entry(): fn(*example_args) once against phase 5's block program on
    # its un-noised input and initial state (phase 5's blocks add noise)
    fn, (x, state) = entry.entry()
    demod_cuda.LAUNCHES = 0
    st_e, out_e = fn(x, state)
    torch.cuda.synchronize()
    launches["entry"] = demod_cuda.LAUNCHES
    block5, x5, state5 = t["flagship"]
    st_5, out_5 = block5(x5, state5)
    if x.cpu().numpy().tobytes() != x5.cpu().numpy().tobytes() or launches["entry"] != 1:
        raise AssertionError(f"entry: the example input is not phase 5's, or K1 launched {launches['entry']} times")
    if not same_bits((st_e, out_e["audio"]), (st_5, out_5["audio"])) or any(v for v in out_diffs(out_5, out_e).values()):
        raise AssertionError(f"entry: fn(*example_args) differs from phase 5's first block: {out_diffs(out_5, out_e)}")
    log(f"entry [{card}]: fn(*example_args) at {x.shape[0]} samples x {C_FLAGSHIP} channels, K1 launches 1; audio, every output "
        f"and the state equal phase 5's block program on the same input bit for bit")

    # (6) bench_app at 8192 channels over 8 s of air, unpaced (phase 8's settings)
    env = dict(BENCH_APP_CHANNELS=str(C_FLAGSHIP), BENCH_APP_SECONDS="8", BENCH_APP_HOT=str(APP_HOT), BENCH_APP_BLOCKS_PER_DISPATCH=str(APP_CHUNK),
               BENCH_APP_ACTIVE_SLOTS=str(APP_SLOTS), BENCH_APP_FMT="i8bf", BENCH_APP_SUPPRESS="1", BENCH_APP_METAPC="1")
    (ba,), launches["bench_app"] = run_driver("bench_app", bench_app.main, env)
    d = ba["detail"]
    if d["blocks"] != d["blocks_expected"] or d["gather_overflows"] or launches["bench_app"] != d["blocks"] + APP_CHUNK:
        raise AssertionError(f"bench_app: blocks {d['blocks']} of {d['blocks_expected']}, overflows {d['gather_overflows']}, "
                             f"K1 launches {launches['bench_app']}")
    log(f"bench_app [{card}]: {ba['value']:.3f} ms a block, realtime factor {ba['vs_baseline']:.2f}, {d['channels_opened']} channels "
        f"opened, D2H {d['d2h_bytes_per_block']:.0f} B a block")

    # (7) soak at SOAK_CHANNELS, paced at real time
    env = dict(SOAK_CHANNELS=str(SOAK_CHANNELS), SOAK_MINUTES=os.environ.get("SOAK_MINUTES", "1"), SOAK_SAMPLE_S="5", SOAK_SCENE_SECONDS="10")
    soak_json = os.path.join(workdir, "soak.json")
    (sk,), launches["soak"] = run_driver("soak", lambda: soak.main(["--out", soak_json]), env)
    with open(soak_json) as fh:
        samples = json.load(fh)["samples"]
    for sm in samples:
        log(f"soak sample: t {sm['t']:.1f} s rss {sm['rss_mb']:.1f} MB threads {sm['threads']} fds {sm['fds']} blocks {sm['blocks']} "
            f"cuda reserved {sm['cuda_reserved_mb']} MB allocated {sm['cuda_allocated_mb']} MB")
    log(f"soak [{card}]: {sk['minutes']:.2f} min, {sk['blocks_handled']} blocks, RSS {sk['rss_mb_start']:.1f} -> {sk['rss_mb_end']:.1f} MB, "
        f"threads {sk['thread_drift']:+d}, fds {sk['fd_drift']:+d}, checks {sk['checks']}")
    if not launches["soak"]:
        raise AssertionError("soak: K1 was not launched")
    log(f"drivers: K1 launches {launches} ({sum(launches.values())} in all)")
    return dict(launches=sum(launches.values()), per_driver=launches, bench_block_ms=b["detail"]["block_ms"], sweep=sweep)


def phase_schedules(device, card: str, scene: dict, t: dict, builds: dict) -> dict:
    """Phase 11: K1's schedules against the plain version and the default,
    the pair schedule through the stream by its environment variable, and
    the three drivers that measure the schedules and the channelizer's
    precision."""
    import os

    import torch

    from rtlsdr_airband_tpu_torch.models.flagship import CENTER_FREQ, flagship_specs
    from rtlsdr_airband_tpu_torch.ops import demod_cuda
    from rtlsdr_airband_tpu_torch.runtime.pipeline import Pipeline, PipelineConfig
    from rtlsdr_airband_tpu_torch.scripts import bench_bf16, bench_pair, bench_unroll

    t_phase = time.perf_counter()
    # ---- (a) every schedule on phase 3's scene, bit for bit ----
    params = scene["params"]
    for unroll, pair in SCHEDULES:
        name = demod_cuda.schedule_name(unroll, pair)
        for k, (st, mags, iqs, kout, pout) in enumerate(scene["blocks"]):
            got = demod_cuda.demod_block_cuda(params, st, mags, iqs, with_iq=True, unroll=unroll, pair=pair)
            if device.type == "cuda":
                torch.cuda.synchronize()
            if not (same_bits(got, pout) and same_bits(got, kout)):
                raise AssertionError(f"schedules (a): {name} on parity block {k}: equal to the plain version "
                                     f"{same_bits(got, pout)}, to the default {same_bits(got, kout)}")
    log(f"schedules (a) [{card}]: {', '.join(demod_cuda.schedule_name(u, p) for u, p in SCHEDULES)} on the {C_FLAGSHIP}-channel "
        f"parity scene ({len(scene['blocks'])} blocks of {scene['blocks'][0][1].shape[0]} samples, CTCSS banks on): audio, IQ, "
        f"flags and every state leaf equal the plain version's and the default schedule's bit for bit")

    # ---- (b) the stream with RTLSDR_DEMOD_PAIR=1 against the stream without ----
    specs = flagship_specs(C_FLAGSHIP)
    raw = stream_bytes(specs, PAIR_STREAM_BLOCKS, seed=11)
    cfg = PipelineConfig(sample_rate=2_560_000, center_freq=CENTER_FREQ, fft_size=512, wave_rate=16000, sample_format="u8",
                         fullscale=127.5, chunk_blocks=PAIR_STREAM_BLOCKS, async_depth=1)
    saved = os.environ.get(demod_cuda.PAIR_ENV)
    runs = {}
    try:
        for env in ("0", "1"):
            os.environ[demod_cuda.PAIR_ENV] = env
            p = Pipeline(cfg, specs)
            p.warm()
            demod_cuda.SCHEDULE_LAUNCHES.clear()
            outs = []
            n, wall = stream(p, raw, lambda o: outs.append({key: np.array(v) for key, v in o.items()}))
            runs[env] = (outs, dict(demod_cuda.SCHEDULE_LAUNCHES), wall / n * 1e3)
    finally:
        if saved is None:
            os.environ.pop(demod_cuda.PAIR_ENV, None)
        else:
            os.environ[demod_cuda.PAIR_ENV] = saved
    (ref, ref_counts, ref_ms), (got, pair_counts, pair_ms) = runs["0"], runs["1"]
    bad = [(k, key) for k, (r, g) in enumerate(zip(ref, got)) for key in r
           if key not in g or r[key].dtype != g[key].dtype or r[key].tobytes() != g[key].tobytes()]
    if len(ref) != PAIR_STREAM_BLOCKS or len(got) != len(ref) or bad:
        raise AssertionError(f"schedules (b): {len(got)} / {len(ref)} blocks, differing (block, key) {bad[:8]}")
    if pair_counts != {"pair_u1": PAIR_STREAM_BLOCKS} or ref_counts != {"single_u1": PAIR_STREAM_BLOCKS}:
        raise AssertionError(f"schedules (b): schedules run {pair_counts} with {demod_cuda.PAIR_ENV}=1, {ref_counts} without")
    log(f"schedules (b) [{card}]: the streaming flagship ({C_FLAGSHIP} channels, {len(ref)} blocks, dense f32) with "
        f"{demod_cuda.PAIR_ENV}=1 ran {pair_counts}, without it {ref_counts}; every key ({sorted(ref[0])}) of every block "
        f"equal bit for bit; wall a block {pair_ms:.3f} against {ref_ms:.3f} ms (one run each, warm)")

    # ---- (c) the drivers ----
    drivers = {}
    for C in SCHEDULE_COUNTS:
        env = dict(BENCH_PAIR_CHANNELS=str(C), BENCH_PAIR_K=str(K_BLOCKS))
        (bp,), _ = run_driver(f"bench_pair {C}", bench_pair.main, env)
        if not bp["parity"]["bit_for_bit"] or not bp["parity"]["timed_blocks_bit_for_bit"] or bp["schedule"] != "pair_u1":
            raise AssertionError(f"bench_pair at {C}: parity {bp['parity']}, schedule {bp['schedule']}")
        lines, _ = run_driver(f"bench_unroll {C}", bench_unroll.main, dict(BENCH_CHANNELS=str(C)))
        if [x["unroll"] for x in lines] != [1, 2, 4] or not all(x["equal_to_default_bit_for_bit"] for x in lines):
            raise AssertionError(f"bench_unroll at {C}: {lines}")
        drivers[C] = dict(pair=bp, unroll={x["schedule"]: x for x in lines})
        log(f"schedules (c) [{card}] at {C} channels: K1 a block single_u1 {bp['ms_single']:.4f}, pair_u1 {bp['ms_pair']:.4f} ms "
            f"(speedup {bp['speedup']:.3f}); unroll " + ", ".join(f"{x['unroll']}: {x['demod_ms_per_block']:.4f} ms "
                                                                  f"({x['us_per_step']:.4f} us a step)" for x in lines))
    precisions, _ = run_driver("bench_bf16", bench_bf16.main, dict(BENCH_CHANNELS=str(C_FLAGSHIP)))
    prec = {x["mode"]: x for x in precisions}
    if list(prec) != list(bench_bf16.MODES) or not prec["highest"]["passes_gate"]:
        raise AssertionError(f"bench_bf16: modes {list(prec)}, highest {prec.get('highest')}")
    log(f"schedules (c) [{card}] channelizer precisions at {C_FLAGSHIP} channels: " + "; ".join(
        f"{m} {x['chan_ms']:.4f} ms {x['snr_db']:.2f} dB ({'clears' if x['passes_gate'] else 'below'} 80 dB)" for m, x in prec.items()))

    # ---- (d) per schedule, what the kernels line carries ----
    per = {}
    for name, b in builds.items():
        per[name] = dict(b, ms=t["k1_ms"] if name == "single_u1" else t["schedule_ms"][name],
                         no_ctcss_ms=t["k1_no_ctcss_ms"] if name == "single_u1" else t["schedule_no_ctcss_ms"][name],
                         stream_launches=pair_counts.get(name, 0) + ref_counts.get(name, 0), bit_for_bit=True,
                         driver_ms={str(C): (d["unroll"][name]["demod_ms_per_block"] if name in d["unroll"] else
                                             d["pair"]["ms_pair"] if name == "pair_u1" else None) for C, d in drivers.items()})
    log(f"schedules: phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return dict(schedules=per, precisions=prec, pair_stream_launches=pair_counts.get("pair_u1", 0))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from rtlsdr_airband_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = smi("name,power.limit")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = _build.build_kernels()
    for src, b in built.items():
        log(f"build {src}: {b.seconds:.1f} s -> {b.path.name}")
        for fn, lines in ptxas_summary(b.log).items():
            log(f"  ptxas {fn}: {' | '.join(lines)}")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    step_instructions, k1_builds = phase_k1_build(built)
    # K2's chains must survive the compiler: 2 * L dependent FMUL/FADD a
    # trip (times the W loop's unroll) and no FFMA under --fmad=false
    for fn, n in sass_ops(built["chain_probe.cu"].path).items():
        log(f"sass {fn[-40:]}: {n}")
    log(f"build total: {time.perf_counter() - t0:.1f} s")

    err, scene = phase_parity(device)
    phase_snr(device)
    t = phase_main_path(device, card, clock_mhz, step_instructions)
    p = phase_probe(device, card, t, clock_mhz)
    s = phase_stream(device, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        a = phase_app(card, workdir)
        phase_cli(workdir)
        mb = mesh_block_program([device] * 4, card, timed=True)
        ms = mesh_stream(device, card)
        if torch.cuda.device_count() >= 2:
            mg = mesh_multi_gpu(card, workdir)
        else:
            mg = dict(launches=0, app_launches=0)
            log(f"mesh over distinct GPUs, the App with mesh_devices > 1 and the 2-rank NCCL run of run_multihost: not run, "
                f"this machine has {torch.cuda.device_count()} GPU and NCCL refuses two ranks on one GPU (App refuses to "
                f"repeat a GPU in its mesh)")
        dr = phase_drivers(device, card, t, workdir)
    sc = phase_schedules(device, card, scene, t, k1_builds)
    mesh_launches = mb["launches"] + ms["launches"] + mg["launches"] + mg["app_launches"]

    log(f"kernels: K1 demod (csrc/demod.cu) launches {t['launches']} on the main path, {s['launches']} on the "
        f"streaming path and {a['launches']} in the App, parity ok "
        f"(audio {err['audio']:.3e}, iq {err['iq']:.3e}, flags exact, int/bool state exact, bit for bit: {err['bitwise']}); "
        f"K2 chain_probe (csrc/chain_probe.cu) launches {p['launches']} equal bit for bit in chain1, chain2, chain1w "
        f"(max |diff| {p['err']}), latency bound {p['latency_bound_ms']:.6f} ms; K1 on the mesh: {mesh_launches} launches "
        f"({mb['shards']} a block at {mb['widths']} channels), {mb['shard_ms']:.4f} ms at {mb['widths'][0]} channels (mean of the shards); "
        f"K1 in the drivers: {dr['launches']} launches; K1's pair schedule {sc['pair_stream_launches']} launches on the "
        f"stream with {PAIR_STREAM_BLOCKS} blocks, every schedule bit for bit; fade-tail (csrc/fade_tail.cu) launches "
        f"{t['fade_launches']} on the main path, bit for bit against the plain assembly, " + ", ".join(
            f"{f['ms']:.4f} ms alone at {C} channels (plain {f['plain_ms']:.4f}, bound {f['bound_ms']:.4f})" for C, f in t["fade"].items())
        + f"; CTCSS pass (csrc/demod_ctcss.cu) launches {t['ctcss_launches']} on the main path, " + ", ".join(
            f"{v['pass_ms']:.4f} ms alone in {k} (bound {v['pass_bound_ms']:.4f})" for k, v in t["ctcss_split"].items() if v["pass_ms"] is not None))
    log(json.dumps({"kernels": [{
        "name": "demod",
        "route": "cuda",
        "source": "rtlsdr_airband_tpu_torch/csrc/demod.cu",
        "replaces": "rtlsdr_airband_tpu/ops/demod_pallas.py:848",
        "launches": t["launches"] + s["launches"] + a["launches"] + mesh_launches + dr["launches"],
        "mesh_launches": mesh_launches,
        "driver_launches": dr["launches"],
        "sweep_k1_ms": {str(p["n_channels"]): p["k1_ms"] for p in dr["sweep"]},
        "max_abs_err": err["audio"],
        "ms": t["k1_ms"],
        "mesh_shard_ms": mb["shard_ms"],
        "mesh_shard_channels": mb["widths"][0],
        "mesh_shard_bound_ms": mb["shard_bound_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "latency_bound_ms": t["issue_bound_ms"],
        "library_ms": None,
        "schedules": sc["schedules"],
        "ctcss_split": t["ctcss_split"],
    }, {
        "name": "chain_probe",
        "route": "cuda",
        "source": "rtlsdr_airband_tpu_torch/csrc/chain_probe.cu",
        "replaces": "scripts/bench_chain_probe.py:91",
        "launches": p["launches"],
        "max_abs_err": p["err"],
        "ms": p["ms"],
        "plain_ms": p["plain_ms"],
        "bound_ms": p["bound_ms"],
        "bound_by": p["bound_by"],
        "latency_bound_ms": p["latency_bound_ms"],
        "library_ms": None,
    }, {
        "name": "fade_tail",
        "route": "cuda",
        "source": "rtlsdr_airband_tpu_torch/csrc/fade_tail.cu",
        "replaces": "rtlsdr_airband_tpu/ops/demod.py:479 (XLA, no Pallas kernel)",
        "launches": t["fade_launches"],
        "max_abs_err": 0.0,
        "ms": t["fade"][C_FLAGSHIP]["ms"],
        "plain_ms": t["fade"][C_FLAGSHIP]["plain_ms"],
        "bound_ms": t["fade"][C_FLAGSHIP]["bound_ms"],
        "bound_by": "bytes",
        "by_channels": {str(C): f for C, f in t["fade"].items()},
        "library_ms": None,
    }, {
        "name": "demod_ctcss",
        "route": "cuda",
        "source": "rtlsdr_airband_tpu_torch/csrc/demod_ctcss.cu",
        "replaces": "rtlsdr_airband_tpu/ops/demod_pallas.py:499 (the CTCSS banks of K1's step)",
        "launches": t["ctcss_launches"],
        "max_abs_err": 0.0,
        "ms": t["ctcss_split"]["mixed8192"]["pass_ms"],
        "plain_ms": None,
        "bound_ms": t["ctcss_split"]["mixed8192"]["pass_bound_ms"],
        "bound_by": t["ctcss_split"]["mixed8192"]["pass_bound_by"],
        "by_scene": t["ctcss_split"],
        "library_ms": None,
    }]}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
