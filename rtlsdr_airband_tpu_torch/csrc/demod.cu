// K1: the demod recurrence as a CUDA kernel for Hopper (sm_90a).
//
// Replaces rtlsdr_airband_tpu/ops/demod_pallas.py::_make_kernel (body at
// :157-659, launched by demod_block_pallas, pl.pallas_call at :848): for
// every channel and each of the W audio samples of a block it advances the
// reference's whole per-sample demod loop - squelch FSM, noise-floor EMA,
// capped MAs and the 102-slot ring, derotation with the 24-bit phase and the
// interpolated sin/cos table, complex Bessel lowpass, AM envelope/AGC with
// the squelch-open bootstrap, NFM discriminator and de-emphasis, notch,
// ampfactor and clamp.  A CTCSS channel's dual 52-tone Goertzel banks, its
// tone gate and what the gate feeds are the CTCSS pass's (demod_ctcss.cu),
// launched after K1.  The per-channel arithmetic lives in demod_step.cuh,
// where it keeps its data in demod_tiles.cuh.
//
// What bounds it on this card: at the flagship shape (W = 2000, C = 8192)
// it reads about 3 * 4 * W * C bytes (mags plus the IQ pairs, ~197 MB) and
// writes 4 * W * C bytes of audio plus W * C bytes of flags (~82 MB), about
// 0.09 ms at 3.35 TB/s.  But each channel is a chain of W dependent steps and
// there are only C = 8192 channels, one thread each, two warps an SM: the
// kernel is bound by the latency of that chain.  The first design kept the
// rings (102 + 100 rows) and the Goertzel banks (4 x 52 rows) in device
// memory and loaded each sample at the top of its step, so a step waited on
// round trips to L2 and DRAM, and an open CTCSS channel on 2 x 52 of them.
//
// What this design does about it: a block of BW = BLOCK_WIDTH (64) channels
// keeps its rings in dynamic shared memory as
// [row][BW], the channel fastest, so each warp access touches 32 banks once
// and waits ~30 cycles, not an L2 round trip.  The input is staged into
// shared memory a tile of 32 samples ahead with cp.async (4- and 8-byte
// copies of the thread's own channel: any C, and the iq_tail / iqs switch
// at n = 100 row by row), so no step waits on device memory.  Each thread
// touches only its own column, so the only barrier is the sin/cos table's.
// Outputs are stored as before; nothing in the step reads device memory
// after them.  The scalar state stays in registers; rare work (the AGC
// bootstrap) stays a per-thread branch; cost_group_permutation keeps warps
// nearly uniform.  The banks left K1 because one thread stepped up to 104
// tones a sample on its channel's chain, so an open CTCSS channel set the
// pace of the whole kernel; the pass spreads them over a warp's lanes.
// About 103 KB a block.  Built with --fmad=false and without fast math, so
// each operation rounds as the plain PyTorch version's does and the outputs
// are equal bit for bit.
//
// The kernels are templates (demod_kernels.cuh); this file builds the
// default schedule, one sample a loop trip, at BLOCK_WIDTH channels a block.
// The schedules a caller may ask for instead, several samples a trip and two
// channel tiles a block, are built from the same templates by
// demod_sched.cu.

#include "demod_kernels.cuh"

// The shared-memory K1 in the default schedule.  Returns a cudaError_t, 0
// when the launch was taken.
extern "C" int demod_launch(const DemodArgs* a, void* stream) {
  return static_cast<int>(launch_tiled<demod::BLOCK_WIDTH, 1>(*a, static_cast<cudaStream_t>(stream)));
}

// Dynamic shared memory of one block.
extern "C" size_t demod_smem_bytes() { return demod::SmemLayout<demod::BLOCK_WIDTH>::bytes; }

extern "C" const char* demod_arg_names() { return DEMOD_ARG_NAMES; }
