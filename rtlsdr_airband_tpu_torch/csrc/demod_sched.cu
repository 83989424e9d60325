// K1's schedules: the same kernel (demod_kernels.cuh, designed in demod.cu)
// stepping its channels in another order, built apart from demod.cu so the
// default's build does not grow.  Counterpart of the schedule options of
// rtlsdr_airband_tpu/ops/demod_pallas.py::_make_kernel (`unroll`, `pair`,
// :157-166, :633-646) and demod_block_pallas (:695-709).
//
// - unroll U = 2 or 4 at BLOCK_WIDTH (64) channels a block: U samples
//   a loop trip.  It cuts the loop's own instructions, not the dependency
//   from one sample to the next.
// - pair: a block of two 32-channel tiles on 32 threads, thread t stepping
//   channel base + t and base + 32 + t together, sample by sample (both
//   samples taken, A's step, B's step), with U = 1, 2 or 4.  Each tile keeps the shared-memory image of a 32-channel
//   block (about 52 KB, so 105 KB a block: the 64-channel block's shared
//   memory and grid), and each thread stages both channels' input tiles in
//   one cp.async group.  One warp with two independent chains against the
//   default's two warps with one: whether the card overlaps the two chains
//   of one thread as well as it overlaps two warps is what the schedule
//   measures.  The registers of two channels' state may spill (ptxas prints
//   them for each instantiation).
//
// What bounds them is what bounds the default: the dependent chain of each
// channel's W steps.  Every float operation of a channel runs in the same
// order as in the default schedule, so every schedule's outputs and state
// equal the default's, and the plain version's, bit for bit.

#include "demod_kernels.cuh"

// One launch of schedule (unroll, pair).  Returns a cudaError_t, 0 when the
// launch was taken; cudaErrorInvalidValue for a schedule not built here.
extern "C" int demod_launch_schedule(const DemodArgs* a, int unroll, int pair, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (!pair && unroll == 2) e = launch_tiled<demod::BLOCK_WIDTH, 2>(*a, s);
  if (!pair && unroll == 4) e = launch_tiled<demod::BLOCK_WIDTH, 4>(*a, s);
  if (pair && unroll == 1) e = launch_pair<1>(*a, s);
  if (pair && unroll == 2) e = launch_pair<2>(*a, s);
  if (pair && unroll == 4) e = launch_pair<4>(*a, s);
  return static_cast<int>(e);
}

// Dynamic shared memory of one pair block.
extern "C" size_t demod_pair_smem_bytes() { return demod::PairLayout::bytes; }

// Dynamic shared memory of one block of the unroll schedules.
extern "C" size_t demod_smem_bytes() { return demod::SmemLayout<demod::BLOCK_WIDTH>::bytes; }

extern "C" const char* demod_arg_names() { return DEMOD_ARG_NAMES; }
