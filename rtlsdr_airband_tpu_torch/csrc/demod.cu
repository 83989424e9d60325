// K1: the demod recurrence as a CUDA kernel for Hopper (sm_90a).
//
// Replaces rtlsdr_airband_tpu/ops/demod_pallas.py::_make_kernel (launched by
// demod_block_pallas): for every channel and each of the W audio samples of
// a block it advances the reference's whole per-sample demod loop - squelch
// FSM, noise-floor EMA, capped MAs and the 102-slot ring, derotation with
// the 24-bit phase and the interpolated sin/cos table, complex Bessel
// lowpass, AM envelope/AGC with the squelch-open bootstrap, NFM
// discriminator and de-emphasis, dual 52-tone Goertzel CTCSS banks, notch,
// ampfactor and clamp.  The per-channel arithmetic lives in demod_step.cuh.
//
// What bounds it on this card: at the flagship shape (W = 2000, C = 8192)
// it reads about 3 * 4 * W * C bytes (mags plus the IQ pairs, ~197 MB) and
// writes 4 * W * C bytes of audio plus W * C bytes of flags (~82 MB), about
// 0.08 ms at 3.35 TB/s.  But each channel is a chain of W dependent steps and
// there are only C = 8192 channels, so the kernel is bound by the latency of
// that chain, not by bandwidth.
//
// What this first design does about it: one thread per channel (64 threads
// a block, so C = 8192 gives 128 blocks, about one per SM) keeps the scalar
// state in registers for the whole block and issues the loads of each step
// that depend on no arithmetic (mags, IQ, the ring entries) together at the
// top of the step, so a step waits on one memory latency rather than
// several.  The rings and the Goertzel banks stay in device memory laid out
// [row, C] so a warp's accesses are coalesced.  The sin/cos table sits in
// shared memory.  The expensive rare work (the bootstrap fold, the Goertzel
// banks, the window decision) runs as per-thread branches only where the
// reference executes it; cost_group_permutation keeps warps nearly uniform.
// Built with --fmad=false and without fast math, so each operation rounds
// as the plain PyTorch version's does.

#include <cuda_runtime.h>

#include "demod_step.cuh"

namespace {

constexpr int kThreads = 64;

// __grid_constant__: demod_channel takes the arguments by reference without
// a per-thread copy of the struct
__global__ void __launch_bounds__(kThreads) demod_kernel(const __grid_constant__ DemodArgs a) {
  __shared__ float sin_lut[demod::LUT_ENTRIES];
  __shared__ float cos_lut[demod::LUT_ENTRIES];
  for (int i = threadIdx.x; i < demod::LUT_ENTRIES; i += blockDim.x) {
    sin_lut[i] = a.p_sin_lut[i];
    cos_lut[i] = a.p_cos_lut[i];
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < a.C) demod::demod_channel(a, c, sin_lut, cos_lut);
}

}  // namespace

extern "C" int demod_launch(const DemodArgs* a, void* stream) {
  const int blocks = (a->C + kThreads - 1) / kThreads;
  demod_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* demod_arg_names() { return DEMOD_ARG_NAMES; }
