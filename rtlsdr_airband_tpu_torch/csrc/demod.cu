// K1: the demod recurrence as a CUDA kernel for Hopper (sm_90a).
//
// Replaces rtlsdr_airband_tpu/ops/demod_pallas.py::_make_kernel (body at
// :157-659, launched by demod_block_pallas, pl.pallas_call at :848): for
// every channel and each of the W audio samples of a block it advances the
// reference's whole per-sample demod loop - squelch FSM, noise-floor EMA,
// capped MAs and the 102-slot ring, derotation with the 24-bit phase and the
// interpolated sin/cos table, complex Bessel lowpass, AM envelope/AGC with
// the squelch-open bootstrap, NFM discriminator and de-emphasis, dual 52-tone
// Goertzel CTCSS banks, notch, ampfactor and clamp.  The per-channel
// arithmetic lives in demod_step.cuh, where it keeps its data in
// demod_tiles.cuh.
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
// What this design does about it: a block of BW channels (32 or 64, a
// template parameter) keeps its rings, banks and tone tables in dynamic
// shared memory as [row][BW], the channel fastest, so each warp access
// touches 32 banks once and waits ~30 cycles, not an L2 round trip.  The
// input is staged into shared memory a tile of 32 samples ahead with
// cp.async (4- and 8-byte copies of the thread's own channel: any C, and
// the iq_tail / iqs switch at n = 100 row by row), so no step waits on
// device memory.  Each thread touches only its own column, so the only
// barrier is the sin/cos table's.  Outputs are stored as before; nothing in
// the step reads device memory after them.  The scalar state stays in
// registers; rare work (AGC bootstrap, banks, window decision) stays per-
// thread branches; cost_group_permutation keeps warps nearly uniform.
// About 185 KB a block at BW = 64 (one block an SM), 93 KB at BW = 32 (two).
// Built with --fmad=false and without fast math, so each operation rounds
// as the plain PyTorch version's does and the outputs are equal bit for bit.
//
// The device-memory design stays as demod_global_kernel, the same header
// instantiated with device-memory accessors, launched only to time the new
// design against it.

#include <cuda_runtime.h>

#include "demod_tiles.cuh"

namespace {

template <int BW>
__global__ void __launch_bounds__(BW) demod_kernel(const __grid_constant__ DemodArgs a) {
  extern __shared__ __align__(16) float smem[];
  using L = demod::SmemLayout<BW>;
  for (int i = threadIdx.x; i < demod::LUT_ENTRIES; i += BW) {
    smem[L::sin_lut + i] = a.p_sin_lut[i];
    smem[L::cos_lut + i] = a.p_cos_lut[i];
  }
  __syncthreads();
  const int c = blockIdx.x * BW + threadIdx.x;
  if (c < a.C) demod::demod_tiled<BW>(a, c, threadIdx.x, smem);
}

template <int BW>
cudaError_t launch(const DemodArgs& a, cudaStream_t stream) {
  const int bytes = static_cast<int>(demod::SmemLayout<BW>::bytes);
  cudaError_t e = cudaFuncSetAttribute(demod_kernel<BW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  // the largest carveout, so two 32-channel blocks fit on one SM
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(demod_kernel<BW>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  demod_kernel<BW><<<(a.C + BW - 1) / BW, BW, bytes, stream>>>(a);
  return cudaGetLastError();
}

constexpr int kGlobalThreads = 64;

__global__ void __launch_bounds__(kGlobalThreads)
    demod_global_kernel(const __grid_constant__ DemodArgs a, float* __restrict__ scratch) {
  __shared__ float sin_lut[demod::LUT_ENTRIES];
  __shared__ float cos_lut[demod::LUT_ENTRIES];
  for (int i = threadIdx.x; i < demod::LUT_ENTRIES; i += blockDim.x) {
    sin_lut[i] = a.p_sin_lut[i];
    cos_lut[i] = a.p_cos_lut[i];
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < a.C) demod::demod_global(a, c, sin_lut, cos_lut, scratch);
}

}  // namespace

// The shared-memory K1 at block_width 32 or 64.  Returns a cudaError_t, 0
// when the launch was taken; cudaErrorInvalidValue for any other width.
extern "C" int demod_launch(const DemodArgs* a, int block_width, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (block_width) {
    case 32:
      return static_cast<int>(launch<32>(*a, s));
    case 64:
      return static_cast<int>(launch<64>(*a, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The device-memory design; scratch is [GLOBAL_SCRATCH_ROWS, C] float32.
extern "C" int demod_launch_global(const DemodArgs* a, float* scratch, void* stream) {
  const int blocks = (a->C + kGlobalThreads - 1) / kGlobalThreads;
  demod_global_kernel<<<blocks, kGlobalThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a, scratch);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block at block_width; 0 for a width not built.
extern "C" size_t demod_smem_bytes(int block_width) { return demod::smem_bytes(block_width); }

extern "C" int demod_global_scratch_rows() { return demod::GLOBAL_SCRATCH_ROWS; }

extern "C" const char* demod_arg_names() { return DEMOD_ARG_NAMES; }
