// K1's kernels as templates, instantiated by csrc/demod.cu (the default
// schedule at BLOCK_WIDTH channels a block, the path every caller takes) and
// by csrc/demod_sched.cu (the schedules a caller asks for by name), so that
// the default's build does not grow with the schedules'.
//
// demod_kernel<BW, U>: a block of BW channels, one thread each, U samples a
// loop trip (csrc/demod.cu explains the design).  demod_pair_kernel<U>: the
// pair schedule, a block of two PAIR_TILE-channel tiles on PAIR_TILE
// threads, each thread stepping one channel of each tile together.

#pragma once

#include <cuda_runtime.h>

#include "demod_tiles.cuh"

namespace {

template <int BW, int U>
__global__ void __launch_bounds__(BW) demod_kernel(const __grid_constant__ DemodArgs a) {
  extern __shared__ __align__(16) float smem[];
  using L = demod::SmemLayout<BW>;
  for (int i = threadIdx.x; i < demod::LUT_ENTRIES; i += BW) {
    smem[L::sin_lut + i] = a.p_sin_lut[i];
    smem[L::cos_lut + i] = a.p_cos_lut[i];
  }
  __syncthreads();
  const int c = blockIdx.x * BW + threadIdx.x;
  if (c < a.C) demod::demod_tiled<BW, U>(a, c, threadIdx.x, smem);
}

template <int U>
__global__ void __launch_bounds__(demod::PAIR_TILE) demod_pair_kernel(const __grid_constant__ DemodArgs a) {
  extern __shared__ __align__(16) float smem[];
  using L = demod::SmemLayout<demod::PAIR_TILE>;
  for (int i = threadIdx.x; i < demod::LUT_ENTRIES; i += demod::PAIR_TILE) {
    smem[L::sin_lut + i] = a.p_sin_lut[i];
    smem[L::cos_lut + i] = a.p_cos_lut[i];
  }
  __syncthreads();
  const int c = blockIdx.x * 2 * demod::PAIR_TILE + threadIdx.x;
  if (c < a.C) demod::demod_tiled_pair<U>(a, c, threadIdx.x, smem);
}

// Launch `kernel` on `blocks` blocks of `threads` with `bytes` of dynamic
// shared memory, at the largest shared-memory carveout (one block
// takes about 103 KB of an SM's 228).
template <class Kernel>
cudaError_t launch(Kernel kernel, int blocks, int threads, size_t bytes, const DemodArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int BW, int U>
cudaError_t launch_tiled(const DemodArgs& a, cudaStream_t stream) {
  return launch(demod_kernel<BW, U>, (a.C + BW - 1) / BW, BW, demod::SmemLayout<BW>::bytes, a, stream);
}

template <int U>
cudaError_t launch_pair(const DemodArgs& a, cudaStream_t stream) {
  constexpr int per_block = 2 * demod::PAIR_TILE;
  return launch(demod_pair_kernel<U>, (a.C + per_block - 1) / per_block, demod::PAIR_TILE, demod::PairLayout::bytes, a,
                stream);
}

}  // namespace
