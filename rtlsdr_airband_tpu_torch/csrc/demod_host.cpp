// Host build of the demod kernel's code (demod_step.cuh, demod_tiles.cuh),
// one channel after another.  A test aid: it lets the CPU tests hold the
// kernel's own arithmetic and index arithmetic against the plain PyTorch
// version.  Build with
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC demod_host.cpp
// (no contraction to fused multiply-add, as the kernel's --fmad=false).

#include <vector>

#include "demod_tiles.cuh"

namespace {

// The shared-memory design as the kernel runs it: channel groups of BW, one
// shared-memory image reused by group after group as an SM reuses its
// shared memory, the lanes of a group run one after another (each touches
// only its own column, as each thread does on the card).
template <int BW>
int run_tiled(const DemodArgs& a) {
  using L = demod::SmemLayout<BW>;
  std::vector<float> smem((L::bytes + sizeof(float) - 1) / sizeof(float));
  for (int i = 0; i < demod::LUT_ENTRIES; ++i) {
    smem[L::sin_lut + i] = a.p_sin_lut[i];
    smem[L::cos_lut + i] = a.p_cos_lut[i];
  }
  for (int c0 = 0; c0 < a.C; c0 += BW)
    for (int lane = 0; lane < BW && c0 + lane < a.C; ++lane) demod::demod_tiled<BW>(a, c0 + lane, lane, smem.data());
  return 0;
}

}  // namespace

extern "C" int demod_host_tiled(const DemodArgs* a, int block_width) {
  switch (block_width) {
    case 32:
      return run_tiled<32>(*a);
    case 64:
      return run_tiled<64>(*a);
    default:
      return 1;
  }
}

// The device-memory design; scratch is [GLOBAL_SCRATCH_ROWS, C] float32.
extern "C" int demod_host_global(const DemodArgs* a, float* scratch) {
  for (int c = 0; c < a->C; ++c) demod::demod_global(*a, c, a->p_sin_lut, a->p_cos_lut, scratch);
  return 0;
}

extern "C" size_t demod_smem_bytes(int block_width) { return demod::smem_bytes(block_width); }

extern "C" int demod_global_scratch_rows() { return demod::GLOBAL_SCRATCH_ROWS; }

extern "C" const char* demod_arg_names() { return DEMOD_ARG_NAMES; }
