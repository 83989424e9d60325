// Host build of the demod kernel's code (demod_step.cuh, demod_tiles.cuh),
// one channel after another, and of the fade-tail kernel's (fade_tail.cuh),
// one channel and row segment after another.  A test aid: it lets the
// CPU tests hold the kernels' own arithmetic and index arithmetic against
// the plain PyTorch version.  Build with
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC demod_host.cpp
// (no contraction to fused multiply-add, as the kernel's --fmad=false).

#include <vector>

#include "demod_tiles.cuh"
#include "fade_tail.cuh"

namespace {

// K1 as the kernel runs it: channel groups of BW, one shared-memory image
// reused by group after group as an SM reuses its shared memory, the lanes
// of a group run one after another (each touches only its own column, as
// each thread does on the card).
template <int BW, int U>
int run_tiled(const DemodArgs& a) {
  using L = demod::SmemLayout<BW>;
  std::vector<float> smem((L::bytes + sizeof(float) - 1) / sizeof(float));
  for (int i = 0; i < demod::LUT_ENTRIES; ++i) {
    smem[L::sin_lut + i] = a.p_sin_lut[i];
    smem[L::cos_lut + i] = a.p_cos_lut[i];
  }
  for (int c0 = 0; c0 < a.C; c0 += BW)
    for (int lane = 0; lane < BW && c0 + lane < a.C; ++lane) demod::demod_tiled<BW, U>(a, c0 + lane, lane, smem.data());
  return 0;
}

// The pair schedule as the kernel runs it: blocks of two PAIR_TILE-channel
// tiles on one pair-block image, each lane stepping its two channels
// interleaved, lane after lane.
template <int U>
int run_pair(const DemodArgs& a) {
  using L = demod::SmemLayout<demod::PAIR_TILE>;
  std::vector<float> smem((demod::PairLayout::bytes + sizeof(float) - 1) / sizeof(float));
  for (int i = 0; i < demod::LUT_ENTRIES; ++i) {
    smem[L::sin_lut + i] = a.p_sin_lut[i];
    smem[L::cos_lut + i] = a.p_cos_lut[i];
  }
  for (int c0 = 0; c0 < a.C; c0 += 2 * demod::PAIR_TILE)
    for (int lane = 0; lane < demod::PAIR_TILE && c0 + lane < a.C; ++lane)
      demod::demod_tiled_pair<U>(a, c0 + lane, lane, smem.data());
  return 0;
}

}  // namespace

// The schedules the card builds (csrc/demod.cu, csrc/demod_sched.cu):
// BLOCK_WIDTH channels a block at unroll 1, 2 or 4, the pair block at
// unroll 1, 2 or 4.  Returns 0, or 1 for a schedule not built.
extern "C" int demod_host_tiled(const DemodArgs* a, int unroll, int pair) {
  if (pair) {
    switch (unroll) {
      case 1:
        return run_pair<1>(*a);
      case 2:
        return run_pair<2>(*a);
      case 4:
        return run_pair<4>(*a);
      default:
        return 1;
    }
  }
  if (unroll == 1) return run_tiled<demod::BLOCK_WIDTH, 1>(*a);
  if (unroll == 2) return run_tiled<demod::BLOCK_WIDTH, 2>(*a);
  if (unroll == 4) return run_tiled<demod::BLOCK_WIDTH, 4>(*a);
  return 1;
}

extern "C" size_t demod_smem_bytes() { return demod::SmemLayout<demod::BLOCK_WIDTH>::bytes; }

extern "C" size_t demod_pair_smem_bytes() { return demod::PairLayout::bytes; }

extern "C" const char* demod_arg_names() { return DEMOD_ARG_NAMES; }

// The fade-tail kernel's segments (fade_tail.cu), `seg_rows` rows a segment
// (any count above 0), segment after segment.  Returns 0, or 1 for a
// shape it cannot run.
extern "C" int fade_tail_host(const FadeTailArgs* a, int seg_rows) {
  if (seg_rows < 1) return 1;
  const int L = a->A + a->W;
  for (int m0 = 0; m0 < L; m0 += seg_rows)
    for (int c = 0; c < a->C; ++c) fade_tail::segment(*a, a->decay, c, m0, m0 + seg_rows < L ? m0 + seg_rows : L);
  return 0;
}

// fade_tail::segment_rows for (W, C) on a card of `sms` SMs.
extern "C" int fade_tail_segment_rows(int W, int C, int A, int sms) { return fade_tail::segment_rows(W, C, A, sms); }

extern "C" const char* fade_tail_arg_names() { return FADE_TAIL_ARG_NAMES; }
