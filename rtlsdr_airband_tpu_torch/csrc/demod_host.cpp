// Host build of the demod kernel's code (demod_step.cuh, demod_tiles.cuh),
// one channel after another, then of the CTCSS pass's (demod_ctcss.cuh),
// one CTCSS channel after another, and of the fade-tail kernel's
// (fade_tail.cuh), one channel and row segment after another.  A test aid:
// it lets the CPU tests hold the kernels' own arithmetic and index
// arithmetic against the plain PyTorch version.  Build with
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC demod_host.cpp
// (no contraction to fused multiply-add, as the kernel's --fmad=false).

#include <vector>

#include "demod_ctcss.cuh"
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

// The CTCSS pass's lanes on the host: one lane holds every tone of a bank
// and every sample of a tile, so a tile is skipped where the card's warp
// skips it, and its samples run in the card's order.
struct HostWarp {
  static constexpr int SLOTS = demod::MAX_TONES;

  struct Tile {
    float x[ctcss::LANES], out[ctcss::LANES];
    unsigned f[ctcss::LANES], out_f[ctcss::LANES];
    bool zero_iq[ctcss::LANES];
  };

  int tone(int k) const { return k; }
  bool leader() const { return true; }

  uint64_t tone_bits(const bool (&m)[SLOTS]) const {
    uint64_t bits = 0;
    for (int t = 0; t < SLOTS; ++t) bits |= (uint64_t)m[t] << t;
    return bits;
  }

  float tone_value(const float (&p)[SLOTS], int t) const { return p[t]; }

  void load(const DemodArgs& a, int c, int n0, Tile& t) const {
    for (int i = 0; i < ctcss::LANES; ++i) {
      const int n = n0 + i;
      const size_t o = (size_t)n * a.C + c;
      t.x[i] = n < a.W ? a.audio_raw[o] : 0.0f;
      t.f[i] = n < a.W ? a.flags[o] : 0u;
    }
  }

  bool active(const Tile& t) const {
    bool any = false;
    for (int i = 0; i < ctcss::LANES; ++i) any |= (t.f[i] & (demod::flag::OPEN | demod::flag::ADVANCE | demod::flag::RESET)) != 0;
    return any;
  }

  bool all_advance(const Tile& t) const {
    bool all = true;
    for (int i = 0; i < ctcss::LANES; ++i) all &= (t.f[i] & (demod::flag::ADVANCE | demod::flag::RESET)) == demod::flag::ADVANCE;
    return all;
  }

  float sample(const Tile& t, int j) const { return t.x[j]; }

  void take(const Tile& t, int j, float& x, unsigned& f) const {
    x = t.x[j];
    f = t.f[j];
  }

  void keep(Tile& t, int j, float audio, unsigned flag, bool zero_iq) const {
    t.out[j] = audio;
    t.out_f[j] = flag;
    t.zero_iq[j] = zero_iq;
  }

  template <class Fn>
  void each(Tile& t, Fn fn) const {
    for (int i = 0; i < ctcss::LANES; ++i) fn(i, t.x[i], t.f[i], t.out[i], t.out_f[i], t.zero_iq[i]);
  }

  void store(const DemodArgs& a, int c, int n0, const Tile& t, bool iq_gated) const {
    for (int i = 0; i < ctcss::LANES && n0 + i < a.W; ++i) {
      const size_t o = (size_t)(n0 + i) * a.C + c;
      a.audio_raw[o] = t.out[i];
      a.flags[o] = (uint8_t)t.out_f[i];
      if (iq_gated && t.zero_iq[i]) {
        a.iq_out[2 * o] = 0.0f;
        a.iq_out[2 * o + 1] = 0.0f;
      }
    }
  }
};

// K1 in schedule (unroll, pair), then, where the block runs its CTCSS banks,
// the CTCSS pass, as launch_k1 launches them.  Returns 0, or 1 for a
// schedule not built.
int run_k1(const DemodArgs& a, int unroll, int pair) {
  int rc = 1;
  if (pair && unroll == 1) rc = run_pair<1>(a);
  if (pair && unroll == 2) rc = run_pair<2>(a);
  if (pair && unroll == 4) rc = run_pair<4>(a);
  if (!pair && unroll == 1) rc = run_tiled<demod::BLOCK_WIDTH, 1>(a);
  if (!pair && unroll == 2) rc = run_tiled<demod::BLOCK_WIDTH, 2>(a);
  if (!pair && unroll == 4) rc = run_tiled<demod::BLOCK_WIDTH, 4>(a);
  if (rc != 0 || !a.with_ctcss) return rc;
  for (int c = 0; c < a.C; ++c)
    if (a.p_ctcss_enabled[c]) ctcss::pass_channel(a, c, HostWarp{});
  return 0;
}

}  // namespace

// The schedules the card builds (csrc/demod.cu, csrc/demod_sched.cu):
// BLOCK_WIDTH channels a block at unroll 1, 2 or 4, the pair block at
// unroll 1, 2 or 4; each followed by the CTCSS pass (csrc/demod_ctcss.cu)
// when with_ctcss is on.  Returns 0, or 1 for a schedule not built.
extern "C" int demod_host_tiled(const DemodArgs* a, int unroll, int pair) { return run_k1(*a, unroll, pair); }

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
