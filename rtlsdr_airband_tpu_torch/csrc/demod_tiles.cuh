// Where the demod step (demod_step.cuh) keeps its data, in the two designs
// of K1.  Both run the same demod_channel(); only these accessors differ.
//
// The shared-memory design (demod_tiled, the kernel's): a block of BW
// channels keeps each channel's rings, Goertzel banks and tone tables in
// dynamic shared memory laid out [row][BW], the channel fastest, and stages
// its input in tiles of TILE samples, tile k+1 copying in (cp.async) while
// the block steps through tile k.  Every thread stages and reads only its own
// channel's column, so no barrier is needed past the sin/cos table's.  The
// tone tables sit in shared memory rather than behind the read-only cache
// (__ldg): the step then reads device memory nowhere, and no tone load can
// miss and stall the 52-tone loop; they cost 33 KB a 64-channel block, which
// still fits, and are copied in only for CTCSS channels.
//
// The device-memory design (the first one, kept as the card's yardstick):
// rings and banks in a [GLOBAL_SCRATCH_ROWS, C] device scratch array, tone
// tables read from the parameters, each sample loaded from device memory at
// the top of its step.
//
// The host build (demod_host.cpp) runs both with memcpy in place of
// cp.async, so the CPU tests hold the tiled index arithmetic too.

#pragma once

#include <string.h>

#include "demod_step.cuh"

namespace demod {

constexpr int TILE = 32;  // samples a staged input tile holds
constexpr int GLOBAL_SCRATCH_ROWS = SQ_BUF + AGC_EXTRA + 4 * MAX_TONES;

// Copy kBytes (4 or 8) of device memory into shared memory without waiting
// for it: cp.async on the card, a plain copy on the host.
template <int kBytes>
DEMOD_HD void stage(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes) : "memory");
#else
  memcpy(dst, src, kBytes);
#endif
}

// Close the group of copies staged since the last commit.
DEMOD_HD void stage_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until every committed group but the newest has landed (for this
// thread's own copies, which are all it reads).
DEMOD_HD void stage_wait_prior() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

// Sample n's IQ pair of channel c: row n of the carried iq_tail below
// AGC_EXTRA, row n - AGC_EXTRA of this block's iqs from there on.
DEMOD_HD const float* iq_at(const float* iqs, const float* iq_tail, size_t C, int c, int n) {
  return (n < AGC_EXTRA) ? iq_tail + 2 * ((size_t)n * C + c) : iqs + 2 * ((size_t)(n - AGC_EXTRA) * C + c);
}

// ---- the device-memory design ----

struct GlobalSource {
  const float *mags, *iqs, *iq_tail;
  size_t C;
  int c;
  DEMOD_HD void at(int n, float& s, float& r, float& i) const {
    s = mags[(size_t)n * C + c];
    const float* iq = iq_at(iqs, iq_tail, C, c, n);
    r = iq[0];
    i = iq[1];
  }
};

// scratch: [GLOBAL_SCRATCH_ROWS, C] float32, rows: ring, delay line, banks
DEMOD_HD Column global_column(const DemodArgs& a, float* scratch, int c) {
  const size_t C = (size_t)a.C;
  float* sq = scratch + c;
  float* dl = sq + SQ_BUF * C;
  float* q = dl + AGC_EXTRA * C;
  return Column{sq, dl, q, q + MAX_TONES * C, q + 2 * MAX_TONES * C, q + 3 * MAX_TONES * C,
                a.p_fast_coeff + c, a.p_slow_coeff + c, a.p_fast_mask + c, a.p_slow_mask + c, C};
}

DEMOD_HD void demod_global(const DemodArgs& a, int c, const float* sin_lut, const float* cos_lut, float* scratch) {
  GlobalSource src{a.mags, a.iqs, a.iq_tail, (size_t)a.C, c};
  demod_channel(a, c, sin_lut, cos_lut, global_column(a, scratch, c), src);
}

// ---- the shared-memory design ----

// Dynamic shared memory of one block of BW channels.  Offsets in floats,
// except `mask` and `bytes`, in bytes.  Each array is [rows][BW].
template <int BW>
struct SmemLayout {
  static constexpr int sin_lut = 0, cos_lut = LUT_ENTRIES;
  static constexpr int sq = (2 * LUT_ENTRIES + 3) / 4 * 4;  // 16-byte aligned from here on
  static constexpr int dl = sq + SQ_BUF * BW;
  static constexpr int banks = dl + AGC_EXTRA * BW;       // fast q1, fast q2, slow q1, slow q2
  static constexpr int coeff = banks + 4 * MAX_TONES * BW;  // fast, slow
  static constexpr int mags = coeff + 2 * MAX_TONES * BW;   // two tiles [TILE][BW]
  static constexpr int iq = mags + 2 * TILE * BW;           // two tiles [TILE][BW][2]
  static constexpr int mask = 4 * (iq + 2 * TILE * BW * 2);  // bytes: fast, slow [MAX_TONES][BW] u8
  static constexpr size_t bytes = mask + 2 * MAX_TONES * BW;
};

// The block widths built (csrc/demod.cu instantiates each): the dynamic
// shared memory of one block, 0 for a width not built.
inline size_t smem_bytes(int block_width) {
  return block_width == 32 ? SmemLayout<32>::bytes : block_width == 64 ? SmemLayout<64>::bytes : 0;
}

// One channel's input, staged a tile ahead into its column of the tiles.
template <int BW>
struct TileSource {
  float* m;  // this channel's column of the mags tiles
  float* q;  // this channel's column of the IQ tiles (pairs)
  const float *mags, *iqs, *iq_tail;
  size_t C;
  int c, W;

  // stage samples k*TILE .. min(W, (k+1)*TILE) - 1 into buffer k % 2
  DEMOD_HD void fetch(int k) {
    float* mb = m + (k & 1) * TILE * BW;
    float* qb = q + (k & 1) * TILE * BW * 2;
    const int n0 = k * TILE;
    const int rows = (W - n0 < TILE) ? W - n0 : TILE;
    for (int j = 0; j < rows; ++j) {
      const int n = n0 + j;
      stage<4>(mb + j * BW, mags + (size_t)n * C + c);
      stage<8>(qb + 2 * j * BW, iq_at(iqs, iq_tail, C, c, n));
    }
    stage_commit();  // an empty group past the end keeps the count uniform
  }

  DEMOD_HD void at(int n, float& s, float& r, float& i) {
    const int k = n / TILE, j = n % TILE;
    if (j == 0) {
      fetch(k + 1);        // the next tile copies in while this one is used
      stage_wait_prior();  // tile k has landed
    }
    const int row = (k & 1) * TILE + j;
    s = m[row * BW];
    r = q[2 * row * BW];
    i = q[2 * row * BW + 1];
  }
};

// Channel c as lane `lane` of a block whose shared memory is `smem` (laid
// out by SmemLayout<BW>, the sin/cos table already in place).
template <int BW>
DEMOD_HD void demod_tiled(const DemodArgs& a, int c, int lane, float* smem) {
  using L = SmemLayout<BW>;
  const size_t C = (size_t)a.C;
  float* coeff = smem + L::coeff + lane;
  uint8_t* mask = reinterpret_cast<uint8_t*>(smem) + L::mask + lane;
  if (a.with_ctcss && a.p_ctcss_enabled[c]) {  // only a CTCSS channel's banks read the tables
    for (int t = 0; t < MAX_TONES; ++t) {
      coeff[t * BW] = a.p_fast_coeff[t * C + c];
      coeff[(MAX_TONES + t) * BW] = a.p_slow_coeff[t * C + c];
      mask[t * BW] = a.p_fast_mask[t * C + c];
      mask[(MAX_TONES + t) * BW] = a.p_slow_mask[t * C + c];
    }
  }
  float* q = smem + L::banks + lane;
  const Column col{smem + L::sq + lane, smem + L::dl + lane, q, q + MAX_TONES * BW, q + 2 * MAX_TONES * BW,
                   q + 3 * MAX_TONES * BW, coeff, coeff + MAX_TONES * BW, mask, mask + MAX_TONES * BW, (size_t)BW};
  TileSource<BW> src{smem + L::mags + lane, smem + L::iq + 2 * lane, a.mags, a.iqs, a.iq_tail, C, c, a.W};
  src.fetch(0);
  demod_channel(a, c, smem + L::sin_lut, smem + L::cos_lut, col, src);
}

}  // namespace demod
