// Where the demod step (demod_step.cuh) keeps its data in K1.
//
// demod_tiled: a block of BW channels keeps each channel's rings in dynamic
// shared memory laid out [row][BW], the channel fastest, and stages its
// input in tiles of TILE samples, tile k+1 copying in (cp.async) while the
// block steps through tile k.  Every thread stages and reads only its own
// channel's column, so no barrier is needed past the sin/cos table's.  The
// Goertzel banks and their tone tables are the CTCSS pass's, in its
// registers (demod_ctcss.cuh), not here.
//
// The schedules (demod_sched.cu): U samples a loop trip (demod_channel's
// U), and the pair block, two tiles of PAIR_TILE channels on one tile's
// threads, each thread stepping one channel of each tile together
// (demod_tiled_pair).
//
// The host build (demod_host.cpp) runs every schedule with memcpy in place
// of cp.async, so the CPU tests hold the tiled index arithmetic too.

#pragma once

#include <string.h>

#include "demod_step.cuh"

namespace demod {

constexpr int TILE = 32;  // samples a staged input tile holds

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

// Dynamic shared memory of one block of BW channels.  Offsets in floats,
// except `bytes`.  Each array is [rows][BW].
template <int BW>
struct SmemLayout {
  static constexpr int sin_lut = 0, cos_lut = LUT_ENTRIES;
  static constexpr int sq = (2 * LUT_ENTRIES + 3) / 4 * 4;  // 16-byte aligned from here on
  static constexpr int dl = sq + SQ_BUF * BW;
  static constexpr int mags = dl + AGC_EXTRA * BW;  // two tiles [TILE][BW]
  static constexpr int iq = mags + 2 * TILE * BW;   // two tiles [TILE][BW][2]
  static constexpr size_t bytes = 4 * (iq + 2 * TILE * BW * 2);
};

// Channels a block of the default schedule and of the unroll schedules.
constexpr int BLOCK_WIDTH = 64;

// The pair schedule's block: two tiles of PAIR_TILE channels on PAIR_TILE
// threads, each tile in an image of SmemLayout<PAIR_TILE>, the second
// `image` floats after the first.  The sin/cos table is read from the first
// image only.
constexpr int PAIR_TILE = 32;
struct PairLayout {
  static constexpr size_t image = (SmemLayout<PAIR_TILE>::bytes + 15) / 16 * 4;  // floats, 16-byte aligned
  static constexpr size_t bytes = 4 * image + SmemLayout<PAIR_TILE>::bytes;
};

// One channel's input, staged a tile ahead into its column of the tiles.
template <int BW>
struct TileSource {
  float* m;  // this channel's column of the mags tiles
  float* q;  // this channel's column of the IQ tiles (pairs)
  const float *mags, *iqs, *iq_tail;
  size_t C;
  int c, W;

  // stage samples k*TILE .. min(W, (k+1)*TILE) - 1 into buffer k % 2,
  // without closing the group
  DEMOD_HD void stage_tile(int k) {
    float* mb = m + (k & 1) * TILE * BW;
    float* qb = q + (k & 1) * TILE * BW * 2;
    const int n0 = k * TILE;
    const int rows = (W - n0 < TILE) ? W - n0 : TILE;
    for (int j = 0; j < rows; ++j) {
      const int n = n0 + j;
      stage<4>(mb + j * BW, mags + (size_t)n * C + c);
      stage<8>(qb + 2 * j * BW, iq_at(iqs, iq_tail, C, c, n));
    }
  }

  DEMOD_HD void fetch(int k) {
    stage_tile(k);
    stage_commit();  // an empty group past the end keeps the count uniform
  }

  // sample n from the tile that holds it (landed)
  DEMOD_HD void row(int n, float& s, float& r, float& i) const {
    const int k = ((n / TILE) & 1) * TILE + n % TILE;
    s = m[k * BW];
    r = q[2 * k * BW];
    i = q[2 * k * BW + 1];
  }

  DEMOD_HD void at(int n, float& s, float& r, float& i) {
    if (n % TILE == 0) {
      fetch(n / TILE + 1);  // the next tile copies in while this one is used
      stage_wait_prior();   // this tile has landed
    }
    row(n, s, r, i);
  }
};

// Two channels' inputs for the pair schedule: both columns' tile k + 1 staged
// in ONE commit group, so `wait_group 1` (all groups but the newest) covers
// tile k of both, and neither channel's prefetch waits on the other's.
template <int BW>
struct PairTileSource {
  TileSource<BW> A, B;

  DEMOD_HD void fetch(int k) {
    A.stage_tile(k);
    B.stage_tile(k);
    stage_commit();
  }

  DEMOD_HD void at(int n, float& sa, float& ra, float& ia, float& sb, float& rb, float& ib) {
    if (n % TILE == 0) {
      fetch(n / TILE + 1);
      stage_wait_prior();
    }
    A.row(n, sa, ra, ia);
    B.row(n, sb, rb, ib);
  }
};

// The rings' column of lane `lane` in a block image laid out by SmemLayout<BW>.
template <int BW>
DEMOD_HD Column tiled_column(int lane, float* smem) {
  using L = SmemLayout<BW>;
  return Column{smem + L::sq + lane, smem + L::dl + lane, (size_t)BW};
}

template <int BW>
DEMOD_HD TileSource<BW> tile_source(const DemodArgs& a, int c, int lane, float* smem) {
  using L = SmemLayout<BW>;
  return TileSource<BW>{smem + L::mags + lane, smem + L::iq + 2 * lane, a.mags, a.iqs, a.iq_tail, (size_t)a.C, c, a.W};
}

// Channel c as lane `lane` of a block whose shared memory is `smem` (laid
// out by SmemLayout<BW>, the sin/cos table already in place), U samples a
// loop trip.
template <int BW, int U>
DEMOD_HD void demod_tiled(const DemodArgs& a, int c, int lane, float* smem) {
  using L = SmemLayout<BW>;
  const Column col = tiled_column<BW>(lane, smem);
  TileSource<BW> src = tile_source<BW>(a, c, lane, smem);
  src.fetch(0);
  demod_channel<U>(a, c, smem + L::sin_lut, smem + L::cos_lut, col, src);
}

// Lane `lane` of a pair block (PairLayout, the sin/cos table in place in the
// first image): channel c of the first tile and c + PAIR_TILE of the second,
// stepped together.  Where the second tile is ragged, a lane without a
// second channel steps its first alone.
template <int U>
DEMOD_HD void demod_tiled_pair(const DemodArgs& a, int c, int lane, float* smem) {
  using L = SmemLayout<PAIR_TILE>;
  const int cB = c + PAIR_TILE;
  if (cB >= a.C) {
    demod_tiled<PAIR_TILE, U>(a, c, lane, smem);
    return;
  }
  float* smemB = smem + PairLayout::image;
  const Column colA = tiled_column<PAIR_TILE>(lane, smem);
  const Column colB = tiled_column<PAIR_TILE>(lane, smemB);
  PairTileSource<PAIR_TILE> src{tile_source<PAIR_TILE>(a, c, lane, smem), tile_source<PAIR_TILE>(a, cB, lane, smemB)};
  src.fetch(0);
  demod_pair<U>(a, c, cB, smem + L::sin_lut, smem + L::cos_lut, colA, colB, src);
}

}  // namespace demod
