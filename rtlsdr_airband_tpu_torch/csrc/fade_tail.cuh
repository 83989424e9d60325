// The block's assembly after K1, one channel and one row segment at a
// time: the AM squelch-close fade rewrite and the carried tail, as
// ops/demod.py::apply_fade_and_tail computes them, plus the open flags out
// of K1's flag bytes.  Shared by the CUDA kernel (fade_tail.cu) and a host
// build of the same code (demod_host.cpp, for the CPU tests).
//
// The rows: w_full = [tail; raw] has L = A + W rows.  Row m takes the
// latest close mark n < m (n < W: bit 1 of flags[n]); if there is one and
// m - n < A, it is w_full[n] * decay[m - n] (one float32 product of the
// un-rewritten w_full[n]), else w_full[m].  Rows m < W are the audio, rows
// m >= W the new tail.  A mark reaches A - 1 rows, so a segment that starts
// at row m0 needs only the marks in [m0 - (A - 1), m0): it finds the latest
// of them by itself, and the segments of a column are independent.
//
// Layout: every array is [rows, C], the channel fastest; a thread takes
// one channel, so the threads of a warp touch consecutive addresses.

#pragma once

#include <stdint.h>

#include "demod_step.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FADE_HD __host__ __device__ __forceinline__
#else
#define FADE_HD inline
#endif

struct FadeTailArgs {
  const float* tail;     // [A, C] the carried tail
  const float* raw;      // [W, C] K1's audio before the assembly
  const uint8_t* flags;  // [W, C] K1's flag bytes (demod::flag): OPEN, CLOSE_MARK
  const float* decay;    // [A] the fade factors 0.94^i
  float* audio;          // [W, C]
  float* new_tail;       // [A, C]
  uint8_t* open_now;     // [W, C] 0 or 1
  int32_t W, C, A;
};

// Field names in struct order: the Python side builds its ctypes mirror of
// FadeTailArgs from this string.
#define FADE_TAIL_ARG_NAMES "tail,raw,flags,decay,audio,new_tail,open_now,W,C,A"

namespace fade_tail {

constexpr int ROWS_AHEAD = 8;         // rows whose loads a thread issues before it uses them
constexpr int THREADS = 128;          // threads a block, along the channels
constexpr int THREADS_PER_SM = 1024;  // the threads a launch aims at an SM
constexpr int MIN_SEGMENT_ROWS = 64;  // a segment's rows at least: its look-back reads up to A - 1 flag rows

template <class T>
FADE_HD T ld(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// Row m of w_full at channel c.
FADE_HD float full_at(const FadeTailArgs& a, int m, int c) {
  return m < a.A ? ld(a.tail + (size_t)m * a.C + c) : ld(a.raw + (size_t)(m - a.A) * a.C + c);
}

// Rows [m0, m1) of channel c.  decay holds a.decay (the card's copy in
// shared memory).
FADE_HD void segment(const FadeTailArgs& a, const float* decay, int c, int m0, int m1) {
  const int A = a.A, W = a.W;
  const size_t C = (size_t)a.C;
  int last = -A;  // the latest mark before the row; -A: none that can reach it
  float base = 0.0f;

  // the look-back: the latest mark in [m0 - (A - 1), m0), and its raw value
  const int hi = m0 < W ? m0 : W;
  for (int n = (m0 - (A - 1) > 0 ? m0 - (A - 1) : 0); n < hi; ++n)
    if (ld(a.flags + n * C + c) & demod::flag::CLOSE_MARK) last = n;
  if (last >= 0) base = full_at(a, last, c);

  // the rows, ROWS_AHEAD loads at a time: none depends on the carried mark
  for (int m = m0; m < m1; m += ROWS_AHEAD) {
    float v[ROWS_AHEAD];
    uint8_t f[ROWS_AHEAD];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int r = 0; r < ROWS_AHEAD; ++r) {
      const int row = m + r;
      if (row >= m1) break;
      v[r] = full_at(a, row, c);
      f[r] = row < W ? ld(a.flags + row * C + c) : 0;
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int r = 0; r < ROWS_AHEAD; ++r) {
      const int row = m + r;
      if (row >= m1) break;
      const int age = row - last;
      const float out = age < A ? base * decay[age] : v[r];
      if (row < W) {
        a.audio[row * C + c] = out;
        a.open_now[row * C + c] = f[r] & demod::flag::OPEN;
      } else {
        a.new_tail[(row - W) * C + c] = out;
      }
      if (f[r] & demod::flag::CLOSE_MARK) last = row, base = v[r];  // a mark acts from the next row on
    }
  }
}

// Rows a segment for (W, C) on a card of `sms` SMs: about THREADS_PER_SM
// threads an SM, in segments of at least MIN_SEGMENT_ROWS rows, a multiple
// of ROWS_AHEAD.
FADE_HD int segment_rows(int W, int C, int A, int sms) {
  const int L = A + W;
  const long long want = (long long)sms * THREADS_PER_SM;
  long long segs = (want + C - 1) / C;
  const long long most = (L + MIN_SEGMENT_ROWS - 1) / MIN_SEGMENT_ROWS;
  if (segs > most) segs = most;
  if (segs < 1) segs = 1;
  const int rows = (int)((L + segs - 1) / segs);
  return (rows + ROWS_AHEAD - 1) / ROWS_AHEAD * ROWS_AHEAD;
}

}  // namespace fade_tail
