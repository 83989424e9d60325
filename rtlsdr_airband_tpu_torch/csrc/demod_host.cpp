// Host build of the demod kernel's per-channel code (demod_step.cuh), one
// channel after another.  A test aid: it lets the CPU tests hold the
// kernel's own arithmetic against the plain PyTorch version.  Build with
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC demod_host.cpp
// (no contraction to fused multiply-add, as the kernel's --fmad=false).

#include "demod_step.cuh"

extern "C" int demod_host(const DemodArgs* a) {
  for (int c = 0; c < a->C; ++c) demod::demod_channel(*a, c, a->p_sin_lut, a->p_cos_lut);
  return 0;
}

extern "C" const char* demod_arg_names() { return DEMOD_ARG_NAMES; }
