// The split products of the bf16 flash-attention kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu), on the wgmma
// instructions of wgmma_sm90.cuh. In the m16n8k16 fragment layout that
// wgmma's accumulators and register A operand share (wgmma_sm90.cuh), the
// accumulators of two neighbouring n8 blocks are, repacked to bf16 in
// registers, the A operand of one k16 step: no shared-memory round trip.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace flash_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// An f32 operand as two bf16 parts, hi and lo: hi + lo carries ~16 of x's
// 24 mantissa bits, where hi alone carries 8.
struct Split {
  uint32_t hi[4], lo[4];
};

// The split by truncation, on the integer pipes alone: hi = the upper 16
// bits of x (bf16 rounded toward zero), lo = the upper 16 bits of the exact
// remainder x - hi. hi + lo keeps x to 2^-14 of itself, where one bf16
// rounding keeps 2^-9; and no conversion runs on the quarter-rate pipe that
// the exp2 of the same scores needs (the wgmma kernels' floor).
__device__ __forceinline__ void split_pair_trunc(float x0, float x1, uint32_t& hi,
                                                 uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  lo = __byte_perm(__float_as_uint(x0 - __uint_as_float(u0 & 0xffff0000u)),
                   __float_as_uint(x1 - __uint_as_float(u1 & 0xffff0000u)), 0x7632);
}

// The A operand of one k16 step from two n8 accumulator blocks (columns
// 0-7 and 8-15 of the step), split into hi and lo parts.
__device__ __forceinline__ Split split_a_trunc(const float (&c0)[4], const float (&c1)[4]) {
  Split s;
  split_pair_trunc(c0[0], c0[1], s.hi[0], s.lo[0]);
  split_pair_trunc(c0[2], c0[3], s.hi[1], s.lo[1]);
  split_pair_trunc(c1[0], c1[1], s.hi[2], s.lo[2]);
  split_pair_trunc(c1[2], c1[3], s.hi[3], s.lo[3]);
  return s;
}

// d += (a.hi + a.lo) * B for the warpgroup: the register-A wgmma of an f32
// operand carried in two bf16 parts, both against the same B descriptor
// (MN-major: V in P*V, K in dS*K, dO and Q in dV and dK).
template <int NB>
__device__ __forceinline__ void wgmma_split(float (&d)[NB][4], const Split& a, uint64_t b) {
  wgmma_sm90::wgmma_rs<1>(d, a.hi, b, true);
  wgmma_sm90::wgmma_rs<1>(d, a.lo, b, true);
}

}  // namespace flash_mma
