// The instructions of csrc/mma_sm90.cuh (same names and signatures),
// emulated on the CPU by emu.h's warps, by the PTX ISA's definitions:
// ldmatrix hands lane l of each 8x8 matrix the pair (row l/4, columns
// 2(l%4), 2(l%4)+1), or with .trans the pair (rows 2(l%4), 2(l%4)+1,
// column l/4); mma.m16n8k16 uses the fragment layouts listed in
// csrc/mma_sm90.cuh and sums each product in f32.
#pragma once

#include "emu.h"

namespace mma_sm90 {

using bf16 = __nv_bfloat16;

inline uint32_t smem_addr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

inline void cp_async_16(uint32_t dst, const void* src, bool valid) {
  if (dst % 16 || (valid && (uintptr_t)src % 16)) {
    fprintf(stderr, "cp.async: address not 16-byte aligned\n");
    abort();
  }
  if (valid) memcpy(emu_smem(dst), src, 16);
  else memset(emu_smem(dst), 0, 16);
}

inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

inline uint16_t emu_ld16(uint32_t row_addr, int i) {
  uint16_t v;
  memcpy(&v, emu_smem(row_addr) + 2 * i, 2);
  return v;
}

inline void emu_ldmatrix(uint32_t (&r)[4], uint32_t addr, bool trans) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if (addr % 16) {
    fprintf(stderr, "ldmatrix: row address not 16-byte aligned\n");
    abort();
  }
  emu_lane(lane)[0] = addr;  // lane 8i + j gives row j of matrix i
  emu_warp_sync();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (trans) {
      lo = emu_ld16((uint32_t)emu_lane(8 * i + 2 * t)[0], g);
      hi = emu_ld16((uint32_t)emu_lane(8 * i + 2 * t + 1)[0], g);
    } else {
      lo = emu_ld16((uint32_t)emu_lane(8 * i + g)[0], 2 * t);
      hi = emu_ld16((uint32_t)emu_lane(8 * i + g)[0], 2 * t + 1);
    }
    r[i] = (uint32_t)lo | ((uint32_t)hi << 16);
  }
  emu_warp_sync();
}

inline void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) { emu_ldmatrix(r, addr, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) { emu_ldmatrix(r, addr, true); }

inline float emu_half(uint64_t w, int high) {
  return __bfloat162float({(unsigned short)(high ? (w >> 16) & 0xffff : w & 0xffff)});
}

inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int lane = threadIdx.x % 32;
  uint64_t* mine = emu_lane(lane);
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b0;
  mine[5] = b1;
  emu_warp_sync();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    const uint64_t* w = emu_lane(l);
    for (int h = 0; h < 2; ++h) {
      A[g][2 * t + h] = emu_half(w[0], h);
      A[g + 8][2 * t + h] = emu_half(w[1], h);
      A[g][2 * t + 8 + h] = emu_half(w[2], h);
      A[g + 8][2 * t + 8 + h] = emu_half(w[3], h);
      B[2 * t + h][g] = emu_half(w[4], h);
      B[2 * t + 8 + h][g] = emu_half(w[5], h);
    }
  }
  emu_warp_sync();
  const int g = lane / 4, t = lane % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float s = d[e];
    for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
    d[e] = s;
  }
}

}  // namespace mma_sm90
