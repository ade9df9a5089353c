// The 3xTF32 products and shared-memory tiles of the f32 flash-attention
// kernels (flash_attention_fwd.cu flash_fwd_kernel, flash_attention_bwd.cu
// flash_bwd_dq_kernel and flash_bwd_dkv_kernel), on the TF32 wgmma of
// wgmma_sm90.cuh.
//
// An f32 operand x goes in as hi = tf32(x) and lo = tf32(x - hi) (cvt.rna;
// wgmma_sm90::split_tf32), and each product A*B as A_hi*B_hi + A_hi*B_lo +
// A_lo*B_hi accumulated in f32: ~2^-21 of each product against f32's 2^-24,
// where one TF32 product (A_hi*B_hi alone) keeps 2^-11 and fails the f32
// bounds. Shared-memory operands are split by the producer warps as they
// write the tiles; P and dS are split in registers from their accumulators.
//
// TF32 wgmma reads both operands K-major. The products whose reduction runs
// over keys (P*V, dS*K) need V and K with the keys along the row: the
// producer writes such a transposed tile [D, BN] beside the stored [BN, D]
// one (dK/dV's products P^T*dO and dS^T*Q, reducing over queries, likewise
// need dO^T and Q^T: there the queries take the keys' part below), the
// keys of each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7
// (key 8m + 2i + h at place 8m + 4h + i). The accumulator of S (or dP)
// gives lane (g, t) keys 2t and 2t+1 of each group of 8, and the A operand
// of a k8 step wants its columns t and t+4: with the keys so permuted those
// are the same values, so an accumulator block is the A operand as it
// stands (split_a_tf32), with no shuffle between lanes (FlashAttention-3's
// FP8 path permutes the same way).
#pragma once

#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace flash_tf32 {

// The SW-byte swizzle of byte offset a in a 1024-byte aligned tile: the
// 16-byte chunk bits [4, 4 + log2(SW/16)) XORed with the bits from 7 up.
__device__ __forceinline__ uint32_t swz(uint32_t a, int sw) {
  return a ^ (((a >> 7) & (uint32_t)(sw / 16 - 1)) << 4);
}

// The byte offset of element (r, c) of a [rows, cols] f32 tile laid as
// K-major panels [rows, SW/4] of SW bytes a row, each rows * SW bytes (what
// TMA writes with a box {SW/4, rows, 1} in the SW-byte swizzle).
template <int SW> __device__ __forceinline__ uint32_t tile_at(int r, int c, int rows) {
  constexpr int W = SW / 4;
  return swz((uint32_t)((c / W) * rows * SW + r * SW + (c % W) * 4), SW);
}

// The byte offset of the k8 slice kd (columns 8kd..8kd+7) of such a tile:
// its panel, then 32 bytes a slice along the swizzled row.
template <int SW> __device__ __forceinline__ uint32_t kslice8(int kd, int rows) {
  constexpr int W = SW / 4;
  return (8 * kd / W) * rows * SW + (8 * kd % W) * 4;
}

struct SplitTf32 {
  uint32_t hi[4], lo[4];
};

// The A operand of the k8 step over one n8 accumulator block (keys
// permuted by kperm), split into hi and lo: a0 (g, t) is accumulator (g,
// 2t), a1 (g+8, 2t), a2 (g, 2t+1), a3 (g+8, 2t+1).
__device__ __forceinline__ SplitTf32 split_a_tf32(const float (&c)[4]) {
  SplitTf32 s;
  wgmma_sm90::split_tf32(c[0], s.hi[0], s.lo[0]);
  wgmma_sm90::split_tf32(c[2], s.hi[1], s.lo[1]);
  wgmma_sm90::split_tf32(c[1], s.hi[2], s.lo[2]);
  wgmma_sm90::split_tf32(c[3], s.hi[3], s.lo[3]);
  return s;
}

// d (+)= A * B for f32 A and B given as hi/lo TF32 tiles (descriptors),
// the small products first; accumulate = false overwrites d.
template <int NB>
__device__ __forceinline__ void wgmma_3xtf32_ss(float (&d)[NB][4], uint64_t a_hi, uint64_t a_lo,
                                                uint64_t b_hi, uint64_t b_lo, bool accumulate) {
  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_lo, accumulate);
  wgmma_sm90::wgmma_tf32_ss(d, a_lo, b_hi, true);
  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_hi, true);
}

// The same with A's lo part from registers (the k8 step's A fragment in
// mma.m16n8k8.tf32's layout, wgmma_sm90.cuh) and its hi part from a tile.
template <int NB>
__device__ __forceinline__ void wgmma_3xtf32_sr(float (&d)[NB][4], uint64_t a_hi,
                                                const uint32_t (&a_lo)[4], uint64_t b_hi,
                                                uint64_t b_lo, bool accumulate) {
  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_lo, accumulate);
  wgmma_sm90::wgmma_tf32_rs(d, a_lo, b_hi, true);
  wgmma_sm90::wgmma_tf32_ss(d, a_hi, b_hi, true);
}

// d += A * B with A from registers (split_a_tf32) and B as hi/lo tiles.
template <int NB>
__device__ __forceinline__ void wgmma_3xtf32_rs(float (&d)[NB][4], const SplitTf32& a,
                                                uint64_t b_hi, uint64_t b_lo) {
  wgmma_sm90::wgmma_tf32_rs(d, a.hi, b_lo, true);
  wgmma_sm90::wgmma_tf32_rs(d, a.lo, b_hi, true);
  wgmma_sm90::wgmma_tf32_rs(d, a.hi, b_hi, true);
}

// Splits `bytes` of f32 at `tile` in place: hi stays, lo goes to the same
// offset at `lo` (unless null); thread `tid` of `n`, 16 bytes a step.
__device__ __forceinline__ void split_in_place(char* tile, char* lo, int bytes, int tid, int n) {
  for (int i = 16 * tid; i < bytes; i += 16 * n) {
    const float4 x = *reinterpret_cast<const float4*>(tile + i);
    uint4 h, l;
    wgmma_sm90::split_tf32(x.x, h.x, l.x);
    wgmma_sm90::split_tf32(x.y, h.y, l.y);
    wgmma_sm90::split_tf32(x.z, h.z, l.z);
    wgmma_sm90::split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(tile + i) = h;
    if (lo != nullptr) *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// One ring stage's key tiles, from the raw f32 [BN, D] tiles TMA wrote to
// their hi/lo TF32 forms; thread `tid` of `n`. FWD (the forward): the stage
// is [K hi | K lo | V^T hi | V^T lo], raw K landed in K hi and raw V in K
// lo (or both in `raw`, K then V, where given); !FWD (dQ): [K hi | K lo |
// V hi | V lo | K^T hi | K^T lo], raw K in K hi and raw V in V hi; with
// BOTH_T (dK/dV, whose stages hold queries: Q in K's place, dO in V's)
// also V^T hi | V^T lo after them. Each
// thread takes 4 keys (8g + 2i + h, i = 0..3) at one column d: it reads
// them before it writes any of their places, and no other thread reads
// them, so the tiles convert in place; their transposed hi/lo land as one
// 16-byte chunk of row d, at places 8g' + 4h + i (g' = g >> 1, h = g & 1).
template <int D, int BN, bool FWD, bool BOTH_T = false>
__device__ __forceinline__ void split_keys(char* stage, int tid, int n,
                                           const char* raw = nullptr) {
  constexpr int SW = D * 4 < 128 ? D * 4 : 128;
  constexpr int VSW = BN * 4 < 128 ? BN * 4 : 128;
  constexpr int TILE = BN * D * 4;
  char* const kh = stage;
  char* const kl = stage + TILE;
  char* const vh = FWD ? kl : stage + 2 * TILE;  // raw V
  char* const vl = stage + 3 * TILE;             // dQ only
  char* const th = stage + (FWD ? 2 : 4) * TILE;
  char* const tl = th + TILE;
  const char* const k_src = raw != nullptr ? raw : kh;
  const char* const v_src = raw != nullptr ? raw + TILE : vh;
  for (int it = tid; it < D * BN / 4; it += n) {
    const int d = it % D, g = it / D;  // g: the group of 8 keys, then the half
    uint32_t off[4];
    float k[4], v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      off[i] = tile_at<SW>(8 * (g >> 1) + 2 * i + (g & 1), d, BN);
      k[i] = *reinterpret_cast<const float*>(k_src + off[i]);
      v[i] = *reinterpret_cast<const float*>(v_src + off[i]);
    }
    uint4 kh4, kl4, vh4, vl4;
    wgmma_sm90::split_tf32(k[0], kh4.x, kl4.x);
    wgmma_sm90::split_tf32(k[1], kh4.y, kl4.y);
    wgmma_sm90::split_tf32(k[2], kh4.z, kl4.z);
    wgmma_sm90::split_tf32(k[3], kh4.w, kl4.w);
    wgmma_sm90::split_tf32(v[0], vh4.x, vl4.x);
    wgmma_sm90::split_tf32(v[1], vh4.y, vl4.y);
    wgmma_sm90::split_tf32(v[2], vh4.z, vl4.z);
    wgmma_sm90::split_tf32(v[3], vh4.w, vl4.w);
    const uint32_t at = tile_at<VSW>(d, 4 * g, D);  // = 8(g >> 1) + 4(g & 1)
    *reinterpret_cast<uint4*>(th + at) = FWD ? vh4 : kh4;
    *reinterpret_cast<uint4*>(tl + at) = FWD ? vl4 : kl4;
    if (BOTH_T) {
      *reinterpret_cast<uint4*>(th + 2 * TILE + at) = vh4;
      *reinterpret_cast<uint4*>(tl + 2 * TILE + at) = vl4;
    }
    const uint32_t khs[4] = {kh4.x, kh4.y, kh4.z, kh4.w}, kls[4] = {kl4.x, kl4.y, kl4.z, kl4.w};
    const uint32_t vhs[4] = {vh4.x, vh4.y, vh4.z, vh4.w}, vls[4] = {vl4.x, vl4.y, vl4.z, vl4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      *reinterpret_cast<uint32_t*>(kh + off[i]) = khs[i];
      *reinterpret_cast<uint32_t*>(kl + off[i]) = kls[i];
      if (!FWD) {
        *reinterpret_cast<uint32_t*>(vh + off[i]) = vhs[i];
        *reinterpret_cast<uint32_t*>(vl + off[i]) = vls[i];
      }
    }
  }
}

// The exchange of a head-dim split over a cluster of 2 (the f32 dQ and
// dK/dV at D = 256), the `it`-th of a consumer thread: it sends its partial
// accumulators `acc...` (NT fragments of 4 each) to its slot of the
// partner's inbox at `partner_slot` once the partner has read the last ones
// (`x_free`), takes the partner's from its own slot `in` once `x_ready`
// says they are there, and adds the two in rank order, so that both blocks
// hold the same sums. A slot holds fragment jj of the a-th accumulator at
// float4 N jj + a (N accumulators).
template <int NT, typename... Acc>
__device__ __forceinline__ void add_partner_partials(uint32_t partner_slot, const float* in,
                                                     uint32_t x_ready, uint32_t x_free,
                                                     int rank, int it, Acc&... acc) {
  using namespace wgmma_sm90;
  constexpr int N = sizeof...(Acc);
  if (it > 0) mbar_wait_cluster(x_free, (it - 1) & 1);
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    uint32_t at = partner_slot + 16 * N * jj;
    ((st_cluster_v4(at, make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3])), at += 16),
     ...);
  }
  mbar_arrive_cluster(map_to_rank(x_ready, rank ^ 1));
  mbar_wait_cluster(x_ready, it & 1);
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    const float4* y = reinterpret_cast<const float4*>(in) + N * jj;
    auto add = [&](float (&x)[4]) {
      const float ys[4] = {y->x, y->y, y->z, y->w};
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = rank == 0 ? x[e] + ys[e] : ys[e] + x[e];
      ++y;
    };
    (add(acc[jj]), ...);
  }
  mbar_arrive_cluster(map_to_rank(x_free, rank ^ 1));
}

}  // namespace flash_tf32
