// Flash-attention backward for Hopper (sm_90a), over [BH, T, D] row-major.
//
// Replaces the two Pallas TPU kernels launched by `_flash_bhtd_bwd` (the JAX
// package's ops/pallas/flash_attention.py:304): `_bwd_dq_kernel` (:207) and
// `_bwd_dkv_kernel` (:247). With S = scale*Q*K^T, P = exp(S - LSE) and
// Delta = rowsum(dO o O):
//
//   dQ = scale * (P o (dO*V^T - Delta)) * K          flash_bwd_dq_mma_kernel (bf16)
//                                                    flash_bwd_dq_kernel (f32)
//   dV = P^T * dO,  dK = scale * dS^T * Q            flash_bwd_dkv_mma_kernel (bf16)
//                                                    flash_bwd_dkv_kernel (f32)
//
// LSE is the forward kernel's [BH, T] f32 log-sum-exp in natural units
// (csrc/flash_attention_fwd.cu stores ln2 * (m + log2 l) with m in log2
// units); the kernels multiply it by log2(e) and evaluate P as
// exp2(scale*log2(e) * q.k - LSE*log2(e)), the forward's own exp2 form.
// scale = 1/sqrt(real head dim), passed in by the wrapper, never taken from
// the padded D.
//
// The TPU grid runs in order on one core and carries the dQ (or dK/dV) sum
// in scratch across the inner grid axis. Here blocks run in parallel and in
// no order, so the inner axis becomes a loop inside the block: dQ takes one
// block per (bh, query tile) looping over key tiles, dK/dV one block per
// (bh, key tile) looping over query tiles. No atomics: every output element
// is written by one thread, once, and results are deterministic. Delta is
// computed by the dQ kernel (whose block holds its queries' dO and O rows)
// and written to a [BH, T] f32 buffer that the dK/dV kernel, launched after
// it on the same stream, reads; so there is no separate pre-pass.
//
// What bounds it on the H100: dQ does 6*T*D and dK/dV 8*T*D flops per query
// row against ~6*D*elt bytes per row, so at T = 1024 both are compute bound.
//
// In bf16 both kernels run their products on the tensor cores
// (`mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, flash_mma.cuh),
// one block of 4 warps per (bh, 64-row tile), 16 rows a warp, the rows'
// operands held in registers as A fragments for the whole loop and the
// other side streamed through a double-buffered cp.async ring (zero-filled
// past T). P and dS are each split into hi = bf16(x) and lo = bf16(x - hi),
// two products against the same B fragment, since one bf16 rounding moves
// dQ, dK and dV by several bf16 steps against the f32 plain version.
//
// dQ (flash_bwd_dq_mma_kernel) works in the untransposed frame, queries as
// the M rows: Q and dO are A fragments, with each row's LSE and Delta (from
// the bf16 O and dO rows, in f32) in the registers of its quad; K and V
// stream. S = Q*K^T and dP = dO*V^T (B fragments from K and V by ldmatrix),
// P = exp2(S*c - LSE) and dS = P o (dP - Delta) on the accumulators, which
// repack in registers into the A operand of dQ += dS*K (B by ldmatrix.trans
// on the same K tile). Key columns >= T get P = 0 explicitly.
//
// dK/dV (flash_bwd_dkv_mma_kernel) works in the transposed frame, keys as
// the M rows: K and V are A fragments; Q and dO stream with the tile's LSE
// and Delta beside them. S^T = K*Q^T and dP^T = V*dO^T, P^T = exp2(S^T*c -
// LSE) and dS^T = P^T o (dP^T - Delta) on the accumulators, then dV +=
// P^T*dO and dK += dS^T*Q (B by ldmatrix.trans). Query rows >= T get P = 0
// explicitly (a zero-filled LSE would give exp2(0) = 1).
//
// In f32 both run on the CUDA cores in f32 FMA (67 TFLOP/s ceiling).
// Layout: each row owned by a block is split over TPR = D/8 adjacent lanes
// that each hold 8 interleaved dims (so the lanes of one row read different
// shared-memory banks); dot products are the xor-shuffle sum of the lanes'
// partials; the streamed operand tiles sit in shared memory; 16 partner
// rows are processed per chunk so that their shuffles and exp2s overlap.
//
// Build (plain C interface, no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDimsPerLane = 8;
constexpr int kChunk = 16;
constexpr float kLog2e = 1.4426950408889634f;

template <int D> struct Tile {
  static constexpr int TPR = D / kDimsPerLane;   // lanes per owned row
  static constexpr int ROWS = kThreads / TPR;    // owned rows per block
  static constexpr int BN = D >= 128 ? 32 : 64;  // streamed rows per shared tile
};

// Loads rows [r0, r0 + BN) of a [T, D] slab into a f32 shared tile, zeros
// past n_valid.
template <int D, int BN>
__device__ __forceinline__ void load_tile(float (*dst)[D], const float* __restrict__ src,
                                          int n_valid) {
  for (int i = threadIdx.x; i < BN * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r][c] = r < n_valid ? src[(size_t)r * D + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dq, float* __restrict__ delta, int t_len,
                    float scale, float scale_log2) {
  constexpr int TPR = Tile<D>::TPR, ROWS = Tile<D>::ROWS, BN = Tile<D>::BN;
  __shared__ float k_s[BN][D];
  __shared__ float v_s[BN][D];

  const int bh = blockIdx.y;
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool row_ok = row < t_len;
  const size_t base = (size_t)bh * t_len * D;
  const size_t row_base = base + (size_t)(row_ok ? row : 0) * D;

  float qr[kDimsPerLane], dor[kDimsPerLane], acc[kDimsPerLane];
  float dsum = 0.f;
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) {
    const int d = sub + e * TPR;
    qr[e] = row_ok ? q[row_base + d] * scale_log2 : 0.f;
    dor[e] = row_ok ? dout[row_base + d] : 0.f;
    dsum = fmaf(dor[e], row_ok ? o[row_base + d] : 0.f, dsum);
    acc[e] = 0.f;
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, off);
  const size_t stat = (size_t)bh * t_len + row;
  const float lse_log2 = row_ok ? lse[stat] * kLog2e : 0.f;
  if (row_ok && sub == 0) delta[stat] = dsum;

  for (int k0 = 0; k0 < t_len; k0 += BN) {
    const int n_valid = min(BN, t_len - k0);
    __syncthreads();  // previous tile fully consumed
    load_tile<D, BN>(k_s, k + base + (size_t)k0 * D, n_valid);
    load_tile<D, BN>(v_s, v + base + (size_t)k0 * D, n_valid);
    __syncthreads();

    for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) {
          a = fmaf(qr[e], k_s[c0 + j][sub + e * TPR], a);
          b = fmaf(dor[e], v_s[c0 + j][sub + e * TPR], b);
        }
        s[j] = a;
        dp[j] = b;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
          dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], off);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = (row_ok && c0 + j < n_valid) ? exp2f(s[j] - lse_log2) : 0.f;
        const float ds = p * (dp[j] - dsum);
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) acc[e] = fmaf(ds, k_s[c0 + j][sub + e * TPR], acc[e]);
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) dq[row_base + sub + e * TPR] = acc[e] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int t_len, float scale,
                     float scale_log2) {
  constexpr int TPR = Tile<D>::TPR, ROWS = Tile<D>::ROWS, BN = Tile<D>::BN;
  __shared__ float q_s[BN][D];
  __shared__ float do_s[BN][D];
  __shared__ float lse_s[BN];    // log2 units
  __shared__ float delta_s[BN];

  const int bh = blockIdx.y;
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;  // key row
  const bool row_ok = row < t_len;
  const size_t base = (size_t)bh * t_len * D;
  const size_t row_base = base + (size_t)(row_ok ? row : 0) * D;
  const size_t stat_base = (size_t)bh * t_len;

  float kr[kDimsPerLane], vr[kDimsPerLane], dk_acc[kDimsPerLane], dv_acc[kDimsPerLane];
#pragma unroll
  for (int e = 0; e < kDimsPerLane; ++e) {
    const int d = sub + e * TPR;
    kr[e] = row_ok ? k[row_base + d] * scale_log2 : 0.f;
    vr[e] = row_ok ? v[row_base + d] : 0.f;
    dk_acc[e] = 0.f;
    dv_acc[e] = 0.f;
  }

  for (int q0 = 0; q0 < t_len; q0 += BN) {
    const int n_valid = min(BN, t_len - q0);
    __syncthreads();  // previous tile fully consumed
    load_tile<D, BN>(q_s, q + base + (size_t)q0 * D, n_valid);
    load_tile<D, BN>(do_s, dout + base + (size_t)q0 * D, n_valid);
    for (int i = threadIdx.x; i < BN; i += kThreads) {
      const bool ok = i < n_valid;
      lse_s[i] = ok ? lse[stat_base + q0 + i] * kLog2e : 0.f;
      delta_s[i] = ok ? delta[stat_base + q0 + i] : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) {
          a = fmaf(kr[e], q_s[c0 + j][sub + e * TPR], a);
          b = fmaf(vr[e], do_s[c0 + j][sub + e * TPR], b);
        }
        s[j] = a;
        dp[j] = b;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
          dp[j] += __shfl_xor_sync(0xffffffffu, dp[j], off);
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int i = c0 + j;
        const float p = (row_ok && i < n_valid) ? exp2f(s[j] - lse_s[i]) : 0.f;
        const float ds = p * (dp[j] - delta_s[i]);
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) {
          dv_acc[e] = fmaf(p, do_s[i][sub + e * TPR], dv_acc[e]);
          dk_acc[e] = fmaf(ds, q_s[i][sub + e * TPR], dk_acc[e]);
        }
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int e = 0; e < kDimsPerLane; ++e) {
      dk[row_base + sub + e * TPR] = dk_acc[e] * scale;
      dv[row_base + sub + e * TPR] = dv_acc[e];
    }
  }
}

constexpr int kMmaThreads = 128;  // 4 warps x 16 rows (keys in dK/dV, queries in dQ)
constexpr int kMmaRows = 64;

template <int D> struct MmaDkv {
  // query rows per streamed tile: fewer at wide heads, where the dK and dV
  // accumulators (2*D/8 n8 tiles of 4 f32 a lane) take most registers
  static constexpr int BQ = D <= 32 ? 64 : (D == 64 ? 32 : 16);
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t_len,
                         float scale, float scale_log2) {
  using namespace mma_sm90;
  using Tile = SmemTile<D>;
  constexpr int BQ = MmaDkv<D>::BQ;
  constexpr int KD = D / 16;   // mma k-steps over the head dim (S^T, dP^T)
  constexpr int NQ = BQ / 8;   // n8 tiles of S^T per query tile
  constexpr int KQ = BQ / 16;  // mma k-steps over the queries of a tile (dV, dK)
  constexpr int ND = D / 8;    // n8 tiles of dK and dV
  __shared__ __align__(128) bf16 q_s[2][BQ * D];
  __shared__ __align__(128) bf16 do_s[2][BQ * D];
  __shared__ __align__(16) float lse_s[2][BQ];    // natural units
  __shared__ __align__(16) float delta_s[2][BQ];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int key0 = blockIdx.x * kMmaRows + warp * 16;
  const size_t base = (size_t)bh * t_len * D;
  const size_t stat_base = (size_t)bh * t_len;
  const int n_tiles = (t_len + BQ - 1) / BQ;

  auto load_stage = [&](int stage, int q0) {
    Tile::template load<BQ, kMmaThreads>(smem_addr(q_s[stage]), q + base + (size_t)q0 * D,
                                         t_len - q0);
    Tile::template load<BQ, kMmaThreads>(smem_addr(do_s[stage]), dout + base + (size_t)q0 * D,
                                         t_len - q0);
    if (threadIdx.x < BQ) {
      const int i = threadIdx.x;
      const bool ok = q0 + i < t_len;
      const size_t src = stat_base + (ok ? q0 + i : 0);
      cp_async_4(smem_addr(&lse_s[stage][i]), lse + src, ok);
      cp_async_4(smem_addr(&delta_s[stage][i]), delta + src, ok);
    }
    cp_async_commit();
  };
  load_stage(0, 0);

  // this warp's 16 keys of K and V as A fragments (rows >= T are zero)
  uint32_t kf[KD][4], vf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = key0 + g + 8 * (i & 1);
      const size_t at = base + (size_t)row * D + 16 * kd + 2 * tq + 8 * (i >> 1);
      const bool ok = row < t_len;
      kf[kd][i] = ok ? *reinterpret_cast<const uint32_t*>(k + at) : 0u;
      vf[kd][i] = ok ? *reinterpret_cast<const uint32_t*>(v + at) : 0u;
    }
  }
  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int q0 = it * BQ;
    if (it + 1 < n_tiles) {  // the next tile streams in while this one is used
      load_stage(stage ^ 1, q0 + BQ);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by the tile's BQ queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    const uint32_t qb = smem_addr(q_s[stage]), db = smem_addr(do_s[stage]);
#pragma unroll
    for (int j = 0; j < NQ; j += 2) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint32_t at = Tile::off(8 * j + (lane & 7) + ((lane >> 4) << 3),
                                      2 * kd + ((lane >> 3) & 1));
        uint32_t b[4];
        ldmatrix_x4(b, qb + at);
        mma_bf16(s[j], kf[kd], b[0], b[1]);
        mma_bf16(s[j + 1], kf[kd], b[2], b[3]);
        ldmatrix_x4(b, db + at);
        mma_bf16(dp[j], vf[kd], b[0], b[1]);
        mma_bf16(dp[j + 1], vf[kd], b[2], b[3]);
      }
    }

    // P^T and dS^T on the accumulators; query rows >= T give P = 0
    const int n_valid = t_len - q0;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * tq + c;
        const float lse_log2 = lse_s[stage][col] * kLog2e;
        const float dlt = delta_s[stage][col];
        const bool ok = col < n_valid;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_log2) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt);
        }
      }
    }

    // dV += (P^T_hi + P^T_lo) dO and dK += (dS^T_hi + dS^T_lo) Q
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const Split p = split_a(s[2 * kq], s[2 * kq + 1]);
      const Split ds = split_a(dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        const uint32_t at = Tile::off(16 * kq + (lane & 15), j + (lane >> 4));
        uint32_t b[4];
        ldmatrix_x4_trans(b, db + at);
        mma_split(dv_acc[j], p, b[0], b[1]);
        mma_split(dv_acc[j + 1], p, b[2], b[3]);
        ldmatrix_x4_trans(b, qb + at);
        mma_split(dk_acc[j], ds, b[0], b[1]);
        mma_split(dk_acc[j + 1], ds, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key0 + g + 8 * r;
    if (row >= t_len) continue;
    const size_t at = base + (size_t)row * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          pack_bf16(dk_acc[j][2 * r] * scale, dk_acc[j][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

template <int D> struct MmaDq {
  // keys per streamed tile: fewer at D = 128, where the Q and dO fragments
  // and the dQ accumulator take most registers
  static constexpr int BN = D >= 128 ? 32 : 64;
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int t_len,
                        float scale, float scale_log2) {
  using namespace mma_sm90;
  using Tile = SmemTile<D>;
  constexpr int BN = MmaDq<D>::BN;
  constexpr int KD = D / 16;   // mma k-steps over the head dim (S, dP)
  constexpr int NS = BN / 8;   // n8 tiles of S per key tile
  constexpr int KN = BN / 16;  // mma k-steps over the keys of a tile (dQ)
  constexpr int ND = D / 8;    // n8 tiles of dQ
  __shared__ __align__(128) bf16 k_s[2][BN * D];
  __shared__ __align__(128) bf16 v_s[2][BN * D];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.x * kMmaRows + warp * 16;
  const size_t base = (size_t)bh * t_len * D;
  const int n_tiles = (t_len + BN - 1) / BN;

  auto load_stage = [&](int stage, int k0) {
    Tile::template load<BN, kMmaThreads>(smem_addr(k_s[stage]), k + base + (size_t)k0 * D,
                                         t_len - k0);
    Tile::template load<BN, kMmaThreads>(smem_addr(v_s[stage]), v + base + (size_t)k0 * D,
                                         t_len - k0);
    cp_async_commit();
  };
  load_stage(0, 0);

  // this warp's 16 queries of Q and dO as A fragments (rows >= T are zero),
  // and Delta = rowsum(dO o O) of rows g and g + 8, this lane's columns
  // first, then over the quad
  uint32_t qf[KD][4], dof[KD][4];
  float dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const size_t at = base + (size_t)row * D + 16 * kd + 2 * tq + 8 * (i >> 1);
      const bool ok = row < t_len;
      qf[kd][i] = ok ? *reinterpret_cast<const uint32_t*>(q + at) : 0u;
      dof[kd][i] = ok ? *reinterpret_cast<const uint32_t*>(dout + at) : 0u;
      if (ok) {
        const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(dout + at);
        const __nv_bfloat162 o2 = *reinterpret_cast<const __nv_bfloat162*>(o + at);
        dlt[i & 1] = fmaf(__bfloat162float(d2.x), __bfloat162float(o2.x), dlt[i & 1]);
        dlt[i & 1] = fmaf(__bfloat162float(d2.y), __bfloat162float(o2.y), dlt[i & 1]);
      }
    }
  }
  float lse_log2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 1);
    dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 2);
    const int row = row0 + g + 8 * r;
    const size_t stat = (size_t)bh * t_len + row;
    lse_log2[r] = row < t_len ? lse[stat] * kLog2e : 0.f;
    if (row < t_len && tq == 0) delta[stat] = dlt[r];
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int k0 = it * BN;
    if (it + 1 < n_tiles) {  // the next tile streams in while this one is used
      load_stage(stage ^ 1, k0 + BN);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 queries by the tile's BN keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    const uint32_t kb = smem_addr(k_s[stage]), vb = smem_addr(v_s[stage]);
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint32_t at = Tile::off(8 * j + (lane & 7) + ((lane >> 4) << 3),
                                      2 * kd + ((lane >> 3) & 1));
        uint32_t b[4];
        ldmatrix_x4(b, kb + at);
        mma_bf16(s[j], qf[kd], b[0], b[1]);
        mma_bf16(s[j + 1], qf[kd], b[2], b[3]);
        ldmatrix_x4(b, vb + at);
        mma_bf16(dp[j], dof[kd], b[0], b[1]);
        mma_bf16(dp[j + 1], dof[kd], b[2], b[3]);
      }
    }

    // P and dS on the accumulators; key columns >= T give P = 0 (a
    // zero-filled K gives S = 0, and exp2(0 - LSE) is not 0)
    const int n_valid = t_len - k0;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = n_valid >= BN || 8 * j + 2 * tq + (e & 1) < n_valid;
        const float p = ok ? exp2f(s[j][e] * scale_log2 - lse_log2[r]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dlt[r]);
      }
    }

    // dQ += (dS_hi + dS_lo) K
#pragma unroll
    for (int kn = 0; kn < KN; ++kn) {
      const Split ds = split_a(dp[2 * kn], dp[2 * kn + 1]);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, kb + Tile::off(16 * kn + (lane & 15), j + (lane >> 4)));
        mma_split(acc[j], ds, b[0], b[1]);
        mma_split(acc[j + 1], ds, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= t_len) continue;
    __nv_bfloat16* out = dq + base + (size_t)row * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

template <int D> dim3 grid_for(int bh, int t) {
  return dim3((t + Tile<D>::ROWS - 1) / Tile<D>::ROWS, bh);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int bh,
                      int t, int dtype, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    flash_bwd_dq_kernel<D><<<grid_for<D>(bh, t), kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(dq), static_cast<float*>(delta), t, scale, scale * kLog2e);
  } else if (dtype == 1) {
    const dim3 grid((t + kMmaRows - 1) / kMmaRows, bh);
    flash_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
        static_cast<__nv_bfloat16*>(dq), static_cast<float*>(delta), t, scale,
        scale * kLog2e);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int t, int dtype, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    flash_bwd_dkv_kernel<D><<<grid_for<D>(bh, t), kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), t, scale, scale * kLog2e);
  } else if (dtype == 1) {
    const dim3 grid((t + kMmaRows - 1) / kMmaRows, bh);
    flash_bwd_dkv_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), t, scale,
        scale * kLog2e);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

cudaError_t dq_dispatch(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dq, void* delta, int bh,
                        int t, int d, int dtype, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dq<16>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, s);
    case 32: return launch_dq<32>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, s);
    case 64: return launch_dq<64>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, s);
    case 128: return launch_dq<128>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dkv_dispatch(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh,
                         int t, int d, int dtype, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, s);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, s);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dQ and Delta = rowsum(dO o O) from q, k, v, o, dO ([BH, T, d], dtype 0 =
// float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel; the [BH, T, d]
// tensors must be 16-byte aligned)) and the forward's [BH, T] f32 LSE. dq
// has q's dtype; delta is [BH, T] f32. Returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported d, dtype or
// size).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* dq, void* delta, int bh, int t, int d, int dtype,
                                      float sm_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dq_dispatch(q, k, v, o, dout, lse, dq, delta, bh, t, d, dtype, sm_scale, s);
}

// dK and dV from q, k, v, dO, the LSE and the Delta that
// flash_attention_bwd_dq wrote (launch this after it on the same stream).
// dtype 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel; the
// [BH, T, d] tensors must be 16-byte aligned).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t, int d, int dtype,
                                       float sm_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dkv_dispatch(q, k, v, dout, lse, delta, dk, dv, bh, t, d, dtype, sm_scale, s);
}
