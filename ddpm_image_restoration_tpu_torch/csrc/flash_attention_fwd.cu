// Flash-attention forward for Hopper (sm_90a), over [BH, T, D] row-major.
//
// Replaces the Pallas TPU kernel `_kernel` launched by `_flash_bhtd` (the
// JAX package's ops/pallas/flash_attention.py:51,141): the
// online-softmax recurrence over key blocks, with the running max, normaliser
// and output accumulator kept in f32, sm_scale = 1/sqrt(D), and an optional
// per-query log-sum-exp. Padded keys are never visited instead of being
// masked to -1e30, and neither D nor the LSE is padded to 128 lanes: the LSE
// is a plain [BH, T] f32 array.
//
// What bounds it on the H100: at the UNet's shapes (T = 1024, D = 16 or 32)
// attention does 4*T*D flops for every 4*D*elt bytes of Q/K/V/O it must move,
// i.e. ~500 flops per byte at T = 1024 in bf16, so it is compute bound. Two
// designs, one per dtype:
//
// bf16: flash_fwd_mma_kernel, products on the tensor cores
// (`mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, flash_mma.cuh).
//   * one block of 4 warps owns one (bh, 64-query tile), 16 query rows a
//     warp; Q's A fragments are loaded once with ldmatrix;
//   * K and V stream as bf16 through a double-buffered shared-memory ring,
//     BN keys a tile, with 16-byte cp.async that zero-fills past T;
//   * S = Q*K^T by D/16 mma k-steps with f32 accumulation, scaled by
//     sm_scale*log2(e) in f32 on the accumulator; the online softmax runs on
//     the accumulator fragment (row max and sum over the 4 lanes of a quad,
//     keys >= T masked to -inf, l summed from the unrounded f32 p);
//   * P*V: P's accumulator fragment is repacked in registers as the A
//     operand, with V's B fragments from ldmatrix.trans. P is split into
//     hi = bf16(p) and lo = bf16(p - hi) and O += P_hi*V + P_lo*V: one bf16
//     rounding of P (as FlashAttention-2 does) moves O by several bf16 steps
//     against the f32 plain version, where the split keeps it within one.
//   At D <= 32 a score tile is only 1-2 mma k-steps, so exp2 and the row
//   bookkeeping on the CUDA cores, not the tensor cores, set the pace.
//
// f32: flash_fwd_kernel, products on the CUDA cores in f32 (FMA):
//   * one block owns one (bh, query tile); K and V stream through shared
//     memory a tile at a time, so each key is read from device memory once
//     per query tile and from shared memory by every row of the tile;
//   * each query row is split over TPR = D/8 adjacent lanes that each hold 8
//     interleaved dims of q and of the accumulator in registers (interleaving
//     keeps the lanes of one row on different shared-memory banks); a row's
//     score is the xor-shuffle sum of its lanes' partial dot products, so
//     every lane holds the same running max and normaliser;
//   * keys are processed in chunks of 16: the chunk's scores sit in
//     registers, the accumulator is rescaled once per chunk, and exp2 with
//     log2(e) folded into the scale replaces exp.
//
// Build (plain C interface, no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using mma_sm90::bf16;

constexpr int kThreads = 256;
constexpr int kDimsPerLane = 8;
constexpr int kChunk = 16;
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int t_len, float scale_log2) {
  constexpr int TPR = D / kDimsPerLane;          // lanes per query row
  constexpr int ROWS = kThreads / TPR;           // query rows per block
  constexpr int BN = D >= 128 ? 32 : 64;         // keys per shared-memory tile
  __shared__ float k_s[BN][D];
  __shared__ float v_s[BN][D];

  const int bh = blockIdx.y;
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool row_ok = row < t_len;
  const size_t base = (size_t)bh * t_len * D;

  float qr[kDimsPerLane];
  float acc[kDimsPerLane];
#pragma unroll
  for (int j = 0; j < kDimsPerLane; ++j) {
    const int d = sub + j * TPR;
    qr[j] = row_ok ? q[base + (size_t)row * D + d] * scale_log2 : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY;  // running max, in log2 units
  float l = 0.f;        // running normaliser

  for (int k0 = 0; k0 < t_len; k0 += BN) {
    const int n_valid = min(BN, t_len - k0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < BN * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = r < n_valid;
      const size_t g = base + (size_t)(k0 + r) * D + c;
      k_s[r][c] = ok ? k[g] : 0.f;
      v_s[r][c] = ok ? v[g] : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < n_valid; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) a = fmaf(qr[e], k_s[c0 + j][sub + e * TPR], a);
        s[j] = a;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      }
      float m_chunk = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j >= n_valid) s[j] = -INFINITY;  // ragged last tile
        m_chunk = fmaxf(m_chunk, s[j]);
      }
      // m_chunk is finite: the chunk holds at least one real key.
      const float m_new = fmaxf(m, m_chunk);
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < kDimsPerLane; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(s[j] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < kDimsPerLane; ++e) acc[e] = fmaf(p, v_s[c0 + j][sub + e * TPR], acc[e]);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv_l = 1.f / l;
#pragma unroll
    for (int j = 0; j < kDimsPerLane; ++j) {
      o[base + (size_t)row * D + sub + j * TPR] = acc[j] * inv_l;
    }
    if (lse != nullptr && sub == 0) {
      // back from log2 to natural units: lse = ln(2) * (m + log2(l))
      lse[(size_t)bh * t_len + row] = kLn2 * (m + log2f(l));
    }
  }
}

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kMmaRows = 64;

template <int D> struct MmaFwd {
  static constexpr int BN = D >= 128 ? 32 : 64;  // keys per tile: 48 KB of shared memory at D = 128
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int t_len, float scale_log2) {
  using namespace mma_sm90;
  using Tile = SmemTile<D>;
  constexpr int BN = MmaFwd<D>::BN;
  constexpr int KD = D / 16;   // mma k-steps over the head dim (S = Q K^T)
  constexpr int NS = BN / 8;   // n8 tiles of S per key tile
  constexpr int KN = BN / 16;  // mma k-steps over the keys of a tile (O += P V)
  constexpr int NO = D / 8;    // n8 tiles of O
  __shared__ __align__(128) bf16 q_s[kMmaRows * D];
  __shared__ __align__(128) bf16 k_s[2][BN * D];
  __shared__ __align__(128) bf16 v_s[2][BN * D];

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kMmaRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const size_t base = (size_t)bh * t_len * D;
  const int n_tiles = (t_len + BN - 1) / BN;

  Tile::template load<kMmaRows, kMmaThreads>(smem_addr(q_s), q + base + (size_t)m0 * D, t_len - m0);
  Tile::template load<BN, kMmaThreads>(smem_addr(k_s[0]), k + base, t_len);
  Tile::template load<BN, kMmaThreads>(smem_addr(v_s[0]), v + base, t_len);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8, log2 units
  float l_row[2] = {0.f, 0.f};              // this lane's share of their normalisers

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int k0 = it * BN;
    if (it + 1 < n_tiles) {  // the next tile streams in while this one is used
      const int k1 = k0 + BN;
      Tile::template load<BN, kMmaThreads>(smem_addr(k_s[stage ^ 1]), k + base + (size_t)k1 * D,
                                           t_len - k1);
      Tile::template load<BN, kMmaThreads>(smem_addr(v_s[stage ^ 1]), v + base + (size_t)k1 * D,
                                           t_len - k1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], smem_addr(q_s) + Tile::off(warp * 16 + (lane & 15), 2 * kd + (lane >> 4)));
    }

    // S = Q K^T for this warp's 16 rows and the tile's BN keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint32_t kb = smem_addr(k_s[stage]);
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t b[4];
        ldmatrix_x4(b, kb + Tile::off(8 * j + (lane & 7) + ((lane >> 4) << 3),
                                      2 * kd + ((lane >> 3) & 1)));
        mma_bf16(s[j], qf[kd], b[0], b[1]);
        mma_bf16(s[j + 1], qf[kd], b[2], b[3]);
      }
    }

    // online softmax on the accumulator fragment
    const int n_valid = t_len - k0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (n_valid < BN && 8 * j + 2 * tq + (e & 1) >= n_valid) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);  // finite: the tile has a real key
      alpha[r] = exp2f(m_row[r] - m_new);
      m_row[r] = m_new;
      l_row[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_row[e >> 1]);
        s[j][e] = p;
        l_row[e >> 1] += p;
      }
    }

    // O += (P_hi + P_lo) V
    const uint32_t vb = smem_addr(v_s[stage]);
#pragma unroll
    for (int kn = 0; kn < KN; ++kn) {
      const Split p = split_a(s[2 * kn], s[2 * kn + 1]);
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + Tile::off(16 * kn + (lane & 15), j + (lane >> 4)));
        mma_split(acc[j], p, b[0], b[1]);
        mma_split(acc[j + 1], p, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + warp * 16 + g + 8 * r;
    if (row >= t_len) continue;
    const float inv_l = 1.f / l_row[r];
    bf16* out = o + base + (size_t)row * D + 2 * tq;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * r] * inv_l, acc[j][2 * r + 1] * inv_l);
    }
    if (lse != nullptr && tq == 0) {
      // back from log2 to natural units: lse = ln(2) * (m + log2(l))
      lse[(size_t)bh * t_len + row] = kLn2 * (m_row[r] + log2f(l_row[r]));
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int t, float sm_scale, cudaStream_t stream) {
  constexpr int ROWS = kThreads / (D / kDimsPerLane);
  const dim3 grid((t + ROWS - 1) / ROWS, bh);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), t, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int t, float sm_scale, cudaStream_t stream) {
  const dim3 grid((t + kMmaRows - 1) / kMmaRows, bh);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), t, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int t, int dtype, float sm_scale, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(q, k, v, o, lse, bh, t, sm_scale, stream);
  if (dtype == 1) return launch_bf16<D>(q, k, v, o, lse, bh, t, sm_scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (tensor-core kernel). lse
// may be null. q, k, v and o must be 16-byte aligned for bf16. Returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for an unsupported d
// or dtype).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int t, int d, int dtype,
                                   float sm_scale, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch<16>(q, k, v, o, lse, bh, t, dtype, sm_scale, s);
    case 32: return (int)launch<32>(q, k, v, o, lse, bh, t, dtype, sm_scale, s);
    case 64: return (int)launch<64>(q, k, v, o, lse, bh, t, dtype, sm_scale, s);
    case 128: return (int)launch<128>(q, k, v, o, lse, bh, t, dtype, sm_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
