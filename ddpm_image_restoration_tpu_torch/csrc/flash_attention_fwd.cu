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
// bf16: flash_fwd_wgmma_kernel, products by wgmma (wgmma_sm90.cuh).
//
// What bounds it on the H100 at T = 1024 (132 SMs at the clock
// `nvidia-smi --query-gpu=clocks.max.sm` reports, 1980 MHz; per 32 heads):
//   * tensor operations: S = Q*K^T at depth DP = max(D, 16) and P*V twice
//     (P as a bf16 hi/lo pair), 6*T^2*DP flops a head at 989 TFLOP/s:
//     3.3 us at D = 8 and 16, 6.5 us at D = 32, 13 us at D = 64;
//   * the MUFU: T^2 exp2 a head at 16 a clock per SM, 8.0 us whatever D:
//     the floor at D <= 32;
//   * filling the card: a block serves 128 query rows, so a (BH, 1024)
//     call has 8*BH blocks; the restore CLI's BH = 4 gives 32 for 132 SMs.
// The design:
//   * a block is two warpgroups of 64 query rows each (256 threads), two
//     blocks an SM at D <= 32 (ptxas -v: 106 registers at D = 32, 98 at 16
//     and 8, no spills; 145 and 154 at D = 64 and 128, one block an SM).
//     No producer warp: a 288-thread block is capped at 168 registers a
//     thread alone and at 96 two to an SM, where S, P and O spilled, and
//     one block of 288 an SM ran slower on the card than two of 256.
//     Thread 0 issues every load;
//   * TMA from 3-D tensor maps [BH, T, D] with boxes {SW/2, 64, 1}, so rows
//     >= T of a head and the columns 8..15 of D = 8 load as zeros: each
//     warpgroup's Q tile once, and K and V through a ring of STAGES (6 at
//     D <= 64, 4 at 128) stages of 64 keys with full/empty mbarriers (empty
//     counts the 8 warps). The first STAGES tiles load at once; tile j's
//     stage is refilled at the top of iteration j + LAG (3; 2 at D = 128),
//     when both warpgroups have let it go, so STAGES - LAG tiles stay ahead
//     and thread 0 does not wait on the other warpgroup;
//   * S = Q*K^T by wgmma m64n64k16 from two K-major descriptors; P*V by
//     register-A wgmma m64n{SW/2}k16, P's accumulator repacked as the A
//     operand in registers and split into bf16 hi and lo parts (wgmma_split:
//     two products against one MN-major V descriptor), since one bf16
//     rounding of P moves O by several bf16 steps against the f32 plain
//     version;
//   * within a warpgroup, tile j's S product is issued with tile j-1's P*V
//     before tile j's softmax runs on the CUDA cores and the MUFU, and
//     waited for after it (FlashAttention-3's intra-warpgroup pipelining);
//   * exp2 by ex2.approx on the MUFU, the scale folded into one FFMA with
//     the running max; l is summed from the unrounded f32 p; the row max
//     and sum by trees; P's hi/lo split by truncation on the integer pipes
//     (flash_mma.cuh split_a_trunc);
//   * the split over keys: where the grid is short of the card, the key
//     tiles of a row tile are dealt round-robin over a cluster of `split`
//     blocks (tile r, r + split, ... to block r), each keeping its own (m,
//     l, O) in f32; after a cluster barrier block r merges its 128/split
//     rows from every block's shared memory (distributed shared memory:
//     M = max m_k, O = sum 2^(m_k - M) O_k / sum 2^(m_k - M) l_k) and
//     writes them. The rule (fill_split): split = 4, else 2, while blocks *
//     split <= the 132 SMs and split <= the key tiles, at most 2 from D =
//     128: the restore CLI's (4, 1024, 32) takes 4, the AVIF restore's (8,
//     1024, 16) 2, the 1024² path's (4, 1024, 256) and (4, 1024, 128) 2,
//     every larger path shape 1. flash_attention_fwd_split forces it;
//   * D = 8 runs natively: the head dim is zero-filled to the wgmma depth
//     16 by the box, and O is written 8 wide;
//   * D = 256 (the 1024² model's bottleneck): a [64, 256] tile is 32 KB and
//     the two warpgroups' Q tiles 64 KB, so the ring's stages hold 32 keys
//     (32 KB of K and V a stage, 5 stages, 225 KB in all) and S and P take
//     16 f32 a thread beside O's 128 (ptxas -v: 186 registers, no spill).
//     The split's merge area (m, l and O of 128 rows, 132 KB) has no room
//     of its own: it overlays the Q tiles and the ring once every product
//     of the block has run (a __syncthreads before it is written).
//
// f32: flash_fwd_kernel, products on the CUDA cores in f32 (FMA):
//   * one block owns one (bh, query tile); K and V stream through shared
//     memory a tile at a time, so each key is read from device memory once
//     per query tile and from shared memory by every row of the tile;
//   * each query row is split over TPR = D/8 adjacent lanes that each hold 8
//     interleaved dims of q and of the accumulator in registers (16 dims at
//     D = 256, whose tiles of K and V are 16 keys, 32 KB of the 48 KB of
//     static shared memory; interleaving keeps the lanes of one row on
//     different shared-memory banks); a row's
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

using flash_mma::bf16;

constexpr int kThreads = 256;
// dims of a query row a lane holds: 16 at D = 256, so that a row takes 16
// lanes and not the whole warp
template <int D> constexpr int kDimsPerLane = D > 128 ? 16 : 8;
constexpr int kChunk = 16;
constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int t_len, float scale_log2) {
  constexpr int DPL = kDimsPerLane<D>;
  constexpr int TPR = D / DPL;                   // lanes per query row
  constexpr int ROWS = kThreads / TPR;           // query rows per block
  // keys per shared-memory tile: K and V take 2*BN*D*4 bytes of the 48 KB
  // of static shared memory (32 KB at D = 128 and 256)
  constexpr int BN = D > 128 ? 16 : (D == 128 ? 32 : 64);
  __shared__ float k_s[BN][D];
  __shared__ float v_s[BN][D];

  const int bh = blockIdx.y;
  const int sub = threadIdx.x % TPR;
  const int row = blockIdx.x * ROWS + threadIdx.x / TPR;
  const bool row_ok = row < t_len;
  const size_t base = (size_t)bh * t_len * D;

  float qr[DPL];
  float acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
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
        for (int e = 0; e < DPL; ++e) a = fmaf(qr[e], k_s[c0 + j][sub + e * TPR], a);
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
      for (int e = 0; e < DPL; ++e) acc[e] *= alpha;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float p = exp2f(s[j] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[e] = fmaf(p, v_s[c0 + j][sub + e * TPR], acc[e]);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv_l = 1.f / l;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      o[base + (size_t)row * D + sub + j * TPR] = acc[j] * inv_l;
    }
    if (lse != nullptr && sub == 0) {
      // back from log2 to natural units: lse = ln(2) * (m + log2(l))
      lse[(size_t)bh * t_len + row] = kLn2 * (m + log2f(l));
    }
  }
}

constexpr int kWarpgroups = 2;                // warpgroups a block, 64 query rows each
constexpr int kThreadsWg = 128 * kWarpgroups;
constexpr int kBlockRows = 64 * kWarpgroups;  // query rows a block
constexpr int kMaxSplit = 4;

template <int D> struct HopperFwd {
  static constexpr int DP = D < 16 ? 16 : D;              // head dim in shared memory
  static constexpr int SW = 2 * DP < 128 ? 2 * DP : 128;  // bytes a panel row: the swizzle
  static constexpr int W = SW / 2;                        // columns a panel
  static constexpr int PANELS = DP / W;
  static constexpr int NO = W / 8;                        // n8 blocks of O a panel
  // keys a ring stage: 32 at D = 256, where a stage of 64 keys' K and V
  // (64 KB) leaves no room for a ring beside the two Q tiles (64 KB)
  static constexpr int BN = D > 128 ? 32 : 64;
  static constexpr int QTILE = 64 * DP * 2;               // a warpgroup's [64, DP] Q tile
  static constexpr int KTILE = BN * DP * 2;               // a stage's [BN, DP] K or V tile
  // blocks an SM: two at D <= 32, where 128 registers a thread suffice
  static constexpr int MIN_BLOCKS = D <= 32 ? 2 : 1;
  // The ring: STAGES stages of BN keys; the stage of tile j is refilled
  // (with tile j + STAGES) by thread 0 at the top of iteration j + LAG.
  // A warpgroup lets go of tile j in iteration j + 1, so LAG >= 2; 3 gives
  // the other warpgroup an iteration's slack before thread 0 waits on it.
  // STAGES - LAG tiles stay ahead.
  static constexpr int STAGES = D <= 64 ? 6 : (D == 128 ? 4 : 5);
  static constexpr int LAG = D <= 64 ? 3 : 2;
  // From the 1024-aligned base: a Q tile per warpgroup, the ring (a K and
  // a V tile a stage), its barriers (full, empty, then Q's), and (split
  // only) the merge area: m[128], l[128] and O[128][DP], f32. At D = 256
  // the merge area (132 KB) has no room of its own: it overlays the Q
  // tiles and the ring, which are free once both warpgroups' last
  // products have run.
  static constexpr int RING = kWarpgroups * QTILE;
  static constexpr int BARS = RING + STAGES * 2 * KTILE;
  static constexpr int END = BARS + 16 * (STAGES + 1);
  static constexpr int MERGE_BYTES = kBlockRows * (2 + DP) * 4;
  static constexpr bool MERGE_IN_RING = D > 128;
  static constexpr int MERGE = MERGE_IN_RING ? 0 : END;
  // the most blocks fill_split deals a row tile's keys over: 2 from D =
  // 128, where the merge reads 128 rows of D columns from every block
  // (kernel_ab.py --splits on the H100: at (4, 1024, 256) 53.6, 48.5 and
  // 55.8 us unsplit, over 2 and over 4; at (4, 1024, 128) 25.5, 25.2, 31.8)
  static constexpr int MAX_SPLIT = D >= 128 ? 2 : kMaxSplit;
  static_assert(!MERGE_IN_RING || MERGE_BYTES <= BARS, "the merge area overlays the ring");
  static constexpr int smem_bytes(bool split) {
    return 1024 + END + (split && !MERGE_IN_RING ? MERGE_BYTES : 0);
  }
};

// The byte offset of the k16 slice kd of a [rows, DP] K-major tile: its
// panel, then 32 bytes a slice along the swizzled row.
template <int D> __device__ __forceinline__ uint32_t kslice(int kd, int rows) {
  using F = HopperFwd<D>;
  return (16 * kd / F::W) * rows * F::SW + (16 * kd % F::W) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreadsWg, HopperFwd<D>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                       float* __restrict__ lse, int t_len, float scale_log2, int split) {
  using namespace flash_mma;
  using namespace wgmma_sm90;
  using F = HopperFwd<D>;
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  float* const merge = reinterpret_cast<float*>(raw + (base - smem_u32(raw)) + F::MERGE);
  const uint32_t bars = base + F::BARS;
  const uint32_t q_bar = bars + 16 * F::STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F::STAGES + s); };
  auto stage_at = [&](int s) { return base + F::RING + s * 2 * F::KTILE; };  // K, then V

  const int bh = blockIdx.y;
  const int rank = blockIdx.x % split;  // the cluster rank where split > 1
  const int m0 = blockIdx.x / split * kBlockRows;
  const int n_tiles = (t_len + F::BN - 1) / F::BN;
  const int n_local = rank < n_tiles ? (n_tiles - rank + split - 1) / split : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane >> 2, tq = lane & 3;
  const bool loader = threadIdx.x == 0;  // issues every TMA load of the block

  // this block's j-th key tile (K and V) into stage j % STAGES
  auto load_tile = [&](int j) {
    const int st = j % F::STAGES;
    const int k0 = (rank + j * split) * F::BN;
    mbar_arrive_expect_tx(full(st), 2 * F::KTILE);
    for (int pn = 0; pn < F::PANELS; ++pn) {
      tma_load_3d(stage_at(st) + pn * F::BN * F::SW, &k_map, full(st), pn * F::W, k0, bh);
      tma_load_3d(stage_at(st) + F::KTILE + pn * F::BN * F::SW, &v_map, full(st), pn * F::W, k0,
                  bh);
    }
  };
  if (loader) {
    for (int st = 0; st < F::STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kThreadsWg / 32);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(q_bar, kWarpgroups * F::QTILE);
    for (int w = 0; w < kWarpgroups; ++w) {
      for (int pn = 0; pn < F::PANELS; ++pn)
        tma_load_3d(base + w * F::QTILE + pn * 64 * F::SW, &q_map, q_bar, pn * F::W, m0 + 64 * w,
                    bh);
    }
    for (int j = 0; j < F::STAGES && j < n_local; ++j) load_tile(j);
  }
  __syncthreads();

  const uint32_t q_wg = base + wg * F::QTILE;
  float acc[F::PANELS][F::NO][4];
#pragma unroll
  for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
    for (int j = 0; j < F::NO; ++j) acc[pn][j][0] = acc[pn][j][1] = acc[pn][j][2] = acc[pn][j][3] = 0.f;
  }
  float m_row[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8, log2 units
  float l_row[2] = {0.f, 0.f};              // this lane's share of their normalisers
  float s[F::BN / 8][4];                    // S, then P, of one key tile
  Split p[F::BN / 16];                      // P as the A operand of P*V, hi and lo

  auto issue_s = [&](int stage) {  // S = Q K^T
#pragma unroll
    for (int kd = 0; kd < F::DP / 16; ++kd)
      wgmma_ss<0>(s, make_desc(q_wg + kslice<D>(kd, 64), F::SW),
                  make_desc(stage_at(stage) + kslice<D>(kd, F::BN), F::SW), kd > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int stage) {  // O += (P_hi + P_lo) V
    const uint32_t vt = stage_at(stage) + F::KTILE;
#pragma unroll
    for (int kk = 0; kk < F::BN / 16; ++kk) {
#pragma unroll
      for (int pn = 0; pn < F::PANELS; ++pn)
        wgmma_split(acc[pn], p[kk],
                    make_desc(vt + pn * F::BN * F::SW + kk * 16 * F::SW, F::SW));
    }
    wgmma_commit();
  };
  // the online softmax of the tile's scores in s (keys >= n_valid
  // masked), leaving P in s; returns each row's rescale factor. Row
  // maxima and sums go by trees over the lane's BN/4 columns a row, so
  // that their chains are log2(BN/8) deep, not BN/4.
  auto softmax = [&](int n_valid, float (&alpha)[2]) {
    if (n_valid < F::BN) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < F::BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * tq + (e & 1) >= n_valid) s[j][e] = -INFINITY;
      }
    }
    float neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t[F::BN / 8];
#pragma unroll
      for (int j = 0; j < F::BN / 8; ++j) t[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
      for (int w = F::BN / 16; w > 0; w /= 2) {
#pragma unroll
        for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
      }
      float mx = fmaxf(t[0], __shfl_xor_sync(0xffffffffu, t[0], 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[r], mx * scale_log2);  // finite: a real key
      alpha[r] = exp2_approx(m_row[r] - m_new);
      m_row[r] = m_new;
      neg_m[r] = -m_new;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t[F::BN / 8];
#pragma unroll
      for (int j = 0; j < F::BN / 8; ++j) {
        s[j][2 * r] = exp2_approx(fmaf(s[j][2 * r], scale_log2, neg_m[r]));
        s[j][2 * r + 1] = exp2_approx(fmaf(s[j][2 * r + 1], scale_log2, neg_m[r]));
        t[j] = s[j][2 * r] + s[j][2 * r + 1];
      }
#pragma unroll
      for (int w = F::BN / 16; w > 0; w /= 2) {
#pragma unroll
        for (int j = 0; j < w; ++j) t[j] += t[j + w];
      }
      l_row[r] = l_row[r] * alpha[r] + t[0];
    }
  };
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < F::BN / 16; ++kk) p[kk] = split_a_trunc(s[2 * kk], s[2 * kk + 1]);
  };
  auto release = [&](int stage) {
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) fence_acc(acc[pn]);
    if (lane == 0) mbar_arrive(empty(stage));
  };

  mbar_wait(q_bar, 0);
  if (n_local > 0) {
    float alpha[2];
    mbar_wait(full(0), 0);
    wgmma_fence();
    issue_s(0);
    wgmma_wait<0>();
    fence_acc(s);
    softmax(t_len - rank * F::BN, alpha);
    split_p();
    for (int j = 1; j < n_local; ++j) {
      const int stage = j % F::STAGES, prev = (j - 1) % F::STAGES;
      const int refill = j - F::LAG + F::STAGES;  // into the stage of tile j - LAG
      if (loader && j >= F::LAG && refill < n_local) {
        mbar_wait(empty(refill % F::STAGES), ((j - F::LAG) / F::STAGES) & 1);
        load_tile(refill);
      }
      mbar_wait(full(stage), (j / F::STAGES) & 1);
      wgmma_fence();
      issue_s(stage);
      issue_pv(prev);
      wgmma_wait<1>();  // S of tile j; tile j-1's P*V runs on under the softmax
      fence_acc(s);
      softmax(t_len - (rank + j * split) * F::BN, alpha);
      wgmma_wait<0>();
      release(prev);
#pragma unroll
      for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
        for (int jo = 0; jo < F::NO; ++jo) {
          acc[pn][jo][0] *= alpha[0];
          acc[pn][jo][1] *= alpha[0];
          acc[pn][jo][2] *= alpha[1];
          acc[pn][jo][3] *= alpha[1];
        }
      }
      split_p();
    }
    wgmma_fence();
    issue_pv((n_local - 1) % F::STAGES);
    wgmma_wait<0>();
    release((n_local - 1) % F::STAGES);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  // the merge area overlays the tiles: every product of both warpgroups
  // has run, and every load has landed, once all threads are here
  if (F::MERGE_IN_RING && split > 1) __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = 64 * wg + 16 * (warp % 4) + g + 8 * r;  // row in the block
    if (split > 1) {  // this block's share of the row, for the merge below
      if (tq == 0) {
        merge[lr] = m_row[r];
        merge[kBlockRows + lr] = l_row[r];
      }
      float* const out = merge + 2 * kBlockRows + lr * F::DP + 2 * tq;
#pragma unroll
      for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
        for (int j = 0; j < F::NO; ++j) {
          out[pn * F::W + 8 * j] = acc[pn][j][2 * r];
          out[pn * F::W + 8 * j + 1] = acc[pn][j][2 * r + 1];
        }
      }
      continue;
    }
    const int row = m0 + lr;
    if (row >= t_len) continue;
    const float inv_l = 1.f / l_row[r];
    bf16* const out = o + ((size_t)bh * t_len + row) * D + 2 * tq;
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
      for (int j = 0; j < F::NO; ++j) {
        if (D >= 16 || 8 * j < D)  // D = 8: the zero-filled columns 8..15 stay unwritten
          *reinterpret_cast<uint32_t*>(out + pn * F::W + 8 * j) =
              pack_bf16(acc[pn][j][2 * r] * inv_l, acc[pn][j][2 * r + 1] * inv_l);
      }
    }
    if (lse != nullptr && tq == 0) {
      // back from log2 to natural units: lse = ln(2) * (m + log2(l))
      lse[(size_t)bh * t_len + row] = kLn2 * (m_row[r] + log2f(l_row[r]));
    }
  }

  if (split > 1) {
    // block `rank` merges rows [rank, rank + 1) * 128 / split from the
    // shares of every block of the cluster
    cluster_sync();
    const int rows = kBlockRows / split;
    const uint32_t at = base + F::MERGE;
    for (int i = threadIdx.x; i < rows * D; i += kThreadsWg) {
      const int lr = rank * rows + i / D, c = i % D;
      const int row = m0 + lr;
      if (row >= t_len) continue;
      float mk[kMaxSplit], top = -INFINITY;
#pragma unroll
      for (int b = 0; b < kMaxSplit; ++b) {
        mk[b] = b < split ? ld_cluster_f32(map_to_rank(at + 4 * lr, b)) : -INFINITY;
        top = fmaxf(top, mk[b]);
      }
      float l = 0.f, sum = 0.f;
#pragma unroll
      for (int b = 0; b < kMaxSplit; ++b) {
        if (b >= split) continue;
        const float w = exp2_approx(mk[b] - top);
        l += w * ld_cluster_f32(map_to_rank(at + 4 * (kBlockRows + lr), b));
        sum += w * ld_cluster_f32(map_to_rank(at + 4 * (2 * kBlockRows + lr * F::DP + c), b));
      }
      o[((size_t)bh * t_len + row) * D + c] = __float2bfloat16(sum / l);
      if (lse != nullptr && c == 0) lse[(size_t)bh * t_len + row] = kLn2 * (top + log2f(l));
    }
    cluster_sync();  // no block leaves while another reads its shared memory
  }
}

// The split over keys that fills the card: 4, else 2 (at most
// `max_split`), while the grid of `blocks` row tiles times the split stays
// within one block an SM and every block of a cluster has a key tile; else
// 1. (kernel_ab.py --splits: at T = 1024 and D = 32 BH = 4 ran fastest
// split 4 ways, 8 split 2, 16 unsplit, where a rule of two blocks an SM
// would have split it.)
int fill_split(int blocks, int key_tiles, int sms, int max_split) {
  int split = 1;
  while (split < max_split && blocks * split * 2 <= sms && split * 2 <= key_tiles) split *= 2;
  return split;
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int bh, int t, float sm_scale, cudaStream_t stream) {
  constexpr int ROWS = kThreads / (D / kDimsPerLane<D>);
  const dim3 grid((t + ROWS - 1) / ROWS, bh);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), t, sm_scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int t, float sm_scale, int split, cudaStream_t stream) {
  namespace host = wgmma_sm90_host;
  using F = HopperFwd<D>;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  const int rows[3] = {64, F::BN, F::BN};  // Q's box is a warpgroup's rows, K's and V's a stage's
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = host::tile_map(&maps[i], src[i], bh, t, D, F::W, rows[i], F::SW);
    if (err != cudaSuccess) return err;
  }
  const int row_tiles = (t + kBlockRows - 1) / kBlockRows;
  if (split == 0)
    split = fill_split(bh * row_tiles, (t + F::BN - 1) / F::BN, host::sm_count(), F::MAX_SPLIT);
  if (split != 1 && split != 2 && split != 4) return cudaErrorInvalidValue;
  static uint64_t allowed = 0;
  cudaError_t err = host::allow_smem(flash_fwd_wgmma_kernel<D>, F::smem_bytes(true), allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * split, bh);
  cfg.blockDim = dim3(kThreadsWg);
  cfg.dynamicSmemBytes = F::smem_bytes(split > 1);
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_wgmma_kernel<D>, maps[0], maps[1], maps[2],
                           static_cast<bf16*>(o), static_cast<float*>(lse), t,
                           sm_scale * kLog2e, split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                   int t, int dtype, float sm_scale, int split, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<D>(q, k, v, o, lse, bh, t, sm_scale, split, stream);
  if constexpr (D >= 16) {  // the f32 kernel is built from D = 16 up
    if (dtype == 0) return launch_f32<D>(q, k, v, o, lse, bh, t, sm_scale, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// As flash_attention_fwd, with the bf16 kernel's split over keys forced:
// split 0 takes fill_split's rule, 1, 2 or 4 that many blocks a cluster
// (the f32 kernel ignores it).
extern "C" int flash_attention_fwd_split(const void* q, const void* k, const void* v, void* o,
                                         void* lse, int bh, int t, int d, int dtype,
                                         float sm_scale, int split, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = wgmma_sm90_host::bind_device();
  if (bound != cudaSuccess) return (int)bound;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return (int)launch<8>(q, k, v, o, lse, bh, t, dtype, sm_scale, split, s);
    case 16: return (int)launch<16>(q, k, v, o, lse, bh, t, dtype, sm_scale, split, s);
    case 32: return (int)launch<32>(q, k, v, o, lse, bh, t, dtype, sm_scale, split, s);
    case 64: return (int)launch<64>(q, k, v, o, lse, bh, t, dtype, sm_scale, split, s);
    case 128: return (int)launch<128>(q, k, v, o, lse, bh, t, dtype, sm_scale, split, s);
    case 256: return (int)launch<256>(q, k, v, o, lse, bh, t, dtype, sm_scale, split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32 (FMA kernel; d >= 16), 1 = bfloat16 (wgmma kernel; d
// = 8 too). lse may be null. q, k, v and o must be 16-byte aligned for bf16. Returns the
// launch's error (cudaErrorInvalidValue for an unsupported d or dtype; the
// tensor maps' or the launch's own error where the card refuses them).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int t, int d, int dtype,
                                   float sm_scale, void* stream) {
  return flash_attention_fwd_split(q, k, v, o, lse, bh, t, d, dtype, sm_scale, 0, stream);
}
