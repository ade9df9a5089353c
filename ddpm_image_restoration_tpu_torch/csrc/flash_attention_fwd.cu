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
// The design at D <= 64 (flash_fwd_wgmma_kernel<D>, fwd_pair):
//   * a block is two warpgroups of 64 query rows each (256 threads), two
//     blocks an SM at D <= 32 (ptxas -v: 106 registers at D = 32, 98 at 16
//     and 8, no spills; 145 at D = 64, one block an SM).
//     No producer warp: a 288-thread block is capped at 168 registers a
//     thread alone and at 96 two to an SM, where S, P and O spilled, and
//     one block of 288 an SM ran slower on the card than two of 256.
//     Thread 0 issues every load;
//   * TMA from 3-D tensor maps [BH, T, D] with boxes {SW/2, 64, 1}, so rows
//     >= T of a head and the columns 8..15 of D = 8 load as zeros: each
//     warpgroup's Q tile once, and K and V through a ring of 6 stages of
//     64 keys with full/empty mbarriers (empty
//     counts the 8 warps). The first STAGES tiles load at once; tile j's
//     stage is refilled at the top of iteration j + LAG (3),
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
//     split <= the 132 SMs and split <= the key tiles: the restore CLI's
//     (4, 1024, 32) takes 4, the AVIF restore's (8, 1024, 16) 2, every
//     larger path shape 1. flash_attention_fwd_split forces it;
//   * D = 8 runs natively: the head dim is zero-filled to the wgmma depth
//     16 by the box, and O is written 8 wide;
//
// D = 128 and 256 (the 1024² model's bottleneck, attended at T = 1024 with
// BH = 4 for one image): the design above filled only 32 row tiles of 128
// at BH = 4 and held 32-key stages at D = 256 (short wgmma chains between
// barriers). Here flash_fwd_wgmma_kernel<D> is warp-specialised (fwd_ws):
//   * a block serves 64 query rows: 384 threads, a producer warpgroup that
//     gives its registers away (setmaxnreg.dec to 40) and whose first
//     thread issues every load, and two consumer warpgroups (setmaxnreg.inc
//     to 232; 168 a thread at launch), so that O (64 or 128 f32 a thread),
//     a 64-key S tile (32 f32) and P's hi/lo parts stay in registers;
//   * the block's Q tile arrives once; K and V through a ring of 64-key
//     stages (6 at D = 128, 3 at D = 256; 208 and 224 KB with Q); the two
//     consumer warpgroups take the block's key tiles in turn (tiles 0, 2,
//     ... and 1, 3, ...), each with its own (m, l, O), so that one's
//     softmax runs while the other's products do; a stage's empty barrier
//     counts the 4 warps of the warpgroup that took it;
//   * the split: a row tile's key tiles dealt over a cluster of `split`
//     blocks as above (fill_split, at most 2 here: (4, 1024, D) gives 64
//     row tiles, 128 blocks); after the products, each warpgroup leaves
//     its (m, l, O) in a merge area laid over Q and the ring, and block r
//     merges rows [r, r + 1) * 64 / split from the 2 * split shares (its
//     own two warpgroups' unsplit), four columns a step; every output
//     element written once, deterministic;
//   * work a head: S once and P*V twice (hi/lo), 6*T^2*D flops: 0.81 GFLOP
//     at D = 128 and 1.61 at D = 256 (T = 1024); at (4, 1024, D) 128
//     blocks for the 132 SMs.
//
// f32: flash_fwd_kernel<D>, at every D (16-256; D = 8 zero-padded to 16
// by the wrapper), on TF32 wgmma with the 3xTF32 split (flash_tf32.cuh):
// every product A*B as A_hi*B_hi + A_hi*B_lo + A_lo*B_hi of TF32 parts,
// accumulated in f32, so that the result keeps f32's accuracy (one TF32
// product fails the f32 bounds). It replaced PR 4's f32 FMA kernel (67
// TFLOP/s ceiling; 0.4412 ms at (4, 1024, 256), 2.95x SDPA in f32).
// What bounds it at T = 1024: S and P*V three times each, 12*T^2*D flops a
// head at 495 TFLOP/s (TF32): 26 us at (4, 1024, 256), 13 at (4, 1024,
// 128); at 67 TFLOP/s (f32 FMA, what the plain f32 function needs) 4*T^2*D
// a head, 64 and 32 us. The design:
//   * a block is C consumer warpgroups of 64 query rows (C = 2 at D <= 64,
//     1 at D = 128 and 256) and a producer warpgroup: its first thread issues every
//     TMA load (f32 tensor maps, zero-filled past T), its warps 1-3 split
//     what lands into TF32 hi/lo tiles in place (split_in_place,
//     split_keys) and arrive on the stage's second barrier; C + 1 times 128
//     threads, no setmaxnreg (C = 2: ptxas's 168 registers a thread hold O,
//     S and P's hi/lo; C = 1: 255);
//   * TF32 wgmma takes both operands K-major, so V must lie with the keys
//     along the row: the splitting warps write V^T hi/lo [D, BN] beside K's
//     hi/lo, keys permuted in groups of 8 (flash_tf32.cuh) so that S's accumulator
//     is P's A operand as it stands (split_a_tf32, no shuffles);
//   * shared memory (227 KB a block): each consumer's Q hi and lo (64 x D
//     x 4 B each), then stages of BN keys holding K hi (raw K lands there),
//     K lo (raw V lands there), V^T hi and V^T lo, 16*BN*D bytes:
//       D = 16:  Q 16 KB, BN 64, 4 stages of 16 KB:  80 KB
//       D = 32:  Q 32 KB, BN 64, 4 stages of 32 KB: 160 KB
//       D = 64:  Q 64 KB, BN 32, 4 stages of 32 KB: 192 KB
//       D = 128: Q 64 KB (C = 1), BN 16, 4 stages of 32 KB: 192 KB
//       D = 256: Q 128 KB (C = 1), BN 16, 1 stage of 64 KB and a raw
//         area of 32 KB where TMA lands K and V: 224 KB; tile j + 1 loads
//         under tile j's products, and its split waits for them (Q's
//         hi/lo alone take 128 KB of the 227);
//   * S = Q*K^T by m64n{BN}k8 from descriptors (Q hi/lo, K hi/lo), P*V by
//     register-A m64n{min(D, 64)}k8 against V^T hi/lo; each warpgroup runs
//     its products and its softmax one after the other;
//   * the split over keys as the bf16 kernel's: where the grid is short of
//     the card, a row tile's key tiles are dealt over a cluster of `split`
//     blocks (fill_split, at most 2, which ran faster than 4 at every f32
//     path shape: (4, 1024, 128) and (4, 1024, 256) take 2, 128 blocks; 4
//     when forced),
//     each block's (m, l, O) merged through distributed shared
//     memory from a merge area laid over Q and the ring; every output
//     element written once, deterministic.
//
// Build (plain C interface, no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"
#include "flash_tf32.cuh"

namespace {

using flash_mma::bf16;

constexpr float kLn2 = 0.69314718055994531f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kWarpgroups = 2;                // warpgroups a block, 64 query rows each
constexpr int kThreadsWg = 128 * kWarpgroups;
constexpr int kBlockRows = 64 * kWarpgroups;  // query rows a block
constexpr int kMaxSplit = 4;

template <int D> struct HopperFwd {
  static_assert(D <= 64, "D = 128 and 256 take HopperFwdWs");
  static constexpr int DP = D < 16 ? 16 : D;              // head dim in shared memory
  static constexpr int SW = 2 * DP < 128 ? 2 * DP : 128;  // bytes a panel row: the swizzle
  static constexpr int W = SW / 2;                        // columns a panel
  static constexpr int PANELS = DP / W;
  static constexpr int NO = W / 8;                        // n8 blocks of O a panel
  static constexpr int BN = 64;                           // keys a ring stage
  static constexpr int QTILE = 64 * DP * 2;               // a warpgroup's [64, DP] Q tile
  static constexpr int KTILE = BN * DP * 2;               // a stage's [BN, DP] K or V tile
  // blocks an SM: two at D <= 32, where 128 registers a thread suffice
  static constexpr int MIN_BLOCKS = D <= 32 ? 2 : 1;
  // The ring: STAGES stages of BN keys; the stage of tile j is refilled
  // (with tile j + STAGES) by thread 0 at the top of iteration j + LAG.
  // A warpgroup lets go of tile j in iteration j + 1, so LAG >= 2; 3 gives
  // the other warpgroup an iteration's slack before thread 0 waits on it.
  // STAGES - LAG tiles stay ahead.
  static constexpr int STAGES = 6;
  static constexpr int LAG = 3;
  // From the 1024-aligned base: a Q tile per warpgroup, the ring (a K and
  // a V tile a stage), its barriers (full, empty, then Q's), and (split
  // only) the merge area: m[128], l[128] and O[128][DP], f32.
  static constexpr int RING = kWarpgroups * QTILE;
  static constexpr int BARS = RING + STAGES * 2 * KTILE;
  static constexpr int END = BARS + 16 * (STAGES + 1);
  static constexpr int MERGE = END;
  static constexpr int MERGE_BYTES = kBlockRows * (2 + DP) * 4;
  static constexpr int MAX_SPLIT = kMaxSplit;
  static constexpr int smem_bytes(bool split) { return 1024 + END + (split ? MERGE_BYTES : 0); }
};

// D = 128 and 256 (the 1024² model's bottleneck): a warp-specialised block
// of 64 query rows (see the file's note). Two consumer warpgroups take the
// block's key tiles in turn, each keeping its own (m, l, O); a producer
// warpgroup's first thread issues every load.
template <int D> struct HopperFwdWs {
  static_assert(D == 128 || D == 256, "the warp-specialised forward is built for D = 128, 256");
  static constexpr int DP = D;
  static constexpr int SW = 128;           // bytes a panel row: the swizzle
  static constexpr int W = 64;             // columns a panel
  static constexpr int PANELS = D / W;
  static constexpr int NO = W / 8;         // n8 blocks of O a panel
  static constexpr int BN = 64;            // keys a ring stage
  static constexpr int ROWS = 64;          // query rows a block
  static constexpr int CONSUMERS = 256;    // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  // registers a thread after setmaxnreg; 40 * 128 + 232 * 256 = 168 * 384,
  // the launch's 168 (65536 registers over 384 threads)
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int QTILE = ROWS * DP * 2;  // the block's [64, DP] Q tile
  static constexpr int KTILE = BN * DP * 2;    // a stage's [64, DP] K or V tile
  // ring stages: as many as fit beside Q in 227 KB
  static constexpr int STAGES = D == 128 ? 6 : 3;
  // From the 1024-aligned base: Q, the ring (a K and a V tile a stage), the
  // barriers (full, empty, then Q's). The merge area (m[2][64], l[2][64],
  // then O[2][64][OSTRIDE] of both warpgroups, f32) overlays Q and the ring
  // once both warpgroups' last products have run; O's rows are padded by 8
  // floats so that the 8 rows a warp writes at once fall on other banks.
  static constexpr int RING = QTILE;
  static constexpr int BARS = RING + STAGES * 2 * KTILE;
  static constexpr int SMEM = 1024 + BARS + 8 * (2 * STAGES + 1);
  static constexpr int OSTRIDE = DP + 8;
  static constexpr int MERGE_O = 2 * 2 * ROWS * 4;  // bytes of m and l before O
  static constexpr int MERGE_BYTES = MERGE_O + 2 * ROWS * OSTRIDE * 4;
  static_assert(MERGE_BYTES <= BARS, "the merge area overlays Q and the ring");
  static_assert(SMEM <= 232448, "227 KB a block");
  // the most blocks fill_split deals a row tile's keys over
  static constexpr int MAX_SPLIT = 2;
};

// Launch shape of flash_fwd_wgmma_kernel<D>.
template <int D> struct FwdLaunch {
  static constexpr bool WS = D >= 128;
  static constexpr int THREADS = WS ? HopperFwdWs<(WS ? D : 128)>::THREADS : kThreadsWg;
  static constexpr int MIN_BLOCKS = WS ? 1 : HopperFwd<(WS ? 64 : D)>::MIN_BLOCKS;
};

// The byte offset of the k16 slice kd of a [rows, DP] K-major tile: its
// panel, then 32 bytes a slice along the swizzled row.
template <class F> __device__ __forceinline__ uint32_t kslice(int kd, int rows) {
  return (16 * kd / F::W) * rows * F::SW + (16 * kd % F::W) * 2;
}

// The online softmax of one key tile's scores in s (a warpgroup's 64 rows
// x BN keys in the wgmma accumulator layout; keys >= n_valid masked),
// leaving P in s, updating each row's running max (log2 units) and this
// lane's share of its normaliser, and returning each row's rescale factor.
// Row maxima and sums go by trees over the lane's BN/4 columns a row, so
// that their chains are log2(BN/8) deep, not BN/4.
template <int BN>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 8][4], float (&m_row)[2],
                                               float (&l_row)[2], int n_valid, int tq,
                                               float scale_log2, float (&alpha)[2]) {
  using wgmma_sm90::exp2_approx;
  if (n_valid < BN) {  // the ragged last tile
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * j + 2 * tq + (e & 1) >= n_valid) s[j][e] = -INFINITY;
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) t[j] = fmaxf(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
    for (int w = BN / 16; w > 0; w /= 2) {
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
    float t[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][2 * r] = exp2_approx(fmaf(s[j][2 * r], scale_log2, neg_m[r]));
      s[j][2 * r + 1] = exp2_approx(fmaf(s[j][2 * r + 1], scale_log2, neg_m[r]));
      t[j] = s[j][2 * r] + s[j][2 * r + 1];
    }
#pragma unroll
    for (int w = BN / 16; w > 0; w /= 2) {
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] += t[j + w];
    }
    l_row[r] = l_row[r] * alpha[r] + t[0];
  }
}

// D <= 64: two warpgroups of 64 query rows, thread 0 loading.
template <int D>
__device__ __forceinline__ void fwd_pair(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                         const CUtensorMap& v_map, bf16* __restrict__ o,
                                         float* __restrict__ lse, int t_len, float scale_log2,
                                         int split) {
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
      wgmma_ss<0>(s, make_desc(q_wg + kslice<F>(kd, 64), F::SW),
                  make_desc(stage_at(stage) + kslice<F>(kd, F::BN), F::SW), kd > 0);
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
    online_softmax<F::BN>(s, m_row, l_row, t_len - rank * F::BN, tq, scale_log2, alpha);
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
      online_softmax<F::BN>(s, m_row, l_row, t_len - (rank + j * split) * F::BN, tq,
                            scale_log2, alpha);
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

// D = 128 and 256: warp-specialised blocks of 64 query rows (the file's
// note). Consumer warpgroup w (threads 0-255) takes the block's key tiles w,
// w + 2, ...; the producer warpgroup (threads 256-383) gives its registers
// to them and its first thread issues every load.
template <int D>
__device__ __forceinline__ void fwd_ws(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                       const CUtensorMap& v_map, bf16* __restrict__ o,
                                       float* __restrict__ lse, int t_len, float scale_log2,
                                       int split) {
  using namespace flash_mma;
  using namespace wgmma_sm90;
  using F = HopperFwdWs<D>;
  constexpr int kConsumerBar = 1;  // named barrier of the two consumer warpgroups
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  char* const area = raw + (base - smem_u32(raw));  // the merge area, after the products
  const uint32_t bars = base + F::BARS;
  const uint32_t q_bar = bars + 16 * F::STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F::STAGES + s); };
  auto stage_at = [&](int s) { return base + F::RING + s * 2 * F::KTILE; };  // K, then V

  const int bh = blockIdx.y;
  const int rank = blockIdx.x % split;  // the cluster rank where split > 1
  const int m0 = blockIdx.x / split * F::ROWS;
  const int n_tiles = (t_len + F::BN - 1) / F::BN;
  const int n_local = rank < n_tiles ? (n_tiles - rank + split - 1) / split : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;

  if (threadIdx.x == 0) {
    for (int st = 0; st < F::STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4);  // the warps of the warpgroup that took the tile
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: the block's Q tile once, then its key tiles in order
    // through the ring, a stage refilled once its warpgroup let it go
    setmaxnreg_dec<F::PRODUCER_REGS>();
    if (threadIdx.x == F::CONSUMERS) {
      mbar_arrive_expect_tx(q_bar, F::QTILE);
      for (int pn = 0; pn < F::PANELS; ++pn)
        tma_load_3d(base + pn * F::ROWS * F::SW, &q_map, q_bar, pn * F::W, m0, bh);
      for (int j = 0; j < n_local; ++j) {
        const int st = j % F::STAGES;
        mbar_wait(empty(st), ((j / F::STAGES) & 1) ^ 1);
        const int k0 = (rank + j * split) * F::BN;
        mbar_arrive_expect_tx(full(st), 2 * F::KTILE);
        for (int pn = 0; pn < F::PANELS; ++pn) {
          tma_load_3d(stage_at(st) + pn * F::BN * F::SW, &k_map, full(st), pn * F::W, k0, bh);
          tma_load_3d(stage_at(st) + F::KTILE + pn * F::BN * F::SW, &v_map, full(st), pn * F::W,
                      k0, bh);
        }
      }
    }
    if (split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  setmaxnreg_inc<F::CONSUMER_REGS>();
  const int g = lane >> 2, tq = lane & 3;
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

  mbar_wait(q_bar, 0);
  for (int j = wg; j < n_local; j += 2) {
    const int st = j % F::STAGES;
    mbar_wait(full(st), (j / F::STAGES) & 1);
    // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < F::DP / 16; ++kd)
      wgmma_ss<0>(s, make_desc(base + kslice<F>(kd, F::ROWS), F::SW),
                  make_desc(stage_at(st) + kslice<F>(kd, F::BN), F::SW), kd > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);
    float alpha[2];
    online_softmax<F::BN>(s, m_row, l_row, t_len - (rank + j * split) * F::BN, tq, scale_log2,
                          alpha);
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
#pragma unroll
    for (int kk = 0; kk < F::BN / 16; ++kk) p[kk] = split_a_trunc(s[2 * kk], s[2 * kk + 1]);
    // O += (P_hi + P_lo) V
    const uint32_t vt = stage_at(st) + F::KTILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::BN / 16; ++kk) {
#pragma unroll
      for (int pn = 0; pn < F::PANELS; ++pn)
        wgmma_split(acc[pn], p[kk], make_desc(vt + pn * F::BN * F::SW + kk * 16 * F::SW, F::SW));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) fence_acc(acc[pn]);
    if (lane == 0) mbar_arrive(empty(st));
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  // the merge area overlays Q and the ring: both warpgroups' products have
  // run, and every load has landed, once both are here
  named_sync(kConsumerBar, F::CONSUMERS);
  float* const m_part = reinterpret_cast<float*>(area);  // [2][64], then l [2][64]
  float* const o_part = reinterpret_cast<float*>(area + F::MERGE_O);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = 16 * (warp % 4) + g + 8 * r;  // row in the block
    if (tq == 0) {
      m_part[wg * F::ROWS + lr] = m_row[r];
      m_part[(2 + wg) * F::ROWS + lr] = l_row[r];
    }
    float* const out = o_part + (wg * F::ROWS + lr) * F::OSTRIDE + 2 * tq;
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
      for (int jo = 0; jo < F::NO; ++jo)
        *reinterpret_cast<float2*>(out + pn * F::W + 8 * jo) =
            make_float2(acc[pn][jo][2 * r], acc[pn][jo][2 * r + 1]);
    }
  }
  if (split > 1) cluster_sync();
  else named_sync(kConsumerBar, F::CONSUMERS);

  // block `rank` merges rows [rank, rank + 1) * 64 / split from the 2 *
  // split shares (each block's two warpgroups'): M = max m_k, O = sum
  // 2^(m_k - M) O_k / sum 2^(m_k - M) l_k, four columns a step
  const int rows = F::ROWS / split;
  const uint32_t m_at = smem_u32(m_part), o_at = smem_u32(o_part);
  for (int i = threadIdx.x; i < rows * (D / 4); i += F::CONSUMERS) {
    const int lr = rank * rows + i / (D / 4), c = 4 * (i % (D / 4));
    const int row = m0 + lr;
    if (row >= t_len) continue;
    float mk[2 * kMaxSplit], top = -INFINITY;
#pragma unroll
    for (int b = 0; b < 2 * kMaxSplit; ++b) {
      mk[b] = b < 2 * split
                  ? ld_cluster_f32(map_to_rank(m_at + 4 * ((b & 1) * F::ROWS + lr), b >> 1))
                  : -INFINITY;
      top = fmaxf(top, mk[b]);
    }
    float l = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int b = 0; b < 2 * kMaxSplit; ++b) {
      if (b >= 2 * split) continue;
      const float w = exp2_approx(mk[b] - top);
      l += w * ld_cluster_f32(map_to_rank(m_at + 4 * ((2 + (b & 1)) * F::ROWS + lr), b >> 1));
      const float4 x = ld_cluster_v4(
          map_to_rank(o_at + 4 * (((b & 1) * F::ROWS + lr) * F::OSTRIDE + c), b >> 1));
      sum.x += w * x.x;
      sum.y += w * x.y;
      sum.z += w * x.z;
      sum.w += w * x.w;
    }
    const float inv_l = 1.f / l;
    uint2 packed;
    packed.x = pack_bf16(sum.x * inv_l, sum.y * inv_l);
    packed.y = pack_bf16(sum.z * inv_l, sum.w * inv_l);
    *reinterpret_cast<uint2*>(o + ((size_t)bh * t_len + row) * D + c) = packed;
    if (lse != nullptr && c == 0) lse[(size_t)bh * t_len + row] = kLn2 * (top + log2f(l));
  }
  if (split > 1) cluster_sync();  // no block leaves while another reads its shared memory
}

template <int D>
__global__ void __launch_bounds__(FwdLaunch<D>::THREADS, FwdLaunch<D>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                       float* __restrict__ lse, int t_len, float scale_log2, int split) {
  if constexpr (FwdLaunch<D>::WS) fwd_ws<D>(q_map, k_map, v_map, o, lse, t_len, scale_log2, split);
  else fwd_pair<D>(q_map, k_map, v_map, o, lse, t_len, scale_log2, split);
}

// f32 (flash_fwd_kernel<D>, every D; see the file's note): C consumer
// warpgroups of 64 query rows each walk the same key tiles through the
// ring, each with its own Q hi/lo tiles and (m, l, O); the producer
// warpgroup's first thread issues every load and its warps 1-3 split each
// tile into its TF32 hi/lo forms (flash_tf32.cuh split_keys).
template <int D> struct F32Fwd {
  // consumer warpgroups: two at D <= 64; one from 128, where two filled
  // only 64 blocks at (4, 1024, 128) (RULE_SPLIT 2) and ran 1.5x slower
  static constexpr int C = D <= 64 ? 2 : 1;
  static constexpr int ROWS = 64 * C;              // query rows a block
  static constexpr int CONSUMERS = 128 * C;
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  static constexpr int SPLITTERS = 96;             // the producer's warps 1-3
  static constexpr int SW = D * 4 < 128 ? D * 4 : 128;  // bytes a row of a [rows, D] tile
  static constexpr int W = SW / 4;                       // columns a panel
  static constexpr int BN = D <= 32 ? 64 : (D == 64 ? 32 : 16);  // keys a ring stage
  static constexpr int VSW = BN * 4 < 128 ? BN * 4 : 128;        // bytes a row of V^T
  static constexpr int NC = D < 64 ? D : 64;       // output columns a P*V product
  static constexpr int QTILE = 64 * D * 4;         // a [64, D] f32 tile
  static constexpr int KTILE = BN * D * 4;         // a [BN, D] (or [D, BN]) f32 tile
  // From the 1024-aligned base: each consumer's Q hi and Q lo; the ring (K
  // hi, where raw K lands; K lo, where raw V lands; V^T hi; V^T lo); the
  // barriers (raw full, split full, empty; then Q's and Q split). As many
  // stages as fit in 227 KB, at most 4.
  static constexpr int RING = C * 2 * QTILE;
  static constexpr int STAGE = 4 * KTILE;
  static constexpr int FIT = (232448 - 1024 - 512 - RING) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // With one stage (D = 256), raw K and V land in an area of their own
  // (RAW), so that the next tile's load runs under this tile's products
  // and only its split waits for them.
  static constexpr bool RAW = STAGES == 1;
  static constexpr int RAW_AT = RING + STAGES * STAGE;
  static constexpr int BARS = RAW_AT + (RAW ? 2 * KTILE : 0);
  static constexpr int SMEM = 1024 + BARS + 8 * (4 * STAGES + 2);
  // The split's merge area (m[ROWS], l[ROWS], then O[ROWS][OSTRIDE], f32)
  // overlays Q and the ring once every product and split has run.
  static constexpr int OSTRIDE = D + 4;
  static constexpr int MERGE_O = 2 * ROWS * 4;
  static constexpr int MERGE_BYTES = MERGE_O + ROWS * OSTRIDE * 4;
  // the most blocks a row tile's keys are dealt over: 4 (forced), and 2 by
  // fill_split (kernel_ab.py --splits: clusters of 4 ran slower than of 2
  // at every f32 path shape, as for the bf16 kernels at D >= 128)
  static constexpr int MAX_SPLIT = 4, RULE_SPLIT = 2;
  static_assert(STAGES >= 1 && SMEM <= 232448, "227 KB a block");
  static_assert(MERGE_BYTES <= BARS, "the merge area overlays Q and the ring");
};

template <int D>
__global__ void __launch_bounds__(F32Fwd<D>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, float* __restrict__ o,
                 float* __restrict__ lse, int t_len, float scale_log2, int split) {
  using namespace wgmma_sm90;
  using namespace flash_tf32;
  using F = F32Fwd<D>;
  constexpr int S = F::STAGES;
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  char* const area = raw + (base - smem_u32(raw));
  const uint32_t bars = base + F::BARS;
  auto raw_full = [&](int s) { return bars + 8 * s; };         // TMA landed
  auto split_full = [&](int s) { return bars + 8 * (S + s); };  // hi/lo written
  auto empty = [&](int s) { return bars + 8 * (2 * S + s); };   // consumers done
  auto raw_free = [&](int s) { return bars + 8 * (3 * S + s); };  // RAW: split read it
  const uint32_t q_bar = bars + 32 * S, q_split = q_bar + 8;
  auto stage_at = [&](int s) { return F::RING + s * F::STAGE; };  // bytes from base
  // where tile j's raw K and V land: their stage, or (RAW) the raw area
  auto landing = [&](int s) { return F::RAW ? F::RAW_AT : stage_at(s); };

  const int bh = blockIdx.y;
  const int rank = blockIdx.x % split;  // the cluster rank where split > 1
  const int m0 = blockIdx.x / split * F::ROWS;
  const int n_tiles = (t_len + F::BN - 1) / F::BN;
  const int n_local = rank < n_tiles ? (n_tiles - rank + split - 1) / split : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(raw_full(st), 1);
      mbar_init(split_full(st), 3);              // the splitting warps
      mbar_init(empty(st), F::CONSUMERS / 32);   // every consumer warp
      mbar_init(raw_free(st), 3);                // the splitting warps (RAW)
    }
    mbar_init(q_bar, 1);
    mbar_init(q_split, 3);
    mbar_fence_init();
  }
  __syncthreads();

  float acc[D / F::NC][F::NC / 8][4];
  float m_row[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8, log2 units
  float l_row[2] = {0.f, 0.f};              // this lane's share of their normalisers
  const int g = lane >> 2, tq = lane & 3;
  if (wg == F::C) {
    const int ptid = threadIdx.x - F::CONSUMERS;
    if (ptid == 0) {
      // the loads: each consumer's Q tile once, then the block's key tiles
      // through the ring, a stage refilled once the consumers let it go
      mbar_arrive_expect_tx(q_bar, F::C * F::QTILE);
      for (int c = 0; c < F::C; ++c) {
        for (int pn = 0; pn < D / F::W; ++pn)
          tma_load_3d(base + c * 2 * F::QTILE + pn * 64 * F::SW, &q_map, q_bar, pn * F::W,
                      m0 + 64 * c, bh);
      }
      for (int j = 0; j < n_local; ++j) {
        const int st = j % S;
        // the landing place is free once the consumers let the stage go
        // (in place), or once the splitting warps read the last tile (RAW)
        if (j >= S) mbar_wait(F::RAW ? raw_free(st) : empty(st), ((j / S) & 1) ^ 1);
        const int k0 = (rank + j * split) * F::BN;
        mbar_arrive_expect_tx(raw_full(st), 2 * F::KTILE);
        for (int pn = 0; pn < D / F::W; ++pn) {
          tma_load_3d(base + landing(st) + pn * F::BN * F::SW, &k_map, raw_full(st), pn * F::W,
                      k0, bh);
          tma_load_3d(base + landing(st) + F::KTILE + pn * F::BN * F::SW, &v_map, raw_full(st),
                      pn * F::W, k0, bh);
        }
      }
    } else if (ptid >= 32) {
      // the split: Q once, then each stage as it lands
      const int sid = ptid - 32;
      mbar_wait(q_bar, 0);
      for (int c = 0; c < F::C; ++c)
        split_in_place(area + c * 2 * F::QTILE, area + c * 2 * F::QTILE + F::QTILE, F::QTILE, sid,
                       F::SPLITTERS);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(q_split);
      for (int j = 0; j < n_local; ++j) {
        const int st = j % S;
        mbar_wait(raw_full(st), (j / S) & 1);
        if (F::RAW) {  // the stage is written once the consumers let it go
          if (j >= S) mbar_wait(empty(st), ((j / S) & 1) ^ 1);
          split_keys<D, F::BN, true>(area + stage_at(st), sid, F::SPLITTERS, area + F::RAW_AT);
        } else {
          split_keys<D, F::BN, true>(area + stage_at(st), sid, F::SPLITTERS);
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(split_full(st));
          if (F::RAW) mbar_arrive(raw_free(st));
        }
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < D / F::NC; ++c) {
#pragma unroll
      for (int j = 0; j < F::NC / 8; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
    }
    const uint32_t q_hi = base + wg * 2 * F::QTILE, q_lo = q_hi + F::QTILE;
    mbar_wait(q_split, 0);
    for (int j = 0; j < n_local; ++j) {
      const int st = j % S;
      mbar_wait(split_full(st), (j / S) & 1);
      const uint32_t kt = base + stage_at(st), vt = kt + 2 * F::KTILE;
      // S = Q K^T, 3xTF32
      float s[F::BN / 8][4];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 8; ++kd) {
        const uint32_t qa = kslice8<F::SW>(kd, 64), ka = kslice8<F::SW>(kd, F::BN);
        wgmma_3xtf32_ss(s, make_desc(q_hi + qa, F::SW), make_desc(q_lo + qa, F::SW),
                        make_desc(kt + ka, F::SW), make_desc(kt + F::KTILE + ka, F::SW), kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      float alpha[2];
      online_softmax<F::BN>(s, m_row, l_row, t_len - (rank + j * split) * F::BN, tq, scale_log2,
                            alpha);
#pragma unroll
      for (int c = 0; c < D / F::NC; ++c) {
#pragma unroll
        for (int jo = 0; jo < F::NC / 8; ++jo) {
          acc[c][jo][0] *= alpha[0];
          acc[c][jo][1] *= alpha[0];
          acc[c][jo][2] *= alpha[1];
          acc[c][jo][3] *= alpha[1];
        }
      }
      SplitTf32 p[F::BN / 8];
#pragma unroll
      for (int kk = 0; kk < F::BN / 8; ++kk) p[kk] = split_a_tf32(s[kk]);
      // O += P V, 3xTF32, against V^T (keys along its rows)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::BN / 8; ++kk) {
#pragma unroll
        for (int c = 0; c < D / F::NC; ++c) {
          const uint32_t va = kslice8<F::VSW>(kk, D) + c * F::NC * F::VSW;
          wgmma_3xtf32_rs(acc[c], p[kk], make_desc(vt + va, F::VSW),
                          make_desc(vt + F::KTILE + va, F::VSW));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < D / F::NC; ++c) fence_acc(acc[c]);
      if (lane == 0) mbar_arrive(empty(st));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
      l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
    }
    if (split == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + 64 * wg + 16 * (warp % 4) + g + 8 * r;
        if (row >= t_len) continue;
        const float inv_l = 1.f / l_row[r];
        float* const out = o + ((size_t)bh * t_len + row) * D + 2 * tq;
#pragma unroll
        for (int c = 0; c < D / F::NC; ++c) {
#pragma unroll
          for (int jo = 0; jo < F::NC / 8; ++jo)
            *reinterpret_cast<float2*>(out + c * F::NC + 8 * jo) =
                make_float2(acc[c][jo][2 * r] * inv_l, acc[c][jo][2 * r + 1] * inv_l);
        }
        if (lse != nullptr && tq == 0) lse[(size_t)bh * t_len + row] = kLn2 * (m_row[r] + log2f(l_row[r]));
      }
    }
  }
  if (split == 1) return;

  // the split: every block's (m, l, O) into its merge area, laid over Q and
  // the ring once every product and split of the block has run
  __syncthreads();
  float* const m_part = reinterpret_cast<float*>(area);  // [ROWS], then l [ROWS]
  float* const o_part = reinterpret_cast<float*>(area + F::MERGE_O);
  if (wg < F::C) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 64 * wg + 16 * (warp % 4) + g + 8 * r;
      if (tq == 0) {
        m_part[lr] = m_row[r];
        m_part[F::ROWS + lr] = l_row[r];
      }
      float* const out = o_part + lr * F::OSTRIDE + 2 * tq;
#pragma unroll
      for (int c = 0; c < D / F::NC; ++c) {
#pragma unroll
        for (int jo = 0; jo < F::NC / 8; ++jo)
          *reinterpret_cast<float2*>(out + c * F::NC + 8 * jo) =
              make_float2(acc[c][jo][2 * r], acc[c][jo][2 * r + 1]);
      }
    }
  }
  cluster_sync();
  // block `rank` merges rows [rank, rank + 1) * ROWS / split from every
  // block's share: M = max m_k, O = sum 2^(m_k - M) O_k / sum 2^(m_k - M) l_k,
  // four columns a step; every output element written once
  const int rows = F::ROWS / split;
  const uint32_t m_at = smem_u32(m_part), o_at = smem_u32(o_part);
  for (int i = threadIdx.x; i < rows * (D / 4); i += F::THREADS) {
    const int lr = rank * rows + i / (D / 4), c = 4 * (i % (D / 4));
    const int row = m0 + lr;
    if (row >= t_len) continue;
    float mk[F::MAX_SPLIT], top = -INFINITY;
#pragma unroll
    for (int b = 0; b < F::MAX_SPLIT; ++b) {
      mk[b] = b < split ? ld_cluster_f32(map_to_rank(m_at + 4 * lr, b)) : -INFINITY;
      top = fmaxf(top, mk[b]);
    }
    float l = 0.f;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int b = 0; b < F::MAX_SPLIT; ++b) {
      if (b >= split) continue;
      const float w = exp2_approx(mk[b] - top);
      l += w * ld_cluster_f32(map_to_rank(m_at + 4 * (F::ROWS + lr), b));
      const float4 x = ld_cluster_v4(map_to_rank(o_at + 4 * (lr * F::OSTRIDE + c), b));
      sum.x += w * x.x;
      sum.y += w * x.y;
      sum.z += w * x.z;
      sum.w += w * x.w;
    }
    const float inv_l = 1.f / l;
    *reinterpret_cast<float4*>(o + ((size_t)bh * t_len + row) * D + c) =
        make_float4(sum.x * inv_l, sum.y * inv_l, sum.z * inv_l, sum.w * inv_l);
    if (lse != nullptr && c == 0) lse[(size_t)bh * t_len + row] = kLn2 * (top + log2f(l));
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                       int t, float sm_scale, int split, cudaStream_t stream) {
  namespace host = wgmma_sm90_host;
  using F = F32Fwd<D>;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  const int rows[3] = {64, F::BN, F::BN};  // Q's box is a consumer's rows, K's and V's a stage's
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = host::tile_map(&maps[i], src[i], bh, t, D, F::W, rows[i], F::SW, 4);
    if (err != cudaSuccess) return err;
  }
  const int row_tiles = (t + F::ROWS - 1) / F::ROWS;
  if (split == 0)
    split = host::fill_split(bh * row_tiles, (t + F::BN - 1) / F::BN, host::sm_count(), F::RULE_SPLIT);
  if (split != 1 && split != 2 && split != 4) return cudaErrorInvalidValue;
  static uint64_t allowed = 0;
  cudaError_t err = host::allow_smem(flash_fwd_kernel<D>, F::SMEM, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * split, bh);
  cfg.blockDim = dim3(F::THREADS);
  cfg.dynamicSmemBytes = F::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_kernel<D>, maps[0], maps[1], maps[2],
                           static_cast<float*>(o), static_cast<float*>(lse), t, sm_scale * kLog2e,
                           split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int bh, int t, float sm_scale, int split, cudaStream_t stream) {
  namespace host = wgmma_sm90_host;
  using L = FwdLaunch<D>;
  // Q's box is a block's (D >= 128) or a warpgroup's rows, K's and V's a stage's
  using F = std::conditional_t<L::WS, HopperFwdWs<(L::WS ? D : 128)>, HopperFwd<(L::WS ? 64 : D)>>;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  const int rows[3] = {64, F::BN, F::BN};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = host::tile_map(&maps[i], src[i], bh, t, D, F::W, rows[i], F::SW);
    if (err != cudaSuccess) return err;
  }
  const int block_rows = L::WS ? 64 : kBlockRows;
  const int row_tiles = (t + block_rows - 1) / block_rows;
  if (split == 0)
    split = host::fill_split(bh * row_tiles, (t + F::BN - 1) / F::BN, host::sm_count(), F::MAX_SPLIT);
  if (split != 1 && split != 2 && split != 4) return cudaErrorInvalidValue;
  static uint64_t allowed = 0, covered = 0;
  int smem = 0;
  cudaError_t err = cudaSuccess;
  if constexpr (L::WS) {
    smem = F::SMEM;
    err = host::registers_cover(flash_fwd_wgmma_kernel<D>, F::THREADS, F::THREADS - F::CONSUMERS,
                                F::PRODUCER_REGS, F::CONSUMER_REGS, covered);
    if (err == cudaSuccess) err = host::allow_smem(flash_fwd_wgmma_kernel<D>, smem, allowed);
  } else {
    smem = F::smem_bytes(split > 1);
    err = host::allow_smem(flash_fwd_wgmma_kernel<D>, F::smem_bytes(true), allowed);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * split, bh);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = smem;
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
    if (dtype == 0) return launch_f32<D>(q, k, v, o, lse, bh, t, sm_scale, split, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// As flash_attention_fwd, with the split over keys forced: split 0 takes
// fill_split's rule, 1, 2 or 4 that many blocks a cluster.
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

// dtype: 0 = float32 (TF32 wgmma kernel; d >= 16), 1 = bfloat16 (wgmma
// kernel; d = 8 too). lse may be null. q, k, v and o must be 16-byte
// aligned. Returns the
// launch's error (cudaErrorInvalidValue for an unsupported d or dtype; the
// tensor maps' or the launch's own error where the card refuses them).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int bh, int t, int d, int dtype,
                                   float sm_scale, void* stream) {
  return flash_attention_fwd_split(q, k, v, o, lse, bh, t, d, dtype, sm_scale, 0, stream);
}
