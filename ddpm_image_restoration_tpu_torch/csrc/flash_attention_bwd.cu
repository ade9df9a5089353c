// Flash-attention backward for Hopper (sm_90a), over [BH, T, D] row-major.
//
// Replaces the two Pallas TPU kernels launched by `_flash_bhtd_bwd` (the JAX
// package's ops/pallas/flash_attention.py:304): `_bwd_dq_kernel` (:207) and
// `_bwd_dkv_kernel` (:247). With S = scale*Q*K^T, P = exp(S - LSE) and
// Delta = rowsum(dO o O):
//
//   dQ = scale * (P o (dO*V^T - Delta)) * K          flash_bwd_dq_wgmma_kernel (bf16)
//                                                    flash_bwd_dq_kernel (f32, TF32)
//   dV = P^T * dO,  dK = scale * dS^T * Q            flash_bwd_dkv_wgmma_kernel (bf16)
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
// dQ (flash_bwd_dq_wgmma_kernel) works in the untransposed frame, queries
// as the M rows, by Hopper's wgmma (wgmma_sm90.cuh). What bounds it at T =
// 1024 (132 SMs at 1980 MHz; per 72 heads): its products, S and dP at
// depth DP = max(D, 16) and dQ twice (hi/lo), 8*T^2*DP flops a head at 989
// TFLOP/s: 9.8 us at D = 8 and 16, 19.5 at 32; the MUFU's T^2 exp2 a head,
// 18.0 us whatever D; the fill: 8*BH blocks of 128 queries (576 at the
// train step, two blocks an SM at D <= 32: 2.2 waves). The design at D <=
// 64 (dq_pair):
//   * a block is two warpgroups of 64 queries (256 threads) and no producer
//     warp: thread 0 issues every load. Two blocks an SM at D <= 32
//     (ptxas -v: 124 registers at D = 32, 98 at 16 and 8; 147 at D = 64,
//     one block an SM), for four warpgroups an SM to hide each other's
//     latency;
//   * each warpgroup's Q and dO tiles arrive once by TMA and stay in shared
//     memory as wgmma's A operands; K and V stream by TMA through a ring of
//     STAGES stages of 64 keys with full/empty mbarriers, thread 0
//     refilling a stage LAG iterations after its use (the forward's ring);
//     [BH, T, D] tensor maps zero-fill rows >= T and, at D = 8, the columns
//     8..15. While they arrive, each thread sums Delta = rowsum(dO o O) of
//     its two rows from the bf16 rows in device memory (the quad's lanes,
//     then shuffles) and writes it for dK/dV;
//   * S = Q*K^T and dP = dO*V^T by wgmma m64n64k16 from K-major
//     descriptors; P = exp2(S*c - LSE) and dS = P o (dP - Delta) on the
//     accumulators, key columns >= T given P = 0 explicitly (a zero-filled
//     K gives S = 0, and exp2(0 - LSE) is not 0); dQ += dS*K by register-A
//     wgmma m64n{W}k16 against the same K tile through MN-major
//     descriptors, dS split into bf16 hi and lo by truncation
//     (split_a_trunc, wgmma_split);
//   * each warpgroup runs its tile's products and its exp2 one after the
//     other and leaves the overlap to the other warpgroups of the SM:
//     issuing tile j's S and dP with tile j-1's dQ product (the forward's
//     pipelining) keeps dS of tile j-1 live beside S and dP, spilled at two
//     blocks an SM and was 1.1-1.4x slower on the card; taking turns (named
//     barriers), 32 keys a stage and three blocks an SM were slower too
//     (PERF.md §6);
//   * D = 8 natively (zero-filled to the wgmma depth 16 in shared memory;
//     dQ written 8 wide).
//
// D = 128 and 256 (the 1024² model's bottleneck, trained at T = 1024 with
// BH = 4 for one image: 6*T^2*D flops a head, 1.6 GFLOP at D = 256). The
// design above gave (4, 1024, D) 32 blocks of 128 queries for 132 SMs, at
// D = 256 stages of 32 keys (two warpgroups' Q and dO took 128 KB), and
// left its loads to a consumer thread. Here the kernel is warp-specialised
// (dq_ws), as dK/dV below:
//   * a block is one 64-query tile: 384 threads, a producer warpgroup that
//     gives its registers away (setmaxnreg.dec to 40) and two consumer
//     warpgroups (setmaxnreg.inc to 232; 168 a thread at launch);
//   * the work is split by product so that the two warpgroups match:
//     warpgroup 0 computes S = Q*K^T and P = exp2(S*c - LSE), warpgroup 1
//     dP = dO*V^T and, with P from warpgroup 0, dS = P o (dP - Delta) and
//     its hi/lo split, which goes back to warpgroup 0; each then
//     accumulates half of dQ's columns, dQ[:, half] += (dS_hi + dS_lo) *
//     K[:, half]: one 64 x 64 x D product and one 64 x D/2 x 64 hi/lo pair
//     each a key tile, the exp2 on one side against dS and its split on the
//     other. (Splitting the keys of a stage between the warpgroups instead
//     would hold a 64 x D accumulator a warpgroup, 128 registers at D =
//     256, beside m64n32 products.) P (f32) and dS (its bf16 hi/lo pairs)
//     pass through one 16 KB buffer each, each thread's fragment at its own
//     place, handed over by named barriers; one buffer each suffices, as
//     each warpgroup reads the other's buffer before it next writes its
//     own;
//   * the producer's first thread streams the tile's Q and dO once and the
//     key tiles' K and V by TMA in 64-key stages through a full/empty ring
//     (4 stages at D = 128, 2 at D = 256: Q and dO 64 KB, a stage 64 KB,
//     the two buffers 32 KB: 226 KB);
//   * while the tiles arrive, warpgroup 0 reads its rows' LSE and warpgroup
//     1 sums their Delta = rowsum(dO o O), every 16-byte load of the rows
//     issued before the sums (summed by the producer's warps 1-3 a row at
//     a time, one memory latency a row, the kernel ran 5.3-5.5 us slower
//     on the card: PERF.md §6);
//   * filling the card: the key tiles are dealt over a cluster of 2 (block
//     r takes tiles r, r + 2, ...; pair_fill_split: 2 while twice the row
//     tiles fit the SMs): 128 blocks at (4, 1024, 256) and (4, 1024, 128).
//     The two blocks' partial dQ are added through distributed shared
//     memory: each warpgroup leaves the half of its accumulator that the
//     other block finishes in the ring's space and adds the other block's
//     share of its own half; every output element written once,
//     deterministic; block 0 writes Delta.
//
// dK/dV (flash_bwd_dkv_wgmma_kernel) works in the transposed frame, keys as
// the M rows. What bounds it at T = 1024 (per 72 heads): its products,
// S^T and dP^T at depth DP and dV and dK twice each (hi/lo), 12*T^2*DP
// flops a head at 989 TFLOP/s: 14.7 us at D = 8 and 16, 29.3 at 32, 58.6
// at 64;
// the MUFU's T^2 exp2 a head at 16 a clock per SM, 18.0 us whatever D (the
// floor at D <= 16); the fill is no limit (8*BH blocks of 128 keys: 576 at
// the train step). The design at D <= 64 (dkv_pair):
//   * a block is two consumer warpgroups of 64 keys and one producer warp
//     (288 threads; one block an SM, ptxas's cap of 168 registers: ptxas -v
//     gives 147 at D = 32, 128 at 16 and 8, 168 at 64. Without the
//     producer warp, at 256 threads with warp 0 loading, D = 32 ran slower
//     on the card); each
//     warpgroup's K and V tiles arrive once by TMA and stay in shared
//     memory as wgmma's A operands;
//   * the producer streams every query tile's Q and dO by TMA ([BH, T, D]
//     tensor maps, boxes of 64 rows, zero-filled past T and, at D = 8, over
//     the columns 8..15) and its LSE and Delta rows by the warp's lanes,
//     through a ring of 4 (D <= 32) or 3 (64) stages with full/empty
//     mbarriers;
//   * S^T = K*Q^T and dP^T = V*dO^T by wgmma m64n64k16 from K-major
//     descriptors; P^T = exp2(S^T*c - LSE) and dS^T = P^T o (dP^T - Delta)
//     on the accumulators, query columns >= T given P = 0 explicitly (a
//     zero LSE would give exp2(0) = 1); dV += P^T*dO and dK += dS^T*Q by
//     register-A wgmma against MN-major dO and Q descriptors, each operand
//     split into bf16 hi and lo (wgmma_split) by truncation on the integer
//     pipes (flash_mma.cuh split_a_trunc), the dV and dK products
//     interleaved so that neighbouring products are independent;
//   * the two warpgroups take turns at issuing each group of products
//     (named barriers), 4-5% faster than issuing at will (PERF.md §6);
//   * D = 8 natively (zero-filled to the wgmma depth 16 in shared memory;
//     dK and dV written 8 wide).
//
// D = 128 and 256 (the 1024² model's bottleneck, trained at T = 1024 with
// BH = 4 for one image). The design above held dK and dV of two warpgroups'
// keys beside S^T and dP^T in a 288-thread block's 168 registers, which
// spilled and serialized its products, and at D = 256 split the columns
// over two blocks that each computed S^T and dP^T (4/3 of the flops). Here
// the kernel is warp-specialised (dkv_ws):
//   * a block is one 64-key tile: 384 threads, a producer warpgroup that
//     gives its registers away (setmaxnreg.dec to 40) and two consumer
//     warpgroups (setmaxnreg.inc to 232; 168 a thread at launch), so that
//     each holds one 64 x D accumulator (64 or 128 f32 a thread) in
//     registers beside a 64 x 64 product tile and its hi/lo parts;
//   * the work is split by product, not by keys: warpgroup 0 computes S^T
//     = K*Q^T and P^T, and accumulates dV += P^T*dO; warpgroup 1 computes
//     dP^T = V*dO^T and, with P^T from warpgroup 0, dS^T = P^T o (dP^T -
//     Delta), and accumulates dK += dS^T*Q. S^T and dP^T are computed once
//     per (key tile, query tile), and the two warpgroups' products are the
//     same size (one 64 x 64 x D product and two hi/lo ones each). P^T
//     passes through shared memory in f32 (the bytes of its hi/lo pair),
//     each thread's fragment at its own place, in two buffers handed over
//     by named barriers (full, then free);
//   * the producer's first warp streams each query tile's Q and dO by TMA
//     (64-row boxes) and its LSE and Delta rows by its lanes through a
//     ring of 4 stages at D = 128 and 2 at D = 256 (200 and 226 KB with K,
//     V and the P^T buffers);
//   * filling the card: one block a key tile gives (4, 1024, D) only 64
//     blocks, so the query tiles are dealt over a cluster of 2 (block r
//     takes tiles r, r + 2, ...; pair_fill_split: 2 while twice the key
//     tiles fit the SMs): 128 blocks at (4, 1024, 256) and (4, 1024, 128).
//     The two blocks' sums are added through distributed shared memory:
//     each warpgroup leaves the half of its accumulator that the other
//     block finishes in the ring's space, and adds the other block's share
//     of its own half; every output element written once, deterministic;
//   * work a head: 12*T^2*D flops, 3.2 GFLOP at D = 256 and 1.6 at D = 128
//     (T = 1024).
//
// No atomics: every output element is written by one thread, once, and
// results are deterministic. P and dS are carried as a bf16 hi part (x
// rounded toward zero) and lo = bf16(x - hi), two products against the
// same B operand, since one bf16 rounding moves dQ, dK and dV by several
// bf16 steps against the f32 plain version.
//
// f32 dQ (flash_bwd_dq_kernel), at every D: TF32 wgmma with the 3xTF32
// split (flash_tf32.cuh; the forward's design, flash_attention_fwd.cu),
// replacing PR 5's FMA kernel (0.3376 ms at (4, 1024, 128), 0.6033 at (4,
// 1024, 256)). What bounds it at T = 1024: S, dP and dS*K three times
// each, 18*T^2*D flops a head at 495 TFLOP/s: 20 us at (4, 1024, 128), 39
// at (4, 1024, 256); at 67 TFLOP/s f32 6*T^2*D, 48 and 96 us. The design:
//   * C consumer warpgroups of 64 queries (2 at D <= 64, 1 at 128), each
//     with its own Q and dO hi/lo tiles, and a producer warpgroup: its
//     first thread issues every TMA load, its warps 1-3 split K and V as
//     they land into K hi/lo and V hi/lo in place and write K^T hi/lo
//     (keys along the row, permuted in groups of 8: dS*K's B operand, which
//     TF32 wgmma reads K-major only);
//   * shared memory: Q, dO hi/lo, 16*64*D bytes a consumer; stages of BN
//     keys of 24*BN*D bytes (K, V, K^T, hi and lo):
//       D = 16:  32 KB, BN 32, 4 stages of 12 KB:  80 KB
//       D = 32:  64 KB, BN 32, 4 stages of 24 KB: 160 KB
//       D = 64:  128 KB, BN 32, 2 stages of 48 KB: 224 KB
//       D = 128: 128 KB (C = 1), BN 16, 2 stages of 48 KB: 224 KB
//       D = 256: one consumer's Q and dO hi/lo alone would take 256 KB, so
//         the head dim is split over a cluster of 2 blocks, each holding
//         its 128 columns: Q hi and dO hi/lo (96 KB; Q's lo part is kept in
//         the consumer's registers as the A fragments of the S product,
//         64 a thread, which made room for a second stage and ran 1.18x
//         faster than Q lo in shared memory with one stage and a raw
//         landing area), two stages of K, V and K^T (96 KB) and an inbox
//         for the partner's partial S and dP (8 KB): 200 KB. After the
//         products each consumer thread stores its partial S and dP into
//         the partner's inbox (st.shared::cluster) and arrives on the
//         partner's mbarrier (release at cluster scope), waits for the
//         partner's, and adds the two in rank order, so that both blocks
//         hold the same S and dP (flash_tf32.cuh add_partner_partials);
//         each then writes its 128 columns of dQ.
//         (Issuing tile j + 1's products before tile j's exchange, with a
//         raw landing area, ran 1.5x slower: kernel_ab.py, PERF.md §6);
//   * S = Q*K^T and dP = dO*V^T by m64n{BN}k8 from descriptors, P =
//     exp2(S*c - LSE) and dS = P o (dP - Delta) on the accumulators (keys
//     >= T given P = 0), dQ += dS*K by register-A m64n{min(D, 64)}k8
//     against K^T, dS split into hi/lo in registers (split_a_tf32); Delta
//     from the f32 rows of dO and O, written for dK/dV by block 0 of a
//     cluster;
//   * the split over keys: where the grid is short of the card, a row
//     tile's key tiles are dealt over a cluster of 2 blocks (fill_split:
//     (4, 1024, 128) takes 2; 4 when forced) and their partial dQ added
//     through distributed shared memory in one fixed order; every output
//     element written once, deterministic.
//
// f32 dK/dV (flash_bwd_dkv_kernel), at every D: TF32 wgmma with the 3xTF32
// split, replacing the f32 FMA kernel (0.3448 ms at (4, 1024, 128), 0.5372
// at (4, 1024, 256), 0.9805 at (72, 1024, 32)). What bounds it at T =
// 1024: S^T, dP^T, dV and dK three times each, 24*T^2*D flops a head at
// 495 TFLOP/s: 26 us at (4, 1024, 128), 52 at (4, 1024, 256), 117 at (72,
// 1024, 32); at 67 TFLOP/s f32 8*T^2*D, 64, 128 and 289 us. The design, in
// the transposed frame of the bf16 kernel (keys as the M rows):
//   * a block is two consumer warpgroups and a producer warpgroup (384
//     threads). The producer gives its registers away (setmaxnreg.dec to
//     56; the consumers .inc to 224, 168 a thread at launch): its first
//     thread issues every TMA load, its first warp's lanes bring each query
//     tile's LSE and Delta rows, its warps 1-3 split what lands;
//   * S^T and dP^T read K (or V) as A and Q (or dO) as B, both as stored
//     (K-major over D); K's and V's hi parts stay in shared memory (rounded
//     in place once), their lo parts in the consumers' registers as the A
//     fragments of the k8 steps (DH/2 a thread each; wgmma_3xtf32_sr). dV
//     and dK reduce over queries: P^T and dS^T are register-A operands
//     taken from the accumulators (split_a_tf32), and their B operands dO^T
//     and Q^T lie with the queries along the row, permuted in groups of 8
//     (flash_tf32.cuh; dQ's K^T with keys and queries swapped). So the
//     splitting warps write four transposed tiles a stage, Q^T and dO^T hi
//     and lo, beside Q and dO hi/lo in place (split_keys, BOTH_T): 8 tiles
//     a stage, 32*BN*DH bytes;
//   * D <= 32 (PAIR): each consumer warpgroup owns 64 of the block's 128
//     keys and runs all four products on them, S^T with dP^T and dV with
//     dK interleaved (two independent chains), holding K lo, V lo, dK and
//     dV (2*D registers a thread besides the 64-query tile's S^T, dP^T and
//     their hi/lo splits). Against the split by product below it halves the
//     splitting per product and needs no hand-over: 0.2943 against 0.3645
//     ms at (72, 1024, 32), 0.0444 against 0.0549 at (16, 1024, 16); taking
//     turns at issuing (named barriers) gained nothing (kernel_ab.py).
//     Here the CUDA cores' work a product sets the pace (exp2, dS, the hi/lo
//     splits of P^T and dS^T, the producer's splitting; twice D = 32's a
//     flop at D = 16): the stats rows hold -LSE in log2 units, and a full
//     query tile skips the mask, 0.2070 -> 0.1890 ms at (72, 1024, 16);
//   * D >= 64: a block is one 64-key tile, split by product as the bf16
//     dkv_ws: consumer warpgroup 0 computes S^T, P^T = exp2(S^T*c - LSE)
//     and dV += P^T*dO; warpgroup 1 dP^T, dS^T = P^T o (dP^T - Delta) with
//     P^T from warpgroup 0 (f32, two shared buffers handed over by named
//     barriers) and dK += dS^T*Q; each holds one 64 x DH accumulator and
//     one A lo operand (K lo or V lo), DH registers a thread, where a
//     warpgroup holding both would need 2*DH = 256 at DH = 128;
//   * shared memory (227 KB a block): K hi and V hi, 8*KEYS*DH bytes;
//     stages of BN queries, 32*BN*DH bytes; two P^T buffers of 256*BN
//     bytes (D >= 64):
//       D = 16:  16 KB (128 keys), BN 64, 4 stages of 32 KB: 147 KB
//       D = 32:  32 KB (128 keys), BN 32, 4 stages of 32 KB: 162 KB
//       D = 64:  32 KB, BN 32, 2 stages of 64 KB, P^T 16 KB: 178 KB
//       D = 128: 64 KB, BN 16, 2 stages of 64 KB, P^T 8 KB: 201 KB (with
//         K lo and V lo in shared memory, 128 KB resident, one stage would
//         fit: the registers keep the ring two deep)
//       D = 256: K and V hi/lo of 64 keys alone would take 256 KB, so the
//         head dim is split over a cluster of 2 blocks, each holding its
//         128 columns of K, V, Q, dO and the transposes (D = 128's counts)
//         and an inbox for the partner's partial S^T or dP^T (8 KB): 209
//         KB. After its product each consumer thread stores its partial
//         S^T (or dP^T) into the partner's inbox (st.shared::cluster),
//         arrives on the partner's mbarrier of its warpgroup (release at
//         cluster scope), waits for the partner's and adds the two in rank
//         order (add_partner_partials, as dQ), so that both blocks hold
//         the same S^T, dP^T, P^T and dS^T; each writes
//         its 128 columns of dK and dV;
//   * query columns >= T get P = 0 explicitly (a zero LSE would give
//     exp2(0) = 1); key rows >= T (zero-filled by TMA) are not written;
//   * filling the card: one block a key tile (of KEYS keys), and where
//     twice the key tiles fit the SMs (pair_fill_split; (4, 1024, 128): 64
//     tiles) the query tiles are dealt over a cluster of 2 (block r takes
//     r, r + 2, ...) and the two blocks' sums added through distributed
//     shared memory, each block finishing half of each accumulator's n8
//     blocks; (4, 1024, 256) takes 128 blocks from its head-dim cluster;
//     every output element written once, deterministic, no atomics.
//
// Build (plain C interface, no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mma.cuh"
#include "flash_tf32.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// f32 dQ (flash_bwd_dq_kernel<D>; the file's note): C consumer warpgroups
// of 64 query rows walk the same key tiles, each with its own Q and dO
// hi/lo tiles; the producer warpgroup's first thread issues every load and
// its warps 1-3 split what lands into TF32 hi/lo tiles. At D = 256 the
// head dim is split over a cluster of DS = 2 blocks: each holds its half of
// Q, dO, K, V and K^T, the two exchange their partial S and dP each key
// tile, and each writes its half of dQ.
template <int D> struct F32Dq {
  static constexpr int DS = D > 128 ? 2 : 1;       // blocks a row tile's head dim is split over
  static constexpr int DH = D / DS;                // head dims a block
  static constexpr int C = D <= 64 ? 2 : 1;        // consumer warpgroups
  static constexpr int ROWS = 64 * C;              // query rows a block
  static constexpr int CONSUMERS = 128 * C;
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  static constexpr int SPLITTERS = 96;             // the producer's warps 1-3
  static constexpr int SW = DH * 4 < 128 ? DH * 4 : 128;  // bytes a row of a [rows, DH] tile
  static constexpr int W = SW / 4;                         // columns a panel
  static constexpr int BN = D <= 64 ? 32 : 16;             // keys a ring stage
  static constexpr int VSW = BN * 4 < 128 ? BN * 4 : 128;  // bytes a row of K^T
  static constexpr int NC = DH < 64 ? DH : 64;     // output columns a dS*K product
  static constexpr int QTILE = 64 * DH * 4;        // a [64, DH] f32 tile
  static constexpr int KTILE = BN * DH * 4;        // a [BN, DH] (or [DH, BN]) f32 tile
  // The partial S and dP a block sends its partner each key tile (DS = 2):
  // each consumer thread's accumulators, 2 * BN / 2 f32.
  static constexpr int XCHG = DS == 2 ? CONSUMERS * BN * 4 : 0;
  // DS = 2: Q's lo part lives in the consumers' registers (its A fragments
  // of the DH / 8 k8 steps, 4 a step: 64 registers at DH = 128), not in
  // shared memory, so that a second stage fits
  static constexpr bool QLO_REGS = DS == 2;
  static constexpr int CTILES = QLO_REGS ? 3 : 4;  // [64, DH] tiles a consumer holds
  // From the 1024-aligned base: each consumer's Q hi, Q lo (unless
  // QLO_REGS), dO hi, dO lo; the ring (K hi, where raw K lands; K lo; V hi,
  // where raw V lands; V lo; K^T hi; K^T lo); the partner's inbox (DS = 2);
  // the barriers (raw full, split full, empty; then Q and dO's, their
  // split, and the exchange's ready and free). As many stages as fit in
  // 227 KB, at most 4 (2 at D = 64, 128 and 256).
  static constexpr int RING = C * CTILES * QTILE;
  static constexpr int STAGE = 6 * KTILE;
  static constexpr int FIT = (232448 - 1024 - 512 - RING - XCHG) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int INBOX = RING + STAGES * STAGE;
  static constexpr int BARS = INBOX + XCHG;
  static constexpr int SMEM = 1024 + BARS + 8 * (3 * STAGES + 4);
  // The key split's partial dQ (f32 [ROWS][OSTRIDE]) overlays Q and the ring.
  static constexpr int OSTRIDE = DH + 4;
  // the most blocks a row tile's keys are dealt over: 4 (forced), and 2 by
  // fill_split (clusters of 4 ran slower than of 2: kernel_ab.py); none
  // where the cluster splits the head dim
  static constexpr int MAX_SPLIT = DS == 2 ? 1 : 4, RULE_SPLIT = DS == 2 ? 1 : 2;
  static_assert(STAGES >= 2 && SMEM <= 232448, "227 KB a block");
  static_assert(ROWS * OSTRIDE * 4 <= BARS, "the partial dQ overlays Q and the ring");
};

template <int D>
__device__ __forceinline__ void dq_tf32(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                        const CUtensorMap& v_map, const CUtensorMap& do_map,
                                        const float* __restrict__ q, const float* __restrict__ o,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse, float* __restrict__ dq,
                                        float* __restrict__ delta, int t_len, float scale,
                                        float scale_log2, int split) {
  using namespace wgmma_sm90;
  using namespace flash_tf32;
  using F = F32Dq<D>;
  constexpr int S = F::STAGES, DH = F::DH;
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  char* const area = raw + (base - smem_u32(raw));
  const uint32_t bars = base + F::BARS;
  auto raw_full = [&](int s) { return bars + 8 * s; };           // TMA landed
  auto split_full = [&](int s) { return bars + 8 * (S + s); };    // hi/lo written
  auto empty = [&](int s) { return bars + 8 * (2 * S + s); };     // consumers done
  const uint32_t q_bar = bars + 24 * S, q_split = q_bar + 8;
  const uint32_t x_ready = q_bar + 16, x_free = q_bar + 24;  // DS = 2: the exchange
  auto stage_at = [&](int s) { return F::RING + s * F::STAGE; };  // bytes from base

  const int bh = blockIdx.y;
  const int cl = F::DS == 2 ? 2 : split;         // the cluster's blocks
  const int rank = blockIdx.x % cl;              // the cluster rank where cl > 1
  const int krank = F::DS == 2 ? 0 : rank;       // the block's share of the keys
  const int ksplit = F::DS == 2 ? 1 : split;
  const int d0 = F::DS == 2 ? rank * DH : 0;     // the block's first head dim
  const int m0 = blockIdx.x / cl * F::ROWS;
  const int n_tiles = (t_len + F::BN - 1) / F::BN;
  const int n_local = krank < n_tiles ? (n_tiles - krank + ksplit - 1) / ksplit : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane >> 2, tq = lane & 3;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(raw_full(st), 1);
      mbar_init(split_full(st), 3);             // the splitting warps
      mbar_init(empty(st), F::CONSUMERS / 32);  // every consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_init(q_split, 3);
    mbar_init(x_ready, F::CONSUMERS);  // every partner consumer thread
    mbar_init(x_free, F::CONSUMERS);
    mbar_fence_init();
  }
  if (F::DS == 2) cluster_sync();  // the partner's barriers exist before any arrival
  else __syncthreads();

  float acc[DH / F::NC][F::NC / 8][4];
  if (wg == F::C) {
    const int ptid = threadIdx.x - F::CONSUMERS;
    if (ptid == 0) {
      // the loads: each consumer's Q and dO tiles once, then the key tiles
      // (K, V) through the ring, a stage refilled once the consumers let it go
      mbar_arrive_expect_tx(q_bar, F::C * 2 * F::QTILE);
      for (int c = 0; c < F::C; ++c) {
        for (int pn = 0; pn < DH / F::W; ++pn) {
          const uint32_t at = base + c * F::CTILES * F::QTILE + pn * 64 * F::SW;
          tma_load_3d(at, &q_map, q_bar, d0 + pn * F::W, m0 + 64 * c, bh);
          tma_load_3d(at + (F::CTILES - 2) * F::QTILE, &do_map, q_bar, d0 + pn * F::W,
                      m0 + 64 * c, bh);
        }
      }
      for (int j = 0; j < n_local; ++j) {
        const int st = j % S;
        if (j >= S) mbar_wait(empty(st), ((j / S) & 1) ^ 1);
        const int k0 = (krank + j * ksplit) * F::BN;
        mbar_arrive_expect_tx(raw_full(st), 2 * F::KTILE);
        for (int pn = 0; pn < DH / F::W; ++pn) {
          tma_load_3d(base + stage_at(st) + pn * F::BN * F::SW, &k_map, raw_full(st),
                      d0 + pn * F::W, k0, bh);
          tma_load_3d(base + stage_at(st) + 2 * F::KTILE + pn * F::BN * F::SW, &v_map,
                      raw_full(st), d0 + pn * F::W, k0, bh);
        }
      }
    } else if (ptid >= 32) {
      // the split: Q and dO once, then each stage as it lands
      const int sid = ptid - 32;
      mbar_wait(q_bar, 0);
      for (int c = 0; c < F::C; ++c) {
        char* const q_tile = area + c * F::CTILES * F::QTILE;
        char* const do_tile = q_tile + (F::CTILES - 2) * F::QTILE;
        split_in_place(q_tile, F::QLO_REGS ? nullptr : q_tile + F::QTILE, F::QTILE, sid,
                       F::SPLITTERS);
        split_in_place(do_tile, do_tile + F::QTILE, F::QTILE, sid, F::SPLITTERS);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(q_split);
      for (int j = 0; j < n_local; ++j) {
        const int st = j % S;
        mbar_wait(raw_full(st), (j / S) & 1);
        split_keys<DH, F::BN, false>(area + stage_at(st), sid, F::SPLITTERS);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(split_full(st));
      }
    }
  } else {
    // Delta = rowsum(dO o O) of this lane's rows g and g + 8 from the f32
    // rows in device memory (all D columns: 8j + 2tq, +1, then over the
    // quad), and their LSE in log2 units; rows >= T get 0 for both, so that
    // their P = 1 meets a zero dO and Delta: dS = 0. Block 0 of a cluster
    // writes it.
    const int row0 = m0 + 64 * wg + 16 * (warp % 4) + g;
    float dlt[2] = {0.f, 0.f}, neg_lse[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const size_t stat = (size_t)bh * t_len + row;
      if (row < t_len) {
#pragma unroll 4
        for (int j = 0; j < D / 8; ++j) {
          const size_t at = stat * D + 8 * j + 2 * tq;
          const float2 d2 = *reinterpret_cast<const float2*>(dout + at);
          const float2 o2 = *reinterpret_cast<const float2*>(o + at);
          dlt[r] = fmaf(d2.x, o2.x, dlt[r]);
          dlt[r] = fmaf(d2.y, o2.y, dlt[r]);
        }
        neg_lse[r] = -lse[stat] * kLog2e;
      }
      dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 1);
      dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 2);
      if (rank == 0 && row < t_len && tq == 0) delta[stat] = dlt[r];
    }
#pragma unroll
    for (int c = 0; c < DH / F::NC; ++c) {
#pragma unroll
      for (int j = 0; j < F::NC / 8; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
    }
    const uint32_t q_hi = base + wg * F::CTILES * F::QTILE, q_lo = q_hi + F::QTILE;
    const uint32_t do_hi = q_hi + (F::CTILES - 2) * F::QTILE, do_lo = do_hi + F::QTILE;
    // QLO_REGS: this thread's part of Q's lo A fragments, from the rows in
    // device memory (k8 step kd: rows g, g + 8, columns d0 + 8kd + tq, + 4)
    uint32_t qlo[F::QLO_REGS ? DH / 8 : 1][4];
    if constexpr (F::QLO_REGS) {
      const float* const qr = q + ((size_t)bh * t_len + row0) * D + d0 + tq;
#pragma unroll
      for (int kd = 0; kd < DH / 8; ++kd) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i & 1, c = 8 * kd + 4 * (i >> 1);
          const float x = row0 + 8 * r < t_len ? qr[(size_t)8 * r * D + c] : 0.f;
          uint32_t hi;
          split_tf32(x, hi, qlo[kd][i]);
        }
      }
    }
    // DS = 2: this thread's slot of the partner's inbox (where it sends its
    // partial S and dP) and of its own (where the partner's arrive)
    const uint32_t slot = base + F::INBOX + threadIdx.x * F::BN * 4;
    const uint32_t partner_slot = map_to_rank(slot, rank ^ 1);
    mbar_wait(q_split, 0);
    for (int j = 0; j < n_local; ++j) {
      const int st = j % S;
      mbar_wait(split_full(st), (j / S) & 1);
      const uint32_t kt = base + stage_at(st), vt = kt + 2 * F::KTILE, ktt = kt + 4 * F::KTILE;
      // S = Q K^T and dP = dO V^T, two independent chains, 3xTF32 (over
      // this block's head dims)
      float s[F::BN / 8][4], dp[F::BN / 8][4];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DH / 8; ++kd) {
        const uint32_t qa = kslice8<F::SW>(kd, 64), ka = kslice8<F::SW>(kd, F::BN);
        if constexpr (F::QLO_REGS)
          wgmma_3xtf32_sr(s, make_desc(q_hi + qa, F::SW), qlo[kd], make_desc(kt + ka, F::SW),
                          make_desc(kt + F::KTILE + ka, F::SW), kd > 0);
        else
          wgmma_3xtf32_ss(s, make_desc(q_hi + qa, F::SW), make_desc(q_lo + qa, F::SW),
                          make_desc(kt + ka, F::SW), make_desc(kt + F::KTILE + ka, F::SW), kd > 0);
        wgmma_3xtf32_ss(dp, make_desc(do_hi + qa, F::SW), make_desc(do_lo + qa, F::SW),
                        make_desc(vt + ka, F::SW), make_desc(vt + F::KTILE + ka, F::SW), kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      // DS = 2: the two halves' partial S and dP, added in rank order
      if (F::DS == 2)
        add_partner_partials<F::BN / 8>(
            partner_slot, reinterpret_cast<const float*>(area + F::INBOX) + threadIdx.x * F::BN,
            x_ready, x_free, rank, j, s, dp);
      // P = exp2(S c - LSE) and dS = P o (dP - Delta) on the accumulators;
      // key columns >= T get P = 0 explicitly (a zero-filled K gives S = 0,
      // and exp2(0 - LSE) is not 0)
      const int n_valid = t_len - (krank + j * ksplit) * F::BN;
#pragma unroll
      for (int jj = 0; jj < F::BN / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok = n_valid >= F::BN || 8 * jj + 2 * tq + (e & 1) < n_valid;
          const float p = ok ? exp2_approx(fmaf(s[jj][e], scale_log2, neg_lse[r])) : 0.f;
          dp[jj][e] = p * (dp[jj][e] - dlt[r]);
        }
      }
      SplitTf32 ds[F::BN / 8];
#pragma unroll
      for (int kk = 0; kk < F::BN / 8; ++kk) ds[kk] = split_a_tf32(dp[kk]);
      // dQ += dS K, 3xTF32, against K^T (keys along its rows)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::BN / 8; ++kk) {
#pragma unroll
        for (int c = 0; c < DH / F::NC; ++c) {
          const uint32_t ka = kslice8<F::VSW>(kk, DH) + c * F::NC * F::VSW;
          wgmma_3xtf32_rs(acc[c], ds[kk], make_desc(ktt + ka, F::VSW),
                          make_desc(ktt + F::KTILE + ka, F::VSW));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < DH / F::NC; ++c) fence_acc(acc[c]);
      if (lane == 0) mbar_arrive(empty(st));
    }
    if (ksplit == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= t_len) continue;
        float* const out = dq + ((size_t)bh * t_len + row) * D + d0 + 2 * tq;
#pragma unroll
        for (int c = 0; c < DH / F::NC; ++c) {
#pragma unroll
          for (int jo = 0; jo < F::NC / 8; ++jo)
            *reinterpret_cast<float2*>(out + c * F::NC + 8 * jo) =
                make_float2(acc[c][jo][2 * r] * scale, acc[c][jo][2 * r + 1] * scale);
        }
      }
    }
  }
  if (F::DS == 2) {
    cluster_sync();  // no block leaves while its partner may still signal it
    return;
  }
  if (split == 1) return;

  // the key split: every block's partial dQ into its merge area, laid over
  // Q and the ring once every product and split of the block has run; block
  // `rank` adds rows [rank, rank + 1) * ROWS / split over the cluster's
  // blocks, four columns a step; every output element written once
  __syncthreads();
  float* const part = reinterpret_cast<float*>(area);
  if (wg < F::C) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float* const out = part + (64 * wg + 16 * (warp % 4) + g + 8 * r) * F::OSTRIDE + 2 * tq;
#pragma unroll
      for (int c = 0; c < DH / F::NC; ++c) {
#pragma unroll
        for (int jo = 0; jo < F::NC / 8; ++jo)
          *reinterpret_cast<float2*>(out + c * F::NC + 8 * jo) =
              make_float2(acc[c][jo][2 * r], acc[c][jo][2 * r + 1]);
      }
    }
  }
  cluster_sync();
  const int rows = F::ROWS / split;
  const uint32_t at = smem_u32(part);
  for (int i = threadIdx.x; i < rows * (DH / 4); i += F::THREADS) {
    const int lr = rank * rows + i / (DH / 4), c = 4 * (i % (DH / 4));
    const int row = m0 + lr;
    if (row >= t_len) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int b = 0; b < F::MAX_SPLIT; ++b) {
      if (b >= split) continue;
      const float4 x = ld_cluster_v4(map_to_rank(at + 4 * (lr * F::OSTRIDE + c), b));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    *reinterpret_cast<float4*>(dq + ((size_t)bh * t_len + row) * D + c) =
        make_float4(sum.x * scale, sum.y * scale, sum.z * scale, sum.w * scale);
  }
  cluster_sync();  // no block leaves while another reads its shared memory
}

// f32 dQ: TF32 wgmma with the 3xTF32 split (dq_tf32), at every D.
template <int D>
__global__ void __launch_bounds__(F32Dq<D>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map, const float* __restrict__ q,
                    const float* __restrict__ o, const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dq,
                    float* __restrict__ delta, int t_len, float scale, float scale_log2,
                    int split) {
  dq_tf32<D>(q_map, k_map, v_map, do_map, q, o, dout, lse, dq, delta, t_len, scale, scale_log2,
             split);
}

// f32 dK/dV (flash_bwd_dkv_kernel<D>; the file's note): a block of two
// consumer warpgroups (threads 0-255) and a producer warpgroup (256-383),
// which issues the loads (its first thread), brings the LSE and Delta rows
// (its first warp) and splits what lands into TF32 hi/lo tiles (warps 1-3).
// D <= 32 (PAIR): each consumer warpgroup owns 64 keys of the block's 128
// and runs all four products on them. D >= 64: the block is one 64-key
// tile, split by product: warpgroup 0 computes S^T and P^T and accumulates
// dV, warpgroup 1 dP^T and dS^T and accumulates dK. At D = 256 the head
// dim is split over a cluster of DS = 2 blocks.
template <int D> struct F32Dkv {
  static constexpr bool PAIR = D <= 32;            // each consumer warpgroup its own keys
  static constexpr int KEYS = PAIR ? 128 : 64;     // keys a block
  static constexpr int DS = D > 128 ? 2 : 1;       // blocks a key tile's head dim is split over
  static constexpr int DH = D / DS;                // head dims a block
  static constexpr int CONSUMERS = 256;            // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  static constexpr int SPLITTERS = 96;             // the producer's warps 1-3
  // registers a thread after setmaxnreg; 56 * 128 + 224 * 256 = 168 * 384,
  // the launch's 168 (65536 registers over 384 threads)
  static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
  static constexpr int BN = D == 16 ? 64 : (D <= 64 ? 32 : 16);  // queries a ring stage
  static constexpr int SW = DH * 4 < 128 ? DH * 4 : 128;   // bytes a row of a [rows, DH] tile
  static constexpr int W = SW / 4;                         // columns a panel
  static constexpr int VSW = BN * 4 < 128 ? BN * 4 : 128;  // bytes a row of Q^T and dO^T
  static constexpr int NC = DH < 64 ? DH : 64;             // output columns a dV or dK product
  static constexpr int NB = DH / 8;                        // n8 blocks of a dV or dK accumulator
  static constexpr int ACCS = PAIR ? 2 : 1;                // accumulators a consumer thread
  static constexpr int KTILE = KEYS * DH * 4;              // the block's [KEYS, DH] K or V hi
  static constexpr int QTILE = BN * DH * 4;                // a [BN, DH] (or [DH, BN]) f32 tile
  static constexpr int STAGE = 8 * QTILE;  // Q, Q lo, dO, dO lo, Q^T, Q^T lo, dO^T, dO^T lo
  static constexpr int PTILE = PAIR ? 0 : 64 * BN * 4;     // P^T of one query tile, f32
  // The partial S^T (warpgroup 0) or dP^T (1) a block sends its partner
  // each query tile (DS = 2): each consumer thread's accumulator, BN / 2 f32.
  static constexpr int XCHG = DS == 2 ? CONSUMERS * BN / 2 * 4 : 0;
  // From the 1024-aligned base: K hi, V hi; the ring (split_keys<BOTH_T>'s
  // eight tiles a stage: raw Q lands in Q hi, raw dO in dO hi); two P^T
  // buffers (split by product); the partner's inbox (DS = 2); each stage's
  // -LSE (log2 units) and Delta rows; the barriers (raw full, split full
  // and empty a stage; then K and V's load and split; each consumer
  // warpgroup's exchange ready and free). As many stages as fit in 227 KB,
  // at most 4.
  static constexpr int RING = 2 * KTILE;
  static constexpr int FIXED = 1024 + RING + 2 * PTILE + XCHG + 8 * 6;
  static constexpr int FIT = (232448 - FIXED) / (STAGE + 2 * BN * 4 + 3 * 8);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int PBUF = RING + STAGES * STAGE;
  static constexpr int INBOX = PBUF + 2 * PTILE;
  static constexpr int STATS = INBOX + XCHG;
  static constexpr int BARS = STATS + STAGES * 2 * BN * 4;
  static constexpr int SMEM = 1024 + BARS + 8 * (3 * STAGES + 6);
  // The split over query tiles: each consumer thread leaves the other
  // block's half of each accumulator's n8 blocks (NB / 2 float4) in the ring.
  static constexpr int RED_BYTES = CONSUMERS * ACCS * (NB / 2) * 16;
  static_assert(STAGES >= 2 && SMEM <= 232448, "227 KB a block");
  static_assert(RED_BYTES <= STAGES * STAGE, "the partial sums overlay the ring");
};

template <int D>
__device__ __forceinline__ void dkv_tf32(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                         const CUtensorMap& v_map, const CUtensorMap& do_map,
                                         const float* __restrict__ k, const float* __restrict__ v,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, float* __restrict__ dk,
                                         float* __restrict__ dv, int t_len, float scale,
                                         float scale_log2, int split) {
  using namespace wgmma_sm90;
  using namespace flash_tf32;
  using F = F32Dkv<D>;
  // named barriers: P^T buffer b full (1 + b) and free (3 + b), each
  // between the two consumer warpgroups; both consumers (5)
  constexpr int kPFull = 1, kPFree = 3, kConsumerBar = 5;
  constexpr int S = F::STAGES, DH = F::DH;
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  char* const area = raw + (base - smem_u32(raw));
  float* const stats = reinterpret_cast<float*>(area + F::STATS);
  const uint32_t bars = base + F::BARS;
  auto raw_full = [&](int s) { return bars + 8 * s; };           // TMA landed
  auto split_full = [&](int s) { return bars + 8 * (S + s); };    // hi/lo and stats written
  auto empty = [&](int s) { return bars + 8 * (2 * S + s); };     // consumers done
  const uint32_t kv_bar = bars + 24 * S, kv_split = kv_bar + 8;
  auto x_ready = [&](int w) { return kv_bar + 16 + 16 * w; };     // DS = 2: the exchange
  auto x_free = [&](int w) { return kv_bar + 24 + 16 * w; };
  auto stage_at = [&](int s) { return F::RING + s * F::STAGE; };  // bytes from base
  const uint32_t k_hi = base, v_hi = base + F::KTILE;

  const int bh = blockIdx.y;
  const int cl = F::DS == 2 ? 2 : split;      // the cluster's blocks
  const int rank = blockIdx.x % cl;           // the cluster rank where cl > 1
  const int qrank = F::DS == 2 ? 0 : rank;    // the block's share of the query tiles
  const int qsplit = F::DS == 2 ? 1 : split;
  const int d0 = F::DS == 2 ? rank * DH : 0;  // the block's first head dim
  const int key0 = blockIdx.x / cl * F::KEYS;
  const int n_tiles = (t_len + F::BN - 1) / F::BN;
  const int n_local = qrank < n_tiles ? (n_tiles - qrank + qsplit - 1) / qsplit : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(raw_full(st), 1);
      mbar_init(split_full(st), 3 + 1);         // the splitting warps, the stats' warp
      mbar_init(empty(st), F::CONSUMERS / 32);  // every consumer warp
    }
    mbar_init(kv_bar, 1);
    mbar_init(kv_split, 3);
    for (int w = 0; w < 2; ++w) {
      mbar_init(x_ready(w), 128);  // every thread of the partner's warpgroup w
      mbar_init(x_free(w), 128);
    }
    mbar_fence_init();
  }
  if (F::DS == 2) cluster_sync();  // the partner's barriers exist before any arrival
  else __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<F::PRODUCER_REGS>();
    if (warp == F::CONSUMERS / 32) {
      // the loads: K and V once, then each query tile's Q and dO through
      // the ring, a stage refilled once the consumers let it go; the lanes
      // write the tile's -LSE (in log2 units) and Delta rows (zeros past T)
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * F::KTILE);
        for (int pn = 0; pn < DH / F::W; ++pn) {
          tma_load_3d(k_hi + pn * F::KEYS * F::SW, &k_map, kv_bar, d0 + pn * F::W, key0, bh);
          tma_load_3d(v_hi + pn * F::KEYS * F::SW, &v_map, kv_bar, d0 + pn * F::W, key0, bh);
        }
      }
      const size_t head = (size_t)bh * t_len;  // this head's first row
      for (int j = 0; j < n_local; ++j) {
        const int st = j % S;
        const int q0 = (qrank + j * qsplit) * F::BN;
        if (j >= S) mbar_wait(empty(st), ((j / S) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(raw_full(st), 2 * F::QTILE);
          for (int pn = 0; pn < DH / F::W; ++pn) {
            tma_load_3d(base + stage_at(st) + pn * F::BN * F::SW, &q_map, raw_full(st),
                        d0 + pn * F::W, q0, bh);
            tma_load_3d(base + stage_at(st) + 2 * F::QTILE + pn * F::BN * F::SW, &do_map,
                        raw_full(st), d0 + pn * F::W, q0, bh);
          }
        }
        float* const rows = stats + st * 2 * F::BN;
        for (int i = lane; i < F::BN; i += 32) {
          const bool ok = q0 + i < t_len;
          rows[i] = ok ? -lse[head + q0 + i] * kLog2e : 0.f;
          rows[F::BN + i] = ok ? delta[head + q0 + i] : 0.f;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(split_full(st));
      }
    } else {
      // the split: K and V hi rounded in place once (their lo parts live in
      // the consumers' registers), then each stage as it lands
      const int sid = threadIdx.x - F::CONSUMERS - 32;
      mbar_wait(kv_bar, 0);
      split_in_place(area, nullptr, 2 * F::KTILE, sid, F::SPLITTERS);
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_split);
      for (int j = 0; j < n_local; ++j) {
        const int st = j % S;
        mbar_wait(raw_full(st), (j / S) & 1);
        split_keys<DH, F::BN, false, true>(area + stage_at(st), sid, F::SPLITTERS);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(split_full(st));
      }
    }
    // the consumers' cluster barriers: one at the end (DS = 2), or two
    // around the split's sum
    if (cl > 1) cluster_sync();
    if (F::DS == 1 && split > 1) cluster_sync();
    return;
  }

  setmaxnreg_inc<F::CONSUMER_REGS>();
  const int g = lane >> 2, tq = lane & 3;
  const int ct = threadIdx.x % 128;               // the thread in its warpgroup
  const int rows0 = F::PAIR ? 64 * wg : 0;        // this warpgroup's first key in the block
  const int row0 = key0 + rows0 + 16 * (warp % 4) + g;
  // A operands' lo fragments from the rows in device memory (k8 step kd:
  // rows g, g + 8, columns d0 + 8kd + tq, + 4; zeros past T)
  auto load_lo = [&](const float* __restrict__ x, uint32_t (&lo)[DH / 8][4]) {
    const float* const src = x + ((size_t)bh * t_len + row0) * D + d0 + tq;
#pragma unroll
    for (int kd = 0; kd < DH / 8; ++kd) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i & 1, c = 8 * kd + 4 * (i >> 1);
        const float y = row0 + 8 * r < t_len ? src[(size_t)8 * r * D + c] : 0.f;
        uint32_t hi;
        split_tf32(y, hi, lo[kd][i]);
      }
    }
  };
  // the k8 slices of this warpgroup's K or V hi rows, and of a stage's Q or
  // dO (B of S^T and dP^T) and of its Q^T or dO^T (B of dK and dV)
  auto a_at = [&](uint32_t tile, int kd) { return tile + rows0 * F::SW + kslice8<F::SW>(kd, F::KEYS); };
  auto b_at = [&](uint32_t tile, int kd) { return tile + kslice8<F::SW>(kd, F::BN); };
  auto bt_at = [&](uint32_t tile, int kk, int c) {
    return tile + kslice8<F::VSW>(kk, DH) + c * F::NC * F::VSW;
  };
  // P^T = exp2(X c - LSE) in place, query columns >= T given P = 0
  // explicitly (a zero LSE would give exp2(0) = 1); a full query tile
  // takes no mask
  auto exp_p = [&](float (&x)[F::BN / 8][4], const float* lse_s, int n_valid) {
    if (n_valid >= F::BN) {
#pragma unroll
      for (int j = 0; j < F::BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float neg_lse = lse_s[8 * j + 2 * tq + c];
#pragma unroll
          for (int e = c; e < 4; e += 2) x[j][e] = exp2_approx(fmaf(x[j][e], scale_log2, neg_lse));
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < F::BN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * j + 2 * tq + c;
        const float neg_lse = lse_s[col];
        const bool ok = col < n_valid;
#pragma unroll
        for (int e = c; e < 4; e += 2)
          x[j][e] = ok ? exp2_approx(fmaf(x[j][e], scale_log2, neg_lse)) : 0.f;
      }
    }
  };
  float acc[F::ACCS][DH / F::NC][F::NC / 8][4];  // dV and dK (PAIR); dV (warpgroup 0) or dK (1)
#pragma unroll
  for (int a = 0; a < F::ACCS; ++a) {
#pragma unroll
    for (int c = 0; c < DH / F::NC; ++c) {
#pragma unroll
      for (int j = 0; j < F::NC / 8; ++j) acc[a][c][j][0] = acc[a][c][j][1] = acc[a][c][j][2] = acc[a][c][j][3] = 0.f;
    }
  }

  if constexpr (F::PAIR) {
    uint32_t klo[DH / 8][4], vlo[DH / 8][4];
    load_lo(k, klo);
    load_lo(v, vlo);
    mbar_wait(kv_split, 0);
    for (int it = 0; it < n_local; ++it) {
      const int st = it % S;
      mbar_wait(split_full(st), (it / S) & 1);
      const uint32_t qs = base + stage_at(st), ds = qs + 2 * F::QTILE;
      // S^T = K Q^T and dP^T = V dO^T, two independent chains
      float s[F::BN / 8][4], dp[F::BN / 8][4];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DH / 8; ++kd) {
        wgmma_3xtf32_sr(s, make_desc(a_at(k_hi, kd), F::SW), klo[kd], make_desc(b_at(qs, kd), F::SW),
                        make_desc(b_at(qs + F::QTILE, kd), F::SW), kd > 0);
        wgmma_3xtf32_sr(dp, make_desc(a_at(v_hi, kd), F::SW), vlo[kd], make_desc(b_at(ds, kd), F::SW),
                        make_desc(b_at(ds + F::QTILE, kd), F::SW), kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      // P^T, then dS^T = P^T o (dP^T - Delta)
      const float* const lse_s = stats + st * 2 * F::BN;
      const float* const delta_s = lse_s + F::BN;
      exp_p(s, lse_s, t_len - (qrank + it * qsplit) * F::BN);
#pragma unroll
      for (int j = 0; j < F::BN / 8; ++j) {
        const float e0 = delta_s[8 * j + 2 * tq], e1 = delta_s[8 * j + 2 * tq + 1];
        dp[j][0] = s[j][0] * (dp[j][0] - e0);
        dp[j][1] = s[j][1] * (dp[j][1] - e1);
        dp[j][2] = s[j][2] * (dp[j][2] - e0);
        dp[j][3] = s[j][3] * (dp[j][3] - e1);
      }
      SplitTf32 p[F::BN / 8], dsa[F::BN / 8];
#pragma unroll
      for (int kk = 0; kk < F::BN / 8; ++kk) {
        p[kk] = split_a_tf32(s[kk]);
        dsa[kk] = split_a_tf32(dp[kk]);
      }
      // dV += P^T dO against dO^T, dK += dS^T Q against Q^T, interleaved
      const uint32_t qt = qs + 4 * F::QTILE, dot = qs + 6 * F::QTILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::BN / 8; ++kk) {
#pragma unroll
        for (int c = 0; c < DH / F::NC; ++c) {
          wgmma_3xtf32_rs(acc[0][c], p[kk], make_desc(bt_at(dot, kk, c), F::VSW),
                          make_desc(bt_at(dot + F::QTILE, kk, c), F::VSW));
          wgmma_3xtf32_rs(acc[1][c], dsa[kk], make_desc(bt_at(qt, kk, c), F::VSW),
                          make_desc(bt_at(qt + F::QTILE, kk, c), F::VSW));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < DH / F::NC; ++c) {
        fence_acc(acc[0][c]);
        fence_acc(acc[1][c]);
      }
      if (lane == 0) mbar_arrive(empty(st));  // this stage is free for the producer
    }
  } else {
    // this warpgroup's A lo fragments: K lo (warpgroup 0) or V lo (1)
    uint32_t alo[DH / 8][4];
    load_lo(wg == 0 ? k : v, alo);
    // DS = 2: this thread's slot of the partner's inbox (where it sends its
    // partial S^T or dP^T) and of its own (where the partner's arrive)
    const uint32_t slot = base + F::INBOX + threadIdx.x * (F::BN / 2) * 4;
    const uint32_t partner_slot = F::DS == 2 ? map_to_rank(slot, rank ^ 1) : 0;
    const uint32_t a_hi = wg == 0 ? k_hi : v_hi;
    mbar_wait(kv_split, 0);
    for (int it = 0; it < n_local; ++it) {
      const int st = it % S, pb = it & 1;
      mbar_wait(split_full(st), (it / S) & 1);
      const uint32_t qs = base + stage_at(st);
      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1), 3xTF32 over this
      // block's head dims, Q or dO hi/lo as stored
      const uint32_t b_hi = wg == 0 ? qs : qs + 2 * F::QTILE;
      float x[F::BN / 8][4];  // S^T, then P^T (warpgroup 0); dP^T, then dS^T (1)
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DH / 8; ++kd)
        wgmma_3xtf32_sr(x, make_desc(a_at(a_hi, kd), F::SW), alo[kd],
                        make_desc(b_at(b_hi, kd), F::SW), make_desc(b_at(b_hi + F::QTILE, kd), F::SW),
                        kd > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(x);
      // DS = 2: the two halves' partial S^T (or dP^T), added in rank order
      if (F::DS == 2)
        add_partner_partials<F::BN / 8>(
            partner_slot,
            reinterpret_cast<const float*>(area + F::INBOX) + threadIdx.x * (F::BN / 2),
            x_ready(wg), x_free(wg), rank, it, x);
      const float* const lse_s = stats + st * 2 * F::BN;
      float4* const pbuf = reinterpret_cast<float4*>(area + F::PBUF + pb * F::PTILE);
      if (wg == 0) {
        exp_p(x, lse_s, t_len - (qrank + it * qsplit) * F::BN);
        // to warpgroup 1, each thread's fragment at its own place
        if (it >= 2) named_sync(kPFree + pb, F::CONSUMERS);
#pragma unroll
        for (int j = 0; j < F::BN / 8; ++j)
          pbuf[j * 128 + ct] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
        named_arrive(kPFull + pb, F::CONSUMERS);
      } else {
        // dS^T = P^T o (dP^T - Delta), P^T from warpgroup 0
        const float* const delta_s = lse_s + F::BN;
        named_sync(kPFull + pb, F::CONSUMERS);
#pragma unroll
        for (int j = 0; j < F::BN / 8; ++j) {
          const float4 pt = pbuf[j * 128 + ct];
          const float e0 = delta_s[8 * j + 2 * tq], e1 = delta_s[8 * j + 2 * tq + 1];
          x[j][0] = pt.x * (x[j][0] - e0);
          x[j][1] = pt.y * (x[j][1] - e1);
          x[j][2] = pt.z * (x[j][2] - e0);
          x[j][3] = pt.w * (x[j][3] - e1);
        }
        if (it + 2 < n_local) named_arrive(kPFree + pb, F::CONSUMERS);
      }
      SplitTf32 a[F::BN / 8];  // P^T or dS^T as the A operand, hi and lo
#pragma unroll
      for (int kk = 0; kk < F::BN / 8; ++kk) a[kk] = split_a_tf32(x[kk]);
      // dV += P^T dO (warpgroup 0) against dO^T, or dK += dS^T Q (1)
      // against Q^T, 3xTF32 (queries along the rows of both)
      const uint32_t bt_hi = qs + (wg == 0 ? 6 : 4) * F::QTILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::BN / 8; ++kk) {
#pragma unroll
        for (int c = 0; c < DH / F::NC; ++c)
          wgmma_3xtf32_rs(acc[0][c], a[kk], make_desc(bt_at(bt_hi, kk, c), F::VSW),
                          make_desc(bt_at(bt_hi + F::QTILE, kk, c), F::VSW));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < DH / F::NC; ++c) fence_acc(acc[0][c]);
      if (lane == 0) mbar_arrive(empty(st));  // this stage is free for the producer
    }
  }

  // accumulator a: dV (a = 0 where PAIR, and warpgroup 0's), else dK
  auto is_dv = [&](int a) { return F::PAIR ? a == 0 : wg == 0; };
  const bool halves = F::DS == 1 && split > 1;
  constexpr int HALF = F::NB / 2;
  auto red_slot = [&](int a, int nb) {  // a float4 of the partial sums
    return ((wg * F::ACCS + a) * HALF + nb % HALF) * 128 + ct;
  };
  if (halves) {
    // the other block's half of each accumulator's n8 blocks: leave it in
    // the ring's space (free once both warpgroups are here), read the other
    // block's share of this block's half, add
    named_sync(kConsumerBar, F::CONSUMERS);
    float4* const red = reinterpret_cast<float4*>(area + F::RING);
    const int other = rank ^ 1;
#pragma unroll
    for (int a = 0; a < F::ACCS; ++a) {
#pragma unroll
      for (int c = 0; c < DH / F::NC; ++c) {
#pragma unroll
        for (int j = 0; j < F::NC / 8; ++j) {
          const int nb = c * (F::NC / 8) + j;
          if (nb / HALF != other) continue;
          red[red_slot(a, nb)] =
              make_float4(acc[a][c][j][0], acc[a][c][j][1], acc[a][c][j][2], acc[a][c][j][3]);
        }
      }
    }
    cluster_sync();
    const uint32_t red_at = smem_u32(red);
#pragma unroll
    for (int a = 0; a < F::ACCS; ++a) {
#pragma unroll
      for (int c = 0; c < DH / F::NC; ++c) {
#pragma unroll
        for (int j = 0; j < F::NC / 8; ++j) {
          const int nb = c * (F::NC / 8) + j;
          if (nb / HALF != rank) continue;
          const float4 y = ld_cluster_v4(map_to_rank(red_at + 16 * red_slot(a, nb), other));
          acc[a][c][j][0] += y.x;
          acc[a][c][j][1] += y.y;
          acc[a][c][j][2] += y.z;
          acc[a][c][j][3] += y.w;
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < F::ACCS; ++a) {
    const float out_scale = is_dv(a) ? 1.f : scale;
    float* const out = is_dv(a) ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= t_len) continue;
      float* const o = out + ((size_t)bh * t_len + row) * D + d0 + 2 * tq;
#pragma unroll
      for (int c = 0; c < DH / F::NC; ++c) {
#pragma unroll
        for (int j = 0; j < F::NC / 8; ++j) {
          if (halves && (c * (F::NC / 8) + j) / HALF != rank) continue;
          *reinterpret_cast<float2*>(o + c * F::NC + 8 * j) =
              make_float2(acc[a][c][j][2 * r] * out_scale, acc[a][c][j][2 * r + 1] * out_scale);
        }
      }
    }
  }
  // no block leaves while its partner may still signal it or read its
  // shared memory
  if (cl > 1) cluster_sync();
}

// f32 dK/dV: TF32 wgmma with the 3xTF32 split (dkv_tf32), at every D.
template <int D>
__global__ void __launch_bounds__(F32Dkv<D>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int t_len, float scale, float scale_log2,
                     int split) {
  dkv_tf32<D>(q_map, k_map, v_map, do_map, k, v, lse, delta, dk, dv, t_len, scale, scale_log2,
              split);
}

constexpr int kWarpgroups = 2;                   // consumer warpgroups a block
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kHopperThreads = kConsumers + 32;  // and dK/dV's producer warp
constexpr int kBlockRows = 64 * kWarpgroups;     // keys (dK/dV) or queries (dQ) a block

// The [rows, DP] bf16 tiles of the wgmma kernels (wgmma_sm90.cuh).
template <int D> struct HopperDims {
  static constexpr int DP = D < 16 ? 16 : D;              // head dim in shared memory
  static constexpr int SW = 2 * DP < 128 ? 2 * DP : 128;  // bytes a panel row: the swizzle
  static constexpr int W = SW / 2;                        // columns a panel
  static constexpr int PANELS = DP / W;
  static constexpr int NO = W / 8;                        // n8 blocks of an output a panel
};

// The byte offset of the k16 slice kd of a [rows, DP] K-major tile: its
// panel, then 32 bytes a slice along the swizzled row.
template <class F> __device__ __forceinline__ uint32_t kslice(int kd, int rows) {
  return (16 * kd / F::W) * rows * F::SW + (16 * kd % F::W) * 2;
}

template <int D> struct HopperDq : HopperDims<D> {
  static_assert(D <= 64, "D = 128 and 256 take HopperDqWs");
  using B = HopperDims<D>;
  static constexpr int BN = 64;                 // keys a ring stage
  static constexpr int QTILE = 64 * B::DP * 2;  // a warpgroup's [64, DP] Q or dO tile
  static constexpr int KTILE = BN * B::DP * 2;  // a stage's [BN, DP] K or V tile
  // blocks an SM: two at D <= 32, where 128 registers a thread suffice
  static constexpr int MIN_BLOCKS = D <= 32 ? 2 : 1;
  // The ring: STAGES stages of BN keys (a K and a V tile each); the stage
  // of key tile j is refilled (with tile j + STAGES) by thread 0 at the top
  // of iteration j + LAG, once both warpgroups have let it go (each lets go
  // of tile j at the end of iteration j; LAG - 1 iterations of slack before
  // thread 0 waits on the other warpgroup). STAGES - LAG tiles stay ahead.
  static constexpr int STAGES = 6;
  static constexpr int LAG = 3;
  // From the 1024-aligned base: each warpgroup's Q tile, then each one's
  // dO tile; the ring; its barriers (full, empty, then Q and dO's).
  static constexpr int RING = 2 * kWarpgroups * QTILE;
  static constexpr int BARS = RING + STAGES * 2 * KTILE;
  static constexpr int SMEM = 1024 + BARS + 16 * (STAGES + 1);
};

// D <= 64: two warpgroups of 64 queries each, thread 0 issuing the loads.
template <int D>
__device__ __forceinline__ void dq_pair(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                        const CUtensorMap& v_map, const CUtensorMap& do_map,
                                        const __nv_bfloat16* __restrict__ o,
                                        const __nv_bfloat16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                                        int t_len, float scale, float scale_log2) {
  using namespace flash_mma;
  using namespace wgmma_sm90;
  using F = HopperDq<D>;
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  const uint32_t bars = base + F::BARS;
  const uint32_t q_bar = bars + 16 * F::STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F::STAGES + s); };
  auto stage_at = [&](int s) { return base + F::RING + s * 2 * F::KTILE; };  // K, then V

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockRows;
  const int n_tiles = (t_len + F::BN - 1) / F::BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane >> 2, tq = lane & 3;
  const bool loader = threadIdx.x == 0;  // issues every TMA load of the block

  // key tile j (K and V) into stage j % STAGES
  auto load_tile = [&](int j) {
    const int st = j % F::STAGES;
    mbar_arrive_expect_tx(full(st), 2 * F::KTILE);
    for (int pn = 0; pn < F::PANELS; ++pn) {
      tma_load_3d(stage_at(st) + pn * F::BN * F::SW, &k_map, full(st), pn * F::W, F::BN * j, bh);
      tma_load_3d(stage_at(st) + F::KTILE + pn * F::BN * F::SW, &v_map, full(st), pn * F::W,
                  F::BN * j, bh);
    }
  };
  if (loader) {
    for (int st = 0; st < F::STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers / 32);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
    mbar_arrive_expect_tx(q_bar, 2 * kWarpgroups * F::QTILE);
    for (int w = 0; w < kWarpgroups; ++w) {
      for (int pn = 0; pn < F::PANELS; ++pn) {
        tma_load_3d(base + w * F::QTILE + pn * 64 * F::SW, &q_map, q_bar, pn * F::W, m0 + 64 * w,
                    bh);
        tma_load_3d(base + (kWarpgroups + w) * F::QTILE + pn * 64 * F::SW, &do_map, q_bar,
                    pn * F::W, m0 + 64 * w, bh);
      }
    }
    for (int j = 0; j < F::STAGES && j < n_tiles; ++j) load_tile(j);
  }
  __syncthreads();

  // While the tiles arrive: Delta = rowsum(dO o O) of this lane's rows g
  // and g + 8, in f32 from the bf16 rows (columns 8j + 2tq, +1, then over
  // the quad), and their LSE in log2 units; rows >= T get 0 for both, so
  // that their P = 1 meets a zero dO and Delta: dS = 0.
  const int row0 = m0 + 64 * wg + 16 * (warp % 4) + g;
  float dlt[2] = {0.f, 0.f}, neg_lse[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const size_t stat = (size_t)bh * t_len + row;
    if (row < t_len) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const size_t at = stat * D + 8 * j + 2 * tq;
        const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(dout + at);
        const __nv_bfloat162 o2 = *reinterpret_cast<const __nv_bfloat162*>(o + at);
        dlt[r] = fmaf(__bfloat162float(d2.x), __bfloat162float(o2.x), dlt[r]);
        dlt[r] = fmaf(__bfloat162float(d2.y), __bfloat162float(o2.y), dlt[r]);
      }
      neg_lse[r] = -lse[stat] * kLog2e;
    }
    dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 1);
    dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], 2);
    if (row < t_len && tq == 0) delta[stat] = dlt[r];
  }

  const uint32_t q_wg = base + wg * F::QTILE, do_wg = base + (kWarpgroups + wg) * F::QTILE;
  float acc[F::PANELS][F::NO][4];
#pragma unroll
  for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
    for (int j = 0; j < F::NO; ++j) acc[pn][j][0] = acc[pn][j][1] = acc[pn][j][2] = acc[pn][j][3] = 0.f;
  }
  float s[F::BN / 8][4], dp[F::BN / 8][4];  // S, then P; dP, then dS: 64 queries x BN keys
  Split ds[F::BN / 16];                     // dS as the A operand of dS*K, hi and lo

  auto issue_s = [&](int stage) {  // S = Q K^T and dP = dO V^T, two independent chains
    const uint32_t kt = stage_at(stage), vt = kt + F::KTILE;
#pragma unroll
    for (int kd = 0; kd < F::DP / 16; ++kd) {
      wgmma_ss<0>(s, make_desc(q_wg + kslice<F>(kd, 64), F::SW),
                  make_desc(kt + kslice<F>(kd, F::BN), F::SW), kd > 0);
      wgmma_ss<0>(dp, make_desc(do_wg + kslice<F>(kd, 64), F::SW),
                  make_desc(vt + kslice<F>(kd, F::BN), F::SW), kd > 0);
    }
    wgmma_commit();
  };
  auto issue_dq = [&](int stage) {  // dQ += (dS_hi + dS_lo) K, K read MN-major
    const uint32_t kt = stage_at(stage);
#pragma unroll
    for (int kk = 0; kk < F::BN / 16; ++kk) {
#pragma unroll
      for (int pn = 0; pn < F::PANELS; ++pn)
        wgmma_split(acc[pn], ds[kk],
                    make_desc(kt + pn * F::BN * F::SW + kk * 16 * F::SW, F::SW));
    }
    wgmma_commit();
  };
  // P = exp2(S c - LSE) and dS = P o (dP - Delta) on the accumulators; key
  // columns >= T get P = 0 explicitly (a zero-filled K gives S = 0, and
  // exp2(0 - LSE) is not 0)
  auto grads = [&](int n_valid) {
#pragma unroll
    for (int j = 0; j < F::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool ok = n_valid >= F::BN || 8 * j + 2 * tq + (e & 1) < n_valid;
        const float p = ok ? exp2_approx(fmaf(s[j][e], scale_log2, neg_lse[r])) : 0.f;
        dp[j][e] = p * (dp[j][e] - dlt[r]);
      }
    }
  };
  auto split_ds = [&]() {
#pragma unroll
    for (int kk = 0; kk < F::BN / 16; ++kk) ds[kk] = split_a_trunc(dp[2 * kk], dp[2 * kk + 1]);
  };
  auto release = [&](int stage) {
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) fence_acc(acc[pn]);
    if (lane == 0) mbar_arrive(empty(stage));
  };

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % F::STAGES;
    const int refill = j - F::LAG + F::STAGES;  // into the stage of tile j - LAG
    if (loader && j >= F::LAG && refill < n_tiles) {
      mbar_wait(empty(refill % F::STAGES), ((j - F::LAG) / F::STAGES) & 1);
      load_tile(refill);
    }
    mbar_wait(full(stage), (j / F::STAGES) & 1);
    wgmma_fence();
    issue_s(stage);
    wgmma_wait<0>();
    fence_acc(s);
    fence_acc(dp);
    grads(t_len - F::BN * j);
    split_ds();
    wgmma_fence();
    issue_dq(stage);
    wgmma_wait<0>();
    release(stage);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t_len) continue;
    __nv_bfloat16* const out = dq + ((size_t)bh * t_len + row) * D + 2 * tq;
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
      for (int j = 0; j < F::NO; ++j) {
        if (D >= 16 || 8 * j < D)  // D = 8: the zero-filled columns 8..15 stay unwritten
          *reinterpret_cast<uint32_t*>(out + pn * F::W + 8 * j) =
              pack_bf16(acc[pn][j][2 * r] * scale, acc[pn][j][2 * r + 1] * scale);
      }
    }
  }
}

// D = 128 and 256: a warp-specialised block of one 64-query tile (see the
// file's note): consumer warpgroup 0 computes S and P, consumer warpgroup 1
// Delta, dP and dS, P and dS passing between them through shared memory,
// and each accumulates half of dQ's columns; a producer warpgroup gives its
// registers to them and streams the tiles.
template <int D> struct HopperDqWs : HopperDims<D> {
  static_assert(D == 128 || D == 256, "the warp-specialised dQ is built for D = 128, 256");
  using B = HopperDims<D>;
  static constexpr int BN = 64;                    // keys a ring stage
  static constexpr int CONSUMERS = 256;            // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  // registers a thread after setmaxnreg; 40 * 128 + 232 * 256 = 168 * 384,
  // the launch's 168 (65536 registers over 384 threads)
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int QTILE = 64 * B::DP * 2;     // [64 queries, DP]: Q or dO
  static constexpr int KTILE = BN * B::DP * 2;     // [BN keys, DP]: K or V
  static constexpr int STAGES = D == 128 ? 4 : 2;  // 2 fill 227 KB at D = 256
  static constexpr int XTILE = 64 * BN * 4;        // P in f32, or dS's hi/lo bf16 pairs
  static constexpr int HALF = B::PANELS / 2;       // dQ's panels a consumer warpgroup
  // From the 1024-aligned base: the Q tile, the dO tile; the ring (a K and a
  // V tile a stage); the P and the dS buffer; the barriers (full, empty,
  // then Q/dO's).
  static constexpr int RING = 2 * QTILE;
  static constexpr int XBUF = RING + STAGES * 2 * KTILE;
  static constexpr int BARS = XBUF + 2 * XTILE;
  static constexpr int SMEM = 1024 + BARS + 8 * (2 * STAGES + 1);
  static_assert(SMEM <= 232448, "227 KB a block");
  // Split over a cluster of 2, block `rank` finishes the n8 blocks [rank *
  // HB, (rank + 1) * HB) of each warpgroup's accumulator (HALF * NO of
  // them) and leaves the other HB float4 a thread in the ring's space for
  // the other block to add.
  static constexpr int HB = HALF * B::NO / 2;
  static_assert(2 * 128 * HB * 16 <= XBUF - RING, "the partial sums overlay the ring");
};

// D = 128 and 256: one 64-query tile a block, its key tiles dealt over a
// cluster of `split` blocks (the file's note). Warpgroup 0 (threads 0-127):
// S and P; warpgroup 1 (128-255): Delta, dP and dS; each then dQ's columns
// of its half; the producer warpgroup (256-383): the loads.
template <int D>
__device__ __forceinline__ void dq_ws(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                      const CUtensorMap& v_map, const CUtensorMap& do_map,
                                      const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                                      int t_len, float scale, float scale_log2, int split) {
  using namespace flash_mma;
  using namespace wgmma_sm90;
  using F = HopperDqWs<D>;
  // named barriers between the two consumer warpgroups: P written (1), dS
  // written (2); both consumers (3)
  constexpr int kPFull = 1, kDsFull = 2, kConsumerBar = 3;
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  char* const at0 = raw + (base - smem_u32(raw));
  const uint32_t bars = base + F::BARS;
  const uint32_t q_bar = bars + 16 * F::STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F::STAGES + s); };
  auto k_at = [&](int s) { return base + F::RING + s * 2 * F::KTILE; };  // K, then V

  const int bh = blockIdx.y;
  const int rank = blockIdx.x % split;  // the cluster rank where split > 1
  const int m0 = blockIdx.x / split * 64;
  const int n_tiles = (t_len + F::BN - 1) / F::BN;
  const int n_local = rank < n_tiles ? (n_tiles - rank + split - 1) / split : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), F::CONSUMERS / 32);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<F::PRODUCER_REGS>();
    if (threadIdx.x == F::CONSUMERS) {
      // the loads: the tile's Q and dO once, then the block's key tiles (K,
      // V) through the ring, a stage refilled once both consumers let it go
      mbar_arrive_expect_tx(q_bar, 2 * F::QTILE);
      for (int pn = 0; pn < F::PANELS; ++pn) {
        tma_load_3d(base + pn * 64 * F::SW, &q_map, q_bar, pn * F::W, m0, bh);
        tma_load_3d(base + F::QTILE + pn * 64 * F::SW, &do_map, q_bar, pn * F::W, m0, bh);
      }
      for (int j = 0; j < n_local; ++j) {
        const int s = j % F::STAGES;
        if (j >= F::STAGES) mbar_wait(empty(s), ((j / F::STAGES) & 1) ^ 1);
        const int k0 = (rank + j * split) * F::BN;
        mbar_arrive_expect_tx(full(s), 2 * F::KTILE);
        for (int pn = 0; pn < F::PANELS; ++pn) {
          tma_load_3d(k_at(s) + pn * F::BN * F::SW, &k_map, full(s), pn * F::W, k0, bh);
          tma_load_3d(k_at(s) + F::KTILE + pn * F::BN * F::SW, &v_map, full(s), pn * F::W, k0, bh);
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
  const int ct = threadIdx.x % 128;      // the thread in its warpgroup
  const int r0 = 16 * (warp % 4) + g;    // its rows of the tile: r0 and r0 + 8
  float acc[F::HALF][F::NO][4];          // dQ's columns of this warpgroup's half
#pragma unroll
  for (int p = 0; p < F::HALF; ++p) {
#pragma unroll
    for (int j = 0; j < F::NO; ++j) acc[p][j][0] = acc[p][j][1] = acc[p][j][2] = acc[p][j][3] = 0.f;
  }
  float x[F::BN / 8][4];  // S, then P (warpgroup 0); dP, then dS (1): 64 queries x BN keys
  Split a[F::BN / 16];    // dS as the A operand of dS*K, hi and lo
  float4* const pbuf = reinterpret_cast<float4*>(at0 + F::XBUF);
  uint4* const dsbuf = reinterpret_cast<uint4*>(at0 + F::XBUF + F::XTILE);
  // Q and K^T (warpgroup 0) or dO and V^T (1) for S or dP
  const uint32_t a_tile = base + wg * F::QTILE;
  // While the tiles arrive: the LSE of this thread's rows r0 and r0 + 8 in
  // log2 units, negated (warpgroup 0), or their Delta = rowsum(dO o O) in
  // f32 from the bf16 rows in device memory (1): the quad's lanes take
  // 16-byte chunks tq, tq + 4, ..., all loads issued before the sums, then
  // shuffles; block 0 of a cluster writes it for dK/dV. Rows >= T get 0
  // for both, so that their P = 1 meets a zero dO and Delta: dS = 0.
  float row_v[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + 8 * r;
    const size_t stat = (size_t)bh * t_len + row;
    if (wg == 0) {
      if (row < t_len) row_v[r] = -lse[stat] * kLog2e;
      continue;
    }
    if (row < t_len) {
      uint4 d8[D / 32], o8[D / 32];
      const uint4* const drow = reinterpret_cast<const uint4*>(dout + stat * D);
      const uint4* const orow = reinterpret_cast<const uint4*>(o + stat * D);
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        d8[i] = drow[tq + 4 * i];
        o8[i] = orow[tq + 4 * i];
      }
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const uint32_t dw[4] = {d8[i].x, d8[i].y, d8[i].z, d8[i].w};
        const uint32_t ow[4] = {o8[i].x, o8[i].y, o8[i].z, o8[i].w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          row_v[r] = fmaf(__uint_as_float(dw[w] << 16), __uint_as_float(ow[w] << 16), row_v[r]);
          row_v[r] = fmaf(__uint_as_float(dw[w] & 0xffff0000u), __uint_as_float(ow[w] & 0xffff0000u),
                          row_v[r]);
        }
      }
    }
    row_v[r] += __shfl_xor_sync(0xffffffffu, row_v[r], 1);
    row_v[r] += __shfl_xor_sync(0xffffffffu, row_v[r], 2);
    if (rank == 0 && row < t_len && tq == 0) delta[stat] = row_v[r];
  }
  mbar_wait(q_bar, 0);
  for (int it = 0; it < n_local; ++it) {
    const int stage = it % F::STAGES;
    mbar_wait(full(stage), (it / F::STAGES) & 1);
    const uint32_t kt = k_at(stage);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < F::DP / 16; ++kd)
      wgmma_ss<0>(x, make_desc(a_tile + kslice<F>(kd, 64), F::SW),
                  make_desc(kt + wg * F::KTILE + kslice<F>(kd, F::BN), F::SW), kd > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(x);
    if (wg == 0) {
      // P = exp2(S c - LSE); key columns >= T get P = 0 explicitly (a
      // zero-filled K gives S = 0, and exp2(0 - LSE) is not 0)
      const int n_valid = t_len - (rank + it * split) * F::BN;
#pragma unroll
      for (int j = 0; j < F::BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = 8 * j + 2 * tq + (e & 1) < n_valid;
          x[j][e] = ok ? exp2_approx(fmaf(x[j][e], scale_log2, row_v[e >> 1])) : 0.f;
        }
      }
      // to warpgroup 1, each thread's fragment at its own place (free: warpgroup
      // 1 read the last P before it wrote the dS read below)
#pragma unroll
      for (int j = 0; j < F::BN / 8; ++j)
        pbuf[j * 128 + ct] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      named_arrive(kPFull, F::CONSUMERS);
      named_sync(kDsFull, F::CONSUMERS);
#pragma unroll
      for (int kk = 0; kk < F::BN / 16; ++kk) {
        const uint4 hi = dsbuf[2 * kk * 128 + ct], lo = dsbuf[(2 * kk + 1) * 128 + ct];
        a[kk].hi[0] = hi.x, a[kk].hi[1] = hi.y, a[kk].hi[2] = hi.z, a[kk].hi[3] = hi.w;
        a[kk].lo[0] = lo.x, a[kk].lo[1] = lo.y, a[kk].lo[2] = lo.z, a[kk].lo[3] = lo.w;
      }
    } else {
      // dS = P o (dP - Delta), P from warpgroup 0; its hi/lo split to
      // warpgroup 0 (free: warpgroup 0 read the last dS before it wrote P)
      named_sync(kPFull, F::CONSUMERS);
#pragma unroll
      for (int j = 0; j < F::BN / 8; ++j) {
        const float4 p = pbuf[j * 128 + ct];
        x[j][0] = p.x * (x[j][0] - row_v[0]);
        x[j][1] = p.y * (x[j][1] - row_v[0]);
        x[j][2] = p.z * (x[j][2] - row_v[1]);
        x[j][3] = p.w * (x[j][3] - row_v[1]);
      }
#pragma unroll
      for (int kk = 0; kk < F::BN / 16; ++kk) {
        a[kk] = split_a_trunc(x[2 * kk], x[2 * kk + 1]);
        dsbuf[2 * kk * 128 + ct] = make_uint4(a[kk].hi[0], a[kk].hi[1], a[kk].hi[2], a[kk].hi[3]);
        dsbuf[(2 * kk + 1) * 128 + ct] =
            make_uint4(a[kk].lo[0], a[kk].lo[1], a[kk].lo[2], a[kk].lo[3]);
      }
      named_arrive(kDsFull, F::CONSUMERS);
    }
    // dQ += (dS_hi + dS_lo) K on this warpgroup's panels, K read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < F::BN / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < F::HALF; ++p)
        wgmma_split(acc[p], a[kk],
                    make_desc(kt + (wg * F::HALF + p) * F::BN * F::SW + kk * 16 * F::SW, F::SW));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < F::HALF; ++p) fence_acc(acc[p]);
    if (lane == 0) mbar_arrive(empty(stage));  // this stage is free for the producer
  }

  if (split > 1) {
    // the other block's share of this warpgroup's sums: leave it in the
    // ring's space (free once both warpgroups are here), read the other
    // block's share of this block's, add
    named_sync(kConsumerBar, F::CONSUMERS);
    float4* const red = reinterpret_cast<float4*>(at0 + F::RING);
    const int other = rank ^ 1;
#pragma unroll
    for (int p = 0; p < F::HALF; ++p) {
#pragma unroll
      for (int j = 0; j < F::NO; ++j) {
        const int b = p * F::NO + j;
        if (b / F::HB == other)
          red[(wg * F::HB + b % F::HB) * 128 + ct] =
              make_float4(acc[p][j][0], acc[p][j][1], acc[p][j][2], acc[p][j][3]);
      }
    }
    cluster_sync();
    const uint32_t red_at = smem_u32(red);
#pragma unroll
    for (int p = 0; p < F::HALF; ++p) {
#pragma unroll
      for (int j = 0; j < F::NO; ++j) {
        const int b = p * F::NO + j;
        if (b / F::HB != rank) continue;
        const float4 y =
            ld_cluster_v4(map_to_rank(red_at + 16 * ((wg * F::HB + b % F::HB) * 128 + ct), other));
        acc[p][j][0] += y.x;
        acc[p][j][1] += y.y;
        acc[p][j][2] += y.z;
        acc[p][j][3] += y.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + r0 + 8 * r;
    if (row >= t_len) continue;
    __nv_bfloat16* const out = dq + ((size_t)bh * t_len + row) * D + 2 * tq;
#pragma unroll
    for (int p = 0; p < F::HALF; ++p) {
#pragma unroll
      for (int j = 0; j < F::NO; ++j) {
        if (split > 1 && (p * F::NO + j) / F::HB != rank) continue;
        *reinterpret_cast<uint32_t*>(out + (wg * F::HALF + p) * F::W + 8 * j) =
            pack_bf16(acc[p][j][2 * r] * scale, acc[p][j][2 * r + 1] * scale);
      }
    }
  }
  if (split > 1) cluster_sync();  // no block leaves while the other reads its shared memory
}

// Launch shape of flash_bwd_dq_wgmma_kernel<D>.
template <int D> struct DqLaunch {
  static constexpr bool WS = D >= 128;
  static constexpr int THREADS = WS ? HopperDqWs<(WS ? D : 128)>::THREADS : kConsumers;
  static constexpr int MIN_BLOCKS = WS ? 1 : HopperDq<(WS ? 64 : D)>::MIN_BLOCKS;
};

template <int D>
__global__ void __launch_bounds__(DqLaunch<D>::THREADS, DqLaunch<D>::MIN_BLOCKS)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int t_len,
                          float scale, float scale_log2, int split) {
  if constexpr (DqLaunch<D>::WS)
    dq_ws<D>(q_map, k_map, v_map, do_map, o, dout, lse, dq, delta, t_len, scale, scale_log2,
             split);
  else
    dq_pair<D>(q_map, k_map, v_map, do_map, o, dout, lse, dq, delta, t_len, scale, scale_log2);
}

template <int D> struct HopperDkv : HopperDims<D> {
  static_assert(D <= 64, "D = 128 and 256 take HopperDkvWs");
  using B = HopperDims<D>;
  static constexpr int BQ = 64;                 // queries a ring stage
  static constexpr int KTILE = 64 * B::DP * 2;  // [64 keys, DP]
  static constexpr int QTILE = BQ * B::DP * 2;  // [BQ queries, DP]
  static constexpr int STAGES = D == 64 ? 3 : 4;
  // From the 1024-aligned base: each warpgroup's K tile, then each one's V
  // tile; the ring (a Q and a dO tile a stage); the LSE and Delta rows of
  // each stage; the barriers (full, empty, then K/V's).
  static constexpr int RING = 2 * kWarpgroups * KTILE;
  static constexpr int STATS = RING + STAGES * 2 * QTILE;
  static constexpr int BARS = STATS + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = 1024 + BARS + 16 * (STAGES + 1);
};

// D = 128 and 256: a warp-specialised block of one 64-key tile (see the
// file's note): consumer warpgroup 0 computes S^T and P^T and accumulates
// dV, consumer warpgroup 1 computes dP^T and accumulates dK, P^T passing
// between them through shared memory; a producer warpgroup gives its
// registers to them and streams the query tiles.
template <int D> struct HopperDkvWs : HopperDims<D> {
  static_assert(D == 128 || D == 256, "the warp-specialised dK/dV is built for D = 128, 256");
  using B = HopperDims<D>;
  static constexpr int BQ = 64;                    // queries a ring stage
  static constexpr int CONSUMERS = 256;            // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  // registers a thread after setmaxnreg; 40 * 128 + 232 * 256 = 168 * 384,
  // the launch's 168 (65536 registers over 384 threads)
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int KTILE = 64 * B::DP * 2;     // [64 keys, DP]
  static constexpr int QTILE = BQ * B::DP * 2;     // [BQ queries, DP]
  static constexpr int STAGES = D == 128 ? 4 : 2;  // as many as fit in 227 KB
  static constexpr int PTILE = 64 * BQ * 4;        // P^T of one query tile, f32
  // From the 1024-aligned base: the K tile, the V tile; the ring (a Q and
  // a dO tile a stage); two P^T buffers; the LSE and Delta rows of each
  // stage; the barriers (full, empty, then K/V's).
  static constexpr int RING = 2 * KTILE;
  static constexpr int PBUF = RING + STAGES * 2 * QTILE;
  static constexpr int STATS = PBUF + 2 * PTILE;
  static constexpr int BARS = STATS + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = 1024 + BARS + 8 * (2 * STAGES + 1);
  static_assert(SMEM <= 232448, "227 KB a block");
  // Split over a cluster of 2, block `rank` finishes the panels [rank *
  // HALF, (rank + 1) * HALF) of dK and dV: each warpgroup leaves the other
  // half of its accumulator (HALF * NO float4 a thread) in the ring's space
  // for the other block to add.
  static constexpr int HALF = B::PANELS / 2;
  static constexpr int RED_BYTES = 2 * 128 * HALF * B::NO * 16;
  static_assert(RED_BYTES <= PBUF - RING, "the partial sums overlay the ring");
};

// Launch shape of flash_bwd_dkv_wgmma_kernel<D>.
template <int D> struct DkvLaunch {
  static constexpr bool WS = D >= 128;
  static constexpr int THREADS = WS ? HopperDkvWs<(WS ? D : 128)>::THREADS : kHopperThreads;
};

// D <= 64: two consumer warpgroups of 64 keys each and one producer warp.
template <int D>
__device__ __forceinline__ void dkv_pair(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                         const CUtensorMap& v_map, const CUtensorMap& do_map,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         __nv_bfloat16* __restrict__ dk,
                                         __nv_bfloat16* __restrict__ dv, int t_len, float scale,
                                         float scale_log2) {
  using namespace flash_mma;
  using namespace wgmma_sm90;
  using F = HopperDkv<D>;
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  float* const stats = reinterpret_cast<float*>(raw + (base - smem_u32(raw)) + F::STATS);
  const uint32_t bars = base + F::BARS;
  const uint32_t kv_bar = bars + 16 * F::STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F::STAGES + s); };
  auto q_at = [&](int s) { return base + F::RING + s * 2 * F::QTILE; };  // Q, then dO
  auto k_at = [&](int w) { return base + w * F::KTILE; };
  auto v_at = [&](int w) { return base + (kWarpgroups + w) * F::KTILE; };

  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kBlockRows;
  const int n_tiles = (t_len + F::BQ - 1) / F::BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA's bytes, then each producer lane's rows
      mbar_init(empty(s), kConsumers / 32);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: the block's K and V once, then every query tile's Q
    // and dO by TMA and its LSE and Delta rows by the warp's lanes (zeros
    // past T) through the ring. (A 1-D tensor map of the [BH*T] rows
    // faulted on the card where BH*T*4 bytes is not a multiple of 16.)
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * kWarpgroups * F::KTILE);
      for (int w = 0; w < kWarpgroups; ++w) {
        for (int pn = 0; pn < F::PANELS; ++pn) {
          tma_load_3d(k_at(w) + pn * 64 * F::SW, &k_map, kv_bar, pn * F::W, key0 + 64 * w, bh);
          tma_load_3d(v_at(w) + pn * 64 * F::SW, &v_map, kv_bar, pn * F::W, key0 + 64 * w, bh);
        }
      }
    }
    const size_t head = (size_t)bh * t_len;  // this head's first row
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % F::STAGES;
      const int q0 = j * F::BQ;
      mbar_wait(empty(s), ((j / F::STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(full(s), 2 * F::QTILE);
        for (int pn = 0; pn < F::PANELS; ++pn) {
          tma_load_3d(q_at(s) + pn * F::BQ * F::SW, &q_map, full(s), pn * F::W, q0, bh);
          tma_load_3d(q_at(s) + F::QTILE + pn * F::BQ * F::SW, &do_map, full(s), pn * F::W, q0,
                      bh);
        }
      }
      float* const st = stats + s * 2 * F::BQ;
      for (int i = lane; i < F::BQ; i += 32) {
        const bool ok = q0 + i < t_len;
        st[i] = ok ? lse[head + q0 + i] : 0.f;
        st[F::BQ + i] = ok ? delta[head + q0 + i] : 0.f;
      }
      mbar_arrive(full(s));
    }
  } else {
    const int wg = warp / 4;
    const int g = lane >> 2, tq = lane & 3;
    float dk_acc[F::PANELS][F::NO][4], dv_acc[F::PANELS][F::NO][4];
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
      for (int j = 0; j < F::NO; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[pn][j][e] = dv_acc[pn][j][e] = 0.f;
      }
    }
    float s[F::BQ / 8][4], dp[F::BQ / 8][4];  // S^T and dP^T: 64 keys x BQ queries
    Split p[F::BQ / 16], ds[F::BQ / 16];      // P^T and dS^T as A operands, hi and lo

    // The two warpgroups take turns at issuing each group of products
    // (named barriers 1 and 2; warpgroup 0 first), so that one's exp2 and
    // dS run while the other's products do (FlashAttention-3's ping-pong).
    auto my_turn = [&]() { named_sync(1 + wg, kConsumers); };
    auto your_turn = [&]() { named_arrive(2 - wg, kConsumers); };
    if (wg == 0) named_arrive(1, kConsumers);

    mbar_wait(kv_bar, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int stage = it % F::STAGES;
      mbar_wait(full(stage), (it / F::STAGES) & 1);
      const uint32_t qt = q_at(stage), dot = qt + F::QTILE;

      // S^T = K Q^T and dP^T = V dO^T, two independent chains
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < F::DP / 16; ++kd) {
        wgmma_ss<0>(s, make_desc(k_at(wg) + kslice<F>(kd, 64), F::SW),
                    make_desc(qt + kslice<F>(kd, F::BQ), F::SW), kd > 0);
        wgmma_ss<0>(dp, make_desc(v_at(wg) + kslice<F>(kd, 64), F::SW),
                    make_desc(dot + kslice<F>(kd, F::BQ), F::SW), kd > 0);
      }
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);

      // P^T = exp2(S^T c - LSE) and dS^T = P^T o (dP^T - Delta); query
      // columns >= T get P = 0 explicitly (a zero-filled LSE would give
      // exp2(0) = 1)
      const float* const lse_s = stats + stage * 2 * F::BQ;
      const float* const delta_s = lse_s + F::BQ;
      const int n_valid = t_len - it * F::BQ;
#pragma unroll
      for (int j = 0; j < F::BQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * tq + c;
          const float neg_lse = -lse_s[col] * kLog2e, dlt = delta_s[col];
          const bool ok = col < n_valid;
#pragma unroll
          for (int e = c; e < 4; e += 2) {
            const float pe = ok ? exp2_approx(fmaf(s[j][e], scale_log2, neg_lse)) : 0.f;
            s[j][e] = pe;
            dp[j][e] = pe * (dp[j][e] - dlt);
          }
        }
      }
#pragma unroll
      for (int kq = 0; kq < F::BQ / 16; ++kq) {
        p[kq] = split_a_trunc(s[2 * kq], s[2 * kq + 1]);
        ds[kq] = split_a_trunc(dp[2 * kq], dp[2 * kq + 1]);
      }

      // dV += (P^T_hi + P^T_lo) dO and dK += (dS^T_hi + dS^T_lo) Q,
      // interleaved so that neighbouring products are independent
      my_turn();
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < F::BQ / 16; ++kq) {
#pragma unroll
        for (int pn = 0; pn < F::PANELS; ++pn) {
          const uint32_t at = pn * F::BQ * F::SW + kq * 16 * F::SW;
          wgmma_split(dv_acc[pn], p[kq], make_desc(dot + at, F::SW));
          wgmma_split(dk_acc[pn], ds[kq], make_desc(qt + at, F::SW));
        }
      }
      wgmma_commit();
      your_turn();
      wgmma_wait<0>();
#pragma unroll
      for (int pn = 0; pn < F::PANELS; ++pn) {
        fence_acc(dk_acc[pn]);
        fence_acc(dv_acc[pn]);
      }
      if (lane == 0) mbar_arrive(empty(stage));  // this stage is free for the producer
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = key0 + 64 * wg + 16 * (warp % 4) + g + 8 * r;
      if (row >= t_len) continue;
      const size_t at = ((size_t)bh * t_len + row) * D + 2 * tq;
#pragma unroll
      for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
        for (int j = 0; j < F::NO; ++j) {
          if (D >= 16 || 8 * j < D) {  // D = 8: the zero-filled columns 8..15 stay unwritten
            const size_t c = at + pn * F::W + 8 * j;
            *reinterpret_cast<uint32_t*>(dk + c) =
                pack_bf16(dk_acc[pn][j][2 * r] * scale, dk_acc[pn][j][2 * r + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + c) =
                pack_bf16(dv_acc[pn][j][2 * r], dv_acc[pn][j][2 * r + 1]);
          }
        }
      }
    }
  }
}

// D = 128 and 256: one 64-key tile a block, its query tiles dealt over a
// cluster of `split` blocks (the file's note). Warpgroup 0 (threads 0-127):
// S^T, P^T and dV; warpgroup 1 (128-255): dP^T, dS^T and dK; the producer
// warpgroup (256-383): the loads.
template <int D>
__device__ __forceinline__ void dkv_ws(const CUtensorMap& q_map, const CUtensorMap& k_map,
                                       const CUtensorMap& v_map, const CUtensorMap& do_map,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       __nv_bfloat16* __restrict__ dk,
                                       __nv_bfloat16* __restrict__ dv, int t_len, float scale,
                                       float scale_log2, int split) {
  using namespace flash_mma;
  using namespace wgmma_sm90;
  using F = HopperDkvWs<D>;
  // named barriers: P^T buffer b full (1 + b) and free (3 + b), each
  // between the two consumer warpgroups; both consumers (5)
  constexpr int kPFull = 1, kPFree = 3, kConsumerBar = 5;
  char* const raw = dynamic_smem();
  const uint32_t base = (smem_u32(raw) + 1023) & ~1023u;
  char* const at0 = raw + (base - smem_u32(raw));
  const float* const stats = reinterpret_cast<const float*>(at0 + F::STATS);
  const uint32_t bars = base + F::BARS;
  const uint32_t kv_bar = bars + 16 * F::STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (F::STAGES + s); };
  auto q_at = [&](int s) { return base + F::RING + s * 2 * F::QTILE; };  // Q, then dO
  const uint32_t k_tile = base, v_tile = base + F::KTILE;

  const int bh = blockIdx.y;
  const int rank = blockIdx.x % split;  // the cluster rank where split > 1
  const int key0 = blockIdx.x / split * 64;
  const int n_tiles = (t_len + F::BQ - 1) / F::BQ;
  const int n_local = rank < n_tiles ? (n_tiles - rank + split - 1) / split : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA's bytes, then each producer lane's rows
      mbar_init(empty(s), F::CONSUMERS / 32);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: the block's K and V tiles once, then its query tiles'
    // Q and dO by TMA and their LSE and Delta rows by the first warp's
    // lanes (zeros past T) through the ring
    setmaxnreg_dec<F::PRODUCER_REGS>();
    if (warp == F::CONSUMERS / 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_bar, 2 * F::KTILE);
        for (int pn = 0; pn < F::PANELS; ++pn) {
          tma_load_3d(k_tile + pn * 64 * F::SW, &k_map, kv_bar, pn * F::W, key0, bh);
          tma_load_3d(v_tile + pn * 64 * F::SW, &v_map, kv_bar, pn * F::W, key0, bh);
        }
      }
      const size_t head = (size_t)bh * t_len;  // this head's first row
      float* const st_all = reinterpret_cast<float*>(at0 + F::STATS);
      for (int j = 0; j < n_local; ++j) {
        const int s = j % F::STAGES;
        const int q0 = (rank + j * split) * F::BQ;
        mbar_wait(empty(s), ((j / F::STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(full(s), 2 * F::QTILE);
          for (int pn = 0; pn < F::PANELS; ++pn) {
            tma_load_3d(q_at(s) + pn * F::BQ * F::SW, &q_map, full(s), pn * F::W, q0, bh);
            tma_load_3d(q_at(s) + F::QTILE + pn * F::BQ * F::SW, &do_map, full(s), pn * F::W,
                        q0, bh);
          }
        }
        float* const st = st_all + s * 2 * F::BQ;
        for (int i = lane; i < F::BQ; i += 32) {
          const bool ok = q0 + i < t_len;
          st[i] = ok ? lse[head + q0 + i] : 0.f;
          st[F::BQ + i] = ok ? delta[head + q0 + i] : 0.f;
        }
        mbar_arrive(full(s));
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
  const int ct = threadIdx.x % 128;  // the thread in its warpgroup
  float acc[F::PANELS][F::NO][4];    // dV (warpgroup 0) or dK (1) of the 64 keys
#pragma unroll
  for (int pn = 0; pn < F::PANELS; ++pn) {
#pragma unroll
    for (int j = 0; j < F::NO; ++j) acc[pn][j][0] = acc[pn][j][1] = acc[pn][j][2] = acc[pn][j][3] = 0.f;
  }
  float x[F::BQ / 8][4];  // S^T, then P^T (warpgroup 0); dP^T, then dS^T (1)
  Split a[F::BQ / 16];    // P^T or dS^T as the A operand, hi and lo

  mbar_wait(kv_bar, 0);
  for (int it = 0; it < n_local; ++it) {
    const int stage = it % F::STAGES, pb = it & 1;
    mbar_wait(full(stage), (it / F::STAGES) & 1);
    const uint32_t qt = q_at(stage), dot = qt + F::QTILE;
    const float* const lse_s = stats + stage * 2 * F::BQ;
    float4* const pbuf = reinterpret_cast<float4*>(at0 + F::PBUF + pb * F::PTILE);
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1)
    const uint32_t a_tile = wg == 0 ? k_tile : v_tile, bt_tile = wg == 0 ? qt : dot;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < F::DP / 16; ++kd)
      wgmma_ss<0>(x, make_desc(a_tile + kslice<F>(kd, 64), F::SW),
                  make_desc(bt_tile + kslice<F>(kd, F::BQ), F::SW), kd > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(x);
    if (wg == 0) {
      // P^T = exp2(S^T c - LSE); query columns >= T get P = 0 explicitly
      // (a zero-filled LSE would give exp2(0) = 1)
      const int n_valid = t_len - (rank + it * split) * F::BQ;
#pragma unroll
      for (int j = 0; j < F::BQ / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * tq + c;
          const float neg_lse = -lse_s[col] * kLog2e;
          const bool ok = col < n_valid;
#pragma unroll
          for (int e = c; e < 4; e += 2)
            x[j][e] = ok ? exp2_approx(fmaf(x[j][e], scale_log2, neg_lse)) : 0.f;
        }
      }
      // to warpgroup 1, each thread's fragment at its own place
      if (it >= 2) named_sync(kPFree + pb, F::CONSUMERS);
#pragma unroll
      for (int j = 0; j < F::BQ / 8; ++j)
        pbuf[j * 128 + ct] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
      named_arrive(kPFull + pb, F::CONSUMERS);
    } else {
      // dS^T = P^T o (dP^T - Delta), P^T from warpgroup 0
      const float* const delta_s = lse_s + F::BQ;
      named_sync(kPFull + pb, F::CONSUMERS);
#pragma unroll
      for (int j = 0; j < F::BQ / 8; ++j) {
        const float4 pt = pbuf[j * 128 + ct];
        const float d0 = delta_s[8 * j + 2 * tq], d1 = delta_s[8 * j + 2 * tq + 1];
        x[j][0] = pt.x * (x[j][0] - d0);
        x[j][1] = pt.y * (x[j][1] - d1);
        x[j][2] = pt.z * (x[j][2] - d0);
        x[j][3] = pt.w * (x[j][3] - d1);
      }
      if (it + 2 < n_local) named_arrive(kPFree + pb, F::CONSUMERS);
    }
#pragma unroll
    for (int kq = 0; kq < F::BQ / 16; ++kq) a[kq] = split_a_trunc(x[2 * kq], x[2 * kq + 1]);
    // dV += (P^T_hi + P^T_lo) dO (warpgroup 0) or dK += (dS^T_hi + dS^T_lo) Q (1)
    const uint32_t b_tile = wg == 0 ? dot : qt;
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < F::BQ / 16; ++kq) {
#pragma unroll
      for (int pn = 0; pn < F::PANELS; ++pn)
        wgmma_split(acc[pn], a[kq],
                    make_desc(b_tile + pn * F::BQ * F::SW + kq * 16 * F::SW, F::SW));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) fence_acc(acc[pn]);
    if (lane == 0) mbar_arrive(empty(stage));  // this stage is free for the producer
  }

  const float out_scale = wg == 0 ? 1.f : scale;
  __nv_bfloat16* const out = wg == 0 ? dv : dk;
  if (split > 1) {
    // the other block's half of this warpgroup's sums: leave it in the
    // ring's space (free once both warpgroups are here), read the other
    // block's share of this block's half, add
    named_sync(kConsumerBar, F::CONSUMERS);
    float4* const red = reinterpret_cast<float4*>(at0 + F::RING);
    const int other = rank ^ 1;
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) {
      if (pn / F::HALF != other) continue;
#pragma unroll
      for (int j = 0; j < F::NO; ++j)
        red[((wg * F::HALF + pn % F::HALF) * F::NO + j) * 128 + ct] =
            make_float4(acc[pn][j][0], acc[pn][j][1], acc[pn][j][2], acc[pn][j][3]);
    }
    cluster_sync();
    const uint32_t red_at = smem_u32(red);
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) {
      if (pn / F::HALF != rank) continue;
#pragma unroll
      for (int j = 0; j < F::NO; ++j) {
        const float4 y = ld_cluster_v4(map_to_rank(
            red_at + 16 * (((wg * F::HALF + pn % F::HALF) * F::NO + j) * 128 + ct), other));
        acc[pn][j][0] += y.x;
        acc[pn][j][1] += y.y;
        acc[pn][j][2] += y.z;
        acc[pn][j][3] += y.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = key0 + 16 * (warp % 4) + g + 8 * r;
    if (row >= t_len) continue;
    const size_t at = ((size_t)bh * t_len + row) * D + 2 * tq;
#pragma unroll
    for (int pn = 0; pn < F::PANELS; ++pn) {
      if (split > 1 && pn / F::HALF != rank) continue;
#pragma unroll
      for (int j = 0; j < F::NO; ++j)
        *reinterpret_cast<uint32_t*>(out + at + pn * F::W + 8 * j) =
            pack_bf16(acc[pn][j][2 * r] * out_scale, acc[pn][j][2 * r + 1] * out_scale);
    }
  }
  if (split > 1) cluster_sync();  // no block leaves while the other reads its shared memory
}

template <int D>
__global__ void __launch_bounds__(DkvLaunch<D>::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int t_len, float scale, float scale_log2, int split) {
  if constexpr (DkvLaunch<D>::WS)
    dkv_ws<D>(q_map, k_map, v_map, do_map, lse, delta, dk, dv, t_len, scale, scale_log2, split);
  else
    dkv_pair<D>(q_map, k_map, v_map, do_map, lse, delta, dk, dv, t_len, scale, scale_log2);
}

// The split of a grid's inner tiles over a cluster of 2 (the bf16 dQ's key
// tiles at D >= 128, dK/dV's query tiles in bf16 at D >= 128 and in f32 at
// D <= 128): 2 while the grid of `blocks` tiles times 2 stays within the
// SMs and there are 2 inner tiles to deal; else 1. (f32 dK/dV: also taking
// 2 where the grid's last round of the SMs would be less than half full,
// (72, 1024, 32|16), ran 1-3% slower: kernel_ab.py.)
int pair_fill_split(int blocks, int inner_tiles, int sms) {
  return blocks * 2 <= sms && inner_tiles >= 2 ? 2 : 1;
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const void* lse, void* dq, void* delta, int bh,
                           int t, float scale, int split, cudaStream_t stream) {
  namespace host = wgmma_sm90_host;
  using L = DqLaunch<D>;
  using F = std::conditional_t<L::WS, HopperDqWs<(L::WS ? D : 128)>, HopperDq<(L::WS ? 64 : D)>>;
  CUtensorMap maps[4];
  const void* tiles[4] = {q, k, v, dout};
  cudaError_t err = cudaSuccess;
  // Q's and dO's boxes are a warpgroup's rows, K's and V's a stage's
  const int rows[4] = {64, F::BN, F::BN, 64};
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = host::tile_map(&maps[i], tiles[i], bh, t, D, F::W, rows[i], F::SW);
  // a block's queries: one 64-row tile (D >= 128) or two warpgroups' (D <= 64)
  const int row_tiles = (t + (L::WS ? 63 : kBlockRows - 1)) / (L::WS ? 64 : kBlockRows);
  if constexpr (L::WS) {
    if (split == 0) split = pair_fill_split(bh * row_tiles, (t + F::BN - 1) / F::BN, host::sm_count());
    if (split != 1 && split != 2) return cudaErrorInvalidValue;
    static uint64_t covered = 0;
    if (err == cudaSuccess)
      err = host::registers_cover(flash_bwd_dq_wgmma_kernel<D>, F::THREADS,
                                  F::THREADS - F::CONSUMERS, F::PRODUCER_REGS, F::CONSUMER_REGS,
                                  covered);
  } else {
    split = 1;  // the D <= 64 design has no split
  }
  static uint64_t allowed = 0;
  if (err == cudaSuccess) err = host::allow_smem(flash_bwd_dq_wgmma_kernel<D>, F::SMEM, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * split, bh);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = F::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dq_wgmma_kernel<D>, maps[0], maps[1], maps[2], maps[3],
                           static_cast<const __nv_bfloat16*>(o),
                           static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
                           static_cast<__nv_bfloat16*>(dq), static_cast<float*>(delta), t, scale,
                           scale * kLog2e, split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, const void* lse, void* dq, void* delta, int bh,
                          int t, float scale, int split, cudaStream_t stream) {
  namespace host = wgmma_sm90_host;
  using F = F32Dq<D>;
  CUtensorMap maps[4];
  const void* tiles[4] = {q, k, v, dout};
  const int rows[4] = {64, F::BN, F::BN, 64};  // Q's and dO's box a consumer's rows
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = host::tile_map(&maps[i], tiles[i], bh, t, D, F::W, rows[i], F::SW, 4);
  const int row_tiles = (t + F::ROWS - 1) / F::ROWS;
  if (F::DS == 2) {
    split = 1;  // the cluster splits the head dim, not the keys
  } else {
    if (split == 0)
      split = host::fill_split(bh * row_tiles, (t + F::BN - 1) / F::BN, host::sm_count(),
                               F::RULE_SPLIT);
    if (split != 1 && split != 2 && split != 4) return cudaErrorInvalidValue;
  }
  const int cluster_blocks = F::DS == 2 ? 2 : split;
  static uint64_t allowed = 0;
  if (err == cudaSuccess) err = host::allow_smem(flash_bwd_dq_kernel<D>, F::SMEM, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cluster_blocks;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * cluster_blocks, bh);
  cfg.blockDim = dim3(F::THREADS);
  cfg.dynamicSmemBytes = F::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = cluster_blocks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dq_kernel<D>, maps[0], maps[1], maps[2], maps[3],
                           static_cast<const float*>(q), static_cast<const float*>(o),
                           static_cast<const float*>(dout),
                           static_cast<const float*>(lse), static_cast<float*>(dq),
                           static_cast<float*>(delta), t, scale, scale * kLog2e, split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const void* lse, void* dq, void* delta, int bh,
                      int t, int dtype, float scale, int split, cudaStream_t stream) {
  if (dtype == 1)
    return launch_dq_bf16<D>(q, k, v, o, dout, lse, dq, delta, bh, t, scale, split, stream);
  if constexpr (D >= 16) {  // the f32 kernel is built from D = 16 up
    if (dtype == 0)
      return launch_dq_f32<D>(q, k, v, o, dout, lse, dq, delta, bh, t, scale, split, stream);
  }
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh,
                            int t, float scale, int split, cudaStream_t stream) {
  namespace host = wgmma_sm90_host;
  using L = DkvLaunch<D>;
  using F = std::conditional_t<L::WS, HopperDkvWs<(L::WS ? D : 128)>, HopperDkv<(L::WS ? 64 : D)>>;
  CUtensorMap maps[4];
  const void* tiles[4] = {q, k, v, dout};
  const int rows[4] = {F::BQ, 64, 64, F::BQ};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = host::tile_map(&maps[i], tiles[i], bh, t, D, F::W, rows[i], F::SW);
  // a block's keys: one 64-key tile (D >= 128) or two warpgroups' (D <= 64)
  const int key_tiles = (t + (L::WS ? 63 : kBlockRows - 1)) / (L::WS ? 64 : kBlockRows);
  if constexpr (L::WS) {
    if (split == 0) split = pair_fill_split(bh * key_tiles, (t + F::BQ - 1) / F::BQ, host::sm_count());
    if (split != 1 && split != 2) return cudaErrorInvalidValue;
    static uint64_t covered = 0;
    if (err == cudaSuccess)
      err = host::registers_cover(flash_bwd_dkv_wgmma_kernel<D>, F::THREADS,
                                  F::THREADS - F::CONSUMERS, F::PRODUCER_REGS, F::CONSUMER_REGS,
                                  covered);
  } else {
    split = 1;  // the D <= 64 design has no split
  }
  static uint64_t allowed = 0;
  if (err == cudaSuccess) err = host::allow_smem(flash_bwd_dkv_wgmma_kernel<D>, F::SMEM, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(key_tiles * split, bh);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = F::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_wgmma_kernel<D>, maps[0], maps[1], maps[2],
                           maps[3], static_cast<const float*>(lse),
                           static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
                           static_cast<__nv_bfloat16*>(dv), t, scale, scale * kLog2e, split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dk, void* dv, int bh,
                           int t, float scale, int split, cudaStream_t stream) {
  namespace host = wgmma_sm90_host;
  using F = F32Dkv<D>;
  CUtensorMap maps[4];
  const void* tiles[4] = {q, k, v, dout};
  const int rows[4] = {F::BN, F::KEYS, F::KEYS, F::BN};  // Q's and dO's box a stage, K's and V's a block's keys
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i)
    err = host::tile_map(&maps[i], tiles[i], bh, t, D, F::W, rows[i], F::SW, 4);
  const int key_tiles = (t + F::KEYS - 1) / F::KEYS;
  if (F::DS == 2) {
    split = 1;  // the cluster splits the head dim, not the query tiles
  } else {
    if (split == 0) split = pair_fill_split(bh * key_tiles, (t + F::BN - 1) / F::BN, host::sm_count());
    if (split != 1 && split != 2) return cudaErrorInvalidValue;
  }
  const int cluster_blocks = F::DS == 2 ? 2 : split;
  static uint64_t covered = 0, allowed = 0;
  if (err == cudaSuccess)
    err = host::registers_cover(flash_bwd_dkv_kernel<D>, F::THREADS, F::THREADS - F::CONSUMERS,
                                F::PRODUCER_REGS, F::CONSUMER_REGS, covered);
  if (err == cudaSuccess) err = host::allow_smem(flash_bwd_dkv_kernel<D>, F::SMEM, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cluster_blocks;
  cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(key_tiles * cluster_blocks, bh);
  cfg.blockDim = dim3(F::THREADS);
  cfg.dynamicSmemBytes = F::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = cluster_blocks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_bwd_dkv_kernel<D>, maps[0], maps[1], maps[2], maps[3],
                           static_cast<const float*>(k), static_cast<const float*>(v),
                           static_cast<const float*>(lse), static_cast<const float*>(delta),
                           static_cast<float*>(dk), static_cast<float*>(dv), t, scale,
                           scale * kLog2e, split);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int t, int dtype, float scale, int split, cudaStream_t stream) {
  if (dtype == 1)
    return launch_dkv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, split, stream);
  if constexpr (D >= 16) {  // the f32 kernel is built from D = 16 up
    if (dtype == 0)
      return launch_dkv_f32<D>(q, k, v, dout, lse, delta, dk, dv, bh, t, scale, split, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dq_dispatch(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dq, void* delta, int bh,
                        int t, int d, int dtype, float scale, int split, cudaStream_t s) {
  switch (d) {
    case 8: return launch_dq<8>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, split, s);
    case 16: return launch_dq<16>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, split, s);
    case 32: return launch_dq<32>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, split, s);
    case 64: return launch_dq<64>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, split, s);
    case 128:
      return launch_dq<128>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, split, s);
    case 256:
      return launch_dq<256>(q, k, v, o, dout, lse, dq, delta, bh, t, dtype, scale, split, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dkv_dispatch(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int bh,
                         int t, int d, int dtype, float scale, int split, cudaStream_t s) {
  switch (d) {
    case 8: return launch_dkv<8>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, split, s);
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, split, s);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, split, s);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, split, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, split, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, bh, t, dtype, scale, split, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As flash_attention_bwd_dq, with the split over keys forced: split 0
// takes the launcher's rule, else that many blocks a cluster: 1, 2 or 4 in
// f32 at D <= 128, 1 or 2 in bf16 at D >= 128 (the bf16 kernel at D <= 64
// ignores it, and the f32 one at D = 256, whose cluster splits the head
// dim).
extern "C" int flash_attention_bwd_dq_split(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const void* lse,
                                            void* dq, void* delta, int bh, int t, int d,
                                            int dtype, float sm_scale, int split, void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = wgmma_sm90_host::bind_device();
  if (bound != cudaSuccess) return (int)bound;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dq_dispatch(q, k, v, o, dout, lse, dq, delta, bh, t, d, dtype, sm_scale, split, s);
}

// dQ and Delta = rowsum(dO o O) from q, k, v, o, dO ([BH, T, d], dtype 0 =
// float32 (TF32 wgmma kernel, d >= 16), 1 = bfloat16
// (wgmma kernel, d = 8 too); the [BH, T, d] tensors must be 16-byte
// aligned) and the forward's [BH, T] f32 LSE. dq has q's dtype; delta is
// [BH, T] f32. Returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for an unsupported d, dtype or size).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                      const void* o, const void* dout, const void* lse,
                                      void* dq, void* delta, int bh, int t, int d, int dtype,
                                      float sm_scale, void* stream) {
  return flash_attention_bwd_dq_split(q, k, v, o, dout, lse, dq, delta, bh, t, d, dtype,
                                      sm_scale, 0, stream);
}

// As flash_attention_bwd_dkv, with the split over query tiles forced:
// split 0 takes the launcher's rule, 1 or 2 that many blocks a cluster (the
// bf16 kernel at D >= 128 and the f32 one at D <= 128; the bf16 kernel at
// D <= 64 ignores it, and the f32 one at D = 256, whose cluster splits the
// head dim).
extern "C" int flash_attention_bwd_dkv_split(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dk, void* dv, int bh,
                                             int t, int d, int dtype, float sm_scale, int split,
                                             void* stream) {
  if (bh <= 0 || bh > 65535 || t <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = wgmma_sm90_host::bind_device();
  if (bound != cudaSuccess) return (int)bound;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)dkv_dispatch(q, k, v, dout, lse, delta, dk, dv, bh, t, d, dtype, sm_scale, split,
                           s);
}

// dK and dV from q, k, v, dO, the LSE and the Delta that
// flash_attention_bwd_dq wrote (launch this after it on the same stream).
// dtype 0 = float32 (TF32 wgmma kernel, d >= 16), 1 = bfloat16 (wgmma
// kernel, d = 8 too); the [BH, T, d] tensors must be 16-byte aligned.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t, int d, int dtype,
                                       float sm_scale, void* stream) {
  return flash_attention_bwd_dkv_split(q, k, v, dout, lse, delta, dk, dv, bh, t, d, dtype,
                                       sm_scale, 0, stream);
}
