// Hopper's own instructions for the flash-attention kernels (the bf16 and
// f32 forward, dQ and dK/dV; sm_90a), as inline PTX:
//   * wgmma.mma_async m64nNk16 (N = 16, 32, 64; bf16 in, f32 accumulate),
//     A from a shared-memory descriptor or from registers, B from a
//     descriptor, K-major or MN-major; fence, commit and wait;
//   * wgmma.mma_async m64nNk8 in TF32 (N = 16, 32, 64; f32 accumulate), A
//     from a descriptor or from registers, B from a descriptor, both
//     K-major only (TF32 has no transpose bits), and cvt.rna.tf32.f32 for
//     the 3xTF32 split of an f32 operand (split_tf32); fence.proxy.async
//     after shared-memory writes that wgmma then reads;
//   * the 64-bit shared-memory matrix descriptor of a swizzled tile;
//   * mbarrier init, arrive, arrive.expect_tx and try_wait.parity;
//   * the TMA tile load (cp.async.bulk.tensor.3d) completing on
//     an mbarrier, and the host side: a tensor map encoded with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//     -lcuda, no PyTorch headers);
//   * named barriers (bar.sync, bar.arrive), with which two consumer
//     warpgroups take turns at issuing their products or hand each other
//     operands through shared memory;
//   * the cluster barrier and distributed shared memory (mapa,
//     ld.shared::cluster, scalar and v4, st.shared::cluster v4, and mbarrier
//     arrivals and waits at cluster scope), for the forward's and the bf16
//     dQ's split over keys, dK/dV's over queries and the f32 dQ's and
//     dK/dV's over the head dim;
//   * setmaxnreg.inc / .dec, with which the warp-specialised kernels (the
//     bf16 forward, dQ and dK/dV at D = 128 and 256, the f32 dK/dV at every D)
//     move registers from their producer warpgroup to their consumer
//     warpgroups; the launchers check that the kernel's register count at
//     launch covers the move (wgmma_sm90_host::registers_cover);
//   * ex2.approx.ftz.f32.
// The other kernels use no setmaxnreg.
//
// Tiles. A [rows, DP] bf16 tile (DP = the head dim, at least 16, the
// wgmma depth) lies in shared memory as PANELS = DP*2/SW panels [rows, SW/2]
// of SW = min(128, 2*DP) bytes a row, each 1024-byte aligned, in the SW-byte
// swizzle (SW = 32, 64, 128): the 16-byte chunk c of the row at byte
// address a goes to chunk c ^ ((a >> 7) & (SW/16 - 1)). TMA writes that
// layout (CU_TENSOR_MAP_SWIZZLE_<SW>B, a box {SW/2, rows, 1}) and wgmma
// reads it through a descriptor of the same swizzle mode:
//   * K-major (the reduction dim along the row: Q and K in Q*K^T): the k16
//     slice k of a panel starts at the panel + 32*k bytes; rows are SW
//     apart and groups of 8 rows SBO = 8*SW apart;
//   * MN-major (the output columns along the row: V in P*V): the k16 slice
//     (16 rows) starts at the panel + 16*SW*k bytes, groups of 8 rows SBO
//     = 8*SW apart, and N = SW/2 columns (one panel) per instruction.
// LBO, the stride between panels in one instruction, is never used: each
// wgmma reads one panel (N <= SW/2, and a k16 slice lies in one row).
//
// TF32 tiles are the same in bytes: a [rows, D] f32 tile lies as panels
// [rows, SW/4] of SW = min(128, 4*D) bytes a row, and the k8 slice k of a
// K-major panel starts at the panel + 32*k bytes (8 f32). Since TF32 wgmma
// reads both operands K-major, the f32 kernels keep V (forward) and K
// (dQ) also as a transposed tile [D, keys] with the keys along the row, and
// Q and dO (dK/dV) as [D, queries].
//
// Fragments (g = lane / 4, t = lane % 4). The m64nNk16 accumulator of a
// warpgroup gives warp w rows 16w..16w+15 and lane l the pairs (row 16w + g
// (+8), columns 8j + 2t, +1) as d[j][0..1] (d[j][2..3] for row +8): the
// C layout of mma.m16n8k16, n8 block j after block j. The register A
// operand of a k16 step is mma.m16n8k16's A fragment on each warp's 16
// rows, each .b32 two bf16, the lower column in the low half: a0 (g, 2t..),
// a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..). So two n8 accumulator
// blocks repack into it in registers (flash_mma.cuh split_a_trunc).
//
// The CPU emulation (tests/cuda_emu/wgmma_sm90.cuh) defines the same names.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_sm90 {

// ---- shared memory --------------------------------------------------------

// The block's dynamic shared memory.
__device__ __forceinline__ char* dynamic_smem() {
  extern __shared__ __align__(1024) char smem_dynamic[];
  return smem_dynamic;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` more of transactions (a TMA load).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// An arrival, releasing this thread's earlier writes at cluster scope, on
// the mbarrier at `addr` in a block of the cluster (a map_to_rank address).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// As mbar_wait, acquiring at cluster scope what the arrivals released (the
// other blocks' writes before their mbar_arrive_cluster).
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- TMA ------------------------------------------------------------------

// Box (c0, c1, c2) of the 3-D tensor map into shared memory at dst,
// completing `bar`'s transactions by the box's bytes (zeros out of bounds).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a swizzled tile at shared address `addr` with rows of `sw`
// bytes (32, 64 or 128); SBO = 8 rows, LBO unused (1), base offset 0.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int sw) {
  const uint64_t mode = sw == 128 ? 1 : (sw == 64 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * sw) >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator registers in place around the asynchronous products, so
// that the compiler neither reads them before a wait nor writes them while
// a product is in flight.
template <int NB> __device__ __forceinline__ void fence_acc(float (&d)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

#define WG_D4(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
#define WG_D8(i) WG_D4(i), WG_D4(i + 1)
#define WG_D16(i) WG_D8(i), WG_D8(i + 2)
#define WG_D32(i) WG_D16(i), WG_D16(i + 4)
#define WG_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WG_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_R32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_OP(N) "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 "
#define WG_PRED(S) "{\n.reg .pred wg_acc;\nsetp.ne.b32 wg_acc, %" #S ", 0;\n"

// d (64 x N f32, N = 8 * NB) (+)= A * B, A (64 x 16) from a K-major
// descriptor, B (16 x N) from a descriptor, K-major (TRANS_B = 0) or
// MN-major (1); accumulate = false overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[2][4], uint64_t a, uint64_t b, bool accumulate) {
  asm volatile(WG_PRED(10) WG_OP(16) WG_R8 ", %8, %9, wg_acc, 1, 1, 0, %11;\n}\n"
               : WG_D8(0)
               : "l"(a), "l"(b), "r"((int)accumulate), "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t a, uint64_t b, bool accumulate) {
  asm volatile(WG_PRED(18) WG_OP(32) WG_R16 ", %16, %17, wg_acc, 1, 1, 0, %19;\n}\n"
               : WG_D16(0)
               : "l"(a), "l"(b), "r"((int)accumulate), "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a, uint64_t b, bool accumulate) {
  asm volatile(WG_PRED(34) WG_OP(64) WG_R32 ", %32, %33, wg_acc, 1, 1, 0, %35;\n}\n"
               : WG_D32(0)
               : "l"(a), "l"(b), "r"((int)accumulate), "n"(TRANS_B));
}

// The same with A from registers: each thread's a[4] is its part of the
// 64 x 16 operand in mma.m16n8k16's A layout on its warp's 16 rows.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[2][4], const uint32_t (&a)[4], uint64_t b,
                                         bool accumulate) {
  asm volatile(WG_PRED(13) WG_OP(16) WG_R8 ", {%8, %9, %10, %11}, %12, wg_acc, 1, 1, %14;\n}\n"
               : WG_D8(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate),
                 "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t b,
                                         bool accumulate) {
  asm volatile(WG_PRED(21) WG_OP(32) WG_R16 ", {%16, %17, %18, %19}, %20, wg_acc, 1, 1, %22;\n}\n"
               : WG_D16(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate),
                 "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                         bool accumulate) {
  asm volatile(WG_PRED(37) WG_OP(64) WG_R32 ", {%32, %33, %34, %35}, %36, wg_acc, 1, 1, %38;\n}\n"
               : WG_D32(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate),
                 "n"(TRANS_B));
}

// TF32 (the f32 kernels): m64nNk8, f32 accumulate, both operands K-major
// (tf32 has no transpose bits). An f32 operand goes in as a hi/lo pair of
// TF32 values (cvt_tf32), each product as three (hi*hi + hi*lo + lo*hi).
#define WG_OP32(N) "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 "

// d (64 x N f32, N = 8 * NB) (+)= A * B, A (64 x 8) and B (8 x N) from
// K-major descriptors of 4-byte TF32 elements.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[2][4], uint64_t a, uint64_t b,
                                              bool accumulate) {
  asm volatile(WG_PRED(10) WG_OP32(16) WG_R8 ", %8, %9, wg_acc, 1, 1;\n}\n"
               : WG_D8(0)
               : "l"(a), "l"(b), "r"((int)accumulate));
}
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4][4], uint64_t a, uint64_t b,
                                              bool accumulate) {
  asm volatile(WG_PRED(18) WG_OP32(32) WG_R16 ", %16, %17, wg_acc, 1, 1;\n}\n"
               : WG_D16(0)
               : "l"(a), "l"(b), "r"((int)accumulate));
}
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8][4], uint64_t a, uint64_t b,
                                              bool accumulate) {
  asm volatile(WG_PRED(34) WG_OP32(64) WG_R32 ", %32, %33, wg_acc, 1, 1;\n}\n"
               : WG_D32(0)
               : "l"(a), "l"(b), "r"((int)accumulate));
}

// The same with A from registers: each thread's a[4] is its part of the
// 64 x 8 operand in mma.m16n8k8.tf32's A layout on its warp's 16 rows,
// one TF32 value a register: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8,
// t+4).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[2][4], const uint32_t (&a)[4],
                                              uint64_t b, bool accumulate) {
  asm volatile(WG_PRED(13) WG_OP32(16) WG_R8 ", {%8, %9, %10, %11}, %12, wg_acc, 1, 1;\n}\n"
               : WG_D8(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t b, bool accumulate) {
  asm volatile(WG_PRED(21) WG_OP32(32) WG_R16 ", {%16, %17, %18, %19}, %20, wg_acc, 1, 1;\n}\n"
               : WG_D16(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t b, bool accumulate) {
  asm volatile(WG_PRED(37) WG_OP32(64) WG_R32 ", {%32, %33, %34, %35}, %36, wg_acc, 1, 1;\n}\n"
               : WG_D32(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"((int)accumulate));
}

#undef WG_D4
#undef WG_D8
#undef WG_D16
#undef WG_D32
#undef WG_R8
#undef WG_R16
#undef WG_R32
#undef WG_OP
#undef WG_OP32
#undef WG_PRED

// Orders this thread's generic-proxy writes to shared memory before later
// reads of it by the async proxy (wgmma operands, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- named barriers ---------------------------------------------------------

// Barrier `id` (1 to 15; 0 is __syncthreads') of `count` threads, counting
// whole warps: wait at it, or arrive at it and go on.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- cluster and distributed shared memory ---------------------------------

// Every thread of every block of the cluster; orders shared-memory writes
// before it with reads after it, across the cluster's blocks.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// The address of the same shared-memory location in block `rank` of the
// cluster, and a load from it.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
// Four f32 at a 16-byte aligned address of the cluster's shared memory.
__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Four f32 to a 16-byte aligned address of the cluster's shared memory.
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// ---- register reallocation ---------------------------------------------------

// The warpgroup's registers a thread, raised to (inc) or lowered to (dec) N:
// every thread of the warpgroup executes it with the same N (a multiple of
// 8 in 24..256). An inc waits until the block has the registers free.
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  static_assert(N % 8 == 0 && N >= 24 && N <= 256, "setmaxnreg count");
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  static_assert(N % 8 == 0 && N >= 24 && N <= 256, "setmaxnreg count");
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- arithmetic -----------------------------------------------------------

// 2^x on the MUFU, subnormal results flushed to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// as the f32 bit pattern with its low 13 bits zero.
__device__ __forceinline__ uint32_t cvt_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// The 3xTF32 split of an f32 value: hi = tf32(x), lo = tf32(x - hi); hi +
// lo keeps x to ~2^-22 of itself, where hi alone keeps 2^-11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = cvt_tf32(x);
  lo = cvt_tf32(x - __uint_as_float(hi));
}

}  // namespace wgmma_sm90

// ---- host: tensor maps and launches ----------------------------------------

namespace wgmma_sm90_host {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime loaded (null if none).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                        : nullptr;
  }();
  return fn;
}

// A map of the [bh, t, d] tensor at `base` (row-major; bf16, or f32 where
// `elem` is 4) with boxes of {cols, rows, 1} in the `sw`-byte swizzle (cols
// * elem == sw); out-of-bounds elements (rows >= t, columns >= d) load as
// zeros.
inline cudaError_t tile_map(CUtensorMap* map, const void* base, int bh, int t, int d, int cols,
                            int rows, int sw, int elem = 2) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem, (cuuint64_t)t * d * elem};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType type =
      elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = enc(map, type, 3, const_cast<void*>(base), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Makes the current device's primary context current in the calling host
// thread, through this library's own (static) CUDA runtime. A launch from a
// thread where no CUDA call had made it current yet (autograd's worker
// thread, when the flash backward is its first CUDA work) was refused on the
// card with cudaErrorInvalidValue, at every head dim.
inline cudaError_t bind_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

// The current device's SM count (cached per device).
inline int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 132;
  }
  return counts[dev];
}

// Whether a warp-specialised kernel's registers at launch (ptxas's count a
// thread, times `threads`) cover its warpgroups' counts after setmaxnreg:
// `producers` threads at `producer_regs` and the rest at `consumer_regs`.
// Where they do not, a consumer's setmaxnreg.inc would wait for registers
// that no warpgroup gives back, and the kernel would hang; the launcher
// refuses it instead. Checked once per device.
template <class Kernel>
inline cudaError_t registers_cover(Kernel kernel, int threads, int producers, int producer_regs,
                                   int consumer_regs, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = (uint64_t)1 << (dev & 63);
  if (done & bit) return cudaSuccess;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const long have = (long)attr.numRegs * threads;
  const long need = (long)producer_regs * producers + (long)consumer_regs * (threads - producers);
  if (need > have) return cudaErrorInvalidValue;
  done |= bit;
  return cudaSuccess;
}

// The split over keys that fills the card: 4, else 2 (at most
// `max_split`), while the grid of `blocks` row tiles times the split stays
// within one block an SM and every block of a cluster has a key tile; else
// 1. (kernel_ab.py --splits: at T = 1024 and D = 32 the bf16 forward at BH
// = 4 ran fastest split 4 ways, 8 split 2, 16 unsplit, where a rule of two
// blocks an SM would have split it.) The bf16 and f32 forwards' and the f32
// dQ's rule.
inline int fill_split(int blocks, int key_tiles, int sms, int max_split) {
  int split = 1;
  while (split < max_split && blocks * split * 2 <= sms && split * 2 <= key_tiles) split *= 2;
  return split;
}

// Raises a kernel's dynamic shared-memory limit to `bytes` once per device.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = (uint64_t)1 << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace wgmma_sm90_host
