// The instructions of csrc/wgmma_sm90.cuh (same names and signatures),
// emulated on the CPU by emu.h's blocks, by the PTX ISA's definitions:
//   * wgmma: each thread of the warpgroup keeps the products it issued and
//     runs them, oldest group first, at the wgmma_wait that needs them done,
//     as one warpgroup-collective step each: the descriptors are decoded
//     then (start address, SBO, LBO, swizzle mode; shared memory read at
//     that moment), a register A is taken from the 128 threads' registers
//     in mma.m16n8k16's A layout on each warp's 16 rows, and each thread's
//     accumulator is written. So a result read before its wait, a register
//     A or a ring stage changed before it, shows as a wrong result;
//   * mbarrier: arrival count, transaction count and phase, waits blocking
//     (a wait that never ends aborts after 60 s);
//   * TMA: the tensor map as cuTensorMapEncodeTiled's checks leave it; a
//     load copies its box at once (zeros out of bounds), in the map's
//     swizzle, and completes its bytes on the barrier;
//   * named barriers: arrivals counted per block and id (bar.arrive goes
//     on, bar.sync waits for the phase), reset for each block;
//   * the cluster: barrier, mapa, ld.shared::cluster (scalar and v4,
//     aligned), st.shared::cluster v4 and mbarrier arrivals from another
//     block on the cluster's windows (emu.h); ex2.approx.ftz as exp2f;
//   * TF32 wgmma (m64nNk8, the f32 kernels): 4-byte elements read
//     K-major only (a transposed TF32 operand is refused), each value's
//     low 13 mantissa bits ignored, the products summed in f32; cvt.rna.
//     tf32.f32 rounds to nearest, ties away from zero;
//   * setmaxnreg: a no-op that checks its count (a multiple of 8 in
//     24..256), that every thread of the warpgroup gives the same one, and,
//     once the block has run, that the warpgroups' counts fit in the SM's
//     registers (emu.h emu_check_registers).
// The swizzle of an address a with rows of SW bytes: its 16-byte chunk
// bits [4, 4 + log2(SW/16)) are XORed with the bits from 7 up.
//
// One limit of this check: the kernels and this emulation rest on one
// reading of the PTX ISA's descriptor, swizzle and fragment layouts. Where
// that reading is wrong, a kernel written to it passes here all the same;
// the card's bounds (chip_smoke.py, tests/test_torch_kernels_cuda.py) are
// the judge.
#pragma once

#include <chrono>
#include <condition_variable>
#include <deque>
#include <mutex>

#include "cuda.h"
#include "emu.h"

namespace wgmma_sm90 {

inline char* dynamic_smem() { return emu_dynamic_smem(); }
inline uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// ---- mbarrier -------------------------------------------------------------

struct EmuMbar {
  int expected = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;  // completed phases
};
inline std::mutex g_mbar_mutex;
inline std::condition_variable g_mbar_cv;
inline std::map<uint32_t, EmuMbar> g_mbars;

inline EmuMbar& emu_mbar(uint32_t bar) {
  const auto it = g_mbars.find(bar);
  if (it == g_mbars.end()) emu_fail("mbarrier used before mbarrier.init");
  return it->second;
}
inline void emu_mbar_update(uint32_t bar, int arrivals, long long tx) {
  std::lock_guard<std::mutex> lock(g_mbar_mutex);
  EmuMbar& m = emu_mbar(bar);
  m.pending -= arrivals;
  m.tx += tx;
  if (m.pending < 0) emu_fail("mbarrier: more arrivals than its count");
  if (m.pending == 0 && m.tx == 0) {
    m.phase += 1;
    m.pending = m.expected;
    g_mbar_cv.notify_all();
  }
}

inline void mbar_init(uint32_t bar, uint32_t count) {
  if (bar % 8) emu_fail("mbarrier not 8-byte aligned");
  std::lock_guard<std::mutex> lock(g_mbar_mutex);
  EmuMbar m;
  m.expected = m.pending = (int)count;
  g_mbars[bar] = m;
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint32_t bar) { emu_mbar_update(bar, 1, 0); }
inline void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  emu_mbar_update(bar, 1, (long long)bytes);
}
// an arrival on another block's barrier (its window's address)
inline void mbar_arrive_cluster(uint32_t addr) { emu_mbar_update(addr, 1, 0); }
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  std::unique_lock<std::mutex> lock(g_mbar_mutex);
  const bool done = g_mbar_cv.wait_for(lock, std::chrono::seconds(60), [&] {
    return (emu_mbar(bar).phase & 1u) != parity;
  });
  if (!done) emu_fail("mbarrier wait never completed");
}

inline void mbar_wait_cluster(uint32_t bar, uint32_t parity) { mbar_wait(bar, parity); }

// ---- TMA ------------------------------------------------------------------

// What the emulated cuTensorMapEncodeTiled keeps in a CUtensorMap.
struct EmuTensorMap {
  const char* base;
  int rank, elem, swizzle;  // swizzle in bytes, 0 for none
  uint64_t dims[5], strides[5];
  uint32_t box[5];
};
static_assert(sizeof(EmuTensorMap) <= sizeof(CUtensorMap), "tensor map");

inline uint32_t emu_swizzle(uint32_t addr, int sw) {
  return sw ? addr ^ (((addr >> 7) & (uint32_t)(sw / 16 - 1)) << 4) : addr;
}

inline void emu_tma(uint32_t dst, const CUtensorMap* map, uint32_t bar, const int* c) {
  EmuTensorMap m;
  memcpy(&m, map, sizeof m);
  if (dst % (m.swizzle ? 1024 : 16)) emu_fail("TMA destination misaligned");
  if (m.swizzle && (int)m.box[0] * m.elem != m.swizzle)
    emu_fail("TMA box rows other than the swizzle span are not emulated");
  uint64_t n = 1;
  for (int i = 0; i < m.rank; ++i) n *= m.box[i];
  for (uint64_t idx = 0; idx < n; ++idx) {
    uint64_t rest = idx, off = 0;
    bool inside = true;
    for (int i = 0; i < m.rank; ++i) {
      const long long at = (long long)c[i] + (long long)(rest % m.box[i]);
      rest /= m.box[i];
      inside = inside && at >= 0 && at < (long long)m.dims[i];
      off += inside ? (uint64_t)at * m.strides[i] : 0;
    }
    char* to = emu_smem(emu_swizzle(dst + (uint32_t)(idx * m.elem), m.swizzle));
    if (inside) memcpy(to, m.base + off, m.elem);
    else memset(to, 0, m.elem);
  }
  emu_mbar_update(bar, 0, -(long long)(n * m.elem));
}

inline void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                        int c2) {
  const int c[3] = {c0, c1, c2};
  emu_tma(dst, map, bar, c);
}

// ---- wgmma ----------------------------------------------------------------

inline uint64_t make_desc(uint32_t addr, int sw) {
  const uint64_t mode = sw == 128 ? 1 : (sw == 64 ? 2 : 3);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * sw) >> 4) << 32) | (mode << 62);
}

struct EmuWgmma {
  float* d;
  int nb;  // n8 blocks: N = 8 * nb
  bool accumulate;
  uint64_t a_desc;
  const uint32_t* a_regs;  // null: A from a_desc
  uint64_t b_desc;
  int trans_b;
  bool tf32;  // m64nNk8 on TF32 (4-byte elements), else m64nNk16 on bf16
};

// An f32 bit pattern as the TF32 value the tensor cores take: its low 13
// mantissa bits ignored.
inline float emu_tf32_bits(uint32_t u) {
  u &= 0xffffe000u;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline thread_local std::vector<EmuWgmma> t_issued;
inline thread_local std::deque<std::vector<EmuWgmma>> t_committed;

// A decoded descriptor: the element (row, k) of a K-major operand, or (k,
// n) of an MN-major one, read from shared memory as f32.
struct EmuDesc {
  uint32_t start, lbo, sbo;
  int sw;
  explicit EmuDesc(uint64_t desc) {
    const int mode = (int)(desc >> 62);
    if (mode == 0) emu_fail("wgmma: the interleaved (unswizzled) layout is not emulated");
    if ((desc >> 49) & 7) emu_fail("wgmma: a descriptor base offset is not emulated");
    sw = mode == 1 ? 128 : (mode == 2 ? 64 : 32);
    // the 18-bit address names the executing block's own window
    start = ((uint32_t)emu_rank << 20) | ((uint32_t)(desc & 0x3FFF) << 4);
    lbo = (uint32_t)((desc >> 16) & 0x3FFF) << 4;
    sbo = (uint32_t)((desc >> 32) & 0x3FFF) << 4;
  }
  float at(uint32_t addr) const {
    __nv_bfloat16 b;
    memcpy(&b, emu_smem(emu_swizzle(addr, sw)), 2);
    return __bfloat162float(b);
  }
  float at32(uint32_t addr) const {
    uint32_t u;
    memcpy(&u, emu_smem(emu_swizzle(addr, sw)), 4);
    return emu_tf32_bits(u);
  }
  // K-major: rows sw bytes apart, 8-row groups sbo apart, k along the row
  float k_major(int row, int k) const {
    if (start % sw + 32 > (uint32_t)sw) emu_fail("wgmma: a K-major k16 slice leaves its row");
    return at(start + (row / 8) * sbo + (row % 8) * sw + 2 * k);
  }
  // the same for TF32: a k8 slice of 4-byte elements, 32 bytes of its row
  float k_major32(int row, int k) const {
    if (start % sw + 32 > (uint32_t)sw) emu_fail("wgmma: a K-major k8 slice leaves its row");
    return at32(start + (row / 8) * sbo + (row % 8) * sw + 4 * k);
  }
  // MN-major: n along the row (sw/2 columns a panel, panels lbo apart),
  // k rows sw bytes apart, 8-row groups sbo apart
  float mn_major(int k, int n) const {
    if (start % (8 * sw)) emu_fail("wgmma: an MN-major operand off its swizzle atom");
    const int w = sw / 2;
    return at(start + (n / w) * lbo + (k / 8) * sbo + (k % 8) * sw + 2 * (n % w));
  }
};

inline float emu_a_reg(int warp, int row, int k) {
  const int g = row % 8, half = (row % 16) / 8;
  const uint64_t w = emu_lane_of(warp, 4 * g + (k % 8) / 2)[half + 2 * (k / 8)];
  __nv_bfloat16 b = {(unsigned short)((w >> (16 * (k % 2))) & 0xffff)};
  return __bfloat162float(b);
}

// The TF32 A operand of a k8 step from registers: mma.m16n8k8.tf32's A
// layout on each warp's 16 rows, one value a register: a0 (g, t), a1 (g+8,
// t), a2 (g, t+4), a3 (g+8, t+4).
inline float emu_a_reg32(int warp, int row, int k) {
  const int g = row % 8, half = (row % 16) / 8;
  return emu_tf32_bits((uint32_t)emu_lane_of(warp, 4 * g + k % 4)[half + 2 * (k / 4)]);
}

// One product, by the warpgroup: every thread calls it with its own op.
inline void emu_run_wgmma(const EmuWgmma& op) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, first = warp / 4 * 4;
  if (op.tf32 && op.trans_b) emu_fail("wgmma: TF32 takes K-major operands only");
  if (op.a_regs)
    for (int i = 0; i < 4; ++i) emu_lane(lane)[i] = op.a_regs[i];
  emu_group_sync();
  const EmuDesc b(op.b_desc);
  const int depth = op.tf32 ? 8 : 16;
  for (int j = 0; j < op.nb; ++j) {
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * (warp % 4) + lane / 4 + 8 * (e >> 1);
      const int col = 8 * j + 2 * (lane % 4) + (e & 1);
      float sum = op.accumulate ? op.d[4 * j + e] : 0.f;
      for (int k = 0; k < depth; ++k) {
        float a, bv;
        if (op.tf32) {  // products of TF32 values, exact in f32, summed in f32
          a = op.a_regs ? emu_a_reg32(first + row / 16, row % 16, k)
                        : EmuDesc(op.a_desc).k_major32(row, k);
          bv = b.k_major32(col, k);
        } else {
          a = op.a_regs ? emu_a_reg(first + row / 16, row % 16, k)
                        : EmuDesc(op.a_desc).k_major(row, k);
          bv = op.trans_b ? b.mn_major(k, col) : b.k_major(col, k);
        }
        sum += a * bv;
      }
      op.d[4 * j + e] = sum;
    }
  }
  emu_group_sync();
}

inline bool emu_wgmma_leftovers() {
  const bool left = !t_issued.empty() || !t_committed.empty();
  t_issued.clear();
  t_committed.clear();
  return left;
}

template <int NB> inline void emu_issue(float (&d)[NB][4], uint64_t a, const uint32_t* a_regs,
                                        uint64_t b, bool accumulate, int trans_b,
                                        bool tf32 = false) {
  emu_block_leftovers = &emu_wgmma_leftovers;
  t_issued.push_back({&d[0][0], NB, accumulate, a, a_regs, b, trans_b, tf32});
}

template <int TRANS_B, int NB>
inline void wgmma_ss(float (&d)[NB][4], uint64_t a, uint64_t b, bool accumulate) {
  static_assert(NB == 2 || NB == 4 || NB == 8, "wgmma m64n16/32/64");
  emu_issue(d, a, nullptr, b, accumulate, TRANS_B);
}
template <int TRANS_B, int NB>
inline void wgmma_rs(float (&d)[NB][4], const uint32_t (&a)[4], uint64_t b, bool accumulate) {
  static_assert(NB == 2 || NB == 4 || NB == 8, "wgmma m64n16/32/64");
  emu_issue(d, 0, a, b, accumulate, TRANS_B);
}

// TF32: K-major only (the instruction has no transpose bits; the
// emulation refuses a transposed TF32 operand, emu_run_wgmma).
template <int NB>
inline void wgmma_tf32_ss(float (&d)[NB][4], uint64_t a, uint64_t b, bool accumulate) {
  static_assert(NB == 2 || NB == 4 || NB == 8, "wgmma m64n16/32/64");
  emu_issue(d, a, nullptr, b, accumulate, 0, true);
}
template <int NB>
inline void wgmma_tf32_rs(float (&d)[NB][4], const uint32_t (&a)[4], uint64_t b, bool accumulate) {
  static_assert(NB == 2 || NB == 4 || NB == 8, "wgmma m64n16/32/64");
  emu_issue(d, 0, a, b, accumulate, 0, true);
}

inline void fence_proxy_async() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {
  t_committed.push_back(std::move(t_issued));
  t_issued.clear();
}
template <int N> inline void wgmma_wait() {
  while ((int)t_committed.size() > N) {
    for (const EmuWgmma& op : t_committed.front()) emu_run_wgmma(op);
    t_committed.pop_front();
  }
}
template <int NB> inline void fence_acc(float (&)[NB][4]) {}

// ---- named barriers ---------------------------------------------------------

inline std::mutex g_named_mutex;
inline std::condition_variable g_named_cv;

// One arrival at a barrier of the block; true if it completed a phase.
inline bool emu_named_arrive(EmuNamedBarrier& b, int count) {
  if (count % 32 || count <= 0) emu_fail("named barrier count not a whole number of warps");
  if (++b.count < count) return false;
  b.count = 0;
  ++b.generation;
  g_named_cv.notify_all();
  return true;
}
inline void named_arrive(int id, int count) {
  std::lock_guard<std::mutex> lock(g_named_mutex);
  emu_named_arrive(g_blocks[emu_rank].named[id], count);
}
inline void named_sync(int id, int count) {
  std::unique_lock<std::mutex> lock(g_named_mutex);
  EmuNamedBarrier& b = g_blocks[emu_rank].named[id];
  const unsigned generation = b.generation;
  if (emu_named_arrive(b, count)) return;
  if (!g_named_cv.wait_for(lock, std::chrono::seconds(60), [&] { return b.generation != generation; }))
    emu_fail("named barrier wait never completed");
}

// ---- cluster and distributed shared memory ---------------------------------

inline void cluster_sync() { pthread_barrier_wait(&g_cluster_barrier); }
inline uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  if ((addr >> 20) != (uint32_t)emu_rank) emu_fail("mapa of an address outside the block's window");
  return (addr & (kEmuSmemWindow - 1)) | (rank << 20);
}
inline float ld_cluster_f32(uint32_t addr) {
  float v;
  memcpy(&v, emu_smem(addr), 4);
  return v;
}

inline void st_cluster_v4(uint32_t addr, float4 v) {
  if (addr % 16) emu_fail("st.shared::cluster.v4 misaligned");
  memcpy(emu_smem(addr), &v, 16);
}

inline float4 ld_cluster_v4(uint32_t addr) {
  if (addr % 16) emu_fail("ld.shared::cluster.v4 misaligned");
  float4 v;
  memcpy(&v, emu_smem(addr), 16);
  return v;
}

// ---- register reallocation ---------------------------------------------------

inline void emu_setmaxnreg(int n) {
  if (n % 8 || n < 24 || n > 256) emu_fail("setmaxnreg: count not a multiple of 8 in 24..256");
  if (threadIdx.x % 128 == 0) g_blocks[emu_rank].maxnreg[threadIdx.x / 128] = n;
  emu_group_sync();
  if (g_blocks[emu_rank].maxnreg[threadIdx.x / 128] != n)
    emu_fail("setmaxnreg: the warpgroup's threads disagree on the count");
  emu_group_sync();
}
template <int N> inline void setmaxnreg_inc() { emu_setmaxnreg(N); }
template <int N> inline void setmaxnreg_dec() { emu_setmaxnreg(N); }

// ---- arithmetic -----------------------------------------------------------

inline float exp2_approx(float x) {
  const float y = exp2f(x);
  return y < 1.17549435e-38f ? 0.f : y;
}

// cvt.rna.tf32.f32: to 10 mantissa bits, to nearest, ties away from zero
// (NaN and infinity kept).
inline uint32_t cvt_tf32(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) == 0x7f800000u) return u;
  return (u + 0x1000u) & 0xffffe000u;
}
inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = cvt_tf32(x);
  float h;
  memcpy(&h, &hi, 4);
  lo = cvt_tf32(x - h);
}

}  // namespace wgmma_sm90

// ---- host: the emulated encoder, then the launchers' own host code ---------

inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* steps,
                                 CUtensorMapInterleave interleave, CUtensorMapSwizzle swizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  wgmma_sm90::EmuTensorMap m = {};
  m.base = (const char*)base;
  m.rank = (int)rank;
  m.elem = type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2 : (type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 0);
  m.swizzle = swizzle == CU_TENSOR_MAP_SWIZZLE_NONE ? 0 : 16 << (int)swizzle;
  // the checks cuTensorMapEncodeTiled makes on these arguments
  if (m.elem == 0 || rank < 1 || rank > 5 || (uintptr_t)base % 16 ||
      interleave != CU_TENSOR_MAP_INTERLEAVE_NONE)
    return CUDA_ERROR_INVALID_VALUE;
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (dims[i] < 1 || box[i] < 1 || box[i] > 256 || steps[i] != 1) return CUDA_ERROR_INVALID_VALUE;
    m.dims[i] = dims[i];
    m.box[i] = box[i];
    m.strides[i] = i == 0 ? (uint64_t)m.elem : strides[i - 1];
    if (i > 0 && (strides[i - 1] % 16 || strides[i - 1] >= ((uint64_t)1 << 40)))
      return CUDA_ERROR_INVALID_VALUE;
  }
  if ((box[0] * m.elem) % 16 || (m.swizzle && (int)(box[0] * m.elem) > m.swizzle))
    return CUDA_ERROR_INVALID_VALUE;
  memset(map, 0, sizeof *map);
  memcpy(map, &m, sizeof m);
  return CUDA_SUCCESS;
}

enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0, cudaDriverEntryPointSymbolNotFound = 1 };
constexpr unsigned long long cudaEnableDefault = 0;
inline cudaError_t cudaGetDriverEntryPointByVersion(const char* symbol, void** fn, unsigned int,
                                                    unsigned long long,
                                                    cudaDriverEntryPointQueryResult* found) {
  const bool ok = strcmp(symbol, "cuTensorMapEncodeTiled") == 0;
  *fn = ok ? (void*)&emu_encode_tiled : nullptr;
  *found = ok ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}

// csrc/wgmma_sm90.cuh's host part, as it stands (the test copies it here)
#include "wgmma_sm90_host.inc"
