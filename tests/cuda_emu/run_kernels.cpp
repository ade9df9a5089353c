// Runs the port's flash-attention launchers under the CPU emulation of
// emu.h: reads q, k, v, dO as raw f32 from <dir>, converts them to the
// launch dtype, runs the forward (with LSE), dQ and dK/dV, and writes o,
// lse, dq, delta, dk, dv back to <dir> as raw f32.
//
//   run_kernels <dir> <bh> <t> <d> <dtype: 0 f32, 1 bf16>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu.h"

extern "C" int flash_attention_fwd(const void*, const void*, const void*, void*, void*, int,
                                   int, int, int, float, void*);
extern "C" int flash_attention_bwd_dq(const void*, const void*, const void*, const void*,
                                      const void*, const void*, void*, void*, int, int, int,
                                      int, float, void*);
extern "C" int flash_attention_bwd_dkv(const void*, const void*, const void*, const void*,
                                       const void*, const void*, void*, void*, int, int, int,
                                       int, float, void*);

namespace {

// A tensor in the launch dtype, in 16-byte-aligned storage.
struct Tensor {
  int dtype;
  size_t n;
  std::vector<char> raw;
  Tensor(int dt, size_t count) : dtype(dt), n(count), raw(count * (dt ? 2 : 4) + 16) {}
  void* ptr() { return (void*)(((uintptr_t)raw.data() + 15) & ~(uintptr_t)15); }
  void set(const std::vector<float>& f) {
    for (size_t i = 0; i < n; ++i) {
      if (dtype) ((__nv_bfloat16*)ptr())[i] = __float2bfloat16(f[i]);
      else ((float*)ptr())[i] = f[i];
    }
  }
  std::vector<float> get() {
    std::vector<float> f(n);
    for (size_t i = 0; i < n; ++i)
      f[i] = dtype ? __bfloat162float(((__nv_bfloat16*)ptr())[i]) : ((float*)ptr())[i];
    return f;
  }
};

std::vector<float> read(const std::string& path, size_t n) {
  std::vector<float> f(n);
  FILE* fp = fopen(path.c_str(), "rb");
  if (!fp || fread(f.data(), 4, n, fp) != n) { fprintf(stderr, "cannot read %s\n", path.c_str()); exit(2); }
  fclose(fp);
  return f;
}

void write(const std::string& path, const std::vector<float>& f) {
  FILE* fp = fopen(path.c_str(), "wb");
  if (!fp || fwrite(f.data(), 4, f.size(), fp) != f.size()) { fprintf(stderr, "cannot write %s\n", path.c_str()); exit(2); }
  fclose(fp);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 6) { fprintf(stderr, "usage: run_kernels dir bh t d dtype\n"); return 2; }
  const std::string dir = argv[1];
  const int bh = atoi(argv[2]), t = atoi(argv[3]), d = atoi(argv[4]), dt = atoi(argv[5]);
  const size_t n = (size_t)bh * t * d, rows = (size_t)bh * t;
  const float scale = 1.f / sqrtf((float)d);
  Tensor q(dt, n), k(dt, n), v(dt, n), dout(dt, n), o(dt, n), dq(dt, n), dk(dt, n), dv(dt, n);
  Tensor lse(0, rows), delta(0, rows);
  q.set(read(dir + "/q", n));
  k.set(read(dir + "/k", n));
  v.set(read(dir + "/v", n));
  dout.set(read(dir + "/do", n));
  int err = flash_attention_fwd(q.ptr(), k.ptr(), v.ptr(), o.ptr(), lse.ptr(), bh, t, d, dt, scale, nullptr);
  err = err ? err : flash_attention_bwd_dq(q.ptr(), k.ptr(), v.ptr(), o.ptr(), dout.ptr(), lse.ptr(),
                                           dq.ptr(), delta.ptr(), bh, t, d, dt, scale, nullptr);
  err = err ? err : flash_attention_bwd_dkv(q.ptr(), k.ptr(), v.ptr(), dout.ptr(), lse.ptr(),
                                            delta.ptr(), dk.ptr(), dv.ptr(), bh, t, d, dt, scale, nullptr);
  if (err) { fprintf(stderr, "launch error %d\n", err); return 1; }
  write(dir + "/o", o.get());
  write(dir + "/lse", lse.get());
  write(dir + "/dq", dq.get());
  write(dir + "/delta", delta.get());
  write(dir + "/dk", dk.get());
  write(dir + "/dv", dv.get());
  return 0;
}
