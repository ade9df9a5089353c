// Runs the port's flash-attention launchers under the CPU emulation of
// emu.h: reads q, k, v, dO as raw f32 from <dir>, converts them to the
// launch dtype, runs the forward (with LSE), dQ and dK/dV, and writes o,
// lse, dq, delta, dk, dv back to <dir> as raw f32.
//
//   run_kernels <dir> <bh> <t> <d> <dtype: 0 f32, 1 bf16> <split> <d_fwd> <d_dq> <d_dkv> <dkv_split>
//               [<dq_split>]
//
// split: the forward's split over keys (0: the launcher's own rule);
// dkv_split: the dK/dV's split over query tiles (likewise): the bf16 kernel's
// at D >= 128, the f32 kernel's at D <= 128 (ignored at D = 256, where its
// cluster splits the head dim);
// dq_split: the f32 dQ's split over keys at D <= 128 (likewise; default 0);
// d_fwd, d_dq, d_dkv: the head dim each launcher runs at, to which its
// inputs are zero-padded as the wrappers pad them (the outputs sliced back).
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "emu.h"

extern "C" int flash_attention_fwd_split(const void*, const void*, const void*, void*, void*,
                                         int, int, int, int, float, int, void*);
extern "C" int flash_attention_bwd_dq_split(const void*, const void*, const void*, const void*,
                                            const void*, const void*, void*, void*, int, int, int,
                                            int, float, int, void*);
extern "C" int flash_attention_bwd_dkv_split(const void*, const void*, const void*,
                                             const void*, const void*, const void*, void*,
                                             void*, int, int, int, int, float, int, void*);

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

// [rows, d] as [rows, d_to], zeros in the new columns (d_to >= d), or back.
std::vector<float> repad(const std::vector<float>& x, size_t rows, int d, int d_to) {
  std::vector<float> y(rows * d_to, 0.f);
  for (size_t r = 0; r < rows; ++r)
    for (int c = 0; c < d && c < d_to; ++c) y[r * d_to + c] = x[r * d + c];
  return y;
}

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
  if (argc != 11 && argc != 12) {
    fprintf(stderr, "usage: run_kernels dir bh t d dtype split d_fwd d_dq d_dkv dkv_split [dq_split]\n");
    return 2;
  }
  const std::string dir = argv[1];
  const int bh = atoi(argv[2]), t = atoi(argv[3]), d = atoi(argv[4]), dt = atoi(argv[5]);
  const int split = atoi(argv[6]), d_fwd = atoi(argv[7]), d_dq = atoi(argv[8]), d_dkv = atoi(argv[9]);
  const int dkv_split = atoi(argv[10]), dq_split = argc > 11 ? atoi(argv[11]) : 0;
  const size_t rows = (size_t)bh * t, n = rows * d;
  const float scale = 1.f / sqrtf((float)d);
  const std::vector<float> fq = read(dir + "/q", n), fk = read(dir + "/k", n),
                           fv = read(dir + "/v", n), fdo = read(dir + "/do", n);
  // the inputs and outputs of one launch, at its head dim dk
  auto tensors = [&](int dk, std::vector<const std::vector<float>*> ins, int n_out) {
    std::vector<Tensor> ts;
    for (auto* x : ins) {
      ts.emplace_back(dt, rows * dk);
      ts.back().set(repad(*x, rows, d, dk));
    }
    for (int i = 0; i < n_out; ++i) ts.emplace_back(dt, rows * dk);
    return ts;
  };
  Tensor lse(0, rows), delta(0, rows);
  std::vector<Tensor> f = tensors(d_fwd, {&fq, &fk, &fv}, 1);
  int err = flash_attention_fwd_split(f[0].ptr(), f[1].ptr(), f[2].ptr(), f[3].ptr(), lse.ptr(), bh,
                                      t, d_fwd, dt, scale, split, nullptr);
  const std::vector<float> fo = repad(f[3].get(), rows, d_fwd, d);
  std::vector<Tensor> b = tensors(d_dq, {&fq, &fk, &fv, &fo, &fdo}, 1);
  err = err ? err : flash_attention_bwd_dq_split(b[0].ptr(), b[1].ptr(), b[2].ptr(), b[3].ptr(),
                                                 b[4].ptr(), lse.ptr(), b[5].ptr(), delta.ptr(), bh,
                                                 t, d_dq, dt, scale, dq_split, nullptr);
  std::vector<Tensor> c = tensors(d_dkv, {&fq, &fk, &fv, &fdo}, 2);
  err = err ? err : flash_attention_bwd_dkv_split(c[0].ptr(), c[1].ptr(), c[2].ptr(), c[3].ptr(),
                                                  lse.ptr(), delta.ptr(), c[4].ptr(), c[5].ptr(),
                                                  bh, t, d_dkv, dt, scale, dkv_split, nullptr);
  if (err) { fprintf(stderr, "launch error %d\n", err); return 1; }
  write(dir + "/o", fo);
  write(dir + "/lse", lse.get());
  write(dir + "/dq", repad(b[5].get(), rows, d_dq, d));
  write(dir + "/delta", delta.get());
  write(dir + "/dk", repad(c[4].get(), rows, d_dkv, d));
  write(dir + "/dv", repad(c[5].get(), rows, d_dkv, d));
  return 0;
}
