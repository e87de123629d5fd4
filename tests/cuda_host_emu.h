// Host emulation of the CUDA features convexadam_torch/csrc/mind.cu uses, so
// that tests/test_torch_mind_host.py can build the kernel source with g++ and
// run it on CPU tensors: every CUDA thread of a block is a std::thread,
// __syncthreads a std::barrier, the blocks run one after another; the
// __f*_rn intrinsics are host float operations (built with
// -ffp-contract=off), and the bf16x2 PTX instructions of Pair<__nv_bfloat16>
// (rewritten by the test into emu_asm calls) compute in float and round to
// bfloat16 to nearest even, as the instructions do for these operands.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __builtin_assume(x) ((void)0)
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local std::barrier<>* emu_bar;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
alignas(16) inline float4 emu_smem_store[232448 / 16];
inline float4* const emu_smem = emu_smem_store;
// an H100's dynamic shared memory per CTA; a larger request is refused as
// the card refuses it (cudaErrorInvalidValue is 1, this 98)
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int v) { return v <= 232448 ? 0 : 98; }
inline cudaError_t cudaGetLastError() { return 0; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline unsigned __byte_perm(unsigned a, unsigned b, unsigned s) {
  uint64_t v = ((uint64_t)b << 32) | a;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
  return r;
}
struct __nv_bfloat16 { uint16_t v; };
inline uint16_t emu_f2bf(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float((unsigned)b.v << 16); }
inline __nv_bfloat16 __float2bfloat16_rn(float f) { return {emu_f2bf(f)}; }
inline float emu_lo(unsigned p) { return __uint_as_float(p << 16); }
inline float emu_hi(unsigned p) { return __uint_as_float(p & 0xffff0000u); }
inline unsigned emu_pack(float lo, float hi) {
  return ((unsigned)emu_f2bf(hi) << 16) | emu_f2bf(lo);
}
// the PTX instructions of Pair<__nv_bfloat16>: cvt.rn.bf16x2.f32 (its first
// source goes to the high half), add, sub, mul and min of bf16x2
inline unsigned emu_asm(const char*, float hi, float lo) { return emu_pack(lo, hi); }
inline unsigned emu_asm(const char* op, unsigned a, unsigned b) {
  float (*f)(float, float);
  if (!strncmp(op, "add", 3)) f = [](float x, float y) { return x + y; };
  else if (!strncmp(op, "sub", 3)) f = [](float x, float y) { return x - y; };
  else if (!strncmp(op, "mul", 3)) f = [](float x, float y) { return x * y; };
  else f = [](float x, float y) { return std::fmin(x, y); };
  return emu_pack(f(emu_lo(a), emu_lo(b)), f(emu_hi(a), emu_hi(b)));
}
inline void emu_launch(dim3 grid, unsigned nt, const std::function<void()>& body) {
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(nt);
        std::vector<std::thread> th;
        th.reserve(nt);
        for (unsigned t = 0; t < nt; ++t)
          th.emplace_back([&, t, x, y, z] {
            threadIdx = {t, 0, 0};
            blockIdx = {x, y, z};
            emu_bar = &bar;
            body();
          });
        for (auto& h : th) h.join();
      }
}
