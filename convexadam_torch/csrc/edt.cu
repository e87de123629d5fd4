// Nearest-neighbour searches of the surface point-set HD95 engine: per query
// point, the least squared distance to a target point set.
//
// Replaces the TPU kernels of convexadam_tpu/ops/edt_pallas.py:
//   nearest_sq         <- nearest_sq_pallas -> _kernel
//   nearest_sq_dual    <- nearest_sq_dual_pallas -> _dual_kernel
//   nearest_sq_pruned  <- nearest_sq_pruned_pallas -> _pruned_kernel
//
// Points are (3, K) float32 rows of integer coordinates below 1024; buffer
// tails hold the pad 8192 = 2^13.  Every cell is
//   d = fma(qz, -2 tz, fma(qy, -2 ty, fma(qx, -2 tx, |t|^2 + |q|^2)))
// in plain FP32 on the CUDA cores.  Between two real points every product
// and partial sum is an integer below 2^24, so d is exact and equals the
// plain PyTorch version's (|t|^2 + |q|^2) - 2 cross bit for bit, whatever
// the order of operations.  Entries outside the caller's meaningful ranges
// are not meaningful (the callers mask them), as in the JAX package.
//
// Bound on the H100: operations.  A cell costs about 8 FP32 operations and
// the searches read only (3, K) rows and write (K,) minima, so at the
// engine's sizes (K = 4096 to 65536 points) the distance arithmetic over the
// cells a search evaluates, at 67 TFLOP/s, is the floor.
//
// Design.  One CTA per query block, one query per thread.  A target tile is
// staged in shared memory once per CTA as float4 (-2x, -2y, -2z, |t|^2), so
// a cell is one broadcast 16-byte shared load and four FP32 instructions
// plus the min.  Targets at or past n_target are staged as (0, 0, 0, +inf)
// and never win.  The TPU walked its grid in order and could carry an
// accumulator from one grid step to the next; Hopper blocks run in no
// order, so
//  - nearest_sq loops over the live target tiles inside the CTA;
//  - nearest_sq_dual's per-target minima, which run across query blocks,
//    are reduced per tile over the CTA's warps (shuffles, then shared
//    memory) and merged into the output with atomicMin on the int bit
//    pattern: every value is >= 0 (pad x pad is exactly +0), where the
//    order of IEEE floats is that of their bits, and min is order-free, so
//    the result is deterministic;
//  - nearest_sq_pruned walks the target blocks in the precomputed order of
//    their bounding-box lower bounds while the bound does not exceed the
//    block's running max-of-mins over meaningful queries (a block-wide
//    reduction and barrier per tile), reading each visited tile from
//    global memory (L2): nothing requires the whole target set resident.
#include "common.cuh"

#include <math.h>

namespace {

constexpr float kInit = 4.0f * 8192.0f * 8192.0f;  // the JAX package's _ACC_INIT
constexpr int TB = 256;                             // tiled / dual: queries and targets per tile
constexpr int PB = 128;                             // pruned: queries and targets per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 stage_target(const float* __restrict__ t, int Kt, int idx,
                                               int live) {
  if (idx < live) {
    const float x = t[idx], y = t[Kt + idx], z = t[2 * Kt + idx];
    const float n = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    return make_float4(-2.f * x, -2.f * y, -2.f * z, n);
  }
  return make_float4(0.f, 0.f, 0.f, INFINITY);
}

struct Query {
  float x, y, z, n;
};

// A query at qi < live, else one whose every cell is +inf.
__device__ __forceinline__ Query load_query(const float* __restrict__ q, int Kq, int qi,
                                            int live) {
  if (qi < live) {
    const float x = q[qi], y = q[Kq + qi], z = q[2 * Kq + qi];
    return Query{x, y, z, __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z))};
  }
  return Query{0.f, 0.f, 0.f, INFINITY};
}

__device__ __forceinline__ float cell(const float4 t, const Query& q) {
  return fmaf(q.z, t.z, fmaf(q.y, t.y, fmaf(q.x, t.x, __fadd_rn(t.w, q.n))));
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(TB)
nearest_sq_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  float* __restrict__ out, int Kq, int Kt, const int* __restrict__ nq_p,
                  const int* __restrict__ nt_p) {
  __shared__ float4 tile[TB];
  const int i0 = blockIdx.x * TB;
  const int qi = i0 + threadIdx.x;
  const int nq = min(*nq_p, Kq);
  const int nt = min(*nt_p, Kt);
  if (i0 >= nq) {  // a query block past n_query: the TPU kernel's init
    if (qi < Kq) out[qi] = kInit;
    return;
  }
  // queries at or past n_query keep the init too (+inf cells)
  const Query qq = load_query(q, Kq, qi, nq);
  float m = kInit;
  for (int j0 = 0; j0 < nt; j0 += TB) {
    __syncthreads();
    tile[threadIdx.x] = stage_target(t, Kt, j0 + threadIdx.x, nt);
    __syncthreads();
#pragma unroll 16
    for (int k = 0; k < TB; ++k) m = fminf(m, cell(tile[k], qq));
  }
  if (qi < Kq) out[qi] = m;
}

__global__ void __launch_bounds__(TB)
nearest_sq_dual_kernel(const float* __restrict__ q, const float* __restrict__ t,
                       float* __restrict__ outq, int* __restrict__ outt, int Kq, int Kt,
                       const int* __restrict__ nq_p, const int* __restrict__ nt_p,
                       const int* __restrict__ hq_p, const int* __restrict__ ht_p) {
  __shared__ float4 tile[TB];
  __shared__ float colw[TB / 32][TB];
  const int i0 = blockIdx.x * TB;
  const int qi = i0 + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = min(*nq_p, Kq);
  const int nt = min(*nt_p, Kt);
  if (i0 >= nq) {
    if (qi < Kq) outq[qi] = kInit;
    return;
  }
  const int ht = *ht_p;
  // block-level liveness of the (head_q x head_t) corner, as the TPU kernel
  const bool past_head_q = i0 + TB > *hq_p;
  // queries at or past n_query give +inf cells: they take no part in the
  // per-target minima
  const Query qq = load_query(q, Kq, qi, nq);
  float m = kInit;
  for (int j0 = 0; j0 < nt; j0 += TB) {
    if (!past_head_q && j0 + TB <= ht) continue;
    __syncthreads();
    tile[threadIdx.x] = stage_target(t, Kt, j0 + threadIdx.x, nt);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < TB; ++k) {
      const float d = cell(tile[k], qq);
      m = fminf(m, d);
      const float c = warp_min(d);
      if (lane == 0) colw[warp][k] = c;
    }
    __syncthreads();
    const int tj = j0 + threadIdx.x;
    if (tj < nt) {
      float c = colw[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < TB / 32; ++w) c = fminf(c, colw[w][threadIdx.x]);
      if (c < kInit) atomicMin(outt + tj, __float_as_int(c));
    }
  }
  if (qi < Kq) outq[qi] = m;
}

__global__ void __launch_bounds__(PB)
nearest_sq_pruned_kernel(const float* __restrict__ q, const float* __restrict__ t,
                         const int* __restrict__ order, const float* __restrict__ dsort,
                         float* __restrict__ out, int* __restrict__ tiles, int Kq, int Kt,
                         int gj, const int* __restrict__ lo_p, const int* __restrict__ hi_p,
                         const int* __restrict__ nt_p) {
  __shared__ float4 tile[PB];
  __shared__ float red[PB / 32];
  __shared__ float bound_s;
  const int i = blockIdx.x;
  const int i0 = i * PB;
  const int qi = i0 + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = *lo_p, hi = min(*hi_p, Kq);
  const int nt = min(*nt_p, Kt);
  if (!(i0 < hi && i0 + PB > lo)) {  // no meaningful query in the block
    if (qi < Kq) out[qi] = kInit;
    if (threadIdx.x == 0) tiles[i] = 0;
    return;
  }
  const bool meaningful = qi >= lo && qi < hi;
  const Query qq = load_query(q, Kq, qi, Kq);
  const int* ord = order + (size_t)i * gj;
  const float* ds = dsort + (size_t)i * gj;
  float m = kInit;
  float bound = kInit;
  int j = 0;
  // dsort is ascending: the first block whose box bound exceeds the running
  // max-of-mins ends the walk exactly (no later block can improve any
  // meaningful query); bound and j are uniform over the CTA
  while (j < gj && ds[j] <= bound) {
    const int jj = ord[j];
    __syncthreads();
    tile[threadIdx.x] = stage_target(t, Kt, jj * PB + threadIdx.x, nt);
    __syncthreads();
#pragma unroll 16
    for (int k = 0; k < PB; ++k) m = fminf(m, cell(tile[k], qq));
    // the bound runs over meaningful queries only: pad and dead entries
    // keep their init and would stop all pruning
    const float v = warp_max(meaningful ? m : -1.f);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float b = red[0];
#pragma unroll
      for (int w = 1; w < PB / 32; ++w) b = fmaxf(b, red[w]);
      bound_s = b;
    }
    __syncthreads();
    bound = bound_s;
    ++j;
  }
  if (qi < Kq) out[qi] = m;
  if (threadIdx.x == 0) tiles[i] = j;
}

}  // namespace

// query (3, Kq) and target (3, Kt) float32; out (Kq,) float32; n_query and
// n_target are int32 scalars on the card.  block must be the kernel's TB.
extern "C" int nearest_sq(const void* q, const void* t, void* out, int Kq, int Kt,
                          const void* nq, const void* nt, int block, void* stream) {
  if (block != TB) return (int)cudaErrorInvalidValue;
  if (Kq <= 0) return 0;
  nearest_sq_kernel<<<(Kq + TB - 1) / TB, TB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(t), static_cast<float*>(out), Kq,
      Kt, static_cast<const int*>(nq), static_cast<const int*>(nt));
  return (int)cudaGetLastError();
}

// As nearest_sq, plus outt (Kt,) float32, which the caller fills with the
// init value 4 * 8192^2 before the launch; head_query and head_target are
// int32 scalars on the card.
extern "C" int nearest_sq_dual(const void* q, const void* t, void* outq, void* outt, int Kq,
                               int Kt, const void* nq, const void* nt, const void* hq,
                               const void* ht, int block, void* stream) {
  if (block != TB) return (int)cudaErrorInvalidValue;
  if (Kq <= 0) return 0;
  nearest_sq_dual_kernel<<<(Kq + TB - 1) / TB, TB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(t), static_cast<float*>(outq),
      static_cast<int*>(outt), Kq, Kt, static_cast<const int*>(nq),
      static_cast<const int*>(nt), static_cast<const int*>(hq), static_cast<const int*>(ht));
  return (int)cudaGetLastError();
}

// order (gi, gj) int32 and dsort (gi, gj) float32 are the target blocks of
// each query block in ascending order of their box lower bounds; tiles (gi,)
// int32 receives the number of target blocks each query block visited.
// q_lo, q_hi and n_target are int32 scalars on the card.  block must be PB.
extern "C" int nearest_sq_pruned(const void* q, const void* t, const void* order,
                                 const void* dsort, void* out, void* tiles, int Kq, int Kt,
                                 int gj, const void* lo, const void* hi, const void* nt,
                                 int block, void* stream) {
  if (block != PB) return (int)cudaErrorInvalidValue;
  if (Kq <= 0) return 0;
  nearest_sq_pruned_kernel<<<(Kq + PB - 1) / PB, PB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(t), static_cast<const int*>(order),
      static_cast<const float*>(dsort), static_cast<float*>(out), static_cast<int*>(tiles), Kq,
      Kt, gj, static_cast<const int*>(lo), static_cast<const int*>(hi),
      static_cast<const int*>(nt));
  return (int)cudaGetLastError();
}
