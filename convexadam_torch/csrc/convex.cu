// The convex stage's coupled argmin: convexadam_torch/kernels/convex.py.
//
// Replaces no Pallas kernel: the JAX package's coupled argmin
// (convexadam_tpu/core/convex.py: coupled_convex, correlate_coupled_streamed,
// convex_displacement_tp) is left to XLA.  The port's plain PyTorch form
// wrote every intermediate of costs + c*((sq0 + sq1) + sq2) to device
// memory, about 84 bytes a (candidate, voxel) where the costs' 4 are needed;
// this kernel reads each cost once and keeps the rest in registers.
//
// What it computes (coupled_argmin_fold): for voxel v < n and candidate
// j < k,
//   val = costs[j][v] + c * ((sq0 + sq1) + sq2),  sq_i = (mesh[i][j] - s[i][v])^2,
// each operation rounded in float32 on its own (__f*_rn, which nvcc never
// contracts into a fused multiply-add), and folds the first minimum into the
// running (best[v], bidx[v]): (val, idx[j]) replaces it when it comes first
// in torch.argmin's order, a NaN before any number, then the smaller value,
// then the smaller index.  idx increases with j (the dense path's 0..k-1, a
// streamed block's kh + K*i, a tensor-parallel rank's slice), so the first
// minimum in j is the one of smallest index, and the result is argmin's over
// every candidate whatever order the blocks come in.
//
// Bound: k * n * 4 bytes of costs read (plus 20 bytes a voxel for s, best
// and bidx), at 3.35 TB/s.  About 10 rounded operations and a compare a
// (candidate, voxel), so the 33.5 T unfused float32 op/s stay under the
// memory's pace.
//
// Design: a thread owns VEC neighbouring voxels (VEC = 4 takes 16-byte
// loads, where the costs' pointer and row stride allow; the ragged edge is
// masked) and walks the candidates UNROLL rows at a time, so that several
// rows' loads are in flight; a warp's loads of one row are contiguous, and
// its mesh loads are uniform (one broadcast).  s, best and bidx are read
// once and best and bidx written once a voxel.  Where the voxels give too
// few warps to fill the card (a small grid, a rank's slice), a block's
// warps split the candidates into `splits` contiguous ranges and combine
// their (value, position) in shared memory in the same order, so the
// answer does not depend on the split.  The launch shape comes from (n, k)
// and the alignment (kernels/convex.py:launch_plan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block
constexpr int NWARPS = NT / 32;
constexpr int UNROLL = 4;  // candidate rows in flight a thread

// torch.argmin's order of (value, index): a NaN first (the smaller index
// among NaNs), then the smaller value, then the smaller index
__device__ __forceinline__ bool before(float v, long long i, float b, long long bi) {
  const bool vn = v != v, bn = b != b;
  if (vn || bn) return vn && (!bn || i < bi);
  return v < b || (v == b && i < bi);
}

// one candidate of one voxel into the thread's running first minimum (b, p)
// over increasing positions: a smaller value, or a NaN where none is held
__device__ __forceinline__ void step(float x, float m0, float m1, float m2, float s0, float s1,
                                     float s2, float c, int j, float& b, int& p) {
  const float d0 = __fsub_rn(m0, s0), d1 = __fsub_rn(m1, s1), d2 = __fsub_rn(m2, s2);
  const float t = __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2));
  const float val = __fadd_rn(x, __fmul_rn(c, t));
  if (!(val >= b) && b == b) {
    b = val;
    p = j;
  }
}

// the thread's VEC costs of one candidate row; lanes past n read nothing
template <int VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row, long long v0, int n,
                                         bool full, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    if (full) {
      const float4 t = *reinterpret_cast<const float4*>(row + v0);
      x[0] = t.x;
      x[1] = t.y;
      x[2] = t.z;
      x[3] = t.w;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) x[e] = v0 + e < n ? row[v0 + e] : 0.f;
}

template <int VEC>
__global__ void __launch_bounds__(NT) coupled_argmin_fold_kernel(
    const float* __restrict__ costs, long long ld, const float* __restrict__ mesh,
    const long long* __restrict__ idx, const float* __restrict__ s, float c,
    float* __restrict__ best, long long* __restrict__ bidx, int k, int n, int splits) {
  __shared__ float sval[NWARPS][32 * VEC];
  __shared__ int spos[NWARPS][32 * VEC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = warp % splits;
  const long long v0 =
      ((long long)blockIdx.x * (NWARPS / splits) + warp / splits) * (32 * VEC) + lane * VEC;
  const int chunk = (k + splits - 1) / splits;
  const int j0 = min(split * chunk, k), j1 = min(j0 + chunk, k);
  const bool full = v0 + VEC <= n;
  const float inf = __uint_as_float(0x7f800000u);
  float s0[VEC], s1[VEC], s2[VEC], b[VEC];
  int p[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const bool in = v0 + e < n;
    s0[e] = in ? s[v0 + e] : 0.f;
    s1[e] = in ? s[n + v0 + e] : 0.f;
    s2[e] = in ? s[2LL * n + v0 + e] : 0.f;
    b[e] = inf;  // with p = j0: (inf, j0) is candidate j0's own pair where its value is inf
    p[e] = j0;
  }
  int j = j0;
  for (; j + UNROLL <= j1; j += UNROLL) {
    float x[UNROLL][VEC], m0[UNROLL], m1[UNROLL], m2[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      load_row<VEC>(costs + (long long)(j + u) * ld, v0, n, full, x[u]);
      m0[u] = mesh[j + u];
      m1[u] = mesh[k + j + u];
      m2[u] = mesh[2 * k + j + u];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        step(x[u][e], m0[u], m1[u], m2[u], s0[e], s1[e], s2[e], c, j + u, b[e], p[e]);
  }
  for (; j < j1; ++j) {
    float x[VEC];
    load_row<VEC>(costs + (long long)j * ld, v0, n, full, x);
    const float m0 = mesh[j], m1 = mesh[k + j], m2 = mesh[2 * k + j];
#pragma unroll
    for (int e = 0; e < VEC; ++e) step(x[e], m0, m1, m2, s0[e], s1[e], s2[e], c, j, b[e], p[e]);
  }
  if (splits > 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sval[warp][lane * VEC + e] = b[e];
      spos[warp][lane * VEC + e] = p[e];
    }
    __syncthreads();
    if (split != 0) return;
    // the later ranges in order; a range past k holds no candidate
    for (int t = 1; t < splits && t * chunk < k; ++t)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ov = sval[warp + t][lane * VEC + e];
        const int op = spos[warp + t][lane * VEC + e];
        if (before(ov, op, b[e], p[e])) {
          b[e] = ov;
          p[e] = op;
        }
      }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const long long v = v0 + e;
    if (v >= n) continue;
    const long long gi = idx[p[e]];
    if (before(b[e], gi, best[v], bidx[v])) {
      best[v] = b[e];
      bidx[v] = gi;
    }
  }
}

}  // namespace

// costs: (k, n) float32 rows of stride ld (elements), each row contiguous;
// mesh (3, k) float32 and s (3, n) float32 contiguous; idx (k,) int64;
// best (n,) float32 and bidx (n,) int64, read and written.  vec is 1 or 4
// (4 only with a 16-byte aligned costs pointer and ld % 4 == 0), splits 1,
// 2, 4 or 8.  k and n at least 1.
extern "C" int coupled_argmin_fold(const void* costs, long long ld, const void* mesh,
                                   const void* idx, const void* s, float c, void* best,
                                   void* bidx, int k, int n, int vec, int splits,
                                   void* stream) {
  if (k < 1 || n < 1 || (vec != 1 && vec != 4) ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8))
    return cudaErrorInvalidValue;
  const long long warps = (n + 32LL * vec - 1) / (32LL * vec);
  const int per_block = NWARPS / splits;
  const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
  const float* cp = static_cast<const float*>(costs);
  const float* mp = static_cast<const float*>(mesh);
  const long long* ip = static_cast<const long long*>(idx);
  const float* sp = static_cast<const float*>(s);
  float* bp = static_cast<float*>(best);
  long long* xp = static_cast<long long*>(bidx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    coupled_argmin_fold_kernel<4><<<blocks, NT, 0, st>>>(cp, ld, mp, ip, sp, c, bp, xp, k, n,
                                                         splits);
  else
    coupled_argmin_fold_kernel<1><<<blocks, NT, 0, st>>>(cp, ld, mp, ip, sp, c, bp, xp, k, n,
                                                         splits);
  return cudaGetLastError();
}
