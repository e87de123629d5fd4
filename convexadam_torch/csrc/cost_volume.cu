// Dense SSD cost volume: out[k, i, j, l] = sum_c (fix[c, i, j, l] -
// mov[c, i + kh - q, j + kw - q, l + kd - q])^2 with zeros outside the moving
// volume, k = kd * K^2 + kw * K + kh, K = 2q + 1, all in float32.
//
// Replaces the TPU kernel convexadam_tpu/ops/cost_volume_pallas.py:
// cost_volume_pallas -> _cost_kernel.
//
// Bound on the H100: bytes.  At the default setting (12 x 32^3 coarse
// features, q = 4) the kernel must write 729 x 32^3 float32 = 95.6 MB, about
// 29 us at 3.35 TB/s; its 0.86 GFLOP is half of that at the f32 rate, and the
// 1.6 MB feature volumes stay in L2.
//
// Design: one CTA per (i, 8-wide j tile, 32-wide l tile, kh), one thread per
// coarse voxel of the tile, each thread walking the K^2 (kw, kd)
// displacements of its kh.  The CTA stages the fixed tile and the moving
// slab it needs (row i + kh - q, the tile grown by q along j and l, zero
// where outside) in shared memory, so the channel loop reads only shared
// memory and accumulates in float32.  Neighbouring threads write
// neighbouring l of one displacement plane, so the output is written once,
// coalesced and directly in the reference's kd-major layout: no transpose
// pass.
#include "common.cuh"

namespace {

constexpr int TW = 8;
constexpr int TD = 32;
constexpr int NT = TW * TD;

__global__ void __launch_bounds__(NT)
cost_volume_kernel(const float* __restrict__ fix, const float* __restrict__ mov,
                   float* __restrict__ out, int C, int h, int w, int d, int q) {
  extern __shared__ float smem[];
  const int K = 2 * q + 1;
  const int SW = TW + 2 * q, SD = TD + 2 * q;
  float* slab = smem;               // C x SW x SD
  float* fx = smem + C * SW * SD;   // C x TW x TD
  const int n_td = (d + TD - 1) / TD;
  const int j0 = (blockIdx.x / n_td) * TW;
  const int l0 = (blockIdx.x % n_td) * TD;
  const int i = blockIdx.y;
  const int kh = blockIdx.z;
  const int im = i + kh - q;
  const bool row_in = im >= 0 && im < h;
  const int t = threadIdx.x;
  const size_t hwd = (size_t)h * w * d;

  for (int e = t; e < C * SW * SD; e += NT) {
    const int sd = e % SD, sw = (e / SD) % SW, c = e / (SD * SW);
    const int gj = j0 - q + sw, gl = l0 - q + sd;
    float v = 0.f;
    if (row_in && gj >= 0 && gj < w && gl >= 0 && gl < d)
      v = mov[c * hwd + ((size_t)im * w + gj) * d + gl];
    slab[e] = v;
  }
  const int lj = t / TD, ll = t % TD;
  const int gj = j0 + lj, gl = l0 + ll;
  const bool valid = gj < w && gl < d;
  for (int c = 0; c < C; ++c)
    fx[c * NT + t] = valid ? fix[c * hwd + ((size_t)i * w + gj) * d + gl] : 0.f;
  __syncthreads();
  if (!valid) return;

  const size_t plane = (size_t)K * K;
  const size_t vox = ((size_t)i * w + gj) * d + gl;
  for (int kw = 0; kw < K; ++kw) {
    for (int kd = 0; kd < K; ++kd) {
      float acc = 0.f;
      for (int c = 0; c < C; ++c) {
        const float diff = __fsub_rn(fx[c * NT + t], slab[(c * SW + lj + kw) * SD + ll + kd]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      const size_t k = (size_t)kd * plane + (size_t)kw * K + kh;
      out[k * hwd + vox] = acc;
    }
  }
}

}  // namespace

// fix, mov (C, h, w, d) and out (K^3, h, w, d) are float32.
extern "C" int cost_volume(const void* fix, const void* mov, void* out, int C, int h, int w,
                           int d, int q, void* stream) {
  const size_t smem =
      ((size_t)C * (TW + 2 * q) * (TD + 2 * q) + (size_t)C * TW * TD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cost_volume_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = ((w + TW - 1) / TW) * ((d + TD - 1) / TD);
  const dim3 grid(n_tiles, h, 2 * q + 1);
  cost_volume_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fix), static_cast<const float*>(mov), static_cast<float*>(out),
      C, h, w, d, q);
  return (int)cudaGetLastError();
}
