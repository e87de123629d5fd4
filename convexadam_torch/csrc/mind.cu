// MIND-SSC statistics: the 12 shift-pair squared differences, their
// (2r+1)^3 replicate-padded box mean, the channel-min subtraction and the
// channel-mean variance, for one volume (H, W, D).
//
// Replaces the TPU kernel convexadam_tpu/ops/mind_pallas.py:
// mind_ssd_stats_pallas -> _mind_kernel.
//
// Bound on the H100: bytes.  At 192^3 in bfloat16 the kernel must read the
// image (14 MB) and write mind (12 channels, 170 MB) and var (f32, 28 MB),
// about 212 MB or 63 us at 3.35 TB/s; its arithmetic (about 150 flops a
// voxel) is a quarter of that at the f32 rate.
//
// Design: one CTA of 256 threads per TH x TW x TD = 4 x 8 x 32 output tile
// (D innermost, so a warp writes 32 consecutive voxels).  The image halo of
// the tile, grown by r + dilation on every side and read at clamped
// coordinates, is loaded once into shared memory; the 12 channels are then
// made one after the other from it: the squared difference on the tile
// grown by r (the diff array's own replicate pad clamps its voxel before
// the shift is applied), then the separable box sums along H, W and D with
// the window offsets added in ascending order, each stage in shared memory.
// Each thread keeps its 4 voxels' 12 box means in registers for the
// channel min and the variance, so the 12-channel volume is written once
// and never read back.  Every intermediate is rounded to the storage type
// as PyTorch rounds each bf16 operation, which makes the kernel agree with
// the plain version in kernels/mind.py to the bit in f32 and bf16.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int TH = 4;
constexpr int TW = 8;
constexpr int TD = 32;
constexpr int NT = TW * TD;  // thread t owns voxels (i, t / TD, t % TD), i < TH
constexpr int NPAIR = 12;

struct PairOffsets {
  int o[NPAIR][2][3];  // voxel offsets (dilation applied) of the two shifts
};

size_t smem_floats(int r, int b) {
  const size_t HH = TH + 2 * b, HW = TW + 2 * b, HD = TD + 2 * b;
  const size_t EH = TH + 2 * r, EW = TW + 2 * r, ED = TD + 2 * r;
  return HH * HW * HD + EH * EW * ED + TH * EW * ED + TH * TW * ED;
}

template <typename T>
__global__ void __launch_bounds__(NT)
mind_kernel(const T* __restrict__ x, T* __restrict__ mind, float* __restrict__ var,
            int H, int W, int D, int r, int b, PairOffsets offs) {
  extern __shared__ float smem[];
  const int k = 2 * r + 1;
  const float k3 = (float)(k * k * k);
  const int HW_ = TW + 2 * b, HD_ = TD + 2 * b;
  const int HH_ = TH + 2 * b;
  const int EW = TW + 2 * r, ED = TD + 2 * r, EH = TH + 2 * r;
  float* halo = smem;
  float* diff = halo + HH_ * HW_ * HD_;
  float* sh = diff + EH * EW * ED;
  float* sw = sh + TH * EW * ED;

  const int h0 = blockIdx.z * TH, w0 = blockIdx.y * TW, d0 = blockIdx.x * TD;
  const int hb = h0 - b, wb = w0 - b, db = d0 - b;
  const int t = threadIdx.x;

  for (int e = t; e < HH_ * HW_ * HD_; e += NT) {
    const int ed = e % HD_, ew = (e / HD_) % HW_, eh = e / (HD_ * HW_);
    const int gh = clampi(hb + eh, 0, H - 1);
    const int gw = clampi(wb + ew, 0, W - 1);
    const int gd = clampi(db + ed, 0, D - 1);
    halo[e] = Io<T>::ld(x + ((size_t)gh * W + gw) * D + gd);
  }

  const int lw = t / TD, ld = t % TD;
  float ssd[NPAIR][TH];

#pragma unroll
  for (int c = 0; c < NPAIR; ++c) {
    __syncthreads();
    const int* o1 = offs.o[c][0];
    const int* o2 = offs.o[c][1];
    for (int e = t; e < EH * EW * ED; e += NT) {
      const int ed = e % ED, ew = (e / ED) % EW, eh = e / (ED * EW);
      const int uh = clampi(h0 - r + eh, 0, H - 1);
      const int uw = clampi(w0 - r + ew, 0, W - 1);
      const int ud = clampi(d0 - r + ed, 0, D - 1);
      const int ah = clampi(uh + o1[0], 0, H - 1) - hb;
      const int aw = clampi(uw + o1[1], 0, W - 1) - wb;
      const int ad = clampi(ud + o1[2], 0, D - 1) - db;
      const int bh = clampi(uh + o2[0], 0, H - 1) - hb;
      const int bw = clampi(uw + o2[1], 0, W - 1) - wb;
      const int bd = clampi(ud + o2[2], 0, D - 1) - db;
      const float dv = Io<T>::rnd(__fsub_rn(halo[(ah * HW_ + aw) * HD_ + ad],
                                            halo[(bh * HW_ + bw) * HD_ + bd]));
      diff[e] = Io<T>::rnd(__fmul_rn(dv, dv));
    }
    __syncthreads();
    for (int e = t; e < TH * EW * ED; e += NT) {
      const int ed = e % ED, ew = (e / ED) % EW, eh = e / (ED * EW);
      float acc = diff[(eh * EW + ew) * ED + ed];
      for (int j = 1; j < k; ++j)
        acc = Io<T>::rnd(__fadd_rn(acc, diff[((eh + j) * EW + ew) * ED + ed]));
      sh[e] = acc;
    }
    __syncthreads();
    for (int e = t; e < TH * TW * ED; e += NT) {
      const int ed = e % ED, ew = (e / ED) % TW, eh = e / (ED * TW);
      float acc = sh[(eh * EW + ew) * ED + ed];
      for (int j = 1; j < k; ++j)
        acc = Io<T>::rnd(__fadd_rn(acc, sh[(eh * EW + ew + j) * ED + ed]));
      sw[e] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      const float* row = sw + (i * TW + lw) * ED + ld;
      float acc = row[0];
      for (int j = 1; j < k; ++j) acc = Io<T>::rnd(__fadd_rn(acc, row[j]));
      ssd[c][i] = Io<T>::rnd(__fdiv_rn(acc, k3));
    }
  }

  const size_t hwd = (size_t)H * W * D;
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int gh = h0 + i, gw = w0 + lw, gd = d0 + ld;
    if (gh < H && gw < W && gd < D) {
      const size_t idx = ((size_t)gh * W + gw) * D + gd;
      float m = ssd[0][i];
#pragma unroll
      for (int c = 1; c < NPAIR; ++c) m = fminf(m, ssd[c][i]);
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < NPAIR; ++c) {
        const float mc = Io<T>::rnd(__fsub_rn(ssd[c][i], m));
        Io<T>::st(mind + c * hwd + idx, mc);
        v = c == 0 ? mc : __fadd_rn(v, mc);
      }
      var[idx] = __fdiv_rn(v, (float)NPAIR);
    }
  }
}

template <typename T>
int launch(const void* x, void* mind, void* var, int H, int W, int D, int r, int dil,
           const void* offs_host, cudaStream_t stream) {
  PairOffsets offs;
  memcpy(&offs, offs_host, sizeof(offs));
  const int b = r + dil;
  const size_t smem = smem_floats(r, b) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mind_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + TD - 1) / TD, (W + TW - 1) / TW, (H + TH - 1) / TH);
  mind_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(mind), static_cast<float*>(var),
      H, W, D, r, b, offs);
  return (int)cudaGetLastError();
}

}  // namespace

// x (H, W, D) and mind (12, H, W, D) are float32 (bf16 == 0) or bfloat16
// (bf16 == 1); var (H, W, D) is float32.  offs holds 12 x 2 x 3 ints.
extern "C" int mind_ssd_stats(const void* x, void* mind, void* var, int H, int W, int D,
                              int r, int dil, int bf16, const void* offs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, mind, var, H, W, D, r, dil, offs, s);
  return launch<float>(x, mind, var, H, W, D, r, dil, offs, s);
}
