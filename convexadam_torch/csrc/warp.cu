// Trilinear sampling kernels: the inverse-consistency sampler, its
// coordinate gradient, and the fused data term of the Adam loop.
//
// sample_trilinear replaces the TPU kernel convexadam_tpu/ops/warp_pallas.py:
// corner_reduce_fwd -> _fwd_kernel.  It is grid_sample (trilinear, zeros
// padding, align_corners=False) with normalized coordinates in array order:
// out[b, c, n] = sum over the 8 corners of vol[b, c, corner] * weight, for a
// float32 or bfloat16 volume (read as stored, summed in float32).
// Bound on the H100: launches.  Inverse consistency samples 2 x 3 channels
// at 2 x 32^3 points, 2.4 MB of traffic or under 1 us at 3.35 TB/s, far
// below a launch.  Design: one thread per (b, n) sample point computes the
// floor, fractions and zeros-padding masks once and gathers the 8 corners
// of every channel straight from the (B, C, H, W, D) volume; the corners
// are added in the JAX package's order (dx, dy, dz nested).  The TPU kernel
// took a pre-gathered (8C, N) block that batched 6 channels at 2N points and
// threw half away; here each direction samples only its own 3 channels.
//
// sample_trilinear_bwd replaces the TPU kernel convexadam_tpu/ops/
// warp_pallas.py: corner_reduce_bwd -> _bwd_kernel, the coordinate half of
// the sampler's vector-Jacobian product: for a cotangent ct (B, C, N) it
// writes rows[b, a, n] = sum_c ct[b, c, n] * scale * d sample[b, c, n] /
// d position_a, the derivative with respect to the voxel position on axis
// a (the caller chains it through the unnormalization, size / 2).  Bound on
// the H100: bytes.  At the semantic Adam grid, 14 channels x 96 x 80 x 128
// in bfloat16, it must read the volume (27.5 MB), the cotangent (55.1 MB)
// and the grid (11.8 MB) and write the rows (11.8 MB): about 106 MB or
// 32 us at 3.35 TB/s.  Design: as warp_ssd_loss_grad, one thread per point
// computes the 8 derivative weights once and gathers the 8 corners of every
// channel straight from the volume (no corner stack); per channel it forms
// the three directional derivatives from the same 8 loads and adds
// ct * scale times them to three float32 accumulators, channel by channel
// in a fixed order, so the result is deterministic (no atomics).
//
// warp_ssd_loss_grad replaces the TPU kernel convexadam_tpu/ops/
// warp_pallas.py: corner_reduce_loss_grad -> _fused_loss_kernel.  For every
// Adam-grid point it samples the moving features at pos = index + disp * fac,
// forms the residual against the float32 fixed features, and writes the
// point's share of sum(res^2) and the three coordinate-gradient rows scaled
// by chain = 2 cost_scale / (C N).  Bound on the H100: bytes.  At the default
// 96^3 x 12 Adam grid in bfloat16 it must read the moving features (21 MB),
// the fixed features (42 MB) and the displacement (11 MB) and write the
// rows (11 MB): about 85 MB or 25 us at 3.35 TB/s per iteration.  Design:
// one thread per point; the 8 corners x C channels are gathered straight
// from the channels-first (C, H, W, D) volume (neighbouring threads read
// neighbouring voxels of one channel, so the gathers coalesce; no corner
// stack and no channels-last copy is made).  Per channel the thread forms
// the interpolated value and its three directional derivatives from the
// same 8 loads, so each corner value is read once and nothing but the
// 6-float accumulators lives across channels.  Each CTA reduces its
// threads' sum(res^2) in a fixed tree into one partial; a second one-CTA
// kernel reduces the partials in a fixed order: deterministic, no atomics.
#include "common.cuh"

namespace {

constexpr int NT = 256;

// floor, fraction and base of one axis; fractions use the __f*_rn
// intrinsics so the plain PyTorch version rounds identically
struct Axis {
  int i0;
  float f;
};

__device__ __forceinline__ Axis split(float p) {
  const float p0 = floorf(p);
  return Axis{(int)p0, __fsub_rn(p, p0)};
}

// The 8 corners of a point: clamped linear offsets and the trilinear weight
// with the zeros-padding mask folded in (a masked corner has weight 0 and
// reads an in-range voxel).  With grads, also the derivative weights of
// the three axes: gx = sx * (wy * wz) etc., as in the JAX package.
struct Corners {
  int off[8];
  float w[8];
};

__device__ __forceinline__ void corners(const Axis& ax, const Axis& ay, const Axis& az, int H,
                                        int W, int D, Corners& cr, float* gx, float* gy,
                                        float* gz) {
  const float wx[2] = {__fsub_rn(1.f, ax.f), ax.f};
  const float wy[2] = {__fsub_rn(1.f, ay.f), ay.f};
  const float wz[2] = {__fsub_rn(1.f, az.f), az.f};
  int k = 0;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int xi = ax.i0 + dx;
    const bool vx = xi >= 0 && xi < H;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yi = ay.i0 + dy;
      const bool vy = yi >= 0 && yi < W;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int zi = az.i0 + dz;
        const bool vz = zi >= 0 && zi < D;
        const float m = (vx && vy && vz) ? 1.f : 0.f;
        cr.off[k] = (clampi(xi, 0, H - 1) * W + clampi(yi, 0, W - 1)) * D + clampi(zi, 0, D - 1);
        const float wxy = __fmul_rn(wx[dx], wy[dy]);
        cr.w[k] = __fmul_rn(__fmul_rn(wxy, wz[dz]), m);
        if (gx != nullptr) {
          const float sx = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f, sz = dz ? 1.f : -1.f;
          gx[k] = __fmul_rn(__fmul_rn(sx, __fmul_rn(wy[dy], wz[dz])), m);
          gy[k] = __fmul_rn(__fmul_rn(sy, __fmul_rn(wx[dx], wz[dz])), m);
          gz[k] = __fmul_rn(__fmul_rn(wxy, sz), m);
        }
        ++k;
      }
    }
  }
}

// grid_sample's align_corners=False unnormalization, ((g + 1) size - 1) / 2
__device__ __forceinline__ float unnormalize(float g, int size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), (float)size), 1.f), 0.5f);
}

template <typename T>
__global__ void __launch_bounds__(NT)
sample_trilinear_kernel(const T* __restrict__ vol, const float* __restrict__ grid,
                        float* __restrict__ out, int B, int C, int H, int W, int D, int N) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)B * N) return;
  const int b = (int)(t / N), n = (int)(t % N);
  const float* g = grid + t * 3;
  const Axis ax = split(unnormalize(g[0], H));
  const Axis ay = split(unnormalize(g[1], W));
  const Axis az = split(unnormalize(g[2], D));
  Corners cr;
  corners(ax, ay, az, H, W, D, cr, nullptr, nullptr, nullptr);
  const size_t hwd = (size_t)H * W * D;
  for (int c = 0; c < C; ++c) {
    const T* v = vol + ((size_t)b * C + c) * hwd;
    float acc = __fmul_rn(Io<T>::ld(v + cr.off[0]), cr.w[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(Io<T>::ld(v + cr.off[k]), cr.w[k]));
    out[((size_t)b * C + c) * N + n] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
sample_trilinear_bwd_kernel(const T* __restrict__ vol, const float* __restrict__ grid,
                            const float* __restrict__ ct, float* __restrict__ rows, int B,
                            int C, int H, int W, int D, int N, float scale) {
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= (long long)B * N) return;
  const int b = (int)(t / N), n = (int)(t % N);
  const float* g = grid + t * 3;
  const Axis ax = split(unnormalize(g[0], H));
  const Axis ay = split(unnormalize(g[1], W));
  const Axis az = split(unnormalize(g[2], D));
  Corners cr;
  float gx[8], gy[8], gz[8];
  corners(ax, ay, az, H, W, D, cr, gx, gy, gz);
  const size_t hwd = (size_t)H * W * D;
  float dx = 0.f, dy = 0.f, dz = 0.f;
  for (int c = 0; c < C; ++c) {
    const size_t bc = (size_t)b * C + c;
    const T* v = vol + bc * hwd;
    float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float val = Io<T>::ld(v + cr.off[k]);
      sx = __fadd_rn(sx, __fmul_rn(val, gx[k]));
      sy = __fadd_rn(sy, __fmul_rn(val, gy[k]));
      sz = __fadd_rn(sz, __fmul_rn(val, gz[k]));
    }
    const float cs = __fmul_rn(ct[bc * N + n], scale);
    dx = __fadd_rn(dx, __fmul_rn(cs, sx));
    dy = __fadd_rn(dy, __fmul_rn(cs, sy));
    dz = __fadd_rn(dz, __fmul_rn(cs, sz));
  }
  float* r = rows + (size_t)b * 3 * N;
  r[n] = dx;
  r[N + n] = dy;
  r[2 * N + n] = dz;
}

// fixed-order reduction of one value per thread over a CTA of NT threads
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  float s = 0.f;
  if (wid == 0) {
    s = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  }
  return s;  // valid in thread 0
}

template <typename T>
__global__ void __launch_bounds__(NT)
warp_ssd_kernel(const T* __restrict__ mov, const float* __restrict__ disp,
                const float* __restrict__ fix, float* __restrict__ rows,
                float* __restrict__ partials, int C, int H, int W, int D, float fac0,
                float fac1, float fac2, float chain) {
  __shared__ float warp_sums[NT / 32];
  const int N = H * W * D;
  const int n = blockIdx.x * NT + threadIdx.x;
  float ssq = 0.f;
  if (n < N) {
    const int i = n / (W * D), j = (n / D) % W, l = n % D;
    const Axis ax = split(__fadd_rn((float)i, __fmul_rn(disp[n], fac0)));
    const Axis ay = split(__fadd_rn((float)j, __fmul_rn(disp[N + n], fac1)));
    const Axis az = split(__fadd_rn((float)l, __fmul_rn(disp[2 * N + n], fac2)));
    Corners cr;
    float gx[8], gy[8], gz[8];
    corners(ax, ay, az, H, W, D, cr, gx, gy, gz);
    float dx = 0.f, dy = 0.f, dz = 0.f;
    for (int c = 0; c < C; ++c) {
      const T* v = mov + (size_t)c * N;
      float s = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float val = Io<T>::ld(v + cr.off[k]);
        s = __fadd_rn(s, __fmul_rn(val, cr.w[k]));
        sx = __fadd_rn(sx, __fmul_rn(val, gx[k]));
        sy = __fadd_rn(sy, __fmul_rn(val, gy[k]));
        sz = __fadd_rn(sz, __fmul_rn(val, gz[k]));
      }
      const float res = __fsub_rn(s, fix[(size_t)c * N + n]);
      ssq = __fadd_rn(ssq, __fmul_rn(res, res));
      const float ct = __fmul_rn(res, chain);
      dx = __fadd_rn(dx, __fmul_rn(ct, sx));
      dy = __fadd_rn(dy, __fmul_rn(ct, sy));
      dz = __fadd_rn(dz, __fmul_rn(ct, sz));
    }
    rows[n] = dx;
    rows[N + n] = dy;
    rows[2 * N + n] = dz;
  }
  const float s = block_sum(ssq, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

constexpr int NR = 1024;

__global__ void __launch_bounds__(NR)
sum_partials_kernel(const float* __restrict__ partials, int n, float* __restrict__ total) {
  __shared__ float warp_sums[NR / 32];
  float v = 0.f;
  for (int p = threadIdx.x; p < n; p += NR) v = __fadd_rn(v, partials[p]);
  const float s = block_sum(v, warp_sums);
  if (threadIdx.x == 0) total[0] = s;
}

template <typename T>
int launch_ssd(const void* mov, const void* disp, const void* fix, void* rows, void* partials,
               void* total, int C, int H, int W, int D, float fac0, float fac1, float fac2,
               float chain, cudaStream_t stream) {
  const int N = H * W * D;
  const int blocks = (N + NT - 1) / NT;
  warp_ssd_kernel<T><<<blocks, NT, 0, stream>>>(
      static_cast<const T*>(mov), static_cast<const float*>(disp),
      static_cast<const float*>(fix), static_cast<float*>(rows), static_cast<float*>(partials),
      C, H, W, D, fac0, fac1, fac2, chain);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, NR, 0, stream>>>(static_cast<const float*>(partials), blocks,
                                           static_cast<float*>(total));
  return (int)cudaGetLastError();
}

}  // namespace

// Number of per-CTA partials warp_ssd_loss_grad writes for N points.
extern "C" int warp_ssd_num_partials(int N) { return (N + NT - 1) / NT; }

// vol (B, C, H, W, D) float32 (bf16 == 0) or bfloat16 (bf16 == 1); grid
// (B, N, 3) and out (B, C, N) float32.
extern "C" int sample_trilinear(const void* vol, const void* grid, void* out, int B, int C,
                                int H, int W, int D, int N, int bf16, void* stream) {
  const long long total = (long long)B * N;
  const unsigned blocks = (unsigned)((total + NT - 1) / NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  float* o = static_cast<float*>(out);
  if (bf16)
    sample_trilinear_kernel<__nv_bfloat16><<<blocks, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), g, o, B, C, H, W, D, N);
  else
    sample_trilinear_kernel<float><<<blocks, NT, 0, s>>>(static_cast<const float*>(vol), g, o,
                                                         B, C, H, W, D, N);
  return (int)cudaGetLastError();
}

// vol (B, C, H, W, D) float32 (bf16 == 0) or bfloat16 (bf16 == 1); grid
// (B, N, 3), ct (B, C, N) and rows (B, 3, N) float32.
extern "C" int sample_trilinear_bwd(const void* vol, const void* grid, const void* ct,
                                    void* rows, int B, int C, int H, int W, int D, int N,
                                    float scale, int bf16, void* stream) {
  const long long total = (long long)B * N;
  const unsigned blocks = (unsigned)((total + NT - 1) / NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  const float* c = static_cast<const float*>(ct);
  float* r = static_cast<float*>(rows);
  if (bf16)
    sample_trilinear_bwd_kernel<__nv_bfloat16><<<blocks, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), g, c, r, B, C, H, W, D, N, scale);
  else
    sample_trilinear_bwd_kernel<float><<<blocks, NT, 0, s>>>(static_cast<const float*>(vol), g,
                                                             c, r, B, C, H, W, D, N, scale);
  return (int)cudaGetLastError();
}

// mov (C, H, W, D) float32 (bf16 == 0) or bfloat16 (bf16 == 1); disp (3, H, W, D),
// fix (C, H*W*D) and rows (3, H*W*D) float32; partials holds
// warp_ssd_num_partials(H*W*D) floats and total one float.
extern "C" int warp_ssd_loss_grad(const void* mov, const void* disp, const void* fix, void* rows,
                                  void* partials, void* total, int C, int H, int W, int D,
                                  float fac0, float fac1, float fac2, float chain, int bf16,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_ssd<__nv_bfloat16>(mov, disp, fix, rows, partials, total, C, H, W, D, fac0,
                                     fac1, fac2, chain, s);
  return launch_ssd<float>(mov, disp, fix, rows, partials, total, C, H, W, D, fac0, fac1, fac2,
                           chain, s);
}
