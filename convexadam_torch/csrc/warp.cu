// Trilinear sampling kernels: the sampler, the inverse-consistency steps,
// the sampler's coordinate gradient, and the fused data term of the Adam
// loop.
//
// sample_trilinear replaces the TPU kernel convexadam_tpu/ops/warp_pallas.py:
// corner_reduce_fwd -> _fwd_kernel.  It is grid_sample (trilinear, zeros
// padding, align_corners=False) with normalized coordinates in array order:
// out[b, c, n] = sum over the 8 corners of vol[b, c, corner] * weight, for a
// float32 or bfloat16 volume (read as stored, summed in float32).  Its one
// caller is the differentiable warp's forward (14 channels at the 96 x 80 x
// 128 semantic Adam grid in bfloat16: the volume, 27.5 MB, and the grid,
// 11.8 MB, read once, the samples, 55 MB, written once, 28 us at 3.35 TB/s:
// bound by bytes).  What holds it back in practice is the latency of its
// gathers, 8 a point and channel (112 at 14 channels), which hit L2: the
// volume fits there, and a float32 volume, twice the bytes, takes about the
// same time.  Design, that of sample_trilinear_bwd: one thread per point
// (blockIdx.y the volume, so no 64-bit division) computes the floor,
// fractions and zeros-padding masks once and keeps the 8 corner offsets and
// 8 weights in registers; the channel loop is unrolled by 4, so 32 gathers
// are in flight a thread, at 64 registers and 4 CTAs of 256 an SM, without
// spills.  The first design walked one channel at a time at 48 registers,
// with 16-20 bytes of spills, and so had 8 gathers in flight.  Measured on
// the H100 at the semantic Adam grid: unrolling by 2, dropping the 4-CTA
// register cap (48 registers), unrolling by 8 at 3 CTAs (80), splitting a
// point's channels over 2 or 4 threads and streaming stores were all as
// fast or slower.  The corners are added in the JAX package's order (dx, dy,
// dz nested).
//
// inverse_consistency_steps also replaces corner_reduce_fwd, in its other
// role: the 15 Jacobi steps of inverse consistency, d1 = (d1 - d2 o (id +
// d1)) / 2 and d2 = (d2 - d1 o (id + d2)) / 2, on the 2 x 3 x 32^3 coarse
// fields.  Bound on the H100: launches.  One step moves 1.6 MB, under 1 us
// at 3.35 TB/s, far below what the host spends issuing it, so one C call
// runs all steps back to back on the stream, swapping two buffers, and each
// step is one ic_step_kernel launch: one thread per (direction, point) adds
// the identity to its field, samples the other field's 3 channels and writes
// its update.  The operations and their order are those of the composition
// it replaces (grid add, sample_trilinear, subtract, halve), so the result
// is the same to the bit.  The TPU kernel took a pre-gathered (8C, N) block
// that batched 6 channels at 2N points and threw half away; here each
// direction samples only its own 3 channels.
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
// 32 us at 3.35 TB/s.  Design, in the TPU kernel's order: one thread per
// point gathers the 8 corners of every channel straight from the volume (no
// corner stack) and reduces the channels first, cv_k = sum_c ct_c * scale *
// v_{k,c}, one multiply-add per corner and channel into 8 float32
// accumulators (channel by channel in a fixed order: deterministic, no
// atomics); only then does it form the 24 derivative weights and the three
// rows sum_k g_{a,k} cv_k.  Nothing but the 8 accumulators and 8 offsets
// lives across the channel loop, which keeps the kernel at 64 registers (4
// CTAs of 256 an SM) with four channels' gathers in flight: on the H100
// that beat unrolling by 1 or 2, and more CTAs an SM spilled.
//
// warp_ssd_loss_grad replaces the TPU kernel convexadam_tpu/ops/
// warp_pallas.py: corner_reduce_loss_grad -> _fused_loss_kernel.  For every
// Adam-grid point it samples the moving features at pos = index + disp * fac,
// forms the residual against the float32 fixed features, and writes the
// point's share of sum(res^2) and the three coordinate-gradient rows scaled
// by chain = 2 cost_scale / (C N).  Bound on the H100: bytes.  At the default
// 96^3 x 12 Adam grid in bfloat16 it must read the moving features (21 MB),
// the fixed features (42 MB) and the displacement (11 MB) and write the
// rows (11 MB): about 85 MB or 25 us at 3.35 TB/s per iteration.  Design, in
// the TPU kernel's order: one thread per point gathers the 8 corners of
// every channel straight from the channels-first (C, H, W, D) volume
// (neighbouring threads read neighbouring voxels of one channel, so the
// gathers coalesce; no corner stack and no channels-last copy is made).  Per
// channel it forms the sample s = sum_k w_k v_k, the residual against the
// fixed feature (read once, streamed past the caches the gathers use), its
// square into the point's sum, and ct = res * chain, and adds ct * v_k into
// one accumulator per corner, cv_k; only after the channel loop does it
// form the 24 derivative weights and the three rows sum_k g_{a,k} cv_k, as
// sample_trilinear_bwd does.  So a channel costs 8 multiply-adds for the
// sample and 8 for the gradient (32 each in the order of value and three
// derivatives per channel), and only the 8 accumulators and the sum live in
// registers across channels; the 8 offsets and 8 weights wait in shared
// memory.  The kernel is bound by the latency of its gathers, 8 a point and
// channel: at 64 registers four CTAs of 256 an SM hide more of it than
// three at 80 with the offsets and weights in registers, and unrolling the
// channel loop did not help (measured on the H100 at the Adam grids).  Each
// CTA reduces its threads' sum(res^2) in a fixed tree into one partial; a
// second one-CTA kernel reduces the partials in a fixed order:
// deterministic, no atomics.
//
// The strided form (convexadam_tpu/core/warp.py:_stacked_mse_pos with
// stride s) takes its points on the (::s, ::s, ::s) sub-lattice of the Adam
// grid: disp and fix hold the hs x ws x ds sub-lattice's values (hs =
// ceil(H / s), ...), point (i, j, l) samples the whole moving volume at s i
// + disp * fac (fac from the full H, W, D), and the rows come out for the
// sub-lattice's points only.  It is the same kernel with the point's index
// scaled: s^3 fewer points, so s^3 fewer gathers, the Adam loop's floor.
//
// A launch may take only the lattice rows row0 .. row0 + hs - 1 of a grid
// split along H (a rank's slab, parallel/spatial.py): disp and fix hold
// those rows, point (i, j, l) samples the whole moving volume at s (row0 +
// i) + disp * fac, and the rows come out for those points.  Only the
// point's first coordinate depends on row0, so row0 = 0 over the whole
// lattice is the launch it was.
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

// The 8 corners' offsets: the lower corner's clamped linear index plus one
// step per axis, 0 where the clamp folds the two corners of that axis
// together, so a masked corner reads an in-range voxel (its weights carry
// the mask).
template <int OS = 1>  // off[k] at off[k * OS]
__device__ __forceinline__ void corner_offsets(const Axis& ax, const Axis& ay, const Axis& az,
                                               int H, int W, int D, int* off) {
  const int x0 = clampi(ax.i0, 0, H - 1), y0 = clampi(ay.i0, 0, W - 1), z0 = clampi(az.i0, 0, D - 1);
  const int sx = (clampi(ax.i0 + 1, 0, H - 1) - x0) * W * D;
  const int sy = (clampi(ay.i0 + 1, 0, W - 1) - y0) * D;
  const int sz = clampi(az.i0 + 1, 0, D - 1) - z0;
  const int base = (x0 * W + y0) * D + z0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    off[k * OS] = base + ((k & 4) ? sx : 0) + ((k & 2) ? sy : 0) + ((k & 1) ? sz : 0);
}

// The 8 corners' trilinear weights ((wx * wy) * wz) * mask in corner order
// (dx, dy, dz nested): a corner outside the volume has weight 0 and reads an
// in-range voxel (corner_offsets).
template <int OS = 1>  // w[k] at w[k * OS]
__device__ __forceinline__ void corner_weights(const Axis& ax, const Axis& ay, const Axis& az,
                                               int H, int W, int D, float* w) {
  const float wx[2] = {__fsub_rn(1.f, ax.f), ax.f};
  const float wy[2] = {__fsub_rn(1.f, ay.f), ay.f};
  const float wz[2] = {__fsub_rn(1.f, az.f), az.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const int xi = ax.i0 + dx, yi = ay.i0 + dy, zi = az.i0 + dz;
    const bool in = xi >= 0 && xi < H && yi >= 0 && yi < W && zi >= 0 && zi < D;
    w[k * OS] = __fmul_rn(__fmul_rn(__fmul_rn(wx[dx], wy[dy]), wz[dz]), in ? 1.f : 0.f);
  }
}

// grid_sample's align_corners=False unnormalization, ((g + 1) size - 1) / 2
__device__ __forceinline__ float unnormalize(float g, int size) {
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.f), (float)size), 1.f), 0.5f);
}

// One Jacobi step of inverse consistency: thread t < N is direction 0
// (field d1 of src, sampling d2) and t >= N direction 1; it writes its
// field's 3 channels at its point into dst.  The identity is given per
// axis, as the caller's PyTorch computes it.
__global__ void __launch_bounds__(NT)
ic_step_kernel(const float* __restrict__ src, float* __restrict__ dst,
               const float* __restrict__ id_h, const float* __restrict__ id_w,
               const float* __restrict__ id_d, int H, int W, int D) {
  const int N = H * W * D;
  const long long t = (long long)blockIdx.x * NT + threadIdx.x;
  if (t >= 2LL * N) return;
  const int b = (int)(t / N), n = (int)(t % N);
  const int i = n / (W * D), j = (n / D) % W, l = n % D;
  const float* d = src + (size_t)b * 3 * N;
  const float* other = src + (size_t)(1 - b) * 3 * N;
  const float dv[3] = {d[n], d[N + n], d[2 * N + n]};
  const Axis ax = split(unnormalize(__fadd_rn(id_h[i], dv[0]), H));
  const Axis ay = split(unnormalize(__fadd_rn(id_w[j], dv[1]), W));
  const Axis az = split(unnormalize(__fadd_rn(id_d[l], dv[2]), D));
  int off[8];
  float wt[8];
  corner_offsets(ax, ay, az, H, W, D, off);
  corner_weights(ax, ay, az, H, W, D, wt);
  float* o = dst + (size_t)b * 3 * N;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* v = other + (size_t)c * N;
    float acc = __fmul_rn(v[off[0]], wt[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(v[off[k]], wt[k]));
    o[(size_t)c * N + n] = __fmul_rn(0.5f, __fsub_rn(dv[c], acc));
  }
}

// The coordinate-gradient rows of a point from its per-corner channel sums
// cv: sum_k g_{a,k} cv_k, with the derivative weights gx = (sx * (wy * wz))
// * mask, gy = (sy * (wx * wz)) * mask, gz = ((wx * wy) * sz) * mask (the JAX
// package's) formed once per corner; written to r[0], r[stride] and
// r[2 stride].
__device__ __forceinline__ void rows_from_cv(const Axis& ax, const Axis& ay, const Axis& az,
                                             int H, int W, int D, const float cv[8], float* r,
                                             int stride) {
  const float wx[2] = {__fsub_rn(1.f, ax.f), ax.f};
  const float wy[2] = {__fsub_rn(1.f, ay.f), ay.f};
  const float wz[2] = {__fsub_rn(1.f, az.f), az.f};
  float rx = 0.f, ry = 0.f, rz = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const int xi = ax.i0 + dx, yi = ay.i0 + dy, zi = az.i0 + dz;
    const bool in = xi >= 0 && xi < H && yi >= 0 && yi < W && zi >= 0 && zi < D;
    const float m = in ? 1.f : 0.f;
    const float sgx = dx ? 1.f : -1.f, sgy = dy ? 1.f : -1.f, sgz = dz ? 1.f : -1.f;
    const float gx = __fmul_rn(__fmul_rn(sgx, __fmul_rn(wy[dy], wz[dz])), m);
    const float gy = __fmul_rn(__fmul_rn(sgy, __fmul_rn(wx[dx], wz[dz])), m);
    const float gz = __fmul_rn(__fmul_rn(__fmul_rn(wx[dx], wy[dy]), sgz), m);
    const float tx = __fmul_rn(cv[k], gx), ty = __fmul_rn(cv[k], gy), tz = __fmul_rn(cv[k], gz);
    rx = k ? __fadd_rn(rx, tx) : tx;
    ry = k ? __fadd_rn(ry, ty) : ty;
    rz = k ? __fadd_rn(rz, tz) : tz;
  }
  r[0] = rx;
  r[stride] = ry;
  r[2 * stride] = rz;
}

template <typename T>
__global__ void __launch_bounds__(NT, 4)
sample_trilinear_kernel(const T* __restrict__ vol, const float* __restrict__ grid,
                        float* __restrict__ out, int C, int H, int W, int D, int N) {
  const int n = blockIdx.x * NT + threadIdx.x, b = blockIdx.y;
  if (n >= N) return;
  const float* g = grid + ((size_t)b * N + n) * 3;
  const Axis ax = split(unnormalize(g[0], H));
  const Axis ay = split(unnormalize(g[1], W));
  const Axis az = split(unnormalize(g[2], D));
  int off[8];
  float wt[8];
  corner_offsets(ax, ay, az, H, W, D, off);
  corner_weights(ax, ay, az, H, W, D, wt);
  const size_t hwd = (size_t)H * W * D;
  const T* v = vol + (size_t)b * C * hwd;
  float* o = out + (size_t)b * C * N + n;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const T* vc = v + (size_t)c * hwd;
    float acc = __fmul_rn(Io<T>::ld(vc + off[0]), wt[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(Io<T>::ld(vc + off[k]), wt[k]));
    o[(size_t)c * N] = acc;
  }
}

// Channels first, then corners (the TPU kernel's order).
template <typename T>
__global__ void __launch_bounds__(NT, 4)
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
  int off[8];
  corner_offsets(ax, ay, az, H, W, D, off);
  const size_t hwd = (size_t)H * W * D;
  const T* v = vol + (size_t)b * C * hwd;
  const float* cb = ct + (size_t)b * C * N + n;
  float cv[8];
  // the cotangent is read once: streamed past the caches the gathers use
  const float cs0 = __fmul_rn(__ldcs(cb), scale);
#pragma unroll
  for (int k = 0; k < 8; ++k) cv[k] = __fmul_rn(cs0, Io<T>::ld(v + off[k]));
#pragma unroll 4
  for (int c = 1; c < C; ++c) {
    const T* vc = v + (size_t)c * hwd;
    const float cs = __fmul_rn(__ldcs(cb + (size_t)c * N), scale);
#pragma unroll
    for (int k = 0; k < 8; ++k) cv[k] = __fadd_rn(cv[k], __fmul_rn(cs, Io<T>::ld(vc + off[k])));
  }
  float* r = rows + (size_t)b * 3 * N;
  rows_from_cv(ax, ay, az, H, W, D, cv, r + n, N);
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

// One channel of the data term at a point: the sample s = sum_k w_k v_k, the
// residual against the fixed feature f, its square into ssq, and ct * v_k
// into the corner sums cv (set instead of added for the first channel).
// Offset and weight k are off[k * NT] and w[k * NT], the thread's slots in
// shared memory.
template <typename T, bool FIRST>
__device__ __forceinline__ void ssd_channel(const T* v, const int* off, const float* w,
                                            float f, float chain, float cv[8], float& ssq) {
  float val[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) val[k] = Io<T>::ld(v + off[k * NT]);
  float s = __fmul_rn(val[0], w[0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) s = __fadd_rn(s, __fmul_rn(val[k], w[k * NT]));
  const float res = __fsub_rn(s, f);
  const float sq = __fmul_rn(res, res);
  ssq = FIRST ? sq : __fadd_rn(ssq, sq);
  const float ct = __fmul_rn(res, chain);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    cv[k] = FIRST ? __fmul_rn(ct, val[k]) : __fadd_rn(cv[k], __fmul_rn(ct, val[k]));
}

// The sample position's floor and fraction per axis, stride * index + disp
// * fac, of point n of an (hs, ws, ds) lattice of N points whose first row
// is the lattice's row0.
__device__ __forceinline__ void ssd_axes(const float* __restrict__ disp, int n, int N, int ws,
                                         int ds, int stride, int row0, float fac0, float fac1,
                                         float fac2, Axis& ax, Axis& ay, Axis& az) {
  const int i = row0 + n / (ws * ds), j = (n / ds) % ws, l = n % ds;
  ax = split(__fadd_rn((float)(stride * i), __fmul_rn(disp[n], fac0)));
  ay = split(__fadd_rn((float)(stride * j), __fmul_rn(disp[N + n], fac1)));
  az = split(__fadd_rn((float)(stride * l), __fmul_rn(disp[2 * N + n], fac2)));
}

template <typename T>
__global__ void __launch_bounds__(NT, 4)
warp_ssd_kernel(const T* __restrict__ mov, const float* __restrict__ disp,
                const float* __restrict__ fix, float* __restrict__ rows,
                float* __restrict__ partials, int C, int H, int W, int D, int stride, int row0,
                int ws, int ds, int N, float fac0, float fac1, float fac2, float chain) {
  __shared__ float warp_sums[NT / 32];
  // the point's 8 corner offsets and weights, read once a channel from
  // shared memory rather than held in registers: 64 registers, so four CTAs
  // an SM hide more of the gathers' latency
  __shared__ int osm[8 * NT];
  __shared__ float wsm[8 * NT];
  int* off = osm + threadIdx.x;  // corner k at [k * NT]
  float* w = wsm + threadIdx.x;
  const int NV = H * W * D;  // a channel of the moving volume; N points
  const int n = blockIdx.x * NT + threadIdx.x;
  float ssq = 0.f;
  if (n < N) {
    {
      Axis ax, ay, az;
      ssd_axes(disp, n, N, ws, ds, stride, row0, fac0, fac1, fac2, ax, ay, az);
      corner_offsets<NT>(ax, ay, az, H, W, D, off);
      corner_weights<NT>(ax, ay, az, H, W, D, w);
    }
    // the fixed features are read once: streamed past the caches the
    // gathers use
    const float* f = fix + n;
    float cv[8];
    ssd_channel<T, true>(mov, off, w, __ldcs(f), chain, cv, ssq);
#pragma unroll 1
    for (int c = 1; c < C; ++c)
      ssd_channel<T, false>(mov + (size_t)c * NV, off, w, __ldcs(f + (size_t)c * N), chain, cv,
                            ssq);
    // the position again rather than kept across the channels: fewer
    // registers, more CTAs an SM
    Axis ax, ay, az;
    ssd_axes(disp, n, N, ws, ds, stride, row0, fac0, fac1, fac2, ax, ay, az);
    rows_from_cv(ax, ay, az, H, W, D, cv, rows + n, N);
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
               void* total, int C, int H, int W, int D, int stride, float fac0, float fac1,
               float fac2, float chain, int row0, int hs, cudaStream_t stream) {
  // the (::stride)^3 sub-lattice: ceil(size / stride) points an axis, hs of
  // its rows from row0
  const int ws = (W + stride - 1) / stride, ds = (D + stride - 1) / stride;
  const int N = hs * ws * ds;
  const int blocks = (N + NT - 1) / NT;
  warp_ssd_kernel<T><<<blocks, NT, 0, stream>>>(
      static_cast<const T*>(mov), static_cast<const float*>(disp),
      static_cast<const float*>(fix), static_cast<float*>(rows), static_cast<float*>(partials),
      C, H, W, D, stride, row0, ws, ds, N, fac0, fac1, fac2, chain);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, NR, 0, stream>>>(static_cast<const float*>(partials), blocks,
                                           static_cast<float*>(total));
  return (int)cudaGetLastError();
}

}  // namespace

// Threads per CTA of warp_ssd_kernel: warp_ssd_loss_grad writes one
// partial sum per CTA, ceil(N / warp_ssd_threads()) for N points.
extern "C" int warp_ssd_threads() { return NT; }

// vol (B, C, H, W, D) float32 (bf16 == 0) or bfloat16 (bf16 == 1); grid
// (B, N, 3) and out (B, C, N) float32.
extern "C" int sample_trilinear(const void* vol, const void* grid, void* out, int B, int C,
                                int H, int W, int D, int N, int bf16, void* stream) {
  const dim3 blocks((N + NT - 1) / NT, B);  // one CTA row per volume
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  float* o = static_cast<float*>(out);
  if (bf16)
    sample_trilinear_kernel<__nv_bfloat16><<<blocks, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), g, o, C, H, W, D, N);
  else
    sample_trilinear_kernel<float><<<blocks, NT, 0, s>>>(static_cast<const float*>(vol), g, o,
                                                         C, H, W, D, N);
  return (int)cudaGetLastError();
}

// fields (2, 3, H, W, D) float32, [d1, d2] in normalized units; bufs holds
// two more such buffers; id_h, id_w, id_d the identity's H, W and D
// coordinates.  Runs iters steps back to back, the first reading fields and
// each writing the buffer the previous one did not; the result is in buffer
// (iters - 1) % 2.  Returns the first launch error.
extern "C" int inverse_consistency_steps(const void* fields, void* bufs, const void* id_h,
                                         const void* id_w, const void* id_d, int H, int W, int D,
                                         int iters, void* stream) {
  const long long N = (long long)H * W * D;
  const unsigned blocks = (unsigned)((2 * N + NT - 1) / NT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* buf[2] = {static_cast<float*>(bufs), static_cast<float*>(bufs) + 6 * N};
  const float* src = static_cast<const float*>(fields);
  for (int it = 0; it < iters; ++it) {
    ic_step_kernel<<<blocks, NT, 0, s>>>(src, buf[it % 2], static_cast<const float*>(id_h),
                                          static_cast<const float*>(id_w),
                                          static_cast<const float*>(id_d), H, W, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = buf[it % 2];
  }
  return 0;
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

// mov (C, H, W, D) float32 (bf16 == 0) or bfloat16 (bf16 == 1); the N = hs
// ws ds points of the rows row0 .. row0 + hs - 1 of the (::stride)^3
// sub-lattice (ceil(H / stride) x ws x ds, ws = ceil(W / stride), ...; the
// whole grid for stride 1, row0 = 0, hs = ceil(H / stride)): disp (3, N),
// fix (C, N) and rows (3, N) float32; partials holds ceil(N /
// warp_ssd_threads()) floats and total one float.
extern "C" int warp_ssd_loss_grad(const void* mov, const void* disp, const void* fix, void* rows,
                                  void* partials, void* total, int C, int H, int W, int D,
                                  float fac0, float fac1, float fac2, float chain, int stride,
                                  int bf16, int row0, int hs, void* stream) {
  if (stride < 1 || row0 < 0 || hs < 1 || row0 + hs > (H + stride - 1) / stride)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_ssd<__nv_bfloat16>(mov, disp, fix, rows, partials, total, C, H, W, D, stride,
                                     fac0, fac1, fac2, chain, row0, hs, s);
  return launch_ssd<float>(mov, disp, fix, rows, partials, total, C, H, W, D, stride, fac0, fac1,
                           fac2, chain, row0, hs, s);
}
