// Dense cost volume: out[k, i, j, l] = sum_c m(fix[c, i, j, l] -
// mov[c, i + kh - q, j + kw - q, l + kd - q]) with zeros outside the moving
// volume, k = kd * K^2 + kw * K + kh, K = 2q + 1, all in float32, the
// channels added in order c = 0..C-1 with each operation rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn: no fused multiply-add), as the plain
// version in kernels/cost_volume.py does.  The metric m is a template
// argument: SSD, m(x) = x * x, or SAD, m(x) = |x| (fabsf, exact), so the SSD
// instantiations are the code they were before SAD existed.
//
// A candidate-block launch computes the kh in [kh0, kh0 + nkh) only and
// writes them as a (K, K, nkh, h, w, d) slab, index (kd * K + kw) * nkh +
// kh - kh0; the dense volume is the block kh0 = 0, nkh = K.  The streamed
// convex path (core/convex.py) takes one kh a block, so it never holds more
// than K^2 candidates of the volume.
//
// Replaces the TPU kernel convexadam_tpu/ops/cost_volume_pallas.py:
// cost_volume_pallas -> _cost_kernel (SSD); SAD and the candidate blocks
// replace the XLA scans of convexadam_tpu/core/cost_volume.py:correlate and
// core/convex.py:correlate_coupled_streamed, which the port does not leave
// to a plain version on the card.
//
// Bound on the H100: the output's bytes and the unfused operations, about
// equally.  At the default setting (12 x 32^3 coarse features, q = 4) the
// kernel must write 729 x 32^3 float32 = 95.6 MB, 29 us at 3.35 TB/s, and do
// 3 K^3 n C = 0.86 G separately rounded float32 operations, 26 us at 132 SMs
// x 128 lanes x 1.98 GHz (none of them fuses).  The 1.6 MB feature volumes
// stay in L2.  So every instruction that is not one of those operations
// costs issue slots the bound does not count.
//
// cost_volume_kernel<Q> takes the half-widths the self-configuring search
// draws, q = 1..7, as a template argument. One CTA per (4-row j tile,
// 32-voxel l tile, kh, i) has one warp per kw: lane = (row lj, group lg),
// and the thread owns the R = 4 neighbouring voxels l0 + 4 lg .. + 3 of row
// j0 + lj and all K displacements kd of its (kw, kh), R K accumulators in
// registers. The CTA stages the fixed tile and the moving slab it needs (row
// i + kh - q, the tile grown by q along j and l, zero outside) in shared
// memory, up to 16 channels at a time, with asynchronous copies (cp.async,
// zero-filled outside the volume) whose offsets a thread works out once for
// every channel (worked out per element, the copies' index arithmetic took a
// quarter of the kernel's time; two 8-channel stages, one filled while the
// other was summed, were no faster than one). Per channel a thread reads its
// 4 fixed values (one 16-byte load) and the R + K - 1 slab values its voxels
// reach (16-byte loads): slab value p serves voxel r at kd wherever r + kd =
// p, so at q = 4 one channel costs 4 shared-memory loads for 108 float32
// operations (the general kernel read two shared words per multiply-add).
// Each thread keeps all channels of its outputs, so chunks of channels leave
// the order of the sum as it is. i is the grid's slowest index: the CTAs in
// flight read the few moving rows around one i, which stay in L2, and the
// output goes out with streaming stores, which do not push them out. Where d
// is a multiple of 4 every kd plane of a thread's voxels is one 16-byte
// store; elsewhere each warp turns its 4 x 32 tile of a plane around in
// shared memory and writes it as four rows of 32 consecutive floats (4-byte
// stores of a thread's own voxels left 16 sectors a warp half-filled, which
// made the q = 7 sweep shape slower than the general kernel). Registers: up
// to q = 4 capped for 3 CTAs an SM, no spills; above, the 52-60 accumulators
// take about 120 registers, 1 CTA.
//
// cost_volume_general_kernel takes any other q at run time (the first
// design: one thread per voxel of an 8 x 32 tile walking its K^2 (kw, kd)
// displacements, all channels in shared memory).  The wrapper chooses the
// kernel by q (kernels/cost_volume.py:kernel_for).
#include "common.cuh"

namespace {

constexpr int TW = 4;    // j rows of a CTA tile
constexpr int TD = 32;   // l voxels of a CTA tile
constexpr int R = 4;     // l voxels of a thread
constexpr int CC = 16;   // channels staged in shared memory at a time
constexpr int MAX_DEVICES = 64;

template <int Q>
struct Cv {
  static constexpr int K = 2 * Q + 1;
  static constexpr int NT = 32 * K;                // one warp per kw
  static constexpr int NV = (R + 2 * Q + 3) / 4;   // 16-byte slab loads a thread and channel
  static constexpr int SW = TW + 2 * Q;            // slab rows (j)
  static constexpr int SD = TD - R + 4 * NV;       // slab row (l), a multiple of 4
  static constexpr int SP = SW * SD, FP = TW * TD; // floats a channel stages: slab, fixed tile
  // CTAs an SM the registers must allow: 3 up to q = 4 (at most 75
  // registers), 1 above (the 52-60 accumulators need more); with no
  // minimum ptxas spilled at q = 1 and q = 6
  static constexpr int MIN_CTAS = Q <= 4 ? 3 : 1;
};

// Raise the kernel's dynamic shared-memory limit on the current device the
// first time a launch needs more than the default 48 KB, and only then.
template <typename Kern>
int ensure_smem(Kern kernel, size_t bytes, int* granted) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if ((int)bytes <= granted[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted[dev] = (int)bytes;
  return (int)err;
}

// 4-byte asynchronous copy from global to shared memory (address dst),
// zero-filled (and nothing read) where !in
__device__ __forceinline__ void copy4(unsigned dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// One thread's share of the copies of cc channels: element e = t + k NT of
// each channel's plane of P floats, at dst + 4 (c P + e) in shared memory,
// from src[k] + c hwd (off[k] < 0: outside the volume, zero-filled).  The
// element's place is the same in every channel, so only the pointers move
// from one channel to the next.
template <int NT, int P, int E>
__device__ __forceinline__ void copy_channels(unsigned dst, const float* base, const int* off,
                                              int cc, size_t hwd) {
  const float* src[E];
#pragma unroll
  for (int k = 0; k < E; ++k) src[k] = base + (off[k] < 0 ? 0 : off[k]);
  const int t = threadIdx.x;
  for (int c = 0; c < cc; ++c) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (k < E - 1 || t + k * NT < P)
        copy4(dst + 4 * (c * P + t + k * NT), src[k], off[k] >= 0);
      src[k] += hwd;
    }
  }
}

// One channel's term of the metric: SSD squares the difference, SAD takes
// its magnitude; either is added to the running sum by the caller.
template <bool SAD>
__device__ __forceinline__ float metric_term(float diff) {
  return SAD ? fabsf(diff) : __fmul_rn(diff, diff);
}

template <int Q, bool SAD>
__global__ void __launch_bounds__(Cv<Q>::NT, Cv<Q>::MIN_CTAS)
cost_volume_kernel(const float* __restrict__ fix, const float* __restrict__ mov,
                   float* __restrict__ out, int C, int h, int w, int d, int kh0, int nkh) {
  using S = Cv<Q>;
  constexpr int K = S::K, SW = S::SW, SD = S::SD, SP = S::SP, FP = S::FP;
  constexpr int ES = (SP + S::NT - 1) / S::NT, EF = (FP + S::NT - 1) / S::NT;
  extern __shared__ __align__(16) float smem[];
  const int cs = C < CC ? C : CC;  // channels shared memory holds
  float* slab = smem;              // cs x SW x SD
  float* fx = smem + cs * SP;      // cs x TW x TD
  const int n_td = (d + TD - 1) / TD;
  const int j0 = (blockIdx.x / n_td) * TW;
  const int l0 = (blockIdx.x % n_td) * TD;
  const int kh = kh0 + blockIdx.y;
  const int i = blockIdx.z;
  const int im = i + kh - Q;
  const int t = threadIdx.x;
  const int kw = t >> 5, lj = (t >> 3) & 3, lg = t & 7;
  const int j = j0 + lj, l = l0 + R * lg;
  const bool valid = j < w && l < d;
  const size_t hwd = (size_t)h * w * d;

  // this thread's copy elements: their offsets in a channel, -1 outside
  const bool row_in = im >= 0 && im < h;
  int so[ES], fo[EF];
#pragma unroll
  for (int k = 0; k < ES; ++k) {
    const int e = t + k * S::NT, gj = j0 - Q + e / SD, gl = l0 - Q + e % SD;
    so[k] = row_in && gj >= 0 && gj < w && gl >= 0 && gl < d ? (im * w + gj) * d + gl : -1;
  }
#pragma unroll
  for (int k = 0; k < EF; ++k) {
    const int e = t + k * S::NT, gj = j0 + e / TD, gl = l0 + e % TD;
    fo[k] = gj < w && gl < d ? (i * w + gj) * d + gl : -1;
  }
  const unsigned slab_s = static_cast<unsigned>(__cvta_generic_to_shared(slab));
  const unsigned fx_s = static_cast<unsigned>(__cvta_generic_to_shared(fx));

  float acc[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int kd = 0; kd < K; ++kd) acc[r][kd] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = C - c0 < CC ? C - c0 : CC;
    if (c0 > 0) __syncthreads();  // the previous chunk is read
    copy_channels<S::NT, SP, ES>(slab_s, mov + c0 * hwd, so, cc, hwd);
    copy_channels<S::NT, FP, EF>(fx_s, fix + c0 * hwd, fo, cc, hwd);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (valid) {
      for (int c = 0; c < cc; ++c) {
        const float4 f4 = *reinterpret_cast<const float4*>(fx + (c * TW + lj) * TD + R * lg);
        const float fv[R] = {f4.x, f4.y, f4.z, f4.w};
        const float* srow = slab + (c * SW + lj + kw) * SD + R * lg;
        float sv[4 * S::NV];
#pragma unroll
        for (int v = 0; v < S::NV; ++v) {
          const float4 s4 = *reinterpret_cast<const float4*>(srow + 4 * v);
          sv[4 * v] = s4.x;
          sv[4 * v + 1] = s4.y;
          sv[4 * v + 2] = s4.z;
          sv[4 * v + 3] = s4.w;
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int kd = 0; kd < K; ++kd) {
            acc[r][kd] = __fadd_rn(acc[r][kd], metric_term<SAD>(__fsub_rn(fv[r], sv[r + kd])));
          }
      }
    }
  }
  __syncthreads();  // shared memory is read: the output tiles may reuse it

  // written once: streaming stores, which leave L2 to the features
  const size_t plane = (size_t)K * nkh * hwd;  // from kd to kd + 1
  float* o = out + ((size_t)kw * nkh + (kh - kh0)) * hwd + (size_t)i * w * d;
  if ((d & 3) == 0) {
    // every row and voxel group 16-byte aligned: one store a plane (the
    // tile path below took a third longer at d = 32)
    if (valid) {
      float* ov = o + (size_t)j * d + l;
#pragma unroll
      for (int kd = 0; kd < K; ++kd)
        __stcs(reinterpret_cast<float4*>(ov + kd * plane),
               make_float4(acc[0][kd], acc[1][kd], acc[2][kd], acc[3][kd]));
    }
  } else {
    // rows at any alignment: the warp turns its 4 x 32 tile of a plane
    // around in shared memory (free after the last barrier), so each row
    // goes out as 32 consecutive floats
    float* tile = smem + kw * TW * TD;
    const int lane = t & 31;
#pragma unroll
    for (int kd = 0; kd < K; ++kd) {
      *reinterpret_cast<float4*>(tile + lj * TD + R * lg) =
          make_float4(acc[0][kd], acc[1][kd], acc[2][kd], acc[3][kd]);
      __syncwarp();
#pragma unroll
      for (int row = 0; row < TW; ++row)
        if (j0 + row < w && l0 + lane < d)
          __stcs(o + kd * plane + (size_t)(j0 + row) * d + l0 + lane, tile[row * TD + lane]);
      __syncwarp();
    }
  }
}

template <int Q, bool SAD>
int launch(const float* fix, const float* mov, float* out, int C, int h, int w, int d, int kh0,
           int nkh, cudaStream_t stream) {
  using S = Cv<Q>;
  static int granted[MAX_DEVICES] = {};
  // the staged channels; at least the warps' output tiles
  const size_t staged = (size_t)(C < CC ? C : CC) * (S::SP + S::FP);
  const size_t smem = (staged > S::K * TW * TD ? staged : S::K * TW * TD) * sizeof(float);
  const int err = ensure_smem(cost_volume_kernel<Q, SAD>, smem, granted);
  if (err != 0) return err;
  // i outermost: the CTAs in flight share the few moving rows around i,
  // which stay in L2
  const dim3 grid(((w + TW - 1) / TW) * ((d + TD - 1) / TD), nkh, h);
  cost_volume_kernel<Q, SAD><<<grid, S::NT, smem, stream>>>(fix, mov, out, C, h, w, d, kh0, nkh);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// cost_volume_general_kernel: runtime q
// ---------------------------------------------------------------------------

constexpr int GW = 8;
constexpr int GD = 32;
constexpr int GNT = GW * GD;

template <bool SAD>
__global__ void __launch_bounds__(GNT)
cost_volume_general_kernel(const float* __restrict__ fix, const float* __restrict__ mov,
                           float* __restrict__ out, int C, int h, int w, int d, int q, int kh0,
                           int nkh) {
  extern __shared__ float gsmem[];
  const int K = 2 * q + 1;
  const int SW = GW + 2 * q, SD = GD + 2 * q;
  float* slab = gsmem;               // C x SW x SD
  float* fx = gsmem + C * SW * SD;   // C x GW x GD
  const int n_td = (d + GD - 1) / GD;
  const int j0 = (blockIdx.x / n_td) * GW;
  const int l0 = (blockIdx.x % n_td) * GD;
  const int i = blockIdx.y;
  const int kh = kh0 + blockIdx.z;
  const int im = i + kh - q;
  const bool row_in = im >= 0 && im < h;
  const int t = threadIdx.x;
  const size_t hwd = (size_t)h * w * d;

  for (int e = t; e < C * SW * SD; e += GNT) {
    const int sd = e % SD, sw = (e / SD) % SW, c = e / (SD * SW);
    const int gj = j0 - q + sw, gl = l0 - q + sd;
    float v = 0.f;
    if (row_in && gj >= 0 && gj < w && gl >= 0 && gl < d)
      v = mov[c * hwd + ((size_t)im * w + gj) * d + gl];
    slab[e] = v;
  }
  const int lj = t / GD, ll = t % GD;
  const int gj = j0 + lj, gl = l0 + ll;
  const bool valid = gj < w && gl < d;
  for (int c = 0; c < C; ++c)
    fx[c * GNT + t] = valid ? fix[c * hwd + ((size_t)i * w + gj) * d + gl] : 0.f;
  __syncthreads();
  if (!valid) return;

  const size_t plane = (size_t)K * nkh;
  const size_t vox = ((size_t)i * w + gj) * d + gl;
  for (int kw = 0; kw < K; ++kw) {
    for (int kd = 0; kd < K; ++kd) {
      float acc = 0.f;
      for (int c = 0; c < C; ++c)
        acc = __fadd_rn(acc, metric_term<SAD>(
                                 __fsub_rn(fx[c * GNT + t], slab[(c * SW + lj + kw) * SD + ll + kd])));
      const size_t k = (size_t)kd * plane + (size_t)kw * nkh + (kh - kh0);
      out[k * hwd + vox] = acc;
    }
  }
}

template <bool SAD>
int launch_general(const float* fix, const float* mov, float* out, int C, int h, int w, int d,
                   int q, int kh0, int nkh, cudaStream_t stream) {
  static int granted[MAX_DEVICES] = {};
  const size_t smem =
      ((size_t)C * (GW + 2 * q) * (GD + 2 * q) + (size_t)C * GW * GD) * sizeof(float);
  const int err = ensure_smem(cost_volume_general_kernel<SAD>, smem, granted);
  if (err != 0) return err;
  const int n_tiles = ((w + GW - 1) / GW) * ((d + GD - 1) / GD);
  const dim3 grid(n_tiles, h, nkh);
  cost_volume_general_kernel<SAD><<<grid, GNT, smem, stream>>>(fix, mov, out, C, h, w, d, q, kh0,
                                                               nkh);
  return (int)cudaGetLastError();
}

template <bool SAD>
int dispatch(const float* f, const float* m, float* o, int C, int h, int w, int d, int q,
             int general, int kh0, int nkh, cudaStream_t s) {
  if (general) return launch_general<SAD>(f, m, o, C, h, w, d, q, kh0, nkh, s);
  switch (q) {
    case 1: return launch<1, SAD>(f, m, o, C, h, w, d, kh0, nkh, s);
    case 2: return launch<2, SAD>(f, m, o, C, h, w, d, kh0, nkh, s);
    case 3: return launch<3, SAD>(f, m, o, C, h, w, d, kh0, nkh, s);
    case 4: return launch<4, SAD>(f, m, o, C, h, w, d, kh0, nkh, s);
    case 5: return launch<5, SAD>(f, m, o, C, h, w, d, kh0, nkh, s);
    case 6: return launch<6, SAD>(f, m, o, C, h, w, d, kh0, nkh, s);
    case 7: return launch<7, SAD>(f, m, o, C, h, w, d, kh0, nkh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// fix, mov (C, h, w, d) float32; out (K, K, nkh, h, w, d) float32 receives
// the candidates kh in [kh0, kh0 + nkh) (the dense (K^3, h, w, d) volume for
// kh0 = 0, nkh = K).  sad == 0 sums squared differences, sad == 1 absolute
// ones.  general == 0 runs cost_volume_kernel<q, sad>, which exists for q =
// 1..7 (any other q is refused); general == 1 runs
// cost_volume_general_kernel<sad>.
extern "C" int cost_volume(const void* fix, const void* mov, void* out, int C, int h, int w,
                           int d, int q, int general, int sad, int kh0, int nkh, void* stream) {
  const int K = 2 * q + 1;
  if (q < 0 || kh0 < 0 || nkh < 1 || kh0 + nkh > K) return (int)cudaErrorInvalidValue;
  const float* f = static_cast<const float*>(fix);
  const float* m = static_cast<const float*>(mov);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return sad ? dispatch<true>(f, m, o, C, h, w, d, q, general, kh0, nkh, s)
             : dispatch<false>(f, m, o, C, h, w, d, q, general, kh0, nkh, s);
}
