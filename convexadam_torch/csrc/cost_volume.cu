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
// cost_volume_general_kernel takes every other q at run time: q = 0, task
// 1's q = 8 (pipeline/challenges.py) and above; the wrapper chooses the
// kernel by q (kernels/cost_volume.py:kernel_for).  At task 1's 12 x 48 x 40
// x 48 it must write 17^3 x 92160 float32 = 1.81 GB, 0.54 ms at 3.35 TB/s,
// and do 16.3 G separately rounded operations, 0.49 ms: bytes and
// operations bound it about equally, so an instruction that is neither
// costs time directly.  The compiled scheme does not carry to q = 8: one
// warp per kw makes a CTA of 17 warps, for which ptxas allows 96 registers
// a thread, and R K = 68 accumulators with the slab window need more
// (cost_volume_kernel<8> spilled and took 2.6x the bound).  This kernel keeps the compiled kernel's thread (R = 4 voxels of
// a row, 16-byte shared loads of the fixed values and of the slab values p
// = r + kd they reach) and holds kd in blocks of KB = 8: a block's 32
// accumulators sum every channel, its planes go out with streaming stores,
// then the next block's sums begin, so one warp's stores overlap the
// others' arithmetic.  KB is a multiple of 4, so each block's slab loads
// start on a 16-byte boundary, and each block size (K = 17 is 8 + 8 + 1) is
// a case of a switch, so no operation is masked.  A CTA of at most 9 warps
// takes the K kw in rounds (17 in two), 3 CTAs an SM at 72 registers; its
// channels, up to 16, are staged once with cp.async (one channel a step of
// the copy loops: unrolled, their addresses pushed the kernel past 72
// registers into spills).  The tile is 8 rows x 16 voxels, 4 lanes a row,
// which leaves no lane idle at task 1's w = 40, d = 48 (a 4 x 32 tile idles
// a quarter of them there and took 29% longer); the slab's rows are padded
// to 16 mod 32 floats, so the two rows a quarter warp's 16-byte loads span
// fall in disjoint banks.  The first general kernel gave each thread one
// voxel walking its K^2 (kw, kd) displacements and read two shared words
// per channel term (340 M warp-wide shared loads at task 1, more time than
// the bound on their own), wrote 4-byte plain stores one plane at a time,
// and staged with synchronous loads, 3 CTAs of 8 warps an SM at 67.6 KB,
// with no copy overlapping arithmetic: 3.11 ms at task 1, 5.7x its bound.
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
// cost_volume_general_kernel: q at run time, kd in blocks
// ---------------------------------------------------------------------------

constexpr int GTW = 8;            // j rows of a CTA tile
constexpr int GTD = 16;           // l voxels of a CTA tile
constexpr int GLANES = GTD / R;   // lanes a tile row
constexpr int GTILE = GTW * GTD;  // voxels a CTA tile
constexpr int KB = 8;             // kd displacements a block: a multiple of 4, so that every
                                  // block's slab loads start on a 16-byte boundary
constexpr int GMAX_WARPS = 9;     // warps a CTA at most, each taking every nw-th kw
constexpr int GMIN_CTAS = 3;      // CTAs an SM the registers must allow
static_assert(GLANES == 4, "the slab's row padding assumes two tile rows a quarter warp");

// The general kernel's staging for half-width q, worked out alike by the
// launcher (shared memory) and the kernel: K x K displacements, the slab of
// SW rows of which a row's first SDN floats are staged (R + K - 1 values a
// thread's voxels reach, in NV 16-byte loads), a row every SD floats.  A
// quarter warp's 16-byte loads span two tile rows, so SD is padded to 16 mod
// 32 floats, and the two rows fall in disjoint banks.
struct GeneralShape {
  int K, NV, SW, SDN, SD, SP;
  __host__ __device__ explicit GeneralShape(int q)
      : K(2 * q + 1), NV((R + 2 * q + 3) / 4), SW(GTW + 2 * q), SDN(GTD - R + 4 * NV),
        SD(SDN + (48 - SDN % 32) % 32), SP(SW * SD) {}
};

// Stage the channels c0 .. c0 + cc - 1 of a CTA's slab (moving row im, the
// tile grown by q along j and l) and fixed tile (row i) with asynchronous
// copies, zero-filled outside the volume; each element's offset is worked
// out once for all cc channels.
__device__ __forceinline__ void stage_general(float* slab, float* fx, const float* fix,
                                              const float* mov, const GeneralShape& g, int c0,
                                              int cc, int h, int w, int d, int q, int i, int im,
                                              int j0, int l0) {
  const int t = threadIdx.x, nt = blockDim.x;
  const size_t hwd = (size_t)h * w * d;
  const unsigned slab_s = static_cast<unsigned>(__cvta_generic_to_shared(slab));
  const unsigned fx_s = static_cast<unsigned>(__cvta_generic_to_shared(fx));
  const bool row_in = im >= 0 && im < h;
  for (int e = t; e < g.SW * g.SDN; e += nt) {
    const int r = e / g.SDN, col = e - r * g.SDN;
    const int gj = j0 - q + r, gl = l0 - q + col;
    const bool in = row_in && gj >= 0 && gj < w && gl >= 0 && gl < d;
    const float* src = mov + c0 * hwd + (in ? ((size_t)im * w + gj) * d + gl : 0);
    const unsigned dst = slab_s + 4 * (r * g.SD + col);
#pragma unroll 1
    for (int c = 0; c < cc; ++c) copy4(dst + 4 * c * g.SP, src + c * hwd, in);
  }
  for (int e = t; e < GTILE; e += nt) {
    const int gj = j0 + e / GTD, gl = l0 + e % GTD;
    const bool in = gj < w && gl < d;
    const float* src = fix + c0 * hwd + (in ? ((size_t)i * w + gj) * d + gl : 0);
#pragma unroll 1
    for (int c = 0; c < cc; ++c) copy4(fx_s + 4 * (c * GTILE + e), src + c * hwd, in);
  }
}

// cc staged channels of a thread's R voxels at NB displacements kd: per
// channel one 16-byte load of its fixed values f and NVB of the slab values
// s[p], p = r + kd - kd0, they reach
template <int NB, bool SAD>
__device__ __forceinline__ void general_sums(float (&acc)[R][NB], const float* f, const float* s,
                                             int sp, int cc) {
  constexpr int NVB = (R + NB + 2) / 4;
#pragma unroll 1
  for (int c = 0; c < cc; ++c, f += GTILE, s += sp) {
    const float4 f4 = *reinterpret_cast<const float4*>(f);
    const float fv[R] = {f4.x, f4.y, f4.z, f4.w};
    float sv[4 * NVB];
#pragma unroll
    for (int v = 0; v < NVB; ++v) {
      const float4 s4 = *reinterpret_cast<const float4*>(s + 4 * v);
      sv[4 * v] = s4.x;
      sv[4 * v + 1] = s4.y;
      sv[4 * v + 2] = s4.z;
      sv[4 * v + 3] = s4.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < NB; ++k)
        acc[r][k] = __fadd_rn(acc[r][k], metric_term<SAD>(__fsub_rn(fv[r], sv[r + k])));
  }
}

// One kd block of one kw: its sums over every channel (staging each chunk
// anew where they do not all fit at once), then its NB planes with
// streaming stores from o, this thread's first voxel of the block's first
// plane, one plane apart: a 16-byte store a plane where d is a multiple of
// 4, else through the warp's tile in shared memory, a row's voxels from
// consecutive lanes.
template <int NB, bool SAD>
__device__ __forceinline__ void general_block(float* slab, float* fx, float* tile,
                                              const float* fix, const float* mov, float* o,
                                              size_t plane, const GeneralShape& g, int C, int cs,
                                              int h, int w, int d, int q, int i, int im, int j0,
                                              int l0, int lj, int lg, bool live, int kw,
                                              int kd0) {
  float acc[R][NB];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int k = 0; k < NB; ++k) acc[r][k] = 0.f;
  const bool valid = j0 + lj < w && l0 + R * lg < d;
  for (int c0 = 0; c0 < C; c0 += cs) {
    const int cc = C - c0 < cs ? C - c0 : cs;
    if (C > cs) {
      __syncthreads();  // the previous chunk is read
      stage_general(slab, fx, fix, mov, g, c0, cc, h, w, d, q, i, im, j0, l0);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
    }
    if (live && valid)
      general_sums<NB, SAD>(acc, fx + lj * GTD + R * lg,
                            slab + (lj + kw) * g.SD + R * lg + kd0, g.SP, cc);
  }
  if (!live) return;
  if ((d & 3) == 0) {
    if (valid) {
#pragma unroll
      for (int k = 0; k < NB; ++k, o += plane)
        __stcs(reinterpret_cast<float4*>(o), make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]));
    }
  } else {
    const int lane = threadIdx.x & 31;
    o -= lj * d + R * lg;  // the tile's first voxel
#pragma unroll
    for (int k = 0; k < NB; ++k, o += plane) {
      *reinterpret_cast<float4*>(tile + lj * GTD + R * lg) =
          make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]);
      __syncwarp();
#pragma unroll 1
      for (int e = lane; e < GTILE; e += 32) {
        const int jj = e / GTD, ll = e % GTD;
        if (j0 + jj < w && l0 + ll < d) __stcs(o + jj * d + ll, tile[e]);
      }
      __syncwarp();
    }
  }
}

template <bool SAD>
__global__ void __launch_bounds__(32 * GMAX_WARPS, GMIN_CTAS)
cost_volume_general_kernel(const float* __restrict__ fix, const float* __restrict__ mov,
                           float* __restrict__ out, int C, int h, int w, int d, int q, int kh0,
                           int nkh, int cs) {
  extern __shared__ __align__(16) float gsmem[];
  const GeneralShape g(q);
  float* slab = gsmem;                // cs x SW x SD
  float* fx = gsmem + cs * g.SP;      // cs x GTW x GTD
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  float* tile = fx + cs * GTILE + warp * GTILE;  // the warp's, where d % 4 != 0
  const int lj = lane / GLANES, lg = lane % GLANES;
  const int n_td = (d + GTD - 1) / GTD;
  const int j0 = (blockIdx.x / n_td) * GTW, l0 = (blockIdx.x % n_td) * GTD;
  const int i = blockIdx.z, im = i + kh0 + (int)blockIdx.y - q;
  const size_t hwd = (size_t)h * w * d;
  const size_t plane = (size_t)g.K * nkh * hwd;  // from kd to kd + 1
  // this thread's first voxel in the plane of (kw, kd) = (0, 0)
  float* const o = out + blockIdx.y * hwd + ((size_t)i * w + j0 + lj) * d + l0 + R * lg;

  if (C <= cs) {  // every channel staged once, for every block
    stage_general(slab, fx, fix, mov, g, 0, C, h, w, d, q, i, im, j0, l0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  for (int kw0 = 0; kw0 < g.K; kw0 += nw) {
    const int kw = kw0 + warp;
    const bool live = kw < g.K;  // the same for the whole warp
    for (int kd0 = 0; kd0 < g.K; kd0 += KB) {
      float* ob = o + ((size_t)kw * nkh * hwd + kd0 * plane);
#define GENERAL_BLOCK(NB)                                                                     \
  general_block<NB, SAD>(slab, fx, tile, fix, mov, ob, plane, g, C, cs, h, w, d, q, i, im, j0, \
                         l0, lj, lg, live, kw, kd0)
      // K is odd: a full block, or the odd rest of the last one
      switch (g.K - kd0 < KB ? g.K - kd0 : KB) {
        case KB: GENERAL_BLOCK(KB); break;
        case 7: GENERAL_BLOCK(7); break;
        case 5: GENERAL_BLOCK(5); break;
        case 3: GENERAL_BLOCK(3); break;
        case 1: GENERAL_BLOCK(1); break;
      }
#undef GENERAL_BLOCK
    }
  }
}

template <bool SAD>
int launch_general(const float* fix, const float* mov, float* out, int C, int h, int w, int d,
                   int q, int kh0, int nkh, cudaStream_t stream) {
  static int granted[MAX_DEVICES] = {};
  const GeneralShape g(q);
  const int rounds = (g.K + GMAX_WARPS - 1) / GMAX_WARPS;  // kw a warp takes
  const int nw = (g.K + rounds - 1) / rounds;
  // the channels staged at a time: up to CC, as many as the CTA's shared
  // memory holds beside the warps' output tiles
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t channel = (size_t)g.SP + GTILE;
  const size_t tiles = (d & 3) ? (size_t)nw * GTILE : 0;
  const size_t room = (size_t)limit / sizeof(float);
  const size_t fit = room > tiles ? (room - tiles) / channel : 0;
  const size_t want = C < CC ? C : CC;
  const int cs = (int)(fit < want ? fit : want);
  if (cs < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (cs * channel + tiles) * sizeof(float);
  const int e = ensure_smem(cost_volume_general_kernel<SAD>, smem, granted);
  if (e != 0) return e;
  const dim3 grid(((w + GTW - 1) / GTW) * ((d + GTD - 1) / GTD), nkh, h);
  cost_volume_general_kernel<SAD><<<grid, 32 * nw, smem, stream>>>(fix, mov, out, C, h, w, d, q,
                                                                   kh0, nkh, cs);
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
