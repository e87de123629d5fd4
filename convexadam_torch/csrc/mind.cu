// MIND-SSC statistics: the 12 shift-pair squared differences, their
// (2r+1)^3 replicate-padded box mean, the channel-min subtraction and the
// channel-mean variance, for one volume (H, W, D).
//
// Replaces the TPU kernel convexadam_tpu/ops/mind_pallas.py:
// mind_ssd_stats_pallas -> _mind_kernel.
//
// Bound on the H100: bytes by the bound formula (at 192^3 in bfloat16 the
// kernel must read the image, 14 MB, and write mind, 12 channels, 170 MB,
// and var, f32, 28 MB: about 212 MB or 63 us at 3.35 TB/s), but in practice
// instructions: every intermediate is rounded to the storage type as PyTorch
// rounds each bf16 operation, which makes the kernel agree with the plain
// version in kernels/mind.py to the bit in f32 and bf16, and costs about 35
// instructions a voxel and channel.
//
// mind_kernel<T, R, DIL> takes the radius and dilation the self-configuring
// search draws, {1, 2, 3}^2, as template arguments, so the pair offsets, the
// window and the halo are constants and no index is decoded with a runtime
// division.  One CTA of 512 threads makes an FH x FW x FD = 4 x 8 x 64
// output tile (D innermost, a warp's 32 lanes own 32 voxel pairs along D):
//   1. the image halo of the tile, grown by R + DIL on every side and read at
//      clamped coordinates, goes to shared memory once, as float;
//   2. per channel, in three barrier-separated passes: the squared
//      difference on the tile grown by R (the diff array's own replicate pad
//      clamps its voxel before the shift is applied), the window sum along
//      H, the window sum along W; the D window and the division by k^3 run
//      from shared memory straight into registers, and overlap the next
//      channel's difference pass;
//   3. each thread keeps its 2 voxel pairs' 12 box means (in shared memory in
//      bf16, in registers in f32) for the channel min and the variance, so
//      the 12-channel volume is written once and never read back.
// Everything after the image load works on pairs of neighbouring voxels
// along D: in bfloat16 one packed bf16x2 instruction per operation (add, sub,
// mul with .rn, which equal the float operation rounded to bf16, since a
// float has more than twice bf16's precision plus 2 bits), in float32 two
// __f*_rn operations.  The window offsets are added in ascending order with a
// rounding after each add, as the plain version's separable sums do.
//
// mind_general_kernel takes any other radius and dilation at run time: a
// 4 x 8 x 32 tile, 256 threads, four passes a channel, the same rounding.
#include <string.h>

#include "common.cuh"

namespace {

constexpr int NPAIR = 12;

// ---------------------------------------------------------------------------
// Pair arithmetic: two neighbouring voxels along D, rounded as stored
// ---------------------------------------------------------------------------

template <typename T>
struct Pair;

template <>
struct Pair<float> {
  using P = float2;
  static __device__ __forceinline__ P make(float a, float b) { return make_float2(a, b); }
  static __device__ __forceinline__ float lo(P p) { return p.x; }
  static __device__ __forceinline__ float hi(P p) { return p.y; }
  static __device__ __forceinline__ P add(P a, P b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  }
  static __device__ __forceinline__ P sub(P a, P b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
  }
  static __device__ __forceinline__ P mul(P a, P b) {
    return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
  }
  static __device__ __forceinline__ P min(P a, P b) {
    return make_float2(fminf(a.x, b.x), fminf(a.y, b.y));
  }
  // (a.hi, b.lo): the pair that starts at an odd offset
  static __device__ __forceinline__ P odd(P a, P b) { return make_float2(a.y, b.x); }
  // the box mean: a true division by k^3
  static __device__ __forceinline__ P mean(P a, float k3, float) {
    return make_float2(__fdiv_rn(a.x, k3), __fdiv_rn(a.y, k3));
  }
  static __device__ __forceinline__ void st2(float* p, P v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ void st_lo(float* p, P v) { *p = v.x; }
  static __device__ __forceinline__ void st_hi(float* p, P v) { *p = v.y; }
};

// bf16x2 in one 32-bit register, lo half first
template <>
struct Pair<__nv_bfloat16> {
  using P = unsigned;
  static __device__ __forceinline__ P make(float a, float b) {
    P d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(b), "f"(a));
    return d;
  }
  static __device__ __forceinline__ float lo(P p) { return __uint_as_float(p << 16); }
  static __device__ __forceinline__ float hi(P p) { return __uint_as_float(p & 0xffff0000u); }
  static __device__ __forceinline__ P add(P a, P b) {
    P d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ P sub(P a, P b) {
    P d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ P mul(P a, P b) {
    P d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ P min(P a, P b) {
    P d;
    asm("min.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ P odd(P a, P b) { return __byte_perm(a, b, 0x5432); }
  // The box mean rounded to bf16, as the sum a times the float reciprocal
  // of k^3, rounds as __fdiv_rn(a, k^3) rounded to bf16 does.  A bf16
  // rounding tie has 9 significant bits.  a = m 2^e with m an integer of at
  // most 8 bits, and k^3 is odd: where k^3 divides m the quotient is shorter
  // than m, elsewhere it is no binary fraction, so it is never a tie.  It
  // lies at least 2^-9 / k^3 > 2^-18 of itself (k <= 7) from every tie when
  // it is normal, and at least 2^-134 / k^3 > 2^-143 when it is subnormal
  // (a is a multiple of 2^-133, the ties odd multiples of 2^-134).  The
  // float product and the float quotient both lie within 2^-22 of it
  // relatively, or 2^-149 absolutely below 2^-126, so they round to the
  // same bf16.  tests/test_torch_kernels.py checks every finite bf16 sum.
  static __device__ __forceinline__ P mean(P a, float, float rk3) {
    return make(__fmul_rn(lo(a), rk3), __fmul_rn(hi(a), rk3));
  }
  static __device__ __forceinline__ void st2(__nv_bfloat16* p, P v) {
    *reinterpret_cast<unsigned*>(p) = v;
  }
  static __device__ __forceinline__ void st_lo(__nv_bfloat16* p, P v) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)(v & 0xffffu);
  }
  static __device__ __forceinline__ void st_hi(__nv_bfloat16* p, P v) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)(v >> 16);
  }
};

// ---------------------------------------------------------------------------
// mind_kernel<T, R, DIL>: compile-time radius and dilation
// ---------------------------------------------------------------------------

// The 12 shift pairs (kernels/mind.py: _mind_shift_pairs, in its order), each
// shift as (oh + 1) * 9 + (ow + 1) * 3 + (od + 1) for its offset from the
// centre in units of the dilation; pair c is code(c) = first * 27 + second.
__host__ __device__ constexpr int pair_code(int c) {
  switch (c) {
    case 0: return 12 * 27 + 4;
    case 1: return 10 * 27 + 4;
    case 2: return 10 * 27 + 12;
    case 3: return 14 * 27 + 4;
    case 4: return 14 * 27 + 10;
    case 5: return 22 * 27 + 12;
    case 6: return 22 * 27 + 10;
    case 7: return 22 * 27 + 14;
    case 8: return 16 * 27 + 4;
    case 9: return 16 * 27 + 12;
    case 10: return 16 * 27 + 14;
    default: return 16 * 27 + 22;
  }
}

// the linear offset in a (., XW, XD) array of shift s (0 or 1) of pair c
__host__ __device__ constexpr int shift_offset(int c, int s, int dil, int XW, int XD) {
  const int code = s == 0 ? pair_code(c) / 27 : pair_code(c) % 27;
  const int oh = code / 9 - 1, ow = (code / 3) % 3 - 1, od = code % 3 - 1;
  return ((oh * XW + ow) * XD + od) * dil;
}

constexpr int FH = 4;
constexpr int FW = 8;
constexpr int FD = 64;
constexpr int FNT = 512;  // thread t: voxel pair t % 32 along D, row (t / 32) % FW, planes 2 (t / 256) + {0, 1}

template <typename T, int R, int DIL>
struct Fixed {
  static constexpr int B = R + DIL, K = 2 * R + 1;
  // image halo (float)
  static constexpr int XH = FH + 2 * B, XW = FW + 2 * B, XD = FD + 2 * B;
  // difference region, H sums, W sums, in voxel pairs along D
  static constexpr int EH = FH + 2 * R, EW = FW + 2 * R, EP = (FD + 2 * R) / 2;
  static constexpr int NDIFF = EH * EW * EP, NHS = FH * EW * EP, NWS = FH * FW * EP;
  static constexpr int IDIFF = (NDIFF + FNT - 1) / FNT, IHS = (NHS + FNT - 1) / FNT,
                       IWS = (NWS + FNT - 1) / FNT;
  // bf16 at radius 1 fits 64 registers without spills: two CTAs an SM;
  // the others keep their 12 float pairs or longer address lists in up to
  // 128 registers
  static constexpr int MIN_BLOCKS = (sizeof(T) == 2 && R == 1) ? 2 : 1;
  static_assert(XH * XW * XD < (1 << 16), "halo index packed in 16 bits");
  // Where a thread's 24 box means (12 channels x its 2 voxel pairs) wait
  // for the channel min: shared memory in bf16 (24 registers fewer, so two
  // CTAs of 512 an SM fit 64 registers without spills), registers in float
  // (one CTA an SM, up to 128 registers, and the float halo would not
  // leave room)
  static constexpr bool HOLD_SMEM = sizeof(T) == 2;
  static constexpr size_t smem_bytes() {
    return sizeof(float) * XH * XW * XD +
           sizeof(typename Pair<T>::P) *
               (size_t)(NDIFF + NHS + NWS + (HOLD_SMEM ? NPAIR * 2 * FNT : 0));
  }
};

template <typename T, int R, int DIL>
__global__ void __launch_bounds__(FNT, (Fixed<T, R, DIL>::MIN_BLOCKS))
mind_kernel(const T* __restrict__ x, T* __restrict__ mind, float* __restrict__ var, int H, int W,
            int D) {
  using F = Fixed<T, R, DIL>;
  using PO = Pair<T>;
  using P = typename PO::P;
  constexpr int B = F::B, XH = F::XH, XW = F::XW, XD = F::XD;
  constexpr int EH = F::EH, EW = F::EW, EP = F::EP;
  constexpr float K3 = (float)(F::K * F::K * F::K);
  constexpr float RK3 = 1.0f / K3;
  extern __shared__ float4 smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  P* dif = reinterpret_cast<P*>(xs + XH * XW * XD);  // XD is even: 8-byte aligned
  P* hs = dif + F::NDIFF;
  P* ws = hs + F::NHS;

  const int t = threadIdx.x;
  __builtin_assume(t < FNT);  // so the compiler sees which items exist for every thread
  const int h0 = blockIdx.z * FH, w0 = blockIdx.y * FW, d0 = blockIdx.x * FD;

  // 1. the image halo at clamped coordinates, one warp per (h, w) row
  for (int row = t >> 5; row < XH * XW; row += FNT / 32) {
    const int gh = clampi(h0 - B + row / XW, 0, H - 1);
    const int gw = clampi(w0 - B + row % XW, 0, W - 1);
    const T* src = x + ((size_t)gh * W + gw) * D;
    float* dst = xs + row * XD;
    for (int e = t & 31; e < XD; e += 32) dst[e] = Io<T>::ld(src + clampi(d0 - B + e, 0, D - 1));
  }

  // 2. the halo index of each difference item's two voxels (the centre of
  // the shifts): its place in the region grown by R, clamped into the
  // volume first, which applies the diff array's replicate border
  const int lo_h = max(0, R - h0), hi_h = min(EH - 1, H - 1 - h0 + R);
  const int lo_w = max(0, R - w0), hi_w = min(EW - 1, W - 1 - w0 + R);
  const int lo_d = max(0, R - d0), hi_d = min(2 * EP - 1, D - 1 - d0 + R);
  // (the halo has fewer than 2^16 elements: the first voxel's index in the
  // low half, the step to the second, 0 or 1, in the high half)
  int xab[F::IDIFF];
#pragma unroll
  for (int it = 0; it < F::IDIFF; ++it) {
    const int e = t + it * FNT;
    const int ep = e % EP, ew = (e / EP) % EW, eh = e / (EP * EW);
    const int base = ((clampi(eh, lo_h, hi_h) + DIL) * XW + clampi(ew, lo_w, hi_w) + DIL) * XD + DIL;
    const int d0c = clampi(2 * ep, lo_d, hi_d);
    xab[it] = (base + d0c) | ((clampi(2 * ep + 1, lo_d, hi_d) - d0c) << 16);
  }

  const int p = t & 31, w = (t >> 5) % FW, i0 = 2 * (t / (32 * FW));
  P ssd[F::HOLD_SMEM ? 1 : NPAIR][2];
  P* held = ws + F::NWS;  // [NPAIR][2][FNT] with HOLD_SMEM
  auto hold = [&](int c, int q) -> P& {
    if constexpr (F::HOLD_SMEM) return held[(c * 2 + q) * FNT + t];
    else return ssd[c][q];
  };
  __syncthreads();

#pragma unroll
  for (int c = 0; c < NPAIR; ++c) {
    const int o1 = shift_offset(c, 0, DIL, XW, XD), o2 = shift_offset(c, 1, DIL, XW, XD);
    // squared differences on the grown region
#pragma unroll
    for (int it = 0; it < F::IDIFF; ++it) {
      const int e = t + it * FNT;
      if (e < F::NDIFF) {
        const int xa = xab[it] & 0xffff, xb = xa + (xab[it] >> 16);
        const P d = PO::make(__fsub_rn(xs[xa + o1], xs[xa + o2]), __fsub_rn(xs[xb + o1], xs[xb + o2]));
        dif[e] = PO::mul(d, d);
      }
    }
    __syncthreads();
    // window sums along H
#pragma unroll
    for (int it = 0; it < F::IHS; ++it) {
      const int e = t + it * FNT;
      if (e < F::NHS) {
        P acc = dif[e];
#pragma unroll
        for (int j = 1; j < F::K; ++j) acc = PO::add(acc, dif[e + j * EW * EP]);
        hs[e] = acc;
      }
    }
    __syncthreads();
    // window sums along W
#pragma unroll
    for (int it = 0; it < F::IWS; ++it) {
      const int e = t + it * FNT;
      if (e < F::NWS) {
        const int src = e + (e / (FW * EP)) * (2 * R * EP);
        P acc = hs[src];
#pragma unroll
        for (int j = 1; j < F::K; ++j) acc = PO::add(acc, hs[src + j * EP]);
        ws[e] = acc;
      }
    }
    __syncthreads();
    // window sums along D and the mean, into registers: term j of output
    // pair p is the pair that starts at element 2p + j
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const P* row = ws + ((i0 + q) * FW + w) * EP + p;
      P acc = row[0];
#pragma unroll
      for (int j = 1; j < F::K; ++j)
        acc = PO::add(acc, (j & 1) ? PO::odd(row[j >> 1], row[(j >> 1) + 1]) : row[j >> 1]);
      hold(c, q) = PO::mean(acc, K3, RK3);
    }
  }

  // 3. channel min, mind and the channel-mean variance
  const size_t hwd = (size_t)H * W * D;
  const bool pairs = (D & 1) == 0;  // aligned pair stores
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int gh = h0 + i0 + q, gw = w0 + w, gd = d0 + 2 * p;
    if (gh >= H || gw >= W || gd >= D) continue;
    const bool both = gd + 1 < D;
    const size_t idx = ((size_t)gh * W + gw) * D + gd;
    P m = hold(0, q);
#pragma unroll
    for (int c = 1; c < NPAIR; ++c) m = PO::min(m, hold(c, q));
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int c = 0; c < NPAIR; ++c) {
      const P mc = PO::sub(hold(c, q), m);
      T* o = mind + c * hwd + idx;
      if (pairs) {
        PO::st2(o, mc);
      } else {
        PO::st_lo(o, mc);
        if (both) PO::st_hi(o + 1, mc);
      }
      v0 = c == 0 ? PO::lo(mc) : __fadd_rn(v0, PO::lo(mc));
      v1 = c == 0 ? PO::hi(mc) : __fadd_rn(v1, PO::hi(mc));
    }
    const float2 vv = make_float2(__fdiv_rn(v0, (float)NPAIR), __fdiv_rn(v1, (float)NPAIR));
    if (pairs) {
      *reinterpret_cast<float2*>(var + idx) = vv;
    } else {
      var[idx] = vv.x;
      if (both) var[idx + 1] = vv.y;
    }
  }
}

template <typename T, int R, int DIL>
int launch_fixed(const void* x, void* mind, void* var, int H, int W, int D, cudaStream_t stream) {
  const size_t smem = Fixed<T, R, DIL>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      mind_kernel<T, R, DIL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + FD - 1) / FD, (W + FW - 1) / FW, (H + FH - 1) / FH);
  mind_kernel<T, R, DIL><<<grid, FNT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(mind), static_cast<float*>(var), H, W, D);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mind_general_kernel: runtime radius and dilation
// ---------------------------------------------------------------------------

constexpr int TH = 4;
constexpr int TW = 8;
constexpr int TD = 32;
constexpr int NT = TW * TD;  // thread t owns voxels (i, t / TD, t % TD), i < TH

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
mind_general_kernel(const T* __restrict__ x, T* __restrict__ mind, float* __restrict__ var,
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
int launch_general(const void* x, void* mind, void* var, int H, int W, int D, int r, int dil,
                   const void* offs_host, cudaStream_t stream) {
  PairOffsets offs;
  memcpy(&offs, offs_host, sizeof(offs));
  const int b = r + dil;
  const size_t smem = smem_floats(r, b) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mind_general_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + TD - 1) / TD, (W + TW - 1) / TW, (H + TH - 1) / TH);
  mind_general_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(mind), static_cast<float*>(var),
      H, W, D, r, b, offs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* mind, void* var, int H, int W, int D, int r, int dil,
           const void* offs, cudaStream_t s) {
  switch (r * 4 + dil) {
    case 1 * 4 + 1: return launch_fixed<T, 1, 1>(x, mind, var, H, W, D, s);
    case 1 * 4 + 2: return launch_fixed<T, 1, 2>(x, mind, var, H, W, D, s);
    case 1 * 4 + 3: return launch_fixed<T, 1, 3>(x, mind, var, H, W, D, s);
    case 2 * 4 + 1: return launch_fixed<T, 2, 1>(x, mind, var, H, W, D, s);
    case 2 * 4 + 2: return launch_fixed<T, 2, 2>(x, mind, var, H, W, D, s);
    case 2 * 4 + 3: return launch_fixed<T, 2, 3>(x, mind, var, H, W, D, s);
    case 3 * 4 + 1: return launch_fixed<T, 3, 1>(x, mind, var, H, W, D, s);
    case 3 * 4 + 2: return launch_fixed<T, 3, 2>(x, mind, var, H, W, D, s);
    case 3 * 4 + 3: return launch_fixed<T, 3, 3>(x, mind, var, H, W, D, s);
    default: return launch_general<T>(x, mind, var, H, W, D, r, dil, offs, s);
  }
}

}  // namespace

// x (H, W, D) and mind (12, H, W, D) are float32 (bf16 == 0) or bfloat16
// (bf16 == 1); var (H, W, D) is float32.  offs holds 12 x 2 x 3 ints (read
// by the general kernel only).
extern "C" int mind_ssd_stats(const void* x, void* mind, void* var, int H, int W, int D,
                              int r, int dil, int bf16, const void* offs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, mind, var, H, W, D, r, dil, offs, s);
  return launch<float>(x, mind, var, H, W, D, r, dil, offs, s);
}
