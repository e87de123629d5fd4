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
// mind_general_kernel<T, HALO> takes any radius and dilation at run time
// (every pair outside {1, 2, 3}^2: kernels/mind.py:kernel_for), on the same
// tile, threads, pair arithmetic and rounding.  Per channel, in a loop over
// the channels (so one build serves every pair):
//   1. the squared differences, streamed along H: a thread takes one column
//      (w, voxel pair) of the tile's W x D region grown by r, and adds each
//      of its FH + 2r rows, in ascending order, to the register sums of the
//      planes whose window holds the row; the sums go to shared memory, so
//      the difference region itself is never stored;
//   2. the window sums along W, shared memory to shared memory;
//   3. the window sums along D and the mean into registers, then to the
//      thread's slots of the box means in shared memory, where they wait
//      for the channel min: the 12-channel volume is written once.
// Index work is done once per column item (its clamped halo or image offsets)
// and once per row (a clamp); the 12 pair offsets come from pair_code and
// the dilation once per channel; no pass divides an index.  The staging is
// chosen at launch from (r, d) by kernels/mind.py:general_plan:
//   HALO: the image halo grown by r + d on every side, stored as T, in
//      shared memory, where it fits beside the sums and the box means
//      ((4, 1): 37 + 14 + 48 KB in bf16, so two CTAs share an SM; 75 + 28 +
//      96 KB in float32);
//   else the four operands of a difference are read from the image in
//      global memory at clamped coordinates (through L1; a 192^3 image is 14
//      MB in bf16 or 28 MB in f32, so it stays in the 50 MB L2).
// A radius whose H sums do not fit is run in chunks of W columns, each
// chunk's W sums added to the earlier chunks' in ascending order, so shared
// memory grows with r, not r^2 (up to r = 433 in float32, 1240 in bf16).
// The bf16 mean multiplies by the reciprocal of k^3 up to k = 19
// (RECIP_MAX_R) and divides beyond.
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
  static __device__ __forceinline__ P div(P a, float k3) {
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
  // the box mean as a true division, for any k
  static __device__ __forceinline__ P div(P a, float k3) {
    return make(__fdiv_rn(lo(a), k3), __fdiv_rn(hi(a), k3));
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
// mind_general_kernel<T, HALO>: runtime radius and dilation
// ---------------------------------------------------------------------------

// Up to this radius (k = 2r + 1 <= 19) the general kernel's bf16 box mean
// multiplies by the float reciprocal of k^3 (Pair<__nv_bfloat16>::mean's
// argument holds for k^3 < 2^13); beyond it, it divides.
constexpr int RECIP_MAX_R = 9;

// Bytes of the general kernel's halo in T (HALO; rounded up to 16 bytes),
// after which its H sums start in shared memory
template <typename T, bool HALO>
__host__ __device__ int general_halo_bytes(int r, int dil) {
  const int b = r + dil;
  return HALO ? ((FH + 2 * b) * (FW + 2 * b) * (FD + 2 * b) * (int)sizeof(T) + 15) / 16 * 16 : 0;
}

// the voxel offset (dilation applied) of shift s (0 or 1) of pair c along
// each axis
__device__ __forceinline__ void shift_axes(int c, int s, int dil, int& oh, int& ow, int& od) {
  const int code = s == 0 ? pair_code(c) / 27 : pair_code(c) % 27;
  oh = (code / 9 - 1) * dil;
  ow = ((code / 3) % 3 - 1) * dil;
  od = (code % 3 - 1) * dil;
}

// bf16 with the halo staged: two CTAs an SM (at most 64 registers; (4, 1)
// takes 99 KB of shared memory); otherwise one, at up to 128 registers
template <typename T, bool HALO>
__host__ __device__ constexpr int general_ctas() { return sizeof(T) == 2 && HALO ? 2 : 1; }

template <typename T, bool HALO>
__global__ void __launch_bounds__(FNT, (general_ctas<T, HALO>()))
mind_general_kernel(const T* __restrict__ x, T* __restrict__ mind, float* __restrict__ var, int H,
                    int W, int D, int r, int dil, int CW) {
  using PO = Pair<T>;
  using P = typename PO::P;
  extern __shared__ float4 smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // the halo (HALO), as stored
  // the H sums' region (EW columns along W, EP voxel pairs along D) and the
  // halo's extents along W and D (HALO); CW columns a W chunk
  const int b = r + dil, EW = FW + 2 * r, EP = FD / 2 + r;
  const int XW = FW + 2 * b, XD = FD + 2 * b, XWD = XW * XD;
  P* hs = reinterpret_cast<P*>(reinterpret_cast<char*>(smem_raw) +
                               general_halo_bytes<T, HALO>(r, dil));  // [FH][CW][EP]
  P* ws = hs + FH * CW * EP;    // [FH][FW][EP]
  P* held = ws + FH * FW * EP;  // the box means, [NPAIR][2][FNT]
  const float k3 = (float)((long long)(2 * r + 1) * (2 * r + 1) * (2 * r + 1));
  const float rk3 = 1.0f / k3;
  const bool recip = sizeof(T) == 2 && r <= RECIP_MAX_R;

  const int t = threadIdx.x;
  const int h0 = blockIdx.z * FH, w0 = blockIdx.y * FW, d0 = blockIdx.x * FD;
  if constexpr (HALO) {
    // the image at clamped coordinates, grown by b on every side: a warp
    // takes SR (h, w) rows at a time, 2 elements of each a lane, and issues
    // all their loads before its stores
    constexpr int SR = 4, NW = FNT / 32;
    const int nrow = (FH + 2 * b) * XW;
    for (int row0 = t >> 5; row0 < nrow; row0 += SR * NW) {
      for (int e0 = t & 31; e0 < XD; e0 += 64) {
        T v[SR][2];
#pragma unroll
        for (int u = 0; u < SR; ++u) {
          const int row = min(row0 + u * NW, nrow - 1);
          const T* src = x + ((size_t)clampi(h0 - b + row / XW, 0, H - 1) * W +
                              clampi(w0 - b + row % XW, 0, W - 1)) * D;
#pragma unroll
          for (int k = 0; k < 2; ++k)
            v[u][k] = src[clampi(d0 - b + min(e0 + 32 * k, XD - 1), 0, D - 1)];
        }
#pragma unroll
        for (int u = 0; u < SR; ++u)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (row0 + u * NW < nrow && e0 + 32 * k < XD)
              xs[(row0 + u * NW) * XD + e0 + 32 * k] = v[u][k];
      }
    }
  }
  // the difference region (the tile grown by r) clamped into the volume:
  // the diff array's replicate border
  const int lo_h = max(0, r - h0), hi_h = min(FH + 2 * r - 1, H - 1 - h0 + r);
  const int lo_w = max(0, r - w0), hi_w = min(EW - 1, W - 1 - w0 + r);
  const int lo_d = max(0, r - d0), hi_d = min(2 * EP - 1, D - 1 - d0 + r);
  // items of the H and W passes: index e = column * EP + pair, stepped by
  // FNT without a division
  const int col0 = t / EP, pair0 = t - col0 * EP;
  const int col_step = FNT / EP, pair_step = FNT - col_step * EP;
  const size_t WD = (size_t)W * D;

  const int p = t & 31, w = (t >> 5) % FW, i0 = 2 * (t / (32 * FW));
  auto hold = [&](int c, int q) -> P& { return held[(c * 2 + q) * FNT + t]; };
  const P zero = PO::make(0.f, 0.f);
  if constexpr (HALO) __syncthreads();

#pragma unroll 1
  for (int c = 0; c < NPAIR; ++c) {
    int s1h, s1w, s1d, s2h, s2w, s2d;
    shift_axes(c, 0, dil, s1h, s1w, s1d);
    shift_axes(c, 1, dil, s2h, s2w, s2d);
    const int o1 = (s1h * XW + s1w) * XD + s1d, o2 = (s2h * XW + s2w) * XD + s2d;
    for (int c0 = 0; c0 < EW; c0 += CW) {
      const int ncol = min(CW, EW - c0);
      // 1. squared differences streamed along H into each column's FH
      // window sums, rows added in ascending order (the region's row i
      // goes to the sums of planes i - 2r .. i); a sum starts at 0, and
      // 0 + d^2 == d^2
      int col = col0, pair = pair0;
      while (col < ncol) {
        const int ew = c0 + col;
        // the two voxels' centres (clamped into the volume): with HALO their
        // halo index at row 0, else the in-plane offsets of the four operands
        int ia = 0, ib = 0, a0 = 0, a1 = 0, b0 = 0, b1 = 0;
        if constexpr (HALO) {
          const int da = clampi(2 * pair, lo_d, hi_d);
          ia = (clampi(ew, lo_w, hi_w) + dil) * XD + da + dil;
          ib = ia + clampi(2 * pair + 1, lo_d, hi_d) - da;
        } else {
          const int uw = w0 - r + clampi(ew, lo_w, hi_w);
          const int ud0 = d0 - r + clampi(2 * pair, lo_d, hi_d);
          const int ud1 = d0 - r + clampi(2 * pair + 1, lo_d, hi_d);
          // (in-plane offsets: W * D < 2^31, checked at launch)
          a0 = clampi(uw + s1w, 0, W - 1) * D + clampi(ud0 + s1d, 0, D - 1);
          a1 = clampi(uw + s1w, 0, W - 1) * D + clampi(ud1 + s1d, 0, D - 1);
          b0 = clampi(uw + s2w, 0, W - 1) * D + clampi(ud0 + s2d, 0, D - 1);
          b1 = clampi(uw + s2w, 0, W - 1) * D + clampi(ud1 + s2d, 0, D - 1);
        }
        auto dif = [&](int i) -> P {
          float u0, u1;
          if constexpr (HALO) {
            const int rb = (clampi(i, lo_h, hi_h) + dil) * XWD;
            u0 = __fsub_rn(Io<T>::ld(xs + rb + ia + o1), Io<T>::ld(xs + rb + ia + o2));
            u1 = __fsub_rn(Io<T>::ld(xs + rb + ib + o1), Io<T>::ld(xs + rb + ib + o2));
          } else {
            const int uh = h0 - r + clampi(i, lo_h, hi_h);
            const T* ra = x + (size_t)clampi(uh + s1h, 0, H - 1) * WD;
            const T* rb = x + (size_t)clampi(uh + s2h, 0, H - 1) * WD;
            u0 = __fsub_rn(Io<T>::ld(ra + a0), Io<T>::ld(rb + b0));
            u1 = __fsub_rn(Io<T>::ld(ra + a1), Io<T>::ld(rb + b1));
          }
          const P d = PO::make(u0, u1);
          return PO::mul(d, d);
        };
        P acc[FH];
#pragma unroll
        for (int h = 0; h < FH; ++h) acc[h] = zero;
        if (2 * r + 1 >= FH) {
          // rows 0 .. FH-2 reach planes 0 .. i, rows FH-1 .. 2r every
          // plane, rows 2r + j (j = 1 .. FH-1) planes j .. FH-1
#pragma unroll
          for (int i = 0; i < FH - 1; ++i) {
            const P v = dif(i);
#pragma unroll
            for (int h = 0; h <= i; ++h) acc[h] = PO::add(acc[h], v);
          }
          for (int i = FH - 1; i <= 2 * r; ++i) {
            const P v = dif(i);
#pragma unroll
            for (int h = 0; h < FH; ++h) acc[h] = PO::add(acc[h], v);
          }
#pragma unroll
          for (int j = 1; j < FH; ++j) {
            const P v = dif(2 * r + j);
#pragma unroll
            for (int h = j; h < FH; ++h) acc[h] = PO::add(acc[h], v);
          }
        } else {
          for (int i = 0; i < FH + 2 * r; ++i) {
            const P v = dif(i);
#pragma unroll
            for (int h = 0; h < FH; ++h)
              if ((unsigned)(i - h) <= (unsigned)(2 * r)) acc[h] = PO::add(acc[h], v);
          }
        }
#pragma unroll
        for (int h = 0; h < FH; ++h) hs[(h * CW + col) * EP + pair] = acc[h];
        col += col_step;
        pair += pair_step;
        if (pair >= EP) pair -= EP, ++col;
      }
      __syncthreads();
      // 2. window sums along W of this chunk's columns, added to the
      // earlier chunks' (ascending offsets: the chunks come in order)
      col = col0, pair = pair0;
      for (int e = t; e < FH * FW * EP; e += FNT) {
        const int h = col / FW, ww = col % FW;  // e = (h * FW + ww) * EP + pair
        const int j0 = max(0, c0 - ww), j1 = min(2 * r, c0 + ncol - 1 - ww);
        const P* src = hs + (h * CW + ww - c0) * EP + pair;
        P acc = c0 == 0 ? zero : ws[e];
        for (int j = j0; j <= j1; ++j) acc = PO::add(acc, src[j * EP]);
        ws[e] = acc;
        col += col_step;
        pair += pair_step;
        if (pair >= EP) pair -= EP, ++col;
      }
      __syncthreads();
    }
    // 3. window sums along D and the mean, into registers: term j of output
    // pair p is the pair that starts at element 2p + j
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const P* row = ws + ((i0 + q) * FW + w) * EP + p;
      P cur = row[0], acc = cur;
      for (int m = 0; m < r; ++m) {
        const P nxt = row[m + 1];
        acc = PO::add(PO::add(acc, PO::odd(cur, nxt)), nxt);
        cur = nxt;
      }
      hold(c, q) = recip ? PO::mean(acc, k3, rk3) : PO::div(acc, k3);
    }
  }

  // 4. channel min, mind and the channel-mean variance
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

// Shared memory of the general kernel, in bytes: the halo, then the H sums
// of a chunk of cw columns, the W sums and the box means, as voxel pairs of
// T.  kernels/mind.py:general_plan repeats it.
template <typename T, bool HALO>
size_t general_smem(int r, int dil, int cw) {
  return general_halo_bytes<T, HALO>(r, dil) +
         sizeof(typename Pair<T>::P) * ((size_t)FH * (FD / 2 + r) * (cw + FW) + NPAIR * 2 * FNT);
}

template <typename T, bool HALO>
int launch_general_as(const void* x, void* mind, void* var, int H, int W, int D, int r, int dil,
                      int cw, cudaStream_t stream) {
  const size_t smem = general_smem<T, HALO>(r, dil, cw);
  cudaError_t err = cudaFuncSetAttribute(
      mind_general_kernel<T, HALO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + FD - 1) / FD, (W + FW - 1) / FW, (H + FH - 1) / FH);
  mind_general_kernel<T, HALO><<<grid, FNT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(mind), static_cast<float*>(var), H, W, D, r, dil,
      cw);
  return (int)cudaGetLastError();
}

// halo: stage the image in shared memory; cw: columns of one W chunk (both
// chosen by kernels/mind.py:general_plan so that shared memory fits)
template <typename T>
int launch_general(const void* x, void* mind, void* var, int H, int W, int D, int r, int dil,
                   int halo, int cw, cudaStream_t stream) {
  if (r < 0 || dil < 0 || cw < 1 || cw > FW + 2 * r || (long long)W * D >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return halo ? launch_general_as<T, true>(x, mind, var, H, W, D, r, dil, cw, stream)
              : launch_general_as<T, false>(x, mind, var, H, W, D, r, dil, cw, stream);
}

// A compiled instance for its own (r, dil) only; general == 1 runs the
// general kernel for any pair.
template <typename T>
int launch(const void* x, void* mind, void* var, int H, int W, int D, int r, int dil, int general,
           int halo, int cw, cudaStream_t s) {
  if (general) return launch_general<T>(x, mind, var, H, W, D, r, dil, halo, cw, s);
  if (r == 1 && dil == 1) return launch_fixed<T, 1, 1>(x, mind, var, H, W, D, s);
  if (r == 1 && dil == 2) return launch_fixed<T, 1, 2>(x, mind, var, H, W, D, s);
  if (r == 1 && dil == 3) return launch_fixed<T, 1, 3>(x, mind, var, H, W, D, s);
  if (r == 2 && dil == 1) return launch_fixed<T, 2, 1>(x, mind, var, H, W, D, s);
  if (r == 2 && dil == 2) return launch_fixed<T, 2, 2>(x, mind, var, H, W, D, s);
  if (r == 2 && dil == 3) return launch_fixed<T, 2, 3>(x, mind, var, H, W, D, s);
  if (r == 3 && dil == 1) return launch_fixed<T, 3, 1>(x, mind, var, H, W, D, s);
  if (r == 3 && dil == 2) return launch_fixed<T, 3, 2>(x, mind, var, H, W, D, s);
  if (r == 3 && dil == 3) return launch_fixed<T, 3, 3>(x, mind, var, H, W, D, s);
  return (int)cudaErrorInvalidValue;  // no instance compiled for (r, dil)
}

}  // namespace

// x (H, W, D) and mind (12, H, W, D) are float32 (bf16 == 0) or bfloat16
// (bf16 == 1); var (H, W, D) is float32.  general == 0 runs mind_kernel<T,
// r, dil>, which exists for (r, dil) in {1, 2, 3}^2 (any other pair is
// refused); general == 1 runs mind_general_kernel<T, halo> with W chunks of
// cw columns.
extern "C" int mind_ssd_stats(const void* x, void* mind, void* var, int H, int W, int D, int r,
                              int dil, int general, int halo, int cw, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(x, mind, var, H, W, D, r, dil, general, halo, cw, s);
  return launch<float>(x, mind, var, H, W, D, r, dil, general, halo, cw, s);
}
