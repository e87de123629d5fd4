// The cost volume's zero-padded 3^3 box passes: convexadam_torch/kernels/box.py.
//
// Replaces no Pallas kernel: the JAX package smooths its cost volume with
// XLA (convexadam_tpu/core/cost_volume.py:correlate), and the port ran
// F.avg_pool3d(x, 3, stride 1, padding 1) once a pass, each pass reading and
// writing the whole volume.  This kernel reads the raw costs once and writes
// the costs after one or two passes once; the first pass's values stay in
// shared memory.
//
// What it computes (box_mean3): for each channel of a float32 (C, h, w, d)
// volume, PASSES zero-padded 3^3 box means, each bit-equal to F.avg_pool3d
// on the card: an output adds its window's 27 terms one at a time in ATen's
// order (h outermost, then w, then d, each ascending) from +0.0f, and
// divides the sum by 27.0f (__fdiv_rn: IEEE division, no reciprocal).  ATen
// skips the window's positions outside the volume; here they are +0.0f,
// which changes no sum: a sum begun at +0.0f is never -0.0f, so adding +0.0f
// returns it unchanged (an inf or a NaN stays one).  The second pass reads
// the first pass's values with zeros outside the volume, as a second
// F.avg_pool3d reads its input.
//
// Bound: the volume read once and written once, 2 V 4 bytes at 3.35 TB/s;
// the 27 rounded adds an element a pass (54 for two) at 33.5 T float32
// operations a second stay under it.  On an H100 the two-pass kernel runs
// at about 40% of that bound: its issue slots go to the adds, the IEEE
// divisions (about ten instructions each, with the check for the slow
// path) and the window's loads, about twice the adds' own.
//
// Design: a block owns one channel's tile of (w, d) columns and walks its h
// planes (a segment of them where the card would otherwise hold too few
// blocks).  Each raw plane of the tile, grown by the passes' reach, comes
// into a ring of NSTAGE planes of shared memory by cp.async, in chunks of
// 16, 8 or 4 bytes as d's alignment allows, NSTAGE - 1 planes ahead of the
// one being summed, so the loads overlap the adds.  A thread owns RY
// outputs along w at one d; neighbouring threads own neighbouring d, so a
// warp's shared-memory reads and global stores are contiguous, and a thread
// loads each value of its window's columns once a plane for the RY outputs
// it serves.  A plane that arrives is added to the three accumulators (in
// registers) of the output planes whose windows hold it: output plane o
// takes plane o - 1 first, then o, then o + 1, which is ATen's order since
// the planes come in order; its 9 terms an output come in (w, d) order.  An
// output plane that has taken its third plane is divided and stored: the
// first pass's into shared memory (two planes: the second pass reads one, a
// step after it was written, while the next is written, so one barrier a
// step orders both rings), the second's to global memory.  Where a tile is
// cut along w (d), the first pass covers it grown by one row (column) on
// each side and the second pass's last two rows (columns) of threads are
// spare; an uncut tile spans the extent and needs no grown values (zeros
// lie beyond it).  The launch shape (the threads' rows and columns, the
// cuts, the h segments) comes from the volume's shape
// (kernels/box.py:launch_plan).

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int RY = 4;           // outputs a thread along w
constexpr int NSTAGE = 4;       // raw planes in the shared-memory ring
constexpr int MAX_THREADS = 512;

// the launch's shape: ty rows of threads (RY outputs each) by tz columns;
// sy (sz) 1 where tiles cut the w (d) extent, 0 where one tile spans it (two
// passes; one pass never grows its tile); ntw x ntd tiles; h in nseg
// segments of seg planes
struct Plan {
  int ty, tz, sy, sz, ntw, ntd, nseg, seg;
};

// asynchronous copy of VW floats from global to shared memory (address dst),
// of which the first `bytes` are read and the rest zero-filled
template <int VW>
__device__ __forceinline__ void copy_chunk(unsigned dst, const float* src, int bytes) {
  if constexpr (VW == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else if constexpr (VW == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread's copies but the NSTAGE - 2 latest is done
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 2) : "memory");
}

// one plane into the three accumulators of every output row i of the
// thread: s points at the thread's window (row 0, column 0) in a plane of
// row stride rw; output i takes rows i, i + 1, i + 2, each's three columns
// in order
__device__ __forceinline__ void add_plane(const float* s, int rw, float (&acc)[3][RY]) {
#pragma unroll
  for (int r = 0; r < RY + 2; ++r) {
    const float v0 = s[r * rw], v1 = s[r * rw + 1], v2 = s[r * rw + 2];
#pragma unroll
    for (int i = 0; i < RY; ++i) {
      if (r - i < 0 || r - i > 2) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        acc[k][i] = __fadd_rn(__fadd_rn(__fadd_rn(acc[k][i], v0), v1), v2);
    }
  }
}

// the row stride of a plane in shared memory for tz thread columns (a
// multiple of 16) and chunks of VW floats: room for the window's tz + 2
// columns and a chunk's alignment (VW - 1 more), in 16-byte rows for VW = 4;
// and 4 more than a multiple of 8, so that RY = 4 rows lie 16 banks apart
// and a warp that holds the ends of two thread rows (tz an odd multiple of
// 16) reads 32 banks
template <int VW>
__host__ __device__ constexpr int row_stride(int tz) {
  return VW == 4 ? tz + 12 : tz + 4;
}
static_assert(RY * row_stride<1>(16) % 32 == 16 && RY * row_stride<4>(16) % 32 == 16,
              "rows of neighbouring thread rows must lie 16 banks apart");

template <int PASSES, int VW>
__global__ void __launch_bounds__(MAX_THREADS) box_mean3_kernel(
    const float* __restrict__ in, float* __restrict__ out, int h, int w, int d, Plan pl) {
  extern __shared__ __align__(16) float smem[];
  const int rh = RY * pl.ty + 2, rw = row_stride<VW>(pl.tz), plane = rh * rw;
  float* ring = smem;
  float* mid = smem + NSTAGE * plane;  // two planes of first-pass values (PASSES == 2)
  unsigned b = blockIdx.x;
  const int td = b % pl.ntd;
  b /= pl.ntd;
  const int tw = b % pl.ntw;
  b /= pl.ntw;
  const int sg = b % pl.nseg;
  const long long c = b / pl.nseg;
  const int cy = PASSES == 2 ? pl.sy : 0, cz = PASSES == 2 ? pl.sz : 0;
  const int tile_w = RY * pl.ty - 2 * cy, tile_d = pl.tz - 2 * cz;  // outputs a tile
  const int y0 = tw * tile_w, z0 = td * tile_d;
  const int y1 = y0 - cy, z1 = z0 - cz;  // the first pass's first row and column
  const int ry0 = y1 - 1, rz0 = z1 - 1;  // the raw tile's
  // the raw tile in shared memory starts at column zb, rz0 or the multiple
  // of VW before it, so that every chunk is aligned: zoff columns early
  const int zoff = ((rz0 % VW) + VW) % VW, zb = rz0 - zoff;
  const int ylim = min(y0 + tile_w, w), zlim = min(z0 + tile_d, d);
  const int xa = sg * pl.seg, xb = min(xa + pl.seg, h);
  const int nt = pl.ty * pl.tz, t = threadIdx.x, ty = t / pl.tz, tz = t % pl.tz;
  const long long wd = (long long)w * d;
  const float* src = in + c * h * wd;
  float* dst = out + c * h * wd;

  // this thread's copies of a raw plane: chunk columns cc, cc + ncc, ... of
  // the rw / VW a row, in rows r0, r0 + rstep, ... (threads past rstep * ncc
  // copy nothing)
  const int nch = rw / VW, ncc = min(nch, nt), rstep = nt / ncc;
  const int r0 = t / ncc, cc0 = t % ncc;
  const unsigned ring_addr = (unsigned)__cvta_generic_to_shared(ring);
  auto issue = [&](int p, int stage) {
    if (p >= 0 && p < h && r0 < rstep) {
      const float* pp = src + p * wd;
      const unsigned base = ring_addr + 4u * (unsigned)(stage * plane);
      for (int r = r0; r < rh; r += rstep) {
        const int y = ry0 + r;
        const bool yin = y >= 0 && y < w;
        for (int cc = cc0; cc < nch; cc += ncc) {
          const int z = zb + cc * VW;
          const int n = yin && z >= 0 ? max(min(d - z, VW), 0) : 0;  // floats in the volume
          copy_chunk<VW>(base + 4u * (unsigned)(r * rw + cc * VW),
                         n ? pp + (long long)y * d + z : pp, 4 * n);
        }
      }
    }
    commit_copies();
  };

  float a1[3][RY], a2[3][RY];  // first and second pass, output planes by slot
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < RY; ++i) a1[k][i] = a2[k][i] = 0.f;
  if (PASSES == 2)
    for (int e = t; e < 2 * plane; e += nt) mid[e] = 0.f;

  // the thread's window in a raw plane and in a first-pass one (whose
  // column 0 is z0 - 1)
  const int win_raw = RY * ty * rw + zoff + tz, win_mid = RY * ty * rw + tz;
  // raw planes p_first..raw_last come in; the walk goes on one plane past
  // them with two passes, whose second pass reads each first-pass plane one
  // step after it is written
  const int p_first = xa - PASSES, raw_last = xb + PASSES - 1;
  const int p_last = PASSES == 2 ? xb + 2 : xb;
  for (int k = 0; k < NSTAGE - 1; ++k) issue(p_first + k <= raw_last ? p_first + k : h, k);
  int stage = 0;  // the ring stage of the plane in hand
  // whether the first pass's plane q is read: in the volume, and next to
  // the segment's output planes
  auto used = [&](int q) { return q >= xa - 1 && q <= xb && q >= 0 && q < h; };

  // the output planes in hand: a1[j] holds the first pass's plane p - 1 + j
  // and a2[j] the second pass's p - 3 + j (one pass: p - 1 + j) as step p
  // begins; each step completes the planes in slot 0 and moves the rest down
  auto rotate = [](float(&acc)[3][RY]) {
#pragma unroll
    for (int i = 0; i < RY; ++i) {
      acc[0][i] = acc[1][i];
      acc[1][i] = acc[2][i];
      acc[2][i] = 0.f;
    }
  };
  auto finish = [&](int o, const float(&acc)[RY]) {
    if (o >= xa && o < xb && z0 + tz < zlim) {
      float* row = dst + o * wd + (long long)(y0 + RY * ty) * d + z0 + tz;
#pragma unroll
      for (int i = 0; i < RY; ++i)
        if (y0 + RY * ty + i < ylim) row[(long long)i * d] = __fdiv_rn(acc[i], 27.0f);
    }
  };
  for (int p = p_first; p <= p_last; ++p) {
    wait_ring();
    __syncthreads();
    const int ahead = p + NSTAGE - 1;
    issue(ahead <= raw_last ? ahead : h, (stage + NSTAGE - 1) % NSTAGE);
    const float* raw = ring + stage * plane + win_raw;
    stage = (stage + 1) % NSTAGE;
    const bool in_raw = p >= 0 && p < h && p <= raw_last;
    if (PASSES == 1) {
      if (in_raw) add_plane(raw, rw, a2);
      finish(p - 1, a2[0]);
      rotate(a2);
    } else {
      if (in_raw) add_plane(raw, rw, a1);
      const int q = p - 1;  // the first pass's plane q is complete
      if (used(q)) {
        const int z = z1 + tz;
        const bool zin = z >= 0 && z < d;
        float* col = mid + (q & 1) * plane + (1 - cy + RY * ty) * rw + 1 - cz + tz;
#pragma unroll
        for (int i = 0; i < RY; ++i) {
          const int y = y1 + RY * ty + i;
          col[i * rw] = zin && y >= 0 && y < w ? __fdiv_rn(a1[0][i], 27.0f) : 0.f;
        }
      }
      rotate(a1);
      // the first pass's plane p - 2, written a step ago (before this step's
      // barrier), into the second pass, whose plane p - 3 is then complete
      const int r = p - 2;
      if (used(r)) add_plane(mid + (r & 1) * plane + win_mid, rw, a2);
      finish(p - 3, a2[0]);
      rotate(a2);
    }
  }
}

template <int PASSES, int VW>
int launch(const float* in, float* out, int C, int h, int w, int d, Plan pl, cudaStream_t st) {
  static int granted[MAX_DEVICES] = {};
  const size_t planes = NSTAGE + (PASSES == 2 ? 2 : 0);
  const size_t smem = planes * (RY * pl.ty + 2) * row_stride<VW>(pl.tz) * sizeof(float);
  const int e = ensure_smem(box_mean3_kernel<PASSES, VW>, smem, granted);
  if (e != 0) return e;
  const unsigned blocks = (unsigned)C * pl.nseg * pl.ntw * pl.ntd;
  const int nt = pl.ty * pl.tz;
  box_mean3_kernel<PASSES, VW><<<blocks, nt, smem, st>>>(in, out, h, w, d, pl);
  return (int)cudaGetLastError();
}

template <int PASSES>
int dispatch(const float* in, float* out, int C, int h, int w, int d, Plan pl, cudaStream_t st) {
  // the widest chunk the rows' alignment allows: 16 bytes where d and the
  // pointer are whole float4s, else 8 where they are whole float2s
  const uintptr_t at = reinterpret_cast<uintptr_t>(in);
  if (d % 4 == 0 && at % 16 == 0)
    return launch<PASSES, 4>(in, out, C, h, w, d, pl, st);
  if (d % 2 == 0 && at % 8 == 0) return launch<PASSES, 2>(in, out, C, h, w, d, pl, st);
  return launch<PASSES, 1>(in, out, C, h, w, d, pl, st);
}

}  // namespace

// in and out: (C, h, w, d) float32, contiguous, not overlapping; out
// receives `passes` (1 or 2) box means of in.  The launch shape: ty x tz
// threads (at most 512), sy / sz 1 to cut the w / d extent into tiles of
// 4 ty - 2 sy rows and tz - 2 sz columns (two passes; one pass: 4 ty and tz),
// 0 for one tile that spans it (4 ty >= w, tz >= d); h in nseg segments.
extern "C" int box_mean3(const void* in, void* out, int C, int h, int w, int d, int passes,
                         int ty, int tz, int sy, int sz, int nseg, void* stream) {
  if (C < 1 || h < 1 || w < 1 || d < 1 || (passes != 1 && passes != 2) || ty < 1 || tz < 1 ||
      ty * tz > MAX_THREADS || (sy != 0 && sy != 1) || (sz != 0 && sz != 1) || nseg < 1 ||
      nseg > h)
    return (int)cudaErrorInvalidValue;
  const int cy = passes == 2 ? sy : 0, cz = passes == 2 ? sz : 0;
  const int tile_w = RY * ty - 2 * cy, tile_d = tz - 2 * cz;
  if (tile_w < 1 || tile_d < 1 || (passes == 2 && ((!sy && tile_w < w) || (!sz && tile_d < d))))
    return (int)cudaErrorInvalidValue;
  Plan pl{ty, tz, sy, sz, (w + tile_w - 1) / tile_w, (d + tile_d - 1) / tile_d, 0,
          (h + nseg - 1) / nseg};
  pl.nseg = (h + pl.seg - 1) / pl.seg;  // no segment left empty
  if ((long long)C * pl.nseg * pl.ntw * pl.ntd > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* ip = static_cast<const float*>(in);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return passes == 2 ? dispatch<2>(ip, op, C, h, w, d, pl, st)
                     : dispatch<1>(ip, op, C, h, w, d, pl, st);
}
