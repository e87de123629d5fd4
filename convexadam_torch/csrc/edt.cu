// Nearest-neighbour searches of the surface point-set HD95 engine: per query
// point, the least squared distance to a target point set.
//
// Replaces the TPU kernels of convexadam_tpu/ops/edt_pallas.py:
//   nearest_sq         <- nearest_sq_pallas -> _kernel
//   nearest_sq_dual    <- nearest_sq_dual_pallas -> _dual_kernel
//   nearest_sq_pruned  <- nearest_sq_pruned_pallas -> _pruned_kernel
//
// Points are (3, K) float32 rows of integer coordinates below 1024; buffer
// tails hold the pad 8192 = 2^13.  Every cell is a chain of FP32 adds and
// fused multiply-adds of -2t against q on the CUDA cores.  Between two real
// points every product and partial sum is an integer below 2^24, so a cell
// is exact and equals the plain PyTorch version's (|t|^2 + |q|^2) - 2 cross
// bit for bit, whatever the order of operations.  Entries outside the
// caller's meaningful ranges are not meaningful (the callers mask them), as
// in the JAX package.
//
// Bound on the H100: operations.  A cell costs about 8 FP32 operations and
// the searches read only (3, K) rows and write (K,) minima, so at the
// engine's sizes (K = 4096 to 65536 points) the distance arithmetic over the
// cells a search needs, at 67 TFLOP/s, is the floor.
//
// Design.  Targets are staged in shared memory as float4 (-2x, -2y, -2z,
// |t|^2), so one 16-byte shared load serves several cells of three FMAs and
// a min.  Targets at or past n_target are staged as (0, 0, 0, +inf) and
// never win.  The TPU walked its grid in order and could carry an
// accumulator from one grid step to the next; Hopper blocks run in no
// order, so
//  - nearest_sq and nearest_sq_dual run a 2-D grid (query blocks of 128 x
//    target chunks of 1024), so that K = 16384 fills the 132 SMs, and share
//    one body (sweep_tiles): each thread owns an 8 x 8 register micro-tile
//    of a 128 x 128 tile.  The tiled search's cell is three FMAs from |t|^2
//    and a row min, |q|^2 added once after the min; the dual's adds |q|^2
//    first (one add more) and also takes a column min, reduced over the CTA
//    once a tile through shared memory.  Row minima stay in registers over
//    a CTA's targets.  Both outputs are merged across CTAs with atomicMin on
//    the int bit pattern into outputs the caller fills with the init: every
//    value is >= 0, where the order of IEEE floats is that of their bits,
//    and min is order-free, so the result is deterministic.  Both stage a
//    chunk once (stage_chunk: plain loads, a thread's all issued first).
//    The tiled search's grid clamps the chunk axis to the card's 65535 and
//    a CTA strides over the chunks past it, so every K the engine can give
//    launches;
//  - nearest_sq_pruned runs every search of a batch in one launch (grid:
//    query blocks x searches, a device table of the searches' buffers,
//    offsets and counts), reading the queries and targets in place.  A
//    query block is one warp's 32 lanes and keeps its own bound: a narrow
//    block prunes as well as a wide one, and its tail walk costs a quarter
//    of the arithmetic.  The CTA's four warps take four tiles of the block's
//    precomputed order a step, one each, and meet once a step to merge
//    their minima and take the block's max-of-mins over meaningful queries;
//    the walk stops after the first step that holds a tile whose box bound
//    exceeds it.  The next step's bounds, tile coordinates and the tile
//    index after it are loaded while the current tile is evaluated, so a
//    step waits on no global read.
#include "common.cuh"

#include <math.h>

namespace {

constexpr float kInit = 4.0f * 8192.0f * 8192.0f;  // the JAX package's _ACC_INIT
constexpr unsigned kFull = 0xffffffffu;

struct Query {
  float x, y, z, n;
};

// A query at qi < live, else one whose norm, and so every whole cell, is +inf.
__device__ __forceinline__ Query load_query(const float* __restrict__ q, int Kq, int qi,
                                            int live) {
  if (qi < live) {
    const size_t K = Kq;
    const float x = q[qi], y = q[K + qi], z = q[2 * K + qi];
    return Query{x, y, z, __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z))};
  }
  return Query{0.f, 0.f, 0.f, INFINITY};
}

// |t|^2 + |q|^2 - 2 q.t: the whole cell, for minima over queries
__device__ __forceinline__ float cell(const float4 t, const Query& q) {
  return fmaf(q.z, t.z, fmaf(q.y, t.y, fmaf(q.x, t.x, __fadd_rn(t.w, q.n))));
}

// |t|^2 - 2 q.t: the cell without the query's norm, added after the min
__device__ __forceinline__ float cell_tq(const float4 t, float qx, float qy, float qz) {
  return fmaf(qz, t.z, fmaf(qy, t.y, fmaf(qx, t.x, t.w)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

constexpr int DT = 128;            // tiled and dual: queries per CTA, targets per tile
constexpr int DCH = 1024;          // tiled and dual: targets per chunk (the grid's second axis)
constexpr int DNT = 256;           // tiled and dual: threads per CTA, a 16 x 16 grid
constexpr int DR = DT / 16;        // queries per thread
constexpr int DC = DT / 16;        // targets per thread and tile
constexpr int DSTRIDE = DT + 16;   // dual: row stride of the column partials (a warp's two rows on disjoint banks)
constexpr int MAX_GRID_Y = 65535;  // the card's limit on gridDim.y
constexpr int QB = 32;             // pruned: queries per block, one a lane
constexpr int PT = 128;            // pruned: targets per tile
constexpr int PW = 4;              // pruned: warps per CTA, tiles per step
constexpr int PPL = PT / 32;       // pruned: targets a lane stages
constexpr int PCOLS = 7;           // pruned: q_src, q_off, t_src, t_off, q_lo, q_hi, n_target

// The chunk of DCH targets at c0 of a (3, Kt) buffer into tgt as (-2x, -2y,
// -2z, |t|^2), or as (0, 0, 0, +inf) at or past live: a thread's DCH / DNT
// targets, every load issued before the first is converted.  Rows are
// addressed in size_t: 3 Kt may pass 2^31.  The caller's barrier orders the
// stores before tgt is read.
__device__ __forceinline__ void stage_chunk(float4* __restrict__ tgt, const float* __restrict__ t,
                                            int Kt, int c0, int live) {
  constexpr int kPer = DCH / DNT;
  const size_t K = Kt;
  float x[kPer], y[kPer], z[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int idx = c0 + threadIdx.x + DNT * k;
    x[k] = y[k] = z[k] = 0.f;
    if (idx < live) {
      x[k] = t[idx];
      y[k] = t[K + idx];
      z[k] = t[2 * K + idx];
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const float n =
        __fadd_rn(__fadd_rn(__fmul_rn(x[k], x[k]), __fmul_rn(y[k], y[k])), __fmul_rn(z[k], z[k]));
    tgt[threadIdx.x + DNT * k] = c0 + (int)threadIdx.x + DNT * k < live
                                     ? make_float4(-2.f * x[k], -2.f * y[k], -2.f * z[k], n)
                                     : make_float4(0.f, 0.f, 0.f, INFINITY);
  }
}

// The body the tiled and the dual search share: a CTA's DT queries against
// the DT-target tiles [j_first, cend) of the chunk staged in tgt (its first
// target c0).  Thread (tx, ty) owns the queries ty + 16 r and, in each tile,
// the targets tx + 16 c, so a warp's 16-byte loads are 16 neighbouring
// float4.  Row minima go on in rmin: whole cells with kCols, else |t|^2 -
// 2 q.t, the query's norm added once after the chunks.  With kCols the
// column partials of each tile meet through colp (double-buffered, so one
// barrier a tile orders both the writes and the reads of two tiles back) and
// are merged into outt.
template <bool kCols>
__device__ __forceinline__ void sweep_tiles(const float4* __restrict__ tgt, const Query (&qq)[DR],
                                            float (&rmin)[DR], int c0, int j_first, int cend,
                                            int nt, float (*colp)[16][DSTRIDE],
                                            int* __restrict__ outt) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int buf = 0;
  for (int j0 = j_first; j0 < cend; j0 += DT) {
    const float4* tt = tgt + (j0 - c0);
    float cmin[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float4 tv = tt[tx + 16 * c];
      cmin[c] = INFINITY;
#pragma unroll
      for (int r = 0; r < DR; ++r) {
        if constexpr (kCols) {
          const float d = cell(tv, qq[r]);
          rmin[r] = fminf(rmin[r], d);
          cmin[c] = fminf(cmin[c], d);
        } else {
          rmin[r] = fminf(rmin[r], cell_tq(tv, qq[r].x, qq[r].y, qq[r].z));
        }
      }
    }
    if constexpr (kCols) {
#pragma unroll
      for (int c = 0; c < DC; ++c) colp[buf][ty][tx + 16 * c] = cmin[c];
      __syncthreads();
      if (threadIdx.x < DT) {
        float v = colp[buf][0][threadIdx.x];
#pragma unroll
        for (int r = 1; r < 16; ++r) v = fminf(v, colp[buf][r][threadIdx.x]);
        const int tj = j0 + threadIdx.x;
        if (tj < nt && v < kInit) atomicMin(outt + tj, __float_as_int(v));
      }
      buf ^= 1;
    }
  }
}

// Row minima over the 16 threads of a row (lanes tx of one half-warp),
// merged into outq; with add_norm the query's norm is added first.
// Queries at or past nq hold +inf and leave outq as it is.
__device__ __forceinline__ void merge_rows(const float (&rmin)[DR], const Query (&qq)[DR],
                                           bool add_norm, int* __restrict__ outq, int i0,
                                           int nq) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < DR; ++r) {
    float v = rmin[r];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
    if (add_norm) v = __fadd_rn(v, qq[r].n);
    const int qi = i0 + ty + 16 * r;
    if (tx == 0 && qi < nq && v < kInit) atomicMin(outq + qi, __float_as_int(v));
  }
}

__global__ void __launch_bounds__(DNT)
nearest_sq_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  int* __restrict__ out, int Kq, int Kt, const int* __restrict__ nq_p,
                  const int* __restrict__ nt_p) {
  __shared__ float4 tgt[DCH];
  const int i0 = blockIdx.x * DT;
  const int nq = min(*nq_p, Kq);
  const int nt = min(*nt_p, Kt);
  const int chunks = nt / DCH + (nt % DCH != 0);
  if (i0 >= nq || (int)blockIdx.y >= chunks) return;  // out holds the caller's init there
  const int ty = threadIdx.x >> 4;
  Query qq[DR];
  float rmin[DR];
#pragma unroll
  for (int r = 0; r < DR; ++r) {
    qq[r] = load_query(q, Kq, i0 + ty + 16 * r, nq);
    rmin[r] = INFINITY;
  }
  // chunks past the grid's y extent are taken in strides of it
  for (int k = blockIdx.y; k < chunks; k += gridDim.y) {
    const int c0 = k * DCH;
    if (k != (int)blockIdx.y) __syncthreads();  // every read of the last chunk is done
    stage_chunk(tgt, t, Kt, c0, nt);
    __syncthreads();
    sweep_tiles<false>(tgt, qq, rmin, c0, c0, min(c0 + DCH, nt), nt, nullptr, nullptr);
  }
  merge_rows(rmin, qq, true, out, i0, nq);
}

__global__ void __launch_bounds__(DNT)
nearest_sq_dual_kernel(const float* __restrict__ q, const float* __restrict__ t,
                       int* __restrict__ outq, int* __restrict__ outt, int Kq, int Kt,
                       const int* __restrict__ nq_p, const int* __restrict__ nt_p,
                       const int* __restrict__ hq_p, const int* __restrict__ ht_p) {
  __shared__ float4 tgt[DCH];
  __shared__ float colp[2][16][DSTRIDE];
  const int i0 = blockIdx.x * DT;
  const int nq = min(*nq_p, Kq);
  const int nt = min(*nt_p, Kt);
  const int chunks = nt / DCH + (nt % DCH != 0);
  if (i0 >= nq || (int)blockIdx.y >= chunks) return;  // both outputs hold the caller's init there
  const int ht = *ht_p;
  // a block wholly in the head query segment skips the tiles wholly in the
  // head target segment: the dead (head_q x head_t) corner, as the TPU kernel
  const bool head_rows = i0 + DT <= *hq_p;
  const int ty = threadIdx.x >> 4;
  // queries at or past n_query give +inf cells: they take no part in the
  // per-target minima
  Query qq[DR];
  float rmin[DR];
#pragma unroll
  for (int r = 0; r < DR; ++r) {
    qq[r] = load_query(q, Kq, i0 + ty + 16 * r, nq);
    rmin[r] = INFINITY;
  }
  // chunks past the grid's y extent are taken in strides of it, as the
  // tiled kernel takes them; the row minima go on across them, and every
  // minimum is merged by atomicMin, so the order does not matter
  bool staged = false;
  for (int k = blockIdx.y; k < chunks; k += gridDim.y) {
    const int c0 = k * DCH;
    const int cend = min(c0 + DCH, nt);
    int j_first = c0;
    while (head_rows && j_first < cend && j_first + DT <= ht) j_first += DT;
    if (j_first >= cend) continue;  // the same for every thread of the CTA
    if (staged) __syncthreads();    // every read of the last chunk and its partials is done
    stage_chunk(tgt, t, Kt, c0, nt);
    __syncthreads();
    sweep_tiles<true>(tgt, qq, rmin, c0, j_first, cend, nt, colp, outt);
    staged = true;
  }
  merge_rows(rmin, qq, false, outq, i0, nq);
}

// The point buffers of a batch of pruned searches: (3, ld[k]) rows.
struct Sources {
  const float* p[4];
  int ld[4];
};

// A lane's targets of one tile, as loaded from the buffer.
struct TileCoords {
  float x[PPL], y[PPL], z[PPL];
};

__device__ __forceinline__ void load_tile(TileCoords& c, const float* __restrict__ t, int ld,
                                          int tile, int lane, bool ok) {
  if (!ok) return;
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    const int idx = tile * PT + lane + 32 * k;
    c.x[k] = t[idx];
    c.y[k] = t[ld + idx];
    c.z[k] = t[2 * ld + idx];
  }
}

__global__ void __launch_bounds__(PW * 32)
nearest_sq_pruned_kernel(const Sources src, const int* __restrict__ table,
                         const int* __restrict__ order, const float* __restrict__ dsort,
                         float* __restrict__ out, int* __restrict__ tiles, int Kq, int Kt,
                         int gj) {
  __shared__ float4 tile[PW][PT];
  __shared__ float part[2][PW][32];
  const int s = blockIdx.y, i = blockIdx.x, gi = gridDim.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int* row = table + s * PCOLS;
  const int lo = row[4], hi = min(row[5], Kq), nt = min(row[6], Kt);
  const int i0 = i * QB, qi = i0 + lane;
  float* o = out + (size_t)s * Kq;
  int* visited_out = tiles + (size_t)s * gi + i;
  if (max(lo, i0) >= min(hi, i0 + QB)) {  // no meaningful query in the block
    if (w == 0) {
      o[qi] = kInit;
      if (lane == 0) *visited_out = 0;
    }
    return;
  }
  const float* qp = src.p[row[0]] + row[1];
  const int qld = src.ld[row[0]];
  const float* tp = src.p[row[2]] + row[3];
  const int tld = src.ld[row[2]];
  const float qx = qp[qi], qy = qp[qld + qi], qz = qp[2 * qld + qi];
  const float qn = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)), __fmul_rn(qz, qz));
  const bool meaningful = qi >= lo && qi < hi;
  const size_t base = ((size_t)s * gi + i) * gj;
  const int* ord = order + base;
  const float* ds = dsort + base;

  // at a step's start: its bounds (lane g holds ds[j + g], +inf past gj),
  // this warp's tile index and coordinates, and its tile index a step on
  float dsv = lane < PW && lane < gj ? ds[lane] : INFINITY;
  int jj = w < gj ? ord[w] : 0;
  TileCoords cur_c, nxt_c;
  load_tile(cur_c, tp, tld, jj, lane, w < gj);
  int jj_next = PW + w < gj ? ord[PW + w] : 0;
  float m = INFINITY;  // this warp's min of |t|^2 - 2 q.t over its tiles
  float cur = kInit, bound = kInit;
  int j = 0, visited = 0, buf = 0;
  while (true) {
    // dsort ascends, so the step's tiles within the bound are a prefix; the
    // bound and the count are uniform over the CTA
    const int n_inc = __popc(__ballot_sync(kFull, lane < PW && dsv <= bound));
    if (n_inc == 0) break;
    const int jn = j + PW;
    const float dsn = lane < PW && jn + lane < gj ? ds[jn + lane] : INFINITY;
    load_tile(nxt_c, tp, tld, jj_next, lane, jn + w < gj);
    const int jj_next2 = jn + PW + w < gj ? ord[jn + PW + w] : 0;
    if (w < n_inc) {
      float4* tl = tile[w];
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        const float x = cur_c.x[k], y = cur_c.y[k], z = cur_c.z[k];
        const float n = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
        tl[lane + 32 * k] = jj * PT + lane + 32 * k < nt
                                ? make_float4(-2.f * x, -2.f * y, -2.f * z, n)
                                : make_float4(0.f, 0.f, 0.f, INFINITY);
      }
      __syncwarp();
      float m0 = m, m1 = INFINITY, m2 = INFINITY, m3 = INFINITY;
#pragma unroll 8
      for (int k = 0; k < PT; k += 4) {
        m0 = fminf(m0, cell_tq(tl[k], qx, qy, qz));
        m1 = fminf(m1, cell_tq(tl[k + 1], qx, qy, qz));
        m2 = fminf(m2, cell_tq(tl[k + 2], qx, qy, qz));
        m3 = fminf(m3, cell_tq(tl[k + 3], qx, qy, qz));
      }
      m = fminf(fminf(m0, m1), fminf(m2, m3));
      __syncwarp();  // the tile slot is written again next step
    }
    // merge the warps' minima (double-buffered: one barrier a step); the
    // bound runs over meaningful queries only: pad and dead entries keep
    // their init and would stop all pruning
    part[buf][w][lane] = m;
    __syncthreads();
    float mm = part[buf][0][lane];
#pragma unroll
    for (int k = 1; k < PW; ++k) mm = fminf(mm, part[buf][k][lane]);
    cur = fminf(kInit, __fadd_rn(mm, qn));
    bound = warp_max(meaningful ? cur : -1.f);
    visited += n_inc;
    buf ^= 1;
    if (n_inc < PW || jn >= gj) break;
    j = jn;
    dsv = dsn;
    jj = jj_next;
    jj_next = jj_next2;
    cur_c = nxt_c;
  }
  if (w == 0) {
    o[qi] = cur;
    if (lane == 0) *visited_out = visited;
  }
}

}  // namespace

// query (3, Kq) and target (3, Kt) float32; out (Kq,) int32 bits of float32,
// which the caller fills with the init value 4 * 8192^2 before the launch;
// n_query and n_target are int32 scalars on the card.  block and chunk must
// be the kernel's DT and DCH.  Where Kt has more chunks than the grid's y
// extent allows, each CTA strides over its further chunks.
extern "C" int nearest_sq(const void* q, const void* t, void* out, int Kq, int Kt,
                          const void* nq, const void* nt, int block, int chunk, void* stream) {
  if (block != DT || chunk != DCH) return (int)cudaErrorInvalidValue;
  if (Kq <= 0 || Kt <= 0) return 0;
  const int chunks = Kt / DCH + (Kt % DCH != 0);
  const dim3 grid((Kq + DT - 1) / DT, chunks < MAX_GRID_Y ? chunks : MAX_GRID_Y);
  nearest_sq_kernel<<<grid, DNT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(t), static_cast<int*>(out), Kq,
      Kt, static_cast<const int*>(nq), static_cast<const int*>(nt));
  return (int)cudaGetLastError();
}

// As nearest_sq, plus outt (Kt,) int32 bits of float32; the caller fills
// outq and outt with the init value 4 * 8192^2 before the launch.
// head_query and head_target are int32 scalars on the card.  block and
// chunk must be the kernel's DT and DCH.  Where Kt has more chunks than the
// grid's y extent allows, each CTA strides over its further chunks.
extern "C" int nearest_sq_dual(const void* q, const void* t, void* outq, void* outt, int Kq,
                               int Kt, const void* nq, const void* nt, const void* hq,
                               const void* ht, int block, int chunk, void* stream) {
  if (block != DT || chunk != DCH) return (int)cudaErrorInvalidValue;
  if (Kq <= 0 || Kt <= 0) return 0;
  const int chunks = Kt / DCH + (Kt % DCH != 0);
  const dim3 grid((Kq + DT - 1) / DT, chunks < MAX_GRID_Y ? chunks : MAX_GRID_Y);
  nearest_sq_dual_kernel<<<grid, DNT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(t), static_cast<int*>(outq),
      static_cast<int*>(outt), Kq, Kt, static_cast<const int*>(nq),
      static_cast<const int*>(nt), static_cast<const int*>(hq), static_cast<const int*>(ht));
  return (int)cudaGetLastError();
}

// S pruned searches over up to four (3, ld_k) float32 buffers s0..s3.
// table (S, 7) int32 on the card: per search the query buffer, query offset,
// target buffer, target offset, q_lo, q_hi and n_target; search s reads the
// queries [q_off, q_off + Kq) and the targets [t_off, t_off + Kt) in place.
// order (S, Kq / 32, gj) int32 and dsort (S, Kq / 32, gj) float32 are the
// target tiles of each query block in ascending order of their box bounds;
// out (S, Kq) float32; tiles (S, Kq / 32) int32 receives the tiles each
// query block visited.  block and tile must be QB and PT.
extern "C" int nearest_sq_pruned(const void* s0, const void* s1, const void* s2, const void* s3,
                                 int ld0, int ld1, int ld2, int ld3, const void* table,
                                 const void* order, const void* dsort, void* out, void* tiles,
                                 int S, int Kq, int Kt, int gj, int block, int tile,
                                 void* stream) {
  if (block != QB || tile != PT || Kq % QB || Kt % PT || S > 65535)
    return (int)cudaErrorInvalidValue;
  if (S <= 0 || Kq <= 0) return 0;
  const Sources src{{static_cast<const float*>(s0), static_cast<const float*>(s1),
                     static_cast<const float*>(s2), static_cast<const float*>(s3)},
                    {ld0, ld1, ld2, ld3}};
  const dim3 grid(Kq / QB, S);
  nearest_sq_pruned_kernel<<<grid, PW * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      src, static_cast<const int*>(table), static_cast<const int*>(order),
      static_cast<const float*>(dsort), static_cast<float*>(out), static_cast<int*>(tiles), Kq,
      Kt, gj);
  return (int)cudaGetLastError();
}
