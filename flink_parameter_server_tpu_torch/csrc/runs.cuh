// Shared pieces of the two sorted-run kernels (scatter_add.cu, fused_mf.cu).
//
// Both kernels take lanes sorted by row id, so equal ids form runs.  A run
// must be summed and its row written exactly once, without atomics, so the
// result is the same, bit for bit, on every run with the same inputs.  A
// Zipf-hot batch has runs of thousands of lanes (11,877 of 65,536 on one
// row in the main path's seed-0 batch), so one warp per run would walk the
// hottest run alone.  Instead the lanes are cut into tiles, one block
// (kBlock threads, 8 warps) each:
//
//   pass 1 (per kernel): the block copies its tile (ids, and the values to
//     sum) into shared memory with every load issued before any sum (16-byte
//     cp.async where the rows allow it).  A run's sum starts from its row's
//     pre-batch value, taken at the run's first lane: scatter_add.cu loads
//     the values of the rows whose runs start in each thread's segment into
//     registers up front (`prefetch_rows`, here), fused_mf.cu adds q to the
//     first lane's item delta.  Then `sum_tile_runs` (here) walks the tile:
//     each warp walks a segment of kSeg lanes in order, one column per
//     thread, adding from shared memory, so no step of the walk waits on
//     device memory.  A run wholly inside a segment is written to its row
//     when it ends.  Runs that cross segments are combined by
//     the block in shared memory, in segment order.  Of a run that crosses
//     the tile's edge, the piece that continues from the previous tile goes
//     to head[tile] and the piece that starts here (with the row's value)
//     and continues into the next tile to tail[tile].  (A tile covered by
//     one run that continues both ways writes head.)
//   pass 2 (combine_spanning_runs, here): one block per tile; the tile
//     where a spanning run starts owns it.  The block finds the run's last
//     tile kBlock tiles at a time (each thread compares one tile's first
//     id), the warps sum contiguous slices of the heads with their loads in
//     flight, and the slices are added to tail[owner] in order; the sum is
//     the row's new value, written once.
//
// On the main path's seed-0 batch the hottest run, 11,877 of 65,536 lanes,
// spans 47 tiles of 256 lanes, where 32-lane warp chunks give it 372
// pieces.
//
// Row addressing covers the dense and the lane-packed layouts: logical id
// i lives in physical row i / sub_k at column (i % sub_k) * d of a row of
// W elements (dense: sub_k = 1, d = W).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"  // cp_async_16, cp_async_commit, cp_async_wait

// kernel<<<grid, threads, smem, stream>>>: the CPU emulation defines its own
#ifndef FPS_LAUNCH
#define FPS_LAUNCH(kernel, grid, threads, smem, stream) kernel<<<grid, threads, smem, stream>>>
#endif

namespace fps {

constexpr int kWarp = 32;
constexpr int kBlock = 256;             // every block of both passes: 8 warps
constexpr int kWarps = kBlock / kWarp;
constexpr int kSeg = kWarp;             // sorted lanes one warp walks in pass 1
constexpr int kCombineCols = kBlock;    // pass 2 adds this many columns at a time
constexpr int kStaticSmem = 48 * 1024;  // dynamic shared memory without an opt-in

enum DType : int { kF32 = 0, kBF16 = 1, kI32 = 2 };

// Sums run in float for float tables and in the table's own type for
// int32 tables, so integer counts stay exact past 2^24.
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int32_t to_acc(int32_t v) { return v; }

__device__ __forceinline__ void store_acc(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_acc(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_acc(int32_t* p, int32_t v) { *p = v; }

__device__ __forceinline__ int64_t row_offset(int id, int sub_k, int d, int W) {
  return static_cast<int64_t>(id / sub_k) * W + static_cast<int64_t>(id % sub_k) * d;
}

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// A tile's shape at CG column groups: the block's 8 warps stand as
// kSegs segments of kSeg lanes by CG groups of 32 * V columns.
template <int CG>
struct Tile {
  static_assert(CG >= 1 && kWarps % CG == 0, "column groups must divide the block's warps");
  static constexpr int kSegs = kWarps / CG;
  static constexpr int kLanes = kSegs * kSeg;
  static constexpr int kSidBytes = round16((kLanes + 8) * 4);  // ids, a neighbour either side
  static constexpr int kIdBytes = kSidBytes + kLanes * 8;      // and each lane's row offset
  __device__ static int* sid(unsigned char* smem) { return reinterpret_cast<int*>(smem) + 4; }
  __device__ static int64_t* soff(unsigned char* smem) {
    return reinterpret_cast<int64_t*>(smem + kSidBytes);
  }
};

// The tile's ids into shared memory: sid[-1 .. len] holds lanes t0 - 1 ..
// t0 + len, with -1 where the batch has no such lane (ids are >= 0), and
// soff[0 .. len) each lane's row offset in the table: one division by sub_k
// a lane, here, instead of one wherever a row is touched.
__device__ __forceinline__ void stage_ids(int* sid, int64_t* soff, const int* __restrict__ ids,
                                          int64_t n, int64_t t0, int len, int sub_k, int d, int W) {
  for (int j = threadIdx.x; j < len + 2; j += kBlock) {
    const int64_t lane = t0 - 1 + j;
    const int id = lane >= 0 && lane < n ? ids[lane] : -1;
    sid[j - 1] = id;
    if (j >= 1 && j <= len) soff[j - 1] = row_offset(id, sub_k, d, W);
  }
}

// This thread's place in pass 1's walk: segment s (lanes lo .. hi of the
// tile), column group g, first column c of the block's 32 * V * CG.
template <int CG, int V>
struct WalkPlace {
  int s, lo, hi, c;
  __device__ __forceinline__ explicit WalkPlace(int len) {
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    s = warp / CG;
    lo = s * kSeg;
    hi = static_cast<int>(lmin(lo + kSeg, len));
    c = (warp % CG) * kWarp * V + lane * V;
  }
};

// The pre-batch row values of every run that starts in this thread's
// segment, in registers, loaded before the walk: a walk that read each row
// when its run ended would wait on one device-memory round trip after
// another (a tile of singletons has 32 runs a segment).  q[k] belongs to
// the run starting at lane lo + k; zero where no run starts there.  The
// walk starts each run's sum from it.
template <typename T, typename A, int CG, int V>
__device__ __forceinline__ void prefetch_rows(A (&q)[kSeg][V], const T* __restrict__ table, int d,
                                              const int* sid, const int64_t* soff, int col0, int len) {
  const WalkPlace<CG, V> at(len);
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const int i = at.lo + k;
    const bool starts = i < at.hi && sid[i] != sid[i - 1];
    const T* row = table + (starts ? soff[i] : 0);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = col0 + at.c + v;
      q[k][v] = starts && col < d ? to_acc(row[col]) : A(0);
    }
  }
}

// Pass 1's walk and the tile's own recombination, after the tile is staged.
// sid, soff: the tile's ids and row offsets (stage_ids); vals: its len
// rows, ld values apart, the block's columns col0 .. col0 + 32 * V * CG of
// the logical row (d wide); q: prefetch_rows, or zeros where vals already
// carry the rows; wpart: 2 * kSegs * 32 * V * CG accumulators of scratch.
// Every thread of the block calls it.
template <typename T, typename S, typename A, int CG, int V>
__device__ __forceinline__ void sum_tile_runs(const A (&q)[kSeg][V], T* __restrict__ table, int d,
                                              const int* sid, const int64_t* soff, const S* vals,
                                              int ld, int col0, int len, A* wpart, int64_t tile,
                                              A* __restrict__ head, A* __restrict__ tail) {
  constexpr int kSegs = Tile<CG>::kSegs;
  constexpr int kCols = kWarp * V * CG;  // the block's columns
  A* whead = wpart;
  A* wtail = wpart + kSegs * kCols;
  const WalkPlace<CG, V> at(len);
  const int s = at.s, lo = at.lo, hi = at.hi, c = at.c;
  const int64_t cut = tile * static_cast<int64_t>(d);

  A acc[V];
  if (lo < len) {
    const bool cont_in = sid[lo - 1] == sid[lo];
    const bool cont_out = sid[hi] == sid[hi - 1];
    int cur = sid[lo], seg = lo;
    int64_t cur_off = soff[lo];
    auto piece = [&](int end) {
      if (seg == lo && cont_in) {
#pragma unroll
        for (int v = 0; v < V; ++v) whead[s * kCols + c + v] = acc[v];
      } else if (end == hi && cont_out) {
#pragma unroll
        for (int v = 0; v < V; ++v) wtail[s * kCols + c + v] = acc[v];
      } else {
        T* row = table + cur_off;
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (col0 + c + v < d) store_acc(row + col0 + c + v, acc[v]);
      }
    };
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = q[0][v];
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      const int i = lo + k;
      if (i < hi) {
        const int id = sid[i];
        if (id != cur) {
          piece(i);
          cur = id;
          seg = i;
          cur_off = soff[i];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = q[k][v];
        }
#pragma unroll
        for (int v = 0; v < V; ++v)
          if (col0 + c + v < d) acc[v] += to_acc(vals[i * ld + c + v]);
      }
    }
    piece(hi);
  }
  __syncthreads();
  if (lo >= len) return;

  // A run that starts in segment s and continues past it: its owner adds the
  // head pieces of the segments it covers, in order.
  const int rid = sid[hi - 1];
  if (sid[hi] == rid && !(sid[lo - 1] == sid[lo] && sid[lo] == rid)) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = wtail[s * kCols + c + v];
    for (int j = s + 1; j < kSegs && j * kSeg < len && sid[j * kSeg] == rid; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += whead[j * kCols + c + v];
    const bool onward = sid[len - 1] == rid && sid[len] == rid;  // into the next tile
    T* row = table + soff[hi - 1];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = col0 + c + v;
      if (col >= d) continue;
      if (onward) tail[cut + col] = acc[v];
      else store_acc(row + col, acc[v]);
    }
  }
  // The run that continues from the previous tile: its piece here.
  if (s == 0 && sid[-1] == sid[0]) {
    const int first = sid[0];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0;
    for (int j = 0; j < kSegs && j * kSeg < len && sid[j * kSeg] == first; ++j)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += whead[j * kCols + c + v];
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (col0 + c + v < d) head[cut + col0 + c + v] = acc[v];
  }
}

template <typename A>
__host__ __device__ constexpr int combine_smem_bytes() {
  return kWarps * kCombineCols * static_cast<int>(sizeof(A));
}

// Pass 2.  grid (ceil(n / lanes)), kBlock threads.  The block counts the
// tiles after the owner that the run covers, kBlock at a time (one round
// for runs of up to kBlock tiles); warp w then sums the heads of a
// contiguous slice of them in order, kCombineCols columns at a time (8 a
// lane), loading kBatch heads before adding any; each thread then adds
// tail[owner] (which carries the row's pre-batch value) and the warps'
// sums, in warp order, for one column and writes the total to the row.
template <typename T, typename A>
__global__ void __launch_bounds__(kBlock)
combine_spanning_runs(T* __restrict__ table, int W, const int* __restrict__ ids, int64_t n,
                      int d, int sub_k, int lanes, const A* __restrict__ head,
                      const A* __restrict__ tail) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* part = reinterpret_cast<A*>(smem_raw);  // [kWarps][kCombineCols]
  const int64_t tile = blockIdx.x;
  const int64_t start = tile * lanes, end = lmin(n, start + lanes);
  if (end >= n) return;
  const int rid = ids[end - 1];
  if (ids[end] != rid) return;                                          // ends here
  if (ids[start] == rid && start > 0 && ids[start - 1] == rid) return;  // not its start
  const int64_t tiles = (n + lanes - 1) / lanes;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  // tiles tile + 1 .. tile + covered hold head pieces: a prefix, since ids
  // are sorted, counted kBlock tiles a round
  int64_t covered = 0;
  for (;;) {
    const int64_t t = tile + 1 + covered + threadIdx.x;
    const int found = __syncthreads_count(t < tiles && ids[t * lanes] == rid);
    covered += found;
    if (found < kBlock) break;
  }
  const int64_t per = (covered + kWarps - 1) / kWarps;
  const int64_t first = tile + 1 + lmin(covered, warp * per);
  const int64_t last = tile + 1 + lmin(covered, (warp + 1) * per);
  constexpr int kPerLane = kCombineCols / kWarp;
  constexpr int kBatch = 8;
  T* row = table + row_offset(rid, sub_k, d, W);

  for (int c0 = 0; c0 < d; c0 += kCombineCols) {
    A sum[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) sum[j] = 0;
    for (int64_t t = first; t < last; t += kBatch) {
      A got[kBatch][kPerLane];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const A* h = head + (t + u) * d + c0;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j)
          got[u][j] = t + u < last && c0 + lane + j * kWarp < d ? h[lane + j * kWarp] : A(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (t + u < last)
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) sum[j] += got[u][j];
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) part[warp * kCombineCols + lane + j * kWarp] = sum[j];
    __syncthreads();
    const int col = c0 + static_cast<int>(threadIdx.x);
    if (col < d) {
      A total = tail[tile * d + col];
      for (int w = 0; w < kWarps; ++w) total += part[w * kCombineCols + threadIdx.x];
      store_acc(row + col, total);
    }
    __syncthreads();
  }
}

}  // namespace fps
