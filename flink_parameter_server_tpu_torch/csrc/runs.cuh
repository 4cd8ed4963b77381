// Shared pieces of the two sorted-run kernels (scatter_add.cu, fused_mf.cu).
//
// Both kernels take lanes sorted by row id, so equal ids form runs.  A run
// must be summed and its row written exactly once, without atomics, so the
// result does not depend on scheduling.  A Zipf-hot batch has runs of
// thousands of lanes, so one warp per run would walk the hottest run alone.
// Instead the lanes are cut into chunks of kChunk lanes, one warp each:
//
//   pass 1 (per kernel): a warp walks its chunk in order.  A run that lies
//     wholly inside the chunk is summed and its row written at once.  The
//     piece of a run that continues from the previous chunk goes to
//     head[chunk]; the piece of a run that starts in this chunk and
//     continues into the next goes to tail[chunk].  (A chunk covered by one
//     run that continues both ways writes head.)
//   pass 2 (combine_spanning_runs, here): the chunk where a spanning run
//     starts owns it.  Its block adds tail[owner] and head[c] of every later
//     chunk the run covers, in a fixed order, and writes the row once.
//
// Row addressing covers the dense and the lane-packed layouts: logical id
// i lives in physical row i / sub_k at column (i % sub_k) * d of a row of
// W elements (dense: sub_k = 1, d = W).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fps {

constexpr int kWarp = 32;
constexpr int kChunk = 32;         // sorted lanes per warp in pass 1
constexpr int kWarpsPerBlock = 8;  // pass 1 and pass 2 blocks: 256 threads

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

// First index in sorted ids[0, n) whose id is greater than key.
__device__ __forceinline__ int64_t upper_bound(const int* ids, int64_t n, int key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (ids[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Pass 2.  grid (num_chunks, ceil(d / 32)), block kWarpsPerBlock warps.
// Warp w sums the head partials of chunks owner+1+w, owner+1+w+8, ... in
// order; warp 0 then adds tail[owner] and the warps' sums in order and
// writes the row.  Columns: 32 per block, one per lane.
template <typename T, typename A>
__global__ void combine_spanning_runs(T* table, int W, const int* ids, int64_t n,
                                      int d, int sub_k, const A* head,
                                      const A* tail) {
  __shared__ A part[kWarpsPerBlock][kWarp];
  const int64_t chunk = blockIdx.x;
  const int64_t start = chunk * kChunk;
  const int64_t end = min(n, start + kChunk);
  if (end >= n) return;
  const int rid = ids[end - 1];
  if (ids[end] != rid) return;                                   // ends here
  if (ids[start] == rid && start > 0 && ids[start - 1] == rid) return;  // not its start
  const int64_t last_chunk = (upper_bound(ids, n, rid) - 1) / kChunk;

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int col = blockIdx.y * kWarp + lane;
  A sum = 0;
  if (col < d) {
    for (int64_t c = chunk + 1 + warp; c <= last_chunk; c += kWarpsPerBlock)
      sum += head[c * d + col];
  }
  part[warp][lane] = sum;
  __syncthreads();
  if (warp != 0 || col >= d) return;
  A total = tail[chunk * d + col];
  for (int w = 0; w < kWarpsPerBlock; ++w) total += part[w][lane];
  T* row = table + row_offset(rid, sub_k, d, W);
  store_acc(row + col, to_acc(row[col]) + total);
}

}  // namespace fps
