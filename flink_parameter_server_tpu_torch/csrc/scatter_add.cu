// Sorted, duplicate-compressing scatter-add: table[ids] += deltas.
//
// Replaces the TPU kernel flink_parameter_server_tpu/ops/pallas_scatter.py
// (_kernel, launched by sorted_scatter_add_pallas).  The wrapper
// (ops/scatter_kernel.py) routes dropped lanes to zero deltas and sorts the
// lanes by id; this file sums each run of equal ids and writes each unique
// row once.  Sums are float for f32/bf16 tables and int32 for int32 tables.
//
// What bounds it on an H100: bytes.  It reads every delta once and
// read-modify-writes each unique row once, at a few operations per byte.
// The hot runs of a Zipf batch (one id can own a fifth of the lanes) are
// the trouble: the two-pass chunk scheme of runs.cuh splits them over many
// warps and still adds every piece in a fixed order, with no atomics.
//
// Pass 1 here: one warp per chunk of kChunk sorted lanes; grid.y tiles the
// row's columns, 32 * V per warp (each lane owns V columns, 32 apart).
#include "runs.cuh"

namespace fps {

template <typename T, typename A, int V>
__global__ void scatter_run_pass(T* table, int W, const int* ids, const T* deltas,
                                 int64_t n, int d, int sub_k, A* head, A* tail) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int64_t start = chunk * kChunk;
  if (start >= n) return;
  const int64_t end = min(n, start + kChunk);
  const bool cont_in = start > 0 && ids[start - 1] == ids[start];
  const bool cont_out = end < n && ids[end - 1] == ids[end];
  const int my_id = start + lane < end ? ids[start + lane] : 0;
  const int col0 = blockIdx.y * (kWarp * V) + lane;

  A acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0;
  int cur = ids[start];
  int64_t seg = start;

  auto flush = [&](int64_t seg_end) {
    A* dst = nullptr;
    if (seg == start && cont_in) dst = head + chunk * d;
    else if (seg_end == end && cont_out) dst = tail + chunk * d;
    if (dst != nullptr) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int col = col0 + v * kWarp;
        if (col < d) dst[col] = acc[v];
      }
    } else {
      T* row = table + row_offset(cur, sub_k, d, W);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int col = col0 + v * kWarp;
        if (col < d) store_acc(row + col, to_acc(row[col]) + acc[v]);
      }
    }
  };

  for (int64_t i = start; i < end; ++i) {
    const int id = __shfl_sync(0xffffffffu, my_id, static_cast<int>(i - start));
    if (id != cur) {
      flush(i);
      cur = id;
      seg = i;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0;
    }
    const T* src = deltas + i * d;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = col0 + v * kWarp;
      if (col < d) acc[v] += to_acc(src[col]);
    }
  }
  flush(end);
}

template <typename T, typename A, int V>
int launch(void* table, int W, const int* ids, const void* deltas, int64_t n,
           int d, int sub_k, void* head, void* tail, cudaStream_t stream) {
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int threads = kWarpsPerBlock * kWarp;
  dim3 grid1(static_cast<unsigned>((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock),
             static_cast<unsigned>((d + kWarp * V - 1) / (kWarp * V)));
  scatter_run_pass<T, A, V><<<grid1, threads, 0, stream>>>(
      static_cast<T*>(table), W, ids, static_cast<const T*>(deltas), n, d, sub_k,
      static_cast<A*>(head), static_cast<A*>(tail));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2(static_cast<unsigned>(chunks), static_cast<unsigned>((d + kWarp - 1) / kWarp));
  combine_spanning_runs<T, A><<<grid2, threads, 0, stream>>>(
      static_cast<T*>(table), W, ids, n, d, sub_k, static_cast<const A*>(head),
      static_cast<const A*>(tail));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_width(void* table, int W, const int* ids, const void* deltas, int64_t n,
                 int d, int sub_k, void* head, void* tail, cudaStream_t stream) {
  if (d <= kWarp) return launch<T, A, 1>(table, W, ids, deltas, n, d, sub_k, head, tail, stream);
  if (d <= 2 * kWarp) return launch<T, A, 2>(table, W, ids, deltas, n, d, sub_k, head, tail, stream);
  return launch<T, A, 4>(table, W, ids, deltas, n, d, sub_k, head, tail, stream);
}

}  // namespace fps

// head/tail: scratch of ceil(n / kChunk) * d accumulators (float, or int32
// for int32 tables).  Returns the CUDA error code of the launches (0 = ok).
extern "C" int fps_sorted_scatter_add(int dtype, void* table, int W, const int* ids,
                                      const void* deltas, int64_t n, int d, int sub_k,
                                      void* head, void* tail, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fps::kF32:
      return fps::launch_width<float, float>(table, W, ids, deltas, n, d, sub_k, head, tail, s);
    case fps::kBF16:
      return fps::launch_width<__nv_bfloat16, float>(table, W, ids, deltas, n, d, sub_k, head, tail, s);
    case fps::kI32:
      return fps::launch_width<int32_t, int32_t>(table, W, ids, deltas, n, d, sub_k, head, tail, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fps_chunk_lanes() { return fps::kChunk; }
