// Fused MF-SGD, item side: pull + SGD + push in one sorted pass.
//
// Replaces the TPU kernel flink_parameter_server_tpu/ops/pallas_mf.py
// (_kernel, launched by _sorted_fused_call).  Lanes arrive sorted by item
// id (ops/mf_kernel.py sorts them and gathers each lane's user row p).  For
// each run of equal items the item row q is read once; every lane of the
// run computes against that pre-batch snapshot
//     pred = p.q,   e = m*lr*(r - pred),
//     user delta = e*q - m*lr*reg*p,   item delta = e*p - m*lr*reg*q,
// writes its user delta and prediction, and the item deltas are summed in
// float; the row is written once as q + sum, in the table's type.
//
// What bounds it on an H100: bytes.  Per lane it reads p and writes the
// user delta (2 * d * 4 bytes) at about 10 * d flops, far below the card's
// ratio; per unique item it reads and writes one row.  The hot runs are
// cut into chunks by the two-pass scheme of runs.cuh: every chunk of a run
// reads the same unmodified row, and the owner writes it after all chunks.
//
// Pass 1 here: one warp per chunk of kChunk sorted lanes; each lane owns V
// of the row's d <= 32 * V columns, and the dot product is a warp sum.
#include "runs.cuh"

namespace fps {

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int V>
__global__ void mf_run_pass(T* table, int W, const int* items, const float* p,
                            const float* r, const float* m, int64_t n, int d,
                            int sub_k, float lr, float reg, float* udelta,
                            float* pred, float* head, float* tail) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int64_t start = chunk * kChunk;
  if (start >= n) return;
  const int64_t end = min(n, start + kChunk);
  const bool cont_in = start > 0 && items[start - 1] == items[start];
  const bool cont_out = end < n && items[end - 1] == items[end];
  const int my_id = start + lane < end ? items[start + lane] : 0;

  float q[V], acc[V];
  int cur = items[start];
  int64_t seg = start;

  auto load_row = [&]() {
    const T* row = table + row_offset(cur, sub_k, d, W);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = lane + v * kWarp;
      q[v] = col < d ? to_acc(row[col]) : 0.0f;
      acc[v] = 0.0f;
    }
  };
  auto flush = [&](int64_t seg_end) {
    float* dst = nullptr;
    if (seg == start && cont_in) dst = head + chunk * d;
    else if (seg_end == end && cont_out) dst = tail + chunk * d;
    T* row = table + row_offset(cur, sub_k, d, W);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = lane + v * kWarp;
      if (col >= d) continue;
      if (dst != nullptr) dst[col] = acc[v];
      else store_acc(row + col, q[v] + acc[v]);
    }
  };

  load_row();
  for (int64_t i = start; i < end; ++i) {
    const int id = __shfl_sync(0xffffffffu, my_id, static_cast<int>(i - start));
    if (id != cur) {
      flush(i);
      cur = id;
      seg = i;
      load_row();
    }
    const float* pi = p + i * d;
    float pv[V];
    float dot = 0.0f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = lane + v * kWarp;
      pv[v] = col < d ? pi[col] : 0.0f;
      dot += pv[v] * q[v];
    }
    dot = warp_sum(dot);
    const float mlr = m[i] * lr;
    const float e = mlr * (r[i] - dot);
    const float shrink = mlr * reg;
    float* ui = udelta + i * d;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int col = lane + v * kWarp;
      if (col < d) ui[col] = e * q[v] - shrink * pv[v];
      acc[v] += e * pv[v] - shrink * q[v];
    }
    if (lane == 0) pred[i] = dot;
  }
  flush(end);
}

template <typename T, int V>
int launch(void* table, int W, const int* items, const float* p, const float* r,
           const float* m, int64_t n, int d, int sub_k, float lr, float reg,
           float* udelta, float* pred, float* head, float* tail, cudaStream_t stream) {
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int threads = kWarpsPerBlock * kWarp;
  dim3 grid1(static_cast<unsigned>((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock));
  mf_run_pass<T, V><<<grid1, threads, 0, stream>>>(
      static_cast<T*>(table), W, items, p, r, m, n, d, sub_k, lr, reg, udelta, pred,
      head, tail);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid2(static_cast<unsigned>(chunks), static_cast<unsigned>((d + kWarp - 1) / kWarp));
  combine_spanning_runs<T, float><<<grid2, threads, 0, stream>>>(
      static_cast<T*>(table), W, items, n, d, sub_k, head, tail);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_width(void* table, int W, const int* items, const float* p, const float* r,
                 const float* m, int64_t n, int d, int sub_k, float lr, float reg,
                 float* udelta, float* pred, float* head, float* tail, cudaStream_t s) {
  if (d <= kWarp)
    return launch<T, 1>(table, W, items, p, r, m, n, d, sub_k, lr, reg, udelta, pred, head, tail, s);
  if (d <= 2 * kWarp)
    return launch<T, 2>(table, W, items, p, r, m, n, d, sub_k, lr, reg, udelta, pred, head, tail, s);
  if (d <= 4 * kWarp)
    return launch<T, 4>(table, W, items, p, r, m, n, d, sub_k, lr, reg, udelta, pred, head, tail, s);
  return launch<T, 8>(table, W, items, p, r, m, n, d, sub_k, lr, reg, udelta, pred, head, tail, s);
}

}  // namespace fps

// d <= 256 (the wrapper checks).  head/tail: ceil(n / kChunk) * d floats.
// Returns the CUDA error code of the launches (0 = ok).
extern "C" int fps_fused_mf_sgd(int dtype, void* table, int W, const int* items,
                                const float* p, const float* r, const float* m,
                                int64_t n, int d, int sub_k, float lr, float reg,
                                float* udelta, float* pred, float* head, float* tail,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fps::kF32:
      return fps::launch_width<float>(table, W, items, p, r, m, n, d, sub_k, lr, reg,
                                      udelta, pred, head, tail, s);
    case fps::kBF16:
      return fps::launch_width<__nv_bfloat16>(table, W, items, p, r, m, n, d, sub_k, lr,
                                              reg, udelta, pred, head, tail, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fps_chunk_lanes() { return fps::kChunk; }
