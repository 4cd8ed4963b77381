// Sorted, duplicate-compressing scatter-add: table[ids] += deltas.
//
// Replaces the TPU kernel flink_parameter_server_tpu/ops/pallas_scatter.py
// (_kernel, launched by sorted_scatter_add_pallas).  The wrapper
// (ops/scatter_kernel.py) routes dropped lanes to zero deltas and sorts the
// lanes by id; this file sums each run of equal ids and writes each unique
// row once.  Sums are float for f32/bf16 tables and int32 for int32 tables.
//
// What bounds it on an H100: bytes.  It reads every delta once and
// read-modify-writes each unique row once, at one add per value.  At the
// main path's shape (65,536 lanes of 64 floats) that is 24 MB, 7 us at
// 3.35 TB/s, so the card has to keep most of the deltas in flight at once,
// and the hot runs of a Zipf batch (one id can own a fifth of the lanes)
// must not serialise the sum.
//
// The design (pass 1 here; the tile scheme and pass 2 in runs.cuh): one
// block of 256 threads owns a tile of 256 sorted lanes and a slab of 128
// bytes of the row (32 floats or int32, 64 bf16; grid.y walks the slabs, so
// any width fits).  It issues the tile's slab as 16-byte cp.async copies
// into shared memory (32 KB), eight threads to a row, then loads the ids,
// then, while the copies are in flight, the table values of the runs that
// start in each warp's segment; at d 64 that is 512 blocks in one wave over
// 132 SMs, the whole batch in flight.  The walk then adds from shared
// memory and registers, so its 32-step chain per warp never waits on
// device memory.  Rows whose copies are not 16-byte aligned (deltas off a
// 16-byte boundary, d * element size not a multiple of 16) take a scalar
// copy, chosen at launch.
#include "runs.cuh"

namespace fps {

constexpr int kTileLanes = Tile<1>::kLanes;  // 256
constexpr int kSlabBytes = kWarp * 4;        // 4 bytes of each row a thread

template <typename T, typename A>
__host__ __device__ constexpr int scatter_smem_bytes() {
  constexpr int kWpart = 2 * Tile<1>::kSegs * (kSlabBytes / static_cast<int>(sizeof(T)));
  return Tile<1>::kIdBytes + kTileLanes * kSlabBytes + kWpart * static_cast<int>(sizeof(A));
}

template <typename T, typename A, bool kVec>
__global__ void __launch_bounds__(kBlock)
scatter_tile_pass(T* __restrict__ table, int W, const int* __restrict__ ids,
                  const T* __restrict__ deltas, int64_t n, int d, int sub_k,
                  A* __restrict__ head, A* __restrict__ tail) {
  constexpr int V = 4 / sizeof(T);     // columns a thread
  constexpr int kCols = kWarp * V;     // columns of the slab
  constexpr int kPerCopy = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* sid = Tile<1>::sid(smem_raw);
  int64_t* soff = Tile<1>::soff(smem_raw);
  T* vals = reinterpret_cast<T*>(smem_raw + Tile<1>::kIdBytes);
  A* wpart = reinterpret_cast<A*>(smem_raw + Tile<1>::kIdBytes + kTileLanes * kSlabBytes);

  const int64_t tile = blockIdx.x, t0 = tile * kTileLanes;
  const int len = static_cast<int>(lmin(kTileLanes, n - t0));
  const int col0 = blockIdx.y * kCols;
  const int cols = static_cast<int>(lmin(kCols, d - col0));
  // the deltas' copies first (they need no ids), then the ids, then the
  // rows of the runs, each thread's loads all issued before it waits
  if constexpr (kVec) {
    const int copies = cols / kPerCopy;  // 16-byte pieces of a row's slab, <= 8
    for (int k = threadIdx.x; k < len * 8; k += kBlock) {
      const int r = k / 8, j = k % 8;
      if (j < copies)
        cp_async_16(vals + r * kCols + j * kPerCopy, deltas + (t0 + r) * d + col0 + j * kPerCopy);
    }
    cp_async_commit();
  } else {
    for (int k = threadIdx.x; k < len * kCols; k += kBlock) {
      const int r = k / kCols, j = k % kCols;
      if (j < cols) vals[r * kCols + j] = deltas[(t0 + r) * d + col0 + j];
    }
  }
  stage_ids(sid, soff, ids, n, t0, len, sub_k, d, W);
  __syncthreads();
  A q[kSeg][V];
  prefetch_rows<T, A, 1, V>(q, table, d, sid, soff, col0, len);
  if constexpr (kVec) cp_async_wait<0>();
  __syncthreads();
  sum_tile_runs<T, T, A, 1, V>(q, table, d, sid, soff, vals, kCols, col0, len, wpart, tile, head,
                               tail);
}

template <typename T, typename A>
int launch(void* table, int W, const int* ids, const void* deltas, int64_t n, int d,
           int sub_k, void* head, void* tail, cudaStream_t stream) {
  constexpr int kCols = kSlabBytes / sizeof(T);
  constexpr int smem1 = scatter_smem_bytes<T, A>(), smem2 = combine_smem_bytes<A>();
  static_assert(smem1 <= kStaticSmem && smem2 <= kStaticSmem, "pass tiles outgrow shared memory");
  const int64_t tiles = (n + kTileLanes - 1) / kTileLanes;
  const bool vec = reinterpret_cast<uintptr_t>(deltas) % 16 == 0 && d * sizeof(T) % 16 == 0;
  auto pass1 = vec ? scatter_tile_pass<T, A, true> : scatter_tile_pass<T, A, false>;
  FPS_LAUNCH(pass1, dim3(static_cast<unsigned>(tiles), static_cast<unsigned>((d + kCols - 1) / kCols)),
             kBlock, smem1, stream)(
      static_cast<T*>(table), W, ids, static_cast<const T*>(deltas), n, d, sub_k,
      static_cast<A*>(head), static_cast<A*>(tail));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto pass2 = combine_spanning_runs<T, A>;
  FPS_LAUNCH(pass2, dim3(static_cast<unsigned>(tiles)), kBlock, smem2, stream)(
      static_cast<T*>(table), W, ids, n, d, sub_k, kTileLanes, static_cast<const A*>(head),
      static_cast<const A*>(tail));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fps

// head/tail: scratch of ceil(n / fps_chunk_lanes()) * d accumulators
// (float, or int32 for int32 tables).  Returns the CUDA error code of the
// launches (0 = ok).
extern "C" int fps_sorted_scatter_add(int dtype, void* table, int W, const int* ids,
                                      const void* deltas, int64_t n, int d, int sub_k,
                                      void* head, void* tail, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case fps::kF32:
      return fps::launch<float, float>(table, W, ids, deltas, n, d, sub_k, head, tail, s);
    case fps::kBF16:
      return fps::launch<__nv_bfloat16, float>(table, W, ids, deltas, n, d, sub_k, head, tail, s);
    case fps::kI32:
      return fps::launch<int32_t, int32_t>(table, W, ids, deltas, n, d, sub_k, head, tail, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Sorted lanes of one tile: the wrappers size head/tail from it.
extern "C" int fps_chunk_lanes() { return fps::kTileLanes; }
