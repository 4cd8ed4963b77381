// Fused MF-SGD, item side: pull + SGD + push in one sorted pass.
//
// Replaces the TPU kernel flink_parameter_server_tpu/ops/pallas_mf.py
// (_kernel, launched by _sorted_fused_call).  Lanes arrive sorted by item
// id (ops/mf_kernel.py sorts them and gathers each lane's user row p).  For
// each run of equal items every lane computes against the pre-batch row q
//     pred = p.q,   e = m*lr*(r - pred),
//     user delta = e*q - m*lr*reg*p,   item delta = e*p - m*lr*reg*q,
// writes its user delta and prediction, and the item deltas are summed in
// float; the row is written once as q + sum, in the table's type.
//
// What bounds it on an H100: bytes.  Per lane it reads p and writes the
// user delta (2 * d * 4 bytes) at about 10 * d flops, far below the card's
// ratio; per unique item it reads and writes one row.  At the main path's
// shape (65,536 lanes, d 128) that is 81 MB, 24 us at 3.35 TB/s.
//
// The design (pass 1 here; the tile scheme and pass 2 in runs.cuh): one
// block of 256 threads owns a tile of 256 / CG sorted lanes, CG = ceil(d /
// 32) (d 128: 64 lanes, d 256: 32), so the tile's p rows fill 32 KB of
// shared memory at every width.  The block copies p (16-byte cp.async, all
// issued up front), r and m into shared memory, then computes the lanes in
// groups of 2 * CG threads, 16 values a thread: q straight from the table
// into registers while p's copies are still in flight (a hot row stays in
// L1), the dot product reduced in the group by log2(2 * CG) shuffles, the
// user delta written as 16-byte stores, and the item delta written over p
// in shared memory, with q added to it at each run's first lane.  The item
// deltas are then summed per run by runs.cuh's walk: per segment, then
// across segments in order, then across tiles in pass 2, every tile
// reading the same unmodified rows; each row is written once, as the
// sum.  Rows that cannot take 16-byte
// accesses (d % 4, a packed or unaligned table, p off a 16-byte boundary)
// take a scalar path, chosen at launch.
#include "runs.cuh"

namespace fps {

// Row stride of the tile in shared memory: four floats of padding keep two
// groups' 16-byte reads of neighbouring rows on different banks.
template <int CG>
__host__ __device__ constexpr int mf_ld() { return kWarp * CG + 4; }

template <int CG>
__host__ __device__ constexpr int mf_smem_bytes() {
  constexpr int L = Tile<CG>::kLanes;
  // ids and offsets; r and m; the tile; wpart
  return Tile<CG>::kIdBytes + 2 * L * 4 + L * mf_ld<CG>() * 4 + 2 * Tile<CG>::kSegs * kWarp * CG * 4;
}

// Four values of a table row from column col, as floats.
__device__ __forceinline__ float4 load4(const float* row, int col) {
  return *reinterpret_cast<const float4*>(row + col);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int col) {
  return make_float4(to_acc(row[col]), to_acc(row[col + 1]), to_acc(row[col + 2]),
                     to_acc(row[col + 3]));
}

template <typename T, int CG, bool kVec>
__global__ void __launch_bounds__(kBlock)
mf_tile_pass(T* __restrict__ table, int W, const int* __restrict__ items,
             const float* __restrict__ p, const float* __restrict__ r,
             const float* __restrict__ m, int64_t n, int d, int sub_k, float lr, float reg,
             float* __restrict__ udelta, float* __restrict__ pred, float* __restrict__ head,
             float* __restrict__ tail) {
  constexpr int L = Tile<CG>::kLanes;
  constexpr int LD = mf_ld<CG>();
  constexpr int G = 2 * CG;             // threads a lane
  constexpr int kGroups = kBlock / G;   // lanes in flight in the block
  constexpr int kPer = kWarp * CG / G;  // values a thread: 16
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* sid = Tile<CG>::sid(smem_raw);
  int64_t* soff = Tile<CG>::soff(smem_raw);
  float* sr = reinterpret_cast<float*>(smem_raw + Tile<CG>::kIdBytes);
  float* sm = sr + L;
  float* vals = sm + L;
  float* wpart = vals + L * LD;

  const int64_t tile = blockIdx.x, t0 = tile * L;
  const int len = static_cast<int>(lmin(L, n - t0));
  // p's copies first (they need no ids), then ids, r and m; then each
  // thread's q values, while p is still in flight
  if constexpr (kVec) {
    const int copies = d / 4;
    for (int k = threadIdx.x; k < len * copies; k += kBlock) {
      const int i = k / copies, j = k % copies;
      cp_async_16(vals + i * LD + 4 * j, p + (t0 + i) * d + 4 * j);
    }
    cp_async_commit();
  } else {
    for (int k = threadIdx.x; k < len * d; k += kBlock) {
      const int i = k / d, j = k % d;
      vals[i * LD + j] = p[(t0 + i) * d + j];
    }
  }
  stage_ids(sid, soff, items, n, t0, len, sub_k, d, W);
  for (int i = threadIdx.x; i < len; i += kBlock) {
    sr[i] = r[t0 + i];
    sm[i] = m[t0 + i];
  }
  __syncthreads();

  // lane i = it * kGroups + grp of the tile, columns of thread t: 4 (t + G k)
  // .. + 3 on the 16-byte path, t + G k otherwise
  const int grp = threadIdx.x / G, t = threadIdx.x % G;
  constexpr int kIters = L / kGroups;  // the same for every thread: the shuffles
  float qv[kIters][kPer];
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = it * kGroups + grp;
    const bool active = i < len;
    const T* row = table + (active ? soff[i] : 0);
#pragma unroll
    for (int k = 0; k < (kVec ? kPer / 4 : kPer); ++k) {
      const int col = kVec ? 4 * (t + G * k) : t + G * k;
      if constexpr (kVec) {
        const float4 b = active && col < d ? load4(row, col) : make_float4(0.f, 0.f, 0.f, 0.f);
        qv[it][4 * k] = b.x, qv[it][4 * k + 1] = b.y, qv[it][4 * k + 2] = b.z, qv[it][4 * k + 3] = b.w;
      } else {
        qv[it][k] = active && col < d ? to_acc(row[col]) : 0.0f;
      }
    }
  }
  if constexpr (kVec) cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int i = it * kGroups + grp;
    const bool active = i < len;
    float* vi = vals + i * LD;
    const float* qk = qv[it];
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < (kVec ? kPer / 4 : kPer); ++k) {
      const int col = kVec ? 4 * (t + G * k) : t + G * k;
      if (!active || col >= d) continue;
      if constexpr (kVec) {
        const float4 a = *reinterpret_cast<const float4*>(vi + col);
        dot += a.x * qk[4 * k];
        dot += a.y * qk[4 * k + 1];
        dot += a.z * qk[4 * k + 2];
        dot += a.w * qk[4 * k + 3];
      } else {
        dot += vi[col] * qk[k];
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (!active) continue;
    const float mlr = sm[i] * lr;
    const float e = mlr * (sr[i] - dot);
    const float shrink = mlr * reg;
    const float from_row = sid[i] != sid[i - 1] ? 1.0f : 0.0f;  // a run's first lane carries its row
    float* ui = udelta + (t0 + i) * d;
#pragma unroll
    for (int k = 0; k < (kVec ? kPer / 4 : kPer); ++k) {
      const int col = kVec ? 4 * (t + G * k) : t + G * k;
      if (col >= d) continue;
      if constexpr (kVec) {
        const float4 a = *reinterpret_cast<const float4*>(vi + col);
        const float* q4 = qk + 4 * k;
        *reinterpret_cast<float4*>(ui + col) =
            make_float4(e * q4[0] - shrink * a.x, e * q4[1] - shrink * a.y,
                        e * q4[2] - shrink * a.z, e * q4[3] - shrink * a.w);
        *reinterpret_cast<float4*>(vi + col) =
            make_float4(from_row * q4[0] + (e * a.x - shrink * q4[0]),
                        from_row * q4[1] + (e * a.y - shrink * q4[1]),
                        from_row * q4[2] + (e * a.z - shrink * q4[2]),
                        from_row * q4[3] + (e * a.w - shrink * q4[3]));
      } else {
        const float pk = vi[col];
        ui[col] = e * qk[k] - shrink * pk;
        vi[col] = from_row * qk[k] + (e * pk - shrink * qk[k]);
      }
    }
    if (t == 0) pred[t0 + i] = dot;
  }
  const float rows_in_vals[kSeg][1] = {};  // the walk adds no row: the first lanes carry them
  __syncthreads();
  sum_tile_runs<T, float, float, CG, 1>(rows_in_vals, table, d, sid, soff, vals, LD, 0, len, wpart,
                                        tile, head, tail);
}

template <typename T, int CG>
int launch(void* table, int W, const int* items, const float* p, const float* r,
           const float* m, int64_t n, int d, int sub_k, float lr, float reg,
           float* udelta, float* pred, float* head, float* tail, cudaStream_t stream) {
  constexpr int L = Tile<CG>::kLanes;
  constexpr int smem1 = mf_smem_bytes<CG>(), smem2 = combine_smem_bytes<float>();
  static_assert(smem1 <= kStaticSmem && smem2 <= kStaticSmem, "pass tiles outgrow shared memory");
  const int64_t tiles = (n + L - 1) / L;
  auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const bool vec = d % 4 == 0 && W % 4 == 0 && aligned(table) && aligned(p) && aligned(udelta);
  auto pass1 = vec ? mf_tile_pass<T, CG, true> : mf_tile_pass<T, CG, false>;
  FPS_LAUNCH(pass1, dim3(static_cast<unsigned>(tiles)), kBlock, smem1, stream)(
      static_cast<T*>(table), W, items, p, r, m, n, d, sub_k, lr, reg, udelta, pred, head, tail);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto pass2 = combine_spanning_runs<T, float>;
  FPS_LAUNCH(pass2, dim3(static_cast<unsigned>(tiles)), kBlock, smem2, stream)(
      static_cast<T*>(table), W, items, n, d, sub_k, L, static_cast<const float*>(head),
      static_cast<const float*>(tail));
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
  if (d <= 8 * kWarp)
    return launch<T, 8>(table, W, items, p, r, m, n, d, sub_k, lr, reg, udelta, pred, head, tail, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fps

// d <= 256 (the wrapper checks; wider rows return cudaErrorInvalidValue).
// head/tail: ceil(n / fps_chunk_lanes()) * d floats.  Returns the CUDA
// error code of the launches (0 = ok).
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

// Sorted lanes of the smallest tile (d 256): at every width the tiles are
// at most ceil(n / this), which is what the wrappers size head/tail by.
extern "C" int fps_chunk_lanes() { return fps::Tile<8>::kLanes; }
