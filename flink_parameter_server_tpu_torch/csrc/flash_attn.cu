// Causal flash attention: forward, dQ and dK/dV, on (B, T, H, D) tensors.
//
// Replaces the TPU kernels behind flink_parameter_server_tpu/ops/
// flash_attention.py (_make_kernel: JAX's splash attention).  Splash runs
// three pallas_calls for training with its default block sizes: the
// forward (splash_attention_kernel.py flash_attention_kernel), dQ
// (_flash_attention_dq_kernel) and dK/dV (_flash_attention_dkv_kernel).
// This file has one kernel for each:
//
//   flash_fwd     O = softmax(q k^T + causal) v with an online softmax over
//                 key tiles; writes O and the float32 log-sum-exp L = m +
//                 log(l) of each query row for the backward.
//   flash_bwd_dq  one block per query tile; recomputes P = exp(q k^T - L),
//                 D_i = rowsum(dO * O) in float32 (written out for the dK/dV
//                 kernel), dP = dO v^T, dS = P * (dP - D), dQ = sum dS k.
//   flash_bwd_dkv one block per key tile, over the query tiles at or below
//                 the diagonal: dV = sum P^T dO, dK = sum dS^T q.
//
// q arrives scaled by 1/sqrt(D) (the wrapper scales it, as splash's caller
// does), so no kernel scales.  Every score, softmax statistic and sum is
// float32 whatever the load type (float32 or bfloat16); outputs are written
// in the load type.  No atomics: every output element is summed by one
// thread in a fixed order, so results are the same on every run.
//
// What bounds them on an H100.  At the LM's shape (B 16, T 512, H 8, D 64,
// bf16) the bytes (q, k, v, O in and out once, ~34 MB, ~10 us) outweigh
// the tensor-core time of the kept tiles (~5 us).  These kernels do their
// products with float32 FMAs on the CUDA cores (67 TFLOP/s, about 64 us
// for the forward), so operations bound them, and, more than the FMA rate,
// the shared-memory reads behind each FMA: a thread reads one q and one k
// value for every four FMAs of its 4 x 4 sub-tile.  What the design does:
// a 64 x 64 (query x key) tile in shared memory, rows padded by one float
// so the 16 rows a warp reads fall in 16 banks; tiles wholly above the
// causal diagonal are never loaded or computed, and only the diagonal tile
// applies the mask; the longest query rows are scheduled first.
// Tensor-core products (mma.sync / wgmma), TMA loads and pipelining are
// later work.
//
// Thread layout: 256 threads as 16 x 16 (ty, tx).  A thread owns rows
// ty + 16 i and columns tx + 16 j (i, j < 4) of a 64 x 64 tile, and output
// columns tx + 16 c (c < D / 16) of its four rows.  The 16 threads of a row
// sit in one half-warp, so row reductions are four xor shuffles.
#include "runs.cuh"

#include <math.h>

namespace fps {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kSide = 16;       // threads per side of the 16 x 16 block
constexpr int kThreads = kSide * kSide;
constexpr int kPer = kTile / kSide;  // rows (and columns) of a tile per thread
constexpr int kPad = kTile + 1;      // row stride of a 64 x 64 score tile in shared memory

// Element strides of one (B, T, H, D) tensor; the last dimension is contiguous.
struct Layout {
  int64_t b, t, h;
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Sum (or max) over the 16 threads of a row: lanes tx = 0..15 of one half-warp.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = kSide / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Rows [row0, row0 + 64) of head (b, h) into shared memory as float, row
// stride D + 1.  Consecutive threads read consecutive columns.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, const Layout& lay, int b, int h,
                                          int row0) {
  const T* base = src + b * lay.b + h * lay.h + static_cast<int64_t>(row0) * lay.t;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = load_f(base + r * lay.t + c);
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]   (A B^T on a 64 x 64 tile)
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[kPer][kPer], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = A[(ty + kSide * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = B[(tx + kSide * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] += a[i] * b[j];
  }
}

// out[i][c] += sum_kk S[ty + 16 i][kk] * V[kk][tx + 16 c]   (S V with S 64 x 64)
template <int D>
__device__ __forceinline__ void tile_sv(float (&out)[kPer][D / kSide], const float* S, const float* V,
                                        int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < kTile; ++kk) {
    float s[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = S[(ty + kSide * i) * kPad + kk];
#pragma unroll
    for (int c = 0; c < D / kSide; ++c) {
      const float v = V[kk * (D + 1) + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[i][c] += s[i] * v;
    }
  }
}

// Write a thread's rows of a 64 x D float tile to a contiguous (B, T, H, D) output.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[kPer][D / kSide], int b, int h,
                                           int H, int T_len, int row0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int64_t row = row0 + ty + kSide * i;
    T* dst = out + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int c = 0; c < D / kSide; ++c) store_f(dst + tx + kSide * c, acc[i][c]);
  }
}

template <int D>
constexpr int fwd_smem_floats() { return 3 * kTile * (D + 1) + kTile * kPad; }
template <int D>
constexpr int dq_smem_floats() { return 4 * kTile * (D + 1) + kTile * kPad; }
template <int D>
constexpr int dkv_smem_floats() { return 4 * kTile * (D + 1) + 2 * kTile * kPad + 2 * kTile; }

// grid (T / 64, B * H): block x takes query tile T/64 - 1 - x (longest first).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* q, const T* k, const T* v, Layout lq, Layout lk, Layout lv, T* o,
                 float* lse, int H, int T_len) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ps = Vs + kTile * (D + 1);
  constexpr int C = D / kSide;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  load_tile<T, D>(Qs, q, lq, b, h, qt * kTile);
  float m[kPer], l[kPer], acc[kPer][C];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {  // key tiles above the diagonal are skipped
    __syncthreads();  // the previous tile's Ks, Vs, Ps are consumed
    load_tile<T, D>(Ks, k, lk, b, h, kt * kTile);
    load_tile<T, D>(Vs, v, lv, b, h, kt * kTile);
    __syncthreads();
    float s[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = 0.f;
    tile_abt<D>(s, Qs, Ks, ty, tx);
    if (kt == qt) {  // the diagonal tile: key column > query row is masked
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (tx + kSide * j > ty + kSide * i) s[i][j] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kPer; ++j) mx = fmaxf(mx, s[i][j]);
      // every row keeps key 0 of tile 0, so m_new is finite from the first tile on
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kPer; ++j) Ps[(ty + kSide * i) * kPad + tx + kSide * j] = s[i][j];
    }
    __syncthreads();
    tile_sv<D>(acc, Ps, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] *= inv;
    if (tx == 0) lse[static_cast<int64_t>(blockIdx.y) * T_len + qt * kTile + ty + kSide * i] = m[i] + logf(l[i]);
  }
  store_rows<T, D>(o, acc, b, h, H, T_len, qt * kTile, ty, tx);
}

// grid (T / 64, B * H): block x takes query tile T/64 - 1 - x.  Also writes
// delta = rowsum(dO * O) for the dK/dV kernel.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* q, const T* k, const T* v, const T* o, const T* dout, Layout lq,
                    Layout lk, Layout lv, Layout lo, Layout ldo, const float* lse, float* delta,
                    T* dq, int H, int T_len) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * (D + 1);
  float* Ks = dOs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ss = Vs + kTile * (D + 1);
  constexpr int C = D / kSide;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.y) * T_len + qt * kTile;

  load_tile<T, D>(Qs, q, lq, b, h, qt * kTile);
  load_tile<T, D>(dOs, dout, ldo, b, h, qt * kTile);
  load_tile<T, D>(Ks, o, lo, b, h, qt * kTile);  // O, for delta only
  __syncthreads();
  float L[kPer], Di[kPer], acc[kPer][C];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSide * i;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) part += dOs[r * (D + 1) + tx + kSide * c] * Ks[r * (D + 1) + tx + kSide * c];
    Di[i] = row_sum(part);
    L[i] = lse[stat0 + r];
    if (tx == 0) delta[stat0 + r] = Di[i];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();
    load_tile<T, D>(Ks, k, lk, b, h, kt * kTile);
    load_tile<T, D>(Vs, v, lv, b, h, kt * kTile);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<D>(s, Qs, Ks, ty, tx);
    tile_abt<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const bool masked = kt == qt && tx + kSide * j > ty + kSide * i;
        const float p = masked ? 0.f : expf(s[i][j] - L[i]);
        Ss[(ty + kSide * i) * kPad + tx + kSide * j] = p * (dp[i][j] - Di[i]);
      }
    __syncthreads();
    tile_sv<D>(acc, Ss, Ks, ty, tx);
  }
  store_rows<T, D>(dq, acc, b, h, H, T_len, qt * kTile, ty, tx);
}

// grid (T / 64, B * H): block x takes key tile x (the lowest tiles see the
// most query tiles, so they start first).  Thread rows are key rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* q, const T* k, const T* v, const T* dout, Layout lq, Layout lk,
                     Layout lv, Layout ldo, const float* lse, const float* delta, T* dk, T* dv,
                     int H, int T_len) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* Pt = dOs + kTile * (D + 1);  // P^T: key row x query column
  float* dSt = Pt + kTile * kPad;     // dS^T
  float* Ls = dSt + kTile * kPad;
  float* Ds = Ls + kTile;
  constexpr int C = D / kSide;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int kt = blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  load_tile<T, D>(Ks, k, lk, b, h, kt * kTile);
  load_tile<T, D>(Vs, v, lv, b, h, kt * kTile);
  float dK[kPer][C], dV[kPer][C];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dK[i][c] = dV[i][c] = 0.f;

  for (int qt = kt; qt < static_cast<int>(gridDim.x); ++qt) {  // query tiles at or below the diagonal
    __syncthreads();
    load_tile<T, D>(Qs, q, lq, b, h, qt * kTile);
    load_tile<T, D>(dOs, dout, ldo, b, h, qt * kTile);
    if (threadIdx.x < kTile) {
      const int64_t at = static_cast<int64_t>(blockIdx.y) * T_len + qt * kTile + threadIdx.x;
      Ls[threadIdx.x] = lse[at];
      Ds[threadIdx.x] = delta[at];
    }
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_abt<D>(s, Ks, Qs, ty, tx);    // s[i][j] = k[key i] . q[query j]
    tile_abt<D>(dp, Vs, dOs, ty, tx);  // dp[i][j] = v[key i] . dO[query j]
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int key = ty + kSide * i, query = tx + kSide * j;
        const bool masked = qt == kt && key > query;
        const float p = masked ? 0.f : expf(s[i][j] - Ls[query]);
        Pt[key * kPad + query] = p;
        dSt[key * kPad + query] = p * (dp[i][j] - Ds[query]);
      }
    __syncthreads();
    tile_sv<D>(dV, Pt, dOs, ty, tx);
    tile_sv<D>(dK, dSt, Qs, ty, tx);
  }
  store_rows<T, D>(dk, dK, b, h, H, T_len, kt * kTile, ty, tx);
  store_rows<T, D>(dv, dV, b, h, H, T_len, kt * kTile, ty, tx);
}

// ---- launchers ----

inline Layout layout_at(const int64_t* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <typename Kernel>
int prepare(Kernel kernel, int smem_bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int64_t* st, void* o, float* lse,
               int B, int T_len, int H, cudaStream_t stream) {
  const int smem = fwd_smem_floats<D>() * static_cast<int>(sizeof(float));
  int err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != 0) return err;
  dim3 grid(T_len / kTile, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      layout_at(st, 0), layout_at(st, 1), layout_at(st, 2), static_cast<T*>(o), lse, H, T_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const int64_t* st, const float* lse, float* delta, void* dq, int B, int T_len, int H,
              cudaStream_t stream) {
  const int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  int err = prepare(flash_bwd_dq_kernel<T, D>, smem);
  if (err != 0) return err;
  dim3 grid(T_len / kTile, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), layout_at(st, 0), layout_at(st, 1),
      layout_at(st, 2), layout_at(st, 3), layout_at(st, 4), lse, delta, static_cast<T*>(dq), H,
      T_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const int64_t* st,
               const float* lse, const float* delta, void* dk, void* dv, int B, int T_len, int H,
               cudaStream_t stream) {
  const int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  int err = prepare(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != 0) return err;
  dim3 grid(T_len / kTile, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), layout_at(st, 0), layout_at(st, 1), layout_at(st, 2),
      layout_at(st, 3), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, T_len);
  return static_cast<int>(cudaGetLastError());
}

// Picks the template for (dtype, head_dim); cudaErrorInvalidValue for any other.
#define FPS_FLASH_DISPATCH(CALL)                                                  \
  switch (dtype * 1000 + head_dim) {                                              \
    case fps::kF32 * 1000 + 64: return CALL(float, 64);                           \
    case fps::kF32 * 1000 + 128: return CALL(float, 128);                         \
    case fps::kBF16 * 1000 + 64: return CALL(__nv_bfloat16, 64);                  \
    case fps::kBF16 * 1000 + 128: return CALL(__nv_bfloat16, 128);                \
    default: return static_cast<int>(cudaErrorInvalidValue);                      \
  }

}  // namespace fps

// strides: (b, t, h) element strides of each input in argument order, from a
// host array.  Outputs (o, dq, dk, dv) are contiguous (B, T, H, D); lse and
// delta contiguous (B, H, T) float32.  T must be a multiple of 64.  Each
// returns the CUDA error code of its launch (0 = ok).
extern "C" int fps_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                             const int64_t* strides, void* o, float* lse, int B, int T, int H,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPS_CALL(TYPE, DIM) fps::launch_fwd<TYPE, DIM>(q, k, v, strides, o, lse, B, T, H, s)
  FPS_FLASH_DISPATCH(FPS_CALL)
#undef FPS_CALL
}

extern "C" int fps_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* o, const void* dout,
                                const int64_t* strides, const float* lse, float* delta, void* dq,
                                int B, int T, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPS_CALL(TYPE, DIM) \
  fps::launch_dq<TYPE, DIM>(q, k, v, o, dout, strides, lse, delta, dq, B, T, H, s)
  FPS_FLASH_DISPATCH(FPS_CALL)
#undef FPS_CALL
}

extern "C" int fps_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* dout, const int64_t* strides,
                                 const float* lse, const float* delta, void* dk, void* dv, int B,
                                 int T, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPS_CALL(TYPE, DIM) \
  fps::launch_dkv<TYPE, DIM>(q, k, v, dout, strides, lse, delta, dk, dv, B, T, H, s)
  FPS_FLASH_DISPATCH(FPS_CALL)
#undef FPS_CALL
}
