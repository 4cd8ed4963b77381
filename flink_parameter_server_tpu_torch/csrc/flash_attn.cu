// Causal flash attention: forward, dQ and dK/dV, on (B, T, H, D) tensors.
//
// Replaces the TPU kernels behind flink_parameter_server_tpu/ops/
// flash_attention.py (_make_kernel: JAX's splash attention).  Splash runs
// three pallas_calls for training with its default block sizes: the
// forward (splash_attention_kernel.py pallas_call :1137, body
// flash_attention_kernel), dQ (:1635, _flash_attention_dq_kernel) and
// dK/dV (:2196, _flash_attention_dkv_kernel).  This file has one kernel
// for each, in three routes:
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
// Routes.  At head widths 64, 128, 192 and 256 bfloat16 inputs take the
// tensor-core kernels (flash_fwd_mma, flash_bwd_dq_mma, flash_bwd_dkv_mma):
// bf16 mma.sync m16n8k16 with float32 sums, operands fed by ldmatrix from
// bf16 tiles that cp.async streams through a two-stage ring.  float32
// inputs take the 3xTF32 kernels (flash_fwd_tf32, flash_bwd_dq_tf32,
// flash_bwd_dkv_tf32): TF32 mma.sync m16n8k8, each float32 product as
// three TF32 products of the operands' big and small halves (mma.cuh),
// which keeps float32's bar (rtol 1e-5) where one TF32 product keeps about
// three decimal digits.  Every wider multiple of 64 takes, in both dtypes,
// the column-split kernels on the tensor cores (flash_fwd_split_mma,
// flash_bwd_dq_split_mma, flash_bwd_dkv_split_mma: bf16 mma.sync or
// 3xTF32; see each).  No kernel runs on the CUDA cores alone.
//
// q arrives scaled by 1/sqrt(D) (the wrapper scales it, as splash's caller
// does), so no kernel scales.  Every score, softmax statistic and sum is
// float32 whatever the load type; outputs are written in the load type.
// Roundings are the reference's: the forward keeps P in float32 (splash
// multiplies float32 P by v cast to float32; the tensor-core forward splits
// it into two bf16 operands, hi + lo), the dQ kernel rounds dS to bf16
// before its product with k, and the dK/dV kernel rounds P and dS to bf16
// before their products with dO and q, as splash's kernels do.  No atomics:
// every output element is summed by one thread in a fixed order, so results
// are the same on every run.
//
// What bounds them on an H100.  At the LM's shape (B 16, T 512, H 8, D 64,
// bf16) the bytes (q, k, v, O in and out once, ~34 MB, ~10 us) outweigh
// the tensor-core time of the (query, key) pairs the causal mask keeps
// (~4.4 us forward, ~6.5 us with the forward's third product).  In
// float32 at a dp-4 or tp-4 rank's share of it (4 or 16 x 512 x 8 or 2 x
// 64) the products bound all three: three TF32 products each of the causal
// pairs' 1.1 (forward), 1.6 (dQ) and 2.2 (dK/dV) GFLOP over 495 TFLOP/s,
// 0.0065, 0.0098 and 0.013 ms, against 0.005-0.0075 ms of bytes.  Past D
// 256 (B 2, T 1024, H 2, D 320) the bytes bound the bf16 forward and dQ
// (0.0031 and 0.0047 ms) and the products bf16 dK/dV (0.0054 ms); in
// float32 the 3xTF32 products bound all three (0.0163, 0.0244 and 0.0326
// ms).
//
// What the designs do:
//
//   tensor-core kernels: a block owns 64 rows (4 warps x 16; where a
//   warp's float32 accumulators would crowd out its score fragments, two
//   sets of 4 warps split the output columns: dK/dV above D 64, dQ above
//   D 128, the forward at D 256), streams 64-row
//   tiles of the other side through the cp.async ring so the next tile's
//   load overlaps this tile's products, keeps scores in registers and turns
//   a product's accumulators into the next product's A operand without
//   shared memory.  Tile rows are padded by 16 B so the eight rows of an
//   ldmatrix fall in eight different banks.
//   3xTF32 kernels: the same shape in float32 (see there), 64 or 32 own
//   rows, each streamed tile split into its TF32 halves once, when it
//   lands.
//   column-split kernels: a block's own rows held whole (or, past where
//   they fit, streamed beside each piece), the other side streamed in 64
//   x 64 pieces, the scores built once a block and shared by its warps
//   through shared memory, the output columns split into slices of up to
//   8 pieces (4 for dK/dV, which holds two outputs) (see there).
//
// All skip tiles wholly above the causal diagonal (never loaded or
// computed), mask only at the diagonal, and schedule the longest query
// rows first.
#include "mma.cuh"
#include "runs.cuh"

#include <math.h>

#include <type_traits>

namespace fps {

using bf16 = __nv_bfloat16;

constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use on an H100

// Element strides of one (B, T, H, D) tensor; the last dimension is contiguous.
struct Layout {
  int64_t b, t, h;
};

// ---- tensor-core kernels (bf16 mma.sync) ----

constexpr int kMma = 64;  // rows of every tile: a block's own 64 rows (4 warps x 16) and each streamed tile

// Row stride in shared memory, in bf16: D + 8, so consecutive rows start
// 16 B further along the 128-B bank cycle and the eight row addresses of
// an ldmatrix hit eight different bank groups.
template <int D>
__host__ __device__ constexpr int row_stride() { return D + 8; }

// Rows [row0, row0 + 64) of head (b, h) into shared memory with cp.async,
// 16 B a thread per copy, kN threads.  Needs 16-byte aligned rows (the
// wrapper checks the pointers and strides).
template <int D, int kN>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, const Layout& lay, int b, int h,
                                           int row0) {
  constexpr int kChunks = D / 8;  // 16-byte pieces of a row
  const bf16* base = src + b * lay.b + h * lay.h + static_cast<int64_t>(row0) * lay.t;
  for (int i = threadIdx.x; i < kMma * kChunks; i += kN) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    cp_async_16(dst + r * row_stride<D>() + c, base + r * lay.t + c);
  }
}

// Where each lane points ldmatrix_x4 at a 16 x 16 piece of a row-major
// tile (row r, column c relative to the piece):
//   A operand, rows = the product's rows:            r = lane % 16,                 c = 8 (lane / 16)
//   B operand, rows = n (the product's columns):     r = 8 (lane / 16) + lane % 8,  c = 8 (lane / 8 % 2)
//     -> r[0], r[1] are b0, b1 of columns 0-7; r[2], r[3] of columns 8-15
//   B operand, rows = k, transposed (P V, P^T dO):   r = 8 (lane / 8 % 2) + lane % 8, c = 8 (lane / 16)
//     -> the same registers, for the tile's columns 0-7 and 8-15
struct Lanes {
  int a_row, a_col, b_row, b_col, t_row, t_col, g, t4;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane % 16), a_col(8 * (lane / 16)), b_row(8 * (lane / 16) + lane % 8),
        b_col(8 * (lane / 8 % 2)), t_row(8 * (lane / 8 % 2) + lane % 8), t_col(8 * (lane / 16)),
        g(lane / 4), t4(lane % 4) {}
};

// One step of the online softmax over a warp's N 16 x 8 score tiles (rows
// g and g + 8 of each lane; the four lanes of a row group, xor 1 and 2,
// share them): the running max m and sum l move on, the scores become
// exp(s - m) and the NO output tiles are scaled to the new max.  Every row
// keeps key 0 of the first step, so m is finite from there on.
template <int N, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[N][4], float (&acc)[NO][4], float (&m)[2],
                                             float (&l)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = expf(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = expf(s[n][e] - mx[e >> 1]);
      sum[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    l[i] = l[i] * alpha[i] + sum[i];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// The forward's shape by head width, from ptxas's register report (no
// spills): at D 256 two sets of four warps split O's columns, both
// computing the same S, so that a lane holds 64 O accumulators, not 128;
// above D 64 a warp takes its 64-key tile in two softmax steps of 32 keys.
template <int D>
__host__ __device__ constexpr int fwd_splits() { return D <= 192 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int fwd_key_step() { return D <= 64 ? 64 : 32; }
template <int D>
constexpr int fwd_mma_smem_bytes() { return 5 * kMma * row_stride<D>() * 2; }  // Q, 2 x K, 2 x V

// grid (T / 64, B * H), 128 x fwd_splits threads: block x takes query tile
// T/64 - 1 - x (longest first).  Warp w owns query rows 16 (w % 4) .. + 15
// of the tile and O's columns (w / 4) D / splits onwards; lane (g, t4)
// holds rows g and g + 8 of them.
template <int D>
__global__ void __launch_bounds__(128 * fwd_splits<D>())
flash_fwd_mma_kernel(const bf16* q, const bf16* k, const bf16* v, Layout lq, Layout lk, Layout lv,
                     bf16* o, float* lse, int H, int T_len) {
  constexpr int kN = 128 * fwd_splits<D>(), DS = D / fwd_splits<D>(), KS = fwd_key_step<D>();
  constexpr int S = row_stride<D>(), kTileElems = kMma * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTileElems;      // two stages
  bf16* Vs = Ks + 2 * kTileElems;  // two stages
  const Lanes ln(threadIdx.x % 32);
  const int warp = threadIdx.x / 32;
  const int w0 = 16 * (warp % 4), c0 = DS * (warp / 4);  // query rows and O columns of the warp
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;

  tile_async<D, kN>(Qs, q, lq, b, h, qt * kMma);
  tile_async<D, kN>(Ks, k, lk, b, h, 0);
  tile_async<D, kN>(Vs, v, lv, b, h, 0);
  cp_async_commit();

  float acc[DS / 8][4];
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  for (int kt = 0; kt <= qt; ++kt) {  // key tiles above the diagonal are skipped
    const int st = kt & 1;
    if (kt < qt) {  // the next tile streams in while this one is used
      tile_async<D, kN>(Ks + (st ^ 1) * kTileElems, k, lk, b, h, (kt + 1) * kMma);
      tile_async<D, kN>(Vs + (st ^ 1) * kTileElems, v, lv, b, h, (kt + 1) * kMma);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * kTileElems;
    const bf16* Vt = Vs + st * kTileElems;

#pragma unroll
    for (int kc = 0; kc < kMma; kc += KS) {  // keys kc .. kc + KS - 1 of the tile
      float s[KS / 8][4];  // S = q k^T: 16 rows x KS keys, 16 x 8 pieces
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t a[4];
        ldmatrix_x4(a, Qs + (w0 + ln.a_row) * S + 16 * kd + ln.a_col);
#pragma unroll
        for (int n = 0; n < KS / 8; n += 2) {
          uint32_t bb[4];
          ldmatrix_x4(bb, Kt + (kc + 8 * n + ln.b_row) * S + 16 * kd + ln.b_col);
          mma_bf16(s[n], a, bb[0], bb[1]);
          mma_bf16(s[n + 1], a, bb[2], bb[3]);
        }
      }
      if (kt == qt) {  // the diagonal tile: key column > query row is masked
#pragma unroll
        for (int n = 0; n < KS / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kc + 8 * n + 2 * ln.t4 + (e & 1) > w0 + ln.g + 8 * (e >> 1)) s[n][e] = -INFINITY;
      }
      softmax_step(s, acc, m, l);
      // O += P v with P = hi + lo, both bf16: P keeps float32's digits
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {  // keys kc + 16 kk .. + 15
        uint32_t hi[4], lo[4];
        acc_to_a_split(hi, lo, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < DS / 8; n += 2) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, Vt + (kc + 16 * kk + ln.t_row) * S + c0 + 8 * n + ln.t_col);
          mma_bf16(acc[n], hi, bb[0], bb[1]);
          mma_bf16(acc[n], lo, bb[0], bb[1]);
          mma_bf16(acc[n + 1], hi, bb[2], bb[3]);
          mma_bf16(acc[n + 1], lo, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qt * kMma + w0 + ln.g + 8 * i;
    const float inv = 1.f / l[i];
    bf16* dst = o + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + c0 + 2 * ln.t4;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (c0 == 0 && ln.t4 == 0) lse[static_cast<int64_t>(blockIdx.y) * T_len + row] = m[i] + logf(l[i]);
  }
}

// The dQ kernel's shape by head width: above D 128 two sets of four warps
// split dQ's columns, both computing the same S and dP, so that a lane
// holds at most 64 dQ accumulators; above D 64 a warp takes its 64-key
// tile in two steps of 32 keys, so that S and dP fit beside them.
template <int D>
__host__ __device__ constexpr int dq_splits() { return D <= 128 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int dq_key_step() { return D <= 64 ? 64 : 32; }
template <int D>
constexpr int dq_mma_smem_bytes() {  // q, dO, 2 x K, 2 x V; delta
  return 6 * kMma * row_stride<D>() * 2 + kMma * 4;
}

// grid (T / 64, B * H), 128 x dq_splits threads: block x takes query tile
// T/64 - 1 - x (longest first).  Warp w owns query rows 16 (w % 4) .. + 15
// and dQ's columns (w / 4) D / splits onwards.  What splash's dQ kernel
// computes: delta = rowsum(dO * O) in float32 (written for the dK/dV
// kernel), and over the key tiles at or below the diagonal P = exp(q k^T -
// L), dP = dO v^T, dS = P (dP - delta), dQ += bf16(dS) k.
template <int D>
__global__ void __launch_bounds__(128 * dq_splits<D>())
flash_bwd_dq_mma_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                        Layout lq, Layout lk, Layout lv, Layout lo, Layout ldo, const float* lse,
                        float* delta, bf16* dq, int H, int T_len) {
  constexpr int kN = 128 * dq_splits<D>(), DS = D / dq_splits<D>(), KS = dq_key_step<D>();
  constexpr int S = row_stride<D>(), kTileElems = kMma * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTileElems;
  bf16* Ks = dOs + kTileElems;     // two stages
  bf16* Vs = Ks + 2 * kTileElems;  // two stages
  float* Ds = reinterpret_cast<float*>(Vs + 2 * kTileElems);  // delta of the tile's rows
  const Lanes ln(threadIdx.x % 32);
  const int warp = threadIdx.x / 32;
  const int w0 = 16 * (warp % 4), c0 = DS * (warp / 4);  // query rows and dQ columns of the warp
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.y) * T_len + qt * kMma;

  tile_async<D, kN>(Qs, q, lq, b, h, qt * kMma);
  tile_async<D, kN>(dOs, dout, ldo, b, h, qt * kMma);
  tile_async<D, kN>(Ks, k, lk, b, h, 0);
  tile_async<D, kN>(Vs, v, lv, b, h, 0);
  cp_async_commit();

  {  // delta while the tiles stream in: kN / 64 neighbouring threads share a row
    constexpr int kParts = kN / kMma, kCols = D / kParts;
    const int r = threadIdx.x / kParts, c = (threadIdx.x % kParts) * kCols;
    const int64_t row = qt * kMma + r;
    const uint32_t* ow = reinterpret_cast<const uint32_t*>(o + b * lo.b + h * lo.h + row * lo.t + c);
    const uint32_t* dw = reinterpret_cast<const uint32_t*>(dout + b * ldo.b + h * ldo.h + row * ldo.t + c);
    float part = 0.f;
#pragma unroll 8
    for (int j = 0; j < kCols / 2; ++j) {
      const uint32_t x = ow[j], y = dw[j];
      part += bf16_lo(x) * bf16_lo(y) + bf16_hi(x) * bf16_hi(y);
    }
#pragma unroll
    for (int off = kParts / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (threadIdx.x % kParts == 0) {
      Ds[r] = part;
      delta[stat0 + r] = part;
    }
  }
  __syncthreads();
  float L[2], Di[2];  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    L[i] = lse[stat0 + w0 + ln.g + 8 * i];
    Di[i] = Ds[w0 + ln.g + 8 * i];
  }
  float acc[DS / 8][4];
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {  // key tiles above the diagonal are skipped
    const int st = kt & 1;
    if (kt < qt) {  // the next tile streams in while this one is used
      tile_async<D, kN>(Ks + (st ^ 1) * kTileElems, k, lk, b, h, (kt + 1) * kMma);
      tile_async<D, kN>(Vs + (st ^ 1) * kTileElems, v, lv, b, h, (kt + 1) * kMma);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + st * kTileElems;
    const bf16* Vt = Vs + st * kTileElems;

#pragma unroll
    for (int kc = 0; kc < kMma; kc += KS) {  // keys kc .. kc + KS - 1 of the tile
      float s[KS / 8][4], dp[KS / 8][4];  // S = q k^T and dP = dO v^T: 16 rows x KS keys
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t qa[4], oa[4];
        ldmatrix_x4(qa, Qs + (w0 + ln.a_row) * S + 16 * kd + ln.a_col);
        ldmatrix_x4(oa, dOs + (w0 + ln.a_row) * S + 16 * kd + ln.a_col);
#pragma unroll
        for (int n = 0; n < KS / 8; n += 2) {
          uint32_t kb[4], vb[4];
          ldmatrix_x4(kb, Kt + (kc + 8 * n + ln.b_row) * S + 16 * kd + ln.b_col);
          ldmatrix_x4(vb, Vt + (kc + 8 * n + ln.b_row) * S + 16 * kd + ln.b_col);
          mma_bf16(s[n], qa, kb[0], kb[1]);
          mma_bf16(s[n + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[n], oa, vb[0], vb[1]);
          mma_bf16(dp[n + 1], oa, vb[2], vb[3]);
        }
      }
      // P = exp(S - L), masked above the diagonal; dS = P (dP - delta), into dp
#pragma unroll
      for (int n = 0; n < KS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = w0 + ln.g + 8 * (e >> 1), key = kc + 8 * n + 2 * ln.t4 + (e & 1);
          const float p = (kt == qt && key > row) ? 0.f : expf(s[n][e] - L[e >> 1]);
          dp[n][e] = p * (dp[n][e] - Di[e >> 1]);
        }
      // dQ += dS k, with dS rounded to bf16 as splash does
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {  // keys kc + 16 kk .. + 15
        uint32_t da[4];
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < DS / 8; n += 2) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, Kt + (kc + 16 * kk + ln.t_row) * S + c0 + 8 * n + ln.t_col);
          mma_bf16(acc[n], da, kb[0], kb[1]);
          mma_bf16(acc[n + 1], da, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = qt * kMma + w0 + ln.g + 8 * i;
    bf16* dst = dq + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + c0 + 2 * ln.t4;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// The dK/dV kernel's warp sets: above D 64 two sets of four warps split the
// output columns, each set holding D / 2 columns of dK and dV, and both
// computing the same S^T and dP^T.  Above 96 columns a warp takes its 64
// query columns in four passes of 16, so that its scores fit beside the
// accumulators (ptxas's register report: no spills).
template <int D>
__host__ __device__ constexpr int dkv_splits() { return D <= 64 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int dkv_pass() { return D / dkv_splits<D>() <= 96 ? 64 : 16; }
template <int D>
constexpr int dkv_mma_smem_bytes() {  // K, V, 2 x q, 2 x dO, 2 x (L, D)
  return 6 * kMma * row_stride<D>() * 2 + 4 * kMma * 4;
}

// grid (T / 64, B * H), 128 x dkv_splits threads: block x takes key tile x
// (the lowest tiles see the most query tiles, so they start first).  Warp
// w owns key rows 16 (w % 4) .. + 15 and output columns (w / 4) D / splits
// onwards.
template <int D>
__global__ void __launch_bounds__(128 * dkv_splits<D>())
flash_bwd_dkv_mma_kernel(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, Layout lq,
                         Layout lk, Layout lv, Layout ldo, const float* lse, const float* delta,
                         bf16* dk, bf16* dv, int H, int T_len) {
  constexpr int kN = 128 * dkv_splits<D>(), DS = D / dkv_splits<D>(), QP = dkv_pass<D>();
  constexpr int S = row_stride<D>(), kTileElems = kMma * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTileElems;
  bf16* Qs = Vs + kTileElems;        // two stages
  bf16* dOs = Qs + 2 * kTileElems;   // two stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kTileElems);  // two stages of 64
  float* Ds = Ls + 2 * kMma;                                   // two stages of 64
  const Lanes ln(threadIdx.x % 32);
  const int warp = threadIdx.x / 32;
  const int w0 = 16 * (warp % 4), c0 = DS * (warp / 4);  // key rows and output columns of the warp
  const int kt = blockIdx.x, nq = gridDim.x;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.y) * T_len;

  // q, dO, L and D of query tile qt into stage st
  auto load_queries = [&](int qt, int st) {
    tile_async<D, kN>(Qs + st * kTileElems, q, lq, b, h, qt * kMma);
    tile_async<D, kN>(dOs + st * kTileElems, dout, ldo, b, h, qt * kMma);
    const int i = threadIdx.x;
    if (i < kMma / 4) cp_async_16(Ls + st * kMma + 4 * i, lse + stat0 + qt * kMma + 4 * i);
    else if (i < kMma / 2) cp_async_16(Ds + st * kMma + 4 * (i - kMma / 4), delta + stat0 + qt * kMma + 4 * (i - kMma / 4));
  };
  tile_async<D, kN>(Ks, k, lk, b, h, kt * kMma);
  tile_async<D, kN>(Vs, v, lv, b, h, kt * kMma);
  load_queries(kt, 0);
  cp_async_commit();

  float dK[DS / 8][4], dV[DS / 8][4];
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.f;

  for (int qt = kt; qt < nq; ++qt) {  // query tiles at or below the diagonal
    const int st = (qt - kt) & 1;
    if (qt + 1 < nq) {  // the next tile streams in while this one is used
      load_queries(qt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + st * kTileElems;
    const bf16* dOt = dOs + st * kTileElems;
    const float* Lt = Ls + st * kMma;
    const float* Dt = Ds + st * kMma;

#pragma unroll
    for (int qp = 0; qp < kMma; qp += QP) {  // query columns qp .. qp + QP - 1
      float s[QP / 8][4], dp[QP / 8][4];  // S^T = k q^T and dP^T = v dO^T: 16 keys x QP queries
#pragma unroll
      for (int n = 0; n < QP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, Ks + (w0 + ln.a_row) * S + 16 * kd + ln.a_col);
        ldmatrix_x4(va, Vs + (w0 + ln.a_row) * S + 16 * kd + ln.a_col);
#pragma unroll
        for (int n = 0; n < QP / 8; n += 2) {
          uint32_t qb[4], ob[4];
          ldmatrix_x4(qb, Qt + (qp + 8 * n + ln.b_row) * S + 16 * kd + ln.b_col);
          ldmatrix_x4(ob, dOt + (qp + 8 * n + ln.b_row) * S + 16 * kd + ln.b_col);
          mma_bf16(s[n], ka, qb[0], qb[1]);
          mma_bf16(s[n + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[n], va, ob[0], ob[1]);
          mma_bf16(dp[n + 1], va, ob[2], ob[3]);
        }
      }
      // P^T = exp(S^T - L), masked above the diagonal; dS^T = P^T (dP^T - D)
#pragma unroll
      for (int n = 0; n < QP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = w0 + ln.g + 8 * (e >> 1), query = qp + 8 * n + 2 * ln.t4 + (e & 1);
          const float p = (qt == kt && key > query) ? 0.f : expf(s[n][e] - Lt[query]);
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Dt[query]);
        }
      // dV += P^T dO and dK += dS^T q, with P^T and dS^T rounded to bf16 as splash does
#pragma unroll
      for (int kk = 0; kk < QP / 16; ++kk) {
        uint32_t pa[4], da[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < DS / 8; n += 2) {
          uint32_t ob[4], qb[4];
          ldmatrix_x4_trans(ob, dOt + (qp + 16 * kk + ln.t_row) * S + c0 + 8 * n + ln.t_col);
          ldmatrix_x4_trans(qb, Qt + (qp + 16 * kk + ln.t_row) * S + c0 + 8 * n + ln.t_col);
          mma_bf16(dV[n], pa, ob[0], ob[1]);
          mma_bf16(dV[n + 1], pa, ob[2], ob[3]);
          mma_bf16(dK[n], da, qb[0], qb[1]);
          mma_bf16(dK[n + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = kt * kMma + w0 + ln.g + 8 * i;
    const int64_t at = ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + c0 + 2 * ln.t4;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * n) = pack_bf16(dK[n][2 * i], dK[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * n) = pack_bf16(dV[n][2 * i], dV[n][2 * i + 1]);
    }
  }
}

// ---- float32 tensor-core kernels (3xTF32 mma.sync, backward) ----
//
// The shape of the bf16 backward kernels, in float32, with every product
// three TF32 mma.m16n8k8 (mma.cuh, "3xTF32").  A block owns kM rows (warps
// of 16); the other side streams past in kS-row tiles through a two-stage
// cp.async ring, so the next tile's load overlaps this tile's products.
// Splitting a float into its TF32 halves costs ALU work, and every warp
// reads the whole streamed tile as a B operand, so each tile is split once,
// in place, when it lands: a "big" plane (x rounded to TF32) and a "small"
// plane (x - big) that all warps then read with no further work.  The
// block's own rows are the A operands, split as each warp loads them.
// Operands of the score products (rows with d contiguous) come by
// ldmatrix, which moves float32 rows as pairs of bf16; a product's
// accumulators become the next product's A operand in registers, its k
// index permuted (acc_to_a_tf32), and that product's B rows are read as
// scalars in the same order.  Rows are padded to D + 4 floats: the eight
// rows of an ldmatrix start 16 B apart in the bank cycle, and a warp's
// scalar reads of rows 2t and 2t + 1 at column g fall in banks 8t + g, all
// different.

// Row stride in shared memory, in floats.
template <int D>
__host__ __device__ constexpr int f32_stride() { return D + 4; }
// Rows a block owns, and rows of each streamed tile: halved above D 128,
// so that the own tiles and two stages of split streamed tiles fit.
template <int D>
__host__ __device__ constexpr int f32_own() { return D <= 128 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr int f32_step() { return D <= 128 ? 32 : 16; }
template <int D>
constexpr int f32_smem_bytes() {  // two own tiles, two stages of two split tiles, statistics
  return (2 * f32_own<D>() + 8 * f32_step<D>()) * f32_stride<D>() * 4 + 4 * f32_step<D>() * 4 +
         f32_own<D>() * 4;
}

// Rows [row0, row0 + kR) of head (b, h) into shared memory with cp.async,
// 16 B (four floats) a thread per copy, kN threads.  Needs 16-byte aligned
// rows (the wrapper checks the pointers and strides).
template <int D, int kR, int kN>
__device__ __forceinline__ void tile_async_f32(float* dst, const float* src, const Layout& lay, int b, int h,
                                               int row0) {
  constexpr int kChunks = D / 4;  // 16-byte pieces of a row
  const float* base = src + b * lay.b + h * lay.h + static_cast<int64_t>(row0) * lay.t;
  for (int i = threadIdx.x; i < kR * kChunks; i += kN) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    cp_async_16(dst + r * f32_stride<D>() + c, base + r * lay.t + c);
  }
}

// A landed kR-row tile split in place: big keeps x rounded to TF32, small
// takes x - big.  kN threads, four floats each a step.
template <int D, int kR, int kN>
__device__ __forceinline__ void split_tile_f32(float* big, float* small) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < kR * kChunks; i += kN) {
    const int at = (i / kChunks) * f32_stride<D>() + (i % kChunks) * 4;
    float4 x = *reinterpret_cast<const float4*>(big + at), lo;
    float* xs = &x.x;
    float* ls = &lo.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hi = __uint_as_float(to_tf32(xs[e]));
      ls[e] = xs[e] - hi;
      xs[e] = hi;
    }
    *reinterpret_cast<float4*>(big + at) = x;
    *reinterpret_cast<float4*>(small + at) = lo;
  }
}

// Lanes of a float32 ldmatrix_x4 (Lanes' rows, its columns in floats):
// A operand at (row a_row, column a_col) of a 16 x 8 piece, B operand with
// rows = n at (b_row, b_col) of a 16 x 8 piece (two n-tiles).
struct LanesF32 {
  int a_row, a_col, b_row, b_col, g, t4;
  __device__ __forceinline__ explicit LanesF32(int lane)
      : a_row(lane % 16), a_col(4 * (lane / 16)), b_row(8 * (lane / 16) + lane % 8),
        b_col(4 * (lane / 8 % 2)), g(lane / 4), t4(lane % 4) {}
};

// A split streamed tile: its big and small planes.
struct PlanesF32 {
  const float* big;
  const float* small;
};

// acc[i][n] = X_i Y_i^T over the full D for a warp's 16 rows (w0..) of the
// own tiles X_i against the N n-tiles of the split streamed tiles Y_i, for
// P products at once: the forward's score (P 1), the backward's two (S
// and dP).  Two 8-column steps of d chain through the tensor cores (six
// truncating adds, too few to drift), then join the sums in the CUDA
// cores.  A loop trip takes kU such pairs, so that kU chains are in
// flight: the forward's one product leaves the registers for two.
template <int D, int N, int P, int kU = 1>
__device__ __forceinline__ void scores_tf32(float (&acc)[P][N][4], const float* const (&X)[P],
                                            const PlanesF32 (&Y)[P], int w0, const LanesF32& ln) {
  constexpr int S = f32_stride<D>();
  static_assert(D % (16 * kU) == 0, "whole pairs of d steps a trip");
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
#pragma unroll 1
  for (int kd1 = 0; kd1 < D / 8; kd1 += 2 * kU) {
#pragma unroll
    for (int pair = 0; pair < kU; ++pair) {
      const int kd0 = kd1 + 2 * pair;
      float t[P][N][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kd = kd0 + half;
        uint32_t xr[P][4];
#pragma unroll
        for (int i = 0; i < P; ++i) ldmatrix_x4(xr[i], X[i] + (w0 + ln.a_row) * S + 8 * kd + ln.a_col);
        Split<4> xa[P];
#pragma unroll
        for (int i = 0; i < P; ++i) xa[i] = split4(xr[i]);
#pragma unroll
        for (int n = 0; n < N; n += 2) {  // an ldmatrix_x4 holds B of two n-tiles
          const int at = (8 * n + ln.b_row) * S + 8 * kd + ln.b_col;
          Split<4> yb[P];
#pragma unroll
          for (int i = 0; i < P; ++i) {
            ldmatrix_x4(yb[i].big, Y[i].big + at);
            ldmatrix_x4(yb[i].small, Y[i].small + at);
          }
#pragma unroll
          for (int i = 0; i < P; ++i) {
            if (half == 0) mma_3xtf32_chain<false, 2>(t[i], n, xa[i], yb[i]);
            else mma_3xtf32_chain<true, 2>(t[i], n, xa[i], yb[i]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < P; ++i) acc[i][n][e] += t[i][n][e];
    }
  }
}

// out[n] += C Z for the 16 x 8 accumulator tile c (its columns = rows z0 ..
// z0 + 7 of the split tile Z) and Z's columns c0 + 8 n: the lane reads rows
// z0 + 2t, z0 + 2t + 1 at column g, the k order acc_to_a_tf32 gives; four
// n-tiles at a time.
template <int D, int N>
__device__ __forceinline__ void acc_times_rows(float (&out)[N][4], const float (&c)[4], PlanesF32 Z, int z0,
                                               int c0, const LanesF32& ln) {
  constexpr int S = f32_stride<D>(), J = 4;
  static_assert(N % J == 0, "output columns come in groups of four n-tiles");
  const Split<4> a = acc_to_a_tf32(c);
  const int at = (z0 + 2 * ln.t4) * S + c0 + ln.g;
#pragma unroll
  for (int n = 0; n < N; n += J) {
    Split<2 * J> b;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      b.big[2 * j] = __float_as_uint(Z.big[at + 8 * (n + j)]);
      b.small[2 * j] = __float_as_uint(Z.small[at + 8 * (n + j)]);
      b.big[2 * j + 1] = __float_as_uint(Z.big[at + S + 8 * (n + j)]);
      b.small[2 * j + 1] = __float_as_uint(Z.small[at + S + 8 * (n + j)]);
    }
    mma_3xtf32<J>(out, n, a, b);
  }
}

// The dQ kernel's warp sets: above D 128 two sets split dQ's columns, both
// computing the same S and dP, so that a lane holds at most 64 dQ sums.
template <int D>
__host__ __device__ constexpr int dq_f32_splits() { return D <= 128 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int dq_f32_threads() { return 2 * f32_own<D>() * dq_f32_splits<D>(); }
// The forward's shape by head width: at D 64 a block owns 64 query rows
// in one warp set; past it, 32 rows and two warp sets that split O's
// columns, both computing the same S, so that a lane holds at most 64 O
// sums.  Shared memory holds the q tile and two stages of split K and V
// tiles (f32_step rows: 32, or 16 past D 128): 87 KB at D 64, 152 KB at D
// 128, 166 KB at D 256.
template <int D>
__host__ __device__ constexpr int fwd_f32_splits() { return D <= 64 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int fwd_f32_own() { return D <= 64 ? 64 : 32; }
template <int D>
__host__ __device__ constexpr int fwd_f32_threads() { return 2 * fwd_f32_own<D>() * fwd_f32_splits<D>(); }
template <int D>
constexpr int fwd_f32_smem_bytes() { return (fwd_f32_own<D>() + 8 * f32_step<D>()) * f32_stride<D>() * 4; }

// grid (B * H, T / kM), fwd_f32_threads threads: block (x, y) takes head x's
// query tile T/kM - 1 - y, so that every head's longest tiles start first.
// Warp w owns query rows 16 (w % (kM / 16)) .. + 15 and O's columns (w /
// (kM / 16)) D / splits onwards; lane (g, t4) holds rows g and g + 8 of
// them.  What flash_fwd_mma_kernel computes, in float32: over the keys at
// or below the diagonal, S = q k^T, the online softmax, O += P v.  Both
// products are 3xTF32: S from q (split as each warp loads it) against the
// split K planes; P v with P's accumulators as the A operand
// (acc_to_a_tf32) against the split V planes.  Each 3xTF32 product of P v
// starts from zero and joins O in a float32 add.
//
// Why 32 rows past D 64 (the backward keeps 64 up to D 128): a dp-4
// rank's width at head_dim 256, (4, 512, 2, 256), then has 8 heads x 16
// tiles = 128 blocks of four warps for the 132 SMs, where 64-row tiles
// left 64 blocks, and at head_dim 128 the 256 blocks of four warps,
// longest first, ran faster than 128 blocks of eight (timed against each
// other on the card; PERF.md §6).  At D 64 two blocks share an SM.
template <int D>
__global__ void __launch_bounds__(fwd_f32_threads<D>(), 1)
flash_fwd_tf32_kernel(const float* q, const float* k, const float* v, Layout lq, Layout lk, Layout lv,
                      float* o, float* lse, int H, int T_len) {
  constexpr int kM = fwd_f32_own<D>(), kS = f32_step<D>(), kN = fwd_f32_threads<D>(), kRowWarps = kM / 16;
  constexpr int DS = D / fwd_f32_splits<D>(), S = f32_stride<D>(), kPlane = kS * S;
  static_assert(kM % kS == 0 && kS % 16 == 0 && DS % 32 == 0, "tiles of whole n-tile pairs and groups");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* ring = Qs + kM * S;  // stage st: K big, K small, V big, V small
  const LanesF32 ln(threadIdx.x % 32);
  const int warp = threadIdx.x / 32;
  const int w0 = 16 * (warp % kRowWarps), c0 = DS * (warp / kRowWarps);  // query rows and O columns
  const int qt = gridDim.y - 1 - blockIdx.y, steps = (qt + 1) * (kM / kS);  // key tiles at or below the diagonal
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int row0 = qt * kM + w0;  // the warp's first query row

  tile_async_f32<D, kM, kN>(Qs, q, lq, b, h, qt * kM);
  tile_async_f32<D, kS, kN>(ring, k, lk, b, h, 0);
  tile_async_f32<D, kS, kN>(ring + 2 * kPlane, v, lv, b, h, 0);
  cp_async_commit();

  float acc[DS / 8][4];
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  for (int j = 0; j < steps; ++j) {  // keys j kS .. + kS - 1
    float* stage = ring + (j & 1) * 4 * kPlane;
    cp_async_wait<0>();
    __syncthreads();  // this stage landed; every warp is done with the other one
    split_tile_f32<D, kS, kN>(stage, stage + kPlane);
    split_tile_f32<D, kS, kN>(stage + 2 * kPlane, stage + 3 * kPlane);
    __syncthreads();
    if (j + 1 < steps) {  // the next tile streams in while this one is used
      float* next = ring + ((j + 1) & 1) * 4 * kPlane;
      tile_async_f32<D, kS, kN>(next, k, lk, b, h, (j + 1) * kS);
      tile_async_f32<D, kS, kN>(next + 2 * kPlane, v, lv, b, h, (j + 1) * kS);
      cp_async_commit();
    }
    if (j * kS > row0 + 15) continue;  // every key of the step lies above the warp's rows
    const PlanesF32 Kt{stage, stage + kPlane}, Vt{stage + 2 * kPlane, stage + 3 * kPlane};

    float sd[1][kS / 8][4];  // S = q k^T: 16 rows x kS keys
    scores_tf32<D, kS / 8, 1, 2>(sd, {Qs}, {Kt}, w0, ln);
    float(&s)[kS / 8][4] = sd[0];
#pragma unroll
    for (int n = 0; n < kS / 8; ++n)  // keys above the diagonal are masked
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * kS + 8 * n + 2 * ln.t4 + (e & 1) > row0 + ln.g + 8 * (e >> 1)) s[n][e] = -INFINITY;
    softmax_step(s, acc, m, l);
    // O += P v, eight keys a step
#pragma unroll
    for (int kk = 0; kk < kS / 8; ++kk) acc_times_rows<D, DS / 8>(acc, s[kk], Vt, 8 * kk, c0, ln);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + ln.g + 8 * i;
    const float inv = 1.f / l[i];
    float* dst = o + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + c0 + 2 * ln.t4;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (c0 == 0 && ln.t4 == 0) lse[static_cast<int64_t>(blockIdx.x) * T_len + row] = m[i] + logf(l[i]);
  }
}

// grid (B * H, T / kM), dq_f32_threads threads: block (x, y) takes head x's
// query tile T/kM - 1 - y, so that every head's longest tiles start first.  Warp w owns query rows 16 (w % (kM / 16))
// .. + 15 and dQ's columns (w / (kM / 16)) D / splits onwards; lane (g, t4)
// holds rows g and g + 8 of them.  What flash_bwd_dq_mma_kernel computes,
// in float32: delta = rowsum(dO * O), written for the dK/dV kernel, and
// over the keys at or below the diagonal P = exp(q k^T - L), dP = dO v^T,
// dS = P (dP - delta), dQ += dS k.
template <int D>
__global__ void __launch_bounds__(dq_f32_threads<D>(), 1)
flash_bwd_dq_tf32_kernel(const float* q, const float* k, const float* v, const float* o, const float* dout,
                         Layout lq, Layout lk, Layout lv, Layout lo, Layout ldo, const float* lse,
                         float* delta, float* dq, int H, int T_len) {
  constexpr int kM = f32_own<D>(), kS = f32_step<D>(), kN = dq_f32_threads<D>(), kRowWarps = kM / 16;
  constexpr int DS = D / dq_f32_splits<D>(), S = f32_stride<D>(), kPlane = kS * S;
  static_assert(kM % kS == 0 && kS % 16 == 0 && D % 16 == 0, "tiles of whole n-tile pairs and d-step pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* dOs = Qs + kM * S;
  float* ring = dOs + kM * S;  // stage st: K big, K small, V big, V small
  float* Ds = ring + 8 * kPlane;  // delta of the tile's rows
  const LanesF32 ln(threadIdx.x % 32);
  const int warp = threadIdx.x / 32;
  const int w0 = 16 * (warp % kRowWarps), c0 = DS * (warp / kRowWarps);  // query rows and dQ columns
  const int qt = gridDim.y - 1 - blockIdx.y, steps = (qt + 1) * (kM / kS);  // key tiles at or below the diagonal
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.x) * T_len + qt * kM;

  tile_async_f32<D, kM, kN>(Qs, q, lq, b, h, qt * kM);
  tile_async_f32<D, kM, kN>(dOs, dout, ldo, b, h, qt * kM);
  tile_async_f32<D, kS, kN>(ring, k, lk, b, h, 0);
  tile_async_f32<D, kS, kN>(ring + 2 * kPlane, v, lv, b, h, 0);
  cp_async_commit();

  {  // delta while the tiles stream in: kN / kM neighbouring threads share a row
    constexpr int kParts = kN / kM, kCols = D / kParts;
    const int r = threadIdx.x / kParts, c = (threadIdx.x % kParts) * kCols;
    const int64_t row = qt * kM + r;
    const float4* ow = reinterpret_cast<const float4*>(o + b * lo.b + h * lo.h + row * lo.t + c);
    const float4* dw = reinterpret_cast<const float4*>(dout + b * ldo.b + h * ldo.h + row * ldo.t + c);
    float part = 0.f;
#pragma unroll 4
    for (int j = 0; j < kCols / 4; ++j) {
      const float4 x = ow[j], y = dw[j];
      part += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
    }
#pragma unroll
    for (int off = kParts / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (threadIdx.x % kParts == 0) {
      Ds[r] = part;
      delta[stat0 + r] = part;
    }
  }
  __syncthreads();
  float L[2], Di[2];  // rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    L[i] = lse[stat0 + w0 + ln.g + 8 * i];
    Di[i] = Ds[w0 + ln.g + 8 * i];
  }
  float acc[DS / 8][4];
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < steps; ++j) {  // keys j kS .. + kS - 1
    float* stage = ring + (j & 1) * 4 * kPlane;
    cp_async_wait<0>();
    __syncthreads();  // this stage landed; every warp is done with the other one
    split_tile_f32<D, kS, kN>(stage, stage + kPlane);
    split_tile_f32<D, kS, kN>(stage + 2 * kPlane, stage + 3 * kPlane);
    __syncthreads();
    if (j + 1 < steps) {  // the next tile streams in while this one is used
      float* next = ring + ((j + 1) & 1) * 4 * kPlane;
      tile_async_f32<D, kS, kN>(next, k, lk, b, h, (j + 1) * kS);
      tile_async_f32<D, kS, kN>(next + 2 * kPlane, v, lv, b, h, (j + 1) * kS);
      cp_async_commit();
    }
    const PlanesF32 Kt{stage, stage + kPlane}, Vt{stage + 2 * kPlane, stage + 3 * kPlane};

    float sd[2][kS / 8][4];  // S = q k^T and dP = dO v^T: 16 rows x kS keys
    scores_tf32<D, kS / 8, 2>(sd, {Qs, dOs}, {Kt, Vt}, w0, ln);
    float(&s)[kS / 8][4] = sd[0];
    float(&dp)[kS / 8][4] = sd[1];
    // P = exp(S - L), masked above the diagonal; dS = P (dP - delta), into dp
#pragma unroll
    for (int n = 0; n < kS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qt * kM + w0 + ln.g + 8 * (e >> 1), key = j * kS + 8 * n + 2 * ln.t4 + (e & 1);
        const float p = key > row ? 0.f : expf(s[n][e] - L[e >> 1]);
        dp[n][e] = p * (dp[n][e] - Di[e >> 1]);
      }
    // dQ += dS k, eight keys a step
#pragma unroll
    for (int kk = 0; kk < kS / 8; ++kk) acc_times_rows<D, DS / 8>(acc, dp[kk], Kt, 8 * kk, c0, ln);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = qt * kM + w0 + ln.g + 8 * i;
    float* dst = dq + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + c0 + 2 * ln.t4;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// The dK/dV kernel's warp sets: D / 64 sets of warps split the output
// columns, each holding 64 columns of dK and dV, all computing the same
// S^T and dP^T.
template <int D>
__host__ __device__ constexpr int dkv_f32_splits() { return D / 64; }
template <int D>
__host__ __device__ constexpr int dkv_f32_threads() { return 2 * f32_own<D>() * dkv_f32_splits<D>(); }

// grid (B * H, T / kM), dkv_f32_threads threads: block (x, y) takes head x's
// key tile y (the lowest tiles see the most query tiles, so every head's
// start first).  Warp
// w owns key rows 16 (w % (kM / 16)) .. + 15 and output columns 64 (w /
// (kM / 16)) onwards.  What flash_bwd_dkv_mma_kernel computes, in float32:
// over the queries at or below the diagonal dV += P^T dO, dK += dS^T q.
template <int D>
__global__ void __launch_bounds__(dkv_f32_threads<D>(), 1)
flash_bwd_dkv_tf32_kernel(const float* q, const float* k, const float* v, const float* dout, Layout lq,
                          Layout lk, Layout lv, Layout ldo, const float* lse, const float* delta, float* dk,
                          float* dv, int H, int T_len) {
  constexpr int kM = f32_own<D>(), kS = f32_step<D>(), kN = dkv_f32_threads<D>(), kRowWarps = kM / 16;
  constexpr int DS = 64, S = f32_stride<D>(), kPlane = kS * S;
  static_assert(kM % kS == 0 && kS % 16 == 0 && D % 64 == 0, "tiles of whole n-tile pairs and warp sets");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);
  float* Vs = Ks + kM * S;
  float* ring = Vs + kM * S;      // stage st: q big, q small, dO big, dO small
  float* Ls = ring + 8 * kPlane;  // two stages of kS
  float* Ds = Ls + 2 * kS;        // two stages of kS
  const LanesF32 ln(threadIdx.x % 32);
  const int warp = threadIdx.x / 32;
  const int w0 = 16 * (warp % kRowWarps), c0 = DS * (warp / kRowWarps);  // key rows and output columns
  const int kt = blockIdx.y, first = kt * (kM / kS), steps = T_len / kS - first;  // query tiles at or below
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int64_t stat0 = static_cast<int64_t>(blockIdx.x) * T_len;

  // q, dO, L and D of query tile qs into stage st
  auto load_queries = [&](int qs, int st) {
    float* stage = ring + st * 4 * kPlane;
    tile_async_f32<D, kS, kN>(stage, q, lq, b, h, qs * kS);
    tile_async_f32<D, kS, kN>(stage + 2 * kPlane, dout, ldo, b, h, qs * kS);
    const int i = threadIdx.x;
    if (i < kS / 4) cp_async_16(Ls + st * kS + 4 * i, lse + stat0 + qs * kS + 4 * i);
    else if (i < kS / 2) cp_async_16(Ds + st * kS + 4 * (i - kS / 4), delta + stat0 + qs * kS + 4 * (i - kS / 4));
  };
  tile_async_f32<D, kM, kN>(Ks, k, lk, b, h, kt * kM);
  tile_async_f32<D, kM, kN>(Vs, v, lv, b, h, kt * kM);
  load_queries(first, 0);
  cp_async_commit();

  float dK[DS / 8][4], dV[DS / 8][4];
#pragma unroll
  for (int n = 0; n < DS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[n][e] = dV[n][e] = 0.f;

  for (int j = 0; j < steps; ++j) {  // queries (first + j) kS .. + kS - 1
    const int qs = first + j, st = j & 1;
    float* stage = ring + st * 4 * kPlane;
    cp_async_wait<0>();
    __syncthreads();  // this stage landed; every warp is done with the other one
    split_tile_f32<D, kS, kN>(stage, stage + kPlane);
    split_tile_f32<D, kS, kN>(stage + 2 * kPlane, stage + 3 * kPlane);
    __syncthreads();
    if (j + 1 < steps) {  // the next tile streams in while this one is used
      load_queries(qs + 1, st ^ 1);
      cp_async_commit();
    }
    const PlanesF32 Qt{stage, stage + kPlane}, dOt{stage + 2 * kPlane, stage + 3 * kPlane};
    const float* Lt = Ls + st * kS;
    const float* Dt = Ds + st * kS;

    float sd[2][kS / 8][4];  // S^T = k q^T and dP^T = v dO^T: 16 keys x kS queries
    scores_tf32<D, kS / 8, 2>(sd, {Ks, Vs}, {Qt, dOt}, w0, ln);
    float(&s)[kS / 8][4] = sd[0];
    float(&dp)[kS / 8][4] = sd[1];
    // P^T = exp(S^T - L), masked above the diagonal; dS^T = P^T (dP^T - D)
#pragma unroll
    for (int n = 0; n < kS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kM + w0 + ln.g + 8 * (e >> 1), query = 8 * n + 2 * ln.t4 + (e & 1);
        const float p = key > qs * kS + query ? 0.f : expf(s[n][e] - Lt[query]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Dt[query]);
      }
    // dV += P^T dO and dK += dS^T q, eight queries a step
#pragma unroll
    for (int kk = 0; kk < kS / 8; ++kk) {
      acc_times_rows<D, DS / 8>(dV, s[kk], dOt, 8 * kk, c0, ln);
      acc_times_rows<D, DS / 8>(dK, dp[kk], Qt, 8 * kk, c0, ln);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = kt * kM + w0 + ln.g + 8 * i;
    const int64_t at = ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + c0 + 2 * ln.t4;
#pragma unroll
    for (int n = 0; n < DS / 8; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) = make_float2(dK[n][2 * i], dK[n][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * n) = make_float2(dV[n][2 * i], dV[n][2 * i + 1]);
    }
  }
}

// ---- column-split forward on the tensor cores (head widths past 256, D a runtime multiple of 64) ----
//
// Both dtypes: bf16 mma.sync m16n8k16 with P as two bf16 operands, hi +
// lo, or 3xTF32 m16n8k8.  A block owns kM query rows and one column slice
// of O.  Steps of 64 keys stream past in 64 x 64 pieces through a two-slot
// cp.async ring: first the D / 64 pieces of k, then only the V pieces of
// the block's slice, a slot holding up to 8 pieces (bf16) or 4 (float32).
// The block holds its q rows whole in shared memory, loaded once, where
// they fit beside the ring (float32 up to D 1,280, bf16 up to D 2,432);
// past that each k piece streams with q's 64 columns beside it, a slot
// holding half as many k pieces.  The block's warps are kM / 16 row warps
// times 4 column sets, and it builds the scores once: warp (r, c) builds S
// for rows 16 r .. + 15 and keys 16 c .. + 15 of the step over the full
// D, the rows' max and sum meet in shared memory, and P goes to shared
// memory (bf16 hi and lo planes, or TF32 big and small planes), from where
// every warp of the rows reads it for O += P v on its 16 columns of each V
// piece.  A lane holds 8 pieces x 16 columns = 64 O sums, so a slice has
// at most 8 pieces, and the ceil(D / 512) slices of a query tile each
// rebuild the scores: that is the recompute factor, where the SIMT design
// had D / 64.
//
// Why 4 column sets, so a factor of 1 up to D 512: at B 2, T 1024, H 2
// (the shape the timings use) 4 sets give 128 blocks of eight warps, the
// scores built once; 2 sets give 256 blocks of four warps, the scores
// built twice, and were slower in both dtypes at D 320 and 512, timed in
// one call (PERF.md §6).
//
// What bounds it there: each block's warps wait on chains of dependent
// mma.sync between barriers, and the longest query tile's block sets the
// kernel's time (one block an SM, all started at once: a per-block
// globaltimer trace).  So a slot holds many pieces (two barriers a step
// for its pieces, where a barrier a piece was slower), each piece's
// scores go to one of two sums and bf16 keeps lo's products apart from
// hi's, so that independent chains are in flight, and bf16 reads P's
// operands once a step.  float32 splits q and the k and v pieces into
// their TF32 halves as each warp reads them; P is split once, when it is
// written.  Each 3xTF32 product chains two 8-wide steps in the tensor
// cores and then joins its sum in a float32 add.  The statistics are
// summed over the column sets in a fixed order, so every warp of a row
// holds the same m and l and every slice the same L; slice 0 writes L.
constexpr int kSplitKeys = 64;   // keys of a step; rows and columns of a ring piece
constexpr int kSplitSets = 4;    // column sets: a warp takes 16 keys of a step and 16 columns of a V piece
static_assert(16 * kSplitSets == kSplitKeys, "a 16-key unit and a 16-column share a warp");
constexpr int kSplitPieces = 8;  // V pieces a slice: a lane's 8 x 16 columns, 64 O sums
constexpr int kSplitPStride = kSplitKeys + 8;  // P's rows: float2 reads of rows g at column 2 t are conflict-free

// Row padding of q and of the ring's pieces: rows 16 B apart in the bank cycle.
template <typename T>
__host__ __device__ constexpr int split_pad() { return 16 / static_cast<int>(sizeof(T)); }
template <typename T>
__host__ __device__ constexpr int split_piece() { return kSplitKeys * (kSplitKeys + split_pad<T>()); }
// Pieces a ring slot; the ring's two slots are one in flight while one is used.
template <typename T>
__host__ __device__ constexpr int split_slot() { return sizeof(T) == 2 ? 8 : 4; }
constexpr int kSplitSlots = 2;

// q whole (where q_whole), the ring, P's two planes, the rows' max and sum by column set
template <typename T>
int fwd_split_smem_bytes(int D, int kM, bool q_whole) {
  const int elems = (q_whole ? kM * (D + split_pad<T>()) : 0) + kSplitSlots * split_slot<T>() * split_piece<T>() +
                    2 * kM * kSplitPStride;
  return elems * static_cast<int>(sizeof(T)) + 2 * kSplitSets * kM * 4;
}

// grid (B * H, T / kM, slices), kM / 16 x 4 warps: block (x, y, z) takes
// head x's query tile T/kM - 1 - y and slice z of O's columns.  q_whole: q's
// rows held whole in shared memory; else streamed beside each k piece.
template <typename T>
__global__ void __launch_bounds__(64 * kSplitSets, 1)
flash_fwd_split_mma_kernel(const T* q, const T* k, const T* v, Layout lq, Layout lk, Layout lv, T* o,
                           float* lse, int H, int T_len, int D, bool q_whole) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int C = kSplitSets, NT = kSplitKeys / C / 8;  // n-tiles of a V piece a warp
  constexpr int kMaxPieces = kSplitPieces, PAD = split_pad<T>(), SP = kSplitKeys + PAD, SPP = kSplitPStride;
  constexpr int PIECE = split_piece<T>(), SLOT = split_slot<T>(), NSL = kSplitSlots;
  static_assert(kMaxPieces % SLOT == 0 && SLOT % 2 == 0, "whole slots of V pieces; k and q pieces in pairs");
  using Ln = typename std::conditional<kF32, LanesF32, Lanes>::type;
  const int RW = blockDim.x / (32 * C), kM = 16 * RW, SQ = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + (q_whole ? kM * SQ : 0);
  T* P0 = ring + NSL * SLOT * PIECE;  // P's hi (bf16) or big (TF32) plane
  T* P1 = P0 + kM * SPP;                   // lo or small
  float* red_max = reinterpret_cast<float*>(P1 + kM * SPP);  // [column set][row]
  float* red_sum = red_max + C * kM;
  const Ln ln(threadIdx.x % 32);
  const int warp = threadIdx.x / 32, c = warp / RW, w0 = 16 * (warp % RW);
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int row0 = qt * kM + w0;  // the warp's first query row
  const int cs = 16 * c;          // the set's keys in each step and columns in each V piece
  // the slice: pieces spread evenly over gridDim.z slices
  const int nK = D / kSplitKeys, z = blockIdx.z, base = nK / gridDim.z, extra = nK % gridDim.z;
  const int nV = base + (z < extra ? 1 : 0), v0 = kSplitKeys * (z * base + (z < extra ? z : extra));
  // k pieces a slot: a whole slot, or half of one with q's piece beside each (at + KP pieces)
  const int KP = q_whole ? SLOT : SLOT / 2, SQP = q_whole ? SQ : SP;  // SQP: the row stride q is read at
  const int kSlots = (nK + KP - 1) / KP, per = kSlots + (nV + SLOT - 1) / SLOT;  // slots of a step
  const int steps = ((qt + 1) * kM - 1) / kSplitKeys + 1, total = steps * per;
  const T* q_blk = q + b * lq.b + h * lq.h + static_cast<int64_t>(qt * kM) * lq.t;

  // q's rows of the block, columns c0 .. c0 + n - 1, into dst (row stride ld)
  constexpr int E = 16 / sizeof(T), CH = kSplitKeys / E;  // elements a 16-byte copy; copies a piece row
  auto load_q = [&](T* dst, int ld, int c0, int n) {
    const int chunks = n / E;
    for (int i = threadIdx.x; i < kM * chunks; i += blockDim.x) {
      const int r = i / chunks, cc = (i % chunks) * E;
      cp_async_16(dst + r * ld + cc, q_blk + r * lq.t + c0 + cc);
    }
  };
  if (q_whole) load_q(Qs, SQ, 0, D);
  // A piece is 64 rows of 64 columns; thread i copies 16 bytes of rows i / CH, + rstep, ... at column
  // (i % CH) E, from pointers set up once, so that a copy costs an add or two.
  const int rstep = blockDim.x / CH, pr = threadIdx.x / CH, pc = (threadIdx.x % CH) * E;
  const T* k_thr = k + b * lk.b + h * lk.h + pr * lk.t + pc;
  const T* v_thr = v + b * lv.b + h * lv.h + pr * lv.t + pc + v0;
  const int64_t k_step = rstep * lk.t, v_step = rstep * lv.t;
  auto load_piece = [&](T* dst, const T* src, int64_t step) {
    dst += pr * SP + pc;
    for (int r = pr; r < kSplitKeys; r += rstep, dst += rstep * SP, src += step) cp_async_16(dst, src);
  };
  // slot i of the block's sequence (step i / per: its k pieces, KP a slot, then its V pieces, SLOT a
  // slot) into ring slot i % NSL; one commit a slot, empty past the end, so that the wait below counts
  // slots
  auto load_slot = [&](int i) {
    if (i < total) {
      const int j = i / per, sl = i % per;
      T* dst = ring + (i % NSL) * SLOT * PIECE;
      const int64_t row = static_cast<int64_t>(kSplitKeys) * j;
      if (sl < kSlots) {
        for (int p = KP * sl; p < KP * (sl + 1) && p < nK; ++p) {
          load_piece(dst + (p - KP * sl) * PIECE, k_thr + row * lk.t + kSplitKeys * p, k_step);
          if (!q_whole) load_q(dst + (KP + p - KP * sl) * PIECE, SP, kSplitKeys * p, kSplitKeys);
        }
      } else {
        const int p0 = SLOT * (sl - kSlots);
        for (int p = p0; p < p0 + SLOT && p < nV; ++p)
          load_piece(dst + (p - p0) * PIECE, v_thr + row * lv.t + kSplitKeys * p, v_step);
      }
    }
    cp_async_commit();
  };
  // slot i, landed for every thread; the previous slot's readers are done, so its ring slot refills
  auto next_slot = [&](int i) -> const T* {
    cp_async_wait<NSL - 2>();
    __syncthreads();
    load_slot(i + NSL - 1);
    return ring + (i % NSL) * SLOT * PIECE;
  };

  for (int i = 0; i < NSL - 1; ++i) load_slot(i);  // a whole q joins slot 0's group

  float acc[kMaxPieces][NT][4];
#pragma unroll
  for (int p = 0; p < kMaxPieces; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  int slot = 0;
  for (int j = 0; j < steps; ++j) {  // keys 64 j .. + 63
    const int key0 = kSplitKeys * j;
    // the set's 16 keys, skipped (their scores masked) where every one is above the warp's rows
    const bool live = key0 + cs <= row0 + 15;
    float sp[2][2][4];  // the scores of even and odd pieces, summed apart
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[hf][n][e] = 0.f;
    for (int sl = 0; sl < kSlots; ++sl) {  // S = q k^T over the full D, KP pieces a slot
      const T* Ks = next_slot(slot++);
      if (!live) continue;
#pragma unroll
      for (int hf = 0; hf < SLOT; ++hf) {
        const int p = KP * sl + hf;
        if (hf >= KP || p >= nK) break;
        const T* Kp = Ks + hf * PIECE + (cs + ln.b_row) * SP + ln.b_col;
        const T* Qp = (q_whole ? Qs + kSplitKeys * p : Ks + (KP + hf) * PIECE) + (w0 + ln.a_row) * SQP + ln.a_col;
        if constexpr (kF32) {
#pragma unroll
          for (int kd0 = 0; kd0 < kSplitKeys / 8; kd0 += 2) {
            float t[2][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int kd = kd0 + half;
              uint32_t xr[4], yr[4];
              ldmatrix_x4(xr, Qp + 8 * kd);
              ldmatrix_x4(yr, Kp + 8 * kd);
              const Split<4> xa = split4(xr), yb = split4(yr);
              if (half == 0) mma_3xtf32_chain<false, 2>(t, 0, xa, yb);
              else mma_3xtf32_chain<true, 2>(t, 0, xa, yb);
            }
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) sp[hf & 1][n][e] += t[n][e];
          }
        } else {
#pragma unroll
          for (int kd = 0; kd < kSplitKeys / 16; ++kd) {
            uint32_t a[4], bb[4];
            ldmatrix_x4(a, Qp + 16 * kd);
            ldmatrix_x4(bb, Kp + 16 * kd);
            mma_bf16(sp[hf & 1][0], a, bb[0], bb[1]);
            mma_bf16(sp[hf & 1][1], a, bb[2], bb[3]);
          }
        }
      }
    }

    // keys above the diagonal masked; each set's max of the rows, then the rows' max over the sets
    float s[2][4], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = sp[0][n][e] + sp[1][n][e];
        if (key0 + cs + 8 * n + 2 * ln.t4 + (e & 1) > row0 + ln.g + 8 * (e >> 1)) s[n][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      if (ln.t4 == 0) red_max[c * kM + w0 + ln.g + 8 * i] = mx[i];
    }
    __syncthreads();
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mn = m[i];  // every row keeps key 0 of the first step, so mn is finite
      for (int cc = 0; cc < C; ++cc) mn = fmaxf(mn, red_max[cc * kM + w0 + ln.g + 8 * i]);
      alpha[i] = expf(m[i] - mn);
      m[i] = mn;
    }
    // P = exp(S - m) into shared memory, split into two operands
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = expf(s[n][2 * i] - m[i]), p1 = expf(s[n][2 * i + 1] - m[i]);
        sum[i] += p0 + p1;
        const int at = (w0 + ln.g + 8 * i) * SPP + cs + 8 * n + 2 * ln.t4;
        if constexpr (kF32) {
          const float b0 = __uint_as_float(to_tf32(p0)), b1 = __uint_as_float(to_tf32(p1));
          *reinterpret_cast<float2*>(P0 + at) = make_float2(b0, b1);
          *reinterpret_cast<float2*>(P1 + at) = make_float2(p0 - b0, p1 - b1);
        } else {
          const uint32_t hi = pack_bf16(p0, p1);
          *reinterpret_cast<uint32_t*>(P0 + at) = hi;
          *reinterpret_cast<uint32_t*>(P1 + at) = pack_bf16(p0 - bf16_lo(hi), p1 - bf16_hi(hi));
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      if (ln.t4 == 0) red_sum[c * kM + w0 + ln.g + 8 * i] = sum[i];
    }
#pragma unroll
    for (int p = 0; p < kMaxPieces; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[p][n][0] *= alpha[0];
        acc[p][n][1] *= alpha[0];
        acc[p][n][2] *= alpha[1];
        acc[p][n][3] *= alpha[1];
      }
    __syncthreads();  // P and the sums are written
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tot = 0.f;
      for (int cc = 0; cc < C; ++cc) tot += red_sum[cc * kM + w0 + ln.g + 8 * i];
      l[i] = l[i] * alpha[i] + tot;
    }

    // O += P v on the set's columns of each V piece, SLOT pieces a slot; 16 keys above every row of the
    // warp add nothing
    const int live_keys = row0 + 16 - key0 < kSplitKeys ? row0 + 16 - key0 : kSplitKeys;
    uint32_t phi[kSplitKeys / 16][4], plo[kSplitKeys / 16][4];  // bf16: P's A operands, read once a step
    if constexpr (!kF32) {
#pragma unroll
      for (int kk = 0; kk < kSplitKeys / 16; ++kk) {
        ldmatrix_x4(phi[kk], P0 + (w0 + ln.a_row) * SPP + 16 * kk + ln.a_col);
        ldmatrix_x4(plo[kk], P1 + (w0 + ln.a_row) * SPP + 16 * kk + ln.a_col);
      }
    }
#pragma unroll
    for (int p2 = 0; p2 < kMaxPieces; p2 += SLOT) {
      if (p2 >= nV) break;
      const T* Vs = next_slot(slot++);
#pragma unroll
      for (int hf = 0; hf < SLOT; ++hf) {
        const int p = p2 + hf;
        if (p >= nV) break;
        const T* Vp = Vs + hf * PIECE;
        if constexpr (kF32) {
#pragma unroll
          for (int kk = 0; kk < kSplitKeys / 8; kk += 2) {
            if (8 * kk >= live_keys) break;
            float t[NT][4];
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int key = 8 * (kk + half);
              // A = P with its k permuted (k = t: key 2t, k = t + 4: key 2t + 1), as acc_to_a_tf32 does
              const float2 x0 = *reinterpret_cast<const float2*>(P0 + (w0 + ln.g) * SPP + key + 2 * ln.t4);
              const float2 x1 = *reinterpret_cast<const float2*>(P0 + (w0 + ln.g + 8) * SPP + key + 2 * ln.t4);
              const float2 y0 = *reinterpret_cast<const float2*>(P1 + (w0 + ln.g) * SPP + key + 2 * ln.t4);
              const float2 y1 = *reinterpret_cast<const float2*>(P1 + (w0 + ln.g + 8) * SPP + key + 2 * ln.t4);
              Split<4> a;
              a.big[0] = __float_as_uint(x0.x), a.big[1] = __float_as_uint(x1.x);
              a.big[2] = __float_as_uint(x0.y), a.big[3] = __float_as_uint(x1.y);
              a.small[0] = __float_as_uint(y0.x), a.small[1] = __float_as_uint(y1.x);
              a.small[2] = __float_as_uint(y0.y), a.small[3] = __float_as_uint(y1.y);
              Split<2 * NT> bv;  // V's rows key + 2t and key + 2t + 1 at column g, in the same order
              const T* vr = Vp + (key + 2 * ln.t4) * SP + cs + ln.g;
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                split_tf32(vr[8 * n], bv.big[2 * n], bv.small[2 * n]);
                split_tf32(vr[SP + 8 * n], bv.big[2 * n + 1], bv.small[2 * n + 1]);
              }
              if (half == 0) mma_3xtf32_chain<false, NT>(t, 0, a, bv);
              else mma_3xtf32_chain<true, NT>(t, 0, a, bv);
            }
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[p][n][e] += t[n][e];
          }
        } else {
          float lo_sum[NT][4];  // lo's products, apart from hi's, then added
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) lo_sum[n][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kSplitKeys / 16; ++kk) {
            if (16 * kk >= live_keys) break;
#pragma unroll
            for (int n = 0; n < NT; n += 2) {
              uint32_t bb[4];
              ldmatrix_x4_trans(bb, Vp + (16 * kk + ln.t_row) * SP + cs + 8 * n + ln.t_col);
              mma_bf16(acc[p][n], phi[kk], bb[0], bb[1]);
              mma_bf16(lo_sum[n], plo[kk], bb[0], bb[1]);
              mma_bf16(acc[p][n + 1], phi[kk], bb[2], bb[3]);
              mma_bf16(lo_sum[n + 1], plo[kk], bb[2], bb[3]);
            }
          }
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[p][n][e] += lo_sum[n][e];
        }
      }
    }
  }
  cp_async_wait<0>();  // the empty groups past the end

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + ln.g + 8 * i;
    const float inv = 1.f / l[i];
    T* dst = o + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + v0 + cs + 2 * ln.t4;
#pragma unroll
    for (int p = 0; p < kMaxPieces; ++p) {
      if (p >= nV) break;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float x = acc[p][n][2 * i] * inv, y = acc[p][n][2 * i + 1] * inv;
        if constexpr (kF32) *reinterpret_cast<float2*>(dst + kSplitKeys * p + 8 * n) = make_float2(x, y);
        else *reinterpret_cast<uint32_t*>(dst + kSplitKeys * p + 8 * n) = pack_bf16(x, y);
      }
    }
    if (z == 0 && c == 0 && ln.t4 == 0) lse[static_cast<int64_t>(blockIdx.x) * T_len + row] = m[i] + logf(l[i]);
  }
}

// ---- column-split backward on the tensor cores (head widths past 256, D a runtime multiple of 64) ----
//
// The split forward's parts, for splash's two backward kernels, in both
// dtypes (bf16 mma.sync m16n8k16, or 3xTF32 m16n8k8).  A block owns kM
// rows, query rows for dQ and key rows for dK/dV, and holds them whole in
// shared memory (dQ: q and dO; dK/dV: k and v), loaded once, where they
// fit beside the ring: dQ up to D 640 in float32 and 1,216 in bf16, dK/dV
// (twice the rows) up to 576 in bf16 and at no split width in float32.
// Past that each streamed piece has the own rows' 64 columns beside it.  The other side streams past in steps of 64 rows
// (dQ: keys; dK/dV: queries), each step's D / 64 column pieces of both
// streamed tensors (dQ: k and v; dK/dV: q and dO) through a two-slot
// cp.async ring of 8 (bf16) or 4 (float32) pieces a slot.  Warp (r, c) of
// kM / 16 row warps times 4 column sets builds S and dP for its 16 own
// rows and 16 of the step's 64 streamed rows over the full D, so the
// scores are built once a block: dQ takes P = exp(S - L) and dS = P (dP -
// delta), dK/dV P^T and dS^T the same way, and each goes to shared memory,
// from where every warp of the rows reads it as the A operand of its
// output products on its 16 columns of each of the slice's pieces: dQ +=
// dS k; dK += dS^T q and dV += P^T dO.  In bf16 what goes to shared memory
// is the bf16 rounding of dS (and of P in dK/dV), the rounding splash
// makes before those products; in float32 its TF32 big and small planes.
//
// Recompute factor.  A lane holds 64 output sums: 8 pieces x 16 columns of
// dQ, so a dQ slice has at most 8 pieces and its score work runs ceil(D /
// 512) times; 4 pieces x 16 columns of both dK and dV, so a dK/dV slice
// has at most 4 and its score work runs ceil(D / 256) times.
//
// Reuse.  The score columns run in an order that ends with the slice's
// own, and a step's partial score slot comes first, so its last score slot
// holds the slice's streamed pieces that the output products need (dQ:
// k's; dK/dV: q's and dO's), as many as it has room for; those are read
// from it before the ring moves on, and only the rest stream in again.
//
// Statistics.  dQ reads L and computes delta = rowsum(dO O) of its rows
// once a block, every slice alike (slice 0 writes it); dK/dV loads each
// lane's queries' L and delta at the start of a step and uses them after
// the scores.  No atomics: every sum has one owner and a fixed order.
//
// Own rows and the grid.  dQ owns 16 rows a block and dK/dV 32, in both
// dtypes.  At B 2, T 1024, H 2 (the shape the timings use) that gives 256
// blocks of each for the 132 SMs, one block an SM; the longest tiles start
// first (dQ: the last query tile; dK/dV: key tile 0), with the slices of
// one tile side by side in the grid's x, so that the short tiles fill in
// behind the long ones.  Timed against each other in one call
// (tools/flash_bwd_variants.py; PERF.md §6): 32 dK/dV rows took
// 0.58-0.74x the time of 16 (a step's streamed pieces serve twice the
// rows), even in float32, where 32 rows of k and v no longer fit whole and
// stream; 32 dQ rows tied in bf16 and took 1.28-1.32x in float32 (there q
// and dO stream).  Reading the last score slot's pieces again made the
// pair 0.92-0.93x as slow as streaming them anew in bf16 and 0.97x in
// float32 at D 320, 1.01x at D 512 (where it saves no slot); float32
// scores summed in even and odd halves were 1.6-2.5 % slower and spilled;
// bf16 slots of 4 pieces (two dQ blocks an SM) were 1.06-1.17x slower
// than slots of 8.

// outputs a block holds: dQ; or dK and dV
template <bool kDKV>
__host__ __device__ constexpr int bwd_split_outputs() { return kDKV ? 2 : 1; }
// planes of the outputs' A operands: one in bf16, TF32 big and small in float32
template <typename T, bool kDKV>
__host__ __device__ constexpr int bwd_split_planes() { return bwd_split_outputs<kDKV>() * (sizeof(T) == 2 ? 1 : 2); }
// own rows a block: 16 for dQ, 32 for dK/dV (see above: "Own rows and the grid")
template <bool kDKV>
__host__ __device__ constexpr int bwd_split_rows() { return kDKV ? 32 : 16; }

// the own rows whole (where held), the ring, the A planes, dQ's delta of the rows
template <typename T, bool kDKV>
int bwd_split_smem_bytes(int D, int kM, bool held) {
  const int elems = (held ? 2 * kM * (D + split_pad<T>()) : 0) + kSplitSlots * split_slot<T>() * split_piece<T>() +
                    bwd_split_planes<T, kDKV>() * kM * kSplitPStride;
  return elems * static_cast<int>(sizeof(T)) + (kDKV ? 0 : kM * 4);
}

// acc += A Y on one output piece, bf16: A (the warp's 16 rows x the step's
// 64 streamed rows) in registers, read from its plane once a step; Y the
// piece, of which the warp takes columns cs .. cs + 15.  Only streamed rows
// klo .. khi - 1 are read: A is 0 elsewhere for these rows.  Odd 16-row
// units sum apart, so that two chains are in flight.
__device__ __forceinline__ void split_out_bf16(float (&acc)[2][4], const uint32_t (&a)[kSplitKeys / 16][4],
                                               const bf16* Yp, int cs, int klo, int khi, const Lanes& ln) {
  constexpr int SP = kSplitKeys + split_pad<bf16>();
  float odd[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) odd[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kSplitKeys / 16; ++kk) {
    if (16 * kk < klo || 16 * kk >= khi) continue;
    uint32_t bb[4];
    ldmatrix_x4_trans(bb, Yp + (16 * kk + ln.t_row) * SP + cs + ln.t_col);
    float(&d)[2][4] = kk & 1 ? odd : acc;
    mma_bf16(d[0], a[kk], bb[0], bb[1]);
    mma_bf16(d[1], a[kk], bb[2], bb[3]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += odd[n][e];
}

// The same in 3xTF32: A from its big and small planes with its k permuted
// (k = t: streamed row 2t, k = t + 4: row 2t + 1, as acc_to_a_tf32 does),
// Y's rows read in that order and split as read; each product chains two
// 8-row steps in the tensor cores and joins acc in a float32 add.
__device__ __forceinline__ void split_out_tf32(float (&acc)[2][4], const float* big, const float* small, int w0,
                                               const float* Yp, int cs, int klo, int khi, const LanesF32& ln) {
  constexpr int SP = kSplitKeys + split_pad<float>(), SPP = kSplitPStride, NT = 2;
#pragma unroll
  for (int kk = 0; kk < kSplitKeys / 8; kk += 2) {
    if (8 * kk < klo || 8 * kk >= khi) continue;
    float t[NT][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = 8 * (kk + half), r0 = (w0 + ln.g) * SPP + key + 2 * ln.t4, r1 = r0 + 8 * SPP;
      const float2 x0 = *reinterpret_cast<const float2*>(big + r0), x1 = *reinterpret_cast<const float2*>(big + r1);
      const float2 y0 = *reinterpret_cast<const float2*>(small + r0), y1 = *reinterpret_cast<const float2*>(small + r1);
      Split<4> a;
      a.big[0] = __float_as_uint(x0.x), a.big[1] = __float_as_uint(x1.x);
      a.big[2] = __float_as_uint(x0.y), a.big[3] = __float_as_uint(x1.y);
      a.small[0] = __float_as_uint(y0.x), a.small[1] = __float_as_uint(y1.x);
      a.small[2] = __float_as_uint(y0.y), a.small[3] = __float_as_uint(y1.y);
      Split<2 * NT> yb;
      const float* yr = Yp + (key + 2 * ln.t4) * SP + cs + ln.g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        split_tf32(yr[8 * n], yb.big[2 * n], yb.small[2 * n]);
        split_tf32(yr[SP + 8 * n], yb.big[2 * n + 1], yb.small[2 * n + 1]);
      }
      if (half == 0) mma_3xtf32_chain<false, NT>(t, 0, a, yb);
      else mma_3xtf32_chain<true, NT>(t, 0, a, yb);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];
  }
}

// The body of both kernels.  x0, x1: the own rows' tensors (dQ: q, dO;
// dK/dV: k, v); y0, y1: the streamed ones (dQ: k, v; dK/dV: q, dO); S = x0
// y0^T and dP = x1 y1^T.  Output o is A plane o times y piece o: dQ = dS
// k; dK = dS^T q and dV = P^T dO.  grid (B * H * slices, T / kM), kM / 16 x
// 4 warps: block (x, y) takes head x / slices, column slice x % slices and
// the own tile y places longest first (dQ: T/kM - 1 - y; dK/dV: y).  held:
// the own rows whole in shared memory, else streamed beside each piece.
template <typename T, bool kDKV>
__device__ __forceinline__ void bwd_split(const T* x0, const T* x1, const T* y0, const T* y1, Layout lx0, Layout lx1,
                                          Layout ly0, Layout ly1, const T* o, Layout lo, const float* lse,
                                          const float* delta_in, float* delta_out, T* out0, T* out1, int H,
                                          int T_len, int D, bool held) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int C = kSplitSets, NT = kSplitKeys / C / 8;  // n-tiles of a warp's 16 columns of a piece
  constexpr int NO = bwd_split_outputs<kDKV>(), kPer = kSplitPieces / NO;  // outputs; pieces a slice
  constexpr int NPL = kF32 ? 2 : 1, PAD = split_pad<T>(), SP = kSplitKeys + PAD, SPP = kSplitPStride;
  constexpr int PIECE = split_piece<T>(), SLOT = split_slot<T>(), NSL = kSplitSlots;
  static_assert(NT == 2 && SLOT % 4 == 0, "a slot holds whole score columns of four pieces");
  using Ln = typename std::conditional<kF32, LanesF32, Lanes>::type;
  const int RW = blockDim.x / (32 * C), kM = 16 * RW, SX = D + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* X0s = reinterpret_cast<T*>(smem_raw);
  T* X1s = X0s + (held ? kM * SX : 0);
  T* ring = X1s + (held ? kM * SX : 0);
  T* planes = ring + NSL * SLOT * PIECE;  // output o's A operand at NPL o kM SPP (float32: big, then small)
  float* Ds = reinterpret_cast<float*>(planes + NO * NPL * kM * SPP);  // dQ: delta of the own rows
  const Ln ln(threadIdx.x % 32);
  const int warp = threadIdx.x / 32, c = warp / RW, w0 = 16 * (warp % RW);
  const int cs = 16 * c;  // the set's streamed rows in each step and columns in each output piece
  const int nK = D / kSplitKeys, slices = (nK + kPer - 1) / kPer;
  const int bh = blockIdx.x / slices, z = blockIdx.x % slices, b = bh / H, h = bh % H;
  const int own0 = kM * (kDKV ? blockIdx.y : gridDim.y - 1 - blockIdx.y), row0 = own0 + w0;
  const int64_t stat0 = static_cast<int64_t>(bh) * T_len;
  // the slice: pieces c0 .. c0 + nV - 1, spread evenly over the slices
  const int base = nK / slices, extra = nK % slices;
  const int nV = base + (z < extra ? 1 : 0), c0 = z * base + (z < extra ? z : extra);
  // score slots: W pieces a column (y0, y1, then x0, x1 where the own rows stream), KP columns a slot, the
  // partial slot first; columns c0 + nV, c0 + nV + 1, ... (mod nK), so that the slice's own come last
  const int W = held ? 2 : 4, KP = SLOT / W;
  const int kSlots = (nK + KP - 1) / KP, rem = nK - KP * (kSlots - 1), last = kSlots == 1 ? nK : KP;
  const int r = nV < last ? nV : last;  // the slice's last r pieces come from the last score slot
  const int OC = SLOT / NO, oSlots = (nV - r + OC - 1) / OC, per = kSlots + oSlots;  // output slots: OC columns
  const int first = kDKV ? own0 / kSplitKeys : 0;  // steps whose pairs are not all masked
  const int steps = kDKV ? T_len / kSplitKeys - first : (own0 + kM - 1) / kSplitKeys + 1, total = steps * per;

  constexpr int E = 16 / sizeof(T), CH = kSplitKeys / E;  // elements a 16-byte copy; copies a piece row
  // the own rows' columns col .. col + n - 1 into dst (row stride ld)
  auto load_own = [&](T* dst, int ld, const T* src, const Layout& lay, int col, int n) {
    const T* blk = src + b * lay.b + h * lay.h + static_cast<int64_t>(own0) * lay.t + col;
    const int chunks = n / E;
    for (int i = threadIdx.x; i < kM * chunks; i += blockDim.x) {
      const int rr = i / chunks, cc = (i % chunks) * E;
      cp_async_16(dst + rr * ld + cc, blk + rr * lay.t + cc);
    }
  };
  // A piece is 64 rows of 64 columns; thread i copies 16 bytes of rows i / CH, + rstep, ... at column
  // (i % CH) E, from pointers set up once
  const int rstep = blockDim.x / CH, pr = threadIdx.x / CH, pc = (threadIdx.x % CH) * E;
  const T* y0_thr = y0 + b * ly0.b + h * ly0.h + pr * ly0.t + pc;
  const T* y1_thr = y1 + b * ly1.b + h * ly1.h + pr * ly1.t + pc;
  const int64_t y0_step = rstep * ly0.t, y1_step = rstep * ly1.t;
  auto load_piece = [&](T* dst, const T* src, int64_t step) {
    dst += pr * SP + pc;
    for (int rr = pr; rr < kSplitKeys; rr += rstep, dst += rstep * SP, src += step) cp_async_16(dst, src);
  };
  // slot i of the block's sequence (step i / per: its score slots, then its output slots) into ring slot
  // i % NSL; one commit a slot, empty past the end, so that the wait below counts slots
  auto load_slot = [&](int i) {
    if (i < total) {
      const int sl = i % per;
      const int64_t row = static_cast<int64_t>(kSplitKeys) * (first + i / per);
      T* dst = ring + (i % NSL) * SLOT * PIECE;
      if (sl < kSlots) {
        const int p0 = sl == 0 ? 0 : rem + KP * (sl - 1), n = sl == 0 ? rem : KP;
        for (int l = 0; l < n; ++l, dst += W * PIECE) {
          const int col = kSplitKeys * ((c0 + nV + p0 + l) % nK);
          load_piece(dst, y0_thr + row * ly0.t + col, y0_step);
          load_piece(dst + PIECE, y1_thr + row * ly1.t + col, y1_step);
          if (!held) {
            load_own(dst + 2 * PIECE, SP, x0, lx0, col, kSplitKeys);
            load_own(dst + 3 * PIECE, SP, x1, lx1, col, kSplitKeys);
          }
        }
      } else {
        for (int l = 0, i0 = OC * (sl - kSlots); l < OC && i0 + l < nV - r; ++l) {
          const int col = kSplitKeys * (c0 + i0 + l);
          load_piece(dst + NO * l * PIECE, y0_thr + row * ly0.t + col, y0_step);
          if constexpr (kDKV) load_piece(dst + (NO * l + 1) * PIECE, y1_thr + row * ly1.t + col, y1_step);
        }
      }
    }
    cp_async_commit();
  };
  // slot i, landed for every thread; the previous slot's readers are done, so its ring slot refills
  auto next_slot = [&](int i) -> const T* {
    cp_async_wait<NSL - 2>();
    __syncthreads();
    load_slot(i + NSL - 1);
    return ring + (i % NSL) * SLOT * PIECE;
  };
  // an output's A operand at at and at + 1 of its plane: bf16, or TF32 big and small
  auto put = [&](T* plane, int at, const float (&x)[2]) {
    if constexpr (kF32) {
      const float b0 = __uint_as_float(to_tf32(x[0])), b1 = __uint_as_float(to_tf32(x[1]));
      *reinterpret_cast<float2*>(plane + at) = make_float2(b0, b1);
      *reinterpret_cast<float2*>(plane + kM * SPP + at) = make_float2(x[0] - b0, x[1] - b1);
    } else {
      *reinterpret_cast<uint32_t*>(plane + at) = pack_bf16(x[0], x[1]);
    }
  };

  if (held) {
    load_own(X0s, SX, x0, lx0, 0, D);
    load_own(X1s, SX, x1, lx1, 0, D);
  }
  for (int i = 0; i < NSL - 1; ++i) load_slot(i);  // the held rows join slot 0's group

  float L[2] = {0.f, 0.f}, Di[2] = {0.f, 0.f};  // dQ: L and delta of rows g and g + 8
  if constexpr (!kDKV) {  // delta = rowsum(dO O) while slot 0 streams in: 8 neighbouring threads a row
    constexpr int kParts = 2 * C;
    const int kCols = D / kParts, rr = threadIdx.x / kParts, col = (threadIdx.x % kParts) * kCols;
    const int64_t row = own0 + rr;
    const T* op = o + b * lo.b + h * lo.h + row * lo.t + col;
    const T* dw = x1 + b * lx1.b + h * lx1.h + row * lx1.t + col;
    float part = 0.f;
    if constexpr (kF32) {
      for (int j = 0; j < kCols; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(op + j), y = *reinterpret_cast<const float4*>(dw + j);
        part += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
    } else {
      for (int j = 0; j < kCols; j += 2) {
        const uint32_t x = *reinterpret_cast<const uint32_t*>(op + j), y = *reinterpret_cast<const uint32_t*>(dw + j);
        part += bf16_lo(x) * bf16_lo(y) + bf16_hi(x) * bf16_hi(y);
      }
    }
#pragma unroll
    for (int off = kParts / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (threadIdx.x % kParts == 0) {
      Ds[rr] = part;
      if (z == 0) delta_out[stat0 + row] = part;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      L[i] = lse[stat0 + row0 + ln.g + 8 * i];
      Di[i] = Ds[w0 + ln.g + 8 * i];
    }
  }

  float acc[NO][kPer][NT][4];
#pragma unroll
  for (int oo = 0; oo < NO; ++oo)
#pragma unroll
    for (int p = 0; p < kPer; ++p)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[oo][p][n][e] = 0.f;

  int slot = 0;
  for (int j = first; j < first + steps; ++j) {
    const int s0 = kSplitKeys * j;  // the step's first streamed row: a key (dQ) or a query (dK/dV)
    // the set's 16 streamed rows, skipped (their pairs masked) where none pairs with the warp's rows
    const bool live = kDKV ? s0 + cs + 15 >= row0 : s0 + cs <= row0 + 15;
    // S and dP; in bf16 each with its even and odd columns summed apart, so that four chains are in
    // flight (float32 chains only two 8-wide steps in the tensor cores and sums in the CUDA cores)
    constexpr int NPAR = kF32 ? 1 : 2;
    float sp[2][NPAR][NT][4];
#pragma unroll
    for (int pi = 0; pi < 2; ++pi)
#pragma unroll
      for (int hf = 0; hf < NPAR; ++hf)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[pi][hf][n][e] = 0.f;
    for (int sl = 0; sl < kSlots; ++sl) {  // S and dP over the full D
      const T* Ys = next_slot(slot++);
      if (!live) continue;
      const int p0 = sl == 0 ? 0 : rem + KP * (sl - 1), n = sl == 0 ? rem : KP;
#pragma unroll
      for (int l = 0; l < SLOT / 2; ++l) {
        if (l >= n) break;
        const int col = kSplitKeys * ((c0 + nV + p0 + l) % nK), SXP = held ? SX : SP;
        const T* yp[2] = {Ys + W * l * PIECE + (cs + ln.b_row) * SP + ln.b_col,
                          Ys + (W * l + 1) * PIECE + (cs + ln.b_row) * SP + ln.b_col};
        const T* xp[2] = {(held ? X0s + col : Ys + (W * l + 2) * PIECE) + (w0 + ln.a_row) * SXP + ln.a_col,
                          (held ? X1s + col : Ys + (W * l + 3) * PIECE) + (w0 + ln.a_row) * SXP + ln.a_col};
        if constexpr (kF32) {
#pragma unroll
          for (int kd0 = 0; kd0 < kSplitKeys / 8; kd0 += 2) {
            float t[2][NT][4];
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
              for (int pi = 0; pi < 2; ++pi) {
                uint32_t xr[4], yr[4];
                ldmatrix_x4(xr, xp[pi] + 8 * (kd0 + half));
                ldmatrix_x4(yr, yp[pi] + 8 * (kd0 + half));
                const Split<4> xa = split4(xr), yb = split4(yr);
                if (half == 0) mma_3xtf32_chain<false, 2>(t[pi], 0, xa, yb);
                else mma_3xtf32_chain<true, 2>(t[pi], 0, xa, yb);
              }
#pragma unroll
            for (int pi = 0; pi < 2; ++pi)
#pragma unroll
              for (int nn = 0; nn < NT; ++nn)
#pragma unroll
                for (int e = 0; e < 4; ++e) sp[pi][0][nn][e] += t[pi][nn][e];
          }
        } else {
#pragma unroll
          for (int kd = 0; kd < kSplitKeys / 16; ++kd)
#pragma unroll
            for (int pi = 0; pi < 2; ++pi) {
              uint32_t a[4], bb[4];
              ldmatrix_x4(a, xp[pi] + 16 * kd);
              ldmatrix_x4(bb, yp[pi] + 16 * kd);
              mma_bf16(sp[pi][l % NPAR][0], a, bb[0], bb[1]);
              mma_bf16(sp[pi][l % NPAR][1], a, bb[2], bb[3]);
            }
        }
      }
    }

    float Lq[NT][2], Dq[NT][2];  // dK/dV: L and delta of the lane's queries 8 n + 2 t4 (+ 1) of the set
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float2 lv = make_float2(0.f, 0.f), dv = lv;
      if (kDKV && live) {
        lv = *reinterpret_cast<const float2*>(lse + stat0 + s0 + cs + 8 * n + 2 * ln.t4);
        dv = *reinterpret_cast<const float2*>(delta_in + stat0 + s0 + cs + 8 * n + 2 * ln.t4);
      }
      Lq[n][0] = lv.x, Lq[n][1] = lv.y, Dq[n][0] = dv.x, Dq[n][1] = dv.y;
    }
    // P = exp(S - L) (dK/dV: P^T with the queries' L), 0 where the key lies past the query; dS = P (dP -
    // delta); dS into plane 0, P^T into plane 1
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float pv[2], dsv[2];
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int e = 2 * i + e1, own = row0 + ln.g + 8 * i, other = s0 + cs + 8 * n + 2 * ln.t4 + e1;
          const bool masked = kDKV ? own > other : other > own;
          const float lv = kDKV ? Lq[n][e1] : L[i], dl = kDKV ? Dq[n][e1] : Di[i];
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int hf = 0; hf < NPAR; ++hf) s += sp[0][hf][n][e], dp += sp[1][hf][n][e];
          pv[e1] = masked ? 0.f : expf(s - lv);
          dsv[e1] = pv[e1] * (dp - dl);
        }
        const int at = (w0 + ln.g + 8 * i) * SPP + cs + 8 * n + 2 * ln.t4;
        put(planes, at, dsv);
        if constexpr (kDKV) put(planes + NPL * kM * SPP, at, pv);
      }
    __syncthreads();  // the planes are written

    // the output products: streamed rows klo .. khi - 1 of the step pair with some of the warp's rows
    const int klo = kDKV && row0 > s0 ? row0 - s0 : 0;
    const int khi = !kDKV && row0 + 16 - s0 < kSplitKeys ? row0 + 16 - s0 : kSplitKeys;
    uint32_t pa[NO][kSplitKeys / 16][4];  // bf16: the A operands, read once a step
    if constexpr (!kF32) {
#pragma unroll
      for (int oo = 0; oo < NO; ++oo)
#pragma unroll
        for (int kk = 0; kk < kSplitKeys / 16; ++kk)
          ldmatrix_x4(pa[oo][kk], planes + oo * kM * SPP + (w0 + ln.a_row) * SPP + 16 * kk + ln.a_col);
    }
    auto out_piece = [&](float (&a)[NT][4], int oo, const T* Yp) {
      if constexpr (kF32) {
        const T* big = planes + NPL * oo * kM * SPP;
        split_out_tf32(a, big, big + kM * SPP, w0, Yp, cs, klo, khi, ln);
      } else {
        split_out_bf16(a, pa[oo], Yp, cs, klo, khi, ln);
      }
    };
    // the slice's pieces still in the last score slot, read before the ring moves on
    const T* last_slot = ring + ((slot - 1) % NSL) * SLOT * PIECE;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i >= nV) break;
      if (i < nV - r) continue;
      const T* col = last_slot + W * (last - nV + i) * PIECE;  // its column's pieces in that slot
#pragma unroll
      for (int oo = 0; oo < NO; ++oo) out_piece(acc[oo][i], oo, col + oo * PIECE);
    }
    // the rest, streamed again, OC columns a slot
    const T* Os = ring;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (i >= nV - r) break;
      if (i % OC == 0) Os = next_slot(slot++);
#pragma unroll
      for (int oo = 0; oo < NO; ++oo) out_piece(acc[oo][i], oo, Os + (NO * (i % OC) + oo) * PIECE);
    }
  }
  cp_async_wait<0>();  // the empty groups past the end

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t row = row0 + ln.g + 8 * i;
#pragma unroll
    for (int oo = 0; oo < NO; ++oo) {
      T* dst = (oo == 0 ? out0 : out1) + ((static_cast<int64_t>(b) * T_len + row) * H + h) * D + kSplitKeys * c0 +
               cs + 2 * ln.t4;
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        if (p >= nV) break;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float x = acc[oo][p][n][2 * i], y = acc[oo][p][n][2 * i + 1];
          if constexpr (kF32) *reinterpret_cast<float2*>(dst + kSplitKeys * p + 8 * n) = make_float2(x, y);
          else *reinterpret_cast<uint32_t*>(dst + kSplitKeys * p + 8 * n) = pack_bf16(x, y);
        }
      }
    }
  }
}

// dQ and delta: what flash_bwd_dq_mma_kernel computes, past head_dim 256, in both dtypes.
template <typename T>
__global__ void __launch_bounds__(64 * kSplitSets, 1)
flash_bwd_dq_split_mma_kernel(const T* q, const T* k, const T* v, const T* o, const T* dout, Layout lq, Layout lk,
                              Layout lv, Layout lo, Layout ldo, const float* lse, float* delta, T* dq, int H,
                              int T_len, int D, bool held) {
  bwd_split<T, false>(q, dout, k, v, lq, ldo, lk, lv, o, lo, lse, nullptr, delta, dq, nullptr, H, T_len, D, held);
}

// dK and dV: what flash_bwd_dkv_mma_kernel computes, past head_dim 256, in both dtypes.
template <typename T>
__global__ void __launch_bounds__(64 * kSplitSets, 1)
flash_bwd_dkv_split_mma_kernel(const T* q, const T* k, const T* v, const T* dout, Layout lq, Layout lk, Layout lv,
                               Layout ldo, const float* lse, const float* delta, T* dk, T* dv, int H, int T_len,
                               int D, bool held) {
  bwd_split<T, true>(k, v, q, dout, lk, lv, lq, ldo, nullptr, Layout{0, 0, 0}, lse, delta, nullptr, dk, dv, H, T_len,
                     D, held);
}

// ---- launchers ----

// kernel<<<grid, threads, smem, stream>>>: the CPU emulation defines its own
#ifndef FPS_LAUNCH
#define FPS_LAUNCH(kernel, grid, threads, smem, stream) kernel<<<grid, threads, smem, stream>>>
#endif

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
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = fwd_mma_smem_bytes<D>();
    static_assert(smem <= kSmemLimit, "forward tiles outgrow shared memory");
    const auto kernel = flash_fwd_mma_kernel<D>;
    int err = prepare(kernel, smem);
    if (err != 0) return err;
    FPS_LAUNCH(kernel, dim3(T_len / kMma, B * H), 128 * fwd_splits<D>(), smem, stream)(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        layout_at(st, 0), layout_at(st, 1), layout_at(st, 2), static_cast<bf16*>(o), lse, H, T_len);
  } else {
    constexpr int smem = fwd_f32_smem_bytes<D>();
    static_assert(smem <= kSmemLimit, "forward tiles outgrow shared memory");
    const auto kernel = flash_fwd_tf32_kernel<D>;
    int err = prepare(kernel, smem);
    if (err != 0) return err;
    FPS_LAUNCH(kernel, dim3(B * H, T_len / fwd_f32_own<D>()), fwd_f32_threads<D>(), smem, stream)(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        layout_at(st, 0), layout_at(st, 1), layout_at(st, 2), static_cast<float*>(o), lse, H, T_len);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const int64_t* st, const float* lse, float* delta, void* dq, int B, int T_len, int H,
              cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = dq_mma_smem_bytes<D>();
    static_assert(smem <= kSmemLimit, "dQ tiles outgrow shared memory");
    const auto kernel = flash_bwd_dq_mma_kernel<D>;
    int err = prepare(kernel, smem);
    if (err != 0) return err;
    FPS_LAUNCH(kernel, dim3(T_len / kMma, B * H), 128 * dq_splits<D>(), smem, stream)(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), layout_at(st, 0), layout_at(st, 1),
        layout_at(st, 2), layout_at(st, 3), layout_at(st, 4), lse, delta, static_cast<bf16*>(dq), H,
        T_len);
  } else {
    constexpr int smem = f32_smem_bytes<D>();
    static_assert(smem <= kSmemLimit, "dQ tiles outgrow shared memory");
    const auto kernel = flash_bwd_dq_tf32_kernel<D>;
    int err = prepare(kernel, smem);
    if (err != 0) return err;
    FPS_LAUNCH(kernel, dim3(B * H, T_len / f32_own<D>()), dq_f32_threads<D>(), smem, stream)(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(o), static_cast<const float*>(dout), layout_at(st, 0), layout_at(st, 1),
        layout_at(st, 2), layout_at(st, 3), layout_at(st, 4), lse, delta, static_cast<float*>(dq), H,
        T_len);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const int64_t* st,
               const float* lse, const float* delta, void* dk, void* dv, int B, int T_len, int H,
               cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int smem = dkv_mma_smem_bytes<D>();
    static_assert(smem <= kSmemLimit, "dK/dV tiles outgrow shared memory");
    const auto kernel = flash_bwd_dkv_mma_kernel<D>;
    int err = prepare(kernel, smem);
    if (err != 0) return err;
    FPS_LAUNCH(kernel, dim3(T_len / kMma, B * H), 128 * dkv_splits<D>(), smem, stream)(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), layout_at(st, 0), layout_at(st, 1), layout_at(st, 2),
        layout_at(st, 3), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T_len);
  } else {
    constexpr int smem = f32_smem_bytes<D>();
    static_assert(smem <= kSmemLimit, "dK/dV tiles outgrow shared memory");
    const auto kernel = flash_bwd_dkv_tf32_kernel<D>;
    int err = prepare(kernel, smem);
    if (err != 0) return err;
    FPS_LAUNCH(kernel, dim3(B * H, T_len / f32_own<D>()), dkv_f32_threads<D>(), smem, stream)(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), layout_at(st, 0), layout_at(st, 1), layout_at(st, 2),
        layout_at(st, 3), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), H, T_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// The column-split route: head widths past 256, any multiple of 64.  The
// forward's blocks own 16 query rows in float32 (as fast as 32 at D 320
// and faster at 512, timed at B 2, T 1024, H 2) and 32 in bf16, or 16
// where 32 rows of q do not fit whole; q is held whole where it fits and
// streamed beside k past that (float32 past D 1,280, bf16 past D 2,432).
template <typename T>
int launch_fwd_split(const void* q, const void* k, const void* v, const int64_t* st, void* o, float* lse,
                     int B, int T_len, int H, int D, cudaStream_t stream) {
  const int kM = sizeof(T) == 2 && fwd_split_smem_bytes<T>(D, 32, true) <= kSmemLimit ? 32 : 16;
  const bool q_whole = fwd_split_smem_bytes<T>(D, kM, true) <= kSmemLimit;
  const int smem = fwd_split_smem_bytes<T>(D, kM, q_whole);
  const int slices = (D / kSplitKeys + kSplitPieces - 1) / kSplitPieces;
  const auto kernel = flash_fwd_split_mma_kernel<T>;
  int err = prepare(kernel, smem);
  if (err != 0) return err;
  FPS_LAUNCH(kernel, dim3(B * H, T_len / kM, slices), kM / 16 * kSplitSets * 32, smem, stream)(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), layout_at(st, 0),
      layout_at(st, 1), layout_at(st, 2), static_cast<T*>(o), lse, H, T_len, D, q_whole);
  return static_cast<int>(cudaGetLastError());
}

// The column-split backward (see there): bwd_split_rows own rows a block, the own rows held whole where
// they fit, a dQ slice of up to 8 pieces and a dK/dV slice of up to 4, the slices of a tile side by side
// in the grid's x.
template <typename T, bool kDKV>
struct BwdSplitShape {
  int kM = bwd_split_rows<kDKV>(), slices, smem;
  bool held;
  explicit BwdSplitShape(int D)
      : slices((D / kSplitKeys * bwd_split_outputs<kDKV>() + kSplitPieces - 1) / kSplitPieces),
        held(bwd_split_smem_bytes<T, kDKV>(D, bwd_split_rows<kDKV>(), true) <= kSmemLimit) {
    smem = bwd_split_smem_bytes<T, kDKV>(D, kM, held);
  }
  dim3 grid(int B, int H, int T_len) const { return dim3(B * H * slices, T_len / kM); }
  int threads() const { return kM / 16 * kSplitSets * 32; }
};

template <typename T>
int launch_dq_split(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const int64_t* st, const float* lse, float* delta, void* dq, int B, int T_len, int H,
                    int D, cudaStream_t stream) {
  const BwdSplitShape<T, false> sh(D);
  const auto kernel = flash_bwd_dq_split_mma_kernel<T>;
  int err = prepare(kernel, sh.smem);
  if (err != 0) return err;
  FPS_LAUNCH(kernel, sh.grid(B, H, T_len), sh.threads(), sh.smem, stream)(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), layout_at(st, 0), layout_at(st, 1),
      layout_at(st, 2), layout_at(st, 3), layout_at(st, 4), lse, delta, static_cast<T*>(dq), H, T_len, D,
      sh.held);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv_split(const void* q, const void* k, const void* v, const void* dout, const int64_t* st,
                     const float* lse, const float* delta, void* dk, void* dv, int B, int T_len, int H,
                     int D, cudaStream_t stream) {
  const BwdSplitShape<T, true> sh(D);
  const auto kernel = flash_bwd_dkv_split_mma_kernel<T>;
  int err = prepare(kernel, sh.smem);
  if (err != 0) return err;
  FPS_LAUNCH(kernel, sh.grid(B, H, T_len), sh.threads(), sh.smem, stream)(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), layout_at(st, 0), layout_at(st, 1), layout_at(st, 2),
      layout_at(st, 3), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, T_len, D, sh.held);
  return static_cast<int>(cudaGetLastError());
}

// Picks the kernels for (dtype, head_dim): a template of its own at 64, 128,
// 192 and 256, the column-split kernels at any wider multiple of 64;
// cudaErrorInvalidValue for anything else.
#define FPS_FLASH_DISPATCH(CALL, SPLIT)                                   \
  if (dtype == fps::kF32 || dtype == fps::kBF16) {                        \
    const bool f32 = dtype == fps::kF32;                                  \
    switch (head_dim) {                                                   \
      case 64: return f32 ? CALL(float, 64) : CALL(fps::bf16, 64);        \
      case 128: return f32 ? CALL(float, 128) : CALL(fps::bf16, 128);     \
      case 192: return f32 ? CALL(float, 192) : CALL(fps::bf16, 192);     \
      case 256: return f32 ? CALL(float, 256) : CALL(fps::bf16, 256);     \
      default:                                                            \
        if (head_dim > 256 && head_dim % fps::kSplitKeys == 0)            \
          return f32 ? SPLIT(float) : SPLIT(fps::bf16);                   \
    }                                                                     \
  }                                                                       \
  return static_cast<int>(cudaErrorInvalidValue);

}  // namespace fps

// strides: (b, t, h) element strides of each input in argument order, from a
// host array.  Outputs (o, dq, dk, dv) are contiguous (B, T, H, D); lse and
// delta contiguous (B, H, T) float32.  head_dim is 64, 128, 192, 256 or a
// wider multiple of 64; T must be a multiple of 64, and
// bfloat16 inputs 16-byte aligned rows (pointer and strides).  Each returns
// the CUDA error code of its launch (0 = ok).
extern "C" int fps_flash_fwd(int dtype, int head_dim, const void* q, const void* k, const void* v,
                             const int64_t* strides, void* o, float* lse, int B, int T, int H,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPS_CALL(TYPE, DIM) fps::launch_fwd<TYPE, DIM>(q, k, v, strides, o, lse, B, T, H, s)
#define FPS_SPLIT(TYPE) fps::launch_fwd_split<TYPE>(q, k, v, strides, o, lse, B, T, H, head_dim, s)
  FPS_FLASH_DISPATCH(FPS_CALL, FPS_SPLIT)
#undef FPS_SPLIT
#undef FPS_CALL
}

extern "C" int fps_flash_bwd_dq(int dtype, int head_dim, const void* q, const void* k,
                                const void* v, const void* o, const void* dout,
                                const int64_t* strides, const float* lse, float* delta, void* dq,
                                int B, int T, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPS_CALL(TYPE, DIM) \
  fps::launch_dq<TYPE, DIM>(q, k, v, o, dout, strides, lse, delta, dq, B, T, H, s)
#define FPS_SPLIT(TYPE) \
  fps::launch_dq_split<TYPE>(q, k, v, o, dout, strides, lse, delta, dq, B, T, H, head_dim, s)
  FPS_FLASH_DISPATCH(FPS_CALL, FPS_SPLIT)
#undef FPS_SPLIT
#undef FPS_CALL
}

extern "C" int fps_flash_bwd_dkv(int dtype, int head_dim, const void* q, const void* k,
                                 const void* v, const void* dout, const int64_t* strides,
                                 const float* lse, const float* delta, void* dk, void* dv, int B,
                                 int T, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPS_CALL(TYPE, DIM) \
  fps::launch_dkv<TYPE, DIM>(q, k, v, dout, strides, lse, delta, dk, dv, B, T, H, s)
#define FPS_SPLIT(TYPE) \
  fps::launch_dkv_split<TYPE>(q, k, v, dout, strides, lse, delta, dk, dv, B, T, H, head_dim, s)
  FPS_FLASH_DISPATCH(FPS_CALL, FPS_SPLIT)
#undef FPS_SPLIT
#undef FPS_CALL
}
