// A CPU emulation of the CUDA the port's kernels use, so that g++ can build
// csrc/flash_attn.cu, csrc/scatter_add.cu or csrc/fused_mf.cu into a shared
// library with the same C interface and the kernels' logic can be checked
// without a card:
//
//   g++ -std=c++20 -O2 -shared -fPIC -pthread -x c++ -I csrc/emulation \
//       -include cuda_emu.h -o libflash_emu.so csrc/flash_attn.cu
//
// One std::thread per CUDA thread, blocks one after another; std::barrier
// for __syncthreads, __syncthreads_count and the warp-collective
// instructions; float2 and float4 as 8- and 16-byte aligned structs;
// cp.async copies deferred until the cp.async.wait_group that covers them;
// ldmatrix, mma.m16n8k16 (bf16 in, float32 sums) and mma.m16n8k8 (TF32 in,
// float32 sums, truncating as the tensor cores do) with the PTX ISA's
// fragment layouts; the TF32 rounding of mma.cuh's to_tf32.  Shared memory
// is filled with NaN before each block, and every ldmatrix and cp.async
// address is checked for 16-byte alignment and for lying in shared memory.
// A launch runs to its end before it returns.
#pragma once

#include <math.h>
#include <stdint.h>

#include <cmath>

#include <barrier>
#include <cassert>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define FPS_MMA_EMULATION 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, gridDim, blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

struct __nv_bfloat16 {
  uint16_t bits;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even; NaN stays NaN
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<uint16_t>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.bits; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short s) { return {s}; }
inline int64_t min(int64_t a, int64_t b) { return a < b ? a : b; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}

struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }

namespace emu {

constexpr size_t kSharedBytes = 232448;  // what a block may use on an H100

struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar;
  const void* ptr[32][32];
  float val[32][32];
  int count = 0;
  uint32_t a[32][32][4];
  uint32_t b[32][32][2];
  uint32_t tf32_a[2][32][32][4];  // mma_tf32's operands, two buffers in turn
  uint32_t tf32_b[2][32][32][2];
};
inline Block* block;
inline thread_local int lane, warp;
inline thread_local int tf32_buffer;  // the buffer this lane's next mma_tf32 fills
inline void warp_sync() { block->warp_bar[warp]->arrive_and_wait(); }

struct Copy {
  void* dst;
  const void* src;
};
inline thread_local std::vector<Copy> open_group;
inline thread_local std::vector<std::vector<Copy>> committed;

}  // namespace emu

namespace fps {  // the kernels' dynamic shared memory (extern __shared__ ... in flash_attn.cu)
alignas(16) inline float smem[emu::kSharedBytes / 4];
alignas(16) inline unsigned char smem_raw[emu::kSharedBytes];
}  // namespace fps

namespace emu {

inline bool in_shared(const void* p, size_t n) {
  const auto a = reinterpret_cast<uintptr_t>(p);
  const auto f = reinterpret_cast<uintptr_t>(fps::smem), r = reinterpret_cast<uintptr_t>(fps::smem_raw);
  return (a >= f && a + n <= f + kSharedBytes) || (a >= r && a + n <= r + kSharedBytes);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

inline float bf16_bits(uint32_t r, int high) {
  return __bfloat162float(__nv_bfloat16{static_cast<uint16_t>(high ? r >> 16 : r & 0xffffu)});
}

// Runs kernel(args...) as grid x threads CUDA threads, one block at a time.
template <typename Kernel>
struct Launch {
  dim3 grid;
  int threads;
  Kernel kernel;
  template <typename... Args>
  void operator()(Args... args) const {
    assert(threads % 32 == 0 && threads <= 1024);
    for (unsigned bz = 0; bz < grid.z; ++bz)
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          std::memset(fps::smem, 0xff, kSharedBytes);
          std::memset(fps::smem_raw, 0xff, kSharedBytes);
          Block blk;
          blk.bar = std::make_unique<std::barrier<>>(threads);
          for (int w = 0; w < threads / 32; ++w) blk.warp_bar.push_back(std::make_unique<std::barrier<>>(32));
          block = &blk;
          std::vector<std::thread> pool;
          for (int t = 0; t < threads; ++t)
            pool.emplace_back([&, t] {
              threadIdx = dim3(t);
              blockIdx = dim3(bx, by, bz);
              gridDim = grid;
              blockDim = dim3(threads);
              lane = t % 32;
              warp = t / 32;
              kernel(args...);
              assert(open_group.empty() && committed.empty());
            });
          for (auto& th : pool) th.join();
        }
  }
};

}  // namespace emu

#define FPS_LAUNCH(kernel, grid, threads, smem, stream) (emu::Launch<decltype(kernel)>{grid, threads, kernel})

template <typename Kernel>
inline cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int bytes) {
  return bytes <= static_cast<int>(emu::kSharedBytes) ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline void __syncthreads() { emu::block->bar->arrive_and_wait(); }

inline int __syncthreads_count(int pred) {
  auto& b = *emu::block;
  static std::mutex m;
  b.bar->arrive_and_wait();
  if (pred) {
    std::lock_guard<std::mutex> hold(m);
    ++b.count;
  }
  b.bar->arrive_and_wait();
  const int total = b.count;
  b.bar->arrive_and_wait();
  if (threadIdx.x == 0) b.count = 0;  // before any thread passes the next call's first barrier
  return total;
}

inline float __shfl_xor_sync(unsigned, float v, int off) {
  auto& b = *emu::block;
  b.val[emu::warp][emu::lane] = v;
  emu::warp_sync();
  const float r = b.val[emu::warp][emu::lane ^ off];
  emu::warp_sync();
  return r;
}

// The helpers of csrc/mma.cuh, emulated.
namespace fps {

inline void cp_async_16(void* dst, const void* src) {
  assert(emu::aligned16(dst) && emu::aligned16(src) && emu::in_shared(dst, 16));
  emu::open_group.push_back({dst, src});
}

inline void cp_async_commit() {
  emu::committed.push_back(std::move(emu::open_group));
  emu::open_group.clear();
}

template <int N>
inline void cp_async_wait() {
  while (emu::committed.size() > static_cast<size_t>(N)) {
    for (const auto& c : emu::committed.front()) std::memcpy(c.dst, c.src, 16);
    emu::committed.erase(emu::committed.begin());
  }
}

// Lane l receives, of matrix i (rows at the addresses of lanes 8 i .. 8 i + 7),
// row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1; transposed: rows 2 (l % 4)
// and 2 (l % 4) + 1 of column l / 4.
inline void ldmatrix_x4_any(uint32_t (&r)[4], const void* p, bool trans) {
  auto& b = *emu::block;
  const int w = emu::warp, l = emu::lane;
  assert(emu::aligned16(p) && emu::in_shared(p, 16));
  b.ptr[w][l] = p;
  emu::warp_sync();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (!trans) {
      const auto* row = static_cast<const uint16_t*>(b.ptr[w][8 * i + l / 4]);
      lo = row[2 * (l % 4)];
      hi = row[2 * (l % 4) + 1];
    } else {
      lo = static_cast<const uint16_t*>(b.ptr[w][8 * i + 2 * (l % 4)])[l / 4];
      hi = static_cast<const uint16_t*>(b.ptr[w][8 * i + 2 * (l % 4) + 1])[l / 4];
    }
    r[i] = static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
  }
  emu::warp_sync();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) { ldmatrix_x4_any(r, p, false); }
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) { ldmatrix_x4_any(r, p, true); }

// d += A B, m16n8k16: A[r][k] sits in register (r >= 8) + 2 (k >= 8) of lane
// 4 (r % 8) + (k % 8) / 2, B[k][n] in register (k >= 8) of lane 4 n + (k % 8) / 2,
// the high half holding the odd k.
inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  auto& b = *emu::block;
  const int w = emu::warp, l = emu::lane;
  for (int i = 0; i < 4; ++i) b.a[w][l][i] = a[i];
  b.b[w][l][0] = b0;
  b.b[w][l][1] = b1;
  emu::warp_sync();
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float sum = d[e];
    for (int k = 0; k < 16; ++k)
      sum += emu::bf16_bits(b.a[w][4 * (row % 8) + (k % 8) / 2][(row >= 8) + 2 * (k >= 8)], k % 2) *
             emu::bf16_bits(b.b[w][4 * col + (k % 8) / 2][k >= 8], k % 2);
    d[e] = sum;
  }
  emu::warp_sync();
}

// TF32 rounding as mma.cuh's to_tf32 does it on the card, and as
// cvt.rna.tf32.f32 does for finite x only: to nearest, ties away from zero
// (add half a TF32 unit to the magnitude, then drop the 13 low bits).
inline uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// d += A B, m16n8k8 TF32: A[r][k] sits in register (r >= 8) + 2 (k >= 4) of
// lane 4 (r % 8) + k % 4, B[k][n] in register (k >= 4) of lane 4 n + k % 4.
// Each register is read as TF32, its 13 low bits cleared.  The eight
// products and d are summed exactly (in double) and the sum rounded toward
// zero: the tensor cores' adds truncate, so a sum carried through d drifts
// toward zero as on the card.  The operands go through two buffers in
// turn, so a call waits once: a lane fills a buffer again only after its
// whole warp has reached the next call's barrier, which each lane reaches
// after reading that buffer.
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int w = emu::warp, l = emu::lane, p = emu::tf32_buffer;
  emu::tf32_buffer ^= 1;
  auto& ea = emu::block->tf32_a[p][w];
  auto& eb = emu::block->tf32_b[p][w];
  for (int i = 0; i < 4; ++i) ea[l][i] = a[i];
  eb[l][0] = b0;
  eb[l][1] = b1;
  emu::warp_sync();
  const int g = l / 4, t = l % 4;
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    double sum = d[e];
    for (int k = 0; k < 8; ++k)
      sum += static_cast<double>(__uint_as_float(ea[4 * (row % 8) + k % 4][(row >= 8) + 2 * (k >= 4)] & 0xffffe000u)) *
             __uint_as_float(eb[4 * col + k % 4][k >= 4] & 0xffffe000u);
    float r = static_cast<float>(sum);
    if (std::fabs(static_cast<double>(r)) > std::fabs(sum)) r = std::nextafter(r, 0.f);
    d[e] = r;
  }
}

inline void mma_tf32_from_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  mma_tf32(d, a, b0, b1);
}

}  // namespace fps
