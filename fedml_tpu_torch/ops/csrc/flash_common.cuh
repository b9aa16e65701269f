// Shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu): tile
// sizes, element conversions, the strided [R, B, T, H, D] operand view, and
// the split-TF32 tensor-core product and cp.async tile copies of the f32
// backward.
//
// Every operand of the three kernels is read through its strides over
// (R, B, T, H) with D at stride 1. R is an outer batch dim with a stride of
// its own: under torch.func.vmap the client dim becomes R, so one launch
// serves every client whatever the physical position of that dim (the
// trainer lays token batches out as [B, C, T], where no view merges C into
// B). A plain call has R = 1. Outputs are contiguous [R, B, T, H, D]; lse
// and delta are contiguous [R, B, H, T] f32.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fedml_tpu_torch {
namespace flash {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // key rows per tile
constexpr int NT = 256;       // threads: 16 row groups x 16 column groups
constexpr int LDP = BN + 16;  // pitch of a [64][64] tile in shared memory:
                              // the two row groups of a warp hit disjoint banks
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long r, b, t, h;
};

// The (r, b, h) of grid row `bh` = (r·B + b)·H + h, and the base pointer of
// that (r, b, h) in an operand read through strides `s`.
struct Head {
  int r, b, h;
  __device__ Head(int bh, int B, int H) {
    h = bh % H;
    const int rb = bh / H;
    r = rb / B;
    b = rb - r * B;
  }
  template <typename T>
  __device__ const T* at(const T* p, const Strides& s) const {
    return p + r * s.r + b * s.b + h * s.h;
  }
};

// Rows [row0, row0 + 64) of one head into a [64][D + 1] f32 tile (odd pitch:
// 16 rows at one column fall in 16 banks); rows at or past T_len read 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride_t, int row0,
                                          int T_len) {
  for (int idx = threadIdx.x; idx < BM * D; idx += NT) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < T_len ? to_float(src[row * stride_t + d])
                                       : 0.f;
  }
}

// --- split TF32 on the tensor cores -----------------------------------------
//
// x ≈ hi + lo with hi = tf32(x) and lo = tf32(x − hi), both rounded to
// nearest, ties away (cvt.rna); a·b ≈ hi_a·hi_b + hi_a·lo_b + lo_a·hi_b with
// f32 sums keeps about 2⁻²¹ of |a·b| where one TF32 pass keeps 2⁻¹¹.

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// c += a·b on one m16n8k8 tile (A row-major 16 × 8, B column-major 8 × 8).
// Fragments, with g = lane / 4 and t = lane % 4: a = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b = (k t, n g), (k t + 4, n g); c = (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three passes, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// --- cp.async tiles ---------------------------------------------------------

// `bytes` (4 or 16) from global to shared memory; src_bytes 0 writes zeros
// and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const size_t g = __cvta_generic_to_global(src);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(g), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(g), "r"(src_bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The pitch of a [64][D] f32 tile in shared memory: D + 4 floats, 4 times an
// odd number, so the fragment reads of the m16n8k8 products — eight rows at
// one of four columns, or four even rows at eight columns — fall in 32
// distinct banks, and every row starts on 16 bytes.
template <int D>
constexpr int tile_pitch() {
  return D + 4;
}

// Whether a head's rows can be copied in 16-byte pieces: its base and its T
// stride multiples of 16 bytes (D is a multiple of 4).
__device__ __forceinline__ bool rows_16b(const float* base,
                                         long long stride_t) {
  return (reinterpret_cast<uintptr_t>(base) & 15) == 0 && (stride_t & 3) == 0;
}

// Rows [row0, row0 + 64) of one head (D f32 each, `stride_t` apart) into a
// [64][tile_pitch<D>] tile by cp.async, in 16-byte pieces when `vec`, else
// 4-byte ones; rows at or past T_len are zero-filled. The caller commits.
template <int D, int THREADS>
__device__ __forceinline__ void cp_tile(float* dst, const float* src,
                                        long long stride_t, int row0,
                                        int T_len, bool vec) {
  constexpr int P = tile_pitch<D>();
  if (vec) {
    constexpr int C = D / 4;  // 16-byte pieces a row
    static_assert(BM * C % THREADS == 0, "pieces per thread");
#pragma unroll
    for (int i = 0; i < BM * C / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / C, c = idx % C;
      const int row = row0 + r;
      const bool in = row < T_len;
      cp_async<16>(dst + r * P + 4 * c,
                   src + (in ? row : 0) * stride_t + 4 * c, in ? 16 : 0);
    }
  } else {
    static_assert(BM * D % THREADS == 0, "elements per thread");
#pragma unroll 4
    for (int i = 0; i < BM * D / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / D, d = idx % D;
      const int row = row0 + r;
      const bool in = row < T_len;
      cp_async<4>(dst + r * P + d, src + (in ? row : 0) * stride_t + d,
                  in ? 4 : 0);
    }
  }
}

}  // namespace flash
}  // namespace fedml_tpu_torch
