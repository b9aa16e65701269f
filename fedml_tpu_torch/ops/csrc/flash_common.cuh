// Shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu): tile
// sizes, element conversions and the strided [R, B, T, H, D] operand view.
//
// Every operand of the three kernels is read through its strides over
// (R, B, T, H) with D at stride 1. R is an outer batch dim with a stride of
// its own: under torch.func.vmap the client dim becomes R, so one launch
// serves every client whatever the physical position of that dim (the
// trainer lays token batches out as [B, C, T], where no view merges C into
// B). A plain call has R = 1. Outputs are contiguous [R, B, T, H, D]; lse
// and delta are contiguous [R, B, H, T] f32.

#pragma once

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

// x rounded to T and back: the TPU kernels' `.astype(dtype)` before a dot.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
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

}  // namespace flash
}  // namespace fedml_tpu_torch
