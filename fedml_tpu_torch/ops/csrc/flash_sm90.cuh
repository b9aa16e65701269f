// Shared by the tensor-core flash kernels (flash_fwd_sm90.cu,
// flash_bwd_sm90.cu): the swizzled bf16 tile that TMA writes and wgmma
// reads, small device helpers, and the host-side tensor maps over the
// [R, B, T, H, D] operand layout of flash_common.cuh.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cmath>

#include "wgmma_sm90.cuh"

namespace fedml_tpu_torch {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int WG = 128;  // one warpgroup per block
constexpr float kLog2e = 1.4426950408889634f;

// A [ROWS][D] bf16 tile in shared memory as TMA writes it: D in atoms of at
// most 64 columns, each atom a [ROWS][COLS] block swizzled at its row
// width (TMA's swizzle mode and the descriptors' layout type agree).
template <int D, int ROWS>
struct Tile {
  static constexpr int COLS = D < 64 ? D : 64;
  static constexpr int ATOMS = D / COLS;
  static constexpr int ROW_BYTES = COLS * 2;  // 32, 64 or 128
  static constexpr int ATOM_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = ATOMS * ATOM_BYTES;
  static constexpr uint32_t MODE = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2
                                                                          : 3;

  // The tile as a K-major operand (the product contracts over D): the
  // descriptor of contraction step k (columns 16k..16k+15).
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int k) {
    const int col = 16 * k;
    return make_desc(base + (col / COLS) * ATOM_BYTES + (col % COLS) * 2, 16,
                     8 * ROW_BYTES, MODE);
  }
  // The tile as an MN-major B operand with N = D (the product contracts
  // over the rows): step k is rows 16k..16k+15; atoms are ATOM_BYTES apart.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int k) {
    return make_desc(base + 16 * k * ROW_BYTES, ATOM_BYTES, 8 * ROW_BYTES,
                     MODE);
  }
  // Rows [t0, t0 + ROWS) of head (r, b, h), all atoms, completing on bar.
  static __device__ __forceinline__ void load(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int t0, int h,
                                              int b, int r) {
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
      tma_load_5d(dst + a * ATOM_BYTES, map, bar, a * COLS, t0, h, b, r);
  }
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void store_bf16x2(bf16* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
}

// --- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver API, through the runtime
// (the extension does not link libcuda itself); null if it is missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of one [R, B, T, H, D] bf16 operand, dims innermost first
// {D, T, H, B, R}, read in boxes of {min(D, 64), rows} with the swizzle of
// that row width. A dim of size 1 takes the T stride (its stride is never
// used, and TMA wants every stride a multiple of 16 bytes). Rows at or past
// T read as zeros.
inline CUresult make_map(CUtensorMap* map, const void* ptr,
                         const long long* s, int R, int B, int T_len, int H,
                         int D, int rows) {
  const int cols = D < 64 ? D : 64;
  const long long st = s[2];
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B),
                              static_cast<cuuint64_t>(R)};
  const cuuint64_t strides[4] = {
      static_cast<cuuint64_t>(2 * st),
      static_cast<cuuint64_t>(2 * (H > 1 ? s[3] : st)),
      static_cast<cuuint64_t>(2 * (B > 1 ? s[1] : st)),
      static_cast<cuuint64_t>(2 * (R > 1 ? s[0] : st))};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace sm90
}  // namespace fedml_tpu_torch
