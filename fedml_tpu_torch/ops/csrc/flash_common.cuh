// Shared by the f32 flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, the strided [R, B, T, H, D] operand view, the split-TF32
// tensor-core product (mma.sync m16n8k8), cp.async tile copies, and the
// fragment helpers that feed one product's accumulator to the next.
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

#include <cuda_runtime.h>

namespace fedml_tpu_torch {
namespace flash {

constexpr int BM = 64;             // query rows per tile
constexpr int BN = 64;             // key rows per tile
constexpr int kThreads = 128;      // 4 warps x 16 rows of a 64-row tile
constexpr float kNegInf = -1e30f;  // the TPU kernels' NEG_INF

struct Strides {
  long long r, b, t, h;
};

inline Strides strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3]};
}

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

// --- split TF32 on the tensor cores -----------------------------------------
//
// x ≈ hi + lo with hi = tf32(x) and lo = tf32(x − hi), both rounded to
// nearest, ties away; a·b ≈ hi_a·hi_b + hi_a·lo_b + lo_a·hi_b with f32 sums
// keeps about 2⁻²¹ of |a·b| where one TF32 pass keeps 2⁻¹¹.

// x rounded to TF32 on its bit pattern: half a TF32 ulp added to the
// magnitude, the 13 low mantissa bits cleared. For every finite x these are
// the bits of cvt.rna.tf32.f32, which sm_90a expands into several more
// instructions (NaN and infinity handling) than this add and mask.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
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

template <int D>
constexpr int tile_floats() {
  return BM * tile_pitch<D>();
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

// --- fragments of one warp's 16 rows ---------------------------------------

// acc[nb] += A·Bᵀ over the D columns of two tiles: A the warp's 16 rows
// (`a` at its first), B rows [8·nb, 8·nb + 8) of `b`. S = Q·Kᵀ in the
// forward; S = Q·Kᵀ and dP = dO·Vᵀ in dq; Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in
// dk/dv.
template <int D, int NB>
__device__ __forceinline__ void rows_by_rows(float (&acc)[NB][4],
                                             const float* a, const float* b,
                                             int g, int t) {
  constexpr int P = tile_pitch<D>();
#pragma unroll 1
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    const float* pa = a + g * P + kk * 8 + t;
    split_tf32(pa[0], ah[0], al[0]);
    split_tf32(pa[8 * P], ah[1], al[1]);
    split_tf32(pa[4], ah[2], al[2]);
    split_tf32(pa[8 * P + 4], ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float* pb = b + (nb * 8 + g) * P + kk * 8 + t;
      uint32_t bh[2], bl[2];
      split_tf32(pb[0], bh[0], bl[0]);
      split_tf32(pb[4], bh[1], bl[1]);
      mma_3xtf32(acc[nb], ah, al, bh, bl);
    }
  }
}

// acc[dn] += C·B: C an accumulator tile in registers (the warp's 16 rows by
// 8·NB columns), B rows [0, 8·NB) of `b` by its D columns. O += P·V in the
// forward; dq += dS·K in dq; dv += P̃ᵀ·dO and dk += dSᵀ·Q in dk/dv. C's
// fragment is the A fragment under the permuted k index: k t ↔ column 2t,
// k t + 4 ↔ column 2t + 1, with B's rows read under the same permutation.
template <int D, int NB>
__device__ __forceinline__ void frag_by_rows(float (&acc)[D / 8][4],
                                             const float (&c)[NB][4],
                                             const float* b, int g, int t) {
  constexpr int P = tile_pitch<D>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    uint32_t ah[4], al[4];
    split_tf32(c[nb][0], ah[0], al[0]);
    split_tf32(c[nb][2], ah[1], al[1]);
    split_tf32(c[nb][1], ah[2], al[2]);
    split_tf32(c[nb][3], ah[3], al[3]);
    const float* pb = b + (nb * 8 + 2 * t) * P + g;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      uint32_t bh[2], bl[2];
      split_tf32(pb[dn * 8], bh[0], bl[0]);
      split_tf32(pb[dn * 8 + P], bh[1], bl[1]);
      mma_3xtf32(acc[dn], ah, al, bh, bl);
      // At D 128 the accumulators fill the registers: keep the compiler
      // from hoisting later columns' loads (and their splits) above here.
      if constexpr (D >= 128) asm volatile("" ::: "memory");
    }
  }
}

// acc += part, element by element, and part = 0: a walked tile's sums join
// the running sums in f32 adds rounded to nearest.
template <int D>
__device__ __forceinline__ void add_tile(float (&acc)[D / 8][4],
                                         float (&part)[D / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[dn][e] += part[dn][e];
      part[dn][e] = 0.f;
    }
}

template <int D>
__device__ __forceinline__ void zero_tile(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
}

// One row of a contiguous [.., T, H, D] output (`out` at its start) from
// an accumulator tile: element 8·dn + 2t + j is acc[dn][2·half + j]·mul.
template <int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[D / 8][4],
                                           int half, float mul, int t) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    *reinterpret_cast<float2*>(out + dn * 8 + 2 * t) =
        make_float2(acc[dn][2 * half] * mul, acc[dn][2 * half + 1] * mul);
}

}  // namespace flash
}  // namespace fedml_tpu_torch
