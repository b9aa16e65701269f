// Flash-attention forward for f32 operands on Hopper's tensor cores, in
// split TF32 (sm_90a): causal or full softmax attention with an online
// softmax; writes O and the row log-sum-exp. bf16 operands take the
// tensor-core kernel of flash_fwd_sm90.cu.
//
// Replaces fedml_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel reached through _fwd) for f32. Same arithmetic: S = (Q·Kᵀ)·scale
// with scale = 1/√D, causal mask NEG_INF = -1e30, a running row max m and
// sum l in f32 rescaled by c = exp(m_old − m_new), P·V summed in f32, l = 0
// rows guarded, O = acc / l, lse = m + log(l). (The TPU kernel's rounding
// of P to the input type before P·V is a no-op in f32.) The TPU's 8-row
// replication of lse is dropped: lse is [R, B, H, T]. Keys past T get −inf,
// so no weight at all; rows past T are not written.
//
// Both products run on the tensor cores as three TF32 passes (mma.sync
// m16n8k8; flash_common.cuh): a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi with
// a_hi = tf32(a), a_lo = tf32(a − a_hi), which keeps f32's accuracy (about
// 2⁻²¹ relative) where one TF32 pass keeps three digits.
//
// What bounds it on an H100: at the ViT's launch (R·B = 256, T = 64,
// H = 4, D = 32, full) it reads Q, K and V and writes O and lse, 33.8 MB,
// 10 µs at 3.35 TB/s, against 3 × 0.54 GFLOP of TF32 passes, 3.3 µs at
// 495 TFLOP/s: bound by bytes. At the FedAdapter shape in f32 (T = 2048,
// D = 64, causal) the products dominate: bound by operations.
//
// Design. One block of 4 warps per (r·b·h, 64-row Q tile), each warp owning
// 16 of the tile's rows; a loop inside the block walks the K/V tiles, so no
// sum crosses blocks, there are no atomics and a rerun gives the same bits.
// - Tiles reach shared memory by cp.async in 16-byte pieces (4-byte pieces
//   for a head whose base or T stride is not a multiple of 16 bytes, chosen
//   per operand inside the kernel), at a pitch of D + 4 floats so every
//   fragment read is free of bank conflicts, in groups in the order the
//   products use them: [Q, K], then [V], so S = Q·Kᵀ runs while V lands.
// - S is accumulated in registers, and the online softmax runs on its
//   accumulator fragments: a row's 64 columns sit in one lane quad, so its
//   max and sum take 2 shuffles. P then feeds P·V as the A operand without
//   leaving registers (frag_by_rows' permuted k index, V's rows read under
//   the same permutation): no P in shared memory and no barrier between
//   the products.
// - Each head dim is built twice: for one tile a head (T <= 64, the ViT's
//   launch; one pass, no loop) and for a walk over several (T > 64; K and
//   V double-buffered so the next tile's copies run under this tile's
//   products; below D 128 each tile's P·V summed apart and added to the
//   rescaled running O in f32, so the tensor cores' own additions chain
//   over one tile, not the whole walk). With causal masking the walk stops
//   at the diagonal tile, and the blocks take the Q tiles from the last
//   (the longest walk) to the first.
// - Only the tiles on the diagonal or at the ragged edge are masked.
// Operands are read through their [R, B, T, H, D] strides
// (flash_common.cuh), so the caller's views of one qkv buffer, and the
// clients' dim under vmap, need no copy.

#include <cmath>

#include "flash_common.cuh"

namespace fedml_tpu_torch {
namespace {

using namespace flash;

// Tiles [Q][K0][V0], and [K1][V1] for a walk.
template <int D, bool WALK>
constexpr int fwd_smem_bytes() {
  return (WALK ? 5 : 3) * tile_floats<D>() * static_cast<int>(sizeof(float));
}

// Max and sum over the lane quad that holds one row of an accumulator tile.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// WALK: T > 64, so the loop may walk more than one K/V tile, and each
// tile's P·V is kept apart before it joins the running O (PART; not at
// D 128, where the registers hold no second D-wide accumulator). One tile
// a head asks for 4 blocks an SM, 128 registers a thread; a walk for 1,
// which leaves it up to 255 for the running O and each tile's P·V.
template <int D, bool WALK>
__global__ void __launch_bounds__(kThreads, WALK ? 1 : 4)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, Strides sq, Strides sk,
                          Strides sv, int B, int H, int T_len, float scale,
                          int causal) {
  constexpr int P = tile_pitch<D>();
  constexpr int TILE = tile_floats<D>();

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  auto stage_k = [&](int st) { return sQ + (1 + 2 * st) * TILE; };
  auto stage_v = [&](int st) { return sQ + (2 + 2 * st) * TILE; };

  const int bh = blockIdx.x;
  const Head hd(bh, B, H);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // the longest walk first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* qb = hd.at(q, sq);
  const float* kb = hd.at(k, sk);
  const float* vb = hd.at(v, sv);
  const bool kvec = rows_16b(kb, sk.t), vvec = rows_16b(vb, sv.t);
  auto load_k = [&](int it) {
    cp_tile<D, kThreads>(stage_k(it & 1), kb, sk.t, it * BN, T_len, kvec);
  };
  auto load_v = [&](int it) {
    cp_tile<D, kThreads>(stage_v(it & 1), vb, sv.t, it * BN, T_len, vvec);
  };
  cp_tile<D, kThreads>(sQ, qb, sq.t, q0, T_len, rows_16b(qb, sq.t));
  load_k(0);
  cp_async_commit();
  load_v(0);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  constexpr bool PART = WALK && D < 128;
  float acc[D / 8][4], part[D / 8][4];
  zero_tile<D>(acc);
  zero_tile<D>(part);
  float (&sum)[D / 8][4] = PART ? part : acc;  // what P·V adds to

  const int kv_end = causal ? min(T_len, q0 + BM) : T_len;
  const int n_kv = WALK ? (kv_end + BN - 1) / BN : 1;
  for (int it = 0; it < n_kv; ++it) {
    // Pending: this tile's [K] (with Q at the first) and [V]. After the
    // barrier every warp is done with the other stage, which takes the
    // next tile.
    cp_async_wait<1>();
    __syncthreads();
    const bool next = WALK && it + 1 < n_kv;
    if (next) {
      load_k(it + 1);
      cp_async_commit();
      load_v(it + 1);
      cp_async_commit();
    }
    const float* tK = stage_k(it & 1);
    const float* tV = stage_v(it & 1);
    const int k0 = it * BN;

    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    rows_by_rows<D, 8>(s, sQ + warp * 16 * P, tK, g, t);

    // Scale, and mask in the fragment where the tile needs it (a uniform
    // branch); the rows' max, then P and its sums.
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] *= scale;
    if ((causal && k0 + BN > q0) || k0 + BN > T_len) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + nb * 8 + 2 * t + (e & 1);
          if (causal && col > row) s[nb][e] = kNegInf;
          if (col >= T_len) s[nb][e] = -INFINITY;  // ragged edge: no weight
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nb][e] - (e < 2 ? mn0 : mn1));
        s[nb][e] = p;
        if (e < 2)
          ps0 += p;
        else
          ps1 += p;
      }
    l0 = l0 * c0 + quad_sum(ps0);
    l1 = l1 * c1 + quad_sum(ps1);
    m0 = mn0;
    m1 = mn1;
    if constexpr (WALK) {  // the running O rescaled before P·V joins it
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][0] *= c0;
        acc[dn][1] *= c0;
        acc[dn][2] *= c1;
        acc[dn][3] *= c1;
      }
    }

    if (next)
      cp_async_wait<2>();  // this tile's V; the next tile's K and V fly on
    else
      cp_async_wait<0>();
    __syncthreads();
    frag_by_rows<D, 8>(sum, s, tV, g, t);
    if constexpr (PART) add_tile<D>(acc, part);
  }

  const long long rb = bh / H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row >= T_len) continue;
    const float l = half ? l1 : l0;
    const float l_safe = l > 0.f ? l : 1.f;
    store_rows<D>(o + ((rb * T_len + row) * H + hd.h) * D, acc, half,
                  1.f / l_safe, t);
    if (t == 0)
      lse[static_cast<long long>(bh) * T_len + row] =
          (half ? m1 : m0) + logf(l_safe);
  }
}

template <int D, bool WALK>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, const Strides& sq, const Strides& sk,
                   const Strides& sv, int R, int B, int T_len, int H,
                   int causal, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D, WALK>();
  auto kernel = flash_fwd_tf32_kernel<D, WALK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(R * B * H, (T_len + BM - 1) / BM);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, sq, sk, sv, B, H,
                                           T_len, scale, causal);
  return cudaSuccess;
}

// One tile a head (T <= 64) or a walk over several.
template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, const Strides& sq, const Strides& sk,
                   const Strides& sv, int R, int B, int T_len, int H,
                   int causal, cudaStream_t stream) {
  return T_len > BM ? launch<D, true>(q, k, v, o, lse, sq, sk, sv, R, B,
                                      T_len, H, causal, stream)
                    : launch<D, false>(q, k, v, o, lse, sq, sk, sv, R, B,
                                       T_len, H, causal, stream);
}

}  // namespace

// Launches on `stream`; returns the error of the set-up calls (the launch
// itself is checked by the caller with cudaGetLastError). Strides are
// (r, b, t, h) of [R, B, T, H, D] f32 operands. bf16 operands go to
// flash_fwd_sm90.cu instead.
cudaError_t flash_fwd_launch(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* sq,
                             const long long* sk, const long long* sv, int R,
                             int B, int T_len, int H, int D, bool causal,
                             cudaStream_t stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  switch (D) {
    case 16:
      return launch<16>(qf, kf, vf, of, lse, strides(sq), strides(sk),
                        strides(sv), R, B, T_len, H, causal, stream);
    case 32:
      return launch<32>(qf, kf, vf, of, lse, strides(sq), strides(sk),
                        strides(sv), R, B, T_len, H, causal, stream);
    case 64:
      return launch<64>(qf, kf, vf, of, lse, strides(sq), strides(sk),
                        strides(sv), R, B, T_len, H, causal, stream);
    case 128:
      return launch<128>(qf, kf, vf, of, lse, strides(sq), strides(sk),
                         strides(sv), R, B, T_len, H, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fedml_tpu_torch
