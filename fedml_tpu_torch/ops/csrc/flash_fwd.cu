// Flash-attention forward for Hopper (sm_90a): causal or full softmax
// attention with an online softmax; writes O and the row log-sum-exp.
//
// Replaces fedml_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel reached through _fwd). Same arithmetic: S = (Q·Kᵀ)·scale with
// scale = 1/√D, causal mask NEG_INF = -1e30, a running row max m and sum l
// in f32, P rounded to the input type before P·V (the TPU kernel's
// p.astype(v.dtype)), l = 0 rows guarded, lse = m + log(l). The TPU's
// 8-row replication of lse is dropped: lse is [B, H, T].
//
// What bounds it on an H100: at the serving shape (T = 2048, D = 64) the
// work is ~2·B·H·T²·D operations against ~4·B·T·H·D·2 bytes, far above the
// card's ~295 operations per byte, so it is bound by operations. This first
// version computes on the FP32 pipes with FMA (no tensor cores), so its
// ceiling is the 67 TFLOP/s FP32 rate, not the 989 TFLOP/s bf16 tensor-core
// rate; moving the two products to wgmma is later work. The design keeps
// the [T, T] score matrix out of device memory (one 64 × 64 tile in shared
// memory at a time) and register-blocks each thread on a 4 × 4 tile of S
// and a 4 × D/16 tile of O, so each shared-memory load feeds 2 FMAs.
//
// Design: one thread block per (batch·head, 64-row Q tile), 256 threads as
// 16 row groups × 16 column groups. A loop inside the block walks the K/V
// tiles (64 rows each) through shared memory; with causal masking it stops
// at the tile holding the block's last row, so tiles wholly above the
// diagonal are never read. Q, K, V are read through their [B, T, H, D]
// strides (innermost dim contiguous), so the caller's views of one qkv
// buffer need no copy. Rows and keys past T are masked in the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fedml_tpu_torch {
namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 64;   // key rows per tile
constexpr int NT = 256;  // threads: 16 row groups x 16 column groups
constexpr int LDP = BN + 16;  // P row pitch: two row groups hit disjoint banks
constexpr float kNegInf = -1e30f;

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

// Sum / max over the 16 lanes of one row group (lane bits 0-3 are the
// column group).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Strides {
  long long b, t, h;
};

template <int D>
constexpr int smem_floats() {
  return BM * (D + 1) + BN * (D + 1) + BN * D + BM * LDP;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, int H, int T_len, float scale, int causal) {
  constexpr int LDQ = D + 1;  // odd pitch: 16 rows at one column, 16 banks
  constexpr int LDK = D + 1;
  constexpr int DJ = D / 16;  // O columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BM * LDQ;
  float* sV = sK + BN * LDK;
  float* sP = sV + BN * D;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr + 16 i
  const int tc = tid & 15;  // S columns tc + 16 j, O columns tc + 16 j

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, d = idx - (idx / D) * D;
    const int row = q0 + r;
    sQ[r * LDQ + d] = row < T_len ? to_float(qb[row * sq.t + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(T_len, q0 + BM) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BN * D; idx += NT) {
      const int r = idx / D, d = idx - (idx / D) * D;
      const int row = k0 + r;
      const bool in = row < T_len;
      sK[r * LDK + d] = in ? to_float(kb[row * sk.t + d]) : 0.f;
      sV[r * D + d] = in ? to_float(vb[row * sv.t + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tc + 16 * j) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
      float mb = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (causal && col > row) x = kNegInf;
        if (col >= T_len) x = -INFINITY;  // ragged edge: no weight at all
        s[i][j] = x;
        mb = fmaxf(mb, x);
      }
      mb = group_max(mb);
      const float m_new = fmaxf(m[i], mb);
      const float c = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        sP[(tr + 16 * i) * LDP + tc + 16 * j] = to_float(from_float<T>(p));
      }
      ps = group_sum(ps);
      l[i] = l[i] * c + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= c;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(tr + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * D + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= T_len) continue;
    const float l_safe = l[i] > 0.f ? l[i] : 1.f;
    T* orow = o + ((static_cast<long long>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tc + 16 * j] = from_float<T>(acc[i][j] / l_safe);
    if (tc == 0)
      lse[static_cast<long long>(bh) * T_len + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* sq, const long long* sk,
                   const long long* sv, int B, int T_len, int H, int causal,
                   cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T_len + BM - 1) / BM, B * H);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse,
      Strides{sq[0], sq[1], sq[2]}, Strides{sk[0], sk[1], sk[2]},
      Strides{sv[0], sv[1], sv[2]}, H, T_len, scale, causal);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o,
                         float* lse, const long long* sq, const long long* sk,
                         const long long* sv, int B, int T_len, int H, int D,
                         int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, sq, sk, sv, B, T_len, H, causal,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, sq, sk, sv, B, T_len, H, causal,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, sq, sk, sv, B, T_len, H, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, sq, sk, sv, B, T_len, H, causal,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream`; returns the error of the set-up calls (the launch
// itself is checked by the caller with cudaGetLastError).
cudaError_t flash_fwd_launch(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* sq,
                             const long long* sk, const long long* sv, int B,
                             int T_len, int H, int D, bool is_bf16,
                             bool causal, cudaStream_t stream) {
  if (is_bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, o, lse, sq, sk, sv, B, T_len,
                                       H, D, causal, stream);
  return launch_dtype<float>(q, k, v, o, lse, sq, sk, sv, B, T_len, H, D,
                             causal, stream);
}

}  // namespace fedml_tpu_torch
