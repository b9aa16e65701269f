// GroupNorm forward, backward and dγ/dβ reduce for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fedml_tpu/ops/group_norm.py:
// _fwd_kernel (:102, launched by _fwd :152) and _bwd_kernel (:115, launched
// by _bwd :169). Same functions: per sample and group, f32 statistics with
// var = max(E[x²] − μ², 0); y = (x − μ)·rsqrt(var + eps)·γ + β rounded once
// to x's type; dx = rstd·(dxhat − mean_g(dxhat) − xhat·mean_g(dxhat·xhat))
// with dxhat = dy·γ; dγ = Σ dy·xhat and dβ = Σ dy over samples and positions.
//
// Layout: x [R, M, S, C] — R rows of γ/β (clients under vmap), M samples per
// row, S positions, C channels at stride 1; R, M and S at any stride, so the
// strided views a vmapped conv hands over are read in place. One block owns
// one sample (blockIdx.x = r·M + m). Threads read 16-byte vectors of V
// channels, neighbouring threads on neighbouring addresses; each thread keeps
// a fixed channel slot and walks rows, so its per-channel sums stay in
// registers and are combined in shared memory in a fixed order.
//
// Bound: bytes. Per element the forward does ~8 flops against 4 bytes (bf16
// read + write), the backward ~20 against 6: far below the card's
// flops-per-byte balance. The least traffic is one read and one write of x
// forward, and two reads (x, dy) and one write (dx) backward. This first
// design leaves on the table: the forward reads x twice (statistics, then
// normalize), and the backward makes three passes (statistics; Σdy and
// Σdy·xhat; dx), reading x three times and dy twice. A sample is at most a
// few hundred KB, so the re-reads mostly hit L2. Folding the statistics pass
// into the second (Σdy·x instead of Σdy·xhat) would save one backward pass.
//
// The TPU kernel carries dγ/dβ across its sequential grid in VMEM scratch.
// CUDA blocks run in no order, so the backward writes f32 per-sample partials
// [R·M, C] and gn_reduce_kernel sums each row's M partials in index order.
// No atomics anywhere: a rerun gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fedml_tpu_torch {
namespace {

constexpr int kThreads = 256;

struct GnShape {
  int R, M, S, C, G;
  float eps;
};

struct Strides {  // element strides of the R, M and S dims; C is at stride 1
  long long r, m, s;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_float(pk.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int k = 0; k < V; ++k) from_float(in[k], &pk.v[k]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// Two per-channel sums over the S rows of one sample: `body(s, c, a, b)`
// adds row s's contribution for channels c..c+V-1 into a[] and b[]. Results
// land in out_a[C] and out_b[C] (shared memory). `part` holds
// 2·kThreads·V floats. Ends with a barrier.
template <int V, typename Body>
__device__ void channel_sums(int S, int C, Body body, float* out_a,
                             float* out_b, float* part) {
  const int t = threadIdx.x;
  const int slots = C / V;
  float* part_a = part;
  float* part_b = part + kThreads * V;
  for (int base = 0; base < slots; base += kThreads) {
    const int here = min(kThreads, slots - base);
    const int rows = kThreads / here;  // row groups walking S in step
    float a[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
    if (t < rows * here) {
      const int c = (base + t % here) * V;
#pragma unroll 4
      for (int s = t / here; s < S; s += rows) body(s, c, a, b);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        part_a[t * V + k] = a[k];
        part_b[t * V + k] = b[k];
      }
    }
    __syncthreads();
    // Thread t = row·here + slot wrote part[(row·here + slot)·V + k]: channel
    // j = slot·V + k of this chunk sits at part[row·here·V + j].
    const int width = here * V;
    for (int j = t; j < width; j += kThreads) {
      float sa = 0.f, sb = 0.f;
      for (int row = 0; row < rows; ++row) {
        sa += part_a[row * width + j];
        sb += part_b[row * width + j];
      }
      out_a[base * V + j] = sa;
      out_b[base * V + j] = sb;
    }
    __syncthreads();
  }
}

// Per-group mean and rstd from per-channel Σx and Σx², written back per
// channel into mu[C] and rstd[C]. Ends with a barrier.
__device__ void group_stats(const GnShape& g, const float* sum,
                            const float* sumsq, float* mu, float* rstd) {
  const int cpg = g.C / g.G;
  const float denom = static_cast<float>(g.S) * static_cast<float>(cpg);
  for (int grp = threadIdx.x; grp < g.G; grp += kThreads) {
    float s = 0.f, sq = 0.f;
    for (int c = grp * cpg; c < (grp + 1) * cpg; ++c) {
      s += sum[c];
      sq += sumsq[c];
    }
    const float m = s / denom;
    const float var = fmaxf(sq / denom - m * m, 0.f);
    const float r = rsqrtf(var + g.eps);
    for (int c = grp * cpg; c < (grp + 1) * cpg; ++c) {
      mu[c] = m;
      rstd[c] = r;
    }
  }
  __syncthreads();
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gn_fwd_kernel(GnShape g, Strides sx, Strides sy,
                  const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y) {
  extern __shared__ float smem[];
  float* part = smem;
  float* c0 = part + 2 * kThreads * V;
  float* c1 = c0 + g.C;
  float* mu = c1 + g.C;
  float* rstd = mu + g.C;

  const int n = blockIdx.x;
  const int r = n / g.M, m = n - r * g.M;
  const T* xs = x + r * sx.r + m * sx.m;
  T* ys = y + r * sy.r + m * sy.m;

  channel_sums<V>(
      g.S, g.C,
      [&](int s, int c, float(&a)[V], float(&b)[V]) {
        float v[V];
        load<T, V>(xs + s * sx.s + c, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[k] += v[k];
          b[k] += v[k] * v[k];
        }
      },
      c0, c1, part);
  group_stats(g, c0, c1, mu, rstd);
  for (int c = threadIdx.x; c < g.C; c += kThreads) {
    c0[c] = gamma[r * g.C + c];
    c1[c] = beta[r * g.C + c];
  }
  __syncthreads();

  const int slots = g.C / V;
  const int total = g.S * slots;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int s = e / slots;
    const int c = (e - s * slots) * V;
    float v[V];
    load<T, V>(xs + s * sx.s + c, v);
#pragma unroll
    for (int k = 0; k < V; ++k)
      v[k] = ((v[k] - mu[c + k]) * rstd[c + k]) * c0[c + k] + c1[c + k];
    store<T, V>(ys + s * sy.s + c, v);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_kernel(GnShape g, Strides sx, Strides sdy, Strides sdx,
                  const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, T* __restrict__ dx,
                  float* __restrict__ part_g, float* __restrict__ part_b) {
  extern __shared__ float smem[];
  float* part = smem;
  float* c0 = part + 2 * kThreads * V;
  float* c1 = c0 + g.C;
  float* mu = c1 + g.C;
  float* rstd = mu + g.C;
  float* gam = rstd + g.C;
  float* k0 = gam + g.C;  // per channel: mean_g(dxhat)
  float* k1 = k0 + g.C;   // per channel: mean_g(dxhat·xhat)

  const int n = blockIdx.x;
  const int r = n / g.M, m = n - r * g.M;
  const T* xs = x + r * sx.r + m * sx.m;
  const T* dys = dy + r * sdy.r + m * sdy.m;
  T* dxs = dx + r * sdx.r + m * sdx.m;

  // Pass 1: the statistics, as in the forward.
  channel_sums<V>(
      g.S, g.C,
      [&](int s, int c, float(&a)[V], float(&b)[V]) {
        float v[V];
        load<T, V>(xs + s * sx.s + c, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[k] += v[k];
          b[k] += v[k] * v[k];
        }
      },
      c0, c1, part);
  group_stats(g, c0, c1, mu, rstd);
  for (int c = threadIdx.x; c < g.C; c += kThreads) gam[c] = gamma[r * g.C + c];

  // Pass 2: per channel Σdy and Σdy·xhat (this sample's dβ and dγ).
  channel_sums<V>(
      g.S, g.C,
      [&](int s, int c, float(&a)[V], float(&b)[V]) {
        float v[V], d[V];
        load<T, V>(xs + s * sx.s + c, v);
        load<T, V>(dys + s * sdy.s + c, d);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[k] += d[k];
          b[k] += d[k] * ((v[k] - mu[c + k]) * rstd[c + k]);
        }
      },
      c0, c1, part);
  for (int c = threadIdx.x; c < g.C; c += kThreads) {
    part_b[static_cast<long long>(n) * g.C + c] = c0[c];
    part_g[static_cast<long long>(n) * g.C + c] = c1[c];
  }
  // Group means of dxhat = dy·γ and dxhat·xhat, per channel.
  const int cpg = g.C / g.G;
  const float denom = static_cast<float>(g.S) * static_cast<float>(cpg);
  for (int grp = threadIdx.x; grp < g.G; grp += kThreads) {
    float s0 = 0.f, s1 = 0.f;
    for (int c = grp * cpg; c < (grp + 1) * cpg; ++c) {
      s0 += gam[c] * c0[c];
      s1 += gam[c] * c1[c];
    }
    for (int c = grp * cpg; c < (grp + 1) * cpg; ++c) {
      k0[c] = s0 / denom;
      k1[c] = s1 / denom;
    }
  }
  __syncthreads();

  // Pass 3: dx.
  const int slots = g.C / V;
  const int total = g.S * slots;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int s = e / slots;
    const int c = (e - s * slots) * V;
    float v[V], d[V];
    load<T, V>(xs + s * sx.s + c, v);
    load<T, V>(dys + s * sdy.s + c, d);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xhat = (v[k] - mu[c + k]) * rstd[c + k];
      v[k] = rstd[c + k] * (d[k] * gam[c + k] - k0[c + k] - xhat * k1[c + k]);
    }
    store<T, V>(dxs + s * sdx.s + c, v);
  }
}

// dγ[r, c] = Σ_m part_g[r·M + m, c] (and dβ alike), m in index order.
__global__ void gn_reduce_kernel(int R, int M, int C,
                                 const float* __restrict__ part_g,
                                 const float* __restrict__ part_b,
                                 float* __restrict__ dgamma,
                                 float* __restrict__ dbeta) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(R) * C) return;
  const long long r = idx / C, c = idx - r * C;
  float sg = 0.f, sb = 0.f;
  for (int m = 0; m < M; ++m) {
    const long long off = (r * M + m) * C + c;
    sg += part_g[off];
    sb += part_b[off];
  }
  dgamma[idx] = sg;
  dbeta[idx] = sb;
}

size_t smem_bytes(int V, int C, int per_channel_arrays) {
  return sizeof(float) *
         (2 * static_cast<size_t>(kThreads) * V +
          static_cast<size_t>(per_channel_arrays) * C);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int V>
cudaError_t fwd_v(const GnShape& g, const Strides& sx, const Strides& sy,
                  const void* x, const float* gamma, const float* beta,
                  void* y, cudaStream_t stream) {
  const size_t bytes = smem_bytes(V, g.C, 4);
  cudaError_t err = allow_smem(gn_fwd_kernel<T, V>, bytes);
  if (err != cudaSuccess) return err;
  gn_fwd_kernel<T, V><<<g.R * g.M, kThreads, bytes, stream>>>(
      g, sx, sy, static_cast<const T*>(x), gamma, beta, static_cast<T*>(y));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t bwd_v(const GnShape& g, const Strides& sx, const Strides& sdy,
                  const Strides& sdx, const void* x, const void* dy,
                  const float* gamma, void* dx, float* part_g, float* part_b,
                  cudaStream_t stream) {
  const size_t bytes = smem_bytes(V, g.C, 7);
  cudaError_t err = allow_smem(gn_bwd_kernel<T, V>, bytes);
  if (err != cudaSuccess) return err;
  gn_bwd_kernel<T, V><<<g.R * g.M, kThreads, bytes, stream>>>(
      g, sx, sdy, sdx, static_cast<const T*>(x), static_cast<const T*>(dy),
      gamma, static_cast<T*>(dx), part_g, part_b);
  return cudaGetLastError();
}

}  // namespace

// The widest vector (in elements, at most 16 bytes) that divides C and every
// stride, and to which every base pointer is aligned.
int gn_vector_width(int C, int elem_bytes, const long long* strides,
                    int n_strides, const void* const* ptrs, int n_ptrs) {
  for (int v = 16 / elem_bytes; v > 1; v /= 2) {
    bool ok = C % v == 0;
    for (int i = 0; ok && i < n_strides; ++i) ok = strides[i] % v == 0;
    for (int i = 0; ok && i < n_ptrs; ++i)
      ok = reinterpret_cast<uintptr_t>(ptrs[i]) % (v * elem_bytes) == 0;
    if (ok) return v;
  }
  return 1;
}

cudaError_t group_norm_fwd_launch(int R, int M, int S, int C, int G,
                                  float eps, const long long* sx,
                                  const long long* sy, const void* x,
                                  const float* gamma, const float* beta,
                                  void* y, bool is_bf16,
                                  cudaStream_t stream) {
  const GnShape g{R, M, S, C, G, eps};
  const Strides tx{sx[0], sx[1], sx[2]}, ty{sy[0], sy[1], sy[2]};
  const long long strides[6] = {sx[0], sx[1], sx[2], sy[0], sy[1], sy[2]};
  const void* ptrs[2] = {x, y};
  const int v = gn_vector_width(C, is_bf16 ? 2 : 4, strides, 6, ptrs, 2);
  if (is_bf16) {
    switch (v) {
      case 8: return fwd_v<__nv_bfloat16, 8>(g, tx, ty, x, gamma, beta, y, stream);
      case 4: return fwd_v<__nv_bfloat16, 4>(g, tx, ty, x, gamma, beta, y, stream);
      case 2: return fwd_v<__nv_bfloat16, 2>(g, tx, ty, x, gamma, beta, y, stream);
      default: return fwd_v<__nv_bfloat16, 1>(g, tx, ty, x, gamma, beta, y, stream);
    }
  }
  switch (v) {
    case 4: return fwd_v<float, 4>(g, tx, ty, x, gamma, beta, y, stream);
    case 2: return fwd_v<float, 2>(g, tx, ty, x, gamma, beta, y, stream);
    default: return fwd_v<float, 1>(g, tx, ty, x, gamma, beta, y, stream);
  }
}

cudaError_t group_norm_bwd_launch(int R, int M, int S, int C, int G,
                                  float eps, const long long* sx,
                                  const long long* sdy, const long long* sdx,
                                  const void* x, const void* dy,
                                  const float* gamma, void* dx,
                                  float* part_g, float* part_b, bool is_bf16,
                                  cudaStream_t stream) {
  const GnShape g{R, M, S, C, G, eps};
  const Strides tx{sx[0], sx[1], sx[2]}, tdy{sdy[0], sdy[1], sdy[2]},
      tdx{sdx[0], sdx[1], sdx[2]};
  const long long strides[9] = {sx[0],  sx[1],  sx[2],  sdy[0], sdy[1],
                                sdy[2], sdx[0], sdx[1], sdx[2]};
  const void* ptrs[3] = {x, dy, dx};
  const int v = gn_vector_width(C, is_bf16 ? 2 : 4, strides, 9, ptrs, 3);
#define FEDML_GN_BWD(T, V)                                                  \
  return bwd_v<T, V>(g, tx, tdy, tdx, x, dy, gamma, dx, part_g, part_b,  \
                     stream)
  if (is_bf16) {
    switch (v) {
      case 8: FEDML_GN_BWD(__nv_bfloat16, 8);
      case 4: FEDML_GN_BWD(__nv_bfloat16, 4);
      case 2: FEDML_GN_BWD(__nv_bfloat16, 2);
      default: FEDML_GN_BWD(__nv_bfloat16, 1);
    }
  }
  switch (v) {
    case 4: FEDML_GN_BWD(float, 4);
    case 2: FEDML_GN_BWD(float, 2);
    default: FEDML_GN_BWD(float, 1);
  }
#undef FEDML_GN_BWD
}

cudaError_t group_norm_reduce_launch(int R, int M, int C,
                                     const float* part_g,
                                     const float* part_b, float* dgamma,
                                     float* dbeta, cudaStream_t stream) {
  const long long n = static_cast<long long>(R) * C;
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  gn_reduce_kernel<<<blocks, kThreads, 0, stream>>>(R, M, C, part_g, part_b,
                                                    dgamma, dbeta);
  return cudaGetLastError();
}

}  // namespace fedml_tpu_torch
