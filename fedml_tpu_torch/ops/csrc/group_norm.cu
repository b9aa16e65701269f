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
// strided views a vmapped conv hands over are read in place. Threads read
// 16-byte vectors of V channels, neighbouring threads on neighbouring
// addresses; each thread keeps a fixed channel slot and walks rows, so its
// per-channel sums stay in registers and are combined in shared memory in a
// fixed order.
//
// Bound: bytes. Per element the forward does ~8 flops against 4 bytes (bf16
// read + write), the backward ~20 against 6: far below the card's
// flops-per-byte balance. The least traffic is one read and one write of x
// forward, and two reads (x, dy) and one write (dx) backward.
//
// Both kernels hold each sample in the shared memory of a thread-block
// cluster, as the TPU kernel holds a block of samples in VMEM, so x (and dy)
// are read from device memory once. A sample is up to 128 KB of x at the
// main path's shapes (bf16 [1024, 64]), more than one block should hold, and
// one block per sample would put only 256 blocks on 132 SMs, too few loads
// in flight to approach the card's 3.35 TB/s. So a cluster of CL blocks of
// 128 threads (CL 1 to 8, chosen per shape by plan_cluster so that a block
// holds ~32 KB of the sample's resident tensors) shares one sample: block q
// copies rows [q·S/CL, (q+1)·S/CL) into its shared memory with cp.async, and
// the blocks exchange per-channel partial sums through distributed shared
// memory, each summing the CL partials in rank order, so every block holds
// the same totals. No atomics anywhere: a rerun gives the same bits.
//
// Forward (gn_fwd_kernel): one tensor resident. Σx and Σx² per channel from
// shared memory, one exchange, the group statistics, then y from shared
// memory with 16-byte stores. At the main shape that is 1024 blocks of 32 KB,
// clusters of 4. A sample whose x does not fit in a cluster of 8 takes the
// streamed route (gn_fwd_streamed_kernel: one 256-thread block per sample,
// statistics then normalize, reading x twice), chosen by shape before the
// launch and reported to the caller, who counts it.
//
// Backward (gn_bwd_kernel): x and dy resident, three passes over shared
// memory (statistics; Σdy and Σdy·xhat; dx) and two exchanges; dy's copy
// lands while the statistics are summed. At the main shape that is 2048
// blocks of 32 KB, five to an SM. A sample whose x and dy do not both fit in
// a cluster of 8 keeps x in shared memory and reads dy twice; one whose x
// alone does not fit takes the streamed route (gn_bwd_streamed_kernel: one
// 256-thread block per sample and the same three passes over device memory,
// reading x three times and dy twice), chosen by shape before the launch and
// reported to the caller, as the forward's is. The formulas stay the TPU
// kernel's on both routes: Σdy·xhat with xhat formed from the statistics,
// not Σdy·x − μΣdy, which cancels.
//
// The TPU kernel carries dγ/dβ across its sequential grid in VMEM scratch.
// CUDA blocks run in no order, so the backward writes f32 per-sample partials
// [R·M, C] and gn_reduce_kernel sums each row's M partials in index order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fedml_tpu_torch {
namespace {

namespace cg = cooperative_groups;

// The streamed forward's and the reduce's blocks.
constexpr int kThreads = 256;
// The cluster-resident kernels' blocks: 128 threads, and a cluster of at most
// the portable 8 blocks per sample, each aiming to hold this many bytes of
// the sample's resident tensors.
constexpr int kClusterThreads = 128;
constexpr int kMaxCluster = 8;
constexpr size_t kTargetBytes = 32 * 1024;

// Offset, in floats, of the resident rows in a cluster kernel's shared
// memory: after the row-group partials [2][kClusterThreads·V] and nine
// per-channel arrays, rounded up to 16 bytes.
__host__ __device__ constexpr int resident_offset(int C, int V) {
  return (2 * kClusterThreads * V + 9 * C + 3) & ~3;
}

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

// Two per-channel sums over the S rows of one sample: `make_row(c)`, called
// once for the thread's channels c..c+V-1, returns `row(s, a, b)`, which adds
// row s's contribution for those channels into a[] and b[]. Results land in
// out_a[C] and out_b[C] (shared memory). `part` holds 2·NT·V floats, for
// NT threads. Ends with a barrier.
template <int NT, int V, typename MakeRow>
__device__ void channel_sums(int S, int C, MakeRow make_row, float* out_a,
                             float* out_b, float* part) {
  const int t = threadIdx.x;
  const int slots = C / V;
  float* part_a = part;
  float* part_b = part + NT * V;
  for (int base = 0; base < slots; base += NT) {
    const int here = min(NT, slots - base);
    const int rows = NT / here;  // row groups walking S in step
    float a[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
    if (t < rows * here) {
      const int c = (base + t % here) * V;
      auto row = make_row(c);
#pragma unroll 4
      for (int s = t / here; s < S; s += rows) row(s, a, b);
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
    for (int j = t; j < width; j += NT) {
      float sa = 0.f, sb = 0.f;
#pragma unroll 8
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
  for (int grp = threadIdx.x; grp < g.G; grp += blockDim.x) {
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

// make_row for channel_sums: Σx and Σx² of the rows at `xs`, `stride`
// elements apart.
template <typename T, int V>
__device__ __forceinline__ auto sum_and_squares(const T* xs,
                                                long long stride) {
  return [=](int c) {
    return [=](int s, float(&a)[V], float(&b)[V]) {
      float v[V];
      load<T, V>(xs + s * stride + c, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] += v[k];
        b[k] += v[k] * v[k];
      }
    };
  };
}

// The streamed route: one block per sample (blockIdx.x = r·M + m), two
// passes over device memory (statistics, then normalize), for a sample too
// large for a cluster's shared memory.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gn_fwd_streamed_kernel(GnShape g, Strides sx, Strides sy,
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

  channel_sums<kThreads, V>(g.S, g.C, sum_and_squares<T, V>(xs, sx.s), c0,
                            c1, part);
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

// Σdy and Σdy·xhat per channel for channel_sums, over the rows of one
// sample at `xs` and `dys`, with the statistics mu[C] and rstd[C].
template <typename T, int V>
__device__ __forceinline__ auto dy_sums(const T* xs, long long x_stride,
                                        const T* dys, long long dy_stride,
                                        const float* mu, const float* rstd) {
  return [=](int c) {
    float mk[V], rk[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mk[k] = mu[c + k];
      rk[k] = rstd[c + k];
    }
    return [=](int s, float(&a)[V], float(&b)[V]) {
      float v[V], d[V];
      load<T, V>(xs + s * x_stride + c, v);
      load<T, V>(dys + s * dy_stride + c, d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] += d[k];
        b[k] += d[k] * ((v[k] - mk[k]) * rk[k]);
      }
    };
  };
}

// Group means of dxhat = dy·γ and dxhat·xhat from per-channel Σdy (k0) and
// Σdy·xhat (k1), written back per channel in place: k0 = mean_g(dxhat),
// k1 = mean_g(dxhat·xhat). Ends with a barrier.
__device__ void dy_group_means(const GnShape& g, const float* gam, float* k0,
                               float* k1) {
  const int cpg = g.C / g.G;
  const float denom = static_cast<float>(g.S) * static_cast<float>(cpg);
  for (int grp = threadIdx.x; grp < g.G; grp += blockDim.x) {
    float s0 = 0.f, s1 = 0.f;
    for (int c = grp * cpg; c < (grp + 1) * cpg; ++c) {
      s0 += gam[c] * k0[c];
      s1 += gam[c] * k1[c];
    }
    for (int c = grp * cpg; c < (grp + 1) * cpg; ++c) {
      k0[c] = s0 / denom;
      k1[c] = s1 / denom;
    }
  }
  __syncthreads();
}

// The backward's streamed route: one block per sample (blockIdx.x = r·M +
// m) and three passes over device memory (the statistics from x; Σdy and
// Σdy·xhat from x and dy; dx), for a sample whose x is more than a
// cluster's shared memory holds. The per-sample partials of dγ and dβ go to
// part_g/part_b [R·M, C], as on the cluster route.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    gn_bwd_streamed_kernel(GnShape g, Strides sx, Strides sdy, Strides sdx,
                           const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ gamma,
                           T* __restrict__ dx, float* __restrict__ part_g,
                           float* __restrict__ part_b) {
  extern __shared__ float smem[];
  float* part = smem;
  float* c0 = part + 2 * kThreads * V;
  float* c1 = c0 + g.C;
  float* mu = c1 + g.C;
  float* rstd = mu + g.C;
  float* gam = rstd + g.C;

  const int n = blockIdx.x;
  const int r = n / g.M, m = n - r * g.M;
  const T* xs = x + r * sx.r + m * sx.m;
  const T* dys = dy + r * sdy.r + m * sdy.m;
  T* dxs = dx + r * sdx.r + m * sdx.m;

  // Pass 1: the statistics.
  channel_sums<kThreads, V>(g.S, g.C, sum_and_squares<T, V>(xs, sx.s), c0,
                            c1, part);
  group_stats(g, c0, c1, mu, rstd);
  for (int c = threadIdx.x; c < g.C; c += kThreads) gam[c] = gamma[r * g.C + c];

  // Pass 2: Σdy and Σdy·xhat per channel (this sample's dβ and dγ).
  channel_sums<kThreads, V>(
      g.S, g.C, dy_sums<T, V>(xs, sx.s, dys, sdy.s, mu, rstd), c0, c1, part);
  for (int c = threadIdx.x; c < g.C; c += kThreads) {
    part_b[static_cast<long long>(n) * g.C + c] = c0[c];
    part_g[static_cast<long long>(n) * g.C + c] = c1[c];
  }
  __syncthreads();
  dy_group_means(g, gam, c0, c1);

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
      v[k] = rstd[c + k] * (d[k] * gam[c + k] - c0[c + k] - xhat * c1[c + k]);
    }
    store<T, V>(dxs + s * sdx.s + c, v);
  }
}

// V elements from global to shared memory without passing through
// registers (cp.async), or by a plain copy below 4 bytes.
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const size_t g = __cvta_generic_to_global(src);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(g)
                 : "memory");
  } else if constexpr (BYTES >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(g), "n"(BYTES)
                 : "memory");
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n_rows) of one sample's slice (`src`, `stride` elements between
// rows) into dst[n_rows][C].
template <typename T, int V>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          long long stride, int n_rows,
                                          int C) {
  const int slots = C / V;
  const int n = n_rows * slots;
  for (int e = threadIdx.x; e < n; e += kClusterThreads) {
    const int s = e / slots, c = (e - s * slots) * V;
    copy_async<static_cast<int>(V * sizeof(T))>(dst + s * C + c,
                                                src + s * stride + c);
  }
}

// The sample's totals of the cluster's per-channel partials: ex[2·C] of
// every block of the cluster, summed in rank order into tot[2·C] (the same
// bits in every block). Ends with a barrier.
__device__ void cluster_totals(cg::cluster_group& cluster, float* ex,
                               float* tot, int C) {
  cluster.sync();  // every block's ex is written
  const int cl = static_cast<int>(cluster.num_blocks());
  for (int c = threadIdx.x; c < 2 * C; c += kClusterThreads) {
    float vals[kMaxCluster];  // all loads in flight before the sum
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      vals[q] = q < cl ? cluster.map_shared_rank(ex, q)[c] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < cl) s += vals[q];
    tot[c] = s;
  }
  __syncthreads();
}

// The cluster barrier in two halves (barrier.cluster, default release and
// acquire): a block arrives once it has read the others' shared memory and
// waits before it exits, so that no block's shared memory goes while
// another still reads it, and no block waits on the slowest in between.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One block of a cluster of CL per sample (blockIdx.x = (r·M + m)·CL + q):
// rows [q·rows_per_block, (q + 1)·rows_per_block) of x in shared memory (see
// the note at the top).
template <typename T, int V>
__global__ void __launch_bounds__(kClusterThreads, 6)
    gn_fwd_kernel(GnShape g, Strides sx, Strides sy,
                  const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  int rows_per_block) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / static_cast<int>(cluster.num_blocks());
  const int r = n / g.M, m = n - r * g.M;
  const int C = g.C;
  const int s0 = q * rows_per_block;
  const int n_rows = max(0, min(g.S - s0, rows_per_block));
  const T* xs = x + r * sx.r + m * sx.m + s0 * sx.s;
  T* ys = y + r * sy.r + m * sy.m + s0 * sy.s;

  extern __shared__ __align__(16) float fwd_smem[];
  float* part = fwd_smem;  // [2][kClusterThreads·V] row-group partials
  float* ex = part + 2 * kClusterThreads * V;  // this block's Σx, Σx² [2][C]
  float* tot = ex + 2 * C;  // the sample's totals [2][C]
  float* mu = tot + 2 * C;
  float* rstd = mu + C;
  float* gam = rstd + C;
  float* bet = gam + C;
  T* sx_ = reinterpret_cast<T*>(fwd_smem + resident_offset(C, V));

  // x's slice as one group of asynchronous copies; γ and β while it lands.
  copy_rows<T, V>(sx_, xs, sx.s, n_rows, C);
  copy_async_commit();
  for (int c = threadIdx.x; c < C; c += kClusterThreads) {
    gam[c] = gamma[r * C + c];
    bet[c] = beta[r * C + c];
  }
  copy_async_wait<0>();
  __syncthreads();

  // The statistics, over the cluster.
  channel_sums<kClusterThreads, V>(n_rows, C, sum_and_squares<T, V>(sx_, C),
                                   ex, ex + C, part);
  cluster_totals(cluster, ex, tot, C);
  cluster_arrive();
  group_stats(g, tot, tot + C, mu, rstd);

  // y from shared memory, each thread on a fixed channel slot with that
  // slot's constants in registers.
  const int slots = C / V;
  const int t = threadIdx.x;
  for (int base = 0; base < slots; base += kClusterThreads) {
    const int here = min(kClusterThreads, slots - base);
    const int rows = kClusterThreads / here;
    if (t >= rows * here) continue;
    const int c = (base + t % here) * V;
    float mk[V], rk[V], gk[V], bk[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mk[k] = mu[c + k];
      rk[k] = rstd[c + k];
      gk[k] = gam[c + k];
      bk[k] = bet[c + k];
    }
#pragma unroll 2
    for (int s = t / here; s < n_rows; s += rows) {
      float v[V];
      load<T, V>(sx_ + s * C + c, v);
#pragma unroll
      for (int k = 0; k < V; ++k)
        v[k] = ((v[k] - mk[k]) * rk[k]) * gk[k] + bk[k];
      store<T, V>(ys + s * sy.s + c, v);
    }
  }
  cluster_wait();
}

// One block of a cluster of CL per sample (blockIdx.x = (r·M + m)·CL + q):
// rows [q·rows_per_block, (q + 1)·rows_per_block) of x, and of dy when
// dy_resident, in shared memory (see the note at the top).
template <typename T, int V>
__global__ void __launch_bounds__(kClusterThreads, 6)
    gn_bwd_kernel(GnShape g, Strides sx, Strides sdy, Strides sdx,
                  const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, T* __restrict__ dx,
                  float* __restrict__ part_g, float* __restrict__ part_b,
                  int rows_per_block, int dy_resident) {
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / static_cast<int>(cluster.num_blocks());
  const int r = n / g.M, m = n - r * g.M;
  const int C = g.C;
  const int s0 = q * rows_per_block;
  const int n_rows = max(0, min(g.S - s0, rows_per_block));
  const T* xs = x + r * sx.r + m * sx.m + s0 * sx.s;
  const T* dys = dy + r * sdy.r + m * sdy.m + s0 * sdy.s;
  T* dxs = dx + r * sdx.r + m * sdx.m + s0 * sdx.s;

  extern __shared__ __align__(16) float bwd_smem[];
  float* part = bwd_smem;  // [2][kClusterThreads·V] row-group partials
  float* ex0 = part + 2 * kClusterThreads * V;  // this block's Σx, Σx² [2][C]
  float* ex1 = ex0 + 2 * C;  // this block's Σdy, Σdy·xhat [2][C]
  float* tot = ex1 + 2 * C;  // the sample's totals [2][C]
  float* mu = tot + 2 * C;
  float* rstd = mu + C;
  float* gam = rstd + C;
  T* sx_ = reinterpret_cast<T*>(bwd_smem + resident_offset(C, V));
  T* sdy_ = sx_ + rows_per_block * C;  // used when dy_resident

  // x's slice, then dy's, as two groups of asynchronous copies; γ while
  // they land.
  copy_rows<T, V>(sx_, xs, sx.s, n_rows, C);
  copy_async_commit();
  if (dy_resident) copy_rows<T, V>(sdy_, dys, sdy.s, n_rows, C);
  copy_async_commit();
  for (int c = threadIdx.x; c < C; c += kClusterThreads)
    gam[c] = gamma[r * C + c];
  copy_async_wait<1>();
  __syncthreads();

  // Pass 1: the statistics, over the cluster.
  channel_sums<kClusterThreads, V>(n_rows, C, sum_and_squares<T, V>(sx_, C), ex0,
                               ex0 + C, part);
  cluster_totals(cluster, ex0, tot, C);
  group_stats(g, tot, tot + C, mu, rstd);
  copy_async_wait<0>();
  __syncthreads();

  // Pass 2: per channel Σdy and Σdy·xhat (this sample's dβ and dγ).
  const T* dy_rows = dy_resident ? sdy_ : dys;
  const long long dy_stride = dy_resident ? C : sdy.s;
  channel_sums<kClusterThreads, V>(
      n_rows, C, dy_sums<T, V>(sx_, C, dy_rows, dy_stride, mu, rstd), ex1,
      ex1 + C, part);
  cluster_totals(cluster, ex1, tot, C);
  if (q == 0) {
    for (int c = threadIdx.x; c < C; c += kClusterThreads) {
      part_b[static_cast<long long>(n) * C + c] = tot[c];
      part_g[static_cast<long long>(n) * C + c] = tot[C + c];
    }
  }
  __syncthreads();
  // Group means of dxhat = dy·γ and dxhat·xhat, per channel, in place:
  // k0 = mean_g(dxhat), k1 = mean_g(dxhat·xhat).
  float* k0 = tot;
  float* k1 = tot + C;
  dy_group_means(g, gam, k0, k1);

  // Pass 3: dx, each thread on a fixed channel slot with that slot's
  // constants in registers.
  const int slots = C / V;
  const int t = threadIdx.x;
  for (int base = 0; base < slots; base += kClusterThreads) {
    const int here = min(kClusterThreads, slots - base);
    const int rows = kClusterThreads / here;
    if (t >= rows * here) continue;
    const int c = (base + t % here) * V;
    float mk[V], rk[V], gk[V], a0[V], a1[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mk[k] = mu[c + k];
      rk[k] = rstd[c + k];
      gk[k] = gam[c + k];
      a0[k] = k0[c + k];
      a1[k] = k1[c + k];
    }
#pragma unroll 2
    for (int s = t / here; s < n_rows; s += rows) {
      float v[V], d[V];
      load<T, V>(sx_ + s * C + c, v);
      load<T, V>(dy_rows + s * dy_stride + c, d);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xhat = (v[k] - mk[k]) * rk[k];
        v[k] = rk[k] * (d[k] * gk[k] - a0[k] - xhat * a1[k]);
      }
      store<T, V>(dxs + s * sdx.s + c, v);
    }
  }
  // The other blocks of the cluster read this block's ex1 in pass 2: its
  // shared memory must outlive their reads.
  cluster.sync();
}

// dγ[r, c] = Σ_m part_g[r·M + m, c] (and dβ alike), m in index order. One
// warp per (r, c): its lanes load 32 partials at once, and every lane adds
// them in order from the shuffles, so the loads are in flight together and
// the sum is the sequential one.
__global__ void gn_reduce_kernel(int R, int M, int C,
                                 const float* __restrict__ part_g,
                                 const float* __restrict__ part_b,
                                 float* __restrict__ dgamma,
                                 float* __restrict__ dbeta) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (w >= static_cast<long long>(R) * C) return;  // whole warps
  const long long r = w / C, c = w - r * C;
  float sg = 0.f, sb = 0.f;
#pragma unroll 4
  for (int m0 = 0; m0 < M; m0 += 32) {
    const long long off = (r * M + m0 + lane) * C + c;
    const bool in = m0 + lane < M;
    const float pg = in ? part_g[off] : 0.f;
    const float pb = in ? part_b[off] : 0.f;
    const int n = min(32, M - m0);
    for (int i = 0; i < n; ++i) {
      sg += __shfl_sync(0xffffffffu, pg, i);
      sb += __shfl_sync(0xffffffffu, pb, i);
    }
  }
  if (lane == 0) {
    dgamma[w] = sg;
    dbeta[w] = sb;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// How a cluster-resident kernel splits a sample: CL blocks of `rows` rows
// each, the number of the sample's tensors held in shared memory, and the
// dynamic shared memory per block.
struct ClusterPlan {
  int cl, rows, resident;
  size_t smem;
};

// For a sample of S x C elements and a kernel with `tensors` tensors to hold
// (the forward x; the backward x and dy): the smallest cluster (a power of 2
// up to kMaxCluster) whose blocks hold at most kTargetBytes of them each,
// and the most of them that fit in `max_smem` bytes a block; false if not
// even x fits. The partials are sized at the widest vector, so the plan
// depends on the shape alone.
bool plan_cluster(int S, int C, size_t elem_bytes, int tensors, int max_smem,
                  ClusterPlan* p) {
  const int widest = static_cast<int>(16 / elem_bytes);
  const size_t fixed =
      sizeof(float) * static_cast<size_t>(resident_offset(C, widest));
  auto data = [&](int cl, int n) {
    const size_t rows = (static_cast<size_t>(S) + cl - 1) / cl;
    return rows * static_cast<size_t>(C) * elem_bytes * n;
  };
  int cl = 1;
  while (cl < kMaxCluster && data(cl, tensors) > kTargetBytes) cl *= 2;
  for (int n = tensors; n >= 1; --n) {
    if (fixed + data(cl, n) <= static_cast<size_t>(max_smem)) {
      *p = {cl, (S + cl - 1) / cl, n, fixed + data(cl, n)};
      return true;
    }
  }
  return false;
}

cudaError_t max_smem_optin(int dev, int* bytes) {
  return cudaDeviceGetAttribute(bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

cudaError_t current_max_smem(int* bytes) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : max_smem_optin(dev, bytes);
}

// One cluster of p.cl blocks of kClusterThreads per sample.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), long long samples,
                           const ClusterPlan& p, cudaStream_t stream,
                           Args... args) {
  const long long blocks = samples * p.cl;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The route is chosen by shape before the launch: the cluster-resident
// kernel when x fits in a cluster's shared memory, else the streamed one.
// `*streamed` says which ran; an error on either route is returned as is.
template <typename T, int V>
cudaError_t fwd_v(const GnShape& g, const Strides& sx, const Strides& sy,
                  const void* x, const float* gamma, const float* beta,
                  void* y, bool* streamed, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = current_max_smem(&max_smem);
  if (err != cudaSuccess) return err;
  ClusterPlan p;
  *streamed = !plan_cluster(g.S, g.C, sizeof(T), 1, max_smem, &p);
  if (!*streamed)
    return launch_cluster(gn_fwd_kernel<T, V>,
                          static_cast<long long>(g.R) * g.M, p, stream, g,
                          sx, sy, static_cast<const T*>(x), gamma, beta,
                          static_cast<T*>(y), p.rows);
  // part, Σx and Σx² (then γ and β), μ and rstd.
  const size_t bytes = sizeof(float) * (2 * static_cast<size_t>(kThreads) *
                                            V + 4 * static_cast<size_t>(g.C));
  err = allow_smem(gn_fwd_streamed_kernel<T, V>, bytes);
  if (err != cudaSuccess) return err;
  gn_fwd_streamed_kernel<T, V><<<g.R * g.M, kThreads, bytes, stream>>>(
      g, sx, sy, static_cast<const T*>(x), gamma, beta, static_cast<T*>(y));
  return cudaGetLastError();
}

// The route is chosen by shape before the launch, as the forward's is: the
// cluster-resident kernel when x fits in a cluster's shared memory, else the
// streamed one. `*streamed` says which ran.
template <typename T, int V>
cudaError_t bwd_v(const GnShape& g, const Strides& sx, const Strides& sdy,
                  const Strides& sdx, const void* x, const void* dy,
                  const float* gamma, void* dx, float* part_g, float* part_b,
                  bool* streamed, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = current_max_smem(&max_smem);
  if (err != cudaSuccess) return err;
  ClusterPlan p;
  *streamed = !plan_cluster(g.S, g.C, sizeof(T), 2, max_smem, &p);
  if (!*streamed)
    return launch_cluster(gn_bwd_kernel<T, V>,
                          static_cast<long long>(g.R) * g.M, p, stream, g, sx,
                          sdy, sdx, static_cast<const T*>(x),
                          static_cast<const T*>(dy), gamma,
                          static_cast<T*>(dx), part_g, part_b, p.rows,
                          static_cast<int>(p.resident == 2));
  // part, Σdy and Σdy·xhat (first Σx and Σx²), μ, rstd and γ.
  const size_t bytes = sizeof(float) * (2 * static_cast<size_t>(kThreads) *
                                            V + 5 * static_cast<size_t>(g.C));
  err = allow_smem(gn_bwd_streamed_kernel<T, V>, bytes);
  if (err != cudaSuccess) return err;
  gn_bwd_streamed_kernel<T, V><<<g.R * g.M, kThreads, bytes, stream>>>(
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

// The cluster plan for a sample of S x C elements on device `dev`, with
// `tensors` tensors to hold (1: the forward, 2: the backward): out = {CL,
// rows per block, tensors resident, shared memory bytes per block}, all 0
// when x does not fit (both kernels then take their streamed route).
cudaError_t group_norm_plan(int S, int C, bool is_bf16, int tensors, int dev,
                            long long* out) {
  int max_smem = 0;
  const cudaError_t err = max_smem_optin(dev, &max_smem);
  if (err != cudaSuccess) return err;
  ClusterPlan p{0, 0, 0, 0};
  plan_cluster(S, C, is_bf16 ? 2 : 4, tensors, max_smem, &p);
  out[0] = p.cl;
  out[1] = p.rows;
  out[2] = p.resident;
  out[3] = static_cast<long long>(p.smem);
  return cudaSuccess;
}

cudaError_t group_norm_fwd_launch(int R, int M, int S, int C, int G,
                                  float eps, const long long* sx,
                                  const long long* sy, const void* x,
                                  const float* gamma, const float* beta,
                                  void* y, bool is_bf16, bool* streamed,
                                  cudaStream_t stream) {
  const GnShape g{R, M, S, C, G, eps};
  const Strides tx{sx[0], sx[1], sx[2]}, ty{sy[0], sy[1], sy[2]};
  const long long strides[6] = {sx[0], sx[1], sx[2], sy[0], sy[1], sy[2]};
  const void* ptrs[2] = {x, y};
  const int v = gn_vector_width(C, is_bf16 ? 2 : 4, strides, 6, ptrs, 2);
#define FEDML_GN_FWD(T, V) \
  return fwd_v<T, V>(g, tx, ty, x, gamma, beta, y, streamed, stream)
  if (is_bf16) {
    switch (v) {
      case 8: FEDML_GN_FWD(__nv_bfloat16, 8);
      case 4: FEDML_GN_FWD(__nv_bfloat16, 4);
      case 2: FEDML_GN_FWD(__nv_bfloat16, 2);
      default: FEDML_GN_FWD(__nv_bfloat16, 1);
    }
  }
  switch (v) {
    case 4: FEDML_GN_FWD(float, 4);
    case 2: FEDML_GN_FWD(float, 2);
    default: FEDML_GN_FWD(float, 1);
  }
#undef FEDML_GN_FWD
}

cudaError_t group_norm_bwd_launch(int R, int M, int S, int C, int G,
                                  float eps, const long long* sx,
                                  const long long* sdy, const long long* sdx,
                                  const void* x, const void* dy,
                                  const float* gamma, void* dx,
                                  float* part_g, float* part_b, bool is_bf16,
                                  bool* streamed, cudaStream_t stream) {
  const GnShape g{R, M, S, C, G, eps};
  const Strides tx{sx[0], sx[1], sx[2]}, tdy{sdy[0], sdy[1], sdy[2]},
      tdx{sdx[0], sdx[1], sdx[2]};
  const long long strides[9] = {sx[0],  sx[1],  sx[2],  sdy[0], sdy[1],
                                sdy[2], sdx[0], sdx[1], sdx[2]};
  const void* ptrs[3] = {x, dy, dx};
  const int v = gn_vector_width(C, is_bf16 ? 2 : 4, strides, 9, ptrs, 3);
#define FEDML_GN_BWD(T, V)                                                  \
  return bwd_v<T, V>(g, tx, tdy, tdx, x, dy, gamma, dx, part_g, part_b,  \
                     streamed, stream)
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
  const long long n = static_cast<long long>(R) * C * 32;  // a warp each
  const int blocks = static_cast<int>((n + kThreads - 1) / kThreads);
  gn_reduce_kernel<<<blocks, kThreads, 0, stream>>>(R, M, C, part_g, part_b,
                                                    dgamma, dbeta);
  return cudaGetLastError();
}

}  // namespace fedml_tpu_torch
