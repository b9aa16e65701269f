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
// clusters of 4.
//
// Backward (gn_bwd_kernel): x and dy resident, three passes over shared
// memory (statistics; Σdy and Σdy·xhat; dx) and two exchanges; dy's copy
// lands while the statistics are summed. At the main shape that is 2048
// blocks of 32 KB, five to an SM. A sample whose x and dy do not both fit in
// a cluster of 8 keeps x in shared memory and reads dy twice. The formulas
// stay the TPU kernel's on every route: Σdy·xhat with xhat formed from the
// statistics, not Σdy·x − μΣdy, which cancels.
//
// The streamed route (gn_fwd_streamed_kernel, gn_bwd_streamed_kernel) takes
// a sample whose x is more than a cluster of 8 holds (FedSeg's U-Net at
// 256², [65536, 16] and [16384, 32] f32, 4 and 2 MiB a sample), chosen by
// shape before the launch and reported to the caller, who counts it. It
// spreads the sample over a cluster of 16 blocks of 256 threads where the
// card schedules one (non-portable; asked of the occupancy calculator once
// per device, else 8), one block an SM with all the shared memory it can
// have, so that most of the sample is read from device memory once:
//
// - Rows are dealt to the cluster's blocks in granules of 16, so the
//   cluster sweeps the sample as one front of neighbouring lines. Each
//   block copies as many of its rows as fit into shared memory with
//   cp.async (3,495 of 4,096 at FedSeg's level 0); the rest it reads from
//   device memory in the first pass and again, soon after, in the later
//   ones, L2 told to keep them (createpolicy evict_last) and to drop what is
//   read or written for the last time (evict_first).
// - Each thread reads and copies the same vectors in every pass, so it
//   waits only for its own copies, and starts 8 rows' 16-byte loads before
//   it sums them, in row order.
// - The exchange is the cluster kernels', in rank order over up to 16
//   partials.
// - The backward keeps x resident first (it is read in all three passes)
//   and gives what shared memory is left to dy (FedSeg's level 1: all of x,
//   70% of dy); the rest of dy is read in the second pass and re-read in the
//   third.
// - Where x's R stride is the smaller (a vmapped conv's clients next to the
//   channels), consecutive clusters take consecutive rows of γ/β, so the
//   clusters in flight together read whole lines.
//
// The TPU kernel carries dγ/dβ across its sequential grid in VMEM scratch.
// CUDA blocks run in no order, so the backward writes f32 per-sample partials
// [R·M, C] and gn_reduce_kernel sums each row's M partials in index order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstdlib>

namespace fedml_tpu_torch {
namespace {

namespace cg = cooperative_groups;

// The reduce's blocks.
constexpr int kThreads = 256;
// The cluster-resident kernels' blocks: 128 threads, and a cluster of at most
// the portable 8 blocks per sample, each aiming to hold this many bytes of
// the sample's resident tensors.
constexpr int kClusterThreads = 128;
constexpr int kMaxCluster = 8;
constexpr size_t kTargetBytes = 32 * 1024;
// The streamed route's blocks: 256 threads, one block an SM, a cluster of 16
// (non-portable) where the card schedules it, and the rows each thread
// loads before it uses them.
constexpr int kStreamThreads = 256;
constexpr int kStreamCluster = 16;
constexpr int kStreamUnroll = 8;
// The rows a streamed block owns: granules of kGranule rows dealt to the
// cluster's blocks in turn.
constexpr int kGranule = 16;
// Devices whose streamed cluster size is remembered.
constexpr int kMaxDevices = 64;

// Offset, in floats, of the resident rows in a cluster kernel's shared
// memory: after the row-group partials [2][kClusterThreads·V] and nine
// per-channel arrays, rounded up to 16 bytes.
__host__ __device__ constexpr int resident_offset(int C, int V) {
  return (2 * kClusterThreads * V + 9 * C + 3) & ~3;
}

// The same for a streamed kernel, after partials [2][kStreamThreads·V].
__host__ __device__ constexpr int streamed_offset(int C, int V) {
  return (2 * kStreamThreads * V + 9 * C + 3) & ~3;
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

// The block's per-channel totals of the thread's V-channel sums a[] and b[]
// for one chunk of channel slots [base, base + here), `rows` threads to a
// slot (thread t = row·here + slot; `active` for t < rows·here): out_a[C]
// and out_b[C] (shared memory), each the sum over row groups in order.
// `part` holds 2·NT·V floats. Ends with a barrier.
template <int NT, int V>
__device__ __forceinline__ void add_partials(int base, int here, int rows,
                                             bool active, const float (&a)[V],
                                             const float (&b)[V], float* part,
                                             float* out_a, float* out_b) {
  const int t = threadIdx.x;
  float* part_a = part;
  float* part_b = part + NT * V;
  if (active) {
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
    }
    add_partials<NT, V>(base, here, rows, t < rows * here, a, b, part, out_a,
                        out_b);
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
// every block of the cluster (at most MAXCL), summed in rank order into
// tot[2·C] (the same bits in every block), by blocks of NT threads. Ends
// with a barrier.
template <int NT = kClusterThreads, int MAXCL = kMaxCluster>
__device__ void cluster_totals(cg::cluster_group& cluster, float* ex,
                               float* tot, int C) {
  cluster.sync();  // every block's ex is written
  const int cl = static_cast<int>(cluster.num_blocks());
  for (int c = threadIdx.x; c < 2 * C; c += NT) {
    float vals[MAXCL];  // all loads in flight before the sum
#pragma unroll
    for (int q = 0; q < MAXCL; ++q)
      vals[q] = q < cl ? cluster.map_shared_rank(ex, q)[c] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < MAXCL; ++q)
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

// --- The streamed route ----------------------------------------------------

// The V elements of a vector already in registers, as floats.
template <typename T, int V>
__device__ __forceinline__ void unpack(const Pack<T, V>& pk, float (&out)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_float(pk.v[k]);
}

// L2 policies (createpolicy): evict_last for lines a later pass reads
// again, evict_first for lines read or written for the last time.
__device__ __forceinline__ uint64_t l2_keep() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_drop() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// A vector of V elements from device memory, with the L2 policy `pol`
// (16-byte vectors; narrower ones are plain loads).
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_global(const T* p, uint64_t pol) {
  if constexpr (sizeof(T) * V == 16) {
    uint4 u;
    asm("ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
        : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
        : "l"(p), "l"(pol));
    return *reinterpret_cast<const Pack<T, V>*>(&u);
  } else {
    return *reinterpret_cast<const Pack<T, V>*>(p);
  }
}

// in[] rounded to T and stored at p, with the L2 policy `pol` (16-byte
// vectors; narrower ones are plain stores).
template <typename T, int V>
__device__ __forceinline__ void store_global(T* p, const float (&in)[V],
                                             uint64_t pol) {
  if constexpr (sizeof(T) * V == 16) {
    Pack<T, V> pk;
#pragma unroll
    for (int k = 0; k < V; ++k) from_float(in[k], &pk.v[k]);
    const uint4 u = *reinterpret_cast<const uint4*>(&pk);
    asm volatile(
        "st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\n" ::"l"(
            p),
        "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w), "l"(pol)
        : "memory");
  } else {
    store<T, V>(p, in);
  }
}

// V elements from device memory to shared memory with cp.async, L2 told by
// `pol` (16-byte copies) that the line is read for the last time.
template <typename T, int V>
__device__ __forceinline__ void copy_slot(T* dst, const T* src,
                                          uint64_t pol) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * V;
  if constexpr (kBytes == 16) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
            a),
        "l"(src), "l"(pol)
        : "memory");
  } else {
    copy_async<kBytes>(dst, src);
  }
}

// The channel chunk [base, base + here) of a pass over C/V slots by NT
// threads, `rows` threads to a slot: thread t takes slot base + t % here and
// rows t / here + k·rows while t < rows·here. Every pass and every copy
// into shared memory follows this map, so each thread reads back only the
// shared-memory vectors it copied itself, once its copies have landed.
struct Chunk {
  int here, rows, c, first;
  bool active;
};

template <int NT, int V>
__device__ __forceinline__ Chunk chunk_of(int base, int slots) {
  Chunk k;
  const int t = threadIdx.x;
  k.here = min(NT, slots - base);
  k.rows = NT / k.here;
  k.active = t < k.rows * k.here;
  k.c = (base + t % k.here) * V;
  k.first = t / k.here;
  return k;
}

// The rows of a sample that block q of a cluster of `cl` owns: granules of
// kGranule rows dealt to the blocks in turn, so that the cluster's blocks
// sweep the sample together, one front of neighbouring lines. The block's
// row i is the sample's row ((i / G)·cl + q)·G + i % G, G = kGranule.
struct RowMap {
  int q, cl;
  __host__ __device__ __forceinline__ int operator()(int i) const {
    return ((i / kGranule) * cl + q) * kGranule + i % kGranule;
  }
  // How many of a sample's S rows the block owns.
  __host__ __device__ __forceinline__ int count(int S) const {
    const int round = kGranule * cl, full = S / round;
    const int rest = S - full * round - q * kGranule;
    return full * kGranule + (rest < 0 ? 0 : rest < kGranule ? rest : kGranule);
  }
};

// The block's rows [0, n_rows) of a sample (`src`, `stride` elements apart,
// owned as `map` says) into dst[n_rows][C] with cp.async, each thread its
// own vectors.
template <typename T, int V, int NT>
__device__ __forceinline__ void copy_own_rows(T* dst, const T* src,
                                              long long stride, RowMap map,
                                              int n_rows, int C,
                                              uint64_t pol) {
  const int slots = C / V;
  for (int base = 0; base < slots; base += NT) {
    const Chunk k = chunk_of<NT, V>(base, slots);
    if (!k.active) continue;
#pragma unroll 4
    for (int s = k.first; s < n_rows; s += k.rows)
      copy_slot<T, V>(dst + s * C + k.c, src + map(s) * stride + k.c, pol);
  }
}

// Rows of one tensor of a sample: the thread's V channels of the block's
// row s, at p + s·stride in shared memory (SmemRows), or at p + map(s)·stride
// in device memory (GlobalRows, read with an L2 policy); p is already at
// the thread's first channel.
template <typename T, int V>
struct SmemRows {
  using Vec = Pack<T, V>;
  const T* p;
  int stride;
  __device__ __forceinline__ Pack<T, V> at(int s) const {
    return *reinterpret_cast<const Pack<T, V>*>(p + s * stride);
  }
};

template <typename T, int V>
struct GlobalRows {
  using Vec = Pack<T, V>;
  const T* p;
  long long stride;
  RowMap map;
  uint64_t pol;
  __device__ __forceinline__ Pack<T, V> at(int s) const {
    return load_global<T, V>(p + map(s) * stride, pol);
  }
};

template <typename Vec>
struct Pair {
  Vec x, d;
};

// A thread's rows of a segment [lo, hi): those s ≡ first (mod step), the
// same rows in every segment and pass as chunk_of gives it (n of them, from
// s upward).
struct Walk {
  int s, n, step;
};

__device__ __forceinline__ Walk walk_of(int lo, int hi, int first,
                                        int step) {
  const int s = lo + ((first - lo) % step + step) % step;
  return Walk{s, s < hi ? (hi - s + step - 1) / step : 0, step};
}

// The rows of `w` in order, `use(s, load(s))` for each, U rows' loads
// started together before they are used: a thread keeps U 16-byte loads of
// each operand in flight, and its sums keep the sequential order.
template <int U, typename Load, typename Use>
__device__ __forceinline__ void walk_rows(Walk w, Load load, Use use) {
  using Regs = decltype(load(0));
  int s = w.s, k = 0;
  for (; k + U <= w.n; k += U, s += U * w.step) {
    Regs r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = load(s + u * w.step);
#pragma unroll
    for (int u = 0; u < U; ++u) use(s + u * w.step, r[u]);
  }
  for (; k < w.n; ++k, s += w.step) use(s, load(s));
}

// Σx and Σx² of the thread's channels over the rows of `w`.
template <typename XR, int V>
__device__ __forceinline__ void sum_x_rows(XR xr, Walk w, float (&a)[V],
                                           float (&b)[V]) {
  walk_rows<kStreamUnroll>(
      w, [&](int s) { return xr.at(s); },
      [&](int, const auto& pk) {
        float v[V];
        unpack(pk, v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[k] += v[k];
          b[k] += v[k] * v[k];
        }
      });
}

// Σdy and Σdy·xhat of the thread's channels over the rows of `w`, xhat =
// (x − μ)·rstd.
template <typename XR, typename DR, int V>
__device__ __forceinline__ void sum_dy_rows(XR xr, DR dr, Walk w,
                                            const float (&mk)[V],
                                            const float (&rk)[V],
                                            float (&a)[V], float (&b)[V]) {
  walk_rows<kStreamUnroll>(
      w,
      [&](int s) { return Pair<typename XR::Vec>{xr.at(s), dr.at(s)}; },
      [&](int, const auto& pr) {
        float v[V], d[V];
        unpack(pr.x, v);
        unpack(pr.d, d);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a[k] += d[k];
          b[k] += d[k] * ((v[k] - mk[k]) * rk[k]);
        }
      });
}

// y = ((x − μ)·rstd)·γ + β of the thread's channels over the rows of `w`,
// into y + map(s)·y_stride.
template <typename XR, typename T, int V>
__device__ __forceinline__ void normalize_rows(
    XR xr, Walk w, T* y, long long y_stride, RowMap map, uint64_t pol,
    const float (&mk)[V], const float (&rk)[V], const float (&gk)[V],
    const float (&bk)[V]) {
  walk_rows<kStreamUnroll>(
      w, [&](int s) { return xr.at(s); },
      [&](int s, const auto& pk) {
        float v[V];
        unpack(pk, v);
#pragma unroll
        for (int k = 0; k < V; ++k)
          v[k] = ((v[k] - mk[k]) * rk[k]) * gk[k] + bk[k];
        store_global<T, V>(y + map(s) * y_stride, v, pol);
      });
}

// dx = rstd·(dy·γ − mean_g(dxhat) − xhat·mean_g(dxhat·xhat)) of the
// thread's channels over the rows of `w`, into dx + map(s)·dx_stride.
template <typename XR, typename DR, typename T, int V>
__device__ __forceinline__ void dx_rows(XR xr, DR dr, Walk w, T* dx,
                                        long long dx_stride, RowMap map,
                                        uint64_t pol,
                                        const float (&mk)[V],
                                        const float (&rk)[V],
                                        const float (&gk)[V],
                                        const float (&a0)[V],
                                        const float (&a1)[V]) {
  walk_rows<kStreamUnroll>(
      w,
      [&](int s) { return Pair<typename XR::Vec>{xr.at(s), dr.at(s)}; },
      [&](int s, const auto& pr) {
        float v[V], d[V];
        unpack(pr.x, v);
        unpack(pr.d, d);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xhat = (v[k] - mk[k]) * rk[k];
          v[k] = rk[k] * (d[k] * gk[k] - a0[k] - xhat * a1[k]);
        }
        store_global<T, V>(dx + map(s) * dx_stride, v, pol);
      });
}

// The sample of cluster n of the grid, (r, m), r the faster index when
// `r_inner`.
__device__ __forceinline__ void sample_of(int n, const GnShape& g,
                                          int r_inner, int* r, int* m) {
  if (r_inner) {
    *m = n / g.R;
    *r = n - *m * g.R;
  } else {
    *r = n / g.M;
    *m = n - *r * g.M;
  }
}

// The forward's streamed route: one cluster of CL blocks per sample (see
// the note at the top). Rows [0, resident) of the block's share sit in its
// shared memory; the rest are read from device memory twice.
template <typename T, int V>
__global__ void __launch_bounds__(kStreamThreads, 1)
    gn_fwd_streamed_kernel(GnShape g, Strides sx, Strides sy,
                           const T* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, T* __restrict__ y,
                           int resident, int r_inner) {
  constexpr int NT = kStreamThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  int r, m;
  sample_of(blockIdx.x / cl, g, r_inner, &r, &m);
  const int C = g.C, slots = C / V;
  const RowMap map{q, cl};
  const int n_rows = map.count(g.S);
  const int n_res = min(resident, n_rows);
  const T* xs = x + r * sx.r + m * sx.m;
  T* ys = y + r * sy.r + m * sy.m;
  const uint64_t keep = l2_keep(), drop = l2_drop();

  extern __shared__ __align__(16) float str_fwd_smem[];
  float* part = str_fwd_smem;  // [2][NT·V] row-group partials
  float* ex = part + 2 * NT * V;  // this block's Σx, Σx² [2][C]
  float* tot = ex + 2 * C;  // the sample's totals [2][C]
  float* mu = tot + 2 * C;
  float* rstd = mu + C;
  float* gam = rstd + C;
  float* bet = gam + C;
  T* sx_ = reinterpret_cast<T*>(str_fwd_smem + streamed_offset(C, V));

  // The resident rows as one group of asynchronous copies; γ and β.
  copy_own_rows<T, V, NT>(sx_, xs, sx.s, map, n_res, C, drop);
  copy_async_commit();
  for (int c = threadIdx.x; c < C; c += NT) {
    gam[c] = gamma[r * C + c];
    bet[c] = beta[r * C + c];
  }

  // Σx and Σx²: the streamed rows while the copies land, then the resident
  // ones.
  for (int base = 0; base < slots; base += NT) {
    const Chunk k = chunk_of<NT, V>(base, slots);
    float a[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
    if (k.active)
      sum_x_rows(GlobalRows<T, V>{xs + k.c, sx.s, map, keep},
                 walk_of(n_res, n_rows, k.first, k.rows), a, b);
    if (base == 0) copy_async_wait<0>();
    if (k.active)
      sum_x_rows(SmemRows<T, V>{sx_ + k.c, C},
                 walk_of(0, n_res, k.first, k.rows), a, b);
    add_partials<NT, V>(base, k.here, k.rows, k.active, a, b, part, ex,
                        ex + C);
  }
  cluster_totals<NT, kStreamCluster>(cluster, ex, tot, C);
  cluster_arrive();
  group_stats(g, tot, tot + C, mu, rstd);

  // y: the streamed rows first, while L2 still holds them; then the
  // resident ones.
  for (int base = 0; base < slots; base += NT) {
    const Chunk k = chunk_of<NT, V>(base, slots);
    if (!k.active) continue;
    float mk[V], rk[V], gk[V], bk[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mk[j] = mu[k.c + j];
      rk[j] = rstd[k.c + j];
      gk[j] = gam[k.c + j];
      bk[j] = bet[k.c + j];
    }
    normalize_rows(GlobalRows<T, V>{xs + k.c, sx.s, map, drop},
                   walk_of(n_res, n_rows, k.first, k.rows), ys + k.c, sy.s,
                   map, drop, mk, rk, gk, bk);
    normalize_rows(SmemRows<T, V>{sx_ + k.c, C},
                   walk_of(0, n_res, k.first, k.rows), ys + k.c, sy.s, map,
                   drop, mk, rk, gk, bk);
  }
  cluster_wait();
}

// The backward's streamed route: one cluster of CL blocks per sample (see
// the note at the top). Rows [0, res_x) of the block's share of x, and
// [0, res_dy) of dy, sit in its shared memory (res_dy > 0 only when all of
// the share of x does); the rest are read from device memory in each pass.
// The per-sample partials of dγ and dβ go to part_g/part_b [R·M, C], as on
// the cluster route.
template <typename T, int V>
__global__ void __launch_bounds__(kStreamThreads, 1)
    gn_bwd_streamed_kernel(GnShape g, Strides sx, Strides sdy, Strides sdx,
                           const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ gamma,
                           T* __restrict__ dx, float* __restrict__ part_g,
                           float* __restrict__ part_b, int res_x,
                           int res_dy, int r_inner) {
  constexpr int NT = kStreamThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  int r, m;
  sample_of(blockIdx.x / cl, g, r_inner, &r, &m);
  const int C = g.C, slots = C / V;
  const RowMap map{q, cl};
  const int n_rows = map.count(g.S);
  const int n_x = min(res_x, n_rows), n_dy = min(res_dy, n_rows);
  const T* xs = x + r * sx.r + m * sx.m;
  const T* dys = dy + r * sdy.r + m * sdy.m;
  T* dxs = dx + r * sdx.r + m * sdx.m;
  const uint64_t keep = l2_keep(), drop = l2_drop();

  extern __shared__ __align__(16) float str_bwd_smem[];
  float* part = str_bwd_smem;  // [2][NT·V] row-group partials
  float* ex0 = part + 2 * NT * V;  // this block's Σx, Σx² [2][C]
  float* ex1 = ex0 + 2 * C;  // this block's Σdy, Σdy·xhat [2][C]
  float* tot = ex1 + 2 * C;  // the sample's totals [2][C]
  float* mu = tot + 2 * C;
  float* rstd = mu + C;
  float* gam = rstd + C;
  T* sx_ = reinterpret_cast<T*>(str_bwd_smem + streamed_offset(C, V));
  T* sdy_ = sx_ + static_cast<long long>(res_x) * C;

  // x's resident rows, then dy's, as two groups of asynchronous copies; γ.
  copy_own_rows<T, V, NT>(sx_, xs, sx.s, map, n_x, C, drop);
  copy_async_commit();
  copy_own_rows<T, V, NT>(sdy_, dys, sdy.s, map, n_dy, C, drop);
  copy_async_commit();
  for (int c = threadIdx.x; c < C; c += NT) gam[c] = gamma[r * C + c];

  // Pass 1: Σx and Σx², the streamed rows while the copies land.
  for (int base = 0; base < slots; base += NT) {
    const Chunk k = chunk_of<NT, V>(base, slots);
    float a[V], b[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a[j] = b[j] = 0.f;
    if (k.active)
      sum_x_rows(GlobalRows<T, V>{xs + k.c, sx.s, map, keep},
                 walk_of(n_x, n_rows, k.first, k.rows), a, b);
    if (base == 0) copy_async_wait<1>();
    if (k.active)
      sum_x_rows(SmemRows<T, V>{sx_ + k.c, C},
                 walk_of(0, n_x, k.first, k.rows), a, b);
    add_partials<NT, V>(base, k.here, k.rows, k.active, a, b, part, ex0,
                        ex0 + C);
  }
  cluster_totals<NT, kStreamCluster>(cluster, ex0, tot, C);
  group_stats(g, tot, tot + C, mu, rstd);
  copy_async_wait<0>();

  // Pass 2: Σdy and Σdy·xhat (this sample's dβ and dγ): the rows whose dy
  // is read from device memory first.
  for (int base = 0; base < slots; base += NT) {
    const Chunk k = chunk_of<NT, V>(base, slots);
    float a[V], b[V], mk[V], rk[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = b[j] = 0.f;
      mk[j] = mu[k.c + j];
      rk[j] = rstd[k.c + j];
    }
    if (k.active) {
      const GlobalRows<T, V> xg{xs + k.c, sx.s, map, keep},
          dg{dys + k.c, sdy.s, map, keep};
      const SmemRows<T, V> xr{sx_ + k.c, C}, dr{sdy_ + k.c, C};
      sum_dy_rows(xg, dg, walk_of(n_x, n_rows, k.first, k.rows), mk, rk, a,
                  b);
      sum_dy_rows(xr, dg, walk_of(n_dy, n_x, k.first, k.rows), mk, rk, a,
                  b);
      sum_dy_rows(xr, dr, walk_of(0, n_dy, k.first, k.rows), mk, rk, a, b);
    }
    add_partials<NT, V>(base, k.here, k.rows, k.active, a, b, part, ex1,
                        ex1 + C);
  }
  cluster_totals<NT, kStreamCluster>(cluster, ex1, tot, C);
  if (q == 0) {
    const long long n = static_cast<long long>(r) * g.M + m;
    for (int c = threadIdx.x; c < C; c += NT) {
      part_b[n * C + c] = tot[c];
      part_g[n * C + c] = tot[C + c];
    }
  }
  __syncthreads();
  // k0 = mean_g(dxhat), k1 = mean_g(dxhat·xhat), per channel, in place.
  float* k0 = tot;
  float* k1 = tot + C;
  dy_group_means(g, gam, k0, k1);

  // Pass 3: dx, the rows whose dy is read from device memory first, while
  // L2 still holds them.
  for (int base = 0; base < slots; base += NT) {
    const Chunk k = chunk_of<NT, V>(base, slots);
    if (!k.active) continue;
    float mk[V], rk[V], gk[V], a0[V], a1[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mk[j] = mu[k.c + j];
      rk[j] = rstd[k.c + j];
      gk[j] = gam[k.c + j];
      a0[j] = k0[k.c + j];
      a1[j] = k1[k.c + j];
    }
    const GlobalRows<T, V> xg{xs + k.c, sx.s, map, drop},
        dg{dys + k.c, sdy.s, map, drop};
    const SmemRows<T, V> xr{sx_ + k.c, C}, dr{sdy_ + k.c, C};
    dx_rows(xr, dg, walk_of(n_dy, n_x, k.first, k.rows), dxs + k.c, sdx.s,
            map, drop, mk, rk, gk, a0, a1);
    dx_rows(xg, dg, walk_of(n_x, n_rows, k.first, k.rows), dxs + k.c, sdx.s,
            map, drop, mk, rk, gk, a0, a1);
    dx_rows(xr, dr, walk_of(0, n_dy, k.first, k.rows), dxs + k.c, sdx.s,
            map, drop, mk, rk, gk, a0, a1);
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
    const size_t rows = static_cast<size_t>(RowMap{0, cl}.count(S));
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

// `clusters` clusters of `cl` blocks of `threads`, `smem` bytes of dynamic
// shared memory each.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), long long clusters,
                           int cl, size_t smem, int threads,
                           cudaStream_t stream, Args... args) {
  const long long blocks = clusters * cl;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The streamed kernel for T, V and TENSORS tensors to hold (1: the forward,
// 2: the backward).
template <typename T, int V, int TENSORS>
auto streamed_kernel() {
  if constexpr (TENSORS == 1) {
    return gn_fwd_streamed_kernel<T, V>;
  } else {
    return gn_bwd_streamed_kernel<T, V>;
  }
}

// The cluster size of a streamed kernel on the current device: 16 where the
// occupancy calculator finds room for one cluster of 16 blocks with
// `max_smem` bytes each (which then holds for any less), else 8; and how
// many such clusters the card runs at once. Asked once per kernel and
// device (which also allows the kernel its cluster of 16), never by trying
// a launch. No cluster at all is an error.
template <typename T, int V, int TENSORS>
cudaError_t streamed_cluster(int max_smem, int* cl, int* active) {
  const auto kernel = streamed_kernel<T, V, TENSORS>();
  static std::atomic<int> known[kMaxDevices];  // cl | active << 8; 0: not yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int seen = dev < kMaxDevices ? known[dev].load() : 0;
  if (seen != 0) {
    *cl = seen & 0xff;
    *active = seen >> 8;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = allow_smem(kernel, max_smem);
  for (int c = kStreamCluster; err == cudaSuccess && c >= kMaxCluster;
       c /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kStreamThreads);
    cfg.dynamicSmemBytes = max_smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err == cudaSuccess && n > 0) {
      *cl = c;
      *active = n;
      if (dev < kMaxDevices) known[dev].store(c | n << 8);
      return cudaSuccess;
    }
  }
  return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
}

// How the streamed route splits a sample: CL blocks owning at most `rows`
// rows each (RowMap), of which the first res_x rows of x and res_dy rows
// of dy sit in shared memory, and the dynamic shared memory per block.
struct StreamPlan {
  int cl, rows, res_x, res_dy;
  size_t smem;
  int active;  // clusters the card runs at once
};

// For a sample of S x C elements and the streamed kernel with TENSORS
// tensors to hold (the forward x; the backward x, then dy): the cluster of
// streamed_cluster, and as many rows of x, then of dy, as `max_smem` bytes
// a block hold beside the fixed arrays. The partials are sized at the
// widest vector, so the plan depends on the shape alone.
template <typename T, int V, int TENSORS>
cudaError_t plan_streamed(int S, int C, int max_smem, StreamPlan* p) {
  constexpr size_t elem_bytes = sizeof(T);
  const int tensors = TENSORS;
  int cl = 0, active = 0;
  const cudaError_t err =
      streamed_cluster<T, V, TENSORS>(max_smem, &cl, &active);
  if (err != cudaSuccess) return err;
  const int widest = static_cast<int>(16 / elem_bytes);
  const size_t fixed =
      sizeof(float) * static_cast<size_t>(streamed_offset(C, widest));
  const size_t row = static_cast<size_t>(C) * elem_bytes;
  const size_t rows = static_cast<size_t>(RowMap{0, cl}.count(S));
  size_t room = static_cast<size_t>(max_smem) > fixed ? max_smem - fixed : 0;
  const size_t res_x = rows < room / row ? rows : room / row;
  room -= res_x * row;
  const size_t res_dy = tensors < 2 ? 0 : rows < room / row ? rows : room / row;
  *p = {cl, static_cast<int>(rows), static_cast<int>(res_x),
        static_cast<int>(res_dy), fixed + (res_x + res_dy) * row, active};
  return cudaSuccess;
}

// Whether the clusters take the samples with r the faster index: where x's
// R stride is the smaller (a vmapped conv's clients next to the channels),
// so that the clusters in flight together read neighbouring rows.
int r_inner(const GnShape& g, const Strides& sx) {
  return g.R > 1 && g.M > 1 && llabs(sx.r) < llabs(sx.m);
}

// The route is chosen by shape before the launch: the cluster-resident
// kernel when x fits in a cluster of 8's shared memory, else the streamed
// one. `*streamed` says which ran; an error on either route is returned as
// is.
template <typename T, int V>
cudaError_t fwd_v(const GnShape& g, const Strides& sx, const Strides& sy,
                  const void* x, const float* gamma, const float* beta,
                  void* y, bool* streamed, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = current_max_smem(&max_smem);
  if (err != cudaSuccess) return err;
  const long long samples = static_cast<long long>(g.R) * g.M;
  ClusterPlan p;
  *streamed = !plan_cluster(g.S, g.C, sizeof(T), 1, max_smem, &p);
  if (!*streamed)
    return launch_cluster(gn_fwd_kernel<T, V>, samples, p.cl, p.smem,
                          kClusterThreads, stream, g, sx, sy,
                          static_cast<const T*>(x), gamma, beta,
                          static_cast<T*>(y), p.rows);
  StreamPlan sp;
  err = plan_streamed<T, V, 1>(g.S, g.C, max_smem, &sp);
  if (err != cudaSuccess) return err;
  return launch_cluster(gn_fwd_streamed_kernel<T, V>, samples, sp.cl,
                        sp.smem, kStreamThreads, stream, g, sx, sy,
                        static_cast<const T*>(x), gamma, beta,
                        static_cast<T*>(y), sp.res_x, r_inner(g, sx));
}

// The route is chosen by shape before the launch, as the forward's is: the
// cluster-resident kernel when x fits in a cluster of 8's shared memory,
// else the streamed one. `*streamed` says which ran.
template <typename T, int V>
cudaError_t bwd_v(const GnShape& g, const Strides& sx, const Strides& sdy,
                  const Strides& sdx, const void* x, const void* dy,
                  const float* gamma, void* dx, float* part_g, float* part_b,
                  bool* streamed, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = current_max_smem(&max_smem);
  if (err != cudaSuccess) return err;
  const long long samples = static_cast<long long>(g.R) * g.M;
  ClusterPlan p;
  *streamed = !plan_cluster(g.S, g.C, sizeof(T), 2, max_smem, &p);
  if (!*streamed)
    return launch_cluster(gn_bwd_kernel<T, V>, samples, p.cl, p.smem,
                          kClusterThreads, stream, g, sx, sdy, sdx,
                          static_cast<const T*>(x),
                          static_cast<const T*>(dy), gamma,
                          static_cast<T*>(dx), part_g, part_b, p.rows,
                          static_cast<int>(p.resident == 2));
  StreamPlan sp;
  err = plan_streamed<T, V, 2>(g.S, g.C, max_smem, &sp);
  if (err != cudaSuccess) return err;
  return launch_cluster(gn_bwd_streamed_kernel<T, V>, samples, sp.cl,
                        sp.smem, kStreamThreads, stream, g, sx, sdy, sdx,
                        static_cast<const T*>(x), static_cast<const T*>(dy),
                        gamma, static_cast<T*>(dx), part_g, part_b,
                        sp.res_x, sp.res_dy, r_inner(g, sx));
}

// The streamed plan of a sample of S x C elements as the widest-vector
// kernel of its type and direction gets it.
template <typename T, int V>
cudaError_t plan_streamed_for(int S, int C, int tensors, int max_smem,
                              StreamPlan* p) {
  return tensors == 1 ? plan_streamed<T, V, 1>(S, C, max_smem, p)
                      : plan_streamed<T, V, 2>(S, C, max_smem, p);
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

// The plans for a sample of S x C elements on the current device `dev`,
// with `tensors` tensors to hold (1: the forward, 2: the backward): out[0..3]
// = the cluster route's {CL, rows per block, tensors resident, shared memory
// bytes per block}, all 0 when x does not fit in a cluster of 8; then, for
// such a sample, out[4..9] = the streamed route's {CL, rows of the block
// that owns the most, resident rows of x a block, resident rows of dy a
// block, shared memory bytes per block, clusters the card runs at once},
// else 0s.
cudaError_t group_norm_plan(int S, int C, bool is_bf16, int tensors, int dev,
                            long long* out) {
  int max_smem = 0;
  cudaError_t err = max_smem_optin(dev, &max_smem);
  if (err != cudaSuccess) return err;
  ClusterPlan p{0, 0, 0, 0};
  StreamPlan sp{0, 0, 0, 0, 0, 0};
  if (!plan_cluster(S, C, is_bf16 ? 2 : 4, tensors, max_smem, &p)) {
    err = is_bf16 ? plan_streamed_for<__nv_bfloat16, 8>(S, C, tensors,
                                                         max_smem, &sp)
                  : plan_streamed_for<float, 4>(S, C, tensors, max_smem, &sp);
    if (err != cudaSuccess) return err;
  }
  out[0] = p.cl;
  out[1] = p.rows;
  out[2] = p.resident;
  out[3] = static_cast<long long>(p.smem);
  out[4] = sp.cl;
  out[5] = sp.rows;
  out[6] = sp.res_x;
  out[7] = sp.res_dy;
  out[8] = static_cast<long long>(sp.smem);
  out[9] = sp.active;
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
