// Flash-attention backward in bf16 on Hopper's tensor cores (sm_90a): dq,
// and dk with dv, from Q, K, V, dO, the forward's row log-sum-exp and
// δ = rowsum(dO∘O).
//
// Replaces fedml_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels reached through _bwd) for bf16 operands; f32
// operands keep the FMA kernels of flash_bwd.cu, since the tensor cores have
// no full-f32 product. Same arithmetic as the TPU kernels: S = (Q·Kᵀ)·scale
// with scale = 1/√D, causal mask NEG_INF = -1e30, P = exp(S − lse),
// dP = dO·Vᵀ, dS = P∘(dP − δ) rounded to bf16 before the products that use
// it, P rounded to bf16 before P̃ᵀ·dO; dq = scale·dS·K, dk = scale·dSᵀ·Q,
// dv = P̃ᵀ·dO, every sum in f32. No sum crosses blocks: no atomics, and a
// rerun gives the same bits.
//
// What bounds them on an H100: at the FedAdapter training shape (R·B = 16,
// T = 2048, H = 8, D = 64, causal) dq does three T²·D/2 products per head
// (S, dP, dS·K) and dk/dv four (Sᵀ, dPᵀ, P̃ᵀ·dO, dSᵀ·Q): 103.1 and 137.5
// GFLOP against ~170 and ~200 MB of operands, far above the card's ~295
// bf16 operations per byte, so both are bound by operations, at the bf16
// tensor-core rate (989 TFLOP/s). The FMA kernels of flash_bwd.cu reached
// ~23 TFLOP/s; what this design does about each thing that held them back:
// 1. No tensor cores: every product here is a wgmma (m64nNk16, bf16 in, f32
//    sums), issued by one warpgroup per block.
// 2. Operands widened to f32 in shared memory by scalar loads: Q, K, V and
//    dO stay bf16 and arrive by TMA, in the swizzled layout the wgmma
//    descriptors read (128 B swizzle at D 64, two 64-column atoms at D 128,
//    64 B at D 32, 32 B at D 16).
// 3. No overlap of load and compute: the tiles of the inner loop go through
//    a ring of two stages, one mbarrier each; the next tile's TMA load is in
//    flight while the current one computes.
// 4. P and dS through shared memory: the accumulator fragment of the
//    score product is the A-register fragment of the accumulating product
//    (wgmma_sm90.cuh), so P̃ and dS go from the exponent to the next wgmma
//    in registers.
// 5. Causal tail: the longest blocks start first. The tile index is the
//    slow grid dim (blockIdx.y) and every head of one tile index runs
//    before the next; dq maps blockIdx.y to the Q tiles from T down (a Q
//    tile near T walks the most K/V tiles), dk/dv from 0 up (a K/V tile
//    near 0 walks the most Q tiles).
//
// Design.
// - flash_dkv_sm90_kernel: one block of one warpgroup per (r·b·h, 64 key
//   rows); K and V stay in shared memory. The loop walks the Q/dO tiles
//   (64 rows; 32 at D 128, to keep the dk and dv accumulators in
//   registers) from the diagonal on: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are SS
//   wgmmas with both operands K-major; P̃ᵀ and dSᵀ are formed in the
//   accumulator registers with lse and δ of the tile's query columns from
//   shared memory; dV += P̃ᵀ·dO and dK += dSᵀ·Q are RS wgmmas with dO and Q
//   read MN-major (transposed) from the same tiles.
// - flash_dq_sm90_kernel: one block of one warpgroup per (r·b·h, 64 query
//   rows); Q and dO stay in shared memory. The loop walks the K/V tiles up
//   to the diagonal: S = Q·Kᵀ and dP = dO·Vᵀ as SS wgmmas, dS in registers,
//   dQ += dS·K as an RS wgmma with K read MN-major.
// Thread 0 issues the TMA loads; the tensor maps are 5-D over the
// operands' [R, B, T, H, D] strides (the layout of flash_common.cuh), so
// MHA's qkv views and the vmapped client dim next to T take no copy, and
// TMA's zero fill covers the ragged end of T. Outputs are contiguous
// [R, B, T, H, D] bf16; lse and δ are contiguous [R, B, H, T] f32.

#include "flash_sm90.cuh"

namespace fedml_tpu_torch {
namespace {

using namespace sm90;

template <int D>
struct DkvCfg {
  static constexpr int BK = 64;                  // key rows per block
  static constexpr int BQ = D == 128 ? 32 : 64;  // query rows per step
  using KT = Tile<D, BK>;
  using QT = Tile<D, BQ>;
  // K, V; two stages of (Q, dO); two stages of lse·log2e and δ (f32 [BQ]);
  // three mbarriers; 1024 B to align the base.
  static constexpr int SMEM = 2 * KT::BYTES + 4 * QT::BYTES + 4 * BQ * 4 +
                              3 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(WG)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int B,
                          int H, int T_len, float scale, int causal) {
  using C = DkvCfg<D>;
  using KT = typename C::KT;
  using QT = typename C::QT;
  constexpr int BK = C::BK, BQ = C::BQ;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + KT::BYTES;
  uint8_t* sQ0 = sV + KT::BYTES;  // stage s: Q at sQ0 + 2s·QT::BYTES, dO after
  float* sL = reinterpret_cast<float*>(sQ0 + 4 * QT::BYTES);  // [2][BQ]
  float* sD = sL + 2 * BQ;                                    // [2][BQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + 2 * BQ);  // K/V, stage 0, 1

  const int bh = blockIdx.x;
  const int h = bh % H, rb = bh / H, r = rb / B, b = rb - r * B;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_begin = causal ? k0 : 0;  // BQ divides BK
  const int n_steps = (T_len - q_begin + BQ - 1) / BQ;
  const float* lse_bh = lse + static_cast<long long>(bh) * T_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * T_len;
  const float scale2 = scale * kLog2e;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * KT::BYTES);
    KT::load(sK, &mk, &bars[0], k0, h, b, r);
    KT::load(sV, &mv, &bars[0], k0, h, b, r);
    mbar_expect_tx(&bars[1], 2 * QT::BYTES);
    QT::load(sQ0, &mq, &bars[1], q_begin, h, b, r);
    QT::load(sQ0 + QT::BYTES, &mdo, &bars[1], q_begin, h, b, r);
  }
  // lse·log2e and δ of the query rows of step `it` (0 past T): thread i < BQ
  // loads lse of row i, thread BQ + i loads δ of row i.
  auto row_stat = [&](int it) {
    const int i = tid % BQ, row = q_begin + it * BQ + i;
    if (tid >= 2 * BQ || row >= T_len) return 0.f;
    return tid < BQ ? lse_bh[row] * kLog2e : delta_bh[row];
  };
  {
    const float x = row_stat(0);
    if (tid < BQ) sL[tid] = x;
    else if (tid < 2 * BQ) sD[tid - BQ] = x;
  }

  float acc_k[D / 2], acc_v[D / 2], st[BQ / 2], dpt[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;

  const uint32_t k_base = smem_addr(sK), v_base = smem_addr(sV);
  const int krow0 = k0 + 16 * warp + (lane >> 2);  // this thread's key rows:
                                                   // krow0 and krow0 + 8
  const int qcol0 = 2 * (lane & 3);  // its query columns: qcol0 + 8j + {0, 1}
  __syncthreads();  // sL/sD of step 0
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_steps; ++it) {
    const int s = it & 1;
    const int q0 = q_begin + it * BQ;
    uint8_t* sQ = sQ0 + 2 * s * QT::BYTES;
    uint8_t* sDO = sQ + QT::BYTES;
    const bool more = it + 1 < n_steps;
    if (tid == 0 && more) {  // stage s ^ 1 was released by the last barrier
      uint8_t* nQ = sQ0 + 2 * (s ^ 1) * QT::BYTES;
      mbar_expect_tx(&bars[1 + (s ^ 1)], 2 * QT::BYTES);
      QT::load(nQ, &mq, &bars[1 + (s ^ 1)], q0 + BQ, h, b, r);
      QT::load(nQ + QT::BYTES, &mdo, &bars[1 + (s ^ 1)], q0 + BQ, h, b, r);
    }
    const float next_stat = more ? row_stat(it + 1) : 0.f;
    mbar_wait(&bars[1 + s], (it >> 1) & 1);

    const uint32_t q_base = smem_addr(sQ), do_base = smem_addr(sDO);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      SS<BQ>::mma(st, KT::kmajor(k_base, k), QT::kmajor(q_base, k), k > 0);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      SS<BQ>::mma(dpt, KT::kmajor(v_base, k), QT::kmajor(do_base, k), k > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P̃ᵀ and dSᵀ, bf16, packed as the A fragments of the RS products.
    const float* sl = sL + s * BQ;
    const float* sd = sD + s * BQ;
    const bool edge = (causal && q0 < k0 + BK) || q0 + BQ > T_len ||
                      k0 + BK > T_len;
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {
      const int j = i >> 2, hh = (i >> 1) & 1;
      const int krow = krow0 + 8 * hh;
      const int qc = 8 * j + qcol0;
      const float2 l2 = *reinterpret_cast<const float2*>(sl + qc);
      const float2 d2 = *reinterpret_cast<const float2*>(sd + qc);
      float p0 = exp2_approx(fmaf(st[i], scale2, -l2.x));
      float p1 = exp2_approx(fmaf(st[i + 1], scale2, -l2.y));
      if (edge) {  // the causal mask (P = exp(NEG_INF − lse) = 0), ragged T
        const bool kin = krow < T_len;
        if (!kin || q0 + qc >= T_len || (causal && krow > q0 + qc)) p0 = 0.f;
        if (!kin || q0 + qc + 1 >= T_len || (causal && krow > q0 + qc + 1))
          p1 = 0.f;
      }
      const int g = j >> 1, reg = 2 * (j & 1) + hh;
      pa[g][reg] = pack_bf16(p0, p1);
      dsa[g][reg] = pack_bf16(p0 * (dpt[i] - d2.x), p1 * (dpt[i + 1] - d2.y));
    }

    fence_regs(acc_v);
    fence_regs(acc_k);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BQ / 16; ++k) {
      RS<D>::mma(acc_v, pa[k], QT::mnmajor(do_base, k), 1);
      RS<D>::mma(acc_k, dsa[k], QT::mnmajor(q_base, k), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
    if (more) {
      if (tid < BQ) sL[(s ^ 1) * BQ + tid] = next_stat;
      else if (tid < 2 * BQ) sD[(s ^ 1) * BQ + tid - BQ] = next_stat;
    }
    __syncthreads();  // stage s is free, and step it + 1's sL/sD are written
  }

  const long long row_base = static_cast<long long>(rb) * T_len;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int j = i >> 2, hh = (i >> 1) & 1;
    const int row = krow0 + 8 * hh;
    if (row >= T_len) continue;
    const long long off = ((row_base + row) * H + h) * D + 8 * j + qcol0;
    store_bf16x2(dk + off, acc_k[i] * scale, acc_k[i + 1] * scale);
    store_bf16x2(dv + off, acc_v[i], acc_v[i + 1]);
  }
}

template <int D>
struct DqCfg {
  static constexpr int BQ = 64;  // query rows per block
  static constexpr int BK = 64;  // key rows per step
  using QT = Tile<D, BQ>;
  using KT = Tile<D, BK>;
  // Q, dO; two stages of (K, V); three mbarriers; 1024 B to align the base.
  static constexpr int SMEM = 2 * QT::BYTES + 4 * KT::BYTES + 3 * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(WG)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int B, int H, int T_len,
                         float scale, int causal) {
  using C = DqCfg<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BQ = C::BQ, BK = C::BK;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sDO = sQ + QT::BYTES;
  uint8_t* sK0 = sDO + QT::BYTES;  // stage s: K at sK0 + 2s·KT::BYTES, V after
  uint64_t* bars = reinterpret_cast<uint64_t*>(sK0 + 4 * KT::BYTES);

  const int bh = blockIdx.x;
  const int h = bh % H, rb = bh / H, r = rb / B, b = rb - r * B;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_end = causal ? min(T_len, q0 + BQ) : T_len;
  const int n_steps = (kv_end + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], 2 * QT::BYTES);
    QT::load(sQ, &mq, &bars[0], q0, h, b, r);
    QT::load(sDO, &mdo, &bars[0], q0, h, b, r);
    mbar_expect_tx(&bars[1], 2 * KT::BYTES);
    KT::load(sK0, &mk, &bars[1], 0, h, b, r);
    KT::load(sK0 + KT::BYTES, &mv, &bars[1], 0, h, b, r);
  }

  // This thread's query rows qrow0 and qrow0 + 8, key columns
  // kcol0 + 8j + {0, 1} of each K/V tile.
  const int qrow0 = q0 + 16 * warp + (lane >> 2);
  const int kcol0 = 2 * (lane & 3);
  const float* lse_bh = lse + static_cast<long long>(bh) * T_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * T_len;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = qrow0 + 8 * hh;
    lse2[hh] = row < T_len ? lse_bh[row] * kLog2e : 0.f;
    dl[hh] = row < T_len ? delta_bh[row] : 0.f;
  }
  const float scale2 = scale * kLog2e;

  float acc[D / 2], sc[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = dp[i] = 0.f;

  const uint32_t q_base = smem_addr(sQ), do_base = smem_addr(sDO);
  mbar_wait(&bars[0], 0);

  for (int it = 0; it < n_steps; ++it) {
    const int s = it & 1;
    const int k0 = it * BK;
    uint8_t* sK = sK0 + 2 * s * KT::BYTES;
    uint8_t* sV = sK + KT::BYTES;
    if (tid == 0 && it + 1 < n_steps) {  // stage s ^ 1 was released
      uint8_t* nK = sK0 + 2 * (s ^ 1) * KT::BYTES;
      mbar_expect_tx(&bars[1 + (s ^ 1)], 2 * KT::BYTES);
      KT::load(nK, &mk, &bars[1 + (s ^ 1)], k0 + BK, h, b, r);
      KT::load(nK + KT::BYTES, &mv, &bars[1 + (s ^ 1)], k0 + BK, h, b, r);
    }
    mbar_wait(&bars[1 + s], (it >> 1) & 1);

    const uint32_t k_base = smem_addr(sK), v_base = smem_addr(sV);
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      SS<BK>::mma(sc, QT::kmajor(q_base, k), KT::kmajor(k_base, k), k > 0);
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      SS<BK>::mma(dp, QT::kmajor(do_base, k), KT::kmajor(v_base, k), k > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS, bf16, packed as the A fragments of dQ += dS·K.
    const bool edge = (causal && k0 + BK > q0) || k0 + BK > T_len ||
                      q0 + BQ > T_len;
    uint32_t dsa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int j = i >> 2, hh = (i >> 1) & 1;
      const int row = qrow0 + 8 * hh;
      const int kc = k0 + 8 * j + kcol0;
      float p0 = exp2_approx(fmaf(sc[i], scale2, -lse2[hh]));
      float p1 = exp2_approx(fmaf(sc[i + 1], scale2, -lse2[hh]));
      if (edge) {  // the causal mask (P = exp(NEG_INF − lse) = 0), ragged T
        const bool qin = row < T_len;
        if (!qin || kc >= T_len || (causal && kc > row)) p0 = 0.f;
        if (!qin || kc + 1 >= T_len || (causal && kc + 1 > row)) p1 = 0.f;
      }
      dsa[j >> 1][2 * (j & 1) + hh] =
          pack_bf16(p0 * (dp[i] - dl[hh]), p1 * (dp[i + 1] - dl[hh]));
    }

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      RS<D>::mma(acc, dsa[k], KT::mnmajor(k_base, k), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // stage s is free for the load of step it + 2
  }

  const long long row_base = static_cast<long long>(rb) * T_len;
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int j = i >> 2, hh = (i >> 1) & 1;
    const int row = qrow0 + 8 * hh;
    if (row >= T_len) continue;
    store_bf16x2(dq + ((row_base + row) * H + h) * D + 8 * j + kcol0,
                 acc[i] * scale, acc[i + 1] * scale);
  }
}

// --- host side ---------------------------------------------------------------

struct Sm90Args {
  const void *q, *k, *v, *dout;
  const long long *sq, *sk, *sv, *sdo;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int R, B, T_len, H;
  bool causal;
};

template <int D>
cudaError_t launch(const Sm90Args& a, bool dkv, cudaStream_t stream,
                   int* encode_status) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  // dk/dv reads K, V in 64-row tiles and Q, dO in BQ-row tiles; dq reads Q,
  // dO and K, V in 64-row tiles.
  const int q_rows = dkv ? DkvCfg<D>::BQ : 64;
  CUtensorMap mq, mk, mv, mdo;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    const long long* strides;
    int rows;
  } maps[4] = {{&mq, a.q, a.sq, q_rows},
               {&mk, a.k, a.sk, 64},
               {&mv, a.v, a.sv, 64},
               {&mdo, a.dout, a.sdo, q_rows}};
  for (const auto& m : maps) {
    const CUresult res = make_map(m.map, m.ptr, m.strides, a.R, a.B, a.T_len,
                                  a.H, D, m.rows);
    if (res != CUDA_SUCCESS) {
      *encode_status = static_cast<int>(res);
      return cudaErrorInvalidValue;
    }
  }
  const dim3 grid(a.R * a.B * a.H, (a.T_len + 63) / 64);
  if (dkv) {
    constexpr int smem = DkvCfg<D>::SMEM;
    auto kernel = flash_dkv_sm90_kernel<D>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, WG, smem, stream>>>(
        mq, mk, mv, mdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.B, a.H, a.T_len, scale, a.causal);
  } else {
    constexpr int smem = DqCfg<D>::SMEM;
    auto kernel = flash_dq_sm90_kernel<D>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, WG, smem, stream>>>(mq, mk, mv, mdo, a.lse, a.delta,
                                       static_cast<bf16*>(a.dq), a.B, a.H,
                                       a.T_len, scale, a.causal);
  }
  return cudaSuccess;
}

}  // namespace

// The dq kernel (dkv false: writes dq) or the dk/dv kernel (dkv true: writes
// dk and dv) on bf16 operands. Strides are (r, b, t, h) of [R, B, T, H, D]
// operands in elements, D at stride 1; every base and stride must be a
// multiple of 16 bytes (the caller copies what is not). Launches on
// `stream` and returns the error of the set-up calls; a tensor map that
// cuTensorMapEncodeTiled refuses gives cudaErrorInvalidValue with its
// CUresult in *encode_status. The launch itself is checked by the caller.
cudaError_t flash_bwd_sm90_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, void* dk,
                                  void* dv, const long long* sq,
                                  const long long* sk, const long long* sv,
                                  const long long* sdo, int R, int B,
                                  int T_len, int H, int D, bool causal,
                                  bool dkv, cudaStream_t stream,
                                  int* encode_status) {
  const Sm90Args a{q,  k,   v,   dout, sq, sk, sv, sdo,   lse,
                   delta, dq, dk, dv, R,  B,  T_len, H, causal};
  *encode_status = 0;
  switch (D) {
    case 16:
      return launch<16>(a, dkv, stream, encode_status);
    case 32:
      return launch<32>(a, dkv, stream, encode_status);
    case 64:
      return launch<64>(a, dkv, stream, encode_status);
    case 128:
      return launch<128>(a, dkv, stream, encode_status);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fedml_tpu_torch
