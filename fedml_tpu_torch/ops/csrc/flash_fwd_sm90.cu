// Flash-attention forward in bf16 on Hopper's tensor cores (sm_90a): causal
// or full softmax attention with an online softmax; writes O and the row
// log-sum-exp.
//
// Replaces fedml_tpu/ops/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel reached through _fwd) for bf16 operands; f32 operands take the
// split-TF32 kernel of flash_fwd.cu.
// Same arithmetic as the TPU kernel, up to exp: S = (Q·Kᵀ)·scale with
// scale = 1/√D, the causal mask at NEG_INF = -1e30, a running row max m and
// sum l in f32, P rounded to bf16 before P·V (p.astype(v.dtype)) while l
// sums the unrounded P, the l = 0 guard, lse = m + log(l) in natural log
// (flash_dq_sm90/flash_dkv_sm90 read it as lse·log2e). The exponentials are
// ex2.approx of the scores scaled by scale·log2e, as in the backward
// kernels. Keys at or past T (which the TPU kernel never sees: its T is a
// block multiple) weigh exactly 0 (score −inf). No sum crosses blocks: a
// rerun gives the same bits.
//
// What bounds it on an H100: at the FedAdapter shape (R·B = 16, T = 2048,
// H = 8, D = 64, causal) the two products Q·Kᵀ and P·V are 68.7 GFLOP
// against ~34 MB of operands, far above the card's ~295 bf16 operations
// per byte, so it is bound by operations at the bf16 tensor-core rate (989
// TFLOP/s). The FMA kernel it replaced for bf16 reached ~22 TFLOP/s on the
// FP32 pipes; what this design does about what held it back:
// 1. No tensor cores: both products are wgmma (m64nNk16, bf16 in, f32
//    sums), issued by one warpgroup per block.
// 2. Operands widened to f32 in shared memory by scalar loads: Q, K and V
//    stay bf16 and arrive by TMA in the swizzled layout that the wgmma
//    descriptors read (flash_sm90.cuh Tile).
// 3. No overlap of load and compute: K/V tiles come through a ring of two
//    stages with one mbarrier each; the next tile's TMA load is in flight
//    while the current one computes.
// 4. P through shared memory, and 16-lane shuffles for the row max and
//    sum: a row of the m64n64 score fragment lives in one quad of 4 lanes,
//    so the row max is two __shfl_xor steps; the row sum l stays a
//    per-thread partial (every lane of a quad rescales by the same factor)
//    and is summed over the quad once, at the end. P̃ goes from the exponent
//    to the P·V wgmma in registers: the accumulator fragment, packed in bf16
//    pairs, is the A fragment of the RS product (wgmma_sm90.cuh).
// 5. Causal tail: Q tiles run from T down on blockIdx.y (a Q tile near T
//    walks the most K/V tiles), every head of one tile index before the
//    next.
//
// Design: one block of one warpgroup per (r·b·h, 64 query rows). Q is
// loaded once by TMA and stays in shared memory. The loop walks the K/V
// tiles (64 rows) up to the diagonal: S = Q·Kᵀ as an SS wgmma (Q and K
// K-major), the mask only in tiles that touch the diagonal or T, the online
// softmax in the accumulator registers, then O += P̃·V as an RS wgmma with V
// read MN-major. The S group is waited on before O is rescaled, and the P·V
// group before the stage is released. Thread 0 issues the TMA loads; the
// tensor maps are 5-D over the operands' [R, B, T, H, D] strides, so MHA's
// qkv views and the vmapped client dim next to T take no copy, and TMA's
// zero fill covers the ragged end of T. O is contiguous [R, B, T, H, D]
// bf16 (rows at or past T are not written); lse is contiguous [R, B, H, T]
// f32.

#include "flash_sm90.cuh"

namespace fedml_tpu_torch {
namespace {

using namespace sm90;

constexpr float kLn2 = 0.6931471805599453f;
// The TPU kernel's NEG_INF = -1e30 on the natural-log scale, here on the
// log2 scale of the scaled scores.
constexpr float kMasked = -1e30f * kLog2e;

template <int D>
struct FwdCfg {
  static constexpr int BQ = 64;  // query rows per block
  static constexpr int BK = 64;  // key rows per step
  using QT = Tile<D, BQ>;
  using KT = Tile<D, BK>;
  // Q; two stages of (K, V); three mbarriers; 1024 B to align the base.
  static constexpr int SMEM = QT::BYTES + 4 * KT::BYTES + 3 * 8 + 1024;
};

// Max over the 4 lanes of a quad (one row of the accumulator fragment).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(WG)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          bf16* __restrict__ o, float* __restrict__ lse, int B,
                          int H, int T_len, float scale, int causal) {
  using C = FwdCfg<D>;
  using QT = typename C::QT;
  using KT = typename C::KT;
  constexpr int BQ = C::BQ, BK = C::BK;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK0 = sQ + QT::BYTES;  // stage s: K at sK0 + 2s·KT::BYTES, V after
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
    mbar_expect_tx(&bars[0], QT::BYTES);
    QT::load(sQ, &mq, &bars[0], q0, h, b, r);
    mbar_expect_tx(&bars[1], 2 * KT::BYTES);
    KT::load(sK0, &mk, &bars[1], 0, h, b, r);
    KT::load(sK0 + KT::BYTES, &mv, &bars[1], 0, h, b, r);
  }

  // This thread's query rows qrow0 and qrow0 + 8, key columns
  // kcol0 + 8j + {0, 1} of each K/V tile.
  const int qrow0 = q0 + 16 * warp + (lane >> 2);
  const int kcol0 = 2 * (lane & 3);
  const float scale2 = scale * kLog2e;

  // m on the log2 scale of the scaled scores; l this thread's share of the
  // row sum (its 16 key columns of each tile).
  float acc[D / 2], sc[BK / 2], m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;

  const uint32_t q_base = smem_addr(sQ);
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
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      SS<BK>::mma(sc, QT::kmajor(q_base, k), KT::kmajor(k_base, k), k > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scaled scores, the mask (only in tiles that touch the diagonal or T)
    // and the row max of the tile.
    const bool edge = (causal && k0 + BK > q0) || k0 + BK > T_len;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int j = i >> 2, hh = (i >> 1) & 1;
      float x = sc[i] * scale2;
      if (edge) {
        const int col = k0 + 8 * j + kcol0 + (i & 1);
        if (causal && col > qrow0 + 8 * hh) x = kMasked;
        if (col >= T_len) x = -INFINITY;  // ragged edge: no weight at all
      }
      sc[i] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
      corr[hh] = exp2_approx(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }

    // P̃ = exp(S − m) rounded to bf16 and packed as the A fragments of
    // O += P̃·V; l sums the unrounded P.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int j = i >> 2, hh = (i >> 1) & 1;
      const float p0 = exp2_approx(sc[i] - m[hh]);
      const float p1 = exp2_approx(sc[i + 1] - m[hh]);
      l[hh] += p0 + p1;
      pa[j >> 1][2 * (j & 1) + hh] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
      RS<D>::mma(acc, pa[k], KT::mnmajor(v_base, k), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();  // stage s is free for the load of step it + 2
  }

  const long long row_base = static_cast<long long>(rb) * T_len;
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lt = quad_sum(l[hh]);
    const float l_safe = lt > 0.f ? lt : 1.f;
    inv[hh] = 1.f / l_safe;
    const int row = qrow0 + 8 * hh;
    if ((lane & 3) == 0 && row < T_len)
      lse[static_cast<long long>(bh) * T_len + row] =
          m[hh] * kLn2 + logf(l_safe);
  }
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int j = i >> 2, hh = (i >> 1) & 1;
    const int row = qrow0 + 8 * hh;
    if (row >= T_len) continue;
    store_bf16x2(o + ((row_base + row) * H + h) * D + 8 * j + kcol0,
                 acc[i] * inv[hh], acc[i + 1] * inv[hh]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const long long* sq, const long long* sk,
                   const long long* sv, int R, int B, int T_len, int H,
                   bool causal, cudaStream_t stream, int* encode_status) {
  CUtensorMap mq, mk, mv;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    const long long* strides;
  } maps[3] = {{&mq, q, sq}, {&mk, k, sk}, {&mv, v, sv}};
  for (const auto& m : maps) {
    const CUresult res =
        make_map(m.map, m.ptr, m.strides, R, B, T_len, H, D, 64);
    if (res != CUDA_SUCCESS) {
      *encode_status = static_cast<int>(res);
      return cudaErrorInvalidValue;
    }
  }
  constexpr int smem = FwdCfg<D>::SMEM;
  auto kernel = flash_fwd_sm90_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid(R * B * H, (T_len + 63) / 64);
  kernel<<<grid, WG, smem, stream>>>(mq, mk, mv, static_cast<bf16*>(o), lse,
                                     B, H, T_len, scale, causal);
  return cudaSuccess;
}

}  // namespace

// The forward on bf16 operands. Strides are (r, b, t, h) of [R, B, T, H, D]
// operands in elements, D at stride 1; every base and stride must be a
// multiple of 16 bytes (the caller copies what is not). Launches on
// `stream` and returns the error of the set-up calls; a tensor map that
// cuTensorMapEncodeTiled refuses gives cudaErrorInvalidValue with its
// CUresult in *encode_status. The launch itself is checked by the caller.
cudaError_t flash_fwd_sm90_launch(const void* q, const void* k, const void* v,
                                  void* o, float* lse, const long long* sq,
                                  const long long* sk, const long long* sv,
                                  int R, int B, int T_len, int H, int D,
                                  bool causal, cudaStream_t stream,
                                  int* encode_status) {
  *encode_status = 0;
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, sq, sk, sv, R, B, T_len, H, causal,
                        stream, encode_status);
    case 32:
      return launch<32>(q, k, v, o, lse, sq, sk, sv, R, B, T_len, H, causal,
                        stream, encode_status);
    case 64:
      return launch<64>(q, k, v, o, lse, sq, sk, sv, R, B, T_len, H, causal,
                        stream, encode_status);
    case 128:
      return launch<128>(q, k, v, o, lse, sq, sk, sv, R, B, T_len, H, causal,
                         stream, encode_status);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace fedml_tpu_torch
