// Flash-attention backward for f32 operands on Hopper's tensor cores, in
// split TF32 (sm_90a): dq with δ = rowsum(dO∘O), then dk with dv, from Q, K,
// V, dO, O and the forward's row log-sum-exp. bf16 operands take the
// kernels of flash_bwd_sm90.cu.
//
// Replaces fedml_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels reached through _bwd) for f32, and the δ that
// _bwd computes before them. Same arithmetic: S = (Q·Kᵀ)·scale with scale =
// 1/√D, causal mask NEG_INF = -1e30, P = exp(S − lse), dP = dO·Vᵀ,
// dS = P∘(dP − δ); dq = scale·dS·K, dk = scale·dSᵀ·Q, dv = Pᵀ·dO, every
// product summed in f32. (The TPU kernels' roundings of dS and P to the
// input type before their products are no-ops in f32.)
//
// Each product runs on the tensor cores as three TF32 passes
// (mma.sync m16n8k8; flash_common.cuh): a·b ≈ a_hi·b_hi + a_hi·b_lo +
// a_lo·b_hi with a_hi = tf32(a), a_lo = tf32(a − a_hi), which keeps f32's
// accuracy (about 2⁻²¹ relative) where one TF32 pass keeps three digits.
//
// What bounds them on an H100: at the ViT's shape (R·B = 256, T = 64,
// H = 4, D = 32, full) each kernel moves ~51 MB (dq reads Q, K, V, dO and O
// and writes dq and δ; dk/dv reads Q, K, V, dO, lse and δ and writes dk and
// dv), 15 µs at 3.35 TB/s, against 3 × 0.8 and 3 × 1.1 GFLOP of TF32
// passes, 5 and 7 µs at 495 TFLOP/s: bound by bytes. At the FedAdapter
// shape in f32 (T = 2048, D = 64, causal) the products dominate and they
// are bound by operations.
//
// Design. One block of 4 warps per (r·b·h, 64-row tile), each warp owning
// 16 of the tile's rows; a loop inside the block walks the other operand's
// 64-row tiles, so no sum crosses blocks, there are no atomics and a rerun
// gives the same bits.
// - Tiles reach shared memory by cp.async in 16-byte pieces (4-byte pieces
//   for a head whose base or T stride is not a multiple of 16 bytes, chosen
//   per operand inside the kernel), at a pitch of D + 4 floats so every
//   fragment read is free of bank conflicts.
// - S and dP (Sᵀ and dPᵀ in dk/dv, whose rows are keys) are accumulated in
//   registers; P and dS are formed there and fed to the next product as its
//   A operand without leaving registers: the k index of each k8 step is
//   permuted (k t ↔ column 2t, k t + 4 ↔ column 2t + 1) so that the
//   accumulator fragment is the A fragment, and the B operand (K, Q or dO)
//   is read with the same permutation.
// - flash_dq_tf32_kernel: Q, dO and O of its rows stay resident; its
//   prologue computes δ of those rows from the dO and O tiles and writes it
//   contiguous [R, B, H, T] for the dk/dv kernel, launched after it on the
//   same stream. With causal masking the walk over K/V stops at the
//   diagonal tile.
// - flash_dkv_tf32_kernel: K and V stay resident; the walk over Q/dO (with
//   their lse and δ) starts at the diagonal tile with causal masking. It
//   takes the heads in the reverse of dq's order, so that, launched right
//   after dq, its first blocks find their operands in L2. Where
//   the dk and dv accumulators do not fit one warp's registers (D 128, and
//   D 64 in a walk) two warps share each 16-row group, one per output.
// - Each is built twice: for one tile a head (T <= 64, the ViT's launch;
//   one pass, 128 registers a thread, the copies in three groups in the
//   order the products use them, so the first product runs while the
//   later operands arrive) and for a walk over several (T > 64;
//   the walked tiles double-buffered so the next tile's copy runs under
//   this tile's products, and below D 128 each tile's sums formed apart and
//   added to the running sums in f32, so the tensor cores' own additions
//   chain over one tile, not the whole walk: on an H100 at T 2048, D 64,
//   causal, that keeps dk and dv within ~4e-6 of f32 rather than ~3e-5).
// - From D = 64 both form S and dP 32 columns at a time rather than 64, so
//   the accumulators and the fragments fit in registers.
// Operands are read through their [R, B, T, H, D] strides (flash_common.cuh);
// rows and keys past T are zero-filled and masked, so any T is taken.

#include "flash_common.cuh"

namespace fedml_tpu_torch {
namespace {

using namespace flash;

// dq: δ of the block's rows, then tiles [Q][dO][K0][V0][K1 | O][V1]; one
// stage (5 tiles) when the walk is one tile long.
template <int D>
constexpr int dq_smem_bytes(int stages) {
  return (BM + (stages == 2 ? 6 : 5) * tile_floats<D>()) *
         static_cast<int>(sizeof(float));
}

// dk/dv: tiles [K][V], then per stage [Q][dO] and the rows' lse and δ.
template <int D>
constexpr int dkv_stage_floats() {
  return 2 * tile_floats<D>() + 2 * BM;
}
template <int D>
constexpr int dkv_smem_bytes(int stages) {
  return (2 * tile_floats<D>() + stages * dkv_stage_floats<D>()) *
         static_cast<int>(sizeof(float));
}

// NB: the 8-column blocks of S and dP formed at a time (fewer at a larger
// D, so the fragments and the D-wide accumulators fit in registers). WALK:
// T > 64, so the loop may walk more than one tile: double-buffered tiles,
// and each tile's sums kept apart before they join the running sums (PART;
// not at D 128, where the registers hold no second set of accumulators).
// One tile a head (the ViT's launch) asks for 4 blocks an SM, 128 registers
// a thread, where its fragments fit; a walk for 1, which leaves it up to 255
// for its accumulators and their per-tile sums.
template <int D, int NB, bool WALK>
__global__ void __launch_bounds__(kThreads, !WALK && D <= 64 ? 4 : 1)
    flash_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ o,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, float* __restrict__ dq,
                         Strides sq, Strides sk, Strides sv, Strides sdo,
                         Strides so, int B, int H, int T_len, float scale,
                         int causal) {
  constexpr int P = tile_pitch<D>();
  constexpr int TILE = tile_floats<D>();

  extern __shared__ __align__(16) float smem[];
  float* sDl = smem;  // δ of the block's rows
  float* sQ = sDl + BM;
  float* sDO = sQ + TILE;
  // Stage st's K and V tiles; O shares stage 1's K tile, read by the
  // prologue before stage 1 is first filled.
  auto stage_k = [&](int st) { return sDO + (1 + 2 * st) * TILE; };
  auto stage_v = [&](int st) { return sDO + (2 + 2 * st) * TILE; };
  float* sO = stage_k(1);

  const int bh = blockIdx.y;
  const Head hd(bh, B, H);
  const int q0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const float* qb = hd.at(q, sq);
  const float* kb = hd.at(k, sk);
  const float* vb = hd.at(v, sv);
  const float* dob = hd.at(dout, sdo);
  const float* ob = hd.at(o, so);
  const bool kvec = rows_16b(kb, sk.t), vvec = rows_16b(vb, sv.t);
  auto load = [&](float* dst, const float* src, long long stride_t,
                  int from) {
    cp_tile<D, kThreads>(dst, src, stride_t, from, T_len,
                         rows_16b(src, stride_t));
  };
  // A walk: Q, dO and O, then K and V; δ first, before stage 1 (which O
  // shares) is filled. One tile: Q and K, then dO and V, then O, so S's
  // products run while dO, V and O arrive, and dP's while O does.
  if constexpr (WALK) {
    load(sQ, qb, sq.t, q0);
    load(sDO, dob, sdo.t, q0);
    load(sO, ob, so.t, q0);
    cp_async_commit();
    load(stage_k(0), kb, sk.t, 0);
    load(stage_v(0), vb, sv.t, 0);
    cp_async_commit();
  } else {
    load(sQ, qb, sq.t, q0);
    load(stage_k(0), kb, sk.t, 0);
    cp_async_commit();
    load(sDO, dob, sdo.t, q0);
    load(stage_v(0), vb, sv.t, 0);
    cp_async_commit();
    load(sO, ob, so.t, q0);
    cp_async_commit();
  }

  const long long row_base = static_cast<long long>(bh) * T_len;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float lse0 = row0 < T_len ? lse[row_base + row0] : 0.f;
  const float lse1 = row1 < T_len ? lse[row_base + row1] : 0.f;

  // δ = rowsum(dO∘O), two threads a row; then each thread's two rows' δ.
  float dl0, dl1;
  auto delta_rows = [&]() {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int at = r * P + half * (D / 2);
    const float4* x = reinterpret_cast<const float4*>(sDO + at);
    const float4* y = reinterpret_cast<const float4*>(sO + at);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float4 a = x[i], b = y[i];
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
      s = fmaf(a.z, b.z, s);
      s = fmaf(a.w, b.w, s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) {
      sDl[r] = s;
      if (q0 + r < T_len) delta[row_base + q0 + r] = s;
    }
    __syncthreads();
    dl0 = sDl[warp * 16 + g];
    dl1 = sDl[warp * 16 + g + 8];
  };
  if constexpr (WALK) {
    cp_async_wait<1>();
    __syncthreads();
    delta_rows();
  }

  constexpr bool PART = WALK && D < 128;
  float acc[D / 8][4], part[D / 8][4];
  zero_tile<D>(acc);
  zero_tile<D>(part);
  float (&sum)[D / 8][4] = PART ? part : acc;  // what the products add to

  const int kv_end = causal ? min(T_len, q0 + BM) : T_len;
  const int n_kv = WALK ? (kv_end + BN - 1) / BN : 1;
  for (int it = 0; it < n_kv; ++it) {
    if constexpr (WALK) {
      if (it + 1 < n_kv) {
        const int st = (it + 1) & 1;
        cp_tile<D, kThreads>(stage_k(st), kb, sk.t, (it + 1) * BN, T_len,
                             kvec);
        cp_tile<D, kThreads>(stage_v(st), vb, sv.t, (it + 1) * BN, T_len,
                             vvec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    const float* tK = stage_k(it & 1);
    const float* tV = stage_v(it & 1);
    const int k0 = it * BN;

#pragma unroll 1
    for (int c0 = 0; c0 < 8; c0 += NB) {  // key columns [8·c0, 8·c0 + 8·NB)
      const float* cK = tK + c0 * 8 * P;
      float s[NB][4], dp[NB][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      const bool first = !WALK && c0 == 0;  // waits on the staged copies
      if (first) {
        cp_async_wait<2>();
        __syncthreads();
      }
      rows_by_rows<D, NB>(s, sQ + warp * 16 * P, cK, g, t);
      if (first) {
        cp_async_wait<1>();
        __syncthreads();
      }
      rows_by_rows<D, NB>(dp, sDO + warp * 16 * P, tV + c0 * 8 * P, g, t);
      if (first) {
        cp_async_wait<0>();
        __syncthreads();
        delta_rows();
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? row0 : row1;
          const int col = k0 + (c0 + nb) * 8 + 2 * t + (e & 1);
          float x = s[nb][e] * scale;
          if (causal && col > row) x = kNegInf;
          float p = expf(x - (e < 2 ? lse0 : lse1));
          if (row >= T_len || col >= T_len) p = 0.f;  // ragged edge
          s[nb][e] = p * (dp[nb][e] - (e < 2 ? dl0 : dl1));  // dS
        }
      frag_by_rows<D, NB>(sum, s, cK, g, t);
    }
    if constexpr (PART) add_tile<D>(acc, part);
    if constexpr (WALK) __syncthreads();  // readers done before a refill
  }

  const long long rb = bh / H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row1 : row0;
    if (row < T_len)
      store_rows<D>(dq + ((rb * T_len + row) * H + hd.h) * D, acc, half,
                    scale, t);
  }
}

// NB, WALK, PART and the blocks an SM as flash_dq_tf32_kernel's, over query
// columns (4 blocks an SM to D 32 only). SPLIT (where
// the D-wide accumulators of dk and dv do not fit one warp's registers): 8
// warps, warps 0-3 accumulating dk and warps 4-7 dv for the same 16-row
// groups; each forms Sᵀ, only the dk warps dPᵀ.
template <int D, int NB, bool SPLIT, bool WALK>
__global__ void __launch_bounds__(SPLIT ? 2 * kThreads : kThreads,
                                  !WALK && D <= 32 ? 4 : 1)
    flash_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Strides sq, Strides sk, Strides sv, Strides sdo,
                          int B, int H, int T_len, float scale, int causal) {
  constexpr int P = tile_pitch<D>();
  constexpr int TILE = tile_floats<D>();
  constexpr int THREADS = SPLIT ? 2 * kThreads : kThreads;

  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + TILE;
  float* stage0 = sV + TILE;  // [Q][dO][lse][δ] per stage

  // The heads in the reverse of dq's order: the first blocks find in L2
  // the operands of the heads dq read last.
  const int bh = gridDim.y - 1 - blockIdx.y;
  const Head hd(bh, B, H);
  const int k0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp & 3;  // the warp's 16 key rows
  const bool k_side = !SPLIT || warp < 4;
  const int g = lane >> 2, t = lane & 3;

  const float* qb = hd.at(q, sq);
  const float* dob = hd.at(dout, sdo);
  const bool qvec = rows_16b(qb, sq.t), dovec = rows_16b(dob, sdo.t);
  const long long row_base = static_cast<long long>(bh) * T_len;
  const float* kb = hd.at(k, sk);
  const float* vb = hd.at(v, sv);
  auto load_k = [&]() {
    cp_tile<D, THREADS>(sK, kb, sk.t, k0, T_len, rows_16b(kb, sk.t));
  };
  auto load_v = [&]() {
    cp_tile<D, THREADS>(sV, vb, sv.t, k0, T_len, rows_16b(vb, sv.t));
  };
  // Q rows [q0, q0 + 64) with their lse and δ, and the dO rows, into stage
  // `st`.
  auto load_q = [&](int st, int q0) {
    float* base = stage0 + st * dkv_stage_floats<D>();
    cp_tile<D, THREADS>(base, qb, sq.t, q0, T_len, qvec);
    if (threadIdx.x < 2 * BM) {
      const int r = threadIdx.x & (BM - 1), row = q0 + r;
      const bool in = row < T_len;
      const float* src = (threadIdx.x < BM ? lse : delta) + row_base;
      cp_async<4>(base + 2 * TILE + threadIdx.x, src + (in ? row : 0),
                  in ? 4 : 0);
    }
  };
  auto load_do = [&](int st, int q0) {
    cp_tile<D, THREADS>(stage0 + st * dkv_stage_floats<D>() + TILE, dob,
                        sdo.t, q0, T_len, dovec);
  };

  // BM == BN: the first Q tile with a row at or past k0 starts at k0.
  const int qt0 = causal ? blockIdx.x : 0;
  const int n_q = WALK ? (T_len + BM - 1) / BM - qt0 : 1;
  // A walk: K and V, then each stage whole. One tile: K, Q, lse and δ,
  // then dO, then V, so Sᵀ's products run while dO and V arrive, and dv's
  // while V does.
  if constexpr (WALK) {
    load_k();
    load_v();
    cp_async_commit();
    load_q(0, qt0 * BM);
    load_do(0, qt0 * BM);
    cp_async_commit();
  } else {
    load_k();
    load_q(0, 0);
    cp_async_commit();
    load_do(0, 0);
    cp_async_commit();
    load_v();
    cp_async_commit();
  }

  // SPLIT: [0] this warp's dk or dv; else [0] dk and [1] dv.
  constexpr int NACC = SPLIT ? 1 : 2;
  constexpr bool PART = WALK && D < 128;
  float acc[NACC][D / 8][4], part[NACC][D / 8][4];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    zero_tile<D>(acc[i]);
    zero_tile<D>(part[i]);
  }
  float (&sum)[NACC][D / 8][4] = PART ? part : acc;

  const int krow0 = k0 + w * 16 + g, krow1 = krow0 + 8;
  for (int it = 0; it < n_q; ++it) {
    if constexpr (WALK) {
      if (it + 1 < n_q) {
        load_q((it + 1) & 1, (qt0 + it + 1) * BM);
        load_do((it + 1) & 1, (qt0 + it + 1) * BM);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    const float* tQ = stage0 + (it & 1) * dkv_stage_floats<D>();
    const float* tDO = tQ + TILE;
    const float* tL = tQ + 2 * TILE;
    const float* tDl = tL + BM;
    const int q0 = (qt0 + it) * BM;

#pragma unroll 1
    for (int c0 = 0; c0 < 8; c0 += NB) {  // query columns [8·c0, 8·c0 + 8·NB)
      const float* cQ = tQ + c0 * 8 * P;
      const float* cDO = tDO + c0 * 8 * P;
      // Sᵀ, then P̃ᵀ and dv's product, then dPᵀ, dSᵀ and dk's: dPᵀ is live
      // only for the last.
      float s[NB][4], dp[NB][4];  // [key row][query column]
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
      const bool first = !WALK && c0 == 0;  // waits on the staged copies
      if (first) {
        cp_async_wait<2>();
        __syncthreads();
      }
      rows_by_rows<D, NB>(s, sK + w * 16 * P, cQ, g, t);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int krow = e < 2 ? krow0 : krow1;
          const int qc = (c0 + nb) * 8 + 2 * t + (e & 1);
          const int qrow = q0 + qc;
          float x = s[nb][e] * scale;
          if (causal && krow > qrow) x = kNegInf;
          float p = expf(x - tL[qc]);
          if (qrow >= T_len || krow >= T_len) p = 0.f;  // ragged edge
          s[nb][e] = p;                                 // P̃ᵀ
        }
      if (first) {
        cp_async_wait<1>();
        __syncthreads();
      }
      if (!SPLIT || !k_side)
        frag_by_rows<D, NB>(sum[NACC - 1], s, cDO, g, t);
      if (first) {
        cp_async_wait<0>();
        __syncthreads();
      }
      if (k_side) {
        rows_by_rows<D, NB>(dp, sV + w * 16 * P, cDO, g, t);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = (c0 + nb) * 8 + 2 * t + (e & 1);
            dp[nb][e] = s[nb][e] * (dp[nb][e] - tDl[qc]);  // dSᵀ
          }
        frag_by_rows<D, NB>(sum[0], dp, cQ, g, t);
      }
    }
    if constexpr (PART) {
#pragma unroll
      for (int i = 0; i < NACC; ++i) add_tile<D>(acc[i], part[i]);
    }
    if constexpr (WALK) __syncthreads();  // readers done before a refill
  }

  const long long rb = bh / H;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? krow1 : krow0;
    if (row < T_len) {
      const long long off = ((rb * T_len + row) * H + hd.h) * D;
      if constexpr (SPLIT) {
        store_rows<D>((k_side ? dk : dv) + off, acc[0], half,
                      k_side ? scale : 1.f, t);
      } else {
        store_rows<D>(dk + off, acc[0], half, scale, t);
        store_rows<D>(dv + off, acc[1], half, 1.f, t);
      }
    }
  }
}

struct BwdArgs {
  const float *q, *k, *v, *dout, *o, *lse;
  float *delta, *dq, *dk, *dv;
  Strides sq, sk, sv, sdo, so;
  int R, B, T_len, H;
  int causal;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D, bool WALK>
cudaError_t launch(const BwdArgs& a, bool dkv, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const dim3 grid((a.T_len + BM - 1) / BM, a.R * a.B * a.H);
  constexpr int stages = WALK ? 2 : 1;
  if (dkv) {
    constexpr bool SPLIT = D == 128 || (WALK && D == 64);
    constexpr int NB = D >= 64 ? 4 : 8;
    auto kernel = flash_dkv_tf32_kernel<D, NB, SPLIT, WALK>;
    constexpr int smem = dkv_smem_bytes<D>(stages);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, SPLIT ? 2 * kThreads : kThreads, smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.sq, a.sk, a.sv,
        a.sdo, a.B, a.H, a.T_len, scale, a.causal);
  } else {
    constexpr int NB = D >= 64 ? 4 : 8;
    auto kernel = flash_dq_tf32_kernel<D, NB, WALK>;
    constexpr int smem = dq_smem_bytes<D>(stages);
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.o, a.lse, a.delta, a.dq, a.sq, a.sk, a.sv,
        a.sdo, a.so, a.B, a.H, a.T_len, scale, a.causal);
  }
  return cudaSuccess;
}

// One tile a head (T <= 64) or a walk over several.
template <int D>
cudaError_t launch(const BwdArgs& a, bool dkv, cudaStream_t stream) {
  return a.T_len > BM ? launch<D, true>(a, dkv, stream)
                      : launch<D, false>(a, dkv, stream);
}

cudaError_t launch_d(const BwdArgs& a, int D, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16>(a, dkv, stream);
    case 32:
      return launch<32>(a, dkv, stream);
    case 64:
      return launch<64>(a, dkv, stream);
    case 128:
      return launch<128>(a, dkv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const long long* sq,
                  const long long* sk, const long long* sv,
                  const long long* sdo, int R, int B, int T_len, int H,
                  bool causal) {
  BwdArgs a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.lse = lse;
  a.sq = strides(sq);
  a.sk = strides(sk);
  a.sv = strides(sv);
  a.sdo = strides(sdo);
  a.R = R;
  a.B = B;
  a.T_len = T_len;
  a.H = H;
  a.causal = causal;
  return a;
}

}  // namespace

// Both launch on `stream` and return the error of the set-up calls (the
// launch itself is checked by the caller with cudaGetLastError). Strides are
// (r, b, t, h) of [R, B, T, H, D] f32 operands; lse and delta are contiguous
// [R, B, H, T]. flash_dq_launch writes delta (from dO and O) for
// flash_dkv_launch, which must run after it on the same stream. bf16
// operands go to flash_bwd_sm90.cu instead.
cudaError_t flash_dq_launch(const void* q, const void* k, const void* v,
                            const void* dout, const void* o,
                            const float* lse, float* delta, void* dq,
                            const long long* sq, const long long* sk,
                            const long long* sv, const long long* sdo,
                            const long long* so, int R, int B, int T_len,
                            int H, int D, bool causal, cudaStream_t stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, sq, sk, sv, sdo, R, B, T_len, H,
                        causal);
  a.o = static_cast<const float*>(o);
  a.so = strides(so);
  a.delta = delta;
  a.dq = static_cast<float*>(dq);
  return launch_d(a, D, false, stream);
}

cudaError_t flash_dkv_launch(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const long long* sq, const long long* sk,
                             const long long* sv, const long long* sdo, int R,
                             int B, int T_len, int H, int D, bool causal,
                             cudaStream_t stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, sq, sk, sv, sdo, R, B, T_len, H,
                        causal);
  a.delta = const_cast<float*>(delta);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return launch_d(a, D, true, stream);
}

}  // namespace fedml_tpu_torch
