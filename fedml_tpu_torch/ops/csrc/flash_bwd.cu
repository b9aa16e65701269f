// Flash-attention backward on the FP32 pipes (sm_90a): dq, and dk with dv,
// from Q, K, V, dO, the forward's row log-sum-exp and δ = rowsum(dO∘O), for
// f32 operands. bf16 operands take the tensor-core kernels of
// flash_bwd_sm90.cu; the tensor cores have no full-f32 product, so f32
// stays here.
//
// Replaces fedml_tpu/ops/flash_attention.py::_dq_kernel and ::_dkv_kernel
// (the Pallas TPU kernels reached through _bwd) for f32. Same arithmetic:
// S = (Q·Kᵀ)·scale with scale = 1/√D, causal mask NEG_INF = -1e30,
// P = exp(S − lse), dP = dO·Vᵀ, dS = P∘(dP − δ) rounded to the input type
// before the products that use it (the TPU kernels' ds.astype(q.dtype)),
// P rounded to dO's type before Pᵀ·dO (p.astype(do.dtype)); dq = scale·dS·K,
// dk = scale·dSᵀ·Q, dv = P̃ᵀ·dO, all accumulated in f32. (The kernels are
// templated on the operand type; only f32 is instantiated.)
//
// What bounds them on an H100: at the FedAdapter training shape (R·B = 16,
// T = 2048, H = 8, D = 64, causal) dq recomputes S and dP and forms dS·K,
// three T²·D/2 products per head, and dk/dv four; that is ~100 and ~140
// GFLOP against ~35 MB of operands, far above the card's ~295 operations
// per byte, so both are bound by operations. They compute on the FP32
// pipes with FMA, so their ceiling is the 67 TFLOP/s FP32 rate. The design
// keeps every [T, T] matrix out of device memory (64 × 64 tiles of dS and
// P in shared memory), register-blocks each thread on 4 × 4 tiles of S and
// dP (four shared-memory loads feed eight FMAs) and on 4 × D/16 tiles of
// the outputs.
//
// Design. The TPU grid walks the contraction tiles in order and carries the
// sums in VMEM scratch; here a loop inside the block takes its place, so no
// sum crosses blocks, there are no atomics and a rerun gives the same bits.
// - flash_dq_kernel: one block per (r·b·h, 64-row Q tile). Q and dO stay in
//   shared memory; the loop walks the K/V tiles and, with causal masking,
//   stops at the diagonal tile.
// - flash_dkv_kernel: one block per (r·b·h, 64-row K/V tile). K and V stay
//   in shared memory; the loop walks the Q/dO tiles and, with causal
//   masking, starts at the diagonal tile. The thread tiles are laid out as
//   Sᵀ (key rows, query columns), so P̃ᵀ and dSᵀ go to shared memory in the
//   layout the two accumulating products read.
// Operands are read through their [R, B, T, H, D] strides (flash_common.cuh);
// rows and keys past T are masked here, so any T is taken.

#include "flash_common.cuh"

namespace fedml_tpu_torch {
namespace {

using namespace flash;

template <int D>
constexpr int dq_smem_floats() {
  return 4 * BM * (D + 1) + BM * LDP;
}

template <int D>
constexpr int dkv_smem_floats() {
  return 4 * BM * (D + 1) + 2 * BN * LDP + 2 * BM;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides sdo, int B,
                    int H, int T_len, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // dq columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BM * LD;
  float* sK = sDO + BM * LD;
  float* sV = sK + BN * LD;
  float* sDS = sV + BN * LD;  // [BM][LDP]

  const int bh = blockIdx.y;
  const Head hd(bh, B, H);
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // query rows tr + 16 i
  const int tc = tid & 15;  // key columns tc + 16 j, dq columns tc + 16 j

  const T* kb = hd.at(k, sk);
  const T* vb = hd.at(v, sv);
  load_tile<T, D>(sQ, hd.at(q, sq), sq.t, q0, T_len);
  load_tile<T, D>(sDO, hd.at(dout, sdo), sdo.t, q0, T_len);

  const float* lse_bh = lse + static_cast<long long>(bh) * T_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * T_len;
  float lse_r[4], delta_r[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    lse_r[i] = row < T_len ? lse_bh[row] : 0.f;
    delta_r[i] = row < T_len ? delta_bh[row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(T_len, q0 + BM) : T_len;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, kb, sk.t, k0, T_len);
    load_tile<T, D>(sV, vb, sv.t, k0, T_len);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(tr + 16 * i) * LD + d];
        ov[i] = sDO[(tr + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tc + 16 * j) * LD + d];
        vv[j] = sV[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tc + 16 * j;
        float x = s[i][j] * scale;
        if (causal && col > row) x = kNegInf;
        float p = expf(x - lse_r[i]);
        if (row >= T_len || col >= T_len) p = 0.f;  // ragged edge
        sDS[(tr + 16 * i) * LDP + tc + 16 * j] =
            round_to<T>(p * (dp[i][j] - delta_r[i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sDS[(tr + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sK[c * LD + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

  const long long rb = bh / H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr + 16 * i;
    if (row >= T_len) continue;
    T* out = dq + ((rb * T_len + row) * H + hd.h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[tc + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                     Strides sdo, int B, int H, int T_len, float scale,
                     int causal) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // dk/dv columns per thread

  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;
  float* sDO = sQ + BM * LD;
  float* sPT = sDO + BM * LD;    // P̃ᵀ [BN][LDP]
  float* sDST = sPT + BN * LDP;  // dSᵀ [BN][LDP]
  float* sL = sDST + BN * LDP;   // lse of the Q tile's rows
  float* sDl = sL + BM;          // δ of the Q tile's rows

  const int bh = blockIdx.y;
  const Head hd(bh, B, H);
  const int k0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // key rows tr + 16 i
  const int tc = tid & 15;  // query columns tc + 16 j, dk/dv columns tc + 16 j

  const T* qb = hd.at(q, sq);
  const T* dob = hd.at(dout, sdo);
  load_tile<T, D>(sK, hd.at(k, sk), sk.t, k0, T_len);
  load_tile<T, D>(sV, hd.at(v, sv), sv.t, k0, T_len);
  const float* lse_bh = lse + static_cast<long long>(bh) * T_len;
  const float* delta_bh = delta + static_cast<long long>(bh) * T_len;

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // BM == BN: the first Q tile with a row at or past k0 starts at k0.
  for (int q0 = causal ? k0 : 0; q0 < T_len; q0 += BM) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sQ, qb, sq.t, q0, T_len);
    load_tile<T, D>(sDO, dob, sdo.t, q0, T_len);
    if (tid < BM) {
      const int row = q0 + tid;
      sL[tid] = row < T_len ? lse_bh[row] : 0.f;
      sDl[tid] = row < T_len ? delta_bh[row] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // Sᵀ and dPᵀ: [key row][query column]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(tr + 16 * i) * LD + d];
        vv[i] = sV[(tr + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(tc + 16 * j) * LD + d];
        ov[j] = sDO[(tc + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = k0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tc + 16 * j;
        const int qrow = q0 + qc;
        float x = s[i][j] * scale;
        if (causal && krow > qrow) x = kNegInf;
        float p = expf(x - sL[qc]);
        if (qrow >= T_len || krow >= T_len) p = 0.f;  // ragged edge
        sPT[(tr + 16 * i) * LDP + qc] = round_to<T>(p);
        sDST[(tr + 16 * i) * LDP + qc] = round_to<T>(p * (dp[i][j] - sDl[qc]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BM; ++c) {
      float pv[4], dsv[4], ov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sPT[(tr + 16 * i) * LDP + c];
        dsv[i] = sDST[(tr + 16 * i) * LDP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        ov[j] = sDO[c * LD + tc + 16 * j];
        qv[j] = sQ[c * LD + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qv[j], acc_k[i][j]);
        }
    }
  }

  const long long rb = bh / H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr + 16 * i;
    if (row >= T_len) continue;
    const long long off = ((rb * T_len + row) * H + hd.h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tc + 16 * j] = from_float<T>(acc_k[i][j] * scale);
      dv[off + tc + 16 * j] = from_float<T>(acc_v[i][j]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo;
  int R, B, T_len, H;
  int causal;
};

template <typename T, int D>
cudaError_t launch(const BwdArgs& a, bool dkv, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const int n_tiles = (a.T_len + BM - 1) / BM;
  const dim3 grid(n_tiles, a.R * a.B * a.H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if (dkv) {
    constexpr int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
    auto kernel = flash_dkv_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.sq, a.sk, a.sv, a.sdo, a.B, a.H, a.T_len,
        scale, a.causal);
  } else {
    constexpr int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
    auto kernel = flash_dq_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.sq, a.sk,
        a.sv, a.sdo, a.B, a.H, a.T_len, scale, a.causal);
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dtype(const BwdArgs& a, int D, bool dkv,
                         cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(a, dkv, stream);
    case 32:
      return launch<T, 32>(a, dkv, stream);
    case 64:
      return launch<T, 64>(a, dkv, stream);
    case 128:
      return launch<T, 128>(a, dkv, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const long long* sq, const long long* sk,
                  const long long* sv, const long long* sdo, int R, int B,
                  int T_len, int H, bool causal) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.sq = Strides{sq[0], sq[1], sq[2], sq[3]};
  a.sk = Strides{sk[0], sk[1], sk[2], sk[3]};
  a.sv = Strides{sv[0], sv[1], sv[2], sv[3]};
  a.sdo = Strides{sdo[0], sdo[1], sdo[2], sdo[3]};
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
// (r, b, t, h) of [R, B, T, H, D] f32 operands; lse and delta are
// [R, B, H, T]. bf16 operands go to flash_bwd_sm90.cu instead.
cudaError_t flash_dq_launch(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, const long long* sq,
                            const long long* sk, const long long* sv,
                            const long long* sdo, int R, int B, int T_len,
                            int H, int D, bool causal, cudaStream_t stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, delta, sq, sk, sv, sdo, R, B,
                        T_len, H, causal);
  a.dq = dq;
  return launch_dtype<float>(a, D, false, stream);
}

cudaError_t flash_dkv_launch(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const long long* sq, const long long* sk,
                             const long long* sv, const long long* sdo, int R,
                             int B, int T_len, int H, int D, bool causal,
                             cudaStream_t stream) {
  BwdArgs a = make_args(q, k, v, dout, lse, delta, sq, sk, sv, sdo, R, B,
                        T_len, H, causal);
  a.dk = dk;
  a.dv = dv;
  return launch_dtype<float>(a, D, true, stream);
}

}  // namespace fedml_tpu_torch
