// PyTorch binding of the port's CUDA kernels: the only source that includes
// PyTorch's headers. Each function checks its tensors, allocates the outputs,
// launches on PyTorch's current stream and checks the launch. Numbers in a
// check's message go through std::to_string: on the card's build, a failed
// check that streamed an integer into its message crashed the process
// instead of raising.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

namespace fedml_tpu_torch {
cudaError_t flash_fwd_launch(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* sq,
                             const long long* sk, const long long* sv, int R,
                             int B, int T_len, int H, int D, bool causal,
                             cudaStream_t stream);
cudaError_t flash_fwd_sm90_launch(const void* q, const void* k, const void* v,
                                  void* o, float* lse, const long long* sq,
                                  const long long* sk, const long long* sv,
                                  int R, int B, int T_len, int H, int D,
                                  bool causal, cudaStream_t stream,
                                  int* encode_status);
cudaError_t flash_dq_launch(const void* q, const void* k, const void* v,
                            const void* dout, const void* o,
                            const float* lse, float* delta, void* dq,
                            const long long* sq, const long long* sk,
                            const long long* sv, const long long* sdo,
                            const long long* so, int R, int B, int T_len,
                            int H, int D, bool causal, cudaStream_t stream);
cudaError_t flash_dkv_launch(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const long long* sq, const long long* sk,
                             const long long* sv, const long long* sdo, int R,
                             int B, int T_len, int H, int D, bool causal,
                             cudaStream_t stream);
cudaError_t flash_bwd_sm90_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dq, void* dk,
                                  void* dv, const long long* sq,
                                  const long long* sk, const long long* sv,
                                  const long long* sdo, int R, int B,
                                  int T_len, int H, int D, bool causal,
                                  bool dkv, cudaStream_t stream,
                                  int* encode_status);
cudaError_t group_norm_fwd_launch(int R, int M, int S, int C, int G,
                                  float eps, const long long* sx,
                                  const long long* sy, const void* x,
                                  const float* gamma, const float* beta,
                                  void* y, bool is_bf16, bool* streamed,
                                  cudaStream_t stream);
cudaError_t group_norm_bwd_launch(int R, int M, int S, int C, int G,
                                  float eps, const long long* sx,
                                  const long long* sdy, const long long* sdx,
                                  const void* x, const void* dy,
                                  const float* gamma, void* dx,
                                  float* part_g, float* part_b, bool is_bf16,
                                  bool* streamed, cudaStream_t stream);
cudaError_t group_norm_plan(int S, int C, bool is_bf16, int tensors, int dev,
                            long long* out);
cudaError_t group_norm_reduce_launch(int R, int M, int C,
                                     const float* part_g,
                                     const float* part_b, float* dgamma,
                                     float* dbeta, cudaStream_t stream);
}

namespace {

// q, k, v (and dO) [R, B, T, H, D], bf16 or f32, D at stride 1 and the
// other dims at any stride.
void check_flash(const torch::Tensor& q, const torch::Tensor& k,
                 const torch::Tensor& v, const char* what) {
  TORCH_CHECK(q.is_cuda() && k.is_cuda() && v.is_cuda(), what,
              ": q, k, v must be CUDA tensors");
  TORCH_CHECK(q.device() == k.device() && q.device() == v.device(), what,
              ": q, k, v must be on one device");
  const auto st = q.scalar_type();
  TORCH_CHECK(st == torch::kFloat32 || st == torch::kBFloat16, what,
              ": dtype must be float32 or bfloat16, got ", st);
  TORCH_CHECK(k.scalar_type() == st && v.scalar_type() == st, what,
              ": q, k, v must share one dtype");
  TORCH_CHECK(q.dim() == 5, what, ": q must be [R, B, T, H, D]");
  TORCH_CHECK(k.sizes() == q.sizes() && v.sizes() == q.sizes(), what,
              ": q, k, v must have one shape");
  TORCH_CHECK(q.stride(4) == 1 && k.stride(4) == 1 && v.stride(4) == 1, what,
              ": the head dim must be contiguous (stride 1)");
  const int64_t D = q.size(4);
  TORCH_CHECK(D == 16 || D == 32 || D == 64 || D == 128, what,
              ": head dim must be 16, 32, 64 or 128, got ", std::to_string(D));
  TORCH_CHECK(q.numel() > 0, what, ": empty input");
  TORCH_CHECK(q.size(0) * q.size(1) * q.size(3) <= 65535, what,
              ": R*B*H must be <= 65535");
  TORCH_CHECK(q.size(2) <= 2147483647LL / 64, what, ": T too large");
}

void strides4(const torch::Tensor& t, long long* out) {
  for (int i = 0; i < 4; ++i) out[i] = t.stride(i);
}

// The f32 kernels (flash_fwd.cu and flash_bwd.cu, in split TF32 on the
// tensor cores) take f32 only; bf16 has flash_*_sm90.
void check_f32(const torch::Tensor& q, const char* what) {
  TORCH_CHECK(q.scalar_type() == torch::kFloat32, what,
              ": takes float32 only (bfloat16 goes to the *_sm90 kernels)");
}

std::vector<torch::Tensor> flash_fwd(torch::Tensor q, torch::Tensor k,
                                     torch::Tensor v, bool causal) {
  check_flash(q, k, v, "flash_fwd");
  check_f32(q, "flash_fwd");
  const int64_t R = q.size(0), B = q.size(1), T = q.size(2), H = q.size(3),
                D = q.size(4);
  const c10::cuda::CUDAGuard guard(q.device());
  auto o = torch::empty({R, B, T, H, D}, q.options());
  auto lse = torch::empty({R, B, H, T}, q.options().dtype(torch::kFloat32));
  long long sq[4], sk[4], sv[4];
  strides4(q, sq);
  strides4(k, sk);
  strides4(v, sv);
  const cudaError_t err = fedml_tpu_torch::flash_fwd_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
      lse.data_ptr<float>(), sq, sk, sv, R, B, T, H, D, causal,
      at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "flash_fwd: set-up failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {o, lse};
}

// The backward's extra operands: dO (and O) like q, lse (and delta)
// contiguous f32 [R, B, H, T].
void check_like_q(const torch::Tensor& q, const torch::Tensor& x,
                  const char* name, const char* what) {
  TORCH_CHECK(x.device() == q.device() && x.sizes() == q.sizes() &&
                  x.scalar_type() == q.scalar_type() && x.stride(4) == 1,
              what, ": ", name, " must match q in device, shape and dtype, "
              "with the head dim contiguous");
}

void check_rows(const torch::Tensor& q, const torch::Tensor& t,
                const char* what) {
  const std::vector<int64_t> rows{q.size(0), q.size(1), q.size(3), q.size(2)};
  TORCH_CHECK(t.device() == q.device() && t.scalar_type() == torch::kFloat32 &&
                  t.sizes() == c10::IntArrayRef(rows) && t.is_contiguous(),
              what, ": lse and delta must be contiguous float32 [R, B, H, T]");
}

void check_flash_bwd(const torch::Tensor& q, const torch::Tensor& k,
                     const torch::Tensor& v, const torch::Tensor& dout,
                     const torch::Tensor& lse, const torch::Tensor& delta,
                     const char* what) {
  check_flash(q, k, v, what);
  check_like_q(q, dout, "dO", what);
  check_rows(q, lse, what);
  check_rows(q, delta, what);
}

// (dq, delta): the dq kernel computes delta = rowsum(dO∘O) of its rows and
// writes it for flash_dkv, which the caller launches next on this stream.
std::vector<torch::Tensor> flash_dq(torch::Tensor q, torch::Tensor k,
                                    torch::Tensor v, torch::Tensor dout,
                                    torch::Tensor o, torch::Tensor lse,
                                    bool causal) {
  const char* what = "flash_dq";
  check_flash(q, k, v, what);
  check_f32(q, what);
  check_like_q(q, dout, "dO", what);
  check_like_q(q, o, "O", what);
  check_rows(q, lse, what);
  const c10::cuda::CUDAGuard guard(q.device());
  auto dq = torch::empty(q.sizes(), q.options());
  auto delta = torch::empty(lse.sizes(), lse.options());
  long long sq[4], sk[4], sv[4], sdo[4], so[4];
  strides4(q, sq);
  strides4(k, sk);
  strides4(v, sv);
  strides4(dout, sdo);
  strides4(o, so);
  const cudaError_t err = fedml_tpu_torch::flash_dq_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), o.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(), sq, sk,
      sv, sdo, so, q.size(0), q.size(1), q.size(2), q.size(3), q.size(4),
      causal, at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "flash_dq: set-up failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {dq, delta};
}

std::vector<torch::Tensor> flash_dkv(torch::Tensor q, torch::Tensor k,
                                     torch::Tensor v, torch::Tensor dout,
                                     torch::Tensor lse, torch::Tensor delta,
                                     bool causal) {
  check_flash_bwd(q, k, v, dout, lse, delta, "flash_dkv");
  check_f32(q, "flash_dkv");
  const c10::cuda::CUDAGuard guard(q.device());
  auto dk = torch::empty(k.sizes(), k.options());
  auto dv = torch::empty(v.sizes(), v.options());
  long long sq[4], sk[4], sv[4], sdo[4];
  strides4(q, sq);
  strides4(k, sk);
  strides4(v, sv);
  strides4(dout, sdo);
  const cudaError_t err = fedml_tpu_torch::flash_dkv_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(), dk.data_ptr(),
      dv.data_ptr(), sq, sk, sv, sdo, q.size(0), q.size(1), q.size(2),
      q.size(3), q.size(4), causal, at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "flash_dkv: set-up failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {dk, dv};
}

// The tensor-core kernels (flash_fwd_sm90.cu, flash_bwd_sm90.cu) take bf16
// operands whose base and (r, b, t, h) strides are multiples of 16 bytes,
// as TMA reads them; ops/flash_attention.py copies any other operand before
// the call.
void check_sm90(const torch::Tensor& t, const char* what) {
  TORCH_CHECK(t.scalar_type() == torch::kBFloat16, what,
              ": the tensor-core kernels take bfloat16 only");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, what,
              ": operand base must be 16-byte aligned for TMA");
  for (int i = 0; i < 4; ++i)
    TORCH_CHECK(t.size(i) == 1 || (t.stride(i) > 0 && t.stride(i) % 8 == 0),
                what, ": operand strides must be multiples of 16 bytes for "
                "TMA, got stride ", std::to_string(t.stride(i)), " in dim ",
                std::to_string(i));
}

// (o, lse) from the tensor-core forward (flash_fwd_sm90.cu).
std::vector<torch::Tensor> flash_fwd_sm90(torch::Tensor q, torch::Tensor k,
                                          torch::Tensor v, bool causal) {
  const char* what = "flash_fwd_sm90";
  check_flash(q, k, v, what);
  for (const auto* t : {&q, &k, &v}) check_sm90(*t, what);
  const int64_t R = q.size(0), B = q.size(1), T = q.size(2), H = q.size(3),
                D = q.size(4);
  const c10::cuda::CUDAGuard guard(q.device());
  auto o = torch::empty({R, B, T, H, D}, q.options());
  auto lse = torch::empty({R, B, H, T}, q.options().dtype(torch::kFloat32));
  long long sq[4], sk[4], sv[4];
  strides4(q, sq);
  strides4(k, sk);
  strides4(v, sv);
  int encode_status = 0;
  const cudaError_t err = fedml_tpu_torch::flash_fwd_sm90_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
      lse.data_ptr<float>(), sq, sk, sv, R, B, T, H, D, causal,
      at::cuda::getCurrentCUDAStream(), &encode_status);
  TORCH_CHECK(encode_status == 0, what,
              ": cuTensorMapEncodeTiled failed with CUresult ",
              std::to_string(encode_status));
  TORCH_CHECK(err == cudaSuccess, what, ": set-up failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {o, lse};
}

// dq (dkv false) or (dk, dv) (dkv true) from the tensor-core kernels.
std::vector<torch::Tensor> flash_bwd_sm90(
    const torch::Tensor& q, const torch::Tensor& k, const torch::Tensor& v,
    const torch::Tensor& dout, const torch::Tensor& lse,
    const torch::Tensor& delta, bool causal, bool dkv, const char* what) {
  check_flash_bwd(q, k, v, dout, lse, delta, what);
  for (const auto* t : {&q, &k, &v, &dout}) check_sm90(*t, what);
  const c10::cuda::CUDAGuard guard(q.device());
  std::vector<torch::Tensor> out;
  if (dkv) {
    out = {torch::empty(k.sizes(), k.options()),
           torch::empty(v.sizes(), v.options())};
  } else {
    out = {torch::empty(q.sizes(), q.options())};
  }
  long long sq[4], sk[4], sv[4], sdo[4];
  strides4(q, sq);
  strides4(k, sk);
  strides4(v, sv);
  strides4(dout, sdo);
  int encode_status = 0;
  const cudaError_t err = fedml_tpu_torch::flash_bwd_sm90_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
      lse.data_ptr<float>(), delta.data_ptr<float>(),
      dkv ? nullptr : out[0].data_ptr(), dkv ? out[0].data_ptr() : nullptr,
      dkv ? out[1].data_ptr() : nullptr, sq, sk, sv, sdo, q.size(0),
      q.size(1), q.size(2), q.size(3), q.size(4), causal, dkv,
      at::cuda::getCurrentCUDAStream(), &encode_status);
  TORCH_CHECK(encode_status == 0, what,
              ": cuTensorMapEncodeTiled failed with CUresult ",
              std::to_string(encode_status));
  TORCH_CHECK(err == cudaSuccess, what, ": set-up failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return out;
}

torch::Tensor flash_dq_sm90(torch::Tensor q, torch::Tensor k, torch::Tensor v,
                            torch::Tensor dout, torch::Tensor lse,
                            torch::Tensor delta, bool causal) {
  return flash_bwd_sm90(q, k, v, dout, lse, delta, causal, false,
                        "flash_dq_sm90")[0];
}

std::vector<torch::Tensor> flash_dkv_sm90(torch::Tensor q, torch::Tensor k,
                                          torch::Tensor v, torch::Tensor dout,
                                          torch::Tensor lse,
                                          torch::Tensor delta, bool causal) {
  return flash_bwd_sm90(q, k, v, dout, lse, delta, causal, true,
                        "flash_dkv_sm90");
}

// x [R, M, S, C] (bf16 or f32, C at stride 1); gamma/beta [R, C] f32.
void check_gn_input(const torch::Tensor& x, const torch::Tensor& gamma,
                    int64_t groups, const char* what) {
  TORCH_CHECK(x.is_cuda() && gamma.is_cuda(), what,
              ": tensors must be on a CUDA device");
  TORCH_CHECK(x.device() == gamma.device(), what,
              ": tensors must be on one device");
  const auto st = x.scalar_type();
  TORCH_CHECK(st == torch::kFloat32 || st == torch::kBFloat16, what,
              ": dtype must be float32 or bfloat16, got ", st);
  TORCH_CHECK(x.dim() == 4, what, ": x must be [R, M, S, C]");
  TORCH_CHECK(x.stride(3) == 1 || x.size(3) == 1, what,
              ": the channel dim must be contiguous (stride 1)");
  const int64_t R = x.size(0), M = x.size(1), S = x.size(2), C = x.size(3);
  TORCH_CHECK(R > 0 && M > 0 && S > 0 && C > 0, what, ": empty input");
  TORCH_CHECK(C <= 4096, what, ": at most 4096 channels, got ",
              std::to_string(C));
  TORCH_CHECK(groups > 0 && C % groups == 0, what, ": groups ",
              std::to_string(groups), " must divide channels ",
              std::to_string(C));
  TORCH_CHECK(R * M <= 2147483647LL && S * C <= 2147483647LL, what,
              ": too many samples or elements per sample");
  TORCH_CHECK(gamma.scalar_type() == torch::kFloat32 && gamma.dim() == 2 &&
                  gamma.size(0) == R && gamma.size(1) == C &&
                  gamma.is_contiguous(),
              what, ": gamma/beta must be contiguous float32 [R, C]");
}

void strides3(const torch::Tensor& t, long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = t.stride(i);
}

// (y, whether the streamed route ran): the route is the kernel's choice by
// shape, reported so the caller can count it.
std::tuple<torch::Tensor, bool> group_norm_fwd(torch::Tensor x,
                                               torch::Tensor gamma,
                                               torch::Tensor beta,
                                               int64_t groups, double eps) {
  check_gn_input(x, gamma, groups, "group_norm_fwd");
  TORCH_CHECK(beta.sizes() == gamma.sizes() &&
                  beta.scalar_type() == torch::kFloat32 &&
                  beta.is_contiguous() && beta.device() == x.device(),
              "group_norm_fwd: beta must match gamma");
  const c10::cuda::CUDAGuard guard(x.device());
  auto y = torch::empty_like(x);  // x's strides when x is dense
  TORCH_CHECK(y.stride(3) == 1 || y.size(3) == 1,
              "group_norm_fwd: output channel dim not contiguous");
  long long sx[3], sy[3];
  strides3(x, sx);
  strides3(y, sy);
  bool streamed = false;
  const cudaError_t err = fedml_tpu_torch::group_norm_fwd_launch(
      x.size(0), x.size(1), x.size(2), x.size(3), groups,
      static_cast<float>(eps), sx, sy, x.data_ptr(), gamma.data_ptr<float>(),
      beta.data_ptr<float>(), y.data_ptr(),
      x.scalar_type() == torch::kBFloat16, &streamed,
      at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "group_norm_fwd: launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return std::make_tuple(y, streamed);
}

// The plans of a sample of S x C elements on the current device, with
// `tensors` tensors to hold (1: the forward, 2: the backward): the cluster
// route's (CL, rows per block, tensors resident, shared memory bytes per
// block), all 0 when x does not fit in a cluster of 8, then the streamed
// route's (CL, rows of the block that owns the most, resident rows of x a
// block, resident rows of dy a block, shared memory bytes per block,
// clusters the card runs at once) for such a sample, else 0s.
std::vector<int64_t> group_norm_plan(int64_t S, int64_t C, bool is_bf16,
                                     int64_t tensors) {
  TORCH_CHECK(S > 0 && C > 0 && S * C <= 2147483647LL && C <= 4096 &&
                  (tensors == 1 || tensors == 2),
              "group_norm_plan: no plan for S ", std::to_string(S), ", C ",
              std::to_string(C), ", tensors ", std::to_string(tensors));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  long long out[10];
  if (err == cudaSuccess)
    err = fedml_tpu_torch::group_norm_plan(
        static_cast<int>(S), static_cast<int>(C), is_bf16,
        static_cast<int>(tensors), dev, out);
  TORCH_CHECK(err == cudaSuccess, "group_norm_plan: ",
              cudaGetErrorString(err));
  return std::vector<int64_t>(out, out + 10);
}

// (dx, dγ partials, dβ partials, whether the streamed route ran): the route
// is the kernel's choice by shape, reported so the caller can count it.
std::tuple<torch::Tensor, torch::Tensor, torch::Tensor, bool> group_norm_bwd(
    torch::Tensor x, torch::Tensor dy, torch::Tensor gamma, int64_t groups,
    double eps) {
  check_gn_input(x, gamma, groups, "group_norm_bwd");
  TORCH_CHECK(dy.device() == x.device() && dy.sizes() == x.sizes() &&
                  dy.scalar_type() == x.scalar_type(),
              "group_norm_bwd: dy must match x in device, shape and dtype");
  TORCH_CHECK(dy.stride(3) == 1 || dy.size(3) == 1,
              "group_norm_bwd: dy's channel dim must be contiguous");
  const bool is_bf16 = x.scalar_type() == torch::kBFloat16;
  const c10::cuda::CUDAGuard guard(x.device());
  auto dx = torch::empty_like(x);
  TORCH_CHECK(dx.stride(3) == 1 || dx.size(3) == 1,
              "group_norm_bwd: output channel dim not contiguous");
  const int64_t N = x.size(0) * x.size(1), C = x.size(3);
  auto opts = x.options().dtype(torch::kFloat32);
  auto part_g = torch::empty({N, C}, opts);
  auto part_b = torch::empty({N, C}, opts);
  long long sx[3], sdy[3], sdx[3];
  strides3(x, sx);
  strides3(dy, sdy);
  strides3(dx, sdx);
  bool streamed = false;
  const cudaError_t err = fedml_tpu_torch::group_norm_bwd_launch(
      x.size(0), x.size(1), x.size(2), C, groups, static_cast<float>(eps), sx,
      sdy, sdx, x.data_ptr(), dy.data_ptr(), gamma.data_ptr<float>(),
      dx.data_ptr(), part_g.data_ptr<float>(), part_b.data_ptr<float>(),
      is_bf16, &streamed, at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "group_norm_bwd: launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return std::make_tuple(dx, part_g, part_b, streamed);
}

// part_g/part_b [R·M, C] f32 → (dgamma, dbeta) [R, C] f32.
std::vector<torch::Tensor> group_norm_reduce(torch::Tensor part_g,
                                             torch::Tensor part_b, int64_t R) {
  TORCH_CHECK(part_g.is_cuda() && part_b.device() == part_g.device(),
              "group_norm_reduce: partials must be on one CUDA device");
  TORCH_CHECK(part_g.scalar_type() == torch::kFloat32 && part_g.dim() == 2 &&
                  part_g.is_contiguous() && part_b.sizes() == part_g.sizes() &&
                  part_b.scalar_type() == torch::kFloat32 &&
                  part_b.is_contiguous(),
              "group_norm_reduce: partials must be contiguous float32 [N, C]");
  const int64_t N = part_g.size(0), C = part_g.size(1);
  TORCH_CHECK(R > 0 && N % R == 0, "group_norm_reduce: R ",
              std::to_string(R), " must divide N ", std::to_string(N));
  const c10::cuda::CUDAGuard guard(part_g.device());
  auto dgamma = torch::empty({R, C}, part_g.options());
  auto dbeta = torch::empty({R, C}, part_g.options());
  const cudaError_t err = fedml_tpu_torch::group_norm_reduce_launch(
      R, N / R, C, part_g.data_ptr<float>(), part_b.data_ptr<float>(),
      dgamma.data_ptr<float>(), dbeta.data_ptr<float>(),
      at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "group_norm_reduce: launch failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {dgamma, dbeta};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd,
        "flash-attention forward in split TF32 (f32): (q, k, v [R,B,T,H,D], "
        "causal) -> (o [R,B,T,H,D], lse [R,B,H,T])");
  m.def("flash_fwd_sm90", &flash_fwd_sm90,
        "flash-attention forward on the tensor cores (bf16): (q, k, v "
        "[R,B,T,H,D], causal) -> (o [R,B,T,H,D], lse [R,B,H,T])");
  m.def("flash_dq", &flash_dq,
        "flash-attention dq in split TF32 (f32): (q, k, v, dO, O "
        "[R,B,T,H,D], lse [R,B,H,T], causal) -> (dq, delta [R,B,H,T])");
  m.def("flash_dkv", &flash_dkv,
        "flash-attention dk/dv in split TF32 (f32): (q, k, v, dO "
        "[R,B,T,H,D], lse, delta [R,B,H,T] from flash_dq, causal) -> (dk, "
        "dv)");
  m.def("flash_dq_sm90", &flash_dq_sm90,
        "flash-attention dq on the tensor cores (bf16): (q, k, v, dO "
        "[R,B,T,H,D], lse, delta [R,B,H,T], causal) -> dq");
  m.def("flash_dkv_sm90", &flash_dkv_sm90,
        "flash-attention dk/dv on the tensor cores (bf16): (q, k, v, dO "
        "[R,B,T,H,D], lse, delta [R,B,H,T], causal) -> (dk, dv)");
  m.def("group_norm_fwd", &group_norm_fwd,
        "GroupNorm forward: (x [R,M,S,C], gamma, beta [R,C], groups, eps) -> "
        "(y, whether the streamed route ran)");
  m.def("group_norm_plan", &group_norm_plan,
        "GroupNorm plans: (S, C, is_bf16, tensors) -> [CL, rows per block, "
        "tensors resident, shared memory bytes per block] of the cluster "
        "route (0s if x does not fit in a cluster of 8), then [CL, rows a "
        "block, resident rows of x, resident rows of dy, shared memory bytes, "
        "clusters at once] of the streamed route (0s unless x does not fit)");
  m.def("group_norm_bwd", &group_norm_bwd,
        "GroupNorm backward: (x, dy [R,M,S,C], gamma [R,C], groups, eps) -> "
        "(dx, dgamma partials [R*M,C], dbeta partials [R*M,C], whether the "
        "streamed route ran)");
  m.def("group_norm_reduce", &group_norm_reduce,
        "per-row sum of GroupNorm partials: (part_g, part_b [R*M,C], R) -> "
        "(dgamma, dbeta [R,C])");
}
