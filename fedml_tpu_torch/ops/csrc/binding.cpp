// PyTorch binding of the port's CUDA kernels: the only source that includes
// PyTorch's headers. Each function checks its tensors, allocates the outputs,
// launches on PyTorch's current stream and checks the launch.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

namespace fedml_tpu_torch {
cudaError_t flash_fwd_launch(const void* q, const void* k, const void* v,
                             void* o, float* lse, const long long* sq,
                             const long long* sk, const long long* sv, int B,
                             int T_len, int H, int D, bool is_bf16,
                             bool causal, cudaStream_t stream);
}

namespace {

std::vector<torch::Tensor> flash_fwd(torch::Tensor q, torch::Tensor k,
                                     torch::Tensor v, bool causal) {
  TORCH_CHECK(q.is_cuda() && k.is_cuda() && v.is_cuda(),
              "flash_fwd: q, k, v must be CUDA tensors");
  TORCH_CHECK(q.device() == k.device() && q.device() == v.device(),
              "flash_fwd: q, k, v must be on one device");
  const auto st = q.scalar_type();
  TORCH_CHECK(st == torch::kFloat32 || st == torch::kBFloat16,
              "flash_fwd: dtype must be float32 or bfloat16, got ", st);
  TORCH_CHECK(k.scalar_type() == st && v.scalar_type() == st,
              "flash_fwd: q, k, v must share one dtype");
  TORCH_CHECK(q.dim() == 4, "flash_fwd: q must be [B, T, H, D]");
  TORCH_CHECK(k.sizes() == q.sizes() && v.sizes() == q.sizes(),
              "flash_fwd: q, k, v must have one shape");
  TORCH_CHECK(q.stride(3) == 1 && k.stride(3) == 1 && v.stride(3) == 1,
              "flash_fwd: the head dim must be contiguous (stride 1)");
  const int64_t B = q.size(0), T = q.size(1), H = q.size(2), D = q.size(3);
  TORCH_CHECK(D == 16 || D == 32 || D == 64 || D == 128,
              "flash_fwd: head dim must be 16, 32, 64 or 128, got ", D);
  TORCH_CHECK(B > 0 && T > 0 && H > 0, "flash_fwd: empty input");
  TORCH_CHECK(B * H <= 65535, "flash_fwd: B*H must be <= 65535");

  const c10::cuda::CUDAGuard guard(q.device());
  auto o = torch::empty({B, T, H, D}, q.options());
  auto lse = torch::empty({B, H, T}, q.options().dtype(torch::kFloat32));
  const long long sq[3] = {q.stride(0), q.stride(1), q.stride(2)};
  const long long sk[3] = {k.stride(0), k.stride(1), k.stride(2)};
  const long long sv[3] = {v.stride(0), v.stride(1), v.stride(2)};
  const cudaError_t err = fedml_tpu_torch::flash_fwd_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
      lse.data_ptr<float>(), sq, sk, sv, static_cast<int>(B),
      static_cast<int>(T), static_cast<int>(H), static_cast<int>(D),
      st == torch::kBFloat16, causal, at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == cudaSuccess, "flash_fwd: set-up failed: ",
              cudaGetErrorString(err));
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {o, lse};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd,
        "flash-attention forward: (q, k, v [B,T,H,D], causal) -> (o, lse)");
}
