// Adam's update of a list of float32 tensors in one launch, for NVIDIA Hopper
// (sm_90a), plain C interface.
//
// It replaces no TPU kernel: the JAX package leaves Adam to optax, which XLA
// fuses into the jitted step. The port's trainer stepped PyTorch's
// capturable multi-tensor Adam over the flow's 95 tiny tensors (2,433
// floats): 207 launches a step on the H100 (21 multi-tensor kernels, the
// rest one kernel a tensor, where a `_foreach_*` op falls back to per-tensor
// ops), 0.29 ms a step under a CUDA graph. This is one launch.
//
// The arithmetic is torch.optim.Adam's capturable multi-tensor path
// (torch/optim/adam.py, `_multi_tensor_adam`, capturable=True), op for op in
// float32, which is optax's adam:
//   t = step + 1                       (stored back into step)
//   m = lerp(m, g, 1 - b1) = m + (1 - b1) (g - m)
//   v = b2 v + (1 - b2) g^2
//   step_size = 1 / ((b1^t - 1) * inv_lr)        = -lr / (1 - b1^t)
//   p = p + m / ((sqrt(v) / sqrt(1 - b2^t) + eps) / step_size)
// No weight decay, amsgrad or maximize: the wrapper raises for them. Each of
// torch's ops is a kernel of its own that rounds its result to float32 in
// memory, and within one op nvcc contracts a product and a sum into a
// multiply-add; the intrinsics below (__fmul_rn, __fmaf_rn) round where
// torch's kernels round, and nvcc does not contract across them. torch's
// `_foreach_div_` by a number multiplies by its reciprocal, taken in double
// and rounded to float32 (inv_lr, from the caller): on the H100 a division
// by lr differed in the last bit in 10% of steps. So the kernel gives
// torch's bits (PERF.md section 6).
//
// Work and bound. 7 float32 streams of the tensors' elements (p, g, m, v
// read; p, m, v written): 68 KB for the flow, 0.02 us at 3.35 TB/s, far under
// one launch (0.0018 ms for an empty one on the H100). So the bound is one
// launch, and the design is for latency: one CTA a tensor, each thread an
// element (the flow's largest tensor has 180), its loads issued together,
// the bias corrections computed beside them from the tensor's own step
// count, no barrier but the one that orders the step count's read before its
// write. One CTA walking a prefix table of all the elements (1,024 threads,
// each finding its tensor by a binary search in shared memory) took 0.0058
// ms a step under a graph against this design's 0.0024 (PERF.md section 6),
// and was removed.
//
// The tensors' addresses and sizes travel in the launch's own parameters
// (AdamArgs, passed by value as a __grid_constant__), so a CUDA graph's
// capture records them with the launch and a replay reads the same tensors.
// CUDA 12.1 and later take up to 32,764 bytes of parameters on sm_90: 128
// tensors a launch (5,664 bytes); an older toolkit takes 4,096 bytes: 92
// tensors a launch (4,080 bytes). A longer list is split over as few
// launches as hold it.

#include <cuda_runtime.h>

namespace {

#if CUDART_VERSION >= 12010
constexpr int MAX_TENSORS = 128;
#else
constexpr int MAX_TENSORS = 92;
#endif
constexpr int THREADS = 256;

struct AdamArgs {
  float* p[MAX_TENSORS];
  const float* g[MAX_TENSORS];
  float* m[MAX_TENSORS];
  float* v[MAX_TENSORS];
  float* step[MAX_TENSORS];
  int n[MAX_TENSORS];
  int count;
  float inv_lr, b1, b2, omb1, omb2, eps;
};
static_assert(MAX_TENSORS % 2 == 0 && sizeof(AdamArgs) == 44 * MAX_TENSORS + 32,
              "parameter bytes");
static_assert(sizeof(AdamArgs) <= (CUDART_VERSION >= 12010 ? 32764 : 4096),
              "launch parameters");

__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ AdamArgs a) {
  const int i = blockIdx.x;
  float* const pp = a.p[i];
  const float* const gp = a.g[i];
  float* const mp = a.m[i];
  float* const vp = a.v[i];
  const float t = *a.step[i] + 1.0f;                              // _foreach_add_(steps, 1)
  // _foreach_pow, _sub_(1), _div_(lr), _reciprocal_: -lr / (1 - b1^t)
  const float step_size = 1.0f / __fmul_rn(powf(a.b1, t) - 1.0f, a.inv_lr);
  // _foreach_pow, _sub_(1), _neg_, _sqrt_: sqrt(1 - b2^t)
  const float bc2_sqrt = sqrtf(-(powf(a.b2, t) - 1.0f));
  for (int e = threadIdx.x; e < a.n[i]; e += THREADS) {
    const float g = gp[e];
    float p = pp[e], m = mp[e], v = vp[e];
    m = __fmaf_rn(a.omb1, g - m, m);                              // _lerp_, weight < 0.5
    v = __fmaf_rn(a.omb2, __fmul_rn(g, g), __fmul_rn(v, a.b2));   // _mul_, _addcmul_
    float d = sqrtf(v) / bc2_sqrt;                                // _sqrt, _div_
    d = d + a.eps;                                                // _add_
    d = d / step_size;                                            // _div_
    p = p + m / d;                                                // _addcdiv_
    pp[e] = p;
    mp[e] = m;
    vp[e] = v;
  }
  __syncthreads();   // every thread has read the step count
  if (threadIdx.x == 0) *a.step[i] = t;
}

}  // namespace

// Tensors a launch and the bytes of a launch's parameters, as built.
extern "C" int nf_adam_limits(int* tensors, int* param_bytes) {
  *tensors = MAX_TENSORS;
  *param_bytes = static_cast<int>(sizeof(AdamArgs));
  return 0;
}

// One Adam step over `count` float32 tensors: p[i], g[i], m[i], v[i] of n[i]
// contiguous elements each on the current device, step[i] a float32 scalar
// there (the step count, incremented). b1, b2, eps as torch's Adam takes
// them; inv_lr = 1 / lr, omb1 = 1 - b1 and omb2 = 1 - b2 computed by the
// caller in double and rounded, as torch rounds them. Launches
// ceil(count / MAX_TENSORS) kernels on `stream`, sets *launched to the number
// issued and returns the first launch error (cudaError_t), 0 if none.
extern "C" int nf_adam_step(void* const* p, void* const* g, void* const* m, void* const* v,
                            void* const* step, const int* n, int count, float inv_lr, float b1,
                            float b2, float omb1, float omb2, float eps, void* stream,
                            int* launched) {
  *launched = 0;
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i)
    if (n[i] < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  for (int base = 0; base < count; base += MAX_TENSORS) {
    AdamArgs a = {};
    a.count = count - base < MAX_TENSORS ? count - base : MAX_TENSORS;
    a.inv_lr = inv_lr;
    a.b1 = b1;
    a.b2 = b2;
    a.omb1 = omb1;
    a.omb2 = omb2;
    a.eps = eps;
    for (int i = 0; i < a.count; ++i) {
      a.p[i] = static_cast<float*>(p[base + i]);
      a.g[i] = static_cast<const float*>(g[base + i]);
      a.m[i] = static_cast<float*>(m[base + i]);
      a.v[i] = static_cast<float*>(v[base + i]);
      a.step[i] = static_cast<float*>(step[base + i]);
      a.n[i] = n[base + i];
    }
    adam_kernel<<<a.count, THREADS, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launched;
  }
  return 0;
}
