// Fused Noise Flow sampler for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel noise_flow_tpu/ops/pallas_sample.py
// `_make_kernel` (launched by `_pallas_sample_padded`): the whole sampling
// chain, latent -> noise, for 32x32x4 patches in NHWC layout. The chain is
// the program of noise_flow_tpu_torch/ops/fused_sample.py: mix ops (4x4
// channel matrix), scale ops (x *= sqrt(a*clean + b), per-example a, b) and
// affine couplings
//   h1 = relu(BN(conv3x3(x[..., 0:2]) + b1))        2 -> 4 channels
//   h2 = relu(BN(h1 @ w2 + b2))                      4 -> 4
//   t  = zeroconv3x3(h2) (+ indicator taps + bias)   4 -> 4
//   x[..., 2:4] = (x[..., 2:4] - t[0:2]) * exp(-rescale * tanh(t[2:4]))
//
// What bounds it: at the published arch every coupling does about 248
// useful multiply-adds per pixel, about 4.1 MFLOP per patch in all, against
// 48 KiB of device memory traffic per patch (eps and clean in, noise out).
// That is about 85 FLOP per byte, above the H100's float32 ridge of about 20
// (67 TFLOP/s over 3.35 TB/s), so the float32 CUDA-core rate bounds it.
//
// What the design does about that: one CTA per patch keeps the patch in
// registers and shared memory for the whole chain, so device memory sees the
// 48 KiB and nothing else in running-BN mode. The TPU kernel's 128-lane banded
// matmuls (about 3% of their FLOPs useful) are not carried over: threads own
// pixels and do only the useful float32 FMAs, each thread 4 pixels of one
// column so a weight read once feeds 4 pixels. 3x3 taps read neighbours from
// shared memory with zero fill at the patch border (SAME padding; the
// zero-conv's edge-indicator channel adds its own weights exactly where a tap
// falls outside the patch).
//
// BatchNorm with batch statistics (the reference wrapper's default) needs,
// at each of a coupling's two BNs, the moments over a group of `bt` patches,
// i.e. over up to 256 CTAs. The kernel is then run stage by stage: for every
// coupling, four statistics launches (mean and variance of each BN, two-pass)
// and one apply launch, each CTA writing one partial sum per channel in a
// fixed order and the next launch reducing the group's partials in a fixed
// order (no float atomics: results are the same from run to run). The chain
// state between launches lives in `out`. Patches past the end of the batch
// do not exist here, so nothing but real patches enters a group's moments.
//
// In-kernel RNG mode (the TPU kernel's use_prng branch, pallas_sample.py
// `_make_kernel` with `_box_muller`): the chain input is drawn in registers
// as normals(seed) * temp, in place of the read of eps, so device memory sees
// 32 KiB a patch (clean in, noise out) in running-BN mode. The bits come from
// a counter-based Philox-4x32-10 and are a pure function of (seed, patch,
// row, channel), so every launch that starts from the chain input (the first
// coupling's five batch-BN launches) draws the same numbers again, at 4
// Philox calls and 8 Box-Muller pairs a thread, with no buffer for them.
// Counter and key, shared with rng_normals_reference in ops/fused_sample.py:
//   key     = (seed, 0)
//   counter = (32 * h + w, patch, j, 0),  h in [0, 16), w in [0, 32), j in {0, 1}
// Output word c of j = 0 is bits1 and of j = 1 is bits2 for channel c at
// (h, w). Box-Muller as JAX's `_box_muller`: u1 = (bits1 >> 8) * 2^-24 +
// 2^-25, u2 = (bits2 >> 8) * 2^-24, r = sqrt(-2 log u1), th = 2 pi u2; row h
// takes r cos th, row h + 16 takes r sin th. The patch is the index in the
// batch and the seed is the key, so seed s + 1 shares no stream with seed s.
//
// bfloat16 mode (the TPU kernel's mm_dtype=bf16, make_sampler's default):
// every product of a mix or a convolution takes both operands rounded to
// bfloat16 (round to nearest even) and keeps the FMA in float32. A product of
// two bfloat16 values is exact in float32, so this is the TPU kernel's
// arithmetic (bf16 operands, float32 accumulation) in another summation
// order. The rounded operands are the chain state at a mix and at conv1, the
// hidden maps at conv2 and the zero-conv, and the weights (BN-folded in
// running mode); biases, the indicator taps, the batch-BN moments (float32 in
// the TPU kernel too) and the coupling update stay float32. It is a
// compile-time parameter of sample_kernel.
//
// The kernel's template, its device helpers and the stage-by-stage launcher
// live in sample_kernel.cuh; this file instantiates the production kernel
// (ABL_FULL, DESIGN_PROD, PPT_PROD) only. The probe library
// (sample_variants.cuh) instantiates the same template with the ablations
// and designs that attribute its time.

#include "sample_kernel.cuh"

namespace {

// The normals of `seed` times temp, as sample_kernel draws its chain input.
__global__ void __launch_bounds__(THREADS)
rng_kernel(float* out, unsigned seed, float temp) {
  const int tid = threadIdx.x;
  float4 x[PPT_PROD];
  draw_normals<PPT_PROD>(seed, blockIdx.x, tid / W, tid % W, temp, x);
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(blockIdx.x) * NPIX * 4);
#pragma unroll
  for (int k = 0; k < PPT_PROD; ++k) o[tid + THREADS * k] = x[k];
}

}  // namespace

// Writes normals(seed) * temp, [B, 32, 32, 4], in one launch: the numbers the
// RNG mode of nf_fused_sample starts its chain from. Returns the launch error.
extern "C" int nf_rng_normals(float* out, int B, unsigned seed, float temp,
                              void* stream) {
  if (B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rng_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(out, seed, temp);
  return static_cast<int>(cudaGetLastError());
}

// Runs the whole chain: eps (already scaled by the temperature) -> out; with
// use_rng != 0 the chain input is drawn in the kernel instead, normals(seed)
// * temp, and eps is not read (it may be null). bf16 != 0 runs the bfloat16
// mode (see the top of this file), 0 the float32 one. Running-BN mode is one
// launch. Batch-BN mode (batch_bn != 0) runs, for each coupling, four
// statistics launches and one apply launch, with BN groups of `bt`
// consecutive patches. `part` is scratch of 2*B*4 floats, `mom` of
// ceil(B/bt)*12 floats. Enqueues on `stream` without synchronising; sets
// `*launched` to the number of kernel launches it issued and returns the
// first launch error (cudaError_t), 0 if none.
extern "C" int nf_fused_sample(const float* eps, float* out, const float* clean,
                               const float* sa, const float* sb,
                               const float* mixes, const float* coup,
                               float* part, float* mom, int B, int n_scale,
                               int bt, int batch_bn, const int* ops, int n_ops,
                               int use_rng, unsigned seed, float temp, int bf16,
                               void* stream, int* launched) {
  *launched = 0;
  if (use_rng) eps = nullptr;  // every launch that starts the chain draws it
  Args a;
  const int err = chain_args(a, eps, out, clean, sa, sb, mixes, coup, mom, B, n_scale, bt,
                             batch_bn, ops, n_ops, use_rng, seed, temp);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_chain<true, ABL_FULL, DESIGN_PROD, PPT_PROD>(a, eps, part, ops, n_ops, s,
                                                               launched);
  return launch_chain<false, ABL_FULL, DESIGN_PROD, PPT_PROD>(a, eps, part, ops, n_ops, s,
                                                              launched);
}
