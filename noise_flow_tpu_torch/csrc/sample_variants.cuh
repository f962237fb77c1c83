// The fused sampler's template (sample_kernel.cuh) in one precision, with
// the ablations and designs that attribute its time: the Hopper
// counterparts of the TPU probes experiments/kernel_probe.py (make_kernel:
// base, notrans, noshift, nocoupnn, interleave, block sizes) and
// experiments/kernel_sweep.py (make_variant_kernel: concat-K, two streams,
// pre-cast bfloat16 weights). A source defines VARIANT_BF (1 for bfloat16,
// 0 for float32) and includes this file; each precision is a library of its
// own so that their nvcc runs go in parallel.
// noise_flow_tpu_torch/probes/sampler.py drives them.

#pragma once

#include "sample_kernel.cuh"

// nf_fused_sample of fused_sample.cu (its arguments but bf16) as variant
// (abl, design, ppt): an Ablation, DESIGN_* bits and the pixels a thread.
// The instantiated variants: ABL_FULL at 2, 4 and 8 pixels a thread; every
// ablation at 4; DESIGN_INTERLEAVE, DESIGN_CONCAT_K and both at 4; in
// bfloat16 also DESIGN_PRECAST and all three designs. Any other variant is
// refused (cudaErrorInvalidValue). Sets *launched to the launches it issued
// and returns the first launch error, 0 if none.
extern "C" int nf_sample_variant(int abl, int design, int ppt, const float* eps, float* out,
                                 const float* clean, const float* sa, const float* sb,
                                 const float* mixes, const float* coup, float* part, float* mom,
                                 int B, int n_scale, int bt, int batch_bn, const int* ops,
                                 int n_ops, int use_rng, unsigned seed, float temp,
                                 void* stream, int* launched) {
  *launched = 0;
  if (use_rng) eps = nullptr;
  Args a;
  const int err = chain_args(a, eps, out, clean, sa, sb, mixes, coup, mom, B, n_scale, bt,
                             batch_bn, ops, n_ops, use_rng, seed, temp);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr bool BF = VARIANT_BF != 0;
#define SAMPLE_VARIANT(A, D, P)                                                 \
  if (abl == (A) && design == (D) && ppt == (P))                                \
    return launch_chain<BF, (A), (D), (P)>(a, eps, part, ops, n_ops, s, launched);
  SAMPLE_VARIANT(ABL_FULL, DESIGN_PROD, 4)
  SAMPLE_VARIANT(ABL_FULL, DESIGN_PROD, 2)
  SAMPLE_VARIANT(ABL_FULL, DESIGN_PROD, 8)
  SAMPLE_VARIANT(ABL_NOTRANS, DESIGN_PROD, 4)
  SAMPLE_VARIANT(ABL_NOSHIFT, DESIGN_PROD, 4)
  SAMPLE_VARIANT(ABL_NOCOUPNN, DESIGN_PROD, 4)
  SAMPLE_VARIANT(ABL_FULL, DESIGN_INTERLEAVE, 4)
  SAMPLE_VARIANT(ABL_FULL, DESIGN_CONCAT_K, 4)
  SAMPLE_VARIANT(ABL_FULL, DESIGN_CONCAT_K | DESIGN_INTERLEAVE, 4)
#if VARIANT_BF
  SAMPLE_VARIANT(ABL_FULL, DESIGN_PRECAST, 4)
  SAMPLE_VARIANT(ABL_FULL, DESIGN_CONCAT_K | DESIGN_INTERLEAVE | DESIGN_PRECAST, 4)
#endif
#undef SAMPLE_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}
