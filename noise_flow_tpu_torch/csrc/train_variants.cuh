// The train kernels' template (train_kernel.cuh) in one design and one
// precision, with the ablations that attribute its time: the part of the
// probe library that instantiates train_kernel (train_probe.cu holds the
// rest). A source defines VARIANT_DESIGN (DESIGN_PARENT or DESIGN_PROD) and
// VARIANT_BF (true for bfloat16) and includes this file; each design and
// precision is a library of its own so that their nvcc runs go in parallel.
// noise_flow_tpu_torch/probes/train_template.py drives them.
//
// Every entry sets *launched to the kernel launches it issued and returns
// the launch error (cudaError_t), 0 if none.

#pragma once

#include "train_kernel.cuh"

namespace {

template <int MODE, int ABL>
int launch_variant(StepArgs a, void* stream, int* launched) {
  return launch_train<MODE, VARIANT_BF, VARIANT_DESIGN, ABL>(a, stream, launched);
}

}  // namespace

// nf_train_scratch of fused_train.cu for this design.
extern "C" int nf_train_scratch(int mode, int B, int bt, int nc, int nm, int n_ops,
                                long long* sizes) {
  return train_scratch(mode, VARIANT_DESIGN, B, bt, nc, nm, n_ops, sizes);
}

// nf_train_step of fused_train.cu in this design and precision.
extern "C" int nf_variant_train_step(const float* x, const float* clean, const float* sa,
                                     const float* sb, const float* rec, const float* offs,
                                     const float* mixes, float* scratch_f4, float* scratch_f,
                                     float* wpart, float* rows, float* gsa, float* gsb,
                                     float* grad_w, float* goffs, float* bnmom, int B, int bt,
                                     int ns, int nc, int nm, float invb, float gl,
                                     const int* ops, int n_ops, void* stream, int* launched) {
  *launched = 0;
  StepArgs a;
  const int err = step_args(a, VARIANT_DESIGN, x, clean, sa, sb, rec, offs, mixes, scratch_f4,
                            scratch_f, wpart, rows, gsa, gsb, grad_w, goffs, bnmom, B, bt, ns,
                            nc, nm, invb, gl, ops, n_ops);
  return err ? err : launch_variant<STEP, ABL_FULL>(a, stream, launched);
}

// nf_segment_backward of fused_train.cu in this design and precision with
// ablation `abl`: ABL_FULL, ABL_NO_WGRAD, ABL_BN_DIAG, ABL_NO_EPI or
// ABL_FWD_ONLY.
extern "C" int nf_variant_segment_backward(int abl, const float* x, const float* gz,
                                           const float* gldj, const float* rec,
                                           const float* offs, const float* mixes,
                                           float* scratch_f4, float* scratch_f, float* wpart,
                                           float* gx, float* grad_w, float* goffs, int B, int bt,
                                           int nc, int nm, const int* ops, int n_ops,
                                           void* stream, int* launched) {
  *launched = 0;
  StepArgs a;
  const int err = seg_bwd_args(a, VARIANT_DESIGN, x, gz, gldj, rec, offs, mixes, scratch_f4,
                               scratch_f, wpart, gx, grad_w, goffs, B, bt, nc, nm, ops, n_ops);
  if (err) return err;
  switch (abl) {
    case ABL_FULL: return launch_variant<SEG_BWD, ABL_FULL>(a, stream, launched);
    case ABL_NO_WGRAD: return launch_variant<SEG_BWD, ABL_NO_WGRAD>(a, stream, launched);
    case ABL_BN_DIAG: return launch_variant<SEG_BWD, ABL_BN_DIAG>(a, stream, launched);
    case ABL_NO_EPI: return launch_variant<SEG_BWD, ABL_NO_EPI>(a, stream, launched);
    case ABL_FWD_ONLY: return launch_variant<SEG_BWD, ABL_FWD_ONLY>(a, stream, launched);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// nf_segment_train_forward of fused_train.cu in this design and precision
// with ablation `abl`: ABL_FULL, ABL_NO_EPI or ABL_NO_BN_STATS.
extern "C" int nf_variant_segment_train_forward(int abl, const float* x, float* z, float* rows,
                                                float* bnmom, const float* rec,
                                                const float* offs, const float* mixes,
                                                float* scratch_f4, float* scratch_f, int B,
                                                int bt, int nc, int nm, const int* ops,
                                                int n_ops, void* stream, int* launched) {
  *launched = 0;
  if (bad_sizes(B, bt, nc, nm) || check_ops(ops, n_ops, nc, nm, 0, false))
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a = make_args(SEG_FWD, VARIANT_DESIGN, B, bt, 1, nc, nm, ops, n_ops, scratch_f4,
                         scratch_f, nullptr);
  a.x = reinterpret_cast<const float4*>(x);
  a.rec = rec;
  a.offs = reinterpret_cast<const float4*>(offs);
  a.mixes = mixes;
  a.cur = reinterpret_cast<float4*>(z);
  a.rows = rows;
  a.bnmom = bnmom;
  switch (abl) {
    case ABL_FULL: return launch_variant<SEG_FWD, ABL_FULL>(a, stream, launched);
    case ABL_NO_EPI: return launch_variant<SEG_FWD, ABL_NO_EPI>(a, stream, launched);
    case ABL_NO_BN_STATS: return launch_variant<SEG_FWD, ABL_NO_BN_STATS>(a, stream, launched);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
