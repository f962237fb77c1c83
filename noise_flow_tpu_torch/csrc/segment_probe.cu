// The running-statistics eval forward's probe library on NVIDIA Hopper
// (sm_90a), plain C interface: the parent's design of nf_segment_forward,
// kept to time and hold the redesign (segment_kernel.cuh) against, and the
// redesign with planted faults that its comparisons must catch.
// noise_flow_tpu_torch/probes/train_template.py drives them.
//
// The parent (segment_kernel_parent, the production kernel before the
// redesign, unchanged): one CTA of 256 threads a patch, 4 pixels a thread;
// every weight read from device memory at every 3x3 tap (and rounded there
// in bfloat16); each thread computes the running moments' 1/sqrt(var + eps);
// three barriers a coupling.
//
// Every entry sets *launched to the kernel launches it issued and returns the
// launch error (cudaError_t), 0 if none.

#include "segment_kernel.cuh"

namespace {

template <bool BF>
__global__ void __launch_bounds__(THREADS)
segment_kernel_parent(const SegArgs a) {
  __shared__ float4 xs[NPIX];
  __shared__ float4 hs[NPIX];
  __shared__ float4 red[WARPS];
  const int patch = blockIdx.x, tid = threadIdx.x;
  const int c = tid % W, r0 = tid / W;
  float4 x[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) x[k] = a.x[slot(patch) + pix(k)];
  float lsum = 0.f;
  for (int i = 0; i < a.n_ops; ++i) {
    const int kind = a.ops[i] >> 8, idx = a.ops[i] & 255;
    if (kind == OP_MIX) {
      const float* m = a.mixes + idx * 16;
      const float4 m0 = wld4<BF>(m), m1 = wld4<BF>(m + 4), m2 = wld4<BF>(m + 8),
                   m3 = wld4<BF>(m + 12);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float4 v = rnd4<BF>(x[k]);
        x[k] = fma4(v.w, m3, fma4(v.z, m2, fma4(v.y, m1, scale4(m0, v.x))));
      }
      continue;
    }
    const float* rec = a.rec + static_cast<size_t>(idx) * REC;
    __syncthreads();  // the previous coupling is done reading xs and hs
#pragma unroll
    for (int k = 0; k < PPT; ++k) xs[pix(k)] = rnd4<BF>(x[k]);
    __syncthreads();
    float4 h[PPT];
    conv1_fwd<BF>(xs, rec, r0, c, h);
    const bool bn = a.bnrun != nullptr;
    float4 m1 = zero4(), is1 = zero4(), m2 = zero4(), is2 = zero4();
    if (bn) {
      const float4* r = a.bnrun + static_cast<size_t>(idx) * 4;
      m1 = r[0];
      is1 = inv_sd4(r[1]);
      m2 = r[2];
      is2 = inv_sd4(r[3]);
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float4 v = h[k];
      if (bn) v = (v - m1) * is1;
      v = conv2_fwd<BF>(relu4(v), rec);
      if (bn) v = (v - m2) * is2;
      hs[pix(k)] = rnd4<BF>(relu4(v));
    }
    __syncthreads();
    float4 t[PPT];
    conv3_fwd<BF>(hs, rec, a.offs + static_cast<size_t>(idx) * NPIX, r0, c, t);
    const float rescale = __ldg(rec + OFF_RESCALE);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float ls2 = rescale * tanhf(t[k].z), ls3 = rescale * tanhf(t[k].w);
      x[k].z = fmaf(x[k].z, expf(ls2), t[k].x);
      x[k].w = fmaf(x[k].w, expf(ls3), t[k].y);
      lsum += ls2 + ls3;
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) a.z[slot(patch) + pix(k)] = x[k];
  const float4 l = block_sum4(make_float4(lsum, 0.f, 0.f, 0.f), red);
  if (tid == 0) a.ldj[patch] = l.x;
}

// segment_kernel with a planted fault (nf_segment_fault's code)
template <bool BF>
int launch_fault(const SegArgs& a, int fault, cudaStream_t s, int* launched) {
  switch (fault) {
    case E_FAULT_NOSYNC: return launch_segment<BF, E_FAULT_NOSYNC>(a, s, launched);
    case E_FAULT_MOMENTS: return launch_segment<BF, E_FAULT_MOMENTS>(a, s, launched);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// nf_segment_forward (fused_train.cu) in the parent's design: one launch of
// B CTAs. Arguments as there.
extern "C" int nf_segment_forward_parent(const float* x, float* z, float* ldj, const float* rec,
                                         const float* offs, const float* mixes,
                                         const float* bnrun, int B, int nc, int nm,
                                         const int* ops, int n_ops, int bf16, void* stream,
                                         int* launched) {
  *launched = 0;
  SegArgs a;
  int err = segment_args(a, x, z, ldj, rec, offs, mixes, bnrun, B, nc, nm, ops, n_ops);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    segment_kernel_parent<true><<<B, THREADS, 0, s>>>(a);
  else
    segment_kernel_parent<false><<<B, THREADS, 0, s>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) ++*launched;
  return err;
}

// nf_segment_forward (fused_train.cu) with a planted fault, the
// segment_kernel.cuh design bit: 1 (E_FAULT_NOSYNC) the barrier before
// conv3 left out, 2 (E_FAULT_MOMENTS) the running variances staged in place
// of 1/sqrt(var + eps). Arguments as nf_segment_forward's.
extern "C" int nf_segment_fault(int fault, const float* x, float* z, float* ldj,
                                const float* rec, const float* offs, const float* mixes,
                                const float* bnrun, int B, int nc, int nm, const int* ops,
                                int n_ops, int bf16, void* stream, int* launched) {
  *launched = 0;
  SegArgs a;
  const int err = segment_args(a, x, z, ldj, rec, offs, mixes, bnrun, B, nc, nm, ops, n_ops);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fault<true>(a, fault, s, launched)
              : launch_fault<false>(a, fault, s, launched);
}

// The CTAs an SM of the parent's kernel (the occupancy API) in *per_sm.
extern "C" int nf_segment_parent_occupancy(int bf16, int* per_sm) {
  const void* fn = bf16 ? reinterpret_cast<const void*>(segment_kernel_parent<true>)
                        : reinterpret_cast<const void*>(segment_kernel_parent<false>);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, THREADS, 0));
}
