// The running-statistics eval forward's template segment_kernel<BF, DESIGN>:
// one [mix, coupling]* segment's inverse chain x -> (z, ldj) with BN folded
// into the records, or applied after each conv from the running moments
// (bnrun). fused_train.cu describes the function and instantiates the
// production design; the probe library segment_probe.cu keeps the parent's
// kernel and instantiates the planted faults.
//
// Design. One CTA of 256 threads a patch, 4 pixels a thread (column c, rows
// r0 + 8k), as the parent. The parent read every weight from device memory
// at every 3x3 tap, rounding it there in bfloat16, and computed the running
// moments' 1/sqrt(var + eps) in every thread: at B = 138 about one CTA runs
// on each SM, so every weight load is an L1 miss that the next FMAs wait
// on, with no other warps to hide it. Here:
// - each coupling's record is staged in shared memory once (its weights
//   rounded once in bfloat16), with the coupling's running moments and
//   their 1/sqrt(var + eps) computed once; the mixes are staged once a
//   launch (rounded once). The convs read the copy (wload4<2>);
// - the record's buffer alternates between couplings, so a coupling needs
//   two barriers, not the parent's three: after the conv1 input tile is
//   written and after the conv3 input tile is written. No barrier is needed
//   before a tile or a record is written again: every thread has passed the
//   conv3 barrier, so has finished reading the conv1 tile, reaches the next
//   conv1 barrier only after its conv3 reads, and the record it stages next
//   goes into the buffer that the coupling before last used;
// - __launch_bounds__(256, 2): at most 128 registers, two CTAs an SM, so a
//   batch of up to 2 x SMs patches (264 on an H100) runs in one wave.
// Each value a product reads is the parent's (a bfloat16 rounding is the
// same whether it is done once or at every load; 1/sqrt(var + eps) is the
// same float in any thread), and every FMA runs in the parent's order, so z
// and ldj are the parent's bits.
//
// Measured and not kept (PERF.md section 6): a patch split over a thread
// block cluster of 2 or 4 CTAs reading its neighbours' halo rows from
// distributed shared memory (slower at B = 138: each cluster barrier cost
// about 0.65 us), the next coupling's record prefetched a coupling ahead
// (no faster at B = 138), the parent's third barrier (no faster), the
// float32 record read in device memory at every tap (slower).

#pragma once

#include "train_kernel.cuh"

namespace {

struct SegArgs {
  const float4* x;      // [B, NPIX]
  float4* z;            // [B, NPIX]
  float* ldj;           // [B]
  const float* rec;     // [nc, REC]: BN folded into w1/b1 and w2/b2, or not (bnrun)
  const float4* offs;   // [nc, NPIX]
  const float* mixes;   // [nm, 16]
  const float4* bnrun;  // [nc, 4]: mean1, var1, mean2, var2 of each coupling's
                        // running BN, applied after each conv; null: folded in rec
  int B, nm, n_ops;
  int ops[MAX_OPS];
};

// Design bits of segment_kernel: planted faults of the probe library, which
// break the kernel on purpose; production has none.
constexpr int E_FAULT_NOSYNC = 1;   // the barrier before conv3 left out: conv3
                                    // reads the other warps' rows in a race
constexpr int E_FAULT_MOMENTS = 2;  // the running variances staged as they are,
                                    // not as 1/sqrt(var + eps)
constexpr int E_PROD = 0;

template <bool BF, int DESIGN>
__global__ void __launch_bounds__(THREADS, 2)
segment_kernel(const SegArgs a) {
  __shared__ float4 xs[NPIX];  // conv1's input
  __shared__ float4 hs[NPIX];  // conv3's input
  __shared__ float4 red[WARPS];
  __shared__ __align__(16) float wsm[2][REC];        // the coupling's record, two buffers
  __shared__ float4 bsm[2][4];                       // its mean1, 1/sd1, mean2, 1/sd2
  __shared__ __align__(16) float msm[MAX_OPS * 16];  // the mixes
  const int patch = blockIdx.x, tid = threadIdx.x;
  const int c = tid % W, r0 = tid / W;
  float4 x[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) x[k] = a.x[slot(patch) + pix(k)];
  for (int e = tid; e < a.nm * 16; e += THREADS) msm[e] = rnd<BF>(a.mixes[e]);
  __syncthreads();
  const bool bn = a.bnrun != nullptr;
  float lsum = 0.f;
  int buf = 0;
  for (int i = 0; i < a.n_ops; ++i) {
    const int kind = a.ops[i] >> 8, idx = a.ops[i] & 255;
    if (kind == OP_MIX) {
      const float4* m = reinterpret_cast<const float4*>(msm + idx * 16);
      const float4 m0 = m[0], m1 = m[1], m2 = m[2], m3 = m[3];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float4 v = rnd4<BF>(x[k]);
        x[k] = fma4(v.w, m3, fma4(v.z, m2, fma4(v.y, m1, scale4(m0, v.x))));
      }
      continue;
    }
    // stage the record and the moments, write the conv1 tile
    const float* grec = a.rec + static_cast<size_t>(idx) * REC;
    float* rec = wsm[buf];
    for (int e = tid; e < REC; e += THREADS)
      rec[e] = BF && is_weight(e) ? rnd<true>(grec[e]) : grec[e];
    if (bn && tid < 4) {
      const float4 r = a.bnrun[static_cast<size_t>(idx) * 4 + tid];
      bsm[buf][tid] = (tid & 1) && (DESIGN & E_FAULT_MOMENTS) == 0 ? inv_sd4(r) : r;
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) xs[pix(k)] = rnd4<BF>(x[k]);
    __syncthreads();
    float4 h[PPT];
    conv1_fwd<BF, 2>(xs, rec, r0, c, h);
    const float4 m1 = bsm[buf][0], is1 = bsm[buf][1], m2 = bsm[buf][2], is2 = bsm[buf][3];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float4 v = h[k];
      if (bn) v = (v - m1) * is1;
      v = conv2_fwd<BF, 2>(relu4(v), rec);
      if (bn) v = (v - m2) * is2;
      hs[pix(k)] = rnd4<BF>(relu4(v));
    }
    if constexpr ((DESIGN & E_FAULT_NOSYNC) == 0) __syncthreads();
    float4 t[PPT];
    conv3_fwd<BF, 2>(hs, rec, a.offs + static_cast<size_t>(idx) * NPIX, r0, c, t);
    const float rescale = rec[OFF_RESCALE];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float ls2 = rescale * tanhf(t[k].z), ls3 = rescale * tanhf(t[k].w);
      x[k].z = fmaf(x[k].z, expf(ls2), t[k].x);
      x[k].w = fmaf(x[k].w, expf(ls3), t[k].y);
      lsum += ls2 + ls3;
    }
    buf ^= 1;
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) a.z[slot(patch) + pix(k)] = x[k];
  const float4 l = block_sum4(make_float4(lsum, 0.f, 0.f, 0.f), red);
  if (tid == 0) a.ldj[patch] = l.x;
}

// Launches segment_kernel<BF, DESIGN> on a's batch, one CTA a patch; adds
// the launch to *launched and returns the launch error. A refused launch is
// not retried in any other way.
template <bool BF, int DESIGN>
int launch_segment(const SegArgs& a, cudaStream_t s, int* launched) {
  segment_kernel<BF, DESIGN><<<a.B, THREADS, 0, s>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) ++*launched;
  return err;
}

// The CTAs an SM of segment_kernel<BF, DESIGN> (the occupancy API) in *n;
// returns the CUDA error.
template <bool BF, int DESIGN>
int segment_occupancy(int* n) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, reinterpret_cast<const void*>(segment_kernel<BF, DESIGN>), THREADS, 0));
}

// nf_segment_forward's arguments into a, checked: 0, or cudaErrorInvalidValue.
int segment_args(SegArgs& a, const float* x, float* z, float* ldj, const float* rec,
                 const float* offs, const float* mixes, const float* bnrun, int B, int nc,
                 int nm, const int* ops, int n_ops) {
  if (B <= 0 || nc <= 0 || nm <= 0 || nm > MAX_OPS || check_ops(ops, n_ops, nc, nm, 0, false))
    return static_cast<int>(cudaErrorInvalidValue);
  a = SegArgs{};
  a.x = reinterpret_cast<const float4*>(x);
  a.z = reinterpret_cast<float4*>(z);
  a.ldj = ldj;
  a.rec = rec;
  a.offs = reinterpret_cast<const float4*>(offs);
  a.mixes = mixes;
  a.bnrun = reinterpret_cast<const float4*>(bnrun);
  a.B = B;
  a.nm = nm;
  a.n_ops = n_ops;
  for (int i = 0; i < n_ops; ++i) a.ops[i] = ops[i];
  return 0;
}

}  // namespace
