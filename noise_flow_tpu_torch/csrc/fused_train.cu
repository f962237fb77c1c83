// Fused Noise Flow training step and eval forward for NVIDIA Hopper (sm_90a),
// plain C interface.
//
// nf_train_step replaces the Pallas TPU kernel
// noise_flow_tpu/ops/pallas_train.py `_step_kernel_factory` (launched by
// `_step_call`): the mean-NLL forward of a single-level 32x32x4 flow in the
// inverse direction (data -> latent) and, in the same launch, the analytic
// backward with the seeds d(mean nll)/dz = z/B and d(mean nll)/d ldj_i = -1/B.
// nf_segment_forward replaces `_fwd_kernel_factory` in running-statistics mode
// (launched by `_seg_fwd_call`): the inverse chain of one [mix, coupling]*
// segment with BatchNorm folded into the convolutions, giving z and the
// per-patch log-det.
// nf_segment_train_forward replaces `_fwd_kernel_factory` in ghost-BN mode
// (`ghost_bn=True`): the same chain with BN over groups of bt patches, giving
// z, the per-patch log-det and the group moments averaged over the groups.
// nf_segment_backward replaces `_bwd_kernel_factory` (launched by
// `_seg_bwd_call`): it recomputes that forward, keeping nothing between the
// two calls, then sweeps back from any cotangents (gz, gldj), gldj one value
// per patch, giving gx and the gradients of the records, offset maps and
// mixes.
//
// The chain is the program of noise_flow_tpu_torch/ops/fused_train.py, in
// NHWC layout: mix ops (x @ A, 4x4), scale ops (x *= 1/sqrt(a*clean + b),
// per-example a, b) and affine couplings
//   h1 = BN(conv3x3(x[..., 0:2]) + b1)        2 -> 4 channels, SAME zero fill
//   h2 = BN(relu(h1) @ w2 + b2)                4 -> 4
//   t  = conv3x3(relu(h2), w3) + offs          4 -> 4, SAME zero fill
//   x[..., 2:4] = x[..., 2:4] * exp(rescale * tanh(t[2:4])) + t[0:2]
// where w3 and the offset map `offs` already carry the zero-conv's exp(3*logs)
// factor, and `offs` holds its edge-indicator taps and bias. In the step
// kernel BN normalises with the two-pass biased moments of the group of `bt`
// consecutive patches the patch belongs to (ghost BN; bt = B is exact BN).
//
// Work and bound. At the published arch (8 couplings, 8 mixes, 2 scales) the
// forward chain is about 4.06 MFLOP of useful multiply-adds per patch, the
// same count as sampling. The step adds the data gradient and the weight
// gradient of every convolution, about 3x that: roughly 12 MFLOP per patch,
// 1.7 GFLOP at B = 138, about 25 us at the H100's 67 TFLOP/s float32 rate.
// Its device memory traffic that the function needs is small (x and clean in,
// 32 KB a patch), so operations bound it. The running-mode segment forward
// does about 2 MFLOP per patch per segment against 32 KB of traffic, also
// bound by operations.
//
// Design. The TPU kernel's 128-lane banded matmuls (about 3% of their FLOPs
// useful) are not carried over: as in fused_sample.cu, 256 threads own the
// 1024 pixels of one patch (4 each, one column, rows r0 + 8k), do only the
// useful float32 FMAs, and read 3x3 neighbours from shared memory with zero
// fill at the border. No tensor cores: at 2->4 and 4->4 channels there is no
// tile to fill.
//
// The step needs the moments of a group of bt patches at each BN, forward
// (mean, then variance: 4 reductions per coupling) and backward (the group
// means of gn and gn*n in one pass: 2 per coupling). The step kernel is one
// cooperative launch with grid.sync() between those stages: the grid is as
// many CTAs as can be resident at once (occupancy API), at most B, and each
// CTA walks its patches patch = blockIdx.x + k * gridDim.x. Every CTA writes
// one partial sum per channel for each of its patches; after the sync every
// CTA that needs a group's moments reduces that group's partials in the same
// fixed order, so no float atomics are used and results repeat bit for bit.
// Residuals for the backward (each op's input, n1, n2, t) do not fit in
// shared memory (about 64 KB a patch per coupling), so they live in global
// scratch that the wrapper allocates; so does the chain state between stages.
// Weight gradients are summed per patch in a fixed order (each warp owns
// taps, each lane 32 pixels, then a butterfly over the warp) into per-patch
// partials, and after the last sync one thread per weight sums them over the
// batch in patch order. b1/b2 gradients are exactly zero (BN removes the
// mean), as the TPU kernel returns them; the wrapper's zeroed buffer keeps
// them so.
//
// The segment path's two kernels are the step kernel's template in two more
// modes (one launch a call each, the same stages and fixed-order reductions).
// SEG_FWD runs the forward stages only, writing z in place of the chain
// state and keeping no residuals for a backward. SEG_BWD runs the forward
// again, seeds the backward with gz in place of z/B and reads each patch's
// ldj cotangent from gldj in place of the constant -1/B; the backward then
// leaves gx in the chain-state gradient. At the flagship's segments (4
// couplings, 4 mixes) the backward does about 3x the forward's multiply-adds,
// and both are bound by operations, not bytes.
//
// bfloat16 mode (the TPU kernels' mm_dtype=bf16, the trainer's default
// pallas_train_dtype): a compile-time parameter BF of every kernel. Where the
// TPU kernel computes a matmul `mm(a, b)`, both operands are rounded to
// bfloat16 (round to nearest even) and the FMAs stay float32; a product of
// two bfloat16 values is exact in float32, so this is the TPU kernel's
// arithmetic in another summation order. Forward: the chain state at a mix
// and at conv1, relu(n1) at conv2, relu(n2) at conv3, and the weights.
// Backward: each data gradient mm(g, w^T) rounds g and w, each weight
// gradient mm(a^T, g) rounds a and g; the elementwise uses of the same
// residuals (x_in * exp(ls), the ReLU masks, the BN backward) stay float32,
// so the residuals are kept in float32 and rounded where a product reads
// them. The BN moments of the TPU kernel are a matmul too,
// mm(sum_rows(v), csel): the sum of each lane (one column and channel, over
// the group's bt * 32 rows) is rounded to bfloat16 before the 32 lanes of a
// channel are added in float32. So in this mode the per-patch partials are
// per lane (NPART floats a patch: two quantities x 32 columns x 4 channels),
// each group's lane sums are reduced in a fixed order, rounded, and then
// summed over the columns in a fixed order: both forward moments and the two
// means of the BN backward. The running-statistics segment forward in this
// mode takes the records without BN folded in and normalises with the
// running moments after each conv, as the TPU kernel's ghost_bn=False does;
// rounding BN-folded weights would be another function.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int H = 32, W = 32, NPIX = H * W;
constexpr int THREADS = 256;
constexpr int PPT = NPIX / THREADS;  // pixels per thread: rows r0 + 8k, column c
constexpr int ROWS_PER_PASS = THREADS / W;
constexpr int WARPS = THREADS / 32;
constexpr int REC = 288;
// coupling record layout: see _REC_LAYOUT in ops/fused_sample.py
constexpr int OFF_W1 = 0, OFF_B1 = 72, OFF_W2 = 76, OFF_B2 = 92, OFF_W3 = 96,
              OFF_RESCALE = 280;
constexpr int MAX_OPS = 64;
// floats of partial sums per patch per stage: two float4 sums (float32
// mode), or two quantities of W lanes of 4 channels (bfloat16 mode)
constexpr int NPART = 2 * W * 4;
static_assert(W == 32, "a warp's lanes are a row's columns");
constexpr float BN_EPS = 1e-4f;

enum OpKind { OP_MIX = 0, OP_SCALE = 1, OP_COUPLING = 2 };
// what one launch of train_kernel computes
enum Mode { STEP = 0, SEG_FWD = 1, SEG_BWD = 2 };

__device__ __forceinline__ float4 operator+(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 operator-(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}
__device__ __forceinline__ float4 operator*(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }
// acc + s * w
__device__ __forceinline__ float4 fma4(float s, float4 w, float4 acc) {
  return make_float4(fmaf(s, w.x, acc.x), fmaf(s, w.y, acc.y),
                     fmaf(s, w.z, acc.z), fmaf(s, w.w, acc.w));
}
__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                     fmaxf(a.w, 0.f));
}
// 1 where a > 0, else 0
__device__ __forceinline__ float4 pos4(float4 a) {
  return make_float4(a.x > 0.f ? 1.f : 0.f, a.y > 0.f ? 1.f : 0.f,
                     a.z > 0.f ? 1.f : 0.f, a.w > 0.f ? 1.f : 0.f);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}
__device__ __forceinline__ float hsum4(float4 a) { return (a.x + a.y) + (a.z + a.w); }
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float get4(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// v rounded to bfloat16 and back (nearest even) when BF, else v: an operand
// of a product
template <bool BF>
__device__ __forceinline__ float rnd(float v) {
  return BF ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}
template <bool BF>
__device__ __forceinline__ float4 rnd4(float4 v) {
  return make_float4(rnd<BF>(v.x), rnd<BF>(v.y), rnd<BF>(v.z), rnd<BF>(v.w));
}
// a weight as a product's operand
template <bool BF>
__device__ __forceinline__ float4 wld4(const float* p) {
  return rnd4<BF>(ldg4(p));
}
__device__ __forceinline__ float4 inv_sd4(float4 var) {
  return make_float4(1.f / sqrtf(var.x + BN_EPS), 1.f / sqrtf(var.y + BN_EPS),
                     1.f / sqrtf(var.z + BN_EPS), 1.f / sqrtf(var.w + BN_EPS));
}

// Sum of one float4 per thread over the block, in a fixed order; every
// thread gets the result.
__device__ float4 block_sum4(float4 v, float4* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_down_sync(0xffffffffu, v.x, o);
    v.y += __shfl_down_sync(0xffffffffu, v.y, o);
    v.z += __shfl_down_sync(0xffffffffu, v.z, o);
    v.w += __shfl_down_sync(0xffffffffu, v.w, o);
  }
  __syncthreads();  // red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float4 s = red[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) s = s + red[i];
  return s;
}

__device__ __forceinline__ int pix(int k) { return threadIdx.x + THREADS * k; }

// ---------------------------------------------------------------------------
// convolutions over the thread's PPT pixels (column c, rows r0 + 8k); the
// shared-memory operands (xs, gs, hs) hold what the mode's product takes
// (rounded in bfloat16 mode), the weights are rounded here
// ---------------------------------------------------------------------------

// h = conv3x3(x[..., 0:2], w1) + b1, SAME zero fill; xs holds the patch.
template <bool BF>
__device__ __forceinline__ void conv1_fwd(const float4* xs, const float* rec,
                                          int r0, int c, float4 (&h)[PPT]) {
  const float4 b1 = ldg4(rec + OFF_B1);
#pragma unroll
  for (int k = 0; k < PPT; ++k) h[k] = b1;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int cc = c + dw - 1;
      if (cc < 0 || cc >= W) continue;
      const float4 w0 = wld4<BF>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 0) * 4);
      const float4 w1 = wld4<BF>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 1) * 4);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int rr = r0 + ROWS_PER_PASS * k + dh - 1;
        if (rr < 0 || rr >= H) continue;
        const float4 v = xs[rr * W + cc];
        h[k] = fma4(v.y, w1, fma4(v.x, w0, h[k]));
      }
    }
  }
}

// x[..., 0:2] gradient of conv1: sum over taps of gh[p - off] . w1[tap][ci]
template <bool BF>
__device__ __forceinline__ void conv1_bwd(const float4* gs, const float* rec,
                                          int r0, int c, float2 (&gx)[PPT]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) gx[k] = make_float2(0.f, 0.f);
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int cc = c - (dw - 1);
      if (cc < 0 || cc >= W) continue;
      const float4 w0 = wld4<BF>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 0) * 4);
      const float4 w1 = wld4<BF>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 1) * 4);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int rr = r0 + ROWS_PER_PASS * k - (dh - 1);
        if (rr < 0 || rr >= H) continue;
        const float4 g = gs[rr * W + cc];
        gx[k].x += dot4(w0, g);
        gx[k].y += dot4(w1, g);
      }
    }
  }
}

// 1x1 conv 4 -> 4, + b2
template <bool BF>
__device__ __forceinline__ float4 conv2_fwd(float4 h, const float* rec) {
  h = rnd4<BF>(h);
  float4 o = ldg4(rec + OFF_B2);
  o = fma4(h.x, wld4<BF>(rec + OFF_W2 + 0), o);
  o = fma4(h.y, wld4<BF>(rec + OFF_W2 + 4), o);
  o = fma4(h.z, wld4<BF>(rec + OFF_W2 + 8), o);
  o = fma4(h.w, wld4<BF>(rec + OFF_W2 + 12), o);
  return o;
}

template <bool BF>
__device__ __forceinline__ float4 conv2_bwd(float4 g, const float* rec) {
  g = rnd4<BF>(g);
  return make_float4(dot4(wld4<BF>(rec + OFF_W2 + 0), g), dot4(wld4<BF>(rec + OFF_W2 + 4), g),
                     dot4(wld4<BF>(rec + OFF_W2 + 8), g), dot4(wld4<BF>(rec + OFF_W2 + 12), g));
}

// t = conv3x3(hs, w3) + offs, SAME zero fill (the indicator taps are in offs)
template <bool BF>
__device__ __forceinline__ void conv3_fwd(const float4* hs, const float* rec,
                                          const float4* offs, int r0, int c,
                                          float4 (&t)[PPT]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) t[k] = __ldg(offs + pix(k));
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int tap = dh * 3 + dw;
      const int cc = c + dw - 1;
      if (cc < 0 || cc >= W) continue;
      const float4 w0 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 0) * 4);
      const float4 w1 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 1) * 4);
      const float4 w2 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 2) * 4);
      const float4 w3 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 3) * 4);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int rr = r0 + ROWS_PER_PASS * k + dh - 1;
        if (rr < 0 || rr >= H) continue;
        const float4 v = hs[rr * W + cc];
        t[k] = fma4(v.w, w3, fma4(v.z, w2, fma4(v.y, w1, fma4(v.x, w0, t[k]))));
      }
    }
  }
}

// gradient of conv3 with respect to its input
template <bool BF>
__device__ __forceinline__ void conv3_bwd(const float4* gs, const float* rec,
                                          int r0, int c, float4 (&gh)[PPT]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) gh[k] = zero4();
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int tap = dh * 3 + dw;
      const int cc = c - (dw - 1);
      if (cc < 0 || cc >= W) continue;
      const float4 w0 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 0) * 4);
      const float4 w1 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 1) * 4);
      const float4 w2 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 2) * 4);
      const float4 w3 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 3) * 4);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int rr = r0 + ROWS_PER_PASS * k - (dh - 1);
        if (rr < 0 || rr >= H) continue;
        const float4 g = gs[rr * W + cc];
        gh[k] = gh[k] + make_float4(dot4(w0, g), dot4(w1, g), dot4(w2, g), dot4(w3, g));
      }
    }
  }
}

// Weight gradient of a conv over one patch, in a fixed order:
// out[(tap * cin + ci) * 4 + co] = sum_p A[p + off(tap)][ci] * G[p][co]
// (A zero outside the patch). ntaps is 9 (3x3, off = (dh-1, dw-1)) or 1
// (1x1). Warp w owns taps w, w + 8, ...; lane l sums the 32 pixels of column
// l; a butterfly sums the lanes. Ends with the whole block synchronised.
__device__ void wgrad(const float4* as, const float4* gs, int ntaps, int cin,
                      float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int tap = warp; tap < ntaps; tap += WARPS) {
    const int dh = ntaps == 9 ? tap / 3 - 1 : 0;
    const int dw = ntaps == 9 ? tap % 3 - 1 : 0;
    float4 acc[4] = {zero4(), zero4(), zero4(), zero4()};
    const int cc = lane + dw;
    if (cc >= 0 && cc < W) {
      for (int r = 0; r < H; ++r) {
        const int rr = r + dh;
        if (rr < 0 || rr >= H) continue;
        const float4 a = as[rr * W + cc];
        const float4 g = gs[r * W + lane];
        acc[0] = fma4(a.x, g, acc[0]);
        acc[1] = fma4(a.y, g, acc[1]);
        acc[2] = fma4(a.z, g, acc[2]);
        acc[3] = fma4(a.w, g, acc[3]);
      }
    }
#pragma unroll
    for (int ci = 0; ci < 4; ++ci) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc[ci].x += __shfl_xor_sync(0xffffffffu, acc[ci].x, o);
        acc[ci].y += __shfl_xor_sync(0xffffffffu, acc[ci].y, o);
        acc[ci].z += __shfl_xor_sync(0xffffffffu, acc[ci].z, o);
        acc[ci].w += __shfl_xor_sync(0xffffffffu, acc[ci].w, o);
      }
    }
    if (lane < cin * 4) {
      // acc by a select, not acc[ci]: a lane-dependent index would put the
      // array in local memory
      const int ci = lane >> 2, co = lane & 3;
      const float4 v = ci == 0 ? acc[0] : ci == 1 ? acc[1] : ci == 2 ? acc[2] : acc[3];
      out[(tap * cin + ci) * 4 + co] = get4(v, co);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the train step
// ---------------------------------------------------------------------------

// Pointers a mode does not use are null (see the C entries).
struct StepArgs {
  const float4* x;      // [B, NPIX] input
  const float4* clean;  // [B, NPIX]
  const float* sa;      // [B, ns]
  const float* sb;      // [B, ns]
  const float* rec;     // [nc, REC] coupling records
  const float4* offs;   // [nc, NPIX] zero-conv offset maps
  const float* mixes;   // [nm, 16]
  const float4* gz;     // SEG_BWD: [B, NPIX] cotangent of z
  const float* gldj;    // SEG_BWD: [B] cotangent of each patch's ldj
  float4* cur;          // [B, NPIX]: chain state, z after the forward
  float4* gcur;         // [B, NPIX]: gradient of the chain state, gx at the end
  float4* xin;          // scratch [n_ops, B, NPIX]: each op's input
  float4* res;          // scratch [nc, 3, B, NPIX]: n1; h2, n2, gn1; t, gn2
                        // (SEG_FWD: [1, 3, B, NPIX], reused by every coupling)
  float4* gt;           // scratch [nc, B, NPIX]: gradient of t
  float* part;          // scratch [2, B, NPART]: per-patch partial sums
  float* mom;           // scratch [nc, B / bt, 16]: group m1, v1, m2, v2
  float* wpart;         // zeroed scratch [B, nw]: per-patch weight gradients
  float* rows;          // out [B, 3]: ldj, sum z, sum z^2 (SEG_FWD: ldj, then
                        // zeros; SEG_BWD: none)
  float* gsa;           // out [B, ns]
  float* gsb;           // out [B, ns]
  float* grad_w;        // out [nw] = [nc * REC + nm * 16]: records, then mixes
  float* goffs;         // out [nc, NPIX * 4]
  float* bnmom;         // out [nc, 16]: group moments averaged over groups
  float invb;           // seed of z: d(mean nll)/dz = z * invb
  float gl;             // seed of each patch's ldj: -invb for the mean NLL
  int B, bt, ns, nc, nm, nw, n_ops;
  int ops[MAX_OPS];     // kind << 8 | index, inverse (data -> latent) order
};

__device__ __forceinline__ size_t slot(int patch) { return static_cast<size_t>(patch) * NPIX; }

// The group's two partial-sum float4s, reduced over its bt patches in a fixed order.
__device__ void group_sums(const StepArgs& a, const float* part, int patch,
                           float4* red, float4& s1, float4& s2) {
  const int g0 = patch / a.bt * a.bt;
  s1 = zero4();
  s2 = zero4();
  for (int i = threadIdx.x; i < a.bt; i += THREADS) {
    const float* p = part + static_cast<size_t>(g0 + i) * NPART;
    s1 = s1 + *reinterpret_cast<const float4*>(p);
    s2 = s2 + *reinterpret_cast<const float4*>(p + 4);
  }
  s1 = block_sum4(s1, red);
  s2 = block_sum4(s2, red);
}

__device__ __forceinline__ void put_part(float* part, int patch, float4 s1, float4 s2) {
  if (threadIdx.x == 0) {
    float4* p = reinterpret_cast<float4*>(part + static_cast<size_t>(patch) * NPART);
    p[0] = s1;
    p[1] = s2;
  }
}

// bfloat16 mode: the patch's per-lane partial sums of two quantities, given
// one float4 of each a thread (over the pixels of its column): the 8 threads
// of a column (lane `column` of every warp) summed in warp order, into
// part[patch] as [2][W] float4.
__device__ void put_lanes(float* part, int patch, float4 s1, float4 s2, float4* lred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // lred may still be read from a previous call
  lred[warp * W + lane] = s1;
  lred[(WARPS + warp) * W + lane] = s2;
  __syncthreads();
  if (threadIdx.x < 2 * W) {
    const int q = threadIdx.x / W, col = threadIdx.x % W;
    float4 t = lred[q * WARPS * W + col];
    for (int j = 1; j < WARPS; ++j) t = t + lred[(q * WARPS + j) * W + col];
    reinterpret_cast<float4*>(part + static_cast<size_t>(patch) * NPART)[q * W + col] = t;
  }
}

// bfloat16 mode: the group's two sums as the TPU kernel's bf16 moment
// matmul forms them: each lane summed over the group's bt patches in a fixed
// order, rounded to bfloat16, then the W lanes of each channel summed in
// float32 in a fixed order.
__device__ void group_lane_sums(const StepArgs& a, const float* part, int patch, float4* lred,
                                float4* red, float4& s1, float4& s2) {
  constexpr int SPLIT = THREADS / (2 * W);  // threads that share a lane
  const int g0 = patch / a.bt * a.bt;
  const int col = threadIdx.x % W, q = (threadIdx.x / W) % 2, j = threadIdx.x / (2 * W);
  float4 t = zero4();
  for (int i = j; i < a.bt; i += SPLIT)
    t = t + reinterpret_cast<const float4*>(part + static_cast<size_t>(g0 + i) * NPART)[q * W + col];
  __syncthreads();  // lred may still be read from a previous call
  lred[threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.x < 2 * W) {  // warp q sums quantity q
    float4 v = lred[threadIdx.x];
    for (int jj = 1; jj < SPLIT; ++jj) v = v + lred[jj * 2 * W + threadIdx.x];
    v = rnd4<true>(v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, o);
      v.y += __shfl_down_sync(0xffffffffu, v.y, o);
      v.z += __shfl_down_sync(0xffffffffu, v.z, o);
      v.w += __shfl_down_sync(0xffffffffu, v.w, o);
    }
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  }
  __syncthreads();
  s1 = red[0];
  s2 = red[1];
}

// The partial sums of two quantities, one float4 each a thread, in the
// mode's layout. Ends with the whole block synchronised since its last
// shared-memory write.
template <bool BF>
__device__ __forceinline__ void put_sums(float* part, int patch, float4 s1, float4 s2,
                                         float4* red, float4* lred) {
  if constexpr (BF) {
    put_lanes(part, patch, s1, s2, lred);
  } else {
    s1 = block_sum4(s1, red);
    s2 = block_sum4(s2, red);
    put_part(part, patch, s1, s2);
  }
}

// The group's two sums, from the partials of put_sums.
template <bool BF>
__device__ __forceinline__ void get_sums(const StepArgs& a, const float* part, int patch,
                                         float4* red, float4* lred, float4& s1, float4& s2) {
  if constexpr (BF)
    group_lane_sums(a, part, patch, lred, red, s1, s2);
  else
    group_sums(a, part, patch, red, s1, s2);
}

// After the last grid sync: each BN's group moments averaged over the groups,
// summed in group order.
__device__ void put_bnmom(const StepArgs& a) {
  const int n_groups = a.B / a.bt;
  for (int e = blockIdx.x * THREADS + threadIdx.x; e < a.nc * 16; e += gridDim.x * THREADS) {
    const float* m = a.mom + static_cast<size_t>(e / 16) * n_groups * 16 + e % 16;
    float s = 0.f;
    for (int gi = 0; gi < n_groups; ++gi) s += m[gi * 16];
    a.bnmom[e] = s / n_groups;
  }
}

// at most 128 registers a thread, so that two CTAs fit on an SM: the grid
// must be co-resident, and B = 138 patches on 132 SMs need two an SM
template <int MODE, bool BF>
__global__ void __launch_bounds__(THREADS, 2)
train_kernel(const StepArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float4 sA[NPIX];
  __shared__ float4 sB[NPIX];
  __shared__ float4 red[WARPS];
  __shared__ float4 lred[BF ? 2 * WARPS * W : 1];  // put_lanes, group_lane_sums

  const int tid = threadIdx.x;
  const int c = tid % W, r0 = tid / W;
  const size_t BP = static_cast<size_t>(a.B) * NPIX;
  const float cnt_inv = 1.f / (static_cast<float>(a.bt) * NPIX);
  const int n_groups = a.B / a.bt;
  float* part_w = a.part;                                  // written this stage
  float* part_r = a.part + static_cast<size_t>(a.B) * NPART;  // read this stage
  auto flip = [&]() {
    float* t = part_r;
    part_r = part_w;
    part_w = t;
  };

  // ---- forward ----------------------------------------------------------
  for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) a.cur[slot(patch) + pix(k)] = a.x[slot(patch) + pix(k)];
    if (MODE != SEG_BWD && tid < 3) a.rows[patch * 3 + tid] = 0.f;
  }
  // only a backward needs each op's input and the residuals of every coupling
  constexpr bool KEEP = MODE != SEG_FWD;
  for (int i = 0; i < a.n_ops; ++i) {
    const int kind = a.ops[i] >> 8, idx = a.ops[i] & 255;
    float4* xin = KEEP ? a.xin + i * BP : nullptr;
    if (kind == OP_MIX) {
      const float* m = a.mixes + idx * 16;
      const float4 m0 = wld4<BF>(m), m1 = wld4<BF>(m + 4), m2 = wld4<BF>(m + 8),
                   m3 = wld4<BF>(m + 12);
      for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const size_t q = slot(patch) + pix(k);
          const float4 v = a.cur[q];
          if (KEEP) xin[q] = v;
          const float4 vr = rnd4<BF>(v);
          a.cur[q] = fma4(vr.w, m3, fma4(vr.z, m2, fma4(vr.y, m1, scale4(m0, vr.x))));
        }
      }
      continue;
    }
    if (kind == OP_SCALE) {
      for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
        const float sa = a.sa[patch * a.ns + idx], sb = a.sb[patch * a.ns + idx];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const size_t q = slot(patch) + pix(k);
          const float4 v = a.cur[q], cl = __ldg(a.clean + q);
          if (KEEP) xin[q] = v;
          a.cur[q] = make_float4(v.x / sqrtf(fmaf(sa, cl.x, sb)), v.y / sqrtf(fmaf(sa, cl.y, sb)),
                                 v.z / sqrtf(fmaf(sa, cl.z, sb)), v.w / sqrtf(fmaf(sa, cl.w, sb)));
        }
      }
      continue;
    }
    // coupling
    const float* rec = a.rec + static_cast<size_t>(idx) * REC;
    const size_t ridx = KEEP ? idx : 0;
    float4* n1s = a.res + (ridx * 3 + 0) * BP;
    float4* h2s = a.res + (ridx * 3 + 1) * BP;
    float4* ts = a.res + (ridx * 3 + 2) * BP;
    float* mom = a.mom + static_cast<size_t>(idx) * n_groups * 16;
    // F1: h1 = conv1(x) + b1 (kept in n1s until normalised); partial sum h1
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      __syncthreads();  // sA of the previous patch is no longer read
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 v = a.cur[q];
        if (KEEP) xin[q] = v;
        sA[pix(k)] = rnd4<BF>(v);
      }
      __syncthreads();
      float4 h[PPT];
      conv1_fwd<BF>(sA, rec, r0, c, h);
      float4 s = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        n1s[slot(patch) + pix(k)] = h[k];
        s = s + h[k];
      }
      put_sums<BF>(part_w, patch, s, zero4(), red, lred);
    }
    grid.sync();
    flip();
    // F2: group mean m1; partial sum (h1 - m1)^2
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 s1, s2;
      get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
      const float4 m1 = scale4(s1, cnt_inv);
      if (patch % a.bt == 0 && tid < 4) mom[(patch / a.bt) * 16 + tid] = get4(m1, tid);
      float4 s = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float4 d = n1s[slot(patch) + pix(k)] - m1;
        s = s + d * d;
      }
      put_sums<BF>(part_w, patch, s, zero4(), red, lred);
    }
    grid.sync();
    flip();
    // F3: v1; n1 = (h1 - m1) / sd1; h2 = relu(n1) @ w2 + b2; partial sum h2
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 s1, s2;
      get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
      const float4 v1 = scale4(s1, cnt_inv);
      const float* mg = mom + (patch / a.bt) * 16;
      if (patch % a.bt == 0 && tid < 4) mom[(patch / a.bt) * 16 + 4 + tid] = get4(v1, tid);
      const float4 m1 = *reinterpret_cast<const float4*>(mg);
      const float4 is1 = inv_sd4(v1);
      float4 s = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n1 = (n1s[q] - m1) * is1;
        n1s[q] = n1;
        const float4 h2 = conv2_fwd<BF>(relu4(n1), rec);
        h2s[q] = h2;
        s = s + h2;
      }
      put_sums<BF>(part_w, patch, s, zero4(), red, lred);
    }
    grid.sync();
    flip();
    // F4: group mean m2; partial sum (h2 - m2)^2
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 s1, s2;
      get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
      const float4 m2 = scale4(s1, cnt_inv);
      if (patch % a.bt == 0 && tid < 4) mom[(patch / a.bt) * 16 + 8 + tid] = get4(m2, tid);
      float4 s = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float4 d = h2s[slot(patch) + pix(k)] - m2;
        s = s + d * d;
      }
      put_sums<BF>(part_w, patch, s, zero4(), red, lred);
    }
    grid.sync();
    flip();
    // F5: v2; n2; t = conv3(relu(n2)) + offs; the affine update and its ldj
    const float rescale = __ldg(rec + OFF_RESCALE);
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 s1, s2;
      get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
      const float4 v2 = scale4(s1, cnt_inv);
      const float* mg = mom + (patch / a.bt) * 16;
      if (patch % a.bt == 0 && tid < 4) mom[(patch / a.bt) * 16 + 12 + tid] = get4(v2, tid);
      const float4 m2 = *reinterpret_cast<const float4*>(mg + 8);
      const float4 is2 = inv_sd4(v2);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n2 = (h2s[q] - m2) * is2;
        h2s[q] = n2;
        sA[pix(k)] = rnd4<BF>(relu4(n2));
      }
      __syncthreads();
      float4 t[PPT];
      conv3_fwd<BF>(sA, rec, a.offs + static_cast<size_t>(idx) * NPIX, r0, c, t);
      float lsum = 0.f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        if (KEEP) ts[q] = t[k];
        const float ls2 = rescale * tanhf(t[k].z), ls3 = rescale * tanhf(t[k].w);
        float4 v = a.cur[q];
        v.z = fmaf(v.z, expf(ls2), t[k].x);
        v.w = fmaf(v.w, expf(ls3), t[k].y);
        a.cur[q] = v;
        lsum += ls2 + ls3;
      }
      if (MODE != SEG_BWD) {  // the backward needs no ldj
        const float4 l = block_sum4(make_float4(lsum, 0.f, 0.f, 0.f), red);
        if (tid == 0) a.rows[patch * 3] += l.x;
      }
      __syncthreads();  // sA is read by conv3 of this patch
    }
  }

  if constexpr (MODE == SEG_FWD) {
    grid.sync();  // every group's moments are written
    put_bnmom(a);
    return;
  }

  // ---- z rows and the seed of the backward --------------------------------
  for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
    if constexpr (MODE == SEG_BWD) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        a.gcur[q] = __ldg(a.gz + q);
      }
      continue;
    }
    float zs = 0.f, z2 = 0.f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const size_t q = slot(patch) + pix(k);
      const float4 z = a.cur[q];
      zs += hsum4(z);
      z2 += dot4(z, z);
      a.gcur[q] = scale4(z, a.invb);
    }
    const float4 s = block_sum4(make_float4(zs, z2, 0.f, 0.f), red);
    if (tid == 0) {
      a.rows[patch * 3 + 1] = s.x;
      a.rows[patch * 3 + 2] = s.y;
    }
  }

  // ---- backward -----------------------------------------------------------
  for (int i = a.n_ops - 1; i >= 0; --i) {
    const int kind = a.ops[i] >> 8, idx = a.ops[i] & 255;
    const float4* xin = a.xin + i * BP;
    if (kind == OP_MIX) {
      const float* m = a.mixes + idx * 16;
      const float4 m0 = wld4<BF>(m), m1 = wld4<BF>(m + 4), m2 = wld4<BF>(m + 8),
                   m3 = wld4<BF>(m + 12);
      for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const size_t q = slot(patch) + pix(k);
          const float4 g = rnd4<BF>(a.gcur[q]);
          sA[pix(k)] = rnd4<BF>(xin[q]);
          sB[pix(k)] = g;
          a.gcur[q] = make_float4(dot4(m0, g), dot4(m1, g), dot4(m2, g), dot4(m3, g));
        }
        __syncthreads();
        wgrad(sA, sB, 1, 4, a.wpart + static_cast<size_t>(patch) * a.nw + a.nc * REC + idx * 16);
      }
      continue;
    }
    if (kind == OP_SCALE) {
      for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
        const float sa = a.sa[patch * a.ns + idx], sb = a.sb[patch * a.ns + idx];
        float ga = 0.f, gb = 0.f;
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const size_t q = slot(patch) + pix(k);
          const float4 g = a.gcur[q], v = xin[q], cl = __ldg(a.clean + q);
          float4 irt = make_float4(1.f / sqrtf(fmaf(sa, cl.x, sb)), 1.f / sqrtf(fmaf(sa, cl.y, sb)),
                                   1.f / sqrtf(fmaf(sa, cl.z, sb)), 1.f / sqrtf(fmaf(sa, cl.w, sb)));
          const float4 com = scale4(g * v * irt * irt * irt, -0.5f);
          ga += dot4(com, cl);
          gb += hsum4(com);
          a.gcur[q] = g * irt;
        }
        const float4 s = block_sum4(make_float4(ga, gb, 0.f, 0.f), red);
        if (tid == 0) {
          a.gsa[patch * a.ns + idx] = s.x;
          a.gsb[patch * a.ns + idx] = s.y;
        }
      }
      continue;
    }
    // coupling
    const float* rec = a.rec + static_cast<size_t>(idx) * REC;
    const float4* n1s = a.res + (static_cast<size_t>(idx) * 3 + 0) * BP;
    float4* n2s = a.res + (static_cast<size_t>(idx) * 3 + 1) * BP;
    float4* ts = a.res + (static_cast<size_t>(idx) * 3 + 2) * BP;
    float4* gts = a.gt + static_cast<size_t>(idx) * BP;
    const float* mom = a.mom + static_cast<size_t>(idx) * n_groups * 16;
    const float rescale = __ldg(rec + OFF_RESCALE);
    // Q1: gt; gradients of rescale, w3; gn2 = conv3^T(gt) * [n2 > 0]
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      __syncthreads();
      const float gl = MODE == SEG_BWD ? __ldg(a.gldj + patch) : a.gl;
      float grs = 0.f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 g = a.gcur[q], v = xin[q], t = ts[q];
        const float th2 = tanhf(t.z), th3 = tanhf(t.w);
        const float e2 = expf(rescale * th2), e3 = expf(rescale * th3);
        const float gls2 = fmaf(g.z * v.z, e2, gl), gls3 = fmaf(g.w * v.w, e3, gl);
        const float4 gtv = make_float4(g.z, g.w, gls2 * rescale * (1.f - th2 * th2),
                                       gls3 * rescale * (1.f - th3 * th3));
        grs += gls2 * th2 + gls3 * th3;
        gts[q] = gtv;
        sB[pix(k)] = rnd4<BF>(gtv);
        sA[pix(k)] = rnd4<BF>(relu4(n2s[q]));
        a.gcur[q] = make_float4(g.x, g.y, g.z * e2, g.w * e3);
      }
      const float4 s = block_sum4(make_float4(grs, 0.f, 0.f, 0.f), red);  // syncs sA, sB
      float* wp = a.wpart + static_cast<size_t>(patch) * a.nw + static_cast<size_t>(idx) * REC;
      if (tid == 0) wp[OFF_RESCALE] = s.x;
      wgrad(sA, sB, 9, 4, wp + OFF_W3);
      float4 gr2[PPT];
      conv3_bwd<BF>(sB, rec, r0, c, gr2);
      float4 p1 = zero4(), p2 = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n2 = n2s[q];
        const float4 gn2 = gr2[k] * pos4(n2);
        ts[q] = gn2;
        p1 = p1 + gn2;
        p2 = p2 + gn2 * n2;
      }
      put_sums<BF>(part_w, patch, p1, p2, red, lred);
    }
    grid.sync();
    flip();
    // Q2: gh2 = BN2 backward; gradient of w2; gn1 = (gh2 @ w2^T) * [n1 > 0]
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 s1, s2;
      get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
      const float4 mg = scale4(s1, cnt_inv), mgn = scale4(s2, cnt_inv);
      const float4 is2 = inv_sd4(*reinterpret_cast<const float4*>(mom + (patch / a.bt) * 16 + 12));
      float4 p1 = zero4(), p2 = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n2 = n2s[q], n1 = n1s[q];
        const float4 gh2 = rnd4<BF>(is2 * (ts[q] - mg - n2 * mgn));
        sA[pix(k)] = rnd4<BF>(relu4(n1));
        sB[pix(k)] = gh2;
        const float4 gn1 = conv2_bwd<BF>(gh2, rec) * pos4(n1);
        n2s[q] = gn1;
        p1 = p1 + gn1;
        p2 = p2 + gn1 * n1;
      }
      put_sums<BF>(part_w, patch, p1, p2, red, lred);  // also syncs sA, sB
      wgrad(sA, sB, 1, 4, a.wpart + static_cast<size_t>(patch) * a.nw +
                              static_cast<size_t>(idx) * REC + OFF_W2);
    }
    grid.sync();
    flip();
    // Q3: gh1 = BN1 backward; gradient of w1; x[..., 0:2] += conv1^T(gh1)
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 s1, s2;
      get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
      const float4 mg = scale4(s1, cnt_inv), mgn = scale4(s2, cnt_inv);
      const float4 is1 = inv_sd4(*reinterpret_cast<const float4*>(mom + (patch / a.bt) * 16 + 4));
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n1 = n1s[q];
        sB[pix(k)] = rnd4<BF>(is1 * (n2s[q] - mg - n1 * mgn));
        const float4 v = xin[q];
        sA[pix(k)] = rnd4<BF>(make_float4(v.x, v.y, 0.f, 0.f));
      }
      __syncthreads();
      wgrad(sA, sB, 9, 2, a.wpart + static_cast<size_t>(patch) * a.nw +
                              static_cast<size_t>(idx) * REC + OFF_W1);
      float2 gx[PPT];
      conv1_bwd<BF>(sB, rec, r0, c, gx);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        float4 g = a.gcur[q];
        g.x += gx[k].x;
        g.y += gx[k].y;
        a.gcur[q] = g;
      }
      __syncthreads();  // sA, sB are read until here
    }
  }
  grid.sync();

  // ---- sums over the batch, in patch order ---------------------------------
  const int gtid = blockIdx.x * THREADS + tid, gstride = gridDim.x * THREADS;
  for (int e = gtid; e < a.nw; e += gstride) {
    float s = 0.f;
    for (int p = 0; p < a.B; ++p) s += a.wpart[static_cast<size_t>(p) * a.nw + e];
    a.grad_w[e] = s;
  }
  for (int e = gtid; e < a.nc * NPIX; e += gstride) {
    const int ci = e / NPIX, px = e % NPIX;
    const float4* g = a.gt + static_cast<size_t>(ci) * BP + px;
    float4 s = zero4();
    for (int p = 0; p < a.B; ++p) s = s + g[slot(p)];
    reinterpret_cast<float4*>(a.goffs)[e] = s;
  }
  if (MODE == STEP) put_bnmom(a);
}

// ---------------------------------------------------------------------------
// running-statistics segment forward
// ---------------------------------------------------------------------------

struct SegArgs {
  const float4* x;      // [B, NPIX]
  float4* z;            // [B, NPIX]
  float* ldj;           // [B]
  const float* rec;     // [nc, REC]: BN folded into w1/b1 and w2/b2, or not (bnrun)
  const float4* offs;   // [nc, NPIX]
  const float* mixes;   // [nm, 16]
  const float4* bnrun;  // [nc, 4]: mean1, var1, mean2, var2 of each coupling's
                        // running BN, applied after each conv; null: folded in rec
  int B, n_ops;
  int ops[MAX_OPS];
};

template <bool BF>
__global__ void __launch_bounds__(THREADS)
segment_kernel(const SegArgs a) {
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

int check_ops(const int* ops, int n_ops, int nc, int nm, int ns, bool allow_scale) {
  if (n_ops < 0 || n_ops > MAX_OPS) return 1;
  for (int i = 0; i < n_ops; ++i) {
    const int kind = ops[i] >> 8, idx = ops[i] & 255;
    if (kind == OP_MIX && idx < nm) continue;
    if (kind == OP_COUPLING && idx < nc) continue;
    if (kind == OP_SCALE && allow_scale && idx < ns) continue;
    return 1;
  }
  return 0;
}

// float4 tiles of [B, NPIX] in a mode's float4 scratch: the chain state and
// its gradient where the caller does not give them, each op's input, the
// residuals of every coupling and their gradient of t (SEG_FWD keeps one
// coupling's residuals, reused).
long long scratch_tiles(int mode, int nc, int n_ops) {
  if (mode == SEG_FWD) return 3;
  return (mode == STEP ? 2 : 1) + n_ops + 4LL * nc;
}

// The sizes, the op list and the scratch pointers of one launch; the caller
// sets the inputs and outputs. STEP's scratch holds cur and gcur; SEG_BWD's
// holds cur (gcur is gx); SEG_FWD's holds neither (cur is z).
StepArgs make_args(int mode, int B, int bt, int ns, int nc, int nm, const int* ops, int n_ops,
                   float* scratch_f4, float* scratch_f, float* wpart) {
  StepArgs a{};
  const size_t bp = static_cast<size_t>(B) * NPIX;
  float4* f4 = reinterpret_cast<float4*>(scratch_f4);
  if (mode == SEG_FWD) {
    a.res = f4;
  } else {
    a.cur = f4;
    f4 += bp;
    if (mode == STEP) {
      a.gcur = f4;
      f4 += bp;
    }
    a.xin = f4;
    a.res = a.xin + n_ops * bp;
    a.gt = a.res + 3 * static_cast<size_t>(nc) * bp;
  }
  a.part = scratch_f;
  a.mom = scratch_f + 2 * static_cast<size_t>(B) * NPART;
  a.wpart = wpart;
  a.B = B;
  a.bt = bt;
  a.ns = ns;
  a.nc = nc;
  a.nm = nm;
  a.nw = nc * REC + nm * 16;
  a.n_ops = n_ops;
  for (int i = 0; i < n_ops; ++i) a.ops[i] = ops[i];
  return a;
}

// One cooperative launch of train_kernel<MODE, BF> on `stream`: as many CTAs
// as can be resident at once (occupancy API), at most B.
template <int MODE, bool BF>
int launch_train(StepArgs a, void* stream, int* launched) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, train_kernel<MODE, BF>, THREADS,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = a.B < per_sm * sms ? a.B : per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(train_kernel<MODE, BF>), dim3(grid),
                                    dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

template <int MODE>
int launch_train(StepArgs a, int bf16, void* stream, int* launched) {
  return bf16 ? launch_train<MODE, true>(a, stream, launched)
              : launch_train<MODE, false>(a, stream, launched);
}

bool bad_sizes(int B, int bt, int nc, int nm) {
  return B <= 0 || bt <= 0 || B % bt || nc <= 0 || nm <= 0;
}

}  // namespace

// Size of the device scratch of one launch in `mode` (0 the train step, 1
// the segment's ghost-BN forward, 2 its backward), in floats, for the wrapper
// to allocate: sizes[0] the float4 scratch (chain state, op inputs,
// residuals), sizes[1] the partial sums and group moments, sizes[2] the
// per-patch weight gradients (which must be zeroed; 0 in mode 1). Returns 0,
// or cudaErrorInvalidValue for bad sizes.
extern "C" int nf_train_scratch(int mode, int B, int bt, int nc, int nm, int n_ops,
                                long long* sizes) {
  if (B <= 0 || bt <= 0 || B % bt || nc < 0 || nm < 0 || n_ops < 0 || mode < STEP ||
      mode > SEG_BWD)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bp4 = static_cast<long long>(B) * NPIX * 4;
  sizes[0] = bp4 * scratch_tiles(mode, nc, n_ops);
  sizes[1] = 2LL * B * NPART + static_cast<long long>(nc) * (B / bt) * 16;
  sizes[2] = mode == SEG_FWD ? 0 : static_cast<long long>(B) * (nc * REC + nm * 16);
  return 0;
}

// One train step: forward and backward of the mean NLL over B patches with BN
// groups of bt (bt divides B), as one cooperative launch on `stream`.
// Inputs x, clean [B,32,32,4]; sa, sb [B, ns]; rec [nc, REC]; offs
// [nc,32,32,4]; mixes [nm,4,4]; ops (kind << 8 | index) in inverse order;
// the seeds invb = 1/B and gl = -1/B of the mean NLL.
// Outputs rows [B,3] (ldj, sum z, sum z^2), gsa/gsb [B, ns], grad_w
// [nc*REC + nm*16] (gradients of the records, then of the mixes), goffs
// [nc,32,32,4], bnmom [nc,16] (m1, v1, m2, v2 of each BN, averaged over the
// groups). scratch_f4, scratch_f, wpart as sized by nf_train_scratch (mode
// 0), wpart zeroed. Sets *launched to the kernel launches issued (1 or 0) and
// returns the launch error (cudaError_t), 0 if none. bf16 != 0 runs the
// bfloat16 mode (see the top of this file), 0 the float32 one.
extern "C" int nf_train_step(const float* x, const float* clean, const float* sa,
                             const float* sb, const float* rec, const float* offs,
                             const float* mixes, float* scratch_f4, float* scratch_f,
                             float* wpart, float* rows, float* gsa, float* gsb,
                             float* grad_w, float* goffs, float* bnmom, int B, int bt,
                             int ns, int nc, int nm, float invb, float gl, const int* ops,
                             int n_ops, int bf16, void* stream, int* launched) {
  *launched = 0;
  if (bad_sizes(B, bt, nc, nm) || ns <= 0 || check_ops(ops, n_ops, nc, nm, ns, true))
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a = make_args(STEP, B, bt, ns, nc, nm, ops, n_ops, scratch_f4, scratch_f, wpart);
  a.x = reinterpret_cast<const float4*>(x);
  a.clean = reinterpret_cast<const float4*>(clean);
  a.sa = sa;
  a.sb = sb;
  a.rec = rec;
  a.offs = reinterpret_cast<const float4*>(offs);
  a.mixes = mixes;
  a.rows = rows;
  a.gsa = gsa;
  a.gsb = gsb;
  a.grad_w = grad_w;
  a.goffs = goffs;
  a.bnmom = bnmom;
  a.invb = invb;
  a.gl = gl;
  return launch_train<STEP>(a, bf16, stream, launched);
}

// Ghost-BN forward of one [mix, coupling]* segment (no scale ops) over B
// patches with BN groups of bt, as one cooperative launch on `stream`:
// x [B,32,32,4] -> z [B,32,32,4], rows [B,3] whose first column is each
// patch's ldj (the others are zero), bnmom [nc,16] (the group
// moments averaged over the groups). rec [nc, REC] holds the records without
// BN folded in. scratch_f4 and scratch_f as sized by nf_train_scratch (mode
// 1). *launched, bf16 and the return value as above.
extern "C" int nf_segment_train_forward(const float* x, float* z, float* rows, float* bnmom,
                                        const float* rec, const float* offs,
                                        const float* mixes, float* scratch_f4,
                                        float* scratch_f, int B, int bt, int nc, int nm,
                                        const int* ops, int n_ops, int bf16, void* stream,
                                        int* launched) {
  *launched = 0;
  if (bad_sizes(B, bt, nc, nm) || check_ops(ops, n_ops, nc, nm, 0, false))
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a = make_args(SEG_FWD, B, bt, 1, nc, nm, ops, n_ops, scratch_f4, scratch_f, nullptr);
  a.x = reinterpret_cast<const float4*>(x);
  a.rec = rec;
  a.offs = reinterpret_cast<const float4*>(offs);
  a.mixes = mixes;
  a.cur = reinterpret_cast<float4*>(z);
  a.rows = rows;
  a.bnmom = bnmom;
  return launch_train<SEG_FWD>(a, bf16, stream, launched);
}

// Backward of that forward from the cotangents gz [B,32,32,4] and gldj [B],
// as one cooperative launch on `stream` that first recomputes the forward:
// gx [B,32,32,4], grad_w [nc*REC + nm*16] (records, then mixes; the b1/b2
// entries and every field the chain does not read are exactly zero), goffs
// [nc,32,32,4]. scratch_f4, scratch_f, wpart as sized by nf_train_scratch
// (mode 2), wpart zeroed. *launched, bf16 and the return value as above.
extern "C" int nf_segment_backward(const float* x, const float* gz, const float* gldj,
                                   const float* rec, const float* offs, const float* mixes,
                                   float* scratch_f4, float* scratch_f, float* wpart,
                                   float* gx, float* grad_w, float* goffs, int B, int bt,
                                   int nc, int nm, const int* ops, int n_ops, int bf16,
                                   void* stream, int* launched) {
  *launched = 0;
  if (bad_sizes(B, bt, nc, nm) || check_ops(ops, n_ops, nc, nm, 0, false))
    return static_cast<int>(cudaErrorInvalidValue);
  StepArgs a = make_args(SEG_BWD, B, bt, 1, nc, nm, ops, n_ops, scratch_f4, scratch_f, wpart);
  a.x = reinterpret_cast<const float4*>(x);
  a.gz = reinterpret_cast<const float4*>(gz);
  a.gldj = gldj;
  a.rec = rec;
  a.offs = reinterpret_cast<const float4*>(offs);
  a.mixes = mixes;
  a.gcur = reinterpret_cast<float4*>(gx);
  a.grad_w = grad_w;
  a.goffs = goffs;
  return launch_train<SEG_BWD>(a, bf16, stream, launched);
}

// Running-statistics forward of one [mix, coupling]* segment: x -> z and the
// per-patch log-det ldj [B]. rec holds the records with BN folded in and
// bnrun is null, or rec holds them without BN and bnrun [nc, 4, 4] the
// running mean1, var1, mean2, var2 of each coupling (the bfloat16 mode rounds
// the unfolded weights, as the TPU kernel does). One launch of B CTAs on
// `stream`; *launched, bf16 and the return value as above.
extern "C" int nf_segment_forward(const float* x, float* z, float* ldj, const float* rec,
                                  const float* offs, const float* mixes, const float* bnrun,
                                  int B, int nc, int nm, const int* ops, int n_ops, int bf16,
                                  void* stream, int* launched) {
  *launched = 0;
  if (B <= 0 || nc <= 0 || nm <= 0 || check_ops(ops, n_ops, nc, nm, 0, false))
    return static_cast<int>(cudaErrorInvalidValue);
  SegArgs a{};
  a.x = reinterpret_cast<const float4*>(x);
  a.z = reinterpret_cast<float4*>(z);
  a.ldj = ldj;
  a.rec = rec;
  a.offs = reinterpret_cast<const float4*>(offs);
  a.mixes = mixes;
  a.bnrun = reinterpret_cast<const float4*>(bnrun);
  a.B = B;
  a.n_ops = n_ops;
  for (int i = 0; i < n_ops; ++i) a.ops[i] = ops[i];
  if (bf16)
    segment_kernel<true><<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  else
    segment_kernel<false><<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) ++*launched;
  return err;
}
