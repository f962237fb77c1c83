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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int H = 32, W = 32, NPIX = H * W;
constexpr int THREADS = 256;
constexpr int PPT = NPIX / THREADS;   // pixels per thread: rows r0, r0+8, r0+16, r0+24
constexpr int ROWS_PER_PASS = THREADS / W;
constexpr int REC = 288;
// coupling record layout: see _REC_LAYOUT in ops/fused_sample.py
constexpr int OFF_W1 = 0, OFF_B1 = 72, OFF_W2 = 76, OFF_B2 = 92, OFF_W3 = 96,
              OFF_WIND = 240, OFF_BZ = 276, OFF_RESCALE = 280;
constexpr int MAX_OPS = 64;
constexpr float BN_EPS = 1e-4f;

enum Stage { APPLY = 0, MEAN1 = 1, VAR1 = 2, MEAN2 = 3, VAR2 = 4 };
enum OpKind { OP_MIX = 0, OP_SCALE = 1, OP_COUPLING = 2 };

struct Args {
  const float* src;      // [B, NPIX, 4] chain state at op_begin (may alias out);
                         // null: draw it, normals(seed) * temp
  unsigned seed;
  float temp;
  float* out;            // [B, NPIX, 4] chain state after op_end
  const float* clean;    // [B, NPIX, 4]
  const float* sa;       // [B, n_scale]
  const float* sb;       // [B, n_scale]
  const float* mixes;    // [n_mix, 4, 4]
  const float* coup;     // [n_coupling, REC]
  const float* part_in;  // [B, 4] per-patch sums of the previous stage
  float* part_out;       // [B, 4] per-patch sums of this stage
  float* mom;            // [n_groups, 12]: mean1, var1, mean2 of the coupling
  int B, n_scale, bt, stage, op_begin, op_end, batch_bn;
  int ops[MAX_OPS];      // kind << 8 | index
};

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
// acc + s * w
__device__ __forceinline__ float4 fma4(float s, float4 w, float4 acc) {
  return make_float4(fmaf(s, w.x, acc.x), fmaf(s, w.y, acc.y),
                     fmaf(s, w.z, acc.z), fmaf(s, w.w, acc.w));
}
__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f),
                     fmaxf(a.w, 0.f));
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
// v rounded to bfloat16 and back (nearest even) when BF, else v
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
__device__ __forceinline__ float get4(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// (h - mean) / sqrt(var + eps), per channel
__device__ __forceinline__ float4 bn4(float4 h, float4 mean, float4 var) {
  float4 d = h - mean;
  return make_float4(d.x / sqrtf(var.x + BN_EPS), d.y / sqrtf(var.y + BN_EPS),
                     d.z / sqrtf(var.z + BN_EPS), d.w / sqrtf(var.w + BN_EPS));
}

// Philox-4x32-10 (Salmon et al., SC '11; Random123's philox4x32 with 10
// rounds): the key is bumped between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// Box-Muller on the 24 high bits of each word; full-precision logf, sqrtf and
// sincosf (no fast-math intrinsics).
__device__ __forceinline__ void box_muller(unsigned bits1, unsigned bits2,
                                           float& n_cos, float& n_sin) {
  constexpr float TWO_M24 = 5.9604644775390625e-08f;   // 2^-24
  constexpr float TWO_M25 = 2.98023223876953125e-08f;  // 2^-25
  constexpr float TWO_PI = 6.283185307179586f;
  const float u1 = static_cast<float>(bits1 >> 8) * TWO_M24 + TWO_M25;
  const float u2 = static_cast<float>(bits2 >> 8) * TWO_M24;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(TWO_PI * u2, &s, &c);
  n_cos = r * c;
  n_sin = r * s;
}

// The thread's PPT pixels (column c, rows r0 + ROWS_PER_PASS * k) of the
// normals of `seed` times temp. Rows r0 + 8k and r0 + 8k + 16 (k = 0, 1) are
// one Box-Muller pair, so both lie in this thread.
__device__ __forceinline__ void draw_normals(unsigned seed, int patch, int r0,
                                             int c, float temp, float4 (&x)[PPT]) {
  const uint2 key = make_uint2(seed, 0u);
#pragma unroll
  for (int k = 0; k < PPT / 2; ++k) {
    const unsigned hw = static_cast<unsigned>((r0 + ROWS_PER_PASS * k) * W + c);
    const uint4 b1 = philox4x32_10(make_uint4(hw, static_cast<unsigned>(patch), 0u, 0u), key);
    const uint4 b2 = philox4x32_10(make_uint4(hw, static_cast<unsigned>(patch), 1u, 0u), key);
    float4 lo, hi;
    box_muller(b1.x, b2.x, lo.x, hi.x);
    box_muller(b1.y, b2.y, lo.y, hi.y);
    box_muller(b1.z, b2.z, lo.z, hi.z);
    box_muller(b1.w, b2.w, lo.w, hi.w);
    x[k] = scale4(lo, temp);
    x[k + PPT / 2] = scale4(hi, temp);
  }
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
  for (int i = 1; i < THREADS / 32; ++i) s = s + red[i];
  return s;
}

// conv 3x3 (SAME, zero fill) of x channels {0,1} -> 4 hidden channels, + b1,
// for the thread's PPT pixels (column c, rows r0 + ROWS_PER_PASS * k). xs
// holds the operand as the mode takes it (rounded in bfloat16 mode).
template <bool BF>
__device__ __forceinline__ void conv1(const float2* xs, const float* rec,
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
        const float2 v = xs[rr * W + cc];
        h[k] = fma4(v.y, w1, fma4(v.x, w0, h[k]));
      }
    }
  }
}

// 1x1 conv 4 -> 4, + b2
template <bool BF>
__device__ __forceinline__ float4 conv2(float4 h, const float* rec) {
  h = rnd4<BF>(h);
  float4 o = ldg4(rec + OFF_B2);
  o = fma4(h.x, wld4<BF>(rec + OFF_W2 + 0), o);
  o = fma4(h.y, wld4<BF>(rec + OFF_W2 + 4), o);
  o = fma4(h.z, wld4<BF>(rec + OFF_W2 + 8), o);
  o = fma4(h.w, wld4<BF>(rec + OFF_W2 + 12), o);
  return o;
}

// One row of taps (dh) of the zero-conv below.
template <bool BF>
__device__ __forceinline__ void conv3_row(const float4* hs, const float* rec, int r0, int c,
                                          int dh, float4 (&t)[PPT]) {
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
    const int tap = dh * 3 + dw;
    const int cc = c + dw - 1;
    const bool col_in = cc >= 0 && cc < W;
    const float4 wi = ldg4(rec + OFF_WIND + tap * 4);
    const float4 w0 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 0) * 4);
    const float4 w1 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 1) * 4);
    const float4 w2 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 2) * 4);
    const float4 w3 = wld4<BF>(rec + OFF_W3 + (tap * 4 + 3) * 4);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int rr = r0 + ROWS_PER_PASS * k + dh - 1;
      if (!col_in || rr < 0 || rr >= H) {
        t[k] = t[k] + wi;
        continue;
      }
      const float4 v = hs[rr * W + cc];
      t[k] = fma4(v.w, w3, fma4(v.z, w2, fma4(v.y, w1, fma4(v.x, w0, t[k]))));
    }
  }
}

// zero-conv 3x3 of the hidden map: taps inside the patch read hs, taps
// outside add the indicator channel's weights; + bias. Outputs {0,1} are the
// shift and {2,3} the raw log-scale of channels {2,3}. hs holds the operand
// as the mode takes it.
template <bool BF>
__device__ __forceinline__ void conv3(const float4* hs, const float* rec,
                                      int r0, int c, float4 (&t)[PPT]) {
  const float4 bz = ldg4(rec + OFF_BZ);
#pragma unroll
  for (int k = 0; k < PPT; ++k) t[k] = bz;
  if constexpr (BF) {
    // rows not unrolled: unrolled, the rounded weights of three rows spill
#pragma unroll 1
    for (int dh = 0; dh < 3; ++dh) conv3_row<BF>(hs, rec, r0, c, dh, t);
  } else {
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) conv3_row<BF>(hs, rec, r0, c, dh, t);
  }
}

template <bool BF>
__global__ void __launch_bounds__(THREADS)
sample_kernel(const Args a) {
  __shared__ float2 xs[NPIX];   // x channels {0,1}: conv1 input
  __shared__ float4 hs[NPIX];   // hidden map: zero-conv input
  __shared__ float4 red[THREADS / 32];

  const int patch = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = tid % W;
  const int r0 = tid / W;
  const size_t base = static_cast<size_t>(patch) * NPIX * 4;

  float4 x[PPT];
  if (a.src == nullptr) {
    draw_normals(a.seed, patch, r0, c, a.temp, x);
  } else {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = tid + THREADS * k;
      x[k] = reinterpret_cast<const float4*>(a.src + base)[p];
    }
  }

  // BatchNorm moments of this patch's group (batch mode, coupling stages).
  const int first = a.op_begin < a.op_end ? a.ops[a.op_begin] : 0;
  const bool at_coupling = a.op_begin < a.op_end && (first >> 8) == OP_COUPLING;
  float4 mean1 = make_float4(0.f, 0.f, 0.f, 0.f), var1 = mean1, mean2 = mean1,
         var2 = mean1;
  if (a.batch_bn && at_coupling && a.stage != MEAN1) {
    const int g = patch / a.bt, g0 = g * a.bt;
    const int count = min(a.bt, a.B - g0);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < count; i += THREADS)
      s = s + *reinterpret_cast<const float4*>(a.part_in + (size_t)(g0 + i) * 4);
    s = scale4(block_sum4(s, red), 1.f / (static_cast<float>(count) * NPIX));
    float* m = a.mom + (size_t)g * 12;
    const bool writer = patch == g0 && tid < 4;
    switch (a.stage) {
      case VAR1:
        mean1 = s;
        if (writer) m[tid] = get4(s, tid);
        break;
      case MEAN2:
        mean1 = *reinterpret_cast<const float4*>(m);
        var1 = s;
        if (writer) m[4 + tid] = get4(s, tid);
        break;
      case VAR2:
        mean1 = *reinterpret_cast<const float4*>(m);
        var1 = *reinterpret_cast<const float4*>(m + 4);
        mean2 = s;
        if (writer) m[8 + tid] = get4(s, tid);
        break;
      default:  // APPLY
        mean1 = *reinterpret_cast<const float4*>(m);
        var1 = *reinterpret_cast<const float4*>(m + 4);
        mean2 = *reinterpret_cast<const float4*>(m + 8);
        var2 = s;
    }
  }

  if (a.stage != APPLY) {
    // statistics stage of the coupling at op_begin: one partial sum per
    // channel of this patch, of h1 or h2 (mean stages) or of its squared
    // deviation from the group mean (variance stages)
    const float* rec = a.coup + (size_t)(first & 255) * REC;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      xs[tid + THREADS * k] = make_float2(rnd<BF>(x[k].x), rnd<BF>(x[k].y));
    __syncthreads();
    float4 h[PPT];
    conv1<BF>(xs, rec, r0, c, h);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float4 v = h[k];
      if (a.stage >= MEAN2) v = conv2<BF>(relu4(bn4(v, mean1, var1)), rec);
      if (a.stage == VAR1 || a.stage == VAR2) {
        const float4 d = v - (a.stage == VAR1 ? mean1 : mean2);
        v = d * d;
      }
      acc = acc + v;
    }
    acc = block_sum4(acc, red);
    if (tid == 0) *reinterpret_cast<float4*>(a.part_out + (size_t)patch * 4) = acc;
    return;
  }

  for (int i = a.op_begin; i < a.op_end; ++i) {
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
    } else if (kind == OP_SCALE) {
      const float sa = a.sa[(size_t)patch * a.n_scale + idx];
      const float sb = a.sb[(size_t)patch * a.n_scale + idx];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float4 cl = ldg4(a.clean + base + (size_t)(tid + THREADS * k) * 4);
        x[k] = make_float4(x[k].x * sqrtf(fmaf(sa, cl.x, sb)),
                           x[k].y * sqrtf(fmaf(sa, cl.y, sb)),
                           x[k].z * sqrtf(fmaf(sa, cl.z, sb)),
                           x[k].w * sqrtf(fmaf(sa, cl.w, sb)));
      }
    } else {  // OP_COUPLING
      const float* rec = a.coup + (size_t)idx * REC;
      __syncthreads();  // the previous coupling is done reading xs and hs
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        xs[tid + THREADS * k] = make_float2(rnd<BF>(x[k].x), rnd<BF>(x[k].y));
      __syncthreads();
      float4 h[PPT];
      conv1<BF>(xs, rec, r0, c, h);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float4 v = h[k];
        if (a.batch_bn) v = bn4(v, mean1, var1);
        v = conv2<BF>(relu4(v), rec);
        if (a.batch_bn) v = bn4(v, mean2, var2);
        hs[tid + THREADS * k] = rnd4<BF>(relu4(v));
      }
      __syncthreads();
      float4 t[PPT];
      conv3<BF>(hs, rec, r0, c, t);
      const float rescale = __ldg(rec + OFF_RESCALE);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float ls0 = rescale * tanhf(t[k].z);
        const float ls1 = rescale * tanhf(t[k].w);
        x[k].z = (x[k].z - t[k].x) * expf(-ls0);
        x[k].w = (x[k].w - t[k].y) * expf(-ls1);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k)
    reinterpret_cast<float4*>(a.out + base)[tid + THREADS * k] = x[k];
}

// The normals of `seed` times temp, as sample_kernel draws its chain input.
__global__ void __launch_bounds__(THREADS)
rng_kernel(float* out, unsigned seed, float temp) {
  const int tid = threadIdx.x;
  float4 x[PPT];
  draw_normals(seed, blockIdx.x, tid / W, tid % W, temp, x);
  float4* o = reinterpret_cast<float4*>(out + static_cast<size_t>(blockIdx.x) * NPIX * 4);
#pragma unroll
  for (int k = 0; k < PPT; ++k) o[tid + THREADS * k] = x[k];
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
  if (B <= 0 || bt <= 0 || n_scale <= 0 || n_ops < 0 || n_ops > MAX_OPS ||
      (!use_rng && eps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (use_rng) eps = nullptr;  // every launch that starts the chain draws it
  Args a{};
  a.seed = seed;
  a.temp = temp;
  a.out = out;
  a.clean = clean;
  a.sa = sa;
  a.sb = sb;
  a.mixes = mixes;
  a.coup = coup;
  a.mom = mom;
  a.B = B;
  a.n_scale = n_scale;
  a.bt = bt;
  a.batch_bn = batch_bn;
  for (int i = 0; i < n_ops; ++i) a.ops[i] = ops[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  auto launch = [&](int stage, int begin, int end, const float* src,
                    const float* part_in, float* part_out) -> int {
    a.stage = stage;
    a.op_begin = begin;
    a.op_end = end;
    a.src = src;
    a.part_in = part_in;
    a.part_out = part_out;
    if (bf16)
      sample_kernel<true><<<B, THREADS, 0, s>>>(a);
    else
      sample_kernel<false><<<B, THREADS, 0, s>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (err == 0) ++*launched;
    return err;
  };

  if (!batch_bn) return launch(APPLY, 0, n_ops, eps, nullptr, nullptr);

  auto next_coupling = [&](int i) {
    while (i < n_ops && (ops[i] >> 8) != OP_COUPLING) ++i;
    return i;
  };
  float* pa = part;
  float* pb = part + static_cast<size_t>(B) * 4;
  const float* cur = eps;
  int p = next_coupling(0);
  int err = 0;
  if (p > 0 || p == n_ops) {  // mix/scale ops before the first coupling
    if ((err = launch(APPLY, 0, p, eps, nullptr, nullptr))) return err;
    cur = out;
  }
  while (p < n_ops) {
    const int q = next_coupling(p + 1);
    if ((err = launch(MEAN1, p, p + 1, cur, nullptr, pa))) return err;
    if ((err = launch(VAR1, p, p + 1, cur, pa, pb))) return err;
    if ((err = launch(MEAN2, p, p + 1, cur, pb, pa))) return err;
    if ((err = launch(VAR2, p, p + 1, cur, pa, pb))) return err;
    if ((err = launch(APPLY, p, q, cur, pb, nullptr))) return err;
    cur = out;
    p = q;
  }
  return 0;
}
