// The fused sampler's template sample_kernel<BF, ABL, DESIGN, PPT> and the
// launcher that runs it stage by stage: fused_sample.cu describes the
// function and the design and instantiates ABL_FULL, DESIGN_PROD and
// PPT_PROD only (the production kernel); the probe library
// (sample_variants.cuh) also instantiates the ablations and designs that
// attribute the sampler's time, the Hopper counterparts of the TPU probes
// experiments/kernel_probe.py and experiments/kernel_sweep.py.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int H = 32, W = 32, NPIX = H * W;
constexpr int PPT_PROD = 4;              // production pixels a thread
constexpr int THREADS = NPIX / PPT_PROD; // production threads a CTA
constexpr int REC = 288;
// coupling record layout: see _REC_LAYOUT in ops/fused_sample.py
constexpr int OFF_W1 = 0, OFF_B1 = 72, OFF_W2 = 76, OFF_B2 = 92, OFF_W3 = 96,
              OFF_WIND = 240, OFF_BZ = 276, OFF_RESCALE = 280;
constexpr int MAX_OPS = 64;
constexpr float BN_EPS = 1e-4f;

enum Stage { APPLY = 0, MEAN1 = 1, VAR1 = 2, MEAN2 = 3, VAR2 = 4 };
enum OpKind { OP_MIX = 0, OP_SCALE = 1, OP_COUPLING = 2 };

// What a variant of the probe library leaves out or replaces; only
// ABL_FULL is the sampler's function.
enum Ablation {
  ABL_FULL = 0,      // the kernel as it is
  ABL_NOTRANS = 1,   // tanh u -> 0.9 u and exp u -> 1 + u in the coupling update
  ABL_NOSHIFT = 2,   // every 3x3 tap reads the thread's own pixel from
                     // registers: no neighbour reads from shared memory, no
                     // border branches, no indicator taps
  ABL_NOCOUPNN = 3,  // couplings skipped: mixes and scales only
};

// Design features, the bits of DESIGN; the production design is 0. None of
// them changes the function, only DESIGN_CONCAT_K the order of its sums.
constexpr int DESIGN_INTERLEAVE = 1;  // two patches a CTA, their op streams
                                      // interleaved in each thread
constexpr int DESIGN_CONCAT_K = 2;    // im2col in registers: each pixel's 3x3
                                      // neighbourhood gathered (zero outside,
                                      // the indicator as 9 more inputs), then
                                      // one dot loop against the [K, 4] weight
constexpr int DESIGN_PRECAST = 4;     // bfloat16: weights rounded once into a
                                      // shared-memory copy of each record and
                                      // of the mixes, not at every load
constexpr int DESIGN_PROD = 0;

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
// a record field: from device memory, or (SM) from the staged copy in
// shared memory
template <bool SM>
__device__ __forceinline__ float4 rld4(const float* p) {
  if constexpr (SM)
    return *reinterpret_cast<const float4*>(p);
  else
    return ldg4(p);
}
// a weight as a product's operand; the staged copy is rounded already
template <bool BF, bool SM = false>
__device__ __forceinline__ float4 wld4(const float* p) {
  if constexpr (SM)
    return rld4<true>(p);
  else
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
// Whether record field `off` is a weight that a product takes as its
// operand: w1, w2, w3 (not the biases, the indicator weights or rescale).
__device__ __forceinline__ bool is_weight(int off) {
  return off < OFF_B1 || (off >= OFF_W2 && off < OFF_B2) ||
         (off >= OFF_W3 && off < OFF_WIND);
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

// The thread's PPT pixels (column c, rows r0 + (32 / PPT) * k) of the
// normals of `seed` times temp. Rows r and r + 16 are one Box-Muller pair,
// so both lie in this thread.
template <int PPT>
__device__ __forceinline__ void draw_normals(unsigned seed, int patch, int r0,
                                             int c, float temp, float4 (&x)[PPT]) {
  constexpr int RPP = H / PPT;
  const uint2 key = make_uint2(seed, 0u);
#pragma unroll
  for (int k = 0; k < PPT / 2; ++k) {
    const unsigned hw = static_cast<unsigned>((r0 + RPP * k) * W + c);
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

// Sum of one float4 per thread over the block of NT threads, in a fixed
// order; every thread gets the result.
template <int NT>
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
  for (int i = 1; i < NT / 32; ++i) s = s + red[i];
  return s;
}

// conv 3x3 (SAME, zero fill) of x channels {0,1} -> 4 hidden channels, + b1,
// for the thread's PPT pixels (column c, rows r0 + (32 / PPT) * k). xs
// holds the operand as the mode takes it (rounded in bfloat16 mode).
template <bool BF, int PPT, bool SM>
__device__ __forceinline__ void conv1(const float2* xs, const float* rec,
                                      int r0, int c, float4 (&h)[PPT]) {
  constexpr int RPP = H / PPT;
  const float4 b1 = rld4<SM>(rec + OFF_B1);
#pragma unroll
  for (int k = 0; k < PPT; ++k) h[k] = b1;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int cc = c + dw - 1;
      if (cc < 0 || cc >= W) continue;
      const float4 w0 = wld4<BF, SM>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 0) * 4);
      const float4 w1 = wld4<BF, SM>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 1) * 4);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int rr = r0 + RPP * k + dh - 1;
        if (rr < 0 || rr >= H) continue;
        const float2 v = xs[rr * W + cc];
        h[k] = fma4(v.y, w1, fma4(v.x, w0, h[k]));
      }
    }
  }
}

// ABL_NOSHIFT's conv1: every tap reads the thread's own pixel (x, in
// registers).
template <bool BF, int PPT, bool SM>
__device__ __forceinline__ void conv1_centre(const float4 (&x)[PPT], const float* rec,
                                             float4 (&h)[PPT]) {
  const float4 b1 = rld4<SM>(rec + OFF_B1);
#pragma unroll
  for (int k = 0; k < PPT; ++k) h[k] = b1;
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const float4 w0 = wld4<BF, SM>(rec + OFF_W1 + (tap * 2 + 0) * 4);
    const float4 w1 = wld4<BF, SM>(rec + OFF_W1 + (tap * 2 + 1) * 4);
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      h[k] = fma4(rnd<BF>(x[k].y), w1, fma4(rnd<BF>(x[k].x), w0, h[k]));
  }
}

// DESIGN_CONCAT_K's conv1: each pixel's 2 x 9 neighbourhood gathered (zero
// outside the patch), then one dot loop against the [18, 4] weight w1.
template <bool BF, int PPT, bool SM>
__device__ __forceinline__ void conv1_im2col(const float2* xs, const float* rec,
                                             int r0, int c, float4 (&h)[PPT]) {
  constexpr int RPP = H / PPT;
  const float4 b1 = rld4<SM>(rec + OFF_B1);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float a[18];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int rr = r0 + RPP * k + tap / 3 - 1, cc = c + tap % 3 - 1;
      const bool in = rr >= 0 && rr < H && cc >= 0 && cc < W;
      const float2 v = in ? xs[rr * W + cc] : make_float2(0.f, 0.f);
      a[2 * tap] = v.x;
      a[2 * tap + 1] = v.y;
    }
    float4 acc = b1;
#pragma unroll
    for (int j = 0; j < 18; ++j) acc = fma4(a[j], wld4<BF, SM>(rec + OFF_W1 + 4 * j), acc);
    h[k] = acc;
  }
}

// 1x1 conv 4 -> 4, + b2
template <bool BF, bool SM = false>
__device__ __forceinline__ float4 conv2(float4 h, const float* rec) {
  h = rnd4<BF>(h);
  float4 o = rld4<SM>(rec + OFF_B2);
  o = fma4(h.x, wld4<BF, SM>(rec + OFF_W2 + 0), o);
  o = fma4(h.y, wld4<BF, SM>(rec + OFF_W2 + 4), o);
  o = fma4(h.z, wld4<BF, SM>(rec + OFF_W2 + 8), o);
  o = fma4(h.w, wld4<BF, SM>(rec + OFF_W2 + 12), o);
  return o;
}

// One row of taps (dh) of the zero-conv below.
template <bool BF, int PPT, bool SM>
__device__ __forceinline__ void conv3_row(const float4* hs, const float* rec, int r0, int c,
                                          int dh, float4 (&t)[PPT]) {
  constexpr int RPP = H / PPT;
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
    const int tap = dh * 3 + dw;
    const int cc = c + dw - 1;
    const bool col_in = cc >= 0 && cc < W;
    const float4 wi = rld4<SM>(rec + OFF_WIND + tap * 4);
    const float4 w0 = wld4<BF, SM>(rec + OFF_W3 + (tap * 4 + 0) * 4);
    const float4 w1 = wld4<BF, SM>(rec + OFF_W3 + (tap * 4 + 1) * 4);
    const float4 w2 = wld4<BF, SM>(rec + OFF_W3 + (tap * 4 + 2) * 4);
    const float4 w3 = wld4<BF, SM>(rec + OFF_W3 + (tap * 4 + 3) * 4);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int rr = r0 + RPP * k + dh - 1;
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
template <bool BF, int PPT, bool SM>
__device__ __forceinline__ void conv3(const float4* hs, const float* rec,
                                      int r0, int c, float4 (&t)[PPT]) {
  const float4 bz = rld4<SM>(rec + OFF_BZ);
#pragma unroll
  for (int k = 0; k < PPT; ++k) t[k] = bz;
  if constexpr (BF) {
    // rows not unrolled: unrolled, the rounded weights of three rows spill
#pragma unroll 1
    for (int dh = 0; dh < 3; ++dh) conv3_row<BF, PPT, SM>(hs, rec, r0, c, dh, t);
  } else {
#pragma unroll
    for (int dh = 0; dh < 3; ++dh) conv3_row<BF, PPT, SM>(hs, rec, r0, c, dh, t);
  }
}

// ABL_NOSHIFT's zero-conv: every tap reads the thread's own hidden pixel
// (hv, in registers, as the mode takes it); no indicator taps.
template <bool BF, int PPT, bool SM>
__device__ __forceinline__ void conv3_centre(const float4 (&hv)[PPT], const float* rec,
                                             float4 (&t)[PPT]) {
  const float4 bz = rld4<SM>(rec + OFF_BZ);
#pragma unroll
  for (int k = 0; k < PPT; ++k) t[k] = bz;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const float4 w0 = wld4<BF, SM>(rec + OFF_W3 + (tap * 4 + 0) * 4);
    const float4 w1 = wld4<BF, SM>(rec + OFF_W3 + (tap * 4 + 1) * 4);
    const float4 w2 = wld4<BF, SM>(rec + OFF_W3 + (tap * 4 + 2) * 4);
    const float4 w3 = wld4<BF, SM>(rec + OFF_W3 + (tap * 4 + 3) * 4);
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float4 v = hv[k];
      t[k] = fma4(v.w, w3, fma4(v.z, w2, fma4(v.y, w1, fma4(v.x, w0, t[k]))));
    }
  }
}

// DESIGN_CONCAT_K's zero-conv: each pixel's 4 x 9 neighbourhood gathered
// (zero outside) and its 9 indicator inputs (1 outside), then one dot loop
// against the [45, 4] weight that w3 and wind make, contiguous in the
// record (OFF_W3 .. OFF_BZ); the indicator weights are not rounded.
template <bool BF, int PPT, bool SM>
__device__ __forceinline__ void conv3_im2col(const float4* hs, const float* rec,
                                             int r0, int c, float4 (&t)[PPT]) {
  constexpr int RPP = H / PPT;
  const float4 bz = rld4<SM>(rec + OFF_BZ);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float a[45];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int rr = r0 + RPP * k + tap / 3 - 1, cc = c + tap % 3 - 1;
      const bool in = rr >= 0 && rr < H && cc >= 0 && cc < W;
      const float4 v = in ? hs[rr * W + cc] : make_float4(0.f, 0.f, 0.f, 0.f);
      a[4 * tap] = v.x;
      a[4 * tap + 1] = v.y;
      a[4 * tap + 2] = v.z;
      a[4 * tap + 3] = v.w;
      a[36 + tap] = in ? 0.f : 1.f;
    }
    float4 acc = bz;
#pragma unroll
    for (int j = 0; j < 45; ++j)
      acc = fma4(a[j], j < 36 ? wld4<BF, SM>(rec + OFF_W3 + 4 * j) : rld4<SM>(rec + OFF_W3 + 4 * j),
                 acc);
    t[k] = acc;
  }
}

// Copies a coupling record (src) into shared memory (dst), its weights
// rounded as the mode takes them (DESIGN_PRECAST); the caller synchronises.
template <bool BF, int NT>
__device__ __forceinline__ void stage_record(float* dst, const float* src) {
  for (int i = threadIdx.x; i < REC; i += NT) {
    const float v = __ldg(src + i);
    dst[i] = is_weight(i) ? rnd<BF>(v) : v;
  }
}

// Dynamic shared memory of a design: the second patch's tiles
// (DESIGN_INTERLEAVE: both patches' hs, then both xs) and the staged record
// and mixes (DESIGN_PRECAST, bfloat16).
template <bool BF, int DESIGN>
constexpr int dyn_floats() {
  return ((DESIGN & DESIGN_INTERLEAVE) ? 2 * NPIX * 6 : 0) +
         ((BF && (DESIGN & DESIGN_PRECAST)) ? REC + MAX_OPS * 16 : 0);
}

// One launch of the chain over ops [op_begin, op_end) (stage APPLY) or one
// statistics stage of the coupling at op_begin, for NP patches a CTA (NP =
// 2 with DESIGN_INTERLEAVE: patches 2 blockIdx and 2 blockIdx + 1), with
// NPIX / PPT threads.
template <bool BF, int ABL, int DESIGN, int PPT>
__global__ void __launch_bounds__(NPIX / PPT)
sample_kernel(const Args a) {
  constexpr int NT = NPIX / PPT, RPP = H / PPT;
  constexpr int NP = (DESIGN & DESIGN_INTERLEAVE) ? 2 : 1;
  constexpr bool CK = (DESIGN & DESIGN_CONCAT_K) != 0;
  constexpr bool SM = BF && (DESIGN & DESIGN_PRECAST) != 0;
  constexpr bool SHIFT = ABL != ABL_NOSHIFT;
  __shared__ float2 xs1[NP == 1 && SHIFT ? NPIX : 1];   // x channels {0,1}: conv1 input
  __shared__ float4 hs1[NP == 1 && SHIFT ? NPIX : 1];   // hidden map: zero-conv input
  __shared__ float4 red[NT / 32];
  extern __shared__ float4 dyn[];
  float4* const hs = NP == 1 ? hs1 : dyn;
  float2* const xs = NP == 1 ? xs1 : reinterpret_cast<float2*>(dyn + NP * NPIX);
  float* const srec = reinterpret_cast<float*>(dyn) + (NP == 1 ? 0 : 2 * NPIX * 6);
  float* const smix = srec + REC;

  const int tid = threadIdx.x;
  const int c = tid % W;
  const int r0 = tid / W;
  int patch[NP];
  bool valid[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    patch[j] = blockIdx.x * NP + j;
    valid[j] = NP == 1 || patch[j] < a.B;   // one patch a CTA: grid = B
  }

  float4 x[NP][PPT];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const size_t base = static_cast<size_t>(patch[j]) * NPIX * 4;
    if (!valid[j]) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) x[j][k] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (a.src == nullptr) {
      draw_normals<PPT>(a.seed, patch[j], r0, c, a.temp, x[j]);
    } else {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int p = tid + NT * k;
        x[j][k] = reinterpret_cast<const float4*>(a.src + base)[p];
      }
    }
  }

  // BatchNorm moments of each patch's group (batch mode, coupling stages).
  const int first = a.op_begin < a.op_end ? a.ops[a.op_begin] : 0;
  const bool at_coupling = a.op_begin < a.op_end && (first >> 8) == OP_COUPLING;
  float4 mean1[NP], var1[NP], mean2[NP], var2[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    mean1[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    var1[j] = mean2[j] = var2[j] = mean1[j];
    if (!(a.batch_bn && at_coupling && a.stage != MEAN1 && valid[j])) continue;
    const int g = patch[j] / a.bt, g0 = g * a.bt;
    const int count = min(a.bt, a.B - g0);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < count; i += NT)
      s = s + *reinterpret_cast<const float4*>(a.part_in + (size_t)(g0 + i) * 4);
    s = scale4(block_sum4<NT>(s, red), 1.f / (static_cast<float>(count) * NPIX));
    float* m = a.mom + (size_t)g * 12;
    const bool writer = patch[j] == g0 && tid < 4;
    switch (a.stage) {
      case VAR1:
        mean1[j] = s;
        if (writer) m[tid] = get4(s, tid);
        break;
      case MEAN2:
        mean1[j] = *reinterpret_cast<const float4*>(m);
        var1[j] = s;
        if (writer) m[4 + tid] = get4(s, tid);
        break;
      case VAR2:
        mean1[j] = *reinterpret_cast<const float4*>(m);
        var1[j] = *reinterpret_cast<const float4*>(m + 4);
        mean2[j] = s;
        if (writer) m[8 + tid] = get4(s, tid);
        break;
      default:  // APPLY
        mean1[j] = *reinterpret_cast<const float4*>(m);
        var1[j] = *reinterpret_cast<const float4*>(m + 4);
        mean2[j] = *reinterpret_cast<const float4*>(m + 8);
        var2[j] = s;
    }
  }

  if (a.stage != APPLY) {
    // statistics stage of the coupling at op_begin: one partial sum per
    // channel of each patch, of h1 or h2 (mean stages) or of its squared
    // deviation from the group mean (variance stages)
    const float* rec = a.coup + (size_t)(first & 255) * REC;
    if constexpr (SM) {
      stage_record<BF, NT>(srec, rec);
      rec = srec;
    }
    if constexpr (SHIFT) {
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int k = 0; k < PPT; ++k)
          xs[j * NPIX + tid + NT * k] = make_float2(rnd<BF>(x[j][k].x), rnd<BF>(x[j][k].y));
    }
    if constexpr (SM || SHIFT) __syncthreads();
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float4 h[PPT];
      if constexpr (!SHIFT)
        conv1_centre<BF, PPT, SM>(x[j], rec, h);
      else if constexpr (CK)
        conv1_im2col<BF, PPT, SM>(xs + j * NPIX, rec, r0, c, h);
      else
        conv1<BF, PPT, SM>(xs + j * NPIX, rec, r0, c, h);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        float4 v = h[k];
        if (a.stage >= MEAN2) v = conv2<BF, SM>(relu4(bn4(v, mean1[j], var1[j])), rec);
        if (a.stage == VAR1 || a.stage == VAR2) {
          const float4 d = v - (a.stage == VAR1 ? mean1[j] : mean2[j]);
          v = d * d;
        }
        acc = acc + v;
      }
      acc = block_sum4<NT>(acc, red);
      if (tid == 0 && valid[j])
        *reinterpret_cast<float4*>(a.part_out + (size_t)patch[j] * 4) = acc;
    }
    return;
  }

  if constexpr (SM) {
    // the mixes of this launch, rounded once
    for (int i = tid; i < (a.op_end - a.op_begin) * 16; i += NT) {
      const int op = a.ops[a.op_begin + i / 16];
      if ((op >> 8) == OP_MIX) {
        const int e = (op & 255) * 16 + i % 16;
        smix[e] = rnd<BF>(__ldg(a.mixes + e));
      }
    }
    __syncthreads();
  }

  for (int i = a.op_begin; i < a.op_end; ++i) {
    const int kind = a.ops[i] >> 8, idx = a.ops[i] & 255;
    if (kind == OP_MIX) {
      const float* m = (SM ? smix : a.mixes) + idx * 16;
      const float4 m0 = wld4<BF, SM>(m), m1 = wld4<BF, SM>(m + 4), m2 = wld4<BF, SM>(m + 8),
                   m3 = wld4<BF, SM>(m + 12);
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float4 v = rnd4<BF>(x[j][k]);
          x[j][k] = fma4(v.w, m3, fma4(v.z, m2, fma4(v.y, m1, scale4(m0, v.x))));
        }
    } else if (kind == OP_SCALE) {
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        if (!valid[j]) continue;
        const size_t base = static_cast<size_t>(patch[j]) * NPIX * 4;
        const float sa = a.sa[(size_t)patch[j] * a.n_scale + idx];
        const float sb = a.sb[(size_t)patch[j] * a.n_scale + idx];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const float4 cl = ldg4(a.clean + base + (size_t)(tid + NT * k) * 4);
          x[j][k] = make_float4(x[j][k].x * sqrtf(fmaf(sa, cl.x, sb)),
                                x[j][k].y * sqrtf(fmaf(sa, cl.y, sb)),
                                x[j][k].z * sqrtf(fmaf(sa, cl.z, sb)),
                                x[j][k].w * sqrtf(fmaf(sa, cl.w, sb)));
        }
      }
    } else {  // OP_COUPLING
      if constexpr (ABL == ABL_NOCOUPNN) continue;
      const float* rec = a.coup + (size_t)idx * REC;
      if constexpr (SM || SHIFT) __syncthreads();  // the previous coupling is done reading
      if constexpr (SM) {
        stage_record<BF, NT>(srec, rec);
        rec = srec;
      }
      if constexpr (SHIFT) {
#pragma unroll
        for (int j = 0; j < NP; ++j)
#pragma unroll
          for (int k = 0; k < PPT; ++k)
            xs[j * NPIX + tid + NT * k] = make_float2(rnd<BF>(x[j][k].x), rnd<BF>(x[j][k].y));
      }
      if constexpr (SM || SHIFT) __syncthreads();
      float4 hv[NP][PPT];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        float4 h[PPT];
        if constexpr (!SHIFT)
          conv1_centre<BF, PPT, SM>(x[j], rec, h);
        else if constexpr (CK)
          conv1_im2col<BF, PPT, SM>(xs + j * NPIX, rec, r0, c, h);
        else
          conv1<BF, PPT, SM>(xs + j * NPIX, rec, r0, c, h);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          float4 v = h[k];
          if (a.batch_bn) v = bn4(v, mean1[j], var1[j]);
          v = conv2<BF, SM>(relu4(v), rec);
          if (a.batch_bn) v = bn4(v, mean2[j], var2[j]);
          if constexpr (SHIFT)
            hs[j * NPIX + tid + NT * k] = rnd4<BF>(relu4(v));
          else
            hv[j][k] = rnd4<BF>(relu4(v));
        }
      }
      if constexpr (SHIFT) __syncthreads();
      const float rescale = SM ? rec[OFF_RESCALE] : __ldg(rec + OFF_RESCALE);
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        float4 t[PPT];
        if constexpr (!SHIFT)
          conv3_centre<BF, PPT, SM>(hv[j], rec, t);
        else if constexpr (CK)
          conv3_im2col<BF, PPT, SM>(hs + j * NPIX, rec, r0, c, t);
        else
          conv3<BF, PPT, SM>(hs + j * NPIX, rec, r0, c, t);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if constexpr (ABL == ABL_NOTRANS) {
            const float ls0 = rescale * (t[k].z * 0.9f);
            const float ls1 = rescale * (t[k].w * 0.9f);
            x[j][k].z = (x[j][k].z - t[k].x) * (1.f - ls0);
            x[j][k].w = (x[j][k].w - t[k].y) * (1.f - ls1);
          } else {
            const float ls0 = rescale * tanhf(t[k].z);
            const float ls1 = rescale * tanhf(t[k].w);
            x[j][k].z = (x[j][k].z - t[k].x) * expf(-ls0);
            x[j][k].w = (x[j][k].w - t[k].y) * expf(-ls1);
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (!valid[j]) continue;
    const size_t base = static_cast<size_t>(patch[j]) * NPIX * 4;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      reinterpret_cast<float4*>(a.out + base)[tid + NT * k] = x[j][k];
  }
}

// Runs the chain on a's inputs (a.src is set per launch: eps, or null to
// draw the chain input in the kernel): one launch in running-BN mode; in
// batch-BN mode (a.batch_bn), for each coupling four statistics launches
// and one apply launch (ABL_NOCOUPNN has no BN and runs as one launch).
// `part` is scratch of 2*B*4 floats. Sets *launched to the kernel launches
// it issued and returns the first launch error (cudaError_t), 0 if none.
template <bool BF, int ABL, int DESIGN, int PPT>
int launch_chain(Args a, const float* eps, float* part, const int* ops, int n_ops,
                 cudaStream_t s, int* launched) {
  constexpr int NP = (DESIGN & DESIGN_INTERLEAVE) ? 2 : 1;
  constexpr int dyn = dyn_floats<BF, DESIGN>() * static_cast<int>(sizeof(float));
  if constexpr (dyn > 0) {  // once a kernel: above 48 KB only after this opt-in
    static const int set = static_cast<int>(cudaFuncSetAttribute(
        sample_kernel<BF, ABL, DESIGN, PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn));
    if (set) return set;
  }
  const int grid = (a.B + NP - 1) / NP;
  *launched = 0;
  auto launch = [&](int stage, int begin, int end, const float* src,
                    const float* part_in, float* part_out) -> int {
    a.stage = stage;
    a.op_begin = begin;
    a.op_end = end;
    a.src = src;
    a.part_in = part_in;
    a.part_out = part_out;
    sample_kernel<BF, ABL, DESIGN, PPT><<<grid, NPIX / PPT, dyn, s>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (err == 0) ++*launched;
    return err;
  };

  if (ABL == ABL_NOCOUPNN) a.batch_bn = 0;
  if (!a.batch_bn) return launch(APPLY, 0, n_ops, eps, nullptr, nullptr);

  auto next_coupling = [&](int i) {
    while (i < n_ops && (ops[i] >> 8) != OP_COUPLING) ++i;
    return i;
  };
  float* pa = part;
  float* pb = part + static_cast<size_t>(a.B) * 4;
  const float* cur = eps;
  int p = next_coupling(0);
  int err = 0;
  if (p > 0 || p == n_ops) {  // mix/scale ops before the first coupling
    if ((err = launch(APPLY, 0, p, eps, nullptr, nullptr))) return err;
    cur = a.out;
  }
  while (p < n_ops) {
    const int q = next_coupling(p + 1);
    if ((err = launch(MEAN1, p, p + 1, cur, nullptr, pa))) return err;
    if ((err = launch(VAR1, p, p + 1, cur, pa, pb))) return err;
    if ((err = launch(MEAN2, p, p + 1, cur, pb, pa))) return err;
    if ((err = launch(VAR2, p, p + 1, cur, pa, pb))) return err;
    if ((err = launch(APPLY, p, q, cur, pb, nullptr))) return err;
    cur = a.out;
    p = q;
  }
  return 0;
}

// The Args of a chain call, or the reason it is refused
// (cudaErrorInvalidValue): the checks and fields of nf_fused_sample.
inline int chain_args(Args& a, const float* eps, float* out, const float* clean,
                      const float* sa, const float* sb, const float* mixes,
                      const float* coup, float* mom, int B, int n_scale, int bt,
                      int batch_bn, const int* ops, int n_ops, int use_rng,
                      unsigned seed, float temp) {
  if (B <= 0 || bt <= 0 || n_scale <= 0 || n_ops < 0 || n_ops > MAX_OPS ||
      (!use_rng && eps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a = Args{};
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
  return 0;
}

}  // namespace
