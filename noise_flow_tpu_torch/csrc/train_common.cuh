// Device code shared by the train kernels' library (fused_train.cu) and the
// probe library (train_probe.cu): the patch layout, float4 helpers, the
// convolutions of one coupling over a thread's pixels, the weight-gradient
// contraction, the launch arguments and the BatchNorm partial sums. See
// fused_train.cu for the design. Everything here has internal linkage, so
// each library holds its own copy.

#pragma once

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
// How a conv reads its record: WL 0 from device memory as it is (float32
// mode), 1 from device memory rounding each weight it loads (bfloat16 mode),
// 2 from a copy whose weights are rounded already (any memory space).
template <int WL>
__device__ __forceinline__ float4 wload4(const float* p) {
  if constexpr (WL == 2)
    return *reinterpret_cast<const float4*>(p);
  else
    return wld4<WL == 1>(p);
}
// a bias of the record
template <int WL>
__device__ __forceinline__ float4 bload4(const float* p) {
  if constexpr (WL == 2)
    return *reinterpret_cast<const float4*>(p);
  else
    return ldg4(p);
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
// (rounded in bfloat16 mode); the record is read as WL says (wload4)
// ---------------------------------------------------------------------------

// h = conv3x3(x[..., 0:2], w1) + b1, SAME zero fill; xs holds the patch.
template <bool BF, int WL = (BF ? 1 : 0)>
__device__ __forceinline__ void conv1_fwd(const float4* xs, const float* rec,
                                          int r0, int c, float4 (&h)[PPT]) {
  const float4 b1 = bload4<WL>(rec + OFF_B1);
#pragma unroll
  for (int k = 0; k < PPT; ++k) h[k] = b1;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int cc = c + dw - 1;
      if (cc < 0 || cc >= W) continue;
      const float4 w0 = wload4<WL>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 0) * 4);
      const float4 w1 = wload4<WL>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 1) * 4);
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
template <bool BF, int WL = (BF ? 1 : 0)>
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
      const float4 w0 = wload4<WL>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 0) * 4);
      const float4 w1 = wload4<WL>(rec + OFF_W1 + ((dh * 3 + dw) * 2 + 1) * 4);
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
template <bool BF, int WL = (BF ? 1 : 0)>
__device__ __forceinline__ float4 conv2_fwd(float4 h, const float* rec) {
  h = rnd4<BF>(h);
  float4 o = bload4<WL>(rec + OFF_B2);
  o = fma4(h.x, wload4<WL>(rec + OFF_W2 + 0), o);
  o = fma4(h.y, wload4<WL>(rec + OFF_W2 + 4), o);
  o = fma4(h.z, wload4<WL>(rec + OFF_W2 + 8), o);
  o = fma4(h.w, wload4<WL>(rec + OFF_W2 + 12), o);
  return o;
}

template <bool BF, int WL = (BF ? 1 : 0)>
__device__ __forceinline__ float4 conv2_bwd(float4 g, const float* rec) {
  g = rnd4<BF>(g);
  return make_float4(dot4(wload4<WL>(rec + OFF_W2 + 0), g), dot4(wload4<WL>(rec + OFF_W2 + 4), g),
                     dot4(wload4<WL>(rec + OFF_W2 + 8), g), dot4(wload4<WL>(rec + OFF_W2 + 12), g));
}

// t = conv3x3(hs, w3) + offs, SAME zero fill (the indicator taps are in offs)
template <bool BF, int WL = (BF ? 1 : 0)>
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
      const float4 w0 = wload4<WL>(rec + OFF_W3 + (tap * 4 + 0) * 4);
      const float4 w1 = wload4<WL>(rec + OFF_W3 + (tap * 4 + 1) * 4);
      const float4 w2 = wload4<WL>(rec + OFF_W3 + (tap * 4 + 2) * 4);
      const float4 w3 = wload4<WL>(rec + OFF_W3 + (tap * 4 + 3) * 4);
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
template <bool BF, int WL = (BF ? 1 : 0)>
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
      const float4 w0 = wload4<WL>(rec + OFF_W3 + (tap * 4 + 0) * 4);
      const float4 w1 = wload4<WL>(rec + OFF_W3 + (tap * 4 + 1) * 4);
      const float4 w2 = wload4<WL>(rec + OFF_W3 + (tap * 4 + 2) * 4);
      const float4 w3 = wload4<WL>(rec + OFF_W3 + (tap * 4 + 3) * 4);
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
                        // ([1, 3, B, NPIX], reused by every coupling, in
                        // SEG_FWD and where the backward recomputes them)
  float4* gt;           // scratch [nc, B, NPIX]: gradient of t
  float* part;          // scratch [2, B, NPART]: per-patch partial sums
  float* mom;           // scratch [nc, B / bt, 16]: group m1, v1, m2, v2
  float* wpart;         // scratch [B, nw]: per-patch weight gradients (zeroed
                        // where the kernel leaves entries unwritten)
  float* tpart;         // scratch [ceil(B / TCHUNK), nw + nc * NPIX * 4]: the
                        // batch sums' first level (the tree tail)
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

bool bad_sizes(int B, int bt, int nc, int nm) {
  return B <= 0 || bt <= 0 || B % bt || nc <= 0 || nm <= 0;
}

}  // namespace
