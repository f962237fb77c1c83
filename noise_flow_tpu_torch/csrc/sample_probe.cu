// Chains of dependent products for NVIDIA Hopper (sm_90a), plain C
// interface: the Hopper counterpart of the TPU probe
// experiments/mxu_bound_probe.py `pallas_mm_chain_rate`, which asked whether
// the fused sampler is bound by its products or by the latency of its
// chain: 56 dependent [bt*32, 128] x [128, 128] products a block of bt = 64
// patches, in float32 against bfloat16 (both operands rounded at every
// step, `x.astype(dt)`, float32 accumulation).
//
// nf_mm_chain takes the literal shape. Each CTA takes a [2048, 128] row
// block (64 patches of 32 rows) through all the products, 128 rows at a
// time (rows are independent, so the chain of one row is the chain of its
// tile):
// - float32: CUDA-core FMAs, the tile and the product's weight in shared
//   memory, 8 x 8 outputs a thread. 4.3 GFLOP a block at b = 8192
//   (481 GFLOP in all) over 67 TFLOP/s: bound by operations, 7.2 ms.
// - bfloat16: mma.sync.m16n8k16 with bf16 operands and float32 sums, the
//   tile stored in bfloat16 (the rounding the next product makes anyway)
//   and the weight transposed, both with rows padded to 136 so that the
//   fragments' 32-bit loads hit 32 banks; each warp owns 16 rows of the
//   tile, so only the weight's reload needs the whole CTA. Bound by
//   operations over 989 TFLOP/s: 0.49 ms at b = 8192.
//
// nf_px_chain takes the sampler's own shape: one patch a CTA, 1024 pixels,
// 56 dependent 4x4 channel products a pixel (the sampler's mixes),
// [B, 1024, 4] x [56, 4, 4]:
// - PX_F32: float32 FMAs, 16 a pixel a product, 4 pixels a thread;
// - PX_BF16_FMA: the same FMAs on bf16-rounded operands (the production
//   sampler's bfloat16 mode);
// - PX_BF16_MMA: mma.sync.m16n8k16, 16 pixels a tile, K padded from 4 to 16
//   and N from 4 to 8 (1/8 of the tile's products are useful). The lane that
//   holds outputs (pixel, n = 2t, 2t + 1) of one product holds inputs
//   (pixel, k = 2t, 2t + 1) of the next, so the chain stays in registers.
// Useful work: 32 FLOP a pixel a product, 15 GFLOP at b = 8192; bytes 268
// MB; bound by operations in float32 (0.22 ms), by bytes in bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int K = 128;         // the literal product's width
constexpr int TILE = 128;      // rows of a tile
constexpr int ROWS_CTA = 2048; // rows of a CTA: bt = 64 patches x 32 rows
constexpr int THREADS = 256;
constexpr int XS = K + 4;      // float32 tile row stride (floats)
constexpr int XB = K + 8;      // bfloat16 row stride (values): 68 words
constexpr int NPIX = 1024;

enum PxVariant { PX_F32 = 0, PX_BF16_FMA = 1, PX_BF16_MMA = 2 };

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// acc += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// float32: thread (ty, tx) = (tid / 16, tid % 16) computes rows ty + 16 r
// and columns tx + 16 j (r, j < 8) of each product.
__global__ void __launch_bounds__(THREADS)
mm_chain_f32(const float* x, const float* w, float* out, int rows, int n_mm) {
  extern __shared__ float4 dyn4[];
  float* xs = reinterpret_cast<float*>(dyn4);   // [TILE][XS]
  float* ws = xs + TILE * XS;                    // [K][K]
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int row_end = min(rows, static_cast<int>(blockIdx.x + 1) * ROWS_CTA);
  for (int t0 = blockIdx.x * ROWS_CTA; t0 < row_end; t0 += TILE) {
    __syncthreads();  // the previous tile is written out
    for (int i = tid; i < TILE * K / 4; i += THREADS) {
      const int r = i / (K / 4), c4 = i % (K / 4);
      *reinterpret_cast<float4*>(xs + r * XS + 4 * c4) = ldg4(x + (size_t)(t0 + r) * K + 4 * c4);
    }
    for (int m = 0; m < n_mm; ++m) {
      __syncthreads();  // xs holds this product's input; ws is free
      for (int i = tid; i < K * K / 4; i += THREADS)
        reinterpret_cast<float4*>(ws)[i] = ldg4(w + (size_t)m * K * K + 4 * i);
      __syncthreads();
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        float av[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) av[r] = xs[(ty + 16 * r) * XS + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = ws[k * K + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(av[r], bv[j], acc[r][j]);
      }
      __syncthreads();  // every thread is done reading xs
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) xs[(ty + 16 * r) * XS + tx + 16 * j] = acc[r][j];
    }
    __syncthreads();
    for (int i = tid; i < TILE * K / 4; i += THREADS) {
      const int r = i / (K / 4), c4 = i % (K / 4);
      *reinterpret_cast<float4*>(out + (size_t)(t0 + r) * K + 4 * c4) =
          *reinterpret_cast<const float4*>(xs + r * XS + 4 * c4);
    }
  }
}

// bfloat16: warp wp owns rows [16 wp, 16 wp + 16) of the tile; lane (g, t) =
// (lane / 4, lane % 4) holds the m16n8k16 fragments (rows g, g + 8; columns
// 2t, 2t + 1 and + 8).
__global__ void __launch_bounds__(THREADS)
mm_chain_bf16(const float* x, const float* w, float* out, int rows, int n_mm) {
  extern __shared__ float4 dyn4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dyn4);  // [TILE][XB]
  __nv_bfloat16* ws = xs + TILE * XB;                           // [n][XB]: w transposed
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_end = min(rows, static_cast<int>(blockIdx.x + 1) * ROWS_CTA);
  auto word = [](const __nv_bfloat16* p) { return *reinterpret_cast<const unsigned*>(p); };
  for (int t0 = blockIdx.x * ROWS_CTA; t0 < row_end; t0 += TILE) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < TILE * K / 2; i += THREADS) {
      const int r = i / (K / 2), c2 = i % (K / 2);
      const float2 v = __ldg(reinterpret_cast<const float2*>(x + (size_t)(t0 + r) * K) + c2);
      *reinterpret_cast<unsigned*>(xs + r * XB + 2 * c2) = pack_bf16(v.x, v.y);
    }
    for (int m = 0; m < n_mm; ++m) {
      __syncthreads();  // ws is free (and, at m = 0, xs is loaded)
      for (int i = tid; i < K * K; i += THREADS) {
        const int k = i / K, n = i % K;
        ws[n * XB + k] = __float2bfloat16_rn(__ldg(w + (size_t)m * K * K + i));
      }
      __syncthreads();
      float acc[K / 8][4];
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      const __nv_bfloat16* xa = xs + (16 * wp + g) * XB + 2 * t;
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        const unsigned a0 = word(xa + kk), a1 = word(xa + 8 * XB + kk);
        const unsigned a2 = word(xa + kk + 8), a3 = word(xa + 8 * XB + kk + 8);
#pragma unroll
        for (int nt = 0; nt < K / 8; ++nt) {
          const __nv_bfloat16* wb = ws + (8 * nt + g) * XB + kk + 2 * t;
          mma_bf16(acc[nt], a0, a1, a2, a3, word(wb), word(wb + 8));
        }
      }
      __syncwarp();  // the warp is done reading its rows
      if (m + 1 < n_mm) {
#pragma unroll
        for (int nt = 0; nt < K / 8; ++nt) {
          __nv_bfloat16* o = xs + (16 * wp + g) * XB + 8 * nt + 2 * t;
          *reinterpret_cast<unsigned*>(o) = pack_bf16(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<unsigned*>(o + 8 * XB) = pack_bf16(acc[nt][2], acc[nt][3]);
        }
        __syncwarp();
      } else {  // the last product's float32 sums are the output
        float* o = out + (size_t)(t0 + 16 * wp + g) * K + 2 * t;
#pragma unroll
        for (int nt = 0; nt < K / 8; ++nt) {
          *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(acc[nt][0], acc[nt][1]);
          *reinterpret_cast<float2*>(o + 8 * K + 8 * nt) = make_float2(acc[nt][2], acc[nt][3]);
        }
      }
    }
  }
}

// The sampler's shape with FMAs: y[co] = sum_ci x[ci] w[ci][co], as the
// sampler's mix op; BF rounds both operands.
template <bool BF>
__global__ void __launch_bounds__(THREADS)
px_chain_fma(const float* x, const float* w, float* out, int n_mm) {
  constexpr int PPT = NPIX / THREADS;
  const size_t base = static_cast<size_t>(blockIdx.x) * NPIX * 4;
  auto r4 = [](float4 v) {
    return BF ? make_float4(rnd(v.x), rnd(v.y), rnd(v.z), rnd(v.w)) : v;
  };
  float4 v[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) v[k] = ldg4(x + base + 4 * (threadIdx.x + THREADS * k));
  for (int m = 0; m < n_mm; ++m) {
    const float* wm = w + 16 * m;
    const float4 m0 = r4(ldg4(wm)), m1 = r4(ldg4(wm + 4)), m2 = r4(ldg4(wm + 8)),
                 m3 = r4(ldg4(wm + 12));
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const float4 u = r4(v[k]);
      v[k] = make_float4(fmaf(u.w, m3.x, fmaf(u.z, m2.x, fmaf(u.y, m1.x, m0.x * u.x))),
                         fmaf(u.w, m3.y, fmaf(u.z, m2.y, fmaf(u.y, m1.y, m0.y * u.x))),
                         fmaf(u.w, m3.z, fmaf(u.z, m2.z, fmaf(u.y, m1.z, m0.z * u.x))),
                         fmaf(u.w, m3.w, fmaf(u.z, m2.w, fmaf(u.y, m1.w, m0.w * u.x))));
    }
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k)
    *reinterpret_cast<float4*>(out + base + 4 * (threadIdx.x + THREADS * k)) = v[k];
}

// The sampler's shape with mma.sync: warp wp takes pixels [128 wp, 128 wp +
// 128) as 8 tiles of 16; lane (g, t) with t < 2 holds channels 2t, 2t + 1 of
// pixels g and g + 8 of each tile, the others hold the padding (zeros).
__global__ void __launch_bounds__(THREADS)
px_chain_mma(const float* x, const float* w, float* out, int n_mm) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = static_cast<size_t>(blockIdx.x) * NPIX * 4;
  unsigned a0[8], a1[8];
  float c[8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    const int p = 128 * wp + 16 * mt + g;
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (t < 2) {
      lo = __ldg(reinterpret_cast<const float2*>(x + base + 4 * p + 2 * t));
      hi = __ldg(reinterpret_cast<const float2*>(x + base + 4 * (p + 8) + 2 * t));
    }
    a0[mt] = pack_bf16(lo.x, lo.y);
    a1[mt] = pack_bf16(hi.x, hi.y);
  }
  for (int m = 0; m < n_mm; ++m) {
    // b0: k = 2t, 2t + 1 of column n = g (zero outside the 4 x 4 weight)
    const unsigned b0 = (t < 2 && g < 4) ? pack_bf16(__ldg(w + 16 * m + 4 * (2 * t) + g),
                                                     __ldg(w + 16 * m + 4 * (2 * t + 1) + g))
                                         : 0u;
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      c[mt][0] = c[mt][1] = c[mt][2] = c[mt][3] = 0.f;
      mma_bf16(c[mt], a0[mt], a1[mt], 0u, 0u, b0, 0u);
      a0[mt] = pack_bf16(c[mt][0], c[mt][1]);  // outputs 2t, 2t + 1 are next inputs
      a1[mt] = pack_bf16(c[mt][2], c[mt][3]);
    }
  }
  if (t < 2) {
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      const int p = 128 * wp + 16 * mt + g;
      *reinterpret_cast<float2*>(out + base + 4 * p + 2 * t) = make_float2(c[mt][0], c[mt][1]);
      *reinterpret_cast<float2*>(out + base + 4 * (p + 8) + 2 * t) =
          make_float2(c[mt][2], c[mt][3]);
    }
  }
}

template <typename Kern>
int opt_in(Kern kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// out = the chain of n_mm >= 1 products x [rows, 128] @ w[m] [128, 128]
// (float32 rows, rows a multiple of 128), in float32 (bf16 = 0) or with
// bfloat16 operands (bf16 = 1). Sets *launched and returns the launch
// error, 0 if none.
extern "C" int nf_mm_chain(int bf16, const float* x, const float* w, float* out, int rows,
                           int n_mm, void* stream, int* launched) {
  *launched = 0;
  if (rows <= 0 || rows % TILE || n_mm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (rows + ROWS_CTA - 1) / ROWS_CTA;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    constexpr int bytes = 2 * TILE * XB * 2;
    static const int set = opt_in(mm_chain_bf16, bytes);
    if (set) return set;
    mm_chain_bf16<<<grid, THREADS, bytes, s>>>(x, w, out, rows, n_mm);
  } else {
    constexpr int bytes = (TILE * XS + K * K) * 4;
    static const int set = opt_in(mm_chain_f32, bytes);
    if (set) return set;
    mm_chain_f32<<<grid, THREADS, bytes, s>>>(x, w, out, rows, n_mm);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched = 1;
  return err;
}

// out = the chain of n_mm >= 1 products x [B, 1024, 4] @ w[m] [4, 4] by
// `variant` (PxVariant), one patch a CTA. Sets *launched and returns the
// launch error, 0 if none.
extern "C" int nf_px_chain(int variant, const float* x, const float* w, float* out, int B,
                           int n_mm, void* stream, int* launched) {
  *launched = 0;
  if (B <= 0 || n_mm < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case PX_F32: px_chain_fma<false><<<B, THREADS, 0, s>>>(x, w, out, n_mm); break;
    case PX_BF16_FMA: px_chain_fma<true><<<B, THREADS, 0, s>>>(x, w, out, n_mm); break;
    case PX_BF16_MMA: px_chain_mma<<<B, THREADS, 0, s>>>(x, w, out, n_mm); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched = 1;
  return err;
}
