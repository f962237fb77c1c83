// Chains of dependent products for NVIDIA Hopper (sm_90a), plain C
// interface: the Hopper counterpart of the TPU probe
// experiments/mxu_bound_probe.py `pallas_mm_chain_rate`, which asked whether
// the fused sampler is bound by its products or by the latency of its
// chain: 56 dependent [bt*32, 128] x [128, 128] products a block of bt = 64
// patches, in float32 against bfloat16 (both operands rounded at every
// step, `x.astype(dt)`, float32 accumulation).
//
// nf_mm_chain takes the literal shape, [rows, 128] through n products (rows
// are independent, so the chain of one row is the chain of its tile). At
// the timed shape (262,144 rows, 56 products: 481 GFLOP; x read and out
// written once, 0.27 GB) both precisions are bound by operations: float32
// over 67 TFLOP/s 7.18 ms, bfloat16 over 989 TFLOP/s 0.486 ms. Two designs
// of each (ChainDesign):
//
// CHAIN_REDESIGN, for Hopper:
// - bfloat16 (mm_chain_bf16): chain_precast first rounds the n weights
//   to bfloat16 once a call, each laid out as the wgmma B operand wants it
//   (w^T, K-major, 128-byte swizzle: two [128 n][64 k] blocks of 16 KB),
//   into scratch the caller allocates. Then a persistent grid (one CTA an
//   SM) walks groups of NWG tiles of 64 rows. A producer warp keeps bulk
//   (TMA) copies of the 32 KB weights in flight into a ring of STAGES slots
//   in shared memory, completing on mbarriers; NWG consumer warpgroups each
//   own a 64-row tile and share each slot. A product is 8
//   wgmma.m64n128k16 with A from registers: the float32 accumulator of
//   product m, packed to bfloat16 (the reference's re-rounding, round to
//   nearest even), is the A fragment of product m + 1, since the
//   accumulator's and the A fragment's layouts line up. The tile is read
//   once (float32 -> bf16) and written once (float32) and never touches
//   shared memory in between. A slot is refilled once every consumer warp
//   is done with it, so the warpgroups may run up to STAGES products apart
//   and one's conversion overlaps another's products.
// - float32 (mm_chain_f32): CUDA-core FMAs with full float32 operands, a
//   persistent grid of 128-row tiles, each weight (64 KB) double-buffered by
//   one bulk (TMA) copy that lands while the previous product runs; the tile
//   transposed (k-major) in shared memory with its 16-byte chunks swizzled,
//   so that each thread's 8 x 8 register block makes 4 16-byte shared loads
//   per 64 FMAs (8 rows and 8 columns of one k) without bank conflicts; two
//   barriers a product (the tile is updated in place). The FMAs run in the
//   parent's order: the same bits.
//
// CHAIN_PARENT (the probe's first design, kept to attribute against):
// each CTA takes a [2048, 128] row block (64 patches of 32 rows) through all
// the products, 128 rows at a time:
// - float32: CUDA-core FMAs, the tile and the product's weight in shared
//   memory, 8 x 8 outputs a thread.
// - bfloat16: mma.sync.m16n8k16 with bf16 operands and float32 sums, the
//   tile stored in bfloat16 (the rounding the next product makes anyway)
//   and the weight transposed, both with rows padded to 136 so that the
//   fragments' 32-bit loads hit 32 banks; each warp owns 16 rows of the
//   tile, so only the weight's reload needs the whole CTA.
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

#include <algorithm>
#include <cstdint>

namespace {

constexpr int K = 128;         // the literal product's width
constexpr int TILE = 128;      // rows of a tile
constexpr int ROWS_CTA = 2048; // rows of a CTA: bt = 64 patches x 32 rows
constexpr int THREADS = 256;
constexpr int XS = K + 4;      // float32 tile row stride (floats)
constexpr int XB = K + 8;      // bfloat16 row stride (values): 68 words
constexpr int NPIX = 1024;

enum PxVariant { PX_F32 = 0, PX_BF16_FMA = 1, PX_BF16_MMA = 2 };
enum ChainDesign { CHAIN_REDESIGN = 0, CHAIN_PARENT = 1 };

// the redesign's constants
constexpr int W_ELEMS = K * K;           // one weight's values
constexpr int W_BF16_BYTES = W_ELEMS * 2;
constexpr int STAGES = 4;                // the bfloat16 weight ring's slots
constexpr int NWG = 3;                   // consumer warpgroups a CTA (bfloat16)
constexpr int F_SMEM = 2 * W_ELEMS * 4 + TILE * K * 4 + 2 * 8;

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
mm_chain_f32_parent(const float* x, const float* w, float* out, int rows, int n_mm) {
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
mm_chain_bf16_parent(const float* x, const float* w, float* out, int rows, int n_mm) {
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

// ---------------------------------------------------------------------------
// the redesign: Hopper's bulk copies (TMA), mbarriers and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// spin until the phase of parity `parity` of bar has completed; a wait that
// lasts seconds (a copy or an arrival that never comes) traps, so that a
// fault ends the launch with an error instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  unsigned spins = 0;
  do {
    if (++spins == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// one bulk (TMA) copy of `bytes` from global to shared memory that completes
// the current phase of bar (one arrival with the bytes expected)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The weights' values w[m][k][n] as the wgmma B operand wants them (K-major,
// 128-byte swizzle): [kb = k / 64][n][64], the 16-byte chunk c = (k % 64) / 8
// of row n stored at chunk c ^ (n % 8). One thread writes one chunk (8 k of
// one n), reading 8 coalesced rows of w; rounds to nearest even, as
// x.astype(bf16).
__global__ void chain_precast(const float* __restrict__ w, __nv_bfloat16* __restrict__ wb,
                              int n_mm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (m, c16 = k / 8, n)
  if (i >= n_mm * 16 * K) return;
  const int n = i & (K - 1), c = (i >> 7) & 15, m = i >> 11;
  const float* src = w + static_cast<size_t>(m) * W_ELEMS + 8 * c * K + n;
  uint4 v;
  v.x = pack_bf16(__ldg(src), __ldg(src + K));
  v.y = pack_bf16(__ldg(src + 2 * K), __ldg(src + 3 * K));
  v.z = pack_bf16(__ldg(src + 4 * K), __ldg(src + 5 * K));
  v.w = pack_bf16(__ldg(src + 6 * K), __ldg(src + 7 * K));
  const int kb = c >> 3, cc = c & 7;
  *reinterpret_cast<uint4*>(wb + static_cast<size_t>(m) * W_ELEMS + kb * (W_ELEMS / 2) + n * 64 +
                            ((cc ^ (n & 7)) * 8)) = v;
}

// the shared-memory descriptor of a K-major, 128-byte-swizzled B operand at
// shared address a: 1024 bytes between groups of 8 rows
__device__ __forceinline__ uint64_t desc_b128(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accesses of these registers across an
// asynchronous wgmma's start or wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
// d (64 x 128, float32) = (scale_d ? d : 0) + a (64 x 16, bf16, registers)
// * B (16 x 128, bf16, shared memory at descriptor b)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// bfloat16, redesigned: warps [0, 4 NWG) are the consumer warpgroups, warp
// 4 NWG the producer. Consumer warpgroup wg takes tile gi * NWG + wg of each
// group gi its CTA walks (a tile past the end computes on zeros and stores
// nothing, so that every warpgroup releases every slot). In the warpgroup,
// warp wq holds rows 16 wq + g and 16 wq + g + 8, lane (g, t) = (lane / 4,
// lane % 4): accumulator d[4 j + i] is row g + 8 (i / 2), column 8 j + 2 t +
// i % 2; the A fragment a[kk] is columns 16 kk + 2 t (+ 1, + 8, + 9) of rows
// g, g + 8, i.e. d[8 kk .. 8 kk + 7] packed in pairs.
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
mm_chain_bf16(const float* __restrict__ x, const __nv_bfloat16* __restrict__ wb,
              float* __restrict__ out, int rows, int n_mm) {
  extern __shared__ __align__(1024) unsigned char dyn[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * W_BF16_BYTES);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int tiles = rows / 64, groups = (tiles + NWG - 1) / NWG;
  if (warp == 4 * NWG) {  // the producer: one lane starts the ring's copies
    if (lane == 0) {
      int s = 0;
      unsigned ph = 0;
      for (int gi = blockIdx.x; gi < groups; gi += gridDim.x)
        for (int m = 0; m < n_mm; ++m) {
          mbar_wait(&empty[s], ph ^ 1);  // the slot's last use is done
          bulk_load(base + s * W_BF16_BYTES, wb + static_cast<size_t>(m) * W_ELEMS, W_BF16_BYTES,
                    &full[s]);
          if (++s == STAGES) s = 0, ph ^= 1;
        }
    }
    return;
  }
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const uint32_t ring = smem_u32(base);
  float d[64];
  uint32_t a[8][4];
  int s = 0;
  unsigned ph = 0;
  for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
    const int tile = gi * NWG + wg;
    const bool valid = tile < tiles;
    const size_t r0 = static_cast<size_t>(tile) * 64 + 16 * wq + g;  // rows r0, r0 + 8
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float2 v[4] = {};
      if (valid) {
        const float* p = x + r0 * K + 16 * kk + 2 * t;
        v[0] = __ldg(reinterpret_cast<const float2*>(p));
        v[1] = __ldg(reinterpret_cast<const float2*>(p + 8 * K));
        v[2] = __ldg(reinterpret_cast<const float2*>(p + 8));
        v[3] = __ldg(reinterpret_cast<const float2*>(p + 8 * K + 8));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(v[i].x, v[i].y);
    }
    for (int m = 0; m < n_mm; ++m) {
      mbar_wait(&full[s], ph);
      const uint32_t wa = ring + s * W_BF16_BYTES;
      fence_regs(a);
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_m64n128k16_rs(d, a[kk],
                            desc_b128(wa + (kk >> 2) * (W_BF16_BYTES / 2) + (kk & 3) * 32),
                            kk > 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(d);
      fence_regs(a);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the slot
      if (++s == STAGES) s = 0, ph ^= 1;
      if (m + 1 < n_mm) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
      }
    }
    if (valid) {  // the last product's float32 sums are the output
      float* o = out + r0 * K + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(o + 8 * j) = make_float2(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<float2*>(o + 8 * K + 8 * j) = make_float2(d[4 * j + 2], d[4 * j + 3]);
      }
    }
  }
}

// float32, redesigned: the tile stored transposed (k-major), so that each
// k-step loads the thread's 8 rows (2 x 16 bytes) and 8 columns (2 x 16
// bytes) and makes their outer product, 64 FMAs in registers: 4 loads per
// 64 FMAs. Row chunk p (4 rows) of k-row k sits at chunk p ^ ((k / 4) % 8),
// so that a warp's loads of the tile (4 chunks of one k-row) and the
// product's transposed stores (8 k-rows, one chunk each) hit distinct banks;
// the weight's row k is read as it lies (8 lanes on 128 contiguous bytes).
// Thread (ty, tx), ty = 4 (warp / 2) + lane / 8 and tx = 8 (warp % 2) + lane
// % 8, computes rows 4 ty + e, 64 + 4 ty + e and columns 4 tx + j, 64 + 4 tx
// + j (e, j < 4). Thread 0 starts the weights' bulk copies: product q of the
// CTA's sequence (q = tiles done x n_mm + m) reads slot q % 2, and the copy
// of product q + 2 into that slot starts once every thread has read it. The
// FMAs of an output run in k order from zero, as the parent's: the same
// bits.
__global__ void __launch_bounds__(THREADS, 1)
mm_chain_f32(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
             int rows, int n_mm) {
  extern __shared__ float4 dyn4[];
  float* ws = reinterpret_cast<float*>(dyn4);  // [2][K][K]
  float* xs = ws + 2 * W_ELEMS;                // [K][TILE], transposed, swizzled
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + TILE * K);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = 4 * (warp >> 1) + (lane >> 3), tx = 8 * (warp & 1) + (lane & 7);
  const int tiles = rows / TILE;
  const int total =
      (tiles - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / gridDim.x * n_mm;
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < 2 && q < total; ++q)
      bulk_load(ws + q * W_ELEMS, w + static_cast<size_t>(q % n_mm) * W_ELEMS, W_ELEMS * 4,
                &full[q]);
  int q = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const float* xt = x + static_cast<size_t>(tile) * TILE * K;
    for (int i = tid; i < TILE * K / 4; i += THREADS) {
      const int r = i >> 5, k4 = i & 31;
      const float4 v = ldg4(xt + 4 * i);
      float* d = xs + 4 * ((r >> 2) ^ (k4 & 7)) + (r & 3);
      d[(4 * k4) * TILE] = v.x;
      d[(4 * k4 + 1) * TILE] = v.y;
      d[(4 * k4 + 2) * TILE] = v.z;
      d[(4 * k4 + 3) * TILE] = v.w;
    }
    __syncthreads();
    for (int m = 0; m < n_mm; ++m, ++q) {
      const int st = q & 1;
      mbar_wait(&full[st], (q >> 1) & 1);
      const float* wm = ws + st * W_ELEMS;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 32
      for (int k = 0; k < K; ++k) {
        const int s = (k >> 2) & 7;
        const float4 a0 = *reinterpret_cast<const float4*>(xs + k * TILE + 4 * (ty ^ s));
        const float4 a1 = *reinterpret_cast<const float4*>(xs + k * TILE + 4 * ((16 + ty) ^ s));
        const float4 b0 = *reinterpret_cast<const float4*>(wm + k * K + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(wm + k * K + 64 + 4 * tx);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();  // every thread is done reading the tile and slot st
      if (tid == 0 && q + 2 < total)
        bulk_load(ws + st * W_ELEMS, w + static_cast<size_t>((q + 2) % n_mm) * W_ELEMS,
                  W_ELEMS * 4, &full[st]);
      if (m + 1 == n_mm) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* o = out + (static_cast<size_t>(tile) * TILE + 4 * ty + (i & 3) + 64 * (i >> 2)) * K;
          *reinterpret_cast<float4*>(o + 4 * tx) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(o + 64 + 4 * tx) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      } else {
        const int s = tx & 7;  // the swizzle of k-rows 4 tx + j and 64 + 4 tx + j
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* d = xs + (4 * tx + (j & 3) + 64 * (j >> 2)) * TILE;
          *reinterpret_cast<float4*>(d + 4 * (ty ^ s)) =
              make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
          *reinterpret_cast<float4*>(d + 4 * ((16 + ty) ^ s)) =
              make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
        }
        __syncthreads();  // the tile holds this product's output
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

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

int launch_precast(const float* w, void* wb, int n_mm, cudaStream_t s) {
  chain_precast<<<(n_mm * 16 * K + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      w, static_cast<__nv_bfloat16*>(wb), n_mm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wb (n_mm x 128 x 128 bfloat16 values) = w (float32 [n_mm, 128, 128])
// rounded to bfloat16 in the layout of the redesigned bfloat16 chain's B
// operand (chain_precast). Sets *launched and returns the launch error, 0 if
// none.
extern "C" int nf_chain_precast(const float* w, void* wb, int n_mm, void* stream,
                                int* launched) {
  *launched = 0;
  if (n_mm < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_precast(w, wb, n_mm, static_cast<cudaStream_t>(stream));
  if (err == 0) *launched = 1;
  return err;
}

// out = the chain of n_mm >= 1 products x [rows, 128] @ w[m] [128, 128]
// (float32 rows, rows a multiple of 128), in float32 (bf16 = 0) or with
// bfloat16 operands (bf16 = 1), by `design` (ChainDesign). The redesigned
// bfloat16 chain first rounds w into wb (n_mm x 128 x 128 bfloat16 values,
// the caller's scratch; unused otherwise): two launches. Sets *launched to
// the launches made and returns the launch error, 0 if none.
extern "C" int nf_mm_chain(int bf16, int design, const float* x, const float* w, void* wb,
                           float* out, int rows, int n_mm, void* stream, int* launched) {
  *launched = 0;
  if (rows <= 0 || rows % TILE || n_mm < 1 || (design != CHAIN_REDESIGN && design != CHAIN_PARENT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (design == CHAIN_PARENT) {
    const int grid = (rows + ROWS_CTA - 1) / ROWS_CTA;
    if (bf16) {
      constexpr int bytes = 2 * TILE * XB * 2;
      static const int set = opt_in(mm_chain_bf16_parent, bytes);
      if (set) return set;
      mm_chain_bf16_parent<<<grid, THREADS, bytes, s>>>(x, w, out, rows, n_mm);
    } else {
      constexpr int bytes = (TILE * XS + K * K) * 4;
      static const int set = opt_in(mm_chain_f32_parent, bytes);
      if (set) return set;
      mm_chain_f32_parent<<<grid, THREADS, bytes, s>>>(x, w, out, rows, n_mm);
    }
  } else if (bf16) {
    if (!wb) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_precast(w, wb, n_mm, s);
    if (err) return err;
    *launched = 1;
    constexpr int bytes = STAGES * W_BF16_BYTES + 1024 + 2 * STAGES * 8;
    static const int set = opt_in(mm_chain_bf16, bytes);
    if (set) return set;
    const int groups = (rows / 64 + NWG - 1) / NWG;
    mm_chain_bf16<<<std::min(groups, sm_count()), NWG * 128 + 32, bytes, s>>>(
        x, static_cast<const __nv_bfloat16*>(wb), out, rows, n_mm);
  } else {
    static const int set = opt_in(mm_chain_f32, F_SMEM);
    if (set) return set;
    mm_chain_f32<<<std::min(rows / TILE, sm_count()), THREADS, F_SMEM, s>>>(x, w, out, rows, n_mm);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launched += 1;
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
