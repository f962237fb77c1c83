// Attribution probes of the train kernels' template on NVIDIA Hopper (sm_90a),
// plain C interface: the Hopper counterparts of the TPU diagnostics of the
// one-shot and segment train kernels in experiments/. Each answers, at the
// flagship shapes (B = 138, BN groups of 69 or 138, float32 and bfloat16),
// the question its TPU probe asked; noise_flow_tpu_torch/probes/
// train_template.py drives them and names the TPU site each replaces.
//
// - Where the segment kernels' time goes (experiments/train_attrib.py
//   _fwd_kernel_variant, _bwd_kernel_variant): train_kernel<SEG_FWD> and
//   train_kernel<SEG_BWD> with a compile-time ablation, in the parent's
//   design and in the redesign. Those are the libraries of
//   train_variants.cuh, one a design and precision; this file holds the
//   other probes.
// - The cost of the ghost-BN moment reduction (bn_wgrad_probe.py bn_kernel):
//   8 chained ghost-BN normalisations of [B, 32, 32, 4] across CTAs, with the
//   production reduction (per-patch partials, grid.sync, fixed-order group
//   read), with none (each patch its own moments), with group-scoped
//   barriers, and with one pass of merged (sum, M2) partials.
// - The cost of the weight-gradient contraction (bn_wgrad_probe.py
//   wgrad_kernel): the production wgrad (taps over warps, a lane a column,
//   a butterfly) against bfloat16 mma.sync.m16n8k16 over the pixels, at the
//   3x3x4->4 and 4->4 shapes.
// - Launch cost with the step's operands and outputs (b138_launch_probe.py):
//   an empty kernel taking the step's StepArgs parameter block at the step's
//   grid, launched cooperatively and plainly; one that reads the step's whole
//   operand set and copies x; one that writes the step's whole output set.
// - Which feature of the call sets the floor (b138_floor_discriminate.py): a
//   no-op cooperative kernel, then with the step's resource request
//   (__launch_bounds__(256, 2) and its 32 KB of static shared memory), with
//   n grid.sync() (25 and 49: a segment backward's and a step's count), and
//   with the parent design's residual scratch written and read back; the
//   full body is the step kernel of train_variants.cuh.
//
// Every entry sets *launched to the kernel launches it issued and returns the
// launch error (cudaError_t), 0 if none.

#include "train_kernel.cuh"

namespace {

// The step kernel's grid: two CTAs an SM (its __launch_bounds__(256, 2) at
// 128 registers a thread leaves room for no third), at most B.
int step_grid(int B, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = B < 2 * sms ? B : 2 * sms;
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// chained ghost-BN normalisations
// ---------------------------------------------------------------------------

enum BnVariant { BN_PROD = 0, BN_LOCAL = 1, BN_GBAR = 2, BN_MERGE = 3 };

struct BnArgs {
  float4* x;       // [B, NPIX], normalised in place n times
  float* part;     // [2, B, NPART]
  unsigned* gbar;  // [B / bt], zeroed
  int B, bt, n;
};

// The barrier between two BN stages: grid.sync(), or (GBAR) each CTA
// announces its patches to their groups' arrival counters and waits only
// for the groups of its own patches. `epoch` counts the barriers.
template <bool GBAR>
__device__ __forceinline__ void bn_sync(cg::grid_group& grid, const BnArgs& b, unsigned& epoch) {
  if constexpr (!GBAR) {
    grid.sync();
  } else {
    ++epoch;
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      for (int p = blockIdx.x; p < b.B; p += gridDim.x) atomicAdd(b.gbar + p / b.bt, 1u);
      const unsigned want = epoch * static_cast<unsigned>(b.bt);
      for (int p = blockIdx.x; p < b.B; p += gridDim.x) {
        const volatile unsigned* cnt = b.gbar + p / b.bt;
        while (*cnt < want) {
        }
      }
      __threadfence();
    }
    __syncthreads();
  }
}

template <int VARIANT, bool BF>
__global__ void __launch_bounds__(THREADS, 2) bn_chain_kernel(const BnArgs b) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float4 red[WARPS];
  __shared__ float4 lred[BF ? 2 * WARPS * W : 1];
  StepArgs a{};  // the fields the BN helpers read
  a.B = b.B;
  a.bt = b.bt;
  const float cnt_inv = 1.f / (static_cast<float>(VARIANT == BN_LOCAL ? 1 : b.bt) * NPIX);
  float* part_w = b.part;
  float* part_r = b.part + static_cast<size_t>(b.B) * NPART;
  unsigned epoch = 0;
  auto sync = [&]() {
    bn_sync<VARIANT == BN_GBAR>(grid, b, epoch);
    float* t = part_r;
    part_r = part_w;
    part_w = t;
  };
  for (int it = 0; it < b.n; ++it) {
    if constexpr (VARIANT == BN_LOCAL) {
      for (int patch = blockIdx.x; patch < b.B; patch += gridDim.x) {
        float4 h[PPT], s = zero4();
#pragma unroll
        for (int k = 0; k < PPT; ++k) s = s + (h[k] = b.x[slot(patch) + pix(k)]);
        const float4 m = scale4(block_sum4(s, red), cnt_inv);
        float4 q = zero4();
#pragma unroll
        for (int k = 0; k < PPT; ++k) q = q + (h[k] - m) * (h[k] - m);
        const float4 is = inv_sd4(scale4(block_sum4(q, red), cnt_inv));
#pragma unroll
        for (int k = 0; k < PPT; ++k) b.x[slot(patch) + pix(k)] = (h[k] - m) * is;
      }
      continue;
    }
    if constexpr (VARIANT == BN_MERGE) {
      for (int patch = blockIdx.x; patch < b.B; patch += gridDim.x) {
        float4 h[PPT];
#pragma unroll
        for (int k = 0; k < PPT; ++k) h[k] = b.x[slot(patch) + pix(k)];
        put_patch_moments(part_w, patch, h, red);
      }
      sync();
      for (int patch = blockIdx.x; patch < b.B; patch += gridDim.x) {
        float4 m, v;
        group_merge(a, part_r, patch, red, cnt_inv, m, v);
        const float4 is = inv_sd4(v);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const size_t q = slot(patch) + pix(k);
          b.x[q] = (b.x[q] - m) * is;
        }
      }
      continue;
    }
    // BN_PROD, BN_GBAR: the train kernels' two passes
    for (int patch = blockIdx.x; patch < b.B; patch += gridDim.x) {
      float4 s = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) s = s + b.x[slot(patch) + pix(k)];
      put_sums<BF>(part_w, patch, s, zero4(), red, lred);
    }
    sync();
    for (int patch = blockIdx.x; patch < b.B; patch += gridDim.x) {
      float4 s1, s2;
      get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
      const float4 m = scale4(s1, cnt_inv);
      float4 s = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 d = b.x[q] - m;
        b.x[q] = d;  // centred: the variance pass reads d
        s = s + d * d;
      }
      put_sums<BF>(part_w, patch, s, zero4(), red, lred);
    }
    sync();
    for (int patch = blockIdx.x; patch < b.B; patch += gridDim.x) {
      float4 s1, s2;
      get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
      const float4 is = inv_sd4(scale4(s1, cnt_inv));
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        b.x[q] = b.x[q] * is;
      }
    }
  }
}

template <int VARIANT, bool BF>
int launch_bn(BnArgs b, void* stream, int* launched) {
  auto kernel = bn_chain_kernel<VARIANT, BF>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(b.gbar, 0, sizeof(unsigned) * (b.B / b.bt), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = b.B < per_sm * sms ? b.B : per_sm * sms;
  void* args[] = {&b};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS),
                                    args, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// the weight-gradient contraction
// ---------------------------------------------------------------------------

enum WgradVariant { WG_WARP = 0, WG_MMA = 1 };

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// out[(tap * 4 + ci) * 4 + co] = sum_p A[p + off(tap)][ci] * G[p][co] as
// bfloat16 mma.sync.m16n8k16 over the pixels: rows m = (tap, ci) (padded to
// 16s), columns n = co (4 of 8 used), depth k = pixels; warp w takes pixels
// [128 w, 128 w + 128), the warps' sums are added in warp order.
template <int NTAPS>
__device__ void wgrad_mma(const float4* as, const float4* gs, float* out, float* wred) {
  constexpr int M = NTAPS * 4, MT = (M + 15) / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  auto a_val = [&](int m, int p) -> float {
    if (m >= M) return 0.f;
    const int tap = m / 4, ci = m % 4;
    const int dh = NTAPS == 9 ? tap / 3 - 1 : 0, dw = NTAPS == 9 ? tap % 3 - 1 : 0;
    const int r = p / W + dh, cc = p % W + dw;
    if (r < 0 || r >= H || cc < 0 || cc >= W) return 0.f;
    return get4(as[r * W + cc], ci);
  };
  for (int kb = warp * 128; kb < warp * 128 + 128; kb += 16) {
    const float4 g0 = gs[kb + 2 * t], g1 = gs[kb + 2 * t + 1];
    const float4 g8 = gs[kb + 2 * t + 8], g9 = gs[kb + 2 * t + 9];
    const unsigned b0 = g < 4 ? pack_bf16(get4(g0, g), get4(g1, g)) : 0u;
    const unsigned b1 = g < 4 ? pack_bf16(get4(g8, g), get4(g9, g)) : 0u;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m0 = mt * 16 + g, m1 = m0 + 8;
      const int p = kb + 2 * t;
      const unsigned a0 = pack_bf16(a_val(m0, p), a_val(m0, p + 1));
      const unsigned a1 = pack_bf16(a_val(m1, p), a_val(m1, p + 1));
      const unsigned a2 = pack_bf16(a_val(m0, p + 8), a_val(m0, p + 9));
      const unsigned a3 = pack_bf16(a_val(m1, p + 8), a_val(m1, p + 9));
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(acc[mt][0]), "+f"(acc[mt][1]), "+f"(acc[mt][2]), "+f"(acc[mt][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    if (t < 2) {
      float* w = wred + (warp * MT + mt) * 64;
      w[g * 4 + 2 * t] = acc[mt][0];
      w[g * 4 + 2 * t + 1] = acc[mt][1];
      w[(g + 8) * 4 + 2 * t] = acc[mt][2];
      w[(g + 8) * 4 + 2 * t + 1] = acc[mt][3];
    }
  __syncthreads();
  for (int e = threadIdx.x; e < M * 4; e += THREADS) {
    const int mt = e / 64, r = e % 64;
    float s = 0.f;
    for (int ww = 0; ww < WARPS; ++ww) s += wred[(ww * MT + mt) * 64 + r];
    out[e] = s;
  }
  __syncthreads();
}

template <int VARIANT, int NTAPS>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(const float4* a_in, const float4* g_in,
                                                        float* out, int B) {
  __shared__ float4 as[NPIX];
  __shared__ float4 gs[NPIX];
  __shared__ float wred[VARIANT == WG_MMA ? WARPS * ((NTAPS * 4 + 15) / 16) * 64 : 1];
  constexpr int NOUT = NTAPS * 16;
  for (int patch = blockIdx.x; patch < B; patch += gridDim.x) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      as[pix(k)] = rnd4<true>(a_in[slot(patch) + pix(k)]);
      gs[pix(k)] = rnd4<true>(g_in[slot(patch) + pix(k)]);
    }
    __syncthreads();
    if constexpr (VARIANT == WG_WARP)
      wgrad(as, gs, NTAPS, 4, out + static_cast<size_t>(patch) * NOUT);
    else
      wgrad_mma<NTAPS>(as, gs, out + static_cast<size_t>(patch) * NOUT, wred);
  }
}

// ---------------------------------------------------------------------------
// launch and floor probes
// ---------------------------------------------------------------------------

enum LaunchVariant { L_COOP = 0, L_PLAIN = 1, L_OPERANDS = 2, L_OUTPUTS = 3 };
enum FloorVariant { FL_NOOP = 0, FL_BOUNDS = 1, FL_SYNCS = 2, FL_RESIDUALS = 3 };

__global__ void __launch_bounds__(THREADS) empty_kernel(const StepArgs a) {}

// the step's whole operand set read once across the grid, x copied into the
// chain state's scratch (the TPU probe staged its operands and copied x)
__global__ void __launch_bounds__(THREADS) operand_kernel(const StepArgs a) {
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;
  float4 s = zero4();
  for (int e = gtid; e < a.B * NPIX; e += gstride) {
    a.cur[e] = a.x[e];
    s = s + a.clean[e];
  }
  for (int e = gtid; e < a.nc * NPIX; e += gstride) s = s + a.offs[e];
  float t = hsum4(s);
  for (int e = gtid; e < a.B * a.ns; e += gstride) t += a.sa[e] + a.sb[e];
  for (int e = gtid; e < a.nc * REC; e += gstride) t += a.rec[e];
  for (int e = gtid; e < a.nm * 16; e += gstride) t += a.mixes[e];
  if (!(t < INFINITY)) a.rows[0] = t;  // never true for finite operands: keeps the reads
}

// the step's whole output set written
__global__ void __launch_bounds__(THREADS) output_kernel(const StepArgs a) {
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gstride = gridDim.x * THREADS;
  for (int e = gtid; e < a.B * 3; e += gstride) a.rows[e] = 0.f;
  for (int e = gtid; e < a.B * a.ns; e += gstride) a.gsa[e] = a.gsb[e] = 0.f;
  for (int e = gtid; e < a.nw; e += gstride) a.grad_w[e] = 0.f;
  for (int e = gtid; e < a.nc * NPIX; e += gstride)
    reinterpret_cast<float4*>(a.goffs)[e] = zero4();
  for (int e = gtid; e < a.nc * 16; e += gstride) a.bnmom[e] = 0.f;
}

// the step kernel's resource request: two CTAs an SM and its static shared memory
__global__ void __launch_bounds__(THREADS, 2) bounds_kernel(const StepArgs a) {
  __shared__ float4 sA[NPIX];
  __shared__ float4 sB[NPIX];
  sA[threadIdx.x] = sB[threadIdx.x] = zero4();
  __syncthreads();
  if (a.B < 0) a.rows[0] = sA[threadIdx.x ^ 1].x + sB[threadIdx.x ^ 2].x;  // never true
}

// n grid-wide barriers
__global__ void __launch_bounds__(THREADS, 2) sync_kernel(const StepArgs a, int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// n tiles of [B, NPIX] float4 from a.xin on: each CTA writes its patches'
// slots of every tile, then reads them back
__global__ void __launch_bounds__(THREADS, 2) residual_kernel(const StepArgs a, int n) {
  const size_t bp = static_cast<size_t>(a.B) * NPIX;
  for (int t = 0; t < n; ++t)
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x)
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        a.xin[t * bp + slot(patch) + pix(k)] = make_float4(static_cast<float>(t), 0.f, 0.f, 0.f);
  float s = 0.f;
  for (int t = 0; t < n; ++t)
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x)
#pragma unroll
      for (int k = 0; k < PPT; ++k) s += a.xin[t * bp + slot(patch) + pix(k)].x;
  if (s < 0.f) a.rows[0] = s;  // never true: keeps the reads
}

int launch_probe(void* kernel, bool coop, int grid, void** args, void* stream, int* launched) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = coop ? cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), args, 0, s)
                         : cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

int bn_variant(int variant, int bf16, BnArgs b, void* stream, int* launched) {
  switch (variant * 2 + (bf16 ? 1 : 0)) {
    case BN_PROD * 2: return launch_bn<BN_PROD, false>(b, stream, launched);
    case BN_PROD * 2 + 1: return launch_bn<BN_PROD, true>(b, stream, launched);
    case BN_LOCAL * 2: return launch_bn<BN_LOCAL, false>(b, stream, launched);
    case BN_GBAR * 2: return launch_bn<BN_GBAR, false>(b, stream, launched);
    case BN_GBAR * 2 + 1: return launch_bn<BN_GBAR, true>(b, stream, launched);
    case BN_MERGE * 2: return launch_bn<BN_MERGE, false>(b, stream, launched);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// n chained ghost-BN normalisations of x [B, 32, 32, 4] in place, groups of
// bt, one cooperative launch, `reps` times back to back; part [2, B, 256]
// and gbar [B / bt] scratch. variant: 0 production, 1 no cross-CTA
// reduction, 2 group-scoped barriers, 3 one-pass merged (sum, M2); 1 and 3
// float32 only (1 has no group sums to round, 3 no second pass).
extern "C" int nf_probe_bn_chain(int variant, int reps, float* x, float* part, unsigned* gbar,
                                 int B, int bt, int n, int bf16, void* stream, int* launched) {
  *launched = 0;
  if (B <= 0 || bt <= 0 || B % bt || n < 0 || reps < 1 ||
      ((variant == BN_LOCAL || variant == BN_MERGE) && bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  BnArgs b{reinterpret_cast<float4*>(x), part, gbar, B, bt, n};
  for (int r = 0; r < reps; ++r) {
    const int err = bn_variant(variant, bf16, b, stream, launched);
    if (err) return err;
  }
  return 0;
}

// Weight gradient of every patch: out [B, ntaps * 16] from the conv input a
// and the output gradient g, both [B, 32, 32, 4] and rounded to bfloat16 on
// load. ntaps 9 (3x3, 4 -> 4) or 1 (1x1, 4 -> 4); variant 0 the production
// wgrad, 1 mma.sync. One CTA a patch; `reps` launches back to back.
extern "C" int nf_probe_wgrad(int variant, int ntaps, int reps, const float* a, const float* g,
                              float* out, int B, void* stream, int* launched) {
  *launched = 0;
  if (B <= 0 || reps < 1 || (ntaps != 9 && ntaps != 1) ||
      (variant != WG_WARP && variant != WG_MMA))
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int r = 0; r < reps; ++r) {
    if (variant == WG_WARP && ntaps == 9) wgrad_kernel<WG_WARP, 9><<<B, THREADS, 0, s>>>(a4, g4, out, B);
    if (variant == WG_WARP && ntaps == 1) wgrad_kernel<WG_WARP, 1><<<B, THREADS, 0, s>>>(a4, g4, out, B);
    if (variant == WG_MMA && ntaps == 9) wgrad_kernel<WG_MMA, 9><<<B, THREADS, 0, s>>>(a4, g4, out, B);
    if (variant == WG_MMA && ntaps == 1) wgrad_kernel<WG_MMA, 1><<<B, THREADS, 0, s>>>(a4, g4, out, B);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    ++*launched;
  }
  return 0;
}

// A launch with the step's parameter block (the arguments of nf_train_step,
// production design) at the step's grid, `reps` times back to back: variant
// 0 an empty kernel launched cooperatively, 1 the same launched plainly, 2
// the step's operand set read and x copied to scratch_f4, 3 the step's
// output set written.
// Floor probes, variant 4 + k: 4 a no-op cooperative kernel, 5 with the
// step's __launch_bounds__(256, 2) and static shared memory, 6 with n
// grid.sync(), 7 with n tiles of [B, 32, 32, 4] written and read back from
// scratch_f4 on.
extern "C" int nf_probe_launch(int variant, int n, int reps, const float* x, const float* clean,
                               const float* sa, const float* sb, const float* rec,
                               const float* offs, const float* mixes, float* scratch_f4,
                               float* scratch_f, float* wpart, float* rows, float* gsa,
                               float* gsb, float* grad_w, float* goffs, float* bnmom, int B,
                               int bt, int ns, int nc, int nm, const int* ops, int n_ops,
                               void* stream, int* launched) {
  *launched = 0;
  StepArgs a;
  int err = reps < 1 ? static_cast<int>(cudaErrorInvalidValue)
                     : step_args(a, DESIGN_PROD, x, clean, sa, sb, rec, offs, mixes, scratch_f4,
                                 scratch_f, wpart, rows, gsa, gsb, grad_w, goffs, bnmom, B, bt,
                                 ns, nc, nm, 1.f, -1.f, ops, n_ops);
  int grid = 0;
  if (!err) err = step_grid(B, &grid);
  if (err) return err;
  a.xin = reinterpret_cast<float4*>(scratch_f4);
  void* args1[] = {&a};
  void* args2[] = {&a, &n};
  for (int r = 0; r < reps && !err; ++r) {
    switch (variant) {
      case L_COOP: err = launch_probe(reinterpret_cast<void*>(empty_kernel), true, grid, args1, stream, launched); break;
      case L_PLAIN: err = launch_probe(reinterpret_cast<void*>(empty_kernel), false, grid, args1, stream, launched); break;
      case L_OPERANDS: err = launch_probe(reinterpret_cast<void*>(operand_kernel), true, grid, args1, stream, launched); break;
      case L_OUTPUTS: err = launch_probe(reinterpret_cast<void*>(output_kernel), true, grid, args1, stream, launched); break;
      case 4 + FL_NOOP: err = launch_probe(reinterpret_cast<void*>(empty_kernel), true, grid, args1, stream, launched); break;
      case 4 + FL_BOUNDS: err = launch_probe(reinterpret_cast<void*>(bounds_kernel), true, grid, args1, stream, launched); break;
      case 4 + FL_SYNCS: err = launch_probe(reinterpret_cast<void*>(sync_kernel), true, grid, args2, stream, launched); break;
      case 4 + FL_RESIDUALS: err = launch_probe(reinterpret_cast<void*>(residual_kernel), true, grid, args2, stream, launched); break;
      default: err = static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return err;
}
