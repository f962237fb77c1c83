// The train kernels' template train_kernel<MODE, BF, DESIGN, ABL>: the one-shot
// step (STEP), the segment path's ghost-BN forward (SEG_FWD) and its
// backward (SEG_BWD), in float32 or bfloat16 (BF). fused_train.cu describes
// the function and the design and instantiates DESIGN_PROD with ABL_FULL
// only; the probe library train_probe.cu also instantiates the parent's
// design (DESIGN_PARENT) and the ablations that attribute the kernel's time.

#pragma once

#include "train_common.cuh"

namespace {

// What a variant of the probe library leaves out. A variant may break the
// numerics on purpose; only ABL_FULL is the kernel. The probe library
// instantiates SEG_BWD with ABL_FULL to ABL_FWD_ONLY and SEG_FWD with
// ABL_FULL, ABL_NO_EPI and ABL_NO_BN_STATS.
enum Ablation {
  ABL_FULL = 0,         // the kernel as it is
  ABL_NO_WGRAD = 1,     // no weight-gradient contractions, no weight sums
  ABL_BN_DIAG = 2,      // BN backward reduced to its diagonal term is * gn: no
                        // backward group means, partial sums or barriers
  ABL_NO_EPI = 3,       // no elementwise epilogues: SEG_BWD's reverse sweep
                        // without the tanh/exp terms of the affine update and
                        // the ReLU masks; SEG_FWD without the affine update and
                        // its ldj (the chain takes t)
  ABL_FWD_ONLY = 4,     // the forward stages alone (residuals kept), no backward
  ABL_NO_BN_STATS = 5,  // forward BN without moments (mean 0, variance 1): no
                        // partial sums and no barriers between the stages
};

// Design features, the bits of DESIGN. The parent's design (one CTA a
// patch, a grid-wide barrier at every BN stage, every residual in global
// scratch, batch sums one thread a weight in patch order) is 0.
constexpr int F_TAIL = 1;    // batch sums of the weight and offset gradients
                             // as a fixed-order two-level tree over the grid;
                             // every wpart entry that is read is written
constexpr int F_MERGE = 2;   // float32 mode: each patch's (sum, M2) merged over
                             // the group, one barrier per BN forward, not two
constexpr int F_WROUND = 8;  // bfloat16 mode: each coupling's record staged in
                             // shared memory with its weights rounded once, not
                             // at every load of a weight
constexpr int DESIGN_PARENT = 0;
constexpr int DESIGN_PROD = F_TAIL | F_MERGE | F_WROUND;
constexpr int TCHUNK = 16;   // patches in one first-level sum of the tree tail

// Whether field `off` of a record is a weight that a product takes as its
// operand: w1, w2, w3.
__device__ __forceinline__ bool is_weight(int off) {
  return off < OFF_B1 || (off >= OFF_W2 && off < OFF_B2) ||
         (off >= OFF_W3 && off < OFF_W3 + 9 * 16);
}

// Whether some patch writes weight-gradient entry e (records, then mixes):
// the weights, rescale and the mixes; the others, b1, b2 and the fields the
// chain does not read, are exactly zero.
__device__ __forceinline__ bool written_w(int e, int nc) {
  return e >= nc * REC || is_weight(e % REC) || e % REC == OFF_RESCALE;
}

// float32 mode with F_MERGE: the patch's partials are its sum and M2 (the
// squared deviations from its own mean), from each thread's h values.
__device__ __forceinline__ void put_patch_moments(float* part, int patch, const float4 (&h)[PPT],
                                                  float4* red) {
  float4 s = zero4();
#pragma unroll
  for (int k = 0; k < PPT; ++k) s = s + h[k];
  s = block_sum4(s, red);
  const float4 mp = scale4(s, 1.f / NPIX);
  float4 q = zero4();
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float4 d = h[k] - mp;
    q = q + d * d;
  }
  put_part(part, patch, s, block_sum4(q, red));
}

// The group's mean and biased variance from its patches' (sum, M2), merged
// in a fixed order: M2 = sum_p M2_p + NPIX * (mean_p - mean)^2.
__device__ void group_merge(const StepArgs& a, const float* part, int patch, float4* red,
                            float cnt_inv, float4& mean, float4& var) {
  const int g0 = patch / a.bt * a.bt;
  float4 s = zero4();
  for (int i = threadIdx.x; i < a.bt; i += THREADS)
    s = s + *reinterpret_cast<const float4*>(part + static_cast<size_t>(g0 + i) * NPART);
  mean = scale4(block_sum4(s, red), cnt_inv);
  float4 q = zero4();
  for (int i = threadIdx.x; i < a.bt; i += THREADS) {
    const float4* p = reinterpret_cast<const float4*>(part + static_cast<size_t>(g0 + i) * NPART);
    const float4 d = scale4(p[0], 1.f / NPIX) - mean;
    q = q + p[1] + scale4(d * d, static_cast<float>(NPIX));
  }
  var = scale4(block_sum4(q, red), cnt_inv);
}

// at most 128 registers a thread, so that two CTAs fit on an SM: the grid
// must be co-resident, and B = 138 patches on 132 SMs need two an SM
template <int MODE, bool BF, int DESIGN, int ABL>
__global__ void __launch_bounds__(THREADS, 2)
train_kernel(const StepArgs a) {
  constexpr bool TAIL = (DESIGN & F_TAIL) != 0;
  constexpr bool MERGE = (DESIGN & F_MERGE) != 0 && !BF;  // bf16 keeps two passes
  constexpr bool WROUND = (DESIGN & F_WROUND) != 0 && BF;
  constexpr int WL = WROUND ? 2 : BF ? 1 : 0;  // how the convs read a record (wload4)
  constexpr bool WGRAD = ABL != ABL_NO_WGRAD, BN_STATS = ABL != ABL_BN_DIAG;
  constexpr bool EPI = ABL != ABL_NO_EPI, BACKWARD = ABL != ABL_FWD_ONLY;
  constexpr bool FWD_STATS = ABL != ABL_NO_BN_STATS;
  constexpr bool FWD_EPI = !(MODE == SEG_FWD && ABL == ABL_NO_EPI);
  cg::grid_group grid = cg::this_grid();
  __shared__ float4 sA[NPIX];
  __shared__ float4 sB[NPIX];
  __shared__ float4 red[WARPS];
  __shared__ float4 lred[BF ? 2 * WARPS * W : 1];  // put_lanes, group_lane_sums
  __shared__ __align__(16) float wsm[WROUND ? REC : 4];  // the coupling's record

  const int tid = threadIdx.x;
  const int c = tid % W, r0 = tid / W;
  const size_t BP = static_cast<size_t>(a.B) * NPIX;
  const float cnt_inv = 1.f / (static_cast<float>(a.bt) * NPIX);
  const int n_groups = a.B / a.bt;
  float* part_w = a.part;                                  // written this stage
  float* part_r = a.part + static_cast<size_t>(a.B) * NPART;  // read this stage
  auto sync = [&]() {  // between two BN stages: the partials' buffers swap
    grid.sync();
    float* t = part_r;
    part_r = part_w;
    part_w = t;
  };
  // coupling idx's record as its convs read it: in device memory, or
  // (WROUND) staged in shared memory with its weights rounded, once for the
  // coupling's forward stages and once for its backward stages
  auto record = [&](int idx) -> const float* {
    const float* rec = a.rec + static_cast<size_t>(idx) * REC;
    if constexpr (WROUND) {
      __syncthreads();  // the previous coupling's convs are done with wsm
      for (int e = tid; e < REC; e += THREADS) wsm[e] = is_weight(e) ? rnd<true>(rec[e]) : rec[e];
      __syncthreads();
      return wsm;
    } else {
      return rec;
    }
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
    const float* rec = record(idx);
    const size_t ridx = KEEP ? idx : 0;
    float4* n1s = a.res + (ridx * 3 + 0) * BP;
    float4* h2s = a.res + (ridx * 3 + 1) * BP;
    float4* ts = a.res + (ridx * 3 + 2) * BP;
    float* mom = a.mom + static_cast<size_t>(idx) * n_groups * 16;
    // A BN's first stage: the patch's partials of its h values (the sum, and
    // merging, M2)
    auto put_moments = [&](int patch, const float4 (&h)[PPT]) {
      if constexpr (!FWD_STATS) {
      } else if constexpr (MERGE) {
        put_patch_moments(part_w, patch, h, red);
      } else {
        float4 s = zero4();
#pragma unroll
        for (int k = 0; k < PPT; ++k) s = s + h[k];
        put_sums<BF>(part_w, patch, s, zero4(), red, lred);
      }
    };
    // Two passes only: the group mean of the BN at mom offset o (0 or 8),
    // and the partial sums of (h - mean)^2 over the patch's tile hs
    auto variance_stage = [&](const float4* hs, int o) {
      if constexpr (FWD_STATS && !MERGE) {
        for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
          float4 s1, s2;
          get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
          const float4 m = scale4(s1, cnt_inv);
          if (patch % a.bt == 0 && tid < 4) mom[(patch / a.bt) * 16 + o + tid] = get4(m, tid);
          float4 s = zero4();
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            const float4 d = hs[slot(patch) + pix(k)] - m;
            s = s + d * d;
          }
          put_sums<BF>(part_w, patch, s, zero4(), red, lred);
        }
        sync();
      }
    };
    // after a BN's last stage: the group's mean and biased variance, each
    // group's written to mom at offset o (0 or 8) by its first patch
    auto moments = [&](int patch, int o, float4& m, float4& v) {
      if constexpr (!FWD_STATS) {
        m = zero4();
        v = make_float4(1.f, 1.f, 1.f, 1.f);
      } else if constexpr (MERGE) {
        group_merge(a, part_r, patch, red, cnt_inv, m, v);
        if (patch % a.bt == 0 && tid < 4) mom[(patch / a.bt) * 16 + o + tid] = get4(m, tid);
      } else {
        float4 s1, s2;
        get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
        v = scale4(s1, cnt_inv);
        m = *reinterpret_cast<const float4*>(mom + (patch / a.bt) * 16 + o);
      }
      if (patch % a.bt == 0 && tid < 4) mom[(patch / a.bt) * 16 + o + 4 + tid] = get4(v, tid);
    };
    // the end of a stage: the barrier of the BN, or without moments only
    // the CTA's (the stages share sA)
    auto end_stage = [&]() {
      if constexpr (FWD_STATS)
        sync();
      else
        __syncthreads();
    };
    // F1: h1 = conv1(x) + b1 (kept in n1s until normalised); its partials
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
      conv1_fwd<BF, WL>(sA, rec, r0, c, h);
#pragma unroll
      for (int k = 0; k < PPT; ++k) n1s[slot(patch) + pix(k)] = h[k];
      put_moments(patch, h);
    }
    end_stage();
    variance_stage(n1s, 0);  // F2
    // F3: n1 = (h1 - m1) / sd1; h2 = relu(n1) @ w2 + b2; its partials
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 m1, v1;
      moments(patch, 0, m1, v1);
      const float4 is1 = inv_sd4(v1);
      float4 h2[PPT];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n1 = (n1s[q] - m1) * is1;
        n1s[q] = n1;
        h2[k] = conv2_fwd<BF, WL>(relu4(n1), rec);
        h2s[q] = h2[k];
      }
      put_moments(patch, h2);
    }
    end_stage();
    variance_stage(h2s, 8);  // F4
    // F5: n2; t = conv3(relu(n2)) + offs; the affine update and its ldj
    float rescale;
    if constexpr (WROUND)
      rescale = rec[OFF_RESCALE];
    else
      rescale = __ldg(rec + OFF_RESCALE);
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 m2, v2;
      moments(patch, 8, m2, v2);
      const float4 is2 = inv_sd4(v2);
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n2 = (h2s[q] - m2) * is2;
        if (KEEP) h2s[q] = n2;
        sA[pix(k)] = rnd4<BF>(relu4(n2));
      }
      __syncthreads();
      float4 t[PPT];
      conv3_fwd<BF, WL>(sA, rec, a.offs + static_cast<size_t>(idx) * NPIX, r0, c, t);
      float lsum = 0.f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        if (KEEP) ts[q] = t[k];
        if constexpr (FWD_EPI) {
          const float ls2 = rescale * tanhf(t[k].z), ls3 = rescale * tanhf(t[k].w);
          float4 v = a.cur[q];
          v.z = fmaf(v.z, expf(ls2), t[k].x);
          v.w = fmaf(v.w, expf(ls3), t[k].y);
          a.cur[q] = v;
          lsum += ls2 + ls3;
        } else {
          a.cur[q] = t[k];
        }
      }
      if (MODE != SEG_BWD && FWD_EPI) {  // the backward needs no ldj
        const float4 l = block_sum4(make_float4(lsum, 0.f, 0.f, 0.f), red);
        if (tid == 0) a.rows[patch * 3] += l.x;
      }
      __syncthreads();  // sA is read by conv3 of this patch
    }
  }

  if constexpr (MODE == SEG_FWD || !BACKWARD) {
    grid.sync();  // every group's moments are written
    if (MODE != SEG_BWD) put_bnmom(a);
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
        if (WGRAD)
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
    const float* rec = record(idx);
    float4* n1s = a.res + (static_cast<size_t>(idx) * 3 + 0) * BP;
    float4* n2s = a.res + (static_cast<size_t>(idx) * 3 + 1) * BP;
    float4* ts = a.res + (static_cast<size_t>(idx) * 3 + 2) * BP;
    float4* gts = a.gt + static_cast<size_t>(idx) * BP;
    const float* mom = a.mom + static_cast<size_t>(idx) * n_groups * 16;
    float rescale;
    if constexpr (WROUND)
      rescale = rec[OFF_RESCALE];
    else
      rescale = __ldg(rec + OFF_RESCALE);
    // Q1: gt; gradients of rescale, w3; gn2 = conv3^T(gt) * [n2 > 0]
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      __syncthreads();
      const float gl = MODE == SEG_BWD ? __ldg(a.gldj + patch) : a.gl;
      float grs = 0.f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 g = a.gcur[q];
        float4 gtv = g;
        if constexpr (EPI) {
          const float4 v = xin[q], t = ts[q];
          const float th2 = tanhf(t.z), th3 = tanhf(t.w);
          const float e2 = expf(rescale * th2), e3 = expf(rescale * th3);
          const float gls2 = fmaf(g.z * v.z, e2, gl), gls3 = fmaf(g.w * v.w, e3, gl);
          gtv = make_float4(g.z, g.w, gls2 * rescale * (1.f - th2 * th2),
                            gls3 * rescale * (1.f - th3 * th3));
          grs += gls2 * th2 + gls3 * th3;
          a.gcur[q] = make_float4(g.x, g.y, g.z * e2, g.w * e3);
        }
        gts[q] = gtv;
        sB[pix(k)] = rnd4<BF>(gtv);
        sA[pix(k)] = rnd4<BF>(relu4(n2s[q]));
      }
      const float4 s = block_sum4(make_float4(grs, 0.f, 0.f, 0.f), red);  // syncs sA, sB
      float* wp = a.wpart + static_cast<size_t>(patch) * a.nw + static_cast<size_t>(idx) * REC;
      if (tid == 0) wp[OFF_RESCALE] = s.x;
      if (WGRAD) wgrad(sA, sB, 9, 4, wp + OFF_W3);
      float4 gr2[PPT];
      conv3_bwd<BF, WL>(sB, rec, r0, c, gr2);
      float4 p1 = zero4(), p2 = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n2 = n2s[q];
        const float4 gn2 = EPI ? gr2[k] * pos4(n2) : gr2[k];
        ts[q] = gn2;
        p1 = p1 + gn2;
        p2 = p2 + gn2 * n2;
      }
      if (BN_STATS) put_sums<BF>(part_w, patch, p1, p2, red, lred);
    }
    if (BN_STATS) sync();
    // Q2: gh2 = BN2 backward; gradient of w2; gn1 = (gh2 @ w2^T) * [n1 > 0]
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 mg = zero4(), mgn = zero4();
      if (BN_STATS) {
        float4 s1, s2;
        get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
        mg = scale4(s1, cnt_inv);
        mgn = scale4(s2, cnt_inv);
      } else {
        __syncthreads();  // sA, sB of the previous patch are no longer read
      }
      const float4 is2 = inv_sd4(*reinterpret_cast<const float4*>(mom + (patch / a.bt) * 16 + 12));
      float4 p1 = zero4(), p2 = zero4();
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const size_t q = slot(patch) + pix(k);
        const float4 n2 = n2s[q], n1 = n1s[q];
        const float4 gh2 = rnd4<BF>(is2 * (ts[q] - mg - n2 * mgn));
        sA[pix(k)] = rnd4<BF>(relu4(n1));
        sB[pix(k)] = gh2;
        const float4 gr1 = conv2_bwd<BF, WL>(gh2, rec);
        const float4 gn1 = EPI ? gr1 * pos4(n1) : gr1;
        n2s[q] = gn1;
        p1 = p1 + gn1;
        p2 = p2 + gn1 * n1;
      }
      if (BN_STATS)
        put_sums<BF>(part_w, patch, p1, p2, red, lred);  // also syncs sA, sB
      else
        __syncthreads();
      if (WGRAD)
        wgrad(sA, sB, 1, 4, a.wpart + static_cast<size_t>(patch) * a.nw +
                                static_cast<size_t>(idx) * REC + OFF_W2);
    }
    if (BN_STATS) sync();
    // Q3: gh1 = BN1 backward; gradient of w1; x[..., 0:2] += conv1^T(gh1)
    for (int patch = blockIdx.x; patch < a.B; patch += gridDim.x) {
      float4 mg = zero4(), mgn = zero4();
      if (BN_STATS) {
        float4 s1, s2;
        get_sums<BF>(a, part_r, patch, red, lred, s1, s2);
        mg = scale4(s1, cnt_inv);
        mgn = scale4(s2, cnt_inv);
      } else {
        __syncthreads();
      }
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
      if (WGRAD)
        wgrad(sA, sB, 9, 2, a.wpart + static_cast<size_t>(patch) * a.nw +
                                static_cast<size_t>(idx) * REC + OFF_W1);
      float2 gx[PPT];
      conv1_bwd<BF, WL>(sB, rec, r0, c, gx);
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

  // ---- sums over the batch -------------------------------------------------
  const int gtid = blockIdx.x * THREADS + tid, gstride = gridDim.x * THREADS;
  const int n4 = a.nc * NPIX;
  float4* goffs = reinterpret_cast<float4*>(a.goffs);
  if constexpr (TAIL) {
    // a fixed-order tree: first each run of TCHUNK patches, then the runs in
    // order; consecutive threads take consecutive entries
    const int nch = (a.B + TCHUNK - 1) / TCHUNK;
    float* tw = a.tpart;                                                  // [nch, nw]
    float4* t4 = reinterpret_cast<float4*>(a.tpart + static_cast<size_t>(nch) * a.nw);  // [nch, n4]
    const int n1 = nch * a.nw, items = n1 + nch * n4;
    for (int it = gtid; it < items; it += gstride) {
      if (it < n1) {
        const int ch = it / a.nw, e = it % a.nw;
        if (!WGRAD || !written_w(e, a.nc)) continue;
        const int p1 = min(a.B, (ch + 1) * TCHUNK);
        float s = 0.f;
#pragma unroll 4
        for (int p = ch * TCHUNK; p < p1; ++p) s += a.wpart[static_cast<size_t>(p) * a.nw + e];
        tw[it] = s;
      } else {
        const int j = it - n1, ch = j / n4, e = j % n4;
        const float4* g = a.gt + static_cast<size_t>(e / NPIX) * BP + e % NPIX;
        const int p1 = min(a.B, (ch + 1) * TCHUNK);
        float4 s = zero4();
#pragma unroll 4
        for (int p = ch * TCHUNK; p < p1; ++p) s = s + g[slot(p)];
        t4[j] = s;
      }
    }
    grid.sync();
    for (int e = gtid; e < a.nw + n4; e += gstride) {
      if (e < a.nw) {
        float s = 0.f;
        if (WGRAD && written_w(e, a.nc))
          for (int ch = 0; ch < nch; ++ch) s += tw[static_cast<size_t>(ch) * a.nw + e];
        a.grad_w[e] = s;
      } else {
        float4 s = zero4();
        for (int ch = 0; ch < nch; ++ch) s = s + t4[static_cast<size_t>(ch) * n4 + e - a.nw];
        goffs[e - a.nw] = s;
      }
    }
  } else {
    // one thread an entry, in patch order
    for (int e = gtid; e < a.nw; e += gstride) {
      float s = 0.f;
      for (int p = 0; p < a.B; ++p) s += a.wpart[static_cast<size_t>(p) * a.nw + e];
      a.grad_w[e] = s;
    }
    for (int e = gtid; e < n4; e += gstride) {
      const float4* g = a.gt + static_cast<size_t>(e / NPIX) * BP + e % NPIX;
      float4 s = zero4();
      for (int p = 0; p < a.B; ++p) s = s + g[slot(p)];
      goffs[e] = s;
    }
  }
  if (MODE == STEP) put_bnmom(a);
}

// float4 tiles of [B, NPIX] in a mode's float4 scratch: the chain state and
// its gradient where the caller does not give them, each op's input, the
// residuals of the couplings (three tiles each) and their gradient of t
// (SEG_FWD keeps one coupling's residuals, reused).
long long scratch_tiles(int mode, int nc, int n_ops) {
  if (mode == SEG_FWD) return 3;
  return (mode == STEP ? 2 : 1) + n_ops + 3LL * nc + nc;
}

// floats of the float scratch: the partial sums' two buffers, the group
// moments, the tree tail's first level
long long scratch_floats(int mode, int design, int B, int bt, int nc, int nm) {
  const long long nw = static_cast<long long>(nc) * REC + nm * 16;
  long long n = 2LL * B * NPART + static_cast<long long>(nc) * (B / bt) * 16;
  if (mode != SEG_FWD && (design & F_TAIL))
    n += static_cast<long long>((B + TCHUNK - 1) / TCHUNK) * (nw + nc * NPIX * 4LL);
  return n;
}

// The sizes, the op list and the scratch pointers of one launch; the caller
// sets the inputs and outputs. STEP's scratch holds cur and gcur; SEG_BWD's
// holds cur (gcur is gx); SEG_FWD's holds neither (cur is z).
StepArgs make_args(int mode, int design, int B, int bt, int ns, int nc, int nm, const int* ops,
                   int n_ops, float* scratch_f4, float* scratch_f, float* wpart) {
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
  if (mode != SEG_FWD && (design & F_TAIL))
    a.tpart = a.mom + static_cast<size_t>(nc) * (B / bt) * 16;
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

// One cooperative launch of train_kernel<MODE, BF, DESIGN, ABL> on `stream`:
// as many CTAs as can be resident at once (occupancy API), at most B. In a
// design without the tree tail, which sums every wpart entry, wpart is
// zeroed on the stream first.
template <int MODE, bool BF, int DESIGN, int ABL>
int launch_train(StepArgs a, void* stream, int* launched) {
  auto kernel = train_kernel<MODE, BF, DESIGN, ABL>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (MODE != SEG_FWD && !(DESIGN & F_TAIL))
    err = cudaMemsetAsync(a.wpart, 0, sizeof(float) * a.B * a.nw, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = a.B < per_sm * sms ? a.B : per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid), dim3(THREADS),
                                    args, 0, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return static_cast<int>(err);
}

// Each coupling and each mix index of the op list appears exactly once:
// the kernel writes each one's weight gradients once a patch, and the tree
// tail reads them without a zeroed buffer under them.
bool ops_once(const int* ops, int n_ops, int nc, int nm) {
  int seen_c = 0, seen_m = 0;
  for (int i = 0; i < n_ops; ++i) {
    const int kind = ops[i] >> 8;
    if (kind == OP_COUPLING) ++seen_c;
    if (kind == OP_MIX) ++seen_m;
    for (int j = 0; j < i; ++j)
      if (ops[j] == ops[i] && kind != OP_SCALE) return false;
  }
  return seen_c == nc && seen_m == nm;
}

// nf_train_scratch for a design (see fused_train.cu).
int train_scratch(int mode, int design, int B, int bt, int nc, int nm, int n_ops,
                  long long* sizes) {
  if (B <= 0 || bt <= 0 || B % bt || nc < 0 || nm < 0 || n_ops < 0 || mode < STEP ||
      mode > SEG_BWD)
    return static_cast<int>(cudaErrorInvalidValue);
  sizes[0] = static_cast<long long>(B) * NPIX * 4 * scratch_tiles(mode, nc, n_ops);
  sizes[1] = scratch_floats(mode, design, B, bt, nc, nm);
  sizes[2] = mode == SEG_FWD ? 0 : static_cast<long long>(B) * (nc * REC + nm * 16);
  return 0;
}

// The checked arguments of one train step (nf_train_step) in a design;
// returns 0 or cudaErrorInvalidValue.
int step_args(StepArgs& a, int design, const float* x, const float* clean, const float* sa,
              const float* sb, const float* rec, const float* offs, const float* mixes,
              float* scratch_f4, float* scratch_f, float* wpart, float* rows, float* gsa,
              float* gsb, float* grad_w, float* goffs, float* bnmom, int B, int bt, int ns,
              int nc, int nm, float invb, float gl, const int* ops, int n_ops) {
  if (bad_sizes(B, bt, nc, nm) || ns <= 0 || check_ops(ops, n_ops, nc, nm, ns, true) ||
      !ops_once(ops, n_ops, nc, nm))
    return static_cast<int>(cudaErrorInvalidValue);
  a = make_args(STEP, design, B, bt, ns, nc, nm, ops, n_ops, scratch_f4, scratch_f, wpart);
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
  return 0;
}

// The checked arguments of one segment backward (nf_segment_backward) in a
// design; returns 0 or cudaErrorInvalidValue.
int seg_bwd_args(StepArgs& a, int design, const float* x, const float* gz, const float* gldj,
                 const float* rec, const float* offs, const float* mixes, float* scratch_f4,
                 float* scratch_f, float* wpart, float* gx, float* grad_w, float* goffs, int B,
                 int bt, int nc, int nm, const int* ops, int n_ops) {
  if (bad_sizes(B, bt, nc, nm) || check_ops(ops, n_ops, nc, nm, 0, false) ||
      !ops_once(ops, n_ops, nc, nm))
    return static_cast<int>(cudaErrorInvalidValue);
  a = make_args(SEG_BWD, design, B, bt, 1, nc, nm, ops, n_ops, scratch_f4, scratch_f, wpart);
  a.x = reinterpret_cast<const float4*>(x);
  a.gz = reinterpret_cast<const float4*>(gz);
  a.gldj = gldj;
  a.rec = rec;
  a.offs = reinterpret_cast<const float4*>(offs);
  a.mixes = mixes;
  a.gcur = reinterpret_cast<float4*>(gx);
  a.grad_w = grad_w;
  a.goffs = goffs;
  return 0;
}

}  // namespace
