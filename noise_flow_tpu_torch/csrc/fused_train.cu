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
// and backward (the group means of gn and gn*n in one pass: 2 per
// coupling). The step kernel is one cooperative launch with grid.sync()
// between those stages: the grid is as many CTAs as can be resident at once
// (occupancy API), at most B, and each CTA walks its patches patch =
// blockIdx.x + k * gridDim.x. Every CTA writes per-patch partial sums; after
// the sync every CTA that needs a group's moments reduces that group's
// partials in the same fixed order, so no float atomics are used and results
// repeat bit for bit. Residuals for the backward (each op's input, n1, n2,
// t) do not fit in shared memory (about 64 KB a patch per coupling), so they
// live in global scratch that the wrapper allocates; so does the chain state
// between stages. Weight gradients are summed per patch in a fixed order
// (each warp owns taps, each lane 32 pixels, then a butterfly over the warp)
// into per-patch partials. b1/b2 gradients are exactly zero (BN removes the
// mean), as the TPU kernel returns them.
//
// The template (train_kernel.cuh) is built in design DESIGN_PROD, chosen by
// the attribution probes of train_probe.cu (PERF.md section 6), each bit
// against the parent's design, which the probe library keeps:
// - F_MERGE, float32: the forward BN moments in one pass, each patch's sum
//   and M2 about its own mean merged over the group in a fixed order (M2 =
//   sum M2_p + NPIX (mean_p - mean)^2): 2 barriers a coupling's forward, not
//   4, and no variance pass over the tiles (bfloat16 keeps JAX's two passes:
//   its per-lane rounding of sum (h - m)^2 needs the group mean first);
// - F_TAIL: the batch sums of the weight and offset gradients as a two-level
//   tree over the grid (runs of 16 patches, then the runs in order) after the
//   last barrier, in place of one thread a weight summing all B patches;
//   every wpart entry it reads is written, so nothing is zeroed;
// - F_WROUND, bfloat16: each coupling's record staged in shared memory with
//   its weights rounded once, for its forward and again for its backward, in
//   place of rounding every weight a thread loads (bit for bit too).
// The probes measured a backward that recomputes n1, n2 and t in place of
// stored residuals slower, group-scoped barriers no faster than grid.sync(),
// and bf16 mma.sync for the weight gradients slower than the warp butterfly;
// none is in the production design.
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
//
// The running-statistics forward (nf_segment_forward) is segment_kernel of
// segment_kernel.cuh, which describes its design: one CTA a patch, each
// coupling's record staged in shared memory once (bfloat16 weights rounded
// once), two barriers a coupling, two CTAs an SM. The parent's kernel
// (weights read, and rounded, at every tap) is kept in the probe library
// segment_probe.cu.

#include "segment_kernel.cuh"

namespace {

template <int MODE>
int launch_prod(StepArgs a, int bf16, void* stream, int* launched) {
  return bf16 ? launch_train<MODE, true, DESIGN_PROD, ABL_FULL>(a, stream, launched)
              : launch_train<MODE, false, DESIGN_PROD, ABL_FULL>(a, stream, launched);
}

}  // namespace

// Size of the device scratch of one launch in `mode` (0 the train step, 1
// the segment's ghost-BN forward, 2 its backward), in floats, for the wrapper
// to allocate: sizes[0] the float4 scratch (chain state, op inputs,
// residuals), sizes[1] the partial sums, group moments and the batch sums'
// first level, sizes[2] the per-patch weight
// gradients (0 in mode 1). None needs zeroing. Returns 0, or
// cudaErrorInvalidValue for bad sizes.
extern "C" int nf_train_scratch(int mode, int B, int bt, int nc, int nm, int n_ops,
                                long long* sizes) {
  return train_scratch(mode, DESIGN_PROD, B, bt, nc, nm, n_ops, sizes);
}

// One train step: forward and backward of the mean NLL over B patches with BN
// groups of bt (bt divides B), as one cooperative launch on `stream`.
// Inputs x, clean [B,32,32,4]; sa, sb [B, ns]; rec [nc, REC]; offs
// [nc,32,32,4]; mixes [nm,4,4]; ops (kind << 8 | index) in inverse order,
// each coupling and mix index once; the seeds invb = 1/B and gl = -1/B of the
// mean NLL. Outputs rows [B,3] (ldj, sum z, sum z^2), gsa/gsb [B, ns]
// (zeroed), grad_w [nc*REC + nm*16] (gradients of the records, then of the
// mixes), goffs [nc,32,32,4], bnmom [nc,16] (m1, v1, m2, v2 of each BN,
// averaged over the groups). scratch_f4, scratch_f, wpart as sized by
// nf_train_scratch (mode 0). Sets *launched to the kernel launches issued (1
// or 0) and returns the launch error (cudaError_t), 0 if none. bf16 != 0
// runs the bfloat16 mode (see the top of this file), 0 the float32 one.
extern "C" int nf_train_step(const float* x, const float* clean, const float* sa,
                             const float* sb, const float* rec, const float* offs,
                             const float* mixes, float* scratch_f4, float* scratch_f,
                             float* wpart, float* rows, float* gsa, float* gsb,
                             float* grad_w, float* goffs, float* bnmom, int B, int bt,
                             int ns, int nc, int nm, float invb, float gl, const int* ops,
                             int n_ops, int bf16, void* stream, int* launched) {
  *launched = 0;
  StepArgs a;
  const int err = step_args(a, DESIGN_PROD, x, clean, sa, sb, rec, offs, mixes, scratch_f4,
                            scratch_f, wpart, rows, gsa, gsb, grad_w, goffs, bnmom, B, bt, ns,
                            nc, nm, invb, gl, ops, n_ops);
  return err ? err : launch_prod<STEP>(a, bf16, stream, launched);
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
  StepArgs a = make_args(SEG_FWD, DESIGN_PROD, B, bt, 1, nc, nm, ops, n_ops, scratch_f4,
                         scratch_f, nullptr);
  a.x = reinterpret_cast<const float4*>(x);
  a.rec = rec;
  a.offs = reinterpret_cast<const float4*>(offs);
  a.mixes = mixes;
  a.cur = reinterpret_cast<float4*>(z);
  a.rows = rows;
  a.bnmom = bnmom;
  return launch_prod<SEG_FWD>(a, bf16, stream, launched);
}

// Backward of that forward from the cotangents gz [B,32,32,4] and gldj [B],
// as one cooperative launch on `stream` that first recomputes the forward:
// gx [B,32,32,4], grad_w [nc*REC + nm*16] (records, then mixes; the b1/b2
// entries and every field the chain does not read are exactly zero), goffs
// [nc,32,32,4]. Each coupling and mix index appears in ops once. scratch_f4,
// scratch_f, wpart as sized by nf_train_scratch (mode 2). *launched, bf16
// and the return value as above.
extern "C" int nf_segment_backward(const float* x, const float* gz, const float* gldj,
                                   const float* rec, const float* offs, const float* mixes,
                                   float* scratch_f4, float* scratch_f, float* wpart,
                                   float* gx, float* grad_w, float* goffs, int B, int bt,
                                   int nc, int nm, const int* ops, int n_ops, int bf16,
                                   void* stream, int* launched) {
  *launched = 0;
  StepArgs a;
  const int err = seg_bwd_args(a, DESIGN_PROD, x, gz, gldj, rec, offs, mixes, scratch_f4,
                               scratch_f, wpart, gx, grad_w, goffs, B, bt, nc, nm, ops, n_ops);
  return err ? err : launch_prod<SEG_BWD>(a, bf16, stream, launched);
}

// The CTAs an SM of the running-statistics forward (bf16 != 0: its bfloat16
// mode) in *per_sm, from the occupancy API: a batch of up to per_sm x SMs
// patches runs in one wave. Returns the CUDA error, 0 if none.
extern "C" int nf_segment_occupancy(int bf16, int* per_sm) {
  return bf16 ? segment_occupancy<true, E_PROD>(per_sm) : segment_occupancy<false, E_PROD>(per_sm);
}

// Running-statistics forward of one [mix, coupling]* segment: x -> z and the
// per-patch log-det ldj [B]. rec holds the records with BN folded in and
// bnrun is null, or rec holds them without BN and bnrun [nc, 4, 4] the
// running mean1, var1, mean2, var2 of each coupling (the bfloat16 mode rounds
// the unfolded weights, as the TPU kernel does). One launch of B CTAs on
// `stream`; nm <= MAX_OPS. *launched, bf16 and the return value as above.
extern "C" int nf_segment_forward(const float* x, float* z, float* ldj, const float* rec,
                                  const float* offs, const float* mixes, const float* bnrun,
                                  int B, int nc, int nm, const int* ops, int n_ops, int bf16,
                                  void* stream, int* launched) {
  *launched = 0;
  SegArgs a;
  const int err = segment_args(a, x, z, ldj, rec, offs, mixes, bnrun, B, nc, nm, ops, n_ops);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_segment<true, E_PROD>(a, s, launched)
              : launch_segment<false, E_PROD>(a, s, launched);
}
