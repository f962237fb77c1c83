#!/usr/bin/env python3
"""Drive noise_flow_tpu_torch's sampling, training, DnCNN and model-family paths on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (nvcc); it imports neither JAX nor noise_flow_tpu.
Phases, each of which fails the run if it fails:

1. print the card's name and power limit; build every kernel from
   ``noise_flow_tpu_torch/csrc`` and print the build seconds;
2. load the flagship model ``experiments/sidd/prod_exact_150`` through the
   port's ``NoiseFlowWrapper(device="cuda")``;
3. hold the fused sampler kernel against its plain PyTorch version on the
   card, on the same eps, in both BatchNorm modes, at every batch the
   main path gives it: the published batch (138), the frame below (2961,
   BatchNorm groups of 141) and the frame batch of larger frames (4096,
   groups of 256); then plant faults (BatchNorm groups halved, BatchNorm
   mode swapped, a coupling skipped), each run through the cooperative
   batch-BN launch, that the same comparison must report;
4. serve requests: ``sample_noise_nf`` at batch 138, temperature 0.6, for
   (iso, cam) pairs on the ISO grid, then ``sample_noise_frame`` on a
   synthetic packed frame of 1500x2000 (2961 patches); the kernel's launch
   count over this phase must be what its calls issue (one cooperative
   launch a call in batch-BN mode), the outputs finite and of the right
   shape, and one batch of samples, taken back through the plain
   ``inverse``/``nll_per_sample``, must give a latent whose sd is the
   temperature within 3%;
5. time the kernel and its plain version with CUDA events;
6. break a request's time down: the host clock around ``sample_noise_nf``
   and ``sample_noise_frame`` beside CUDA-event times of their parts;
7. hold the fused train-step kernel against its plain PyTorch version on
   the card at the published batch (138) with the flagship weights, in
   BatchNorm groups of 69 (the trainer's) and 138 (exact BN): the loss,
   sd_z, the new BN statistics, the kernel's raw gradients and every
   parameter gradient after autograd through the fold; the eval forward
   kernel against its plain version on both segments;
8. plant faults (BN groups of a third, one coupling's weight gradients left
   out, the ldj seed's sign flipped) that the same comparison must report;
9. train: ``Trainer(use_pallas=True)`` at the flagship config from its seed
   initialisation, on a synthetic set staged on the card (31 train and 5
   test batches of 138), ``fit`` for 2 epochs; the kernels' launch counts
   over the fit must be what its steps issue, the NLL finite and falling,
   the logs in the JAX columns with finite KLDs, the checkpoints loadable;
10. run 5 Adam steps through the kernels and 5 through the plain versions
   from the same weights on the same batches; the parameters must agree;
11. time the train kernels, their plain versions and one train step's parts;
12. the segment path's kernels against their plain versions on both flagship
   segments at b = 138, bt 69 and 138: the ghost-BN forward (z elementwise,
   ldj relative, the group moments elementwise) and the backward from
   seeded cotangents (gz, gldj) that are not the analytic seeds (gx and
   every raw gradient normwise, b1/b2 exactly zero);
13. the segment path (``FusedFlow.loss(train=True)`` through those kernels)
   against the one-shot path (``FusedTrainStep`` through the step kernel)
   on the same batch: loss, sd_z, new BN state, every parameter gradient;
14. plant faults in the backward (BN groups of bt/3, gldj zeroed, one
   coupling's weight gradients left out) that the comparison must report;
15. train through the segment path: ``Trainer(use_pallas=True,
   pallas_oneshot=False)``, the fit of phase 9 with exact launch counts of
   the segment kernels and none of the step kernel; then 5 steps of the
   5-scale arch ``sdn|gain|sdn1|gain1|sdn2|unc``, whose only fused path is
   the segment path;
16. 5 Adam steps through the segment kernels against 5 through their plain
   versions, as phase 10;
17. time the segment kernels, their plain versions and their bounds;
18. break a segment-path train step down, as phase 11;
19. the sampler's in-kernel RNG mode: the normals its kernel draws
   (``nf_rng_normals``, the same ``draw_normals`` as the chain's) against
   ``rng_normals_reference`` at b = 128 and 8192, within 1e-6 absolute;
   mean, sd and a KS test against N(0, 1) over the 33.5M values of 8192;
20. the RNG mode against the plain chain on ``rng_normals_reference(seed) *
   temp`` with the flagship weights: batch BN at b = 128 with one group (the
   DnCNN_NF step) and at 2961 (groups of 141), running BN at 8192
   (``make_sampler``'s steady state); one seed twice gives the same bits,
   two seeds differ;
21. plant faults (the seed ignored, the sin half dropped with the cos half
   reused, the temperature not applied) that phase 19 or 20 must report;
22. ``make_sampler`` at b = 8192, temperature 0.6, running BN, bt 64: one
   launch a call, no eps allocated, ms a call and patches/s;
23. train a DnCNN through ``cli.train_dncnn.main`` (``DnCNN_NF``, the
   flagship flow as its noise source, depth 9, 32 filters, batch 128, 2
   epochs of 9 steps on synthetic data): exactly one sampler launch a
   step, all in RNG mode, a finite and falling loss, ``log.csv`` and the
   checkpoints; then ``cli.test_dncnn.main --synthetic`` on the last
   checkpoint, a finite PSNR and SSIM;
24. 3 DnCNN_NF Adam steps with the noise through the kernel and 3 through
   the plain versions, from the same weights and seeds: each step's noise
   within TOL, a rerun bit for bit, the parameters and losses within
   tolerances set from the trajectory's own response to a noise moved by
   one float32 rounding (run beside them, and printed);
25. time the RNG and eps modes, their plain versions and bounds at b = 128
   and 8192, and break a DnCNN_NF train step down on the host clock;
26. the bfloat16 modes (the TPU kernels' ``mm_dtype=bf16``: ``make_sampler``'s
   default, the trainer's default ``pallas_train_dtype``): each bf16 kernel
   against its plain bf16 version on the card, normwise, beside the float32
   kernel's distance to the same plain output, which must exceed the
   tolerance: the sampler's eps mode at b = 138 (batch BN) and 2961 (groups
   of 141), its RNG mode at b = 128 and 8192 (running); the train step at
   b = 138, bt 69 and 138 (raw outputs, loss, parameter gradients); the
   running-BN eval forward and the ghost forward and backward on both
   segments;
27. plant one fault of each rounding class (the zero-conv's input unrounded,
   the mix weights unrounded, the train step's moment sums unrounded) in the
   plain version; the kernel against it must disagree;
28. train through ``cli.train.main --use_pallas`` at the default dtype, 2
   epochs on synthetic data, on the one-shot path and on the segment path:
   exact launch counts, every launch in bf16 mode, the NLL finite and
   falling;
29. ``make_sampler`` at its defaults (bf16) at b = 8192: one launch a call,
   in bf16 mode, ms a call;
30. time each bf16 kernel beside its float32 mode in turns, its plain
   version and its bf16 bound (useful FMAs over 989 TFLOP/s, bytes over 3.35
   TB/s);
31. the sampler with the whole batch as one BN group (``bt = b``, what
   ``NoiseFlowWrapper`` passes) against its plain version at b = 2961 (the
   frame) and 4096, within TOL, its kernel timed beside ``bn_block`` groups
   (medians of runs in turns); the wrapper's own call at b = 300 equals
   ``fused_sample(bt=300)`` bit for bit and not its ``bn_block`` groups of
   150;
32. the train template's probe attribution (``probes/train_template.py``;
   ``csrc/train_probe.cu`` and the ``csrc/train_variants_*.cu`` libraries):
   every ablation of the ghost segment forward and of the segment backward
   in the parent's design and in the redesign, both precisions, bt 69 and
   138; the chained ghost-BN reductions, the weight-gradient layouts, the
   one-shot step in both designs, the launch and floor probes; each timed.
   Every variant that has a plain version is held to it on the same inputs
   (the full segment and step variants at the production kernels'
   tolerances, the BN chains and weight gradients at BN_CHAIN_ATOL and
   WGRAD_RTOL), and a planted fault of each of the last two must disagree;
   the full variants in the production design are bit-equal to the
   production kernels;
33. the redesigned step and segment backward against the parent's template
   (kept in the probe library) in turns, float32 and bf16, bt 69 and 138,
   beside their bounds and plain versions; the ghost forward too, which
   shares the template's design;
34. print the ``{"kernels": [...]}`` line, one entry a TPU kernel function
   (the segment forward with its running and ghost modes, the sampler with
   its eps and RNG modes; every entry with its bf16 modes under
   ``by_mode``; the step and the backward with ``redesign``, the parent's
   time beside each), then one entry a train-template probe site of
   ``experiments/`` (``replaces`` its ``pl.pallas_call`` line; ``launches``
   counts its wrappers' ``counters`` over the main paths' runs, each read
   just after its path ran from counts set to 0; no main path runs a probe.
   ``plain_ms`` and ``max_abs_err`` are null for the launch and floor
   probes, which compute nothing to compare, and ``one_op_ms`` is one small
   PyTorch call beside them), and last the three sampler-group sites of
   phase 35 (the sampler's entry also carries ``design``, its production
   design by precision and BN mode, and ``redesign``, phase 37's rows; the
   eval forward's running modes carry phase 38's rows as ``redesign``);
   before it, a ``{"rank": [...]}`` line: each kernel and mode
   with main-path launches, calls x (device ms a call - bound a call)
   summed over the shapes its calls ran at (the wrapper's requests and its
   frame apart), the redesign ranking;
35. the sampler group's probe attribution (``probes/sampler.py``;
   ``csrc/sample_variants_{f32,bf16}.cu`` and ``csrc/sample_probe.cu``): the
   sampler's template with every ablation of ``kernel_probe.py`` (notrans,
   noshift, nocoupnn, interleave, 2 and 8 pixels a thread) and every fold of
   ``kernel_sweep.py`` (concat-K, interleave, precast and their
   combinations), at (R) running BN with in-kernel RNG, b = 8192, and (W)
   batch BN on eps, b = bt = 138, both precisions; the chains of 56
   dependent products of ``mxu_bound_probe.py`` at the literal shape in
   the Hopper redesign (bf16 ``wgmma`` with the tile in registers and the
   weights fed by bulk copies; float32 FMAs over a persistent grid, the
   parent's bits) and the parent's design, beside 56 torch.matmul, and at the
   sampler's 4 channels beside 56 torch.matmul, torch.matmul at 4096^2 (k)
   and the production sampler in float32 against bfloat16 (R); the
   calibration line gives the chain's k from the redesign and from the
   parent, and the matmul share from the redesign's k; the SASS of the
   bf16 redesign must hold HGMMA (wgmma) and UBLKCP (bulk copies). Each is
   timed as device time in turns;
   each variant is held to its plain version (float32 within TOL, bfloat16
   normwise within BF16_SAMPLE_RTOL, notrans at NOTRANS_RTOL, the chains at
   CHAIN_RTOL, over their first CHAIN_PREFIX products at CHAIN_PREFIX_RTOL,
   and PX_CHAIN_RTOL), the variants of FULL's arithmetic
   (interleave, precast, pixels a thread in running BN) bit for bit to it;
   FULL (the probe library keeps the parent's design, batch BN stage by
   stage) is bit-equal to the production kernel in running BN and within
   the sampler's tolerance of it in batch BN, in both precisions and input
   modes, a (W) call is 40 launches (nocoupnn one); then the
   production sampler's rows (a request, the frame, the DnCNN_NF step,
   make_sampler) and the eval forward re-timed as device times;
36. plant faults those comparisons must catch: a wrong polynomial in
   notrans (tanh u -> u), an interleaved stream reading the other patch's
   clean, a precast record rounded toward zero, one chain product skipped
   and one weight replaced by the one before it (a stale ring slot), both
   through each chain design, a bfloat16 chain whose intermediates are not
   rounded again (and each bfloat16 chain kernel held to it);
37. the sampler's redesign (batch BN in one cooperative launch with merged
   moments, each patch kept on chip where the card holds every CTA; bf16
   weights rounded once) against the parent's design (the probe library's
   stage-by-stage launch_chain, 40 launches a batch-BN call) in turns, as
   device times: a request (b = 138, eps) and the DnCNN_NF step's call (b
   = 128, RNG) in both precisions; the frame (b = bt = 2961, float32; it
   walks); make_sampler's bf16 call (b = 8192, running BN). It prints each
   ratio, the launch plan (CTAs, CTAs an SM, resident or walk) and the
   rule that picks it, ptxas's registers of the cooperative kernels, and
   each output's distance to the parent; the redesign must agree with the
   plain version, be one launch a call, be faster at b = 138 and 128, no
   more than 3% slower at the frame and at most 0.75 of the parent at
   make_sampler; the running-BN kernel must give the parent's bits;
38. the running-BN eval forward's redesign (each coupling's record staged
   in shared memory once, bf16 weights rounded once, two barriers a
   coupling, two CTAs an SM) against the parent's design (the probe
   library's ``segment_kernel_parent``, ``csrc/segment_probe.cu``) in turns,
   as device times of one eval call (both flagship segments) at b = 1, 138
   and 4096 in both precisions. It prints each ratio, the CTAs an SM of
   both designs (occupancy API) and the waves at each batch, ptxas's
   registers and spills of both designs' kernels, and whether z and ldj are
   the parent's bits; the redesign must agree with the plain version, be
   one launch a segment, give the parent's bits, be faster than the parent
   at b = 138 in bf16 and no more than 3% slower at any timed batch. Then
   planted faults that the comparison with the plain version must catch:
   the barrier before conv3 left out (a race, at b = 138 and 4096), the
   running variances staged in place of 1/sqrt(var + eps), and a bf16
   record rounded toward zero;
39. the flagship data path at a cut of scale: ``cli.make_sidd_scale``
   writes the SIDD-scale generator's first 2 train and 1 test scenes (their
   ids, round-robin cells and seeds; v7.3 .MAT where h5py is installed,
   else v5) at a 1024x2048 Bayer frame in place of 3000x5328, then
   ``cli.train.main`` runs the ``prod-exact`` flags (exact batch BN on the
   plain path, b 138, the npy cache, the native loader, staged data, the
   sample phase) for 2 epochs: both rows written and finite, the fit on the
   card with no kernel launched, the cache read back without decoding a
   .MAT; then the exact-BN train step at b = 138 timed (host clock);
40. ``cli.kld_sweep.main`` on the flagship over that test scene at two
   temperatures: the fused sampler launched once a (group, temperature,
   batch) and nowhere else; one sweep call's kernel output against the
   plain ``sample_chain_reference`` on a shared eps, within TOL; KLD_G and
   KLD_NLF as printed against a numpy recomputation from the reference's
   definition;
41. ``analysis.ref_parity.run_grid`` on the flagship at b = 1024 (the
   cooperative kernel walks): 5 cells (every third of the table's 15,
   ``GRID_EVERY``, cut for time) x 3 levels, one launch a call; one
   cell's kernel samples against the plain version on a shared eps within
   TOL, the summary printed; then ``sample_noise_frame_spatial`` on the
   1500x2000 frame timed (the plain flow at frame size, no kernel). The
   kernels line's sampler entry counts these launches too (``flagship``);
42. the model family, no kernel on any of its paths (the fused envelopes
   exclude every flow below but the oracle of phase 43, as JAX's do, and
   that runs without ``--use_pallas`` and samples nothing): each of the 24
   layer kinds of ``tests/test_bijectors.py::ALL_KINDS`` and the coupling
   with the dense template, weights moved off init as
   ``tests/test_torch_layers.py`` moves them, at b = 138, 32x32x4, width 4: ``inverse`` (with its train-mode
   BatchNorm state) and ``forward`` in train and eval mode on the card and
   on the CPU, held to each other at the layer tolerances, the largest
   distances printed;
43. the camera-NLF oracle ``experiments/sidd/condsdn_scale`` (the flow that
   generated the SIDD-scale corpus): the ``condsdn-baseline`` recipe through
   ``cli.train`` on the card for 2 epochs over phase 39's cut corpus,
   starting from the oracle's checkpoint (``--init_checkpoint``); its
   train rows equal within ORACLE_ROW_ATOL (it never trains), and one train
   batch's NLL from the checkpoint on the card and on the CPU within
   ORACLE_CPU_TOL;
44. ``cli.train`` on the card for 2 epochs over that corpus: a 2-level
   ``unc|unc|unc|unc`` flow (``--n_levels 2 --squeeze_factor 2
   --do_sample``, so the sample phase goes through the multi-level
   ``sample``) and a legacy ``--arch "" --sidd_cond condXY --depth 4``
   flow: the train NLL falls, every row finite, ``hps.txt`` says ``cuda``;
45. on every path of phases 42-44 the launch counters read zero
   (``no_launch``), and the earlier phases' counts are as they were;
46. data-parallel training, 2 ranks sharing the card over gloo (processes
   started here): ``cli.train`` in coordinator mode, 2 processes on cuda:0,
   the published arch at global batch 276 (138 a process, each on its
   ``host_shard`` of phase 39's image tuples), the plain exact-BN path,
   3 steps from the flagship's checkpoint (``--init_checkpoint``), with the
   sample phase; held against one rank at 276 in this process on the two
   processes' batches concatenated: each step's train NLL and each test NLL
   within PAR_NLL_RTOL, the weights of ``ckpt-3`` (after 2 steps) within
   ``probes.mesh.PARAM_TOL`` where the reference's gradients set Adam's
   sign (PAR_WEIGHT_FLOOR); no kernel launched; hps.txt's num_processes 2;
   every rank and reference with cuDNN's deterministic algorithms;
47. the same with ``--use_pallas --pallas_train_dtype float32`` (the
   one-shot step at bt 69 on each rank, as one rank's at 276): the same
   comparisons, and each rank's launches exactly one step launch a step and
   two eval launches a test batch; then an in-process spawn of
   ``Trainer(mesh)`` on those global batches: the plain path within the
   same tolerances of one rank and its first step's gradients within
   ``probes.mesh.GRAD_TOL``, the planted fault of the tests (each rank's
   own BN moments) outside both, and the per-rank step ms of the plain and
   one-shot paths and the all-reduce ms a step beside one rank's step at
   276 (host clock; "2 ranks sharing one card, gloo", with the card's name
   and power limit: not a multi-card speed);
48. ``cli.train_dncnn`` DnCNN_NF in a group of 2 ranks on the card (batch
   128, 64 a rank, 2 epochs): the same weights on both ranks bit for bit,
   the same finite, falling losses, on each rank exactly one sampler launch
   a step, all in RNG mode over the whole batch (b = 128, as one rank's, so
   that the noise does not depend on the ranks); against one rank's run of
   the same command: the first step's noise the same bits, its loss within
   PAR_NLL_RTOL and its gradients within PAR_DNCNN_GRAD_RTOL normwise. The
   kernels line gives these per-rank launches under each
   kernel's ``parallel``.
49. the frame sharded by height over 2 ranks on cuda:0 (gloo, processes
   started here): the flagship at frame size on the SIDD_Medium packed
   frame (2664x1500, padded to 2672x1504), each rank's rows of
   ``parallel.spatial.sample_frame_sharded`` against one rank's
   ``flow.forward`` on the same frame and latent in both BN modes, within
   SPATIAL_RTOL of the value and the frame's spread; the two planted faults
   of ``tests/test_torch_spatial_mesh.py`` (the edge indicator on every
   shard's padded rows, BN moments over each rank's own rows) outside it;
   each rank's frame ms, halo-exchange ms and all-reduce ms (host clock,
   "2 ranks sharing one card, gloo", beside one rank's frame ms); the entry
   point ``NoiseFlowWrapper.sample_noise_frame_spatial(mesh=)`` on both
   ranks, the same bits of the whole 2664x1500 frame on each, held within
   SPATIAL_RTOL to one rank's ``flow.forward`` on the frame reflect-padded
   to 2672x1504 as the wrapper pads it, from latents drawn as the wrapper
   draws them (a generator on the card seeded alike), cropped; no kernel;
50. ``ops.packed_flow.PackedFlow`` on the flagship at b = 138: loss,
   sd_z, new BN state and every gradient by autograd against
   ``NoiseFlow.loss`` and its autograd, at ``tests/test_packed.py``'s
   tolerances, with ``precision="highest"`` (gated) and ``"default"``
   (TF32, reported), and each one's loss+backward ms beside the NHWC
   path's; no kernel;
51. the flagship exported to the reference TF checkpoint's 143 variable
   names in a dict (``utils.tf_import.export_reference_variables``) and
   loaded back through
   ``utils.tf_import.import_reference_variables``: the same state dict,
   bit for bit, and the same NLL; reading a TF checkpoint raises
   ImportError where TensorFlow is not installed;
52. K train steps a dispatch (``steps_per_call``): ``Trainer`` at b = 138,
   K = 32 over 70 staged steps (2 CUDA graph replays, ``training.step_graph``,
   and a 6-step eager tail) against 70 eager steps from the same state, on
   the plain exact-BN path, the one-shot step in float32 and bf16 (the
   flagship's weights) and the segment path (the 5-scale arch from its
   seed): every step's NLL and sd_z, the weights, the BN state and Adam's
   moments and step the same bits, with cuDNN held to deterministic
   algorithms; the kernels' launches exactly one step's a step, the graph
   run's counting each replay's and the warm-up steps' before the capture;
   then each path's ms a step, eager against graph in turns (host clock;
   the plain path's graph also with cuDNN's default algorithms, as it
   trains), and the device kernels of one step (torch.profiler over a
   replay and over an eager step);
53. the staged eval through the running-BN eval forward, K = 32 eval steps a
   replay over 70 test batches, held and timed the same way, and the staged
   eval epoch's ms eager against graph;
54. ``train_epoch`` over 70 host batches at K = 32 (the [K, B, ...] feed)
   against K = 1, one-shot float32, the same bits;
55. planted faults that the comparison of phase 52 must catch: a replay
   whose index buffer is not refreshed, and the BN state rebound instead of
   copied. The kernels line adds the launches of phases 52-53 to the
   kernels and modes that ran there (``under_graph``: path, launches, ms a
   step eager and graph); the rank line leaves them out.

56. the DnCNN four-source comparison through ``cli.dncnn_comparison``
   (the main path of ``experiments/dncnn/run_comparison.py``) at a cut of
   scale: all 78 scenes at 512x2496 Bayer, 64x64 validation blocks, the
   four sources at the JAX script's width for 30 epochs of 35 steps at b =
   128: the noisy input's PSNR equal to a numpy recomputation from the .mat
   files, the NF source's ``fused_sample_rng`` launches equal to its steps
   (and no other sampler launch), each source's PSNR above the noisy
   input's. The kernels line adds its launches to the sampler's RNG mode.

57. (run after phase 41) ``cli.train``'s prod-exact fit on phase 39's corpus
   plus three train scenes, 3 epochs straight against the same fit stopped
   by SIGINT after epoch 1 and resumed by ``--continue_training`` in a fresh
   Trainer: every parameter, BN buffer and Adam slot the same bits; a
   planted resume without Adam's slots must differ.

58. (run after phase 55) K train steps a dispatch under a mesh: each rank's
   K steps with their nccl all-reduces captured as one CUDA graph
   (``training.step_graph``, ``parallel.distributed._all_reduce_``). (a) On
   any card: a one-rank nccl group (a process started here), the trainer's
   mesh step written out so that it issues its collectives on one rank: the
   plain exact-BN step (65 all-reduces a step: the BatchNorm sums forward
   and backward, the flat all-reduce) and the one-shot f32 step (1), at b =
   138 from the flagship's weights, 2 replays of a K = 4 graph against the
   same 8 steps eager: every step's NLL and sd_z, the weights, BN state and
   Adam's slots the same bits (or, where the collectives sum in another
   order, the first difference named and held to phase 46's tolerances);
   each replay counting its K x 65 or K all-reduces and its K step
   launches; the planted fault (the graph's static input buffer, which the
   captured BN all-reduces read, rebound after capture) must differ. (b)
   With two cards or more: ``cli.train --mesh N --steps_per_call 32``, N the
   visible cards up to 4, nccl, on phase 39's corpus (random patches, 2
   epochs of 70 steps at 276: 2 replays and a 6-step tail an epoch), the
   plain and the one-shot f32 path, against the same N ranks at K = 1: the
   same comparisons by rank, the ranks' graph runs the same bits, one graph
   a rank, a replay's 32 step launches and its all-reduces; each rank's ms a
   step, eager and graph (host clock over epoch 2, input included). (c) A
   line says whether (b) ran, and why not ("1 card visible; nccl takes one
   rank a card"). The kernels line gives the one-shot step's launches of
   (a) and, by rank, of (b) under its entry's ``parallel.mesh_graphs``.

59. (run after phase 58) the kernel-path training recipe: ``cli.train``
   with ``cli.flagship --recipe ghost``'s flags (jobs/job_noise_flow.sh
   prod-synth-scale: the one-shot step with ghost BN over blocks of 69 and
   the running-BN eval forward, both in bf16, K = 32, staged data, the
   sample phase) on phase 39's corpus (random patches: 70 train steps an
   epoch at b = 138, 35 test batches), 2 epochs at K = 32 against K = 1 with
   cuDNN held to deterministic algorithms: every staged train and eval
   step's NLL and sd_z, the weights, BN state and Adam's slots the same
   bits, and the rows of train.txt, test.txt and sample.txt (NLL, sd_z);
   the eval graph, captured at epoch 1, replayed after epoch 2's train
   groups against eager eval on those BN buffers, the same bits; a planted
   fault (the eval graph fed running moments kept from its capture) must
   differ; launches exactly the steps' and warm-ups', a replay's 32 step
   and 64 eval-forward launches, all in bf16; then ms a step eager and
   graph of the bf16 train and eval steps. The kernels line adds the graph
   run's launches to the bf16 modes (``under_graph``).

The train template's redesigned step, segment backward and ghost forward
keep one launch a call, so the exact launch counts of phases 9, 15 and 28
are those of its parent's design; the sampler's batch-BN calls went from
40 launches to one; the redesigned eval forward keeps one launch a
segment.

The last line of stdout is ``{"ok": true, "device": {...}}``; it is printed
only if every phase passed. Exit code 0 then, non-zero otherwise.
"""

from __future__ import annotations

import collections
import copy
import csv
import functools
import hashlib
import importlib.util
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
TEMP = 0.6
GRID = ((100.0, 0.0), (400.0, 1.0), (800.0, 2.0), (1600.0, 3.0), (3200.0, 4.0))
FRAME_HW = (1500, 2000)          # packed SIDD frame: 2961 patches of 32x32
FRAME_B = -(-FRAME_HW[0] // 32) * -(-FRAME_HW[1] // 32)   # one wrapper call (b <= 4096)
BATCHES = (138, 2961, 4096)      # requests, this frame, larger frames
# kernel vs plain: |kernel - plain| <= atol + rtol * |plain|, elementwise, in
# both BN modes: float32 sums (and batch-BN moments) in another order than the
# plain version's. The noise has an sd of 0.01-0.04 and the kernel differs
# from its plain version by at most 1.5e-7 on the H100, so atol 1e-6 leaves
# room for rounding and no more; the planted faults must exceed it.
TOL = (1e-6, 1e-5)
# kernel launches of one fused_sample call in batch-BN mode: one cooperative
# launch; in the parent's design (the probe library's launch_chain) four
# statistics stages and one apply stage for each of the flagship's eight
# couplings
BATCH_BN_LAUNCHES = 1
PARENT_BATCH_BN_LAUNCHES = 40
# phase 36's stale-slot fault: the literal chain's weights with w[m] replaced
# by w[m - 1] at this m (past the redesign's first pass through its ring of
# 4 slots)
STALE_PRODUCT = 5
# The train step, kernel vs plain, at b = 138 (flagship weights). Float32 sums
# in another order; the gradients of the early couplings also go through
# ReLU kinks where a float32 rounding flips a mask (one or two flips a step,
# counted against float64), so gradients are held normwise:
# ||kernel - plain|| <= tol * ||plain||. Observed with this script on an
# H100 80GB HBM3 at 700 W: the per-patch rows (ldj, sum z, sum z^2) 8.4e-8 normwise, the
# loss and sd_z equal to the last bit, the group BN moments 4.5e-8 abs (the
# new running statistics, a tenth of that), the kernel's raw gradients at most
# 1.7e-4 normwise, the parameter gradients after autograd through the fold
# at most 9.6e-4 normwise. Each tolerance is about 10x the observed error.
ROWS_RTOL = 5e-7         # per-patch rows, normwise
LOSS_RTOL = 1e-6         # mean NLL and sd_z, relative: about 10 float32 ulps
BN_ATOL = 4e-7           # group BN moments, absolute; new running stats: a tenth
RAW_GRAD_RTOL = 2e-3     # the kernel's raw gradients, normwise
LEAF_GRAD_RTOL = 1e-2    # parameter gradients, normwise per leaf
# the eval forward on N(0, 1) input: z elementwise |k - p| <= atol + rtol |p|
# (observed 6.7e-6 abs), its ldj relative (observed 2e-7)
SEG_TOL = (5e-5, 1e-5)
LDJ_RTOL = 2e-6
# 5 Adam steps from the same weights, kernel vs plain: parameters, absolute
# (observed 2.2e-6 after moves of up to 5e-4)
TRAJ_ATOL = 1e-5
# The segment path's kernels on N(0, 1) input (observed with this script on
# an H100 80GB HBM3 at 700 W). The ghost-BN forward: z and ldj as the eval
# forward above (observed 9.5e-6 abs, 3.8e-7 rel); the group moments
# |k - p| <= atol + rtol |p| (observed 1.2e-7 abs, 1.1e-6 rel: sums of up to
# 141k values in another order). The backward from seeded cotangents:
# gx and every raw gradient normwise. Observed at most 6.5e-7 here, where no
# ReLU mask flips; a flip (float32 rounding on either side of a kink, as the
# train-step comparison above allows for) moved one card test's gradients
# by up to 9.2e-5 at b = 300. BN groups of bt/3 move them by 1.5e-3 to
# 3.6e-3, and must be reported on every output.
GHOST_BN_TOL = (4e-7, 5e-6)
SEG_GRAD_RTOL = 5e-4
# The segment path against the one-shot path on the same batch: the mean NLL
# and sd_z, relative (sd_z from the two-pass variance there, from sum z and
# sum z^2 here)
PATH_LOSS_RTOL = 1e-6
FIVE_SCALE_ARCH = "sdn|gain|sdn1|gain1|sdn2|unc"   # beyond the one-shot step's 4 scale layers
TRAIN_B, TRAIN_BTS = 138, (69, 138)
FRAME_ROUNDS = 5      # phase 31: the frame's kernel at bt = b and bn_block(b), in turns
TRAIN_EPOCHS, TRAIN_IMAGES, TEST_IMAGES = 2, 17, 3    # 512x512: 256 patches each
# The in-kernel RNG mode. The kernel's normals against the plain version's
# (both on the card): logf, sqrtf and sincosf at full precision on both
# sides, values up to 5.9, so within 1e-6 absolute; the chain from them
# within TOL. Shapes: the DnCNN_NF step (b = 128, one BN group), the frame
# batch (2961, groups of 141), make_sampler's steady state (8192, running).
RNG_SEED = 1234
RNG_ATOL = 1e-6
RNG_STATS_B = 8192                # 33.5M normals for the statistics
RNG_SHAPES = (("batch", 128, 128), ("batch", 2961, 141), ("running", 8192, 8192))
SAMPLER_B, SAMPLER_BT = 8192, 64
# DnCNN_NF at the reference's full width (train_dncnn_noiseflow.py:77-105):
# 80 synthetic 256x256 images, 16 patches each, less the CLI's held-out
# tenth: 9 steps an epoch
DNCNN_DEPTH, DNCNN_FILTERS, DNCNN_B, DNCNN_EPOCHS, DNCNN_IMAGES = 9, 32, 128, 2, 80
# 3 Adam steps kernel vs plain from the same weights and seeds. Each step's
# noise is held within TOL. The trajectory then carries those last-bit
# differences: Adam's first steps are lr * g / |g|, and a DnCNN trained
# with a sum loss turns a noise changed by one float32 rounding (x (1 +
# 2^-23)) into parameters 8.2e-3 apart normwise after 3 steps and losses
# 8.8e-5 apart (the plain path alone, run beside them here; observed with
# this script on an H100 80GB HBM3 at 700 W, where kernel against plain read
# 4.2e-3 and 3.4e-5), so the parameters and BN state are held normwise per
# leaf within 2e-2 and the losses within 3e-4 relative.
DNCNN_TRAJ_RTOL, DNCNN_LOSS_RTOL = 2e-2, 3e-4
# The bfloat16 modes, bf16 kernel vs plain bf16 version (both on the card).
# A value within a float32 ulp of a bfloat16 rounding boundary rounds either
# way under another summation order, and an operand flipped in an early
# coupling carries on through the chain (a few noise values move by up to 5%
# of its sd), so every output is held normwise, ||kernel - plain|| <= tol *
# ||plain||; the float32 kernel on the same inputs must exceed the tolerance
# (the group moments: absolute). Observed in the first two runs on an H100
# 80GB HBM3 at 700 W, bf16 kernel / float32 kernel, each against the plain
# bf16: noise 3.3e-5 to 9.8e-5 / 9.7e-3; the step's rows up to 1.1e-5 /
# 1.2e-3, group moments up to 1.4e-5 / 2.7e-4 abs, raw gradients (of the
# records, offset maps, mixes, scale coefficients) up to 8.8e-4, 6.0e-3,
# 4.9e-5, 6.7e-5 / at least 1.0e-2, 3.8e-2, 1.7e-2, 3.7e-3; the eval
# forward's z 3.7e-5 / 5.1e-3; the ghost forward's z 2.1e-5 / 4.8e-3, its
# moments equal / 1.9e-3 abs; the backward up to 7.7e-4 / 2.3e-3.
BF16_SAMPLE_RTOL = 3e-4
BF16_BN_ATOL = 5e-5
BF16_STEP_RTOL = {"rows": 5e-5, "grad_rec": 4e-3, "grad_offs": 1.5e-2, "grad_mixes": 1e-3,
                  "gsa": 1e-3, "gsb": 1e-3}
# parameter gradients after the fold, normwise over all leaves (observed 1.0e-4
# at bt = 69, 3.9e-6 at bt = 138; the float32 kernel 4.6e-3 and 4.7e-3)
BF16_LEAF_RTOL = 1e-3
BF16_Z_RTOL, BF16_LDJ_RTOL, BF16_BWD_RTOL = 3e-4, 1e-5, 1.5e-3
# the CLI fits: 90 synthetic 128x128 images a split, 16 patches each: 10
# train and 10 test batches of 138 an epoch
BF16_FIT_IMAGES = 90
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, dense
# bfloat16 in the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
# The probe library's variants that have a plain version (phase 32), each
# against it on the same inputs: the template's full variants at the
# tolerances of the production kernels above; 8 chained ghost-BN
# normalisations of N(0, 1) patches, max abs (observed with this script on
# an H100 80GB HBM3 at 700 W: 1.4e-6 in float32, 6.7e-6 in bfloat16, where
# the rounding of a lane's group sum flips with the summation order); the
# weight-gradient contractions of bfloat16-rounded operands in float32,
# normwise (observed 1.3e-7 to 2.6e-7). A planted fault of each must exceed
# them.
BN_CHAIN_ATOL = {"float32": 1e-5, "bfloat16": 5e-5}
WGRAD_RTOL = 1e-5
# The sampler probe library's variants (phase 35), each against its plain
# version on the same inputs (observed with this script's first call on an
# H100 80GB HBM3 at 700 W, b = 512 running and 138 batch): the sampler's
# function and the ablations but notrans in float32 elementwise within TOL
# (up to 1.8e-7 abs), in bfloat16 normwise within BF16_SAMPLE_RTOL (up to
# 6.5e-5); notrans and the product chains at the tolerances of
# probes/sampler.py (NOTRANS_RTOL, CHAIN_RTOL, PX_CHAIN_RTOL), which say
# what was observed.
# launch counts of the main paths, each read just after the path ran with
# the counts set to 0 just before it (the kernels line's probe entries)
MAIN_PATH = collections.Counter()


def _main_path(counts: dict) -> dict:
    """Add a main path's launch counts to MAIN_PATH; return them."""
    MAIN_PATH.update(counts)
    return counts


def _norm_rel(k, p) -> float:
    return float((k - p).norm() / p.norm().clamp_min(1e-30))


def _probe_check(kind: str, dt: str, got, ref) -> bool:
    """A probe variant against its plain version on the same inputs (the
    check of train_template.attribution), at the tolerances above."""
    import torch
    bf = dt == "bfloat16"

    def finite(t):
        return bool(torch.isfinite(t).all())
    if kind == "bn_chain":
        return finite(got) and float((got - ref).abs().max()) <= BN_CHAIN_ATOL[dt]
    if kind == "wgrad":
        return finite(got) and _norm_rel(got, ref) <= WGRAD_RTOL
    if kind == "train_step":
        ok = True
        for key in ref:
            if key == "bnmom":
                good = float((got[key] - ref[key]).abs().max()) <= (BF16_BN_ATOL if bf else BN_ATOL)
            else:
                tol = BF16_STEP_RTOL[key] if bf else ROWS_RTOL if key == "rows" else RAW_GRAD_RTOL
                good = _norm_rel(got[key], ref[key]) <= tol
            ok = ok and good and finite(got[key])
        return ok
    if kind == "segment_backward":
        tol = BF16_BWD_RTOL if bf else SEG_GRAD_RTOL
        return all(_norm_rel(a, r) <= tol and finite(a)
                   for o, rr in zip(got, ref) for a, r in zip(o, rr))
    if kind == "segment_train_forward":
        ok = True
        for (zk, lk, mk), (zp, lp, mp) in zip(got, ref):
            if bf:
                good = (_norm_rel(zk, zp) <= BF16_Z_RTOL and _norm_rel(lk, lp) <= BF16_LDJ_RTOL
                        and float((mk - mp).abs().max()) <= BF16_BN_ATOL)
            else:
                good = (bool(((zk - zp).abs() <= SEG_TOL[0] + SEG_TOL[1] * zp.abs()).all())
                        and float(((lk - lp).abs() / lp.abs().clamp_min(1.0)).max()) <= LDJ_RTOL
                        and bool(((mk - mp).abs()
                                  <= GHOST_BN_TOL[0] + GHOST_BN_TOL[1] * mp.abs()).all()))
            ok = ok and good and finite(zk) and finite(lk)
        return ok
    raise ValueError(f"no check for {kind}")


def _sampler_check(kind: str, dt: str, got, ref) -> bool:
    """A sampler probe variant against its plain version on the same inputs
    (the check of sampler.attribution), at the tolerances above."""
    import torch
    from noise_flow_tpu_torch.probes import sampler as sp
    if not bool(torch.isfinite(got).all()):
        return False
    if kind == "sample_notrans":
        return _norm_rel(got, ref) <= sp.NOTRANS_RTOL[dt]
    if kind == "sample":
        if dt == "bfloat16":
            return _norm_rel(got, ref) <= BF16_SAMPLE_RTOL
        return bool(((got - ref).abs() <= TOL[0] + TOL[1] * ref.abs()).all())
    tol = {"mm_chain": sp.CHAIN_RTOL, "mm_chain_prefix": sp.CHAIN_PREFIX_RTOL,
           "px_chain": sp.PX_CHAIN_RTOL}.get(kind)
    if tol is not None:
        return _norm_rel(got, ref) <= tol[dt]
    raise ValueError(f"no check for {kind}")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _cond(b, seed):
    """Clean patches and per-example (iso, cam) on the grid, on the card;
    and the generator that drew them."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    clean = 0.01 + 0.89 * torch.rand((b, 32, 32, 4), generator=g, device="cuda")
    iso = torch.tensor([GRID[i % 5][0] for i in range(b)], device="cuda")
    cam = torch.tensor([GRID[(i // 5) % 5][1] for i in range(b)], device="cuda")
    return {"clean": clean.contiguous(), "iso": iso, "cam": cam,
            "nlf0": torch.zeros(b, device="cuda"),
            "nlf1": torch.zeros(b, device="cuda")}, g


def _inputs(program, b, seed):
    """Clean patches, per-example (iso, cam) on the grid, eps * TEMP."""
    import torch
    cond, g = _cond(b, seed)
    sa, sb = program.scale_ab(cond, b)
    x = (torch.randn((b, 32, 32, 4), generator=g, device="cuda") * TEMP).contiguous()
    return x, cond["clean"], sa, sb


def _work(program, b, rng=False):
    """(FLOPs, bytes) the chain needs for b patches (``sampler.chain_work``:
    the convolutions' and mixes' multiply-adds, each input read and the noise
    written once; the RNG mode's Philox and Box-Muller left out)."""
    from noise_flow_tpu_torch.probes.sampler import chain_work
    return chain_work(program, b, rng)


def _train_batch(b, seed):
    """A synthetic training batch on the card: clean patches, NLF noise."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    clean = 0.01 + 0.89 * torch.rand((b, 32, 32, 4), generator=g, device="cuda")
    x = torch.randn((b, 32, 32, 4), generator=g, device="cuda") * torch.sqrt(5e-4 * clean + 2e-6)
    cond = {"clean": clean,
            "iso": torch.tensor([GRID[i % 5][0] for i in range(b)], device="cuda"),
            "cam": torch.tensor([GRID[(i // 5) % 5][1] for i in range(b)], device="cuda"),
            "nlf0": torch.full((b,), 5e-4, device="cuda"),
            "nlf1": torch.full((b,), 2e-6, device="cuda")}
    return x.contiguous(), cond


def _train_work(inputs, b, kind: str):
    """(FLOPs, bytes) of the train step (kind "step": forward, data gradient
    and weight gradient of every conv and mix, 3x the forward's
    multiply-adds), of one segment's forward ("forward": running BN;
    "ghost": ghost BN, which also writes the group moments) or of one
    segment's backward ("backward": its forward again, then both gradients,
    3x the forward's). Bytes: each input read once, each output written
    once."""
    rec, offs, mixes = inputs[:3]
    n_c, n_m = rec.shape[0], mixes.shape[0]
    mac_per_px = n_c * (9 * 2 * 4 + 4 * 4 + 9 * 4 * 4) + n_m * 16
    weights = rec.numel() + offs.numel() + mixes.numel()
    fwd_flops = 2.0 * mac_per_px * 1024 * b
    if kind == "forward":
        return fwd_flops, 4.0 * (2 * b * 4096 + b + weights)
    if kind == "ghost":
        return fwd_flops, 4.0 * (2 * b * 4096 + b + weights + n_c * 16)
    if kind == "backward":   # x, gz, gldj, weights in; gx, gradients out
        return 3 * fwd_flops, 4.0 * (3 * b * 4096 + b + 2 * weights)
    ns = inputs[3].shape[1]
    return (3 * fwd_flops,
            4.0 * (2 * b * 4096 + 4 * b * ns + 2 * weights + 3 * b + n_c * 16))


def _training_phases(phase, agree):
    """Phases 7-11 (see the module docstring); returns the kernels' entries
    for the kernels line."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.data.patches import PatchDataset
    from noise_flow_tpu_torch.data.stats import calc_baselines, calc_pat_stats
    from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.ops import fused_train as ft
    from noise_flow_tpu_torch.training.trainer import Trainer, make_optimizer
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    out = {"entries": []}
    errs, launches, timings = {}, {}, {}
    cfg = load_hps(os.path.join(MODEL, "hps.txt"))
    flow = NoiseFlow((32, 32, 4), cfg, device="cuda")
    load_checkpoint(os.path.join(MODEL, "ckpt", "model.ckpt-best.npz"), flow)
    b = TRAIN_B
    x, cond = _train_batch(b, seed=11)

    def kernel_inputs(step):
        with torch.no_grad():
            rec, offs, mixes, _ = step.fold()
            sa, sb, _ = step._prep(cond, b)
        return rec, offs, mixes, sa, sb

    def raw(step, inputs, bt, fn, **kw):
        rec, offs, mixes, sa, sb = inputs
        return fn(x, cond["clean"], sa, sb, rec, offs, mixes, step.ops_code, bt, **kw)

    def raw_agree(label, k, p):
        """The kernel's raw outputs against the plain version's: rows and
        BN moments elementwise, every gradient normwise."""
        torch.cuda.synchronize()
        worst, ok = 0.0, True
        for key in p:
            if key == "bnmom":
                e = float((k[key] - p[key]).abs().max())
                good = e <= BN_ATOL
            else:
                e = _norm_rel(k[key], p[key])
                good = e <= (ROWS_RTOL if key == "rows" else RAW_GRAD_RTOL)
            good = good and bool(torch.isfinite(k[key]).all())
            ok = ok and good
            worst = max(worst, float((k[key] - p[key]).abs().max()))
            print(f"  {label} {key}: {'abs' if key == 'bnmom' else 'normwise rel'} "
                  f"{e:.3e} max_abs {float((k[key] - p[key]).abs().max()):.3e} "
                  f"{'ok' if good else 'DISAGREES'}")
        print(f"compare {label}: {'ok' if ok else 'DISAGREES'}")
        return ok, worst

    def step_vs_plain(bt):
        step = ft.FusedTrainStep(flow, bt=bt)
        inputs = kernel_inputs(step)
        ok, worst = raw_agree(f"train step raw b={b} bt={bt}", raw(step, inputs, bt, ft.fused_train_step),
                              raw(step, inputs, bt, ft.train_step_reference))
        nk, sk, stk, gk = step.loss_and_grad(x, cond)
        npl, sp, stp, gp = step.loss_and_grad(x, cond, step_fn=ft.train_step_reference)
        torch.cuda.synchronize()
        e_loss = abs(float(nk) - float(npl)) / abs(float(npl))
        e_sd = abs(float(sk) - float(sp)) / abs(float(sp))
        e_st = max(float((stk[k] - stp[k]).abs().max()) for k in stp)
        print(f"compare train step b={b} bt={bt}: loss {float(nk):.4f} vs {float(npl):.4f} "
              f"(rel {e_loss:.2e}, tol {LOSS_RTOL}); sd_z rel {e_sd:.2e}; new BN state "
              f"max_abs {e_st:.2e} (tol {BN_ATOL * 0.1:.0e})")
        ok = ok and e_loss <= LOSS_RTOL and e_sd <= LOSS_RTOL and e_st <= BN_ATOL * 0.1
        rels, max_abs, max_rel = {}, 0.0, 0.0
        for name, g in gp.items():
            if name.endswith(("l1_b", "l2_b")):
                # BN removes the mean: the kernel's gradient is exactly zero,
                # the plain version's is autograd's rounding
                ok = ok and float(gk[name].abs().max()) == 0.0
                continue
            rels[name] = _norm_rel(gk[name], g)
            max_abs = max(max_abs, float((gk[name] - g).abs().max()))
            max_rel = max(max_rel, float(((gk[name] - g).abs() / g.abs().clamp_min(1e-6)).max()))
        bad = {k: v for k, v in rels.items() if not v <= LEAF_GRAD_RTOL}
        worst_leaf = max(rels, key=rels.get)
        print(f"compare parameter gradients b={b} bt={bt}: {len(rels)} leaves, worst normwise "
              f"{rels[worst_leaf]:.3e} ({worst_leaf}), max_abs {max_abs:.3e}, max_rel {max_rel:.3e} "
              f"(tol normwise {LEAF_GRAD_RTOL}); l1_b/l2_b exactly zero; "
              f"{'ok' if not bad and ok else 'DISAGREES ' + str(sorted(bad))}")
        errs[bt] = max(worst, max_abs)
        if bad or not ok:
            raise AssertionError(f"train step kernel disagrees with plain at bt={bt}")

    for bt in TRAIN_BTS:
        phase(f"train step kernel vs plain b={b} bt={bt}", lambda bt=bt: step_vs_plain(bt))

    ff = ft.FusedFlow(flow, bt=b)
    segs = [item for item in ff.plan if item[0] == "segment"]

    def seg_inputs(lo, hi):
        with torch.no_grad():
            coups = [flow.layers[i] for i in range(lo, hi) if flow.specs[i].kind == "coupling"]
            mi = [i for i in range(lo, hi) if flow.specs[i].kind != "coupling"]
            rec, offs = ft.fold_couplings(coups, fold_bn=True)
            mixes, _ = ft.fold_mixes([flow.specs[i] for i in mi], [flow.layers[i] for i in mi], "cuda")
        return rec, offs, mixes

    z_in = torch.randn((b, 32, 32, 4), generator=torch.Generator(device="cuda").manual_seed(12),
                       device="cuda")

    def segment_vs_plain():
        worst = 0.0
        for n, (_, seg, lo, hi) in enumerate(segs):
            rec, offs, mixes = seg_inputs(lo, hi)
            code = ft._ops_code(seg.ops)
            zk, lk = ft.fused_segment_forward(z_in, rec, offs, mixes, code)
            zp, lp = ft.segment_forward_reference(z_in, rec, offs, mixes, code)
            ok, e = agree(f"segment {n} z b={b}", zk, zp, SEG_TOL)
            e_l = float(((lk - lp).abs() / lp.abs().clamp_min(1.0)).max())
            print(f"compare segment {n} ldj b={b}: max rel {e_l:.3e} (tol {LDJ_RTOL})")
            worst = max(worst, e, float((lk - lp).abs().max()))
            if not ok or not e_l <= LDJ_RTOL:
                raise AssertionError(f"segment forward kernel disagrees with plain (segment {n})")
        errs["segment"] = worst
    phase(f"segment forward kernel vs plain b={b}", segment_vs_plain)

    def planted_faults():
        step = ft.FusedTrainStep(flow, bt=69)
        inputs = kernel_inputs(step)
        right = raw(step, inputs, 69, ft.train_step_reference)
        left_out = raw(step, inputs, 69, ft.fused_train_step)
        left_out["grad_rec"][3] = 0.0        # coupling 3's weight gradients left out
        left_out["grad_offs"][3] = 0.0
        faults = (("BN groups of bt/3", raw(step, inputs, 23, ft.fused_train_step)),
                  ("one coupling's weight gradients left out", left_out),
                  ("ldj seed sign flipped", raw(step, inputs, 69, ft.fused_train_step,
                                                ldj_seed=1.0 / b)))
        for name, wrong in faults:
            ok, _ = raw_agree(f"planted fault ({name})", wrong, right)
            if ok:
                raise AssertionError(f"the comparison missed a planted fault: {name}")
    phase("train planted faults are caught", planted_faults)

    tcfg = load_hps(os.path.join(MODEL, "hps.txt"))
    tcfg.use_pallas, tcfg.pallas_oneshot, tcfg.pallas_train_dtype = True, True, "float32"
    tcfg.epochs, tcfg.continue_training = TRAIN_EPOCHS, False
    tr = PatchDataset(make_synthetic_samples(TRAIN_IMAGES, 512, 512, seed=0,
                                             isos=[100, 400, 800, 1600, 3200]), 32, 256)
    ts = PatchDataset(make_synthetic_samples(TEST_IMAGES, 512, 512, seed=9,
                                             isos=[100, 400, 800, 1600, 3200]), 32, 256)

    def train(oneshot):
        """A 2-epoch fit through the one-shot step or the segment path."""
        cfg = copy.copy(tcfg)
        cfg.pallas_oneshot = oneshot
        trainer = Trainer(NoiseFlow((32, 32, 4), cfg, device="cuda", seed=cfg.seed), cfg)
        if trainer.use_oneshot != oneshot or not trainer.use_fused:
            raise AssertionError(f"trainer took use_oneshot={trainer.use_oneshot}")
        n_seg = sum(1 for it in trainer._fused_for_batch(b).plan if it[0] == "segment")
        stats = calc_pat_stats(tr.x, tr.y)
        nll_g, nll_sdn = calc_baselines(ts.batches(b, drop_remainder=True), stats["sc_in_vr"])
        n_tr = trainer.stage_dataset(tr.batches(b, drop_remainder=True), "train")
        n_ts = trainer.stage_dataset(ts.batches(b, drop_remainder=True), "test")
        steps, test_steps = n_tr // b, n_ts // b
        nlls = []
        inner = trainer.train_step

        def recording(batch):
            r = inner(batch)
            nlls.append(r[0])
            return r
        trainer.train_step = recording
        logdir = os.path.join(ROOT, "build", "chip_smoke_fit")   # gitignored
        shutil.rmtree(logdir, ignore_errors=True)
        fs.launch_counts.clear()
        t0 = time.time()
        trainer.fit(None, None, logdir, epochs=TRAIN_EPOCHS, nll_gauss=nll_g, nll_sdn=nll_sdn,
                    sc_sd=stats["sc_in_sd"], do_sampling=True, verbose=True)
        torch.cuda.synchronize()
        t_fit = time.time() - t0
        counts = _main_path(dict(fs.launch_counts))
        launches[oneshot] = counts
        nll = torch.stack(nlls).cpu().numpy()
        # eval steps: each test batch, plus the sampling phase's first batch
        # (its NLL round trip takes the numpy path for the .mat dump); train
        # steps: one step kernel, or a forward and a backward a segment
        train_launches = TRAIN_EPOCHS * steps * (1 if oneshot else n_seg)
        want = {"fused_train_step": train_launches if oneshot else 0,
                "fused_segment_train_forward": 0 if oneshot else train_launches,
                "fused_segment_backward": 0 if oneshot else train_launches,
                "fused_segment_forward": TRAIN_EPOCHS * (test_steps + 1) * n_seg}
        print(f"train ({'one-shot' if oneshot else 'segment path'}): {n_tr} train / {n_ts} "
              f"test patches staged, fit of {TRAIN_EPOCHS} epochs in {t_fit:.2f} s; launches "
              f"{counts} (expected {want}); NLL first 10 {nll[:10].mean():.3f}, last 10 "
              f"{nll[-10:].mean():.3f}")
        for name, n in want.items():
            if counts.get(name, 0) != n:
                raise AssertionError(f"{name} launched {counts.get(name, 0)} times, not {n}")
        if not np.isfinite(nll).all() or not nll[-10:].mean() < nll[:10].mean():
            raise AssertionError("train NLL not finite or not falling")
        cols = ["epoch", "NLL", "NLL_G", "NLL_SDN", "sdz"]
        for name, extra in (("train.txt", ["train_time"]), ("test.txt", ["msg"]),
                            ("sample.txt", ["sample_time", "KLD_G", "KLD_NLF", "KLD_NF", "KLD_R"])):
            with open(os.path.join(logdir, name)) as f:
                rows = [r.split("\t") for r in f.read().splitlines()]
            if rows[0] != cols + extra or len(rows) != TRAIN_EPOCHS + 1:
                raise AssertionError(f"{name}: header {rows[0]}, {len(rows) - 1} rows")
            vals = np.asarray([[float(v) for v in r] for r in rows[1:]])
            if not np.isfinite(vals).all():
                raise AssertionError(f"{name} has values that are not finite: {vals}")
            print(f"  {name}: {rows[0]} last {rows[-1]}")
        for tag in [str(e) for e in range(1, TRAIN_EPOCHS + 1)] + ["best"]:
            back = NoiseFlow((32, 32, 4), cfg, device="cuda", seed=1)
            opt = make_optimizer(cfg, list(back.parameters()))
            path = os.path.join(logdir, "ckpt", f"model.ckpt-{tag}.npz")
            epoch = load_checkpoint(path, back, opt)
            if not opt.state and epoch > 1:
                raise AssertionError(f"{path}: no optimizer slots")
            print(f"  checkpoint {tag}: epoch {epoch}, {len(opt.state)} optimizer slots loaded")
        shutil.rmtree(logdir, ignore_errors=True)
        return trainer
    trainer = phase("train on the card (fit, staged data)", lambda: train(True))

    def trajectory(oneshot):
        """5 Adam steps through the kernels and 5 through their plain
        versions, on the one-shot path or the segment path."""
        runs = {}
        fns = ((("kernel", ft.fused_train_step), ("plain", ft.train_step_reference)) if oneshot
               else (("kernel", ft.SEGMENT_KERNELS), ("plain", ft.SEGMENT_PLAIN)))
        for name, fn in fns:
            f = NoiseFlow((32, 32, 4), tcfg, device="cuda", seed=tcfg.seed)
            opt = make_optimizer(tcfg, [q for _, q in f.named_parameters()])
            if oneshot:
                step = ft.FusedTrainStep(f, bt=69)
            else:
                ff_t = ft.FusedFlow(f, bt=69)
            for i in range(5):
                mb = {k: torch.as_tensor(v[i * b:(i + 1) * b], device="cuda")
                      for k, v in (("_x", tr.x), ("_y", tr.y), ("nlf0", tr.nlf0),
                                   ("nlf1", tr.nlf1), ("iso", tr.iso), ("cam", tr.cam))}
                cnd = {"clean": mb["_y"], "nlf0": mb["nlf0"], "nlf1": mb["nlf1"],
                       "iso": mb["iso"], "cam": mb["cam"]}
                if oneshot:
                    nll, _, new_state = step.loss(mb["_x"], cnd, step_fn=fn)
                else:
                    nll, _, new_state = ff_t.loss(mb["_x"], cnd, train=True, seg_fns=fn)
                opt.zero_grad(set_to_none=True)
                nll.backward()
                opt.step()
                f.apply_state(new_state)
            runs[name] = f
        init = NoiseFlow((32, 32, 4), tcfg, device="cuda", seed=tcfg.seed)
        pk, pp, p0 = (dict(r.named_parameters()) for r in (runs["kernel"], runs["plain"], init))
        with torch.no_grad():
            diffs = {k: float((pk[k] - pp[k]).abs().max()) for k in pp
                     if not k.endswith(("l1_b", "l2_b"))}
            moved = max(float((pp[k] - p0[k]).abs().max()) for k in diffs)
        worst = max(diffs, key=diffs.get)
        print(f"trajectory ({'one-shot' if oneshot else 'segment path'}): 5 Adam steps "
              f"(lr {tcfg.lr}), kernel vs plain: max abs param "
              f"difference {diffs[worst]:.3e} ({worst}); largest move from init {moved:.3e}; "
              f"tol {TRAJ_ATOL} (l1_b/l2_b left out: their true gradient is zero, and Adam "
              f"turns the plain version's rounding into lr-sized steps)")
        if not diffs[worst] <= TRAJ_ATOL:
            raise AssertionError("kernel and plain trajectories disagree")
    phase("trajectory: 5 Adam steps kernel vs plain", lambda: trajectory(True))

    def timing():
        for bt in TRAIN_BTS:
            step = ft.FusedTrainStep(flow, bt=bt)
            inputs = kernel_inputs(step)
            k_ms = _time_ms(lambda: raw(step, inputs, bt, ft.fused_train_step), 20)
            p_ms = _time_ms(lambda: raw(step, inputs, bt, ft.train_step_reference), 5)
            flops, nbytes = _train_work(inputs, b, "step")
            t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
            timings[bt] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
                           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
            print(f"time train step b={b} bt={bt}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {timings[bt]['bound_ms']:.4f} ms ({timings[bt]['bound_by']}; "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
        ins = [(seg_inputs(lo, hi), ft._ops_code(seg.ops)) for _, seg, lo, hi in segs]
        k_ms = _time_ms(lambda: [ft.fused_segment_forward(z_in, *i, c) for i, c in ins], 20)
        p_ms = _time_ms(lambda: [ft.segment_forward_reference(z_in, *i, c) for i, c in ins], 5)
        work = [_train_work(i, b, "forward") for i, _ in ins]
        t_ops = sum(w[0] for w in work) / PEAK_FP32_FLOPS
        t_bytes = sum(w[1] for w in work) / PEAK_HBM_BYTES
        timings["segment"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
                              "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"time segment forward b={b} ({len(ins)} calls, one eval step): kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {timings['segment']['bound_ms']:.4f} ms "
              f"({timings['segment']['bound_by']})")
    phase("train timing", timing)

    def step_breakdown():
        """One train step of the trainer on the host clock, and its parts,
        each timed alone between synchronisations, 10 times."""
        if trainer is None:
            raise AssertionError("no trainer (the train phase failed)")
        batch = trainer._gather_staged(trainer._staged_train, torch.arange(b, device="cuda"))
        cnd = {"clean": batch["_y"], "nlf0": batch["nlf0"], "nlf1": batch["nlf1"],
               "iso": batch["iso"], "cam": batch["cam"]}
        step = trainer._step_for_batch(b)
        parts = {k: 0.0 for k in ("step", "fold", "_prep", "kernel", "backward", "adam")}
        n = 10

        def clock(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            parts[name] += (time.perf_counter() - t0) * 1e3 / n
            return r
        for _ in range(3):
            trainer.train_step(batch)
        for _ in range(n):
            clock("step", lambda: trainer.train_step(batch))
            folded = clock("fold", step.fold)
            sa, sb, _ = clock("_prep", lambda: step._prep(cnd, b))
            with torch.no_grad():
                inputs = (*(t.detach() for t in folded[:3]), sa.detach(), sb.detach())
            clock("kernel", lambda: raw(step, inputs, step.bt, ft.fused_train_step))
            nll, _, _ = step.loss(batch["_x"], cnd)
            trainer.optimizer.zero_grad(set_to_none=True)
            clock("backward", nll.backward)
            clock("adam", trainer.optimizer.step)
        print("breakdown train step b=138 bt=69 (host clock, ms): " +
              ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    phase("train step breakdown", step_breakdown)

    # ---- the segment path ---------------------------------------------------
    ffs = ft.FusedFlow(flow, bt=b)
    with torch.no_grad():
        train_segs = [(*ffs.fold_segment(lo, hi, fold_bn=False)[:3], ft._ops_code(seg.ops))
                      for _, seg, lo, hi in segs]
    gen = torch.Generator(device="cuda").manual_seed(13)
    # cotangents at the scale of the mean NLL's, but not its analytic seeds
    gz = torch.randn((b, 32, 32, 4), generator=gen, device="cuda") / b
    gldj = (-1.0 + 0.5 * torch.randn((b,), generator=gen, device="cuda")) / b
    grad_names = ("gx", "grad_rec", "grad_offs", "grad_mixes")

    def bwd_agree(label, k, p):
        """The backward kernel's outputs against the plain version's,
        normwise; returns (agrees, max abs error)."""
        torch.cuda.synchronize()
        ok, worst = True, 0.0
        for name, a, r in zip(grad_names, k, p):
            e = _norm_rel(a, r)
            good = e <= SEG_GRAD_RTOL and bool(torch.isfinite(a).all())
            ok = ok and good
            worst = max(worst, float((a - r).abs().max()))
            print(f"  {label} {name}: normwise rel {e:.3e} max_abs "
                  f"{float((a - r).abs().max()):.3e} {'ok' if good else 'DISAGREES'}")
        print(f"compare {label}: {'ok' if ok else 'DISAGREES'}")
        return ok, worst

    def ghost_vs_plain(bt):
        worst = 0.0
        for n, (rec, offs, mixes, code) in enumerate(train_segs):
            zk, lk, mk = ft.fused_segment_train_forward(z_in, rec, offs, mixes, code, bt)
            zp, lp, mp = ft.segment_train_forward_reference(z_in, rec, offs, mixes, code, bt)
            ok, e = agree(f"ghost segment {n} z b={b} bt={bt}", zk, zp, SEG_TOL)
            e_l = float(((lk - lp).abs() / lp.abs().clamp_min(1.0)).max())
            d_m = (mk - mp).abs()
            ok_m = bool((d_m <= GHOST_BN_TOL[0] + GHOST_BN_TOL[1] * mp.abs()).all())
            print(f"compare ghost segment {n} ldj b={b} bt={bt}: max rel {e_l:.3e} (tol "
                  f"{LDJ_RTOL}); group moments max_abs {float(d_m.max()):.3e} max_rel "
                  f"{float((d_m / mp.abs().clamp_min(1e-6)).max()):.3e} (atol, rtol "
                  f"{GHOST_BN_TOL}) {'ok' if ok_m else 'DISAGREES'}")
            worst = max(worst, e, float((lk - lp).abs().max()), float(d_m.max()))
            if not (ok and e_l <= LDJ_RTOL and ok_m):
                raise AssertionError(f"ghost segment forward disagrees with plain (segment {n})")
        errs[("ghost", bt)] = worst

    def backward_vs_plain(bt):
        worst = 0.0
        for n, (rec, offs, mixes, code) in enumerate(train_segs):
            k = ft.fused_segment_backward(z_in, rec, offs, mixes, code, bt, gz, gldj)
            p = ft.segment_backward_reference(z_in, rec, offs, mixes, code, bt, gz, gldj)
            ok, w = bwd_agree(f"segment {n} backward b={b} bt={bt}", k, p)
            for field in ("b1", "b2"):
                off, shape = fs._REC_LAYOUT[field]
                ok = ok and float(k[1][:, off:off + shape[0]].abs().max()) == 0.0
            worst = max(worst, w)
            if not ok:
                raise AssertionError(f"segment backward disagrees with plain (segment {n}), "
                                     f"or its b1/b2 gradients are not exactly zero")
        errs[("bwd", bt)] = worst

    for bt in TRAIN_BTS:
        phase(f"ghost segment forward kernel vs plain b={b} bt={bt}",
              lambda bt=bt: ghost_vs_plain(bt))
    for bt in TRAIN_BTS:
        phase(f"segment backward kernel vs plain b={b} bt={bt}",
              lambda bt=bt: backward_vs_plain(bt))

    def path_vs_oneshot():
        """Two CUDA kernels computing one function: the segment path's loss
        and gradients against the one-shot step's, at the trainer's bt."""
        params = dict(flow.named_parameters())
        nll_s, sd_s, st_s = ft.FusedFlow(flow, bt=69).loss(x, cond, train=True)
        g_s = torch.autograd.grad(nll_s, list(params.values()), allow_unused=True)
        nll_s = nll_s.detach()
        g_s = {k: torch.zeros_like(q) if g is None else g for (k, q), g in zip(params.items(), g_s)}
        nll_o, sd_o, st_o, g_o = ft.FusedTrainStep(flow, bt=69).loss_and_grad(x, cond)
        torch.cuda.synchronize()
        e_loss = abs(float(nll_s) - float(nll_o)) / abs(float(nll_o))
        e_sd = abs(float(sd_s) - float(sd_o)) / abs(float(sd_o))
        e_st = max(float((st_s[k] - st_o[k]).abs().max()) for k in st_o)
        ok = (set(st_s) == set(st_o) and e_loss <= PATH_LOSS_RTOL and e_sd <= PATH_LOSS_RTOL
              and e_st <= BN_ATOL * 0.1)
        rels = {}
        for k, g in g_o.items():
            if k.endswith(("l1_b", "l2_b")):
                ok = ok and float(g_s[k].abs().max()) == 0.0 == float(g.abs().max())
                continue
            rels[k] = _norm_rel(g_s[k], g)
        worst = max(rels, key=rels.get)
        bad = sorted(k for k, v in rels.items() if not v <= LEAF_GRAD_RTOL)
        print(f"compare segment path vs one-shot b={b} bt=69: loss {float(nll_s):.4f} vs "
              f"{float(nll_o):.4f} (rel {e_loss:.2e}), sd_z rel {e_sd:.2e} (tol {PATH_LOSS_RTOL}); "
              f"new BN state max_abs {e_st:.2e} (tol {BN_ATOL * 0.1:.0e}); {len(rels)} gradient "
              f"leaves, worst normwise {rels[worst]:.3e} ({worst}) (tol {LEAF_GRAD_RTOL}); "
              f"{'ok' if ok and not bad else 'DISAGREES ' + str(bad)}")
        if bad or not ok:
            raise AssertionError("the segment path and the one-shot path disagree")
    phase("segment path vs one-shot path", path_vs_oneshot)

    def segment_faults():
        rec, offs, mixes, code = train_segs[0]
        right = ft.segment_backward_reference(z_in, rec, offs, mixes, code, 69, gz, gldj)
        left_out = [t.clone() for t in ft.fused_segment_backward(z_in, rec, offs, mixes, code,
                                                                 69, gz, gldj)]
        left_out[1][2] = 0.0        # coupling 2's weight gradients left out
        left_out[2][2] = 0.0
        faults = (("BN groups of bt/3 in the backward alone",
                   ft.fused_segment_backward(z_in, rec, offs, mixes, code, 23, gz, gldj)),
                  ("gldj zeroed", ft.fused_segment_backward(z_in, rec, offs, mixes, code, 69, gz,
                                                            torch.zeros_like(gldj))),
                  ("one coupling's weight gradients left out", left_out))
        for name, wrong in faults:
            ok, _ = bwd_agree(f"planted fault ({name})", wrong, right)
            if ok:
                raise AssertionError(f"the comparison missed a planted fault: {name}")
    phase("segment planted faults are caught", segment_faults)

    seg_trainer = phase("train on the card through the segment path (fit, staged data)",
                        lambda: train(False))

    def five_scale():
        cfg = copy.copy(tcfg)
        cfg.arch = FIVE_SCALE_ARCH
        tr5 = Trainer(NoiseFlow((32, 32, 4), cfg, device="cuda", seed=cfg.seed), cfg)
        if tr5.use_oneshot or not tr5.use_fused:
            raise AssertionError(f"{cfg.arch}: use_fused={tr5.use_fused}, "
                                 f"use_oneshot={tr5.use_oneshot}")
        n_seg = sum(1 for it in tr5._fused_for_batch(b).plan if it[0] == "segment")
        fs.launch_counts.clear()
        nlls = [float(tr5.train_step(tr5._put(mb))[0])
                for mb in itertools.islice(tr.batches(b, drop_remainder=True), 5)]
        counts = _main_path(dict(fs.launch_counts))
        want = {"fused_segment_train_forward": 5 * n_seg, "fused_segment_backward": 5 * n_seg}
        print(f"train {cfg.arch} (5 scale layers, segment path): 5 steps at b={b}, NLL "
              f"{[round(v, 3) for v in nlls]}; launches {counts} (expected {want})")
        if counts != want or not np.isfinite(nlls).all():
            raise AssertionError("5-scale arch: launches or losses wrong")
    phase("train the 5-scale arch (segment path)", five_scale)
    phase("trajectory (segment path): 5 Adam steps kernel vs plain", lambda: trajectory(False))

    def segment_timing():
        for bt in TRAIN_BTS:
            for kind, fn, plain in (
                    ("ghost", lambda bt=bt: [ft.fused_segment_train_forward(z_in, *sg, bt)
                                             for sg in train_segs],
                     lambda bt=bt: [ft.segment_train_forward_reference(z_in, *sg, bt)
                                    for sg in train_segs]),
                    ("backward", lambda bt=bt: [ft.fused_segment_backward(z_in, *sg, bt, gz, gldj)
                                                for sg in train_segs],
                     lambda bt=bt: [ft.segment_backward_reference(z_in, *sg, bt, gz, gldj)
                                    for sg in train_segs])):
                k_ms = _time_ms(fn, 20)
                p_ms = _time_ms(plain, 5)
                work = [_train_work(sg, b, kind) for sg in train_segs]
                flops, nbytes = sum(w[0] for w in work), sum(w[1] for w in work)
                t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
                key = ("ghost" if kind == "ghost" else "bwd", bt)
                timings[key] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
                                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
                print(f"time segment {kind} b={b} bt={bt} ({len(train_segs)} calls, one train "
                      f"step): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                      f"{timings[key]['bound_ms']:.4f} ms ({timings[key]['bound_by']}; "
                      f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
    phase("segment timing", segment_timing)

    def segment_step_breakdown():
        """One segment-path train step of the trainer on the host clock, and
        its parts, each timed alone between synchronisations, 10 times. The
        loss holds the folds and the forward kernels; backward holds the
        backward kernels and autograd through the scale layers and folds."""
        if seg_trainer is None:
            raise AssertionError("no trainer (the segment-path train phase failed)")
        batch = seg_trainer._gather_staged(seg_trainer._staged_train,
                                           torch.arange(b, device="cuda"))
        cnd = {"clean": batch["_y"], "nlf0": batch["nlf0"], "nlf1": batch["nlf1"],
               "iso": batch["iso"], "cam": batch["cam"]}
        ff_s = seg_trainer._fused_for_batch(b)
        parts = {k: 0.0 for k in ("step", "loss", "fold", "fwd kernels", "backward",
                                  "bwd kernels", "adam")}
        n = 10

        def clock(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            parts[name] += (time.perf_counter() - t0) * 1e3 / n
            return r
        for _ in range(3):
            seg_trainer.train_step(batch)
        for _ in range(n):
            clock("step", lambda: seg_trainer.train_step(batch))
            nll = clock("loss", lambda: ff_s.loss(batch["_x"], cnd, train=True))[0]
            clock("fold", lambda: [ff_s.fold_segment(lo, hi, False) for _, _, lo, hi in segs])
            clock("fwd kernels", lambda: [ft.fused_segment_train_forward(z_in, *sg, ff_s.bt)
                                          for sg in train_segs])
            seg_trainer.optimizer.zero_grad(set_to_none=True)
            clock("backward", nll.backward)
            clock("bwd kernels", lambda: [ft.fused_segment_backward(z_in, *sg, ff_s.bt, gz, gldj)
                                          for sg in train_segs])
            clock("adam", seg_trainer.optimizer.step)
        print(f"breakdown segment-path train step b={b} bt={ff_s.bt} (host clock, ms): " +
              ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    phase("segment-path train step breakdown", segment_step_breakdown)

    need_t = [69, 138, "segment"] + [(k, bt) for k in ("ghost", "bwd") for bt in TRAIN_BTS]
    if all(k in timings and k in errs for k in need_t) and True in launches and False in launches:
        seg_l = launches[False]

        def by_bt(kind):
            return {f"b=138,bt={bt}": dict(timings[(kind, bt)], max_abs_err=errs[(kind, bt)])
                    for bt in TRAIN_BTS}
        common = {"route": "cuda", "source": "noise_flow_tpu_torch/csrc/fused_train.cu",
                  "library_ms": None}
        out["entries"] = [
            {"name": "fused_train_step", **common,
             "replaces": "noise_flow_tpu/ops/pallas_train.py:645",
             "launches": launches[True].get("fused_train_step", 0),
             "max_abs_err": max(errs[69], errs[138]), **timings[69],
             "shape": "b=138, bt=69 (the trainer's block)",
             "by_shape": {f"b=138,bt={bt}": dict(timings[bt], max_abs_err=errs[bt])
                          for bt in TRAIN_BTS}},
            {"name": "fused_segment_forward", **common,
             "replaces": "noise_flow_tpu/ops/pallas_train.py:315",
             "launches": seg_l.get("fused_segment_forward", 0)
             + seg_l.get("fused_segment_train_forward", 0),
             "max_abs_err": max(errs["segment"], *(errs[("ghost", bt)] for bt in TRAIN_BTS)),
             **timings[("ghost", 69)],
             "shape": "b=138, ghost BN bt=69 (the segment path's block), both segments of one "
                      "train step",
             "by_mode": {
                 "running": dict(timings["segment"], max_abs_err=errs["segment"],
                                 launches=seg_l.get("fused_segment_forward", 0),
                                 shape="b=138, both segments of one eval step"),
                 "ghost": dict(timings[("ghost", 69)], max_abs_err=errs[("ghost", 69)],
                               launches=seg_l.get("fused_segment_train_forward", 0),
                               by_shape=by_bt("ghost"))}},
            {"name": "fused_segment_backward", **common,
             "replaces": "noise_flow_tpu/ops/pallas_train.py:388",
             "launches": seg_l.get("fused_segment_backward", 0),
             "max_abs_err": max(errs[("bwd", bt)] for bt in TRAIN_BTS), **timings[("bwd", 69)],
             "shape": "b=138, bt=69, both segments of one train step",
             "by_shape": by_bt("bwd")},
        ]
    return out


def _rng_dncnn_phases(phase, agree, programs, nf):
    """Phases 19-25 (see the module docstring): the sampler's in-kernel RNG
    mode and the DnCNN path. Returns the RNG mode's errors, launches and
    times, and the eps mode's times at the same shapes, for the kernels
    line."""
    import numpy as np
    import torch
    from scipy.stats import kstwobign
    from noise_flow_tpu_torch.cli import test_dncnn, train_dncnn
    from noise_flow_tpu_torch.data.dncnn_data import synthetic_dncnn_data
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.training.dncnn_trainer import DnCNNTrainer

    out = {"errs": {}, "timings": {}, "launches": None}
    errs, timings = out["errs"], out["timings"]
    dev = torch.device("cuda")

    def plain_rng_chain(prog, seed, temp, clean, sa, sb, bt):
        x = fs.rng_normals_reference(seed, clean.shape[0], device=dev) * temp
        return fs.sample_chain_reference(prog, x, clean, sa, sb, bt)

    def normals():
        for b in (128, RNG_STATS_B):
            k = fs.rng_normals(RNG_SEED, b, dev)
            p = fs.rng_normals_reference(RNG_SEED, b, device=dev)
            ok, errs[("normals", b)] = agree(f"rng normals b={b} (abs)", k, p, (RNG_ATOL, 0.0))
            if not ok:
                raise AssertionError(f"the kernel's normals disagree with plain at b={b}")
        v = k.double().reshape(-1)
        n = v.numel()
        mean, sd = float(v.mean()), float(v.std())
        cdf = torch.special.ndtr(torch.sort(v).values)
        i = torch.arange(n, device=dev, dtype=torch.float64)
        d = max(float(((i + 1) / n - cdf).max()), float((cdf - i / n).max()))
        p_ks = float(kstwobign.sf(d * np.sqrt(n)))
        lim_m, lim_s = 5 / np.sqrt(n), 5 * np.sqrt(0.5 / n)
        print(f"rng normals b={RNG_STATS_B}: {n} values, mean {mean:.3e} (|.| < {lim_m:.1e}), "
              f"sd {sd:.6f} (|sd - 1| < {lim_s:.1e}), KS D {d:.3e} p {p_ks:.3f} (> 1e-3)")
        if not (abs(mean) < lim_m and abs(sd - 1) < lim_s and p_ks > 1e-3):
            raise AssertionError("the kernel's normals fail the N(0, 1) checks")
    phase("rng normals on the card", normals)

    def rng_vs_plain(mode, b, bt):
        prog = programs[mode]
        _, clean, sa, sb = _inputs(prog, b, seed=b)
        k = fs.fused_sample_chain_rng(prog, RNG_SEED, TEMP, clean, sa, sb, bt)
        p = plain_rng_chain(prog, RNG_SEED, TEMP, clean, sa, sb, bt)
        ok, errs[(mode, b)] = agree(f"rng mode bn={mode} b={b} bt={bt}", k, p)
        again = fs.fused_sample_chain_rng(prog, RNG_SEED, TEMP, clean, sa, sb, bt)
        other = fs.fused_sample_chain_rng(prog, RNG_SEED + 1, TEMP, clean, sa, sb, bt)
        same, differ = bool(torch.equal(k, again)), not bool(torch.equal(k, other))
        print(f"  rng mode b={b}: one seed twice bit for bit {same}; seed + 1 differs {differ}")
        if not (ok and same and differ):
            raise AssertionError(f"rng mode disagrees with plain, or repeats wrongly, at b={b}")
    for mode, b, bt in RNG_SHAPES:
        phase(f"rng mode vs plain bn={mode} b={b} bt={bt}",
              lambda m=mode, b=b, bt=bt: rng_vs_plain(m, b, bt))

    def planted_faults():
        """Each must fail the comparison of phase 19 or 20."""
        mode, b, bt = RNG_SHAPES[0]
        prog = programs[mode]
        _, clean, sa, sb = _inputs(prog, b, seed=b)
        right_n = fs.rng_normals_reference(RNG_SEED, b, device=dev)
        right = plain_rng_chain(prog, RNG_SEED, TEMP, clean, sa, sb, bt)
        k_n = fs.rng_normals(RNG_SEED, b, dev)
        cos_reused = torch.cat([k_n[:, :16], k_n[:, :16]], 1).contiguous()
        faults = (
            ("seed ignored (normals)", fs.rng_normals(0, b, dev), right_n, (RNG_ATOL, 0.0)),
            ("seed ignored (chain)",
             fs.fused_sample_chain_rng(prog, 0, TEMP, clean, sa, sb, bt), right, TOL),
            ("sin half dropped, cos reused (normals)", cos_reused, right_n, (RNG_ATOL, 0.0)),
            ("sin half dropped, cos reused (chain)",
             fs.fused_sample_chain(prog, cos_reused * TEMP, clean, sa, sb, bt), right, TOL),
            ("temperature not applied",
             fs.fused_sample_chain_rng(prog, RNG_SEED, 1.0, clean, sa, sb, bt), right, TOL),
        )
        for name, wrong, ref, tol in faults:
            ok, _ = agree(f"planted fault ({name}) b={b}", wrong, ref, tol)
            if ok:
                raise AssertionError(f"the comparison missed a planted fault: {name}")
    phase("rng planted faults are caught", planted_faults)

    def sampler():
        prog = programs["running"]
        b = SAMPLER_B
        cond, _ = _cond(b, seed=3)
        smp = fs.make_sampler(prog, cond, temp=TEMP, bt=SAMPLER_BT, mm_dtype=torch.float32)
        seeds = itertools.count(100)
        smp(next(seeds))
        torch.cuda.synchronize()
        fs.launch_counts.clear()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tile = smp(next(seeds))
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        counts = _main_path(dict(fs.launch_counts))
        out_bytes = tile.numel() * 4
        ms = _time_ms(lambda: smp(next(seeds)), 20)
        n = 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            smp(next(seeds))
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        timings["make_sampler"] = {"ms": ms, "host_ms": host_ms,
                                   "patches_per_s": b / (ms / 1e3)}
        print(f"make_sampler b={b} bt={SAMPLER_BT} temp {TEMP} running BN: launches a call "
              f"{counts} (want one of each); memory allocated during a call {extra} bytes, the "
              f"output {out_bytes} (no eps: {extra < out_bytes * 1.05}); tile {tuple(tile.shape)}; "
              f"{ms:.4f} ms a call (CUDA events), {host_ms:.4f} ms (host clock, back to back), "
              f"{b / (ms / 1e3):.4e} patches/s")
        if counts != {"fused_sample": 1, "fused_sample_rng": 1} or extra >= out_bytes * 1.05 \
                or tuple(tile.shape) != (b, 32, 128):
            raise AssertionError("make_sampler: launches, memory or shape wrong")
    phase("make_sampler on the card", sampler)

    rows = train_dncnn.cam_iso_rows_from_table(os.path.join(ROOT, "cam_iso_nlf.txt"))

    def dncnn_train():
        save = os.path.join(ROOT, "build", "chip_smoke_dncnn")          # gitignored
        results = os.path.join(ROOT, "build", "chip_smoke_dncnn_results")
        for d in (save, results):
            shutil.rmtree(d, ignore_errors=True)
        clean, _, _ = synthetic_dncnn_data(n_images=DNCNN_IMAGES, batch_size=DNCNN_B)
        n_val = min(len(clean) // 10, 512) or 1     # the CLI's held-out split
        steps = (len(clean) - n_val) // DNCNN_B
        fs.launch_counts.clear()
        t0 = time.time()
        rc = train_dncnn.main([
            "--model", "DnCNN_NF", "--noise_flow_path", MODEL, "--device", "cuda",
            "--depth", str(DNCNN_DEPTH), "--filters", str(DNCNN_FILTERS),
            "--batch_size", str(DNCNN_B), "--max_epoch", str(DNCNN_EPOCHS),
            "--synthetic_data", str(DNCNN_IMAGES), "--save_dir", save,
            "--cam_iso_nlf", os.path.join(ROOT, "cam_iso_nlf.txt")])
        torch.cuda.synchronize()
        t_fit = time.time() - t0
        counts = _main_path(dict(fs.launch_counts))
        out["launches"] = counts.get("fused_sample_rng", 0)
        want = DNCNN_EPOCHS * steps * BATCH_BN_LAUNCHES
        with open(os.path.join(save, "log.csv")) as f:
            log = [r.split(",") for r in f.read().splitlines()]
        losses = [float(r[1]) for r in log]
        print(f"dncnn: train_dncnn DnCNN_NF depth {DNCNN_DEPTH}, {DNCNN_FILTERS} filters, b="
              f"{DNCNN_B}, {DNCNN_EPOCHS} epochs of {steps} steps in {t_fit:.2f} s (rc {rc}); "
              f"launches {counts} (want {want} of fused_sample, all in RNG mode); log.csv {log}")
        if rc != 0 or counts.get("fused_sample", 0) != want or \
                counts.get("fused_sample_rng", 0) != want:
            raise AssertionError(f"DnCNN_NF: rc {rc}, sampler launches {counts}, not {want}")
        if len(losses) != DNCNN_EPOCHS or not np.isfinite(losses).all() or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"DnCNN_NF loss not finite or not falling: {losses}")
        ckpts = sorted(f for f in os.listdir(save) if f.startswith("model.ckpt-"))
        if ckpts != [f"model.ckpt-{e:03d}.npz" for e in range(1, DNCNN_EPOCHS + 1)]:
            raise AssertionError(f"checkpoints written: {ckpts}")
        t0 = time.time()
        rc = test_dncnn.main(["--model_name", "DnCNN_NF", "--model_dir", save,
                              "--result_dir", results, "--synthetic", "--device", "cuda",
                              "--depth", str(DNCNN_DEPTH), "--filters", str(DNCNN_FILTERS)])
        sidd = os.path.join(results, "DnCNN_NF", "SIDD")
        psnr = float(np.loadtxt(os.path.join(sidd, "psnr.txt")))
        ssim = float(np.loadtxt(os.path.join(sidd, "ssim.txt")))
        with open(os.path.join(sidd, "epc_psnr.txt")) as f:
            epc = f.read().split()
        print(f"dncnn: test_dncnn --synthetic in {time.time() - t0:.2f} s (rc {rc}): PSNR "
              f"{psnr:.4f} dB, SSIM {ssim:.4f}, epc_psnr {epc}; files {sorted(os.listdir(sidd))}")
        if rc != 0 or not (np.isfinite(psnr) and np.isfinite(ssim)) or \
                not os.path.exists(os.path.join(sidd, "psnrs.mat")):
            raise AssertionError("test_dncnn: no finite PSNR/SSIM")
        for d in (save, results):
            shutil.rmtree(d, ignore_errors=True)
    phase("train and test DnCNN_NF on the card (CLIs)", dncnn_train)

    clean_np, _, _ = synthetic_dncnn_data(n_images=8, batch_size=DNCNN_B)
    clean_b = torch.as_tensor(clean_np[:DNCNN_B], device=dev)

    def plain_nf_noise(t, clean, p, gen):
        """The trainer's NF noise through the plain versions: the seed's
        normals and the plain chain, one BN group of the batch."""
        b = clean.shape[0]
        cam, iso = p["row"][0], p["row"][1]
        cond = {"clean": clean, "nlf0": torch.zeros(b, device=dev),
                "nlf1": torch.zeros(b, device=dev), "iso": torch.full((b,), iso, device=dev),
                "cam": torch.full((b,), cam, device=dev)}
        sa, sb = t.program.scale_ab(cond, b)
        return plain_rng_chain(t.program, p["seed"], 1.0, clean, sa, sb, b)

    def nf_trainer():
        return DnCNNTrainer(depth=DNCNN_DEPTH, filters=DNCNN_FILTERS, noise_source="nf",
                            noise_flow=nf.flow, cam_iso_rows=rows, device="cuda", seed=0)

    def dncnn_trajectory():
        """Kernel, kernel again, plain, and plain with its noise moved by one
        float32 rounding: each 3 Adam steps from the same weights, data and
        seeds. cuDNN is held to deterministic algorithms here, so that a
        rerun repeats bit for bit and what differs is the noise path."""
        runs = {}
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for name in ("kernel", "kernel again", "plain", "plain, one rounding"):
                t = nf_trainer()
                if name.startswith("plain"):
                    scale = 1.0 + 2.0 ** -23 if name.endswith("rounding") else 1.0
                    make = (lambda clean, p, gen, t=t, scale=scale:
                            plain_nf_noise(t, clean, p, gen) * scale)
                else:
                    make = t._make_noise
                noises = []
                t._make_noise = lambda clean, p, gen, make=make, noises=noises: \
                    noises.append(make(clean, p, gen)) or noises[-1]
                rng, gen = np.random.default_rng(5), torch.Generator(device=dev).manual_seed(6)
                fs.launch_counts.clear()
                losses = []
                for _ in range(3):
                    p = dict(t._noise_params(rng), gauss=False)   # the NF face of the coin
                    losses.append(float(t.train_step(clean_b, None, p, gen)))
                runs[name] = (t, losses, dict(fs.launch_counts), noises)
        finally:
            torch.backends.cudnn.deterministic = det

        def rel(a, b):
            """(worst normwise difference of parameters and BN state, its
            leaf, largest relative loss difference) between two runs."""
            sa, sb = runs[a][0].model.state_dict(), runs[b][0].model.state_dict()
            rels = {k: float((sa[k] - sb[k]).norm() / sb[k].norm().clamp_min(1e-30)) for k in sb}
            worst = max(rels, key=rels.get)
            e_loss = max(abs(x - y) / abs(y) for x, y in zip(runs[a][1], runs[b][1]))
            return rels[worst], worst, e_loss
        ok_noise = True
        for i, (a, b) in enumerate(zip(runs["kernel"][3], runs["plain"][3])):
            ok, _ = agree(f"dncnn step {i} noise kernel vs plain", a, b)
            ok_noise = ok_noise and ok
        kp, kk, pr = rel("kernel", "plain"), rel("kernel", "kernel again"), \
            rel("plain, one rounding", "plain")
        ck, cp = runs["kernel"][2], runs["plain"][2]
        print(f"dncnn trajectory: 3 Adam steps of DnCNN_NF at b={DNCNN_B}: losses kernel "
              f"{runs['kernel'][1]}, plain {runs['plain'][1]}; kernel vs plain: parameters "
              f"and BN state normwise worst {kp[0]:.3e} ({kp[1]}), losses max rel {kp[2]:.3e} "
              f"(tol {DNCNN_TRAJ_RTOL}, {DNCNN_LOSS_RTOL}); kernel vs kernel again {kk[0]:.3e}, "
              f"{kk[2]:.3e}; plain vs its noise moved by one rounding {pr[0]:.3e} ({pr[1]}), "
              f"{pr[2]:.3e}; launches kernel {ck}, plain {cp}")
        if not (ok_noise and kp[0] <= DNCNN_TRAJ_RTOL and kp[2] <= DNCNN_LOSS_RTOL
                and kk[0] == 0.0) or ck.get("fused_sample_rng", 0) != 3 * BATCH_BN_LAUNCHES or cp:
            raise AssertionError("DnCNN_NF trajectories disagree, or launches wrong")
    phase("dncnn trajectory: 3 steps kernel vs plain", dncnn_trajectory)

    def rng_timing():
        for mode, b, bt in (RNG_SHAPES[0], ("running", SAMPLER_B, SAMPLER_B)):
            prog = programs[mode]
            x, clean, sa, sb = _inputs(prog, b, seed=17 + b)
            iters = 20 if b <= 138 else 5
            fns = {"eps": (lambda: fs.fused_sample_chain(prog, x, clean, sa, sb, bt),
                           lambda: fs.sample_chain_reference(prog, x, clean, sa, sb, bt)),
                   "rng": (lambda: fs.fused_sample_chain_rng(prog, RNG_SEED, TEMP, clean, sa, sb,
                                                             bt),
                           lambda: plain_rng_chain(prog, RNG_SEED, TEMP, clean, sa, sb, bt))}
            ms = {k: [] for k in fns}
            for kind in ("eps", "rng", "rng", "eps") * 3:   # in turns, one card
                ms[kind].append(_time_ms(fns[kind][0], iters))
            for kind, (_, plain) in fns.items():
                k_ms, p_ms = float(np.median(ms[kind])), _time_ms(plain, max(2, iters // 4))
                flops, nbytes = _work(prog, b, rng=kind == "rng")
                t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
                timings[(kind, b)] = {"ms": k_ms, "plain_ms": p_ms,
                                      "bound_ms": max(t_ops, t_bytes) * 1e3,
                                      "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                                      "library_ms": None}
                print(f"time {kind} mode bn={mode} b={b} bt={bt}: kernel {k_ms:.4f} ms (median of turns "
                      f"{', '.join(f'{v:.4f}' for v in ms[kind])}), plain {p_ms:.4f} ms, bound "
                      f"{timings[(kind, b)]['bound_ms']:.4f} ms ({timings[(kind, b)]['bound_by']}; "
                      f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")

        t = nf_trainer()
        rng, gen = np.random.default_rng(7), torch.Generator(device=dev).manual_seed(8)
        b = DNCNN_B
        parts = {k: 0.0 for k in ("step", "noise", "scale_ab", "kernel", "forward+backward",
                                  "adam")}
        n = 10

        def clock(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            parts[name] += (time.perf_counter() - t0) * 1e3 / n
            return r
        for _ in range(3):
            t.train_step(clean_b, None, dict(t._noise_params(rng), gauss=False), gen)
        for _ in range(n):
            p = dict(t._noise_params(rng), gauss=False)
            clock("step", lambda: t.train_step(clean_b, None, p, gen))
            noise = clock("noise", lambda: t._make_noise(clean_b, p, gen))
            cond = {"clean": clean_b, "nlf0": torch.zeros(b, device=dev),
                    "nlf1": torch.zeros(b, device=dev),
                    "iso": torch.full((b,), p["row"][1], device=dev),
                    "cam": torch.full((b,), p["row"][0], device=dev)}
            sa, sb = clock("scale_ab", lambda: t.program.scale_ab(cond, b))
            clock("kernel", lambda: fs.fused_sample_chain_rng(t.program, p["seed"], 1.0,
                                                              clean_b, sa, sb, b))
            x_noisy = torch.clamp(clean_b + noise, 0.0, 1.0)

            def fwd_bwd():
                out_, _ = t.model(x_noisy, train=True)
                t.optimizer.zero_grad(set_to_none=True)
                (torch.sum(torch.square(out_ - clean_b)) / 2.0).backward()
            clock("forward+backward", fwd_bwd)
            clock("adam", t.optimizer.step)
        timings["dncnn_step"] = parts
        # the convolutions' FLOPs: forward, weight gradients, and data
        # gradients of all but the first (its input needs none)
        macs = [2.0 * kh * kw * ci * co * b * 32 * 32 for kh, kw, ci, co in
                (tuple(w.shape) for w in t.model.convs)]
        conv_flops = 2 * sum(macs) + sum(macs[1:])
        print(f"breakdown DnCNN_NF train step b={b}, depth {DNCNN_DEPTH}, {DNCNN_FILTERS} "
              f"filters (host clock, ms, each part alone between synchronisations, means of "
              f"{n}): " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) +
              f"; the convolutions {conv_flops / 1e9:.2f} GFLOP a step, "
              f"{conv_flops / parts['forward+backward'] / 1e9:.2f} TFLOP/s over forward+backward")
    phase("rng and dncnn timing", rng_timing)
    return out


def _bf16_phases(phase, programs):
    """Phases 26-30 (see the module docstring): the bfloat16 modes. Returns
    name -> {mode: entry} for the kernels line's ``by_mode``."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.cli import train as train_cli
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.ops import fused_train as ft
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    BF, F32 = "bfloat16", "float32"
    errs, timings, launches = {}, {}, {}
    dev = torch.device("cuda")

    def hold(label, k, p, k32, tol):
        """The bf16 kernel's output k and the float32 kernel's k32 against
        the plain bf16 output p, normwise; (agrees, max abs error)."""
        torch.cuda.synchronize()
        e, e32 = _norm_rel(k, p), _norm_rel(k32, p)
        max_abs = float((k - p).abs().max())
        ok = bool(torch.isfinite(k).all()) and e <= tol < e32
        print(f"compare bf16 {label}: normwise {e:.3e} max_abs {max_abs:.3e} (tol {tol}); "
              f"float32 kernel {e32:.3e} {'ok' if ok else 'DISAGREES'}")
        return ok, max_abs

    def plain_rng(prog, clean, sa, sb, bt, temp=TEMP):
        x = fs.rng_normals_reference(RNG_SEED, clean.shape[0], device=dev) * temp
        return fs.sample_chain_reference(prog, x, clean, sa, sb, bt, BF)

    def sampler_vs_plain(kind, mode, b, bt):
        prog = programs[mode]
        x, clean, sa, sb = _inputs(prog, b, seed=b)
        if kind == "eps":
            k, k32 = (fs.fused_sample_chain(prog, x, clean, sa, sb, bt, m) for m in (BF, F32))
            p = fs.sample_chain_reference(prog, x, clean, sa, sb, bt, BF)
        else:
            k, k32 = (fs.fused_sample_chain_rng(prog, RNG_SEED, TEMP, clean, sa, sb, bt, m)
                      for m in (BF, F32))
            p = plain_rng(prog, clean, sa, sb, bt)
        ok, errs[(kind, b)] = hold(f"sampler {kind} mode bn={mode} b={b} bt={bt}", k, p, k32,
                                   BF16_SAMPLE_RTOL)
        if not ok:
            raise AssertionError(f"bf16 sampler disagrees with plain ({kind}, b={b})")
    for kind, mode, b, bt in (("eps", "batch", 138, 138), ("eps", "batch", 2961, 141),
                              ("rng", "batch", 128, 128), ("rng", "running", 8192, 8192)):
        phase(f"bf16 sampler {kind} mode vs plain bn={mode} b={b}",
              lambda k=kind, m=mode, b=b, bt=bt: sampler_vs_plain(k, m, b, bt))

    cfg = load_hps(os.path.join(MODEL, "hps.txt"))
    flow = NoiseFlow((32, 32, 4), cfg, device="cuda")
    load_checkpoint(os.path.join(MODEL, "ckpt", "model.ckpt-best.npz"), flow)
    b = TRAIN_B
    x, cond = _train_batch(b, seed=11)

    def step_args(bt):
        step = ft.FusedTrainStep(flow, bt=bt, mm_dtype=BF)
        with torch.no_grad():
            rec, offs, mixes, _ = step.fold()
            sa, sb, _ = step._prep(cond, b)
        return step, (x, cond["clean"], sa, sb, rec, offs, mixes, step.ops_code, bt)

    def raw_agree(label, k, k32, p):
        ok, worst = True, 0.0
        for key in p:
            if key == "bnmom":
                e, e32 = (float((a - p[key]).abs().max()) for a in (k[key], k32[key]))
                tol = BF16_BN_ATOL
            else:
                e, e32 = _norm_rel(k[key], p[key]), _norm_rel(k32[key], p[key])
                tol = BF16_STEP_RTOL[key]
            good = e <= tol < e32 and bool(torch.isfinite(k[key]).all())
            ok = ok and good
            worst = max(worst, float((k[key] - p[key]).abs().max()))
            print(f"  {label} {key}: {'abs' if key == 'bnmom' else 'normwise'} {e:.3e} (tol "
                  f"{tol}); float32 kernel {e32:.3e} {'ok' if good else 'DISAGREES'}")
        print(f"compare bf16 {label}: {'ok' if ok else 'DISAGREES'}")
        return ok, worst

    def step_vs_plain(bt):
        step, args = step_args(bt)
        k = ft.fused_train_step(*args, mm_dtype=BF)
        k32 = ft.fused_train_step(*args, mm_dtype=F32)
        p = ft.train_step_reference(*args, mm_dtype=BF)
        torch.cuda.synchronize()
        ok, worst = raw_agree(f"train step raw b={b} bt={bt}", k, k32, p)
        for name in ("b1", "b2"):
            off, shape = fs._REC_LAYOUT[name]
            ok = ok and float(k["grad_rec"][:, off:off + shape[0]].abs().max()) == 0.0
        nk, _, _, gk = step.loss_and_grad(x, cond)
        _, _, _, g32 = ft.FusedTrainStep(flow, bt=bt, mm_dtype=F32).loss_and_grad(x, cond)
        npl, _, _, gp = step.loss_and_grad(x, cond, step_fn=ft.train_step_reference)
        torch.cuda.synchronize()
        e_loss = abs(float(nk) - float(npl)) / abs(float(npl))
        leaves = [n for n in gp if not n.endswith(("l1_b", "l2_b"))]

        def all_leaves(g):
            return float(torch.sqrt(sum(((g[n] - gp[n]) ** 2).sum() for n in leaves)
                                    / sum((gp[n] ** 2).sum() for n in leaves)))
        e_g, e_g32 = all_leaves(gk), all_leaves(g32)
        rels = {n: _norm_rel(gk[n], gp[n]) for n in leaves}
        worst_leaf = max(rels, key=rels.get)
        ok = ok and e_loss <= LOSS_RTOL and e_g <= BF16_LEAF_RTOL < e_g32
        print(f"compare bf16 train step b={b} bt={bt}: loss {float(nk):.4f} vs {float(npl):.4f} "
              f"(rel {e_loss:.2e}, tol {LOSS_RTOL}); parameter gradients normwise over all "
              f"leaves {e_g:.3e} (tol {BF16_LEAF_RTOL}; float32 kernel {e_g32:.3e}), worst leaf "
              f"{rels[worst_leaf]:.3e} ({worst_leaf}); b1/b2 exactly zero; "
              f"{'ok' if ok else 'DISAGREES'}")
        errs[("step", bt)] = worst
        if not ok:
            raise AssertionError(f"bf16 train step kernel disagrees with plain at bt={bt}")
    for bt in TRAIN_BTS:
        phase(f"bf16 train step kernel vs plain b={b} bt={bt}", lambda bt=bt: step_vs_plain(bt))

    ff = ft.FusedFlow(flow, bt=b, mm_dtype=BF)
    with torch.no_grad():
        segs = [(*ff.fold_segment(lo, hi, fold_bn=False)[:3], ft._ops_code(seg.ops),
                 ff.running_moments(lo, hi)) for _, seg, lo, hi in
                (it for it in ff.plan if it[0] == "segment")]
    gen = torch.Generator(device="cuda").manual_seed(13)
    z_in = torch.randn((b, 32, 32, 4), generator=gen, device="cuda")
    gz = torch.randn((b, 32, 32, 4), generator=gen, device="cuda") / b
    gldj = (-1.0 + 0.5 * torch.randn((b,), generator=gen, device="cuda")) / b

    def eval_vs_plain():
        worst, ok = 0.0, True
        for n, (rec, offs, mixes, code, bnrun) in enumerate(segs):
            zk, lk = ft.fused_segment_forward(z_in, rec, offs, mixes, code, BF, bnrun)
            zk32, _ = ft.fused_segment_forward(z_in, rec, offs, mixes, code, F32, bnrun)
            zp, lp = ft.segment_forward_reference(z_in, rec, offs, mixes, code, BF, bnrun)
            good, e = hold(f"eval forward segment {n} z b={b}", zk, zp, zk32, BF16_Z_RTOL)
            e_l = _norm_rel(lk, lp)
            print(f"  eval forward segment {n} ldj: normwise {e_l:.3e} (tol {BF16_LDJ_RTOL})")
            ok = ok and good and e_l <= BF16_LDJ_RTOL
            worst = max(worst, e, float((lk - lp).abs().max()))
        errs["eval"] = worst
        if not ok:
            raise AssertionError("bf16 eval forward kernel disagrees with plain")
    phase(f"bf16 eval forward kernel vs plain b={b}", eval_vs_plain)

    def ghost_and_backward_vs_plain(bt):
        worst_f, worst_b, ok = 0.0, 0.0, True
        for n, (rec, offs, mixes, code, _) in enumerate(segs):
            k = ft.fused_segment_train_forward(z_in, rec, offs, mixes, code, bt, BF)
            k32 = ft.fused_segment_train_forward(z_in, rec, offs, mixes, code, bt, F32)
            p = ft.segment_train_forward_reference(z_in, rec, offs, mixes, code, bt, BF)
            good, e = hold(f"ghost forward segment {n} z b={b} bt={bt}", k[0], p[0], k32[0],
                           BF16_Z_RTOL)
            e_l, e_m = _norm_rel(k[1], p[1]), float((k[2] - p[2]).abs().max())
            e_m32 = float((k32[2] - p[2]).abs().max())
            print(f"  ghost forward segment {n} ldj normwise {e_l:.3e} (tol {BF16_LDJ_RTOL}); "
                  f"group moments abs {e_m:.3e} (tol {BF16_BN_ATOL}; float32 kernel {e_m32:.3e})")
            ok = ok and good and e_l <= BF16_LDJ_RTOL and e_m <= BF16_BN_ATOL < e_m32
            worst_f = max(worst_f, e, float((k[1] - p[1]).abs().max()), e_m)
            k = ft.fused_segment_backward(z_in, rec, offs, mixes, code, bt, gz, gldj, BF)
            k32 = ft.fused_segment_backward(z_in, rec, offs, mixes, code, bt, gz, gldj, F32)
            p = ft.segment_backward_reference(z_in, rec, offs, mixes, code, bt, gz, gldj, BF)
            for name, a, a32, r in zip(("gx", "grad_rec", "grad_offs", "grad_mixes"), k, k32, p):
                good, e = hold(f"segment {n} backward {name} b={b} bt={bt}", a, r, a32,
                               BF16_BWD_RTOL)
                ok = ok and good
                worst_b = max(worst_b, e)
            for field in ("b1", "b2"):
                off, shape = fs._REC_LAYOUT[field]
                ok = ok and float(k[1][:, off:off + shape[0]].abs().max()) == 0.0
        errs[("ghost", bt)], errs[("bwd", bt)] = worst_f, worst_b
        if not ok:
            raise AssertionError(f"bf16 segment kernels disagree with plain at bt={bt}")
    for bt in TRAIN_BTS:
        phase(f"bf16 ghost forward and backward kernels vs plain b={b} bt={bt}",
              lambda bt=bt: ghost_and_backward_vs_plain(bt))

    def planted_faults():
        """One fault of each rounding class, planted in the plain version;
        the kernel held against it must disagree."""
        prog = programs["batch"]
        xs, clean, sa, sb = _inputs(prog, 138, seed=138)
        k = fs.fused_sample_chain(prog, xs, clean, sa, sb, 138, BF)
        k32 = fs.fused_sample_chain(prog, xs, clean, sa, sb, 138, F32)
        zero_conv, rnd = fs._zero_conv, fs.bf16_round
        mix_store = prog.mixes.untyped_storage().data_ptr()
        faults = {}
        try:
            # the zero-conv's input (relu of the hidden map) left unrounded
            fs._zero_conv = lambda h, rec, r: zero_conv(h, rec, lambda t: t if t is h else r(t))
            faults["sampler: zero-conv input unrounded"] = fs.sample_chain_reference(
                prog, xs, clean, sa, sb, 138, BF)
            fs._zero_conv = zero_conv
            # the mix weights (views of program.mixes) left unrounded
            fs.bf16_round = lambda t: (t if t.untyped_storage().data_ptr() == mix_store
                                       else rnd(t))
            faults["sampler: mix weights unrounded"] = fs.sample_chain_reference(
                prog, xs, clean, sa, sb, 138, BF)
        finally:
            fs._zero_conv, fs.bf16_round = zero_conv, rnd
        for name, wrong in faults.items():
            ok, _ = hold(f"planted fault ({name})", k, wrong, k32, BF16_SAMPLE_RTOL)
            if ok:
                raise AssertionError(f"the comparison missed a planted fault: {name}")
        _, args = step_args(69)
        ks = ft.fused_train_step(*args, mm_dtype=BF)
        k32s = ft.fused_train_step(*args, mm_dtype=F32)
        cmean = ft._bf16_cmean
        try:
            ft._bf16_cmean = lambda v, bt: (v.sum(dim=(1, 2, 3)) * (1.0 / (bt * 1024)))[
                :, None, None, None, :]
            wrong = ft.train_step_reference(*args, mm_dtype=BF)
        finally:
            ft._bf16_cmean = cmean
        ok, _ = raw_agree("planted fault (train step: moment sums unrounded)", ks, k32s, wrong)
        if ok:
            raise AssertionError("the comparison missed a planted fault: moment sums unrounded")
    phase("bf16 planted faults are caught", planted_faults)

    def cli_fit(oneshot):
        """2 epochs through cli.train.main --use_pallas at the default
        pallas_train_dtype; the segment path by pallas_oneshot=False, which
        the CLI (as JAX's) takes from the config."""
        logdir = os.path.join(ROOT, "build", "chip_smoke_bf16_fit")   # gitignored
        shutil.rmtree(logdir, ignore_errors=True)
        argv = ["--synthetic_data", str(BF16_FIT_IMAGES), "--use_pallas", "--device", "cuda",
                "--epochs", str(TRAIN_EPOCHS), "--logdir", logdir, "--n_batch_train", str(b),
                "--n_batch_test", str(b)]
        parse = train_cli.parse_config

        def parse_path(a):
            args, c = parse(a)
            c.pallas_oneshot = oneshot
            return args, c
        args, c = parse_path(argv)
        if c.pallas_train_dtype != BF:
            raise AssertionError(f"default pallas_train_dtype is {c.pallas_train_dtype!r}")
        steps = len(train_cli.load_split(args, c, "train")) // b
        test_steps = len(train_cli.load_split(args, c, "test")) // b
        n_seg = sum(1 for it in ft.FusedFlow(flow).plan if it[0] == "segment")
        fs.launch_counts.clear()
        train_cli.parse_config = parse_path
        t0 = time.time()
        try:
            rc = train_cli.main(argv)
        finally:
            train_cli.parse_config = parse
        torch.cuda.synchronize()
        t_fit = time.time() - t0
        counts = _main_path(dict(fs.launch_counts))
        n_train = TRAIN_EPOCHS * steps * (1 if oneshot else n_seg)
        want = {"fused_segment_forward": TRAIN_EPOCHS * test_steps * n_seg}
        for name in (("fused_train_step",) if oneshot else
                     ("fused_segment_train_forward", "fused_segment_backward")):
            want[name] = n_train
        want.update({f"{k}_bf16": v for k, v in want.items()})
        with open(os.path.join(logdir, "train.txt")) as f:
            rows = [r.split("\t") for r in f.read().splitlines()]
        nll = np.asarray([float(r[1]) for r in rows[1:]])
        print(f"train bf16 via cli.train ({'one-shot' if oneshot else 'segment path'}): {steps} "
              f"train and {test_steps} test batches of {b} an epoch, {TRAIN_EPOCHS} epochs in "
              f"{t_fit:.2f} s (rc {rc}); launches {counts} (expected {want}); epoch NLL {nll}")
        if rc != 0 or counts != want:
            raise AssertionError(f"launches {counts}, not {want} (rc {rc})")
        if len(nll) != TRAIN_EPOCHS or not np.isfinite(nll).all() or not nll[-1] < nll[0]:
            raise AssertionError(f"train NLL not finite or not falling: {nll}")
        shutil.rmtree(logdir, ignore_errors=True)
        launches["oneshot" if oneshot else "segment"] = counts
    phase("train bf16 through cli.train (one-shot)", lambda: cli_fit(True))
    phase("train bf16 through cli.train (segment path)", lambda: cli_fit(False))

    def sampler_default():
        prog = programs["running"]
        c, _ = _cond(SAMPLER_B, seed=3)
        smp = fs.make_sampler(prog, c, temp=TEMP, bt=SAMPLER_BT)
        seeds = itertools.count(200)
        smp(next(seeds))
        torch.cuda.synchronize()
        fs.launch_counts.clear()
        n = 5
        tiles = [smp(next(seeds)) for _ in range(n)]
        torch.cuda.synchronize()
        counts = _main_path(dict(fs.launch_counts))
        launches["make_sampler"] = counts
        ms = _time_ms(lambda: smp(next(seeds)), 20)
        timings["make_sampler"] = {"ms": ms, "patches_per_s": SAMPLER_B / (ms / 1e3)}
        want = {"fused_sample": n, "fused_sample_rng": n, "fused_sample_bf16": n}
        print(f"make_sampler defaults (bf16) b={SAMPLER_B} bt={SAMPLER_BT}: {n} calls, launches "
              f"{counts} (want {want}); {ms:.4f} ms a call, {SAMPLER_B / (ms / 1e3):.4e} patches/s")
        if counts != want or not all(bool(torch.isfinite(t).all()) for t in tiles):
            raise AssertionError("make_sampler at its defaults: launches or values wrong")
    phase("make_sampler at its defaults (bf16) on the card", sampler_default)

    def timing():
        """Each bf16 kernel beside its float32 mode, in turns (bf16, f32,
        f32, bf16), the median; its plain bf16 version; its bf16 bound."""
        def turns(key, fn, plain, iters, flops, nbytes):
            ms = {BF: [], F32: []}
            for m in (BF, F32, F32, BF):
                ms[m].append(_time_ms(lambda: fn(m), iters))
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
            timings[key] = {"ms": float(np.median(ms[BF])), "f32_ms": float(np.median(ms[F32])),
                            "plain_ms": _time_ms(plain, 3), "bound_ms": max(t_ops, t_bytes) * 1e3,
                            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                            "library_ms": None}
            t = timings[key]
            print(f"time bf16 {key}: kernel {t['ms']:.4f} ms (float32 mode {t['f32_ms']:.4f}), "
                  f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}; "
                  f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB)")
        prog = programs["batch"]
        xs, clean, sa, sb = _inputs(prog, 138, seed=145)
        turns("eps b=138", lambda m: fs.fused_sample_chain(prog, xs, clean, sa, sb, 138, m),
              lambda: fs.sample_chain_reference(prog, xs, clean, sa, sb, 138, BF), 20,
              *_work(prog, 138))
        prog = programs["running"]
        _, clean, sa, sb = _inputs(prog, SAMPLER_B, seed=146)
        turns(f"rng b={SAMPLER_B}",
              lambda m: fs.fused_sample_chain_rng(prog, RNG_SEED, TEMP, clean, sa, sb,
                                                  SAMPLER_B, m),
              lambda: plain_rng(prog, clean, sa, sb, SAMPLER_B), 5,
              *_work(prog, SAMPLER_B, rng=True))
        _, args = step_args(69)
        rec, offs, mixes = args[4:7]
        turns("step b=138 bt=69", lambda m: ft.fused_train_step(*args, mm_dtype=m),
              lambda: ft.train_step_reference(*args, mm_dtype=BF), 20,
              *_train_work((rec, offs, mixes, args[2]), b, "step"))

        def all_segs(kind):
            w = [_train_work(sg[:3], b, kind) for sg in segs]
            return sum(v[0] for v in w), sum(v[1] for v in w)
        turns("eval forward b=138",
              lambda m: [ft.fused_segment_forward(z_in, *sg[:4], m, sg[4]) for sg in segs],
              lambda: [ft.segment_forward_reference(z_in, *sg[:4], BF, sg[4]) for sg in segs],
              20, *all_segs("forward"))
        turns("ghost forward b=138 bt=69",
              lambda m: [ft.fused_segment_train_forward(z_in, *sg[:4], 69, m) for sg in segs],
              lambda: [ft.segment_train_forward_reference(z_in, *sg[:4], 69, BF) for sg in segs],
              20, *all_segs("ghost"))
        turns("backward b=138 bt=69",
              lambda m: [ft.fused_segment_backward(z_in, *sg[:4], 69, gz, gldj, m) for sg in segs],
              lambda: [ft.segment_backward_reference(z_in, *sg[:4], 69, gz, gldj, BF)
                       for sg in segs], 20, *all_segs("backward"))
    phase("bf16 timing", timing)

    need = [("eps", 138), ("eps", 2961), ("rng", 128), ("rng", SAMPLER_B), ("step", 69),
            ("step", 138), "eval", ("ghost", 69), ("ghost", 138), ("bwd", 69), ("bwd", 138)]
    need_t = ["eps b=138", f"rng b={SAMPLER_B}", "step b=138 bt=69", "eval forward b=138",
              "ghost forward b=138 bt=69", "backward b=138 bt=69", "make_sampler"]
    if not (all(k in errs for k in need) and all(k in timings for k in need_t)
            and {"oneshot", "segment", "make_sampler"} <= set(launches)):
        return {}
    one, seg, smp = launches["oneshot"], launches["segment"], launches["make_sampler"]
    return {
        "fused_sample": {
            "eps_bf16": dict(timings["eps b=138"], launches=0,
                             max_abs_err=max(errs[("eps", 138)], errs[("eps", 2961)]),
                             shape="b=138, bn=batch (no main path runs it: NoiseFlowWrapper "
                                   "samples in float32, as JAX's)"),
            "rng_bf16": dict(timings[f"rng b={SAMPLER_B}"],
                             launches=smp.get("fused_sample_bf16", 0),
                             max_abs_err=max(errs[("rng", 128)], errs[("rng", SAMPLER_B)]),
                             make_sampler=timings["make_sampler"],
                             shape=f"b={SAMPLER_B}, running BN (make_sampler's defaults; "
                                   f"launches: 5 calls)")},
        "fused_train_step": {
            "bf16": dict(timings["step b=138 bt=69"],
                         launches=one.get("fused_train_step_bf16", 0),
                         max_abs_err=max(errs[("step", 69)], errs[("step", 138)]),
                         shape="b=138, bt=69 (launches: the one-shot cli.train fit)")},
        "fused_segment_forward": {
            "running_bf16": dict(timings["eval forward b=138"],
                                 launches=one.get("fused_segment_forward_bf16", 0)
                                 + seg.get("fused_segment_forward_bf16", 0),
                                 max_abs_err=errs["eval"],
                                 shape="b=138, both segments of one eval step (launches: "
                                       "both cli.train fits)"),
            "ghost_bf16": dict(timings["ghost forward b=138 bt=69"],
                               launches=seg.get("fused_segment_train_forward_bf16", 0),
                               max_abs_err=max(errs[("ghost", 69)], errs[("ghost", 138)]),
                               shape="b=138, bt=69, both segments of one train step "
                                     "(launches: the segment-path cli.train fit)")},
        "fused_segment_backward": {
            "bf16": dict(timings["backward b=138 bt=69"],
                         launches=seg.get("fused_segment_backward_bf16", 0),
                         max_abs_err=max(errs[("bwd", 69)], errs[("bwd", 138)]),
                         shape="b=138, bt=69, both segments of one train step (launches: the "
                               "segment-path cli.train fit)")},
    }


def _redesign_phases(phase, agree, programs, nf):
    """Phases 31-33 (see the module docstring): the sampler with the whole
    batch as one BN group, the train template's probe attribution, and the
    redesigned step and segment backward against the parent's template.
    Returns the probe sites' entries for the kernels line and the design
    times by kernel."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.ops import fused_train as ft
    from noise_flow_tpu_torch.probes import train_template as tt

    out = {"probes": {}, "designs": {}, "frame": {}}
    prog = programs["batch"]

    def whole_batch():
        """The kernel at bt = b against its plain version, timed beside the
        bn_block groups of JAX's Pallas branch; and the wrapper's own call
        launches with bt = b: on one generator state it equals fused_sample
        with bt = b bit for bit, and not with bn_block groups."""
        for b in (2961, 4096):
            x, clean, sa, sb = _inputs(prog, b, seed=b + 1)
            k = fs.fused_sample_chain(prog, x, clean, sa, sb, b)
            p = fs.sample_chain_reference(prog, x, clean, sa, sb, b)
            ok, err = agree(f"bn=batch b={b} bt={b} (whole batch)", k, p)
            if not ok:
                raise AssertionError(f"kernel disagrees with plain at b={b}, bt={b}")
            t = tt.alternated_ms({bt: lambda bt=bt: fs.fused_sample_chain(prog, x, clean, sa, sb,
                                                                          bt)
                                  for bt in (b, fs.bn_block(b))}, FRAME_ROUNDS, 5)
            flops, nbytes = _work(prog, b)
            out["frame"][b] = {"ms": t[b], "ms_bn_block": t[fs.bn_block(b)], "max_abs_err": err,
                               "bound_ms": max(flops / PEAK_FP32_FLOPS,
                                               nbytes / PEAK_HBM_BYTES) * 1e3}
            print(f"time bn=batch b={b}: kernel at bt={b} {t[b]:.4f} ms, at "
                  f"bt={fs.bn_block(b)} {t[fs.bn_block(b)]:.4f} ms (medians of {FRAME_ROUNDS}, "
                  f"in turns; {t[b] / t[fs.bn_block(b)] - 1:+.1%})")
        b = 300
        clean = np.random.default_rng(3).uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
        cond = {"clean": torch.as_tensor(clean, device="cuda"),
                "iso": torch.full((b,), 800.0, device="cuda"),
                "cam": torch.full((b,), 2.0, device="cuda"),
                "nlf0": torch.zeros(b, device="cuda"), "nlf1": torch.zeros(b, device="cuda")}
        state = nf._gen.get_state()
        got = nf.sample_noise_nf(clean, 0.0, 0.0, 800.0, 2.0)
        same = {}
        for bt in (b, fs.bn_block(b)):
            nf._gen.set_state(state)
            ref = fs.fused_sample(prog, cond, temp=nf.temp, generator=nf._gen, bt=bt)
            same[bt] = bool(np.array_equal(got, ref.cpu().numpy()))
        print(f"wrapper b={b}: equals fused_sample bt={b} {same[b]}, bt={fs.bn_block(b)} "
              f"{same[fs.bn_block(b)]}")
        if not same[b] or same[fs.bn_block(b)]:
            raise AssertionError("the wrapper's batch-BN call does not take the whole batch")
    phase("sampler with the whole batch as one BN group (bt = b)", whole_batch)

    def attribution():
        """Every probe timed; every variant that has a plain version held to
        it (_probe_check), and a planted fault of the bn chain and of the
        weight gradient caught; the probe library's full variants in the
        production design bit-equal to the production kernels."""
        res = tt.attribution(iters=10, check=_probe_check)
        bad = [f"{site}: {key}" for site, e in res.items()
               for key, row in e["variants"].items() if row.get("agrees") is False]
        held = sum(1 for e in res.values() for row in e["variants"].values() if "agrees" in row)
        print(f"probe variants held to their plain versions: {held}, disagreeing: {bad}")
        if bad or not held:
            raise AssertionError(f"probe variants disagree with their plain versions: {bad}")
        inp = tt.flagship_inputs()
        zin, gz, gldj = inp["z"], inp["gz"], inp["gldj"]
        faults = {
            "bn chain in groups of 23, plain in 69": _probe_check(
                "bn_chain", "float32", tt.bn_chain("production", zin, 23),
                tt.bn_chain_reference(zin, 69)),
            "mma weight gradient with a and g swapped": _probe_check(
                "wgrad", "bfloat16", tt.wgrad("mma", 9, gz, zin), tt.wgrad_reference(9, zin, gz)),
        }
        print(f"probe planted faults (each must disagree): {faults}")
        if any(faults.values()):
            raise AssertionError(f"a probe check missed a planted fault: {faults}")
        args = inp["step"]
        for dt in ("float32", "bfloat16"):
            a = ft.fused_train_step(*args, 69, mm_dtype=dt)
            b = tt.train_step(tt.PROD, *args, 69, dt)
            same = all(torch.equal(a[k], b[k]) for k in a)
            for sg in inp["segments"]:
                same = same and all(torch.equal(u, v) for u, v in zip(
                    ft.fused_segment_train_forward(zin, *sg, 69, dt),
                    tt.segment_train_forward(tt.PROD, "full", zin, *sg, 69, dt)))
                same = same and all(torch.equal(u, v) for u, v in zip(
                    ft.fused_segment_backward(zin, *sg, 69, gz, gldj, dt),
                    tt.segment_backward(tt.PROD, "full", zin, *sg, 69, gz, gldj, dt)))
            if not same:
                raise AssertionError(f"a probe full variant ({dt}) is not the production kernel")
        print("probe full variants: bit-equal to the production step, ghost forward and "
              "backward kernels in both precisions")
        out["probes"] = res
    phase("train template probe attribution (parent design and redesign)", attribution)

    def designs():
        """Each kernel, precision and bt: the parent's template (probe
        library) and the redesign (the production wrapper) in turns
        (parent, redesign, redesign, parent), medians; bound and plain."""
        inp = tt.flagship_inputs()
        sa, rec, offs, mixes = inp["step"][2], *inp["step"][4:7]
        segs, zin, gz, gldj = inp["segments"], inp["z"], inp["gz"], inp["gldj"]
        for dt in ("float32", "bfloat16"):
            peak = PEAK_BF16_FLOPS if dt == "bfloat16" else PEAK_FP32_FLOPS
            for bt in TRAIN_BTS:
                runs = {
                    "step": (lambda: tt.train_step(tt.PARENT, *inp["step"], bt, dt),
                             lambda: ft.fused_train_step(*inp["step"], bt, mm_dtype=dt),
                             lambda: ft.train_step_reference(*inp["step"], bt, mm_dtype=dt),
                             _train_work((rec, offs, mixes, sa), b_, "step")),
                    "segment_backward": (
                        lambda: [tt.segment_backward(tt.PARENT, "full", zin, *sg, bt, gz, gldj, dt)
                                 for sg in segs],
                        lambda: [ft.fused_segment_backward(zin, *sg, bt, gz, gldj, dt)
                                 for sg in segs],
                        lambda: [ft.segment_backward_reference(zin, *sg, bt, gz, gldj, dt)
                                 for sg in segs],
                        tuple(map(sum, zip(*(_train_work(sg, b_, "backward") for sg in segs))))),
                    # not one of the two redesigned kernels: it shares the template's
                    # design, and this row shows what that costs it
                    "ghost_forward": (
                        lambda: [tt.segment_train_forward(tt.PARENT, "full", zin, *sg, bt, dt)
                                 for sg in segs],
                        lambda: [ft.fused_segment_train_forward(zin, *sg, bt, dt) for sg in segs],
                        lambda: [ft.segment_train_forward_reference(zin, *sg, bt, dt)
                                 for sg in segs],
                        tuple(map(sum, zip(*(_train_work(sg, b_, "ghost") for sg in segs)))))}
                for kind, (parent, redesign, plain, (flops, nbytes)) in runs.items():
                    ms = {"parent": [], "redesign": []}
                    for who in ("parent", "redesign", "redesign", "parent"):
                        ms[who].append(tt.time_ms(parent if who == "parent" else redesign, 20))
                    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
                    row = {"ms": float(np.median(ms["redesign"])),
                           "parent_ms": float(np.median(ms["parent"])),
                           "plain_ms": _time_ms(plain, 3), "bound_ms": max(t_ops, t_bytes) * 1e3,
                           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
                    out["designs"][(kind, dt, bt)] = row
                    print(f"time {kind} {dt} b={b_} bt={bt}: redesign {row['ms']:.4f} ms, parent "
                          f"{row['parent_ms']:.4f} ms ({row['parent_ms'] / row['ms']:.2f}x), plain "
                          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.5f} ms "
                          f"({row['bound_by']})")
    b_ = TRAIN_B
    phase("step and segment backward: redesign against the parent's template", designs)
    return out


def _production_times(programs, flow):
    """Device times (``train_template.time_ms``, medians of ``sampler.ROUNDS``
    rounds in turns) of the production rows the rank reads: the sampler's
    eps mode at b = bt = 138 (a request) and at b = bt = FRAME_B (the frame),
    its RNG mode at b = bt = 128 (the DnCNN_NF step) and at b = 8192 running
    BN (make_sampler), the running-BN eval forward of both flagship segments
    at b = 138; float32 and bfloat16 (the frame float32 only, as the
    wrapper samples). Each row: ms a call, launches a call, bound, plain
    ms."""
    import torch
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.ops import fused_train as ft
    from noise_flow_tpu_torch.probes import sampler as sp
    from noise_flow_tpu_torch.probes import train_template as tt

    w_in, r_in = sp.shape_inputs(programs, "W"), sp.shape_inputs(programs, "R")
    d_in = dict(w_in, seed=sp.SEED, b=128, bt=128, x=None)    # RNG mode, batch BN
    for key in ("clean", "sa", "sb"):
        d_in[key] = d_in[key][:128].contiguous()
    x, clean, sa, sb = _inputs(programs["batch"], FRAME_B, seed=FRAME_B + 7)
    f_in = {"program": programs["batch"], "b": FRAME_B, "bt": FRAME_B, "x": x, "clean": clean,
            "sa": sa, "sb": sb, "seed": None}
    ff = ft.FusedFlow(flow, bt=sp.W_B)
    with torch.no_grad():
        segs = [(*ff.fold_segment(lo, hi, fold_bn=False)[:3], ft._ops_code(seg.ops),
                 ff.running_moments(lo, hi)) for _, seg, lo, hi in
                (it for it in ff.plan if it[0] == "segment")]
    z = torch.randn((sp.W_B, 32, 32, 4), generator=torch.Generator(device="cuda").manual_seed(12),
                    device="cuda")
    eval_work = tuple(map(sum, zip(*(_train_work(sg[:3], sp.W_B, "forward") for sg in segs))))
    plans = {}
    for dt in sp.DTYPES:
        suffix = "" if dt == "float32" else "_bf16"
        runs = (("eps", w_in), ("eps_frame", f_in), ("rng", d_in), ("rng_8192", r_in))
        for mode, inp in runs:
            if mode == "eps_frame" and dt != "float32":
                continue
            plans[mode + suffix] = (functools.partial(sp.run_production, inp, dt),
                                    functools.partial(sp.run_variant, inp, "full", dt, False),
                                    _work(inp["program"], inp["b"], inp["seed"] is not None),
                                    dt, f"b={inp['b']}, bt={inp['bt']}, "
                                    f"{inp['program'].bn_mode} BN, "
                                    f"{'rng' if inp['seed'] is not None else 'eps'}")
        plans["eval" + suffix] = (
            lambda dt=dt: [ft.fused_segment_forward(z, *sg[:4], dt, sg[4]) for sg in segs],
            lambda dt=dt: [ft.segment_forward_reference(z, *sg[:4], dt, sg[4]) for sg in segs],
            eval_work, dt, "b=138, running BN, both segments")
    ms = tt.alternated_ms({k: v[0] for k, v in plans.items()}, sp.ROUNDS, 10)
    out = {}
    for key, (fn, plain, (fl, nb), dt, shape) in plans.items():
        counter = "fused_segment_forward" if key.startswith("eval") else "fused_sample"
        before = fs.launch_counts[counter]
        fn()
        launches = fs.launch_counts[counter] - before
        bound = tt._bound(fl, nb, fs.is_bf16(dt))
        out[key] = {"ms": ms[key], "launches_a_call": launches, "bound_ms": bound[0],
                    "bound_by": bound[1], "plain_ms": tt.time_ms(plain, 2), "shape": shape}
        print(f"time {key} ({shape}): {ms[key]:.4f} ms a call ({launches} launches), bound "
              f"{bound[0]:.4f} ms ({bound[1]}), plain {out[key]['plain_ms']:.4f} ms")
    return out


def _sampler_phases(phase, programs, flow):
    """Phases 35-36 (see the module docstring): the sampler group's probe
    attribution and the production sampler's and eval forward's device
    times, then the planted faults. Returns the probe sites' entries for
    the kernels line and the production rows."""
    import torch
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.probes import sampler as sp

    out = {"probes": {}, "production": {}}

    def attribution():
        """Every variant timed and held to its plain version
        (_sampler_check); the variants of FULL's arithmetic bit-equal to it;
        FULL (the parent's design) bit-equal to the production kernel in
        running BN and held to it at the sampler's tolerance in batch BN
        (production merges its moments in another order), in both
        precisions and both input modes; 40 launches a (W) call in the
        parent's design, 1 for nocoupnn."""
        res = sp.attribution(check=_sampler_check)
        rows = {f"{site}: {k}": r for site, e in res.items() for k, r in e["variants"].items()}
        bad = [k for k, r in rows.items()
               if r.get("agrees") is False or r.get("bit_equal") is False
               or r.get("bit_equal_to_production") is False
               or r.get("bit_equal_to_parent") is False]
        held = sum(1 for r in rows.values() if "agrees" in r)
        calls = {k: r["launches_a_call"] for k, r in rows.items() if "launches_a_call" in r}
        wrong = [k for k, n in calls.items()
                 if n != (1 if k.endswith(",R") or "nocoupnn" in k
                          else PARENT_BATCH_BN_LAUNCHES)]
        print(f"sampler probe variants held to their plain versions: {held}; bit-equal checks: "
              f"{sum(1 for r in rows.values() if 'bit_equal' in r)}; disagreeing: {bad}; "
              f"launches a call wrong: {wrong}")
        if bad or not held or wrong:
            raise AssertionError(f"sampler probe variants disagree: {bad}, launches {wrong}")
        for mode, rng in (("running", False), ("batch", True)):   # the other two input modes
            inp = dict(sp.shape_inputs(programs, "W"), program=programs[mode])
            if rng:
                inp.update(seed=sp.SEED, x=None)
            for dt in sp.DTYPES:
                full, prod = sp.run_variant(inp, "full", dt), sp.run_production(inp, dt)
                same = (torch.equal(full, prod) if mode == "running"
                        else _sampler_check("sample", dt, prod, full))
                if not same:
                    raise AssertionError(f"probe full is not production ({mode}, rng={rng}, {dt}): "
                                         f"normwise {_norm_rel(prod, full):.3e}")
        print("sampler probe full (the parent's design): bit-equal to the production kernel in "
              "running BN and within the sampler's tolerance of it in batch BN, in both "
              "precisions and both input modes")
        # the redesigned bfloat16 chain runs on wgmma fed by bulk copies
        sass = {k: v for k, v in sp.sass_counts().items() if "mm_chain" in k or "precast" in k}
        for kernel, ops in sass.items():
            print(f"sass[sample_probe] {kernel}: {ops}")
        bf = [v for k, v in sass.items() if "mm_chain_bf16E" in k]
        if len(bf) != 1 or not bf[0].get("HGMMA") or not bf[0].get("UBLKCP"):
            raise AssertionError(f"the bfloat16 chain redesign lacks HGMMA or UBLKCP: {bf}")
        res["probe_mm_chain"]["sass"] = sass
        out["probes"] = res
        out["production"] = _production_times(programs, flow)
    phase("sampler probe attribution", attribution)

    def planted_faults():
        """Faults of each kind the comparisons of phase 35 must catch: a
        wrong polynomial in notrans (tanh u -> u), an interleaved stream
        reading the other patch's clean, a precast record rounded toward
        zero, one chain product skipped and one weight replaced by the one
        before it (a stale slot of the redesign's ring), each run through
        both chain designs, and a bfloat16 chain whose intermediates are not
        rounded again, against the plain chain and against each bfloat16
        kernel (the chains at their timed shape)."""
        inp = sp.shape_inputs(programs, "W")
        prog, x, clean, sa, sb, b = (inp[k] for k in ("program", "x", "clean", "sa", "sb", "b"))
        caught = {}
        xc, wc = sp.chain_inputs(torch.Generator(device="cuda").manual_seed(3))
        for dt in sp.DTYPES:
            k = sp.sample_variant(prog, "notrans", x, clean, sa, sb, b, dt)
            p = sp.ablated_chain_reference(prog, x, clean, sa, sb, b, dt, "notrans", slope=1.0)
            caught[f"notrans tanh u -> u ({dt})"] = not _sampler_check("sample_notrans", dt, k, p)
            swapped = clean.view(b // 2, 2, *clean.shape[1:]).flip(1).reshape(clean.shape)
            k = sp.sample_variant(prog, "interleave", x, swapped.contiguous(), sa, sb, b, dt)
            p = sp.variant_reference(prog, "interleave", x, clean, sa, sb, b, dt)
            caught[f"interleave reads the other patch's clean ({dt})"] = not _sampler_check(
                "sample", dt, k, p)
            ref = sp.mm_chain_reference(xc, wc, dt)
            stale = wc.clone()
            stale[STALE_PRODUCT] = wc[STALE_PRODUCT - 1]
            for design in sp.CHAIN_DESIGNS:
                for fault, w_in in (("a product skipped", wc[1:].contiguous()),
                                    (f"w[{STALE_PRODUCT}] replaced by w[{STALE_PRODUCT - 1}] "
                                     "(a stale ring slot)", stale)):
                    got = sp.mm_chain(xc, w_in, dt, design)
                    caught[f"{design} chain with {fault} ({dt})"] = not _sampler_check(
                        "mm_chain", dt, got, ref)
                    print(f"{design} chain with {fault} ({dt}): normwise "
                          f"{_norm_rel(got, ref):.3e}")
        for n in (sp.N_MM, sp.CHAIN_PREFIX):   # the full chain's reading, for the record
            got = sp.chain_without_rerounding(xc, wc[:n])
            ref = sp.mm_chain_reference(xc, wc[:n], "bfloat16")
            print(f"bfloat16 chain without re-rounding, {n} products: normwise "
                  f"{_norm_rel(got, ref):.3e}")
        caught["chain without re-rounding (bfloat16)"] = not _sampler_check(
            "mm_chain_prefix", "bfloat16", got, ref)
        # and the other way round: each bfloat16 kernel held to the chain
        # without re-rounding as if that were its plain version must fail,
        # so the kernels do round every product's input
        for design in sp.CHAIN_DESIGNS:
            kern = sp.mm_chain(xc, wc[:sp.CHAIN_PREFIX].contiguous(), "bfloat16", design)
            caught[f"{design} bfloat16 chain held to one without re-rounding"] = (
                not _sampler_check("mm_chain_prefix", "bfloat16", kern, got))
            print(f"{design} bfloat16 chain against the chain without re-rounding, "
                  f"{sp.CHAIN_PREFIX} products: normwise {_norm_rel(kern, got):.3e}")
        trunc = copy.copy(prog)
        coup = prog.coup.clone()
        weights = torch.zeros(fs.REC, dtype=torch.bool, device="cuda")
        for name in ("w1", "w2", "w3"):
            off, shape = fs._REC_LAYOUT[name]
            weights[off:off + math.prod(shape)] = True
        toward_zero = (coup.view(torch.int32) & -65536).view(torch.float32)
        trunc.coup = torch.where(weights, toward_zero, coup).contiguous()
        k = sp.sample_variant(trunc, "precast", x, clean, sa, sb, b, "bfloat16")
        full = sp.sample_variant(prog, "full", x, clean, sa, sb, b, "bfloat16")
        caught["precast record rounded toward zero (bfloat16)"] = not torch.equal(k, full)
        print(f"sampler probe planted faults (each must be caught): {caught}")
        if not all(caught.values()):
            raise AssertionError(f"a sampler probe comparison missed a planted fault: {caught}")
    phase("sampler probe planted faults", planted_faults)
    return out


# Phase 37: the sampler's redesign (one cooperative launch a batch-BN call,
# merged moments, bf16 weights rounded once) against the parent's design
# (the probe library's stage-by-stage launch_chain), in turns, at the main
# paths' shapes. What it must show: faster at a request (b = 138, eps) and
# at the DnCNN_NF step's call (b = 128, RNG) in both precisions; the frame
# (b = bt = FRAME_B, float32) no slower than the parent by more than
# REDESIGN_FRAME_SLACK; make_sampler's bf16 call (b = 8192, running BN) at
# most REDESIGN_R_RATIO of the parent's time.
REDESIGN_FRAME_SLACK = 1.03
REDESIGN_R_RATIO = 0.75
REDESIGN_ROUNDS = 5


def _coop_registers():
    """ptxas's registers and spills of the production coop_kernel<BF,
    RESIDENT>, by (precision, resident or walk)."""
    import re
    from noise_flow_tpu_torch.ops import _build
    out = {}
    for k in _build.kernel_resources("fused_sample"):
        m = re.search(r"coop_kernelILb(\d)ELb(\d)E", k["kernel"])
        if m:
            key = (f"{'bfloat16' if m.group(1) == '1' else 'float32'}, "
                   f"{'resident' if m.group(2) == '1' else 'walk'}")
            out[key] = {"registers": k.get("registers"), "spill_stores": k["spill_stores"]}
    return out


def _coop_phases(phase, programs):
    """Phase 37 (see the module docstring): the sampler's redesign against
    the parent's design in turns. Returns the rows for the kernels line's
    sampler entry (``redesign``) and the production design by precision and
    BN mode (``design``)."""
    import torch
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.probes import sampler as sp
    from noise_flow_tpu_torch.probes import train_template as tt

    out = {"rows": {}, "design": {}}

    def redesign():
        regs = _coop_registers()
        for key, r in regs.items():
            print(f"ptxas coop_kernel [{key}]: {r['registers']} registers, spill "
                  f"{r['spill_stores']} B")
        w_in, r_in = sp.shape_inputs(programs, "W"), sp.shape_inputs(programs, "R")
        d_in = dict(w_in, seed=sp.SEED, b=128, bt=128, x=None)    # the DnCNN_NF step's call
        for key in ("clean", "sa", "sb"):
            d_in[key] = d_in[key][:128].contiguous()
        x, clean, sa, sb = _inputs(programs["batch"], FRAME_B, seed=FRAME_B + 7)
        f_in = {"program": programs["batch"], "b": FRAME_B, "bt": FRAME_B, "x": x,
                "clean": clean, "sa": sa, "sb": sb, "seed": None}
        shapes = [("request", w_in, dt) for dt in sp.DTYPES] + \
                 [("dncnn", d_in, dt) for dt in sp.DTYPES] + \
                 [("frame", f_in, "float32"), ("make_sampler", r_in, "bfloat16")]
        for name, inp, dt in shapes:
            batch = inp["program"].bn_mode == "batch"
            fns = {"parent": functools.partial(sp.run_variant, inp, "full", dt),
                   "redesign": functools.partial(sp.run_production, inp, dt)}
            ms = tt.alternated_ms(fns, REDESIGN_ROUNDS, 10 if inp["b"] <= 138 else 3)
            before = fs.launch_counts["fused_sample"]
            got = sp.run_production(inp, dt)
            launches = fs.launch_counts["fused_sample"] - before
            parent = sp.run_variant(inp, "full", dt)
            plain = sp.run_variant(inp, "full", dt, kernel=False)
            torch.cuda.synchronize()
            check = _sampler_check("sample", dt, got, plain)
            row = {"shape": f"b={inp['b']}, bt={inp['bt']}, {inp['program'].bn_mode} BN, "
                            f"{'rng' if inp['seed'] is not None else 'eps'}, {dt}",
                   "ms": ms["redesign"], "parent_ms": ms["parent"],
                   "parent_over_redesign": ms["parent"] / ms["redesign"],
                   "launches_a_call": launches, "agrees_with_plain": check,
                   "max_abs_vs_plain": float((got - plain).abs().max()),
                   "bits_equal_to_parent": bool(torch.equal(got, parent)),
                   "normwise_vs_parent": _norm_rel(got, parent)}
            if batch:
                row["plan"] = fs.sample_plan(inp["b"], dt)
                row["patches_a_cta"] = -(-inp["b"] // row["plan"]["grid"])
            out["rows"][f"{name},{dt}"] = row
            print(f"redesign {name} [{row['shape']}]: redesign {row['ms']:.4f} ms "
                  f"({launches} launch), parent {row['parent_ms']:.4f} ms: "
                  f"{row['parent_over_redesign']:.3f}x; plan {row.get('plan')}, up to "
                  f"{row.get('patches_a_cta')} patches a CTA; vs plain "
                  f"{'agrees' if check else 'DISAGREES'} (max abs {row['max_abs_vs_plain']:.3e}); "
                  f"bits as parent {row['bits_equal_to_parent']} (normwise "
                  f"{row['normwise_vs_parent']:.3e})")
            if not check or launches != 1:
                raise AssertionError(f"the redesign at {name} {dt}: plain {check}, {launches} "
                                     "launches")
            if not batch and not row["bits_equal_to_parent"]:
                raise AssertionError(f"{name} {dt}: running BN is not the parent's bits")
        rows = out["rows"]
        fast = {k: r["parent_over_redesign"] for k, r in rows.items()
                if k.split(",")[0] in ("request", "dncnn")}
        frame = rows["frame,float32"]["ms"] / rows["frame,float32"]["parent_ms"]
        r_ratio = rows["make_sampler,bfloat16"]["ms"] / rows["make_sampler,bfloat16"]["parent_ms"]
        plan = rows["request,float32"]["plan"]
        print(f"redesign against the parent: parent/redesign at b = 138 and 128 {fast} (each "
              f"> 1); the frame {frame:.3f} of the parent (<= {REDESIGN_FRAME_SLACK}); "
              f"make_sampler bf16 {r_ratio:.3f} of the parent (<= {REDESIGN_R_RATIO}); the rule: "
              f"batch BN resident (one CTA a patch) where b <= {plan['per_sm']} CTAs an SM x "
              f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, else walk")
        if min(fast.values()) <= 1 or frame > REDESIGN_FRAME_SLACK or r_ratio > REDESIGN_R_RATIO:
            raise AssertionError("the redesign is not faster than the parent where it must be")
        out["design"] = {
            dt: {"running": "sample_kernel, one launch" + (
                     ", weights rounded once (DESIGN_PRECAST)" if dt == "bfloat16" else ""),
                 "batch": f"coop_kernel, {fs.H * fs.W // 4} threads: "
                          "one cooperative launch, merged moments (one grid barrier a BN), "
                          f"resident where b <= {plan['per_sm']} CTAs an SM x SMs, else walk"
                          + (", weights rounded once" if dt == "bfloat16" else ""),
                 "registers": {k: v for k, v in regs.items()
                               if k.startswith(dt)}}
            for dt in sp.DTYPES}
    phase("sampler redesign against the parent's design", redesign)
    return out


# Phase 38: the running-BN eval forward's redesign (each coupling's record
# staged in shared memory once, bf16 weights rounded once, two barriers a
# coupling, two CTAs an SM) against the parent's design (the probe library's
# segment_kernel_parent), in turns, as device times of one eval call (both
# flagship segments). What it must show: z and ldj the parent's bits, one
# launch a segment, faster than the parent at b = 138 in bf16, and no slower
# than the parent by more than EVAL_REDESIGN_SLACK at any timed batch.
EVAL_REDESIGN_BATCHES = (1, 138, 4096)
EVAL_REDESIGN_SLACK = 1.03


def _eval_check(dt: str, got, ref) -> bool:
    """An eval call's (z, ldj) against its plain version's: float32 z
    elementwise within SEG_TOL and ldj within LDJ_RTOL; bf16 both normwise
    within BF16_Z_RTOL and BF16_LDJ_RTOL."""
    import torch
    (zk, lk), (zp, lp) = got, ref
    if not bool(torch.isfinite(zk).all()) or not bool(torch.isfinite(lk).all()):
        return False
    if dt == "float32":
        atol, rtol = SEG_TOL
        return (bool(((zk - zp).abs() <= atol + rtol * zp.abs()).all())
                and float(((lk - lp).abs() / lp.abs().clamp_min(1.0)).max()) <= LDJ_RTOL)
    return _norm_rel(zk, zp) <= BF16_Z_RTOL and _norm_rel(lk, lp) <= BF16_LDJ_RTOL


def _segment_registers():
    """ptxas's registers and spills of the production eval kernel
    (segment_kernel<BF, E_PROD> in fused_train) and of the parent's
    (segment_kernel_parent<BF> in segment_probe), by "design, precision"."""
    import re
    from noise_flow_tpu_torch.ops import _build
    out = {}
    for lib, pattern, design in (("fused_train", r"\d+segment_kernelILb(\d)ELi0E", "redesign"),
                                 ("segment_probe", r"segment_kernel_parentILb(\d)E", "parent")):
        for k in _build.kernel_resources(lib):
            m = re.search(pattern, k["kernel"])
            if m:
                out[f"{design}, {'bfloat16' if m.group(1) == '1' else 'float32'}"] = {
                    "registers": k.get("registers"), "spill_stores": k["spill_stores"],
                    "spill_loads": k["spill_loads"]}
    return out


def _eval_phases(phase):
    """Phase 38 (see the module docstring): the eval forward's redesign
    against the parent's design in turns, then its planted faults. Returns
    the rows for the kernels line's running modes (``redesign``), by
    precision."""
    import torch
    from noise_flow_tpu_torch.ops import fused_train as ft
    from noise_flow_tpu_torch.probes import train_template as tt

    out = {dt: {} for dt in tt.DTYPES}

    def redesign():
        regs = _segment_registers()
        for key, r in regs.items():
            print(f"ptxas segment kernel [{key}]: {r['registers']} registers, spill "
                  f"{r['spill_stores']} B stores / {r['spill_loads']} B loads")
        if len(regs) != 4:
            raise AssertionError(f"ptxas reported {sorted(regs)}, not both designs' two kernels")
        rows = tt.eval_times(EVAL_REDESIGN_BATCHES, REDESIGN_ROUNDS, check=_eval_check)
        bad = []
        for key, row in rows.items():
            dt, b = key.split(",b=")
            row["registers"] = {d: regs[f"{d}, {dt}"] for d in (tt.PARENT, tt.PROD)}
            out[dt][f"b={b}"] = row
            if not (row["agrees_with_plain"] and row["launches_a_call"] == row["segments"]
                    and row["z_bits_as_parent"] and row["ldj_bits_as_parent"]
                    and row["ms"] <= EVAL_REDESIGN_SLACK * row["parent_ms"]):
                bad.append(key)
        fast = rows["bfloat16,b=138"]["parent_over_redesign"]
        sms = rows["float32,b=138"]["sms"]
        print(f"eval redesign against the parent: parent/redesign "
              + ", ".join(f"{k} {r['parent_over_redesign']:.3f}x" for k, r in rows.items())
              + f"; the rule: one CTA a patch, one wave where b <= CTAs an SM x {sms} SMs "
              f"(redesign {[rows[f'{dt},b=138']['per_sm'][tt.PROD] for dt in tt.DTYPES]}, parent "
              f"{[rows[f'{dt},b=138']['per_sm'][tt.PARENT] for dt in tt.DTYPES]} CTAs an SM, "
              "float32 and bf16)")
        if bad or fast <= 1:
            raise AssertionError(f"the eval redesign fails at {bad} (plain, launches, bits or "
                                 f"> {EVAL_REDESIGN_SLACK} of the parent), or bf16 at b = 138 "
                                 f"is not faster ({fast:.3f}x)")
    phase("eval forward redesign against the parent's design", redesign)

    def planted_faults():
        """Each must fail _eval_check against the plain version: the
        barrier before conv3 left out (a race; at b = 138 and 4096, caught
        if either disagrees), the running variances staged in place of
        1/sqrt(var + eps) (bf16, which applies them), and a bf16 record
        whose weights are rounded toward zero (staged through production)."""
        flow = tt.flagship_flow()
        caught = {}
        for name, dt, batches in (("nosync", "float32", (138, 4096)),
                                  ("moments", "bfloat16", (138,))):
            segs = tt.eval_segments(flow, dt)
            seen = []
            for b in batches:
                z = torch.randn((b, 32, 32, 4), device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(b + 1))
                got = tt.eval_chain(segs, functools.partial(tt.segment_forward_fault, name), z, dt)
                ref = tt.eval_chain(segs, ft.segment_forward_reference, z, dt)
                torch.cuda.synchronize()
                seen.append(not _eval_check(dt, got, ref))
                print(f"planted eval fault {name} ({dt}, b={b}): z normwise "
                      f"{_norm_rel(got[0], ref[0]):.3e}, max abs "
                      f"{float((got[0] - ref[0]).abs().max()):.3e} -> "
                      f"{'DISAGREES' if seen[-1] else 'agrees'}")
            caught[f"{name} ({dt})"] = any(seen)
        segs = tt.eval_segments(flow, "bfloat16")
        weights = torch.zeros(ft.REC, dtype=torch.bool, device="cuda")
        for field in ("w1", "w2", "w3"):
            off, shape = ft._REC_LAYOUT[field]
            weights[off:off + math.prod(shape)] = True
        trunc = [(torch.where(weights, (sg[0].view(torch.int32) & -65536).view(torch.float32),
                              sg[0]).contiguous(), *sg[1:]) for sg in segs]
        z = torch.randn((138, 32, 32, 4), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(139))
        got = tt.eval_chain(trunc, ft.fused_segment_forward, z, "bfloat16")
        ref = tt.eval_chain(segs, ft.segment_forward_reference, z, "bfloat16")
        caught["record rounded toward zero (bfloat16)"] = not _eval_check("bfloat16", got, ref)
        print(f"planted eval fault record rounded toward zero (bfloat16, b=138): z normwise "
              f"{_norm_rel(got[0], ref[0]):.3e} -> "
              f"{'DISAGREES' if caught['record rounded toward zero (bfloat16)'] else 'agrees'}")
        print(f"eval forward planted faults (each must be caught): {caught}")
        if not all(caught.values()):
            raise AssertionError(f"the eval comparison missed a planted fault: {caught}")
    phase("eval forward planted faults", planted_faults)
    return out


# phases 39-41: the flagship run's path at a cut of scale. The SIDD-scale
# generator's first 2 train and 1 test scenes (their ids and round-robin
# cells) at a Bayer frame of 1024x2048 instead of 3000x5328
FLAGSHIP_BAYER = (1024, 2048)
FLAGSHIP_EPOCHS = 2
SWEEP_SMOKE = ["--temps", "0.6,1.0", "--n_patches_per_image", "512"]
GRID_B = 1024        # ref_parity's CLI batch: one walk-mode launch a call
GRID_EVERY = 3       # the grid's depth, cut for time: every third cell of cam_iso_nlf.txt


def _numpy_kld_g_nlf(mb, sc_sd: float, step: int = 5):
    """KLD_G and KLD_NLF of one sweep batch recomputed in numpy from the
    reference's definition (ref:sidd_utils.py:995-1058): every step-th
    patch unpacked to Bayer, Gaussian then NLF draws from default_rng(0),
    density histograms over the reference's bins, forward KLD of the real
    noise's histogram against each over the bins where both are positive."""
    import numpy as np
    edges = np.concatenate(([-1000.0], np.arange(-0.1, 0.1 + 1e-9, 0.2 / 64), [1000.0]))

    def bayer(p):
        h, w, _ = p.shape
        out = np.zeros((2 * h, 2 * w), np.float32)
        out[0::2, 0::2], out[0::2, 1::2] = p[..., 0], p[..., 1]
        out[1::2, 1::2], out[1::2, 0::2] = p[..., 2], p[..., 3]
        return out

    def hist(v):
        return np.histogram(v, edges)[0] / v.size

    def kl(p, q):
        m = (p > 0) & (q > 0)
        return float(np.sum(p[m] * np.log(p[m] / q[m])))
    rng = np.random.default_rng(0)
    rows = []
    for i in range(0, len(mb["_x"]), step):
        y = bayer(mb["_y"][i])
        sd = np.sqrt(float(mb["nlf0"][i]) * y + float(mb["nlf1"][i]))
        ng = rng.normal(0, sc_sd, y.shape)
        nl = sd * rng.normal(0, 1, y.shape)
        hn = hist(bayer(mb["_x"][i]))
        rows.append((kl(hn, hist(ng)), kl(hn, hist(nl))))
    return np.mean(rows, axis=0)


def _flagship_phases(phase, agree, nf, frame):
    """Phases 39-41 (see the module docstring): the flagship data path and
    the exact-BN train step, the KLD sweep and the parity grid through the
    fused sampler, and the frame-size sampler. Returns the main paths'
    sampler launches, the kernel's distances to its plain version and the
    times, for the kernels line."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.analysis import ref_parity
    from noise_flow_tpu_torch.cli import flagship, kld_sweep, make_sidd_scale
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.cli.args import parse_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.training.trainer import Trainer

    work = os.path.join(ROOT, "build", "flagship_smoke")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "SIDD_Medium_Raw", "Data")
    out = {"launches": {}, "max_abs_err": {}}

    def data_path():
        version = make_sidd_scale.available_mat_version()
        h, w = FLAGSHIP_BAYER
        t0 = time.time()
        make_sidd_scale.main(["--root", root, "--n_train", "2", "--n_test", "1", "--height",
                              str(h), "--width", str(w), "--mat_version", version])
        t_gen = time.time() - t0
        argv = flagship.PROD_EXACT + [
            "--epochs", str(FLAGSHIP_EPOCHS), "--sidd_path", root, "--device", "cuda",
            "--cache_dir", os.path.join(work, "cache"), "--native_loader",
            "--logdir", os.path.join(work, "prefix")]
        fs.launch_counts.clear()
        t0 = time.time()
        if cli_train.main(argv) != 0:
            raise AssertionError("cli.train failed")
        t_fit = time.time() - t0
        counts = _main_path(dict(fs.launch_counts))
        logdir = os.path.join(work, "prefix")
        rows = {s: flagship.read_tsv(os.path.join(logdir, f"{s}.txt"))
                for s in ("train", "test", "sample")}
        if [len(rows["train"]), len(rows["test"])] != [FLAGSHIP_EPOCHS] * 2 or not all(
                math.isfinite(float(r[c])) for s in rows.values() for r in s
                for c in ("NLL", "sdz")):
            raise AssertionError(f"bad rows: {rows}")
        hps = dict(ln.rstrip("\n").split(",", 1) for ln in open(os.path.join(logdir, "hps.txt"))
                   if "," in ln)
        if not hps.get("device", "").startswith("cuda") or hps.get("use_pallas") != "False":
            raise AssertionError(f"the fit ran on {hps.get('device')}, use_pallas "
                                 f"{hps.get('use_pallas')}")
        if counts:   # exact BN trains on the plain path, as JAX's flagship
            raise AssertionError(f"the exact-BN fit launched kernels: {counts}")
        # the cache is reused: a second load never decodes a .MAT
        args, cfg = parse_config(argv)
        index = os.path.join(work, "cache", "train", "index.json")
        mtime = os.path.getmtime(index)
        decode = cli_train.load_image_tuple
        cli_train.load_image_tuple = None
        try:
            tr = cli_train.load_split(args, cfg, "train")
        finally:
            cli_train.load_image_tuple = decode
        n_img = (h // 2 // 32) * (w // 2 // 32)
        if len(tr) != 2 * 2 * n_img or os.path.getmtime(index) != mtime:
            raise AssertionError(f"cache reload: {len(tr)} patches, not {4 * n_img}")
        # the exact-BN train step at b = 138 on the card, host clock
        trainer = Trainer(NoiseFlow(cfg.x_shape, cfg, device="cuda", seed=cfg.seed), cfg)
        batch = trainer._put(next(tr.batches(138)))
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        out["step_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        timers = open(os.path.join(logdir, "phase_timers.txt")).read().strip()
        print(f"flagship data path: {version} .MAT, 2 train + 1 test scenes of {h}x{w} Bayer "
              f"(a cut of scale from 3000x5328), written in {t_gen:.1f} s; cli.train prod-exact "
              f"{FLAGSHIP_EPOCHS} epochs in {t_fit:.1f} s ({len(tr)} train patches); rows "
              + "; ".join(f"{s} " + ", ".join(f"{float(r['NLL']):.1f}/{float(r['sdz']):.3f}"
                                            for r in rows[s]) for s in ("train", "test"))
              + f"; {timers}; cache reused; exact-BN train step b=138: "
              f"{out['step_ms']:.3f} ms (host clock, 20 steps)")
    phase("flagship data path: generator, cli.train prod-exact (exact BN), cache", data_path)

    def sweep():
        args = ["--model_dir", MODEL, "--sidd_path", root, "--logdir",
                os.path.join(work, "kld_sweep"), "--device", "cuda"] + SWEEP_SMOKE
        a = kld_sweep.parse_args(args)
        temps = [float(t) for t in a.temps.split(",")]
        ds = kld_sweep.load_patches(a, nf.cfg)
        keys = sorted({(float(c), float(i)) for c, i in zip(ds.cam, ds.iso)})
        sels = {k: kld_sweep.group_batches(ds, *k, a.n_batch, a.max_batches_per_group)
                for k in keys}
        expected = sum(map(len, sels.values())) * len(temps) * BATCH_BN_LAUNCHES
        fs.launch_counts.clear()
        if kld_sweep.main(args) != 0:
            raise AssertionError("cli.kld_sweep failed")
        launches = _main_path(dict(fs.launch_counts)).get("fused_sample", 0)
        out["launches"]["sweep"] = launches
        if launches != expected:
            raise AssertionError(f"the sweep launched the sampler {launches} times, "
                                 f"not {expected} (one a group, temperature and batch)")
        # one sweep call, kernel against plain on a shared eps
        mb = kld_sweep.minibatch(ds, sels[keys[0]][0])
        b = len(mb["_x"])
        eps = torch.randn((b, 32, 32, 4), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(40))
        k = torch.as_tensor(kld_sweep.sample_minibatch(nf._program, mb, temps[0], "cuda",
                                                       eps=eps), device="cuda")
        cond = {c: torch.as_tensor(mb[s], device="cuda") for c, s in (
            ("clean", "_y"), ("nlf0", "nlf0"), ("nlf1", "nlf1"), ("iso", "iso"), ("cam", "cam"))}
        sa, sb = nf._program.scale_ab(cond, b)
        p = fs.sample_chain_reference(nf._program, (eps * temps[0]).contiguous(),
                                      cond["clean"].contiguous(), sa, sb, b)
        ok, out["max_abs_err"]["sweep"] = agree(f"sweep call b={b} bt={b} (resident)", k, p)
        # KLD_G and KLD_NLF against a numpy recomputation, as printed
        sc_sd = float(np.sqrt(ds.x.astype(np.float64).var()))
        rows = flagship.read_tsv(os.path.join(work, "kld_sweep", "kld_vs_temp.txt"))
        bad = []
        for r in rows:
            key = (float(r["cam"]), float(r["iso"]))
            g, nlf = np.mean([_numpy_kld_g_nlf(kld_sweep.minibatch(ds, s), sc_sd)
                              for s in sels[key]], axis=0)
            if (r["KLD_G"], r["KLD_NLF"]) != (f"{g:g}", f"{nlf:g}"):
                bad.append((r, g, nlf))
        print(f"sweep: {len(keys)} (cam, iso) groups x {len(temps)} temperatures, "
              f"{launches} sampler launches ({expected} expected); rows " + "; ".join(
                  f"cam {r['cam']} iso {r['iso']} t {r['temp']}: G {r['KLD_G']} NLF "
                  f"{r['KLD_NLF']} NF {r['KLD_NF']}" for r in rows)
              + f"; KLD_G and KLD_NLF against numpy: {len(rows) - len(bad)}/{len(rows)} equal")
        if not ok or bad or len(rows) != len(keys) * len(temps):
            raise AssertionError(f"sweep: kernel agrees {ok}, rows differing from numpy {bad}")
    phase("kld sweep through the fused sampler", sweep)

    def grid():
        plan = fs.sample_plan(GRID_B)
        with open(os.path.join(ROOT, "cam_iso_nlf.txt")) as f:
            head, *cells = f.read().splitlines()
        table = os.path.join(work, "cam_iso_nlf_cut.txt")
        with open(table, "w") as f:
            f.write("\n".join([head] + cells[::GRID_EVERY]) + "\n")
        fs.launch_counts.clear()
        rows = ref_parity.run_grid(MODEL, out_dir=os.path.join(work, "grid"),
                                   nlf_table_path=table, batch=GRID_B, temp=1.0, device="cuda",
                                   verbose=False)
        launches = _main_path(dict(fs.launch_counts)).get("fused_sample", 0)
        out["launches"]["grid"] = launches
        expected = len(rows) * len(ref_parity.CLEAN_LEVELS) * BATCH_BN_LAUNCHES
        # one cell, kernel against plain on a shared eps
        cam_iso, b1 = rows[0]["cam_iso"], rows[0]["beta1"]
        cam_s, iso_s = cam_iso.split("_")
        full = lambda v: torch.full((GRID_B,), float(v), device="cuda")  # noqa: E731
        cond = {"clean": torch.full((GRID_B, 32, 32, 4), ref_parity.CLEAN_LEVELS[0],
                                    device="cuda"),
                "nlf0": full(b1), "nlf1": full(b1), "iso": full(int(iso_s)),
                "cam": full(ref_parity.CAM_IDS.index(cam_s))}
        eps = torch.randn((GRID_B, 32, 32, 4), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(41))
        k = fs.fused_sample(nf._program, cond, temp=1.0, eps=eps, bt=GRID_B)
        sa, sb = nf._program.scale_ab(cond, GRID_B)
        p = fs.sample_chain_reference(nf._program, eps, cond["clean"], sa, sb, GRID_B)
        ok, out["max_abs_err"]["grid"] = agree(f"grid cell {cam_iso} b={GRID_B} (walk)", k, p)
        ratios = np.asarray([r["std_ratio"] for r in rows])
        klds = np.asarray([r["kld_nf_vs_nlf"] for r in rows])
        print(f"grid: {len(rows)} cells x {len(ref_parity.CLEAN_LEVELS)} levels at b={GRID_B}, "
              f"plan {plan}, {launches} sampler launches ({expected} expected); std_ratio mean "
              f"{ratios.mean():.4f} min {ratios.min():.4f} max {ratios.max():.4f}; KLD vs NLF "
              f"mean {klds.mean():.5f} max {klds.max():.5f}")
        if (not ok or launches != expected or plan["resident"] != 0
                or not np.all(np.isfinite(klds)) or not np.all((ratios > 0.5) & (ratios < 2))):
            raise AssertionError(f"grid: kernel agrees {ok}, {launches} launches, plan {plan}, "
                                 f"ratios {ratios}")
    phase("reference-parity grid through the fused sampler", grid)

    def frame_spatial():
        fs.launch_counts.clear()
        nf.sample_noise_frame_spatial(frame, 0.0, 0.0, 800.0, 2.0)
        t0 = time.perf_counter()
        noise = nf.sample_noise_frame_spatial(frame, 0.0, 0.0, 800.0, 2.0)
        out["frame_spatial_ms"] = (time.perf_counter() - t0) * 1e3
        print(f"sample_noise_frame_spatial {FRAME_HW}: {out['frame_spatial_ms']:.1f} ms "
              f"(host clock, plain flow.sample at frame size), noise sd {noise.std():.5f}")
        if noise.shape != frame.shape or not np.isfinite(noise).all() or fs.launch_counts:
            raise AssertionError(f"frame noise {noise.shape}, launches {dict(fs.launch_counts)}")
    phase("frame-size sampler", frame_spatial)
    out["work"], out["root"] = work, root   # the corpus stays for phases 42-44
    return out


# Phase 57: a prod-exact fit stopped by SIGINT and resumed, on phase 39's cut
# corpus with three more train scenes of the same cut: 5 train scenes of 2
# images of 512 patches, 37 steps of 138 an epoch (one replay of K = 32 and a
# 5-step tail), 7 test batches
RESUME_TRAIN_SCENES = 5
RESUME_EPOCHS = 3


def _resume_phase(phase, flagship):
    """Phase 57 (see the module docstring): cli.train's prod-exact fit for
    RESUME_EPOCHS epochs straight, against the same fit stopped by SIGINT
    after epoch 1 and resumed by ``--continue_training`` in a new process's
    state (a fresh Trainer and NoiseFlow, the staged data and K = 32 graphs
    captured anew); every parameter, BN buffer and Adam slot must be the
    same bits, and a resume that drops the optimizer's slots must differ."""
    import signal

    import torch
    from noise_flow_tpu_torch.cli import flagship as fl
    from noise_flow_tpu_torch.cli import make_sidd_scale
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.training import trainer as trainer_mod
    from noise_flow_tpu_torch.training.trainer import Trainer

    def resume():
        work = os.path.join(flagship["work"], "resume")
        root = os.path.join(work, "SIDD_Medium_Raw", "Data")
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(flagship["root"], root)      # phase 39's scenes, copied
        h, w = FLAGSHIP_BAYER
        t0 = time.time()
        make_sidd_scale.main(["--root", root, "--n_train", str(RESUME_TRAIN_SCENES),
                              "--n_test", "1", "--height", str(h), "--width", str(w),
                              "--mat_version", make_sidd_scale.available_mat_version()])
        t_gen = time.time() - t0
        argv = fl.PROD_EXACT + ["--epochs", str(RESUME_EPOCHS), "--sidd_path", root,
                                "--device", "cuda"]
        fits = []
        real_fit, real_epoch = Trainer.fit, Trainer._train_epoch_staged
        real_load = trainer_mod.load_checkpoint

        def kept_fit(self, *a, **k):
            fits.append(self)
            return real_fit(self, *a, **k)

        def epoch_then_sigint(self, shuffle_seed):
            out = real_epoch(self, shuffle_seed)
            if shuffle_seed == self.cfg.seed + 1:     # after epoch 1's training pass
                signal.raise_signal(signal.SIGINT)
            return out

        def run(logdir, *extra):
            t0 = time.time()
            if cli_train.main(argv + ["--logdir", logdir, *extra]) != 0:
                raise AssertionError(f"cli.train {extra} failed")
            tr = fits[-1]
            if tr._steps_per_call() != GRAPH_K or not tr._graphs:
                raise AssertionError(f"K {tr._steps_per_call()}, graphs {list(tr._graphs)}")
            return {k: v.clone() for k, v in _run_state(tr).items()}, time.time() - t0

        def diff(a, b):
            return [k for k in a if k not in b or not torch.equal(a[k], b[k])]

        det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        Trainer.fit = kept_fit
        fs.launch_counts.clear()
        try:
            whole, t_whole = run(os.path.join(work, "whole"))
            split = os.path.join(work, "split")
            Trainer._train_epoch_staged = epoch_then_sigint
            try:
                _, t_first = run(split)
            finally:
                Trainer._train_epoch_staged = real_epoch
            first_rows = fl.read_tsv(os.path.join(split, "train.txt"))
            shutil.copytree(split, os.path.join(work, "fault"))
            resumed, t_resume = run(split, "--continue_training")
            # planted fault: the resume loads the weights and BN state only
            trainer_mod.load_checkpoint = lambda path, flow, opt=None: real_load(path, flow)
            try:
                dropped, _ = run(os.path.join(work, "fault"), "--continue_training")
            finally:
                trainer_mod.load_checkpoint = real_load
        finally:
            Trainer.fit = real_fit
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        counts = _main_path(dict(fs.launch_counts))
        bad = diff(whole, resumed)
        caught = diff(whole, dropped)
        # the NLL columns; train_time restarts and fit's best restarts at a
        # resume (msg), as JAX's do
        rows = {r: [[(x["epoch"], x["NLL"], x["sdz"]) for x in fl.read_tsv(
            os.path.join(work, d, f"{r}.txt"))] for d in ("whole", "split")]
            for r in ("train", "test")}
        same_rows = all(a == b for a, b in rows.values())
        n_opt = sum(k.startswith("opt/") for k in whole)
        steps = next(v for k, v in resumed.items() if k.endswith("/step"))
        print(f"resume: {RESUME_TRAIN_SCENES} train + 1 test scenes of {h}x{w} "
              f"({t_gen:.1f} s to write the new ones); cli.train prod-exact {RESUME_EPOCHS} "
              f"epochs straight {t_whole:.1f} s; stopped by SIGINT after epoch "
              f"{[r['epoch'] for r in first_rows]} {t_first:.1f} s, resumed "
              f"(--continue_training, K = {GRAPH_K} graphs captured anew) {t_resume:.1f} s; "
              f"{len(bad)} of {len(whole)} tensors differ ({n_opt} Adam slots; Adam step "
              f"{float(steps):g} on {steps.device}); train and test rows the same: {same_rows}; "
              f"planted fault (the resume drops Adam's slots): {len(caught)} tensors differ; "
              f"cuDNN deterministic; kernel launches {counts}")
        if bad or not same_rows or not caught or counts or len(first_rows) != 1:
            raise AssertionError(f"resume: differing {bad[:8]}, rows the same {same_rows}, "
                                 f"fault caught {bool(caught)}, launches {counts}")
    phase("resume: prod-exact fit stopped by SIGINT and resumed, against one run", resume)


# Phases 42-45: every flow the JAX package builds, on the card. None has a
# kernel (the fused envelopes exclude them all, as JAX's), so each path runs
# the plain PyTorch flow, and every one is held to the CPU. Layer kinds at the
# layer tolerances of tests/test_torch_layers.py: x and y elementwise within
# rtol 1e-4 and atol 1e-6 (times the largest |x| for the ISO-affine kinds,
# whose weights are multiplied by iso[0]), the log-dets within rtol 1e-5 and
# atol 1e-3; train-mode BN state within rtol 1e-5, atol 1e-6.
FAMILY_KINDS = ("perm_reverse", "conv1x1", "coupling", "sdn", "sdn1", "sdn2", "sdn3", "sdn4",
                "sdn5", "sdn6", "gain", "gain1", "gain2", "gain3", "gain4", "fitSDN", "fitSDN2",
                "condSDN", "condY", "condYG", "condXY", "condXYG", "batch_norm", "leaky_relu",
                "coupling:dense")
FAMILY_B = 138
ORACLE_ROW_ATOL = 0.01   # the oracle never trains: its train rows of 2 epochs, nats
ORACLE_CPU_TOL = (5e-2, 1e-5)   # one batch's NLL on the card and on the CPU (atol, rtol)
FAMILY_CLI = {
    "two_level": ["--arch", "unc|unc|unc|unc", "--n_levels", "2", "--squeeze_factor", "2",
                  "--do_sample"],
    "revnet_condXY": ["--arch", "", "--sidd_cond", "condXY", "--depth", "4"],
}


def _family_layer(kind, seed):
    """The port's layer of a FAMILY_KINDS entry at 32x32x4, width 4, its
    weights moved off init as tests/test_torch_layers.py::_pair moves them
    (parameters + 0.05 N, BatchNorm moments |m + 0.3 N| + 0.5), and the
    shared sdn/gain group + 0.1 N."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models import cond_params as cp
    from noise_flow_tpu_torch.models.layers import make_layer

    name, _, template = kind.partition(":")
    kw = dict(arch="", flow_permutation=1, decomp="LU")
    if template:
        kw["coupling_nn"] = template
    cfg = default_config(**kw)
    layer = make_layer(name, (32, 32, 4), cfg, np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    params = set(dict(layer.named_parameters()))
    sd = {}
    for k, v in layer.state_dict().items():
        n = torch.as_tensor(rng.standard_normal(tuple(v.shape)), dtype=torch.float32)
        if k in params:
            sd[k] = v + 0.05 * n
        elif k.endswith(("mean", "var")):
            sd[k] = (v + 0.3 * n).abs() + 0.5
        else:
            sd[k] = v
    layer.load_state_dict(sd)
    shared, c_i = cp.sdn_gain_shared_init(cfg.gain_init, None, 1 if name == "sdn6" else 3)
    shared = {k: torch.as_tensor(np.asarray(v, np.float32) + 0.1 * rng.standard_normal(
        np.shape(v)).astype(np.float32)) for k, v in shared.items()}
    return layer, shared, c_i


def _model_family_phases(phase, flagship):
    """Phases 42-45 (see the module docstring). Returns what they printed,
    for the summary."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.cli import flagship as cli_flagship
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.cli.args import parse_config
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.training.trainer import Trainer, batch_to_cond
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    out = {"seconds": {}}

    def no_launch(label):
        counts = _main_path(dict(fs.launch_counts))
        if counts:
            raise AssertionError(f"{label} launched kernels: {counts}")

    def layers():
        t0 = time.time()
        rng = np.random.default_rng(42)
        b = FAMILY_B
        cond_np = {"clean": rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32),
                   "iso": np.resize(np.array([100, 800, 200, 3200], np.float32), b),
                   "cam": np.resize(np.array([0, 2, 4, 7], np.float32), b),
                   "nlf0": np.full(b, 5e-4, np.float32), "nlf1": np.full(b, 2e-6, np.float32)}
        y_np = (0.05 * rng.standard_normal((b, 32, 32, 4))).astype(np.float32)
        worst = {"x": (0.0, ""), "ldj": (0.0, ""), "bn": (0.0, "")}
        bad = []
        fs.launch_counts.clear()
        for seed, kind in enumerate(FAMILY_KINDS):
            layer, shared, c_i = _family_layer(kind, seed)
            runs = {}
            for dev in ("cuda", "cpu"):
                lay = copy.deepcopy(layer).to(dev)
                sh = {"sdn_gain": {k: v.to(dev) for k, v in shared.items()}, "c_i": c_i}
                cond = {k: torch.as_tensor(v, device=dev) for k, v in cond_np.items()}
                y = torch.as_tensor(y_np, device=dev)
                with torch.no_grad():
                    for train in (False, True):
                        st = {}
                        x, ildj = lay.inverse(y, cond, train, sh, st)
                        y2, fldj = lay.forward(y, cond, train, sh)
                        runs[(dev, train)] = {"x": x.cpu(), "y": y2.cpu(), "ildj": ildj.cpu(),
                                              "fldj": fldj.cpu(),
                                              **{f"bn:{k}": v.cpu() for k, v in st.items()}}
            for train in (False, True):
                k_, p_ = runs[("cuda", train)], runs[("cpu", train)]
                scale = (float(p_["x"].abs().max()) if kind in ("condYG", "condXYG") else 1.0)
                for key in k_:
                    d = (k_[key] - p_[key]).abs()
                    if key in ("x", "y"):
                        atol, rtol, slot = 1e-6 * scale, 1e-4, "x"
                    elif key in ("ildj", "fldj"):
                        atol, rtol, slot = 1e-3, 1e-5, "ldj"
                    else:
                        atol, rtol, slot = 1e-6, 1e-5, "bn"
                    if not bool((d <= atol + rtol * p_[key].abs()).all()):
                        bad.append((kind, train, key, float(d.max())))
                    m = float(d.max()) if d.numel() else 0.0
                    if m > worst[slot][0]:
                        worst[slot] = (m, f"{kind} train={train} {key}")
            if kind in ("condY", "condYG", "condXY", "condXYG", "batch_norm", "coupling",
                        "coupling:dense") and not any(
                            k.startswith("bn:") for k in runs[("cuda", True)]):
                bad.append((kind, True, "no BN state", 0.0))
        no_launch("the layer kinds")
        out["seconds"]["layers"] = time.time() - t0
        print(f"model family: {len(FAMILY_KINDS)} layer kinds (dense coupling included) at "
              f"b={b}, 32x32x4, width 4, card against CPU, train and eval, inverse and forward: "
              + "; ".join(f"largest |d| {slot} {v:.3e} ({where})" for slot, (v, where) in
                          worst.items()) + f"; {len(bad)} out of tolerance")
        if bad:
            raise AssertionError(f"layer kinds disagree between card and CPU: {bad}")
    phase("model family: every layer kind, card against CPU", layers)

    def oracle():
        t0 = time.time()
        logdir = os.path.join(flagship["work"], "oracle")
        shutil.rmtree(logdir, ignore_errors=True)
        argv = cli_flagship.CONDSDN + ["--sidd_path", flagship["root"], "--logdir", logdir,
                                       "--device", "cuda"]
        fs.launch_counts.clear()
        if cli_train.main(argv) != 0:
            raise AssertionError("cli.train failed")
        no_launch("the condsdn-baseline run")
        rows = {s: cli_flagship.read_tsv(os.path.join(logdir, f"{s}.txt"))
                for s in ("train", "test")}
        train = [float(r["NLL"]) for r in rows["train"]]
        # one train batch's NLL from the oracle's checkpoint, card and CPU
        args, cfg = parse_config(argv)
        batch = next(cli_train.load_split(args, cfg, "train").batches(FAMILY_B))
        nll = {}
        for dev in ("cuda", "cpu"):
            flow = NoiseFlow(cfg.x_shape, load_hps(os.path.join(cli_flagship.JAX_ORACLE,
                                                                "hps.txt")), device=dev)
            load_checkpoint(os.path.join(cli_flagship.JAX_ORACLE, "ckpt",
                                         "model.ckpt-best.npz"), flow)
            t = {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32, device=dev)
                 for k in ("_x", "_y", "nlf0", "nlf1", "iso", "cam")}
            with torch.no_grad():
                nll[dev] = float(flow.nll_per_sample(t["_x"], batch_to_cond(t)).mean())
        no_launch("the oracle's batch")
        out["seconds"]["oracle"] = time.time() - t0
        out["oracle"] = {"rows": rows, "batch_nll": nll}
        print("condsdn-baseline (condsdn_scale's weights) through cli.train on the card, "
              f"{len(rows['train'])} epochs over the cut corpus: rows " + "; ".join(
                  f"{s} " + ", ".join(f"{float(r['NLL']):.4f}/{float(r['sdz']):.5f}"
                                      for r in rows[s]) for s in ("train", "test"))
              + f"; first train batch NLL card {nll['cuda']:.4f}, CPU {nll['cpu']:.4f}")
        hps = dict(ln.rstrip("\n").split(",", 1)
                   for ln in open(os.path.join(logdir, "hps.txt")) if "," in ln)
        if (len(train) != 2 or not np.isfinite(train).all()
                or abs(train[0] - train[1]) > ORACLE_ROW_ATOL
                or not hps.get("device", "").startswith("cuda")
                or abs(nll["cuda"] - nll["cpu"]) > ORACLE_CPU_TOL[0]
                + ORACLE_CPU_TOL[1] * abs(nll["cpu"])):
            raise AssertionError(f"oracle rows {rows}, batch NLL {nll}, device {hps.get('device')}")
    phase("model family: the condsdn_scale oracle through cli.train", oracle)

    def fits():
        for name, flags in FAMILY_CLI.items():
            t0 = time.time()
            logdir = os.path.join(flagship["work"], name)
            argv = flags + ["--n_batch_train", "138", "--patch_height", "32",
                            "--n_patches_per_image", "2898", "--epochs", "2",
                            "--epochs_full_valid", "1", "--temp", "0.6", "--device_resident_data",
                            "--sidd_path", flagship["root"], "--logdir", logdir,
                            "--device", "cuda"]
            fs.launch_counts.clear()
            if cli_train.main(argv) != 0:
                raise AssertionError(f"cli.train {name} failed")
            no_launch(f"cli.train {name}")
            rows = {s: cli_flagship.read_tsv(os.path.join(logdir, f"{s}.txt"))
                    for s in ("train", "test", "sample")}
            train = [float(r["NLL"]) for r in rows["train"]]
            hps = dict(ln.rstrip("\n").split(",", 1)
                       for ln in open(os.path.join(logdir, "hps.txt")) if "," in ln)
            out["seconds"][name] = time.time() - t0
            print(f"cli.train {name} on the card, 2 epochs over the cut corpus in "
                  f"{out['seconds'][name]:.1f} s: train {train}, test "
                  f"{[float(r['NLL']) for r in rows['test']]}, sample rows "
                  f"{[(float(r['NLL']), float(r['KLD_NF'])) for r in rows['sample']]}")
            finite = all(math.isfinite(float(r[c])) for s in rows.values() for r in s
                         for c in ("NLL", "sdz"))
            want_samples = 2 if "--do_sample" in flags else 0
            if (len(train) != 2 or not finite or not train[1] < train[0]
                    or len(rows["sample"]) != want_samples
                    or not hps.get("device", "").startswith("cuda")):
                raise AssertionError(f"{name}: rows {rows}, device {hps.get('device')}")
    phase("model family: cli.train of a 2-level flow and a legacy condXY flow", fits)
    return out


# Phases 46-48: data-parallel training, 2 ranks sharing the one card over
# gloo (nccl refuses two ranks on one card). The ranks are processes started
# by parallel.distributed.spawn_ranks, which returns what each rank read.
# Phases 46-47 are the multihost recipe (jobs/job_noise_flow.sh multihost:
# global batch 276 over 2 processes of 138) on phase 39's cut corpus: each
# process takes its host_shard of the image tuples (2 train images and 1
# test image), 69 patches an image, so that every epoch is one step of 276
# and a test batch of 138; 3 epochs from the flagship's checkpoint (ckpt-3
# is written before the third epoch's step: the weights after 2 steps).
# Every rank and every one-rank reference of these phases runs with cuDNN's
# deterministic algorithms (PAR_DETERMINISM), so that a comparison reads the
# same in every run: see PERF.md §6.
PAR_RANKS = 2
PAR_B = 276
PAR_PATCHES = 69
PAR_EPOCHS = 3
PAR_SPAWN_S = 300     # the longest a spawn of ranks may run
PAR_DIR = os.path.join(ROOT, "build", "chip_smoke_parallel")
PAR_INIT = os.path.join(MODEL, "ckpt", "model.ckpt-best.npz")
# 2 ranks against 1 rank on the same global batches, float32 sums in another
# order (the BN moments' all-reduce, the ranks' mean of the gradients): each
# step's train NLL and each test NLL within PAR_NLL_RTOL relative; the first
# step's gradients, on the same weights, within probes.mesh.GRAD_TOL (JAX's);
# the weights after 2 Adam steps (lr 1e-4) within probes.mesh.PARAM_TOL,
# less probes.mesh.SKIP, as tests/test_torch_parallel.py leaves them out,
# and less the elements whose reference gradient in a step is below
# PAR_WEIGHT_FLOOR of that step's largest |g|, the gradient tolerance's
# absolute part: within it such a gradient may change sign, and Adam's first
# steps move an element by about lr whatever its gradient's size, so the two
# sides step lr apart there (PERF.md §6: the coupling networks'
# last.w elements with |g| ~1e-9 of the largest read 18.6 times the
# tolerance, as far as the planted fault).
PAR_NLL_RTOL = 1e-5
PAR_WEIGHT_FLOOR = 1e-5
# DnCNN_NF on 2 ranks against 1, the first step on the same weights and the
# same noise: each gradient leaf normwise, ||d|| <= tol ||g||. A weight's
# gradient sums 64 x 64 x 128 products, in another order on 2 ranks (cuDNN
# picks its algorithm by batch), and cancels: elementwise it read 5.3 times
# JAX's gradient tolerance (PERF.md §6), so it is held normwise.
PAR_DNCNN_GRAD_RTOL = 1e-3
PAR_DEVICE = "cuda:0"   # both ranks' device
PAR_DETERMINISM = "cudnn"


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _par_argv(flagship, use_pallas, device):
    return ["--n_batch_train", str(PAR_B), "--patch_height", "32", "--n_patches_per_image",
            str(PAR_PATCHES), "--epochs", str(PAR_EPOCHS), "--sidd_path", flagship["root"],
            "--init_checkpoint", PAR_INIT, "--temp", "0.6", "--device", device,
            "--dist_backend", "gloo"] + (
                ["--use_pallas", "--pallas_train_dtype", "float32"] if use_pallas
                else ["--do_sample"])


def _coordinator_rank(rank, device, argv, port):
    """One process of cli.train in coordinator mode; its kernels' launches
    (every kernel's wrapper counts into ``fused_sample.launch_counts``)."""
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.probes.mesh import set_deterministic

    set_deterministic(PAR_DETERMINISM)
    fs.launch_counts.clear()
    t0 = time.time()
    rc = cli_train.main(argv + ["--coordinator_address", f"localhost:{port}",
                                "--num_processes", str(PAR_RANKS), "--process_id", str(rank)])
    return {"rc": rc, "seconds": time.time() - t0, "launches": dict(fs.launch_counts)}


def _trainer_rank(rank, device, batches_path):
    """A rank of Trainer(mesh) on the global batches of phase 46: the plain
    path, the plain path with each rank's own BN moments (the planted
    fault), and each path's step and all-reduce times."""
    import numpy as np
    from noise_flow_tpu_torch.parallel.mesh import make_mesh
    from noise_flow_tpu_torch.probes import mesh as pm

    mesh = make_mesh(None, device)
    z = np.load(batches_path)
    n = len({k.split(":")[0] for k in z.files})
    epoch = [{k.split(":")[1]: z[k] for k in z.files if k.startswith(f"{s}:")}
             for s in range(n)]
    # the steps of phase 46's epochs, which repeat one epoch's batches
    batches = [epoch[s % n] for s in range(2)]
    # local_bn: the planted fault, each rank's own BN moments
    out = {name: pm.plain_steps(rank, device, batches, PAR_DETERMINISM, name == "local_bn")
           for name in ("plain", "local_bn")}
    pm.set_deterministic("off")
    out["times"] = pm.step_times(mesh, batches[0])
    return out


def _dncnn_fit(argv):
    """cli.train_dncnn on this rank (or one rank alone): its sampler
    launches, losses and weights, and its first step's noise (the whole
    batch's), loss and gradients."""
    from noise_flow_tpu_torch.cli import train_dncnn
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.probes.mesh import set_deterministic
    from noise_flow_tpu_torch.training import dncnn_trainer as dt

    set_deterministic(PAR_DETERMINISM)
    held, first = {}, {}
    cls = dt.DnCNNTrainer
    fit, make_noise, step = cls.fit, cls._make_noise, cls.train_step

    def keep(self, *a, **k):
        held["trainer"], held["history"] = self, fit(self, *a, **k)
        return held["history"]

    def keep_noise(self, *a):
        noise = make_noise(self, *a)
        first.setdefault("noise", noise.cpu())
        return noise

    def keep_step(self, *a):
        loss = step(self, *a)
        if "grads" not in first:
            first["loss"] = float(loss)
            first["grads"] = {k: p.grad.cpu().clone() for k, p in self.model.named_parameters()}
        return loss
    cls.fit, cls._make_noise, cls.train_step = keep, keep_noise, keep_step
    try:
        fs.launch_counts.clear()
        t0 = time.time()
        rc = train_dncnn.main(argv)
        return {"rc": rc, "seconds": time.time() - t0, "launches": dict(fs.launch_counts),
                "losses": held["history"]["loss"], "first": first,
                "state": {k: v.cpu() for k, v in held["trainer"].model.state_dict().items()}}
    finally:
        cls.fit, cls._make_noise, cls.train_step = fit, make_noise, step
        set_deterministic("off")


def _dncnn_rank(rank, device, argv):
    """A rank of cli.train_dncnn in a group of PAR_RANKS on the card."""
    return _dncnn_fit(argv)


def _parallel_phases(phase, flagship, smi, device=PAR_DEVICE):
    """Phases 46-48 (see the module docstring). Returns the per-rank
    launches, for the kernels line."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.cli.args import parse_config
    from noise_flow_tpu_torch.cli.flagship import read_tsv
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.parallel.mesh import Mesh
    from noise_flow_tpu_torch.probes import mesh as pm
    from noise_flow_tpu_torch.training.trainer import Trainer
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    out = {"launches": {}}
    label = f"2 ranks sharing one card, gloo; {smi}"

    def spawn(fn, *args, group=True):
        return pd.spawn_ranks(PAR_RANKS, fn, args, device, "gloo", timeout=PAR_SPAWN_S,
                              group=group)

    def reference(argv):
        """One rank at 276 on the two processes' batches, concatenated: each
        epoch's test NLL and train NLL, the state before each epoch's step,
        and the global train batches."""
        args, cfg = parse_config(argv)
        bsc = not cfg.per_example_cond

        def global_batches(split, bs, shuffle):
            its = [cli_train.load_split(args, cfg, split, shard=(r, PAR_RANKS)).batches(
                bs, shuffle=shuffle, seed=cfg.seed, drop_remainder=True, batch_scalar_cond=bsc)
                for r in range(PAR_RANKS)]
            return [{k: np.concatenate([b[k] for b in group]) for k in group[0]}
                    for group in zip(*its)]
        train_b = global_batches("train", PAR_B // PAR_RANKS, True)
        test_b = global_batches("test", cfg.n_batch_test // PAR_RANKS, False)
        flow = NoiseFlow(cfg.x_shape, cfg, device=device, seed=cfg.seed)
        load_checkpoint(PAR_INIT, flow)
        tr = Trainer(flow, cfg)
        rows = {"train": [], "test": [], "states": [], "grads": []}
        pm.set_deterministic(PAR_DETERMINISM)
        try:
            for _ in range(cfg.epochs):
                rows["states"].append({k: v.cpu().clone() for k, v in flow.state_dict().items()})
                rows["test"].append(float(np.mean([float(tr.eval_step(tr._put(b))[0])
                                                   for b in test_b])))
                for b in train_b:
                    rows["train"].append(float(tr.train_step(tr._put(b))[0]))
                    rows["grads"].append({k: p.grad.cpu().clone() for k, p in
                                          flow.named_parameters() if p.grad is not None})
        finally:
            pm.set_deterministic("off")
        rows["batches"] = train_b
        return rows

    def coordinator_fit(use_pallas):
        name = "oneshot" if use_pallas else "plain"
        argv = _par_argv(flagship, use_pallas, device)
        logdir = os.path.join(PAR_DIR, f"fit_{name}")
        shutil.rmtree(logdir, ignore_errors=True)
        argv += ["--logdir", logdir]
        t0 = time.time()
        ranks = spawn(_coordinator_rank, argv, pd.free_port(), group=False)
        t_fit = time.time() - t0
        ref = reference(argv)
        rows = {s: read_tsv(os.path.join(logdir, f"{s}.txt")) for s in ("train", "test")}
        train = [float(r["NLL"]) for r in rows["train"]]
        test = [float(r["NLL"]) for r in rows["test"]]
        args, cfg = parse_config(argv)
        flow = NoiseFlow(cfg.x_shape, cfg, device="cpu")
        load_checkpoint(os.path.join(logdir, "ckpt", f"model.ckpt-{PAR_EPOCHS}.npz"), flow)
        ratio, worst, worst_key = pm.weights_agreement(
            flow.state_dict(), ref["states"][-1], ref["grads"][:PAR_EPOCHS - 1],
            PAR_WEIGHT_FLOOR)
        every = pm.weights_agreement(flow.state_dict(), ref["states"][-1])[0]
        d_train = max(abs(a - b) / abs(b) for a, b in zip(train, ref["train"]))
        d_test = max(abs(a - b) / abs(b) for a, b in zip(test, ref["test"]))
        with open(os.path.join(logdir, "hps.txt")) as f:
            hps = {r[0]: r[1] for r in csv.reader(f) if len(r) == 2}
        counts = [r["launches"] for r in ranks]
        out[name] = {"ref": ref, "train": train}
        print(f"parallel {name}: cli.train coordinator mode, {PAR_RANKS} processes on {device} "
              f"(gloo), global batch {PAR_B} ({PAR_B // PAR_RANKS} a rank), {PAR_EPOCHS} steps "
              f"from {os.path.relpath(PAR_INIT, ROOT)} in {t_fit:.1f} s (rc "
              f"{[r['rc'] for r in ranks]}; rank seconds {[round(r['seconds'], 1) for r in ranks]}"
              f"); train NLL {train} vs 1 rank at {PAR_B} {ref['train']} (max rel "
              f"{d_train:.3e}, tol {PAR_NLL_RTOL}); test NLL {test} vs {ref['test']} (max rel "
              f"{d_test:.3e}); ckpt-{PAR_EPOCHS} weights max |d| {worst:.3e}, "
              f"{ratio:.3f} of the tolerance (atol {pm.PARAM_TOL[0]}, rtol {pm.PARAM_TOL[1]},"
              f" less {pm.SKIP} and the elements below {PAR_WEIGHT_FLOOR} of a step's largest"
              f" |g|; worst {worst_key}; {every:.3f} over every element); launches by rank "
              f"{counts}; hps "
              f"num_processes {hps.get('num_processes')}")
        if any(r["rc"] != 0 for r in ranks) or len(train) != PAR_EPOCHS or \
                d_train > PAR_NLL_RTOL or d_test > PAR_NLL_RTOL or ratio > 1.0 or \
                hps.get("num_processes") != str(PAR_RANKS):
            raise AssertionError(f"{name}: 2 ranks disagree with 1 rank")
        if use_pallas:
            # each rank: one step launch a step, none of the segment path; two
            # eval launches (both segments) a test batch
            want = {"fused_train_step": PAR_EPOCHS, "fused_segment_forward": 2 * PAR_EPOCHS}
            if any({k: v for k, v in c.items() if v} != want for c in counts):
                raise AssertionError(f"launches by rank {counts}, not {want} each")
            out["launches"]["fused_train_step"] = [c["fused_train_step"] for c in counts]
            out["launches"]["fused_segment_forward"] = [c["fused_segment_forward"]
                                                        for c in counts]
        elif any(c for c in counts):
            raise AssertionError(f"the exact-BN path launched kernels: {counts}")

    phase("parallel: cli.train coordinator mode, 2 ranks, plain exact BN, vs 1 rank at 276",
          lambda: coordinator_fit(False))
    phase("parallel: cli.train coordinator mode, 2 ranks, one-shot kernel, vs 1 rank at 276",
          lambda: coordinator_fit(True))

    def trainer_spawn():
        """The planted fault of tests/test_torch_parallel.py (each rank's
        own BN moments) through an in-process spawn of the Trainer, and each
        path's step and all-reduce times."""
        ref = out["plain"]["ref"]
        path = os.path.join(PAR_DIR, "batches.npz")
        np.savez(path, **{f"{s}:{k}": v for s, b in enumerate(ref["batches"])
                          for k, v in b.items()})
        ranks = spawn(_trainer_rank, path)
        for r in ranks:
            read = {}
            for name in ("plain", "local_bn"):
                got = r[name]
                read[name] = (
                    max(abs(a - b) / abs(b) for a, b in zip(got["nlls"], ref["train"])),
                    pm.grads_agreement(got["grads"][0], ref["grads"][0]),
                    pm.weights_agreement(got["state"], ref["states"][2], ref["grads"][:2],
                                         PAR_WEIGHT_FLOOR))
            (d, g, w), (bd, bg, bw) = read["plain"], read["local_bn"]
            print(f"parallel trainer spawn: plain path NLL max rel {d:.3e}, first step's "
                  f"gradients {g[0]:.3f} of their tolerance (rtol {pm.GRAD_TOL[0]}, atol "
                  f"{pm.GRAD_TOL[1]} max|g|; {g[2]}), weights {w[0]:.3f} of theirs ({w[2]}, "
                  f"max |d| {w[1]:.3e}); planted fault (each rank's own BN moments) NLL max "
                  f"rel {bd:.3e}, gradients {bg[0]:.3f} ({bg[2]}), weights {bw[0]:.3f} of the "
                  f"tolerance")
            if g[0] > 1.0 or w[0] > 1.0 or d > PAR_NLL_RTOL:
                raise AssertionError("the trainer's 2 ranks disagree with 1 rank")
            if bg[0] <= 1.0 or bw[0] <= 1.0:
                raise AssertionError("a comparison missed the planted fault")
        # the 1-rank step at 276 on the same batch, host clock
        one_rank = pm.step_times(Mesh(1, 0, torch.device(device)), ref["batches"][0])
        out["times"] = {"one_rank_ms": {}}
        for key in ("plain", "oneshot"):
            t = [r["times"][key] for r in ranks]
            one = one_rank[key]["step_ms"]
            out["times"][f"{key}_ms"] = t
            out["times"]["one_rank_ms"][key] = one
            print(f"parallel {key} step at {PAR_B // PAR_RANKS} a rank ({label}): step ms "
                  f"by rank {[round(x['step_ms'], 3) for x in t]}, all-reduce ms a step "
                  f"{[round(x['allreduce_ms'], 3) for x in t]} ({t[0]['allreduces']:.0f} "
                  f"all-reduces a step); 1 rank at {PAR_B}: {one} ms (host clock)")
    phase("parallel: Trainer spawn, planted fault and per-rank times", trainer_spawn)

    def dncnn():
        save = os.path.join(PAR_DIR, "dncnn")
        shutil.rmtree(save, ignore_errors=True)
        from noise_flow_tpu_torch.data.dncnn_data import synthetic_dncnn_data

        clean, _, _ = synthetic_dncnn_data(n_images=DNCNN_IMAGES, batch_size=DNCNN_B)
        steps = (len(clean) - (min(len(clean) // 10, 512) or 1)) // DNCNN_B
        argv = ["--model", "DnCNN_NF", "--noise_flow_path", MODEL, "--device", device,
                "--depth", str(DNCNN_DEPTH), "--filters", str(DNCNN_FILTERS),
                "--batch_size", str(DNCNN_B), "--max_epoch", str(DNCNN_EPOCHS),
                "--synthetic_data", str(DNCNN_IMAGES), "--save_dir", save,
                "--cam_iso_nlf", os.path.join(ROOT, "cam_iso_nlf.txt")]
        t0 = time.time()
        ranks = spawn(_dncnn_rank, argv)
        t_ranks = time.time() - t0
        one = _dncnn_fit(argv + ["--save_dir", save + "_one"])
        want = DNCNN_EPOCHS * steps * BATCH_BN_LAUNCHES
        same = all(torch.equal(v, ranks[1]["state"][k]) for k, v in ranks[0]["state"].items())
        losses = ranks[0]["losses"]
        f1, f0 = ranks[0]["first"], one["first"]
        noise_same = all(torch.equal(r["first"]["noise"], f0["noise"]) for r in ranks)
        e_first = abs(f1["loss"] - f0["loss"]) / abs(f0["loss"])
        g = {k: float((f1["grads"][k] - v).norm() / v.norm().clamp_min(1e-30))
             for k, v in f0["grads"].items()}
        g_worst = max(g, key=g.get)
        e_loss = max(abs(a - b) / abs(b) for a, b in zip(losses, one["losses"]))
        rels = {k: float((ranks[0]["state"][k] - v).norm() / v.norm().clamp_min(1e-30))
                for k, v in one["state"].items()}
        worst = max(rels, key=rels.get)
        print(f"parallel dncnn: cli.train_dncnn DnCNN_NF in a group of {PAR_RANKS} ranks on "
              f"{device} (gloo), batch {DNCNN_B} ({DNCNN_B // PAR_RANKS} a rank), "
              f"{DNCNN_EPOCHS} epochs of {steps} steps in {t_ranks:.1f} s (rc "
              f"{[r['rc'] for r in ranks]}); losses {losses}; weights equal on both ranks: "
              f"{same}; sampler launches by rank {[r['launches'] for r in ranks]} (want {want}"
              f" each, all in RNG mode at b = {DNCNN_B}); against one rank (losses "
              f"{one['losses']}, launches {one['launches']}): first step's noise the same bits"
              f" on both ranks as on one: {noise_same}; its loss rel {e_first:.3e} (tol "
              f"{PAR_NLL_RTOL}); its gradients normwise worst {g[g_worst]:.3e} ({g_worst}; tol "
              f"{PAR_DNCNN_GRAD_RTOL}); after "
              f"{DNCNN_EPOCHS} epochs losses max rel {e_loss:.3e}, weights and BN state "
              f"normwise worst {rels[worst]:.3e} ({worst})")
        if any(r["rc"] != 0 for r in ranks + [one]) or not same or \
                not np.isfinite(losses).all() or not losses[-1] < losses[0] or \
                ranks[0]["losses"] != ranks[1]["losses"] or not noise_same or \
                e_first > PAR_NLL_RTOL or g[g_worst] > PAR_DNCNN_GRAD_RTOL:
            raise AssertionError("DnCNN_NF on 2 ranks")
        if any(r["launches"].get("fused_sample") != want or
               r["launches"].get("fused_sample_rng") != want for r in ranks):
            raise AssertionError(f"sampler launches by rank, not {want} each")
        out["launches"]["fused_sample"] = [r["launches"]["fused_sample"] for r in ranks]
        shutil.rmtree(save, ignore_errors=True)
        shutil.rmtree(save + "_one", ignore_errors=True)
    phase("parallel: cli.train_dncnn DnCNN_NF on 2 ranks, vs 1 rank", dncnn)
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    return out


# Phases 49-51: the frame sharded by height over 2 ranks (both on cuda:0,
# gloo), PackedFlow, and the TF importer's mapping; no kernel on any of them.
# The frame is the SIDD_Medium packed frame of experiments/spatial_frame.md,
# reflect-padded to a height that 8 x 2 ranks divides (2672) and a width
# that 8 divides (1504), as JAX's mesh path pads it. Each rank's rows are
# held to the one-rank flow.forward on the same frame and latent, elementwise
# and relative to the value and to the frame's spread:
# |d| <= SPATIAL_RTOL (|one rank| + sd(one rank)), the gate of
# tests/test_torch_spatial_mesh.py (BN moments summed in another order, and
# cuDNN free to pick other algorithms at the shard's shape). The planted
# faults (the edge indicator on every shard's padded rows; BN moments over
# each rank's own rows) must exceed it.
SPATIAL_FRAME_HW = (2664, 1500)
SPATIAL_PAD_HW = (2672, 1504)
SPATIAL_RTOL = 1e-5
SPATIAL_REPS = 3
SPATIAL_WRAPPER_SEED = 5   # every rank's NoiseFlowWrapper, and the one-rank draws it is held to
SPATIAL_DIR = os.path.join(ROOT, "build", "chip_smoke_spatial")
# PackedFlow against NoiseFlow.loss on the card at the flagship's batch, the
# tolerances of tests/test_packed.py: the NLL (rtol, atol), sd_z, the new BN
# state, and each gradient leaf elementwise within rtol 5e-3 and
# max(5e-3 max|g|, 5e-4) (leaves below 2e-3 on both sides, the biases that
# feed a BN, are rounding noise there and left out)
PACKED_B = 138
PACKED_NLL_TOL = (2e-5, 2e-3)
PACKED_SDZ_TOL = (1e-4, 1e-5)
PACKED_STATE_TOL = (1e-5, 1e-6)
PACKED_GRAD_RTOL = 5e-3


class _PerShardIndicator:
    """The planted fault of tests/test_torch_spatial_mesh.py: the halo rows
    exchanged, the edge indicator set on every shard's padded rows."""

    def __init__(self, halo):
        self.halo, self.top, self.bottom = halo, True, True

    def __call__(self, x, rows=1):
        return self.halo(x, rows)


class _TimedHalo:
    """A RowHalo that adds each exchange's seconds (card synchronised) to
    ``seconds``."""

    def __init__(self, halo):
        self.halo, self.top, self.bottom = halo, halo.top, halo.bottom
        self.seconds, self.calls = 0.0, 0

    def __call__(self, x, rows=1):
        import torch
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = self.halo(x, rows)
        torch.cuda.synchronize(x.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def _spatial_frame(device):
    """The padded frame's clean image, conditioning and latent, the same on
    every rank (a seeded CPU generator)."""
    import torch
    g = torch.Generator().manual_seed(13)
    h, w = SPATIAL_PAD_HW
    clean = 0.02 + 0.78 * torch.rand((1, h, w, 4), generator=g)
    z = torch.randn((1, h, w, 4), generator=g) * TEMP

    def one(v):
        return torch.full((1,), float(v), device=device)
    cond = {"clean": clean.to(device), "nlf0": one(0.0), "nlf1": one(0.0),
            "iso": one(800.0), "cam": one(2.0)}
    return cond, z.to(device)


def _host_ms(fn, iters: int = 5) -> float:
    """The median of ``iters`` calls' host-clock ms, the card synchronised
    after each (after one call to warm up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[iters // 2]


def _spatial_flow(device):
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    flow = NoiseFlow(SPATIAL_PAD_HW + (4,), load_hps(os.path.join(MODEL, "hps.txt")),
                     device=device)
    load_checkpoint(os.path.join(MODEL, "ckpt", "model.ckpt-best.npz"), flow)
    return flow.eval()


def _rows_read(got, one, sd, row0):
    """``got`` against ``one`` under the gate |d| <= SPATIAL_RTOL (|one| +
    sd): max abs and rel, the gate's worst ratio, and the frame rows
    (``row0`` the first of ``got``) outside it."""
    import torch
    d = (got - one).abs()
    gate = d / (SPATIAL_RTOL * (one.abs() + sd))
    bad_rows = torch.nonzero((gate > 1).any(dim=3).any(dim=2)[0]).flatten()
    return {"max_abs": float(d.max()), "max_rel": float((d / one.abs().clamp_min(1e-6)).max()),
            "gate": float(gate.max()), "finite": bool(torch.isfinite(got).all()),
            "bad_rows": [int(r) + row0 for r in bad_rows[:4]] + (
                [int(bad_rows[-1]) + row0] if len(bad_rows) > 4 else []),
            "n_bad_rows": int(len(bad_rows))}


def _spatial_rank(rank, device, ref_path):
    """A rank of phase 49: its rows of each BN mode and each planted fault
    against the one-rank frame, the faithful pass timed, and the wrapper's
    entry point under the mesh against its one-rank frame."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.parallel import spatial
    from noise_flow_tpu_torch.parallel.mesh import make_mesh
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    mesh = make_mesh(None, device)
    ref = torch.load(ref_path)
    flow = _spatial_flow(device)
    cond, z = _spatial_frame(device)
    rows = spatial.shard_rows(SPATIAL_PAD_HW[0], mesh)
    fs.launch_counts.clear()
    out = {"rank": mesh.rank, "rows": (rows.start, rows.stop), "reads": {}}
    cases = (("train", True, None), ("eval", False, None),
             ("indicator", True, "indicator"), ("local_bn", True, "local_bn"))
    with torch.no_grad():
        for name, train, fault in cases:
            halo = _PerShardIndicator(spatial.RowHalo(mesh)) if fault == "indicator" else None
            psum = (lambda s: s) if fault == "local_bn" else None
            got = spatial.sample_frame_sharded(flow, cond, z, mesh, TEMP, train, halo=halo,
                                               psum=psum)
            one = ref[name if name in ("train", "eval") else "train"].to(device)[:, rows]
            sd = ref["sd_" + ("eval" if name == "eval" else "train")]
            out["reads"][name] = _rows_read(got, one, sd, rows.start)
        # the faithful train-mode pass timed: the frame, its halo exchanges
        # (all-reduces included) and every all-reduce (halo and BN moments)
        timed = _TimedHalo(spatial.RowHalo(mesh))
        pd.collective_stats.update(calls=0, seconds=0.0, timing=True)
        ms = []
        for _ in range(SPATIAL_REPS):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            spatial.sample_frame_sharded(flow, cond, z, mesh, TEMP, True, halo=timed)
            torch.cuda.synchronize(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        pd.collective_stats["timing"] = False
        out["times"] = {"frame_ms": ms, "halo_ms": timed.seconds * 1e3 / SPATIAL_REPS,
                        "halo_calls": timed.calls // SPATIAL_REPS,
                        "allreduce_ms": pd.collective_stats["seconds"] * 1e3 / SPATIAL_REPS,
                        "allreduces": pd.collective_stats["calls"] // SPATIAL_REPS}
        # the entry point: each rank's wrapper seeded alike, the mesh of both
        frame = np.asarray(cond["clean"][0, :SPATIAL_FRAME_HW[0], :SPATIAL_FRAME_HW[1]].cpu())
        nf = NoiseFlowWrapper(MODEL, sampling_temperature=TEMP, device=device,
                              seed=SPATIAL_WRAPPER_SEED)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        noise = nf.sample_noise_frame_spatial(frame, 0.0, 0.0, 800.0, 2.0, mesh=mesh)
        out["wrapper"] = {"ms": (time.perf_counter() - t0) * 1e3, "shape": noise.shape,
                          "sd": float(noise.std()), "finite": bool(np.isfinite(noise).all()),
                          "digest": hashlib.sha256(noise.tobytes()).hexdigest()[:16]}
        if noise.shape == SPATIAL_FRAME_HW + (4,):
            out["reads"]["wrapper"] = _rows_read(torch.as_tensor(noise, device=device)[None],
                                                 ref["wrapper"].to(device), ref["sd_wrapper"], 0)
    out["launches"] = dict(fs.launch_counts)
    return out


def _spatial_packed_tf_phases(phase, nf, smi, device=PAR_DEVICE):
    """Phases 49-51 (see the module docstring). Returns their readings."""
    import numpy as np
    import torch
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.ops.packed_flow import PackedFlow, pack
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.parallel.mesh import Mesh
    from noise_flow_tpu_torch.utils import tf_import as ti

    out = {}
    label = f"2 ranks sharing one card, gloo; {smi}"

    def spatial_frame():
        os.makedirs(SPATIAL_DIR, exist_ok=True)
        flow = _spatial_flow(device)
        cond, z = _spatial_frame(device)
        fs.launch_counts.clear()
        ref = {}
        from noise_flow_tpu_torch.parallel.spatial import sample_frame_sharded
        one = Mesh(1, 0, torch.device(device))
        with torch.no_grad():
            for name, train in (("train", True), ("eval", False)):
                x = sample_frame_sharded(flow, cond, z, one, TEMP, train)
                ref[name], ref["sd_" + name] = x.cpu(), float(x.std())
            # the entry point's one-rank frame: the wrapper's frame padded as
            # it pads it for 2 ranks, its latents drawn as it draws them
            # (train-mode BN, its default), cropped to the frame
            (h, w), (hp, wp) = SPATIAL_FRAME_HW, SPATIAL_PAD_HW
            padded = np.pad(cond["clean"][:, :h, :w].cpu().numpy(),
                            ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), mode="reflect")
            zw, epsw = flow.draw_latents(TEMP, 1, torch.Generator(device=device).manual_seed(
                SPATIAL_WRAPPER_SEED))
            x = sample_frame_sharded(flow, dict(cond, clean=torch.as_tensor(padded, device=device)),
                                     zw, one, TEMP, True, epsw)[:, :h, :w]
            ref["wrapper"], ref["sd_wrapper"] = x.cpu(), float(x.std())
            ms = []
            for _ in range(SPATIAL_REPS):
                _sync(device)
                t0 = time.perf_counter()
                sample_frame_sharded(flow, cond, z, one, TEMP, True)
                _sync(device)
                ms.append((time.perf_counter() - t0) * 1e3)
        if fs.launch_counts:
            raise AssertionError(f"the one-rank frame launched kernels: {dict(fs.launch_counts)}")
        del flow, cond, z, zw, epsw
        torch.cuda.empty_cache()
        path = os.path.join(SPATIAL_DIR, "one_rank.pt")
        torch.save(ref, path)
        t0 = time.time()
        ranks = pd.spawn_ranks(2, _spatial_rank, (path,), device, "gloo", timeout=PAR_SPAWN_S)
        t_ranks = time.time() - t0
        reads = {k: {f: max(r["reads"][k][f] for r in ranks) if f != "finite" else
                     all(r["reads"][k][f] for r in ranks)
                     for f in ("max_abs", "max_rel", "gate", "finite")}
                 for k in ranks[0]["reads"]}
        for k in reads:
            reads[k]["bad_rows"] = [r["reads"][k]["bad_rows"] for r in ranks]
            reads[k]["n_bad_rows"] = sum(r["reads"][k]["n_bad_rows"] for r in ranks)
        out["spatial"] = {"reads": reads, "one_rank_ms": ms,
                          "ranks": [r["times"] for r in ranks],
                          "wrapper": [r["wrapper"] for r in ranks], "on": label}
        for k, v in reads.items():
            what = (f"the wrapper's {SPATIAL_FRAME_HW} frame" if k == "wrapper" else
                    f"the {SPATIAL_PAD_HW} frame")
            print(f"spatial frame {k}: 2 ranks vs 1 rank on {what} "
                  f"(flagship, same z): max_abs {v['max_abs']:.3e} max_rel {v['max_rel']:.3e}, "
                  f"gate {v['gate']:.3f} of SPATIAL_RTOL {SPATIAL_RTOL} (|1 rank| + sd), "
                  f"{v['n_bad_rows']} rows outside it (first/last by rank {v['bad_rows']})")
        for r in ranks:
            t = r["times"]
            print(f"spatial frame rank {r['rank']} rows {r['rows']} ({label}): frame ms "
                  f"{[round(x, 2) for x in t['frame_ms']]}; halo {t['halo_ms']:.2f} ms over "
                  f"{t['halo_calls']} exchanges; all-reduce {t['allreduce_ms']:.2f} ms over "
                  f"{t['allreduces']} (halo and BN moments; host clock); wrapper "
                  f"sample_noise_frame_spatial({SPATIAL_FRAME_HW}, mesh=2 ranks) "
                  f"{r['wrapper']['ms']:.1f} ms, shape {r['wrapper']['shape']}, sd "
                  f"{r['wrapper']['sd']:.5f}, digest {r['wrapper']['digest']}; launches "
                  f"{r['launches']}")
        print(f"spatial frame 1 rank at {SPATIAL_PAD_HW}: ms {[round(x, 2) for x in ms]} "
              f"(host clock, {smi}); the spawn of 2 ranks {t_ranks:.1f} s")
        shutil.rmtree(SPATIAL_DIR, ignore_errors=True)
        faithful = "wrapper" in reads and all(
            reads[k]["gate"] <= 1 for k in ("train", "eval", "wrapper")) and all(
            v["finite"] for v in reads.values())
        wrap = ranks[0]["wrapper"]
        if not faithful or any(r["launches"] for r in ranks) or \
                ranks[0]["wrapper"]["digest"] != ranks[1]["wrapper"]["digest"] or \
                tuple(wrap["shape"]) != SPATIAL_FRAME_HW + (4,) or not wrap["finite"]:
            raise AssertionError("2 ranks disagree with 1 rank, or the wrapper's ranks differ")
        if reads["indicator"]["gate"] <= 1 or reads["local_bn"]["gate"] <= 1:
            raise AssertionError("the gate missed a planted fault")
    phase("spatial frame: 2 ranks (gloo, one card) vs 1 rank at 2664x1500, planted faults",
          spatial_frame)

    def packed():
        flow = nf.flow
        x, cond = _train_batch(PACKED_B, seed=49)
        fs.launch_counts.clear()
        reads = {}
        for precision in ("highest", "default"):
            pf = PackedFlow(flow, precision)

            def run(fn):
                flow.zero_grad()
                nll, sdz, st = fn()
                nll.backward()
                return nll.detach(), sdz.detach(), st, {
                    k: p.grad.clone() for k, p in flow.named_parameters() if p.grad is not None}
            ref = run(lambda: flow.loss(x, cond, train=True))
            got = run(lambda: pf.loss(pack(x), dict(cond, clean=pack(cond["clean"])), True))
            worst = 0.0
            for k, a in ref[3].items():
                b = got[3][k]
                if max(float(a.abs().max()), float(b.abs().max())) < 2e-3:
                    continue
                tol = max(5e-3 * float(a.abs().max()), 5e-4) + PACKED_GRAD_RTOL * a.abs()
                worst = max(worst, float(((b - a).abs() / tol).max()))
            st = max(float(((got[2][k] - v).abs() / (PACKED_STATE_TOL[1] + PACKED_STATE_TOL[0]
                                                      * v.abs())).max()) for k, v in ref[2].items())
            nll = abs(float(got[0]) - float(ref[0])) / (PACKED_NLL_TOL[1] + PACKED_NLL_TOL[0]
                                                         * abs(float(ref[0])))
            sdz = abs(float(got[1]) - float(ref[1])) / (PACKED_SDZ_TOL[1] + PACKED_SDZ_TOL[0]
                                                         * abs(float(ref[1])))

            def step(fn):
                flow.zero_grad()
                fn()[0].backward()
            t_ref = _host_ms(lambda: step(lambda: flow.loss(x, cond, train=True)))
            t_got = _host_ms(lambda: step(lambda: pf.loss(pack(x), dict(
                cond, clean=pack(cond["clean"])), True)))
            reads[precision] = {"nll": float(got[0]), "nll_ref": float(ref[0]),
                                "of_tol": {"nll": nll, "sd_z": sdz, "state": st, "grads": worst},
                                "ms": t_got, "nhwc_ms": t_ref,
                                "grad_leaves": len(set(ref[3]) & set(got[3]))}
            print(f"packed flow b={PACKED_B} precision={precision}: NLL {float(got[0]):.4f} vs "
                  f"NoiseFlow.loss {float(ref[0]):.4f}; of their tolerances: NLL {nll:.3f}, "
                  f"sd_z {sdz:.3f}, new BN state {st:.3f}, gradients {worst:.3f} (worst of "
                  f"{reads[precision]['grad_leaves']} leaves); loss+backward {t_got:.3f} ms vs "
                  f"NHWC {t_ref:.3f} ms (host clock, {smi})")
        flow.zero_grad()
        out["packed"] = reads
        if any(v > 1 for v in reads["highest"]["of_tol"].values()) or fs.launch_counts or \
                not set(reads["highest"]) or reads["highest"]["grad_leaves"] < 40:
            raise AssertionError("PackedFlow disagrees with NoiseFlow.loss on the card")
    phase("packed flow: loss and gradients vs NoiseFlow.loss at b=138", packed)

    def tf_mapping():
        tf_vars = ti.export_reference_variables(nf.flow)
        flow = NoiseFlow((32, 32, 4), load_hps(os.path.join(MODEL, "hps.txt")),
                         device=nf.flow.device, seed=99)
        sd = ti.import_reference_variables(tf_vars, flow)
        want = nf.flow.state_dict()
        same = all(torch.equal(flow.state_dict()[k], v) for k, v in want.items()) and \
            set(sd) == set(want)
        x, cond = _train_batch(PACKED_B, seed=51)
        with torch.no_grad():
            a = float(flow.loss(x, cond, train=False)[0])
            b = float(nf.flow.loss(x, cond, train=False)[0])
        reading = "tensorflow installed: not tried"
        if importlib.util.find_spec("tensorflow") is None:
            try:
                ti.read_tf_checkpoint(os.path.join(SPATIAL_DIR, "none"))
                raise AssertionError("read a TF checkpoint without tensorflow")
            except ImportError as e:
                reading = f"ImportError: {e}"[:160]
        out["tf_import"] = {"variables": len(tf_vars), "same": same, "nll": (a, b)}
        print(f"tf importer: the flagship exported to {len(tf_vars)} reference variables and "
              f"imported back: state dict identical {same}, NLL {a!r} vs {b!r}; reading a TF "
              f"checkpoint here: {reading}")
        if not same or a != b or len(tf_vars) != 143:
            raise AssertionError("the flagship does not round trip through the importer")
    phase("tf importer: the flagship through import_reference_variables", tf_mapping)
    return out


# K steps a dispatch (phases 52-54): CUDA graphs of K train or eval steps
# (training.step_graph) at b = 138, K = 32, over 70 staged steps: 2 replays
# and a 6-step tail. A graph replays the kernels and ops of its eager steps,
# so each path's replays are held to 70 eager steps from the same state to
# the bit: every step's NLL and sd_z, the weights, the BN state, Adam's
# moments and step. cuDNN is held to deterministic algorithms there.
GRAPH_K, GRAPH_STEPS = 32, 70
GRAPH_TIMED = 32       # steps timed a turn: one replay, or 32 eager steps
GRAPH_SEED = 17
# (path, use_pallas, pallas_oneshot, pallas_train_dtype, arch; None: the flagship's)
GRAPH_PATHS = (("plain exact BN", False, True, "float32", None),
               ("one-shot f32", True, True, "float32", None),
               ("one-shot bf16", True, True, "bfloat16", None),
               ("segment path, 5-scale arch", True, False, "float32", FIVE_SCALE_ARCH))


def _graph_batches(n, seed):
    """n batches of TRAIN_B synthetic patches (``_train_batch``) as one host
    batch, as a loader's stream is staged."""
    x, cond = _train_batch(n * TRAIN_B, seed)
    host = {"_x": x, "_y": cond["clean"], **{k: cond[k] for k in ("nlf0", "nlf1", "iso", "cam")}}
    return [{k: v.cpu().numpy() for k, v in host.items()}]


def _graph_trainer(path, k, train, test):
    """A Trainer on ``path`` (a GRAPH_PATHS row) with steps_per_call k, from
    the flagship's weights (the 5-scale arch: from its seed), with ``train``
    and ``test`` staged."""
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.training.trainer import Trainer
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    _, use_pallas, oneshot, dtype, arch = path
    cfg = load_hps(os.path.join(MODEL, "hps.txt"))
    cfg.use_pallas, cfg.pallas_oneshot, cfg.pallas_train_dtype = use_pallas, oneshot, dtype
    cfg.steps_per_call, cfg.n_batch_train, cfg.n_batch_test = k, TRAIN_B, TRAIN_B
    if arch is not None:
        cfg.arch = arch
    flow = NoiseFlow((32, 32, 4), cfg, device="cuda", seed=cfg.seed)
    if arch is None:
        load_checkpoint(os.path.join(MODEL, "ckpt", "model.ckpt-best.npz"), flow)
    tr = Trainer(flow, cfg)
    if (tr.use_fused, tr.use_oneshot) != (use_pallas, use_pallas and oneshot):
        raise AssertionError(f"{path[0]}: use_fused {tr.use_fused}, use_oneshot {tr.use_oneshot}")
    if train is not None:
        tr.stage_dataset(iter(train), "train")
    if test is not None:
        tr.stage_dataset(iter(test), "test")
    return tr


def _run_state(tr):
    """Every tensor a run changes: the flow's state dict and the optimizer's
    slots, by name."""
    out = {f"flow/{k}": v for k, v in tr.flow.state_dict().items()}
    names = {p: n for n, p in tr.flow.named_parameters()}
    for p, st in tr.optimizer.state.items():
        for slot, v in st.items():
            out[f"opt/{names[p]}/{slot}"] = v
    return out


def _graph_diff(a, b):
    """(tensors that differ in any bit, the largest abs difference) between
    two runs' (nll, sd_z, state)."""
    import torch
    pairs = {"nll": (a[0], b[0]), "sd_z": (a[1], b[1])}
    sa, sb = a[2], b[2]
    if set(sa) != set(sb):
        return [f"keys {sorted(set(sa) ^ set(sb))}"], float("inf")
    pairs.update({k: (sa[k], sb[k]) for k in sb})
    bad = [k for k, (x, y) in pairs.items() if not torch.equal(x, y)]
    worst = max((float((x.float() - y.float()).abs().max()) for x, y in pairs.values()),
                default=0.0)
    return bad, worst


def _kernels_a_step(fn, steps):
    """Device kernels (and copies or sets) that ``fn`` runs, over ``steps``
    steps, by torch.profiler; None where it shows no device activity."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        return None
    mem = sum(1 for e in ev if e.name.startswith(("Memcpy", "Memset")))
    return {"kernels": (len(ev) - mem) / steps, "copies_sets": mem / steps}


def _graph_checks(phase, out):
    import numpy as np
    import torch
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.training import step_graph

    train = _graph_batches(GRAPH_STEPS, GRAPH_SEED)
    test = train     # the staged eval's set: the same patches, in order
    order = torch.as_tensor(np.random.default_rng(GRAPH_SEED).permutation(
        GRAPH_STEPS * TRAIN_B).reshape(GRAPH_STEPS, TRAIN_B), device="cuda")

    def run(path, k, test_set=None, plant=None):
        """GRAPH_STEPS staged train steps (eval steps with test_set): the
        trainer, (nll, sd_z) of each step, the state after, the launches."""
        tr = _graph_trainer(path, k, train, test_set)
        if plant:
            plant(tr)
        fs.launch_counts.clear()
        if test_set is None:
            nll, sd_z = tr._staged_steps("train", order, k, True)
        else:
            nll, sd_z = tr._staged_steps("test", tr._staged_test_steps(), k, False)
        torch.cuda.synchronize()
        counts = _main_path(dict(fs.launch_counts))
        return tr, (nll, sd_z, _run_state(tr)), counts

    def per_step(path, graph, evals=False):
        """The launches a run must count: each step's, and the warm-up
        steps' before a capture."""
        _, use_pallas, oneshot, dtype, _ = path
        if not use_pallas:
            return {}
        n = GRAPH_STEPS + (step_graph.WARMUP_STEPS if graph else 0)
        segs = 1 if path[4] == FIVE_SCALE_ARCH else 2
        if evals:
            want = {"fused_segment_forward": n * segs}
        elif oneshot:
            want = {"fused_train_step": n}
        else:
            want = {"fused_segment_train_forward": n * segs, "fused_segment_backward": n * segs}
        if dtype == "bfloat16":
            want.update({f"{k}_bf16": v for k, v in want.items()})
        return want

    def hold(label, path, evals=False):
        test_set = test if evals else None
        _, eager, c_e = run(path, 1, test_set)
        tr, graph, c_g = run(path, GRAPH_K, test_set)
        bad, worst = _graph_diff(graph, eager)
        want_e, want_g = per_step(path, False, evals), per_step(path, True, evals)
        group = [dict(g.launches) for g in tr._graphs.values()]
        print(f"graph {label}: {GRAPH_STEPS} steps b={TRAIN_B}, K={GRAPH_K} (2 replays, "
              f"{GRAPH_STEPS % GRAPH_K}-step tail) against {GRAPH_STEPS} eager steps: "
              f"{len(graph[2]) + 2} tensors, {len(bad)} differ in any bit (max abs "
              f"{worst:.3e}); NLL first {float(graph[0][0]):.4f} last "
              f"{float(graph[0][-1]):.4f}; launches graph run {c_g} (want {want_g}), eager "
              f"{c_e} (want {want_e}); a replay's launches {group}")
        if bad or c_g != want_g or c_e != want_e or len(tr._graphs) != 1:
            raise AssertionError(f"graph run differs from eager on {bad[:8]}, or launches "
                                 f"wrong, or {len(tr._graphs)} graphs")
        out["launches"][label] = c_g
        return tr

    def timed(tr, evals=False, turns=(1, GRAPH_K, GRAPH_K, 1)):
        """ms a step of GRAPH_TIMED steps, eager (k = 1) and graph in turns
        (host clock, synchronised)."""
        def once(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if evals:
                tr._staged_steps("test", tr._staged_test_steps()[:GRAPH_TIMED], k, False)
            else:
                tr._staged_steps("train", order[:GRAPH_TIMED], k, True)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / GRAPH_TIMED
        t = [once(k) for k in turns]
        eager, graph = [v for k, v in zip(turns, t) if k == 1], [
            v for k, v in zip(turns, t) if k != 1]
        return {"eager_ms": sum(eager) / len(eager) if eager else None,
                "graph_ms": sum(graph) / len(graph), "turns": t}

    def paths():
        for path in GRAPH_PATHS:
            tr = hold(path[0], path)
            out["ms"][path[0]] = timed(tr)
            g = next(iter(tr._graphs.values()))
            cnt = {"graph": _kernels_a_step(lambda: g.replay(), GRAPH_K),
                   "eager": _kernels_a_step(lambda: tr._staged_steps(
                       "train", order[:1], 1, True), 1)}
            out["kernels_a_step"][path[0]] = cnt
            print(f"graph {path[0]}: ms a step eager {out['ms'][path[0]]['eager_ms']:.3f}, "
                  f"graph {out['ms'][path[0]]['graph_ms']:.3f} (turns eager, graph, graph, "
                  f"eager: {['%.3f' % v for v in out['ms'][path[0]]['turns']]}; host clock, "
                  f"{GRAPH_TIMED} steps a turn); device kernels a step {cnt}")
            if not path[1]:
                # the plain path's convolutions also with cuDNN's default
                # algorithms, as it trains; a graph keeps the algorithms it
                # was captured with, so a new trainer captures anew
                label = path[0] + ", default cuDNN"
                torch.backends.cudnn.deterministic = False
                try:
                    tr = _graph_trainer(path, GRAPH_K, train, None)
                    tr._staged_steps("train", order[:GRAPH_K], GRAPH_K, True)
                    out["ms"][label] = timed(tr, turns=(GRAPH_K, GRAPH_K))
                finally:
                    torch.backends.cudnn.deterministic = True
                print(f"graph {label}: ms a step graph {out['ms'][label]['graph_ms']:.3f} "
                      f"(turns {['%.3f' % v for v in out['ms'][label]['turns']]})")
    phase(f"graphs: K={GRAPH_K} train steps a replay against eager steps, 4 paths", paths)

    def evals():
        path = GRAPH_PATHS[1]
        tr = hold("staged eval (fused, f32)", path, evals=True)
        ms = timed(tr, evals=True)
        t = {}
        for k in (1, GRAPH_K, GRAPH_K, 1):
            tr.cfg.steps_per_call = k
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr._eval_epoch_staged()
            t.setdefault(k, []).append((time.perf_counter() - t0) * 1e3)
        ms["epoch_ms"] = {"eager": sum(t[1]) / 2, "graph": sum(t[GRAPH_K]) / 2,
                          "steps": GRAPH_STEPS}
        out["ms"]["staged eval"] = ms
        print(f"graph staged eval: ms a step eager {ms['eager_ms']:.3f}, graph "
              f"{ms['graph_ms']:.3f}; the staged eval epoch ({GRAPH_STEPS} batches) eager "
              f"{ms['epoch_ms']['eager']:.2f} ms, graph {ms['epoch_ms']['graph']:.2f} ms")
    phase("graphs: the staged eval, K eval steps a replay against eager steps", evals)

    def host_batches():
        """train_epoch over host batches (the [K, B, ...] feed) against
        eager steps: the one-shot f32 path."""
        path = GRAPH_PATHS[1]
        runs = {}
        for k in (1, GRAPH_K):
            tr = _graph_trainer(path, k, None, None)
            nll = tr.train_epoch(({f: v[s * TRAIN_B:(s + 1) * TRAIN_B] for f, v in
                                   train[0].items()} for s in range(GRAPH_STEPS)),
                                 steps_per_call=k)
            runs[k] = (nll, _run_state(tr))
        bad = [n for n, v in runs[1][1].items() if not torch.equal(v, runs[GRAPH_K][1][n])]
        print(f"graph host batches (one-shot f32): train_epoch of {GRAPH_STEPS} batches, "
              f"K={GRAPH_K} against 1: epoch NLL {runs[GRAPH_K][0]} vs {runs[1][0]}; "
              f"{len(bad)} tensors differ")
        if bad or runs[1][0] != runs[GRAPH_K][0]:
            raise AssertionError(f"host-batch graph run differs from eager on {bad[:8]}")
    phase("graphs: train_epoch over host batches against eager steps", host_batches)

    def planted_faults():
        """The comparison must catch a replay whose index buffer is not
        refreshed, and BN state rebound instead of copied."""
        path = GRAPH_PATHS[1]
        _, eager, _ = run(path, 1)

        def stale(tr):
            replay = step_graph.StepGraph.replay
            step_graph.StepGraph.replay = lambda self, feed=None: replay(self, None)

        def rebound(tr):
            flow = tr.flow

            def apply_state(new_state):
                for key, v in new_state.items():
                    mod, name = key.rsplit(".", 1)
                    flow.get_submodule(mod)._buffers[name] = v.detach().clone()
            flow.apply_state = apply_state
        for name, plant in (("index buffer not refreshed", stale),
                            ("BN state rebound, not copied", rebound)):
            replay = step_graph.StepGraph.replay
            try:
                _, graph, _ = run(path, GRAPH_K, plant=plant)
            finally:
                step_graph.StepGraph.replay = replay
            bad, worst = _graph_diff(graph, eager)
            print(f"graph planted fault ({name}): {len(bad)} tensors differ (max abs "
                  f"{worst:.3e}), among them {bad[:4]}")
            if not bad:
                raise AssertionError(f"the comparison missed a planted fault: {name}")
    phase("graphs: planted faults are caught", planted_faults)


def _graph_phases(phase):
    """Phases 52-55 (see the module docstring), with cuDNN held to
    deterministic algorithms. Returns each path's launch counts of its graph
    run (kernels line), the times and the kernels a step."""
    import torch

    out = {"launches": {}, "ms": {}, "kernels_a_step": {}}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _graph_checks(phase, out)
    finally:
        torch.backends.cudnn.deterministic = det
    return out


# Phase 58: K train steps a dispatch under a mesh. Each rank captures its K
# steps with every all-reduce they issue as one CUDA graph (the nccl
# collectives recorded through parallel.distributed._all_reduce_), as XLA
# puts the gradient all-reduce inside JAX's sharded scan. (a) runs on any
# card: a one-rank nccl group (started here, ranks of their own process),
# the trainer's mesh step written out so that its collectives are issued on
# one rank (the trainer's own skip them there, as JAX's psum over one device
# is the identity): the plain exact-BN step (the BN sums forward and
# backward, then the flat all-reduce: 65 a step) and the one-shot step (its
# kernel, then the flat all-reduce of gradients, metrics and BN state: 1 a
# step), K = 4 a replay over 2 groups, against the same 8 steps eager from
# the same state. (b) needs two cards or more, as nccl takes one rank a
# card: cli.train --mesh N --steps_per_call 32 (N = the visible cards, at
# most 4) against the same N ranks at K = 1, 2 epochs of 70 steps at the
# multihost recipe's global batch of 276 on phase 39's corpus.
MESH_GRAPH_K1 = 4
MESH_GRAPH_K = 32
MESH_GRAPH_MAX_RANKS = 4
MESH_GRAPH_STEPS = 70            # an epoch at 276: 2 replays and a 6-step tail
MESH_GRAPH_EPOCHS = 2
# random patches an image: 4 train images x 4830 = 70 x 276
MESH_GRAPH_PATCHES = MESH_GRAPH_STEPS * PAR_B // 4
MESH_GRAPH_SPAWN_S = 600
MESH_GRAPH_DIR = os.path.join(ROOT, "build", "chip_smoke_mesh_graphs")
MESH_GRAPH_PATHS = (("plain exact BN", False), ("one-shot f32", True))


def _opt_state(flow, optimizer):
    """The flow's state dict and the optimizer's slots, by name, on the CPU."""
    out = {f"flow/{k}": v.detach().cpu().clone() for k, v in flow.state_dict().items()}
    names = {p: n for n, p in flow.named_parameters()}
    for p, st in optimizer.state.items():
        for slot, v in st.items():
            out[f"opt/{names[p]}/{slot}"] = v.detach().cpu().clone()
    return out


def _first_difference(a, b):
    """(step, name) of the first difference between two runs' (nll [n],
    sd_z [n], state); None where they are the same bits."""
    import torch
    for j in range(len(b["nll"])):
        for name in ("nll", "sd_z"):
            if not torch.equal(a[name][j], b[name][j]):
                return j, name
    for name, v in b["state"].items():
        if name not in a["state"] or not torch.equal(a["state"][name], v):
            return None, name
    return None


def _one_rank_capture(rank, device):
    """Part (a) of phase 58 in a one-rank nccl group: for the plain and the
    one-shot f32 step, 2 groups of K = 4 at b = 138 eager, as replays of one
    graph, and as replays with the graph's static input buffer rebound after
    capture (the planted fault: the captured BN all-reduces read the stale
    buffer)."""
    import torch
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.ops.fused_train import FusedTrainStep, pick_block
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.parallel.mesh import Mesh
    from noise_flow_tpu_torch.probes.mesh import set_deterministic
    from noise_flow_tpu_torch.training.step_graph import StepGraph
    from noise_flow_tpu_torch.training.trainer import batch_to_cond, make_optimizer
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    torch.cuda.set_device(device)
    set_deterministic(PAR_DETERMINISM)
    k, b = MESH_GRAPH_K1, TRAIN_B
    groups = []
    for gi in range(2):
        x, cond = _train_batch(k * b, GRAPH_SEED + gi)
        groups.append({"_x": x.reshape(k, b, 32, 32, 4),
                       "_y": cond["clean"].reshape(k, b, 32, 32, 4),
                       **{n: cond[n].reshape(k, b) for n in ("nlf0", "nlf1", "iso", "cam")}})

    def at(feed, j):
        return {n: v[j] for n, v in feed.items()}

    def run(oneshot, graph, plant=None):
        cfg = load_hps(os.path.join(MODEL, "hps.txt"))
        flow = NoiseFlow(cfg.x_shape, cfg, device=device, seed=cfg.seed)
        load_checkpoint(PAR_INIT, flow)
        opt = make_optimizer(cfg, list(flow.parameters()))
        fstep = FusedTrainStep(flow, bt=pick_block(b, target=64, stretch=8),
                               mm_dtype="float32") if oneshot else None

        def psum(t):
            return pd._AllReduceSum.apply(t, None)

        def step(batch):
            """Trainer.train_step under a mesh, its collectives issued."""
            if oneshot:
                nll, sd_z, new_state = fstep.loss(batch["_x"], batch_to_cond(batch))
            else:
                nll, sd_z, new_state = flow.loss(batch["_x"], batch_to_cond(batch), train=True,
                                                 psum=psum)
            opt.zero_grad(set_to_none=True)
            nll.backward()
            metrics = torch.stack([nll.detach(), sd_z.detach()])
            tensors = [p.grad for p in flow.parameters() if p.grad is not None] + [metrics] + (
                list(new_state.values()) if oneshot else [])
            flat = pd._all_reduce_(torch.cat([t.detach().reshape(-1) for t in tensors]), None)
            off = 0
            with torch.no_grad():
                for t in tensors:
                    t.copy_(flat[off:off + t.numel()].view_as(t))
                    off += t.numel()
            opt.step()
            flow.apply_state(new_state)
            return metrics[0], metrics[1]

        fs.launch_counts.clear()
        pd.collective_stats["calls"] = 0
        nll, sd_z, per_replay, g = [], [], [], None
        if graph:
            g = StepGraph(step, {n: v.clone() for n, v in groups[0].items()}, at, k, flow, opt,
                          Mesh(1, 0, device))
            if plant:
                plant(g)
            for grp in groups:
                before = pd.collective_stats["calls"]
                n_, s_ = g.replay(grp)
                per_replay.append(pd.collective_stats["calls"] - before)
                nll.append(n_)
                sd_z.append(s_)
        else:
            for grp in groups:
                for j in range(k):
                    n_, s_ = step(at(grp, j))
                    nll.append(n_.reshape(1))
                    sd_z.append(s_.reshape(1))
        torch.cuda.synchronize()
        return {"nll": torch.cat(nll).cpu(), "sd_z": torch.cat(sd_z).cpu(),
                "state": _opt_state(flow, opt), "collectives": pd.collective_stats["calls"],
                "per_replay": per_replay, "captured": g.collectives if g else None,
                "launches": dict(fs.launch_counts),
                "replay_launches": dict(g.launches) if g else None,
                "n_bn": sum(key.endswith(".mean") for key in flow.state_dict())}

    def rebound(g):
        g.feed["_x"] = g.feed["_x"].clone()
    out = {}
    for name, oneshot in MESH_GRAPH_PATHS:
        out[name] = {"eager": run(oneshot, False), "graph": run(oneshot, True)}
    out["fault"] = run(False, True, rebound)
    set_deterministic("off")
    return out


def _mesh_cli_rank(rank, device, argv):
    """A rank of part (b): cli.train's main in the group of --mesh N on its
    card; each train epoch's steps (nll, sd_z) and seconds, the state after,
    the launches and all-reduces, the graphs' per-replay counts."""
    import torch
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.probes.mesh import set_deterministic
    from noise_flow_tpu_torch.training.trainer import Trainer

    set_deterministic(PAR_DETERMINISM)
    kept = {"epochs": []}
    real = Trainer.train_epoch

    def keep(self, *a, **kw):
        _sync(device)
        t0 = time.perf_counter()
        out = real(self, *a, **kw)
        kept["epochs"].append((time.perf_counter() - t0, [t.cpu() for t in self.epoch_steps]))
        kept["trainer"] = self
        return out
    Trainer.train_epoch = keep
    fs.launch_counts.clear()
    pd.collective_stats["calls"] = 0
    try:
        rc = cli_train.main(argv + ["--device", str(device)])
    finally:
        Trainer.train_epoch = real
        set_deterministic("off")
    tr = kept["trainer"]
    return {"rc": rc, "graphs_on": tr.graphs_on,
            "nll": torch.cat([e[1][0] for e in kept["epochs"]]),
            "sd_z": torch.cat([e[1][1] for e in kept["epochs"]]),
            "epoch_s": [e[0] for e in kept["epochs"]],
            "steps": [len(e[1][0]) for e in kept["epochs"]],
            "state": _opt_state(tr.flow, tr.optimizer), "launches": dict(fs.launch_counts),
            "n_bn": sum(key.endswith(".mean") for key in tr.flow.state_dict()),
            "collectives": pd.collective_stats["calls"],
            "graphs": [{"key": list(key), "launches": dict(g.launches),
                        "collectives": g.collectives} for key, g in tr._graphs.items()]}


def _mesh_graph_phases(phase, flagship, smi):
    """Phase 58 (see the module docstring): (a) on one card, (b) on 2-4
    cards where visible, (c) the line that says whether (b) ran. Returns
    each kernel's per-rank launches of (b) and its times, for the kernels
    line."""
    import torch
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.probes import mesh as pm
    from noise_flow_tpu_torch.training import step_graph

    out = {"launches": {}, "ms": {}, "ranks": 0, "one_rank": None}

    def hold(label, got, ref):
        """Bits, or the first difference and phase 46's tolerances."""
        first = _first_difference(got, ref)
        if first is None:
            return "the same bits"
        d = float((got["nll"] - ref["nll"]).abs().max() / ref["nll"].abs().max())
        flow_got = {k[5:]: v for k, v in got["state"].items() if k.startswith("flow/")}
        flow_ref = {k[5:]: v for k, v in ref["state"].items() if k.startswith("flow/")}
        ratio, _, key = pm.weights_agreement(flow_got, flow_ref)
        msg = (f"first difference at step {first[0]} in {first[1]}; NLL max rel {d:.3e} (tol "
               f"{PAR_NLL_RTOL}); weights {ratio:.3f} of probes.mesh.PARAM_TOL ({key})")
        if d > PAR_NLL_RTOL or ratio > 1.0:
            raise AssertionError(f"{label}: {msg}")
        return msg

    def one_rank():
        (r,) = pd.spawn_ranks(1, _one_rank_capture, (), "cuda:0", "nccl",
                              timeout=MESH_GRAPH_SPAWN_S)
        k = MESH_GRAPH_K1
        for name, oneshot in MESH_GRAPH_PATHS:
            eager, graph = r[name]["eager"], r[name]["graph"]
            per_step = 1 if oneshot else 4 * eager["n_bn"] + 1
            read = hold(f"(a) {name}", graph, eager)
            want_launch = {"fused_train_step": step_graph.WARMUP_STEPS + 2 * k} if oneshot else {}
            print(f"mesh graphs (a) {name}: one-rank nccl group on cuda:0, b={TRAIN_B}, K={k}, "
                  f"2 replays against {2 * k} eager steps: {read}; collectives a replay "
                  f"{graph['per_replay']} (captured {graph['captured']}, want {k * per_step}), "
                  f"eager {eager['collectives']} ({per_step} a step); launches graph "
                  f"{graph['launches']} (a replay {graph['replay_launches']}), eager "
                  f"{eager['launches']}")
            if graph["per_replay"] != [k * per_step] * 2 or graph["captured"] != k * per_step or \
                    eager["collectives"] != 2 * k * per_step or \
                    graph["collectives"] != (step_graph.WARMUP_STEPS + 2 * k) * per_step:
                raise AssertionError(f"(a) {name}: collective counts")
            if {n: v for n, v in graph["launches"].items() if v} != want_launch:
                raise AssertionError(f"(a) {name}: launches {graph['launches']}")
            if oneshot:
                out["one_rank"] = {"launches": graph["launches"]["fused_train_step"],
                                   "per_replay": graph["replay_launches"]["fused_train_step"],
                                   "k": k, "collectives_per_replay": graph["per_replay"][0]}
        fault = r["fault"]
        first = _first_difference(fault, r[MESH_GRAPH_PATHS[0][0]]["eager"])
        print(f"mesh graphs (a) planted fault (the static input buffer rebound after capture): "
              f"first difference {first}")
        if first is None:
            raise AssertionError("the comparison missed the rebound input buffer")
    phase("mesh graphs (a): K steps with their nccl all-reduces captured, one-rank group",
          one_rank)

    cards = torch.cuda.device_count()
    n = min(cards, MESH_GRAPH_MAX_RANKS)
    if n < 2:
        why = f"{cards} card visible; nccl takes one rank a card"
        print(f"mesh graphs (b): did not run: {why}")
        out["not_run"] = why
        return out

    def cli_runs():
        root = flagship["root"]
        shutil.rmtree(MESH_GRAPH_DIR, ignore_errors=True)
        out["ranks"] = n
        for name, oneshot in MESH_GRAPH_PATHS:
            runs = {}
            for k in (1, MESH_GRAPH_K):
                argv = ["--n_batch_train", str(PAR_B), "--n_batch_test", str(PAR_B),
                        "--patch_height", "32", "--patch_sampling", "random",
                        "--n_patches_per_image", str(MESH_GRAPH_PATCHES),
                        "--epochs", str(MESH_GRAPH_EPOCHS), "--sidd_path", root,
                        "--init_checkpoint", PAR_INIT, "--mesh", str(n),
                        "--steps_per_call", str(k),
                        "--logdir", os.path.join(MESH_GRAPH_DIR, f"{oneshot:d}_{k}")] + (
                    ["--use_pallas", "--pallas_train_dtype", "float32"] if oneshot else [])
                t0 = time.time()
                runs[k] = pd.spawn_ranks(n, _mesh_cli_rank, (argv,), "cuda", "nccl",
                                         timeout=MESH_GRAPH_SPAWN_S)
                runs[k + 0.5] = time.time() - t0
            eager, graph = runs[1], runs[MESH_GRAPH_K]
            per_step = 1 if oneshot else 4 * graph[0]["n_bn"] + 1
            for r in eager + graph:
                if r["rc"] != 0 or r["steps"] != [MESH_GRAPH_STEPS] * MESH_GRAPH_EPOCHS:
                    raise AssertionError(f"(b) {name}: rc {r['rc']}, steps {r['steps']}")
            reads = [hold(f"(b) {name} rank {i}", g, e)
                     for i, (g, e) in enumerate(zip(graph, eager))]
            same = all(_first_difference(g, graph[0]) is None for g in graph[1:])
            ms = {"eager": [e["epoch_s"][-1] / MESH_GRAPH_STEPS * 1e3 for e in eager],
                  "graph": [g["epoch_s"][-1] / MESH_GRAPH_STEPS * 1e3 for g in graph]}
            out["ms"][name] = ms
            replays = [[dict(g_["launches"]) for g_ in r["graphs"]] for r in graph]
            coll = [[g_["collectives"] for g_ in r["graphs"]] for r in graph]
            print(f"mesh graphs (b) {name}: cli.train --mesh {n} --steps_per_call "
                  f"{MESH_GRAPH_K} against K=1, {MESH_GRAPH_EPOCHS} epochs of {MESH_GRAPH_STEPS}"
                  f" steps at {PAR_B} ({PAR_B // n} a rank; {runs[MESH_GRAPH_K + 0.5]:.1f} s "
                  f"and {runs[1.5]:.1f} s): graph against eager by rank {reads}; ranks' graph "
                  f"runs the same bits: {same}; graphs_on {[r['graphs_on'] for r in graph]}; "
                  f"ms a step (epoch 2, host clock, input included) by rank eager "
                  f"{['%.3f' % v for v in ms['eager']]}, graph "
                  f"{['%.3f' % v for v in ms['graph']]}; a replay's launches by rank "
                  f"{replays}, its all-reduces {coll}; launches by rank graph "
                  f"{[r['launches'] for r in graph]}, eager {[r['launches'] for r in eager]}; "
                  f"all-reduces by rank graph {[r['collectives'] for r in graph]}, eager "
                  f"{[r['collectives'] for r in eager]}; {smi}")
            if not same or not all(r["graphs_on"] for r in graph) or \
                    any(len(r["graphs"]) != 1 for r in graph):
                raise AssertionError(f"(b) {name}: ranks differ, graphs off, or not one graph")
            want = {"fused_train_step": MESH_GRAPH_K} if oneshot else {}
            if any(r != [want] for r in replays) or \
                    any(c != [MESH_GRAPH_K * per_step] for c in coll):
                raise AssertionError(f"(b) {name}: a replay's launches {replays}, "
                                     f"all-reduces {coll}")
            if oneshot:
                out["launches"]["fused_train_step"] = [
                    r["launches"]["fused_train_step"] for r in graph]
            elif any(r["launches"] for r in graph + eager):
                raise AssertionError(f"(b) {name}: the exact-BN path launched kernels")
        shutil.rmtree(MESH_GRAPH_DIR, ignore_errors=True)
    phase(f"mesh graphs (b): cli.train --mesh {n} --steps_per_call {MESH_GRAPH_K} against "
          f"K=1, plain and one-shot", cli_runs)
    print(f"mesh graphs (b): ran on {n} cards")
    return out


# Phase 59: the kernel-path training recipe (cli.flagship --recipe ghost:
# jobs/job_noise_flow.sh prod-synth-scale's flags, the one-shot step and the
# running-BN eval forward in bfloat16, K = 32) through cli.train at a cut of
# scale on phase 39's corpus: random patches, 70 train steps an epoch at b =
# 138 (2 replays and a 6-step tail) and 35 test batches (a replay and a
# 3-step tail), 2 epochs; at K = 32 against K = 1, and a planted fault.
GHOST_EPOCHS = 2
GHOST_STEPS = 70
GHOST_DIR = os.path.join(ROOT, "build", "chip_smoke_ghost")
GHOST_TIMED = 32       # steps timed a turn: one replay, or 32 eager steps


def _ghost_recipe_phase(phase, flagship):
    """Phase 59 (see the module docstring). Returns the graph run's launches
    of the bf16 step and eval forward and their ms a step, for the kernels
    line."""
    import torch
    from noise_flow_tpu_torch.cli import flagship as fl
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.ops import fused_train as ft
    from noise_flow_tpu_torch.training import step_graph
    from noise_flow_tpu_torch.training.trainer import Trainer

    out = {"launches": {}, "ms": {}}
    images = 2 * 2                                  # phase 39's train scenes, 2 images each
    per_image = GHOST_STEPS * TRAIN_B // images

    def run(k, name):
        """cli.train --recipe ghost's flags at K = k: each staged group's
        (split, nll, sd_z), the trainer, its state after, the launches, the
        logdir."""
        kept = {"steps": []}
        real_steps, real_fit = Trainer._staged_steps, Trainer.fit

        def steps(self, split, order, kk, train):
            nll, sd_z = real_steps(self, split, order, kk, train)
            kept["steps"].append((split, nll.clone(), sd_z.clone()))
            return nll, sd_z

        def fit(self, *a, **kw):
            kept["trainer"] = self
            return real_fit(self, *a, **kw)
        logdir = os.path.join(GHOST_DIR, name)
        argv = fl.RECIPES["ghost"].flags + [
            "--steps_per_call", str(k), "--epochs", str(GHOST_EPOCHS),
            "--patch_sampling", "random", "--n_patches_per_image", str(per_image),
            "--sidd_path", flagship["root"], "--logdir", logdir, "--device", "cuda"]
        Trainer._staged_steps, Trainer.fit = steps, fit
        fs.launch_counts.clear()
        t0 = time.time()
        try:
            if cli_train.main(argv) != 0:
                raise AssertionError(f"cli.train --recipe ghost K={k} failed")
        finally:
            Trainer._staged_steps, Trainer.fit = real_steps, real_fit
        torch.cuda.synchronize()
        counts = dict(fs.launch_counts)
        tr = kept["trainer"]
        state = {n: v.clone() for n, v in _run_state(tr).items()}
        return {"steps": kept["steps"], "tr": tr, "state": state, "counts": counts,
                "logdir": logdir, "s": time.time() - t0}

    def differing(a, b):
        """Names of the groups (split and index) and tensors that differ."""
        bad = [f"{sa}{i}" for i, ((sa, na, za), (sb, nb, zb)) in enumerate(
            zip(a["steps"], b["steps"])) if sa != sb or not (torch.equal(na, nb) and
                                                            torch.equal(za, zb))]
        if len(a["steps"]) != len(b["steps"]):
            bad.append("groups")
        return bad + [n for n in a["state"] if not torch.equal(a["state"][n], b["state"][n])]

    def eval_steps(tr, k):
        return tr._staged_steps("test", tr._staged_test_steps(), k, False)

    def ghost():
        shutil.rmtree(GHOST_DIR, ignore_errors=True)
        det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            eager = run(1, "eager")
            graph = run(GRAPH_K, "graph")
            main = _main_path(graph["counts"])
            tr = graph["tr"]
            # the eval graph, captured at epoch 1 before any training, replayed
            # now, after epoch 2's train groups, against eager eval on these
            # buffers, and against epoch 2's eval
            replayed = eval_steps(tr, GRAPH_K)
            fresh = eval_steps(tr, 1)
            epoch2 = [n for split, n, _ in graph["steps"] if split == "test"][-1]
            replay_same = all(torch.equal(a, b) for a, b in zip(replayed, fresh))
            moved = not torch.equal(replayed[0], epoch2)
            real = ft.FusedFlow.running_moments
            kept = {}

            def stale(self, lo, hi):
                if (lo, hi) not in kept:
                    kept[(lo, hi)] = real(self, lo, hi).clone()
                return kept[(lo, hi)]
            ft.FusedFlow.running_moments = stale
            try:
                planted = run(GRAPH_K, "planted")
            finally:
                ft.FusedFlow.running_moments = real
            planted_bad = [b for b in differing(planted, eager) if b.startswith("test")]
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        bad = differing(graph, eager)
        # every column but the times (and the sample rows' KLDs, whose
        # histograms sum in no fixed order)
        cols = {"train": ("epoch", "NLL", "sdz"), "test": ("epoch", "NLL", "sdz", "msg"),
                "sample": ("epoch", "NLL", "sdz")}
        rows_same = {r: [[x[c] for c in cs] for x in fl.read_tsv(os.path.join(
            graph["logdir"], f"{r}.txt"))] == [[x[c] for c in cs] for x in fl.read_tsv(
            os.path.join(eager["logdir"], f"{r}.txt"))] for r, cs in cols.items()}
        graphs = {key[0]: dict(g.launches) for key, g in tr._graphs.items()}
        n_test = int(tr._staged_test["_x"].shape[0]) // TRAIN_B
        warm = step_graph.WARMUP_STEPS
        want = {"fused_train_step": GHOST_EPOCHS * GHOST_STEPS + warm,
                "fused_segment_forward": 2 * (GHOST_EPOCHS * (n_test + 1) + warm)}
        want.update({f"{k}_bf16": v for k, v in list(want.items())})
        want_replay = {"staged_train": {"fused_train_step": GRAPH_K,
                                        "fused_train_step_bf16": GRAPH_K},
                       "staged_test": {"fused_segment_forward": 2 * GRAPH_K,
                                       "fused_segment_forward_bf16": 2 * GRAPH_K}}
        out["launches"] = main
        out["replay"] = graphs

        def turns(fn):
            t = []
            for k in (1, GRAPH_K, GRAPH_K, 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(k)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3 / GHOST_TIMED)
            return {"eager_ms": (t[0] + t[3]) / 2, "graph_ms": (t[1] + t[2]) / 2, "turns": t}
        order = torch.arange(GHOST_TIMED * TRAIN_B, device="cuda").reshape(GHOST_TIMED, TRAIN_B)
        out["ms"] = {
            "train": turns(lambda k: tr._staged_steps("train", order, k, True)),
            "eval": turns(lambda k: tr._staged_steps("test", tr._staged_test_steps()[
                :GHOST_TIMED], k, False))}
        print(f"ghost recipe: cli.train --recipe ghost's flags (one-shot step and eval forward "
              f"in bf16, bt {tr._step_for_batch(TRAIN_B).bt}), {GHOST_EPOCHS} epochs of "
              f"{GHOST_STEPS} steps at b={TRAIN_B} and {n_test} test batches on phase 39's "
              f"corpus ({per_image} random patches an image), K={GRAPH_K} against K=1 "
              f"({graph['s']:.1f} s and {eager['s']:.1f} s): {len(bad)} of "
              f"{len(graph['steps'])} groups and {len(graph['state'])} tensors differ "
              f"{bad[:6]}; rows the same {rows_same}; the eval graph (captured at epoch 1) "
              f"replayed after epoch 2's train groups against eager eval on those buffers: "
              f"the same bits {replay_same}, moved from epoch 2's eval {moved}; planted fault "
              f"(the eval graph fed running moments kept from its capture): eval groups "
              f"differing {planted_bad}; launches graph run {main} (want {want}), eager run "
              f"{eager['counts']}; a replay's launches {graphs}; ms a step eager / graph "
              f"(host clock, {GHOST_TIMED} steps a turn) train {out['ms']['train']['eager_ms']:.3f}"
              f" / {out['ms']['train']['graph_ms']:.3f}, bf16 eval "
              f"{out['ms']['eval']['eager_ms']:.3f} / {out['ms']['eval']['graph_ms']:.3f}")
        if bad or not all(rows_same.values()) or not replay_same or not moved:
            raise AssertionError(f"graph against eager: {bad[:8]}, rows {rows_same}, "
                                 f"replay {replay_same}, moved {moved}")
        if not planted_bad:
            raise AssertionError("the comparison missed the planted stale running moments")
        if main != want or graphs != want_replay or not all(main.get(k) for k in want):
            raise AssertionError(f"launches {main} (want {want}), a replay's {graphs}")
        shutil.rmtree(GHOST_DIR, ignore_errors=True)
    phase("ghost recipe: bf16 one-shot train and eval graphs against eager, cli.train", ghost)
    return out


# Phase 56: the DnCNN four-source comparison (cli.dncnn_comparison) at a cut
# of scale. The corpus: all 78 scene instances (the test split's 44 image
# tuples give the 40 validation images, the ISO exclusion's indices up to
# 38) at 512x2496 Bayer, an eighth of the full frame's area: 80 patches an
# image, 4,480 train patches, 35 steps of b = 128 an epoch. Validation
# blocks of 64x64. The DnCNN at the JAX script's width (depth 9, 32 filters), lr
# 1e-3. From its random weights a DnCNN stays below the noisy input's PSNR
# for its first several hundred Adam steps (one epoch of the full corpus,
# 422 steps, is not enough), so the phase takes 30 epochs, the most that the
# schedule keeps at its first lr: 1,050 steps a source.
CMP_BAYER, CMP_BLOCK, CMP_EPOCHS = (512, 2496), 64, 30


def _dncnn_comparison_phase(phase):
    """Phase 56 (see the module docstring): the comparison's CLI at a cut of
    scale, the noisy input's PSNR against numpy, the NF source's sampler
    launches against its steps, each source above the noisy input. Returns
    the main path's sampler launches and the results, for the kernels
    line."""
    import numpy as np
    from scipy.io import loadmat
    from noise_flow_tpu_torch.cli import dncnn_comparison, make_sidd_scale
    from noise_flow_tpu_torch.cli.test_dncnn import EXCLUDED_ISO_IMAGES
    from noise_flow_tpu_torch.ops import fused_sample as fs

    work = os.path.join(ROOT, "build", "dncnn_comparison_smoke")

    def comparison():
        shutil.rmtree(work, ignore_errors=True)
        root = os.path.join(work, "SIDD_Medium_Raw_synth", "Data")
        val, out = os.path.join(work, "val"), os.path.join(work, "out")
        h, w = CMP_BAYER
        t0 = time.time()
        make_sidd_scale.main(["--root", root, "--height", str(h), "--width", str(w),
                              "--mat_version", "v5"])
        dncnn_comparison.build_validation_blocks(root, val, size=CMP_BLOCK)
        t_data = time.time() - t0
        fs.launch_counts.clear()
        t0 = time.time()
        rc = dncnn_comparison.main(["--data_root", root, "--val_dir", val, "--out", out,
                                    "--epochs", str(CMP_EPOCHS), "--device", "cuda"])
        t_run = time.time() - t0
        counts = _main_path(dict(fs.launch_counts))
        with open(os.path.join(out, "results.json")) as f:
            res = json.load(f)
        r = res["results"]
        # the noisy input's PSNR from the .mat files, in numpy
        noisy, gt = (np.delete(loadmat(os.path.join(val, f"Validation{k}BlocksRaw.mat"))[
            f"Validation{k}BlocksRaw"], EXCLUDED_ISO_IMAGES, axis=0).astype(np.float64)
            for k in ("Noisy", "Gt"))
        base = float(np.mean(10 * np.log10(1 / np.mean((noisy - gt) ** 2, axis=(2, 3)))))
        nf = r["nf"]
        print(f"dncnn comparison: 78 scenes of {h}x{w} Bayer and {CMP_BLOCK}x{CMP_BLOCK} "
              f"blocks in {t_data:.1f} s; {res['n_train_patches']} train patches, blocks "
              f"{res['val_blocks']}, {CMP_EPOCHS} epochs in {t_run:.1f} s (rc {rc}); noisy input "
              f"{r['noisy_input']['psnr']:.4f} dB (numpy {base:.4f}), SSIM "
              f"{r['noisy_input']['ssim']:.4f}; " + "; ".join(
                  f"{s} {r[s]['psnr']:.4f} dB / {r[s]['ssim']:.4f}, "
                  f"{r[s]['fit_s'] / r[s]['steps'] * 1e3:.3f} ms a step (host clock)"
                  for s in dncnn_comparison.SOURCES)
              + f"; sampler launches {counts} ({nf['steps']} NF steps); {res['device']}")
        if rc != 0 or res["val_blocks"] != [20, 8, CMP_BLOCK, CMP_BLOCK]:
            raise AssertionError(f"rc {rc}, blocks {res['val_blocks']}")
        if abs(r["noisy_input"]["psnr"] - base) > 1e-9 * base:
            raise AssertionError(f"noisy input {r['noisy_input']['psnr']} dB, numpy {base}")
        if not (counts.get("fused_sample_rng", 0) == counts.get("fused_sample", 0)
                == nf["sampler_launches"] == nf["steps"] > 0):
            raise AssertionError(f"NF: {nf['steps']} steps, sampler launches {counts}")
        below = [s for s in dncnn_comparison.SOURCES
                 if not r[s]["psnr"] > r["noisy_input"]["psnr"]]
        if below:
            raise AssertionError(f"PSNR not above the noisy input's: {below}")
        shutil.rmtree(work, ignore_errors=True)
        return {"launches": nf["sampler_launches"], "results": r}
    return phase("dncnn comparison: four sources at a cut of scale", comparison)


# the kernels line's (kernel, mode) by the production rows of
# _production_times that time its calls; and the redesign rows (phase 33) by
# (kernel, mode, kind, launches a call: both segments are two launches)
PRODUCTION_MODES = {("fused_sample", "eps"): ("eps", "eps_frame"),
                    ("fused_sample", "rng"): ("rng",),
                    ("fused_sample", "eps_bf16"): ("eps_bf16",),
                    ("fused_sample", "rng_bf16"): ("rng_8192_bf16",),
                    ("fused_segment_forward", "running"): ("eval",),
                    ("fused_segment_forward", "running_bf16"): ("eval_bf16",)}
DESIGN_MODES = (("fused_train_step", None, "step", 1), ("fused_train_step", "bf16", "step", 1),
                ("fused_segment_backward", None, "segment_backward", 2),
                ("fused_segment_backward", "bf16", "segment_backward", 2),
                ("fused_segment_forward", "ghost", "ghost_forward", 2),
                ("fused_segment_forward", "ghost_bf16", "ghost_forward", 2))


def _rank(kernels, production, designs, serve_calls):
    """The redesign ranking: for each kernel and mode with main-path
    launches, the sum over the shapes of its calls of calls x (device ms a
    call - bound a call), each call at the time measured at its own shape.
    The sampler's eps calls are the serve phase's (``serve_calls``: five
    requests at b = 138, the frame at b = FRAME_B); the other modes' calls
    are their main-path launches over the launches a call of their one row
    (the sampler's RNG mode at b = 128, the DnCNN_NF step; make_sampler's
    bf16 at b = 8192; the train kernels at b = 138, bt = 69). Raises
    ValueError where the calls do not account for the launches. Each
    production row also goes into its mode's entry under device_ms, by
    shape. Sorted, largest first."""
    by_name = {k["name"]: k for k in kernels}
    ranks = []

    def mode_entry(kernel, mode):
        return by_name[kernel] if mode is None else by_name[kernel].get("by_mode", {}).get(mode)

    def add(kernel, mode, parts):
        """parts: (row, calls, launches a call) of each shape the mode ran at."""
        m = mode_entry(kernel, mode)
        if m is None or not m.get("launches"):
            return
        if sum(c * n for _, c, n in parts) != m["launches"]:
            raise ValueError(f"the rank's calls of {kernel} {mode} do not make its "
                             f"{m['launches']} main-path launches: {parts}")
        rows = [{"shape": r["shape"], "calls": c, "ms": r["ms"], "bound_ms": r["bound_ms"],
                 "rank_ms": c * (r["ms"] - r["bound_ms"])} for r, c, _ in parts]
        ranks.append({"kernel": kernel, "mode": mode or "float32", "launches": m["launches"],
                      "parts": rows, "rank_ms": sum(r["rank_ms"] for r in rows)})

    def one_shape(kernel, mode, row, per_call):
        """A mode whose main-path calls all run at the row's shape."""
        launches = (mode_entry(kernel, mode) or {}).get("launches") or 0
        add(kernel, mode, [(row, launches // per_call, per_call)])
    for (kernel, mode), keys in PRODUCTION_MODES.items():
        rows = {k: production[k] for k in keys if k in production}
        if len(rows) != len(keys):
            continue
        (mode_entry(kernel, mode) or {})["device_ms"] = {r["shape"]: r["ms"] for r in rows.values()}
        if kernel == "fused_sample" and mode == "eps":
            add(kernel, mode, [(r, serve_calls.get(k, 0), r["launches_a_call"])
                               for k, r in rows.items()])
        else:
            (row,) = rows.values()
            one_shape(kernel, mode, row, row["launches_a_call"])
    for kernel, mode, kind, per_call in DESIGN_MODES:
        row = designs.get((kind, "bfloat16" if mode and "bf16" in mode else "float32", 69))
        if row is not None:
            one_shape(kernel, mode, dict(row, shape="b=138, bt=69"), per_call)
    return sorted(ranks, key=lambda r: -r["rank_ms"])


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from noise_flow_tpu_torch.ops import _build
    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    t_start = time.time()

    def phase(name, fn):
        t0 = time.time()
        try:
            out = fn()
            print(f"[phase] {name}: ok ({time.time() - t0:.1f} s)", flush=True)
            return out
        except Exception:  # a failed phase fails the run; go on to report the rest
            failures.append(name)
            print(f"[phase] {name}: FAILED", flush=True)
            traceback.print_exc()
            return None

    smi = _smi()
    print(smi, flush=True)

    def build():
        t0 = time.time()
        _build.build_all()
        print(f"build_seconds {time.time() - t0:.2f}")
        for name in _build.build_logs:
            for k in _build.kernel_resources(name):
                print(f"ptxas[{name}] {k['kernel']}: {k.get('registers')} registers, spill "
                      f"{k['spill_stores']} B stores / {k['spill_loads']} B loads, "
                      f"{k.get('smem')} B smem")
    phase("build kernels", build)

    nf = phase("load wrapper", lambda: NoiseFlowWrapper(
        MODEL, sampling_temperature=TEMP, device="cuda"))
    if nf is None:
        print("chip_smoke: failed phases: load wrapper", file=sys.stderr)
        return 1
    programs = {"batch": nf._program,
                "running": fs.build_sample_program(nf.flow, bn_mode="running")}

    errs = {}

    def agree(label, k, p, tol=TOL):
        """Hold kernel output k against plain output p; print and return
        (agrees, max abs error)."""
        torch.cuda.synchronize()
        atol, rtol = tol
        d = (k - p).abs()
        max_abs = float(d.max())
        max_rel = float((d / p.abs().clamp_min(1e-6)).max())
        ok = bool(torch.isfinite(k).all()) and bool((d <= atol + rtol * p.abs()).all())
        print(f"compare {label}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
              f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'DISAGREES'}")
        return ok, max_abs

    def compare(mode, b):
        prog = programs[mode]
        x, clean, sa, sb = _inputs(prog, b, seed=b)
        bt = fs.bn_block(b)
        k = fs.fused_sample_chain(prog, x, clean, sa, sb, bt)
        p = fs.sample_chain_reference(prog, x, clean, sa, sb, bt)
        ok, errs[(mode, b)] = agree(f"bn={mode} b={b} bt={bt}", k, p)
        if not ok:
            raise AssertionError(f"kernel disagrees with plain at bn={mode} b={b}")

    for mode in ("batch", "running"):
        for b in BATCHES:
            phase(f"kernel vs plain bn={mode} b={b}", lambda m=mode, b=b: compare(m, b))

    def planted_faults():
        """The comparison above must catch a wrong kernel: run the kernel
        wrongly on purpose, each time against the right plain output; every
        wrong run goes through the cooperative batch-BN launch."""
        b = BATCHES[0]

        def variant(prog, **fields):
            v = copy.copy(prog)
            for name, value in fields.items():
                setattr(v, name, value)
            v.ops_code = [kind << 8 | idx for kind, idx in v.ops]
            return v

        batch, running = programs["batch"], programs["running"]
        skip = next(i for i, (kind, _) in enumerate(batch.ops) if kind == fs.OP_COUPLING)
        faults = (
            ("BN groups halved", batch, batch, b // 2),
            ("BN mode swapped", running, variant(running, bn_mode="batch"), b),
            ("a coupling skipped", batch,
             variant(batch, ops=batch.ops[:skip] + batch.ops[skip + 1:]), b),
        )
        for name, right, wrong, bt in faults:
            x, clean, sa, sb = _inputs(right, b, seed=b)
            p = fs.sample_chain_reference(right, x, clean, sa, sb, b)
            before = fs.launch_counts["fused_sample"]
            k = fs.fused_sample_chain(wrong, x, clean, sa, sb, bt)
            n = fs.launch_counts["fused_sample"] - before
            ok, _ = agree(f"planted fault ({name}) b={b}, {n} cooperative launch", k, p)
            if ok or wrong.bn_mode != "batch" or n != BATCH_BN_LAUNCHES:
                raise AssertionError(f"the comparison missed a planted fault: {name}")
    phase("planted faults are caught", planted_faults)

    rng_np = np.random.default_rng(0)
    frame = make_synthetic_samples(1, *FRAME_HW, iso=800, seed=1)[0]["clean"]
    clean = np.ascontiguousarray(np.stack([
        frame[0, r:r + 32, c:c + 32]
        for r, c in zip(rng_np.integers(0, FRAME_HW[0] - 32, 138),
                        rng_np.integers(0, FRAME_HW[1] - 32, 138))]))

    def serve():
        fs.launch_counts.clear()
        outs = []
        t0 = time.time()
        for iso, cam in GRID:
            n = nf.sample_noise_nf(clean, 0.0, 0.0, iso, cam, temp=TEMP)
            if n.shape != clean.shape or not np.isfinite(n).all():
                raise AssertionError(f"bad sample at iso {iso}: {n.shape}")
            outs.append((iso, cam, n))
        t_req = (time.time() - t0) / len(GRID)
        t0 = time.time()
        noise = nf.sample_noise_frame(frame, 0.0, 0.0, 800.0, 2.0, temp=TEMP)
        t_frame = time.time() - t0
        if noise.shape != frame.shape[1:] or not np.isfinite(noise).all():
            raise AssertionError(f"bad frame noise {noise.shape}")
        launches = _main_path(dict(fs.launch_counts))["fused_sample"]
        # calls by the production row that times them (_production_times)
        serve_calls.update(eps=len(GRID), eps_frame=-(-FRAME_B // 4096))
        calls = sum(serve_calls.values())
        expected = calls * BATCH_BN_LAUNCHES
        print(f"serve: {len(GRID)} requests of 138 patches, {t_req * 1e3:.2f} ms "
              f"each (host clock, incl. transfers); frame {FRAME_HW} in "
              f"{t_frame * 1e3:.1f} ms; kernel launches {launches} "
              f"({calls} calls, {expected} expected)")
        if launches <= 0 or launches != expected:
            raise AssertionError(f"the main path launched the fused kernel "
                                 f"{launches} times, not {expected}")
        for iso, cam, n in outs:
            print(f"  iso {iso:.0f} cam {cam:.0f}: noise sd {n.std():.5f}")
        # round trip: the plain inverse of one batch gives back the latent,
        # which was eps * TEMP
        iso, cam, n = outs[2]
        b = n.shape[0]
        cond = {"clean": torch.as_tensor(clean, device="cuda"),
                "iso": torch.full((b,), iso, device="cuda"),
                "cam": torch.full((b,), cam, device="cuda"),
                "nlf0": torch.zeros(b, device="cuda"),
                "nlf1": torch.zeros(b, device="cuda")}
        with torch.no_grad():
            xn = torch.as_tensor(n, device="cuda")
            z, _ = nf.flow.inverse(xn, cond, train=nf.bn_batch_stats)
            nll = nf.flow.nll_per_sample(xn, cond, train=nf.bn_batch_stats)
        sd = float(z.std())
        print(f"round trip: latent sd {sd:.5f} (temperature {TEMP}), "
              f"mean NLL {float(nll.mean()):.2f} nats/patch")
        if not bool(torch.isfinite(nll).all()) or abs(sd - TEMP) > 0.03 * TEMP:
            raise AssertionError(f"round trip latent sd {sd} vs temperature {TEMP}")
        return launches
    serve_calls = {}
    launches = phase("serve requests + frame", serve)

    timings = {}

    def timing():
        for b in BATCHES:
            for mode in ("batch", "running"):
                prog = programs[mode]
                x, clean, sa, sb = _inputs(prog, b, seed=7 + b)
                bt = fs.bn_block(b)
                iters = 20 if b == 138 else 5
                k_ms = _time_ms(lambda: fs.fused_sample_chain(prog, x, clean, sa, sb, bt), iters)
                p_ms = _time_ms(lambda: fs.sample_chain_reference(prog, x, clean, sa, sb, bt), iters)
                flops, nbytes = _work(prog, b)
                t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
                timings[(mode, b)] = {
                    "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
                print(f"time bn={mode} b={b}: kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, bound {timings[(mode, b)]['bound_ms']:.4f} ms "
                      f"({timings[(mode, b)]['bound_by']}; {flops / 1e9:.3f} GFLOP, "
                      f"{nbytes / 1e6:.3f} MB)")
    phase("timing", timing)

    def breakdown():
        """Where a request's time goes: the host clock around whole calls
        (each ends in a copy to the host, which waits for the card) beside
        CUDA-event times of its parts, each run alone (an event pair spans
        the stream's idle gaps too, so a part that the host holds up, as
        scale_ab's many small launches, shows its host time)."""
        b, n = clean.shape[0], 20
        for _ in range(3):
            nf.sample_noise_nf(clean, 0.0, 0.0, 800.0, 2.0)
        t0 = time.perf_counter()
        for _ in range(n):
            nf.sample_noise_nf(clean, 0.0, 0.0, 800.0, 2.0)
        req_ms = (time.perf_counter() - t0) / n * 1e3
        cond = {"clean": torch.as_tensor(clean, device="cuda"),
                "iso": torch.full((b,), 800.0, device="cuda"),
                "cam": torch.full((b,), 2.0, device="cuda"),
                "nlf0": torch.zeros(b, device="cuda"),
                "nlf1": torch.zeros(b, device="cuda")}
        sab_ms = _time_ms(lambda: nf._program.scale_ab(cond, b), n)
        h2d_ms = _time_ms(lambda: torch.as_tensor(clean, device="cuda"), n)
        d2h_ms = _time_ms(lambda: cond["clean"].cpu(), n)
        t0 = time.perf_counter()
        for _ in range(3):
            nf.sample_noise_frame(frame, 0.0, 0.0, 800.0, 2.0)
        frame_ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"breakdown b={b} bn=batch: request {req_ms:.4f} ms (host clock); "
              f"parts (CUDA events): scale_ab {sab_ms:.4f} ms, copy in {h2d_ms:.4f} ms, "
              f"kernel {timings[('batch', 138)]['ms']:.4f} ms, copy out "
              f"{d2h_ms:.4f} ms; frame {FRAME_HW} {frame_ms:.2f} ms (host clock)")
    phase("request breakdown", breakdown)

    train_out = _training_phases(phase, agree)
    rng_out = _rng_dncnn_phases(phase, agree, programs, nf)
    bf16_modes = _bf16_phases(phase, programs)
    redesign = _redesign_phases(phase, agree, programs, nf)
    sampler = _sampler_phases(phase, programs, nf.flow)
    coop = _coop_phases(phase, programs)
    eval_rows = _eval_phases(phase)
    flagship = _flagship_phases(phase, agree, nf, frame[0])
    _resume_phase(phase, flagship)
    family = _model_family_phases(phase, flagship)
    parallel = _parallel_phases(phase, flagship, smi)
    _spatial_packed_tf_phases(phase, nf, smi)
    graphs = _graph_phases(phase)
    mesh_graphs = _mesh_graph_phases(phase, flagship, smi)
    ghost = _ghost_recipe_phase(phase, flagship)
    comparison = _dncnn_comparison_phase(phase)
    shutil.rmtree(flagship["work"], ignore_errors=True)
    print(f"model_family_seconds {json.dumps(family['seconds'])}")

    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1

    main_t = timings[("batch", 138)]
    rng_errs, rng_t = rng_out["errs"], rng_out["timings"]
    chain_errs = {k: v for k, v in rng_errs.items() if k[0] != "normals"}
    rng_mode = dict(
        rng_t[("rng", 128)], launches=rng_out["launches"] + comparison["launches"],
        max_abs_err=max(chain_errs.values()),
        shape="b=128, bt=128, batch BN (the DnCNN_NF step; launches: its 2-epoch fit and "
              "the comparison's NF source, phase 56)",
        comparison={"launches": comparison["launches"],
                    "psnr": {s: v["psnr"] for s, v in comparison["results"].items()}},
        normals_max_abs_err=max(v for k, v in rng_errs.items() if k[0] == "normals"),
        by_shape={f"b={b},bn={m}": dict(rng_t.get(("rng", b), {}), max_abs_err=e)
                  for (m, b), e in chain_errs.items()},
        make_sampler=rng_t["make_sampler"])
    eps_mode = dict(
        main_t, launches=launches, max_abs_err=max(errs.values()), library_ms=None,
        shape="b=138, bn=batch (the wrapper's default; launches: the serve phase)",
        by_shape=dict({f"b={b},bn={m}": dict(v, max_abs_err=errs[(m, b)])
                       for (m, b), v in timings.items()},
                      **{f"b={b},bn={m}": rng_t[("eps", b)]
                         for m, b, _ in (RNG_SHAPES[0], ("running", SAMPLER_B, 0))}))
    entry = {
        "name": "fused_sample",
        "route": "cuda",
        "source": "noise_flow_tpu_torch/csrc/fused_sample.cu",
        "replaces": "noise_flow_tpu/ops/pallas_sample.py:374",
        "launches": launches + rng_out["launches"] + sum(flagship["launches"].values())
        + comparison["launches"],
        "max_abs_err": max(max(errs.values()), rng_mode["max_abs_err"],
                           *flagship["max_abs_err"].values()),
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None,
        "shape": "b=138, bn=batch, eps mode (the wrapper's default)",
        "by_mode": {"eps": eps_mode, "rng": rng_mode},
    }
    entry["by_mode"]["eps"]["whole_batch"] = {
        f"b={b},bt={b}": v for b, v in redesign["frame"].items()}
    entry["design"], entry["redesign"] = coop["design"], coop["rows"]
    # phases 40-41: the sweep (b <= 138, resident) and the grid (b = 1024, walk)
    entry["flagship"] = {"launches": flagship["launches"],
                         "max_abs_err": flagship["max_abs_err"],
                         "exact_bn_step_ms": flagship["step_ms"],
                         "frame_spatial_ms": flagship["frame_spatial_ms"]}
    kernels = [entry] + train_out["entries"]
    for k in kernels:   # phase 38's rows beside the eval forward's running modes
        if k["name"] == "fused_segment_forward":
            k["by_mode"]["running"]["redesign"] = eval_rows["float32"]
            bf16_modes[k["name"]]["running_bf16"]["redesign"] = eval_rows["bfloat16"]
    for k in kernels:   # the bf16 modes beside each kernel's float32 ones
        k.setdefault("by_mode", {}).update(bf16_modes.get(k["name"], {}))
        kind = {"fused_train_step": "step", "fused_segment_backward": "segment_backward",
                "fused_segment_forward": "ghost_forward"}.get(k["name"])
        if kind:   # the production design beside the parent's, both precisions
            k["redesign"] = {f"{dt},bt={bt}": v for (kd, dt, bt), v in
                             redesign["designs"].items() if kd == kind}
    for k in kernels:   # phases 47-48: each rank's launches on the data-parallel paths
        if k["name"] in parallel["launches"]:
            k["parallel"] = {"launches_by_rank": parallel["launches"][k["name"]],
                             "ranks": PAR_RANKS, "on": "2 ranks sharing one card, gloo"}
    for k in kernels:   # phase 58: the one-shot step's launches under mesh graphs
        if k["name"] == "fused_train_step":
            k.setdefault("parallel", {})["mesh_graphs"] = {
                "one_rank_nccl": mesh_graphs["one_rank"], "k": MESH_GRAPH_K,
                "ranks": mesh_graphs["ranks"],
                "launches_by_rank": mesh_graphs["launches"].get("fused_train_step"),
                "step_ms_by_rank": mesh_graphs["ms"].get("one-shot f32"),
                "not_run": mesh_graphs.get("not_run")}
    if {k["name"] for k in kernels} - set(bf16_modes):
        print("chip_smoke: a kernel has no bf16 mode in the kernels line", file=sys.stderr)
        return 1
    print(f"smoke_seconds {time.time() - t_start:.1f} (build included)")
    try:
        rank = _rank(kernels, sampler["production"], redesign["designs"], serve_calls)
    except ValueError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"rank": rank}))
    # phases 52-53: the launches that graph replays (and the warm-up steps
    # before each capture) issued, in the entries and modes of the kernels
    # that ran there; the rank above leaves them out (the 5-scale arch's
    # segment is one launch a step, where its rows time both segments)
    seg = GRAPH_PATHS[3][0]
    under = {("fused_train_step", None): ("one-shot f32", "fused_train_step"),
             ("fused_train_step", "bf16"): ("one-shot bf16", "fused_train_step_bf16"),
             ("fused_segment_forward", "ghost"): (seg, "fused_segment_train_forward"),
             ("fused_segment_forward", "running"): ("staged eval (fused, f32)",
                                                    "fused_segment_forward"),
             ("fused_segment_backward", None): (seg, "fused_segment_backward")}
    for k in kernels:
        for (name, mode), (label, counter) in under.items():
            if k["name"] != name:
                continue
            n = graphs["launches"].get(label, {}).get(counter, 0)
            if mode is None or not mode.endswith("bf16"):
                k["launches"] += n
            if mode is not None:
                k["by_mode"][mode]["launches"] += n
            ms = graphs["ms"].get("staged eval" if mode == "running" else label, {})
            k.setdefault("under_graph", {})[mode or "float32"] = {
                "path": label, "launches": n, "k": GRAPH_K,
                "eager_step_ms": ms.get("eager_ms"), "graph_step_ms": ms.get("graph_ms")}
    # phase 59: the ghost recipe's graph run (cli.train at K = 32), its bf16
    # step and eval forward launches beside their modes
    for k in kernels:
        for name, mode, counter, part in (
                ("fused_train_step", "bf16", "fused_train_step_bf16", "train"),
                ("fused_segment_forward", "running_bf16", "fused_segment_forward_bf16", "eval")):
            if k["name"] != name:
                continue
            n = ghost["launches"].get(counter, 0)
            k["by_mode"][mode]["launches"] += n
            replay = ghost["replay"]["staged_" + ("train" if part == "train" else "test")]
            k.setdefault("under_graph", {})[mode + "_ghost_recipe"] = {
                "path": "cli.train --recipe ghost's flags (phase 59)", "launches": n,
                "a_replay": replay.get(counter), "k": GRAPH_K,
                "eager_step_ms": ghost["ms"][part]["eager_ms"],
                "graph_step_ms": ghost["ms"][part]["graph_ms"]}
    # the probe sites: train template, then the sampler group
    for probe in [*redesign["probes"].values(), *sampler["probes"].values()]:
        probe["launches"] = sum(MAIN_PATH.get(c, 0) for c in probe["counters"])
        kernels.append(probe)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
