"""CLI flag surface.

Port of noise_flow_tpu.cli.args: the same flags, plus ``--device`` (default
``cuda``), ``--init_checkpoint``, ``--dist_backend`` and
``--pallas_train_dtype``. ``--mesh`` and
``--coordinator_address`` / ``--num_processes`` / ``--process_id`` select
data-parallel training, one rank a device (cli/train.py).

Keeps the reference's flag names (ref:sidd/ArgParser.py:11-167) so the
canonical run commands (ref:job_noise_flow.sh:35-75) work verbatim, and maps
them onto the typed Config. Runtime extras (mesh shape, dtype, fused kernels)
are additive.

Flag diff vs ref:sidd/ArgParser.py:11-167 — reference flags intentionally
NOT exposed here, each dead or meaningless outside the reference's TF runtime:
  * dead in the reference itself (parsed, never read by any code path —
    verified `grep hps.<flag>` over the reference tree): --dal,
    --epochs_warmup, --model, --full-conv, --weight_y, --learntop, --ycond,
    --noise_baseline, --cond_gt, --reload_freq, --n_reuse_batch,
    --split_observations, --num_gpus, --init_sdn, --visualize,
    --visualize_only, --vis_samples, --copy_stats, --visualize_last_epoch,
    --sample_subdir, --load_batches, --fcsize, --mb_qsize, --collect_vars,
    --pre_init
  * CLI value dead because the reference overwrites it before any read:
    --n_train / --n_test (recomputed, ref:sidd/sidd_utils.py:71-72),
    --mb_requeue (forced True, ref:train_noise_flow.py:272),
    --save_batches (its one consumer is commented out,
    ref:train_noise_flow.py:277)
  * hogwild/TF-1 pipeline knobs with no analogue in a jitted
    single-controller step — their function is subsumed by --mesh,
    --steps_per_call and the C++ native loader: --n_train_threads,
    --n_reuse_image
  * environment-specific path remaps subsumed by --logdir/--sidd_path taking
    full paths: --problem (logdir prefix, ref:train_noise_flow.py:250),
    --server ('skynet' cluster remap, ref:sidd/sidd_utils.py:44)
--epochs_full_sample / --sample_epoch_start / --sample_epoch_end are parsed
and recorded by the reference but consumed nowhere in its code (their only
surface is the hps.txt dump); they are accepted + recorded here identically.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from noise_flow_tpu_torch.config import Config, default_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "noise_flow_tpu_torch", description="conditional noise flow, PyTorch/CUDA")
    # --- model (ref:ArgParser.py:37-66,110-125) ---
    p.add_argument("--arch", type=str,
                   default="sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc",
                   help="arch DSL, e.g. 'sdn5|unc|...|gain4|...'")
    p.add_argument("--width", type=int, default=4,
                   help="coupling-NN hidden width")
    p.add_argument("--coupling_nn", type=str, default="conv",
                   choices=["conv", "dense"],
                   help="coupling template: conv (real_nvp_conv_template) or "
                        "dense MLP (real_nvp_default_template)")
    p.add_argument("--hidden_layers", type=int, nargs="+", default=[64, 64],
                   help="dense-template hidden layer sizes")
    p.add_argument("--depth", type=int, default=-1,
                   help="legacy revnet2d depth (used when --arch is empty)")
    p.add_argument("--n_levels", type=int, default=1)
    p.add_argument("--squeeze_factor", type=int, default=1)
    p.add_argument("--squeeze-type", dest="squeeze_type", type=str,
                   default="chessboard", choices=("chessboard", "patch"))
    p.add_argument("--flow_permutation", type=int, default=1,
                   help="0=reverse, 1=invertible 1x1 conv, else none")
    p.add_argument("--decomp", type=str, default="LU",
                   choices=("NONE", "LU", "LU2"))
    p.add_argument("--sidd_cond", type=str, default="mix",
                   help="legacy revnet2d conditioning "
                        "(uncond|condY|condYG|condXY|condXYG|condSDN|fitSDN|mix)")
    p.add_argument("--gain_init", type=float, default=-5.0,
                   help="initial value for gain parameters "
                        "(ref:ArgParser.py:162; feeds sdn2/sdn3/gain2 inits)")
    p.add_argument("--append_sdn", action="store_true")
    p.add_argument("--append_sdn2", action="store_true")
    p.add_argument("--append_sdn_first", action="store_true")
    p.add_argument("--append_cY", action="store_true")
    # --- data (ref:ArgParser.py:15,72-106) ---
    p.add_argument("--sidd_path", type=str,
                   default="./data/SIDD_Medium_Raw/Data")
    p.add_argument("--patch_height", type=int, default=32)
    p.add_argument("--patch_sampling", type=str, default="uniform",
                   choices=("uniform", "random"))
    p.add_argument("--n_patches_per_image", type=int, default=2898)
    p.add_argument("--start_tr_im_idx", type=int, default=10)
    p.add_argument("--end_tr_im_idx", type=int, default=12)
    p.add_argument("--start_ts_im_idx", type=int, default=10)
    p.add_argument("--end_ts_im_idx", type=int, default=12)
    p.add_argument("--camera", type=str, default=None,
                   help="filter by camera id (IP|GP|S6|N6|G4)")
    p.add_argument("--iso", type=int, default=None, help="filter by ISO")
    p.add_argument("--synthetic_data", type=int, default=0, metavar="N",
                   help="use N synthetic images instead of SIDD (smoke runs)")
    p.add_argument("--n_tr_inst", type=int, default=None,
                   help="cap enumerated training scene instances (quick-run "
                        "aid; the reference recorded the enumerated count "
                        "instead, ref:Initialization.py:31-33)")
    p.add_argument("--n_ts_inst", type=int, default=None,
                   help="cap enumerated testing scene instances (see "
                        "--n_tr_inst)")
    p.add_argument("--cache_dir", type=str, default=None,
                   help="npy cache dir for decoded SIDD images: built on "
                        "first run, reused afterwards (data/cache.py)")
    p.add_argument("--native_loader", action="store_true",
                   help="stream minibatches through the C++ threaded loader "
                        "(native/patch_loader.cc) instead of the in-RAM "
                        "PatchDataset; requires --cache_dir")
    p.add_argument("--download_sidd", action="store_true",
                   help="auto-download SIDD_Medium_Raw (~20 GB) if missing "
                        "(ref:sidd/data_loader.py:34-45)")
    # --- multi-process: one rank a process, over torch.distributed ---
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="host:port of process 0; enables multi-process "
                        "training (coordinator mode)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--shuffle_patches", action="store_true",
                   help="shuffle the uniform patch grid per image "
                        "(ref:sidd_utils.py:838-844)")
    p.add_argument("--calc_pat_stats_and_baselines_only", action="store_true",
                   help="compute patch stats + Gaussian/NLF baselines, then exit")
    p.add_argument("--calc_hists_only", action="store_true",
                   help="compute train/test intensity histograms, then exit")
    # --- training (ref:ArgParser.py:25-36,62,126-151) ---
    p.add_argument("--logdir", type=str, default="./experiments/sidd/run0")
    p.add_argument("--n_batch_train", type=int, default=138)
    p.add_argument("--n_batch_test", type=int, default=138)
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--epochs_full_valid", type=int, default=30)
    # accepted + recorded for hps.txt/command-line round-trip parity; dead in
    # the reference too (see module docstring)
    p.add_argument("--epochs_full_sample", type=int, default=50,
                   help="recorded only (dead in the reference as well, "
                        "ref:ArgParser.py:53)")
    p.add_argument("--sample_epoch_start", type=int, default=None,
                   help="recorded only (dead in the reference as well, "
                        "ref:ArgParser.py:132)")
    p.add_argument("--sample_epoch_end", type=int, default=None,
                   help="recorded only (dead in the reference as well, "
                        "ref:ArgParser.py:134)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--optim", type=str, default="adam", choices=("adam", "sgd"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_bits_x", type=int, default=10)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--do_sample", action="store_true")
    p.add_argument("--device_resident_data", action="store_true",
                   help="stage the full train/test patch sets on the card once "
                        "(streamed through the input pipeline at startup) "
                        "and train with on-device index gathers — removes "
                        "the per-step host link (single device/process; "
                        "needs per-example conditioning)")
    p.add_argument("--staged_test_patches", type=int, default=55200,
                   help="with --device_resident_data, cap the staged "
                        "test set to this many patches (the per-epoch test "
                        "NLL is over this fixed deterministic subset; 0 = "
                        "stage the full split — watch device memory)")
    p.add_argument("--n_sample_batches", type=int, default=0,
                   help="cap the per-epoch sampling-diagnostic phase to this"
                        " many test batches (0 = all; with the on-device "
                        "KLD path the phase streams scalars only, so "
                        "full-scale splits no longer need a cap)")
    p.add_argument("--continue_training", action="store_true")
    # --- runtime extras ---
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel mesh size: ranks started by this launch, "
                        "one a card (0 = all visible cards; 1 on the CPU)")
    p.add_argument("--dist_backend", type=str, default=None, choices=("gloo", "nccl"),
                   help="process-group backend (default: nccl on the card, gloo "
                        "on the CPU; gloo for ranks that share one card)")
    p.add_argument("--batch_scalar_cond", action="store_true",
                   help="reference-compat: one (nlf,iso,cam) scalar per "
                        "minibatch, taken from its last patch "
                        "(ref:sidd/MiniBatchSampler.py:60-64)")
    p.add_argument("--use_pallas", action="store_true",
                   help="train and evaluate through the fused CUDA kernels")
    p.add_argument("--pallas_train_dtype", type=str, default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="the fused train kernels' product operands (the config "
                        "field JAX's CLI leaves at its default, bfloat16)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="recorded only: each train step is one eager call")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    p.add_argument("--init_checkpoint", type=str, default="",
                   help="npz checkpoint (the JAX package's format) whose "
                        "params and state the new flow starts from; the run "
                        "itself is new: epoch 1, new logs, fresh optimizer")
    return p


def args_to_config(args: argparse.Namespace) -> Config:
    cfg_fields = {f for f in Config.__dataclass_fields__}
    kwargs = {k: v for k, v in vars(args).items() if k in cfg_fields}
    if args.mesh:
        kwargs["mesh_shape"] = (args.mesh,)
    if getattr(args, "batch_scalar_cond", False):
        kwargs["per_example_cond"] = False
    return default_config(**kwargs)


def parse_config(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)
    return args, args_to_config(args)
