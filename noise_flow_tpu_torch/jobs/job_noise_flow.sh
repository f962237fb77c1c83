#!/bin/bash
# Canonical noise-flow runs through the PyTorch port (the recipes of
# jobs/job_noise_flow.sh, ref:job_noise_flow.sh:17-75, with the same names
# and flags), run from the repo root. The port's CLIs take the card
# (--device cuda, their default); outputs go under experiments/sidd_torch/
# where the JAX recipes write experiments/sidd/.
# Usage: bash noise_flow_tpu_torch/jobs/job_noise_flow.sh <config>    config in:
#   published | sdn-gain | s-ax1-g-ax1 | ax4 | condsdn-baseline | smoke |
#   published-fused | multihost | converged-fused-synth | prod-synth-scale |
#   prod-exact | kld-sweep
set -e
cfg="${1:-published}"
SIDD="${SIDD_PATH:-./data/SIDD_Medium_Raw/Data}"

case "$cfg" in
  published)  # S-Ax4-G-Ax4-CAM (ref:job_noise_flow.sh:35-39)
    python -m noise_flow_tpu_torch.cli.train \
      --arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc" --width 4 \
      --lr 1e-4 --n_batch_train 138 --patch_height 32 \
      --n_patches_per_image 2898 --epochs 2000 --do_sample \
      --sidd_path "$SIDD" --logdir experiments/sidd_torch/published
    ;;
  s-ax1-g-ax1)  # (ref:job_noise_flow.sh:44-48)
    python -m noise_flow_tpu_torch.cli.train \
      --arch "sdn5|unc|gain4|unc" --width 4 --lr 1e-4 \
      --n_batch_train 138 --patch_height 32 --n_patches_per_image 2898 \
      --epochs 2000 --sidd_path "$SIDD" --logdir experiments/sidd_torch/s_ax1_g_ax1
    ;;
  sdn-gain)  # S-G, conditional layers only (ref:job_noise_flow.sh:53-57)
    python -m noise_flow_tpu_torch.cli.train \
      --arch "sdn5|gain4" --width 4 --lr 1e-4 --n_batch_train 138 \
      --patch_height 32 --n_patches_per_image 2898 --epochs 2000 \
      --sidd_path "$SIDD" --logdir experiments/sidd_torch/s_g
    ;;
  ax4)  # unconditional Ax4 ablation (ref:job_noise_flow.sh:62-66)
    python -m noise_flow_tpu_torch.cli.train \
      --arch "unc|unc|unc|unc" --width 4 --lr 1e-4 --n_batch_train 138 \
      --patch_height 32 --n_patches_per_image 2898 --epochs 2000 \
      --sidd_path "$SIDD" --logdir experiments/sidd_torch/ax4
    ;;
  condsdn-baseline)  # non-trainable camera-NLF baseline (eval only)
    python -m noise_flow_tpu_torch.cli.train \
      --arch "" --sidd_cond condSDN --depth 1 --lr 1e-4 \
      --n_batch_train 138 --patch_height 32 --n_patches_per_image 2898 \
      --epochs 5 --sidd_path "$SIDD" --logdir experiments/sidd_torch/condsdn
    ;;
  smoke)  # no SIDD needed
    python -m noise_flow_tpu_torch.cli.train --synthetic_data 4 --epochs 30 \
      --patch_height 16 --n_batch_train 16 --lr 1e-2 --do_sample \
      --logdir experiments/sidd_torch/smoke
    ;;
  published-fused)  # published model through the fused CUDA train kernels,
                    # npy cache + C++ loader feeding the card
    python -m noise_flow_tpu_torch.cli.train \
      --arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc" --width 4 \
      --lr 1e-4 --n_batch_train 138 --patch_height 32 --shuffle_patches \
      --n_patches_per_image 2898 --epochs 2000 --do_sample --use_pallas \
      --steps_per_call 16 \
      --cache_dir experiments/sidd_torch/cache --native_loader \
      --sidd_path "$SIDD" --logdir experiments/sidd_torch/published_fused
    ;;
  multihost)  # 2-host data-parallel example (run once per host with its id)
    : "${COORD:=host0:8476}" "${NPROC:=2}" "${PID:=0}"
    python -m noise_flow_tpu_torch.cli.train \
      --arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc" --width 4 \
      --lr 1e-4 --n_batch_train 276 --patch_height 32 \
      --n_patches_per_image 2898 --epochs 2000 \
      --coordinator_address "$COORD" --num_processes "$NPROC" \
      --process_id "$PID" \
      --sidd_path "$SIDD" --logdir experiments/sidd_torch/multihost
    ;;
  converged-fused-synth)  # the JAX run of experiments/sidd/converged_fused:
    # published arch trained end-to-end through the one-shot fused kernel
    # on synthetic SIDD-shaped data (no dataset needed)
    python -m noise_flow_tpu_torch.cli.train \
      --arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc" --width 4 \
      --synthetic_data 48 --patch_height 32 --n_batch_train 128 \
      --n_batch_test 128 --lr 2e-3 --temp 0.6 --epochs 300 \
      --epochs_full_valid 20 --do_sample --use_pallas --steps_per_call 4 \
      --seed 0 --logdir experiments/sidd_torch/converged_fused
    ;;
  prod-synth-scale)  # production-shaped run, end to end: the SIDD-scale
    # dataset in the on-disk format (78 scene instances, 5328x3000 Bayer,
    # v7.3 .MAT, which needs h5py; all 15 (cam, ISO) NLF cells), decoded
    # once into the npy cache, streamed by the C++ native loader, trained
    # through the one-shot fused CUDA kernel at the reference batch (138);
    # the KLD sweep after.
    python -m noise_flow_tpu_torch.cli.make_sidd_scale
    python -m noise_flow_tpu_torch.cli.train \
      --arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc" --width 4 \
      --lr 1e-4 --n_batch_train 138 --patch_height 32 --shuffle_patches \
      --n_patches_per_image 2898 --epochs 150 --epochs_full_valid 10 \
      --temp 0.6 --do_sample --n_sample_batches 24 \
      --use_pallas --steps_per_call 32 --device_resident_data \
      --cache_dir data/sidd_scale_cache --native_loader \
      --sidd_path data/SIDD_Medium_Raw_synth/Data \
      --logdir experiments/sidd_torch/prod_synth_scale
    python -m noise_flow_tpu_torch.cli.kld_sweep \
      --model_dir experiments/sidd_torch/prod_synth_scale \
      --sidd_path data/SIDD_Medium_Raw_synth/Data \
      --temps 0.2,0.4,0.5,0.6,0.7,0.8,1.0 \
      --logdir experiments/sidd_torch/prod_synth_scale/kld_sweep
    ;;
  prod-exact)  # the flagship recipe: exact batch BN (the plain path) at
    # the published batch, epochs staged on the card, on-device sampling
    # diagnostics; the JAX run's artifacts are experiments/sidd/prod_exact_150
    # (its ghost-BN comparison: experiments/sidd/bn_delta/).
    python -m noise_flow_tpu_torch.cli.train \
      --arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc" --width 4 \
      --lr 1e-4 --n_batch_train 138 --patch_height 32 --shuffle_patches \
      --n_patches_per_image 2898 --epochs 150 --epochs_full_valid 10 \
      --temp 0.6 --do_sample \
      --steps_per_call 32 --device_resident_data \
      --cache_dir data/sidd_scale_cache --native_loader \
      --sidd_path data/SIDD_Medium_Raw_synth/Data \
      --logdir experiments/sidd_torch/prod_exact_150
    ;;
  kld-sweep)  # per-(cam,iso) marginal KLD vs temperature on a trained model
    python -m noise_flow_tpu_torch.cli.kld_sweep \
      --model_dir experiments/sidd_torch/published_fused \
      --sidd_path "$SIDD" --temps 0.2,0.4,0.5,0.6,0.7,0.8,1.0 \
      --logdir experiments/sidd_torch/kld_sweep
    ;;
  *) echo "unknown config: $cfg" >&2; exit 1;;
esac
