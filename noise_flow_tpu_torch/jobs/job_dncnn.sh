#!/bin/bash
# Canonical DnCNN runs over the four noise sources through the PyTorch port
# (the recipes of jobs/job_dncnn.sh, ref:job_dncnn.sh:17-84, with the same
# names and flags), run from the repo root on the card.
# Usage: bash noise_flow_tpu_torch/jobs/job_dncnn.sh <gauss|camnlf|nf|real|smoke> [noise_flow_model_dir]
set -e
cfg="${1:-gauss}"
NF_DIR="${2:-experiments/sidd_torch/published}"
SIDD="${SIDD_PATH:-./data/SIDD_Medium_Raw/Data}"

case "$cfg" in
  gauss)
    python -m noise_flow_tpu_torch.cli.train_dncnn --model DnCNN_Gauss --train_data "$SIDD"
    python -m noise_flow_tpu_torch.cli.test_dncnn --model_name DnCNN_Gauss --set_dir data
    ;;
  camnlf)
    python -m noise_flow_tpu_torch.cli.train_dncnn --model DnCNN_CamNLF --train_data "$SIDD"
    python -m noise_flow_tpu_torch.cli.test_dncnn --model_name DnCNN_CamNLF --set_dir data
    ;;
  nf)
    python -m noise_flow_tpu_torch.cli.train_dncnn --model DnCNN_NF --train_data "$SIDD" \
      --noise_flow_path "$NF_DIR"
    python -m noise_flow_tpu_torch.cli.test_dncnn --model_name DnCNN_NF --set_dir data
    ;;
  real)
    python -m noise_flow_tpu_torch.cli.train_dncnn --model DnCNN_Real --train_data "$SIDD"
    python -m noise_flow_tpu_torch.cli.test_dncnn --model_name DnCNN_Real --set_dir data
    ;;
  smoke)
    python -m noise_flow_tpu_torch.cli.train_dncnn --model DnCNN_Gauss --synthetic_data 4 \
      --max_epoch 3 --batch_size 16 --depth 5 --filters 8 \
      --save_dir /tmp/dncnn_smoke
    python -m noise_flow_tpu_torch.cli.test_dncnn --model_name DnCNN_Gauss \
      --model_dir /tmp/dncnn_smoke --depth 5 --filters 8 --synthetic \
      --result_dir /tmp/dncnn_smoke_results
    ;;
  *) echo "unknown config: $cfg" >&2; exit 1;;
esac
