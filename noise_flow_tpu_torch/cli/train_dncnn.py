"""DnCNN training CLI.

Port of noise_flow_tpu.cli.train_dncnn (ref:train_dncnn_noiseflow.py
__main__, :257-300) with two more arguments, ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch path) and ``--dist_backend``. Model
naming selects the noise source exactly like the reference: a model name
containing ``_Gauss`` / ``_SDN`` / ``_CamNLF`` / ``_NF`` / ``_Real`` picks
the corresponding generator (ref:train_datagen 176-240).

    python -m noise_flow_tpu_torch.cli.train_dncnn --model DnCNN_NF \\
        --noise_flow_path experiments/sidd/prod_exact_150 \\
        --train_data data/SIDD_Medium_Raw/Data
Smoke run: add --synthetic_data 4. ``--mesh N`` trains data-parallel on N
ranks that this launch starts, one a card (0: every visible card; 1 on the
CPU; ``--device cpu`` starts N CPU processes); in a process group that is
already up, every rank of it is the mesh. ``--batch_size`` is the global
batch.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import List, Optional

from noise_flow_tpu_torch.config import CAM_NAMES
from noise_flow_tpu_torch.data.dncnn_data import load_dncnn_data, synthetic_dncnn_data
from noise_flow_tpu_torch.data.sidd import load_cam_iso_nlf
from noise_flow_tpu_torch.parallel import distributed as pd
from noise_flow_tpu_torch.parallel.mesh import mesh_ranks
from noise_flow_tpu_torch.training.dncnn_trainer import DnCNNTrainer


def noise_source_from_name(model_name: str) -> str:
    for tag, src in (("_NF", "nf"), ("_Gauss", "gauss"), ("_SDN", "sdn"),
                     ("_CamNLF", "camnlf"), ("_Real", "real")):
        if tag in model_name:
            return src
    raise ValueError(f"model name {model_name!r} must contain one of "
                     "_Gauss/_SDN/_CamNLF/_NF/_Real (ref naming scheme)")


def cam_iso_rows_from_table(path: str):
    rows = []
    for cam_iso, (b1, b2) in load_cam_iso_nlf(path).items():
        rows.append((CAM_NAMES.index(cam_iso[:2]), float(cam_iso[3:]), b1, b2))
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_dncnn")
    p.add_argument("--model", type=str, default="DnCNN_NF",
                   help="name with noise tag: DnCNN_{Gauss|SDN|CamNLF|NF|Real}")
    p.add_argument("--train_data", type=str,
                   default="./data/SIDD_Medium_Raw/Data")
    p.add_argument("--cam_iso_nlf", type=str, default="cam_iso_nlf.txt")
    p.add_argument("--noise_flow_path", type=str, default="",
                   help="trained noise-flow model dir (for _NF)")
    p.add_argument("--save_dir", type=str, default="")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--max_epoch", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--depth", type=int, default=9)
    p.add_argument("--filters", type=int, default=32)
    p.add_argument("--save_every", type=int, default=1)
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--synthetic_data", type=int, default=0)
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel ranks, one a card (0 = all visible cards)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dist_backend", type=str, default=None, choices=("gloo", "nccl"),
                   help="process-group backend (default: nccl on the card, gloo on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    n = mesh_ranks(args.mesh, args.device)
    if n > 1 and pd.world_size() == 1:
        pd.spawn_ranks(n, _rank_main, (argv,), args.device, args.dist_backend)
        return 0
    return _train(args, args.device)


def _rank_main(rank, device, argv):
    """One rank of ``--mesh N``: the run on ``device`` in the group."""
    _train(build_parser().parse_args(argv), str(device))


def _train(args, device: str) -> int:
    from noise_flow_tpu_torch.parallel.mesh import make_mesh
    from noise_flow_tpu_torch.utils.device import resolve_device

    logging.basicConfig(level=logging.INFO)
    mesh = make_mesh(None, resolve_device(device))

    source = noise_source_from_name(args.model)
    save_dir = args.save_dir or os.path.join("models", args.model)

    if args.synthetic_data:
        clean, info, noisy = synthetic_dncnn_data(
            n_images=args.synthetic_data, batch_size=args.batch_size)
    else:
        clean, info, noisy = load_dncnn_data(
            args.train_data,
            args.cam_iso_nlf if os.path.exists(args.cam_iso_nlf) else None,
            max_images=args.max_images, with_noisy=(source == "real"),
            batch_size=args.batch_size)
    logging.info("dataset: %d patches", len(clean))

    rows = None
    if os.path.exists(args.cam_iso_nlf):
        rows = cam_iso_rows_from_table(args.cam_iso_nlf)

    noise_flow = None
    if source == "nf":
        from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper
        noise_flow = NoiseFlowWrapper(args.noise_flow_path, device=mesh.device).flow

    trainer = DnCNNTrainer(
        depth=args.depth, filters=args.filters, lr=args.lr, noise_source=source,
        noise_flow=noise_flow, cam_iso_rows=rows, device=mesh.device, mesh=mesh)

    initial_epoch = 0
    if args.continue_training:
        try:
            initial_epoch = trainer.load(save_dir)
            logging.info("resuming from epoch %d", initial_epoch)
        except FileNotFoundError:
            pass

    # small held-out split for PSNR tracking when real noisy pairs exist
    val_clean = val_noisy = None
    if noisy is not None:
        n_val = min(len(clean) // 10, 512) or 1
        val_clean, val_noisy = clean[-n_val:], noisy[-n_val:]
        clean = clean[:-n_val]
        noisy = noisy[:-n_val] if source == "real" else None

    trainer.fit(clean, save_dir, epochs=args.max_epoch,
                batch_size=args.batch_size, noisy=noisy,
                val_clean=val_clean, val_noisy=val_noisy,
                initial_epoch=initial_epoch, save_every=args.save_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
