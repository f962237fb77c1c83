"""DnCNN training on synthesised noise.

Port of noise_flow_tpu.training.dncnn_trainer (ref:train_dncnn_noiseflow.py:
127-300). Each train step draws a noise batch on the device from the clean
batch (Gaussian, SDN, camera NLF, Noise Flow, or the real noisy set), clips
``clean + noise`` to [0, 1], and takes one Adam step on the DnCNN.

The Noise Flow source samples every batch through the fused sampler's
in-kernel RNG mode (``ops.fused_sample``, the JAX kernel's ``use_prng``): a
per-step int seed in, the noise out, no normals in device memory. Its
BatchNorm uses the batch's moments with one group of the whole batch, which
is what JAX's ``flow.sample(..., train=True)`` computes.

Random draws: the per-step scalars (sigma, betas, the (cam, iso) row, the
Gaussian coin, the sampler's seed) come from a numpy generator on the host,
so that no step waits for the card; the normals of the Gaussian-family
sources from a ``torch.Generator`` on the device, seeded once an epoch from
the host generator. The streams differ from JAX's, so against JAX the noise
sources are held by their distributions, or through a shared eps.

Loss: sum-squared-error / 2 (ref:train_dncnn_noiseflow.py:244-245).
LR schedule: lr for epochs <= 30, lr/10 <= 60, lr/20 after
(ref:train_dncnn_noiseflow.py:127-138).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from noise_flow_tpu_torch.models.dncnn import DnCNN
from noise_flow_tpu_torch.ops.fused_sample import (
    SEED_MOD,
    build_sample_program,
    fused_sample,
)
from noise_flow_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from noise_flow_tpu_torch.utils.device import resolve_device
from noise_flow_tpu_torch.utils.image_metrics import psnr as psnr_metric

# Gaussian sigma (in [0,255]) and camera NLF ranges estimated from SIDD
# (ref:train_dncnn_noiseflow.py:33-36)
MIN_EST_SIGMA = 0.24186
MAX_EST_SIGMA = 11.507
MIN_CAM_NLF = (0.00011841, 2.0024e-06)
MAX_CAM_NLF = (0.021949, 0.0017506)
NOISE_SOURCES = ("gauss", "sdn", "camnlf", "nf", "real")


def _stage_key(a: Optional[np.ndarray]):
    """Cheap identity for a host array staged on the card: shape + dtype + a
    hash of <= 64k elements strided uniformly across the whole flat buffer,
    so a different array reusing a collected id() and an in-place edit both
    restage, without hashing gigabytes (JAX's ``_stage_key``)."""
    if a is None:
        return None
    a = np.asarray(a)
    flat = a.reshape(-1)
    sample = np.ascontiguousarray(flat[::max(1, flat.size // 65536)])
    return (a.shape, str(a.dtype), hash(sample.tobytes()))


def lr_schedule(epoch: int, initial_lr: float) -> float:
    """(ref:train_dncnn_noiseflow.py:127-138)"""
    if epoch <= 30:
        return initial_lr
    if epoch <= 60:
        return initial_lr / 10.0
    return initial_lr / 20.0


class DnCNNTrainer:
    """noise_source: 'gauss' | 'sdn' | 'camnlf' | 'nf' | 'real'.

    For 'nf', pass ``noise_flow``, a frozen ``NoiseFlow`` on the trainer's
    device (e.g. ``NoiseFlowWrapper(path, device=...).flow``); each batch is
    sampled from it with a random (cam, iso) row and, half of the time,
    replaced by Gaussian noise, like the reference generator
    (ref:train_dncnn_noiseflow.py:150-163). For 'camnlf'/'nf', pass
    ``cam_iso_rows=[(cam_idx, iso, b1, b2), ...]`` (from cam_iso_nlf.txt).
    One card: the JAX trainer's ``mesh`` has no counterpart yet (ROADMAP.md
    queue 1, item 8).
    """

    def __init__(self, depth: int = 9, filters: int = 32, channels: int = 4,
                 lr: float = 1e-3, seed: int = 0, noise_source: str = "gauss",
                 noise_flow=None, cam_iso_rows: Optional[List] = None,
                 dtype: str = "float32", device="cuda"):
        if noise_source not in NOISE_SOURCES:
            raise ValueError(f"unknown noise source {noise_source!r}")
        self.device = resolve_device(device)
        self.depth, self.filters, self.lr = depth, filters, lr
        self.noise_source = noise_source
        self.model = DnCNN(depth, filters, channels, seed=seed, device=self.device,
                           compute_dtype=torch.bfloat16 if dtype == "bfloat16" else None)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self._rows = [tuple(float(v) for v in r)
                      for r in (cam_iso_rows or [(2, 100.0, 0.000479, 2e-6)])]
        self.program = None
        if noise_source == "nf":
            if noise_flow is None:
                raise ValueError("noise_source='nf' needs noise_flow")
            if noise_flow.device.type != self.device.type:
                raise ValueError(f"noise_flow lies on {noise_flow.device}, the trainer "
                                 f"on {self.device}")
            self.program = build_sample_program(noise_flow, bn_mode="batch")
        self._staged = None

    # ------------------------------------------------------------- noise gen
    def _noise_params(self, rng: np.random.Generator) -> Dict:
        """The host-side draws of one step (ref:train_dncnn_noiseflow.py:
        150-163, 213-236)."""
        src = self.noise_source
        if src == "gauss":
            return {"sig": rng.uniform(MIN_EST_SIGMA, MAX_EST_SIGMA) / 255.0}
        if src == "sdn":
            return {"b1": rng.uniform(MIN_CAM_NLF[0], MAX_CAM_NLF[0]),
                    "b2": rng.uniform(MIN_CAM_NLF[1], MAX_CAM_NLF[1])}
        if src == "camnlf":
            return {"row": self._rows[rng.integers(len(self._rows))]}
        if src == "nf":
            return {"row": self._rows[rng.integers(len(self._rows))],
                    "seed": int(rng.integers(SEED_MOD)),
                    "sig": rng.uniform(MIN_EST_SIGMA, MAX_EST_SIGMA) / 255.0,
                    "gauss": bool(rng.random() < 0.5)}
        return {}

    @torch.no_grad()
    def _make_noise(self, clean, p: Dict, gen: torch.Generator):
        """Noise with clean's shape, on its device, from the step's draws
        ``p`` and the device generator ``gen``."""
        src = self.noise_source

        def normal():
            return torch.randn(clean.shape, generator=gen, device=clean.device)
        if src == "gauss":
            return p["sig"] * normal()
        if src == "sdn":
            return torch.sqrt(p["b1"] * clean + p["b2"]) * normal()
        if src == "camnlf":
            return torch.sqrt(p["row"][2] * clean + p["row"][3]) * normal()
        if src == "nf":
            b = clean.shape[0]
            cam, iso = p["row"][0], p["row"][1]
            zeros = torch.zeros((b,), device=clean.device)
            cond = {"clean": clean, "nlf0": zeros, "nlf1": zeros,
                    "iso": torch.full((b,), iso, device=clean.device),
                    "cam": torch.full((b,), cam, device=clean.device)}
            # one BN group of the whole batch, as flow.sample(train=True)
            nf_noise = fused_sample(self.program, cond, temp=1.0, seed=p["seed"], bt=b)
            # 50% Gaussian-sigma augmentation (ref:154-160); both drawn, as
            # JAX's jnp.where draws both
            gauss = p["sig"] * normal()
            return gauss if p["gauss"] else nf_noise
        raise ValueError(f"noise source {src!r} draws no noise")

    # ---------------------------------------------------------------- steps
    def train_step(self, clean, noisy, p: Dict, gen: torch.Generator):
        """One Adam step on a batch on the device; returns the loss (a
        tensor on the device, not synchronised)."""
        if self.noise_source == "real":
            x_noisy = noisy
        else:
            x_noisy = torch.clamp(clean + self._make_noise(clean, p, gen), 0.0, 1.0)
        out, new_state = self.model(x_noisy, train=True)
        # sum_squared_error / 2 (ref:244-245)
        loss = torch.sum(torch.square(out - clean)) / 2.0
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.model.apply_state(new_state)
        return loss.detach()

    def set_lr(self, lr: float) -> None:
        for g in self.optimizer.param_groups:
            g["lr"] = lr

    def train_epoch(self, clean: np.ndarray, batch_size: int, rng,
                    noisy: Optional[np.ndarray] = None, shuffle_seed: int = 0,
                    device_resident: bool = True) -> float:
        """One epoch over ``clean`` in the order of
        ``default_rng(shuffle_seed).permutation`` (full batches only).
        ``rng``: a numpy Generator (or an int seed) for the step draws.
        ``device_resident`` stages the clean/noisy sets on the device once
        and gathers each batch by index there; otherwise every batch is
        copied from the host."""
        rng = np.random.default_rng(rng)
        gen = torch.Generator(device=self.device).manual_seed(int(rng.integers(2 ** 63)))
        n = (len(clean) // batch_size) * batch_size
        order = np.random.default_rng(shuffle_seed).permutation(len(clean))[:n]
        dev = self.device
        if device_resident:
            key = (_stage_key(clean), _stage_key(noisy))
            if self._staged is None or self._staged[0] != key:
                ca = torch.as_tensor(np.asarray(clean, np.float32), device=dev)
                na = (torch.as_tensor(np.asarray(noisy, np.float32), device=dev)
                      if noisy is not None else ca)   # same buffer, unused
                self._staged = (key, ca, na)
            _, ca, na = self._staged
        losses = []
        for s in range(0, n, batch_size):
            idx = order[s:s + batch_size]
            if device_resident:
                i = torch.as_tensor(idx, device=dev)
                cb, nb = ca.index_select(0, i), na.index_select(0, i)
            else:
                cb = torch.as_tensor(np.asarray(clean[idx], np.float32), device=dev)
                nb = (torch.as_tensor(np.asarray(noisy[idx], np.float32), device=dev)
                      if noisy is not None else None)
            losses.append(self.train_step(cb, nb, self._noise_params(rng), gen))
        return float(torch.stack(losses).mean())

    @torch.no_grad()
    def denoise(self, noisy: np.ndarray, batch_size: int = 0) -> np.ndarray:
        """Eval-mode forward (running BN statistics); numpy in and out."""
        def run(a):
            x = torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            return self.model(x, train=False)[0].cpu().numpy()
        if not batch_size:
            return run(noisy)
        return np.concatenate([run(noisy[s:s + batch_size])
                               for s in range(0, len(noisy), batch_size)])

    def eval_psnr(self, clean: np.ndarray, noisy: np.ndarray,
                  batch_size: int = 128) -> float:
        den = self.denoise(noisy, batch_size)
        return psnr_metric(clean, np.clip(den, 0.0, 1.0))

    # ------------------------------------------------------------ main loop
    def fit(self, clean: np.ndarray, save_dir: str, epochs: int,
            batch_size: int = 128, noisy: Optional[np.ndarray] = None,
            val_clean: Optional[np.ndarray] = None,
            val_noisy: Optional[np.ndarray] = None,
            initial_epoch: int = 0, save_every: int = 1,
            verbose: bool = True) -> Dict:
        """Epoch loop with per-epoch checkpoints ``model.ckpt-{epoch:03d}.npz``,
        CSV log, LR schedule, and best-PSNR tracking
        (ref:train_dncnn_noiseflow.py:246-300, max_epc_psnr.txt of
        test_dncnn_noiseflow.py:26-31)."""
        os.makedirs(save_dir, exist_ok=True)
        log_path = os.path.join(save_dir, "log.csv")
        history = {"loss": [], "psnr": []}
        best = (-1.0, 0)
        rng = np.random.default_rng(1234)
        for epoch in range(initial_epoch + 1, epochs + 1):
            self.set_lr(lr_schedule(epoch, self.lr))
            t0 = time.time()
            loss = self.train_epoch(clean, batch_size, rng, noisy=noisy,
                                    shuffle_seed=epoch)
            history["loss"].append(loss)
            val_psnr = ""
            if val_clean is not None and val_noisy is not None:
                p = self.eval_psnr(val_clean, val_noisy, batch_size)
                history["psnr"].append(p)
                if p > best[0]:
                    best = (p, epoch)
                val_psnr = f"{p:.4f}"
            if epoch % save_every == 0:
                save_checkpoint(save_dir, f"{epoch:03d}", self.model, epoch,
                                self.optimizer)
            with open(log_path, "a", newline="") as f:
                csv.writer(f).writerow([epoch, f"{loss:.4f}", val_psnr,
                                        f"{time.time() - t0:.1f}"])
            if verbose:
                print(f"dncnn epoch {epoch}: loss={loss:.1f} "
                      f"psnr={val_psnr or '-'}", flush=True)
        if best[1] > 0:
            with open(os.path.join(save_dir, "max_epc_psnr.txt"), "w") as f:
                f.write(f"{best[1]} {best[0]:.6f}\n")
        return history

    def load(self, save_dir: str, epoch: Optional[int] = None) -> int:
        """Load a checkpoint; returns its epoch. As in JAX, ``epoch`` names
        ``model_{epoch:03d}.npz``, which ``fit`` never writes, so the latest
        checkpoint loads whenever that file is absent."""
        path = (os.path.join(save_dir, f"model_{epoch:03d}.npz") if epoch
                else latest_checkpoint(save_dir))
        if path is None or not os.path.exists(path):
            path = latest_checkpoint(save_dir)
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {save_dir}")
        return load_checkpoint(path, self.model, self.optimizer)
