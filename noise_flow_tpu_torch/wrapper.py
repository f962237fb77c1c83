"""Inference-only public API: load a trained model directory and sample noise.

Port of noise_flow_tpu.wrapper (ref:borealisflows/NoiseFlowWrapper.py:19-138):
re-hydrate the Config from ``hps.txt``, load the best npz checkpoint, and
expose ``sample_noise_nf(batch_clean, b1, b2, iso, cam)``, the call the
DnCNN pipeline and the sampling demo make.

Reference quirk preserved: the wrapper samples with ``is_training=True`` so
coupling-NN batch norm uses batch statistics (ref:NoiseFlowWrapper.py:86),
controlled by ``bn_batch_stats`` (default True to match). Sampling goes
through the fused sampler (``ops.fused_sample``): its CUDA kernel on the
card, its plain PyTorch version on the CPU. A flow outside the sampler's
envelope (the legacy revnet specs, the dense template, multi-level flows)
samples through the plain ``flow.sample``, the path of JAX's default
wrapper, which loads any checkpoint its ``NoiseFlow`` builds. A flow inside
the envelope that the sampler still refuses (its patch shape, more than
``MAX_OPS`` layers) raises, as JAX's wrapper does with ``use_pallas``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from noise_flow_tpu_torch.config import Config, load_hps
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops.fused_sample import build_sample_program, fused_sample, in_envelope
from noise_flow_tpu_torch.parallel.mesh import as_mesh
from noise_flow_tpu_torch.parallel.spatial import gather_rows, sample_frame_sharded
from noise_flow_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from noise_flow_tpu_torch.utils.device import resolve_device


def _best_checkpoint(ckpt_dir: str) -> Optional[str]:
    best = os.path.join(ckpt_dir, "model.ckpt-best.npz")
    if os.path.exists(best):
        return best
    return latest_checkpoint(ckpt_dir)


class NoiseFlowWrapper:
    """Load ``path/{hps.txt, ckpt/model.ckpt-best.npz}`` and sample noise.

    Example:
        nf = NoiseFlowWrapper("models/NoiseFlow", sampling_temperature=0.6)
        noise = nf.sample_noise_nf(clean_batch, 0.0, 0.0, iso=100, cam=2)
    """

    def __init__(self, path: str, sampling_temperature: float = 0.6,
                 cfg: Optional[Config] = None, bn_batch_stats: bool = True,
                 seed: int = 12345, device="cuda"):
        self.device = resolve_device(device)
        self.path = path
        self.temp = float(sampling_temperature)
        self.cfg = cfg or load_hps(os.path.join(path, "hps.txt"))
        self.bn_batch_stats = bn_batch_stats
        ph = self.cfg.patch_height
        self.flow = NoiseFlow((ph, ph, self.cfg.n_channels), self.cfg,
                              device=self.device)
        ckpt_dir = os.path.join(path, "ckpt")
        ckpt = _best_checkpoint(ckpt_dir)
        if ckpt is not None:
            self.epoch = load_checkpoint(ckpt, self.flow)
        else:
            # fall back to the reference's TF checkpoint, as JAX's wrapper
            # does (ref:NoiseFlowWrapper.py:43,77); reading it needs tensorflow
            from noise_flow_tpu_torch.utils.tf_import import (
                has_tf_checkpoint, import_reference_checkpoint)
            if not has_tf_checkpoint(ckpt_dir):
                raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
            import_reference_checkpoint(os.path.join(ckpt_dir, "model.ckpt.best"), self.flow)
            self.epoch = 0
        self.flow.eval()
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._program = None
        if in_envelope(self.flow):
            self._program = build_sample_program(
                self.flow, bn_mode="batch" if bn_batch_stats else "running")
        else:
            logging.getLogger(__name__).info(
                "%s is outside the fused sampler's envelope: sampling through "
                "flow.sample", path)

    # ------------------------------------------------------------------ api
    @torch.no_grad()
    def sample_noise_nf(self, batch_clean: np.ndarray, b1: float, b2: float,
                        iso: float, cam: float,
                        temp: Optional[float] = None) -> np.ndarray:
        """Sample noise for a batch of clean patches
        (ref:NoiseFlowWrapper.py:81-87).

        b1/b2 are the camera NLF betas (only used by condSDN-style layers;
        the published model ignores them — the reference feeds 0.0, 0.0).
        """
        x = np.asarray(batch_clean, np.float32)
        expect = (self.cfg.patch_height, self.cfg.patch_height,
                  self.cfg.n_channels)
        if x.ndim != 4 or x.shape[1:] != expect:
            raise ValueError(
                f"batch_clean must be [B,{expect[0]},{expect[1]},{expect[2]}] "
                f"(model was built at that shape, like the reference's fixed "
                f"placeholders); got {x.shape}")
        b = x.shape[0]

        def full(v):
            return torch.full((b,), float(v), dtype=torch.float32,
                              device=self.device)

        cond = {"clean": torch.as_tensor(x, device=self.device),
                "nlf0": full(b1), "nlf1": full(b2), "iso": full(iso),
                "cam": full(cam)}
        t = self.temp if temp is None else float(temp)
        # batch-stats BN over the whole batch (bt = b), as JAX's default
        # wrapper samples through flow.sample(train=True); fused_sample's
        # own default, bn_block, is the rule of JAX's Pallas branch only
        if self._program is None:
            out = self.flow.sample(cond, temp=t, batch=b, train=self.bn_batch_stats,
                                   generator=self._gen)
        else:
            out = fused_sample(self._program, cond, temp=t, generator=self._gen, bt=b)
        return out.cpu().numpy()

    def sample_noise_frame(self, clean_frame: np.ndarray, b1: float,
                           b2: float, iso: float, cam: float,
                           temp: Optional[float] = None,
                           batch: int = 4096) -> np.ndarray:
        """Sample noise for a FULL packed raw frame [H, W, 4] (or [1, H, W, 4]).

        The flow is patch-based (32x32 receptive field); the frame is tiled
        into patch-grid tiles, sampled in batches of ``batch`` tiles, and
        stitched back. Edges are covered by reflect-padding the frame up to
        a patch multiple and cropping the result.
        """
        x = np.asarray(clean_frame, np.float32)
        if x.ndim == 4:
            x = x[0]
        h, w, c = x.shape
        ph = self.cfg.patch_height
        xp = np.pad(x, ((0, (-h) % ph), (0, (-w) % ph), (0, 0)), mode="reflect")
        hh, ww = xp.shape[:2]
        tiles = xp.reshape(hh // ph, ph, ww // ph, ph, c)
        tiles = tiles.transpose(0, 2, 1, 3, 4).reshape(-1, ph, ph, c)
        outs = [self.sample_noise_nf(tiles[s:s + batch], b1, b2, iso, cam, temp)
                for s in range(0, len(tiles), batch)]
        noise = np.concatenate(outs).reshape(hh // ph, ww // ph, ph, ph, c)
        noise = noise.transpose(0, 2, 1, 3, 4).reshape(hh, ww, c)
        return noise[:h, :w]

    @torch.no_grad()
    def sample_noise_frame_spatial(self, clean_frame: np.ndarray, b1: float,
                                   b2: float, iso: float, cam: float,
                                   temp: Optional[float] = None, mesh=None) -> np.ndarray:
        """Sample noise for a FULL frame [H, W, 4] (or [1, H, W, 4]) with the
        flow run AT frame size, the frame's height sharded over ``mesh``.

        The flow is fully convolutional, so the 32x32-trained weights apply
        at any (H, W): a flow is built at the frame's size with this
        wrapper's weights and sampled with BatchNorm in train mode where
        ``bn_batch_stats`` is set. Unlike ``sample_noise_frame``
        (independent 32x32 tiles), the noise has no tile seams. ``mesh``
        (a ``parallel.mesh.Mesh``; None: every rank of the default process
        group, one rank without one) splits the frame's rows over its ranks,
        each calling this with the same frame: the convs exchange halo rows
        and BatchNorm's moments span the frame (``parallel.spatial``). The
        frame is reflect-padded to a height that is a multiple of 8 x ranks
        and a width that is a multiple of 8, as JAX's. Every rank draws the
        whole frame's latents from this wrapper's generator, so wrappers
        seeded alike give n ranks the noise of one, and every rank returns
        the whole frame. No kernel runs: the fused sampler is a
        32x32-patch kernel.
        """
        mesh = as_mesh(mesh, self.device)
        x = np.asarray(clean_frame, np.float32)
        if x.ndim == 3:
            x = x[None]
        h, w = x.shape[1], x.shape[2]
        xp = np.pad(x, ((0, 0), (0, (-h) % (8 * mesh.size)), (0, (-w) % 8), (0, 0)),
                    mode="reflect")
        flow = NoiseFlow(xp.shape[1:], self.cfg, device=self.device)
        flow.load_state_dict(self.flow.state_dict())
        flow.eval()

        def full(v):
            return torch.full((1,), float(v), dtype=torch.float32, device=self.device)

        cond = {"clean": torch.as_tensor(xp, device=self.device),
                "nlf0": full(b1), "nlf1": full(b2), "iso": full(iso), "cam": full(cam)}
        t = self.temp if temp is None else float(temp)
        z, split_eps = flow.draw_latents(t, 1, self._gen)
        out = sample_frame_sharded(flow, cond, z, mesh, t, self.bn_batch_stats, split_eps)
        return gather_rows(out, mesh)[0, :h, :w].cpu().numpy()
