"""NoiseFlow model: arch-DSL -> layer stack; NLL loss, sampling.

Port of noise_flow_tpu.models.flow (ref:borealisflows/noise_flow_model.py).
``NoiseFlow`` is an ``nn.Module`` whose ``layers`` hold the bijectors in
spec order and whose ``shared.sdn_gain`` holds the group that sdn4/5/6 and
gain4 share. ``state_dict`` keys mirror the JAX trees: the JAX leaf
``params['layers'][0][i]['nn']['l1_w']`` is ``layers.i.nn.l1_w`` here.

Direction naming follows the reference: ``inverse`` maps data -> latent (the
NLL), ``forward`` maps latent -> data (sampling runs the specs reversed).

Arch DSL (ref:noise_flow_model.py:71-235): tokens split on '|'; ``unc``
expands to [permutation, affine coupling] where the permutation is a channel
reverse (flow_permutation=0), an invertible 1x1 conv (=1), or nothing; other
tokens are single conditional bijectors. Single-level flows only: multi-level
``split2d`` and the legacy revnet specs (empty ``cfg.arch``) raise.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from noise_flow_tpu_torch.models import cond_params as cp
from noise_flow_tpu_torch.models.layers import SHARED_SDN_GAIN_KINDS, ParamTree, make_layer
from noise_flow_tpu_torch.ops.gaussian import diag_gaussian_logp, diag_gaussian_sample
from noise_flow_tpu_torch.ops.squeeze import squeeze2d, unsqueeze2d
from noise_flow_tpu_torch.utils.device import resolve_device


class LayerSpec(NamedTuple):
    kind: str
    name: str


def _arch_to_specs(cfg) -> List[LayerSpec]:
    """Arch token list -> layer specs, with reference-identical layer naming
    (ref:noise_flow_model.py:79-234 and models/NoiseFlow/hps.txt)."""
    specs: List[LayerSpec] = []
    for i, tok in enumerate(cfg.arch_tokens()):
        if tok == "unc":
            if cfg.flow_permutation == 0:
                specs.append(LayerSpec("perm_reverse", f"Permute_{i}"))
            elif cfg.flow_permutation == 1:
                specs.append(LayerSpec("conv1x1", f"Conv2d_1x1_{i}"))
            specs.append(LayerSpec("coupling", f"unc_{i}"))
        elif tok.startswith("sdn"):
            specs.append(LayerSpec(tok, f"sdn_{i}"))
        elif tok.startswith("gain"):
            specs.append(LayerSpec(tok, f"gain_{i}"))
        else:
            raise ValueError(f"unhandled arch token {tok!r}")
    return specs


class NoiseFlow(nn.Module):
    """Conditional normalizing flow over [B,H,W,C] noise tensors.

    The layers are initialised from ``seed`` (numpy), which fixes their
    shapes; real weights come from a checkpoint (``utils.checkpoint``).
    """

    def __init__(self, x_shape: Tuple[int, int, int], cfg, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        if cfg.n_levels != 1:
            raise NotImplementedError(
                "multi-level flows (split2d) are not ported yet: ROADMAP.md "
                "queue 1, 'Multi-level flows'")
        if not cfg.arch:
            raise NotImplementedError(
                "the legacy revnet specs (empty cfg.arch) are not ported yet: "
                "ROADMAP.md queue 1, 'Remaining layer kinds'")
        self.cfg = cfg
        self.x_shape = tuple(x_shape)
        f = cfg.squeeze_factor
        shape = self.x_shape
        if f != 1:
            shape = (shape[0] // f, shape[1] // f, shape[2] * f * f)
        self.level_shapes: List[Tuple[int, int, int]] = [shape]
        self.specs: List[LayerSpec] = _arch_to_specs(cfg)
        rng = np.random.default_rng(seed)
        self.layers = nn.ModuleList(
            [make_layer(s.kind, shape, cfg, rng) for s in self.specs])
        kinds = {s.kind for s in self.specs}
        self.c_i = 1.0  # (ref:train_noise_flow.py:207)
        if kinds & set(SHARED_SDN_GAIN_KINDS):
            npcam = 1 if "sdn6" in kinds else 3
            shared, self.c_i = cp.sdn_gain_shared_init(cfg.gain_init, None, npcam)
            self.shared = ParamTree({"sdn_gain": shared})
        else:
            self.shared = None
        self._is_cond = bool(kinds - {"perm_reverse", "conv1x1", "coupling"})
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def shared_view(self):
        sh = {"c_i": self.c_i}
        if self.shared is not None:
            sh["sdn_gain"] = self.shared.sdn_gain
        return sh

    def _squeezed_cond(self, cond):
        cond = dict(cond)
        if cond.get("clean") is not None:
            cond["clean"] = squeeze2d(cond["clean"], self.cfg.squeeze_factor,
                                      self.cfg.squeeze_type)
        return cond

    # ------------------------------------------------------------- inverse
    def inverse(self, x, cond, train: bool, state_out=None):
        """data -> latent; returns (z, objective[B]) where the objective is
        the sum of the inverse log-det-jacobians (ref:noise_flow_model.py:394-428).

        Given a dict ``state_out``, puts there the new BatchNorm running
        statistics of every coupling, keyed as the flow's ``state_dict``
        buffers (``layers.1.nn.bn1.mean``, ...)."""
        shared = self.shared_view()
        z = squeeze2d(x, self.cfg.squeeze_factor, self.cfg.squeeze_type)
        cond = self._squeezed_cond(cond)
        obj = x.new_zeros((x.shape[0],))
        for i, layer in enumerate(self.layers):
            sub = {} if state_out is not None else None
            z, ildj = layer.inverse(z, cond, train, shared, sub)
            obj = obj + ildj
            if sub:
                state_out.update({f"layers.{i}.{k}": v for k, v in sub.items()})
        return z, obj

    # ------------------------------------------------------------- forward
    def forward(self, z, cond, train: bool):
        """latent -> data (sampling direction, ref:noise_flow_model.py:430-447)."""
        shared = self.shared_view()
        cond = self._squeezed_cond(cond)
        x = z
        for layer in reversed(self.layers):
            x, _ = layer.forward(x, cond, train, shared)
        return unsqueeze2d(x, self.cfg.squeeze_factor, self.cfg.squeeze_type)

    # ---------------------------------------------------------------- loss
    def _nll(self, x, cond, train, state_out=None):
        c = cond if self._is_cond else {"clean": None}
        z, obj = self.inverse(x, c, train, state_out)
        return -(obj + diag_gaussian_logp(z)), z

    def loss(self, x, cond, train: bool):
        """Returns (mean NLL [nats/patch], sd_z, new_state)
        (ref:noise_flow_model.py:458-484), as the JAX ``flow.loss``.

        ``new_state`` is a dict keyed as the flow's ``state_dict`` buffers
        that holds every coupling's BatchNorm running statistics: updated to
        ``s - 0.1 * (s - batch_stat)`` with ``train=True``, the current values
        otherwise. The buffers themselves are not changed; ``apply_state``
        writes a new state into them."""
        new_state = {}
        nll, z = self._nll(x, cond, train, new_state)
        var_z = torch.var(z.reshape(z.shape[0], -1), dim=1, unbiased=False)
        return torch.mean(nll), torch.mean(torch.sqrt(var_z)), new_state

    @torch.no_grad()
    def apply_state(self, new_state) -> None:
        """Write a state returned by ``loss`` into the flow's buffers."""
        bufs = dict(self.named_buffers())
        for k, v in new_state.items():
            bufs[k].copy_(v)

    def nll_per_sample(self, x, cond, train: bool = False):
        return self._nll(x, cond, train)[0]

    # -------------------------------------------------------------- sample
    def sample(self, cond, temp: float = 1.0, batch: Optional[int] = None,
               train: bool = False,
               generator: Optional[torch.Generator] = None):
        """Temperature-scaled sampling (ref:noise_flow_model.py:449-456).

        NOTE: the reference's inference wrapper samples with is_training=True
        so coupling-NN batch norm uses batch statistics
        (ref:borealisflows/NoiseFlowWrapper.py:86); pass train=True to match.
        """
        if batch is None:
            batch = cond["clean"].shape[0]
        z = diag_gaussian_sample((batch,) + tuple(self.level_shapes[-1]), temp,
                                 generator=generator, device=self.device)
        c = cond if self._is_cond else {"clean": None}
        return self.forward(z, c, train)

    # ------------------------------------------------------------- utility
    def get_layer_names(self) -> List[str]:
        return [s.name for s in self.specs]

    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))
