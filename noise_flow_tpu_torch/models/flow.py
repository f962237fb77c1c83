"""NoiseFlow model: arch-DSL -> layer stack; NLL loss, sampling, priors.

Port of noise_flow_tpu.models.flow (ref:borealisflows/noise_flow_model.py).
``NoiseFlow`` is an ``nn.Module`` that holds the bijectors of each level in
spec order, the split priors between levels, and in ``shared.sdn_gain`` the
group that sdn4/5/6 and gain4 share.

``state_dict`` keys mirror the JAX trees (``utils.checkpoint`` maps them):
- level 0 is ``layers``: the JAX leaf
  ``params['layers'][0][i]['nn']['l1_w']`` is ``layers.i.nn.l1_w``, so every
  key of a single-level flow names its leaf without the level index;
- a level li >= 1 is ``levels.<li>``: ``params['layers'][li][i][...]`` is
  ``levels.li.i....`` (``levels`` is empty for a single-level flow);
- the split prior after level li is ``splits.<li>``: the JAX
  ``params['splits'][li]['w']`` is ``splits.li.w`` (with ``b`` and ``logs``);
- ``shared.sdn_gain.*`` is ``params['shared']['sdn_gain']``.
BatchNorm buffers take the same names as the parameters beside them.

Direction naming follows the reference: ``inverse`` maps data -> latent (the
NLL), ``forward`` maps latent -> data (sampling runs the levels and the
specs reversed).

Arch DSL (ref:noise_flow_model.py:71-235): tokens split on '|'; ``unc``
expands to [permutation, affine coupling] where the permutation is a channel
reverse (flow_permutation=0), an invertible 1x1 conv (=1), or nothing; other
tokens are single conditional bijectors. An empty ``cfg.arch`` takes the
legacy revnet2d specs (ref:noise_flow_model.py:237-392), chosen by
``cfg.sidd_cond`` and ``cfg.depth``.

Multi-level flows (``cfg.n_levels > 1``) squeeze at every level and split
half the channels off between levels, scored by a zero-init conv prior
(ref:noise_flow_model.py:544-574). A reference limitation is kept: at a
level above 0 the squeezed clean image no longer matches the latent, so a
flow whose layers read ``cond['clean']`` fails there, in JAX with a shape
error and here with a ``ValueError`` when the flow is built.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from noise_flow_tpu_torch.models import cond_params as cp
from noise_flow_tpu_torch.models.layers import (
    CLEAN_KINDS,
    SHARED_SDN_GAIN_KINDS,
    ParamTree,
    make_layer,
)
from noise_flow_tpu_torch.ops.gaussian import diag_gaussian_logp, diag_gaussian_sample
from noise_flow_tpu_torch.ops.nn import conv_zeros_apply, conv_zeros_init
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


def _revnet_specs(cfg) -> List[LayerSpec]:
    """Legacy Glow-style path (ref:noise_flow_model.py:237-392)."""
    specs: List[LayerSpec] = []
    if cfg.append_sdn2:
        specs.append(LayerSpec("fitSDN2", f"ac_fitSdnGain2_{cfg.depth}"))
    if cfg.append_sdn_first:
        specs.append(LayerSpec("fitSDN", f"ac_fitSdnGain_{cfg.depth}"))
    if cfg.append_cY:
        specs.append(LayerSpec("condY", "ac_cY_first"))
    names = {"condY": "cY", "condYG": "cYG", "condXY": "cXY", "condXYG": "cXYG",
             "condSDN": "cSDN", "fitSDN": "fitSDN"}
    cond_kind = cfg.sidd_cond if cfg.sidd_cond in names else "coupling"
    for i in range(max(cfg.depth, 0)):
        if cfg.flow_permutation == 0:
            specs.append(LayerSpec("perm_reverse", f"Permute_{i}"))
        elif cfg.flow_permutation == 1:
            specs.append(LayerSpec("conv1x1", f"Conv2d_1x1_{i}"))
        specs.append(LayerSpec(cond_kind, f"ac_{names.get(cond_kind, 'unc')}_{i}"))
    if cfg.append_sdn:
        specs.append(LayerSpec("fitSDN", f"ac_fitSDN_{cfg.depth}"))
    return specs


def _level_shapes(x_shape, cfg) -> List[Tuple[int, int, int]]:
    """Per-level latent shapes (ref:noise_flow_model.py:54-69): the first
    level squeezes (H, W, C) to (H/f, W/f, C f^2), each later one halves the
    spatial size and doubles the channels."""
    shapes, shape = [], tuple(x_shape)
    f = cfg.squeeze_factor
    for i in range(cfg.n_levels):
        if f != 1:
            c = shape[2] * f * f if i == 0 else shape[2] * 2
            shape = (shape[0] // f, shape[1] // f, c)
        shapes.append(shape)
    return shapes


class NoiseFlow(nn.Module):
    """Conditional normalizing flow over [B,H,W,C] noise tensors.

    The layers are initialised from ``seed`` (numpy), which fixes their
    shapes; real weights come from a checkpoint (``utils.checkpoint``).
    """

    def __init__(self, x_shape: Tuple[int, int, int], cfg, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.x_shape = tuple(x_shape)
        self.n_levels = cfg.n_levels
        self.level_shapes = _level_shapes(x_shape, cfg)
        self.specs: List[LayerSpec] = _arch_to_specs(cfg) if cfg.arch else _revnet_specs(cfg)
        kinds = {s.kind for s in self.specs}
        if self.n_levels > 1 and kinds & set(CLEAN_KINDS):
            f = cfg.squeeze_factor
            raise ValueError(
                f"layer kinds {sorted(kinds & set(CLEAN_KINDS))} read the clean image, "
                f"which at level 1 is squeezed to {self.x_shape[2] * f ** 4} channels "
                f"against the latent's {self.level_shapes[0][2] // 2 * f * f}; the JAX "
                "flow fails there too")
        rng = np.random.default_rng(seed)
        levels = [nn.ModuleList([make_layer(s.kind, shape, cfg, rng) for s in self.specs])
                  for shape in self.level_shapes]
        self.layers = levels[0]
        self.levels = nn.ModuleDict({str(li): lv for li, lv in enumerate(levels) if li})
        self.splits = nn.ModuleList([
            ParamTree(conv_zeros_init(shape[-1] // 2, 2 * (shape[-1] // 2), 3, edge_bias=True))
            for shape in self.level_shapes[:-1]])
        self.c_i = 1.0  # (ref:train_noise_flow.py:207)
        if kinds & set(SHARED_SDN_GAIN_KINDS):
            npcam = 1 if "sdn6" in kinds else 3
            shared, self.c_i = cp.sdn_gain_shared_init(cfg.gain_init, None, npcam)
            self.shared = ParamTree({"sdn_gain": shared})
        else:
            self.shared = None
        self._is_cond = bool(kinds - {"perm_reverse", "conv1x1", "coupling",
                                      "batch_norm", "leaky_relu"})
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def shared_view(self, psum=None):
        """What every layer is given as ``shared``: the sdn/gain group, c_i,
        and ``psum``, the sum over data-parallel ranks that train-mode
        BatchNorm takes its moments with (None: this rank's rows)."""
        sh = {"c_i": self.c_i, "psum": psum}
        if self.shared is not None:
            sh["sdn_gain"] = self.shared.sdn_gain
        return sh

    def _level_layers(self, li: int):
        """(state_dict prefix, layer modules) of level ``li``."""
        if li == 0:
            return "layers", self.layers
        return f"levels.{li}", self.levels[str(li)]

    def _squeeze(self, x):
        return squeeze2d(x, self.cfg.squeeze_factor, self.cfg.squeeze_type)

    # ------------------------------------------------------------- inverse
    def inverse(self, x, cond, train: bool, state_out=None, psum=None):
        """data -> latent; returns (z, objective[B]) where the objective sums
        the inverse log-det-jacobians and, between levels, the split priors'
        log-probs (ref:noise_flow_model.py:394-428).

        Given a dict ``state_out``, puts there the new BatchNorm running
        statistics of every layer with BatchNorm, keyed as the flow's
        ``state_dict`` buffers (``layers.1.nn.bn1.mean``, ...). ``psum``:
        train-mode BatchNorm moments over every data-parallel rank's rows
        (``shared_view``)."""
        shared = self.shared_view(psum)
        z = x
        cond = dict(cond)
        obj = x.new_zeros((x.shape[0],))
        for li in range(self.n_levels):
            z = self._squeeze(z)
            if cond.get("clean") is not None:
                cond["clean"] = self._squeeze(cond["clean"])
            prefix, layers = self._level_layers(li)
            for i, layer in enumerate(layers):
                sub = {} if state_out is not None else None
                z, ildj = layer.inverse(z, cond, train, shared, sub)
                obj = obj + ildj
                if sub:
                    state_out.update({f"{prefix}.{i}.{k}": v for k, v in sub.items()})
            if li < self.n_levels - 1:
                z, logp2 = _split2d(self.splits[li], z)
                obj = obj + logp2
        return z, obj

    # ------------------------------------------------------------- forward
    def forward(self, z, cond, train: bool, split_eps=None, temp: float = 1.0,
                generator: Optional[torch.Generator] = None):
        """latent -> data (sampling direction, ref:noise_flow_model.py:430-447).

        ``z`` is the top level's latent, already scaled by the temperature.
        Between levels the split prior draws the other half of the channels,
        ``mean + exp(logs) * eps * temp``: ``split_eps[li]`` is the standard
        normal ``eps`` of the split after level ``li`` (shape: level ``li``'s
        latent with half its channels); without it, eps is drawn from
        ``generator``, from the top level down."""
        shared = self.shared_view()
        x = z
        for li in reversed(range(self.n_levels)):
            if li < self.n_levels - 1:
                mean, logs = _split_prior(self.splits[li], x)
                eps = (split_eps[li] if split_eps is not None else torch.randn(
                    x.shape, generator=generator, device=x.device, dtype=x.dtype))
                x = torch.cat([x, mean + torch.exp(logs) * (eps * temp)], dim=-1)
            lvl_cond = dict(cond)
            if lvl_cond.get("clean") is not None:
                for _ in range(li + 1):
                    lvl_cond["clean"] = self._squeeze(lvl_cond["clean"])
            for layer in reversed(self._level_layers(li)[1]):
                x, _ = layer.forward(x, lvl_cond, train, shared)
            x = unsqueeze2d(x, self.cfg.squeeze_factor, self.cfg.squeeze_type)
        return x

    # ---------------------------------------------------------------- loss
    def _nll(self, x, cond, train, state_out=None, psum=None):
        c = cond if self._is_cond else {"clean": None}
        z, obj = self.inverse(x, c, train, state_out, psum)
        return -(obj + diag_gaussian_logp(z)), z

    def loss(self, x, cond, train: bool, psum=None):
        """Returns (mean NLL [nats/patch], sd_z, new_state)
        (ref:noise_flow_model.py:458-484), as the JAX ``flow.loss``.

        ``new_state`` is a dict keyed as the flow's ``state_dict`` buffers
        that holds every coupling's BatchNorm running statistics: updated to
        ``s - 0.1 * (s - batch_stat)`` with ``train=True``, the current values
        otherwise. The buffers themselves are not changed; ``apply_state``
        writes a new state into them.

        ``psum`` (data parallelism, ``parallel.mesh.Mesh.psum()``): the
        BatchNorm moments span every rank's rows, differentiably, as JAX's
        ``flow.loss`` over a sharded global batch; the NLL and sd_z stay
        this rank's."""
        new_state = {}
        nll, z = self._nll(x, cond, train, new_state, psum)
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
        return self.forward(z, c, train, temp=temp, generator=generator)

    # ------------------------------------------------------------- utility
    def get_layer_names(self) -> List[str]:
        return [s.name for s in self.specs] * self.n_levels

    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))


# ---------------------------------------------------------------------------
# multi-scale split (ref:noise_flow_model.py:544-574)
# ---------------------------------------------------------------------------

def _split_prior(p_conv, z1):
    h = conv_zeros_apply(p_conv, z1)
    return h[..., 0::2], h[..., 1::2]


def _split2d(p_conv, z):
    c = z.shape[-1]
    z1, z2 = z[..., : c // 2], z[..., c // 2:]
    mean, logs = _split_prior(p_conv, z1)
    return z1, diag_gaussian_logp(z2, mean, logs)
