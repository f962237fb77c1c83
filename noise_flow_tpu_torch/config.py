"""Configuration for noise_flow_tpu_torch (a copy of noise_flow_tpu.config, so
that the port reads the same hps.txt files without importing the JAX package).

Replaces the reference's mutable argparse namespace (ref:sidd/ArgParser.py:11-167)
with a typed dataclass. The arch DSL string is identical to the reference's
(``--arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"``,
ref:borealisflows/noise_flow_model.py:71-104) so canonical configs carry over.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

ISO_VALS = (100.0, 400.0, 800.0, 1600.0, 3200.0)
CAM_NAMES = ("IP", "GP", "S6", "N6", "G4")

# Arch tokens understood by the DSL (ref:borealisflows/noise_flow_model.py:79-234).
ARCH_TOKENS = (
    "unc",
    "sdn", "sdn1", "sdn2", "sdn3", "sdn4", "sdn5", "sdn6",
    "gain", "gain1", "gain2", "gain3", "gain4",
)

# Legacy revnet2d conditioning modes (ref:borealisflows/noise_flow_model.py:237-392).
SIDD_COND_MODES = (
    "uncond", "condY", "condYG", "condXY", "condXYG", "condSDN", "fitSDN", "mix",
)


@dataclass
class Config:
    # --- model ---
    arch: str = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"
    width: int = 4                       # coupling-NN hidden width
    coupling_nn: str = "conv"            # conv | dense (real_nvp_default_template)
    hidden_layers: Tuple[int, ...] = (64, 64)  # dense-template hidden sizes
    depth: int = -1                      # legacy revnet2d depth (arch DSL preferred)
    n_levels: int = 1
    squeeze_factor: int = 1
    squeeze_type: str = "chessboard"     # chessboard | patch
    flow_permutation: int = 1            # 0=channel-reverse, 1=invertible 1x1 conv
    decomp: str = "LU"                   # NONE | LU | LU2
    sidd_cond: str = "mix"               # legacy revnet2d conditioning selector
    gain_init: float = -5.0
    # legacy revnet2d appends (ref:noise_flow_model.py:243-280,379-390)
    append_sdn: bool = False
    append_sdn2: bool = False
    append_sdn_first: bool = False
    append_cY: bool = False

    # --- data ---
    sidd_path: str = "./data/SIDD_Medium_Raw/Data"
    patch_height: int = 32
    patch_sampling: str = "uniform"      # uniform | random
    n_patches_per_image: int = 2898
    start_tr_im_idx: int = 10
    end_tr_im_idx: int = 12
    start_ts_im_idx: int = 10
    end_ts_im_idx: int = 12
    camera: Optional[str] = None
    iso: Optional[int] = None
    n_channels: int = 4

    # --- training ---
    n_batch_train: int = 138
    n_batch_test: int = 138
    epochs: int = 2000
    epochs_full_valid: int = 30
    # Parsed and recorded by the reference but consumed nowhere in its code
    # (ref:sidd/ArgParser.py:53,132-134 — their only downstream surface is
    # the models/NoiseFlow/hps.txt dump). Accepted + dumped here identically
    # so canonical command lines and hps.txt files round-trip verbatim.
    epochs_full_sample: int = 50
    sample_epoch_start: Optional[int] = None
    sample_epoch_end: Optional[int] = None
    lr: float = 1e-4
    optim: str = "adam"                  # adam | sgd
    seed: int = 0
    n_bits_x: int = 10
    temp: float = 1.0                    # sampling temperature
    do_sample: bool = False
    continue_training: bool = False
    logdir: str = "./experiments/sidd/run0"

    # --- tpu / parallelism ---
    mesh_shape: Tuple[int, ...] = (1,)   # data-parallel axis sizes
    mesh_axes: Tuple[str, ...] = ("data",)
    # Flow math (log-dets, NLL) is always float32; 'bfloat16' here enables
    # low-precision MXU compute where it is safe: the fused Pallas sampler's
    # matmuls and DnCNN convs (f32 accumulation in both).
    dtype: str = "float32"
    use_pallas: bool = False             # fused Pallas flow kernels for the hot path
    # matmul dtype inside the fused TRAINING kernels, as the JAX package's:
    # "bfloat16" rounds the operands of every product in the one-shot step,
    # the segment kernels and the eval forward (float32 accumulation);
    # "float32" keeps them whole
    pallas_train_dtype: str = "bfloat16"
    # one-shot train step: loss AND grads in a single kernel pass (forward
    # once per block, analytic NLL cotangents, in-kernel backward — see
    # ops/fused_train.FusedTrainStep). Off = the segment path (FusedFlow in
    # train mode: a forward and a backward kernel per segment).
    pallas_oneshot: bool = True
    # train steps fused into one device dispatch via lax.scan (Trainer
    # stacks this many same-shape minibatches per call). 1 = step-per-call.
    steps_per_call: int = 1

    # --- compat with reference quirks ---
    # per-batch scalar conditioning (ref:sidd/MiniBatchSampler.py:60-64) vs
    # true per-example conditioning (TPU-native generalisation).
    per_example_cond: bool = True

    # derived (filled by finalize())
    n_bins: float = field(default=1024.0)
    x_shape: Tuple[int, int, int] = field(default=(32, 32, 4))
    n_dims: int = field(default=4096)

    def finalize(self) -> "Config":
        self.n_bins = float(2 ** self.n_bits_x)
        self.x_shape = (self.patch_height, self.patch_height, self.n_channels)
        self.n_dims = self.patch_height * self.patch_height * self.n_channels
        return self

    def arch_tokens(self):
        if not self.arch:
            return []
        toks = self.arch.split("|")
        for t in toks:
            if t not in ARCH_TOKENS:
                raise ValueError(f"unknown arch token {t!r}; known: {ARCH_TOKENS}")
        return toks


def default_config(**overrides) -> Config:
    cfg = Config(**overrides)
    return cfg.finalize()


def save_hps(path: str, cfg: Config, layer_names, num_params: int,
             extra=None) -> None:
    """csv dump compatible with the reference's hps.txt
    (ref:borealisflows/utils.py:110-119).

    extra: args-only provenance rows (e.g. synthetic_data, native_loader)
    that are not Config fields but must be recorded for reproducibility;
    load_hps skips unknown keys, so they round-trip harmlessly."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for n in layer_names:
            w.writerow([n])
        w.writerow([num_params])
        for k, v in dataclasses.asdict(cfg).items():
            w.writerow([k, v])
        for k, v in (extra or {}).items():
            w.writerow([k, v])


def load_hps(path: str) -> Config:
    """Re-hydrate a Config from an hps csv (ref:borealisflows/utils.py:122-135)."""
    fields = {f.name: f for f in dataclasses.fields(Config)}
    kwargs = {}
    with open(path, "r") as f:
        for pair in csv.reader(f):
            if len(pair) < 2 or pair[0] not in fields:
                continue
            k, raw = pair[0], pair[1]
            ftype = fields[k].type
            val = _coerce(raw)
            kwargs[k] = val
    cfg = Config(**{k: v for k, v in kwargs.items() if k in fields})
    return cfg.finalize()


def _coerce(raw: str):
    if raw in ("True", "False"):
        return raw == "True"
    if raw in ("None", ""):
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    if raw.startswith("(") or raw.startswith("["):
        try:
            import ast
            v = ast.literal_eval(raw)
            if isinstance(v, list):
                v = tuple(v)
            return v
        except Exception:
            pass
    return raw
