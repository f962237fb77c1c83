"""The program under test, built from a configuration's file: the port's
``NoiseFlow`` with the configuration's settings and checkpoint."""

from __future__ import annotations

import dataclasses
from typing import Dict


def flow(config: Dict, device):
    """A ``NoiseFlow`` on ``device`` with ``config``'s settings (the keys
    that are fields of the port's ``Config``) and its checkpoint's weights."""
    from noise_flow_tpu_torch.config import Config, default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    names = {f.name for f in dataclasses.fields(Config)}
    hps = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config.items() if k in names}
    model = NoiseFlow(tuple(config["x_shape"]), default_config(**hps), device=device)
    load_checkpoint(config["weights_path"], model)
    return model
