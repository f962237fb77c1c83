"""Checkpoints in the JAX package's npz format, read and written without JAX.

The format (noise_flow_tpu.utils.checkpoint) is a flat npz whose keys are
``<group>|<jax key path>``: ``params|['layers']/[0]/[2]/['nn']/['l1_w']``,
``state|['layers']/[0]/[1]/['frozen']/['p']``, ``opt|...`` and
``__epoch__``. The port's ``state_dict`` key of a leaf is its key path with
the level index after ``layers`` dropped for level 0
(``['layers']/[0]/[2]/['nn']/['l1_w']`` is ``layers.2.nn.l1_w``) and
``layers`` renamed ``levels`` for a level above it (``['layers']/[1]/[2]``
is ``levels.1.2``); the split priors keep their path
(``['splits']/[0]/['w']`` is ``splits.0.w``), as every other tree does (the
DnCNN's ``['convs']/[0]`` is ``convs.0``). Parameters come from the
``params`` group, buffers from ``state``, so both packages read each other's
weights, the flow's and the DnCNN's.

The ``opt`` group holds the optimizer state in the port's own layout,
``opt|torch/<parameter name>/<slot>`` (``exp_avg``, ``exp_avg_sq``, ``step``
for Adam; ``momentum_buffer`` for SGD). The JAX package's optax layout
differs: a checkpoint in the other package's layout loads its parameters and
state and resumes without the optimizer slots, with a warning, as the JAX
loader does for a layout it does not know.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_TOKEN = re.compile(r"^\[(?:'([^']*)'|(\d+))\]$")


def _parse_path(key: str) -> Tuple:
    """"['layers']/[0]/[2]/['nn']" -> ('layers', 0, 2, 'nn')."""
    out = []
    for tok in key.split("/"):
        m = _TOKEN.match(tok)
        if m is None:
            raise ValueError(f"bad checkpoint key path {key!r}")
        out.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
    return tuple(out)


def _format_path(path: Tuple) -> str:
    return "/".join(f"[{p}]" if isinstance(p, int) else f"['{p}']" for p in path)


def _path_to_key(path: Tuple) -> str:
    """JAX tree path -> port state_dict key."""
    if path[0] == "layers":
        path = (("layers",) if path[1] == 0 else ("levels", path[1])) + path[2:]
    return ".".join(str(p) for p in path)


def _key_to_path(key: str) -> Tuple:
    parts = tuple(int(p) if p.isdigit() else p for p in key.split("."))
    if parts[0] == "layers":
        parts = ("layers", 0) + parts[1:]
    elif parts[0] == "levels":
        parts = ("layers",) + parts[1:]
    return parts


def _walk(tree, prefix=()) -> Iterator[Tuple[Tuple, np.ndarray]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


def from_numpy_tree(params, state) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter and state trees (leaves as numpy arrays)
    -> a ``state_dict`` for the port's ``NoiseFlow``, so both packages can
    hold the same weights: ``flow.load_state_dict(from_numpy_tree(p, s))``.

    The JAX DnCNN's ``(params, state)`` trees carry over the same way into
    the port's ``DnCNN``: their key paths are its names (``convs.0``,
    ``biases.first``, ``bn_scale.0``, ``bn.0.mean``)."""
    out = {}
    for tree in (params, state):
        for path, leaf in _walk(tree):
            out[_path_to_key(path)] = torch.as_tensor(
                np.array(leaf, dtype=np.float32))
    return out


def _load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise KeyError(f"checkpoint missing leaves {missing}")
    for k, v in sd.items():
        if k not in own:
            raise KeyError(f"checkpoint leaf {k!r} has no place in the model")
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"shape mismatch for {k}: ckpt {tuple(v.shape)} "
                             f"vs model {tuple(own[k].shape)}")
    module.load_state_dict(sd, strict=True)


_OPT_PREFIX = "torch/"


def _load_optimizer(path: str, module, optimizer, opt: Dict[str, np.ndarray]) -> None:
    params = dict(module.named_parameters())
    slots: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in opt.items():
        name, _, slot = key[len(_OPT_PREFIX):].rpartition("/")
        if not key.startswith(_OPT_PREFIX) or name not in params:
            logging.getLogger(__name__).warning(
                "checkpoint %s: optimizer state layout does not match the "
                "current optimizer; resuming without it", path)
            return
        slots.setdefault(name, {})[slot] = v
    # a capturable optimizer (one a CUDA graph steps) keeps its step count
    # on the parameter's device, any other on the host
    capturable = optimizer.defaults.get("capturable", False)
    for name, st in slots.items():
        p = params[name]
        optimizer.state[p] = {
            k: torch.as_tensor(v, device=p.device if k != "step" or capturable else None)
            for k, v in st.items()}


def load_checkpoint(path: str, module: torch.nn.Module, optimizer=None) -> int:
    """Load an npz checkpoint's params and state into ``module`` and, given
    an ``optimizer`` over ``module.parameters()``, its optimizer slots;
    returns the epoch it was written at."""
    sd, opt = {}, {}
    with np.load(path, allow_pickle=False) as z:
        epoch = int(z["__epoch__"])
        for k in z.files:
            if k == "__epoch__":
                continue
            group, key = k.split("|", 1)
            if group in ("params", "state"):
                sd[_path_to_key(_parse_path(key))] = torch.as_tensor(
                    np.array(z[k], dtype=np.float32))
            elif group == "opt":
                opt[key] = np.array(z[k])
    _load_into(module, sd)
    if optimizer is not None and opt:
        _load_optimizer(path, module, optimizer, opt)
    return epoch


def save_checkpoint(ckpt_dir: str, tag, module: torch.nn.Module,
                    epoch: int = 0, optimizer=None) -> str:
    """Write ``module``'s parameters and buffers as ``model.ckpt-<tag>.npz``
    in the JAX package's format, and the ``optimizer``'s slots (if given)
    in the ``opt`` group."""
    os.makedirs(ckpt_dir, exist_ok=True)
    out = {}
    params = dict(module.named_parameters())
    for k, v in module.state_dict().items():
        group = "params" if k in params else "state"
        out[f"{group}|{_format_path(_key_to_path(k))}"] = v.detach().cpu().numpy()
    if optimizer is not None:
        for name, p in params.items():
            for slot, v in optimizer.state.get(p, {}).items():
                out[f"opt|{_OPT_PREFIX}{name}/{slot}"] = np.asarray(
                    v.detach().cpu().numpy() if torch.is_tensor(v) else v)
    out["__epoch__"] = np.asarray(epoch)
    path = os.path.join(ckpt_dir, f"model.ckpt-{tag}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Find the highest-epoch checkpoint (ref:sidd_utils.py:1152-1162)."""
    best, best_ep = None, -1
    for p in glob.glob(os.path.join(ckpt_dir, "model.ckpt-*.npz")):
        m = re.search(r"model\.ckpt-(\d+)\.npz$", p)
        if m and int(m.group(1)) > best_ep:
            best_ep, best = int(m.group(1)), p
    return best
