"""Checkpoints as ``torch.save`` files of ``{params_coarse, params_fine, step}``.

A run keeps them as ``<run>/checkpoints/<step>.pt``, written zero-padded
(``000100.pt``); the reader takes padded and unpadded names alike. Optimizer state
joins the payload with the training slice of the port.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Tuple

import torch

_NAME = re.compile(r"(\d+)\.pt")


def _ckpt_path(log_dir: str, step: int) -> str:
    return os.path.join(log_dir, "checkpoints", f"{step:06d}.pt")


def save_checkpoint(log_dir: str, params_coarse: Dict, params_fine: Dict, step: int) -> str:
    path = _ckpt_path(log_dir, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {
        "step": int(step),
        "params_coarse": {k: v.detach().cpu() for k, v in params_coarse.items()},
        "params_fine": {k: v.detach().cpu() for k, v in params_fine.items()},
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _steps(log_dir: str) -> Dict[int, str]:
    d = os.path.join(log_dir, "checkpoints")
    if not os.path.isdir(d):
        return {}
    return {int(m.group(1)): os.path.join(d, f)
            for f in os.listdir(d) if (m := _NAME.fullmatch(f))}


def resolve_ckpt_path(ft_path: str) -> Tuple[str, int]:
    """A user-facing ``ft_path`` as ``(checkpoint file, step)``:
      * ``<run>/checkpoints/<step>.pt``  -> that file (padded or not);
      * ``<run>/checkpoints``            -> its latest step;
      * ``<run>``                        -> its latest step.
    Raises FileNotFoundError for a path that names no checkpoint."""
    p = os.path.normpath(ft_path)
    m = _NAME.fullmatch(os.path.basename(p))
    if m is not None:
        if not os.path.isfile(p):
            raise FileNotFoundError(f"ft_path names checkpoint step {int(m.group(1))} but {p} "
                                    "does not exist")
        return p, int(m.group(1))
    log_dir = os.path.dirname(p) if os.path.basename(p) == "checkpoints" else p
    steps = _steps(log_dir)
    if not steps:
        raise FileNotFoundError(
            f"ft_path={ft_path!r} resolves to no checkpoint (expected a "
            "<run>/checkpoints/<step>.pt file, a <run>/checkpoints dir, or a run dir "
            "containing checkpoints/)")
    step = max(steps)
    return steps[step], step


def load_checkpoint(path: str, device) -> Tuple[Dict, Dict, int]:
    payload = torch.load(path, map_location=device, weights_only=True)
    return payload["params_coarse"], payload["params_fine"], int(payload["step"])


def restore_checkpoint(log_dir: str, device):
    """(params_coarse, params_fine, step) of the latest step under ``log_dir``, or
    None if there is none."""
    steps = _steps(log_dir)
    return load_checkpoint(steps[max(steps)], device) if steps else None
