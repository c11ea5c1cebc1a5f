"""Checkpoints as ``torch.save`` files of ``{params_coarse, params_fine, step,
opt_state}``; ``opt_state`` is the Adam ``state_dict`` of a training run (None for
parameters saved without one), and callers that only render ignore it.

A run keeps them as ``<run>/checkpoints/<step>.pt``, written zero-padded
(``000100.pt``); the reader takes padded and unpadded names alike. In a process group
only rank 0 writes, and every rank waits for it; every rank reads.

``checkpoint_from_numpy`` turns the JAX package's checkpoint, read as numpy
(``scripts/orbax_to_torch.py`` reads it from Orbax), into this format.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dmnerf_tpu_torch.core.mlp import params_from_numpy
from dmnerf_tpu_torch.render.trainstep import make_adam
from dmnerf_tpu_torch.utils.device import barrier, is_writer

_NAME = re.compile(r"(\d+)\.pt")


def _ckpt_path(log_dir: str, step: int) -> str:
    return os.path.join(log_dir, "checkpoints", f"{step:06d}.pt")


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(log_dir: str, params_coarse: Dict, params_fine: Dict, step: int,
                    opt_state: Optional[Dict] = None) -> str:
    """Writes the checkpoint of ``step`` (rank 0 of a process group; the others wait)
    and returns its path."""
    path = _ckpt_path(log_dir, step)
    if is_writer():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "step": int(step),
            "params_coarse": _to_cpu(params_coarse),
            "params_fine": _to_cpu(params_fine),
            "opt_state": _to_cpu(opt_state),
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    barrier()
    return path


def checkpoint_steps(log_dir: str) -> Dict[int, str]:
    """{step: file} of the complete checkpoints under ``log_dir`` (a ``.pt.tmp`` that a
    kill left mid-write is not one)."""
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
    steps = checkpoint_steps(log_dir)
    if not steps:
        raise FileNotFoundError(
            f"ft_path={ft_path!r} resolves to no checkpoint (expected a "
            "<run>/checkpoints/<step>.pt file, a <run>/checkpoints dir, or a run dir "
            "containing checkpoints/)")
    step = max(steps)
    return steps[step], step


def load_checkpoint(path: str, device) -> Tuple[Dict, Dict, int, Optional[Dict]]:
    """(params_coarse, params_fine, step, opt_state) of one checkpoint file."""
    payload = torch.load(path, map_location=device, weights_only=True)
    return (payload["params_coarse"], payload["params_fine"], int(payload["step"]),
            payload.get("opt_state"))


def restore_checkpoint(log_dir: str, device):
    """(params_coarse, params_fine, step, opt_state) of the latest step under
    ``log_dir``, or None if there is none."""
    steps = checkpoint_steps(log_dir)
    return load_checkpoint(steps[max(steps)], device) if steps else None


def state_digest(params_coarse: Mapping, params_fine: Mapping, opt_state: Optional[Dict]) -> Dict:
    """SHA-256 hex digests of a training state's bits: ``params`` over the coarse then
    the fine tensors, ``adam`` over each parameter's Adam step count, first and second
    moments (``opt_state`` a ``state_dict``), each tensor's bytes on the host in its
    own dtype. A restored state and its checkpoint file are equal bit for bit exactly
    when their digests are."""
    def feed(h, t):
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
        h.update(str(t.dtype).encode())

    params = hashlib.sha256()
    for t in [*params_coarse.values(), *params_fine.values()]:
        feed(params, t)
    adam = hashlib.sha256()
    states = (opt_state or {}).get("state", {})
    for i in sorted(states):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            feed(adam, torch.as_tensor(states[i][key]))
    return {"params": params.hexdigest(), "adam": adam.hexdigest()}


def checkpoint_from_numpy(tree: Mapping) -> Tuple[Dict, Dict, int, Dict]:
    """(params_coarse, params_fine, step, opt_state) of a JAX package checkpoint given
    as numpy: ``{step, params_coarse, params_fine, opt_state}``, where ``opt_state`` is
    the state of ``optax.adam`` over ``(params_coarse, params_fine)`` (a chain whose
    first element holds ``count``, ``mu`` and ``nu``, each moment a pair of dicts).

    The parameters keep the tree's keys and layout. The moments become the state of
    the run's Adam over these parameters (``render.trainstep.make_adam``: the coarse
    tensors then the fine ones, in each dict's insertion order), each placed by its
    key, whatever order the tree's dicts have (JAX flattens them sorted). The group's
    learning rate is left at 0: the train step sets it before every update."""
    pc = params_from_numpy(tree["params_coarse"], "cpu")
    pf = params_from_numpy(tree["params_fine"], "cpu")
    adam = tree["opt_state"][0]
    count = float(np.asarray(adam["count"]))
    state = make_adam(pc, pf, lr=0.0).state_dict()
    keys = [(0, k, v) for k, v in pc.items()] + [(1, k, v) for k, v in pf.items()]
    for i, (which, k, v) in enumerate(keys):
        moments = [torch.from_numpy(np.array(adam[m][which][k], copy=True)) for m in ("mu", "nu")]
        if any(t.shape != v.shape for t in moments):
            raise ValueError(f"Adam moments of {k} have shapes {[tuple(t.shape) for t in moments]}, "
                             f"the parameter {tuple(v.shape)}")
        state["state"][i] = {"step": torch.tensor(count, dtype=torch.float32),
                             "exp_avg": moments[0], "exp_avg_sq": moments[1]}
    return pc, pf, int(np.asarray(tree["step"])), state
