"""The traffic generators, one a mix ``kind`` (``drivers/<kind>.py``, class ``Driver``).

A driver is made from a configuration (``configs/<name>.json``), a mix
(``mixes/<name>.json``), the run's seed and a device, and drives the program through its
own entry functions:

 * ``setup()``: the cell's kernels built, the scene and the weights made from the seed,
   the program's objects made and every shape of the window warmed; what the check needs
   of the timed path's first output is kept;
 * ``unit()``: one unit of traffic through the timed path, returning its ``Unit``;
 * ``verify(units)``: after the window, each unit's ``finite`` set;
 * ``work(units)``: the analytic work of ``units`` units (``steps`` or ``views``,
   ``flops``, the point ``queries``), for the per-layer readers;
 * ``release()``: the program's state freed;
 * ``check()``: the reference on the same inputs; the numbers compared, by name.

Seeds: every generator of a run is seeded from ``--seed`` and a fixed salt
(``sub_seed``), so one seed gives the same scene, weights and draws.

``stage(name)`` marks the end of a stage of the set-up; ``run.py`` logs each stage's
seconds (``stages``), so a set-up that grows shows where.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

SALTS = {"scene": 1, "weights": 2, "batch": 3, "step": 4, "views": 5, "sample": 6}
STAGES: List[Tuple[str, float]] = []     # (stage, the clock at its end)


def stage(name: str, device: Optional[torch.device] = None) -> None:
    """The end of the set-up's stage ``name``, after the device's queue has drained."""
    sync(device)
    STAGES.append((name, time.time()))


def sub_seed(seed: int, what: str) -> int:
    return (int(seed) * 8 + SALTS[what]) % (2 ** 63)


@dataclasses.dataclass
class Unit:
    rays: int           # rays (train) or pixels (views) the unit completed
    seconds: float      # from its start to its outputs on the host
    finite: bool = True
    attempted: int = 1  # steps or views


def program_config(conf: dict, mix: dict, **extra):
    """The port's ``Config`` of a configuration, a mix and ``extra`` keys: every key of
    them that is a field of ``Config``, a later one over an earlier one."""
    from dmnerf_tpu_torch.configs import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for src in (conf, mix, extra) for k, v in src.items() if k in fields}
    if "skips" in kw:
        kw["skips"] = tuple(kw["skips"])
    return Config(**kw)


def scene_data(scene):
    """The port's ``SceneData`` of a benchmark scene (host arrays, as a loader gives)."""
    from dmnerf_tpu_torch.data.scene import SceneData

    return SceneData(
        images=scene.images.cpu().numpy(), poses=scene.poses.cpu().numpy(), H=scene.H,
        W=scene.W, K=scene.K.cpu().numpy(), i_train=scene.i_train, i_test=scene.i_test,
        gt_labels=scene.labels.cpu().numpy().astype(np.int32),
        ins_rgbs=np.zeros((scene.ins_num, 3), np.uint8), ins_num=scene.ins_num,
        ins_indices=scene.ins_indices, crop_mask=scene.crop_mask)


def build(conf: dict, kind: str, device: torch.device) -> None:
    """The kernel sources the configuration lists for this kind, built together (a
    source built in this checkout before is found and not built again)."""
    if device.type != "cuda":
        return
    from dmnerf_tpu_torch.kernels import runtime

    names = conf.get("sources", {}).get(kind)
    if names:
        runtime.build(names)


def release_cuda(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
