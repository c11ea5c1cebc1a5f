"""Cells shrunk for the CPU: few rays, samples and pixels; the widths are kept unless a
test asks for narrower ones. On the CPU the program's point query is its fp32 plain
version, so the program and the reference agree to rounding."""

from __future__ import annotations

import copy

from benchmark import registry


def tiny_cell(name: str, width: int = 256, rays: int = 64, limits=None) -> dict:
    c = copy.deepcopy(registry.cell(name))
    conf = c["conf"]
    conf.update(netwidth=width, N_train=rays, N_test=128, N_samples=8, N_importance=8)
    s = conf["scene"]
    if conf["dataset_type"] == "dmsr":
        conf.update(ins_num=8, target_label=2)
        s.update(H=24, W=20, objects=4, train_views=3, test_views=2)
    else:
        conf.update(ins_num=4, crop_width=24, crop_height=16)
        s.update(H=24, W=32, objects=4, train_views=3, test_views=2, crop_width=24,
                 crop_height=16)
    if limits is not None:
        c["limits"] = limits
    return c
