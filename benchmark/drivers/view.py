"""Held-out views, one after another over the scene's test poses, without perturbation:
``render.renderer.make_image_renderer``'s render function driven as
``render.evaluation.render_test`` drives it (the pose to the device, ``core.rays.rays_from_K``,
the chunked render, the rgb and instance maps to the host), without the host's scoring.
A unit is one view, timed from its pose to its maps on the host.

The check: views drawn from the seed among those the window completed, each rendered
again by the reference from the same weights. The numbers, each the worst sampled view's:
the root mean square difference of the rgb map (``rgb_rms``) and of the instance map, the
probabilities of every instance (``ins_rms``), and the median pixel's rgb difference
(``rgb_med``). Which of them a cell compares, its ``limits/<cell>.json`` says.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import compare, yardstick
from benchmark.drivers import Unit, build, program_config, release_cuda, stage, sub_seed
from benchmark.reference.nerf import fp32_matmul, render_view
from benchmark.scene import make_scene
from benchmark.weights import make_models


def view_rays(scene, c2w: torch.Tensor):
    """A view's flat rays, as the reference makes them."""
    H, W, K = scene.H, scene.W, scene.K
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=K.device),
                          torch.arange(W, dtype=torch.float32, device=K.device), indexing="ij")
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                        K[2, 2] * torch.ones_like(i)], -1).reshape(-1, 3)
    d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand_as(d), d


class Driver:
    kind = "view"

    def __init__(self, conf: dict, mix: dict, seed: int, device: torch.device):
        self.conf, self.mix, self.seed, self.device = conf, mix, seed, device

    def setup(self) -> None:
        conf, dev = self.conf, self.device
        build(conf, self.kind, dev)
        stage("build")
        self.scene = make_scene(conf, torch.Generator(dev).manual_seed(sub_seed(self.seed, "scene")))
        self.pc, self.pf = self._models()
        stage("scene and weights", dev)
        self.cfg = program_config(conf, self.mix, perturb=0.0)
        self.poses = self.scene.poses[torch.as_tensor(self.scene.i_test)].cpu().numpy()
        self.K = self.scene.K
        self.renderer = self._renderer()
        stage("renderer", dev)
        self.outputs: List[Dict[str, np.ndarray]] = []
        self.unit()                 # warm-up: every chunk shape of a view
        self.outputs.clear()
        stage("warm-up view", dev)

    def _models(self):
        return make_models(self.conf, sub_seed(self.seed, "weights"), self.device)

    def _renderer(self):
        from dmnerf_tpu_torch.render.renderer import make_image_renderer

        return make_image_renderer(self.cfg)

    def _render(self, i: int) -> Dict[str, np.ndarray]:
        from dmnerf_tpu_torch.core.rays import rays_from_K

        c2w = torch.as_tensor(self.poses[i % len(self.poses)], dtype=torch.float32,
                              device=self.device)
        o, d = rays_from_K(self.scene.H, self.scene.W, self.K, c2w)
        out = self.renderer(self.pc, self.pf, o.reshape(-1, 3), d.reshape(-1, 3))
        return {"rgb": out["rgb"].cpu().numpy(), "ins": out["ins"].cpu().numpy()}

    def unit(self) -> Unit:
        t0 = time.perf_counter()
        out = self._render(len(self.outputs))
        dt = time.perf_counter() - t0
        self.outputs.append(out)
        return Unit(rays=self.scene.H * self.scene.W, seconds=dt)

    def verify(self, units: List[Unit]) -> None:
        """Mark the views whose maps hold a value that is not finite (after the window)."""
        for u, out in zip(units, self.outputs):
            u.finite = bool(np.isfinite(out["rgb"]).all() and np.isfinite(out["ins"]).all())

    def work(self, units: int) -> dict:
        c, n = self.conf, units * self.scene.H * self.scene.W
        queries = [{"points": n * c["N_samples"], "rays": n, "model": "sigma", "pass": "fwd"},
                   {"points": n * (c["N_samples"] + c["N_importance"]), "rays": n,
                    "model": "full", "pass": "fwd"}]
        flops = sum(yardstick.query_work(c, q)[0] for q in queries)
        return {"views": units, "flops": flops, "queries": queries}

    def release(self) -> None:
        del self.renderer
        release_cuda(self.device)

    def sample(self) -> List[int]:
        """The views the check compares: ``check_views`` of the completed ones, drawn from
        the seed."""
        rng = np.random.default_rng(sub_seed(self.seed, "sample"))
        k = min(self.mix["check_views"], len(self.outputs))
        return sorted(rng.choice(len(self.outputs), size=k, replace=False).tolist())

    def reference(self, i: int, prec: str = "fp32") -> Dict[str, np.ndarray]:
        c2w = torch.as_tensor(self.poses[i % len(self.poses)], dtype=torch.float32,
                              device=self.device)
        o, d = view_rays(self.scene, c2w)
        with fp32_matmul():
            rgb, ins = render_view(self.pc, self.pf, o, d, self.conf, prec, self.conf["N_test"])
        return {"rgb": rgb.cpu().numpy(), "ins": ins.cpu().numpy()}

    def check(self, prec: str = "fp32") -> Dict[str, float]:
        numbers = {"rgb_rms": compare.rms, "ins_rms": compare.rms, "rgb_med": compare.median_gap}
        worst = {k: 0.0 if self.sample() else float("inf") for k in numbers}
        for i in self.sample():
            ref = self.reference(i)
            out = self.outputs[i] if prec == "fp32" else self.reference(i, prec)
            for k, fn in numbers.items():
                m = k.split("_")[0]
                worst[k] = max(worst[k], fn(out[m], ref[m]))
        return worst
