"""Manipulated views, one after another over the scene's test poses:
``render.manipulator.make_manipulator_renderer(cfg, 1)`` driven as
``render.mani_eval.manipulator_eval`` drives it (the original view's rays and the target
bundle's, rendered from translation @ pose, the moved label ``target_label``, the
importance draws from a device generator a view), the rgb and instance maps to the host,
without the scoring. A unit is one view. The weights lift the moved label's logit
(``_models``), so that the exchange moves a share of the scene, as it moves an object of
a trained one.

The check: as the view traffic's, with the reference's manipulation (both bundles'
queries, the exchange, compositing) on the same importance draws: the renderer seeds one
generator a chunk of ``N_test`` rays from the view's generator, and the reference draws
the same uniforms from the same seeds in the same order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import yardstick
from benchmark.drivers import sub_seed
from benchmark.drivers.view import Driver as ViewDriver, view_rays
from benchmark.reference.nerf import fp32_matmul, manipulate
from benchmark.weights import make_models


class Driver(ViewDriver):
    kind = "mani"

    def _models(self):
        """The weights with the moved label's logit lifted by the mix's ``label_lift``:
        drawn at random, the moved label is carried by under 1 % of the points, and on
        two seeds of three by no point that a ray weighs, so the exchange changes no
        pixel."""
        return make_models(self.conf, sub_seed(self.seed, "weights"), self.device,
                           (int(self.conf["target_label"]), self.mix["label_lift"]))

    def _renderer(self):
        from dmnerf_tpu_torch.render.manipulator import make_manipulator_renderer

        t = torch.eye(4)
        t[:3, 3] = torch.tensor(self.mix["translation"])
        self.trans = t.numpy()
        self.moves = (int(self.conf["target_label"]),)
        return make_manipulator_renderer(self.cfg, self.mix["targets"])

    def _view_seed(self, i: int) -> int:
        return (sub_seed(self.seed, "views") + i) % (2 ** 63)

    def _render(self, i: int) -> Dict[str, np.ndarray]:
        from dmnerf_tpu_torch.core.rays import rays_from_K

        pose = self.poses[i % len(self.poses)]
        rays = []
        for c2w in (pose, self.trans @ pose):
            c2w_t = torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=self.device)
            o, d = rays_from_K(self.scene.H, self.scene.W, self.K, c2w_t)
            rays.append((o.reshape(-1, 3), d.reshape(-1, 3)))
        (o, d), (to, td) = rays
        gen = torch.Generator(device=self.device).manual_seed(self._view_seed(i))
        out = self.renderer(self.pc, self.pf, o, d, to[None], td[None], self.moves, generator=gen)
        return {"rgb": out["rgb"].cpu().numpy(), "ins": out["ins"].cpu().numpy()}

    def work(self, units: int) -> dict:
        """Per ray of K = 1: pass 1 the original's coarse (sigma and labels) and
        fine-label queries, the target's full coarse and fine-label queries; pass 2 both
        bundles' full queries on the union of 64 + 128 + K * 128 samples."""
        c, n = self.conf, units * self.scene.H * self.scene.W
        K, Ns, Ni = self.mix["targets"], c["N_samples"], c["N_importance"]
        q = [(Ns, "sigma_ins"), (Ns + Ni, "sigma_ins")]
        q += K * [(Ns, "full"), (Ns + Ni, "sigma_ins")]
        q += (1 + K) * [(Ns + Ni + K * Ni, "full")]
        queries = [{"points": n * s, "rays": n, "model": m, "pass": "fwd"} for s, m in q]
        flops = sum(yardstick.query_work(c, x)[0] for x in queries)
        return {"views": units, "flops": flops, "queries": queries}

    def reference(self, i: int, prec: str = "fp32") -> Dict[str, np.ndarray]:
        dev, chunk = self.device, self.conf["N_test"]
        pose = self.poses[i % len(self.poses)]
        o, d = view_rays(self.scene, torch.as_tensor(pose, dtype=torch.float32, device=dev))
        to, td = view_rays(self.scene, torch.as_tensor(self.trans @ pose, dtype=torch.float32,
                                                       device=dev))
        n = o.shape[0]
        nc = -(-n // chunk)
        K = self.mix["targets"]
        gen = torch.Generator(device=dev).manual_seed(self._view_seed(i))
        seeds = torch.randint(0, 2 ** 62, (nc,), generator=gen, device=dev).tolist()
        rgbs, inss = [], []
        with fp32_matmul():
            for c in range(nc):
                g = torch.Generator(device=dev).manual_seed(seeds[c])
                # the renderer draws the original's, each target's, then the second pass's
                u = [torch.rand((chunk, self.conf["N_importance"]), generator=g, device=dev)
                     for _ in range(K + 2)]
                s = slice(c * chunk, min((c + 1) * chunk, n))
                m = s.stop - s.start
                rgb, ins = manipulate(self.pc, self.pf, (o[s], d[s]),
                                      [(to[s], td[s])], self.moves, self.conf,
                                      [x[:m] for x in u], prec)
                rgbs.append(rgb)
                inss.append(ins)
        return {"rgb": torch.cat(rgbs).cpu().numpy(), "ins": torch.cat(inss).cpu().numpy()}
