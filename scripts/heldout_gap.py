"""Held-out against train-view PSNR of a trained synthetic ScanNet scene, with either
package on the same scene and settings: the port (``--pkg port``, on the CPU) or the JAX
reference (``--pkg jax``, on its CPU backend).

    python3 scripts/heldout_gap.py --pkg port|jax [--iters 1500] [--seed 0] [--out FILE]

The ScanNet writer (``data/synthetic.py``, the same in both packages) places its
``n_train + n_test`` cameras evenly on one circle, the train views first: with its
defaults (5 + 3) the three test views look at the half of the scene no train view sees.
This trains a small model (D 4, W 64, 32 + 32 samples, 512 rays a step) on a 48x64
scene with a 48x32 crop from the scene0010_00 train config, then renders every train
and every test view through each package's own ``render_test`` (the crop path), and
prints one JSON line: the mean PSNR and mAP@.5 of each split. Run it with both packages
(the JAX one needs JAX, so not on a card host) to read the gap against the reference's
on the same inputs; the random streams differ, so compare a few seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CONFIG = os.path.join(REPO, "configs", "train", "scannet", "scene0010_00.txt")
SMALL = dict(resize=False, crop_width=48, crop_height=32, netdepth=4, netwidth=64,
             N_samples=32, N_importance=32, N_train=512, i_print=250, i_save=10 ** 9,
             i_test=10 ** 9)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pkg", required=True, choices=("port", "jax"))
    ap.add_argument("--iters", type=int, default=1500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--work", default=os.path.join(REPO, "build", "heldout_gap"))
    ap.add_argument("--out", default=None, help="append the JSON line to this file too")
    args = ap.parse_args(argv)
    datadir = os.path.join(args.work, "scene")
    keys = dict(SMALL, datadir=datadir, basedir=os.path.join(args.work, f"{args.pkg}_{args.seed}"),
                expname="heldout", N_iters=args.iters, seed=args.seed)
    if args.pkg == "port":
        import torch

        from dmnerf_tpu_torch.configs import load_config
        from dmnerf_tpu_torch.data.scannet import load_scannet
        from dmnerf_tpu_torch.data.synthetic import write_scannet_scene
        from dmnerf_tpu_torch.render.evaluation import render_test
        from dmnerf_tpu_torch.train import train

        torch.set_num_threads(min(4, os.cpu_count() or 1))
        write_scannet_scene(datadir, H=48, W=64, n_objects=6, unlabeled_frac=0.5)
        cfg = load_config(CONFIG, **keys)
        scene = load_scannet(cfg)
        state = train(cfg, scene, device="cpu")
        params = (state.params_coarse, state.params_fine)
        extra = {"device": "cpu"}
    else:
        from dmnerf_tpu.configs import load_config
        from dmnerf_tpu.data.scannet import load_scannet
        from dmnerf_tpu.data.synthetic import write_scannet_scene
        from dmnerf_tpu.render.evaluation import render_test
        from dmnerf_tpu.test import load_params
        from dmnerf_tpu.train import train

        write_scannet_scene(datadir, H=48, W=64, n_objects=6, unlabeled_frac=0.5)
        cfg = load_config(CONFIG, **keys)
        scene = load_scannet(cfg)
        train(cfg, scene)
        state, _ = load_params(cfg.replace(ins_num=scene.ins_num))
        params = (state.params_coarse, state.params_fine)
        extra = {}
    cfg = cfg.replace(ins_num=scene.ins_num, perturb=0.0)
    out = {"pkg": args.pkg, "seed": args.seed, "iters": args.iters}
    for split, ids in (("train", scene.i_train), ("test", scene.i_test)):
        r = render_test(cfg, *params, scene.poses[ids], scene.hwk, gt_imgs=scene.images[ids],
                        gt_labels=scene.gt_labels[ids], ins_rgbs=scene.ins_rgbs, savedir=None,
                        crop_mask=scene.crop_mask, **extra)
        out[f"{split}_psnr"] = float(np.mean(r["psnrs"]))
        out[f"{split}_ap50"] = float(np.asarray(r["aps"])[:, 0].mean())
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
