"""The ranks' side of ``tests/test_torch_parallel.py``: one process of a gloo world on
the CPU, which imports no JAX. That file's tests start it as

    python tests/test_torch_parallel_ranks.py OUT_DIR CASE[,CASE...]

with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in its
environment, as ``torchrun`` sets them. It joins the group through
``parallel.mesh.init_process_group`` (``env://``), runs the cases and saves what this rank
computed to ``OUT_DIR/rank<r>.pt``. Its case helpers (scenes, configs, batches) are
shared with the parent, which runs the same inputs unsharded and through the JAX
package. It holds no tests of its own.
"""

import contextlib
import datetime
import io
import os
import sys

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.data.samplers import make_crop_sampler, make_full_sampler
from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene, build_scannet_scene

TINY = dict(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
            N_samples=8, N_importance=8, N_train=64, N_test=32, near=2.0, far=7.0,
            lrate=5e-3, lrate_decay=500, perturb=1.0, penalize=True, tolerance=0.05,
            deta_w=0.05)
N_RAYS = 101        # a ray count no world size divides
N_POINTS = 301      # a point count no world size divides
MANI_RAYS = 64
KEYED_RAYS = 16     # rays a rank in the keyed-mode case
STEPS = 3           # perturbed steps from the generators
PACK = 4


def scenes():
    """The full-image scene (DM-SR) and the crop scene (ScanNet: labelled suffix, images
    with fewer labelled pixels than N_ins, so padded slots)."""
    full = build_dmsr_scene(n_train=4, n_test=1, H=16, W=16, n_objects=3, ins_num=8, seed=0)
    crop = build_scannet_scene(Config(crop_width=16, crop_height=12, weakly_value=1.0),
                               n_train=3, n_test=1, H=16, W=20, n_objects=3, seed=0)
    return {"full": full, "crop": crop}


def config(scene, **kw) -> Config:
    return Config(**{**TINY, "ins_num": scene.ins_num, **kw})


def sampler(kind, scene, cfg):
    """(sampler, N_ins) of the scene's kind, on the CPU."""
    if kind == "crop":
        return make_crop_sampler(scene.images, scene.gt_labels, scene.poses, scene.K,
                                 scene.i_train, cfg.N_train, scene.ins_indices,
                                 scene.crop_mask, device="cpu")
    return make_full_sampler(scene.images, scene.gt_labels, scene.poses, scene.K,
                             scene.i_train, cfg.N_train, device="cpu"), None


def fixed_batches(kind, scene, cfg):
    """Two batches from injected ids (numpy draws): image / slot 0 and 1. The crop
    scene's images 0 and 1 have 12 and 18 labelled pixels, under N_ins = 19, so both
    labelled suffixes end in padded slots (target_valid False)."""
    sample, n_ins = sampler(kind, scene, cfg)
    rng = np.random.RandomState(0)
    out = []
    for t in (0, 1):
        if kind == "crop":
            L = max(max(len(ix) for ix in scene.ins_indices), n_ins)
            crop = np.where(np.asarray(scene.crop_mask).reshape(-1) == 1)[0]
            out.append(sample(t=t, lab_slots=torch.from_numpy(rng.permutation(L)[:n_ins]),
                              rgb_ids=torch.from_numpy(rng.choice(crop, cfg.N_train - n_ins,
                                                                  replace=False))))
        else:
            H, W = scene.images.shape[1:3]
            out.append(sample(img_i=int(scene.i_train[t]),
                              pix=torch.from_numpy(rng.choice(H * W, cfg.N_train, replace=False))))
    return out, n_ins


def init(cfg):
    from dmnerf_tpu_torch.render.trainstep import create_train_state
    from dmnerf_tpu_torch.test import init_params

    return create_train_state(cfg, *init_params(cfg, "cpu"))


def params_of(state):
    return {f"{w} {k}": p.detach().clone() for w, ps in (("coarse", state.params_coarse),
                                                        ("fine", state.params_fine))
            for k, p in ps.items()}


def adam_of(state):
    """Adam's state of each parameter, by the names of ``params_of``."""
    return {f"{w} {k}": {m: v.clone() for m, v in state.opt.state[p].items()}
            for w, ps in (("coarse", state.params_coarse), ("fine", state.params_fine))
            for k, p in ps.items()}


def run_steps(kind, scene, step_maker):
    """One deterministic step on batch 0 (perturb 0), then STEPS perturbed steps on
    batches 0, 1, 0 with the draws from a seeded generator: auxs, parameters."""
    out = {}
    cfg0 = config(scene, perturb=0.0)
    batches, n_ins = fixed_batches(kind, scene, cfg0)
    state = init(cfg0)
    aux = step_maker(cfg0, n_ins)(state, batches[0])
    out["det"] = {"aux": {k: float(v) for k, v in aux.items()}, "params": params_of(state),
                  "adam": adam_of(state)}
    cfg = config(scene)
    state = init(cfg)
    step = step_maker(cfg, n_ins)
    gen = torch.Generator().manual_seed(7)
    auxs = [{k: float(v) for k, v in step(state, batches[i % 2], generator=gen).items()}
            for i in range(STEPS)]
    out["perturbed"] = {"auxs": auxs, "params": params_of(state), "adam": adam_of(state)}
    return out


def case_step(mesh, sc):
    from dmnerf_tpu_torch.parallel.mesh import make_sharded_train_step

    return {kind: run_steps(kind, sc[kind], lambda cfg, n_ins: make_sharded_train_step(
        cfg, mesh, N_ins=n_ins)) for kind in ("full", "crop")}


def render_inputs(cfg):
    """Rays, points and manipulation bundles from numpy draws."""
    rng = np.random.RandomState(4)
    rays_d = rng.randn(N_RAYS, 3).astype(np.float32)
    rays_d[:, 2] = np.abs(rays_d[:, 2]) + 1.0
    pts = rng.uniform(-2, 2, (N_POINTS, 3)).astype(np.float32)
    mani_d = rng.randn(MANI_RAYS, 3).astype(np.float32)
    mani_d[:, 2] = np.abs(mani_d[:, 2]) + 1.0
    keyed_d = rng.randn(KEYED_RAYS, 3).astype(np.float32)
    keyed_d[:, 2] = np.abs(keyed_d[:, 2]) + 1.0
    return {"rays_o": np.zeros((N_RAYS, 3), np.float32), "rays_d": rays_d, "pts": pts,
            "mani_d": mani_d, "keyed_d": keyed_d}


def mani_args(ro, rd):
    """ori rays, one target bundle (the rays shifted by [0, -0.25, 0]), label 1."""
    tar_o = (ro - torch.tensor([0.0, 0.25, 0.0]))[None]
    return ro, rd, tar_o, rd[None], (1,)


def case_render(mesh, sc):
    from dmnerf_tpu_torch.parallel.mesh import (
        make_sharded_image_renderer, make_sharded_manipulator_renderer, make_sharded_sigma_query)

    cfg = config(sc["full"])
    state = init(cfg)
    pc, pf = state.params_coarse, state.params_fine
    x = {k: torch.from_numpy(v) for k, v in render_inputs(cfg).items()}
    out = {"image": make_sharded_image_renderer(cfg, mesh)(pc, pf, x["rays_o"], x["rays_d"]),
           "sigma": make_sharded_sigma_query(cfg, mesh, chunk=64, samples=8)(pf, x["pts"])}
    run = make_sharded_manipulator_renderer(cfg.replace(N_test=16), mesh, n_targets=1)
    out["mani"] = run(pc, pf, *mani_args(torch.zeros((MANI_RAYS, 3)), x["mani_d"]))
    # every rank's shard the same bundle
    rd = x["keyed_d"].repeat(mesh.size, 1)
    args = mani_args(torch.zeros_like(rd), rd)
    out["keyed_det"] = run(pc, pf, *args)["rgb"]
    out["keyed"] = run(pc, pf, *args, generator=torch.Generator().manual_seed(5))["rgb"]
    return out


def case_packed(mesh, sc):
    """PACK sharded steps packed against PACK sharded steps one at a time, from train()'s
    seeded state and generators: parameters, Adam's state and auxs."""
    from dmnerf_tpu_torch.parallel.mesh import make_packed_sharded_steps, make_sharded_train_step
    from dmnerf_tpu_torch.render.packing import StepRunner

    out = {}
    for kind in ("full", "crop"):
        cfg = config(sc[kind], steps_per_dispatch=PACK, i_print=PACK)
        sample, n_ins = sampler(kind, sc[kind], cfg)
        runs = {}
        for name, runner in (
                ("packed", make_packed_sharded_steps(cfg, sample, n_ins, mesh, PACK)),
                ("single", StepRunner(cfg, sample, make_sharded_train_step(cfg, mesh, N_ins=n_ins),
                                      "cpu", 1))):
            state = init(cfg)
            gb = torch.Generator().manual_seed(cfg.seed + 1)
            gs = torch.Generator().manual_seed(cfg.seed + 2)
            auxs = torch.cat([torch.stack(list(runner(state, gb, gs).values()), -1).clone()
                              for _ in range(PACK // runner.P)])
            runs[name] = {"auxs": auxs, "params": params_of(state), "adam": adam_of(state),
                          "step": state.step}
        out[kind] = runs
    return out


def case_fallback(mesh, sc):
    """N_train = 17, which the world size does not divide: the message, and every rank
    running the unsharded step alike."""
    from dmnerf_tpu_torch.train import build_sampler_and_step

    cfg = config(sc["full"], N_train=17)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, single, _, _ = build_sampler_and_step(cfg, sc["full"], "cpu")
    state = init(cfg)
    single(state, torch.Generator().manual_seed(1), torch.Generator().manual_seed(2))
    return {"message": buf.getvalue(), "params": params_of(state)}


def train_config(scene, basedir, **kw):
    return config(scene, **{"N_iters": 4, "i_print": 1, "i_save": 2, "i_test": 2,
                            "basedir": basedir, "expname": "t", **kw})


def case_train(mesh, sc, out_dir):
    """train() in the world: rank 0 into OUT_DIR/train, the others into a directory of
    their own, which must stay absent; then every rank resumes from rank 0's run."""
    from dmnerf_tpu_torch.train import train

    own = os.path.join(out_dir, "train" if mesh.rank == 0 else f"train_rank{mesh.rank}")
    state = train(train_config(sc["full"], own), sc["full"], device="cpu")
    out = {"params": params_of(state), "wrote": os.path.exists(own)}
    resumed = train(train_config(sc["full"], os.path.join(out_dir, "train"), N_iters=6),
                    sc["full"], device="cpu")
    out.update(resumed_params=params_of(resumed), resumed_step=resumed.step)
    return out


def modes_config(scene, basedir) -> Config:
    """The render and mesh modes' config: seeded init weights (no checkpoint), a 20³
    grid and a level the weights reach (the sweep's 99th occupancy percentile)."""
    from dmnerf_tpu_torch.test import init_params
    from dmnerf_tpu_torch.tools.mesh_extract import build_grid, make_sigma_query

    cfg = config(scene, basedir=basedir, expname="m", perturb=0.0, mesh_grid_dim=20)
    _, pf = init_params(cfg, "cpu")
    sigma = make_sigma_query(cfg)(pf, torch.from_numpy(build_grid(np.eye(4), np.array(
        [1.9, 7.0, 7.0]), 20))).numpy()
    occ = 1.0 - np.exp(-np.maximum(sigma, 0) * (cfg.far - cfg.near) / cfg.N_importance)
    return cfg.replace(mesh_level=float(np.quantile(occ, 0.99)))


def case_modes(mesh, sc, out_dir):
    """run_test's render and mesh modes in the world (rank 0 writes)."""
    from dmnerf_tpu_torch.test import run_test

    cfg = modes_config(sc["full"], os.path.join(out_dir, "modes"))
    run_test(cfg.replace(render=True, render_test=True), device="cpu", scene=sc["full"])
    stats = run_test(cfg.replace(mesh=True), device="cpu", scene=sc["full"])
    return {"labels": stats["labels"]}


CASES = {"step": case_step, "render": case_render, "packed": case_packed,
         "fallback": case_fallback}


def main(out_dir: str, cases: str) -> None:
    from dmnerf_tpu_torch.parallel.mesh import init_process_group

    torch.set_num_threads(1)
    mesh = init_process_group("cpu", timeout=datetime.timedelta(seconds=60))
    sc = scenes()
    results = {"world": mesh.size, "rank": mesh.rank}
    for name in cases.split(","):
        if name in ("train", "modes"):
            results[name] = (case_train if name == "train" else case_modes)(mesh, sc, out_dir)
        else:
            results[name] = CASES[name](mesh, sc)
    torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
