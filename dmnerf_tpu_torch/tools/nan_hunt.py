"""NaN bisection (``dmnerf_tpu/tools/nan_hunt.py``): replay training to the first
non-finite step, decompose that step by loss component and dump a repro.

The replay runs the port's own train step (the fused kernels on the card), as
``train.train`` does, without ``debug_nans``: its batches and its draws come from the
same seeded generators, so the steps are the training run's. Each step's draws are
made here and injected (``u_z``, ``u_pdf``), so the failing step can be run again.
A step is bad when its total loss or any updated parameter is not finite. Then the
state before it is re-rendered and each loss component (rgb; ins and penalizer,
coarse and fine) is differentiated on its own, naming the parameters whose gradients
are not finite.

CLI:
  python -m dmnerf_tpu_torch.tools.nan_hunt --config cfg.txt [--max-steps 500]
                                            [--repro-out FILE] [--device cpu]

The repro (default ``<log_dir>/nan_repro.pkl``) is a pickle of numpy arrays in the
JAX tool's layout, ``((params_coarse, params_fine), batch, step_draws, all_info)``:
``batch`` is a ``Batch`` of numpy arrays (fields as the JAX package's), and
``step_draws`` (the JAX tool's step key) is ``{"u_z": ..., "u_pdf": ...}``, or None
without ``perturb``.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, Optional

import torch

from dmnerf_tpu_torch.configs import Config, load_config
from dmnerf_tpu_torch.core.pipeline import make_query_fn, render_rays
from dmnerf_tpu_torch.core.sampling import z_val_sample
from dmnerf_tpu_torch.data.scene import SceneData, load_scene
from dmnerf_tpu_torch.objfield.losses import img2mse, ins_criterion
from dmnerf_tpu_torch.objfield.penalizer import ins_penalizer
from dmnerf_tpu_torch.render.trainstep import Batch, create_train_state, make_train_step
from dmnerf_tpu_torch.test import init_params
from dmnerf_tpu_torch.train import make_sampler
from dmnerf_tpu_torch.utils.device import resolve_device


def _finite(tensors) -> bool:
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())


def components(cfg: Config, batch: Batch, n_ins: Optional[int]):
    """The loss components of a step, each a function of render_rays' output."""
    sl = slice(-n_ins, None) if n_ins is not None else slice(None)
    target_i = batch.target_i[sl]
    mask = None if batch.target_valid is None else batch.target_valid[sl]

    def ins(which):
        return lambda info: ins_criterion(info[f"ins_{which}"][sl], target_i, cfg.ins_num, mask)[0]

    def pen(which):
        return lambda info: ins_penalizer(info[f"raw_{which}"], info[f"z_vals_{which}"],
                                          info[f"depth_{which}"], batch.rays_d,
                                          cfg.tolerance, cfg.deta_w)

    return {
        "rgb": lambda info: img2mse(info["rgb_coarse"], batch.target_c)
                            + img2mse(info["rgb_fine"], batch.target_c),
        "ins_coarse": ins("coarse"),
        "ins_fine": ins("fine"),
        "pen_coarse": pen("coarse"),
        "pen_fine": pen("fine"),
    }


def hunt(cfg: Config, scene: SceneData, device=None, max_steps: int = 500,
         repro_out: Optional[str] = None, params=None) -> Dict:
    """Replay up to ``max_steps`` steps from the seeded init (or ``params``, a pair of
    parameter dicts). Returns ``first_bad_step`` (None when every step was finite) and,
    for a bad step, each component's ``value`` and ``nan_grads`` and the repro path."""
    device = resolve_device(device)
    cfg = cfg.replace(ins_num=scene.ins_num, debug_nans=False)
    state = create_train_state(cfg, *(params or init_params(cfg, device)))
    sampler, n_ins = make_sampler(cfg, scene, device)
    step_fn = make_train_step(cfg, N_ins=n_ins)
    gen_batch = torch.Generator().manual_seed(cfg.seed + 1)
    gen_step = torch.Generator(device=device).manual_seed(cfg.seed + 2)
    perturb = cfg.perturb > 0.0

    for i in range(max_steps):
        batch = sampler(gen_batch)
        draws = None
        if perturb:
            draws = {"u_z": torch.rand((cfg.N_train, cfg.N_samples), generator=gen_step,
                                       device=device),
                     "u_pdf": torch.rand((cfg.N_train, cfg.N_importance), generator=gen_step,
                                         device=device)}
        before = [{k: v.detach().clone() for k, v in p.items()}
                  for p in (state.params_coarse, state.params_fine)]
        aux = step_fn(state, batch, **(draws or {}))
        if not _finite([aux["total_loss"], *state.params_coarse.values(),
                        *state.params_fine.values()]):
            print(f"first bad step: {i}, total={float(aux['total_loss'])}", flush=True)
            break
    else:
        print(f"no NaN in {max_steps} steps — nothing to bisect")
        return {"first_bad_step": None}

    print("pre-step params finite:", _finite([v for p in before for v in p.values()]), flush=True)
    query_fn = make_query_fn(cfg)
    z = z_val_sample(cfg.N_train, cfg.near, cfg.far, cfg.N_samples, device=device)

    def render(pc, pf):
        return render_rays(pc, pf, batch.rays_o, batch.rays_d, z, query_fn,
                           N_importance=cfg.N_importance, perturb=perturb,
                           **({"u_z": draws["u_z"], "u_pdf": draws["u_pdf"]} if draws else {}))

    with torch.no_grad():
        info = render(*before)
    for k, v in info.items():
        print(f"  fwd {k}: finite={bool(torch.isfinite(v).all())}", flush=True)

    result = {"first_bad_step": i, "components": {}}
    for name, fn in components(cfg, batch, n_ins).items():
        pc, pf = ({k: v.clone().requires_grad_(True) for k, v in p.items()} for p in before)
        val = fn(render(pc, pf))
        named = [(f"coarse.{k}", v) for k, v in pc.items()] + [(f"fine.{k}", v) for k, v in pf.items()]
        grads = torch.autograd.grad(val, [v for _, v in named], allow_unused=True)
        bad = [n for (n, _), g in zip(named, grads) if g is not None and not bool(torch.isfinite(g).all())]
        value = float(val.detach())
        result["components"][name] = {"value": value, "nan_grads": bad}
        print(f"{name}: value={value:.4f} nan_grads={bad[:6]}", flush=True)

    repro_out = repro_out or os.path.join(cfg.log_dir, "nan_repro.pkl")
    os.makedirs(os.path.dirname(os.path.abspath(repro_out)), exist_ok=True)
    to_np = lambda t: None if t is None else t.detach().cpu().numpy()  # noqa: E731
    repro = (tuple({k: to_np(v) for k, v in p.items()} for p in before),
             Batch(*(to_np(t) for t in batch)),
             None if draws is None else {k: to_np(v) for k, v in draws.items()},
             {k: to_np(v) for k, v in info.items()})
    with open(repro_out, "wb") as f:
        pickle.dump(repro, f)
    print(f"dumped {repro_out}", flush=True)
    result["repro"] = repro_out
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True, help="training config txt")
    ap.add_argument("--max-steps", type=int, default=500)
    ap.add_argument("--repro-out", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    hunt(cfg, load_scene(cfg), args.device, args.max_steps, args.repro_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
