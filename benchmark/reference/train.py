"""The reference's training: the batches a run's seeds give, and the steps over them.

``full_batches`` and ``crop_batches`` draw each step's rays from the run's batch generator
on the host, in the order DM-NeRF's samplers draw them (a train view, then its pixels:
the full-image sampler's N_train distinct pixels; the crop sampler's N_ins labelled slots
by the top scores of uniforms over the view's labelled ids, then N_train - N_ins distinct
crop pixels), then each step's jitter and importance uniforms from the run's step
generator on the device. ``train`` runs Adam (0.9, 0.999, 1e-8) over the coarse then the
fine tensors, the learning rate decayed exponentially and set before each update.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from benchmark.reference.losses import step_loss

Tensors = Dict[str, torch.Tensor]
from benchmark.reference.nerf import render_batch


def rays_for_pixels(pix: torch.Tensor, W: int, K: torch.Tensor, c2w: torch.Tensor):
    x, y = (pix % W).to(torch.float32), (pix // W).to(torch.float32)
    dirs = torch.stack([(x - K[0, 2]) / K[0, 0], (y - K[1, 2]) / K[1, 1],
                        K[2, 2] * torch.ones_like(x)], -1)
    d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand_as(d), d


def _uniforms(conf: dict, gen_step: torch.Generator):
    n = conf["N_train"]
    u_z = torch.rand((n, conf["N_samples"]), generator=gen_step, device=gen_step.device)
    u_pdf = torch.rand((n, conf["N_importance"]), generator=gen_step, device=gen_step.device)
    return u_z, u_pdf


def full_batches(scene, conf: dict, steps: int, gen_batch: torch.Generator,
                 gen_step: torch.Generator) -> List[dict]:
    H, W, n = scene.H, scene.W, conf["N_train"]
    out = []
    for _ in range(steps):
        img = int(scene.i_train[int(torch.randint(len(scene.i_train), (), generator=gen_batch))])
        pix = torch.randperm(H * W, generator=gen_batch)[:n].to(scene.images.device)
        o, d = rays_for_pixels(pix, W, scene.K, scene.poses[img])
        u_z, u_pdf = _uniforms(conf, gen_step)
        out.append(dict(o=o, d=d, rgb=scene.images[img].reshape(-1, 3)[pix],
                        label=scene.labels[img].reshape(-1)[pix], valid=None, n_ins=None,
                        u_z=u_z, u_pdf=u_pdf))
    return out


def crop_batches(scene, conf: dict, steps: int, gen_batch: torch.Generator,
                 gen_step: torch.Generator) -> List[dict]:
    n = conf["N_train"]
    n_ins = int(n * 0.3)
    dev = scene.images.device
    L = max(max(len(ix) for ix in scene.ins_indices), n_ins)
    crop = torch.nonzero(torch.as_tensor(scene.crop_mask.reshape(-1) == 1))[:, 0]
    out = []
    for _ in range(steps):
        t = int(torch.randint(len(scene.i_train), (), generator=gen_batch))
        ids = torch.as_tensor(scene.ins_indices[t], dtype=torch.long)
        valid_slot = torch.arange(L) < len(ids)
        scores = torch.rand(L, generator=gen_batch) + torch.where(valid_slot, 0.0, -1e9)
        slots = torch.topk(scores, n_ins).indices
        rgb_ids = crop[torch.randperm(len(crop), generator=gen_batch)[:n - n_ins]]
        lab_ids = torch.cat([ids, torch.zeros(L - len(ids), dtype=torch.long)])[slots]
        pix = torch.cat([rgb_ids, lab_ids]).to(dev)
        img = int(scene.i_train[t])
        o, d = rays_for_pixels(pix, scene.W, scene.K, scene.poses[img])
        valid = torch.cat([torch.ones(n - n_ins, dtype=torch.bool), slots < len(ids)]).to(dev)
        u_z, u_pdf = _uniforms(conf, gen_step)
        out.append(dict(o=o, d=d, rgb=scene.images[img].reshape(-1, 3)[pix],
                        label=scene.labels[img].reshape(-1)[pix], valid=valid, n_ins=n_ins,
                        u_z=u_z, u_pdf=u_pdf))
    return out


def lr_at(conf: dict, step: int) -> float:
    return conf["lrate"] * 0.1 ** (step / (conf["lrate_decay"] * 1000.0))


@dataclasses.dataclass
class Trained:
    losses: List[float]                         # each step's total loss
    states: Dict[int, Tuple[Tensors, Tensors]]  # after k steps: (Adam's first moments, tensors)


def train(pc: Tensors, pf: Tensors, batches: List[dict], conf: dict, prec: str = "fp32",
          first_grads: Optional[Tensors] = None, at: Iterable[int] = ()) -> Trained:
    """Train copies of (pc, pf) over ``batches``: each step's losses, and Adam's first
    moment of each tensor and each tensor after ``k`` steps for each ``k`` of ``at`` and
    after the last, keyed 'coarse <name>' and 'fine <name>'. ``first_grads``, when given,
    is filled with the first step's gradients."""
    leaves = {f"coarse {k}": v.detach().clone().requires_grad_(True) for k, v in pc.items()}
    leaves.update({f"fine {k}": v.detach().clone().requires_grad_(True) for k, v in pf.items()})
    opt = torch.optim.Adam(list(leaves.values()), lr=lr_at(conf, 0), betas=(0.9, 0.999), eps=1e-8)
    cp = {k[7:]: v for k, v in leaves.items() if k.startswith("coarse ")}
    fp = {k[5:]: v for k, v in leaves.items() if k.startswith("fine ")}
    at = set(at) | {len(batches)}
    done = Trained([], {})
    for step, b in enumerate(batches):
        out = render_batch(cp, fp, b["o"], b["d"], conf, b["u_z"], b["u_pdf"], prec)
        out["rays_d"] = b["d"]
        loss = step_loss(out, b["rgb"], b["label"], conf, b["n_ins"], b["valid"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if step == 0 and first_grads is not None:
            first_grads.update({k: v.grad.detach().clone() for k, v in leaves.items()})
        for g in opt.param_groups:
            g["lr"] = lr_at(conf, step)
        opt.step()
        done.losses.append(float(loss.detach()))
        if step + 1 in at:
            done.states[step + 1] = (
                {k: opt.state[v]["exp_avg"].detach().clone() for k, v in leaves.items()},
                {k: v.detach().clone() for k, v in leaves.items()})
        del out, loss
    return done
