"""The training step (``dmnerf_tpu/render/trainstep.py``): forward render, losses,
backward, Adam update with exponential LR decay.

  losses = MSE(rgb_coarse) + MSE(rgb_fine)
         + ins_criterion(ins_coarse) + ins_criterion(ins_fine)
         + [cfg.penalize] emptiness penalizer on both raw bundles
  optim  = Adam(betas=(0.9, 0.999), eps=1e-8) over the coarse and fine tensors
  lr     = lrate * 0.1 ** (step / (lrate_decay * 1000)), set before each update, so
           the first update uses lr_at_step(0) as optax's schedule does

With ``cfg.debug_nans`` every step checks its loss components and then every parameter
gradient for finiteness before Adam applies them, and raises ``FloatingPointError``
naming the step and the first non-finite value (the JAX package turns on
``jax_debug_nans``, which raises at the first NaN, ``dmnerf_tpu/train.py:146-147``).

ScanNet's labeled-suffix variant: with ``N_ins`` the instance loss sees only the last
N_ins rays of the batch, and ``Batch.target_valid`` masks the padded ones.

The step runs eagerly: the point queries are the fused kernels' autograd function
on the card (kernels.fused_mlp) and the two assignments of a step one launch of K11
(objfield.hungarian), so a step on the card reads nothing back to the host and can be
captured in a CUDA graph (``render.packing``). For that, the Adam of parameters on the
card is ``capturable`` with its learning rate a device tensor, which each step writes
(``lr`` may be a device value, as a graph's step reads it); on the CPU it is the plain
Adam with a float learning rate. ``finite`` takes debug_nans' checks as device flags
instead of a host read, for a step inside a graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.pipeline import QueryFn, make_query_fn, render_rays
from dmnerf_tpu_torch.core.sampling import z_val_sample
from dmnerf_tpu_torch.objfield.losses import img2mse, ins_criterion, mse2psnr
from dmnerf_tpu_torch.objfield.penalizer import ins_penalizer


class Batch(NamedTuple):
    rays_o: torch.Tensor    # [N, 3]
    rays_d: torch.Tensor    # [N, 3]
    target_c: torch.Tensor  # [N, 3]
    target_i: torch.Tensor  # [N] int (ScanNet: only the last N_ins entries are valid)
    target_valid: Optional[torch.Tensor] = None  # [N] bool; None = all rays supervised


@dataclasses.dataclass
class TrainState:
    """Parameters are leaf tensors that require a gradient; ``opt`` updates them in
    place. ``step`` counts the updates made."""
    step: int
    params_coarse: Dict[str, torch.Tensor]
    params_fine: Dict[str, torch.Tensor]
    opt: torch.optim.Adam


def lr_at_step(cfg: Config, step) -> float:
    """Exponential decay (the reference's train_dmsr.py:68-73)."""
    return cfg.lrate * 0.1 ** (step / (cfg.lrate_decay * 1000.0))


def make_adam(params_coarse, params_fine, lr: float) -> torch.optim.Adam:
    """The run's Adam: one group of the coarse tensors then the fine ones, in each
    dict's order. On the card it is capturable, its learning rate an fp32 device tensor."""
    params = [*params_coarse.values(), *params_fine.values()]
    if params[0].device.type != "cuda":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    lr_t = torch.full((), lr, dtype=torch.float32, device=params[0].device)
    return torch.optim.Adam(params, lr=lr_t, betas=(0.9, 0.999), eps=1e-8, capturable=True)


def load_adam_state(opt: torch.optim.Adam, opt_state: Dict) -> None:
    """Load a saved Adam state into ``opt`` and keep ``opt``'s form: a checkpoint written
    on either device restores onto either (a capturable Adam keeps its device learning
    rate tensor, which every step writes, and its step counts on the card)."""
    forms = [(g["lr"], g["capturable"]) for g in opt.param_groups]
    opt.load_state_dict(opt_state)
    for group, (lr, capturable) in zip(opt.param_groups, forms):
        group["lr"], group["capturable"] = lr, capturable
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = (st["step"].to(device=p.device, dtype=torch.float32) if capturable
                              else st["step"].cpu())


def set_lr(opt: torch.optim.Adam, lr) -> None:
    """Write the learning rate of every group: a float, or a device value copied into a
    capturable Adam's tensor."""
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            if isinstance(lr, torch.Tensor):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        else:
            group["lr"] = float(lr)


def create_train_state(cfg: Config, params_coarse, params_fine, step: int = 0) -> TrainState:
    """A state over the given parameters (detached copies that require a gradient),
    with a fresh Adam."""
    pc = {k: v.detach().clone().requires_grad_(True) for k, v in params_coarse.items()}
    pf = {k: v.detach().clone().requires_grad_(True) for k, v in params_fine.items()}
    return TrainState(step, pc, pf, make_adam(pc, pf, lr_at_step(cfg, step)))


def compute_losses(cfg: Config, info: Dict[str, torch.Tensor], batch: Batch,
                   N_ins: Optional[int]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    rgb_loss_coarse = img2mse(info["rgb_coarse"], batch.target_c)
    rgb_loss_fine = img2mse(info["rgb_fine"], batch.target_c)

    if N_ins is not None:
        ins_coarse, ins_fine = info["ins_coarse"][-N_ins:], info["ins_fine"][-N_ins:]
        target_i = batch.target_i[-N_ins:]
        ray_mask = None if batch.target_valid is None else batch.target_valid[-N_ins:]
    else:
        ins_coarse, ins_fine, target_i = info["ins_coarse"], info["ins_fine"], batch.target_i
        ray_mask = batch.target_valid

    # coarse and fine together: one launch of K11 for both assignments
    ins_losses, vces, ices, vsious = ins_criterion(
        torch.stack([ins_coarse, ins_fine]), target_i, cfg.ins_num, ray_mask)

    total = rgb_loss_coarse + rgb_loss_fine + ins_losses[0] + ins_losses[1]
    emptiness = torch.zeros((), dtype=total.dtype, device=total.device)
    if cfg.penalize:
        emptiness = ins_penalizer(info["raw_coarse"], info["z_vals_coarse"], info["depth_coarse"],
                                  batch.rays_d, cfg.tolerance, cfg.deta_w) \
            + ins_penalizer(info["raw_fine"], info["z_vals_fine"], info["depth_fine"],
                            batch.rays_d, cfg.tolerance, cfg.deta_w)
        total = total + emptiness

    aux = {
        "psnr_coarse": mse2psnr(rgb_loss_coarse),
        "psnr_fine": mse2psnr(rgb_loss_fine),
        "rgb_loss": rgb_loss_coarse + rgb_loss_fine,
        "ins_loss": ins_losses[0] + ins_losses[1],
        "valid_ce_fine": vces[1],
        "invalid_ce_fine": ices[1],
        "valid_siou_fine": vsious[1],
        "emptiness_loss": emptiness,
        "total_loss": total,
    }
    return total, {k: v.detach() for k, v in aux.items()}


# the loss components a debug_nans step checks, in the order they are named
LOSS_KEYS = ("rgb_loss", "ins_loss", "emptiness_loss", "total_loss")


def _grads(state: TrainState):
    return [(f"{which} {k}", p.grad) for which, params in (("coarse", state.params_coarse),
                                                           ("fine", state.params_fine))
            for k, p in params.items() if p.grad is not None]


def check_names(state: TrainState):
    """The names of debug_nans' checks in order: the loss components, then each parameter
    gradient that exists (coarse, then fine)."""
    return [f"loss {k}" for k in LOSS_KEYS] + [f"gradient of {n}" for n, _ in _grads(state)]


def finite_flags(state: TrainState, aux: Dict[str, torch.Tensor]) -> torch.Tensor:
    """debug_nans' checks (``check_names``) as a bool device tensor, True where finite."""
    return torch.stack([torch.isfinite(aux[k]).all() for k in LOSS_KEYS]
                       + [torch.isfinite(g).all() for _, g in _grads(state)])


def raise_non_finite(step: int, names, ok) -> None:
    """Raise FloatingPointError naming ``step`` and the first check of ``ok`` (host bools,
    one per name) that failed; nothing when all passed."""
    if not bool(ok.all()):
        bad = names[int((~ok).nonzero()[0])]
        raise FloatingPointError(f"debug_nans: step {step}: non-finite {bad}")


def check_finite(state: TrainState, aux: Dict[str, torch.Tensor]) -> None:
    """Raise FloatingPointError at the first non-finite loss component of ``aux`` or,
    after those, the first parameter gradient with a non-finite entry (coarse, then
    fine). One host read for all of them."""
    raise_non_finite(state.step, check_names(state), finite_flags(state, aux).cpu())


def make_train_step(cfg: Config, query_fn: Optional[QueryFn] = None,
                    N_ins: Optional[int] = None):
    """Returns ``step_fn(state, batch, generator=None, u_z=None, u_pdf=None, lr=None,
    finite=None) -> aux``, which renders, backpropagates and updates ``state`` in place.
    With ``cfg.perturb`` the draws come from ``generator`` or the injected uniforms
    (``u_z`` [N, N_samples] for the jitter, ``u_pdf`` [N, N_importance] for sample_pdf),
    as in render_rays. ``lr`` replaces lr_at_step(state.step) (a float or a device
    value). With ``cfg.debug_nans`` the step raises before the update at a non-finite
    loss or gradient, or, given ``finite`` (a bool device tensor, one per check of
    ``finite_flags``), writes the checks there and goes on."""
    if query_fn is None:
        query_fn = make_query_fn(cfg)

    def loss_fn(state: TrainState, batch: Batch, generator, u_z, u_pdf):
        z = z_val_sample(batch.rays_o.shape[0], cfg.near, cfg.far, cfg.N_samples,
                         device=batch.rays_o.device)
        info = render_rays(state.params_coarse, state.params_fine, batch.rays_o, batch.rays_d,
                           z, query_fn, N_importance=cfg.N_importance,
                           perturb=cfg.perturb > 0.0, generator=generator, u_z=u_z, u_pdf=u_pdf)
        return compute_losses(cfg, info, batch, N_ins)

    def step_fn(state: TrainState, batch: Batch, generator: Optional[torch.Generator] = None,
                u_z: Optional[torch.Tensor] = None, u_pdf: Optional[torch.Tensor] = None,
                lr=None, finite: Optional[torch.Tensor] = None):
        total, aux = loss_fn(state, batch, generator, u_z, u_pdf)
        state.opt.zero_grad(set_to_none=True)
        total.backward()
        if cfg.debug_nans and finite is None:
            check_finite(state, aux)
        elif cfg.debug_nans:
            finite.copy_(finite_flags(state, aux))
        set_lr(state.opt, lr_at_step(cfg, state.step) if lr is None else lr)
        state.opt.step()
        state.step += 1
        return aux

    return step_fn
