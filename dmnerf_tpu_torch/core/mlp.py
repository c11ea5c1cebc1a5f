"""The DM-NeRF MLP as a flat dict of parameters (``dmnerf_tpu/core/mlp.py``).

  trunk:   D Linear(W) + ReLU layers, skip-concat of the embedded position after
           the ReLU of each layer index in ``skips``.
  density: Linear(W -> 1) on the trunk feature (ReLU is the compositor's).
  rgb:     Linear(W -> W) (no ReLU), concat embedded view dirs,
           Linear(W+Dv -> W/2) + ReLU, Linear(W/2 -> 3).
  ins:     detached trunk feature (the instance head must not shape the geometry),
           Linear(W -> W) (no ReLU), Linear(W -> W/2) + ReLU, Linear(W/2 -> ins_num+1).
  output:  [rgb(3), density(1), ins(ins_num+1)].

Weights are ``[in, out]`` matrices under the JAX package's keys, so parameters
carry across in both directions without transposes (``params_from_numpy``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from dmnerf_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]


def _linear_init(gen: torch.Generator, fan_in: int, fan_out: int, dtype):
    """torch.nn.Linear's default: U(-1/sqrt(fan_in), +1/sqrt(fan_in)) for w and b."""
    bound = 1.0 / float(np.sqrt(fan_in))
    w = (torch.rand((fan_in, fan_out), generator=gen, dtype=dtype) * 2.0 - 1.0) * bound
    b = (torch.rand((fan_out,), generator=gen, dtype=dtype) * 2.0 - 1.0) * bound
    return w, b


def init_dm_nerf(
    ins_num: int,
    D: int = 8,
    W: int = 256,
    input_ch_pts: int = 63,
    input_ch_views: int = 27,
    skips: Sequence[int] = (4,),
    dtype=torch.float32,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Params:
    """Seeded init. Draws come from a CPU generator, so one seed gives the same
    parameters on every device."""
    device = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params: Params = {}
    in_dim = input_ch_pts
    for i in range(D):
        params[f"trunk_{i}_w"], params[f"trunk_{i}_b"] = _linear_init(gen, in_dim, W, dtype)
        in_dim = W + input_ch_pts if i in skips else W
    params["rgb_feat_w"], params["rgb_feat_b"] = _linear_init(gen, W, W, dtype)
    params["rgb_hid_w"], params["rgb_hid_b"] = _linear_init(gen, W + input_ch_views, W // 2, dtype)
    params["rgb_out_w"], params["rgb_out_b"] = _linear_init(gen, W // 2, 3, dtype)
    params["ins_feat_w"], params["ins_feat_b"] = _linear_init(gen, W, W, dtype)
    params["ins_hid_w"], params["ins_hid_b"] = _linear_init(gen, W, W // 2, dtype)
    params["ins_out_w"], params["ins_out_b"] = _linear_init(gen, W // 2, ins_num + 1, dtype)
    params["density_w"], params["density_b"] = _linear_init(gen, W, 1, dtype)
    return {k: v.to(device) for k, v in params.items()}


def params_from_numpy(d: Mapping[str, np.ndarray], device=None) -> Params:
    """The JAX package's parameters, given as numpy arrays, as this package's dict:
    same keys, same ``[in, out]`` layout, no transposes."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(device) for k, v in d.items()}


def _matmul(x, w, b):
    return (x @ w).to(x.dtype) + b


def dm_nerf_apply(
    params: Params,
    pts_embedded: torch.Tensor,   # [..., input_ch_pts]
    dirs_embedded: torch.Tensor,  # [..., input_ch_views]
    D: int = 8,
    skips: Sequence[int] = (4,),
) -> torch.Tensor:
    """Returns raw [..., 3 + 1 + ins_num + 1] = [rgb, sigma, ins_logits]."""
    h = pts_embedded
    for i in range(D):
        h = torch.relu(_matmul(h, params[f"trunk_{i}_w"], params[f"trunk_{i}_b"]))
        if i in skips:
            h = torch.cat([h, pts_embedded], dim=-1)

    density = _matmul(h, params["density_w"], params["density_b"])

    rgb_feat = _matmul(h, params["rgb_feat_w"], params["rgb_feat_b"])  # no relu
    rgb_feat = torch.cat([rgb_feat, dirs_embedded], dim=-1)
    rgb_feat = torch.relu(_matmul(rgb_feat, params["rgb_hid_w"], params["rgb_hid_b"]))
    rgb = _matmul(rgb_feat, params["rgb_out_w"], params["rgb_out_b"])

    # gradient wall: instance supervision never updates the geometry
    ins_feat = _matmul(h.detach(), params["ins_feat_w"], params["ins_feat_b"])  # no relu
    ins_feat = torch.relu(_matmul(ins_feat, params["ins_hid_w"], params["ins_hid_b"]))
    ins = _matmul(ins_feat, params["ins_out_w"], params["ins_out_b"])

    return torch.cat([rgb, density, ins], dim=-1)


def num_params(params: Params) -> int:
    return sum(int(p.numel()) for p in params.values())


def _stub_branch(params: Params, stub_w: int, with_ins: bool) -> Params:
    W = params["density_w"].shape[0]
    ref = params["density_w"]
    emb_views = params["rgb_hid_w"].shape[0] - params["rgb_feat_w"].shape[1]

    def zeros(*shape):
        return torch.zeros(shape, dtype=ref.dtype, device=ref.device)

    out = dict(
        rgb_feat_w=zeros(W, stub_w), rgb_feat_b=zeros(stub_w),
        rgb_hid_w=zeros(stub_w + emb_views, stub_w), rgb_hid_b=zeros(stub_w),
        rgb_out_w=zeros(stub_w, 3), rgb_out_b=zeros(3),
    )
    if with_ins:
        out.update(
            ins_feat_w=zeros(W, stub_w), ins_feat_b=zeros(stub_w),
            ins_hid_w=zeros(stub_w, stub_w), ins_hid_b=zeros(stub_w),
            ins_out_w=zeros(stub_w, 1), ins_out_b=zeros(1),
        )
    return out


def rgb_stub_params(params: Params, stub_w: int = 8) -> Params:
    """Shrink ONLY the rgb branch to ``stub_w``-wide zero weights. Sigma and the
    instance logits stay exact (each output column of a matmul is an independent
    dot product); the rgb channels of the result must not be consumed."""
    if stub_w % 8:
        raise ValueError(f"stub_w must be a multiple of 8, got {stub_w}")
    out = dict(params)
    out.update(_stub_branch(params, stub_w, with_ins=False))
    return out


def sigma_stub_params(params: Params, stub_w: int = 8) -> Params:
    """Shrink the rgb and ins branches to ``stub_w``-wide zero weights, keeping the
    trunk and density head. For consumers that read only sigma (the renderer's
    coarse pass feeds nothing but ``sample_pdf``): sigma is exact, the other
    channels of the result must not be consumed."""
    if stub_w % 8:
        raise ValueError(f"stub_w must be a multiple of 8, got {stub_w}")
    out = {k: v for k, v in params.items()
           if k.startswith("trunk_") or k.startswith("density_")}
    out.update(_stub_branch(params, stub_w, with_ins=True))
    return out
