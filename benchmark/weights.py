"""Seeded DM-NeRF weights, made on the device by the benchmark and handed to the program
and to the reference alike.

The layout is the port's parameter dict (``[in, out]`` matrices under the JAX package's
keys), drawn from one ``torch.rand`` a model on the generator's device: weights
U(-g/sqrt(fan_in), g/sqrt(fan_in)) and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), with
g = sqrt(6) (He's uniform bound for ReLU layers), but for the density layer, whose
weights take g = 0.1 and whose bias is drawn from U(DENSITY_BIAS).

Why not ``torch.nn.Linear``'s default (g = 1, the port's own seeded init): through eight
ReLU layers it shrinks the trunk's features by about 6x a layer, so every head reads
almost nothing but its bias. The field is then the same at every point, every sample's
instance label is one channel, and a manipulated view's exchange never fires. Sigma is
kept positive (0.46 to 1.04) because its ``relu``'s kink times the last sample's 1e10
distance switches a ray's last weight between 0 and its transmittance under any rounding
where sigma is near 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from benchmark.yardstick import embed_dim


def layer_shapes(conf: dict) -> List[Tuple[str, int, int]]:
    """(name, fan_in, fan_out) of each layer, in the port's key order."""
    D, W, skips = conf["netdepth"], conf["netwidth"], tuple(conf["skips"])
    cp, cv = embed_dim(conf["multires"]), embed_dim(conf["multires_views"])
    out, in_dim = [], cp
    for i in range(D):
        out.append((f"trunk_{i}", in_dim, W))
        in_dim = W + cp if i in skips else W
    out += [("rgb_feat", W, W), ("rgb_hid", W + cv, W // 2), ("rgb_out", W // 2, 3),
            ("ins_feat", W, W), ("ins_hid", W, W // 2), ("ins_out", W // 2, conf["ins_num"] + 1),
            ("density", W, 1)]
    return out


DENSITY_BIAS = (0.5, 1.0)
GAIN = 6.0 ** 0.5
DENSITY_GAIN = 0.1


def make_params(conf: dict, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """One model's parameters from ``gen``, fp32 on the generator's device."""
    shapes = layer_shapes(conf)
    total = sum(i * o + o for _, i, o in shapes)
    u = torch.rand(total, generator=gen, device=gen.device) * 2.0 - 1.0
    params, at = {}, 0
    for name, i, o in shapes:
        bound = i ** -0.5
        gain = DENSITY_GAIN if name == "density" else GAIN
        params[f"{name}_w"] = (u[at:at + i * o].view(i, o) * (gain * bound)).contiguous()
        at += i * o
        params[f"{name}_b"] = (u[at:at + o] * bound).contiguous()
        if name == "density":
            lo, hi = DENSITY_BIAS
            params[f"{name}_b"] = lo + (hi - lo) * 0.5 * (u[at:at + o] + 1.0)
        at += o
    return params


def make_models(conf: dict, seed: int, device, lift: Optional[Tuple[int, float]] = None
                ) -> Tuple[Dict, Dict]:
    """(coarse, fine) for ``seed``: one device generator draws the coarse model, then the
    fine one. ``lift`` = (label, amount) raises that label's instance logit by ``amount``
    in both, so that the label is carried by a large share of the points (the moved object
    of a manipulated view)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    models = make_params(conf, gen), make_params(conf, gen)
    if lift is not None:
        for p in models:
            p["ins_out_b"][lift[0]] += lift[1]
    return models
