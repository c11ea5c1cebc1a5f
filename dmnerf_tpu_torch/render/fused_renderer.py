"""Full-image rendering through the fused render passes (``kernels.fused_render``): the
counterpart of ``make_fused_renderer`` in ``scripts/dev/fused_render_probe.py:157-189``.

A chunk of rays is two launches and the glue between them: K8c, the coarse weights of
the sigma stub over the fixed coarse depths; ``sample_pdf`` of the fine depths and the
sorted union; K8f, the fine maps. The points, raw and the compositing of
``render.renderer.make_image_renderer`` stay inside the kernels. Both models are packed
and the rays' viewdir table built once per render. Nothing outside the probes calls it:
the test modes render through ``make_image_renderer``, as the JAX package's do.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.mlp import sigma_stub_params
from dmnerf_tpu_torch.core.sampling import sample_pdf, z_val_sample
from dmnerf_tpu_torch.kernels.fused_mlp import pack_params
from dmnerf_tpu_torch.kernels.fused_render import fused_render, ray_table


def make_fused_renderer(cfg: Config, chunk: Optional[int] = None):
    """Returns render_fn(params_coarse, params_fine, rays_o [N,3], rays_d [N,3]) -> dict(rgb
    [N,3], ins [N,ins_num], depth [N]) on the rays' device, as ``make_image_renderer``
    with its sigma-stub coarse pass and deterministic depths. ``chunk`` rays a pass
    (``cfg.N_test`` by default); the rays are padded to whole chunks. CUDA tensors run
    the kernels, CPU tensors their fp32 plain version."""
    chunk = chunk or cfg.N_test
    args = (cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))

    @torch.no_grad()
    def render_fn(params_coarse, params_fine, rays_o, rays_d) -> Dict[str, torch.Tensor]:
        n = rays_o.shape[0]
        pad = (-n) % chunk
        ro = torch.nn.functional.pad(rays_o, (0, 0, 0, pad))
        rd = torch.nn.functional.pad(rays_d, (0, 0, 0, pad))
        z_coarse = z_val_sample(chunk, cfg.near, cfg.far, cfg.N_samples, dtype=rays_o.dtype,
                                device=rays_o.device).contiguous()
        z_mids = 0.5 * (z_coarse[..., 1:] + z_coarse[..., :-1])
        pc = pack_params(sigma_stub_params(params_coarse), *args)
        pf = pack_params(params_fine, *args)
        d, edr = ray_table(pf, rd)   # the viewdir table depends on multires_views alone
        outs = []
        for c0 in range(0, n + pad, chunk):
            o, table = ro[c0:c0 + chunk], (d[c0:c0 + chunk], edr[c0:c0 + chunk])
            w = fused_render(pc, o, table[0], z_coarse, True, table)
            z_samples = sample_pdf(z_mids, w[..., 1:-1], cfg.N_importance)
            z_fine = torch.sort(torch.cat([z_coarse, z_samples], dim=-1), dim=-1).values
            outs.append(fused_render(pf, o, table[0], z_fine, False, table))
        maps = torch.cat(outs)[:n]
        # the maps keep the air channel; the renderer's ins drops it
        return {"rgb": maps[:, :3], "ins": maps[:, 4:-1], "depth": maps[:, 3]}

    return render_fn
