"""Full-image rendering by ray chunks (``dmnerf_tpu/render/renderer.py``).

A Python loop over chunks of ``cfg.N_test`` rays under ``torch.no_grad()``; the rays
are padded to a whole number of chunks, so every chunk has the same shape and the
query runs at one size. Parameters are prepared (packed, for the kernel) once per
render, not once per chunk. Under a profiler each chunk records the span
``render.chunk`` (``utils.spans``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.compositor import composite, composite_maps
from dmnerf_tpu_torch.core.mlp import sigma_stub_params
from dmnerf_tpu_torch.core.pipeline import QueryFn, make_query_fn, render_rays
from dmnerf_tpu_torch.core.sampling import sample_pdf, z_val_sample
from dmnerf_tpu_torch.utils.spans import span


def make_image_renderer(cfg: Config, query_fn: Optional[QueryFn] = None,
                        sigma_only_coarse: bool = True):
    """Returns render_fn(params_coarse, params_fine, rays_o [N,3], rays_d [N,3])
    -> dict(rgb [N,3], ins [N,ins_num], depth [N]) on the rays' device.

    sigma_only_coarse (default): the coarse pass only feeds ``sample_pdf``, whose
    weights depend on sigma alone, so it queries ``sigma_stub_params`` (trunk and
    density intact, heads stubbed) and skips the head work. Output-identical to the
    full pipeline."""
    if query_fn is None:
        query_fn = make_query_fn(cfg)
    chunk = cfg.N_test

    def _slim_chunk(pc_stub, pf, o, d, z_coarse):
        """render_rays' deterministic z path with the sigma-stub coarse query; only
        the fine maps are computed, by one reduction (composite_maps)."""
        viewdirs = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        pts = o[..., None, :] + d[..., None, :] * z_coarse[..., :, None]
        raw_c = query_fn.query(pc_stub, pts, viewdirs)     # only sigma is valid
        w = composite(raw_c, z_coarse, d).weights
        z_mids = 0.5 * (z_coarse[..., 1:] + z_coarse[..., :-1])
        z_samples = sample_pdf(z_mids, w[..., 1:-1], cfg.N_importance)
        z_fine = torch.sort(torch.cat([z_coarse, z_samples], dim=-1), dim=-1).values
        pts_fine = o[..., None, :] + d[..., None, :] * z_fine[..., :, None]
        raw_f = query_fn.query(pf, pts_fine, viewdirs)
        rgb, ins, depth = composite_maps(raw_f, z_fine, d, keep_air=False)
        return {"rgb": rgb, "ins": ins, "depth": depth}

    @torch.no_grad()
    def render_fn(params_coarse, params_fine, rays_o, rays_d) -> Dict[str, torch.Tensor]:
        n = rays_o.shape[0]
        pad = (-n) % chunk
        ro = torch.nn.functional.pad(rays_o, (0, 0, 0, pad))
        rd = torch.nn.functional.pad(rays_d, (0, 0, 0, pad))
        z_coarse = z_val_sample(chunk, cfg.near, cfg.far, cfg.N_samples,
                                dtype=rays_o.dtype, device=rays_o.device)
        if sigma_only_coarse:
            pc = query_fn.prepare(sigma_stub_params(params_coarse))
        else:
            pc = query_fn.prepare(params_coarse)
        pf = query_fn.prepare(params_fine)
        outs = []
        for c0 in range(0, n + pad, chunk):
            with span("render.chunk", min(chunk, n - c0)):
                o, d = ro[c0:c0 + chunk], rd[c0:c0 + chunk]
                # padding rays get d = 1, not 0/0 viewdirs
                d = torch.where(torch.sum(d * d, -1, keepdim=True) > 0, d, torch.ones_like(d))
                if sigma_only_coarse:
                    outs.append(_slim_chunk(pc, pf, o, d, z_coarse))
                else:
                    info = render_rays(pc, pf, o, d, z_coarse, query_fn.query,
                                       N_importance=cfg.N_importance, perturb=False)
                    outs.append({"rgb": info["rgb_fine"], "ins": info["ins_fine"],
                                 "depth": info["depth_fine"]})
        return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}

    return render_fn
