"""Full-image rendering by ray chunks (``dmnerf_tpu/render/renderer.py``).

The rays are cut into chunks of ``cfg.N_test``, the last one padded, so every chunk has
the same shape and the query runs at one size; padding rays get d = 1, not 0/0 viewdirs.
Parameters are prepared (packed, for the kernel) once per render, not once per chunk.

On the card every chunk is a replay of one CUDA graph (``_ChunkGraph``). A renderer's first
render warms the chunk up on a side stream and captures it (``utils.device.capture_graph``,
as ``render.packing.StepRunner`` captures a pack); later renders take rays of the same
device and dtype and parameters of the same shapes, and raise on others. The graph reads
static buffers: one chunk's rays [N_test, 6] (origins, then directions), the coarse z and
the prepared parameters. The kernels' tensor maps hold the weights' addresses, taken at
capture, so every render first copies the parameters it is given into those buffers
(``copy_``); new weights show on the very next render. The graph writes the chunk's maps
side by side into a static [N_test, 4 + C] (rgb, depth, ins). A render copies each
chunk's rays in, replays, and copies the maps out into the view's buffer: one
``cudaGraphLaunch`` and two copies a chunk, and no copy to the host. A failed capture or
replay raises; there is no eager path on the card. On the CPU the chunks run eagerly,
one by one (``render_fn.eager``). Both give the same maps, bit for bit: the same kernels
run in the same order on the same inputs.

Under a profiler each chunk records the span ``render.chunk`` (``utils.spans``). A fused
query's ``query`` span opens while its host side runs, which on the card is at capture.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.compositor import composite, composite_maps
from dmnerf_tpu_torch.core.mlp import sigma_stub_params
from dmnerf_tpu_torch.core.pipeline import QueryFn, make_query_fn, render_rays
from dmnerf_tpu_torch.core.sampling import sample_pdf, z_val_sample
from dmnerf_tpu_torch.utils.device import capture_graph, copy_params, static_params
from dmnerf_tpu_torch.utils.spans import span


def make_image_renderer(cfg: Config, query_fn: Optional[QueryFn] = None,
                        sigma_only_coarse: bool = True):
    """Returns render_fn(params_coarse, params_fine, rays_o [N,3], rays_d [N,3])
    -> dict(rgb [N,3], ins [N,ins_num], depth [N]) on the rays' device; on the card
    each chunk is a CUDA graph replay. ``render_fn.eager`` is the same render with the
    chunks run one by one, the CPU's path.

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
        return composite_maps(raw_f, z_fine, d, keep_air=False)

    def render_chunk(pc, pf, o, d, z_coarse):
        """One chunk's (rgb, ins, depth)."""
        d = torch.where(torch.sum(d * d, -1, keepdim=True) > 0, d, torch.ones_like(d))
        if sigma_only_coarse:
            return _slim_chunk(pc, pf, o, d, z_coarse)
        info = render_rays(pc, pf, o, d, z_coarse, query_fn.query,
                           N_importance=cfg.N_importance, perturb=False)
        return info["rgb_fine"], info["ins_fine"], info["depth_fine"]

    def prepare(params_coarse, params_fine):
        if sigma_only_coarse:
            params_coarse = sigma_stub_params(params_coarse)
        return query_fn.prepare(params_coarse), query_fn.prepare(params_fine)

    def coarse_z(rays_o):
        return z_val_sample(chunk, cfg.near, cfg.far, cfg.N_samples, dtype=rays_o.dtype,
                            device=rays_o.device)

    @torch.no_grad()
    def render_eager(params_coarse, params_fine, rays_o, rays_d) -> Dict[str, torch.Tensor]:
        n = rays_o.shape[0]
        pad = (-n) % chunk
        ro = torch.nn.functional.pad(rays_o, (0, 0, 0, pad))
        rd = torch.nn.functional.pad(rays_d, (0, 0, 0, pad))
        z_coarse = coarse_z(rays_o)
        pc, pf = prepare(params_coarse, params_fine)
        outs = []
        for c0 in range(0, n + pad, chunk):
            with span("render.chunk", min(chunk, n - c0)):
                outs.append(render_chunk(pc, pf, ro[c0:c0 + chunk], rd[c0:c0 + chunk], z_coarse))
        return {k: torch.cat(maps)[:n] for k, maps in zip(("rgb", "ins", "depth"), zip(*outs))}

    graph: Optional[_ChunkGraph] = None

    @torch.no_grad()
    def render_fn(params_coarse, params_fine, rays_o, rays_d) -> Dict[str, torch.Tensor]:
        nonlocal graph
        if rays_o.device.type != "cuda":
            return render_eager(params_coarse, params_fine, rays_o, rays_d)
        with torch.cuda.device(rays_o.device):
            pc, pf = prepare(params_coarse, params_fine)
            if graph is None:
                graph = _ChunkGraph(render_chunk, pc, pf, coarse_z(rays_o))
            return graph(pc, pf, rays_o, rays_d)

    render_fn.eager = render_eager
    return render_fn


class _ChunkGraph:
    """One chunk of a render captured as one CUDA graph on the current device, over
    static rays, coarse z and prepared parameters (the module docstring);
    ``graph(pc, pf, rays_o, rays_d)`` renders all the rays by its replays. It serves rays
    of the device and dtype it was captured for, and parameters of the same shapes: others
    raise."""

    def __init__(self, render_chunk, pc, pf, z_coarse: torch.Tensor):
        # every tensor the graph reads is held here: a freed one's memory would be reused
        self.pc, self.pf, self.z = static_params(pc), static_params(pf), z_coarse
        self.rays = torch.zeros((z_coarse.shape[0], 6), dtype=z_coarse.dtype,
                                device=z_coarse.device)
        o, d = self.rays[:, :3], self.rays[:, 3:]

        def chunk_maps():
            rgb, ins, depth = render_chunk(self.pc, self.pf, o, d, self.z)
            return torch.cat([rgb, depth[:, None], ins], -1), rgb.shape[-1]

        self.graph, (self.maps, self.n_rgb) = capture_graph(torch.cuda.Stream(), chunk_maps,
                                                            chunk_maps)

    def __call__(self, pc, pf, rays_o: torch.Tensor, rays_d: torch.Tensor) -> Dict[str, torch.Tensor]:
        if (rays_o.device, rays_o.dtype) != (self.rays.device, self.rays.dtype):
            raise ValueError(f"the renderer's chunk graph takes {self.rays.dtype} rays on "
                             f"{self.rays.device}, not {rays_o.dtype} on {rays_o.device}: "
                             f"make a renderer for each")
        copy_params(self.pc, pc)
        copy_params(self.pf, pf)
        n, chunk = rays_o.shape[0], self.rays.shape[0]
        rays = torch.cat([rays_o, rays_d], -1)
        out = torch.empty((n + (-n) % chunk, self.maps.shape[-1]), dtype=self.maps.dtype,
                          device=self.maps.device)
        for c0 in range(0, n, chunk):
            m = min(chunk, n - c0)
            with span("render.chunk", m):
                self.rays[:m].copy_(rays[c0:c0 + m])
                if m < chunk:
                    self.rays[m:].zero_()
                self.graph.replay()
                out[c0:c0 + chunk].copy_(self.maps)
        r = self.n_rgb
        return {"rgb": out[:n, :r].contiguous(), "ins": out[:n, r + 1:].contiguous(),
                "depth": out[:n, r].contiguous()}
