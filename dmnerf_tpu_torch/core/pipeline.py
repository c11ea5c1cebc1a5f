"""Coarse-to-fine rendering pipeline (``dmnerf_tpu/core/pipeline.py``).

  normalize viewdirs -> (optional) stratified jitter -> coarse points -> PE + MLP ->
  composite -> inverse-CDF importance sampling on detached coarse weights ->
  fine z = sort(coarse ∪ fine) -> PE + MLP -> composite.

The point query is pluggable: ``make_torch_query_fn`` is the plain PyTorch path
(the analogue of the JAX package's ``make_xla_query_fn``), and ``make_query_fn``
picks the fused Hopper kernels from the config, the pair named by
``cfg.pallas_pe_mode`` (``kernels.fused_mlp.resolve_pe_mode``). A ``QueryFn`` takes
prepared parameters; ``prepare`` runs once per render (for the kernel: the packing).
Under a profiler each fused point query records the span ``query`` (``utils.spans``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from dmnerf_tpu_torch.core.compositor import Composited, composite, composite_geometry
from dmnerf_tpu_torch.core.embedding import positional_encoding
from dmnerf_tpu_torch.core.mlp import dm_nerf_apply
from dmnerf_tpu_torch.core.sampling import perturb_z_vals, sample_pdf
from dmnerf_tpu_torch.utils.spans import span


def _identity(params):
    return params


@dataclasses.dataclass(frozen=True)
class QueryFn:
    """``query(prepared, pts [N,S,3], viewdirs [N,3]) -> raw [N,S,4+ins+1]``;
    ``prepare(params)`` turns a parameter dict into what ``query`` takes, once per
    render. Calling the QueryFn itself prepares and queries."""
    query: Callable
    prepare: Callable = _identity

    def __call__(self, params, pts, viewdirs):
        return self.query(self.prepare(params), pts, viewdirs)


def make_torch_query_fn(multires: int = 10, multires_views: int = 4, D: int = 8,
                        skips=(4,)) -> QueryFn:
    """Plain PyTorch point query: PE + MLP."""

    def query(params, pts, viewdirs):
        emb_pts = positional_encoding(pts, multires)                  # [N, S, Cp]
        emb_dirs = positional_encoding(viewdirs, multires_views)      # [N, Cv]
        emb_dirs = torch.broadcast_to(emb_dirs[:, None, :], pts.shape[:-1] + emb_dirs.shape[-1:])
        return dm_nerf_apply(params, emb_pts, emb_dirs, D=D, skips=skips)

    return QueryFn(query)


def make_fused_query_fn(multires: int = 10, multires_views: int = 4, D: int = 8,
                        skips=(4,), pe_mode: Optional[str] = None) -> QueryFn:
    """The fused PE + MLP query (kernels.fused_mlp): the Hopper kernels of
    ``pe_mode`` (forward and parameter backward) for CUDA tensors, their fp32 plain
    versions for CPU tensors."""
    from dmnerf_tpu_torch.kernels.fused_mlp import fused_query, pack_params, resolve_pe_mode

    mode = resolve_pe_mode(pe_mode)

    def prepare(params):
        return pack_params(params, multires, multires_views, D, tuple(skips))

    def query(packed, pts, viewdirs):
        with span("query", pts.numel() // 3):
            return fused_query(packed, pts, viewdirs, mode)

    return QueryFn(query, prepare)


def make_query_fn(cfg) -> QueryFn:
    """Config-driven choice: the fused kernel path of ``cfg.pallas_pe_mode`` when
    ``cfg.use_pallas`` and the positional encoding is on, the plain PyTorch path
    otherwise (the identity embedding, i_embed = -1). The fused path itself routes by
    the device of the tensors it is given."""
    if cfg.use_pallas and cfg.i_embed == 0 and cfg.multires > 0 and cfg.multires_views > 0:
        return make_fused_query_fn(cfg.multires, cfg.multires_views, cfg.netdepth,
                                   tuple(cfg.skips), cfg.pallas_pe_mode)
    mr = cfg.multires if cfg.i_embed == 0 else -1
    mrv = cfg.multires_views if cfg.i_embed == 0 else -1
    return make_torch_query_fn(mr, mrv, cfg.netdepth, tuple(cfg.skips))


def _composite(raw, z_vals, rays_d, instance_fn):
    """composite(), or with ``instance_fn`` its geometry and ``instance_fn``'s instance
    map: (Composited, the penalizer's sums or None)."""
    if instance_fn is None:
        return composite(raw, z_vals, rays_d), None
    weights, rgb, depth = composite_geometry(raw, z_vals, rays_d)
    logits, sums = instance_fn(raw, weights, z_vals, depth, rays_d)
    return Composited(rgb, weights, depth, torch.sigmoid(logits)[..., :-1]), sums


def render_rays(
    params_coarse,
    params_fine,
    rays_o: torch.Tensor,         # [N, 3]
    rays_d: torch.Tensor,         # [N, 3]
    z_vals_coarse: torch.Tensor,  # [N, N_samples]
    query_fn: Callable,           # query_fn(params, pts [N,S,3], viewdirs [N,3]) -> raw
    N_importance: int = 128,
    perturb: bool = True,
    generator: Optional[torch.Generator] = None,
    u_z: Optional[torch.Tensor] = None,
    u_pdf: Optional[torch.Tensor] = None,
    instance_fn: Optional[Callable] = None,
) -> Dict[str, torch.Tensor]:
    """The coarse + fine render; gradients flow to both parameter dicts through the
    queries, except across the walls: the instance head's detached trunk feature,
    the detached instance-composite weights and the detached fine z. The draws are
    random when ``perturb`` and a generator or injected uniforms (``u_z`` for the
    jitter, ``u_pdf`` for sample_pdf) are given; otherwise the pass is
    deterministic, as the reference's perturb == 0.

    ``instance_fn(raw, weights, z_vals, depth, rays_d) -> (ins_logits, sums or None)``
    (a training step's ``kernels.instance_terms`` with its penalizer settings) takes each
    bundle's instance map in place of composite's, and its penalizer sums of each ray
    [N, 4], when it gives them, go to ``penalizer_coarse`` / ``penalizer_fine``."""
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    randomized = perturb and (generator is not None or u_z is not None)
    if randomized:
        z_vals_coarse = perturb_z_vals(z_vals_coarse, u=u_z, generator=generator)

    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals_coarse[..., :, None]
    raw_coarse = query_fn(params_coarse, pts, viewdirs)
    out_c, pen_c = _composite(raw_coarse, z_vals_coarse, rays_d, instance_fn)

    z_mids = 0.5 * (z_vals_coarse[..., 1:] + z_vals_coarse[..., :-1])
    z_samples = sample_pdf(z_mids, out_c.weights[..., 1:-1].detach(), N_importance,
                           u=u_pdf if randomized else None,
                           generator=generator if randomized else None).detach()

    z_vals_fine = torch.sort(torch.cat([z_vals_coarse, z_samples], dim=-1), dim=-1).values
    pts_fine = rays_o[..., None, :] + rays_d[..., None, :] * z_vals_fine[..., :, None]
    raw_fine = query_fn(params_fine, pts_fine, viewdirs)
    out_f, pen_f = _composite(raw_fine, z_vals_fine, rays_d, instance_fn)

    info = {
        "rgb_fine": out_f.rgb,
        "ins_fine": out_f.ins,
        "z_vals_fine": z_vals_fine,
        "raw_fine": raw_fine,
        "raw_coarse": raw_coarse,
        "rgb_coarse": out_c.rgb,
        "ins_coarse": out_c.ins,
        "z_vals_coarse": z_vals_coarse,
        "depth_fine": out_f.depth,
        "depth_coarse": out_c.depth,
    }
    if pen_c is not None:
        info.update(penalizer_coarse=pen_c, penalizer_fine=pen_f)
    return info
