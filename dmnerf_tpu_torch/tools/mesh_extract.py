"""Colored instance mesh extraction (``dmnerf_tpu/tools/mesh_extract.py``,
single-device branch).

 * sampling frame: oriented bounds of the dataset's mesh.ply (PCA OBB, see
   tools.meshing.oriented_bounds_pca) or the identity; the reference's scene extents
   [1.9, 7.0, 7.0] (mesh_generator.py:27);
 * a 256^3 grid in [-1,1]^3, scaled by extents/2, rotated and translated into the
   scene, then the blender axis swap ([x,z,y], y negated; mesh_generator.py:31-32);
 * the fine model's sigma at every grid point, in chunks of 65,536 points through the
   config's point query with zero view dirs and ``sigma_stub_params`` (on the card
   K1, or K3 / K7+K5 under ``pallas_pe_mode``: 256 launches a 256^3 sweep);
 * occupancy = 1 - exp(-relu(sigma) * voxel), voxel = (far-near)/N_importance;
 * the iso-surface at ``level`` (0.45), oriented along the gradient; vertices mapped
   grid -> [0,1] -> [-1,1] -> scene frame; mesh.ply;
 * connected-component cleaning (min 400 faces);
 * per-vertex instance colour: a ray along the NEGATIVE vertex normal from just
   outside the surface (o = v - d*0.03*near) through the image renderer with z in
   [0.01, 15] (mesh_generator.py:124), argmax instance -> palette -> color_mesh.ply.

The sweep and the vertex render run on the parameters' device; everything else is
host NumPy, as in the JAX package. Each host stage's seconds and the process's peak
resident memory are printed and returned.
"""

from __future__ import annotations

import os
import resource
import time
from typing import Dict, Optional

import numpy as np
import torch

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.core.mlp import sigma_stub_params
from dmnerf_tpu_torch.core.pipeline import make_query_fn
from dmnerf_tpu_torch.render.renderer import make_image_renderer
from dmnerf_tpu_torch.tools.meshing import (
    clean_mesh,
    marching_tetrahedra,
    oriented_bounds_pca,
    read_ply,
    vertex_normals,
    write_ply,
)
from dmnerf_tpu_torch.tools.visualizer import render_label2world
from dmnerf_tpu_torch.utils.device import resolve_device

DEFAULT_EXTENTS = np.array([1.9, 7.0, 7.0])  # reference mesh_generator.py:27
LEVEL = 0.45
GRID_DIM = 256
MIN_CLUSTER = 400


def make_sigma_query(cfg: Config, chunk: int = 65536, samples: int = 64):
    """Batched density query: ``query(params_fine, pts [N, 3]) -> sigma [N]`` on the
    points' device. The fine parameters' sigma stub is prepared (packed, for the
    kernel) once per call; the points are padded to whole chunks, and each chunk is
    folded into the query's ``[chunk/samples, samples, 3]`` shape with zero view dirs,
    as the reference's mesh query."""
    if chunk % samples:
        raise ValueError(f"chunk {chunk} is not a multiple of samples {samples}")
    query_fn = make_query_fn(cfg)

    @torch.no_grad()
    def query(params_fine, pts: torch.Tensor) -> torch.Tensor:
        n = pts.shape[0]
        pts_p = torch.nn.functional.pad(pts, (0, 0, 0, (-n) % chunk)).contiguous()
        prepared = query_fn.prepare(sigma_stub_params(params_fine))
        viewdirs = torch.zeros((chunk // samples, 3), dtype=pts.dtype, device=pts.device)
        sigma = torch.empty(pts_p.shape[0], dtype=torch.float32, device=pts.device)
        for c0 in range(0, pts_p.shape[0], chunk):
            raw = query_fn.query(prepared, pts_p[c0:c0 + chunk].reshape(-1, samples, 3), viewdirs)
            sigma[c0:c0 + chunk] = raw[..., 3].reshape(-1)
        return sigma[:n]

    return query


def build_grid(scene_transform: np.ndarray, extents: np.ndarray, dim: int = GRID_DIM):
    """[-1,1]^3 grid scaled/rotated into the scene + the blender axis swap."""
    t = np.linspace(-1.0, 1.0, dim, dtype=np.float32)
    gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
    grid = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    grid = grid * (extents / 2.0)
    grid = grid @ scene_transform[:3, :3].T + scene_transform[:3, 3]
    grid = grid[:, [0, 2, 1]]
    grid[:, 1] *= -1
    return grid.astype(np.float32)


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20   # KiB on Linux


def mesh_main(
    cfg: Config,
    params_coarse,
    params_fine,
    ins_rgbs: np.ndarray,
    save_dir: str,
    ins_map: Optional[Dict] = None,
    color_dict: Optional[Dict] = None,
    grid_dim: int = GRID_DIM,
    extents: Optional[np.ndarray] = None,
    threshold: float = 0.2,
    level: Optional[float] = None,
    device=None,
) -> Dict:
    """Writes mesh.ply and color_mesh.ply into ``save_dir``. Returns the vertex and
    face counts, each stage's seconds (``seconds``), the peak resident memory, and
    for the coloured mesh its vertex rays and labels (``path`` None and no colour
    keys when the iso-surface is empty)."""
    device = resolve_device(device)
    if color_dict is None:
        color_dict = {str(i): i for i in range(cfg.ins_num)}
    if ins_map is None:
        ins_map = {str(i): i for i in range(cfg.ins_num)}
    if extents is None:
        extents = DEFAULT_EXTENTS
    seconds = {}
    stats = {"path": None, "seconds": seconds}

    def stage(name, t0):
        seconds[name] = time.perf_counter() - t0
        return time.perf_counter()

    mesh_file = os.path.join(cfg.datadir, "mesh.ply")
    if os.path.exists(mesh_file):
        verts_scene, _ = read_ply(mesh_file)
        to_origin, _ = oriented_bounds_pca(verts_scene)
        scene_transform = np.linalg.inv(to_origin)
    else:
        scene_transform = np.eye(4)

    t = time.perf_counter()
    grid = build_grid(scene_transform, np.asarray(extents), grid_dim)
    t = stage("grid", t)
    sigma = make_sigma_query(cfg)(params_fine, torch.from_numpy(grid).to(device)).cpu().numpy()
    t = stage("sweep", t)

    voxel = (cfg.far - cfg.near) / cfg.N_importance
    occ = 1.0 - np.exp(-np.maximum(sigma, 0) * voxel)
    occ = occ.reshape(grid_dim, grid_dim, grid_dim)
    print(f"[mesh] fraction occupied: {(occ > threshold).mean():.4f} "
          f"max {occ.max():.3f} mean {occ.mean():.4f}")

    verts, faces = marching_tetrahedra(occ, level if level is not None else LEVEL)
    t = stage("marching", t)
    stats.update(verts=len(verts), faces=len(faces))
    if len(faces) == 0:
        print("[mesh] empty iso-surface; nothing to write")
        stats["peak_rss_gb"] = _peak_rss_gb()
        return stats
    # grid index -> [0,1] -> [-1,1] -> scene frame
    verts = verts / (grid_dim - 1)
    verts = (verts - 0.5) * 2.0
    verts = verts * (np.asarray(extents) / 2.0)
    verts = verts @ scene_transform[:3, :3].T + scene_transform[:3, 3]

    write_ply(os.path.join(save_dir, "mesh.ply"), verts.astype(np.float32), faces)
    print(f"[mesh] mesh.ply: {len(verts)} verts, {len(faces)} faces")
    t = stage("ply", t)

    verts_c, faces_c, _ = clean_mesh(verts, faces, min_num_cluster=MIN_CLUSTER)
    if len(faces_c) == 0:
        verts_c, faces_c = verts, faces
    t = stage("clean", t)
    normals = vertex_normals(verts_c, faces_c)
    t = stage("normals", t)
    print(f"[mesh] cleaned: {len(verts_c)} verts, {len(faces_c)} faces")

    # per-vertex instance rays: march along the negative normal through the renderer
    rays_d = -normals
    rays_d = rays_d[:, [0, 2, 1]].copy()
    rays_d[:, 1] *= -1
    v_sw = verts_c[:, [0, 2, 1]].copy()
    v_sw[:, 1] *= -1
    rays_o = v_sw - rays_d * 0.03 * cfg.near

    renderer = make_image_renderer(cfg.replace(near=0.01, far=15.0, perturb=0.0))
    rays_o_t = torch.as_tensor(rays_o, dtype=torch.float32, device=device)
    rays_d_t = torch.as_tensor(rays_d, dtype=torch.float32, device=device)
    out = renderer(params_coarse, params_fine, rays_o_t, rays_d_t)
    pred_label = out["ins"].argmax(-1).cpu().numpy()
    t = stage("color_render", t)
    colors = render_label2world(pred_label, ins_rgbs, color_dict, ins_map)

    out_path = os.path.join(save_dir, "color_mesh.ply")
    write_ply(out_path, verts_c.astype(np.float32), faces_c, colors=colors, normals=normals)
    stage("color_ply", t)
    stats.update(path=out_path, clean_verts=len(verts_c), clean_faces=len(faces_c),
                 rays_o=rays_o_t, rays_d=rays_d_t, labels=pred_label,
                 peak_rss_gb=_peak_rss_gb())
    print("[mesh] color_mesh.ply written; host seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in seconds.items())
          + f"; peak RSS {stats['peak_rss_gb']:.2f} GB")
    return stats
