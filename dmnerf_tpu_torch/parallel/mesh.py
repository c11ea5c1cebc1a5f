"""Multi-GPU scaling: ray-sharded data parallelism over a ``torch.distributed`` group
(``dmnerf_tpu/parallel/mesh.py``, whose function names this module keeps).

One process a GPU in a process group (NCCL on the card, gloo on the CPU); each rank's
device is ``cuda:{LOCAL_RANK}``, and ``torchrun`` starts such a world. The design is the
JAX module's:

 * one data axis: the ray batch, and every per-ray tensor derived from it, is sharded
   on it. Every rank draws the global batch and the global uniforms from the same
   generators and takes its contiguous rows (``shard_batch``);
 * parameters, Adam's state and the random streams are replicated;
 * every sum over rays in the loss is a rank-local partial sum followed by one small
   all-reduce whose backward is the identity (``Mesh.reduce``; ``objfield.losses``),
   so every rank computes the global loss and its gradient is the rank's share. The
   instance loss's cost matrices are summed this way before the assignment, which then
   runs on every rank (K11) on the same costs; no per-ray tensor is gathered;
 * the gradient is all-reduced (sum) as one flat buffer, then Adam runs on every rank;
 * the renderers pad the rays to a multiple of the world size, render this rank's
   slice with the single-device renderer (each rank runs the kernels on its own card,
   so the point query needs nothing of the mesh) and all-gather the maps, so every
   rank returns the whole view.

Without a process group ``make_mesh`` gives a world of one with no group, and the
port runs exactly as it does without this module.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.render.trainstep import Batch, make_train_step
from dmnerf_tpu_torch.utils.device import distributed, resolve_device

# a rendezvous or a collective that cannot complete fails after this, never hangs
TIMEOUT = datetime.timedelta(minutes=5)
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the identity, so a replicated function
    of the sum gives each rank the gradient of its own share."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis ('data') device mesh: the process group (None: a world of one without
    collectives), its size, this rank and this rank's device."""
    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of n (a multiple of the size)."""
        m = n // self.size
        return slice(self.rank * m, (self.rank + 1) * m)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, differentiable (identity backward)."""
        return _AllReduceSum.apply(x, self.group)

    def reduce_grads(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """Sum the gradients over the ranks in place, as one flat buffer."""
        grads = [g for g in grads if g is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (the same shape on each), concatenated in rank order."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)


def multi_process(cfg: Config) -> bool:
    """Whether an entry point joins a process group from the environment:
    ``multihost``, ``$DMNERF_MULTIHOST=1`` or a ``torchrun`` world of more than one."""
    return (cfg.multihost or os.environ.get("DMNERF_MULTIHOST", "") == "1"
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def init_process_group(device=None, init_method: str = "env://", rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout: datetime.timedelta = TIMEOUT,
                       backend: Optional[str] = None) -> Mesh:
    """Join the process group unless one is up, and return its mesh. ``env://`` reads
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (``torchrun`` sets them,
    and ``LOCAL_RANK``, which picks the card); ``tcp://host:port`` takes ``rank`` and
    ``world_size``. ``timeout`` bounds the rendezvous and every collective. ``backend``:
    NCCL for a card and gloo for the CPU unless named (gloo also takes CUDA tensors, so
    two ranks can share one card, which NCCL refuses)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not distributed():
        if init_method == "env://":
            missing = [v for v in ENV_VARS if v not in os.environ]
            if missing:
                raise RuntimeError(
                    f"multi-process training needs {', '.join(missing)} in the environment: "
                    "start each rank with torchrun (torchrun --nproc_per_node=N -m "
                    "dmnerf_tpu_torch.train --config ...; across hosts add --nnodes, "
                    "--node_rank and --master_addr) or set them")
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        kwargs = {} if rank is None else {"rank": rank, "world_size": world_size}
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device      # NCCL's communicator now, not at a capture
        dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kwargs)
    return make_mesh(device=device)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the process group that is up (every rank of it), or a world of one
    without a group. ``n_devices``, when given, must be that size."""
    device = resolve_device(device)
    if distributed():
        mesh = Mesh(dist.group.WORLD, dist.get_world_size(), dist.get_rank(), device)
    else:
        mesh = Mesh(None, 1, 0, device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"a mesh of {n_devices} devices asked for in a world of {mesh.size}")
    return mesh


def shard_batch(mesh: Mesh, batch: Batch) -> Batch:
    """This rank's contiguous rows of the global batch."""
    rows = mesh.rows(batch.rays_o.shape[0])
    return Batch(*(None if x is None else x[rows] for x in batch))


def make_sharded_train_step(cfg: Config, mesh: Mesh, query_fn=None, N_ins=None):
    """``render.trainstep.make_train_step``'s step as this rank's step of the global
    batch (``make_train_step(..., shard=mesh)``): the same arguments, the global batch
    and draws. cfg.N_train must be a multiple of the mesh's size."""
    if cfg.N_train % mesh.size:
        raise ValueError(f"N_train={cfg.N_train} not divisible by data axis {mesh.size}")
    if mesh.group is None:
        return make_train_step(cfg, query_fn=query_fn, N_ins=N_ins)
    return make_train_step(cfg, query_fn=query_fn, N_ins=N_ins, shard=mesh)


def make_packed_sharded_steps(cfg: Config, sampler, N_ins, mesh: Mesh, pack: int):
    """``steps_per_dispatch`` composed with the sharded step: a ``render.packing.StepRunner``
    of ``pack`` sharded steps, which on the card captures them, NCCL's collectives
    included, into one CUDA graph (its eager warm-up steps run the collectives first).
    The trajectory is the unpacked sharded trajectory, bit for bit."""
    from dmnerf_tpu_torch.render.packing import StepRunner

    if mesh.device.type == "cuda" and mesh.group is not None \
            and dist.get_backend(mesh.group) != "nccl":
        raise ValueError("packed steps on the card capture their collectives into a CUDA "
                         f"graph, which needs NCCL, not {dist.get_backend(mesh.group)}")
    step = make_sharded_train_step(cfg, mesh, N_ins=N_ins)
    return StepRunner(cfg, sampler, step, mesh.device, pack)


def _pad_rows(x: torch.Tensor, m: int, dim: int = 0) -> torch.Tensor:
    """``x`` with zero rows appended along ``dim`` up to a multiple of m."""
    pad = (-x.shape[dim]) % m
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim)


def _gather_maps(mesh: Mesh, out: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """Every rank's maps (one all-gather of them side by side), cut to the first n rows."""
    m = next(iter(out.values())).shape[0]
    widths = [v[0].numel() for v in out.values()]
    flat = mesh.gather(torch.cat([v.reshape(m, -1).float() for v in out.values()], -1))
    return {k: part.reshape((-1,) + v.shape[1:]).to(v.dtype)[:n]
            for (k, v), part in zip(out.items(), flat.split(widths, -1))}


def make_sharded_image_renderer(cfg: Config, mesh: Mesh, query_fn=None):
    """``render.renderer.make_image_renderer``'s function over the mesh: the rays padded
    to a multiple of its size, this rank's slice rendered by the single-device chunked
    renderer, the maps all-gathered, so every rank returns the whole view."""
    from dmnerf_tpu_torch.render.renderer import make_image_renderer

    inner = make_image_renderer(cfg, query_fn=query_fn)

    def render_fn(params_coarse, params_fine, rays_o, rays_d):
        n = rays_o.shape[0]
        ro, rd = _pad_rows(rays_o, mesh.size), _pad_rows(rays_d, mesh.size)
        rows = mesh.rows(ro.shape[0])
        return _gather_maps(mesh, inner(params_coarse, params_fine, ro[rows], rd[rows]), n)

    return render_fn


def make_sharded_sigma_query(cfg: Config, mesh: Mesh, chunk: int = 65536, samples: int = 64):
    """``tools.mesh_extract.make_sigma_query`` over the mesh: the points padded to a
    multiple of its size, this rank's slice swept in chunks, the densities all-gathered."""
    from dmnerf_tpu_torch.tools.mesh_extract import make_sigma_query

    inner = make_sigma_query(cfg, chunk=chunk, samples=samples)

    def query(params_fine, pts):
        n = pts.shape[0]
        p = _pad_rows(pts, mesh.size)
        return _gather_maps(mesh, {"sigma": inner(params_fine, p[mesh.rows(p.shape[0])])},
                            n)["sigma"]

    return query


def rank_generator(mesh: Mesh, generator: torch.Generator) -> torch.Generator:
    """This rank's generator, derived from the caller's and the rank (the JAX module's
    ``fold_in(key, axis_index('data'))``): every rank draws one seed a rank from the
    caller's generator alike and seeds its own from its seed."""
    seeds = torch.randint(0, 2 ** 62, (mesh.size,), generator=generator,
                          device=generator.device)
    return torch.Generator(device=generator.device).manual_seed(int(seeds[mesh.rank]))


def make_sharded_manipulator_renderer(cfg: Config, mesh: Mesh, n_targets: int, query_fn=None):
    """``render.manipulator.make_manipulator_renderer``'s function over the mesh, the
    rays sharded as in ``make_sharded_image_renderer``. Det mode (no generator) gives the
    single-device renderer's result; with a generator each rank draws from its own
    (``rank_generator``), so shards given identical ray bundles draw distinct
    inverse-CDF streams."""
    from dmnerf_tpu_torch.render.manipulator import make_manipulator_renderer

    inner = make_manipulator_renderer(cfg, n_targets, query_fn=query_fn)

    def render_fn(params_coarse, params_fine, ori_o, ori_d, tar_o, tar_d, move_labels,
                  generator: Optional[torch.Generator] = None):
        n = ori_o.shape[0]
        oo, od = _pad_rows(ori_o, mesh.size), _pad_rows(ori_d, mesh.size)
        to, td = _pad_rows(tar_o, mesh.size, 1), _pad_rows(tar_d, mesh.size, 1)
        rows = mesh.rows(oo.shape[0])
        if generator is not None:
            generator = rank_generator(mesh, generator)
        out = inner(params_coarse, params_fine, oo[rows], od[rows], to[:, rows], td[:, rows],
                    move_labels, generator=generator)
        return _gather_maps(mesh, out, n)

    return render_fn


def broadcast_object(mesh: Mesh, obj=None):
    """Rank 0's ``obj`` on every rank (pickled; for host data such as a mesh's vertex rays)."""
    if mesh.group is None:
        return obj
    box: List = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]
