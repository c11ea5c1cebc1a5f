"""Device resolution for the port's entry points, this process's place in a
``torch.distributed`` group (one process a GPU; ``parallel.mesh``), and the CUDA graph
capture that the packed steps and the two renderers share, with the renderers' static
copies of their prepared parameters."""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple, TypeVar, Union

import torch
import torch.distributed as dist

T = TypeVar("T")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the CUDA card: ``cuda:{LOCAL_RANK}`` in a process that ``torchrun``
    started, else ``cuda``. Without one, raise rather than run on the CPU unasked: a
    caller that wants the CPU passes ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda")


def pop_device_flag(argv):
    """``(device, argv without it)`` of a command line that may hold ``--device D``;
    device None when it holds none (the entry points then take the card)."""
    argv = list(argv)
    if "--device" not in argv:
        return None, argv
    i = argv.index("--device")
    if i + 1 == len(argv):
        raise SystemExit("--device needs a value, e.g. --device cpu")
    return argv[i + 1], argv[:i] + argv[i + 2:]


def distributed() -> bool:
    """True when a process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The process group's size; 1 without one."""
    return dist.get_world_size() if distributed() else 1


def is_writer() -> bool:
    """Only rank 0 of a process group writes checkpoints, logs, images and meshes."""
    return not distributed() or dist.get_rank() == 0


def barrier() -> None:
    """Every rank waits here for the others; nothing without a process group."""
    if distributed():
        dist.barrier()


def capture_graph(stream: torch.cuda.Stream, warmup: Callable[[], object],
                  body: Callable[[], T]) -> Tuple[torch.cuda.CUDAGraph, T]:
    """``body`` captured as one CUDA graph on ``stream``, after ``warmup()`` ran there
    eagerly (the kernels' builds, the allocator's blocks, cuBLAS's workspace for that
    stream), behind the current stream's work and ahead of its next. Returns the graph
    and what ``body`` returned, which every replay writes again. A failed capture raises."""
    cur = torch.cuda.current_stream(stream.device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        warmup()
    cur.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = body()
    return graph, out


def static_params(prepared):
    """Tensors of their own holding ``prepared``: a parameter dict's (the plain query's),
    or the kernels' ``Packed``."""
    if isinstance(prepared, dict):
        return {k: v.clone() for k, v in prepared.items()}
    return prepared.clone()


def copy_params(static, prepared) -> None:
    """``prepared``'s values into ``static`` (``static_params``'s), in place; raises on a
    parameter of another shape."""
    if not isinstance(static, dict):
        static.copy_(prepared)
        return
    if {k: v.shape for k, v in static.items()} != {k: v.shape for k, v in prepared.items()}:
        raise ValueError("parameters of other shapes than the renderer's chunk graph was "
                         "captured with: make a renderer for each")
    for k, v in static.items():
        v.copy_(prepared[k])
