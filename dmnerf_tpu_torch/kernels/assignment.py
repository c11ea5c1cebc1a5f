"""K11: the masked linear-sum assignment of the instance loss, its plain PyTorch version
and its wrapper.

The JAX package solves the assignment on the device, inside the jitted train step: a
Jonker-Volgenant shortest-augmenting-path solver written with ``lax`` loops
(``dmnerf_tpu/objfield/hungarian.py:29-159``). ``csrc/assignment.cu`` is that solver as a
Hopper kernel (one block a matrix, one thread a column), so a train step makes no host
round trip and fits in a CUDA graph. ``masked_assignment_ref`` is the same algorithm in
PyTorch, line by line against the JAX function: the same fp32 operations in the same
order, ``argmin`` with NaN first and the lowest index on ties, the same loop bounds. Both
give JAX's ``col4row`` exactly, not only an assignment of the same cost.

``objfield.hungarian.masked_assignment`` routes: a CPU tensor gets the plain version, a
CUDA tensor the kernel (``assignment``) or an error.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Union

import torch

from dmnerf_tpu_torch.kernels import runtime

MAX_N = 1024    # csrc/assignment.cu: one thread a column, at most 1024 a block
_INF = float("inf")


def _valid_count(valid_rows: Union[int, torch.Tensor], batch: int) -> List[int]:
    """The valid row count of each of ``batch`` matrices, as host ints (plain version)."""
    v = torch.as_tensor(valid_rows).reshape(-1)
    v = v.expand(batch) if v.numel() == 1 else v
    if v.numel() != batch:
        raise ValueError(f"valid_rows of {v.numel()} values for {batch} matrices")
    return [int(x) for x in v.tolist()]


def _argmin(x: torch.Tensor) -> int:
    """jnp.argmin's index: the first NaN if there is one, else the first minimum
    (torch.argmin's order too)."""
    return int(torch.argmin(x))


def _solve(cost: torch.Tensor, valid: int, iterations: Optional[List[int]]) -> torch.Tensor:
    """col4row [n] int64 of one [n, n] fp32 matrix whose non-finite entries are already
    replaced: ``dmnerf_tpu/objfield/hungarian.py`` masked_assignment :141-159 with
    _augmenting_path_step :29-110 inlined."""
    n = cost.shape[0]
    ar = torch.arange(n)
    zero = torch.zeros((), dtype=torch.float32)
    inf = torch.full((), _INF, dtype=torch.float32)
    u = torch.zeros(n, dtype=torch.float32)
    v = torch.zeros(n, dtype=torch.float32)
    row4col = [-1] * n
    col4row = [-1] * n
    valid = min(max(valid, 0), n)
    steps = 0
    for cur in range(valid):
        # Dijkstra to the nearest unassigned column, bounded at n + 1 iterations
        i, min_val, sink, it = cur, zero, -1, 0
        remaining = torch.ones(n, dtype=torch.bool)
        sr = torch.zeros(n, dtype=torch.bool)
        shortest = torch.full((n,), _INF, dtype=torch.float32)
        path = torch.full((n,), -1, dtype=torch.long)
        while sink < 0 and it <= n:
            sr[i] = True
            r = min_val + cost[i] - u[i] - v
            upd = (r < shortest) & remaining
            path = torch.where(upd, i, path)
            shortest = torch.where(upd, r, shortest)
            masked = torch.where(remaining, shortest, inf)
            j = _argmin(masked)
            min_val = masked[j]
            if row4col[j] < 0:
                sink = j
            else:
                i = row4col[j]
            remaining[j] = False
            it += 1
        steps += it
        sink = max(sink, 0)    # bound hit: column 0

        # dual updates: u of the scanned rows, v of the scanned columns
        u = u + torch.where(ar == cur, min_val, zero)
        c4r = torch.tensor(col4row)
        at_col = torch.where(c4r >= 0, shortest[c4r.clamp(min=0)], zero)
        u = u + torch.where(sr & (ar != cur), min_val - at_col, zero)
        v = v - torch.where(~remaining, min_val - shortest, zero)

        # augment along the predecessors from the sink back to cur, bounded at n + 1
        path_l = path.tolist()
        j, done, it = sink, False, 0
        while not done and it <= n:
            inside = 0 <= j < n
            row = max(path_l[j] if inside else 0, 0)
            if inside:
                row4col[j] = row
            nxt = col4row[row]
            col4row[row] = j
            j, done, it = nxt, row == cur, it + 1
    if iterations is not None:
        iterations.append(steps)

    # padding rows take the leftover columns in index order
    col_for_rank = [0] * n
    free = [c for c in range(n) if row4col[c] < 0]
    col_for_rank[:len(free)] = free
    out = [col4row[k] if k < valid else col_for_rank[min(max(k - valid, 0), n - 1)]
           for k in range(n)]
    return torch.tensor(out, dtype=torch.long)


def masked_assignment_ref(cost: torch.Tensor, valid_rows: Union[int, torch.Tensor],
                          iterations: Optional[List[int]] = None) -> torch.Tensor:
    """K11's function on the CPU: col4row [..., n] int64 of square costs [..., n, n] for
    the first ``valid_rows`` rows (an int, or a tensor of one value or one per matrix),
    computed as the JAX package's ``masked_assignment``. ``iterations``, when given, gets
    each matrix's Dijkstra iterations over its valid rows appended (the serial steps of
    K11's bound)."""
    n = cost.shape[-1]
    flat = torch.nan_to_num(cost.detach().float().reshape(-1, n, n).cpu(), nan=1e9, posinf=1e9,
                            neginf=-1e9)
    valid = _valid_count(valid_rows, flat.shape[0])
    out = torch.stack([_solve(c, k, iterations) for c, k in zip(flat, valid)]) \
        if flat.shape[0] else torch.empty((0, n), dtype=torch.long)
    return out.reshape(cost.shape[:-1])


def assignment(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One launch of K11: costs [B, n, n] fp32 and the valid row counts [B] int32, both
    contiguous on the card -> col4row [B, n] int64, on the current stream. Makes no host
    read and no allocation but its output, so it can be captured in a CUDA graph."""
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2] or not 1 <= cost.shape[-1] <= MAX_N:
        raise ValueError(f"assignment wants costs [B, n, n] with 1 <= n <= {MAX_N}, got "
                         f"{tuple(cost.shape)}")
    dev = cost.device
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"assignment is built for sm_90a; device {dev} is not capability 9.0")
    for what, t, dt, shape in (("cost", cost, torch.float32, tuple(cost.shape)),
                               ("valid", valid, torch.int32, (cost.shape[0],))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: want a contiguous {dt} {list(shape)} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    B, n = cost.shape[0], cost.shape[-1]
    out = torch.empty((B, n), dtype=torch.long, device=dev)
    if B == 0:
        return out
    fn = _lib().dmnerf_assignment
    err = fn(cost.data_ptr(), valid.data_ptr(), out.data_ptr(), B, n,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"assignment launch failed: cudaError {err}")
    runtime.count_launch("assignment")
    return out


def argmin_probe(threads: int, iters: int, out: torch.Tensor) -> None:
    """Launch csrc/assignment.cu's latency probe: ``iters`` dependent block-wide argmins in
    one block of ``threads``; out [1] fp32 on the card. A measurement, not a kernel of
    any path: it is not counted."""
    err = _lib().dmnerf_assignment_argmin_probe(threads, iters, out.data_ptr(),
                                                torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"assignment argmin probe launch failed: cudaError {err}")


def _lib() -> ctypes.CDLL:
    lib = runtime.load("assignment")
    if not getattr(lib, "typed", False):
        lib.dmnerf_assignment.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.dmnerf_assignment_argmin_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                                       ctypes.c_void_p]
        for fn in (lib.dmnerf_assignment, lib.dmnerf_assignment_argmin_probe):
            fn.restype = ctypes.c_int
        lib.typed = True
    return lib
