"""K11: the masked linear-sum assignment of the instance loss, its plain PyTorch version
and its wrapper.

The JAX package solves the assignment on the device, inside the jitted train step: a
Jonker-Volgenant shortest-augmenting-path solver written with ``lax`` loops
(``dmnerf_tpu/objfield/hungarian.py:29-159``). ``csrc/assignment.cu`` is that solver as a
Hopper kernel (one warp a matrix up to n = 32, one block a matrix above), so a train step
makes no host round trip and fits in a CUDA graph. ``masked_assignment_ref`` is the same
algorithm in PyTorch, line by line against the JAX function: the same fp32 operations in the same
order, ``argmin`` with NaN first and the lowest index on ties, the same loop bounds. Both
give JAX's ``col4row`` exactly, not only an assignment of the same cost.

``objfield.hungarian.masked_assignment`` routes: a CPU tensor gets the plain version, a
CUDA tensor the kernel (``assignment``) or an error. ``argmin_key`` is the plain twin of
the warp design's argmin key (tests hold it to ``torch.argmin`` and ``jnp.argmin``); the
probes and ``assignment_block`` are measurements and card tests, launched by no path.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Union

import torch

from dmnerf_tpu_torch.kernels import runtime

MAX_N = 1024    # csrc/assignment.cu: one thread a column, at most 1024 a block
WARP_N = 32     # n <= WARP_N: one warp a matrix
PAD_KEY = 0xFFFFFFFF    # the key of a lane past n: above +inf's
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
    (torch.argmin's order too). Subnormals compare exactly, where JAX's CPU backend reads
    them as 0."""
    return int(torch.argmin(x))


def argmin_key(x: torch.Tensor, lanes: Optional[int] = None) -> torch.Tensor:
    """K11's argmin order key (``csrc/assignment.cu`` ``order_key``) of each element of fp32
    ``x`` [..., L], as int64 holding the uint32 key: NaN of any sign and payload -> 0, -0
    read as +0, a float f >= 0 -> bits(f) | 0x80000000, f < 0 -> ~bits(f). Unsigned key
    order is ``jnp.argmin``'s order, so the first lowest key is its index. ``lanes`` (>= L)
    pads the last axis to a warp's lanes with ``PAD_KEY``, which no real lane reaches."""
    x = x.float()
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    key = torch.where(bits >= 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    key = torch.where(torch.isnan(x), 0, key)
    if lanes is not None and lanes > key.shape[-1]:
        pad = key.new_full((*key.shape[:-1], lanes - key.shape[-1]), PAD_KEY)
        key = torch.cat([key, pad], -1)
    return key


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


def _check(cost: torch.Tensor, valid: torch.Tensor) -> None:
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


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def assignment(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One launch of K11: costs [B, n, n] fp32 and the valid row counts [B] int32, both
    contiguous on the card -> col4row [B, n] int64, on the current stream (one warp a
    matrix for n <= 32, one block a matrix above). Makes no host read and no allocation
    but its output, so it can be captured in a CUDA graph."""
    _check(cost, valid)
    dev = cost.device
    B, n = cost.shape[0], cost.shape[-1]
    out = torch.empty((B, n), dtype=torch.long, device=dev)
    if B == 0:
        return out
    _raise(_lib().dmnerf_assignment(cost.data_ptr(), valid.data_ptr(), out.data_ptr(), B, n,
                                    torch.cuda.current_stream(dev).cuda_stream), "assignment")
    runtime.count_launch("assignment")
    return out


def assignment_block(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K11's function by the block design at any n (the entry takes it above n = 32 only),
    so card tests can hold the two designs to each other: not counted, no path's launch."""
    _check(cost, valid)
    B, n = cost.shape[0], cost.shape[-1]
    out = torch.empty((B, n), dtype=torch.long, device=cost.device)
    _raise(_lib().dmnerf_assignment_block(
        cost.data_ptr(), valid.data_ptr(), out.data_ptr(), B, n,
        torch.cuda.current_stream(cost.device).cuda_stream), "assignment block design")
    return out


def argmin_probe(threads: int, iters: int, out: torch.Tensor) -> None:
    """Launch csrc/assignment.cu's block-argmin probe: ``iters`` dependent block-wide
    argmins (the block design's, its earlier bound) in one block of ``threads``; out [1] fp32
    on the card. A measurement, not a kernel of any path: it is not counted."""
    _raise(_lib().dmnerf_assignment_argmin_probe(
        threads, iters, out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream),
        "assignment argmin probe")


def chain_probe(mode: int, iters: int, ring: Optional[torch.Tensor], out: torch.Tensor) -> None:
    """Launch the chain floor's probe, which calls nothing of the solver: one warp chains
    ``iters`` warp steps (mode 0: a dependent shared-memory load, redux.sync.min.u32,
    vote.ballot + __ffs, __shfl_sync) or dependent L2 loads through ``ring`` (mode 1: int32
    on the card, each entry an index into it). out [1] int32 on the card. Not counted."""
    _raise(_lib().dmnerf_assignment_chain_probe(
        mode, iters, None if ring is None else ring.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream), "assignment chain probe")


def key_probe(x: torch.Tensor):
    """K11's own order key and warp argmin on x [count, n] fp32 (n <= 32) on the card ->
    (keys [count, 32] int64 holding the uint32 keys, lanes past n padded; argmin [count]
    int64). A card test's probe: not counted."""
    if x.dim() != 2 or not 1 <= x.shape[1] <= WARP_N or x.dtype != torch.float32 \
            or not x.is_contiguous() or x.shape[0] < 1:
        raise ValueError(f"key_probe wants a contiguous fp32 [count, n <= {WARP_N}] tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    count, n = x.shape
    keys = torch.empty((count, WARP_N), dtype=torch.int32, device=x.device)
    idx = torch.empty(count, dtype=torch.int32, device=x.device)
    _raise(_lib().dmnerf_assignment_key_probe(x.data_ptr(), n, count, keys.data_ptr(),
                                              idx.data_ptr(),
                                              torch.cuda.current_stream(x.device).cuda_stream),
           "assignment key probe")
    return keys.to(torch.int64) & 0xFFFFFFFF, idx.to(torch.int64)


def _lib() -> ctypes.CDLL:
    lib = runtime.load("assignment")
    if not getattr(lib, "typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dmnerf_assignment.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
        lib.dmnerf_assignment_block.argtypes = [ptr] * 3 + [i32] * 2 + [ptr]
        lib.dmnerf_assignment_argmin_probe.argtypes = [i32, i32, ptr, ptr]
        lib.dmnerf_assignment_chain_probe.argtypes = [i32, i32, ptr, ptr, ptr]
        lib.dmnerf_assignment_key_probe.argtypes = [ptr, i32, i32, ptr, ptr, ptr]
        for fn in (lib.dmnerf_assignment, lib.dmnerf_assignment_block,
                   lib.dmnerf_assignment_argmin_probe, lib.dmnerf_assignment_chain_probe,
                   lib.dmnerf_assignment_key_probe):
            fn.restype = ctypes.c_int
        lib.typed = True
    return lib
