"""Assignment for the instance loss (``dmnerf_tpu/objfield/hungarian.py``).

The JAX package solves it on the device, inside the jitted train step, with a
Jonker-Volgenant shortest-augmenting-path solver. Here the same solver is K11
(``kernels/assignment.py``, ``csrc/assignment.cu``) for CUDA tensors and its plain
PyTorch version for CPU tensors; both give the JAX solver's ``col4row``, ties included.
The count of valid rows stays on the device, so a train step on the card makes no host
round trip for its assignments. Evaluation's AP matching (``objfield.metrics``) keeps
scipy on the host.
"""

from __future__ import annotations

from typing import Union

import torch

from dmnerf_tpu_torch.kernels.assignment import assignment, masked_assignment_ref


def masked_assignment(cost: torch.Tensor, valid_rows: Union[int, torch.Tensor]) -> torch.Tensor:
    """Assignment for the first ``valid_rows`` rows of square cost matrices
    ``[..., n, n]`` (an int, or a tensor of one value or one per matrix); returns col4row
    ``[..., n]`` (int64) on the cost's device. Rows at or past ``valid_rows`` take the
    leftover columns in index order.

    The cost carries no gradient. NaN and +inf read as 1e9 and -inf as -1e9, as the JAX
    package does before its solve. A CPU tensor takes the plain version, a CUDA tensor
    the kernel; there is no fallback from one to the other."""
    if cost.device.type == "cpu":
        return masked_assignment_ref(cost, valid_rows)
    n = cost.shape[-1]
    flat = cost.detach().float().reshape(-1, n, n).contiguous()
    B = flat.shape[0]
    if isinstance(valid_rows, torch.Tensor):
        valid = valid_rows.to(device=cost.device, dtype=torch.int32).reshape(-1)
        valid = valid.expand(B).contiguous() if valid.numel() == 1 else valid.contiguous()
    else:
        valid = torch.full((B,), int(valid_rows), dtype=torch.int32, device=cost.device)
    return assignment(flat, valid).reshape(cost.shape[:-1])
