"""Assignment for the instance loss (``dmnerf_tpu/objfield/hungarian.py``).

The JAX package solves it on the device in a ``lax.while_loop``. Here it is a host
solve with ``scipy.optimize.linear_sum_assignment`` on the first ``valid`` rows,
as ``objfield.metrics`` already does for evaluation. Ties may break differently
from the JAX solver; the optimal cost is the same. A batch of cost matrices (the
coarse and the fine one of a training step) comes to the host in one copy.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from dmnerf_tpu_torch.objfield.metrics import _lsa_rect


def _assign(cost: np.ndarray, valid: int) -> np.ndarray:
    """col4row [n] for one square cost matrix: an optimal assignment of rows
    [0, valid); rows at or past ``valid`` take the leftover columns in index order
    (``dmnerf_tpu/objfield/hungarian.py:152-159``)."""
    n = cost.shape[0]
    col4row = np.empty(n, np.int64)
    col4row[:valid] = _lsa_rect(cost[:valid]) if valid > 0 else []
    free = np.ones(n, bool)
    free[col4row[:valid]] = False
    col4row[valid:] = np.flatnonzero(free)
    return col4row


def masked_assignment(cost: torch.Tensor, valid_rows: Union[int, torch.Tensor]) -> torch.Tensor:
    """Assignment for the first ``valid_rows`` rows of square cost matrices
    ``[..., n, n]``; returns col4row ``[..., n]`` (int64) on the cost's device.

    The cost carries no gradient. NaN and +inf become 1e9 and -inf -1e9, as the JAX
    package does before its solve, so a non-finite step degrades rather than
    raising in scipy. The costs and the row count cross to the host together."""
    n = cost.shape[-1]
    flat = cost.detach().float().reshape(-1)
    valid_t = torch.as_tensor(valid_rows, dtype=torch.float32, device=cost.device).reshape(1)
    host = torch.cat([flat, valid_t]).cpu().numpy()
    valid = int(np.clip(host[-1], 0, n))
    costs = np.nan_to_num(host[:-1].reshape(-1, n, n), nan=1e9, posinf=1e9, neginf=-1e9)
    out = np.stack([_assign(c, valid) for c in costs])
    return torch.from_numpy(out.reshape(cost.shape[:-1])).to(cost.device)
