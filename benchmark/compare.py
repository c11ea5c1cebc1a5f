"""The numbers that decide ``correct``: gaps between what the program's timed path produced
and what the reference computes from the same inputs.

 * ``worst_relative``: the largest |a - r| / |r| over matched scalars (a step's loss);
 * ``leaf_norm_gaps``: per tensor, the gap between the program's norm and the reference's
   (not the norm of their difference), over the reference's norm of that tensor or the
   median tensor's, whichever is larger. Tensors whose reference gradient is under a
   thousandth of the median tensor's are left out (``moving``);
 * ``rms``: the root mean square of a map's difference; ``median_gap``: the median pixel's
   largest channel difference, which a few rays whose discrete choices (a sample's
   instance label in the manipulator's exchange) flip under rounding do not move.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch


def worst_relative(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return float("inf")
    gaps = [abs(a - r) / max(abs(r), 1e-12) for a, r in zip(prog, ref)]
    return max(gaps) if all(np.isfinite(prog)) else float("inf")


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in tensors.items()}


def moving(grads: Dict[str, torch.Tensor]) -> Iterable[str]:
    """The tensors whose reference gradient is at least a thousandth of the median
    tensor's."""
    n = norms(grads)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= 1e-3 * med]


def leaf_norm_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each tensor's gap of norms (see the module docstring), by name."""
    keys = list(ref) if keys is None else list(keys)
    if any(k not in prog for k in keys):
        return {k: float("inf") for k in keys}
    rn = {k: float(torch.linalg.norm(ref[k].double())) for k in keys}
    pn = {k: float(torch.linalg.norm(prog[k].double().to(ref[k].device))) for k in keys}
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) if np.isfinite(pn[k])
            else float("inf") for k in keys}


def rms(a: np.ndarray, r: np.ndarray) -> float:
    d = np.asarray(a, np.float64) - np.asarray(r, np.float64)
    return float(np.sqrt(np.mean(d * d))) if np.all(np.isfinite(a)) else float("inf")


def median_gap(a: np.ndarray, r: np.ndarray) -> float:
    """The median over pixels of the largest channel's |a - r|."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(r, np.float64)).max(-1)
    return float(np.median(d)) if np.all(np.isfinite(a)) else float("inf")
