"""The benchmark's arithmetic: the card's peaks, the analytic work of the point query,
rooflines, percentiles and the union of intervals. Counted from a cell's shapes, never
from the program's implementation.

The analytic matmul count is the port's bench's (``dmnerf_tpu_torch/bench.py``
``analytic_matmul_flops``, itself the JAX bench's): 2 * in * out a point and layer, a
train step 3x its forward (dx and dW). At the flagship widths and ins_num 32 the full
model is 1,391,872 FLOPs a point and a training step of 3072 rays at 64 + 192 points a
ray 3,283.8 GFLOP.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}


def embed_dim(multires: int, input_dims: int = 3) -> int:
    return input_dims * (1 + 2 * multires) if multires > 0 else input_dims


def head_dims(conf: dict) -> Dict[str, List[Tuple[int, int]]]:
    """(in, out) of each layer, by part: the trunk, sigma, the rgb head, the instance
    head."""
    D, W = conf["netdepth"], conf["netwidth"]
    cp, cv = embed_dim(conf["multires"]), embed_dim(conf["multires_views"])
    trunk, in_dim = [], cp
    for i in range(D):
        trunk.append((in_dim, W))
        in_dim = W + cp if i in conf["skips"] else W
    return {"trunk": trunk, "sigma": [(W, 1)],
            "rgb": [(W, W), (W + cv, W // 2), (W // 2, 3)],
            "ins": [(W, W), (W, W // 2), (W // 2, conf["ins_num"] + 1)]}


# the parts of the model a query needs, by what its result is read for
MODELS = {"full": ("trunk", "sigma", "rgb", "ins"), "sigma": ("trunk", "sigma"),
          "sigma_ins": ("trunk", "sigma", "ins")}


def point_flops(conf: dict, model: str = "full") -> int:
    dims = head_dims(conf)
    return 2 * sum(i * o for part in MODELS[model] for i, o in dims[part])


def n_params(conf: dict) -> int:
    dims = head_dims(conf)
    return sum(i * o + o for part in dims.values() for i, o in part)


def train_step_flops(conf: dict) -> int:
    """The bench's count of a train step: 3 x the full model's forward on the coarse and
    the fine points."""
    n = conf["N_train"]
    pts = n * conf["N_samples"] + n * (conf["N_samples"] + conf["N_importance"])
    return 3 * point_flops(conf, "full") * pts


def query_work(conf: dict, q: dict) -> Tuple[float, float]:
    """(FLOPs, bytes) of one point query ``q`` = {points, rays, model, pass}: the forward
    reads the points and the view directions (fp32) and the model's parameters (fp32)
    once and writes the raw outputs (fp32, 4 + ins_num + 1 a point); the backward does
    twice the forward's products, reads the output's cotangent, the points, the
    directions and the parameters, and writes the parameters' gradients."""
    P, R = q["points"], q["rays"]
    flops = point_flops(conf, q["model"]) * P
    c4 = 4 + conf["ins_num"] + 1
    params = 4 * n_params(conf)
    io = 4 * (3 * P + 3 * R)
    if q["pass"] == "fwd":
        return float(flops), float(io + params + 4 * c4 * P)
    return float(2 * flops), float(io + params + 4 * c4 * P + params)


def least_seconds(conf: dict, queries: Iterable[dict], pass_: str, kind: str) -> float:
    """The least time of the queries of one pass on card ``kind``: per query the larger of
    its FLOPs over the peak rate and its bytes over the peak bandwidth."""
    total = 0.0
    for q in queries:
        if q["pass"] != pass_:
            continue
        f, b = query_work(conf, q)
        total += max(f / PEAK_FLOPS[kind], b / PEAK_BYTES[kind])
    return total


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(e - s for s, e in merge(intervals))


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0 < q < 100) by linear interpolation between the order
    statistics (numpy's default)."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
