"""The port's CUDA kernels on the card: each against its plain version, at narrow
widths and at the flagship's, with ragged point counts. These tests need a CUDA card
of capability 9.0 and skip without one; they import no JAX, so they run on a machine
that has none:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dmnerf_tpu_torch.core.mlp import init_dm_nerf, sigma_stub_params  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402
from dmnerf_tpu_torch.kernels.fused_mlp import fused_query, fused_query_ref, pack_params  # noqa: E402

SHAPES = [
    # (multires, multires_views, D, W, skips, ins_num, N, S)
    (10, 4, 8, 256, (4,), 32, 37, 19),    # flagship widths, P = 703 (ragged)
    (4, 2, 2, 32, (0,), 4, 5, 7),         # tiny, one partial tile
    (6, 3, 5, 64, (1, 3), 8, 300, 13),    # two skips
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a CUDA card of capability 9.0 (the kernels are built for sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    mr, mrv, D, W, skips, ins, N, S = shape
    params = init_dm_nerf(ins_num=ins, D=D, W=W, input_ch_pts=3 * (1 + 2 * mr),
                          input_ch_views=3 * (1 + 2 * mrv), skips=skips,
                          generator=torch.Generator().manual_seed(seed), device=device)
    rng = np.random.RandomState(seed)
    pts = torch.from_numpy(rng.uniform(-8, 8, (N, S, 3)).astype(np.float32)).to(device)
    dirs = rng.randn(N, 3).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).to(device)
    return params, (mr, mrv, D, skips), pts, dirs


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_fwd_matches_plain(cuda, shape):
    params, args, pts, dirs = _inputs(shape, cuda)
    packed = pack_params(params, *args)
    runtime.reset_launches()
    got = fused_query(packed, pts, dirs)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["fused_mlp_fwd"] == 1
    ref32 = fused_query_ref(packed, pts, dirs, torch.float32)
    ref16 = fused_query_ref(packed, pts, dirs, torch.bfloat16)
    assert got.shape == ref32.shape and torch.isfinite(got).all()
    scale = float(ref32.abs().max())
    assert float((got - ref32).abs().max()) <= 5e-3 * max(scale, 1.0)
    # same roundings as the kernel; only the order of fp32 sums differs
    assert float((got - ref16).abs().max()) <= 1e-3 * max(scale, 1.0)


@pytest.mark.parametrize("shape", SHAPES[:1])
def test_fused_mlp_fwd_sigma_stub_exact(cuda, shape):
    params, args, pts, dirs = _inputs(shape, cuda, seed=1)
    full = fused_query(pack_params(params, *args), pts, dirs)[..., 3]
    stub = fused_query(pack_params(sigma_stub_params(params), *args), pts, dirs)[..., 3]
    assert float((stub - full).abs().max()) <= 1e-5 * max(float(full.abs().max()), 1.0)


def test_fused_mlp_fwd_refuses_what_it_cannot_hold(cuda):
    params, args, pts, dirs = _inputs((4, 2, 2, 40, (0,), 4, 3, 5), cuda)
    with pytest.raises(ValueError, match="W % 16"):
        fused_query(pack_params(params, *args), pts, dirs)
    params, args, pts, dirs = _inputs(SHAPES[1], cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fused_query(pack_params(params, *args), pts.transpose(0, 1), dirs)
