"""The port's CUDA kernels on the card: each against its plain version, at narrow
widths and at the flagship's, with ragged point counts; the backward kernels'
instance-head wall and their bit-identical repeats; the training forward's stash
against the standalone backward and the no-grad forward, bit for bit. K1/K2 take per-ray viewdirs
(pe_mode 'kernel_t'), K3/K4 per-point directions (pe_mode 'kernel'), K5/K6 the
embeddings that K7 and the per-ray viewdir table give (pe_mode 'outside'); K8c/K8f (the
fused render passes) take rays and depths and composite in the kernel; K9/K10 (the head
probes) take a hidden activation and their own layer tables, and the forward template
they joined still gives K1/K3/K5 their earlier bits. These tests
need a CUDA card of capability 9.0 and skip without one; they import no JAX, so they
run on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dmnerf_tpu_torch.core.mlp import init_dm_nerf, rgb_stub_params, sigma_stub_params  # noqa: E402
from dmnerf_tpu_torch.kernels import fused_mlp, runtime  # noqa: E402
from dmnerf_tpu_torch.kernels.fused_mlp import (  # noqa: E402
    LOCKSTEP, PIPELINED, _embedding, _forward, _forward_kpe, _forward_pe, _pe_launcher,
    _point_dirs, fused_query, fused_query_bwd, fused_query_bwd_ref, fused_query_kpe_bwd,
    fused_query_kpe_bwd_ref, fused_query_kpe_ref, fused_query_pe_bwd, fused_query_pe_bwd_ref,
    fused_query_pe_ref, fused_query_ref, pack_params, pe_points, pe_points_ref,
    point_view_embedding)

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


def _cotangent(packed, pts, seed=0):
    rng = np.random.RandomState(seed)
    g = rng.randn(*pts.shape[:2], packed.c4).astype(np.float32)
    return torch.from_numpy(g).to(pts.device)


def _block_errs(packed, got, want):
    """(max|d|, max|want|) of each packed layer's dW and db block."""
    out = []
    for layer in packed.layers:
        for sl in (slice(layer.w_off, layer.w_off + layer.K * layer.N), None):
            g_, w_ = (got[0][sl], want[0][sl]) if sl is not None else \
                (got[1][layer.b_off:layer.b_off + layer.N], want[1][layer.b_off:layer.b_off + layer.N])
            out.append((layer, float((g_ - w_).abs().max()), float(w_.abs().max())))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_bwd_matches_plain(cuda, shape):
    """K2 against its plain version, block by packed layer, relative to the block's
    largest entry. With a random cotangent: within 5e-3 of the bf16 plain version
    (the same roundings; only the order of fp32 sums differs, and a sum that lands
    on the other side of a bf16 rounding moves one cotangent by 2^-8). With the
    cotangent of sum(tanh(raw) * w) (the JAX package's gradient gate, bench.py:388-401):
    the kernel's error against the fp32 plain version is at most the bf16 plain
    version's plus 5e-3, so all of it is bf16 rounding. (At these few hundred points
    that rounding alone can exceed the 2e-2 gate, which chip_smoke.py holds at the
    training shapes.)"""
    params, args, pts, dirs = _inputs(shape, cuda)
    packed = pack_params(params, *args)
    g = _cotangent(packed, pts)
    runtime.reset_launches()
    got = fused_query_bwd(packed, pts, dirs, g)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["fused_mlp_bwd"] == 1
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    ref16 = fused_query_bwd_ref(packed, pts, dirs, g, torch.bfloat16)
    for layer, err, scale in _block_errs(packed, got, ref16):
        assert err <= 5e-3 * max(scale, 1e-6), (layer, err, scale)

    raw = fused_query_ref(packed, pts, dirs, torch.float32)
    w = torch.linspace(0.5, 1.5, raw.shape[-1], device=cuda)
    g = ((1.0 - torch.tanh(raw) ** 2) * w).contiguous()
    ref32 = fused_query_bwd_ref(packed, pts, dirs, g, torch.float32)
    kernel = _block_errs(packed, fused_query_bwd(packed, pts, dirs, g), ref32)
    plain16 = _block_errs(packed, fused_query_bwd_ref(packed, pts, dirs, g, torch.bfloat16), ref32)
    for (layer, err, scale), (_, err16, _) in zip(kernel, plain16):
        assert err <= err16 + 5e-3 * max(scale, 1e-6), (layer, err, err16, scale)


def test_fused_mlp_bwd_wall(cuda):
    """An instance-only loss gives exactly zero trunk, rgb and density gradients
    through the kernel, and a nonzero instance head gradient."""
    params, args, pts, dirs = _inputs(SHAPES[0], cuda, seed=2)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    runtime.reset_launches()
    raw = fused_query(pack_params(params, *args), pts, dirs)
    raw[..., 4:].sum().backward()
    assert runtime.LAUNCHES == {"fused_mlp_fwd": 1, "fused_mlp_bwd": 1, "fused_mlp_fwd_kpe": 0,
                                "fused_mlp_bwd_kpe": 0, "fused_mlp_fwd_pe": 0,
                                "fused_mlp_bwd_pe": 0, "fused_pe": 0, "fused_render_weights": 0,
                                "fused_render_maps": 0, "head512": 0, "heads_fused": 0,
                                "assignment": 0}
    for k, v in params.items():
        if k.startswith(("trunk_", "rgb_", "density")):
            assert v.grad is None or int(torch.count_nonzero(v.grad)) == 0, k
    assert float(params["ins_out_w"].grad.abs().sum()) > 0


def test_fused_mlp_bwd_repeats_bit_identical(cuda):
    params, args, pts, dirs = _inputs(SHAPES[2], cuda, seed=3)
    packed = pack_params(params, *args)
    g = _cotangent(packed, pts, seed=3)
    first = fused_query_bwd(packed, pts, dirs, g)
    second = fused_query_bwd(packed, pts, dirs, g)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def _flat(pts, dirs):
    """The K3/K4 inputs of a [N, S] query: pts [P, 3] and one direction per point."""
    return pts.reshape(-1, 3).contiguous(), _point_dirs(dirs, pts.shape[1])


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_fwd_kpe_matches_plain(cuda, shape):
    params, args, pts, dirs = _inputs(shape, cuda)
    for p in (params, rgb_stub_params(params)):
        packed = pack_params(p, *args)
        fp, fd = _flat(pts, dirs)
        runtime.reset_launches()
        got = _forward_kpe(packed, fp, fd)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["fused_mlp_fwd_kpe"] == 1 and runtime.LAUNCHES["fused_mlp_fwd"] == 0
        ref32 = fused_query_kpe_ref(packed, fp, fd, torch.float32)
        ref16 = fused_query_kpe_ref(packed, fp, fd, torch.bfloat16)
        assert got.shape == ref32.shape and torch.isfinite(got).all()
        scale = float(ref32.abs().max())
        assert float((got - ref32).abs().max()) <= 5e-3 * max(scale, 1.0)
        assert float((got - ref16).abs().max()) <= 1e-3 * max(scale, 1.0)
        # through fused_query, and against K1 on the same rays (the same function)
        via = fused_query(packed, pts, dirs, "kernel")
        assert torch.equal(via.reshape(-1, packed.c4), got)
        k1 = fused_query(packed, pts, dirs)
        assert float((k1.reshape(-1, packed.c4) - got).abs().max()) <= 1e-3 * max(scale, 1.0)


@pytest.mark.parametrize("shape", SHAPES[:1])
def test_fused_mlp_fwd_kpe_stub_sigma_exact(cuda, shape):
    params, args, pts, dirs = _inputs(shape, cuda, seed=1)
    fp, fd = _flat(pts, dirs)
    full = _forward_kpe(pack_params(params, *args), fp, fd)[:, 3]
    for stub in (sigma_stub_params(params), rgb_stub_params(params)):
        got = _forward_kpe(pack_params(stub, *args), fp, fd)[:, 3]
        assert float((got - full).abs().max()) <= 1e-5 * max(float(full.abs().max()), 1.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_bwd_kpe_matches_plain(cuda, shape):
    """K4 against its bf16 plain version, block by packed layer, as K2's test: within
    5e-3 of each block's scale (the same roundings, another order of fp32 sums)."""
    params, args, pts, dirs = _inputs(shape, cuda)
    packed = pack_params(params, *args)
    fp, fd = _flat(pts, dirs)
    g = _cotangent(packed, pts).reshape(-1, packed.c4)
    runtime.reset_launches()
    got = fused_query_kpe_bwd(packed, fp, fd, g)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["fused_mlp_bwd_kpe"] == 1 and runtime.LAUNCHES["fused_mlp_bwd"] == 0
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    ref16 = fused_query_kpe_bwd_ref(packed, fp, fd, g, torch.bfloat16)
    for layer, err, scale in _block_errs(packed, got, ref16):
        assert err <= 5e-3 * max(scale, 1e-6), (layer, err, scale)


def test_fused_mlp_bwd_kpe_wall_and_repeats(cuda):
    """pe_mode 'kernel' through autograd: an instance-only loss gives exactly zero
    trunk, rgb and density gradients (K3 forward, K4 backward, one launch each), and
    two K4 calls on the same inputs are bit-identical."""
    params, args, pts, dirs = _inputs(SHAPES[0], cuda, seed=2)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    runtime.reset_launches()
    raw = fused_query(pack_params(params, *args), pts, dirs, "kernel")
    raw[..., 4:].sum().backward()
    assert runtime.LAUNCHES == {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0, "fused_mlp_fwd_kpe": 1,
                                "fused_mlp_bwd_kpe": 1, "fused_mlp_fwd_pe": 0,
                                "fused_mlp_bwd_pe": 0, "fused_pe": 0, "fused_render_weights": 0,
                                "fused_render_maps": 0, "head512": 0, "heads_fused": 0,
                                "assignment": 0}
    for k, v in params.items():
        if k.startswith(("trunk_", "rgb_", "density")):
            assert v.grad is None or int(torch.count_nonzero(v.grad)) == 0, k
    assert float(params["ins_out_w"].grad.abs().sum()) > 0

    params, args, pts, dirs = _inputs(SHAPES[2], cuda, seed=3)
    packed = pack_params(params, *args)
    fp, fd = _flat(pts, dirs)
    g = _cotangent(packed, pts, seed=3).reshape(-1, packed.c4)
    first, second = fused_query_kpe_bwd(packed, fp, fd, g), fused_query_kpe_bwd(packed, fp, fd, g)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def _embedded(packed, pts, dirs):
    """The K5/K6 inputs of a [N, S] query: K7's e and the per-point viewdir table, bf16."""
    e = pe_points(packed, pts.reshape(-1, 3).contiguous())
    return e, point_view_embedding(packed, dirs, pts.shape[1], torch.bfloat16)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_pe_matches_plain(cuda, shape):
    """K7 against its plain version: the x lanes bit-equal to bf16(x), the sin / cos
    lanes within 4e-3 of fp32 (bf16's half step at 1 is 2^-9), the pad columns zero;
    points up to 8 from the origin, phases up to 2^(multires-1) * 8."""
    params, args, pts, dirs = _inputs(shape, cuda)
    packed = pack_params(params, *args)
    x = pts.reshape(-1, 3).contiguous()
    runtime.reset_launches()
    got = pe_points(packed, x)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["fused_pe"] == 1
    assert got.dtype == torch.bfloat16 and got.shape == (x.shape[0], packed.ep)
    ref = pe_points_ref(packed, x, torch.float32)
    n = 3 * (1 + 2 * packed.multires)
    assert torch.equal(got[:, :3], x.to(torch.bfloat16))
    assert float((got[:, 3:n].float() - ref[:, 3:n]).abs().max()) <= 4e-3
    assert not got[:, n:].any()


# point counts around K7's 128-point tiles and its persistent grid: one point, less than
# a tile, a tile, a ragged second tile, many tiles, and enough that every block of the
# grid walks three tiles or more at up to 8 blocks an SM, with a ragged last one
PE_POINTS = [1, 3, 127, 128, 129, 4095, 33869, 132 * 8 * 128 * 3 + 77]
PE_GUARD = 64


def _pe_case(multires, P, device, seed=0):
    """Packed narrow params at ``multires`` and an x [P, 3] between -9.5 and 9.5 that is a
    contiguous slice from row 1 of a larger array (4-byte aligned, as a slice may be),
    with per-ray directions for S = 1."""
    params, args, _, _ = _inputs((multires, 2, 2, 32, (0,), 4, 1, 1), device, seed)
    packed = pack_params(params, *args)
    rng = np.random.RandomState(seed + P)
    big = torch.from_numpy(rng.uniform(-9.5, 9.5, (P + 1, 3)).astype(np.float32)).to(device)
    dirs = rng.randn(P, 3).astype(np.float32)
    dirs = torch.from_numpy(dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).to(device)
    return packed, big[1:], dirs


@pytest.mark.parametrize("P", PE_POINTS)
@pytest.mark.parametrize("multires", [4, 6, 10])
def test_fused_pe_ragged_points_widths_and_guard_rows(cuda, multires, P):
    """K7 at point counts around its tiles and grid and at the packed widths of multires
    4, 6 and 10 (EP 32, 48, 64; the first two on the generic path, the last unrolled),
    from a 4-byte-aligned x: launched into the first P rows
    of a larger array, it leaves the guard rows after them untouched, writes the x lanes
    bit-equal to bf16(x), sin / cos within 4e-3 of fp32 and zero pad columns, repeats
    bit for bit; and K5 over its e is bit for bit K1 on the same points."""
    packed, x, dirs = _pe_case(multires, P, cuda)
    assert x.data_ptr() % 16 == 12
    big = torch.full((P + PE_GUARD, packed.ep), 1234.0, dtype=torch.bfloat16, device=cuda)
    runtime.reset_launches()
    _pe_launcher(x, big[:P], packed.multires)()
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["fused_pe"] == 1
    got = big[:P]
    assert torch.equal(big[P:], torch.full_like(big[P:], 1234.0))
    n = 3 * (1 + 2 * multires)
    ref = pe_points_ref(packed, x, torch.float32)
    assert torch.equal(got[:, :3], x.to(torch.bfloat16))
    assert float((got[:, 3:n].float() - ref[:, 3:n]).abs().max()) <= 4e-3
    assert not got[:, n:].any()
    assert torch.equal(pe_points(packed, x), got)
    e = pe_points(packed, x)
    ed = point_view_embedding(packed, dirs, 1, torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(_forward_pe(packed, e, ed), _forward(packed, x[:, None, :], dirs)
                           .reshape(P, -1))


@pytest.mark.parametrize("multires", [6, 10])
def test_fused_pe_slow_path_phases(cuda, multires):
    """Every other point scaled so that its top phases pass sincosf's slow-path threshold
    (105615 rad), so each warp mixes points with and without the range branch: x lanes
    bit-equal to bf16(x), sin / cos within 4e-3 of fp32, pad zero, and K5 over its e bit
    for bit K1 (compared as bits: the huge inputs may drive raw to inf)."""
    P = 4095
    packed, x, dirs = _pe_case(multires, P, cuda)
    far = 400.0 * 2 ** (10 - multires)     # |x| up to 3800 * 2^(10 - multires)
    x = x * torch.where(torch.arange(P, device=cuda) % 2 == 0, 1.0, far)[:, None]
    assert float(x[1::2].abs().amax(dim=1).max()) * 2 ** (multires - 1) > 105615
    got = pe_points(packed, x)
    n = 3 * (1 + 2 * multires)
    ref = pe_points_ref(packed, x, torch.float32)
    assert torch.equal(got[:, :3], x.to(torch.bfloat16))
    assert float((got[:, 3:n].float() - ref[:, 3:n]).abs().max()) <= 4e-3
    assert not got[:, n:].any()
    ed = point_view_embedding(packed, dirs, 1, torch.bfloat16)
    with torch.no_grad():
        via_k7 = _forward_pe(packed, got, ed)
        k1 = _forward(packed, x[:, None, :].contiguous(), dirs).reshape(P, -1)
    assert torch.equal(via_k7.view(torch.int32), k1.view(torch.int32))


@pytest.mark.parametrize("multires, width", [(6, 40), (10, 72), (12, 80)])
def test_fused_pe_generic_widths(cuda, multires, width):
    """K7's generic path (every (multires, width) but the unrolled (10, 64): here a width
    that pack_params does not give the multires, or a multires past 10) against the plain
    embedding, and on the lanes they share bit for bit K7's output at the packed width."""
    P = 33869
    packed, x, _ = _pe_case(min(multires, 10), P, cuda)
    e = torch.empty((P, width), dtype=torch.bfloat16, device=cuda)
    _pe_launcher(x, e, multires)()
    n = 3 * (1 + 2 * multires)
    ref = _embedding(x, multires, width)
    assert torch.equal(e[:, :3], x.to(torch.bfloat16))
    assert float((e[:, 3:n].float() - ref[:, 3:n]).abs().max()) <= 4e-3
    assert not e[:, n:].any()
    if multires <= 10:
        assert torch.equal(e[:, :n], pe_points(packed, x)[:, :n])


def test_fused_pe_refuses_what_it_cannot_take(cuda):
    """A misaligned or strided e, or a width that is not a multiple of 8, raises before
    any launch."""
    packed, x, _ = _pe_case(10, 300, cuda)
    flat = torch.empty(300 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    runtime.reset_launches()
    with pytest.raises(ValueError):
        _pe_launcher(x, flat[1:].view(300, 64), 10)
    with pytest.raises(ValueError):
        _pe_launcher(x, torch.empty((300, 128), dtype=torch.bfloat16, device=cuda)[:, :64], 10)
    with pytest.raises(ValueError):
        _pe_launcher(x, torch.empty((300, 68), dtype=torch.bfloat16, device=cuda), 10)
    assert runtime.LAUNCHES["fused_pe"] == 0


@pytest.mark.parametrize("field, delta", [("tile", 32), ("tiles", 1), ("grid", 1),
                                          ("copy_bytes", 16), ("last_copy_bytes", 16),
                                          ("staging_bytes", -16)])
def test_fused_pe_refuses_a_plan_off_its_tiling(cuda, monkeypatch, field, delta):
    """K7's entry checks the plan it is launched with against the kernel's tiling: a plan
    off by a tile, a block or 16 bytes is refused (cudaErrorInvalidValue), counts no
    launch and writes nothing."""
    packed, x, _ = _pe_case(10, 300, cuda)
    plan = fused_mlp._pe_plan
    monkeypatch.setattr(fused_mlp, "_pe_plan",
                        lambda *a: {**plan(*a), field: plan(*a)[field] + delta})
    e = torch.zeros((300, packed.ep), dtype=torch.bfloat16, device=cuda)
    runtime.reset_launches()
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        _pe_launcher(x, e, 10)()
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["fused_pe"] == 0 and not e.any()


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_fwd_pe_matches_plain(cuda, shape):
    """K5 over K7's embedding against the fp32 plain query and its own bf16 plain
    version, and bit-equal to K1 on the same rays: both read the same bf16 embeddings,
    which one function (embed_rows) builds."""
    params, args, pts, dirs = _inputs(shape, cuda)
    for p in (params, rgb_stub_params(params)):
        packed = pack_params(p, *args)
        e, ed = _embedded(packed, pts, dirs)
        runtime.reset_launches()
        got = _forward_pe(packed, e, ed)
        torch.cuda.synchronize()
        assert runtime.LAUNCHES["fused_mlp_fwd_pe"] == 1 and runtime.LAUNCHES["fused_mlp_fwd"] == 0
        ref32 = fused_query_ref(packed, pts, dirs, torch.float32).reshape(-1, packed.c4)
        ref16 = fused_query_pe_ref(packed, e, ed, torch.bfloat16)
        assert got.shape == ref32.shape and torch.isfinite(got).all()
        scale = float(ref32.abs().max())
        assert float((got - ref32).abs().max()) <= 5e-3 * max(scale, 1.0)
        assert float((got - ref16).abs().max()) <= 1e-3 * max(scale, 1.0)
        via = fused_query(packed, pts, dirs, "outside")
        assert torch.equal(via.reshape(-1, packed.c4), got)
        assert torch.equal(_forward(packed, pts, dirs).reshape(-1, packed.c4), got)


@pytest.mark.parametrize("shape", SHAPES[:1])
def test_fused_mlp_fwd_pe_stub_sigma_exact(cuda, shape):
    params, args, pts, dirs = _inputs(shape, cuda, seed=1)
    packed = pack_params(params, *args)
    full = _forward_pe(packed, *_embedded(packed, pts, dirs))[:, 3]
    for stub in (sigma_stub_params(params), rgb_stub_params(params)):
        sp = pack_params(stub, *args)
        got = _forward_pe(sp, *_embedded(sp, pts, dirs))[:, 3]
        assert float((got - full).abs().max()) <= 1e-5 * max(float(full.abs().max()), 1.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_bwd_pe_matches_plain(cuda, shape):
    """K6 against its bf16 plain version over the same embeddings, block by packed
    layer, as K2's test: within 5e-3 of each block's scale."""
    params, args, pts, dirs = _inputs(shape, cuda)
    packed = pack_params(params, *args)
    e, ed = _embedded(packed, pts, dirs)
    g = _cotangent(packed, pts).reshape(-1, packed.c4)
    runtime.reset_launches()
    got = fused_query_pe_bwd(packed, e, ed, g)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["fused_mlp_bwd_pe"] == 1 and runtime.LAUNCHES["fused_mlp_bwd"] == 0
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()
    ref16 = fused_query_pe_bwd_ref(packed, e, ed, g, torch.bfloat16)
    for layer, err, scale in _block_errs(packed, got, ref16):
        assert err <= 5e-3 * max(scale, 1e-6), (layer, err, scale)


def test_fused_mlp_bwd_pe_wall_and_repeats(cuda):
    """pe_mode 'outside' through autograd: one launch each of K7, K5 and K6 (the
    backward reuses the forward's embeddings), an instance-only loss gives exactly zero
    trunk, rgb and density gradients, and two K6 calls are bit-identical."""
    params, args, pts, dirs = _inputs(SHAPES[0], cuda, seed=2)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    runtime.reset_launches()
    raw = fused_query(pack_params(params, *args), pts, dirs, "outside")
    raw[..., 4:].sum().backward()
    assert runtime.LAUNCHES == {"fused_mlp_fwd": 0, "fused_mlp_bwd": 0, "fused_mlp_fwd_kpe": 0,
                                "fused_mlp_bwd_kpe": 0, "fused_mlp_fwd_pe": 1,
                                "fused_mlp_bwd_pe": 1, "fused_pe": 1, "fused_render_weights": 0,
                                "fused_render_maps": 0, "head512": 0, "heads_fused": 0,
                                "assignment": 0}
    for k, v in params.items():
        if k.startswith(("trunk_", "rgb_", "density")):
            assert v.grad is None or int(torch.count_nonzero(v.grad)) == 0, k
    assert float(params["ins_out_w"].grad.abs().sum()) > 0

    params, args, pts, dirs = _inputs(SHAPES[2], cuda, seed=3)
    packed = pack_params(params, *args)
    e, ed = _embedded(packed, pts, dirs)
    g = _cotangent(packed, pts, seed=3).reshape(-1, packed.c4)
    first, second = fused_query_pe_bwd(packed, e, ed, g), fused_query_pe_bwd(packed, e, ed, g)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("pe_mode", ["kernel_t", "kernel", "outside"])
def test_training_forward_stashes_for_the_backward(cuda, pe_mode):
    """With gradients on, the forward kernel also writes the stash and the backward
    launches only its own kernels (one forward and one backward launch a query, and
    K7 under 'outside'): raw is bit for bit the no-grad forward's, and the autograd
    gradients into Packed.w / Packed.b are bit for bit those of the standalone backward
    entry, which runs the same training forward and then the backward."""
    params, args, pts, dirs = _inputs(SHAPES[0], cuda, seed=4)
    packed = pack_params(params, *args)
    g = _cotangent(packed, pts, seed=4)
    with torch.no_grad():
        want_raw = fused_query(packed, pts, dirs, pe_mode)
    pk = dataclasses.replace(packed, w=packed.w.detach().requires_grad_(True),
                             b=packed.b.detach().requires_grad_(True))
    runtime.reset_launches()
    raw = fused_query(pk, pts, dirs, pe_mode)
    dw, db = torch.autograd.grad(raw, [pk.w, pk.b], g)
    torch.cuda.synchronize()
    names = {"kernel_t": ("fused_mlp_fwd", "fused_mlp_bwd"),
             "kernel": ("fused_mlp_fwd_kpe", "fused_mlp_bwd_kpe"),
             "outside": ("fused_pe", "fused_mlp_fwd_pe", "fused_mlp_bwd_pe")}[pe_mode]
    assert runtime.LAUNCHES == {k: int(k in names) for k in runtime.COUNTED}
    assert torch.equal(raw, want_raw)
    if pe_mode == "kernel_t":
        alone = fused_query_bwd(packed, pts, dirs, g)
    elif pe_mode == "kernel":
        alone = fused_query_kpe_bwd(packed, *_flat(pts, dirs), g.reshape(-1, packed.c4))
    else:
        alone = fused_query_pe_bwd(packed, *_embedded(packed, pts, dirs), g.reshape(-1, packed.c4))
    assert torch.equal(dw, alone[0]) and torch.equal(db, alone[1])


# the forward template's persistent grid walks 128-point tiles, one CTA per SM: one
# point, less than a tile, a ragged last tile, and more tiles than the card's 132 SMs
# with a remainder (N rays x S samples)
RAGGED = [(1, 1), (4, 25), (8, 125), (11, 3079)]
MODES = ["kernel_t", "kernel", "outside"]


def _fwd_bf16_plain(mode, packed, pts, dirs):
    """The bf16 plain version of ``mode``'s forward kernel, raw [P, 4+C]: the same
    roundings as the kernel (K5's over K7's embedding)."""
    if mode == "kernel_t":
        return fused_query_ref(packed, pts, dirs, torch.bfloat16).reshape(-1, packed.c4)
    if mode == "kernel":
        return fused_query_kpe_ref(packed, *_flat(pts, dirs), torch.bfloat16)
    return fused_query_pe_ref(packed, *_embedded(packed, pts, dirs), torch.bfloat16)


def _check_fwd(mode, packed, pts, dirs):
    """``mode``'s forward kernel through fused_query against the fp32 plain query
    (5e-3 of the output scale) and its bf16 plain version (1e-3)."""
    with torch.no_grad():
        got = fused_query(packed, pts, dirs, mode).reshape(-1, packed.c4)
    torch.cuda.synchronize()
    ref32 = fused_query_ref(packed, pts, dirs, torch.float32).reshape(-1, packed.c4)
    scale = float(ref32.abs().max())
    assert got.shape == ref32.shape and torch.isfinite(got).all()
    assert float((got - ref32).abs().max()) <= 5e-3 * max(scale, 1.0)
    assert float((got - _fwd_bf16_plain(mode, packed, pts, dirs)).abs().max()) \
        <= 1e-3 * max(scale, 1.0)
    return got


@pytest.mark.parametrize("n_s", RAGGED)
@pytest.mark.parametrize("mode", MODES)
def test_forward_template_ragged_point_counts(cuda, mode, n_s):
    """K1, K3 and K5 at point counts around the persistent grid's tiles, flagship
    widths, each within the forward bars of its plain versions."""
    N, S = n_s
    params, args, pts, dirs = _inputs((10, 4, 8, 256, (4,), 32, N, S), cuda, seed=5)
    _check_fwd(mode, pack_params(params, *args), pts, dirs)


@pytest.mark.parametrize("variant", ["sigma_stub", "rgb_stub", "ins_num_6"])
@pytest.mark.parametrize("mode", MODES)
def test_forward_template_narrow_widths(cuda, mode, variant):
    """The narrow layers' instruction widths: the sigma stub (16-column head and
    output), the rgb stub (144-column head, 16-column output) and ins_num 6 (16-column
    output), at flagship trunk widths and a ragged point count."""
    ins = 6 if variant == "ins_num_6" else 32
    params, args, pts, dirs = _inputs((10, 4, 8, 256, (4,), ins, 37, 19), cuda, seed=6)
    if variant == "sigma_stub":
        params = sigma_stub_params(params)
    elif variant == "rgb_stub":
        params = rgb_stub_params(params)
    _check_fwd(mode, pack_params(params, *args), pts, dirs)


@pytest.mark.parametrize("mode", MODES)
def test_forward_template_stash_and_repeats_bit_exact(cuda, mode):
    """With more tiles than SMs: the training forward's raw (STASH) equals the no-grad
    forward's bit for bit, and two no-grad launches are bit-identical."""
    params, args, pts, dirs = _inputs((10, 4, 8, 256, (4,), 32, 11, 3079), cuda, seed=7)
    packed = pack_params(params, *args)
    with torch.no_grad():
        first = fused_query(packed, pts, dirs, mode)
        second = fused_query(packed, pts, dirs, mode)
    pk = dataclasses.replace(packed, w=packed.w.detach().requires_grad_(True),
                             b=packed.b.detach().requires_grad_(True))
    stashed = fused_query(pk, pts, dirs, mode)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(stashed.detach(), first)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_sweep_chunk_zero_viewdirs(cuda, mode):
    """The mesh sweep's launch: 65,536 grid points as 1,024 rays of 64 samples with
    zero view dirs through the sigma stub, one launch of the forward kernel (and one of
    K7 under ``outside``) and no other, within the forward bars; its sigma within 1e-5
    of the full model's."""
    from dmnerf_tpu_torch.tools.mesh_extract import DEFAULT_EXTENTS, build_grid

    params, args, _, _ = _inputs((10, 4, 8, 256, (4,), 32, 1, 1), cuda, seed=8)
    grid = torch.from_numpy(build_grid(np.eye(4), DEFAULT_EXTENTS, 41)).to(cuda)
    pts = grid[:65536].reshape(1024, 64, 3).contiguous()
    dirs = torch.zeros((1024, 3), device=cuda)
    stub = pack_params(sigma_stub_params(params), *args)
    runtime.reset_launches()
    with torch.no_grad():
        once = fused_query(stub, pts, dirs, mode).reshape(-1, stub.c4)
    torch.cuda.synchronize()
    want = {fused_mlp._FWD_NAME[mode]: 1, **({"fused_pe": 1} if mode == "outside" else {})}
    assert {k: v for k, v in runtime.LAUNCHES.items() if v} == want
    got = _check_fwd(mode, stub, pts, dirs)
    assert torch.equal(got, once)
    with torch.no_grad():
        full = fused_query(pack_params(params, *args), pts, dirs, mode)[..., 3].reshape(-1)
    assert float((got[:, 3] - full).abs().max()) <= 1e-5 * max(float(full.abs().max()), 1.0)


@pytest.mark.parametrize("n", [65536, 2 * 65536 + 1001])
def test_sigma_query_sweep_on_the_card(cuda, n):
    """make_sigma_query over a whole chunk and a ragged count (the tail padded): one K1
    launch a chunk, sigma within the forward bar of the plain PyTorch sweep."""
    from dmnerf_tpu_torch.configs import Config
    from dmnerf_tpu_torch.tools.mesh_extract import make_sigma_query

    params, _, _, _ = _inputs((10, 4, 8, 256, (4,), 32, 1, 1), cuda, seed=9)
    pts = torch.from_numpy(np.random.RandomState(9).uniform(-3.5, 3.5, (n, 3))
                           .astype(np.float32)).to(cuda)
    cfg = Config(ins_num=32)
    runtime.reset_launches()
    got = make_sigma_query(cfg)(params, pts)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["fused_mlp_fwd"] == -(-n // 65536)
    want = make_sigma_query(cfg.replace(use_pallas=False))(params, pts)
    assert got.shape == want.shape == (n,) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 5e-3 * max(float(want.abs().max()), 1.0)


# ---- K8c / K8f: the fused render passes (csrc/fused_render.cu) ----

def _rays(N, S, device, seed, near=1.0, far=8.0):
    """N rays from a camera at radius 4 looking at the origin (directions of varied
    length, the last one zero, as a padding ray), S sorted depths between near and far."""
    rng = np.random.RandomState(seed)
    o = np.tile(np.float32([4.0, 0.0, 1.6]), (N, 1)).astype(np.float32)
    d = (-o + rng.randn(N, 3).astype(np.float32) * 0.5) * rng.uniform(0.2, 0.3, (N, 1))
    d[-1] = 0.0
    z = np.sort(rng.uniform(near, far, (N, S)), -1).astype(np.float32)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (o, d, z)]


# (N rays, S samples): the flagship's coarse and fine chunks, a ragged count of each, and
# sample counts whose spans are 1 tile of 4 rays, 3 tiles of 4 rays and 19 tiles of 128
RENDER_SHAPES = [(2048, 64), (2048, 192), (37, 64), (37, 192), (300, 32), (41, 96), (130, 19)]


@pytest.mark.parametrize("weights_only", [True, False])
@pytest.mark.parametrize("n_s", RENDER_SHAPES)
def test_fused_render_matches_plain(cuda, n_s, weights_only):
    """K8c (the sigma stub's weights) and K8f (the full model's maps) at flagship widths
    against their bf16 plain versions (the same roundings) within 5e-3 * max(scale, 1);
    one launch of the pass's kernel and no other; two launches bit-identical."""
    from dmnerf_tpu_torch.kernels.fused_render import fused_render, fused_render_ref

    N, S = n_s
    params, args, _, _ = _inputs((10, 4, 8, 256, (4,), 32, 1, 1), cuda, seed=10)
    packed = pack_params(sigma_stub_params(params) if weights_only else params, *args)
    o, d, z = _rays(N, S, cuda, seed=N + S)
    runtime.reset_launches()
    with torch.no_grad():
        got = fused_render(packed, o, d, z, weights_only)
        again = fused_render(packed, o, d, z, weights_only)
    torch.cuda.synchronize()
    name = "fused_render_weights" if weights_only else "fused_render_maps"
    assert {k: v for k, v in runtime.LAUNCHES.items() if v} == {name: 2}
    assert torch.equal(got, again)
    assert got.shape == ((N, S) if weights_only else (N, packed.c4)) and torch.isfinite(got).all()
    want = fused_render_ref(packed, o, d, z, weights_only, torch.bfloat16)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 5e-3 * max(scale, 1.0)


@pytest.mark.parametrize("weights_only", [True, False])
def test_fused_render_is_k1_then_the_compositing(cuda, weights_only):
    """The points K8 forms and embeds are K1's: K8c / K8f against K1 on the points the
    plain path forms (o + d * z) composited in PyTorch, within 1e-5 * max(scale, 1) (raw
    is the same; only the order of the compositing's fp32 sums differs)."""
    from dmnerf_tpu_torch.core.compositor import composite, composite_maps
    from dmnerf_tpu_torch.kernels.fused_render import fused_render

    params, args, _, _ = _inputs((10, 4, 8, 256, (4,), 32, 1, 1), cuda, seed=11)
    packed = pack_params(sigma_stub_params(params) if weights_only else params, *args)
    o, d, z = _rays(517, 192, cuda, seed=11)
    df = torch.where(torch.sum(d * d, -1, keepdim=True) > 0, d, torch.ones_like(d))
    with torch.no_grad():
        got = fused_render(packed, o, d, z, weights_only)
        raw = fused_query(packed, o[:, None, :] + df[:, None, :] * z[..., None],
                          df / torch.linalg.norm(df, dim=-1, keepdim=True))
    if weights_only:
        want = composite(raw, z, df).weights
    else:
        rgb, ins, depth = composite_maps(raw, z, df, keep_air=True)
        want = torch.cat([rgb, depth[:, None], ins], -1)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * max(scale, 1.0)


def test_fused_renderer_on_the_card(cuda):
    """make_fused_renderer over a ragged ray count (two chunks of 2048, the last partial):
    2 launches a chunk (one K8c, one K8f) and no K1, against make_image_renderer (K1)
    with the same weights: rgb PSNR >= 40 dB, at most 1 % of the rays on another label."""
    from dmnerf_tpu_torch.configs import Config
    from dmnerf_tpu_torch.render.fused_renderer import make_fused_renderer
    from dmnerf_tpu_torch.render.renderer import make_image_renderer

    cfg = Config(ins_num=32, near=1.0, far=8.0)
    pc, _, _, _ = _inputs((10, 4, 8, 256, (4,), 32, 1, 1), cuda, seed=12)
    pf, _, _, _ = _inputs((10, 4, 8, 256, (4,), 32, 1, 1), cuda, seed=13)
    o, d, _ = _rays(3000, 1, cuda, seed=12)
    d[-1] = d[0]
    runtime.reset_launches()
    got = make_fused_renderer(cfg)(pc, pf, o, d)
    torch.cuda.synchronize()
    assert {k: v for k, v in runtime.LAUNCHES.items() if v} == \
        {"fused_render_weights": 2, "fused_render_maps": 2}
    want = make_image_renderer(cfg)(pc, pf, o, d)
    mse = float(torch.mean((got["rgb"].double() - want["rgb"].double()) ** 2))
    assert mse == 0 or -10 * np.log10(mse) >= 40
    assert float((got["ins"].argmax(-1) != want["ins"].argmax(-1)).float().mean()) <= 0.01


# ---- K9, K10: the head probes (kernels/head_probes.py) ----

H512_P, HEADS_P = 786_432, 589_824    # the probes' point counts
RAGGED_P = 3 * 128 * 66 + 77          # past one walk of the persistent grid, a partial tile


def _h512_inputs(mode, P, device, seed=0):
    """The probe's inputs (head512_probe.py:98-108, 74-82): x [P, 256] normals and
    weights of normals * 0.05, all bf16."""
    from dmnerf_tpu_torch.kernels.head_probes import WIDTH

    g = torch.Generator(device).manual_seed(seed)
    rnd = lambda *s, k=1.0: (torch.randn(*s, generator=g, device=device) * k).to(torch.bfloat16)  # noqa: E731
    x = rnd(P, WIDTH)
    ws = [rnd(WIDTH, WIDTH, k=0.05) for _ in range(8)] + [rnd(WIDTH, 2 * WIDTH + (mode == "a"), k=0.05)]
    return x, ws, rnd(1, WIDTH, k=0.05) if mode in "bd" else None


def _heads_inputs(P, device, seed=0):
    """K10's inputs: h [P, 256] and edT [27, P] normals in bf16, and the operands of
    seeded flagship parameters (ins_num 32) through heads_operands."""
    from dmnerf_tpu_torch.kernels.head_probes import heads_operands

    params = init_dm_nerf(ins_num=32, generator=torch.Generator().manual_seed(seed), device=device)
    ops = heads_operands(params, 4)
    g = torch.Generator(device).manual_seed(seed)
    h = torch.randn(P, 256, generator=g, device=device).to(torch.bfloat16)
    edT = torch.randn(27, P, generator=g, device=device).to(torch.bfloat16)
    return [h, edT] + [ops[k] for k in ("m1", "b1", "wrh2", "m2", "b2")]


def _held(got, ref, *args, **kw):
    """The kernel against ``ref``'s fp32 plain version (5e-3 * max(scale, 1)) and its bf16
    one with exact sums (5e-3 of the scale, or twice PyTorch's own order floor where that
    is above: head_probes.compare)."""
    from dmnerf_tpu_torch.kernels.head_probes import compare

    r = compare(got, *(ref(*args, **kw, act_dtype=a, sum_dtype=s) for a, s in (
        (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
        (torch.bfloat16, torch.float64))))
    assert r["ok"], r


@pytest.mark.parametrize("P", [H512_P, RAGGED_P])
@pytest.mark.parametrize("mode", ["a", "b", "c", "d"])
def test_head512_matches_plain(cuda, mode, P):
    from dmnerf_tpu_torch.kernels.head_probes import head512, head512_ref

    x, ws, wd = _h512_inputs(mode, P, cuda)
    runtime.reset_launches()
    got = head512(mode, x, ws, wd)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["head512"] == 1 and got.shape == (P, 32)
    _held(got, head512_ref, mode, x, ws, wd)


@pytest.mark.parametrize("mode", ["a", "b", "c", "d"])
def test_head512_computes_every_column(cuda, mode):
    """store_all: every head column (and sigma) against the plain version's."""
    from dmnerf_tpu_torch.kernels.head_probes import head512, head512_ref

    x, ws, wd = _h512_inputs(mode, RAGGED_P, cuda, seed=1)
    got = head512(mode, x, ws, wd, store_all=True)
    assert got.shape == (RAGGED_P, 512 + (mode != "c"))
    _held(got, head512_ref, mode, x, ws, wd, store_all=True)


@pytest.mark.parametrize("P", [HEADS_P, RAGGED_P])
@pytest.mark.parametrize("split", [False, True])
def test_heads_fused_matches_plain(cuda, split, P):
    from dmnerf_tpu_torch.kernels.head_probes import heads_fused, heads_fused_ref

    args = _heads_inputs(P, cuda)
    runtime.reset_launches()
    got = heads_fused(*args, split=split)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["heads_fused"] == 1 and got.shape == (P, 1)
    _held(got, lambda *a, **k: heads_fused_ref(*a, **k)[0], *args, split=split)


@pytest.mark.parametrize("split", [False, True])
def test_heads_fused_computes_every_column(cuda, split):
    """store_all: the [P, 4 + C] columns before the row sum against the plain version's."""
    from dmnerf_tpu_torch.kernels.head_probes import heads_fused, heads_fused_ref

    args = _heads_inputs(RAGGED_P, cuda, seed=1)
    got = heads_fused(*args, split=split, store_all=True)
    assert got.shape == (RAGGED_P, 37)
    _held(got, lambda *a, **k: heads_fused_ref(*a, **k)[1], *args, split=split)


def test_head_probes_repeat_bit_identical(cuda):
    from dmnerf_tpu_torch.kernels.head_probes import head512, heads_fused

    for mode in ("a", "b", "c", "d"):
        x, ws, wd = _h512_inputs(mode, RAGGED_P, cuda, seed=2)
        assert torch.equal(head512(mode, x, ws, wd), head512(mode, x, ws, wd))
    args = _heads_inputs(RAGGED_P, cuda, seed=2)
    for split in (False, True):
        assert torch.equal(heads_fused(*args, split=split), heads_fused(*args, split=split))


# ---- the consumers' schedules (csrc/fused_mlp_fwd.cuh Sched): lockstep, pipelined ----

@pytest.mark.parametrize("n_s", [(2048, 192), (2048, 64), (37, 192), (130, 19)])
def test_fused_render_maps_schedules_bit_equal(cuda, n_s):
    """K8f with its products pipelined gives lockstep's bits, at the fine and the coarse
    render chunk's shapes and at ragged ones; each schedule's repeats are bit-identical;
    the wrapper's call is its path's schedule's launch."""
    from dmnerf_tpu_torch.kernels import fused_render as fr

    N, S = n_s
    params, args, _, _ = _inputs((10, 4, 8, 256, (4,), 32, 1, 1), cuda, seed=14)
    packed = pack_params(params, *args)
    o, d, z = _rays(N, S, cuda, seed=N + S + 1)
    d, edr = fr.ray_table(packed, d)
    with torch.no_grad():
        outs = {sc: [fr._launch_render(packed, o, d, z, edr, False, sc) for _ in range(2)]
                for sc in (LOCKSTEP, PIPELINED)}
        path = fr.fused_render(packed, o, d, z, False, (d, edr))
    torch.cuda.synchronize()
    for sc, (a, b) in outs.items():
        assert torch.equal(a, b), sc
    assert torch.equal(outs[PIPELINED][0], outs[LOCKSTEP][0])
    assert torch.equal(path, outs[fr.MAPS_SCHEDULE][0])


@pytest.mark.parametrize("P", [HEADS_P, RAGGED_P])
@pytest.mark.parametrize("split", [False, True])
def test_heads_fused_schedules_bit_equal(cuda, split, P):
    """K10 with its products pipelined gives lockstep's row sums and store_all columns,
    bit for bit; repeats bit-identical."""
    from dmnerf_tpu_torch.kernels import head_probes as hpr

    args = _heads_inputs(P, cuda, seed=3)
    for store_all in (False, True):
        ops = hpr.heads_fused_operands(*args[2:], split=split, store_all=store_all)
        outs = {sc: [hpr._launch_probe("heads_fused", ops, args[0], args[1], sc)
                     for _ in range(2)] for sc in (LOCKSTEP, PIPELINED)}
        torch.cuda.synchronize()
        for sc, (a, b) in outs.items():
            assert torch.equal(a, b), sc
        assert torch.equal(outs[PIPELINED][0], outs[LOCKSTEP][0])


def test_forward_template_outputs_unchanged(cuda):
    """K1, K3 and K5 at the fine render chunk of scripts/fwd_anatomy_torch.py --k7 hash to
    the digest they had before the head probes joined their template (854cbb6195d4a8e8,
    H100 80GB HBM3)."""
    import importlib.util
    import os

    from dmnerf_tpu_torch.configs import load_config
    from dmnerf_tpu_torch.test import init_params

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = load_config(os.path.join(repo, "configs", "train", "dmsr", "study.txt"), ins_num=32,
                      near=1.0, far=8.0)
    _, pf = init_params(cfg, cuda)
    packed = pack_params(pf, cfg.multires, cfg.multires_views, cfg.netdepth, tuple(cfg.skips))
    pts, dirs = cs._points(2048, 192, 1.0, 8.0, torch.Generator().manual_seed(cs.SEED + 3), cuda)
    with torch.no_grad():
        got = {mode: cs.digest(fused_query(packed, pts, dirs, mode))
               for mode in ("kernel_t", "kernel", "outside")}
    assert got == dict.fromkeys(got, "854cbb6195d4a8e8")


def _chip_smoke():
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("n", [1, 2, 5, 31, 32, 33, 100])
def test_assignment_matches_plain(cuda, n):
    """K11's col4row equals its plain version's (the JAX solver's) on seeded [2, n, n]
    batches: uniform costs, integer costs with ties, NaN and +-inf entries, wide costs,
    every valid count from 0 to n; one launch a batch."""
    from dmnerf_tpu_torch.kernels.assignment import masked_assignment_ref
    from dmnerf_tpu_torch.objfield.hungarian import masked_assignment

    cases = _chip_smoke()._assignment_cases(n, 4 * (n + 1), seed=n)
    runtime.reset_launches()
    for c, valid in cases:
        cost = torch.from_numpy(c)
        got = masked_assignment(cost.to(cuda), torch.tensor(valid, device=cuda))
        assert torch.equal(got.cpu(), masked_assignment_ref(cost, valid)), (n, valid)
    assert runtime.LAUNCHES["assignment"] == len(cases)


def _adversarial_batch(n, seed=0):
    """[6, n, n] costs a tie-breaking or non-finite fault would show on: -0 and +0 ties,
    all-equal costs, an all-NaN row, +-inf columns, integer ties with a NaN row and an
    inf column, and a -inf row; with the valid counts that reach those rows."""
    rng = np.random.RandomState(seed)
    c = np.zeros((6, n, n), np.float32)
    c[0] = np.where(rng.rand(n, n) < 0.5, np.float32(-0.0), np.float32(0.0))
    c[1] = 0.25
    c[2] = rng.randint(0, 3, (n, n))
    c[2, n // 2] = np.nan
    c[3] = rng.rand(n, n)
    c[3][:, rng.rand(n) < 0.3] = np.inf
    c[3][:, rng.rand(n) < 0.3] = -np.inf
    c[4] = rng.randint(0, 2, (n, n))
    c[4, 0] = np.nan
    c[4][:, n - 1] = np.inf
    c[5] = rng.rand(n, n)
    c[5, n - 1] = -np.inf
    valid = np.array([n, n, n // 2 + 1, n, max(n - 1, 1), n], np.int32)
    return c, valid


@pytest.mark.parametrize("n", [2, 5, 31, 32, 33])
def test_assignment_adversarial_batch(cuda, n):
    """-0/+0 ties, all-equal costs, an all-NaN row and +-inf columns: K11's col4row is its
    plain version's, in one launch of the whole batch."""
    from dmnerf_tpu_torch.kernels.assignment import assignment, masked_assignment_ref

    c, valid = _adversarial_batch(n, seed=n)
    got = assignment(torch.from_numpy(c).to(cuda), torch.from_numpy(valid).to(cuda))
    want = masked_assignment_ref(torch.from_numpy(c), torch.from_numpy(valid))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n", [1, 2, 5, 31, 32])
def test_assignment_warp_design_equals_block_design(cuda, n):
    """At n <= 32 the warp design (the entry's there) gives the block design's col4row on
    the seeded batches and the adversarial one."""
    from dmnerf_tpu_torch.kernels.assignment import assignment, assignment_block

    cases = [(c, np.full(2, v, np.int32)) for c, v in
             _chip_smoke()._assignment_cases(n, 2 * (n + 1), seed=100 + n)]
    cases.append(_adversarial_batch(n, seed=7))
    for c, valid in cases:
        cost, val = torch.from_numpy(c).to(cuda), torch.from_numpy(valid).to(cuda)
        assert torch.equal(assignment(cost, val), assignment_block(cost, val)), (n, valid)


def test_assignment_repeats_bit_identical(cuda):
    """Ten launches on the same [2, 32, 32] and [2, 33, 33] batches give the same
    col4row."""
    from dmnerf_tpu_torch.kernels.assignment import assignment

    for n in (32, 33):
        for c, valid in _chip_smoke()._assignment_cases(n, 8, seed=3):
            cost = torch.from_numpy(c).to(cuda)
            val = torch.full((2,), valid, dtype=torch.int32, device=cuda)
            outs = [assignment(cost, val) for _ in range(10)]
            assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_assignment_key_probe_matches_argmin_key(cuda):
    """K11's order key and warp argmin on the card (key_probe) against argmin_key and
    torch.argmin: NaN of either sign and payload, +-inf, -0/+0, subnormals, all-inf,
    all-NaN, at 1 to 32 lanes with the padding lanes' key."""
    from dmnerf_tpu_torch.kernels.assignment import argmin_key, key_probe

    rng = np.random.RandomState(0)
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0],
                        np.float32)
    payload_nans = (np.uint32(0x7F800000) | rng.randint(1, 1 << 23, 16).astype(np.uint32)
                    | (rng.randint(0, 2, 16).astype(np.uint32) << 31)).view(np.float32)
    pool = np.concatenate([specials, payload_nans, rng.randn(16).astype(np.float32)])
    for n in (1, 2, 5, 31, 32):
        x = rng.choice(pool, (256, n)).astype(np.float32)
        x[0], x[1] = np.inf, np.nan
        keys, idx = key_probe(torch.from_numpy(x).to(cuda))
        want = argmin_key(torch.from_numpy(x), 32)
        assert torch.equal(keys.cpu(), want), n
        assert torch.equal(idx.cpu(), torch.argmin(want, -1)), n
        assert torch.equal(idx.cpu(), torch.argmin(torch.from_numpy(x), -1)), n


def test_assignment_chain_probe_launches(cuda):
    """The chain floor's probe runs both modes (not counted as K11's launches)."""
    from dmnerf_tpu_torch.kernels.assignment import chain_probe

    ring = torch.roll(torch.arange(4096, dtype=torch.int32, device=cuda), -1)
    out = torch.zeros(1, dtype=torch.int32, device=cuda)
    runtime.reset_launches()
    chain_probe(0, 100, None, out)
    chain_probe(1, 100, ring, out)
    torch.cuda.synchronize()
    assert int(out) == 100 and runtime.LAUNCHES["assignment"] == 0


def _pack_setup(cuda, P=3, **kw):
    from dmnerf_tpu_torch.configs import Config
    from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene
    from dmnerf_tpu_torch.train import make_sampler

    scene = build_dmsr_scene(n_train=4, n_test=1, H=32, W=32, n_objects=3, ins_num=8, seed=0)
    cfg = Config(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,), N_samples=16,
                 N_importance=16, N_train=256, near=2.0, far=7.0, ins_num=8, lrate=5e-3,
                 perturb=1.0, penalize=True, tolerance=0.05, deta_w=0.05, steps_per_dispatch=P,
                 i_print=P, **kw)
    sampler, n_ins = make_sampler(cfg, scene, cuda)

    def start():
        from dmnerf_tpu_torch.render.trainstep import create_train_state
        from dmnerf_tpu_torch.test import init_params

        return (create_train_state(cfg, *init_params(cfg, cuda)),
                torch.Generator().manual_seed(1), torch.Generator(device=cuda).manual_seed(2))
    return cfg, sampler, n_ins, start


@pytest.mark.parametrize("pe_mode", [None, "outside"])
def test_graph_replay_equals_eager_steps(cuda, pe_mode):
    """Two packs of 3 steps (one CUDA graph replay each) against 6 eager steps from the
    same state and draws: parameters, Adam's moments and counts and every aux, bit for
    bit; the capture counts no launch that did not run."""
    from dmnerf_tpu_torch.render.packing import StepRunner
    from dmnerf_tpu_torch.render.trainstep import make_train_step
    from dmnerf_tpu_torch.train import make_packed_steps

    cs = _chip_smoke()
    cfg, sampler, n_ins, start = _pack_setup(cuda, pallas_pe_mode=pe_mode)
    st_u, gb, gs = start()
    single = StepRunner(cfg, sampler, make_train_step(cfg, N_ins=n_ins), cuda, 1)
    eager = torch.cat([cs._aux_rows(single(st_u, gb, gs)) for _ in range(6)])
    st_p, gb, gs = start()
    packed, P = make_packed_steps(cfg, sampler, n_ins, cuda)
    runtime.reset_launches()
    packs = torch.cat([cs._aux_rows(packed(st_p, gb, gs)) for _ in range(2)])
    torch.cuda.synchronize()
    fwd = "fused_mlp_fwd_pe" if pe_mode == "outside" else "fused_mlp_fwd"
    assert runtime.LAUNCHES[fwd] == 2 * 2 and runtime.LAUNCHES["assignment"] == 2   # warm-up only
    assert torch.equal(eager.view(torch.int32), packs.view(torch.int32))
    assert not cs._state_diffs(st_u, st_p)


def test_a_pack_copies_nothing_to_the_host_and_launches_each_kernel_per_step(cuda):
    """One pack under torch.profiler: one cudaGraphLaunch, no device-to-host copy, 2P
    forward launches (the training forward), 2P bwd_data launches and P of K11."""
    from dmnerf_tpu_torch.train import make_packed_steps

    cs = _chip_smoke()
    cfg, sampler, n_ins, start = _pack_setup(cuda, P=4)
    st, gb, gs = start()
    packed, P = make_packed_steps(cfg, sampler, n_ins, cuda)
    packed(st, gb, gs)
    prof = cs.profile_calls(lambda: packed(st, gb, gs))
    k = prof["kernels"]
    assert prof["api"].get("cudaGraphLaunch", 0) == 1
    assert cs._count(prof["copies"], "DtoH") == 0
    assert (cs._count(k, "fused_mlp_fwd_kernel"), cs._count(k, "bwd_data_kernel"),
            cs._count(k, "assignment_kernel")) == (2 * P, 2 * P, P)
