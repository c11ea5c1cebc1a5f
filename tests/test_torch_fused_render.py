"""dmnerf_tpu_torch.kernels.fused_render and render.fused_renderer on the CPU: the fused
render passes' plain version against the JAX probe's Pallas kernel
(scripts/dev/fused_render_probe.py, interpret mode) and against the JAX query and
compositor at 2e-5, the fused renderer against both packages' image renderers at 1e-4,
the host plan of the kernel's ray-aligned walk and the kernel's compositing read by a
plain interpreter, and the guards: no fallback from a card to the plain version.

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py."""

import importlib.util
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.core import compositor as jcomp  # noqa: E402
from dmnerf_tpu.core.mlp import init_dm_nerf, sigma_stub_params  # noqa: E402
from dmnerf_tpu.core.pipeline import make_xla_query_fn  # noqa: E402
from dmnerf_tpu.core.rays import rays_from_K as j_rays_from_K  # noqa: E402
from dmnerf_tpu.render import renderer as jren  # noqa: E402
from dmnerf_tpu_torch.configs import Config as TConfig  # noqa: E402
from dmnerf_tpu_torch.core import mlp as tmlp  # noqa: E402
from dmnerf_tpu_torch.core.compositor import composite, composite_maps  # noqa: E402
from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene  # noqa: E402
from dmnerf_tpu_torch.kernels import fused_mlp as tfm  # noqa: E402
from dmnerf_tpu_torch.kernels import fused_render as tfr  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402
from dmnerf_tpu_torch.render import renderer as tren  # noqa: E402
from dmnerf_tpu_torch.render.fused_renderer import make_fused_renderer  # noqa: E402

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=2e-5)
RTOL = dict(atol=1e-4, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [
    # (multires, multires_views, D, W, skips, ins_num), as tests/test_torch_kernels.py
    (4, 2, 2, 32, (0,), 4),
    (10, 4, 8, 64, (4,), 8),
    (6, 3, 5, 32, (1, 3), 4),
]


def _probe():
    """scripts/dev/fused_render_probe.py as a module (it has no package)."""
    spec = importlib.util.spec_from_file_location(
        "fused_render_probe", os.path.join(REPO, "scripts", "dev", "fused_render_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _setup(multires, multires_views, D, W, skips, ins_num, N=16, S=8, seed=0):
    """JAX params, their torch copy and rays between near 2 and far 6: origins around
    the origin, directions of varied length, one of them zero (a padding ray), sorted
    depths."""
    jp = init_dm_nerf(jax.random.PRNGKey(seed), ins_num=ins_num, D=D, W=W,
                      input_ch_pts=3 * (1 + 2 * multires),
                      input_ch_views=3 * (1 + 2 * multires_views), skips=skips)
    tp = tmlp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    rng = np.random.RandomState(seed)
    o = (rng.randn(N, 3) * 0.3).astype(np.float32)
    d = (rng.randn(N, 3) * rng.uniform(0.5, 1.5, (N, 1))).astype(np.float32)
    d[-1] = 0.0
    z = np.sort(rng.uniform(2.0, 6.0, (N, S)), axis=-1).astype(np.float32)
    return jp, tp, o, d, z


def _fixed(d):
    return np.where(np.sum(d * d, -1, keepdims=True) > 0, d, np.ones_like(d))


@pytest.mark.parametrize("case", CASES)
def test_weights_pass_matches_the_probe_kernel(case):
    """The coarse pass (weights_only) of the plain version over the sigma stub vs the
    probe's own Pallas kernel, weights_only, fp32 (interpret mode), at 2e-5; and vs the
    port's query + composite."""
    mr, mrv, D, W, skips, ins = case
    jp, tp, o, d, z = _setup(*case)
    run = _probe().make_fused_pass(None, mr, mrv, D, skips, R=8, weights_only=True,
                                   interpret=True, cache_dtype=None)
    want = np.asarray(run(sigma_stub_params(jp), jnp.asarray(o), jnp.asarray(d), jnp.asarray(z)))
    packed = tfm.pack_params(tmlp.sigma_stub_params(tp), mr, mrv, D, skips)
    got = tfr.fused_render_ref(packed, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(z), True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    df = torch.from_numpy(_fixed(d))
    pts = torch.from_numpy(o)[:, None, :] + df[:, None, :] * torch.from_numpy(z)[..., None]
    raw = tfm.fused_query_ref(packed, pts, df / torch.linalg.norm(df, dim=-1, keepdim=True))
    assert torch.equal(got, composite(raw, torch.from_numpy(z), df).weights)


@pytest.mark.parametrize("case", CASES)
def test_maps_pass_matches_jax_query_and_composite_maps(case):
    """The fine pass (maps, air kept) of the plain version vs the JAX XLA query +
    composite_maps(keep_air=True), the function the probe's kernel computes, at 2e-5;
    and its own rows against the port's composite_maps."""
    mr, mrv, D, W, skips, ins = case
    jp, tp, o, d, z = _setup(*case, seed=1)
    df = _fixed(d)
    vd = df / np.linalg.norm(df, axis=-1, keepdims=True)
    pts = o[:, None, :] + df[:, None, :] * z[..., None]
    raw = make_xla_query_fn(mr, mrv, D, skips)(jp, jnp.asarray(pts), jnp.asarray(vd))
    rgb, ins_map, depth = jcomp.composite_maps(raw, jnp.asarray(z), jnp.asarray(df), keep_air=True)
    want = np.concatenate([np.asarray(rgb), np.asarray(depth)[:, None], np.asarray(ins_map)], -1)
    packed = tfm.pack_params(tp, mr, mrv, D, skips)
    got = tfr.fused_render_ref(packed, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(z), False)
    assert got.shape == (16, 4 + ins + 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dt = torch.from_numpy(df)
    pts_t = torch.from_numpy(o)[:, None, :] + dt[:, None, :] * torch.from_numpy(z)[..., None]
    raw_t = tfm.fused_query_ref(packed, pts_t, dt / torch.linalg.norm(dt, dim=-1, keepdim=True))
    t_rgb, t_ins, t_depth = composite_maps(raw_t, torch.from_numpy(z), dt, keep_air=True)
    assert torch.equal(got, torch.cat([t_rgb, t_depth[:, None], t_ins], -1))


def test_the_probe_maps_pass_fails_on_the_fused_head():
    """A fault of the JAX probe, recorded: its maps pass gives _forward_core the rgb and
    ins FEATURE widths (fused_render_probe.py:111-112) where the fused head takes the
    HIDDEN widths (rgb_hid_w / ins_hid_w, dmnerf_tpu/kernels/fused_mlp.py:788), so at
    the flagship layout (feature W, hidden W/2) it cannot run; the port's maps pass
    takes the hidden widths from the packed layout and matches composite_maps above."""
    mr, mrv, D, W, skips, ins = CASES[0]
    jp, _, o, d, z = _setup(*CASES[0])
    assert jp["rgb_feat_w"].shape[1] != jp["rgb_hid_w"].shape[1]
    run = _probe().make_fused_pass(None, mr, mrv, D, skips, R=8, weights_only=False,
                                   interpret=True, cache_dtype=None)
    with pytest.raises(TypeError, match="incompatible shapes"):
        run(jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(z))


# ---- the renderer ----

KW = dict(N_samples=8, N_importance=8, N_test=64, near=1.0, far=8.0, netdepth=3, netwidth=32,
          multires=10, multires_views=4, skips=(1,), ins_num=6)


@pytest.fixture(scope="module")
def scene():
    return build_dmsr_scene(n_train=1, n_test=2, H=12, W=10, n_objects=3, ins_num=KW["ins_num"])


def _params(seed):
    jp = init_dm_nerf(jax.random.PRNGKey(seed), ins_num=KW["ins_num"], D=KW["netdepth"],
                      W=KW["netwidth"], skips=KW["skips"])
    return jp, tmlp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


@pytest.mark.parametrize("n_rays", [120, 64])
def test_fused_renderer_matches_both_image_renderers(scene, n_rays):
    """make_fused_renderer (K8c, sample_pdf, K8f per chunk; here their plain versions)
    vs the port's make_image_renderer and the JAX package's, at 1e-4 (a round-off can
    move a sample_pdf rank): 120 rays are two chunks of 64, the last ragged; 64 one."""
    (jpc, tpc), (jpf, tpf) = _params(0), _params(1)
    H, W, K = scene.hwk
    ro, rd = j_rays_from_K(H, W, jnp.asarray(K), jnp.asarray(scene.poses[-1]))
    ro, rd = np.array(ro).reshape(-1, 3)[:n_rays], np.array(rd).reshape(-1, 3)[:n_rays]
    want = jren.make_image_renderer(JConfig(**KW))(jpc, jpf, jnp.asarray(ro), jnp.asarray(rd))
    runtime.reset_launches()
    got = make_fused_renderer(TConfig(**KW))(tpc, tpf, torch.from_numpy(ro), torch.from_numpy(rd))
    assert not any(runtime.LAUNCHES.values())
    port = tren.make_image_renderer(TConfig(**KW))(tpc, tpf, torch.from_numpy(ro),
                                                   torch.from_numpy(rd))
    assert set(got) == set(want) == set(port) == {"rgb", "ins", "depth"}
    for k in want:
        assert got[k].shape == port[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **RTOL)
        np.testing.assert_allclose(got[k].numpy(), port[k].numpy(), err_msg=k, **RTOL)


# ---- the host plan and the kernel's compositing, read by a plain interpreter ----

def _render_walk(plan, clusters):
    """The tiles each block walks, in order, as the kernel's loops run them with
    ``clusters`` clusters of two blocks: block 2 c + rank takes, for q = c, c +
    clusters, ... while 2 q < spans, the tiles of span 2 q + rank. Tiles at or past
    ``plan['tiles']`` are walked on zeros and store nothing."""
    return [[(2 * q + rank) * plan["span"] + j
             for q in range(c, -(-plan["spans"] // 2), clusters) for j in range(plan["span"])]
            for c in range(clusters) for rank in range(2)]


def _interpret_render(plan, clusters, sigma, z, d, vals, weights_only):
    """A plain reading of the kernel's walk and compositing (csrc/fused_mlp_fwd.cuh
    composite_tile) in fp32: each block walks its tiles (``_render_walk``) in order;
    a tile's rows get alpha and log(1 - alpha); one warp scans them, lane l holding rows
    4 l .. 4 l + 3 (sums since the lane's last ray start, then a segmented
    Hillis-Steele scan over the lanes' open sums, the log-transmittance carried from
    the block's tile before); the weights; then (maps) one sum a column over each ray's
    rows in order, carried across tiles. Returns the output (NaN where nothing was
    stored) and the count of stores of each element."""
    N, S = z.shape
    P = N * S
    f32 = np.float32
    sig, zf = sigma.reshape(-1).astype(f32), z.reshape(-1).astype(f32)
    dn = np.sqrt((d.astype(f32) ** 2).sum(-1)).astype(f32)
    C4 = vals.shape[-1]
    out = np.full((N, S) if weights_only else (N, C4), np.nan, f32)
    writes = np.zeros(out.shape, np.int64)
    for walk in _render_walk(plan, clusters):
        carry, csum = f32(0), np.zeros(C4, f32)
        for tile in walk:
            p0 = tile * plan["tile"]
            s0 = p0 % S
            alpha, lg, w = (np.zeros(128, f32) for _ in range(3))
            for r in range(128):
                p = p0 + r
                if p < P:
                    dist = f32((zf[p + 1] - zf[p]) if (p % S) + 1 < S else f32(1e10)) * dn[p // S]
                    alpha[r] = f32(1) - np.exp(-max(sig[p], f32(0)) * dist, dtype=f32)
                    lg[r] = np.log(max(f32(1) - alpha[r], f32(1e-10)), dtype=f32)
            ex, run, head = np.zeros((32, 4), f32), np.zeros(32, f32), np.zeros((32, 4), bool)
            for lane in range(32):
                for k in range(4):
                    r = 4 * lane + k
                    if (s0 + r) % S == 0:
                        run[lane], head[lane, k] = 0, True
                    ex[lane, k] = run[lane]
                    run[lane] += lg[r]
            sc, f = run.copy(), head.any(1)
            off = 1
            while off < 32:
                so, fo = np.roll(sc, off), np.roll(f, off)
                for lane in range(31, off - 1, -1):
                    if not f[lane]:
                        sc[lane] = so[lane] + sc[lane]
                    f[lane] = f[lane] or fo[lane]
                off *= 2
            for lane in range(32):
                pre, pf = (f32(0), False) if lane == 0 else (sc[lane - 1], f[lane - 1])
                if not pf:
                    pre = carry + pre
                for k in range(4):
                    r = 4 * lane + k
                    started = head[lane, :k + 1].any()
                    w[r] = alpha[r] * np.exp(ex[lane, k] if started else pre + ex[lane, k],
                                             dtype=f32)
            carry = sc[31] if f[31] else carry + sc[31]
            if weights_only:
                for r in range(128):
                    if p0 + r < P:
                        out.reshape(-1)[p0 + r] = w[r]
                        writes.reshape(-1)[p0 + r] += 1
                continue
            ray = p0 // S
            acc = np.zeros(C4, f32) if s0 == 0 else csum.copy()
            s = s0
            v = vals.reshape(-1, C4)
            for r in range(128):
                if s == 0 and r > 0:
                    if ray < N:
                        out[ray], writes[ray] = acc, writes[ray] + 1
                    acc, ray = np.zeros(C4, f32), ray + 1
                if p0 + r < P:
                    acc = acc + w[r] * v[p0 + r]
                s = (s + 1) % S
            if s == 0:
                if ray < N:
                    out[ray], writes[ray] = acc, writes[ray] + 1
            else:
                csum = acc
    return out, writes


@pytest.mark.parametrize("S, N, clusters", [(64, 37, 3), (192, 23, 2), (192, 2048, 66),
                                            (32, 9, 1), (96, 11, 2), (8, 5, 4)])
def test_render_plan_walks_whole_rays_and_composites_them(S, N, clusters):
    """The ray-aligned plan: a span holds whole rays (S = 64: a tile of two rays; S = 192:
    three tiles of two rays), every tile is walked once, each ray's tiles lie in one
    block in order; and the kernel's compositing read by a plain interpreter over that
    walk gives the plain weights and maps at 2e-5 (the order of the fp32 sums differs),
    each stored once."""
    plan = tfr._render_plan(N, S)
    assert plan["span"] * 128 == math.lcm(S, 128) == plan["rays_per_span"] * S
    if S == 64:
        assert (plan["span"], plan["rays_per_span"]) == (1, 2)
    if S == 192:
        assert (plan["span"], plan["rays_per_span"]) == (3, 2)
    walks = _render_walk(plan, clusters)
    walked = sorted(t for w in walks for t in w if t < plan["tiles"])
    assert walked == list(range(plan["tiles"]))
    owner = {}
    for b, w in enumerate(walks):
        for k, t in enumerate(w):
            for p in range(t * 128, min((t + 1) * 128, N * S)):
                owner.setdefault(p // S, []).append((b, k))
    for ray, seen in owner.items():
        assert len({b for b, _ in seen}) == 1, ray
        ks = sorted({k for _, k in seen})
        assert ks == list(range(ks[0], ks[-1] + 1)), ray
    if N > 64:
        return   # the walk alone: the interpreter is slow at a full chunk
    rng = np.random.RandomState(S + N)
    sigma = (rng.randn(N, S) * 2).astype(np.float32)
    z = np.sort(rng.uniform(1, 8, (N, S)), -1).astype(np.float32)
    d = rng.randn(N, 3).astype(np.float32)
    vals = rng.randn(N, S, 7).astype(np.float32)
    raw = torch.zeros(N, S, 4)
    raw[..., 3] = torch.from_numpy(sigma)
    want_w = composite(raw, torch.from_numpy(z), torch.from_numpy(d)).weights
    got_w, n_w = _interpret_render(plan, clusters, sigma, z, d, vals, True)
    assert (n_w == 1).all()
    np.testing.assert_allclose(got_w, want_w.numpy(), **TOL)
    got_m, n_m = _interpret_render(plan, clusters, sigma, z, d, vals, False)
    assert (n_m == 1).all()
    want_m = (torch.from_numpy(vals) * want_w[..., None]).sum(1)
    np.testing.assert_allclose(got_m, want_m.numpy(), **TOL)


def test_fused_render_on_a_card_takes_the_kernel_or_raises(monkeypatch):
    """No fallback: tensors that are not on the CPU go to the kernel; when the kernel
    cannot be built the call raises, with no launch counted and no plain-version call;
    a shape the kernel does not take is refused before any build."""
    mr, mrv, D, W, skips, ins = CASES[0]
    _, tp, o, d, z = _setup(*CASES[0])
    packed = tfm.pack_params(tp, mr, mrv, D, skips)
    meta = tfm.Packed(**{f.name: (getattr(packed, f.name).to("meta")
                                  if isinstance(getattr(packed, f.name), torch.Tensor)
                                  else getattr(packed, f.name))
                         for f in tfm.Packed.__dataclass_fields__.values()})
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda *a: (9, 0))

    def no_build(name):
        raise RuntimeError(f"kernel build failed: {name}")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a card tensor")

    monkeypatch.setattr(runtime, "load", no_build)
    monkeypatch.setattr(tfr, "fused_render_ref", no_plain)
    args = [torch.from_numpy(a).to("meta") for a in (o, _fixed(d), z)]
    runtime.reset_launches()
    for weights_only in (True, False):
        with pytest.raises(RuntimeError, match="kernel build failed: fused_render"):
            tfr.fused_render(meta, *args, weights_only)
    assert not any(runtime.LAUNCHES.values())
    with pytest.raises(ValueError, match="z \\[N, S\\]"):
        tfr.fused_render(meta, args[0], args[1], args[2][:-1], False)
    wide = tfm.Packed(**{**{f: getattr(meta, f) for f in tfm.Packed.__dataclass_fields__},
                         "c4": 60})
    with pytest.raises(ValueError, match="output columns"):
        tfr.fused_render(wide, *args, False)
