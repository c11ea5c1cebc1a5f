"""The port's training slice on the CPU against the JAX package: the instance losses,
the penalizer and the assignment, the sampler, the train step per step and over a
short trajectory, and the training entry point (checkpoints with the Adam state,
resume, ft_path, the device rule).

Tolerances: losses and the penalizer within 1e-5 (fp32, the same formulas summed in
another order); train-step losses within 1e-4 relative per step for 5 steps (Adam's
update is computed in another order by optax and torch); over 30 steps each recorded
point within 0.1 dB of PSNR and 2 % of the total loss (tests/test_training_parity.py:53-59).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.objfield import hungarian as jh  # noqa: E402
from dmnerf_tpu.objfield import losses as jl  # noqa: E402
from dmnerf_tpu.objfield import penalizer as jpen  # noqa: E402
from dmnerf_tpu.render import trainstep as jts  # noqa: E402
from dmnerf_tpu_torch.configs import Config  # noqa: E402
from dmnerf_tpu_torch.core.mlp import params_from_numpy  # noqa: E402
from dmnerf_tpu_torch.core.rays import rays_for_pixels  # noqa: E402
from dmnerf_tpu_torch.data.samplers import make_full_sampler  # noqa: E402
from dmnerf_tpu_torch.data.synthetic import build_dmsr_scene  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402
from dmnerf_tpu_torch.objfield import hungarian as th  # noqa: E402
from dmnerf_tpu_torch.objfield import losses as tl  # noqa: E402
from dmnerf_tpu_torch.objfield import penalizer as tpen  # noqa: E402
from dmnerf_tpu_torch.render import trainstep as tts  # noqa: E402

torch.set_num_threads(2)

TINY = dict(netdepth=2, netwidth=32, multires=4, multires_views=2, skips=(0,),
            N_samples=8, N_importance=8, N_train=64, N_test=128, near=2.0, far=7.0,
            ins_num=8, lrate=5e-3, lrate_decay=500, perturb=0.0, penalize=True,
            tolerance=0.05, deta_w=0.05)


def _preds(rng, n, c, batch=()):
    return rng.uniform(0.02, 0.98, batch + (n, c)).astype(np.float32)


@pytest.mark.parametrize("labels_kind", ["some", "none_valid", "all_valid"])
@pytest.mark.parametrize("masked", [False, True])
def test_ins_criterion_matches_jax(labels_kind, masked):
    """valid = 0 (every ray masked out), 0 < valid < C, valid = C; with and without
    ray_mask; coarse and fine batched."""
    rng = np.random.RandomState(3)
    N, C = 40, 6
    labels = {"some": rng.randint(0, 3, N), "none_valid": rng.randint(0, C, N),
              "all_valid": np.arange(N) % C}[labels_kind].astype(np.int32)
    mask = rng.rand(N) > 0.3
    if labels_kind == "none_valid":
        mask[:] = False
        masked = True
    pred = _preds(rng, N, C, (2,))
    rm = mask if masked else None
    got = tl.ins_criterion(torch.from_numpy(pred), torch.from_numpy(labels), C,
                           None if rm is None else torch.from_numpy(rm))
    for b in range(2):
        want = jl.ins_criterion(jnp.asarray(pred[b]), jnp.asarray(labels), C,
                                None if rm is None else jnp.asarray(rm))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g[b]), float(w), atol=1e-5, rtol=1e-5)


def test_ins_criterion_gradient_matches_jax():
    rng = np.random.RandomState(4)
    pred = _preds(rng, 32, 5)
    labels = rng.randint(0, 4, 32).astype(np.int32)
    p = torch.from_numpy(pred).requires_grad_(True)
    tl.ins_criterion(p, torch.from_numpy(labels), 5)[0].backward()
    want = jax.grad(lambda x: jl.ins_criterion(x, jnp.asarray(labels), 5)[0])(jnp.asarray(pred))
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_compact_one_hot_and_costs_match_jax():
    rng = np.random.RandomState(5)
    labels = rng.choice([1, 4, 6], 30).astype(np.int32)
    mask = rng.rand(30) > 0.2
    pred = _preds(rng, 30, 8)
    for rm in (None, mask):
        got = tl.compact_one_hot(torch.from_numpy(labels), 8,
                                 None if rm is None else torch.from_numpy(rm))
        want = jl.compact_one_hot(jnp.asarray(labels), 8, None if rm is None else jnp.asarray(rm))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert int(got[1]) == int(want[1])
        costs = tl.pairwise_costs(torch.from_numpy(pred), got[0],
                                  None if rm is None else torch.from_numpy(rm))
        jcosts = jl.pairwise_costs(jnp.asarray(pred), want[0], None if rm is None else jnp.asarray(rm))
        for g, w in zip(costs, jcosts):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("valid", [0, 3, 7])
def test_masked_assignment_optimal_cost_matches_jax(valid):
    """The same optimal cost as the JAX solver (ties may break differently); rows at
    or past valid take the leftover columns in index order; one host copy serves a
    batch."""
    rng = np.random.RandomState(valid)
    cost = rng.rand(2, 7, 7).astype(np.float32)
    got = th.masked_assignment(torch.from_numpy(cost), torch.tensor(valid)).numpy()
    for b in range(2):
        want = np.asarray(jh.masked_assignment(jnp.asarray(cost[b]), jnp.asarray(valid)))
        assert sorted(got[b]) == list(range(7))
        np.testing.assert_allclose(cost[b][np.arange(valid), got[b][:valid]].sum(),
                                   cost[b][np.arange(valid), want[:valid]].sum(), rtol=1e-6)
        np.testing.assert_array_equal(got[b][valid:], np.sort(got[b][valid:]))


def test_masked_assignment_degrades_on_non_finite_costs():
    cost = torch.tensor([[float("nan"), 1.0, 2.0], [0.5, float("inf"), 0.1],
                         [float("-inf"), 3.0, 1.0]])
    col4row = th.masked_assignment(cost, 3).numpy()
    assert sorted(col4row) == [0, 1, 2]
    assert col4row[2] == 0      # -inf reads as -1e9, the cheapest entry


def test_ins_penalizer_matches_jax():
    rng = np.random.RandomState(6)
    N, S, C = 16, 12, 6
    raw = rng.randn(N, S, 4 + C).astype(np.float32) * 3
    z = np.sort(rng.uniform(2, 6, (N, S)), -1).astype(np.float32)
    depth = rng.uniform(2.5, 5.5, N).astype(np.float32)
    rays_d = rng.randn(N, 3).astype(np.float32)
    raw_t = torch.from_numpy(raw).requires_grad_(True)
    depth_t = torch.from_numpy(depth).requires_grad_(True)
    got = tpen.ins_penalizer(raw_t, torch.from_numpy(z), depth_t, torch.from_numpy(rays_d),
                             0.05, 0.05)
    want = jpen.ins_penalizer(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(depth),
                              jnp.asarray(rays_d), 0.05, 0.05)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5, rtol=1e-5)
    got.backward()
    assert depth_t.grad is None or not depth_t.grad.any()   # depth is detached inside
    assert raw_t.grad.abs().sum() > 0


def _pre_change_penalizer(raw, z_vals, depth, rays_d, tolerance, deta_w):
    """emptiness_penalizer as it was before K12: the four sums over the bundle, then the
    two ratios; and the four sums' terms, [N, S, C'] and [N, S]."""
    import math

    depth = depth.detach()[..., None]
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    dists_before = (depth - tolerance) * norm
    dists_after = (depth + tolerance) * norm
    p_dists = z_vals * norm
    delta = depth * norm - p_dists
    gauss = torch.exp(-(delta ** 2) / (2.0 * deta_w ** 2)) / (0.4 * math.sqrt(2.0 * math.pi)) + 1e-8
    mask_before = (p_dists < dists_before).to(raw.dtype)
    mask_after = (p_dists > dists_after).to(raw.dtype)
    mask_middle = 1.0 - (mask_after + mask_before)
    pred_ins = torch.sigmoid(raw[..., 4:])
    n_ch = pred_ins.shape[-1]
    air = (torch.arange(n_ch) == n_ch - 1).to(raw.dtype)
    bce_before = -air * torch.log(torch.clamp(pred_ins, min=1e-8)) \
        - (1.0 - air) * torch.log(torch.clamp(1.0 - pred_ins, min=1e-8))
    bce_middle = -torch.log(torch.clamp(1.0 - pred_ins[..., -1], min=1e-8))
    terms = (bce_before * ((1.0 - gauss) * mask_before)[..., None], mask_before,
             bce_middle * (gauss * mask_middle), mask_middle)
    sums = [torch.sum(t) for t in terms]
    loss = sums[0] / (n_ch * torch.clamp(sums[1], min=1e-8)) + sums[2] / torch.clamp(sums[3],
                                                                                     min=1e-8)
    return sums, loss, terms


def _k12_case(N, S, ins_num, seed=0):
    """Logits of scale 4 with one in ten at +-30 (every clamp of the penalizer active),
    weights, sorted z, each ray's depth at one of its samples, rays_d."""
    rng = np.random.RandomState(seed)
    raw = 4.0 * rng.randn(N, S, 5 + ins_num)
    sat = rng.rand(N, S, ins_num + 1) < 0.1
    raw[..., 4:] = np.where(sat, np.where(rng.rand(N, S, ins_num + 1) < 0.5, -30.0, 30.0),
                            raw[..., 4:])
    z = np.sort(rng.uniform(4.0, 15.0, (N, S)), -1)
    depth = z[np.arange(N), rng.randint(0, S, N)]
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (t(raw), t(rng.rand(N, S) * 2.0 / S), t(z), t(depth), t(rng.randn(N, 3)),
            t(rng.randn(N, ins_num)))


@pytest.mark.parametrize("S", [64, 192])
@pytest.mark.parametrize("ins_num", [5, 16, 32])
def test_instance_terms_plain_route_matches_the_pre_change_formula(S, ins_num):
    """kernels.instance_terms on CPU tensors (its plain route, K12's function) against the
    step's formulas before K12, which this test keeps: composite's instance map and the
    pre-change penalizer at 37 rays (ragged against K12's blocks), logits at +-30 so
    every clamp is active. The instance map, each ray's four sums of the pre-change terms
    and raw's gradient through a loss of them all are the same bits; the rays' sums
    summed, and the penalizer's value, are the pre-change whole-bundle sums' within 1e-6
    (another sum order; the counts exact); nothing is launched."""
    from dmnerf_tpu_torch.core.compositor import composite
    from dmnerf_tpu_torch.kernels.instance_terms import instance_terms

    raw, w, z, depth, d, g_ins = _k12_case(37, S, ins_num)
    runtime.reset_launches()
    rk = raw.clone().requires_grad_(True)
    logits, sums = instance_terms(rk, w, z, depth, d, 0.05, 0.05, True)
    got_loss = tpen.penalty(sums, ins_num + 1)
    got_ins = torch.sigmoid(logits)[..., :-1]
    (gk,) = torch.autograd.grad((got_ins * g_ins).sum() + got_loss, rk)
    assert not any(runtime.LAUNCHES.values())

    # composite's instance map, over the weights composite takes from raw's sigma
    rp = raw.clone().requires_grad_(True)
    comp = composite(rp, z, d)
    logits_c, _ = instance_terms(rp, comp.weights, z, depth, d, 0.05, 0.05, False)
    assert torch.equal(torch.sigmoid(logits_c)[..., :-1], comp.ins)
    want_sums, want_loss, terms = _pre_change_penalizer(rp, z, depth, d, 0.05, 0.05)
    want_ins = torch.sigmoid(torch.sum(w[..., None] * rp[..., 4:], dim=-2))[..., :-1]
    (gp,) = torch.autograd.grad((want_ins * g_ins).sum() + want_loss, rp)
    assert torch.equal(got_ins, want_ins.detach())
    per_ray = [t.reshape(37, -1).sum(-1) for t in terms]
    assert sums.shape == (37, 4)
    assert all(torch.equal(a, b.detach()) for a, b in zip(sums.unbind(-1), per_ray))
    total = sums.detach().sum(0)
    assert float(total[1]) == float(want_sums[1]) and float(total[3]) == float(want_sums[3])
    assert 0 < float(want_sums[1]) < 37 * S and 0 < float(want_sums[3]) < 37 * S
    for i in (0, 2):
        np.testing.assert_allclose(float(total[i]), float(want_sums[i].detach()), rtol=1e-6)
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss.detach()), rtol=1e-6)
    assert torch.equal(gk, gp) and float(gk[..., :4].abs().max()) == 0.0


@pytest.mark.parametrize("world", [1, 2])
def test_compute_losses_on_the_instance_terms_path_match_the_plain_path(world):
    """One step's losses and gradient on the CPU, rendered as the train step renders
    (``instance_fn``: the instance map and the penalizer's sums from
    ``kernels.instance_terms``) and as before it (composite's instance map, the penalizer
    from the raw bundles in ``compute_losses``): every aux and every parameter gradient
    the same bits. ``world`` 2 is the sharded reduce of two ranks whose rays are alike
    (each sum doubled); there the penalizer also equals the one of the batch twice over."""
    import functools

    from dmnerf_tpu_torch.core.pipeline import make_query_fn, render_rays
    from dmnerf_tpu_torch.core.sampling import z_val_sample
    from dmnerf_tpu_torch.kernels.instance_terms import instance_terms
    from dmnerf_tpu_torch.test import init_params

    cfg = Config(**{**TINY, "perturb": 1.0, "N_train": 29})
    pc0, pf0 = init_params(cfg, "cpu")
    rng = np.random.RandomState(4)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    n = cfg.N_train
    batch = tts.Batch(t(rng.randn(n, 3) * 0.1), t(rng.randn(n, 3)), t(rng.rand(n, 3)),
                      torch.from_numpy(rng.randint(0, cfg.ins_num, n)))
    u_z, u_pdf = t(rng.rand(n, cfg.N_samples)), t(rng.rand(n, cfg.N_importance))
    reduce = None if world == 1 else (lambda x: x + x)
    instance_fn = functools.partial(instance_terms, tolerance=cfg.tolerance,
                                    deta_w=cfg.deta_w, penalize=True)

    def step(fn):
        pc = {k: v.clone().requires_grad_(True) for k, v in pc0.items()}
        pf = {k: v.clone().requires_grad_(True) for k, v in pf0.items()}
        z = z_val_sample(n, cfg.near, cfg.far, cfg.N_samples)
        info = render_rays(pc, pf, batch.rays_o, batch.rays_d, z, make_query_fn(cfg),
                           N_importance=cfg.N_importance, perturb=True, u_z=u_z, u_pdf=u_pdf,
                           instance_fn=fn)
        total, aux = tts.compute_losses(cfg, info, batch, None, reduce)
        return info, aux, torch.autograd.grad(total, [*pc.values(), *pf.values()])

    info_k, aux_k, grads_k = step(instance_fn)
    info_p, aux_p, grads_p = step(None)
    assert "penalizer_fine" in info_k and "penalizer_fine" not in info_p
    assert float(aux_k["emptiness_loss"]) > 0
    assert all(torch.equal(aux_k[k], aux_p[k]) for k in aux_p)
    assert all(torch.equal(a, b) for a, b in zip(grads_k, grads_p))
    if world == 2:
        twice = [torch.cat([info_k[k]] * 2) for k in ("raw_fine", "z_vals_fine", "depth_fine")]
        whole = tpen.ins_penalizer(*twice, torch.cat([batch.rays_d] * 2), 0.05, 0.05)
        got = tpen.penalty(info_k["penalizer_fine"], cfg.ins_num + 1, reduce)
        np.testing.assert_allclose(float(got.detach()), float(whole.detach()), rtol=1e-6)


@pytest.fixture(scope="module")
def scene():
    return build_dmsr_scene(n_train=4, n_test=1, H=16, W=16, n_objects=3, ins_num=8, seed=0)


def test_full_sampler_with_injected_ids(scene):
    sample = make_full_sampler(scene.images, scene.gt_labels, scene.poses, scene.K,
                               scene.i_train, 20, device="cpu")
    pix = np.random.RandomState(0).choice(16 * 16, 20, replace=False)
    b = sample(img_i=2, pix=torch.from_numpy(pix))
    py, px = pix // 16, pix % 16
    ro, rd = rays_for_pixels(torch.from_numpy(py), torch.from_numpy(px),
                             torch.from_numpy(scene.K), torch.from_numpy(scene.poses[2]))
    assert torch.equal(b.rays_o, ro) and torch.equal(b.rays_d, rd)
    np.testing.assert_array_equal(b.target_c.numpy(), scene.images[2][py, px])
    np.testing.assert_array_equal(b.target_i.numpy(), scene.gt_labels[2][py, px])
    drawn = sample(torch.Generator().manual_seed(1))
    d = np.round(drawn.rays_d.numpy(), 5)
    assert len(np.unique(d, axis=0)) == 20          # without replacement


def _batches(scene, n_steps, n_train, seed=0):
    """One fixed ray batch per step, made once (numpy draws, the port's sampler)."""
    rng = np.random.RandomState(seed)
    sample = make_full_sampler(scene.images, scene.gt_labels, scene.poses, scene.K,
                               scene.i_train, n_train, device="cpu")
    return [sample(img_i=int(rng.choice(scene.i_train)),
                   pix=torch.from_numpy(rng.choice(16 * 16, n_train, replace=False)))
            for _ in range(n_steps)]


@pytest.fixture(scope="module")
def trajectories(scene):
    """30 steps of the JAX make_train_step and of the port's (fused path, CPU) from
    the same parameters on the same batches, perturb = 0."""
    n_steps = 30
    batches = _batches(scene, n_steps, TINY["N_train"])
    jcfg = JConfig(**TINY)
    jstate = jts.create_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jts.make_train_step(jcfg)
    cfg = Config(**TINY)
    to_np = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa: E731
    state = tts.create_train_state(cfg, params_from_numpy(to_np(jstate.params_coarse), "cpu"),
                                   params_from_numpy(to_np(jstate.params_fine), "cpu"))
    step = tts.make_train_step(cfg)
    runtime.reset_launches()
    rows = []
    for b in batches:
        aux = step(state, b)
        jstate, jaux = jstep(jstate, jts.Batch(*(jnp.asarray(t.numpy()) for t in b[:4])),
                             jax.random.PRNGKey(0))
        rows.append(({k: float(v) for k, v in aux.items()}, {k: float(v) for k, v in jaux.items()}))
    launches = dict(runtime.LAUNCHES)
    return rows, state, launches


def test_train_step_matches_jax_per_step(trajectories):
    rows, state, launches = trajectories
    assert state.step == len(rows)
    assert not any(launches.values())
    for i, (ours, ref) in enumerate(rows[:5]):
        for k in ("total_loss", "rgb_loss", "ins_loss", "emptiness_loss"):
            assert np.isfinite(ours[k])
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i}: {k}")


def test_train_trajectory_tracks_jax(trajectories):
    rows, _, _ = trajectories
    for i in range(0, len(rows), 5):
        ours, ref = rows[i]
        assert abs(ours["psnr_fine"] - ref["psnr_fine"]) <= 0.1, i
        assert abs(ours["total_loss"] - ref["total_loss"]) <= 0.02 * max(abs(ref["total_loss"]), 1.0), i
    assert rows[-1][0]["total_loss"] < rows[0][0]["total_loss"]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["fused", "plain"])
def test_bf16_train_step_tracks_jax(scene, use_pallas):
    """precision = bfloat16 (bf16 parameters, the JAX package's
    ``dmnerf_tpu/render/trainstep.py:74``): 5 steps from the same bf16 parameters on the
    trajectory fixture's batches, perturb = 0, through the fused query (its fp32 plain
    version on the CPU) and the plain one, each within the training-parity bar of the
    JAX bf16 step's total loss (2 %, tests/test_training_parity.py:43-62); the
    parameters, their gradients and Adam's moments stay bf16. The JAX parameters cross
    as float32 (exact for bf16 values) and are cast back."""
    cfg = Config(**{**TINY, "precision": "bfloat16", "use_pallas": use_pallas})
    jcfg = JConfig(**{**TINY, "precision": "bfloat16"})
    jstate = jts.create_train_state(jcfg, jax.random.PRNGKey(0))
    jstep = jts.make_train_step(jcfg)

    def to_port(p):
        d = params_from_numpy({k: np.asarray(v, np.float32) for k, v in p.items()}, "cpu")
        return {k: v.to(torch.bfloat16) for k, v in d.items()}

    pc, pf = to_port(jstate.params_coarse), to_port(jstate.params_fine)
    assert all(np.array_equal(pf[k].float().numpy(), np.asarray(v, np.float32))
               for k, v in jstate.params_fine.items())
    state = tts.create_train_state(cfg, pc, pf)
    step = tts.make_train_step(cfg)
    for i, b in enumerate(_batches(scene, 5, TINY["N_train"])):
        aux = step(state, b)
        jstate, jaux = jstep(jstate, jts.Batch(*(jnp.asarray(t.numpy()) for t in b[:4])),
                             jax.random.PRNGKey(0))
        ours, ref = float(aux["total_loss"]), float(jaux["total_loss"])
        assert np.isfinite(ours) and abs(ours - ref) <= 0.02 * max(abs(ref), 1.0), (i, ours, ref)
    for p in [*state.params_coarse.values(), *state.params_fine.values()]:
        assert p.dtype == p.grad.dtype == torch.bfloat16
        assert all(t.dtype == torch.bfloat16 for k, t in state.opt.state[p].items() if k != "step")
    assert all(v.dtype == jnp.bfloat16 for v in jstate.params_fine.values())


def test_bf16_init_is_the_fp32_init_rounded():
    """A bf16 model's seeded init is the fp32 init rounded to bf16, draw for draw:
    ``core.mlp`` draws in fp32 whatever the dtype (``torch.rand``'s own bf16 draws are
    another sequence, and another again on other torch versions)."""
    from dmnerf_tpu_torch.test import init_params

    cfg = Config(**TINY)
    fp32, bf16 = init_params(cfg, "cpu"), init_params(cfg.replace(precision="bfloat16"), "cpu")
    for a, b in zip(fp32, bf16):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == torch.float32 and b[k].dtype == torch.bfloat16, k
            assert torch.equal(a[k].to(torch.bfloat16), b[k]), k


def test_first_update_uses_lr_at_step_zero(scene):
    """After one step Adam has moved each parameter by about lr_at_step(0): the first
    Adam update is lr * g / (|g| + eps)."""
    cfg = Config(**{**TINY, "lrate_decay": 0.001})   # a fast decay tells step 0 from 1
    from dmnerf_tpu_torch.test import init_params

    pc, pf = init_params(cfg.replace(ins_num=8), "cpu")
    state = tts.create_train_state(cfg, pc, pf)
    tts.make_train_step(cfg)(state, _batches(scene, 1, TINY["N_train"])[0])
    moved = max(float((state.params_fine[k].detach() - pf[k]).abs().max()) for k in pf)
    assert abs(moved - tts.lr_at_step(cfg, 0)) <= 1e-3 * tts.lr_at_step(cfg, 0)
    assert tts.lr_at_step(cfg, 1) < 0.5 * tts.lr_at_step(cfg, 0)


def _cli_cfg(tmp_path, **kw):
    return Config(**{**TINY, "perturb": 1.0, "N_iters": 4, "i_print": 1, "i_save": 2,
                     "i_test": 10 ** 6, "basedir": str(tmp_path), "expname": "t", **kw})


def test_train_cli_checkpoints_resume_and_ft_path(scene, tmp_path):
    from dmnerf_tpu_torch.train import train
    from dmnerf_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = _cli_cfg(tmp_path)
    state = train(cfg, scene, device="cpu")
    assert state.step == 4
    pc, pf, step, opt = restore_checkpoint(cfg.log_dir, "cpu")
    assert step == 4 and opt is not None and len(opt["state"]) == 2 * len(pc)
    assert int(opt["state"][0]["step"]) == 4
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    assert all(np.isfinite(r["ins_loss"]) and np.isfinite(r["total_loss"]) for r in recs)

    resumed = train(cfg.replace(N_iters=6), scene, device="cpu")   # resumes at step 4
    assert resumed.step == 6
    with open(os.path.join(cfg.log_dir, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f][4:] == [4, 5]

    # checkpoints land after the step: 000003.pt (i = 2), 000005.pt (i = 4), 000006.pt
    ft = train(cfg.replace(N_iters=5, ft_path=os.path.join(cfg.log_dir, "checkpoints",
                                                            "000003.pt")), scene, device="cpu")
    assert ft.step == 5      # ft_path (step 3) won over resume (step 6): steps 3 and 4 ran


def test_train_cli_needs_cuda_or_an_explicit_cpu(scene, tmp_path, monkeypatch):
    from dmnerf_tpu_torch.train import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(_cli_cfg(tmp_path), scene)
    # multihost joins a process group from the environment, which names none here
    with pytest.raises(RuntimeError, match="torchrun"):
        train(_cli_cfg(tmp_path, multihost=True), scene, device="cpu")
    # profile_dir traces steps 1 and 2 of 4 on the CPU
    cfg = _cli_cfg(tmp_path, expname="prof", profile_dir=str(tmp_path / "prof"),
                   profile_start=1, profile_steps=2)
    assert train(cfg, scene, device="cpu").step == 4
    with open(tmp_path / "prof" / "train_steps_000001-000002.json") as f:
        assert json.load(f)["traceEvents"]


def _nan_states(scene):
    """The JAX and port train states from the same initial parameters, with one NaN
    weight in the fine model's first trunk layer."""
    jcfg = JConfig(**TINY)
    jstate = jts.create_train_state(jcfg, jax.random.PRNGKey(0))
    to_np = lambda p: {k: np.array(v) for k, v in p.items()}  # noqa: E731
    pc, pf = to_np(jstate.params_coarse), to_np(jstate.params_fine)
    pf["trunk_0_w"][0, 0] = np.nan
    jstate = jstate._replace(params_fine={k: jnp.asarray(v) for k, v in pf.items()})
    state = tts.create_train_state(Config(**TINY), params_from_numpy(pc, "cpu"),
                                   params_from_numpy(pf, "cpu"))
    return jcfg, jstate, state


@pytest.mark.parametrize("debug_nans", [True, False])
def test_debug_nans_stops_at_the_first_non_finite_step_like_jax(scene, debug_nans):
    """With debug_nans both packages raise FloatingPointError on a NaN weight (JAX's
    jax_debug_nans, the port's finiteness check before the update); without it both
    train on through the NaN."""
    jcfg, jstate, state = _nan_states(scene)
    b = _batches(scene, 1, TINY["N_train"])[0]
    jbatch = jts.Batch(*(jnp.asarray(t.numpy()) for t in b[:4]))
    jstep = jts.make_train_step(jcfg)
    step = tts.make_train_step(Config(**TINY, debug_nans=debug_nans))
    before = {k: v.detach().clone() for k, v in state.params_coarse.items()}
    if debug_nans:
        with jax.debug_nans(True):
            with pytest.raises(FloatingPointError):
                jax.block_until_ready(jstep(jstate, jbatch, jax.random.PRNGKey(0)))
        with pytest.raises(FloatingPointError, match=r"step 0: non-finite loss rgb_loss"):
            step(state, b)
        assert state.step == 0      # the update was not applied
        assert all(torch.equal(state.params_coarse[k], v) for k, v in before.items())
    else:
        _, jaux = jstep(jstate, jbatch, jax.random.PRNGKey(0))
        aux = step(state, b)
        assert state.step == 1
        assert not np.isfinite(float(jaux["total_loss"])) and not np.isfinite(float(aux["total_loss"]))


def test_debug_nans_leaves_a_finite_run_unchanged(scene):
    """Three finite steps with and without debug_nans: the same losses and parameters,
    bit for bit."""
    from dmnerf_tpu_torch.test import init_params

    batches = _batches(scene, 3, TINY["N_train"])
    pc, pf = init_params(Config(**TINY), "cpu")
    runs = []
    for flag in (False, True):
        cfg = Config(**TINY, debug_nans=flag)
        state = tts.create_train_state(cfg, pc, pf)
        step = tts.make_train_step(cfg)
        runs.append(([step(state, b)["total_loss"] for b in batches], state))
    (l0, s0), (l1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1)) and all(np.isfinite(float(x)) for x in l1)
    assert all(torch.equal(s0.params_fine[k], s1.params_fine[k]) for k in s0.params_fine)
