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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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
