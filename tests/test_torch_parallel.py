"""The port's multi-GPU module (``dmnerf_tpu_torch/parallel/mesh.py``) in gloo worlds of
2 and 4 processes on the CPU, against the port's unsharded functions and the JAX
package's sharded ones on the 8-device CPU mesh that ``tests/conftest.py`` forces. It
mirrors the JAX package's tests at ``tests/test_data_and_train.py:337, 455, 482, 506,
534, 581, 613`` and ``tests/test_multihost.py``.

Each world is one set of processes (``tests/test_torch_parallel_ranks.py``, which
imports no JAX) started once for the module with ``torchrun``'s environment, joined
within a limit and killed past it; the parent computes the unsharded and the JAX side.

Bars: parameters after a step rtol 2e-4 / atol 2e-6 and the total loss rtol 1e-4 (the
JAX test's, ``tests/test_data_and_train.py:355-359``); renders and sigma atol 1e-5 /
rtol 1e-4; packed against unpacked, and the replicas against each other, exact.
"""

import contextlib
import importlib.util
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu import train as jtrain  # noqa: E402
from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.parallel import mesh as jmesh  # noqa: E402
from dmnerf_tpu.render import trainstep as jts  # noqa: E402
from dmnerf_tpu_torch import train as ttrain  # noqa: E402
from dmnerf_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dmnerf_tpu_torch.render.manipulator import make_manipulator_renderer  # noqa: E402
from dmnerf_tpu_torch.render.renderer import make_image_renderer  # noqa: E402
from dmnerf_tpu_torch.render.trainstep import compute_losses, make_train_step  # noqa: E402
from dmnerf_tpu_torch.core.pipeline import make_query_fn, render_rays  # noqa: E402
from dmnerf_tpu_torch.core.sampling import z_val_sample  # noqa: E402
from dmnerf_tpu_torch.tools.mesh_extract import make_sigma_query  # noqa: E402
from dmnerf_tpu_torch.tools.meshing import read_ply  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_parallel_ranks.py")
_spec = importlib.util.spec_from_file_location("torch_parallel_ranks", WORKER)
ranks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ranks)

torch.set_num_threads(2)
WORLDS = {2: "step,render,packed,fallback,train,modes", 4: "step,render,packed"}
LIMIT = 240          # seconds a world may take before its processes are killed
KINDS = ("full", "crop")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds run at once; each rank's results, by world, and each world's
    directory."""
    try:
        ports = {w: _free_port() for w in WORLDS}
    except OSError as e:  # no loopback sockets in this sandbox
        pytest.skip(f"sockets unavailable: {e}")
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in WORLDS}
    procs = {}
    for w, cases in WORLDS.items():
        for r in range(w):
            env = {**os.environ, "PYTHONPATH": REPO, "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(ports[w]), "RANK": str(r), "WORLD_SIZE": str(w),
                   "LOCAL_RANK": str(r), "OMP_NUM_THREADS": "1"}
            procs[w, r] = subprocess.Popen([sys.executable, WORKER, str(dirs[w]), cases],
                                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                           text=True, cwd=REPO, env=env)
    deadline = time.time() + LIMIT
    outs = {}
    try:
        for key, p in procs.items():
            try:
                outs[key], _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                outs[key], _ = p.communicate()
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for (w, r), p in procs.items():
        assert p.returncode == 0, f"world {w} rank {r} failed ({p.returncode}):\n{outs[w, r][-4000:]}"
    res = {w: [torch.load(dirs[w] / f"rank{r}.pt", weights_only=False) for r in range(w)]
           for w in WORLDS}
    return res, dirs, outs


@pytest.fixture(scope="module")
def scenes():
    return ranks.scenes()


@pytest.fixture(scope="module")
def unsharded(scenes):
    """The same steps through the port's unsharded step."""
    return {k: ranks.run_steps(k, scenes[k], lambda cfg, n: make_train_step(cfg, N_ins=n))
            for k in KINDS}


def _close_params(got, want, rtol=2e-4, atol=2e-6):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


def _equal_params(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_step_matches_single_device(worlds, unsharded, world, kind):
    """One step with perturb 0 and three with the draws from a generator (stronger than
    the JAX test, which needs perturb = 0): the total loss and every aux within 1e-4,
    parameters and Adam's moments within the bar, the replicas bit-identical (the JAX
    multi-host test's agreement of the replicas). ``crop``'s labelled suffix (19 of 64
    rays, with padded slots) lies on the last rank in world 2 and across ranks 2 and 3
    in world 4, where ranks 0 and 1 hold none of it."""
    res = [r["step"][kind] for r in worlds[0][world]]
    ref = unsharded[kind]
    for mode in ("det", "perturbed"):
        for r in res[1:]:
            assert _equal_params(r[mode]["params"], res[0][mode]["params"]), mode
        _close_params(res[0][mode]["params"], ref[mode]["params"])
    for k, v in ref["det"]["aux"].items():
        np.testing.assert_allclose(res[0]["det"]["aux"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    for got, want in zip(res[0]["perturbed"]["auxs"], ref["perturbed"]["auxs"]):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    for name, want in ref["perturbed"]["adam"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(res[0]["perturbed"]["adam"][name][m].numpy(),
                                       want[m].numpy(), rtol=2e-3, atol=2e-6, err_msg=name)


def _jax_state(jcfg, cfg):
    """The JAX train state over the port's seeded init parameters."""
    state = ranks.init(cfg)
    to_j = lambda ps: {k: jnp.asarray(p.detach().numpy()) for k, p in ps.items()}  # noqa: E731
    js = jts.create_train_state(jcfg, jax.random.PRNGKey(0))
    return js._replace(params_coarse=to_j(state.params_coarse),
                       params_fine=to_j(state.params_fine))


def _jconfig(scene, **kw):
    return JConfig(**{**ranks.TINY, "ins_num": scene.ins_num, "use_pallas": False, **kw})


@pytest.fixture(scope="module")
def jax_steps(scenes):
    """The JAX sharded step (8-device mesh) on the same batch and parameters, perturb 0."""
    mesh = jmesh.make_mesh(n_devices=8, devices=jax.devices("cpu"))
    out = {}
    for kind in KINDS:
        scene = scenes[kind]
        cfg = ranks.config(scene, perturb=0.0)
        jcfg = _jconfig(scene, perturb=0.0)
        batches, n_ins = ranks.fixed_batches(kind, scene, cfg)
        b = batches[0]
        jb = jts.Batch(*(jnp.asarray(t.numpy()) for t in b[:4]),
                       target_valid=None if b.target_valid is None
                       else jnp.asarray(b.target_valid.numpy()))
        with jax.set_mesh(mesh) if hasattr(jax, "set_mesh") else mesh:
            step = jmesh.make_sharded_train_step(jcfg, mesh, N_ins=n_ins)
            state, aux = step(_jax_state(jcfg, cfg), jmesh.shard_batch(mesh, jb),
                              jax.random.PRNGKey(7))
        mu = state.opt_state[0].mu        # (coarse dict, fine dict)
        out[kind] = ({f"{w} {k}": np.asarray(v) for w, ps in (("coarse", mu[0]), ("fine", mu[1]))
                      for k, v in ps.items()}, {k: float(v) for k, v in aux.items()})
    return out


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_step_matches_jax_sharded_step(worlds, jax_steps, world, kind):
    """The port's world against the JAX package's 8-device mesh, one step, perturb 0:
    the losses within 1e-4 and the global gradient, read as Adam's first moment after
    one step (0.1 g in both packages), within the JAX test's moment bar (rtol 2e-3, atol
    2e-6; tests/test_data_and_train.py:572-575). The parameters are held to the port's
    unsharded step (above), not to JAX's: Adam's first update is lr g / (|g| + eps), so
    at a gradient of a few 1e-7 the two frameworks' roundings already move a parameter
    past 2e-4 unsharded (full: 1 of 864 entries of fine trunk_0_w, g = 2.6e-7, 2.45e-4
    relative)."""
    got = worlds[0][world][0]["step"][kind]["det"]
    jmu, jaux = jax_steps[kind]
    for k in ("total_loss", "rgb_loss", "ins_loss", "emptiness_loss", "psnr_fine",
              "valid_ce_fine", "invalid_ce_fine", "valid_siou_fine"):
        np.testing.assert_allclose(got["aux"][k], jaux[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert set(jmu) == set(got["adam"])
    for k, v in jmu.items():
        np.testing.assert_allclose(got["adam"][k]["exp_avg"].numpy(), v, rtol=2e-3, atol=2e-6,
                                   err_msg=k)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_averaging_local_losses_misses_the_global_loss(worlds, scenes, world):
    """Where a denominator varies by rank (the masked instance loss, the penalizer's
    ratios, the labelled suffix on the last rank(s)), DDP's average of each rank's own
    loss is not the global loss: on the crop batch (total 5.4534) the average misses by
    25.8 % (world 2: 4.0456) and 24.1 % (world 4: 4.1391), far beyond the 1e-4 bar,
    which the sharded step meets."""
    scene = scenes["crop"]
    cfg = ranks.config(scene, perturb=0.0)
    (batch, _), n_ins = ranks.fixed_batches("crop", scene, cfg)
    state = ranks.init(cfg)
    with torch.no_grad():
        z = z_val_sample(cfg.N_train, cfg.near, cfg.far, cfg.N_samples)
        info = render_rays(state.params_coarse, state.params_fine, batch.rays_o, batch.rays_d,
                           z, make_query_fn(cfg), N_importance=cfg.N_importance, perturb=False)
        total = float(compute_losses(cfg, info, batch, n_ins)[0])
        m = cfg.N_train // world
        local = []
        for r in range(world):
            rows = slice(r * m, (r + 1) * m)
            n_loc = max(0, rows.stop - max(rows.start, cfg.N_train - n_ins))
            local.append(float(compute_losses(
                cfg, {k: v[rows] for k, v in info.items()},
                type(batch)(*(None if x is None else x[rows] for x in batch)), n_loc)[0]))
    sharded = worlds[0][world][0]["step"]["crop"]["det"]["aux"]["total_loss"]
    miss = abs(np.mean(local) - total) / total
    assert abs(sharded - total) <= 1e-4 * total
    assert miss > 0.2, miss


@pytest.fixture(scope="module")
def renders(scenes):
    """The unsharded port renders and the JAX sharded ones on the same inputs."""
    cfg = ranks.config(scenes["full"])
    state = ranks.init(cfg)
    pc, pf = state.params_coarse, state.params_fine
    x = {k: torch.from_numpy(v) for k, v in ranks.render_inputs(cfg).items()}
    mani_cfg = cfg.replace(N_test=16)
    ro = torch.zeros((ranks.MANI_RAYS, 3))
    port = {"image": make_image_renderer(cfg)(pc, pf, x["rays_o"], x["rays_d"]),
            "sigma": make_sigma_query(cfg, chunk=64, samples=8)(pf, x["pts"]),
            "mani": make_manipulator_renderer(mani_cfg, n_targets=1)(
                pc, pf, *ranks.mani_args(ro, x["mani_d"]))}
    mesh = jmesh.make_mesh(n_devices=8, devices=jax.devices("cpu"))
    jcfg = _jconfig(scenes["full"])
    js = _jax_state(jcfg, cfg)
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jmani = jmesh.make_sharded_manipulator_renderer(jcfg.replace(N_test=16), mesh, n_targets=1)(
        js.params_coarse, js.params_fine, *(j(t) for t in ranks.mani_args(ro, x["mani_d"])[:4]),
        (1,))
    jax_out = {"image": jmesh.make_sharded_image_renderer(jcfg, mesh)(
                   js.params_coarse, js.params_fine, j(x["rays_o"]), j(x["rays_d"])),
               "sigma": {"sigma": jmesh.make_sharded_sigma_query(jcfg, mesh, chunk=64, samples=8)(
                   js.params_fine, j(x["pts"]))},
               "mani": jmani}
    port["sigma"] = {"sigma": port["sigma"]}
    return port, jax_out


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("what", ["image", "sigma", "mani"])
def test_sharded_renderers_match_single_device(worlds, renders, world, what):
    """The sharded image renderer on 101 rays, the sigma sweep on 301 points (counts no
    world divides: the padded path) and the manipulation renderer in det mode on 64 rays,
    against the unsharded ones and the JAX sharded ones (8-device mesh); every rank
    returns the whole result."""
    port, jax_out = renders
    res = [r["render"][what] if what != "sigma" else {"sigma": r["render"]["sigma"]}
           for r in worlds[0][world]]
    for got in res:
        assert set(got) == set(port[what])
        for k, want in port[what].items():
            assert got[k].shape == want.shape, k
            np.testing.assert_allclose(got[k].numpy(), want.numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=k)
            if k in jax_out[what]:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(jax_out[what][k]),
                                           atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_manipulator_keyed_mode_distinct_per_shard(worlds, world):
    """Every shard renders the same bundle: in det mode the shards' outputs are
    identical; with a generator each rank draws from its own (``rank_generator``), so
    the outputs are finite and distinct."""
    det = worlds[0][world][0]["render"]["keyed_det"].numpy().reshape(world, ranks.KEYED_RAYS, 3)
    keyed = worlds[0][world][0]["render"]["keyed"].numpy().reshape(world, ranks.KEYED_RAYS, 3)
    for s in range(1, world):
        np.testing.assert_array_equal(det[s], det[0])
    assert np.isfinite(keyed).all()
    assert min(float(np.abs(keyed[s] - keyed[0]).max()) for s in range(1, world)) > 0.0


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("kind", KINDS)
def test_packed_sharded_matches_single_steps(worlds, world, kind):
    """A pack of 4 sharded steps against 4 sharded steps one at a time, from train()'s
    seeded state and generators: parameters, Adam's state and every aux bit for bit."""
    runs = worlds[0][world][0]["packed"][kind]
    packed, single = runs["packed"], runs["single"]
    assert packed["step"] == single["step"] == ranks.PACK
    assert torch.equal(packed["auxs"], single["auxs"]) and torch.isfinite(packed["auxs"]).all()
    assert _equal_params(packed["params"], single["params"])
    for name, a in packed["adam"].items():
        assert all(torch.equal(a[m], single["adam"][name][m]) for m in a), name


class _FakeScene:
    """tests/test_data_and_train.py's stand-in scene."""

    def __init__(self):
        rng = np.random.RandomState(0)
        self.images = rng.rand(2, 8, 8, 3).astype(np.float32)
        self.gt_labels = rng.randint(0, 4, size=(2, 8, 8))
        self.poses = np.stack([np.eye(4, dtype=np.float32)] * 2)
        self.K = np.asarray([[8.0, 0, 4.0], [0, -8.0, 4.0], [0, 0, -1.0]], np.float32)
        self.i_train = np.arange(2)
        self.crop_mask = None
        self.ins_indices = None


def test_nondivisible_fallback_warns_like_jax(worlds, capsys):
    """N_train = 17 over 8 devices prints the JAX train.py's message word for word; in a
    world of 2 every rank runs the unsharded step, the replicas stay identical."""
    kw = dict(ranks.TINY, N_train=17)
    jtrain.build_sampler_and_step(JConfig(**kw, ins_num=4, use_pallas=False), _FakeScene())
    jout = capsys.readouterr().out
    eight = tmesh.Mesh(None, 8, 0, torch.device("cpu"))
    ttrain.build_sampler_and_step(ranks.Config(**kw, ins_num=4), _FakeScene(), "cpu", eight)
    assert capsys.readouterr().out == jout
    assert "FALLING BACK TO SINGLE-DEVICE" in jout and "multiple of 8" in jout
    res = [r["fallback"] for r in worlds[0][2]]
    assert "FALLING BACK TO SINGLE-DEVICE" in res[0]["message"] and "multiple of 2" in res[0]["message"]
    assert res[1]["message"] == ""                  # rank 1 prints nothing
    assert _equal_params(res[0]["params"], res[1]["params"])


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def world_one_train(scenes, tmp_path_factory):
    """train() without a process group: 4 steps, then resumed to 6."""
    base = str(tmp_path_factory.mktemp("world1"))
    with contextlib.redirect_stdout(io.StringIO()):
        ttrain.train(ranks.train_config(scenes["full"], base), scenes["full"], device="cpu")
        state = ttrain.train(ranks.train_config(scenes["full"], base, N_iters=6), scenes["full"],
                             device="cpu")
    return ranks.train_config(scenes["full"], base).log_dir, state


def test_train_under_world_two_matches_world_one(worlds, scenes, world_one_train):
    """train() in a world of 2 (sharded steps, the evaluation at i_test sharded): rank
    0's metrics.jsonl and checkpoints within 1e-4 of world one's (relative, the
    parameters with the step bar's atol 2e-6), rank 1 writes nothing (its own basedir
    stays absent), and every rank resumes from rank 0's checkpoint to step 6."""
    res, dirs, _ = worlds
    log1, state1 = world_one_train
    log2 = ranks.train_config(scenes["full"], str(dirs[2] / "train")).log_dir
    m1, m2 = _metrics(log1), _metrics(log2)
    assert [r["step"] for r in m2] == [r["step"] for r in m1] == [0, 1, 2, 3, 4, 5]
    for a, b in zip(m2, m1):
        for k in b:
            if k not in ("t", "rays_per_sec"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-7, err_msg=f"{k} @ {b['step']}")
    assert sorted(os.listdir(os.path.join(log2, "checkpoints"))) == \
        sorted(os.listdir(os.path.join(log1, "checkpoints")))
    for name in os.listdir(os.path.join(log1, "checkpoints")):
        c1 = torch.load(os.path.join(log1, "checkpoints", name), weights_only=True)
        c2 = torch.load(os.path.join(log2, "checkpoints", name), weights_only=True)
        assert c1["step"] == c2["step"]
        for w in ("params_coarse", "params_fine"):
            for k in c1[w]:
                np.testing.assert_allclose(c2[w][k].numpy(), c1[w][k].numpy(), rtol=1e-4,
                                           atol=2e-6, err_msg=f"{name} {w} {k}")
    assert sorted(os.listdir(log2)) == sorted(os.listdir(log1))
    assert res[2][0]["train"]["wrote"] and not res[2][1]["train"]["wrote"]
    for r in res[2]:
        assert r["train"]["resumed_step"] == 6
        assert _equal_params(r["train"]["resumed_params"], res[2][0]["train"]["resumed_params"])


def test_run_test_modes_under_world_two_match_world_one(worlds, scenes, tmp_path):
    """run_test's render and mesh modes in a world of 2 (the views, the 20³ sweep and the
    vertex render sharded; marching on rank 0): test_results.txt within 1e-4, mesh.ply
    and color_mesh.ply vertices within 1e-4 and faces equal, the vertex labels equal on
    every rank."""
    from dmnerf_tpu_torch.test import run_test

    res, dirs, _ = worlds
    cfg1 = ranks.modes_config(scenes["full"], str(tmp_path))
    cfg2 = ranks.modes_config(scenes["full"], str(dirs[2] / "modes"))
    with contextlib.redirect_stdout(io.StringIO()):
        run_test(cfg1.replace(render=True, render_test=True), device="cpu", scene=scenes["full"])
        stats = run_test(cfg1.replace(mesh=True), device="cpu", scene=scenes["full"])
    t1 = np.loadtxt(os.path.join(cfg1.log_dir, "render_test_000000", "test_results.txt"))
    t2 = np.loadtxt(os.path.join(cfg2.log_dir, "render_test_000000", "test_results.txt"))
    np.testing.assert_allclose(t2, t1, rtol=1e-4, atol=1e-6)
    for name in ("mesh.ply", "color_mesh.ply"):
        v1, f1 = read_ply(os.path.join(cfg1.log_dir, "mesh_000000", name))
        v2, f2 = read_ply(os.path.join(cfg2.log_dir, "mesh_000000", name))
        assert len(f1) > 0
        np.testing.assert_allclose(v2, v1, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(f2, f1)
    for r in res[2]:
        np.testing.assert_array_equal(r["modes"]["labels"], stats["labels"])


def test_multi_process_entry_reads_the_environment(monkeypatch):
    """``multihost``, ``$DMNERF_MULTIHOST=1`` and a torchrun world of more than one join a
    process group from the environment (``env://``); without its variables the entry
    names them and torchrun, where JAX's jax.distributed.initialize() would wait."""
    for v in (*tmesh.ENV_VARS, "DMNERF_MULTIHOST"):
        monkeypatch.delenv(v, raising=False)
    cfg = ranks.Config()
    assert not tmesh.multi_process(cfg) and tmesh.multi_process(cfg.replace(multihost=True))
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not tmesh.multi_process(cfg)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tmesh.multi_process(cfg)
    monkeypatch.setenv("DMNERF_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT, RANK.*torchrun"):
        tmesh.init_process_group("cpu")
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank, mesh.shape) == (None, 1, 0, {"data": 1})
    with pytest.raises(ValueError, match="world of 1"):
        tmesh.make_mesh(n_devices=2, device="cpu")
