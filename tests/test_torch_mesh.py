"""The port's mesh mode on the CPU against the JAX package: every ``tools.meshing``
function bit for bit on a sphere volume and a seeded random volume, each package's
PLY files read by the other, the sigma query (its padded tail, every pe_mode's plain
versions and the plain PyTorch query) within 2e-5 of JAX's, the grid exactly, and
``mesh_main`` / ``run_test``'s mesh mode on the same parameters as the JAX package's
entry-point test (tests/test_drivers.py): vertices within 1e-4, faces and vertex colours equal.

JAX runs as its own tests run it on the CPU (``use_pallas=False``)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dmnerf_tpu.configs import Config as JConfig  # noqa: E402
from dmnerf_tpu.render.trainstep import create_train_state  # noqa: E402
from dmnerf_tpu.tools import mesh_extract as jme  # noqa: E402
from dmnerf_tpu.tools import meshing as jm  # noqa: E402
from dmnerf_tpu_torch.configs import Config  # noqa: E402
from dmnerf_tpu_torch.core.mlp import params_from_numpy  # noqa: E402
from dmnerf_tpu_torch.data.synthetic import write_dmsr_scene  # noqa: E402
from dmnerf_tpu_torch.kernels import runtime  # noqa: E402
from dmnerf_tpu_torch.test import main as cli_main  # noqa: E402
from dmnerf_tpu_torch.test import run_test  # noqa: E402
from dmnerf_tpu_torch.tools import mesh_extract as tme  # noqa: E402
from dmnerf_tpu_torch.tools import meshing as tm  # noqa: E402
from dmnerf_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

torch.set_num_threads(2)
INS = 6
# the setup of the JAX package's entry-point test (tests/test_drivers.py:49-53)
KW = dict(expname="drv", dataset_type="dmsr", N_samples=8, N_importance=8, N_train=64,
          N_test=256, near=1.0, far=8.0, netdepth=2, netwidth=32, multires=4,
          multires_views=2, ins_num=INS, testskip=1, views=2, mesh_grid_dim=20,
          mesh_level=0.1)


def _volume(kind):
    if kind == "sphere":
        t = np.linspace(-1, 1, 24)
        x, y, z = np.meshgrid(t, t, t, indexing="ij")
        return 0.6 - np.sqrt(x * x + y * y + z * z)
    return np.random.RandomState(3).rand(11, 13, 9).astype(np.float32)


def _level(kind):
    return 0.0 if kind == "sphere" else 0.55


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["sphere", "random"])
def test_marching_tetrahedra_bit_equal(kind):
    vol = _volume(kind)
    (tv, tf), (jv, jf) = tm.marching_tetrahedra(vol, _level(kind)), jm.marching_tetrahedra(vol, _level(kind))
    assert len(tf) > 50
    _equal(tv, jv)
    _equal(tf, jf)


@pytest.mark.parametrize("kind", ["sphere", "random"])
def test_vertex_normals_and_components_bit_equal(kind):
    verts, faces = jm.marching_tetrahedra(_volume(kind), _level(kind))
    _equal(tm.vertex_normals(verts, faces), jm.vertex_normals(verts, faces))
    _equal(tm._union_find_components(faces, len(verts)),
           jm._union_find_components(faces, len(verts)))


@pytest.mark.parametrize("kind", ["sphere", "random"])
@pytest.mark.parametrize("min_cluster", [1, 30])
def test_clean_mesh_bit_equal(kind, min_cluster):
    verts, faces = jm.marching_tetrahedra(_volume(kind), _level(kind))
    got, want = tm.clean_mesh(verts, faces, min_num_cluster=min_cluster), \
        jm.clean_mesh(verts, faces, min_num_cluster=min_cluster)
    for g, w in zip(got, want):
        _equal(g, w)
    for g, w in zip(tm.clean_mesh(verts, faces, keep_single_cluster=True),
                    jm.clean_mesh(verts, faces, keep_single_cluster=True)):
        _equal(g, w)


@pytest.mark.parametrize("kind", ["sphere", "random"])
def test_ply_read_by_either_package(kind, tmp_path):
    verts, faces = jm.marching_tetrahedra(_volume(kind), _level(kind))
    normals = jm.vertex_normals(verts, faces)
    colors = np.random.RandomState(1).randint(0, 255, (len(verts), 3)).astype(np.uint8)
    for writer, name in ((tm.write_ply, "port.ply"), (jm.write_ply, "jax.ply")):
        writer(str(tmp_path / name), verts, faces, colors=colors, normals=normals)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    for name in ("port.ply", "jax.ply"):
        v, f = tm.read_ply(str(tmp_path / name))
        _equal(v, verts.astype(np.float32))
        _equal(f, faces.astype(np.int64))
    # the JAX reader, on a file it can walk (its face offset is uint8 arithmetic under
    # NumPy 2: see tools/meshing.py): the first triangle of each package's writer
    for writer, name in ((tm.write_ply, "port1.ply"), (jm.write_ply, "jax1.ply")):
        writer(str(tmp_path / name), verts[:3], np.array([[0, 1, 2]]), colors=colors[:3])
        for reader in (tm.read_ply, jm.read_ply):
            v, f = reader(str(tmp_path / name))
            _equal(v, verts[:3].astype(np.float32))
            _equal(f, np.array([[0, 1, 2]], np.int64))


@pytest.mark.parametrize("kind", ["sphere", "random"])
def test_oriented_bounds_pca_bit_equal(kind):
    verts, _ = jm.marching_tetrahedra(_volume(kind), _level(kind))
    pts = verts @ np.array([[0.8, 0.6, 0.0], [-0.6, 0.8, 0.0], [0.0, 0.0, 1.0]]).T + 3.0
    for g, w in zip(tm.oriented_bounds_pca(pts), jm.oriented_bounds_pca(pts)):
        _equal(g, w)


def test_build_grid_exact():
    verts, _ = jm.marching_tetrahedra(_volume("sphere"), 0.0)
    to_origin, _ = jm.oriented_bounds_pca(verts * np.array([1.0, 2.0, 0.5]))
    for T in (np.eye(4), np.linalg.inv(to_origin)):
        for dim in (5, 12):
            _equal(tme.build_grid(T, tme.DEFAULT_EXTENTS, dim), jme.build_grid(T, jme.DEFAULT_EXTENTS, dim))


def _params(jcfg):
    state = create_train_state(jcfg, jax.random.PRNGKey(0))
    to_np = lambda p: {k: np.asarray(v) for k, v in p.items()}  # noqa: E731
    return state, to_np(state.params_coarse), to_np(state.params_fine)


@pytest.mark.parametrize("use_pallas,pe_mode", [(True, None), (True, "kernel"),
                                                (True, "outside"), (False, None)])
def test_sigma_query_matches_jax(use_pallas, pe_mode):
    """300 points in chunks of 128 (16 rays of 8 samples): the last chunk padded."""
    jcfg = JConfig(**KW, use_pallas=False)
    _, _, pf = _params(jcfg)
    pts = np.random.RandomState(5).uniform(-3, 3, (300, 3)).astype(np.float32)
    want = np.asarray(jme.make_sigma_query(jcfg, chunk=128, samples=8)(
        {k: jnp.asarray(v) for k, v in pf.items()}, jnp.asarray(pts)))
    cfg = Config(**KW, use_pallas=use_pallas, pallas_pe_mode=pe_mode)
    runtime.reset_launches()
    got = tme.make_sigma_query(cfg, chunk=128, samples=8)(params_from_numpy(pf, "cpu"),
                                                          torch.from_numpy(pts))
    assert not any(runtime.LAUNCHES.values())
    assert got.shape == (300,) and want.shape == (300,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="multiple"):
        tme.make_sigma_query(cfg, chunk=100, samples=8)


def _colors(path):
    """The uchar colours of a color_mesh.ply vertex record."""
    data = open(path, "rb").read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n_v = int(data[:end].decode().split("element vertex ")[1].split()[0])
    vdt = np.dtype([(k, "<f4") for k in ("x", "y", "z", "nx", "ny", "nz")]
                   + [(k, "u1") for k in ("red", "green", "blue")])
    v = np.frombuffer(data[end:], vdt, count=n_v)
    return np.stack([v["red"], v["green"], v["blue"]], -1)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A DM-SR scene, the JAX package's checkpoint and the port's converted from it."""
    root = tmp_path_factory.mktemp("torch_mesh")
    datadir = root / "dmsr" / "study"
    write_dmsr_scene(str(datadir), n_train=3, n_test=2, H=32, W=32, n_objects=3, ins_num=INS)
    jcfg = JConfig(basedir=str(root / "jax_logs"), datadir=str(datadir), use_pallas=False, **KW)
    cfg = Config(basedir=str(root / "torch_logs"), datadir=str(datadir), **KW)
    state, pc, pf = _params(jcfg)
    from dmnerf_tpu.utils.checkpoint import save_checkpoint as j_save

    j_save(jcfg.log_dir, state)
    save_checkpoint(cfg.log_dir, params_from_numpy(pc, "cpu"), params_from_numpy(pf, "cpu"), 0)
    return jcfg, cfg, pc, pf


def test_mesh_main_matches_jax(env, tmp_path):
    jcfg, cfg, pc, pf = env
    from dmnerf_tpu.data.dmsr import load_dmsr

    scene = load_dmsr(jcfg)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jme.mesh_main(jcfg.replace(ins_num=scene.ins_num), *({k: jnp.asarray(v) for k, v in p.items()}
                                                        for p in (pc, pf)),
                  scene.ins_rgbs, str(tmp_path / "jax"), grid_dim=20, level=0.1)
    stats = tme.mesh_main(cfg.replace(ins_num=scene.ins_num), params_from_numpy(pc, "cpu"),
                          params_from_numpy(pf, "cpu"), scene.ins_rgbs, str(tmp_path / "port"),
                          grid_dim=20, level=0.1, device="cpu")
    assert stats["faces"] > 0 and stats["clean_faces"] > 0
    assert set(stats["seconds"]) == {"grid", "sweep", "marching", "ply", "clean", "normals",
                                     "color_render", "color_ply"}
    for name in ("mesh.ply", "color_mesh.ply"):
        tv, tf = tm.read_ply(str(tmp_path / "port" / name))
        jv, jf = tm.read_ply(str(tmp_path / "jax" / name))
        np.testing.assert_allclose(tv, jv, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(_colors(str(tmp_path / "port" / "color_mesh.ply")),
                                  _colors(str(tmp_path / "jax" / "color_mesh.ply")))
    assert len(stats["labels"]) == stats["clean_verts"] == stats["rays_o"].shape[0]


def test_mesh_main_empty_surface_writes_nothing(env, tmp_path):
    _, cfg, pc, pf = env
    stats = tme.mesh_main(cfg, params_from_numpy(pc, "cpu"), params_from_numpy(pf, "cpu"),
                          np.zeros((INS, 3), np.uint8), str(tmp_path), grid_dim=6, level=2.0,
                          device="cpu")
    assert stats["faces"] == 0 and stats["path"] is None and not os.listdir(tmp_path)


def test_run_test_mesh_mode_writes_the_artifacts(env, tmp_path, monkeypatch):
    """As tests/test_drivers.py does for JAX, through the CLI with --device cpu; without
    --device and without a card it raises."""
    jcfg, cfg, _, _ = env
    conf = tmp_path / "mesh.txt"
    conf.write_text("\n".join([f"basedir = {cfg.basedir}", f"datadir = {cfg.datadir}"]
                              + [f"{k} = {v}" for k, v in KW.items()] + ["mesh"]) + "\n")
    cli_main(["--config", str(conf), "--device", "cpu"])
    savedir = os.path.join(cfg.log_dir, "mesh_000000")
    for name in ("mesh.ply", "color_mesh.ply"):
        with open(os.path.join(savedir, name), "rb") as f:
            assert f.read(200).decode("latin1").startswith("ply")
    verts, faces = tm.read_ply(os.path.join(savedir, "color_mesh.ply"))
    assert len(faces) > 0 and faces.max() < len(verts)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_test(cfg.replace(mesh=True))


def test_sigma_query_hands_the_kernel_contiguous_chunks(monkeypatch):
    """build_grid's axis swap leaves a strided array; the kernel wrapper takes only
    contiguous points on the card, so every chunk the sweep queries is contiguous."""
    from dmnerf_tpu_torch.kernels import fused_mlp

    seen = []
    orig = fused_mlp.fused_query

    def spy(packed, pts, viewdirs, pe_mode=None):
        seen.append(pts.is_contiguous())
        return orig(packed, pts, viewdirs, pe_mode)

    monkeypatch.setattr(fused_mlp, "fused_query", spy)
    grid = torch.from_numpy(tme.build_grid(np.eye(4), tme.DEFAULT_EXTENTS, 8))   # 4 whole chunks
    assert not grid.is_contiguous()
    cfg = Config(**KW)
    _, _, pf = _params(JConfig(**KW, use_pallas=False))
    tme.make_sigma_query(cfg, chunk=128, samples=8)(params_from_numpy(pf, "cpu"), grid)
    assert seen and all(seen)
