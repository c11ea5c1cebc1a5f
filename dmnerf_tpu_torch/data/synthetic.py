"""Analytic scene generators (``dmnerf_tpu/data/synthetic.py``): DM-SR, Replica and
ScanNet.

A set of colored spheres (one instance label each) over a sky gradient, ray-traced
with the DM-SR loader's ray convention (K with negative fy and fz = -1), so a NeRF
fit to these images against ``rays_from_K`` is geometrically consistent.

``write_dmsr_scene`` writes a DM-SR directory ({train,test}/rgbs, transforms.json,
semantic_instance, ins_rgb.hdf5, objs_info.json, color_dict.json) and, for each of
its ``mani_modes``, the manipulated ground truth (indoor_{mode}_test/, the test views
re-rendered with object 0 moved: translation by -0.25 in y, scale by 1.2; rotation
leaves a sphere as it is). ``build_dmsr_scene`` and ``build_dmsr_mani_scene`` build in
memory the SceneData that writing and then ``load_dmsr`` / ``load_dmsr_mani`` would
give, PNG quantization included. The writers write images through Pillow
(``utils.image_io``, the bytes imageio writes) and the palette with the port's HDF5
writer (``utils.hdf5``, which h5py reads).

``write_replica_scene`` and ``write_scannet_scene`` write Replica and ScanNet trees
(the same files, draws included, as the JAX package's writers). Both datasets store
OpenCV camera-to-world poses (y down, z forward) with positive intrinsics, while
``render_view`` works in the blender convention of ``_look_at`` (the camera looks
along -z), so the saved pose is c2w @ diag(1, -1, -1, 1): without that bridge the
loaded rays point backward and upside down against the rendered pixels.
``build_replica_scene`` and ``build_scannet_scene`` build the loaders' SceneData in
memory, through the loaders' own ``scene_from_arrays``; the ScanNet one skips the
JPEG round trip, so its images are the uint8 renders without the JPEG loss.
"""

from __future__ import annotations

import json
import os

import numpy as np

from dmnerf_tpu_torch.configs import Config
from dmnerf_tpu_torch.data import replica, scannet
from dmnerf_tpu_torch.data.dmsr import demo_view_poses, dmsr_intrinsics
from dmnerf_tpu_torch.data.scene import SceneData
from dmnerf_tpu_torch.utils.hdf5 import write_dataset
from dmnerf_tpu_torch.utils.image_io import imwrite

_CV_FLIP = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)   # blender <-> OpenCV camera axes


def _look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    # the camera looks along -z in the blender/DM-SR convention
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, true_up, -fwd
    c2w[:3, 3] = eye
    return c2w


def default_spec(n_objects: int = 4, seed: int = 0):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-1.2, 1.2, size=(n_objects, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(-0.5, 0.5, size=n_objects)
    radii = rng.uniform(0.35, 0.6, size=n_objects).astype(np.float32)
    colors = rng.uniform(0.2, 0.95, size=(n_objects, 3)).astype(np.float32)
    return {"centers": centers, "radii": radii, "colors": colors}


def render_view(c2w: np.ndarray, H: int, W: int, K: np.ndarray, spec) -> tuple:
    """Returns (rgb [H,W,3] float in [0,1], label [H,W] int). Label 0 = background,
    sphere k has label k+1."""
    j, i = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32), indexing="ij")
    dirs = np.stack(
        [(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1], K[2, 2] * np.ones_like(i)], -1
    )
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape)

    d_norm = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    best_t = np.full((H, W), np.inf, np.float32)
    label = np.zeros((H, W), np.int32)
    rgb = np.empty((H, W, 3), np.float32)
    rgb[:] = 0.25 + 0.35 * (d_norm[..., 2:3] * 0.5 + 0.5)

    light = np.array([0.4, -0.3, 0.85])
    light = light / np.linalg.norm(light)
    for k in range(len(spec["radii"])):
        c, r, col = spec["centers"][k], spec["radii"][k], spec["colors"][k]
        oc = rays_o - c
        b = np.sum(oc * d_norm, -1)
        disc = b * b - (np.sum(oc * oc, -1) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= (t > 1e-3) & (t < best_t)
        if not hit.any():
            continue
        p = rays_o[hit] + d_norm[hit] * t[hit, None]
        n = (p - c) / r
        shade = 0.35 + 0.65 * np.maximum(n @ light, 0)
        rgb[hit] = np.clip(col * shade[:, None], 0, 1)
        label[hit] = k + 1
        best_t[hit] = t[hit]
    return rgb, label


def _render_K(H: int, W: int) -> np.ndarray:
    focal = float(W)  # ~53deg fov
    return np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1]], np.float32)


def _dmsr_scene(n_train, n_test, H, W, n_objects, ins_num, seed, radius):
    """Everything a DM-SR directory holds, in memory: per split a list of
    (c2w, rgb uint8, label uint8), the camera angle, the palette and objs_info."""
    spec = default_spec(n_objects, seed)
    K = _render_K(H, W)
    angle_x = float(2.0 * np.arctan(W / (2.0 * float(W))))

    splits = {}
    for split, count, phase in [("train", n_train, 0.0), ("test", n_test, 0.13)]:
        frames = []
        for t in range(count):
            ang = phase + 2 * np.pi * t / max(count, 1)
            eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.6 + 0.4 * np.sin(2 * ang)])
            c2w = _look_at(eye.astype(np.float32), np.zeros(3, np.float32))
            rgb, label = render_view(c2w, H, W, K, spec)
            frames.append((c2w, (rgb * 255).astype(np.uint8), label.astype(np.uint8)))
        splits[split] = frames

    rng = np.random.RandomState(seed + 1)
    palette = rng.randint(0, 255, size=(ins_num, 3)).astype(np.uint8)
    objs_info = {
        "objects": [
            {"obj_name": f"sphere_{k}", "tar_id": k + 1, "mani_mode": "translation",
             "obj_center": spec["centers"][k].tolist(), "distance": [0.5]}
            for k in range(n_objects)
        ],
        "view_id": 0,
        "ins_map": {str(k + 1): k + 1 for k in range(n_objects)},
    }
    return spec, splits, angle_x, palette, objs_info


def _mani_gt_frames(spec, c2ws, H: int, W: int, mode: str):
    """(rgb uint8, label uint8) of each view with the manipulation of ``mode`` applied
    to object 0 of the scene spec."""
    spec2 = {k: v.copy() for k, v in spec.items()}
    if mode == "translation":
        spec2["centers"][0] += np.array([0, -0.25, 0], np.float32)
    elif mode == "scale":
        spec2["radii"][0] *= 1.2
    frames = []
    for c2w in c2ws:
        rgb, label = render_view(c2w, H, W, _render_K(H, W), spec2)
        frames.append(((rgb * 255).astype(np.uint8), label.astype(np.uint8)))
    return frames


def _write_frames(root: str, frames) -> None:
    os.makedirs(os.path.join(root, "rgbs"), exist_ok=True)
    os.makedirs(os.path.join(root, "semantic_instance"), exist_ok=True)
    for t, (rgb, label) in enumerate(frames):
        imwrite(os.path.join(root, "rgbs", f"{t:04d}.png"), rgb)
        imwrite(os.path.join(root, "semantic_instance", f"{t:04d}.png"), label)


def write_dmsr_scene(out_dir: str, n_train: int = 12, n_test: int = 4, H: int = 64,
                     W: int = 64, n_objects: int = 4, ins_num: int = 8, seed: int = 0,
                     radius: float = 4.0, mani_modes=None):
    """Writes a DM-SR-format scene; returns the spec. ins_num >= n_objects + 1. With
    ``mani_modes``, also the top-level transforms.json (the test split's) and the
    manipulated ground truth of each mode, which ``load_dmsr_mani`` reads."""
    spec, splits, angle_x, palette, objs_info = _dmsr_scene(
        n_train, n_test, H, W, n_objects, ins_num, seed, radius)
    for split, frames in splits.items():
        _write_frames(os.path.join(out_dir, split), [(rgb, label) for _, rgb, label in frames])
        with open(os.path.join(out_dir, split, "transforms.json"), "w") as f:
            json.dump({"camera_angle_x": angle_x,
                       "frames": [{"transform_matrix": c2w.tolist()} for c2w, _, _ in frames]}, f)
    _write_palette(out_dir, palette)
    with open(os.path.join(out_dir, "objs_info.json"), "w") as f:
        json.dump(objs_info, f)
    with open(os.path.join(out_dir, "color_dict.json"), "w") as f:
        json.dump({str(lbl): int(lbl) for lbl in range(ins_num)}, f)
    if mani_modes:
        # the manipulated-GT loader reads the poses from a top-level transforms.json
        with open(os.path.join(out_dir, "test", "transforms.json")) as f:
            meta = json.load(f)
        with open(os.path.join(out_dir, "transforms.json"), "w") as f:
            json.dump(meta, f)
        c2ws = [np.array(fr["transform_matrix"], np.float32) for fr in meta["frames"]]
        for mode in mani_modes:
            _write_frames(os.path.join(out_dir, f"indoor_{mode}_test"),
                          _mani_gt_frames(spec, c2ws, H, W, mode))
    return spec


def build_dmsr_scene(n_train: int = 12, n_test: int = 4, H: int = 64, W: int = 64,
                     n_objects: int = 4, ins_num: int = 8, seed: int = 0,
                     radius: float = 4.0, testskip: int = 1, views: int = 720) -> SceneData:
    """The SceneData that ``write_dmsr_scene`` followed by ``load_dmsr`` gives, for
    a config with this ``testskip`` and ``views``, built in memory."""
    _, splits, angle_x, palette, objs_info = _dmsr_scene(
        n_train, n_test, H, W, n_objects, ins_num, seed, radius)
    skip = testskip if testskip != 0 else 1
    frames = splits["train"] + splits["test"][::skip]
    images = (np.stack([rgb for _, rgb, _ in frames]) / 255.0).astype(np.float32)
    poses = np.stack([c2w for c2w, _, _ in frames]).astype(np.float32)
    n_tr = len(splits["train"])
    return SceneData(
        images=images, poses=poses, H=H, W=W, K=dmsr_intrinsics(H, W, angle_x),
        i_train=np.arange(n_tr), i_test=np.arange(n_tr, len(frames)),
        gt_labels=np.stack([label for _, _, label in frames]).astype(np.int32),
        ins_rgbs=palette, ins_num=len(palette), objs=objs_info["objects"],
        view_poses=demo_view_poses(poses, objs_info["view_id"], views),
        ins_map=objs_info["ins_map"],
    )


def build_dmsr_mani_scene(mode: str, n_test: int = 4, H: int = 64, W: int = 64,
                          n_objects: int = 4, ins_num: int = 8, seed: int = 0,
                          radius: float = 4.0, testskip: int = 1) -> SceneData:
    """The SceneData that ``write_dmsr_scene(mani_modes=[mode])`` followed by
    ``load_dmsr_mani`` gives, for a config with this ``mani_mode`` and ``testskip``,
    built in memory."""
    spec, splits, angle_x, palette, _ = _dmsr_scene(0, n_test, H, W, n_objects, ins_num,
                                                    seed, radius)
    skip = testskip if testskip != 0 else 1
    c2ws = [c2w for c2w, _, _ in splits["test"]][::skip]
    frames = _mani_gt_frames(spec, c2ws, H, W, mode)
    return SceneData(
        images=(np.stack([rgb for rgb, _ in frames]) / 255.0).astype(np.float32),
        poses=np.stack(c2ws).astype(np.float32), H=H, W=W,
        K=dmsr_intrinsics(H, W, angle_x), i_train=np.arange(0), i_test=np.arange(len(frames)),
        gt_labels=np.stack([label for _, label in frames]).astype(np.int32),
        ins_rgbs=palette, ins_num=len(palette),
    )


def _write_palette(out_dir: str, palette: np.ndarray) -> None:
    write_dataset(os.path.join(out_dir, "ins_rgb.hdf5"), "datasets", palette)


def _replica_scene(H, W, n_objects, ins_num, seed, ids):
    """A Replica trajectory of 900 OpenCV poses on a circle of radius 4, the (rgb
    uint8, label uint8) renders of the frames ``ids``, the palette and objs_info."""
    spec = default_spec(n_objects, seed)
    focal = W / 2.0
    # the blender-convention K of the renders; centres at (W-1)/2, (H-1)/2 as the
    # loader's K
    K_render = np.array([[focal, 0, (W - 1) * 0.5], [0, -focal, (H - 1) * 0.5],
                         [0, 0, -1]], np.float32)
    total, radius = 900, 4.0
    poses = np.zeros((total, 4, 4), np.float32)
    for i in range(total):
        ang = 2 * np.pi * i / total
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.6], np.float32)
        poses[i] = _look_at(eye, np.zeros(3, np.float32))
    frames = {}
    for i in ids:
        rgb, label = render_view(poses[i], H, W, K_render, spec)
        frames[i] = ((rgb * 255).astype(np.uint8), label.astype(np.uint8))
    palette = np.random.RandomState(seed + 1).randint(0, 255, size=(ins_num, 3)).astype(np.uint8)
    objs_info = {
        "objects": [{"obj_name": f"sphere_{k}", "tar_id": k + 1, "mani_mode": "translation",
                     "obj_center": spec["centers"][k].tolist(), "distance": [0.5]}
                    for k in range(n_objects)],
        "view_id": 0,
        "ins_map": {str(k + 1): k + 1 for k in range(n_objects)},
    }
    return spec, poses @ _CV_FLIP, frames, palette, objs_info


def write_replica_scene(out_dir: str, H: int = 16, W: int = 16, n_objects: int = 3,
                        ins_num: int = 8, seed: int = 0, testskip: int = 10,
                        with_objs_info: bool = True):
    """Writes a Replica tree (traj_w_c.txt with 900 flat 4x4 rows, rgb/rgb_{i}.png,
    semantic_instance/semantic_instance_{i}.png, ins_rgb.hdf5, objs_info.json) with
    images only for the frames a loader with this ``testskip`` reads; returns the
    spec."""
    train_ids, test_ids = replica.read_ids(Config(testskip=testskip))
    spec, traj, frames, palette, objs_info = _replica_scene(
        H, W, n_objects, ins_num, seed, sorted(set(train_ids) | set(test_ids)))
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "semantic_instance"), exist_ok=True)
    np.savetxt(os.path.join(out_dir, "traj_w_c.txt"), traj.reshape(len(traj), 16), delimiter=" ")
    for i, (rgb, label) in frames.items():
        imwrite(os.path.join(out_dir, "rgb", f"rgb_{i}.png"), rgb)
        imwrite(os.path.join(out_dir, "semantic_instance", f"semantic_instance_{i}.png"), label)
    _write_palette(out_dir, palette)
    if with_objs_info:
        with open(os.path.join(out_dir, "objs_info.json"), "w") as f:
            json.dump(objs_info, f)
    return spec


def build_replica_scene(cfg: Config, H: int = 16, W: int = 16, n_objects: int = 3,
                        ins_num: int = 8, seed: int = 0) -> SceneData:
    """The SceneData that ``write_replica_scene`` followed by ``load_replica(cfg)``
    gives, built in memory."""
    train_ids, test_ids = replica.read_ids(cfg)
    ids = list(train_ids) + list(test_ids)
    _, traj, frames, palette, objs_info = _replica_scene(H, W, n_objects, ins_num, seed,
                                                         sorted(set(ids)))
    return replica.scene_from_arrays(cfg, traj, np.stack([frames[i][0] for i in ids]),
                                     np.stack([frames[i][1] for i in ids]), palette, objs_info)


def _scannet_scene(n_train, n_test, H, W, n_objects, seed, unlabeled_frac):
    """Per split a list of (frame id, rgb uint8, OpenCV c2w, raw labels with -1
    unlabelled), the 4x4 intrinsics and the palette. Raw label k - 1 marks sphere k - 1
    (render label k); the background and a random ``unlabeled_frac`` of the pixels are
    -1 (the weak labels)."""
    spec = default_spec(n_objects, seed)
    focal = float(W)
    K = np.array([[focal, 0, W * 0.5], [0, focal, H * 0.5], [0, 0, 1]], np.float32)
    K_render = np.array([[focal, 0, W * 0.5], [0, -focal, H * 0.5], [0, 0, -1]], np.float32)
    intr = np.eye(4, dtype=np.float32)
    intr[:3, :3] = K

    rng = np.random.RandomState(seed + 2)
    radius = 4.0
    splits, frame = {}, 0
    for split, count in [("train", n_train), ("test", n_test)]:
        frames = []
        for i in range(frame, frame + count):
            ang = 2 * np.pi * i / (n_train + n_test)
            eye = np.array([radius * np.cos(ang), radius * np.sin(ang), 1.6], np.float32)
            c2w = _look_at(eye, np.zeros(3, np.float32))
            rgb, label = render_view(c2w, H, W, K_render, spec)
            raw = label.astype(np.int32) - 1
            raw[rng.rand(H, W) < unlabeled_frac] = -1
            frames.append((i, (rgb * 255).astype(np.uint8), c2w @ _CV_FLIP, raw))
        frame += count
        splits[split] = frames
    palette = rng.randint(0, 255, size=(n_objects + 4, 3)).astype(np.uint8)
    return spec, splits, intr, palette


def write_scannet_scene(out_dir: str, n_train: int = 5, n_test: int = 3, H: int = 24,
                        W: int = 32, n_objects: int = 3, seed: int = 0,
                        unlabeled_frac: float = 0.5):
    """Writes a ScanNet tree ({split}_split_idx.txt, {split}/{split}_images/{i}.jpg,
    {split}/{split}_pose/{i}.txt, {split}/{split}_ins/{i}.npz with ins_2d_label_id,
    intrinsic/intrinsic_{color,depth}.txt, ins_rgb.hdf5); returns the spec."""
    spec, splits, intr, palette = _scannet_scene(n_train, n_test, H, W, n_objects, seed,
                                                 unlabeled_frac)
    os.makedirs(os.path.join(out_dir, "intrinsic"), exist_ok=True)
    np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_color.txt"), intr)
    np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_depth.txt"), intr)
    for split, frames in splits.items():
        np.savetxt(os.path.join(out_dir, f"{split}_split_idx.txt"),
                   np.asarray([i for i, *_ in frames], np.int32), fmt="%d")
        dirs = [os.path.join(out_dir, split, f"{split}_{kind}") for kind in ("images", "pose", "ins")]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        for i, rgb, c2w_cv, raw in frames:
            imwrite(os.path.join(dirs[0], f"{i}.jpg"), rgb)
            np.savetxt(os.path.join(dirs[1], f"{i}.txt"), c2w_cv)
            np.savez(os.path.join(dirs[2], f"{i}.npz"), ins_2d_label_id=raw)
    _write_palette(out_dir, palette)
    return spec


def build_scannet_scene(cfg: Config, n_train: int = 5, n_test: int = 3, H: int = 24,
                        W: int = 32, n_objects: int = 3, seed: int = 0,
                        unlabeled_frac: float = 0.5) -> SceneData:
    """The SceneData that ``write_scannet_scene`` followed by ``load_scannet(cfg)``
    gives, built in memory, but for the JPEG loss of the images."""
    _, splits, intr, palette = _scannet_scene(n_train, n_test, H, W, n_objects, seed,
                                              unlabeled_frac)
    skip = cfg.testskip if cfg.testskip != 0 else 1

    def arrays(frames):
        return ((np.stack([rgb for _, rgb, _, _ in frames]) / 255.0).astype(np.float32),
                np.stack([c2w for _, _, c2w, _ in frames]).astype(np.float32),
                np.stack([raw for _, _, _, raw in frames]))

    return scannet.scene_from_arrays(cfg, arrays(splits["train"]), arrays(splits["test"][::skip]),
                                     intr, palette)
