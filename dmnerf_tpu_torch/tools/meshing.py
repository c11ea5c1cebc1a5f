"""Dependency-free mesh geometry, a NumPy copy of ``dmnerf_tpu/tools/meshing.py``
(this package imports nothing of the JAX one): iso-surface extraction, cleaning, PLY
IO, oriented bounds. The arithmetic is the same line for line, so both packages give
the same bits and write the same PLY bytes. One line differs: ``read_ply`` steps
through the face records in Python ints. The JAX module adds the record's uint8 count
to the offset, which NumPy 2 keeps in uint8 and refuses once the offset passes 255
bytes, so it reads no PLY of more than a few vertices there.

 * ``marching_tetrahedra``: vectorized iso-surfacing. Each grid cube splits into
   6 tetrahedra; each tet emits 0-2 triangles with edge-interpolated vertices, deduped
   by grid-edge key; 'ascent' gradient orientation, vertices in index coordinates
   (the reference's skimage.measure.marching_cubes, tools/mesh_generator.py:66-69).
 * ``clean_mesh``: connected-component filtering over the face graph (union-find on
   shared vertices), dropping components with fewer than min_num_cluster faces
   (open3d cluster_connected_triangles, reference tools/visualizer.py:169-194).
 * ``vertex_normals``: area-weighted face-normal accumulation.
 * ``write_ply`` / ``read_ply``: binary little-endian PLY with optional per-vertex
   uchar colors (the reference's color_mesh.ply output format).
 * ``oriented_bounds_pca``: PCA approximation of trimesh.bounds.oriented_bounds
   (to_origin transform + extents): a scene-aligned sampling frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# 6-tetrahedra decomposition of the unit cube (corner ids 0..7, bit k = axis k offset)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 3, 6], [0, 3, 2, 6], [0, 2, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]],
    np.int64,
)
_CORNER_OFFSETS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]],
    np.int64,
)


def marching_tetrahedra(volume: np.ndarray, level: float) -> Tuple[np.ndarray, np.ndarray]:
    """volume: [X, Y, Z] scalar field. Returns (vertices [V, 3] float in index coords,
    faces [F, 3] int). Triangles are oriented toward increasing field ('ascent')."""
    X, Y, Z = volume.shape
    # grid of cube base corners
    bx, by, bz = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    base = np.stack([bx, by, bz], -1).reshape(-1, 3)             # [C, 3]
    # flat ids of all 8 corners per cube
    corner_pos = base[:, None, :] + _CORNER_OFFSETS[None]         # [C, 8, 3]
    corner_flat = (
        corner_pos[..., 0] * (Y * Z) + corner_pos[..., 1] * Z + corner_pos[..., 2]
    )                                                             # [C, 8]
    vol_flat = volume.reshape(-1)
    corner_val = vol_flat[corner_flat]                            # [C, 8]

    # quick reject: cubes fully above/below the level
    inside = corner_val > level
    active = inside.any(1) & (~inside).any(1)
    corner_flat = corner_flat[active]
    corner_val = corner_val[active]
    if corner_flat.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tri_edges = []  # list of [T, 3, 2] arrays of (flat_a, flat_b) grid-edge endpoints
    for tet in _TETS:
        ids = corner_flat[:, tet]                                 # [C, 4]
        vals = corner_val[:, tet]                                 # [C, 4]
        ins = vals > level                                        # [C, 4]
        code = ins[:, 0] * 1 + ins[:, 1] * 2 + ins[:, 2] * 4 + ins[:, 3] * 8

        # tet corner index pairs per case; cases 1..14 emit 1 or 2 triangles.
        # orientation fixed afterwards via the field gradient, so case tables only
        # need correct topology.
        def edge(a, b):
            return np.stack([ids[:, a], ids[:, b]], -1)           # [C, 2]

        e01, e02, e03 = edge(0, 1), edge(0, 2), edge(0, 3)
        e12, e13, e23 = edge(1, 2), edge(1, 3), edge(2, 3)

        single = {
            1: (e01, e02, e03), 2: (e01, e13, e12), 4: (e02, e12, e23), 8: (e03, e23, e13),
            14: (e01, e03, e02), 13: (e01, e12, e13), 11: (e02, e23, e12), 7: (e03, e13, e23),
        }
        double = {
            3: ((e02, e03, e13), (e02, e13, e12)),
            12: ((e02, e13, e03), (e02, e12, e13)),
            5: ((e01, e03, e23), (e01, e23, e12)),
            10: ((e01, e23, e03), (e01, e12, e23)),
            6: ((e01, e02, e23), (e01, e23, e13)),
            9: ((e01, e23, e02), (e01, e13, e23)),
        }
        for case, tri in single.items():
            m = code == case
            if m.any():
                tri_edges.append(np.stack([t[m] for t in tri], 1))
        for case, (t1, t2) in double.items():
            m = code == case
            if m.any():
                tri_edges.append(np.stack([t[m] for t in t1], 1))
                tri_edges.append(np.stack([t[m] for t in t2], 1))

    if not tri_edges:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tris = np.concatenate(tri_edges, 0)                           # [F, 3, 2]

    # dedup vertices by sorted grid-edge key
    lo = np.minimum(tris[..., 0], tris[..., 1])
    hi = np.maximum(tris[..., 0], tris[..., 1])
    keys = lo.astype(np.int64) * (X * Y * Z) + hi                 # [F, 3]
    uniq, inv = np.unique(keys.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3)

    ua = (uniq // (X * Y * Z)).astype(np.int64)
    ub = (uniq % (X * Y * Z)).astype(np.int64)
    va, vb = vol_flat[ua], vol_flat[ub]
    denom = vb - va
    t = np.where(np.abs(denom) < 1e-12, 0.5, (level - va) / np.where(denom == 0, 1, denom))
    t = np.clip(t, 0.0, 1.0)

    def unflat(f):
        return np.stack([f // (Y * Z), (f // Z) % Y, f % Z], -1).astype(np.float64)

    verts = unflat(ua) + t[:, None] * (unflat(ub) - unflat(ua))

    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (faces[:, 0] != faces[:, 2])
    faces = faces[good]

    # orient toward increasing field: flip faces whose normal points against the
    # local gradient (marching_cubes 'ascent' convention)
    grad = np.stack(np.gradient(volume), -1).reshape(-1, 3)
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    centers = np.clip(np.round(fv.mean(1)).astype(np.int64), 0, [X - 1, Y - 1, Z - 1])
    cflat = centers[:, 0] * (Y * Z) + centers[:, 1] * Z + centers[:, 2]
    flip = np.sum(fn * grad[cflat], -1) < 0
    faces[flip] = faces[flip][:, ::-1]

    return verts.astype(np.float32), faces


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


def _union_find_components(faces: np.ndarray, n_verts: int) -> np.ndarray:
    parent = np.arange(n_verts)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for f in faces:
        a, b, c = find(f[0]), find(f[1]), find(f[2])
        parent[b] = a
        parent[c] = a
    return np.array([find(i) for i in range(n_verts)])


def clean_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    keep_single_cluster: bool = False,
    min_num_cluster: int = 200,
):
    """Connected-component filter (reference clean_mesh, tools/visualizer.py:169-194).
    Returns (verts, faces, vertex_keep_index) with unreferenced vertices removed."""
    roots = _union_find_components(faces, len(verts))
    face_root = roots[faces[:, 0]]
    uniq, counts = np.unique(face_root, return_counts=True)
    if keep_single_cluster:
        keep_roots = {uniq[np.argmax(counts)]}
    else:
        keep_roots = set(uniq[counts >= min_num_cluster])
    fmask = np.array([r in keep_roots for r in face_root])
    faces = faces[fmask]

    used = np.unique(faces.reshape(-1))
    remap = -np.ones(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces], used


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None,
              normals: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY; colors are uint8 RGB."""
    n_v, n_f = len(verts), len(faces)
    props = ["property float x", "property float y", "property float z"]
    vdtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        vdtype += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        vdtype += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n_v}\n" + "\n".join(props) + "\n"
        f"element face {n_f}\nproperty list uchar int vertex_indices\nend_header\n"
    )
    vdata = np.empty(n_v, dtype=vdtype)
    vdata["x"], vdata["y"], vdata["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
    if normals is not None:
        vdata["nx"], vdata["ny"], vdata["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        vdata["red"], vdata["green"], vdata["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    fdata = np.empty(n_f, dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    fdata["n"] = 3
    fdata["idx"] = faces.astype(np.int32)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vdata.tobytes())
        f.write(fdata.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal PLY reader (ascii or binary LE) returning (verts, faces); extra vertex
    properties are skipped. Enough to ingest the datasets' mesh.ply scene meshes."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii").splitlines()
    body = data[header_end:]

    fmt = "ascii"
    n_v = n_f = 0
    vprops = []
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_v = int(parts[2])
            elif cur == "face":
                n_f = int(parts[2])
        elif parts[0] == "property" and cur == "vertex":
            vprops.append((parts[-1], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
                "uchar": "u1", "uint8": "u1", "char": "i1", "int": "<i4", "int32": "<i4",
                "uint": "<u4", "short": "<i2", "ushort": "<u2"}
    if fmt == "ascii":
        text = body.decode("ascii").split("\n")
        verts = np.array([[float(x) for x in text[i].split()[:3]] for i in range(n_v)], np.float32)
        faces = np.array([[int(x) for x in text[n_v + i].split()[1:4]] for i in range(n_f)], np.int64)
        return verts, faces
    vdtype = np.dtype([(name, type_map[t]) for name, t in vprops])
    vdata = np.frombuffer(body, dtype=vdtype, count=n_v)
    verts = np.stack([vdata["x"], vdata["y"], vdata["z"]], -1).astype(np.float32)
    offset = n_v * vdtype.itemsize
    faces = np.empty((n_f, 3), np.int64)
    pos = offset
    for i in range(n_f):
        cnt = np.frombuffer(body, "u1", 1, pos)[0]
        idx = np.frombuffer(body, "<i4", cnt, pos + 1)
        faces[i] = idx[:3]
        pos += 1 + 4 * int(cnt)
    return verts, faces


def oriented_bounds_pca(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """PCA oriented bounding box: returns (to_origin [4,4], extents [3]) with
    trimesh.bounds.oriented_bounds semantics (transform maps the mesh to the
    origin-centered axis-aligned frame)."""
    mean = points.mean(0)
    centered = points - mean
    cov = centered.T @ centered / max(len(points) - 1, 1)
    _, vecs = np.linalg.eigh(cov)
    R = vecs[:, ::-1].T              # rows = principal axes, major first
    if np.linalg.det(R) < 0:
        R[2] = -R[2]
    proj = centered @ R.T
    lo, hi = proj.min(0), proj.max(0)
    extents = hi - lo
    center_local = (lo + hi) / 2
    to_origin = np.eye(4)
    to_origin[:3, :3] = R
    to_origin[:3, 3] = -(R @ mean) - center_local
    return to_origin, extents
