"""Marching tetrahedra isosurface extraction on the SDF's device.

Counterpart of ``gs2d_tpu/ops/marching.py`` (which replaces the
reference's skimage marching cubes, ``utils/mcube_utils.py:17-95``). Each
voxel cube is split into 6 tetrahedra; every tet contributes 0-2
triangles with vertices linearly interpolated on crossing edges, oriented
so normals point toward positive SDF (outside), and vertices are welded on
a 1/1024-voxel lattice. ``marching_tets`` is torch on the SDF's device
(the NumPy original stacks 8 corner arrays, 8.4 GB of host memory at the
bounded path's 640³ grid): cubes are scanned in X-slabs, positions are
float64 as there, and the weld sorts lattice keys as ``np.unique(axis=0)``
does, so the vertex order and the face indices are the JAX package's.
``largest_clusters`` stays on the host (NumPy/SciPy).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# cube corner offsets (x, y, z)
_CORNERS = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))

# six tetrahedra covering the cube (indices into _CORNERS, sharing the
# main diagonal 0-6)
_TETS = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6),
         (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


def _interp(p_a, p_b, f_a, f_b):
    """Crossing of the edge a→b; t in the SDF's dtype, positions in
    float64, as in the NumPy original."""
    diff = f_a - f_b
    t = f_a / torch.where(torch.abs(diff) < 1e-12, 1e-12, diff)
    t = torch.clamp(t, 0.0, 1.0)[..., None].to(p_a.dtype)
    return p_a + t * (p_b - p_a)


def _active_cubes(sdf, mask, slab_cubes):
    """Cubes with a sign change and all 8 corners valid, in C order →
    (cube index (C, 3) int64, corner values (C, 8))."""
    X, Y, Z = sdf.shape
    bx = max(1, slab_cubes // max((Y - 1) * (Z - 1), 1))
    idx, vals = [], []
    for x0 in range(0, X - 1, bx):
        x1 = min(x0 + bx, X - 1)

        def corner(a, c):
            dx, dy, dz = _CORNERS[c]
            return a[x0 + dx:x1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]

        v = torch.stack([corner(sdf, c) for c in range(8)], -1)
        valid = torch.stack([corner(mask, c) for c in range(8)], -1).all(-1)
        sign = v < 0
        active = valid & sign.any(-1) & (~sign).any(-1)
        where = torch.nonzero(active)
        where[:, 0] += x0
        idx.append(where)
        vals.append(v[active])
    return torch.cat(idx), torch.cat(vals)


def _lone_and_others(ins):
    """For rows with exactly one True in ``ins`` (C, 4): the True's index
    and the other three in increasing order (np.argsort of ~ins, stable)."""
    order = torch.argsort((~ins).to(torch.int8), dim=-1, stable=True)
    return order[:, 0], order[:, 1:]


def marching_tets(sdf: torch.Tensor, origin=np.zeros(3), voxel_size=1.0,
                  mask: Optional[torch.Tensor] = None,
                  slab_cubes: int = 1 << 22
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """sdf (X, Y, Z) → (vertices (V, 3) f32, faces (F, 3) int64), on the
    SDF's device. Isolevel 0; negative = inside. ``mask`` marks valid
    voxels (e.g. weight > 0)."""
    dev = sdf.device
    X, Y, Z = sdf.shape
    if mask is None:
        mask = torch.ones_like(sdf, dtype=torch.bool)
    empty = (torch.zeros((0, 3), dtype=torch.float32, device=dev),
             torch.zeros((0, 3), dtype=torch.int64, device=dev))
    if min(X, Y, Z) < 2:
        return empty
    idx, cube_vals = _active_cubes(sdf, mask, slab_cubes)
    if idx.shape[0] == 0:
        return empty
    corners = torch.tensor(_CORNERS, dtype=torch.float64, device=dev)
    corner_pos = idx.to(torch.float64)[:, None, :] + corners[None]  # (C,8,3)

    tris = []
    for tet in _TETS:
        tet_i = torch.tensor(tet, device=dev)
        f = cube_vals[:, tet_i]                    # (C, 4)
        p = corner_pos[:, tet_i]                   # (C, 4, 3)
        n_in = (f < 0).sum(-1)
        for n_target, flip in ((1, False), (3, True)):
            sel = n_in == n_target
            if not bool(sel.any()):
                continue
            fi, pi = f[sel], p[sel]
            # the lone vertex (inside for n=1, outside for n=3)
            lone, others = _lone_and_others((fi >= 0) if flip else (fi < 0))
            rows = torch.arange(fi.shape[0], device=dev)
            pl = pi[rows, lone]
            fl = fi[rows, lone]
            tris.append(torch.stack([
                _interp(pl, pi[rows, others[:, k]], fl,
                        fi[rows, others[:, k]]) for k in range(3)], dim=1))

        sel = n_in == 2
        if bool(sel.any()):
            fi, pi = f[sel], p[sel]
            order = torch.argsort((fi >= 0).to(torch.int8), dim=-1,
                                  stable=True)
            a, b, c, d = order.unbind(-1)          # a, b inside
            rows = torch.arange(fi.shape[0], device=dev)
            pac = _interp(pi[rows, a], pi[rows, c], fi[rows, a], fi[rows, c])
            pad = _interp(pi[rows, a], pi[rows, d], fi[rows, a], fi[rows, d])
            pbc = _interp(pi[rows, b], pi[rows, c], fi[rows, b], fi[rows, c])
            pbd = _interp(pi[rows, b], pi[rows, d], fi[rows, b], fi[rows, d])
            tris.append(torch.stack([pac, pbc, pbd], 1))
            tris.append(torch.stack([pac, pbd, pad], 1))

    tri = torch.cat(tris, 0)                       # (T, 3, 3) voxel coords

    # orient: normal should point from inside (f<0) to outside (f>0) —
    # approximate SDF gradient by forward differences at the centroid
    cent = tri.mean(1)
    hi = torch.tensor([X - 2, Y - 2, Z - 2], device=dev)
    ci = torch.minimum(torch.clamp(torch.round(cent).to(torch.int64), min=0),
                       hi)
    s0 = sdf[ci[:, 0], ci[:, 1], ci[:, 2]]
    grad = torch.stack([sdf[ci[:, 0] + 1, ci[:, 1], ci[:, 2]] - s0,
                        sdf[ci[:, 0], ci[:, 1] + 1, ci[:, 2]] - s0,
                        sdf[ci[:, 0], ci[:, 1], ci[:, 2] + 1] - s0], -1)
    nrm = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = (nrm * grad).sum(-1) < 0
    tri[flip] = tri[flip].flip(1)

    verts, faces = _weld(tri.reshape(-1, 3))
    faces = faces.reshape(-1, 3)
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    faces = faces[ok]
    origin = torch.as_tensor(origin, device=dev)
    verts_world = verts * voxel_size + origin
    return verts_world.to(torch.float32), faces


def _packed_keys(pos: torch.Tensor):
    """Rows of int64 lattice keys → one int64 per row that sorts as the
    rows do lexicographically (21 bits per axis, offset to be
    non-negative), or None where the keys span too much for that."""
    lo = pos.amin(0)
    if bool((pos.amax(0) - lo >= (1 << 21)).any()):
        return None
    q = pos - lo
    return (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]


def unique_rows(keys: torch.Tensor):
    """``np.unique(keys, axis=0, return_inverse=True, return_counts=True)``
    for non-empty (n, 3) int64 rows → (number of unique rows, inverse,
    counts), through one packed key where it fits."""
    packed = _packed_keys(keys)
    uniq, inv, counts = torch.unique(
        keys if packed is None else packed, dim=0 if packed is None else None,
        return_inverse=True, return_counts=True)
    return uniq.shape[0], inv, counts


def _weld(flat: torch.Tensor):
    """Dedupe vertices on the 1/1024-voxel lattice: each welded vertex is
    the mean of the positions that share its key."""
    keys = torch.round(flat * 1024.0).to(torch.int64)
    n, inv, counts = unique_rows(keys)
    verts = torch.zeros((n, 3), dtype=flat.dtype, device=flat.device)
    verts.index_add_(0, inv, flat)
    verts /= counts[:, None].to(flat.dtype)
    return verts, inv


def largest_clusters(verts: np.ndarray, faces: np.ndarray,
                     num_clusters: int = 1, min_faces: int = 0):
    """Keep the largest EDGE-connected face clusters (Open3D's
    cluster_connected_triangles post-process, reference
    utils/mesh_utils.py:22-43): every cluster smaller than
    max(num_clusters-th largest, min_faces) triangles goes; when fewer
    clusters exist than num_clusters the floor is the smallest. NumPy /
    SciPy on the host → (verts, faces, kept_vertex_indices)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    if len(faces) == 0:
        return verts, faces, np.arange(n)
    F = len(faces)
    # canonical (min, max) edge keys, 3 per face
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]]).astype(np.int64)
    e.sort(axis=1)
    keys = e[:, 0] * np.int64(n) + e[:, 1]
    uniq_keys, edge_id = np.unique(keys, return_inverse=True)
    E = len(uniq_keys)
    face_id = np.tile(np.arange(F, dtype=np.int64), 3)
    # bipartite edge↔face graph: a component = one edge-connected cluster
    g = sp.coo_matrix(
        (np.ones(3 * F, np.int8), (edge_id, E + face_id)),
        shape=(E + F, E + F))
    _, labels = connected_components(g, directed=False)
    face_label = labels[E + np.arange(F)]
    sizes = np.bincount(face_label, minlength=int(labels.max()) + 1)
    present = np.sort(sizes[sizes > 0])[::-1]
    kth = int(present[min(num_clusters, len(present)) - 1])
    thresh = max(kth, min_faces, 1)
    keep = sizes[face_label] >= thresh
    faces2 = faces[keep]
    used = np.unique(faces2)
    remap = -np.ones(n, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces2], used
