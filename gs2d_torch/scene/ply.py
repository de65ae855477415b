"""Minimal binary-little-endian PLY codec (no plyfile dependency).

NumPy copy of ``gs2d_tpu/scene/ply.py`` (the port imports nothing from the
JAX package).

Covers Gaussian checkpoints with the exact 3DGS-ecosystem attribute order
x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,scale_*,rot_*
(reference ``scene/gaussian_model.py:176-207``), so models interchange with
the reference tooling and with the JAX package; triangle meshes
(``write_mesh_ply``/``read_mesh_ply``) and seed point clouds
(x,y,z[,nx,ny,nz][,red,green,blue]).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Reads the first 'vertex' element into {property: column}."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    fmt = None
    props: List[Tuple[str, str]] = []
    count = 0
    in_vertex = False
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            in_vertex = t[1] == "vertex"
            if in_vertex:
                count = int(t[2])
        elif t[0] == "property" and in_vertex:
            props.append((t[2], _PLY_DTYPES[t[1]]))
    if fmt == "ascii":
        # slice exactly the vertex element's tokens — the body may hold
        # further elements (faces) whose rows are NOT vertex columns
        need = count * len(props)
        body = data[end:].decode("ascii").split()[:need]
        if len(body) < need:
            raise ValueError(
                f"ascii PLY vertex element truncated: {len(body)} tokens "
                f"for {count}x{len(props)}")
        arr = np.array(body, np.float64).reshape(count, len(props))
        return {name: arr[:, i].astype(np.dtype(dt).newbyteorder("="))
                for i, (name, dt) in enumerate(props)}
    assert fmt == "binary_little_endian", f"unsupported PLY format {fmt}"
    dtype = np.dtype([(name, dt) for name, dt in props])
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=end)
    return {name: np.ascontiguousarray(arr[name]) for name, _ in props}


def write_ply(path: str, columns: Dict[str, np.ndarray],
              dtypes: Dict[str, str] | None = None) -> None:
    names = list(columns.keys())
    n = len(next(iter(columns.values())))
    dtypes = dtypes or {}
    fields = [(name, dtypes.get(name, "<f4")) for name in names]
    rec = np.empty(n, dtype=np.dtype(fields))
    for name, dt in fields:
        rec[name] = np.asarray(columns[name]).astype(dt)

    def ply_type(dt: str) -> str:
        return {"<f4": "float", "<f8": "double", "u1": "uchar",
                "<i4": "int", "<u4": "uint"}[dt]

    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, dt in fields:
            f.write(f"property {ply_type(dt)} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                   colors: np.ndarray | None = None) -> None:
    """Triangle mesh with optional per-vertex uchar colors."""
    n, m = len(verts), len(faces)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    rec = np.empty(n, np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
    if colors is not None:
        c8 = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8) \
            if colors.dtype != np.uint8 else colors
        rec["red"], rec["green"], rec["blue"] = c8[:, 0], c8[:, 1], c8[:, 2]
    frec = np.empty(m, np.dtype([("n", "u1"), ("v", "<i4", (3,))]))
    frec["n"] = 3
    frec["v"] = faces.astype(np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(b"property uchar red\nproperty uchar green\n"
                    b"property uchar blue\n")
        f.write(f"element face {m}\n".encode())
        f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(rec.tobytes())
        f.write(frec.tobytes())


def read_mesh_ply(path: str):
    """Reads a triangle mesh written by write_mesh_ply (or compatible
    binary_little_endian PLY with uchar-count int-index face lists)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    elems = []          # (name, count, props)
    cur = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "element":
            cur = (t[1], int(t[2]), [])
            elems.append(cur)
        elif t[0] == "property" and cur is not None:
            cur[2].append(t)
    off = end
    verts = faces = colors = None
    for name, count, props in elems:
        if name == "vertex":
            fields = [(p[2], _PLY_DTYPES[p[1]]) for p in props]
            dt = np.dtype(fields)
            arr = np.frombuffer(data, dt, count, off)
            off += dt.itemsize * count
            verts = np.stack([arr["x"], arr["y"], arr["z"]],
                             -1).astype(np.float32)
            if "red" in arr.dtype.names:
                colors = np.stack([arr["red"], arr["green"], arr["blue"]],
                                  -1).astype(np.float32) / 255.0
        elif name == "face":
            dt = np.dtype([("n", "u1"), ("v", "<i4", (3,))])
            arr = np.frombuffer(data, dt, count, off)
            off += dt.itemsize * count
            faces = arr["v"].astype(np.int64)
    return verts, faces, colors


def read_point_cloud(path: str):
    """(points (N,3) f32, colors (N,3) f32 in [0,1], normals (N,3) f32)."""
    cols = read_ply(path)
    pts = np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
    if "red" in cols:
        int_typed = np.issubdtype(cols["red"].dtype, np.integer)
        rgb = np.stack([cols["red"], cols["green"], cols["blue"]],
                       -1).astype(np.float32)
        # scale by STORED dtype, not a value heuristic (an all-dark
        # uint8 cloud would otherwise skip the /255 and load 1/255 as
        # full intensity; empty clouds made .max() raise)
        if int_typed:
            rgb = rgb / 255.0
    else:
        rgb = np.full_like(pts, 0.5)
    if "nx" in cols:
        nrm = np.stack([cols["nx"], cols["ny"], cols["nz"]],
                       -1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return pts, rgb, nrm


def write_point_cloud(path: str, points: np.ndarray, colors: np.ndarray,
                      normals: np.ndarray | None = None) -> None:
    if normals is None:
        normals = np.zeros_like(points)
    c8 = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8) \
        if colors.dtype != np.uint8 else colors
    write_ply(path, {
        "x": points[:, 0], "y": points[:, 1], "z": points[:, 2],
        "nx": normals[:, 0], "ny": normals[:, 1], "nz": normals[:, 2],
        "red": c8[:, 0], "green": c8[:, 1], "blue": c8[:, 2],
    }, dtypes={"red": "u1", "green": "u1", "blue": "u1"})
