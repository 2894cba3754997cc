"""Host-side mesh/point-cloud file loaders (numpy only, no plyfile/open3d).

The port's own copy of ``oryon_tpu/data/meshio.py``.  Formats required by
the datasets:
  * NOCS objects: ``<obj>_vertices.txt`` / ``<obj>_normals.txt`` +
    face lines of ``<obj>.obj`` (reference utils/data/nocs.py:59-92);
  * TOYL/BOP objects: ``obj_XXXXXX.ply`` with vertex normals
    (reference utils/data/toyl.py:54-80 via plyfile — reimplemented here
    for ascii and binary_little_endian PLY).
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ: v lines + f lines (1-based, '/'-separated indices)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append([float(p[1]), float(p[2]), float(p[3])])
            elif line.startswith("f "):
                p = line.split()[1:]
                idx = [int(tok.split("/")[0]) - 1 for tok in p[:3]]
                faces.append(idx)
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def load_nocs_object(basepath: str) -> Dict[str, np.ndarray]:
    """NOCS real_test object: vertices/normals txt (meters -> mm) + obj faces.
    Mirrors reference get_obj_rendering (utils/data/nocs.py:59-92), including
    the x1000 unit conversion and 1-based face indices in the .obj."""
    pts = np.loadtxt(basepath + "_vertices.txt", dtype=np.float64)
    normals = np.loadtxt(basepath + "_normals.txt", dtype=np.float64)
    faces = []
    with open(basepath + ".obj") as f:
        for line in f:
            if line.startswith("f"):
                p = line.split()[1:]
                faces.append([int(tok.split("/")[0]) for tok in p[:3]])
    return {
        "pts": np.asarray(pts) * 1000.0,
        "normals": np.asarray(normals),
        "faces": np.asarray(faces, np.int64),
    }


_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """PLY loader (ascii + binary_little_endian) for vertex xyz/normals and
    triangular faces."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = "ascii"
    elements = []  # (name, count, [(type, prop) or ('list', ctype, itype, prop)])
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[1], tok[2]))

    out: Dict[str, np.ndarray] = {}
    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                rows.append(lines[li].split())
                li += 1
            if name == "vertex":
                cols = {p[-1]: i for i, p in enumerate(props)}
                arr = np.asarray([[float(v) for v in r] for r in rows])
                out["vertex"] = arr
                out["vertex_props"] = cols  # type: ignore[assignment]
            elif name == "face":
                out["faces"] = np.asarray(
                    [[int(v) for v in r[1:4]] for r in rows], np.int64)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if all(p[0] != "list" for p in props):
                fmt_str = "<" + "".join(_PLY_TYPES[p[0]][0] for p in props)
                size = struct.calcsize(fmt_str)
                arr = np.frombuffer(body, dtype=np.dtype(
                    [(p[-1], "<" + _PLY_TYPES[p[0]][0]) for p in props]),
                    count=count, offset=off)
                off += size * count
                if name == "vertex":
                    out["vertex"] = arr
                    out["vertex_props"] = {p[-1]: i for i, p in enumerate(props)}  # type: ignore
            else:
                rows = []
                for _ in range(count):
                    (ctype, itype, _pname) = props[0][1], props[0][2], props[0][3]
                    cfmt, csz = _PLY_TYPES[ctype]
                    n = struct.unpack_from("<" + cfmt, body, off)[0]
                    off += csz
                    ifmt, isz = _PLY_TYPES[itype]
                    vals = struct.unpack_from("<" + ifmt * n, body, off)
                    off += isz * n
                    rows.append(list(vals[:3]))
                if name == "face":
                    out["faces"] = np.asarray(rows, np.int64)
    else:
        raise ValueError(f"unsupported PLY format {fmt}")
    return out


def load_bop_object(path: str) -> Dict[str, np.ndarray]:
    """BOP model PLY -> dict(pts [mm], normals, faces) — reference
    utils/data/toyl.py:54-80 semantics."""
    ply = load_ply(path)
    v = ply["vertex"]
    if isinstance(v, np.ndarray) and v.dtype.names:
        pts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
        if "nx" in v.dtype.names:
            normals = np.stack([v["nx"], v["ny"], v["nz"]], 1).astype(np.float64)
        else:
            normals = np.zeros_like(pts)
    else:
        cols = ply["vertex_props"]
        pts = v[:, [cols["x"], cols["y"], cols["z"]]]
        if "nx" in cols:
            normals = v[:, [cols["nx"], cols["ny"], cols["nz"]]]
        else:
            normals = np.zeros_like(pts)
    return {"pts": pts, "normals": normals, "faces": ply.get("faces")}
