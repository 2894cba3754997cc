"""Dataset asset builders (offline tooling, host only).

Counterpart of ``scripts/make_dataset_assets.py``, on the port's own copy of
``data/meshio.py``; the same commands and the same files.

Consolidates the reference's data-construction scripts:
  * ``detections``: per-image detection txt from the NOCS masks
    (reference scripts/data/make_nocs_data.py / nocs.make_detections,
    utils/data/nocs.py:156-178);
  * ``models_info``: BOP-style models_info.json with axis-range diameters and
    continuous z-symmetries for the NOCS bottle/bowl/can categories
    (reference scripts/data/nocs_bop_models.py:18-66);
  * ``normals``: per-vertex normals from mesh faces (area-weighted face
    normal accumulation — replaces the reference's Open3D estimation,
    scripts/data/make_nocs_obj_normal.py);
  * ``fix_toyl_masks``: split BOP combined masks into per-object visib masks
    (reference scripts/data/fix_bop_masks.py).

Usage:
    python -m oryon_tpu_torch.scripts.make_dataset_assets detections root=data/nocs
    python -m oryon_tpu_torch.scripts.make_dataset_assets models_info root=data/nocs
    python -m oryon_tpu_torch.scripts.make_dataset_assets normals root=data/nocs
"""
from __future__ import annotations

import json
import os
import sys
from os.path import join

import numpy as np

SYMMETRIC_CATEGORIES = ("bottle", "bowl", "can")  # continuous z-symmetry


def build_detections(root: str) -> int:
    """Write <img>_detection.txt next to every NOCS meta/mask pair."""
    from PIL import Image

    split_dir = join(root, "split", "real_test")
    n = 0
    for scene_dir in sorted(os.listdir(split_dir)):
        sdir = join(split_dir, scene_dir)
        for f in sorted(os.listdir(sdir)):
            if not f.endswith("_meta.txt"):
                continue
            base = join(sdir, f[: -len("_meta.txt")])
            mask = np.asarray(Image.open(base + "_mask.png").convert("L"))
            with open(base + "_meta.txt") as fm:
                metas = [line.split(" ") for line in fm.readlines()]
            kept_meta, det_lines = [], []
            for parts in metas:
                mask_id = int(parts[0])
                ys, xs = np.nonzero(mask == mask_id)
                if len(ys) == 0:
                    continue
                x, y = int(xs.min()), int(ys.min())
                w, h = int(xs.max() - x), int(ys.max() - y)
                det_lines.append(f"{mask_id} {x} {y} {w} {h}\n")
                kept_meta.append(" ".join(parts))
            with open(base + "_detection.txt", "w") as fd:
                fd.writelines(det_lines)
            with open(base + "_meta.txt", "w") as fm:
                fm.writelines(kept_meta)
            n += 1
    return n


def build_models_info(root: str) -> str:
    """models_info.json with diameters + continuous symmetries for the
    rotationally symmetric categories."""
    from oryon_tpu_torch.data.meshio import load_nocs_object

    odir = join(root, "obj_models", "real_test")
    infos = {}
    for f in sorted(os.listdir(odir)):
        if not f.endswith("_vertices.txt"):
            continue
        obj = f[: -len("_vertices.txt")]
        model = load_nocs_object(join(odir, obj))
        pts = model["pts"]
        mins, maxs = pts.min(0), pts.max(0)
        info = {
            "diameter": float(np.max(maxs - mins)),
            "min_x": float(mins[0]), "min_y": float(mins[1]),
            "min_z": float(mins[2]),
            "size_x": float(maxs[0] - mins[0]),
            "size_y": float(maxs[1] - mins[1]),
            "size_z": float(maxs[2] - mins[2]),
        }
        if any(obj.startswith(cat) for cat in SYMMETRIC_CATEGORIES):
            info["symmetries_continuous"] = [
                {"axis": [0, 1, 0], "offset": [0, 0, 0]}]
        infos[obj] = info
    out = join(odir, "models_info.json")
    with open(out, "w") as fp:
        json.dump(infos, fp, indent=1)
    return out


def compute_vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals from triangle faces."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    normals = np.zeros_like(v)
    for k in range(3):
        np.add.at(normals, f[:, k], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(lens, 1e-12)


def build_normals(root: str) -> int:
    from oryon_tpu_torch.data.meshio import load_nocs_object

    odir = join(root, "obj_models", "real_test")
    n = 0
    for f in sorted(os.listdir(odir)):
        if not f.endswith(".obj"):
            continue
        obj = f[:-4]
        model = load_nocs_object(join(odir, obj))
        normals = compute_vertex_normals(model["pts"], model["faces"] - 1)
        np.savetxt(join(odir, obj + "_normals.txt"), normals, fmt="%.6f")
        n += 1
    return n


def fix_toyl_masks(root: str) -> int:
    """BOP per-object visib masks (obj_XXXXXX_YYYYYY.png) -> combined
    per-image mask_visib/<img>.png with mask_idx = gt index + 1."""
    from PIL import Image

    split_dir = join(root, "split", "test")
    n = 0
    for scene_dir in sorted(os.listdir(split_dir)):
        sdir = join(split_dir, scene_dir)
        per_obj = join(sdir, "mask_visib_per_obj")
        if not os.path.isdir(per_obj):
            continue
        os.makedirs(join(sdir, "mask_visib"), exist_ok=True)
        by_img = {}
        for f in sorted(os.listdir(per_obj)):
            img_id, gt_idx = os.path.splitext(f)[0].split("_")
            by_img.setdefault(int(img_id), []).append((int(gt_idx), f))
        for img_id, entries in by_img.items():
            combined = None
            for gt_idx, f in sorted(entries):
                m = np.asarray(Image.open(join(per_obj, f)).convert("L")) > 0
                if combined is None:
                    combined = np.zeros(m.shape, np.uint8)
                combined[m] = gt_idx + 1
            Image.fromarray(combined).save(
                join(sdir, "mask_visib", f"{img_id:06d}.png"))
            n += 1
    return n


def main(argv):
    cmd = argv[0]
    kv = dict(a.split("=", 1) for a in argv[1:] if "=" in a)
    root = kv["root"]
    fn = {"detections": build_detections, "models_info": build_models_info,
          "normals": build_normals, "fix_toyl_masks": fix_toyl_masks}[cmd]
    print(fn(root))


if __name__ == "__main__":
    main(sys.argv[1:])
