"""Fixed-split pair construction (dataset builder).

Counterpart of ``scripts/make_pair_split.py``: enumerate the (scene, image,
object) instances of a REAL275 or BOP tree, draw same-object pairs, take the
ground-truth relative pose ``pose_q @ inv(pose_a)``, match the lifted masked
clouds by 3D nearest neighbour within 2 mm (one chunked distance matrix on
the device, ``geometry/pcd.sq_dist_matrix`` in f32 as the JAX package's),
reject pairs with fewer than ``min_corrs`` matches, and write
``fixed_split/<name>/instance_list.txt``, ``annots.pkl`` and ``tracked.txt``.

    python -m oryon_tpu_torch.scripts.make_pair_split dataset.root=data \
        dataset.test.name=nocs split_name=my_test n_pairs=2000 \
        pair_mode=cross_scene [--device cpu]
"""
from __future__ import annotations

import os
import pickle
import sys
import types
from os.path import join

import numpy as np

CHUNK = 4096    # anchor rows a distance matrix


def nearest(warped: np.ndarray, pq: np.ndarray, device="cpu"):
    """For every warped anchor point (mm): the index of its nearest query
    point and the distance to it, in f32 as the JAX package computes them."""
    import torch

    from oryon_tpu_torch.geometry.pcd import sq_dist_matrix

    q = torch.as_tensor(pq, dtype=torch.float32, device=device)
    idx, dist = [], []
    for s in range(0, len(warped), CHUNK):
        a = torch.as_tensor(warped[s:s + CHUNK], dtype=torch.float32, device=device)
        d2 = sq_dist_matrix(a, q)
        nn = d2.argmin(1)     # the first of tied minima, as numpy's argmin
        idx.append(nn)
        dist.append(torch.sqrt(d2.gather(1, nn[:, None])[:, 0]))
    return torch.cat(idx).cpu().numpy(), torch.cat(dist).cpu().numpy()


def subsampled(pa, yx_a, pq, yx_q, rel_pose, subsample=20000, seed=0):
    """The clouds cut to ``subsample`` points each and the anchor cloud
    warped into the query frame: (warped, yx_a, pq, yx_q, the draw state)."""
    rs = np.random.RandomState(seed)
    if len(pa) > subsample:
        ia = rs.choice(len(pa), subsample, replace=False)
        pa, yx_a = pa[ia], yx_a[ia]
    if len(pq) > subsample:
        iq = rs.choice(len(pq), subsample, replace=False)
        pq, yx_q = pq[iq], yx_q[iq]
    warped = pa @ rel_pose[:3, :3].T + rel_pose[:3, 3]
    return warped, yx_a, pq, yx_q, rs


def pcd_correspondences(pa, yx_a, pq, yx_q, rel_pose, th_mm=2.0,
                        max_corrs=10000, subsample=20000, seed=0, device="cpu"):
    """3D-NN matching of the transformed anchor cloud into the query cloud:
    returns [N, 4] (y1, x1, y2, x2)."""
    warped, yx_a, pq, yx_q, rs = subsampled(pa, yx_a, pq, yx_q, rel_pose, subsample, seed)
    nn, dist = nearest(warped, pq, device)
    good = dist < th_mm
    corrs = np.concatenate([yx_a[good], yx_q[nn[good]]], axis=1)
    if len(corrs) > max_corrs:
        corrs = corrs[rs.choice(len(corrs), max_corrs, replace=False)]
    return corrs.astype(np.int32)


def lift_masked(item):
    """Masked RGBD -> (points mm, yx pixels)."""
    depth = np.asarray(item["depth"], np.float64)
    mask = np.asarray(item["mask"]) > 0
    K = np.asarray(item["camera"], np.float64).reshape(3, 3)
    ys, xs = np.nonzero(mask & (depth > 0))
    z = depth[ys, xs]
    pts = np.stack([(xs - K[0, 2]) * z / K[0, 0],
                    (ys - K[1, 2]) * z / K[1, 1], z], 1)
    return pts, np.stack([ys, xs], 1)


def instances_of(name: str, root: str, reader):
    """(scene, image, class id, object) of every annotated object."""
    instances = []
    if name.startswith("nocs"):
        split_dir = join(root, "split/real_test")
        for scene_dir in sorted(os.listdir(split_dir)):
            scene_id = int(scene_dir.split("_")[1])
            for f in sorted(os.listdir(join(split_dir, scene_dir))):
                if not f.endswith("_meta.txt"):
                    continue
                img_id = int(f.split("_")[0])
                with open(join(split_dir, scene_dir, f)) as fm:
                    for line in fm:
                        _mid, cid, obj = line.split(" ")
                        instances.append((scene_id, img_id, int(cid), obj.strip()))
    else:
        for key_, objs in reader.annots.items():
            scene_id, img_id = (int(t) for t in key_.split("_"))
            for cid in objs:
                instances.append((scene_id, img_id, int(cid), cid))
    return instances


def main(argv) -> types.SimpleNamespace:
    """Returns the written directory, the instance lines and the annotations."""
    from oryon_tpu_torch.config import load_config
    from oryon_tpu_torch.data.datasets import pick_reader
    from oryon_tpu_torch.scripts._cli import device as _device
    from oryon_tpu_torch.scripts._cli import overrides

    device = _device(argv)
    kv = dict(a.split("=", 1) for a in overrides(argv))
    split_name = kv.pop("split_name", "custom_split")
    n_pairs = int(kv.pop("n_pairs", "2000"))
    pair_mode = kv.pop("pair_mode", "cross_scene")  # same_scene|cross_scene|any
    seed = int(kv.pop("seed", "0"))
    min_corrs = int(kv.pop("min_corrs", "100"))
    cfg = load_config(None, [f"{k}={v}" for k, v in kv.items()])

    name = cfg.dataset.test.name
    root = join(cfg.dataset.root, name)
    reader = pick_reader(name)(root)
    rs = np.random.RandomState(seed)
    by_obj = {}
    for inst in instances_of(name, root, reader):
        by_obj.setdefault(inst[3], []).append(inst)

    out_dir = join(root, "fixed_split", split_name)
    os.makedirs(out_dir, exist_ok=True)
    lines, annots = [], {}
    attempts = 0
    while len(lines) < n_pairs and attempts < n_pairs * 20:
        attempts += 1
        obj = rs.choice(list(by_obj.keys()))
        cands = by_obj[obj]
        if len(cands) < 2:
            continue
        a, q = [cands[i] for i in rs.choice(len(cands), 2, replace=False)]
        if pair_mode == "cross_scene" and a[0] == q[0]:
            continue
        if pair_mode == "same_scene" and a[0] != q[0]:
            continue
        try:
            item_a = reader.get_item(a[0], a[1], a[3] if name.startswith("nocs") else a[2])
            item_q = reader.get_item(q[0], q[1], q[3] if name.startswith("nocs") else q[2])
        except (AssertionError, FileNotFoundError, KeyError):
            continue
        pose_a = np.asarray(item_a["pose"], np.float64).copy()
        pose_q = np.asarray(item_q["pose"], np.float64).copy()
        rel = pose_q @ np.linalg.inv(pose_a)
        rel_mm = rel.copy()
        rel_mm[:3, 3] *= 1000.0
        pa, yx_a = lift_masked(item_a)
        pq, yx_q = lift_masked(item_q)
        if len(pa) < min_corrs or len(pq) < min_corrs:
            continue
        corrs = pcd_correspondences(pa, yx_a, pq, yx_q, rel_mm, seed=seed, device=device)
        if len(corrs) < min_corrs:
            continue
        key_str = "_".join(str(e) for e in (a[0], a[1], q[0], q[1], a[2], a[3]))
        annots[key_str] = {"gt": rel_mm.astype(np.float32), "corrs": corrs}
        lines.append(f"{pair_mode}, {a[0]} {a[1]}, {q[0]} {q[1]}, {a[2]} {a[3]}\n")
        if len(lines) % 50 == 0:
            print(f"{len(lines)}/{n_pairs} pairs")

    with open(join(out_dir, "instance_list.txt"), "w") as f:
        f.writelines(lines)
    with open(join(out_dir, "annots.pkl"), "wb") as f:
        pickle.dump(annots, f)
    with open(join(out_dir, "tracked.txt"), "w") as f:
        f.writelines(lines[: min(5, len(lines))])
    print(f"wrote {len(lines)} pairs to {out_dir}")
    return types.SimpleNamespace(out_dir=out_dir, lines=lines, annots=annots)


if __name__ == "__main__":
    main(sys.argv[1:])
