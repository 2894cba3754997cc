"""Production-scale synthetic ShapeNet6D-format dataset generator (host only).

Counterpart of ``scripts/make_synthetic_sn6d.py``, on the port's own copy of
``data/templates.py``: the same draws from the same seed, the same tree.

Writes a tree in the layout ``Shapenet6DReader`` reads, so that the
training and evaluation CLIs drive the reader, augmentation, loader and
collate at the reference's scale without the ShapeNetSem assets.  The
benchmark is discriminative: structured, category-coloured textures (a
quarter of the objects nearly uniform, where SIFT starves), a gradient
background whose brightness overlaps the objects, 1-3 occluding distractor
patches a view, and large mixed pose deltas.  Each object is a textured
smooth depth patch rendered under rigid motions by a z-buffer splat; the
ground-truth relative poses are exact and the correspondences come from
canonical-point identity with a 2 mm co-visibility rule.  The val objects
also get point and grid-mesh models for BOP scoring.

Usage:
    python -m oryon_tpu_torch.scripts.make_synthetic_sn6d out=data_synth n_objects=2500 \
        views=4 pairs_per_obj=8 n_val_objects=60 val_pairs_per_obj=4
"""
from __future__ import annotations

import json
import os
import pickle
import sys
from os.path import join

import numpy as np

K640 = np.array([[591.0125, 0, 322.525],
                 [0, 590.16775, 244.11084],
                 [0, 0, 1]], np.float64)


def cam_for(hw):
    """Intrinsics for a frame size, scaled from the 480x640 REAL275 K."""
    oh, ow = hw
    s = np.diag([ow / 640.0, oh / 480.0, 1.0])
    return s @ K640


# (OH, OW, K) per split: train frames are written at model input size so
# the 1-core host loader is not decode/resize-bound at B=32 (~4.4 s/batch
# at 480x640 vs ~0.4 s at 224 — profiled); val keeps the full 480x640 frame
# because VSD renders/compares at the original depth resolution.
TRAIN_HW = (224, 224)
VAL_HW = (480, 640)
CATEGORIES = [
    ("chair", "chair,seat"), ("table", "table,desk"), ("mug", "mug,cup"),
    ("bottle", "bottle,flask"), ("bowl", "bowl,dish"), ("camera", "camera"),
    ("laptop", "laptop,notebook computer"), ("lamp", "lamp,light"),
    ("can", "can,tin"), ("phone", "phone,telephone"), ("clock", "clock"),
    ("vase", "vase,jar"), ("basket", "basket"), ("helmet", "helmet"),
    ("guitar", "guitar"), ("knife", "knife,blade"), ("pot", "pot,planter"),
    ("book", "book"), ("shoe", "shoe,boot"), ("toy", "toy,figurine"),
]
TEXTURE_POOR_FRAC = 0.25   # objects with near-uniform texture (SIFT-hostile)


# the 80 public CLIP ImageNet prompt templates the reference pipeline uses
# (reference datasets.py templates.json; openai/CLIP prompts notebook)
from oryon_tpu_torch.data.templates import CLIP_TEMPLATES as TEMPLATES  # noqa: E402


def _hsv_rgb(h, s, v):
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    return np.array([(v, t, p), (q, v, p), (p, v, t),
                     (p, q, v), (t, p, v), (v, p, q)][i])


def make_texture(rs, oh, ow, cat_idx, poor):
    """Structured, category-colored texture over the canonical grid.

    Low-frequency sinusoid shading on a per-category hue: locally smooth
    (matching cannot key on per-pixel noise), globally class-informative
    (the prompt <-> appearance association is learnable)."""
    hue = (cat_idx / float(len(CATEGORIES)) + rs.uniform(-0.02, 0.02)) % 1.0
    base = _hsv_rgb(hue, rs.uniform(0.45, 0.70), rs.uniform(0.55, 0.85))
    ry = np.arange(oh, dtype=np.float64)[:, None]
    rx = np.arange(ow, dtype=np.float64)[None, :]
    pat = (np.sin(ry / rs.uniform(4, 14) + rs.uniform(0, 6.3))
           + np.sin(rx / rs.uniform(4, 14) + rs.uniform(0, 6.3))
           + np.sin((ry + rx) / rs.uniform(6, 20) + rs.uniform(0, 6.3))) / 3.0
    contrast = 0.03 if poor else rs.uniform(0.20, 0.45)
    shade = 1.0 + contrast * 2.0 * pat
    noise = 0.015 if poor else 0.03
    tex = (base[None, None, :] * shade[..., None]
           + noise * (rs.rand(oh, ow, 3) - 0.5))
    return np.clip(tex, 0.02, 1.0).reshape(-1, 3)


def _pose(rs, ang, shift):
    """Rotation by ``ang`` rad about a random axis + random-direction
    translation of norm ``shift`` meters."""
    axis = rs.randn(3)
    axis /= np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * (Kx @ Kx)
    t = rs.randn(3)
    t = t / np.linalg.norm(t) * shift
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def _view_pose(rs, kind, scale=1.0):
    """Large mixed pose deltas: rotation-dominant or shift-dominant views."""
    if kind == "rot":
        return _pose(rs, rs.uniform(0.35, 0.80) * scale,
                     rs.uniform(0.0, 0.03) * scale)
    return _pose(rs, rs.uniform(0.05, 0.25) * scale,
                 rs.uniform(0.06, 0.15) * scale)


def _surface(rs, hw, K, size_lo, size_hi, z0, margin_frac):
    """Smooth textured depth patch: (points mm in camera frame, grid hw)."""
    OH, OW = hw
    oh = rs.randint(int(OH * size_lo), int(OH * size_hi))
    ow = rs.randint(int(OW * size_lo * 0.75), int(OW * size_hi * 0.75))
    m_y, m_x = int(OH * margin_frac), int(OW * margin_frac)
    oy = rs.randint(m_y, max(OH - oh - m_y, m_y + 1))
    ox = rs.randint(m_x, max(OW - ow - m_x, m_x + 1))
    ry = np.arange(oh, dtype=np.float64)[:, None]
    rx = np.arange(ow, dtype=np.float64)[None, :]
    zs = (z0 + rs.uniform(15, 30) * np.sin(ry / rs.uniform(18, 30))
          + rs.uniform(12, 25) * np.cos(rx / rs.uniform(20, 35))
          + rs.uniform(0.2, 0.5) * ry + rs.uniform(0.2, 0.5) * rx)
    ys, xs = np.mgrid[oy:oy + oh, ox:ox + ow]
    ys, xs, z = ys.ravel(), xs.ravel(), zs.ravel()
    pts = np.stack([(xs - K[0, 2]) * z / K[0, 0],
                    (ys - K[1, 2]) * z / K[1, 1], z], 1)  # mm
    return pts, (oh, ow)


def make_canonical(rs, hw, K, cat_idx, poor):
    """Canonical textured target surface (points mm in view-0 camera frame)."""
    pts, grid = _surface(rs, hw, K, 0.19, 0.32, rs.uniform(620.0, 780.0),
                         1.0 / 8.0)
    tex = make_texture(rs, grid[0], grid[1], cat_idx, poor)
    return pts, tex, grid


def make_distractors(rs, hw, K, target_cat, z_ref):
    """1-3 clutter patches from OTHER categories, anywhere in frame (may
    occlude the target: z is sampled around the target depth)."""
    out = []
    for _ in range(rs.randint(1, 4)):
        cat = rs.randint(len(CATEGORIES) - 1)
        if cat >= target_cat:
            cat += 1
        z0 = z_ref + rs.uniform(-140.0, 200.0)
        pts, grid = _surface(rs, hw, K, 0.10, 0.22, z0, 0.02)
        out.append((pts, make_texture(rs, grid[0], grid[1], cat, False)))
    return out


def render_scene(tgt_pts, tgt_tex, T, distractors, rs, hw, K):
    """Rigid-move the target, z-buffer splat target + distractors.

    Returns (depth mm, target-only mask, rgb, per-canonical-target-point
    pixel coords + visibility, visible fraction)."""
    OH, OW = hw
    p_t = (tgt_pts / 1000.0 @ T[:3, :3].T + T[:3, 3]) * 1000.0  # mm
    n_t = p_t.shape[0]
    pts_all = [p_t] + [d[0] for d in distractors]
    tex_all = [tgt_tex] + [d[1] for d in distractors]
    P = np.concatenate(pts_all, 0)
    TX = np.concatenate(tex_all, 0)

    z = P[:, 2]
    u = P[:, 0] / z * K[0, 0] + K[0, 2]
    v = P[:, 1] / z * K[1, 1] + K[1, 2]
    in_frame = (u >= 1) & (u < OW - 1) & (v >= 1) & (v < OH - 1) & (z > 1)
    ui = np.clip(np.round(u).astype(int), 0, OW - 1)
    vi = np.clip(np.round(v).astype(int), 0, OH - 1)

    depth = np.full((OH, OW), np.inf, np.float32)
    uin, vin, zin = ui[in_frame], vi[in_frame], z[in_frame]
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            vv = np.clip(vin + dv, 0, OH - 1)
            uu = np.clip(uin + du, 0, OW - 1)
            np.minimum.at(depth, (vv, uu), zin.astype(np.float32))

    # background: smooth gradient field with brightness overlapping the
    # objects — no threshold shortcut for segmentation
    yy, xx = np.mgrid[0:OH, 0:OW].astype(np.float64)
    bg = (0.45
          + 0.22 * np.sin(yy / rs.uniform(25, 70) + rs.uniform(0, 6.3))
          * np.cos(xx / rs.uniform(25, 70) + rs.uniform(0, 6.3))
          + 0.10 * np.sin((yy + xx) / rs.uniform(40, 90) + rs.uniform(0, 6.3))
          + 0.12 * (rs.rand(OH, OW) - 0.5))
    tint = rs.uniform(0.75, 1.05, 3)
    rgb = np.clip(bg[..., None] * tint[None, None, :], 0.02, 1.0).astype(
        np.float32)
    order = np.argsort(-zin)  # far -> near: nearest surface paints last
    rgb[vin[order], uin[order]] = TX[in_frame][order]

    # per-canonical-target-point visibility (z-buffer 2 mm agreement:
    # handles self-occlusion AND distractor occlusion)
    vi_t, ui_t = vi[:n_t], ui[:n_t]
    vis = in_frame[:n_t] & (np.abs(depth[vi_t, ui_t] - p_t[:, 2]) < 2.0)

    # target-only mask: splat of VISIBLE target points
    mask = np.zeros((OH, OW), np.uint8)
    uv, vv_ = ui_t[vis], vi_t[vis]
    for dv in (-1, 0, 1):
        for du in (-1, 0, 1):
            mask[np.clip(vv_ + dv, 0, OH - 1), np.clip(uv + du, 0, OW - 1)] = 1

    depth = np.where(np.isinf(depth), 0.0, depth)
    return depth, mask, rgb, vi_t, ui_t, vis, vis.mean()


def save_view(root, img_id, depth, mask, rgb, pose, cls_id, K):
    from PIL import Image
    Image.fromarray(np.clip(rgb * 255, 0, 255).astype(np.uint8)).save(
        join(root, "raw_data", "rgb", f"{img_id:06d}.jpg"), quality=92)
    Image.fromarray(mask).save(join(root, "raw_data", "mask", f"{img_id:06d}.png"))
    Image.fromarray(np.clip(depth, 0, 65535).astype(np.uint16)).save(
        join(root, "raw_data", "depth", f"{img_id:06d}.png"))
    return {"K": K.copy(), "obj_info_lst": [{}, {"cls_id": cls_id,
                                                 "RT": pose[:3, :].copy()}]}


def main(argv):
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out = kv.get("out", "data_synth")
    n_objects = int(kv.get("n_objects", "2500"))
    views = int(kv.get("views", "4"))
    pairs_per_obj = int(kv.get("pairs_per_obj", "8"))
    n_val_objects = int(kv.get("n_val_objects", "60"))
    val_pairs_per_obj = int(kv.get("val_pairs_per_obj", "4"))
    seed = int(kv.get("seed", "0"))
    max_corrs = int(kv.get("max_corrs", "2000"))

    root = join(out, "shapenet6d")
    for sub in ("rgb", "mask", "depth"):
        os.makedirs(join(root, "raw_data", sub), exist_ok=True)
    os.makedirs(join(root, "models"), exist_ok=True)

    rs = np.random.RandomState(seed)
    annots_gt = {}
    meta_lines = ['fullId,x,category,wnlemmas,name,z\n']
    objnm2clsid = {}
    splits = {"train": ([], {}), "val": ([], {})}
    img_id = 0
    total = n_objects + n_val_objects
    rel_angles, vis_fracs = [], []

    for oid in range(total):
        split = "train" if oid < n_objects else "val"
        cat_idx = oid % len(CATEGORIES)
        cat, lemmas = CATEGORIES[cat_idx]
        name = f"obj{oid:05d}"
        meta_lines.append(f'wss.{name},0,{cat},"{lemmas}",{name}_model,0\n')
        objnm2clsid[f"{name}_0"] = oid

        hw = TRAIN_HW if split == "train" else VAL_HW
        Kc = cam_for(hw)
        poor = rs.rand() < TEXTURE_POOR_FRAC
        pts, tex, grid = make_canonical(rs, hw, Kc, cat_idx, poor)
        z_ref = float(np.median(pts[:, 2]))
        view_data = []
        for vI in range(views):
            kind = "rot" if vI % 2 == 1 else "shift"
            for attempt in range(25):
                T = (np.eye(4) if vI == 0 else
                     _view_pose(rs, kind, 1.0 / (1 + attempt * 0.15)))
                dists = make_distractors(rs, hw, Kc, cat_idx, z_ref)
                depth, mask, rgb, vi, ui, vis, frac = render_scene(
                    pts, tex, T, dists, rs, hw, Kc)
                if frac > 0.55:
                    break
            vis_fracs.append(frac)
            annots_gt[img_id] = save_view(root, img_id, depth, mask, rgb, T,
                                          oid, Kc)
            view_data.append((img_id, T, vi, ui, vis))
            img_id += 1

        # val-split object model: subsampled points (mm, canonical frame)
        # + stride-4 grid mesh for VSD renders
        if split == "val":
            oh, ow = grid
            sub = rs.choice(len(pts), min(512, len(pts)), replace=False)
            s = 4
            gy, gx = np.mgrid[0:oh:s, 0:ow:s]
            idx2d = (gy * ow + gx)
            Vg = pts[idx2d.ravel()]
            ny, nx = idx2d.shape
            faces = []
            for yy in range(ny - 1):
                for xx in range(nx - 1):
                    a = yy * nx + xx
                    faces += [[a, a + 1, a + nx], [a + 1, a + nx + 1, a + nx]]
            d = float(np.linalg.norm(pts.max(0) - pts.min(0)))
            np.savez_compressed(join(root, "models", f"obj_{oid:05d}.npz"),
                                pts=pts[sub].astype(np.float32),
                                mesh_vertices=Vg.astype(np.float32),
                                mesh_faces=np.asarray(faces, np.int32),
                                diameter=np.float32(d))

        # pairs among this object's views (ordered, no self-pairs); only
        # combos that keep >=100 co-visible GT corrs survive occlusion +
        # the large pose deltas (reference >=100-corr filter,
        # make_nocs_test.py:237)
        lines, annots = splits[split]
        n_pairs = pairs_per_obj if split == "train" else val_pairs_per_obj
        combos = [(i, j) for i in range(views) for j in range(views) if i != j]
        good = []
        for i, j in combos:
            co = view_data[i][4] & view_data[j][4]
            if int(co.sum()) >= 100:
                good.append((i, j))
        if not good:
            continue
        pick = rs.choice(len(good), min(n_pairs, len(good)), replace=False)
        for ci in pick:
            i, j = good[ci]
            (ia, Ta, va, ua, visa) = view_data[i]
            (iq, Tq, vq, uq, visq) = view_data[j]
            co = visa & visq
            idx = np.nonzero(co)[0]
            if len(idx) > max_corrs:
                idx = idx[rs.choice(len(idx), max_corrs, replace=False)]
            corrs = np.stack([va[idx], ua[idx], vq[idx], uq[idx]], 1).astype(np.int32)
            rel = Tq @ np.linalg.inv(Ta)
            rel_angles.append(np.degrees(np.arccos(
                np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1))))
            rel_mm = rel.copy()
            rel_mm[:3, 3] *= 1000.0
            key = f"0_{ia}_0_{iq}_{oid}_{oid}"
            annots[key] = {"gt": rel_mm.astype(np.float32), "corrs": corrs}
            lines.append(f"synth, 0 {ia}, 0 {iq}, {oid} {oid}\n")
        if (oid + 1) % 100 == 0:
            print(f"{oid + 1}/{total} objects ({img_id} images)", flush=True)

    with open(join(root, "templates.json"), "w") as f:
        json.dump(TEMPLATES, f)
    with open(join(root, "scene_gt.pkl"), "wb") as f:
        pickle.dump(annots_gt, f)
    with open(join(root, "metadata.csv"), "w") as f:
        f.writelines(meta_lines)
    with open(join(root, "objnm2clsid.json"), "w") as f:
        json.dump(objnm2clsid, f)
    for split, (lines, annots) in splits.items():
        d = join(root, "fixed_split", split)
        os.makedirs(d, exist_ok=True)
        with open(join(d, "instance_list.txt"), "w") as f:
            f.writelines(lines)
        with open(join(d, "annots.pkl"), "wb") as f:
            pickle.dump(annots, f)
        with open(join(d, "tracked.txt"), "w") as f:
            f.writelines(lines[: min(3, len(lines))])
        print(f"{split}: {len(lines)} pairs")
    if rel_angles:
        a = np.asarray(rel_angles)
        print(f"relative rotation: mean {a.mean():.1f} deg, p10 "
              f"{np.percentile(a, 10):.1f}, p90 {np.percentile(a, 90):.1f}")
    print(f"target visible fraction: mean {np.mean(vis_fracs):.2f}")
    print(f"wrote {img_id} images under {root}")


if __name__ == "__main__":
    main(sys.argv[1:])
