"""Cross-check the scoring rasteriser against OpenGL depth dumps.

Counterpart of ``scripts/check_vsd_vs_gl.py``: the window rasteriser of
``eval/renderer.py`` (the VSD path of scoring), on the device, against the
depth a reference OpenGL renderer wrote for the same pose.  One ``.npz``
per view:

    required  K [3,3] f32, R_gt [3,3], t_gt [3] (mm), depth_gt [H,W] f32 mm
    mesh      vertices [V,3] (mm) + faces [F,3] int, or mesh_path (str) to a
              PLY/OBJ, resolved relative to the npz
    optional  R_est / t_est + depth_est, and depth_test [H,W] (the measured
              scene depth, mm): enables the VSD-recall comparison; diameter
              (float, mm; default from the vertices)

    python -m oryon_tpu_torch.scripts.check_vsd_vs_gl dump1.npz [dump2.npz ...] \
        [--window 160] [--json out.json] [--device cpu]

Reports per dump: pixels rendered by one rasteriser only, the largest and
mean depth difference where both render, and the VSD recall from the GL
depths against the recall from ours.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_mesh(z, npz_path, device="cpu"):
    """(padded Mesh on ``device``, vertices [V, 3] mm)."""
    from oryon_tpu_torch.eval.renderer import pad_mesh
    if "vertices" in z:
        V = np.asarray(z["vertices"], np.float32)
        F = np.asarray(z["faces"], np.int32)
    else:
        mesh_path = str(z["mesh_path"])
        if not os.path.isabs(mesh_path):
            mesh_path = os.path.join(os.path.dirname(npz_path), mesh_path)
        from oryon_tpu_torch.data.meshio import load_obj, load_ply
        if mesh_path.endswith(".ply"):
            m = load_ply(mesh_path)
            V, F = m["pts"], m["faces"]
        else:
            V, F = load_obj(mesh_path)
        V = np.asarray(V, np.float32)
        F = np.asarray(F, np.int32)
    return pad_mesh(V, F, device=device), V


def our_render(mesh, R, t, K, hw, window):
    """The scoring path: the window rasteriser placed over the projected
    bbox, embedded back into the full frame (host array)."""
    import torch

    from oryon_tpu_torch.eval.renderer import projected_bbox, render_depth_window
    dev = mesh.vertices.device
    R, t, K = (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (R, t, K))
    H, W = hw
    lo, hi, any_front = projected_bbox(mesh, R, t, K, hw=hw)
    if not bool(any_front):
        return np.zeros(hw, np.float32)
    (y0, x0), (y1, x1) = lo.cpu().numpy().astype(int), hi.cpu().numpy().astype(int)
    hw_need = (int(y1 - y0 + 1), int(x1 - x0 + 1))
    win = (max(window, hw_need[0] + 8), max(window, hw_need[1] + 8))
    cy, cx = (y0 + y1) // 2, (x0 + x1) // 2
    oy = int(np.clip(cy - win[0] // 2, 0, max(H - win[0], 0)))
    ox = int(np.clip(cx - win[1] // 2, 0, max(W - win[1], 0)))
    d = render_depth_window(mesh, R, t, K, torch.tensor([oy, ox], device=dev),
                            window=win).cpu().numpy()
    full = np.zeros(hw, np.float32)
    yl = min(win[0], H - oy)
    xl = min(win[1], W - ox)
    full[oy:oy + yl, ox:ox + xl] = d[:yl, :xl]
    return full


def compare_depths(d_gl, d_ours, label):
    both = (d_gl > 0) & (d_ours > 0)
    only_gl = int(((d_gl > 0) & ~(d_ours > 0)).sum())
    only_ours = int((~(d_gl > 0) & (d_ours > 0)).sum())
    if both.sum() == 0:
        return {"label": label, "covered_both": 0, "only_gl": only_gl,
                "only_ours": only_ours, "mean_abs_mm": float("nan"),
                "max_abs_mm": float("nan")}
    err = np.abs(d_gl[both] - d_ours[both])
    return {"label": label, "covered_both": int(both.sum()),
            "only_gl": only_gl, "only_ours": only_ours,
            "mean_abs_mm": float(err.mean()), "max_abs_mm": float(err.max()),
            "p99_abs_mm": float(np.percentile(err, 99))}


def check_dump(path, window, taus, delta, device="cpu"):
    import torch

    from oryon_tpu_torch.eval.bop import vsd_errors, vsd_recall
    z = np.load(path, allow_pickle=True)
    K = np.asarray(z["K"], np.float32)
    hw = tuple(np.asarray(z["depth_gt"]).shape)
    mesh, V = load_mesh(z, path, device)
    diameter = float(z["diameter"]) if "diameter" in z else float(
        np.linalg.norm(V.max(0) - V.min(0)))

    report = {"dump": path}
    d_gt_gl = np.asarray(z["depth_gt"], np.float32)
    d_gt_ours = our_render(mesh, z["R_gt"], z["t_gt"], K, hw, window)
    report["gt"] = compare_depths(d_gt_gl, d_gt_ours, "gt-pose render")

    if "depth_est" in z and "depth_test" in z:
        d_est_gl = np.asarray(z["depth_est"], np.float32)
        d_est_ours = our_render(mesh, z["R_est"], z["t_est"], K, hw, window)
        report["est"] = compare_depths(d_est_gl, d_est_ours, "est-pose render")

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        def recall(d_est, d_gt):
            errs = vsd_errors(dev(d_est), dev(d_gt), dev(z["depth_test"]), dev(K), delta,
                              taus, diameter)
            return float(vsd_recall(errs))

        r_gl = recall(d_est_gl, d_gt_gl)
        r_ours = recall(d_est_ours, d_gt_ours)
        report["vsd_recall_gl"] = r_gl
        report["vsd_recall_ours"] = r_ours
        report["vsd_recall_delta"] = r_ours - r_gl
    return report


def main(argv=None):
    from oryon_tpu_torch.scripts._cli import device as _device
    ap = argparse.ArgumentParser()
    ap.add_argument("dumps", nargs="+")
    ap.add_argument("--window", type=int, default=160)
    ap.add_argument("--delta", type=float, default=15.0)
    ap.add_argument("--taus", type=float, nargs="*",
                    default=[0.05 * i for i in range(1, 11)])
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = _device(["--device", args.device])

    reports = []
    for p in args.dumps:
        r = check_dump(p, args.window, args.taus, args.delta, device)
        reports.append(r)
        g = r["gt"]
        line = (f"{p}: both={g['covered_both']}px only_gl={g['only_gl']} "
                f"only_ours={g['only_ours']} mean|dz|={g['mean_abs_mm']:.3f}mm "
                f"max|dz|={g['max_abs_mm']:.3f}mm")
        if "vsd_recall_delta" in r:
            line += (f" | VSD recall gl={r['vsd_recall_gl']:.4f} "
                     f"ours={r['vsd_recall_ours']:.4f} "
                     f"delta={r['vsd_recall_delta']:+.4f}")
        print(line)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=1)
    return reports


if __name__ == "__main__":
    main()
