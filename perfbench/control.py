#!/usr/bin/env python3
"""The readings that the comparison's limits are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 3]

For each seed: one short run of the cell at its own load (as long as it
takes to finish the sampled requests), the comparison's numbers of the
served program (the lower readings), and, for the first ``--control-seeds``
seeds, the same numbers of the control: the reference put in the program's
place one precision step lower (the model with bf16 operands in float8
e4m3 and int8 projections in int4; K2's argmin on float8 features; PointDSC
and ICP with TF32 products).  One JSON line a seed; not run by the
benchmark's own runs.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.lib import common, serve_check, weights  # noqa: E402


def control_numbers(cell, data, device) -> dict:
    """The control's worst reading of each number over the run's samples."""
    import numpy as np
    import torch

    from perfbench.reference import pose as ref_pose
    cfg, dev = cell["config"], torch.device(device)
    ref_model = common.reference(cfg)
    pipe = cfg["pipeline"]
    gen = torch.Generator(device=dev).manual_seed(data["seed"])
    ref = ref_model.build(cfg, dev)
    ref.load_state_dict(weights.make_state(ref, gen, dev), strict=True)
    pdsc = ref_pose.build_pointdsc(cfg, dev)
    pdsc.load_state_dict(weights.make_state(pdsc, gen, dev), strict=True)
    low = ref_model.build(cfg, dev, ref_model.Prec(control=True))
    low.load_state_dict(ref.state_dict(), strict=True)
    readings = []
    for s in sorted(data["samples"], key=lambda s: s["draw"]):
        reqs = s["requests"]
        ids = torch.as_tensor(np.stack([data["tokenize"](r["prompt"]) for r in reqs]), device=dev)
        rgb2 = torch.cat([s["rgb_a"], s["rgb_q"]])
        with torch.no_grad():
            towers = dict(s, visual=low.clip_tower(rgb2), guid=low.swin_tower(rgb2),
                          text=low.encode_prompts(ids))
            c = low.head(s["visual"], s["guid"], s["text"])
        # the control in the program's place: each stage on the served state before it
        head = dict(s, featmap_a=c.featmap_a, featmap_q=c.featmap_q, mask_a=c.mask_a,
                    mask_q=c.mask_q)
        nums = serve_check.model_numbers(ref, towers, ids, cfg["model"]["image_hw"])
        h = serve_check.model_numbers(ref, head, ids, cfg["model"]["image_hw"])
        nums.update(feat_err=h["feat_err"], mask_err=h["mask_err"])
        # K2's argmin on float8 operands: the gap of its choice, in f32
        fa, fq = s["featmap_a"].float(), s["featmap_q"].float()
        B, FH, FW, D = fa.shape
        thr = pipe["mask_threshold"]
        ma = (torch.sigmoid(s["mask_a"]) > thr).to(torch.uint8)
        mq = (torch.sigmoid(s["mask_q"]) > thr).to(torch.uint8)
        gen_n = torch.Generator(device=dev).manual_seed(data["noise_seed"])
        for _ in range(s["draw"] + 1):
            noise = ref_pose.draw_noise(gen_n, B, FH * FW, pipe["src_capacity"], dev)
        src, valid = ref_pose.masked_select(ma, noise.match_src, min(pipe["src_capacity"], FH * FW))
        prec = ref_model.Prec(control=True)
        gap = 0.0
        for b in range(B):
            d = ref_pose.source_distances(fa[b:b + 1], fq[b:b + 1], src[b:b + 1], mq[b:b + 1])[0]
            f1 = prec.low(ref_pose.unit(fa[b].reshape(-1, D)[src[b]]))
            f2 = prec.low(ref_pose.unit(fq[b].reshape(-1, D)))
            dl = (0.5 * (1 - f1 @ f2.t())).masked_fill(mq[b].reshape(1, -1) == 0, float("inf"))
            pick = dl.argmin(dim=-1)
            ok = valid[b] & torch.isfinite(d.min(dim=-1).values)
            g = d.gather(1, pick[:, None])[:, 0] - d.min(dim=-1).values
            gap = max(gap, float(g[ok].max())) if bool(ok.any()) else gap
        nums["match_gap"] = gap
        # PointDSC and ICP with TF32 products in the program's place
        with ref_pose.matmul_precision(True), torch.no_grad():
            T_c, conf_c, _ = serve_check.solve(ref_pose, pdsc, s, noise, pipe, ma, mq)
            T_ci = serve_check.solve(ref_pose, pdsc, dict(s, pointdsc_T=T_c), noise, pipe,
                                     ma, mq)[2]
        tf = serve_check.pose_numbers(
            ref_pose, pdsc, dict(s, pointdsc_T=T_c, pointdsc_conf=conf_c, pose=T_ci), noise, pipe)
        nums.update(pointdsc_conf_err=tf["pointdsc_conf_err"], icp_gap_mm=tf["icp_gap_mm"])
        readings.append(nums)
    return serve_check.worst(readings)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="least window of each run; it lasts until the sampled requests are answered")
    args = ap.parse_args(argv)
    common.set_environment()
    cell = common.load_cell(args.workload)
    common.require_cards(cell["workload"]["chips"])
    from perfbench.traffic import serve_closed
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        data = serve_closed.run(cell, seed, args.seconds, False, t0, keep=True)
        data["seed"] = seed
        line = {"seed": seed, "program": data["checks"], "missing": data["missing"],
                "requests": data["requests"]}
        if k < args.control_seeds:
            line["control"] = control_numbers(cell, data, "cuda")
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del data
        import torch
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
