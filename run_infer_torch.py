#!/usr/bin/env python
"""Serving CLI of the PyTorch port: relative 6D pose from raw RGB-D pairs and
a prompt.  Counterpart of ``run_infer.py`` with the same arguments; it loads a
checkpointed model once and answers pose queries from plain image files, a
single pair or a JSONL request stream.

Single pair:
    python run_infer_torch.py --anchor-rgb a.png --anchor-depth a_d.png \
        --query-rgb q.png --query-depth q_d.png \
        --camera "591.0,590.2,322.5,244.1" --prompt "mug" \
        exp_name=myrun eval.ckpt=last [model.size=full] [out=pose.json]

Request stream (one JSON object per line; keys: anchor{rgb,depth[,mask]},
query{...}, camera [or per-view anchor.camera], prompt[, id]):
    python run_infer_torch.py --requests pairs.jsonl exp_name=myrun eval.ckpt=last

``--config FILE`` reads a YAML config first; ``key=value`` overrides use the
config tree's grammar (test.solver, test.mask, dataset.batch_size,
model.quant=int8, model.attn_impl=flash, ...).  ``--device`` (default
``cuda``) chooses where the engine runs; ``--device cpu`` runs the plain
PyTorch versions of the kernels.  Outputs one JSON line per pair: {"id",
"prompt", "pose" (4x4 T_anchor->query, meters), "n_corrs",
"detection_valid"}.
"""
from __future__ import annotations

import json
import sys


def _flag(argv, name, default=None):
    for i, a in enumerate(argv):
        if a == name:
            return argv[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return default


def read_requests(argv, load_view):
    """The request list of a command line: every line of ``--requests``, or
    the one pair of the ``--anchor-*`` / ``--query-*`` flags.  ``load_view``
    turns a view's file spec into arrays."""
    reqs = []
    req_file = _flag(argv, "--requests")
    if req_file:
        with open(req_file) as f:
            for li, line in enumerate(f):
                if not line.strip():
                    continue
                d = json.loads(line)
                cam = d.get("camera")
                for side in ("anchor", "query"):
                    v = dict(d[side])
                    v.setdefault("camera", cam)
                    d[side] = load_view(v)
                d.setdefault("id", str(li))
                reqs.append(d)
        return reqs
    cam = _flag(argv, "--camera")
    if cam is None:
        raise SystemExit("need --camera (or --requests file)")
    reqs.append({
        "anchor": load_view({"rgb": _flag(argv, "--anchor-rgb"),
                             "depth": _flag(argv, "--anchor-depth"),
                             "mask": _flag(argv, "--anchor-mask"),
                             "camera": cam}),
        "query": load_view({"rgb": _flag(argv, "--query-rgb"),
                            "depth": _flag(argv, "--query-depth"),
                            "mask": _flag(argv, "--query-mask"),
                            "camera": cam}),
        "prompt": _flag(argv, "--prompt", "object"),
        "id": "0",
    })
    return reqs


def serve(cfg, reqs, out_path=None, device="cuda"):
    """Build the engine for ``reqs`` (depth frame of the first request, batch
    of at most ``cfg.dataset.batch_size``), answer them and write one JSON
    line per request to ``out_path`` or the standard output."""
    from oryon_tpu_torch.infer import OryonPredictor

    dhw = reqs[0]["anchor"]["depth"].shape
    bs = min(int(cfg.dataset.batch_size), max(1, len(reqs)))
    engine = OryonPredictor.from_config(cfg, batch_size=bs, depth_hw=dhw,
                                        device=device)
    results = engine.predict(reqs)

    sink = open(out_path, "w") if out_path else sys.stdout
    try:
        for req, res in zip(reqs, results):
            res = dict(res, id=req["id"])
            sink.write(json.dumps(res) + "\n")
    finally:
        if out_path:
            sink.close()
            print(f"wrote {len(results)} results -> {out_path}")
    return results


def main(argv):
    overrides = [a for a in argv if "=" in a and not a.startswith("--")]
    cfg_path = _flag(argv, "--config")
    out_path = next((o.split("=", 1)[1] for o in overrides
                     if o.startswith("out=")), None)
    overrides = [o for o in overrides if not o.startswith("out=")]

    from oryon_tpu_torch.config import load_config
    cfg = load_config(cfg_path, overrides)

    from oryon_tpu_torch.infer import load_view
    reqs = read_requests(argv, load_view)
    serve(cfg, reqs, out_path, device=_flag(argv, "--device", "cuda"))


if __name__ == "__main__":
    main(sys.argv[1:])
