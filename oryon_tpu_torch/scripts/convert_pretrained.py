"""One-shot converter: the published torch checkpoints -> npz archives.

Counterpart of ``scripts/convert_pretrained.py`` (host work, no device):

    python -m oryon_tpu_torch.scripts.convert_pretrained clip=<ViT-L-14-336px.pt> \
        swin=<swin_b-weights.pth> catseg=<catseg.pth> out=pretrained_models

writes ``clip_vit_l14_336.npz``, ``swin_b.npz`` and ``catseg.npz``, the
files ``models/pretrained.load_pretrained_params`` reads.
"""
from __future__ import annotations

import os
import sys

import numpy as np

OUTPUTS = (("clip", "clip_vit_l14_336.npz"), ("swin", "swin_b.npz"),
           ("catseg", "catseg.npz"))


def main(argv):
    from oryon_tpu_torch.models.convert import load_torch_state

    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    out = kv.get("out", "pretrained_models")
    os.makedirs(out, exist_ok=True)
    for key, name in OUTPUTS:
        if key in kv:
            sd = load_torch_state(kv[key])
            np.savez(os.path.join(out, name), **sd)
            print(f"wrote {out}/{name} ({len(sd)} tensors)")


if __name__ == "__main__":
    main(sys.argv[1:])
