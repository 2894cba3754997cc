#!/usr/bin/env python
"""Export checkpoints of the JAX package (orbax) for the PyTorch port.

The port reads a JAX-trained checkpoint entry from ``params.npz`` inside its
``epoch=NNNN/`` directory: a flat npz of the entry's params tree with
'/'-joined flax paths (``params/vlm_visual/...``).  This script writes that
file next to the orbax data, for one entry or for every entry of an
experiment.  It needs JAX, flax and orbax, so it runs where the JAX package
runs, not on a machine with the port alone.

Usage:
    python scripts/export_params_npz.py exp_data/prod40/models/epoch=0019
    python scripts/export_params_npz.py exp_root=exp_data exp_name=prod40
"""
from __future__ import annotations

import os
import re
import sys

import numpy as np

ENTRY = re.compile(r"epoch=(\d+)")


def export_entry(epoch_dir: str) -> str:
    """Write ``<epoch_dir>/params.npz`` from the orbax entry; returns its path."""
    import orbax.checkpoint as ocp
    from flax.traverse_util import flatten_dict

    raw = ocp.PyTreeCheckpointer().restore(os.path.abspath(epoch_dir))
    flat = flatten_dict(raw["params"])
    out = os.path.join(epoch_dir, "params.npz")
    np.savez(out, **{"/".join(k): np.asarray(v) for k, v in flat.items()})
    return out


def entries(models_dir: str):
    """The ``epoch=NNNN`` entries of a models directory, by epoch."""
    found = [(int(m.group(1)), os.path.join(models_dir, name))
             for name in os.listdir(models_dir) if (m := ENTRY.fullmatch(name))]
    return [path for _, path in sorted(found)]


def main(argv):
    """Returns the written paths."""
    paths = [a for a in argv if "=" not in a or ENTRY.fullmatch(os.path.basename(a))]
    if paths:
        todo = paths
    else:
        kv = dict(a.split("=", 1) for a in argv if "=" in a)
        models = os.path.join(kv.get("exp_root", "exp_data"), kv["exp_name"], "models")
        todo = entries(models)
        if not todo:
            raise FileNotFoundError(f"no epoch=NNNN entries under {models}")
    written = [export_entry(p) for p in todo]
    for p in written:
        print(f"wrote {p}")
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
