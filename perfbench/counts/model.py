"""Model FLOPs of a served request, from the configuration's shapes.

The reference model's forward over one request's pairs is traced on the
``meta`` device under ``torch.utils.flop_counter.FlopCounterMode``: every
matrix product, convolution and attention product is counted from its shapes
(two operations a multiply-add), nothing is computed.  The prompt
embeddings come from the engine's cache, so the text tower is not counted.
The int8 projections count as many operations as bf16 ones, and the
utilisation holds them all against the bf16 peak."""
from __future__ import annotations

import functools
import json


@functools.lru_cache(maxsize=8)
def _request_flops(cfg_json: str, pairs: int) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from perfbench.lib.common import reference

    cfg = json.loads(cfg_json)
    m = cfg["model"]
    with torch.device("meta"):
        model = reference(cfg).Oryon(cfg)
        rgb = torch.zeros((pairs, *m["image_hw"], 3), dtype=torch.uint8)
        text = torch.zeros((pairs, m["fusion"]["num_prompts"], m["text"]["embed_dim"]))
        with FlopCounterMode(display=False) as fc:
            model(rgb, rgb, text)
    return fc.get_total_flops()


def request_flops(cfg: dict, pairs: int) -> int:
    """FLOPs of the model's forward over ``pairs`` pairs (both views)."""
    return _request_flops(json.dumps(cfg, sort_keys=True), pairs)


def clip_vision_flops(image_size: int, patch: int, width: int, layers: int) -> int:
    """The CLIP vision tower of one image by hand: the patch convolution,
    then per layer q|k|v, the two attention products, the output projection
    and the 4x MLP over the tokens and the class token."""
    g = image_size // patch
    T = g * g + 1
    per_layer = 2 * T * width * 3 * width + 4 * T * T * width + 2 * T * width * width \
        + 2 * 2 * T * width * 4 * width
    return 2 * g * g * 3 * patch * patch * width + layers * per_layer
