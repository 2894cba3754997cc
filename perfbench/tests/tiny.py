"""A cell cut to a size the CPU runs in seconds, for the tests: the same
modules and pipeline, tiny towers in float32, small frames."""
import copy

from perfbench.lib import common

TINY = {"dtype": "float32", "swin_image_size": 64,
        "vision": {"image_size": 56, "patch_size": 14, "width": 64, "layers": 2, "heads": 4},
        "text": {"vocab_size": 600, "context_length": 16, "width": 32, "layers": 2, "heads": 4,
                 "embed_dim": 48},
        "fusion": {"hidden_dim": 128, "text_guidance_dim": 48, "text_guidance_proj_dim": 128,
                   "appearance_guidance_dim": 512, "appearance_proj_dim": 128, "num_layers": 2,
                   "nheads": 4, "window": 2, "pooling": 2, "num_prompts": 8, "clip_dim": 64,
                   "clip_proj_dim": 48}}


def tiny_cell(name: str) -> dict:
    cell = common.load_cell(name)
    cell["config"]["model"].update(copy.deepcopy(TINY))
    cell["workload"].update(frame_hw=[120, 160], pool_pairs=8, check_within=1,
                            check_requests=1, trace_requests=2, label_requests=1,
                            warmup_requests=0)
    return cell
