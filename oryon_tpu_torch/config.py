"""Single-tree configuration system.

The port's own copy of ``oryon_tpu/config.py``: the same tree of nested
dataclasses, the same YAML loading and dotted-path ``a.b.c=value``
overrides, so one ``configs/config.yaml`` and one set of overrides drive
both packages (a test holds ``flatten(load_config(...))`` of the two equal).
The serving path of the port reads ``model.size/quant/attn_impl``,
``test.*``, ``dataset.img_size/batch_size``, ``pretrained.*``, ``eval.ckpt``
and ``seed``; the training, mesh and precision fields are carried so that a
config file of the JAX package loads unchanged.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Dict, List, Optional, Tuple


@lru_cache(maxsize=None)
def _yaml12_loader():
    """SafeLoader with YAML-1.2 bool semantics: only true/false parse as
    booleans; yes/no/on/off stay literal strings.  This keeps string-valued
    keys (test.add_description: yes) intact in both config files and
    overrides; bool-valued keys still accept yes/on via _apply's coercion.
    yaml is imported here, not with the module: the serving engine reads the
    dataclass defaults and needs no yaml unless a file or override is parsed."""
    import yaml

    class Yaml12Loader(yaml.SafeLoader):
        pass

    Yaml12Loader.yaml_implicit_resolvers = {
        ch: [(tag, rx) for tag, rx in resolvers
             if tag != "tag:yaml.org,2002:bool"]
        for ch, resolvers in yaml.SafeLoader.yaml_implicit_resolvers.items()
    }
    Yaml12Loader.add_implicit_resolver(
        "tag:yaml.org,2002:bool",
        re.compile(r"^(?:true|True|TRUE|false|False|FALSE)$"),
        list("tTfF"))
    return Yaml12Loader


@dataclass
class TrainSplitConfig:
    name: str = "shapenet6d"
    split: str = "custom_train"
    obj: str = "all"


@dataclass
class TestSplitConfig:
    name: str = "nocs"
    split: str = "cross_scene_test"
    obj: str = "all"


@dataclass
class DatasetConfig:
    root: str = "data"
    batch_size: int = 32
    img_size: Tuple[int, int] = (224, 224)
    max_corrs: int = 500
    # in-RAM decoded-item cache (GiB; 0 disables)
    cache_gib: float = 16.0
    train: TrainSplitConfig = field(default_factory=TrainSplitConfig)
    test: TestSplitConfig = field(default_factory=TestSplitConfig)


@dataclass
class ImageEncoderConfig:
    img_size: Tuple[int, int] = (192, 192)
    out_channels: int = 32
    extra_upsampling: bool = True
    vlm: str = "clip"
    use_decoder_guidance: bool = True
    use_cost_guidance: bool = True
    decoder_type: str = "standard"


@dataclass
class ModelConfig:
    use_catseg_ckpt: bool = True
    size: str = "full"  # full | small | tiny (small/tiny for smoke tests)
    # Inference quantization. "int8": the CLIP vision tower's projections
    # run int8 x int8 -> int32 (models/quant.py); "none" = bf16.  Only the
    # full size has the int8 tower: small/tiny resolve to "none"
    # (models/oryon.py resolve_quant).
    quant: str = "int8"
    # train the CLIP-vision + Swin towers jointly with fusion/decoder
    # (training only; the serving path does not read it)
    train_towers: bool = False
    # CLIP vision-tower attention (models/clip.py MultiHeadAttention):
    # "fused" = attention kernel on the packed in_proj output (default);
    # "fused_i8qk" = the same with int8 logits (about 1% logit noise);
    # "flash" = streaming kernel on [B, H, L, D]; einsum/auto = plain.
    # Ignored for small/tiny (models/oryon.py resolve_attn_impl).
    attn_impl: str = "fused"
    # training-time quantization (training only)
    train_quant: str = "none"
    image_encoder: ImageEncoderConfig = field(default_factory=ImageEncoderConfig)


@dataclass
class LossWeights:
    mask: float = 1.0
    pos: float = 0.5
    neg: float = 0.5


@dataclass
class LossConfig:
    hard_negatives: bool = True
    pos_margin: float = 0.2
    neg_margin: float = 0.9
    neg_kernel_size: int = 5
    mask_type: str = "dice"
    neg_pool: int = 2000  # hardest-negative candidate pool
    w: LossWeights = field(default_factory=LossWeights)


@dataclass
class TestConfig:
    mask: str = "predicted"  # predicted | oracle | ovseg
    add_description: str = "yes"
    src_sampling: int = 5000
    solver: str = "pointdsc"  # pointdsc | ransac
    n_corrs: int = 500
    dist_th: float = 0.25
    mask_threshold: float = 0.5
    only_save_masks: bool = False
    only_save_featmaps: bool = False
    # dense trimmed-ICP refinement of the solver pose on the masked depth
    # clouds (pipeline.PipelineConfig icp_*; geometry/kabsch.py masked_icp);
    # these defaults are the single source for the serving path
    icp_refine: bool = True
    icp_points: int = 1024
    icp_iters: int = 48
    icp_trim: float = 0.6


@dataclass
class OptimizationConfig:
    optim_type: str = "Adam"
    scheduler_type: str = "cosine"
    lr: float = 1e-3
    momentum: float = 0.0
    w_decay: float = 5e-4
    gamma: float = 0.1


@dataclass
class TrainingConfig:
    n_epochs: int = 20
    freq_save: int = 5
    freq_valid: int = 5
    accum_steps: int = 1          # gradient-accumulation micro-batches
    rss_restart_gib: float = 64.0  # host-RSS bound for a checkpointed restart


@dataclass
class RGBAugConfig:
    jitter: bool = True
    bright: bool = True
    hflip: bool = True
    vflip: bool = True
    device: bool = True   # colour/flip augmentation on the device


@dataclass
class TextAugConfig:
    synset: bool = True


@dataclass
class AugConfig:
    rgb: RGBAugConfig = field(default_factory=RGBAugConfig)
    text: TextAugConfig = field(default_factory=TextAugConfig)


@dataclass
class PretrainedConfig:
    pointdsc: str = "pretrained_models/pointdsc"
    vocabulary: str = "pretrained_models/bpe_simple_vocab_16e6.txt.gz"
    clip: str = "pretrained_models/clip_vit_l14_336.npz"
    swin: str = "pretrained_models/swin_b.npz"
    catseg: str = "pretrained_models/catseg.npz"


@dataclass
class EvalConfig:
    ckpt: Optional[str] = None
    results: Optional[str] = None
    vsd_window: int = 256   # side of the square VSD render window, px


@dataclass
class MeshConfig:
    """Device-mesh layout of the JAX package (the port serves on one card)."""

    data: int = -1  # -1 = all devices on the data axis
    model: int = 1  # optional tensor-parallel axis for the ViT encoder


@dataclass
class PrecisionConfig:
    compute_dtype: str = "bfloat16"  # activations in the frozen/compute path
    param_dtype: str = "float32"
    matching_dtype: str = "float32"  # NN-matching similarity accumulation


@dataclass
class Config:
    exp_name: str = "baseline"
    exp_root: str = "exp_data"
    exp_tag: str = "Ours"
    use_seed: bool = False
    seed: int = 1
    compute_vsd: bool = True
    viz_valid: bool = False
    debug_valid: bool = False
    profiler: bool = False
    resume_ckpt: str = "none"
    # warm-start params (only) from another experiment's checkpoint:
    # '<exp_name>', '<exp_name>:<epoch|last>' or a path to an 'epoch=NNNN' dir
    init_params_from: str = "none"

    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    test: TestConfig = field(default_factory=TestConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    augs: AugConfig = field(default_factory=AugConfig)
    pretrained: PretrainedConfig = field(default_factory=PretrainedConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)


def _apply(obj: Any, key: str, value: Any) -> None:
    parts = key.split(".")
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"Unknown config key: {key}")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"Unknown config key: {key}")
    cur = getattr(obj, leaf)
    if isinstance(cur, tuple) and isinstance(value, (list, tuple)):
        value = tuple(value)
    elif isinstance(cur, bool) and isinstance(value, str):
        value = value.lower() in ("1", "true", "yes", "on")
    elif cur is not None and not isinstance(cur, (dict, list, tuple)) and not dataclasses.is_dataclass(cur):
        value = type(cur)(value)
    setattr(obj, leaf, value)


def _merge_dict(obj: Any, d: Dict[str, Any], prefix: str = "") -> None:
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict) and dataclasses.is_dataclass(getattr(obj, k, None)):
            _merge_dict(getattr(obj, k), v)
        else:
            _apply(obj, key, v)


def load_config(path: Optional[str] = None, overrides: Optional[List[str]] = None) -> Config:
    """Build a Config from an optional YAML file plus ``a.b.c=value`` overrides."""
    import yaml

    cfg = Config()
    if path is not None:
        with open(path) as f:
            data = yaml.load(f, Loader=_yaml12_loader()) or {}
        _merge_dict(cfg, data)
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        try:
            value = yaml.load(raw, Loader=_yaml12_loader())
        except yaml.YAMLError:
            value = raw
        _apply(cfg, key.strip(), value)
    return cfg


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)


def flatten(cfg: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten the config tree to dotted keys."""
    out: Dict[str, Any] = {}
    for f_ in dataclasses.fields(cfg):
        v = getattr(cfg, f_.name)
        key = f"{prefix}{f_.name}"
        if dataclasses.is_dataclass(v):
            out.update(flatten(v, key + "."))
        else:
            out[key] = v
    return out
