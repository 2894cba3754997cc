"""Serving engine: pose from raw RGB-D pairs and a text prompt.

Counterpart of ``OryonPredictor`` in ``oryon_tpu/infer.py``: a long-lived
object that answers "here are two RGB-D views and a prompt; where did the
object move?" requests at a fixed batch size and depth resolution.  Short
tails are padded with the first request and dropped from the results; text
embeddings are memoised per prompt string.  ``from_config`` builds the
engine from the config tree (``config.load_config``), where a user chooses
the attention kernels (``model.attn_impl=...``), merges the pretrained
towers and restores the experiment's checkpoint (``eval.ckpt``);
``load_view`` reads a view from files; ``run_infer_torch.py`` is the CLI.

Several GPUs (one process per device, ``torchrun``): ``from_config`` takes
the mesh of ``cfg.mesh`` by the JAX engine's policy (``parallel.serving_mesh``)
and, with ``mesh.model`` above 1, shards the towers over it
(``parallel.tp.shard_params_tp``).  Every rank calls ``predict`` with the
same requests; each computes its rows of a batch and every rank returns the
same answers.

Request dict: {"anchor": {"rgb": [H,W,3] u8, "depth": [Ho,Wo] mm,
"camera": K, "mask": optional [H,W] u8}, "query": {...}, "prompt": str}.
Result dict: {"pose": 4x4 T_anchor->query (metres), "n_corrs": int,
"detection_valid": bool, "prompt": str, "mask_a"/"mask_q": optional}.
"""
from __future__ import annotations

import json
from os.path import splitext
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from oryon_tpu_torch.checkpoint import restore_checkpoint
from oryon_tpu_torch.config import TestConfig
from oryon_tpu_torch.data.pair_batch import PairBatch, PairView
from oryon_tpu_torch.data.templates import CLIP_TEMPLATES
from oryon_tpu_torch.models.layers import random_init_
from oryon_tpu_torch.models.oryon import (build_model, resolve_attn_impl,
                                          resolve_quant)
from oryon_tpu_torch.models.pretrained import load_pretrained_params
from oryon_tpu_torch.models.tokenizer import ClipTokenizer
from oryon_tpu_torch.ops.matching import MatchParams
from oryon_tpu_torch.parallel.mesh import place_params, serving_mesh
from oryon_tpu_torch.parallel.tp import shard_params_tp
from oryon_tpu_torch.pipeline import (PipelineConfig, build_pointdsc_solver, make_run_fn,
                                      pointdsc_weights_available, split_over_data)
from oryon_tpu_torch.utils.profiling import count, span


def _load_array(path: str) -> np.ndarray:
    """A .npy / .npz array (the first of an archive), else any PIL image."""
    if splitext(path)[1] in (".npy", ".npz"):
        arr = np.load(path)
        return arr[arr.files[0]] if hasattr(arr, "files") else arr
    from PIL import Image

    return np.asarray(Image.open(path))


def load_view(spec: Dict) -> Dict:
    """Load one view's arrays from a file spec {rgb, depth, camera[, mask]}.

    rgb: png/jpg (any PIL format) -> [H, W, 3] uint8
    depth: 16-bit png (mm) or .npy/.npz float/int array (mm)
    camera: any form ``parse_camera`` takes
    mask: optional png (nonzero = object) or .npy/.npz
    """
    from PIL import Image

    out: Dict = {"rgb": np.asarray(Image.open(spec["rgb"]).convert("RGB")),
                 "depth": np.asarray(_load_array(spec["depth"]), np.float32),
                 "camera": parse_camera(spec["camera"])}
    if spec.get("mask"):
        mask = _load_array(spec["mask"])
        if mask.ndim == 3:
            mask = mask[..., 0]
        out["mask"] = (mask > 0).astype(np.uint8)
    return out


def parse_camera(spec) -> np.ndarray:
    """Accepts a 9-float K (row-major), {"fx","fy","cx","cy"} or {"K": ...},
    a file path (.json/.txt), or an inline "fx,fy,cx,cy" string."""
    if isinstance(spec, np.ndarray):
        return np.asarray(spec, np.float32).reshape(9)
    if isinstance(spec, dict):
        if "K" in spec:
            return np.asarray(spec["K"], np.float32).reshape(9)
        return np.array([spec["fx"], 0, spec["cx"],
                         0, spec["fy"], spec["cy"], 0, 0, 1], np.float32)
    if isinstance(spec, (list, tuple)):
        vals = np.asarray(spec, np.float32)
        if vals.size == 9:
            return vals.reshape(9)
        fx, fy, cx, cy = vals
        return np.array([fx, 0, cx, 0, fy, cy, 0, 0, 1], np.float32)
    s = str(spec)
    if s.endswith(".json"):
        with open(s) as f:
            return parse_camera(json.load(f))
    if s.endswith(".txt"):
        with open(s) as f:
            return parse_camera([float(v) for v in f.read().split()])
    return parse_camera([float(v) for v in s.split(",")])


def full_precision_matmuls() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions, process-wide.

    Pose math (lifting, Kabsch, PointDSC, ICP) must run in full float32, the
    counterpart of the JAX package's ``fp32_matmul`` policy; TF32 keeps
    about three decimal digits.  The model itself computes in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def model_from_config(cfg, generator: Optional[torch.Generator] = None):
    """The model of the config tree, on the host: ``cfg.model.size/quant/
    attn_impl`` and the towers of ``cfg.model.image_encoder.vlm`` (clip |
    eva02); weights random from ``generator`` (default: seeded with
    ``cfg.seed`` if ``cfg.use_seed`` else 1), then the pretrained assets at
    size full (the report printed), then the checkpoint ``cfg.eval.ckpt``
    of the experiment.  Returns (model, epoch): the restored epoch, -1 when
    the experiment has no such checkpoint, None when ``eval.ckpt`` is empty."""
    size = cfg.model.size
    model = build_model(size, quant=resolve_quant(size, cfg.model.quant),
                        attn_impl=resolve_attn_impl(size, cfg.model.attn_impl),
                        vlm=cfg.model.image_encoder.vlm)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed if cfg.use_seed else 1)
    random_init_(model, generator)
    if size == "full":
        for line in load_pretrained_params(cfg, model):
            print(line)
    epoch = None
    if cfg.eval.ckpt is not None and str(cfg.eval.ckpt) != "":
        epoch, _ = restore_checkpoint(cfg, model, str(cfg.eval.ckpt))
    return model, epoch


class OryonPredictor:
    """Long-lived inference engine over a fixed (batch, depth-frame) shape.

    ``model`` (an ``OryonModel``) and ``pointdsc`` hold their weights and are
    moved to ``device``.  Building a predictor calls
    ``full_precision_matmuls`` (TF32 off, process-wide).
    """

    def __init__(self, model, pointdsc=None, *, device, batch_size: int = 8,
                 img_size=(224, 224), depth_hw=(480, 640),
                 mask_source: str = "predicted", solver: str = "ransac",
                 n_corrs: int = 500, dist_th: float = 0.25,
                 mask_threshold: float = 0.5, vocabulary: str = "",
                 seed: int = 0, tokenize_fn=None, icp_refine=None,
                 icp_points=None, icp_iters=None, icp_trim=None, mesh=None):
        full_precision_matmuls()
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.mesh = mesh
        if mesh is not None:
            place_params(self.model, mesh)
        self.pointdsc = None if pointdsc is None else pointdsc.to(self.device).eval()
        self.B = int(batch_size)
        self.img_size = tuple(img_size)
        self.depth_hw = tuple(depth_hw)
        if tokenize_fn is None:
            # prompt shape follows the model: P templates x L context tokens
            tokenizer = ClipTokenizer(vocabulary)
            templates = CLIP_TEMPLATES[:model.fusion_cfg.num_prompts]
            ctx = model.text_cfg.context_length

            def tokenize_fn(prompt: str) -> np.ndarray:
                return tokenizer([t.format(prompt) for t in templates],
                                 context_length=ctx)

        self._tokenize = tokenize_fn
        # ICP settings left at None follow the shipped TestConfig defaults,
        # so the direct constructor and ``from_config`` agree
        tc = TestConfig()
        cfg = PipelineConfig(
            mask_source=mask_source, mask_threshold=mask_threshold, solver=solver,
            icp_refine=tc.icp_refine if icp_refine is None else bool(icp_refine),
            icp_points=tc.icp_points if icp_points is None else int(icp_points),
            icp_iters=tc.icp_iters if icp_iters is None else int(icp_iters),
            icp_trim=tc.icp_trim if icp_trim is None else float(icp_trim),
            match=MatchParams(src_capacity=5120, max_corrs=n_corrs, dist_th=dist_th))
        self._run = split_over_data(make_run_fn(self.model, cfg, self.pointdsc), mesh)
        self._text_cache: Dict[str, torch.Tensor] = {}
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._max_corrs = n_corrs

    @classmethod
    def from_config(cls, cfg, *, batch_size: Optional[int] = None,
                    depth_hw=(480, 640), device="cuda",
                    generator: Optional[torch.Generator] = None
                    ) -> "OryonPredictor":
        """Build from the config tree (``config.Config``): the model by
        ``cfg.model.size/quant/attn_impl``, every ``cfg.test.*`` setting, and
        the configured solver, falling back to RANSAC with a warning when no
        trained PointDSC weights exist.  Runs on the card unless the caller
        passes ``device="cpu"``.

        Weights, in this order: random, drawn from ``generator`` (default:
        seeded with ``cfg.seed`` if ``cfg.use_seed`` else 1); the pretrained
        towers, fusion and decoder when ``cfg.model.size == "full"`` (each
        asset optional, the report printed); the checkpoint ``cfg.eval.ckpt``
        ("last" or an epoch number) of the experiment ``cfg.exp_root`` /
        ``cfg.exp_name``.  An experiment without checkpoints prints a warning
        and serves the weights it has.  All of it happens on the host; the
        constructor then moves the one copy to ``device``."""
        model, epoch = model_from_config(cfg, generator)
        if epoch is not None:
            if epoch >= 0:
                print(f"loaded checkpoint epoch {epoch}")
            else:
                print(f"WARNING: eval.ckpt={cfg.eval.ckpt!r} not found; "
                      "serving current (pretrained/random) params")
        solver, pointdsc = cfg.test.solver, None
        if solver == "pointdsc":
            if pointdsc_weights_available(cfg.pretrained.pointdsc):
                pointdsc = build_pointdsc_solver(cfg.pretrained.pointdsc)
            else:
                print("WARNING: PointDSC snapshot absent; serving with "
                      "RANSAC registration")
                solver = "ransac"
        # several GPUs: each request batch split over the data axis
        # (replicated params; optional TP axis), as run_test_torch.py does
        B = int(batch_size or cfg.dataset.batch_size)
        mesh = serving_mesh(cfg.mesh.data, cfg.mesh.model, B, label="serving", device=device)
        if mesh is not None and cfg.mesh.model > 1:
            shard_params_tp(model, mesh)
        return cls(model, pointdsc, device=device, batch_size=B, mesh=mesh,
                   img_size=cfg.dataset.img_size, depth_hw=depth_hw,
                   mask_source=cfg.test.mask, solver=solver,
                   n_corrs=cfg.test.n_corrs, dist_th=cfg.test.dist_th,
                   mask_threshold=cfg.test.mask_threshold,
                   vocabulary=cfg.pretrained.vocabulary,
                   seed=cfg.seed if cfg.use_seed else 0,
                   icp_refine=cfg.test.icp_refine, icp_points=cfg.test.icp_points,
                   icp_iters=cfg.test.icp_iters, icp_trim=cfg.test.icp_trim)

    def _text_emb(self, prompt: str) -> torch.Tensor:
        emb = self._text_cache.get(prompt)
        count("text_hit" if emb is not None else "text_miss")
        if emb is None:
            ids = torch.as_tensor(np.asarray(self._tokenize(prompt))[None],
                                  device=self.device)
            with torch.inference_mode():
                emb = self.model.encode_prompts(ids)[0]
            self._text_cache[prompt] = emb
        return emb

    def _view(self, specs: Sequence[Dict]) -> PairView:
        """Stack request views into a PairView at engine shapes."""
        H, W = self.img_size
        Ho, Wo = self.depth_hw
        rgbs, masks, depths, cams = [], [], [], []
        for v in specs:
            rgb = np.asarray(v["rgb"])
            if rgb.dtype != np.uint8:
                rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
            if rgb.shape[:2] != (H, W):
                rgb = _resize_u8(rgb, (H, W))
            rgbs.append(rgb)
            m = v.get("mask")
            if m is None:
                m = np.zeros((H, W), np.uint8)
            elif m.shape != (H, W):
                m = _resize_u8(m[..., None], (H, W), nearest=True)[..., 0]
            masks.append(m.astype(np.uint8))
            d = np.asarray(v["depth"], np.float32)
            if d.shape != (Ho, Wo):
                raise ValueError(
                    f"depth frame {d.shape} != engine depth_hw {(Ho, Wo)}; "
                    "build the predictor with the matching depth_hw")
            # the JAX engine's uint16 millimetre wire format
            depths.append(np.clip(d, 0, 65535).astype(np.uint16).astype(np.float32))
            cams.append(parse_camera(v["camera"]))
        dev = self.device
        n = len(specs)
        return PairView(
            rgb=torch.as_tensor(np.stack(rgbs), device=dev),
            mask=torch.as_tensor(np.stack(masks), device=dev),
            depth=None,
            orig_depth=torch.as_tensor(np.stack(depths), device=dev),
            eval_depth=None,
            camera=torch.as_tensor(np.stack(cams), device=dev),
            pose=torch.eye(4, device=dev).expand(n, 4, 4),
            size=torch.tensor([[Ho, Wo]] * n, dtype=torch.int32, device=dev),
        )

    def _build_batch(self, chunk: Sequence[Dict]):
        B = len(chunk)
        with span("engine.text"):
            text = torch.stack([self._text_emb(r["prompt"]) for r in chunk])
        with span("engine.views"):
            anchor = self._view([r["anchor"] for r in chunk])
            query = self._view([r["query"] for r in chunk])
        batch = PairBatch(
            anchor=anchor,
            query=query,
            prompt_ids=None,   # text_emb short-circuits the text tower
            corrs=torch.zeros((B, self._max_corrs, 4), dtype=torch.int64,
                              device=self.device),
            corr_valid=torch.zeros((B, self._max_corrs), dtype=torch.bool,
                                   device=self.device),
            valid=torch.ones(B, device=self.device),
            rel_pose=None,
            cls_id=np.zeros(B, np.int64),
            instance_id=np.asarray([r.get("id", str(i)) for i, r in enumerate(chunk)]),
        )
        return batch, text

    def predict(self, requests: List[Dict], *, return_masks: bool = False,
                stage_events: Optional[list] = None) -> List[Dict]:
        """One result per request; requests beyond the engine batch run in
        chunks, and a short tail is padded with its first request.
        ``stage_events`` (a list) collects CUDA events at stage boundaries.
        Each chunk is one ``engine.request`` span (``utils.profiling``), with
        ``engine.text``, ``engine.views``, the pipeline's spans and
        ``engine.fetch`` inside, and counts its ``padded_pairs``."""
        results: List[Dict] = []
        for i in range(0, len(requests), self.B):
            with span("engine.request"):
                chunk = requests[i: i + self.B]
                n_real = len(chunk)
                count("padded_pairs", self.B - n_real)
                chunk = chunk + [chunk[0]] * (self.B - n_real)
                batch, text_emb = self._build_batch(chunk)
                out = self._run(batch, text_emb, generator=self._generator,
                                stage_events=stage_events)
                with span("engine.fetch"):
                    packed = out.packed.cpu().numpy()   # one fetch: poses + scalars
                    if return_masks:
                        masks = (out.mask_a.cpu().numpy(), out.mask_q.cpu().numpy())
                for b in range(n_real):
                    res = {
                        "pose": packed[b, :16].reshape(4, 4).tolist(),
                        "n_corrs": int(packed[b, 32]),
                        "detection_valid": bool(packed[b, 33] > 0),
                        "prompt": chunk[b]["prompt"],
                    }
                    if return_masks:
                        res["mask_a"], res["mask_q"] = masks[0][b], masks[1][b]
                    results.append(res)
        return results

    def predict_pair(self, anchor: Dict, query: Dict, prompt: str, **kw) -> Dict:
        return self.predict(
            [{"anchor": anchor, "query": query, "prompt": prompt}], **kw)[0]


def _resize_u8(img: np.ndarray, hw, nearest: bool = False) -> np.ndarray:
    from PIL import Image

    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(Image.fromarray(img.squeeze() if img.shape[-1] == 1
                                      else img).resize(
        (hw[1], hw[0]), mode)).reshape(hw[0], hw[1], -1)
