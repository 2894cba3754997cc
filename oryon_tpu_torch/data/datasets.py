"""Dataset readers + pair assembly into fixed-shape PairBatches.

The port's own copy of ``oryon_tpu/data/datasets.py``: host-side numpy
readers of the on-disk formats, with ``collate`` building the port's
``PairBatch`` of tensors on the dataset's ``device``:

  * fixed splits: ``fixed_split/<split>/instance_list.txt`` + ``annots.pkl``
    with GT relative poses (mm -> m) and precomputed pixel correspondences
    (reference datasets.py:421-442, 596-617);
  * per-dataset item readers mirror the on-disk formats exactly
    (NOCS meta/detection txt + gt pkl, TOYL BOP scene_gt.json tree,
    ShapeNet6D scene_gt.pkl + metadata.csv lemmas);
  * prompt construction from ``templates.json`` with the synset/description
    augmentations (reference datasets.py:354-367, 515-532);
  * correspondence dedup + capacity-500 sampling with validity flags
    (reference sample_correspondences, datasets.py:116-136);
  * collate produces a PairBatch (fixed shapes everywhere).  Depths are
    carried as f32 tensors holding the clipped uint16 millimetre values of
    the JAX package's wire format (identical values; torch computes little
    in uint16); ``prompt_ids`` is an int tensor on the device.
"""
from __future__ import annotations

import json
import os
import pickle
from os.path import join
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from oryon_tpu_torch.data.augment import AugmentConfig, augment_pair, resize_only
from oryon_tpu_torch.data.bop import sym_set_from_info
from oryon_tpu_torch.data.meshio import load_bop_object, load_nocs_object
from oryon_tpu_torch.data.pair_batch import PairBatch, PairView
from oryon_tpu_torch.eval.evaluator import ObjectInfo
from oryon_tpu_torch.eval.renderer import pad_mesh

NOCS_K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]],
                  np.float64)


def _imread(path: str, mode: Optional[str] = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if mode:
        img = img.convert(mode)
    return np.asarray(img)


def unique_matches(corrs: np.ndarray) -> np.ndarray:
    """Dedup (N,4) integer matches, reference utils/misc.py:146-164."""
    if corrs.shape[0] == 0:
        return corrs
    return np.unique(corrs.astype(np.int64), axis=0)


def sample_correspondences(
    rs: np.random.RandomState, corrs: np.ndarray, max_corrs: int,
    ordered: bool = False,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Dedup + fixed-capacity sample (reference datasets.py:116-136).

    Returns (corrs [max_corrs, 4] int32, valid [max_corrs] bool, any_valid).
    """
    out = np.zeros((max_corrs, 4), np.int32)
    val = np.zeros(max_corrs, bool)
    if corrs.shape[0] == 0:
        return out, val, False
    corrs = unique_matches(corrs)
    if ordered:
        take = corrs[:max_corrs]
    else:
        idx = rs.choice(corrs.shape[0], min(max_corrs, corrs.shape[0]),
                        replace=False)
        take = corrs[idx]
    out[: len(take)] = take
    val[: len(take)] = True
    return out, val, True


class NocsReader:
    """REAL275 ('nocs') reader (reference utils/data/nocs.py)."""

    name = "nocs"

    def __init__(self, root: str):
        self.root = root
        self.K = NOCS_K
        with open(join(root, "obj_names.json")) as f:
            self.obj_names = json.load(f)
        self.poses = self._load_part_data()

    def _load_part_data(self) -> Dict:
        poses = {}
        gts = join(self.root, "gts", "real_test")
        if not os.path.isdir(gts):
            return poses
        for img_file in os.listdir(gts):
            with open(join(gts, img_file), "rb") as f:
                data = pickle.load(f)["gt_RTs"]
            scene_id, img_id = os.path.splitext(img_file)[0].split("_")[-2:]
            poses[f"{int(scene_id)}_{int(img_id)}"] = data
        return poses

    def get_item(self, scene_id: int, img_id: int, obj_name: str, *,
                 mask_type: str = "oracle") -> Dict:
        base = join(self.root, "split/real_test", f"scene_{scene_id}/{img_id:04d}")
        rgb = _imread(base + "_color.png", "RGB")
        if mask_type == "oracle":
            mask = _imread(base + "_mask.png", "L")
        elif mask_type == "ovseg":
            mask = _imread(base + "_pred_mask.png", "L")
        elif mask_type in ("san", "oryon"):
            # external binary masks keyed by instance (utils/data/nocs.py:237-257)
            path = join(self.root, f"{mask_type}_name",
                        f"{scene_id} {img_id} {obj_name}.png")
            ext = _imread(path, "L")
            mask = None  # resolved below against mask_id
        else:
            raise ValueError(f"mask type {mask_type}")
        depth = _imread(base + "_depth.png")

        # metadata: meta.txt lines '<mask_id> <cls_id> <obj_name>'
        mask_id, cls_id, pose = None, None, np.eye(4)
        raw_poses = self.poses.get(f"{scene_id}_{img_id}")
        with open(base + "_meta.txt") as fm:
            for i, line in enumerate(fm.readlines()):
                m_id, c_id, name = line.split(" ")
                if name.strip() == obj_name:
                    mask_id, cls_id = int(m_id), int(c_id)
                    if raw_poses is not None:
                        pose = np.array(raw_poses[i], np.float64)
                        # NOCS poses carry scale; normalize rows (nocs.py:186-190)
                        pose[:3, :3] /= np.linalg.norm(pose[:3, :3], axis=1,
                                                       keepdims=True)
        assert mask_id is not None, f"{obj_name} not in {base}_meta.txt"
        if mask is None:  # san/oryon external binary mask
            mask = np.where(ext == 1, mask_id, 255).astype(np.uint8)
        names = self.obj_names[obj_name]
        return {
            "rgb": rgb.astype(np.float32) / 255.0,
            "mask": (mask == mask_id).astype(np.uint8),
            "depth": depth.astype(np.float32),
            "camera": self.K,
            "pose": pose,
            "cls_name": names[0],
            "cls_descs": names[1:],
            "instance_id": f"{scene_id} {img_id} {obj_name}",
        }

    def object_info(self, n_faces: Optional[int] = None,
                    max_edge: Optional[float] = None) -> Dict[str, ObjectInfo]:
        """Per-object eval models.  ``max_edge=None``: the production VSD
        renderer (render_depth_window) has no per-triangle footprint limit,
        and its cost is linear in face count — subdividing here would only
        multiply render cost.  Pass a max_edge only when rendering through
        the scatter rasterizer (render_depth)."""
        out = {}
        with open(join(self.root, "obj_models", "real_test", "models_info.json")) as f:
            infos = json.load(f)
        for obj_name, info in infos.items():
            model = load_nocs_object(join(self.root, "obj_models", "real_test", obj_name))
            syms = sym_set_from_info(info, 0.05)
            mesh = pad_mesh(model["pts"], model["faces"] - 1, n_faces, max_edge)
            out[obj_name] = ObjectInfo(model["pts"], info["diameter"], syms, mesh)
        return out


class ToylReader:
    """Toyota-Light ('toyl') reader over the BOP layout (utils/data/toyl.py)."""

    name = "toyl"

    # Linemod/TOYL intrinsics (reference datasets.py:573) — NOT the NOCS K
    TOYL_K = np.asarray([[572.4114, 0.0, 325.2611],
                         [0.0, 573.5704, 242.0489],
                         [0.0, 0.0, 1.0]])

    def __init__(self, root: str):
        self.root = root
        self.K = self.TOYL_K
        with open(join(root, "models_name.json")) as f:
            self.obj_names = json.load(f)
        self.annots = self._load_part_data()

    def _load_part_data(self) -> Dict:
        out = {}
        split_dir = join(self.root, "split", "test")
        if not os.path.isdir(split_dir):
            return out
        for scene_folder in os.listdir(split_dir):
            with open(join(split_dir, scene_folder, "scene_gt.json")) as fa:
                data = json.load(fa)
            with open(join(split_dir, scene_folder, "scene_gt_info.json")) as fm:
                meta = json.load(fm)
            for img_k, img_data in data.items():
                key = f"{int(scene_folder)}_{int(img_k)}"
                out[key] = {}
                for i, (obj, obj_meta) in enumerate(zip(img_data, meta[img_k])):
                    pose = np.eye(4)
                    pose[:3, :3] = np.asarray(obj["cam_R_m2c"]).reshape(3, 3)
                    pose[:3, 3] = np.asarray(obj["cam_t_m2c"]) / 1000.0
                    out[key][str(int(obj["obj_id"]))] = {
                        "pose": pose, "box": obj_meta["bbox_visib"],
                        "mask_idx": i + 1,
                    }
        return out

    def get_item(self, scene_id: int, img_id: int, cls_id: int, *,
                 mask_type: str = "oracle") -> Dict:
        base = join(self.root, "split", "test", f"{scene_id:06d}")
        rgb = _imread(join(base, "rgb", f"{img_id:06d}.png"), "RGB")
        ann = self.annots[f"{scene_id}_{img_id}"][str(int(cls_id))]
        if mask_type == "oracle":
            mask = _imread(join(base, "mask_visib", f"{img_id:06d}.png"), "L")
        elif mask_type == "ovseg":
            mask = _imread(join(base, "mask_pred", f"{img_id:06d}.png"), "L")
        elif mask_type in ("san", "oryon"):
            path = join(self.root, f"{mask_type}_name",
                        f"{scene_id} {img_id} {int(cls_id)}.png")
            ext = _imread(path, "L")
            mask = np.where(ext == 1, ann["mask_idx"], 255).astype(np.uint8)
        else:
            raise ValueError(f"mask type {mask_type}")
        depth = _imread(join(base, "depth", f"{img_id:06d}.png"))
        names = self.obj_names[str(int(cls_id))]
        return {
            "rgb": rgb.astype(np.float32) / 255.0,
            "mask": (mask == ann["mask_idx"]).astype(np.uint8),
            "depth": depth.astype(np.float32),
            "camera": self.K,
            "pose": ann["pose"],
            "cls_name": names[0],
            "cls_descs": names[1:],
            "instance_id": f"{scene_id} {img_id} {cls_id}",
        }

    def object_info(self, n_faces: Optional[int] = None,
                    max_edge: Optional[float] = None) -> Dict[int, ObjectInfo]:
        """max_edge=None: see NocsReader.object_info — the windowed gather
        renderer needs no subdivision and its cost scales with faces."""
        out = {}
        mdir = join(self.root, "models_bop")
        with open(join(mdir, "models_info.json")) as f:
            infos = json.load(f)
        for fname in os.listdir(mdir):
            if not fname.endswith(".ply"):
                continue
            obj_id = int(os.path.splitext(fname[4:])[0])
            info = infos[str(obj_id)]
            model = load_bop_object(join(mdir, fname))
            syms = sym_set_from_info(info, 0.05)
            mesh = pad_mesh(model["pts"], model["faces"], n_faces, max_edge)
            out[obj_id] = ObjectInfo(model["pts"], info["diameter"], syms, mesh)
        return out


class Shapenet6DReader:
    """ShapeNet6D synthetic training pairs (utils/data/shapenet.py)."""

    name = "shapenet6d"

    def __init__(self, root: str):
        self.root = root
        with open(join(root, "scene_gt.pkl"), "rb") as f:
            self.annots = pickle.load(f)
        self.cat_map, self.id_new2old = self._load_metadata()

    def _load_metadata(self):
        import csv

        cat_map = {}
        with open(join(self.root, "metadata.csv")) as f:
            for i, tokens in enumerate(csv.reader(f)):
                if i == 0:
                    continue
                obj_id = tokens[0].split(".")[1]
                cat_map[obj_id] = {"obj_syn": tokens[3].split(","),
                                   "obj_name": tokens[-2]}
        with open(join(self.root, "objnm2clsid.json")) as f:
            data = json.load(f)
        id_new2old = {new: old.split("_")[0] for old, new in data.items()}
        return cat_map, id_new2old

    def object_info(self, n_faces: Optional[int] = None,
                    max_edge: Optional[float] = None) -> Dict[int, ObjectInfo]:
        """Per-object eval models (points + render mesh + diameter).

        Present only for synthetic trees (a models/ dir of .npz files, as the
        JAX package's scripts/make_synthetic_sn6d.py writes them); the real
        ShapeNet6D training archive ships no eval models.  max_edge defaults
        to no subdivision (see NocsReader.object_info)."""
        mdir = join(self.root, "models")
        if not os.path.isdir(mdir):
            raise FileNotFoundError(
                f"{mdir} absent: this ShapeNet6D tree has no eval models "
                "(expected for the real training archive; synthetic trees "
                "include them)")
        out = {}
        syms = np.eye(3, 4, dtype=np.float32)[None]
        for fname in sorted(os.listdir(mdir)):
            if not fname.endswith(".npz"):
                continue
            oid = int(fname[4:-4])
            with np.load(join(mdir, fname)) as z:
                mesh = pad_mesh(z["mesh_vertices"], z["mesh_faces"],
                                n_faces, max_edge)
                out[oid] = ObjectInfo(np.asarray(z["pts"]),
                                      float(z["diameter"]), syms, mesh)
        return out

    def get_item(self, scene_id: int, img_id: int = None, cat_id: int = None,
                 *, mask_type: str = "oracle") -> Dict:
        """Uniform reader signature (scene, img, obj, mask_type) so
        PairDataset can drive any reader; ShapeNet6D images form a flat
        pool, so the scene slot is ignored.  Two-arg direct calls
        get_item(img_id, cat_id) keep working."""
        if cat_id is None:
            scene_id, img_id, cat_id = None, scene_id, img_id
        rgb = _imread(join(self.root, "raw_data", "rgb", f"{img_id:06d}.jpg"), "RGB")
        mask = _imread(join(self.root, "raw_data", "mask", f"{img_id:06d}.png"), "L")
        depth = _imread(join(self.root, "raw_data", "depth", f"{img_id:06d}.png"))
        ann = self.annots[img_id]
        pose, mask_idx, lemmas = np.eye(4), None, ["object"]
        for obj_idx, obj in enumerate(ann["obj_info_lst"]):
            if obj and int(obj["cls_id"]) == int(cat_id):
                mask_idx = obj_idx
                pose = np.eye(4)
                pose[:3, :] = obj["RT"]
                lemmas = self.cat_map[self.id_new2old[int(cat_id)]]["obj_syn"]
        assert mask_idx is not None, f"cat {cat_id} not in img {img_id}"
        return {
            "rgb": rgb.astype(np.float32) / 255.0,
            "mask": (mask == mask_idx).astype(np.uint8),
            "depth": depth.astype(np.float32),
            "camera": np.asarray(ann["K"], np.float64),
            "pose": pose,
            "cls_name": lemmas[0],
            "cls_descs": lemmas,
            "instance_id": f"{img_id} {cat_id}",
        }


READER_REGISTRY = {"nocs": NocsReader, "toyl": ToylReader,
                   "shapenet6d": Shapenet6DReader}


def pick_reader(name: str, readers: Dict = None):
    """Reader class for a dataset-dir name; prefix match tolerates suffixed
    dirs (e.g. 'nocs_v1'). Shared by every CLI/script."""
    readers = readers if readers is not None else READER_REGISTRY
    if name in readers:
        return readers[name]
    for k, r in readers.items():
        if name.startswith(k):
            return r
    raise KeyError(f"no reader for dataset {name}")


class PairDataset:
    """Fixed-split pair dataset over any reader + tokenizer -> PairBatch,
    whose tensors ``collate`` puts on ``device``."""

    def __init__(
        self,
        reader,
        split: str,
        tokenizer,
        max_corrs: int = 500,
        img_size: Tuple[int, int] = (224, 224),
        augment: bool = False,
        aug_cfg: Optional[AugmentConfig] = None,
        add_description: str = "no",
        synset_aug: bool = False,
        debug_valid: bool = False,
        mask_type: str = "oracle",
        seed: int = 0,
        n_prompts: int = 81,
        obj_split: str = "all",
        device="cpu",
    ):
        self.reader = reader
        self.device = torch.device(device)
        self.tokenizer = tokenizer
        self.max_corrs = max_corrs
        self.img_size = tuple(img_size)
        self.augment = augment
        self.aug_cfg = aug_cfg or AugmentConfig(out_size=self.img_size)
        self.aug_cfg.out_size = self.img_size
        self.add_description = add_description
        self.synset_aug = synset_aug
        self.debug_valid = debug_valid
        self.mask_type = mask_type
        self.rs = np.random.RandomState(seed)
        self.n_prompts = n_prompts
        self._prompt_id_cache: Dict[tuple, np.ndarray] = {}

        root = reader.root
        with open(join(root, "templates.json")) as f:
            self.templates = json.load(f)

        # per-object split filter (reference object_splits.json,
        # datasets.py:399-401): restricts pairs to the listed class ids
        self.obj_ids = None
        split_file = join(root, "object_splits.json")
        if obj_split != "all" and os.path.exists(split_file):
            with open(split_file) as f:
                self.obj_ids = {int(c) for c in json.load(f)[obj_split]}

        path = join(root, "fixed_split", split)
        self.instances: List[Tuple] = []
        self.rel_poses: List[np.ndarray] = []
        self.corrs: List[np.ndarray] = []
        with open(join(path, "instance_list.txt")) as f:
            lines = f.readlines()
        with open(join(path, "annots.pkl"), "rb") as f:
            annots = pickle.load(f)
        # tracked pairs rendered during validation/test
        # (reference datasets.py:444-457)
        self.tracked_instances = set()
        tracked_path = join(path, "tracked.txt")
        if os.path.exists(tracked_path):
            with open(tracked_path) as f:
                for line in f.readlines():
                    try:
                        _, id_a, id_q, cat = line.strip("\n").split(",")
                        sa, ia = [int(n) for n in id_a.split(" ") if n != ""]
                        sq, iq = [int(n) for n in id_q.split(" ") if n != ""]
                        obj = cat.strip().split(" ")[1]
                        self.tracked_instances.add(f"{sa}_{ia}_{sq}_{iq}_{obj}")
                    except (ValueError, IndexError):
                        continue
        for line in lines:
            _, id_a, id_q, cat = line.strip("\n").split(",")
            scene_a, img_a = [int(n) for n in id_a.split(" ") if n != ""]
            scene_q, img_q = [int(n) for n in id_q.split(" ") if n != ""]
            cat_id, obj_name = cat.strip().split(" ")
            if self.obj_ids is not None and int(cat_id) not in self.obj_ids:
                continue
            key = "_".join(str(e) for e in
                           (scene_a, img_a, scene_q, img_q, cat_id, obj_name))
            pose = np.array(annots[key]["gt"], np.float64)
            pose[:3, 3] /= 1000.0  # annots store mm (datasets.py:429)
            self.instances.append((scene_a, img_a, scene_q, img_q, cat_id, obj_name))
            self.rel_poses.append(pose)
            self.corrs.append(np.asarray(annots[key]["corrs"]))

    def __len__(self) -> int:
        return len(self.instances)

    def _prompts(self, cls_name: str, cls_descs: Sequence[str]) -> List[str]:
        name = cls_name
        if self.augment and self.synset_aug and cls_descs and self.rs.rand() > 0.2:
            name = self.rs.choice(list(cls_descs))
        # test-time description ablations (reference get_item_prompt,
        # datasets.py:515-527/685-697): 'yes' prepends the object's first
        # description, 'wrong' the second (mismatched) one, 'desconly'
        # replaces the class name with 'object'
        descs = list(cls_descs) if cls_descs else []
        if self.add_description == "yes" and descs:
            name = f"{descs[0]} {name}"
        elif self.add_description == "wrong" and len(descs) > 1:
            name = f"{descs[1]} {name}"
        elif self.add_description == "desconly" and descs:
            name = f"{descs[0]} object"
        prompts = [template.format(name) for template in self.templates]
        return prompts[: self.n_prompts - 1] if self.n_prompts else prompts

    def get_pair(self, index: int, train: bool = False) -> Dict:
        """``train=True`` skips all depth handling (copies, flips, resize):
        a training batch carries no depth."""
        scene_a, img_a, scene_q, img_q, cat_id, obj_name = self.instances[index]
        obj_key = obj_name if self.reader.name == "nocs" else int(cat_id)
        item_a = self.reader.get_item(scene_a, img_a, obj_key, mask_type=self.mask_type)
        item_q = self.reader.get_item(scene_q, img_q, obj_key, mask_type=self.mask_type)
        corrs = self.corrs[index].astype(np.float64)

        if train:
            orig_a = {"size": item_a["mask"].shape}
            orig_q = {"size": item_q["mask"].shape}
        else:
            orig_a = {"depth": item_a["depth"].copy(), "size": item_a["mask"].shape}
            orig_q = {"depth": item_q["depth"].copy(), "size": item_q["mask"].shape}

        if self.augment:
            item_a, item_q, corrs = augment_pair(self.rs, item_a, item_q,
                                                 corrs, self.aug_cfg,
                                                 skip_depth=train)
        else:
            item_a, item_q, corrs = resize_only(item_a, item_q, corrs,
                                                self.img_size, skip_depth=train)

        sampled, corr_valid, any_valid = sample_correspondences(
            self.rs, np.round(corrs).astype(np.int64), self.max_corrs,
            ordered=self.debug_valid)
        H, W = self.img_size
        sampled = np.clip(sampled, 0, [H - 1, W - 1, H - 1, W - 1])
        valid = (any_valid and item_a["mask"].sum() > 0
                 and item_q["mask"].sum() > 0)

        prompts = self._prompts(item_a["cls_name"], item_a["cls_descs"])
        return {
            "item_a": item_a, "item_q": item_q,
            "orig_a": orig_a, "orig_q": orig_q,
            "corrs": sampled, "corr_valid": corr_valid, "valid": float(valid),
            "rel_pose": self.rel_poses[index],
            "prompts": prompts,
            "cls_id": obj_key,
            "instance_id": f"{scene_a}_{img_a}_{scene_q}_{img_q}_{obj_name}",
            "id_a": item_a["instance_id"],
            "id_q": item_q["instance_id"],
        }

    def collate(self, pairs: Sequence[Dict], train: bool = False) -> PairBatch:
        dev = self.device

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev)

        def depth(arrs):
            # the JAX package's uint16 millimetre wire format, carried as f32
            return t(np.clip(np.stack(arrs), 0, 65535).astype(np.uint16).astype(np.float32))

        def view(side, orig):
            items = [p[side] for p in pairs]
            origs = [p[orig] for p in pairs]
            rgb_h = np.stack([it["rgb"] for it in items])
            if rgb_h.dtype != np.uint8:  # uint8 straight from CachedReader
                rgb_h = np.clip(rgb_h * 255.0, 0, 255).astype(np.uint8)
            rgb = t(rgb_h)
            mask = t(np.stack([it["mask"] for it in items]).astype(np.uint8))
            if train:
                # a training step reads rgb, mask and corrs only
                return PairView(rgb=rgb, mask=mask, depth=None, orig_depth=None,
                                eval_depth=None, camera=None, pose=None, size=None)
            orig_depth = depth([o["depth"] for o in origs])
            return PairView(
                rgb=rgb,
                mask=mask,
                depth=depth([it["depth"] for it in items]),
                orig_depth=orig_depth,
                eval_depth=orig_depth,
                camera=t(np.stack([np.asarray(it["camera"], np.float32).reshape(9)
                                   for it in items])),
                pose=t(np.stack([it["pose"] for it in items]).astype(np.float32)),
                size=t(np.stack([o["size"] for o in origs]).astype(np.int32)),
            )

        prompt_ids = np.stack([self._tokenize_cached(p["prompts"]) for p in pairs])
        valid = np.asarray([p["valid"] for p in pairs], np.float32)
        return PairBatch(
            anchor=view("item_a", "orig_a"),
            query=view("item_q", "orig_q"),
            # training: the prompt cache keys on the host ids, and the loss
            # reads the pair validity on the device; the test loop reads
            # the validity on the host every batch
            prompt_ids=prompt_ids if train else t(prompt_ids),
            corrs=t(np.stack([p["corrs"] for p in pairs])),
            corr_valid=t(np.stack([p["corr_valid"] for p in pairs])),
            valid=t(valid) if train else valid,
            rel_pose=None if train else t(np.stack(
                [p["rel_pose"] for p in pairs]).astype(np.float32)),
            cls_id=np.asarray([p["cls_id"] for p in pairs]),
            instance_id=np.asarray([p["instance_id"] for p in pairs]),
            id_a=np.asarray([p["id_a"] for p in pairs]),
            id_q=np.asarray([p["id_q"] for p in pairs]),
        )

    def _tokenize_cached(self, prompts: Sequence[str]) -> np.ndarray:
        """BPE-tokenize a prompt list with memoization: a sweep revisits the
        same few prompt sets, and the 80-template BPE loop is slow."""
        key = tuple(prompts)
        ids = self._prompt_id_cache.get(key)
        if ids is None:
            ids = self.tokenizer(prompts)
            ids.setflags(write=False)
            if len(self._prompt_id_cache) < 4096:
                self._prompt_id_cache[key] = ids
        return ids

    def batches(self, batch_size: int, shuffle: bool = False,
                drop_last: bool = False, sort_by_class: bool = False):
        """Yield PairBatches; final short batch is padded with invalid
        duplicates so shapes stay static.  ``sort_by_class`` groups pairs of
        the same object class into the same batches (fewer per-class metric
        programs per batch at test time).

        Synchronous path; the CLI uses data.loader.PrefetchLoader, which
        assembles batches in a background thread."""
        order = np.arange(len(self))
        if sort_by_class:
            keys = [str(inst[4]) for inst in self.instances]
            order = order[np.argsort(np.asarray(keys)[order], kind="stable")]
        if shuffle:
            self.rs.shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start: start + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    return
                pad = np.full(batch_size - len(idx), idx[-1])
                idx = np.concatenate([idx, pad])
                pairs = [self.get_pair(int(i)) for i in idx]
                for p in pairs[len(order) - start:]:
                    p["valid"] = 0.0
            else:
                pairs = [self.get_pair(int(i)) for i in idx]
            yield self.collate(pairs)
