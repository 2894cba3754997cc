"""The port's data layer (``oryon_tpu_torch/data/``, ``utils/native.py``)
against the JAX package's on the CPU, on the miniature REAL275 tree of
``tests/_fixtures.make_nocs_tree`` (60 x 80 views): readers, object models,
``PairDataset.get_pair`` and ``collate``, the cached reader, the prefetching
loader's order and padding, the augmentations fed the same RandomState,
the mesh readers and the mask codecs give equal arrays.
"""
import json
import os

import numpy as np
import pytest
import torch

from _fixtures import make_nocs_tree

TEMPLATES = ["a photo of a {}", "a picture of a {}", "one {} in the scene", "a {}",
             "the {}", "a close-up photo of a {}", "a photo of the {}", "a rendering of a {}"]


@pytest.fixture(scope="module")
def nocs_root(tmp_path_factory):
    """Five views, five pairs of two scenes (one class)."""
    root = str(tmp_path_factory.mktemp("data") / "nocs")
    scenes = [(1, 0), (1, 1), (1, 2), (2, 0), (2, 1)]
    pairs = [((1, 0), (1, 1)), ((1, 0), (2, 0)), ((1, 2), (2, 1)), ((2, 0), (2, 1)),
             ((1, 1), (1, 2))]
    make_nocs_tree(root, scenes=scenes, pairs=pairs)
    with open(os.path.join(root, "templates.json"), "w") as f:
        json.dump(TEMPLATES, f)
    with open(os.path.join(root, "fixed_split", "test_split", "tracked.txt"), "w") as f:
        f.write("test, 1 0, 2 0, 3 mug_1\n")
    return root


def _tokenizer(prompts):
    """Deterministic ids, shared by both packages."""
    out = np.zeros((len(prompts), 16), np.int32)
    for i, p in enumerate(prompts):
        ids = [ord(c) % 500 + 1 for c in p][:14]
        out[i, :len(ids)] = ids
    return out


def _datasets(root, **kw):
    from oryon_tpu.data.datasets import NocsReader as JReader
    from oryon_tpu.data.datasets import PairDataset as JDataset
    from oryon_tpu_torch.data.datasets import NocsReader, PairDataset

    return (JDataset(JReader(root), "test_split", _tokenizer, max_corrs=32,
                     img_size=(56, 56), **kw),
            PairDataset(NocsReader(root), "test_split", _tokenizer, max_corrs=32,
                        img_size=(56, 56), **kw))


def _eq(got, ref, what):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    if got is None or ref is None:
        assert got is None and ref is None, what
        return
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=what)


def test_reader_items_and_objects_match_jax(nocs_root):
    from oryon_tpu.data.datasets import NocsReader as JReader
    from oryon_tpu.data.datasets import pick_reader as jpick
    from oryon_tpu_torch.data.datasets import NocsReader, ToylReader, pick_reader

    got, ref = NocsReader(nocs_root).get_item(1, 2, "mug_1"), JReader(nocs_root).get_item(1, 2, "mug_1")
    assert got.keys() == ref.keys()
    for k in got:
        if isinstance(got[k], np.ndarray):
            _eq(got[k], ref[k], k)
        else:
            assert got[k] == ref[k], k
    go, ro = NocsReader(nocs_root).object_info(), JReader(nocs_root).object_info()
    assert go.keys() == ro.keys()
    for k in go:
        _eq(go[k].pts, ro[k].pts, "pts")
        _eq(go[k].syms, ro[k].syms, "syms")
        assert go[k].diameter == ro[k].diameter
        for a, b in zip(go[k].mesh, ro[k].mesh):
            _eq(a, b, "mesh")
    assert pick_reader("nocs_v1") is NocsReader and pick_reader("toyl") is ToylReader
    assert jpick("nocs_v1").__name__ == "NocsReader"
    with pytest.raises(KeyError):
        pick_reader("lm")


@pytest.mark.parametrize("debug_valid", [False, True])
def test_get_pair_and_collate_match_jax(nocs_root, debug_valid):
    """Pairs, prompts, sampled correspondences (the dataset's RandomState)
    and every field of the collated batch; the port's depths are f32 tensors
    of the JAX wire format's uint16 values."""
    jds, tds = _datasets(nocs_root, debug_valid=debug_valid, add_description="yes")
    assert len(jds) == len(tds) == 5 and tds.tracked_instances == jds.tracked_instances
    jp = [jds.get_pair(i) for i in range(3)]
    tp = [tds.get_pair(i) for i in range(3)]
    for a, b in zip(tp, jp):
        assert a.keys() == b.keys() and a["prompts"] == b["prompts"]
        for k in ("corrs", "corr_valid", "valid", "rel_pose", "cls_id", "instance_id", "id_a",
                  "id_q"):
            _eq(np.asarray(a[k]), np.asarray(b[k]), k)
        for side in ("item_a", "item_q"):
            for k in ("rgb", "mask", "depth", "camera", "pose"):
                _eq(a[side][k], b[side][k], f"{side}.{k}")
    got, ref = tds.collate(tp), jds.collate(jp)
    for view in ("anchor", "query"):
        g, r = getattr(got, view), getattr(ref, view)
        for k in r._fields:
            _eq(getattr(g, k), getattr(r, k), f"{view}.{k}")
        assert g.orig_depth.dtype == torch.float32 and g.eval_depth is g.orig_depth
    for k in ("prompt_ids", "corrs", "corr_valid", "valid", "rel_pose", "cls_id",
              "instance_id", "id_a", "id_q"):
        _eq(getattr(got, k), getattr(ref, k), k)


def test_batches_and_loader_match_jax(nocs_root):
    """Class-sorted batches of 2 over 5 pairs: the same pairs in the same
    order, the last batch padded with invalid copies; the loader yields what
    ``batches`` does, and an error in its worker reaches the caller."""
    from oryon_tpu.data.loader import PrefetchLoader as JLoader
    from oryon_tpu_torch.data.loader import PrefetchLoader

    jds, tds = _datasets(nocs_root)
    ref = [(list(b.instance_id), list(b.valid)) for b in JLoader(jds, 2, sort_by_class=True)]
    got = [(list(b.instance_id), list(b.valid))
           for b in PrefetchLoader(tds, 2, sort_by_class=True)]
    assert got == ref and len(got) == 3 and got[-1][1] == [1.0, 0.0]
    same = [(list(b.instance_id), list(b.valid)) for b in tds.batches(2, sort_by_class=True)]
    assert same == got
    batch = next(iter(PrefetchLoader(tds, 2)))
    assert batch.anchor.rgb.is_inference()     # built inside inference mode

    def broken(i, train=False):
        raise OSError("unreadable view")
    tds.get_pair = broken
    with pytest.raises(OSError, match="unreadable view"):
        list(PrefetchLoader(tds, 2))


def test_cached_reader_returns_the_readers_items(nocs_root):
    from oryon_tpu_torch.data.cache import CachedReader
    from oryon_tpu_torch.data.datasets import NocsReader

    reader = NocsReader(nocs_root)
    cached = CachedReader(reader, max_bytes=1 << 20)
    for _ in range(2):
        a, b = cached.get_item(1, 0, "mug_1"), reader.get_item(1, 0, "mug_1")
        for k in ("rgb", "mask", "depth"):
            _eq(a[k], b[k], k)
        a["rgb"][:] = 0                        # a fresh copy every time
    assert cached.stats()["hits"] == 1 and cached.name == "nocs"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentations_match_jax(seed):
    """augment_pair and resize_only fed the same RandomState: equal items,
    correspondences and RandomState afterwards."""
    from oryon_tpu.data import augment as ja
    from oryon_tpu_torch.data import augment as ta

    rs = np.random.RandomState(seed)

    def items():
        return {"rgb": rs.rand(30, 40, 3).astype(np.float32),
                "mask": (rs.rand(30, 40) > 0.5).astype(np.uint8),
                "depth": (rs.rand(30, 40) * 900).astype(np.float32)}
    a, q = items(), items()
    corrs = rs.rand(20, 4) * [29, 39, 29, 39]
    cfg_j, cfg_t = ja.AugmentConfig(prob=0.7, out_size=(24, 32)), ta.AugmentConfig(
        prob=0.7, out_size=(24, 32))
    rj, rt = np.random.RandomState(seed + 10), np.random.RandomState(seed + 10)
    ref = ja.augment_pair(rj, {**a}, {**q}, corrs, cfg_j)
    got = ta.augment_pair(rt, {**a}, {**q}, corrs, cfg_t)
    assert rj.rand() == rt.rand()
    for g, r in zip(got[:2], ref[:2]):
        for k in r:
            _eq(g[k], r[k], k)
    _eq(got[2], ref[2], "corrs")
    ref = ja.resize_only({**a}, {**q}, corrs, (20, 20))
    got = ta.resize_only({**a}, {**q}, corrs, (20, 20))
    for k in ("rgb", "mask", "depth"):
        _eq(got[0][k], ref[0][k], k)
    _eq(got[2], ref[2], "corrs")


def test_native_codecs_match_jax():
    from oryon_tpu.utils import native as jn
    from oryon_tpu_torch.utils import native as tn

    rs = np.random.RandomState(5)
    for m in ((rs.rand(13, 17) > 0.6).astype(np.uint8), np.ones((4, 5), np.uint8),
              np.zeros((3, 3), np.uint8)):
        runs = tn.rle_encode(m)
        _eq(runs, jn.rle_encode(m), "runs")
        _eq(tn.rle_decode(runs, m.shape), m, "decode")
    img = (rs.rand(21, 30, 3) * 255).astype(np.uint8)
    _eq(tn.resize_bilinear_u8(img, (11, 16)), jn.resize_bilinear_u8(img, (11, 16)), "bilinear")
    _eq(tn.resize_nearest_u8(img[..., 0], (11, 16)), jn.resize_nearest_u8(img[..., 0], (11, 16)),
        "nearest")


def test_mesh_readers_match_jax(tmp_path):
    """ASCII and binary PLY and the NOCS obj/txt pair."""
    from oryon_tpu.data import meshio as jm
    from oryon_tpu_torch.data import meshio as tm

    V = np.array([[0, 0, 0], [10, 0, 0], [0, 10, 0], [0, 0, 10]], np.float32)
    F = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    head = ("ply\nformat {}\nelement vertex 4\nproperty float x\nproperty float y\n"
            "property float z\nelement face 4\nproperty list uchar int vertex_indices\n"
            "end_header\n")
    (tmp_path / "a.ply").write_text(head.format("ascii 1.0") + "".join(
        f"{x} {y} {z}\n" for x, y, z in V) + "".join(f"3 {a} {b} {c}\n" for a, b, c in F))
    body = V.astype("<f4").tobytes() + b"".join(
        np.uint8(3).tobytes() + f.astype("<i4").tobytes() for f in F)
    (tmp_path / "b.ply").write_bytes(head.format("binary_little_endian 1.0").encode() + body)
    for name in ("a.ply", "b.ply"):
        got, ref = tm.load_bop_object(str(tmp_path / name)), jm.load_bop_object(str(tmp_path / name))
        for k in ("pts", "normals", "faces"):
            _eq(got[k], ref[k], k)
    base = str(tmp_path / "obj")
    np.savetxt(base + "_vertices.txt", V / 1000)
    np.savetxt(base + "_normals.txt", V)
    with open(base + ".obj", "w") as f:
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in F)
    got, ref = tm.load_nocs_object(base), jm.load_nocs_object(base)
    for k in ("pts", "normals", "faces"):
        _eq(got[k], ref[k], k)


def test_train_collate_and_fields_match_jax(nocs_root):
    """``collate(train=True)`` and ``train_fields``: the fields a train step
    reads equal the JAX package's, the rest are dropped as there; the
    prompt ids stay on the host (the prompt cache keys on them)."""
    from oryon_tpu.data.pair_batch import train_fields as jax_train_fields
    from oryon_tpu_torch.data.pair_batch import device_fields, train_fields

    jds, tds = _datasets(nocs_root, augment=True)
    ref = jax_train_fields(jds.collate([jds.get_pair(i, train=True) for i in range(2)],
                                       train=True))
    got = tds.collate([tds.get_pair(i, train=True) for i in range(2)], train=True)
    assert isinstance(got.prompt_ids, np.ndarray) and isinstance(got.valid, torch.Tensor)
    got = train_fields(got)
    _eq(got.prompt_ids, ref.prompt_ids, "prompt_ids")
    assert got.anchor._fields == ref.anchor._fields and got._fields == ref._fields
    for view in ("anchor", "query"):
        for k in ref.anchor._fields:
            _eq(getattr(getattr(got, view), k), getattr(getattr(ref, view), k), f"{view}.{k}")
    for k in ("corrs", "corr_valid", "valid", "rel_pose", "cls_id", "instance_id", "id_a",
              "id_q", "text_emb"):
        _eq(getattr(got, k), getattr(ref, k), k)
    emb = torch.zeros(2, 3, 4)
    cached = train_fields(got._replace(text_emb=emb))
    assert cached.prompt_ids is None and cached.text_emb is emb
    assert device_fields(tds.collate([tds.get_pair(0)])).id_a is None


def test_synthetic_pair_batch_is_jaxs_bit_for_bit():
    from oryon_tpu.data.synthetic import synthetic_pair_batch as jax_batch
    from oryon_tpu_torch.data.synthetic import synthetic_pair_batch

    kw = dict(seed=7, batch=3, img_hw=(40, 48), orig_hw=(120, 160), n_corrs=50,
              n_prompts=4, context_len=16, vocab=600)
    ref, got = jax_batch(**kw), synthetic_pair_batch(**kw)
    for view in ("anchor", "query"):
        for k in ref.anchor._fields:
            g, r = getattr(getattr(got, view), k), np.asarray(getattr(getattr(ref, view), k))
            assert g.dtype == (torch.float32 if r.dtype == np.uint16 else
                               torch.from_numpy(r.copy()).dtype), f"{view}.{k}"
            _eq(g, r.astype(np.float32) if r.dtype == np.uint16 else r, f"{view}.{k}")
    for k in ("prompt_ids", "corrs", "corr_valid", "valid", "rel_pose", "cls_id",
              "instance_id", "id_a", "id_q"):
        g, r = getattr(got, k), np.asarray(getattr(ref, k))
        if isinstance(g, torch.Tensor):
            assert g.dtype == torch.from_numpy(r.copy()).dtype, k
        _eq(g, r, k)


def test_misc_and_logging_match_jax(tmp_path):
    """The port's ``MetricLogger`` writes the JAX one's JSONL lines and epoch
    means.  (``utils/misc.py`` and ``StageTimer`` have no caller in either
    package and are not ported.)"""
    from oryon_tpu.utils.logging import MetricLogger as JLogger
    from oryon_tpu_torch.utils.logging import MetricLogger

    logs = []
    for cls, d in ((JLogger, tmp_path / "jax"), (MetricLogger, tmp_path / "port")):
        log = cls(str(d), "run")
        log.log_step(3, {"loss/total": 0.5, "metric/iou_a": np.float32(0.25)}, prefix="train")
        log.log_step(4, {"loss/total": torch.tensor(1.5)}, prefix="train")
        means = log.epoch_summary(0)
        log.close()
        with open(log.path) as f:
            lines = [json.loads(line) for line in f]
        logs.append((means, [{k: v for k, v in r.items() if k != "time"} for r in lines]))
    assert logs[1] == logs[0] and logs[1][0]["train_loss/total"] == 1.0


def test_metric_logger_epochs_and_reopen_match_jax(tmp_path):
    """Each epoch summary holds only the values logged since the previous
    one, an epoch with nothing logged writes an empty mean, and a logger
    reopened on the same run appends (a resumed run keeps its history), as
    in the JAX package."""
    from oryon_tpu.utils.logging import MetricLogger as JLogger
    from oryon_tpu_torch.utils.logging import MetricLogger

    runs = []
    for cls, d in ((JLogger, tmp_path / "jax"), (MetricLogger, tmp_path / "port")):
        means = []
        for epoch, values in enumerate(([1.0, 3.0], [], [5.0])):
            log = cls(str(d), "run")
            for i, v in enumerate(values):
                log.log_step(10 * epoch + i, {"loss/total": v, "loss/mask": v / 2},
                             prefix="valid")
            means.append(log.epoch_summary(epoch))
            log.close()
        with open(log.path) as f:
            lines = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]
        runs.append((means, lines))
    assert runs[1] == runs[0]
    assert runs[1][0] == [{"valid_loss/total": 2.0, "valid_loss/mask": 1.0}, {},
                          {"valid_loss/total": 5.0, "valid_loss/mask": 2.5}]
