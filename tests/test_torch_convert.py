"""The port's pretrained-weight converters, key surgery and merge against the
JAX package's, on state dicts with the original torch key names, filled from
a numpy seed at tiny_oryon widths (2 layers).  Conversion only moves and
transposes values, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

from _torch_helpers import original_torch_state


def _sub(name):
    from oryon_tpu_torch.models.oryon import tiny_oryon
    from oryon_tpu_torch.models.pointdsc import PointDSC, PointDSCConfig

    if name == "pointdsc":
        return PointDSC(PointDSCConfig(num_layers=2))
    return getattr(tiny_oryon(), name)


# kind of checkpoint -> (sub-module of the port, converter name, its keywords)
CONVERTERS = {
    "clip_visual": ("vlm_visual", "convert_clip_visual", {"layers": 2}),
    "clip_text": ("vlm_text", "convert_clip_text", {"layers": 2}),
    "swin": ("guidance", "convert_swin_guidance", {}),
    "fusion": ("fusion", "convert_fusion", {"num_layers": 2}),
    "decoder": ("decoder", "convert_decoder", {}),
    "pointdsc": ("pointdsc", "convert_pointdsc", {"num_layers": 2}),
}


@pytest.mark.parametrize("kind", list(CONVERTERS))
def test_converter_matches_jax_package(kind):
    """JAX ``convert_*`` + bridge and the port's ``convert_*`` + bridge give
    the same state dict, key by key and bit by bit; it holds the values the
    original checkpoint was made of, and loads strictly into the module."""
    from oryon_tpu.models import convert as JC
    from oryon_tpu_torch.models import convert as C

    sub, fn, kw = CONVERTERS[kind]
    module = _sub(sub)
    want, original = original_torch_state(module, kind, seed=3)
    ref_tree = getattr(JC, fn)(original, **kw)
    got_tree = getattr(C, fn)(original, **kw)
    ref = C.from_jax_params(ref_tree)
    got = C.from_jax_params(got_tree)
    assert set(got) == set(ref) == set(want)
    for k in got:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    module.load_state_dict(got, strict=True)


@pytest.mark.parametrize("fn,kw", [("convert_clip_visual", {"layers": 2}),
                                   ("convert_clip_text", {"layers": 2})])
def test_unrolled_clip_layout_matches_jax_package(fn, kw):
    """``scan=False`` names the blocks ``resblock_i`` in both packages."""
    import jax

    from oryon_tpu.models import convert as JC
    from oryon_tpu_torch.models import convert as C

    kind = "clip_visual" if "visual" in fn else "clip_text"
    _, original = original_torch_state(_sub(CONVERTERS[kind][0]), kind, seed=4)
    ref = getattr(JC, fn)(original, scan=False, **kw)
    got = getattr(C, fn)(original, scan=False, **kw)
    assert "resblock_1" in got["params"] and "resblocks" not in got["params"]
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)


def test_state_loaders_match_jax_package(tmp_path):
    """``load_torch_state`` unwraps ``model`` / ``state_dict`` and drops what
    is no tensor; ``load_npz_state`` reads an archive; ``load_flax_npz``
    rebuilds the nested tree of a flat '/'-joined archive."""
    from oryon_tpu.models import convert as JC
    from oryon_tpu_torch.models import convert as C

    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2), "epoch": 3}
    for name, payload in (("bare.pth", sd), ("model.pth", {"model": sd}),
                          ("both.pkl", {"model": {"state_dict": sd}})):
        path = str(tmp_path / name)
        torch.save(payload, path)
        got, ref = C.load_torch_state(path), JC.load_torch_state(path)
        assert set(got) == set(ref) == {"a.weight", "b"}
        for k in got:
            np.testing.assert_array_equal(got[k], ref[k])
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **{"params/enc/kernel": np.eye(2), "params/sigma": np.ones(1),
                     "batch_stats/enc/mean": np.zeros(2)})
    got, ref = C.load_npz_state(npz), JC.load_npz_state(npz)
    assert set(got) == set(ref)
    tree = C.load_flax_npz(npz)
    assert set(tree) == {"params", "batch_stats"} and set(tree["params"]) == {"enc", "sigma"}
    np.testing.assert_array_equal(tree["params"]["enc"]["kernel"], np.eye(2))
    back = str(tmp_path / "back.npz")
    C.save_flax_npz(back, tree)                      # and the way back
    again = C.load_npz_state(back)
    assert set(again) == set(got)
    for k in got:
        np.testing.assert_array_equal(again[k], got[k])


def test_catseg_key_surgery_matches_jax_package():
    from oryon_tpu.models.pretrained import catseg_key_surgery as ref_fn
    from oryon_tpu_torch.models.pretrained import catseg_key_surgery

    sd = {
        "sem_seg_head.predictor.transformer.conv1.weight": np.zeros(1),
        "sem_seg_head.predictor.transformer.decoder.decoder1.up.weight": np.ones(1),
        "sem_seg_head.predictor.transformer.head.weight": np.full(1, 2.0),
        "sem_seg_head.predictor.clip_model.visual.conv1.weight": np.full(1, 3.0),
        "backbone.something": np.zeros(1),
    }
    got, ref = catseg_key_surgery(sd), ref_fn(sd)
    assert list(got) == list(ref) == [
        "fusion.conv1.weight", "decoder.decoder.decoder1.up.weight",
        "decoder.head.weight", "clip.visual.conv1.weight"]
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])


def _cfg(tmp_path, **paths):
    from oryon_tpu_torch.config import Config

    cfg = Config()
    for name in ("clip", "swin", "catseg"):
        setattr(cfg.pretrained, name, paths.get(name, str(tmp_path / f"no_{name}.npz")))
    return cfg


def test_load_pretrained_reports_missing_like_jax_package(tmp_path):
    """Every asset missing: the model keeps its weights and the report has
    the JAX package's three lines."""
    from oryon_tpu.config import Config as JConfig
    from oryon_tpu.models.pretrained import load_pretrained_params as ref_fn
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon
    from oryon_tpu_torch.models.pretrained import load_pretrained_params

    jcfg = JConfig()
    jcfg.pretrained.clip = jcfg.pretrained.swin = jcfg.pretrained.catseg = str(tmp_path / "no")
    _, ref = ref_fn(jcfg, {"params": {"vlm_visual": {}, "vlm_text": {}, "guidance": {},
                                      "fusion": {}, "decoder": {}}})
    model = random_init_(tiny_oryon(), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    report = load_pretrained_params(_cfg(tmp_path), model)
    assert report == ref and len(report) == 3 and all("missing" in r for r in report)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """CLIP as a torch pickle, Swin as an npz, and a CATSeg checkpoint (npz)
    with fusion, decoder and a finetuned CLIP, at tiny_oryon widths."""
    from oryon_tpu_torch.models.oryon import tiny_oryon

    out = tmp_path_factory.mktemp("assets")
    model = tiny_oryon()
    port, orig = {}, {}
    for kind, seed in (("clip_visual", 1), ("clip_text", 2), ("swin", 3), ("fusion", 4),
                       ("decoder", 5)):
        port[kind], orig[kind] = original_torch_state(
            getattr(model, CONVERTERS[kind][0]), kind, seed)
    fine = {kind: original_torch_state(getattr(model, CONVERTERS[kind][0]), kind, seed)
            for kind, seed in (("clip_visual", 6), ("clip_text", 7))}
    paths = {"clip": str(out / "clip.pth"), "swin": str(out / "swin.npz"),
             "catseg": str(out / "catseg.npz")}
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               {**orig["clip_visual"], **orig["clip_text"]}.items()}},
               paths["clip"])
    np.savez(paths["swin"], **orig["swin"])
    catseg = {"backbone.unused": np.zeros(1, np.float32)}
    for kind in ("fusion", "decoder"):
        for k, v in orig[kind].items():   # "fusion.x" and "decoder.x" both lie under it
            catseg["sem_seg_head.predictor.transformer." + k.split(".", 1)[1]] = v
    for kind in fine:
        for k, v in fine[kind][1].items():
            catseg["sem_seg_head.predictor.clip_model." + k] = v
    np.savez(paths["catseg"], **catseg)
    return paths, port, {kind: fine[kind][0] for kind in fine}


def _assert_sub(model, sub, want):
    got = getattr(model, sub).state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=f"{sub}.{k}")


@pytest.mark.parametrize("use_catseg", [True, False])
def test_load_pretrained_merges_every_asset(assets, tmp_path, use_catseg):
    """All assets present: every sub-module holds its checkpoint's values;
    the CATSeg-finetuned CLIP overrides the base CLIP, last, and only under
    ``model.use_catseg_ckpt``.  The report reads as the JAX package's."""
    from oryon_tpu_torch.models.layers import random_init_
    from oryon_tpu_torch.models.oryon import tiny_oryon
    from oryon_tpu_torch.models.pretrained import load_pretrained_params

    paths, port, fine = assets
    cfg = _cfg(tmp_path, **paths)
    cfg.model.use_catseg_ckpt = use_catseg
    model = random_init_(tiny_oryon(), torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.fusion.state_dict().items()}
    report = load_pretrained_params(cfg, model)
    want = [f"loaded CLIP from {paths['clip']}", f"loaded Swin-B from {paths['swin']}"]
    if use_catseg:
        want += [f"loaded CATSeg fusion/decoder from {paths['catseg']}",
                 "applied CATSeg-finetuned CLIP override"]
        _assert_sub(model, "fusion", port["fusion"])
        _assert_sub(model, "decoder", port["decoder"])
        _assert_sub(model, "vlm_visual", fine["clip_visual"])
        _assert_sub(model, "vlm_text", fine["clip_text"])
    else:
        want += ["CATSeg weights missing (random init)"]
        assert all(torch.equal(v, before[k]) for k, v in model.fusion.state_dict().items())
        _assert_sub(model, "vlm_visual", port["clip_visual"])
        _assert_sub(model, "vlm_text", port["clip_text"])
    assert report == want
    _assert_sub(model, "guidance", port["swin"])


def test_load_pretrained_refuses_a_tower_of_other_widths(assets, tmp_path):
    """A sub-module loads whole or raises: the small model's towers do not
    take the tiny checkpoint."""
    from oryon_tpu_torch.models.oryon import small_oryon
    from oryon_tpu_torch.models.pretrained import load_pretrained_params

    paths, _, _ = assets
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_pretrained_params(_cfg(tmp_path, clip=paths["clip"]), small_oryon())
