"""The port's config tree, model resolution and host-side copies (tokenizer,
templates) against the JAX package, and the guard that the port imports
nothing of it.
"""
import ast
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "config.yaml")


@pytest.mark.parametrize("overrides", [
    [],
    ["model.attn_impl=fused_i8qk", "model.quant=none"],
    ["model.attn_impl=flash", "test.solver=ransac", "test.icp_refine=false"],
    ["model.size=tiny", "dataset.batch_size=2", "dataset.img_size=[64, 64]",
     "test.n_corrs=64", "test.icp_trim=0.5", "use_seed=yes", "seed=7",
     "test.add_description=no", "eval.ckpt=some/dir"],
])
def test_load_config_matches_jax(overrides):
    """The same file and overrides give the same flattened tree, value by
    value and type by type (YAML 1.2 booleans, tuple and scalar coercion)."""
    from oryon_tpu import config as jcfg
    from oryon_tpu_torch import config as tcfg

    ref = jcfg.flatten(jcfg.load_config(YAML, overrides))
    got = tcfg.flatten(tcfg.load_config(YAML, overrides))
    assert got == ref
    assert {k: type(v) for k, v in got.items()} == {k: type(v) for k, v in ref.items()}
    assert tcfg.flatten(tcfg.load_config()) == jcfg.flatten(jcfg.load_config())
    assert tcfg.to_dict(tcfg.load_config(YAML, overrides)) == jcfg.to_dict(
        jcfg.load_config(YAML, overrides))


def test_config_rejects_unknown_keys_and_roundtrips(tmp_path):
    from oryon_tpu_torch import config as tcfg

    with pytest.raises(KeyError, match="model.attention"):
        tcfg.load_config(YAML, ["model.attention=flash"])
    cfg = tcfg.load_config(YAML, ["model.attn_impl=flash", "test.icp_points=256"])
    path = tmp_path / "saved.yaml"
    tcfg.save_config(cfg, str(path))
    assert tcfg.flatten(tcfg.load_config(str(path))) == tcfg.flatten(cfg)


@pytest.mark.parametrize("overrides,solver,mask_source", [
    ([], "pointdsc", None),
    (["test.mask=oracle", "test.n_corrs=64", "test.dist_th=0.3", "test.icp_refine=false",
      "test.icp_points=256", "test.icp_iters=12", "test.icp_trim=0.7",
      "test.mask_threshold=0.4"], "ransac", None),
    ([], "ransac", "predicted"),
])
def test_make_pipeline_config_field_by_field(overrides, solver, mask_source):
    from oryon_tpu import config as jcfg
    from oryon_tpu.pipeline import make_pipeline_config as jmake
    from oryon_tpu_torch import config as tcfg
    from oryon_tpu_torch.pipeline import make_pipeline_config

    ref = jmake(jcfg.load_config(YAML, overrides), solver, mask_source)
    got = make_pipeline_config(tcfg.load_config(YAML, overrides), solver, mask_source)
    for f in dataclasses.fields(got):
        if f.name == "match":
            for m in dataclasses.fields(got.match):
                assert getattr(got.match, m.name) == getattr(ref.match, m.name), m.name
        else:
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    if not overrides:   # the shipped ICP defaults, whichever way they are reached
        assert (got.icp_refine, got.icp_points, got.icp_iters, got.icp_trim) == (
            True, 1024, 48, 0.6)
    # debug_valid (ground-truth correspondences) reaches the pipeline, as in JAX
    dbg = ["debug_valid=true"] + overrides
    assert make_pipeline_config(tcfg.load_config(YAML, dbg), solver).debug_valid is True
    assert jmake(jcfg.load_config(YAML, dbg), solver).debug_valid is True


def test_predictor_icp_defaults_come_from_test_config():
    """The direct constructor takes its ICP defaults from ``TestConfig``,
    not from literals of its own."""
    from oryon_tpu_torch import config as tcfg, infer

    seen = {}
    with pytest.MonkeyPatch().context() as mp:
        mp.setattr(infer, "make_run_fn", lambda model, cfg, pd: seen.setdefault("cfg", cfg))
        mp.setattr(infer, "TestConfig", lambda: tcfg.TestConfig(
            icp_points=77, icp_iters=5, icp_trim=0.9, icp_refine=False))
        infer.OryonPredictor(torch.nn.Identity(), device="cpu", tokenize_fn=lambda p: None)
    c = seen["cfg"]
    assert (c.icp_refine, c.icp_points, c.icp_iters, c.icp_trim) == (False, 77, 5, 0.9)


# the port's tower keys that the JAX package lacks (the EVA02 towers), at the
# values that leave a CLIP tower as the JAX package builds it
EVA02_KEYS = {"block": "clip", "act": "quick_gelu"}


def _clip_fields(got, ref) -> dict:
    """The port's tower config as a dict of the JAX config's fields, after
    checking that every other field holds its CLIP value."""
    mine, theirs = dataclasses.asdict(got), dataclasses.asdict(ref)
    extra = {k: v for k, v in mine.items() if k not in theirs}
    assert set(extra) <= set(EVA02_KEYS) and extra == {k: EVA02_KEYS[k] for k in extra}
    return {k: v for k, v in mine.items() if k in theirs}


@pytest.mark.parametrize("size", ["full", "small", "tiny"])
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("attn_impl", ["fused", "fused_i8qk", "flash", "einsum"])
def test_resolve_functions_match_jax(size, quant, attn_impl):
    from oryon_tpu.models import oryon as jo
    from oryon_tpu_torch.models import oryon as to

    assert to.resolve_quant(size, quant) == jo.resolve_quant(size, quant)
    assert to.resolve_attn_impl(size, attn_impl) == jo.resolve_attn_impl(size, attn_impl)
    if size != "full" and (quant != "none" or attn_impl != "fused"):
        # explicit misuse raises in both packages
        for build in (jo.build_model, to.build_model):
            with pytest.raises(ValueError, match="only wired for size='full'"):
                build(size, quant=quant, attn_impl=attn_impl)
    elif size != "full":
        got, ref = to.build_model(size), jo.build_model(size)
        assert _clip_fields(got.vision_cfg, ref.vision_cfg) == dataclasses.asdict(ref.vision_cfg)
        assert dataclasses.asdict(got.swin_cfg) == dataclasses.asdict(ref.swin_cfg)


def test_build_full_model_configs_match_jax():
    """``build_model("full", ...)`` carries quant and attn_impl into the
    vision config exactly as the JAX factory does; built on the meta device,
    so no 400M-parameter tensors are allocated."""
    from oryon_tpu.models import oryon as jo
    from oryon_tpu_torch.models import oryon as to

    for quant, attn_impl in (("int8", "fused_i8qk"), ("none", "flash"), ("int8", "fused")):
        ref = jo.build_model("full", quant=quant, attn_impl=attn_impl)
        with torch.device("meta"):
            got = to.build_model("full", quant=quant, attn_impl=attn_impl)
        assert _clip_fields(got.vision_cfg, ref.vision_cfg) == dataclasses.asdict(ref.vision_cfg)
        assert dataclasses.asdict(got.swin_cfg) == dataclasses.asdict(ref.swin_cfg)
        assert _clip_fields(got.text_cfg, ref.text_cfg) == dataclasses.asdict(ref.text_cfg)
    with pytest.raises(ValueError, match="attn_impl"):
        with torch.device("meta"):
            to.build_model("full", attn_impl="pallas")


PROMPTS = ["mug", "a photo of a laptop.", "Café crème &amp; co", "bottle_2 (red)",
           "it's  spaced\tout", "", "x" * 300]


@pytest.mark.parametrize("context_length", [77, 16])
def test_tokenizer_copy_matches_jax_package(context_length):
    """The port's own tokenizer gives the JAX package's token ids (the
    byte-level fallback vocabulary: no merges file ships with the repo)."""
    from oryon_tpu.models.tokenizer import ClipTokenizer as JTok
    from oryon_tpu_torch.models.tokenizer import ClipTokenizer as TTok

    ref = JTok("")(PROMPTS, context_length=context_length)
    got = TTok("")(PROMPTS, context_length=context_length)
    assert got.dtype == ref.dtype and got.shape == (len(PROMPTS), context_length)
    np.testing.assert_array_equal(got, ref)


def test_templates_copy_matches_jax_package():
    from oryon_tpu.data.templates import CLIP_TEMPLATES as ref
    from oryon_tpu_torch.data.templates import CLIP_TEMPLATES as got

    assert got == ref and len(got) == 80


def _imports_and_joins(path):
    """(imported module names, string constants of os.path.join calls)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods, joins = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
        elif isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in ("join", "import_module", "__import__", "spec_from_file_location",
                        "Path", "joinpath"):
                joins += [a.value for a in ast.walk(node)
                          if isinstance(a, ast.Constant) and isinstance(a.value, str)]
    return mods, joins


PORT_FILES = sorted(glob.glob(os.path.join(ROOT, "oryon_tpu_torch", "**", "*.py"),
                              recursive=True)) + [
    os.path.join(ROOT, name) for name in ("chip_smoke.py", "run_infer_torch.py",
                                          "run_test_torch.py", "run_train_torch.py")]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_nothing_of_jax(path):
    """No file of the port imports jax, flax, orbax or the JAX package, by
    import statement or by a path that reaches into ``oryon_tpu/``; nor
    builds from the JAX package's ``native/`` (its Makefile, its library):
    only ``utils/native.py`` joins a ``native`` directory, the port's own."""
    mods, joins = _imports_and_joins(path)
    for m in mods:
        top = m.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "orbax", "optax", "oryon_tpu"), (path, m)
    for s in joins:
        parts = s.replace("\\", "/").split("/")
        assert "oryon_tpu" not in parts and not s.startswith("oryon_tpu."), (path, s)
        if "native" in parts:
            assert os.path.relpath(path, ROOT) == os.path.join("oryon_tpu_torch", "utils",
                                                               "native.py"), (path, s)
    with open(path) as f:
        consts = [n.value for n in ast.walk(ast.parse(f.read(), path))
                  if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert not [c for c in consts if c in ("make", "Makefile") or "liboryon_native.so" in c], path
    if path.endswith(os.path.join("utils", "native.py")):
        from oryon_tpu_torch.utils import native
        assert native.SOURCE == os.path.join(ROOT, "oryon_tpu_torch", "native", "oryon_native.cpp")


def test_port_has_no_host_loader():
    assert not os.path.exists(os.path.join(ROOT, "oryon_tpu_torch", "_host.py"))
    assert len(PORT_FILES) > 25
