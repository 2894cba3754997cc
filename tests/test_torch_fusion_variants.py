"""The fusion ablations of the port against the JAX package's on the CPU:
softmax attention in the class transformer, the MLP guidance head, no
guidance head, and the guided blocks without appearance guidance.  f32, the
config of ``tests/test_models.py::test_fusion_variants``, the same flax
weights bridged by ``from_jax_params``; ``test_torch_models.py``'s bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import flax_params, to_torch
from test_torch_models import TOL

CASES = [("full", "default", True), ("linear", "mlp", True), ("linear", "none", True),
         ("linear", "default", False)]


@pytest.mark.parametrize("attn,head,guided", CASES,
                         ids=["full", "mlp", "none", "no_appearance"])
def test_fusion_variant_matches_jax(attn, head, guided):
    from oryon_tpu.models.fusion import FusionConfig as JConfig, ImageTextFusion as JFusion
    from oryon_tpu_torch.models.fusion import FusionConfig, ImageTextFusion

    kw = dict(hidden_dim=32, text_guidance_dim=48, text_guidance_proj_dim=32,
              appearance_guidance_dim=16, appearance_proj_dim=32, num_layers=1, nheads=4,
              window=12, pooling=6, num_prompts=8, clip_dim=64, clip_proj_dim=48,
              attention_type=attn, guidance_head=head, use_appearance_guidance=guided)
    img = np.random.RandomState(0).randn(2, 24, 24, 64).astype(np.float32)
    txt = np.random.RandomState(1).randn(2, 8, 48).astype(np.float32)
    app = np.random.RandomState(2).randn(2, 24, 24, 16).astype(np.float32)
    jm = JFusion(JConfig(**kw), dtype=jnp.float32)
    params = flax_params(jm, 3, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(app))
    ref = np.asarray(jax.jit(jm.apply)(params, img, txt, app))
    port = to_torch(ImageTextFusion(FusionConfig(**kw), dtype=torch.float32), params)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (img, txt, app))).numpy()
    assert got.shape == (2, 24, 24, 32)
    np.testing.assert_allclose(got, ref, **TOL)
    # the ablation changes the function: the default model's output differs
    if (attn, head, guided) != ("linear", "default", True):
        names = set(port.state_dict())
        assert ("layer_0.mlp_head.textconv.weight" in names) == (head == "mlp")
        assert ("guidance_projection.weight" in names) == guided
        assert ("layer_0.class_transformer.q.weight" in names) == (head == "default")
