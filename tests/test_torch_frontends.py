"""`repro_torch.models.frontends` against `repro.models.frontends`: M-RoPE
position ids to the integer, the vision prefix and the audio projection in
fp32, on the same seeded numpy inputs and weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import frontends as jfrontends
from repro.models import lm as jlm
from repro_torch import configs, convert
from repro_torch.models import frontends, lm

from test_torch_util import FP32_TOL, random_like, to_jax, to_np, to_torch


def _cfgs(arch, **changes):
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    if changes:
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, **changes))
        jcfg = dataclasses.replace(jcfg, frontend=dataclasses.replace(
            jcfg.frontend, **changes))
    return cfg, jcfg


@pytest.mark.parametrize("prefix_len", [0, 8])
@pytest.mark.parametrize("offset", ["int0", "int5", "per-sequence"])
@pytest.mark.parametrize("seq", [1, 20])
def test_mrope_positions_equal_reference(prefix_len, offset, seq):
    cfg, jcfg = _cfgs("qwen2-vl-2b", prefix_len=prefix_len)
    B = 3
    if offset == "per-sequence":          # decode: each sequence's length
        off = np.array([0, 7, 30], np.int32)
        got = frontends.mrope_positions(cfg, B, seq, to_torch(off),
                                        device="cpu")
        want = jfrontends.mrope_positions(jcfg, B, seq, jnp.asarray(off))
    else:
        off = int(offset[3:])
        got = frontends.mrope_positions(cfg, B, seq, off, device="cpu")
        want = jfrontends.mrope_positions(jcfg, B, seq, off)
    assert got.shape == (3, B, seq) and got.dtype == torch.int32
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    # and through the model's own entry, as prefill and decode call it
    via_lm = lm.positions_for(cfg, B, seq, got.new_tensor(off)
                              if offset == "per-sequence" else off,
                              device="cpu")
    np.testing.assert_array_equal(to_np(via_lm), np.asarray(want))


def test_mrope_prefix_is_a_grid_and_text_continues():
    """prefix 8: side = int(sqrt(8)) = 2, so the image is a 2-wide grid at
    time 0; text continues all three streams from 1."""
    cfg, _ = _cfgs("qwen2-vl-2b")
    pos = to_np(frontends.mrope_positions(cfg, 1, 10, device="cpu"))[:, 0]
    np.testing.assert_array_equal(pos[0], [0] * 8 + [1, 2])
    np.testing.assert_array_equal(pos[1], [0, 0, 1, 1, 2, 2, 3, 3, 1, 2])
    np.testing.assert_array_equal(pos[2], [0, 1] * 4 + [1, 2])


def _frontend_weights(arch, seed=0):
    jcfg = jconfigs.get_smoke_config(arch)
    shapes = {"proj": np.asarray(jfrontends.init_frontend(
        jcfg, jax.random.PRNGKey(0))["proj"])}
    return random_like(shapes, np.random.default_rng(seed))


@pytest.mark.parametrize("seq", [8, 20])
def test_apply_vision_prefix_matches_reference(seq):
    cfg, jcfg = _cfgs("qwen2-vl-2b")
    w = _frontend_weights("qwen2-vl-2b")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    vis = rng.standard_normal(
        (2, cfg.frontend.prefix_len, cfg.frontend.feature_dim)
    ).astype(np.float32)
    got = frontends.apply_vision_prefix(
        cfg, convert.params_from_numpy(w, device="cpu"), to_torch(x),
        to_torch(vis))
    want = jfrontends.apply_vision_prefix(jcfg, to_jax(w), jnp.asarray(x),
                                          jnp.asarray(vis))
    assert got.shape == x.shape
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL)
    np.testing.assert_array_equal(to_np(got)[:, 8:], x[:, 8:])


def test_apply_audio_features_matches_reference():
    cfg, jcfg = _cfgs("hubert-xlarge")
    w = _frontend_weights("hubert-xlarge")
    feats = np.random.default_rng(2).standard_normal(
        (2, 30, cfg.frontend.feature_dim)).astype(np.float32)
    got = frontends.apply_audio_features(
        cfg, convert.params_from_numpy(w, device="cpu"), to_torch(feats))
    want = jfrontends.apply_audio_features(jcfg, to_jax(w),
                                           jnp.asarray(feats))
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "hubert-xlarge"])
def test_embed_inputs_matches_reference(arch):
    """The model's stream: tokens + vision prefix, or audio frames alone (an
    audio model has no embedding table)."""
    cfg, jcfg = _cfgs(arch)
    shapes = jax.tree.map(np.asarray,
                          jlm.init_model(jcfg, jax.random.PRNGKey(0)))
    weights = random_like(shapes, np.random.default_rng(3))
    assert ("embed" in weights) == (arch == "qwen2-vl-2b")
    rng = np.random.default_rng(4)
    if arch == "hubert-xlarge":
        inputs = {"features": rng.standard_normal(
            (2, 12, cfg.frontend.feature_dim)).astype(np.float32)}
    else:
        inputs = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12)),
                  "vision_embeds": rng.standard_normal(
                      (2, 8, cfg.frontend.feature_dim)).astype(np.float32)}
    got = lm.embed_inputs(cfg, convert.params_from_numpy(weights,
                                                         device="cpu"),
                          {k: to_torch(v) for k, v in inputs.items()},
                          torch.float32)
    want = jlm.embed_inputs(jcfg, to_jax(weights), to_jax(inputs),
                            jnp.float32)
    np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL)
