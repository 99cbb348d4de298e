"""`repro_torch.launch.serve` on the CPU at smoke size: the slice as a whole.
Offloaded decode must give the baseline's tokens, the decode runs must not
touch the post-prefill cache, and a card that is not there is an error."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.launch import serve as serve_mod
from repro_torch.models import lm

from test_torch_util import to_np


@pytest.mark.parametrize("prompt_len,use_kernels,window", [
    (16, False, 2), (128, True, 2), (16, True, 1)])
def test_serve_offload_tokens_identical(prompt_len, use_kernels, window):
    res = serve_mod.serve("qwen2.5-3b", smoke=True, batch=2,
                          prompt_len=prompt_len, max_new=6,
                          use_kernels=use_kernels, offload_kv=True,
                          offload_window=window, device="cpu")
    assert res["tokens"].shape == (2, 6)
    assert res["tokens_identical"]
    assert torch.equal(res["tokens"], res["tokens_offload"])
    assert res["offload_pages"] == 3              # len, k, v
    stats = res["offload_stats"]
    assert stats["demand_fetches"] == 0 and stats["prefetch_issued"] == 3
    assert stats["writebacks"] > 0

    # the two decode runs worked on clones: the post-prefill cache still is
    # what a fresh prefill of the same prompts gives
    cfg = serve_mod.configs.get_smoke_config("qwen2.5-3b")
    fresh = lm.init_cache(cfg, 2, prompt_len + 6, device="cpu")
    _, fresh = lm.prefill(cfg, res["params"], {"tokens": res["prompts"]},
                          fresh, use_kernels=use_kernels)
    for a, b in zip(convert.flatten(res["cache"])[0],
                    convert.flatten(fresh)[0]):
        assert torch.equal(a, b)
    assert res["cache"]["len"].tolist() == [prompt_len] * 2
    assert not res["cache"]["scan"][0]["k"][:, prompt_len:].any()


@pytest.mark.parametrize("arch,use_kernels", [
    ("granite-moe-1b-a400m", True), ("rwkv6-7b", False)])
def test_serve_offload_new_archs(arch, use_kernels):
    """MoE (capacity mode, tokens dropped at decode) and RWKV-6 (its state
    rewritten whole on every step) through `launch.serve`: the same tokens
    with and without offload, and the post-prefill cache untouched by the
    two decode runs."""
    res = serve_mod.serve(arch, smoke=True, batch=2, prompt_len=128,
                          max_new=6, use_kernels=use_kernels, offload_kv=True,
                          device="cpu")
    assert res["tokens"].shape == (2, 6)
    assert res["tokens_identical"]
    assert torch.equal(res["tokens"], res["tokens_offload"])
    stats = res["offload_stats"]
    assert stats["demand_fetches"] == 0 and stats["prefetch_issued"] == 3
    cfg = serve_mod.configs.get_smoke_config(arch)
    fresh = lm.init_cache(cfg, 2, 128 + 6, device="cpu")
    _, fresh = lm.prefill(cfg, res["params"], {"tokens": res["prompts"]},
                          fresh, use_kernels=use_kernels)
    for a, b in zip(convert.flatten(res["cache"])[0],
                    convert.flatten(fresh)[0]):
        assert torch.equal(a, b)
    if arch == "rwkv6-7b":
        # pages: len, last_x, s; the state is filled and the decode steps
        # worked on clones of it
        assert res["offload_pages"] == 3
        assert res["cache"]["scan"][0]["s"].any()
        # a decode step writes the new state into the tree it was handed
        # (`serve` pages exactly those tensors back to the host)
        cur = convert.tree_map(torch.clone, res["cache"])
        before = convert.tree_map(torch.clone, cur)
        _, out = lm.decode_step(cfg, res["params"], res["tokens"][:, :1], cur)
        for name in ("s", "last_x"):
            assert out["scan"][0][name] is cur["scan"][0][name]
            assert not torch.equal(cur["scan"][0][name],
                                   before["scan"][0][name])


@pytest.mark.parametrize("prompt_len,use_kernels", [(40, False), (130, True)])
def test_serve_offload_recurrentgemma(prompt_len, use_kernels):
    """The hybrid RG-LRU + sliding-window model through `launch.serve`: its
    cache flattens to 7 pages at smoke size (`len`, then the period's RG-LRU
    `conv` and `h` twice and the window's `k` and `v`), more than the window
    of 2 holds, so every decode step after the first evicts dirty pages and
    writes them back to the host. Tokens are the same with and without
    offload, and the post-prefill cache is untouched by the decode runs."""
    max_new = 6
    res = serve_mod.serve("recurrentgemma-9b", smoke=True, batch=2,
                          prompt_len=prompt_len, max_new=max_new,
                          use_kernels=use_kernels, offload_kv=True,
                          device="cpu")
    assert res["tokens"].shape == (2, max_new)
    assert res["tokens_identical"]
    assert torch.equal(res["tokens"], res["tokens_offload"])
    pages, window = res["offload_pages"], res["offload_window"]
    assert pages == 7 and window == 2
    leaves, _ = convert.flatten(res["cache"])
    assert [tuple(t.shape) for t in leaves] == [
        (2,), (1, 2, 3, 64), (1, 2, 64), (1, 2, 3, 64), (1, 2, 64),
        (1, 2, 16, 1, 16), (1, 2, 16, 1, 16)]
    stats = res["offload_stats"]
    assert stats["prefetch_issued"] == pages
    assert stats["writebacks"] >= (max_new - 2) * (pages - window)
    cfg = serve_mod.configs.get_smoke_config("recurrentgemma-9b")
    fresh = lm.init_cache(cfg, 2, prompt_len + max_new, device="cpu")
    _, fresh = lm.prefill(cfg, res["params"], {"tokens": res["prompts"]},
                          fresh, use_kernels=use_kernels)
    for a, b in zip(leaves, convert.flatten(fresh)[0]):
        assert torch.equal(a, b)


def test_serve_tokens_match_reference_serving_loop():
    """The port's greedy tokens equal the reference's decode loop on the
    same weights, carried across leaf by leaf (bf16 compute on both sides
    can round differently, so this runs in the reference's fp32)."""
    res = serve_mod.serve("qwen2-7b", smoke=True, batch=2, prompt_len=16,
                          max_new=5, device="cpu", seed=3)
    # run both sides in fp32 from the same (already bf16-rounded) weights
    weights = convert.flatten(res["params"])
    np_tree = convert.unflatten(weights[1], [to_np(t) for t in weights[0]])
    jcfg = jconfigs.get_smoke_config("qwen2-7b")
    cfg = serve_mod.configs.get_smoke_config("qwen2-7b")
    jparams = jax.tree.map(jnp.asarray, np_tree)
    params = convert.params_from_numpy(np_tree, device="cpu")
    prompts = to_np(res["prompts"])
    jcache = jlm.init_cache(jcfg, 2, 21, dtype=jnp.float32)
    cache = lm.init_cache(cfg, 2, 21, dtype=torch.float32, device="cpu")
    jlg, jcache = jlm.prefill(jcfg, jparams, {"tokens": jnp.array(prompts)},
                              jcache, dtype=jnp.float32)
    lg, cache = lm.prefill(cfg, params, {"tokens": res["prompts"]}, cache,
                           dtype=torch.float32)
    for _ in range(4):
        jtok = jnp.argmax(jlg[:, -1], -1)[:, None]
        tok = torch.argmax(lg[:, -1], -1)[:, None]
        np.testing.assert_array_equal(np.asarray(jtok), to_np(tok))
        jlg, jcache = jlm.decode_step(jcfg, jparams, jtok, jcache,
                                      dtype=jnp.float32)
        lg, cache = lm.decode_step(cfg, params, tok, cache,
                                   dtype=torch.float32)


def test_serve_sampling_is_seeded():
    a = serve_mod.serve("qwen2.5-3b", smoke=True, batch=2, prompt_len=8,
                        max_new=4, temperature=0.8, device="cpu", seed=5)
    b = serve_mod.serve("qwen2.5-3b", smoke=True, batch=2, prompt_len=8,
                        max_new=4, temperature=0.8, device="cpu", seed=5)
    assert torch.equal(a["tokens"], b["tokens"])


def test_serve_main_prints_the_reference_lines(capsys):
    serve_mod.main(["--arch", "qwen2.5-3b", "--smoke", "--batch", "2",
                    "--prompt-len", "16", "--max-new", "4", "--use-kernels",
                    "--offload-kv", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill: 2x16" in out and "tok/s" in out
    assert "tokens identical: True" in out


def test_serve_rejects_encoder_and_missing_card():
    with pytest.raises(ValueError, match="encoder-only"):
        serve_mod.serve("hubert-xlarge", smoke=True, device="cpu")
    with pytest.raises(ValueError, match="vision_embeds"):
        serve_mod.serve("qwen2-vl-2b", smoke=True, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.serve("qwen2.5-3b", smoke=True)       # device="cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        serve_mod.main(["--arch", "qwen2.5-3b", "--smoke"])
    from repro_torch.launch import trace
    with pytest.raises(RuntimeError, match="cuda"):
        trace.main([])


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen2.5-32b"])
def test_serve_main_serves_head_size_8_with_kernels(arch, capsys):
    """`python -m repro_torch.launch.serve --arch A --smoke --use-kernels
    --device cpu` serves the two smoke configs of head size 8, as the
    reference's serve does (the kernels take every head size from 1 to
    256), prompts of 128 (flash) and with offload."""
    assert serve_mod.configs.get_smoke_config(arch).resolved_head_dim == 8
    serve_mod.main(["--arch", arch, "--smoke", "--use-kernels", "--batch",
                    "2", "--prompt-len", "128", "--max-new", "4",
                    "--offload-kv", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("[cpu] prefill: 2x128 in ")
    assert "tokens identical: True" in out
