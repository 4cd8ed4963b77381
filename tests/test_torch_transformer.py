"""The port's Transformer LM against the JAX package's, on the CPU.

JAX initialises the weights; ``interop`` carries them to the port element
for element, and both run the same tokens.  float32 throughout: logits
atol 2e-4 (the bar of tests/test_flash_attention.py's model-level test),
gradients rtol 1e-4 / atol 1e-6, losses rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flink_parameter_server_tpu.models import transformer as ref_tr
from flink_parameter_server_tpu_torch import interop
from flink_parameter_server_tpu_torch.models import transformer as tr
from flink_parameter_server_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)

SMALL = dict(vocab_size=64, d_model=128, n_heads=2, n_layers=2, d_ff=128, max_seq=128)


def _configs(dtype="float32", **kw):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    args = {**SMALL, **kw}
    return ref_tr.TransformerConfig(**args, dtype=jdt), tr.TransformerConfig(**args, dtype=tdt)


def _carried(ref_cfg, cfg, seed=0):
    params = ref_tr.init_params(jax.random.PRNGKey(seed), ref_cfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    return params, interop.transformer_params_from_numpy(tree, cfg, device="cpu")


def _tokens(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (B, T)).astype(np.int32)


def test_init_tree_matches_reference_shapes_and_dtypes():
    for dtype in ("float32", "bfloat16"):
        ref_cfg, cfg = _configs(dtype)
        want = ref_tr.init_params(jax.random.PRNGKey(0), ref_cfg)
        model = tr.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        got = {"embed": model.embed, "final_norm": model.final_norm,
               "layers": [{k: getattr(layer, k) for k in want["layers"][0]} for layer in model.layers]}
        flat_w, tree_w = jax.tree.flatten(want)
        flat_g, tree_g = jax.tree.flatten(got)
        assert tree_w == tree_g
        for w, g in zip(flat_w, flat_g):
            assert tuple(w.shape) == tuple(g.shape)
            assert str(w.dtype) == str(g.dtype).replace("torch.", "")
            # same scale: the two generators draw different numbers
            ws, gs = float(np.std(np.asarray(w, np.float32))), float(g.detach().float().std())
            assert (ws == gs == 0.0) or abs(gs / ws - 1) < 0.1


def test_logits_match_with_carried_weights(monkeypatch):
    ref_cfg, cfg = _configs(flash_attention="off")
    params, model = _carried(ref_cfg, cfg)
    tokens = _tokens(2, 128)
    want = np.asarray(ref_tr.forward(params, jnp.asarray(tokens), ref_cfg))
    got = tr.forward(model, torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4)
    assert interop.transformer_params_to_numpy(model)["layers"][1]["wqkv"].shape == (128, 384)

    # the flash path, reached on the CPU by patching eligibility: the plain versions
    calls = []
    real = fa.flash_mha

    def counted(q, k, v):
        calls.append(q.shape)
        return real(q, k, v)

    monkeypatch.setattr(fa, "eligible", lambda T, D, device, mesh=None: True)
    monkeypatch.setattr(fa, "flash_mha", counted)
    auto = tr.forward(model, torch.from_numpy(tokens), dataclasses.replace(cfg, flash_attention="auto"))
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(auto.detach().numpy(), want, atol=2e-4)


def test_flash_on_raises_on_the_cpu():
    _, cfg = _configs(flash_attention="on")
    model = tr.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="ineligible"):
        tr.forward(model, torch.from_numpy(_tokens(1, 128)), cfg)
    # "auto" on the CPU runs the reference attention
    auto = tr.forward(model, torch.from_numpy(_tokens(1, 128)), dataclasses.replace(cfg, flash_attention="auto"))
    assert torch.isfinite(auto).all()


def test_eligible_head_width_the_kernels_lack_raises(monkeypatch):
    """An eligible shape goes to the kernel wrappers and never quietly to
    the reference: head_dim 320 (the column-split kernels on the card, their
    plain versions here) matches the JAX reference's logits, and a dtype
    the kernels lack raises.  Eligibility is patched to stand for a CUDA
    tensor."""
    ref_cfg, cfg = _configs(d_model=320, n_heads=1, flash_attention="auto")  # head_dim 320
    params, model = _carried(ref_cfg, cfg)
    tokens = _tokens(1, 128)
    monkeypatch.setattr(fa, "eligible", lambda T, D, device, mesh=None: fa.supports_shape(T, D))
    monkeypatch.setattr(tr, "reference_attention", lambda *a: pytest.fail("ran the reference"))
    off = dataclasses.replace(ref_cfg, flash_attention="off")
    want = np.asarray(ref_tr.forward(params, jnp.asarray(tokens), off))
    got = tr.forward(model, torch.from_numpy(tokens), cfg)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-4)
    half = tr.init_params(dataclasses.replace(cfg, dtype=torch.float16), device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tr.forward(half, torch.from_numpy(tokens), cfg)


@pytest.mark.parametrize("mask", [None, "rows", "cells"])
def test_next_token_xent_matches(mask):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 10, 64)).astype(np.float32)
    tokens = rng.integers(0, 64, (3, 10)).astype(np.int32)
    row_mask = {None: None, "rows": np.array([1, 0, 1], np.float32),
                "cells": (rng.random((3, 10)) > 0.3).astype(np.float32)}[mask]
    want = ref_tr.next_token_xent(jnp.asarray(logits), jnp.asarray(tokens),
                                  None if row_mask is None else jnp.asarray(row_mask))
    got = tr.next_token_xent(torch.from_numpy(logits), torch.from_numpy(tokens),
                             None if row_mask is None else torch.from_numpy(row_mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_lm_loss_gradients_match():
    ref_cfg, cfg = _configs(flash_attention="off")
    params, model = _carried(ref_cfg, cfg, seed=1)
    tokens = _tokens(2, 32, seed=2)
    row_mask = np.array([1.0, 0.5], np.float32)
    loss, grads = jax.value_and_grad(ref_tr.lm_loss)(
        params, {"tokens": jnp.asarray(tokens), "mask": jnp.asarray(row_mask)}, ref_cfg)
    got = tr.lm_loss(model, {"tokens": torch.from_numpy(tokens), "mask": torch.from_numpy(row_mask)}, cfg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    want = jax.tree.map(lambda x: np.asarray(x, np.float32), grads)
    np.testing.assert_allclose(model.embed.grad.numpy(), want["embed"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(model.final_norm.grad.numpy(), want["final_norm"], rtol=1e-4, atol=1e-6)
    for layer, ref_layer in zip(model.layers, want["layers"]):
        for key, w in ref_layer.items():
            np.testing.assert_allclose(getattr(layer, key).grad.numpy(), w, rtol=1e-4, atol=1e-6,
                                       err_msg=key)


def test_block_gelu_is_tanh():
    """jax.nn.gelu's default is the tanh form; torch's is erf.  A block
    with the reference's weights matches to 1e-5, and the erf form would
    miss by more than 1e-4 on these inputs."""
    ref_cfg, cfg = _configs(flash_attention="off")
    params, model = _carried(ref_cfg, cfg, seed=2)
    x = np.random.default_rng(3).normal(size=(2, 16, 128)).astype(np.float32) * 3
    want = np.asarray(ref_tr._apply_block(jnp.asarray(x), params["layers"][0], ref_cfg, None))
    got = tr._apply_block(torch.from_numpy(x), model.layers[0], cfg).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    h = torch.from_numpy(x) @ model.layers[0].w_up.detach()
    gap = (torch.nn.functional.gelu(h) - torch.nn.functional.gelu(h, approximate="tanh")).abs().max()
    assert float(gap) > 1e-4


def test_rope_and_rmsnorm_match():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (2, 8))
    np.testing.assert_allclose(tr._rope(torch.from_numpy(x), torch.from_numpy(pos.copy())).numpy(),
                               np.asarray(ref_tr._rope(jnp.asarray(x), jnp.asarray(pos))), atol=1e-6)
    g = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(tr._rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
                               np.asarray(ref_tr._rmsnorm(jnp.asarray(x), jnp.asarray(g))), atol=1e-6)


def test_bfloat16_forward_close_to_reference():
    """bfloat16 rounds at other places in the two frameworks; the logits
    (float32, from bfloat16 activations) stay within bfloat16 noise."""
    ref_cfg, cfg = _configs("bfloat16", flash_attention="off")
    params, model = _carried(ref_cfg, cfg)
    tokens = _tokens(2, 64)
    want = np.asarray(ref_tr.forward(params, jnp.asarray(tokens), ref_cfg))
    got = tr.forward(model, torch.from_numpy(tokens), cfg).detach().numpy()
    assert model.layers[0].wqkv.dtype == torch.bfloat16 and model.final_norm.dtype == torch.float32
    np.testing.assert_allclose(got, want, atol=0.05)


def test_config_validation():
    with pytest.raises(ValueError, match="flash_attention"):
        tr.TransformerConfig(flash_attention="always")
    # the mesh-less switch MoE came with models/moe.py (tests/test_torch_moe.py);
    # a capacity of 0 would drop every token
    assert tr.TransformerConfig(num_experts=4, moe_capacity=8).num_experts == 4
    assert tr.TransformerConfig(moe_capacity=8).num_experts == 0  # ignored without experts, as the reference does
    with pytest.raises(ValueError, match="moe_capacity"):
        tr.TransformerConfig(num_experts=4)
    # the data axis may take any name (a dp mesh's, tests/test_torch_dense_dp.py);
    # expert parallelism (tests/test_torch_moe_ep.py) and tensor, sequence and
    # pipeline parallelism (tests/test_torch_model_parallel.py) are ported: the
    # config takes their fields, and a mesh's layout is checked where one is given
    assert tr.TransformerConfig(dp_axis="data").dp_axis == "data"
    assert tr.TransformerConfig(ep_axis="ep").ep_axis == "ep"
    assert tr.TransformerConfig(num_experts=4, moe_capacity=8, ep_axis="ep").num_experts == 4
    for kw in (dict(use_ring_attention=True), dict(sp_axis="sp"), dict(tp_axis="tp"), dict(pp_axis="pp")):
        assert dataclasses.asdict(tr.TransformerConfig(**kw)).items() >= kw.items()
    _, cfg = _configs()
    model = tr.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        tr.forward(model, torch.zeros(1, 129, dtype=torch.int64), cfg)
    with pytest.raises(ValueError, match="takes a torch DeviceMesh"):
        tr.forward(model, torch.zeros(1, 8, dtype=torch.int64), cfg, mesh=object())


def test_remat_gives_the_same_gradients():
    _, cfg = _configs(flash_attention="off")
    model = tr.init_params(cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(2, 16))}
    tr.lm_loss(model, batch, cfg).backward()
    plain = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    tr.lm_loss(model, batch, dataclasses.replace(cfg, remat=True)).backward()
    for a, p in zip(plain, model.parameters()):
        torch.testing.assert_close(p.grad, a, rtol=1e-6, atol=1e-7)
