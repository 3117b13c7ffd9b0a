"""Port parity of the language-model modules, module by module, against the
JAX package at small sizes in fp32: RMSNorm, RoPE, GQA attention on its
three routes (naive, chunked, the sliding-window kernel's, whose JAX side
runs the Pallas kernel in interpret mode) and the ring-buffer decode, the
dense prefill and decode, the Mamba2 block with both impls and its decode
step, and the hybrid forward and decode; plus the parameter converter.

Parameters are the JAX package's own inits with numpy noise added (so zero
biases and unit norms are exercised too), carried over by
``params_from_jax``; inputs come from numpy seeds.  Tolerances: fp32 with
another summation order gives about 1e-6 per op; 1e-5 for single modules,
1e-4 where two or more layers, a softmax over 256 keys or the SSD
recurrence compound it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro_torch.convert import params_from_jax
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig as TConfig

DENSE = JConfig(name="d", family="dense", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
                d_ff=128, vocab=128, qk_norm=True, qkv_bias=True, sliding_window=128)
SSM = JConfig(name="s", family="ssm", n_layers=2, d_model=64, vocab=128, ssm_state=16,
              ssm_headdim=16, ssm_chunk=16)
HYBRID = JConfig(name="h", family="hybrid", n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
                 d_ff=128, vocab=128, ssm_state=16, ssm_headdim=16, ssm_chunk=8, attn_every=2)


def tcfg(cfg):
    return TConfig(**dataclasses.asdict(cfg))


def noisy(tree, seed, scale=0.05):
    """The JAX tree as numpy, each float leaf plus scaled normal noise."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        return (a + scale * rng.normal(size=a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map(f, tree)


def both(tree):
    """(JAX tree, torch tree) of one numpy tree."""
    return jax.tree_util.tree_map(jnp.asarray, tree), params_from_jax(tree)


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def test_rms_norm_and_rope():
    x, w = normal(0, 2, 5, 3, 16), normal(1, 16)
    close(tcommon.rms_norm(torch.as_tensor(x), torch.as_tensor(w), 1e-5),
          jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-6)
    pos = np.arange(5)[None].repeat(2, 0) + 1000  # large angles
    close(tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0),
          jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), 1e-5)


@pytest.mark.parametrize("impl,S,window", [
    ("naive", 48, None), ("naive", 256, 128), ("chunked", 256, 128), ("pallas_swa", 256, 128),
])
def test_attn_apply_full_pass(impl, S, window):
    cfg = DENSE.replace(attn_impl=impl, sliding_window=window, attn_chunk=64)
    jp, tp = both(noisy(jattn.attn_init(jax.random.key(0), cfg), 0))
    x = normal(2, 2, S, cfg.d_model)
    pos = np.arange(S)[None].repeat(2, 0)
    want, wc = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    got, gc = tattn.attn_apply(tp, tcfg(cfg), torch.as_tensor(x), torch.as_tensor(pos))
    assert tattn.swa_route(tcfg(cfg), S) == (impl == "pallas_swa")
    close(got, want, 1e-5)
    for name in ("k", "v"):
        close(gc[name], wc[name], 1e-5)


def test_ring_buffer_decode():
    """Window 8, cache of 8 slots, 12 decode steps: slot = index % 8 wraps."""
    cfg = DENSE.replace(sliding_window=8)
    jp, tp = both(noisy(jattn.attn_init(jax.random.key(1), cfg), 1))
    jc = jattn.attn_cache_init(cfg, 2, 16)
    tc = tattn.attn_cache_init(tcfg(cfg), 2, 16)
    assert tc["k"].shape[1] == 8
    for i in range(12):
        x = normal(10 + i, 2, 1, cfg.d_model)
        pos = np.full((2, 1), i)
        want, jc = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos), cache=jc,
                                    cache_index=jnp.int32(i))
        got, tc = tattn.attn_apply(tp, tcfg(cfg), torch.as_tensor(x), torch.as_tensor(pos),
                                   cache=tc, cache_index=i)
        close(got, want, 1e-5)
    close(tc["k"], jc["k"], 1e-5)


def test_dense_prefill_and_decode():
    """The kernel route (window 128, S 128): prefill logits and cache, then
    decode steps past the window (the ring buffer wraps)."""
    cfg = DENSE.replace(attn_impl="pallas_swa")
    jp, tp = both(noisy(japi.init_params(cfg, jax.random.key(2)), 2))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 128)).astype(np.int32)
    want, jc = japi.prefill(jp, cfg, {"tokens": jnp.asarray(toks)}, 136)
    got, tc = tapi.prefill(tp, tcfg(cfg), {"tokens": torch.as_tensor(toks)}, 136)
    close(got, want, 1e-4)
    for name in ("k", "v"):
        assert tuple(tc["dense_layers"][name].shape) == jc["dense_layers"][name].shape
        close(tc["dense_layers"][name], jc["dense_layers"][name], 1e-4)
    for i in range(128, 132):
        t = toks[:, i - 128:i - 127]
        want, jc = japi.decode_step(jp, cfg, jc, jnp.asarray(t), jnp.int32(i))
        got, tc = tapi.decode_step(tp, tcfg(cfg), tc, torch.as_tensor(t), i)
        close(got, want, 1e-4)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_ssm_apply(impl):
    cfg = SSM.replace(ssm_impl=impl)
    jp, tp = both(noisy(jssm.ssm_init(jax.random.key(4), cfg), 4))
    x = normal(5, 2, 48, cfg.d_model)  # 3 chunks of 16
    close(tssm.ssm_apply(tp, tcfg(cfg), torch.as_tensor(x)),
          jssm.ssm_apply(jp, cfg, jnp.asarray(x)), 1e-4)


def test_ssm_decode_step():
    jp, tp = both(noisy(jssm.ssm_init(jax.random.key(6), SSM), 6))
    jc = jssm.ssm_cache_init(SSM, 2)
    tc = tssm.ssm_cache_init(tcfg(SSM), 2)
    for i in range(6):
        x = normal(20 + i, 2, 1, SSM.d_model)
        want, jc = jssm.ssm_decode_step(jp, SSM, jnp.asarray(x), jc)
        got, tc = tssm.ssm_decode_step(tp, tcfg(SSM), torch.as_tensor(x), tc)
        close(got, want, 1e-5)
    close(tc["state"], jc["state"], 1e-5)
    close(tc["conv"], jc["conv"], 1e-6)


def test_hybrid_forward_and_decode():
    cfg = HYBRID
    jp, tp = both(noisy(japi.init_params(cfg, jax.random.key(7)), 7))
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    want, _ = japi.forward(jp, cfg, {"tokens": jnp.asarray(toks)})
    got, _ = tapi.forward(tp, tcfg(cfg), {"tokens": torch.as_tensor(toks)})
    close(got, want, 1e-4)
    full = got
    jc = japi.init_cache(cfg, 2, 16)
    tc = tapi.init_cache(tcfg(cfg), 2, 16)
    for i in range(3):
        t = toks[:, i:i + 1]
        want, jc = japi.decode_step(jp, cfg, jc, jnp.asarray(t), jnp.int32(i))
        got, tc = tapi.decode_step(tp, tcfg(cfg), tc, torch.as_tensor(t), i)
        close(got, want, 1e-4)
        close(got[:, 0], full[:, i], 2e-3)  # decode against forward, as test_decode_consistency


def test_param_counts_match():
    for cfg in (DENSE, SSM, HYBRID):
        assert tapi.param_count(tcfg(cfg)) == japi.param_count(cfg)


def test_converter_carries_every_leaf_bitwise():
    """bf16 (stacked and doubly stacked), the fp32 leaves a bf16 model keeps
    (A_log, D, dt_bias) and integer leaves: same shapes, dtypes and bits."""
    cfg = HYBRID.replace(dtype="bfloat16")
    tree = dict(japi.init_params(cfg, jax.random.key(9)))
    tree["ids"] = jnp.arange(-3, 9, dtype=jnp.int32).reshape(3, 4)
    got = params_from_jax(tree)
    assert got["mamba_seg"]["ssm"]["in_proj"].shape[:2] == (2, 2)  # segment, layer
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in flat_j:
        t = got
        for k in path:
            t = t[k.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            assert str(t.dtype).split(".")[-1] == a.dtype.name
            assert np.array_equal(t.numpy(), a)
    assert got["mamba_seg"]["ssm"]["A_log"].dtype == torch.float32
    assert got["mamba_seg"]["ssm"]["in_proj"].dtype == torch.bfloat16
