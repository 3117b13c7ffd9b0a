"""Port parity of MLA (DeepSeek-V2's latent attention) and the
DeepSeek-V2-236B config against the JAX package on the CPU, in fp32:

- the attention module on its three routes (naive train/prefill with
  per-head k/v, ``attn_impl="chunked"`` with W_uk absorbed and a running
  softmax over latent chunks, decode over the latent cache), with
  ``q_lora_rank`` on and off: outputs and caches within 1e-5;
- the reference's MLA prefill-then-decode config
  (``tests/test_prefill.py``) against the JAX forward within 1e-4;
- the smoke config: forward and decode logits within 1e-4, greedy ids
  equal to the JAX engine's, one decentralized train step through the
  reference's jitted ``make_train_step`` within 1e-5, the converter bitwise
  in bf16, and ``param_count`` of the published config equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_zoo_parity import (  # noqa: F401  (two_torch_threads: autouse fixture)
    both,
    check_bf16_bitwise,
    check_greedy_ids,
    check_train_step,
    close,
    jax_params,
    noisy,
    normal,
    tcfg,
    two_torch_threads,
)

from repro.configs import get_config as jget
from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn

ARCH = "deepseek-v2-236b"
B, S = 2, 32


def mla_cfg(q_lora, impl="naive"):
    return JConfig(name="m", family="dense", d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                   vocab=64, mla=True, kv_lora_rank=32, q_lora_rank=q_lora, qk_nope_dim=16,
                   qk_rope_dim=8, v_head_dim=16, attn_impl=impl, attn_chunk=8)


def jax_params_attn(cfg, seed):
    return noisy(jattn.attn_init(jax.random.key(0), cfg), seed)


@pytest.mark.parametrize("q_lora", [None, 24])
@pytest.mark.parametrize("route", ["naive", "chunked", "decode"])
def test_mla_attention_routes_match_jax(route, q_lora):
    cfg = mla_cfg(q_lora, "chunked" if route == "chunked" else "naive")
    jp, tp = both(jax_params_attn(cfg, 1))
    assert sorted(tp) == sorted(jp)
    assert ("w_dq" in tp) == bool(q_lora)
    if route == "decode":
        T, index = 12, 5
        x = normal(2, B, 1, cfg.d_model)
        cache = {"ckv": normal(3, B, T, cfg.kv_lora_rank), "krope": normal(4, B, T, cfg.qk_rope_dim)}
        pos = np.full((B, 1), index)
        want, want_c = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                        cache={k: jnp.asarray(v) for k, v in cache.items()},
                                        cache_index=jnp.int32(index))
        tc = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
        got, got_c = tattn.attn_apply(tp, tcfg(cfg), torch.as_tensor(x), torch.as_tensor(pos),
                                      cache=tc, cache_index=index)
        assert got_c is tc  # written in place
    else:
        x = normal(2, B, S, cfg.d_model)
        pos = np.arange(S)[None].repeat(B, 0) + 3
        want, want_c = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
        got, got_c = tattn.attn_apply(tp, tcfg(cfg), torch.as_tensor(x), torch.as_tensor(pos))
    close(got, want, 1e-5)
    assert sorted(got_c) == sorted(want_c) == ["ckv", "krope"]
    for k in want_c:
        close(got_c[k], want_c[k], 1e-5)


def test_mla_chunked_route_equals_naive_route():
    """The two full-pass routes of the port compute the same attention."""
    _, tp = both(jax_params_attn(mla_cfg(24), 1))
    x, pos = torch.as_tensor(normal(2, B, S, 64)), torch.arange(S)[None].expand(B, S)
    naive, _ = tattn.attn_apply(tp, tcfg(mla_cfg(24)), x, pos)
    chunked, _ = tattn.attn_apply(tp, tcfg(mla_cfg(24, "chunked")), x, pos)
    close(chunked, naive.detach(), 1e-5)


def test_mla_latent_cache_layout_as_the_reference():
    cfg = mla_cfg(None)
    want = jattn.attn_cache_init(cfg, 2, 10, layers=3)
    got = tattn.attn_cache_init(tcfg(cfg), 2, 10, layers=3)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_mla_prefill_then_decode_matches_forward():
    """The reference's MLA prefill-then-decode config: the port's prefill of
    half the tokens and its decode steps against the JAX forward, and the
    port's forward too, within 1e-4."""
    cfg = JConfig(name="m", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                  d_ff=128, vocab=64, mla=True, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                  v_head_dim=16)
    jp, tp = both(jax_params(cfg, 6))
    toks = np.random.default_rng(1).integers(0, 64, (2, 16)).astype(np.int32)
    full, _ = jax.jit(lambda p, t: japi.forward(p, cfg, {"tokens": t}))(jp, jnp.asarray(toks))
    tt, c = torch.as_tensor(toks), tcfg(cfg)
    close(tapi.forward(tp, c, {"tokens": tt})[0], full, 1e-4)
    S0 = 8
    logits0, cache = tapi.prefill(tp, c, {"tokens": tt[:, :S0]}, max_len=16)
    assert tuple(cache["dense_layers"]["ckv"].shape) == (2, 2, 16, 32)
    close(logits0, full[:, S0 - 1], 1e-4)
    for t in range(S0, 16):
        logits, cache = tapi.decode_step(tp, c, cache, tt[:, t:t + 1], t)
        close(logits[:, 0], full[:, t], 1e-4)


def test_deepseek_smoke_forward_and_decode_match_jax():
    jcfg, cfg = jsmoke(ARCH), get_smoke_config(ARCH)
    jp, tp = both(jax_params(jcfg, 7))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    want, want_aux = jax.jit(lambda p, t: japi.forward(p, jcfg, {"tokens": t}))(
        jp, jnp.asarray(toks))
    got, aux = tapi.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    close(got, want, 1e-4)
    close(aux, want_aux, 1e-5)
    # prefill then decode, each side its own
    S0 = 12
    jl, jc = jax.jit(lambda p, t: japi.prefill(p, jcfg, {"tokens": t}, 16))(
        jp, jnp.asarray(toks[:, :S0]))
    tl, tc = tapi.prefill(tp, cfg, {"tokens": torch.as_tensor(toks[:, :S0])}, 16)
    close(tl, jl, 1e-4)
    assert sorted(tc) == sorted(jc) == ["dense_layers", "group_moe"]
    for name in tc:
        for k in tc[name]:
            close(tc[name][k], jc[name][k], 1e-4)
    jstep = jax.jit(lambda p, c, t, i: japi.decode_step(p, jcfg, c, t, i))
    for t in range(S0, 16):
        jlog, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tlog, tc = tapi.decode_step(tp, cfg, tc, torch.as_tensor(toks[:, t:t + 1]), t)
        close(tlog, jlog, 1e-4)


def test_deepseek_greedy_ids_equal_jax():
    check_greedy_ids(ARCH)


def test_deepseek_train_step_matches_jax():
    got = check_train_step(ARCH)
    assert "dense_layers" in got and "group_moe" in got
    assert "w_uk" in got["group_moe"]["attn"] and "w_dq" in got["group_moe"]["attn"]


def test_deepseek_params_carry_bitwise_in_bf16():
    paths = check_bf16_bitwise(ARCH)
    for leaf in ("w_dkv", "kv_norm", "w_uk", "w_uv", "w_dq", "q_norm"):
        assert any(p.endswith(f"['attn']['{leaf}']") for p in paths), leaf


def test_deepseek_param_count_at_full_size_equals_jax():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget(ARCH))
    assert tapi.param_count(cfg) == japi.param_count(jget(ARCH))
