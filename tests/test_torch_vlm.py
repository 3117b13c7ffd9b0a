"""Port parity of M-RoPE and the Qwen2-VL-72B config (the VLM family, its
frontend a stub of pre-projected embeddings) against the JAX package on
the CPU, in fp32.  Every M-RoPE input here has three different position
streams (t, h, w) — a text run, an image grid (t fixed, h the row, w the
column), then text — since equal streams make M-RoPE plain RoPE and would
pass a wrong band mapping:

- ``apply_mrope`` within 1e-6 at the smoke and the published sections;
- GQA attention under M-RoPE, full pass and decode, within 1e-5;
- the smoke config: forward logits from embeddings within 1e-4, the
  prefill from embeddings and its decode steps within 1e-4, greedy ids
  equal to the JAX engine's, one decentralized train step through the
  reference's jitted ``make_train_step`` within 1e-5, and ``param_count``
  of the published config equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_zoo_parity import (  # noqa: F401  (two_torch_threads: autouse fixture)
    both,
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
from repro.models import common as jcommon
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon

ARCH = "qwen2-vl-72b"


def vl_positions(B, text0, grid, text1, start=0):
    """(3, B, S) int32 M-RoPE positions: ``text0`` text tokens, a ``grid``
    = (rows, cols) image (t fixed, h = row, w = column), then ``text1``
    text tokens from one past the image's largest position."""
    t = list(range(start, start + text0))
    h, w = list(t), list(t)
    base = start + text0
    rows, cols = grid
    for r in range(rows):
        for c in range(cols):
            t.append(base)
            h.append(base + r)
            w.append(base + c)
    nxt = base + max(rows, cols)
    tail = list(range(nxt, nxt + text1))
    pos = np.array([t + tail, h + tail, w + tail], dtype=np.int32)  # (3, S)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, pos.shape[1])))


@pytest.mark.parametrize("sections,hd,theta", [((8, 4, 4), 32, 1e6), ((16, 24, 24), 128, 1e6),
                                               ((4, 2, 2), 16, 1e4)])
def test_apply_mrope_three_streams_match_jax(sections, hd, theta):
    pos = vl_positions(2, 5, (4, 6), 7, start=1000)  # large angles too
    assert not (np.array_equal(pos[0], pos[1]) or np.array_equal(pos[1], pos[2]))
    x = normal(0, 2, pos.shape[2], 3, hd)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    got = tcommon.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), theta, sections)
    close(got, want, 1e-6)
    # the streams matter: plain RoPE on the t stream differs inside the image
    plain = tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[0]), theta)
    assert not torch.allclose(plain, got, atol=1e-3)
    close(got[:, :5], plain[:, :5], 1e-6)  # the text run: all streams equal


def attn_cfg():
    return JConfig(name="v", family="vlm", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                   vocab=64, qkv_bias=True, mrope_sections=(4, 2, 2), stub_frontend=True)


@pytest.mark.parametrize("route", ["full", "decode"])
def test_mrope_attention_matches_jax(route):
    cfg = attn_cfg()
    jp, tp = both(noisy(jattn.attn_init(jax.random.key(0), cfg), 1))
    pos = vl_positions(2, 3, (3, 4), 5)
    S = pos.shape[2]
    if route == "full":
        x = normal(2, 2, S, cfg.d_model)
        want, want_c = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
        got, got_c = tattn.attn_apply(tp, tcfg(cfg), torch.as_tensor(x), torch.as_tensor(pos))
    else:
        index = 9
        x, p1 = normal(2, 2, 1, cfg.d_model), pos[:, :, index:index + 1]
        cache = {"k": normal(3, 2, S, 2, cfg.hd), "v": normal(4, 2, S, 2, cfg.hd)}
        want, want_c = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(p1),
                                        cache={k: jnp.asarray(v) for k, v in cache.items()},
                                        cache_index=jnp.int32(index))
        got, got_c = tattn.attn_apply(tp, tcfg(cfg), torch.as_tensor(x), torch.as_tensor(p1),
                                      cache={k: torch.as_tensor(v.copy())
                                             for k, v in cache.items()}, cache_index=index)
    close(got, want, 1e-5)
    for k in ("k", "v"):
        close(got_c[k], want_c[k], 1e-5)


def _smoke(seed=7):
    jcfg, cfg = jsmoke(ARCH), get_smoke_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jp, tp = both(jax_params(jcfg, seed))
    pos = vl_positions(2, 4, (4, 4), 4)
    emb = normal(9, 2, pos.shape[2], jcfg.d_model)
    return jcfg, cfg, jp, tp, emb, pos


def test_qwen2_vl_smoke_forward_from_embeddings_matches_jax():
    jcfg, cfg, jp, tp, emb, pos = _smoke()
    want, _ = jax.jit(lambda p, e, q: japi.forward(p, jcfg, {"embeddings": e, "positions": q}))(
        jp, jnp.asarray(emb), jnp.asarray(pos))
    got, _ = tapi.forward(tp, cfg, {"embeddings": torch.as_tensor(emb),
                                    "positions": torch.as_tensor(pos)})
    close(got, want, 1e-4)
    # the default positions (all streams 0..S-1) differ from the image's
    plain, _ = tapi.forward(tp, cfg, {"embeddings": torch.as_tensor(emb)})
    assert not torch.allclose(plain, got, atol=1e-3)


def test_qwen2_vl_prefill_from_embeddings_then_decode_matches_jax():
    """The one-shot prefill from stub embeddings and three-stream positions,
    then token decode steps (all three streams at the index): logits and the
    cache within 1e-4."""
    jcfg, cfg, jp, tp, emb, pos = _smoke()
    S = pos.shape[2]
    jl, jc = jax.jit(lambda p, e, q: japi.prefill(p, jcfg, {"embeddings": e, "positions": q},
                                                  S + 4))(jp, jnp.asarray(emb), jnp.asarray(pos))
    tl, tc = tapi.prefill(tp, cfg, {"embeddings": torch.as_tensor(emb),
                                    "positions": torch.as_tensor(pos)}, S + 4)
    close(tl, jl, 1e-4)
    for k in ("k", "v"):
        close(tc["dense_layers"][k], jc["dense_layers"][k], 1e-4)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 4)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, i: japi.decode_step(p, jcfg, c, t, i))
    for i in range(4):
        jlog, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(S + i))
        tlog, tc = tapi.decode_step(tp, cfg, tc, torch.as_tensor(toks[:, i:i + 1]), S + i)
        close(tlog, jlog, 1e-4)


def test_qwen2_vl_greedy_ids_equal_jax():
    check_greedy_ids(ARCH)


def test_qwen2_vl_train_step_matches_jax():
    check_train_step(ARCH)


def test_qwen2_vl_param_count_at_full_size_equals_jax():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget(ARCH))
    assert tapi.param_count(cfg) == japi.param_count(jget(ARCH))
