"""Port parity of cross-attention and the Whisper-style encoder-decoder
(``models/encdec.py``, the Whisper-tiny config) against the JAX package on
the CPU, in fp32:

- cross-attention, fresh (k/v from ``kv_src``) and cached (k/v read from
  the cache, nothing written), with and without qk-norm (the query always
  normed, the key only when fresh), and the encoder's non-causal
  self-attention: outputs within 1e-5;
- the smoke config: ``decode_train`` logits within 1e-4, decode logits
  against ``encdec_cache_init``'s real cross cache within 1e-4,
  ``ServingEngine`` greedy ids equal to the JAX engine's (which decodes
  against the zero cross cache of ``init_cache``), the converter bitwise
  in bf16 over both layer stacks, and ``param_count`` of the published
  config equal;
- ``LMTrainer`` refuses the family: the token batcher has no frames.
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
from repro.models import encdec as jencdec
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec

ARCH = "whisper-tiny"
B, S, T = 2, 12, 20


def xcfg(qk_norm):
    return JConfig(name="x", family="encdec", d_model=48, n_heads=6, n_kv_heads=2, d_ff=64,
                   vocab=64, n_enc_layers=1, enc_seq=T, qk_norm=qk_norm, qkv_bias=True)


@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("form", ["fresh", "cached", "encoder"])
def test_cross_attention_matches_jax(form, qk_norm):
    cfg = xcfg(qk_norm)
    jp, tp = both(noisy(jattn.attn_init(jax.random.key(0), cfg, cross=True), 1))
    assert sorted(tp) == sorted(jp)
    x, src = normal(2, B, S, cfg.d_model), normal(3, B, T, cfg.d_model)
    pos = np.arange(S)[None].repeat(B, 0)
    kw_j, kw_t = {}, {}
    if form == "fresh":
        kw_j, kw_t = dict(kv_src=jnp.asarray(src)), dict(kv_src=torch.as_tensor(src))
    elif form == "cached":
        x, pos = x[:, :1], np.full((B, 1), 7)
        cache = {"k": normal(4, B, T, 2, cfg.hd), "v": normal(5, B, T, 2, cfg.hd)}
        kw_j = dict(cache={k: jnp.asarray(v) for k, v in cache.items()}, cross=True)
        tc = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
        kw_t = dict(cache=tc, cross=True)
    else:  # the encoder's non-causal self-attention (RoPE, every key)
        kw_j = kw_t = dict(causal=False)
    want, want_c = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos), **kw_j)
    got, got_c = tattn.attn_apply(tp, tcfg(cfg), torch.as_tensor(x), torch.as_tensor(pos), **kw_t)
    close(got, want, 1e-5)
    for k in ("k", "v"):
        close(got_c[k], want_c[k], 1e-5)
    if form == "cached":  # read, not written
        assert got_c is tc
        for k in ("k", "v"):
            assert np.array_equal(tc[k].numpy(), cache[k])


def _smoke():
    jcfg, cfg = jsmoke(ARCH), get_smoke_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jp, tp = both(jax_params(jcfg, 7))
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, 16)).astype(np.int32)
    return jcfg, cfg, jp, tp, frames, toks


def test_whisper_smoke_forward_matches_jax():
    """``forward`` of the encdec family (``decode_train``: encoder, then the
    teacher-forced decoder with cross-attention) and the encoder alone."""
    jcfg, cfg, jp, tp, frames, toks = _smoke()
    want, _ = jax.jit(lambda p, f, t: japi.forward(p, jcfg, {"frames": f, "tokens": t}))(
        jp, jnp.asarray(frames), jnp.asarray(toks))
    got, aux = tapi.forward(tp, cfg, {"frames": torch.as_tensor(frames),
                                      "tokens": torch.as_tensor(toks)})
    close(got, want, 1e-4)
    assert float(aux) == 0.0
    close(tencdec.encode(tp, cfg, torch.as_tensor(frames)),
          jax.jit(lambda p, f: jencdec.encode(p, jcfg, f))(jp, jnp.asarray(frames)), 1e-4)


def test_whisper_decode_against_the_real_cross_cache_matches_jax():
    """``encdec_cache_init`` (the cross k/v of every decoder layer from the
    encoder output), then ``decode_step`` token by token: logits within
    1e-4 of the JAX package's, and of the port's own forward."""
    jcfg, cfg, jp, tp, frames, toks = _smoke()
    jc = jax.jit(lambda p, f: jencdec.encdec_cache_init(p, jcfg, f, B, 16))(
        jp, jnp.asarray(frames))
    tc = tencdec.encdec_cache_init(tp, cfg, torch.as_tensor(frames), B, 16)
    for part in ("self", "cross"):
        for k in ("k", "v"):
            assert tuple(tc[part][k].shape) == jc[part][k].shape
            close(tc[part][k], jc[part][k], 1e-4)
    full, _ = tapi.forward(tp, cfg, {"frames": torch.as_tensor(frames),
                                     "tokens": torch.as_tensor(toks)})
    jstep = jax.jit(lambda p, c, t, i: japi.decode_step(p, jcfg, c, t, i))
    for t in range(toks.shape[1]):
        jlog, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        tlog, tc = tapi.decode_step(tp, cfg, tc, torch.as_tensor(toks[:, t:t + 1]), t)
        close(tlog, jlog, 1e-4)
        close(tlog[:, 0], full[:, t].detach(), 1e-4)


def test_whisper_greedy_ids_equal_jax():
    """The engine prefills token by token over ``init_cache``: the
    reference's zero cross cache, mirrored."""
    check_greedy_ids(ARCH)
    cfg = get_smoke_config(ARCH)
    zc = tapi.init_cache(cfg, 2, 24)
    jc = japi.init_cache(jsmoke(ARCH), 2, 24)
    for part in ("self", "cross"):
        for k in ("k", "v"):
            assert tuple(zc[part][k].shape) == jc[part][k].shape
            assert not zc[part][k].any()


def test_whisper_params_carry_bitwise_in_bf16():
    paths = check_bf16_bitwise(ARCH)
    assert any(p.startswith("['enc_layers']['attn']") for p in paths)
    assert any(p.startswith("['dec_layers']['xattn']") for p in paths)
    assert "['enc_pos']" in paths


def test_whisper_param_count_at_full_size_equals_jax():
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget(ARCH))
    assert tapi.param_count(cfg) == japi.param_count(jget(ARCH))


def test_lm_trainer_refuses_encdec():
    from repro_torch.launch.train import LMTrainer, parse_args

    with pytest.raises(ValueError, match="frames"):
        LMTrainer(parse_args(["--device", "cpu", "--arch", ARCH, "--nodes", "2"]))
