"""Port parity of the two paths of the language-model slice against the
JAX package, on the CPU: ``ServingEngine.generate`` greedy ids equal to the
JAX engine's (a dense config with a 128-token window and 128-token prompts,
so both take their sliding-window kernel route, the JAX one in Pallas
interpret mode; the Mamba2 and Zamba2 smoke configs), and the teacher-forced
forward and loss of the Mamba2 smoke config with the SSD chunk kernel's
route (``ssm_impl="pallas"``).  Logits within 1e-4 (fp32, another
summation order over two or more layers)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)

from repro.configs import get_smoke_config as jsmoke
from repro.models import api as japi
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.convert import params_from_jax
from repro_torch.models import api as tapi
from repro_torch.models.attention import swa_route
from repro_torch.serving import ServeConfig, ServingEngine


def _pair(arch, **over):
    jcfg, tcfg = jsmoke(arch).replace(**over), tsmoke(arch).replace(**over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    params = jax.tree_util.tree_map(np.asarray, japi.init_params(jcfg, jax.random.key(0)))
    return jcfg, tcfg, params


@pytest.mark.parametrize("arch,over,S0,new", [
    ("smollm-135m", dict(sliding_window=128, attn_impl="pallas_swa"), 128, 8),
    ("mamba2-370m", {}, 16, 6),
    ("zamba2-1.2b", {}, 16, 6),
])
def test_generate_greedy_ids_equal_jax(arch, over, S0, new):
    jcfg, tcfg, params = _pair(arch, **over)
    if tcfg.family == "dense":
        assert swa_route(tcfg, S0)
    prompts = np.random.default_rng(1).integers(1, jcfg.vocab, (2, S0)).astype(np.int32)
    max_len = S0 + new
    want = JServingEngine(jcfg, JServeConfig(batch=2, max_len=max_len),
                          jax.tree_util.tree_map(jnp.asarray, params)).generate(
        jnp.asarray(prompts), max_new=new)
    eng = ServingEngine(tcfg, ServeConfig(batch=2, max_len=max_len), params_from_jax(params),
                        "cpu")
    got = eng.generate(torch.as_tensor(prompts), max_new=new)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mamba2_forward_and_loss_with_the_chunk_kernel_route():
    jcfg, tcfg, params = _pair("mamba2-370m", ssm_impl="pallas")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 48)).astype(np.int32)
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(np.roll(toks, -1, 1))}
    batch_t = {k: torch.as_tensor(np.array(v)) for k, v in batch_j.items()}
    want, _ = japi.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg, batch_j)
    got, _ = tapi.forward(params_from_jax(params), tcfg, batch_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        float(tapi.loss_fn(params_from_jax(params), tcfg, batch_t)),
        float(japi.loss_fn(jax.tree_util.tree_map(jnp.asarray, params), jcfg, batch_j)),
        rtol=1e-5)
