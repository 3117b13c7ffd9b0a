"""Port parity: the packed int4 codec, the delta index codec, the pytree
helpers and the package namespaces against the JAX package.

The int4 codes and scales are bitwise ``jax.jit(quantize_int4)``'s: under
``jit`` XLA turns the reference's ``amax / 7`` into ``amax * fl(1/7)``,
which can differ from the eager division in the last bit, and the port
follows the jitted program (as its int8 codec does).  Stochastic rounding
draws its noise from a shared key (``prng.key(s)`` and
``jax.random.key(s)``).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core
import repro_torch.data
import repro_torch.utils
from repro.core import compression as jcomp
from repro.utils import pytree as jtree
from repro_torch import prng
from repro_torch.core import compression as tcomp
from repro_torch.utils import pytree as ttree

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 256), (3, 2, 62), (1, 2), (7, 1024)]


def _x(shape, seed, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    if x.shape[-1] > 4:
        x[..., 3] = 0.0
        x.reshape(-1, x.shape[-1])[0] = 0.0  # an all-zero row takes the 1e-12 floor
    return x


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 3])
def test_int4_codes_and_scales_bitwise_jit(shape, seed):
    x = _x(shape, seed, scale=seed + 1.0)
    jp, js = jax.jit(jcomp.quantize_int4)(jnp.asarray(x))
    tp, ts = tcomp.quantize_int4(torch.as_tensor(x))
    assert tp.dtype == torch.uint8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tcomp.dequantize_int4(tp, ts).numpy(),
                                  np.asarray(jax.jit(jcomp.dequantize_int4)(jp, js)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [1, 9])
def test_int4_stochastic_rounding_bitwise_jit(shape, seed):
    x = _x(shape, seed)
    jp, js = jax.jit(jcomp.quantize_int4)(jnp.asarray(x), jax.random.key(seed))
    tp, ts = tcomp.quantize_int4(torch.as_tensor(x), prng.key(seed))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int4_stochastic_rounding_is_unbiased():
    x = torch.full((1, 4096), 0.3)
    outs = [tcomp.dequantize_int4(*tcomp.quantize_int4(x, prng.key(i))).mean().item()
            for i in range(20)]
    assert abs(np.mean(outs) - 0.3) < 4e-3


def test_int4_roundtrip_bounded():
    x = torch.as_tensor(_x((2, 128), 0))
    packed, s = tcomp.quantize_int4(x)
    assert packed.shape == (2, 64)
    y = tcomp.dequantize_int4(packed, s)
    assert (y - x).abs().max().item() <= s.max().item() * 0.51 + 1e-9


def test_int4_odd_last_axis_raises():
    x = _x((2, 7), 0)
    with pytest.raises(TypeError):  # the reference fails broadcasting the nibbles
        jax.jit(jcomp.quantize_int4)(jnp.asarray(x))
    with pytest.raises(ValueError, match="odd"):
        tcomp.quantize_int4(torch.as_tensor(x))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_delta_codec_bitwise_and_round_trip(dtype):
    rng = np.random.default_rng(4)
    idx = np.stack([rng.permutation(5000)[:96] for _ in range(3)]).astype(dtype)
    jd = np.asarray(jcomp.delta_encode_indices(jnp.asarray(idx.astype(np.int32))))
    td = tcomp.delta_encode_indices(torch.as_tensor(idx))
    np.testing.assert_array_equal(td.numpy(), jd)
    assert (td.numpy() >= 0).all()
    back = tcomp.delta_decode_indices(td)
    assert back.dtype == td.dtype
    np.testing.assert_array_equal(back.numpy(), np.sort(idx, axis=-1))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcomp.delta_decode_indices(jnp.asarray(jd))))


def _trees(rng):
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    c = np.arange(6, dtype=np.int32).reshape(2, 3)
    return ({"w": a, "blk": {"b": b, "c": c}},
            {"w": torch.as_tensor(a), "blk": {"b": torch.as_tensor(b).to(torch.bfloat16),
                                              "c": torch.as_tensor(c)}})


def test_tree_bytes_and_path_names_match():
    jt, tt = _trees(np.random.default_rng(0))
    jt_bf = dict(jt, blk=dict(jt["blk"], b=jnp.asarray(jt["blk"]["b"], jnp.bfloat16)))
    assert ttree.tree_bytes(tt) == jtree.tree_bytes(jt_bf) == 48 + 10 + 24
    seen_j, seen_t = {}, {}
    jout = jtree.tree_map_with_path_names(lambda n, l: seen_j.setdefault(n, l.shape), jt)
    tout = ttree.tree_map_with_path_names(lambda n, l: seen_t.setdefault(n, tuple(l.shape)), tt)
    assert seen_t == {k: tuple(v) for k, v in seen_j.items()}
    assert sorted(seen_t) == ["blk/b", "blk/c", "w"]
    assert tout["blk"]["c"] == tuple(jout["blk"]["c"])
    # sequence indices join the path too
    names = []
    ttree.tree_map_with_path_names(lambda n, l: names.append(n), {"s": (tt["w"], [tt["w"]])})
    jnames = []
    jtree.tree_map_with_path_names(lambda n, l: jnames.append(n), {"s": (jt["w"], [jt["w"]])})
    assert names == jnames == ["s/0", "s/1/0"]


@pytest.mark.parametrize("num_segments", [1, 5, 12])
@pytest.mark.parametrize("seed", [0, 2])
def test_segment_starts_match(num_segments, seed):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(-1, num_segments + 2, 40)).astype(np.int32)
    want = np.asarray(jtree.segment_starts(jnp.asarray(ids), num_segments))
    got = ttree.segment_starts(torch.as_tensor(ids), num_segments)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def _exports(path):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            yield from (a.asname or a.name for a in node.names)


@pytest.mark.parametrize("pkg", ["core", "data", "utils"])
def test_package_namespaces_export_the_reference_names(pkg):
    want = sorted(_exports(ROOT / "src" / "repro" / pkg / "__init__.py"))
    assert want
    port = getattr(repro_torch, pkg)
    assert [n for n in want if not hasattr(port, n)] == []
