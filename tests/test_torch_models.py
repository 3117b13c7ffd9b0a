"""Port parity: GN-LeNet logits and gradients, the loss, the flat-vector
order, SGD and the parameter conversion, against the JAX package on the
same (JAX-initialised) parameters.  Tolerances are fp32 with a different
summation order: atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import two_torch_threads  # noqa: F401  (autouse fixture)
from torch.func import grad, vmap

from repro.models import api as japi
from repro.models import cnn as jcnn
from repro.optim import optimizers as jopt
from repro.utils import pytree as jtree
from repro_torch.convert import params_from_jax
from repro_torch.models import api as tapi
from repro_torch.models import cnn as tcnn
from repro_torch.models.common import dense_init
from repro_torch.optim import optimizers as topt
from repro_torch.utils import pytree as ttree

ATOL = 1e-5


def _params(width=8, seed=0):
    return jax.tree_util.tree_map(np.asarray, jcnn.cnn_init(jax.random.key(seed), width=width))


def _images(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, b).astype(np.int32))


def _flat(tree):
    return {"/".join(k): v for k, v in _walk(tree)}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("width,seed", [(8, 0), (16, 1)])
def test_logits_match_jax(width, seed):
    p = _params(width, seed)
    x, _ = _images(seed=seed)
    want = np.asarray(jcnn.cnn_apply(p, jnp.asarray(x)))
    got = tcnn.cnn_apply(params_from_jax(p), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_group_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 6, 5, 16)).astype(np.float32)  # NHWC
    g, b = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    want = np.asarray(jcnn.group_norm(jnp.asarray(x), g, b))
    got = tcnn.group_norm(torch.as_tensor(x).permute(0, 3, 1, 2), torch.as_tensor(g),
                          torch.as_tensor(b)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_loss_and_per_leaf_grads_match_jax():
    p = _params()
    x, y = _images()

    def jloss(pp):
        return japi.cross_entropy(jcnn.cnn_apply(pp, jnp.asarray(x)), jnp.asarray(y))

    def tloss(pp):
        return tapi.cross_entropy(tcnn.cnn_apply(pp, torch.as_tensor(x)), torch.as_tensor(y))

    tp = params_from_jax(p)
    assert float(tloss(tp)) == pytest.approx(float(jloss(p)), abs=ATOL)
    jg, tg = _flat(jax.grad(jloss)(p)), _flat(grad(tloss)(tp))
    assert jg.keys() == tg.keys()
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


def test_node_stacked_grads_match_jax_vmap():
    n = 3
    stacked = jax.vmap(lambda k: jcnn.cnn_init(k, width=8))(jax.random.split(jax.random.key(4), n))
    stacked = jax.tree_util.tree_map(np.asarray, stacked)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(n, 4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (n, 4)).astype(np.int32)

    def jl(pp, a, b):
        return japi.cross_entropy(jcnn.cnn_apply(pp, a), b)

    def tl(pp, a, b):
        return tapi.cross_entropy(tcnn.cnn_apply(pp, a), b)

    jg = _flat(jax.vmap(jax.grad(jl))(stacked, jnp.asarray(x), jnp.asarray(y)))
    tg = _flat(vmap(grad(tl))(params_from_jax(stacked), torch.as_tensor(x),
                              torch.as_tensor(y).long()))
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), atol=ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("ignore_some", [False, True])
def test_cross_entropy_matches_jax(ignore_some):
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(5, 7, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (5, 7)).astype(np.int32)
    if ignore_some:
        labels[0, :3] = -1
    want = float(japi.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tapi.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels)))
    assert got == pytest.approx(want, abs=ATOL)


def test_tree_vector_bitwise_and_unvector_views():
    p = _params()
    want = np.asarray(jtree.tree_vector(p))
    tp = params_from_jax(p)
    got = ttree.tree_vector(tp)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ttree.tree_size(tp) == jtree.tree_size(p) == want.size
    back = ttree.tree_unvector(got, tp)
    for (ka, a), (kb, b) in zip(_walk(back), _walk(tp)):
        assert ka == kb
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # stacked: leaves are views of the (N, P) matrix
    X = torch.stack([got, 2 * got])
    views = ttree.tree_unvector(X, tp)
    views["fc2"]["b"].add_(1.0)
    off = want.size - 128 * 10 - 10  # fc2/b, then fc2/w (sorted keys)
    sl = slice(off, off + 10)
    np.testing.assert_array_equal(X[:, sl].numpy(), np.stack([want[sl], 2 * want[sl]]) + 1)


def test_params_from_jax_round_trip():
    p = _params(width=16, seed=3)
    tp = params_from_jax(p, "cpu")
    for (ka, a), (kb, b) in zip(_walk(p), _walk(tp)):
        assert ka == kb and b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), a)


def test_gnlenet_module_equals_functional():
    p = params_from_jax(_params())
    x, _ = _images()
    m = tcnn.GNLeNet({k: dict(v) for k, v in p.items()})
    np.testing.assert_array_equal(m(torch.as_tensor(x)).detach().numpy(),
                                  tcnn.cnn_apply(p, torch.as_tensor(x)).numpy())
    assert sum(t.numel() for t in m.parameters()) == ttree.tree_size(p)


@pytest.mark.parametrize("width", [8, 32])
def test_cnn_init_shapes_and_parameter_count(width):
    tp = tcnn.cnn_init(torch.Generator().manual_seed(0), width=width)
    jp = jax.eval_shape(lambda k: jcnn.cnn_init(k, width=width), jax.random.key(0))
    for (ka, a), (kb, b) in zip(_walk(jp), _walk(tp)):
        assert ka == kb and tuple(a.shape) == tuple(b.shape)
    assert ttree.tree_size(tp) == jtree.tree_size(jp)
    if width == 32:
        assert ttree.tree_size(tp) == 579_594  # the main path's P


def test_dense_init_truncation_and_std():
    t = dense_init(torch.Generator().manual_seed(1), (512, 256))
    assert t.shape == (512, 256) and t.dtype == torch.float32
    z = t * 512**0.5
    assert float(z.abs().max()) <= 2.0
    # std of a standard normal truncated at ±2
    assert float(z.std()) == pytest.approx(0.8796, abs=0.01)
    s = dense_init(torch.Generator().manual_seed(1), (75, 8), scale=0.1)
    assert float(s.abs().max()) <= 0.2 + 1e-7


def test_sgd_matches_jax_exactly():
    p = _params()
    g = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.25) * np.sign(a + 0.1), p)
    ju, _ = jopt.sgd(0.05).update(g, (), p)
    want = _flat(jax.tree_util.tree_map(np.asarray, jopt.apply_updates(p, ju)))
    opt = topt.make_optimizer("sgd", 0.05)
    tu, state = opt.update(params_from_jax(g), opt.init(None), None)
    got = _flat(topt.apply_updates(params_from_jax(p), tu))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    tp = params_from_jax(p)
    topt.apply_updates_(tp, tu)
    for k, v in _flat(tp).items():
        np.testing.assert_array_equal(v.numpy(), want[k])
    # momentum and AdamW are ported (tests/test_torch_optim.py holds them)
    for name in ("momentum", "adamw"):
        assert topt.make_optimizer(name, 0.1).init(params_from_jax(p)) is not None
    with pytest.raises(ValueError):
        topt.make_optimizer("lion", 0.1)
