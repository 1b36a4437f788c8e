"""Port parity: the Eq.-7 pool-scoring kernel (B1).

On the CPU the port's wrappers run the kernel's plain version; it is held
against the JAX package's Pallas kernel (interpret mode, as that package's
own tests run it) and its vmap oracle at rtol 1e-5, atol 1e-6.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hfl as JH  # noqa: E402
from repro.core import networks as JN  # noqa: E402
from repro.kernels.pool_mlp import ops as JOPS  # noqa: E402
from repro.kernels.pool_mlp.ref import pool_errors_ref as j_ref  # noqa: E402
from repro.sharding import spec as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.core import hfl as TH  # noqa: E402
from repro_torch.kernels.pool_mlp import kernel as TK  # noqa: E402
from repro_torch.kernels.pool_mlp import ops as TOPS  # noqa: E402
from repro_torch.kernels.pool_mlp.ref import pool_errors_ref as t_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _pool_np(ns, w, seed0=0):
    """The JAX test suite's pool: ns heads from PRNGKey(seed0 + i)."""
    pool = [JS.materialize(JN.head_schema(w), jax.random.PRNGKey(seed0 + i))
            for i in range(ns)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *pool)


def _probe(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(tree):
    return convert.params_from_numpy(tree)


@pytest.mark.parametrize("ns,R,w,bp", [(10, 50, 3, 8), (4, 20, 5, 4),
                                       (16, 50, 3, 16), (3, 7, 2, 8)])
def test_pool_mlp_errors_match_reference(ns, R, w, bp):
    pool = _pool_np(ns, w)
    xd, y = _probe((R, w), 99), _probe((R,), 98)
    ours = TOPS.pool_mlp_errors(_t(pool), torch.tensor(xd), torch.tensor(y),
                                block_pool=bp).numpy()
    theirs = np.asarray(JOPS.pool_mlp_errors(pool, xd, y, block_pool=bp))
    oracle = np.asarray(j_ref(pool, xd, y))
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_allclose(ours, oracle, **TOL)
    np.testing.assert_allclose(
        t_ref(_t(pool), torch.tensor(xd), torch.tensor(y)).numpy(), oracle,
        **TOL)
    assert int(np.argmin(ours)) == int(np.argmin(theirs)) \
        == int(np.argmin(oracle))
    fb = TH.pool_errors(_t(pool), torch.tensor(xd), torch.tensor(y)).numpy()
    np.testing.assert_allclose(fb, np.asarray(JH.pool_errors(pool, xd, y)),
                               **TOL)


def test_pool_mlp_features_match_reference():
    ns, R, w, nf = 9, 30, 3, 4
    pool = _pool_np(ns, w, 3)
    xd, y = _probe((nf, R, w), 5), _probe((R,), 6)
    ours = TOPS.pool_mlp_errors_features(_t(pool), torch.tensor(xd),
                                         torch.tensor(y)).numpy()
    theirs = np.asarray(JOPS.pool_mlp_errors_features(pool, xd, y))
    np.testing.assert_allclose(ours, theirs, **TOL)
    np.testing.assert_array_equal(ours.argmin(1), theirs.argmin(1))


def test_poisoned_rows_and_nan_probe_pinned_to_inf():
    ns, R, w, nf = 8, 20, 3, 2
    pool = {k: v.copy() for k, v in _pool_np(ns, w).items()}
    pool["w0"][1] = np.nan
    pool["b4"][5] = np.inf
    xd, y = _probe((nf, R, w), 9), _probe((R,), 8)
    ours = TOPS.pool_mlp_errors_features(_t(pool), torch.tensor(xd),
                                         torch.tensor(y)).numpy()
    theirs = np.asarray(JOPS.pool_mlp_errors_features(pool, xd, y))
    assert np.isposinf(ours[:, [1, 5]]).all()
    assert np.isfinite(np.delete(ours, [1, 5], axis=1)).all()
    np.testing.assert_allclose(ours, theirs, **TOL)   # inf == inf
    assert int(ours[0].argmin()) not in (1, 5)

    pool = _pool_np(6, w)
    xd = _probe((nf, 10, w), 3)
    xd[1, 4, 0] = np.nan                                # one bad sample
    y = _probe((10,), 4)
    ours = TOPS.pool_mlp_errors_features(_t(pool), torch.tensor(xd),
                                         torch.tensor(y)).numpy()
    theirs = np.asarray(JOPS.pool_mlp_errors_features(pool, xd, y))
    assert np.isfinite(ours[0]).all() and np.isposinf(ours[1]).all()
    np.testing.assert_allclose(ours, theirs, **TOL)


def test_masked_and_shard_sweeps():
    ns, R, w, nf = 8, 10, 3, 2
    pool = {k: v.copy() for k, v in _pool_np(ns, w).items()}
    pool["w2"][2] = np.nan
    xd, y = _probe((nf, R, w), 5), _probe((R,), 6)
    valid = np.array([True] * 6 + [False] * 2)
    tp, txd, ty = _t(pool), torch.tensor(xd), torch.tensor(y)
    ours = TOPS.pool_mlp_errors_features_masked(tp, txd, ty,
                                                torch.tensor(valid)).numpy()
    theirs = np.asarray(JOPS.pool_mlp_errors_features_masked(
        pool, xd, y, jnp.asarray(valid)))
    assert np.isposinf(ours[:, [2, 6, 7]]).all()
    np.testing.assert_allclose(ours, theirs, **TOL)
    full = TOPS.pool_mlp_errors_features(tp, txd, ty)
    lo, hi = 0, 4
    shard = TOPS.pool_mlp_errors_shard(tree_map(lambda t: t[lo:hi], tp),
                                       txd, ty)
    assert torch.equal(shard, full[:, lo:hi])
    masked_shard = TOPS.pool_mlp_errors_shard(
        tree_map(lambda t: t[4:], tp), txd, ty, torch.tensor(valid[4:]))
    np.testing.assert_array_equal(masked_shard.numpy(), ours[:, 4:])


def test_kernel_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    pool = _t(_pool_np(2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        TK.pool_mlp_features_cuda(torch.zeros(1, 5, 3), torch.zeros(5),
                                  tuple(pool[k] for k in TOPS._KEYS))
