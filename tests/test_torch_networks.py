"""Port parity: the Table-4 H/E/P networks, the multi-task loss and its
gradients on parameters carried across from the JAX package (rtol 1e-5,
atol 1e-6: fp32 products summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import networks as JN  # noqa: E402
from repro.sharding import spec as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.core import networks as TN  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _case(nf=4, w=3, B=20, seed=0):
    p_np = jax.tree_util.tree_map(
        np.asarray, JS.materialize(JN.hfl_schema(nf, w),
                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(B, nf, w)).astype(np.float32)
    xs[rng.random(xs.shape) < 0.6] = 0.0          # sparse, as packed
    xd = rng.normal(size=(B, nf, w)).astype(np.float32)
    y = rng.normal(size=B).astype(np.float32)
    return p_np, xs, xd, y


@pytest.mark.parametrize("nf,w", [(4, 3), (2, 5)])
def test_forward_and_loss_match(nf, w):
    p_np, xs, xd, y = _case(nf, w)
    jy, jpre = JN.hfl_forward(p_np, xs, xd)
    ty, tpre = TN.hfl_forward(convert.params_from_numpy(p_np),
                              torch.tensor(xs), torch.tensor(xd))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), **TOL)
    (jl, (jf, jp)) = JN.hfl_loss(p_np, xs, xd, y)
    tl, (tf, tp) = TN.hfl_loss(convert.params_from_numpy(p_np),
                               torch.tensor(xs), torch.tensor(xd),
                               torch.tensor(y))
    for a, b in ((tl, jl), (tf, jf), (tp, jp)):
        np.testing.assert_allclose(float(a), float(b), **TOL)


def test_loss_gradients_match_for_every_leaf():
    p_np, xs, xd, y = _case()
    jg = jax.grad(lambda p: JN.hfl_loss(p, xs, xd, y)[0])(
        jax.tree_util.tree_map(jnp.asarray, p_np))
    tp = convert.params_from_numpy(p_np)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    loss, _ = TN.hfl_loss(tree_unflatten(tp, leaves), torch.tensor(xs),
                          torch.tensor(xd), torch.tensor(y))
    grads = torch.autograd.grad(loss, leaves)
    j_leaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(j_leaves) == 30
    for g, h in zip(grads, j_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(h), **TOL)


def test_head_pool_apply_matches():
    ns, R, w = 5, 12, 3
    pool = jax.tree_util.tree_map(
        np.asarray, JS.materialize(JS.stack(JN.head_schema(w), ns),
                                   jax.random.PRNGKey(4)))
    xd = np.random.default_rng(4).normal(size=(R, w)).astype(np.float32)
    ours = TN.head_pool_apply(convert.params_from_numpy(pool),
                              torch.tensor(xd))
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(JN.head_pool_apply(pool, xd)),
                               **TOL)
    one = {k: v[2] for k, v in pool.items()}
    np.testing.assert_allclose(
        TN.head_apply(convert.params_from_numpy(one), torch.tensor(xd)),
        np.asarray(JN.head_apply(one, xd)), **TOL)
