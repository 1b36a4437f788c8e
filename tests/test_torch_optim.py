"""Port parity: Adam (term for term with ``repro.optim.adam``) and the
parameter schema, on parameters carried across from the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import networks as JN  # noqa: E402
from repro.optim import adam as j_adam  # noqa: E402
from repro.optim import apply_updates as j_apply  # noqa: E402
from repro.sharding import spec as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import tree_leaves, tree_map, tree_paths  # noqa: E402
from repro_torch.core import networks as TN  # noqa: E402
from repro_torch.optim import adam as t_adam  # noqa: E402
from repro_torch.optim import apply_updates as t_apply  # noqa: E402
from repro_torch.sharding import spec as TS  # noqa: E402

NF, W = 3, 3


def _np_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, JS.materialize(JN.hfl_schema(NF, W),
                                   jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("steps", [1, 5])
def test_adam_steps_match_reference(steps):
    """The same gradients (numpy, from a seed) through both optimizers: every
    step's updates and moments agree to rtol 1e-6 (fp32 elementwise
    arithmetic, the same terms in the same order).  Parameters also get an
    atol of 1e-8: p + u cancels where a step nearly zeroes a weight, and one
    ulp of an lr-sized step (0.01) is 9.3e-10."""
    p_np = _np_params()
    rng = np.random.default_rng(steps)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), p_np)
        for _ in range(steps)]
    jo, to = j_adam(0.01), t_adam(0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    tp = convert.params_from_numpy(p_np)
    js, ts = jo.init(jp), to.init(tp)

    def close(ours, theirs, **tol):
        a_leaves = tree_leaves(convert.params_to_numpy(ours))
        b_leaves = jax.tree_util.tree_leaves(theirs)
        assert len(a_leaves) == len(b_leaves) == 30
        for a, b in zip(a_leaves, b_leaves):
            np.testing.assert_allclose(a, np.asarray(b), **tol)

    for g in grads:      # eager, op by op: jit would contract into FMAs
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = j_apply(jp, ju)
        tu, ts = to.update(convert.params_from_numpy(g), ts, tp)
        tp = t_apply(tp, tu)
        close(tu, ju, rtol=1e-6, atol=0)
        close(ts["m"], js["m"], rtol=1e-6, atol=0)
        close(ts["v"], js["v"], rtol=1e-6, atol=0)
    assert ts["step"] == int(js["step"]) == steps
    close(tp, jp, rtol=1e-6, atol=1e-8)


def test_schema_shapes_keys_and_init_law():
    """Same keys, shapes and parameter count as the reference schema; the
    fan-in truncated normal lies within 2 std and has about its std."""
    ts_schema = TN.hfl_schema(4, 3)
    js_schema = JN.hfl_schema(4, 3)
    assert TS.count_params(ts_schema) == JS.count_params(js_schema)
    ours = TS.materialize(ts_schema, seed=3)
    theirs = jax.tree_util.tree_map(
        np.asarray, JS.materialize(js_schema, jax.random.PRNGKey(3)))
    assert tree_paths(ours) == [jax.tree_util.keystr(p) for p, _ in
                                jax.tree_util.tree_flatten_with_path(
                                    theirs)[0]]
    for a, b in zip(tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    w2 = ours["embed"]["w2"]                    # (256, 64), fan_in 256
    std = 1 / np.sqrt(256)
    assert float(w2.abs().max()) <= 2 * std
    assert abs(float(w2.std()) / std - 0.88) < 0.05   # trunc-normal std
    assert float(ours["embed"]["b2"].abs().max()) == 0.0
    again = TS.materialize(ts_schema, seed=3)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ours),
                                                 tree_leaves(again)))


def test_convert_round_trip():
    p = _np_params(1)
    back = convert.params_to_numpy(convert.params_from_numpy(p))
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(p)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tree_map(lambda t: t.shape, back)["heads"]["w2"] == (NF, 256, 64)
