"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.core import networks as N  # noqa: E402
from repro_torch.kernels.pool_mlp import kernel as K  # noqa: E402
from repro_torch.kernels.pool_mlp import ops  # noqa: E402
from repro_torch.sharding import spec as S  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)   # fp32 FMA chains against cuBLAS/CPU sums


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(nf, ns, R, w, device):
    pool = S.materialize(S.stack(N.head_schema(w), ns), ns, device)
    rng = np.random.default_rng(ns)
    xd = torch.tensor(rng.normal(size=(nf, R, w)), dtype=torch.float32,
                      device=device)
    y = torch.tensor(rng.normal(size=R), dtype=torch.float32, device=device)
    return pool, xd, y


@pytest.mark.cuda
@pytest.mark.parametrize("nf,ns,R,w", [(1, 4, 50, 3), (4, 512, 50, 3),
                                       (2, 37, 7, 3), (1, 3, 7, 2)])
def test_pool_mlp_kernel_matches_plain_version(cuda_device, nf, ns, R, w):
    pool, xd, y = _case(nf, ns, R, w, cuda_device)
    before = K.launches
    got = ops.pool_mlp_errors_features(pool, xd, y)
    assert K.launches == before + 1
    want = ops.pool_mlp_errors_features(tree_map(lambda t: t.cpu(), pool),
                                        xd.cpu(), y.cpu())
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    assert torch.equal(got.argmin(1).cpu(), want.argmin(1))


@pytest.mark.cuda
def test_pool_mlp_kernel_pins_and_shards(cuda_device):
    pool, xd, y = _case(2, 8, 20, 3, cuda_device)
    pool = dict(pool)
    pool["w2"] = pool["w2"].clone()
    pool["w2"][2] = torch.nan
    xd[1, 4, 0] = torch.nan
    valid = torch.tensor([True] * 6 + [False] * 2, device=cuda_device)
    got = ops.pool_mlp_errors_features_masked(pool, xd, y, valid).cpu()
    assert torch.isposinf(got[:, [2, 6, 7]]).all()
    assert torch.isposinf(got[1]).all()
    assert torch.isfinite(got[0, [0, 1, 3, 4, 5]]).all()
    full = ops.pool_mlp_errors_features(pool, xd, y)
    shard = ops.pool_mlp_errors_shard(tree_map(lambda t: t[3:7], pool), xd, y)
    assert torch.equal(shard, full[:, 3:7])


@pytest.mark.cuda
def test_pool_mlp_kernel_rejects_what_it_does_not_take(cuda_device):
    pool, xd, y = _case(1, 4, 10, 3, cuda_device)
    weights = tuple(pool[k] for k in ops._KEYS)
    with pytest.raises(TypeError, match="dtype"):
        K.pool_mlp_features_cuda(xd.double(), y, weights)
    with pytest.raises(ValueError, match="contiguous"):
        K.pool_mlp_features_cuda(xd.transpose(1, 2).contiguous()
                                 .transpose(1, 2), y, weights)
    with pytest.raises(ValueError, match="shape"):
        K.pool_mlp_features_cuda(xd, y[:5], weights)
