"""Heterogeneous Federated Learning primitives (paper §4.2) on PyTorch.

Counterpart of ``repro.core.hfl``:
  * the asynchronous **head pool** (every user publishes its nf global-head
    weight sets; stale versions remain usable),
  * **heterogeneous domain selection** (Eq. 7): for each target head H_i
    pick the pool model with the smallest preliminary-prediction squared
    error on the target's own last R samples,
  * **alpha-blending** (Eq. 8): H_i <- alpha * H_hat + (1-alpha) * H_i,
  * the **switching mechanism** and the ablation modes of §5.5.

A client's parameters are a dict of tensors keyed like the reference's
pytree; a train step takes gradients with ``torch.autograd.grad`` over its
leaves and applies the port's term-for-term Adam.  Everything a client
holds lives on its ``device``, which defaults to ``"cuda"``.  On a CUDA
device every Eq.-7 score goes through the CUDA kernel; its plain version
runs only for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.core import networks as N
from repro_torch.core.policies import plateaued
from repro_torch.kernels.pool_mlp import ops as pool_ops
from repro_torch.optim import adam, apply_updates
from repro_torch.sharding import spec as S

# Pool rows seeded from an inadmissible head are published at this sentinel
# age (the reference's faults.QUARANTINE_AGE): far above any real staleness
# bound, so every selector skips the row until a clean republication.
QUARANTINE_AGE = 1 << 30


@dataclasses.dataclass
class HFLConfig:
    w: int = 3
    R: int = 50
    alpha: float = 0.2
    lr: float = 0.01
    epochs: int = 50
    patience: int = 3
    mode: str = "hfl"            # hfl | no | random | always
    use_pool_kernel: bool = False  # read by nothing: kept so configs read
                                   # as the reference's; every Eq.-7 score
                                   # goes through the kernel wrapper
    seed: int = 0


def switch_active(val_history: Sequence[float], cfg: HFLConfig) -> bool:
    """Switching mechanism: FL only when validation has plateaued for
    `patience` epochs (always/random modes bypass; no disables)."""
    mode = cfg.mode
    if mode == "no":
        return False
    if mode in ("always", "random"):
        return True
    return plateaued(val_history, cfg.patience)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

def _train_step(opt, params, opt_state, xs, xd, y):
    """One Adam update on one client's R-batch."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = N.hfl_loss(tree_unflatten(params, leaves), xs, xd, y)
    grads = tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))
    updates, opt_state = opt.update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state, loss.detach()


@torch.no_grad()
def _eval_mse(params, xs, xd, y):
    y_hat, _ = N.hfl_forward(params, xs, xd)
    return torch.mean((y - y_hat) ** 2)


class FederatedClient:
    """One hospital: local data, local model, recent-R scoring buffer.

    ``train``/``valid``/``test`` are ``(xs, xd, y)`` numpy arrays, moved to
    ``device`` once.  Parameters are drawn from ``schema`` with ``seed``, or
    taken from ``params`` (a tree of tensors, e.g. carried across from the
    JAX package with :func:`repro_torch.convert.params_from_numpy`)."""

    def __init__(self, name: str, nf: int, cfg: HFLConfig,
                 train, valid, test, seed: int = 0, *, params=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.name, self.nf, self.cfg = name, nf, cfg
        self.train, self.valid, self.test = (
            tuple(torch.as_tensor(np.asarray(a), device=self.device)
                  for a in split) for split in (train, valid, test))
        if params is None:
            params = S.materialize(N.hfl_schema(nf, cfg.w), seed, self.device)
        self.params = tree_map(lambda p: p.to(self.device), params)
        self.opt = adam(cfg.lr)
        self.opt_state = self.opt.init(self.params)
        self.val_history: List[float] = []
        self.best_val = np.inf
        self.best_params = self.params
        self._recent: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def train_epoch(self, R: Optional[int] = None) -> Iterator[None]:
        """Generator over the epoch's R-batches: one Adam update per batch,
        yielding after each — a yield is one federated opportunity."""
        xs, xd, y = self.train
        R = self.cfg.R if R is None else R
        for start in range(0, len(y) - R + 1, R):
            sl = slice(start, start + R)
            self.params, self.opt_state, _ = _train_step(
                self.opt, self.params, self.opt_state, xs[sl], xd[sl], y[sl])
            self._recent = (xd[sl], y[sl])
            yield

    def val_mse(self) -> float:
        return float(_eval_mse(self.params, *self.valid))

    def test_mse(self, params=None) -> float:
        return float(_eval_mse(params if params is not None
                               else self.best_params, *self.test))

    def end_epoch(self) -> None:
        v = self.val_mse()
        self.val_history.append(v)
        if v < self.best_val:
            self.best_val = v
            self.best_params = self.params


# ---------------------------------------------------------------------------
# Pool
# ---------------------------------------------------------------------------

class HeadPool:
    """Decentralized asynchronous pool of shared head-layer weights.

    Entries persist until overwritten ("the last version stored in the
    pool"), so a user that skips publication rounds still contributes its
    stale heads.  Each entry carries an age (federated opportunities since
    publication, advanced by :meth:`tick`).  Entries are views of the
    publishing client's parameter tensors, which train steps replace but
    never write in place."""

    def __init__(self):
        self.entries: Dict[Tuple[str, int], dict] = {}
        self.ages: Dict[Tuple[str, int], int] = {}

    def publish(self, user: str, head_params_stacked, nf: int,
                age: int = 0) -> None:
        for i in range(nf):
            self.entries[(user, i)] = tree_map(lambda p: p[i],
                                               head_params_stacked)
            self.ages[(user, i)] = age

    def tick(self) -> None:
        """Advance every entry's age by one federated opportunity."""
        for k in self.ages:
            self.ages[k] += 1

    def stacked_for(self, exclude_user: str):
        """All pool heads from OTHER users, stacked to (ns, ...)."""
        keys = [k for k in sorted(self.entries) if k[0] != exclude_user]
        if not keys:
            return None, []
        stacked = tree_map(lambda *xs: torch.stack(xs),
                           *[self.entries[k] for k in keys])
        return stacked, keys

    def fresh_mask(self, exclude_user: str, max_age: Optional[int] = None,
                   keys: Optional[List[Tuple[str, int]]] = None) -> np.ndarray:
        """Validity mask aligned with :meth:`stacked_for`'s sorted keys:
        True where the entry is young enough to be served.  Unbounded pools
        still hide rows at the :data:`QUARANTINE_AGE` sentinel."""
        if keys is None:
            keys = [k for k in sorted(self.entries) if k[0] != exclude_user]
        if max_age is None:
            return np.array([self.ages.get(k, 0) < QUARANTINE_AGE
                             for k in keys], bool)
        return np.array([self.ages.get(k, 0) <= max_age for k in keys],
                        bool)


# ---------------------------------------------------------------------------
# Selection scoring (Eq. 7) + blending (Eq. 8)
# ---------------------------------------------------------------------------

@torch.no_grad()
def pool_errors(pool_stacked, xd_i, y):
    """Mean squared preliminary-prediction error of every pool head on the
    client's last-R dense vectors of feature i.  xd_i: (R, w); y: (R,).
    Returns (ns,), non-finite errors pinned to +inf.  CUDA tensors go
    through the CUDA kernel, CPU tensors through its plain version (see
    ``repro_torch/kernels/pool_mlp``)."""
    return pool_ops.pool_mlp_errors(pool_stacked, xd_i, y)


# The reference keeps a separate Pallas-kernel scorer; here both names are
# the same function, since every score already goes through the kernel.
pool_errors_kernel = pool_errors


def blend(target_heads_stacked, selected_stacked, alpha: float):
    """Eq. 8 applied to all nf heads at once."""
    return tree_map(lambda t, s: alpha * s + (1 - alpha) * t,
                    target_heads_stacked, selected_stacked)


def federated_round(client: FederatedClient, pool: HeadPool,
                    rng: np.random.Generator) -> Optional[List[int]]:
    """One heterogeneous-transfer round for `client` (paper Fig. 6) under the
    client's legacy ``cfg.mode`` — a shim over
    :func:`repro_torch.core.federation.policy_round`."""
    from repro_torch.core.federation import policy_round
    from repro_torch.core.policies import FederationPolicies
    return policy_round(client, pool, rng,
                        FederationPolicies.from_config(client.cfg))


# ---------------------------------------------------------------------------
# Orchestration (legacy entry point over the Federation API)
# ---------------------------------------------------------------------------

def run_federated_training(clients: Sequence[FederatedClient],
                           cfg: HFLConfig, verbose: bool = False,
                           engine: str = "sequential"):
    """Decentralized HFL over a set of clients — compat shim over
    :class:`repro_torch.core.federation.Federation`.  Returns
    {name: {"val": [...], "test": float, "rounds": int, "best_val": float,
    "selections": [[...], ...]}}."""
    from repro_torch.core.federation import Federation
    return Federation(clients, cfg, engine=engine).fit(verbose=verbose)
