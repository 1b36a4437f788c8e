"""Composable federation API on PyTorch: the sequential executor.

:class:`Federation` owns a set of :class:`~repro_torch.core.hfl.FederatedClient`
objects, a :class:`~repro_torch.core.policies.FederationPolicies` bundle, a
shared :class:`RoundSchedule` and a :class:`Callback` list, as
``repro.core.federation`` does.  This module ports its ``sequential``
executor, the reference oracle that defines the semantics every engine
must reproduce.  The batched fused-epoch engine, checkpoints
(``save``/``restore``) and the trust, fault, straggler and telemetry
layers are not ported yet (ROADMAP §A5, §A6 and §A9-§A12).

State (per-client params / optimizer state / validation history / best
snapshot, the head pool with per-entry ages, the two numpy host RNG streams
and the epoch/round counters) lives on the Federation and its clients, so
``fit(epochs=k)`` resumes where the last fit stopped.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch._tree import tree_map
from repro_torch.core.hfl import (FederatedClient, HeadPool, HFLConfig,
                                  pool_errors)
from repro_torch.core.policies import FederationPolicies


# ---------------------------------------------------------------------------
# Round schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundSchedule:
    """The paper's training protocol skeleton, shared by the executor and by
    the non-federated loop: `epochs` epochs, one gradient step per R
    consecutive periods.

    ``exchange_every`` relaxes the pool-exchange cadence: sub-round ``r``
    (0-based, counted within the epoch) exchanges iff
    ``(r + 1) % exchange_every == 0``, on the sub-round's own probe batch.
    The default k=1 is the paper's per-sub-round exchange.  The cadence
    resets at epoch boundaries."""
    epochs: int
    R: int
    exchange_every: int = 1

    def __post_init__(self):
        if self.exchange_every < 1:
            raise ValueError(
                f"exchange_every must be >= 1 (1 = exchange every "
                f"sub-round, the paper's cadence), got {self.exchange_every}")

    def slices(self, n: int):
        """Sub-round batch slices over an n-sample train split.  Only FULL
        R-batches are yielded: the trailing ``leftover(n)`` events are never
        trained on (:meth:`Federation.fit` warns about it)."""
        for start in range(0, n - self.R + 1, self.R):
            yield slice(start, start + self.R)

    def sub_rounds(self, n: int) -> int:
        return max(0, (n - self.R) // self.R + 1)

    def leftover(self, n: int) -> int:
        """Trailing events per epoch that :meth:`slices` drops (0 when n is
        a multiple of R; n itself when n < R)."""
        return n - self.sub_rounds(n) * self.R


# ---------------------------------------------------------------------------
# Callbacks
# ---------------------------------------------------------------------------

class Callback:
    """Training hooks.  `fed` is the running Federation (None when invoked
    from the non-federated :func:`fit_local` loop)."""

    def on_fit_start(self, fed) -> None:
        """Once per :meth:`Federation.fit` call, before any training."""

    def on_round(self, fed, epoch: int, round_idx: int) -> None:
        """After each federated sub-round (``round_idx`` counts executed
        sub-rounds from 0 within the epoch)."""

    def on_epoch_end(self, fed, epoch: int, val: Dict[str, float],
                     active: Dict[str, bool]) -> None:
        """After each epoch: ``val`` maps client name -> this epoch's
        validation MSE, ``active`` maps client name -> whether its switch
        was active (it federated) this epoch."""

    def on_fit_end(self, fed, results) -> None:
        """Once per fit, after training: ``results`` is the
        :meth:`Federation.results` history dict."""


class VerboseLogger(Callback):
    """Per-epoch console line (a `*` marks clients whose switch was active
    this epoch), plus the epoch's wall time and client-rounds/s (exchange
    opportunities actually run)."""

    def __init__(self):
        self._t0 = None
        self._rounds0 = None

    def on_fit_start(self, fed):
        self._t0 = time.perf_counter()
        self._rounds0 = (sum(fed.n_rounds.values())
                         if fed is not None else 0)

    def on_epoch_end(self, fed, epoch, val, active):
        msg = " ".join(f"{n}={val[n]:.4f}{'*' if active.get(n) else ''}"
                       for n in val)
        print(f"[hfl] epoch {epoch:3d} val: {msg}", flush=True)
        now = time.perf_counter()
        dt = now - self._t0 if self._t0 is not None else 0.0
        self._t0 = now
        if fed is None:
            print(f"[hfl] epoch {epoch:3d} wall: {dt:.3f}s", flush=True)
            return
        total = sum(fed.n_rounds.values())
        done = total - (self._rounds0 or 0)
        self._rounds0 = total
        crs = done / dt if dt > 0 else 0.0
        print(f"[hfl] epoch {epoch:3d} wall: {dt:.3f}s "
              f"client-rounds/s: {crs:.1f}", flush=True)


class MetricsCapture(Callback):
    """Records the per-epoch validation MSEs and switch activity."""

    def __init__(self):
        self.epochs: List[dict] = []

    def on_epoch_end(self, fed, epoch, val, active):
        self.epochs.append({"epoch": epoch, "val": dict(val),
                            "active": dict(active)})


# ---------------------------------------------------------------------------
# Sequential executor
# ---------------------------------------------------------------------------

@torch.no_grad()
def policy_round(client: FederatedClient, pool: HeadPool,
                 rng: np.random.Generator,
                 policies: FederationPolicies) -> Optional[List[int]]:
    """One heterogeneous-transfer round for `client` (paper Fig. 6) under an
    explicit policy bundle.  Returns the selected pool indices per feature
    (positions in the sorted foreign pool), or None when there was nothing
    valid to select from.  Each feature's Eq.-7 scores are one kernel launch
    on a CUDA device."""
    if client._recent is None:
        return None
    stacked, keys = pool.stacked_for(client.name)
    if stacked is None:
        return None
    valid = pool.fresh_mask(client.name, policies.pool.max_age, keys=keys)
    if not valid.any():
        return None
    xd_R, y_R = client._recent
    sel = policies.selection
    chosen, sel_entries = [], []
    for i in range(client.nf):
        if sel.needs_errors:
            errs = pool_errors(stacked, xd_R[:, i], y_R).cpu().numpy()
            errs = np.where(valid, errs, np.inf)
        else:
            errs = None
        j = sel.select_host(errs, valid, rng)
        chosen.append(j)
        sel_entries.append(tree_map(lambda p: p[j], stacked))
    selected = tree_map(lambda *xs: torch.stack(xs), *sel_entries)
    client.params = dict(client.params)
    client.params["heads"] = policies.transfer.apply(client.params["heads"],
                                                     selected)
    return chosen


def _fit_sequential(fed: "Federation", n_epochs: int, cbs) -> None:
    """The reference oracle: a host-driven loop of per-client train steps
    interleaved with per-client :func:`policy_round` calls in list order.
    Handles heterogeneous nf and ragged data lengths."""
    pol = fed.policies
    C = len(fed.clients)
    k_ex = fed.schedule.exchange_every
    n_exchange = 0            # executed sub-rounds that ran an exchange

    for _ in range(n_epochs):
        epoch = fed.epoch
        mask = pol.switch.active_mask(
            [c.val_history for c in fed.clients], fed._switch_rng)
        active = {c.name: bool(mask[i]) for i, c in enumerate(fed.clients)}
        iters = {c.name: c.train_epoch(R=fed.schedule.R)
                 for c in fed.clients}
        live = set(iters)
        rnd = 0
        while live:
            # only every k-th executed sub-round (within the epoch) is a
            # federated opportunity; on the others clients just train and
            # the staleness clock stands still
            exchange = (rnd + 1) % k_ex == 0
            # staleness clock: tick once per exchange round in which
            # federation can run
            ticked = not exchange or not (pol.pool.bounded and C >= 2
                                          and any(active[n] for n in live))
            progressed = False
            for c in fed.clients:
                if c.name not in live:
                    continue
                try:
                    next(iters[c.name])
                except StopIteration:
                    live.discard(c.name)
                    continue
                progressed = True
                if not exchange:
                    continue
                if not ticked:
                    fed.pool.tick()
                    ticked = True
                if active[c.name]:
                    sel = policy_round(c, fed.pool, fed._sel_rng, pol)
                    if sel is not None:
                        fed.selections[c.name].append(sel)
                    fed.n_rounds[c.name] += 1
                    fed.pool.publish(c.name, c.params["heads"], c.nf)
            if progressed:
                if exchange and any(active.values()):
                    n_exchange += 1
                for cb in cbs:
                    cb.on_round(fed, epoch, rnd)
                rnd += 1
        for c in fed.clients:
            c.end_epoch()
        fed.epoch += 1
        val = {c.name: c.val_history[-1] for c in fed.clients}
        for cb in cbs:
            cb.on_epoch_end(fed, epoch, val, active)
    fed.dispatch_stats = {"engine": "sequential", "epochs": n_epochs,
                          "exchange_every": k_ex,
                          "exchange_rounds": n_exchange}


# ---------------------------------------------------------------------------
# Federation
# ---------------------------------------------------------------------------

class Federation:
    """A resumable federated-training run: clients + policies + schedule +
    callbacks + all mutable state (pool, RNG streams, counters).

    ``fit()`` trains up to ``schedule.epochs``; ``fit(epochs=k)`` trains k
    MORE epochs from wherever the federation currently is."""

    def __init__(self, clients: Sequence[FederatedClient],
                 cfg: Optional[HFLConfig] = None, *,
                 policies: Optional[FederationPolicies] = None,
                 schedule: Optional[RoundSchedule] = None,
                 callbacks: Sequence[Callback] = (),
                 engine: str = "sequential"):
        if engine == "batched":
            raise NotImplementedError(
                "engine='batched' is not ported yet (ROADMAP §A6, the "
                "batched fused-epoch engine); use engine='sequential'")
        if engine != "sequential":
            raise ValueError(f"unknown engine {engine!r}")
        self.clients = list(clients)
        names = [c.name for c in self.clients]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate client names: {names}")
        if cfg is None:
            cfg = self.clients[0].cfg if self.clients else HFLConfig()
        self.cfg = cfg
        self.policies = policies if policies is not None \
            else FederationPolicies.from_config(cfg)
        self.schedule = schedule or RoundSchedule(cfg.epochs, cfg.R)
        self.callbacks = list(callbacks)
        self.engine = engine
        self.epoch = 0
        self.n_rounds: Dict[str, int] = {n: 0 for n in names}
        self.selections: Dict[str, list] = {n: [] for n in names}
        self.pool = HeadPool()
        for c in self.clients:   # asynchronous start: pool is never empty
            self.pool.publish(c.name, c.params["heads"], c.nf)
        self._sel_rng = np.random.default_rng(cfg.seed)
        self._switch_rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 0x5F]))
        # {engine, epochs, exchange_every, exchange_rounds} of the last fit
        self.dispatch_stats: Optional[dict] = None

    def fit(self, epochs: Optional[int] = None, verbose: bool = False):
        """Train `epochs` more epochs (default: up to ``schedule.epochs``
        total) and return the legacy history dict
        {name: {val, test, rounds, best_val, selections}}."""
        target = self.schedule.epochs if epochs is None \
            else self.epoch + epochs
        n = max(0, target - self.epoch)
        cbs = list(self.callbacks)
        if verbose and not any(isinstance(cb, VerboseLogger) for cb in cbs):
            cbs.append(VerboseLogger())
        for cb in cbs:
            cb.on_fit_start(self)
        if n:
            dropped = {c.name: self.schedule.leftover(len(c.train[2]))
                       for c in self.clients}
            dropped = {k: v for k, v in dropped.items() if v}
            if dropped:
                warnings.warn(
                    f"RoundSchedule(R={self.schedule.R}) drops the trailing "
                    f"partial batch every epoch: {dropped} train events per "
                    f"epoch are never trained on (train lengths are not "
                    f"multiples of R); truncate to a multiple of R or pick "
                    f"a divisor R to silence this", UserWarning,
                    stacklevel=2)
            _fit_sequential(self, n, cbs)
        results = self.results()
        for cb in cbs:
            cb.on_fit_end(self, results)
        return results

    def results(self):
        """Per-client history in the legacy run_federated_training format."""
        test = self._test_mses()
        return {c.name: {"val": list(c.val_history),
                         "test": test[c.name],
                         "rounds": self.n_rounds[c.name],
                         "best_val": float(c.best_val),
                         "selections": [list(s) for s in
                                        self.selections[c.name]]}
                for c in self.clients}

    def _test_mses(self) -> Dict[str, float]:
        """Best-params test MSE per client."""
        return {c.name: c.test_mse() for c in self.clients}


# ---------------------------------------------------------------------------
# Non-federated loop on the shared schedule (benchmark systems)
# ---------------------------------------------------------------------------

def fit_local(step_fn, eval_fn, params, opt_state, train, valid,
              schedule: RoundSchedule, callbacks: Sequence[Callback] = ()):
    """Single-model training on the shared :class:`RoundSchedule` with
    save-best-on-validation (paper §5.2) and the same callback hooks as
    :meth:`Federation.fit`.

    ``step_fn(params, opt_state, xs, xd, y) -> (params, opt_state)``;
    ``eval_fn(params, xs, xd, y) -> scalar``.  Returns
    ``(params, opt_state, best_params, best_val)``."""
    xs, xd, y = train
    best_val, best_params = np.inf, params
    for cb in callbacks:
        cb.on_fit_start(None)
    for epoch in range(schedule.epochs):
        for rnd, sl in enumerate(schedule.slices(len(y))):
            params, opt_state = step_fn(params, opt_state,
                                        xs[sl], xd[sl], y[sl])
            for cb in callbacks:
                cb.on_round(None, epoch, rnd)
        v = float(eval_fn(params, *valid))
        if v < best_val:
            best_val, best_params = v, params
        for cb in callbacks:
            cb.on_epoch_end(None, epoch, {"val": v}, {})
    for cb in callbacks:
        cb.on_fit_end(None, {"best_val": best_val})
    return params, opt_state, best_params, best_val
