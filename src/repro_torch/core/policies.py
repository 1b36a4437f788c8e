"""Pluggable federation policies (the composable HFL API).

The paper's mechanisms are four orthogonal decisions, each a policy
protocol with interchangeable implementations:

  * :class:`SwitchPolicy`  — WHEN a client federates.  The paper's
    validation-plateau rule (:class:`PlateauSwitch`), plus ``always`` /
    ``never`` / Bernoulli-``prob(p)`` variants.
  * :class:`SelectionPolicy` — WHICH pool head a client pulls per feature.
    Eq. 7 argmin (:class:`ArgminSelection`), uniform :class:`RandomSelection`
    (the §5.5 ablation), softmax-weighted sampling and uniform-over-top-k.
  * :class:`TransferRule` — HOW a selected head is merged into the local
    head.  Eq. 8 alpha-blend (:class:`AlphaBlend`) and a per-feature-alpha
    variant.
  * :class:`PoolPolicy` — WHAT the pool serves.  Last-write-wins asynchrony
    (stale entries persist forever, the paper's semantics) or a bounded
    max-staleness variant that hides entries older than ``max_age``
    federated opportunities.

Counterpart of ``repro.core.policies`` with its host paths (``active``,
``active_mask``, ``select_host``, ``apply``).  The ``select_batched``
methods come with the batched engine.  Every policy is a frozen dataclass
and serializes to a plain dict spec (``spec()`` / :func:`policy_from_spec`)
in the reference's format.  Stochastic host policies draw from numpy
generators, exactly as the reference does, so their streams match it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_map


def plateaued(val_history: Sequence[float], patience: int) -> bool:
    """The paper's switching criterion: the validation loss has not improved
    for `patience` consecutive epochs (zero patience: eligible from epoch 1
    on)."""
    h = val_history
    if patience <= 0:
        return len(h) > 0
    if len(h) < patience + 1:
        return False
    best_before = min(h[:-patience])
    return all(v >= best_before for v in h[-patience:])


class _Spec:
    """spec()/from-spec plumbing shared by every policy dataclass."""

    def spec(self) -> dict:
        d = dataclasses.asdict(self)
        d["kind"] = type(self).__name__
        return d


# ---------------------------------------------------------------------------
# SwitchPolicy — when does a client federate?
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SwitchPolicy(_Spec):
    """Decides, at the start of each epoch, whether a client participates in
    federated transfer this epoch (host-side, once per epoch, in client
    order, so stochastic policies stay deterministic)."""

    def active(self, val_history: Sequence[float],
               rng: np.random.Generator) -> bool:
        """One client's switch decision for the coming epoch, given its
        validation-MSE history (may be empty) and the shared host rng
        stream (consumed ONLY by stochastic policies, in client order)."""
        raise NotImplementedError

    def active_mask(self, histories: Sequence[Sequence[float]],
                    rng: np.random.Generator) -> np.ndarray:
        """The whole population's activity for one epoch as a (C,) bool
        array: :meth:`active` per client in list order, so stochastic
        policies consume the host rng stream as the reference does."""
        return np.array([self.active(h, rng) for h in histories], bool)


@dataclasses.dataclass(frozen=True)
class PlateauSwitch(SwitchPolicy):
    """Federate only when validation has plateaued (paper §4.2)."""
    patience: int = 3

    def active(self, val_history, rng):
        return plateaued(val_history, self.patience)

    def active_mask(self, histories, rng):
        """Vectorized over the population in exact float64 on the host —
        bitwise the same comparisons as the scalar :func:`plateaued`."""
        C = len(histories)
        E = min((len(h) for h in histories), default=0)
        if E != max((len(h) for h in histories), default=0):
            return super().active_mask(histories, rng)   # ragged: loop
        if self.patience <= 0:
            return np.full(C, E > 0)
        if E < self.patience + 1:
            return np.zeros(C, bool)
        hist = np.asarray([list(h) for h in histories],
                          np.float64).reshape(C, E)
        best_before = hist[:, :E - self.patience].min(axis=1)
        return (hist[:, E - self.patience:] >=
                best_before[:, None]).all(axis=1)


@dataclasses.dataclass(frozen=True)
class AlwaysSwitch(SwitchPolicy):
    """Every epoch federates (§5.5 `always`, also the `random` ablation)."""

    def active(self, val_history, rng):
        return True

    def active_mask(self, histories, rng):
        return np.ones(len(histories), bool)


@dataclasses.dataclass(frozen=True)
class NeverSwitch(SwitchPolicy):
    """Transfer disabled (§5.5 `no`)."""

    def active(self, val_history, rng):
        return False

    def active_mask(self, histories, rng):
        return np.zeros(len(histories), bool)


@dataclasses.dataclass(frozen=True)
class ProbSwitch(SwitchPolicy):
    """Bernoulli(p) participation — partial-participation scenarios."""
    p: float = 0.5

    def active(self, val_history, rng):
        return bool(rng.random() < self.p)


# ---------------------------------------------------------------------------
# SelectionPolicy — which pool head per feature?
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SelectionPolicy(_Spec):
    """Picks one pool entry per target feature: :meth:`select_host` gets the
    Eq.-7 error vector (numpy, ``inf`` at excluded entries; ``None`` when
    ``needs_errors`` is False), the validity mask, and the shared host rng —
    returns an int index.

    ``local_argmin`` declares that the selection is a pure argmin over the
    error row (a sharded engine may then merge per-chunk minima)."""

    needs_errors = True
    local_argmin = False

    def select_host(self, errs: Optional[np.ndarray], valid: np.ndarray,
                    rng: np.random.Generator) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ArgminSelection(SelectionPolicy):
    """Eq. 7: the pool head with the smallest preliminary-prediction squared
    error on the client's last-R probe batch.  Ties resolve to the LOWEST
    flat pool index (``argmin``'s first occurrence)."""

    local_argmin = True

    def select_host(self, errs, valid, rng):
        return int(np.argmin(errs))


@dataclasses.dataclass(frozen=True)
class RandomSelection(SelectionPolicy):
    """Uniform over the (valid) foreign pool — the §5.5 `random` ablation.
    Skips Eq.-7 scoring entirely."""

    needs_errors = False

    def select_host(self, errs, valid, rng):
        if valid.all():              # legacy stream: one draw over all keys
            return int(rng.integers(len(valid)))
        idx = np.flatnonzero(valid)
        return int(idx[rng.integers(len(idx))])


@dataclasses.dataclass(frozen=True)
class SoftmaxSelection(SelectionPolicy):
    """Sample proportionally to softmax(-err / temperature) — softer than
    argmin, explores near-optimal sources."""
    temperature: float = 1.0

    def __post_init__(self):
        if self.temperature <= 0:
            raise ValueError(f"temperature must be > 0, "
                             f"got {self.temperature} (use ArgminSelection "
                             f"for the deterministic limit)")

    def select_host(self, errs, valid, rng):
        logits = -errs / self.temperature
        logits = logits - logits[np.isfinite(logits)].max()
        p = np.where(np.isfinite(logits), np.exp(logits), 0.0)
        return int(rng.choice(len(errs), p=p / p.sum()))


@dataclasses.dataclass(frozen=True)
class TopKSelection(SelectionPolicy):
    """Uniform over the k lowest-error valid heads (k=1 == argmin)."""
    k: int = 3

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")

    def select_host(self, errs, valid, rng):
        order = np.argsort(errs, kind="stable")       # inf (excluded) last
        kk = max(1, min(self.k, int(np.isfinite(errs).sum())))
        return int(order[rng.integers(kk)])


# ---------------------------------------------------------------------------
# TransferRule — how is a selected head merged in?
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransferRule(_Spec):
    """Merges the selected pool heads into the client's own heads: `apply`
    takes the stacked ``(nf, ...)`` head trees and returns a new tree."""

    def apply(self, target_heads_stacked, selected_stacked):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AlphaBlend(TransferRule):
    """Eq. 8: H_i <- alpha * H_hat + (1 - alpha) * H_i for all nf heads."""
    alpha: float = 0.2

    def apply(self, target, selected):
        a = self.alpha
        return tree_map(lambda t, s: a * s + (1 - a) * t, target, selected)


@dataclasses.dataclass(frozen=True)
class PerFeatureAlpha(TransferRule):
    """Eq. 8 with a distinct alpha per target feature (e.g. trust foreign
    knowledge more on sparsely-observed channels)."""
    alphas: Tuple[float, ...] = (0.2,)

    def apply(self, target, selected):
        def blend_leaf(t, s):
            a = torch.tensor(self.alphas, dtype=torch.float32,
                             device=t.device)
            af = a.reshape((-1,) + (1,) * (t.dim() - 1))
            return af * s + (1 - af) * t

        return tree_map(blend_leaf, target, selected)


# ---------------------------------------------------------------------------
# PoolPolicy — what does the pool serve?
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PoolPolicy(_Spec):
    """Asynchrony semantics of the head pool.  ``max_age`` is None for the
    paper's last-write-wins rule (stale entries persist forever); an int
    bounds how many federated opportunities an entry may go unrefreshed
    before it stops being served to selectors (it is hidden, not deleted —
    a republish revives the row)."""
    max_age: Optional[int] = None

    @property
    def bounded(self) -> bool:
        return self.max_age is not None


@dataclasses.dataclass(frozen=True)
class LastWriteWins(PoolPolicy):
    """Entries persist until overwritten — the paper's asynchrony."""
    max_age: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class MaxStaleness(PoolPolicy):
    """Hide entries older than `max_age` federated opportunities."""
    max_age: Optional[int] = 3


# ---------------------------------------------------------------------------
# Bundle + legacy-mode factory + spec round-trip
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FederationPolicies:
    """One complete policy description consumed by the engines."""
    switch: SwitchPolicy
    selection: SelectionPolicy
    transfer: TransferRule
    pool: PoolPolicy

    @classmethod
    def from_config(cls, cfg) -> "FederationPolicies":
        """Legacy ``HFLConfig.mode`` shorthand -> explicit policy bundle."""
        mode = cfg.mode
        if mode == "no":
            switch: SwitchPolicy = NeverSwitch()
        elif mode in ("always", "random"):
            switch = AlwaysSwitch()
        elif mode == "hfl":
            switch = PlateauSwitch(patience=cfg.patience)
        else:
            raise ValueError(f"unknown HFL mode {mode!r}")
        selection = (RandomSelection() if mode == "random"
                     else ArgminSelection())
        return cls(switch=switch, selection=selection,
                   transfer=AlphaBlend(alpha=cfg.alpha),
                   pool=LastWriteWins())

    def spec(self) -> dict:
        """JSON-serializable description of the whole bundle."""
        return {"switch": self.switch.spec(),
                "selection": self.selection.spec(),
                "transfer": self.transfer.spec(),
                "pool": self.pool.spec()}

    @classmethod
    def from_spec(cls, spec: dict) -> "FederationPolicies":
        """Inverse of :meth:`spec` — rebuilds every policy through the
        registry (third-party policies must have been registered via
        :func:`register_policy` first)."""
        return cls(**{slot: policy_from_spec(spec[slot])
                      for slot in ("switch", "selection", "transfer", "pool")})


_REGISTRY = {cls.__name__: cls for cls in (
    PlateauSwitch, AlwaysSwitch, NeverSwitch, ProbSwitch,
    ArgminSelection, RandomSelection, SoftmaxSelection, TopKSelection,
    AlphaBlend, PerFeatureAlpha,
    LastWriteWins, MaxStaleness, PoolPolicy,
)}


def register_policy(cls):
    """Third-party policy plugin hook: registered classes round-trip through
    :func:`policy_from_spec`.  Usable as a decorator."""
    _REGISTRY[cls.__name__] = cls
    return cls


def policy_from_spec(spec: dict):
    """One policy object back from its ``spec()`` dict: the ``kind`` key
    names the registered class, every other key is a constructor field
    (JSON-decoded lists are coerced back to tuples so frozen dataclasses
    stay hashable)."""
    d = dict(spec)
    kind = d.pop("kind")
    if kind not in _REGISTRY:
        raise ValueError(f"unknown policy kind {kind!r} "
                         f"(register it with policies.register_policy)")
    for k, v in d.items():          # JSON round-trip turns tuples into lists
        if isinstance(v, list):
            d[k] = tuple(v)
        elif isinstance(v, dict) and "kind" in v:
            d[k] = policy_from_spec(v)   # nested sub-policy
    return _REGISTRY[kind](**d)
