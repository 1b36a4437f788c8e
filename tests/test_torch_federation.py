"""Port parity for the slice as a whole: the sequential Federation of the
paper's two hospitals, from parameters carried across from the JAX package.
Selections and federated rounds must be identical (argmin over close fp32
scores, and numpy host RNG streams in both packages); validation histories
agree to rtol 1e-4 (fp32 training steps, summed in another order)."""
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import experiment as JE  # noqa: E402
from repro.core import federation as JF  # noqa: E402
from repro.core import hfl as JH  # noqa: E402
from repro.core import policies as JP  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import experiment as TE  # noqa: E402
from repro_torch.core import federation as TF  # noqa: E402
from repro_torch.core import hfl as TH  # noqa: E402
from repro_torch.core import policies as TP  # noqa: E402

HOSPITALS = ("metavision", "carevue")


def _staleness_bundle(P):
    return P.FederationPolicies(P.AlwaysSwitch(), P.ArgminSelection(),
                                P.AlphaBlend(0.2), P.MaxStaleness(max_age=1))


def _both(mode, epochs, k_ex=1, bounded=False, **kw):
    """One run per package on the same data and initial parameters.
    ``k_ex`` sets the exchange cadence; ``bounded`` swaps in a MaxStaleness
    pool, whose ages tick once per exchange round."""
    cfg = dict(epochs=epochs, mode=mode, R=20, **kw)
    jcfg, tcfg = JH.HFLConfig(**cfg), TH.HFLConfig(**cfg)
    jc, tc = [], []
    for i, h in enumerate(HOSPITALS):
        p = JE.task_data(h, 4, 3, seed=0, n_patients=8, n_events=200)
        nf = p["train"][0].shape[1]
        c = JH.FederatedClient(h, nf, jcfg, p["train"], p["valid"],
                               p["test"], jax.random.PRNGKey(i))
        jc.append(c)
        tc.append(TH.FederatedClient(
            h, nf, tcfg, p["train"], p["valid"], p["test"], device="cpu",
            params=convert.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, c.params))))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # ragged R-batches
        jfed = JF.Federation(
            jc, jcfg, schedule=JF.RoundSchedule(epochs, 20, k_ex),
            policies=_staleness_bundle(JP) if bounded else None)
        tfed = TF.Federation(
            tc, tcfg, schedule=TF.RoundSchedule(epochs, 20, k_ex),
            policies=_staleness_bundle(TP) if bounded else None)
        return jfed, jfed.fit(), tfed, tfed.fit()


@pytest.mark.parametrize("mode,epochs,kw", [
    ("always", 3, {}),
    ("hfl", 4, {"patience": 1}),           # patience 1: plateaus occur
    ("no", 2, {}),
    ("random", 3, {}),
    ("always", 2, {"use_pool_kernel": True}),
    ("always", 3, {"k_ex": 2, "bounded": True}),
])
def test_sequential_federation_matches_reference(mode, epochs, kw):
    jfed, hj, tfed, ht = _both(mode, epochs, **kw)
    for name in HOSPITALS:
        assert ht[name]["rounds"] == hj[name]["rounds"]
        assert ht[name]["selections"] == hj[name]["selections"]
        np.testing.assert_allclose(ht[name]["val"], hj[name]["val"],
                                   rtol=1e-4)
        np.testing.assert_allclose(ht[name]["test"], hj[name]["test"],
                                   rtol=1e-4)
        assert np.isfinite(ht[name]["test"])
    assert tfed.dispatch_stats["exchange_rounds"] == \
        jfed.dispatch_stats["exchange_rounds"]
    total = sum(ht[n]["rounds"] for n in HOSPITALS)
    assert (total == 0) == (mode == "no")
    assert tfed.pool.ages == jfed.pool.ages


def test_train_hfl_runs_on_cpu_when_asked():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = TE.train_hfl("metavision", 4,
                           TH.HFLConfig(epochs=1, mode="always", R=20),
                           n_patients=8, n_events=200, device="cpu")
    assert set(res) == {"valid", "test", "rounds", "source_test"}
    assert res["rounds"] > 0
    assert all(np.isfinite(v) for v in res.values())


def test_batched_engine_not_ported_yet():
    with pytest.raises(NotImplementedError, match="A6"):
        TF.Federation([], TH.HFLConfig(), engine="batched")
    with pytest.raises(ValueError, match="unknown engine"):
        TF.Federation([], TH.HFLConfig(), engine="fused")


def test_resumed_fit_continues():
    """fit(epochs=k) twice equals one fit of 2k epochs (state lives on the
    Federation and its clients)."""
    cfg = TH.HFLConfig(epochs=2, mode="always", R=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        runs = []
        for split in ((2,), (1, 1)):
            clients, _ = TE.population_clients(3, cfg, seed=1, n_patients=6,
                                               n_events=120, device="cpu")
            fed = TF.Federation(clients, cfg)
            for k in split:
                hist = fed.fit(epochs=k)
            runs.append(hist)
    for name in runs[0]:
        assert runs[0][name]["selections"] == runs[1][name]["selections"]
        assert runs[0][name]["val"] == runs[1][name]["val"]


def test_train_population_on_cpu():
    cfg = TH.HFLConfig(epochs=1, mode="always", R=20)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        hist = TE.train_population(3, cfg, seed=2, n_patients=6,
                                   n_events=120, device="cpu")
    assert len(hist) == 3
    assert all(h["rounds"] > 0 and np.isfinite(h["test"])
               for h in hist.values())


def test_legacy_primitives_match_reference():
    """switch_active, blend (on carried parameters) and federated_round
    (one client's Eq.-7 round under its cfg.mode, after one train step)
    against the reference."""
    for mode in ("no", "always", "random", "hfl"):
        for hist in ([], [3.0, 2.0], [2.0, 2.5, 2.4, 2.6]):
            cfg_kw = dict(mode=mode, patience=2)
            assert TH.switch_active(hist, TH.HFLConfig(**cfg_kw)) == \
                JH.switch_active(hist, JH.HFLConfig(**cfg_kw))
    cfg = dict(epochs=1, mode="always", R=20)
    jcfg, tcfg = JH.HFLConfig(**cfg), TH.HFLConfig(**cfg)
    p = JE.task_data("metavision", 4, 3, seed=0, n_patients=8, n_events=200)
    jc = [JH.FederatedClient(n, 4, jcfg, p["train"], p["valid"], p["test"],
                             jax.random.PRNGKey(i))
          for i, n in enumerate(("a", "b"))]
    tc = [TH.FederatedClient(c.name, 4, tcfg, p["train"], p["valid"],
                             p["test"], device="cpu",
                             params=convert.params_from_numpy(
                                 jax.tree_util.tree_map(np.asarray,
                                                        c.params)))
          for c in jc]
    ours = TH.blend(tc[0].params["heads"], tc[1].params["heads"], 0.2)
    ref = JH.blend(jc[0].params["heads"], jc[1].params["heads"], 0.2)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)
    jpool, tpool = JH.HeadPool(), TH.HeadPool()
    for j, t in zip(jc, tc):
        jpool.publish(j.name, j.params["heads"], 4)
        tpool.publish(t.name, t.params["heads"], 4)
        next(j.train_epoch())
        next(t.train_epoch())
    sel_j = JH.federated_round(jc[0], jpool, np.random.default_rng(0))
    sel_t = TH.federated_round(tc[0], tpool, np.random.default_rng(0))
    assert sel_t == sel_j and len(sel_t) == 4
