"""Experiments of the paper's evaluation protocol (§5) on PyTorch.

Counterpart of ``repro.core.experiment``: data preparation on the simulated
MIMIC-III (:mod:`repro_torch.data.synthetic`), HFL training across the two
hospitals (:func:`train_hfl`) and over generated N-hospital populations
(:func:`train_population`), on the sequential engine.  The benchmark systems
(DNN, BIBE, BIBEP) and the heterogeneous/lazy populations are not ported
yet (ROADMAP §A3, §A7-§A9).  Entry points take ``device`` (default
``"cuda"``) and raise without a card unless ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.federation import Callback, Federation
from repro_torch.core.hfl import FederatedClient, HFLConfig
from repro_torch.core.policies import FederationPolicies
from repro_torch.data import synthetic as syn


# ---------------------------------------------------------------------------
# Data preparation
# ---------------------------------------------------------------------------

def _normalize_streams(data: syn.HospitalData):
    """Per-channel z-score using TRAIN-split statistics.  ALL channels
    (label included) are normalized for optimization; reported MSEs are
    rescaled back to raw units by sigma_label^2 (paper reports raw units)."""
    nf = data.streams[0].nf
    n_chan = nf + 1
    vals = {c: [] for c in range(n_chan)}
    for i in data.splits["train"]:
        s = data.streams[i]
        for c in range(n_chan):
            v = s.values[s.channels == c]
            if len(v):
                vals[c].append(v)
    mu = np.zeros(n_chan, np.float32)
    sd = np.ones(n_chan, np.float32)
    for c in range(n_chan):
        if vals[c]:
            allv = np.concatenate(vals[c])
            mu[c], sd[c] = allv.mean(), max(1e-6, allv.std())
    out = []
    for s in data.streams:
        v = s.values.copy()
        for c in range(n_chan):
            m = s.channels == c
            v[m] = (v[m] - mu[c]) / sd[c]
        out.append(dataclasses.replace(s, values=v))
    return out, float(mu[nf]), float(sd[nf])


def _scaled_patients(hospital: str, n_patients: Optional[int]):
    """Preserve the paper's domain-size asymmetry (Table 3: metavision is
    the smaller source) when a reduced budget is requested: `n_patients`
    sets the carevue count; metavision scales by the natural 58/120 ratio."""
    if n_patients is None:
        return None
    if hospital == "metavision":
        return max(6, int(round(n_patients * 58 / 120)))
    return n_patients


def task_data(hospital: str, label_idx: int, w: int, seed: int = 0,
              n_patients: Optional[int] = None, n_events: int = 400):
    """Packed (train, valid, test) numpy tensors for predicting channel
    `label_idx` of `hospital` from its other channels."""
    data = syn.make_hospital(hospital, seed=seed,
                             n_patients=_scaled_patients(hospital, n_patients),
                             n_events=n_events)
    # relabel so channel `label_idx` plays the label role
    relabeled = syn.HospitalData(
        data.name, data.feature_names,
        [syn.relabel(s, label_idx) for s in data.streams], data.splits)
    relabeled.streams, mu_y, sd_y = _normalize_streams(relabeled)
    packed = {}
    for split in ("train", "valid", "test"):
        packed[split] = syn.packed_split(relabeled, split, w)
    packed["label_var"] = sd_y * sd_y    # raw-unit rescale for reported MSEs
    return packed


# ---------------------------------------------------------------------------
# HFL training (federated over both hospitals)
# ---------------------------------------------------------------------------

def train_hfl(target: str, label_idx: int, cfg: HFLConfig, seed: int = 0,
              n_patients=None, n_events: int = 400,
              verbose: bool = False,
              policies: Optional[FederationPolicies] = None,
              callbacks: Sequence[Callback] = (),
              device="cuda") -> Dict[str, float]:
    """The paper's two-hospital HFL system: `target` and the other hospital
    federate on the sequential engine.  Returns the target's best-valid and
    test MSE and federated rounds, and the source's test MSE, in raw
    units."""
    device = resolve_device(device)
    source = "carevue" if target == "metavision" else "metavision"
    t_pack = task_data(target, label_idx, cfg.w, seed, n_patients, n_events)
    s_pack = task_data(source, label_idx, cfg.w, seed, n_patients, n_events)
    nf = t_pack["train"][0].shape[1]
    clients = [
        FederatedClient(target, nf, cfg, t_pack["train"], t_pack["valid"],
                        t_pack["test"], seed, device=device),
        FederatedClient(source, nf, cfg, s_pack["train"], s_pack["valid"],
                        s_pack["test"], seed + 17, device=device),
    ]
    fed = Federation(clients, cfg, policies=policies, callbacks=callbacks)
    hist = fed.fit(verbose=verbose)
    t_scale, s_scale = t_pack["label_var"], s_pack["label_var"]
    return {"valid": hist[target]["best_val"] * t_scale,
            "test": hist[target]["test"] * t_scale,
            "rounds": hist[target]["rounds"],
            "source_test": hist[source]["test"] * s_scale}


# ---------------------------------------------------------------------------
# N-hospital populations
# ---------------------------------------------------------------------------

def _truncate_common(packs: List[dict]) -> List[dict]:
    """Truncate every client's split tensors to the population-wide minimum
    length (the layout the batched engine stacks)."""
    out = []
    mins = {s: min(len(p[s][2]) for p in packs)
            for s in ("train", "valid", "test")}
    for p in packs:
        q = dict(p)
        for s in ("train", "valid", "test"):
            q[s] = tuple(a[:mins[s]] for a in p[s])
        out.append(q)
    return out


def _pack_hospital(data: syn.HospitalData, w: int) -> dict:
    """Normalize + pack one hospital's splits."""
    streams, mu_y, sd_y = _normalize_streams(data)
    data = syn.HospitalData(data.name, data.feature_names, streams,
                            data.splits)
    packed = {"name": data.name,
              "nf": len(data.feature_names)}
    for split in ("train", "valid", "test"):
        packed[split] = syn.packed_split(data, split, w)
    packed["label_var"] = sd_y * sd_y
    return packed


def population_task_data(n_clients: int, w: int, seed: int = 0,
                         n_patients: int = 10, n_events: int = 300,
                         nf: int = 4) -> List[dict]:
    """Packed per-hospital tensors for an N-hospital generated population,
    truncated to common split lengths."""
    pop = syn.make_population(n_clients, seed=seed, nf=nf,
                              n_patients=n_patients, n_events=n_events)
    return _truncate_common([_pack_hospital(data, w) for data in pop])


def population_clients(n_clients: int, cfg: HFLConfig, seed: int = 0,
                       n_patients: int = 10, n_events: int = 300,
                       device="cuda"
                       ) -> Tuple[List[FederatedClient], List[dict]]:
    """Freshly-constructed clients (plus their packed data dicts) for an
    N-hospital generated population; client i draws its parameters with
    seed ``seed + 31 i``."""
    device = resolve_device(device)
    packs = population_task_data(n_clients, cfg.w, seed, n_patients, n_events)
    nf = packs[0]["train"][0].shape[1]
    clients = [
        FederatedClient(p["name"], nf, cfg, p["train"], p["valid"], p["test"],
                        seed + 31 * i, device=device)
        for i, p in enumerate(packs)]
    return clients, packs


def train_population(n_clients: int, cfg: HFLConfig,
                     engine: str = "sequential", seed: int = 0,
                     n_patients: int = 10, n_events: int = 300,
                     verbose: bool = False,
                     policies: Optional[FederationPolicies] = None,
                     callbacks: Sequence[Callback] = (),
                     device="cuda") -> Dict[str, Dict[str, float]]:
    """Federated training over an N-hospital generated population.  Returns
    the per-client history with test/best_val rescaled to raw units.  Only
    the sequential engine is ported (``engine="batched"`` raises)."""
    clients, packs = population_clients(n_clients, cfg, seed, n_patients,
                                        n_events, device)
    fed = Federation(clients, cfg, engine=engine, policies=policies,
                     callbacks=callbacks)
    hist = fed.fit(verbose=verbose)
    for p in packs:
        h = hist[p["name"]]
        h["test"] *= p["label_var"]
        h["best_val"] *= p["label_var"]
    return hist
