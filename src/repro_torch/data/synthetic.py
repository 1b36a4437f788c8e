"""Synthetic two-source sparse clinical time-series (the simulated MIMIC-III
gate — see DESIGN.md §7).

A shared latent physiological state z (OU process, irregular sampling) is
observed through *per-hospital* observation operators.  Hospital "carevue"
(source-rich) and hospital "metavision" (smaller target) expose DIFFERENT
feature channels with different scales/noise — heterogeneous feature spaces,
exactly the paper's setting (Table 3: e.g. 'SpO2' vs 'O2 saturation pulse
oximetry', 'Arterial BP' vs 'Non Invasive Blood Pressure').

At every tick exactly ONE channel is observed (paper §3's sparsity model),
channel frequencies mimic Table 3's record-count skew.

A numpy-only copy of ``repro.data.synthetic`` (the two hospitals and the
homogeneous population): the port imports nothing of the JAX package, and
the same seeds give byte-identical data in both (pinned by the tests).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List

import numpy as np

from repro_torch.core.feature_tensors import EventStream, pack_feature_tensors

Z_DIM = 6

# (name, mean, std, latent weights, observation-frequency weight)
HOSPITALS = {
    "carevue": {
        "features": [
            ("heart_rate", 80.0, 14.0, (1.0, 0.3, 0.0, 0.0, 0.2, 0.0), 5.18),
            ("spo2", 96.5, 2.5, (0.0, -0.8, 0.4, 0.0, 0.0, 0.1), 3.42),
            ("resp_rate", 18.0, 4.5, (0.3, -0.5, 0.0, 0.6, 0.0, 0.0), 3.39),
            ("abp_sys", 122.0, 18.0, (0.5, 0.0, 0.9, 0.0, -0.2, 0.0), 2.10),
        ],
        "label": ("abp_dia", 64.0, 12.0, (0.4, 0.0, 0.8, 0.0, -0.3, 0.1), 2.09),
        "n_patients": 120,
    },
    "metavision": {
        "features": [
            ("heart_rate", 78.0, 13.0, (1.0, 0.25, 0.0, 0.0, 0.15, 0.0), 2.76),
            ("resp_rate", 18.5, 4.0, (0.3, -0.5, 0.0, 0.6, 0.0, 0.0), 2.74),
            ("o2_sat_pulse", 96.0, 2.8, (0.0, -0.8, 0.45, 0.0, 0.0, 0.1), 2.67),
            ("nibp_mean", 84.0, 13.0, (0.45, 0.0, 0.85, 0.0, -0.25, 0.05), 1.29),
        ],
        "label": ("nibp_sys", 118.0, 17.0, (0.5, 0.0, 0.9, 0.0, -0.2, 0.0), 1.29),
        "n_patients": 58,  # the smaller target domain
    },
}


@dataclasses.dataclass
class HospitalData:
    name: str
    feature_names: List[str]
    streams: List[EventStream]          # one per patient
    splits: Dict[str, List[int]]        # train/valid/test patient indices


def _ou_path(rng: np.random.Generator, times: np.ndarray) -> np.ndarray:
    """Ornstein-Uhlenbeck latent state sampled at irregular times."""
    theta, sigma = 0.08, 1.0
    z = np.zeros((len(times), Z_DIM), np.float64)
    z[0] = rng.normal(size=Z_DIM)
    for t in range(1, len(times)):
        dt = times[t] - times[t - 1]
        decay = np.exp(-theta * dt)
        var = (sigma ** 2) * (1 - decay ** 2) / (2 * theta)
        z[t] = z[t - 1] * decay + rng.normal(scale=np.sqrt(var), size=Z_DIM)
    return z


def make_patient(rng: np.random.Generator, hospital,
                 n_events: int, label_noise: float = 0.15) -> EventStream:
    """`hospital` is a name from HOSPITALS or a spec dict of the same shape
    (population hospitals are generated, not registered)."""
    spec = HOSPITALS[hospital] if isinstance(hospital, str) else hospital
    chans = spec["features"] + [spec["label"]]
    nf = len(spec["features"])
    freq = np.array([c[4] for c in chans])
    p = freq / freq.sum()
    gaps = rng.exponential(scale=1.0, size=n_events)
    times = np.cumsum(gaps)
    z = _ou_path(rng, times)
    channels = rng.choice(len(chans), size=n_events, p=p).astype(np.int32)
    values = np.empty(n_events, np.float32)
    for t in range(n_events):
        name, mu, sd, wz, _ = chans[channels[t]]
        wz = np.asarray(wz)
        sig = z[t] @ wz / max(1e-9, np.linalg.norm(wz))
        noise = label_noise if channels[t] == nf else 0.25
        values[t] = mu + sd * (0.9 * sig + noise * rng.normal())
    return EventStream(channels=channels, values=values,
                       times=times.astype(np.float32), nf=nf)


def make_hospital(hospital: str, seed: int = 0, n_patients: int = None,
                  n_events: int = 400) -> HospitalData:
    return make_hospital_from_spec(hospital, HOSPITALS[hospital], seed,
                                   n_patients, n_events)


def make_hospital_from_spec(name: str, spec: dict, seed: int = 0,
                            n_patients: int = None,
                            n_events: int = 400) -> HospitalData:
    # crc32, not hash(): str hashes are salted per process, which would make
    # "identical seed" runs train on different data across interpreter runs
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 100003)
    n = n_patients or spec["n_patients"]
    streams = [make_patient(rng, spec, n_events) for _ in range(n)]
    idx = rng.permutation(n)
    n_tr, n_va = int(0.6 * n), int(0.2 * n)
    splits = {"train": idx[:n_tr].tolist(),
              "valid": idx[n_tr:n_tr + n_va].tolist(),
              "test": idx[n_tr + n_va:].tolist()}
    return HospitalData(name, [c[0] for c in spec["features"]],
                        streams, splits)


# ---------------------------------------------------------------------------
# N-hospital populations (scaling beyond the paper's two-source setting)
# ---------------------------------------------------------------------------

# union of both paper hospitals' channel templates — population hospitals
# draw jittered variants of these, mimicking Table 3's near-synonymous
# channels ('SpO2' vs 'O2 saturation pulse oximetry', ...)
_CHANNEL_BANK = (HOSPITALS["carevue"]["features"]
                 + [HOSPITALS["carevue"]["label"]]
                 + HOSPITALS["metavision"]["features"]
                 + [HOSPITALS["metavision"]["label"]])


def population_spec(rng: np.random.Generator, nf: int = 4) -> dict:
    """One generated hospital: nf feature channels + 1 label channel, each a
    perturbed draw from the channel bank (different scales, noise, latent
    weights, observation frequencies — heterogeneous observation operators
    over the SAME latent physiology, exactly the paper's setting)."""
    n_chan = nf + 1
    replace = n_chan > len(_CHANNEL_BANK)
    picks = rng.choice(len(_CHANNEL_BANK), size=n_chan, replace=replace)
    chans = []
    for k, b in enumerate(picks):
        name, mu, sd, wz, freq = _CHANNEL_BANK[b]
        chans.append((
            f"{name}_v{k}",
            float(mu * (1 + 0.08 * rng.normal())),
            float(sd * abs(1 + 0.15 * rng.normal()) + 1e-3),
            tuple(np.asarray(wz, np.float64) + 0.1 * rng.normal(size=Z_DIM)),
            float(freq * np.exp(0.4 * rng.normal())),
        ))
    return {"features": chans[:nf], "label": chans[nf],
            # skewed domain sizes, echoing Table 3's carevue/metavision gap
            "n_patients": int(rng.integers(8, 25))}


def make_population(n_hospitals: int, seed: int = 0, nf: int = 4,
                    n_patients: int = None,
                    n_events: int = 300) -> List[HospitalData]:
    """Generate an N-hospital federated population.  Every hospital observes
    the shared OU latent state through its own generated observation operator
    (population_spec).  `n_patients=None` keeps the skewed per-hospital
    sizes; an int forces equal sizes (what the batched engine wants)."""
    rng = np.random.default_rng(seed)
    out = []
    for h in range(n_hospitals):
        spec = population_spec(rng, nf)
        out.append(make_hospital_from_spec(
            f"h{h:03d}", spec, seed=seed + 7919 * (h + 1),
            n_patients=n_patients, n_events=n_events))
    return out


def packed_split(data: HospitalData, split: str, w: int):
    """Concatenate packed tensors over a patient split.
    Returns (X_sparse, X_dense, y) float32 arrays."""
    xs, xd, ys = [], [], []
    for i in data.splits[split]:
        a, b, c = pack_feature_tensors(data.streams[i], w)
        xs.append(a)
        xd.append(b)
        ys.append(c)
    return (np.concatenate(xs), np.concatenate(xd), np.concatenate(ys))


def relabel(stream: EventStream, label_channel: int) -> EventStream:
    """Swap the label role to a different channel (the paper predicts each of
    the five channels in turn: use [CF1..CF4]->CF5, [CF1..CF3,CF5]->CF4, ...).
    Channel ids are remapped so features stay 0..nf-1 and label = nf."""
    nf = stream.nf
    old_label = nf
    mapping = {}
    nxt = 0
    for c in range(nf + 1):
        if c == label_channel:
            mapping[c] = nf
        else:
            mapping[c] = nxt
            nxt += 1
    # old label becomes an ordinary feature unless it IS the chosen label
    channels = np.array([mapping[c] for c in stream.channels], np.int32)
    return EventStream(channels=channels, values=stream.values,
                       times=stream.times, nf=nf)
