"""Dense & sparse feature tensors (paper §3, Figs. 3-4).

A patient record is an *event stream*: at each tick exactly ONE channel (one
of `nf` features or the label) carries a value — the paper's sparsity model.
For every tick where the LABEL is observed we pack:

  sparse tensor  X^S ∈ R^{nf x w}:  X^S[i, l] = x_i at tick (t-1-l) if that
      tick carried feature i, else 0   (raw last-w window per feature);
  dense tensor   X^D ∈ R^{nf x w}:  X^D[i, l] = the (l+1)-th most recent
      *available* value of feature i before tick t (0 while unseen).

Both are returned most-recent-first along the window axis, matching Eq. (1):
X^S_{i,t} = [x_{i,t-1}, x_{i,t-2}, ..., x_{i,t-w}].

A numpy-only copy of ``repro.core.feature_tensors``: the port imports
nothing of the JAX package, and both pack byte-identical tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class EventStream:
    """One patient's sparse record.  channel: 0..nf-1 = features, nf = label."""
    channels: np.ndarray   # (T,) int32
    values: np.ndarray     # (T,) float32
    times: np.ndarray      # (T,) float32, strictly increasing (irregular gaps)
    nf: int

    def __post_init__(self):
        assert self.channels.shape == self.values.shape == self.times.shape


def pack_feature_tensors(stream: EventStream, w: int
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (X_sparse, X_dense, y) with shapes (N, nf, w), (N, nf, w), (N,)
    where N = number of label events (label events with no history still
    count; unseen entries are 0, as in the paper's zero-padded tensors)."""
    nf = stream.nf
    T = len(stream.channels)
    label_ticks = np.nonzero(stream.channels == nf)[0]
    N = len(label_ticks)
    xs = np.zeros((N, nf, w), np.float32)
    xd = np.zeros((N, nf, w), np.float32)
    y = stream.values[label_ticks].astype(np.float32)

    # rolling per-feature history of available values (most-recent-first)
    hist = np.zeros((nf, w), np.float32)
    hist_len = np.zeros(nf, np.int64)
    li = 0
    for t in range(T):
        ch = stream.channels[t]
        if ch == nf:
            if li < N and label_ticks[li] == t:
                # sparse: raw window of the last w ticks
                lo = max(0, t - w)
                for l, tick in enumerate(range(t - 1, lo - 1, -1)):
                    c = stream.channels[tick]
                    if c < nf:
                        xs[li, c, l] = stream.values[tick]
                xd[li] = hist
                li += 1
        else:
            hist[ch, 1:] = hist[ch, :-1]
            hist[ch, 0] = stream.values[t]
            hist_len[ch] = min(w, hist_len[ch] + 1)
    return xs, xd, y


def pack_feature_tensors_ref(stream: EventStream, w: int):
    """O(T*w) oracle used by the hypothesis property tests (independent,
    maximally-dumb implementation)."""
    nf = stream.nf
    out_s, out_d, out_y = [], [], []
    for t in range(len(stream.channels)):
        if stream.channels[t] != nf:
            continue
        xs = np.zeros((nf, w), np.float32)
        for l in range(w):
            tick = t - 1 - l
            if tick >= 0 and stream.channels[tick] < nf:
                xs[stream.channels[tick], l] = stream.values[tick]
        xd = np.zeros((nf, w), np.float32)
        for i in range(nf):
            past = [stream.values[u] for u in range(t)
                    if stream.channels[u] == i]
            for l, v in enumerate(reversed(past[-w:])):
                xd[i, l] = v
        out_s.append(xs)
        out_d.append(xd)
        out_y.append(stream.values[t])
    if not out_y:
        return (np.zeros((0, nf, w), np.float32),) * 2 + (np.zeros(0, np.float32),)
    return (np.stack(out_s), np.stack(out_d),
            np.asarray(out_y, np.float32))
