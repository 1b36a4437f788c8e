"""Port parity: feature tensors and synthetic data.  The port keeps numpy
copies of ``repro.core.feature_tensors`` and ``repro.data.synthetic``; the
same seeds must give byte-identical packed tensors in both packages."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import experiment as JE  # noqa: E402
from repro.core import feature_tensors as JFT  # noqa: E402
from repro.data import synthetic as JSYN  # noqa: E402
from repro_torch.core import experiment as TE  # noqa: E402
from repro_torch.core import feature_tensors as TFT  # noqa: E402
from repro_torch.data import synthetic as TSYN  # noqa: E402


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _stream(mod, seed, nf=4, T=120):
    rng = np.random.default_rng(seed)
    return mod.EventStream(
        channels=rng.integers(0, nf + 1, T).astype(np.int32),
        values=rng.normal(size=T).astype(np.float32),
        times=np.cumsum(rng.exponential(size=T)).astype(np.float32), nf=nf)


@pytest.mark.parametrize("seed,w", [(0, 3), (1, 5), (2, 1)])
def test_pack_feature_tensors_byte_identical(seed, w):
    for fn in ("pack_feature_tensors", "pack_feature_tensors_ref"):
        ours = getattr(TFT, fn)(_stream(TFT, seed), w)
        theirs = getattr(JFT, fn)(_stream(JFT, seed), w)
        for a, b in zip(ours, theirs):
            _assert_same(a, b)


def test_hospitals_and_population_byte_identical():
    for name in ("metavision", "carevue"):
        a = TSYN.make_hospital(name, seed=3, n_patients=6, n_events=120)
        b = JSYN.make_hospital(name, seed=3, n_patients=6, n_events=120)
        assert a.splits == b.splits and a.feature_names == b.feature_names
        for sa, sb in zip(a.streams, b.streams):
            _assert_same(sa.channels, sb.channels)
            _assert_same(sa.values, sb.values)
            _assert_same(sa.times, sb.times)
            _assert_same(TSYN.relabel(sa, 1).channels,
                         JSYN.relabel(sb, 1).channels)
        for split in ("train", "valid", "test"):
            for x, y in zip(TSYN.packed_split(a, split, 3),
                            JSYN.packed_split(b, split, 3)):
                _assert_same(x, y)
    pa = TSYN.make_population(3, seed=5, n_patients=4, n_events=100)
    pb = JSYN.make_population(3, seed=5, n_patients=4, n_events=100)
    for ha, hb in zip(pa, pb):
        assert ha.name == hb.name and ha.splits == hb.splits
        for x, y in zip(TSYN.packed_split(ha, "train", 3),
                        JSYN.packed_split(hb, "train", 3)):
            _assert_same(x, y)


@pytest.mark.parametrize("hospital", ["metavision", "carevue"])
def test_task_data_splits_byte_identical(hospital):
    a = TE.task_data(hospital, 4, 3, seed=0, n_patients=8, n_events=200)
    b = JE.task_data(hospital, 4, 3, seed=0, n_patients=8, n_events=200)
    assert a["label_var"] == b["label_var"]
    for split in ("train", "valid", "test"):
        for x, y in zip(a[split], b[split]):
            _assert_same(x, y)


def test_population_task_data_byte_identical():
    a = TE.population_task_data(3, 3, seed=1, n_patients=6, n_events=120)
    b = JE.population_task_data(3, 3, seed=1, n_patients=6, n_events=120)
    for pa, pb in zip(a, b):
        assert pa["name"] == pb["name"] and pa["label_var"] == pb["label_var"]
        for split in ("train", "valid", "test"):
            for x, y in zip(pa[split], pb[split]):
                _assert_same(x, y)
