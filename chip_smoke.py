#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card, then
drives the paper's two-hospital HFL system (``train_hfl``) on ``cuda`` at
the default data size and full Table-4 widths, and checks that every Eq.-7
score of that run went through the kernel.  Exits non-zero on any failure
(no phase catches an error) and when no GPU is present.  Imports nothing
of JAX or of the JAX package.

Output: a ``{"kernels": [...]}`` line with each kernel's launches on the
main path, error against its plain version, times (CUDA events, after a
warm-up) and bound, then the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``.
"""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import _build  # noqa: E402
from repro_torch._tree import tree_map  # noqa: E402
from repro_torch.core import networks as N  # noqa: E402
from repro_torch.core.experiment import train_hfl  # noqa: E402
from repro_torch.core.federation import Callback  # noqa: E402
from repro_torch.core.hfl import HFLConfig  # noqa: E402
from repro_torch.kernels.pool_mlp import kernel as K  # noqa: E402
from repro_torch.kernels.pool_mlp import ops  # noqa: E402
from repro_torch.kernels.pool_mlp.ref import pool_errors_features_ref  # noqa: E402
from repro_torch.sharding import spec as S  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6          # fp32 FMA chains against cuBLAS products
FP32_PEAK = 67e12                # H100 SXM fp32 FLOP/s outside tensor cores
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
SPIN_CYCLES = 500_000_000        # about 0.25 s of device spin at H100 clocks
DEV = torch.device("cuda")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_summary(report: str) -> dict:
    """Registers and spill bytes per kernel from nvcc's ``-Xptxas -v``
    report, so they survive a cut-off log in the ``kernels`` line."""
    return {"registers": [int(n) for n in
                          re.findall(r"Used (\d+) registers", report)],
            "spill_store_bytes": [int(n) for n in
                                  re.findall(r"(\d+) bytes spill stores",
                                             report)]}


def make_case(nf, ns, R, w, seed):
    """A stacked pool of ns Table-4 heads and an (nf, R, w) probe batch."""
    pool = S.materialize(S.stack(N.head_schema(w), ns), seed, DEV)
    rng = np.random.default_rng(seed)
    xd = torch.tensor(rng.normal(size=(nf, R, w)), dtype=torch.float32,
                      device=DEV)
    y = torch.tensor(rng.normal(size=R), dtype=torch.float32, device=DEV)
    return pool, xd, y


def plain(pool, xd, y, valid=None):
    """The plain version on the card, pinned as the wrappers pin."""
    errs = pool_errors_features_ref(pool, xd, y)
    errs = torch.where(torch.isfinite(errs), errs, torch.inf)
    if valid is not None:
        errs = torch.where(valid[None, :], errs, torch.inf)
    return errs


def compare(name, got, want, stats):
    """Kernel against plain: +inf exactly where the plain version pins it,
    finite entries within RTOL/ATOL, the same argmin per feature."""
    torch.cuda.synchronize()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert torch.equal(torch.isposinf(got), torch.isposinf(want)), \
        f"{name}: +inf pattern differs"
    assert bool(torch.isfinite(got[~torch.isposinf(got)]).all()), \
        f"{name}: NaN or -inf in the kernel's output"
    fin = torch.isfinite(want)
    g, r = got[fin].double(), want[fin].double()
    abs_err = float((g - r).abs().max()) if g.numel() else 0.0
    rel_err = float(((g - r).abs() / r.abs().clamp_min(1e-30)).max()) \
        if g.numel() else 0.0
    assert bool(((g - r).abs() <= ATOL + RTOL * r.abs()).all()), \
        f"{name}: max abs err {abs_err:.3e}, max rel err {rel_err:.3e}"
    assert torch.equal(torch.argmin(got, dim=1), torch.argmin(want, dim=1)), \
        f"{name}: argmin differs"
    stats["max_abs_err"] = max(stats["max_abs_err"], abs_err)
    stats["max_rel_err"] = max(stats["max_rel_err"], rel_err)
    print(f"  {name:34s} shape {tuple(got.shape)}  max abs err "
          f"{abs_err:.3e}  max rel err {rel_err:.3e}  ok", flush=True)


def time_ms(fn, iters):
    """Mean device time of one call, from CUDA events around `iters`
    back-to-back calls after a warm-up.  A spin kernel holds the device
    while the host queues the calls, so the events time the device and not
    the host's launch rate (a small call's launch costs the host more than
    the call costs the device).  Checks that the host queued everything
    before the spin ended."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ev[2].record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = ev[0].elapsed_time(ev[1])
    assert host_ms < spin_ms, \
        f"the host queued for {host_ms:.1f} ms, longer than the " \
        f"{spin_ms:.1f} ms spin: raise SPIN_CYCLES"
    return ev[1].elapsed_time(ev[2]) / iters


def pool_mlp_bound(nf, ns, R, w):
    """Least time for the sweep on an H100 SXM: the larger of the bytes it
    must move (inputs read once, output written once) over the memory rate
    and its FMAs (2 flops each) over the fp32 rate."""
    dims = (w, 16, 256, 64, 16, 1)
    macs = sum(a * b for a, b in zip(dims, dims[1:]))
    n_weights = macs + sum(dims[1:])
    nbytes = 4 * (nf * R * w + R + ns * n_weights + nf * ns)
    flops = 2 * macs * R * nf * ns
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_PEAK
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def timed_pair(nf, ns, R, w, iters, plain_iters):
    """Kernel and plain-version times in turns (plain, kernel, kernel,
    plain) on one seeded input, with the bound for that shape.  The plain
    version launches tens of kernels per call, so it gets fewer calls: the
    device's launch queue must hold a whole timed run behind the spin."""
    pool, xd, y = make_case(nf, ns, R, w, seed=7)
    weights = tuple(pool[k] for k in ops._KEYS)

    def run_kernel():
        return K.pool_mlp_features_cuda(xd, y, weights)

    def run_plain():
        return plain(pool, xd, y)

    p1 = time_ms(run_plain, plain_iters)
    k1 = time_ms(run_kernel, iters)
    k2 = time_ms(run_kernel, iters)
    p2 = time_ms(run_plain, plain_iters)
    bound_ms, bound_by, flops, nbytes = pool_mlp_bound(nf, ns, R, w)
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": {"nf": nf, "ns": ns, "R": R, "w": w},
            "flops": flops, "bytes": nbytes}


def kernel_phase():
    stats = {"max_abs_err": 0.0, "max_rel_err": 0.0}
    # the sequential engine's shape: one feature, the other client's 4 heads
    pool, xd, y = make_case(1, 4, 50, 3, seed=1)
    compare("slice nf=1 ns=4 R=50 w=3",
            ops.pool_mlp_errors(pool, xd[0], y)[None], plain(pool, xd, y),
            stats)
    # the batched engine's shape at 128 clients
    pool, xd, y = make_case(4, 512, 50, 3, seed=2)
    full = ops.pool_mlp_errors_features(pool, xd, y)
    compare("batched nf=4 ns=512 R=50 w=3", full, plain(pool, xd, y), stats)
    lo, hi = 100, 228
    chunk = tree_map(lambda t: t[lo:hi], pool)
    shard = ops.pool_mlp_errors_shard(chunk, xd, y)
    torch.cuda.synchronize()
    assert torch.equal(shard, full[:, lo:hi]), "shard != slice of full sweep"
    print(f"  shard [{lo}:{hi}] equals the full sweep's columns bit for bit",
          flush=True)
    # ragged pools and the reference test's shape sweep
    for nf, ns, R, w in ((2, 37, 7, 3), (1, 10, 50, 3), (1, 4, 20, 5),
                         (1, 16, 50, 3), (1, 3, 7, 2)):
        pool, xd, y = make_case(nf, ns, R, w, seed=3 + ns)
        compare(f"ragged nf={nf} ns={ns} R={R} w={w}",
                ops.pool_mlp_errors_features(pool, xd, y),
                plain(pool, xd, y), stats)
    # a NaN row and an Inf row in the pool
    pool, xd, y = make_case(2, 8, 20, 3, seed=4)
    pool = dict(pool)
    pool["w0"] = pool["w0"].clone()
    pool["w0"][1] = torch.nan
    pool["b4"] = pool["b4"].clone()
    pool["b4"][5] = torch.inf
    got = ops.pool_mlp_errors_features(pool, xd, y)
    compare("poisoned rows 1 (NaN), 5 (Inf)", got, plain(pool, xd, y), stats)
    assert bool(torch.isposinf(got[:, [1, 5]]).all())
    # a NaN probe sample poisons its feature's whole row
    pool, xd, y = make_case(2, 6, 10, 3, seed=5)
    xd[1, 4, 0] = torch.nan
    got = ops.pool_mlp_errors_features(pool, xd, y)
    compare("NaN probe in feature 1", got, plain(pool, xd, y), stats)
    assert bool(torch.isposinf(got[1]).all()) and \
        bool(torch.isfinite(got[0]).all())
    # masked union pool: invalid rows and a poisoned row come back +inf
    pool, xd, y = make_case(2, 8, 10, 3, seed=6)
    pool = dict(pool)
    pool["w2"] = pool["w2"].clone()
    pool["w2"][2] = torch.nan
    valid = torch.tensor([True] * 6 + [False] * 2, device=DEV)
    got = ops.pool_mlp_errors_features_masked(pool, xd, y, valid)
    compare("masked, row 2 NaN, rows 6-7 invalid", got,
            plain(pool, xd, y, valid), stats)
    assert bool(torch.isposinf(got[:, [2, 6, 7]]).all())
    got = ops.pool_mlp_errors_shard(pool, xd, y, valid)
    compare("shard with valid mask", got, plain(pool, xd, y, valid), stats)
    return stats


class _Rounds(Callback):
    """Reads each client's federated rounds, nf and train size, and the
    fit's wall time (data preparation excluded)."""

    def on_fit_start(self, fed):
        self.t0 = time.perf_counter()

    def on_fit_end(self, fed, results):
        torch.cuda.synchronize()
        self.fit_s = time.perf_counter() - self.t0
        self.rounds = dict(fed.n_rounds)
        self.nf = {c.name: c.nf for c in fed.clients}
        self.train = {c.name: int(len(c.train[2])) for c in fed.clients}


class _Profile(Callback):
    """torch.profiler over the fit: device time by kernel."""

    def on_fit_start(self, fed):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def on_fit_end(self, fed, results):
        torch.cuda.synchronize()
        self.prof.stop()


class _SelCapture(Callback):
    """Keeps the fit's results (selections, rounds, histories)."""

    def on_fit_end(self, fed, results):
        self.results = results


def small_run_parity():
    """The port on the card (kernel scores) against the port on the CPU
    (plain scores) at a small size: identical selections, close values."""
    cfg = HFLConfig(epochs=2, mode="always", R=20, use_pool_kernel=True)
    out = {}
    for dev in ("cpu", "cuda"):
        cb = _SelCapture()
        res = train_hfl("metavision", 4, cfg, n_patients=8, n_events=200,
                        callbacks=[cb], device=dev)
        out[dev] = (res, cb.results)
    (rc, hc), (rg, hg) = out["cpu"], out["cuda"]
    for name in hc:
        assert hc[name]["selections"] == hg[name]["selections"], name
        assert hc[name]["rounds"] == hg[name]["rounds"] > 0, name
        np.testing.assert_allclose(hg[name]["val"], hc[name]["val"],
                                   rtol=1e-4)
    np.testing.assert_allclose(rg["test"], rc["test"], rtol=1e-4)
    print(f"  small run: selections identical on cuda and cpu "
          f"({sum(h['rounds'] for h in hc.values())} rounds), test MSE "
          f"{rg['test']:.4f} (cuda) vs {rc['test']:.4f} (cpu)", flush=True)


def main_path():
    cfg = HFLConfig(epochs=3, mode="always", use_pool_kernel=True)
    cb = _Rounds()
    K.launches = 0
    t0 = time.perf_counter()
    res = train_hfl("metavision", 4, cfg, callbacks=[cb], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launches
    scorings = sum(cb.rounds[n] * cb.nf[n] for n in cb.rounds)
    print(f"  train sizes {cb.train}, nf {cb.nf}, R {cfg.R}, "
          f"epochs {cfg.epochs}, mode {cfg.mode}", flush=True)
    print(f"  test MSE {res['test']:.4f}  valid MSE {res['valid']:.4f}  "
          f"source test MSE {res['source_test']:.4f} (raw units)", flush=True)
    print(f"  federated rounds {cb.rounds}  Eq.-7 scorings {scorings}  "
          f"pool_mlp launches {launches}", flush=True)
    print(f"  wall {wall:.2f} s, of which fit {cb.fit_s:.2f} s "
          f"({cb.fit_s / cfg.epochs:.3f} s per epoch)", flush=True)
    assert all(np.isfinite(res[k]) for k in ("valid", "test", "source_test"))
    assert launches > 0, "the main path launched no pool_mlp kernel"
    assert launches == scorings, (launches, scorings)
    return launches, {"wall_s": wall, "fit_s": cb.fit_s,
                      "epochs": cfg.epochs, "rounds": cb.rounds,
                      "train": cb.train, "test_mse": res["test"],
                      "valid_mse": res["valid"],
                      "source_test_mse": res["source_test"]}


def profile_epoch(fit_s_per_epoch):
    """One epoch of the main path under torch.profiler: device time by
    kernel, and the device's busy share of an unprofiled epoch's wall time
    (the profiler itself slows the host)."""
    from torch.autograd import DeviceType
    cb = _Profile()
    train_hfl("metavision", 4, HFLConfig(epochs=1, mode="always"),
              callbacks=[cb], device="cuda")
    rows = [(e.key, e.device_time_total, e.count)
            for e in cb.prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 1e3
    busy = device_ms / 1e3 / fit_s_per_epoch
    print(f"  device time {device_ms:.1f} ms per epoch over "
          f"{sum(r[2] for r in rows)} kernels; busy share of an unprofiled "
          f"epoch {busy:.4f}" if rows else
          "  the profiler saw no device time (not measured)", flush=True)
    for key, us, count in rows[:8]:
        print(f"    {us / 1e3:9.2f} ms  {count:7d} launches  {key[:80]}",
              flush=True)
    return {"device_ms_per_epoch": device_ms, "busy_share": busy,
            "kernel_launches_per_epoch": sum(r[2] for r in rows),
            "top": [{"kernel": k[:80], "ms": us / 1e3, "launches": c}
                    for k, us, c in rows[:8]]}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script needs an NVIDIA GPU")
    smi = nvidia_smi()
    print(f"== device: {smi}", flush=True)
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"== build: {sorted(libs)} in {build_s:.1f} s", flush=True)
    reports = {name: _build.build_report(name) for name in libs}
    for report in reports.values():
        print(report.strip(), flush=True)

    print("== kernel phase: pool_mlp against its plain version", flush=True)
    stats = kernel_phase()
    slice_t = timed_pair(1, 4, 50, 3, iters=100, plain_iters=20)
    scale_t = timed_pair(4, 512, 50, 3, iters=20, plain_iters=8)
    for tag, t in (("slice", slice_t), ("batched", scale_t)):
        print(f"  {tag}: kernel {t['ms'] * 1e3:.1f} us, plain "
              f"{t['plain_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})", flush=True)

    print("== small-run parity: cuda against cpu", flush=True)
    small_run_parity()

    print("== main path: train_hfl('metavision', 4, epochs=3, "
          "mode='always') on cuda", flush=True)
    launches, run = main_path()

    print("== profile: one epoch of the main path", flush=True)
    prof = profile_epoch(run["fit_s"] / run["epochs"])

    kernels = [{
        "name": "pool_mlp", "route": "cuda",
        "source": "src/repro_torch/csrc/pool_mlp.cu",
        "replaces": "src/repro/kernels/pool_mlp/kernel.py:74",
        "launches": launches,
        "max_abs_err": stats["max_abs_err"],
        "max_rel_err": stats["max_rel_err"],
        "ms": slice_t["ms"], "plain_ms": slice_t["plain_ms"],
        "bound_ms": slice_t["bound_ms"], "bound_by": slice_t["bound_by"],
        "library_ms": None,
        "build_s": build_s,
        "ptxas": ptxas_summary(reports["pool_mlp"]),
        "shape": slice_t["shape"],
        "at_batched_shape": scale_t,
        "main_path": run,
        "profile": prof,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
