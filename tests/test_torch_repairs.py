"""Repairs of three faults of the port (ROADMAP §3, faults 1, 5 and 6).

* The launcher's pool: ``launch/serve.py`` sizes the pool to hold every
  list at full scale (the configs' own pools drop rows there; ``chip_smoke.py``
  uses the same sizing) and refuses a build that dropped rows.
* ``serial`` mode takes every queued mutation each loop turn (the
  reference takes one), so its acks stay bounded when a turn slows.
* ``chip_smoke.py``'s runtime runs fail on a profiled window that is not
  positive.
"""

import importlib.util
import os
import sys
import threading
import time
from unittest import mock

import numpy as np
import pytest

from repro_torch.configs.anns import ivfflat_sift1m, ivfpq_dssm40m
from repro_torch.core.faults import FaultPlan
from repro_torch.core.ivf import build_ivf
from repro_torch.core.runtime import RuntimeConfig, ServingRuntime
from repro_torch.launch import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 30.0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ------------------------------------------------------------- fault 1 ----
@pytest.mark.parametrize("make,blocks", [(ivfflat_sift1m, 5969),
                                         (ivfpq_dssm40m, 238_141)])
def test_launcher_default_pool_holds_full_scale(make, blocks):
    # chip_smoke.py sizes its pools with this same function
    cfg = make(1.0)
    assert serve.default_pool_blocks(cfg) == blocks
    # the config's own pool is the smaller one that dropped rows
    assert cfg.pool_config().n_blocks < blocks


def test_launcher_builds_without_dropping_rows(capsys):
    argv = ["serve", "--index", "ivfflat_sift1m", "--scale", "0.01",
            "--device", "cpu", "--mode", "fused", "--duration", "0.3",
            "--qps-search", "20", "--qps-insert", "20"]
    with mock.patch.object(sys, "argv", argv):
        serve.main()
    out = capsys.readouterr().out
    assert "dropped=0" in out


def test_launcher_refuses_a_pool_that_drops_rows():
    argv = ["serve", "--index", "ivfflat_sift1m", "--scale", "0.002",
            "--device", "cpu", "--pool-blocks", "20", "--duration", "0.1"]
    with mock.patch.object(sys, "argv", argv):
        with pytest.raises(AssertionError, match="dropped"):
            serve.main()


# ------------------------------------------------------------- fault 5 ----
def _data(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, 16)).astype(np.float32)


def _index():
    return build_ivf(_data(600, 0), n_clusters=4, block_size=16,
                     max_chain=64, capacity_vectors=8000, device="cpu")


class _Parked(FaultPlan):
    """Parks the search loop at its first turn until ``release()``."""

    def __init__(self):
        super().__init__()
        self._go = threading.Event()

    def release(self):
        self._go.set()

    def check(self, site):
        if site == "search_loop" and self.calls(site) == 0:
            assert self._go.wait(WAIT), "parked too long"
        super().check(site)


def test_serial_turn_drains_every_queued_mutation():
    plan = _Parked()
    rt = ServingRuntime(_index(), RuntimeConfig(mode="serial", flush_min=1),
                        faults=plan)
    batches = []
    apply = rt._apply_mutations
    rt._apply_mutations = lambda items: (batches.append(len(items)),
                                         apply(items))
    try:
        futs = [rt.submit_insert(_data(2, 10 + i)) for i in range(30)]
        futs.append(rt.submit_delete(np.arange(5, dtype=np.int32)))
        plan.release()
        for f in futs:
            f.result(timeout=WAIT)
    finally:
        rt.stop()
    assert batches[0] == 31, batches  # one turn took all of them


def test_serial_acks_stay_bounded_when_turns_slow():
    """Each loop turn sleeps 0.2 s: taking one item a turn, the last of 25
    queued inserts would wait 25 turns (5 s); draining, about one."""
    delay = 0.2
    plan = FaultPlan().delay("search_loop", delay)
    rt = ServingRuntime(_index(), RuntimeConfig(mode="serial", flush_min=1),
                        faults=plan)
    try:
        time.sleep(delay)  # into the loop's rhythm
        t0 = time.perf_counter()
        futs = [rt.submit_insert(_data(2, 50 + i)) for i in range(25)]
        for f in futs:
            f.result(timeout=WAIT)
        waited = time.perf_counter() - t0
    finally:
        rt.stop()
    assert waited < 10 * delay, waited
    stats = rt.stats()
    assert stats["inserts"] == 50


# ------------------------------------------------------------- fault 6 ----
def test_profiled_window_must_be_positive():
    cs = _chip_smoke()
    assert cs.profiled_window_ms(10.0, 11.0, "t") == pytest.approx(1000.0)
    for t_start in (11.0, 12.5):  # the profiler started at or past the end
        with pytest.raises(RuntimeError, match="not positive"):
            cs.profiled_window_ms(t_start, 11.0, "t")
