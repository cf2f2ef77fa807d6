"""Recall and latency metrics used across benchmarks (paper §4)."""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Iterable, Optional

import numpy as np


class CounterSet:
    """Named monotonic counters shared across threads.

    The serving runtime's workers, submit paths, and the supervisor all
    bump counters concurrently; bare ``+=`` on instance ints loses
    increments under the GIL's byte-code interleaving (load/add/store is
    three ops).  Every mutation happens under one lock and ``snapshot()``
    returns a consistent point-in-time copy for ``stats()``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: collections.defaultdict = collections.defaultdict(int)

    def inc(self, name: str, n: int = 1) -> int:
        with self._lock:
            self._counts[name] += n
            return self._counts[name]

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


def percentile_summary(samples_s: Iterable[float]) -> dict:
    """p50/p95/p99/mean/max milliseconds over seconds-valued samples.

    The one shared percentile computation: ``LatencyStats``, the runtime's
    ``stats()`` output, and the open-loop load generator
    (``benchmarks/loadgen.py``) all report through it, so their numbers can
    never disagree on interpolation or unit conventions."""
    ms = np.asarray(list(samples_s), np.float64) * 1e3
    if ms.size == 0:
        return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0,
                "mean_ms": 0.0, "max_ms": 0.0, "n": 0}
    return {
        "p50_ms": float(np.percentile(ms, 50)),
        "p95_ms": float(np.percentile(ms, 95)),
        "p99_ms": float(np.percentile(ms, 99)),
        "mean_ms": float(ms.mean()),
        "max_ms": float(ms.max()),
        "n": int(ms.size),
    }


class ArrivalEstimator:
    """Lock-disciplined EWMA tracker for one serving lane.

    Tracks three signals the adaptive controller (and the degradation
    ladder, which receives the very same queue-age observations — the
    estimator stores the signal, it does not duplicate the ladder's
    hysteresis) needs:

    * **arrival rate** — exponentially-weighted event counting: a weight
      ``W`` decays as ``exp(-dt / tau)`` and each arrival batch adds its
      event count, so ``rate = W / tau`` converges to the true arrival
      rate for steady traffic and decays toward zero in silence.  Reads
      apply the decay since the last arrival, so a stale estimate never
      reports a burst that ended seconds ago.
    * **queue-age watermark** — the age of the oldest item in each
      dispatched batch (how far behind the lane runs), EWMA-smoothed over
      dispatches with the same time constant.
    * **service time** — EWMA seconds per dispatch, the lane's measured
      cost, which turns the arrival rate into a load factor
      (``rho = rate * service / batch``).

    All fields move under one lock; ``observe_*`` accept an explicit
    ``now`` so unit tests are deterministic wall-clock-free.
    """

    def __init__(self, tau_s: float = 0.5):
        if tau_s <= 0:
            raise ValueError(f"tau_s must be positive, got {tau_s}")
        self.tau_s = tau_s
        self._lock = threading.Lock()
        self._weight = 0.0  # guarded-by: _lock (decayed event count)
        self._t_last: Optional[float] = None  # guarded-by: _lock
        self._age = 0.0  # guarded-by: _lock (queue-age watermark EWMA)
        self._service: Optional[float] = None  # guarded-by: _lock
        self._events = 0  # guarded-by: _lock (lifetime arrivals)

    def observe_arrival(self, n: int = 1,
                        now: Optional[float] = None) -> None:
        """Record ``n`` arrivals (rows for the mutation lane, requests for
        the search lane) at ``now``."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._t_last is not None:
                dt = max(0.0, now - self._t_last)
                self._weight *= math.exp(-dt / self.tau_s)
            self._weight += n
            self._t_last = now
            self._events += n

    def observe_queue_age(self, age_s: float,
                          now: Optional[float] = None) -> None:
        """Record one dispatch's queue-age watermark (seconds)."""
        with self._lock:
            # dispatches are already paced by the lane; a plain EWMA over
            # observations keeps the smoothing timing-independent
            self._age += 0.3 * (max(0.0, age_s) - self._age)

    def observe_service(self, service_s: float) -> None:
        """Record one dispatch's measured service seconds."""
        with self._lock:
            if self._service is None:
                self._service = service_s
            else:
                self._service += 0.3 * (service_s - self._service)

    def rate(self, now: Optional[float] = None) -> float:
        """Decayed arrivals/second estimate."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._t_last is None:
                return 0.0
            dt = max(0.0, now - self._t_last)
            return self._weight * math.exp(-dt / self.tau_s) / self.tau_s

    def queue_age(self) -> float:
        with self._lock:
            return self._age

    def service(self, default: float = 0.0) -> float:
        with self._lock:
            return self._service if self._service is not None else default

    def reset(self) -> None:
        """Forget every learned signal (rate, queue age, service EWMA,
        lifetime arrivals).  ``ServingRuntime.reset_stats()`` calls this
        between benchmark phases so one cell's learned load cannot bleed
        into the next cell's controller decisions; the first few
        post-reset dispatches re-learn service (EWMA seeds on the first
        sample)."""
        with self._lock:
            self._weight = 0.0
            self._t_last = None
            self._age = 0.0
            self._service = None
            self._events = 0

    def snapshot(self, now: Optional[float] = None) -> dict:
        """One consistent read of every signal (for ``stats()``)."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._t_last is None:
                rate = 0.0
            else:
                rate = self._weight * math.exp(
                    -max(0.0, now - self._t_last) / self.tau_s
                ) / self.tau_s
            return {
                "rate": rate,
                "queue_age_s": self._age,
                "service_s": self._service or 0.0,
                "events": self._events,
            }


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray, k: int) -> float:
    """Mean |found ∩ true| / k over queries (ids = -1 ignored)."""
    found = np.asarray(found_ids)[:, :k]
    true = np.asarray(true_ids)[:, :k]
    hits = 0
    for f, t in zip(found, true):
        hits += len(set(int(i) for i in f if i >= 0) & set(int(i) for i in t))
    return hits / (found.shape[0] * k)


@dataclasses.dataclass
class LatencyStats:
    mean_ms: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    n: int
    timeouts: int = 0

    @classmethod
    def from_samples(cls, samples_s: Iterable[float], timeout_ms: float = None):
        samples = list(samples_s)
        p = percentile_summary(samples)
        ms = np.asarray(samples, np.float64) * 1e3
        timeouts = int((ms > timeout_ms).sum()) if timeout_ms and ms.size \
            else 0
        return cls(
            mean_ms=p["mean_ms"], p50_ms=p["p50_ms"], p95_ms=p["p95_ms"],
            p99_ms=p["p99_ms"], max_ms=p["max_ms"], n=p["n"],
            timeouts=timeouts,
        )

    def as_dict(self) -> dict:
        """JSON-ready percentile summary (same keys as
        ``percentile_summary``) — benchmarks and the ops runbook consume
        this instead of post-processing raw latency windows by hand."""
        return {
            "p50_ms": self.p50_ms, "p95_ms": self.p95_ms,
            "p99_ms": self.p99_ms, "mean_ms": self.mean_ms,
            "max_ms": self.max_ms, "n": self.n, "timeouts": self.timeouts,
        }

    def row(self) -> str:
        return (
            f"mean={self.mean_ms:7.2f}ms p50={self.p50_ms:7.2f} "
            f"p95={self.p95_ms:7.2f} p99={self.p99_ms:7.2f} "
            f"max={self.max_ms:7.2f} n={self.n} timeouts={self.timeouts}"
        )


class Timer:
    """Context timer returning seconds."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
