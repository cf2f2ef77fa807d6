"""Seeds and schedules of a run: numpy only, so that the load generator's
process imports neither torch nor the program."""

from __future__ import annotations

import numpy as np


def seed_of(*parts: int) -> int:
    """A 63-bit generator seed from whole numbers of any sign and size."""
    ss = np.random.SeedSequence([int(p) % (1 << 64) for p in parts])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def arrival_gaps(n: int, rate: float, seed: int) -> np.ndarray:
    """``n`` gaps of a Poisson stream at ``rate`` a second: the
    exponential distribution's quantiles at (i + 0.5) / n, in an order
    drawn from the seed.  Every seed gets the same set of gaps, so seeds
    change the order of arrivals and not the load."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return np.random.default_rng(seed_of(seed, 7)).permutation(gaps)


def arrivals(rate: float, lead: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival times, from the lead-in's start, of a Poisson stream at
    ``rate`` a second: ``round(rate * lead)`` of them in the lead-in and
    ``round(rate * seconds)`` in the window.  Each part's gaps are the
    set of ``arrival_gaps``, one more than its arrivals, scaled to span
    the part exactly, in an order drawn from the seed: every seed sends
    the same number of inserts in the window, at the same set of gaps."""
    out, start = [], 0.0
    for part, span in enumerate((lead, seconds)):
        n = int(round(rate * span))
        if n:
            gaps = arrival_gaps(n + 1, rate, seed_of(seed, part))
            out.append(start + span * gaps.cumsum()[:-1] / gaps.sum())
        start += span
    return np.concatenate(out) if out else np.zeros(0)


def client_orders(clients: int, batches: int, length: int, seed: int):
    """For each closed-loop client, the query-bank batches it sends in
    turn: ``length`` of them, through a permutation drawn from the seed,
    each client starting at its own offset."""
    perm = np.random.default_rng(seed_of(seed, 11)).permutation(batches)
    return [np.resize(np.roll(perm, -(c * batches // clients)), length)
            for c in range(clients)]
