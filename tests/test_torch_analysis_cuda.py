"""The static analysis held to the card (marker: cuda; skipped without
one).  This file imports no jax: the card's machine has none.

* ptxas's report of every kernel the port builds parses, each
  instantiation places a block on an SM, and no instantiation spills;
* every program of the op audit, run once on a card index at the audit
  geometry, makes exactly the host syncs the audit's inventory pins (plus
  one for a search's result readback).

Run on a machine with one card:

    PYTHONPATH=src python -m pytest -q -s -m cuda \\
        tests/test_torch_analysis_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.analysis import op_audit, smem

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def test_ptxas_budgets_place_every_kernel(card):
    from repro_torch.kernels import build

    build.build()
    rows = []
    for name in build.sources():
        rows += smem.ptxas_rows(name, build.build_log(name))
    assert rows
    budgets = smem.card_budgets(rows)
    for b in budgets:
        print("[ptxas-budget]", json.dumps(b))
    assert smem.spill_findings(budgets) == []
    for b in budgets:
        assert min(b["blocks_by_smem"], b["blocks_by_regs"]) >= 1, b


@pytest.mark.parametrize("payload", op_audit.PAYLOAD_CONFIGS)
def test_card_syncs_match_the_inventory(card, payload):
    cfg, state, pq, queries, vecs, ids = op_audit._populated(payload,
                                                             op_audit.GEOM)
    to = lambda t: None if t is None else t.to(card)  # noqa: E731
    state = op_audit.clone_state(state)
    for f in state.__dataclass_fields__:
        setattr(state, f, getattr(state, f).to(card))
    if pq is not None:
        pq = type(pq)(codebooks=to(pq.codebooks))
    cases, _ = op_audit.programs(payload, cfg, state, pq, to(queries),
                                 to(vecs), to(ids), to(ids + 100_000))
    moved = {}
    for case in cases:
        n, sites = op_audit.card_syncs(case)
        want = op_audit.EXPECTED_SYNCS[case.name] + (case.kind == "search")
        print("[card-syncs]", case.name, n, want, sites)
        if n != want:
            moved[case.name] = (want, n, sites)
    assert not moved, moved
    assert np.isfinite(float(state.centroids.sum()))
