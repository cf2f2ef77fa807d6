"""The judge sees a broken timed path: each fault below is planted under
a run at a size the CPU holds (the harness's look for a card skipped),
and the run must come out not correct.  And its control: the plain
reference in the program's place, computed with TF32's operands, fails
the numbers that the program's own answers pass, and so comes out not
correct by the verdict a run applies."""

from __future__ import annotations

import pytest
import torch

from bench import run
from bench.tests.tiny import make_root

SEED = 2_718_281_828


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _wrap_search(monkeypatch, change):
    import repro_torch.core.runtime as rt_mod

    real = rt_mod.resolve_search_impl

    def resolve(cfg, path, rerank=False):
        impl = real(cfg, path, rerank)

        def broken(*a, **kw):
            d, i = impl(*a, **kw)
            return change(d.clone(), i.clone())

        return broken

    monkeypatch.setattr(rt_mod, "resolve_search_impl", resolve)


def _altered_answer(d, i):
    # each query's nearest answer names another row
    i[:, 0] = torch.where(i[:, 0] >= 0, (i[:, 0] + 7) % 4000, i[:, 0])
    return d, i


def _half_left_out(d, i):
    half = d.shape[0] // 2
    d[half:] = float("inf")
    i[half:] = -1
    return d, i


@pytest.mark.parametrize("cell", ["tiny.flat", "tiny.pq"])
@pytest.mark.parametrize("fault", [_altered_answer, _half_left_out],
                         ids=["answer_altered", "half_of_batch_left_out"])
def test_broken_search_is_not_correct(root, cell, fault, monkeypatch):
    _wrap_search(monkeypatch, fault)
    res = run.run_cell(root, cell, SEED, 1.0, False, device="cpu")
    assert res["correct"] is False
    assert res["checks"]["bad_ids"]["value"] + res["checks"]["dist_err"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny.flat", "tiny.pq"])
def test_insert_acked_but_state_unchanged_is_not_correct(root, cell, monkeypatch):
    import repro_torch.core.runtime as rt_mod

    monkeypatch.setattr(rt_mod, "insert_payload",
                        lambda cfg, state, *a, fence=None, **kw: fence and fence())
    res = run.run_cell(root, cell, SEED, 1.0, False, device="cpu")
    assert res["correct"] is False
    assert res["checks"]["insert_missed"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny.flat", "tiny.pq"])
def test_insert_acked_before_it_is_applied_is_not_correct(root, cell, monkeypatch):
    # each insert run acks its rows but writes them only with the next run
    import repro_torch.core.runtime as rt_mod

    real, held = rt_mod.insert_payload, []

    def one_run_late(cfg, state, *args, fence=None):
        if fence is not None:
            fence()
        late = held[:]
        held[:] = [tuple(a.clone() if a is not None else None for a in args)]
        for prev in late:
            real(cfg, state, *prev)
        return state

    monkeypatch.setattr(rt_mod, "insert_payload", one_run_late)
    res = run.run_cell(root, cell, SEED, 1.0, False, device="cpu")
    assert res["correct"] is False
    assert res["checks"]["insert_missed"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny.flat", "tiny.search"])
def test_centroids_left_at_their_init_are_not_correct(root, cell, monkeypatch):
    import repro_torch.core.ivf as ivf_mod

    real = ivf_mod.kmeans
    monkeypatch.setattr(ivf_mod, "kmeans",
                        lambda x, n, n_iter=20, **kw: real(x, n, n_iter=0, **kw))
    res = run.run_cell(root, cell, SEED, 1.0, False, device="cpu")
    assert res["correct"] is False
    km = res["checks"]["kmeans_excess"]
    assert km["value"] > km["limit"]


@pytest.mark.parametrize("cell", ["tiny.flat", "tiny.pq", "tiny.search"])
def test_control_fails_where_the_program_passes(root, cell):
    res = run.run_cell(root, cell, SEED + 1, 1.0, False, device="cpu", control=True)
    assert res["correct"] is True
    assert run.within(res["control"]) is False, res["control"]
