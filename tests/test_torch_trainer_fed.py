"""``chip_smoke.py``'s trainer part (c) machinery on the CPU: a Trainer run
with the codebook map and the two-timescale controller is recorded
(``DecisionRecorder``: the codes and the global tier's signature bits;
``KmeansProbe``), then run again from the same seed fed the record's
decisions and farthest-point picks (``DecisionFeeder``, ``KmeansProbe`` with
the record): on one CPU thread it reproduces the recorded losses, installs
and centroids bit for bit, with none of its own decisions or picks
differing; a fed stream of another shape, or one that runs out, fails the
run.  (On the card the fed run is the CPU's, the record the card's.)"""

import sys
import tempfile
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
STEPS, T_CP = 10, 5  # reclusters at steps 5 and 10


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke


@pytest.fixture(autouse=True)
def _one_thread():
    # CPU reductions over threads may sum in another order run to run
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(c, mode, walks, shared, calls=None, seq=64):
    """One controller run on the CPU: ``mode`` "record" keeps its codes,
    reservoirs and k-means; "feed" clusters the recorded reservoirs and takes
    the recorded codes and picks.  Returns (losses, history, centroids, the
    recorder or feeder)."""
    from repro_torch.core.two_timescale import TwoTimescaleConfig

    with tempfile.TemporaryDirectory() as tmp:
        tr = c.trainer_for(c.codebook_arch(), tmp, STEPS, device="cpu", batch=2, seq=seq,
                           two_timescale=TwoTimescaleConfig(t_cp_steps=T_CP))
        real = tr.controller.maybe_recluster
        probe = c.KmeansProbe(walks[mode], card=walks["record"] if mode == "feed" else None)

        def recluster(step, *a, **k):
            if mode == "record":
                shared[step] = list(tr.controller._reservoir)
            else:
                tr.controller._reservoir = list(shared[step])
            probe.step = step
            return real(step, *a, **k)

        tr.controller.maybe_recluster = recluster
        with (c.DecisionRecorder() if mode == "record" else c.DecisionFeeder(calls)) as codes, \
                probe:
            out = tr.run()
    cent = tr.params["blocks"]["b0"]["attn"]["chimera"]["fm"]["centroids"]
    return c.logged_losses(mode, out), tr.controller.history, cent, codes


def test_a_run_fed_its_own_codes_and_picks_reproduces_it(chip_smoke):
    walks, shared = {"record": {}, "feed": {}}, {}
    want = _run(chip_smoke, "record", walks, shared)
    got = _run(chip_smoke, "feed", walks, shared, calls=want[3].calls)
    assert got[0] == want[0]
    assert [(r.step, r.installed, r.delta_map) for r in got[1]] == [
        (r.step, r.installed, r.delta_map) for r in want[1]]
    assert torch.equal(got[2], want[2])
    fed, calls = got[3], want[3].calls
    assert fed.done == {k: len(v) for k, v in calls.items()}
    assert min(fed.done.values()) > 0 and set(fed.differ.values()) == {0}
    assert sorted(walks["feed"]) == sorted(walks["record"]) == [T_CP, STEPS]
    assert all(e["differ"] == 0 and e["first"] is None and e["err"] == 0.0
               for e in walks["feed"].values())
    assert {k: v[1:] for k, v in chip_smoke.count_flips(calls).items()} == {
        "codes": (0, 0), "signatures": (0, 0)}


@pytest.mark.parametrize("how", ["shape", "short"])
def test_a_fed_stream_that_does_not_fit_the_run_fails(chip_smoke, how):
    walks, shared = {"record": {}, "feed": {}}, {}
    calls = _run(chip_smoke, "record", walks, shared, seq=64 if how == "short" else 128)[3].calls
    if how == "short":
        calls = dict(calls, codes=calls["codes"][:len(calls["codes"]) // 2])
    with pytest.raises(SystemExit):
        _run(chip_smoke, "feed", walks, shared, calls=calls)
