"""With the timed path broken underneath, a run's ``correct`` comes out
false: a step that returns its state unchanged, half of a cluster's
members left out of its refit (its means taken over the rest), and an
answer altered where it is produced. (The cells run on one card, so
there is no exchange between cards to leave out; the stream engine
takes one beat at a time and averages over no batch.)"""

import functools

import pytest

from hdpgpc_torch.models import gplds
from hdpgpc_torch.models import stream_online as so
from hdpgpc_torch.ops import hmm as hmm_ops
from portbench.tests import tiny


def _broken_refit(monkeypatch, change):
    build = gplds.build_refit

    @functools.wraps(build)
    def broken(*a, **k):
        refit = build(*a, **k)

        def run(Y, resp, state):
            return change(refit, Y, resp, state)
        return run
    monkeypatch.setattr(gplds, "build_refit", broken)


def _unchanged(refit, Y, resp, state):
    return refit(Y, resp, state)._replace(state=state)


def _half(refit, Y, resp, state):
    resp = resp.clone()
    rows = resp.reshape(-1, resp.shape[-1])
    for r in rows:
        idx = (r > 0.99).nonzero().reshape(-1)
        r[idx[1::2]] = 0.0
    return refit(Y, resp, state)


def _altered_fb(monkeypatch):
    fb = hmm_ops.fb_hard_packed_idx

    def broken(packed):
        idx, pidx = fb(packed)
        idx = idx.clone()
        idx[idx.shape[0] // 2] = (idx[idx.shape[0] // 2] + 1) \
            % packed.shape[1]
        return idx, pidx
    monkeypatch.setattr(hmm_ops, "fb_hard_packed_idx", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_offline_fault_is_not_correct(monkeypatch, fault):
    if fault == "altered":
        _altered_fb(monkeypatch)
    else:
        _broken_refit(monkeypatch, {"unchanged": _unchanged,
                                    "half": _half}[fault])
    r = tiny.run(tiny.offline("float32"))
    assert not r["correct"], r["checks"]


def _broken_step(monkeypatch, change):
    build = so.build_stream_step

    @functools.wraps(build)
    def broken(*a, **k):
        step = build(*a, **k)

        def run(carry, y):
            return change(step, carry, y)
        run.fits, run.fit_seconds = 0, 0.0
        return run
    monkeypatch.setattr(so, "build_stream_step", broken)


def _stream_unchanged(step, carry, y):
    """The clusters' states come back as they went in (the bookkeeping
    moves on, so a first member is fitted once)."""
    new, out = step(carry, y)
    return new._replace(states=carry.states), out


def _stream_altered(step, carry, y):
    new, out = step(carry, y)
    return new, out._replace(uid=out.uid + 1)


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_stream_fault_is_not_correct(monkeypatch, fault):
    _broken_step(monkeypatch, {"unchanged": _stream_unchanged,
                               "altered": _stream_altered}[fault])
    r = tiny.run(tiny.stream("float32"))
    assert not r["correct"], r["checks"]
