"""The port's spans and counters (``utils.progress``: ``trace``, ``count``,
``set_tracing``, ``take``) around a small XENON-style binned profile on the
CPU: nothing recorded while tracing is off, the same numbers either way,
spans that nest under their call, counters that agree with the fits'
iteration counts and the straggler pass, and spans on the profiler's clock;
around a small unbinned profile, the event scoring's and centring's spans
and counters, which read nothing more of the device."""

import bisect

import numpy as np
import pytest
import torch

from blueice_tpu_torch.utils import progress, profile_to
from blueice_tpu_torch.parallel import BinnedToyStudy, UnbinnedToyStudy
from blueice_tpu_torch.examples.xenon_like import build_likelihood

from test_torch_profile_grid_map import (  # noqa: F401
    fresh_template_caches, one_torch_thread)

#: Every span name the binned profile path records
NAMES = {'study.profile', 'study.fit', 'study.profile_grid', 'study.stage',
         'study.gather', 'study.refine', 'newton.fit', 'newton.iter',
         'newton.select', 'newton.step', 'newton.polish', 'newton.solve',
         'newton.value', 'newton.vgh', 'newton.scatter', 'graph.cells',
         'graph.values', 'graph.chain', 'sync'}
TARGET = 'wimp_rate_multiplier'
N_TOYS = 12


@pytest.fixture(scope='module')
def lf():
    return build_likelihood('binned', n_cs1_bins=4, n_cs2_bins=3,
                            livetime_days=5.0)


@pytest.fixture
def tracing():
    """Tracing on for the test, off and emptied after it."""
    progress.take()
    progress.set_tracing(True)
    try:
        yield
    finally:
        progress.set_tracing(False)
        progress.take()


def profile(study, seed=3):
    return study.profile_ts(seed, N_TOYS, TARGET, 1.0)


def fits(spans):
    return [s for s in spans if s.name == 'newton.fit']


def test_nothing_is_recorded_while_tracing_is_off(lf):
    progress.take()
    profile(BinnedToyStudy(lf, device='cpu', max_iter=30))
    assert progress.take() == {'spans': [], 'counters': {}}


def test_tracing_changes_no_number(lf):
    study = BinnedToyStudy(lf, device='cpu', max_iter=30)
    off = profile(study)
    progress.set_tracing(True)
    try:
        on = profile(study)
    finally:
        progress.set_tracing(False)
    assert progress.take()['spans']
    assert np.array_equal(off[0], on[0])
    for a, b in zip(off[1:], on[1:]):
        assert np.array_equal(a.x, b.x)
        assert np.array_equal(a.max_ll, b.max_ll)
        assert np.array_equal(a.n_iter, b.n_iter)


def test_spans_nest_under_their_call(lf, tracing):
    study = BinnedToyStudy(lf, device='cpu', max_iter=30)
    profile(study, seed=3)
    profile(study, seed=4)
    spans = progress.take()['spans']
    assert {s.name for s in spans} <= NAMES
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ['study.profile'] * 2
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.call == i
            continue
        p = spans[s.parent]
        assert s.parent < i and s.call == p.call
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    stages = [s.attrs['fit'] for s in spans if s.name == 'study.stage']
    assert stages == ['free', 'cond'] * 2
    # each iteration's lane selection waits twice, on its two nonzero
    # calls; the Newton lanes' write-back once, on its host scalar, and the
    # polish lanes' not at all (a fill on the device); each fit once, on
    # its tables; each solve once, on its batched Cholesky factor and solve
    # (eight free parameters)
    waits = {'newton.select': ['sync', 'sync'], 'newton.solve': ['sync']}
    for i, s in enumerate(spans):
        kids = [k.name for k in spans if k.parent == i]
        if s.name in waits:
            assert kids == waits[s.name], s.name
        if s.name == 'newton.scatter':
            before = [k.name for k in spans[:i] if k.parent == s.parent][-1]
            assert kids == (['sync'] if before == 'newton.step' else []), \
                before
        if s.name == 'newton.fit':
            assert kids[0] == 'sync' and kids.count('sync') == 1
        if s.name == 'sync':
            assert not kids
            assert spans[s.parent].name in set(waits) | {
                'newton.scatter', 'newton.fit', 'study.gather',
                'study.refine'}


def test_counters_match_the_fits(lf, tracing):
    """Per fit: the stepped iterations are the largest lane count, the
    lanes stepped their sum (every stepped lane's count rises by one an
    iteration), the lanes started the batch."""
    study = BinnedToyStudy(lf, device='cpu', max_iter=30, two_stage=False)
    _, free, cond = profile(study)
    got = progress.take()
    spans, counters = got['spans'], got['counters']
    free_fit, cond_fit = fits(spans)
    for span, res in ((free_fit, free), (cond_fit, cond)):
        assert span.counts['newton.iterations'] == res.n_iter.max()
        assert span.counts['newton.lanes_stepped'] == res.n_iter.sum()
        assert span.counts['newton.lanes_started'] == N_TOYS
    assert counters['newton.iterations'] == free.n_iter.max() + \
        cond.n_iter.max()
    assert counters['newton.lanes_stepped'] == free.n_iter.sum() + \
        cond.n_iter.sum()
    assert counters['study.toys'] == N_TOYS
    assert counters.get('study.refit_toys', 0) == 0
    call = spans[0]
    assert call.name == 'study.profile' and call.counts == counters


def test_refit_toys_are_the_stragglers(lf, tracing):
    """``study.refit_toys`` counts the toys whose free or conditional
    stage-1 fit hit the cap, each once: a short cap makes some."""
    cap = 40
    stage1 = BinnedToyStudy(lf, device='cpu', max_iter=cap, two_stage=False)
    _, free1, cond1 = profile(stage1)
    stragglers = int(np.sum((free1.n_iter >= cap) | (cond1.n_iter >= cap)))
    assert 0 < stragglers < N_TOYS
    progress.take()
    profile(BinnedToyStudy(lf, device='cpu', max_iter=cap))
    got = progress.take()
    assert got['counters']['study.refit_toys'] == stragglers
    assert got['counters']['study.toys'] == N_TOYS
    refits = [s for s in got['spans'] if s.name == 'study.refine']
    assert len(refits) == 2
    for span in refits:
        assert span.counts['newton.lanes_started'] == stragglers


def test_spans_share_the_profilers_clock(lf, tracing, tmp_path):
    """Under ``profile_to`` each recorded span lies inside the latest
    ``record_function`` event of its name that starts before it, and 99%
    of them start within 50 us of that event: the profiler's own enter sits
    between the two stamps (a warm call first takes its start-up)."""
    study = BinnedToyStudy(lf, device='cpu', max_iter=30)
    with profile_to(str(tmp_path)) as prof:
        profile(study)
        progress.take()
        profile(study)
    spans = progress.take()['spans']
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in NAMES:
            events.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    assert spans
    for evs in events.values():
        evs.sort()
    starts = {name: [e[0] for e in evs] for name, evs in events.items()}
    lags = []
    for s in spans:
        k = bisect.bisect_right(starts[s.name], s.start_ns + 5_000) - 1
        assert k >= 0, s.name
        start, end = events[s.name][k]
        assert s.end_ns <= end + 5_000, s.name
        lags.append(s.start_ns - start)
    assert np.mean(np.asarray(lags) <= 50_000) >= 0.99


def test_trace_is_a_shared_no_op_while_off():
    progress.set_tracing(False)
    assert progress.trace('a') is progress.trace('b', fit='free')
    with progress.trace('newton.iter'):
        progress.count('newton.iterations')
    assert progress.take() == {'spans': [], 'counters': {}}


@pytest.fixture(scope='module')
def unbinned_lf():
    """The XENON-style likelihood as an extended unbinned one over 4 x 3
    bins, 0.1 live days (about 60 events a toy)."""
    return build_likelihood('unbinned', n_cs1_bins=4, n_cs2_bins=3,
                            livetime_days=0.1)


def test_unbinned_profile_records_scoring_and_centring(unbinned_lf, tracing):
    """Each event set's fit data are made once in a profile, before its
    ``study.profile`` call: one ``study.score`` and one ``study.center``
    span, scoring before centring, neither waiting on the device (no
    ``sync`` inside); ``study.scored_toys`` counts the toys and
    ``study.event_slots`` their padded event slots, B x n_max, inside the
    scoring's span."""
    study = UnbinnedToyStudy(unbinned_lf, device='cpu', max_iter=30)
    study.profile_ts(3, N_TOYS, TARGET, 1.0)
    study.profile_ts(4, N_TOYS, TARGET, 1.0)
    got = progress.take()
    spans, counters = got['spans'], got['counters']
    roots = [spans[i] for i, s in enumerate(spans) if s.parent is None]
    assert [s.name for s in roots] == [
        'study.score', 'study.center', 'study.profile'] * 2
    for i, s in enumerate(spans):
        if s.name in ('study.score', 'study.center'):
            assert not [k for k in spans if k.parent == i]
    assert counters['study.scored_toys'] == 2 * N_TOYS
    assert counters['study.event_slots'] == 2 * N_TOYS * study.n_max
    for s in roots:
        if s.name == 'study.score':
            assert s.counts == {'study.scored_toys': N_TOYS,
                                'study.event_slots': N_TOYS * study.n_max}
        else:
            assert 'study.scored_toys' not in s.counts


#: The tensor methods that read a value back to the host
HOST_READS = ('item', 'tolist', 'cpu', 'numpy', '__int__', '__float__',
              '__bool__', '__index__')


@pytest.mark.parametrize('on', [False, True], ids=['off', 'on'])
def test_unbinned_spans_read_nothing_of_the_device(unbinned_lf, monkeypatch,
                                                  on):
    """The scoring's and centring's spans and counters add no host read
    of a tensor (on the card, each would wait for the device), with
    tracing off or on: an event set's fit data are made with the same reads
    back, and the same data, as scoring and centring without them; with
    tracing off nothing is recorded."""
    from blueice_tpu_torch.parallel.fitter import unbinned_center
    study = UnbinnedToyStudy(unbinned_lf, device='cpu', max_iter=30)
    events = study.simulate(5, N_TOYS)
    coords, mask, bins = events
    reads = []

    def counted(make):
        reads.clear()
        with monkeypatch.context() as patch:
            for name in HOST_READS:
                def read(self, *args, _name=name,
                         _original=getattr(torch.Tensor, name), **kwargs):
                    reads.append(_name)
                    return _original(self, *args, **kwargs)
                patch.setattr(torch.Tensor, name, read)
            out = make()
        return list(reads), out

    def plain():
        ps = study.score_events(coords, bins)
        return ps, mask, unbinned_center(study.compiled, ps, mask)

    progress.take()
    progress.set_tracing(on)
    try:
        spanned, data = counted(lambda: study._fit_data(events))
    finally:
        progress.set_tracing(False)
    got = progress.take()
    without, data0 = counted(plain)
    assert spanned == without
    assert torch.equal(data[0], data0[0]) and torch.equal(data[1], data0[1])
    for a, b in zip(data[2], data0[2]):
        assert torch.equal(a, b)
    if on:
        assert [s.name for s in got['spans']] == ['study.score',
                                                  'study.center']
        assert got['counters'] == {'study.scored_toys': N_TOYS,
                                   'study.event_slots': N_TOYS * study.n_max}
    else:
        assert got == {'spans': [], 'counters': {}}
