"""The binned cells read the same through the likelihood-kind interface as
they did when the harness drove binned likelihoods alone: the same datasets,
bit for bit, and the same check numbers from the same program results. The
values below were recorded on the harness before the interface, on the
CPU, with the same seeds, rows and results."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark.harness import check, ensemble, runner

SEED = 2 ** 40 + 21
#: sha256 of the datasets' bytes, their shape and type, by (cell, call);
#: ``xenon.ensemble`` at 64 toys a call (its float32 datasets), the tiny
#: cell at its own 12
DATASETS = {
    ('tiny.tiny_mix', 0): (
        '22566a19e1467c2873a558cf372d7cddca3f1149cd76df935c08c0b8c07f1aae',
        (12, 8, 10), torch.float64),
    ('tiny.tiny_mix', 1): (
        'fe991efaa8f601b4e12c9dc681e3664050cc1e7c49f531a94f11afefad651c18',
        (12, 8, 10), torch.float64),
    ('tiny.tiny_mix', ensemble.WARM_CALL): (
        '8c48834cb6f2425602933a78732e4b8739a56f7132abc90b2c56713d8f890bc5',
        (12, 8, 10), torch.float64),
    ('xenon.ensemble', 0): (
        '3a44991727f0d1f1a5bb27968fc0d0baf1799bdedc407df1124a6138ad68e868',
        (64, 50, 62), torch.float32),
    ('xenon.ensemble', 1): (
        '337caca5547d9878745337d99761b578db183e5a47af515a9214c5f8a1117b0b',
        (64, 50, 62), torch.float32),
    ('xenon.ensemble', ensemble.WARM_CALL): (
        '5dc5604058f33477f7a6353f15263ae9fea01356787f99fdec439ee990bb66d2',
        (64, 50, 62), torch.float32),
}
#: The judged rows of call 0, and the check's numbers on them
ROWS = [0, 3, 5, 7, 10]
NUMBERS = {
    'tiny.tiny_mix': {'ll_eval_gap': 0.0020004165463376467,
                      't_eval_gap': 0.004537174970053404,
                      'll_fit_gap': 0.0015068762183716444,
                      'short_fit_share': 0.4},
    'tiny_bb.tiny_mix': {'ll_eval_gap': 0.0020004165463376467,
                         't_eval_gap': 0.004537174970053404,
                         'll_fit_gap': 0.0011064776302873724,
                         'short_fit_share': 0.4},
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ensemble(checkout, cell):
    if cell == 'tiny.tiny_mix':
        return runner.prepare(cell, 'cpu', root=str(checkout)).ensemble(SEED)
    cx = runner.prepare(cell, 'cpu')
    traffic = dict(cx.traffic, toys_per_call=64)
    return ensemble.Ensemble(traffic, cx.kind.reference.sampler(
        cx.model, cx.truth, 64, 'cpu', cx.dtype), SEED, 'cpu')


@pytest.mark.parametrize('cell, call', sorted(DATASETS, key=str),
                         ids=lambda v: str(v))
def test_datasets_are_bit_identical(checkout, one_thread, cell, call):
    digest, shape, dtype = DATASETS[cell, call]
    data = _ensemble(checkout, cell).datasets(call)
    assert tuple(data.shape) == shape and data.dtype == dtype
    assert hashlib.sha256(data.numpy().tobytes()).hexdigest() == digest


def fixed_prog(model, fits, data, target, hypothesis):
    """A fixed set of program results on the toys ``data``: the reference's
    own fits (``fits``, its ``profile_fits``), every toy's rates moved a
    little off them and every third toy's more, the values a little off
    the reference's at the points."""
    ref = fits(model, data, target, hypothesis)
    T = data.shape[0]
    rng = np.random.default_rng(7)
    x_free, x_cond = ref['x_free'].copy(), ref['x_cond'].copy()
    for x in (x_free, x_cond):
        x[:, :model.R] *= 1 + 1e-4 * rng.standard_normal((T, model.R))
        x[1::3, :model.R] *= 1 + 2e-3 * rng.standard_normal(
            (len(x[1::3]), model.R))
    x_cond[:, model.names.index(target)] = hypothesis
    off = 1e-3 * rng.standard_normal((2, T))
    ll_free = model.loglik_at(x_free, data) + off[0]
    ll_cond = model.loglik_at(x_cond, data) + off[1]
    t = np.maximum(2 * (ll_free - ll_cond), 0) + 1e-4 * rng.random(T)
    return dict(x_free=x_free, x_cond=x_cond, ll_free=ll_free,
                ll_cond=ll_cond, t=t)


@pytest.mark.parametrize('cell', sorted(NUMBERS))
def test_judge_gives_the_same_numbers(checkout, one_thread, cell):
    cx = runner.prepare(cell, 'cpu', root=str(checkout))
    reference = cx.kind.reference
    data = reference.take(cx.ensemble(SEED).datasets(0), ROWS)
    prog = fixed_prog(cx.model, reference.profile_fits, data, cx.target,
                      cx.hypothesis)
    numbers = check.judge(reference, cx.model, data, prog, cx.target,
                          cx.hypothesis)[0]
    assert numbers == NUMBERS[cell]


def test_a_missing_kind_is_named(checkout):
    with pytest.raises(KeyError, match='benchmark/reference/unknown.py'):
        runner.load_kind('unknown', root=str(checkout))
