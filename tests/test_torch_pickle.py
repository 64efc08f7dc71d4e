"""Pickle round trips of the port's prepared likelihoods, twins of
``tests/test_pickle.py``, float64 on the CPU.

The host interpolators are closures over (morpher, tensor) payloads kept in
``lf._builds``: they are dropped on dump and rebuilt on load, so the stdlib
pickle works whenever the user's config pickles. Each restored value equals
the original's and the JAX package's on the same templates (both packages'
Monte-Carlo templates drawn from one reset numpy state) and the same data.
The device cache of ``compile.cached_logl`` stays out of the pickle.
"""

import pickle

import numpy as np
import pytest

from blueice_tpu import test_helpers as jhelpers
from blueice_tpu import likelihood as jlik
from blueice_tpu import composition as jcomp
from blueice_tpu_torch import test_helpers as thelpers
from blueice_tpu_torch import likelihood as tlik
from blueice_tpu_torch import composition as tcomp
from blueice_tpu_torch.compile import cached_logl
from blueice_tpu_torch.parallel import BinnedToyStudy
from blueice_tpu_torch.utils.io import read_pickle, save_pickle

from test_torch_profile_grid_map import (  # noqa: F401
    fresh_template_caches, one_torch_thread)

KW = dict(s0_rate_multiplier=1.3, some_multiplier=1.4)
BOTH = ((tlik, thelpers, tcomp), (jlik, jhelpers, jcomp))


def _roundtrip(lf):
    return pickle.loads(pickle.dumps(lf))


def _binned_pair(likelihood_config=None):
    """The port's and the JAX package's binned likelihood of one config,
    each from the same reset numpy state, with the same data."""
    out = []
    for lik, helpers, _ in BOTH:
        np.random.seed(1)
        conf = helpers.conf_for_test(n_sources=2, mc=True,
                                     analysis_space=[['x', [-10, -1, 1, 10]]],
                                     n_events_for_pdf=int(1e5))
        lf = lik.BinnedLogLikelihood(conf, likelihood_config=(
            None if likelihood_config is None else dict(likelihood_config)))
        lf.add_rate_parameter('s0')
        lf.add_shape_parameter('some_multiplier', (0.5, 1.0, 2.0))
        lf.prepare()
        out.append(lf)
    data = out[0].base_model.simulate(rng=np.random.default_rng(0))
    for lf in out:
        lf.set_data(data)
    return out


def _unbinned(lik, helpers, source_wise=False):
    lf = lik.UnbinnedLogLikelihood(helpers.conf_for_test(
        n_sources=2, mc=False, source_wise_interpolation=source_wise))
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('some_multiplier', (0.5, 1.0, 2.0))
    lf.prepare()
    lf.set_data(helpers.make_data([dict(n_events=10, x=0.0)])[0])
    return lf


def test_binned_pickle_roundtrip(tmp_path):
    lf, jlf = _binned_pair()
    v1 = float(lf(**KW))
    assert float(_roundtrip(lf)(**KW)) == v1
    np.testing.assert_allclose(v1, float(jlf(**KW)), rtol=1e-12)
    # ... and through the package's atomic pickle I/O
    p = str(tmp_path / 'lf.pkl')
    save_pickle(lf, p)
    assert float(read_pickle(p)(**KW)) == v1


def test_unpickled_likelihood_drives_the_compiled_path():
    """The unpickled likelihood feeds the compiled path: its builds survive,
    so a toy study on it fits the same toys to the same values; the
    original's device cache is not in the pickle."""
    lf, _ = _binned_pair()
    cached_logl(lf, device='cpu')
    assert '_torch_compiled_for_fit' in lf.__dict__
    lf2 = _roundtrip(lf)
    assert '_torch_compiled_for_fit' not in lf2.__dict__
    runs = [BinnedToyStudy(x, device='cpu').profile_ts(
        0, 4, 's0_rate_multiplier', 1.0) for x in (lf, lf2)]
    assert np.isfinite(runs[1][1].max_ll).all()
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1].max_ll, runs[1][1].max_ll)


def test_binned_bb_pickle_roundtrip():
    """bb_single keeps an n_model_events interpolator: rebuilt on load."""
    lf, jlf = _binned_pair({
        'model_statistical_uncertainty_handling': 'bb_single',
        'bb_single_source': 's1'})
    v1 = float(lf(**KW))
    lf2 = _roundtrip(lf)
    assert float(lf2(**KW)) == v1
    np.testing.assert_allclose(v1, float(jlf(**KW)), rtol=1e-12)
    np.testing.assert_array_equal(
        lf2.n_model_events_interpolator(np.array([1.4])),
        lf.n_model_events_interpolator(np.array([1.4])))


@pytest.mark.parametrize('source_wise', [False, True])
def test_unbinned_pickle_roundtrip(source_wise):
    lf, jlf = (_unbinned(lik, helpers, source_wise)
               for lik, helpers, _ in BOTH)
    v1 = float(lf(**KW))
    lf2 = _roundtrip(lf)
    assert float(lf2(**KW)) == v1
    np.testing.assert_allclose(v1, float(jlf(**KW)), rtol=1e-12)
    # Rebinding data after the round trip rebuilds the per-event tensors
    new = thelpers.make_data([dict(n_events=5, x=1.0)])[0]
    lf2.set_data(new)
    lf.set_data(new)
    jlf.set_data(new)
    assert float(lf2(**KW)) == float(lf(**KW))
    np.testing.assert_allclose(float(lf2(**KW)), float(jlf(**KW)),
                               rtol=1e-12)


def test_unprepared_likelihood_pickles():
    lf = tlik.UnbinnedLogLikelihood(thelpers.conf_for_test(n_sources=1))
    lf2 = _roundtrip(lf)
    assert not lf2.is_prepared
    assert lf2.n_model_events_interpolator(np.array([0.0])) is None


# Composition classes pickle whenever the user's functions do
# (module-level functions round-trip with the stdlib pickle).

def _sq0(np0):
    return np0 ** 2


def _sq1(np1):
    return np1 ** 2


def _bil(np0, np1):
    return np0 * np1


def _anc(pars):
    return -0.5 * (pars['theta'] - 1.0) ** 2


def test_sum_pickle_roundtrip():
    values = []
    for lik, helpers, comp in BOTH:
        s = comp.LogLikelihoodSum([_unbinned(lik, helpers),
                                   _unbinned(lik, helpers)],
                                  likelihood_weights=[1.0, 0.5])
        values.append(float(s(**KW)))
        if comp is tcomp:
            cached_logl(s, device='cpu')
            s2 = _roundtrip(s)
            assert '_torch_compiled_for_fit' not in s2.__dict__
            assert float(s2(**KW)) == values[0]
    np.testing.assert_allclose(values[0], values[1], rtol=1e-12)


def test_reparam_and_ancillary_pickle_roundtrip():
    conv = dict(
        np0=(np.linspace(1e-12, 10, 2), None, None),
        np1=(np.linspace(1e-12, 10, 2), None, None),
        op0_rate_multiplier=dict(params=['np0'], func=_sq0),
        op1_rate_multiplier=dict(params=['np1'], func=_sq1),
        op2_rate_multiplier=dict(params=['np0', 'np1'], func=_bil),
    )
    rp_values, anc_values = [], []
    for lik, helpers, comp in BOTH:
        lf = lik.UnbinnedLogLikelihood(helpers.conf_for_reparam_test())
        lf.prepare()
        lf.set_data(helpers.make_data([dict(n_events=10, x=0.0)])[0])
        rp = comp.LogLikelihoodReParam(lf, conv)
        rp_values.append(float(rp(np0=1.3)))
        al = comp.LogAncillaryLikelihood(_anc, ['theta'],
                                         config={'theta': 1.0})
        anc_values.append(float(al(theta=1.5)))
        if comp is tcomp:
            # the patched base model (its simulate routed through the
            # transform) and the device cache of a compile
            rp.base_model
            cached_logl(rp, device='cpu')
            rp2 = _roundtrip(rp)
            assert '_torch_compiled_for_fit' not in rp2.__dict__
            assert float(rp2(np0=1.3)) == rp_values[0]
            assert len(rp2.base_model.simulate(dict(np0=2.0))['x']) > 0
            assert float(_roundtrip(al)(theta=1.5)) == anc_values[0]
    np.testing.assert_allclose(rp_values[0], rp_values[1], rtol=1e-12)
    assert anc_values[0] == anc_values[1]
