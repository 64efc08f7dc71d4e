"""``include_livetime`` of the port's compile against the JAX package's,
float64 on the CPU: twins of ``tests/test_compile_extra.py``'s
``test_compiled_livetime`` and ``tests/test_likelihood_sum.py``'s
``test_compiled_sum_livetime``, on identical data.

* 'livetime_days' becomes a parameter, its default the base live time and
  its bounds (0, inf); it scales every source's rate. The compiled value
  equals the host ``lf(livetime_days=...)`` and the JAX compiled value
  (rtol 1e-9), unbinned, binned (Gaussian Monte-Carlo templates) and
  through a Sum (one joint live time) and a ReParam.
* A zero or absent base live time raises the JAX package's ValueError.
* The fits never float it; fixed at another value, the closed-form engine,
  the autodiff engine and the JAX fit agree (max_ll 1e-6 absolute, x
  2e-3).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from blueice_tpu import composition as jcomp
from blueice_tpu import likelihood as jlik
from blueice_tpu import test_helpers as jhelpers
from blueice_tpu.compile import build_logl as jbuild
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu_torch import composition as tcomp
from blueice_tpu_torch import likelihood as tlik
from blueice_tpu_torch import test_helpers as thelpers
from blueice_tpu_torch.compile import (build_logl, build_logl_reparam,
                                       build_logl_sum)
from blueice_tpu_torch.parallel import fitter as tfitter

from test_torch_profile_grid_map import (  # noqa: F401
    fresh_template_caches, one_torch_thread)

PORT, JAX = (tlik, thelpers, tcomp), (jlik, jhelpers, jcomp)


def _unbinned(pkg, seed, **kw):
    lik, helpers, _ = pkg
    lf = lik.UnbinnedLogLikelihood(helpers.conf_for_test(**kw))
    lf.add_rate_parameter('s0')
    lf.prepare()
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(seed)))
    return lf


def _binned(pkg, livetime=2.0):
    lik, helpers, _ = pkg
    np.random.seed(3)
    lf = lik.BinnedLogLikelihood(helpers.conf_for_test(
        n_sources=2, mc=True, analysis_space=[['x', [-10, -1, 0, 1, 10]]],
        n_events_for_pdf=int(1e5), livetime_days=livetime,
        events_per_day=50.))
    lf.add_rate_parameter('s0')
    lf.add_shape_parameter('some_multiplier', (0.5, 1.0, 2.0))
    lf.prepare()
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(4)))
    return lf


def test_compiled_livetime():
    lf = _unbinned(PORT, 1, livetime_days=2.0)
    jlf = _unbinned(JAX, 1, livetime_days=2.0)
    c = build_logl(lf, device='cpu', include_livetime=True)
    jc = jbuild(jlf, include_livetime=True)
    assert c.param_names == jc.param_names
    assert 'livetime_days' in c.param_names
    assert c.defaults['livetime_days'] == 2.0
    assert tuple(c.bounds['livetime_days']) == (0.0, float('inf'))
    for kw in (dict(livetime_days=3.0), dict(),
               dict(livetime_days=0.5, s0_rate_multiplier=1.7)):
        value = float(c(**kw))
        assert thelpers.almost_equal(value, lf(**kw), 1e-9)
        np.testing.assert_allclose(value, float(jc(**kw)), rtol=1e-9)


def test_compiled_binned_livetime():
    """A morphed binned likelihood: the rates, the value and the expected
    counts follow the live time, as the JAX package's."""
    lf, jlf = _binned(PORT), _binned(JAX)
    c = build_logl(lf, device='cpu', include_livetime=True)
    jc = jbuild(jlf, include_livetime=True)
    for kw in (dict(livetime_days=4.0, some_multiplier=1.3), dict(),
               dict(livetime_days=1.0, s0_rate_multiplier=0.4)):
        value = float(c(**kw))
        assert thelpers.almost_equal(value, lf(**kw), 1e-9)
        np.testing.assert_allclose(value, float(jc(**kw)), rtol=1e-9)
        p, jp = c.params_from_kwargs(**kw), jc.params_from_kwargs(**kw)
        np.testing.assert_allclose(c.rates(p).numpy(),
                                   np.asarray(jc.rates(jp)), rtol=1e-12)


def test_compiled_sum_livetime():
    """One joint live time for every child of a Sum, and through a
    ReParam."""
    sums = []
    for pkg in (PORT, JAX):
        lf1 = _unbinned(pkg, 1, livetime_days=1.0)
        lf2 = _unbinned(pkg, 2, events_per_day=500., livetime_days=1.0)
        sums.append((lf1, lf2, pkg[2].LogLikelihoodSum([lf1, lf2])))
    (lf1, lf2, s), (_, _, js) = sums
    c = build_logl_sum(s, device='cpu', include_livetime=True)
    jc = jbuild(js, include_livetime=True)
    assert 'livetime_days' in c.param_names
    assert c.param_names == jc.param_names
    assert all('livetime_days' in r for r in c.child_routed)
    value = float(c(livetime_days=2.0))
    assert thelpers.almost_equal(
        value, lf1(livetime_days=2.0) + lf2(livetime_days=2.0), 1e-9)
    np.testing.assert_allclose(value, float(jc(livetime_days=2.0)),
                               rtol=1e-9)
    assert thelpers.almost_equal(float(c()), s(), 1e-9)

    lf1.pdf_base_config['coupling'] = 2.0
    rp = tcomp.LogLikelihoodReParam(lf1, {
        's0_rate_multiplier': {'params': ['coupling'],
                               'func': lambda g: g ** 2},
        'coupling': (np.linspace(0.5, 4.0, 4), None, None)})
    crp = build_logl_reparam(rp, device='cpu', include_livetime=True)
    assert 'livetime_days' in crp.param_names
    assert thelpers.almost_equal(
        float(crp(livetime_days=3.0, coupling=3.0)),
        rp(livetime_days=3.0, coupling=3.0), 1e-9)


@pytest.mark.parametrize('base', [None, 0.0])
def test_missing_base_livetime_raises(base):
    kw = {} if base is None else dict(livetime_days=base)
    for pkg, build in ((PORT, lambda lf: build_logl(
            lf, device='cpu', include_livetime=True)),
            (JAX, lambda lf: jbuild(lf, include_livetime=True))):
        lf = _unbinned(pkg, 1, **kw)
        with pytest.raises(ValueError, match='base livetime'):
            build(lf)


def test_livetime_fits_agree():
    """The fits never float the live time. Fixed at twice the base, the
    closed-form engine and the autodiff engine fit the same toys to the
    same optima, and to the JAX package's."""
    lf, jlf = _binned(PORT), _binned(JAX)
    c = build_logl(lf, device='cpu', include_livetime=True)
    jc = jbuild(jlf, include_livetime=True)
    assert tfitter._engine_family(c) == 'binned'
    fixed = {'livetime_days': 4.0}
    counts = c.expected_counts(c.params_from_kwargs(**fixed)).numpy()
    counts = np.random.default_rng(6).poisson(
        counts, (4,) + counts.shape).astype(float)
    out = {}
    for engine in ('analytic', 'ad'):
        fit, names = tfitter.make_toy_fitter(c, fixed=fixed, engine=engine)
        assert 'livetime_days' not in names
        x, ll, _ = fit(torch.as_tensor(counts))
        out[engine] = (x.numpy(), ll.numpy())
    jfit, jnames = jfitter.make_toy_fitter(jc, fixed=fixed)
    assert jnames == names
    jx, jll, _ = jax.vmap(lambda d: jfit(d))(jnp.asarray(counts))
    for x, ll in out.values():
        np.testing.assert_allclose(ll, np.asarray(jll), rtol=0, atol=1e-6)
        np.testing.assert_allclose(x, np.asarray(jx), rtol=2e-3, atol=2e-3)
    # and at the base live time the fits are those without the parameter
    fit, _ = tfitter.make_toy_fitter(c)
    plain, _ = tfitter.make_toy_fitter(build_logl(lf, device='cpu'))
    np.testing.assert_allclose(fit(torch.as_tensor(counts))[1].numpy(),
                               plain(torch.as_tensor(counts))[1].numpy(),
                               rtol=0, atol=1e-9)
