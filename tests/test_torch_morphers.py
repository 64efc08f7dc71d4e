"""The port's morphers against the JAX package's, float64 on the CPU: the
five cases of ``tests/test_morphers.py`` on the port's classes, and the
scattered-anchor ``RadialInterpolator`` end to end.

* ``latin`` consumes numpy's global RandomState as the JAX package's does,
  so one ``np.random.seed`` gives both packages the same anchors, radii of
  influence and host values (bit for bit).
* A radial likelihood compiles (``state_from_reference`` carries the
  scattered anchors): its value equals the host's and the JAX compiled
  value's (rtol 1e-9, ``tests/test_compile_extra.py``'s
  ``test_compiled_radial_morpher``); its derivatives at a point exactly on
  an anchor are finite (the ``tiny`` floor under the square root); its
  fits take the autodiff engine and match the JAX package's on the same
  toys (max_ll 1e-6 absolute, x 2e-3, as ``tests/test_torch_ad_engine.py``).
"""

from collections import OrderedDict

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import blueice_tpu.exceptions
from blueice_tpu import morphers as jmorphers
from blueice_tpu import test_helpers as jhelpers
from blueice_tpu.compile import build_logl as jbuild
from blueice_tpu.likelihood import UnbinnedLogLikelihood as JaxUnbinned
from blueice_tpu.parallel import fitter as jfitter
from blueice_tpu_torch import exceptions, morphers
from blueice_tpu_torch import test_helpers as thelpers
from blueice_tpu_torch.compile import build_logl
from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
from blueice_tpu_torch.parallel import fitter as tfitter

from test_torch_log_morphing import JAX, PORT, blob_likelihood
from test_torch_profile_grid_map import (  # noqa: F401
    fresh_template_caches, one_torch_thread)

RADIAL = {'morpher': 'RadialInterpolator',
          'morpher_config': {'hypercube_shuffle_steps': 20}}


def test_morpher_api():
    """Generic contract test over the MORPHERS registry."""
    conf = dict(hypercube_shuffle_steps=2, r_sample_points=2)
    assert set(morphers.MORPHERS) == set(jmorphers.MORPHERS)
    for name, morph_class in morphers.MORPHERS.items():
        with pytest.raises(exceptions.NoShapeParameters):
            morph_class(config=conf, shape_parameters=OrderedDict())

        shape_pars = OrderedDict([('bla', ({-1: -1, 0: 0, 1: 1}, None, None))])
        mr = morph_class(config=conf, shape_parameters=shape_pars)
        aps = mr.get_anchor_points(bounds=[(-1, 1)], n_models=3)
        assert isinstance(aps, list)
        assert isinstance(aps[0], tuple)

        def scalar_f(_):
            return 0

        scalar_itp = mr.make_interpolator(scalar_f, extra_dims=[],
                                          anchor_models={z: None for z in aps})
        assert scalar_itp([0]) == 0

        matrix_itp = mr.make_interpolator(scalar_f, extra_dims=[2, 2],
                                          anchor_models={z: None for z in aps})
        np.testing.assert_array_equal(matrix_itp([0]), np.zeros((2, 2)))


def test_grid_interpolator_values():
    """GridInterpolator is exact at anchors and multilinear between them,
    on the host and on tensors."""
    shape_pars = OrderedDict([
        ('a', ({0.0: 0.0, 1.0: 1.0}, None, None)),
        ('b', ({0.0: 0.0, 2.0: 2.0}, None, None)),
    ])
    mr = morphers.GridInterpolator({}, shape_pars)
    aps = mr.get_anchor_points(bounds=None)
    assert len(aps) == 4

    # f = a + 10*b is linear, so interpolation is exact everywhere
    models = {zs: zs for zs in aps}
    itp = mr.make_interpolator(lambda m: np.array([m[0] + 10 * m[1]]),
                               extra_dims=[1], anchor_models=models)
    for a, b in [(0, 0), (1, 2), (0.25, 0.5), (1.0, 1.3)]:
        np.testing.assert_allclose(itp(np.array([a, b])), [a + 10 * b],
                                   rtol=1e-12)
    tensor = mr.build_tensor(lambda m: np.array([m[0] + 10 * m[1]]),
                             [1], models)
    got = mr.eval(torch.as_tensor(tensor),
                  torch.tensor([0.25, 0.5], dtype=torch.float64))
    np.testing.assert_allclose(got.numpy(), [0.25 + 5.0], rtol=1e-12)


def test_radial_interpolator_smoke():
    shape_pars = OrderedDict([('a', ({0.0: 0.0, 1.0: 1.0}, None, None))])
    mr = morphers.RadialInterpolator(dict(hypercube_shuffle_steps=5),
                                     shape_pars)
    aps = mr.get_anchor_points(bounds=[(0, 1)], n_models=5)
    models = {zs: zs for zs in aps}
    itp = mr.make_interpolator(lambda m: np.array([m[0]]), extra_dims=[1],
                               anchor_models=models)
    out = itp(np.array([0.5]))
    assert out.shape == (1,)
    assert 0 <= out[0] <= 1


def test_latin():
    pts = morphers.latin(5, 2, shuffle_steps=10)
    assert pts.shape == (5, 2)
    # Each column is a permutation of the diagonal values
    for d in range(2):
        np.testing.assert_allclose(np.sort(pts[:, d]),
                                   np.arange(5) / 4.0, rtol=1e-12)
    boxed = morphers.latin(4, 1, box=[(10, 20)], shuffle_steps=5)
    assert (boxed >= 10).all() and (boxed <= 20).all()


def test_single_anchor_axis_rejected():
    """Grid morphing needs >= 2 anchors per axis."""
    shape_parameters = OrderedDict(
        mu=({-1.0: -1.0, 0.0: 0.0, 1.0: 1.0}, None, None),
        sigma=({1.0: 1.0}, None, None))
    with pytest.raises(exceptions.InvalidParameterSpecification,
                       match='at least 2'):
        morphers.MORPHERS['GridInterpolator']({}, shape_parameters)
    with pytest.raises(blueice_tpu.exceptions.InvalidParameterSpecification,
                       match='at least 2'):
        jmorphers.MORPHERS['GridInterpolator']({}, shape_parameters)


@pytest.mark.parametrize('steps', [0, 50])
def test_radial_anchors_match_jax(steps):
    """One numpy seed, the same anchors, radii and host values; the
    torch eval of the same tensor equals the host eval."""
    shape_pars = OrderedDict([('a', ({0.0: 0.0, 2.0: 2.0}, None, None)),
                              ('b', ({-1.0: -1.0, 1.0: 1.0}, None, None))])
    out = []
    for mod in (morphers, jmorphers):
        np.random.seed(7)
        mr = mod.RadialInterpolator(dict(hypercube_shuffle_steps=steps,
                                         decay_multiplier=3), shape_pars)
        aps = mr.get_anchor_points(bounds=[(0.0, 2.0), (-1.0, 1.0)],
                                   n_models=9)
        out.append((mr, aps, np.random.randint(1 << 30)))
    (tm, taps, tnext), (jm, japs, jnext) = out
    assert taps == japs
    assert tnext == jnext          # the same draws from the global state
    np.testing.assert_array_equal(tm._r0s, jm._r0s)
    np.testing.assert_array_equal(tm._normed_model_zs, jm._normed_model_zs)
    tensor = np.random.default_rng(0).normal(size=(9, 3, 4))
    rng = np.random.default_rng(1)
    for zs in [np.array(taps[3], dtype=float), rng.uniform([0, -1], [2, 1])]:
        host = tm.host_eval(tensor, zs)
        np.testing.assert_array_equal(host, jm.host_eval(tensor, zs))
        np.testing.assert_allclose(
            tm.eval(torch.as_tensor(tensor), torch.as_tensor(zs)).numpy(),
            host, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(jm.jax_eval(jnp.asarray(tensor), jnp.asarray(zs))),
            host, rtol=1e-12, atol=1e-12)


def _radial_unbinned(cls, helpers):
    np.random.seed(0)
    lf = cls(helpers.conf_for_test(), likelihood_config=dict(RADIAL))
    lf.add_shape_parameter('some_multiplier', (0.5, 1, 2))
    lf.prepare()
    lf.set_data(lf.base_model.simulate(rng=np.random.default_rng(0)))
    return lf


def test_compiled_radial_morpher():
    """The compiled radial likelihood against the host and against the JAX
    compiled value; finite first and second derivatives everywhere,
    exactly on an anchor included."""
    lf = _radial_unbinned(UnbinnedLogLikelihood, thelpers)
    jlf = _radial_unbinned(JaxUnbinned, jhelpers)
    c, jc = build_logl(lf, device='cpu'), jbuild(jlf)
    assert c.anchor_arrays is None and c.radial is not None
    anchor = float(lf.morpher._anchor_order[2][0])
    for kwargs in [dict(), dict(some_multiplier=1.2),
                   dict(some_multiplier=anchor)]:
        value = float(c(**kwargs))
        assert thelpers.almost_equal(value, lf(**kwargs), 1e-9)
        np.testing.assert_allclose(value, float(jc(**kwargs)), rtol=1e-9)
    for z in (1.2, anchor):
        p = {k: torch.tensor(float(v), dtype=torch.float64)
             for k, v in c.params_from_kwargs(some_multiplier=z).items()}

        def f(x):
            return c.logl(dict(p, some_multiplier=x))
        g = torch.func.jacfwd(f)(p['some_multiplier'])
        h = torch.func.jacfwd(torch.func.jacfwd(f))(p['some_multiplier'])
        jg = jax.grad(jc.logl)(jc.params_from_kwargs(some_multiplier=z))
        assert torch.isfinite(g) and torch.isfinite(h)
        np.testing.assert_allclose(float(g), float(jg['some_multiplier']),
                                   rtol=1e-7)


def _radial_blob(pkg):
    np.random.seed(0)
    return blob_likelihood(pkg, 'linear', K=2,
                           likelihood_config=dict(RADIAL))


def test_radial_toy_fit_matches_jax():
    """A binned radial model: 'auto' picks the autodiff engine (no anchor
    grid for the closed forms), and its fits of numpy-made toys, free and
    with the target fixed at run time, are the JAX package's."""
    tlf, jlf = _radial_blob(PORT), _radial_blob(JAX)
    assert tlf.morpher._anchor_order == jlf.morpher._anchor_order
    tc, jc = build_logl(tlf, device='cpu'), jbuild(jlf)
    assert tfitter._engine_family(tc) == 'ad'
    assert not jfitter._analytic_supported(jc)
    counts = tc.expected_counts(tc.defaults).numpy()
    counts = np.random.default_rng(5).poisson(
        counts, (3,) + counts.shape).astype(float)
    target = 'wimp_rate_multiplier'
    for runtime in ((), (target,)):
        fixed_values = [1.3] if runtime else None
        fit, names = tfitter.make_toy_fitter(tc, runtime_fixed=runtime)
        jfit, jnames = jfitter.make_toy_fitter(jc, engine='ad',
                                               runtime_fixed=runtime)
        assert names == jnames
        x, ll, _ = fit(torch.as_tensor(counts), fixed_values)
        jx, jll, _ = jax.vmap(lambda d: jfit(
            d, None, tuple(jnp.asarray(v) for v in (fixed_values or ()))))(
                jnp.asarray(counts))
        np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-3,
                                   atol=2e-3)


def test_source_wise_refuses_a_radial_morpher():
    """Source-wise builds keep the JAX package's refusal of scattered
    anchors."""
    for cls, helpers in ((UnbinnedLogLikelihood, thelpers),
                         (JaxUnbinned, jhelpers)):
        lf = cls(helpers.conf_for_test(source_wise_interpolation=True),
                 likelihood_config=dict(RADIAL))
        lf.add_shape_parameter('some_multiplier', (0.5, 1, 2))
        with pytest.raises(NotImplementedError, match='GridInterpolator'):
            lf.prepare()
