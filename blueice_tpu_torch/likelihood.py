"""Log-likelihood constructors: the host layer of the binned likelihood.

Counterpart of :mod:`blueice_tpu.likelihood` for the slice the port runs:

* ``prepare()`` builds one Model per shape-parameter anchor combination and
  stacks the payloads into dense anchor tensors: expected rates
  (*grid, n_sources) and PMF grids (*grid, n_sources, *bins), kept in
  ``self._builds`` exactly as the JAX package keeps them.
* ``__call__(**kwargs)`` is the host convenience path: plain numpy/float64,
  reproducing the reference's semantics (out-of-bounds -> -inf, unphysical
  rate policy, livetime scaling rules, arbitrary host priors).
* :meth:`LogLikelihoodBase.make_logl` (see :mod:`blueice_tpu_torch.compile`)
  lowers the same likelihood to torch tensors on a chosen device.

The binned likelihood's finite-MC-statistics modes are ported: 'bb_single'
(the reference's one-source Beeston-Barlow profile, analytic per-bin root)
and 'bb_lite' (one profiled scale per bin on the total template).

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP item):
unbinned likelihoods, log template morphing, source-wise interpolation,
parallel template builds, and the likelihood compositions (sum,
re-parametrisation, ancillary terms).
"""

from collections import OrderedDict
from copy import deepcopy
from functools import wraps

import numpy as np
from scipy.special import gammaln, xlogy

from .exceptions import (NotPreparedException, InvalidParameterSpecification,
                         InvalidParameter)
from .models import Model
from .morphers import MORPHERS
from .ops.bb_lite import bb_lite_logl_host
from .ops.hist import Hist
from .priors import NormalPrior
from .utils import combine_dicts, inherit_docstring_from

__all__ = ['LogLikelihoodBase', 'BinnedLogLikelihood', 'UnbinnedLogLikelihood',
           'beeston_barlow_root1', 'beeston_barlow_root2',
           'beeston_barlow_roots']


def _needs_preparation(f):
    @wraps(f)
    def wrapper(self, *args, **kwargs):
        if not self.is_prepared:
            if not len(self.shape_parameters):
                # Preparation is trivial without shape parameters: just do it
                self.prepare()
            else:
                raise NotPreparedException(
                    "%s requires you to first prepare the likelihood function "
                    "using prepare()" % f.__name__)
        return f(self, *args, **kwargs)
    return wrapper


def _needs_data(f):
    @wraps(f)
    def wrapper(self, *args, **kwargs):
        if not self.is_data_set:
            raise NotPreparedException(
                "%s needs data: call set_data() first"
                % f.__name__)
        return f(self, *args, **kwargs)
    return wrapper


def _global_host_interpolator(morpher, tensor):
    """Host interpolator over a stacked anchor tensor (a 'global' build)."""
    def interpolator(zs):
        return np.asarray(morpher.host_eval(tensor, np.asarray(zs)))
    return interpolator


class LogLikelihoodBase:
    """Log likelihood function with rate and/or shape nuisance parameters.

    likelihood_config options:
        morpher ('GridInterpolator', the only one ported), morpher_config,
        unphysical_behaviour ('error' to raise instead of returning -inf).
    """

    def __init__(self, pdf_base_config, likelihood_config=None, **kwargs):
        """
        :param pdf_base_config: config dict passed to the Model.
        :param likelihood_config: options for the likelihood itself.
        :param kwargs: overrides for pdf_base_config (not likelihood_config).
        """
        self.pdf_base_config = combine_dicts(pdf_base_config, kwargs,
                                             deep_copy=True)
        self.config = likelihood_config if likelihood_config is not None else {}
        self.config.setdefault('morpher', 'GridInterpolator')
        if self.config['morpher'] not in MORPHERS:
            raise NotImplementedError(
                "morpher %r is not ported yet (ROADMAP queue 1 item 16); "
                "use 'GridInterpolator'" % (self.config['morpher'],))
        if self.config.get('template_interpolation', 'linear') != 'linear':
            raise NotImplementedError(
                "template_interpolation=%r is not ported yet (ROADMAP queue "
                "1 item 11, log morphing)"
                % (self.config['template_interpolation'],))
        self.source_wise_interpolation = self.pdf_base_config.get(
            'source_wise_interpolation', False)
        if self.source_wise_interpolation:
            raise NotImplementedError(
                "source_wise_interpolation is not ported yet (ROADMAP queue "
                "1 item 9)")

        # Base model: no variation of any setting
        self.base_model = Model(self.pdf_base_config)
        self.source_name_list = [s.name for s in self.base_model.sources]
        self.source_allowed_negative = [
            s.config.get('allow_negative', False)
            for s in self.base_model.sources]
        self.source_apply_efficiency = np.array([
            s.config.get('apply_efficiency', False)
            for s in self.base_model.sources])
        self.source_efficiency_names = np.array([
            s.config.get('efficiency_name', 'efficiency')
            for s in self.base_model.sources])

        # sourcename -> log prior on its rate multiplier
        self.rate_parameters = OrderedDict()
        # settingname -> (anchors {z: setting}, log_prior, base_z)
        self.shape_parameters = OrderedDict()

        self.is_prepared = False
        self.is_data_set = False
        self._has_non_numeric = False
        # Monotonic payload version, bumped by prepare()/set_data()
        self._build_version = 0

        # Without shape parameters:
        self.ps = None                    # pmf grids
        self.n_model_events = None

        # With shape parameters:
        self.anchor_models = OrderedDict()    # zs tuple -> Model
        self.mus_interpolator = None
        self.ps_interpolator = None
        self.n_model_events_interpolator = None

        # Stacked anchor tensors for the device path (set by prepare):
        #   dict payload_name -> ('global', morpher, tensor)
        #                      | ('constant', array)
        self._builds = {}

    # -- preparation -----------------------------------------------------------

    def prepare(self, n_cores=1, ipp_client=None):
        """Build the anchor models for every shape-parameter anchor
        combination and stack their rate payloads into the mus anchor tensor.

        :param n_cores: only 1 is ported (parallel template builds are ROADMAP
          queue 1 item 16).
        """
        if n_cores != 1 or ipp_client is not None:
            raise NotImplementedError(
                "parallel template builds (n_cores > 1, ipp_client) are not "
                "ported yet (ROADMAP queue 1 item 16)")
        if len(self.shape_parameters):
            self.morpher = MORPHERS[self.config['morpher']](
                self.config.get('morpher_config', {}), self.shape_parameters)
            zs_list = self.morpher.get_anchor_points(bounds=self.get_bounds())

            configs = []
            for zs in zs_list:
                config = deepcopy(self.pdf_base_config)
                for i, (setting_name, (anchors, _, _)) in enumerate(
                        self.shape_parameters.items()):
                    if zs[i] is not None:
                        config[setting_name] = anchors.get(zs[i], zs[i])
                configs.append(config)

            models = self._build_models(configs)
            for zs, model in zip(zs_list, models):
                self.anchor_models[tuple(zs)] = model
            self.mus_interpolator, mus_tensor = self._interp_and_tensor(
                self.morpher, f=lambda m: m.expected_events(),
                extra_dims=[len(self.source_name_list)],
                anchor_models=self.anchor_models)
            self._builds['mus'] = ('global', self.morpher, mus_tensor)

        self.is_data_set = False
        self._builds.pop('ps', None)
        self.is_prepared = True
        self._build_version += 1

    def _build_models(self, configs):
        from .utils.progress import progress_iter
        return [Model(c) for c in progress_iter(
            configs, desc="Computing/loading anchor models")]

    @staticmethod
    def _interp_and_tensor(morpher, f, extra_dims, anchor_models):
        """Build the stacked anchor tensor once; return (host interpolator,
        tensor)."""
        tensor = np.asarray(morpher.build_tensor(f, extra_dims, anchor_models))
        return _global_host_interpolator(morpher, tensor), tensor

    # -- data --------------------------------------------------------------------

    @_needs_preparation
    def set_data(self, d):
        """Bind the dataset d for likelihood evaluation.
        :param d: indexable by analysis dimension name (numpy record array,
          dict of arrays or DataFrame): d['x'] etc. give per-event coordinates.
        """
        self._data = d
        self.is_data_set = True
        self._build_version += 1

    # -- parameter registry --------------------------------------------------------

    def add_rate_parameter(self, source_name, log_prior=None):
        """Add parameter source_name + "_rate_multiplier" which MULTIPLIES the
        expected rate of that source (shape parameters can also change rates).
        :param log_prior: log-prior pdf on the multiplier (not the rate itself).
        """
        self.rate_parameters[source_name] = log_prior

    def add_shape_parameter(self, setting_name, anchors, log_prior=None,
                            base_value=None):
        """Add a shape parameter that varies the config setting setting_name.
        :param anchors: list/tuple/array of numeric setting values, OR a dict
          {representative z: setting value} for non-numeric settings.
        :param base_value: for non-numeric settings, the z representing the
          base model's setting.
        """
        is_numeric = isinstance(self.pdf_base_config.get(setting_name),
                                (float, int))
        if not isinstance(anchors, dict):
            if not is_numeric:
                raise InvalidParameterSpecification(
                    "Anchors given as a bare list of setting values need the "
                    "base setting to have a numeric default")
            anchors = {z: z for z in anchors}

        if not is_numeric:
            self._has_non_numeric = True
            if base_value is None:
                raise InvalidParameterSpecification(
                    "For non-numeric settings, you must specify which number "
                    "represents the default (base model) setting")
        if is_numeric and base_value is not None:
            raise InvalidParameterSpecification(
                "base_value only applies to non-numeric settings; numeric "
                "anchors are their own base values")

        self.shape_parameters[setting_name] = (anchors, log_prior, base_value)

    def add_rate_uncertainty(self, source_name, fractional_uncertainty):
        """Rate parameter with a Gaussian prior around 1."""
        self.add_rate_parameter(source_name,
                                log_prior=NormalPrior(1, fractional_uncertainty))

    def add_shape_uncertainty(self, setting_name, fractional_uncertainty,
                              anchor_zs=(-2, -1, 0, 1, 2), base_value=None):
        """Shape parameter with a Gaussian prior around the default value.
        :param fractional_uncertainty: relative uncertainty on the default value.
        """
        self.add_shape_parameter(setting_name, anchor_zs, base_value=base_value)
        anchors, _, base_value = self.shape_parameters[setting_name]
        if base_value is None:
            center = self.pdf_base_config.get(setting_name)
        else:
            center = base_value
        self.shape_parameters[setting_name] = (
            anchors, NormalPrior(center, center * fractional_uncertainty),
            base_value)

    def get_bounds(self, parameter_name=None):
        """Bounds of parameter_name (all shape parameters if None)."""
        if parameter_name is None:
            return [self.get_bounds(p) for p in self.shape_parameters.keys()]
        if parameter_name in self.shape_parameters:
            anchor_settings = list(self.shape_parameters[parameter_name][0].keys())
            return min(anchor_settings), max(anchor_settings)
        elif parameter_name.endswith('_rate_multiplier'):
            for source_name, allow_negative in zip(self.source_name_list,
                                                   self.source_allowed_negative):
                if parameter_name == source_name + '_rate_multiplier':
                    return ((float('-inf'), float('inf')) if allow_negative
                            else (0, float('inf')))
        raise InvalidParameter("No parameter named %s in this likelihood" % parameter_name)

    # -- evaluation (host path) --------------------------------------------------

    @_needs_data
    def __call__(self, livetime_days=None, full_output=False, **kwargs):
        """Evaluate the log likelihood. Parameters not passed take their base
        values; rate uncertainties are passed as sourcename_rate_multiplier.
        :param livetime_days: exposure to evaluate at (scales all rates).
        :param full_output: also return the mus and ps.
        """
        result = 0
        rate_multipliers, shape_settings = self._kwargs_to_settings(**kwargs)

        if len(self.shape_parameters):
            zs = []
            for setting_name, (_, log_prior, _) in \
                    self.shape_parameters.items():
                z = shape_settings[setting_name]
                zs.append(z)
                minbound, maxbound = self.get_bounds(setting_name)
                if not minbound <= z <= maxbound:
                    # Cannot extrapolate beyond the anchor range
                    return -float('inf')
                if log_prior is not None:
                    result += float(log_prior(z))
            zs = np.asarray(zs, dtype=float)
            mus = np.array(self.mus_interpolator(zs), dtype=float)
            ps = self.ps_interpolator(zs)
            n_model_events = (None if self.n_model_events_interpolator is None
                              else self.n_model_events_interpolator(zs))
        else:
            mus = np.array(self.base_model.expected_events(), dtype=float)
            ps = self.ps
            n_model_events = self.n_model_events

        # Rate multipliers (and their priors)
        for source_i, source_name in enumerate(self.source_name_list):
            mult = rate_multipliers[source_i]
            mus[source_i] *= mult
            log_prior = self.rate_parameters.get(source_name, None)
            if log_prior is not None:
                result += float(log_prior(mult))

        # Livetime scaling
        if livetime_days is not None:
            if 'livetime_days' not in self.pdf_base_config:
                raise ValueError(
                    "livetime scaling needs a livetime_days entry in the "
                    "base config to scale relative to")
            if self.pdf_base_config['livetime_days'] == 0:
                if livetime_days != 0:
                    raise ValueError("Cannot scale from 0 to non-0 livetime")
                if not np.all(mus == 0):
                    raise ValueError(
                        "zero base livetime must mean zero expectations")
            else:
                mus = mus * (livetime_days / self.pdf_base_config['livetime_days'])

        # Per-source efficiencies
        if True in self.source_apply_efficiency:
            effs = [shape_settings.get(sen, 1)
                    for sae, sen in zip(self.source_apply_efficiency,
                                        self.source_efficiency_names) if sae]
            mus[self.source_apply_efficiency] *= np.array(effs)

        # Unphysical rate policy
        if self._unphysical(mus):
            if self.config.get('unphysical_behaviour') == 'error':
                raise ValueError("Unphysical rates: %s" % str(mus))
            return -float('inf')

        # Finite-MC-statistics adjustment (analytic Beeston-Barlow, binned)
        mus, ps = self.adjust_expectations(mus, ps, n_model_events)

        result += self._compute_likelihood(mus, ps)

        if full_output:
            return result, mus, ps
        return result

    def _unphysical(self, mus):
        """True if the expected-rate vector violates the physicality policy."""
        if not any(self.source_allowed_negative):
            return not np.all((mus >= 0) & (mus < float('inf')))
        # Some sources may go negative: all-infinite or negative-total is still bad
        if (not any(mus < float('inf'))) or (np.sum(mus) < 0):
            return True
        return any(not (0 <= mu) and not allowed
                   for mu, allowed in zip(mus, self.source_allowed_negative))

    def adjust_expectations(self, mus, ps, n_model_events):
        """Adjust uncertain (mus, pmfs) for the observed data: hook for the
        analytic Beeston-Barlow profile of finite-MC templates (binned
        only)."""
        return mus, ps

    def _kwargs_to_settings(self, **kwargs):
        """Validate kwargs; return (rate_multipliers list per source,
        {shape setting name: z})."""
        for k in kwargs.keys():
            if k in self.shape_parameters:
                continue
            if k.endswith('_rate_multiplier') \
                    and k[:-len('_rate_multiplier')] in self.source_name_list:
                continue
            raise InvalidParameter(
                "%s matches neither a rate nor a shape parameter" % k)

        shape_settings = dict()
        for setting_name, (_, _, base_value) in self.shape_parameters.items():
            z = kwargs.get(setting_name)
            if z is None:
                base_setting = self.pdf_base_config.get(setting_name)
                z = (base_setting if isinstance(base_setting, (float, int))
                     else base_value)
            if not isinstance(z, (int, float)):
                raise ValueError("Arguments to likelihood function must be "
                                 "numeric, not %s" % type(z))
            shape_settings[setting_name] = z

        rate_multipliers = [kwargs.get(sn + '_rate_multiplier', 1)
                            for sn in self.source_name_list]
        return rate_multipliers, shape_settings

    def _compute_likelihood(self, mus, ps):
        raise NotImplementedError

    # -- device path ---------------------------------------------------------------

    def make_logl(self, **opts):
        """Lower this likelihood to torch tensors on a device.
        See :func:`blueice_tpu_torch.compile.build_logl` for options."""
        from .compile import build_logl
        return build_logl(self, **opts)


class UnbinnedLogLikelihood(LogLikelihoodBase):
    """Extended unbinned log likelihood — not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "UnbinnedLogLikelihood is not ported yet (ROADMAP queue 1 item 9, "
            "slice C)")


class BinnedLogLikelihood(LogLikelihoodBase):
    """Binned Poisson log likelihood over the analysis-space bins, with
    optional analytic handling of finite-MC templates
    (likelihood_config 'model_statistical_uncertainty_handling': None,
    'bb_single' with 'bb_single_source', or 'bb_lite')."""

    def __init__(self, pdf_base_config, likelihood_config=None, **kwargs):
        LogLikelihoodBase.__init__(self, pdf_base_config, likelihood_config,
                                   **kwargs)
        self._bb_lite_nme = None
        self.model_statistical_uncertainty_handling = \
            self.config.get('model_statistical_uncertainty_handling')
        if self.model_statistical_uncertainty_handling not in (
                None, 'bb_single', 'bb_lite'):
            # Fail at construction: an unknown mode silently evaluating the
            # plain Poisson likelihood would be a wrong-results bug
            raise ValueError(
                "model_statistical_uncertainty_handling must be None, "
                "'bb_single' (the reference's one-source Beeston-Barlow) or "
                "'bb_lite' (HistFactory-style per-bin total-template scale); "
                "got %r" % (self.model_statistical_uncertainty_handling,))

    @inherit_docstring_from(LogLikelihoodBase)
    def prepare(self, n_cores=1, ipp_client=None):
        LogLikelihoodBase.prepare(self, n_cores, ipp_client)
        self.ps, self.n_model_events = self.base_model.pmf_grids()

        if len(self.shape_parameters):
            self.ps_interpolator, pmf_tensor = self._interp_and_tensor(
                self.morpher, f=lambda m: m.pmf_grids()[0],
                extra_dims=list(self.ps.shape),
                anchor_models=self.anchor_models)
            self._builds['ps'] = ('global', self.morpher, pmf_tensor)
            if self.model_statistical_uncertainty_handling is not None:
                self.n_model_events_interpolator, nme_tensor = \
                    self._interp_and_tensor(
                        self.morpher, f=lambda m: m.pmf_grids()[1],
                        extra_dims=list(self.ps.shape),
                        anchor_models=self.anchor_models)
                self._builds['n_model_events'] = ('global', self.morpher,
                                                  nme_tensor)
        else:
            self._builds['ps'] = ('constant', self.ps)
            self._builds['n_model_events'] = ('constant', self.n_model_events)

    @inherit_docstring_from(LogLikelihoodBase)
    def set_data(self, d):
        LogLikelihoodBase.set_data(self, d)
        self.data_events_per_bin = Hist.from_analysis_space(
            self.base_model.config['analysis_space'])
        self.data_events_per_bin.add(*self.base_model.to_analysis_dimensions(d))

    def adjust_expectations(self, mus, pmfs, n_model_events):
        """The finite-MC-statistics adjustment. 'bb_single' replaces the
        finite source's (mu, pmf) by the profiled Beeston-Barlow solution;
        'bb_lite' changes the per-bin likelihood instead, so it keeps the
        morphed MC counts for the :meth:`_compute_likelihood` call that
        follows."""
        mus = np.array(mus, dtype=float)
        pmfs = np.array(pmfs, dtype=float)
        mode = self.model_statistical_uncertainty_handling
        if mode == 'bb_lite':
            self._bb_lite_nme = np.asarray(n_model_events, dtype=float)
            return mus, pmfs
        if mode != 'bb_single':
            return mus, pmfs

        source_i = self.config.get('bb_single_source')
        if source_i is None:
            raise ValueError("You need to specify bb_single_source to use "
                             "bb_single expectation adjustment")
        source_i = self.base_model.get_source_i(source_i)
        assert pmfs.shape == n_model_events.shape

        # Expected counts per bin from the sources we will NOT adjust
        other_mus = mus.copy()
        other_mus[source_i] = 0.0
        u_bins = np.tensordot(other_mus, pmfs, axes=(0, 0))

        a_bins = np.asarray(n_model_events[source_i], dtype=float)
        n_mc_total = a_bins.sum()
        p_calibration = mus[source_i] / n_mc_total
        # Empty-MC bins (a == 0, so also pmf == 0) carry zero weight
        safe_a = np.where(a_bins > 0, a_bins, 1.0)
        w_calibration = np.where(a_bins > 0,
                                 pmfs[source_i] / safe_a * n_mc_total, 0.0)

        observed = self.data_events_per_bin.values
        A_bins_1, A_bins_2 = beeston_barlow_roots(
            a_bins, w_calibration * p_calibration, u_bins, observed)
        # The first root is the unphysical one (sqrt rounding can leave it
        # at +epsilon instead of exactly 0 when U == 0)
        assert np.all(A_bins_1 <= 1e-6 * np.maximum(1.0, np.abs(A_bins_2)))

        # U == 0 bins: the general solution is singular, use the special case
        A_special = (observed + a_bins) / (1.0 + p_calibration)
        A_bins = np.where(u_bins == 0, A_special, A_bins_2)
        A_bins = np.where(w_calibration > 0, A_bins, 0.0)
        # The physical root is >= 0 in exact arithmetic; clamp sqrt rounding
        assert np.all(A_bins >= -1e-6 * np.maximum(1.0, observed + a_bins))
        A_bins = np.maximum(A_bins, 0.0)

        raw = A_bins * w_calibration
        pmfs[source_i] = raw / raw.sum()
        mus[source_i] = raw.sum() * p_calibration
        return mus, pmfs

    def _compute_likelihood(self, mus, pmfs):
        """Sum over bins of Poisson logpmf(observed; sum_s mu_s pmf_s).
        Negative per-bin expectations (allow_negative sources) take a steep
        linear penalty, matching the compiled path. With 'bb_lite', each
        bin's total expectation carries the profiled lite scale and its
        constraint."""
        observed = self.data_events_per_bin.values
        if self.model_statistical_uncertainty_handling == 'bb_lite':
            # Consume the MC counts of the adjust_expectations call that
            # precedes us: never evaluate with counts of an earlier point
            nme, self._bb_lite_nme = self._bb_lite_nme, None
            if nme is None:
                raise RuntimeError(
                    "bb_lite _compute_likelihood needs the morphed MC "
                    "counts from the immediately preceding "
                    "adjust_expectations call")
            return bb_lite_logl_host(mus, pmfs, nme, observed)
        expected = np.tensordot(np.asarray(mus, dtype=float),
                                np.asarray(pmfs, dtype=float), axes=(0, 0))
        penalty = 1e6 * float(np.sum(np.minimum(expected, 0.0)))
        expected_pos = np.maximum(expected, np.finfo(float).tiny)
        return float(np.sum(xlogy(observed, expected_pos) - expected
                            - gammaln(observed + 1.0))) + penalty


# Host (numpy, float64) roots of the per-bin Beeston-Barlow quadratic; the
# torch twins live in ops/beeston_barlow.py.

def _bb_quadratic_parts(a, p, U, d):
    """Coefficients (A2, b) of the per-bin quadratic A2*x^2 + b*x + c with
    c = -U*a, plus s = sqrt(b^2 + 4*A2*U*a): every term of the discriminant
    is nonnegative, so it is cancellation-free."""
    a = np.asarray(a, dtype=float)
    A2 = p * (p + 1.0)
    b = U * (p + 1.0) - p * (a + d)
    s = np.sqrt(b * b + 4.0 * A2 * (U * a))
    return A2, b, s


def beeston_barlow_root1(a, p, U, d):
    """Unphysical root of the per-bin Beeston-Barlow quadratic (kept only
    for regression checking, like the reference)."""
    A2, b, s = _bb_quadratic_parts(a, p, U, d)
    tiny = np.finfo(float).tiny
    return np.where(b >= 0, -(b + s) / np.maximum(2.0 * A2, tiny),
                    -2.0 * U * a / np.maximum(s - b, tiny))


def beeston_barlow_root2(a, p, U, d):
    """Physical root of the per-bin Beeston-Barlow quadratic: the profiled
    per-bin MC expectation of one finite-statistics source among exact
    ones, in the cancellation-free form per sign of the linear coefficient
    (Citardauq for b >= 0)."""
    A2, b, s = _bb_quadratic_parts(a, p, U, d)
    tiny = np.finfo(float).tiny
    return np.where(b >= 0, 2.0 * U * a / np.maximum(b + s, tiny),
                    (s - b) / np.maximum(2.0 * A2, tiny))


def beeston_barlow_roots(a, p, U, d):
    return beeston_barlow_root1(a, p, U, d), beeston_barlow_root2(a, p, U, d)
