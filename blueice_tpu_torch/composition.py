"""Likelihood composition: joint sums, re-parametrisations, and analytic
constraint terms.

Counterpart of :mod:`blueice_tpu.composition` (the reference's
``LogLikelihoodSum``, ``LogLikelihoodReParam`` and
``LogAncillaryLikelihood``, blueice/likelihood.py), built around two ideas:

* a **routing table** (:class:`LogLikelihoodSum`): each child's declared
  parameter names are recorded once at construction; evaluation filters the
  caller's kwargs through that table, so one flat parameter namespace drives
  all children.
* a **parameter transform** (:class:`ParameterTransform`): the
  re-parametrisation is a pure map ``new params -> target rate multipliers``
  built from user functions normalized at the base point. Written with
  ordinary arithmetic, it computes on floats and on torch tensors alike,
  which gives the re-parametrised likelihood its compiled path
  (:func:`blueice_tpu_torch.compile.build_logl` takes every class here).

All three classes expose the common likelihood interface (``__call__``,
``rate_parameters`` / ``shape_parameters``, ``get_bounds``) so they compose
with each other.
"""

from collections import OrderedDict
from copy import deepcopy

import numpy as np

from .exceptions import InvalidParameter, InvalidParameterSpecification

__all__ = ['LogLikelihoodSum', 'LogLikelihoodReParam',
           'LogAncillaryLikelihood', 'ParameterTransform',
           'correlated_gaussian_constraint']

RATE_SUFFIX = '_rate_multiplier'


class _HostState:
    """Pickles without the device cache of
    :func:`blueice_tpu_torch.compile.cached_logl` (tensors on a device are
    never pickled; the next fit compiles anew)."""

    def __getstate__(self):
        state = dict(self.__dict__)
        state.pop('_torch_compiled_for_fit', None)
        return state


def declared_parameter_names(lf):
    """The flat parameter names a likelihood responds to: its rate multipliers
    (with suffix) and its shape parameters."""
    return ([name + RATE_SUFFIX for name in lf.rate_parameters]
            + list(lf.shape_parameters))


class LogLikelihoodSum(_HostState):
    """Several likelihoods fitted jointly as one term.

    Parameters are routed by name: a kwarg reaches exactly the children that
    declared it. Optional per-child weights de-weight e.g. a constraint term
    shared between N sub-volume likelihoods (weight 1/N).
    """

    def __init__(self, likelihood_list, likelihood_weights=None):
        self.likelihood_list = list(likelihood_list)
        if likelihood_weights is None:
            likelihood_weights = [1] * len(self.likelihood_list)
        if len(likelihood_weights) != len(self.likelihood_list):
            raise InvalidParameterSpecification(
                "Need one weight per likelihood (%d != %d)"
                % (len(likelihood_weights), len(self.likelihood_list)))
        self.likelihood_weights = likelihood_weights

        # Routing table: child index -> its declared parameter names
        self.likelihood_parameters = [declared_parameter_names(ll)
                                      for ll in self.likelihood_list]

        # Aggregated registries; on a name clash the later child wins, and its
        # base-config value becomes the default-guess hint
        self.rate_parameters = {}
        self.shape_parameters = {}
        self.source_name_list = []    # union, first occurrence kept
        self.pdf_base_config = {}
        for ll in self.likelihood_list:
            self.rate_parameters.update(ll.rate_parameters)
            self.shape_parameters.update(ll.shape_parameters)
            for sn in getattr(ll, 'source_name_list', ()):
                if sn not in self.source_name_list:
                    self.source_name_list.append(sn)
            for setting in (*ll.rate_parameters, *ll.shape_parameters):
                hint = ll.pdf_base_config.get(setting)
                if hint is not None:
                    self.pdf_base_config[setting] = hint

    def _kwargs_for(self, i, kwargs):
        declared = self.likelihood_parameters[i]
        return {k: v for k, v in kwargs.items() if k in declared}

    def __call__(self, compute_pdf=False, livetime_days=None, **kwargs):
        total = 0.
        for i, (ll, weight) in enumerate(zip(self.likelihood_list,
                                             self.likelihood_weights)):
            livetime = (livetime_days[i]
                        if isinstance(livetime_days, (list, tuple))
                        else livetime_days)
            total += weight * ll(compute_pdf=compute_pdf,
                                 livetime_days=livetime,
                                 **self._kwargs_for(i, kwargs))
        return total

    def split_results(self, result_dict):
        """Per-child dicts of the entries of a joint fit result."""
        return [self._kwargs_for(i, result_dict)
                for i in range(len(self.likelihood_list))]

    def get_bounds(self, parameter_name=None):
        """Joint bounds: the intersection over the children that declare the
        parameter."""
        if parameter_name is None:
            return [self.get_bounds(p) for p in self.shape_parameters]
        if parameter_name in self.shape_parameters:
            lows, highs = zip(*(ll.get_bounds(parameter_name)
                                for ll in self.likelihood_list
                                if parameter_name in ll.shape_parameters))
            lo, hi = max(lows), min(highs)
            if hi <= lo:
                raise InvalidParameterSpecification(
                    "The children's bounds on %s do not overlap"
                    % parameter_name)
            return lo, hi
        if parameter_name.endswith(RATE_SUFFIX):
            source = parameter_name[:-len(RATE_SUFFIX)]
            rate_bounds = []
            for ll in self.likelihood_list:
                if (source in getattr(ll, 'rate_parameters', ())
                        or source in getattr(ll, 'source_name_list', ())):
                    # Delegate: an allow_negative source opens to (-inf, inf)
                    rate_bounds.append(ll.get_bounds(parameter_name)
                                       if hasattr(ll, 'get_bounds')
                                       else (0, float('inf')))
            if rate_bounds:
                lows, highs = zip(*rate_bounds)
                return max(lows), min(highs)
            # fall through: no child knows this source — surface the typo
        raise InvalidParameter("No parameter named %s in this likelihood" % parameter_name)


class ParameterTransform:
    """A pure, differentiable map from new parameters to target values.

    Each target is ``func(*inputs) / func(*base_inputs)`` — normalized so the
    base point maps to 1 (a rate *multiplier*). Works on floats and on torch
    tensors alike, so the same object serves the host path and the compiled
    path.
    """

    def __init__(self, targets, base_values):
        """
        :param targets: OrderedDict target name -> (input names tuple, func).
        :param base_values: {input name: its base (config) value}.
        """
        self.targets = OrderedDict(targets)
        self.base_values = dict(base_values)
        for target, (inputs, func) in self.targets.items():
            base = func(*[self.base_values[p] for p in inputs])
            if base == 0:
                raise InvalidParameterSpecification(
                    "Conversion function for %r evaluates to 0 at the base "
                    "point: the normalization func(inputs)/func(base) would "
                    "divide by zero" % target)

    @property
    def input_names(self):
        seen = OrderedDict()
        for inputs, _ in self.targets.values():
            for p in inputs:
                seen[p] = True
        return list(seen)

    def __call__(self, values):
        """{target: multiplier} for the given {input: value} dict (missing
        inputs take their base values)."""
        out = OrderedDict()
        for target, (inputs, func) in self.targets.items():
            xs = [values.get(p, self.base_values[p]) for p in inputs]
            base = [self.base_values[p] for p in inputs]
            out[target] = func(*xs) / func(*base)
        return out


class LogLikelihoodReParam(_HostState):
    """A likelihood under new parameters.

    ``conv_config`` declares (a) target rate multipliers of the wrapped
    likelihood as functions of new parameters, and (b) the new parameters
    themselves as (anchors, log_prior, base_value) triples — e.g. EFT
    couplings whose event rates are quadratic/bilinear in the couplings::

        {'op0_rate_multiplier': {'params': ['np0'], 'func': lambda x: x**2},
         'np0': (np.linspace(0, 10, 3), None, None)}
    """

    def __init__(self, likelihood, conv_config):
        self._likelihood = likelihood
        self.conv_config = conv_config
        self.pdf_base_config = likelihood.pdf_base_config

        targets = OrderedDict()
        declared = OrderedDict()
        for key, spec in conv_config.items():
            if key.endswith(RATE_SUFFIX):
                targets[key] = (tuple(spec['params']), spec['func'])
            else:
                anchors, log_prior, base_value = spec
                declared[key] = ({z: z for z in anchors}, log_prior,
                                 base_value)
        self._new_parameters = declared

        used = {p for inputs, _ in targets.values() for p in inputs}
        assert used == set(declared), (
            "conv_config is inconsistent: parameters declared %s vs used by "
            "the conversion functions %s" % (sorted(declared), sorted(used)))
        absent = sorted(p for p in declared
                        if not self.pdf_base_config.get(p, False))
        assert not absent, (
            "New parameters %s need (nonzero) base values in the model config"
            % absent)

        self.transform = ParameterTransform(
            targets, {p: self.pdf_base_config.get(p) for p in used})

    # -- parameter registry views -------------------------------------------------

    @property
    def _build_version(self):
        """Payload version of the wrapped likelihood, so a set_data() on
        the inner likelihood invalidates what was compiled through the
        wrapper too."""
        return ('reparam', getattr(self._likelihood, '_build_version', None))

    @property
    def rate_parameters(self):
        """The wrapped rate parameters minus those now derived via the
        transform."""
        return {name: prior
                for name, prior in self._likelihood.rate_parameters.items()
                if name + RATE_SUFFIX not in self.transform.targets}

    @property
    def shape_parameters(self):
        """The wrapped shape parameters plus the new ones."""
        merged = OrderedDict(deepcopy(self._likelihood.shape_parameters))
        merged.update(deepcopy(self._new_parameters))
        return merged

    def get_bounds(self, parameter_name=None):
        if parameter_name is None:
            return [self.get_bounds(p) for p in self.shape_parameters]
        if parameter_name in self._new_parameters:
            zs = list(self._new_parameters[parameter_name][0])
            return min(zs), max(zs)
        return self._likelihood.get_bounds(parameter_name)

    # -- evaluation -----------------------------------------------------------------

    def _to_wrapped_kwargs(self, kwargs):
        """Replace new-parameter kwargs by the transformed rate multipliers;
        everything else passes through."""
        inputs = set(self.transform.input_names)
        wrapped = dict(self.transform(kwargs))
        wrapped.update({k: v for k, v in kwargs.items() if k not in inputs})
        return wrapped

    def __call__(self, compute_pdf=False, livetime_days=None, **kwargs):
        return self._likelihood(compute_pdf=compute_pdf,
                                livetime_days=livetime_days,
                                **self._to_wrapped_kwargs(kwargs))

    def set_data(self, d):
        self._likelihood.set_data(d)

    # -- simulation under the new parameters -----------------------------------------

    @property
    def base_model(self):
        """The wrapped base model with ``simulate`` routed through the
        transform, so toys can be drawn at new-parameter points:
        ``base_model.simulate(kwargs=dict(np0=2))``. The patched copy is
        cached — deep-copying all source templates per property access made
        innocuous-looking attribute chains O(model size)."""
        cached = getattr(self, '_patched_base_model', None)
        if cached is None or cached[0] is not self._likelihood.base_model:
            model = deepcopy(self._likelihood.base_model)
            model.simulate = self._simulate
            cached = (self._likelihood.base_model, model)
            self._patched_base_model = cached
        return cached[1]

    def _simulate(self, kwargs=None, livetime_days=None):
        # Accept bare source names for rate multipliers (simulate convention)
        raw = {(k + RATE_SUFFIX if k in self._likelihood.rate_parameters
                else k): v
               for k, v in dict(kwargs or {}).items()}
        wrapped = self._to_wrapped_kwargs(raw)
        multipliers = {name[:-len(RATE_SUFFIX)]: value
                       for name, value in wrapped.items()
                       if name.endswith(RATE_SUFFIX)}
        return self._likelihood.base_model.simulate(
            rate_multipliers=multipliers, livetime_days=livetime_days)


class LogAncillaryLikelihood(_HostState):
    """An analytic constraint term with the standard likelihood interface, for
    composition via :class:`LogLikelihoodSum`.

    :param func: ``func(OrderedDict{name: value}, **func_kwargs) -> logl``.
    :param parameter_list: parameter names, in the order func expects them.
    :param config: default value per parameter.
    :param func_kwargs: extra keyword arguments passed to func.
    """

    def __init__(self, func, parameter_list, config=None, func_kwargs=None):
        self.func = func
        self.func_kwargs = dict(func_kwargs or {})
        self.pdf_base_config = dict(config or {})
        self.rate_parameters = {}
        # Every parameter is exposed as an unbounded shape parameter; other
        # likelihoods in a sum may constrain it further
        self.shape_parameters = OrderedDict(
            (name, (None, None, None)) for name in parameter_list)
        self.source_name_list = []

    def get_bounds(self, parameter_name=None):
        if parameter_name is None:
            return [self.get_bounds(p) for p in self.shape_parameters]
        if parameter_name not in self.shape_parameters:
            raise InvalidParameter(
                "No parameter named %s in this likelihood" % parameter_name)
        return -np.inf, np.inf

    def __call__(self, **kwargs):
        values = OrderedDict((name, kwargs.get(name,
                                               self.pdf_base_config[name]))
                             for name in self.shape_parameters)
        return self.func(values, **self.func_kwargs)


def correlated_gaussian_constraint(parameter_names, mean, cov):
    """A joint (correlated) Gaussian constraint over several parameters, as a
    :class:`LogAncillaryLikelihood` ready for :class:`LogLikelihoodSum`
    composition — the correlated generalization of per-parameter
    ``log_prior=NormalPrior(...)`` constraints, which the reference cannot
    express (its priors are strictly one callable per parameter,
    blueice/likelihood.py:488-504).

    Each named parameter defaults to its constraint mean; the term computes
    on torch tensors (one triangular solve), so summed likelihoods
    containing it compile end to end.

    :param parameter_names: parameters of the OTHER likelihoods in the sum
      this constraint correlates (rate multipliers or shape parameters).
    :param mean: constraint center per parameter.
    :param cov: covariance matrix (positive definite).
    """
    from .priors import MultivariateNormalPrior
    parameter_names = list(parameter_names)
    prior = MultivariateNormalPrior(mean, cov)
    if len(prior.mean) != len(parameter_names):
        raise ValueError("Got %d parameter names for a %d-dimensional "
                         "constraint" % (len(parameter_names),
                                         len(prior.mean)))
    return LogAncillaryLikelihood(
        func=prior, parameter_list=parameter_names,
        config=dict(zip(parameter_names, prior.mean)))
