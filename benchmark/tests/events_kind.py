"""An event-set likelihood kind, written as new files into a throwaway
checkout (:func:`add`): a tiny 1-D two-source unbinned likelihood run
through the port's ``UnbinnedToyStudy``, with its configuration, traffic
mix, cell and limits. It proves that the harness takes a kind as new files;
its reference is the port's host likelihood and a scipy fit, which is
enough for that and no yardstick of accuracy."""

import json
import shutil

CELL = 'tiny_events.events_mix'

#: The configuration: two Gaussian Monte-Carlo sources on one axis, a rate
#: parameter each (the background's constrained)
CONFIG = {
    "name": "tiny_events", "source": "test", "reduced": [], "assumed": {},
    "likelihood": "events", "dtype": "float64",
    "space": [-5.0, 5.0, 40], "template_seed": 0, "mc_events": 20000,
    "sources": [{"name": "sig", "events_per_day": 20.0, "mu": 0.5,
                 "sigma": 0.6},
                {"name": "bkg", "events_per_day": 100.0, "mu": -1.0,
                 "sigma": 2.0}],
    "rate_parameters": [{"source": "sig"},
                        {"source": "bkg", "normal_prior": [1.0, 0.1]}],
}
MIX = {"name": "events_mix", "kind": "closed_loop_ensemble",
       "toys_per_call": 12, "truth": {"sig_rate_multiplier": 1.0},
       "target": "sig_rate_multiplier", "hypothesis": 1.0, "check_toys": 8}

#: The port's host likelihood of the configuration, in both modules
HOST_LIKELIHOOD = '''
def host_likelihood(config, cache_dir):
    """The port's prepared UnbinnedLogLikelihood of the configuration."""
    import numpy as np
    from blueice_tpu_torch.likelihood import UnbinnedLogLikelihood
    from blueice_tpu_torch.priors import NormalPrior
    from blueice_tpu_torch.test_helpers import GaussianMCSource
    lo, hi, n = config['space']
    np.random.seed(config['template_seed'])
    lf = UnbinnedLogLikelihood(dict(
        analysis_space=[['x', np.linspace(lo, hi, n + 1)]],
        default_source_class=GaussianMCSource,
        sources=[dict(s) for s in config['sources']], livetime_days=1.0,
        n_events_for_pdf=config['mc_events'], some_multiplier=1,
        strlen_multiplier='q', cache_dir=os.path.join(cache_dir, 'pdf'),
        task_dir=os.path.join(cache_dir, 'tasks')))
    for r in config['rate_parameters']:
        prior = r.get('normal_prior')
        lf.add_rate_parameter(r['source'], log_prior=(
            NormalPrior(*prior) if prior else None))
    lf.prepare()
    return lf
'''

SYSTEM = '''"""The event-set kind's system: the port's UnbinnedToyStudy."""

import os
''' + HOST_LIKELIHOOD + '''

def build_study(config, device, cache_dir, dtype):
    from blueice_tpu_torch.parallel.toys import UnbinnedToyStudy
    lf = host_likelihood(config, cache_dir)
    return lf, UnbinnedToyStudy(lf, dtype=dtype, device=device)
'''

REFERENCE = '''"""The event-set kind's reference: the host likelihood at a
point, a scipy fit; its datasets are (coords, mask, bins) event sets."""

import os

import numpy as np
import torch
''' + HOST_LIKELIHOOD + '''

class Model:
    def __init__(self, config):
        self.lf = host_likelihood(config, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), os.pardir,
            os.pardir, 'build', 'events_reference'))
        self.names = ['%s_rate_multiplier' % r['source']
                      for r in config['rate_parameters']]
        self.defaults = np.ones(len(self.names))
        self.edges = np.linspace(config['space'][0], config['space'][1],
                                 config['space'][2] + 1)

    def ll(self, x, events):
        self.lf.set_data(events)
        return float(self.lf(**dict(zip(self.names, x))))

    def loglik_at(self, x, data):
        return np.array([self.ll(xi, ev) for xi, ev in zip(x, data)])


def build(config, device='cpu', storage=torch.float64):
    return Model(config)


def sampler(model, truth, toys, device, dtype):
    """Event sets as the port draws them: a Poisson count of events, each
    in a bin drawn by its expectation, uniform inside it."""
    sources = model.lf.base_model.sources
    mus = model.lf.base_model.expected_events()
    weights = sum(
        mu * truth[model.names.index(s.name + '_rate_multiplier')]
        * np.asarray(s._pdf_histogram.values) * np.diff(model.edges)
        for s, mu in zip(sources, mus))
    f64 = torch.float64
    cdf = torch.cumsum(torch.as_tensor(weights, dtype=f64, device=device), 0)
    total = cdf[-1]
    n_max = int(total + 6 * (total + 1) ** 0.5 + 10)
    edges = torch.as_tensor(model.edges, dtype=f64, device=device)

    def draw(gen):
        n = torch.poisson(total.expand(toys).contiguous(), generator=gen)
        mask = (torch.arange(n_max, device=device)[None, :]
                < torch.clamp(n, max=n_max)[:, None])
        u = torch.rand((2, toys, n_max), generator=gen, dtype=f64,
                       device=device)
        bins = torch.clamp(torch.searchsorted(cdf, (u[0] * total)
                                              .contiguous()),
                           max=len(cdf) - 1)
        x = edges[bins] + u[1] * (edges[bins + 1] - edges[bins])
        return x[..., None], mask, bins[..., None]
    return draw


def take(datasets, rows):
    coords, mask, _ = datasets
    out = []
    for r in rows:
        ev = np.zeros(int(mask[r].sum()), dtype=[('x', float),
                                                 ('source', int)])
        ev['x'] = coords[r, mask[r], 0].cpu().numpy()
        out.append(ev)
    return out


def join(parts):
    return [ev for part in parts for ev in part]


def profile_fits(model, data, target, hypothesis, x_judged=None):
    from scipy.optimize import minimize
    P, ti = len(model.names), model.names.index(target)
    out = {k: [] for k in ('x_free', 'll_free', 'x_cond', 'll_cond')}
    for i, events in enumerate(data):
        for j, key in enumerate(('free', 'cond')):
            free = [p for p in range(P) if key == 'free' or p != ti]

            def point(z):
                x = np.full(P, float(hypothesis))
                x[free] = z
                return x
            starts = [model.defaults] + (
                [] if x_judged is None else [np.asarray(x_judged)[i, j]])
            best = min((minimize(lambda z: -model.ll(point(z), events),
                                 np.asarray(s, float)[free],
                                 method='L-BFGS-B',
                                 bounds=[(1e-9, None)] * len(free))
                        for s in starts), key=lambda r: r.fun)
            out['x_' + key].append(point(best.x))
            out['ll_' + key].append(-best.fun)
    res = {k: np.array(v) for k, v in out.items()}
    res['t'] = np.maximum(2.0 * (res['ll_free'] - res['ll_cond']), 0.0)
    return res
'''


def add(root):
    """Write the kind, its configuration, mix, cell (:data:`CELL`) and
    limits into the checkout ``root`` as new files and entries."""
    bench = root / 'benchmark'
    (bench / 'reference' / 'events.py').write_text(REFERENCE)
    (bench / 'harness' / 'systems' / 'events.py').write_text(SYSTEM)
    (bench / 'configs' / 'tiny_events.json').write_text(json.dumps(CONFIG))
    (bench / 'traffic' / 'events_mix.json').write_text(json.dumps(MIX))
    shutil.copy(bench / 'limits' / 'xenon.ensemble.json',
                bench / 'limits' / (CELL + '.json'))
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    spec['configs'].append({'name': 'tiny_events', 'source': 'test',
                            'file': 'benchmark/configs/tiny_events.json',
                            'reduced': [], 'why': 'test'})
    spec['workloads'].append({'name': CELL, 'config': 'tiny_events',
                              'traffic': 'events_mix', 'chips': 1,
                              'why': 'test'})
    for m in spec['end_to_end']:
        if 'workloads' in m:
            m['workloads'].append(CELL)
    for m in spec['per_layer']:
        if m['name'] in ('iters_per_fit', 'median_t'):
            m['workloads'].append(CELL)
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
