"""Whether what the timed path produced is correct: the sampled toys of the
window judged against the float64 reference of the configuration's
likelihood kind (``benchmark/reference/<kind>.py``).

For each sampled toy the program's free and conditional fits (parameters
and maximum log likelihood) and its t are compared with the reference's on
the same dataset. Four numbers:

* ``ll_eval_gap``: the widest |program's log likelihood - the reference's
  at the program's parameters|, over the sample and both fits: the
  compiled likelihood (binned: morph, rates with live time and
  efficiency, constraints, Beeston-Barlow).
* ``t_eval_gap``: the widest |program's t - 2 (reference's log likelihood
  at the free fit's parameters - at the conditional fit's)|, floored at
  0 as t is: the statistic the program reports for its own fits.
* ``ll_fit_gap``: the median over the sample of how far short of the
  reference's maximum (the better fit of the two) the program's fits stop:
  the Newton fits on the body of the toys, where a fit that stops a little
  short everywhere shows.
* ``short_fit_share``: the share of the sample whose fits stop more than
  :data:`SHORT` short of the reference's maximum: the fits toy by toy,
  where a fault that leaves some toys unfitted shows. On about 1% of toys
  the port's fit stalls at an anchor kink (PERF.md), so a few toys of a
  sound run count here too, and the limit leaves room for them.

Each is held to the limit in ``benchmark/limits/<cell>.json``, which
``PERF.md`` derives from the readings of sound runs, of the
lower-precision control and of the planted faults (``faults.py``).
"""

import numpy as np

__all__ = ['NUMBERS', 'SHORT', 'full_points', 'judge', 'verdict']

NUMBERS = ('ll_eval_gap', 't_eval_gap', 'll_fit_gap', 'short_fit_share')
#: How far short of the reference's maximum (log-likelihood units) a toy's
#: fit counts as short in ``short_fit_share``: above the gaps of sound fits
#: (but for the kink's stalls) and of the control's, below those of a fit
#: that takes no step (PERF.md)
SHORT = 0.01


def full_points(names_fit, x, names_all, fixed):
    """(T, P) points in ``names_all`` order from a fit's (T, p) parameters
    named ``names_fit``, with the ``fixed`` {name: value} filled in."""
    x = np.asarray(x, dtype=float)
    out = np.empty((x.shape[0], len(names_all)))
    for j, n in enumerate(names_all):
        if n in names_fit:
            out[:, j] = x[:, names_fit.index(n)]
        else:
            out[:, j] = fixed[n]
    return out


def judge(reference, model, data, prog, target, hypothesis):
    """The four numbers of a sample of toys (``data``: the toys as the
    kind's ``reference`` module takes them, ``model`` its model) and the
    program's results ``prog``: dict of arrays over the sample, x_free /
    x_cond (T, P) in the reference's parameter order, ll_free, ll_cond, t.
    Returns (numbers, details)."""
    xf, xc = prog['x_free'], prog['x_cond']
    at_f = model.loglik_at(xf, data)
    at_c = model.loglik_at(xc, data)
    ref = reference.profile_fits(model, data, target, hypothesis,
                                 x_judged=np.stack([xf, xc], 1))
    eval_gap = np.maximum(np.abs(prog['ll_free'] - at_f),
                          np.abs(prog['ll_cond'] - at_c))
    t_eval_gap = np.abs(prog['t'] - np.maximum(2.0 * (at_f - at_c), 0.0))
    fit_gap = np.maximum(ref['ll_free'] - at_f, ref['ll_cond'] - at_c)
    numbers = {'ll_eval_gap': _worst(eval_gap),
               't_eval_gap': _worst(t_eval_gap),
               'll_fit_gap': (float(np.median(fit_gap))
                              if np.all(np.isfinite(fit_gap))
                              else float('inf')),
               'short_fit_share': (float(np.mean(~(fit_gap <= SHORT)))
                                   if fit_gap.size else float('inf'))}
    return numbers, dict(eval_gap=eval_gap, t_eval_gap=t_eval_gap,
                         fit_gap=fit_gap, t_gap=np.abs(prog['t'] - ref['t']),
                         fit_gap_free=ref['ll_free'] - at_f,
                         fit_gap_cond=ref['ll_cond'] - at_c, ref=ref)


def _worst(a):
    a = np.asarray(a, dtype=float)
    if not np.all(np.isfinite(a)):
        return float('inf')
    return float(a.max()) if a.size else float('inf')


def verdict(numbers, limits):
    """(correct, lines): every number at or under its limit; one line
    'name value <= limit' for each, in :data:`NUMBERS` order."""
    ok, lines = True, []
    for n in NUMBERS:
        v, lim = numbers[n], float(limits[n])
        good = v <= lim
        ok &= good
        lines.append('%s %r %s %r' % (n, v, '<=' if good else '>', lim))
    return ok, lines
