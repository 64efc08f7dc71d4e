"""CLs exclusion limits on the compiled profile-likelihood engines.

The modified-frequentist CLs prescription (A. Read, J.Phys.G 28 (2002) 2693)
is the standard exclusion convention of the field the reference serves; with
blueice, users assemble it by hand from per-hypothesis toy loops over
``bestfit_*`` calls (there is no CLs code in the reference — its inference
layer stops at Wilks/Neyman intervals, blueice/inference.py:332-389). Here
the three ingredients are each batched fits on the study's device (the
counterpart of :mod:`blueice_tpu.parallel.cls`):

- the observed one-sided q_mu curve over the hypothesis grid
  (:meth:`~blueice_tpu_torch.parallel.toys.BinnedToyStudy.profile_map`),
- the signal+background calibration ensembles, one per hypothesis, each
  simulated at that hypothesis (``profile_ts_scan``),
- ONE background-only ensemble profiled across the whole grid with a single
  free fit per toy (``profile_ts_grid``).

CLs(mu) = CLsb / CLb with CLsb = P(q_mu >= q_obs | mu), CLb = P(q_mu >=
q_obs | 0); the upper limit is the first downcrossing of CLs below
alpha = 1 - cl. The expected (median / band) limits reuse the SAME two toy
ensembles: each background-only toy's q_mu row plays the observed curve.
"""

import numpy as np

from ._stats import simulation_truth, tail_fraction
from .toys import child_seed, seed_of

__all__ = ['cls_curve', 'cls_upper_limit', 'cls_expected_band']


def _one_sided_qmu(ts, x_hat, hyps):
    """One-sided q_mu: an upward best-fit fluctuation past the tested mu is
    not evidence against mu as an upper limit, so q_mu = 0 there.

    :param ts: (H, N) or (H,) profile-LR statistics.
    :param x_hat: (N,) or scalar best-fit target values.
    :param hyps: (H,) hypotheses.
    """
    ts = np.asarray(ts, dtype=float)
    x_hat = np.asarray(x_hat, dtype=float)
    if ts.ndim == 1:
        return np.where(x_hat <= hyps, ts, 0.0)
    return np.where(x_hat[None, :] <= hyps[:, None], ts, 0.0)


def cls_curve(study, seed_or_generator, target, hypotheses, n_toys,
              counts=None, truth=None, fixed=None, mesh=None, null=0.0):
    """Observed CLs, CLsb and CLb at each hypothesis.

    :param seed_or_generator: int seed or torch.Generator (one int seed
      drawn at entry): the signal+background ensembles take its child
      seeds (:meth:`profile_ts_scan`), the background-only ensemble the
      child seed ``child_seed(seed, _B_ONLY_SALT)``.
    :param counts: observed count tensor(s) (binned studies; default: the
      likelihood's ``set_data`` dataset, either study type).
    :param truth: background model parameters for the calibration ensembles
      (the target is overridden per-ensemble); default config values.
      ``fixed`` values are folded in (explicit ``truth`` entries win):
      parameters held fixed in the fits must be simulated at those values
      or the calibration belongs to a different model.
    :param null: the background-only value of the target (0 for a rate).
    :return: dict with 'hypotheses' (sorted ascending), 'q_obs', 'cls',
      'clsb', 'clb', 'x_hat' (observed best fit), and the calibration
      statistics 'q_sb' / 'q_b' ((H, n_toys) each, one-sided).
    """
    hyps = np.sort(np.asarray(hypotheses, dtype=float))
    if hyps.ndim != 1 or len(hyps) < 2:
        raise ValueError("hypotheses must be a 1-d grid of >= 2 values")
    truth = simulation_truth(truth, fixed)
    seed = seed_of(seed_or_generator)

    # Observed one-sided q_mu curve: one free fit + one batched
    # conditional fit over the grid
    map_kwargs = {'fixed': fixed}
    if counts is not None:
        if not hasattr(study, 'observed_counts'):
            raise ValueError(
                "counts= applies to binned studies; unbinned observed data "
                "is bound with lf.set_data")
        map_kwargs['counts'] = counts
    t_obs, free_obs, _ = study.profile_map([(target, hyps)], **map_kwargs)
    x_hat = float(np.asarray(free_obs[target])[0])
    q_obs = _one_sided_qmu(np.asarray(t_obs).ravel(), x_hat, hyps)

    # Signal+background calibration: one fresh ensemble per hypothesis,
    # simulated AT that hypothesis (the standard construction)
    ts_sb, frees_sb = study.profile_ts_scan(
        seed, target, hyps, n_toys, fixed=fixed, mesh=mesh, truth=truth,
        truth_at_hypothesis=True, return_free=True)
    q_sb = np.stack([
        _one_sided_qmu(ts_sb[j], np.asarray(frees_sb[j][target]), hyps[j])
        for j in range(len(hyps))])

    # Background-only calibration: ONE ensemble, one free fit per toy,
    # conditional fits reused across the grid
    b_truth = dict(truth)
    b_truth[target] = float(null)
    ts_b, _, free_b, _ = study.profile_ts_grid(
        child_seed(seed, _B_ONLY_SALT), target, hyps, n_toys,
        truth=b_truth, fixed=fixed, mesh=mesh, return_cond=False)
    q_b = _one_sided_qmu(ts_b, np.asarray(free_b[target]), hyps)

    clsb = np.empty(len(hyps))
    clb = np.empty(len(hyps))
    for j in range(len(hyps)):
        clsb[j] = tail_fraction(np.sort(q_sb[j]), q_obs[j])
        clb[j] = tail_fraction(np.sort(q_b[j]), q_obs[j])
    cls = clsb / clb
    return {'hypotheses': hyps, 'q_obs': q_obs, 'cls': cls, 'clsb': clsb,
            'clb': clb, 'x_hat': x_hat, 'q_sb': q_sb, 'q_b': q_b}


_B_ONLY_SALT = 987654321


def _cls_crossing(hyps, cls, alpha):
    """First downcrossing of the CLs curve below alpha, linearly
    interpolated; NaN if it never crosses inside the grid. Monte-Carlo
    noise can make the curve locally non-monotone, so take the FIRST
    crossing (the conservative, smallest excluded mu)."""
    below = cls <= alpha
    if below[0]:
        return float(hyps[0])
    if not below.any():
        return float('nan')
    j = int(np.argmax(below))
    c0, c1 = cls[j - 1], cls[j]
    if c1 == c0:
        return float(hyps[j])
    w = (c0 - alpha) / (c0 - c1)
    return float(hyps[j - 1] + w * (hyps[j] - hyps[j - 1]))


def cls_upper_limit(study, seed_or_generator, target, hypotheses, n_toys,
                    cl=0.9, counts=None, truth=None, fixed=None, mesh=None,
                    null=0.0, return_curve=False):
    """Observed CLs upper limit: the smallest mu with CLs(mu) <= 1 - cl.

    CLs >= CLsb always, so this limit is never tighter than the plain
    frequentist (CLsb) one — the protection against excluding signals the
    experiment has no sensitivity to that the prescription exists for.

    :return: float; with ``return_curve``, (float, the :func:`cls_curve`
      dict). NaN (with the curve, for diagnosis) if CLs never reaches
      alpha inside the grid — widen the grid.
    """
    curve = cls_curve(study, seed_or_generator, target, hypotheses, n_toys,
                      counts=counts, truth=truth, fixed=fixed, mesh=mesh,
                      null=null)
    ul = _cls_crossing(curve['hypotheses'], curve['cls'], 1.0 - cl)
    return (ul, curve) if return_curve else ul


def cls_expected_band(study, seed_or_generator, target, hypotheses, n_toys,
                      cl=0.9, truth=None, fixed=None, mesh=None, null=0.0,
                      quantiles=(0.025, 0.16, 0.5, 0.84, 0.975)):
    """Expected CLs limit band: per-toy CLs limits over the background-only
    ensemble, reusing the SAME calibration ensembles as :func:`cls_curve`
    (each background-only toy's q_mu row plays the observed curve — no
    additional device work beyond one curve construction).

    The band shows CLs's defining shape: the low quantiles compress against
    the sensitivity floor (CLs never excludes below it) while deficit toys
    stretch the high quantiles. With small ``n_toys`` the most extreme
    deficit toys can fail to cross at all (their CLsb floors at the add-one
    minimum ~1/n while their CLb sits there too, so CLs stays ~1): those
    limits come back +inf. They are a finite-calibration artifact — raise
    ``n_toys`` (it is both the band population and the calibration sample)
    or widen the grid before reading the outer quantiles.

    :return: dict with 'limits' ((n_toys,), NaN -> +inf for beyond-grid),
      'band' (OrderedDict quantile -> limit), 'n_beyond_grid', 'curve'.
    """
    from .limits import _band_from_limits

    curve = cls_curve(study, seed_or_generator, target, hypotheses, n_toys,
                      truth=truth, fixed=fixed, mesh=mesh, null=null,
                      # the observed dataset is irrelevant for the band; the
                      # b-only ensemble is the "observed" population. Feed
                      # the set_data dataset if bound, else expected counts
                      counts=_band_counts(study))
    hyps, q_sb, q_b = curve['hypotheses'], curve['q_sb'], curve['q_b']
    H, n = q_b.shape
    clsb_all = np.empty((H, n))
    clb_all = np.empty((H, n))
    for j in range(H):
        clsb_all[j] = tail_fraction(np.sort(q_sb[j]), q_b[j])
        # Leave-one-out CLb — each toy is excluded from its own calibration
        # (left in, the add-one estimator double-counts it and biases CLb
        # high). Counting >= entries in the FULL sorted sample and dropping
        # the toy's own (always >=) entry equals the delete-and-recount,
        # without n re-sorts of the n-element sample per hypothesis.
        b_sorted = np.sort(q_b[j])
        idx = np.searchsorted(b_sorted, q_b[j] * (1.0 - 1e-12) - 1e-12,
                              side='left')
        clb_all[j] = (1.0 + (n - idx) - 1.0) / (1.0 + (n - 1))
    cls_all = clsb_all / clb_all
    lims = np.array([_cls_crossing(hyps, cls_all[:, i], 1.0 - cl)
                     for i in range(n)])
    out = _band_from_limits(np.where(np.isnan(lims), np.inf, lims),
                            quantiles)
    out['curve'] = curve
    return out


def _band_counts(study):
    """A placeholder observed dataset for band construction: the band never
    reads the observed CLs, but cls_curve's map needs SOME dataset. Use the
    bound set_data one when present, else (binned) the expected counts."""
    if not hasattr(study, 'expected_counts'):
        return None            # unbinned: set_data is required anyway
    try:
        study.observed_counts()
        return None            # set_data bound — default path works
    except ValueError:
        return study.expected_counts()
