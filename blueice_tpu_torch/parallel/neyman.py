"""Toy-calibrated (Neyman) confidence intervals.

The reference exposes a ``t_ppf`` hook in ``one_parameter_interval`` for users
who construct their own test-statistic distributions (reference:
blueice/inference.py:341-343,365-367) — but leaves the construction itself,
the expensive part, to the user (thousands of toy fits per hypothesis).
Here the construction IS the framework: a hypothesis scan of the batched
profile-LR toy study (one batched double fit per hypothesis, on the study's
device) produces the critical-value surface, which then plugs straight back
into ``one_parameter_interval``. The counterpart of
:mod:`blueice_tpu.parallel.neyman`.
"""

import numpy as np

from ._stats import simulation_truth

__all__ = ['NeymanConstruction']


class NeymanConstruction:
    """Critical values of the profile-LR statistic from toy ensembles.

    Usage::

        study = BinnedToyStudy(lf)                  # prepared likelihood
        nc = NeymanConstruction(study, 'wimp_rate_multiplier')
        nc.scan(0, hypotheses=np.linspace(0, 5, 11), n_toys=2000)
        lf.set_data(observed_events)
        ul = lf.one_parameter_interval('wimp_rate_multiplier', bound=10,
                                       kind='upper', confidence_level=0.9,
                                       t_ppf=nc.t_ppf)
    """

    def __init__(self, study, target, fixed=None, truth=None, mesh=None,
                 statistic='two-sided'):
        """:param statistic: which test statistic to calibrate.
          'two-sided' (default): t = max(2(LL_free - LL_cond), 0); its
          critical values are mapped to the one-sided level via |2q-1|
          (exact in the symmetric/Wilks regime — see :meth:`t_ppf`).
          'upper' / 'lower': the one-sided statistic (t where the best fit
          lies below / above the hypothesis, else 0 — the q-tilde family).
          Calibrating P(t_one-sided > c) = 1 - CL is exact for the
          corresponding limit kind even when up/down fluctuations split
          asymmetrically; use statistic='upper' with kind='upper' etc."""
        if statistic not in ('two-sided', 'upper', 'lower'):
            raise ValueError("statistic must be 'two-sided', 'upper' or "
                             "'lower'")
        self.study = study
        self.target = target
        self.fixed = dict(fixed or {})
        # Parameters held fixed in the fits are simulated at those values
        # too (explicit truth entries win) — the calibration ensembles must
        # belong to the same model as the fits that evaluate them
        self.truth = simulation_truth(truth, fixed)
        self.mesh = mesh
        self.statistic = statistic
        self.hypotheses = None
        self.t_sorted = None

    def scan(self, seed_or_generator, hypotheses, n_toys=1000):
        """Run the toy ensembles: for each hypothesis h, simulate n_toys
        datasets with target=h (each from a child seed of
        ``seed_or_generator``, see :meth:`~blueice_tpu_torch.parallel.toys.
        BinnedToyStudy.profile_ts_scan`) and collect the profile-LR
        distribution.
        The hypothesis grid is sorted internally (np.interp over a
        non-monotonic grid would silently return nonsense)."""
        hypotheses = np.asarray(hypotheses, dtype=float)
        order = np.argsort(hypotheses)
        self.hypotheses = hypotheses[order]
        ts, frees = self.study.profile_ts_scan(
            seed_or_generator, self.target, self.hypotheses, n_toys,
            fixed=self.fixed, mesh=self.mesh, truth=self.truth,
            truth_at_hypothesis=True, return_free=True)
        if self.statistic != 'two-sided':
            # One-sided statistic: zero the toys whose best fit lies on the
            # non-rejecting side of the hypothesis
            x_hat = np.stack([f[self.target] for f in frees])   # (H, T)
            h_col = self.hypotheses[:, None]
            keep = (x_hat < h_col) if self.statistic == 'upper' \
                else (x_hat > h_col)
            ts = np.where(keep, ts, 0.0)
        self.t_sorted = np.sort(ts, axis=1)
        return self

    def t_ppf(self, hypothesis, quantile):
        """Critical value: the toy-calibrated analog of Wilks'
        ``norm.ppf(quantile)**2`` at ``hypothesis`` (linear interpolation
        across the hypothesis grid). Signature matches the reference's t_ppf
        hook.

        The toy statistic t = max(2(LL_free - LL_cond), 0) is TWO-sided
        (up- and down-fluctuations both produce t > 0), while
        one_parameter_interval's quantile is the one-sided level (CL for
        upper limits, 1 - CL for lower, the tail probabilities for central).
        Wilks' default norm.ppf(q)^2 equals chi2(1).ppf(|2q - 1|), so the
        consistent toy quantile is |2q - 1| — e.g. a 90% upper limit uses the
        0.8-quantile of t (~1.64 in the Wilks regime), NOT the 0.9-quantile
        (~2.71), which would overcover (~95%). Exact when up/down
        fluctuations split evenly (the Wilks regime); a rejected-direction
        asymmetry shifts one-sided coverage accordingly.

        For ``statistic='upper'``/``'lower'`` the calibrated distribution is
        the one-sided statistic itself, so the critical value is its direct
        max(q, 1-q) quantile — exact one-sided coverage with no symmetry
        assumption: P(t_one-sided > c) = P(best fit on the rejecting side
        AND t > c) = 1 - CL by construction."""
        if self.t_sorted is None:
            raise RuntimeError("Call scan() first")
        # brentq in one_parameter_interval passes the quantile wrapped in a
        # sequence; accept scalars or length-1 containers
        quantile = float(np.asarray(quantile).reshape(-1)[0])
        if self.statistic == 'two-sided':
            quantile = abs(2.0 * quantile - 1.0)
        else:
            # upper limits pass q = CL, lower limits q = 1 - CL: both mean
            # the same one-sided level
            quantile = max(quantile, 1.0 - quantile)
        hypothesis = float(np.asarray(hypothesis).reshape(-1)[0])
        n = self.t_sorted.shape[1]
        # quantile within each hypothesis's sorted toy statistics
        pos = np.clip(quantile * (n - 1), 0, n - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        per_hyp = (1 - frac) * self.t_sorted[:, lo] \
            + frac * self.t_sorted[:, hi]
        # interpolate across hypotheses (constant beyond the scan range)
        h = np.clip(hypothesis, self.hypotheses[0], self.hypotheses[-1])
        return float(np.interp(h, self.hypotheses, per_hyp))

    def coverage_check(self, quantile=0.9):
        """Fraction of toys below their own hypothesis's critical value —
        should be ~|2*quantile - 1| for the two-sided statistic, resp.
        ~max(quantile, 1 - quantile) for the one-sided ones (see
        :meth:`t_ppf`). Sanity diagnostic."""
        crits = np.array([self.t_ppf(h, quantile) for h in self.hypotheses])
        return (self.t_sorted <= crits[:, None]).mean(axis=1)
