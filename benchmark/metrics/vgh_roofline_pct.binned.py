"""vgh_roofline_pct.binned: the summed least time of the traced window's
``binned_vgh_fused`` calls (ll, g and H at one point a toy), by the work
their contract implies (``benchmark/harness/roofline.py``: lanes,
candidates, distinct corner rows, S, K, N), over the summed device time
of what those calls launched. Reported with the card's power limit
beside it (``device.power_limit_w``)."""

from benchmark.harness.roofline import BinnedCalls, share_pct

INTERPOSE = BinnedCalls('blueice_tpu_torch.ops.fused',
                        'binned_vgh_fused', 'vgh', mc_rows=False)


def read(run):
    return share_pct(run, INTERPOSE)
