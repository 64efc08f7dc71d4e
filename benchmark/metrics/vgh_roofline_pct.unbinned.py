"""vgh_roofline_pct.unbinned: the summed least time of the traced window's
``unbinned_vgh_fused`` calls (ll, g and H at one point a toy), by the work
their contract implies (``benchmark/harness/unbinned_roofline.py``: lanes,
each lane's distinct corner rows over its valid events, the lanes' masks
and valid events, S, K), over the summed device time of what those calls
launched. Reported with the card's power limit beside it
(``device.power_limit_w``)."""

from benchmark.harness.roofline import share_pct
from benchmark.harness.unbinned_roofline import UnbinnedCalls

INTERPOSE = UnbinnedCalls('unbinned_vgh_fused', 'vgh')


def read(run):
    return share_pct(run, INTERPOSE)
