"""value_roofline_pct.bb: the summed least time of the traced window's
``binned_bb_ll_fused_multi`` calls (ll at A candidates a toy), by the
work their contract implies (``benchmark/harness/roofline.py``: lanes,
candidates, distinct corner rows, S, K, N), over the summed device time
of what those calls launched. Reported with the card's power limit
beside it (``device.power_limit_w``)."""

from benchmark.harness.roofline import BinnedCalls, share_pct

INTERPOSE = BinnedCalls('blueice_tpu_torch.ops.fused_bb',
                        'binned_bb_ll_fused_multi', 'value', mc_rows=True)


def read(run):
    return share_pct(run, INTERPOSE)
