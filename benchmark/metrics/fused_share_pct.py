"""fused_share_pct: the share of the card's busy time in the traced window
spent in operations launched inside the port's kernel-wrapper calls (every
wrapper a roofline reader of the cell interposes on: the kernel and the
wrapper's own table-building operations)."""


def read(run):
    rec = run.trace
    if rec is None or rec.busy_s <= 0 or not rec.interposers:
        return None
    inside = sum(o[1] for o in rec.ops if o[2].startswith('wrapper.'))
    return 100.0 * inside / rec.busy_s if inside > 0 else None
