"""The traced run's records: ``torch.profiler``'s timeline of the traced
window, reduced to what the per-layer readers read.

The benchmark marks its own spans with ``record_function``:
``bench.window`` (the traced window), ``bench.study`` (one call of the
study), ``bench.draw`` (the harness drawing a call's datasets),
``bench.wrapper.<name>`` (one kernel-wrapper call, :mod:`.roofline`) and
``bench.record`` (the harness's own bookkeeping, left out of every device
figure). Each device operation is put under the innermost span that was
open on the host when it was launched (matched through the profiler's
correlation ids); one under ``bench.study`` and no deeper span was launched
by the Newton loop's host glue."""

import collections

__all__ = ['Records', 'records_of', 'reduce_profile', 'busy_and_gaps']

#: The innermost span's name -> the label of what the host was doing
LABELS = {'bench.study': 'newton_loop_glue', 'bench.draw': 'harness_draw',
          'bench.record': 'harness_record', 'bench.window': 'between_calls'}
_DEVICE_KINDS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def _label(span):
    if span is None:
        return 'outside_window'
    if span.startswith('bench.wrapper.'):
        return 'wrapper.' + span[len('bench.wrapper.'):]
    return LABELS.get(span, span)


class Records:
    """What a traced window left: ``window_s``; ``busy_s`` (the union of
    the device operations' intervals); ``ops``, a list of (name, seconds,
    label, span index, kind, start, end) of each device operation;
    ``gaps``, (label, seconds) of each idle stretch of the device;
    ``spans``, (name, start, end) of the benchmark's spans; ``toys`` and
    ``n_iter`` (the fits' Newton iterations) of the window's calls;
    ``interposers`` by wrapper name (:class:`~.roofline.BinnedCalls`)."""

    def __init__(self, window_s, busy_s, ops, gaps, spans, toys=0,
                 n_iter=(), interposers=None):
        self.window_s, self.busy_s = window_s, busy_s
        self.ops, self.gaps, self.spans = ops, gaps, spans
        self.toys, self.n_iter = toys, list(n_iter)
        self.interposers = dict(interposers or {})

    def kernels(self):
        """The device kernels of the window, the harness's own left out."""
        return [o for o in self.ops
                if o[4] == 'kernel' and o[2] != 'harness_record']

    def wrapper_seconds(self, name):
        """Device seconds of each call of wrapper ``name`` (every operation
        launched inside the call's span), in call order."""
        per = collections.OrderedDict(
            (i, 0.0) for i, s in enumerate(self.spans)
            if s[0] == 'bench.wrapper.' + name)
        for o in self.ops:
            if o[3] in per:
                per[o[3]] += o[1]
        return list(per.values())

    def breakdown(self, top=10):
        """{'device_ops': [[name, s]], 'idle_gaps': [[label, s]]}: the
        operations that took the most device time, by name, and the idle
        time by what the host was doing, each the ``top`` largest."""
        by_op = collections.Counter()
        for o in self.ops:
            if o[2] != 'harness_record':
                by_op[o[0]] += o[1]
        by_gap = collections.Counter()
        for label, s in self.gaps:
            by_gap[label] += s
        return {'device_ops': [[n[:120], s]
                               for n, s in by_op.most_common(top)],
                'idle_gaps': [[n, s] for n, s in by_gap.most_common(top)]}


def _innermost(spans, times):
    """For each host time (sorted indices returned in input order), the
    index of the innermost span of ``spans`` [(name, start, end)] open at
    that time, or None. Spans nest (one host thread)."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    bounds = sorted([(s[1], 0, i) for i, s in enumerate(spans)]
                    + [(s[2], 1, i) for i, s in enumerate(spans)])
    out = [None] * len(times)
    stack, b = [], 0
    for i in order:
        t = times[i]
        while b < len(bounds) and bounds[b][0] <= t:
            _, kind, j = bounds[b]
            if kind == 0:
                stack.append(j)
            elif j in stack:
                stack.remove(j)
            b += 1
        out[i] = stack[-1] if stack else None
    return out


def reduce_profile(prof):
    """(spans, ops, window) of a stopped ``torch.profiler.profile``: the
    benchmark's host spans, each device operation as (name, seconds,
    label, span index, kind, start_ns, end_ns), and the ``bench.window``
    span's (start_ns, end_ns)."""
    from torch.autograd import DeviceType
    spans, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        kind = e.activity_type() if hasattr(e, 'activity_type') else ''
        if e.device_type() == DeviceType.CPU:
            if name.startswith('bench.'):
                spans.append((name, e.start_ns(), e.end_ns()))
            elif kind in ('cuda_runtime', 'cuda_driver') or (
                    'Launch' in name or 'Memcpy' in name
                    or 'Memset' in name):
                launches[e.correlation_id()] = e.start_ns()
        elif not name.startswith('bench.') and (
                kind in _DEVICE_KINDS or not kind):
            device.append((name, e.start_ns(), e.start_ns() + e.duration_ns(),
                           e.linked_correlation_id() or e.correlation_id(),
                           kind or 'kernel'))
    spans.sort(key=lambda s: (s[1], -s[2]))
    window = next(((s[1], s[2]) for s in spans if s[0] == 'bench.window'),
                  None)
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    host_t = [launches.get(d[3], d[1]) for d in device]
    where = _innermost(spans, host_t)
    ops = []
    for d, j in zip(device, where):
        label = _label(None if j is None else spans[j][0])
        if d[2] <= window[0] or d[1] >= window[1]:
            continue
        ops.append((d[0], (min(d[2], window[1]) - max(d[1], window[0])) / 1e9,
                    label, j, d[4], max(d[1], window[0]),
                    min(d[2], window[1])))
    return spans, ops, window


def busy_and_gaps(spans, ops, window):
    """(busy seconds, [(label, idle seconds)]) of the device over the
    window: the union of the operations' intervals (the harness's own left
    out), and each stretch between them, labelled by what the host was doing
    when it began (the innermost span open then)."""
    iv = sorted((o[5], o[6]) for o in ops if o[2] != 'harness_record')
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) / 1e9
    starts, lengths, t = [], [], window[0]
    for a, b in merged + [[window[1], window[1]]]:
        if a > t:
            starts.append(t)
            lengths.append(a - t)
        t = max(t, b)
    where = _innermost(spans, starts)
    gaps = [(_label(None if j is None else spans[j][0]), n / 1e9)
            for j, n in zip(where, lengths)]
    return busy, gaps


def records_of(prof, toys, n_iter, interposers):
    """The :class:`Records` of a stopped profiler over one traced window.
    The window's length leaves out the device's idle stretches that began
    while the harness kept its books (``bench.record``): an untraced run
    has none."""
    spans, ops, window = reduce_profile(prof)
    busy, gaps = busy_and_gaps(spans, ops, window)
    books = sum(s for label, s in gaps if label == 'harness_record')
    return Records((window[1] - window[0]) / 1e9 - books, busy, ops,
                   [g for g in gaps if g[0] != 'harness_record'], spans,
                   toys=toys, n_iter=n_iter,
                   interposers={i.name: i for i in interposers})

