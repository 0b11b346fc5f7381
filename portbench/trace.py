"""What the profiler's slice says: device intervals, busy time, the
largest device operations and the idle gaps with what the host did.

``Slice.from_profile(prof, batches)`` reads a ``torch.profiler.profile``
that ran with CPU and CUDA activities around the slice's
``portbench.slice`` span; the benchmark's ``portbench.front`` and
``portbench.decode`` spans label what the host was in during a gap.
``Slice(ops, spans, start, end, batches)`` takes the same data as plain
lists, for tests. Times are in seconds.
"""

import bisect

SLICE, FRONT, DECODE = "portbench.slice", "portbench.front", \
    "portbench.decode"


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(v) for v in out]


class Slice:
    """``ops``: (name, start, end) of each device operation; ``spans``:
    (name, start, end) of the host spans; ``start``, ``end``: the slice;
    ``batches``: the batches it holds."""

    def __init__(self, ops, spans, start, end, batches):
        self.start, self.end, self.batches = start, end, batches
        self.ops = [(n, max(s, start), min(e, end)) for n, s, e in ops
                    if e > start and s < end]
        self.spans = sorted((s, e, n) for n, s, e in spans
                            if n in (FRONT, DECODE))
        self.busy = union((s, e) for _, s, e in self.ops)

    @classmethod
    def from_profile(cls, prof, batches):
        from torch.autograd import DeviceType
        ops, spans, window = [], [], None
        for ev in prof.events():
            s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
            if ev.device_type == DeviceType.CUDA:
                # the device timeline also carries the host spans' ranges
                if not (getattr(ev, "is_user_annotation", False)
                        or ev.name.startswith("portbench.")):
                    ops.append((ev.name, s, e))
            elif ev.name == SLICE:
                window = (s, e)
            elif ev.name in (FRONT, DECODE):
                spans.append((ev.name, s, e))
        if window is None:
            raise RuntimeError("the profile holds no portbench.slice span")
        if not ops:
            raise RuntimeError("the profile holds no device operation")
        return cls(ops, spans, window[0], window[1], batches)

    @property
    def window_s(self):
        return self.end - self.start

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy)

    def op_seconds(self, match=None):
        """Device seconds of the operations whose name ``match`` accepts
        (all by default), summed."""
        return sum(e - s for n, s, e in self.ops
                   if match is None or match(n))

    def top_ops(self, count=10):
        """[[name, seconds], ...] of the operations that took most time,
        summed by name."""
        tot = {}
        for n, s, e in self.ops:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n, v] for n, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:count]]

    def host_span(self, t):
        """The benchmark span the host was in at ``t``: front, decode or,
        outside both, harness."""
        i = bisect.bisect_right(self.spans, (t, float("inf"), "")) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i][2].split(".")[1]
        return "harness"

    def idle_gaps(self, count=10):
        """[[label, seconds], ...]: the slice's idle time by what the host
        was in at the middle of each gap and the device operation that
        ended it, summed by label, largest first."""
        starts = sorted((s, n) for n, s, _ in self.ops)
        tot, t = {}, self.start
        for s, e in self.busy + [(self.end, self.end)]:
            if s > t:
                j = bisect.bisect_left(starts, (s, ""))
                nxt = starts[j][1] if j < len(starts) else "end of slice"
                label = f"{self.host_span((s + t) / 2)} before {nxt[:60]}"
                tot[label] = tot.get(label, 0.0) + (s - t)
            t = max(t, e)
        return [[n, v] for n, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:count]]
