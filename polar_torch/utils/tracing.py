"""Spans and counters inside the program, on the profiler's clock.

``span(name)`` marks a piece of the program's work::

    with tracing.span("front.encode"):
        codewords = self.encoder(bits)

Tracing is off unless a ``torch.profiler`` runs or an ``enabled()`` block
is open. Off, ``span`` returns one shared, pre-built null context after a
flag check: it allocates nothing and dispatches no op. On, a span opens
``torch.profiler.record_function(name)``, so its host and device ranges
land in the profile beside the kernels it launched, and appends a record to
the session: its name, its parent, its batch, the host clock
(``perf_counter_ns``) at its start and end and, once the program has used
the card, a pair of CUDA timing events on the current stream (pooled).

``batch()`` opens the root span of one Monte-Carlo batch (``sim.step``):
every span inside it carries the batch's id, a running count of batches.
A session is one profiler run or one ``enabled()`` block; it ends at the
first ``batch()`` or ``summary()`` that finds tracing off, and its records
stay until the next session starts. ``summary()`` synchronises once,
resolves the events and returns the session's table (``summarize``).

``count(name, n)`` adds to a counter of the one registry, whether tracing
is on or not: the hand-written kernels' launches (``launch.<wrapper>``,
read by ``kernel_work.launch_counts`` and ``probes.launch_counts``), the
blocking device-to-host reads (``sync``) and the host-to-device copies
(``h2d``). While a span is open the count is charged to it too.

The aten ops a span dispatches are counted in the first batch of a session
only (a ``TorchDispatchMode``), and that batch is left out of every time
mean, so the counting does not bend the times: the chain runs the same ops
in every batch. Views and the ops that launch no device work (allocation,
aliasing) are left out, and so are ops on host tensors where the
session's ops touch the card. A hand-written kernel's launch, which no
dispatcher sees, adds its device operations to the open span's count
(``count(..., ops=k)``).
"""

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_NULL = contextlib.nullcontext()

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling():
        return _autograd_profiler._is_profiler_enabled
else:                                               # older torch
    _profiling = torch._C._autograd._profiler_enabled

# spans whose time ``harness.host_ms`` leaves out of ``sim.step``'s
HARNESS_EXCLUDES = ("chain.front", "chain.decode", "sim.sync")
# aten ops that launch no device work, besides views
_NO_LAUNCH = frozenset("""
    empty empty_like empty_strided new_empty new_empty_strided lift_fresh
    detach alias _unsafe_view set_ resize_ sym_size sym_stride sym_numel
    sym_storage_offset is_same_size record_stream
""".split())


class _Record:
    __slots__ = ("name", "parent", "batch", "t0", "t1", "events", "ops",
                 "cpu_ops", "counts", "rf")

    def __init__(self, name, parent, batch):
        self.name, self.parent, self.batch = name, parent, batch
        self.t1 = self.events = self.counts = None
        self.ops = self.cpu_ops = 0


class _Span:
    __slots__ = ("_tracer", "_name", "_root", "_rec")

    def __init__(self, tracer, name, root):
        self._tracer, self._name, self._root = tracer, name, root

    def __enter__(self):
        self._rec = self._tracer._open(self._name, self._root)
        return self

    def __exit__(self, *exc):
        self._tracer._close(self._rec, self._root)
        return False


class _OpCount(TorchDispatchMode):
    """Charges each aten op that launches device work to the open span."""

    def __init__(self, tracer):
        super().__init__()
        self._tracer = tracer
        self._launches = {}

    def _counts(self, func):
        hit = self._launches.get(func)
        if hit is None:
            hit = self._launches[func] = (
                func.namespace == "aten" and not func.is_view
                and func._overloadpacket.__name__ not in _NO_LAUNCH)
        return hit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        stack = self._tracer._stack
        if stack and self._counts(func):
            rec = stack[-1]
            if any(isinstance(x, torch.Tensor) and x.device.type != "cpu"
                   for x in tree_leaves((args, kwargs, out))):
                rec.ops += 1
            else:
                rec.cpu_ops += 1
        return out


class Tracer:
    """The registry of counters and the records of the latest session.
    The module's functions act on one shared instance."""

    def __init__(self):
        self.counters = {}
        self.explicit = 0           # open ``enabled()`` blocks
        self.batches = 0            # batches opened, traced or not
        self._live = False          # a session is being written
        self._records = []
        self._stack = []
        self._batch = None          # the open batch's id
        self._counted = None        # the batch whose ops are counted
        self._mode = None
        self._cuda = False
        self._pool = []             # free CUDA events
        self._summary = None

    def on(self):
        return bool(self.explicit) or _profiling()

    # ---- sessions ----
    def _start_session(self):
        for rec in self._records:
            if rec.events:
                self._pool.extend(rec.events)
        self._records, self._stack, self._summary = [], [], None
        self._counted = None
        self._cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self._live = True

    def end_session(self):
        """Stop writing the session; its records stay for ``summary``."""
        if self._mode is not None:
            self._mode.__exit__(None, None, None)
            self._mode = None
        self._live = False

    def _event(self):
        if self._pool:
            return self._pool.pop()
        return torch.cuda.Event(enable_timing=True)

    # ---- spans ----
    def _open(self, name, root):
        if not self._live:
            self._start_session()
        if root:
            self._batch = self.batches
        rec = _Record(name, self._stack[-1] if self._stack else None,
                      self._batch)
        if root and self._counted is None:
            self._counted = self._batch
            self._mode = _OpCount(self)
            self._mode.__enter__()
        rec.rf = _autograd_profiler.record_function(name)
        rec.rf.__enter__()
        if self._cuda:
            rec.events = (self._event(), self._event())
            rec.events[0].record()
        self._stack.append(rec)
        self._records.append(rec)
        rec.t0 = time.perf_counter_ns()
        return rec

    def _close(self, rec, root):
        rec.t1 = time.perf_counter_ns()
        if rec.events:
            rec.events[1].record()
        rec.rf.__exit__(None, None, None)
        rec.rf = None
        if self._stack and self._stack[-1] is rec:
            self._stack.pop()
        if root:
            self._batch = None
            if self._mode is not None:
                self._mode.__exit__(None, None, None)
                self._mode = None

    # ---- counters ----
    def count(self, name, n=1, ops=0):
        self.counters[name] = self.counters.get(name, 0) + n
        if self._stack:
            rec = self._stack[-1]
            if rec.counts is None:
                rec.counts = {}
            rec.counts[name] = rec.counts.get(name, 0) + n
            if self._mode is not None:
                rec.ops += ops * n

    # ---- reading ----
    def records(self):
        """(name, parent index or None, batch id or None) of each record of
        the latest session, in the order the spans opened."""
        pos = {id(r): i for i, r in enumerate(self._records)}
        return [(r.name, pos.get(id(r.parent)), r.batch)
                for r in self._records]

    def summary(self):
        if self._live and not self.on():
            self.end_session()
        if not self._records:
            return None
        if self._summary is not None and not self._live:
            return self._summary
        if self._cuda:
            torch.cuda.synchronize()
        kept = [r for r in self._records if r.t1 is not None]
        pos = {id(r): j for j, r in enumerate(kept)}
        rows = [dict(name=r.name, parent=pos.get(id(r.parent)),
                     batch=r.batch, host_ms=(r.t1 - r.t0) / 1e6,
                     device_ms=(r.events[0].elapsed_time(r.events[1])
                                if r.events else None),
                     ops=r.ops, cpu_ops=r.cpu_ops,
                     counts=dict(r.counts or {})) for r in kept]
        s = summarize(rows, self._counted)
        if not self._live:
            self._summary = s
        return s


def summarize(rows, counted):
    """The session's table from its records, each a dict with ``name``,
    ``parent`` (an index into ``rows``, which come in the order the spans
    opened, or None), ``batch``, ``host_ms``, ``device_ms`` (None without
    events), ``ops`` (device ops and launches charged to the span
    itself), ``cpu_ops`` (ops on host tensors alone) and ``counts`` (the
    counters charged to the span itself). ``counted`` is the batch whose
    ops were counted.

    Returns ``batches`` (the session's), ``timed_batches`` (all but the
    counted one, over which every time is a mean), ``events`` (whether
    device times exist) and ``spans``: per span name ``calls`` a batch,
    ``host_ms`` and ``device_ms`` a batch, ``self_host_ms`` and
    ``self_device_ms`` (less the children's), ``ops`` in the counted batch
    (the span's and its children's: device ops and launches, or, where the
    session touched no device, host ops) and every counter a batch, with
    children's. Then the per-layer readings:

    * ``front_ops``, ``decode_ops``: ``ops`` of ``chain.front`` and
      ``chain.decode``; ``harness_ops``: ``sim.step``'s less those two;
    * ``decode_kernel_ms``: device ms a batch of the ``kernel.*`` spans
      inside ``chain.decode``; ``decode_glue_ms``: ``chain.decode``'s
      device ms a batch less that;
    * ``harness_host_ms``: ``sim.step``'s host ms a batch less that of
      the ``HARNESS_EXCLUDES`` spans inside it.
    """
    n = len(rows)
    use_cpu = not any(r["ops"] for r in rows)
    incl_ops = [r["cpu_ops"] if use_cpu else r["ops"] for r in rows]
    incl_counts = [dict(r["counts"]) for r in rows]
    kids_host = [0.0] * n
    kids_dev = [0.0] * n
    for i in range(n - 1, -1, -1):
        p = rows[i]["parent"]
        if p is None:
            continue
        incl_ops[p] += incl_ops[i]
        for k, v in incl_counts[i].items():
            incl_counts[p][k] = incl_counts[p].get(k, 0) + v
        kids_host[p] += rows[i]["host_ms"]
        if rows[i]["device_ms"] is not None:
            kids_dev[p] += rows[i]["device_ms"]

    order = []
    for r in rows:
        if r["batch"] not in order:
            order.append(r["batch"])
    batches = [b for b in order if b is not None] or [None]
    timed = (batches if counted is None
             else [b for b in batches if b != counted])
    events = bool(rows) and all(r["device_ms"] is not None for r in rows)

    def ancestor(i, names):
        p = rows[i]["parent"]
        while p is not None:
            if rows[p]["name"] in names:
                return p
            p = rows[p]["parent"]
        return None

    def mean(total, over):
        return total / len(over) if over else None

    spans = {}
    for i, r in enumerate(rows):
        if r["batch"] not in batches:
            continue
        row = spans.setdefault(r["name"], dict(
            calls=0, host_ms=0.0, device_ms=0.0, self_host_ms=0.0,
            self_device_ms=0.0, ops=None if counted is None else 0))
        row["calls"] += 1
        for k, v in incl_counts[i].items():
            row[k] = row.get(k, 0) + v
        if r["batch"] == counted and counted is not None:
            row["ops"] += incl_ops[i]
        if r["batch"] in timed:
            row["host_ms"] += r["host_ms"]
            row["self_host_ms"] += r["host_ms"] - kids_host[i]
            if events:
                row["device_ms"] += r["device_ms"]
                row["self_device_ms"] += r["device_ms"] - kids_dev[i]
    for row in spans.values():
        for k in list(row):
            if k in ("host_ms", "self_host_ms", "device_ms",
                     "self_device_ms"):
                row[k] = (mean(row[k], timed)
                          if events or "device" not in k else None)
            elif k != "ops":
                row[k] = row[k] / len(batches)

    kernel_ms = glue_ms = harness_ms = 0.0
    for i, r in enumerate(rows):
        if r["batch"] not in timed:
            continue
        if events and r["name"] == "chain.decode":
            glue_ms += r["device_ms"]
        elif (events and r["name"].startswith("kernel.")
              and ancestor(i, ("chain.decode",)) is not None):
            kernel_ms += r["device_ms"]
            glue_ms -= r["device_ms"]
        if r["name"] == "sim.step":
            harness_ms += r["host_ms"]
        elif (r["name"] in HARNESS_EXCLUDES
              and ancestor(i, HARNESS_EXCLUDES) is None
              and ancestor(i, ("sim.step",)) is not None):
            harness_ms -= r["host_ms"]

    def ops_of(name):
        return spans.get(name, {}).get("ops")

    front, decode, step = (ops_of("chain.front"), ops_of("chain.decode"),
                           ops_of("sim.step"))
    have = {r["name"] for r in rows}
    return dict(
        batches=len(batches),
        timed_batches=len(timed), events=events, spans=spans,
        front_ops=front, decode_ops=decode,
        harness_ops=(None if None in (front, decode, step)
                     else step - front - decode),
        decode_kernel_ms=(mean(kernel_ms, timed)
                          if events and "chain.decode" in have else None),
        decode_glue_ms=(mean(glue_ms, timed)
                        if events and "chain.decode" in have else None),
        harness_host_ms=(mean(harness_ms, timed) if "sim.step" in have
                         else None))


def format_table(s):
    """``summary()``'s span table as text: one line a span name in the
    order the spans first opened, with calls, host and device ms (self
    ms in brackets), ops, host-to-device copies, syncs and launches a
    batch."""
    head = (f"spans: {s['batches']} batches, times over "
            f"{s['timed_batches']}, ops of the first")
    lines = [head, f"{'span':<22}{'calls':>6} {'host ms (self)':>20} "
                   f"{'device ms (self)':>20}{'ops':>7}{'h2d':>6}{'sync':>6}"
                   f"{'launch':>7}"]

    def ms(v, self_v):
        return "-" if v is None else f"{v:.4f} ({self_v:.4f})"

    for name, r in s["spans"].items():
        launches = sum(v for k, v in r.items() if k.startswith("launch."))
        lines.append(
            f"{name:<22}{r['calls']:>6.2f} "
            f"{ms(r['host_ms'], r['self_host_ms']):>20} "
            f"{ms(r['device_ms'], r['self_device_ms']):>20}"
            f"{'-' if r['ops'] is None else r['ops']:>7}"
            f"{r.get('h2d', 0):>6.2f}{r.get('sync', 0):>6.2f}"
            f"{launches:>7.2f}")
    for key in ("front_ops", "decode_ops", "harness_ops", "decode_kernel_ms",
                "decode_glue_ms", "harness_host_ms"):
        lines.append(f"{key} {s[key]!r}")
    return "\n".join(lines)


_TRACER = Tracer()


def span(name):
    """A span of the program's work named ``name``; see the module
    docstring. Off, the shared null context."""
    if _TRACER.explicit or _profiling():
        return _Span(_TRACER, name, False)
    return _NULL


def batch(name="sim.step"):
    """The root span of one Monte-Carlo batch; its spans share its id."""
    t = _TRACER
    t.batches += 1
    if t.explicit or _profiling():
        return _Span(t, name, True)
    if t._live:
        t.end_session()
    return _NULL


def count(name, n=1, ops=0):
    """Add ``n`` to counter ``name``; while a span is open, charge it to
    the span too, with ``ops`` device operations each (a hand-written
    kernel's launch) in the batch whose ops are counted."""
    _TRACER.count(name, n, ops)


def counter(name):
    """Counter ``name``'s value (0 before its first count)."""
    return _TRACER.counters.get(name, 0)


def reset_counters(names):
    """Counters ``names`` to 0."""
    for name in names:
        _TRACER.counters.pop(name, None)


@contextlib.contextmanager
def enabled():
    """Trace the block as a session of its own, without a profiler."""
    t = _TRACER
    if not t.explicit:
        t.end_session()
    t.explicit += 1
    try:
        yield
    finally:
        t.explicit -= 1
        if not t.explicit:
            t.end_session()


def records():
    """The latest session's records: ``Tracer.records``."""
    return _TRACER.records()


def summary():
    """The latest session's table (``summarize``), or None where no
    session has run. Synchronises once with the card where the session
    recorded events."""
    return _TRACER.summary()
