"""One run of one benchmark cell.

``run_cell`` builds the cell's chain from its configuration, warms it up,
then drives ``polar_torch.sim.sim_ber`` over it for ``seconds``: one Eb/N0
point in back-to-back chunks of ``batches_per_chunk`` batches, each chunk
a ``sim_ber`` call (``early_stop=False``, no error targets, ``verbose=
False``) with its own seed derived from the run's seed. A ``Tap`` hooks the
model's ``step``, ``front`` and ``decoder`` to read the host clock at each
step, to hold a seeded sample of whole chunks' outputs for the comparison
with the plain reference, and, in a traced run, to record CUDA events
around the two layers over the window and profiler spans over
``trace_chunks`` more chunks after it. After the window it reads the
metrics by their readers (``portbench/metrics/<name>.py``) and judges the
sample (``compare.judge``, against the configuration's plain reference).
"""

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import random
import time

import numpy as np
import torch

from portbench import compare
from portbench.reference import channel
from portbench.trace import DECODE, FRONT, SLICE, Slice

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "polar_tpu")


class CellError(RuntimeError):
    """A cell that cannot run as asked; no result is printed."""


def load_manifest():
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        raise CellError(f"no BENCHMARK.json at {ROOT}")
    with open(path) as fh:
        return json.load(fh)


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as fh:
        return json.load(fh)


def cell_spec(name):
    """(manifest, workload entry, configuration, traffic, limits) of the
    cell ``name``, each from the file its name gives."""
    man = load_manifest()
    found = [w for w in man["workloads"] if w["name"] == name]
    if not found:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    wl = found[0]
    (conf,) = [c for c in man["configs"] if c["name"] == wl["config"]]
    with open(os.path.join(ROOT, conf["file"])) as fh:
        cfg = json.load(fh)
    return (man, wl, cfg, _json("traffic", wl["traffic"] + ".json"),
            _json("limits", name + ".json"))


def cell_metrics(man, name, trace):
    """The metric entries this cell reports: its per-layer ones in a
    traced run, else its end-to-end ones."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(name):
    """The reader of metric ``name``: ``read(ctx) -> number or None``,
    from ``metrics/<name>.py``. A metric ``<base>.<variant>`` with no file
    of its own is ``<base>``'s reading under another name (as a quantity
    is named apart in cells that report another end-to-end metric), and
    ``<base>``'s reader reads it."""
    base = name
    while not os.path.exists(os.path.join(HERE, "metrics", base + ".py")):
        if "." not in base:
            raise CellError(f"no reader for metric {name!r} in "
                            f"portbench/metrics/")
        base = base.rsplit(".", 1)[0]
    path = os.path.join(HERE, "metrics", base + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + base.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def chunk_seed(seed, chunk):
    """The ``sim_ber`` seed of chunk ``chunk`` of a run seeded with
    ``seed`` (warm-up chunks are negative)."""
    return channel.batch_seed(seed % 2 ** 64, chunk + 2 ** 32, 0) % 2 ** 63


def process_age():
    """Seconds since this process started (Linux ``/proc``), or 0."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Tap:
    """The ``mc_fun`` that ``sim_ber`` drives: ``step`` is the model's,
    with the host clock read at each call. ``front`` and ``decoder`` are
    hooked on the model object itself, so the program's own ``step`` calls
    through them; they keep each batch's outputs while ``hold`` is set and
    record CUDA events (``events``) and profiler spans (``spans``)."""

    def __init__(self, model):
        self.model, self.device = model, model.device
        self._front, self._decoder = model.front, model.decoder
        model.front, model.decoder = self.front, self.decode
        self.hold = self.events = self.spans = False
        self.clock = []         # host clock at each timed step
        self.marks = []         # CUDA events (front start, front end,
        self.timed = False      # decode end) of each timed batch
        self.batches = []       # the chunk in progress: its outputs
        self._cur = None

    def step(self, generator, batch_size, ebno_db):
        if self.timed:
            self.clock.append(time.perf_counter())
        bits, bits_hat = self.model.step(generator, batch_size, ebno_db)
        if self.hold:
            self.batches.append(self._cur + (bits_hat,))
        self._cur = None
        return bits, bits_hat

    def _span(self, name):
        if self.spans:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def front(self, generator, batch_size, ebno_db):
        ev = None
        if self.events:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        with self._span(FRONT):
            bits, cw, llr = self._front(generator, batch_size, ebno_db)
        if ev is not None:
            ev[1].record()
            self.marks.append(ev)
        if self.hold:
            self._cur = (generator.initial_seed(), bits, cw, llr)
        return bits, cw, llr

    def decode(self, llr):
        with self._span(DECODE):
            out = self._decoder(llr)
        if self.events:
            self.marks[-1][2].record()
        return out

    def detach(self):
        self.model.front, self.model.decoder = self._front, self._decoder


class Ctx:
    """What a metric reader sees (attributes set by ``run_cell``)."""


def run_chunks(tap, traffic, seed, first, count, sample=None):
    """``count`` chunks from chunk ``first`` through ``sim_ber``; with
    ``sample`` (a reservoir) each chunk's outputs are offered to it."""
    from polar_torch.sim import sim_ber

    ebno, bs, m = (float(traffic["ebno_db"]), int(traffic["batch_size"]),
                   int(traffic["batches_per_chunk"]))
    for c in range(first, first + count):
        tap.batches = []
        cs = chunk_seed(seed, c)
        ber, bler = sim_ber(tap, [ebno], bs, m, early_stop=False,
                            verbose=False, seed=cs)
        if sample is not None:
            sample.offer((c, cs, tap.batches, float(ber[0]),
                          float(bler[0])))
    tap.batches = []


class Reservoir:
    """A uniform sample of ``size`` chunks, drawn from ``seed``."""

    def __init__(self, size, seed):
        self.size, self.items, self.seen = size, [], 0
        self.rng = random.Random(seed)

    def offer(self, item):
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def forbidden_modules():
    import sys
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN_MODULES))


def run_cell(name, seed, seconds, trace, device="cuda", overrides=None,
             build=None, log=print, age=None):
    """One run of cell ``name``: the result line's dict, ``checks`` last.
    ``overrides`` replaces traffic keys (tests run tiny batches on the CPU);
    ``build`` replaces the system's build function (tests plant faults with it)."""
    t_start = time.perf_counter() - (process_age() if age is None else age)
    man, wl, cfg, traffic, limits = cell_spec(name)
    traffic = dict(traffic, **(overrides or {}))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise CellError("no CUDA card: torch.cuda.is_available() is "
                            "false")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise CellError(f"the cell needs {wl['chips']} cards, "
                            f"{torch.cuda.device_count()} present")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    system = importlib.import_module(f"portbench.systems.{cfg['system']}")
    t_imports = time.perf_counter()
    model = (build or system.build)(cfg, dev)
    t_model = time.perf_counter()
    tap = Tap(model)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # ---- set-up: warm-up chunks of the cell's own shape ----
    tap.hold = True
    tap.events = trace and cuda
    run_chunks(tap, traffic, seed, -int(traffic["warmup_chunks"]),
               int(traffic["warmup_chunks"]))
    tap.marks = []
    sync()

    # ---- the window ----
    sample = Reservoir(int(traffic["sampled_chunks"]), seed)
    prof = None
    tap.timed = True
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    chunk = 0
    while True:
        run_chunks(tap, traffic, seed, chunk, 1, sample)
        chunk += 1
        if time.perf_counter() - t0 >= seconds:
            break
    profiled_from = len(tap.clock)
    batch_period_s = (time.perf_counter() - t0) / profiled_from
    if trace:
        # a traced run profiles a fixed number of chunks after the window
        prof = _start_profile(cuda)
        with torch.profiler.record_function(SLICE):
            tap.spans = True
            run_chunks(tap, traffic, seed, chunk,
                       int(traffic["trace_chunks"]), sample)
            sync()
        prof.__exit__(None, None, None)
    sync()
    t_end = time.perf_counter()
    tap.timed = tap.spans = False

    ctx = Ctx()
    ctx.cfg, ctx.traffic = cfg, traffic
    ctx.k = int(cfg["k"])
    ctx.batches = len(tap.clock)
    ctx.blocks = ctx.batches * int(traffic["batch_size"])
    ctx.window_s = t_end - t0
    ctx.setup_s = setup_s
    ctx.periods_s = np.diff(np.array(tap.clock + [t_end]))
    ctx.batch_period_s = batch_period_s
    log(f"set-up {setup_s:.3f} s (imports {t_imports - t_start:.3f}, "
        f"model {t_model - t_imports:.3f}, warm-up {t0 - t_model:.3f})")
    ctx.front_ms = ctx.decode_ms = ctx.gap_ms = None
    ctx.slice = None
    ctx.power_limit = None
    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules of JAX or the JAX package are loaded: "
                        f"{bad}")
    if trace and cuda:
        marks = tap.marks[:profiled_from]
        ctx.front_ms = [a.elapsed_time(b) for a, b, _ in marks]
        ctx.decode_ms = [b.elapsed_time(c) for _, b, c in marks]
        ctx.gap_ms = [marks[i][2].elapsed_time(marks[i + 1][0])
                      for i in range(len(marks) - 1)]
        ctx.slice = Slice.from_profile(prof, len(tap.clock) - profiled_from)
        ctx.power_limit = _power_limit()
    mem = torch.cuda.max_memory_allocated(dev) if cuda else 0
    metrics = {}
    for m in cell_metrics(man, name, trace):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu",
                   "count": 1, "memory_peak_bytes": int(mem)}
    breakdown = None
    if ctx.slice is not None:
        device_info["busy_s"] = ctx.slice.busy_s
        device_info["window_s"] = ctx.slice.window_s
        breakdown = {"device_ops": ctx.slice.top_ops(),
                     "idle_gaps": ctx.slice.idle_gaps()}
    if trace and cuda:
        log(f"power limit {ctx.power_limit}; trace slice "
            f"{ctx.slice.window_s:.4f} s, {ctx.slice.batches} batches")

    # ---- the comparison, once the program's state is freed ----
    samples = sample.items
    tap.detach()
    del model, tap, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = compare.judge(samples, cfg, traffic, dev)
    log(f"reference comparison {time.perf_counter() - t_ref:.2f} s over "
        f"{sum(len(s[2]) for s in samples)} batches")
    correct = all(v["value"] <= limits[k] for k, v in checks.items())
    for k, v in checks.items():
        v["limit"] = limits[k]
    result = {"correct": bool(correct), "attempted": ctx.batches,
              "failed": 0, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    bad = forbidden_modules()
    if bad:
        raise CellError(f"modules of JAX or the JAX package are loaded: "
                        f"{bad}")
    result["checks"] = checks
    return result


def _start_profile(cuda):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _power_limit():
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        return out[0] if out else None
    except (OSError, subprocess.SubprocessError):
        return None
