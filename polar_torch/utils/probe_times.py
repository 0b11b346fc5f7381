"""The probe kernels' times on the card, for comparing two checkouts in
one call: each probe's kernel alone (``torch.profiler``, three runs of 200
launches) and a launch through its wrapper (CUDA events over 200
launches), after a check against its plain version, as one JSON line.

    python polar_torch/utils/probe_times.py ROOT [NAME,NAME,...]

times the ``polar_torch`` package under checkout ``ROOT`` (run by path,
so that ``ROOT``'s package is the one imported); the names default to
every probe. Run two checkouts in turns (old, new, new, old) on one card.
"""

import json
import os
import sys


def kernel_alone_ms(fn, reps=200):
    """Mean device time of the probe kernels ``reps`` calls of ``fn``
    launch (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "probe_" in e.key]
    return (sum(e.self_device_time_total for e in events) / 1e3
            / sum(e.count for e in events))


def main(argv):
    root = os.path.abspath(argv[0])
    sys.path.insert(0, root)
    from polar_torch import probes
    from polar_torch._device import card_info, resolve_device
    from polar_torch.utils.profiling import cuda_ms
    names = argv[1].split(",") if len(argv) > 1 else list(probes.PROBES)
    dev = resolve_device(None)
    card, power = card_info(dev)
    row = {"root": root, "device": card, "power_limit": power}
    for name in names:
        step = "bf16" if name in probes.BF16 else f"mini:{name}"
        args = tuple(a.to(dev) for a in probes.step_inputs(step)[name])
        wrapper = probes.WRAPPERS[name]
        differ = probes.differing(probes.PLAIN[name](*args), wrapper(*args))
        row[name] = {"alone_ms": [kernel_alone_ms(lambda: wrapper(*args))
                                  for _ in range(3)],
                     "launch_ms": cuda_ms(lambda: wrapper(*args), 200),
                     "differ": differ}
    print(json.dumps(row), flush=True)
    return 0 if all(row[n]["differ"] == 0 for n in names) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
