"""Dataclass CLI configuration: the JAX package's ``PolarConfig`` fields
and its argparse bridge (every field is a ``--flag``; ``--algos [scl]``
list syntax; bool and tri-state ``fast_scl`` parsing), plus ``device``, the
port's explicit device."""

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List


@dataclass
class PolarConfig:
    # code parameters
    k: int = 32            # number of information bits per codeword
    n: int = 64            # desired codeword length
    algos: List[str] = field(default_factory=lambda: ["scl"])
    kern: str = "F2"       # kernel of the zoo; other than F2: dense-G + OSD
    verbose: bool = False
    bs: int = 3            # Monte-Carlo batch size
    snr_end: float = 5.0   # sweep = arange(0, snr_end, 0.5)
    mc_iter: int = 10      # max Monte-Carlo iterations per SNR point
    list_size: int = 8     # SCL list size
    mode: str = "max"      # f-function: "max"/"minsum" or "llr"/"exact"
    spec: bool = False     # apply special cases (unused, as in the reference)
    seed: int = 42
    construction: str = "rm"   # "rm" (lowest row weight, stable ties),
    # "rm-ref" (the reference CLI's own ties), and on F2 only "5g" (NR
    # reliability table) or "ga" (Gaussian approximation at design_snr)
    num_devices: int = 0       # unread, as in the JAX CLI: data-parallel
    # runs go through parallel.ShardedSystem and sim_ber
    target_block_errs: int = 1000
    bp_iter: int = 20          # BP decoder iterations (sweeps)
    osd_t: int = 2             # OSD order for kernels other than F2
    # fast-SCL pruning, tri-state: None = the decoder's default by n (fast
    # below n=256, plain from 256 up); true/false pins it
    fast_scl: bool | None = None
    design_snr: float = 2.0    # design Eb/N0 (dB) for --construction ga
    plot_dir: str = "plots"
    device: str = "cuda"       # where the chain runs ("cpu" for the CPU)


def _parse_value(ftype, raw):
    if (ftype == bool or ftype == "bool"
            or str(ftype) in ("bool | None", "typing.Optional[bool]")):
        return raw in ("1", "true", "True", "yes")
    if ftype in (List[str], "List[str]"):
        raw = raw.strip()
        if raw.startswith("[") and raw.endswith("]"):
            raw = raw[1:-1]
        return [s.strip() for s in raw.split(",") if s.strip()]
    return ftype(raw)


def parse_config(argv=None, cls=PolarConfig):
    """Parse CLI flags into a config dataclass."""
    parser = argparse.ArgumentParser(description=cls.__doc__)
    for f in dataclasses.fields(cls):
        parser.add_argument(f"--{f.name}", type=str, default=None)
    args = parser.parse_args(argv)
    kwargs = {}
    for f in dataclasses.fields(cls):
        raw = getattr(args, f.name)
        if raw is not None:
            kwargs[f.name] = _parse_value(f.type, raw)
    return cls(**kwargs)
