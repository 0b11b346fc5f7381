"""Device selection shared by the port's entry points, and the card's name
and power limit that they print."""

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.

    Entry points run on the card unless the caller asks for the CPU. A CUDA
    device without a card raises: the port never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_info(device):
    """(name, power limit) of ``device`` as ``nvidia-smi --query-gpu=
    name,power.limit`` prints them; ``("cpu", None)`` on the CPU."""
    if device.type != "cuda":
        return "cpu", None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    name, power = out[min(device.index, len(out) - 1)].rsplit(",", 1)
    return name.strip(), power.strip()
