"""The plain references: one module a system (``reference/<system>.py``,
found by a configuration's ``system`` key as ``systems/<system>.py`` is),
and the pieces they share (``channel``, ``nr``, ``scl``). None of them
imports anything of the program."""

import importlib

import torch


def link(cfg, device, dtype=torch.float32):
    """The plain reference of ``cfg``'s system, computing in ``dtype``:
    its module's ``Link(cfg, device, dtype)``, which gives ``front(seed,
    batch_size, ebno_db, dtype)`` (a batch's draws, sent bits and LLRs),
    ``decode(llr, rows)`` (the decisions) and ``decode_work(batch_size)``
    (the decode's least bytes and operations, ``portbench.work``)."""
    module = importlib.import_module(f"portbench.reference.{cfg['system']}")
    return module.Link(cfg, device, dtype)
