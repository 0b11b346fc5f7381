"""Monte-Carlo BER/BLER simulation harness and its error counters.

``sim_ber`` runs up to ``max_mc_iter`` batches per Eb/N0 point with the
same five status codes, live progress table and early stop (on the first
error-free point) as the JAX package, plus JSONL metrics and counter
checkpoint/resume (``state_path``). The chain runs on the model's device:

* each (point, iteration) gets its own ``torch.Generator`` on that device,
  seeded from ``(seed, point, iteration)`` through
  ``numpy.random.SeedSequence``, so results do not depend on loop order;
* error counts are int64 on the device; two scalars cross to the host per
  batch, where the sweep accumulates in int64;
* a model with its own ``counted_step`` (``parallel.ShardedSystem``)
  returns counters already reduced across its ranks, which the sweep takes
  as they are, so every rank takes the same early-stop branch;
* each batch is one ``tracing.batch()`` (``sim.step``) with its spans
  ``sim.seed`` (the generator), ``sim.count`` (the counting ops) and
  ``sim.sync`` (the wait for the two scalars, a counted ``sync``).
"""

import json
import os
import time

import numpy as np
import torch

from polar_torch._device import resolve_device
from polar_torch.utils import tracing

STATUS_LEVELS = [
    "not simulated",
    "reached max iter       ",
    "no errors - early stop",
    "reached target bit errors",
    "reached target block errors",
]


def hard_decisions(llr):
    """Logits to bits: ``llr > 0 -> 1``."""
    return (llr > 0).to(llr.dtype)


def count_errors(b, b_hat):
    """Number of differing bits (int64 tensor)."""
    return torch.count_nonzero(b != b_hat)


def count_block_errors(b, b_hat):
    """Number of blocks (last dim) with at least one bit error."""
    return torch.count_nonzero((b != b_hat).any(dim=-1))


def iteration_generator(seed: int, point: int, iteration: int, device):
    """The generator of one (point, iteration) of a sweep."""
    state = np.random.SeedSequence([seed, point, iteration]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def fold_in(generator, index: int):
    """A new generator on ``generator``'s device, derived from its seed and
    ``index`` (the counterpart of ``jax.random.fold_in``): a shard's stream
    of a sharded step."""
    state = np.random.SeedSequence(
        [generator.initial_seed(), int(index)]).generate_state(1, np.uint64)
    return torch.Generator(device=generator.device).manual_seed(
        int(state[0]))


def _print_progress(is_final, rt, ebno_db, idx_it, max_mc_iter, bit_errors,
                    nb_bits, block_errors, nb_blocks, status,
                    header_text=None):
    end_str = "\n" if is_final else "\r"
    if header_text is not None:
        row_text = header_text
        end_str = "\n"
    else:
        ber_np = np.nan_to_num(bit_errors / max(nb_bits, 1e-12))
        bler_np = np.nan_to_num(block_errors / max(nb_blocks, 1e-12))
        if status == 0:
            status_txt = f"iter: {idx_it:.0f}/{max_mc_iter:.0f}"
        else:
            status_txt = STATUS_LEVELS[int(status)]
        row_text = [str(np.round(ebno_db, 3)), f"{ber_np:.4e}",
                    f"{bler_np:.4e}", np.round(bit_errors, 0),
                    np.round(nb_bits, 0), np.round(block_errors, 0),
                    np.round(nb_blocks, 0), np.round(rt, 1), status_txt]
    print("{: >9} |{: >11} |{: >11} |{: >12} |{: >12} |{: >13} |{: >12} |"
          "{: >12} |{: >10}".format(*row_text), end=end_str)


def _counted_step(mc_fun, batch_size, soft_estimates):
    """``(generator, ebno_db) -> (bit errors, block errors, bits, blocks)``
    as host ints, from ``mc_fun.counted_step`` (reduced counters, e.g.
    ``parallel.ShardedSystem``), ``mc_fun.step`` or the callable
    ``mc_fun``."""
    if hasattr(mc_fun, "counted_step"):
        def reduced(generator, ebno_db):
            return mc_fun.counted_step(generator, batch_size, ebno_db)
        return reduced
    run = mc_fun.step if hasattr(mc_fun, "step") else mc_fun

    def counted(generator, ebno_db):
        b, b_hat = run(generator, batch_size, ebno_db)
        with tracing.span("sim.count"):
            if soft_estimates:
                b_hat = hard_decisions(b_hat)
            counts = torch.stack([count_errors(b, b_hat),
                                  count_block_errors(b, b_hat)])
        with tracing.span("sim.sync"):
            errs, blk = counts.tolist()
            tracing.count("sync")
        return errs, blk, b.numel(), b.numel() // b.shape[-1]
    return counted


def sim_ber(mc_fun, ebno_dbs, batch_size, max_mc_iter, soft_estimates=False,
            target_bit_errs=None, target_block_errs=None, early_stop=True,
            verbose=True, seed=42, jsonl_path=None, state_path=None,
            device=None):
    """Monte-Carlo BER/BLER sweep. Returns ``(ber, bler)`` as np.float64.

    ``mc_fun``: an object with ``step(generator, batch_size, ebno_db) ->
    (b, b_hat)`` (a ``SystemAWGNModel``), one with ``counted_step`` of the
    same arguments returning reduced counters (``parallel.ShardedSystem``),
    or a callable with ``step``'s signature. The generators live on ``device``, by default the model's
    ``device`` attribute, else the card."""
    if device is None:
        device = getattr(mc_fun, "device", None)
    device = resolve_device(device)
    ebno_dbs = np.asarray(ebno_dbs, dtype=np.float32)
    num_points = ebno_dbs.shape[0]
    bit_errors = np.zeros(num_points, dtype=np.int64)
    block_errors = np.zeros(num_points, dtype=np.int64)
    nb_bits = np.zeros(num_points, dtype=np.int64)
    nb_blocks = np.zeros(num_points, dtype=np.int64)
    status = np.zeros(num_points, dtype=np.int64)
    runtime = np.zeros(num_points, dtype=np.float64)
    start_point = 0

    # resume from checkpoint if present
    if state_path is not None and os.path.exists(state_path):
        with np.load(state_path) as st:
            if (st["ebno_dbs"].shape == ebno_dbs.shape
                    and np.allclose(st["ebno_dbs"], ebno_dbs)):
                bit_errors = st["bit_errors"]
                block_errors = st["block_errors"]
                nb_bits = st["nb_bits"]
                nb_blocks = st["nb_blocks"]
                status = st["status"]
                runtime = st["runtime"]
                start_point = int(st["next_point"])

    counted_step = _counted_step(mc_fun, batch_size, soft_estimates)
    header_text = ["EbNo [dB]", "BER", "BLER", "bit errors", "num bits",
                   "block errors", "num blocks", "runtime [s]", "status"]

    def save_state(next_point):
        if state_path is not None:
            np.savez(state_path, ebno_dbs=ebno_dbs, bit_errors=bit_errors,
                     block_errors=block_errors, nb_bits=nb_bits,
                     nb_blocks=nb_blocks, status=status, runtime=runtime,
                     next_point=next_point)

    jsonl_f = open(jsonl_path, "a") if jsonl_path is not None else None
    try:
        for i in range(start_point, num_points):
            t0 = time.perf_counter()
            iter_count = -1
            status[i] = 0
            for ii in range(max_mc_iter):
                iter_count += 1
                with tracing.batch():
                    with tracing.span("sim.seed"):
                        gen = iteration_generator(seed, i, ii, device)
                    bit_e, block_e, bit_n, block_n = counted_step(
                        gen, float(ebno_dbs[i]))
                    bit_errors[i] += bit_e
                    block_errors[i] += block_e
                    nb_bits[i] += bit_n
                    nb_blocks[i] += block_n
                if verbose:
                    if i == start_point and iter_count == 0:
                        _print_progress(True, 0, 0, 0, max_mc_iter, 0, 0, 0,
                                        0, 0, header_text=header_text)
                        print("-" * 135)
                    rt = time.perf_counter() - t0
                    _print_progress(False, rt, ebno_dbs[i], ii, max_mc_iter,
                                    bit_errors[i], nb_bits[i],
                                    block_errors[i], nb_blocks[i], status[i])
                if (target_bit_errs is not None
                        and bit_errors[i] >= target_bit_errs):
                    status[i] = 3
                    runtime[i] = time.perf_counter() - t0
                    break
                if (target_block_errs is not None
                        and block_errors[i] >= target_block_errs):
                    status[i] = 4
                    runtime[i] = time.perf_counter() - t0
                    break
                if iter_count == max_mc_iter - 1:
                    status[i] = 1
                    runtime[i] = time.perf_counter() - t0
            if verbose:
                _print_progress(True, runtime[i], ebno_dbs[i], iter_count,
                                max_mc_iter, bit_errors[i], nb_bits[i],
                                block_errors[i], nb_blocks[i], status[i])
            if jsonl_f is not None:
                jsonl_f.write(json.dumps({
                    "ebno_db": float(ebno_dbs[i]),
                    "bit_errors": int(bit_errors[i]),
                    "num_bits": int(nb_bits[i]),
                    "block_errors": int(block_errors[i]),
                    "num_blocks": int(nb_blocks[i]),
                    "runtime_s": float(runtime[i]),
                    "status": int(status[i]),
                }) + "\n")
                jsonl_f.flush()
            if early_stop and block_errors[i] == 0:
                status[i] = 2
                if verbose:
                    print(f"\nSimulation stopped as no error occurred "
                          f"@ EbNo = {ebno_dbs[i]:.1f} dB.\n")
                save_state(i + 1)
                break
            save_state(i + 1)
    finally:
        if jsonl_f is not None:
            jsonl_f.close()

    with np.errstate(divide="ignore", invalid="ignore"):
        ber = np.nan_to_num(bit_errors / nb_bits)
        bler = np.nan_to_num(block_errors / nb_blocks)
    return ber, bler
