"""The comparison that decides ``correct``: a sample of whole chunks that
the window ran, judged against the plain reference of the configuration's
system (``portbench.reference.link``).

Each sampled chunk is ``(chunk, sim_ber seed, batches, ber, bler)``; a
batch is ``(generator seed, bits, codewords, llr, bits_hat)`` as the
program produced them. The reference draws and sends each batch again
from the seed that ``sim_ber`` derives for it (``channel.batch_seed``),
demaps it in float64 and decodes it on its own, and the numbers are:

* ``bits_differ``: payload bits unlike the reference's draws (the source
  and the harness's seeding);
* ``codeword_bits_differ``: sent bits unlike the reference's encoder;
* ``llr_err``: the largest |LLR - reference LLR| over the mean |reference
  LLR| (the mapper, channel and demapper);
* ``blocks_differ_share``: the share of the sampled blocks whose
  decisions differ from the reference decoder's on its own LLRs (in the
  configuration's float32);
* ``counts_differ``: |bit errors - the chunk's bit errors| + |block errors
  - its block errors|, the chunk's taken from ``sim_ber``'s BER and BLER
  and recounted here from the program's bits and decisions, plus the
  blocks of any batch the chunk is short of (the harness's counters).
"""

import numpy as np
import torch

from portbench import reference
from portbench.reference import channel

NAMES = ("bits_differ", "codeword_bits_differ", "llr_err",
         "blocks_differ_share", "counts_differ")


def judge(samples, cfg, traffic, device):
    """{name: {"value": number}} over the sampled chunks."""
    k = int(cfg["k"])
    bs, m = int(traffic["batch_size"]), int(traffic["batches_per_chunk"])
    rows = int(traffic.get("reference_rows", bs))
    link = reference.link(cfg, device)
    ebno = ebno_db(traffic)
    tot = dict.fromkeys(NAMES, 0)
    err_max = ref_abs = 0.0
    n_llr = n_blocks = 0
    for _, cs, batches, ber, bler in samples:
        bit_e = blk_e = 0
        for ii, (gseed, bits, cw, llr, bits_hat) in enumerate(batches):
            seed = channel.batch_seed(cs, 0, ii)
            rb, rcw, rllr = link.front(seed, bs, ebno, torch.float64)
            tot["bits_differ"] += _differ(bits, rb) + (gseed != seed) * k
            tot["codeword_bits_differ"] += _differ(cw, rcw)
            if llr.shape == rllr.shape:
                err_max = max(err_max,
                              (llr.double() - rllr).abs().max().item())
            else:
                err_max = float("inf")
            ref_abs += rllr.abs().sum().item()
            n_llr += rllr.numel()
            rbh = link.decode(rllr, rows)
            tot["blocks_differ_share"] += _blocks_differ(bits_hat, rbh)
            n_blocks += bs
            if bits_hat.shape != bits.shape:
                tot["counts_differ"] += bs        # a malformed batch
            else:
                wrong = bits.to(torch.int8) != bits_hat.to(torch.int8)
                bit_e += int(wrong.sum())
                blk_e += int(wrong.any(dim=-1).sum())
            del rb, rcw, rllr, rbh
        tot["counts_differ"] += (abs(round(ber * m * bs * k) - bit_e)
                                 + abs(round(bler * m * bs) - blk_e)
                                 + bs * abs(m - len(batches)))
    tot["blocks_differ_share"] /= max(n_blocks, 1)
    tot["llr_err"] = err_max / max(ref_abs / max(n_llr, 1), 1e-30)
    return {name: {"value": tot[name]} for name in NAMES}


def ebno_db(traffic):
    """The traffic's Eb/N0 point as ``sim_ber`` takes it (float32)."""
    return float(np.float32(traffic["ebno_db"]))


def _differ(x, ref):
    if x.shape != ref.shape:
        return ref.numel()
    return int((x.to(torch.int8) != ref.to(torch.int8)).sum())


def _blocks_differ(x, ref):
    if x.shape != ref.shape:
        return ref.shape[0]
    return int((x.to(torch.int8) != ref.to(torch.int8)).any(dim=-1).sum())
