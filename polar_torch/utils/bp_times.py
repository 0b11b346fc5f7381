"""The BP kernel alone on the card at the shape of the benchmark cell
``bp20_n1024.wide_batch``, for comparing checkouts in one call: the
5G-ranked (1024, 512) code, BP-20 in scaled min-sum (msf 0.9375) with
early stop every 2 sweeps, bs 65536 at 2.0 dB through the chain's own
front end; the median of ten launches (CUDA events) with f32 and with bf16
messages, the converged share and a hash of the outputs and flags, as one
JSON line.

    python polar_torch/utils/bp_times.py ROOT [SEED]

times the ``polar_torch`` package under checkout ``ROOT`` (run by path,
so that ``ROOT``'s package is the one imported). Run checkouts in turns
(old, new, new, old) on one card, both sides of a turn at one seed: equal
hashes at a seed mean bit-equal outputs.
"""

import hashlib
import json
import os
import statistics
import sys

K, N, BS, EBNO_DB = 512, 1024, 65536, 2.0


def main(argv):
    root = os.path.abspath(argv[0])
    seed = int(argv[1]) if len(argv) > 1 else 0
    sys.path.insert(0, root)
    import torch
    import polar_torch as pt
    from polar_torch._device import card_info, resolve_device
    from polar_torch.models.polar.cuda_bp import bp_decode
    dev = resolve_device(None)
    card, power = card_info(dev)
    frozen, _ = pt.generate_5g_ranking(K, N)
    dec = pt.PolarBPDecoder(frozen, N, num_iter=20, mode="minsum",
                            msf=0.9375, early_stop=True, check_every=2,
                            llr_max=30.0, device=dev)
    model = pt.SystemAWGNModel(N, K, pt.PolarEncoder(frozen, N, device=dev),
                               dec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    llr = model.front(gen, BS, EBNO_DB)[2].t()
    kw = dict(num_iter=20, check_every=2, early_stop=True, mode="minsum",
              msf=0.9375, llr_max=30.0, negate=True, return_done=True)
    row = {"root": root, "seed": seed, "device": card, "power_limit": power}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for _ in range(2):
            out, done = bp_decode(llr, dec._prior, msg_dtype=dtype, **kw)
        ms = []
        for _ in range(10):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            bp_decode(llr, dec._prior, msg_dtype=dtype, **kw)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        digest = hashlib.sha256(out.contiguous().cpu().numpy().tobytes()
                                + done.cpu().numpy().tobytes())
        row[name] = {"ms": statistics.median(ms),
                     "converged": float(done.float().mean()),
                     "hash": digest.hexdigest()[:16]}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
