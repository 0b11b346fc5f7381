"""Smoke run of the PyTorch port (``polar_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repo root; one card, nvcc
    python3 chip_smoke.py --parent DIR   # DIR: a checkout of the parent
                                         # commit, for phase 7's turns

It drives nine paths: the fast-SCL chain (phases 4 and 5), the CLI sweep
with SC, SCL-8 and BP-20 (phase 6), the 5G NR CA-SCL chain (phase 8),
BP's two-pass serving path and BP-20 with bf16 messages (phase 9), the
``--kern`` CLI path with OSD
(phase 10), the BEC link (phase 11), the 5G uplink UCI chain with PC bits
(phase 12) and the data-parallel and profiling tools over it (phase 13);
then the entry points a user runs, each in its own process: the headline
benchmark and the four walkthroughs (phase 14); then the probe kernels of
``benchmarks/probe_r4.py`` through their entry point (phase 15), which no
path of the system runs; then the SCL sweep's closing transform
(``butterfly_rows``, phase 16); last the plain chain's QPSK transmitter
(``qpsk_front``, phase 17).
Phases (any failure exits non-zero and prints no result):

1. the card: CUDA must be available; prints the card's name and power
   limit as ``nvidia-smi`` reports them;
2. build: compiles every kernel of the paths from ``polar_torch/csrc``, one
   ``nvcc`` per kernel, all started together; prints each kernel's
   registers, stack and shared memory, and the BP kernel's bf16 instances
   apart with their dynamic shared bytes per CTA;
3. kernels against their plain versions on the card, on the same CUDA
   inputs. The SCL subtree kernel (``scl_subtree``) against
   ``scl_subtree_plain``: at L=8 on a 5G k=32 n=64 code at b=3, on random
   masks (rate-1 and SPC nodes), and through the whole k=512 n=1024 sweep
   at the decoder's subtree depth and at a smaller one (so the outer sweep
   runs on the card too); at L=16 and 32 on the k=512 n=1024 fast schedule
   and random masks, min-sum and exact; at L=8 b=10 and L=32 b=8, where
   the upper workspace stages go to the global scratch, min-sum and
   exact; the plain sweep of the 5G k=400 E=1000 mother code at L=8, 16
   and 32 in exact mode, at the decoder's depth (the whole tree) and at
   b=6, where it runs on the traced form (frozen flags as data), against
   the plain version and bit for bit against the static form at b=6.
   Codewords and parent maps must agree on >= 99.8% of blocks, path
   metrics to 1e-5 relative on the agreeing blocks. The same holds for the plain (unpruned) SCL-8 sweep at k=512
   n=1024. The SC subtree kernel (``sc_subtree``) against
   ``sc_subtree_plain``: random masks at b = 1..10, static (ops z/f/i) and
   traced (op t) forms, at the default group size and split, at 32 lanes
   and at 4 lanes with every workspace stage in the global scratch, on a
   batch no block's codeword count divides, and the 5G k=512 n=1024 code
   at the SC decoder's depth and as the whole tree. Min-sum must agree on every block, exact
   mode on >= 99.9% of blocks. The BP kernel (``bp_decode``) against
   ``bp_decode_plain``: n = 64..2048 with the lattice in shared memory
   (the tiled schedule: groups of three stages, the top group of one,
   two or three), n = 4096 and n = 1024 with it in global memory; scaled
   and unscaled min-sum, early stop on and off, odd sweep counts and
   check_every 1, 2 and 3, the convergence flags returned; exact mode at
   n = 1024. Min-sum must be bit-equal (every LLR and flag); in exact mode
   the hard decisions must agree on every block the plain version marks
   converged and on >= 99% of all blocks, since ``expf``/``log1pf`` and
   ``torch.logaddexp`` round differently. The same for the kernel's bf16
   instance against ``bp_decode_plain(msg_dtype=torch.bfloat16)``: at
   n = 1024 (shared and forced global), 2048 (shared), 4096 (global) and
   256, min-sum bit-equal, exact mode at
   n = 1024 under the same rule. On BEC inputs (the logits of
   ``BinaryErasureChannel(return_llrs=True)`` at pe = 0.3 and 0.45, 8192
   blocks each: +-100, erasures as -0.0 and +0.0) the SCL kernel on the
   plain SCL-8 sweep and the fast sweep with rate-1 nodes (the block rule
   above) and the SC kernel at the SC decoder's depth (every block), whose
   decisions must not change when the zeros change sign. PC schedules
   (the ``'p'`` leaf, the whole tree in one call): the plain SCL sweep at
   L = 8 and 32 and the SC sweep of the mother codes of the uplink (19,
   864) and (12, 48) codes, min-sum and exact, on random LLRs and on the
   noiseless +-10 logits of encoded payloads, 8192 blocks each; min-sum
   must agree on every block with bit-equal path metrics;
4. the main path: ``SystemAWGNModel.step`` (source -> 5G k=512 n=1024
   polar encoder -> QPSK -> AWGN -> demapper -> SCL-8 min-sum fast-SCL
   decoder with rate-1 nodes) at a batch of 8192 codewords and 2.0 dB,
   built and timed by ``polar_torch.bench``'s ``build_model`` and
   ``time_steps`` (one warm-up step, 10 timed steps, the counts summed on
   the card, one synchronisation), with every kernel's launch count reset
   just before and read just after; prints info bit/s and ms per step;
5. BLER at 1.5 dB over 32768 blocks against the ``scl8_n1024_fast_r1`` row
   of ``benchmarks/bler_validation.json`` (+-0.006, about 4 sigma);
6. the CLI path: ``polar_torch.main.sweep`` at k=512 n=1024 (5G), bs=8192,
   4 batches per point at 1.5 and 2.0 dB, ``algos=["scl", "bp"]``: SC on
   the ``sc_subtree`` kernel, SCL-8 on the plain sweep and the
   ``scl_subtree`` kernel (the whole tree, one call), then BP-20 on the
   ``bp`` kernel, with every launch count reset just before and read just
   after. Gates: SC BLER at 2.0 dB within +-0.011 of ``sc_n1024``, SCL-8
   BLER at 1.5 dB within +-0.007 of ``scl8_n1024``, BP-20 BLER at 2.0 dB
   within +-0.012 of ``bp_n1024`` (about 4 sigma of both samples
   combined);
7. where the time goes: the SC, plain SCL, fast SCL and CA-SCL-32 depth
   surveys, the SCL kernel's registers, stack and shared memory, its
   registers, stack and spills from ``-Xptxas -v`` and its resident blocks
   an SM at b = 10 for every list size; with ``--parent``, the decode
   kernel alone (profiled) against the parent's build in turns (P C C P,
   outputs bit for bit the same) on five decodes: scl8's fast SCL-8, the
   uplink (19, 864) CA-SCL-8 PC decode, CA-SCL-32 at b = 10, the CLI's
   plain SCL-8 at b = 10 and CA-SCL-8 on the traced form at b = 6; its time
   with the workspace split between shared memory and the global scratch
   at other points than the budget's (fast SCL-8 at b = 6, 8 and the
   default), a breakdown of a whole-tree L=32 call (as decoded, min-sum,
   every leaf frozen, the descent alone), kernel, plain and bound times
   over one decode, one BP-20 decode (bs=8192, 2.0 dB) with early stop on
   and off and its mean sweeps per codeword, with f32 and with bf16
   messages, the BP and SC kernels' registers, stack and shared memory,
   their resident blocks per SM (BP at n = 1024, 2048 and 4096, both
   message types), SC's time at b = 8..10 with 4..32 lanes and other
   shared splits, and one profiled main-path step;
8. the 5G path: ``Polar5GEncoder`` (uplink k=400 E=1000, CRC11,
   n_polar=1024) -> QPSK -> AWGN -> demapper -> ``Polar5GDecoder`` in exact
   mode through ``sim_ber`` at 1.5 dB: CA-SCL-8 and hybSCL-8 at bs=8192,
   CA-SCL-32 at bs=2048, and CA-SCL-8 at b=6 (the kernel's traced form)
   at bs=8192, each with the launch counts reset just before and read just
   after. Gates: CA-SCL-8 (both depths) and hybSCL-8 BLER within about 4
   sigma of ``5g_cascl8_k400_n1000`` and ``hybscl8_5g_k400_n1000``;
   CA-SCL-32 BLER at or below the CA-SCL-8 yardstick. Prints info bit/s, decoder ms
   per batch, and the kernel's ms per decode with launches and bound;
9. BP's two-pass serving path at 2.0 dB: ``PolarBPDecoder(two_pass=True,
   first_pass_iters=8)`` bit-identical to the single-pass decoder on one
   batch of 8192 (hard and soft outputs), then through ``sim_ber`` (4
   batches of 8192) with the launch counts reset just before and read just
   after; BLER on the ``bp_n1024`` gate, info bit/s. Then bf16 messages:
   the two-pass decoder bit-identical to the single-pass one (soft
   outputs), and BP-20 with ``msg_dtype=torch.bfloat16`` through
   ``sim_ber`` (4 batches of 8192) with the launch counts reset just before
   and read just after, its BLER within 4 sigma of both samples combined
   of ``PORT_YARDSTICKS["bp20_n1024_bf16"]`` (JAX's bf16 engine on the
   CPU) and on the ``bp_n1024`` gate;
10. the ``--kern`` CLI path: ``polar_torch.main.sweep`` with ``--kern G16
    --n 256 --k 128 --construction rm-ref --osd_t 2`` (dense-G encoder,
    OSD-2; no CUDA kernel) at bs=1024, 4 batches at 2.0 and 3.0 dB, and
    OSD-2 on the 5G (64, 128) F2 code with codeword estimates
    (``pattern_chunk=1024``) through ``sim_ber``, 8 batches of 1024 at
    2.0 dB. Gates: each BLER within 4 sigma of both samples combined of
    its yardstick (``PORT_YARDSTICKS``: the JAX package on the CPU); on one
    batch the card's OSD against the same decoder on the CPU, every card
    codeword valid and a block differing only where the two codewords'
    float64 distances agree to 1e-6 relative. Prints info bit/s, ms per
    batch and the OSD's split into sort and elimination and pattern sweep;
11. the BEC link: ``SystemBECModel`` (5G k=512 n=1024) with the CLI's SC
    and SCL-8 decoders through ``sim_ber`` at pe = 0.38 and 0.42, 4
    batches of 8192 each, BLER gated as in phase 10; the GA construction
    (``generate_ga_code(512, 1024, 2.0)``, g++ build) equal to its NumPy
    twin's;
12. the 5G uplink UCI chain: ``Polar5GEncoder(19, 864)`` (n_polar 256,
    CRC6, 3 PC bits, one placed by row weight) -> QPSK -> AWGN -> exact
    demapper -> ``Polar5GDecoder`` in exact mode, SC, CA-SCL-8 and
    hybSCL-8 through ``sim_ber`` at 4.5 dB, then CA-SCL-8 on (12, 48) at
    2.0 dB, 4 batches of 8192 each, with the launch counts reset just
    before each run and read just after; each BLER within 4 sigma of both
    samples combined of its ``PORT_YARDSTICKS`` row; prints info bit/s,
    decoder ms per batch and the kernels' ms per decode beside the bound;
13. the tools over phase 12's CA-SCL-8 chain: ``ShardedSystem`` with a
    world of one on NCCL (a localhost store), 2 batches through
    ``sim_ber``, its counters equal to the unsharded model's on the same
    derived generators; ``trace`` of one step, whose file must name the
    SCL kernel; ``flop_estimate`` of one decode and one step beside the
    kernel call's own work count;
14. the entry points, each in its own process on the card:
    ``python -m polar_torch.bench`` at its defaults (k=512 n=1024 SCL-8,
    bs=8192, 8 warm-up and 24 timed steps), which must exit 0 and print
    one JSON line with every key, the card's name and power limit as
    ``nvidia-smi`` reports them, info bit/s > 0 and ``scl_subtree``
    launches; its figure is logged beside phase 4's with their ratio (not
    gated). Then ``examples/torch_01`` ... ``torch_04`` side by side at
    small sizes (``torch_03`` over every card present, NCCL): each must
    exit 0, print its result lines and launch the kernels of its path
    (``sc_subtree``, ``scl_subtree`` and ``bp``; ``scl_subtree`` and
    ``sc_subtree``; ``scl_subtree``; ``scl_subtree``);
15. the probe kernels (``polar_torch.probes``, ``csrc/probes.cu``): every
    step of the entry point in this process, with the probes' launch
    counts reset just before and read just after: each kernel launched,
    0 elements differing from its plain version at the script's draw (bit
    for bit), its ms per launch over 200 launches (CUDA events; the host
    paces launches this short). Then each kernel against its plain version
    at another draw, 0 elements differing (the stage sweeps also on f32 of
    random bits at [64, 512] and [64, 768], on every ordered pair of NaNs,
    +-1 and +-0 at each stage of ``k_sweepcombo`` and on normal values at
    [64, 768]; ``int8`` also on every int8 value at ``INT8_SHAPES``, each
    as it is and one byte past a 16-byte boundary); the kernel's own
    device time
    (torch.profiler, 20 launches) beside its plain version's, the library
    call's (``torch.gather`` for ``gather``, ``torch.amin`` for
    ``reduce``) and its bound. For those two also the library kernel's
    own device time (profiler) and the kernel's and the library call's ms a
    launch in turns (kernel, library, library, kernel, ...: the medians of
    five runs of 200 launches each, with their ratio; not gated). Then
    ``k_big``'s two instances in the SASS (``cuobjdump -sass``): 40
    shuffles a sweep each (every cross-lane stage of every sweep kept),
    with their counts of min, select, logic and barrier instructions
    logged; ``int8``'s vector instance: its 16-byte loads and stores, and
    no loop (no branch back). Then ``python -m polar_torch.probes`` in its own process,
    which must exit 0 and print one line a step;
16. the SCL sweep's closing transform (``butterfly_rows``,
    ``csrc/butterfly.cu``) against its plain version, 0 elements
    differing: at the main paths' shapes (fast SCL-8 [1, 1024, 65536] and
    the uplink UCI chain at bs 65536 [1, 256, 524288], int32; the plain
    sweep at b=8 [4, 256, 16384], int8) and at every width w = 2..4096 on
    ragged column counts with bits above bit 0 set; one decode each of
    fast SCL-8, CA-SCL-8 on the uplink (19, 864) code with PC bits and
    plain SCL-8 at b=8 must launch it once, with the decisions the plain
    transform gives; then its ms a launch (CUDA events over 50 launches)
    and alone (profiler) at those shapes beside its bound, its plain
    version's time and the parent's torch transform's (the int8 cast, the
    stack and ``polar_transform`` on [m, w, L, bs]);
17. the QPSK transmitter (``qpsk_front``, ``csrc/qpsk_front.cu``): each
    instance's registers and spills from ``-Xptxas -v``; against its plain
    version at every width n = 2..4096 (random frozen sets, a batch no
    tile divides), 0 elements differing; the k=512 n=1024 chain's kernel
    path against the composed chain at bs 65536 and 8192 (bits, codewords
    and LLRs bit for bit, the generator left alike); then its ms a launch
    (CUDA events over 50 launches) and alone (profiler) beside its bound
    (``kernel_work.qpsk_front_work``), and the kernel path's whole front
    end beside the composed chain's and the plain version's. Phase 4's
    main path must launch it once a step.

The line before the card's line is one JSON object ``{"kernels": [...]}``
with each kernel form's launches on its path (``scl_subtree`` static
L <= 8: the fast-SCL chain; ``scl_subtree`` L=16/32: the 5G path's
CA-SCL-32; ``scl_subtree`` traced: the 5G path's CA-SCL-8 at b=6;
``sc_subtree`` and ``bp``: the CLI sweep; ``bp_bf16``: phase 9's bf16
BP-20 run), its disagreement with the
plain version (for ``bp``: the largest min-sum LLR gap, and the blocks
that differ in min-sum or, in exact mode, in their decisions; for
``scl_subtree`` and ``sc_subtree`` also the BEC blocks checked, and with
a ``pc_`` prefix the PC path's launches in phase 12, the PC blocks checked
in phase 3 and the times of one (19, 864) decode), and its time, the
plain version's time and its bound at the path's shape; then one entry a
probe (``probe <name>``: launches on phase 15's path, elements checked
and differing over both draws, times at the script's shapes; for
``gather`` and ``reduce`` also ``library_device_ms``, the in-turn medians
``turns_ms`` and ``library_turns_ms``), one for ``butterfly_rows``
(phase 16's launches, elements checked and differing, and its times at
each shape) and one for ``qpsk_front`` (phase 4's launches, phase 17's
elements, registers, spills and times). The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

K, N, LIST_SIZE, MODE = 512, 1024, 8, "minsum"
BATCH = 8192
EBNO_MAIN_DB = 2.0
EBNO_BLER_DB, BLER_BLOCKS, BLER_TOL = 1.5, 32768, 0.006
SURVEY_DEPTHS = range(5, 11)        # subtree depths b timed at the end
SC_SURVEY_DEPTHS = range(4, 11)
PLAIN_SURVEY_DEPTHS = range(4, 11)  # the plain SCL-8 sweep's depths
BLOCK_AGREEMENT, PM_RTOL = 0.998, 1e-5
SC_EXACT_AGREEMENT = 0.999          # min-sum SC must agree on every block
SC_CHECK_BATCH = 4099            # no block's codeword count divides it
CLI_EBNO_DB, CLI_MC_ITER = (1.5, 2.0), 4
CLI_GATES = (("SC", "sc_n1024", 2.0, 0.011),
             ("SCL-8", "scl8_n1024", 1.5, 0.007),
             ("BP-20", "bp_n1024", 2.0, 0.012))
# BP: the CLI's BP-20 (scaled min-sum, msf 0.9375, early stop every 2
# sweeps) and the kernel checks, (n, bs, lattice, msf, early stop, sweeps,
# check_every, mode); n <= 1024 on the 5G code, beyond on the RM-style one
BP_ITER, BP_EBNO_DB = 20, 2.0
# (n, bs, lattice, msf, early stop, sweeps, check_every, mode): S = 6..11
# end the tiled schedule's groups of three stages on a group of three, one
# or two
BP_CASES = ((64, 4096, "auto", 1.0, True, 21, 1, "minsum"),
            (128, 4096, "auto", 0.9375, True, 11, 3, "minsum"),
            (256, 4096, "auto", 0.9375, True, 21, 2, "minsum"),
            (512, 4096, "auto", 0.9375, True, 13, 3, "minsum"),
            (1024, BATCH, "auto", 0.9375, True, BP_ITER, 2, "minsum"),
            (1024, BATCH, "auto", 0.9375, False, BP_ITER, 2, "minsum"),
            (1024, 4096, "auto", 1.0, True, 9, 1, "minsum"),
            (1024, 2048, "global", 0.9375, True, BP_ITER, 2, "minsum"),
            (2048, 2048, "auto", 0.9375, True, 13, 1, "minsum"),
            (2048, 2048, "auto", 0.9375, True, 13, 3, "minsum"),
            (4096, 256, "auto", 0.9375, True, 9, 2, "minsum"),
            (1024, BATCH, "auto", 0.9375, True, BP_ITER, 2, "exact"))
BP_EXACT_AGREEMENT = 0.99
# the bf16 instance's checks, the same fields: n = 1024 in shared memory
# and forced global, 2048 (shared), 4096 (global), and a small unscaled
# case
BP_BF16_CASES = ((1024, BATCH, "auto", 0.9375, True, BP_ITER, 2, "minsum"),
                 (1024, BATCH, "auto", 0.9375, False, BP_ITER, 2, "minsum"),
                 (1024, 2048, "global", 0.9375, True, 13, 3, "minsum"),
                 (2048, 2048, "auto", 0.9375, True, 13, 1, "minsum"),
                 (4096, 256, "auto", 0.9375, True, 9, 2, "minsum"),
                 (256, 4096, "auto", 1.0, True, 21, 2, "minsum"),
                 (1024, BATCH, "auto", 0.9375, True, BP_ITER, 2, "exact"))
BP_BF16_YARDSTICK = "bp20_n1024_bf16"
# the 5G path: uplink k=400 E=1000 (CRC11, n_polar=1024) in exact mode, as
# the yardsticks ran. (name, dec_type, list size, batch, batches, yardstick,
# its sample: blocks, subtree depth or None for the decoder's own).
# CA-SCL-32 has no yardstick of its own: its BLER must not exceed
# CA-SCL-8's. The decoders' own depth is the whole tree, a static leaf
# schedule; at TRACED_B the plain sweep has 16 subtrees, more than 8, and
# runs them on the kernel's traced form.
G5_K, G5_E, G5_MODE, G5_EBNO_DB = 400, 1000, "exact", 1.5
TRACED_B = 6
G5_DECODERS = (("CA-SCL-8", "SCL", 8, 8192, 8, "5g_cascl8_k400_n1000",
                299008, None),
               ("hybSCL-8", "hybSCL", 8, 8192, 8, "hybscl8_5g_k400_n1000",
                37376, None),
               ("CA-SCL-32", "SCL", 32, 2048, 16, None, None, None),
               (f"CA-SCL-8 at b={TRACED_B}", "SCL", 8, 8192, 4,
                "5g_cascl8_k400_n1000", 299008, TRACED_B))
WIDE_BATCH = 2048                   # the L=16/32 rows' batch
WIDE_SURVEY_DEPTHS = range(3, 11)   # the CA-SCL-32 decoder's depths
SEED = 0
# BEC logits (+-100, erasures as signed zeros) for the SC and SCL kernel
# checks of phase 3, BATCH blocks at each erasure probability
BEC_CHECK_PE = (0.3, 0.45)
# phase 10: the --kern CLI path (dense-G encoder over the reference zoo's
# G16 kernel, OSD-2) and OSD-2 on the 5G (64, 128) F2 code with codeword
# estimates (the osd2_k64_n128 row of benchmarks/throughput_suite.py)
KERN_CODE = dict(k=128, n=256, kern="G16", construction="rm-ref", osd_t=2)
KERN_BS, KERN_MC_ITER, KERN_EBNO_DB = 1024, 4, (2.0, 3.0)
OSD2_K, OSD2_N, OSD2_BS, OSD2_BATCHES = 64, 128, 1024, 8
OSD2_CHUNK, OSD2_EBNO_DB = 1024, 2.0
# a card codeword may differ from the CPU's only where the two float64
# distances agree to this relative gap (an equally good codeword)
OSD_TIE_RTOL = 1e-6
# phase 11: the BEC link, SC and SCL-8 on the 5G k=512 n=1024 code
BEC_PE, BEC_BATCHES = (0.38, 0.42), 4
GA_CODE = (512, 1024, 2.0)          # generate_ga_code(k, n, design Eb/N0)
# BLER yardsticks of phases 10 and 11, (block errors, blocks): the JAX
# package on the CPU through polar_tpu.sim.sim_ber, seed 7, 64 batches of
# 256, made with
#   JAX_PLATFORMS=cpu python tests/make_torch_yardsticks.py --blocks 16384
#       --bs 256
PORT_YARDSTICKS = {
    "g16_osd2_2.0": (3037, 16384), "g16_osd2_3.0": (427, 16384),
    "osd2_k64_n128": (1336, 16384),
    "bec_sc_0.38": (4138, 16384), "bec_sc_0.42": (12128, 16384),
    "bec_scl8_0.38": (73, 16384), "bec_scl8_0.42": (1048, 16384),
    # phase 12, the same script and settings, made with
    #   JAX_PLATFORMS=cpu python tests/make_torch_yardsticks.py --blocks
    #       16384 --bs 256 --only pc_sc_k19_e864 pc_scl8_k19_e864
    #       pc_hybscl8_k19_e864 pc_scl8_k12_e48
    "pc_sc_k19_e864": (3306, 16384), "pc_scl8_k19_e864": (305, 16384),
    "pc_hybscl8_k19_e864": (367, 16384), "pc_scl8_k12_e48": (1323, 16384),
    # phase 9's bf16 BP-20, the same script and settings, made with
    #   ... --only bp20_n1024_bf16
    "bp20_n1024_bf16": (1942, 16384),
}
# phase 3's PC schedules: the mother codes of the uplink (k, E) codes with
# 3 PC bits, the whole tree as one call, at these list sizes
PC_CHECK_CODES = ((19, 864), (12, 48))
PC_CHECK_LISTS = (8, 32)
# phase 12: the 5G uplink UCI chain (TS 38.212 5.3.1.2: CRC6 and 3 PC bits
# for 12 <= A <= 19), Polar5GEncoder(19, 864) (n_polar 256; E - K + 3 > 192
# puts one PC bit by row weight) in exact mode, SC, CA-SCL-8 and hybSCL-8
# at UCI_EBNO_DB, where every yardstick BLER lies in 0.01-0.3; CA-SCL-8 on
# (12, 48) at UCI_SMALL_EBNO_DB. (name, dec_type, yardstick)
UCI_K, UCI_E, UCI_MODE, UCI_EBNO_DB, UCI_BATCHES = 19, 864, "exact", 4.5, 4
UCI_DECODERS = (("SC", "SC", "pc_sc_k19_e864"),
                ("CA-SCL-8", "SCL", "pc_scl8_k19_e864"),
                ("hybSCL-8", "hybSCL", "pc_hybscl8_k19_e864"))
UCI_SMALL_K, UCI_SMALL_E, UCI_SMALL_EBNO_DB = 12, 48, 2.0
# phase 13: batches of the sharded run
SHARDED_BATCHES = 2
# phase 14: the entry points a user runs, each in its own process: the
# benchmark at its defaults, then the walkthroughs side by side at small
# sizes, (script, arguments, the kernels its run must launch, the result
# lines it must print); torch_03 runs over every card present
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_step", "bs",
              "iters", "lower_stages", "scl_subtree_launches", "device",
              "power_limit"}
EXAMPLE_RUNS = (
    ("torch_01_bler_sweep.py", ["--max-mc-iter", "2"],
     ("sc_subtree", "scl_subtree", "bp"),
     (r"^SC: BLER \[", r"^SCL-8: BLER \[", r"^BP-20: BLER \[")),
    ("torch_02_5g_chain.py", [], ("scl_subtree", "sc_subtree"),
     (r"^BER \S+; CRC pass rate \S+$", r"^hybSCL BER \S+$")),
    ("torch_03_multichip.py", ["--max-mc-iter", "2"], ("scl_subtree",),
     (r"^world of \d+ \(nccl\)", r"^BER :", r"^BLER:")),
    ("torch_04_osd_any_linear_code.py", [], ("scl_subtree",),
     (r"^OSD-2 codeword BER \S+  \(SCL-8 info BER \S+\)$",)),
)
ENTRY_TIMEOUT_S = 300

# phase 15: the probes' second draw (the entry point's path runs the
# script's); the calls of the profiled loop and of the plain version's
# timed one; the timed runs of kernel and library call each, in turns
PROBE_OTHER_SEED = 11
PROBE_FEW_REPS = 20
PROBE_TURN_ROUNDS = 5
# the stage sweeps, also checked on NaN, zero and wider inputs; the wider
# width; k_big's shuffles a sweep in its SASS (5 cross-lane stages of a
# lane's 8 rows)
PROBE_SWEEPS = ("sweepcombo", "bigsweep", "bigsweep_noloop")
PROBE_WIDE_COLS = 768
BIG_SHFL_A_SWEEP = 40
# int8's other inputs: ragged shapes (a partial 16-byte unit, a width not
# a multiple of 16; many CTAs), each also as a view one byte past a
# 16-byte boundary; its kernel's 16-byte loads a thread
INT8_SHAPES = ((3, 17), (32, 250), (32, 256), (1000, 1000))
INT8_VEC_LOADS = 2
SMEM_OPT_IN = 232448                # shared memory a block may opt in to


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def resource_usage(libs):
    """Registers, stack and shared memory of each kernel in the built
    libraries, as ``cuobjdump -res-usage`` reports them."""
    from polar_torch import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return ["resource usage: cuobjdump not found (not measured)"]
    lines, name = [], None
    for lib in libs:
        out = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                             text=True, timeout=60).stdout
        for line in out.splitlines():
            if "Function" in line:
                name = line.split("Function", 1)[1].strip(" :")
            elif "REG:" in line and name:
                lines.append(f"{name}: {' '.join(line.split()[:4])}")
                name = None
    return lines


def bp_bf16_resources(lib):
    """The BP kernel's bf16 instances' lines of ``resource_usage``, named
    ``bp_kernel_tiled<S, mode, bf16>`` (the shared lattice, at n = 1024
    and 2048) and ``bp_kernel<bf16>`` (the global one)."""
    import re
    out = []
    for line in resource_usage([lib]):
        tiled = re.search(r"bp_kernel_tiledILi(1[01])ELi(\d)ELb1E", line)
        if tiled:
            out.append(f"bp_kernel_tiled<{tiled[1]}, {tiled[2]}, bf16>: "
                       f"{line.split(': ', 1)[1]}")
        elif re.search(r"bp_kernelILb1E", line):
            out.append(f"bp_kernel<bf16>: {line.split(': ', 1)[1]}")
    return out or ["bf16 instances: resource usage not measured"]


def binomial_gate(name, errors, blocks, key):
    """Fails unless the BLER ``errors / blocks`` lies within 4 sigma of
    both samples combined of the yardstick ``PORT_YARDSTICKS[key]``."""
    import numpy as np
    want_err, want_blocks = PORT_YARDSTICKS[key]
    want, got = want_err / want_blocks, errors / blocks
    tol = 4.0 * np.sqrt(want * (1.0 - want)
                        * (1.0 / blocks + 1.0 / want_blocks))
    log(f"{name} BLER {got:.5f} over {blocks} blocks; yardstick {key} "
        f"{want:.5f} over {want_blocks} +- {tol:.5f}")
    if abs(got - want) > tol:
        raise AssertionError(f"{name} BLER {got} is off the yardstick {want}")


def osd_distance(llr, c, llr_max):
    """Float64 OSD distance of codewords ``c [bs, n]`` for the logits
    ``llr [bs, n]``: mean softplus(clip(llr) * (1 - 2c))."""
    import torch
    llr = llr.double().clamp(-llr_max, llr_max)
    sgn = llr * (1.0 - 2.0 * c.double())
    return torch.logaddexp(torch.zeros((), dtype=torch.float64,
                                       device=sgn.device), sgn).mean(-1)


def osd_card_against_cpu(label, osd, cpu_osd, llr, valid):
    """One batch through ``osd`` on the card and ``cpu_osd``, the same
    decoder on the CPU: every card codeword valid (``valid(c) -> [bs]``
    bools), and a block may differ only under the tie rule. Returns the
    (differing, blocks) counts."""
    import torch
    card = osd(llr)
    cpu = cpu_osd(llr.cpu()).to(llr.device)
    if not bool(valid(card).all()):
        raise AssertionError(f"{label}: an invalid codeword on the card")
    bad = (card != cpu).any(-1)
    gap = (osd_distance(llr[bad], card[bad], osd._llr_max)
           - osd_distance(llr[bad], cpu[bad], osd._llr_max)).abs()
    rel = gap / osd_distance(llr[bad], cpu[bad], osd._llr_max).clamp_min(
        1e-12)
    worst = rel.max().item() if rel.numel() else 0.0
    n_bad = int(bad.sum().item())
    log(f"  {label}: card against CPU, {n_bad} of {bad.numel()} blocks "
        f"differ, largest distance gap {worst:.3g} relative (tie rule "
        f"{OSD_TIE_RTOL}); every card codeword valid")
    if worst > OSD_TIE_RTOL:
        raise AssertionError(f"{label}: the card's OSD differs from the "
                             "CPU's beyond a distance tie")
    torch.cuda.synchronize()
    return n_bad, bad.numel()


def osd_split_ms(osd, llr, reps):
    """Device ms of one OSD decode of ``llr``: the whole decode, its
    reliability sort and elimination (``basis``) and its pattern sweep
    (``sweep``), CUDA events."""
    from polar_torch.utils.profiling import cuda_ms
    total = cuda_ms(lambda: osd.decode(llr), reps=reps)
    front = cuda_ms(lambda: osd.basis(llr), reps=reps)
    _, llr_sort, c, gm_mrb = osd.basis(llr)
    sweep = cuda_ms(lambda: osd.sweep(llr_sort, c, gm_mrb), reps=reps)
    return total, front, sweep


class ScCheck:
    """Accumulates SC kernel-vs-plain comparisons of codewords or
    decisions ([rows, bs] integers); fails on the first miss. Min-sum must
    agree on every block, exact mode on ``SC_EXACT_AGREEMENT``."""

    def __init__(self):
        self.blocks = {"minsum": 0, "exact": 0}
        self.bad = {"minsum": 0, "exact": 0}
        self.max_abs = 0

    @property
    def n_bad(self):
        return sum(self.bad.values())

    @property
    def n_blocks(self):
        return sum(self.blocks.values())

    def add(self, label, mode, want, got):
        import torch
        diff = (want.to(torch.int32) - got.to(torch.int32)).abs()
        bad = diff.flatten(0, -2).any(0)
        n_bad, n_blocks = int(bad.sum().item()), bad.numel()
        share = 1.0 - n_bad / n_blocks
        log(f"  {label}, {mode}: blocks agree {share:.6f} ({n_bad} of "
            f"{n_blocks} differ)")
        need = 1.0 if mode == "minsum" else SC_EXACT_AGREEMENT
        if share < need:
            raise AssertionError(f"{label}, {mode}: kernel disagrees with "
                                 f"the plain version (share {share})")
        self.blocks[mode] += n_blocks
        self.bad[mode] += n_bad
        self.max_abs = max(self.max_abs, int(diff.max().item()))


def differing(want, got):
    """[bs] mask of the blocks whose codewords or parent maps differ
    between two (cw, P, pm) results."""
    return ((want[0] != got[0]).flatten(0, -2).any(0)
            | (want[1] != got[1]).any(0))


def agreement(want, got):
    """(share of agreeing blocks, max relative and absolute path-metric
    gap on them, differing block count) of two (cw, P, pm) results."""
    pm_w, pm_g = want[2], got[2]
    bad = differing(want, got)
    ok = ~bad
    gap = (pm_w - pm_g).abs()[:, ok]
    rel = gap / pm_w.abs()[:, ok].clamp_min(1e-6)
    return (1.0 - bad.float().mean().item(),
            rel.max().item() if rel.numel() else 0.0,
            gap.max().item() if gap.numel() else 0.0,
            int(bad.sum().item()))


class BpCheck:
    """Accumulates BP kernel-vs-plain comparisons of (out [n, bs], done
    [bs]) pairs; fails on the first miss. Min-sum must be bit-equal; exact
    mode must agree in its hard decisions (info rows) on every block the
    plain version marks converged and on ``BP_EXACT_AGREEMENT`` of all."""

    def __init__(self):
        self.n_blocks = self.n_bad = 0
        self.max_abs = 0.0

    def add(self, label, mode, info, want, got):
        (out_w, done_w), (out_g, done_g) = want, got
        if mode == "minsum":
            bad = (out_w != out_g).any(0) | (done_w != done_g)
            self.max_abs = max(self.max_abs,
                               (out_w - out_g).abs().max().item())
            need = 1.0
        else:
            bad = ((out_w <= 0) != (out_g <= 0))[info].any(0)
            if bad[done_w > 0].any():
                raise AssertionError(f"{label}: decisions differ on a block "
                                     "the plain version marks converged")
            need = BP_EXACT_AGREEMENT
        n_bad, n_blocks = int(bad.sum().item()), bad.numel()
        share = 1.0 - n_bad / n_blocks
        log(f"  {label}, {mode}: blocks agree {share:.6f} ({n_bad} of "
            f"{n_blocks} differ), {int(done_w.sum().item())} converged"
            + (" (decisions)" if mode == "exact" else "")
            + f"; llr max abs gap {(out_w - out_g).abs().max().item():.3g}")
        if share < need:
            raise AssertionError(f"{label}: kernel disagrees with the plain "
                                 f"version (share {share})")
        self.n_blocks += n_blocks
        self.n_bad += n_bad


class Check:
    """Accumulates kernel-vs-plain comparisons; fails on the first miss."""

    def __init__(self):
        self.n_blocks = self.n_bad = 0
        self.max_abs = self.max_rel = 0.0

    def add(self, label, want, got):
        share, rel, gap, n_bad = agreement(want, got)
        n_blocks = want[2].shape[-1]
        log(f"  {label}: blocks agree {share:.6f} ({n_bad} of {n_blocks} "
            f"differ), pm max rel {rel:.3g}, max abs {gap:.3g}")
        if share < BLOCK_AGREEMENT or rel > PM_RTOL:
            raise AssertionError(f"{label}: kernel disagrees with the plain "
                                 f"version (share {share}, pm rel {rel})")
        self.n_blocks += n_blocks
        self.n_bad += n_bad
        self.max_abs = max(self.max_abs, gap)
        self.max_rel = max(self.max_rel, rel)
        return n_bad


def near_tie_gaps(a, pm, ops, cols, **kw):
    """For blocks ``cols``: the smallest nonzero gap, absolute and relative
    to the block's best path metric, between the L-th and (L+1)-th best
    candidate over the plain version's forks, i.e. how close the block
    came to another decision. (Exact ties, such as the initial clones'
    equal metrics, are broken alike by both versions.)"""
    import torch
    from polar_torch.models.polar import cuda_scl
    gaps = []
    top_l = cuda_scl._top_l

    def recording_top_l(pmc, L):
        srt = torch.sort(pmc, dim=0).values
        gaps.append(srt[L] - srt[L - 1])
        return top_l(pmc, L)

    cuda_scl._top_l = recording_top_l
    try:
        _, _, pm_out = cuda_scl.scl_subtree_plain(a[..., cols], pm[:, cols],
                                                  ops, **kw)
    finally:
        cuda_scl._top_l = top_l
    gap = torch.stack(gaps).abs()
    gap = gap.where(gap > 0, torch.inf).min(0).values
    return [(c, g, g / p) for c, g, p in zip(
        cols, gap.tolist(), pm_out.min(0).values.tolist())]


def recorder(calls, subtree):
    """``subtree`` that also appends each call's (args, kwargs) to
    ``calls``."""
    def recording(*args, **kw):
        calls.append((args, kw))
        return subtree(*args, **kw)
    return recording


def profile_step(model, gen, top=8, ebno_db=EBNO_MAIN_DB):
    """Device time by kernel over one step of ``model`` at ``ebno_db``
    (torch.profiler; by default the main path's), and the device's busy
    share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    model.step(gen, BATCH, ebno_db)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.step(gen, BATCH, ebno_db)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only (kernels, copies): an operator's entry
    # repeats the time of the kernels it launched
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile: one step {wall_ms:.3f} ms wall (profiled), device busy "
        f"{busy:.3f} ms ({busy / wall_ms:.1%})")
    for ms, key, count in rows[:top]:
        log(f"  {ms:9.3f} ms  {count:4d}x  {key[:90]}")


def kernel_device_ms(fn, reps, match):
    """Mean device time of the kernels whose name holds ``match`` over
    ``reps`` calls of ``fn`` (torch.profiler), without the host's pacing
    of back-to-back launches; None where the profiler saw none."""
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
              and match in e.key]
    count = sum(e.count for e in events)
    return (sum(e.self_device_time_total for e in events) / 1e3 / count
            if count else None)


def kern_phase(dev, gen, card, reset_counts, counts):
    """Phase 10: the ``--kern`` CLI sweep (G16, OSD-2) and OSD-2 on the 5G
    (64, 128) code through ``sim_ber``, each BLER against its yardstick;
    the card's OSD against the CPU's on one batch; OSD's time split."""
    import torch
    from polar_torch import from_numpy_state, generate_5g_ranking
    from polar_torch.config import PolarConfig
    from polar_torch.main import gen_code, sweep
    from polar_torch.models.osd import OSDecoder
    from polar_torch.models.polar.dense import DenseKernelEncoder
    from polar_torch.models.polar.encode import PolarEncoder
    from polar_torch.sim import sim_ber
    from polar_torch.utils.profiling import cuda_ms

    kern_cfg = PolarConfig(bs=KERN_BS, mc_iter=KERN_MC_ITER,
                           target_block_errs=None, seed=SEED,
                           device=str(dev), **KERN_CODE)
    log(f"phase 10: CLI sweep {kern_cfg}")
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "kern.jsonl")
        reset_counts()
        torch.cuda.synchronize()
        sweep(kern_cfg, ebno_dbs=KERN_EBNO_DB, jsonl_path=jsonl)
        torch.cuda.synchronize()
        kern_counts = counts()
        with open(jsonl) as fh:
            rows = [json.loads(line) for line in fh]
    if [row["ebno_db"] for row in rows] != list(KERN_EBNO_DB) or any(
            row["num_blocks"] != KERN_BS * KERN_MC_ITER for row in rows):
        raise AssertionError(f"the --kern sweep gave {rows}")
    kern_k = KERN_CODE["k"]
    for row in rows:
        log(f"phase 10: G16 OSD-2 at {row['ebno_db']} dB: "
            f"{row['runtime_s']:.3f} s, "
            f"{kern_k * row['num_blocks'] / row['runtime_s']:.4g} info "
            f"bit/s; launches {kern_counts} (OSD runs in torch ops) "
            f"[{card}]")
        binomial_gate(f"phase 10: G16 OSD-2 at {row['ebno_db']} dB",
                      row["block_errors"], row["num_blocks"],
                      f"g16_osd2_{row['ebno_db']}")
    kern_model, _ = gen_code(kern_cfg, "G16 OSD-2", mode="osd")
    kern_dec = kern_model.decoder
    llr = kern_model.front(gen, KERN_BS, KERN_EBNO_DB[0])[2]
    enc_cpu = DenseKernelEncoder(kern_model.encoder.frozen_pos,
                                 KERN_CODE["n"], kern_model.encoder.kern,
                                 device="cpu")
    osd_card_against_cpu(f"G16 OSD-2, bs={KERN_BS}, {KERN_EBNO_DB[0]} dB",
                         kern_dec._osd, OSDecoder(t=KERN_CODE["osd_t"],
                                                  encoder=enc_cpu),
                         llr, kern_model.encoder.parity_check)
    total, front, sweep_ms = osd_split_ms(kern_dec._osd, llr, reps=2)
    dec_ms = cuda_ms(lambda: kern_dec(llr), reps=2)
    log(f"phase 10: G16 OSD-2 decoder {dec_ms:.3f} ms per batch of "
        f"{KERN_BS} ({kern_k * KERN_BS / dec_ms * 1e3:.4g} info bit/s); "
        f"OSD {total:.3f} ms: sort and elimination {front:.3f} ms, pattern "
        f"sweep {sweep_ms:.3f} ms [{card}]")

    frozen_o, _ = generate_5g_ranking(OSD2_K, OSD2_N)
    osd2_model = from_numpy_state(dict(
        frozen_pos=frozen_o, n=OSD2_N, k=OSD2_K, decoder="osd", osd_t=2,
        pattern_chunk=OSD2_CHUNK, cw_estimates=True), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "osd2.jsonl")
        sim_ber(osd2_model, [OSD2_EBNO_DB], batch_size=OSD2_BS,
                max_mc_iter=OSD2_BATCHES, early_stop=False, verbose=False,
                seed=SEED, jsonl_path=jsonl)
        with open(jsonl) as fh:
            (row,) = [json.loads(line) for line in fh]
    log(f"phase 10: OSD-2 5G ({OSD2_K}, {OSD2_N}), chunk {OSD2_CHUNK}, "
        f"codeword estimates, {OSD2_EBNO_DB} dB: {row['runtime_s']:.3f} s, "
        f"{OSD2_K * row['num_blocks'] / row['runtime_s']:.4g} info bit/s "
        f"[{card}]")
    binomial_gate("phase 10: OSD-2 (64, 128)", row["block_errors"],
                  row["num_blocks"], "osd2_k64_n128")
    osd2 = osd2_model.decoder
    llr = osd2_model.front(gen, OSD2_BS, OSD2_EBNO_DB)[2]
    enc_o = PolarEncoder(frozen_o, OSD2_N, device="cpu")
    osd_card_against_cpu(f"OSD-2 ({OSD2_K}, {OSD2_N}), bs={OSD2_BS}", osd2,
                         OSDecoder(t=2, encoder=enc_o,
                                   pattern_chunk=OSD2_CHUNK), llr,
                         osd2_model.encoder.parity_check)
    total, front, sweep_ms = osd_split_ms(osd2, llr, reps=3)
    log(f"phase 10: OSD-2 ({OSD2_K}, {OSD2_N}) {total:.3f} ms per batch of "
        f"{OSD2_BS} ({OSD2_K * OSD2_BS / total * 1e3:.4g} info bit/s): sort "
        f"and elimination {front:.3f} ms, pattern sweep {sweep_ms:.3f} ms "
        f"[{card}]")


def pc_kernel_checks(dev, gen):
    """Phase 3's PC schedules: the plain SCL sweep (``'p'`` leaves, the
    whole tree in one call) at ``PC_CHECK_LISTS`` and the SC sweep of the
    ``PC_CHECK_CODES`` mother codes, kernel against plain version, min-sum
    and exact, on random LLRs and on the noiseless +-10 logits of encoded
    payloads (rate-recovered), BATCH blocks each. Min-sum must agree on
    every block with bit-equal path metrics; exact mode as the other
    checks. Returns the (SCL, SC) checks."""
    import numpy as np
    import torch
    from polar_torch.models.polar import scan_core
    from polar_torch.models.polar.cuda_sc import sc_subtree, sc_subtree_plain
    from polar_torch.models.polar.cuda_scl import (scl_subtree,
                                                   scl_subtree_plain)
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    from polar_torch.ops.source import binary_source

    def plain_scl(a, pm, sched, **kw):
        return scl_subtree_plain(a, pm, sched.ops, **kw)

    def plain_sc(a, frz, sched, **kw):
        return sc_subtree_plain(a, frz, sched.ops, **kw)

    scl_check, sc_check = Check(), ScCheck()
    for k, e in PC_CHECK_CODES:
        enc = Polar5GEncoder(k, e, device=dev)
        n = enc.n_polar
        S = n.bit_length() - 1
        mask = np.zeros(n, bool)
        mask[enc.frozen_pos] = True
        pc = np.zeros(n, bool)
        pc[enc.pc_pos] = True
        logits = 10.0 * (2.0 * enc(binary_source(gen, (BATCH, k))) - 1.0)
        rate_recover = Polar5GDecoder(enc, dec_type="SC").rate_recover
        inputs = {"random LLRs": 3.0 * torch.randn((n, BATCH), generator=gen,
                                                   device=dev),
                  "noiseless logits": (-rate_recover(logits)).t().contiguous()}
        scl_plan = scan_core.plan_plain_sweep(mask, S, dev, pc_mask=pc)
        sc_plan = scan_core.plan_sc_sweep(mask, S, dev, pc_mask=pc)
        n_p = sum(kind == "p" for kind, _, _ in scl_plan[0][2].ops)
        for label, llr in inputs.items():
            for mode in ("minsum", "exact"):
                for L in PC_CHECK_LISTS:
                    kw = dict(mode=mode, llr_max=30.0, lower_stages=S,
                              plan=scl_plan)
                    u_k, pm_k = scan_core.scl_sweep_hybrid(
                        llr, mask, L, subtree=scl_subtree, **kw)
                    u_p, pm_p = scan_core.scl_sweep_hybrid(
                        llr, mask, L, subtree=plain_scl, **kw)
                    name = (f"PC ({k}, {e}), n={n}, {n_p} 'p' leaves, "
                            f"{label}, L={L}, b={S}, bs={BATCH}, {mode}")
                    n_bad = scl_check.add(name,
                                          (u_p, torch.zeros_like(pm_p), pm_p),
                                          (u_k, torch.zeros_like(pm_k), pm_k))
                    if mode == "minsum" and (n_bad or not torch.equal(pm_k,
                                                                      pm_p)):
                        raise AssertionError(f"{name}: min-sum must agree on "
                                             "every block, path metrics bit "
                                             "for bit")
                kw = dict(mode=mode, llr_max=30.0, lower_stages=S,
                          plan=sc_plan)
                u_k = scan_core.sc_sweep_hybrid(llr, mask, subtree=sc_subtree,
                                                **kw)
                u_p = scan_core.sc_sweep_hybrid(llr, mask, subtree=plain_sc,
                                                **kw)
                sc_check.add(f"PC ({k}, {e}), n={n}, {label}, b={S}, "
                             f"bs={BATCH}", mode, u_p, u_k)
    torch.cuda.synchronize()
    log(f"phase 3: PC schedules: scl_subtree {scl_check.n_bad} of "
        f"{scl_check.n_blocks} blocks differ (pm max abs "
        f"{scl_check.max_abs:.3g}); sc_subtree min-sum "
        f"{sc_check.bad['minsum']} of {sc_check.blocks['minsum']}, exact "
        f"{sc_check.bad['exact']} of {sc_check.blocks['exact']}")
    return scl_check, sc_check


def uci_phase(dev, gen, card, reset_counts, counts, kernel_times):
    """Phase 12: the 5G uplink UCI chain with PC bits through ``sim_ber``
    (``UCI_DECODERS`` on (19, 864), CA-SCL-8 on (12, 48)), the launch
    counts reset just before each run and read just after, each BLER
    against its yardstick; info bit/s, decoder ms per batch, and the
    kernels' ms per decode (``kernel_times(calls, label)``) beside their
    bound. Returns (the summed launch counts, the kernels' times per
    (19, 864) decode, the CA-SCL-8 model)."""
    import numpy as np
    import torch
    from polar_torch.models.polar import scan_core
    from polar_torch.models.polar.cuda_sc import sc_subtree
    from polar_torch.models.polar.cuda_scl import scl_subtree
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    from polar_torch.models.systems import SystemAWGNModel
    from polar_torch.sim import sim_ber
    from polar_torch.utils.profiling import cuda_ms

    totals = {"scl_subtree": 0, "sc_subtree": 0}
    times, scl_model = {}, None
    runs = [(UCI_K, UCI_E, UCI_EBNO_DB) + d for d in UCI_DECODERS]
    runs.append((UCI_SMALL_K, UCI_SMALL_E, UCI_SMALL_EBNO_DB, "CA-SCL-8",
                 "SCL", f"pc_scl8_k{UCI_SMALL_K}_e{UCI_SMALL_E}"))
    for k, e, ebno, name, dec_type, key in runs:
        enc = Polar5GEncoder(k, e, device=dev)
        if enc.pc_pos is None or len(enc.pc_pos) != 3:
            raise AssertionError(f"({k}, {e}) has no 3 PC bits")
        dec = Polar5GDecoder(enc, dec_type=dec_type, list_size=8,
                             mode=UCI_MODE)
        model = SystemAWGNModel(e, k, enc, dec)
        bits, bits_hat = model.step(gen, BATCH, ebno)          # warm-up
        if bits_hat.shape != (BATCH, k) or not torch.isin(
                bits_hat, torch.tensor([0.0, 1.0], device=dev)).all():
            raise AssertionError(f"{name}: output of shape "
                                 f"{bits_hat.shape} is not [batch, k] bits")
        with tempfile.TemporaryDirectory() as tmp:
            jsonl = os.path.join(tmp, "uci.jsonl")
            reset_counts()
            torch.cuda.synchronize()
            sim_ber(model, [ebno], batch_size=BATCH, max_mc_iter=UCI_BATCHES,
                    early_stop=False, verbose=False, seed=SEED,
                    jsonl_path=jsonl)
            torch.cuda.synchronize()
            run = counts()
            with open(jsonl) as fh:
                (row,) = [json.loads(line) for line in fh]
        need = [kern for kern, used in (
            ("scl_subtree", dec_type != "SC"),
            ("sc_subtree", dec_type != "SCL")) if used and run[kern] == 0]
        if need or row["num_blocks"] != BATCH * UCI_BATCHES:
            raise AssertionError(f"{name} ({k}, {e}): {row['num_blocks']} "
                                 f"blocks, launches {run}; none of {need}")
        for kern in totals:
            totals[kern] += run[kern]
        llr = model.front(gen, BATCH, ebno)[2]
        dec_ms = cuda_ms(lambda: dec(llr), reps=3)
        # the kernels' calls of one decode of this batch, timed alone
        inner = dec._polar_dec
        scl_dec = getattr(inner, "_scl", inner if dec_type == "SCL" else None)
        sc_dec = getattr(inner, "_sc", inner if dec_type == "SC" else None)
        llr_ch = (-dec.rate_recover(llr)).t().contiguous()
        for kern, sub in (("scl_subtree", scl_dec), ("sc_subtree", sc_dec)):
            if sub is None:
                continue
            label = f"one {name} decode of ({k}, {e})" + (
                ", its CA-SCL pass on every row"
                if dec_type == "hybSCL" and kern == "scl_subtree" else "")
            calls = []
            rec = recorder(calls, scl_subtree if kern == "scl_subtree"
                           else sc_subtree)
            if kern == "scl_subtree":
                scan_core.scl_sweep_hybrid(
                    llr_ch, sub._frozen_mask, sub.list_size, mode=UCI_MODE,
                    llr_max=30.0, lower_stages=sub.lower_stages,
                    plan=sub._plan, subtree=rec)
            else:
                scan_core.sc_sweep_hybrid(
                    llr_ch, sub._frozen_mask, mode=UCI_MODE, llr_max=30.0,
                    lower_stages=sub.lower_stages, plan=sub._plan,
                    subtree=rec)
            t = kernel_times(kern, calls, label)
            if (k, e) == (UCI_K, UCI_E) and kern not in times:
                times[kern] = t
        log(f"phase 12: {name} {dec_type} L=8 {UCI_MODE}, 5G uplink ({k}, "
            f"{e}), n_polar {enc.n_polar}, PC at {enc.pc_pos.tolist()}, "
            f"bs={BATCH}, b={inner.lower_stages}: {row['runtime_s']:.3f} s, "
            f"{k * row['num_blocks'] / row['runtime_s']:.4g} info bit/s; "
            f"decoder {dec_ms:.3f} ms per batch; launches {run} [{card}]")
        binomial_gate(f"phase 12: {name} ({k}, {e}) at {ebno} dB",
                      row["block_errors"], row["num_blocks"], key)
        if (k, e) == (UCI_K, UCI_E) and dec_type != "hybSCL":
            log(f"phase 12: {name} ({k}, {e}), where one step's time goes:")
            profile_step(model, gen, ebno_db=ebno)
        if (k, e, dec_type) == (UCI_K, UCI_E, "SCL"):
            scl_model = model
    return totals, times, scl_model


def tools_phase(dev, card, model, reset_counts, counts):
    """Phase 13: the tools on the card over ``model`` (the UCI chain's
    CA-SCL-8): ``ShardedSystem`` with a world of one on NCCL through
    ``sim_ber``, its counters equal to the unsharded model's run on the
    same derived generators; ``trace`` of one step, whose file names the
    SCL kernel; ``flop_estimate`` of one step beside the kernel's own
    work count."""
    import socket
    import torch
    import torch.distributed as dist
    from polar_torch.parallel import ShardedSystem, initialize
    from polar_torch.sim import (count_block_errors, count_errors, fold_in,
                                 iteration_generator, sim_ber)
    from polar_torch.utils.kernel_work import subtree_work
    from polar_torch.utils.profiling import flop_estimate, trace

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    rank, world, n_dev = initialize(f"tcp://localhost:{port}", world_size=1,
                                    rank=0, device=dev, timeout_s=120)
    try:
        sharded = ShardedSystem(model)
        with tempfile.TemporaryDirectory() as tmp:
            jsonl = os.path.join(tmp, "sharded.jsonl")
            reset_counts()
            torch.cuda.synchronize()
            sim_ber(sharded, [UCI_EBNO_DB], batch_size=BATCH,
                    max_mc_iter=SHARDED_BATCHES, early_stop=False,
                    verbose=False, seed=SEED, jsonl_path=jsonl)
            torch.cuda.synchronize()
            run = counts()
            with open(jsonl) as fh:
                (row,) = [json.loads(line) for line in fh]
        bit_e = blk_e = 0
        for it in range(SHARDED_BATCHES):
            gen = iteration_generator(SEED, 0, it, dev)
            b, b_hat = model.step(fold_in(gen, 0), BATCH, UCI_EBNO_DB)
            bit_e += count_errors(b, b_hat).item()
            blk_e += count_block_errors(b, b_hat).item()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    log(f"phase 13: ShardedSystem, {backend} world of {world} (rank {rank}, "
        f"{n_dev} device), CA-SCL-8 ({UCI_K}, {UCI_E}), {SHARDED_BATCHES} "
        f"batches of {BATCH}: {row['bit_errors']} bit and "
        f"{row['block_errors']} block errors in {row['num_blocks']} blocks; "
        f"unsharded on the same derived generators: {bit_e}, {blk_e}; "
        f"launches {run}")
    if (row["bit_errors"], row["block_errors"]) != (bit_e, blk_e) or \
            row["num_blocks"] != BATCH * SHARDED_BATCHES or \
            run["scl_subtree"] == 0:
        raise AssertionError("the sharded counters differ from the "
                             "unsharded run's")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            model.step(gen, BATCH, UCI_EBNO_DB)
        files = [f for f in os.listdir(tmp) if f.endswith(".json")]
        text = "".join(open(os.path.join(tmp, f)).read() for f in files)
    named = "scl_subtree_kernel" in text
    log(f"phase 13: trace of one step: {files} ({len(text)} bytes), names "
        f"scl_subtree_kernel: {named}")
    if len(files) != 1 or not named:
        raise AssertionError("the trace file is missing or does not name "
                             "the SCL kernel")

    inner = model.decoder._polar_dec
    llr = model.front(gen, BATCH, UCI_EBNO_DB)[2]
    flops = flop_estimate(lambda x: model.decoder(x), llr)
    step_flops = flop_estimate(lambda: model.step(gen, BATCH, UCI_EBNO_DB))
    _, kernel_ops = subtree_work(inner._plan[0][2].ops, inner.lower_stages,
                                 UCI_MODE, llr.new_empty(
                                     (inner.n, 8, BATCH)))
    log(f"phase 13: flop_estimate: one CA-SCL-8 ({UCI_K}, {UCI_E}) decode of "
        f"{BATCH} {flops:.6g} operations, one step {step_flops:.6g}; the "
        f"scl_subtree call's own work count (phase 7's rule) {kernel_ops} "
        f"f32 ops")
    if not flops >= kernel_ops > 0:
        raise AssertionError("flop_estimate missed the kernel's work")


def entry_points_phase(card, info_bps):
    """Phase 14: ``python -m polar_torch.bench`` at its defaults, alone on
    the card, then the four ``examples/torch_0*.py`` side by side, each in
    its own process: every one exits 0; the bench prints one JSON line with
    every key, the card's name and limit, info bit/s > 0 and SCL kernel
    launches; each example prints its result lines and launches the
    kernels on its path. Returns the bench's JSON object."""
    import re
    import signal
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "polar_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=ENTRY_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"polar_torch.bench exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    row = json.loads(lines[0]) if len(lines) == 1 else {}
    name, power = (x.strip() for x in card.rsplit(",", 1))
    if (set(row) != BENCH_KEYS or row["device"] != name
            or row["power_limit"] != power or not row["value"] > 0
            or not row["scl_subtree_launches"] > 0):
        raise AssertionError(f"polar_torch.bench printed {out.stdout!r}")
    log(f"phase 14: python -m polar_torch.bench ({time.perf_counter() - t0:.1f}"
        f" s): {lines[0]}")
    for line in out.stderr.strip().splitlines():
        log(f"  {line}")
    log(f"phase 14: the bench {row['value']:.6g} info bit/s "
        f"({row['ms_per_step']:.3f} ms per step, {row['iters']} steps), "
        f"phase 4 {info_bps:.6g} ({BATCH * K / info_bps * 1e3:.3f} ms): "
        f"ratio {row['value'] / info_bps:.4f} [{card}]")

    # each walkthrough leads a process group of its own, so that its
    # workers (torch_03's ranks) go with it
    t0 = time.perf_counter()
    procs = [(script, want, pattern, subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True))
        for script, args, want, pattern in EXAMPLE_RUNS]
    try:
        for script, want, patterns, proc in procs:
            stdout, stderr = proc.communicate(timeout=ENTRY_TIMEOUT_S)
            if proc.returncode != 0:
                raise AssertionError(f"{script} exited {proc.returncode}: "
                                     f"{stderr[-3000:]}")
            got = re.search(r"^kernel launches[^:]*: (\{.*\})$", stdout,
                            re.M)
            launched = json.loads(got[1]) if got else {}
            missing = [p for p in patterns if not re.search(p, stdout, re.M)]
            if missing or not all(launched.get(k, 0) > 0 for k in want):
                raise AssertionError(f"{script}: result lines {missing} "
                                     f"missing or launches {launched}; "
                                     f"stdout {stdout[-2000:]!r}")
            results = [ln for ln in stdout.splitlines()
                       if any(re.search(p, ln) for p in patterns)]
            log(f"phase 14: {script}: " + "; ".join(results)
                + f"; launches {launched}")
    finally:
        for *_, proc in procs:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    log(f"phase 14: the four walkthroughs side by side in "
        f"{time.perf_counter() - t0:.1f} s")
    return row


# the PyTorch call that computes a probe's function in one call, and the
# profiler name of its kernel
PROBE_LIBRARY = {"gather": ("torch.gather", "gather"),
                 "reduce": ("torch.amin", "reduce_kernel")}


def probe_library(name, args):
    """The library call of probe ``name`` on ``args``: ``torch.gather``
    with the pointers already int64, ``torch.amin(dim=0, keepdim=True)``
    (it writes [1, cols]; the broadcast is a view); None for the other
    probes."""
    import torch
    if name == "gather":
        ptr = args[1].long()
        return lambda: torch.gather(args[0], 0, ptr)
    if name == "reduce":
        return lambda: torch.amin(args[0], dim=0, keepdim=True)
    return None


def sass_functions(lib, match):
    """{kernel: its SASS lines} of the kernels in library ``lib`` whose
    mangled name holds ``match`` (``cuobjdump -sass``)."""
    from polar_torch import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            name = name if match in name else None
            if name:
                funcs[name] = []
        elif name:
            funcs[name].append(line)
    return funcs


def sass_counts(lib, match, opcodes):
    """{kernel: {opcode: count}} of the kernels in library ``lib`` whose
    mangled name holds ``match``, counting the SASS instructions whose
    opcode starts with each of ``opcodes``."""
    counts = {}
    for name, lines in sass_functions(lib, match).items():
        counts[name] = dict.fromkeys(opcodes, 0)
        for line in lines:
            if not (line.strip().startswith("/*") and "*/" in line):
                continue
            words = line.split("*/", 1)[1].replace("{", " ").split()
            words = [w for w in words if not w.startswith("@")]
            for op in opcodes:
                if words and words[0].startswith(op):
                    counts[name][op] += 1
    return counts


def sass_backward_branches(lib, match):
    """{kernel: branches to an earlier address} of the kernels in library
    ``lib`` whose mangled name holds ``match``: its loops; the branch to
    itself that ends a kernel's code is not one."""
    counts = {}
    for name, lines in sass_functions(lib, match).items():
        counts[name] = 0
        for line in lines:
            m = re.search(r"/\*([0-9a-f]+)\*/.*\bBRA\b.*?0x([0-9a-f]+)",
                          line)
            if m and int(m.group(2), 16) < int(m.group(1), 16):
                counts[name] += 1
    return counts


def int8_inputs(dev):
    """``int8``'s other inputs on card ``dev``: each of ``INT8_SHAPES``
    from a seed, with every int8 value, as it is and as a view one byte
    past a 16-byte boundary."""
    import numpy as np
    import torch
    out = []
    for rows, cols in INT8_SHAPES:
        x = torch.from_numpy(np.random.default_rng(cols).integers(
            -128, 128, (rows, cols)).astype(np.int8))
        x.view(-1)[:256] = torch.arange(-128, 128, dtype=torch.int8)[
            :x.numel()]
        x = x.to(dev)
        flat = x.new_empty(x.numel() + 1)
        flat[1:] = x.flatten()
        out += [x, flat[1:].view(x.shape)]
    return out


def in_turns(kernel, library, reps, rounds=PROBE_TURN_ROUNDS):
    """(kernel ms, library ms) a launch, each the median of ``rounds``
    CUDA-event means of ``reps`` back-to-back launches, timed in turns:
    kernel, library, library, kernel, ..."""
    from polar_torch.utils.profiling import cuda_ms
    times = {kernel: [], library: []}
    order = [kernel, library, library, kernel]
    for i in range(2 * rounds):
        fn = order[i % 4]
        times[fn].append(cuda_ms(fn, reps))
    return (statistics.median(times[kernel]),
            statistics.median(times[library]))


def probes_phase(dev, card):
    """Phase 15: the probe kernels of ``polar_torch.probes``. Their path,
    every step of the entry point (``run_step``), with the probes' launch
    counts reset just before and read just after: each kernel launched,
    0 elements differing from its plain version at the script's draw, its
    ms per launch. Then each kernel against its plain version at another
    draw (0 differing elements), its time alone under ``torch.profiler``,
    the plain version's and the library call's where one exists, and the
    bound. For ``gather`` and ``reduce``, which have a library call: the
    library kernel's own device time, and kernel against library in
    turns (``in_turns``), printed side by side with their ratio (not
    gated). Last ``python -m polar_torch.probes`` in its own process,
    which must exit 0 and print one line a step. Returns the probes'
    ``kernels`` entries."""
    import torch
    from polar_torch import probes
    from polar_torch.utils.kernel_work import bound_ms, probe_work
    from polar_torch.utils.profiling import cuda_ms
    t0 = t_phase = time.perf_counter()
    probes.reset_launch_counts()
    rows = [probes.run_step(step) for step in probes.STEPS]
    launches = probes.launch_counts()
    on_path = {name: r for row in rows
               for name, r in probes.results(row).items()}
    if any(r["mismatches"] for r in on_path.values()):
        raise AssertionError(f"phase 15: a probe differs: {rows}")
    if not all(launches.values()):
        raise AssertionError(f"phase 15: a probe did not launch: {launches}")
    log(f"phase 15: every step of polar_torch.probes "
        f"({time.perf_counter() - t0:.1f} s), launches {launches}")

    entries = []
    for name in probes.PROBES:
        step = "bf16" if name in probes.BF16 else f"mini:{name}"
        wrapper, plain = probes.WRAPPERS[name], probes.PLAIN[name]
        args = tuple(a.to(dev) for a in probes.step_inputs(
            step, PROBE_OTHER_SEED)[name])
        got, want = wrapper(*args), plain(*args)
        torch.cuda.synchronize()
        n_bad = probes.differing(want, got)
        if n_bad:
            raise AssertionError(f"phase 15: {name} differs from its plain "
                                 f"version on {n_bad} elements (seed "
                                 f"{PROBE_OTHER_SEED})")
        n_bad += on_path[name]["mismatches"]
        checked = 2 * got.numel()               # both draws' shapes agree
        if name in PROBE_SWEEPS:
            # NaNs, signed zeros and infinities at the script's width and
            # a wider one, and every ordered pair of NaNs, +-1 and +-0
            for x in (probes.bits_input(PROBE_OTHER_SEED),
                      probes.bits_input(PROBE_OTHER_SEED, PROBE_WIDE_COLS),
                      probes.pair_input(PROBE_OTHER_SEED),
                      probes.mini_input(PROBE_OTHER_SEED).repeat(1, 2)[
                          :, :PROBE_WIDE_COLS].contiguous()):
                x = x.to(dev)
                got_x = wrapper(x)
                torch.cuda.synchronize()
                n_x = probes.differing(plain(x), got_x)
                if n_x:
                    raise AssertionError(
                        f"phase 15: {name} differs from its plain version "
                        f"on {n_x} elements of a NaN, zero or wide input "
                        f"{list(x.shape)}")
                checked += got_x.numel()
        if name == "int8":
            for x in int8_inputs(dev):
                got_x = wrapper(x)
                torch.cuda.synchronize()
                n_x = probes.differing(plain(x), got_x)
                if n_x:
                    raise AssertionError(
                        f"phase 15: int8 differs from its plain version on "
                        f"{n_x} elements of {list(x.shape)} (offset "
                        f"{x.data_ptr() % 16} from 16 bytes)")
                checked += got_x.numel()
        max_abs = max(on_path[name]["max_abs_err"],
                      (want.double() - got.double()).abs().max().item())
        args = tuple(a.to(dev) for a in probes.step_inputs(step)[name])
        k_ms = on_path[name]["ms"]
        dev_ms = kernel_device_ms(lambda: wrapper(*args), PROBE_FEW_REPS,
                                  "probe_")
        p_ms = cuda_ms(lambda: plain(*args), PROBE_FEW_REPS)
        lib = probe_library(name, args)
        lib_ms = cuda_ms(lib, probes.REPS) if lib else None
        bnd, by = bound_ms(*probe_work(name, *args))
        entry = dict(
            name=f"probe {name}", route="cuda",
            source="polar_torch/csrc/probes.cu",
            replaces=f"benchmarks/probe_r4.py:{probes.REPLACES[name]}",
            launches=launches[name], max_abs_err=max_abs,
            mismatch_elements=n_bad, checked_elements=checked, ms=k_ms,
            plain_ms=p_ms, bound_ms=bnd, bound_by=by, library_ms=lib_ms,
            device_ms=dev_ms)
        log(f"phase 15: {name}: {k_ms:.4f} ms a launch, the kernel alone "
            f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'} "
            f"(plain {p_ms:.4f}, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f}'}), bound "
            f"{bnd:.6f} ms ({by}); {checked} elements, {n_bad} differ "
            f"[{card}]")
        if lib:
            lib_name, lib_kernel = PROBE_LIBRARY[name]
            lib_dev = kernel_device_ms(lib, PROBE_FEW_REPS, lib_kernel)
            k_turn, l_turn = in_turns(lambda: wrapper(*args), lib,
                                      probes.REPS)
            if dev_ms is None or lib_dev is None:
                raise AssertionError(f"phase 15: the profiler saw no kernel "
                                     f"of {name} ({dev_ms}) or {lib_name} "
                                     f"({lib_dev})")
            entry.update(library_device_ms=lib_dev, turns_ms=k_turn,
                         library_turns_ms=l_turn)
            log(f"phase 15: {name} against {lib_name}: alone {dev_ms:.4f} "
                f"vs {lib_dev:.4f} ms ({dev_ms / lib_dev:.3f}x); a launch "
                f"in turns (medians of {PROBE_TURN_ROUNDS} x {probes.REPS} "
                f"launches) {k_turn:.4f} vs {l_turn:.4f} ms "
                f"({k_turn / l_turn:.3f}x) [{card}]")
        entries.append(entry)

    # k_big's whole sweep is in its code: every cross-lane stage of every
    # sweep shuffles a lane's 8 rows (the quarters are warps of their own,
    # folded into the output)
    from polar_torch import _build
    (lib,) = _build.build([("probes", "cuda")])
    sass = sass_counts(lib, "probe_big_kernel",
                       ("SHFL", "FMNMX", "FSETP", "SEL", "LOP3", "ISETP", "BAR"))
    sweeps = {"ILi4E": 4, "ILi1E": 1}
    for fn, ops in sass.items():
        want = [BIG_SHFL_A_SWEEP * n for key, n in sweeps.items()
                if key in fn]
        if want != [ops["SHFL"]]:
            raise AssertionError(f"phase 15: {fn} has {ops['SHFL']} "
                                 f"shuffles, not {want}")
        log(f"phase 15: SASS of {fn}: {ops}")
    if len(sass) != 2:
        raise AssertionError(f"phase 15: k_big's two instances not found "
                             f"in the SASS: {sorted(sass)}")
    # int8's vector form: its 16-byte loads and stores, no loop
    i8 = {fn: ops for fn, ops in sass_counts(
        lib, "probe_int8_kernel", ("LDG.E.128", "STG.E.128", "LDG",
                                   "STG")).items() if "ILb1E" in fn}
    loops = sass_backward_branches(lib, "probe_int8_kernel")
    for fn, ops in i8.items():
        if ops["LDG.E.128"] < INT8_VEC_LOADS or ops["STG.E.128"] < 1 \
                or loops[fn]:
            raise AssertionError(f"phase 15: {fn} has {ops} and "
                                 f"{loops[fn]} backward branches, not "
                                 f"{INT8_VEC_LOADS} 16-byte loads or more "
                                 f"and no loop")
        log(f"phase 15: SASS of {fn}: {ops}, {loops[fn]} backward branches")
    if len(i8) != 1:
        raise AssertionError(f"phase 15: int8's vector instance not found "
                             f"in the SASS: {sorted(i8)}")

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "polar_torch.probes"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=ENTRY_TIMEOUT_S)
    lines = out.stdout.strip().splitlines()
    steps = [json.loads(line).get("step") for line in lines]
    if out.returncode != 0 or steps != list(probes.STEPS):
        raise AssertionError(f"polar_torch.probes exited {out.returncode}, "
                             f"steps {steps}: {out.stderr[-3000:]}")
    log(f"phase 15: python -m polar_torch.probes "
        f"({time.perf_counter() - t0:.1f} s): {len(lines)} lines, exit 0; "
        f"the phase {time.perf_counter() - t_phase:.1f} s")
    return entries


# phase 16: the closing transform's shapes on the main paths, (m, w, C,
# dtype): the fast SCL-8 chain (bs 8192), the uplink UCI chain at bs 65536
# (both the subtree kernel's int32 codeword), the plain sweep at b=8 (four
# stacked int8 subtrees); the first two are timed
BUTTERFLY_SHAPES = (("scl8", (1, 1024, 8 * 8192), "int32"),
                    ("wide", (1, 256, 8 * 65536), "int32"),
                    ("plain_b8", (4, 256, 8 * 2048), "int8"))
BUTTERFLY_REPS = 50

# phase 17: the QPSK transmitter's timed batches on the k=512 n=1024 code
# (the card-paced cells' bp20 and SC, and scl8's), its launches timed a
# shape, and the widths checked against the plain version on a batch no
# tile divides
QPSK_FRONT_SHAPES = (("wide", 65536), ("scl8", 8192))
QPSK_FRONT_REPS = 50
QPSK_FRONT_CHECK_BS = 1031


SCL_TURN_ROUNDS = 3      # P C C P rounds of the kernel-alone timing
SCL_TURN_REPS = 5        # decodes per profiled reading


def ptxas_report(src, pattern, name_of):
    """``nvcc -Xptxas -v`` on the kernel source ``src`` (built into a
    temporary file with the package's flags): the registers, stack frame
    and spill bytes of each kernel whose mangled name ``pattern`` matches,
    by ``name_of(match)``."""
    from polar_torch import _build
    with tempfile.TemporaryDirectory() as tmp:
        run = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "lib.so"), src],
            capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v {src} failed:\n{run.stderr}")
    info, name = {}, None
    for line in (run.stdout + run.stderr).splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?"
                      + pattern, line)
        if m:
            name = name_of(m)
            info.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            info[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                              spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[name]["registers"] = int(m[1])
    return info


def scl_ptxas_report(src):
    """``ptxas_report`` of the SCL subtree source ``src``, by
    ``<kernel><L[, pc]>``."""
    return ptxas_report(
        src, r"(_Z\w*(scl_subtree_kernel|scl_cw_kernel)ILi(\d+)E"
             r"(Lb(\d)E)?\w*)",
        lambda m: f"{m[2]}<{m[3]}{', pc' if m[5] == '1' else ''}>")


def scl_sass_counts(lib):
    """SASS instructions of each decode kernel in the built library
    ``lib`` (``cuobjdump -sass``), by ``scl_subtree_kernel<L[, pc]>``."""
    from polar_torch import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    run = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, timeout=300, check=True)
    counts, name = {}, None
    for line in run.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"scl_subtree_kernelILi(\d+)ELb(\d)E", m[1])
            pc = ", pc" if k and k[2] == "1" else ""
            name = f"scl_subtree_kernel<{k[1]}{pc}>" if k else None
            if name:
                counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return counts


def parent_scl_launch(parent):
    """The parent checkout's ``scl_subtree_launch``: its
    ``polar_torch/csrc/scl_subtree.cu`` built with the package's nvcc flags
    into ``build/polar_torch/``. The entry point's arguments are the
    same, so ``cuda_scl._native_call`` drives it as it does this one."""
    import ctypes
    from polar_torch import _build
    src = os.path.join(parent, "polar_torch", "csrc", "scl_subtree.cu")
    out = os.path.join(_build.BUILD_DIR, "libscl_subtree_parent.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, timeout=900)
    return ctypes.CDLL(out).scl_subtree_launch


def scl_turn_decodes(dev):
    """One decode of each SCL path the quads serve, as the recorded calls
    ``[(args, kwargs)]`` of ``scl_subtree``: scl8's fast decode (the
    benchmark's chain), the uplink (19, 864) CA-SCL-8 PC decode, CA-SCL-32
    of the 5G k=400 E=1000 code at b=10, the CLI's plain SCL-8 at b=10 and
    CA-SCL-8 on the traced form at b=6, each at its chain's batch and SNR."""
    import torch
    from polar_torch.bench import build_model
    from polar_torch.models.polar import scan_core
    from polar_torch.models.polar.cuda_scl import scl_subtree
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    from polar_torch.models.polar.scl import PolarSCLDecoder
    from polar_torch.models.systems import SystemAWGNModel
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def calls_of(sub, llr_ch):
        calls = []
        kw = dict(mode=sub.mode, llr_max=sub.llr_max,
                  lower_stages=sub.lower_stages, plan=sub._plan,
                  subtree=recorder(calls, scl_subtree))
        if sub.use_fast_scl:
            scan_core.scl_sweep_hybrid_fast(
                llr_ch, sub._frozen_mask, sub.list_size,
                rate1=sub.fast_rate1, spc_min_stage=sub.spc_min_stage, **kw)
        else:
            scan_core.scl_sweep_hybrid(llr_ch, sub._frozen_mask,
                                       sub.list_size, **kw)
        return calls

    model = build_model(K, N, LIST_SIZE, device=dev)
    llr = model.front(gen, BATCH, EBNO_MAIN_DB)[2]
    out = [("scl8 fast SCL-8 (b=10, min-sum)",
            calls_of(model.decoder, (-llr).t().contiguous()))]
    plain = PolarSCLDecoder(model.decoder.frozen_pos, N, list_size=LIST_SIZE,
                            mode=MODE, use_fast_scl=False, lower_stages=10,
                            device=dev)
    out.append(("plain SCL-8 of the CLI (b=10, min-sum)",
                calls_of(plain, (-llr).t().contiguous())))
    for k, e, ebno, L, b, bs, label in (
            (UCI_K, UCI_E, UCI_EBNO_DB, 8, None, BATCH,
             f"uplink ({UCI_K}, {UCI_E}) CA-SCL-8 PC"),
            (G5_K, G5_E, G5_EBNO_DB, 32, 10, WIDE_BATCH,
             f"5G ({G5_K}, {G5_E}) CA-SCL-32"),
            (G5_K, G5_E, G5_EBNO_DB, 8, TRACED_B, BATCH,
             f"5G ({G5_K}, {G5_E}) CA-SCL-8")):
        enc = Polar5GEncoder(k, e, device=dev)
        dec = Polar5GDecoder(enc, dec_type="SCL", list_size=L,
                             mode=UCI_MODE if k == UCI_K else G5_MODE,
                             lower_stages=b)
        llr5 = SystemAWGNModel(e, k, enc, None).front(gen, bs, ebno)[2]
        sub = dec._polar_dec
        calls = calls_of(sub, (-dec.rate_recover(llr5)).t().contiguous())
        form = "traced" if calls[0][0][2].traced else "static"
        out.append((f"{label} (b={sub.lower_stages}, {sub.mode}, bs={bs}, "
                    f"{form} form)", calls))
    return out


def scl_quads_phase(dev, card, parent):
    """Phase 7's SCL kernel lines: the decode kernel's registers, spills
    and resident blocks an SM (``-Xptxas -v`` and the occupancy API), and,
    with ``parent`` (a checkout of the parent commit), each decode of
    ``scl_turn_decodes`` on the parent's build and this one in turns (P C
    C P, ``SCL_TURN_ROUNDS`` rounds), bit for bit the same outputs, the
    kernel alone timed by the profiler. Returns {label: (parent ms, this
    ms)}."""
    import torch
    from polar_torch import _build
    from polar_torch.models.polar import cuda_scl
    lib = _build.load("scl_subtree", "cuda")
    info = scl_ptxas_report(os.path.join(ROOT, "polar_torch", "csrc",
                                         "scl_subtree.cu"))
    sass = scl_sass_counts(_build._library_path("scl_subtree", "cuda"))
    for name, v in info.items():
        log(f"phase 7: {name}: {v.get('registers')} registers, stack "
            f"{v.get('stack')} B, spill stores {v.get('spill_stores')} B, "
            f"spill loads {v.get('spill_loads')} B, "
            f"{sass.get(name, '-')} SASS instructions")
    for L in cuda_scl.LIST_SIZES:
        n = cuda_scl.shared_stages(10, L)
        per_sm = [lib.scl_subtree_blocks_per_sm(L, pc, n) for pc in (0, 1)]
        log(f"phase 7: scl_subtree_kernel<{L}> at b=10: {n} shared stages, "
            f"{cuda_scl.block_smem_bytes(L, n)} B a block, blocks an SM "
            f"{per_sm[0]} (PC build {per_sm[1]})")
    if parent is None:
        log("phase 7: no --parent checkout given: the kernel against the "
            "parent's in turns not measured")
        return {}
    launch = parent_scl_launch(parent)
    sass = scl_sass_counts(os.path.join(_build.BUILD_DIR,
                                        "libscl_subtree_parent.so"))
    for name, v in scl_ptxas_report(os.path.join(
            parent, "polar_torch", "csrc", "scl_subtree.cu")).items():
        log(f"phase 7: the parent's {name}: {v.get('registers')} "
            f"registers, spill stores {v.get('spill_stores')} B, "
            f"{sass.get(name, '-')} SASS instructions")

    def parent_call(a, pm, sched, *, b, llr_max, mode, frz=None,
                    n_shared=None):
        if n_shared is None:
            n_shared = cuda_scl.shared_stages(b, a.shape[1])
        stream = torch.cuda.current_stream(a.device).cuda_stream
        return cuda_scl._native_call(launch, a, pm, frz, sched, b, llr_max,
                                     mode, n_shared, stream)

    def leaf_rows(calls):
        """The calls with each schedule's table one row a leaf (no
        frozen-run rows), which every parent build takes"""
        return [((a, pm, cuda_scl.SubtreeSchedule(
            sched.ops, a.device, runs=False)), kw)
            for (a, pm, sched), kw in calls]

    times = {}
    for label, calls in scl_turn_decodes(dev):
        sides = (("parent", parent_call, leaf_rows(calls)),
                 ("this", cuda_scl.scl_subtree, calls))
        outs = {side: [fn(*args, **kw) for args, kw in cs]
                for side, fn, cs in sides}
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for p, c in zip(outs["parent"],
                                                    outs["this"])
                   for x, y in zip(p, c))
        if not same:
            raise AssertionError(f"phase 7: {label}: the kernel's outputs "
                                 "differ from the parent kernel's")
        ms = {"parent": [], "this": []}
        for _ in range(SCL_TURN_ROUNDS):
            for side, fn, cs in (*sides, *sides[::-1]):
                ms[side].append(len(cs) * kernel_device_ms(
                    lambda: [fn(*args, **kw) for args, kw in cs],
                    SCL_TURN_REPS, "scl_subtree_kernel"))
        p, c = statistics.median(ms["parent"]), statistics.median(ms["this"])
        times[label] = (p, c)
        log(f"phase 7: {label}, {len(calls)} calls: scl_subtree_kernel "
            f"alone, in turns P C C P: parent "
            f"{', '.join(f'{x:.4f}' for x in ms['parent'])} ms, this "
            f"{', '.join(f'{x:.4f}' for x in ms['this'])} ms; medians "
            f"{c / p:.3f}x the parent's; outputs bit-equal [{card}]")
    return times


def butterfly_phase(dev, card, main_launches):
    """Phase 16: ``butterfly_rows`` against its plain version on the card
    (the main paths' shapes, every width at ragged column counts, any bits
    above bit 0), one launch a decode on each of the three main chains
    with the same decisions as the plain transform, and its time at the
    main paths' shapes beside its bound, its plain version's and the
    parent's torch transform (the int8 cast, the stack and
    ``polar_transform`` on the [m, w, L, bs] codewords). Returns its
    ``kernels`` entry, whose ``launches`` is ``main_launches``, the main
    path's count from phase 4 (counts zeroed just before it), and whose
    ``chain_launches`` sums this phase's three decodes."""
    import numpy as np
    import torch
    from polar_torch import generate_5g_ranking
    from polar_torch.models.polar import scan_core
    from polar_torch.models.polar.cuda_butterfly import (
        butterfly_rows, butterfly_rows_plain)
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    from polar_torch.models.polar.scl import PolarSCLDecoder
    from polar_torch.ops.butterfly import polar_transform
    from polar_torch.utils import tracing
    from polar_torch.utils.kernel_work import bound_ms, butterfly_work
    from polar_torch.utils.profiling import cuda_ms
    gen = torch.Generator(dev).manual_seed(SEED)
    checked = bad = 0

    def check(x):
        nonlocal checked, bad
        want = butterfly_rows_plain(x)
        got = butterfly_rows(x)
        checked += x.numel()
        bad += int((got != want).sum().item())

    inputs = {}
    for name, shape, dtype in BUTTERFLY_SHAPES:
        x = inputs[name] = torch.randint(0, 2, shape, generator=gen,
                                         dtype=getattr(torch, dtype),
                                         device=dev)
        check(x)
    for b in range(1, 13):
        for C in (1, 33, 4100):
            for dtype in (torch.int32, torch.int8):
                check(torch.randint(-100, 100, (3, 1 << b, C),
                                    generator=gen, dtype=dtype, device=dev))
    torch.cuda.synchronize()
    log(f"phase 16: butterfly_rows against butterfly_rows_plain: {bad} of "
        f"{checked} elements differ")
    if bad:
        raise AssertionError(f"phase 16: butterfly_rows differs from its "
                             f"plain version in {bad} elements")

    # one decode of each main chain: one launch, the plain transform's
    # decisions
    frozen = generate_5g_ranking(K, N)[0]
    rng = np.random.default_rng(SEED)
    llr = torch.from_numpy(rng.normal(2.0, 2.0, (BATCH, N)).astype(
        np.float32)).to(dev)
    enc = Polar5GEncoder(19, 864, device=dev)
    uci = torch.from_numpy(rng.normal(2.0, 2.0, (BATCH, 864)).astype(
        np.float32)).to(dev)
    chains = (
        ("fast SCL-8", PolarSCLDecoder(frozen, N, list_size=8, mode=MODE,
                                       use_fast_scl=True, fast_rate1=True,
                                       device=dev), llr),
        ("CA-SCL-8 (19, 864) with PC", Polar5GDecoder(
            enc, dec_type="SCL", list_size=8, mode="exact"), uci),
        ("plain SCL-8 at b=8", PolarSCLDecoder(
            frozen, N, list_size=8, mode=MODE, use_fast_scl=False,
            lower_stages=8, device=dev), llr))
    chain_launches = 0
    for name, dec, x in chains:
        dec(x)
        torch.cuda.synchronize()
        before = tracing.counter("launch.butterfly_rows")
        got = dec(x)
        torch.cuda.synchronize()
        n_launch = tracing.counter("launch.butterfly_rows") - before
        chain_launches += n_launch
        scan_core.butterfly_rows = butterfly_rows_plain
        try:
            want = dec(x)
        finally:
            scan_core.butterfly_rows = butterfly_rows
        same = torch.equal(got, want)
        log(f"phase 16: {name}: {n_launch} butterfly_rows launch(es) a "
            f"decode; decisions equal to the plain transform's: {same}")
        if n_launch != 1 or not same:
            raise AssertionError(f"phase 16: {name}: {n_launch} launches, "
                                 f"same decisions: {same}")

    # times at the main paths' shapes (CUDA events over back-to-back
    # launches; the kernel alone from the profiler)
    times = {}
    for name, shape, dtype in BUTTERFLY_SHAPES:
        x = inputs[name]
        m, w, C = shape
        xv = x.view(m, w, 8, C // 8)
        ms = cuda_ms(lambda: butterfly_rows(x), BUTTERFLY_REPS)
        alone = kernel_device_ms(lambda: butterfly_rows(x), 20,
                                 "butterfly_rows_kernel")
        plain_ms = cuda_ms(lambda: butterfly_rows_plain(x), 3)
        parent_ms = cuda_ms(lambda: polar_transform(torch.stack(
            [c.to(torch.int8) for c in xv]), axis=1), 3)
        bound, kind = bound_ms(*butterfly_work(x))
        times[name] = dict(ms=ms, device_ms=alone, plain_ms=plain_ms,
                           parent_torch_ms=parent_ms, bound_ms=bound,
                           bound_by=kind)
        log(f"phase 16: butterfly_rows {list(shape)} {dtype}: {ms:.4f} ms a "
            f"launch, the kernel alone {alone:.4f} ms; bound {bound:.4f} ms "
            f"({kind}; {bound / alone:.1%} of it); plain {plain_ms:.3f} ms; "
            f"the parent's cast, stack and polar_transform {parent_ms:.3f} "
            f"ms [{card}]")
    return dict(name="butterfly_rows", route="cuda",
                source="polar_torch/csrc/butterfly.cu", replaces=None,
                launches=main_launches, chain_launches=chain_launches,
                mismatch_elements=bad,
                checked_elements=checked,
                **{f"{k}_{name}": v for name, t in times.items()
                   for k, v in t.items()}, library_ms=None)


def qpsk_front_phase(dev, card, main_launches):
    """Phase 17: the QPSK transmitter (``qpsk_front``,
    ``csrc/qpsk_front.cu``): its registers and spills (``-Xptxas -v``);
    against its plain version at every width n = 2..4096 on random frozen
    sets; the main chain's kernel path against its composed chain at the
    timed batches, bit for bit in bits, codewords and LLRs, with the
    generator left alike; then the kernel's ms a launch (CUDA events over
    back-to-back launches) and alone (profiler) beside its bound, the
    kernel path's whole front end (draws included) beside the composed
    chain's and the plain version's. Returns its ``kernels`` entry, whose
    ``launches`` is ``main_launches``, the main path's count from phase
    4."""
    import numpy as np
    import torch
    from polar_torch import generate_5g_ranking
    from polar_torch.models.polar.cuda_front import (
        qpsk_front, qpsk_front_plain, transmit_plan)
    from polar_torch.models.polar.encode import PolarEncoder
    from polar_torch.models.systems import SystemAWGNModel
    from polar_torch.ops.channels import normal_parts
    from polar_torch.ops.ebno import ebnodb2no
    from polar_torch.ops.mapping import Constellation
    from polar_torch.utils.kernel_work import bound_ms, qpsk_front_work
    from polar_torch.utils.profiling import cuda_ms

    regs = ptxas_report(os.path.join(ROOT, "polar_torch", "csrc",
                                     "qpsk_front.cu"),
                        r"(_Z\w*qpsk_front_kernelILi(\d+)E\w*)",
                        lambda m: f"qpsk_front_kernel<{m[2]}>")
    for name in sorted(regs, key=lambda x: int(x.split("<")[1][:-1])):
        log(f"phase 17: {name} (-Xptxas -v): {regs[name]}")
    m_main = N.bit_length() - 1
    if not regs.get(f"qpsk_front_kernel<{m_main}>"):
        raise AssertionError(f"phase 17: no -Xptxas -v line of "
                             f"qpsk_front_kernel<{m_main}>: {regs}")

    bits_of = lambda x: x.contiguous().view(torch.int32)    # noqa: E731
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(dev).manual_seed(SEED)
    checked = bad = 0
    for m in range(1, 13):
        n = 1 << m
        k = int(rng.integers(1, n + 1))
        frozen = np.sort(rng.choice(n, n - k, replace=False))
        table, a = transmit_plan(PolarEncoder(frozen, n, device=dev),
                                 Constellation(2, device=dev), dev)
        bs = QPSK_FRONT_CHECK_BS
        bits = torch.randint(0, 2, (bs, k), generator=gen,
                             device=dev).float()
        xr, xi = normal_parts(gen, (bs, n // 2))
        no = ebnodb2no(0.5, 2, k / n)
        got = qpsk_front(bits, xr, xi, table, a, no)
        want = qpsk_front_plain(bits, xr, xi, table, a, no)
        checked += 2 * bs * n
        bad += sum(int((bits_of(x) != bits_of(y)).sum().item())
                   for x, y in zip(got, want))
    log(f"phase 17: qpsk_front against qpsk_front_plain at n = 2..4096: "
        f"{bad} of {checked} elements differ")
    if bad:
        raise AssertionError(f"phase 17: qpsk_front differs from its plain "
                             f"version in {bad} elements")

    enc = PolarEncoder(generate_5g_ranking(K, N)[0], N, device=dev)
    model = SystemAWGNModel(N, K, enc, None)
    composed = SystemAWGNModel(N, K, enc, None)
    composed._transmit = None           # the chain as it ran before
    if model._transmit is None:
        raise AssertionError("phase 17: the plain QPSK chain on the card "
                             "does not take the kernel")
    table, a = model._transmit
    no = ebnodb2no(EBNO_MAIN_DB, 2, K / N)
    times = {}
    for name, bs in QPSK_FRONT_SHAPES:
        g_kernel = torch.Generator(dev).manual_seed(SEED + bs)
        g_composed = torch.Generator(dev).manual_seed(SEED + bs)
        got = model.front(g_kernel, bs, EBNO_MAIN_DB)
        want = composed.front(g_composed, bs, EBNO_MAIN_DB)
        torch.cuda.synchronize()
        same = (all(torch.equal(bits_of(x), bits_of(y))
                    for x, y in zip(got, want))
                and torch.equal(g_kernel.get_state(), g_composed.get_state()))
        if not same:
            raise AssertionError(f"phase 17: {name}: the kernel path's front "
                                 f"end differs from the composed chain's")
        bits = got[0]
        xr, xi = normal_parts(g_kernel, (bs, N // 2))
        del got, want

        def launch():
            return qpsk_front(bits, xr, xi, table, a, no)
        ms = cuda_ms(launch, QPSK_FRONT_REPS)
        alone = kernel_device_ms(launch, 20, "qpsk_front_kernel")
        front_ms = cuda_ms(lambda: model.front(g_kernel, bs, EBNO_MAIN_DB),
                           10)
        composed_ms = cuda_ms(
            lambda: composed.front(g_kernel, bs, EBNO_MAIN_DB), 10)
        plain_ms = cuda_ms(
            lambda: qpsk_front_plain(bits, xr, xi, table, a, no), 3)
        bound, kind = bound_ms(*qpsk_front_work(bs, K, N))
        times[name] = dict(ms=ms, device_ms=alone, front_ms=front_ms,
                           composed_front_ms=composed_ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=kind)
        log(f"phase 17: qpsk_front ({bs}, {N}, {K}): {ms:.4f} ms a launch, "
            f"the kernel alone {alone:.4f} ms; bound {bound:.4f} ms ({kind}; "
            f"{bound / alone:.1%} of it); the kernel path's front end "
            f"{front_ms:.3f} ms against the composed chain's "
            f"{composed_ms:.3f} ms; plain {plain_ms:.3f} ms; codewords and "
            f"LLRs equal to the composed chain's [{card}]")
    return dict(name="qpsk_front", route="cuda",
                source="polar_torch/csrc/qpsk_front.cu", replaces=None,
                launches=main_launches, mismatch_elements=bad,
                checked_elements=checked,
                registers={k: v.get("registers") for k, v in regs.items()},
                spill_bytes={k: v.get("spill_stores", 0)
                             + v.get("spill_loads", 0)
                             for k, v in regs.items()},
                **{f"{k}_{name}": v for name, t in times.items()
                   for k, v in t.items()}, library_ms=None)


def bec_link_phase(dev, gen, card, encoder, frozen, reset_counts, counts):
    """Phase 11: ``SystemBECModel`` with the CLI's SC and SCL-8 decoders on
    the k=512 n=1024 code through ``sim_ber``, each BLER against its
    yardstick; the GA construction's g++ build against its NumPy twin."""
    import numpy as np
    import torch
    from polar_torch.models.polar.construction import generate_ga_code
    from polar_torch.models.polar.ga import ga_bit_channel_means
    from polar_torch.models.polar.sc import PolarSCDecoder
    from polar_torch.models.polar.scl import PolarSCLDecoder
    from polar_torch.models.systems import SystemBECModel
    from polar_torch.sim import sim_ber

    for name, key, bec_dec in (
            ("SC", "bec_sc", PolarSCDecoder(frozen, N, mode=MODE,
                                            device=dev)),
            (f"SCL-{LIST_SIZE}", f"bec_scl{LIST_SIZE}",
             PolarSCLDecoder(frozen, N, list_size=LIST_SIZE, mode=MODE,
                             device=dev))):
        bec_model = SystemBECModel(N, K, encoder, bec_dec)
        with tempfile.TemporaryDirectory() as tmp:
            jsonl = os.path.join(tmp, "bec.jsonl")
            reset_counts()
            torch.cuda.synchronize()
            sim_ber(bec_model, BEC_PE, batch_size=BATCH,
                    max_mc_iter=BEC_BATCHES, early_stop=False,
                    verbose=False, seed=SEED, jsonl_path=jsonl)
            torch.cuda.synchronize()
            run = counts()
            with open(jsonl) as fh:
                rows = [json.loads(line) for line in fh]
        kernel = "sc_subtree" if name == "SC" else "scl_subtree"
        if run[kernel] == 0 or len(rows) != len(BEC_PE):
            raise AssertionError(f"BEC link {name}: {len(rows)} points, "
                                 f"launches {run}")
        for row in rows:
            pe = round(row["ebno_db"], 2)
            log(f"phase 11: BEC link, {name} (k={K} n={N} 5G, {MODE}), "
                f"pe={pe}: {row['runtime_s']:.3f} s, "
                f"{K * row['num_blocks'] / row['runtime_s']:.4g} info bit/s;"
                f" launches {run} [{card}]")
            binomial_gate(f"phase 11: BEC {name} at pe={pe}",
                          row["block_errors"], row["num_blocks"],
                          f"{key}_{pe}")
    t0 = time.perf_counter()
    ga_k, ga_n, ga_db = GA_CODE
    ga_frozen, _ = generate_ga_code(ga_k, ga_n, ga_db)
    ga_s = time.perf_counter() - t0
    m0 = 4.0 * (ga_k / ga_n) * 10.0 ** (ga_db / 10.0)
    twin = ga_bit_channel_means(ga_n, m0, force_numpy=True)
    want = np.sort(np.argsort(twin, kind="stable")[: ga_n - ga_k])
    same = np.array_equal(ga_frozen, want)
    log(f"phase 11: GA frozen set k={ga_k} n={ga_n} at {ga_db} dB from the "
        f"g++ build ({ga_s:.2f} s, build included) equal to the NumPy "
        f"twin's: {same}")
    if not same:
        raise AssertionError("the GA build's frozen set differs from the "
                             "NumPy twin's")


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Smoke run of polar_torch on "
                                             "one CUDA card.")
    ap.add_argument("--parent", help="a checkout of the parent commit: "
                    "phase 7 times its SCL kernel against this one's")
    parent = ap.parse_args(argv).parent
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "polar_torch")):
        print("chip_smoke: run from a checkout of the repo (polar_torch/ "
              "not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    from polar_torch import _build, generate_5g_ranking
    from polar_torch.bench import build_model, time_steps
    from polar_torch._device import resolve_device
    from polar_torch.config import PolarConfig
    from polar_torch.main import sweep
    from polar_torch.models.polar import cuda_bp, cuda_sc, cuda_scl, scan_core
    from polar_torch.models.polar.bp import PolarBPDecoder
    from polar_torch.models.polar.construction import get_kern_frozen_bits
    from polar_torch.models.polar.cuda_bp import bp_decode, bp_decode_plain
    from polar_torch.models.polar.cuda_sc import (
        sc_schedule, sc_subtree, sc_subtree_plain, traced_schedule)
    from polar_torch.models.polar.cuda_scl import (
        SubtreeSchedule, scl_subtree, scl_subtree_plain)
    from polar_torch.models.polar.sc import PolarSCDecoder
    from polar_torch.models.polar.scl import PolarSCLDecoder
    from polar_torch.ops.butterfly import polar_transform
    from polar_torch.models.polar.decode5g import Polar5GDecoder
    from polar_torch.models.polar.encode import Polar5GEncoder
    from polar_torch.models.systems import SystemAWGNModel
    from polar_torch.sim import count_block_errors, sim_ber
    from polar_torch.ops.channels import BinaryErasureChannel
    from polar_torch.ops.source import binary_source
    from polar_torch.utils.kernel_work import (
        bound_ms, bp_work, launch_counts as counts,
        reset_launch_counts as reset_counts, sc_subtree_work, subtree_work)
    from polar_torch.utils.profiling import cuda_ms

    # ---- phase 1: the card ----
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"phase 1: {kind}, {torch.cuda.device_count()} card(s); "
        f"nvidia-smi: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    dev = resolve_device()                      # the current card

    # ---- phase 2: build every kernel of the paths, compilers in parallel
    t0 = time.perf_counter()
    kernels_built = ("scl_subtree", "sc_subtree", "bp", "probes",
                     "butterfly", "qpsk_front")
    libs = _build.build([(name, "cuda") for name in kernels_built])
    for name in kernels_built:
        _build.load(name, "cuda")
    log(f"phase 2: built {', '.join(kernels_built)} (nvcc, sm_90a, in "
        f"parallel) in {time.perf_counter() - t0:.1f} s")
    for line in resource_usage(libs):
        log(f"  {line}")
    bf16_smem = [cuda_bp.launch_plan(n_bp, msg_dtype=torch.bfloat16)[2]
                 for n_bp in (N, 2048, 4096)]
    log("phase 2: the bp kernel's bf16 instances (dynamic shared memory per "
        f"CTA at n = {N}, 2048, 4096: {bf16_smem} B):")
    for line in bp_bf16_resources(libs[kernels_built.index("bp")]):
        log(f"  {line}")

    # ---- phase 3: kernels against their plain versions on the card ----
    log("phase 3: scl_subtree kernel against scl_subtree_plain")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    check = Check()

    def mask_of(frozen, n):
        mask = np.zeros(n, bool)
        mask[frozen] = True
        return mask

    def random_units(mask, b, L, bs, mode, spc=None, into=check):
        units, _ = scan_core.split_fast_schedule(mask, b, rate1=True,
                                                 spc_min_stage=spc)
        for i, u in enumerate(x for x in units if x[0] == "sub"):
            ops = u[2]
            a = 3.0 * torch.randn((1 << b, L, bs), generator=gen, device=dev)
            pm = torch.empty((L, bs), device=dev).exponential_(
                0.5, generator=gen)
            sched = SubtreeSchedule(ops, dev)
            kw = dict(b=b, llr_max=30.0, mode=mode)
            got = scl_subtree(a, pm, sched, **kw)
            want = scl_subtree_plain(a, pm, ops, **kw)
            into.add(f"{len(mask)}-leaf mask, b={b}, L={L}, {mode}, "
                     f"unit {i} ({len(ops)} ops)", want, got)

    random_units(mask_of(generate_5g_ranking(32, 64)[0], 64), 3, 8, 4096,
                 "minsum")
    rng = np.random.default_rng(SEED)
    for L, spc in ((8, 2), (4, None), (2, 3)):
        random_units(rng.random(128) < rng.uniform(0.2, 0.8), 4, L, 2048,
                     "minsum", spc)

    frozen, _ = generate_5g_ranking(K, N)
    # the main path's chain, as python -m polar_torch.bench builds it
    model = build_model(K, N, LIST_SIZE, device=dev)
    dec = model.decoder
    if (dec.mode, dec.use_fast_scl, dec.fast_rate1) != (MODE, True, True):
        raise AssertionError("the bench chain is not min-sum fast-SCL with "
                             "rate-1 nodes")
    main_b = dec.lower_stages
    _, _, llr = model.front(gen, BATCH, EBNO_MAIN_DB)
    llr_ch = (-llr).t().contiguous()
    mask = mask_of(frozen, N)

    def plain_subtree(a, pm, sched, **kw):
        return scl_subtree_plain(a, pm, sched.ops, **kw)

    main_calls = []
    # the decoder's depth, a smaller one (more of the sweep outside the
    # kernel, on the card too) and the whole tree as one call
    for b in dict.fromkeys((main_b, TRACED_B, N.bit_length() - 1)):
        kw = dict(mode=MODE, llr_max=30.0, lower_stages=b, rate1=True)
        u_k, pm_k = scan_core.scl_sweep_hybrid_fast(
            llr_ch, mask, LIST_SIZE,
            subtree=(recorder(main_calls, scl_subtree) if b == main_b
                     else scl_subtree), **kw)
        u_p, pm_p = scan_core.scl_sweep_hybrid_fast(
            llr_ch, mask, LIST_SIZE, subtree=plain_subtree, **kw)
        check.add(f"k={K} n={N} sweep, b={b}, bs={BATCH}",
                  (u_p, torch.zeros_like(pm_p), pm_p),
                  (u_k, torch.zeros_like(pm_k), pm_k))
    for i, ((a, pm, sched), kw) in enumerate(main_calls):
        want = scl_subtree_plain(a, pm, sched.ops, **kw)
        got = scl_subtree(a, pm, sched, **kw)
        if check.add(f"main-path call {i}, b={main_b}, bs={BATCH}", want,
                     got):
            cols = differing(want, got).nonzero().flatten().tolist()
            for col, gap, rel in near_tie_gaps(a, pm, sched.ops, cols, **kw):
                log(f"  differing block {col} of call {i} (seed {SEED}, "
                    f"{EBNO_MAIN_DB} dB): smallest candidate gap {gap:.3g} "
                    f"({rel:.3g} of its best path metric)")

    # the plain (unpruned) SCL-8 sweep of the CLI path, same LLRs
    plain_b = PolarSCLDecoder(frozen, N, list_size=LIST_SIZE, mode=MODE,
                              use_fast_scl=False, device=dev).lower_stages
    plain_calls = []
    kw = dict(mode=MODE, llr_max=30.0, lower_stages=plain_b)
    u_k, pm_k = scan_core.scl_sweep_hybrid(
        llr_ch, mask, LIST_SIZE, subtree=recorder(plain_calls, scl_subtree),
        **kw)
    u_p, pm_p = scan_core.scl_sweep_hybrid(llr_ch, mask, LIST_SIZE,
                                           subtree=plain_subtree, **kw)
    check.add(f"k={K} n={N} plain sweep, b={plain_b}, bs={BATCH}, "
              f"{EBNO_MAIN_DB} dB", (u_p, torch.zeros_like(pm_p), pm_p),
              (u_k, torch.zeros_like(pm_k), pm_k))

    # BEC inputs: the channel's logits (+-100, clipped to 30 in the sweeps;
    # erasures are -0.0 for a 0 bit, +0.0 for a 1 bit) of codewords of the
    # same code, negated into channel LLRs; the plain SCL-8 sweep and the
    # fast sweep with rate-1 nodes, at their decoders' depths
    bec_channel = BinaryErasureChannel(return_llrs=True)
    bec_llr = {}
    for pe in BEC_CHECK_PE:
        cw = model.encoder(binary_source(gen, (BATCH, K)))
        logits = bec_channel(gen, (cw, pe))
        zeros = logits == 0
        neg = int((zeros & torch.signbit(logits)).sum().item())
        log(f"  BEC at pe={pe}: {int(zeros.sum().item())} erasures, {neg} "
            f"of them -0.0")
        if neg == 0 or neg == int(zeros.sum().item()):
            raise AssertionError("the BEC logits lack one sign of zero")
        bec_llr[pe] = (-logits).t().contiguous()
    scl_bec = check.n_blocks
    for pe, llr_b in bec_llr.items():
        for label, sweep_fn, kw in (
                ("plain sweep", scan_core.scl_sweep_hybrid,
                 dict(lower_stages=plain_b)),
                ("fast sweep, rate-1", scan_core.scl_sweep_hybrid_fast,
                 dict(lower_stages=main_b, rate1=True))):
            kw = dict(kw, mode=MODE, llr_max=30.0)
            u_k, pm_k = sweep_fn(llr_b, mask, LIST_SIZE, subtree=scl_subtree,
                                 **kw)
            u_p, pm_p = sweep_fn(llr_b, mask, LIST_SIZE,
                                 subtree=plain_subtree, **kw)
            check.add(f"k={K} n={N} {label} on BEC logits, pe={pe}, "
                      f"b={kw['lower_stages']}, bs={BATCH}",
                      (u_p, torch.zeros_like(pm_p), pm_p),
                      (u_k, torch.zeros_like(pm_k), pm_k))
    scl_bec = check.n_blocks - scl_bec
    torch.cuda.synchronize()
    log(f"phase 3: scl_subtree static, L <= 8: {check.n_bad} of "
        f"{check.n_blocks} blocks differ; pm max abs {check.max_abs:.3g}, "
        f"max rel {check.max_rel:.3g}")

    # L = 16, 32: the k=512 n=1024 fast schedule and random masks (rate-1
    # and SPC nodes), both modes
    check_wide = Check()
    for L in (16, 32):
        for mode in ("minsum", "exact"):
            random_units(mask, main_b, L, WIDE_BATCH, mode, into=check_wide)
            random_units(rng.random(128) < rng.uniform(0.2, 0.8), 4, L,
                         WIDE_BATCH, mode, spc=2, into=check_wide)

    # depths whose workspaces outgrow a block's shared-memory budget, so
    # the upper stages sit in the global scratch: L=8 at b=10 and L=32 at
    # b=8 on the k=512 n=1024 fast schedule, both modes
    for L, b, bs, into in ((8, 10, BATCH // 2, check), (32, 8, WIDE_BATCH,
                                                        check_wide)):
        log(f"  L={L}, b={b}: {cuda_scl.shared_stages(b, L)} of {b} "
            f"workspace stages in shared memory")
        for mode in ("minsum", "exact"):
            random_units(mask, b, L, bs, mode, into=into)

    # the 5G path: the plain sweep of the k=400 E=1000 mother code at the
    # decoder's depth (the whole tree, static leaf schedule) against the
    # plain version; and at b=TRACED_B, where its 16 subtrees share one
    # traced schedule, against the plain version and bit for bit against
    # the static leaf-only form
    check_traced = Check()
    enc5 = Polar5GEncoder(G5_K, G5_E, device=dev)
    mask5 = mask_of(enc5.frozen_pos, enc5.n_polar)
    traced_calls, g5_calls = {}, {}
    for L in (8, 16, 32):
        bs = BATCH if L == 8 else WIDE_BATCH
        dec5 = Polar5GDecoder(enc5, dec_type="SCL", list_size=L,
                              mode=G5_MODE)
        model5 = SystemAWGNModel(G5_E, G5_K, enc5, dec5)
        llr5 = (-dec5.rate_recover(model5.front(gen, bs, G5_EBNO_DB)[2])).t(
            ).contiguous()
        b5 = dec5._polar_dec.lower_stages
        kw = dict(mode=G5_MODE, llr_max=30.0, lower_stages=b5)
        calls = g5_calls[L] = []
        u_k, pm_k = scan_core.scl_sweep_hybrid(
            llr5, mask5, L, subtree=recorder(calls, scl_subtree), **kw)
        u_p, pm_p = scan_core.scl_sweep_hybrid(llr5, mask5, L,
                                               subtree=plain_subtree, **kw)
        (check_wide if L > 8 else check).add(
            f"5G k={G5_K} E={G5_E} plain sweep, L={L}, b={b5}, bs={bs}, "
            f"{G5_MODE}", (u_p, torch.zeros_like(pm_p), pm_p),
            (u_k, torch.zeros_like(pm_k), pm_k))
        b5 = TRACED_B
        kw = dict(mode=G5_MODE, llr_max=30.0, lower_stages=b5)
        traced_plan = scan_core.plan_plain_sweep(mask5, b5, dev)
        static_plan = scan_core.plan_sweep(scan_core.leaf_schedule(mask5),
                                           b5, dev)
        if not all(u[2].traced for u in traced_plan):
            raise AssertionError(f"the 5G plain sweep at b={b5} is not on "
                                 "the traced form")
        calls = traced_calls[L] = []
        u_t, pm_t = scan_core.scl_sweep_hybrid(
            llr5, mask5, L, plan=traced_plan,
            subtree=recorder(calls, scl_subtree), **kw)
        u_s, pm_s = scan_core.scl_sweep_hybrid(llr5, mask5, L,
                                               plan=static_plan, **kw)
        u_p, pm_p = scan_core.scl_sweep_hybrid(llr5, mask5, L,
                                               plan=traced_plan,
                                               subtree=plain_subtree, **kw)
        same = torch.equal(u_t, u_s) and torch.equal(pm_t, pm_s)
        log(f"  5G k={G5_K} E={G5_E} plain sweep, L={L}, b={b5}, bs={bs}, "
            f"{G5_MODE}: traced bit-equal to static: {same}")
        if not same:
            raise AssertionError(f"L={L}: the traced form differs from the "
                                 "static form")
        label = (f"5G k={G5_K} E={G5_E} traced sweep, L={L}, b={b5}, "
                 f"bs={bs}, {G5_MODE}")
        for into in (check_traced, check_wide) if L > 8 else (check_traced,):
            into.add(label, (u_p, torch.zeros_like(pm_p), pm_p),
                     (u_t, torch.zeros_like(pm_t), pm_t))
    torch.cuda.synchronize()
    for name, c in (("L=16/32", check_wide), ("traced", check_traced)):
        log(f"phase 3: scl_subtree {name}: {c.n_bad} of {c.n_blocks} "
            f"blocks differ; pm max abs {c.max_abs:.3g}, max rel "
            f"{c.max_rel:.3g}")

    def subtree_times(calls, label, reps):
        """Kernel, plain and bound ms over ``calls`` of scl_subtree."""
        k_ms = cuda_ms(lambda: [scl_subtree(*args, **kw)
                                for args, kw in calls], reps=reps)
        p_ms = cuda_ms(lambda: [scl_subtree_plain(a, pm, sched.ops, **kw)
                                for (a, pm, sched), kw in calls], reps=1)
        n_bytes = n_ops = 0
        for (a, _, sched), kw in calls:
            call_bytes, call_ops = subtree_work(sched.ops, kw["b"],
                                                kw["mode"], a, kw.get("frz"))
            n_bytes += call_bytes
            n_ops += call_ops
        bnd, by = bound_ms(n_bytes, n_ops)
        (a, _, _), kw = calls[0]
        log(f"  scl_subtree, {len(calls)} calls of {label} (b={kw['b']}, "
            f"L={a.shape[1]}, bs={a.shape[2]}, {kw['mode']}): kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.3f} ms; bound {bnd:.4f} ms ({by}: "
            f"{n_bytes} B, {n_ops} f32 ops); library: none [{card}]")
        return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by)

    scl_times = {
        "static": subtree_times(main_calls, "one fast main-path step",
                                reps=3),
        "traced": subtree_times(traced_calls[8], "one CA-SCL-8 decode, "
                                "traced", reps=3),
        "wide": subtree_times(g5_calls[32], "one CA-SCL-32 decode", reps=2),
        "CA-SCL-8": subtree_times(g5_calls[8], "one CA-SCL-8 decode",
                                  reps=3),
    }
    subtree_times(g5_calls[16], "one CA-SCL-16 decode", reps=2)
    subtree_times(traced_calls[32], "one CA-SCL-32 decode, traced", reps=2)
    subtree_times(plain_calls, "one plain-sweep SCL-8 decode (CLI)", reps=3)

    log("phase 3: sc_subtree kernel against sc_subtree_plain")
    sc_check = ScCheck()

    def constructed_mask(n):
        """Random rate; frozen by row weight, random order among ties: the
        construction's structure, so info leaves are reliable ones."""
        _, weights, _ = get_kern_frozen_bits(n, 0)
        order = np.lexsort((rng.random(n), weights))
        m = np.zeros(n, bool)
        m[order[:int(rng.uniform(0.2, 0.8) * n)]] = True
        return m

    def codeword_llr(m, bs, sigma):
        """BPSK-over-AWGN channel LLRs of random codewords of mask ``m``."""
        u = torch.randint(0, 2, (len(m), bs), generator=gen, device=dev,
                          dtype=torch.int8)
        u = u * torch.from_numpy(~m).to(dev, torch.int8)[:, None]
        c = polar_transform(u, axis=0).to(torch.float32)
        y = 1.0 - 2.0 * c + sigma * torch.randn(c.shape, generator=gen,
                                                 device=dev)
        return (2.0 * y / sigma ** 2).contiguous()

    # min-sum on uniformly random masks and N(0, 3^2) LLRs; exact mode on
    # constructed masks and codeword LLRs: the exact boxplus loses all
    # precision below ~1e-7 in f32, so an info leaf at an unreliable
    # position would be decided by rounding in either version
    # b = 1..10 (b=10: a whole n=1024 tree), SC_CHECK_BATCH columns, which
    # no block's codeword count divides; the default group size and split,
    # 32 lanes (segments narrower than the group from stage 5 down), and 4
    # lanes with every workspace stage in the global scratch
    for b in range(1, 11):
        m_rand = rng.random(1 << b) < rng.uniform(0.2, 0.8)
        m_cons = constructed_mask(1 << b)
        for mode, m, a in (
                ("minsum", m_rand, 3.0 * torch.randn(
                    (1 << b, SC_CHECK_BATCH), generator=gen, device=dev)),
                ("exact", m_cons, codeword_llr(m_cons, SC_CHECK_BATCH,
                                               0.8))):
            frz = torch.from_numpy(m.astype(np.int32)).to(dev)
            for form, ops in (
                    ("static", scan_core.fast_schedule(m, rep=False)),
                    ("traced", traced_schedule(b))):
                kw = dict(b=b, llr_max=30.0, mode=mode)
                want = sc_subtree_plain(a, frz, ops, **kw)
                sched = sc_schedule(ops, dev)
                for lanes, n_sh in ((None, None), (32, None), (4, 0)):
                    if mode == "exact" and lanes is not None:
                        continue
                    got = sc_subtree(a, frz, sched, lanes=lanes,
                                     n_shared=n_sh, **kw)
                    g = lanes or cuda_sc.DEFAULT_LANES
                    n_sh = cuda_sc.shared_stages(b, g) if n_sh is None \
                        else n_sh
                    sc_check.add(f"b={b}, {form} ({len(ops)} ops), {g} "
                                 f"lanes, {n_sh} shared stages, bs="
                                 f"{SC_CHECK_BATCH}", mode, want, got)

    sc_b = PolarSCDecoder(frozen, N, mode=MODE, device=dev).lower_stages

    def plain_sc(a, frz, sched, **kw):
        return sc_subtree_plain(a, frz, sched.ops, **kw)

    sc_calls = []
    for mode in ("minsum", "exact"):
        for b in sorted({sc_b, N.bit_length() - 1}):
            record = mode == MODE and b == sc_b
            u_k = scan_core.sc_sweep_hybrid(
                llr_ch, mask, mode=mode, lower_stages=b,
                subtree=recorder(sc_calls, sc_subtree) if record
                else sc_subtree)
            u_p = scan_core.sc_sweep_hybrid(llr_ch, mask, mode=mode,
                                            lower_stages=b, subtree=plain_sc)
            sc_check.add(f"k={K} n={N} SC sweep, b={b}, bs={BATCH}, "
                         f"{EBNO_MAIN_DB} dB", mode, u_p, u_k)
    # the BEC logits of the SCL checks at the SC decoder's depth (static
    # form); the -0.0 and +0.0 erasures must decide the same bits
    sc_bec = sc_check.n_blocks
    for pe, llr_b in bec_llr.items():
        u_k = scan_core.sc_sweep_hybrid(llr_b, mask, mode=MODE,
                                        lower_stages=sc_b)
        u_p = scan_core.sc_sweep_hybrid(llr_b, mask, mode=MODE,
                                        lower_stages=sc_b, subtree=plain_sc)
        sc_check.add(f"k={K} n={N} SC sweep on BEC logits, pe={pe}, "
                     f"b={sc_b}, bs={BATCH}", MODE, u_p, u_k)
        flipped = torch.where(llr_b == 0, -llr_b, llr_b)
        same = torch.equal(u_k, scan_core.sc_sweep_hybrid(
            flipped, mask, mode=MODE, lower_stages=sc_b))
        log(f"  SC on BEC logits, pe={pe}: zeros of the other sign decide "
            f"the same bits: {same}")
        if not same:
            raise AssertionError("SC decides -0.0 and +0.0 erasures apart")
    sc_bec = sc_check.n_blocks - sc_bec
    torch.cuda.synchronize()
    log(f"phase 3: BEC logits checked: scl_subtree {scl_bec} blocks, "
        f"sc_subtree {sc_bec} blocks")
    log(f"phase 3: sc_subtree: min-sum {sc_check.bad['minsum']} of "
        f"{sc_check.blocks['minsum']} blocks differ, exact "
        f"{sc_check.bad['exact']} of {sc_check.blocks['exact']}")

    def sc_times(calls, label, reps=5):
        """Kernel, plain and bound ms over ``calls`` of sc_subtree."""
        k_ms = cuda_ms(lambda: [sc_subtree(*args, **kw)
                                for args, kw in calls], reps=reps)
        p_ms = cuda_ms(lambda: [sc_subtree_plain(a, frz, sched.ops, **kw)
                                for (a, frz, sched), kw in calls], reps=1)
        n_bytes = n_ops = 0
        for (a, _, sched), kw in calls:
            call_bytes, call_ops = sc_subtree_work(sched.ops, kw["b"],
                                                   a.shape[1], kw["mode"])
            n_bytes += call_bytes
            n_ops += call_ops
        bnd, by = bound_ms(n_bytes, n_ops)
        (a, _, _), kw = calls[0]
        log(f"  sc_subtree, {len(calls)} calls of {label} (b={kw['b']}, "
            f"bs={a.shape[1]}, {kw['mode']}): kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms; bound {bnd:.4f} ms ({by}: {n_bytes} B, {n_ops} "
            f"f32 ops); library: none [{card}]")
        return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by)

    # SC kernel, plain and bound over the subtree calls of one SC decode
    sc_time = sc_times(sc_calls, "one SC decode")
    # the PC schedules of both kernels (phase 3's part for this slice)
    pc_scl_check, pc_sc_check = pc_kernel_checks(dev, gen)

    log("phase 3: bp kernel against bp_decode_plain")
    bp_check = BpCheck()
    # the CLI's BP-20 chain: the same 5G k=512 n=1024 code and encoder
    bp_dec = PolarBPDecoder(frozen, N, num_iter=BP_ITER, device=dev)
    bp_model = SystemAWGNModel(N, K, model.encoder, bp_dec)
    bp_logits = bp_model.front(gen, BATCH, BP_EBNO_DB)[2]
    bp_prior = bp_dec._prior

    def bp_cases(cases, msg_dtype, into):
        for n, bs, lattice, msf, es, iters, every, mode in cases:
            if n == N:  # the decoder's own call: [bs, n] logits, transposed
                prior, llr, negate = bp_prior, bp_logits[:bs].t(), True
            else:       # true LLRs [n, bs] of random codewords
                m = np.zeros(n, bool)
                m[generate_5g_ranking(n // 2, n)[0] if n <= N
                  else get_kern_frozen_bits(n, n // 2)[2]] = True
                prior = torch.from_numpy(np.where(m, 30.0, 0.0).astype(
                    np.float32)).to(dev)
                llr = codeword_llr(m, bs, 10 ** (-BP_EBNO_DB / 20))
                negate = False
            kw = dict(num_iter=iters, check_every=every, early_stop=es,
                      mode=mode, msf=msf, llr_max=30.0, return_done=es,
                      negate=negate, msg_dtype=msg_dtype)
            got = bp_decode(llr, prior, lattice=lattice, **kw)
            want = bp_decode_plain(llr, prior, **kw)
            if not es:
                got, want = (got, torch.zeros(bs, device=dev)), \
                    (want, torch.zeros(bs, device=dev))
            into.add(f"{str(msg_dtype)[6:]} messages, n={n}, bs={bs}, "
                     f"{cuda_bp.resolve_lattice(n, lattice)} lattice, msf "
                     f"{msf}, early stop {es}, {iters} sweeps, check every "
                     f"{every}", mode, prior == 0, want, got)
        torch.cuda.synchronize()
        log(f"phase 3: bp, {str(msg_dtype)[6:]} messages: {into.n_bad} of "
            f"{into.n_blocks} blocks differ; min-sum llr max abs gap "
            f"{into.max_abs:.3g}")

    bp_cases(BP_CASES, torch.float32, bp_check)
    log("phase 3: bp kernel's bf16 instance against bp_decode_plain(bf16)")
    bp16_check = BpCheck()
    bp_cases(BP_BF16_CASES, torch.bfloat16, bp16_check)

    # ---- phase 4: the main path, timed as python -m polar_torch.bench
    # times it (time_steps zeroes the counts again after its warm-up) ----
    steps = 10
    reset_counts()
    torch.cuda.synchronize()
    step_s, errs, blk = time_steps(model, gen, BATCH, EBNO_MAIN_DB, warmup=1,
                                   iters=steps)
    main_counts = counts()
    launches = main_counts["scl_subtree"]
    if launches == 0:
        raise AssertionError("the main path launched no scl_subtree kernel")
    if main_counts["butterfly_rows"] != launches:
        raise AssertionError(f"the main path's decodes launched "
                             f"butterfly_rows {main_counts['butterfly_rows']}"
                             f" times, scl_subtree {launches}")
    if main_counts["qpsk_front"] != launches:
        raise AssertionError(f"the main path's fronts launched qpsk_front "
                             f"{main_counts['qpsk_front']} times, "
                             f"scl_subtree {launches}")
    if main_counts["scl_subtree traced"] or main_counts["scl_subtree wide"]:
        raise AssertionError(f"the fast main path left the static L=8 "
                             f"form: {main_counts}")
    bits, bits_hat = model.step(gen, BATCH, EBNO_MAIN_DB)
    if bits_hat.shape != (BATCH, K) or not torch.isin(
            bits_hat, torch.tensor([0.0, 1.0], device=dev)).all():
        raise AssertionError(f"decoder output of shape {bits_hat.shape} is "
                             "not a [batch, k] array of bits")
    info_bps = BATCH * K / step_s
    log(f"phase 4: k={K} n={N} SCL-{LIST_SIZE} {MODE} fast+rate-1, "
        f"bs={BATCH}, {EBNO_MAIN_DB} dB, b={main_b}: {step_s * 1e3:.3f} ms "
        f"per step, {info_bps:.6g} info bit/s; {launches} scl_subtree "
        f"launches in {steps} timed steps; BER "
        f"{errs / (steps * BATCH * K):.3g}, BLER {blk / (steps * BATCH):.4g} "
        f"[{card}]")

    # ---- phase 5: BLER against the committed yardstick ----
    with open(os.path.join(ROOT, "benchmarks", "bler_validation.json")) as fh:
        yardsticks = json.load(fh)

    def yardstick(key, ebno_db):
        row = yardsticks[key]
        return row["bler"][row["ebno_db"].index(ebno_db)]

    want_bler = yardstick("scl8_n1024_fast_r1", EBNO_BLER_DB)
    blk = 0
    for _ in range(BLER_BLOCKS // BATCH):
        bits, bits_hat = model.step(gen, BATCH, EBNO_BLER_DB)
        blk += count_block_errors(bits, bits_hat).item()
    bler = blk / BLER_BLOCKS
    log(f"phase 5: BLER {bler:.5f} at {EBNO_BLER_DB} dB over {BLER_BLOCKS} "
        f"blocks; yardstick {want_bler:.5f} +- {BLER_TOL}")
    if abs(bler - want_bler) > BLER_TOL:
        raise AssertionError(f"BLER {bler} is off the yardstick {want_bler}")

    # ---- phase 6: the CLI path ----
    cfg = PolarConfig(k=K, n=N, construction="5g", bs=BATCH,
                      algos=["scl", "bp"], bp_iter=BP_ITER,
                      mc_iter=CLI_MC_ITER, target_block_errs=None, seed=SEED,
                      device=str(dev))
    log(f"phase 6: CLI sweep {cfg}")
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "sweep.jsonl")
        reset_counts()
        torch.cuda.synchronize()
        curves = sweep(cfg, ebno_dbs=CLI_EBNO_DB, jsonl_path=jsonl)
        torch.cuda.synchronize()
        cli_launches = counts()
        with open(jsonl) as fh:
            rows = [json.loads(line) for line in fh]
    log(f"phase 6: launches during the sweep: {cli_launches}")
    if min(cli_launches["sc_subtree"], cli_launches["scl_subtree"],
           cli_launches["bp"]) == 0:
        raise AssertionError(f"the CLI sweep did not launch every kernel: "
                             f"{cli_launches}")
    names = [gate[0] for gate in CLI_GATES]
    if len(rows) != len(names) * len(CLI_EBNO_DB) or not all(
            np.isfinite(c).all() and ((0 <= c) & (c <= 1)).all()
            for c in curves.ber):
        raise AssertionError(f"the sweep gave {len(rows)} points and curves "
                             f"{curves.ber}")
    point = {}
    for i, row in enumerate(rows):
        name = names[i // len(CLI_EBNO_DB)]
        point[name, row["ebno_db"]] = row
        log(f"  {name} at {row['ebno_db']} dB: BLER "
            f"{row['block_errors'] / row['num_blocks']:.5f} over "
            f"{row['num_blocks']} blocks, {row['runtime_s']:.3f} s, "
            f"{K * row['num_blocks'] / row['runtime_s']:.4g} info bit/s "
            f"[{card}]")
    def gate(name, key, ebno_db, tol, row):
        got_bler = row["block_errors"] / row["num_blocks"]
        want = yardstick(key, ebno_db)
        log(f"{name} BLER {got_bler:.5f} at {ebno_db} dB; yardstick {key} "
            f"{want:.5f} +- {tol}")
        if abs(got_bler - want) > tol:
            raise AssertionError(f"{name} BLER {got_bler} is off the "
                                 f"yardstick {want}")

    for name, key, ebno_db, tol in CLI_GATES:
        gate(f"phase 6: {name}", key, ebno_db, tol, point[name, ebno_db])

    # ---- phase 7: where the time goes ----
    llr = model.front(gen, BATCH, EBNO_MAIN_DB)[2]
    for b in SC_SURVEY_DEPTHS:
        dec_b = PolarSCDecoder(frozen, N, mode=MODE, lower_stages=b,
                               device=dev)
        ms = cuda_ms(lambda: dec_b(llr), reps=5)
        log(f"SC depth survey: decoder at b={b} ({N >> b} x {1 << b} "
            f"leaves): {ms:.3f} ms per batch of {BATCH} [{card}]")
    for b in PLAIN_SURVEY_DEPTHS:
        dec_b = PolarSCLDecoder(frozen, N, list_size=LIST_SIZE, mode=MODE,
                                use_fast_scl=False, lower_stages=b,
                                device=dev)
        ms = cuda_ms(lambda: dec_b(llr), reps=2)
        log(f"plain SCL depth survey: decoder at b={b} ({N >> b} x "
            f"{1 << b} leaves): {ms:.3f} ms per batch of {BATCH} [{card}]")
    for b in SURVEY_DEPTHS:
        dec_b = PolarSCLDecoder(frozen, N, list_size=LIST_SIZE, mode=MODE,
                                use_fast_scl=True, fast_rate1=True,
                                lower_stages=b, device=dev)
        ms = cuda_ms(lambda: dec_b(llr), reps=3)
        log(f"depth survey: decoder at b={b} ({N >> b} x {1 << b} leaves): "
            f"{ms:.3f} ms per batch of {BATCH} [{card}]")
    llr5 = SystemAWGNModel(G5_E, G5_K, enc5, None).front(
        gen, WIDE_BATCH, G5_EBNO_DB)[2]
    for b in WIDE_SURVEY_DEPTHS:
        dec_b = Polar5GDecoder(enc5, dec_type="SCL", list_size=32,
                               mode=G5_MODE, lower_stages=b)
        ms = cuda_ms(lambda: dec_b(llr5), reps=2)
        log(f"CA-SCL-32 depth survey: 5G k={G5_K} E={G5_E} decoder at b={b} "
            f"({enc5.n_polar >> b} x {1 << b} leaves): {ms:.3f} ms per batch "
            f"of {WIDE_BATCH} [{card}]")

    # the SCL kernel: its resources, and its time over one fast decode's
    # calls with the workspace split between shared memory and the global
    # scratch at other points than the budget's
    log(f"phase 7: scl_subtree kernel resources (dynamic shared memory "
        f"per block: {cuda_scl.THREADS} threads, budget "
        f"{cuda_scl.SMEM_BUDGET} B):")
    for line in resource_usage(libs[:1]):
        log(f"  {line}")
    scl_turns = scl_quads_phase(dev, card, parent)
    for b in sorted({TRACED_B, 8, main_b}):
        split_calls = []
        scan_core.scl_sweep_hybrid_fast(
            llr_ch, mask, LIST_SIZE, mode=MODE, llr_max=30.0,
            lower_stages=b, rate1=True,
            subtree=recorder(split_calls, scl_subtree))
        fits = [n for n in range(b + 1)
                if cuda_scl.block_smem_bytes(LIST_SIZE, n) <= SMEM_OPT_IN]
        default = cuda_scl.shared_stages(b, LIST_SIZE)
        for n in sorted({fits[-1], default, max(default - 2, 0), 0},
                        reverse=True):
            ms = cuda_ms(lambda: [scl_subtree(*args, n_shared=n, **kw)
                                  for args, kw in split_calls], reps=2)
            log(f"shared-memory split survey: fast SCL-{LIST_SIZE} at b={b}, "
                f"{len(split_calls)} calls, stages 0..{n - 1} shared "
                f"({cuda_scl.block_smem_bytes(LIST_SIZE, n)} B per block"
                f"{', the default' if n == default else ''}): kernel "
                f"{ms:.3f} ms [{card}]")

    # where a whole-tree L=32 call's time goes: the CA-SCL-32 decode's one
    # call at b=10 as decoded, in min-sum, with every leaf frozen (no fork)
    # and as one rate-0 node (the first descent alone)
    dec10 = Polar5GDecoder(enc5, dec_type="SCL", list_size=32, mode=G5_MODE,
                           lower_stages=10)
    whole_calls = []
    scan_core.scl_sweep_hybrid(
        (-dec10.rate_recover(llr5)).t().contiguous(), mask5, 32,
        mode=G5_MODE, llr_max=30.0, lower_stages=10,
        subtree=recorder(whole_calls, scl_subtree))
    ((a10, pm10, sched10), kw10), = whole_calls
    frozen_leaves = SubtreeSchedule(scan_core.leaf_schedule(
        np.ones(1 << 10, bool)), dev)
    for label, sched, mode in (
            ("as decoded", sched10, G5_MODE), ("as decoded", sched10, MODE),
            ("every leaf frozen", frozen_leaves, G5_MODE),
            ("every leaf frozen", frozen_leaves, MODE),
            ("one rate-0 node", SubtreeSchedule((("z", 10, 0),), dev),
             G5_MODE)):
        ms = cuda_ms(lambda: scl_subtree(a10, pm10, sched,
                                         **dict(kw10, mode=mode)), reps=2)
        log(f"L=32 whole-tree breakdown (5G k={G5_K} E={G5_E}, b=10, "
            f"bs={WIDE_BATCH}): {label}, {mode}: kernel {ms:.3f} ms [{card}]")

    # one BP-20 decode of the CLI's shape, early stop on (the path's
    # setting) and off (fixed work); the sweeps each codeword ran, from the
    # flags at every check budget: a codeword converged within c checks
    # carries the same flag at the budget of c chunks
    llr_bp = bp_model.front(gen, BATCH, BP_EBNO_DB)[2].t()
    every = bp_dec.check_every

    def bp_times_of(msg_dtype):
        """Kernel, plain and bound ms of one BP-20 decode of ``llr_bp``
        with early stop on and off; the work counts this run's sweeps and
        checks, from the flags at every check budget (a codeword converged
        within c checks carries the same flag at the budget of c chunks)."""
        bp_kw = dict(check_every=every, mode=bp_dec.mode, msf=bp_dec.msf,
                     llr_max=30.0, negate=True, msg_dtype=msg_dtype)
        checks = torch.zeros(BATCH, dtype=torch.int64, device=dev)
        for c in range(1, BP_ITER // every + 1):
            _, done_c = bp_decode(llr_bp, bp_prior, num_iter=c * every,
                                  early_stop=True, return_done=True, **bp_kw)
            checks += done_c == 0
        converged = checks < BP_ITER // every
        checks = torch.where(converged, checks + 1, checks)
        sweeps = torch.where(converged, checks * every, BP_ITER)
        times = {}
        for es, n_sweeps, n_checks in (
                (True, int(sweeps.sum().item()), int(checks.sum().item())),
                (False, BP_ITER * BATCH, 0)):
            kw = dict(num_iter=BP_ITER, early_stop=es, **bp_kw)
            k_ms = cuda_ms(lambda: bp_decode(llr_bp, bp_prior, **kw), reps=5)
            p_ms = cuda_ms(lambda: bp_decode_plain(llr_bp, bp_prior, **kw),
                           reps=1)
            n_bytes, n_ops = bp_work(N, BATCH, n_sweeps, n_checks,
                                     bp_dec.mode, bp_dec.msf)
            bnd, by = bound_ms(n_bytes, n_ops)
            times[es] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bnd,
                             bound_by=by)
            log(f"  bp, {str(msg_dtype)[6:]} messages, one BP-{BP_ITER} "
                f"decode (n={N}, bs={BATCH}, {BP_EBNO_DB} dB, early stop "
                f"{es}): kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; "
                f"{n_sweeps / BATCH:.3f} sweeps and {n_checks / BATCH:.3f} "
                f"checks per codeword; bound {bnd:.4f} ms ({by}: {n_bytes} "
                f"B, {n_ops} f32 ops); library: none [{card}]")
        return times

    bp_times = bp_times_of(torch.float32)
    bp16_times = bp_times_of(torch.bfloat16)

    # the redesigned BP and SC kernels: resources, resident blocks per SM,
    # BP's launch plans and SC's time at other launch choices
    log("phase 7: bp and sc_subtree kernel resources:")
    for line in resource_usage(libs[1:3]):
        log(f"  {line}")
    bp_lib, sc_lib = _build.load("bp", "cuda"), _build.load("sc_subtree",
                                                             "cuda")
    for n_bp in (N, 2048, 4096):
        lat = cuda_bp.resolve_lattice(n_bp)
        for msg in (torch.float32, torch.bfloat16):
            threads, syncs, smem = cuda_bp.launch_plan(n_bp, msg_dtype=msg)
            # the scaled min-sum instance, the CLI's
            per_sm = bp_lib.bp_blocks_per_sm(n_bp.bit_length() - 1,
                                             int(lat == "shared"),
                                             int(msg == torch.bfloat16), 0)
            log(f"bp launch plan: n={n_bp}, {lat} lattice, "
                f"{str(msg)[6:]} messages: {threads} threads, {syncs} "
                f"barriers a sweep, {smem} B shared, {per_sm} CTAs per SM")
    for b in sorted({8, 9, 10, sc_b}):
        calls = []
        scan_core.sc_sweep_hybrid(llr_ch, mask, mode=MODE, lower_stages=b,
                                  subtree=recorder(calls, sc_subtree))
        for lanes in cuda_sc.LANES:
            for n_sh in sorted({cuda_sc.shared_stages(b, lanes), b, 0},
                               reverse=True):
                if cuda_sc.block_smem_bytes(b, lanes, n_sh) > SMEM_OPT_IN:
                    continue
                ms = cuda_ms(lambda: [sc_subtree(*args, lanes=lanes,
                                                 n_shared=n_sh, **kw)
                                      for args, kw in calls], reps=5)
                default = (lanes == cuda_sc.DEFAULT_LANES
                           and n_sh == cuda_sc.shared_stages(b, lanes))
                log(f"sc_subtree launch survey: one SC decode ({len(calls)} "
                    f"calls, b={b}, bs={BATCH}), {lanes} lanes, {n_sh} of "
                    f"{b} workspace stages shared "
                    f"({cuda_sc.block_smem_bytes(b, lanes, n_sh)} B a block, "
                    f"{sc_lib.sc_subtree_blocks_per_sm(b, lanes, n_sh)} "
                    f"blocks per SM{', the default' if default else ''}): "
                    f"kernel {ms:.3f} ms [{card}]")
    profile_step(model, gen)

    # ---- phase 8: the 5G NR CA-SCL path ----
    g5_counts = {}
    for name, dec_type, L, bs, batches, key, key_blocks, b in G5_DECODERS:
        dec5 = Polar5GDecoder(enc5, dec_type=dec_type, list_size=L,
                              mode=G5_MODE, lower_stages=b)
        model5 = SystemAWGNModel(G5_E, G5_K, enc5, dec5)
        bits, bits_hat = model5.step(gen, bs, G5_EBNO_DB)    # warm-up
        if bits_hat.shape != (bs, G5_K) or not torch.isin(
                bits_hat, torch.tensor([0.0, 1.0], device=dev)).all():
            raise AssertionError(f"{name}: output of shape {bits_hat.shape} "
                                 "is not a [batch, k] array of bits")
        with tempfile.TemporaryDirectory() as tmp:
            jsonl = os.path.join(tmp, "5g.jsonl")
            reset_counts()
            torch.cuda.synchronize()
            sim_ber(model5, [G5_EBNO_DB], batch_size=bs,
                    max_mc_iter=batches, early_stop=False, verbose=False,
                    seed=SEED, jsonl_path=jsonl)
            torch.cuda.synchronize()
            run = g5_counts[name] = counts()
            with open(jsonl) as fh:
                (row,) = [json.loads(line) for line in fh]
        need = {"scl_subtree": True, "scl_subtree traced": b is not None,
                "scl_subtree wide": L > 8, "sc_subtree": dec_type == "hybSCL"}
        missing = [k for k, v in need.items() if v and run[k] == 0]
        if missing or row["num_blocks"] != bs * batches:
            raise AssertionError(f"{name}: {row['num_blocks']} blocks, "
                                 f"launches {run}; none of {missing}")
        got_bler = row["block_errors"] / row["num_blocks"]
        llr = model5.front(gen, bs, G5_EBNO_DB)[2]
        dec_ms = cuda_ms(lambda: dec5(llr), reps=3)
        if dec_type == "hybSCL":
            log(f"phase 8: {name}: CA-SCL bucket (high-water mark) "
                f"{min(dec5._polar_dec._cap_hwm, bs)} rows of {bs}")
        log(f"phase 8: {name} {dec_type} L={L} {G5_MODE}, 5G k={G5_K} "
            f"E={G5_E}, bs={bs}, b={dec5._polar_dec.lower_stages}: BLER "
            f"{got_bler:.5f} at {G5_EBNO_DB} dB over {row['num_blocks']} "
            f"blocks, {row['runtime_s']:.3f} s, "
            f"{G5_K * row['num_blocks'] / row['runtime_s']:.4g} info bit/s; "
            f"decoder {dec_ms:.3f} ms per batch; launches {run} [{card}]")
        if key is None:
            want = yardstick("5g_cascl8_k400_n1000", G5_EBNO_DB)
            log(f"phase 8: {name} BLER {got_bler:.5f}; must not exceed the "
                f"CA-SCL-8 yardstick {want:.5f}")
            if got_bler > want:
                raise AssertionError(f"{name} BLER {got_bler} is above "
                                     f"{want}")
            continue
        want = yardstick(key, G5_EBNO_DB)
        # about 4 sigma of the two binomial samples combined
        tol = 4.0 * np.sqrt(want * (1.0 - want)
                            * (1.0 / row["num_blocks"] + 1.0 / key_blocks))
        log(f"phase 8: {name} BLER {got_bler:.5f}; yardstick {key} "
            f"{want:.5f} +- {tol:.5f}")
        if abs(got_bler - want) > tol:
            raise AssertionError(f"{name} BLER {got_bler} is off the "
                                 f"yardstick {want}")
    for label, key, calls in (
            ("CA-SCL-8", "CA-SCL-8", g5_calls[8]),
            ("CA-SCL-32", "wide", g5_calls[32]),
            (f"CA-SCL-8 at b={TRACED_B}", "traced", traced_calls[8])):
        t = scl_times[key]
        log(f"phase 8: scl_subtree per {label} decode: {t['ms']:.3f} ms over "
            f"{len(calls)} launches; plain {t['plain_ms']:.3f} ms; "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) [{card}]")

    # ---- phase 9: BP's two-pass serving path ----
    bp_two = PolarBPDecoder(frozen, N, num_iter=BP_ITER, two_pass=True,
                            first_pass_iters=8, device=dev)
    for hard_out in (True, False):
        one = PolarBPDecoder(frozen, N, num_iter=BP_ITER, hard_out=hard_out,
                             device=dev)
        two = PolarBPDecoder(frozen, N, num_iter=BP_ITER, hard_out=hard_out,
                             two_pass=True, first_pass_iters=8, device=dev)
        llr = bp_model.front(gen, BATCH, BP_EBNO_DB)[2]
        same = torch.equal(one(llr), two(llr))
        _, done1 = two._run(llr, two.first_pass_iters, want_done=True)
        log(f"phase 9: two-pass BP-{BP_ITER} (first pass 8 sweeps), "
            f"hard_out {hard_out}, bs={BATCH}, {BP_EBNO_DB} dB: bit-identical "
            f"to single-pass: {same}; {int((~done1).sum().item())} rows "
            f"re-decoded in a bucket of {two._cap_hwm}")
        if not same:
            raise AssertionError("the two-pass BP decoder differs from the "
                                 "single-pass decoder")
    model_two = SystemAWGNModel(N, K, model.encoder, bp_two)
    bp_two.prewarm(BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "bp2.jsonl")
        reset_counts()
        torch.cuda.synchronize()
        sim_ber(model_two, [BP_EBNO_DB], batch_size=BATCH,
                max_mc_iter=CLI_MC_ITER, early_stop=False, verbose=False,
                seed=SEED, jsonl_path=jsonl)
        torch.cuda.synchronize()
        two_counts = counts()
        with open(jsonl) as fh:
            (row,) = [json.loads(line) for line in fh]
    if two_counts["bp"] == 0 or row["num_blocks"] != BATCH * CLI_MC_ITER:
        raise AssertionError(f"two-pass BP: {row['num_blocks']} blocks, "
                             f"launches {two_counts}")
    bp_name, bp_key, bp_ebno, bp_tol = CLI_GATES[-1]
    one_row = point[bp_name, bp_ebno]
    log(f"phase 9: two-pass BP-{BP_ITER}: {row['runtime_s']:.3f} s, "
        f"{K * row['num_blocks'] / row['runtime_s']:.4g} info bit/s "
        f"(single pass in phase 6: "
        f"{K * one_row['num_blocks'] / one_row['runtime_s']:.4g}); "
        f"bucket {bp_two._cap_hwm} rows; launches {two_counts} [{card}]")
    gate(f"phase 9: two-pass {bp_name}", bp_key, bp_ebno, bp_tol, row)

    # bf16 messages: the two-pass path bit-identical to one pass, then
    # BP-20 through sim_ber as phase 6 runs it
    bf16 = dict(num_iter=BP_ITER, msg_dtype=torch.bfloat16, device=dev)
    one = PolarBPDecoder(frozen, N, hard_out=False, **bf16)
    two = PolarBPDecoder(frozen, N, hard_out=False, two_pass=True,
                         first_pass_iters=8, **bf16)
    llr = bp_model.front(gen, BATCH, BP_EBNO_DB)[2]
    same = torch.equal(one(llr), two(llr))
    log(f"phase 9: two-pass BP-{BP_ITER}, bf16 messages, soft outputs, "
        f"bs={BATCH}: bit-identical to single-pass: {same}")
    if not same:
        raise AssertionError("the two-pass bf16 BP decoder differs from the "
                             "single-pass decoder")
    model16 = SystemAWGNModel(N, K, model.encoder, PolarBPDecoder(
        frozen, N, **bf16))
    model16.step(gen, BATCH, BP_EBNO_DB)                        # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "bp16.jsonl")
        reset_counts()
        torch.cuda.synchronize()
        sim_ber(model16, [BP_EBNO_DB], batch_size=BATCH,
                max_mc_iter=CLI_MC_ITER, early_stop=False, verbose=False,
                seed=SEED, jsonl_path=jsonl)
        torch.cuda.synchronize()
        bf16_counts = counts()
        with open(jsonl) as fh:
            (row,) = [json.loads(line) for line in fh]
    if bf16_counts["bp bf16"] == 0 or bf16_counts["bp bf16"] != \
            bf16_counts["bp"] or row["num_blocks"] != BATCH * CLI_MC_ITER:
        raise AssertionError(f"bf16 BP: {row['num_blocks']} blocks, "
                             f"launches {bf16_counts}")
    log(f"phase 9: BP-{BP_ITER}, bf16 messages, k={K} n={N} 5G, "
        f"bs={BATCH}: {row['runtime_s']:.3f} s, "
        f"{K * row['num_blocks'] / row['runtime_s']:.4g} info bit/s; "
        f"launches {bf16_counts} [{card}]")
    binomial_gate(f"phase 9: BP-{BP_ITER} bf16 at {BP_EBNO_DB} dB",
                  row["block_errors"], row["num_blocks"], BP_BF16_YARDSTICK)
    gate(f"phase 9: BP-{BP_ITER} bf16", bp_key, bp_ebno, bp_tol, row)

    # ---- phases 10 and 11: the --kern CLI path, the BEC link and GA ----
    kern_phase(dev, gen, card, reset_counts, counts)
    bec_link_phase(dev, gen, card, model.encoder, frozen, reset_counts,
                   counts)

    # ---- phases 12 and 13: the 5G uplink UCI chain and the tools ----
    def kernel_times(kern, calls, label):
        if kern == "scl_subtree":
            return subtree_times(calls, label, reps=3)
        return sc_times(calls, label)

    pc_launches, pc_time, uci_model = uci_phase(dev, gen, card, reset_counts,
                                                counts, kernel_times)
    tools_phase(dev, card, uci_model, reset_counts, counts)

    # ---- phase 14: the entry points, each in its own process ----
    bench_row = entry_points_phase(card, info_bps)

    # ---- phase 15: the probe kernels ----
    probe_entries = probes_phase(dev, card)

    # ---- phase 16: the SCL sweep's closing transform ----
    butterfly_entry = butterfly_phase(dev, card,
                                      main_counts["butterfly_rows"])

    # ---- phase 17: the QPSK transmitter ----
    qpsk_front_entry = qpsk_front_phase(dev, card, main_counts["qpsk_front"])

    def entry(name, source, replaces, launches, c, times, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=c.max_abs, mismatch_blocks=c.n_bad,
                    checked_blocks=c.n_blocks, **extra, **times,
                    library_ms=None)

    def pc_fields(kern, c):
        """The PC path's launches (phase 12), checks (phase 3) and times
        per (19, 864) decode."""
        return dict(pc_launches=pc_launches[kern],
                    pc_checked_blocks=c.n_blocks, pc_mismatch_blocks=c.n_bad,
                    pc_max_abs_err=c.max_abs,
                    **{f"pc_{k}": v for k, v in pc_time[kern].items()})

    scl_src, pallas = ("polar_torch/csrc/scl_subtree.cu",
                       "polar_tpu/models/polar/pallas_scl.py")
    g5_total = {k: sum(run[k] for run in g5_counts.values())
                for k in ("scl_subtree traced", "scl_subtree wide")}
    kernels = [
        entry("scl_subtree", scl_src, f"{pallas}:142", launches, check,
              scl_times["static"], bec_checked_blocks=scl_bec,
              parent_turns_ms=scl_turns,
              **pc_fields("scl_subtree", pc_scl_check)),
        entry("scl_subtree L=16/32", scl_src, f"{pallas}:515",
              g5_total["scl_subtree wide"], check_wide, scl_times["wide"]),
        entry("scl_subtree traced", scl_src, f"{pallas}:407",
              g5_total["scl_subtree traced"], check_traced,
              scl_times["traced"]),
        entry("sc_subtree", "polar_torch/csrc/sc_subtree.cu",
              f"{pallas}:832", cli_launches["sc_subtree"], sc_check,
              sc_time, bec_checked_blocks=sc_bec,
              **pc_fields("sc_subtree", pc_sc_check)),
        entry("bp", "polar_torch/csrc/bp.cu",
              "polar_tpu/models/polar/pallas_bp.py:57", cli_launches["bp"],
              bp_check, dict(bp_times[True], **{
                  f"{k}_no_early_stop": v
                  for k, v in bp_times[False].items()})),
        entry("bp_bf16", "polar_torch/csrc/bp.cu",
              "polar_tpu/models/polar/pallas_bp.py:57",
              bf16_counts["bp bf16"], bp16_check, dict(bp16_times[True], **{
                  f"{k}_no_early_stop": v
                  for k, v in bp16_times[False].items()}),
              msg_dtype="bfloat16"),
        butterfly_entry,
        qpsk_front_entry,
        *probe_entries,
    ]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}; main path {info_bps:.6g} info bit/s, "
          f"{step_s * 1e3:.3f} ms per step; python -m polar_torch.bench "
          f"{bench_row['value']:.6g} info bit/s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
