"""Iterative belief-propagation (BP) polar decoder.

Arikan's BP over the encoding factor graph: every sweep updates the whole
``[S+1, n]`` message lattice, right-to-left then left-to-right
(``cuda_bp.py`` has the update and the rounding rules). Frozen positions
carry a ``+llr_max`` prior on the info side.

* **Scaled min-sum** (``msf``, default 0.9375): raw min-sum BP diverges at
  large block lengths; the normalized form lands in SC's class.
* **G-matrix early stop** (``early_stop``, default True): every
  ``check_every`` sweeps each block re-encodes its info-side hard decision
  and compares it with the channel-side one; a block that passes stops (BP
  can oscillate out of a codeword).
* **bf16 messages** (``msg_dtype=torch.bfloat16``): the lattice in bf16,
  every op rounded to bf16 on its own, as the JAX package's bf16 XLA
  engine runs (bit-equal in min-sum); the LLRs in and out stay f32.
* **Two-pass serving** (``two_pass``): a first pass of
  ``first_pass_iters`` sweeps accepts the converged blocks, and only the
  failures are re-decoded at the full budget, gathered into power-of-two
  capacity buckets held at a high-water mark, then scattered back. Every
  block decodes on its own and the re-decode replays the same sweeps, so
  the output is bit-identical to the single-pass decoder.

Inputs are logits (``llr > 0`` means bit 1). On the card the whole decode
is one launch of ``csrc/bp.cu`` per call; on the CPU it runs the plain
version.
"""

import numpy as np
import torch

from polar_torch._device import resolve_device
from polar_torch.models.polar.construction import (as_host_positions,
                                                    info_positions)
from polar_torch.models.polar.cuda_bp import bp_decode, msg_is_bf16
from polar_torch.ops.fg import F_FUNCTIONS


class PolarBPDecoder:
    """BP decoder. ``__call__(llr_logits[..., n]) -> u_hat[..., k]`` (hard
    decisions; ``hard_out=False`` returns info-side soft logits)."""

    def __init__(self, frozen_pos, n: int, num_iter: int = 20,
                 mode: str = "minsum", hard_out: bool = True,
                 llr_max: float = 30.0, msf: float = 0.9375,
                 early_stop: bool = True, check_every: int = 2,
                 output_dtype=torch.float32, two_pass: bool = False,
                 first_pass_iters: int = 8, min_capacity: int = 128,
                 msg_dtype=torch.float32, device=None):
        n = int(n)
        if n < 2 or n & (n - 1):
            raise ValueError("n must be a power of 2, at least 2")
        if int(num_iter) < 1:
            raise ValueError("num_iter must be at least 1")
        if mode not in F_FUNCTIONS:
            raise ValueError(f"unknown mode {mode!r}")
        msg_is_bf16(msg_dtype)          # f32 or bf16, else ValueError
        if two_pass and not early_stop:
            raise ValueError("two_pass needs early_stop")
        self.n = n
        self.device = resolve_device(device)
        self.frozen_pos = as_host_positions(frozen_pos)
        self.k = n - len(self.frozen_pos)
        self.info_pos = info_positions(self.frozen_pos, n)
        self.num_iter = int(num_iter)
        self.mode = mode
        self.hard_out = bool(hard_out)
        self.llr_max = float(llr_max)
        self.msf = float(msf)
        self.early_stop = bool(early_stop)
        self.check_every = max(1, int(check_every))
        self.output_dtype = output_dtype
        self.msg_dtype = msg_dtype
        self.two_pass = bool(two_pass)
        self.first_pass_iters = min(int(first_pass_iters), self.num_iter)
        self.min_capacity = int(min_capacity)
        # the capacity's high-water mark: later batches reuse the largest
        # bucket seen, as the JAX package does to keep one compiled shape
        self._cap_hwm = self.min_capacity
        prior = np.zeros(n, dtype=np.float32)
        prior[self.frozen_pos] = self.llr_max   # true LLR: positive -> bit 0
        self._prior = torch.from_numpy(prior).to(self.device)
        self._info_idx = torch.from_numpy(self.info_pos).to(self.device)

    def _run(self, llr_logits, num_iter: int, want_done: bool = False):
        """Decode [bs, n] logits at a given sweep budget: ``(out [bs, k],
        done [bs] bool)``, ``done`` None unless ``want_done`` (which needs
        early_stop)."""
        res = bp_decode(llr_logits.to(torch.float32).t(), self._prior,
                        num_iter=num_iter, check_every=self.check_every,
                        early_stop=self.early_stop, mode=self.mode,
                        msf=self.msf, llr_max=self.llr_max,
                        return_done=want_done, negate=True,
                        msg_dtype=self.msg_dtype)
        if want_done:
            return self._finish(res[0]), res[1] > 0
        return self._finish(res), None

    def _finish(self, u_llr):
        """Info-side total LLR [n, bs] -> decoder output [bs, k]."""
        u_info = u_llr.t()[:, self._info_idx]
        if self.hard_out:
            return (u_info <= 0).to(self.output_dtype)
        return (-u_info).to(self.output_dtype)     # back to logits

    def decode(self, llr_logits):
        """[bs, n] logits -> [bs, k] at the full budget, single pass."""
        return self._run(llr_logits, self.num_iter)[0]

    def __call__(self, inputs):
        if inputs.shape[-1] != self.n or inputs.dim() < 2:
            raise ValueError(f"inputs must be [..., n={self.n}]")
        if inputs.device != self.device:
            raise ValueError(f"inputs on {inputs.device}, decoder on "
                             f"{self.device}")
        lead = inputs.shape[:-1]
        llr2d = inputs.reshape(-1, self.n)
        if self.two_pass:
            out = self.decode_pipelined([llr2d])[0]
        else:
            out = self.decode(llr2d)
        return out.reshape(lead + (self.k,))

    # ------------------------------------------------------------------
    # two-pass serving path
    # ------------------------------------------------------------------
    def _capacity(self, n_fail: int, bucket: int) -> int:
        cap = self.min_capacity
        while cap < n_fail:
            cap *= 2
        cap = min(max(cap, self._cap_hwm), bucket)
        self._cap_hwm = max(self._cap_hwm, cap)
        return cap

    def prewarm(self, bs: int, scl_capacity: int = None):
        """Build and load the kernel with one first pass of ``bs`` blocks
        and one full-budget decode at the capacity bucket, and raise the
        bucket's high-water mark to ``scl_capacity``."""
        if not self.two_pass:
            raise ValueError("prewarm is the two-pass path")
        if scl_capacity:
            self._cap_hwm = max(self._cap_hwm, int(scl_capacity))
        zeros = torch.zeros((max(bs, self._cap_hwm), self.n),
                            device=self.device)
        self._run(zeros[:bs], self.first_pass_iters, want_done=True)
        self._run(zeros[:self._cap_hwm], self.num_iter)

    def decode_pipelined(self, llr_batches, scl_batch: int = 8192):
        """Decode many ``[bs_i, n]`` batches with one host sync: the first
        pass runs on every batch, all accept masks cross to the host
        together, and the failing rows of all batches are re-decoded at the
        full budget in calls of at most ``scl_batch`` rows (the last padded
        to its bucket with copies of its first row). Bit-identical to
        per-batch ``decode``; returns a list of ``[bs_i, k]`` tensors."""
        if not self.two_pass:
            raise ValueError("decode_pipelined is the two-pass path")
        llr_batches = [x.reshape(-1, self.n) for x in llr_batches]
        sizes = [x.shape[0] for x in llr_batches]
        p1 = [self._run(x, self.first_pass_iters, want_done=True)
              for x in llr_batches]
        u_all = torch.cat([u for u, _ in p1])
        done = torch.cat([d for _, d in p1])
        fail = np.flatnonzero(~done.cpu().numpy())    # the one host sync
        if fail.size:
            llr_all = torch.cat(llr_batches)
            for lo in range(0, int(fail.size), scl_batch):
                chunk = fail[lo:lo + scl_batch]
                cap = self._capacity(int(chunk.size), scl_batch)
                idx = np.full(cap, chunk[0], dtype=np.int64)
                idx[:chunk.size] = chunk
                idx = torch.from_numpy(idx).to(self.device)
                u2, _ = self._run(llr_all[idx], self.num_iter)
                u_all[idx[:chunk.size]] = u2[:chunk.size]
        return list(u_all.split(sizes))
