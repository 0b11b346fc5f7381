"""The BP decode: its hand-written CUDA kernel, the same schedule's host
build, and its plain PyTorch version.

One call runs the whole belief-propagation decode of every codeword of the
batch: given the true channel LLRs ``llr`` [n, bs] f32 (positive means bit
0; with ``negate=True`` the caller's logits, negated on load) and the
frozen prior ``prior`` [n] f32 (+llr_max at frozen positions, 0
elsewhere), it runs ``num_iter`` sweeps of scaled min-sum (``msf``) or
exact processing-element updates over the message lattice and returns the
info-side total LLR [n, bs] f32, and with ``return_done`` the G-matrix
convergence flag [bs] int32. With ``early_stop`` a codeword stops at the
first of its checks (every ``check_every`` sweeps) that passes.

* ``bp_decode`` is the wrapper the decoder calls. A CUDA tensor goes
  through the kernel (``csrc/bp.cu``), a CPU tensor through the plain
  version; nothing falls back from one to the other. It runs in the span
  ``kernel.bp``, counts its launches in the tracing counter ``launch.bp``
  (the bf16 instance's also in ``form.bp.bf16``) and reports each launch's
  work to a running ``profiling.flop_estimate``.
* ``bp_decode_plain`` mirrors the JAX package's XLA engine
  (``PolarBPDecoder._run``): whole-batch tensor ops, a converged lane frozen
  by a select, the loop left when every lane has converged.
* ``bp_decode_host`` runs the kernel's schedule built for the CPU with g++,
  one thread running the CTA's lanes in turn, so the tests can check the
  CUDA source's logic.

The kernel runs one CTA per codeword. Stages 0..4 exchange inside a warp
(shuffles, no CTA barrier) and keep their messages in registers; stages
5..S sit in shared memory up to n = 2048 and run one at a time between
barriers (``launch_plan``: 49,408 B at n = 1024); from n = 4096 the
lattice sits in a global scratch (``csrc/bp.cuh`` explains the schedule).

In scaled min-sum the ``l_v``/``r_v`` outputs round ``msf * minsum + v``
once, as XLA fuses them on the CPU (``ops/fg.scaled_minsum_add`` here,
``fmaf`` in the kernel), so min-sum is bit-equal to the JAX package. Exact
mode rounds differently in ``expf``/``log1pf`` and ``torch.logaddexp``.

``msg_dtype=torch.bfloat16`` holds the lattice in bf16 (the kernel's own
template instances, 16-bit messages in shared memory and the scratch). Its
contract is the JAX package's bf16 XLA engine: every op rounds to bf16 on
its own (no fused multiply-add; ``jnp.logaddexp``'s formula in exact
mode), the channel LLRs, the prior, ``msf`` and ``llr_max`` are rounded on
load, and the check and the output read the rounded sums. The LLRs in and
out stay f32. Min-sum is bit-equal to JAX; exact mode again differs only
where ``expf``/``log1pf`` round differently before the bf16 rounding.
"""

import ctypes
import functools

import torch

from polar_torch import _build
from polar_torch.ops.fg import (F_FUNCTIONS, f_exact, f_exact_per_op,
                                make_scaled_minsum, scaled_minsum_add,
                                scaled_minsum_per_op)
from polar_torch.utils import kernel_work, tracing

MAX_S = 16
MAX_SHARED_S = 11           # kBpMaxSharedS in csrc/bp.cuh
LATTICES = ("auto", "shared", "global")
MSG_DTYPES = (torch.float32, torch.bfloat16)


def resolve_lattice(n: int, lattice: str = "auto") -> str:
    """Where the kernel keeps the lattice: ``"shared"`` up to n = 2048,
    else ``"global"``; a forced ``"shared"`` beyond it raises."""
    if lattice not in LATTICES:
        raise ValueError(f"lattice must be one of {LATTICES}")
    fits = n.bit_length() - 1 <= MAX_SHARED_S
    if lattice == "shared" and not fits:
        raise ValueError(f"the lattice of n={n} does not fit shared memory")
    if lattice == "auto":
        return "shared" if fits else "global"
    return lattice


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
def bp_decode(llr, prior, *, num_iter: int, check_every: int,
              early_stop: bool, mode: str, msf: float, llr_max: float,
              return_done: bool = False, negate: bool = False,
              lattice: str = "auto", msg_dtype=torch.float32):
    """Decode; see the module docstring. CUDA tensors launch the kernel
    (``lattice`` forces its lattice into shared or global memory; the
    ``msg_dtype`` instance), CPU tensors run ``bp_decode_plain``."""
    kw = dict(num_iter=num_iter, check_every=check_every,
              early_stop=early_stop, mode=mode, msf=msf, llr_max=llr_max,
              return_done=return_done, negate=negate, msg_dtype=msg_dtype)
    with tracing.span("kernel.bp"):
        if llr.device.type == "cpu":
            resolve_lattice(llr.shape[0], lattice)
            return bp_decode_plain(llr, prior, **kw)
        if llr.device.type != "cuda":
            raise ValueError(f"bp_decode: unsupported device {llr.device}")
        lib = _build.load("bp", "cuda")
        with torch.cuda.device(llr.device):
            stream = torch.cuda.current_stream(llr.device).cuda_stream
            res = _native_call(lib.bp_launch, llr, prior, lattice,
                               (ctypes.c_void_p, stream), **kw)
            launched = int(llr.shape[1] > 0)        # an empty batch: none
            tracing.count("launch.bp", launched, ops=1)
            tracing.count("form.bp.bf16",
                          launched * (msg_dtype == torch.bfloat16))
        # an estimate counts every sweep and check: early stop is data that
        # it cannot read without a sync; the bf16 lattice does the same work
        n, bs = llr.shape
        kernel_work.report(kernel_work.bp_work, n, bs, num_iter * bs,
                           (num_iter // check_every) * bs if early_stop
                           else 0, mode, msf)
        return res


def bp_decode_host(llr, prior, *, lattice: str = "auto",
                   warp_blocks: int = 0, **kw):
    """The kernel's schedule built for the CPU (g++), with the card's launch
    plan, or with ``warp_blocks`` (1 or 2) resident blocks per warp in the
    shared form, so that tests reach the two-block form (the card's at
    n = 2048) at small n; CPU tensors only. The main path never calls it."""
    if llr.device.type != "cpu":
        raise ValueError("bp_decode_host takes CPU tensors")
    if int(warp_blocks) not in (0, 1, 2):
        raise ValueError("warp_blocks must be 0 (the card's plan), 1 or 2")
    return _native_call(_build.load("bp", "host").bp_host, llr, prior,
                        lattice, (ctypes.c_int, int(warp_blocks)), **kw)


def launch_plan(n: int, lattice: str = "auto", msg_dtype=torch.float32):
    """(threads per CTA, resident blocks per warp, dynamic shared memory
    bytes) of the kernel's launch at block length ``n`` with ``msg_dtype``
    messages (from the host build, which shares the plan's code with the
    kernel)."""
    fn = _build.load("bp", "host").bp_plan_of
    fn.restype = None
    out = (ctypes.c_int * 3)()
    fn(ctypes.c_int(n.bit_length() - 1),
       ctypes.c_int(int(resolve_lattice(n, lattice) == "shared")),
       ctypes.c_int(int(msg_is_bf16(msg_dtype))), out)
    return tuple(out)


def bf16_round_host(x):
    """``x`` (f32, CPU) rounded to bf16 by the kernel's own rounding
    (``csrc/fg.cuh`` ``bf16_round``, g++ build), as f32; for the tests."""
    x = x.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    fn = _build.load("bp", "host").bp_bf16_round
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
    fn.restype = None
    fn(x.data_ptr(), out.data_ptr(), x.numel())
    return out


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
             + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_float,
                                     ctypes.c_int])


def msg_is_bf16(msg_dtype) -> bool:
    """True for a bf16 lattice, False for f32; any other message type
    raises."""
    if msg_dtype not in MSG_DTYPES:
        raise ValueError(f"msg_dtype must be torch.float32 or "
                         f"torch.bfloat16, not {msg_dtype}")
    return msg_dtype == torch.bfloat16


def _check(llr, prior, num_iter, check_every, early_stop, mode, return_done,
           msg_dtype):
    msg_is_bf16(msg_dtype)
    if llr.dim() != 2 or llr.dtype != torch.float32:
        raise TypeError("bp_decode takes f32 LLRs of shape [n, bs]")
    n, _ = llr.shape
    if n < 2 or n & (n - 1) or n > 1 << MAX_S:
        raise ValueError(f"n={n} must be a power of 2 in [2, 2^{MAX_S}]")
    if (prior.dtype != torch.float32 or tuple(prior.shape) != (n,)
            or prior.device != llr.device):
        raise ValueError(f"prior must be an f32 [{n}] tensor on {llr.device}")
    if mode not in F_FUNCTIONS:
        raise ValueError(f"unknown mode {mode!r}")
    if int(num_iter) < 1 or int(check_every) < 1:
        raise ValueError("num_iter and check_every must be at least 1")
    if return_done and not early_stop:
        raise ValueError("return_done needs early_stop")


def _native_call(fn, llr, prior, lattice, last, *, num_iter, check_every,
                 early_stop, mode, msf, llr_max, return_done=False,
                 negate=False, msg_dtype=torch.float32):
    """Call ``bp_launch`` or ``bp_host``; ``last`` is the (ctypes type,
    value) of the entry point's last argument: the stream, or the host's
    ``warp_blocks``."""
    _check(llr, prior, num_iter, check_every, early_stop, mode, return_done,
           msg_dtype)
    n, bs = llr.shape
    where = resolve_lattice(n, lattice)
    dev = llr.device
    # [n, bs] over [bs, n] storage: a codeword's rows are contiguous, so a
    # block's loads and stores coalesce
    out = torch.empty((bs, n), dtype=torch.float32, device=dev).t()
    done = (torch.empty(bs, dtype=torch.int32, device=dev) if return_done
            else None)
    if bs == 0:
        return (out, done) if return_done else out
    prior = prior.contiguous()
    scratch = None
    if where == "global":
        scratch = torch.empty(bs * 2 * n.bit_length() * n,
                              dtype=msg_dtype, device=dev)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + [last[0]]
        fn.restype = ctypes.c_int
    args = [llr.data_ptr(), llr.stride(0), llr.stride(1), prior.data_ptr(),
            out.data_ptr(), out.stride(0), out.stride(1),
            None if done is None else done.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n.bit_length() - 1, bs, int(num_iter), int(check_every),
            int(bool(early_stop)), int(F_FUNCTIONS[mode] is f_exact),
            int(bool(negate)), float(msf), float(llr_max),
            int(msg_is_bf16(msg_dtype)), last[1]]
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"bp_decode: native call failed with code {rc}")
    return (out, done) if return_done else out


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------
def _pairs(x, s):
    """[n, bs] -> the (upper, lower) halves of the stage-s butterflies,
    views [n / 2^(s+1), 2^s, bs]."""
    n, bs = x.shape
    blk = x.view(n >> (s + 1), 2, 1 << s, bs)
    return blk[:, 0], blk[:, 1]


def bp_decode_plain(llr, prior, *, num_iter: int, check_every: int,
                    early_stop: bool, mode: str, msf: float, llr_max: float,
                    return_done: bool = False, negate: bool = False,
                    msg_dtype=torch.float32):
    """Plain PyTorch BP decode on any device, the JAX package's XLA engine
    step for step, its lattice in ``msg_dtype``; same contract as
    ``bp_decode``."""
    _check(llr, prior, num_iter, check_every, early_stop, mode, return_done,
           msg_dtype)
    n, bs = llr.shape
    S = n.bit_length() - 1
    dev = llr.device
    if msg_dtype == torch.bfloat16:
        # one rounding per op, in bf16
        f = (f_exact_per_op if F_FUNCTIONS[mode] is f_exact
             else functools.partial(scaled_minsum_per_op, msf))

        def f_add(x, y, z):
            return f(x, y, llr_max) + z
    elif mode in ("minsum", "max") and float(msf) != 1.0:
        f = make_scaled_minsum(msf)

        def f_add(x, y, z):
            return scaled_minsum_add(msf, x, y, z, llr_max)
    else:
        f = F_FUNCTIONS[mode]

        def f_add(x, y, z):
            return f(x, y, llr_max) + z

    # the copies round the LLRs and the prior to msg_dtype
    lmsg = torch.zeros((S + 1, n, bs), dtype=msg_dtype, device=dev)
    rmsg = torch.zeros_like(lmsg)
    lmsg[S] = -llr if negate else llr
    rmsg[0] = prior[:, None]

    def sweep_(lm, rm):
        """One sweep, in place: l at stages S-1..0, then r at 0..S-1."""
        for left, stages in ((True, range(S - 1, -1, -1)),
                             (False, range(S))):
            for s in stages:
                lu, lv = _pairs(lm[s + 1], s)
                ru, rv = _pairs(rm[s], s)
                du, dv = _pairs(lm[s] if left else rm[s + 1], s)
                a, b, c = (lu, ru, lv) if left else (ru, lu, rv)
                du.copy_(f(a, lv + rv, llr_max))
                dv.copy_(f_add(a, b, c))

    frozen = prior > 0

    def converged(lm, rm):
        u = torch.where(frozen[:, None], 0, (lm[0] + rm[0] <= 0).to(
            torch.int32))
        x_hat = (lm[S] + rm[S] <= 0).to(torch.int32)
        for s in range(S):
            cu, cv = _pairs(u, s)
            u = torch.stack([cu ^ cv, cv], dim=1).reshape(n, bs)
        return (u == x_hat).all(dim=0)

    def frozen_sweeps(lm, rm, done, sweeps):
        """``sweeps`` sweeps; a converged lane keeps its lattice."""
        l_new, r_new = lm.clone(), rm.clone()
        for _ in range(sweeps):
            sweep_(l_new, r_new)
        keep = done[None, None, :]
        return torch.where(keep, lm, l_new), torch.where(keep, rm, r_new)

    done = torch.zeros(bs, dtype=torch.bool, device=dev)
    if early_stop:
        # full chunks while a lane is left, then the unchecked remainder
        full = (num_iter // check_every) * check_every
        i = 0
        while i < full and not bool(done.all()):
            lmsg, rmsg = frozen_sweeps(lmsg, rmsg, done, check_every)
            done = done | converged(lmsg, rmsg)
            i += check_every
        if num_iter > full:
            lmsg, rmsg = frozen_sweeps(lmsg, rmsg, done, num_iter - full)
    else:
        for _ in range(num_iter):
            sweep_(lmsg, rmsg)
    out = (lmsg[0] + rmsg[0]).to(torch.float32)
    return (out, done.to(torch.int32)) if return_done else out
