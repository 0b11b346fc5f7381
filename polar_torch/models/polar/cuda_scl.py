"""The fast-SCL subtree: its hand-written CUDA kernel, the same routine's
host build, and its plain PyTorch version.

One call decodes one 2^b-leaf subtree of the fast-SCL sweep
(``scan_core.scl_sweep_hybrid_fast``) for every codeword of the batch:
given the stage-b LLRs ``a`` [2^b, L, bs] f32, the path metrics ``pm``
[L, bs] f32 and the subtree's op schedule, it returns the per-path codeword
``cw`` [2^b, L, bs] int32, the parent map ``P`` [L, bs] int32 (output path
-> input path) and the new path metrics. L is 1, 2, 4, 8, 16 or 32.

The schedule comes in two forms:

* static: ``'z'`` rate-0, ``'r'`` repetition, ``'o'`` rate-1, ``'s'`` SPC
  and ``'f'``/``'i'``/``'p'`` frozen/info/parity-check leaf ops, which fix
  the frozen set;
* traced (``traced_schedule``): one ``'t'`` leaf per leaf, whose frozen
  flag is read at run time from ``frz`` [2^b] int32. One schedule then
  serves every subtree of a sweep. The kernel branches on the flag (it is
  the same for the whole launch), so a frozen ``'t'`` leaf pays only its
  path-metric update; the plain version computes the fork and selects, as
  the JAX package's branchless form does. Both equal the static form.

* ``scl_subtree`` is the wrapper the sweep calls. A CUDA tensor goes through
  the kernel (``csrc/scl_subtree.cu``), a CPU tensor through the plain
  version; nothing falls back from one to the other. It runs in the span
  ``kernel.scl_subtree``, counts its launches in the tracing counter
  ``launch.scl_subtree`` (two device operations each: the decode and the
  codeword transpose), and of those the traced ones in
  ``form.scl_subtree.traced`` and those at L > 8 in
  ``form.scl_subtree.wide``, and reports each launch's work to a running
  ``profiling.flop_estimate``.
* The kernel gives each codeword a group of L threads of one warp, one
  thread per path, and a block of ``THREADS`` threads holds THREADS / L
  codewords. A thread keeps its path's metric and its slot of every
  stage's path pointer in registers and computes its own path's f/g rows,
  reading through those pointers, so forks copy no workspace rows. The
  workspaces sit in shared memory as far as ``SMEM_BUDGET`` bytes a block
  allow (``shared_stages``: stages from 0 up); the wrapper allocates a
  global scratch for the stages above. A fork is top-L by rank: each
  thread counts, for its two candidates, the candidates with a smaller
  metric or an equal one and a lower index, and takes the survivor in its
  slot with its parent's state.
* ``scl_subtree_plain`` repeats the computation with whole-buffer gathers:
  a fork physically re-orders the workspaces. The kernel instead composes
  per-stage path pointers lazily, pruned by ``_lptr_live`` / ``_uptr_live``;
  both give the same result. Node sums run row by row per path in the
  kernel's order, so the two round path metrics alike wherever their
  softplus agrees.
* ``scl_subtree_host`` runs the kernel's per-codeword routine built for the
  CPU with g++ (one thread runs a codeword's L lanes in turn), so the tests
  can check the CUDA source's logic, with any split of the stages between
  shared memory and the global scratch.

PC leaves (``'p'``, 5G's parity-check bits, TS 38.212 5.3.1.2) need the
whole tree in one call. Each path carries a 5-bit PC register: after the
register's rotations at leaf i, the JAX package's ``y[0]`` is bit
``(i + 1) mod 5`` of an unrotated word, so an info leaf i XORs its bit into
that bit and a PC leaf i decides it, paying ``softplus(-/+ clip(llr))``
with no fork. A fork hands each survivor its parent's register before the
survivor's own bit goes in.

Top-L of the 2L candidates keeps equal path metrics in candidate order
(lower index first), and the rate-1/SPC reliability order keeps equal
magnitudes in row order. Path metrics may differ from the JAX package's by
a few ulp (softplus and sum order), never the min-sum f/g values.
"""

import ctypes
import functools

import torch

from polar_torch import _build
from polar_torch.ops.fg import (F_FUNCTIONS, _clip, f_exact, g as g_op,
                                softplus)
from polar_torch.utils import kernel_work, tracing

KIND_CODES = {"z": 0, "r": 1, "o": 2, "s": 3, "f": 4, "i": 5, "t": 6,
              "p": 7}
PC_REGISTER = 5     # length of the PC shift register (TS 38.212 5.3.1.2)
MAX_B = 12          # kMaxB in csrc/scl_subtree.cuh
LIST_SIZES = (1, 2, 4, 8, 16, 32)


def traced_schedule(b: int):
    """The traced form's ops: one ``'t'`` leaf per leaf of the subtree."""
    return tuple(("t", 0, i) for i in range(1 << b))


def _ctz(i: int) -> int:
    return (i & -i).bit_length() - 1


def _cto(i: int) -> int:
    c = 0
    while i & 1:
        c += 1
        i >>= 1
    return c


def _lptr_live(s: int, i_end: int) -> bool:
    """LLR stage ``s`` still has a pending g-read after the fork of a node
    ending at leaf ``i_end`` iff bit_{s-1}(i_end) == 0 (stage 0 never)."""
    return s >= 1 and ((i_end >> (s - 1)) & 1) == 0


def _uptr_live(s: int, i_end: int, s_node: int = 0) -> bool:
    """Partial-sum stage ``s`` still has a pending combine after the fork of
    a node at stage ``s_node`` ending at leaf ``i_end`` iff bit_s(i_end) == 1
    and the stage is at or above the node's root."""
    return s >= s_node and ((i_end >> s) & 1) == 1


class SubtreeSchedule:
    """One subtree's op list: ``ops`` for the plain version and ``table``,
    its int32 [n_ops, 3] encoding (kind, stage, lo) on ``device``; ``codes``
    maps the kinds a kernel takes to their codes. ``span`` is the number of
    leaves the ops cover, which the wrappers hold against 2^b; ``traced``
    says whether any op reads the run-time frozen flags (``'t'``), ``pc``
    whether any is a PC leaf (``'p'``)."""

    def __init__(self, ops, device, codes=KIND_CODES):
        self.ops = tuple((str(k), int(s), int(lo)) for k, s, lo in ops)
        bad = sorted({k for k, _, _ in self.ops} - set(codes))
        if bad:
            raise ValueError(f"op kinds {bad} not in {sorted(codes)}")
        self.span = max((lo + (1 << s) for _, s, lo in self.ops), default=0)
        self.traced = any(k == "t" for k, _, _ in self.ops)
        self.pc = any(k == "p" for k, _, _ in self.ops)
        self.table = torch.tensor(
            [[codes[k], s, lo] for k, s, lo in self.ops],
            dtype=torch.int32, device=device).reshape(-1, 3)


# ----------------------------------------------------------------------
# the wrapper
# ----------------------------------------------------------------------
def scl_subtree(a, pm, sched: SubtreeSchedule, *, b: int, llr_max: float,
                mode: str, frz=None, n_shared=None):
    """Decode one subtree; see the module docstring. ``frz`` is None
    unless the schedule has ``'t'`` ops. CUDA tensors launch the kernel,
    CPU tensors run ``scl_subtree_plain``. ``n_shared`` is the number of
    workspace stages the kernel keeps in shared memory (by default
    ``shared_stages(b, L)``); the plain version has no such split."""
    with tracing.span("kernel.scl_subtree"):
        if a.device.type == "cpu":
            return scl_subtree_plain(a, pm, sched.ops, b=b, llr_max=llr_max,
                                     mode=mode, frz=frz)
        if a.device.type != "cuda":
            raise ValueError(f"scl_subtree: unsupported device {a.device}")
        lib = _build.load("scl_subtree", "cuda")
        if n_shared is None:
            n_shared = shared_stages(b, a.shape[1])
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            out = _native_call(lib.scl_subtree_launch, a, pm, frz, sched, b,
                               llr_max, mode, n_shared, stream)
            tracing.count("launch.scl_subtree", ops=2)
            tracing.count("form.scl_subtree.traced", int(sched.traced))
            tracing.count("form.scl_subtree.wide", int(a.shape[1] > 8))
        kernel_work.report(kernel_work.subtree_work, sched.ops, b, mode, a,
                           frz)
        return out

THREADS = 128                 # a block: THREADS // L codewords (kThreads)
SMEM_BUDGET = 48 * 1024       # dynamic shared memory a block may take


def block_smem_bytes(L: int, n_shared: int, route: str = "cuda") -> int:
    """Dynamic shared memory of one block of the kernel with workspace
    stages 0..n_shared-1 in shared memory, as the routine lays it out
    (``smem_bytes`` in csrc/scl_subtree.cuh, asked of the ``route``'s
    build): per codeword 4 + 1 bytes per row and path, plus its exchange
    arrays."""
    fn = _build.load("scl_subtree", route).scl_subtree_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_longlong
    return int(fn(L, n_shared))


@functools.lru_cache(maxsize=None)
def shared_stages(b: int, L: int, route: str = "cuda") -> int:
    """The most workspace stages (from stage 0 up) that fit
    ``SMEM_BUDGET`` bytes of shared memory a block; the stages above go to
    a global scratch."""
    n = b
    while n > 0 and block_smem_bytes(L, n, route) > SMEM_BUDGET:
        n -= 1
    return n


def scl_subtree_host(a, pm, sched: SubtreeSchedule, *, b: int,
                     llr_max: float, mode: str, frz=None, n_shared=None):
    """The kernel's per-codeword routine built for the CPU (g++); CPU
    tensors only. ``n_shared`` (default b) splits the workspace stages
    between the codeword's "shared" arrays and the global scratch, as on
    the card. For tests: the main path never calls it."""
    if a.device.type != "cpu":
        raise ValueError("scl_subtree_host takes CPU tensors")
    lib = _build.load("scl_subtree", "host")
    return _native_call(lib.scl_subtree_host, a, pm, frz, sched, b,
                        llr_max, mode, b if n_shared is None else n_shared,
                        None)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
             ctypes.c_int]


def _native_call(fn, a, pm, frz, sched, b, llr_max, mode, n_shared, stream):
    w, L, bs = a.shape
    if a.dtype != torch.float32 or pm.dtype != torch.float32:
        raise TypeError("scl_subtree takes f32 LLRs and path metrics")
    if w != 1 << b or not 1 <= b <= MAX_B or sched.span != w:
        raise ValueError(f"a has {w} rows and the schedule {sched.span} "
                         f"leaves; need 2^b of both with 1 <= b <= {MAX_B} "
                         f"(b={b})")
    if L not in LIST_SIZES:
        raise ValueError(f"list size {L} not in {LIST_SIZES}")
    if a.stride(2) != 1 and bs > 1:
        raise ValueError("a must have unit stride along the batch")
    if tuple(pm.shape) != (L, bs):
        raise ValueError(f"pm has shape {tuple(pm.shape)}, need {(L, bs)}")
    if mode not in F_FUNCTIONS:
        raise ValueError(f"unknown mode {mode!r}")
    if not 0 <= n_shared <= b:
        raise ValueError(f"n_shared={n_shared} stages not in [0, b={b}]")
    table = sched.table
    if table.device != a.device or pm.device != a.device:
        raise ValueError("a, pm and the schedule table must share a device")
    frz_ptr = None
    if sched.traced:
        if (frz is None or frz.dtype != torch.int32
                or tuple(frz.shape) != (w,) or frz.device != a.device):
            raise ValueError(f"'t' ops need frz, an int32 [{w}] tensor on "
                             f"{a.device}")
        frz = frz.contiguous()
        frz_ptr = frz.data_ptr()
    pm = pm.contiguous()
    dev = a.device
    cw = torch.empty((w, L, bs), dtype=torch.int32, device=dev)
    P = torch.empty((L, bs), dtype=torch.int32, device=dev)
    pm_out = torch.empty((L, bs), dtype=torch.float32, device=dev)
    # the global scratch of the stages that stay out of shared memory; the
    # partial sums' also holds stage b, the codeword before its transpose
    rows = w - (1 << n_shared)
    lloc = torch.empty((rows, bs, L), dtype=torch.float32, device=dev)
    uloc = torch.empty((rows + w, bs, L), dtype=torch.int8, device=dev)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES + ([] if stream is None
                                   else [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    args = [a.data_ptr(), a.stride(0), a.stride(1), pm.data_ptr(), frz_ptr,
            table.data_ptr(), table.shape[0], cw.data_ptr(), P.data_ptr(),
            pm_out.data_ptr(), lloc.data_ptr() if rows else None,
            uloc.data_ptr(), b, L, bs, float(llr_max),
            int(F_FUNCTIONS[mode] is f_exact), n_shared, int(sched.pc)]
    rc = fn(*args) if stream is None else fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"scl_subtree: native call failed with code {rc}")
    return cw, P, pm_out


# ----------------------------------------------------------------------
# the plain version
# ----------------------------------------------------------------------
def _take_paths(x, idx):
    """Re-index the path axis (-2) of ``x`` by ``idx`` [L, bs]:
    ``out[..., l, c] = x[..., idx[l, c], c]``."""
    return torch.gather(x, -2, idx.expand(x.shape[:-2] + idx.shape))


def _row_sum(x):
    """Sum over the rows (dim 0) one row at a time, in row order, as the
    kernel does. Paths with equal rows then get bitwise-equal sums, so the
    kernel and this version break exact ties between such paths alike."""
    acc = x[0]
    for row in x[1:]:
        acc = acc + row
    return acc


def _top_l(pmc, L):
    """Ascending best L of the [2L, bs] candidates, equal metrics in
    candidate order."""
    vals, idx = torch.sort(pmc, dim=0, stable=True)
    return vals[:L], idx[:L]


def _rep_fork(pm, cur, llr_max, row_sum=_row_sum):
    """Repetition node ('r') or info leaf ('i') on its root LLRs ``cur``
    [w, L, bs]: one fork for the repeated bit. Returns (pm, parent, bit).
    ``row_sum`` sums over the rows (the kernel's order by default)."""
    a_c = _clip(cur, llr_max)
    L = pm.shape[0]
    pmc = torch.cat([pm + row_sum(softplus(-a_c)),
                     pm + row_sum(softplus(a_c))], dim=0)
    pm, idx = _top_l(pmc, L)
    return pm, idx % L, (idx // L).to(torch.int8)


def _flip_forks(pm, cur, llr_max, spc, fork, row_sum=_row_sum):
    """Rate-1 ('o') or SPC ('s') node on its root LLRs ``cur`` [w, L, bs]:
    hard decisions plus theta sequential least-reliable-flip forks, each of
    which calls ``fork(parent)``. Returns (pm, node sums [w, L, bs] int8,
    the forks' composed parent map). ``row_sum`` as in ``_rep_fork``."""
    w_nd, L, _ = cur.shape
    a_c = _clip(cur, llr_max)
    aab = a_c.abs()
    hd = (a_c < 0).to(torch.int8)
    theta = min(L, w_nd) if spc else min(L - 1, w_nd)
    small = not spc and w_nd <= L - 1      # row-order forks, no sort
    if not small:
        vals, rows = torch.sort(aab, dim=0, stable=True)
        vals, rows = vals[:theta], rows[:theta]
    pm = pm + row_sum(softplus(-aab))
    e = None
    if spc:
        par = hd.to(torch.int32).sum(dim=0) & 1
        pm = pm + par.to(torch.float32) * vals[0]
        e = par.to(torch.int8)
    qn = None
    fm = torch.zeros_like(hd)
    iota_w = torch.arange(w_nd, device=cur.device)[:, None, None]
    for t in range(1 if spc else 0, theta):
        val_t = aab[t] if small else vals[t]
        v0 = vals[0] if spc else None
        if qn is not None:
            val_t = _take_paths(val_t, qn)
            v0 = None if v0 is None else _take_paths(v0, qn)
        if spc:
            val_t = val_t + (1.0 - 2.0 * e.to(torch.float32)) * v0
        pm, idx = _top_l(torch.cat([pm, pm + val_t], dim=0), L)
        parent = idx % L
        flip = (idx // L).to(torch.int8)
        fork(parent)
        qn = parent if qn is None else _take_paths(qn, parent)
        fm = _take_paths(fm, parent)
        if spc:
            e = _take_paths(e, parent) ^ flip
        if small:
            fm = fm ^ torch.where(iota_w == t, flip[None],
                                  torch.zeros_like(flip[None]))
        else:
            row_t = _take_paths(rows[t], qn)
            fm = fm ^ ((iota_w == row_t[None])
                       & (flip[None] == 1)).to(torch.int8)
    if spc:
        row_0 = rows[0] if qn is None else _take_paths(rows[0], qn)
        fm = fm ^ ((iota_w == row_0[None]) & (e[None] == 1)).to(torch.int8)
    c = hd if qn is None else _take_paths(hd, qn)
    return pm, c ^ fm, qn


def scl_subtree_plain(a, pm, ops, *, b: int, llr_max: float, mode: str,
                      frz=None):
    """Plain PyTorch subtree decode on any device; ``ops`` is the op list
    of a ``SubtreeSchedule`` (``frz`` as for ``scl_subtree``). Forks
    re-order whole workspaces, and the stage-b input rides the packed LLR
    buffer so forks reach it too. A ``'t'`` leaf computes the fork and
    selects, on its frozen flag, between it and the frozen leaf's update,
    without a host sync. With ``'p'`` leaves each path carries its PC
    register, an int8 [L, bs] word that forks re-order with the rest."""
    f = F_FUNCTIONS[mode]
    w_sub, L, bs = a.shape
    dev = a.device
    off = lambda s: (1 << s) - 1
    lloc = torch.zeros(((1 << (b + 1)) - 1, L, bs), dtype=torch.float32,
                       device=dev)
    lloc[off(b):off(b + 1)] = a
    uloc = torch.zeros_like(lloc, dtype=torch.int8)
    P = None
    cwj = None
    # the PC register, or None when no leaf reads it
    y = (torch.zeros((L, bs), dtype=torch.int8, device=dev)
         if any(k == "p" for k, _, _ in ops) else None)

    def fork(parent):
        nonlocal lloc, uloc, P, y
        lloc = _take_paths(lloc, parent)
        uloc = _take_paths(uloc, parent)
        P = parent if P is None else _take_paths(P, parent)
        if y is not None:
            y = _take_paths(y, parent)

    def descend(s_from, s_nd, cur):
        for s in range(s_from, s_nd, -1):
            h = 1 << (s - 1)
            cur = f(cur[:h], cur[h:], llr_max)
            if s - 1 > s_nd:
                lloc[off(s - 1):off(s)] = cur
        return cur

    for kind, s_nd, lo in ops:
        w_nd = 1 << s_nd
        i_end = lo + w_nd - 1
        # ---- descent to the node root ----
        if lo == 0:
            cur = descend(b, s_nd, lloc[off(b):off(b + 1)])
        else:
            d = _ctz(lo)
            seg = lloc[off(d + 1):off(d + 2)]
            h = 1 << d
            cur = g_op(seg[:h], seg[h:], uloc[off(d):off(d + 1)])
            if d > s_nd:
                lloc[off(d):off(d + 1)] = cur
            cur = descend(d, s_nd, cur)
        # ---- node ----
        if kind in ("f", "z"):
            pm = pm + _row_sum(softplus(-_clip(cur, llr_max)))
            ubit = torch.zeros((w_nd, L, bs), dtype=torch.int8, device=dev)
        elif kind in ("o", "s"):
            pm, ubit, _ = _flip_forks(pm, cur, llr_max, kind == "s", fork)
        elif kind in ("r", "i"):
            pm, parent, bit = _rep_fork(pm, cur, llr_max)
            ubit = bit[None].expand(w_nd, L, bs)
            fork(parent)
            if y is not None and kind == "i":
                y = y ^ (bit << ((lo + 1) % PC_REGISTER))
        elif kind == "p":
            # the register's bit decides; one signed softplus, no fork
            bit = (y >> ((lo + 1) % PC_REGISTER)) & 1
            a_c = _clip(cur, llr_max)
            pm = pm + _row_sum(softplus(torch.where(bit[None] == 1, a_c,
                                                    -a_c)))
            ubit = bit[None]
        elif kind == "t":
            frozen = frz[lo] != 0
            pm_f = pm + _row_sum(softplus(-_clip(cur, llr_max)))
            pm_i, parent, bit = _rep_fork(pm, cur, llr_max)
            pm = torch.where(frozen, pm_f, pm_i)
            ident = torch.arange(L, device=dev)[:, None].expand(L, bs)
            parent = torch.where(frozen, ident, parent)
            ubit = torch.where(frozen, torch.zeros_like(bit), bit)[None]
            fork(parent)
        else:
            raise ValueError(f"unknown op kind {kind!r}")
        # ---- rise ----
        r = _cto(i_end)
        cur_u = ubit
        for s in range(s_nd, min(r, b)):
            left = uloc[off(s):off(s + 1)]
            cur_u = torch.cat([left ^ cur_u, cur_u], dim=0)
        if r >= b:
            cwj = cur_u
        else:
            uloc[off(r):off(r + 1)] = cur_u
    if P is None:
        P = torch.arange(L, device=dev)[:, None].expand(L, bs)
    return cwj.to(torch.int32), P.to(torch.int32), pm
