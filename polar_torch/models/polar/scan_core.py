"""The two-level SC and SCL sweeps.

The decode tree is cut at stage ``b``. Every 2^b-leaf subtree is one call of
a subtree kernel (``cuda_scl.scl_subtree`` for SCL, ``cuda_sc.sc_subtree``
for SC); the stages above ``b`` run here as tensor code. For SCL:

* the outer descent (f/g from the channel LLRs down to the next subtree),
  and the rise (partial-sum combines back up);
* upper nodes, i.e. rate-0 ('z'), repetition ('r'), rate-1 ('o') and SPC
  ('s') nodes that span whole subtrees, at their true stage;
* lazy path pointers per upper stage: a fork composes the live pointers
  (``_lptr_live`` / ``_uptr_live``) instead of copying segments;
* survivor backtracking through the parent maps, then the polar transform
  of the survivors' codewords (``cuda_butterfly.butterfly_rows``).

The node schedule is Hashemi's fast-SSCL pruning: rate-0 nodes keep a bulk
path-metric update, repetition nodes one fork, and (``rate1=True``) rate-1
and SPC nodes theta least-reliable-flip forks at the node top. The plain
(unpruned) SCL sweep, ``scl_sweep_hybrid``, is the same sweep with one
frozen/info op per leaf (``leaf_schedule``); with more than
``UNROLL_OUTER_MAX_M`` subtrees its units share one traced schedule and
take their frozen flags as data (``plan_plain_sweep``). With ``b = S`` the
whole tree is one subtree call.

The SC sweep (``sc_sweep_hybrid``) has no list and so no pointers and no
backtracking: its schedule is ``fast_schedule(mask, rep=False)``, whose
rate-0 nodes above stage b skip their subtrees' calls.

PC-aided decoding (the parity-check bits of 5G's small uplink codes) adds
a ``'p'`` leaf to the plain SCL schedule and to the SC schedule. It runs
with b = log2(n), the whole tree in one kernel call, so each path's PC
register lives and dies inside the call.

Both sweeps mark their pieces as spans (``utils.tracing``):
``sweep.descend`` (the outer f/g), ``sweep.node`` (an upper node),
``sweep.cast`` (a subtree's parent map to int64 and, with more than one
subtree, its codeword to int8),
``sweep.rise`` (the pointer updates and partial-sum combines after a
subtree, and the combines after a node), ``sweep.backtrack`` (the survivor
labels) and ``sweep.transform`` (the codewords stacked and transformed).
The SC sweep counts, once a decode, the f and g rows it computes here above
stage b in the tracing counter ``rows.sc.top`` (1024 for the 5G-ranked
(1024, 512) code at b = 9, 0 at b = log2(n)).
"""

import numpy as np
import torch

from polar_torch.models.polar.cuda_butterfly import butterfly_rows
from polar_torch.models.polar.cuda_sc import sc_schedule, sc_subtree
from polar_torch.models.polar.cuda_scl import (
    SubtreeSchedule, _ctz, _cto, _flip_forks, _lptr_live,
    _rep_fork, _take_paths, _uptr_live, scl_subtree, traced_schedule)
from polar_torch.ops.butterfly import polar_transform
from polar_torch.ops.fg import F_FUNCTIONS, _clip, g as g_op, softplus
from polar_torch.utils import tracing

# SPC ('s') nodes are off unless a threshold stage is given
SPC_MIN_STAGE_OFF = 99
# subtree depth b when none is given: the fastest of b = 5..10 for the
# k=512 n=1024 SCL-8 chain on an H100 (the depth survey of chip_smoke.py),
# and of b = 4..10 for the plain SCL-8 sweep of the same code. The kernel
# runs a thread per path with its workspaces in shared memory as far as
# they fit, so a deeper subtree costs it less than the outer sweep's
# whole-batch torch ops and host launches that it replaces: at n=1024 the
# whole tree is one kernel call.
DEFAULT_LOWER_STAGES = 10
# the same for lists of 16 and 32: the fastest of b = 3..10 for the
# CA-SCL-32 decoder of the 5G k=400 E=1000 code (n=1024) at a batch of 2048
# on an H100 (chip_smoke.py's CA-SCL-32 depth survey). Each subtree call
# costs the outer sweep whole-batch torch ops and host launches that cost
# more than the kernel's top stages, so here too the whole n=1024 tree is
# one call. The two constants come from separate surveys.
DEFAULT_WIDE_LOWER_STAGES = 10
# the same for SC: the fastest of b = 4..10 for the k=512 n=1024 SC decoder
# on an H100 (chip_smoke.py's SC depth survey). The kernel runs a group of
# lanes per codeword with its workspaces in shared memory, so a deeper
# subtree saves the outer sweep's whole-batch ops and launches, up to the
# whole tree: at b=10 the input and codeword tiles and the workspaces of
# a block's 16 codewords outgrow the budget that keeps four blocks an SM,
# and the decode is half again as slow as at b=9.
DEFAULT_SC_LOWER_STAGES = 9


# with more subtrees than this the plain sweep runs them on the traced
# form, as the JAX package's plain sweep does (its lax.scan outer)
UNROLL_OUTER_MAX_M = 8


def resolve_lower_stages(S: int, lower_stages=None,
                         default: int = DEFAULT_LOWER_STAGES) -> int:
    """Subtree depth b of a 2^S-leaf tree: ``lower_stages`` (else
    ``default``) clamped to [1, S]."""
    b = default if lower_stages is None else int(lower_stages)
    return max(1, min(b, S))


def default_lower_stages(list_size: int) -> int:
    """The SCL decoders' subtree depth when none is given, by list size."""
    return DEFAULT_LOWER_STAGES if list_size <= 8 \
        else DEFAULT_WIDE_LOWER_STAGES


def fast_schedule(frozen_mask, rep: bool = True, rate1: bool = False,
                  spc_min_stage=None, pc_mask=None):
    """Fast-SCL pruned node schedule in leaf order:

        ('z', s, lo)  rate-0 node covering [lo, lo + 2^s)
        ('r', s, lo)  repetition node (all frozen but the last leaf)
        ('o', s, lo)  rate-1 node (no frozen leaf), with ``rate1=True``
        ('s', s, lo)  SPC node (only the first leaf frozen), with
                      ``rate1=True`` and s >= ``spc_min_stage`` (>= 1)
        ('f', 0, lo)  frozen leaf
        ('i', 0, lo)  info leaf
        ('p', 0, lo)  parity-check (PC) leaf, where ``pc_mask`` is set

    ``rep=False`` emits rate-0 prunes only. ``spc_min_stage=None`` keeps SPC
    nodes off. A node holding a PC leaf is never a repetition, rate-1 or
    SPC node: the PC register walks its leaves one by one."""
    mask = np.asarray(frozen_mask, dtype=bool)
    n = len(mask)
    pc = _pc_leaves(mask, pc_mask)
    spc_min = max(1, SPC_MIN_STAGE_OFF if spc_min_stage is None
                  else int(spc_min_stage))
    ops = []

    def rec(s, lo):
        seg = mask[lo:lo + (1 << s)]
        plain = not pc[lo:lo + (1 << s)].any()
        if s >= 1 and seg.all():
            ops.append(("z", s, lo))
        elif plain and rep and s >= 1 and not seg[-1] and seg[:-1].all():
            ops.append(("r", s, lo))
        elif plain and rate1 and s >= 1 and not seg.any():
            ops.append(("o", s, lo))
        elif (plain and rate1 and s >= spc_min and seg[0]
              and not seg[1:].any()):
            ops.append(("s", s, lo))
        elif s == 0:
            ops.append(("f" if seg[0] else "p" if pc[lo] else "i", 0, lo))
        else:
            rec(s - 1, lo)
            rec(s - 1, lo + (1 << (s - 1)))

    rec(int(np.log2(n)), 0)
    return ops


def _pc_leaves(frozen_mask, pc_mask):
    """``pc_mask`` as a bool array (all False when None); a PC leaf that
    is also frozen raises."""
    pc = np.zeros(len(frozen_mask), dtype=bool)
    if pc_mask is not None:
        pc_mask = np.asarray(pc_mask, dtype=bool)
        if pc_mask.shape != pc.shape:
            raise ValueError(f"the PC mask has {pc_mask.size} leaves, the "
                             f"frozen mask {pc.size}")
        pc |= pc_mask
        both = np.flatnonzero(pc & frozen_mask)
        if both.size:
            raise ValueError(f"PC positions {both.tolist()} are frozen")
    return pc


def leaf_schedule(frozen_mask, pc_mask=None):
    """The unpruned schedule: one ``('f', 0, lo)``, ``('i', 0, lo)`` or,
    where ``pc_mask`` is set, ``('p', 0, lo)`` op per leaf."""
    mask = np.asarray(frozen_mask, dtype=bool)
    pc = _pc_leaves(mask, pc_mask)
    return [("f" if fz else "p" if p else "i", 0, lo)
            for lo, (fz, p) in enumerate(zip(mask, pc))]


def split_fast_schedule(frozen_mask, b, rate1: bool = False,
                        spc_min_stage=None):
    """``split_schedule`` of the fast schedule."""
    return split_schedule(fast_schedule(frozen_mask, rate1=rate1,
                                        spc_min_stage=spc_min_stage), b)


def split_schedule(ops, b):
    """Cut a schedule (leaf order) at the subtree boundary 2^b. Returns
    ``(units, has_upper_rep)``: ``units`` in leaf order are
    ``('sub', j, ops_j)`` (subtree ``j``, ``lo`` local to it) or
    ``(kind, s, j0, q)``, an upper node at stage ``s > b`` covering the
    ``q = 2^(s-b)`` subtrees from ``j0``."""
    units, has_upper_rep = [], False
    cur_j, cur_ops = None, []

    def flush():
        nonlocal cur_j, cur_ops
        if cur_j is not None:
            units.append(("sub", cur_j, tuple(cur_ops)))
            cur_j, cur_ops = None, []

    for kind, s, lo in ops:
        if s > b:
            flush()
            has_upper_rep |= kind == "r"
            units.append((kind, s, lo >> b, 1 << (s - b)))
        else:
            j = lo >> b
            if j != cur_j:
                flush()
                cur_j = j
            cur_ops.append((kind, s, lo - (j << b)))
    flush()
    return units, has_upper_rep


def sum_rows(x):
    """One reduction over the rows (dim 0): upper nodes are wide, and no
    kernel computes them, so no summation order has to be matched."""
    return x.sum(dim=0)


def plan_sweep(ops, b, device, schedule=SubtreeSchedule):
    """``split_schedule``'s units with each subtree's op list encoded once
    by ``schedule(ops, device)`` (the SCL kernel's ``SubtreeSchedule`` or
    the SC kernel's ``cuda_sc.sc_schedule``). A subtree
    unit is ``("sub", j, schedule, frz)``; ``frz`` is None for a static
    schedule. PC leaves (``'p'``) need the whole tree in one subtree
    (``b = log2(n)``): the kernels start each call's PC register at zero
    and index it by the leaf's place in the subtree."""
    units, _ = split_schedule(ops, b)
    if any(k == "p" for k, _, _ in ops) and len(units) > 1:
        raise ValueError(f"PC leaves need the whole tree in one subtree "
                         f"call; b={b} cuts it into {len(units)} units")
    return [("sub", u[1], schedule(u[2], device), None)
            if u[0] == "sub" else u for u in units]


def plan_plain_sweep(frozen_mask, b, device, pc_mask=None):
    """The plain SCL sweep's plan. Up to ``UNROLL_OUTER_MAX_M`` subtrees
    each get their static leaf-only schedule; beyond that every subtree
    shares one traced schedule (``'t'`` leaves) and carries its slice of
    the frozen mask as ``frz``, an int32 [2^b] tensor on ``device``. Both
    decode alike, bit for bit. ``pc_mask`` adds PC leaves (``'p'``), which
    need b = log2(n) (``plan_sweep``)."""
    mask = np.asarray(frozen_mask, dtype=bool)
    m = len(mask) >> b
    if m <= UNROLL_OUTER_MAX_M or pc_mask is not None:
        return plan_sweep(leaf_schedule(mask, pc_mask), b, device)
    sched = SubtreeSchedule(traced_schedule(b), device)
    frz = torch.from_numpy(mask.reshape(m, 1 << b).astype(np.int32)).to(
        device)
    return [("sub", j, sched, frz[j]) for j in range(m)]


def plan_fast_sweep(frozen_mask, b, device, rate1: bool = False,
                    spc_min_stage=None):
    """The fast SCL sweep's plan (``plan_sweep`` of ``fast_schedule``)."""
    return plan_sweep(fast_schedule(frozen_mask, rate1=rate1,
                                    spc_min_stage=spc_min_stage), b, device)


def scl_sweep_hybrid_fast(llr_ch, frozen_mask, list_size: int,
                          mode: str = "minsum", llr_max: float = 30.0,
                          lower_stages=None, rate1: bool = False,
                          spc_min_stage=None, plan=None,
                          subtree=scl_subtree):
    """Two-level fast-SCL sweep. ``llr_ch``: [n, bs] channel LLRs
    (positive means bit 0). Returns ``(u [n, L, bs] int8, pm [L, bs])``.

    ``lower_stages`` is the subtree depth b (see ``resolve_lower_stages``;
    by default ``default_lower_stages(list_size)``; b = S runs the whole
    tree as one subtree call). ``plan`` is ``plan_fast_sweep``'s result
    for the same mask, b, ``rate1`` and ``spc_min_stage``, computed here
    when omitted. ``subtree`` decodes one subtree (``cuda_scl.scl_subtree``
    or a function with its signature)."""
    n, bs = llr_ch.shape
    S = int(np.log2(n))
    L = int(list_size)
    b = resolve_lower_stages(S, lower_stages, default_lower_stages(L))
    dev = llr_ch.device
    f = F_FUNCTIONS[mode]
    w_sub = 1 << b
    m = n >> b
    top = S - b
    if plan is None:
        plan = plan_fast_sweep(frozen_mask, b, dev, rate1=rate1,
                               spc_min_stage=spc_min_stage)
    llr_bc = llr_ch.to(torch.float32)[:, None, :].expand(n, L, bs)

    # upper-stage state: lbs[t] holds super-stage t+1 (real stage b+1+t),
    # u0s[t] super-stage t; pointers are None (identity) or an index map
    lbs = [None] * max(top - 1, 0)
    u0s = [None] * top
    lptr = [None] * max(top - 1, 0)
    uptr = [None] * top
    pm = torch.full((L, bs), llr_max, dtype=torch.float32, device=dev)
    pm[0] = 0.0

    def read(seg, ptr):
        return seg if ptr is None else _take_paths(seg, ptr)

    def compose(ptr, parent):
        return parent if ptr is None else _take_paths(ptr, parent)

    def compose_live(parent, j_end: int, sg_nd: int):
        """Re-index the live upper pointers by a fork's parent selection;
        dead ones are rewritten before their next read and stay as they
        are."""
        for t in range(len(lptr)):
            if _lptr_live(t + 1, j_end):
                lptr[t] = compose(lptr[t], parent)
        for t in range(top):
            if _uptr_live(t, j_end, sg_nd):
                uptr[t] = compose(uptr[t], parent)

    def store(sg, cur):
        """Keep super-stage ``sg`` (>= 1) for its pending g-read."""
        lbs[sg - 1] = cur
        lptr[sg - 1] = None

    def descend(j0: int, sg_nd: int):
        """LLRs of the unit starting at subtree ``j0``, down to super-stage
        ``sg_nd``: [2^(b+sg_nd), L, bs]."""
        if j0 == 0:
            cur, sg_from = llr_bc, top
        else:
            d = _ctz(j0)
            a = llr_bc if d + 1 == top else read(lbs[d], lptr[d])
            h = 1 << (b + d)
            cur = g_op(a[:h], a[h:], read(u0s[d], uptr[d]))
            if d > sg_nd:
                store(d, cur)
            sg_from = d
        for sg in range(sg_from, sg_nd, -1):
            h = 1 << (b + sg - 1)
            cur = f(cur[:h], cur[h:], llr_max)
            if sg - 1 > sg_nd:
                store(sg - 1, cur)
        return cur

    def rise(node_sums, j_end: int, sg_nd: int):
        """Combine partial sums upward through cto(j_end) super-stages."""
        r = _cto(j_end)
        cur_u = node_sums
        for sg in range(sg_nd, min(r, top)):
            cur_u = torch.cat([read(u0s[sg], uptr[sg]) ^ cur_u, cur_u], dim=0)
        if r < top:
            u0s[r] = cur_u
            uptr[r] = None

    # ---- the outer sweep over schedule units ----
    cws = [None] * m
    ps = [None] * m
    for unit in plan:
        if unit[0] == "sub":
            _, j, sched, frz = unit
            with tracing.span("sweep.descend"):
                a = descend(j, 0)
            cw32, Pj, pm = subtree(a, pm, sched, b=b, llr_max=llr_max,
                                   mode=mode, frz=frz)
            with tracing.span("sweep.cast"):
                Pj = Pj.to(torch.int64)
                # one subtree is the whole tree: top is 0, so the rise
                # combines nothing, and backtracking re-indexes no path;
                # the transform reads the int32 codeword as it is
                cws[j] = cw32 if m == 1 else cw32.to(torch.int8)
            with tracing.span("sweep.rise"):
                compose_live(Pj, j, 0)
                ps[j] = Pj
                rise(cws[j], j, 0)
            continue
        kind, s_real, j0, q = unit
        sg_nd = s_real - b
        j_end = j0 + q - 1
        with tracing.span("sweep.descend"):
            cur = descend(j0, sg_nd)              # [2^s_real, L, bs]
        fork = lambda parent: compose_live(parent, j_end, sg_nd)
        with tracing.span("sweep.node"):
            if kind == "z":
                # rate-0 spanning q subtrees: bulk path-metric update
                pm = pm + sum_rows(softplus(-_clip(cur, llr_max)))
                node_sums = torch.zeros((1 << s_real, L, bs),
                                        dtype=torch.int8, device=dev)
                for jj in range(j0, j_end + 1):
                    cws[jj] = node_sums[:w_sub]
                    ps[jj] = None
            elif kind in ("o", "s"):
                pm, node_sums, qn = _flip_forks(pm, cur, llr_max,
                                                kind == "s", fork, sum_rows)
                # emissions are stage-b codewords: undo the node's combine
                # levels along the chunk axis; the composed parent map
                # rides the first covered subtree
                em = polar_transform(node_sums.reshape(q, w_sub, L, bs),
                                     axis=0)
                for jj in range(j0, j_end + 1):
                    cws[jj] = em[jj - j0]
                    ps[jj] = qn if jj == j0 else None
            else:
                # repetition spanning q subtrees: one fork
                pm, parent, bit = _rep_fork(pm, cur, llr_max, sum_rows)
                fork(parent)
                node_sums = bit[None].expand(1 << s_real, L, bs)
                for jj in range(j0, j_end + 1):
                    cws[jj] = node_sums[:w_sub]
                    # the fork's parent map rides the first covered subtree
                    ps[jj] = parent if jj == j0 else None
        with tracing.span("sweep.rise"):
            rise(node_sums, j_end, sg_nd)

    # ---- survivor backtracking (label None is the identity) ----
    with tracing.span("sweep.backtrack"):
        label = None
        for j in range(m - 1, -1, -1):
            if label is not None:
                cws[j] = _take_paths(cws[j], label)
            if ps[j] is not None:
                label = ps[j] if label is None else _take_paths(ps[j],
                                                                label)
    with tracing.span("sweep.transform"):
        # [m, 2^b, L, bs]; some entries are views or expands
        cw = cws[0][None] if m == 1 else torch.stack(cws, dim=0)
        u = butterfly_rows(cw.reshape(m, w_sub, L * bs))
    return u.reshape(n, L, bs), pm


def scl_sweep_hybrid(llr_ch, frozen_mask, list_size: int,
                     mode: str = "minsum", llr_max: float = 30.0,
                     lower_stages=None, plan=None, subtree=scl_subtree):
    """Plain (unpruned) two-level SCL sweep: ``scl_sweep_hybrid_fast`` on
    ``leaf_schedule``, one frozen/info op per leaf and no upper nodes.
    Arguments and result as there; ``plan`` is ``plan_plain_sweep``'s
    result for the same mask and b."""
    S = int(np.log2(llr_ch.shape[0]))
    b = resolve_lower_stages(S, lower_stages,
                             default_lower_stages(int(list_size)))
    if plan is None:
        plan = plan_plain_sweep(frozen_mask, b, llr_ch.device)
    return scl_sweep_hybrid_fast(llr_ch, frozen_mask, list_size, mode=mode,
                                 llr_max=llr_max, lower_stages=b, plan=plan,
                                 subtree=subtree)


def plan_sc_sweep(frozen_mask, b, device, pc_mask=None):
    """The SC sweep's plan: ``plan_sweep`` of the rate-0-pruned schedule
    ``fast_schedule(mask, rep=False, pc_mask=pc_mask)`` with the SC
    kernel's op codes."""
    return plan_sweep(fast_schedule(frozen_mask, rep=False, pc_mask=pc_mask),
                      b, device, schedule=sc_schedule)


def sc_sweep_hybrid(llr_ch, frozen_mask, mode: str = "minsum",
                    llr_max: float = 30.0, lower_stages=None, plan=None,
                    subtree=sc_subtree):
    """Two-level SC sweep. ``llr_ch``: [n, bs] channel LLRs (positive
    means bit 0) -> decisions ``u`` [n, bs] int8.

    ``lower_stages`` is the subtree depth b (default
    ``DEFAULT_SC_LOWER_STAGES``; b = S decodes the whole tree in one
    subtree call). ``plan`` is ``plan_sc_sweep``'s result for the same mask
    and b, computed here when omitted. ``subtree`` decodes one subtree
    (``cuda_sc.sc_subtree`` or a function with its signature). Each
    subtree emits its stage-b codeword, so the decisions come from a
    width-2^b polar transform per subtree."""
    n, bs = llr_ch.shape
    S = int(np.log2(n))
    b = resolve_lower_stages(S, lower_stages, DEFAULT_SC_LOWER_STAGES)
    dev = llr_ch.device
    f = F_FUNCTIONS[mode]
    w_sub = 1 << b
    top = S - b
    if plan is None:
        plan = plan_sc_sweep(frozen_mask, b, dev)
    llr = llr_ch.to(torch.float32).contiguous()
    # lbs[t] holds super-stage t+1 (real stage b+1+t), u0s[t] the left
    # partial sums of super-stage t, each waiting for its g-read / combine
    lbs = [None] * max(top - 1, 0)
    u0s = [None] * top
    top_rows = 0                # f and g rows computed above stage b

    def descend(j0: int, sg_nd: int, stop: int):
        """Descend from the unit's g-entry to super-stage ``stop``, storing
        the super-stages above the unit's root ``sg_nd``; the value at
        ``stop`` (None when the g-entry lies below it)."""
        nonlocal top_rows
        if j0 == 0:
            cur, d = llr, top
        else:
            d = _ctz(j0)
            if d < stop:
                return None
            a = llr if d + 1 == top else lbs[d]
            h = 1 << (b + d)
            cur = g_op(a[:h], a[h:], u0s[d])
            top_rows += h
            if d > sg_nd:
                lbs[d - 1] = cur
        for sg in range(d, stop, -1):
            h = 1 << (b + sg - 1)
            cur = f(cur[:h], cur[h:], llr_max)
            top_rows += h
            if sg - 1 > sg_nd:
                lbs[sg - 2] = cur
        return cur

    cws = [None] * (n >> b)
    for unit in plan:
        if unit[0] == "sub":
            _, j, sched, _ = unit
            with tracing.span("sweep.descend"):
                a = descend(j, 0, 0)
            cw32 = subtree(a, None, sched, b=b, llr_max=llr_max, mode=mode)
            with tracing.span("sweep.cast"):
                node = cws[j] = cw32.to(torch.int8)
            j_end, sg_nd = j, 0
        else:
            # rate-0 node spanning q subtrees: zero partial sums whatever
            # its LLRs; the descent only stores what later g-reads need
            _, s_real, j0, q = unit
            sg_nd, j_end = s_real - b, j0 + q - 1
            with tracing.span("sweep.descend"):
                descend(j0, sg_nd, sg_nd + 1)
            with tracing.span("sweep.node"):
                node = torch.zeros((1 << s_real, bs), dtype=torch.int8,
                                   device=dev)
                for jj in range(j0, j_end + 1):
                    cws[jj] = node[:w_sub]
        # rise: combine partial sums upward through cto(j_end) stages
        with tracing.span("sweep.rise"):
            r = _cto(j_end)
            for sg in range(sg_nd, min(r, top)):
                node = torch.cat([u0s[sg] ^ node, node], dim=0)
            if r < top:
                u0s[r] = node
    tracing.count("rows.sc.top", top_rows)
    with tracing.span("sweep.transform"):
        cw = torch.stack(cws, dim=0)              # [m, 2^b, bs]
        return polar_transform(cw, axis=1).reshape(n, bs)
