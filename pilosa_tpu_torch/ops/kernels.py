"""Popcount kernels of the count, GroupBy, TopN and BSI paths, each with
its plain PyTorch version.

Hand-written CUDA kernels, built by ops/build.py: the pair kernels and the
group-tensor kernels on the tensor cores' binary MMA (ops/csrc/bmma.cu), and
the row popcounts and the BSI plane walk on the CUDA cores
(ops/csrc/bitcount.cu):

- ``pair_stats_pershard`` (K1, bmma.cu): per shard s, over int32[S, Rf, W] and
  int32[S, Rg, W] stacks,

      pair[s, a, b] = popcount(F[s, a, :] & G[s, b, :])
      cf[s, a]      = popcount(F[s, a, :])
      cg[s, b]      = popcount(G[s, b, :])

  returned as one flat int32[S, Rf*Rg + Rf + Rg] table, each row laid out
  ``[pair.ravel() | cf | cg]``. Per-shard counts are <= 2^20, so int32 is
  exact for any shard count.
- ``pair_stats`` (K2, bmma.cu): the same stats summed over shards,
  int32[D]. Exact while S <= MAX_PAIR_SHARDS (S * 2^20 < 2^31).
- ``popcount_rows`` (K3, bitcount.cu): int32[N, W] -> int32[N], the popcount
  of each row.
- ``row_popcounts`` (K8, bitcount.cu): the popcounts of rows row0 ..
  row0 + n_rows of every shard of an int32[S, R, W] stack, each row ANDed
  with each of M in {0, 1, 2} int32[S, W] mask slabs: int32[max(M, 1), S,
  n_rows]. TopN's per-row counts (M = 0, or 1 with a source filter) and
  Sum's plane counts (M = 2: the positive and the negative columns), the
  BSI planes read in place.
- ``bsi_minmax`` (K9, bitcount.cu): the Min/Max plane walk of a BSI stack
  (rows exists, sign, planes), per shard, both branches: int32[2, S,
  depth + 2], branch b's decision bit of plane i at [b, s, i], its final
  count at [b, s, depth] and whether its start had a bit at [b, s, depth +
  1] (``split_minmax`` unpacks it into the JAX program's six outputs).
- ``bsi_compare`` (K10, bitcount.cu): one BSI condition (``==``, ``!=``,
  ``<``, ``<=``, ``>``, ``>=`` or a between) over a BSI stack: the
  condition's slab int32[S, W]. The plain version composes the range
  helpers (``_lt_unsigned`` ...) as the count program's spec evaluator
  does; the kernel runs the same walk from a per-plane action table that
  the host resolves from the predicate's bits (``compare_plan``).
- ``spec_eval`` (K11, spec.cu): a bitmap call tree compiled on the host into
  a postfix program (``spec_program``) over leaf rows, evaluated for Q query
  slots in one launch: per slot, the popcount of the result in every shard
  (count mode, int32[Q, S]) or the result itself (slab mode, int32[Q, S,
  W]). The host's window table (``spec_window``) names each distinct leaf
  row once, so the kernel reads it once for every slot that names it; a
  window past the kernel's caps is cut into launches of whole slots
  (``spec_split``). The single Count, ``Row`` and the batcher's count and
  row windows run on it.
- the group tensor of an N-field GroupBy (K4-K7): for slots q, with m_q the
  AND of one row of each extra field (and of a filter slab),

      out[q, (s,) a, b] = popcount(F[s, a, :] & G[s, b, :] & m_q[s, :])

  ``group_tile_stats`` (K4, bmma.cu, summed over shards, optional filter)
  and ``group_tile_stats_pershard`` (K5, bmma.cu, per shard) take each
  slot's extra rows from an int32[T, E] table and an ``active`` flag per
  slot (an inactive slot is exactly 0); ``nary_stats`` (K6, bmma.cu,
  summed, optional filter) and ``nary_stats_pershard`` (K7, bmma.cu) run
  the full odometer over the extras, slot k decoded in the kernel, last
  extra fastest. All four are instances of one kernel body.

From the pair stats the host derives any two-row verb in O(1):
Intersect = pair, Union = cf + cg - pair, Difference = cf - pair,
Xor = cf + cg - 2 * pair.

Each wrapper takes a tensor on the CPU to its plain version (the CPU tests)
and launches its kernel for a CUDA tensor, on the current stream, counting
the launch in ``launch_counts()``. There is no fallback: a build or launch
failure raises. Words are int32 views of the packed uint32 bits: torch's
``>>`` on int32 is arithmetic, so the plain popcount first widens each word
to its unsigned value in int64.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch

# int32 accumulator bound of the shard-summed pair and group kernels:
# MAX_PAIR_SHARDS * 2^20 < 2^31.
MAX_PAIR_SHARDS = 2047

#: Slots of one group-tile launch: the backend cuts the live combinations
#: of a GroupBy into launches of at most this many slots, which keeps the
#: per-shard tile output (T * S * Rf * Rg int32) under the pair budget.
MAX_GROUP_TILE_SLOTS = 64

#: Extra fields (GroupBy fields past the first two) the group kernels take:
#: their row pointers travel in a fixed table of the launch's parameters.
MAX_GROUP_EXTRAS = 8

#: Launches of each CUDA kernel in this process (CPU calls are not counted);
#: server threads launch concurrently, so counts move under _LAUNCH_LOCK.
_LAUNCH_LOCK = threading.Lock()
_LAUNCHES = {
    "pair_stats_pershard": 0, "pair_stats": 0, "popcount_rows": 0,
    "group_tile_stats": 0, "group_tile_stats_pershard": 0,
    "nary_stats": 0, "nary_stats_pershard": 0,
    "row_popcounts": 0, "bsi_minmax": 0, "bsi_compare": 0, "spec_eval": 0,
}


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Count one launch of kernel `name` and make it on `device` and its
    current stream (the last argument of every entry point): a server's
    handler thread has its own current device, so the tensor's device
    decides, never the thread's."""
    with _LAUNCH_LOCK:
        _LAUNCHES[name] += 1
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check_rc(name, fn(*args, stream))


def pair_stats_width(rf: int, rg: int) -> int:
    """Cells in one row of the flat pair table."""
    return rf * rg + rf + rg


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words, as int64 (SWAR on the word
    widened to its unsigned value, so no sign bit or overflow can reach a
    count)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def popcount_rows_torch(x: torch.Tensor) -> torch.Tensor:
    """int32[N, W] -> int32[N] row popcounts."""
    return popcount32(x).sum(dim=-1, dtype=torch.int64).to(torch.int32)


def row_popcounts_torch(stack: torch.Tensor, row0: int, n_rows: int,
                        masks=()) -> torch.Tensor:
    """Plain K8: int32[max(M, 1), S, n_rows], one row at a time so the
    temporary is S * W words."""
    masks = tuple(masks or ())
    s = stack.shape[0]
    out = torch.zeros((max(len(masks), 1), s, n_rows), dtype=torch.int64,
                      device=stack.device)
    for i in range(n_rows):
        row = stack[:, row0 + i, :]
        for k, m in enumerate(masks or (None,)):
            x = row if m is None else row & m
            out[k, :, i] = popcount32(x).sum(dim=-1, dtype=torch.int64)
    return out.to(torch.int32)


#: Stack rows of a BSI view (reference fragment.go bsiExistsBit,
#: bsiSignBit, bsiOffsetBit).
BSI_EXISTS_ROW, BSI_SIGN_ROW, BSI_PLANE_ROW = 0, 1, 2


def bsi_minmax_torch(stack: torch.Tensor, depth: int, filt=None,
                     kind: str = "min") -> torch.Tensor:
    """Plain K9: the walk of the JAX package's bsi_min / bsi_max program
    body in torch ops, packed as the kernel packs it (int32[2, S, depth +
    2]; see split_minmax)."""
    exists = stack[:, BSI_EXISTS_ROW, :]
    sign = stack[:, BSI_SIGN_ROW, :]
    consider = exists if filt is None else exists & filt

    def pc(x):  # [S, W] -> int64 [S]
        return popcount32(x).sum(dim=-1, dtype=torch.int64)

    s = stack.shape[0]
    out = torch.zeros((2, s, depth + 2), dtype=torch.int64, device=stack.device)
    starts = ((sign & consider) if kind == "min" else (consider & ~sign), consider)
    for b, run in enumerate(starts):
        out[b, :, depth + 1] = (pc(run) > 0).to(torch.int64)
        for i in range(depth - 1, -1, -1):
            plane = stack[:, BSI_PLANE_ROW + i, :]
            row = plane & run if b == 0 else run & ~plane
            nz = pc(row) > 0
            run = torch.where(nz[:, None], row, run)
            out[b, :, i] = (nz if b == 0 else ~nz).to(torch.int64)
        out[b, :, depth] = pc(run)
    return out.to(torch.int32)


def split_minmax(table: torch.Tensor, depth: int):
    """A bsi_minmax table -> the JAX program's six outputs: (bits_a
    bool[S, depth], cnt_a int32[S], bits_b bool[S, depth], cnt_b int32[S],
    branch_any bool[S], consider_any bool[S]); bit i is plane i's."""
    return (table[0, :, :depth] != 0, table[0, :, depth],
            table[1, :, :depth] != 0, table[1, :, depth],
            table[0, :, depth + 1] != 0, table[1, :, depth + 1] != 0)


def _bsi_slabs(block, depth):
    """exists/sign/plane slabs from a stacked BSI view block [S, R, W]."""
    exists = block[:, BSI_EXISTS_ROW, :]
    sign = block[:, BSI_SIGN_ROW, :]
    planes = [block[:, BSI_PLANE_ROW + i, :] for i in range(depth)]
    return exists, sign, planes


# The range helpers below keep the JAX package's control flow line for line
# (pilosa_tpu/exec/tpu.py:1113-1179); its traced predicate bits are host
# ints here, so each of its selects on a bit is a Python branch.


def _lt_unsigned(filt, planes, bits, depth, allow_eq):
    """Port of fragment.rangeLTUnsigned (fragment.go:1440) with the
    documented strict-<0 fix (see core/fragment.py:481)."""
    zeros = torch.zeros_like(filt)
    keep = zeros
    lz = True
    zero_pred = not allow_eq and all(bits[i] == 0 for i in range(depth))
    for i in range(depth - 1, -1, -1):
        plane = planes[i]
        bit = bits[i] != 0
        skip = lz and not bit
        if i == 0 and not allow_eq:
            if zero_pred:
                return zeros
            if skip:
                return filt & ~plane
            return filt & ~(plane & ~keep) if bit else keep
        if skip:
            new_filt = filt & ~plane
        elif bit:
            new_filt = filt
        else:
            new_filt = filt & ~(plane & ~keep)
        if i > 0 and not skip and bit:
            keep = keep | (filt & ~plane)
        filt = new_filt
        lz = lz and not bit
    return zeros if zero_pred else filt


def _gt_unsigned(filt, planes, bits, depth, allow_eq):
    """Port of fragment.rangeGTUnsigned (fragment.go:1471)."""
    keep = torch.zeros_like(filt)
    for i in range(depth - 1, -1, -1):
        plane = planes[i]
        bit = bits[i] != 0
        if i == 0 and not allow_eq:
            return keep if bit else filt & ~((filt & ~plane) & ~keep)
        new_filt = filt & ~((filt & ~plane) & ~keep) if bit else filt
        if i > 0 and not bit:
            keep = keep | (filt & plane)
        filt = new_filt
    return filt


def _between_unsigned(filt, planes, lo_bits, hi_bits, depth):
    """Port of fragment.rangeBetweenUnsigned (fragment.go:1504)."""
    keep1 = torch.zeros_like(filt)
    keep2 = torch.zeros_like(filt)
    for i in range(depth - 1, -1, -1):
        plane = planes[i]
        b1 = lo_bits[i] != 0
        b2 = hi_bits[i] != 0
        new_filt = filt & ~((filt & ~plane) & ~keep1) if b1 else filt
        if i > 0 and not b1:
            keep1 = keep1 | (filt & plane)
        filt = new_filt
        new_filt = filt if b2 else filt & ~(plane & ~keep2)
        if i > 0 and b2:
            keep2 = keep2 | (filt & ~plane)
        filt = new_filt
    return filt


def _eq_slab(exists, sign, planes, bits, depth, neg):
    b = (exists & sign) if neg else (exists & ~sign)
    for i in range(depth - 1, -1, -1):
        b = b & planes[i] if bits[i] != 0 else b & ~planes[i]
    return b


#: The conditions K10 takes: a comparison's operator, or a between's class
#: (the sign of its bounds: both >= 0, both < 0, or one of each).
COMPARE_OPS = ("==", "!=", "<", ">")
BETWEEN_CLASSES = ("pos", "neg", "mixed")


def bsi_compare_torch(stack: torch.Tensor, depth: int, op: str, bits, neg: bool = False,
                      allow_eq: bool = False, hi_bits=None) -> torch.Tensor:
    """Plain K10: the slab int32[S, W] of one BSI condition, the range
    helpers composed as the count program's ``C`` and ``CB`` nodes compose
    them (pilosa_tpu/exec/tpu.py:1243-1277). See bsi_compare."""
    exists, sign, planes = _bsi_slabs(stack, depth)
    if op == "==":
        return _eq_slab(exists, sign, planes, bits, depth, neg)
    if op == "!=":
        return exists & ~_eq_slab(exists, sign, planes, bits, depth, neg)
    if op == "<":
        if not neg:
            pos = _lt_unsigned(exists & ~sign, planes, bits, depth, allow_eq)
            return (sign & exists) | pos
        return _gt_unsigned(exists & sign, planes, bits, depth, allow_eq)
    if op == ">":
        if not neg:
            return _gt_unsigned(exists & ~sign, planes, bits, depth, allow_eq)
        negs = _lt_unsigned(exists & sign, planes, bits, depth, allow_eq)
        return (exists & ~sign) | negs
    # A between; bits are the low bound's magnitude bits.
    if op == "pos":
        return _between_unsigned(exists & ~sign, planes, bits, hi_bits, depth)
    if op == "neg":
        # negative range: magnitudes swap (|hi| <= mag <= |lo|)
        return _between_unsigned(exists & sign, planes, hi_bits, bits, depth)
    pos = _lt_unsigned(exists & ~sign, planes, hi_bits, depth, True)
    negs = _lt_unsigned(exists & sign, planes, bits, depth, True)
    return pos | negs


# K10's action table. Each walk carries a filter f and a keep k per word;
# plane p's action on them is one of these (the kernel's step(), bitcount.cu).
OP_NOP = 0
OP_F_ANDNOT_P = 1   # f &= ~p
OP_F_AND_P = 2      # f &= p
OP_K_OR_F_P = 3     # k |= f & p
OP_K_OR_F_NP = 4    # k |= f & ~p
OP_F_AND_P_K = 5    # f &= p | k
OP_F_AND_NP_K = 6   # f &= ~p | k
OP_F_TAKE_K = 7     # f = k
# The slabs a walk starts from, and the one the result is ORed with.
SLAB_ZERO, SLAB_POS, SLAB_NEG, SLAB_EXISTS = 0, 1, 2, 3
# One walk; a between's two steps a plane on one filter with two keeps;
# two walks on two filters (the mixed between), ORed.
MODE_ONE, MODE_BETWEEN, MODE_TWO = 0, 1, 2


def _lt_ops(bits, depth, allow_eq):
    """_lt_unsigned as plane actions, or None when the strict-<0 fix makes
    its result empty."""
    if not allow_eq and all(bits[i] == 0 for i in range(depth)):
        return None
    ops = [OP_NOP] * depth
    lz = True
    for i in range(depth - 1, -1, -1):
        bit = bits[i] != 0
        skip = lz and not bit
        if i == 0 and not allow_eq:
            # The early return: filt & ~plane, filt & ~(plane & ~keep), keep.
            ops[0] = OP_F_ANDNOT_P if skip else OP_F_AND_NP_K if bit else OP_F_TAKE_K
            break
        if skip:
            ops[i] = OP_F_ANDNOT_P
        elif bit:
            ops[i] = OP_K_OR_F_NP if i > 0 else OP_NOP
        else:
            ops[i] = OP_F_AND_NP_K
        lz = lz and not bit
    return ops


def _gt_ops(bits, depth, allow_eq):
    """_gt_unsigned as plane actions."""
    ops = [OP_NOP] * depth
    for i in range(depth - 1, -1, -1):
        bit = bits[i] != 0
        if i == 0 and not allow_eq:
            ops[0] = OP_F_TAKE_K if bit else OP_F_AND_P_K
        elif bit:
            ops[i] = OP_F_AND_P_K
        elif i > 0:
            ops[i] = OP_K_OR_F_P
    return ops


def _between_ops(lo_bits, hi_bits, depth):
    """_between_unsigned as plane actions: its lo step on (f, k1) in bits
    0-2, its hi step on (f, k2) in bits 3-5."""
    ops = []
    for i in range(depth):
        a = OP_F_AND_P_K if lo_bits[i] else OP_K_OR_F_P if i > 0 else OP_NOP
        b = (OP_K_OR_F_NP if i > 0 else OP_NOP) if hi_bits[i] else OP_F_AND_NP_K
        ops.append(a | b << 3)
    return ops


def compare_plan(depth: int, op: str, bits, neg: bool = False, allow_eq: bool = False,
                 hi_bits=None):
    """The host side of K10: a condition -> (mode, start_a, start_b,
    extra, neq, ops), ops[i] plane i's actions (walk a's in bits 0-2, walk
    b's in bits 3-5). The kernel starts walk a from slab start_a and walk b
    from start_b, applies ops from plane depth - 1 down to 0 and writes
    exists & ~f_a when neq, else f_a | f_b | extra."""
    sign_slab = SLAB_NEG if neg else SLAB_POS
    if op in ("==", "!="):
        ops = [OP_F_AND_P if bits[i] else OP_F_ANDNOT_P for i in range(depth)]
        if op == "==":
            return (MODE_ONE, sign_slab, SLAB_ZERO, SLAB_ZERO, False, ops)
        return (MODE_ONE, sign_slab, SLAB_ZERO, SLAB_EXISTS, True, ops)
    if op in ("<", ">"):
        if (op == "<") == neg:
            # x < -|v| or x > |v|: the greater-than walk over one sign.
            return (MODE_ONE, sign_slab, SLAB_ZERO, SLAB_ZERO, False,
                    _gt_ops(bits, depth, allow_eq))
        # x < |v| or x > -|v|: the other sign whole, plus a less-than walk
        # (an empty one, from no slab, under the strict-<0 fix).
        other = SLAB_POS if neg else SLAB_NEG
        ops = _lt_ops(bits, depth, allow_eq)
        if ops is None:
            return (MODE_ONE, SLAB_ZERO, SLAB_ZERO, other, False, [OP_NOP] * depth)
        return (MODE_ONE, sign_slab, SLAB_ZERO, other, False, ops)
    if op == "pos":
        return (MODE_BETWEEN, SLAB_POS, SLAB_ZERO, SLAB_ZERO, False,
                _between_ops(bits, hi_bits, depth))
    if op == "neg":
        return (MODE_BETWEEN, SLAB_NEG, SLAB_ZERO, SLAB_ZERO, False,
                _between_ops(hi_bits, bits, depth))
    pos, negs = _lt_ops(hi_bits, depth, True), _lt_ops(bits, depth, True)
    return (MODE_TWO, SLAB_POS, SLAB_NEG, SLAB_ZERO, False,
            [a | b << 3 for a, b in zip(pos, negs)])


def pair_stats_torch(f: torch.Tensor, g: torch.Tensor,
                     pershard: bool = True) -> torch.Tensor:
    """Plain form of both pair kernels: the flat table int32[S, D]
    (pershard) or its sum over shards int32[D]. One F row at a time
    against all of G, so the temporary is S * Rg * W words."""
    s, rf, _ = f.shape
    rg = g.shape[1]
    pair = torch.empty((s, rf, rg), dtype=torch.int64, device=f.device)
    for a in range(rf):
        pair[:, a, :] = popcount32(f[:, a : a + 1, :] & g).sum(
            dim=-1, dtype=torch.int64
        )
    cf = popcount32(f).sum(dim=-1, dtype=torch.int64)
    cg = popcount32(g).sum(dim=-1, dtype=torch.int64)
    flat = torch.cat([pair.reshape(s, -1), cf, cg], dim=1)
    if not pershard:
        flat = flat.sum(dim=0)
    return flat.to(torch.int32)


def _slot_mask(extras, rows, filt):
    """m_q: the AND over the extras of each one's row in ``rows`` [S, W],
    ANDed with the filter slab when there is one."""
    m = extras[0][:, rows[0], :]
    for h, r in zip(extras[1:], rows[1:]):
        m = m & h[:, r, :]
    return m if filt is None else m & filt


def _group_slots_torch(f, g, masks, n_slots: int, pershard: bool) -> torch.Tensor:
    """Shared plain body of the group kernels: ``masks`` yields one [S, W]
    slab for each of the n_slots slots, or None for an inactive slot (its
    cells stay 0), one at a time. One F row at a time against all of G, as
    pair_stats_torch, so the temporary is S * Rg * W words. int32[Q, S,
    Rf, Rg], or [Q, Rf, Rg] summed over shards."""
    s, rf, _ = f.shape
    rg = g.shape[1]
    out = torch.zeros((n_slots, s, rf, rg), dtype=torch.int64, device=f.device)
    for q, m in enumerate(masks):
        if m is None:
            continue
        for a in range(rf):
            out[q, :, a, :] = popcount32((f[:, a, :] & m)[:, None, :] & g).sum(
                dim=-1, dtype=torch.int64
            )
    if not pershard:
        out = out.sum(dim=1)
    return out.to(torch.int32)


def _odometer(heights):
    """Row tuples of the extras in slot order: k runs as an odometer over
    the extras' rows, the last extra fastest."""
    import itertools

    return itertools.product(*(range(r) for r in heights))


def _slot_lists(rows_idx, active):
    """The slot table as host lists: each slot's extra rows, and whether
    it is active."""
    rows = torch.as_tensor(rows_idx).to("cpu", torch.int64).tolist()
    act = [a != 0 for a in torch.as_tensor(active).to("cpu", torch.int64).tolist()]
    return rows, act


def group_tile_stats_torch(f, g, extras, rows_idx, active, filt=None):
    """Plain K4: int32[T, Rf, Rg]; slot q ANDs row rows_idx[q, e] of each
    extra e (and filt), inactive slots are 0."""
    rows, act = _slot_lists(rows_idx, active)
    masks = (_slot_mask(extras, r, filt) if a else None for r, a in zip(rows, act))
    return _group_slots_torch(f, g, masks, len(rows), pershard=False)


def group_tile_stats_pershard_torch(f, g, extras, rows_idx, active):
    """Plain K5: int32[T, S, Rf, Rg], unfiltered."""
    rows, act = _slot_lists(rows_idx, active)
    masks = (_slot_mask(extras, r, None) if a else None for r, a in zip(rows, act))
    return _group_slots_torch(f, g, masks, len(rows), pershard=True)


def nary_stats_torch(f, g, extras, filt=None):
    """Plain K6: int32[K, Rf, Rg], K = the product of the extras' heights,
    slot k the odometer over their rows (last extra fastest)."""
    heights = [h.shape[1] for h in extras]
    masks = (_slot_mask(extras, r, filt) for r in _odometer(heights))
    return _group_slots_torch(f, g, masks, _odometer_slots(extras), pershard=False)


def nary_stats_pershard_torch(f, g, extras):
    """Plain K7: int32[K, S, Rf, Rg], unfiltered."""
    heights = [h.shape[1] for h in extras]
    masks = (_slot_mask(extras, r, None) for r in _odometer(heights))
    return _group_slots_torch(f, g, masks, _odometer_slots(extras), pershard=True)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_words(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if t.is_cuda and (t.shape[-1] % 4 or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: the word axis must be a multiple of 4 and 16-byte aligned"
        )


def _plain(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version), False for a CUDA
    tensor (launch the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _check_pair_args(name: str, f: torch.Tensor, g: torch.Tensor) -> None:
    _check_words(name, f, 3)
    _check_words(name, g, 3)
    if f.device != g.device:
        raise ValueError(f"{name}: stacks on {f.device} and {g.device}")
    if not (f.shape[1] and g.shape[1]):
        raise ValueError(f"{name}: a stack has no rows")
    if f.shape[0] != g.shape[0] or f.shape[2] != g.shape[2]:
        raise ValueError(
            f"{name}: stacks disagree: {tuple(f.shape)} vs {tuple(g.shape)}"
        )


#: The library that holds each kernel's entry point.
_LIBRARY = {
    "pair_stats_pershard": "bmma", "pair_stats": "bmma", "popcount_rows": "bitcount",
    "group_tile_stats": "bmma", "group_tile_stats_pershard": "bmma",
    "nary_stats": "bmma", "nary_stats_pershard": "bmma",
    "row_popcounts": "bitcount", "bsi_minmax": "bitcount", "bsi_compare": "bitcount",
    "spec_eval": "spec",
}


def _launch_pair(name: str, f: torch.Tensor, g: torch.Tensor,
                 out: torch.Tensor) -> None:
    from pilosa_tpu_torch.ops.build import library

    s, rf, w = f.shape
    rg = g.shape[1]
    fn = getattr(library(_LIBRARY[name]), name + "_launch")
    _launch(name, f.device, fn, f.data_ptr(), g.data_ptr(), out.data_ptr(),
            s, rf, rg, w)


def pair_stats_pershard(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K1: (int32[S, Rf, W], int32[S, Rg, W]) -> int32[S, Rf*Rg + Rf + Rg]."""
    _check_pair_args("pair_stats_pershard", f, g)
    if _plain("pair_stats_pershard", f):
        return pair_stats_torch(f, g, pershard=True)
    s, rf, _ = f.shape
    rg = g.shape[1]
    # Zeroed: the kernel's word slices add into their shard's row.
    out = torch.zeros((s, pair_stats_width(rf, rg)), dtype=torch.int32,
                      device=f.device)
    if s:
        _launch_pair("pair_stats_pershard", f, g, out)
    return out


def pair_stats(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2: (int32[S, Rf, W], int32[S, Rg, W]) -> int32[Rf*Rg + Rf + Rg],
    summed over shards; requires S <= MAX_PAIR_SHARDS."""
    _check_pair_args("pair_stats", f, g)
    if f.shape[0] > MAX_PAIR_SHARDS:
        raise ValueError(
            f"pair_stats: {f.shape[0]} shards exceed the int32 bound "
            f"{MAX_PAIR_SHARDS}"
        )
    if _plain("pair_stats", f):
        return pair_stats_torch(f, g, pershard=False)
    s, rf, _ = f.shape
    rg = g.shape[1]
    out = torch.zeros(pair_stats_width(rf, rg), dtype=torch.int32,
                      device=f.device)
    if s:
        _launch_pair("pair_stats", f, g, out)
    return out


def popcount_rows(x: torch.Tensor) -> torch.Tensor:
    """K3: int32[N, W] -> int32[N] row popcounts."""
    _check_words("popcount_rows", x, 2)
    if _plain("popcount_rows", x):
        return popcount_rows_torch(x)
    from pilosa_tpu_torch.ops.build import library

    n, w = x.shape
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    if n:
        _launch("popcount_rows", x.device,
                library("bitcount").popcount_rows_launch,
                x.data_ptr(), out.data_ptr(), n, w)
    return out


def _check_group_args(name, f, g, extras, filt=None) -> None:
    _check_pair_args(name, f, g)
    if not extras:
        raise ValueError(f"{name}: needs at least one extra field")
    if len(extras) > MAX_GROUP_EXTRAS:
        raise ValueError(
            f"{name}: {len(extras)} extra fields exceed the kernels' cap "
            f"of {MAX_GROUP_EXTRAS}"
        )
    for h in extras:
        _check_words(name, h, 3)
        _check_beside(name, f, h)
        if not h.shape[1]:
            raise ValueError(f"{name}: an extra stack has no rows")
    if filt is not None:
        _check_words(name, filt, 2)
        _check_beside(name, f, filt)


def _check_beside(name, f, t) -> None:
    """t lies on f's device with f's shard and word axes."""
    if t.device != f.device:
        raise ValueError(f"{name}: inputs on {f.device} and {t.device}")
    if t.shape[0] != f.shape[0] or t.shape[-1] != f.shape[2]:
        raise ValueError(
            f"{name}: {tuple(t.shape)} disagrees with the stacks' {tuple(f.shape)}"
        )


def _slot_table(name, extras, rows_idx, active):
    """The int32[T, E] row table and int32[T] active flags on the host,
    every active slot's rows inside its extra's height."""
    rows = torch.as_tensor(rows_idx).to("cpu", torch.int32).contiguous()
    act = torch.as_tensor(active).to("cpu", torch.int32).contiguous()
    if rows.dim() != 2 or rows.shape[1] != len(extras):
        raise ValueError(
            f"{name}: rows_idx must be [T, {len(extras)}], got {tuple(rows.shape)}"
        )
    if tuple(act.shape) != (rows.shape[0],):
        raise ValueError(f"{name}: active must be [{rows.shape[0]}], got {tuple(act.shape)}")
    heights = torch.tensor([h.shape[1] for h in extras], dtype=torch.int32)
    live = rows[act != 0]
    if bool(((live < 0) | (live >= heights)).any()):
        raise ValueError(f"{name}: a row index lies outside its extra's height")
    return rows, act


def _launch_group(name, f, g, extras, filt, rows, act, out, n_slots) -> None:
    import ctypes

    from pilosa_tpu_torch.ops.build import library

    s, rf, w = f.shape
    rg = g.shape[1]
    lib = library(_LIBRARY[name])
    ptrs = (ctypes.c_void_p * MAX_GROUP_EXTRAS)(*[h.data_ptr() for h in extras])
    heights = (ctypes.c_int * MAX_GROUP_EXTRAS)(*[h.shape[1] for h in extras])
    _launch(
        name, f.device, getattr(lib, name + "_launch"),
        f.data_ptr(), g.data_ptr(), ctypes.addressof(ptrs), ctypes.addressof(heights),
        len(extras),
        None if rows is None else rows.data_ptr(),
        None if act is None else act.data_ptr(),
        None if filt is None else filt.data_ptr(),
        out.data_ptr(), s, rf, rg, w, n_slots,
    )


def _group_out(f, g, n_slots, pershard):
    s, rf, _ = f.shape
    shape = (n_slots, s, f.shape[1], g.shape[1]) if pershard else (n_slots, rf, g.shape[1])
    return torch.zeros(shape, dtype=torch.int32, device=f.device)


def _check_summed_shards(name, f) -> None:
    if f.shape[0] > MAX_PAIR_SHARDS:
        raise ValueError(
            f"{name}: {f.shape[0]} shards exceed the int32 bound {MAX_PAIR_SHARDS}"
        )


def group_tile_stats(f, g, extras, rows_idx, active, filt=None) -> torch.Tensor:
    """K4: (int32[S, Rf, W], int32[S, Rg, W], (int32[S, Rh, W], ...),
    int32[T, E], [T] [, int32[S, W]]) -> int32[T, Rf, Rg], summed over
    shards; requires S <= MAX_PAIR_SHARDS."""
    _check_group_args("group_tile_stats", f, g, extras, filt)
    _check_summed_shards("group_tile_stats", f)
    rows, act = _slot_table("group_tile_stats", extras, rows_idx, active)
    if _plain("group_tile_stats", f):
        return group_tile_stats_torch(f, g, extras, rows, act, filt)
    out = _group_out(f, g, rows.shape[0], pershard=False)
    if out.numel():
        _launch_group("group_tile_stats", f, g, extras, filt, rows.to(f.device),
                      act.to(f.device), out, rows.shape[0])
    return out


def group_tile_stats_pershard(f, g, extras, rows_idx, active) -> torch.Tensor:
    """K5: the same slots per shard, unfiltered -> int32[T, S, Rf, Rg]."""
    _check_group_args("group_tile_stats_pershard", f, g, extras)
    rows, act = _slot_table("group_tile_stats_pershard", extras, rows_idx, active)
    if _plain("group_tile_stats_pershard", f):
        return group_tile_stats_pershard_torch(f, g, extras, rows, act)
    out = _group_out(f, g, rows.shape[0], pershard=True)
    if out.numel():
        _launch_group("group_tile_stats_pershard", f, g, extras, None,
                      rows.to(f.device), act.to(f.device), out, rows.shape[0])
    return out


def _odometer_slots(extras) -> int:
    """K: the product of the extras' heights."""
    k = 1
    for h in extras:
        k *= h.shape[1]
    return k


def nary_stats(f, g, extras, filt=None) -> torch.Tensor:
    """K6: the whole N-field group tensor int32[K, Rf, Rg], K the product
    of the extras' heights, summed over shards; requires S <=
    MAX_PAIR_SHARDS."""
    _check_group_args("nary_stats", f, g, extras, filt)
    _check_summed_shards("nary_stats", f)
    if _plain("nary_stats", f):
        return nary_stats_torch(f, g, extras, filt)
    k = _odometer_slots(extras)
    out = _group_out(f, g, k, pershard=False)
    if out.numel():
        _launch_group("nary_stats", f, g, extras, filt, None, None, out, k)
    return out


def nary_stats_pershard(f, g, extras) -> torch.Tensor:
    """K7: the group tensor per shard, unfiltered -> int32[K, S, Rf, Rg]."""
    _check_group_args("nary_stats_pershard", f, g, extras)
    if _plain("nary_stats_pershard", f):
        return nary_stats_pershard_torch(f, g, extras)
    k = _odometer_slots(extras)
    out = _group_out(f, g, k, pershard=True)
    if out.numel():
        _launch_group("nary_stats_pershard", f, g, extras, None, None, None, out, k)
    return out


def tri_stats(f, g, h, filt=None) -> torch.Tensor:
    """The 3-field group tensor: nary_stats with one extra field ->
    int32[Rh, Rf, Rg]."""
    return nary_stats(f, g, (h,), filt)


#: The widest word axis K9 takes: a shard's cluster of 8 blocks of 256
#: threads holds both running filters in registers, 4 uint4 a thread.
MAX_MINMAX_WORDS = 32768

#: The deepest BSI stack K10 takes: its action table travels in the
#: launch's parameters, one byte a plane.
MAX_COMPARE_DEPTH = 63


def row_popcounts(stack: torch.Tensor, row0: int, n_rows: int,
                  masks=()) -> torch.Tensor:
    """K8: (int32[S, R, W], rows row0 .. row0 + n_rows, M <= 2 int32[S, W]
    masks) -> int32[max(M, 1), S, n_rows]."""
    masks = tuple(masks or ())
    _check_words("row_popcounts", stack, 3)
    if len(masks) > 2:
        raise ValueError(f"row_popcounts: at most 2 masks, got {len(masks)}")
    for m in masks:
        _check_words("row_popcounts", m, 2)
        _check_beside("row_popcounts", stack, m)
    if row0 < 0 or n_rows < 0 or row0 + n_rows > stack.shape[1]:
        raise ValueError(
            f"row_popcounts: rows {row0} .. {row0 + n_rows} outside the stack's "
            f"{stack.shape[1]}"
        )
    if _plain("row_popcounts", stack):
        return row_popcounts_torch(stack, row0, n_rows, masks)
    from pilosa_tpu_torch.ops.build import library

    s, r, w = stack.shape
    out = torch.empty((max(len(masks), 1), s, n_rows), dtype=torch.int32,
                      device=stack.device)
    if out.numel():
        ptrs = [m.data_ptr() for m in masks] + [None] * (2 - len(masks))
        _launch("row_popcounts", stack.device, library("bitcount").row_popcounts_launch,
                stack.data_ptr(), ptrs[0], ptrs[1], out.data_ptr(), len(masks),
                s, r, row0, n_rows, w)
    return out


def bsi_minmax(stack: torch.Tensor, depth: int, filt=None,
               kind: str = "min") -> torch.Tensor:
    """K9: (int32[S, R, W] BSI stack with R >= 2 + depth, optional int32[S,
    W] filter, "min" or "max") -> int32[2, S, depth + 2] (split_minmax)."""
    _check_words("bsi_minmax", stack, 3)
    if kind not in ("min", "max"):
        raise ValueError(f"bsi_minmax: kind must be 'min' or 'max', got {kind!r}")
    if depth < 0 or BSI_PLANE_ROW + depth > stack.shape[1]:
        raise ValueError(
            f"bsi_minmax: depth {depth} needs {BSI_PLANE_ROW + depth} rows, the stack "
            f"has {stack.shape[1]}"
        )
    if filt is not None:
        _check_words("bsi_minmax", filt, 2)
        _check_beside("bsi_minmax", stack, filt)
    if _plain("bsi_minmax", stack):
        return bsi_minmax_torch(stack, depth, filt, kind)
    if stack.shape[2] > MAX_MINMAX_WORDS:
        raise ValueError(
            f"bsi_minmax: {stack.shape[2]} words exceed the kernel's {MAX_MINMAX_WORDS}"
        )
    from pilosa_tpu_torch.ops.build import library

    s, r, w = stack.shape
    out = torch.empty((2, s, depth + 2), dtype=torch.int32, device=stack.device)
    if s:
        _launch("bsi_minmax", stack.device, library("bitcount").bsi_minmax_launch,
                stack.data_ptr(), None if filt is None else filt.data_ptr(),
                out.data_ptr(), 0 if kind == "min" else 1, s, r, depth, w)
    return out


def bsi_compare(stack: torch.Tensor, depth: int, op: str, bits, neg: bool = False,
                allow_eq: bool = False, hi_bits=None) -> torch.Tensor:
    """K10: (int32[S, R, W] BSI stack with R >= 2 + depth, one condition)
    -> the condition's slab int32[S, W]. ``op`` is a comparison, "==",
    "!=", "<" or ">" (``bits`` the predicate's magnitude bits, ``neg`` its
    sign, ``allow_eq`` for <= and >=), or a between's class, "pos", "neg"
    or "mixed" (``bits`` the low bound's magnitude bits, ``hi_bits`` the
    high bound's). Bits are host ints, plane i's at [i]."""
    _check_words("bsi_compare", stack, 3)
    if op not in COMPARE_OPS + BETWEEN_CLASSES:
        raise ValueError(f"bsi_compare: unknown condition {op!r}")
    if depth < 0 or depth > MAX_COMPARE_DEPTH or BSI_PLANE_ROW + depth > stack.shape[1]:
        raise ValueError(
            f"bsi_compare: depth {depth} needs {BSI_PLANE_ROW + depth} rows (at most "
            f"{MAX_COMPARE_DEPTH} planes), the stack has {stack.shape[1]}"
        )
    between = op in BETWEEN_CLASSES
    if len(bits) < depth or (between and (hi_bits is None or len(hi_bits) < depth)):
        raise ValueError(f"bsi_compare: the predicate needs {depth} bits")
    if _plain("bsi_compare", stack):
        return bsi_compare_torch(stack, depth, op, bits, neg, allow_eq, hi_bits)
    import ctypes

    from pilosa_tpu_torch.ops.build import library

    mode, start_a, start_b, extra, neq, ops = compare_plan(depth, op, bits, neg, allow_eq,
                                                           hi_bits)
    table = (ctypes.c_uint8 * (MAX_COMPARE_DEPTH + 1))(*ops)
    s, r, w = stack.shape
    out = torch.empty((s, w), dtype=torch.int32, device=stack.device)
    if out.numel():
        _launch("bsi_compare", stack.device, library("bitcount").bsi_compare_launch,
                stack.data_ptr(), out.data_ptr(), ctypes.addressof(table), mode, start_a,
                start_b, extra, int(neq), s, r, depth, w)
    return out


# ---------------------------------------------------------------------------
# K11: the spec-tree evaluator
# ---------------------------------------------------------------------------

#: K11's limits: a program's leaf table travels in the launch's parameters,
#: and its stack lives in registers, one uint4 a level. A tree past either
#: is split by spec_program into sub-programs evaluated first (slab leaves).
MAX_SPEC_LEAVES = 16
MAX_SPEC_DEPTH = 8
#: Per-slot entries that travel in the launch's parameters (Q * leaves);
#: more go to the card as a table of their own.
SPEC_INLINE_ROWS = 256
#: The distinct leaf rows (entries) and the slots one launch of K11's
#: window body takes: each entry's 4 KiB tile sits in shared memory, in a
#: ring of up to two buffers that each also hold a zero tile, beside a
#: 20-byte row a slot (2 x 25 x 4 KiB + 512 x 20 B of a block's 227 KiB).
#: spec_split cuts a window past either into launches of whole slots.
MAX_SPEC_ENTRIES = 24
MAX_SPEC_SLOTS = 512
#: K11's bodies (spec.cu): one block a (slot, chunk), each slot loading its
#: own leaves, or one block a tile of every slot, each entry staged once
#: (spec_body chooses). Two variants of the window body, which chip_smoke.py
#: times against it and no served launch takes: every program walked leaf by
#: leaf (no fold kernels), and a fold's kernel over its run-time leaf count
#: (no exact unrolling).
SPEC_BODY_SLOT, SPEC_BODY_WINDOW, SPEC_BODY_WALK, SPEC_BODY_FOLD_N = 0, 1, 2, 3
#: A program's ops: i < MAX_SPEC_LEAVES pushes leaf i; these pop b, then a,
#: and push a op b.
SPEC_AND, SPEC_OR, SPEC_ANDNOT, SPEC_XOR = 0x80, 0x81, 0x82, 0x83
_SPEC_VERBS = {"I": SPEC_AND, "U": SPEC_OR, "D": SPEC_ANDNOT, "X": SPEC_XOR}


class SpecProgram(NamedTuple):
    """A spec tree compiled for K11: ``ops`` the postfix program, ``leaves``
    one descriptor a leaf in push order, ``depth`` the stack it needs.

    A leaf descriptor names where the leaf comes from among the call's
    blocks b and scalars s, in the order the backend's _build emits them:

    - ("row", b, s): row scalars[s] of stack blocks[b], or the zero leaf
      when the mask scalars[s + 1] is 0 (``R``, and each view of ``T``);
    - ("fixed", b, r): row r of blocks[b] in every slot (``A``: the
      existence row; ``NN``: the BSI exists row);
    - ("zero", b): the zero leaf (``E``; blocks[b] carries only a shape);
    - ("cmp", b, s, node): the slab of BSI condition ``node`` (``C`` or
      ``CB``) over stack blocks[b] with its bits at scalars[s:], by K10;
    - ("shift", n, prog): the slab of sub-program ``prog``, shifted by n
      (``S``);
    - ("sub", prog): the slab of sub-program ``prog``, a part of a tree past
      MAX_SPEC_LEAVES or MAX_SPEC_DEPTH.

    The last three are slab leaves, which depend on a slot's scalars: a
    program that holds one runs one slot a launch (``per_slot``)."""

    ops: tuple
    leaves: tuple
    depth: int

    @property
    def per_slot(self) -> bool:
        return any(leaf[0] in ("cmp", "shift", "sub") for leaf in self.leaves)


def _spec_leaf(desc) -> SpecProgram:
    return SpecProgram((0,), (desc,), 1)


def _spec_combine(a: SpecProgram, b: SpecProgram, op: int) -> SpecProgram:
    n = len(a.leaves)
    ops = a.ops + tuple(o + n if o < MAX_SPEC_LEAVES else o for o in b.ops) + (op,)
    return SpecProgram(ops, a.leaves + b.leaves, max(a.depth, b.depth + 1))


def _spec_fits(p: SpecProgram) -> bool:
    return len(p.leaves) <= MAX_SPEC_LEAVES and p.depth <= MAX_SPEC_DEPTH


def _spec_fold(progs, op: int) -> SpecProgram:
    """The left fold ((p0 op p1) op p2) ... that _eval_spec evaluates,
    splitting what does not fit: a child too big to sit beside anything
    becomes a sub-program leaf, and when the fold so far and the next child
    do not fit together, the fold so far does."""
    acc = progs[0]
    for p in progs[1:]:
        cand = _spec_combine(acc, p, op)
        if not _spec_fits(cand):
            if len(p.leaves) > MAX_SPEC_LEAVES - 1 or p.depth > MAX_SPEC_DEPTH - 1:
                p = _spec_leaf(("sub", p))
            cand = _spec_combine(acc, p, op)
            if not _spec_fits(cand):
                cand = _spec_combine(_spec_leaf(("sub", acc)), p, op)
        acc = cand
    return acc


def _spec_compile(node, b: int, s: int):
    """(program, next block index, next scalar index) of one spec node,
    walking blocks and scalars as the backend's _build emitted them."""
    tag = node[0]
    if tag == "R":
        return _spec_leaf(("row", b, s)), b + 1, s + 2
    if tag == "T":  # a time range: the OR of its views' rows
        views = [_spec_leaf(("row", b + k, s + 2 * k)) for k in range(node[2])]
        return _spec_fold(views, SPEC_OR), b + node[2], s + 2 * node[2]
    if tag == "A":
        return _spec_leaf(("fixed", b, 0)), b + 1, s
    if tag == "NN":
        return _spec_leaf(("fixed", b, BSI_EXISTS_ROW)), b + 1, s
    if tag == "E":
        return _spec_leaf(("zero", b)), b + 1, s
    if tag == "N":  # the existence row ANDNOT the child
        child, b2, s2 = _spec_compile(node[1], b + 1, s)
        return _spec_fold([_spec_leaf(("fixed", b, 0)), child], SPEC_ANDNOT), b2, s2
    if tag == "C":
        return _spec_leaf(("cmp", b, s, node)), b + 1, s + 1
    if tag == "CB":
        return _spec_leaf(("cmp", b, s, node)), b + 1, s + 2
    if tag == "S":
        child, b2, s2 = _spec_compile(node[2], b, s)
        return _spec_leaf(("shift", node[1], child)), b2, s2
    progs = []
    for ch in node[1]:
        p, b, s = _spec_compile(ch, b, s)
        progs.append(p)
    return _spec_fold(progs, _SPEC_VERBS[tag]), b, s


@functools.lru_cache(maxsize=1024)
def spec_program(spec) -> SpecProgram:
    """The K11 program of a spec tree of the device backend's _build
    (``R``, ``T``, ``A``, ``N``, ``E``, ``NN``, ``C``, ``CB``, ``S`` and the
    verbs ``U``, ``I``, ``D``, ``X``): its leaves in push order, every
    program and sub-program within MAX_SPEC_LEAVES and MAX_SPEC_DEPTH."""
    return _spec_compile(spec, 0, 0)[0]


def spec_leaf_rows(prog: SpecProgram, scalars) -> list:
    """One slot's row of each leaf of ``prog`` (-1: the zero leaf; 0 for a
    slab leaf) from the call's scalars."""
    rows = []
    for leaf in prog.leaves:
        kind = leaf[0]
        if kind == "row":
            s = leaf[2]
            rows.append(int(scalars[s]) if scalars[s + 1] else -1)
        elif kind == "fixed":
            rows.append(leaf[2])
        elif kind == "zero":
            rows.append(-1)
        else:
            rows.append(0)
    return rows


def _spec_check(ops, leaves, rows):
    """Validate a K11 call; returns (rows as lists, S, W)."""
    name = "spec_eval"
    if not 1 <= len(leaves) <= MAX_SPEC_LEAVES:
        raise ValueError(f"{name}: {len(leaves)} leaves; K11 takes 1 to {MAX_SPEC_LEAVES}")
    for t in leaves:
        if t.dim() not in (2, 3):
            raise ValueError(f"{name}: a leaf must be [S, R, W] or [S, W], got "
                             f"{tuple(t.shape)}")
        _check_words(name, t, t.dim())
        if t.device != leaves[0].device:
            raise ValueError(f"{name}: leaves on {leaves[0].device} and {t.device}")
        if t.shape[0] != leaves[0].shape[0] or t.shape[-1] != leaves[0].shape[-1]:
            raise ValueError(f"{name}: leaves disagree: {tuple(leaves[0].shape)} vs "
                             f"{tuple(t.shape)}")
    depth, pushed = 0, 0
    for op in ops:
        if op < MAX_SPEC_LEAVES:
            if op != pushed:
                raise ValueError(f"{name}: leaf {op} pushed out of order (expected {pushed})")
            pushed += 1
            depth += 1
            if depth > MAX_SPEC_DEPTH:
                raise ValueError(f"{name}: the program needs a stack past {MAX_SPEC_DEPTH}")
        elif op in (SPEC_AND, SPEC_OR, SPEC_ANDNOT, SPEC_XOR):
            if depth < 2:
                raise ValueError(f"{name}: op {op:#x} on a stack of {depth}")
            depth -= 1
        else:
            raise ValueError(f"{name}: unknown op {op!r}")
    if depth != 1 or pushed != len(leaves):
        raise ValueError(f"{name}: the program leaves {depth} values and pushes "
                         f"{pushed} of {len(leaves)} leaves")
    rows = [[int(r) for r in slot] for slot in rows]
    for slot in rows:
        if len(slot) != len(leaves):
            raise ValueError(f"{name}: a slot names {len(slot)} rows for {len(leaves)} leaves")
        for r, t in zip(slot, leaves):
            height = t.shape[1] if t.dim() == 3 else 1
            if not -1 <= r < height:
                raise ValueError(f"{name}: row {r} outside a leaf of {height} rows")
    return rows, leaves[0].shape[0], leaves[0].shape[-1]


def _entry_key(leaves, i: int, r: int):
    """Leaves that are one object share their rows' entries."""
    return id(leaves[i]), r


def spec_window(leaves, rows):
    """K11's window table of slots ``rows`` [Q][leaf] (-1: the zero leaf)
    over ``leaves``: (the distinct entries, as (leaf i, row r) in order of
    first use, r >= 0; per slot and leaf the index of its entry, -1 for the
    zero leaf). Leaves that are the same object share entries, so each
    distinct row is staged once for every slot that names it."""
    first: dict = {}
    entries: list = []
    index: list = []
    for slot in rows:
        idx = []
        for i, r in enumerate(slot):
            if r < 0:
                idx.append(-1)
                continue
            key = _entry_key(leaves, i, r)
            e = first.get(key)
            if e is None:
                e = first[key] = len(entries)
                entries.append((i, r))
            idx.append(e)
        index.append(idx)
    return entries, index


def spec_split(leaves, rows, max_entries: int = MAX_SPEC_ENTRIES,
               max_slots: int = MAX_SPEC_SLOTS):
    """The launches of a window, as [(q0, q1)]: runs of whole slots, in
    order, each naming at most ``max_entries`` distinct entries and holding
    at most ``max_slots`` slots (a slot alone names at most MAX_SPEC_LEAVES
    <= max_entries)."""
    spans: list = []
    seen: set = set()
    q0 = 0
    for q, slot in enumerate(rows):
        keys = {_entry_key(leaves, i, r) for i, r in enumerate(slot) if r >= 0}
        if q > q0 and (q - q0 == max_slots or len(seen | keys) > max_entries):
            spans.append((q0, q))
            seen, q0 = set(), q
        seen |= keys
    if len(rows) > q0:
        spans.append((q0, len(rows)))
    return spans


def spec_eval_torch(ops, leaves, rows, mode: str = "count") -> torch.Tensor:
    """Plain K11: the program run with torch ops, one slot at a time:
    int32[Q, S] per-shard counts ("count") or the slabs int32[Q, S, W]
    ("slab")."""
    s, w = leaves[0].shape[0], leaves[0].shape[-1]
    out = []
    for slot in rows:
        stack = []
        for op in ops:
            if op < MAX_SPEC_LEAVES:
                t, r = leaves[op], slot[op]
                if r < 0:
                    v = torch.zeros((s, w), dtype=torch.int32, device=t.device)
                else:
                    v = t[:, r, :] if t.dim() == 3 else t
                stack.append(v)
                continue
            b = stack.pop()
            a = stack.pop()
            if op == SPEC_AND:
                stack.append(a & b)
            elif op == SPEC_OR:
                stack.append(a | b)
            elif op == SPEC_ANDNOT:
                stack.append(a & ~b)
            else:
                stack.append(a ^ b)
        res = stack.pop()
        out.append(popcount32(res).sum(dim=-1, dtype=torch.int64).to(torch.int32)
                   if mode == "count" else res.contiguous())
    if not out:
        shape = (0, s) if mode == "count" else (0, s, w)
        return torch.zeros(shape, dtype=torch.int32, device=leaves[0].device)
    return torch.stack(out)


@functools.lru_cache(maxsize=1024)
def spec_is_fold(ops: tuple) -> bool:
    """Whether a program folds its leaves left to right with one op (leaf
    0, then each further leaf followed by that op): Intersect, Union,
    Difference or Xor of rows, a time range, a lone row. The window body
    runs these as kernels of their own (spec.cu window_shape)."""
    n = (len(ops) + 1) // 2
    return (len(ops) == 2 * n - 1 and all(ops[2 * i - 1] == i for i in range(1, n))
            and len({ops[2 * i] for i in range(1, n)}) <= 1)


def spec_body(ops, q: int, mode: str) -> int:
    """The body a launch of q slots of program ``ops`` runs in ``mode``:
    the window body, but for one slot of a program other than a fold, or
    of one leaf counted (a condition Count), which the per-slot body runs
    faster on an H100 (chip_smoke.py times both)."""
    if q == 1 and (not spec_is_fold(tuple(ops)) or (len(ops) == 1 and mode == "count")):
        return SPEC_BODY_SLOT
    return SPEC_BODY_WINDOW


def spec_launch_args(ops, leaves, rows, out: torch.Tensor, mode: str, body: int):
    """(the ctypes arguments of one spec_eval_launch, bar the stream, over
    slots ``rows`` (within spec_split's caps) into ``out``; the objects
    they point into, which the caller keeps alive until the launch is
    enqueued)."""
    import ctypes

    entries, index = spec_window(leaves, rows)
    q, n, ne = len(rows), len(leaves), len(entries)
    s, w = leaves[0].shape[0], leaves[0].shape[-1]
    w4 = w // 4
    bases = (ctypes.c_void_p * max(ne, 1))(
        *[leaves[i].data_ptr() + r * w4 * 16 for i, r in entries])
    strides = (ctypes.c_longlong * max(ne, 1))(
        *[(leaves[i].shape[1] if leaves[i].dim() == 3 else 1) * w4 for i, _ in entries])
    prog = (ctypes.c_uint8 * len(ops))(*ops)
    flat = [e for slot in index for e in slot]
    slots_host = (ctypes.c_int * len(flat))(*flat)
    slots_dev = None
    if len(flat) > SPEC_INLINE_ROWS:
        slots_dev = torch.tensor(flat, dtype=torch.int32).to(out.device)
    args = (ctypes.addressof(bases), ctypes.addressof(strides), ne, ctypes.addressof(prog),
            len(ops), n, ctypes.addressof(slots_host),
            None if slots_dev is None else slots_dev.data_ptr(),
            out.data_ptr() if mode == "count" else None,
            out.data_ptr() if mode == "slab" else None,
            0 if mode == "count" else 1, body, q, s, w)
    return args, (bases, strides, prog, slots_host, slots_dev)


def spec_eval(ops, leaves, rows, mode: str = "count") -> torch.Tensor:
    """K11: (postfix ``ops``, ``leaves`` int32[S, R, W] stacks or [S, W]
    slabs, per-slot ``rows`` [Q][leaf] with -1 for the zero leaf) ->
    int32[Q, S] per-shard popcounts of each slot's result ("count"), or the
    results int32[Q, S, W] ("slab"). Leaves are pushed in order, each once
    (spec_program's programs are). On the card, one launch for each run of
    slots spec_split cuts the window into."""
    if mode not in ("count", "slab"):
        raise ValueError(f"spec_eval: mode must be 'count' or 'slab', got {mode!r}")
    leaves = tuple(leaves)
    rows, s, w = _spec_check(tuple(ops), leaves, rows)
    if _plain("spec_eval", leaves[0]):
        return spec_eval_torch(ops, leaves, rows, mode)
    from pilosa_tpu_torch.ops.build import library

    dev = leaves[0].device
    q = len(rows)
    out = torch.empty((q, s) if mode == "count" else (q, s, w), dtype=torch.int32, device=dev)
    if not out.numel():
        return out
    fn = library(_LIBRARY["spec_eval"]).spec_eval_launch
    ops = tuple(ops)
    for q0, q1 in spec_split(leaves, rows):
        part = out if q1 - q0 == q else out[q0:q1]
        args, keep = spec_launch_args(ops, leaves, rows[q0:q1], part, mode,
                                      spec_body(ops, q1 - q0, mode))
        _launch("spec_eval", dev, fn, *args)
        del keep
    return out
