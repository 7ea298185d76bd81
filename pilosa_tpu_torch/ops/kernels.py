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

import threading

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
    "row_popcounts": 0, "bsi_minmax": 0, "bsi_compare": 0,
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
