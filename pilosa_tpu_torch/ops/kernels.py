"""Popcount kernels of the count and GroupBy paths, each with its plain
PyTorch version.

Hand-written CUDA kernels, built by ops/build.py: the pair kernels and the
group-tensor kernels on the tensor cores' binary MMA (ops/csrc/bmma.cu), and
the popcount-reduce of the count path on the CUDA cores
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

#: Launches of each CUDA kernel in this process (CPU calls are not counted).
_LAUNCHES = {
    "pair_stats_pershard": 0, "pair_stats": 0, "popcount_rows": 0,
    "group_tile_stats": 0, "group_tile_stats_pershard": 0,
    "nary_stats": 0, "nary_stats_pershard": 0,
}


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


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
}


def _launch_pair(name: str, f: torch.Tensor, g: torch.Tensor,
                 out: torch.Tensor) -> None:
    from pilosa_tpu_torch.ops.build import library

    s, rf, w = f.shape
    rg = g.shape[1]
    fn = getattr(library(_LIBRARY[name]), name + "_launch")
    stream = torch.cuda.current_stream(f.device).cuda_stream
    _LAUNCHES[name] += 1
    _check_rc(name, fn(f.data_ptr(), g.data_ptr(), out.data_ptr(),
                       s, rf, rg, w, stream))


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
        lib = library("bitcount")
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _LAUNCHES["popcount_rows"] += 1
        _check_rc("popcount_rows",
                  lib.popcount_rows_launch(x.data_ptr(), out.data_ptr(), n, w,
                                           stream))
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
    stream = torch.cuda.current_stream(f.device).cuda_stream
    _LAUNCHES[name] += 1
    _check_rc(name, getattr(lib, name + "_launch")(
        f.data_ptr(), g.data_ptr(), ctypes.addressof(ptrs), ctypes.addressof(heights),
        len(extras),
        None if rows is None else rows.data_ptr(),
        None if act is None else act.data_ptr(),
        None if filt is None else filt.data_ptr(),
        out.data_ptr(), s, rf, rg, w, n_slots, stream,
    ))


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
