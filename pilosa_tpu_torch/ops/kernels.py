"""Popcount kernels of the count path, each with its plain PyTorch version.

Three hand-written CUDA kernels (ops/csrc/bitcount.cu, built by ops/build.py):

- ``pair_stats_pershard`` (K1): per shard s, over int32[S, Rf, W] and
  int32[S, Rg, W] stacks,

      pair[s, a, b] = popcount(F[s, a, :] & G[s, b, :])
      cf[s, a]      = popcount(F[s, a, :])
      cg[s, b]      = popcount(G[s, b, :])

  returned as one flat int32[S, Rf*Rg + Rf + Rg] table, each row laid out
  ``[pair.ravel() | cf | cg]``. Per-shard counts are <= 2^20, so int32 is
  exact for any shard count.
- ``pair_stats`` (K2): the same stats summed over shards, int32[D]. Exact
  while S <= MAX_PAIR_SHARDS (S * 2^20 < 2^31).
- ``popcount_rows`` (K3): int32[N, W] -> int32[N], the popcount of each row.

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

# int32 accumulator bound of the shard-summed pair kernel:
# MAX_PAIR_SHARDS * 2^20 < 2^31.
MAX_PAIR_SHARDS = 2047

#: Launches of each CUDA kernel in this process (CPU calls are not counted).
_LAUNCHES = {"pair_stats_pershard": 0, "pair_stats": 0, "popcount_rows": 0}


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


def _launch_pair(name: str, f: torch.Tensor, g: torch.Tensor,
                 out: torch.Tensor) -> None:
    from pilosa_tpu_torch.ops.build import library

    s, rf, w = f.shape
    rg = g.shape[1]
    lib = library()
    fn = getattr(lib, name + "_launch")
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
    out = torch.empty((s, pair_stats_width(rf, rg)), dtype=torch.int32,
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
        lib = library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _LAUNCHES["popcount_rows"] += 1
        _check_rc("popcount_rows",
                  lib.popcount_rows_launch(x.data_ptr(), out.data_ptr(), n, w,
                                           stream))
    return out
