"""The port's popcount kernels (pilosa_tpu_torch/ops/kernels.py) against
the JAX package's Pallas kernels.

On the CPU every wrapper takes its plain PyTorch version, so these tests
hold the plain versions (the reference the CUDA kernels are compared with
on the card) against pair_stats_pershard / pair_stats in Pallas interpret
mode and against pair_stats_xla. All outputs are integers: equality is
exact. tests/test_torch_cuda.py holds the CUDA kernels against these plain
versions on the card.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from pilosa_tpu.ops.kernels import pair_stats as jax_pair_stats
from pilosa_tpu.ops.kernels import pair_stats_pershard as jax_pair_stats_pershard
from pilosa_tpu.ops.kernels import pair_stats_xla
from pilosa_tpu_torch.carry import stack_from_reference
from pilosa_tpu_torch.ops import kernels as K


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain kernels' tensors here are small: one intra-op thread does
    their work in a fraction of the CPU time, which counts where test files
    run side by side. The process's setting is restored after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W = 32768

# (shards, Rf, Rg): the main path's square 8 x 8 pair, Rf != Rg both ways,
# a tile edge (Rg not a multiple of the CUDA kernel's 8-row tile), S = 1;
# faces off the tensor-core K2's m16 and n8 sub-tiles on its staged route.
SHAPES = [(2, 8, 8), (3, 8, 16), (2, 16, 8), (2, 8, 12), (1, 8, 8), (2, 40, 24),
          (1, 17, 130)]
# (shards, Rf, Rg, words): word axes that are not a multiple of the
# tensor-core K2's 8-word k-chunk or of its 32-word stage, on both of its
# routes (Rf <= 16 and Rg <= 8 load registers directly; larger faces stage).
SHORT_WORD_SHAPES = [(2, 40, 24, 36), (1, 17, 130, 100), (3, 16, 8, 36), (2, 8, 8, 36),
                     (1, 1, 1, 4)]


def _stacks(seed, s, rf, rg, w=W):
    """uint32 stacks with row 0 all zeros and the last row all ones, the
    rest random at bit density 1/16 (the AND of four random words)."""
    rng = np.random.default_rng(seed)

    def one(r):
        words = rng.integers(0, 2**32, (4, s, r, w), dtype=np.uint32)
        words = np.bitwise_and.reduce(words, axis=0)
        words[:, 0, :] = 0
        words[:, -1, :] = 0xFFFFFFFF
        return words

    return one(rf), one(rg)


def _jax_flat(pair, cf, cg, pershard):
    pair, cf, cg = (np.asarray(x).astype(np.int64) for x in (pair, cf, cg))
    if pershard:
        s = pair.shape[0]
        return np.concatenate(
            [pair.reshape(s, -1), cf.reshape(s, -1), cg.reshape(s, -1)], axis=1
        )
    return np.concatenate([pair.ravel(), cf.ravel(), cg.ravel()])


@pytest.mark.parametrize("s,rf,rg", SHAPES)
def test_pair_stats_pershard_matches_pallas(s, rf, rg):
    f, g = _stacks(s * 100 + rf + rg, s, rf, rg)
    got = K.pair_stats_pershard(stack_from_reference(f, "cpu"),
                                stack_from_reference(g, "cpu"))
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (s, K.pair_stats_width(rf, rg))
    want = _jax_flat(*jax_pair_stats_pershard(f, g, interpret=True), True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s,rf,rg", SHAPES)
def test_pair_stats_summed_matches_pallas_and_xla(s, rf, rg):
    f, g = _stacks(s * 200 + rf + rg, s, rf, rg)
    got = K.pair_stats(stack_from_reference(f, "cpu"), stack_from_reference(g, "cpu"))
    assert tuple(got.shape) == (K.pair_stats_width(rf, rg),)
    np.testing.assert_array_equal(
        got.numpy(), _jax_flat(*jax_pair_stats(f, g, interpret=True), False)
    )
    np.testing.assert_array_equal(got.numpy(), _jax_flat(*pair_stats_xla(f, g), False))


@pytest.mark.parametrize("s,rf,rg,w", SHORT_WORD_SHAPES)
def test_pair_stats_short_word_axes_match_pallas(s, rf, rg, w):
    f, g = _stacks(s * 300 + rf + rg + w, s, rf, rg, w)
    ft, gt = stack_from_reference(f, "cpu"), stack_from_reference(g, "cpu")
    np.testing.assert_array_equal(
        K.pair_stats(ft, gt).numpy(),
        _jax_flat(*jax_pair_stats(f, g, interpret=True), False))
    np.testing.assert_array_equal(
        K.pair_stats_pershard(ft, gt).numpy(),
        _jax_flat(*jax_pair_stats_pershard(f, g, interpret=True), True))


def test_pair_table_layout():
    f, g = _stacks(7, 2, 8, 16)
    flat = K.pair_stats_pershard(stack_from_reference(f, "cpu"),
                                 stack_from_reference(g, "cpu"))
    pair = flat[:, : 8 * 16].reshape(2, 8, 16)
    cf, cg = flat[:, 8 * 16 : 8 * 16 + 8], flat[:, 8 * 16 + 8 :]
    jp, jf, jg = (np.asarray(x) for x in jax_pair_stats_pershard(f, g, interpret=True))
    np.testing.assert_array_equal(pair.numpy(), jp)
    np.testing.assert_array_equal(cf.numpy(), jf.reshape(2, 8))
    np.testing.assert_array_equal(cg.numpy(), jg.reshape(2, 16))
    # Zero row: no bits and no pairs; all-ones row: every bit.
    assert (cf[:, 0] == 0).all() and (pair[:, 0, :] == 0).all()
    assert (cf[:, -1] == W * 32).all()
    np.testing.assert_array_equal(pair[:, -1, :].numpy(), cg.numpy())


def test_popcount_rows_matches_numpy_and_jax():
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(11)
    x = rng.integers(0, 2**32, (12, W), dtype=np.uint32)
    x[0] = 0
    x[1] = 0xFFFFFFFF
    x[2] = 0x80000000  # the sign bit alone: int32 >> is arithmetic
    got = K.popcount_rows(torch.from_numpy(x.view(np.int32)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (12,)
    want_np = np.bitwise_count(x).sum(axis=-1)
    want_jax = np.asarray(jnp.sum(lax.population_count(jnp.asarray(x)), -1,
                                  dtype=jnp.int32))
    np.testing.assert_array_equal(got.numpy(), want_np)
    np.testing.assert_array_equal(got.numpy(), want_jax)
    assert got[1] == W * 32 and got[2] == W


def test_popcount32_every_bit_position():
    words = np.array([1 << i for i in range(32)] + [0, 0xFFFFFFFF, 0x55555555],
                     dtype=np.uint32)
    got = K.popcount32(torch.from_numpy(words.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.bitwise_count(words))


@pytest.mark.parametrize(
    "bad,err",
    [
        (lambda f, g: (f.to(torch.int64), g), TypeError),  # dtype
        (lambda f, g: (f[:, :, :-4], g), ValueError),  # word axes disagree
        (lambda f, g: (f[:1], g), ValueError),  # shard axes disagree
        (lambda f, g: (f.transpose(1, 2), g), ValueError),  # dims / contiguity
        (lambda f, g: (f[:, :, ::2], g[:, :, ::2]), ValueError),  # contiguity
        (lambda f, g: (f[:, :0], g), ValueError),  # no rows
    ],
)
def test_pair_wrappers_reject_bad_inputs(bad, err):
    f = torch.zeros((2, 8, 64), dtype=torch.int32)
    g = torch.zeros((2, 8, 64), dtype=torch.int32)
    a, b = bad(f, g)
    with pytest.raises(err):
        K.pair_stats_pershard(a, b)
    with pytest.raises(err):
        K.pair_stats(a, b)


def test_pair_stats_refuses_past_int32_shard_bound():
    f = torch.zeros((K.MAX_PAIR_SHARDS + 1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32 bound"):
        K.pair_stats(f, f)
    # The per-shard table has no such bound.
    assert K.pair_stats_pershard(f, f).shape == (K.MAX_PAIR_SHARDS + 1, 3)


def test_popcount_rows_rejects_bad_inputs():
    with pytest.raises(TypeError):
        K.popcount_rows(torch.zeros((2, 8), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.popcount_rows(torch.zeros((2, 8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.popcount_rows(torch.zeros((8, 2), dtype=torch.int32).t())


def test_row_popcounts_and_bsi_minmax_reject_bad_inputs():
    x = torch.zeros((2, 8, 64), dtype=torch.int32)
    m = torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 2 masks"):
        K.row_popcounts(x, 0, 8, (m, m, m))
    with pytest.raises(ValueError, match="outside"):
        K.row_popcounts(x, 4, 5)
    with pytest.raises(ValueError):
        K.row_popcounts(x, 0, 8, (torch.zeros((3, 64), dtype=torch.int32),))
    with pytest.raises(ValueError, match="needs 9 rows"):
        K.bsi_minmax(x, 7)
    with pytest.raises(ValueError, match="kind"):
        K.bsi_minmax(x, 2, None, "sum")


def test_bsi_compare_rejects_bad_inputs():
    x = torch.zeros((2, 8, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs 9 rows"):
        K.bsi_compare(x, 7, "==", (0,) * 7)
    with pytest.raises(ValueError, match="unknown condition"):
        K.bsi_compare(x, 2, "<=", (0, 1))
    with pytest.raises(ValueError, match="needs 3 bits"):
        K.bsi_compare(x, 3, ">", (0, 1))
    with pytest.raises(ValueError, match="needs 2 bits"):
        K.bsi_compare(x, 2, "mixed", (0, 1))  # a between without its high bound
    deep = torch.zeros((1, 2 + 64, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 63 planes"):
        K.bsi_compare(deep, 64, "==", (0,) * 64)
    with pytest.raises(TypeError):
        K.bsi_compare(x.to(torch.int64), 2, "==", (0, 1))


def test_cpu_calls_launch_nothing():
    K.reset_launch_counts()
    x = torch.zeros((2, 8, 64), dtype=torch.int32)
    K.pair_stats_pershard(x, x)
    K.pair_stats(x, x)
    K.popcount_rows(x[0])
    K.group_tile_stats(x, x, (x,), [[1]], [1], x[:, 0].contiguous())
    K.group_tile_stats_pershard(x, x, (x,), [[1]], [1])
    K.nary_stats(x, x, (x,), x[:, 0].contiguous())
    K.nary_stats_pershard(x, x, (x,))
    K.row_popcounts(x, 1, 3, (x[:, 0].contiguous(),))
    K.bsi_minmax(x, 4, x[:, 1].contiguous(), "max")
    K.bsi_compare(x, 4, "<", (1, 0, 1, 0), allow_eq=True)
    K.spec_eval((0, 1, K.SPEC_AND), (x, x[:, 0].contiguous()), [[1, 0], [-1, 0]])
    assert K.launch_counts() == {
        "pair_stats_pershard": 0, "pair_stats": 0, "popcount_rows": 0,
        "group_tile_stats": 0, "group_tile_stats_pershard": 0,
        "nary_stats": 0, "nary_stats_pershard": 0,
        "row_popcounts": 0, "bsi_minmax": 0, "bsi_compare": 0, "spec_eval": 0,
    }


class _StubLibrary:
    """A stand-in for a loaded ctypes library: every attribute is a plain
    object on which ``_bind`` can set argtypes and restype."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.fns.setdefault(name, types.SimpleNamespace())


def _entry_points(source_path):
    """{name: [ctypes type of each parameter]} of the ``extern "C" int``
    functions of a kernel source: c_void_p for a pointer, c_int otherwise."""
    with open(source_path) as fh:
        src = fh.read()
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\s*\(([^)]*)\)', src):
        out[name] = [ctypes.c_void_p if "*" in p else ctypes.c_int
                     for p in " ".join(params.split()).split(",")]
    return out


@pytest.mark.parametrize("name", sorted(K._LIBRARY))
def test_kernel_entry_point_is_defined_and_bound(name):
    """The library _LIBRARY names for a kernel defines its C entry point,
    and _bind gives it argtypes matching the C parameters, so no pointer
    goes through ctypes as a 32-bit int."""
    from pilosa_tpu_torch.ops import build

    lib_name = K._LIBRARY[name]
    entries = _entry_points(build.SOURCES[lib_name])
    assert name + "_launch" in entries, (name, lib_name)
    stub = _StubLibrary()
    build._bind(lib_name, stub)
    fn = stub.fns[name + "_launch"]
    assert fn.argtypes == entries[name + "_launch"]
    assert fn.restype is ctypes.c_int


def test_every_kernel_source_is_built():
    """build.SOURCES names exactly the .cu files of ops/csrc: no source is
    left unbuilt, and no library is built from a file that is gone."""
    import glob
    import os

    from pilosa_tpu_torch.ops import build

    on_disk = glob.glob(os.path.join(os.path.dirname(build.__file__), "csrc", "*.cu"))
    assert sorted(build.SOURCES.values()) == sorted(on_disk)
    assert set(K._LIBRARY.values()) == set(build.SOURCES)


@pytest.mark.parametrize("lib_name", ["bitcount", "bmma", "spec", "expand", "splice"])
def test_bind_covers_exactly_the_entry_points_of_each_source(lib_name):
    """_bind binds every entry point a source defines and nothing else (a
    stale name would fail the real library's load), each with argtypes
    matching its C parameters."""
    from pilosa_tpu_torch.ops import build

    entries = _entry_points(build.SOURCES[lib_name])
    stub = _StubLibrary()
    build._bind(lib_name, stub)
    assert set(stub.fns) == set(entries)
    for fn_name, argtypes in entries.items():
        assert stub.fns[fn_name].argtypes == argtypes, fn_name


def test_launch_floor_needs_a_card():
    """The launch floor's no-op kernel (ops/probe.py noop) is a CUDA card's:
    asked for on the CPU it refuses before loading any library."""
    from pilosa_tpu_torch.ops import probe

    with pytest.raises(ValueError, match="CUDA card"):
        probe.noop(device="cpu")
