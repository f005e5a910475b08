"""latticefold_torch's counterparts of the TPU probes P1-P5
(rings/plane_probes.py, and kernel A's modes in rings/plane_commit.py)
against numpy int64 references, on the CPU, where each function runs its
kernel's plain version. The probes' bench scripts are not imported (they
reconfigure JAX when imported); their kernels' functions are restated here
in numpy. The kernels themselves run only on the card, where chip_smoke.py
holds them against these plain versions at the TPU shapes.

Tolerance: exact equality (0) -- every value is an integer (the bf16 probe's
float32 sums are integers below 2^24). The bf16 probe is also held against
its TPU kernel's function in JAX (``k_dot_bf``'s dot, restated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticefold_torch.rings import plane_commit as tpc
from latticefold_torch.rings import plane_probes as pp

C, M, K, L = 2, 32, 300, 20  # a ragged K and a word count not a multiple of 16


@pytest.fixture(scope="module")
def dot_inputs():
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, size=(C, M, K)).astype(np.int8)
    w = rng.integers(0, 1 << 32, size=(C, K, L), dtype=np.uint64).astype(np.uint32)
    return a, w


def np_planes(w, fake=False):
    """The probes' planes: kern_v2 (XOR 0x80808080, then each byte as int8,
    column = byte L + word) or kern_dot_only's fake planes (the low byte of
    each word, four times)."""
    if fake:
        return np.concatenate([w.astype(np.uint8).view(np.int8)] * 4, axis=-1).astype(np.int64)
    x = w ^ np.uint32(0x80808080)
    parts = [((x >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8) for b in range(4)]
    return np.concatenate(parts, axis=-1).astype(np.int64)


def t32(w):
    return torch.from_numpy(w.view(np.int32).copy())


def test_v1_and_v2_planes_are_one_function(dot_inputs):
    """kern_v1 ((byte - 128) as int8) and kern_v2 (XOR, truncating cast)
    give the same planes, so one kernel mode serves both."""
    _, w = dot_inputs
    v1 = np.concatenate([((w >> (8 * b)) & 0xFF).astype(np.int64) - 128 for b in range(4)], axis=-1)
    assert np.array_equal(v1, np_planes(w))
    assert np.array_equal(tpc._signed_planes(t32(w), "full").numpy(), v1)


@pytest.mark.parametrize("kmajor", [False, True])
def test_plane_dot_full_matches_int64(dot_inputs, kmajor):
    a, w = dot_inputs
    want = np.einsum("cmk,ckn->cmn", a.astype(np.int64), np_planes(w))
    lhs = np.ascontiguousarray(a.transpose(0, 2, 1)) if kmajor else a
    got = tpc.plane_dot(torch.from_numpy(lhs), t32(w), kmajor=kmajor)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    # the same function on int64 limb lanes, the commit's witness layout
    got64 = tpc.plane_dot(torch.from_numpy(lhs), torch.from_numpy(w.astype(np.int64)), kmajor=kmajor)
    assert torch.equal(got64, got)


def test_plane_dot_planes_only_matches_int64(dot_inputs):
    a, w = dot_inputs
    want = np.zeros((C, M, 4 * L), dtype=np.int64)
    want[:, 0] = np_planes(w).sum(axis=1)
    got = tpc.plane_dot(torch.from_numpy(a), t32(w), "planes_only")
    assert np.array_equal(got.numpy(), want)


def test_plane_dot_dot_only_matches_int64(dot_inputs):
    a, w = dot_inputs
    want = np.einsum("cmk,ckn->cmn", a.astype(np.int64), np_planes(w, fake=True))
    got = tpc.plane_dot(torch.from_numpy(a), t32(w), "dot_only")
    assert np.array_equal(got.numpy(), want)


def test_dma_checksum_matches_int64(dot_inputs):
    a, w = dot_inputs
    want = (a.reshape(C, -1).astype(np.int64).sum(1) + w.reshape(C, -1).astype(np.int64).sum(1)) % (1 << 32)
    got = pp.dma_checksum(torch.from_numpy(a), t32(w))
    assert np.array_equal(got.numpy(), want)
    # the layout of A does not change the checksum (P2's and P3's DMA rows)
    at = np.ascontiguousarray(a.transpose(0, 2, 1))
    assert torch.equal(pp.dma_checksum(torch.from_numpy(at), t32(w)), got)


@pytest.mark.parametrize("shape,dtype", [
    ((256, 2048, 256), np.int8),  # probe_i8exact
    ((256, 2048, 256), np.uint8),
    ((8, 1 << 15, 128), np.int8),  # probe_i8exact at the commit's K
    ((128, 256, 128), np.uint8),  # exp_pallas_probe dot_u8
])
def test_int_gemm_matches_int64(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    lo, hi = (-128, 128) if dtype == np.int8 else (0, 256)
    a = rng.integers(lo, hi, size=(m, k)).astype(dtype)
    b = rng.integers(lo, hi, size=(k, n)).astype(dtype)
    got = pp.int_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_bf16_gemm_of_u8_is_exact_at_k128():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 255, size=(128, 128)).astype(np.uint8)
    b = rng.integers(0, 255, size=(128, 128)).astype(np.uint8)
    got = pp.bf16_gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy().astype(np.int64), a.astype(np.int64) @ b.astype(np.int64))


def k_dot_bf(a, b):
    """The body of ``k_dot_bf`` (benches/exp_pallas_probe.py:70-88), restated:
    the u8 blocks cast to bf16, one dot with float32 accumulation."""
    return jax.lax.dot_general(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
                               (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)


@pytest.mark.parametrize("m,k,n,full", [
    (128, 128, 128, False),  # dot_u8_via_bf16's shape
    (72, 200, 40, False),  # ragged: rows of neither operand a 16-byte multiple
    (128, 256, 128, True),  # all 255 at K 256: sums 16646400, near 2^24
])
def test_bf16_gemm_matches_jax_dot_general(m, k, n, full):
    """``bf16_gemm`` and its first design's wrapper (off the card both run
    ``bf16_gemm_plain``) against the TPU probe's function in JAX, float32
    bits."""
    rng = np.random.default_rng(m + k + n)
    a = np.full((m, k), 255, np.uint8) if full else rng.integers(0, 256, size=(m, k)).astype(np.uint8)
    b = np.full((k, n), 255, np.uint8) if full else rng.integers(0, 256, size=(k, n)).astype(np.uint8)
    want = np.asarray(k_dot_bf(a, b))
    assert want.dtype == np.float32
    for fn in (pp.bf16_gemm, pp.bf16_gemm_mma):
        got = fn(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fn", [pp.bf16_gemm, pp.bf16_gemm_mma], ids=["bf16_gemm", "bf16_gemm_mma"])
def test_bf16_gemm_refuses_k_past_exact_float32(fn):
    """Above K 258 a float32 sum of u8 products can pass 2^24 and round: the
    wrappers refuse it, here as on the card."""
    k = pp.BF16_K_MAX
    ok = fn(torch.full((2, k), 255, dtype=torch.uint8), torch.full((k, 2), 255, dtype=torch.uint8))
    assert int(ok[0, 0]) == 255 * 255 * k < 1 << 24
    with pytest.raises(ValueError, match="exact"):
        fn(torch.zeros((2, k + 1), dtype=torch.uint8), torch.zeros((k + 1, 2), dtype=torch.uint8))


def test_bf16_byte_rows_take_every_view_the_cpu_takes():
    """The card's launcher wants rows of contiguous bytes at least a row
    apart: ``_byte_rows`` passes such views as they are (a stride along a
    dimension of size 1 is never read) and copies the rest, so the card
    takes every operand the CPU's plain version takes."""
    base = torch.arange(64, dtype=torch.int64).to(torch.uint8)
    cases = [
        (base.view(8, 8), False, 8),  # contiguous
        (base.view(4, 16)[:, :8], False, 16),  # rows 16 bytes apart
        (base[:8].view(1, 8).t(), False, 1),  # [K, 1] view of a row: stride 8 along its size-1 dimension
        (base[:8].view(8, 1).t(), False, 8),  # [1, K] view of a column
        (base.view(8, 8).t(), True, 8),  # column-major
        (base[:8].view(1, 8).expand(4, 8), True, 8),  # rows 0 bytes apart
    ]
    for x, copied, ld in cases:
        y, got_ld = pp._byte_rows(x)
        assert torch.equal(y, x) and (y.data_ptr() != x.data_ptr()) == copied and got_ld == ld
        assert y.stride(1) == 1 or y.shape[1] == 1


@pytest.mark.parametrize("m,k,n", [(3, 0, 4), (0, 5, 4), (3, 5, 0)])
def test_bf16_gemm_of_an_empty_product(m, k, n):
    """An empty product is zeros of its shape on every device (the card's
    wrapper returns them without a launch)."""
    for fn in (pp.bf16_gemm, pp.bf16_gemm_plain):
        got = fn(torch.zeros((m, k), dtype=torch.uint8), torch.zeros((k, n), dtype=torch.uint8))
        assert got.dtype == torch.float32 and got.shape == (m, n) and not got.any()


def test_bitcast_and_merge_are_byte_exact():
    """Both designs' wrappers (the vector copy and the first design, off the
    card their plain versions) at the probe shapes and a size with a tail."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 1 << 32, size=(8, 128), dtype=np.uint64).astype(np.uint32)
    odd = rng.integers(0, 1 << 32, size=(3, 7), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, size=(8, 16, 4), dtype=np.uint64).astype(np.uint32)
    for bitcast, merge in ((pp.bitcast_u8, pp.merge_minor), (pp.bitcast_u8_v1, pp.merge_minor_v1)):
        assert np.array_equal(bitcast(t32(x)).numpy(), x.view(np.uint8).reshape(8, 512))
        assert np.array_equal(bitcast(t32(odd)).numpy(), odd.view(np.uint8).reshape(3, 28))
        assert np.array_equal(merge(t32(y)).numpy().view(np.uint32), y.reshape(8, 64))
        assert np.array_equal(merge(t32(odd.reshape(3, 7, 1))).numpy().view(np.uint32), odd)


def test_gemm_refuses_mixed_types():
    with pytest.raises(ValueError, match="int8 or uint8"):
        pp.int_gemm(torch.zeros((2, 2), dtype=torch.int8), torch.zeros((2, 2), dtype=torch.uint8))


@pytest.mark.parametrize("kmajor", [False, True])
def test_plane_dot_mma_baseline_refuses_planes_only(dot_inputs, kmajor):
    """``plane_dot_mma``, the mma.sync baseline that chip_smoke.py times in
    turns with the Hopper dot, takes the full and dot-only modes only:
    ``planes_only`` stays ``plane_dot``'s."""
    a, w = dot_inputs
    lhs = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1)) if kmajor else a)
    with pytest.raises(ValueError, match="no mode"):
        tpc.plane_dot_mma(lhs, t32(w), "planes_only", kmajor)


@pytest.mark.parametrize("m,k,n,groups,width,splits", [
    (256, 2048, 256, 4, 64, 8),  # P4 i8exact: groups of 64, eight splits
    (8, 1 << 15, 128, 1, 8, 64),  # M = 8: one n = 8 group, the most splits
    (1728, 1 << 15, 384, 9, 192, 4),  # P4 dotspeed: 27 tiles, four splits
    (1728, 1 << 15, 1536, 9, 192, 1),  # 108 tiles fill the card: no split
    (128, 256, 128, 2, 64, 1),  # P5 dot_u8: K too short to split
    (600, 4096, 64, 4, 192, 16),  # above _GEMM_SMALL_M: the fewest groups of at most 192
])
def test_gemm_plan(m, k, n, groups, width, splits):
    """The Hopper GEMM's plan at 132 SMs (an H100's): row groups, their width
    and the K splits; a split K keeps tiles x splits within one wave, which
    the once-allocated workspace and counters rely on."""
    assert pp.gemm_groups(m) == (groups, width)
    tiles = groups * -(-n // 128)
    ks = pp.gemm_split_k(tiles, k, 132)
    assert ks == splits
    assert ks == 1 or tiles * ks <= 132
    assert pp._gemm_plan(m, n, k, 132) == (width, splits)


@pytest.mark.parametrize("rows,cols,offset", [(5, 90, 0), (4, 48, 0), (3, 32, 1)])
def test_tma_rows_gives_16_byte_rows_with_the_same_values(rows, cols, offset):
    """``_tma_rows`` hands the Hopper GEMM an operand whose rows start 16
    bytes apart at a 16-byte aligned pointer, with that pointer and row
    stride: the tensor itself where it already is so, else a copy of its
    values."""
    x = torch.arange(rows * cols + offset, dtype=torch.uint8)[offset:].view(rows, cols)
    y, p, s0 = pp._tma_rows(x)
    assert (p, s0) == (y.data_ptr(), y.stride(0))
    assert torch.equal(y, x) and y.stride(1) == 1 and y.stride(0) % 16 == 0 and y.data_ptr() % 16 == 0
    assert (y.data_ptr() == x.data_ptr()) == (cols % 16 == 0 and x.data_ptr() % 16 == 0)
