"""A numpy model of the CUDA gathers' work map (``csrc/dequant_gather.cu``).

The kernel cannot run on the CPU, so this file models what each of its
threads does, step by step, and holds the model to the references: the grid
of ``launch_tasks`` (``repro::grid_for``), the lane-task map (task t =
row * ceil(d/4) + l, row found by ``FastDiv``'s multiply-high), the bytes a
lane loads (a whole word on the aligned path, single bytes up to the row's
last needed byte otherwise), the shift pair that sign-extends each code, the
fp32 multiply by Delta, and where each lane stores.  For every shape of the
GPU test (d 13, 15, 16, 32, 576; bits 8, 4, 2; 1, 7, 777 and 24,576 ids, the
last at d <= 32) it checks that every output element is written exactly
once, that no lane reads outside its id's row, and that the model is bitwise
equal to ``ref.dequant_gather(_packed)_ref`` and to the JAX package's
``ops.dequant_gather`` (run with ``use_kernel=True``, as
tests/test_torch_kernels.py runs it; tolerance 0).

The block size is read from the CUDA source; the card's SM count, which
caps the grid, is a parameter of the model.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codestore as jcs
from repro.kernels import ops as jops
from repro_torch.core import codestore as pcs
from repro_torch.kernels import ref as pref

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
BLOCK = int(re.search(r"constexpr int kThreads = (\d+);", (CSRC / "common.cuh").read_text())[1])
assert "<<<repro::grid_for(p.tasks), repro::kThreads" in (CSRC / "dequant_gather.cu").read_text()
H100_SMS = 132  # an H100 SXM; other cards hold fewer
NAN_BITS = 0x7FC00000


def fast_div(divisor: int) -> tuple[int, int]:
    """``fast_div`` of the source: (magic, shift) for t // divisor."""
    shift = 0
    while (1 << shift) < divisor:
        shift += 1
    return (1 << 32) * ((1 << shift) - divisor) // divisor + 1, shift


def divide(t: np.ndarray, magic: int, shift: int) -> np.ndarray:
    """The kernel's row: (umulhi(t, magic) + t) >> shift, all uint32."""
    t = t.astype(np.uint64)
    hi = (t * np.uint64(magic)) >> np.uint64(32)
    return ((hi + t) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)


def plan(d: int, b: int, bits: int, codes_offset: int = 0, out_offset: int = 0,
         sms: int = H100_SMS):
    """``launch_gather`` / ``launch_tasks`` on a card of ``sms`` SMs:
    (lanes, tasks, vec, grid), the grid capped at one resident wave of
    2048 threads per SM (``repro::grid_for``)."""
    lanes = -(-d // 4)
    tasks = b * lanes
    vec = d % 4 == 0 and out_offset % 16 == 0 and codes_offset % (bits // 2) == 0
    return lanes, tasks, vec, min(-(-tasks // BLOCK), sms * (2048 // BLOCK))


def thread_tasks(tasks: int, grid: int):
    """Every (thread, sweep) of the grid-stride loop that stores: the global
    thread index, the sweep and its task t."""
    gtid = np.arange(grid * BLOCK, dtype=np.int64)
    stride = grid * BLOCK
    out = []
    sweep = 0
    while sweep * stride < tasks:
        t = gtid + sweep * stride
        keep = t < tasks
        out.append(np.stack([gtid[keep], np.full(keep.sum(), sweep), t[keep]], axis=1))
        sweep += 1
    return np.concatenate(out) if out else np.zeros((0, 3), np.int64)


def model_gather(table: np.ndarray, step: np.ndarray, ids: np.ndarray, bits: int, d: int,
                 codes_offset: int = 0, out_offset: int = 0, sms: int = H100_SMS):
    """The kernel's output, how often each element was written, and the byte
    offsets (into the table) that its lanes read, with the id of each read."""
    n, width = table.shape
    assert width == -(-d * bits // 8)
    lanes, tasks, vec, grid = plan(d, len(ids), bits, codes_offset, out_offset, sms)
    magic, shift = fast_div(lanes)
    t = thread_tasks(tasks, grid)[:, 2]
    row = divide(t, magic, shift).astype(np.int64)
    lane = t - row * lanes
    ident = ids[row].astype(np.int64)
    n_ok = min(n, 2 ** 31)
    ok = (ident & 0xFFFFFFFF) < n_ok  # the id as uint32 against n capped at 2^31
    flat = table.reshape(-1).view(np.uint8)
    src = np.where(ok, ident, 0) * width + lane * (bits // 2)
    c = np.minimum(4, d - 4 * lane)
    nbytes = np.full_like(c, bits // 2) if vec else (c * bits + 7) // 8
    word = np.zeros(len(t), np.uint64)
    reads, read_ids = [], []
    for k in range(bits // 2):
        take = ok & (k < nbytes)
        word[take] |= flat[src[take] + k].astype(np.uint64) << np.uint64(8 * k)
        reads.append(src[take] + k)
        read_ids.append(ident[take])
    delta = np.where(ok, step[np.where(ok, ident, 0)],
                     np.array(NAN_BITS, np.uint32).view(np.float32))
    out = np.zeros(len(ids) * d, np.float32)
    count = np.zeros(len(ids) * d, np.int64)
    for k in range(4):
        field = (word << np.uint64(32 - bits * (k + 1))) & np.uint64(0xFFFFFFFF)
        q = field.astype(np.uint32).view(np.int32) >> (32 - bits)
        v = q.astype(np.float32) * delta.astype(np.float32)
        if vec:
            at = 4 * t + k  # the float4 store at out + 16t
            keep = np.ones(len(t), bool)
        else:
            at = row * d + 4 * lane + k
            keep = k < c
        out[at[keep]] = v[keep]
        np.add.at(count, at[keep], 1)
    return (out.reshape(len(ids), d), count.reshape(len(ids), d), np.concatenate(reads),
            np.concatenate(read_ids))


def _operands(d: int, b: int, bits: int, n: int = 1000, seed: int = 0):
    rng = np.random.RandomState(seed + 7 * d + b + bits)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rng.randint(lo, hi + 1, (n, d)).astype(np.int8)
    step = rng.uniform(1e-3, 1e-1, n).astype(np.float32)
    ids = rng.randint(0, n, b).astype(np.int32)
    # The last row (which ends the table), the first, and a duplicate.
    ids[:min(b, 4)] = np.array([n - 1, 0, 3, 3], np.int32)[:min(b, 4)]
    return codes, step, ids


def _table(codes: np.ndarray, bits: int) -> np.ndarray:
    if bits == 8:
        return codes
    return pcs.pack_codes(torch.from_numpy(codes), bits).numpy()


def _reference(codes, step, ids, bits, d):
    if bits == 8:
        return pref.dequant_gather_ref(torch.from_numpy(codes), torch.from_numpy(step),
                                       torch.from_numpy(ids)).numpy()
    store = pcs.CodeStore.from_codes(torch.from_numpy(codes), bits)
    return pref.dequant_gather_packed_ref(store.data, torch.from_numpy(step),
                                          torch.from_numpy(ids), bits=bits, d=d).numpy()


def _jax_reference(codes, step, ids, bits):
    table = jnp.asarray(codes) if bits == 8 else jcs.CodeStore.from_codes(jnp.asarray(codes),
                                                                           bits)
    return np.asarray(jops.dequant_gather(table, jnp.asarray(step), jnp.asarray(ids),
                                          use_kernel=True))


SHAPES = [(d, b) for d in (13, 15, 16, 32, 576) for b in (1, 7, 777, 24_576)
          if not (d == 576 and b == 24_576)]


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d,b", SHAPES)
def test_model_writes_each_output_once_and_equals_the_references(d, b, bits):
    codes, step, ids = _operands(d, b, bits)
    table = _table(codes, bits)
    out, count, reads, read_ids = model_gather(table, step, ids, bits, d)
    assert (count == 1).all()
    width = table.shape[1]
    # Every byte a lane reads lies in its own id's row: the row of n - 1
    # ends the table, and nothing past it is touched.
    assert ((reads >= read_ids * width) & (reads < (read_ids + 1) * width)).all()
    want = _reference(codes, step, ids, bits, d)
    np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(out.view(np.uint32),
                                  _jax_reference(codes, step, ids, bits).view(np.uint32))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 32, 576])
def test_unaligned_operands_take_the_byte_path_with_the_same_rows(d, bits):
    # An operand one byte (codes) or four bytes (out) off its alignment
    # turns the word loads and float4 stores off; the rows stay the same.
    codes, step, ids = _operands(d, 777, bits)
    table = _table(codes, bits)
    aligned = model_gather(table, step, ids, bits, d)[0]
    offsets = [(0, 4)] if bits == 2 else [(1, 0), (0, 4)]
    for codes_offset, out_offset in offsets:
        assert plan(d, 777, bits)[2] and not plan(d, 777, bits, codes_offset, out_offset)[2]
        out, count, reads, read_ids = model_gather(table, step, ids, bits, d, codes_offset,
                                                   out_offset)
        assert (count == 1).all()
        width = table.shape[1]
        assert ((reads >= read_ids * width) & (reads < (read_ids + 1) * width)).all()
        np.testing.assert_array_equal(out.view(np.uint32), aligned.view(np.uint32))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [13, 16, 576])
def test_out_of_range_ids_give_nan_rows_and_read_nothing(d, bits):
    codes, step, ids = _operands(d, 9, bits, n=50)
    ids[[1, 4, 6]] = [50, -1, 2 ** 31 - 1]
    table = _table(codes, bits)
    out, count, _, read_ids = model_gather(table, step, ids, bits, d)
    assert (count == 1).all()
    bad = np.isin(np.arange(9), [1, 4, 6])
    assert np.isnan(out[bad]).all()
    assert ((read_ids >= 0) & (read_ids < 50)).all()
    good = ids[~bad]
    np.testing.assert_array_equal(out[~bad], _reference(codes, step, good, bits, d))


@pytest.mark.parametrize("d", [4, 8, 16, 32, 576])
def test_a_warp_stores_contiguous_16_byte_chunks(d):
    # On the aligned path each store instruction of a warp (one sweep of the
    # loop) writes its lanes' 16 bytes side by side: 512 contiguous bytes.
    lanes, tasks, vec, grid = plan(d, 777, 8)
    assert vec
    work = thread_tasks(tasks, grid)
    key = (work[:, 0] >> 5) * 64 + work[:, 1]
    order = np.lexsort((work[:, 0], key))
    key, t = key[order], work[order, 2]
    same = key[1:] == key[:-1]
    assert (t[1:][same] - t[:-1][same] == 1).all()
    sizes = np.unique(key, return_counts=True)[1]
    assert (sizes <= 32).all() and (sizes < 32).sum() <= 1


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16])
@pytest.mark.parametrize("bits,d,b", [(8, 16, 24_576), (4, 15, 777), (2, 576, 157),
                                      (8, 32, 4_429), (4, 32, 70_000)])
def test_the_grid_stride_loop_writes_each_output_once(bits, d, b, sms):
    # The grid is capped at one resident wave of the card (132 SMs on an
    # H100 SXM, 114 on the PCIe card, 16 as a small one); 70,000 ids of 8
    # lanes pass that cap on each, and on 16 SMs so does the CTR wave, so
    # the loop strides.
    codes, step, ids = _operands(d, b, bits)
    table = _table(codes, bits)
    out, count, _, _ = model_gather(table, step, ids, bits, d, sms=sms)
    assert (count == 1).all()
    np.testing.assert_array_equal(out.view(np.uint32),
                                  _reference(codes, step, ids, bits, d).view(np.uint32))


@pytest.mark.parametrize("divisors", [range(1, 1025), [144, 4_095, 4_097, 65_535, 65_537,
                                                       1_000_003, 2 ** 20 + 1, 2 ** 30 - 1,
                                                       2 ** 30, 2 ** 31 - 1]])
def test_fast_div_equals_integer_division(divisors):
    rng = np.random.RandomState(1)
    for divisor in divisors:
        magic, shift = fast_div(divisor)
        assert 0 < magic < 2 ** 32
        top = 2 ** 31 - 1
        edges = np.array([0, 1, divisor - 1, divisor, top, top - 1], np.int64)
        near = (top // divisor) * divisor + np.arange(-2, 2)
        t = np.concatenate([edges, near, rng.randint(0, top, 200)])
        t = t[(t >= 0) & (t <= top)]
        np.testing.assert_array_equal(divide(t, magic, shift), t // divisor)
