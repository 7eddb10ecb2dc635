"""The CTR row step's work map (``csrc/sparse_row_update.cu``) as a numpy
model, and the row step with the duplicate-id sum folded in against its
parts and against the JAX package.

The kernels cannot run on the CPU, so this file models what their threads
do: the g_sum form's lane tasks (task t = slot * ceil(d/4) + l, the slot by
``FastDiv``'s multiply-high, one resident wave of blocks at most and a
grid-stride loop past it) and the runs form's tiles (a block per 16 slots,
the tile's range of ``order`` staged in chunks of 1,536 pieces, each live
lane adding its run from the stage).  For both it checks that every
(live slot, column) is written exactly once, that dead slots (a repeated id
or one outside the table) read no row state and write a zero ``w_new`` row,
that each run is walked in occurrence order and each lookup's row staged
once, that the code bytes (pad bits zero) and the sums are bitwise those of
the plain versions, and that ``fast_div`` is integer division.

Then, bitwise (tolerance 0): ``dedup_runs`` + ``sparse_row_update_runs
(_packed)_ref`` against ``segment_sum`` + ``sparse_row_update(_packed)_ref``
over bits, widths, weight decay and both sentinels, with a run of more than
400 lookups; and the port's ``lpt.sparse_apply`` with ``use_kernels=True``
against the JAX package's jitted ``sparse_apply`` on live rows and real slots.
"""
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codestore as jcs
from repro.core import lpt as jlpt
from repro.core import quant as jq
from repro_torch.core import codestore as pcs
from repro_torch.core import lpt as plpt
from repro_torch.kernels import ops as pops
from repro_torch.kernels import ref as pref

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
SOURCE = (CSRC / "sparse_row_update.cu").read_text()
BLOCK = int(re.search(r"constexpr int kThreads = (\d+);", (CSRC / "common.cuh").read_text())[1])
STAGE = int(re.search(r"constexpr uint32_t kStage = (\d+);", SOURCE)[1])
TILE = int(re.search(r"constexpr uint32_t kTileSlots = (\d+);", SOURCE)[1])
assert "kPieces = kStage / repro::kThreads" in SOURCE and STAGE % BLOCK == 0
assert "std::min(repro::kThreads / p.tile_lanes, kTileSlots)" in SOURCE
assert "row_kernel<BITS, VEC><<<repro::grid_for(p.tasks), repro::kThreads" in SOURCE
H100_SMS = 132
f32 = np.float32


def fast_div(divisor: int) -> tuple[int, int]:
    """``repro::fast_div``: (magic, shift) for t // divisor."""
    shift = 0
    while (1 << shift) < divisor:
        shift += 1
    return (1 << 32) * ((1 << shift) - divisor) // divisor + 1, shift


def divide(t, magic: int, shift: int) -> np.ndarray:
    """``repro::divide``: (umulhi(t, magic) + t) >> shift, all uint32."""
    t = np.asarray(t).astype(np.uint64)
    hi = (t * np.uint64(magic)) >> np.uint64(32)
    return (((hi + t) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)).astype(np.int64)


# ---------------------------------------------------------------------------
# Operands: a CTR-like wave with repeats, one long run and the sentinels.
# ---------------------------------------------------------------------------


def _wave(seed: int, n_live: int, m: int, long_run: int = 0, rows: int | None = None):
    """int32 ids [m] in [0, n_live) with zipf repeats (and ``long_run``
    lookups of one id spread over the wave), the last live row included."""
    rs = np.random.RandomState(seed)
    ids = (np.minimum(rs.zipf(1.3, m), n_live) - 1).astype(np.int32)
    ids[0] = n_live - 1
    if long_run:
        at = rs.choice(np.arange(1, m), long_run, replace=False)
        ids[at] = n_live // 2
    return ids


def _state(seed: int, n: int, d: int, bits: int, m: int):
    rs = np.random.RandomState(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rs.randint(lo, hi + 1, (n, d)).astype(np.int8)
    step = rs.uniform(1e-3, 0.05, n).astype(f32)
    mu = (rs.randn(n, d) * 0.01).astype(f32)
    nu = (rs.rand(n, d) * 1e-3).astype(f32)
    g_occ = (rs.randn(m, d) * rs.lognormal(0, 2, (m, 1)) * 0.1).astype(f32)
    g_occ[rs.rand(m, d) < 0.02] = -0.0  # sums that start at +0.0 stay +0.0
    noise = rs.rand(m, d).astype(f32)
    return codes, step, mu, nu, g_occ, noise


def _dedup(ids, sentinel):
    return tuple(x.numpy() for x in plpt.dedup_runs(torch.from_numpy(ids), sentinel))


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------


def _live(uniq: np.ndarray, n: int) -> np.ndarray:
    """``live_slot``: id in [0, n) (as uint32 against n capped at 2^31) and
    not the previous slot's id."""
    prev = np.concatenate([[~uniq[0]], uniq[:-1]]) if len(uniq) else uniq
    first = np.ones(len(uniq), bool)
    first[1:] = uniq[1:] != prev[1:]
    return ((uniq.astype(np.int64) & 0xFFFFFFFF) < min(n, 2 ** 31)) & first


def _stepped(codes, step, mu, nu, uniq, g, noise, bits, wd):
    """The plain step of every slot from its clamped row (kernels/ref.py):
    (w_new, new codes, mu', nu') [k, d]; the model writes what its lanes own."""
    safe = np.clip(uniq, 0, len(codes) - 1)
    t = torch.from_numpy
    w_new, mu_r, nu_r = pref.adam_row_step(
        t(codes[safe].astype(f32)), t(step[safe]), t(mu[safe]), t(nu[safe]), t(g), 0.01, 0.3,
        0.02, wd)
    new_codes = pref.sr_round_ref(w_new, t(step[safe]), t(noise), bits)
    return w_new.numpy(), new_codes.numpy(), mu_r.numpy(), nu_r.numpy()


class Table:
    """The table's bytes as the kernel sees them, with write counts."""

    def __init__(self, codes, mu, nu, bits, k, d):
        self.bits, self.d = bits, d
        self.data = codes.copy() if bits == 8 else pcs.pack_codes(
            torch.from_numpy(codes), bits).numpy()
        self.data = self.data.view(np.uint8).copy()
        self.mu, self.nu = mu.copy(), nu.copy()
        self.w_new = np.full((k, d), np.nan, f32)
        self.row_writes = np.zeros(mu.shape, np.int64)
        self.byte_writes = np.zeros(self.data.shape, np.int64)
        self.out_writes = np.zeros((k, d), np.int64)
        self.reads = []  # (slot, id) of every lane that read row state

    def lane(self, s, l, live, row, stepped):
        """What lane l of slot s stores (``step_lane`` / ``dead_lane``)."""
        d, bits = self.d, self.bits
        cols = np.arange(4 * l, min(4 * l + 4, d))
        self.out_writes[s, cols] += 1
        if not live:
            self.w_new[s, cols] = 0.0
            return
        self.reads.append((s, row))
        w_new, codes, mu, nu = stepped
        self.w_new[s, cols] = w_new[s, cols]
        self.mu[row, cols], self.nu[row, cols] = mu[s, cols], nu[s, cols]
        self.row_writes[row, cols] += 1
        word = 0
        for j, col in enumerate(cols):
            word |= (int(codes[s, col]) & ((1 << bits) - 1)) << (j * bits)
        nbytes = (len(cols) * bits + 7) // 8
        first = l * (bits // 2)
        for b in range(nbytes):
            self.data[row, first + b] = (word >> (8 * b)) & 0xFF
            self.byte_writes[row, first + b] += 1


def model_rows(codes, step, mu, nu, uniq, g_sum, noise, bits, wd, sms=H100_SMS):
    """The g_sum form (``row_kernel``): the grid of ``launch_rows`` (one
    resident wave at most) and its grid-stride loop, one task per thread."""
    k, d = g_sum.shape
    lanes = -(-d // 4)
    tasks = k * lanes
    stride = min(-(-tasks // BLOCK), sms * (2048 // BLOCK)) * BLOCK
    magic, shift = fast_div(lanes)
    live = _live(uniq, len(codes))
    stepped = _stepped(codes, step, mu, nu, uniq, g_sum, noise, bits, wd)
    table = Table(codes, mu, nu, bits, k, d)
    for gtid in range(stride):
        for t in range(gtid, tasks, stride):
            s = int(divide(t, magic, shift))
            assert s == t // lanes
            table.lane(s, t - s * lanes, live[s], int(uniq[s]), stepped)
    return table


def model_runs(codes, step, mu, nu, uniq, g_occ, order, starts, noise, bits, wd):
    """The runs form (``runs_kernel``): per block, the tile's range of
    ``order`` staged chunk by chunk, each live lane's sums in float32 in the
    order it walks the stage.  Returns the table, the sums, every lane's walk
    (positions in ``order``) and how often each (lookup, lane) was staged."""
    k, d = len(uniq), g_occ.shape[1]
    m = len(order)
    lanes = -(-d // 4)
    tl = min(lanes, BLOCK)
    ts = min(BLOCK // tl, TILE)
    chunk = STAGE // tl
    magic, shift = fast_div(tl)
    live = _live(uniq, len(codes))
    g = np.zeros((k, d), f32)
    walks = {}
    lanes_run = []  # (slot, lane) of every active thread, block by block
    staged = np.zeros((m, lanes), np.int64)
    tid = np.arange(BLOCK)
    ls = divide(tid, magic, shift)
    ll = tid - ls * tl
    for bx in range(-(-k // ts)):
        for by in range(-(-lanes // tl)):
            s0, s_end = bx * ts, min(bx * ts + ts, k)
            s, l = s0 + ls, by * tl + ll
            active = (s < s_end) & (l < lanes)
            s_c = np.minimum(s, k - 1)
            on = active & live[s_c]
            r0, r1 = starts[s_c].astype(np.int64), starts[s_c + 1].astype(np.int64)
            acc = np.zeros((BLOCK, 4), f32)
            begin = min(int(starts[s0]) & 0xFFFFFFFF, m)
            end = min(int(starts[s_end]) & 0xFFFFFFFF, m)
            for c0 in range(begin, end, chunk):
                cn = min(chunk, end - c0)
                stage = np.zeros((STAGE, 4), f32)
                for q in range(STAGE // BLOCK):
                    piece = tid + q * BLOCK
                    i = divide(piece, magic, shift)
                    lane = by * tl + piece - i * tl
                    ok = (i < cn) & (lane < lanes)
                    for p, ii, ln in zip(piece[ok], i[ok], lane[ok]):
                        row = order[c0 + ii]
                        v = g_occ[row, 4 * ln: 4 * ln + 4]
                        stage[p, :len(v)] = v
                        staged[c0 + ii, ln] += 1
                a = np.maximum(r0, c0)
                b = np.minimum(r1, c0 + cn)
                for j in range(int(max(0, (b - a).max(initial=0)))):
                    at = a + j
                    take = on & (at < b)
                    acc[take] = acc[take] + stage[(at[take] - c0) * tl + ll[take]]
                    for th in np.flatnonzero(take):
                        walks.setdefault((int(s[th]), int(l[th])), []).append(int(at[th]))
            for th in np.flatnonzero(on):
                cols = np.arange(4 * l[th], min(4 * l[th] + 4, d))
                g[s[th], cols] = acc[th, :len(cols)]
            lanes_run += [(int(s[th]), int(l[th])) for th in np.flatnonzero(active)]
    stepped = _stepped(codes, step, mu, nu, uniq, g, noise, bits, wd)
    table = Table(codes, mu, nu, bits, k, d)
    for s_, l_ in lanes_run:
        table.lane(s_, l_, live[s_], int(uniq[s_]), stepped)
    return table, g, walks, staged


def _plain(codes, step, mu, nu, uniq, g_sum, noise, bits, wd):
    """``sparse_row_update(_packed)_ref`` on copies: (container, mu, nu, w_new)."""
    t = torch.from_numpy
    store = pcs.CodeStore.from_codes(t(codes.copy()), bits)
    m_, v_ = t(mu.copy()), t(nu.copy())
    w = pops.sparse_row_update(store, t(step), m_, v_, t(uniq), t(g_sum), t(noise), 0.01, 0.3,
                               0.02, bits, weight_decay=wd)
    return store.data.numpy().view(np.uint8), m_.numpy(), v_.numpy(), w.numpy()


def _check_table(table, plain, uniq, live, n_live):
    data, mu, nu, w_new = plain
    k, d = table.w_new.shape
    assert (table.out_writes == 1).all()
    rows = uniq[live]
    assert len(set(rows.tolist())) == len(rows)
    written = np.zeros(len(table.mu), bool)
    written[rows] = True
    assert (table.row_writes[written] == 1).all() and (table.row_writes[~written] == 0).all()
    assert (table.byte_writes[written] == 1).all() and (table.byte_writes[~written] == 0).all()
    # Dead slots read nothing and get zeros; each lane of a live slot reads its own row.
    assert sorted(set(table.reads)) == [(s, int(uniq[s])) for s in np.flatnonzero(live)]
    assert len(table.reads) == live.sum() * -(-d // 4)
    assert (table.w_new[~live] == 0).all() and not np.signbit(table.w_new[~live]).any()
    # Bitwise the plain version on live rows (codes with their pad bits) and real slots.
    live_rows = slice(0, n_live)
    np.testing.assert_array_equal(table.data[live_rows], data[live_rows])
    np.testing.assert_array_equal(table.mu[live_rows].view(np.int32), mu[live_rows].view(np.int32))
    np.testing.assert_array_equal(table.nu[live_rows].view(np.int32), nu[live_rows].view(np.int32))
    real = uniq < n_live
    np.testing.assert_array_equal(table.w_new[real].view(np.int32), w_new[real].view(np.int32))


# ---------------------------------------------------------------------------
# Model tests.
# ---------------------------------------------------------------------------

MODEL_CASES = [(16, 700, 0), (15, 700, 0), (13, 700, 0), (16, 3000, 1100), (13, 2600, 600),
               (1, 300, 40), (40, 500, 0)]


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d,m,long_run", MODEL_CASES)
@pytest.mark.parametrize("scratch", [True, False])
def test_g_sum_form_model_writes_each_live_element_once(d, m, long_run, bits, scratch):
    n_live = 500
    n = n_live + 8 if scratch else n_live
    ids = _wave(d + m + bits, n_live, m, long_run)
    codes, step, mu, nu, g_occ, noise = _state(bits * 7 + d, n, d, bits, m)
    uniq, inv, order, starts = _dedup(ids, n_live)
    g_sum = plpt.segment_sum(torch.from_numpy(g_occ), torch.from_numpy(inv), m).numpy()
    table = model_rows(codes, step, mu, nu, uniq, g_sum, noise, bits, 5e-8, sms=2)
    live = _live(uniq, n)
    assert live.sum() == len(np.unique(ids)) + scratch  # the scratch row's first sentinel
    _check_table(table, _plain(codes, step, mu, nu, uniq, g_sum, noise, bits, 5e-8), uniq,
                 live, n_live)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d,m,long_run", MODEL_CASES)
@pytest.mark.parametrize("scratch", [True, False])
def test_runs_form_model_walks_each_run_in_order(d, m, long_run, bits, scratch):
    n_live = 500
    n = n_live + 8 if scratch else n_live
    ids = _wave(d + m + bits + 1, n_live, m, long_run)
    codes, step, mu, nu, g_occ, noise = _state(bits * 5 + d, n, d, bits, m)
    uniq, inv, order, starts = _dedup(ids, n_live)
    table, g, walks, staged = model_runs(codes, step, mu, nu, uniq, g_occ, order, starts, noise,
                                         bits, 0.0)
    live = _live(uniq, n)
    lanes = -(-d // 4)
    # Every lookup's row staged once per lane; every live lane walked its
    # whole run, in order, and the run is its slot's lookups in occurrence order.
    assert (staged == 1).all()
    for s in np.flatnonzero(live):
        run = list(range(starts[s], starts[s + 1]))
        np.testing.assert_array_equal(order[run], np.flatnonzero(inv == s))
        for l in range(lanes):
            assert walks.get((s, l), []) == run
    assert all(live[s] for s, _ in walks)
    g_sum = plpt.segment_sum(torch.from_numpy(g_occ), torch.from_numpy(inv), m).numpy()
    np.testing.assert_array_equal(g[live].view(np.int32), g_sum[live].view(np.int32))
    _check_table(table, _plain(codes, step, mu, nu, uniq, g_sum, noise, bits, 0.0), uniq, live,
                 n_live)


def test_runs_form_model_splits_wide_rows_over_lane_tiles():
    # d = 1,100 is 275 lanes: two lane tiles (blockIdx.y) of one slot each.
    d, m, n_live = 1100, 40, 30
    ids = _wave(3, n_live, m, 12)
    codes, step, mu, nu, g_occ, noise = _state(4, n_live + 8, d, 8, m)
    uniq, inv, order, starts = _dedup(ids, n_live)
    table, g, walks, staged = model_runs(codes, step, mu, nu, uniq, g_occ, order, starts, noise,
                                         8, 5e-8)
    assert (staged == 1).all()
    live = _live(uniq, n_live + 8)
    g_sum = plpt.segment_sum(torch.from_numpy(g_occ), torch.from_numpy(inv), m).numpy()
    np.testing.assert_array_equal(g[live].view(np.int32), g_sum[live].view(np.int32))
    _check_table(table, _plain(codes, step, mu, nu, uniq, g_sum, noise, 8, 5e-8), uniq, live,
                 n_live)


@pytest.mark.parametrize("divisors", [range(1, 1025), [2 ** 20 + 1, 2 ** 30 - 1, 2 ** 31 - 1]])
def test_fast_div_equals_integer_division(divisors):
    rng = np.random.RandomState(2)
    for divisor in divisors:
        magic, shift = fast_div(divisor)
        assert 0 < magic < 2 ** 32
        top = 2 ** 31 - 1
        t = np.concatenate([[0, 1, divisor - 1, divisor, top], rng.randint(0, top, 100)])
        t = t[(t >= 0) & (t <= top)]
        np.testing.assert_array_equal(divide(t, magic, shift), t // divisor)


def test_occurrence_runs_of_a_ctr_wave():
    ids = _wave(9, 4000, 24_576, 404)
    uniq, inv, order, starts = _dedup(ids, 4000)
    k, distinct = len(uniq), len(np.unique(ids))
    assert order.dtype == np.int64 and starts.dtype == np.int32 and starts.shape == (k + 1,)
    counts = np.bincount(inv, minlength=k)
    np.testing.assert_array_equal(np.diff(starts)[:distinct], counts[:distinct])
    assert (np.diff(starts)[distinct:] == 0).all() and starts[0] == 0 and starts[-1] == k
    np.testing.assert_array_equal(order, np.argsort(inv, kind="stable"))
    assert np.diff(starts).max() >= 404


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", ["ctr wave", "one id", "all distinct", "empty"])
def test_dedup_runs_agrees_with_dedup_ids(dtype, case):
    """The runs' one sort gives ``dedup_ids``' uniq and inv exactly, with
    the ids in any shape and either index dtype."""
    ids = {"ctr wave": _wave(3, 4000, 2048, 300), "one id": np.full(64, 17),
           "all distinct": np.random.RandomState(4).permutation(500)[:257],
           "empty": np.zeros(0, np.int64)}[case]
    t = torch.from_numpy(ids).to(dtype).reshape(-1, 1)
    uniq, inv, order, starts = plpt.dedup_runs(t, 4000)
    want_uniq, want_inv = plpt.dedup_ids(t, 4000)
    assert uniq.dtype == torch.int32 and inv.dtype == torch.int64
    assert torch.equal(uniq, want_uniq) and torch.equal(inv, want_inv)
    np.testing.assert_array_equal(order.numpy(), np.argsort(inv.numpy(), kind="stable"))
    np.testing.assert_array_equal(np.diff(starts.numpy()),
                                  np.bincount(inv.numpy(), minlength=ids.size))


# ---------------------------------------------------------------------------
# The runs form's plain version against its parts, and against the JAX package.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 15, 13])
@pytest.mark.parametrize("scratch", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 5e-8])
def test_runs_plain_equals_segment_sum_then_row_step(bits, d, scratch, weight_decay):
    n_live, m = 300, 1200
    n = n_live + 8 if scratch else n_live
    ids = _wave(bits + d, n_live, m, 420)
    codes, step, mu, nu, g_occ, noise = _state(bits + 3 * d, n, d, bits, m)
    t = torch.from_numpy
    uniq, inv = plpt.dedup_ids(t(ids), n_live)
    _, _, order, starts = plpt.dedup_runs(t(ids), n_live)
    assert int((starts[1:] - starts[:-1]).max()) >= 420
    outs = []
    for runs in (True, False):
        store = pcs.CodeStore.from_codes(t(codes.copy()), bits)
        m_, v_ = t(mu.copy()), t(nu.copy())
        pops.reset_kernel_calls()
        if runs:
            w = pops.sparse_row_update_runs(store, t(step), m_, v_, uniq, t(g_occ), order, starts,
                                            t(noise), 0.01, 0.3, 0.02, bits,
                                            weight_decay=weight_decay)
        else:
            g_sum = plpt.segment_sum(t(g_occ), inv, m)
            w = pops.sparse_row_update(store, t(step), m_, v_, uniq, g_sum, t(noise), 0.01, 0.3,
                                       0.02, bits, weight_decay=weight_decay)
        assert pops.kernel_calls() == {}  # CPU tensors take the plain versions
        outs.append((store.data.numpy(), m_.numpy().view(np.int32), v_.numpy().view(np.int32),
                     w.numpy().view(np.int32)))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)  # every row and slot, sentinels included
    np.testing.assert_array_equal(
        pref.runs_sum(t(g_occ), order, starts).numpy().view(np.int32),
        plpt.segment_sum(t(g_occ), inv, m).numpy().view(np.int32))


def _tables(seed, n, d, bits):
    rs = np.random.RandomState(seed)
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = rs.randint(lo, hi + 1, (n, d)).astype(np.int8)
    step = rs.uniform(2e-3, 0.03, n).astype(f32)
    mu = (rs.randn(n, d) * 1e-3).astype(f32)
    nu = (rs.rand(n, d) * 1e-4).astype(f32)
    jt = jlpt.LPTTable(codes=jcs.CodeStore.from_codes(jnp.asarray(codes), bits),
                       step=jnp.asarray(step), mu=jnp.asarray(mu), nu=jnp.asarray(nu),
                       count=jnp.asarray(6, jnp.int32))
    pt = plpt.LPTTable(codes=pcs.CodeStore.from_codes(torch.from_numpy(codes), bits),
                       step=torch.from_numpy(step.copy()), mu=torch.from_numpy(mu.copy()),
                       nu=torch.from_numpy(nu.copy()), count=6)
    return jt, pt


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("d", [16, 14, 13])
@pytest.mark.parametrize("pad", [True, False])
def test_sparse_apply_with_kernels_equals_the_jax_reference(bits, d, pad):
    """Bitwise on live rows and real slots.  One exception, the reference's
    own: at an odd width in a packed container XLA fuses the reference's
    packed oracle otherwise and rounds a few ``w_new`` elements (an aux
    output; the codes made from them agree) 1-3 ulps away, as it does for the
    port's plain path (tests/test_torch_train_kernels.py, d = 15); there
    ``w_new`` is held bitwise to the port's plain path and within 4 ulps of
    the reference."""
    n_live = 120
    n = n_live + 8 if pad else n_live
    jt, pt = _tables(bits * 3 + d, n, d, bits)
    _, plain = _tables(bits * 3 + d, n, d, bits)
    ids = _wave(d * bits, n_live, 640, 410).reshape(80, 8)
    rs = np.random.RandomState(d)
    g_rows = (rs.randn(80, 8, d) * 0.05).astype(f32)
    key = jax.random.PRNGKey(bits + d)
    noise = np.array(jq.sr_noise(key, (ids.size, d)))
    lr = f32(0.01)

    @jax.jit
    def ref_step(table, ids, g_rows):
        return jlpt.sparse_apply(table, ids, g_rows, lr=lr, bits=bits, noise_key=key,
                                 weight_decay=5e-8, return_updated_rows=True, id_space=n_live,
                                 use_kernels=True)

    jt2, (juniq, jw) = ref_step(jt, jnp.asarray(ids), jnp.asarray(g_rows))
    pops.reset_fallbacks()
    pt2, (puniq, pw, _) = plpt.sparse_apply(
        pt, torch.from_numpy(ids), torch.from_numpy(g_rows), lr=float(lr), bits=bits,
        noise=torch.from_numpy(noise), weight_decay=5e-8, return_updated_rows=True,
        id_space=n_live, use_kernels=True)
    assert pops.fallbacks() == []
    plain_w = plpt.sparse_apply(
        plain, torch.from_numpy(ids), torch.from_numpy(g_rows), lr=float(lr), bits=bits,
        noise=torch.from_numpy(noise), weight_decay=5e-8, return_updated_rows=True,
        id_space=n_live)[1][1]
    live = slice(0, n_live)
    np.testing.assert_array_equal(pt2.codes.data.numpy()[live], np.asarray(jt2.codes.data)[live])
    for name in ("mu", "nu", "step"):
        np.testing.assert_array_equal(getattr(pt2, name).numpy()[live].view(np.int32),
                                      np.asarray(getattr(jt2, name))[live].view(np.int32))
    np.testing.assert_array_equal(puniq.numpy(), np.asarray(juniq))
    real = puniq.numpy() < n_live
    got, want = pw.numpy()[real].view(np.int32), np.asarray(jw)[real].view(np.int32)
    np.testing.assert_array_equal(got, plain_w.numpy()[real].view(np.int32))
    if bits < 8 and d % 2:
        assert np.abs(got.astype(np.int64) - want).max() <= 4 and (got != want).mean() <= 0.02
    else:
        np.testing.assert_array_equal(got, want)
