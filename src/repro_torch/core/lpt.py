"""Low-precision training (LPT) of embedding tables (port of repro/core/lpt.py).

The table lives as integer codes plus a per-row step size Delta; there is no
full-precision master copy (paper §2.3).  Each step de-quantizes only the
rows a batch touches, applies the optimizer update in float, and
re-quantizes with SR or DR (Eq. 8):

    w_hat^{t+1} = Q( w_hat^t - eta * grad f(w_hat^t) )

Ported: :func:`init_table` (SR through the ``sr_round`` kernel),
:func:`lookup`, the sparse CTR path :func:`sparse_apply` (ids
de-duplicated, only those rows updated, through the ``sparse_row_update_runs``
kernel, which sums each row's gradients in occurrence order) and the dense
LM path :func:`dense_apply` (the whole table's gradient, the optimizer direction
formed in PyTorch, the write-back through the ``lpt_fused_update`` kernel,
untouched rows kept bit-identical).  Unlike the reference, whose arrays are
immutable, :func:`sparse_apply` updates the table's tensors **in place** and
returns a table that shares them; :func:`dense_apply` returns new tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.codestore import CodeStore, in_range_rows
from repro_torch.kernels import ops, ref


class LPTTable(NamedTuple):
    """Quantized embedding table + per-row step + row optimizer state."""

    codes: CodeStore  # packed uint8 at bits in {2, 4}, int8 otherwise
    step: torch.Tensor  # f32 [n] (feature-wise Delta; ALPT learns it)
    mu: torch.Tensor  # f32 [n, d] (adam) | [n] zeros (adagrad/sgd)
    nu: torch.Tensor  # f32 [n, d] (adam) | [n] (adagrad accumulator) | [n] zeros
    count: int  # global step for Adam bias correction

    @property
    def n_rows(self) -> int:
        return self.codes.shape[0]

    @property
    def dim(self) -> int:
        return self.codes.shape[1]


def init_table(generator: torch.Generator, n: int, d: int, bits: int, *,
               init_scale: float = 1e-2, mean: float = 0.0,
               step_size: float | None = None, clip_value: float | None = None,
               optimizer: str = "adam", use_kernels: bool = False,
               packed: bool | None = None) -> LPTTable:
    """Weights ~ N(mean, init_scale^2) and SR noise from ``generator`` (on its
    device), then :func:`table_from_init`.  The draws differ from JAX's
    threefry stream; parity tests call :func:`table_from_init` with JAX's."""
    w = torch.randn((n, d), generator=generator, dtype=torch.float32,
                    device=generator.device) * init_scale
    if mean:
        w = mean + w
    noise = quant.sr_noise(generator, (n, d))
    return table_from_init(w, noise, bits, step_size=step_size, clip_value=clip_value,
                           optimizer=optimizer, use_kernels=use_kernels, packed=packed)


def table_from_init(w: torch.Tensor, noise: torch.Tensor, bits: int, *,
                    step_size: float | None = None, clip_value: float | None = None,
                    optimizer: str = "adam", use_kernels: bool = False,
                    packed: bool | None = None) -> LPTTable:
    """Choose Delta, SR-quantize ``w`` with ``noise``, store the codes.

    Vanilla LPT fixes Delta from a tuned clip value (clip / 2^{m-1}); with
    neither ``step_size`` nor ``clip_value``, Delta is set per row LSQ-style
    from ``w`` (the ALPT default).  ``packed`` selects the container: None or
    True packs bits in {2, 4}, False keeps one byte per code.
    """
    n, d = w.shape
    if step_size is not None:
        step = torch.full((n,), step_size, dtype=torch.float32, device=w.device)
    elif clip_value is not None:
        step = torch.full((n,), clip_value / (2 ** (bits - 1)), dtype=torch.float32,
                          device=w.device)
    else:
        step = quant.init_step_size(w, bits, per_row=True)
    if use_kernels:
        codes = ops.sr_round(w, step, noise, bits)
    else:
        codes = quant.quantize_codes(w, step, bits, "sr", noise)
    codes = CodeStore.from_codes(codes, bits, packed=packed)
    if optimizer == "adam":
        slot_shape = (n, d)
    elif optimizer in ("adagrad", "sgd"):
        slot_shape = (n,)
    else:
        raise ValueError(f"unknown row optimizer {optimizer!r}")
    mu = torch.zeros(slot_shape, dtype=torch.float32, device=w.device)
    nu = torch.zeros(slot_shape, dtype=torch.float32, device=w.device)
    return LPTTable(codes=codes, step=step, mu=mu, nu=nu, count=0)


def lookup(table: LPTTable, ids: torch.Tensor, *, use_kernels: bool = False,
           out_dim: int | None = None) -> torch.Tensor:
    """De-quantize the rows for int32 ``ids`` (any leading shape) -> f32 [..., d].

    ``use_kernels`` routes through the fused gather (``ops.dequant_gather``);
    the plain path is bitwise identical.  ``out_dim`` slices padded tables
    back to the live embedding width.
    """
    if use_kernels:
        rows = ops.dequant_gather(table.codes, table.step, ids.reshape(-1))
        rows = rows.reshape(*ids.shape, table.dim)
    else:
        rows = quant.dequantize(table.codes.take(ids), table.step[ids])
    if out_dim is not None and out_dim != rows.shape[-1]:
        rows = rows[..., :out_dim]
    return rows


def dense_table(table: LPTTable) -> torch.Tensor:
    """The full de-quantized f32 [n, d] table (the dense LM path)."""
    return quant.dequantize(table.codes.unpack(), table.step)


# ---------------------------------------------------------------------------
# Sparse (CTR) training path.
# ---------------------------------------------------------------------------


def adam_bias_corrections(count: int, b1: float = 0.9, b2: float = 0.999) -> tuple[float, float]:
    """``(1 - b1^t, 1 - b2^t)`` at the 1-indexed step ``count``, as float32 values.

    The reference computes them with XLA's float32 ``pow``, which calls the
    C library's ``powf``; numpy's float32 scalar power calls the same
    function, so the host values equal the reference's bit for bit
    (tests/test_torch_train_kernels.py sweeps t).  They reach the kernel by
    value, with no device sync.
    """
    t = np.float32(count)
    one = np.float32(1.0)
    return float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)


def dedup_ids(ids: torch.Tensor, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(uniq int32 [K], inv int64 [K])`` for the K flat ids: sorted unique
    ids padded to K with the sentinel ``n_rows``, and each id's slot in
    ``uniq`` — what ``jnp.unique(size=K, fill_value=n_rows)`` returns."""
    flat = ids.reshape(-1)
    u, inv = torch.unique(flat, sorted=True, return_inverse=True)
    uniq = torch.full((flat.numel(),), n_rows, dtype=torch.int32, device=flat.device)
    uniq[: u.numel()] = u.to(torch.int32)
    return uniq, inv.reshape(-1).to(torch.int64)


# ``out[inv[i]] += values[i]`` in occurrence order (the plain path's sum and
# ALPT's Delta-step backward); it lives beside the kernels' plain versions.
segment_sum = ref.segment_sum


def dedup_runs(ids: torch.Tensor, n_rows: int) -> tuple[torch.Tensor, ...]:
    """``(uniq, inv, order int64 [K], starts int32 [K + 1])`` for the K flat
    ids from one stable sort and no wait for the card: :func:`dedup_ids`'
    ``uniq`` and ``inv``, and each slot's run of lookups,
    ``order[starts[s]:starts[s + 1]]`` in occurrence order (empty for the
    sentinel padding) -- the operands of ``ops.sparse_row_update_runs``.  A
    sorted lookup's slot is the number of id changes before it.  The ids are
    sorted as int32 keys (ids < 2^31, as ``uniq``'s dtype already asks)."""
    flat = ids.reshape(-1)
    k = flat.numel()
    sorted_ids, order = torch.sort(flat.to(torch.int32), stable=True)
    slot = (torch.diff(sorted_ids, prepend=sorted_ids[:1]) != 0).cumsum(0)
    uniq = torch.full((k,), n_rows, dtype=torch.int32, device=flat.device)
    uniq.scatter_(0, slot, sorted_ids)  # a run's lookups write its one id
    inv = torch.empty_like(order).scatter_(0, order, slot)
    starts = torch.searchsorted(slot, torch.arange(k + 1, device=flat.device), out_int32=True)
    return uniq, inv, order, starts


def set_rows(t: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> None:
    """``t.at[ids].set(rows, mode="drop")``, in place."""
    ids, rows = in_range_rows(ids, rows, t.shape[0])
    t.index_copy_(0, ids, rows)


def _opt_direction(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, optimizer: str,
                   count: int | None = None):
    """Weight-independent part of a row update: ``(direction, mu', nu')``.
    Adam's (at the 1-indexed ``count``) is
    :func:`repro_torch.kernels.ref.adam_direction`, the arithmetic the
    reference's jitted step computes."""
    if optimizer == "adam":
        return ref.adam_direction(g, mu, nu, *adam_bias_corrections(count),
                                  mu_from_numerator=True)
    if optimizer == "adagrad":
        nu = nu + torch.mean(torch.square(g), dim=-1)
        return g / (ref.sqrt_rn(nu)[..., None] + ref.EPS), mu, nu
    if optimizer == "sgd":
        return g, mu, nu
    raise ValueError(f"unknown row optimizer {optimizer!r}")


def _row_update(codes: torch.Tensor, step_rows: torch.Tensor, g: torch.Tensor,
                mu: torch.Tensor, nu: torch.Tensor, count: int, lr: float, optimizer: str,
                weight_decay: float, *, mu_from_numerator: bool = False):
    """``(w_new, mu', nu')`` for f32 code rows ``codes`` [k, d] at 1-indexed
    ``count`` (``mu_from_numerator``: see ``ref.adam_direction``)."""
    if optimizer == "adam":
        c1, c2 = adam_bias_corrections(count)
        return ref.adam_row_step(codes, step_rows, mu, nu, g, lr, c1, c2, weight_decay,
                                 mu_from_numerator=mu_from_numerator)
    w = codes * step_rows[:, None]
    upd, mu, nu = _opt_direction(g, mu, nu, optimizer)
    if weight_decay:
        upd = upd + weight_decay * w
    return w - lr * upd, mu, nu


def sparse_apply(table: LPTTable, ids: torch.Tensor, grad_rows: torch.Tensor, *, lr: float,
                 bits: int, rounding: str = "sr", noise: torch.Tensor | None = None,
                 optimizer: str = "adam", weight_decay: float = 0.0,
                 new_step: torch.Tensor | None = None, return_updated_rows: bool = False,
                 id_space: int | None = None, use_kernels: bool = False):
    """Paper-faithful LPT update, **in place**: only rows present in ``ids`` change.

    ``grad_rows`` [..., d] is the cotangent per lookup; duplicate ids have
    their gradients summed.  ``noise`` f32 [K, d] (K = ids.numel()) is the
    SR noise of the reference's ``sr_noise(noise_key, (K, d))``.  ``lr`` is a
    float32 value.  The returned table shares the input's tensors.

    ``id_space`` is the logical id range (``spec.n``), the dedup sentinel:
    on ``pad_to_tiles`` tables it is a dead scratch row below ``n_rows``,
    otherwise it lies past the table and its writes are dropped.
    ``use_kernels`` takes the fused ``ops.sparse_row_update_runs`` kernel
    when eligible (SR, row-Adam, no ``new_step``), which sums each id's
    gradients itself (:func:`dedup_runs`); anything else is a counted
    fallback (``ops.fallbacks()``) to the plain path below, which sums with
    :func:`segment_sum` and is bitwise equal on every live row and real
    slot (the sentinel's slots and scratch row are unspecified on both).

    With ``return_updated_rows`` the result is ``(table, (uniq, w_new,
    inv))``: the reference's ``(uniq, w_new)`` and each lookup's slot in
    ``uniq``, which ALPT's Delta step reuses.
    """
    n, d = table.n_rows, table.dim
    sentinel = n if id_space is None else id_space
    flat_g = grad_rows.reshape(-1, grad_rows.shape[-1]).to(torch.float32)
    if flat_g.shape[-1] != d:
        # Live-width cotangents against a pad_to_tiles table: the tail
        # columns were never looked up, so their gradient is exactly zero.
        flat_g = torch.nn.functional.pad(flat_g, (0, d - flat_g.shape[-1]))
    count = table.count + 1
    if rounding == "sr" and noise is None:
        raise ValueError("SR requires noise")

    kernel_ok = False
    if use_kernels:
        kernel = "sparse_row_update_runs" + ("_packed" if table.codes.packed else "")
        if rounding != "sr":
            ops.note_fallback(kernel, (n, d), "dr rounding")
        elif optimizer != "adam":
            ops.note_fallback(kernel, (n, d), f"row optimizer {optimizer!r}")
        elif new_step is not None:
            ops.note_fallback(kernel, (n, d), "caller-supplied new_step")
        else:
            kernel_ok = True
    if kernel_ok:
        # The kernel sums each slot's run of lookups itself: no g_sum.
        c1, c2 = adam_bias_corrections(count)
        uniq, inv, order, starts = dedup_runs(ids, sentinel)
        w_new = ops.sparse_row_update_runs(table.codes, table.step, table.mu, table.nu, uniq,
                                           flat_g.contiguous(), order, starts, noise, lr, c1, c2,
                                           bits, weight_decay=weight_decay)
        new_table = table._replace(count=count)
        return (new_table, (uniq, w_new, inv)) if return_updated_rows else new_table

    uniq, inv = dedup_ids(ids, sentinel)
    k = uniq.numel()
    g_sum = segment_sum(flat_g, inv, k)
    # Gather the current rows and optimizer slots (a sentinel past the table
    # gathers the last row harmlessly; its writes are dropped).
    safe = torch.clamp(uniq, max=n - 1).to(torch.int64)
    step_rows = table.step[safe]
    w_new, mu_new, nu_new = _row_update(
        table.codes.take(safe).to(torch.float32), step_rows, g_sum, table.mu[safe],
        table.nu[safe], count, lr, optimizer, weight_decay)
    if new_step is not None:
        step_rows = new_step
        set_rows(table.step, uniq, step_rows)
    codes_rows = quant.quantize_codes(w_new, step_rows, bits, rounding, noise)
    table.codes.set_rows(uniq, codes_rows)
    set_rows(table.mu, uniq, mu_new)
    set_rows(table.nu, uniq, nu_new)
    new_table = table._replace(count=count)
    return (new_table, (uniq, w_new, inv)) if return_updated_rows else new_table


# ---------------------------------------------------------------------------
# Dense (LM) training path.
# ---------------------------------------------------------------------------


def dense_apply(table: LPTTable, grad_table: torch.Tensor, *, lr: float, bits: int,
                rounding: str = "sr", noise: torch.Tensor | None = None,
                optimizer: str = "adam", weight_decay: float = 0.0,
                new_step: torch.Tensor | None = None, use_kernels: bool = False) -> LPTTable:
    """Dense LPT update: the whole table stepped, touched rows kept.

    A row is touched iff any element of its gradient ``grad_table`` f32
    [n, d] is nonzero; untouched rows keep their codes, Adam slots and Delta
    bit-identical.  ``noise`` f32 [n, d] is the SR noise (the reference's
    ``sr_noise(noise_key, (n, d))``); ``lr`` a float32 value.

    ``use_kernels`` with SR forms the optimizer direction in PyTorch and
    writes back through ``ops.lpt_update`` (de-quantize, decayed step, SR
    re-quantize with ``new_step`` or Delta in one pass; the fp32 table is
    never built).  DR takes the plain path below, counted as a fallback
    (``ops.fallbacks()``); the two paths are bitwise equal.
    """
    touched = torch.any(grad_table != 0.0, dim=-1)
    count = table.count + 1
    step = table.step if new_step is None else new_step
    if rounding == "sr" and noise is None:
        raise ValueError("SR requires noise")
    if use_kernels and rounding != "sr":
        kernel = "lpt_fused_update_packed" if table.codes.packed else "lpt_fused_update"
        ops.note_fallback(kernel, table.codes.shape, "dr rounding")
    g = grad_table.to(torch.float32)
    if use_kernels and rounding == "sr":
        upd, mu_new, nu_new = _opt_direction(g, table.mu, table.nu, optimizer, count)
        codes_new = ops.lpt_update(table.codes, table.step, upd, noise, lr, bits,
                                   new_step=new_step, weight_decay=weight_decay)
    else:
        w_new, mu_new, nu_new = _row_update(table.codes.unpack().to(torch.float32), table.step,
                                            g, table.mu, table.nu, count, lr, optimizer,
                                            weight_decay, mu_from_numerator=True)
        codes_new = quant.quantize_codes(w_new, step, bits, rounding, noise)
    slot_mask = touched[:, None] if table.mu.ndim == 2 else touched
    return LPTTable(
        codes=table.codes.where_rows(touched, codes_new),
        step=table.step if new_step is None else torch.where(touched, step, table.step),
        mu=torch.where(slot_mask, mu_new, table.mu),
        nu=torch.where(slot_mask, nu_new, table.nu),
        count=count,
    )


def memory_bytes(table: LPTTable, bits: int, count_optimizer: bool = False) -> int:
    """Training-memory accounting (codes + Delta), storage-actual: the code
    container's resident bytes (``ceil(d * bits / 8)`` per packed row) + 4 B
    of Delta per row, and with ``count_optimizer`` the row-optimizer slots."""
    total = table.codes.resident_bytes + table.n_rows * 4
    if count_optimizer:
        total += (table.mu.numel() + table.nu.numel()) * 4
    return int(total)
