"""Low-precision training (LPT) of embedding tables (port of repro/core/lpt.py).

The table lives as integer codes plus a per-row step size Delta; there is no
full-precision master copy (paper §2.3).  Each step de-quantizes only the
rows a batch touches, applies the optimizer update in float, and
re-quantizes with SR or DR (Eq. 8):

    w_hat^{t+1} = Q( w_hat^t - eta * grad f(w_hat^t) )

Ported: :func:`init_table` (SR through the ``sr_round`` kernel),
:func:`lookup`, and the sparse CTR path :func:`sparse_apply` (ids
de-duplicated, per-row gradients summed in occurrence order, only those rows
updated through the ``sparse_row_update`` kernel).  Unlike the reference,
whose arrays are immutable, :func:`sparse_apply` updates the table's tensors
**in place** and returns a table that shares them.  ``dense_apply`` (the
LM/DP path) is not ported yet.
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


def segment_sum(values: torch.Tensor, inv: torch.Tensor, k: int) -> torch.Tensor:
    """``out[inv[i]] += values[i]`` into zeros [k, ...], in occurrence order.

    The reference's ``zeros.at[inv].add(g)`` adds each slot's occurrences in
    order, one rounding each.  On the CPU ``index_add_`` walks the indices in
    order.  On the card ``index_add_`` uses atomics, whose order changes from
    run to run; ``index_put_(accumulate=True)`` instead sorts the indices
    with a stable radix sort and adds each slot's run sequentially, which is
    the same order and deterministic (``chip_smoke.py`` holds it bitwise
    against the CPU).
    """
    out = torch.zeros((k, *values.shape[1:]), dtype=values.dtype, device=values.device)
    if out.device.type == "cpu":
        return out.index_add_(0, inv, values)
    return out.index_put_((inv,), values, accumulate=True)


def set_rows(t: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> None:
    """``t.at[ids].set(rows, mode="drop")``, in place."""
    ids, rows = in_range_rows(ids, rows, t.shape[0])
    t.index_copy_(0, ids, rows)


def _opt_direction(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, optimizer: str):
    """Weight-independent part of an adagrad/sgd row update: (direction, mu, nu).
    Row-Adam is :func:`repro_torch.kernels.ref.adam_row_step`, the kernel's
    own arithmetic."""
    if optimizer == "adagrad":
        nu = nu + torch.mean(torch.square(g), dim=-1)
        return g / (ref.sqrt_rn(nu)[..., None] + ref.EPS), mu, nu
    if optimizer == "sgd":
        return g, mu, nu
    raise ValueError(f"unknown row optimizer {optimizer!r}")


def _row_update(codes: torch.Tensor, step_rows: torch.Tensor, g: torch.Tensor,
                mu: torch.Tensor, nu: torch.Tensor, count: int, lr: float, optimizer: str,
                weight_decay: float):
    """``(w_new, mu', nu')`` for f32 code rows ``codes`` [k, d] at 1-indexed ``count``."""
    if optimizer == "adam":
        c1, c2 = adam_bias_corrections(count)
        return ref.adam_row_step(codes, step_rows, mu, nu, g, lr, c1, c2, weight_decay)
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
    ``use_kernels`` takes the fused ``ops.sparse_row_update`` kernel when
    eligible (SR, row-Adam, no ``new_step``); anything else is a counted
    fallback (``ops.fallbacks()``) to the plain path below, which is bitwise
    equal on every live row and real slot (the sentinel's slots and scratch
    row are unspecified on both).

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
    uniq, inv = dedup_ids(ids, sentinel)
    k = uniq.numel()
    g_sum = segment_sum(flat_g, inv, k)
    count = table.count + 1
    if rounding == "sr" and noise is None:
        raise ValueError("SR requires noise")

    kernel_ok = False
    if use_kernels:
        if rounding != "sr":
            ops.note_fallback("sparse_row_update", (n, d), "dr rounding")
        elif optimizer != "adam":
            ops.note_fallback("sparse_row_update", (n, d), f"row optimizer {optimizer!r}")
        elif new_step is not None:
            ops.note_fallback("sparse_row_update", (n, d), "caller-supplied new_step")
        else:
            kernel_ok = True
    if kernel_ok:
        c1, c2 = adam_bias_corrections(count)
        w_new = ops.sparse_row_update(table.codes, table.step, table.mu, table.nu, uniq, g_sum,
                                      noise, lr, c1, c2, bits, weight_decay=weight_decay)
        new_table = table._replace(count=count)
        return (new_table, (uniq, w_new, inv)) if return_updated_rows else new_table

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


def memory_bytes(table: LPTTable, bits: int, count_optimizer: bool = False) -> int:
    """Training-memory accounting (codes + Delta), storage-actual: the code
    container's resident bytes (``ceil(d * bits / 8)`` per packed row) + 4 B
    of Delta per row, and with ``count_optimizer`` the row-optimizer slots."""
    total = table.codes.resident_bytes + table.n_rows * 4
    if count_optimizer:
        total += (table.mu.numel() + table.nu.numel()) * 4
    return int(total)
