"""Tensor and sequence parallelism on explicit shards: the collectives that
stand where the reference's ``hint``\\ s let GSPMD place them.

A rank of a ``(data, model)`` mesh (:mod:`repro_torch.launch.mesh`) holds
its shard of every leaf (:func:`repro_torch.dist.sharding.shard_tree`) and
runs the one-process model code on it; with a context active
(:func:`repro_torch.dist.context.use`) and a model axis larger than 1, the
model calls these at the reference's hint sites:

* :func:`enter` before a column-parallel projection (``q_heads`` /
  ``kv_heads``, an MLP's in-projections, the routed experts): identity
  forward / all-reduce backward (Megatron's *f*), after an all-gather along
  T under sequence parallelism (``carry``; backward: the rank's slice);
* :func:`leave` after a row-parallel one (``wo``, ``w_down``, the expert
  combine): all-reduce forward / identity backward (*g*), then the rank's
  slice of T under sequence parallelism (backward: all-gather).  A bias on
  the output is added once, after it;
* :func:`embed_rows` (``embed_table``): a vocab shard gives zero rows for
  ids outside it, then *g*; a shard over d is all-gathered along d;
* :func:`token_losses` (``head_weight`` / ``logits``): a vocab shard's
  logits go through a vocab-parallel cross-entropy (a MAX, then a SUM of
  exp, then the label's logit from the rank that holds it; the rows of a
  padded table past the vocabulary masked out); a shard over d contracts
  its columns and all-reduces the logits;
* :func:`partial_weight`: a replicated weight that reads this rank's
  block of T (the norms under sequence parallelism, the encoder MLP's
  ``b_out``) or its heads (QK-norm, the mamba mixer's B / C streams) gets
  the model ranks' summed gradient (*f* on the weight);
* :func:`whole`: a leaf the specs cut where the executor cannot run a
  shard (attention heads split mid-head, SSD heads that do not split)
  gathered before use, its backward the rank's block; the sub-layer then
  runs replicated, with neither *f* nor *g*;
* :func:`sum_over_model`: a statistic summed over the ranks' blocks of a
  sharded width (the gated norm over the mixer's ``d_inner``), whose
  backward sums too, since every rank's output reads it;
* :func:`rows_any` / :func:`rows_sum`: a table sharded over d reduces a
  row's touched flag and its Delta gradient over the model group;
* :func:`batch_mean`: a batch statistic that is not a mean of per-token
  terms (the MoE load-balance loss) takes the whole batch's over a split
  data axis;
* :func:`all_to_all` and :func:`mean_over_model`: expert parallelism's
  dispatch and return trip (``models.moe.moe_forward_ep``), and its
  per-slice load-balance loss averaged once over the model ranks;
* :func:`fsdp_whole` (fsdp): a sub-layer's projections, cut over the data
  axis, all-gathered over the data group where the sub-layer reads them;
  backward: the data ranks' gradients' exact rank-ordered mean, then the
  rank's block (so the step does not mean those leaves again);
* :func:`vocab_whole` (dp, where the model ranks hold different
  sequences): the vocab table and the untied head, which the specs still
  split over the model axis, all-gathered whole before the model reads
  them; backward: the exact mean over every rank of the mesh, then the
  rank's block.  Every other leaf is whole under dp, so no other hint site
  runs a collective.

No context, or a model axis of 1: every function is the identity and no
collective runs (:func:`fsdp_whole` and :func:`batch_mean` read the data
axis).  Every collective is ``all_reduce`` (SUM, MAX), ``all_gather`` or
``all_to_all_single`` on the model group (the data group or the world for
the two above and :func:`vocab_whole`), which gloo
takes on CUDA tensors (several ranks on one card, where NCCL refuses); a
reduce-scatter is an all-reduce followed by the rank's slice.  All ranks
run the same backward graph, so they reach the collectives in the same
order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import collectives
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import sharding


def active():
    """The active context when its mesh has a model axis > 1, else None."""
    ctx = dist_ctx.current()
    if ctx is None or ctx.mesh.shape.get("model", 1) <= 1:
        return None
    return ctx


def _group():
    return dist_ctx.current().mesh.groups["model"]


def model_size() -> int:
    ctx = active()
    return 1 if ctx is None else int(ctx.mesh.shape["model"])


def model_rank() -> int:
    ctx = active()
    return 0 if ctx is None else int(ctx.mesh.coords["model"])


def seq_split(shape) -> bool:
    """Whether the ``carry`` [B, T, d] of this whole ``shape`` is split over
    T (a sequence-parallel policy, T divisible by the model axis)."""
    ctx = active()
    if ctx is None:
        return False
    spec = dist_ctx.spec_of("carry", shape)
    return spec is not None and spec[1] is not None


# --------------------------------------------------------------- autograd ops


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    k = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * k, k).contiguous()


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group), None, None


class _SliceAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group).clone()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``j`` of dim 0 to model rank ``j``; block ``j`` of the result
    from rank ``j`` (gloo takes CUDA tensors here: chip_smoke.gloo_probe)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def copy_to_model(x):
    """Identity forward, all-reduce (SUM) of the gradient over the model group."""
    return x if active() is None else _CopyToModel.apply(x, _group())


def reduce_from_model(x):
    """All-reduce (SUM) forward over the model group, identity backward."""
    return x if active() is None else _ReduceFromModel.apply(x, _group())


def gather_along(x, dim: int):
    """The model ranks' blocks concatenated along ``dim``; backward: the
    rank's block of the gradient."""
    return x if active() is None else _GatherAlong.apply(x, dim % x.ndim, _group())


def slice_along(x, dim: int):
    """The rank's block of ``x`` along ``dim``; backward: the ranks'
    gradients all-gathered."""
    return x if active() is None else _SliceAlong.apply(x, dim % x.ndim, _group())


def sum_over_model(x):
    """All-reduce (SUM) over the model group, forward and backward: a sum of
    the ranks' partial terms that every rank then reads."""
    return x if active() is None else _SumOverModel.apply(x, _group())


def all_to_all(x):
    """``x`` [m, ...]: block ``j`` of dim 0 sent to model rank ``j``, and
    block ``j`` of the result the one rank ``j`` sent here (the reference's
    ``all_to_all(split_axis=0, concat_axis=0)``); backward: the reverse
    exchange of the gradient, which is the same exchange."""
    return x if active() is None else _AllToAll.apply(x, _group())


def mean_over_model(x):
    """The model ranks' mean of a per-rank term that the loss counts once
    (EP's per-slice load-balance loss): all-reduce forward over ``m``,
    identity backward, so each rank's gradient reaches its own term with
    weight ``1/m`` (a summing backward would count it ``m`` times)."""
    return x if active() is None else reduce_from_model(x) / model_size()


def whole(x, shape):
    """``x``, a rank's block of a leaf of the whole ``shape``, gathered
    along each dimension where it is narrower (the identity for a
    replicated leaf); backward: the rank's block of the gradient."""
    for dim, (have, want) in enumerate(zip(x.shape, shape, strict=True)):
        if have < want:
            x = gather_along(x, dim)
    return x


def partial_weight(w, partial: bool):
    """A replicated weight that reads only this rank's part of its input
    (``partial``: QK-norm over the rank's heads, a norm over its block of
    T under sequence parallelism): its gradient is the model ranks' sum."""
    return copy_to_model(w) if partial else w


def enter(y, sharded: bool, seq: bool):
    """Into a column-parallel sub-layer: the whole sequence (``seq``), then
    *f* when the sub-layer's weights are sharded."""
    if seq:
        y = gather_along(y, 1)
    return copy_to_model(y) if sharded else y


def leave(o, sharded: bool, seq: bool):
    """Out of a row-parallel sub-layer: *g* when its weights are sharded,
    then the rank's block of the sequence (``seq``)."""
    if sharded:
        o = reduce_from_model(o)
    return slice_along(o, 1) if seq else o


# ------------------------------------------------------------ vocab shards


def embed_rows(table: torch.Tensor, ids: torch.Tensor, vocab: int, width: int) -> torch.Tensor:
    """Rows of ``ids`` from this rank's shard of the [vocab, width] table:
    a block of rows gives zeros for the ids it does not hold and the model
    ranks' rows are summed; a block of columns is all-gathered along d."""
    rows, cols = table.shape
    if active() is None or (rows == vocab and cols == width):
        return table[ids]
    if rows < vocab:
        local = ids.long() - model_rank() * rows
        inside = (local >= 0) & (local < rows)
        out = torch.where(inside[..., None], table[local.clamp(0, rows - 1)], 0.0)
        return reduce_from_model(out)
    return gather_along(table[ids], -1)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over vocab shards:
    ``logits`` [N, V/m] this rank's columns ``[r0, r0 + V/m)``."""

    @staticmethod
    def forward(ctx, logits, labels, r0, group):
        v = logits.shape[-1]
        lmax = logits.max(dim=-1).values
        dist.all_reduce(lmax, op=dist.ReduceOp.MAX, group=group)
        shifted = logits - lmax[..., None]
        e = torch.exp(shifted)
        total = e.sum(dim=-1)
        dist.all_reduce(total, group=group)
        local = labels.long() - r0
        inside = (local >= 0) & (local < v)
        idx = local.clamp(0, v - 1)
        gold = torch.where(inside, shifted.gather(-1, idx[..., None])[..., 0], 0.0)
        dist.all_reduce(gold, group=group)
        e.div_(total[..., None])  # this rank's columns of the softmax
        ctx.save_for_backward(e, idx, inside)
        return torch.log(total) - gold

    @staticmethod
    def backward(ctx, g):
        softmax, idx, inside = ctx.saved_tensors
        grad = softmax.clone()
        grad.scatter_add_(-1, idx[..., None], -inside.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


def token_losses(w: torch.Tensor, h: torch.Tensor, labels: torch.Tensor, vocab: int,
                 logits_of) -> torch.Tensor | None:
    """``logsumexp - gold`` per token of ``h`` [..., d] against this rank's
    shard of the head ``w`` (``logits_of(w, h)`` the plain contraction), or
    None when the head is whole (the caller's plain path)."""
    rows, cols = w.shape
    if active() is None or (rows == vocab and cols == h.shape[-1]):
        return None
    if rows < vocab:
        logits = logits_of(w, copy_to_model(h))
        r0 = model_rank() * rows
        if r0 + rows > vocab:  # a padded table's rows past the vocabulary
            live = torch.arange(rows, device=logits.device) < vocab - r0
            logits = torch.where(live, logits, -torch.inf)
        return _VocabParallelCE.apply(logits, labels, r0, _group())
    logits = reduce_from_model(logits_of(w, slice_along(h, -1)))
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


# ------------------------------------------------- the step's layout


def _layout() -> dist_ctx.StepLayout:
    ctx = dist_ctx.current()
    return dist_ctx.StepLayout() if ctx is None else ctx.layout


def rows_any(mask: torch.Tensor) -> torch.Tensor:
    """A row's flag set on any model rank (a row touched in another rank's
    columns is touched) when the table is sharded over d, else ``mask``."""
    if not (_layout().width_split and active() is not None):
        return mask
    t = mask.to(torch.float32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_group())
    return t > 0


def rows_sum(g: torch.Tensor) -> torch.Tensor:
    """A per-row sum over the model ranks' columns (ALPT's Delta gradient)
    when the table is sharded over d, else ``g``."""
    if not (_layout().width_split and active() is not None):
        return g
    g = g.contiguous().clone()
    dist.all_reduce(g, group=_group())
    return g


class _DataMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y * (1.0 / n)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks that split the batch (the data group; under
    dp, where the model axis is more data parallelism, every rank) of a
    statistic of the batch (the MoE load-balance loss's token shares and
    mean router probabilities), so a split batch gives the whole batch's;
    its gradient passes as it is, each rank's share of the whole batch's
    gradient before the step's mean.  ``x`` itself when the batch is not
    split."""
    ctx = dist_ctx.current()
    if ctx is None or not _layout().batch_split:
        return x
    if ctx.policy.pure_dp:
        return _DataMean.apply(x, None, ctx.mesh.size)
    n = int(ctx.mesh.shape.get("data", 1))
    return x if n <= 1 else _DataMean.apply(x, ctx.mesh.groups["data"], n)


# ------------------------------------------------------------ fsdp and dp


class _GatherMean(torch.autograd.Function):
    """The ranks' blocks of ``gather`` all-gathered along ``dim``; backward:
    with ``mean`` the exact rank-ordered mean of the ranks' gradients over
    ``over`` (``collectives.exact_pmean_local``, None: the world), then
    this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, gather, mean, over):
        ctx.dim, ctx.gather, ctx.mean, ctx.over = dim, gather, mean, over
        return _all_gather(x, dim, gather)

    @staticmethod
    def backward(ctx, g):
        if ctx.mean:
            g = collectives.exact_pmean_local(g, ctx.over)
        return _own_slice(g, ctx.dim, ctx.gather), None, None, None, None


def fsdp_active() -> bool:
    """Whether the active policy cuts projections over a data axis of
    size > 1 (fsdp)."""
    ctx = dist_ctx.current()
    return (ctx is not None and ctx.policy.fsdp
            and int(ctx.mesh.shape.get("data", 1)) > 1)


def fsdp_whole(tree: dict, shapes: dict) -> dict:
    """A sub-layer's leaves (``tree``, one group's: the whole ``shapes``)
    with each projection that fsdp cuts over the data axis
    (``sharding.fsdp_dim``) all-gathered over the data group; the identity
    without fsdp.  The backward means the data ranks' gradients of the
    whole leaf (when the batch is split) and keeps this rank's block."""
    if not fsdp_active():
        return tree
    ctx = dist_ctx.current()
    group = ctx.mesh.groups["data"]
    out = {}
    for k, v in tree.items():
        dim = sharding.fsdp_dim(k)
        if dim is not None and v.shape[dim] < shapes[k][dim]:
            v = _GatherMean.apply(v, dim % v.ndim, group, _layout().batch_split, group)
        out[k] = v
    return out


def vocab_whole(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Under dp: ``x``, this rank's block of a [rows, cols] table or head
    split over the model axis (a padded table's block of its allocated
    rows), all-gathered over the model group and cut to [rows, cols]; its
    gradient the exact mean over every rank of the mesh (the batch's
    split), then this rank's block.  ``x`` itself otherwise."""
    ctx = active()
    if ctx is None or not ctx.policy.pure_dp or (x.shape[0] >= rows and x.shape[1] >= cols):
        return x
    dim = 0 if x.shape[0] < rows else 1
    whole = _GatherMean.apply(x, dim, _group(), _layout().batch_split, None)
    return whole[:rows, :cols]
