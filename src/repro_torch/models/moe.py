"""Mixture-of-Experts: top-k routing with per-sample capacity dispatch (port
of repro/models/moe.py).

The dispatch buffer keeps the batch dim leading, ``[B, E, C, d]`` with
capacity ``C = int(S * k * capacity_factor / E) + 1`` per *sample*; the
(token, slot) pairs are taken token-major (slot order inside a token), each
pair's place in its expert is an exclusive running count per sample, so
token order decides the drops, and a dropped pair passes nothing (the
residual carries its token).  Shared experts (DeepSeek-MoE: always-on,
added to the routed output) and the load-balance auxiliary loss are as the
reference's.  Everything here is plain PyTorch: the reference's expert
products are plain jnp einsums, outside any Pallas kernel.

Where the reference differs only by its framework:

* ``jax.lax.top_k`` puts the lower expert index first on a tie, and
  ``torch.topk`` promises no order; the selection here is a stable
  descending sort, whose order on ties is the reference's.
* The reference scatters dropped pairs to index ``C`` and lets
  ``.at[].add(mode="drop")`` discard them; here only the kept pairs are
  written (``index_put`` raises on an out-of-range index).  Kept pairs hold
  distinct slots, so writing them equals adding them into zeros.

Expert shards (the reference's ``moe_buf`` hints under a ``tp`` policy):
when this rank holds ``E/m`` of the experts (``repro_torch.dist``), the
router and the dispatch run as above on every model rank, the rank runs
its experts on its slice of the buffer and combines their gate-weighted
outputs, and one all-reduce over the model group sums the ranks'.  The
router and the shared experts are replicated and count once.  One body
serves both: with every expert on the rank, the slice is the whole buffer
and the collectives are the identity.

Expert parallelism (:func:`moe_forward_ep`, the reference's explicit
dispatch under an ``ep`` policy): each model rank routes its slice of the
sequence, sends every expert owner its pairs through an all-to-all, runs
its experts on what it receives and sends the outputs back; one all-reduce
restores the replicated [B, S, d].  Capacity and drops are per slice, and
the load-balance loss is the slice's, averaged over the model ranks: not
the dense layer's numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import tensor_parallel as tp


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int  # per-expert hidden dim
    n_shared_experts: int = 0
    shared_d_ff: int | None = None  # defaults to d_ff * n_shared
    capacity_factor: float = 1.25
    normalize_gates: bool = True  # renormalize top-k probs (Mixtral-style)
    aux_loss_coef: float = 0.01

    @property
    def shared_hidden(self) -> int:
        if self.n_shared_experts == 0:
            return 0
        return self.shared_d_ff or self.d_ff * self.n_shared_experts


def init_moe(generator: torch.Generator, cfg: MoEConfig, dtype=torch.float32) -> dict[str, Any]:
    """Router, experts and shared experts drawn from ``generator`` on its
    device, in the reference's layout and scales (the draws are torch's)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dev = generator.device

    def normal(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dt)

    scale_in, scale_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    params = {
        "router": normal((d, e), scale_in, torch.float32),
        "w_gate": normal((e, d, f), scale_in),
        "w_up": normal((e, d, f), scale_in),
        "w_down": normal((e, f, d), scale_out),
    }
    if cfg.n_shared_experts:
        fs = cfg.shared_hidden
        params["shared"] = {"w_gate": normal((d, fs), scale_in),
                            "w_up": normal((d, fs), scale_in),
                            "w_down": normal((fs, d), scale_out)}
    return params


def capacity(cfg: MoEConfig, seq_len: int) -> int:
    c = int(seq_len * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(c, 1)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries of the last dim,
    largest first and the lower index first on a tie (``jax.lax.top_k``'s
    order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """x [B, S, d] -> ``(probs [B, S, E], gates [B, S, k], experts [B, S*k],
    one-hot [B, S*k, E], places [B, S*k])``: the router's softmax, its top-k
    (renormalized where the config says so), and each (token, slot) pair's
    place within its expert, an exclusive running count in token order."""
    b, s, _ = x.shape
    probs = torch.softmax(x.to(torch.float32) @ router, dim=-1)
    gate_vals, expert_ids = top_k(probs, cfg.top_k)
    if cfg.normalize_gates:
        gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    flat_e = expert_ids.reshape(b, s * cfg.top_k)
    oh = F.one_hot(flat_e, cfg.n_experts)
    pos = torch.cumsum(oh, dim=1) - oh  # exclusive prefix count
    return probs, gate_vals, flat_e, oh, (pos * oh).sum(-1)


def moe_forward(params: dict[str, Any], x: torch.Tensor, cfg: MoEConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> ``(y [B, S, d], aux_loss scalar)``.

    On a rank that holds experts ``[e0, e0 + E/m)`` (``params``' expert
    stacks shorter than ``E``), the routing and places are the whole
    model's, the rank runs its experts on its pairs, and their gate-weighted
    sum is all-reduced over the model group; the experts' input and the
    gates enter through ``tp.enter`` (each rank's gradient covers its
    experts only), while the router and the shared experts read ``x`` as it
    is (their gradients are whole on every rank).  With every expert here,
    ``e0`` is 0 and the collectives are the identity."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    el = params["w_gate"].shape[0]
    split = el < e
    e0 = tp.model_rank() * el if split else 0
    c = capacity(cfg, s)

    probs, gate_vals, flat_e, oh, flat_p = _route(x, params["router"], cfg)
    keep = (flat_p < c) & (flat_e >= e0) & (flat_e < e0 + el)  # kept, and this rank's

    # Dispatch the kept pairs into [B, E/m, C, d].
    x_e = tp.enter(x, split, False)
    x_rep = x_e[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    local_e = torch.clamp(flat_e - e0, 0, el - 1)
    buf = x.new_zeros((b, el, c, d)).index_put(
        (bidx[keep], local_e[keep], flat_p[keep]), x_rep[keep])

    # Per-expert SwiGLU.
    h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"]))
    h = h * torch.einsum("becd,edf->becf", buf, params["w_up"])
    y_buf = torch.einsum("becf,efd->becd", h, params["w_down"])  # [B, E/m, C, d]

    # Gather back (dropped pairs read a clamped slot and weigh 0) and combine.
    y_tok = y_buf[bidx, local_e, torch.clamp_max(flat_p, c - 1)]  # [B, S*k, d]
    gates = tp.enter(gate_vals, split, False).reshape(b, s * k, 1)
    y_tok = y_tok * (keep[..., None] * gates).to(y_tok.dtype)
    y = tp.leave(y_tok.reshape(b, s, k, d).sum(dim=2), split, False)

    if cfg.n_shared_experts:
        sh = params["shared"]
        y = y + (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]

    # Load-balance loss (Switch/Mixtral form): E * sum_e f_e * P_e, with f_e
    # the share of tokens routed to e before any drop; over a batch split
    # across data ranks, the whole batch's shares (tp.batch_mean).
    routed = oh.reshape(b, s, k, e).sum(dim=2) > 0
    frac_tokens = tp.batch_mean(torch.mean(routed.to(torch.float32), dim=(0, 1)))  # [E]
    mean_probs = tp.batch_mean(torch.mean(probs, dim=(0, 1)))
    aux = cfg.aux_loss_coef * e * torch.sum(frac_tokens * mean_probs)
    return y.to(x.dtype), aux


def moe_forward_ep(params: dict[str, Any], x: torch.Tensor, cfg: MoEConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d], the same on every rank of the active context's model
    group of ``m`` ranks, this rank ``r`` holding experts ``[r E/m, (r+1)
    E/m)`` -> ``(y [B, S, d], aux)``, the reference's ``moe_forward_ep``
    (``repro/models/moe.py:142``) step by step:

    1. this rank's slice of the sequence, ``s_loc = S // m`` tokens from
       ``r s_loc`` (tokens past ``m s_loc`` get no output at all, routed or
       shared, as in the reference), routed;
    2. a send buffer [m, E/m, B, C, d] with ``C = int(s_loc k cf / E) + 1``,
       pairs placed in token order within the slice (later ones dropped);
    3. an all-to-all, this rank's experts (SwiGLU) on what every rank sent
       it, an all-to-all back;
    4. the gate-weighted combine and the shared experts on the slice, the
       slice placed in zeros of [B, S, d] and summed over the model group.

    The input enters through ``tp.copy_to_model`` and the router and the
    shared experts through ``tp.partial_weight``: each rank reads only its
    slice, so their gradients are the ranks' sum; the output's all-reduce
    has an identity backward.  ``aux`` is the slice's load-balance loss
    averaged over the model ranks (``tp.mean_over_model``: counted once)."""
    m, r = tp.model_size(), tp.model_rank()
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    el, s_loc = e // m, s // m
    xs = tp.copy_to_model(x)[:, r * s_loc:(r + 1) * s_loc]
    probs, gate_vals, flat_e, oh, flat_p = _route(xs, tp.partial_weight(params["router"], True),
                                                  cfg)
    c = capacity(cfg, s_loc)
    keep = flat_p < c
    dest_rank, dest_exp = flat_e // el, flat_e % el
    bidx = torch.arange(b, device=x.device)[:, None].expand(b, s_loc * k)
    x_rep = xs[:, :, None, :].expand(b, s_loc, k, d).reshape(b, s_loc * k, d)
    send = x.new_zeros((m, el, b, c, d)).index_put(
        (dest_rank[keep], dest_exp[keep], bidx[keep], flat_p[keep]), x_rep[keep])

    recv = tp.all_to_all(send)  # [m (source), E/m, B, C, d]: pairs for this rank's experts
    h = F.silu(torch.einsum("sebcd,edf->sebcf", recv, params["w_gate"]))
    h = h * torch.einsum("sebcd,edf->sebcf", recv, params["w_up"])
    back = tp.all_to_all(torch.einsum("sebcf,efd->sebcd", h, params["w_down"]))

    y_tok = back[dest_rank, dest_exp, bidx, torch.clamp_max(flat_p, c - 1)]  # [B, s_loc*k, d]
    y_tok = y_tok * (keep[..., None] * gate_vals.reshape(b, s_loc * k, 1)).to(y_tok.dtype)
    ys = y_tok.reshape(b, s_loc, k, d).sum(dim=2)
    if cfg.n_shared_experts:
        sh = {n: tp.partial_weight(w, True) for n, w in params["shared"].items()}
        ys = ys + (F.silu(xs @ sh["w_gate"]) * (xs @ sh["w_up"])) @ sh["w_down"]
    y = tp.reduce_from_model(F.pad(ys.to(x.dtype), (0, 0, r * s_loc, s - (r + 1) * s_loc)))

    routed = oh.reshape(b, s_loc, k, e).sum(dim=2) > 0
    frac_tokens = torch.mean(routed.to(torch.float32), dim=(0, 1))
    mean_probs = torch.mean(probs, dim=(0, 1))
    aux = cfg.aux_loss_coef * e * torch.sum(frac_tokens * mean_probs)
    return y, tp.mean_over_model(aux)
