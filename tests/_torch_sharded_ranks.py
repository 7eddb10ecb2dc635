"""One rank of the sharded-step tests (tests/test_torch_sharded_step.py,
tests/test_torch_cuda.py): ``python tests/_torch_sharded_ranks.py DIR RANK
WORLD DATA MODEL DEVICE``.

Joins a gloo group through ``DIR/init``, reads ``DIR/in.pt`` (the parent's
one-process states, batches and noise, as numpy), runs every check of the
launch on a ``DATA x MODEL`` mesh (a case marked ``data_only`` on a
``WORLD x 1`` one; each case's policy with the mesh's ``model_size`` and
``data_size``) and writes ``DIR/rank<r>.pt`` (rank 0: the gathered states
and losses; every rank: its flags, per case and in all, the guard's world
verdicts, the one-process checkpoint restored under each policy, and its
``moe_forward_ep`` results).
Imports torch and the port only, so the same program runs on the card.

:func:`moe_ep_twin` is the one-process twin of the expert-parallel MoE
(``models.moe.moe_forward_ep`` on a mesh), which the tests and
``chip_smoke.py`` put in a one-process step with :func:`ep_twin`.
"""
import contextlib
import dataclasses
import datetime
import pathlib
import sys

import torch
import torch.distributed as dist
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import faults, interop, methods  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.dist import collectives, context, sharding  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.training import lm_trainer  # noqa: E402


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _cpu(tree):
    return _to(tree, "cpu")


def _whole_state(case, dev):
    return interop.lm_state_from_numpy(case["cfg"], case["tcfg"], **case["state"], device=dev)


def _step_case(case, mesh, pol, dev):
    """A one-process state (or this rank's init) sharded, one step, gathered.
    ``guard_at``: a guarded step under a plan that poisons the params at
    those steps, taken twice: the steps' verdicts and whether this rank's
    shards came through the second as they were.  Returns the rank's state,
    the whole state, the first step's metrics and the rank's flags."""
    cfg, tcfg = case["cfg"], case["tcfg"]
    guard_at = case.get("guard_at")
    if guard_at is not None:  # the seams bind when the step is made
        faults.install(faults.FaultPlan(specs=(faults.FaultSpec(site="trainer.nonfinite",
                                                                steps=guard_at),)))
    try:
        with context.use(mesh, pol):
            sh = lm_trainer._shards(cfg, tcfg)
            if "state" in case:
                state = sharding.shard_tree(_whole_state(case, dev), sh.specs, mesh)
            else:
                state = lm_trainer.init_state(cfg, tcfg, seed=case["seed"], device=dev)
            step = lm_trainer.wrap_host_refresh(  # prune's mask; the identity for the others
                lm_trainer.make_train_step(cfg, tcfg, donate=case.get("donate", False)), cfg,
                tcfg)
    finally:
        faults.uninstall()
    noise = case.get("noise")
    batch = _to(case["batch"], dev)
    state, m = step(state, batch, None if noise is None else noise.to(dev))
    guard = None
    if guard_at is not None:
        new, m2 = step(state, batch)
        guard = {"skipped": [int(m["guard_skipped"]), int(m2["guard_skipped"])],
                 "kept": _same_state(new, state, clocks=False)}
        state = new
    with context.use(mesh, pol):
        whole = sharding.gather_tree(state, sh.specs, mesh)
    # Replicated leaves (params, and a table and its float leaves' Adam
    # moments where the specs keep them whole) are the same on every rank.
    same = True
    for leaf in _replicated(state, sh.specs, mesh):
        wire = leaf.contiguous().view(torch.uint8) if leaf.dtype in (torch.int8,
                                                                     torch.bool) else leaf
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire.contiguous())
        same &= all(torch.equal(p, wire) for p in parts)
    metrics = {k: float(v) for k, v in m.items() if torch.is_tensor(v) and v.ndim == 0}
    return state, whole, metrics, {"guard": guard, "same_replicas": bool(same)}


def _replicated(state, specs, mesh) -> list:
    """The tensors of ``state`` whose spec places nothing over the mesh (a
    code container's bytes), in the spec tree's order."""
    from repro_torch.core.codestore import CodeStore

    out = []

    def keep(leaf, spec):
        if not sharding.is_sharded(spec, mesh):
            out.append(leaf.data if isinstance(leaf, CodeStore) else leaf)
        return leaf

    sharding._map_specs(keep, state._replace(generator=None), specs._replace(generator=None))
    return out


def _guard_world(dev) -> list:
    """The guard's verdicts over the world group when only rank 0's shard
    of the params comes out non-finite: a step that does so at its first
    call, then a clean one."""
    state = lm_trainer.LMTrainState(params={"w": torch.ones(3, device=dev)}, opt=None,
                                    table=None, table_opt=None, step=0,
                                    generator=torch.Generator(device=dev))

    def step(st, batch):
        bad = st.step == 0 and dist.get_rank() == 0
        w = st.params["w"] * (torch.nan if bad else 2.0)
        return st._replace(params={"w": w}, step=st.step + 1), {"loss": torch.ones((), device=dev)}

    guarded = faults.wrap_lm_step(step, group=dist.group.WORLD)
    verdicts = []
    for _ in range(2):
        state, m = guarded(state, None)
        verdicts.append(int(m["guard_skipped"]))
    return verdicts


def _subtables(table):
    """The code tables of a method's state (one, or a composed table's)."""
    if hasattr(table, "codes"):
        return [table]
    if isinstance(table, tuple):
        return [t for x in table for t in _subtables(x)]
    return []


def _table_np(table):
    if isinstance(table, torch.Tensor):
        return {"table": table.cpu()}
    if not hasattr(table, "codes"):  # a composed table: its codes and Deltas, in order
        subs = _subtables(table)  # (none: a float-leaf method's, held through "emb")
        if not subs:
            return {}
        return {"codes": torch.cat([t.codes.data.reshape(-1).cpu() for t in subs]),
                "step": torch.cat([t.step.cpu() for t in subs])}
    return {"codes": table.codes.data.cpu(), "step": table.step.cpu(), "mu": table.mu.cpu(),
            "nu": table.nu.cpu()}


def main(directory, rank, world, data, model, device):
    directory = pathlib.Path(directory)
    torch.set_num_threads(1)
    dev = torch.device(device)
    dist.init_process_group("gloo", init_method=f"file://{directory}/init", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    inp = torch.load(directory / "in.pt", weights_only=False)
    mesh = make_host_mesh(data, model)
    data_only = None  # the same ranks as a world x 1 mesh, made when a case asks
    out = {"steps": {}, "guard_world": _guard_world(dev)}
    for name, case in inp["steps"].items():
        at = mesh
        if case.get("data_only"):
            data_only = data_only or make_host_mesh(world, 1)
            at = data_only
        pol = sharding.policy_from_name(case["policy"], model_size=at.shape["model"],
                                        data_size=at.shape["data"])
        state, whole, metrics, flags = _step_case(case, at, pol, dev)
        spec = lm_trainer.embedding_spec_of(case["cfg"], case["tcfg"])
        out["steps"][name] = {"metrics": metrics, "params": _cpu(whole.params),
                              "opt": _cpu([whole.opt.mu, whole.opt.nu]),
                              "table": _table_np(whole.table),
                              "emb": _cpu(methods.get(spec.method).trainable_params(whole.table,
                                                                                    spec)),
                              "mask": _cpu(getattr(whole.table, "mask", None)), **flags}
        if name in inp.get("save_cases", ()):
            # Save from shards: every rank gathers, rank 0 writes whole leaves.
            with context.use(mesh, pol):
                lm_trainer.save(CheckpointManager(directory / f"ck_mesh_{name}"), case["cfg"],
                                state, case["tcfg"], force=True)
        del state, whole

    out["same_replicas"] = all(c["same_replicas"] for c in out["steps"].values())

    if "restore" in inp:  # a 1 x 1 checkpoint restored on this mesh, under each policy
        case = inp["restore"]
        out["restore"] = {}
        for name in case["policies"]:
            pol = sharding.policy_from_name(name, model_size=model, data_size=data)
            with context.use(mesh, pol):
                got = lm_trainer.restore(CheckpointManager(directory / "ck_one"), case["cfg"],
                                         case["tcfg"], device=dev)
                sh = lm_trainer._shards(case["cfg"], case["tcfg"])
                want = sharding.shard_tree(_whole_state(case, dev), sh.specs, mesh)
                back = sharding.gather_tree(want, sh.specs, mesh)
            whole = _whole_state(case, dev)
            out["restore"][name] = {"bitwise": _same_state(got, want),
                                    "identity": _same_state(back, whole)}

    if "rows" in inp:  # rung 2: the same gradient rows give the same shard rows
        out["rows"] = _rows_check(inp["rows"], mesh, dev)

    if "chunked_mean" in inp:  # exact_pmean_local chunk by chunk, bitwise the whole leaf's
        g = torch.Generator().manual_seed(100 + rank)
        leaf = torch.randn(inp["chunked_mean"], generator=g).to(dev)
        whole = collectives.exact_pmean_local(leaf)
        real = collectives.MEAN_CHUNK
        collectives.MEAN_CHUNK = 7
        try:
            chunked = collectives.exact_pmean_local(leaf)
        finally:
            collectives.MEAN_CHUNK = real
        out["chunked_mean"] = (torch.equal(whole, chunked), whole.cpu())

    if "ep" in inp:  # the port's moe_forward_ep against the reference's
        out["ep"] = [_ep_case(c, mesh, dev) for c in inp["ep"]]

    for key in ("cli", "cli_ep", "cli_fsdp"):  # the CLI on the launcher's group (it keeps it)
        if key in inp:
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                code = train_cli.main(inp[key])
            out[key] = {"code": code, "stdout": buf.getvalue()}
    torch.save(out, directory / f"rank{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _same_state(a, b, clocks: bool = True) -> bool:
    """Two states' params, Adam moments and table bitwise equal, and with
    ``clocks`` their step counters and generators too."""
    la = tree_leaves(a.params) + a.opt.mu + a.opt.nu
    lb = tree_leaves(b.params) + b.opt.mu + b.opt.nu
    same = all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))
    if clocks:
        same = (same and a.step == b.step
                and torch.equal(a.generator.get_state(), b.generator.get_state()))
    if isinstance(a.table, torch.Tensor):
        return same and torch.equal(a.table, b.table)
    ta, tb = a.table, b.table
    return (same and torch.equal(ta.codes.data, tb.codes.data) and torch.equal(ta.step, tb.step)
            and torch.equal(ta.mu, tb.mu) and torch.equal(ta.nu, tb.nu) and ta.count == tb.count)


def _ep_case(case, mesh, dev) -> dict:
    """``moe_forward_ep`` under ``tp_ep`` on this rank (its data row's block
    of the parent's numpy batch, its experts), then the backward of
    ``sum(y * ct) + aux``: y, aux, and the gradients of the input and of
    every weight the rank holds, on the host."""
    cfg, p = case["cfg"], case["params"]
    m, r = mesh.shape["model"], mesh.coords["model"]
    el, bd = cfg.n_experts // m, case["x"].shape[0] // mesh.shape["data"]
    rows = slice(mesh.coords["data"] * bd, (mesh.coords["data"] + 1) * bd)

    def leaf(a):
        return torch.from_numpy(a).to(dev).requires_grad_(True)

    params = {"router": leaf(p["router"]),
              **{n: leaf(p[n][r * el:(r + 1) * el]) for n in ("w_gate", "w_up", "w_down")}}
    if "shared" in p:
        params["shared"] = {n: leaf(v) for n, v in p["shared"].items()}
    x = leaf(case["x"][rows])
    pol = sharding.policy_from_name("tp_ep", model_size=m)
    with context.use(mesh, pol):
        y, aux = moe_mod.moe_forward_ep(params, x, cfg)
        (torch.sum(y * torch.from_numpy(case["ct"][rows]).to(dev)) + aux).backward()
    grads = {"x": x.grad, **{n: params[n].grad for n in ("router", "w_gate", "w_up", "w_down")}}
    if "shared" in p:
        grads["shared"] = {n: w.grad for n, w in params["shared"].items()}
    return {"y": y.detach().cpu(), "aux": float(aux), "grads": _cpu(grads)}


def moe_ep_twin(params, x, cfg, data: int, model: int):
    """``moe_forward_ep``'s arithmetic for the cells of a ``data x model``
    mesh in one process: each data row's block of the batch (the whole
    batch where the axis does not divide it, as the sharded step
    replicates it), each of its ``model`` virtual ranks routing its slice
    of the sequence into a send buffer [model, E/model, b, C, d], the
    buffers' blocks stacked where the all-to-all exchanges them, each
    virtual rank's experts on what it receives, the return trip stacked
    back; the slices concatenated where the all-reduce sums them (tokens
    past ``model * s_loc`` get no output), the aux the mean of the cells'.
    -> ``(y [B, S, d], aux)``, differentiable in ``params`` and ``x``."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    data = data if b % data == 0 else 1
    bd, el, s_loc = b // data, e // model, s // model
    c = max(int(s_loc * k * cfg.capacity_factor / e) + 1, 1)
    rows, auxes = [], []
    for i in range(data):
        xb = x[i * bd:(i + 1) * bd]
        sends, routes = [], []
        for j in range(model):  # virtual rank j routes its slice
            xs = xb[:, j * s_loc:(j + 1) * s_loc]
            probs = torch.softmax(xs.to(torch.float32) @ params["router"], dim=-1)
            gates, ids = moe_mod.top_k(probs, k)
            if cfg.normalize_gates:
                gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
            flat_e = ids.reshape(bd, s_loc * k)
            oh = F.one_hot(flat_e, e)
            flat_p = ((torch.cumsum(oh, dim=1) - oh) * oh).sum(-1)
            keep = flat_p < c
            bidx = torch.arange(bd, device=x.device)[:, None].expand(bd, s_loc * k)
            x_rep = xs[:, :, None, :].expand(bd, s_loc, k, d).reshape(bd, s_loc * k, d)
            sends.append(xs.new_zeros((model, el, bd, c, d)).index_put(
                (flat_e[keep] // el, flat_e[keep] % el, bidx[keep], flat_p[keep]), x_rep[keep]))
            routes.append((xs, flat_e, flat_p, keep, bidx, gates))
            routed = oh.reshape(bd, s_loc, k, e).sum(dim=2) > 0
            auxes.append(cfg.aux_loss_coef * e * torch.sum(
                torch.mean(routed.to(torch.float32), dim=(0, 1)) * torch.mean(probs, dim=(0, 1))))
        outs = []
        for r in range(model):  # virtual rank r's experts on every rank's block for them
            recv = torch.stack([sends[j][r] for j in range(model)])
            w = {n: params[n][r * el:(r + 1) * el] for n in ("w_gate", "w_up", "w_down")}
            h = F.silu(torch.einsum("sebcd,edf->sebcf", recv, w["w_gate"]))
            h = h * torch.einsum("sebcd,edf->sebcf", recv, w["w_up"])
            outs.append(torch.einsum("sebcf,efd->sebcd", h, w["w_down"]))
        ys = []
        for j, (xs, flat_e, flat_p, keep, bidx, gates) in enumerate(routes):
            back = torch.stack([outs[r][j] for r in range(model)])
            y_tok = back[flat_e // el, flat_e % el, bidx, torch.clamp_max(flat_p, c - 1)]
            y_tok = y_tok * (keep[..., None] * gates.reshape(bd, s_loc * k, 1)).to(y_tok.dtype)
            y_j = y_tok.reshape(bd, s_loc, k, d).sum(dim=2)
            if cfg.n_shared_experts:
                sh = params["shared"]
                y_j = y_j + (F.silu(xs @ sh["w_gate"]) * (xs @ sh["w_up"])) @ sh["w_down"]
            ys.append(y_j.to(x.dtype))
        ys.append(xb.new_zeros((bd, s - model * s_loc, d)))
        rows.append(torch.cat(ys, dim=1))
    return torch.cat(rows, dim=0), torch.stack(auxes).mean()


@contextlib.contextmanager
def ep_twin(data: int, model: int):
    """One-process steps made and run inside it take :func:`moe_ep_twin`
    for their MoE layers (``models.moe.moe_forward`` swapped): the
    one-process twin of a ``tp_ep`` step on a ``data x model`` mesh."""
    real = moe_mod.moe_forward
    moe_mod.moe_forward = lambda params, x, cfg: moe_ep_twin(params, x, cfg, data, model)
    try:
        yield
    finally:
        moe_mod.moe_forward = real


def _rows_check(case, mesh, dev) -> dict:
    """Each method's ``dense_update`` on this rank's rows of the table, the
    one-process gradient's rows and noise's rows (ALPT: a fixed Delta
    gradient's rows): the updated shard, on the host (the parent holds it
    against the one-process update's rows)."""
    out = {}
    for name, c in case.items():
        cfg, tcfg = c["cfg"], c["tcfg"]
        pol = sharding.policy_from_name("tp", model_size=mesh.shape["model"])
        with context.use(mesh, pol):
            sh = lm_trainer._shards(cfg, tcfg)
        tspec = sh.specs.table
        table = sharding.shard_tree(_whole_state(c, dev).table, tspec, mesh)
        g = sharding.shard_tree(c["grad"].to(dev), tspec.codes, mesh)
        noise = sharding.shard_tree(c["noise"].to(dev), tspec.codes, mesh)
        g_step = sharding.shard_tree(c["g_step"].to(dev), tspec.step, mesh)
        new, _, _ = methods.get(name).dense_update(
            table, None, g, spec=sh.spec, lr=c["lr"], weight_decay=tcfg.emb_weight_decay,
            noise=noise, delta_grad=lambda w, s, gscale: g_step, batch_rows=c["batch_rows"])
        out[name] = new._replace(codes=dataclasses.replace(new.codes, data=new.codes.data.cpu()),
                                 step=new.step.cpu(), mu=new.mu.cpu(), nu=new.nu.cpu())
    return out


if __name__ == "__main__":
    d, r, w, dd, mm, device = sys.argv[1:7]
    sys.exit(main(d, int(r), int(w), int(dd), int(mm), device))
