"""One rank of the sharded-step tests (tests/test_torch_sharded_step.py,
tests/test_torch_cuda.py): ``python tests/_torch_sharded_ranks.py DIR RANK
WORLD DATA MODEL DEVICE``.

Joins a gloo group through ``DIR/init``, reads ``DIR/in.pt`` (the parent's
one-process states, batches and noise, as numpy), runs every check of the
launch on a ``DATA x MODEL`` mesh (a case marked ``data_only`` on a
``WORLD x 1`` one) and writes ``DIR/rank<r>.pt`` (rank 0:
the gathered states and losses; every rank: its flags, per case and in
all, and the guard's world verdicts).  Imports torch and the port only, so
the same program runs on the card.
"""
import dataclasses
import datetime
import pathlib
import sys

import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import faults, interop, methods  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.dist import context, sharding  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
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
            step = lm_trainer.make_train_step(cfg, tcfg, donate=case.get("donate", False))
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
    # Replicated leaves are the same on every rank of the mesh.
    same = True
    for leaf, spec in zip(tree_leaves(state.params), sharding.spec_leaves(sh.specs.params)):
        if not sharding.is_sharded(spec, mesh):
            parts = [torch.empty_like(leaf) for _ in range(mesh.size)]
            dist.all_gather(parts, leaf.contiguous())
            same &= all(torch.equal(p, leaf) for p in parts)
    metrics = {k: float(v) for k, v in m.items() if torch.is_tensor(v) and v.ndim == 0}
    return state, whole, metrics, {"guard": guard, "same_replicas": bool(same)}


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
    if not hasattr(table, "codes"):  # a composed table: its codes, flattened in order
        return {"codes": torch.cat([t.codes.data.reshape(-1).cpu() for t in _subtables(table)])}
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
        pol = sharding.policy_from_name(case["policy"], model_size=at.shape["model"])
        state, whole, metrics, flags = _step_case(case, at, pol, dev)
        out["steps"][name] = {"metrics": metrics, "params": _cpu(whole.params),
                              "table": _table_np(whole.table), **flags}
        if name == inp.get("save_case"):
            # Save from shards: every rank gathers, rank 0 writes whole leaves.
            with context.use(mesh, pol):
                lm_trainer.save(CheckpointManager(directory / "ck_mesh"), case["cfg"], state,
                                case["tcfg"], force=True)
        del state, whole

    out["same_replicas"] = all(c["same_replicas"] for c in out["steps"].values())

    if "restore" in inp:  # a 1 x 1 checkpoint restored on this mesh
        case = inp["restore"]
        pol = sharding.policy_from_name("tp", model_size=model)
        with context.use(mesh, pol):
            got = lm_trainer.restore(CheckpointManager(directory / "ck_one"), case["cfg"],
                                     case["tcfg"], device=dev)
            sh = lm_trainer._shards(case["cfg"], case["tcfg"])
            want = sharding.shard_tree(_whole_state(case, dev), sh.specs, mesh)
            back = sharding.gather_tree(want, sh.specs, mesh)
        whole = _whole_state(case, dev)
        out["restore_bitwise"] = _same_state(got, want)
        out["shard_gather_identity"] = _same_state(back, whole)

    if "rows" in inp:  # rung 2: the same gradient rows give the same shard rows
        out["rows"] = _rows_check(inp["rows"], mesh, dev)

    if "cli" in inp:  # last: the CLI tears the default group down
        import contextlib
        import io

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = train_cli.main(inp["cli"])
        out["cli"] = {"code": code, "stdout": buf.getvalue()}
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
