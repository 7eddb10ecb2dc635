"""The port's sharded LM step (every policy of the reference: tensor,
sequence and expert parallel, fsdp and dp, on a ``(data, model)`` grid of
gloo ranks) against the JAX package's single-device jitted step and the
port's own one-process step, at smoke configs on the CPU.

The reference's own sharded steps (tests/test_distribution.py) need 8 XLA
devices; the port is held to the contract they state against the
reference's single-device step: loss within 2e-3, codes differing on under
2% after one step (there: SR noise keyed alike, reductions reordered).
Against the port's one-process step from the same state, batch and noise
the bounds are tighter: loss within 1e-4; gradients (as the global norm)
within rtol 1e-5; every param within rtol 1e-4 / atol 1e-6 where its
one-process gradient is at least 1e-6, and within 2·lr elsewhere (AdamW's
first step is ``lr·g/(|g| + 1e-8)``: for |g| near eps the reordered sums'
last bits move the update by up to lr; measured: 2 of 49,152 qwen3 smoke
weights, gradients 7e-10 and 7e-8); codes differing on at most 0.5%
(measured 0).  Given the same table gradient rows, a shard's update is the
one-process update's rows bitwise (rung 2).

Four rank processes are spawned once for the module (a 2 x 2 grid, one
thread each, ``tests/_torch_sharded_ranks.py``) and run every check of the
module in one launch: qwen3-1.7b's smoke config (``head_pad_multiple=2``)
under ``tp`` and ``tp_sp``, mixtral's smoke config (4 experts, 2 a rank),
a vocabulary that does not divide the model axis (the table split over d),
qr_alpt on the same ranks as a 4 x 1 mesh (a data axis only); hubert's
smoke config under ``tp_sp`` (the gelu MLP's ``b_out`` added to a block of
T), qwen2-vl's (the mixed input mode, [3, B, T] grid positions, seeded
QKV biases), mamba2's under ``tp`` and ``tp_sp`` (the SSD heads split)
and at 3 SSD heads (``d_inner`` split, the heads not: gathered), jamba's
(mamba, attention and MoE layers in one period), SmolLM's 3/1
heads at D = 16 (``wq`` and ``wk`` split mid-head), a ``pad_to_tiles``
table (its 520 allocated rows split, the scratch row on rank 1), the
guard with ``trainer.nonfinite`` at step 1 (every rank skips); the seven
other embedding methods under the model axis (qr_lpt, qr_alpt, hash and
mixed replicated on every rank, prune with its mask refreshed over the
whole table, lsq and pact with rows split and, at the 509-row vocabulary,
with the width split); expert parallelism (``tp_ep``: deepseek-moe's and
jamba's smoke configs against a one-process twin of the EP arithmetic,
``_torch_sharded_ranks.moe_ep_twin``, and ``moe_forward_ep`` itself against
the reference's under ``jax.vmap(axis_name="model")``); the policies that
cut over the data axis or reuse the model axis for data (qwen3's smoke
config under ``fsdp_tp``, ``fsdp_tp_sp`` and ``dp`` from the reference's
state and noise, deepseek-moe's under ``fsdp_tp_ep`` and ``tp_sp_ep``
against its EP twin and under ``dp``, deepseek-67b's under ``fsdp_tp``, its reference
default, and h2o-danube's windowed attention under ``fsdp_tp_sp``); rung
2, checkpoints across meshes both ways (tp, fsdp_tp and dp shards), the
``train lm`` CLI (tp and fsdp_tp, and tp_ep against its one-process EP
twin).
"""
import contextlib
import dataclasses
import functools
import io
import json
import pathlib
import subprocess
import sys

import _torch_sharded_ranks as ranks_mod
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quant as jq
from repro.models import moe as jmoe
from repro.training import lm_trainer as jlm
from repro_torch import configs, faults, interop, methods
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import quant
from repro_torch.core.pruning import PruneConfig
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.dist import collectives, sharding
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import HostMesh
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig
from repro_torch.optim import tree_leaves
from repro_torch.training import lm_trainer

jax.config.update("jax_platform_name", "cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent
LR = 1e-3
BATCH, SEQ = 4, 32
CLI = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps", "2", "--batch",
       str(BATCH), "--seq", str(SEQ), "--log-every", "0"]
CLI_EP = ["--arch", "deepseek-moe-16b", *CLI[2:], "--policy", "tp_ep"]
#: The methods other than fp / lpt / alpt, each a case on the model axis.
OTHER_METHODS = ("qr_lpt", "qr_alpt", "hash", "mixed", "prune", "lsq", "pact")
#: prune's schedule in these cases: no warmup and a refresh after every
#: step, with a ratio of 0.25 after step 1 (damping 0.5 over 1 step); the
#: defaults' 200 warmup steps would keep every weight.
PRUNE = PruneConfig(target_sparsity=0.5, damping=0.5, damping_steps=1, warmup_steps=0,
                    update_every=1)
#: moe_forward_ep against the reference: 8 experts top-2 with a shared one,
#: capacity factor 1.25 (pairs drop), on the ranks' 2 x 2 grid; S = 16
#: splits over the model axis, S = 15 leaves the reference's last token out.
EP_MOE = MoEConfig(n_experts=8, top_k=2, d_model=16, d_ff=32, n_shared_experts=1, shared_d_ff=32)
EP_SEQ = {"even": 16, "ragged": 15}
#: qwen3's cases saved from their shards (each rank gathers, rank 0 writes),
#: and the policies the one-process checkpoint is restored under on the grid.
SAVED = ("qwen3_tp", "qwen3_fsdp_tp", "qwen3_dp")
RESTORED = ("tp", "fsdp_tp", "dp")


def _qwen3(**kw):
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen3-1.7b"), head_pad_multiple=2, **kw)
    cfg = dataclasses.replace(configs.smoke_config("qwen3-1.7b"), head_pad_multiple=2, **kw)
    return jcfg, cfg


def _batch(vocab, seed=0):
    data = LMTokenStream(vocab, SEQ, seed=17).batch(seed, BATCH)
    return ({"tokens": jnp.asarray(data[:, :-1]), "labels": jnp.asarray(data[:, 1:])},
            {"tokens": torch.from_numpy(data[:, :-1]), "labels": torch.from_numpy(data[:, 1:])})


def _ref_state_np(js):
    tree = jax.tree.map(np.asarray, js)
    return {"params": tree.params, "table": {
        "codes": np.asarray(js.table.codes.data), "step": tree.table.step, "mu": tree.table.mu,
        "nu": tree.table.nu, "count": tree.table.count},
        "opt": {"step": tree.opt.step, "mu": tree.opt.mu, "nu": tree.opt.nu}}


def _one_process(cfg, tcfg, state, batch, noise=None, guard_at=None, ep=False):
    """One step (``guard_at``: two guarded steps under a plan that poisons
    the params at those steps; prune's mask refreshed after it; ``ep``: the
    MoE layers through the EP twin of the 2 x 2 grid) -> (state, the first
    step's metrics, its params' gradients, its table's)."""
    with ranks_mod.ep_twin(2, 2) if ep else contextlib.nullcontext():
        g_emb, grads = lm_trainer.make_grad_fn(cfg, tcfg)(lm_trainer.clone_state(state),
                                                          batch)[1]
        if guard_at is not None:
            faults.install(faults.FaultPlan(specs=(faults.FaultSpec(site="trainer.nonfinite",
                                                                    steps=guard_at),)))
        try:
            step = lm_trainer.wrap_host_refresh(lm_trainer.make_train_step(cfg, tcfg), cfg, tcfg)
        finally:
            faults.uninstall()
        new, m = step(state, batch, noise)
        if guard_at is not None:
            new, _ = step(new, batch)
    return new, m, grads, g_emb


def _grid_positions(b, t, rows, cols):
    """[3, b, t] M-RoPE positions: a rows x cols patch grid (temporal 0),
    then text equal in all three streams."""
    pos = np.zeros((3, t), np.int32)
    pos[1, :rows * cols] = np.repeat(np.arange(rows), cols)
    pos[2, :rows * cols] = np.tile(np.arange(cols), rows)
    pos[:, rows * cols:] = max(rows, cols) + np.arange(t - rows * cols)
    return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, t))))


def _mesh_cases(pt):
    """The archs and options of the sharded path's model-level rest, each a
    case of the rank launch: (cfg, tcfg, policy, its init's seed or the
    whole state it starts from, batch, extras)."""
    g = np.random.RandomState(23)
    cases = {}
    hubert = configs.smoke_config("hubert-xlarge")
    tok = _batch(hubert.vocab_size, 3)[1]
    frames = torch.from_numpy(g.normal(0, 1, (BATCH, SEQ, hubert.d_model)).astype(np.float32))
    cases["hubert_tp_sp"] = (hubert, pt, "tp_sp", 15,
                             {"embeds": frames, "labels": tok["labels"]}, {})
    vl = configs.smoke_config("qwen2-vl-7b")
    st = lm_trainer.init_state(vl, pt, seed=17, device="cpu")
    for attn in (b["attn"] for b in st.params["blocks"] if "attn" in b):
        for name in ("bq", "bk", "bv"):
            attn[name] = torch.from_numpy(g.normal(0, 0.5, attn[name].shape).astype(np.float32))
    batch = dict(_batch(vl.vocab_size, 4)[1], positions=_grid_positions(BATCH, SEQ, 2, 4),
                 prefix_embeds=torch.from_numpy(g.normal(
                     0, 1, (BATCH, vl.visual_prefix, vl.d_model)).astype(np.float32)))
    cases["qwen2vl"] = (vl, pt, "tp", interop.lm_state_to_numpy(st), batch, {})
    mamba = configs.smoke_config("mamba2-370m")
    for pol in ("tp", "tp_sp"):
        cases[f"mamba_{pol}"] = (mamba, pt, pol, 19, _batch(mamba.vocab_size, 5)[1], {})
    # 3 SSD heads of 16 (d_inner 48): the specs split d_inner, not the heads.
    odd = dataclasses.replace(mamba, n_layers=2, d_model=24, ssm=SSMConfig(
        d_model=24, d_state=16, headdim=16, expand=2, chunk=32))
    cases["mamba_midhead"] = (odd, pt, "tp", 31, _batch(odd.vocab_size, 10)[1], {})
    jamba = configs.smoke_config("jamba-v0.1-52b")
    cases["jamba"] = (jamba, pt, "tp", 21, _batch(jamba.vocab_size, 6)[1], {})
    smol = configs.smoke_config("smollm-135m")
    cases["smollm"] = (smol, pt, "tp", 25, _batch(smol.vocab_size, 7)[1], {})
    _, cfg = _qwen3()
    cases["padded"] = (cfg, dataclasses.replace(pt, pad_to_tiles=True), "tp", 27,
                       _batch(cfg.vocab_size, 8)[1], {})
    cases["guard"] = (cfg, dataclasses.replace(pt, guard=True), "tp", 29,
                      _batch(cfg.vocab_size, 9)[1], {"guard_at": (1,)})
    # The other methods: rows split (qwen3's 512-row vocabulary) or, for
    # lsq and pact, the width split (509 rows).
    _, odd = _qwen3(vocab_size=509)
    for i, method in enumerate(OTHER_METHODS):
        c = dataclasses.replace(cfg, embedding_method=method)
        tc = dataclasses.replace(pt, prune=PRUNE) if method == "prune" else pt
        cases[method] = (c, tc, "tp", _clipping(c, tc, 41 + i) if method == "pact" else 41 + i,
                         _batch(cfg.vocab_size, 11 + i)[1], {})
    for i, method in enumerate(("lsq", "pact")):
        c = dataclasses.replace(odd, embedding_method=method)
        cases[f"{method}_width"] = (c, pt, "tp",
                                    _clipping(c, pt, 51 + i) if method == "pact" else 51 + i,
                                    _batch(odd.vocab_size, 21 + i)[1], {})
    for i, arch in enumerate(("deepseek-moe-16b", "jamba-v0.1-52b")):
        c = configs.smoke_config(arch)
        cases[f"{arch.split('-')[0]}_ep"] = (c, pt, "tp_ep", 61 + i,
                                             _batch(c.vocab_size, 31 + i)[1], {"ep": True})
    # dp over an MoE: the load-balance statistics' mean over all four ranks.
    moe = configs.smoke_config("deepseek-moe-16b")
    cases["deepseek_dp"] = (moe, pt, "dp", 61, _batch(moe.vocab_size, 31)[1], {})
    # The reference's default for deepseek-67b, and a sliding window (32)
    # over a sequence split in two, both with projections cut over data.
    for i, (name, arch, pol) in enumerate((("deepseek67b_fsdp_tp", "deepseek-67b", "fsdp_tp"),
                                           ("danube_fsdp_tp_sp", "h2o-danube-1.8b",
                                            "fsdp_tp_sp"))):
        c = configs.smoke_config(arch)
        cases[name] = (c, pt, pol, 71 + i, _batch(c.vocab_size, 41 + i)[1], {})
    return cases


#: Cases that share a case's state, batch and noise under another policy,
#: and so its one-process twin (deepseek-moe's: the EP twin, which reads the
#: whole sequence, as the dispatch does under sp).
SAME_TWIN = {"qwen3_tp_sp": "qwen3_tp", "qwen3_fsdp_tp": "qwen3_tp",
             "qwen3_fsdp_tp_sp": "qwen3_tp", "qwen3_dp": "qwen3_tp",
             "mamba_tp_sp": "mamba_tp", "deepseek_fsdp_tp_ep": "deepseek_ep",
             "deepseek_tp_sp_ep": "deepseek_ep"}


def _clipping(cfg, tcfg, seed: int) -> dict:
    """pact's init of ``seed`` with alpha cut to a twentieth, about one
    standard deviation of a row's weights, so that weights clip and alpha
    has a gradient (at its init, 2 mean|w| sqrt(127), none clips)."""
    st = interop.lm_state_to_numpy(lm_trainer.init_state(cfg, tcfg, seed=seed, device="cpu"))
    weights, alpha = st["table"]
    return dict(st, table={"weights": weights, "scale": alpha * np.float32(0.05)}, table_opt=None)


def _ep_inputs(seq: int) -> dict:
    """EP_MOE's weights (the reference's init scales), a [4, seq, 16] input
    and the output's cotangent, seeded with numpy."""
    g = np.random.RandomState(40 + seq)
    d, f, e, fs = EP_MOE.d_model, EP_MOE.d_ff, EP_MOE.n_experts, EP_MOE.shared_hidden

    def normal(shape, scale):
        return (g.normal(0.0, 1.0, shape) * scale).astype(np.float32)

    params = {"router": normal((d, e), d**-0.5), "w_gate": normal((e, d, f), d**-0.5),
              "w_up": normal((e, d, f), d**-0.5), "w_down": normal((e, f, d), f**-0.5),
              "shared": {"w_gate": normal((d, fs), d**-0.5), "w_up": normal((d, fs), d**-0.5),
                         "w_down": normal((fs, d), fs**-0.5)}}
    return {"cfg": EP_MOE, "params": params, "x": normal((BATCH, seq, d), 1.0),
            "ct": normal((BATCH, seq, d), 1.0)}


@functools.lru_cache(maxsize=None)
def _reference_ep_grad(m: int):
    """The reference's ``moe_forward_ep`` on ``m`` virtual ranks under
    ``jax.vmap(axis_name="model")``, jitted: ``(w [m, E/m, ...] stacked,
    router, shared, x, ct, a) -> (gradients, (y, aux))`` of ``sum(y * ct) +
    a * aux``."""
    cfg = jmoe.MoEConfig(**dataclasses.asdict(EP_MOE))

    def loss(w, router, shared, x, ct, a):
        def inner(w_loc):
            return jmoe.moe_forward_ep({"router": router, "shared": shared, **w_loc}, x, cfg,
                                       axis="model")

        y, aux = jax.vmap(inner, axis_name="model")(w)
        return jnp.sum(y[0] * ct) + a * aux[0], (y[0], aux[0])

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True))


def _reference_ep(case: dict, data: int, m: int, a: float) -> list:
    """Per data row's block of the batch: the reference's y, aux and the
    gradients of ``sum(y * ct) + a * aux`` (the expert stacks unstacked to
    [E, ...]), as numpy."""
    p, e = case["params"], EP_MOE.n_experts
    w = {n: jnp.asarray(p[n].reshape(m, e // m, *p[n].shape[1:]))
         for n in ("w_gate", "w_up", "w_down")}
    shared = jax.tree.map(jnp.asarray, p["shared"])
    bd = case["x"].shape[0] // data
    out = []
    for i in range(data):
        rows = slice(i * bd, (i + 1) * bd)
        (gw, gr, gs, gx), (y, aux) = _reference_ep_grad(m)(
            w, jnp.asarray(p["router"]), shared, jnp.asarray(case["x"][rows]),
            jnp.asarray(case["ct"][rows]), a)
        grads = {"x": gx, "router": gr, "shared": gs,
                 **{n: gw[n].reshape(e, *gw[n].shape[2:]) for n in gw}}
        out.append({"y": np.asarray(y), "aux": float(aux),
                    "grads": jax.tree.map(np.asarray, grads)})
    return out


def _spawn(d):
    return [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_sharded_ranks.py"),
                              str(d), str(r), "4", "2", "2", "cpu"], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(4)]


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The ranks' inputs, the ranks started, then (while they run) the
    reference's jitted step, the one-process twins, rung 2's whole updates
    and the CLI at 1 x 1 in this process; then the ranks' outputs."""
    d = tmp_path_factory.mktemp("sharded")
    # qwen3 smoke (head_pad_multiple=2), ALPT-8, from the reference's state.
    jcfg, cfg = _qwen3()
    jt, pt = jlm.LMTrainerConfig(lr=LR), lm_trainer.LMTrainerConfig(lr=LR)
    js = jlm.init_state(jax.random.PRNGKey(0), jcfg, jt)
    jb, pb = _batch(cfg.vocab_size)
    kn = jax.random.split(js.rng)[1]
    noise = torch.from_numpy(np.array(jq.sr_noise(jax.random.fold_in(kn, 1),
                                                  tuple(js.table.codes.shape))))
    state_np = _ref_state_np(js)
    ps = interop.lm_state_from_numpy(cfg, pt, **state_np, device="cpu")
    lm_trainer.save(CheckpointManager(d / "ck_one"), cfg, ps, pt, force=True)
    steps = {f"qwen3_{pol}": {"cfg": cfg, "tcfg": pt, "policy": pol, "state": state_np,
                              "batch": pb, "noise": noise}
             for pol in ("tp", "tp_sp", "fsdp_tp", "fsdp_tp_sp", "dp")}
    # mixtral smoke (4 experts, 2 a rank) and a 509-row vocabulary (the table
    # split over d), each from this rank's shard of the port's init.
    mixtral = configs.smoke_config("mixtral-8x7b")
    _, odd = _qwen3(vocab_size=509)
    for name, c, seed in (("mixtral", mixtral, 3), ("width", odd, 5)):
        steps[name] = {"cfg": c, "tcfg": pt, "policy": "tp", "seed": seed,
                       "batch": _batch(c.vocab_size, 1)[1]}
    # qr_alpt (a composed table: one SR draw per sub-table, a pair of Delta
    # gradients) on the same four ranks as a 4 x 1 mesh: the batch split
    # over data, the table replicated.
    qr = dataclasses.replace(cfg, embedding_method="qr_alpt")
    steps["qrdata"] = {"cfg": qr, "tcfg": pt, "policy": "tp", "seed": 9, "data_only": True,
                       "batch": _batch(qr.vocab_size, 2)[1]}
    mesh_cases = _mesh_cases(pt)
    for name, (c, tc, pol, start, b, extra) in mesh_cases.items():
        steps[name] = {"cfg": c, "tcfg": tc, "policy": pol, "batch": b, **extra,
                       **({"state": start} if isinstance(start, dict) else {"seed": start})}
    for pol in ("fsdp_tp_ep", "tp_sp_ep"):
        steps[f"deepseek_{pol}"] = dict(steps["deepseek_ep"], policy=pol)
    # Rung 2: LPT-8 and ALPT-8 updates from one gradient, noise and Delta gradient.
    rows = {}
    g = torch.Generator().manual_seed(7)
    for method in ("lpt", "alpt"):
        c = dataclasses.replace(cfg, embedding_method=method)
        grad = torch.randn((c.vocab_size, c.d_model), generator=g) * 1e-2
        grad[::3] = 0.0  # untouched rows
        rows[method] = {"cfg": c, "tcfg": pt, "grad": grad, "lr": LR, "batch_rows": BATCH * SEQ,
                        "state": interop.lm_state_to_numpy(
                            lm_trainer.init_state(c, pt, seed=11, device="cpu")),
                        "noise": quant.sr_noise(g, (c.vocab_size, c.d_model)),
                        "g_step": torch.randn((c.vocab_size,), generator=g) * 1e-3}
    ep = {name: _ep_inputs(seq) for name, seq in EP_SEQ.items()}
    mesh_flags = ["--mesh-data", "2", "--mesh-model", "2"]
    torch.save({"steps": steps, "save_cases": (*SAVED, "qr_alpt", "lsq"),
                "restore": {"cfg": cfg, "tcfg": pt, "state": state_np,
                            "policies": RESTORED},
                "rows": rows, "ep": list(ep.values()), "cli": ["lm", *CLI, *mesh_flags],
                "cli_fsdp": ["lm", *CLI, *mesh_flags, "--policy", "fsdp_tp"],
                "cli_ep": ["lm", *CLI_EP, *mesh_flags], "chunked_mean": (5, 3, 11)},
               d / "in.pt")
    procs = _spawn(d)
    try:
        js1, jm = jax.jit(jlm.make_train_step(jcfg, jt))(js, jb)
        out = {"ref": {"loss": float(jm["loss"]), "codes": np.asarray(js1.table.codes.data)}}
        one = {"qwen3_tp": _one_process(cfg, pt, ps, pb, noise)}
        for name in ("mixtral", "width", "qrdata", *mesh_cases):
            if name in SAME_TWIN:
                continue
            case = steps[name]
            c, tc, b = case["cfg"], case["tcfg"], case["batch"]
            st = (interop.lm_state_from_numpy(c, tc, **case["state"], device="cpu")
                  if "state" in case else
                  lm_trainer.init_state(c, tc, seed=case["seed"], device="cpu"))
            one[name] = _one_process(c, tc, st, b, guard_at=case.get("guard_at"),
                                     ep=case.get("ep", False))
        one.update({name: one[twin] for name, twin in SAME_TWIN.items()})
        for method, r in rows.items():
            spec = lm_trainer.embedding_spec_of(r["cfg"], pt)
            st = interop.lm_state_from_numpy(r["cfg"], pt, **r["state"], device="cpu")
            r["want"], _, _ = methods.get(method).dense_update(
                st.table, None, r["grad"], spec=spec, lr=LR, weight_decay=pt.emb_weight_decay,
                noise=r["noise"], delta_grad=lambda w, s_, gs, g_step=r["g_step"]: g_step,
                batch_rows=BATCH * SEQ)
        for key, argv, twin in (("cli_one", CLI, False), ("cli_ep_one", CLI_EP[:-2], True)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), ranks_mod.ep_twin(2, 2) if twin else \
                    contextlib.nullcontext():
                assert train_cli.main(["lm", *argv]) == 0
            out[key] = json.loads(buf.getvalue().strip().splitlines()[-1])["losses"]
        out["ep_ref"] = {name: _reference_ep(c, 2, 2, 1.0) for name, c in ep.items()}
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * 4, [e[-3000:] for e in errs]
    out["ranks"] = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(4)]
    out.update(one=one, dir=d, cfg=cfg, tcfg=pt, rows=rows, steps=steps, ep=ep)
    return out


def _close_params(got, want, grads, lr=LR):
    for x, y, g in zip(tree_leaves(got), tree_leaves(want), grads):
        ok = torch.abs(x - y) <= 1e-6 + 1e-4 * torch.abs(y)
        conditioned = torch.abs(g) >= 1e-6
        assert bool(torch.all(ok | ~conditioned)), (tuple(y.shape), (x - y).abs().max())
        assert float((x - y).abs().max()) <= 2 * lr


@pytest.mark.parametrize("policy", ["tp", "tp_sp", "fsdp_tp", "dp"])
def test_sharded_step_meets_the_reference_contract(launch, policy):
    """2 x 2 grid, one step from the reference's state with its SR noise,
    against the reference's single-device jitted step: the reference's own
    bounds (tests/test_distribution.py)."""
    got = launch["ranks"][0]["steps"][f"qwen3_{policy}"]
    assert abs(got["metrics"]["loss"] - launch["ref"]["loss"]) < 2e-3
    frac = float((got["table"]["codes"].numpy() != launch["ref"]["codes"]).mean())
    assert frac < 0.02


@pytest.mark.parametrize("case", ["qwen3_tp", "qwen3_tp_sp", "mixtral", "width", "qrdata",
                                  "hubert_tp_sp", "qwen2vl", "mamba_tp", "mamba_tp_sp",
                                  "mamba_midhead", "jamba", "smollm", "padded", "guard",
                                  *OTHER_METHODS, "lsq_width", "pact_width", "deepseek_ep",
                                  "jamba_ep", "qwen3_fsdp_tp", "qwen3_fsdp_tp_sp", "qwen3_dp",
                                  "deepseek_fsdp_tp_ep", "deepseek_tp_sp_ep", "deepseek_dp",
                                  "deepseek67b_fsdp_tp", "danube_fsdp_tp_sp"])
def test_sharded_step_tracks_the_one_process_step(launch, case):
    """The same state, batch and noise through the one-process step: loss,
    grad norm, params and the table (module docstring's bounds); every
    replicated leaf the same on all ranks (a replicated table's codes,
    Delta and slots, a float leaf's Adam moments too).  ``qrdata``: qr_alpt
    on a 4 x 1 mesh, its two sub-tables' codes in order.  ``guard``: two
    guarded steps, the second poisoned; every rank skips it and keeps its
    shards of the state the first step left (the one-process twin's, whose
    first step's loss and norm are compared).  A float-leaf method's table
    (hash, prune, lsq, pact) meets the params bound against its one-process
    gradient (lsq's step size and pact's alpha, replicated over a table
    split over d, take the ranks' summed gradient); prune's mask, refreshed
    after the step over the whole table, is the one-process mask bitwise.
    ``*_ep``: ``tp_ep``, ``fsdp_tp_ep`` and ``tp_sp_ep`` (the dispatch
    reading the sequence gathered from its blocks) against the one-process
    EP twin.  ``*fsdp*``: the projections' blocks over the data axis;
    ``*_dp``: one sequence a rank, the params whole and bitwise equal on
    all four ranks (the replicas check); deepseek-moe's load-balance
    statistics meaned over all four."""
    got = launch["ranks"][0]["steps"][case]
    new, m, grads, g_emb = launch["one"][case]
    if case == "guard":
        for r in launch["ranks"]:
            assert r["steps"][case]["guard"] == {"skipped": [0, 1], "kept": True}
    assert abs(got["metrics"]["loss"] - float(m["loss"])) < 1e-4
    np.testing.assert_allclose(got["metrics"]["grad_norm"], float(m["grad_norm"]), rtol=1e-5)
    _close_params(got["params"], new.params, grads)
    cfg = launch["steps"][case]["cfg"]
    spec = lm_trainer.embedding_spec_of(cfg, launch["steps"][case]["tcfg"])
    emb = methods.get(spec.method).trainable_params(new.table, spec)
    if emb is not None:
        _close_params(got["emb"], emb, tree_leaves(g_emb))
    if got["mask"] is not None:
        assert torch.equal(got["mask"], new.table.mask)
        assert 0.2 < float(1.0 - got["mask"].float().mean()) < 0.3  # PRUNE's 0.25 after step 1
    subs = ranks_mod._subtables(new.table)
    if subs:
        codes = got["table"]["codes"]
        want = subs[0].codes.data if hasattr(new.table, "codes") else torch.cat(
            [t.codes.data.reshape(-1) for t in subs])
        assert codes.shape == want.shape
        assert float((codes != want).float().mean()) <= 0.005
    assert all(r["steps"][case]["same_replicas"] for r in launch["ranks"])


def test_exact_mean_chunk_by_chunk_is_the_whole_leafs(launch):
    """``collectives.exact_pmean_local`` over the four ranks, its leaf in
    chunks of 7 elements (``MEAN_CHUNK``; a 5 x 3 x 11 leaf, a ragged last
    chunk), bitwise the mean of the whole leaf, and that mean the
    rank-ordered one of the ranks' draws."""
    ranks = launch["ranks"]
    assert all(r["chunked_mean"][0] for r in ranks)
    draws = [torch.randn((5, 3, 11), generator=torch.Generator().manual_seed(100 + r))
             for r in range(4)]
    want = collectives.exact_pmean_stacked(draws)
    assert all(torch.equal(r["chunked_mean"][1], want) for r in ranks)


def test_guard_verdict_is_the_whole_worlds(launch):
    """A step whose params come out non-finite on rank 0's shard alone is
    skipped on all four ranks (one all-reduce of the verdict), and a clean
    step after it on none."""
    assert [r["guard_world"] for r in launch["ranks"]] == [[1, 0]] * 4


def test_shard_update_from_the_same_gradient_rows_is_bitwise(launch):
    """Rung 2: LPT-8's and ALPT-8's ``dense_update`` on each rank's rows
    (the one-process gradient's, noise's and Delta gradient's rows) equal
    the one-process update's rows bitwise: codes, Delta and both slots."""
    for rank, r in enumerate(launch["ranks"]):
        mesh = HostMesh(shape={"data": 2, "model": 2}, coords={"data": rank // 2,
                                                                "model": rank % 2},
                        groups={"data": None, "model": None})
        for method, c in launch["rows"].items():
            want = sharding.shard_tree(c["want"], methods.get(method).table_pspec("model", None),
                                       mesh)
            got = r["rows"][method]
            assert torch.equal(got.codes.data, want.codes.data)
            assert all(torch.equal(getattr(got, k), getattr(want, k)) for k in ("step", "mu", "nu"))


@pytest.mark.parametrize("case", SAVED)
def test_checkpoint_from_shards_restores_in_one_process_bitwise(launch, case):
    """Saved at 2 x 2 (gathered, rank 0 writes whole leaves; fsdp's blocks
    over the data axis, dp's Adam moments over the model axis), restored at
    1 x 1: every leaf, the Adam moments too, equals the gathered shards
    bitwise."""
    cfg, pt = launch["cfg"], launch["tcfg"]
    back = lm_trainer.restore(CheckpointManager(launch["dir"] / f"ck_mesh_{case}"), cfg, pt,
                              device="cpu")
    got = launch["ranks"][0]["steps"][case]
    assert back.step == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.params),
                                                 tree_leaves(got["params"])))
    assert all(torch.equal(a, b) for a, b in zip([*back.opt.mu, *back.opt.nu],
                                                 [*got["opt"][0], *got["opt"][1]], strict=True))
    for key in ("codes", "step", "mu", "nu"):
        mine = back.table.codes.data if key == "codes" else getattr(back.table, key)
        assert torch.equal(mine, got["table"][key])


@pytest.mark.parametrize("case", ["qr_alpt", "lsq"])
def test_method_checkpoint_from_shards_restores_in_one_process_bitwise(launch, case):
    """qr_alpt's replicated sub-tables and lsq's row-split weights and step
    sizes saved at 2 x 2 (rank 0 writes whole leaves), restored at 1 x 1:
    params, the codes and Delta of both sub-tables, the float leaves, all
    equal to the gathered shards bitwise."""
    c = launch["steps"][case]
    back = lm_trainer.restore(CheckpointManager(launch["dir"] / f"ck_mesh_{case}"), c["cfg"],
                              c["tcfg"], device="cpu")
    got = launch["ranks"][0]["steps"][case]
    assert back.step == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back.params),
                                                 tree_leaves(got["params"])))
    spec = lm_trainer.embedding_spec_of(c["cfg"], c["tcfg"])
    table = ranks_mod._table_np(back.table)
    assert table.keys() == got["table"].keys()
    assert all(torch.equal(table[k], got["table"][k]) for k in table)
    emb = methods.get(spec.method).trainable_params(back.table, spec)
    assert (emb is None) == (got["emb"] is None)
    if emb is not None:
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(emb), tree_leaves(got["emb"])))


@pytest.mark.parametrize("policy", RESTORED)
def test_one_process_checkpoint_restores_on_the_mesh_bitwise(launch, policy):
    """Saved at 1 x 1, restored at 2 x 2 under ``policy``: each rank's shard
    of every leaf (Adam moments, table, generator) is the slice of the
    saved state (fsdp: blocks over both axes; dp: whole params, moments
    over the model axis); and ``gather_tree`` of ``shard_tree`` is the
    identity, bitwise."""
    for r in launch["ranks"]:
        assert r["restore"][policy] == {"bitwise": True, "identity": True}


@pytest.mark.parametrize("policy", ["tp", "fsdp_tp"])
def test_cli_on_a_2x2_mesh_tracks_1x1(launch, policy):
    """``train lm --mesh-data 2 --mesh-model 2 [--policy fsdp_tp]`` on four
    gloo ranks (the launcher's group; the policy's ``data_size`` the mesh's
    data axis): its losses against the CLI at 1 x 1."""
    key = "cli" if policy == "tp" else "cli_fsdp"
    cli = launch["ranks"][0][key]
    assert cli["code"] == 0
    report = json.loads(cli["stdout"].strip().splitlines()[-1])
    assert report["mesh_data"] == 2 and report["mesh_model"] == 2 and report["policy"] == policy
    assert all(r[key]["stdout"] == "" for r in launch["ranks"][1:])
    np.testing.assert_allclose(report["losses"], launch["cli_one"], rtol=0, atol=1e-4)


def test_cli_tp_ep_on_a_2x2_mesh_tracks_its_ep_twin(launch):
    """``train lm --arch deepseek-moe-16b --policy tp_ep`` on the 2 x 2 grid:
    its losses against the CLI at 1 x 1 whose MoE layers take the one-process
    EP twin of that grid."""
    cli = launch["ranks"][0]["cli_ep"]
    assert cli["code"] == 0
    report = json.loads(cli["stdout"].strip().splitlines()[-1])
    assert report["policy"] == "tp_ep" and report["mesh_model"] == 2
    np.testing.assert_allclose(report["losses"], launch["cli_ep_one"], rtol=0, atol=1e-4)


def _close_tree(got, want, rtol, atol):
    for x, y in zip(tree_leaves(got), tree_leaves(want), strict=True):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(EP_SEQ))
def test_moe_forward_ep_on_the_ranks_matches_the_reference(launch, name):
    """The port's ``moe_forward_ep`` on each rank of the 2 x 2 grid (its
    data row's block of the batch, its 4 of 8 experts) against the
    reference's on 2 virtual ranks under ``jax.vmap(axis_name="model")``:
    output and input gradient within 2e-5 (the reference test's bound),
    aux within rtol 1e-5, the router's, experts' and shared expert's
    gradients within rtol 1e-4 / atol 1e-6.  ``ragged``: S = 15 on 2 ranks,
    the last token without output, as in the reference."""
    i = list(EP_SEQ).index(name)
    el = EP_MOE.n_experts // 2
    for rank, r in enumerate(launch["ranks"]):
        got, want = r["ep"][i], launch["ep_ref"][name][rank // 2]
        np.testing.assert_allclose(got["y"].numpy(), want["y"], rtol=0, atol=2e-5)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5)
        g, w = got["grads"], dict(want["grads"])
        np.testing.assert_allclose(g["x"].numpy(), w.pop("x"), rtol=0, atol=2e-5)
        for n in ("w_gate", "w_up", "w_down"):
            w[n] = w[n][(rank % 2) * el:(rank % 2 + 1) * el]
        _close_tree({k: v for k, v in g.items() if k != "x"}, w, 1e-4, 1e-6)
    if name == "ragged":
        assert not launch["ep_ref"][name][0]["y"][:, -1].any()


@pytest.mark.parametrize("name", list(EP_SEQ))
def test_moe_ep_twin_matches_the_reference(launch, name):
    """The one-process EP twin (``moe_ep_twin``, the steps' twin of
    ``tp_ep``) on a 2 x 2 grid's four cells against the reference's
    ``moe_forward_ep`` per data row under ``jax.vmap``: y, the aux (the
    cells' mean), and the gradients of ``sum(y * ct) + aux``, within the
    bounds of the ranks' test."""
    case = launch["ep"][name]
    params = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(True), case["params"])
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    y, aux = ranks_mod.moe_ep_twin(params, x, EP_MOE, 2, 2)
    (torch.sum(y * torch.from_numpy(case["ct"])) + aux).backward()
    ref = _reference_ep(case, 2, 2, 0.5)  # each data row's aux weighs 1/2 in the cells' mean
    np.testing.assert_allclose(y.detach().numpy(), np.concatenate([o["y"] for o in ref]),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(aux.detach()), np.mean([o["aux"] for o in ref]), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.concatenate([o["grads"]["x"] for o in ref]),
                               rtol=0, atol=2e-5)
    want = jax.tree.map(lambda *a: sum(a), *[{k: v for k, v in o["grads"].items() if k != "x"}
                                             for o in ref])
    _close_tree(jax.tree.map(lambda t: t.grad, params), want, 1e-4, 1e-6)


@pytest.mark.parametrize("argv,world,message", [
    (["--arch", "qwen3-1.7b", "--mesh-data", "2", "--mesh-model", "2"], 3, "WORLD_SIZE is 3"),
    (["--arch", "deepseek-moe-16b", "--mesh-model", "4", "--policy", "fsdp_tp_ep"], 2,
     "WORLD_SIZE is 2"),
    (["--mesh-data", "2", "--mesh-model", "2", "--policy", "dp"], None, "takes 4 processes"),
    (["--policy", "fsdp_tp", "--dp-compress-bits", "32"], 1, "the sharded path's"),
    (["--mesh-data", "2", "--policy", "dp", "--dp-compress-bits", "8"], 2,
     "the sharded path's"),
    (["--mesh-data", "2", "--mesh-model", "2", "--policy", "fsdp_tp_sp",
      "--dp-compress-bits", "8"], 4, "pure data parallelism"),
    (["--mesh-model", "0", "--policy", "fsdp_tp"], 1, ">= 1"),
    (["--mesh-data", "2", "--mesh-model", "0", "--policy", "dp"], 1, ">= 1"),
    (["--mesh-data", "4", "--dp-compress-bits", "32", "--batch", "6"], 4, "multiple"),
])
def test_cli_refuses_what_the_sharded_step_does_not_run(argv, world, message, capsys,
                                                        monkeypatch):
    """Exit 2 for a mesh the flags cannot make (a world size that is not
    data x model, a launch without the processes, an axis of 0), for
    ``--dp-compress-bits`` beside a sharding policy or a model axis, and for
    a DP batch its ranks do not split; every policy itself runs (fsdp, dp,
    ep at any mesh, each with the mesh's ``data_size``)."""
    if world is None:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["lm", "--smoke", "--device", "cpu", *argv])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("policy", ["fsdp_tp", "dp", "tp_sp_ep"])
def test_check_shardable_takes_every_policy_at_the_meshs_sizes(policy):
    """``check_shardable`` takes each policy built with the mesh's axes (and
    with ``data_size=None``, which places nothing over the data axis), and
    refuses a ``data_size`` or ``model_size`` other than the mesh's."""
    mesh = HostMesh(shape={"data": 2, "model": 2}, coords={"data": 0, "model": 0},
                    groups={"data": None, "model": None})
    for data_size in (2, None):
        lm_trainer.check_shardable(mesh, sharding.policy_from_name(policy, model_size=2,
                                                                   data_size=data_size))
    with pytest.raises(ValueError, match="data_size 16 != the mesh's data axis 2"):
        lm_trainer.check_shardable(mesh, sharding.default_policy("deepseek-67b", model_size=2,
                                                                 override=policy))
    with pytest.raises(ValueError, match="model_size 4"):
        lm_trainer.check_shardable(mesh, sharding.policy_from_name(policy, model_size=4,
                                                                   data_size=2))
