"""Training CLI of the port: CTR training of the paper's DCN (or DeepFM) with
any embedding method, and LM training (dense, SSM, MoE and hybrid stacks,
the encoder, the VLM) with a quantized vocab table.

    python -m repro_torch.launch.train ctr --config avazu --scale 1.0 \\
        --method alpt --bits 8 --batch 1024 --steps 20 [--model deepfm]
    python -m repro_torch.launch.train ctr --config criteo --method qr_alpt
    python -m repro_torch.launch.train lm --arch smollm-135m --steps 100
    python -m repro_torch.launch.train lm --arch mamba2-370m --embedding-method prune

``--device cpu`` runs the plain PyTorch versions on the CPU; the default is
``cuda`` and fails without a GPU.  The state is initialized from
``--seed`` (``lm``: from seed 0, with the reference's token stream, seed
17), and the report ends with one JSON line: the losses, host milliseconds
per step, kernel launches, fallbacks and the table's training memory.  A
``mixed``-input arch (qwen2-vl-7b) also takes a seeded normal visual prefix
and three equal M-RoPE position streams per batch, an ``embeds`` arch
(hubert-xlarge) seeded normal frames in place of the tokens
(:func:`lm_batch`).  The single-program ``lm`` step is donated
(``make_train_step(donate=True)``: params and Adam moments stepped in
place), as the reference's CLI donates its state, unless ``--guard`` needs
the state before the step to roll back to.
``--method`` takes any name in ``repro_torch.methods.available()``; mixed
takes the dataset's field cardinalities, DeepFM a table one column wider
than its embedding (the first-order weight), Criteo's DCN its dropout 0.2.

Checkpoints (both scenarios, as in the reference's CLI): ``--ckpt-dir``
resumes from the newest committed checkpoint that passes verification
(printing ``resumed from step N``; refused steps are listed as
``corrupt_checkpoints`` in the JSON line), saves every ``--ckpt-every``
steps (keeping 3) and at the end; SIGTERM / SIGINT finishes the step in
flight, saves and exits 75 so a scheduler requeues the job.  The data are
indexed by step, so a resumed run replays exactly the batches it missed.

Data parallel (``lm``, port of the reference's ``--dp-compress-bits``
mode): ``--dp-compress-bits B`` replicates the state over ``--mesh-data N``
ranks, each training on its slice of the global ``--batch``, and syncs the
gradients at B bits (32: the exact fp32 mean; 2..8: SR-compressed codes;
``repro_torch.training.data_parallel``).  N processes come from
``python -m torch.distributed.run --standalone --nproc-per-node N -m
repro_torch.launch.train lm ...``: each joins the group from the
environment (NCCL on ``cuda``, one card per local rank; gloo on ``cpu``)
and ``--mesh-data`` must equal ``WORLD_SIZE``.  ``--mesh-data 1`` without
``torchrun`` makes a one-rank group itself.  Rank 0 logs and saves; every
rank restores the same checkpoint (the state is replicated, so a checkpoint
of one ``--mesh-data`` resumes at another); on SIGTERM the ranks agree on
the step to stop at before rank 0 saves and all exit 75.
``--dp-compress-bits`` refuses a mixed-input arch (as the reference does).

Sharded (``lm``, the reference's GSPMD path): without
``--dp-compress-bits``, ``--mesh-data D --mesh-model M`` trains on a
``D x M`` grid of ranks (``repro_torch.launch.mesh``; ``D * M`` processes
under ``torch.distributed.run``, or ranks whose launcher made the default
group) under ``--policy`` (``tp``, the reference CLI's; ``tp_sp``;
``tp_ep``, the MoE layers' explicit expert-parallel dispatch; ``fsdp_tp``,
``fsdp_tp_sp`` and ``fsdp_tp_ep``, the projections also cut over the data
axis; ``dp``, the model axis more data parallelism), built with the mesh's
``data_size`` (``--mesh-data``): the state follows ``state_pspecs`` (each
rank its shard of the one-process init), the batch ``batch_pspecs`` (a
batch the data axes do not divide is replicated and still trains), and
the step is donated.  Every rank saves
through the gather and rank 0 writes whole leaves; a resume cuts each
rank's shard for this mesh, whatever mesh saved the checkpoint.  Every
arch and every ``--embedding-method`` runs there (mamba mixers and heads
that split mid-head among them; qr_*, hash and mixed tables replicated on
every rank; prune's refresh over the whole table), and so do
``--pad-to-tiles`` and ``--guard`` (one verdict for every rank).  Exit 2: a
world size that is not ``D * M``.

Storage tiers (``ctr``): ``--zipf`` trains on the reference's Zipf(1.1)
skewed-traffic fixture (:data:`CTR_ZIPF_DATA`: 8 fields, 4,092 rows) in
place of the dataset, with the config's model; ``--cache-rows`` composes a
device hot-row cache of that many rows over every cacheable sub-table
(bitwise the uncached run; checkpoints hold the exported state) and
prints each slot's hits, evictions and write-backs at the end.

Observability (:mod:`repro_torch.obs`, as the reference's CLI): the JSON
line carries ``step_time_us`` (P² quantiles of each step's host µs) and
``kernel_fallbacks`` (``lm``: unless ``--no-kernels``), and ``lm`` also
``straggler_steps``: a step slower than 2.5 x the EWMA of the steps before
it, after 5 warm-up steps, is flagged (``train.straggler_warnings``, the
instant ``train.straggler``).  ``--trace-out PATH`` arms the span tracer
and writes a Chrome trace (``chrome://tracing``, https://ui.perfetto.dev)
to PATH at exit, also after an error; with several ranks only rank 0
writes it.  Tracing fences the card at span edges and changes no result.

Faults (:mod:`repro_torch.faults`, both scenarios, as the reference's CLI):
``--fault-plan JSON`` installs a ``FaultPlan`` for the run (its sites are
printed; it is uninstalled when the run ends).  ``train.preempt`` requests
the graceful shutdown after its step: the checkpoint, then exit 75.
``--guard`` turns on the non-finite skip-step guard, and a plan naming
``trainer.nonfinite`` or ``alpt.delta`` turns it on by itself; the JSON
line then carries ``guard`` (skipped steps, fired seams, clamped Delta
rows).  ``--dp-compress-bits`` refuses ``--guard``, as the reference's CLI
does, since each rank would judge its own loss before the sync; the
sharded path takes it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch import faults, methods
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import check_embedding_manifest, config_hash
from repro_torch.configs import dcn_ctr
from repro_torch.data.ctr_synth import CTRDatasetConfig, CTRSynthetic
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.dist import context as dist_ctx
from repro_torch.dist import sharding
from repro_torch.kernels import ops
from repro_torch.launch.mesh import HostMesh, make_host_mesh
from repro_torch.models import ctr as ctr_models
from repro_torch.obs import counters as obs_counters
from repro_torch.obs.stats import StreamingQuantiles
from repro_torch.obs.trace import tracer
from repro_torch.training import data_parallel, lm_trainer
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig

SETUPS = {"avazu": dcn_ctr.avazu_setup, "criteo": dcn_ctr.criteo_setup}

# Steps the straggler watchdog flagged, in this process.
_MET_STRAGGLERS = obs_counters.registry().counter("train.straggler_warnings",
                                                  "steps flagged slow by the watchdog")

# The reference's skewed-traffic fixture for the storage tiers
# (repro/launch/serve.py:53): Zipf(1.1) ids over a 4,092-row vocabulary, so
# a hot tier of ~10% of the rows catches most lookups.
CTR_ZIPF_DATA = CTRDatasetConfig(
    name="serve-zipf", n_fields=8,
    cardinalities=(4, 8, 12, 24, 48, 96, 1400, 2500),
    teacher_rank=4, zipf_a=1.1, seed=0,
)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The configuration flags ``train`` and ``serve`` share."""
    p.add_argument("--config", choices=sorted(SETUPS), default="avazu")
    p.add_argument("--model", choices=sorted(ctr_models.MODELS), default="dcn",
                   help="CTR backbone (deepfm: the table is emb_dim + 1 wide)")
    p.add_argument("--method", choices=methods.available(), default="alpt")
    p.add_argument("--scale", type=float, default=0.01,
                   help="vocabulary scale of the synthetic dataset (1.0 = full)")
    p.add_argument("--bits", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--zipf", action="store_true",
                   help="the Zipf(1.1) skewed-traffic fixture in place of the dataset")


def build(args, method: str):
    """``(data, trainer config)`` for the parsed flags (``config``, ``model``,
    ``bits``, ``scale``, ``seed``, ``zipf``): the dataset's setup (with
    ``zipf``, its model over :data:`CTR_ZIPF_DATA`), mixed's field
    cardinalities, and for DeepFM its default MLP and the setup's dropout
    over a table of width d + 1."""
    data_cfg, spec, dcn = SETUPS[args.config](method=method, bits=args.bits, scale=args.scale)
    if getattr(args, "zipf", False):
        data_cfg = CTR_ZIPF_DATA
        spec = dataclasses.replace(spec, n=data_cfg.n_features)
        dcn = dataclasses.replace(dcn, n_fields=data_cfg.n_fields)
    if method == "mixed":
        spec = dataclasses.replace(spec, field_cards=tuple(data_cfg.cardinalities))
    model = getattr(args, "model", "dcn")
    deepfm = None
    if model == "deepfm":
        deepfm = ctr_models.DeepFMConfig(n_fields=dcn.n_fields, emb_dim=dcn.emb_dim,
                                         dropout=dcn.dropout)
        spec = dataclasses.replace(spec, d=dcn.emb_dim + 1)
    cfg = TrainerConfig(spec=spec, dcn=dcn, deepfm=deepfm, model=model, seed=args.seed)
    return CTRSynthetic(data_cfg), cfg


def data_label(args) -> str:
    """The data a CTR run took, for its report line."""
    return "zipf fixture" if args.zipf else f"{args.config} scale={args.scale}"


def ms_per_step(history) -> float:
    """Mean host milliseconds per step of a ``CTRTrainer.fit`` history."""
    return sum(h["ms"] for h in history) / max(len(history), 1)


class StragglerWatchdog:
    """Flags a step slower than ``factor`` x the EWMA of the steps before it,
    once ``warmup`` steps are in (the reference's ``launch/train.py:69``)."""

    def __init__(self, factor: float = 2.5, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.ewma = None
        self.n = 0
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        """``dt``: a step's host seconds; True when it is flagged."""
        self.n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = self.n > self.warmup and dt > self.factor * self.ewma
        if slow:
            self.flagged += 1
            _MET_STRAGGLERS.inc()
            tracer().instant("train.straggler", step=self.n, dt_ms=dt * 1e3)
        # A slow step does not poison the EWMA.
        self.ewma = 0.9 * self.ewma + 0.1 * min(dt, 2 * self.ewma)
        return slow


def step_quantiles(ms) -> dict:
    """``StreamingQuantiles.to_json()`` of step times given in ms, in µs."""
    q = StreamingQuantiles()
    for t in ms:
        q.add(t * 1e3)
    return q.to_json()


def run_traced(trace_out: str | None, tag: str, run) -> int:
    """``run()``, with the span tracer armed when ``trace_out`` names a file:
    the Chrome trace is written there at exit, also after an error, by
    rank 0 only under torch.distributed (``RANK``), and the tracer is then
    disarmed.  The note that it was written goes to stderr, so that the
    report's JSON line stays the last line of stdout."""
    if not trace_out:
        return run()
    rank0 = int(os.environ.get("RANK", "0")) == 0
    tr = tracer()
    tr.clear()
    tr.enable(trace_out)
    if rank0:
        print(f"[{tag}] tracing armed -> {trace_out}")
    try:
        return run()
    finally:
        tr.disable()
        if rank0 and tr.export():
            print(f"[{tag}] trace written: {trace_out} ({len(tr.events)} events)",
                  file=sys.stderr)
        tr.clear()


def load_fault_plan(path: str | None, tag: str) -> faults.FaultPlan | None:
    """The ``--fault-plan`` file's plan (None without one), its sites printed."""
    if not path:
        return None
    plan = faults.FaultPlan.load(path)
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"[{tag}] fault plan installed: sites {sorted(plan.sites())}")
    return plan


def run_with_plan(plan: faults.FaultPlan | None, run) -> int:
    """``run()`` with ``plan`` installed process-wide (when given), and
    uninstalled when the run ends, also after an error."""
    if plan is None:
        return run()
    faults.install(plan)
    try:
        return run()
    finally:
        faults.uninstall()


def guard_report(stats: faults.GuardStats, say=print) -> dict:
    """The guard's totals for the JSON line (published to the registry's
    ``faults.guard.*`` gauges), and their line."""
    stats.publish()
    g = stats.to_json()
    say(f"[train] guard: {g['skipped']} skipped steps ({g['nonfinite_fired']} injected "
        f"non-finite, {g['delta_fired']} injected Delta blowups, {g['delta_clamped']} Delta "
        "rows clamped)")
    return g


class GracefulShutdown:
    """Latches SIGTERM / SIGINT while a run is in flight (a context manager
    that puts the previous handlers back on exit): the loop finishes the
    step, checkpoints and exits 75."""

    def __init__(self):
        self.requested = False
        self._previous = {}

    def __enter__(self) -> "GracefulShutdown":
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)

    def _handler(self, signum, frame) -> None:
        self.requested = True


def _resume(manager, cfg, spec, restore, say=print):
    """``restore()`` of the newest good checkpoint in ``manager``, or None
    when there is none; a method, schema, packing or config mismatch is
    reported through ``say`` before the restore."""
    latest = manager.latest_step() if manager else None
    if latest is None:
        return None
    manifest = manager.read_manifest(latest)
    for problem in check_embedding_manifest(manifest, spec):
        say(f"[train] WARNING: {problem}")
    if manifest.get("config_hash") != config_hash(cfg):
        say("[train] WARNING: config hash mismatch on resume")
    return restore()


def _loop(state, steps: int, one_step, save, saved: bool, agree=bool, say=print):
    """Steps from ``state.step`` up to ``steps``, ``save(state, force)``
    after each (at the manager's cadence), and at the end unless that step
    is saved already -> ``(state, losses, ms per step, preempted)``.  A
    SIGTERM / SIGINT finishes the step in flight and saves; ``agree(flag)``
    turns this process's latched flag into the ranks' common decision."""
    losses, ms = [], []
    with GracefulShutdown() as shutdown:
        while state.step < steps:
            state, loss, t = one_step(state)
            losses.append(loss)
            ms.append(t)
            saved = save(state, False)
            if faults.fires("train.preempt", state.step):
                say(f"[train] injected preemption at step {state.step}")
                shutdown.requested = True
            if agree(shutdown.requested):
                if not saved:
                    save(state, True)
                say(f"[train] preempted at step {state.step}; checkpointed; exiting 75 "
                    "for requeue")
                return state, losses, ms, True
    if not saved:
        save(state, True)
    return state, losses, ms, False


def _manager(args):
    if not args.ckpt_dir:
        return None
    return CheckpointManager(args.ckpt_dir, keep=3, save_every=args.ckpt_every)


def _run_ctr(args) -> int:
    device = device_mod.resolve(args.device)
    data, cfg = build(args, args.method)
    cfg = dataclasses.replace(cfg, lr=args.lr, cache_rows=args.cache_rows, guard=args.guard)
    trainer = CTRTrainer(cfg, device=device)
    manager = _manager(args)
    ops.reset_kernel_calls()
    ops.reset_fallbacks()
    state = _resume(manager, cfg, cfg.spec, lambda: trainer.restore(manager))
    resumed = state is not None
    if resumed:
        print(f"[train] ctr resumed from step {state.step}")
    else:
        state = trainer.init_state()

    def log(h):
        if args.log_every and h["step"] % args.log_every == 0:
            print(f"[train] step {h['step']}: loss {h['loss']:.6f}")

    def one_step(state):
        state, (h,) = trainer.fit(data, steps=1, batch_size=args.batch, state=state, log=log)
        return state, h["loss"], h["ms"]

    def save(state, force):
        return bool(manager) and trainer.save(manager, state, force=force)

    start = state.step
    state, losses, ms_list, preempted = _loop(state, args.steps, one_step, save, resumed)
    if preempted:
        return 75
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = sum(ms_list) / max(len(ms_list), 1)
    method = methods.get(args.method)
    report = {
        "method": args.method, "model": args.model, "config": args.config,
        "scale": args.scale, "bits": args.bits, "device": str(device), "steps": args.steps,
        "start_step": start, "batch": args.batch, "losses": losses, "ms_per_step": ms,
        "kernel_launches": ops.kernel_calls(), "fallbacks": ops.fallbacks(),
        "kernel_fallbacks": ops.fallback_stats()["total_fallbacks"],
        "step_time_us": step_quantiles(ms_list),
        "embedding_bytes": method.memory_bytes(state.emb_state, cfg.spec, training=True),
        "inference_bytes": method.memory_bytes(state.emb_state, cfg.spec, training=False),
        "training_bytes": method.memory_bytes(state.emb_state, cfg.spec, stored=True),
    }
    if manager and manager.corrupt_steps:
        report["corrupt_checkpoints"] = manager.corrupt_steps
    if trainer.caches:
        report["caches"] = trainer.cache_stats()
    if trainer.guard_stats is not None:
        report["guard"] = guard_report(trainer.guard_stats)
    if args.eval_batches:
        report.update(trainer.evaluate(state, data.batches("valid", args.batch,
                                                           args.eval_batches)))
    loss_note = f", loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses else ""
    print(f"[train] ctr/{args.method} {args.model} {data_label(args)} "
          f"bits={args.bits} on {device}: steps {start + 1}-{args.steps} of {args.batch}"
          f"{loss_note}, {ms:.2f} ms/step (host clock)")
    for st in trainer.cache_stats():
        print(f"[train] hot tier '{st['name']}': {st['rows_cached']}/{st['capacity']} rows, hit "
              f"rate {st['hit_rate']:.3f}, {st['evictions']} evictions, {st['writebacks']} "
              f"write-backs, {st['writeback_retries']} write-back retries, "
              f"{st['admission_oom']} admission refusals")
    print(json.dumps(report, sort_keys=True))
    return 0


def _world() -> int | None:
    """The ranks of the default group (a launcher's), else ``WORLD_SIZE``."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = os.environ.get("WORLD_SIZE")
    return None if world is None else int(world)


def check_mesh(parser: argparse.ArgumentParser, args) -> None:
    """The reference's checks of the mesh flags (``repro/launch/train.py:298``),
    and the port's: N ranks are N processes, and the sharded step's
    refusals (``lm_trainer.check_shardable``)."""
    dp_mode = args.dp_compress_bits is not None
    if args.mesh_data < 1 or args.mesh_model < 1:
        parser.error(f"mesh axes must be >= 1, got --mesh-data {args.mesh_data} "
                     f"--mesh-model {args.mesh_model}")
    if dp_mode and args.mesh_model != 1:
        parser.error("--dp-compress-bits is pure data parallelism; use --mesh-model 1")
    if dp_mode and args.policy != "tp":
        parser.error("--policy is the sharded path's; --dp-compress-bits replicates the state")
    world = _world()
    if not dp_mode:
        n = args.mesh_data * args.mesh_model
        if world is not None and world != n:
            parser.error(f"a {args.mesh_data} x {args.mesh_model} mesh needs {n} ranks; "
                         f"WORLD_SIZE is {world}")
        if world is None and n > 1:
            parser.error(f"a {args.mesh_data} x {args.mesh_model} mesh takes {n} processes: "
                         f"run under python -m torch.distributed.run --standalone "
                         f"--nproc-per-node {n}")
        shape = {"data": args.mesh_data, "model": args.mesh_model}
        try:
            lm_trainer.check_shardable(
                HostMesh(shape=shape, coords={"data": 0, "model": 0},
                         groups={"data": None, "model": None}),
                sharding.policy_from_name(args.policy, model_size=args.mesh_model,
                                          data_size=args.mesh_data))
        except ValueError as err:
            parser.error(str(err))
        return
    if dp_mode and args.dp_compress_bits != 32 and not 2 <= args.dp_compress_bits <= 8:
        parser.error("--dp-compress-bits must be 32 (exact) or in [2, 8] (SR-compressed), "
                     f"got {args.dp_compress_bits}")
    if dp_mode and world is not None and world != args.mesh_data:
        parser.error(f"--mesh-data {args.mesh_data} != WORLD_SIZE {world} of torch.distributed.run")
    if dp_mode and world is None and args.mesh_data > 1:
        parser.error(f"--mesh-data {args.mesh_data} takes {args.mesh_data} processes: run under "
                     f"python -m torch.distributed.run --standalone --nproc-per-node "
                     f"{args.mesh_data}")
    if dp_mode and args.batch % args.mesh_data:
        parser.error(f"--batch {args.batch} is not a multiple of --mesh-data {args.mesh_data}")


def _join_group(device: torch.device) -> torch.device:
    """Join the data-parallel group -> this rank's device: from the
    environment under ``torch.distributed.run`` (a CUDA rank on the card of
    its local rank), else a one-rank group of this process; a process that
    is in a default group already (a launcher that made it) keeps it.
    NCCL on ``cuda``, gloo on ``cpu``."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    kw = {"device_id": device} if device.type == "cuda" else {}
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        return device
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    return device


def _run_lm(args) -> int:
    device = device_mod.resolve(args.device)
    if args.dp_compress_bits is None and args.mesh_data * args.mesh_model == 1:
        return _train_lm(args, device)
    if args.dp_compress_bits is not None and args.mesh_data == 1 and args.dp_compress_bits != 32:
        print("[train] WARNING: --dp-compress-bits < 32 with --mesh-data 1 injects "
              "quantization noise with nothing to communicate")
    made = not dist.is_initialized()
    device = _join_group(device)
    try:
        return _train_lm(args, device)
    finally:
        if made:  # a launcher's group stays its own
            dist.destroy_process_group()


def lm_config(args):
    """The ``--arch`` config the LM scenario runs (``--smoke``: its reduced
    one; ``--layers``: the full one's depth cut; ``--embedding-method``
    overrides its method)."""
    if args.smoke:
        cfg = configs.smoke_config(args.arch)
    else:
        cfg = configs.full_config(args.arch, **({"n_layers": args.layers} if args.layers else {}))
    if args.embedding_method:
        cfg = dataclasses.replace(cfg, embedding_method=args.embedding_method)
    return cfg


def lm_batch(cfg, data: LMTokenStream, step: int, batch: int, seq: int,
             device: torch.device) -> dict:
    """Step ``step``'s batch on ``device``, as the reference's CLI makes it:
    ``tokens`` / ``labels`` from the token stream; an ``embeds`` arch's (the
    encoder) ``embeds`` [batch, seq, d], ``RandomState(step)`` normals, in
    place of the tokens and its labels the stream's modulo the vocabulary;
    a ``mixed`` arch's also ``prefix_embeds`` [batch, visual_prefix, d],
    ``RandomState(step)`` normals, and three equal ``positions`` streams
    [3, batch, seq]."""
    full = torch.from_numpy(data.batch(step, batch)).to(device)
    out = {"tokens": full[:, :-1], "labels": full[:, 1:]}
    if cfg.input_mode == "embeds":
        emb = np.random.RandomState(step).normal(0, 1, (batch, seq, cfg.d_model))
        return {"embeds": torch.from_numpy(emb).to(device=device, dtype=cfg.dtype),
                "labels": full[:, 1:] % cfg.vocab_size}
    if cfg.input_mode == "mixed":
        emb = np.random.RandomState(step).normal(0, 1, (batch, cfg.visual_prefix, cfg.d_model))
        out["prefix_embeds"] = torch.from_numpy(emb).to(device=device, dtype=cfg.dtype)
        pos = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(batch, seq)
        out["positions"] = torch.stack([pos, pos, pos], 0)
    return out


def _train_lm(args, device: torch.device) -> int:
    dp_mode = args.dp_compress_bits is not None
    mesh = None
    if not dp_mode and args.mesh_data * args.mesh_model > 1:
        mesh = make_host_mesh(args.mesh_data, args.mesh_model)
        pol = sharding.policy_from_name(args.policy, model_size=args.mesh_model,
                                        data_size=args.mesh_data)
        with dist_ctx.use(mesh, pol):
            return _train_lm_in(args, device, mesh)
    return _train_lm_in(args, device, None)


def _train_lm_in(args, device: torch.device, mesh) -> int:
    """The ``lm`` scenario's run, under the caller's sharding context when
    ``mesh`` is given."""
    dp_mode = args.dp_compress_bits is not None
    rank = dist.get_rank() if dp_mode or mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = lm_config(args)
    tcfg = lm_trainer.LMTrainerConfig(lr=args.lr, use_kernels=not args.no_kernels,
                                      dp_sync_bits=args.dp_compress_bits if dp_mode else 32,
                                      pad_to_tiles=args.pad_to_tiles, guard=args.guard)
    spec = lm_trainer.embedding_spec_of(cfg, tcfg)
    data = LMTokenStream(cfg.vocab_size, args.seq, seed=17)
    manager = _manager(args)
    ops.reset_kernel_calls()
    ops.reset_fallbacks()
    state = _resume(manager, cfg, spec,
                    lambda: lm_trainer.restore(manager, cfg, tcfg, device=device), say)
    resumed = state is not None
    if resumed:
        say(f"[train] resumed from step {state.step}")
    else:
        state = lm_trainer.init_state(cfg, tcfg, seed=0, device=device)
    agree = bool
    wire = None
    if dp_mode or mesh is not None:
        def agree(flag: bool) -> bool:  # the ranks stop at the same step
            t = torch.tensor([float(flag)], device=device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            return bool(t.item())
    if dp_mode:
        step_fn = data_parallel.make_lm_dp_step(cfg, tcfg)
        wire = data_parallel.wire_report(data_parallel.lm_grad_shapes(cfg, tcfg, state),
                                         tcfg.dp_sync_bits)
        say(f"[train] dp sync_bits={tcfg.dp_sync_bits} "
            f"wire_bytes/step={wire['wire_bytes_per_step']} "
            f"({wire['compression_ratio']:.2f}x vs fp32)")
    else:
        # The host-side refresh (prune's mask); the identity for other methods.
        # The step is donated, as the reference's CLI jits it with
        # donate_argnums=(0,), unless the guard needs the old state back.
        step_fn = lm_trainer.wrap_host_refresh(
            lm_trainer.make_train_step(cfg, tcfg, donate=not args.guard), cfg, tcfg)

    watchdog = StragglerWatchdog()
    guard_stats = faults.GuardStats() if args.guard else None

    def one_step(state):
        batch = lm_batch(cfg, data, state.step, args.batch, args.seq, device)
        t0 = time.perf_counter()
        with tracer().span("train.step", step=state.step):
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])  # waits for the step
        dt = time.perf_counter() - t0
        if guard_stats is not None:
            guard_stats.observe(metrics)
        slow = watchdog.observe(dt)
        if args.log_every and state.step % args.log_every == 0:
            say(f"[train] step {state.step} loss {loss:.4f} {dt * 1e3:.0f}ms"
                f"{' STRAGGLER' if slow else ''}")
        return state, loss, dt * 1e3

    def save(state, force):  # sharded: every rank gathers, rank 0 writes
        return (bool(manager) and (rank == 0 or mesh is not None)
                and lm_trainer.save(manager, cfg, state, tcfg, force=force))

    start = state.step
    state, losses, ms, preempted = _loop(state, args.steps, one_step, save, resumed,
                                         agree=agree, say=say)
    if preempted:
        return 75
    method = methods.get(spec.method)
    report = {
        "arch": cfg.name, "method": spec.method, "bits": spec.bits, "device": str(device),
        "steps": args.steps, "start_step": start, "batch": args.batch, "seq": args.seq,
        "losses": losses,
        "ms_per_step": sum(ms[1:]) / (len(ms) - 1) if len(ms) > 1 else sum(ms),
        "first_step_ms": ms[0] if ms else None, "kernel_launches": ops.kernel_calls(),
        "fallbacks": ops.fallbacks(), "embedding_bytes": method.memory_bytes(state.table, spec),
        "training_bytes": method.memory_bytes(state.table, spec, stored=True),
        "table_shape": [spec.n_padded, spec.d_padded],
        "straggler_steps": watchdog.flagged, "step_time_us": step_quantiles(ms),
    }
    if not args.no_kernels:
        report["kernel_fallbacks"] = ops.fallback_stats()["total_fallbacks"]
    if wire is not None:
        report.update(mesh_data=dist.get_world_size(), **wire)
    if mesh is not None:
        report.update(mesh_data=args.mesh_data, mesh_model=args.mesh_model, policy=args.policy)
    if manager and manager.corrupt_steps:
        report["corrupt_checkpoints"] = manager.corrupt_steps
    if guard_stats is not None:
        report["guard"] = guard_report(guard_stats, say)
    loss_note = f", loss {losses[0]:.4f} -> {losses[-1]:.4f}" if losses else ""
    say(f"[train] lm/{spec.method} {cfg.name} bits={spec.bits} on {device}: steps "
        f"{start + 1}-{args.steps} of {args.batch} x {args.seq}{loss_note}, "
        f"{report['ms_per_step']:.2f} ms/step after the first (host clock)")
    say(json.dumps(report, sort_keys=True))
    return 0


def add_ckpt_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint directory: resume from it, save into it")
    p.add_argument("--ckpt-every", type=int, default=50, help="steps between checkpoints")


def add_trace_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="arm the span tracer and write a Chrome-trace JSON "
                        "(chrome://tracing / ui.perfetto.dev) to PATH at exit")


def add_fault_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--fault-plan", default=None, metavar="JSON",
                   help="install a repro_torch.faults FaultPlan (JSON file) for the run; see "
                        "the seam catalog in repro_torch/faults/__init__.py")


def add_guard_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--guard", action="store_true",
                   help="the non-finite skip-step guard (repro_torch.faults.guards); on by "
                        "itself when --fault-plan schedules a trainer seam")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="scenario", required=True)
    ctr = sub.add_parser("ctr", help="CTR training of the DCN or DeepFM")
    add_model_args(ctr)
    ctr.add_argument("--steps", type=int, default=20)
    ctr.add_argument("--lr", type=float, default=1e-3)
    ctr.add_argument("--log-every", type=int, default=0)
    ctr.add_argument("--eval-batches", type=int, default=0,
                     help="validation batches for AUC / logloss at the end (0 = none)")
    ctr.add_argument("--cache-rows", type=int, default=0,
                     help="device hot-row cache capacity per storage slot (0 = off); "
                          "bitwise the uncached run")
    add_ckpt_args(ctr)
    add_trace_arg(ctr)
    add_fault_arg(ctr)
    add_guard_arg(ctr)
    lm = sub.add_parser("lm", help="LM training (dense, SSM, MoE, encoder, VLM) with a "
                                   "quantized vocab table")
    lm.add_argument("--arch", choices=sorted(configs.ARCHS), default="smollm-135m")
    lm.add_argument("--smoke", action="store_true", help="the reduced config of --arch")
    lm.add_argument("--layers", type=int, default=None,
                    help="cut the full config's depth to this many layers (width kept)")
    lm.add_argument("--steps", type=int, default=100)
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--lr", type=float, default=3e-4)
    lm.add_argument("--embedding-method", choices=methods.available(), default=None,
                    help="override the config's method")
    lm.add_argument("--pad-to-tiles", action="store_true",
                    help="pad the vocab table to the reference's tile geometry (a scratch "
                         "row; rows and width rounded up to 8)")
    lm.add_argument("--no-kernels", action="store_true",
                    help="the plain PyTorch versions on any device")
    lm.add_argument("--log-every", type=int, default=10)
    lm.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    lm.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel ranks (N > 1 under torch.distributed.run)")
    lm.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel ranks of the sharded path (data x model processes)")
    lm.add_argument("--policy", default="tp",
                    choices=("tp", "tp_sp", "fsdp_tp", "fsdp_tp_sp", "fsdp_tp_ep", "tp_ep", "dp"),
                    help="sharding policy of the sharded path, every one executed with every "
                         "--embedding-method: tp, tp_sp, tp_ep (the MoE layers' expert-parallel "
                         "all-to-all dispatch), fsdp_* (the projections also cut over the data "
                         "axis), dp (the model axis more data parallelism)")
    lm.add_argument("--dp-compress-bits", type=int, default=None, metavar="BITS",
                    help="data-parallel mode: replicate the state over --mesh-data ranks and "
                         "sync gradients at this width (32 = exact fp32 mean, 2..8 = "
                         "SR-compressed codes); requires --mesh-model 1")
    add_ckpt_args(lm)
    add_trace_arg(lm)
    add_fault_arg(lm)
    add_guard_arg(lm)
    args = ap.parse_args(argv)
    plan = load_fault_plan(args.fault_plan, "train")
    seams = sorted({"trainer.nonfinite", "alpt.delta"} & set(plan.sites() if plan else ()))
    if seams and not args.guard:
        print(f"[train] plan schedules {seams}; enabling --guard")
        args.guard = True
    if args.scenario == "lm":
        if args.guard and args.dp_compress_bits is not None:
            lm.error("--guard is single-program only (each rank would judge its own loss "
                     "before the sync); drop --dp-compress-bits")
        check_mesh(lm, args)
        if args.dp_compress_bits is not None and lm_config(args).input_mode == "mixed":
            lm.error("--dp-compress-bits does not support mixed-input (M-RoPE positions) archs")
    run = _run_lm if args.scenario == "lm" else _run_ctr
    return run_with_plan(plan, lambda: run_traced(args.trace_out, "train", lambda: run(args)))


if __name__ == "__main__":
    sys.exit(main())
