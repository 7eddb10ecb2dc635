"""Training CLI of the port: CTR training of the paper's DCN (or DeepFM) with
any embedding method, and dense LM training with a quantized vocab table.

    python -m repro_torch.launch.train ctr --config avazu --scale 1.0 \\
        --method alpt --bits 8 --batch 1024 --steps 20 [--model deepfm]
    python -m repro_torch.launch.train ctr --config criteo --method qr_alpt
    python -m repro_torch.launch.train lm --arch smollm-135m --steps 100

``--device cpu`` runs the plain PyTorch versions on the CPU; the default is
``cuda`` and fails without a GPU.  The state is initialized from
``--seed`` (``lm``: from seed 0, with the reference's token stream, seed
17), and the report ends with one JSON line: the losses, host milliseconds
per step, kernel launches, fallbacks and the table's training memory.
``--method`` takes any name in ``repro_torch.methods.available()``; mixed
takes the dataset's field cardinalities, DeepFM a table one column wider
than its embedding (the first-order weight), Criteo's DCN its dropout 0.2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch import methods
from repro_torch.configs import dcn_ctr
from repro_torch.data.ctr_synth import CTRSynthetic
from repro_torch.data.lm_synth import LMTokenStream
from repro_torch.kernels import ops
from repro_torch.models import ctr as ctr_models
from repro_torch.training import lm_trainer
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig

SETUPS = {"avazu": dcn_ctr.avazu_setup, "criteo": dcn_ctr.criteo_setup}


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


def build(args, method: str):
    """``(data, trainer config)`` for the parsed flags (``config``, ``model``,
    ``bits``, ``scale``, ``seed``): the dataset's setup, mixed's field
    cardinalities, and for DeepFM its default MLP and the setup's dropout
    over a table of width d + 1."""
    data_cfg, spec, dcn = SETUPS[args.config](method=method, bits=args.bits, scale=args.scale)
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


def ms_per_step(history) -> float:
    """Mean host milliseconds per step of a ``CTRTrainer.fit`` history."""
    return sum(h["ms"] for h in history) / max(len(history), 1)


def _run_ctr(args) -> int:
    device = device_mod.resolve(args.device)
    data, cfg = build(args, args.method)
    trainer = CTRTrainer(dataclasses.replace(cfg, lr=args.lr), device=device)
    ops.reset_kernel_calls()
    ops.reset_fallbacks()

    def log(h):
        if args.log_every and h["step"] % args.log_every == 0:
            print(f"[train] step {h['step']}: loss {h['loss']:.6f}")

    state, history = trainer.fit(data, steps=args.steps, batch_size=args.batch, log=log)
    if device.type == "cuda":
        torch.cuda.synchronize()
    losses, ms = [h["loss"] for h in history], ms_per_step(history)
    method = methods.get(args.method)
    report = {
        "method": args.method, "model": args.model, "config": args.config,
        "scale": args.scale, "bits": args.bits, "device": str(device), "steps": args.steps,
        "batch": args.batch, "losses": losses, "ms_per_step": ms,
        "kernel_launches": ops.kernel_calls(), "fallbacks": ops.fallbacks(),
        "embedding_bytes": method.memory_bytes(state.emb_state, cfg.spec, training=True),
        "inference_bytes": method.memory_bytes(state.emb_state, cfg.spec, training=False),
        "training_bytes": method.memory_bytes(state.emb_state, cfg.spec, stored=True),
    }
    if args.eval_batches:
        report.update(trainer.evaluate(state, data.batches("valid", args.batch,
                                                           args.eval_batches)))
    print(f"[train] ctr/{args.method} {args.model} {args.config} scale={args.scale} "
          f"bits={args.bits} on "
          f"{device}: {args.steps} steps of {args.batch}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {ms:.2f} ms/step (host clock)")
    print(json.dumps(report, sort_keys=True))
    return 0


def _run_lm(args) -> int:
    device = device_mod.resolve(args.device)
    cfg = configs.smoke_config(args.arch) if args.smoke else configs.full_config(args.arch)
    if args.embedding_method:
        cfg = dataclasses.replace(cfg, embedding_method=args.embedding_method)
    tcfg = lm_trainer.LMTrainerConfig(lr=args.lr, use_kernels=not args.no_kernels)
    spec = lm_trainer.embedding_spec_of(cfg, tcfg)
    data = LMTokenStream(cfg.vocab_size, args.seq, seed=17)
    ops.reset_kernel_calls()
    ops.reset_fallbacks()
    state = lm_trainer.init_state(cfg, tcfg, seed=0, device=device)
    step_fn = lm_trainer.make_train_step(cfg, tcfg)
    losses, ms = [], []
    for step in range(args.steps):
        full = torch.from_numpy(data.batch(step, args.batch)).to(device)
        batch = {"tokens": full[:, :-1], "labels": full[:, 1:]}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
        if args.log_every and (step + 1) % args.log_every == 0:
            print(f"[train] step {step + 1} loss {losses[-1]:.4f} {ms[-1]:.0f}ms")
    method = methods.get(spec.method)
    report = {
        "arch": cfg.name, "method": spec.method, "bits": spec.bits, "device": str(device),
        "steps": args.steps, "batch": args.batch, "seq": args.seq, "losses": losses,
        "ms_per_step": sum(ms[1:]) / max(len(ms) - 1, 1) if len(ms) > 1 else ms[0],
        "first_step_ms": ms[0], "kernel_launches": ops.kernel_calls(),
        "fallbacks": ops.fallbacks(), "embedding_bytes": method.memory_bytes(state.table, spec),
        "training_bytes": method.memory_bytes(state.table, spec, stored=True),
    }
    print(f"[train] lm/{spec.method} {cfg.name} bits={spec.bits} on {device}: {args.steps} "
          f"steps of {args.batch} x {args.seq}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{report['ms_per_step']:.2f} ms/step after the first (host clock)")
    print(json.dumps(report, sort_keys=True))
    return 0


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
    lm = sub.add_parser("lm", help="dense LM training with a quantized vocab table")
    lm.add_argument("--arch", choices=sorted(configs.ARCHS), default="smollm-135m")
    lm.add_argument("--smoke", action="store_true", help="the reduced config of --arch")
    lm.add_argument("--steps", type=int, default=100)
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--lr", type=float, default=3e-4)
    lm.add_argument("--embedding-method", choices=methods.available(), default=None,
                    help="override the config's method")
    lm.add_argument("--no-kernels", action="store_true",
                    help="the plain PyTorch versions on any device")
    lm.add_argument("--log-every", type=int, default=10)
    lm.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return _run_lm(args) if args.scenario == "lm" else _run_ctr(args)


if __name__ == "__main__":
    sys.exit(main())
