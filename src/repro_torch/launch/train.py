"""Training CLI of the port: sparse CTR training of the paper's DCN.

    python -m repro_torch.launch.train ctr --config avazu --scale 1.0 \\
        --method alpt --bits 8 --batch 1024 --steps 20

``--device cpu`` runs the plain PyTorch versions on the CPU; the default is
``cuda`` and fails without a GPU.  The state is initialized from
``--seed``, trained on the synthetic ``train`` split, and the report ends
with one JSON line: the losses, host milliseconds per step, kernel launches,
fallbacks and the table's training memory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch import device as device_mod
from repro_torch import methods
from repro_torch.configs import dcn_ctr
from repro_torch.core import lpt as lpt_core
from repro_torch.data.ctr_synth import CTRSynthetic
from repro_torch.kernels import ops
from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig

SETUPS = {"avazu": dcn_ctr.avazu_setup, "criteo": dcn_ctr.criteo_setup}


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The configuration flags ``train`` and ``serve`` share."""
    p.add_argument("--config", choices=sorted(SETUPS), default="avazu")
    p.add_argument("--scale", type=float, default=0.01,
                   help="vocabulary scale of the synthetic dataset (1.0 = full)")
    p.add_argument("--bits", type=int, default=8)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def build(args, method: str):
    """``(data, trainer config)`` for the parsed flags."""
    data_cfg, spec, dcn = SETUPS[args.config](method=method, bits=args.bits, scale=args.scale)
    return CTRSynthetic(data_cfg), TrainerConfig(spec=spec, dcn=dcn, seed=args.seed)


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
    report = {
        "method": args.method, "config": args.config, "scale": args.scale, "bits": args.bits,
        "device": str(device), "steps": args.steps, "batch": args.batch, "losses": losses,
        "ms_per_step": ms, "kernel_launches": ops.kernel_calls(), "fallbacks": ops.fallbacks(),
        "embedding_bytes": methods.get(args.method).memory_bytes(state.emb_state, cfg.spec),
    }
    if cfg.spec.is_integer_table:
        report["training_bytes"] = lpt_core.memory_bytes(state.emb_state, cfg.spec.bits,
                                                         count_optimizer=True)
    if args.eval_batches:
        report.update(trainer.evaluate(state, data.batches("valid", args.batch,
                                                           args.eval_batches)))
    print(f"[train] ctr/{args.method} {args.config} scale={args.scale} bits={args.bits} on "
          f"{device}: {args.steps} steps of {args.batch}, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, {ms:.2f} ms/step (host clock)")
    print(json.dumps(report, sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="scenario", required=True)
    ctr = sub.add_parser("ctr", help="sparse CTR training of the DCN")
    add_model_args(ctr)
    ctr.add_argument("--method", choices=methods.available(), default="alpt")
    ctr.add_argument("--steps", type=int, default=20)
    ctr.add_argument("--lr", type=float, default=1e-3)
    ctr.add_argument("--log-every", type=int, default=0)
    ctr.add_argument("--eval-batches", type=int, default=0,
                     help="validation batches for AUC / logloss at the end (0 = none)")
    return _run_ctr(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
