"""Serving CLI of the port: CTR scoring over a freshly initialized or trained state.

    python -m repro_torch.launch.serve ctr --config avazu --scale 1.0 \\
        --method alpt --bits 8 --batch 1024 --requests 4096 [--train-steps 20]

``--device cpu`` runs the plain PyTorch versions on the CPU; the default is
``cuda`` and fails without a GPU.  The state is initialized from ``--seed``
(table init through the ``sr_round`` kernel), trained ``--train-steps``
batches of ``--batch`` first (default 0: serve the initial state), served by
``CTREngine`` (rows through ``dequant_gather``), and the report ends with one
JSON line of the engine's metrics.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import device as device_mod
from repro_torch.launch import train as train_cli
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.training.ctr_trainer import CTRTrainer, init_state


def _run_ctr(args) -> int:
    device = device_mod.resolve(args.device)
    data, cfg = train_cli.build(args, args.method)
    if args.train_steps:
        state, history = CTRTrainer(cfg, device=device).fit(data, steps=args.train_steps,
                                                            batch_size=args.batch)
        print(f"[serve] trained {args.train_steps} steps: loss {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f}, {train_cli.ms_per_step(history):.2f} ms/step "
              "(host clock)")
    else:
        state = init_state(cfg, device=device)
    engine = CTREngine.from_state(state, cfg, batch=args.batch)
    ids, _ = data.batch("test", 0, args.requests)
    rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
    done = engine.run()
    m = engine.metrics()
    print(
        f"[serve] ctr/{m.embedding_method} {args.config} scale={args.scale} "
        f"bits={args.bits} on {device}: {m.requests_completed} requests in "
        f"{m.wall_s:.3f}s; resident embedding bytes {m.resident_embedding_bytes} "
        f"(codes {m.embedding_code_bytes} + scales {m.embedding_scale_bytes}; "
        f"int8_resident={m.int8_resident}); kernel launches {m.kernel_launches}"
    )
    print(f"  first probs: {[round(done[r]['prob'], 4) for r in rids[:4]]}")
    print(json.dumps(m.to_json(), sort_keys=True))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="scenario", required=True)
    ctr = sub.add_parser("ctr", help="batched CTR request scoring")
    train_cli.add_model_args(ctr)
    ctr.add_argument("--method", choices=("lpt", "alpt"), default="alpt")
    ctr.add_argument("--requests", type=int, default=64)
    ctr.add_argument("--train-steps", type=int, default=0,
                     help="train this many batches of --batch before serving")
    return _run_ctr(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
