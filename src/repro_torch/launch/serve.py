"""Serving CLI of the port: CTR scoring over a freshly initialized state.

    python -m repro_torch.launch.serve ctr --config avazu --scale 1.0 \\
        --method alpt --bits 8 --batch 1024 --requests 4096

``--device cpu`` runs the plain PyTorch versions on the CPU; the default is
``cuda`` and fails without a GPU.  The state is initialized from ``--seed``
(table init through the ``sr_round`` kernel), served by ``CTREngine`` (rows
through ``dequant_gather``), and the report ends with one JSON line of the
engine's metrics.  Training before serving (the reference's
``--train-steps``) comes with the training slice.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch import device as device_mod
from repro_torch.configs import dcn_ctr
from repro_torch.data.ctr_synth import CTRSynthetic
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.training.ctr_trainer import TrainerConfig, init_state

SETUPS = {"avazu": dcn_ctr.avazu_setup, "criteo": dcn_ctr.criteo_setup}


def _run_ctr(args) -> int:
    device = device_mod.resolve(args.device)
    data_cfg, spec, dcn = SETUPS[args.config](
        method=args.method, bits=args.bits, scale=args.scale
    )
    cfg = TrainerConfig(spec=spec, dcn=dcn, seed=args.seed)
    state = init_state(cfg, device=device)
    engine = CTREngine.from_state(state, cfg, batch=args.batch)
    ids, _ = CTRSynthetic(data_cfg).batch("test", 0, args.requests)
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
    ctr.add_argument("--config", choices=sorted(SETUPS), default="avazu")
    ctr.add_argument("--scale", type=float, default=0.01,
                     help="vocabulary scale of the synthetic dataset (1.0 = full)")
    ctr.add_argument("--method", choices=("lpt", "alpt"), default="alpt")
    ctr.add_argument("--bits", type=int, default=8)
    ctr.add_argument("--batch", type=int, default=32)
    ctr.add_argument("--requests", type=int, default=64)
    ctr.add_argument("--seed", type=int, default=0)
    ctr.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return _run_ctr(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
