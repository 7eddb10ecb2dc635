"""Serving CLI of the port: CTR scoring and LM decoding.

    python -m repro_torch.launch.serve ctr --config avazu --scale 1.0 \\
        --method alpt --bits 8 --batch 1024 --requests 4096 [--train-steps 20] \\
        [--model deepfm]
    python -m repro_torch.launch.serve lm --arch smollm-135m [--smoke] \\
        --batch 4 --prompt-len 32 --gen 16 --requests 8

``--device cpu`` runs the plain PyTorch versions on the CPU; the default is
``cuda`` and fails without a GPU.  The state is initialized from ``--seed``
(table init through the ``sr_round`` kernel), trained ``--train-steps``
batches of ``--batch`` first (default 0: serve the initial state), served by
``CTREngine`` (integer tables' rows through ``dequant_gather``, per sub-table
for qr_* and mixed; lsq / pact through their int8 export; the fp32 export
of fp, hash and prune), and the report ends with one JSON line of the
engine's metrics.  ``--method`` and ``--model`` take what ``train`` takes.
``lm`` initializes the architecture's params and ALPT vocab table from
``--seed`` (``--smoke``: its reduced
config), submits ``--requests`` random prompts of ``--prompt-len`` tokens,
decodes ``--gen`` tokens each greedily in ``LMEngine`` (slot batch
``--batch``: token rows through ``dequant_gather``, a tied head through
``dequant_matmul``, prefill attention through ``flash_attention_fwd``) and
ends with the same JSON line.  It builds no optimizer state, so
qwen2-vl-7b (whose text path it serves) fits one card at full depth.  An
encoder-only arch (hubert-xlarge) has no decode: ``lm`` says so and exits 0
before building anything, as the reference's CLI does.

Storage tiers (``ctr``): ``--zipf`` serves the reference's Zipf(1.1)
fixture (``train.CTR_ZIPF_DATA``); ``--cache-rows`` composes a device
hot-row cache over every cacheable sub-table, and with ``--cold-tier`` the
code container moves to host memory (a plain integer table only) and the
device keeps Delta and ``--cache-rows`` hot rows; ``--device-budget-bytes``
refuses a tier that would hold more.  A ``[serve] hot tier`` or ``cold
tier`` line reports each slot's hit rate and bytes.

The JSON line carries ``latency_us`` (wave and request quantiles on the
host clock) and ``kernel_fallbacks``.  ``--trace-out PATH`` (both
scenarios) arms the span tracer and writes a Chrome trace to PATH at exit
(``train.run_traced``).

Faults (:mod:`repro_torch.faults`, both scenarios, as the reference's CLI):
``--fault-plan JSON`` installs a ``FaultPlan`` for the run (uninstalled
when it ends); ``--deadline-ms`` sets the engine's per-wave deadline
(observed, not enforced).  The JSON line carries ``served_degraded``,
``deadline_misses``, ``wave_retries``, ``retry_failures`` and ``health``
(``Engine.health()``); the recovery lines (the tiers' refusals, lost and
corrupted prefetches, retries, and the readiness) go to stderr, so the JSON
line stays the last line of stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.launch import train as train_cli
from repro_torch.serving.ctr import CTREngine, CTRRequest
from repro_torch.serving.lm import LMEngine, LMRequest
from repro_torch.training import lm_trainer
from repro_torch.training.ctr_trainer import CTRTrainer, init_state


def _report(engine, m) -> str:
    """The recovery lines (to stderr) and the JSON line of a served run."""
    for c in m.caches:
        if c.admission_oom or c.prefetch_dropped or c.corruption_detected:
            print(f"[serve] {c.tier} tier '{c.name}' recovery: {c.admission_oom} admission "
                  f"refusals, {c.prefetch_dropped} prefetch losses, {c.corruption_detected} "
                  "corrupted prefetches re-fetched", file=sys.stderr)
    print(f"[serve] recovery: {m.served_degraded} degraded waves, {m.deadline_misses} deadline "
          f"misses, {m.wave_retries} wave retries, {m.retry_failures} retry exhaustions",
          file=sys.stderr)
    for name, stats in engine._tier_retry_stats():
        print(f"[serve] {name} tier retries: {json.dumps(stats.to_json())}", file=sys.stderr)
    health = engine.health()
    failed = [k for k, ok in health["checks"].items() if not ok]
    print(f"[serve] health: {'READY' if health['ready'] else 'NOT READY'}"
          + (f" (failing: {', '.join(failed)})" if failed else ""), file=sys.stderr)
    return json.dumps({**m.to_json(), "health": health}, sort_keys=True)


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
    engine = CTREngine.from_state(state, cfg, batch=args.batch, cache_rows=args.cache_rows,
                                  cold_tier=args.cold_tier,
                                  device_budget_bytes=args.device_budget_bytes)
    if args.deadline_ms is not None:
        engine.deadline_s = args.deadline_ms / 1e3
    ids, _ = data.batch("test", 0, args.requests)
    rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
    done = engine.run()
    m = engine.metrics()
    print(
        f"[serve] ctr/{m.embedding_method} {args.model} {train_cli.data_label(args)} "
        f"bits={args.bits} on {device}: {m.requests_completed} requests in "
        f"{m.wall_s:.3f}s; resident embedding bytes {m.resident_embedding_bytes} "
        f"(codes {m.embedding_code_bytes} + scales {m.embedding_scale_bytes}; "
        f"int8_resident={m.int8_resident}); kernel launches {m.kernel_launches}"
    )
    for c in m.caches:
        print(f"[serve] {c.tier} tier '{c.name}': {c.rows_cached}/{c.capacity} rows, hit rate "
              f"{c.hit_rate:.3f} ({c.hits} hits / {c.misses} misses), {c.hot_bytes} B of rows + "
              f"{c.metadata_bytes} B of maps and policy state")
    if m.caches:
        cold = f"; cold host bytes {engine.cold_host_bytes}" if args.cold_tier else ""
        print(f"[serve] aggregate cache hit rate {m.cache_hit_rate:.3f}{cold}")
    print(f"  first probs: {[round(done[r]['prob'], 4) for r in rids[:4]]}")
    print(_report(engine, m))
    return 0


def _run_lm(args) -> int:
    cfg = configs.smoke_config(args.arch) if args.smoke else configs.full_config(args.arch)
    if cfg.input_mode == "embeds":
        print("[serve] encoder-only arch has no decode; nothing to serve")
        return 0
    device = device_mod.resolve(args.device)
    state = lm_trainer.init_state(cfg, seed=args.seed, device=device, optimizer=False)
    engine = LMEngine.from_state(state, cfg, batch=args.batch,
                                 max_len=args.prompt_len + args.gen)
    if args.deadline_ms is not None:
        engine.deadline_s = args.deadline_ms / 1e3
    rng = np.random.RandomState(args.seed)
    for _ in range(args.requests):
        engine.submit(LMRequest(
            prompt=rng.randint(0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new=args.gen))
    done = engine.run()
    m = engine.metrics()
    print(
        f"[serve] lm/{m.embedding_method} {cfg.name} bits={cfg.embedding_bits} on {device}: "
        f"{m.requests_completed} requests, {m.tokens_generated} tokens in {m.wall_s:.3f}s "
        f"({m.to_json()['us_per_token']:.1f} us/token); resident embedding bytes "
        f"{m.resident_embedding_bytes} (codes {m.embedding_code_bytes} + scales "
        f"{m.embedding_scale_bytes}; int8_resident={m.int8_resident}); kernel launches "
        f"{m.kernel_launches}"
    )
    for rid in sorted(done)[:2]:
        print(f"  rid={rid} tokens={done[rid][:8]}...")
    print(_report(engine, m))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="scenario", required=True)
    ctr = sub.add_parser("ctr", help="batched CTR request scoring")
    train_cli.add_model_args(ctr)
    ctr.add_argument("--requests", type=int, default=64)
    ctr.add_argument("--train-steps", type=int, default=0,
                     help="train this many batches of --batch before serving")
    ctr.add_argument("--cache-rows", type=int, default=0,
                     help="device hot-row cache capacity per storage slot (0 = off); "
                          "bitwise the uncached engine")
    ctr.add_argument("--cold-tier", action="store_true",
                     help="codes in host memory; the device keeps Delta + --cache-rows hot rows")
    ctr.add_argument("--device-budget-bytes", type=int, default=None,
                     help="refuse a hot or cold tier whose device bytes exceed this")
    lm = sub.add_parser("lm", help="continuous-batch LM decode")
    lm.add_argument("--arch", choices=sorted(configs.ARCHS), required=True)
    lm.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--prompt-len", type=int, default=32)
    lm.add_argument("--gen", type=int, default=16)
    lm.add_argument("--requests", type=int, default=8)
    lm.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    lm.add_argument("--seed", type=int, default=0)
    for p in (ctr, lm):
        train_cli.add_trace_arg(p)
        train_cli.add_fault_arg(p)
        p.add_argument("--deadline-ms", type=float, default=None,
                       help="per-wave deadline: waves over it tick deadline_misses (observed, "
                            "not enforced)")
    args = ap.parse_args(argv)
    run = _run_lm if args.scenario == "lm" else _run_ctr
    plan = train_cli.load_fault_plan(args.fault_plan, "serve")
    return train_cli.run_with_plan(
        plan, lambda: train_cli.run_traced(args.trace_out, "serve", lambda: run(args)))


if __name__ == "__main__":
    sys.exit(main())
