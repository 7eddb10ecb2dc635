#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ALPT CTR serving on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero with no result):
  1. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  2. hold each kernel bitwise against its plain PyTorch version on the card:
     sr_round at the full Avazu table shape (4,428,281 x 16) and a ragged one,
     dequant_gather at bits 8, 4 and 2 with d in {16, 15} and repeated ids;
  3. serve 4,096 Avazu test requests at full width (24 fields, d=16, DCN
     cross depth 3 + MLP 1024/512/256, alpt, 8 bits, waves of 1,024): the
     state is initialized on the card through sr_round, rows are read through
     dequant_gather; results must be finite probabilities, bitwise equal to
     the same engine on the plain gather, close to a float64 recomputation of
     the first requests, and the table must hold exactly codes + scales;
  4. the same at 4 bits, packed (dequant_gather_packed);
  5. time each kernel at the slice's shapes (median of per-launch CUDA-event
     times after warm-up, device work only) beside its bound and its plain
     version's time, and the host's enqueue time per call.
The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  Without a GPU, or outside a checkout, it
exits with code 2 and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# NVIDIA H100 SXM data sheet: HBM3 rate and fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
REQUESTS, BATCH = 4096, 1024
SPIN_CYCLES = 2_000_000  # ~1 ms of card clock: outlasts enqueueing one timed call
SCALE = 1.0  # vocabulary scale of the Avazu setup: the full 4,428,281-row table
# Resident embedding bytes of the full Avazu table (4,428,281 rows, d=16):
# codes (1 byte per code at 8 bits, 8 bytes per packed 4-bit row) + fp32 Delta.
EXPECTED_RESIDENT = {8: 88_565_620, 4: 53_139_372}
KERNELS = {
    "sr_round": ("src/repro_torch/kernels/csrc/sr_round.cu",
                 "src/repro/kernels/sr_round.py:58"),
    "dequant_gather": ("src/repro_torch/kernels/csrc/dequant_gather.cu",
                       "src/repro/kernels/dequant_gather.py:42"),
    "dequant_gather_packed": ("src/repro_torch/kernels/csrc/dequant_gather.cu",
                              "src/repro/kernels/dequant_gather.py:78"),
}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time on the card: bytes over the HBM rate or ops over the fp32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, flush=None) -> tuple[float, float]:
    """(device ms, host enqueue us) of one call of ``fn``.

    Device time: the median of ``reps`` per-call CUDA-event times after three
    warm-up calls.  A spin kernel queued before each start event keeps the
    card busy while the host enqueues the call, so the events bracket the
    device work only, not the wrapper's Python overhead; ``flush`` (before
    the spin) evicts L2.  Host time: the mean wall time to enqueue one call.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host_us = (time.perf_counter() - t0) / 10 * 1e6
    torch.cuda.synchronize()
    return statistics.median(times), host_us


def float64_logits(torch, np, engine, ids):
    """Independent reference: rows unpacked and scaled in float64, DCN in numpy."""
    idx = torch.from_numpy(ids).to(engine.device)
    codes = engine.table.codes.take(idx).cpu().numpy().astype(np.float64)
    step = engine.table.step[idx].cpu().numpy().astype(np.float64)
    p = engine.dense.jax_params()
    x0 = (codes * step[..., None]).reshape(len(ids), -1)
    x = x0
    for w, b in zip(p["cross_w"], p["cross_b"]):
        x = x0 * (x @ w.astype(np.float64))[:, None] + b + x
    h = x0
    for layer in p["mlp"]:
        h = np.maximum(h @ layer["w"].astype(np.float64) + layer["b"], 0.0)
    return np.concatenate([x, h], axis=-1) @ p["out_w"].astype(np.float64) + float(p["out_b"])


def serve(torch, np, dev, bits: int, ids, kernel: str) -> dict:
    """Phase 3/4: the main path at ``bits``, then the plain-gather twin."""
    import dataclasses

    from repro_torch.configs import dcn_ctr
    from repro_torch.kernels import ops
    from repro_torch.serving.ctr import CTREngine, CTRRequest
    from repro_torch.training.ctr_trainer import TrainerConfig, init_state

    _, spec, dcn = dcn_ctr.avazu_setup(method="alpt", bits=bits, scale=SCALE)
    cfg = TrainerConfig(spec=spec, dcn=dcn, seed=bits)

    ops.reset_kernel_calls()  # the main path starts here ...
    t0 = time.perf_counter()
    state = init_state(cfg, device=dev)
    engine = CTREngine.from_state(state, cfg, batch=BATCH)
    rids = [engine.submit(CTRRequest(ids=row)) for row in ids]
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.kernel_calls()  # ... and ends here
    check(launches.get("sr_round", 0) > 0, f"bits={bits}: sr_round never launched")
    check(launches.get(kernel, 0) > 0, f"bits={bits}: {kernel} never launched")
    m = engine.metrics()
    logits = np.array([done[r]["logit"] for r in rids])
    probs = np.array([done[r]["prob"] for r in rids])
    check(len(done) == REQUESTS and m.requests_completed == REQUESTS, "requests lost")
    check(bool(np.isfinite(probs).all() and (probs > 0).all() and (probs < 1).all()),
          f"bits={bits}: probabilities not finite in (0, 1)")
    check(m.int8_resident and m.kernel_launches.get(kernel) == m.steps == REQUESTS // BATCH,
          f"bits={bits}: engine metrics {m.to_json()}")
    check(m.resident_embedding_bytes == m.embedding_code_bytes + m.embedding_scale_bytes
          == EXPECTED_RESIDENT[bits],
          f"bits={bits}: resident bytes {m.resident_embedding_bytes} (codes "
          f"{m.embedding_code_bytes} + scales {m.embedding_scale_bytes}) != "
          f"{EXPECTED_RESIDENT[bits]}")
    log(f"[serve] bits={bits}: {REQUESTS} requests in {m.steps} waves of {BATCH}; "
        f"init+serve {wall:.3f}s, serve {m.wall_s:.4f}s "
        f"({m.wall_s / REQUESTS * 1e6:.2f} us/request); resident "
        f"{m.resident_embedding_bytes} B = codes {m.embedding_code_bytes} + scales "
        f"{m.embedding_scale_bytes}; launches {launches}")

    plain_cfg = dataclasses.replace(cfg, spec=dataclasses.replace(spec, use_kernels=False))
    plain = CTREngine.from_state(state, plain_cfg, batch=BATCH)
    prids = [plain.submit(CTRRequest(ids=row)) for row in ids]
    pdone = plain.run()
    check(plain.metrics().kernel_launches == {}, "plain engine launched a kernel")
    same = all(pdone[p] == done[r] for p, r in zip(prids, rids))
    check(same, f"bits={bits}: kernel engine differs from the plain-gather engine")
    ref = float64_logits(torch, np, engine, ids[:64])
    err = float(np.abs(ref - logits[:64]).max())
    check(err <= 1e-4, f"bits={bits}: logits differ from float64 recomputation by {err}")
    log(f"[serve] bits={bits}: bitwise equal to the plain-gather engine; max |logit - "
        f"float64 reference| over 64 requests {err:.3g}")
    return {"launches": launches, "table": engine.table}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"[chip_smoke] cannot import numpy/torch: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"[chip_smoke] {ROOT} is not a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.core import quant
    from repro_torch.core.codestore import CodeStore
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import dequant_gather as gather_kernel
    from repro_torch.kernels import sr_round as sr_kernel

    dev = device_mod.resolve("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    stale = sorted(lib for lib in _build.SIGNATURES if not _build._library_path(lib).exists())
    for lib in _build.build():
        _build.library(lib)
    log(f"[build] nvcc compiled {stale or 'nothing (all libraries up to date)'}; "
        f"{len(_build.SIGNATURES)} libraries loaded in {time.perf_counter() - t0:.1f}s")

    # 2. kernels against their plain versions, bitwise
    g = torch.Generator(device=dev).manual_seed(0)
    err = {k: 0.0 for k in KERNELS}
    data_cfg = avazu_like(SCALE)
    n = data_cfg.n_features
    full = {}
    for rows, cols, bit_set in ((n, 16, (8, 4)), (37, 13, (8, 4, 2))):
        w = torch.randn(rows, cols, generator=g, device=dev) * 0.01
        noise = quant.sr_noise(g, (rows, cols))
        for bits in bit_set:
            step = quant.init_step_size(w, bits)
            got = sr_kernel.sr_round(w, step, noise, bits)
            want = ref.sr_round_ref(w, step, noise, bits)
            torch.cuda.synchronize()
            e = float((got.int() - want.int()).abs().max())
            err["sr_round"] = max(err["sr_round"], e)
            check(torch.equal(got, want), f"sr_round {rows}x{cols} bits={bits}: max err {e}")
        if rows == n:
            full = {"w": w, "step": quant.init_step_size(w, 8), "noise": noise}
    log(f"[check] sr_round bitwise at {n}x16 (bits 8, 4) and 37x13 (bits 8, 4, 2)")

    t0 = time.perf_counter()
    data = CTRSynthetic(data_cfg)
    ids, _ = data.batch("test", 0, REQUESTS)
    log(f"[data] Avazu-shaped synthetic data, {n} features: {REQUESTS} test requests "
        f"in {time.perf_counter() - t0:.1f}s")
    flat = torch.from_numpy(ids.reshape(-1)).to(dev)
    flat = torch.cat([flat, flat[:100], torch.tensor([0, n - 1, n - 1], dtype=torch.int32,
                                                     device=dev)])
    for bits in (8, 4, 2):
        for d in (16, 15):
            lo, hi = quant.code_bounds(bits)
            codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=dev,
                                  dtype=torch.int8)
            step = torch.rand(n, generator=g, device=dev) * 0.1 + 1e-3
            store = CodeStore.from_codes(codes, bits)
            if store.packed:
                got = gather_kernel.dequant_gather_packed(store.data, step, flat,
                                                          bits=bits, d=d)
                want = ref.dequant_gather_packed_ref(store.data, step, flat, bits=bits, d=d)
                kernel = "dequant_gather_packed"
            else:
                got = gather_kernel.dequant_gather(codes, step, flat)
                want = ref.dequant_gather_ref(codes, step, flat)
                kernel = "dequant_gather"
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err[kernel] = max(err[kernel], e)
            check(torch.equal(got, want), f"{kernel} bits={bits} d={d}: max err {e}")
    log(f"[check] dequant_gather bitwise at bits 8, 4, 2 x d 16, 15 over {n} rows, "
        f"{flat.numel()} ids with repeats")
    del codes, step, store, got, want

    # 3, 4. the main path at 8 bits, then 4 bits packed
    runs = {8: serve(torch, np, dev, 8, ids, "dequant_gather"),
            4: serve(torch, np, dev, 4, ids, "dequant_gather_packed")}
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values()) for k in KERNELS}
    log(f"[kernels] launches on the serving path: {launches}")

    # 5. timing at the slice's shapes
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    timings = {}
    w, step, noise = full["w"], full["step"], full["noise"]
    rows, cols = w.shape
    timings["sr_round"] = (
        *time_ms(torch, lambda: sr_kernel.sr_round(w, step, noise, 8), 30),
        time_ms(torch, lambda: ref.sr_round_ref(w, step, noise, 8), 20)[0],
        *bound_ms(rows * cols * 9 + rows * 4, rows * cols * 9),
    )
    wave = flat[: BATCH * data_cfg.n_fields].contiguous()
    uniq = int(torch.unique(wave).numel())
    for bits, kernel in ((8, "dequant_gather"), (4, "dequant_gather_packed")):
        table = runs[bits]["table"]
        width = table.codes.data.shape[1]
        b, d = wave.numel(), table.codes.d
        ops_per = 1 if bits == 8 else 5  # multiply; packed adds shift/mask/sign/convert
        timings[kernel] = (
            *time_ms(torch, lambda: ops.dequant_gather(table.codes, table.step, wave), 50,
                     flush),
            time_ms(torch, lambda: ops.dequant_gather(table.codes, table.step, wave,
                                                      use_kernel=False), 20, flush)[0],
            *bound_ms(b * 4 + uniq * (width + 4) + b * d * 4, b * d * ops_per),
        )
    log(f"[time] one wave = {wave.numel()} ids ({uniq} distinct rows); L2 flushed before "
        "each gather launch; sr_round over the full table")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    rows_out = []
    for kernel, (source, replaces) in KERNELS.items():
        ms, host_us, plain_ms, b_ms, b_by = timings[kernel]
        log(f"[time] {kernel}: {ms * 1e3:.2f} us on the card (plain {plain_ms * 1e3:.2f} us, "
            f"bound {b_ms * 1e3:.3f} us by {b_by}); host enqueue {host_us:.1f} us per call; "
            f"{card}")
        rows_out.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kernel], "max_abs_err": err[kernel], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    check(all(r["launches"] > 0 for r in rows_out), f"a kernel never launched: {launches}")
    check(all(math.isfinite(r["ms"]) for r in rows_out), "a timing is not finite")
    print(json.dumps({"kernels": rows_out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"[chip_smoke] FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
