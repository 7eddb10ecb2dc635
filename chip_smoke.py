#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ALPT CTR serving and training and of
int8-resident LM serving on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero with no result):
  1. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  2. hold each kernel bitwise against its plain PyTorch version on the card:
     sr_round at the full Avazu table shape (4,428,281 x 16) and a ragged one,
     dequant_gather at bits 8, 4 and 2 with d in {16, 15} and repeated ids;
  2b. sparse_row_update / sparse_row_update_packed at bits 8, 4, 2 on the
     full Avazu table with its scratch row (4,428,288 x 16) and without it
     (4,428,281 x 16, the sentinel past the table), and on ragged 37 x 13
     and 36 x 13 tables, weight decay 0 and 5e-8, over one training wave's
     dedup'd ids (1,024 requests) and its DCN row gradients; the segment sum
     on the card equal to the CPU's, twice;
  2c. adam_update (the dense optimizer's kernel) over the full-width DCN's
     parameters and that wave's gradients, two steps;
  3. serve 4,096 Avazu test requests at full width (24 fields, d=16, DCN
     cross depth 3 + MLP 1024/512/256, alpt, 8 bits, waves of 1,024): the
     state is initialized on the card through sr_round, rows are read through
     dequant_gather; results must be finite probabilities, bitwise equal to
     the same engine on the plain gather, close to a float64 recomputation of
     the first requests, and the table must hold exactly codes + scales;
  4. the same at 4 bits, packed (dequant_gather_packed);
  6. train ALPT on the full padded Avazu table at full width, 20 steps of
     1,024 at 8 bits and then 20 at 4 bits packed (kernels on): launch
     counts, no fallbacks, finite losses, untouched rows bit-identical,
     training memory exactly memory_bytes; the first 3 steps again with the
     kernels off from a copy of the initial state must give the same state
     and losses bit for bit; then serve the trained state;
  6b. the training CLI (python -m repro_torch.launch.train ctr) at full
     width in the paper's setup, without the scratch row, 5 steps: one row
     kernel and one Adam launch per step, no fallbacks;
  2d. dequant_matmul / dequant_matmul_packed (bits 4, 2) at SmolLM's head
     (M in {1, 8}, N = 49,152, K = 576) and ragged shapes against their plain
     versions and a float64 recomputation, each logit within the fp32 error
     bound of its K-term sum; the packed head bitwise equal to the int8 head
     on the unpacked codes; flash_attention_fwd at (B, T, S, H, KH, D) =
     (1, 157, 157, 9, 3, 64), (2, 96, 96, 4, 2, 80) window 32,
     (1, 64, 64, 4, 4, 128) non-causal and (1, 2048, 2048, 9, 3, 64);
  7. serve SmolLM-135M at full width (30 layers, d=576, 9/3 heads, vocab
     49,152, ALPT table, random weights from a seed) at 8 bits, then 4 bits
     packed: 16 requests, prompts of 64/100/128/157 tokens, 32 new tokens
     each, slot batch 8 (token rows through dequant_gather, prefill attention
     through flash_attention_fwd, the tied head through dequant_matmul);
     the plain path (use_kernel=False) teacher-forced on the engine's tokens
     agrees at every step; the requests in reverse order give the same
     tokens; resident bytes exactly codes + Delta; a decode step's peak
     memory grows by less than the fp32 table;
  7b. the serving CLI (python -m repro_torch.launch.serve lm --arch
     smollm-135m) at its defaults, as a subprocess;
  5. time each kernel at the slices' shapes (median of per-launch CUDA-event
     times after warm-up, device work only) beside its bound, its plain
     version's time and the library's one call where there is one, and the
     host's enqueue time per call.
The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  Without a GPU, or outside a checkout, it
exits with code 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
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
TRAIN_STEPS = 20
CLI_STEPS = 5
KERNELS = {
    "sr_round": ("src/repro_torch/kernels/csrc/sr_round.cu",
                 "src/repro/kernels/sr_round.py:58"),
    "dequant_gather": ("src/repro_torch/kernels/csrc/dequant_gather.cu",
                       "src/repro/kernels/dequant_gather.py:42"),
    "dequant_gather_packed": ("src/repro_torch/kernels/csrc/dequant_gather.cu",
                              "src/repro/kernels/dequant_gather.py:78"),
    "sparse_row_update": ("src/repro_torch/kernels/csrc/sparse_row_update.cu",
                          "src/repro/kernels/sparse_row_update.py:71"),
    "sparse_row_update_packed": ("src/repro_torch/kernels/csrc/sparse_row_update.cu",
                                 "src/repro/kernels/sparse_row_update.py:139"),
    # A helper of the training step: the reference's dense Adam is jnp that
    # XLA fuses, with no Pallas kernel.
    "adam_update": ("src/repro_torch/kernels/csrc/adam_update.cu",
                    "src/repro/optim/adam.py:32"),
    "dequant_matmul": ("src/repro_torch/kernels/csrc/dequant_matmul.cu",
                       "src/repro/kernels/dequant_matmul.py:49"),
    "dequant_matmul_packed": ("src/repro_torch/kernels/csrc/dequant_matmul.cu",
                              "src/repro/kernels/dequant_matmul.py:99"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:88"),
}
# LM serving (phase 7): SmolLM-135M at full width.
LM_ARCH = "smollm-135m"
LM_REQUESTS, LM_PROMPTS, LM_MAX_NEW, LM_BATCH, LM_MAX_LEN = 16, (64, 100, 128, 157), 32, 8, 192
# Resident vocab table: 49,152 rows of 576 codes (1 byte each at 8 bits, 288
# bytes per packed 4-bit row) + fp32 Delta.
EXPECTED_LM_RESIDENT = {8: 28_508_160, 4: 14_352_384}
FP32_TABLE_BYTES = 49_152 * 576 * 4  # 113,246,208: what the head never builds
# Teacher-forced logits, kernels on vs off: fp32 through 30 layers, where
# cuBLAS at the slot batch and at batch 1, the flash kernel's online softmax
# and the head kernel each sum in another order (logits are ~N(0, 1)).
LM_LOGIT_ATOL = 2e-3
# (B, T, S, H, KH, D, causal, window) of the attention checks: SmolLM's
# longest prompt, Danube's head dim with a window, Qwen3's head dim without
# a causal mask, and a long causal prefill.
FLASH_CASES = [(1, 157, 157, 9, 3, 64, True, None), (2, 96, 96, 4, 2, 80, True, 32),
               (1, 64, 64, 4, 4, 128, False, None), (1, 2048, 2048, 9, 3, 64, True, None)]
# Attention outputs, kernel vs plain: convex combinations of v (|v| < 6),
# exp and sums in another order, online rescaling.
FLASH_ATOL = 1e-4
U32 = 2.0 ** -24  # unit roundoff of fp32


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


def wave_gradients(torch, dev, batch):
    """One real training wave at full width: the Avazu ALPT state at 8 bits
    (a fresh init), one forward/backward of the DCN at ``batch``'s rows ->
    ``(flat ids, per-lookup row gradients [B*F, 16], dense params, their
    gradients)``."""
    from repro_torch import methods
    from repro_torch.configs import dcn_ctr
    from repro_torch.models import ctr as ctr_models
    from repro_torch.training.ctr_trainer import TrainerConfig, init_state

    _, spec, dcn = dcn_ctr.avazu_setup(method="alpt", bits=8, scale=SCALE)
    state = init_state(TrainerConfig(spec=spec, dcn=dcn, seed=7), device=dev)
    method = methods.get("alpt")
    ids = torch.from_numpy(batch[0]).to(dev)
    labels = torch.from_numpy(batch[1]).to(dev)
    params = [p.detach() for p in state.dense.parameters()]
    _, g_rows, g_dense = method.row_grads(
        state.emb_state, ids, spec=spec, dense_params=list(state.dense.parameters()),
        loss_from_rows=lambda rows: ctr_models.bce_loss(
            ctr_models.logits_from_rows(state.dense, rows), labels))
    return ids.reshape(-1), g_rows.reshape(-1, spec.d), params, g_dense


def check_row_update(torch, dev, g, wave, g_occ, n_live: int, err: dict) -> dict:
    """Phase 2b: the row-step kernels against their plain versions, bitwise,
    over one training wave's ids and row gradients, on tables with and
    without the scratch row; returns the full-table operands for timing."""
    from repro_torch.core import lpt, quant
    from repro_torch.core.codestore import CodeStore
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_row_update as row_kernel

    k = wave.numel()
    uniq, inv = lpt.dedup_ids(wave, n_live)
    g_sum = lpt.segment_sum(g_occ, inv, k)
    check(torch.equal(g_sum, lpt.segment_sum(g_occ, inv, k)), "segment sum differs between calls")
    check(torch.equal(g_sum.cpu(), lpt.segment_sum(g_occ.cpu(), inv.cpu(), k)),
          "segment sum on the card differs from the CPU's in-order sum")
    distinct = int((uniq < n_live).sum())
    ragged_live = 36  # a 37 x 13 table has row 36 as its scratch row; 36 x 13 none
    r_ids = (torch.rand(300, generator=g, device=dev) ** 3 * ragged_live).to(torch.int32)
    r_ids[0] = ragged_live - 1  # the last live row is in the wave with the sentinels
    r_uniq, r_inv = lpt.dedup_ids(r_ids, ragged_live)
    r_g = lpt.segment_sum(torch.randn(300, 13, generator=g, device=dev) * 0.1, r_inv, 300)
    n_full = -(-(n_live + 1) // 8) * 8
    # (table rows, live rows, d, uniq, g_sum): the scratch-row tables
    # (pad_to_tiles) and the paper's tables, whose sentinel lies past the end.
    cases = [(n_full, n_live, 16, uniq, g_sum), (n_live, n_live, 16, uniq, g_sum),
             (ragged_live + 1, ragged_live, 13, r_uniq, r_g),
             (ragged_live, ragged_live, 13, r_uniq, r_g)]
    c1, c2 = lpt.adam_bias_corrections(3)
    timing = {}
    for n, live_rows, d, ids, gs in cases:
        for bits in (8, 4, 2):
            lo, hi = quant.code_bounds(bits)
            codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=dev, dtype=torch.int8)
            step = torch.rand(n, generator=g, device=dev) * 0.01 + 1e-3
            mu = torch.randn(n, d, generator=g, device=dev) * 1e-3
            nu = torch.rand(n, d, generator=g, device=dev) * 1e-5
            noise = torch.rand(ids.numel(), d, generator=g, device=dev)
            for wd in (0.0, 5e-8):
                outs = []
                for use_kernel in (True, False):
                    store = CodeStore.from_codes(codes.clone(), bits)
                    m, v = mu.clone(), nu.clone()
                    args = (step, m, v, ids, gs, noise, 1e-3, c1, c2, bits)
                    if store.packed:
                        fn = row_kernel.sparse_row_update_packed if use_kernel else \
                            ref.sparse_row_update_packed_ref
                        w = fn(store.data, *args, d, weight_decay=wd)
                    else:
                        fn = row_kernel.sparse_row_update if use_kernel else ref.sparse_row_update_ref
                        w = fn(store.data, *args, weight_decay=wd)
                    outs.append((store.data[:live_rows], m[:live_rows], v[:live_rows],
                                 w[ids < live_rows]))
                    check(bool(torch.isfinite(w).all()), f"{n}x{d} bits={bits}: w_new not finite")
                torch.cuda.synchronize()
                name = "sparse_row_update_packed" if bits < 8 else "sparse_row_update"
                e = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*outs))
                err[name] = max(err[name], e)
                check(all(torch.equal(a, b) for a, b in zip(*outs)),
                      f"{name} {n}x{d} bits={bits} wd={wd}: max err {e}")
            if n == n_full and bits in (8, 4):
                timing[bits] = {"codes": CodeStore.from_codes(codes, bits), "step": step,
                                "mu": mu, "nu": nu, "uniq": ids, "g_sum": gs, "noise": noise}
    log(f"[check] sparse_row_update(_packed) bitwise at {n_full}x16 and 37x13 (scratch row) and "
        f"at {n_live}x16 and 36x13 (sentinel past the table), bits 8, 4, 2, weight decay 0 and "
        f"5e-8, over one wave of {k} ids ({distinct} distinct + sentinel padding) and its DCN "
        "row gradients; segment sum equal to the CPU's, twice")
    timing["distinct"] = distinct
    return timing


def check_adam(torch, params, g_dense, err: dict) -> dict:
    """Phase 2c: the dense Adam kernel against its plain version, bitwise, on
    the full-width DCN's parameters and one wave's gradients, two steps (the
    second from nonzero moments); returns the operands for timing."""
    from repro_torch.core import lpt
    from repro_torch.kernels import adam_update as adam_kernel
    from repro_torch.kernels import ref

    for wd in (0.0, 5e-8):
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        p = params
        for t in (1, 2):
            bc1, bc2 = lpt.adam_bias_corrections(t)
            got = adam_kernel.adam_update(p, g_dense, mu, nu, 1e-3, bc1, bc2, weight_decay=wd)
            want = ref.adam_update_ref(p, g_dense, mu, nu, 1e-3, bc1, bc2, weight_decay=wd)
            torch.cuda.synchronize()
            e = max(float((a - b).abs().max()) for x, y in zip(got, want) for a, b in zip(x, y))
            err["adam_update"] = max(err["adam_update"], e)
            check(all(torch.equal(a, b) for x, y in zip(got, want) for a, b in zip(x, y)),
                  f"adam_update step {t} wd={wd}: max err {e}")
            p, mu, nu = got
    n = sum(x.numel() for x in params)
    log(f"[check] adam_update bitwise over the DCN's {len(params)} tensors ({n} parameters), "
        "two steps, weight decay 0 and 5e-8")
    return {"params": params, "grads": g_dense, "mu": mu, "nu": nu}


class Batches(list):
    """Training batches made once, handed to ``CTRTrainer.fit`` as its data:
    ``batch("train", i, size)`` is the i-th, so the host does not make data
    inside a timed step."""

    def batch(self, split: str, i: int, size: int):
        return self[i]


def train_cli(n: int) -> dict:
    """Phase 6b: ``python -m repro_torch.launch.train ctr`` at full width with
    the paper's setup (no scratch row: the dedup sentinel lies past the
    table), alpt at 8 bits: the row kernel and the dense Adam kernel launch
    once per step, nothing falls back; returns the run's launches."""
    from repro_torch.launch import train as train_cli_mod

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_cli_mod.main(["ctr", "--config", "avazu", "--scale", str(SCALE), "--method",
                                 "alpt", "--bits", "8", "--batch", str(BATCH), "--steps",
                                 str(CLI_STEPS), "--seed", "3"])
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and bool(lines), f"training CLI exited {rc}")
    r = json.loads(lines[-1])
    launches = r["kernel_launches"]
    check(launches.get("sparse_row_update") == CLI_STEPS == launches.get("adam_update")
          and launches.get("dequant_gather", 0) >= CLI_STEPS, f"training CLI launches {launches}")
    check(r["fallbacks"] == [], f"training CLI fallbacks {r['fallbacks']}")
    check(all(math.isfinite(x) for x in r["losses"]), f"training CLI losses {r['losses']}")
    check(r["training_bytes"] == n * (16 + 4) + 2 * n * 16 * 4,
          f"training CLI memory {r['training_bytes']}")
    log(f"[train-cli] {lines[-2]}; launches {launches}; no fallbacks; training memory "
        f"{r['training_bytes']} B")
    return launches


def train(torch, np, dev, bits: int, batches, test_ids) -> dict:
    """Phase 6: ALPT training on the full padded Avazu table (the main path),
    then its checks, the kernels-off repeat and serving the trained state."""
    from repro_torch.configs import dcn_ctr
    from repro_torch.core import lpt
    from repro_torch.kernels import ops
    from repro_torch.serving.ctr import CTREngine, CTRRequest
    from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig, clone_state

    _, spec, dcn = dcn_ctr.avazu_setup(method="alpt", bits=bits, scale=SCALE)
    spec = dataclasses.replace(spec, pad_to_tiles=True)
    cfg = TrainerConfig(spec=spec, dcn=dcn, seed=100 + bits)
    trainer = CTRTrainer(cfg, device=dev)
    row = "sparse_row_update_packed" if bits < 8 else "sparse_row_update"
    gather = "dequant_gather_packed" if bits < 8 else "dequant_gather"

    ops.reset_kernel_calls()  # the main path starts here ...
    ops.reset_fallbacks()
    state = trainer.init_state()
    state0 = clone_state(state)
    state, history = trainer.fit(batches, steps=3, batch_size=BATCH, state=state)
    early = (clone_state(state), [h["loss"] for h in history])
    state, rest = trainer.fit(batches, steps=len(batches) - 3, batch_size=BATCH, state=state)
    history += rest
    torch.cuda.synchronize()
    losses, wall = [h["loss"] for h in history], [h["ms"] for h in history]
    trained = ops.kernel_calls()
    steps = len(batches)
    check(trained.get(row, 0) == steps, f"bits={bits}: {row} launched {trained.get(row)} times")
    check(trained.get(gather, 0) >= steps, f"bits={bits}: {gather} launched {trained.get(gather)}")
    check(trained.get("sr_round", 0) == steps + 1, f"bits={bits}: sr_round {trained}")
    check(trained.get("adam_update", 0) == steps, f"bits={bits}: adam_update {trained}")
    check(ops.fallbacks() == [], f"bits={bits}: fallbacks {ops.fallbacks()}")
    check(all(math.isfinite(x) for x in losses), f"bits={bits}: losses {losses}")

    table, before = state.emb_state, state0.emb_state
    n = spec.n
    touched = torch.zeros(n, dtype=torch.bool, device=dev)
    touched[torch.from_numpy(np.concatenate([b[0].ravel() for b in batches])).to(dev).long()] = True
    idle = ~touched
    for name, a, b in (("codes", table.codes.data, before.codes.data),
                       ("step", table.step, before.step), ("mu", table.mu, before.mu),
                       ("nu", table.nu, before.nu)):
        check(torch.equal(a[:n][idle], b[:n][idle]), f"bits={bits}: untouched {name} rows changed")
    check(not torch.equal(table.mu[:n][touched], before.mu[:n][touched]), "no row trained")
    held = sum(t.numel() * t.element_size()
               for t in (table.codes.data, table.step, table.mu, table.nu))
    rows = spec.n_padded
    check(held == lpt.memory_bytes(table, bits, count_optimizer=True)
          and lpt.memory_bytes(table, bits) == rows * (table.codes.data.shape[1] + 4),
          f"bits={bits}: training memory {held} != memory_bytes")
    ms = statistics.mean(wall[1:])
    log(f"[train] bits={bits}: {steps} ALPT steps of {BATCH} on {rows}x16 (pad_to_tiles); loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; host clock: first step {wall[0]:.1f} ms, "
        f"then {ms:.2f} ms/step; {int(touched.sum())} rows touched, the other "
        f"{int(idle.sum())} bit-identical; training memory {held} B (codes + Delta "
        f"{lpt.memory_bytes(table, bits)} B); launches {trained}")

    engine = CTREngine.from_state(state, cfg, batch=BATCH)
    rids = [engine.submit(CTRRequest(ids=r)) for r in test_ids]
    done = engine.run()
    plain_cfg = dataclasses.replace(cfg, spec=dataclasses.replace(spec, use_kernels=False))
    plain = CTREngine.from_state(state, plain_cfg, batch=BATCH)
    prids = [plain.submit(CTRRequest(ids=r)) for r in test_ids]
    pdone = plain.run()
    launches = ops.kernel_calls()  # ... and ends here
    probs = np.array([done[r]["prob"] for r in rids])
    check(bool(np.isfinite(probs).all() and (probs > 0).all() and (probs < 1).all()),
          f"bits={bits}: trained state serves non-finite probabilities")
    check(all(pdone[p] == done[r] for p, r in zip(prids, rids)),
          f"bits={bits}: trained-state engine differs from the plain-gather engine")
    log(f"[train] bits={bits}: the trained state served {len(rids)} requests, bitwise equal to "
        "the plain-gather engine")

    ops.reset_kernel_calls()
    replay, replay_hist = CTRTrainer(plain_cfg, device=dev).fit(batches, steps=3,
                                                                batch_size=BATCH, state=state0)
    replay_losses = [h["loss"] for h in replay_hist]
    torch.cuda.synchronize()
    check(ops.kernel_calls() == {}, f"kernels-off run launched {ops.kernel_calls()}")
    ref_state, ref_losses = early
    same = replay_losses == ref_losses and all(
        torch.equal(a[:n], b[:n]) for a, b in (
            (replay.emb_state.codes.data, ref_state.emb_state.codes.data),
            (replay.emb_state.step, ref_state.emb_state.step),
            (replay.emb_state.mu, ref_state.emb_state.mu),
            (replay.emb_state.nu, ref_state.emb_state.nu))) and all(
        torch.equal(a, b) for a, b in zip(replay.dense.parameters(), ref_state.dense.parameters()))
    check(same, f"bits={bits}: kernels-off steps 1-3 differ from kernels-on: "
                f"{replay_losses} vs {ref_losses}")
    log(f"[train] bits={bits}: steps 1-3 with the kernels off equal the kernels-on run bit for "
        f"bit (losses {ref_losses})")
    profile_steps(torch, trainer, replay, batches, bits)
    return {"launches": launches, "ms_per_step": ms, "first_ms": wall[0], "losses": losses}


def profile_steps(torch, trainer, state, batches, bits: int) -> None:
    """Where a training step's time goes: three more steps (kernels on, from
    ``state``) under torch.profiler; the card's busy share of the host clock
    and the top device ops.  Prints "not measured" when the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = trainer.fit(batches, steps=1, batch_size=BATCH, state=state)  # warm, outside
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.fit(batches, steps=3, batch_size=BATCH, state=state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log(f"[profile] bits={bits}: device time not measured (the profiler saw none)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] bits={bits}: 3 steps in {wall_us / 1e3:.2f} ms (host clock, "
        f"profiler on); device busy {busy_us / 1e3:.3f} ms = {busy_us / wall_us:.1%}; top "
        "device ops (us per step): " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 3:.1f}" for e in top))


def head_bound(torch, x, codes, step):
    """(float64 logits, gamma_{K+1} * (|x| @ |w|.T)): the fp32 error bound of
    a K-term sum of rounded products, in any order."""
    k = x.shape[1]
    w = codes.double() * step.double()[:, None]
    gamma = (k + 1) * U32 / (1 - (k + 1) * U32)
    return x.double() @ w.T, gamma * (x.double().abs() @ w.abs().T)


def check_lm_kernels(torch, dev, g, err: dict) -> None:
    """Phase 2d: the head and attention kernels against their plain versions."""
    from repro_torch.core.codestore import CodeStore
    from repro_torch.kernels import ops

    for m, n, k in ((1, 49_152, 576), (8, 49_152, 576), (3, 37, 13), (3, 37, 15)):
        x = torch.randn(m, k, generator=g, device=dev)
        step = torch.rand(n, generator=g, device=dev) * 0.01 + 1e-4
        for bits in (8, 4, 2):
            lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
            codes = torch.randint(lo, hi + 1, (n, k), generator=g, device=dev, dtype=torch.int8)
            store = CodeStore.from_codes(codes, bits)
            got = ops.dequant_matmul(x, store, step)
            plain = ops.dequant_matmul(x, store, step, use_kernel=False)
            exact, bound = head_bound(torch, x, codes, step)
            torch.cuda.synchronize()
            name = "dequant_matmul_packed" if store.packed else "dequant_matmul"
            e = float((got - plain).abs().max())
            err[name] = max(err[name], e)
            check(bool(((got.double() - exact).abs() <= bound).all()),
                  f"{name} {m}x{n}x{k} bits={bits}: off the float64 value by more than "
                  f"gamma_(K+1) sum|x w|")
            check(bool(((got.double() - plain.double()).abs() <= 2 * bound).all()),
                  f"{name} {m}x{n}x{k} bits={bits}: max err {e} vs plain")
            if store.packed:
                check(torch.equal(got, ops.dequant_matmul(x, codes, step)),
                      f"{name} {m}x{n}x{k} bits={bits}: packed head != int8 head")
    log("[check] dequant_matmul(_packed) at M 1 and 8 x 49152 x 576 and ragged 3x37x13/15, "
        "bits 8, 4, 2: within gamma_(K+1) sum|x w| of float64, within twice that of the "
        "plain matmul; packed heads bitwise equal to the int8 head on the same codes")
    for b, t, s, h, kh, d, causal, window in FLASH_CASES:
        q = torch.randn(b, t, h, d, generator=g, device=dev)
        k = torch.randn(b, s, kh, d, generator=g, device=dev)
        v = torch.randn(b, s, kh, d, generator=g, device=dev)
        got = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
        plain = ops.flash_attention_fwd(q, k, v, causal=causal, window=window, use_kernel=False)
        torch.cuda.synchronize()
        e = float((got - plain).abs().max())
        err["flash_attention_fwd"] = max(err["flash_attention_fwd"], e)
        check(bool(torch.isfinite(got).all()) and e <= FLASH_ATOL,
              f"flash_attention_fwd {(b, t, s, h, kh, d, causal, window)}: max err {e}")
    log(f"[check] flash_attention_fwd within {FLASH_ATOL} of the plain masked softmax at "
        f"{[c[:6] for c in FLASH_CASES]}; max err {err['flash_attention_fwd']:.3g}")


def lm_engine_class():
    """``LMEngine`` that also keeps, per request, the logits it chose each
    token from, and the host time of each prefill and decode step (ending
    with the card synchronised)."""
    import torch

    from repro_torch.serving.lm import LMEngine

    class RecordingEngine(LMEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.logits = {}
            self.prefill_ms, self.decode_ms = [], []

        def _prefill(self, req):
            t0 = time.perf_counter()
            logits, cache = super()._prefill(req)
            torch.cuda.synchronize()
            self.prefill_ms.append((len(req.prompt), (time.perf_counter() - t0) * 1e3))
            self.logits[req.rid] = [logits[0].clone()]
            return logits, cache

        def _decode(self):
            t0 = time.perf_counter()
            logits = super()._decode()
            torch.cuda.synchronize()
            self.decode_ms.append((time.perf_counter() - t0) * 1e3)
            for slot, rid in enumerate(self._slot_rid):
                if rid is not None:
                    self.logits[rid].append(logits[slot].clone())
            return logits

    return RecordingEngine


def lm_serve(torch, np, dev, bits: int) -> dict:
    """Phase 7: LM serving at full width (the main path), then its checks."""
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.lm import LMRequest
    from repro_torch.training import lm_trainer

    cfg = configs.full_config(LM_ARCH, embedding_bits=bits)
    rng = np.random.RandomState(bits)
    prompts = [rng.randint(0, cfg.vocab_size, LM_PROMPTS[i % len(LM_PROMPTS)]).astype(np.int32)
               for i in range(LM_REQUESTS)]
    engine_cls = lm_engine_class()
    gather = "dequant_gather_packed" if bits < 8 else "dequant_gather"
    head = "dequant_matmul_packed" if bits < 8 else "dequant_matmul"

    ops.reset_kernel_calls()  # the main path starts here ...
    ops.reset_fallbacks()
    t0 = time.perf_counter()
    state = lm_trainer.init_state(cfg, seed=bits, device=dev)
    engine = engine_cls.from_state(state, cfg, batch=LM_BATCH, max_len=LM_MAX_LEN)
    for i, p in enumerate(prompts):
        engine.submit(LMRequest(prompt=p, max_new=LM_MAX_NEW, rid=i))
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.kernel_calls()  # ... and ends here
    for kernel in ("sr_round", gather, head, "flash_attention_fwd"):
        check(launches.get(kernel, 0) > 0, f"lm bits={bits}: {kernel} never launched")
    check(launches["flash_attention_fwd"] == LM_REQUESTS * cfg.n_layers,
          f"lm bits={bits}: flash launches {launches['flash_attention_fwd']}")
    check(ops.fallbacks() == [], f"lm bits={bits}: fallbacks {ops.fallbacks()}")
    m = engine.metrics()
    check(len(done) == LM_REQUESTS and all(len(done[i]) == LM_MAX_NEW for i in done),
          f"lm bits={bits}: requests lost or short")
    check(all(0 <= t < cfg.vocab_size for toks in done.values() for t in toks),
          f"lm bits={bits}: tokens outside the vocabulary")
    check(m.tokens_generated == LM_REQUESTS * LM_MAX_NEW and m.int8_resident,
          f"lm bits={bits}: engine metrics {m.to_json()}")
    check(m.resident_embedding_bytes == m.embedding_code_bytes + m.embedding_scale_bytes
          == EXPECTED_LM_RESIDENT[bits],
          f"lm bits={bits}: resident bytes {m.resident_embedding_bytes} != "
          f"{EXPECTED_LM_RESIDENT[bits]}")
    for rid, rows in engine.logits.items():
        check(len(rows) == LM_MAX_NEW and all(bool(torch.isfinite(r).all()) for r in rows),
              f"lm bits={bits}: request {rid} logits not finite or missing")
    decode_ms = statistics.mean(engine.decode_ms[1:])
    prefill = {n: statistics.mean(ms for t, ms in engine.prefill_ms[1:] if t == n)
               for n in LM_PROMPTS}
    log(f"[lm] bits={bits}: {LM_REQUESTS} requests x {LM_MAX_NEW} tokens, slot batch "
        f"{LM_BATCH}: init+serve {wall:.2f}s, serve {m.wall_s:.3f}s "
        f"({m.to_json()['us_per_token']:.1f} us/token); host clock per decode step "
        f"{decode_ms:.2f} ms over {len(engine.decode_ms) - 1} steps, per prefill "
        + ", ".join(f"T={n}: {ms:.2f} ms" for n, ms in prefill.items())
        + f"; resident {m.resident_embedding_bytes} B = codes {m.embedding_code_bytes} + "
        f"Delta {m.embedding_scale_bytes}; launches {launches}")

    # The plain path, teacher-forced on the engine's tokens.
    plain = dataclasses.replace(engine.table, use_kernels=False)
    worst, agree, held, total = 0.0, 0, 0, 0
    with torch.inference_mode():
        for rid, prompt in enumerate(prompts):
            tokens = done[rid]
            p = torch.from_numpy(prompt).to(dev)
            logits, cache = tfm.prefill(state.params, plain, p[None], cfg, LM_MAX_LEN,
                                        use_kernel=False)
            for i, tok in enumerate(tokens):
                if i:
                    logits, cache = tfm.decode_step(
                        state.params, plain, torch.tensor([tokens[i - 1]], device=dev), cache,
                        len(prompt) + i - 1, cfg, use_kernel=False)
                ref_row, got_row = logits[0], engine.logits[rid][i]
                e = float((ref_row - got_row).abs().max())
                worst = max(worst, e)
                check(e <= LM_LOGIT_ATOL, f"lm bits={bits}: request {rid} step {i}: kernel "
                                          f"logits differ from the plain path by {e}")
                top2 = torch.topk(ref_row, 2).values
                total += 1
                agree += int(int(torch.argmax(ref_row)) == tok)
                if float(top2[0] - top2[1]) > 10 * LM_LOGIT_ATOL:
                    held += 1
                    check(int(torch.argmax(ref_row)) == tok,
                          f"lm bits={bits}: request {rid} step {i}: the plain path picks "
                          f"another token at margin {float(top2[0] - top2[1])}")
    log(f"[lm] bits={bits}: teacher-forced plain path (use_kernel=False) within "
        f"{worst:.3g} of the kernel logits (tolerance {LM_LOGIT_ATOL}); greedy tokens agree at "
        f"{agree}/{total} steps, {held} of them held at a top-2 margin > "
        f"{10 * LM_LOGIT_ATOL}")

    # Peak memory over one decode step: the head never builds the fp32 table.
    def decode_peak(table, use_kernel):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with torch.inference_mode():
            tfm.decode_step(state.params, table, torch.zeros(LM_BATCH, dtype=torch.int32,
                                                             device=dev),
                            engine._cache, torch.zeros(LM_BATCH, dtype=torch.int32, device=dev),
                            cfg, use_kernel=use_kernel)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(dev) - base

    kernel_peak, plain_peak = decode_peak(engine.table, True), decode_peak(plain, False)
    check(kernel_peak < FP32_TABLE_BYTES, f"lm bits={bits}: a decode step's peak grows by "
                                          f"{kernel_peak} B >= the fp32 table")
    log(f"[lm] bits={bits}: a decode step's peak memory grows by {kernel_peak} B with the "
        f"kernels ({plain_peak} B on the plain path, which builds the {FP32_TABLE_BYTES} B "
        "fp32 table)")

    profile_decode(torch, engine, bits)

    # Slot-refill determinism: the same requests in reverse order.
    again = engine_cls.from_state(state, cfg, batch=LM_BATCH, max_len=LM_MAX_LEN)
    for i in reversed(range(LM_REQUESTS)):
        again.submit(LMRequest(prompt=prompts[i], max_new=LM_MAX_NEW, rid=i))
    check(again.run() == done, f"lm bits={bits}: reversed arrival order changed the tokens")
    log(f"[lm] bits={bits}: the {LM_REQUESTS} requests in reverse order give every request "
        "the same tokens")
    return {"launches": launches, "state": state, "table": engine.table, "cfg": cfg,
            "decode_ms": decode_ms, "prefill_ms": prefill}


def profile_decode(torch, engine, bits: int, steps: int = 5) -> None:
    """Where a decode step's time goes: ``steps`` more decode steps of the
    engine's slot batch under torch.profiler; the card's busy share of the
    host clock and the top device ops.  Prints "not measured" when the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        engine._decode()  # warm, outside the window
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                engine._decode()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        log(f"[profile] lm bits={bits}: device time not measured (the profiler saw none)")
        return
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] lm bits={bits}: {steps} decode steps in {wall_us / 1e3:.2f} ms (host "
        f"clock, profiler on); device busy {busy_us / 1e3:.3f} ms = {busy_us / wall_us:.1%}; "
        f"{sum(e.count for e in events) / steps:.0f} device ops per step; top (us per step): "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / steps:.1f}" for e in top))


def lm_cli() -> dict:
    """Phase 7b: ``python -m repro_torch.launch.serve lm --arch smollm-135m``
    at its defaults in a subprocess; returns its launches."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch",
                           LM_ARCH], capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"serve lm CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    m = json.loads(lines[-1])
    launches = m["kernel_launches"]
    check(m["requests_completed"] == 8 and m["tokens_generated"] == 8 * 16 and m["int8_resident"]
          and m["resident_embedding_bytes"] == EXPECTED_LM_RESIDENT[8],
          f"serve lm CLI metrics {m}")
    check(all(launches.get(k, 0) > 0 for k in ("dequant_gather", "dequant_matmul",
                                                 "flash_attention_fwd")),
          f"serve lm CLI launches {launches}")
    log(f"[serve-cli] {lines[0]}")
    return launches


def flash_pairs(t: int, s: int, causal: bool, window) -> int:
    """(query, key) pairs the masks let through: the work this input needs."""
    total = 0
    for qi in range(t):
        hi = min(s, qi + 1) if causal else s
        lo = max(0, qi - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def time_lm_kernels(torch, lm_runs, flush) -> dict:
    """Phase 5 for the LM kernels: the head at M = 1 (prefill) and 8 (decode)
    at both widths over the served tables, flash at the slice's longest
    prompt and at T = 2048; each beside its bound, its plain version and the
    library's one call."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    timings, notes = {}, []
    g = torch.Generator(device="cuda").manual_seed(5)
    for bits, kernel in ((8, "dequant_matmul"), (4, "dequant_matmul_packed")):
        table = lm_runs[bits]["table"]
        n, k = table.codes.n, table.codes.d
        width = table.codes.data.shape[1]
        w_fp32 = ops.dequant_gather(table.codes, table.step,
                                    torch.arange(n, dtype=torch.int32, device="cuda"))
        for m in (1, 8):
            x = torch.randn(m, k, generator=g, device="cuda")
            got = time_ms(torch, lambda: ops.dequant_matmul(x, table.codes, table.step), 50, flush)
            plain = time_ms(torch, lambda: ops.dequant_matmul(x, table.codes, table.step,
                                                              use_kernel=False), 20, flush)[0]
            lib = time_ms(torch, lambda: torch.matmul(x, w_fp32.T), 50, flush)[0]
            # fp32 work at both widths: the product and one Delta multiply per
            # code (the packed unpack is integer work on another pipe).
            b_ms, b_by = bound_ms(n * width + 4 * n + 4 * m * k + 4 * m * n,
                                  2 * m * n * k + n * k)
            notes.append(f"[time] {kernel} M={m} N={n} K={k}: {got[0] * 1e3:.2f} us (plain "
                         f"{plain * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us by {b_by}; "
                         f"torch.matmul over the pre-dequantized {n * k * 4} B fp32 table, "
                         f"which the kernel never builds: {lib * 1e3:.2f} us); host enqueue "
                         f"{got[1]:.1f} us")
            if m == LM_BATCH:
                timings[kernel] = (*got, plain, b_ms, b_by, None)
        del w_fp32
    for t, window in ((max(LM_PROMPTS), None), (2048, None)):
        h, kh, d = 9, 3, 64
        q = torch.randn(1, t, h, d, generator=g, device="cuda")
        k = torch.randn(1, t, kh, d, generator=g, device="cuda")
        v = torch.randn(1, t, kh, d, generator=g, device="cuda")
        got = time_ms(torch, lambda: ops.flash_attention_fwd(q, k, v, window=window), 30, flush)
        plain = time_ms(torch, lambda: ops.flash_attention_fwd(q, k, v, window=window,
                                                               use_kernel=False), 10, flush)[0]
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 30, flush)[0]
        pairs = flash_pairs(t, t, True, window)
        b_ms, b_by = bound_ms(4 * (2 * t * h * d + 2 * t * kh * d), 4 * pairs * h * d)
        notes.append(f"[time] flash_attention_fwd T=S={t} H={h} KH={kh} D={d} causal: "
                     f"{got[0] * 1e3:.2f} us (plain {plain * 1e3:.2f} us, bound "
                     f"{b_ms * 1e3:.3f} us by {b_by}, scaled_dot_product_attention "
                     f"{lib * 1e3:.2f} us); host enqueue {got[1]:.1f} us")
        if t == max(LM_PROMPTS):
            timings["flash_attention_fwd"] = (*got, plain, b_ms, b_by, lib)
    for line in notes:
        log(line)
    return timings


def main() -> int:
    # cuBLAS picks deterministic algorithms only with a fixed workspace; the
    # kernels-on / kernels-off training runs of phase 6 must agree bitwise.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
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

    # 2b. the row-step kernels over one training wave
    t0 = time.perf_counter()
    batches = Batches(data.batch("train", i, BATCH) for i in range(TRAIN_STEPS))
    log(f"[data] {TRAIN_STEPS} training batches of {BATCH} in {time.perf_counter() - t0:.1f}s")
    wave, g_occ, dense_params, g_dense = wave_gradients(torch, dev, batches[0])
    row_ops = check_row_update(torch, dev, g, wave, g_occ, n, err)
    adam_ops = check_adam(torch, dense_params, g_dense, err)
    del g_occ

    # 2d. the LM head and attention kernels
    check_lm_kernels(torch, dev, g, err)

    # 3, 4. the serving path at 8 bits, then 4 bits packed
    runs = {8: serve(torch, np, dev, 8, ids, "dequant_gather"),
            4: serve(torch, np, dev, 4, ids, "dequant_gather_packed")}
    launches = {k: sum(r["launches"].get(k, 0) for r in runs.values()) for k in KERNELS}
    log(f"[kernels] launches on the serving path: {launches}")

    # 6. the training path at 8 bits, then 4 bits packed, then serving it
    trains = {bits: train(torch, np, dev, bits, batches, ids) for bits in (8, 4)}
    trained = {k: sum(r["launches"].get(k, 0) for r in trains.values()) for k in KERNELS}
    log(f"[kernels] launches on the training path: {trained}")
    launches = {k: launches[k] + trained[k] for k in KERNELS}

    # 6b. the training CLI at the paper's setup: no scratch row
    cli = train_cli(n)
    launches = {k: launches[k] + cli.get(k, 0) for k in KERNELS}

    # 7. LM serving at full width, 8 bits then 4 bits packed; 7b. its CLI
    lm_runs = {bits: lm_serve(torch, np, dev, bits) for bits in (8, 4)}
    served = {k: sum(r["launches"].get(k, 0) for r in lm_runs.values()) for k in KERNELS}
    log(f"[kernels] launches on the LM serving path: {served}")
    cli = lm_cli()
    launches = {k: launches[k] + served[k] + cli.get(k, 0) for k in KERNELS}

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
        *bound_ms(rows * cols * 9 + rows * 4, rows * cols * 9), None,
    )
    wave = flat[: BATCH * data_cfg.n_fields].contiguous()
    uniq = int(torch.unique(wave).numel())
    for bits, kernel in ((8, "dequant_gather"), (4, "dequant_gather_packed")):
        table = runs[bits]["table"]
        width = table.codes.data.shape[1]
        b, d = wave.numel(), table.codes.d
        # fp32 work: one Delta multiply per element (the packed unpack is
        # integer work on another pipe).
        timings[kernel] = (
            *time_ms(torch, lambda: ops.dequant_gather(table.codes, table.step, wave), 50,
                     flush),
            time_ms(torch, lambda: ops.dequant_gather(table.codes, table.step, wave,
                                                      use_kernel=False), 20, flush)[0],
            *bound_ms(b * 4 + uniq * (width + 4) + b * d * 4, b * d), None,
        )
    k, distinct = row_ops[8]["uniq"].numel(), row_ops["distinct"]
    for bits, kernel in ((8, "sparse_row_update"), (4, "sparse_row_update_packed")):
        o = row_ops[bits]
        codes, width, d = o["codes"], o["codes"].data.shape[1], o["codes"].d
        # Per slot: id, g and noise rows in, w_new out.  Per distinct row (and
        # the scratch row): codes in and out, Delta in, mu and nu in and out.
        # About 30 fp32 operations per element (fma counted as 2).
        nbytes = k * (4 + 3 * 4 * d) + (distinct + 1) * (2 * width + 4 + 4 * 4 * d)

        def run(use_kernel, o=o, codes=codes):
            return ops.sparse_row_update(codes, o["step"], o["mu"], o["nu"], o["uniq"],
                                         o["g_sum"], o["noise"], 1e-3, 0.1, 0.001, bits,
                                         weight_decay=5e-8, use_kernel=use_kernel)
        timings[kernel] = (*time_ms(torch, lambda: run(True), 50, flush),
                           time_ms(torch, lambda: run(False), 20, flush)[0],
                           *bound_ms(nbytes, k * d * 30), None)
    a = adam_ops
    n_el = sum(x.numel() for x in a["params"])

    def adam(use_kernel):
        return ops.adam_update(a["params"], a["grads"], a["mu"], a["nu"], 1e-3, 0.1, 0.001,
                               use_kernel=use_kernel)
    # The library's one call for an Adam step over the same tensors (its own
    # operation order): torch.optim.Adam's fused CUDA step.
    lib_params = [x.clone().requires_grad_(True) for x in a["params"]]
    for x, gr in zip(lib_params, a["grads"]):
        x.grad = gr.clone()
    lib_opt = torch.optim.Adam(lib_params, lr=1e-3, fused=True)
    # Per element: p, g, m, v in and p', m', v' out; about 15 fp32 operations
    # (fma counted as 2).
    timings["adam_update"] = (*time_ms(torch, lambda: adam(True), 50, flush),
                              time_ms(torch, lambda: adam(False), 20, flush)[0],
                              *bound_ms(n_el * 28, n_el * 15),
                              time_ms(torch, lib_opt.step, 50, flush)[0])
    timings.update(time_lm_kernels(torch, lm_runs, flush))
    log(f"[time] one wave = {wave.numel()} ids ({uniq} distinct rows); L2 flushed before "
        "each gather and row-step launch; sr_round over the full table; the row step over "
        f"the full padded table at the training wave's {k} slots ({distinct} distinct); "
        f"adam_update over the DCN's {len(a['params'])} tensors ({n_el} parameters)")
    for bits, r in trains.items():
        log(f"[time] training step, bits={bits}: {r['ms_per_step']:.2f} ms/step on the host "
            f"clock (steps 2-{TRAIN_STEPS}; first step {r['first_ms']:.1f} ms)")
    for bits, r in lm_runs.items():
        log(f"[time] LM serving, bits={bits}: {r['decode_ms']:.2f} ms per decode step of "
            f"{LM_BATCH} slots, prefill " + ", ".join(f"T={t}: {ms:.2f} ms" for t, ms in
                                                      r["prefill_ms"].items())
            + " on the host clock")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    rows_out = []
    for kernel, (source, replaces) in KERNELS.items():
        ms, host_us, plain_ms, b_ms, b_by, lib_ms = timings[kernel]
        lib = "none" if lib_ms is None else f"{lib_ms * 1e3:.2f} us"
        log(f"[time] {kernel}: {ms * 1e3:.2f} us on the card (plain {plain_ms * 1e3:.2f} us, "
            f"bound {b_ms * 1e3:.3f} us by {b_by}, library {lib}); host enqueue "
            f"{host_us:.1f} us per call; {card}")
        rows_out.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kernel], "max_abs_err": err[kernel], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
    check(all(r["launches"] > 0 for r in rows_out), f"a kernel never launched: {launches}")
    check(all(math.isfinite(r["ms"]) for r in rows_out), "a timing is not finite")
    log(f"[chip_smoke] every phase passed in {time.perf_counter() - t_start:.1f}s")
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
