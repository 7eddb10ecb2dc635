#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of ALPT CTR serving and training, of
int8-resident LM serving and of LPT/ALPT LM training on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero with no result):
  1. build the CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  2. hold each kernel bitwise against its plain PyTorch version on the card:
     sr_round at the full Avazu table shape (4,428,281 x 16) and a ragged one,
     dequant_gather(_packed) at bits 8, 4 and 2 on the full Avazu table over a
     CTR wave of real ids and over 4,096 requests (d = 16, also with the codes
     one byte off alignment; d = 15) and on SmolLM's table (49,152 x 576)
     over a decode step's, a prefill's and a training batch's token ids;
  2b. the row step in both forms, sparse_row_update(_packed) (summed
     gradients) and sparse_row_update_runs(_packed) (per-lookup gradients,
     each id's run summed in the kernel), at bits 8, 4, 2 on the full Avazu
     table with its scratch row (4,428,288 x 16) and without it (4,428,281
     x 16, the sentinel past the table), and on ragged 37 x 13 and 36 x 13
     tables, weight decay 0 and 5e-8, over one training wave's dedup'd ids
     (1,024 requests) and its DCN row gradients and over that wave with
     1,100 of its lookups turned into one id; the segment sum on the card
     equal to the CPU's, twice; the g_sum form's launches are this phase's;
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
     counts (the runs form once per step, the g_sum form never), no
     fallbacks, finite losses, untouched rows bit-identical,
     training memory exactly memory_bytes; the first 3 steps again with the
     kernels off from a copy of the initial state must give the same state
     and losses bit for bit; then serve the trained state;
  6b. the training CLI (python -m repro_torch.launch.train ctr) at full
     width in the paper's setup, without the scratch row, 5 steps: one
     sparse_row_update_runs and one Adam launch per step, no fallbacks;
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
  2e. lpt_fused_update (bits 8) and lpt_fused_update_packed (bits 4, 2) at
     SmolLM's table (49,152 x 576) and ragged 37 x 13 / 36 x 15, weight decay
     0 and 5e-8, with and without a new step: bitwise equal to their plain
     versions, packed also to pack(int8 kernel(unpack)); sr_round_seeded at
     49,152 x 576, 37 x 13 and 3 x 5 bitwise equal to its plain version (the
     same Philox words) for 3 seeds, repeatable, within one lattice step, and
     unbiased over 64 seeds at 1,000 sampled elements;
  8. train SmolLM-135M at full width and depth (random weights from a seed,
     LMTokenStream batches of 4 x 1,024 tokens) for 20 steps each: ALPT at 8
     bits (Delta's second forward/backward, write-back through sr_round), LPT
     at 8 bits (lpt_fused_update) and LPT at 4 bits packed
     (lpt_fused_update_packed): one write-back and one adam_update launch per
     step and no other kernel, no fallbacks, finite falling losses, the
     table's training tensors exactly memory_bytes, the write-back's peak
     memory growth below one fp32 table, the first 3 steps with the kernels
     off from a copy of the initial state equal bit for bit, a profiler
     window of 3 steps;
  8b. the training CLI (python -m repro_torch.launch.train lm --arch
     smollm-135m --steps 5) at its defaults, as a subprocess;
  5. time each kernel at the slices' shapes (median of per-launch CUDA-event
     times after warm-up, device work only) beside its bound, its plain
     version's time and the library's one call where there is one, and the
     host's enqueue time per call; the gathers also back to back (256 calls
     over 32 distinct waves, events around the run) at the CTR wave and at
     LM decode and prefill (time_gathers, which gather_only runs without
     the rest, optionally beside another build of dequant_gather.cu);
     flash_attention_fwd at every prompt length of phase 7 and at T = 2048
     (time_flash, which flash_only runs without the rest); the head at
     M = 1, 8 and 64 with its share of the HBM rate (time_head, which
     head_only runs without the rest, optionally beside another build of
     dequant_matmul.cu); sr_round_seeded beside sr_round with its noise
     operand at 49,152 x 576, the row step's two forms at a training wave
     (row_only runs them without the rest, beside another build of
     sparse_row_update.cu, the segment sum they replace and the host time
     of lpt.sparse_apply), and the training attention's forward + backward
     (plain PyTorch, no bound row).
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
# fp32-accurate products on the tensor cores: the data sheet's dense TF32
# rate over the three products of the 3xTF32 split (hi*lo + lo*hi + hi*hi).
TF32X3_OPS_PER_S = 495e12 / 3
# The LM head's products at fp32 accuracy: codes are exact in TF32, so only x
# is split, and a product takes two TF32 terms (x_hi c + x_lo c).
TF32X2_OPS_PER_S = 495e12 / 2
# 32-bit integer rate: 64 INT32 lanes per SM (Hopper white paper) x 132 SMs x
# the 1.98 GHz boost clock behind the 67 TFLOP/s fp32 figure.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# sr_round_seeded's integer work per element: one Philox4x32-10 call per 4
# elements (10 rounds of 2 mulhi + 2 mullo + 2 three-input xors, one LOP3
# each) and the shift of the element's word.  The key schedule depends on
# the seed alone, so a thread forms it once, not once per call.
PHILOX_INT_OPS_PER_ELEMENT = 10 * (2 + 2 + 2) / 4 + 1
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
    # The row step with the duplicate-id sum in front of it folded in: the
    # CTR training path's form (phases 6, 6b).  The two above, which take the
    # summed gradients, leave the main path; their launches are phase 2b's.
    "sparse_row_update_runs": ("src/repro_torch/kernels/csrc/sparse_row_update.cu",
                               "src/repro/kernels/sparse_row_update.py:71 + "
                               "src/repro/core/lpt.py:255"),
    "sparse_row_update_runs_packed": ("src/repro_torch/kernels/csrc/sparse_row_update.cu",
                                      "src/repro/kernels/sparse_row_update.py:139 + "
                                      "src/repro/core/lpt.py:255"),
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
    "lpt_fused_update": ("src/repro_torch/kernels/csrc/lpt_update.cu",
                         "src/repro/kernels/lpt_update.py:50"),
    "lpt_fused_update_packed": ("src/repro_torch/kernels/csrc/lpt_update.cu",
                                "src/repro/kernels/lpt_update.py:93"),
    # No caller in the JAX package but its kernel test: its launches are
    # those of phase 2e's 64-seed unbiasedness run.
    "sr_round_seeded": ("src/repro_torch/kernels/csrc/sr_round.cu",
                        "src/repro/kernels/sr_round.py:87"),
}
# Where a kernel's launch count comes from when it has no main path.
LAUNCHES_FROM = {"sparse_row_update": "phase 2b check", "sparse_row_update_packed":
                 "phase 2b check", "sr_round_seeded": "phase 2e unbiasedness run"}
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
# LM training (phase 8): SmolLM-135M, batches of 4 x 1,024 tokens (the CE in
# two chunks of 512), 20 steps per run, the first 3 replayed kernels-off.
LM_TRAIN_RUNS = (("alpt", 8), ("lpt", 8), ("lpt", 4))
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_REPLAY = 20, 4, 1024, 3
# The table's training tensors: codes (1 B per code at 8 bits, 288 B per
# packed 4-bit row) + fp32 Delta + the row-Adam mu and nu (fp32 [V, d] each).
EXPECTED_LM_TRAIN_BYTES = {8: 255_000_576, 4: 240_844_800}
SEEDED_SWEEP, SEEDED_SAMPLES = 64, 1000
LM_TABLE = (49_152, 576)  # SmolLM-135M's vocab table: the write-back's shape
U32 = 2.0 ** -24  # unit roundoff of fp32


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: float, int_ops: float = 0.0,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time on the card: bytes over the HBM rate, or fp32 ops over
    ``ops_per_s`` (the fp32 rate unless a faster fp32-accurate route exists),
    or 32-bit integer ops over the integer rate, the largest."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / ops_per_s, int_ops / INT32_OPS_PER_S)
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


LONG_RUN = 1_100  # lookups of one id in phase 2b's synthetic wave


def row_runs(torch, ids, g_occ, sentinel: int) -> dict:
    """One wave's row-step operands: its ids, their dedup (``uniq``,
    ``inv``) and runs (``order``, ``starts``), per-lookup gradients and
    their segment sum."""
    from repro_torch.core import lpt

    uniq, inv, order, starts = lpt.dedup_runs(ids, sentinel)
    return {"ids": ids, "uniq": uniq, "inv": inv, "order": order, "starts": starts,
            "g_occ": g_occ, "g_sum": lpt.segment_sum(g_occ, inv, ids.numel())}


def run_row_step(ops, o: dict, runs: bool, bits: int, wd: float = 5e-8,
                 use_kernel: bool = True):
    """One row step over the operands ``o`` (a CodeStore under "codes"): the
    g_sum form, or the runs form that sums ``g_occ`` itself."""
    c1, c2 = o.get("c", (0.1, 0.001))
    if runs:
        return ops.sparse_row_update_runs(o["codes"], o["step"], o["mu"], o["nu"], o["uniq"],
                                          o["g_occ"], o["order"], o["starts"], o["noise"], 1e-3,
                                          c1, c2, bits, weight_decay=wd, use_kernel=use_kernel)
    return ops.sparse_row_update(o["codes"], o["step"], o["mu"], o["nu"], o["uniq"], o["g_sum"],
                                 o["noise"], 1e-3, c1, c2, bits, weight_decay=wd,
                                 use_kernel=use_kernel)


def row_bound(o: dict, distinct: int, runs: bool,
              all_slots: bool = False) -> tuple[float, str]:
    """Least time of one row step over the operands ``o``: what the function
    needs.  Both forms: the live rows' state (per distinct row and the
    scratch row the codes in and out, Delta in, mu and nu in and out), the
    live slots' noise rows, all of w_new (a dead slot's row is written, its
    value unspecified); ~30 fp32 operations per element of a live row (fma
    counted as 2).  The g_sum form adds each slot's id and each live slot's
    g row; with ``all_slots`` it counts instead what the kernel's first port
    moved and did, g and noise rows and a step for every slot (a comparison
    figure for that port's times, not a bound).  The runs form adds the
    lookups' g_occ rows and int64 order entries, starts and uniq, and one add
    per looked-up element."""
    k, m, d = o["uniq"].numel(), o["g_occ"].shape[0], o["codes"].d
    width = o["codes"].data.shape[1]
    state = (distinct + 1) * (2 * width + 4 + 16 * d)
    if not runs:
        read = k if all_slots else distinct  # slots whose g and noise rows are read
        return bound_ms(k * (4 + 4 * d) + read * 8 * d + state,
                        (k if all_slots else distinct + 1) * d * 30)
    nbytes = m * (4 * d + 8) + 4 * (k + 1) + 4 * k + state + distinct * 4 * d + k * 4 * d
    return bound_ms(nbytes, (distinct + 1) * d * 30 + m * d)


def check_row_update(torch, dev, g, wave, g_occ, n_live: int, err: dict) -> dict:
    """Phase 2b: both forms of the row step against their plain versions,
    bitwise: the g_sum form (``sparse_row_update(_packed)``) and the runs
    form, which sums each id's lookups itself (``sparse_row_update_runs
    (_packed)``), over one training wave's ids and DCN row gradients and over
    that wave with LONG_RUN of its lookups turned into one id, on tables with
    and without the scratch row and on ragged ones; returns the full-table
    operands for timing and this phase's launches (the g_sum form's count:
    it has left the main path)."""
    from repro_torch.core import lpt, quant
    from repro_torch.core.codestore import CodeStore
    from repro_torch.kernels import ops

    ops.reset_kernel_calls()
    k = wave.numel()
    real = row_runs(torch, wave, g_occ, n_live)
    check(torch.equal(real["g_sum"], lpt.segment_sum(g_occ, real["inv"], k)),
          "segment sum differs between calls")
    check(torch.equal(real["g_sum"].cpu(), lpt.segment_sum(g_occ.cpu(), real["inv"].cpu(), k)),
          "segment sum on the card differs from the CPU's in-order sum")
    long_ids = wave.clone()
    long_ids[torch.randperm(k, generator=g, device=dev)[:LONG_RUN]] = n_live // 3
    longw = row_runs(torch, long_ids, g_occ, n_live)
    run_len = longw["starts"][1:] - longw["starts"][:-1]
    check(int(run_len.max()) >= LONG_RUN, f"the long run has {int(run_len.max())} lookups")
    distinct = int((real["uniq"] < n_live).sum())
    ragged_live = 36  # a 37 x 13 table has row 36 as its scratch row; 36 x 13 none
    r_ids = (torch.rand(300, generator=g, device=dev) ** 3 * ragged_live).to(torch.int32)
    r_ids[0] = ragged_live - 1  # the last live row is in the wave with the sentinels
    ragged = row_runs(torch, r_ids, torch.randn(300, 13, generator=g, device=dev) * 0.1,
                      ragged_live)
    n_full = -(-(n_live + 1) // 8) * 8
    # (table rows, live rows, d, waves): the scratch-row tables (pad_to_tiles)
    # and the paper's tables, whose sentinel lies past the end.
    cases = [(n_full, n_live, 16, {"real": real, "long": longw}),
             (n_live, n_live, 16, {"real": real, "long": longw}),
             (ragged_live + 1, ragged_live, 13, {"ragged": ragged}),
             (ragged_live, ragged_live, 13, {"ragged": ragged})]
    c = lpt.adam_bias_corrections(3)
    timing = {}
    for n, live_rows, d, waves in cases:
        for bits in (8, 4, 2):
            lo, hi = quant.code_bounds(bits)
            codes = torch.randint(lo, hi + 1, (n, d), generator=g, device=dev, dtype=torch.int8)
            step = torch.rand(n, generator=g, device=dev) * 0.01 + 1e-3
            mu = torch.randn(n, d, generator=g, device=dev) * 1e-3
            nu = torch.rand(n, d, generator=g, device=dev) * 1e-5
            for label, w in waves.items():
                noise = torch.rand(w["uniq"].numel(), d, generator=g, device=dev)
                for wd in (0.0, 5e-8):
                    for runs in (False, True):
                        outs = []
                        for use_kernel in (True, False):
                            o = {**w, "codes": CodeStore.from_codes(codes.clone(), bits),
                                 "step": step, "mu": mu.clone(), "nu": nu.clone(),
                                 "noise": noise, "c": c}
                            out = run_row_step(ops, o, runs, bits, wd, use_kernel)
                            check(bool(torch.isfinite(out).all()),
                                  f"{n}x{d} bits={bits}: w_new not finite")
                            outs.append((o["codes"].data[:live_rows], o["mu"][:live_rows],
                                         o["nu"][:live_rows], out[w["uniq"] < live_rows]))
                        torch.cuda.synchronize()
                        name = ("sparse_row_update_runs" if runs else "sparse_row_update") + \
                            ("_packed" if bits < 8 else "")
                        e = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*outs))
                        err[name] = max(err[name], e)
                        check(all(torch.equal(a, b) for a, b in zip(*outs)),
                              f"{name} {n}x{d} bits={bits} wd={wd} {label} wave: max err {e}")
                if n == n_full and bits in (8, 4) and label == "real":
                    timing[bits] = {**w, "codes": CodeStore.from_codes(codes, bits),
                                    "step": step, "mu": mu, "nu": nu, "noise": noise}
    launches = ops.kernel_calls()
    longest = int((real["starts"][1:] - real["starts"][:-1]).max())
    log(f"[check] sparse_row_update(_packed) and sparse_row_update_runs(_packed) bitwise at "
        f"{n_full}x16 and 37x13 (scratch row) and at {n_live}x16 and 36x13 (sentinel past the "
        f"table), bits 8, 4, 2, weight decay 0 and 5e-8, over one wave of {k} ids ({distinct} "
        f"distinct + sentinel padding; runs up to {longest} long) and its DCN row gradients,"
        f" and over that wave with {LONG_RUN} lookups of one id; "
        f"segment sum equal to the CPU's, twice; launches {launches}")
    timing["distinct"] = distinct
    timing["launches"] = launches
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
    table), alpt at 8 bits: the row kernel (the runs form, which sums the
    gradients itself) and the dense Adam kernel launch once per step, the
    g_sum form never, nothing falls back; returns the run's launches."""
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
    check(launches.get("sparse_row_update_runs") == CLI_STEPS == launches.get("adam_update")
          and "sparse_row_update" not in launches
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
    row = "sparse_row_update_runs_packed" if bits < 8 else "sparse_row_update_runs"
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
    check(not any(trained.get(k, 0) for k in ("sparse_row_update", "sparse_row_update_packed")),
          f"bits={bits}: the g_sum form of the row step ran on the main path: {trained}")
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


def profile_window(torch, run, steps: int, label: str) -> None:
    """Where the time of ``steps`` steps goes: ``run()`` (the steps, ending
    with the card synchronised) under torch.profiler; the card's busy share
    of the host clock, kernels per step, and the top kernels and the top
    operators by the device time of the kernels they launch.  Busy time sums
    the kernels alone: an operator's device time is its kernels' time, so
    summing both would count it twice.  Prints "not measured" when the
    profiler sees no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    timed = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    kernels = [e for e in timed if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"[profile] {label}: device time not measured (the profiler saw no kernel)")
        return

    def top(events):
        return "; ".join(f"{e.key[:60]} {e.self_device_time_total / steps:.1f}" for e in
                         sorted(events, key=lambda e: -e.self_device_time_total)[:5])

    sums = sum(e.count for e in kernels if "indexing_backward" in e.key) / steps
    log(f"[profile] {label}: {steps} steps in {wall_us / 1e3:.2f} ms (host clock, profiler "
        f"on); kernels busy {busy_us / 1e3:.3f} ms = {busy_us / wall_us:.1%}; "
        f"{sum(e.count for e in kernels) / steps:.0f} kernels per step, {sums:g} of them "
        f"indexing_backward_kernel (index_put_'s sorted sum); top kernels (us per "
        f"step): {top(kernels)}; top operators by their kernels' time: "
        f"{top([e for e in timed if e not in kernels])}")


def profile_steps(torch, trainer, state, batches, bits: int) -> None:
    """Three more CTR training steps (kernels on, from ``state``) under the
    profiler, after one outside it."""
    state, _ = trainer.fit(batches, steps=1, batch_size=BATCH, state=state)  # warm, outside
    torch.cuda.synchronize()

    def run():
        trainer.fit(batches, steps=3, batch_size=BATCH, state=state)
        torch.cuda.synchronize()

    profile_window(torch, run, 3, f"bits={bits}")


def head_bound(torch, x, codes, step):
    """(float64 logits, gamma_{K+1} * (|x| @ |w|.T)): the fp32 error bound of
    a K-term sum of rounded products, in any order."""
    k = x.shape[1]
    w = codes.double() * step.double()[:, None]
    gamma = (k + 1) * U32 / (1 - (k + 1) * U32)
    return x.double() @ w.T, gamma * (x.double().abs() @ w.abs().T)


def check_lm_kernels(torch, dev, g, err: dict) -> None:
    """Phase 2d: the head and attention kernels against their plain versions."""
    check_head(torch, dev, g, err)
    check_flash(torch, dev, g, err)


def check_head(torch, dev, g, err: dict) -> None:
    """dequant_matmul(_packed) at SmolLM's head and ragged shapes, bits 8/4/2."""
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


def check_flash(torch, dev, g, err: dict) -> None:
    """flash_attention_fwd against its plain version at ``FLASH_CASES``."""
    from repro_torch.kernels import ops

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
    """``steps`` more decode steps of the engine's slot batch under the
    profiler, after one outside it."""
    with torch.inference_mode():
        engine._decode()  # warm, outside the window
        torch.cuda.synchronize()

        def run():
            for _ in range(steps):
                engine._decode()
            torch.cuda.synchronize()

        profile_window(torch, run, steps, f"lm decode bits={bits}")


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
    """Phase 5 for the LM kernels: the head as :func:`time_head` times it over
    the served tables, flash as :func:`time_flash` times it."""
    tables = {bits: (r["table"].codes, r["table"].step) for bits, r in lm_runs.items()}
    timings, notes = time_head(torch, tables, flush)
    row, flash_notes = time_flash(torch, flush)
    timings["flash_attention_fwd"] = row
    for line in notes + flash_notes:
        log(line)
    return timings


def head_work(m: int, n: int, k: int, width: int) -> tuple[float, tuple[float, str]]:
    """(bytes, bound) of one head call: codes, Delta and x in, y out; the
    2MNK products at the better of the fp32 and 2xTF32 rates, MN Delta
    multiplies, and the code conversion's NK integer operations."""
    nbytes = n * width + 4 * n + 4 * m * k + 4 * m * n
    return nbytes, bound_ms(nbytes, 2 * m * n * k + m * n, int_ops=n * k,
                            ops_per_s=max(FP32_OPS_PER_S, TF32X2_OPS_PER_S))


def other_builds(name: str, specs: dict) -> dict:
    """Build ``{label: (source, nvcc flags)}``, each a variant of
    ``csrc/<name>.cu`` with its C entry points (another commit's source
    unpacked beside its common.cuh, or this one with timing flags), one nvcc
    each, all at once: {label: the loaded library, entry points bound}.
    Their launches are not counted."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (source, flags) in specs.items():
        path = _build.BUILD_DIR / f"{name}-{re.sub(r'[^0-9A-Za-z]+', '-', label)}.so"
        procs[label] = (path, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(path), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (path, proc) in procs.items():
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed for {name} {label}:\n{out}")
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _build.SIGNATURES[name].items():
            if hasattr(lib, fn):  # another commit's source may lack an entry point
                getattr(lib, fn).argtypes = list(argtypes)
        libs[label] = lib
    return libs


def baseline_head(torch, source: str):
    """``launch(x, data, step, bits, k) -> y`` through another build of the
    head (``source``: a dequant_matmul.cu with the same C entry point, e.g.
    the parent commit's, unpacked beside its own common.cuh), for timing it
    in the same call; its launches are not counted."""
    from repro_torch.kernels import _build

    lib = other_builds("dequant_matmul", {"baseline": (source, ())})["baseline"]

    def launch(x, data, step, bits, k):
        y = torch.empty(x.shape[0], data.shape[0], device=x.device)
        err = lib.dequant_matmul_launch(x.data_ptr(), data.data_ptr(), step.data_ptr(),
                                        y.data_ptr(), x.shape[0], data.shape[0], k, bits,
                                        _build.stream_of(x.device))
        check(err == 0, f"baseline head: launch error {err}")
        return y

    return launch


def time_head(torch, tables: dict, flush, baseline=None) -> tuple[dict, list[str]]:
    """The head at M = 1 (prefill), 8 (decode) and 64 over ``tables`` ({bits:
    (CodeStore, step)}, 8 and 4), each beside its bound, its share of the HBM
    rate, its plain version and ``torch.matmul`` over the pre-dequantized
    fp32 table (which the kernel never builds).  With ``baseline`` (from
    :func:`baseline_head`) that build is timed in the same turns: baseline,
    kernel, kernel, baseline.  Returns the kernels-line rows (M = 8) and the
    ``[time]`` lines."""
    from repro_torch.kernels import ops

    timings, notes = {}, []
    g = torch.Generator(device="cuda").manual_seed(5)
    for bits, kernel in ((8, "dequant_matmul"), (4, "dequant_matmul_packed")):
        codes, step = tables[bits]
        n, k = codes.n, codes.d
        width = codes.data.shape[1]
        w_fp32 = ops.dequant_gather(codes, step, torch.arange(n, dtype=torch.int32,
                                                              device="cuda"))
        for m in (1, LM_BATCH, 64):
            x = torch.randn(m, k, generator=g, device="cuda")
            run = lambda: ops.dequant_matmul(x, codes, step)  # noqa: E731
            if baseline is None:
                got = time_ms(torch, run, 50, flush)
                turns = ""
            else:
                base = lambda: baseline(x, codes.data, step, bits, k)  # noqa: E731
                b0 = time_ms(torch, base, 50, flush)[0]
                got = time_ms(torch, run, 50, flush)
                again = time_ms(torch, run, 50, flush)[0]
                b1 = time_ms(torch, base, 50, flush)[0]
                turns = (f"; turns baseline {b0 * 1e3:.2f}, kernel {got[0] * 1e3:.2f}, "
                         f"{again * 1e3:.2f}, baseline {b1 * 1e3:.2f} us")
            plain = time_ms(torch, lambda: ops.dequant_matmul(x, codes, step, use_kernel=False),
                            20, flush)[0]
            lib = time_ms(torch, lambda: torch.matmul(x, w_fp32.T), 50, flush)[0]
            nbytes, (b_ms, b_by) = head_work(m, n, k, width)
            share = nbytes / HBM_BYTES_PER_S * 1e3 / got[0]
            notes.append(f"[time] {kernel} M={m} N={n} K={k}: {got[0] * 1e3:.2f} us, "
                         f"{share:.1%} of the HBM rate (plain {plain * 1e3:.2f} us, bound "
                         f"{b_ms * 1e3:.3f} us by {b_by}; torch.matmul over the pre-dequantized "
                         f"{n * k * 4} B fp32 table, which the kernel never builds: "
                         f"{lib * 1e3:.2f} us); host enqueue {got[1]:.1f} us{turns}")
            if m == LM_BATCH:
                timings[kernel] = (*got, plain, b_ms, b_by, None)
        del w_fp32
    return timings, notes


def head_phases(torch, tables: dict, flush, how: str = "L2 flushed") -> None:
    """Where one head launch spends its time: the kernel built with
    -DHEAD_PHASES stamps the SM clock in lane 0 of warp 0 of block 0; one
    launch per width at M = 8 over ``tables``, L2 flushed, cycles from the
    block's start: x landed and split, then per ring unit the wait for it
    and its products (the refill of its stage included), then the output of
    a finished tile."""
    import ctypes

    from repro_torch.kernels import _build

    lib = other_builds("dequant_matmul", {"phases": (_build.CSRC / "dequant_matmul.cu",
                                                     ("-DHEAD_PHASES",))})["phases"]
    lib.head_phases_read.argtypes = [ctypes.c_void_p]
    g = torch.Generator(device="cuda").manual_seed(8)
    for bits, (codes, step) in tables.items():
        x = torch.randn(LM_BATCH, codes.d, generator=g, device="cuda")
        y = torch.empty(LM_BATCH, codes.n, device="cuda")
        stamps = (ctypes.c_longlong * 64)()
        flush()
        torch.cuda._sleep(SPIN_CYCLES)  # as time_ms runs a call
        err = lib.dequant_matmul_launch(x.data_ptr(), codes.data.data_ptr(), step.data_ptr(),
                                        y.data_ptr(), LM_BATCH, codes.n, codes.d, bits,
                                        _build.stream_of(x.device))
        torch.cuda.synchronize()
        check(err == 0 and lib.head_phases_read(ctypes.cast(stamps, ctypes.c_void_p)) == 0,
              f"head_phases bits={bits}: launch error {err}")
        at = [v - stamps[0] for v in stamps]
        units, prev = [], at[2]
        for u in range(18):
            landed, computed, done = at[8 + 3 * u: 11 + 3 * u]
            if landed <= 0:
                break
            units.append(f"{landed - prev}/{computed - landed}/{done - computed}")
            prev = done
        log(f"[phases] head bits={bits} M={LM_BATCH} ({how}), warp 0 of block 0, SM cycles: "
            f"x landed {at[1]}, split {at[2] - at[1]}; per unit wait/products/write "
            f"{', '.join(units)}; done {at[3]}")


def head_only(baseline: str | None = None, clean_flush: bool = False) -> int:
    """Build the head kernels, check them as phase 2d does and time them at
    SmolLM's head (random codes at 8 and 4 bits), without the rest of the
    smoke; ``baseline`` (another dequant_matmul.cu, e.g. the parent
    commit's) adds a second build timed in the same turns; ``clean_flush``
    times again with L2 evicted by reading a buffer, so that no dirty line
    is written back during the call:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.head_only())"``."""
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.codestore import CodeStore
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library("dequant_matmul")
    base = None
    if baseline is not None:
        base = baseline_head(torch, baseline)
        log(f"[build] baseline: {baseline}")
    log(f"[build] dequant_matmul{' and the baseline' if base else ''} in "
        f"{time.perf_counter() - t0:.1f}s")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    err = {"dequant_matmul": 0.0, "dequant_matmul_packed": 0.0}
    check_head(torch, dev, g, err)
    log(f"[check] max err vs plain: {err}")
    n, k = LM_TABLE
    tables = {}
    for bits in (8, 4):
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        codes = torch.randint(lo, hi + 1, (n, k), generator=g, device=dev, dtype=torch.int8)
        tables[bits] = (CodeStore.from_codes(codes, bits),
                        torch.rand(n, generator=g, device=dev) * 0.01 + 1e-4)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    for line in time_head(torch, tables, flush_buf.zero_, base)[1]:
        log(line)
    if clean_flush:
        for line in time_head(torch, tables, flush_buf.max, base)[1]:
            log(line.replace("[time]", "[time, L2 evicted by reading]"))
    for bits, (codes, _) in tables.items():
        data = codes.data
        log(f"[time] a plain read of the {data.numel()} B of {bits}-bit codes (torch.amax): "
            f"{time_ms(torch, data.amax, 30, flush_buf.zero_)[0] * 1e3:.2f} us")
    head_phases(torch, tables, flush_buf.zero_)
    if clean_flush:
        head_phases(torch, tables, flush_buf.max, how="L2 evicted by reading")
    one = torch.zeros(1, device=dev)
    log(f"[time] the timer's floor, a 1-element add_: "
        f"{time_ms(torch, lambda: one.add_(1), 30, flush_buf.zero_)[0] * 1e3:.2f} us")
    log(card_name())
    return 0


# The gathers (phases 2 and 5, gather_only).  A CTR wave is 1,024 requests x
# 24 fields at d = 16; SmolLM's token rows are d = 576: 8 per decode step and
# 157 for the longest prefill.
LM_GATHER_SHAPES = {"LM decode": LM_BATCH, "LM prefill": max(LM_PROMPTS)}
GATHER_POOL = 32  # distinct waves the back-to-back timing cycles through
B2B_CALLS = 256
# Host enqueue of ops.dequant_gather in a checkout (its src on PYTHONPATH),
# run as a server: it makes the operands of each shape, prints their keys,
# then for each key read from stdin prints the mean time of 100 calls, the
# card held busy by a spin.  Beside each shape's gather it times the
# wrapper's three _build.check_operand calls alone (CTR wave, 8 bits).
HOST_PROBE = f"""
import json, sys, time
import torch
from repro_torch.core.codestore import CodeStore
from repro_torch.data.ctr_synth import avazu_like
from repro_torch.kernels import _build, ops
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
cases = {{}}
for label, n, d, b in [("CTR wave", avazu_like({SCALE}).n_features, 16, {BATCH * 24}),
                       ("LM decode", {LM_TABLE[0]}, {LM_TABLE[1]}, {LM_BATCH}),
                       ("LM prefill", {LM_TABLE[0]}, {LM_TABLE[1]}, {max(LM_PROMPTS)})]:
    for bits in (8, 4):
        codes = torch.randint(-8, 8, (n, d), generator=g, device=dev, dtype=torch.int8)
        case = (CodeStore.from_codes(codes, bits), torch.rand(n, generator=g, device=dev),
                torch.randint(0, n, (b,), generator=g, device=dev, dtype=torch.int32))
        cases[f"{{label}} bits={{bits}}"] = lambda case=case: ops.dequant_gather(*case)
        if label == "CTR wave" and bits == 8:
            store, step, ids = case
            def checks(store=store, step=step, ids=ids, n=n, d=d):
                _build.check_operand("dequant_gather", "step", step, torch.float32, (n,))
                _build.check_operand("dequant_gather", "ids", ids, torch.int32, ids.shape,
                                     step.device)
                _build.check_operand("dequant_gather", "codes", store.data, torch.int8,
                                     (n, d), step.device)
            cases["CTR wave bits=8: the three operand checks"] = checks
for fn in cases.values():
    for _ in range(20):
        fn()
torch.cuda.synchronize()
print(json.dumps(list(cases)), flush=True)
for line in sys.stdin:
    fn = cases[line.strip()]
    torch.cuda._sleep({SPIN_CYCLES * 8})
    t0 = time.perf_counter()
    for _ in range(100):
        fn()
    print((time.perf_counter() - t0) / 100 * 1e6, flush=True)
    torch.cuda.synchronize()
"""


def time_b2b(torch, fns: list, calls: int = B2B_CALLS) -> float:
    """Device ms per call of ``calls`` launches back to back, cycling through
    ``fns`` (calls on distinct inputs, so that neighbours read other rows):
    CUDA events around the whole run, over its count.  A spin queued first
    holds the card while the host enqueues the run, so the events see the
    kernels back to back and not the host's pace; if the spin ended before
    the host was done, the run is repeated with a spin twice as long."""
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES * 8
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for i in range(calls):
            fns[i % len(fns)]()
        end.record()
        late = start.query()  # the spin was over: the card may have waited
        end.synchronize()
        if not late:
            return start.elapsed_time(end) / calls
        spin *= 2
    raise SmokeFailure("time_b2b: the host could not enqueue the run within the spin")


def in_turns(measure, change, variants: dict):
    """``measure`` of every variant, of ``change`` twice, then of the variants
    again in reverse order: (change's two, {label: (first, last)})."""
    first = {label: measure(f) for label, f in variants.items()}
    mine = (measure(change), measure(change))
    last = {label: measure(variants[label]) for label in reversed(variants)}
    return mine, {label: (first[label], last[label]) for label in variants}


def check_gathers(torch, dev, g, err: dict, ctr_sets: list, n: int) -> None:
    """Phase 2: both gathers bitwise against their plain versions at bits 8,
    4 and 2: on the full Avazu table (``n`` rows) at d = 16 over
    ``ctr_sets`` (a CTR wave of real ids and more, each with the first and
    last rows and repeats added), again with the codes one byte off their
    alignment (the byte path), at d = 15 (the ragged path), and on SmolLM's
    table (49,152 x 576) over a decode step's, the longest prefill's and a
    training batch's token ids."""
    import dataclasses

    from repro_torch.core import quant
    from repro_torch.core.codestore import CodeStore
    from repro_torch.kernels import ops

    edge = torch.tensor([0, n - 1, n - 1], dtype=torch.int32, device=dev)
    ctr = [torch.cat([ids, edge]) for ids in ctr_sets]
    vocab, d_lm = LM_TABLE
    lm = [torch.cat([torch.tensor([vocab - 1, 0], dtype=torch.int32, device=dev),
                     torch.randint(0, vocab, (b - 2,), generator=g, device=dev,
                                   dtype=torch.int32)])
          for b in (*LM_GATHER_SHAPES.values(), LM_TRAIN_BATCH * LM_TRAIN_SEQ)]
    cases = [(n, 16, ctr, 0), (n, 16, ctr[:1], 1), (n, 15, ctr, 0), (vocab, d_lm, lm, 0)]
    for bits in (8, 4, 2):
        kernel = "dequant_gather" if bits == 8 else "dequant_gather_packed"
        lo, hi = quant.code_bounds(bits)
        for rows, d, id_sets, offset in cases:
            codes = torch.randint(lo, hi + 1, (rows, d), generator=g, device=dev,
                                  dtype=torch.int8)
            step = torch.rand(rows, generator=g, device=dev) * 0.1 + 1e-3
            store = CodeStore.from_codes(codes, bits)
            if offset:
                buf = torch.empty(store.data.numel() + offset, dtype=store.data.dtype,
                                  device=dev)
                data = buf[offset:].view(store.data.shape).copy_(store.data)
                store = dataclasses.replace(store, data=data)
            for ids in id_sets:
                got = ops.dequant_gather(store, step, ids)
                want = ops.dequant_gather(store, step, ids, use_kernel=False)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                err[kernel] = max(err[kernel], e)
                check(torch.equal(got, want), f"{kernel} bits={bits} {rows}x{d} "
                      f"b={ids.numel()} offset {offset}: max err {e}")
    log(f"[check] dequant_gather(_packed) bitwise at bits 8, 4, 2: {n} x 16 over "
        f"{', '.join(str(i.numel()) for i in ctr)} ids (real Avazu ids, the first and last "
        f"rows, repeats), also with the codes 1 byte off alignment; {n} x 15; {vocab} x "
        f"{d_lm} over {', '.join(str(i.numel()) for i in lm)} token ids")


def gather_variant(torch, lib):
    """``run(store, step, ids) -> out`` through another build of the gathers
    (a ctypes library with the same C entry points); not counted."""
    from repro_torch.kernels import _build

    def run(store, step, ids):
        out = torch.empty(ids.numel(), store.d, device=ids.device)
        args = (store.data.data_ptr(), step.data_ptr(), ids.data_ptr(), out.data_ptr(),
                store.n, store.d, ids.numel())
        stream = _build.stream_of(ids.device)
        err = (lib.dequant_gather_packed_launch(*args, store.bits, stream) if store.packed
               else lib.dequant_gather_launch(*args, stream))
        check(err == 0, f"gather variant: launch error {err}")
        return out

    return run


def gather_bound(torch, store, ids) -> tuple[float, str]:
    """Least time of one gather: ids in, each distinct row's codes and Delta
    in, the fp32 rows out; one Delta multiply per element."""
    b, d = ids.numel(), store.d
    uniq = int(torch.unique(ids).numel())
    return bound_ms(b * 4 + uniq * (store.data.shape[1] + 4) + b * d * 4, b * d)


def time_gathers(torch, tables: dict, pools: dict, flush, variants=None):
    """Both gathers at a CTR wave and at LM decode and prefill: per call (L2
    flushed; ``time_ms``) and back to back over a pool of distinct waves
    (``time_b2b``), each beside its bound; the plain version at the CTR wave.
    ``tables``: {(domain, bits): (CodeStore, step)}, domain "ctr" or "lm",
    bits 8 and 4; ``pools``: {label: (domain, [ids, ...])}, the first entry
    of each pool the one timed per call.  ``variants`` ({label: run} from
    :func:`gather_variant`) are timed in turns with the kernel: variants,
    kernel, kernel, variants reversed.  Returns the kernels-line rows (the
    CTR wave) and the ``[time]`` lines."""
    from repro_torch.kernels import ops

    variants = variants or {}
    timings, notes = {}, []
    for label, (domain, pool) in pools.items():
        for bits in (8, 4):
            kernel = "dequant_gather" if bits == 8 else "dequant_gather_packed"
            store, step = tables[(domain, bits)]
            ids = pool[0]
            per_call = in_turns(
                lambda f: time_ms(torch, f, 50, flush),
                lambda: ops.dequant_gather(store, step, ids),
                {v: (lambda run=run: run(store, step, ids)) for v, run in variants.items()})
            b2b = in_turns(
                lambda fns: time_b2b(torch, fns),
                [lambda i=i: ops.dequant_gather(store, step, i) for i in pool],
                {v: [lambda i=i, run=run: run(store, step, i) for i in pool]
                 for v, run in variants.items()})
            b_ms, b_by = gather_bound(torch, store, ids)
            (c0, host_us), (c1, _) = per_call[0]
            others = "".join(f"; {v} {a[0] * 1e3:.2f}, {z[0] * 1e3:.2f}"
                             for v, (a, z) in per_call[1].items())
            others_b2b = "".join(f"; {v} {a * 1e3:.2f}, {z * 1e3:.2f}"
                                 for v, (a, z) in b2b[1].items())
            plain = ""
            if domain == "ctr":
                plain_ms = time_ms(torch, lambda: ops.dequant_gather(store, step, ids,
                                                                     use_kernel=False),
                                   20, flush)[0]
                plain = f"; plain {plain_ms * 1e3:.2f} us"
                timings[kernel] = (c0, host_us, plain_ms, b_ms, b_by, None)
            notes.append(
                f"[time] {kernel} {label} b={ids.numel()} d={store.d}: per call (L2 flushed) "
                f"{c0 * 1e3:.2f}, {c1 * 1e3:.2f} us{others}; back to back ({B2B_CALLS} calls "
                f"over {len(pool)} distinct waves) {b2b[0][0] * 1e3:.2f}, "
                f"{b2b[0][1] * 1e3:.2f} us{others_b2b}; bound {b_ms * 1e3:.3f} us by {b_by}"
                f"{plain}; host enqueue {host_us:.1f} us")
    return timings, notes


def host_enqueue(roots: dict, rounds: int = 15, probe: str = HOST_PROBE) -> dict:
    """``probe`` in one process per checkout (``roots``: {name: root}),
    all alive at once and asked in turns, the order reversed every round
    (A B, B A, ...), so that a change in the host's load reaches both alike:
    {key: {name: median us per call}}."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", probe], cwd=root, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True, env={**os.environ, "PYTHONPATH": str(root / "src")})
        for name, root in roots.items()}
    try:
        keys = [json.loads(p.stdout.readline()) for p in procs.values()][0]
        got = {key: {name: [] for name in procs} for key in keys}
        for r in range(rounds):
            order = list(procs) if r % 2 == 0 else list(reversed(procs))
            for key in keys:
                for name in order:
                    procs[name].stdin.write(key + "\n")
                    procs[name].stdin.flush()
                    got[key][name].append(float(procs[name].stdout.readline()))
    finally:
        for p in procs.values():
            p.stdin.close()
            p.wait(timeout=120)
    check(all(p.returncode == 0 for p in procs.values()), "a host probe failed")
    return {key: {name: statistics.median(v) for name, v in by.items()}
            for key, by in got.items()}


def gather_only(baseline: str | None = None) -> int:
    """Build the gathers, check them as phase 2 does, and time them as phase
    5 does (a CTR wave on the full Avazu table, SmolLM's decode and prefill
    rows; random codes at 8 and 4 bits), and the timer's floor.
    ``baseline`` (another dequant_gather.cu inside a checkout, e.g. the
    parent commit's: ``git archive HEAD src/repro_torch | tar -x -C
    build/parent``) is built, checked bitwise and timed in turns with this
    one (baseline, this, this, baseline), and the host enqueue per call of
    that checkout and of this one is measured in a process each, asked in
    turns (:func:`host_enqueue`):
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.gather_only())"``."""
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.codestore import CodeStore
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    specs = {} if baseline is None else {"baseline": (pathlib.Path(baseline).resolve(), ())}
    _build.library("dequant_gather")
    variants = {label: gather_variant(torch, lib)
                for label, lib in other_builds("dequant_gather", specs).items()}
    log(f"[build] dequant_gather in {time.perf_counter() - t0:.1f}s"
        + (f", with the baseline {baseline}" if baseline else ""))
    dev = torch.device("cuda")
    check(_build.stream_of(dev) == torch.cuda.current_stream(dev).cuda_stream,
          "stream_of differs from the current stream's handle")
    g = torch.Generator(device=dev).manual_seed(0)
    data = CTRSynthetic(avazu_like(SCALE))
    n = data.cfg.n_features
    pool = [torch.from_numpy(data.batch("test", i, BATCH)[0].reshape(-1)).to(dev)
            for i in range(GATHER_POOL)]
    err = {"dequant_gather": 0.0, "dequant_gather_packed": 0.0}
    check_gathers(torch, dev, g, err, pool[:2], n)
    log(f"[check] max err vs plain: {err}")
    tables = {}
    for domain, (rows, d) in (("ctr", (n, 16)), ("lm", LM_TABLE)):
        for bits in (8, 4):
            lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
            codes = torch.randint(lo, hi + 1, (rows, d), generator=g, device=dev,
                                  dtype=torch.int8)
            tables[(domain, bits)] = (CodeStore.from_codes(codes, bits),
                                      torch.rand(rows, generator=g, device=dev) * 0.01 + 1e-4)
    pools = {"CTR wave": ("ctr", pool)}
    for label, b in LM_GATHER_SHAPES.items():
        pools[label] = ("lm", [torch.randint(0, LM_TABLE[0], (b,), generator=g, device=dev,
                                             dtype=torch.int32) for _ in range(GATHER_POOL)])
    for label, run in variants.items():
        for (domain, bits), (store, step) in tables.items():
            for ids in [pool[0]] if domain == "ctr" else [pools["LM prefill"][1][0]]:
                check(torch.equal(run(store, step, ids),
                                  ops.dequant_gather(store, step, ids, use_kernel=False)),
                      f"the {label} build differs from the plain gather: bits={bits} "
                      f"b={ids.numel()} d={store.d}")
    if variants:
        log("[check] the baseline build bitwise equal to the plain gathers at bits 8, 4")
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    for line in time_gathers(torch, tables, pools, flush_buf.zero_, variants)[1]:
        log(line)
    one_el = torch.zeros(1, device=dev)
    floor = time_ms(torch, lambda: one_el.add_(1), 30, flush_buf.zero_)[0]
    log(f"[time] the timer's floor, a 1-element add_: {floor * 1e3:.2f} us per call, "
        f"{time_b2b(torch, [lambda: one_el.add_(1)]) * 1e3:.2f} us back to back")
    if baseline is not None:
        other = pathlib.Path(baseline).resolve().parents[4]
        check((other / "src" / "repro_torch").is_dir(), f"{other} is not a checkout")
        for key, us in host_enqueue({"baseline": other, "this checkout": ROOT}).items():
            log(f"[host] {key}, us per call (median of 15 rounds of 100 calls, the two "
                f"processes in turns): baseline {us['baseline']:.2f}, this checkout "
                f"{us['this checkout']:.2f}")
    log(card_name())
    return 0


# The row step alone (row_only).  Host time of lpt.sparse_apply with the
# kernels on, at the CTR wave on the full padded Avazu table, in a checkout
# (its src on PYTHONPATH), run as a server in the manner of HOST_PROBE: per
# key read from stdin, the mean wall time of 50 calls back to back ending
# with a sync (the longer of the host's enqueue and the card's work, and any
# wait for the card inside a call), or the number of aten operations one
# call dispatches.
ROW_HOST_PROBE = f"""
import json, sys, time
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.core import lpt
from repro_torch.core.codestore import CodeStore
from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)
data = CTRSynthetic(avazu_like({SCALE}))
n_live = data.cfg.n_features
n = -(-(n_live + 1) // 8) * 8
ids = torch.from_numpy(data.batch("train", 0, {BATCH})[0]).to(dev)
g_rows = torch.randn(*ids.shape, 16, generator=g, device=dev) * 0.01
noise = torch.rand(ids.numel(), 16, generator=g, device=dev)

class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {{}}))

cases = {{}}
for bits in (8, 4):
    codes = torch.randint(-8, 8, (n, 16), generator=g, device=dev, dtype=torch.int8)
    table = lpt.LPTTable(codes=CodeStore.from_codes(codes, bits),
                         step=torch.rand(n, generator=g, device=dev) * 0.01 + 1e-3,
                         mu=torch.zeros(n, 16, device=dev), nu=torch.zeros(n, 16, device=dev),
                         count=3)
    def call(table=table, bits=bits):
        lpt.sparse_apply(table, ids, g_rows, lr=1e-3, bits=bits, noise=noise,
                         weight_decay=5e-8, id_space=n_live, use_kernels=True)
    def ops_per_call(call=call):
        with Count() as c:
            call()
        return c.n
    cases[f"sparse_apply bits={{bits}}: us per call"] = call
    cases[f"sparse_apply bits={{bits}}: aten ops per call"] = ops_per_call
for key, fn in cases.items():
    for _ in range(5):
        fn()
torch.cuda.synchronize()
print(json.dumps(list(cases)), flush=True)
for line in sys.stdin:
    key = line.strip()
    if key.endswith("aten ops per call"):
        print(cases[key](), flush=True)
        continue
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        cases[key]()
    torch.cuda.synchronize()
    print((time.perf_counter() - t0) / 50 * 1e6, flush=True)
"""
ROW_POOL = 8  # distinct training waves the back-to-back timing cycles through


def row_variant(torch, lib):
    """``run(o, bits, g_sum=None) -> w_new`` through another build's g_sum
    form (``sparse_row_update_launch``) at run_row_step's scalars; not
    counted."""
    from repro_torch.kernels import _build, ref

    def run(o, bits, g_sum=None):
        codes = o["codes"]
        k, d = o["uniq"].numel(), codes.d
        w_new = torch.empty(k, d, device=codes.data.device)
        g_sum = o["g_sum"] if g_sum is None else g_sum
        err = lib.sparse_row_update_launch(
            codes.data.data_ptr(), o["step"].data_ptr(), o["mu"].data_ptr(), o["nu"].data_ptr(),
            o["uniq"].data_ptr(), g_sum.data_ptr(), o["noise"].data_ptr(), w_new.data_ptr(),
            codes.n, d, k, codes.data.shape[1], codes.bits if codes.packed else 8, bits,
            ref.f32(1e-3), ref.f32(0.1), ref.f32(0.001), ref.B1, ref.A1, ref.B2, ref.A2, ref.EPS,
            ref.f32(5e-8), _build.stream_of(w_new.device))
        check(err == 0, f"row variant: launch error {err}")
        return w_new

    return run


def row_only(baseline: str | None = None) -> int:
    """Build the row step, check both forms as phase 2b does, and time them
    at the CTR wave (1,024 Avazu requests) on the full padded Avazu table at
    8 and 4 bits: per call (L2 flushed, ``time_ms``) and back to back over
    ROW_POOL distinct waves (``time_b2b``), beside their bounds, the plain
    versions, what the runs' operands and the segment sum cost, and the
    timer's floor.  ``baseline`` (the parent commit's sparse_row_update.cu
    inside an unpacked checkout: ``git archive HEAD src/repro_torch | tar -x
    -C build/parent``) is built, checked bitwise and timed in turns with this
    one (baseline, this, this, baseline): its g_sum kernel against this one's,
    and the segment sum + its kernel against the runs form; and the host
    time of ``lpt.sparse_apply`` in that checkout and in this one, in a
    process each asked in turns (:func:`host_enqueue`):
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.row_only())"``."""
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import lpt
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    specs = {} if baseline is None else {"baseline": (pathlib.Path(baseline).resolve(), ())}
    _build.library("sparse_row_update")
    variants = {label: row_variant(torch, lib)
                for label, lib in other_builds("sparse_row_update", specs).items()}
    log(f"[build] sparse_row_update in {time.perf_counter() - t0:.1f}s"
        + (f", with the baseline {baseline}" if baseline else ""))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    data = CTRSynthetic(avazu_like(SCALE))
    n = data.cfg.n_features
    batches = [data.batch("train", i, BATCH) for i in range(ROW_POOL)]
    wave, g_occ, _, _ = wave_gradients(torch, dev, batches[0])
    err = {k: 0.0 for k in KERNELS}
    row_ops = check_row_update(torch, dev, g, wave, g_occ, n, err)
    log(f"[check] max err vs plain: " + str({k: v for k, v in err.items() if "row" in k}))
    distinct = row_ops["distinct"]
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    for bits in (8, 4):
        o = row_ops[bits]
        k = o["uniq"].numel()
        pool = [o] + [{**o, **row_runs(torch, torch.from_numpy(b[0].reshape(-1)).to(dev),
                                       torch.randn(k, 16, generator=g, device=dev) * 0.01, n),
                       "noise": torch.rand(k, 16, generator=g, device=dev)}
                      for b in batches[1:]]
        for label, run in variants.items():
            plain = {**o, "mu": o["mu"].clone(), "nu": o["nu"].clone(),
                     "codes": dataclasses.replace(o["codes"], data=o["codes"].data.clone())}
            mine = {**plain, "mu": o["mu"].clone(), "nu": o["nu"].clone(),
                    "codes": dataclasses.replace(o["codes"], data=o["codes"].data.clone())}
            got = run(mine, bits)
            want = run_row_step(ops, plain, False, bits, use_kernel=False)
            live = o["uniq"] < n
            check(torch.equal(got[live], want[live])
                  and torch.equal(mine["mu"][:n], plain["mu"][:n])
                  and torch.equal(mine["nu"][:n], plain["nu"][:n])
                  and torch.equal(mine["codes"].data[:n], plain["codes"].data[:n]),
                  f"the {label} build differs from the plain row step: bits={bits}")
        pair = variants.get("baseline", lambda o, bits, g_sum=None: run_row_step(
            ops, {**o, "g_sum": o["g_sum"] if g_sum is None else g_sum}, False, bits))
        pair_label = "baseline" if baseline else "this g_sum form"

        def segsum_pair(o):
            return pair(o, bits, lpt.segment_sum(o["g_occ"], o["inv"], o["uniq"].numel()))

        def runs_from_ids(o):
            uniq, _, order, starts = lpt.dedup_runs(o["ids"], n)
            return run_row_step(ops, {**o, "uniq": uniq, "order": order, "starts": starts},
                                True, bits)

        # (the change, what it is timed against per call, and whether back
        # to back too: with the segment sum or the dedup in the calls
        # the host fell behind every spin of time_b2b on an H100)
        forms = {
            "g_sum form": (lambda o: run_row_step(ops, o, False, bits),
                           {v: (lambda o, r=r: r(o, bits)) for v, r in variants.items()}, True),
            "runs form": (lambda o: run_row_step(ops, o, True, bits),
                          {f"segment sum + {pair_label} kernel": segsum_pair,
                           "dedup_runs + runs form": runs_from_ids}, False),
        }
        for form, (change, others, b2b_others) in forms.items():
            per_call = in_turns(lambda f: time_ms(torch, f, 50, flush)[0], lambda: change(o),
                                {v: (lambda f=f: f(o)) for v, f in others.items()})
            b2b = in_turns(lambda fns: time_b2b(torch, fns),
                           [lambda p=p: change(p) for p in pool],
                           {v: [lambda p=p, f=f: f(p) for p in pool]
                            for v, f in others.items() if b2b_others})
            plain_ms = time_ms(torch, lambda: run_row_step(ops, o, form == "runs form", bits,
                                                           use_kernel=False), 10, flush)[0]
            b_ms, b_by = row_bound(o, distinct, form == "runs form")
            first_port = ("" if form == "runs form" else "; the first port's byte count "
                          f"{row_bound(o, distinct, False, all_slots=True)[0] * 1e3:.3f} us")
            log(f"[time] row step bits={bits}, {form}, CTR wave ({k} slots, {distinct} distinct): "
                f"per call (L2 flushed) {per_call[0][0] * 1e3:.2f}, {per_call[0][1] * 1e3:.2f} us"
                + "".join(f"; {v} {a * 1e3:.2f}, {z * 1e3:.2f}"
                          for v, (a, z) in per_call[1].items())
                + f"; back to back ({B2B_CALLS} calls over {len(pool)} waves) "
                f"{b2b[0][0] * 1e3:.2f}, {b2b[0][1] * 1e3:.2f} us"
                + "".join(f"; {v} {a * 1e3:.2f}, {z * 1e3:.2f}" for v, (a, z) in b2b[1].items())
                + f"; bound {b_ms * 1e3:.3f} us by {b_by}{first_port}; "
                f"plain {plain_ms * 1e3:.2f} us")
    # What the runs' operands cost on the card, beside the sum they replace.
    o = row_ops[8]
    ids, inv, k = o["ids"], o["inv"], o["uniq"].numel()

    def two_sorts():  # dedup_ids, then a stable sort of its inv for the runs
        _, slots = lpt.dedup_ids(ids, n)
        sorted_inv, order = torch.sort(slots.to(torch.int32), stable=True)
        return order, torch.searchsorted(
            sorted_inv, torch.arange(k + 1, dtype=torch.int32, device=dev), out_int32=True)

    parts = {"dedup_ids (torch.unique)": lambda: lpt.dedup_ids(ids, n),
             "dedup_ids + a stable sort of inv + searchsorted": two_sorts,
             "dedup_runs (one stable sort, no sync)": lambda: lpt.dedup_runs(ids, n),
             "segment_sum (zeros + index_put_)": lambda: lpt.segment_sum(o["g_occ"], inv, k)}
    check(all(torch.equal(a, b) for a, b in zip(lpt.dedup_runs(ids, n),
                                                 (*lpt.dedup_ids(ids, n), *two_sorts()))),
          "dedup_runs differs from dedup_ids and a stable sort of its inv")
    log("[time] the runs' operands at the CTR wave, per call (L2 flushed; torch.unique waits "
        "for the card inside the call, so the host's work after it is in its time): " + "; ".join(
        f"{label} {time_ms(torch, fn, 30, flush)[0] * 1e3:.2f} us" for label, fn in parts.items()))
    one_el = torch.zeros(1, device=dev)
    floor = time_ms(torch, lambda: one_el.add_(1), 30, flush)[0]
    log(f"[time] the timer's floor, a 1-element add_: {floor * 1e3:.2f} us per call, "
        f"{time_b2b(torch, [lambda: one_el.add_(1)]) * 1e3:.2f} us back to back")
    if baseline is not None:
        other = pathlib.Path(baseline).resolve().parents[4]
        check((other / "src" / "repro_torch").is_dir(), f"{other} is not a checkout")
        for key, v in host_enqueue({"baseline": other, "this checkout": ROOT}, 11,
                                   ROW_HOST_PROBE).items():
            log(f"[host] {key} (median of 11 rounds, the two processes in turns): baseline "
                f"{v['baseline']:.2f}, this checkout {v['this checkout']:.2f}")
    log(card_name())
    return 0


def time_flash(torch, flush) -> tuple[tuple, list[str]]:
    """flash_attention_fwd at SmolLM's prefill (B = 1, 9/3 heads, D = 64,
    causal) at every prompt length of the LM slice and at T = 2048, each
    beside its bound, its plain version and SDPA's one call.  Returns the
    kernels-line row (the longest prompt) and the ``[time]`` lines."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(6)
    row, notes = None, []
    h, kh, d = 9, 3, 64
    for t in (*LM_PROMPTS, 2048):
        q = torch.randn(1, t, h, d, generator=g, device="cuda")
        k = torch.randn(1, t, kh, d, generator=g, device="cuda")
        v = torch.randn(1, t, kh, d, generator=g, device="cuda")
        got = time_ms(torch, lambda: ops.flash_attention_fwd(q, k, v), 30, flush)
        plain = time_ms(torch, lambda: ops.flash_attention_fwd(q, k, v, use_kernel=False), 10,
                        flush)[0]
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 30, flush)[0]
        # 4 fp32 ops per visible (query, key) pair, head and dimension, at the
        # better of the two fp32-accurate routes (CUDA cores, 3xTF32).
        b_ms, b_by = bound_ms(4 * (2 * t * h * d + 2 * t * kh * d),
                              4 * flash_pairs(t, t, True, None) * h * d,
                              ops_per_s=max(FP32_OPS_PER_S, TF32X3_OPS_PER_S))
        notes.append(f"[time] flash_attention_fwd T=S={t} H={h} KH={kh} D={d} causal: "
                     f"{got[0] * 1e3:.2f} us (plain {plain * 1e3:.2f} us, bound "
                     f"{b_ms * 1e3:.3f} us by {b_by}, scaled_dot_product_attention "
                     f"{lib * 1e3:.2f} us); host enqueue {got[1]:.1f} us")
        if t == max(LM_PROMPTS):
            row = (*got, plain, b_ms, b_by, lib)
    return row, notes


def flash_only() -> int:
    """Build flash_attention_fwd, check it at ``FLASH_CASES`` and time it at
    every prompt length, without the rest of the smoke:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.flash_only())"``."""
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] torch.cuda.is_available() is False: needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library("flash_attention")
    log(f"[build] flash_attention in {time.perf_counter() - t0:.1f}s")
    err = {"flash_attention_fwd": 0.0}
    check_flash(torch, torch.device("cuda"), torch.Generator(device="cuda").manual_seed(0), err)
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    for line in time_flash(torch, flush_buf.zero_)[1]:
        log(line)
    flash_phases(torch, flush_buf.zero_)
    one = torch.zeros(1, device="cuda")
    log(f"[time] the timer's floor, a 1-element add_: "
        f"{time_ms(torch, lambda: one.add_(1), 30, flush_buf.zero_)[0] * 1e3:.2f} us")
    log(card_name())
    return 0


def flash_phases(torch, flush) -> None:
    """Where one flash launch spends its time: the kernel built with
    -DFLASH_PHASES stamps the SM clock in thread 0 of the block with the
    longest causal footprint; one launch each at SmolLM's longest prompt and
    at T = 2048, L2 flushed, cycles from the block's start."""
    import ctypes

    from repro_torch.kernels import _build

    lib = other_builds("flash_attention", {"phases": (_build.CSRC / "flash_attention.cu",
                                                      ("-DFLASH_PHASES",))})["phases"]
    lib.flash_phases_read.argtypes = [ctypes.c_void_p]
    h, kh, d = 9, 3, 64
    g = torch.Generator(device="cuda").manual_seed(7)
    for t in (max(LM_PROMPTS), 2048):
        q = torch.randn(1, t, h, d, generator=g, device="cuda")
        k = torch.randn(1, t, kh, d, generator=g, device="cuda")
        v = torch.randn(1, t, kh, d, generator=g, device="cuda")
        o = torch.empty_like(q)
        stamps = (ctypes.c_longlong * 64)()
        flush()
        err = lib.flash_attention_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             o.data_ptr(), 1, t, t, h, kh, d, 1, 0,
                                             1.0 / math.sqrt(d), _build.stream_of(q.device))
        torch.cuda.synchronize()
        check(err == 0 and lib.flash_phases_read(ctypes.cast(stamps, ctypes.c_void_p)) == 0,
              f"flash_phases T={t}: launch error {err}")
        at = [x - stamps[0] for x in stamps]
        tiles = []
        for js in range(8):
            landed, qk, soft, pv = at[8 + 4 * js: 12 + 4 * js]
            if landed <= 0:
                break
            prev = at[2] if js == 0 else at[11 + 4 * (js - 1)]
            tiles.append(f"{landed - prev}/{qk - landed}/{soft - qk}/{pv - soft}")
        log(f"[phases] flash_attention_fwd T=S={t}, block of the last query tile, SM cycles: "
            f"q landed {at[1]}, q split {at[2] - at[1]}; per stage wait+issue/QK/softmax/PV "
            f"{', '.join(tiles)}; loop end {at[3]}, warp groups merged {at[4] - at[3]}, "
            f"output written {at[5] - at[4]}, total {at[5]}")


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip() != "", f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def check_write_back(torch, dev, g, err: dict) -> dict:
    """Phase 2e: the dense write-back kernels and sr_round_seeded against their
    plain versions, bitwise; returns the full-table operands for timing and
    the seeded kernel's launches in its unbiasedness run."""
    from repro_torch.core import quant
    from repro_torch.core.codestore import pack_codes, unpack_codes
    from repro_torch.kernels import lpt_update as lpt_kernel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sr_round as sr_kernel

    n, d = LM_TABLE
    timing = {}
    for rows, cols in ((n, d), (37, 13), (36, 15)):
        codes = torch.randint(-128, 128, (rows, cols), generator=g, device=dev,
                              dtype=torch.int8)
        step = torch.rand(rows, generator=g, device=dev) * 0.01 + 1e-3
        new_step = step * (1 + 0.02 * torch.rand(rows, generator=g, device=dev))
        upd = torch.randn(rows, cols, generator=g, device=dev)
        noise = torch.rand(rows, cols, generator=g, device=dev)
        for wd in (0.0, 5e-8):
            for ns in (None, new_step):
                kw = dict(new_step=ns, weight_decay=wd)
                got = lpt_kernel.lpt_fused_update(codes, step, upd, noise, 3e-3, 8, **kw)
                want = ref.lpt_fused_update_ref(codes, step, upd, noise, 3e-3, 8, **kw)
                torch.cuda.synchronize()
                e = float((got.int() - want.int()).abs().max())
                err["lpt_fused_update"] = max(err["lpt_fused_update"], e)
                check(torch.equal(got, want), f"lpt_fused_update {rows}x{cols} wd={wd} "
                                              f"new_step={ns is not None}: max err {e}")
                for bits in (4, 2):
                    lo, hi = quant.code_bounds(bits)
                    small = torch.clamp(codes, lo, hi)
                    packed = pack_codes(small, bits)
                    got = lpt_kernel.lpt_fused_update_packed(packed, step, upd, noise, 3e-3,
                                                             bits, cols, **kw)
                    want = ref.lpt_fused_update_packed_ref(packed, step, upd, noise, 3e-3,
                                                           bits, cols, **kw)
                    via = pack_codes(lpt_kernel.lpt_fused_update(small, step, upd, noise, 3e-3,
                                                                 bits, **kw), bits)
                    torch.cuda.synchronize()
                    e = float((unpack_codes(got, bits, cols).int()
                               - unpack_codes(want, bits, cols).int()).abs().max())
                    err["lpt_fused_update_packed"] = max(err["lpt_fused_update_packed"], e)
                    check(torch.equal(got, want) and torch.equal(got, via),
                          f"lpt_fused_update_packed {rows}x{cols} bits={bits} wd={wd} "
                          f"new_step={ns is not None}: max err {e}")
        if rows == n:
            timing.update(codes=codes, step=step, new_step=new_step, upd=upd, noise=noise,
                          packed=pack_codes(torch.clamp(codes, -8, 7), 4))
    log(f"[check] lpt_fused_update (bits 8) and lpt_fused_update_packed (bits 4, 2) bitwise at "
        f"{n}x{d}, 37x13 and 36x15, weight decay 0 and 5e-8, with and without a new step; "
        "packed equal to pack(int8 kernel(unpack))")

    for rows, cols in ((n, d), (37, 13), (3, 5)):
        w = torch.randn(rows, cols, generator=g, device=dev) * 0.05
        step = quant.init_step_size(w, 8)
        codes = {}
        for seed in (0, -1, 12345):
            codes[seed] = sr_kernel.sr_round_seeded(w, step, seed, 8)
            want = ref.sr_round_seeded_ref(w, step, seed, 8)
            again = sr_kernel.sr_round_seeded(w, step, seed, 8)
            torch.cuda.synchronize()
            e = float((codes[seed].int() - want.int()).abs().max())
            err["sr_round_seeded"] = max(err["sr_round_seeded"], e)
            check(torch.equal(codes[seed], want) and torch.equal(codes[seed], again),
                  f"sr_round_seeded {rows}x{cols} seed={seed}: max err {e} or not repeatable")
            exact = torch.clamp(w.double() / step.double()[:, None], -128, 127)
            check(bool(((codes[seed].double() - exact).abs() < 1).all()),
                  f"sr_round_seeded {rows}x{cols} seed={seed}: a code off the lattice step")
        if rows * cols > 100:
            check(not torch.equal(codes[0], codes[-1]), f"sr_round_seeded {rows}x{cols}: seeds "
                                                        "0 and -1 give the same codes")
        if rows == n:
            timing.update(w=w, w_step=step, w_noise=quant.sr_noise(g, (rows, cols)))
    # Unbiased: over SEEDED_SWEEP seeds the mean code of each sampled element
    # lies within 5 sigma of s = clip(w / Delta) (the kernel's float32
    # quotient), sigma = sqrt(frac(s) (1 - frac(s)) / SEEDED_SWEEP) the standard
    # error of a mean of Bernoulli(frac(s)) draws, plus 2^-24 for u's grid.
    w, step = timing["w"], timing["w_step"]
    pick = torch.randperm(w.numel(), generator=g, device=dev)[:SEEDED_SAMPLES]
    ops.reset_kernel_calls()
    draws = torch.stack([ops.sr_round_seeded(w, step, seed, 8).reshape(-1)[pick]
                         for seed in range(1000, 1000 + SEEDED_SWEEP)]).double()
    sweep_launches = ops.kernel_calls().get("sr_round_seeded", 0)
    s32 = torch.clamp(w / step[:, None], -128, 127).reshape(-1)[pick].double()
    frac = s32 - torch.floor(s32)
    sigma = torch.sqrt(frac * (1 - frac) / SEEDED_SWEEP)
    dev_max = float(((draws.mean(0) - s32).abs() - 5 * sigma).max())
    check(dev_max <= 2.0 ** -24, f"sr_round_seeded biased: a sampled mean exceeds 5 sigma by "
                                 f"{dev_max}")
    check(sweep_launches == SEEDED_SWEEP, f"sr_round_seeded sweep launched {sweep_launches}")
    log(f"[check] sr_round_seeded bitwise equal to its plain version (the same Philox words) at "
        f"{n}x{d}, 37x13 and 3x5 for seeds 0, -1, 12345, repeatable, every code within one "
        f"lattice step of w/Delta; over {SEEDED_SWEEP} seeds the mean code of {SEEDED_SAMPLES} "
        "sampled elements within 5 sigma of w/Delta, sigma = sqrt(frac (1 - frac) / "
        f"{SEEDED_SWEEP})")
    timing["seeded_launches"] = sweep_launches
    return timing


def lm_batches(torch, dev, vocab: int) -> list:
    """Phase 8's training batches, made once: LMTokenStream(seed=17) as the
    training CLI draws them, tokens and next-token labels on the card."""
    from repro_torch.data.lm_synth import LMTokenStream

    stream = LMTokenStream(vocab, LM_TRAIN_SEQ, seed=17)
    out = []
    for i in range(LM_TRAIN_STEPS):
        full = torch.from_numpy(stream.batch(i, LM_TRAIN_BATCH)).to(dev)
        out.append({"tokens": full[:, :-1], "labels": full[:, 1:]})
    return out


def peak_growth(torch, dev, fn) -> int:
    """Bytes the card's allocated memory peaks above its level before ``fn()``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize()
    del out
    return torch.cuda.max_memory_allocated(dev) - base


def lm_train(torch, dev, method: str, bits: int, batches: list) -> dict:
    """Phase 8: SmolLM-135M training at full width (the main path), then its
    checks, the write-back's peak memory, the kernels-off replay and a
    profiler window."""
    from repro_torch import configs
    from repro_torch.core import alpt as alpt_core
    from repro_torch.core import lpt as lpt_core
    from repro_torch.core import quant
    from repro_torch.kernels import ops
    from repro_torch.optim import tree_leaves
    from repro_torch.training import lm_trainer

    label = f"lm-train {method} bits={bits}"
    cfg = configs.full_config(LM_ARCH, embedding_method=method, embedding_bits=bits)
    tcfg = lm_trainer.LMTrainerConfig()
    train_step = lm_trainer.make_train_step(cfg, tcfg)
    write_back = "sr_round" if method == "alpt" else (
        "lpt_fused_update_packed" if bits < 8 else "lpt_fused_update")

    ops.reset_kernel_calls()  # the main path starts here ...
    ops.reset_fallbacks()
    state = lm_trainer.init_state(cfg, tcfg, seed=20 + bits, device=dev)
    state0 = lm_trainer.clone_state(state)
    losses, wall = [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))  # the host waits for the step
        wall.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == LM_REPLAY:
            early = (lm_trainer.clone_state(state), list(losses))
    torch.cuda.synchronize()
    launches = ops.kernel_calls()  # ... and ends here
    steps = len(batches)
    want = {"sr_round": 1, "adam_update": steps}  # sr_round: the table's init
    want[write_back] = want.get(write_back, 0) + steps
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(ops.fallbacks() == [], f"{label}: fallbacks {ops.fallbacks()}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{label}: losses {losses}")
    table = state.table
    held = sum(t.numel() * t.element_size() for t in (table.codes.data, table.step, table.mu,
                                                       table.nu))
    check(held == lpt_core.memory_bytes(table, bits, count_optimizer=True)
          == EXPECTED_LM_TRAIN_BYTES[bits],
          f"{label}: training memory {held} != {EXPECTED_LM_TRAIN_BYTES[bits]}")
    ms = statistics.mean(wall[1:])
    log(f"[lm-train] {method} bits={bits}: {steps} steps of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} "
        f"tokens, loss {losses[0]:.4f} -> {losses[-1]:.4f}; host clock: first step "
        f"{wall[0]:.1f} ms, then {ms:.2f} ms/step; table training tensors {held} B; "
        f"launches {launches}")

    # The write-back's peak memory over the trained table, kernel vs plain.
    spec = lm_trainer.embedding_spec_of(cfg, tcfg)
    _, (g_table, _) = lm_trainer.make_grad_fn(cfg, tcfg)(state, batches[0])
    noise = quant.sr_noise(state.generator, tuple(table.codes.shape))
    if method == "alpt":
        w_new = alpt_core.dense_weight_update(table, g_table, cfg=spec.alpt, lr=tcfg.lr).w_new

        def write(use_kernel):
            return ops.sr_round(w_new, table.step, noise, bits, use_kernel=use_kernel)
    else:
        upd, _, _ = lpt_core._opt_direction(g_table, table.mu, table.nu, "adam",
                                            table.count + 1)

        def write(use_kernel):
            return ops.lpt_update(table.codes, table.step, upd, noise, tcfg.lr, bits,
                                  weight_decay=tcfg.emb_weight_decay, use_kernel=use_kernel)
    kernel_peak = peak_growth(torch, dev, lambda: write(True))
    plain_peak = peak_growth(torch, dev, lambda: write(False))
    check(kernel_peak < FP32_TABLE_BYTES, f"{label}: the write-back's peak grows by "
                                          f"{kernel_peak} B >= the fp32 table")
    log(f"[lm-train] {method} bits={bits}: the write-back ({write_back}) grows the peak by "
        f"{kernel_peak} B with the kernel, {plain_peak} B on the plain path (one fp32 table is "
        f"{FP32_TABLE_BYTES} B)")

    # The first LM_REPLAY steps again with the kernels off, from the copy.
    off_step = lm_trainer.make_train_step(cfg, dataclasses.replace(tcfg, use_kernels=False))
    ops.reset_kernel_calls()
    replay, replay_losses = state0, []
    for batch in batches[:LM_REPLAY]:
        replay, m = off_step(replay, batch)
        replay_losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    check(ops.kernel_calls() == {}, f"{label}: kernels-off run launched {ops.kernel_calls()}")
    ref_state, ref_losses = early
    pairs = [*zip(tree_leaves(replay.params), tree_leaves(ref_state.params)),
             *zip(replay.opt.mu + replay.opt.nu, ref_state.opt.mu + ref_state.opt.nu),
             *((getattr(replay.table, k), getattr(ref_state.table, k))
               for k in ("step", "mu", "nu")),
             (replay.table.codes.data, ref_state.table.codes.data)]
    same = replay_losses == ref_losses and all(torch.equal(a, b) for a, b in pairs)
    check(same, f"{label}: kernels-off steps 1-{LM_REPLAY} differ from kernels-on: "
                f"{replay_losses} vs {ref_losses}")
    log(f"[lm-train] {method} bits={bits}: steps 1-{LM_REPLAY} with the kernels off equal the "
        f"kernels-on run bit for bit (losses {ref_losses}; params, Adam moments, codes, Delta, "
        "row-Adam slots)")

    state, _ = train_step(state, batches[0])  # warm, outside the window
    torch.cuda.synchronize()

    def run():
        s = state
        for batch in batches[1:4]:
            s, _ = train_step(s, batch)
        torch.cuda.synchronize()

    profile_window(torch, run, 3, label)
    return {"launches": launches, "ms": ms, "first_ms": wall[0], "losses": losses}


def lm_train_cli() -> dict:
    """Phase 8b: ``python -m repro_torch.launch.train lm --arch smollm-135m
    --steps 5`` at its defaults in a subprocess; returns its launches."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "lm", "--arch",
                           LM_ARCH, "--steps", "5"], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"train lm CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    r = json.loads(lines[-1])
    launches = r["kernel_launches"]
    check(len(r["losses"]) == 5 and all(math.isfinite(x) for x in r["losses"]),
          f"train lm CLI losses {r['losses']}")
    check(launches == {"sr_round": 6, "adam_update": 5}, f"train lm CLI launches {launches}")
    check(r["fallbacks"] == [] and r["training_bytes"] == EXPECTED_LM_TRAIN_BYTES[8],
          f"train lm CLI fallbacks {r['fallbacks']}, memory {r['training_bytes']}")
    log(f"[train-cli] {lines[-2]}; launches {launches}; no fallbacks")
    return launches


def time_write_back(torch, wb: dict, flush) -> dict:
    """Phase 5 for the LM training kernels at SmolLM's table: the write-back
    at 8 and 4 bits and sr_round_seeded beside sr_round with its noise
    operand; then the training attention's forward + backward."""
    import torch.nn.functional as F

    from repro_torch.core.codestore import CodeStore
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    timings = {}
    codes, step, ns, upd, noise = (wb[k] for k in ("codes", "step", "new_step", "upd", "noise"))
    rows, cols = codes.shape
    for kernel, c, bits in (("lpt_fused_update", codes, 8),
                            ("lpt_fused_update_packed", wb["packed"], 4)):
        store = CodeStore(data=c, bits=bits, n=rows, d=cols, packed=bits < 8)

        def run(use_kernel, store=store, bits=bits):
            return ops.lpt_update(store, step, upd, noise, 3e-4, bits, new_step=ns,
                                  weight_decay=5e-8, use_kernel=use_kernel)
        # Codes in and out, upd and noise in, Delta and Delta' per row; about
        # 10 fp32 operations per element.
        nbytes = 2 * c.numel() * c.element_size() + rows * cols * 8 + rows * 8
        timings[kernel] = (*time_ms(torch, lambda: run(True), 30, flush),
                           time_ms(torch, lambda: run(False), 5, flush)[0],
                           *bound_ms(nbytes, rows * cols * 10), None)
    w, wstep, wnoise = wb["w"], wb["w_step"], wb["w_noise"]
    n_el = w.numel()
    timings["sr_round_seeded"] = (
        *time_ms(torch, lambda: ops.sr_round_seeded(w, wstep, 7, 8), 30, flush),
        time_ms(torch, lambda: ops.sr_round_seeded(w, wstep, 7, 8, use_kernel=False), 5,
                flush)[0],
        *bound_ms(n_el * 5 + rows * 4, n_el * 8, n_el * PHILOX_INT_OPS_PER_ELEMENT), None)
    noisy = time_ms(torch, lambda: ops.sr_round(w, wstep, wnoise, 8), 30, flush)
    b_ms, b_by = bound_ms(n_el * 9 + rows * 4, n_el * 8)
    log(f"[time] sr_round with its noise operand at {rows}x{cols}: {noisy[0] * 1e3:.2f} us "
        f"(bound {b_ms * 1e3:.3f} us by {b_by}); sr_round_seeded "
        f"{timings['sr_round_seeded'][0] * 1e3:.2f} us (bound "
        f"{timings['sr_round_seeded'][3] * 1e3:.3f} us by {timings['sr_round_seeded'][4]})")

    g = torch.Generator(device="cuda").manual_seed(6)
    b, t, h, kh, d = LM_TRAIN_BATCH, LM_TRAIN_SEQ, 9, 3, 64
    q = torch.randn(b, t, h, d, generator=g, device="cuda").requires_grad_(True)
    k, v = (torch.randn(b, t, kh, d, generator=g, device="cuda").requires_grad_(True)
            for _ in range(2))
    ct = torch.randn(b, t, h, d, generator=g, device="cuda")

    def train_attn():
        (L.flash_attention_train(q, k, v, q_block=512, k_block=1024) * ct).sum().backward()

    def sdpa():
        o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           v.transpose(1, 2), is_causal=True, enable_gqa=True)
        (o.transpose(1, 2) * ct).sum().backward()
    attn = time_ms(torch, train_attn, 10, flush)
    lib = time_ms(torch, sdpa, 10, flush)[0]
    log(f"[time] training attention (plain PyTorch, flash_attention_train) forward + backward "
        f"at B={b} T=S={t} H={h} KH={kh} D={d} causal: {attn[0] * 1e3:.1f} us (SDPA fp32 "
        f"forward + backward {lib * 1e3:.1f} us); host enqueue {attn[1]:.1f} us")
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
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import _build, ops, ref
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
    wave = flat[: BATCH * data_cfg.n_fields].contiguous()
    check_gathers(torch, dev, g, err, [wave, torch.cat([flat, flat[:100]])], n)

    # 2b. the row-step kernels over one training wave
    t0 = time.perf_counter()
    batches = Batches(data.batch("train", i, BATCH) for i in range(TRAIN_STEPS))
    log(f"[data] {TRAIN_STEPS} training batches of {BATCH} in {time.perf_counter() - t0:.1f}s")
    wave, g_occ, dense_params, g_dense = wave_gradients(torch, dev, batches[0])
    row_ops = check_row_update(torch, dev, g, wave, g_occ, n, err)
    adam_ops = check_adam(torch, dense_params, g_dense, err)
    del g_occ

    # 2d. the LM head and attention kernels; 2e. the LM training kernels
    check_lm_kernels(torch, dev, g, err)
    wb_ops = check_write_back(torch, dev, g, err)

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

    # 8. LM training at full width: ALPT 8, LPT 8, LPT 4 packed; 8b. its CLI
    t0 = time.perf_counter()
    lm_data = lm_batches(torch, dev, LM_TABLE[0])
    log(f"[data] {LM_TRAIN_STEPS} LM batches of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens in "
        f"{time.perf_counter() - t0:.1f}s")
    lm_trains = {run: lm_train(torch, dev, *run, lm_data) for run in LM_TRAIN_RUNS}
    trained = {k: sum(r["launches"].get(k, 0) for r in lm_trains.values()) for k in KERNELS}
    log(f"[kernels] launches on the LM training path: {trained}")
    cli = lm_train_cli()
    launches = {k: launches[k] + trained[k] + cli.get(k, 0) for k in KERNELS}
    # sr_round_seeded has no main path (no caller in the JAX package but its
    # kernel test): its launches are its unbiasedness run's (phase 2e).
    launches["sr_round_seeded"] += wb_ops["seeded_launches"]
    # The g_sum form of the row step left the main path (the runs form took
    # it over): its launches are phase 2b's.
    for kernel in ("sparse_row_update", "sparse_row_update_packed"):
        launches[kernel] += row_ops["launches"].get(kernel, 0)

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
    uniq = int(torch.unique(wave).numel())
    tables = {(domain, bits): (r["table"].codes, r["table"].step)
              for domain, by_bits in (("ctr", runs), ("lm", lm_runs))
              for bits, r in by_bits.items()}
    pools = {"CTR wave": ("ctr", [wave] + [
        torch.from_numpy(data.batch("test", i, BATCH)[0].reshape(-1)).to(dev)
        for i in range(1, GATHER_POOL)])}
    for label, b in LM_GATHER_SHAPES.items():
        pools[label] = ("lm", [torch.randint(0, LM_TABLE[0], (b,), generator=g, device=dev,
                                             dtype=torch.int32) for _ in range(GATHER_POOL)])
    gather_rows, gather_notes = time_gathers(torch, tables, pools, flush)
    timings.update(gather_rows)
    distinct = row_ops["distinct"]
    for bits in (8, 4):
        o = row_ops[bits]
        for runs in (False, True):
            kernel = ("sparse_row_update_runs" if runs else "sparse_row_update") + \
                ("_packed" if bits < 8 else "")
            timings[kernel] = (
                *time_ms(torch, lambda: run_row_step(ops, o, runs, bits), 50, flush),
                time_ms(torch, lambda: run_row_step(ops, o, runs, bits, use_kernel=False), 20,
                        flush)[0],
                *row_bound(o, distinct, runs), None)
        first_port = row_bound(o, distinct, False, all_slots=True)[0]
        log(f"[time] sparse_row_update bits={bits}: the first port's byte count (g and noise "
            f"rows and a step for all {o['uniq'].numel()} slots), {first_port * 1e3:.3f} us, "
            "for comparison with that port's times; the bound counts the live slots only")
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
    timings.update(time_write_back(torch, wb_ops, flush))
    for line in gather_notes:
        log(line)
    log(f"[time] one wave = {wave.numel()} ids ({uniq} distinct rows); L2 flushed before "
        "each gather and row-step launch; sr_round over the full table; the row step over "
        f"the full padded table at the training wave's {row_ops[8]['uniq'].numel()} slots "
        f"({distinct} distinct); "
        f"adam_update over the DCN's {len(a['params'])} tensors ({n_el} parameters)")
    for bits, r in trains.items():
        log(f"[time] training step, bits={bits}: {r['ms_per_step']:.2f} ms/step on the host "
            f"clock (steps 2-{TRAIN_STEPS}; first step {r['first_ms']:.1f} ms)")
    for (method, bits), r in lm_trains.items():
        log(f"[time] LM training, {method} bits={bits}: {r['ms']:.2f} ms/step on the host clock "
            f"(steps 2-{LM_TRAIN_STEPS}; first step {r['first_ms']:.1f} ms)")
    for bits, r in lm_runs.items():
        log(f"[time] LM serving, bits={bits}: {r['decode_ms']:.2f} ms per decode step of "
            f"{LM_BATCH} slots, prefill " + ", ".join(f"T={t}: {ms:.2f} ms" for t, ms in
                                                      r["prefill_ms"].items())
            + " on the host clock")
    card = card_name()
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
            "launches_from": LAUNCHES_FROM.get(kernel, "main path"),
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
