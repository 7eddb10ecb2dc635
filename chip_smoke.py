#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CTR serving and training (every embedding
method, DCN and DeepFM), of int8-resident LM serving, of LPT/ALPT LM
training, of checkpoints (resume, serving from a checkpoint), of the
storage tiers (hot-row cache, host-memory cold tier), of data-parallel
training (exact and SR-compressed gradient sync), of the SSM and MoE LM
families (mamba2-370m, deepseek-moe-16b), of observability (spans,
counters, latency quantiles, --trace-out), of faults and recovery (the
fault plan's seams, bounded retry, the non-finite guard), of the VLM
(qwen2-vl-7b: M-RoPE, QKV bias, the mixed input mode), of the encoder
(hubert-xlarge: frames in, the gelu MLP, non-causal attention), of remat
(deepseek-67b) and of the sharding path (tensor and sequence parallel LM
training on a (data, model) grid of ranks) on one NVIDIA GPU.

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
     the runs form bitwise at the two long-run waves of phase 9's methods:
     the qr_* remainder (ids % 2 of that wave: two rows, ~12,288 lookups
     each) and mixed's 8-bit group (82 rows; the other groups' ~21,500
     lookups one sentinel run on its scratch row);
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
  9. the rest of the paper's methods on the full Avazu table (padded), DCN,
     batches of 1,024: lsq, pact, prune (its mask refreshed at steps 3, 6
     and 9), hash, qr_lpt, qr_alpt and mixed (groups at 8, 4 and 2 bits)
     each train 10 steps kernels on, then the first 3 again kernels off from
     a copy of the initial state: bitwise equal state, dense params,
     optimizer states and losses; launches per step as the code implies, no
     fallbacks, finite losses, the bytes of every tensor of the state
     (row-Adam slots and prune's bool mask included) exactly
     memory_bytes(stored=True), prune's sparsity its scheduled ratio; each trained state
     served (4,096 requests) kernels on and off, bitwise equal, resident
     bytes exactly memory_bytes(training=False) for lsq, pact, qr_* and
     mixed; full synthetic Criteo (1,086,878 x 16, DCN depth 5 x 1000,
     dropout 0.2) ALPT-8 10 steps, 3 replayed kernels off with the same
     masks, bitwise; DeepFM on Avazu (table width d + 1 = 17) ALPT-8 5 steps,
     3 replayed, then served; a profiler window of 3 steps for each;
  2d. dequant_matmul / dequant_matmul_packed (bits 4, 2) at SmolLM's head
     (M in {1, 8}, N = 49,152, K = 576) and ragged shapes against their plain
     versions and a float64 recomputation, each logit within the fp32 error
     bound of its K-term sum; the packed head bitwise equal to the int8 head
     on the unpacked codes; flash_attention_fwd at (B, T, S, H, KH, D) =
     (1, 157, 157, 9, 3, 64), (2, 96, 96, 4, 2, 80) window 32,
     (1, 64, 64, 4, 4, 128) non-causal and (1, 2048, 2048, 9, 3, 64);
  7. serve SmolLM-135M at full width (30 layers, d=576, 9/3 heads, vocab
     49,152, ALPT table, random weights from a seed) at 8 bits, then 4 bits
     packed: 16 requests, prompts of 64/100/128/157 tokens, 16 new tokens
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
     LMTokenStream batches of 4 x 1,024 tokens) for 10 steps each: ALPT at 8
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
  10. checkpoints (repro_torch.checkpoint), in a temporary directory
     removed at the end: 10a. on the full padded Avazu table (DCN
     1024/512/256, batches of 1,024) ALPT-8, qr_alpt-4 (packed sub-tables)
     and prune (bool mask, host clock; refreshed at steps 3 and 6) train 6
     steps in one run and, from the same seed, 3 steps, a save through
     CheckpointManager, every tensor dropped and the cache emptied, a fresh
     trainer's restore and 3 more steps: every leaf of both states (codes,
     Delta, mu, nu, count, float leaves, dense params, both Adam states, the
     generator's state) and the 6 losses equal bit for bit; launches per
     step as STEP_LAUNCHES implies, none in a restore; 10b. the table's
     arrays of every saved step exactly memory_bytes(stored=True), one
     flipped byte in the newest step's leaf makes restore() fall back to the
     previous step and record the refused one; save / restore seconds and
     bytes written (host clock); 10c. serving checkpoints of the trained
     ALPT-8 and qr_alpt-4 states and of an unpadded ALPT-4 table (table
     leaves exactly memory_bytes(training=False), codes + Delta only):
     CTREngine.from_checkpoint serves phase 3's 4,096 requests bitwise equal
     to CTREngine.from_state; 10d. SmolLM-135M's ALPT-8 serving state saved
     and restored with LMEngine.from_checkpoint: 4 of phase 7's prompts x 32
     tokens equal to the engine built from the state; then the train lm CLI
     --steps 2 --ckpt-every 1 and --steps 4 as subprocesses: the second
     resumes from step 2, its losses equal phase 8b's steps 3-4.  The step
     counts (6, split at 3; 2 + 2 LM steps) are phase 10's cut: its time
     goes to the two train lm processes and the disk, not the steps;
  11. storage tiers (repro_torch.storage) on the full padded Avazu table:
     11a. ALPT-8, ALPT-4 packed, qr_alpt-4 and mixed train 10 steps of 1,024
     cache off, then with a hot-row cache of 4,096 rows per slot (below a
     wave's ~5,712 distinct ids: every wave evicts and writes back): losses
     and every leaf of the exported state bitwise the cache-off run's,
     launches as the step implies (the routed gathers and runs form only,
     no untiered one, no fallback), evictions, write-backs and hits on the
     largest slot; ALPT-8 saved both ways (the leaf files byte for byte
     equal) and the cache-on checkpoint restored into a cache-on trainer;
     11b. the trained ALPT-8 and ALPT-4 states serve phase 3's 4,096
     requests in waves of 1,024 through a hot tier of 65,536 rows
     warm-started from the training ids' counts, a cold tier (65,536 hot
     rows, a device budget one byte under the codes) and no cache:
     probabilities bitwise equal, the cold ALPT-8 device bytes exactly
     Delta + hot rows (18,761,728), prefetch hits on every wave but the
     first, an over-budget hot tier refused; the rows the cold tier copied
     to the card (only a wave's distinct uncached rows travel); host clock
     per step and wave (the first wave apart) with and without the cache,
     the policy's host time (cold_only times the cold waves part by part,
     optionally for another checkout's repro_torch); 11c. the four
     routed kernels against their plain versions at the CTR wave (half of
     its distinct rows cached), bitwise, and timed (storage_only runs the
     phase without the rest);
  12. data parallel (repro_torch.training.data_parallel over
     repro_torch.dist.collectives), in a temporary directory removed at the
     end (dp_only runs the phase without the rest): 12a. the microbatched
     CTR twin on the full padded Avazu table, a global batch of 4,096 as 4
     shards of 1,024, 5 steps each of ALPT-8 at sync 32, 8 and 4, LPT-8 at
     8, ALPT-4 packed at 2 and fp at 32, kernels on and again kernels off
     from the same seed: losses and every leaf of the state (the generator
     included) bitwise; launches exactly what the step implies (a gather per
     shard, an sr_round per gradient leaf per rank at a compressed width,
     ALPT's Delta gradient and line 5), no fallback; wire bytes per step
     against fp32; the twin's sync alone at 32, 8, 4 and 2 bits; 12b.
     make_ctr_dp_step (ALPT-8, sync 8, 4,096 a step) and make_lm_dp_step
     (SmolLM-135M at full width, ALPT-8, sync 8, phase 8's batches of 4 x
     1,024 tokens), 3 steps each through a one-rank NCCL group, bitwise
     their twins with n_shards = 1, sr_round launched on every sync leaf;
     12c. two processes on the one card over gloo (CUDA tensors), each
     holding the full ALPT-8 state, 3 steps of 2 x 1,024 at sync 8 and 32:
     every rank's state digest and losses equal the twin's with n_shards =
     2; 12d. python -m repro_torch.launch.train lm --mesh-data 1
     --dp-compress-bits 8 --steps 3 --ckpt-every 1 as a subprocess (its
     wire-bytes line), then its step 3 removed and the command again:
     resumed from step 2, step 3's loss bitwise the first run's;
  13. the SSM and MoE LM families at full width (families_only runs the
     phase without the rest, with its timings): 13a. mamba2-370m (48 mamba
     layers, d = 1,024, tied vocabulary of 50,280) served at 8 and 4 bits
     packed (16 requests, prompts of 64/100/128 tokens and one of 256, 16
     new tokens each, slot batch 8: token rows through dequant_gather, the
     tied head through dequant_matmul), launches exactly one gather and one
     head per prefill and decode step; the plain path (use_kernel=False)
     teacher-forced on the engine's tokens within the LM tolerance; then
     trained ALPT-8 and LPT-4 packed, 3 steps of 4 x 1,024 tokens each, all
     3 replayed kernels off from the same seed with equal checksums of
     every tensor of the state and equal losses, losses and gradient norms
     finite; 13b. deepseek-moe-16b at full width with 2 of its 28 layers (16
     MHA heads at D = 128, 64 routed experts top-6 and 2 shared, untied
     vocabulary of 102,400) served at 8 bits the same way (prefill attention
     through flash_attention_fwd, once per attention layer and request) and
     trained ALPT-8 for 3 steps, replayed likewise, its aux loss printed;
     each run's launches and peak memory printed;
  14. observability (repro_torch.obs; obs_only runs the phase without the
     rest), after phase 12: 14a. ALPT-8 on the full padded Avazu table, 3
     steps from copies of one initial state untraced, traced, traced,
     untraced (in turns): losses and every leaf of the checkpoint tree (the
     generator's state included) bitwise equal, exactly 3 train.step and 3
     train.writeback spans in each traced run, each
     train.step span at least the card time of its step's kernels (CUDA
     events around the step function, inside the span: the fence waited;
     slack 0.1% for the two clocks), the host ms per step traced and
     untraced printed (steps 2-3 of each run: a smoke number, not
     gated); 14b. the trained state
     serving phase 3's 4,096 requests in waves of 1,024, untraced and
     traced: probabilities bitwise equal, 4 engine.wave and 4 engine.score
     spans and 4,096 request b / e pairs, latency_us p50 <= p95 <= p99 for
     waves and requests, the registry's engine.* diff equal to
     EngineMetrics; 14c. the same requests through the cold tier (65,536
     hot rows) while traced, bitwise 14b: storage.cold.prefetch and
     storage.cold.fetch spans, the registry's prefetch_hits / demand_puts
     diff equal to the ColdStore's counts; then a cached ALPT-8 run (4,096
     rows, 10 steps, as phase 11's, which evicts dirty rows) traced:
     storage.writeback_rows equal to the cache's write-backs and to the
     spans' rows; 14d. SmolLM-135M at 8 bits (phase 7's state and prompts,
     8 new tokens each) untraced and traced: greedy tokens equal, one
     engine.prefill span per request and one engine.decode span per decode
     step; over 14a-d a launch scope equal to the registry's
     kernels.kernel_calls diff, no fallback; 14e. train ctr at full width (5
     steps) and serve lm --arch smollm-135m, in this process, with
     --trace-out: Chrome traces that load, step_time_us / latency_us and
     kernel_fallbacks 0 in the reports, the train report's launches equal
     to ops.kernel_calls() and the registry's;
  15. faults and recovery (repro_torch.faults; faults_only runs the phase
     without the rest), after phase 14: 15a. ALPT-8 on the full padded
     Avazu table, 6 steps of 1,024 from copies of one state, unguarded and
     guarded without a plan in turns: losses, every leaf, the generator and
     the launches bitwise equal, host ms per step both ways (the loss read
     each step, and back to back); guarded with trainer.nonfinite at steps
     1 and 3: each fired step leaves every leaf as before it, the generator
     where the unguarded run has it, 2 skips; alpt.delta (inf) at step 2:
     one skip, every leaf finite; the guard's snapshot bytes; 15b. phase
     3's 4,096 requests through the cold tier (65,536 hot rows) with
     codestore.corrupt, cold.fetch (2 failures) and cold.prefetch_loss on
     the staged waves 1-3: probabilities bitwise the fault-free run's and
     the uncached engine's, each seam counted once (store and registry),
     health ready; cold.fetch past its attempts raises RetryError and
     health reports no_retry_exhaustion False; 15c. 15a's steps through a
     4,096-row cache with admissions refused at waves 2 and 4 and the
     closing flush failing twice: bitwise 15a's uncached run; a hot-tier
     engine refusing 2 waves: bitwise, served_degraded 2; 15d.
     kernels.force_fallback over 15a's first 3 steps: bitwise, every forced
     dispatch counted fault-injected, launches lower by exactly those, none
     after uninstall(); 15e. train ctr preempted at step 3 (exit 75), its
     resume bitwise the uninterrupted run, then a corrupted newest step
     skipped (corrupt_checkpoints); train lm --arch smollm-135m --guard with
     trainer.nonfinite at step 1 (4 x 1,024 tokens, 3 steps): one skip, and
     in process the guarded step leaves the state as before it; serve ctr
     --deadline-ms 0.001: deadline_misses == waves;
  16. the VLM (vlm_only runs the phase without the rest, with its timings),
     after phase 13: 16a. qwen2-vl-7b at full width and depth (28 layers,
     d = 3,584, 28/4 heads at D = 128 with QKV bias, M-RoPE, an untied head
     over 152,064 rows; ~28.3 GB of fp32 params, no optimizer state) served
     at 8 and 4 bits packed with phase 13's requests: its text path, three
     equal position streams; launches exactly one gather per prefill and
     decode step and 28 flash launches per request; the plain path
     teacher-forced within the LM tolerance; peak memory and host ms per
     decode step and prefill printed; 16b. flash at 28/4 heads, D = 128,
     causal, T = 64/100/128/157/256 within FLASH_ATOL of its plain version,
     both gathers on the served 152,064 x 3,584 tables over a decode step's,
     a prefill's and a training batch's ids and sr_round over a table of
     that shape, bitwise; 16c. ALPT-8 at full width with 2 of its 28 layers
     (at 4 the kernels-off replay runs out of memory), 3 steps of 4 x 1,024
     tokens, each with a
     256-position visual prefix laid out as a 16 x 16 patch grid in M-RoPE
     positions, replayed kernels off from the same seed: equal checksums of
     every tensor of the state and equal losses; peak memory printed; 16d.
     serve lm --arch qwen2-vl-7b at full depth in a subprocess (4 requests),
     train lm --arch qwen2-vl-7b --smoke on the card and its exit 2 under
     --dp-compress-bits 8;
  17. the encoder and remat (encoder_remat_only runs the phase without the
     rest, with its timings), after phase 16: 17a. hubert-xlarge at full
     width and depth (48 layers, d = 1,280, 16/16 heads at D = 80,
     non-causal, the gelu MLP with biases, an untied 504-way head;
     944,794,880 fp32 params) trained ALPT-8 and LPT-4 packed, 3 steps each
     of 4 x 1,024 frames made as the train CLI makes them, replayed kernels
     off from the same seed: equal checksums of every tensor and equal
     losses; launches sr_round per ALPT step, lpt_fused_update_packed per
     LPT step, one adam_update per step, no fallback; peak memory and ms
     per step printed; 17b. deepseek-67b at full width (d = 8,192, 64/8
     heads at D = 128, d_ff 22,016, an untied head over 102,400 rows) with
     16 of its 95 layers served at 8 and 4 bits packed with phase 13's
     requests: one gather per prefill and decode step, 16 flash launches per
     request, the plain path teacher-forced within the LM tolerance; 17c.
     flash at 64/8 heads (g = 8), D = 128, causal, T = 64/100/128/157/256
     within FLASH_ATOL, both gathers on the served 102,400 x 8,192 tables
     and sr_round over a table of that shape, bitwise; 17d. deepseek-67b
     ALPT-8 at full width with 1 layer and remat, the step donated (params
     and Adam moments stepped in place), 3 steps of 4 x 1,024 tokens,
     replayed kernels off (bitwise), then again with remat off: losses and
     every tensor's checksum equal the remat run's; memory allocated at the
     end of the training forward with remat on and off printed; 17e. train
     lm --arch hubert-xlarge --smoke and --arch deepseek-67b --smoke on the
     card, serve lm --arch hubert-xlarge exits 0 with the reference's line;
  18. the sharding path (sharding_only runs the phase without the rest),
     after phase 17, on gloo ranks of their own processes on the one card
     (NCCL refuses two ranks on one device), each run's one-process twin
     first (the same seed, batches and noise, kernels on; its card memory
     freed before the ranks start); a rank exiting non-zero fails the run:
     each train run's per-step losses within 1e-4 of its twin's, the first
     and last layers after step 1 within rtol 1e-4 / atol 1e-6 where the
     twin's gradient is at least 1e-6 (within 2 lr elsewhere) and the same
     on every rank, codes differing on at most 0.5%; launches per rank (one
     sr_round for the init and one a step, one adam_update a step), peak
     memory per rank and host ms per step printed; one launch of two ranks
     (1 x 2), after every twin, each run 2 steps of 2 x 1,024 tokens: 18c.
     mixtral-8x7b at full width (d = 4,096, 32/8 heads, 8 experts of d_ff
     14,336 top-2, an untied head over 32,000) with 1 of 32 layers ALPT-8
     (4 experts a rank); 18e. SmolLM-135M at full width and depth, 18f.
     mamba2-370m at full width with 8 of its 48 layers, 18g.
     hubert-xlarge at 2 layers under tp_sp, 18h. SmolLM at 2 layers
     guarded with trainer.nonfinite at step 1; 18i. SmolLM-135M at full
     width with 2 of its 30 layers under each of qr_lpt-8, qr_alpt-8, hash,
     mixed, prune (refreshed over the whole table every step), lsq-8 and
     pact-8 (a replicated table's replicas equal, the grad norm within
     1e-5, codes or the float leaves as the params, prune's mask bitwise the
     refresh of the ranks' whole table and within 0.5% of the twin's); 18j.
     deepseek-moe-16b at full width with 2 of its 28 layers ALPT-8 under
     tp_ep (32 experts a rank, the all-to-all dispatch) against its
     one-process EP twin, under tp (ms only), and gloo's all-to-all at its
     64 MB send buffer; 18d. sr_round and lpt_fused_update(_packed) on each
     of two row blocks of qwen3-1.7b's table equal the one-process call's
     rows bitwise; then one launch of four gloo ranks on a 2 x 2 grid, after
     the 1 x 1 CLI and the twins: 18b / 18k. train lm --arch qwen3-1.7b
     --layers 4 --embedding-method lpt --policy fsdp_tp (d = 2,048, 16/8
     heads at D = 128, d_ff 6,144, a tied vocab of 151,936; the projections
     cut over the data axis too), 3 steps of 4 x 512, at 1 x 1 in this
     process and on the grid, whose launcher made the group: losses within
     1e-4 step for step, lpt_fused_update on every rank's rows; its
     checkpoint (written from the gathered shards) restored in this
     process and cut to each rank's coordinates equals, in every leaf, the
     live shards each rank saved and the shards each rank restores on the
     grid under tp_sp (18b) and fsdp_tp_sp (18k) (checksums); one step
     through the API under each, its loss within 1e-4 of its one-process
     twin's from that state; 18l. SmolLM-135M at full width and depth
     ALPT-8 under dp, 2 steps of 4 x 1,024 (one sequence a rank), its
     params the same on all four ranks; 18m. 18j's deepseek-moe-16b run
     under fsdp_tp_ep and tp_sp_ep with 1 of its 28 layers (32 experts a
     rank; under sp the dispatch reads the gathered sequence) against one
     twin, 18j's EP arithmetic on the 2 x 2 grid;
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
     of lpt.sparse_apply), the runs form at phase 9's two long-run waves
     beside its bound, and the training attention's forward + backward
     (plain PyTorch, no bound row); the head at mamba2-370m's table (N =
     50,280, K = 1,024) and flash at deepseek-moe-16b's prefill (16/16
     heads, D = 128, causal, T = 64, 100, 128 and 256), each beside its
     bound, its plain version and the library's call (time_families);
     flash at qwen2-vl-7b's prefill (28/4 heads, D = 128, causal, T = 64,
     100, 128, 157 and 256) beside its bound, plain version and SDPA, and
     both gathers on its 152,064 x 3,584 tables at a decode step and a
     prefill beside their bounds (time_vlm); the same at deepseek-67b's
     prefill (64/8 heads, D = 128) and 102,400 x 8,192 tables
     (time_encoder_remat).
The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  Without a GPU, or outside a checkout, it
exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import shutil
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
    # The gathers and the runs form over a table behind a hot-row cache
    # (phase 11): the row's address routed through the hot tier.  The
    # reference routes the gather in jnp around its kernel (ops.py:418) and
    # takes a jnp fallback for the row step (core/lpt.py:263).
    "dequant_gather_routed": ("src/repro_torch/kernels/csrc/dequant_gather.cu",
                              "src/repro/kernels/dequant_gather.py:42 (routed as "
                              "src/repro/kernels/ops.py:418)"),
    "dequant_gather_packed_routed": ("src/repro_torch/kernels/csrc/dequant_gather.cu",
                                     "src/repro/kernels/dequant_gather.py:78 (routed as "
                                     "src/repro/kernels/ops.py:418)"),
    "sparse_row_update_runs_routed": ("src/repro_torch/kernels/csrc/sparse_row_update.cu",
                                      "src/repro/kernels/sparse_row_update.py:71 + "
                                      "src/repro/core/lpt.py:255 (tiered: "
                                      "src/repro/core/lpt.py:263)"),
    "sparse_row_update_runs_packed_routed": (
        "src/repro_torch/kernels/csrc/sparse_row_update.cu",
        "src/repro/kernels/sparse_row_update.py:139 + src/repro/core/lpt.py:255 (tiered: "
        "src/repro/core/lpt.py:263)"),
}
# Where a kernel's launch count comes from when it has no main path.
LAUNCHES_FROM = {"sparse_row_update": "phase 2b check", "sparse_row_update_packed":
                 "phase 2b check", "sr_round_seeded": "phase 2e unbiasedness run"}
# LM serving (phase 7): SmolLM-135M at full width.
LM_ARCH = "smollm-135m"
LM_REQUESTS, LM_PROMPTS, LM_MAX_NEW, LM_BATCH, LM_MAX_LEN = 16, (64, 100, 128, 157), 16, 8, 192
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
# two chunks of 512), 10 steps per run (cut from 20 to make room for phase
# 13), the first 3 replayed kernels-off.
LM_TRAIN_RUNS = (("alpt", 8), ("lpt", 8), ("lpt", 4))
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_REPLAY = 10, 4, 1024, 3
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


def row_bound(o: dict, distinct: int, runs: bool, all_slots: bool = False,
              map_bytes: int = 0) -> tuple[float, str]:
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
    per looked-up element; ``map_bytes`` the routed form's slot reads."""
    k, m, d = o["uniq"].numel(), o["g_occ"].shape[0], o["codes"].d
    width = o["codes"].data.shape[1]
    state = (distinct + 1) * (2 * width + 4 + 16 * d)
    if not runs:
        read = k if all_slots else distinct  # slots whose g and noise rows are read
        return bound_ms(k * (4 + 4 * d) + read * 8 * d + state,
                        (k if all_slots else distinct + 1) * d * 30)
    nbytes = m * (4 * d + 8) + 4 * (k + 1) + 4 * k + state + distinct * 4 * d + k * 4 * d
    return bound_ms(nbytes + map_bytes, (distinct + 1) * d * 30 + m * d)


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
    profile_steps(torch, trainer, replay, batches, f"bits={bits}")
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


def profile_steps(torch, trainer, state, batches, label: str) -> None:
    """Three more CTR training steps (kernels on, from ``state``) under the
    profiler, after one outside it."""
    state, _ = trainer.fit(batches, steps=1, batch_size=BATCH, state=state)  # warm, outside
    torch.cuda.synchronize()

    def run():
        trainer.fit(batches, steps=3, batch_size=BATCH, state=state)
        torch.cuda.synchronize()

    profile_window(torch, run, 3, label)


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


def check_flash(torch, dev, g, err: dict, cases=None) -> None:
    """flash_attention_fwd against its plain version at ``cases`` (default
    ``FLASH_CASES``)."""
    from repro_torch.kernels import ops

    cases = FLASH_CASES if cases is None else cases
    for b, t, s, h, kh, d, causal, window in cases:
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
        f"{[c[:6] for c in cases]}; max err {err['flash_attention_fwd']:.3g}")


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


def teacher_forced(torch, engine, params, plain, cfg, prompts, done: dict, max_new: int,
                   max_len: int, label: str) -> str:
    """The plain path (``plain``, the engine's table with its kernels off,
    and ``use_kernel=False``) fed the engine's tokens: each prompt prefilled
    alone at its exact length and spliced into its own slot of one cache,
    then ``max_new - 1`` decode steps over all the requests at once.  Each
    step's logits within LM_LOGIT_ATOL of those the engine chose from, and
    the plain pick the engine's wherever its top-2 margin exceeds ten times
    that; returns the summary for the log."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.lm import splice

    dev = params["final_norm"].device
    n = len(prompts)
    worst, agree, held = 0.0, 0, 0
    with torch.inference_mode():
        cache = tfm.init_cache(cfg, n, max_len, device=dev)
        firsts = []
        for r, prompt in enumerate(prompts):
            logits, one = tfm.prefill(params, plain, torch.from_numpy(prompt).to(dev)[None], cfg,
                                      max_len, use_kernel=False)
            splice(cache, one, r)
            firsts.append(logits[0])
            del one
        ref_rows = torch.stack(firsts)
        start = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
        for i in range(max_new):
            if i:
                toks = torch.tensor([done[r][i - 1] for r in range(n)], dtype=torch.int32,
                                    device=dev)
                ref_rows, cache = tfm.decode_step(params, plain, toks, cache, start + i - 1, cfg,
                                                  use_kernel=False)
            got = torch.stack([engine.logits[r][i] for r in range(n)])
            e = float((ref_rows - got).abs().max())
            worst = max(worst, e)
            check(e <= LM_LOGIT_ATOL, f"{label}: step {i}: kernel logits differ from the plain "
                                      f"path by {e}")
            picks = torch.tensor([done[r][i] for r in range(n)], device=dev)
            same = ref_rows.argmax(-1) == picks
            top2 = torch.topk(ref_rows, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 10 * LM_LOGIT_ATOL
            check(bool(same[clear].all()), f"{label}: step {i}: the plain path picks another "
                                           "token at a clear margin")
            agree += int(same.sum())
            held += int(clear.sum())
    return (f"within {worst:.3g} of the kernel logits (tolerance {LM_LOGIT_ATOL}); greedy tokens "
            f"agree at {agree}/{n * max_new} steps, {held} of them held at a top-2 margin > "
            f"{10 * LM_LOGIT_ATOL}")


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
    summary = teacher_forced(torch, engine, state.params, plain, cfg, prompts, done,
                             LM_MAX_NEW, LM_MAX_LEN, f"lm bits={bits}")
    log(f"[lm] bits={bits}: teacher-forced plain path (use_kernel=False) {summary}")

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
            "decode_ms": decode_ms, "prefill_ms": prefill, "prompts": prompts}


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


def gather_bound(torch, store, ids, routed: bool = False) -> tuple[float, str]:
    """Least time of one gather: ids in, each distinct row's codes and Delta
    in, the fp32 rows out; one Delta multiply per element.  ``routed``: also
    each distinct id's 4-byte ``slot_of_id`` entry (the routed gather's map
    read)."""
    b, d = ids.numel(), store.d
    uniq = int(torch.unique(ids).numel())
    row_bytes = store.data.shape[1] + 4 + (4 if routed else 0)
    return bound_ms(b * 4 + uniq * row_bytes + b * d * 4, b * d)


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
    long_waves = long_run_waves(torch, dev, g, wave, n)
    check_long_runs(torch, long_waves, err)
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


def time_flash(torch, flush, heads=(9, 3, 64), lengths=(*LM_PROMPTS, 2048)
               ) -> tuple[tuple, list[str]]:
    """flash_attention_fwd at a causal prefill (B = 1; by default SmolLM's
    9/3 heads at D = 64 at every prompt length of the LM slice and at T =
    2048), each beside its bound, its plain version and SDPA's one call.
    Returns the kernels-line row (the longest prompt of phase 7, when timed)
    and the ``[time]`` lines."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(6)
    row, notes = None, []
    h, kh, d = heads
    for t in lengths:
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
    every prompt length, and at qwen2-vl-7b's prefill (28/4 heads, D = 128),
    without the rest of the smoke:
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
    for line in time_flash(torch, flush_buf.zero_, heads=VLM_HEADS, lengths=VLM_FLASH_LENGTHS)[1]:
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
    --steps 5`` at its defaults in a subprocess; returns its report."""
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
    return r


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


# Phase 9: the rest of the paper's embedding methods, Criteo with dropout
# and DeepFM, at full width.
NEW_METHODS = ("lsq", "pact", "prune", "hash", "qr_lpt", "qr_alpt", "mixed")
METHOD_STEPS, METHOD_REPLAY, DEEPFM_STEPS = 10, 3, 5
# Kernel launches of one training step, as the code implies: float leaves
# take one adam_update over the table's leaves and one over the DCN; qr_*
# gather both factors once and step each sub-table through the runs form,
# qr_alpt re-quantizes both through
# sr_round; mixed gathers and steps its 8-bit, 4-bit and 2-bit groups.
STEP_LAUNCHES = {
    **{m: {"adam_update": 2} for m in ("lsq", "pact", "prune", "hash")},
    "qr_lpt": {"dequant_gather": 2, "sparse_row_update_runs": 2, "adam_update": 1},
    "qr_alpt": {"dequant_gather": 2, "sparse_row_update_runs": 2, "sr_round": 2,
                "adam_update": 1},
    "alpt": {"dequant_gather": 1, "sparse_row_update_runs": 1, "sr_round": 1,
             "adam_update": 1},
}
# Serving launches per wave: QAT's int8 export, both QR factors (mixed: one
# gather per group).
WAVE_LAUNCHES = {"lsq": {"dequant_gather": 1}, "pact": {"dequant_gather": 1},
                 "qr_lpt": {"dequant_gather": 2}, "qr_alpt": {"dequant_gather": 2},
                 "alpt": {"dequant_gather": 1}, "prune": {}, "hash": {}}
# Phase 9's own pruning schedule: warmup 2, ratio 0.5 * (1 - 0.5^(k - 2)),
# the mask recomputed at steps 3, 6 and 9.
PHASE9_PRUNE = dict(target_sparsity=0.5, damping=0.5, damping_steps=1, warmup_steps=2,
                    update_every=3)


def mixed_launches(spec) -> tuple[dict, dict]:
    """(per training step, per serving wave) launches of mixed: a gather and
    a row step per bit-width group (the packed kernels below 8 bits; the
    full Avazu table has groups at 8, 4 and 2 bits), one adam_update."""
    from repro_torch.methods.mixed import plan_of

    step, wave = {"adam_update": 1}, {}
    for bits in plan_of(spec).group_bits:
        packed = "_packed" if bits < 8 else ""
        for d, k in ((step, "dequant_gather" + packed), (wave, "dequant_gather" + packed),
                     (step, "sparse_row_update_runs" + packed)):
            d[k] = d.get(k, 0) + 1
    return step, wave


def live_parts(state, spec) -> list:
    """The state's tensors a model can observe: each LPT sub-table's codes,
    Delta and Adam slots over its live rows (a padded table's scratch row is
    unspecified), or every tensor of a float-leaf state."""
    from repro_torch.core import hashing
    from repro_torch.core.lpt import LPTTable
    from repro_torch.methods.mixed import plan_of

    if spec.method in ("qr_lpt", "qr_alpt"):
        tables = zip((state.remainder, state.quotient),
                     hashing.qr_rows(spec.n, spec.hash_compression))
    elif spec.method == "mixed":
        tables = zip(state.subs, plan_of(spec).group_rows)
    elif isinstance(state, LPTTable):
        tables = [(state, spec.n)]
    else:
        return [v for v in state if hasattr(v, "dtype")]
    return [t[:live] for table, live in tables
            for t in (table.codes.data, table.step, table.mu, table.nu)]


def held_bytes(state) -> int:
    """The bytes every tensor of a table state holds on the device: codes,
    Delta and row-optimizer slots of every sub-table, float leaves, prune's
    bool mask."""
    if hasattr(state, "numel"):
        return state.numel() * state.element_size()
    if hasattr(state, "packed"):  # a CodeStore
        return held_bytes(state.data)
    if isinstance(state, (tuple, list)):
        return sum(held_bytes(v) for v in state)
    return 0


def scaled(per_step: dict, steps: int) -> dict:
    return {k: v * steps for k, v in per_step.items()}


def train_and_replay(torch, dev, cfg, batches, steps: int, replay: int, label: str):
    """``steps`` steps with the kernels on (counted from the first step),
    then the first ``replay`` again with the kernels off from a copy of the
    initial state (the generator's state included: the same SR noise and
    dropout masks): bitwise on the live state, the dense params and their
    optimizer states, and the losses; then a profiler window of 3 steps
    with the kernels on.  Returns (state, launches, losses, ms per step
    after the first, init launches)."""
    from repro_torch.kernels import ops
    from repro_torch.training.ctr_trainer import CTRTrainer, clone_state

    trainer = CTRTrainer(cfg, device=dev)
    ops.reset_kernel_calls()
    ops.reset_fallbacks()
    state = trainer.init_state()
    init_launches = ops.kernel_calls()
    state0 = clone_state(state)
    ops.reset_kernel_calls()
    state, history = trainer.fit(batches, steps=replay, batch_size=BATCH, state=state)
    early = clone_state(state)
    state, rest = trainer.fit(batches, steps=steps - replay, batch_size=BATCH, state=state)
    history += rest
    torch.cuda.synchronize()
    launches = ops.kernel_calls()
    losses = [h["loss"] for h in history]
    check(ops.fallbacks() == [], f"{label}: fallbacks {ops.fallbacks()}")
    check(all(math.isfinite(x) for x in losses), f"{label}: losses {losses}")

    plain_cfg = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, use_kernels=False))
    ops.reset_kernel_calls()
    again, again_hist = CTRTrainer(plain_cfg, device=dev).fit(batches, steps=replay,
                                                              batch_size=BATCH, state=state0)
    torch.cuda.synchronize()
    check(ops.kernel_calls() == {}, f"{label}: kernels-off run launched {ops.kernel_calls()}")
    pairs = list(zip(live_parts(early.emb_state, cfg.spec), live_parts(again.emb_state, cfg.spec)))
    pairs += list(zip(early.dense.parameters(), again.dense.parameters()))
    for opt_a, opt_b in ((early.dense_opt, again.dense_opt), (early.emb_opt, again.emb_opt)):
        if opt_a is not None:
            pairs += list(zip(opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu))
    same = [h["loss"] for h in again_hist] == losses[:replay] and all(
        torch.equal(a, b) for a, b in pairs)
    check(same, f"{label}: kernels-off steps 1-{replay} differ from kernels-on "
                f"({[h['loss'] for h in again_hist]} vs {losses[:replay]})")
    profile_steps(torch, trainer, again, batches, label)
    ms = statistics.mean(h["ms"] for h in history[1:])
    return state, launches, losses, ms, init_launches


def serve_both(torch, np, state, cfg, test_ids, label: str) -> tuple:
    """Serve ``test_ids`` from a trained state through CTREngine, kernels on
    and off: bitwise equal, finite probabilities.  Returns (engine metrics,
    launches)."""
    from repro_torch.serving.ctr import CTREngine, CTRRequest

    results = []
    for use_kernels in (True, False):
        c = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, use_kernels=use_kernels))
        engine = CTREngine.from_state(state, c, batch=BATCH)
        rids = [engine.submit(CTRRequest(ids=r)) for r in test_ids]
        done = engine.run()
        results.append(([done[r] for r in rids], engine.metrics()))
    (on, m), (off, m_off) = results
    probs = np.array([r["prob"] for r in on])
    check(bool(np.isfinite(probs).all() and (probs > 0).all() and (probs < 1).all()),
          f"{label}: served probabilities not finite in (0, 1)")
    check(on == off and m_off.kernel_launches == {},
          f"{label}: the kernel engine differs from the plain one")
    return m, m.kernel_launches


def methods_phase(torch, np, dev, batches, test_ids) -> dict:
    """Phase 9: each of the seven methods on the full Avazu table (padded:
    the scratch rows take the sentinel runs), DCN, batches of 1,024: 10
    steps kernels on, the first 3 again kernels off (bitwise), the launches
    per step, the bytes the state holds, prune's sparsity, then serving the trained
    state kernels on and off.  Returns this phase's launches."""
    from repro_torch import methods
    from repro_torch.core import pruning
    from repro_torch.launch import train as train_cli_mod

    args = argparse.Namespace(config="avazu", model="dcn", bits=8, scale=SCALE, seed=0)
    total = {}
    waves = -(-len(test_ids) // BATCH)
    for i, name in enumerate(NEW_METHODS):
        t0 = time.perf_counter()
        _, cfg = train_cli_mod.build(argparse.Namespace(**{**vars(args), "seed": 900 + i}), name)
        spec = dataclasses.replace(cfg.spec, pad_to_tiles=True,
                                   prune=pruning.PruneConfig(**PHASE9_PRUNE))
        cfg = dataclasses.replace(cfg, spec=spec)
        method = methods.get(name)
        state, launches, losses, ms, init = train_and_replay(
            torch, dev, cfg, batches, METHOD_STEPS, METHOD_REPLAY, name)
        per_step, per_wave = (mixed_launches(spec) if name == "mixed" else
                              (STEP_LAUNCHES[name], WAVE_LAUNCHES[name]))
        want = scaled(per_step, METHOD_STEPS)
        check(launches == want, f"{name}: launches {launches}, the code implies {want}")
        held = held_bytes(state.emb_state)
        stored_b = method.memory_bytes(state.emb_state, spec, stored=True)
        train_b = method.memory_bytes(state.emb_state, spec, training=True)
        check(held == stored_b, f"{name}: the state holds {held} B, memory_bytes(stored=True) "
                                f"{stored_b}")
        extra = ""
        if name == "prune":
            mask = state.emb_state.mask
            pruned = (mask.numel() - int(mask.sum())) / mask.numel()
            ratio = pruning.prune_ratio(spec.prune, 9)  # the last refresh: step 9
            # |w| <= the ratio-quantile: floor(ratio * (N - 1)) + 1 weights, ties aside.
            check(abs(pruned - ratio) <= 2 / mask.numel(),
                  f"prune: sparsity {pruned} != ratio {ratio}")
            extra = f"; sparsity {pruned:.6f} = prune_ratio(step 9) {ratio:.6f}"
        m, served = serve_both(torch, np, state, cfg, test_ids, name)
        want_wave = scaled(per_wave, waves)
        check(served == want_wave, f"{name}: serving launches {served}, expected {want_wave}")
        inf_b = method.memory_bytes(state.emb_state, spec, training=False)
        if name not in ("prune", "hash"):  # their export is the fp32 table
            check(m.int8_resident and m.resident_embedding_bytes == inf_b,
                  f"{name}: resident {m.resident_embedding_bytes} B != memory_bytes {inf_b}")
        log(f"[methods] {name}: {METHOD_STEPS} steps of {BATCH} on the full Avazu table "
            f"(padded), loss {losses[0]:.5f} -> {losses[-1]:.5f}, {ms:.2f} ms/step after the "
            f"first (host clock); steps 1-{METHOD_REPLAY} kernels off bitwise equal; launches "
            f"{launches} (init {init}); the state holds {held} B = memory_bytes(stored=True), "
            f"the paper's training accounting {train_b} B; served "
            f"{len(test_ids)} requests bitwise equal to the plain engine, resident "
            f"{m.resident_embedding_bytes} B (memory_bytes(training=False) {inf_b}); "
            f"launches {served}{extra}; {time.perf_counter() - t0:.1f}s")
        for launched in (init, launches, served):
            for k, v in launched.items():
                total[k] = total.get(k, 0) + v
        del state
        torch.cuda.empty_cache()
    return total


def criteo_deepfm_phase(torch, np, dev, avazu_batches, test_ids) -> dict:
    """Phase 9, continued: Criteo at full width (DCN depth 5 x 1000, dropout
    0.2) trains ALPT-8 10 steps, the first 3 again kernels off with the same
    generator state (same masks and noise), bitwise; DeepFM (table width
    d + 1 = 17, no scratch row) trains ALPT-8 on Avazu 5 steps (3 replayed)
    and is served.  Returns their launches."""
    from repro_torch.data.ctr_synth import CTRSynthetic, criteo_like
    from repro_torch.launch import train as train_cli_mod

    total = {}
    data = CTRSynthetic(criteo_like(SCALE))
    criteo_batches = Batches(data.batch("train", i, BATCH) for i in range(METHOD_STEPS))
    runs = (("criteo", "dcn", criteo_batches, METHOD_STEPS),
            ("avazu", "deepfm", avazu_batches, DEEPFM_STEPS))
    for config, model, batches, steps in runs:
        t0 = time.perf_counter()
        args = argparse.Namespace(config=config, model=model, bits=8, scale=SCALE, seed=31)
        _, cfg = train_cli_mod.build(args, "alpt")
        label = f"{config}/{model}"
        state, launches, losses, ms, init = train_and_replay(
            torch, dev, cfg, batches, steps, METHOD_REPLAY, label)
        want = scaled(STEP_LAUNCHES["alpt"], steps)
        check(launches == want, f"{label}: launches {launches}, the code implies {want}")
        line = (f"[{model}] {config} ALPT-8, {cfg.spec.n} x {cfg.spec.d}, "
                f"{type(state.dense).__name__} dropout {cfg.model_cfg.dropout}: {steps} steps of "
                f"{BATCH}, loss {losses[0]:.5f} -> {losses[-1]:.5f}, {ms:.2f} ms/step after the "
                f"first; steps 1-{METHOD_REPLAY} kernels off bitwise equal; launches {launches}")
        served = {}
        if model == "deepfm":
            m, served = serve_both(torch, np, state, cfg, test_ids, label)
            check(served == scaled(WAVE_LAUNCHES["alpt"], -(-len(test_ids) // BATCH))
                  and m.resident_embedding_bytes == cfg.spec.n * (17 + 4),
                  f"{label}: serving launches {served}, resident {m.resident_embedding_bytes}")
            line += (f"; served {len(test_ids)} requests bitwise equal to the plain engine, "
                     f"resident {m.resident_embedding_bytes} B")
        log(f"{line}; {time.perf_counter() - t0:.1f}s")
        for launched in (init, launches, served):
            for k, v in launched.items():
                total[k] = total.get(k, 0) + v
        del state
        torch.cuda.empty_cache()
    return total


# Phase 10 (checkpoints): the configs resumed bitwise, their step counts.
CKPT_RUNS = (("alpt", 8), ("qr_alpt", 4), ("prune", 8))
CKPT_STEPS, CKPT_SPLIT = 6, 3
LM_CKPT_PROMPTS = 4


def packed_names(launches: dict, bits: int) -> dict:
    """Launches of a step at ``bits``: below 8 bits the gathers and the row
    step take their packed kernels."""
    if bits >= 8:
        return dict(launches)
    return {(k + "_packed" if k in ("dequant_gather", "sparse_row_update_runs") else k): v
            for k, v in launches.items()}


def added(*counts: dict) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def same_tree(torch, a, b) -> bool:
    """Two checkpoint trees equal leaf for leaf, bit for bit (paths, dtypes,
    values; the generator's state included)."""
    from repro_torch.checkpoint import manager as ckpt

    fa, fb = ckpt.flatten(a), ckpt.flatten(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    for (_, x), (_, y) in zip(fa, fb):
        x = x.detach() if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        y = y.detach() if isinstance(y, torch.Tensor) else torch.as_tensor(y)
        if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
            return False
    return True


def step_files(directory: pathlib.Path, step: int) -> tuple[int, dict]:
    """(bytes on disk, manifest) of a saved step."""
    d = directory / f"step_{step:09d}"
    return (sum(f.stat().st_size for f in d.iterdir()),
            json.loads((d / "manifest.json").read_text()))


def leaf_bytes(manifest: dict, prefix: str) -> int:
    """Bytes of the manifest's array leaves under ``prefix`` (a table's 0-d
    counters aside)."""
    import numpy as np

    return sum(math.prod(e["shape"]) * np.dtype(e["dtype"]).itemsize
               for e in manifest["leaves"] if e["path"].startswith(prefix) and e["shape"])


def ckpt_resume(torch, dev, name: str, bits: int, batches, root: pathlib.Path, seed: int):
    """10a / 10b for one config on the full padded Avazu table: 6 steps in
    one run; in a second from the same seed, 3 steps, a save through
    CheckpointManager (cadence 3), every tensor of the state dropped and
    the cache emptied, a fresh trainer's restore, 3 more steps and the save
    at 6: both runs equal bit for bit (every leaf of the checkpoint tree:
    codes, Delta, mu, nu, count, the float leaves and prune's mask and
    clock, dense params, both Adam states, the generator's state) and their
    losses; launches per step as the code implies, none in the restore; the
    table's arrays in each saved step exactly memory_bytes(stored=True)."""
    import gc

    from repro_torch import methods
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import pruning
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli_mod
    from repro_torch.training.ctr_trainer import CTRTrainer, checkpoint_tree

    args = argparse.Namespace(config="avazu", model="dcn", bits=bits, scale=SCALE, seed=seed)
    _, cfg = train_cli_mod.build(args, name)
    spec = dataclasses.replace(cfg.spec, pad_to_tiles=True,
                               prune=pruning.PruneConfig(**PHASE9_PRUNE))
    cfg = dataclasses.replace(cfg, spec=spec)
    method = methods.get(name)
    label = f"{name}-{bits}"
    per_step = packed_names(STEP_LAUNCHES[name], bits)

    ops.reset_kernel_calls()
    ops.reset_fallbacks()
    trainer = CTRTrainer(cfg, device=dev)
    straight = trainer.init_state()
    init = ops.kernel_calls()
    straight, h_straight = trainer.fit(batches, steps=CKPT_STEPS, batch_size=BATCH, state=straight)
    torch.cuda.synchronize()
    want = added(init, scaled(per_step, CKPT_STEPS))
    check(ops.kernel_calls() == want, f"{label}: launches {ops.kernel_calls()}, the code "
                                      f"implies {want}")

    ops.reset_kernel_calls()
    manager = CheckpointManager(root / label, keep=3, save_every=CKPT_SPLIT)
    state, h1 = trainer.fit(batches, steps=CKPT_SPLIT, batch_size=BATCH)
    t0 = time.perf_counter()
    check(trainer.save(manager, state), f"{label}: no save at step {CKPT_SPLIT}")
    save_s = [time.perf_counter() - t0]
    stored = method.memory_bytes(state.emb_state, spec, stored=True)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    before = ops.kernel_calls()
    fresh = CTRTrainer(cfg, device=dev)
    t0 = time.perf_counter()
    state = fresh.restore(manager)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(ops.kernel_calls() == before, f"{label}: the restore launched a kernel")
    check(state.step == CKPT_SPLIT and state.emb_state is not None, f"{label}: restored step")
    state, h2 = fresh.fit(batches, steps=CKPT_STEPS - CKPT_SPLIT, batch_size=BATCH, state=state)
    t0 = time.perf_counter()
    check(fresh.save(manager, state), f"{label}: no save at step {CKPT_STEPS}")
    save_s.append(time.perf_counter() - t0)
    resumed = ops.kernel_calls()
    check(resumed == want, f"{label}: resumed run launched {resumed}, the code implies {want}")
    check(ops.fallbacks() == [], f"{label}: fallbacks {ops.fallbacks()}")
    losses = [h["loss"] for h in h1 + h2]
    check(losses == [h["loss"] for h in h_straight],
          f"{label}: resumed losses {losses} != {[h['loss'] for h in h_straight]}")
    check(same_tree(torch, checkpoint_tree(cfg, state), checkpoint_tree(cfg, straight)),
          f"{label}: the resumed state differs from the uninterrupted run")
    written = []
    for step in (CKPT_SPLIT, CKPT_STEPS):
        nbytes, manifest = step_files(manager.directory, step)
        emb = leaf_bytes(manifest, ".emb_state")
        check(emb == stored, f"{label} step {step}: the table's saved arrays {emb} B != "
                             f"memory_bytes(stored=True) {stored}")
        written.append(nbytes)
    log(f"[ckpt] {label}: {CKPT_STEPS} steps straight == {CKPT_SPLIT} + save + restore into a "
        f"fresh trainer + {CKPT_STEPS - CKPT_SPLIT}, bit for bit (every leaf, the generator, "
        f"losses {losses[0]:.5f} -> {losses[-1]:.5f}); launches {resumed} (init {init}), none "
        f"in the restore; the table's arrays {stored} B = memory_bytes(stored=True); save "
        f"{save_s[0]:.3f} / {save_s[1]:.3f} s for {written[0]} / {written[1]} B on disk "
        f"({save_s[0] / written[0] * 1e9:.3f} / {save_s[1] / written[1] * 1e9:.3f} s per GB), "
        f"restore {restore_s:.3f} s ({restore_s / written[0] * 1e9:.3f} s per GB; host clock)")
    return {"launches": added(want, resumed), "cfg": cfg, "state": state, "manager": manager,
            "save_s": save_s, "restore_s": restore_s, "bytes": written}


def flip_and_fall_back(torch, dev, manager) -> float:
    """10b: one byte of a leaf file of the newest step flipped: restore()
    falls back to the previous committed step and records the refused one."""
    from repro_torch.checkpoint import CheckpointManager

    leaf = manager.directory / f"step_{CKPT_STEPS:09d}" / "leaf_00000.npy"
    raw = bytearray(leaf.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    again = CheckpointManager(manager.directory)
    t0 = time.perf_counter()
    tree, manifest = again.restore(device=dev)
    elapsed = time.perf_counter() - t0
    check(manifest["step"] == CKPT_SPLIT and again.corrupt_steps == [CKPT_STEPS],
          f"corrupted step {CKPT_STEPS}: restored {manifest['step']}, refused "
          f"{again.corrupt_steps}")
    del tree
    log(f"[ckpt] a flipped byte in step {CKPT_STEPS}'s {leaf.name}: restore() refused it "
        f"(corrupt_steps {again.corrupt_steps}) and fell back to step {manifest['step']} in "
        f"{elapsed:.3f} s")
    return elapsed


def serve_from_checkpoint(torch, np, dev, cfg, state, test_ids, directory, label: str,
                          expect: int | None = None) -> dict:
    """10c: a serving checkpoint of ``state`` (params + the serving-resident
    table): its table leaves exactly memory_bytes(training=False) (and
    ``expect`` where given), codes and Delta only; CTREngine.from_checkpoint
    on the card serves ``test_ids`` bitwise equal to CTREngine.from_state.
    Returns the two engines' launches."""
    from repro_torch import methods
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.kernels import ops
    from repro_torch.serving.ctr import CTREngine, CTRRequest

    spec = cfg.spec
    t0 = time.perf_counter()
    ckpt.save_serving_checkpoint(directory, step=state.step, params=state.dense.param_tree(),
                                 table=state.emb_state, spec=spec)
    save_s = time.perf_counter() - t0
    nbytes, manifest = step_files(pathlib.Path(directory), state.step)
    table = [e for e in manifest["leaves"] if e["path"].startswith("['table']")]
    inference = methods.get(spec.method).memory_bytes(state.emb_state, spec, training=False)
    held = leaf_bytes(manifest, "['table']")
    check(held == inference and all(e["dtype"] in ("int8", "uint8") or len(e["shape"]) == 1
                                    for e in table),
          f"{label}: serving table leaves {held} B ({table}) != memory_bytes(training=False) "
          f"{inference}")
    check(expect is None or held == expect, f"{label}: serving table leaves {held} != {expect}")
    ops.reset_kernel_calls()
    results = []
    t0 = time.perf_counter()
    engine = CTREngine.from_checkpoint(directory, cfg, batch=BATCH, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for e in (CTREngine.from_state(state, cfg, batch=BATCH), engine):
        rids = [e.submit(CTRRequest(ids=r)) for r in test_ids]
        done = e.run()
        results.append([done[r] for r in rids])
    launches = ops.kernel_calls()
    check(results[0] == results[1], f"{label}: from_checkpoint scores differ from from_state")
    check(engine.resident_embedding_bytes == inference,
          f"{label}: resident {engine.resident_embedding_bytes} B != {inference}")
    log(f"[ckpt] {label}: serving checkpoint {nbytes} B on disk (table leaves {held} B = "
        f"memory_bytes(training=False), codes + Delta only) saved in {save_s:.3f} s "
        f"({save_s / nbytes * 1e9:.3f} s per GB); "
        f"CTREngine.from_checkpoint in {restore_s:.3f} s served {len(test_ids)} requests "
        f"bitwise equal to from_state; launches {launches}")
    return launches


def lm_from_checkpoint(torch, dev, lm_run: dict, directory) -> dict:
    """10d: SmolLM-135M's ALPT-8 serving state at full width saved as a
    serving checkpoint (table leaves exactly its resident bytes) and
    restored with LMEngine.from_checkpoint: 4 of phase 7's prompts, LM_MAX_NEW
    new tokens each, the same tokens as the engine built from the state."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.kernels import ops
    from repro_torch.serving.lm import LMEngine, LMRequest
    from repro_torch.training import lm_trainer

    state, cfg = lm_run["state"], lm_run["cfg"]
    spec = lm_trainer.embedding_spec_of(cfg)
    t0 = time.perf_counter()
    ckpt.save_serving_checkpoint(directory, step=0, params=state.params, table=state.table,
                                 spec=spec)
    save_s = time.perf_counter() - t0
    nbytes, manifest = step_files(pathlib.Path(directory), 0)
    held = leaf_bytes(manifest, "['table']")
    check(held == EXPECTED_LM_RESIDENT[8], f"LM serving table leaves {held} B")
    ops.reset_kernel_calls()
    t0 = time.perf_counter()
    restored = LMEngine.from_checkpoint(directory, cfg, batch=LM_BATCH, max_len=LM_MAX_LEN,
                                        device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    outs = []
    for engine in (LMEngine.from_state(state, cfg, batch=LM_BATCH, max_len=LM_MAX_LEN),
                   restored):
        for i, p in enumerate(lm_run["prompts"][:LM_CKPT_PROMPTS]):
            engine.submit(LMRequest(prompt=p, max_new=LM_MAX_NEW, rid=i))
        outs.append(engine.run())
        check(engine.metrics().kernel_launches.get("flash_attention_fwd") ==
              LM_CKPT_PROMPTS * cfg.n_layers, f"LM engine launches {engine.metrics()}")
    launches = ops.kernel_calls()
    check(outs[0] == outs[1] and all(len(t) == LM_MAX_NEW for t in outs[1].values()),
          "LMEngine.from_checkpoint gives other tokens than from_state")
    check(restored.resident_embedding_bytes == EXPECTED_LM_RESIDENT[8],
          f"restored LM resident bytes {restored.resident_embedding_bytes}")
    log(f"[ckpt] lm: serving checkpoint {nbytes} B on disk (table leaves {held} B) saved in "
        f"{save_s:.3f} s ({save_s / nbytes * 1e9:.3f} s per GB); LMEngine.from_checkpoint "
        f"in {restore_s:.3f} s: {LM_CKPT_PROMPTS} prompts x {LM_MAX_NEW} tokens equal to from_state's; launches {launches}")
    return launches


def lm_resume_cli(directory, straight_losses: list) -> dict:
    """10d: ``train lm --steps 2 --ckpt-every 1`` then ``--steps 4`` on the same
    directory, as subprocesses: the second resumes from step 2 and its
    losses continue phase 8b's uninterrupted run bit for bit; launches as
    the code implies (the resumed run inits nothing)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    reports, times = [], []
    for extra in (["--steps", "2", "--ckpt-every", "1"], ["--steps", "4"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "lm", "--arch",
                               LM_ARCH, "--ckpt-dir", str(directory), *extra],
                              capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
        times.append(time.perf_counter() - t0)
        lines = proc.stdout.strip().splitlines()
        check(proc.returncode == 0 and bool(lines),
              f"train lm {extra} exited {proc.returncode}: {proc.stderr[-2000:]}")
        reports.append((lines, json.loads(lines[-1])))
    (_, first), (lines, second) = reports
    check("[train] resumed from step 2" in lines, f"train lm --steps 4 did not resume: {lines}")
    check(first["kernel_launches"] == {"sr_round": 3, "adam_update": 2}
          and second["kernel_launches"] == {"sr_round": 2, "adam_update": 2},
          f"train lm resume launches {first['kernel_launches']}, {second['kernel_launches']}")
    losses = first["losses"] + second["losses"]
    check(losses == straight_losses[:4],
          f"train lm resumed losses {losses} != the uninterrupted run's {straight_losses[:4]}")
    log(f"[ckpt] train lm: --steps 2 --ckpt-every 1 ({times[0]:.1f} s), then --steps 4 "
        f"({times[1]:.1f} s) resumed from step 2; losses {losses} equal phase 8b's first 4")
    return added(first["kernel_launches"], second["kernel_launches"])


def checkpoint_phase(torch, np, dev, batches, test_ids, lm_run: dict,
                     lm_cli_losses: list) -> dict:
    """Phase 10, in a temporary directory removed at the end.  Returns its
    launches."""
    import tempfile

    from repro_torch.configs import dcn_ctr
    from repro_torch.kernels import ops
    from repro_torch.training.ctr_trainer import TrainerConfig, init_state

    t_phase = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        root = pathlib.Path(tmp)
        runs = {}
        for i, (name, bits) in enumerate(CKPT_RUNS):
            runs[name] = ckpt_resume(torch, dev, name, bits, batches, root, seed=700 + i)
            total = added(total, runs[name]["launches"])
            if name == "prune":
                del runs[name]["state"]
        flip_and_fall_back(torch, dev, runs["alpt"]["manager"])
        served = [(runs["alpt"]["cfg"], runs["alpt"]["state"], "alpt-8 (padded, trained)"),
                  (runs["qr_alpt"]["cfg"], runs["qr_alpt"]["state"],
                   "qr_alpt-4 (padded, trained)")]
        _, spec4, dcn = dcn_ctr.avazu_setup(method="alpt", bits=4, scale=SCALE)
        cfg4 = TrainerConfig(spec=spec4, dcn=dcn, seed=704)
        ops.reset_kernel_calls()
        state4 = init_state(cfg4, device=dev)
        total = added(total, ops.kernel_calls())
        served.append((cfg4, state4, "alpt-4 (unpadded)"))
        for i, (cfg, state, label) in enumerate(served):
            launched = serve_from_checkpoint(
                torch, np, dev, cfg, state, test_ids, root / f"serve_{i}", label,
                expect=EXPECTED_RESIDENT[4] if state is state4 else None)
            total = added(total, launched)
        del runs, served, state4
        torch.cuda.empty_cache()
        total = added(total, lm_from_checkpoint(torch, dev, lm_run, root / "lm_serve"))
        total = added(total, lm_resume_cli(root / "lm_train", lm_cli_losses))
    log(f"[ckpt] phase 10: launches {total}; {time.perf_counter() - t_phase:.1f}s; "
        f"{card_name()}")
    return total


def long_run_waves(torch, dev, g, wave, n_live: int) -> dict:
    """The two long-run shapes of the runs form: the qr_* remainder's wave
    (ids % r over the full Avazu wave, r = 2: two live rows, ~12,288 lookups
    each, on its padded 8-row table) and mixed's 8-bit group (82 live rows of
    3 fields; the other groups' ~21,500 lookups are one sentinel run on the
    scratch row of its padded 88-row table); each with its table, the
    wave's row gradients and noise.  Returns {label: operands}."""
    from repro_torch.configs import dcn_ctr
    from repro_torch.core import hashing
    from repro_torch.core.codestore import CodeStore
    from repro_torch.methods import mixed
    from repro_torch.serving.table import map_field_ids

    data_cfg, spec, _ = dcn_ctr.avazu_setup(method="mixed", bits=8, scale=SCALE)
    spec = dataclasses.replace(spec, field_cards=tuple(data_cfg.cardinalities))
    plan = mixed.plan_of(spec)
    gid, local = map_field_ids(plan.field_offsets, plan.field_group, plan.field_local, wave)
    r, _ = hashing.qr_rows(n_live)
    shapes = {"qr remainder (r = 2)": (wave % r, r),
              "mixed 8-bit group": (torch.where(gid == 0, local, plan.group_rows[0]),
                                    plan.group_rows[0])}
    out = {}
    k, d = wave.numel(), 16
    for label, (ids, live) in shapes.items():
        n = -(-(live + 1) // 8) * 8
        codes = torch.randint(-128, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
        o = row_runs(torch, ids.to(torch.int32), torch.randn(k, d, generator=g, device=dev) * 0.01,
                     live)
        o.update(codes=CodeStore.from_codes(codes, 8),
                 step=torch.rand(n, generator=g, device=dev) * 0.01 + 1e-3,
                 mu=torch.randn(n, d, generator=g, device=dev) * 1e-3,
                 nu=torch.rand(n, d, generator=g, device=dev) * 1e-5,
                 noise=torch.rand(k, d, generator=g, device=dev), live=live)
        out[label] = o
    return out


def check_long_runs(torch, long_waves: dict, err: dict) -> None:
    """The runs form at the two long-run shapes against its plain version:
    live rows and every slot with a run (the sentinel's run on the scratch
    row included) bit for bit."""
    from repro_torch.kernels import ops

    for label, o in long_waves.items():
        outs = []
        for use_kernel in (True, False):
            c = {**o, "codes": dataclasses.replace(o["codes"], data=o["codes"].data.clone()),
                 "mu": o["mu"].clone(), "nu": o["nu"].clone()}
            w_new = run_row_step(ops, c, True, 8, use_kernel=use_kernel)
            outs.append((c["codes"].data[:o["live"]], c["mu"][:o["live"]], c["nu"][:o["live"]],
                         w_new[o["starts"][1:] > o["starts"][:-1]]))
        torch.cuda.synchronize()
        e = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*outs))
        err["sparse_row_update_runs"] = max(err["sparse_row_update_runs"], e)
        check(all(torch.equal(a, b) for a, b in zip(*outs)),
              f"sparse_row_update_runs at the {label} wave: max err {e}")
        runs = o["starts"][1:] - o["starts"][:-1]
        log(f"[check] sparse_row_update_runs bitwise at the {label} wave: "
            f"{o['codes'].n} x 16 table, {int((runs > 0).sum())} runs, the longest "
            f"{int(runs.max())} lookups")


# Phase 11: storage tiers on the full padded Avazu table.
STORAGE_RUNS = (("alpt", 8), ("alpt", 4), ("qr_alpt", 4), ("mixed", 8))
STORAGE_STEPS = 10
STORAGE_CACHE_ROWS = 4_096  # per slot: below a wave's ~5,712 distinct ids
SERVE_CACHE_ROWS = 65_536
# The cold ALPT-8 engine's device bytes: Delta of the padded table (4,428,288
# x 4 B) + 65,536 hot rows of 16 B.
EXPECTED_COLD_DEVICE = 4_428_288 * 4 + SERVE_CACHE_ROWS * 16


def routed_names(launches: dict) -> dict:
    """A step's launches over tiered tables: the gathers and the runs form
    take their routed kernels."""
    return {(k + "_routed" if k.startswith(("dequant_gather", "sparse_row_update_runs")) else k): v
            for k, v in launches.items()}


def leaf_files(directory: pathlib.Path, step: int) -> dict:
    """{file name: bytes} of a saved step's leaves (the manifest aside)."""
    d = directory / f"step_{step:09d}"
    return {f.name: f.read_bytes() for f in sorted(d.iterdir()) if f.name != "manifest.json"}


def storage_train(torch, dev, name: str, bits: int, batches, root: pathlib.Path):
    """11a: one config trained STORAGE_STEPS steps cache off, then with a hot
    tier of STORAGE_CACHE_ROWS rows per slot (kernels on both times): the
    losses and every leaf of export_state bitwise the cache-off run's,
    launches as the step implies (routed kernels only under the cache),
    evictions, write-backs and hits on the largest slot; for ALPT-8 a save
    of both and a restore of the cache-on checkpoint.  Returns (cache-off
    state, cfg, launches)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli_mod
    from repro_torch.training.ctr_trainer import CTRTrainer, checkpoint_tree

    args = argparse.Namespace(config="avazu", model="dcn", bits=bits, scale=SCALE,
                              seed=1100 + bits)
    _, cfg = train_cli_mod.build(args, name)
    cfg = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, pad_to_tiles=True))
    label = f"{name}-{bits}"
    per_step = (mixed_launches(cfg.spec)[0] if name == "mixed"
                else packed_names(STEP_LAUNCHES[name], bits))
    runs, total = {}, {}
    for cache_rows in (0, STORAGE_CACHE_ROWS):
        c = dataclasses.replace(cfg, cache_rows=cache_rows)
        trainer = CTRTrainer(c, device=dev)
        ops.reset_kernel_calls()
        ops.reset_fallbacks()
        state = trainer.init_state()
        init = ops.kernel_calls()
        ops.reset_kernel_calls()
        state, hist = trainer.fit(batches, steps=STORAGE_STEPS, batch_size=BATCH, state=state)
        torch.cuda.synchronize()
        launched = ops.kernel_calls()
        want = scaled(routed_names(per_step) if cache_rows else per_step, STORAGE_STEPS)
        check(launched == want, f"{label} cache_rows={cache_rows}: launches {launched}, the "
                                f"step implies {want}")
        check(ops.fallbacks() == [], f"{label}: fallbacks {ops.fallbacks()}")
        total = added(total, init, launched)
        policy_s = sum(cache.policy_s for _, cache in trainer.caches)
        runs[cache_rows] = (trainer, state, hist, policy_s)
    (_, off, h_off, _), (tr_on, on, h_on, policy_s) = runs[0], runs[STORAGE_CACHE_ROWS]
    losses = [h["loss"] for h in h_on]
    check(losses == [h["loss"] for h in h_off],
          f"{label}: cache-on losses {losses} != cache-off {[h['loss'] for h in h_off]}")
    exported = tr_on.export_state(on)
    check(same_tree(torch, checkpoint_tree(cfg, exported), checkpoint_tree(cfg, off)),
          f"{label}: the cache-on run's exported state differs from the cache-off run")
    stats = tr_on.cache_stats()
    big = max(stats, key=lambda st: st["capacity"])
    check(big["evictions"] > 0 and big["writebacks"] > 0 and big["hits"] > 0,
          f"{label}: slot {big['name']} saw no eviction, write-back or hit: {big}")
    ms = {k: statistics.mean(h["ms"] for h in r[2][1:]) for k, r in runs.items()}
    if (name, bits) == ("alpt", 8):
        managers = {}
        for cache_rows, (trainer, state, _, _) in runs.items():
            managers[cache_rows] = CheckpointManager(root / f"storage_{cache_rows}", keep=1)
            check(trainer.save(managers[cache_rows], state, force=True), f"{label}: no save")
        files = [leaf_files(m.directory, STORAGE_STEPS) for m in managers.values()]
        check(files[0] == files[1] and len(files[0]) > 1,
              f"{label}: the cache-on checkpoint's leaf files differ from the cache-off run's")
        fresh = CTRTrainer(dataclasses.replace(cfg, cache_rows=STORAGE_CACHE_ROWS), device=dev)
        restored = fresh.restore(managers[STORAGE_CACHE_ROWS])
        check(all(st["rows_cached"] == 0 for st in fresh.cache_stats())
              and same_tree(torch, checkpoint_tree(cfg, fresh.export_state(restored)),
                            checkpoint_tree(cfg, off)),
              f"{label}: the restored cache-on checkpoint differs from the cache-off state")
        log(f"[storage] {label}: the cache-on checkpoint's {len(files[0])} leaf files equal the "
            "cache-off run's byte for byte; restored into a cache-on trainer (caches empty), "
            "its export equals the cache-off state")
    slots = ", ".join(f"{st['name']}: cap {st['capacity']}, hits {st['hits']}, misses "
                      f"{st['misses']}, evictions {st['evictions']}, write-backs "
                      f"{st['writebacks']}" for st in stats)
    log(f"[storage] {label}: {STORAGE_STEPS} steps of {BATCH} on the padded Avazu table, cache "
        f"on == cache off bit for bit (losses {losses[0]:.5f} -> {losses[-1]:.5f}, every leaf of "
        f"export_state); launches per step {routed_names(per_step)}; host clock "
        f"{ms[0]:.2f} ms/step off, {ms[STORAGE_CACHE_ROWS]:.2f} on (steps 2-{STORAGE_STEPS}); "
        f"policy {policy_s / STORAGE_STEPS * 1e3:.2f} ms/step; {slots}")
    del runs, exported, tr_on, on
    torch.cuda.empty_cache()
    return off, cfg, total


def storage_serve(torch, np, state, cfg, bits: int, test_ids, batches) -> dict:
    """11b: the trained state served three ways, phase 3's requests in waves
    of BATCH: a hot tier of SERVE_CACHE_ROWS rows warm-started from the
    training ids' counts, a cold tier (SERVE_CACHE_ROWS hot rows, a budget
    one byte under the codes) and no cache; probabilities bitwise equal,
    routed gathers only under a tier, the cold device bytes exactly Delta +
    hot rows (ALPT-8), prefetch hits >= waves - 1, an over-budget hot tier
    refused.  Returns the launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving.ctr import CTREngine, CTRRequest

    gather = "dequant_gather" + ("_packed" if bits < 8 else "")
    waves = -(-len(test_ids) // BATCH)
    freqs = np.bincount(np.concatenate([b[0].reshape(-1) for b in batches[:STORAGE_STEPS]]),
                        minlength=cfg.spec.n_padded)
    plain = CTREngine.from_state(state, cfg, batch=BATCH)
    code_bytes = plain.embedding_code_bytes
    engines = {
        "hot": CTREngine.from_state(state, cfg, batch=BATCH, cache_rows=SERVE_CACHE_ROWS),
        "cold": CTREngine.from_state(state, cfg, batch=BATCH, cache_rows=SERVE_CACHE_ROWS,
                                     cold_tier=True, device_budget_bytes=code_bytes - 1),
        "off": plain,
    }
    engines["hot"].warm_start(freqs)
    total, probs, m, wave_ms = {}, {}, {}, {}
    for label, engine in engines.items():
        rids = [engine.submit(CTRRequest(ids=r)) for r in test_ids]
        wave_ms[label] = []
        while True:  # each wave timed: a process's first wave pays one-time costs
            t0 = time.perf_counter()
            if not engine.step():
                break
            wave_ms[label].append((time.perf_counter() - t0) * 1e3)
        done = engine.run()
        torch.cuda.synchronize()
        probs[label] = [done[r]["prob"] for r in rids]
        m[label] = engine.metrics()
        want = {gather + ("_routed" if label != "off" else ""): waves}
        check(m[label].kernel_launches == want,
              f"bits={bits} {label}: serving launches {m[label].kernel_launches}, expected {want}")
        total = added(total, m[label].kernel_launches)
    check(probs["hot"] == probs["off"] and probs["cold"] == probs["off"],
          f"bits={bits}: tiered probabilities differ from the uncached engine's")
    cold = engines["cold"].cold
    cm = m["cold"]
    check(cm.resident_embedding_bytes == cold.device_bytes <= code_bytes - 1,
          f"bits={bits}: cold device bytes {cm.resident_embedding_bytes}")
    if bits == 8:
        check(cold.device_bytes == EXPECTED_COLD_DEVICE,
              f"cold ALPT-8 device bytes {cold.device_bytes} != {EXPECTED_COLD_DEVICE}")
    check(cold.prefetch_hits >= waves - 1 and cold.prefetch_hits + cold.demand_puts == waves,
          f"bits={bits}: prefetch hits {cold.prefetch_hits}, demand puts {cold.demand_puts}")
    try:
        CTREngine.from_state(state, cfg, batch=BATCH, cache_rows=SERVE_CACHE_ROWS,
                             device_budget_bytes=SERVE_CACHE_ROWS)
        refused = False
    except ValueError as exc:
        refused = "budget" in str(exc)
    check(refused, f"bits={bits}: an over-budget hot tier was not refused")
    policy_ms = {k: sum(c.policy_s for c in engines[k].policies) / waves * 1e3
                 for k in ("hot", "cold")}
    hot = ", ".join(f"{c.name} {c.hit_rate:.4f}" for c in m["hot"].caches)
    log(f"[storage] serving bits={bits}: {len(test_ids)} requests in {waves} waves of {BATCH}, "
        f"hot tier ({SERVE_CACHE_ROWS} rows, warm-started; hit rate {hot}), cold tier (hit "
        f"rate {cm.caches[0].hit_rate:.4f}; {cold.prefetch_hits} prefetch hits, "
        f"{cold.demand_puts} demand puts; {cold.copied_rows} rows copied to the card, "
        f"{cold.topup_rows} of them topped up, against {waves * BATCH * plain.n_fields} "
        f"lookups) and no cache: probabilities bitwise equal; device "
        f"bytes cold {cold.device_bytes} (Delta + hot rows; host {cold.host_bytes}), hot "
        f"{m['hot'].resident_embedding_bytes}, uncached {m['off'].resident_embedding_bytes}; "
        f"an over-budget hot tier refused; host clock per wave "
        + ", ".join(f"{k} {m[k].wall_s / m[k].steps * 1e3:.2f} ms (waves 2-{waves} "
                    f"{sum(wave_ms[k][1:]) / max(1, waves - 1):.2f}, the first "
                    f"{wave_ms[k][0]:.2f})" for k in m)
        + f"; policy per wave hot {policy_ms['hot']:.2f} ms, cold {policy_ms['cold']:.2f} ms")
    del engines
    return total


def storage_kernels(torch, wave, o: dict, row_o4: dict, n_live: int, distinct: int,
                    err: dict, flush) -> dict:
    """11c: the four routed kernels against their plain versions at the CTR
    wave, bitwise (the gathers at a serving wave over a padded Avazu-sized
    table, through the map and staged; the runs form at phase 2b's training
    wave on its full padded table, ``o`` / ``row_o4`` at bits 8 / 4), about
    half of the wave's distinct rows cached; then each timed as phase 5 times
    the untiered ones (L2 flushed), beside its bound (the map reads
    counted).  Returns the kernels-line rows."""
    from repro_torch.core.codestore import CodeStore
    from repro_torch.kernels import ops
    from repro_torch.storage.tiered import HotRowCache

    timings = {}
    n = o["codes"].n
    for bits, ro in ((8, o), (4, row_o4)):
        live = ro["uniq"] < n_live
        packed = "_packed" if bits < 8 else ""
        base = ro["codes"]

        def tiered_copy(ids):
            cache = HotRowCache(STORAGE_CACHE_ROWS, n)
            t = cache.wrap(dataclasses.replace(base, data=base.data.clone()))
            uniq = torch.unique(ids)
            return cache.observe_apply(t, uniq[uniq < n_live][::2].cpu().numpy())

        # The gathers: a serving wave over the table, through the map and staged.
        kernel = "dequant_gather" + packed + "_routed"
        t = tiered_copy(wave)
        step = ro["step"]
        slot = t.slot_of_id[wave.long()]
        miss = slot < 0  # staged as the cold tier stages: the distinct uncached rows
        need, inv = torch.unique(wave[miss], return_inverse=True)
        slot[miss] = (-1 - inv).to(torch.int32)
        staged = (t.backing.data[need.long()].contiguous(), t.hot.data, slot, step, wave)
        kw = dict(bits=t.bits, d=t.d, packed=t.packed)
        got = [ops.dequant_gather(t, step, wave), ops.dequant_gather_staged(*staged, **kw)]
        want = [ops.dequant_gather(t, step, wave, use_kernel=False),
                ops.dequant_gather_staged(*staged, **kw, use_kernel=False),
                ops.dequant_gather(base, step, wave)]
        torch.cuda.synchronize()
        e = max(float((a - b).abs().max()) for a, b in zip(got, want))
        err[kernel] = max(err[kernel], e)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and torch.equal(got[0], want[2]),
              f"{kernel} at the CTR wave: max err {e} (against the untiered gather: "
              f"{torch.equal(got[0], want[2])})")
        cached = int((slot >= 0).sum())
        b_ms, b_by = gather_bound(torch, base, wave, routed=True)
        timings[kernel] = (*time_ms(torch, lambda: ops.dequant_gather(t, step, wave), 50, flush),
                           time_ms(torch, lambda: ops.dequant_gather(t, step, wave,
                                                                     use_kernel=False),
                                   20, flush)[0], b_ms, b_by, None)
        staged_ms = time_ms(torch, lambda: ops.dequant_gather_staged(*staged, **kw), 50, flush)[0]
        flat_ms = time_ms(torch, lambda: ops.dequant_gather(base, step, wave), 50, flush)[0]
        log(f"[check] {kernel} bitwise at the CTR wave ({wave.numel()} ids, {cached} lookups "
            f"cached) through the map and staged, and equal to the untiered gather; per call (L2 "
            f"flushed) the map route {timings[kernel][0] * 1e3:.2f} us, the staged route "
            f"{staged_ms * 1e3:.2f} us, the untiered gather {flat_ms * 1e3:.2f} us; "
            f"{card_name()}")
        del t, staged

        # The runs form: phase 2b's training wave, half of its distinct rows cached.
        kernel = "sparse_row_update_runs" + packed + "_routed"
        outs = []
        for use_kernel in (True, False):
            t = tiered_copy(ro["ids"])
            mu, nu = ro["mu"].clone(), ro["nu"].clone()
            w = ops.sparse_row_update_runs(t, ro["step"], mu, nu, ro["uniq"], ro["g_occ"],
                                           ro["order"], ro["starts"], ro["noise"], 1e-3, 0.1,
                                           0.001, bits, weight_decay=5e-8, use_kernel=use_kernel)
            outs.append((t.backing.data[:n_live], t.hot.data, mu[:n_live], nu[:n_live],
                         w[live]))
        torch.cuda.synchronize()
        e = max(float((a.float() - b.float()).abs().max()) for a, b in zip(*outs))
        err[kernel] = max(err[kernel], e)
        check(all(torch.equal(a, b) for a, b in zip(*outs)),
              f"{kernel} at the training wave: max err {e}")
        del outs, mu, nu
        t = tiered_copy(ro["ids"])
        cached = int((t.slots_for(ro["uniq"][live]) >= 0).sum())
        tmp = {**ro, "codes": t}

        def step_fn(use_kernel=True):
            return ops.sparse_row_update_runs(t, tmp["step"], tmp["mu"], tmp["nu"], tmp["uniq"],
                                              tmp["g_occ"], tmp["order"], tmp["starts"],
                                              tmp["noise"], 1e-3, 0.1, 0.001, bits,
                                              weight_decay=5e-8, use_kernel=use_kernel)
        bound = row_bound({**ro}, distinct, True, map_bytes=distinct * 4)
        timings[kernel] = (*time_ms(torch, step_fn, 50, flush),
                           time_ms(torch, lambda: step_fn(False), 20, flush)[0], *bound, None)
        flat_ms = time_ms(torch, lambda: run_row_step(ops, ro, True, bits), 50, flush)[0]
        log(f"[check] {kernel} bitwise at the training wave ({ro['uniq'].numel()} slots, "
            f"{distinct} distinct, {cached} of them cached) on the full padded table: both tiers, "
            f"mu, nu and w_new; per call (L2 flushed) {timings[kernel][0] * 1e3:.2f} us, the "
            f"untiered runs form {flat_ms * 1e3:.2f} us; {card_name()}")
        del t, tmp
        torch.cuda.empty_cache()
    return timings


def storage_phase(torch, np, dev, batches, test_ids, wave, row_ops: dict, n_live: int,
                  err: dict, flush) -> tuple[dict, dict]:
    """Phase 11, in a temporary directory removed at the end.  Returns (its
    launches, the routed kernels' timings)."""
    import tempfile

    t_phase = time.perf_counter()
    total, states = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_storage_") as tmp:
        for name, bits in STORAGE_RUNS:
            state, cfg, launched = storage_train(torch, dev, name, bits, batches,
                                                 pathlib.Path(tmp))
            total = added(total, launched)
            if name == "alpt":
                states[bits] = (state, cfg)
            del state
    for bits, (state, cfg) in states.items():
        total = added(total, storage_serve(torch, np, state, cfg, bits, test_ids, batches))
    del states
    torch.cuda.empty_cache()
    timings = storage_kernels(torch, wave, row_ops[8], row_ops[4], n_live, row_ops["distinct"],
                              err, flush)
    log(f"[storage] phase 11: launches {total}; {time.perf_counter() - t_phase:.1f}s; "
        f"{card_name()}")
    return total, timings


def storage_only() -> int:
    """Phase 11 alone, with what it takes of phase 2b (one training wave's
    row-step operands, checked), then the routed kernels' rows:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.storage_only())"``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = device_mod.resolve("cuda")
    for lib in _build.build():
        _build.library(lib)
    data_cfg = avazu_like(SCALE)
    n = data_cfg.n_features
    data = CTRSynthetic(data_cfg)
    ids, _ = data.batch("test", 0, REQUESTS)
    batches = Batches(data.batch("train", i, BATCH) for i in range(STORAGE_STEPS))
    g = torch.Generator(device=dev).manual_seed(0)
    wave, g_occ, _, _ = wave_gradients(torch, dev, batches[0])
    err = {k: 0.0 for k in KERNELS}
    row_ops = check_row_update(torch, dev, g, wave, g_occ, n, err)
    del g_occ
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    launches, timings = storage_phase(torch, np, dev, batches, ids, wave, row_ops, n, err,
                                      flush_buf.zero_)
    for kernel, (ms, host_us, plain_ms, b_ms, b_by, _) in timings.items():
        log(f"[time] {kernel}: {ms * 1e3:.2f} us on the card (plain {plain_ms * 1e3:.2f} us, "
            f"bound {b_ms * 1e3:.3f} us by {b_by}); host enqueue {host_us:.1f} us per call; "
            f"max abs err {err[kernel]}; launches {launches.get(kernel, 0)}; {card_name()}")
    log(f"[chip_smoke] phase 11 alone in {time.perf_counter() - t_start:.1f}s")
    return 0


def cold_only(root: str | None = None, reps: int = 5) -> int:
    """The cold tier's serving waves on the host clock, part by part: a
    fresh ALPT init on the padded full Avazu table (8 and 4 bits), phase 3's
    requests in waves of BATCH through a SERVE_CACHE_ROWS-row cold tier,
    ``reps`` engines each (the first pays the process's one-time costs and
    is left out of the medians).  ``root``: another checkout whose
    ``repro_torch`` is timed instead (e.g. a parent unpacked under build/),
    so that two designs run in turns, a process each:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.cold_only('build/parent'))"``."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    tree = pathlib.Path(root).resolve() if root else ROOT
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import _build
    from repro_torch.launch import train as train_cli_mod
    from repro_torch.serving.ctr import CTREngine, CTRRequest
    from repro_torch.storage import cold as cold_mod
    from repro_torch.training.ctr_trainer import CTRTrainer

    for lib in _build.build():
        _build.library(lib)
    dev = torch.device("cuda")
    ids, _ = CTRSynthetic(avazu_like(SCALE)).batch("test", 0, REQUESTS)
    parts: dict = {}

    def timed(name, fn):
        def wrap(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                parts.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return wrap

    for name in ("admit", "rows", "stage"):
        setattr(cold_mod.ColdStore, name, timed(name, getattr(cold_mod.ColdStore, name)))
    summary: dict = {}
    for bits in (8, 4):
        args = argparse.Namespace(config="avazu", model="dcn", bits=bits, scale=SCALE,
                                  seed=1100 + bits)
        _, cfg = train_cli_mod.build(args, "alpt")
        cfg = dataclasses.replace(cfg, spec=dataclasses.replace(cfg.spec, pad_to_tiles=True))
        state = CTRTrainer(cfg, device=dev).init_state()
        budget = CTREngine.from_state(state, cfg, batch=BATCH).embedding_code_bytes - 1
        for rep in range(reps):
            eng = CTREngine.from_state(state, cfg, batch=BATCH, cache_rows=SERVE_CACHE_ROWS,
                                       cold_tier=True, device_budget_bytes=budget)
            for r in ids:
                eng.submit(CTRRequest(ids=r))
            parts.clear()
            waves = []
            while True:
                t0 = time.perf_counter()
                if not eng.step():
                    break
                waves.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            cold = eng.cold
            policy = cold.cache.policy_s * 1e3
            copied = getattr(cold, "copied_rows", None)
            log(f"[cold] {tree.name} bits={bits} engine {rep}: waves ms "
                + " ".join(f"{w:.2f}" for w in waves) + "; "
                + "; ".join(f"{k} " + " ".join(f"{v:.2f}" for v in vs) for k, vs in parts.items())
                + f"; policy {policy:.2f} ms in all; rows copied {copied}")
            if rep:
                got = summary.setdefault(bits, {"first wave": [], "waves 2+": [], "stage": [],
                                                "rows": [], "admit": [], "policy": []})
                got["first wave"].append(waves[0])
                got["waves 2+"] += waves[1:]
                got["policy"].append(policy / len(waves))
                for k in ("stage", "rows", "admit"):
                    got[k] += parts[k]
            del eng
        del state
    for bits, got in summary.items():
        log(f"[cold] {tree.name} bits={bits}: medians over engines 1-{reps - 1} (ms): "
            + ", ".join(f"{k} {statistics.median(v):.2f}" for k, v in got.items())
            + f"; {card_name()}")
    return 0


# Phase 12: data parallel (training/data_parallel.py, dist/collectives.py).
# (method, table bits, sync bits) of the microbatched twins at full width.
DP_RUNS = (("alpt", 8, 32), ("alpt", 8, 8), ("alpt", 8, 4), ("lpt", 8, 8), ("alpt", 4, 2),
           ("fp", 8, 32))
DP_SHARDS, DP_STEPS = 4, 5  # a global batch of 4 x BATCH = 4,096, 5 steps a run
DP_NCCL_STEPS = 3  # 12b: the DP step through a one-rank NCCL group, CTR and LM
DP_RANKS, DP_RANK_STEPS, DP_RANK_SYNC = 2, 3, (8, 32)  # 12c: gloo ranks on the card
DP_SYNC_TIMING = (32, 8, 4, 2)
DP_CLI_STEPS = 3


def dp_trainer(dev, method: str, bits: int, sync: int, *, use_kernels: bool = True):
    """A CTR trainer on the full Avazu table (padded for integer tables) with
    the sync width ``sync``; every rank and twin of phase 12 builds this one."""
    from repro_torch.configs import dcn_ctr
    from repro_torch.training.ctr_trainer import CTRTrainer, TrainerConfig

    _, spec, dcn = dcn_ctr.avazu_setup(method=method, bits=bits, scale=SCALE)
    spec = dataclasses.replace(spec, pad_to_tiles=spec.is_integer_table, use_kernels=use_kernels)
    cfg = TrainerConfig(spec=spec, dcn=dcn, seed=1200 + bits, dp_sync_bits=sync)
    return CTRTrainer(cfg, device=dev), cfg


def dp_launches(method: str, bits: int, sync: int, leaves: int, ranks: int, steps: int,
                init: bool = True) -> dict:
    """Launches of ``steps`` data-parallel CTR steps over ``ranks`` shards
    (all of them, as the one-process twin launches them): a gather per shard
    (integer tables), an ``sr_round`` per gradient leaf per rank at a
    compressed width, and for ALPT the Delta gradient's (one leaf) and line
    5's; the dense Adam, and for fp the table's; LPT's write-back."""
    gather = "dequant_gather_packed" if bits < 8 else "dequant_gather"
    compressed = sync < 32
    per_step_sr = (leaves * ranks if compressed else 0) + (
        (ranks if compressed else 0) + 1 if method == "alpt" else 0)
    want = {"adam_update": steps * (2 if method == "fp" else 1)}
    if method != "fp":
        want[gather] = ranks * steps
    sr = (1 if init and method != "fp" else 0) + steps * per_step_sr
    if sr:
        want["sr_round"] = sr
    if method == "lpt":
        want["lpt_fused_update"] = steps
    return want


def tree_digest(torch, tree) -> str:
    """sha256 over a checkpoint tree's paths, dtypes and bytes."""
    import hashlib

    from repro_torch.checkpoint import manager as ckpt

    h = hashlib.sha256()
    for path, leaf in ckpt.flatten(tree):
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        h.update(f"{path}:{t.dtype}".encode())
        h.update(t.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def sync_ms(torch, sync, leaves, step: int, stacked: bool, reps: int = 5) -> float:
    """Host ms of one gradient sync (``GradSync.tree``), the card synchronised:
    the median of ``reps`` after a warm-up."""
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sync.tree(leaves, step, stacked=stacked)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        del out
    return statistics.median(times[1:])


def ctr_shard_grads(torch, trainer, state, ids, labels, shards: int) -> list:
    """The per-shard gradient leaves of one step (the leaves a sync takes)."""
    from repro_torch.training import data_parallel as dpm

    grad_fn = trainer.build_grad_fn()
    ids, labels = trainer._batch(ids, labels)
    leaves_of = dpm.CTRGradLeaves(state.dense)
    return [leaves_of.flat(grad_fn(state, i, y)[1])
            for i, y in zip(ids.chunk(shards), labels.chunk(shards))]


def dp_twins(torch, dev, batches) -> dict:
    """12a: the microbatched CTR twin at full width (4 shards of BATCH): each
    DP_RUNS config DP_STEPS steps kernels on, then again kernels off from the
    same seed: the losses and every leaf of the state (codes, Delta, row-Adam
    slots, dense params, both Adam states, the generator) bitwise; launches
    exactly ``dp_launches`` (every sync leaf through sr_round), no fallback.
    Then the sync alone at every width.  Returns the kernels-on launches."""
    from repro_torch.kernels import ops
    from repro_torch.training import ctr_trainer
    from repro_torch.training import data_parallel as dpm

    total = {}
    for method, bits, sync in DP_RUNS:
        label = f"dp-twin {method}-{bits} sync={sync}"
        runs = {}
        for use_kernels in (True, False):
            trainer, cfg = dp_trainer(dev, method, bits, sync, use_kernels=use_kernels)
            step = dpm.make_ctr_microbatch_step(
                trainer, DP_SHARDS, dpm.DPConfig(sync_bits=sync, use_kernels=use_kernels))
            ops.reset_kernel_calls()  # the main path (kernels on) starts here ...
            ops.reset_fallbacks()
            state = trainer.init_state()
            losses, wall = [], []
            for ids, labels in batches[:DP_STEPS]:
                t0 = time.perf_counter()
                state, m = step(state, ids, labels)
                losses.append(float(m["loss"]))  # the host waits for the step
                wall.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            runs[use_kernels] = dict(tree=ctr_trainer.checkpoint_tree(cfg, state),
                                     losses=losses, wall=wall, launches=ops.kernel_calls(),
                                     fallbacks=ops.fallbacks(), trainer=trainer, state=state)
        on, off = runs[True], runs[False]
        shapes = dpm.ctr_grad_shapes(on["trainer"], on["state"])
        want = dp_launches(method, bits, sync, len(shapes), DP_SHARDS, DP_STEPS)
        check(on["launches"] == want, f"{label}: launches {on['launches']}, expected {want}")
        check(on["fallbacks"] == [], f"{label}: fallbacks {on['fallbacks']}")
        check(off["launches"] == {}, f"{label}: the kernels-off run launched {off['launches']}")
        check(all(math.isfinite(x) for x in on["losses"]), f"{label}: losses {on['losses']}")
        check(on["losses"] == off["losses"] and same_tree(torch, on["tree"], off["tree"]),
              f"{label}: kernels on and off differ: {on['losses']} vs {off['losses']}")
        wire = dpm.wire_report(shapes, sync)
        log(f"[dp] 12a {label}: {DP_STEPS} steps of {DP_SHARDS} x {BATCH} on the full table, "
            f"kernels on == off bitwise (losses {on['losses'][0]:.6f} -> {on['losses'][-1]:.6f}, "
            f"every leaf); wire {wire['wire_bytes_per_step']} B/step per rank against "
            f"{wire['fp32_wire_bytes_per_step']} at fp32 ({wire['compression_ratio']:.2f}x); "
            f"host clock {statistics.mean(on['wall'][1:]):.2f} ms/step (first "
            f"{on['wall'][0]:.1f}); launches {on['launches']}")
        total = added(total, on["launches"])
        del runs, on, off
        torch.cuda.empty_cache()

    # The sync alone at every width (the twin's, 4 ranks in one process).
    trainer, _ = dp_trainer(dev, "alpt", 8, 32)
    state = trainer.init_state()
    per_leaf = list(zip(*ctr_shard_grads(torch, trainer, state, *batches[0], DP_SHARDS)))
    stacks = [list(x) for x in per_leaf]
    times = {bits: sync_ms(torch, dpm.GradSync(dpm.DPConfig(sync_bits=bits)), stacks, 0, True)
             for bits in DP_SYNC_TIMING}
    log(f"[dp] 12a the twin's sync of one ALPT-8 step ({DP_SHARDS} ranks' gradients, "
        f"{len(stacks)} leaves, the table's {list(stacks[0][0].shape)}), host clock: " + ", ".join(
            f"{b} bits {ms:.2f} ms" for b, ms in times.items()) + f"; {card_name()}")
    del per_leaf, stacks, state, trainer
    torch.cuda.empty_cache()
    return total


def dp_nccl(torch, dev, batches, lm_data) -> tuple[dict, dict]:
    """12b: ``make_ctr_dp_step`` (ALPT-8, sync 8, a global batch of
    DP_SHARDS x BATCH) and ``make_lm_dp_step`` (SmolLM-135M at full width,
    ALPT-8, sync 8, phase 8's batches of 4 x 1,024 tokens) through a one-rank
    NCCL group, DP_NCCL_STEPS steps each, bitwise their twins with
    ``n_shards = 1``; ``sr_round`` launched once per sync leaf.  Returns the
    DP steps' launches and what 12d checks against (the LM's leaf count)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.training import ctr_trainer, lm_trainer
    from repro_torch.training import data_parallel as dpm

    total = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        trainer, cfg = dp_trainer(dev, "alpt", 8, 8)
        trees = {}
        for name in ("dp", "twin"):
            step = (dpm.make_ctr_dp_step(trainer) if name == "dp"
                    else dpm.make_ctr_microbatch_step(trainer, 1))
            ops.reset_kernel_calls()
            ops.reset_fallbacks()
            state = trainer.init_state()
            losses = []
            for ids, labels in batches[:DP_NCCL_STEPS]:
                state, m = step(state, ids, labels)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            trees[name] = (ctr_trainer.checkpoint_tree(cfg, state), losses, ops.kernel_calls(),
                           ops.fallbacks())
        leaves = len(dpm.ctr_grad_shapes(trainer, state))
        want = dp_launches("alpt", 8, 8, leaves, 1, DP_NCCL_STEPS)
        (tree, losses, launched, fallbacks), (t_tree, t_losses, _, _) = trees["dp"], trees["twin"]
        check(launched == want and fallbacks == [],
              f"12b CTR DP step launches {launched} (expected {want}), fallbacks {fallbacks}")
        check(losses == t_losses and same_tree(torch, tree, t_tree),
              f"12b CTR DP step over NCCL differs from its twin: {losses} vs {t_losses}")
        total = added(total, launched)
        grads = ctr_shard_grads(torch, trainer, state, *batches[0], 1)[0]
        times = {bits: sync_ms(torch, dpm.GradSync(dpm.DPConfig(sync_bits=bits)), grads, 0,
                               False) for bits in DP_SYNC_TIMING}
        log(f"[dp] 12b CTR ALPT-8 sync=8 through a one-rank NCCL group: {DP_NCCL_STEPS} steps "
            f"of {DP_SHARDS * BATCH}, bitwise its twin (losses {losses}); sr_round "
            f"{launched.get('sr_round')} = 1 init + {DP_NCCL_STEPS} x ({leaves} leaves + Delta + "
            "line 5); the one-rank sync alone, host clock: " + ", ".join(
                f"{b} bits {ms:.2f} ms" for b, ms in times.items()))
        del trees, tree, t_tree, state, grads
        torch.cuda.empty_cache()

        lm_cfg = configs.full_config(LM_ARCH, embedding_method="alpt", embedding_bits=8)
        tcfg = lm_trainer.LMTrainerConfig(dp_sync_bits=8)
        runs = {}
        for name in ("dp", "twin"):
            step = (dpm.make_lm_dp_step(lm_cfg, tcfg) if name == "dp"
                    else dpm.make_lm_microbatch_step(lm_cfg, tcfg, 1))
            ops.reset_kernel_calls()
            ops.reset_fallbacks()
            state = lm_trainer.init_state(lm_cfg, tcfg, seed=31, device=dev)
            losses, wall = [], []
            for batch in lm_data[:DP_NCCL_STEPS]:
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                wall.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            runs[name] = (lm_trainer.checkpoint_tree(lm_cfg, state, tcfg), losses,
                          ops.kernel_calls(), ops.fallbacks(), wall)
        lm_leaves = len(dpm.lm_grad_shapes(lm_cfg, tcfg, state))
        (tree, losses, launched, fallbacks, wall), (t_tree, t_losses, _, _, _) = (
            runs["dp"], runs["twin"])
        want = {"sr_round": 1 + DP_NCCL_STEPS * (lm_leaves + 2), "adam_update": DP_NCCL_STEPS}
        check(launched == want and fallbacks == [],
              f"12b LM DP step launches {launched} (expected {want}), fallbacks {fallbacks}")
        check(losses == t_losses and same_tree(torch, tree, t_tree),
              f"12b LM DP step over NCCL differs from its twin: {losses} vs {t_losses}")
        wire = dpm.wire_report(dpm.lm_grad_shapes(lm_cfg, tcfg, state), 8)
        log(f"[dp] 12b SmolLM-135M ALPT-8 sync=8 through a one-rank NCCL group: "
            f"{DP_NCCL_STEPS} steps of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, bitwise its "
            f"twin (losses {losses}); {lm_leaves} gradient leaves; wire "
            f"{wire['wire_bytes_per_step']} B/step ({wire['compression_ratio']:.2f}x vs fp32); "
            f"host clock {statistics.mean(wall[1:]):.1f} ms/step; launches {launched}")
        total = added(total, launched)
        del runs, tree, t_tree, state
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total, {"lm_leaves": lm_leaves, "lm_wire": wire}


def dp_rank(rank: int, world: int, directory: str) -> int:
    """One gloo rank of 12c (a process of its own, on the one card): the CTR
    DP step at full width (ALPT-8, DP_RANK_STEPS steps of a global batch of
    ``world`` x BATCH) at each DP_RANK_SYNC width; writes its state's digest,
    losses, host times, launches and the sync's time to
    ``directory/rank<r>.json``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import ops
    from repro_torch.training import ctr_trainer
    from repro_torch.training import data_parallel as dpm

    dev = device_mod.resolve("cuda")
    dist.init_process_group("gloo", init_method=f"file://{directory}/init", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        data = CTRSynthetic(avazu_like(SCALE))
        batches = [data.batch("train", i, world * BATCH) for i in range(DP_RANK_STEPS)]
        out = {}
        for sync in DP_RANK_SYNC:
            trainer, cfg = dp_trainer(dev, "alpt", 8, sync)
            step = dpm.make_ctr_dp_step(trainer)
            ops.reset_kernel_calls()
            ops.reset_fallbacks()
            state = trainer.init_state()
            losses, wall = [], []
            for ids, labels in batches:
                t0 = time.perf_counter()
                state, m = step(state, ids, labels)
                losses.append(float(m["loss"]))
                wall.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            launched, fallbacks = ops.kernel_calls(), ops.fallbacks()
            ids, labels = batches[0]
            grads = ctr_shard_grads(torch, trainer, state, ids, labels, world)[rank]
            ms = sync_ms(torch, dpm.GradSync(dpm.DPConfig(sync_bits=sync)), grads, 0, False, 3)
            out[str(sync)] = {"digest": tree_digest(torch, ctr_trainer.checkpoint_tree(cfg, state)),
                              "losses": losses, "wall": wall, "launches": launched,
                              "fallbacks": fallbacks, "sync_ms": ms,
                              "leaves": len(dpm.ctr_grad_shapes(trainer, state))}
            del state, grads
            torch.cuda.empty_cache()
        (pathlib.Path(directory) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def dp_gloo(torch, dev, directory: pathlib.Path) -> dict:
    """12c: DP_RANKS processes on the one card over gloo (CUDA tensors), each
    holding the full-width ALPT-8 state (``dp_rank``), against the twin with
    ``n_shards = DP_RANKS`` in this process: every rank's state digest and
    losses equal the twin's at each DP_RANK_SYNC width.  Returns the ranks'
    launches."""
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.training import ctr_trainer
    from repro_torch.training import data_parallel as dpm

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke, sys; "
         f"sys.exit(chip_smoke.dp_rank({r}, {DP_RANKS}, {str(directory)!r}))"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(DP_RANKS)]
    try:
        for r, p in enumerate(procs):
            _, err_text = p.communicate(timeout=600)
            check(p.returncode == 0, f"12c rank {r} exited {p.returncode}: {err_text[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [json.loads((directory / f"rank{r}.json").read_text()) for r in range(DP_RANKS)]
    ranks_s = time.perf_counter() - t0
    data = CTRSynthetic(avazu_like(SCALE))
    batches = [data.batch("train", i, DP_RANKS * BATCH) for i in range(DP_RANK_STEPS)]
    total = {}
    for sync in DP_RANK_SYNC:
        trainer, cfg = dp_trainer(dev, "alpt", 8, sync)
        twin = dpm.make_ctr_microbatch_step(trainer, DP_RANKS)
        state = trainer.init_state()
        losses = []
        for ids, labels in batches:
            state, m = twin(state, ids, labels)
            losses.append(float(m["loss"]))
        digest = tree_digest(torch, ctr_trainer.checkpoint_tree(cfg, state))
        for r, out in enumerate(ranks):
            o = out[str(sync)]
            want = dp_launches("alpt", 8, sync, o["leaves"], 1, DP_RANK_STEPS)
            check(o["digest"] == digest and o["losses"] == losses,
                  f"12c sync={sync}: rank {r} differs from the twin: {o['losses']} vs {losses}")
            check(o["launches"] == want and o["fallbacks"] == [],
                  f"12c sync={sync} rank {r}: launches {o['launches']} (expected {want}), "
                  f"fallbacks {o['fallbacks']}")
            total = added(total, o["launches"])
        o = ranks[0][str(sync)]
        log(f"[dp] 12c ALPT-8 sync={sync}: {DP_RANKS} gloo ranks on one card, each the full "
            f"state, {DP_RANK_STEPS} steps of {DP_RANKS} x {BATCH}: every rank's state and "
            f"losses {losses} bitwise the twin with n_shards = {DP_RANKS}; rank 0 host clock "
            f"{statistics.mean(o['wall'][1:]):.1f} ms/step (first {o['wall'][0]:.1f}), the sync "
            f"alone {o['sync_ms']:.1f} ms; launches per rank {o['launches']}")
        del state
        torch.cuda.empty_cache()
    log(f"[dp] 12c: the ranks' processes {ranks_s:.1f}s; {card_name()}")
    return total


def dp_cli(directory: pathlib.Path, lm_leaves: int, lm_wire: dict) -> dict:
    """12d: ``train lm --arch smollm-135m --mesh-data 1 --dp-compress-bits 8
    --steps 3`` (a one-rank NCCL group it makes itself) with ``--ckpt-dir``
    and ``--ckpt-every 1``, its wire-bytes line and launches; then its step 3
    removed and the same command again: resumed from step 2, its step 3's
    loss the first run's bit for bit."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "lm", "--arch", LM_ARCH,
           "--mesh-data", "1", "--dp-compress-bits", "8", "--steps", str(DP_CLI_STEPS),
           "--ckpt-dir", str(directory), "--ckpt-every", "1"]
    reports, times = [], []
    for attempt in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
        times.append(time.perf_counter() - t0)
        lines = proc.stdout.strip().splitlines()
        check(proc.returncode == 0 and bool(lines),
              f"12d train lm --mesh-data 1 exited {proc.returncode}: {proc.stderr[-2000:]}")
        reports.append((lines, json.loads(lines[-1])))
        if attempt == 0:
            last = f"step_{DP_CLI_STEPS:09d}"
            (directory / f"{last}.COMMITTED").unlink()
            shutil.rmtree(directory / last)
    (lines, first), (lines2, second) = reports
    wire_line = (f"[train] dp sync_bits=8 wire_bytes/step={lm_wire['wire_bytes_per_step']} "
                 f"({lm_wire['compression_ratio']:.2f}x vs fp32)")
    check(wire_line in lines and wire_line in lines2, f"12d wire line missing: {lines[:6]}")
    check(first["mesh_data"] == 1 and first["wire_bytes_per_step"]
          == lm_wire["wire_bytes_per_step"], f"12d report {first}")
    per_step = lm_leaves + 2
    check(first["kernel_launches"] == {"sr_round": 1 + DP_CLI_STEPS * per_step,
                                       "adam_update": DP_CLI_STEPS}
          and second["kernel_launches"] == {"sr_round": per_step, "adam_update": 1}
          and first["fallbacks"] == second["fallbacks"] == [],
          f"12d launches {first['kernel_launches']}, {second['kernel_launches']}")
    check(f"[train] resumed from step {DP_CLI_STEPS - 1}" in lines2,
          f"12d the second run did not resume: {lines2[:6]}")
    check(second["losses"] == first["losses"][-1:],
          f"12d resumed step {DP_CLI_STEPS}: {second['losses']} != {first['losses'][-1:]}")
    log(f"[dp] 12d {wire_line!r}; {DP_CLI_STEPS} steps ({times[0]:.1f} s), losses "
        f"{first['losses']}; step {DP_CLI_STEPS} removed and the command again ({times[1]:.1f} "
        f"s): resumed from step {DP_CLI_STEPS - 1}, its loss bitwise the first run's")
    return {k: first["kernel_launches"].get(k, 0) + second["kernel_launches"].get(k, 0)
            for k in set(first["kernel_launches"]) | set(second["kernel_launches"])}


def dp_phase(torch, dev, lm_data) -> dict:
    """Phase 12 (12a-12d), in a temporary directory removed at the end.
    Returns its launches (12a's kernels-on twins, 12b's and 12c's DP steps,
    12d's CLI runs)."""
    import tempfile

    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like

    t_phase = time.perf_counter()
    data = CTRSynthetic(avazu_like(SCALE))
    batches = Batches(data.batch("train", i, DP_SHARDS * BATCH) for i in range(DP_STEPS))
    total = dp_twins(torch, dev, batches)
    log(f"[dp] 12a: {time.perf_counter() - t_phase:.1f}s")
    nccl, lm = dp_nccl(torch, dev, batches, lm_data)
    total = added(total, nccl)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        root = pathlib.Path(tmp)
        (root / "gloo").mkdir()
        total = added(total, dp_gloo(torch, dev, root / "gloo"))
        total = added(total, dp_cli(root / "cli", lm["lm_leaves"], lm["lm_wire"]))
    log(f"[dp] phase 12: launches {total}; {time.perf_counter() - t_phase:.1f}s; {card_name()}")
    return total


def gloo_probe_rank(rank: int, world: int, directory: str) -> int:
    """One rank of ``gloo_probe``: each collective phases 12 and 18 take, on
    CUDA tensors over gloo, its result printed; then one table-sized
    all_gather (float32) and all_reduce (int32 SUM), and phase 18's
    activation-sized all_reduce (SUM, MAX) and all_gather, timed on the host
    clock."""
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{directory}/init", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", 0)
    try:
        out = {}
        for dtype in (torch.float32, torch.uint8):
            t = (torch.arange(6, device=dev) + 10 * rank).to(dtype)
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t)
            out[f"all_gather {dtype}"] = [p.tolist() for p in parts]
        for dtype, op in ((torch.float32, dist.ReduceOp.MAX), (torch.int32, dist.ReduceOp.SUM)):
            t = (torch.arange(4, device=dev) * (rank + 1)).to(dtype)
            dist.all_reduce(t, op=op)
            out[f"all_reduce {op} {dtype}"] = t.tolist()
        # Phase 18's: an activation [2, 1,024, 2,048] (qwen3-1.7b, 2 x 1,024
        # tokens) summed, its max, and gathered along T (sequence parallel).
        act = (torch.arange(2 * 1024 * 2048, device=dev, dtype=torch.float32)
               .reshape(2, 1024, 2048) % 7) * (rank + 1)
        for op in (dist.ReduceOp.SUM, dist.ReduceOp.MAX):
            t = act.clone()
            dist.all_reduce(t, op=op)
            want = act / (rank + 1) * (3 if op == dist.ReduceOp.SUM else 2)
            out[f"activation all_reduce {op} equal"] = bool(torch.equal(t, want))
        for name, t in (("all_gather", torch.full((4_428_288 * 16,), float(rank), device=dev)),
                        ("all_reduce", torch.full((4_428_288 * 16,), rank + 1, device=dev,
                                                  dtype=torch.int32)),
                        ("activation all_reduce SUM", act.clone()),
                        ("activation all_reduce MAX", act.clone()),
                        ("activation all_gather", act.clone())):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name.endswith("all_gather"):
                dist.all_gather([torch.empty_like(t) for _ in range(world)], t)
            else:
                dist.all_reduce(t, op=dist.ReduceOp.MAX if name.endswith("MAX")
                                else dist.ReduceOp.SUM)
            torch.cuda.synchronize()
            out[f"{name} of {t.numel() * 4} B, s"] = time.perf_counter() - t0
        out.update(all_to_all_probe(torch, dist, dev, rank, world))
        print(f"[probe] rank {rank}: {json.dumps(out)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


# 18j's all-to-all: deepseek-moe-16b's send buffer [m, E/m, B, C, d] on 1 x 2
# at 2 x 1,024 tokens (s_loc 512, C = int(512 * 6 * 1.25 / 64) + 1 = 61).
EP_SEND_SHAPE = (2, 32, 2, 61, 2048)


def all_to_all_probe(torch, dist, dev, rank: int, world: int, reps: int = 3) -> dict:
    """gloo's ``all_to_all_single`` on CUDA tensors: a small exchange checked
    against what each rank sent, then EP_SEND_SHAPE's buffer timed on the
    host clock (``reps`` calls).  A refusal is reported as it is."""
    out = {}
    try:
        t = torch.arange(world * 3, device=dev, dtype=torch.float32) + 100 * rank
        got = torch.empty_like(t)
        dist.all_to_all_single(got, t)
        want = torch.cat([torch.arange(3, device=dev, dtype=torch.float32) + 3 * rank + 100 * j
                          for j in range(world)])
        out["all_to_all_single equal"] = bool(torch.equal(got, want))
        buf = torch.full(EP_SEND_SHAPE, float(rank), device=dev)
        recv = torch.empty_like(buf)
        times = []
        for _ in range(reps):
            _on_card(torch, dev, "synchronize")
            t0 = time.perf_counter()
            dist.all_to_all_single(recv, buf)
            _on_card(torch, dev, "synchronize")
            times.append(time.perf_counter() - t0)
        out[f"all_to_all_single of {buf.numel() * 4} B, s"] = times
        out["all_to_all_single sources"] = [float(recv[j].flatten()[0]) for j in range(world)]
    except RuntimeError as exc:
        out["all_to_all_single refused"] = str(exc)[:300]
    return out


def gloo_probe() -> int:
    """Whether this torch build's gloo takes CUDA tensors for the collectives
    of phase 12 (two ranks on the one card), and what a table-sized payload
    costs: ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.gloo_probe())"``."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_probe_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke, sys; "
             f"sys.exit(chip_smoke.gloo_probe_rank({r}, 2, {tmp!r}))"], cwd=ROOT)
            for r in range(2)]
        codes = [p.wait(timeout=300) for p in procs]
    log(f"[probe] ranks exited {codes}; {card_name()}")
    return max(codes)


def dp_only() -> int:
    """Phase 12 alone (with phase 8's LM batches):
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.dp_only())"``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = device_mod.resolve("cuda")
    for lib in _build.build():
        _build.library(lib)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; build "
        f"{time.perf_counter() - t_start:.1f}s")
    launches = dp_phase(torch, dev, lm_batches(torch, dev, LM_TABLE[0]))
    check(set(launches) <= set(KERNELS), f"phase 12 launched {launches}")
    log(f"[chip_smoke] phase 12 alone in {time.perf_counter() - t_start:.1f}s")
    return 0


# Phase 13: the SSM and MoE LM families at full width (random weights from a
# seed).  mamba2-370m runs at full depth; deepseek-moe-16b's depth is cut
# from 28 layers to 2 so that one card holds its training state (params,
# gradients and two Adam moments of ~1.39 B fp32 parameters, ~25 GB, and the
# out-of-place AdamW's new copies).
FAMILY_DEPTH = {"mamba2-370m": None, "deepseek-moe-16b": 2}
# Prompts of at most one SSD chunk (128) or a multiple of it: an SSM
# prefills at exact length.  The last request's prompt is two chunks.
FAMILY_PROMPTS, FAMILY_LONG_PROMPT = (64, 100, 128), 256
FAMILY_REQUESTS, FAMILY_MAX_NEW, FAMILY_BATCH = 16, 16, 8
FAMILY_MAX_LEN = FAMILY_LONG_PROMPT + FAMILY_MAX_NEW
FAMILY_SERVE = (("mamba2-370m", 8), ("mamba2-370m", 4), ("deepseek-moe-16b", 8))
# (arch, method, bits, steps); the first LM_REPLAY steps replayed kernels off.
FAMILY_TRAIN = (("mamba2-370m", "alpt", 8, 3), ("mamba2-370m", "lpt", 4, 3),
                ("deepseek-moe-16b", "alpt", 8, 3))

CHECKSUM_CHUNK = 1 << 26


def family_config(arch: str, **overrides):
    """The full config of ``arch``, at phase 13's depth."""
    from repro_torch import configs

    depth = FAMILY_DEPTH[arch]
    return configs.full_config(arch, **overrides, **({"n_layers": depth} if depth else {}))


def checksum(torch, t) -> int:
    """A position-weighted sum of a tensor's bit patterns, on the card (int64,
    wrapping): equal tensors give equal sums, and a flipped bit or two
    swapped elements change it."""
    flat = t.detach().reshape(-1)
    if flat.dtype == torch.float32:
        flat = flat.view(torch.int32)
    total = 0
    for c0 in range(0, flat.numel(), CHECKSUM_CHUNK):
        x = flat[c0:c0 + CHECKSUM_CHUNK].to(torch.int64)
        w = torch.arange(c0, c0 + x.numel(), device=x.device, dtype=torch.int64) % 65521 + 1
        total += int((x * w).sum())
    return total


def state_checksums(torch, state) -> list:
    """Every tensor of an LM training state (params, Adam moments, codes,
    Delta, row-Adam slots) as :func:`checksum`, the step, the table's count
    and the generator's state."""
    from repro_torch.optim import tree_leaves

    t = state.table
    tensors = [*tree_leaves(state.params), *state.opt.mu, *state.opt.nu, t.codes.data, t.step,
               t.mu, t.nu]
    return [state.step, int(t.count), state.generator.get_state().tolist(),
            *(checksum(torch, x) for x in tensors)]


def family_serve(torch, np, dev, arch: str, bits: int, cfg=None, tag: str = "family") -> dict:
    """13a / 13b (16a) serving: ``arch`` at full width (``cfg``, default
    phase 13's depth) behind ``LMEngine`` (the main path), then the plain
    path teacher-forced on its tokens.  The state is built without its
    optimizer (the same draws)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.lm import LMRequest
    from repro_torch.training import lm_trainer

    cfg = cfg or family_config(arch, embedding_bits=bits)
    label = f"{arch} bits={bits}"
    rng = np.random.RandomState(30 + bits)
    lens = [FAMILY_PROMPTS[i % len(FAMILY_PROMPTS)] for i in range(FAMILY_REQUESTS - 1)]
    prompts = [rng.randint(0, cfg.vocab_size, t).astype(np.int32)
               for t in (*lens, FAMILY_LONG_PROMPT)]
    gather = "dequant_gather_packed" if bits < 8 else "dequant_gather"
    head = "dequant_matmul_packed" if bits < 8 else "dequant_matmul"
    attn_layers = cfg.n_groups * cfg.layer_types.count("attn")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_kernel_calls()  # the main path starts here ...
    ops.reset_fallbacks()
    t0 = time.perf_counter()
    state = lm_trainer.init_state(cfg, seed=40 + bits, device=dev, optimizer=False)
    engine = lm_engine_class().from_state(state, cfg, batch=FAMILY_BATCH, max_len=FAMILY_MAX_LEN)
    for i, p in enumerate(prompts):
        engine.submit(LMRequest(prompt=p, max_new=FAMILY_MAX_NEW, rid=i))
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.kernel_calls()  # ... and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    reads = FAMILY_REQUESTS + len(engine.decode_ms)  # one per prefill and decode step
    want = {"sr_round": 1, gather: reads}
    if cfg.tie_embeddings:
        want[head] = reads
    if attn_layers:
        want["flash_attention_fwd"] = FAMILY_REQUESTS * attn_layers
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(ops.fallbacks() == [], f"{label}: fallbacks {ops.fallbacks()}")
    m = engine.metrics()
    check(len(done) == FAMILY_REQUESTS and all(len(done[i]) == FAMILY_MAX_NEW for i in done),
          f"{label}: requests lost or short")
    check(all(0 <= t < cfg.vocab_size for toks in done.values() for t in toks),
          f"{label}: tokens outside the vocabulary")
    resident = cfg.vocab_size * (-(-cfg.d_model * bits // 8) + 4)
    check(m.int8_resident and m.resident_embedding_bytes == resident,
          f"{label}: resident bytes {m.resident_embedding_bytes} != {resident}")
    for rid, rows in engine.logits.items():
        check(len(rows) == FAMILY_MAX_NEW and all(bool(torch.isfinite(r).all()) for r in rows),
              f"{label}: request {rid} logits not finite or missing")
    prefill = {n: statistics.mean(ms for t, ms in engine.prefill_ms[1:] if t == n)
               for n in sorted(set(map(len, prompts)))}  # the first one warms up
    decode_ms = statistics.mean(engine.decode_ms[1:])
    log(f"[{tag}] {label}: {cfg.n_layers} layers, d={cfg.d_model}, vocab {cfg.vocab_size}; "
        f"{FAMILY_REQUESTS} requests x {FAMILY_MAX_NEW} tokens, slot batch {FAMILY_BATCH}: "
        f"init+serve {wall:.2f}s (host clock), per decode step {decode_ms:.2f} ms, per "
        "prefill " + ", ".join(f"T={n}: {ms:.2f} ms" for n, ms in prefill.items())
        + f"; resident {m.resident_embedding_bytes} B; peak memory {peak} B; launches "
        f"{launches}; {card_name()}")

    plain = dataclasses.replace(engine.table, use_kernels=False)
    summary = teacher_forced(torch, engine, state.params, plain, cfg, prompts, done,
                             FAMILY_MAX_NEW, FAMILY_MAX_LEN, label)
    log(f"[{tag}] {label}: teacher-forced plain path {summary}; "
        f"{time.perf_counter() - t0:.1f}s with the serving")
    if arch in ("mamba2-370m", VLM_ARCH) and bits == 8:
        profile_decode(torch, engine, bits)
    return {"launches": launches, "table": (engine.table.codes, engine.table.step),
            "peak": peak, "prompts": sorted(set(map(len, prompts)))}


def family_train(torch, dev, arch: str, method: str, bits: int, steps: int, cfg=None,
                 batches=None, tag: str = "family-train", donate: bool = False,
                 replay: bool = True) -> dict:
    """13a / 13b (16c, 17a, 17d) training: ``arch`` at full width (``cfg``,
    default phase 13's depth; ``batches``, default the token stream's)
    through the main path (``donate``: the step consumes its state), then,
    with ``replay``, the first LM_REPLAY steps again with the kernels off
    from the same seed.  Returns the run's launches, host ms, peak memory
    and ``sums``, the state's checksums and the losses after LM_REPLAY
    steps."""
    from repro_torch.core import lpt as lpt_core
    from repro_torch.data.lm_synth import LMTokenStream
    from repro_torch.kernels import ops
    from repro_torch.training import lm_trainer

    cfg = cfg or family_config(arch, embedding_method=method, embedding_bits=bits)
    tcfg = lm_trainer.LMTrainerConfig()
    label = f"{arch} {method} bits={bits}"
    write_back = "sr_round" if method == "alpt" else (
        "lpt_fused_update_packed" if bits < 8 else "lpt_fused_update")
    if batches is None:
        stream = LMTokenStream(cfg.vocab_size, LM_TRAIN_SEQ, seed=17)
        batches = []
        for i in range(steps):
            full = torch.from_numpy(stream.batch(i, LM_TRAIN_BATCH)).to(dev)
            batches.append({"tokens": full[:, :-1], "labels": full[:, 1:]})
    train_step = lm_trainer.make_train_step(cfg, tcfg, donate=donate)
    seed = 50 + bits

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t_run = time.perf_counter()
    ops.reset_kernel_calls()  # the main path starts here ...
    ops.reset_fallbacks()
    state = lm_trainer.init_state(cfg, tcfg, seed=seed, device=dev)
    losses, aux, norms, wall = [], [], [], []
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))  # the host waits for the step
        wall.append((time.perf_counter() - t0) * 1e3)
        aux.append(float(m["aux_loss"]))
        norms.append([float(m["grad_norm"])] + ([float(m["step_grad_norm"])]
                                                if method == "alpt" else []))
        if i + 1 == LM_REPLAY:
            early = (state_checksums(torch, state), list(losses))
    torch.cuda.synchronize()
    launches = ops.kernel_calls()  # ... and ends here
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"sr_round": 1, "adam_update": steps}  # sr_round: the table's init
    want[write_back] = want.get(write_back, 0) + steps
    check(launches == want, f"{label}: launches {launches}, expected {want}")
    check(ops.fallbacks() == [], f"{label}: fallbacks {ops.fallbacks()}")
    check(all(math.isfinite(x) for x in losses + aux + sum(norms, [])),
          f"{label}: losses {losses}, aux {aux}, gradient norms {norms}")
    t = state.table
    held_bytes = sum(x.numel() * x.element_size() for x in (t.codes.data, t.step, t.mu, t.nu))
    v, d = cfg.vocab_size, cfg.d_model
    expected = v * -(-d * bits // 8) + 4 * v + 8 * v * d
    check(held_bytes == lpt_core.memory_bytes(t, bits, count_optimizer=True) == expected,
          f"{label}: table training bytes {held_bytes} != {expected}")
    del t  # the table's tensors go with the state below, before the replay
    ms = statistics.mean(wall[1:])
    log(f"[{tag}] {label}: {cfg.n_layers} layers, d={d}; {steps} steps of "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        + (f", aux {aux}" if cfg.moe is not None else "")
        + f", gradient norms {norms}; host clock: first step {wall[0]:.1f} ms, then "
        f"{ms:.2f} ms/step; table training tensors {held_bytes} B; peak memory {peak} B; "
        f"launches {launches}; {time.perf_counter() - t_run:.1f}s; {card_name()}")
    del state
    torch.cuda.empty_cache()
    out = {"launches": launches, "ms": ms, "first_ms": wall[0], "peak": peak, "sums": early}
    if not replay:
        return out

    # The first LM_REPLAY steps again with the kernels off, from the same seed.
    replay = lm_trainer.init_state(cfg, tcfg, seed=seed, device=dev)
    off_step = lm_trainer.make_train_step(cfg, dataclasses.replace(tcfg, use_kernels=False),
                                          donate=donate)
    ops.reset_kernel_calls()
    replay_losses = []
    for batch in batches[:LM_REPLAY]:
        replay, m = off_step(replay, batch)
        replay_losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    check(ops.kernel_calls() == {}, f"{label}: kernels-off run launched {ops.kernel_calls()}")
    same = (state_checksums(torch, replay), replay_losses) == early
    check(same, f"{label}: kernels-off steps 1-{LM_REPLAY} differ from kernels-on: "
                f"{replay_losses} vs {early[1]}")
    log(f"[{tag}] {label}: steps 1-{LM_REPLAY} with the kernels off equal the kernels-on "
        f"run (losses {early[1]}; the checksums of every param, Adam moment, code, Delta and "
        f"row-Adam slot, the step, count and generator state); {time.perf_counter() - t_run:.1f}s "
        "with the replay")
    del replay
    torch.cuda.empty_cache()
    return out


def families_phase(torch, np, dev) -> tuple[dict, dict]:
    """Phase 13: mamba2-370m (13a) and deepseek-moe-16b (13b) served and
    trained at full width through the port's entry points.  Returns the
    phase's launches and the served tables ({(arch, bits): (codes, step)})."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"[family] phase 13 starts with {torch.cuda.memory_allocated(dev)} B allocated")
    total, tables = {}, {}
    for arch in FAMILY_DEPTH:
        for a, bits in FAMILY_SERVE:
            if a == arch:
                r = family_serve(torch, np, dev, arch, bits)
                total = added(total, r["launches"])
                tables[(arch, bits)] = r["table"]
        for a, method, bits, steps in FAMILY_TRAIN:
            if a == arch:
                r = family_train(torch, dev, arch, method, bits, steps)
                total = added(total, r["launches"])
        log(f"[family] {arch}: {time.perf_counter() - t_phase:.1f}s into phase 13")
    log(f"[family] phase 13: launches {total}; {time.perf_counter() - t_phase:.1f}s; "
        f"{card_name()}")
    return total, tables


def time_families(torch, tables: dict, flush) -> None:
    """Phase 5 for phase 13's shapes: the head at mamba2-370m's tied table
    (N = 50,280, K = 1,024) and flash at deepseek-moe-16b's prefill (16/16
    heads, D = 128, causal) at phase 13's prompt lengths, each beside its
    bound, its plain version and the library's one call."""
    _, notes = time_head(torch, {bits: tables[("mamba2-370m", bits)] for bits in (8, 4)}, flush)
    _, flash_notes = time_flash(torch, flush, heads=(16, 16, 128),
                                lengths=(*FAMILY_PROMPTS, FAMILY_LONG_PROMPT))
    for line in notes + flash_notes:
        log(f"{line}; {card_name()}")


def families_only() -> int:
    """Phase 13 alone, with its timings:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.families_only())"``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = device_mod.resolve("cuda")
    for lib in _build.build():
        _build.library(lib)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; build "
        f"{time.perf_counter() - t_start:.1f}s")
    launches, tables = families_phase(torch, np, dev)
    check(set(launches) <= set(KERNELS), f"phase 13 launched {launches}")
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    time_families(torch, tables, flush_buf.zero_)
    log(f"[chip_smoke] phase 13 alone in {time.perf_counter() - t_start:.1f}s")
    return 0


# Phase 16: the VLM, qwen2-vl-7b (28 layers, d = 3,584, 28/4 heads at D =
# 128 with QKV bias, M-RoPE sections 16/24/24, an untied head over 152,064
# rows).  Served at full width and depth (28.3 GB of fp32 params, built
# without Adam moments) with phase 13's requests; trained ALPT-8 at full
# width with its depth cut to VLM_TRAIN_DEPTH of 28 layers: one card holds
# the params, gradients, two Adam moments and the out-of-place update's
# new copies of the head's and the layers' parameters, the table's training
# state and the activations of 4 x 1,024 tokens.  At 4 layers the
# kernels-on run peaks at 79.8 GB of the card's 85.0 and its kernels-off
# replay (the plain Adam's and write-back's temporaries) runs out of
# memory.  Each training batch is phase 8's 4 x 1,024 tokens with a
# 256-position visual prefix laid out as a VLM_GRID patch grid.
VLM_ARCH = "qwen2-vl-7b"
VLM_SERVE_BITS = (8, 4)
VLM_TRAIN_DEPTH = 2
VLM_TRAIN_STEPS = 3
VLM_GRID = (16, 16)
VLM_HEADS = (28, 4, 128)
VLM_FLASH_LENGTHS = (64, 100, 128, 157, 256)
VLM_CLI_REQUESTS, VLM_CLI_PROMPT, VLM_CLI_GEN = 4, 64, 8


def vlm_positions(torch, b: int, t: int, dev):
    """Grid M-RoPE positions [3, b, t]: the prefix a VLM_GRID of patches
    (temporal 0, height = row, width = col), the text after it equal in all
    three streams from the prefix's largest position + 1 on."""
    rows, cols = VLM_GRID
    p = rows * cols
    pos = torch.zeros(3, t, dtype=torch.int32)
    pos[1, :p] = torch.arange(rows).repeat_interleave(cols)
    pos[2, :p] = torch.arange(cols).repeat(rows)
    pos[:, p:] = max(rows, cols) + torch.arange(t - p)
    return pos[:, None].expand(3, b, t).contiguous().to(dev)


def vlm_batches(torch, dev, cfg) -> list:
    """VLM_TRAIN_STEPS batches of LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens (the
    token stream's), each with a seeded normal visual prefix [B, 256, d] and
    grid positions."""
    from repro_torch.data.lm_synth import LMTokenStream

    stream = LMTokenStream(cfg.vocab_size, LM_TRAIN_SEQ, seed=17)
    g = torch.Generator(device=dev).manual_seed(16)
    out = []
    for i in range(VLM_TRAIN_STEPS):
        full = torch.from_numpy(stream.batch(i, LM_TRAIN_BATCH)).to(dev)
        out.append({"tokens": full[:, :-1], "labels": full[:, 1:],
                    "prefix_embeds": torch.randn(LM_TRAIN_BATCH, cfg.visual_prefix,
                                                 cfg.d_model, generator=g, device=dev),
                    "positions": vlm_positions(torch, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)})
    return out


def shape_kernels(torch, dev, tables: dict, err: dict, heads, lengths, seed: int,
                  tag: str) -> None:
    """16b / 17c: the kernels at a family's shapes against their plain
    versions: flash at ``heads`` (H, KH, D), causal, at every length of
    ``lengths`` (within FLASH_ATOL); both gathers on the served tables
    ({bits: (codes, step)}) over a decode step's, the longest prefill's and
    a training batch's token ids (bitwise); sr_round over a table of that
    shape (bitwise)."""
    from repro_torch.core import quant
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sr_round as sr_kernel

    g = torch.Generator(device=dev).manual_seed(seed)
    h, kh, d = heads
    check_flash(torch, dev, g, err, [(1, t, t, h, kh, d, True, None) for t in lengths])
    vocab = tables[8][0].n
    for bits, (store, step) in tables.items():
        kernel = "dequant_gather" if bits == 8 else "dequant_gather_packed"
        for b in (FAMILY_BATCH, FAMILY_LONG_PROMPT, LM_TRAIN_BATCH * LM_TRAIN_SEQ):
            ids = torch.randint(0, vocab, (b,), generator=g, device=dev, dtype=torch.int32)
            ids[:2] = torch.tensor([vocab - 1, 0], device=dev)
            got = ops.dequant_gather(store, step, ids)
            want = ops.dequant_gather(store, step, ids, use_kernel=False)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err[kernel] = max(err[kernel], e)
            check(torch.equal(got, want), f"{tag}: {kernel} {vocab}x{store.d} b={b}: max err {e}")
    w = torch.randn(vocab, tables[8][0].d, generator=g, device=dev) * 0.01
    noise = quant.sr_noise(g, tuple(w.shape))
    step = quant.init_step_size(w, 8)
    got = sr_kernel.sr_round(w, step, noise, 8)
    want = ref.sr_round_ref(w, step, noise, 8)
    torch.cuda.synchronize()
    e = float((got.int() - want.int()).abs().max())
    err["sr_round"] = max(err["sr_round"], e)
    check(torch.equal(got, want), f"{tag}: sr_round {tuple(w.shape)}: max err {e}")
    log(f"{tag}: flash_attention_fwd at {h}/{kh} heads, D = {d}, causal, T = "
        f"{list(lengths)} within {FLASH_ATOL} of the plain masked softmax; both gathers "
        f"bitwise on the {vocab} x {tables[8][0].d} tables over {FAMILY_BATCH}, "
        f"{FAMILY_LONG_PROMPT} and {LM_TRAIN_BATCH * LM_TRAIN_SEQ} token ids; sr_round bitwise "
        f"over {w.numel()} elements")


def vlm_clis(torch) -> dict:
    """16d: ``serve lm --arch qwen2-vl-7b`` at full width and depth in a
    subprocess (its own card memory; VLM_CLI_REQUESTS prompts of
    VLM_CLI_PROMPT tokens, VLM_CLI_GEN new each), ``train lm --arch
    qwen2-vl-7b --smoke`` on the card in this process, and its exit 2 under
    ``--dp-compress-bits 8``.  Returns the CLIs' launches."""
    from repro_torch import configs
    from repro_torch.launch import train as train_mod

    layers = configs.full_config(VLM_ARCH).n_layers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "lm", "--arch", VLM_ARCH,
         "--requests", str(VLM_CLI_REQUESTS), "--prompt-len", str(VLM_CLI_PROMPT), "--gen",
         str(VLM_CLI_GEN), "--batch", str(VLM_CLI_REQUESTS)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=600)
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and bool(lines),
          f"16d: serve lm --arch {VLM_ARCH} exited {proc.returncode}: {proc.stderr[-2000:]}")
    m = json.loads(lines[-1])
    served = m["kernel_launches"]
    # The engine's waves (its table's init is not one): a prefill each, then
    # the decode steps, one gather each; flash once per layer and request.
    reads = VLM_CLI_REQUESTS + VLM_CLI_GEN - 1
    want = {"dequant_gather": reads, "flash_attention_fwd": VLM_CLI_REQUESTS * layers}
    check(m["requests_completed"] == VLM_CLI_REQUESTS
          and m["tokens_generated"] == VLM_CLI_REQUESTS * VLM_CLI_GEN and m["int8_resident"]
          and m["kernel_fallbacks"] == 0 and served == want,
          f"16d: serve lm CLI metrics {m}, launches expected {want}")
    log(f"[vlm] 16d: {lines[0]} ({time.perf_counter() - t0:.1f}s with the process)")
    rc, report, err = cli_json(train_mod.main, [
        "lm", "--arch", VLM_ARCH, "--smoke", "--steps", "3", "--batch", "2", "--seq", "64",
        "--log-every", "0"])
    check(rc == 0 and len(report["losses"]) == 3 and all(map(math.isfinite, report["losses"]))
          and report["kernel_fallbacks"] == 0 and report["fallbacks"] == []
          and report["kernel_launches"] == {"sr_round": 4, "adam_update": 3},
          f"16d: train lm --arch {VLM_ARCH} --smoke: rc {rc}, {report}: {err[-2000:]}")
    out, errs = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
        try:
            train_mod.main(["lm", "--arch", VLM_ARCH, "--smoke", "--steps", "1",
                            "--dp-compress-bits", "8"])
            code = 0
        except SystemExit as exc:
            code = exc.code
    check(code == 2 and "does not support mixed-input" in errs.getvalue(),
          f"16d: train lm --dp-compress-bits 8 exited {code}: {errs.getvalue()[-500:]}")
    log(f"[vlm] 16d: train lm --arch {VLM_ARCH} --smoke on the card: losses "
        f"{report['losses']}, launches {report['kernel_launches']}; with --dp-compress-bits 8: "
        f"exit 2, \"{errs.getvalue().strip().splitlines()[-1]}\"")
    return added(served, report["kernel_launches"])


def vlm_phase(torch, np, dev, err: dict) -> tuple[dict, dict]:
    """Phase 16: qwen2-vl-7b served at full width and depth at 8 and 4 bits
    (16a), its kernels against their plain versions at its shapes (16b),
    trained ALPT-8 at full width (16c), its CLIs (16d).  Returns the
    phase's launches and the served tables ({bits: (codes, step)})."""
    import gc

    from repro_torch import configs

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"[vlm] phase 16 starts with {torch.cuda.memory_allocated(dev)} B allocated")
    total, tables = {}, {}
    for bits in VLM_SERVE_BITS:
        cfg = configs.full_config(VLM_ARCH, embedding_bits=bits)
        r = family_serve(torch, np, dev, VLM_ARCH, bits, cfg=cfg, tag="vlm")
        total = added(total, r["launches"])
        tables[bits] = r["table"]
        del r
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[vlm] 16a: {time.perf_counter() - t_phase:.1f}s")
    shape_kernels(torch, dev, tables, err, VLM_HEADS, VLM_FLASH_LENGTHS, 161, "[vlm] 16b")
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.full_config(VLM_ARCH, n_layers=VLM_TRAIN_DEPTH)
    r = family_train(torch, dev, VLM_ARCH, "alpt", 8, VLM_TRAIN_STEPS, cfg=cfg,
                     batches=vlm_batches(torch, dev, cfg), tag="vlm-train")
    total = added(total, r["launches"])
    log(f"[vlm] 16c: {VLM_TRAIN_DEPTH} of 28 layers, peak memory {r['peak']} B; "
        f"{time.perf_counter() - t_phase:.1f}s into phase 16")
    del r
    gc.collect()
    torch.cuda.empty_cache()
    total = added(total, vlm_clis(torch))
    log(f"[vlm] phase 16: launches {total}; {time.perf_counter() - t_phase:.1f}s; "
        f"{card_name()}")
    return total, tables


def time_vlm(torch, tables: dict, flush) -> None:
    """Phase 5 for phase 16's shapes: flash at qwen2-vl-7b's prefill (28/4
    heads, D = 128, causal, VLM_FLASH_LENGTHS) and both gathers on its
    152,064 x 3,584 tables at a decode step (8 ids) and the longest prefill
    (256), each beside its bound (and flash beside its plain version and
    SDPA's one call)."""
    _, notes = time_flash(torch, flush, heads=VLM_HEADS, lengths=VLM_FLASH_LENGTHS)
    vocab = tables[8][0].n
    g = torch.Generator(device="cuda").manual_seed(162)
    pools = {label: ("vlm", [torch.randint(0, vocab, (b,), generator=g, device="cuda",
                                           dtype=torch.int32) for _ in range(GATHER_POOL)])
             for label, b in (("VLM decode", FAMILY_BATCH), ("VLM prefill", FAMILY_LONG_PROMPT))}
    _, gather_notes = time_gathers(torch, {("vlm", bits): t for bits, t in tables.items()},
                                   pools, flush)
    for line in notes + gather_notes:
        log(f"{line}; {card_name()}")


def vlm_only() -> int:
    """Phase 16 alone, with its timings:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.vlm_only())"``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = device_mod.resolve("cuda")
    for lib in _build.build():
        _build.library(lib)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; build "
        f"{time.perf_counter() - t_start:.1f}s")
    err = {k: 0.0 for k in KERNELS}
    launches, tables = vlm_phase(torch, np, dev, err)
    check(set(launches) <= set(KERNELS), f"phase 16 launched {launches}")
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    time_vlm(torch, tables, flush_buf.zero_)
    log(f"[vlm] max abs errors against the plain versions: "
        f"{ {k: v for k, v in err.items() if v} }")
    log(f"[chip_smoke] phase 16 alone in {time.perf_counter() - t_start:.1f}s")
    return 0


# Phase 17: the encoder and remat.  hubert-xlarge (48 layers, d = 1,280,
# 16/16 heads at D = 80, non-causal, the gelu MLP with biases, an untied
# 504-way head; 944,794,880 fp32 params, the ``embeds`` input mode) trains
# at full width and depth, ALPT-8 (its config) and LPT-4 packed, on 4 x
# 1,024 frames made as the train CLI makes them.  deepseek-67b (d = 8,192,
# 64/8 heads at D = 128, d_ff 22,016, an untied head over 102,400 rows,
# remat) is served at full width with its depth cut to REMAT_SERVE_DEPTH of 95
# layers (a layer is 2.77 GB of fp32 weights: 16 layers, 44.3 GB, leave the
# init's fp32 table and noise and the plain path's room on the card) and
# trained ALPT-8 at full width with REMAT_TRAIN_DEPTH layer(s): its head and
# table (839 M elements each) with Adam and the row optimizer fill the card
# at one layer, so the step is donated (params and Adam moments stepped in
# place, as the reference's CLI donates its state).
ENC_ARCH, REMAT_ARCH = "hubert-xlarge", "deepseek-67b"
ENC_TRAIN = (("alpt", 8), ("lpt", 4))
ENC_STEPS = 3
REMAT_SERVE_DEPTH = 16
REMAT_SERVE_BITS = (8, 4)
REMAT_TRAIN_DEPTH = 1
REMAT_STEPS = 3
REMAT_HEADS = (64, 8, 128)
REMAT_FLASH_LENGTHS = (64, 100, 128, 157, 256)


def encoder_batches(torch, dev, cfg) -> list:
    """ENC_STEPS batches of LM_TRAIN_BATCH x LM_TRAIN_SEQ frames as the train
    CLI builds them (``lm_batch``: ``RandomState(step)`` normal frames, the
    token stream's labels modulo the vocabulary)."""
    from repro_torch.data.lm_synth import LMTokenStream
    from repro_torch.launch.train import lm_batch

    stream = LMTokenStream(cfg.vocab_size, LM_TRAIN_SEQ, seed=17)
    return [lm_batch(cfg, stream, i, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)
            for i in range(ENC_STEPS)]


def forward_bytes(torch, dev, cfg) -> dict:
    """17d: ``torch.cuda.memory_allocated()`` at the end of a training
    forward (the loss under grad mode, before its backward) less before it,
    with remat on and off, from one state (no optimizer) and one batch: the
    tensors the backward keeps."""
    from repro_torch.data.lm_synth import LMTokenStream
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import tree_leaves, tree_like
    from repro_torch.training import lm_trainer

    state = lm_trainer.init_state(cfg, seed=58, device=dev, optimizer=False)
    table = lm_trainer.table_fp_of(state, cfg)
    full = torch.from_numpy(LMTokenStream(cfg.vocab_size, LM_TRAIN_SEQ, seed=17).batch(
        0, LM_TRAIN_BATCH)).to(dev)
    batch = {"tokens": full[:, :-1], "labels": full[:, 1:]}
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        params = tree_like(state.params, [p.detach().requires_grad_(True)
                                          for p in tree_leaves(state.params)])
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        with torch.enable_grad():
            loss, _ = tfm.loss_fn(params, table, batch, c)
            torch.cuda.synchronize()
            out[remat] = torch.cuda.memory_allocated(dev) - before
        del loss, params
    del state, table
    torch.cuda.empty_cache()
    return out


def remat_train(torch, dev) -> dict:
    """17d: deepseek-67b ALPT-8 at full width with REMAT_TRAIN_DEPTH
    layer(s), donated, REMAT_STEPS steps of 4 x 1,024 tokens through the
    main path, replayed kernels off from the same seed (bitwise), then the
    same steps with remat off at the same depth: the losses and every
    tensor's checksum equal the remat run's.  Returns the launches."""
    from repro_torch import configs

    cfg = configs.full_config(REMAT_ARCH, n_layers=REMAT_TRAIN_DEPTH)
    fwd = forward_bytes(torch, dev, cfg)
    log(f"[remat] 17d: memory allocated at the end of the training forward ({REMAT_TRAIN_DEPTH} "
        f"layer(s), {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens): remat on {fwd[True]} B, off "
        f"{fwd[False]} B, {(fwd[False] - fwd[True]) / REMAT_TRAIN_DEPTH:.0f} B a layer saved; "
        f"{card_name()}")
    on = family_train(torch, dev, REMAT_ARCH, "alpt", 8, REMAT_STEPS, cfg=cfg,
                      tag="remat-train", donate=True)
    off = family_train(torch, dev, REMAT_ARCH, "alpt", 8, REMAT_STEPS,
                       cfg=dataclasses.replace(cfg, remat=False), tag="remat-train (remat off)",
                       donate=True, replay=False)
    check(off["sums"] == on["sums"], f"17d: remat off differs from remat on: losses "
                                     f"{off['sums'][1]} vs {on['sums'][1]}")
    log(f"[remat] 17d: remat off equals remat on over {REMAT_STEPS} steps (losses "
        f"{on['sums'][1]} and the checksums of every tensor of the state); peak memory "
        f"{on['peak']} B with remat, {off['peak']} B without; {on['ms']:.2f} / {off['ms']:.2f} "
        "ms a step")
    return added(on["launches"], off["launches"])


def encoder_remat_clis(torch) -> dict:
    """17e: ``train lm --arch hubert-xlarge --smoke`` and ``train lm --arch
    deepseek-67b --smoke`` on the card in this process; ``serve lm --arch
    hubert-xlarge`` exits 0 with the reference's line.  Returns the CLIs'
    launches."""
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod

    total = {}
    for arch in (ENC_ARCH, REMAT_ARCH):
        rc, report, err = cli_json(train_mod.main, [
            "lm", "--arch", arch, "--smoke", "--steps", "3", "--batch", "2", "--seq", "64",
            "--log-every", "0"])
        check(rc == 0 and len(report["losses"]) == 3 and all(map(math.isfinite, report["losses"]))
              and report["kernel_fallbacks"] == 0 and report["fallbacks"] == []
              and report["kernel_launches"] == {"sr_round": 4, "adam_update": 3},
              f"17e: train lm --arch {arch} --smoke: rc {rc}, {report}: {err[-2000:]}")
        log(f"[encoder] 17e: train lm --arch {arch} --smoke on the card: losses "
            f"{report['losses']}, launches {report['kernel_launches']}")
        total = added(total, report["kernel_launches"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_mod.main(["lm", "--arch", ENC_ARCH])
    line = "[serve] encoder-only arch has no decode; nothing to serve"
    check(rc == 0 and out.getvalue().strip() == line,
          f"17e: serve lm --arch {ENC_ARCH} exited {rc}: {out.getvalue()[-500:]}")
    log(f"[encoder] 17e: serve lm --arch {ENC_ARCH}: exit 0, '{line}'")
    return total


def encoder_remat_phase(torch, np, dev, err: dict) -> tuple[dict, dict]:
    """Phase 17: hubert-xlarge trained at full width and depth (17a),
    deepseek-67b served at full width (17b), its kernels against their plain
    versions at its shapes (17c), trained ALPT-8 at full width with remat
    (17d), the CLIs (17e).  Returns the phase's launches and the served
    tables ({bits: (codes, step)})."""
    import gc

    from repro_torch import configs

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    log(f"[encoder] phase 17 starts with {torch.cuda.memory_allocated(dev)} B allocated")
    total, tables = {}, {}
    for method, bits in ENC_TRAIN:
        cfg = configs.full_config(ENC_ARCH, embedding_method=method, embedding_bits=bits)
        r = family_train(torch, dev, ENC_ARCH, method, bits, ENC_STEPS, cfg=cfg,
                         batches=encoder_batches(torch, dev, cfg), tag="encoder-train")
        total = added(total, r["launches"])
        del r
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[encoder] 17a: {time.perf_counter() - t_phase:.1f}s")
    for bits in REMAT_SERVE_BITS:
        cfg = configs.full_config(REMAT_ARCH, n_layers=REMAT_SERVE_DEPTH, embedding_bits=bits)
        r = family_serve(torch, np, dev, REMAT_ARCH, bits, cfg=cfg, tag="remat")
        total = added(total, r["launches"])
        tables[bits] = r["table"]
        del r
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[remat] 17b: {REMAT_SERVE_DEPTH} of 95 layers; {time.perf_counter() - t_phase:.1f}s "
        "into phase 17")
    shape_kernels(torch, dev, tables, err, REMAT_HEADS, REMAT_FLASH_LENGTHS, 171, "[remat] 17c")
    gc.collect()
    torch.cuda.empty_cache()
    total = added(total, remat_train(torch, dev))
    log(f"[remat] 17d: {time.perf_counter() - t_phase:.1f}s into phase 17")
    gc.collect()
    torch.cuda.empty_cache()
    total = added(total, encoder_remat_clis(torch))
    log(f"[encoder] phase 17: launches {total}; {time.perf_counter() - t_phase:.1f}s; "
        f"{card_name()}")
    return total, tables


def time_encoder_remat(torch, tables: dict, flush) -> None:
    """Phase 5 for phase 17's shapes: flash at deepseek-67b's prefill (64/8
    heads, D = 128, causal, g = 8, REMAT_FLASH_LENGTHS) beside its bound,
    plain version and SDPA's one call, and both gathers on its 102,400 x
    8,192 tables at a decode step (8 ids) and the longest prefill (256)
    beside their bounds."""
    _, notes = time_flash(torch, flush, heads=REMAT_HEADS, lengths=REMAT_FLASH_LENGTHS)
    vocab = tables[8][0].n
    g = torch.Generator(device="cuda").manual_seed(172)
    pools = {label: ("remat", [torch.randint(0, vocab, (b,), generator=g, device="cuda",
                                             dtype=torch.int32) for _ in range(GATHER_POOL)])
             for label, b in (("deepseek-67b decode", FAMILY_BATCH),
                              ("deepseek-67b prefill", FAMILY_LONG_PROMPT))}
    _, gather_notes = time_gathers(torch, {("remat", bits): t for bits, t in tables.items()},
                                   pools, flush)
    for line in notes + gather_notes:
        log(f"{line}; {card_name()}")


def encoder_remat_only() -> int:
    """Phase 17 alone, with its timings:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.encoder_remat_only())"``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = device_mod.resolve("cuda")
    for lib in _build.build():
        _build.library(lib)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; build "
        f"{time.perf_counter() - t_start:.1f}s")
    err = {k: 0.0 for k in KERNELS}
    launches, tables = encoder_remat_phase(torch, np, dev, err)
    check(set(launches) <= set(KERNELS), f"phase 17 launched {launches}")
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)
    time_encoder_remat(torch, tables, flush_buf.zero_)
    log(f"[encoder] max abs errors against the plain versions: "
        f"{ {k: v for k, v in err.items() if v} }")
    log(f"[chip_smoke] phase 17 alone in {time.perf_counter() - t_start:.1f}s")
    return 0


# Phase 18: the sharding path (tensor and sequence parallel LM training on a
# (data, model) grid of gloo ranks on the one card; NCCL refuses two ranks on
# one device).  Each one-process twin runs and frees the card before its
# ranks start; every rank is a process of its own with its own CUDA context.
SHARD_ARCH = "qwen3-1.7b"
# 18a (qwen3-1.7b ALPT-8 under tp on 1 x 2) is gone: its model at full width
# trains on the ranks in 18b / 18k, ALPT's write-back under tp in 18c-18j,
# and the run's 1,200 s had no room for it beside 18k-18m.
SHARD_BATCH, SHARD_SEQ = 2, 1024
SHARD_CLI_LAYERS, SHARD_CLI_STEPS, SHARD_CLI_BATCH, SHARD_CLI_SEQ = 4, 3, 4, 512  # 18b / 18k
SHARD_MOE_ARCH, SHARD_MOE_LAYERS, SHARD_MOE_STEPS = "mixtral-8x7b", 1, 2  # 18c, 1 x 2
# The CPU tests' bounds (tests/test_torch_sharded_step.py) against the
# one-process step: loss, params after step 1 (where the one-process
# gradient AdamW takes, after the global-norm clip, is at least 1e-6;
# within 2 lr elsewhere), codes differing.
SHARD_LOSS_ATOL, SHARD_RTOL, SHARD_ATOL, SHARD_CODES_FRAC = 1e-4, 1e-4, 1e-6, 0.005
SHARD_LR = 3e-4  # LMTrainerConfig's default
SHARD_TABLE = (151_936, 2_048)  # 18d: qwen3-1.7b's vocab table, two row blocks
SHARD_SP_LAUNCHES = {"lpt_fused_update": 1, "adam_update": 1}  # 18b / 18k's sp steps, a rank
# 18e-18h, ALPT-8 on 1 x 2 beside their twins: SmolLM-135M at full width and
# depth (9/3 heads split mid-head), mamba2-370m at full width with
# SHARD_SSM_LAYERS of its 48 layers (16 of its 32 SSD heads a rank),
# hubert-xlarge at full width with its depth
# cut under tp_sp, and SmolLM again with the guard and trainer.nonfinite at
# step SHARD_GUARD_AT (both ranks skip it).
SHARD_SMOL_ARCH, SHARD_SSM_ARCH, SHARD_ENC_ARCH = "smollm-135m", "mamba2-370m", "hubert-xlarge"
SHARD_FAMILY_STEPS, SHARD_ENC_LAYERS, SHARD_GUARD_AT = 2, 2, 1
SHARD_SSM_LAYERS = 8  # 18f's depth, cut from 48 (phase 13 trains it at full depth)
SHARD_GUARD_LAYERS = 2  # 18h's depth, cut from 30 (18e runs SmolLM at full depth)
# 18i: the seven other embedding methods (8 bits where they quantize) on
# SmolLM-135M at full width with SHARD_METHOD_LAYERS of its 30 layers; 18j:
# deepseek-moe-16b at full width with SHARD_EP_LAYERS of its 28, ALPT-8
# under tp_ep (32 experts a rank) against its one-process EP twin, beside
# the same layers under tp (rank ms only) and an all-to-all probe at the
# layer's send buffer (EP_SEND_SHAPE).  Each 2 steps of 2 x 1,024 on 1 x 2.
SHARD_METHODS = ("qr_lpt", "qr_alpt", "hash", "mixed", "prune", "lsq", "pact")
SHARD_METHOD_LAYERS, SHARD_EP_ARCH, SHARD_EP_LAYERS = 2, "deepseek-moe-16b", 2
# The first step's global gradient norm against the twin's (18i, 18j: the
# CPU tests' bound).
SHARD_NORM_RTOL = 1e-5
# 18b and 18k-18m, one launch of 2 x 2 ranks: 18b / 18k the train lm CLI
# under fsdp_tp (its 1 x 1 run the twin), its checkpoint saved from the fsdp
# shards, then restored under tp_sp (18b) and fsdp_tp_sp (18k) for one step
# through the API each (one CLI run where 18b had its own under tp: the
# run's 1,200 s had no room for both); 18l SmolLM-135M at full width and depth ALPT-8 under dp,
# SHARD_DP_STEPS steps of SHARD_DP_BATCH x SHARD_SEQ (one sequence a rank);
# 18m 18j's deepseek-moe-16b run (its seed and batches) with
# SHARD_GRID_EP_LAYERS of its layers under fsdp_tp_ep and tp_sp_ep, 32
# experts a rank, against one twin of the 2 x 2 grid's EP arithmetic (at
# 18j's 2 layers four ranks ran out of the card's 80 GB: a rank holds its
# 32 experts' params, Adam moments and gradients, 8.9 GB at 2 layers).
SHARD_GRID_POLICY, SHARD_GRID_SP_POLICY = "fsdp_tp", "fsdp_tp_sp"
SHARD_DP_STEPS, SHARD_DP_BATCH, SHARD_GRID_EP_LAYERS = 2, 4, 1
# The 18b / 18k CLI's model flags (a rehearsal on the CPU swaps them for --smoke
# --device cpu, and shard_config for the smoke configs).
SHARD_CLI_MODEL = ["--arch", SHARD_ARCH, "--layers", str(SHARD_CLI_LAYERS)]


def shard_config(arch: str, **overrides):
    """Phase 18's config of ``arch``: the full one, ``overrides`` applied."""
    from repro_torch import configs

    return configs.full_config(arch, **overrides)


def _on_card(torch, dev, what: str, *args):
    """``torch.cuda.<what>(*args)`` when ``dev`` is the card (0 elsewhere)."""
    return getattr(torch.cuda, what)(*args) if dev.type == "cuda" else 0


def shard_batches(torch, vocab: int, steps: int, batch: int, seq: int, seed: int = 17) -> list:
    """Token batches on the host (the ranks move them to the card)."""
    from repro_torch.data.lm_synth import LMTokenStream

    stream = LMTokenStream(vocab, seq, seed=seed)
    out = []
    for i in range(steps):
        full = torch.from_numpy(stream.batch(i, batch))
        out.append({"tokens": full[:, :-1].contiguous(), "labels": full[:, 1:].contiguous()})
    return out


def shard_frames(torch, cfg, steps: int, batch: int, seq: int) -> list:
    """An ``embeds`` arch's batches on the host, as the train CLI makes them
    (``lm_batch``: normal frames, the token stream's labels)."""
    from repro_torch.data.lm_synth import LMTokenStream
    from repro_torch.launch.train import lm_batch

    stream = LMTokenStream(cfg.vocab_size, seq, seed=17)
    return [lm_batch(cfg, stream, i, batch, seq, torch.device("cpu")) for i in range(steps)]


def shard_prune():
    """18i's prune schedule: no warmup, the mask refreshed after every step,
    target 0.5 with damping 0.5 over 1 step (ratio 0.25 after step 1, 0.375
    after step 2); the defaults' 200 warmup steps would keep every weight."""
    from repro_torch.core.pruning import PruneConfig

    return PruneConfig(target_sparsity=0.5, damping=0.5, damping_steps=1, warmup_steps=0,
                       update_every=1)


def shard_run_config(run: dict):
    """A phase-18 run's ``(trainer config, fault plan or None, donate)``: its
    ``trainer`` overrides applied; a guarded run keeps the state before each
    step, so it is not donated."""
    from repro_torch.training import lm_trainer

    tcfg = lm_trainer.LMTrainerConfig(**run.get("trainer", {}))
    at = run.get("guard_at")
    if at is None:
        return tcfg, None, True
    return (dataclasses.replace(tcfg, guard=True),
            fault_plan(("trainer.nonfinite", (at,), False, None)), False)


def code_tables(table) -> list:
    """The code tables of a method's state (one, or a composed table's in
    order)."""
    if hasattr(table, "codes"):
        return [table]
    if isinstance(table, tuple):
        return [t for x in table for t in code_tables(x)]
    return []


def table_summary(torch, cfg, tcfg, table) -> dict:
    """A whole table's state on the host, as phase 18 compares it: an
    integer table's codes and Deltas (a composed table's sub-tables
    flattened in order), or a float-leaf method's leaves
    (``trainable_params``, in ``tree_leaves`` order) and prune's mask."""
    from repro_torch import methods
    from repro_torch.optim import tree_leaves
    from repro_torch.training import lm_trainer

    spec = lm_trainer.embedding_spec_of(cfg, tcfg)
    emb = methods.get(spec.method).trainable_params(table, spec)
    if emb is None:
        subs = code_tables(table)
        return {"codes": torch.cat([t.codes.data.reshape(-1).cpu() for t in subs]),
                "delta": torch.cat([t.step.cpu() for t in subs])}
    mask = getattr(table, "mask", None)
    return {"emb": tuple(x.detach().cpu() for x in tree_leaves(emb)),
            "mask": None if mask is None else mask.cpu()}


def ep_twin(run: dict):
    """An ``ep`` run's one-process twin of its ``data x model`` mesh
    (``tests/_torch_sharded_ranks.py``'s ``ep_twin``: the MoE layers through
    the EP arithmetic of each virtual rank); nothing for another run."""
    from repro_torch.dist import sharding

    if not sharding.policy_from_name(run.get("policy", "tp")).ep:
        return contextlib.nullcontext()
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    import _torch_sharded_ranks

    return _torch_sharded_ranks.ep_twin(run.get("data", 1), run["model"])


# A leaf of more elements is compared on its first SHARD_BLOCK_ROWS rows of
# its second-to-last dim (mixtral's expert stacks, 470 M elements a layer:
# moving them to the host and back would take the phase's budget).
SHARD_COMPARE_MAX, SHARD_BLOCK_ROWS = 1 << 26, 256


def compared(leaf):
    """The part of a group's leaf that phase 18 compares element for element."""
    return leaf if leaf.numel() <= SHARD_COMPARE_MAX else leaf[..., :SHARD_BLOCK_ROWS, :]


def end_layers(params) -> dict:
    """The compared part (:func:`compared`) of the first and the last group
    of every block leaf (views)."""
    return {f"{pos}.{name}": (compared(leaf[0]), compared(leaf[-1]))
            for pos, block in enumerate(params["blocks"])
            for name, leaf in _named_leaves(block)}


def _named_leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def gathered_end_layers(torch, params, specs, mesh, compare_max: int, block_rows: int) -> dict:
    """:func:`end_layers` of the whole params from this rank's shards (the
    groups' dim is never sharded, nor is a compared block's row dim: an
    expert stack splits its experts), on the host."""
    from repro_torch.dist import sharding

    out = {}
    for pos, (block, spec) in enumerate(zip(params["blocks"], specs["blocks"])):
        for (name, leaf), (_, s) in zip(_named_leaves(block), _named_leaves(spec)):
            whole = leaf[0].numel() * math.prod(mesh.shape[a]
                                                for a in sharding.split_axes(s, mesh))
            ends = leaf[[0, -1]]
            if whole > compare_max:
                check(len(s) < 2 or s[-2] is None,
                      f"{name}: a compared block would cut a sharded dim")
                ends = ends[..., :block_rows, :]
            ends = sharding.gather_tree(ends.contiguous(), s, mesh)
            out[f"{pos}.{name}"] = (ends[0].cpu(), ends[1].cpu())
    return out


def sharding_rank(rank: int, world: int, data: int, model: int, directory: str) -> int:
    """One gloo rank of phase 18 (a process of its own on the one card):
    runs each of ``directory/job.pt``'s runs in turn on a ``data x model``
    mesh and writes ``directory/rank<r>.pt``, a result per run (launches,
    fallbacks, peak memory, host ms, the gathered results)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import datetime
    import gc

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch import methods
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import context, sharding
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import lm_trainer

    directory = pathlib.Path(directory)
    job = torch.load(directory / "job.pt", weights_only=False)
    dev = device_mod.resolve(job["device"])
    dist.init_process_group("gloo", init_method=f"file://{directory}/init", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    try:
        mesh = make_host_mesh(data, model)
        clock = [time.perf_counter()]

        def lap(out, name):  # host seconds of each part of the rank's run
            now = time.perf_counter()
            out.setdefault("times", {})[name] = round(now - clock[0], 2)
            clock[0] = now

        outs = []
        for run in job["runs"]:
            out: dict = {}
            gc.collect()
            _on_card(torch, dev, "empty_cache")
            _on_card(torch, dev, "reset_peak_memory_stats", dev)
            ops.reset_kernel_calls()  # the main path starts here ...
            ops.reset_fallbacks()
            if run["kind"] == "probe":  # 18j: gloo's all-to-all at the layer's send buffer
                out["probe"] = all_to_all_probe(torch, dist, dev, mesh.coords["model"], model)
                outs.append(out)
                continue
            cfg = run["cfg"]
            tcfg, plan, donate = shard_run_config(run)
            if run["kind"] == "train":
                pol = sharding.policy_from_name(run.get("policy", "tp"), model_size=model,
                                                data_size=data)
                with plan_installed(plan), context.use(mesh, pol):
                    state = lm_trainer.init_state(cfg, tcfg, seed=run["seed"], device=dev)
                    step = lm_trainer.wrap_host_refresh(  # prune's mask; else the identity
                        lm_trainer.make_train_step(cfg, tcfg, donate=donate), cfg, tcfg)
                    specs = lm_trainer._shards(cfg, tcfg).specs
                lap(out, "init")
                losses, wall, skipped = [], [], []
                for i, b in enumerate(run["batches"]):
                    batch = {k: v.to(dev) for k, v in b.items()}
                    t0 = time.perf_counter()
                    before = state if plan is not None else None  # (a guarded step's)
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
                    wall.append((time.perf_counter() - t0) * 1e3)
                    if plan is not None:
                        skipped.append(int(m["guard_skipped"]))
                        if skipped[-1]:  # this rank's shards as they were before the step
                            out["kept"] = shards_same(torch, before, state)
                    if i == 0:
                        out["grad_norm"] = float(m["grad_norm"])
                        if run["compare"] is not None:
                            with context.use(mesh, pol):
                                out["layers"] = gathered_end_layers(
                                    torch, state.params, specs.params, mesh, *run["compare"])
                                if not methods.get(cfg.embedding_method).is_integer_table:
                                    whole = sharding.gather_tree(state.table, specs.table, mesh)
                                    out["emb1"] = table_summary(torch, cfg, tcfg, whole)["emb"]
                                    del whole
                _on_card(torch, dev, "synchronize")
                out.update(launches=ops.kernel_calls(), fallbacks=ops.fallbacks())  # ... and here
                del before
                lap(out, "steps")
                if run["compare"] is not None:
                    with context.use(mesh, pol):
                        table = sharding.gather_tree(state.table, specs.table, mesh)
                    out["table"] = table_summary(torch, cfg, tcfg, table)
                    del table
                out.update(losses=losses, wall=wall, skipped=skipped)
                lap(out, "gather")
            else:  # 18b / 18k: the CLI on the launcher's group, then sp steps through the API
                real_save = lm_trainer.save

                def save_and_sum(manager, cfg_, state_, *args, **kwargs):
                    # The live shards just before the CLI saves them (the
                    # newest save wins).
                    due = kwargs.get("force") or manager.should_save(state_.step)
                    sums = state_checksums(torch, state_) if due else None
                    saved = real_save(manager, cfg_, state_, *args, **kwargs)
                    if saved:
                        out["live_sums"] = sums
                    return saved

                lm_trainer.save = save_and_sum
                try:
                    rc, report, err = cli_json(train_mod.main, run["argv"])
                finally:
                    lm_trainer.save = real_save
                check(rc == 0, f"{run['label']} rank {rank}: train lm exited {rc}: "
                               f"{err[-2000:]}")
                out.update(report=report, launches=ops.kernel_calls(),
                           fallbacks=ops.fallbacks())
                lap(out, "cli")
                out["sp"] = {}
                for sp, b in run["sp_steps"]:  # the checkpoint restored under sp, one step
                    pol = sharding.policy_from_name(sp, model_size=model, data_size=data)
                    with context.use(mesh, pol):
                        state = lm_trainer.restore(CheckpointManager(run["ckpt"]), cfg, tcfg,
                                                   device=dev)
                        step = lm_trainer.make_train_step(cfg, tcfg)
                    sums = state_checksums(torch, state)  # the checkpoint on this mesh
                    lap(out, f"{sp} restore")
                    ops.reset_kernel_calls()
                    state, m = step(state, {k: v.to(dev) for k, v in b.items()})
                    _on_card(torch, dev, "synchronize")
                    out["sp"][sp] = {"sums": sums, "loss": float(m["loss"]),
                                     "launches": ops.kernel_calls()}
                    lap(out, f"{sp} step")
            out["peak"] = _on_card(torch, dev, "max_memory_allocated", dev)
            outs.append(out)
            del state, step
        torch.save(outs, directory / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def shards_same(torch, a, b) -> bool:
    """Two LM states' params, Adam moments and table equal, on the card."""
    from repro_torch.optim import tree_leaves

    la = tree_leaves(a.params) + a.opt.mu + a.opt.nu
    lb = tree_leaves(b.params) + b.opt.mu + b.opt.nu
    return (all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))
            and torch.equal(a.table.codes.data, b.table.codes.data)
            and all(torch.equal(getattr(a.table, k), getattr(b.table, k))
                    for k in ("step", "mu", "nu")))


def run_ranks(torch, directory: pathlib.Path, job: dict, data: int, model: int,
              label: str) -> list:
    """``data x model`` processes of :func:`sharding_rank` on ``job``: any rank
    that exits non-zero fails the run.  Returns the ranks' outputs (a list
    of per-run results each)."""
    torch.save(job, directory / "job.pt")
    world = data * model
    # Four ranks share one card: segments that grow in place keep a rank's
    # reserved memory near what it holds.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke, sys; "
         f"sys.exit(chip_smoke.sharding_rank({r}, {world}, {data}, {model}, "
         f"{str(directory)!r}))"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        failed = {}
        for r, p in enumerate(procs):
            _, err_text = p.communicate(timeout=600)
            if p.returncode != 0:
                failed[r] = f"exited {p.returncode}: {err_text[-2000:]}"
        check(not failed, f"{label}: " + " | ".join(f"rank {r} {e}" for r, e in failed.items()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(directory / f"rank{r}.pt", weights_only=False) for r in range(world)]


def close_layers(torch, got: dict, want: dict, grads: dict, lr: float,
                 clip: float) -> tuple[float, int, int]:
    """The CPU tests' param bound on the first and last layers: within rtol /
    atol where the one-process gradient AdamW takes (``grads`` times the
    global-norm ``clip`` factor) is at least 1e-6, within 2 lr elsewhere:
    AdamW's first step is ``lr g / (|g| + 1e-8)``, so near eps the last
    bits of a reordered sum move the update by up to lr.  Returns (max abs
    difference, elements under the eps guard, those of them whose gradient
    is at least 1e-6 before the clip)."""
    worst, guarded, clipped = 0.0, 0, 0
    for key, pair in want.items():
        for x, y, g in zip(got[key], pair, grads[key]):
            d = (x - y).abs()
            ok = d <= SHARD_ATOL + SHARD_RTOL * y.abs()
            conditioned = g.abs() * clip >= 1e-6
            check(bool((ok | ~conditioned).all()) and float(d.max()) <= 2 * lr,
                  f"layer {key}: differs from the one-process step by {float(d.max())}")
            worst = max(worst, float(d.max()))
            guarded += int((~ok).sum())
            clipped += int((~ok & (g.abs() >= 1e-6)).sum())
    return worst, guarded, clipped


def shard_twin(torch, dev, run: dict) -> dict:
    """The one-process run of a phase-18 train run (the same seed, batches,
    noise and trainer config, a guarded run's fault plan; kernels on):
    per-step losses (and the guard's verdicts), the first and last layers
    after step 1 and their step-1 gradients with the step's clip factor,
    the table at the end, on the host; the card freed after it."""
    import gc

    from repro_torch.optim import tree_leaves, tree_like
    from repro_torch.training import lm_trainer

    t0_twin = time.perf_counter()
    cfg, batches, label = run["cfg"], run["batches"], run["label"]
    tcfg, plan, donate = shard_run_config(run)
    state = lm_trainer.init_state(cfg, tcfg, seed=run["seed"], device=dev)
    first = {k: v.to(dev) for k, v in batches[0].items()}
    with ep_twin(run):
        g_emb, g_params = lm_trainer.make_grad_fn(cfg, tcfg)(state, first)[1]
    grads = end_layers(tree_like(state.params, g_params))
    grads = {k: (a.cpu(), b.cpu()) for k, (a, b) in grads.items()}
    # A float-leaf table's own gradient (its Adam step is not clipped).
    emb_grads = (None if isinstance(g_emb, torch.Tensor)
                 else tuple(g.cpu() for g in tree_leaves(g_emb)))
    norm = float(torch.sqrt(sum(torch.sum(torch.square(g)) for g in g_params)))
    clip = min(1.0, tcfg.grad_clip / (norm + 1e-12))  # clip_by_global_norm's factor
    del g_params, g_emb
    with plan_installed(plan):
        step = lm_trainer.wrap_host_refresh(
            lm_trainer.make_train_step(cfg, tcfg, donate=donate), cfg, tcfg)
    losses, wall, layers, skipped = [], [], None, []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        with ep_twin(run):
            state, m = step(state, {k: v.to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
        wall.append((time.perf_counter() - t0) * 1e3)
        if plan is not None:
            skipped.append(int(m["guard_skipped"]))
        if i == 0:
            grad_norm = float(m["grad_norm"])
            layers = {k: (a.to("cpu", copy=True), b_.to("cpu", copy=True))
                      for k, (a, b_) in end_layers(state.params).items()}  # the step is donated
            emb1 = None if emb_grads is None else table_summary(torch, cfg, tcfg,
                                                                state.table)["emb"]
    _on_card(torch, dev, "synchronize")
    peak = _on_card(torch, dev, "max_memory_allocated", dev)
    out = {"losses": losses, "wall": wall, "layers": layers, "grads": grads, "peak": peak,
           "table": table_summary(torch, cfg, tcfg, state.table), "emb_grads": emb_grads,
           "emb1": emb1,
           "grad_norm": grad_norm, "skipped": skipped, "clip": clip}
    del state, step
    gc.collect()
    _on_card(torch, dev, "empty_cache")
    log(f"[sharding] {label}: one-process twin, losses {losses}, host clock "
        f"{statistics.mean(wall[1:]):.1f} ms/step (first {wall[0]:.1f}), peak {peak} B, "
        f"{time.perf_counter() - t0_twin:.1f}s")
    return out


def compare_shard_run(torch, twin: dict, ranks: list, run: dict, lr: float) -> None:
    """A mesh run against its twin within the CPU tests' bounds (a step the
    guard skipped has a NaN loss on both sides); a guarded run's verdicts
    the twin's on every rank, and every rank's shards kept through a skip;
    every rank's whole table and its gathered first and last layers the
    same (replicas: a replicated table's, dp's whole params); an
    integer table's codes, or a float-leaf table's leaves after step 1
    under the params bound (their Adam step unclipped); prune's last mask
    bitwise the one-process refresh of the ranks' own whole table, and
    differing from the twin's on at most SHARD_CODES_FRAC (its weights
    differ where AdamW's first step turns a gradient near eps into up to
    lr); ``run["check_norm"]``: the first step's gradient norm within
    SHARD_NORM_RTOL."""
    from repro_torch.core import pruning
    from repro_torch.optim import tree_leaves

    label, r0 = run["label"], ranks[0]
    pairs = list(zip(r0["losses"], twin["losses"]))
    gaps = [abs(a - b) for a, b in pairs if not (math.isnan(a) and math.isnan(b))]
    check(len(pairs) == len(twin["losses"]) and gaps and max(gaps) < SHARD_LOSS_ATOL,
          f"{label}: losses {r0['losses']} against the twin's {twin['losses']}")
    norm_gap = abs(r0["grad_norm"] - twin["grad_norm"]) / twin["grad_norm"]
    check(not run.get("check_norm") or norm_gap <= SHARD_NORM_RTOL,
          f"{label}: grad norm {r0['grad_norm']} against the twin's {twin['grad_norm']}")
    for r, o in enumerate(ranks):
        check(o["skipped"] == twin["skipped"] and o.get("kept", True),
              f"{label} rank {r}: guard verdicts {o['skipped']} (the twin's {twin['skipped']}), "
              f"shards kept through the skip: {o.get('kept')}")
        check(all(a is b or torch.equal(a, b) for a, b in zip(
            tree_leaves(o["table"]), tree_leaves(r0["table"]), strict=True)),
              f"{label} rank {r}: its table differs from rank 0's")
        check(all(torch.equal(a, b) for k, pair in r0["layers"].items()
                  for a, b in zip(o["layers"][k], pair)),
              f"{label} rank {r}: its first and last layers (gathered) differ from rank 0's")
    worst, guarded, clipped = close_layers(torch, r0["layers"], twin["layers"], twin["grads"],
                                           lr, twin["clip"])
    got, want = r0["table"], twin["table"]
    if "codes" in want:
        frac = float((got["codes"] != want["codes"]).float().mean())
        check(frac <= SHARD_CODES_FRAC, f"{label}: {frac:.4%} of the codes differ from the "
                                        f"twin's")
        table = (f"codes differing {frac:.6%}, Delta within "
                 f"{float((got['delta'] - want['delta']).abs().max()):.3g}")
    else:  # the leaves after step 1, the step the gradients are of
        t_worst, t_guarded, _ = close_layers(torch, {"emb": r0["emb1"]}, {"emb": twin["emb1"]},
                                             {"emb": twin["emb_grads"]}, lr, 1.0)
        t_end = max(float((a - b).abs().max()) for a, b in zip(got["emb"], want["emb"]))
        table = (f"table leaves after step 1 within {t_worst:.3g} ({t_guarded} elements past "
                 f"rtol, each with a one-process gradient under 1e-6), at the end within "
                 f"{t_end:.3g}")
        if want["mask"] is not None:
            cfg = run["trainer"]["prune"]
            steps = len(run["batches"])
            (w,), (w_twin,) = got["emb"], want["emb"]
            own = pruning.update_mask(pruning.PruneState(w, got["mask"], steps), cfg).mask
            check(torch.equal(own, got["mask"]), f"{label}: the ranks' mask is not the "
                                                 f"one-process refresh of their whole table")
            diff = got["mask"] != want["mask"]
            check(float(diff.float().mean()) <= SHARD_CODES_FRAC,
                  f"{label}: the mask differs in {int(diff.sum())} elements from the twin's")
            ratio = pruning.prune_ratio(cfg, steps)
            table += (f"; the mask bitwise the refresh of the ranks' whole table (threshold "
                      f"{float(pruning.quantile_linear(w.abs(), ratio)):.9g}, the twin's "
                      f"{float(pruning.quantile_linear(w_twin.abs(), ratio)):.9g}), differing "
                      f"from the twin's in {int(diff.sum())} of {diff.numel()} elements (|w| "
                      f"there {w[diff].abs().tolist()[:8]}, the twin's "
                      f"{w_twin[diff].abs().tolist()[:8]}), sparsity "
                      f"{1.0 - float(got['mask'].float().mean()):.6f}")
    log(f"[sharding] {label}: per-step loss gaps {gaps}; grad norm gap {norm_gap:.3g} "
        f"(relative); first and last layers after step 1 "
        f"within {worst:.3g} ({guarded} elements past rtol {SHARD_RTOL} / atol {SHARD_ATOL}, "
        f"each with a one-process gradient under 1e-6 after the clip by {twin['clip']:.6g}, "
        f"{clipped} of them at least 1e-6 before it); {table}")



def shard_launches(method: str, bits: int, steps: int) -> dict:
    """A rank's launches in a run of ``steps`` from its init: an integer
    table's init through sr_round (one a sub-table: qr_* two) and its
    write-back (ALPT's sr_round, LPT's lpt_fused_update); a composed table's
    dense form read through dequant_gather (qr_*: each sub-table for the
    table and for the product rule's factors, 4 a step; mixed's one group 1);
    a float-leaf table (hash, prune, lsq, pact) steps by adam_update beside
    the params'."""
    if method in ("fp", "hash", "prune", "lsq", "pact"):
        return {"adam_update": 2 * steps}
    subs = 2 if method.startswith("qr_") else 1
    packed = "_packed" if bits < 8 else ""
    write_back = "sr_round" if method in ("alpt", "qr_alpt") else "lpt_fused_update" + packed
    want = {"sr_round": subs, "adam_update": steps}
    want[write_back] = want.get(write_back, 0) + subs * steps
    gathers = {"qr_lpt": 4, "qr_alpt": 4, "mixed": 1}.get(method, 0) * steps
    if gathers:
        want["dequant_gather" + packed] = gathers
    return want


def shard_trains(torch, dev, directory: pathlib.Path, runs: list, model: int):
    """18c, 18e-18j: each run's twin (in turn, the card freed after
    each), then one launch of ``1 x model`` ranks that run them in turn from
    the same seeds and batches (each rank its shard of the one-process init,
    the noise the rows' slice of the one-process draw), compared.  A run is
    a dict of ``label``, ``cfg``, ``seed``, ``batches``, and optionally its
    ``policy`` (tp; an ep run's twin is the one-process EP twin),
    ``trainer`` (LMTrainerConfig overrides), ``guard_at`` (the step
    ``trainer.nonfinite`` fires on under the guard), ``twin`` (False: the
    ranks' times only) and ``check_norm`` (the gradient norm against the
    twin's); or ``{"kind": "probe"}``, 18j's all-to-all probe.  Returns the
    ranks' launches."""
    twins = []
    for run in runs:
        _on_card(torch, dev, "reset_peak_memory_stats", dev)
        twins.append(shard_twin(torch, dev, dict(run, model=model))
                     if run.get("kind", "train") == "train" and run.get("twin", True) else None)
    t0 = time.perf_counter()
    ranks = run_ranks(torch, directory, shard_job(dev, runs), 1, model, "18c / 18e-18j")
    ranks_s = time.perf_counter() - t0
    total = {}
    for i, (run, twin) in enumerate(zip(runs, twins)):
        outs = [r[i] for r in ranks]
        if run.get("kind") == "probe":
            log(f"[sharding] 18j gloo all_to_all_single on the card, {EP_SEND_SHAPE} float32 "
                f"a rank: {[o['probe'] for o in outs]}; {card_name()}")
            check(all(o["probe"].get("all_to_all_single equal") for o in outs),
                  f"18j all-to-all probe: {[o['probe'] for o in outs]}")
            continue
        total = added(total, check_train_run(torch, run, twin, outs, f"1 x {model}"))
    log(f"[sharding] 18c / 18e-18j: the ranks' processes {ranks_s:.1f}s; {card_name()}")
    return total


def shard_job(dev, runs: list) -> dict:
    """The ranks' job: the runs, each train run with its compared layers'
    limits (none for a run without a twin)."""
    return {"device": dev.type, "runs": [
        {"kind": "train", "compare": (SHARD_COMPARE_MAX, SHARD_BLOCK_ROWS)
         if run.get("twin", True) else None, **run} for run in runs]}


def check_train_run(torch, run: dict, twin: dict | None, outs: list, grid: str) -> dict:
    """A train run's launches on every rank (:func:`shard_launches`, no
    fallback) and, beside its twin, :func:`compare_shard_run`; its ms a step
    and peak memory a rank logged.  Returns the ranks' launches."""
    label, cfg, batches = run["label"], run["cfg"], run["batches"]
    want = shard_launches(cfg.embedding_method, cfg.embedding_bits, len(batches))
    total = {}
    for r, o in enumerate(outs):
        check(o["launches"] == want and o["fallbacks"] == [],
              f"{label} rank {r}: launches {o['launches']} (expected {want}), fallbacks "
              f"{o['fallbacks']}")
        total = added(total, o["launches"])
    if twin is not None:
        compare_shard_run(torch, twin, outs, run, SHARD_LR)
    tokens = tuple(batches[0]["labels"].shape)
    log(f"[sharding] {label}: {grid} gloo ranks on one card, {len(batches)} steps of "
        f"{tokens[0]} x {tokens[1]} tokens: losses {outs[0]['losses']}; per rank: host clock "
        + ", ".join(f"{statistics.mean(o['wall'][1:]):.1f} ms/step (first {o['wall'][0]:.1f})"
                    for o in outs)
        + f"; peak memory {[o['peak'] for o in outs]} B"
        + ("" if twin is None else f" (the twin's {twin['peak']} B)")
        + f"; launches {[o['launches'] for o in outs]}; rank 0 {outs[0]['times']} s; "
        f"{card_name()}")
    return total


def shard_cli_argv() -> list:
    """18b's (and 18k's) ``train lm`` arguments at 1 x 1."""
    return ["lm", *SHARD_CLI_MODEL, "--embedding-method", "lpt", "--steps",
            str(SHARD_CLI_STEPS), "--batch", str(SHARD_CLI_BATCH), "--seq", str(SHARD_CLI_SEQ),
            "--log-every", "0"]


def shard_cli_run(torch, directory: pathlib.Path) -> dict:
    """18b / 18k, a ranks' run: ``train lm`` at 2 x 2 under fsdp_tp
    (checkpointed into ``directory/ckpt`` at its last step), then that
    checkpoint restored under tp_sp (18b) and under fsdp_tp_sp (18k), and
    one step through the API under each, each on a batch of its own seed."""
    cfg = shard_config(SHARD_ARCH, n_layers=SHARD_CLI_LAYERS, embedding_method="lpt")
    ckpt = directory / "ckpt"

    def batch(seed):
        return shard_batches(torch, cfg.vocab_size, 1, SHARD_CLI_BATCH, SHARD_CLI_SEQ,
                             seed=seed)[0]

    return {"kind": "cli", "label": f"18b / 18k (train lm --policy {SHARD_GRID_POLICY})",
            "cfg": cfg, "ckpt": str(ckpt), "policy": SHARD_GRID_POLICY,
            "sp_steps": [("tp_sp", batch(23)), (SHARD_GRID_SP_POLICY, batch(29))],
            "argv": shard_cli_argv() + ["--mesh-data", "2", "--mesh-model", "2", "--policy",
                                        SHARD_GRID_POLICY, "--ckpt-dir", str(ckpt),
                                        "--ckpt-every", str(SHARD_CLI_STEPS)]}


def shard_cli_one(torch, dev) -> tuple[dict, dict]:
    """18b's (and 18k's) ``train lm`` at 1 x 1 in this process: its
    launches and its report (with the seconds it took)."""
    import gc

    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_mod

    t0 = time.perf_counter()
    ops.reset_kernel_calls()
    rc, one, err = cli_json(train_mod.main, shard_cli_argv())
    check(rc == 0, f"18b train lm at 1 x 1 exited {rc}: {err[-2000:]}")
    one["seconds"] = time.perf_counter() - t0
    launched = ops.kernel_calls()
    gc.collect()
    _on_card(torch, dev, "empty_cache")
    return launched, one


def check_cli_run(torch, dev, run: dict, one: dict, ranks: list) -> dict:
    """18b / 18k: the 2 x 2 CLI's losses against the 1 x 1 run's within
    SHARD_LOSS_ATOL step for step, its launches (and each sp step's) on
    every rank; its checkpoint (written from the gathered shards) restored
    in this process and cut to each rank's coordinates equals, in every
    leaf, the live shards each rank saved (under the CLI's policy) and the
    shards each rank restored on the grid under each sp policy; each sp
    step's loss against its one-process twin's from that state.  Returns
    the ranks' launches."""
    import gc

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.training import lm_trainer

    label, cfg = run["label"], run["cfg"]
    report = ranks[0]["report"]
    gaps = [abs(a - b) for a, b in zip(report["losses"], one["losses"])]
    check(report["mesh_data"] == 2 and report["mesh_model"] == 2
          and report["policy"] == run["policy"]
          and len(gaps) == SHARD_CLI_STEPS and max(gaps) < SHARD_LOSS_ATOL,
          f"{label} losses at 2 x 2 {report['losses']} against 1 x 1 {one['losses']}")
    want = shard_launches("lpt", 8, SHARD_CLI_STEPS)
    total = {}
    for r, o in enumerate(ranks):
        check(o["launches"] == want and o["fallbacks"] == []
              and all(v["launches"] == SHARD_SP_LAUNCHES for v in o["sp"].values()),
              f"{label} rank {r}: launches {o['launches']} (expected {want}), sp steps "
              f"{ {k: v['launches'] for k, v in o['sp'].items()} }, fallbacks {o['fallbacks']}")
        total = added(total, o["launches"], *(v["launches"] for v in o["sp"].values()))
    # The CLI's checkpoint restored in one process and cut to each rank's
    # coordinates: every leaf the live shard the rank saved (so a faulty
    # gather or write shows), and the shards the rank restored on the grid.
    t_checks = time.perf_counter()
    tcfg = lm_trainer.LMTrainerConfig()
    state = lm_trainer.restore(CheckpointManager(run["ckpt"]), cfg, tcfg, device=dev)
    for r, o in enumerate(ranks):
        mesh = HostMesh(shape={"data": 2, "model": 2}, coords={"data": r // 2, "model": r % 2},
                        groups={"data": None, "model": None})
        for name in (run["policy"], *o["sp"]):
            pol = sharding.policy_from_name(name, model_size=2, data_size=2)
            mine = sharding.shard_tree(state, lm_trainer.state_specs(cfg, tcfg, mesh, pol), mesh)
            sums = state_checksums(torch, mine)
            del mine
            if name == run["policy"]:
                check("live_sums" in o and sums == o["live_sums"],
                      f"{label} rank {r}: the one-process restore's {name} shard differs from "
                      f"the live shard it saved")
            else:
                check(sums == o["sp"][name]["sums"],
                      f"{label} rank {r}: its {name} shard of the checkpoint differs from the "
                      f"one-process restore's")
    # Each sp step's one-process twin from the same state.
    steps = []
    step = lm_trainer.make_train_step(cfg, tcfg)
    for name, b in run["sp_steps"]:
        _, m = step(state, {k: v.to(dev) for k, v in b.items()})
        gap = abs(float(m["loss"]) - ranks[0]["sp"][name]["loss"])
        check(gap < SHARD_LOSS_ATOL, f"{label} {name} step loss {ranks[0]['sp'][name]['loss']} "
                                     f"against the one-process {float(m['loss'])}")
        steps.append(f"one {name} step (loss {ranks[0]['sp'][name]['loss']}, one-process "
                     f"{float(m['loss'])}, gap {gap:.3g})")
    del state, step
    gc.collect()
    _on_card(torch, dev, "empty_cache")
    log(f"[sharding] {label} train lm {SHARD_ARCH} (d = 2,048, {SHARD_CLI_LAYERS} of 28 layers) "
        f"LPT-8 under {run['policy']}, {SHARD_CLI_STEPS} steps of {SHARD_CLI_BATCH} x "
        f"{SHARD_CLI_SEQ}: 1 x 1 {one['losses']} ({one['seconds']:.1f}s), 2 x 2 "
        f"{report['losses']} (gaps {gaps}); 2 x 2 rank 0 {report['ms_per_step']:.1f} ms/step "
        f"after the first; its checkpoint restored in one process and cut to each rank equals, "
        f"in every leaf, the live shards each rank saved and the shards each rank restored on "
        f"the grid under {', '.join(o['sp'])}; {'; '.join(steps)}; peak memory per rank "
        f"{[o['peak'] for o in ranks]} B; rank 0 {ranks[0]['times']} s; the checks here "
        f"{time.perf_counter() - t_checks:.1f}s; {card_name()}")
    return total


def shard_grid(torch, dev, directory: pathlib.Path, ep_run: dict) -> dict:
    """18b and 18k-18m in one launch of 2 x 2 ranks: 18b / 18k
    :func:`shard_cli_run` (the CLI under fsdp_tp, then a tp_sp and an
    fsdp_tp_sp step from its checkpoint), held by :func:`check_cli_run`
    against the 1 x 1 run of the same CLI (:func:`shard_cli_one`); 18l SmolLM-135M at full width
    and depth under dp, one sequence a rank, its params bitwise equal on
    the four ranks; 18m ``ep_run`` (18j's deepseek-moe-16b run: its seed
    and batches) with SHARD_GRID_EP_LAYERS layers under fsdp_tp_ep and
    tp_sp_ep against one EP twin,
    18j's arithmetic on the 2 x 2 grid (each data row's load-balance loss
    its own, as on the ranks).  The 1 x 1 CLI and the twins run first, the
    card freed after each.  Returns the ranks' launches (and the 1 x 1
    CLI's)."""
    total, one = shard_cli_one(torch, dev)
    smol = shard_config(SHARD_SMOL_ARCH)
    dp_run = {"label": f"18l {SHARD_SMOL_ARCH} ALPT-8 dp, one sequence a rank", "cfg": smol,
              "seed": 201, "policy": "dp", "check_norm": True,
              "batches": shard_batches(torch, smol.vocab_size, SHARD_DP_STEPS, SHARD_DP_BATCH,
                                       SHARD_SEQ)}
    moe = shard_config(SHARD_EP_ARCH, n_layers=SHARD_GRID_EP_LAYERS)
    moe_runs = [dict(ep_run, cfg=moe, policy=pol, check_norm=True,
                     label=f"18m {SHARD_EP_ARCH} ALPT-8 {pol}, {SHARD_GRID_EP_LAYERS} of 28 "
                           "layers, 32 experts a rank")
                for pol in ("fsdp_tp_ep", "tp_sp_ep")]
    twins = []
    for run in (dp_run, moe_runs[0]):
        _on_card(torch, dev, "reset_peak_memory_stats", dev)
        twins.append(shard_twin(torch, dev, dict(run, model=2, data=2)))
    cli = shard_cli_run(torch, directory)
    runs = [dp_run, *moe_runs]
    job = shard_job(dev, runs)
    job["runs"].insert(0, cli)
    t0 = time.perf_counter()
    ranks = run_ranks(torch, directory, job, 2, 2, "18b, 18k-18m")
    ranks_s = time.perf_counter() - t0
    total = added(total, check_cli_run(torch, dev, cli, one, [r[0] for r in ranks]))
    for i, (run, twin) in enumerate(zip(runs, [*twins, twins[1]]), start=1):
        total = added(total, check_train_run(torch, run, twin, [r[i] for r in ranks], "2 x 2"))
    log(f"[sharding] 18b, 18k-18m: the ranks' processes {ranks_s:.1f}s; {card_name()}")
    return total


def shard_kernels(torch, dev, err: dict) -> None:
    """18d: sr_round and lpt_fused_update(_packed) on each rank's rows of
    qwen3-1.7b's table (SHARD_TABLE, two row blocks) equal the one-process
    call's rows bitwise, given the same operands (rung 1)."""
    from repro_torch.core import quant
    from repro_torch.core.codestore import CodeStore
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(180)
    n, d = SHARD_TABLE
    w = torch.randn(n, d, generator=g, device=dev) * 0.02
    step = quant.init_step_size(w, 8)
    noise = quant.sr_noise(g, (n, d))
    upd = torch.randn(n, d, generator=g, device=dev)
    half = n // 2
    full = ops.sr_round(w, step, noise, 8)
    for r in range(2):
        rows = slice(r * half, (r + 1) * half)
        got = ops.sr_round(w[rows].contiguous(), step[rows].contiguous(),
                           noise[rows].contiguous(), 8)
        check(torch.equal(got, full[rows]), f"18d sr_round: rank {r}'s rows differ")
    for bits in (8, 4):
        codes = CodeStore.from_codes(torch.clamp(full, *quant.code_bounds(bits)), bits)
        whole = ops.lpt_update(codes, step, upd, noise, 3e-4, bits, weight_decay=5e-8)
        for r in range(2):
            rows = slice(r * half, (r + 1) * half)
            shard = CodeStore(data=codes.data[rows].contiguous(), bits=codes.bits, n=half, d=d,
                              packed=codes.packed)
            got = ops.lpt_update(shard, step[rows].contiguous(), upd[rows].contiguous(),
                                 noise[rows].contiguous(), 3e-4, bits, weight_decay=5e-8)
            check(torch.equal(got.data, whole.data[rows]),
                  f"18d lpt_fused_update bits={bits}: rank {r}'s rows differ")
    _on_card(torch, dev, "synchronize")
    log(f"[sharding] 18d sr_round (bits 8) and lpt_fused_update / lpt_fused_update_packed "
        f"(bits 8, 4) on each of two row blocks of {n} x {d} equal the one-process call's rows "
        "bitwise")
    del w, noise, upd, full


def sharding_phase(torch, dev, err: dict) -> dict:
    """Phase 18: on 1 x 2, 18c mixtral-8x7b ALPT-8 at 1 layer with its
    experts over 2 ranks, 18e SmolLM-135M (heads split mid-head) at full
    width and depth, 18f mamba2-370m at full width with SHARD_SSM_LAYERS of
    its layers, 18g hubert-xlarge at full width under tp_sp, 18h SmolLM
    guarded with a poisoned step, 18i SmolLM at 2 layers with each of the
    seven other methods, 18j deepseek-moe-16b at 2 layers under tp_ep (and
    tp, and the all-to-all probe); then one launch of 2 x 2 ranks: 18b / 18k
    the train lm CLI under fsdp_tp (its checkpoint, a tp_sp and an
    fsdp_tp_sp step from it), 18l SmolLM-135M under dp, 18m 18j's model
    under fsdp_tp_ep and tp_sp_ep; 18d the shard-local kernels.
    Returns the ranks' launches (and the 1 x 1 CLI's)."""
    import gc
    import tempfile

    gc.collect()
    _on_card(torch, dev, "empty_cache")
    t_phase = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        root = pathlib.Path(tmp)
        for sub in ("a", "b"):
            (root / sub).mkdir()
        mixtral = shard_config(SHARD_MOE_ARCH, n_layers=SHARD_MOE_LAYERS)
        smol = shard_config(SHARD_SMOL_ARCH)
        ssm = shard_config(SHARD_SSM_ARCH, n_layers=SHARD_SSM_LAYERS)
        enc = shard_config(SHARD_ENC_ARCH, n_layers=SHARD_ENC_LAYERS)

        def tokens(cfg, steps):
            return shard_batches(torch, cfg.vocab_size, steps, SHARD_BATCH, SHARD_SEQ)

        fam = SHARD_FAMILY_STEPS
        runs = [
            {"label": "18c mixtral-8x7b ALPT-8 tp, 4 experts a rank", "cfg": mixtral,
             "seed": 183, "batches": tokens(mixtral, SHARD_MOE_STEPS)},
            {"label": "18e smollm-135m ALPT-8 tp, 9/3 heads split mid-head", "cfg": smol,
             "seed": 185, "batches": tokens(smol, fam)},
            {"label": f"18f mamba2-370m ALPT-8 tp, 16 of 32 SSD heads a rank, "
                      f"{SHARD_SSM_LAYERS} of 48 layers", "cfg": ssm,
             "seed": 186, "batches": tokens(ssm, fam)},
            {"label": f"18g hubert-xlarge ALPT-8 tp_sp, {SHARD_ENC_LAYERS} of 48 layers",
             "cfg": enc, "seed": 187, "policy": "tp_sp",
             "batches": shard_frames(torch, enc, fam, SHARD_BATCH, SHARD_SEQ)},
            {"label": f"18h smollm-135m ALPT-8 tp, {SHARD_GUARD_LAYERS} of 30 layers, guarded, "
                      f"trainer.nonfinite at step {SHARD_GUARD_AT}",
             "cfg": shard_config(SHARD_SMOL_ARCH, n_layers=SHARD_GUARD_LAYERS), "seed": 188,
             "guard_at": SHARD_GUARD_AT, "batches": tokens(smol, fam)}]
        for i, method in enumerate(SHARD_METHODS):
            cfg = shard_config(SHARD_SMOL_ARCH, n_layers=SHARD_METHOD_LAYERS,
                               embedding_method=method, embedding_bits=8)
            runs.append({"label": f"18i smollm-135m {method} tp, {SHARD_METHOD_LAYERS} of 30 "
                                  f"layers", "cfg": cfg, "seed": 190 + i, "check_norm": True,
                         "trainer": {"prune": shard_prune()} if method == "prune" else {},
                         "batches": tokens(cfg, fam)})
        moe = shard_config(SHARD_EP_ARCH, n_layers=SHARD_EP_LAYERS)
        ep_batches = tokens(moe, fam)
        ep_run = {"label": f"18j {SHARD_EP_ARCH} ALPT-8 tp_ep, {SHARD_EP_LAYERS} of 28 layers, "
                           "32 experts a rank", "cfg": moe, "seed": 199, "policy": "tp_ep",
                  "check_norm": True, "batches": ep_batches}
        runs += [
            ep_run,
            {"label": f"18j {SHARD_EP_ARCH} ALPT-8 tp, the same layers", "cfg": moe,
             "seed": 199, "twin": False, "batches": ep_batches},
            {"kind": "probe"}]
        total = added(total, shard_trains(torch, dev, root / "a", runs, 2))
        log(f"[sharding] 18c, 18e-18j: {time.perf_counter() - t_phase:.1f}s")
        total = added(total, shard_grid(torch, dev, root / "b", ep_run))
        log(f"[sharding] 18b, 18k-18m: {time.perf_counter() - t_phase:.1f}s into phase 18")
    shard_kernels(torch, dev, err)
    gc.collect()
    _on_card(torch, dev, "empty_cache")
    log(f"[sharding] phase 18: launches {total}; {time.perf_counter() - t_phase:.1f}s; "
        f"{card_name()}")
    return total


def sharding_only() -> int:
    """Phase 18 alone:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.sharding_only())"``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = device_mod.resolve("cuda")
    for lib in _build.build():
        _build.library(lib)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; build "
        f"{time.perf_counter() - t_start:.1f}s")
    err = {k: 0.0 for k in KERNELS}
    launches = sharding_phase(torch, dev, err)
    check(set(launches) <= set(KERNELS), f"phase 18 launched {launches}")
    log(f"[chip_smoke] phase 18 alone in {time.perf_counter() - t_start:.1f}s")
    return 0


OBS_STEPS = 3  # 14a: ALPT-8 steps, untraced and traced
OBS_CACHED_STEPS = STORAGE_STEPS  # 14c: a cached ALPT-8 run, traced (phase 11's: it writes back)
OBS_LM_NEW = 8  # 14d: new tokens per request
OBS_SLACK = 0.999  # 14a: a span's host clock against its events' card clock


def span_names(events) -> dict:
    """{(ph, name): count} of a trace's events."""
    out = {}
    for e in events:
        out[(e["ph"], e["name"])] = out.get((e["ph"], e["name"]), 0) + 1
    return out


def traced_run(run):
    """``run()`` with the port's tracer armed -> (its result, the events);
    the tracer is disarmed and cleared after."""
    from repro_torch.obs.trace import tracer

    tr = tracer()
    tr.clear()
    tr.enable()
    try:
        return run(), tr.events
    finally:
        tr.disable()
        tr.clear()


def obs_train(torch, dev, batches) -> dict:
    """14a: ALPT-8 on the full padded Avazu table, OBS_STEPS steps from
    copies of one initial state (generator included), untraced, traced,
    traced, untraced (in turns, for the host-clock comparison): losses and
    every leaf of the checkpoint tree bitwise equal in all four; exactly
    OBS_STEPS train.step and train.writeback spans in each traced run, each
    train.step at least as long as the card time of its step's kernels (CUDA
    events around the step function, inside the span), so the fence
    waited."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.configs import dcn_ctr
    from repro_torch.training.ctr_trainer import (CTRTrainer, TrainerConfig, checkpoint_tree,
                                                  clone_state)

    _, spec, dcn = dcn_ctr.avazu_setup(method="alpt", bits=8, scale=SCALE)
    cfg = TrainerConfig(spec=dataclasses.replace(spec, pad_to_tiles=True), dcn=dcn, seed=1400)
    trainer = CTRTrainer(cfg, device=dev)
    state0 = trainer.init_state()
    step_fn, card = trainer._step, []

    def timed_step(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = step_fn(*args, **kwargs)
        end.record()
        card.append((start, end))
        return out

    def run():
        card.clear()
        state, losses, host_ms = clone_state(state0), [], []
        for ids, labels in batches[:OBS_STEPS]:
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, ids, labels)
            losses.append(float(m["loss"]))  # waits for the step
            host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return state, losses, host_ms

    trainer._step = timed_step
    first, ms = None, {False: [], True: []}
    for traced in (False, True, True, False):
        if traced:
            (state, losses, host_ms), events = traced_run(run)
        else:
            state, losses, host_ms = run()
        ms[traced].append(host_ms)
        leaves = ckpt.flatten(checkpoint_tree(cfg, state))
        if first is None:
            first = (losses, leaves)
            continue
        check(losses == first[0], f"14a: losses {losses} (traced {traced}) != {first[0]}")
        check(all(pa == pb and torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                  for (pa, a), (pb, b) in zip(leaves, first[1], strict=True)),
              f"14a: a leaf of the state (traced {traced}: codes, Delta, moments, dense "
              "params, Adam, generator) differs from the first untraced run's")
        if not traced:
            continue
        card_us = [start.elapsed_time(end) * 1e3 for start, end in card]
        names = span_names(events)
        check(names.get(("X", "train.step")) == OBS_STEPS == names.get(("X", "train.writeback")),
              f"14a: spans {names}")
        spans = [e["dur"] for e in events if e["name"] == "train.step"]
        check(all(dur >= OBS_SLACK * c for dur, c in zip(spans, card_us, strict=True)),
              f"14a: a train.step span ({spans} us) is shorter than its kernels' card time "
              f"({card_us} us)")
        log(f"[obs] 14a: train.step spans {[round(d, 1) for d in spans]} us >= the steps' card "
            f"time {[round(c, 1) for c in card_us]} us")
    trainer._step = step_fn
    log(f"[obs] 14a: ALPT-8 on {cfg.spec.n_padded} rows, {OBS_STEPS} steps untraced, traced, "
        f"traced, untraced: all bitwise equal ({len(first[1])} leaves, losses {first[0]}); "
        f"host ms per step untraced {[[round(x, 3) for x in r] for r in ms[False]]}, traced "
        f"{[[round(x, 3) for x in r] for r in ms[True]]}")
    return {"cfg": cfg, "state": state, "ms": ms}


def obs_serve(torch, np, cfg, state, test_ids) -> list:
    """14b: the CTR engine, the test requests in waves of BATCH, untraced and
    traced: probabilities bitwise equal, a wave span and a score span per
    wave, a b / e pair per request, latency quantiles ordered, the
    registry's engine.* diff equal to EngineMetrics.  Returns the probs."""
    from repro_torch.obs import counters as obs_counters
    from repro_torch.serving.ctr import CTREngine, CTRRequest

    reg = obs_counters.registry()

    def run():
        engine = CTREngine.from_state(state, cfg, batch=BATCH)
        before = reg.snapshot()
        rids = [engine.submit(CTRRequest(ids=r)) for r in test_ids]
        done = engine.run()
        m = engine.metrics()
        return [done[r]["prob"] for r in rids], m, reg.snapshot().diff(before)

    plain, _, _ = run()
    (probs, m, delta), events = traced_run(run)
    check(probs == plain, "14b: traced probabilities differ from untraced")
    waves, n = -(-len(test_ids) // BATCH), len(test_ids)
    names = span_names(events)
    check(names.get(("X", "engine.wave")) == waves == names.get(("X", "engine.score"))
          and names.get(("b", "engine.request")) == n == names.get(("e", "engine.request")),
          f"14b: spans {names}")
    lat = m.latency_us
    for which, count in (("wave", waves), ("request", n)):
        q = lat[which]
        check(q["count"] == count and q["p50"] <= q["p95"] <= q["p99"],
              f"14b: latency_us[{which}] {q}")
    got = {k: delta.value(f"engine.{k}", "ctr")
           for k in ("requests_submitted", "requests_completed", "waves")}
    check(got == {"requests_submitted": m.requests_submitted,
                  "requests_completed": m.requests_completed, "waves": m.steps},
          f"14b: registry engine.* {got} != metrics {m.to_json()}")
    log(f"[obs] 14b: {n} requests in {waves} waves traced == untraced bitwise; latency_us "
        f"wave {lat['wave']}, request {lat['request']} (host clock); registry engine.* "
        f"{got}")
    return probs


def obs_tiers(torch, dev, cfg, state, test_ids, batches, probs) -> None:
    """14c: the trained state served through the cold tier while traced
    (bitwise 14b's probabilities; prefetch and fetch spans; the registry's
    prefetch_hits / demand_puts diff equal to the ColdStore's own counts),
    then a cached ALPT-8 run of OBS_CACHED_STEPS steps, traced, whose
    storage.writeback_rows diff equals the cache's write-backs."""
    from repro_torch.obs import counters as obs_counters
    from repro_torch.serving.ctr import CTREngine, CTRRequest
    from repro_torch.training.ctr_trainer import CTRTrainer

    reg = obs_counters.registry()

    def serve_cold():
        engine = CTREngine.from_state(state, cfg, batch=BATCH, cache_rows=SERVE_CACHE_ROWS,
                                      cold_tier=True)
        before = reg.snapshot()
        rids = [engine.submit(CTRRequest(ids=r)) for r in test_ids]
        done = engine.run()
        return [done[r]["prob"] for r in rids], engine.cold, reg.snapshot().diff(before)

    (cold_probs, store, delta), events = traced_run(serve_cold)
    names = span_names(events)
    hits, puts = (delta.value("storage.cold.prefetch_hits"),
                  delta.value("storage.cold.demand_puts"))
    check(cold_probs == probs, "14c: the cold tier's probabilities differ from 14b's")
    check(names.get(("X", "storage.cold.prefetch"), 0) > 0
          and names.get(("X", "storage.cold.fetch"), 0) > 0
          and (hits, puts) == (store.prefetch_hits, store.demand_puts),
          f"14c: spans {names}, registry ({hits}, {puts}) != the store's "
          f"({store.prefetch_hits}, {store.demand_puts})")
    del store

    trainer = CTRTrainer(dataclasses.replace(cfg, cache_rows=STORAGE_CACHE_ROWS), device=dev)

    def train_cached():
        s = trainer.init_state()
        before = reg.snapshot()
        for ids, labels in batches[:OBS_CACHED_STEPS]:
            s, m = trainer.train_step(s, ids, labels)
            float(m["loss"])
        return reg.snapshot().diff(before).value("storage.writeback_rows")

    rows, events = traced_run(train_cached)
    written = sum(st["writebacks"] for st in trainer.cache_stats())
    spans = [e["args"]["rows"] for e in events if e["name"] == "storage.writeback"]
    check(rows == written > 0 and sum(spans) == rows,
          f"14c: storage.writeback_rows {rows}, the cache's write-backs {written}, the "
          f"spans' rows {sum(spans)}")
    log(f"[obs] 14c: the cold tier served {len(test_ids)} requests traced, bitwise 14b "
        f"({names.get(('X', 'storage.cold.prefetch'))} prefetch spans, "
        f"{names.get(('X', 'storage.cold.fetch'))} fetch spans; registry prefetch_hits {hits}, "
        f"demand_puts {puts}); a cached ALPT-8 run ({STORAGE_CACHE_ROWS} rows, "
        f"{OBS_CACHED_STEPS} steps): storage.writeback_rows {rows} == the cache's write-backs "
        f"over {len(spans)} storage.writeback spans")


def obs_lm(torch, lm_run: dict) -> None:
    """14d: SmolLM-135M at 8 bits (phase 7's state and prompts), its
    requests untraced and traced: greedy tokens equal, one engine.prefill
    per request and one engine.decode per decode step."""
    from repro_torch.serving.lm import LMRequest

    engine_cls = lm_engine_class()

    def run():
        engine = engine_cls.from_state(lm_run["state"], lm_run["cfg"], batch=LM_BATCH,
                                       max_len=LM_MAX_LEN)
        for i, p in enumerate(lm_run["prompts"]):
            engine.submit(LMRequest(prompt=p, max_new=OBS_LM_NEW, rid=i))
        return engine.run(), len(engine.prefill_ms), len(engine.decode_ms)

    plain, _, _ = run()
    (done, prefills, decodes), events = traced_run(run)
    names = span_names(events)
    check(done == plain, "14d: traced greedy tokens differ from untraced")
    check(names.get(("X", "engine.prefill")) == prefills == len(lm_run["prompts"])
          and names.get(("X", "engine.decode")) == decodes > 0, f"14d: spans {names}")
    log(f"[obs] 14d: SmolLM-135M 8 bits, {prefills} requests x {OBS_LM_NEW} tokens traced == "
        f"untraced; {prefills} engine.prefill and {decodes} engine.decode spans")


def obs_clis(directory: pathlib.Path) -> dict:
    """14e: ``train ctr`` at full width (CLI_STEPS steps) and ``serve lm
    --arch smollm-135m`` at its defaults, in this process, each with
    --trace-out: the Chrome traces load, the reports hold step_time_us /
    latency_us and kernel_fallbacks 0, and the train report's launches are
    the registry's.  Returns the two runs' launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.obs import counters as obs_counters

    total = {}
    for label, main, argv, span in (
            ("train ctr", train_mod.main,
             ["ctr", "--config", "avazu", "--scale", str(SCALE), "--method", "alpt", "--bits",
              "8", "--batch", str(BATCH), "--steps", str(CLI_STEPS), "--seed", "3"],
             "train.step"),
            ("serve lm", serve_mod.main, ["lm", "--arch", LM_ARCH], "engine.prefill")):
        path = directory / f"{label.replace(' ', '_')}.json"
        out, err = io.StringIO(), io.StringIO()
        ops.reset_kernel_calls()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv + ["--trace-out", str(path)])
        lines = out.getvalue().strip().splitlines()
        check(rc == 0 and bool(lines), f"14e: {label} exited {rc}: {err.getvalue()[-2000:]}")
        r = json.loads(lines[-1])
        names = span_names(json.loads(path.read_text())["traceEvents"])
        cells = obs_counters.registry().snapshot().values.get("kernels.kernel_calls", {})
        registry = {op: int(v) for (op,), v in cells.items()}
        launches = r["kernel_launches"]
        # The train report counts the whole run; the engine's, its waves
        # (the state's init launched sr_round once before them).
        served = {k: v for k, v in registry.items() if k != "sr_round"}
        check(r.get("kernel_fallbacks") == 0 and names.get(("X", span), 0) > 0
              and registry == ops.kernel_calls()
              and launches == (registry if label == "train ctr" else served),
              f"14e: {label}: kernel_fallbacks {r.get('kernel_fallbacks')}, spans {names}, "
              f"launches {launches} / {ops.kernel_calls()} / registry {registry}")
        if label == "train ctr":
            q = r["step_time_us"]
            check(q["count"] == CLI_STEPS == names.get(("X", "train.step")),
                  f"14e: train ctr step_time_us {q}")
        else:
            q = r["latency_us"]["request"]
            check(q["count"] == r["requests_completed"] and q["p50"] <= q["p95"] <= q["p99"],
                  f"14e: serve lm latency_us {r['latency_us']}")
        log(f"[obs] 14e: {label} --trace-out: {sum(names.values())} events, {path.stat().st_size}"
            f" B; {'step_time_us' if label == 'train ctr' else 'latency_us.request'} {q}; "
            f"launches {launches}; ops.kernel_calls() == the registry's {registry}")
        total = added(total, registry)
    return total


def obs_phase(torch, np, dev, batches, test_ids, lm_run: dict) -> dict:
    """Phase 14: observability on the card (obs_only runs it without the
    rest).  Returns its launches: 14a-d's through a scope held over them
    (checked against the registry's diff), 14e's from the CLIs' reports."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.obs import counters as obs_counters

    t_phase = time.perf_counter()
    reg = obs_counters.registry()
    before = reg.snapshot()
    with ops.fallback_scope() as scope:
        a = obs_train(torch, dev, batches)
        probs = obs_serve(torch, np, a["cfg"], a["state"], test_ids)
        obs_tiers(torch, dev, a["cfg"], a["state"], test_ids, batches, probs)
        del a["state"]
        torch.cuda.empty_cache()
        obs_lm(torch, lm_run)
    cells = reg.snapshot().diff(before).values.get("kernels.kernel_calls", {})
    window = {op: int(v) for (op,), v in cells.items()}
    check(window == dict(scope.kernel_calls) and scope.stats()["total_fallbacks"] == 0,
          f"14: the registry's kernels.kernel_calls diff {window} != the scope's "
          f"{dict(scope.kernel_calls)}, or a fallback: {scope.stats()['fallbacks']}")
    total = dict(scope.kernel_calls)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        total = added(total, obs_clis(pathlib.Path(tmp)))
    plain, traced = (statistics.mean(x for r in a["ms"][t] for x in r[1:]) for t in (False, True))
    log(f"[obs] 14a overhead (smoke number, host clock, steps 2-{OBS_STEPS} of the two runs "
        f"each): {plain:.3f} ms per step untraced, {traced:.3f} traced "
        f"({traced / plain - 1:+.1%}); {card_name()}")
    log(f"[obs] phase 14: launches {total}; {time.perf_counter() - t_phase:.1f}s; "
        f"{card_name()}")
    return total


def obs_only() -> int:
    """Phase 14 alone (phase 7's SmolLM state and prompts made as phase 7
    makes them):
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.obs_only())"``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch import device as device_mod
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import _build
    from repro_torch.training import lm_trainer

    t_start = time.perf_counter()
    dev = device_mod.resolve("cuda")
    for lib in _build.build():
        _build.library(lib)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; build "
        f"{time.perf_counter() - t_start:.1f}s")
    data = CTRSynthetic(avazu_like(SCALE))
    ids, _ = data.batch("test", 0, REQUESTS)
    batches = Batches(data.batch("train", i, BATCH) for i in range(OBS_CACHED_STEPS))
    cfg = configs.full_config(LM_ARCH, embedding_bits=8)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, LM_PROMPTS[i % len(LM_PROMPTS)]).astype(np.int32)
               for i in range(LM_REQUESTS)]
    lm_run = {"cfg": cfg, "prompts": prompts,
              "state": lm_trainer.init_state(cfg, seed=8, device=dev)}
    launches = obs_phase(torch, np, dev, batches, ids, lm_run)
    check(set(launches) <= set(KERNELS), f"phase 14 launched {launches}")
    log(f"[chip_smoke] phase 14 alone in {time.perf_counter() - t_start:.1f}s")
    return 0


FAULT_STEPS = 6  # 15a: ALPT-8 steps of BATCH on the padded Avazu table
FAULT_TIMED = 24  # 15a: steps of each trainer timed step by step in turns
FAULT_PART_CALLS = 50  # 15a: calls timed of each part of the guard
FAULT_NONFINITE = (1, 3)  # 15a: the steps trainer.nonfinite fires on
FAULT_DELTA = 2  # 15a: the step alpt.delta (scale inf) fires on
FAULT_FORCED_STEPS = 3  # 15d: 15a's first steps under kernels.force_fallback
FAULT_ADMISSION = (2, 4)  # 15c: the training waves whose admissions are refused
FAULT_SERVE_ADMISSION = (1, 3)  # 15c: the serving waves whose admissions are refused
FAULT_PREEMPT, FAULT_CLI_STEPS = 3, 5  # 15e: train ctr preempted at step 3 of 5
FAULT_LM_STEPS, FAULT_LM_FIRED = 3, 1  # 15e: train lm --guard, trainer.nonfinite at step 1


def fault_plan(*specs):
    """A ``repro_torch.faults.FaultPlan`` of ``(site, steps, always, params)``."""
    from repro_torch import faults

    return faults.FaultPlan(specs=tuple(faults.FaultSpec(site=s, steps=st, always=a,
                                                         params=p or {})
                                        for s, st, a, p in specs))


@contextlib.contextmanager
def plan_installed(plan):
    """``plan`` installed for the block (None: no plan), uninstalled after."""
    from repro_torch import faults

    faults.install(plan)
    try:
        yield plan
    finally:
        faults.uninstall()


def changed_leaves(torch, cfg, a, b) -> set:
    """Paths of the checkpoint-tree leaves of two CTR states that differ
    (dtype or bits; compared where they lie)."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.training.ctr_trainer import checkpoint_tree

    fa = ckpt.flatten(checkpoint_tree(cfg, a))
    fb = ckpt.flatten(checkpoint_tree(cfg, b))
    check([p for p, _ in fa] == [p for p, _ in fb], "two states of one config differ in paths")
    return {pa for (pa, x), (_, y) in zip(fa, fb)
            if not torch.equal(torch.as_tensor(x).detach(), torch.as_tensor(y).detach())}


def finite_leaves(torch, tree) -> bool:
    from repro_torch.checkpoint import manager as ckpt

    return all(bool(torch.isfinite(x).all()) for _, x in ckpt.flatten(tree)
               if isinstance(x, torch.Tensor) and x.is_floating_point())


def faults_train(torch, dev, batches) -> dict:
    """15a: ALPT-8 on the full padded Avazu table, FAULT_STEPS steps of BATCH
    from copies of one initial state: unguarded, guarded without a plan
    (bitwise: losses, every leaf, the generator, the launches), each twice in
    turns with the host ms per step (the loss read each step, and back to
    back with one wait at the end); guarded with trainer.nonfinite at
    FAULT_NONFINITE (each fired step leaves every leaf as before it, the
    generator where the unguarded run has it; skipped == fired == 2); with
    alpt.delta (inf) at FAULT_DELTA (one skip, every leaf finite).  The
    snapshot's bytes per step.  Returns the configs, the initial and the
    unguarded final state."""
    from repro_torch.configs import dcn_ctr
    from repro_torch.faults import guards
    from repro_torch.kernels import ops
    from repro_torch.training.ctr_trainer import (CTRTrainer, TrainerConfig, checkpoint_tree,
                                                  clone_state)

    _, spec, dcn = dcn_ctr.avazu_setup(method="alpt", bits=8, scale=SCALE)
    cfg = TrainerConfig(spec=dataclasses.replace(spec, pad_to_tiles=True), dcn=dcn, seed=1500)
    state0 = CTRTrainer(cfg, device=dev).init_state()
    batches = batches[:FAULT_STEPS]

    def run(guard, plan=None, each=True, watch=(), gens=None):
        """One run from a copy of state0: ``each`` reads the loss after each
        step (else once, at the end); the steps in ``watch`` are checked to
        leave every leaf as before them, the generator at ``gens[i]``."""
        with plan_installed(plan):
            trainer = CTRTrainer(dataclasses.replace(cfg, guard=guard), device=dev)
            state, losses, ms, states = clone_state(state0), [], [], []
            ops.reset_kernel_calls()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, (ids, labels) in enumerate(batches):
                before = clone_state(state) if i in watch else None
                t = time.perf_counter()
                state, m = trainer.train_step(state, ids, labels)
                losses.append(float(m["loss"]) if each else m["loss"])
                ms.append((time.perf_counter() - t) * 1e3)
                states.append(state.generator.get_state())
                if before is not None:
                    diff = changed_leaves(torch, cfg, before, state)
                    check(diff == {".step", ".generator"},
                          f"15a: fired step {i} changed {sorted(diff)} (only .step and "
                          ".generator may)")
                    check(torch.equal(states[-1], gens[i]), f"15a: fired step {i}: the "
                          "generator is not where the unguarded run has it")
                    del before
            losses = [float(x) for x in losses]
            torch.cuda.synchronize()
            per_step = (time.perf_counter() - t0) * 1e3 / len(batches)
        return {"state": state, "losses": losses, "ms": ms, "per_step": per_step,
                "gens": states, "launches": ops.kernel_calls(), "stats": trainer.guard_stats}

    first, ms, b2b = None, {False: [], True: []}, {False: [], True: []}
    for guard in (False, True, True, False):
        r = run(guard)
        first = first or r
        ms[guard].append(r["ms"])
        check(r["losses"] == first["losses"] and r["launches"] == first["launches"]
              and not changed_leaves(torch, cfg, r["state"], first["state"]),
              f"15a: guard={guard} (no plan) differs from the unguarded run: losses "
              f"{r['losses']} vs {first['losses']}, launches {r['launches']} vs "
              f"{first['launches']}")
        check(r["stats"] is None or r["stats"].skipped == 0, "15a: a step skipped without a plan")
        del r
    for guard in (False, True, True, False):
        b2b[guard].append(run(guard, each=False)["per_step"])
    # Step by step in turns (host noise drifts slower than a step): two
    # trainers from copies of state0, FAULT_TIMED steps each over the batches
    # again and again, the loss read after each.
    trainers = {g: CTRTrainer(dataclasses.replace(cfg, guard=g), device=dev)
                for g in (False, True)}
    states = {g: clone_state(state0) for g in trainers}
    turns = {False: [], True: []}
    for i in range(FAULT_TIMED):
        ids, labels = batches[i % len(batches)]
        for g in ((False, True) if i % 2 else (True, False)):
            t = time.perf_counter()
            states[g], m = trainers[g].train_step(states[g], ids, labels)
            float(m["loss"])
            turns[g].append((time.perf_counter() - t) * 1e3)
    del states, trainers
    gens = first["gens"]
    stats = run(True, fault_plan(("trainer.nonfinite", FAULT_NONFINITE, False, None)),
                watch=FAULT_NONFINITE, gens=gens)["stats"]
    check(stats.skipped == stats.nonfinite_fired == len(FAULT_NONFINITE),
          f"15a: trainer.nonfinite {stats.to_json()}")
    r = run(True, fault_plan(("alpt.delta", (FAULT_DELTA,), False, None)), watch=(FAULT_DELTA,),
            gens=gens)
    dstats = r["stats"]
    check(dstats.skipped == dstats.delta_fired == 1
          and finite_leaves(torch, checkpoint_tree(cfg, r["state"])),
          f"15a: alpt.delta {dstats.to_json()}")
    del r
    ids = batches[0][0]
    slots = CTRTrainer(cfg, device=dev).method.storage_spec(cfg.spec)
    snap = {whole: sum(s.nbytes for s in guards.ctr_snapshot(state0, ids, slots,
                                                             whole_delta=whole))
            for whole in (False, True)}
    # The guard's two parts alone, host clock per call, the queue drained
    # before each: the snapshot (upload of the rows included) and the check
    # with its one read of the verdict.
    loss = torch.ones((), device=dev)
    parts = {}
    for name, fn in (("snapshot", lambda: guards.ctr_snapshot(state0, ids, slots)),
                     ("check", lambda: bool(guards._all_finite(loss,
                                                               state0.dense.parameters())))):
        t = []
        for _ in range(FAULT_PART_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e6)
        parts[name] = statistics.median(t[5:])
    per = {g: statistics.mean(x for r in ms[g] for x in r[1:]) for g in ms}
    per_b2b = {g: statistics.mean(b2b[g]) for g in b2b}
    med = {g: statistics.median(turns[g][2:]) for g in turns}
    log(f"[faults] 15a: ALPT-8 on {cfg.spec.n_padded} rows, {FAULT_STEPS} steps of {BATCH}: "
        f"guarded without a plan == unguarded bitwise (losses, every leaf, the generator, "
        f"launches {first['launches']}); trainer.nonfinite at {FAULT_NONFINITE}: "
        f"{stats.to_json()}, each fired step's leaves as before it, the generator as unguarded; "
        f"alpt.delta (inf) at step {FAULT_DELTA}: {dstats.to_json()}, every leaf finite")
    log(f"[faults] 15a cost (host clock): step by step in turns, {FAULT_TIMED} steps each, "
        f"median of steps 3-{FAULT_TIMED} {med[False]:.3f} ms unguarded, {med[True]:.3f} guarded "
        f"({med[True] - med[False]:+.3f} ms); runs in turns (steps 2-{FAULT_STEPS}, loss read "
        f"each step) {per[False]:.3f} vs {per[True]:.3f} ms/step ({per[True] - per[False]:+.3f}); "
        f"back to back {per_b2b[False]:.3f} vs {per_b2b[True]:.3f} ms/step "
        f"({per_b2b[True] - per_b2b[False]:+.3f}); alone, the snapshot {parts['snapshot']:.1f} "
        f"us and the check {parts['check']:.1f} us a call (medians); snapshot "
        f"{snap[False]} B per step ({snap[True]} B on an alpt.delta step, the whole Delta); "
        f"{card_name()}")
    return {"cfg": cfg, "state0": state0, "state": first["state"], "losses": first["losses"]}


def faults_cold(torch, np, cfg, state, test_ids) -> list:
    """15b: the test requests through the cold tier (SERVE_CACHE_ROWS hot rows)
    with codestore.corrupt, cold.fetch (fails 2) and cold.prefetch_loss on
    the staged waves 1, 2 and 3: probabilities bitwise the fault-free cold
    run's and the uncached engine's; each seam counted once (the store, the
    registry's diff), two retries, none exhausted, health ready.  Then
    cold.fetch failing past its attempts: RetryError, and health reports
    no_retry_exhaustion False.  Returns the uncached probabilities."""
    from repro_torch import faults
    from repro_torch.obs import counters as obs_counters
    from repro_torch.serving.ctr import CTREngine, CTRRequest

    reg = obs_counters.registry()

    def serve(plan, **kw):
        with plan_installed(plan):
            engine = CTREngine.from_state(state, cfg, batch=BATCH, **kw)
            before = reg.snapshot()
            rids = [engine.submit(CTRRequest(ids=r)) for r in test_ids]
            done = engine.run()
            torch.cuda.synchronize()
            return [done[r]["prob"] for r in rids], engine, reg.snapshot().diff(before)

    cold_kw = dict(cache_rows=SERVE_CACHE_ROWS, cold_tier=True)
    uncached, _, _ = serve(None)
    plain, _, _ = serve(None, **cold_kw)
    seams = fault_plan(("codestore.corrupt", (1,), False, None),
                       ("cold.fetch", (2,), False, {"fails": 2}),
                       ("cold.prefetch_loss", (3,), False, None))
    probs, engine, delta = serve(seams, **cold_kw)
    cold = engine.cold
    check(plain == uncached and probs == plain,
          "15b: the cold tier's probabilities under the seams differ from the fault-free run's")
    got = (cold.corruption_detected, cold.prefetch_dropped, cold.retry_stats.retries,
           cold.retry_stats.failures)
    reg_got = (delta.value("storage.cold.corruption_detected"),
               delta.value("storage.cold.prefetch_dropped"),
               delta.value("faults.retries", "cold.fetch"),
               delta.value("faults.retry_failures", "cold.fetch"))
    health = engine.health()
    check(got == reg_got == (1, 1, 2, 0) and health["ready"],
          f"15b: (corrupt, dropped, retries, failures) store {got}, registry {reg_got}, "
          f"health {health}")
    calls = cold.retry_stats.calls
    with plan_installed(fault_plan(("cold.fetch", (1,), False, {"fails": 5, "attempts": 2}))):
        broken = CTREngine.from_state(state, cfg, batch=BATCH, **cold_kw)
        for r in test_ids:
            broken.submit(CTRRequest(ids=r))
        try:
            broken.run()
            raised = "nothing"
        except faults.RetryError as exc:
            raised = str(exc)
    bh = broken.health()
    check(raised.startswith("cold.fetch") and not bh["checks"]["no_retry_exhaustion"]
          and not bh["ready"] and broken.pending == len(test_ids),
          f"15b: exhaustion raised {raised!r}, health {bh}, pending {broken.pending}")
    log(f"[faults] 15b: {len(test_ids)} requests through the cold tier with codestore.corrupt, "
        f"cold.fetch (fails 2) and cold.prefetch_loss on staged waves 1-3: bitwise the "
        f"fault-free run and the uncached engine; corrupt / dropped / retries / failures "
        f"{got} (registry {reg_got}), {calls} host fetches, health ready; cold.fetch past its "
        f"attempts raised {raised!r}, health {bh['checks']}")
    del engine, broken
    return uncached


def faults_cached(torch, dev, cfg, state0, straight, losses, probs, test_ids, batches) -> None:
    """15c: phase 11's cached ALPT-8 training (STORAGE_CACHE_ROWS rows) over
    15a's steps with cache.admission at FAULT_ADMISSION and
    tiered.writeback (fails 2) on the closing flush: losses and the
    exported state bitwise 15a's uncached run, the refusals and retries
    counted; a hot-cache engine (SERVE_CACHE_ROWS rows) refusing waves
    FAULT_SERVE_ADMISSION: probabilities bitwise the uncached engine's,
    served_degraded once per refused wave."""
    from repro_torch.serving.ctr import CTREngine, CTRRequest
    from repro_torch.training.ctr_trainer import CTRTrainer, checkpoint_tree, clone_state

    plan = fault_plan(("cache.admission", FAULT_ADMISSION, False, None),
                      ("tiered.writeback", (0,), False, {"fails": 2}))
    with plan_installed(plan):
        trainer = CTRTrainer(dataclasses.replace(cfg, cache_rows=STORAGE_CACHE_ROWS), device=dev)
        state, hist = trainer.fit(batches, steps=FAULT_STEPS, batch_size=BATCH,
                                  state=trainer.import_state(clone_state(state0)))
        for slot, cache in trainer.caches:
            cache.flush(slot.get(state.emb_state).codes)
        torch.cuda.synchronize()
    stats = trainer.cache_stats()
    check([h["loss"] for h in hist] == losses
          and same_tree(torch, checkpoint_tree(cfg, trainer.export_state(state)),
                        checkpoint_tree(cfg, straight)),
          "15c: the cached run under the seams differs from the uncached run")
    check(stats[0]["admission_oom"] == len(FAULT_ADMISSION) and stats[0]["writeback_retries"] == 2
          and stats[0]["writebacks"] > 0 and not any(c.dirty.any() for _, c in trainer.caches),
          f"15c: cache stats {stats}")
    del state, trainer
    with plan_installed(fault_plan(("cache.admission", FAULT_SERVE_ADMISSION, False, None))):
        engine = CTREngine.from_state(straight, cfg, batch=BATCH, cache_rows=SERVE_CACHE_ROWS)
        rids = [engine.submit(CTRRequest(ids=r)) for r in test_ids]
        done = engine.run()
        torch.cuda.synchronize()
    m = engine.metrics()
    check([done[r]["prob"] for r in rids] == probs
          and m.served_degraded == len(FAULT_SERVE_ADMISSION) == m.caches[0].admission_oom
          and engine.health()["ready"],
          f"15c: hot-cache engine under refusals: served_degraded {m.served_degraded}, "
          f"admission_oom {[c.admission_oom for c in m.caches]}")
    log(f"[faults] 15c: cached ALPT-8 ({STORAGE_CACHE_ROWS} rows) with admissions refused at "
        f"waves {FAULT_ADMISSION} and the closing flush failing twice: bitwise the uncached run; "
        f"{stats[0]}; a hot-cache engine refusing waves {FAULT_SERVE_ADMISSION}: bitwise, "
        f"served_degraded {m.served_degraded}")


def faults_fallback(torch, dev, cfg, state0, batches) -> None:
    """15d: kernels.force_fallback over 15a's first FAULT_FORCED_STEPS steps:
    the state of the kernels-on run bit for bit, each forced dispatch counted
    with reason fault-injected, the launches lower by exactly those
    dispatches; after uninstall() the same steps fall back nowhere."""
    from repro_torch.kernels import ops
    from repro_torch.training.ctr_trainer import CTRTrainer, checkpoint_tree, clone_state

    def run(plan):
        with plan_installed(plan):
            trainer = CTRTrainer(cfg, device=dev)
            state, losses = clone_state(state0), []
            ops.reset_kernel_calls()
            with ops.fallback_scope() as scope:
                for ids, labels in batches[:FAULT_FORCED_STEPS]:
                    state, m = trainer.train_step(state, ids, labels)
                    losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            return state, losses, ops.kernel_calls(), scope.stats()

    on, l_on, launched, st_on = run(None)
    forced, l_forced, launched_f, st_f = run(fault_plan(("kernels.force_fallback", (), True,
                                                         None)))
    after, l_after, launched_a, st_a = run(None)
    counts = {f["op"]: f["count"] for f in st_f["fallbacks"]}
    drop = sum(launched.values()) - sum(launched_f.values())
    # The scratch row takes the dedup sentinel's run: unspecified between a
    # kernel and its plain version, so the table is compared over its live rows.
    check(l_on == l_forced == l_after
          and all(torch.equal(x, y) for x, y in zip(live_parts(on.emb_state, cfg.spec),
                                                    live_parts(forced.emb_state, cfg.spec),
                                                    strict=True))
          and same_tree(torch, checkpoint_tree(cfg, on._replace(emb_state=None)),
                        checkpoint_tree(cfg, forced._replace(emb_state=None))),
          "15d: the forced run differs from the kernels-on run")
    check({f["reason"] for f in st_f["fallbacks"]} == {"fault-injected"}
          and st_f["total_fallbacks"] == drop == sum(launched.values()) and launched_f == {},
          f"15d: forced fallbacks {counts}, launches {launched} -> {launched_f}")
    check(st_on["total_fallbacks"] == st_a["total_fallbacks"] == 0 and launched_a == launched,
          f"15d: after uninstall: fallbacks {st_a['fallbacks']}, launches {launched_a}")
    log(f"[faults] 15d: kernels.force_fallback over {FAULT_FORCED_STEPS} ALPT-8 steps: bitwise "
        f"the kernels-on run; forced dispatches {counts} (fault-injected), launches {launched} -> "
        f"{launched_f or '{}'}; after uninstall() no fallback, launches {launched_a}")


def cli_json(main, argv) -> tuple[int, dict | None, str]:
    """(rc, the report's JSON line or None, stderr) of a CLI run in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    lines = out.getvalue().strip().splitlines()
    report = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, report, err.getvalue()


def faults_clis(torch, dev, directory: pathlib.Path, lm_data) -> dict:
    """15e: the CLIs at full width.  train ctr with train.preempt at
    FAULT_PREEMPT exits 75; its requeue resumes there, losses bitwise the
    uninterrupted run's; corrupt_checkpoint_leaf on the newest step makes the
    next resume fall back and report corrupt_checkpoints.  train lm
    --guard with trainer.nonfinite at FAULT_LM_FIRED (4 x 1,024 tokens,
    FAULT_LM_STEPS steps): one skip; the same guarded step in this process
    returns the state bitwise as before the fired step, the generator where
    the unguarded step leaves it.  serve ctr --deadline-ms below one wave:
    deadline_misses == waves.  Returns the CLIs' launches."""
    from repro_torch import configs, faults
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.training import lm_trainer

    total = {}
    ck = directory / "ck"
    preempt = directory / "preempt.json"
    fault_plan(("train.preempt", (FAULT_PREEMPT,), False, None)).save(preempt)
    base = ["ctr", "--config", "avazu", "--scale", str(SCALE), "--method", "alpt", "--bits", "8",
            "--batch", str(BATCH), "--seed", "5", "--ckpt-every", "100"]
    rc, _, err = cli_json(train_mod.main, base + ["--steps", str(FAULT_CLI_STEPS), "--ckpt-dir",
                                                  str(ck), "--fault-plan", str(preempt)])
    check(rc == 75 and faults.active_plan() is None, f"15e: preempted train ctr exited {rc}: "
                                                     f"{err[-2000:]}")
    rc, resumed, err = cli_json(train_mod.main, base + ["--steps", str(FAULT_CLI_STEPS),
                                                        "--ckpt-dir", str(ck)])
    check(rc == 0, f"15e: the requeued train ctr exited {rc}: {err[-2000:]}")
    rc, ref, err = cli_json(train_mod.main, base + ["--steps", str(FAULT_CLI_STEPS + 1)])
    check(rc == 0, f"15e: the uninterrupted train ctr exited {rc}: {err[-2000:]}")
    check(resumed["start_step"] == FAULT_PREEMPT
          and resumed["losses"] == ref["losses"][FAULT_PREEMPT:FAULT_CLI_STEPS],
          f"15e: resumed losses {resumed['losses']} != {ref['losses'][FAULT_PREEMPT:]}")
    faults.corrupt_checkpoint_leaf(ck, FAULT_CLI_STEPS)
    rc, again, err = cli_json(train_mod.main, base + ["--steps", str(FAULT_CLI_STEPS + 1),
                                                      "--ckpt-dir", str(ck)])
    check(rc == 0 and again.get("corrupt_checkpoints") == [FAULT_CLI_STEPS]
          and again["start_step"] == FAULT_PREEMPT
          and again["losses"] == ref["losses"][FAULT_PREEMPT:],
          f"15e: after corrupting step {FAULT_CLI_STEPS}: rc {rc}, "
          f"{ {k: (again or {}).get(k) for k in ('corrupt_checkpoints', 'start_step')} }")
    for r in (resumed, ref, again):
        total = added(total, r["kernel_launches"])
    log(f"[faults] 15e: train ctr preempted at step {FAULT_PREEMPT} (exit 75), requeued: losses "
        f"{resumed['losses']} == the uninterrupted run's; step {FAULT_CLI_STEPS} corrupted: "
        f"the resume fell back to step {again['start_step']}, corrupt_checkpoints "
        f"{again['corrupt_checkpoints']}")

    nf = directory / "nonfinite.json"
    fault_plan(("trainer.nonfinite", (FAULT_LM_FIRED,), False, None)).save(nf)
    rc, lm_report, err = cli_json(train_mod.main, [
        "lm", "--arch", LM_ARCH, "--steps", str(FAULT_LM_STEPS), "--batch", str(LM_TRAIN_BATCH),
        "--seq", str(LM_TRAIN_SEQ), "--guard", "--fault-plan", str(nf), "--log-every", "0"])
    g = (lm_report or {}).get("guard", {})
    check(rc == 0 and g.get("skipped") == g.get("nonfinite_fired") == 1
          and lm_report.get("kernel_fallbacks") == 0,
          f"15e: train lm --guard: rc {rc}, guard {g}: {err[-2000:]}")
    total = added(total, lm_report["kernel_launches"])
    cfg = configs.full_config(LM_ARCH)  # as the CLI builds it
    steps = {}
    for guard in (False, True):
        tcfg = lm_trainer.LMTrainerConfig(guard=guard)
        plan = fault_plan(("trainer.nonfinite", (FAULT_LM_FIRED,), False, None)) if guard else None
        with plan_installed(plan):
            step = lm_trainer.make_train_step(cfg, tcfg)
        state = lm_trainer.init_state(cfg, tcfg, seed=0, device=dev)
        for i in range(FAULT_LM_FIRED):
            state, _ = step(state, lm_data[i])
        before = lm_trainer.clone_state(state)
        state, m = step(state, lm_data[FAULT_LM_FIRED])
        steps[guard] = (state, before, m)
    (plain, _, _), (state, before, m) = steps[False], steps[True]
    check(m["guard_skipped"] == 1 and lm_same(torch, cfg, state, before, skip_clock=True)
          and torch.equal(state.generator.get_state(), plain.generator.get_state()),
          "15e: the guarded SmolLM step did not return the state before it")
    log(f"[faults] 15e: train lm --arch {LM_ARCH} --guard, {FAULT_LM_STEPS} steps of "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, trainer.nonfinite at step {FAULT_LM_FIRED}: guard "
        f"{g}; in process the fired step left params, their Adam state and the table bitwise "
        "as before it, the generator as the unguarded step's")
    del steps, state, before, plain
    torch.cuda.empty_cache()

    rc, served, err = cli_json(serve_mod.main, [
        "ctr", "--config", "avazu", "--scale", str(SCALE), "--method", "alpt", "--bits", "8",
        "--batch", str(BATCH), "--requests", str(REQUESTS), "--deadline-ms", "0.001"])
    waves = -(-REQUESTS // BATCH)
    check(rc == 0 and served["deadline_misses"] == served["steps"] == waves
          and served["health"]["ready"] and "[serve] health: READY" in err,
          f"15e: serve ctr --deadline-ms: rc {rc}, {({k: (served or {}).get(k) for k in ('deadline_misses', 'steps', 'health')})}")
    total = added(total, served["kernel_launches"])
    log(f"[faults] 15e: serve ctr --deadline-ms 0.001: deadline_misses {served['deadline_misses']} "
        f"of {waves} waves, health {served['health']['checks']}; JSON line last on stdout, the "
        "recovery lines on stderr")
    return total


def lm_same(torch, cfg, a, b, skip_clock: bool = False) -> bool:
    """Two LM states' checkpoint trees equal leaf for leaf (``skip_clock``:
    the step counter and the generator aside)."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.training import lm_trainer

    fa = ckpt.flatten(lm_trainer.checkpoint_tree(cfg, a))
    fb = ckpt.flatten(lm_trainer.checkpoint_tree(cfg, b))
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(torch.as_tensor(x).detach().cpu(), torch.as_tensor(y).detach().cpu())
        for (p, x), (_, y) in zip(fa, fb) if not (skip_clock and p in (".step", ".generator")))


def faults_phase(torch, np, dev, batches, test_ids, lm_data) -> dict:
    """Phase 15: faults and recovery on the card (faults_only runs it without
    the rest).  Returns its launches (one scope over 15a-d, the CLIs'
    reports for 15e)."""
    import tempfile

    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    with ops.fallback_scope() as scope:
        a = faults_train(torch, dev, batches)
        probs = faults_cold(torch, np, a["cfg"], a["state"], test_ids)
        faults_cached(torch, dev, a["cfg"], a["state0"], a["state"], a["losses"], probs,
                      test_ids, batches)
        faults_fallback(torch, dev, a["cfg"], a["state0"], batches)
    del a
    torch.cuda.empty_cache()
    st = scope.stats()
    check({f["reason"] for f in st["fallbacks"]} <= {"fault-injected"},
          f"15: a fallback not asked for by a plan: {st['fallbacks']}")
    total = dict(scope.kernel_calls)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_faults_") as tmp:
        total = added(total, faults_clis(torch, dev, pathlib.Path(tmp), lm_data))
    log(f"[faults] phase 15: launches {total}; {time.perf_counter() - t_phase:.1f}s; "
        f"{card_name()}")
    return total


def faults_only() -> int:
    """Phase 15 alone:
    ``python3 -c "import chip_smoke, sys; sys.exit(chip_smoke.faults_only())"``."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as device_mod
    from repro_torch.data.ctr_synth import CTRSynthetic, avazu_like
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = device_mod.resolve("cuda")
    for lib in _build.build():
        _build.library(lib)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; build "
        f"{time.perf_counter() - t_start:.1f}s")
    data = CTRSynthetic(avazu_like(SCALE))
    ids, _ = data.batch("test", 0, REQUESTS)
    batches = Batches(data.batch("train", i, BATCH) for i in range(FAULT_STEPS))
    launches = faults_phase(torch, np, dev, batches, ids, lm_batches(torch, dev, LM_TABLE[0]))
    check(set(launches) <= set(KERNELS), f"phase 15 launched {launches}")
    log(f"[chip_smoke] phase 15 alone in {time.perf_counter() - t_start:.1f}s")
    return 0


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
    long_waves = long_run_waves(torch, dev, g, wave, n)
    check_long_runs(torch, long_waves, err)
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

    # 9. the other seven methods, Criteo with dropout, DeepFM, at full width
    t0 = time.perf_counter()
    phase9 = methods_phase(torch, np, dev, batches, ids)
    for k, v in criteo_deepfm_phase(torch, np, dev, batches, ids).items():
        phase9[k] = phase9.get(k, 0) + v
    check(set(phase9) <= set(KERNELS), f"phase 9 launched {phase9}")
    log(f"[kernels] launches on phase 9's paths: {phase9}; {time.perf_counter() - t0:.1f}s")
    launches = {k: launches[k] + phase9.get(k, 0) for k in KERNELS}

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
    lm_cli_report = lm_train_cli()
    cli = lm_cli_report["kernel_launches"]
    launches = {k: launches[k] + trained[k] + cli.get(k, 0) for k in KERNELS}

    # 10. checkpoints: CTR resume bitwise, the layout, both engines from
    # serving checkpoints, the LM CLI's resume
    phase10 = checkpoint_phase(torch, np, dev, batches, ids, lm_runs[8],
                               lm_cli_report["losses"])
    check(set(phase10) <= set(KERNELS), f"phase 10 launched {phase10}")
    launches = {k: launches[k] + phase10.get(k, 0) for k in KERNELS}
    # 11. storage tiers: cache on == cache off in training, hot and cold tiers
    # in serving, the routed kernels checked and timed
    flush_buf = torch.empty(128 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    phase11, routed_timings = storage_phase(torch, np, dev, batches, ids, wave, row_ops, n,
                                            err, flush)
    check(set(phase11) <= set(KERNELS), f"phase 11 launched {phase11}")
    launches = {k: launches[k] + phase11.get(k, 0) for k in KERNELS}
    # 12. data parallel: the microbatched twins at full width kernels on ==
    # off, the DP steps through a one-rank NCCL group and over two gloo ranks
    # on the card bitwise their twins, the train lm CLI's --mesh-data
    phase12 = dp_phase(torch, dev, lm_data)
    check(set(phase12) <= set(KERNELS), f"phase 12 launched {phase12}")
    launches = {k: launches[k] + phase12.get(k, 0) for k in KERNELS}
    # 14. observability: traced == untraced bitwise in training, CTR and LM
    # serving; spans, counters and the CLIs' --trace-out (phase 7's SmolLM
    # state still alive)
    phase14 = obs_phase(torch, np, dev, batches, ids, lm_runs[8])
    check(set(phase14) <= set(KERNELS), f"phase 14 launched {phase14}")
    launches = {k: launches[k] + phase14.get(k, 0) for k in KERNELS}
    # 15. faults and recovery: the guard, the storage and serving seams, forced
    # fallbacks and the CLIs' preemption, corruption, guard and deadline
    phase15 = faults_phase(torch, np, dev, batches, ids, lm_data)
    check(set(phase15) <= set(KERNELS), f"phase 15 launched {phase15}")
    launches = {k: launches[k] + phase15.get(k, 0) for k in KERNELS}
    # 13. the SSM and MoE families: mamba2-370m at full width and depth,
    # deepseek-moe-16b at full width with 2 layers, served and trained.  The
    # SmolLM states of phase 7 go first (their tables stay for the timing).
    for r in lm_runs.values():
        r.pop("state", None)
    phase13, family_tables = families_phase(torch, np, dev)
    check(set(phase13) <= set(KERNELS), f"phase 13 launched {phase13}")
    launches = {k: launches[k] + phase13.get(k, 0) for k in KERNELS}
    # 16. the VLM: qwen2-vl-7b served at full width and depth, its kernels at
    # its shapes, trained ALPT-8 at full width with its depth cut, its CLIs.
    phase16, vlm_tables = vlm_phase(torch, np, dev, err)
    check(set(phase16) <= set(KERNELS), f"phase 16 launched {phase16}")
    launches = {k: launches[k] + phase16.get(k, 0) for k in KERNELS}
    # 17. the encoder and remat: hubert-xlarge trained at full width and
    # depth, deepseek-67b served at full width with its depth cut, its
    # kernels at its shapes, trained ALPT-8 at full width with remat, the CLIs.
    phase17, remat_tables = encoder_remat_phase(torch, np, dev, err)
    check(set(phase17) <= set(KERNELS), f"phase 17 launched {phase17}")
    launches = {k: launches[k] + phase17.get(k, 0) for k in KERNELS}
    # 18. the sharding path: qwen3-1.7b on a 1 x 2 grid of gloo ranks at full
    # width and depth, the train lm CLI at 2 x 2 with a tp_sp step and its
    # checkpoint, mixtral-8x7b's experts over 2 ranks, the shard-local
    # kernels, the other families, the seven other methods and tp_ep.
    phase18 = sharding_phase(torch, dev, err)
    check(set(phase18) <= set(KERNELS), f"phase 18 launched {phase18}")
    launches = {k: launches[k] + phase18.get(k, 0) for k in KERNELS}
    # sr_round_seeded has no main path (no caller in the JAX package but its
    # kernel test): its launches are its unbiasedness run's (phase 2e).
    launches["sr_round_seeded"] += wb_ops["seeded_launches"]
    # The g_sum form of the row step left the main path (the runs form took
    # it over): its launches are phase 2b's.
    for kernel in ("sparse_row_update", "sparse_row_update_packed"):
        launches[kernel] += row_ops["launches"].get(kernel, 0)

    # 5. timing at the slice's shapes (the routed kernels: phase 11's)
    timings = dict(routed_timings)
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
    for label, o in long_waves.items():
        runs = o["starts"][1:] - o["starts"][:-1]
        ms_, host_us = time_ms(torch, lambda: run_row_step(ops, o, True, 8), 30, flush)
        plain_ms = time_ms(torch, lambda: run_row_step(ops, o, True, 8, use_kernel=False), 10,
                           flush)[0]
        b_ms, b_by = row_bound(o, int(((o["uniq"] < o["live"]) & (runs > 0)).sum()), True)
        log(f"[time] sparse_row_update_runs at the {label} wave (bits 8, {o['codes'].n} x 16, "
            f"the longest run {int(runs.max())} lookups): {ms_ * 1e3:.2f} us on the card "
            f"(plain {plain_ms * 1e3:.2f} us, bound {b_ms * 1e3:.3f} us by {b_by}); host "
            f"enqueue {host_us:.1f} us per call; {card_name()}")
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
    time_families(torch, family_tables, flush)
    time_vlm(torch, vlm_tables, flush)
    time_encoder_remat(torch, remat_tables, flush)
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
