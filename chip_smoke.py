#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py   # needs one CUDA card and nvcc

Phases (any failure exits non-zero before the final line):
1. the card, torch/CUDA versions, TF32 off, the kernels' build: the sketch
   kernels from ``src/repro_torch/kernels/csrc/histogram_agg.cu`` and every
   median, trimmed-mean and fused median + trimmed-mean program this
   script runs, in f32 and bf16, and in f16 those of phases 5 and 7
   (generated by ``kernels/select_codegen.py`` around
   ``csrc/select_program.cuh``, ``robust_agg.prepare``: a few libraries),
   all nvcc processes started together; the build seconds and the ptxas
   reports; any spill fails;
2. every order-statistic kernel against its plain PyTorch version on the
   card, bitwise (NaN matched by position, -0 != +0): m in {2,...,64}, f32
   and bf16, ragged n and the main path's leaf sizes, columns with ±1e30,
   NaN and mixed ±0, every legal trim for m in {10, 17, 40}; then the
   multi-leaf calls of the median, the trimmed mean and the fused kernel
   (both of its outputs): the CNN's 8 leaf sizes in one launch (m in {10,
   17, 40}, f32 and bf16, rows with ±inf, ±1e30, NaN, ±0 and subnormals),
   a call with more leaves than one launch takes, misaligned inputs
   (``x[:, 1:]`` made contiguous, a view one element off) and m = 1.  Both
   load paths (vector and scalar) must have run;
2b. the sketch kernels (min/max, histogram) against their plain versions,
   bitwise (counts and sums): rows in {1, 7, 33, 256, 512, 1000}, n in {1,
   32, 33, 4097, 50176}, nbins in {2, 64, 256, 512, 4096}, f32 and bf16,
   with and without sums, columns with ±1e30 rows, a NaN, mixed ±0 and a
   constant; a row slice x[1:] (pointer not 16-byte aligned, n = 33), a
   wide view one element off, and 2^15 / 2^16 bins (past the shared-memory
   budget).  Every kernel variant (scalar and 16-byte loads; shared and
   global histogram) must have run;
2c. approx_median and approx_trimmed_mean on the card twice: bitwise equal,
   and within the CPU tests' tolerance of the CPU result;
3. the quickstart, ``examples/torch_quickstart.py``'s ``main`` on the card
   (examples/quickstart.py's configuration): median and trimmed mean
   ROBUST (||w - w*|| < 0.2), mean BROKEN;
4. the main path: Algorithm 1 on the paper's CNN at full width (53,370
   parameters in 8 leaves), the Table 3 layout (m=10, n=400 per worker,
   sign_flip alpha=0.1 scale 20), median and trimmed mean (beta=0.1) for
   30 iterations each.  The launch counters are zeroed just before and
   read just after: every aggregation must have gone through a kernel,
   one launch a step over all 8 leaves (30 launches, 240 leaves a method).
   Algorithm 1 does not run the fused kernel, so its entry point
   (ops.fused_median_trimmed) is then called directly on each of the final
   per-worker gradients' 8 leaves, then robust_agg.fused_median_trimmed_many
   once over all 8 (8 + 1 launches; both outputs bitwise equal to the median
   and trimmed-mean kernels), and its count is those calls'.  The first 3
   iterates are compared with the same run on the CPU; linreg runs at
   the Table 2 worker count (m=40);
5. times at the main path's shapes, the CNN's 8 leaves in one call (median,
   trimmed mean and fused), and
   bandwidth-sized shapes (f32, bf16 and f16; CUDA events per call, and
   device time from torch.profiler), against the
   memory bound (3.35 TB/s) and the f32 operation bound (67 TFLOP/s) of
   an H100 SXM at 700 W, the plain version, and the one PyTorch call that
   computes the same function where there is one (the median's); the
   steady-state CNN step time, and the top device-time rows of a
   torch.profiler trace of 3 steps; the sketch kernels at the federated
   chunk (512 x 32, 512 bins), the CLI default (256 x 64, 256 bins) and a
   bandwidth shape (256 x 2^20, 128 bins, f32 and bf16), against the
   memory bound, their plain versions and torch.aminmax (min/max, timed in
   turns with the kernel; its device time too), with a line per min/max
   shape comparing them;
6. the federated path: ``fed.rounds.run_rounds`` at benchmarks/fed_scale.py's
   configuration (200,000 clients, cohorts of 100,000 in chunks of 512,
   d=32, n=16, 512 bins, sign_flip alpha=0.1 scale 100, beta=0.15, lr 0.3,
   sgd, cut to 5 rounds) for approx_median, approx_trimmed_mean and
   stream_mean.
   The launch counters are zeroed before each method and read after it:
   196 min/max and 196 histogram launches per round for the robust
   methods, none for the mean.  Robust ||w - w*|| < 0.5, the mean's more
   than 10x the median's; the sketch median within one bin of the exact
   median of an attacked 10^4 cohort; the first 2 rounds agree with the
   CPU; the CLI runs twice with one sha256 (in the CLI batch, below); a
   profile of one round (with
   the sketch kernels' device ms in it);
7. C1 on the card: the f16 median, trimmed-mean and fused programs bitwise
   against their plain versions (m in HALF_M, rows with NaN, ±0, ±inf,
   ±65504 and f16 subnormals, both load paths, misaligned leaves, the CNN's
   8 leaves in one call of each); f64 and zero-width leaves through
   coordinate_median / coordinate_trimmed_mean take their routes (the
   network, bitwise its plain result; an empty result) with no launch;
8. Algorithm 2, benchmarks/table4_one_round.py at full width (logistic
   regression d=784, 10 classes, m=10, n=500, 150 local GD steps at lr
   0.5): its five accuracies and claim_holds, which must hold; the median
   kernel launched once a median row over both leaves;
9. one_round_streaming at federated scale (m=10^5 workers, n=64, d=32,
   ~845 MB of data on the card, chunks of 512, 512 bins, sign_flip alpha
   0.1 scale 100), approx_median and approx_trimmed_mean: within one bin
   width of the exact one_round on the same 10^5 attacked solutions (the
   sort path), the median more than 10x better than the mean, 196 min/max
   and 196 histogram launches a method;
10. local-update rounds on phase 4's CNN: tau=1 after 5 rounds bitwise
   robust_gd (deterministic cuDNN; with the default algorithms too
   whenever two robust_gd runs agree bitwise), tau=5 for 10 rounds with the loss
   falling and one launch a round over the 8 leaves, the tau=5 round time
   and its profile;
11. compressed federated rounds: int8, topk and count_sketch, 5 rounds of
   run_rounds at a 10^4 cohort under sign_flip for approx_median and
   approx_trimmed_mean, each converging (the last ||w - w*|| below 0.9x the
   first) but topk with the median, which does not converge (reported);
12. buffered async federated rounds: fed.async_rounds.run_async_rounds at
   phase 6's width (10^5-client cohorts in chunks of 512, 30 rounds) with a
   5*10^4 buffer, lognormal stragglers, the damped policy, timeout 20,
   beta 0.3 and stale_exploit alpha 0.1, approx_median and
   approx_trimmed_mean: buffer_k = cohort with zero latency bitwise
   run_rounds (the fast path every round, 196 + 196 launches a round);
   ||w - w*|| < 0.5; every buffer 5*10^4 with stale rows and a pending
   queue; 98 min/max and 98 histogram launches a round; >= 2x faster
   simulated rounds than a buffer of the whole cohort; at a 10^4 cohort
   the buffer composition equal on the card and the CPU and the iterates
   within one bin; the wall time a round and a profile of one round;
13. the robustness matrix, ``python -m repro_torch.attacks.matrix`` at the
   default configs: exit 0, no violation, ROBUSTNESS.json's 276 / 40 / 64
   / 42 cells with its bounds (1e-12 relative) and flags, the worst err /
   bound beside the committed one, and B1 / B2 launched exactly
   MATRIX_LAUNCHES times (one launch a step over all cells of a program);
   its programs are built in phase 1, and phases 12-14 may build none;
14. robust serving (``repro_torch.serve``): (a) tests/test_serve.py's tiny
   model in f32 on the card against the same run on the CPU (the engine's
   tokens, teacher-forced logits within 1e-5, one adaptation round); (b)
   llama3.2-3b's widths (d_model 3072, 24 heads, GQA kv 8, d_ff 8192,
   vocab 128256, bf16) cut to 8 of its 28 layers (D = 1,593,363,456):
   32 requests through a 4-slot pool (prompt 16, max_new 16) from 10^6
   virtual users over 4 shards, one Byzantine (feedback_flip alpha 0.25),
   served three times: without adaptation, and adapting every 8 ticks
   (B = 2 a shard, sgd 0.1) with the median and with the trimmed mean
   (beta 0.25).  The counters are zeroed before each run and read after:
   every request served, >= 2 rounds, exactly one B1 (B2) launch over one
   leaf a round and no other kernel; each round's aggregate is bitwise
   the plain version on the adapter's (4, D) rows in column slices of
   2^26; the served tensors keep their storage; tokens/s, latency in
   ticks, peak memory, the round's split, B1/B2 at (4, D) against the HBM
   bound and profiles of 8 ticks and of a round; (c) ``python -m
   repro_torch.serve.run --smoke`` twice, both processes at once: one
   sha256;
15. robust LM training (``repro_torch.launch.trainer`` with 4 in-process
   workers, every window under ``torch.cuda.set_sync_debug_mode("error")``):
   (a) tests/test_trainer.py's tiny llama in f32, gather and bucketed x
   median and trimmed mean under alie alpha 0.25, 4 SGD steps on the card
   and the CPU from the same params and batches (losses and params within
   1e-5), every step's aggregate bitwise its plain version; (b)
   llama3.2-3b's widths at 8 layers (D = 1,593,363,456 bf16), global batch
   8, seq 128, AdamW 1e-4, 4 steps in windows of 2 (remat off; 22d runs
   it on): gather / bucketed
   median, gather trimmed mean beta 0.25 and psum mean under alie alpha
   0.25, psum mean and gather median under sign_flip.  The counters are
   zeroed before each run and read after: one B1 (B2) launch a step over
   all 12 leaves of the (4, D) bf16 stack, none for psum; the last window's
   aggregates bitwise their plain versions in 2^26 column slices; the
   robust runs' loss falls; under sign_flip the median ends below the
   mean; steps/s, tokens/s, the step's split, peak memory, the device busy
   share of the first run of each strategy (gather, bucketed, psum), and
   B1/B2 at (4, D) bf16 against the 4.76 ms HBM bound; (c) the
   chunked strategy on one (4, 2^24) leaf (B4 once, B5 once a 2^20 chunk)
   and two steps of the tiny llama, within one bin of the exact median /
   trimmed mean, B4/B5 held on the path's inputs and timed at its shapes;
   (d) ``python -m repro_torch.launch.train --smoke`` on the card;
16. the MoE, SSM and hybrid RG-LRU families, served: (a) granite-moe,
   grok-1, mamba2 and recurrentgemma at their smoke widths in f32, card
   against CPU as 14a (tokens, logits within 1e-5, one round; the round's
   B1 bitwise its plain version); (b) three full-width cells in bf16 from
   a seed, phase 14b's traffic and adaptation: granite-moe-1b-a400m at 12
   of 24 layers (D = 742,816,768; median: its trimmed-mean run went when
   phase 23 took its time),
   mamba2-2.7b at 4 of 64 layers with 272-token prompts (D =
   418,280,896; the prefill crosses the 256-token SSD chunk) and
   recurrentgemma-2b at 5 of 26 layers (D = 1,751,221,760; median), each
   run held as 14b (every request served, >= 2 rounds, one
   B1 / B2 launch a round over the (4, D) f32 rows and no other kernel,
   bitwise in 2^26 column slices, storage kept), with tokens/s, latency,
   peak memory, the round's split, B1/B2 against the HBM bound and
   profiles of a round and of 2 ticks after the stream (the serve-only
   runs went when phase 22 took its time); (c) ``python -m repro_torch.serve.run --smoke --arch
   <family>`` twice per family, all eight processes at once: one sha256
   each; (d) ``python -m repro_torch.launch.train --smoke --arch
   <family>`` in this process for granite, mamba2 and recurrentgemma: B1
   launched once a step per dtype group and MAX_LEAVES (32) leaves; (e)
   the MoE combine's two kernels (``kernels/moe_combine.py``, no TPU
   kernel's port) against their plain versions at granite-moe's training
   shapes with most pairs dropped, as rank 1 of split="experts" and at a
   decode step, bf16 and f32 (y and d_weight within MC_TOL, d_ye bitwise),
   and timed at the training shapes against the HBM bound;
17. the distributed round programs and the process group: (a)
   ``rounds.one_round_distributed`` at phase 8's configuration, its local
   solver cut to 50 GD steps, on make_debug_mesh(10, 1): the median on
   the clean and random_label shards and under sign_flip alpha 0.1 scale
   15 by gather, bucketed and chunked, and gather's three mean rows:
   gather and bucketed bitwise equal and within 1e-5 of phase 8's
   one_round, chunked within one bin of the exact
   median of its rows, Table 4's claim_holds on the gather rows; one B1
   launch a gather / bucketed call, 2 B4 + 2 B5 a chunked call; (b)
   ``rounds.make_local_update_round`` on phase 10's CNN (m = 10, sign_flip
   alpha 0.1 scale 20): gather, bucketed and chunked x median and trimmed
   mean beta 0.1 x tau in {1, 5}, 5 rounds each: one B1 (B2) launch a round
   for gather and bucketed and 8 B4 + 8 B5 a round for chunked, the same at
   tau = 1 and 5; tau = 1 gather a round from the same iterate within 1e-4
   of each leaf's scale of local_update_gd's (deterministic cuDNN); the
   loss falls at tau = 5; the tau = 5 round ms and a profile of one round;
   (c) ``python -m repro_torch.serve.run`` with the reference's CI smoke
   flags (``--mesh debug --workers 2 --model-par 1``) twice: one sha256; (d)
   ``python -m repro_torch.launch.train --mesh single`` under NCCL at world
   size 1 (torchrun's environment variables set by hand): its loss lines
   and params bitwise ``--mesh debug --workers 1``'s (these four processes
   start together), then ``core.distributed.ProcessGroupAxes`` at world
   size 1 in this process on a (1, 2^20) leaf: gather, bucketed and
   chunked medians bitwise ``InProcessAxes({"data": 1})``'s (B4 + B5; the
   median of one row takes the sort path, no B1).  NCCL refuses two ranks
   on one card, so 4-rank runs are held on gloo on the CPU
   (tests/test_torch_process_group.py);
18. the audio and vision frontends, the whisper encoder and its
   cross-attention: (a) whisper-smoke and internvl2-smoke in f32, card
   against CPU from one set of params and one frontend: forward logits,
   loss and every gradient leaf, whisper's prefill and 4 decode steps,
   internvl2's prefill (within 1e-5); the cross blocks' FFN gradients
   exactly 0 on both; decode on a vision prefill's cache raising on both;
   one m = 4 window each under alie (one B1 launch, bitwise); (b)
   whisper-small (12 + 12 layers, 1500 stub frames, D = 419,460,096 in 31
   leaves) and internvl2-1b (24 layers, 256 stub patches, D = 629,636,224
   in 12 leaves) at full width and depth in bf16, trained as 15b (4
   workers, batch 8, seq 128, AdamW 1e-4) for 4 steps in windows of 2:
   gather median and gather trimmed mean beta 0.25 under alie alpha 0.25,
   and gather median without an attack for 4 steps in windows of 2 (remat
   off; their first-window losses are 22c's model-1 reference).  One B1
   (B2) launch a step over
   every leaf and no other kernel; the last window's aggregates bitwise
   their plain versions in 2^26 column slices; the cross FFN coordinates
   of every aggregate exactly 0; the losses finite, falling in the clean
   run (alie stalls internvl2-1b's at m = 4; reported); steps/s, tokens/s,
   peak memory, the alie median run's step split (gradients, attack,
   B1/B2, AdamW) and device busy share, and B1/B2 against the HBM bound
   (1.252 / 1.880 ms); (c)
   the cache paths at full width in f32 against the teacher-forced
   forward (2e-3, tests/test_models_smoke.py's): whisper-small's prefill
   of 4 prompts of 16 tokens (1500 frames, the chunked attention) and 16
   decode steps; internvl2-1b's prefill, its decode raising; (d)
   ``python -m repro_torch.launch.train --smoke`` for both in this
   process: one B1 launch a step;
19. FSDP (``param_mode='fsdp'``, the robust reduce-scatter in the
   backward): (a) 15a's tiny llama in f32 over 4 in-process workers, gather
   median under sign_flip alpha 0.25, 3 SGD steps on the card and the CPU
   (within 1e-5) and the card's run bitwise its replicated run, one B1
   launch a step; (b) 15b's cell (llama3.2-3b's widths at 8 of 28 layers,
   D = 1,593,363,456 bf16, 4 workers, batch 8, seq 128, AdamW 1e-4) for 4
   steps in windows of 2: gather median and trimmed mean beta 0.25 under
   alie alpha 0.25 (remat off), each with param_mode='fsdp' and then
   'replicated' (the fsdp runs profiled).  The
   params after each window bitwise equal between the two (compared on the
   host after the window's clock stopped); fsdp aggregates each ``blocks``
   leaf once a layer (75 leaves, 3 B1 / B2 launches a step), replicated 12
   leaves in one; the last step's aggregate bitwise its plain version in
   column slices; steps/s, the step's split (gradients, attack,
   reduce-scatter, B1/B2, AdamW), device busy share, peak memory, and B1/B2
   over the fsdp rows against the 4.756 ms HBM bound; (c) the tiny llama's
   fsdp train_loop over ProcessGroupAxes under NCCL at world size 1 (the
   gathers and their reduce-scatter backward as NCCL collectives) bitwise
   InProcessAxes({"data": 1}), no B1 (one row sorts); (d) the bytes of
   params and AdamW moments a rank holds of llama3.2-3b at 28 layers, fsdp
   over 4 ranks against replicated, computed from ``abstract_state``'s
   shapes on the meta device (not measured);
20. tensor parallelism (a model axis of 2 on the in-process mesh: each
   layer's model ranks in turn, from chunks of the global view): (a)
   llama3.2-3b's widths at 2 layers in f32, the logits, loss and every
   gradient at make_debug_mesh(4, 2) against make_debug_mesh(4, 1) (within
   1e-4 of each value's largest magnitude); (b) 15b's cell at (4, 2) beside
   the same run at model 1 (remat off): gather median and trimmed mean beta
   0.25 under alie alpha 0.25, 2 steps in one window, each window's loss
   within 1e-3
   of model 1's, the first window's grad norm within 1e-3 and the run's
   update (final - initial params) within 0.6 of model 1's (limits set
   between sound and frozen-leaf runs on the card by
   scripts/tp_witness.py), one B1 (B2) launch a step over 12 leaves, every
   step's aggregate bitwise its plain version (column slices), steps/s, the
   step's split (gradients, model-axis sums, aggregation, B1/B2, AdamW),
   launches a step, busy share, peak memory, and B1/B2 over the rows
   against the 4.756 ms HBM bound; (c) granite-moe-1b-a400m at 12 of 24
   layers (16b's cell), expert-parallel (16 experts a shard, embed and lm head split
   on d_model), 4 steps of gather median under alie at (4, 2) beside model
   1, losses within 1e-3, grad norms within 1e-2 and the update within
   0.6, every step's aggregate bitwise its plain version; (d) the bytes
   of params and AdamW moments a rank holds of llama3.2-3b at 28 layers
   over (data 4, model 2), computed from ``abstract_state``'s shapes (not
   measured); (e) the chunked strategy (B4, B5) at (4, 2): 15a's tiny
   llama, 2 steps of median and trimmed mean under alie, losses within
   1e-4 of model 1's.  A process group with a
   model axis needs a card a rank (NCCL refuses two ranks on one GPU);
   the world-size-1 checks (17d, 19c) stand;
21. serving under tensor parallelism (the model axis of 2 in process, as
   phase 20): (a) 14a's tiny model and granite-moe-smoke in f32 (TF32
   off): the prefill and 8 decode steps' logits at make_debug_mesh(1, 2)
   within 1e-5 (relative to the largest) of model 1's, the engine's greedy
   tokens equal to model 1's wherever model 1's top-2 gap exceeds 2e-5, and
   a hot swap at model 2 keeps the storage; (b) 14b's cell (llama3.2-3b
   widths, 8 of 28 layers, bf16, 32 requests, 4 slots) at
   make_debug_mesh(4, 2), the serve shim's default mesh: serve only,
   median and trimmed mean beta 0.25 adapting every 8 ticks, each run held
   as 14b (every request served, >= 2 rounds, one B1 / B2 launch over one
   leaf a round, bitwise its plain version on the round's rows), tick ms,
   launches a tick, busy share, the round's split, peak memory (B1/B2 at
   these rows' shapes are timed in 14b and 16b), and the share of greedy
   tokens equal to 14b's model-1 runs (recorded, not held: bf16 partials
   summed in rank order may flip near-ties); (c) granite-moe-1b-a400m at
   12 of 24 layers (16b's cell: expert-parallel, embed and lm head split on
   d_model), 24 requests, the median run, held as (b); (d) ``python -m
   repro_torch.launch.serve --arch <arch> --smoke`` with its defaults
   (the debug mesh, 4 workers, model 2) on the card for
   llama3.2-3b, granite-moe, mamba2 and recurrentgemma: every request
   served at (data 4, model 2), exit 0; (e) the bytes a rank
   holds of llama3.2-3b at 28 layers at (data 4, model 2) and model 1: the
   params, the slot pool (4 slots, 32 positions) and the (4, D_rank) f32
   rows, computed from the shapes (not measured);
22. tensor parallelism of the ssm / rec layers, the whisper encoder and
   cross-attention and the vision prefix, and remat (the model axis of 2
   in process): (a) f32 at published widths and shallow depth, model 2
   against model 1 in one call (make_debug_mesh(1, 2)): mamba2-2.7b at 2
   layers, recurrentgemma-2b at 3 (rec, rec, attn), whisper-small at 2 + 2,
   internvl2-1b at 2: the logits, the loss and every gradient leaf within
   1e-4 of the model-1 value's largest magnitude; (b) 16b's mamba2-2.7b
   and recurrentgemma-2b cells at make_debug_mesh(4, 2): one median run
   each, held as 16b (every request served, >= 2 rounds, one B1 launch a
   round, bitwise its plain version on the round's rows), the round's
   split and profile, a 2-tick profile (tick ms, launches a tick, busy),
   peak memory and the share of whole requests equal to 16b's model-1
   tokens (printed); (c) 18b's whisper-small and internvl2-1b cells at
   make_debug_mesh(4, 2), gather median under alie alpha 0.25, one window
   of 2 steps: one B1 launch a step over every leaf, each held bitwise on
   its rows, the window's loss within 1e-3 of 18b's model-1 first window,
   the step's split (with the model-axis sums), launches a step, busy,
   peak; (d) remat on 15b's cell, replicated and fsdp, gather median under
   alie, 2 steps with remat off and then on: the losses, every
   aggregation call's input digests (the B1 inputs), the final params and
   the B1 launches equal, the remat runs' launches held bitwise, each
   run's step ms and peak memory; (e) the bytes a rank holds of
   mamba2-2.7b at 64 layers and recurrentgemma-2b at 26 at (data 4,
   model 2) and model 1 (params, pool, rows), computed from the shapes;
23. the rest of the reference's step on the model axis (in process at
   make_debug_mesh(4, 2): NCCL refuses two ranks on one GPU, so the gloo
   tests carry the process group): (a) fsdp and (b) seq_parallel on 15b's
   cell (gather median under alie, AdamW 1e-4, remat off), one window of 2
   steps each, bitwise a replicated model-2 median run's first window (the
   loss, every step's aggregation inputs as per-worker multiset digests,
   the params after it): for 23a 20b's, for 23b one with the block norms
   in seq_parallel's per-rank form; every aggregation call held bitwise
   on its rows, the step's split with the model-axis sums (23a also a
   profile: launches, busy); (c) int8 and count_sketch through
   make_train_step and topk through the trainer's window, 2 steps each at
   15b's widths cut to 2 layers, every worker's codec call held against a
   rerun of the codec on the same rows and generator state (run first, by
   digest); (d) gauss alpha 0.25, 2 steps at 2 layers, every payload
   bitwise a rerun of the draw; (e) the feedback adapter on 21c's
   granite-moe cell cut to 4 layers with int8 and with gauss alpha 0.25,
   24 requests, >= 1 round each, each round's decoded or attacked (4, D)
   rows bitwise a rerun of the model-1 function and its B1 launch bitwise
   its plain version on them (in process the model-2 codec call and draw
   are model 1's on whole rows, so (c)-(e) hold the card's determinism,
   which each model rank of a process group needs; the gather / cut / whole
   draw over the model axis is held by the gloo tests); (f) the bytes a rank holds of
   llama3.2-3b at 28 layers under fsdp × TP, fsdp and TP, and the residual
   stream with and without seq_parallel at train_4k, computed;
24. serving a frontend configuration on the model axis, and the dry-run
   held against a real rank: (a) whisper-small (prefill and 16
   teacher-forced decode steps) and internvl2-1b (prefill) at published
   widths and depth in f32, at make_debug_mesh(4, 2) against (4, 1): the
   relative logit error within 22a's 1e-4 (21a's serving limit 1e-5
   printed beside), the model-2 and model-1 ms; (b) llama3.2-3b's
   ``train_4k``, ``prefill_32k`` and ``decode_32k`` planned by
   ``repro_torch.launch.dryrun`` on the single mesh (meta stand-ins, a fake
   group of 256 ranks; one subprocess each, on the CPU, started after
   phase 1),
   ``prefill_32k`` (its plan under 70 GB) and mamba2-2.7b's ``decode_32k``
   then run once on the card's real tensors in a subprocess under the same
   fake group (the collectives move no data, so its values are not
   checked): ``torch.cuda.max_memory_allocated()`` within 15 % of the
   plan's peak, the plan's roofline bound (H100 SXM data sheet at 700 W)
   not above the measured step time, and each kernel's launches the
   plan's;
25. attention on each rank's kv-head group where the kv heads do not
   divide the model size (``padded``, in process: a layer's ranks one after
   the other), in f32 against model 1: (a) llama3.2-3b's widths at 2 layers
   at make_debug_mesh(1, 16) (8 kv heads: one on ranks 0-7, none on 8-15):
   the loss and every gradient and the forward's logits on 2 x 1,600 tokens
   (the weights' columns move), a 64-token prefill and 4 decode steps (the
   products' columns move), each within 20a's 1e-4 of the model-1 value's
   largest magnitude, and the last rank's slot pool zero wide; (b)
   whisper-small at full depth at make_debug_mesh(1, 8) (12 kv heads: two on
   ranks 0-5, none on 6-7; the encoder and cross-attention too): the loss
   and every gradient, and 24a's prefill and 16 decode steps, within 1e-4,
   with each size's ms; (c) 24b's llama3.2-3b ``prefill_32k`` rank, which
   24b held to its plan, printed beside its step when the attention was
   gathered (40.4-41.0 s);
26. the reference's examples on the card through the port's: (a)
   ``examples/torch_train_lm_robust.py``'s ``main`` at full width
   (demo-100m: 8 layers, d 768, 99,496,704 params, bf16) on its 4 x 2
   in-process mesh for 30 steps (300 cut for time) under label_flip with
   the bucketed median: every loss and grad norm finite, the last loss
   below the first by 2.0, B1 launched once a step as the code implies
   (``launches_for`` the bucketed strategy's super-buckets) and nothing
   else, the checkpoint restored on the card bitwise, its s/step printed;
   (b) ``examples/torch_one_round_federated.py``'s ``main`` at its
   defaults: the median within 3 points of the mean (Table 4's claim; at
   these defaults neither package's median beats its mean), the streaming
   median within one bin width of the exact one on the same rows, B1 once
   and B4 / B5 once a chunk of 4 workers.
The launch counters are zeroed before each of phases 8-13, each run of
phase 14b, 15b, 16b, 18b, 19b, 20b, 20c, 21b, 21c, 22b, 22c, 22d and 23a-23e, phases 15c, 19a, 19c, 20e, 26a and 26b, each 16d
and 18d run and each call (17a), round (17b) or set of calls (17d) of phase
17, and read after; the kernels line gives each kernel's launches on them
(``launches_new_paths``).  The combine's counters are zeroed before
phases 16, 20, 21 and 23 (each runs the MoE layer on the card) and read
after, and the first call of each shape each of them made is recorded and
held as 16e holds its own (CombineCalls).
In phases 4, 6, 8-13, 15c, 17, 18, 19, 20e and 26 the inputs each kernel wrapper gets
(the first call of each shape) are
recorded, and after the path's counts were read each kernel is run again on
them and held against its plain version, bitwise (PathInputs); a kernel that
launched on a path and was not held fails.  Phase 20's model-2 runs and
phases 22's and 23's hold every launch's output against the plain version on that
launch's own rows instead (HeldAggregation; a recorded copy of the rows does
not fit beside them).  The CLI phases (6's CLI, 14c, 15d, 16c, 17c and
17d's CLIs, 21d) run as a batch of subprocesses, three groups at a time,
started after phase 1 beside phases 2-4 (which time nothing) and read
before phase 5; their lines print there.  Each phase prints its seconds.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores

SWEEP_M = (2, 3, 5, 8, 10, 16, 17, 32, 40, 64)
SWEEP_N = (1, 1000, 4097)
TRIM_SWEEP_M = (10, 17, 40)
CNN_LEAVES = 8
CNN_ITERS = 30


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------- helpers


def adversarial_rows(m: int, n: int, seed: int):
    """N(0,1) rows with adversarial columns: ±1e30 rows, a NaN, mixed ±0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    if n >= 4:
        x[: max(1, m // 4), 0] = 1e30
        x[: max(1, m // 4), 1] = -1e30
        x[m // 2, 2] = np.nan
        x[:, 3] = np.where(rng.random(m) < 0.5, -0.0, 0.0)
    return x


def special_rows(m: int, n: int, seed: int):
    """N(0,1) rows with one value in four drawn from ±0, ±inf, ±1e30, f32
    subnormals and the smallest normal, and a NaN in one column."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, 1e30, -1e30, 1e-40, -1e-40, 1.4e-45,
                     -1.4e-45, 1.1754944e-38, -3e-39], dtype=np.float32)
    pick = rng.random((m, n)) < 0.25
    x[pick] = pool[rng.integers(0, len(pool), int(pick.sum()))]
    if n >= 3:
        x[m // 2, n // 3] = np.nan
    return x


def compare(got, want):
    """(bit mismatches, max |got - want|): NaN matches NaN, -0 != +0."""
    import torch

    g, w = got.float(), want.float()
    gn, wn = torch.isnan(g), torch.isnan(w)
    ok = torch.where(gn | wn, gn & wn, g.view(torch.int32) == w.view(torch.int32))
    diff = torch.where(gn | wn, torch.where(gn & wn, 0.0, float("inf")), (g - w).abs())
    return int((~ok).sum()), float(diff.max()) if diff.numel() else 0.0


class PathInputs:
    """Inside ``with``: records what a main path hands the kernel wrappers
    (robust_agg's median / trimmed-mean / fused calls, histogram_agg's
    minmax and histogram), the first call of each kernel, shapes, dtype and
    16-byte alignment, as copies at the same alignment.  ``hold`` then runs
    each kernel again on those inputs and compares it with its plain
    version, bitwise.  Call it after the path's launch counts were read:
    its launches are not the path's."""

    def __enter__(self):
        from repro_torch.kernels import histogram_agg as H
        from repro_torch.kernels import robust_agg

        self.calls = {}
        self._orig = {"select": robust_agg._select_many, "minmax": H.minmax,
                      "histogram": H.histogram}
        self._patched = [(robust_agg, "_select_many", "select"), (H, "minmax", "minmax"),
                         (H, "histogram", "histogram")]
        for mod, attr, kind in self._patched:
            setattr(mod, attr, self._recording(kind))
        return self

    def __exit__(self, *exc):
        for mod, attr, kind in self._patched:
            setattr(mod, attr, self._orig[kind])

    @staticmethod
    def _sig(v):
        import torch

        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), str(v.dtype), v.data_ptr() % 16)
        if isinstance(v, (list, tuple)):
            return tuple(PathInputs._sig(t) for t in v)
        return v

    @staticmethod
    def _copy(v):
        import torch

        if isinstance(v, torch.Tensor):
            off = (v.data_ptr() % 16) // v.element_size()
            buf = torch.empty(v.numel() + off, dtype=v.dtype, device=v.device)[off:]
            return buf.view(v.shape).copy_(v)
        if isinstance(v, (list, tuple)):
            return [PathInputs._copy(t) for t in v]
        return v

    def _recording(self, kind):
        fn = self._orig[kind]

        def recorded(*args, **kwargs):
            x = args[1][0] if kind == "select" and args[1] else args[0]
            if getattr(x, "is_cuda", False):
                key = (kind, self._sig(args), tuple(sorted(kwargs.items())))
                if key not in self.calls:
                    self.calls[key] = (self._copy(args), dict(kwargs))
            return fn(*args, **kwargs)

        return recorded

    def hold(self, label: str, worst: dict) -> set:
        """Each recorded call again, kernel vs plain version, bitwise; returns
        the names of the kernels held."""
        import torch

        from repro_torch.kernels import histogram_agg as H
        from repro_torch.kernels import selection_network as SN

        held, shapes = set(), []
        for (kind, _, _), (args, kwargs) in self.calls.items():
            if kind == "select":
                name, xs, trim = args
                got = self._orig["select"](name, xs, trim)
                if name == "median":
                    want = [[SN.median_select(x) for x in xs]]
                elif name == "trimmed_mean":
                    want = [[SN.trimmed_mean_select(x, trim) for x in xs]]
                else:
                    want = [list(o) for o in zip(*(SN.median_and_trimmed_select(x, trim)
                                                   for x in xs))]
                pairs = [(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws)]
                shape = f"{name} {[tuple(x.shape) for x in xs]} {xs[0].dtype}"
            elif kind == "minmax":
                name = "minmax"
                pairs = list(zip(self._orig["minmax"](*args), H.minmax_plain(*args)))
                shape = f"minmax {tuple(args[0].shape)} {args[0].dtype}"
            else:
                name = "histogram"
                pairs = list(zip(self._orig["histogram"](*args, **kwargs),
                                 H.histogram_plain(*args, **kwargs)))
                shape = f"histogram {tuple(args[0].shape)} {args[0].dtype} {args[3]} bins " \
                        f"sums={kwargs.get('with_sums', args[4] if len(args) > 4 else True)}"
            torch.cuda.synchronize()
            for g, w in pairs:
                if w is None:
                    check(g is None, f"{label}: {shape}: the kernel wrote sums the plain "
                                     f"version did not")
                    continue
                bad, err = compare(g, w)
                check(bad == 0, f"{label}: {shape}: {bad} mismatches vs the plain version "
                                f"on the path's inputs (max |err| {err})")
                worst[name] = max(worst[name], err)
            held.add(name)
            shapes.append(shape)
        print(f"{label}: kernels held against their plain versions on the path's own "
              f"inputs, bitwise: {shapes}")
        return held


def time_ms(fn, reps: int) -> float:
    """Mean time per call over ``reps`` calls, CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(a, b, reps: int):
    """Mean times per call of ``a`` and ``b`` (time_ms), taken in turns a, b,
    b, a, so that drift on the host touches both alike."""
    ta, tb = time_ms(a, reps), time_ms(b, reps)
    tb, ta = (tb + time_ms(b, reps)) / 2, (ta + time_ms(a, reps)) / 2
    return ta, tb


def device_ms(fn, reps: int, name: str = "", launches: int = 0):
    """Device time per call of the kernels whose name contains ``name``
    (every kernel for ""), from torch.profiler (None when three traces show
    no such kernel).  The trace covers the host as well as the card: one of
    the card alone now and then came back with some of the launches, or
    with none.  With ``launches`` (the kernel's launches per call), a trace
    holding another count is not used: after many long launches a trace
    has come back with two of five."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        us = sum(e.self_device_time_total for e in rows)
        if us and (not launches or sum(e.count for e in rows) == launches * reps):
            return us / 1e3 / reps
    return None


def ms_text(x) -> str:
    """A time for the log: ``not measured`` where the trace kept nothing."""
    return "not measured" if x is None else f"{x:.5f}"


# ------------------------------------------------------------------ phases

CNN_LEAF_SIZES = (144, 16, 2304, 16, 50176, 64, 640, 10)  # the CNN's 8 leaves
MULTI_LEAF_M = (10, 17, 40)
TIMING_SHAPES = (("cnn fc1 leaf", 10, 50176, "float32"), ("logreg w leaf", 40, 7840, "float32"),
                 ("bandwidth", 32, 1 << 24, "float32"), ("bandwidth, odd m", 31, 1 << 24, "float32"),
                 ("bandwidth", 32, 1 << 24, "bfloat16"), ("bandwidth", 32, 1 << 24, "float16"),
                 ("bandwidth, odd m", 31, 1 << 24, "float16"))
# the worker counts the float16 programs are built and checked at (phase 7)
HALF_M = (1, 2, 3, 8, 10, 31, 32, 40, 64)


def sweep_trim(m: int) -> int:
    return max(1, m // 10) if m >= 3 else 0


def select_specs():
    """Every (kind, m, trim, dtype) of the order-statistic kernels this
    script runs: in f32 and bf16, phase 2's sweeps, the quickstart (m=8,
    beta 0.3), the CNN (m=10, beta 0.1; also phase 17's and 26b's rows),
    linreg m=40 (beta 0.05), phase 5's shapes, phases 14-15's and 26a's rows
    (m=4: the median, beta 0.25) and m=1 (phase 2); the fused kernel at each (m, trim)
    of the trimmed mean.  In
    f16 only what phase 7 and phase 5 run: the three kinds at HALF_M with
    sweep_trim(m), which is also int(0.1 * m) at the timed m = 31, 32.  In f32
    also the programs of phase 13's matrix (matrix_programs)."""
    import torch

    progs = {("median", 1, 0), ("trimmed_mean", 1, 0), ("median", 8, 0),
             ("trimmed_mean", 8, int(0.3 * 8)), ("trimmed_mean", 40, int(0.05 * 40)),
             ("median", 4, 0), ("trimmed_mean", 4, int(0.25 * 4))}
    for m in SWEEP_M + MULTI_LEAF_M + tuple(s[1] for s in TIMING_SHAPES):
        progs |= {("median", m, 0), ("trimmed_mean", m, sweep_trim(m)),
                  ("trimmed_mean", m, int(0.1 * m))}
    for m in TRIM_SWEEP_M:
        progs |= {("trimmed_mean", m, t) for t in range((m + 1) // 2)}
    progs |= {("fused_median_trimmed", m, t) for k, m, t in progs if k == "trimmed_mean"}
    half = {(k, m, sweep_trim(m) if k != "median" else 0) for m in HALF_M
            for k in ("median", "trimmed_mean", "fused_median_trimmed")}
    return ([(k, m, t, d) for k, m, t in sorted(progs) for d in (torch.float32, torch.bfloat16)]
            + [(k, m, t, torch.float16) for k, m, t in sorted(half)]
            + [(k, m, t, torch.float32) for k, m, t in sorted(matrix_programs() - progs)])


def ptxas_report(lib):
    """(registers, spill bytes, stack bytes) maxima over the kernels in a
    library's ptxas log, and the number of kernels."""
    import re

    text = lib.with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in
              re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    stack = [int(a) for a in re.findall(r"(\d+) bytes stack frame", text)]
    return max(regs, default=0), max(spills, default=0), max(stack, default=0), len(regs)


def registers_by_program_kind(libs):
    """The most registers a kernel of each order-statistic kind uses (the
    program struct's prefix, med_ / tm_ / fu_, in the kernel's mangled name),
    over the libraries' ptxas logs."""
    import re

    most = {}
    for lib in libs:
        kind = None
        for line in lib.with_suffix(".log").read_text().splitlines():
            entry = re.search(r"Compiling entry function '([^']*)'", line)
            if entry:
                named = re.search(r"\d(med|tm|fu)_m\d+", entry.group(1))
                kind = named.group(1) if named else None
            used = re.search(r"Used (\d+) registers", line)
            if used and kind:
                most[kind] = max(most.get(kind, 0), int(used.group(1)))
    return most


def check_spills(libs, label: str) -> None:
    """Print each library's ptxas maxima; fail on any spill."""
    for lib in libs:
        regs, spill, stack, kernels = ptxas_report(lib)
        print(f"  ptxas {lib.name}: {kernels} kernels, at most {regs} registers, "
              f"{spill} spill bytes, {stack} stack bytes")
        check(spill == 0, f"{label}: ptxas spilled in {lib.name}")


def kernel_sweep(dev, leaf_sizes):
    """Phase 2: each kernel vs its plain version, bitwise.  Returns the
    max |err| per kernel."""
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import selection_network as SN

    worst = {"median": 0.0, "trimmed_mean": 0.0, "fused_median_trimmed": 0.0}
    checked = 0

    def run(name, x, trim):
        nonlocal checked
        if name == "median":
            pairs = [(robust_agg.median(x), SN.median_select(x))]
        elif name == "trimmed_mean":
            pairs = [(robust_agg.trimmed_mean(x, trim), SN.trimmed_mean_select(x, trim))]
        else:
            pairs = list(zip(robust_agg.fused_median_trimmed(x, trim),
                             SN.median_and_trimmed_select(x, trim)))
        torch.cuda.synchronize()
        for got, want in pairs:
            bad, err = compare(got, want)
            check(bad == 0, f"{name} m={x.shape[0]} n={x.shape[1]} {x.dtype} trim={trim}: "
                            f"{bad} mismatches vs the plain version (max |err| {err})")
            worst[name] = max(worst[name], err)
            checked += 1

    for dtype in (torch.float32, torch.bfloat16):
        for m in SWEEP_M:
            trim = sweep_trim(m)
            for n in sorted(set(SWEEP_N) | set(leaf_sizes)):  # ragged n, the CNN's leaves
                x = torch.from_numpy(adversarial_rows(m, n, seed=m * 7919 + n)).to(dev, dtype)
                for name in worst:
                    run(name, x, trim)
        for m in TRIM_SWEEP_M:
            for n in (4097, max(leaf_sizes)):
                x = torch.from_numpy(adversarial_rows(m, n, seed=m + n)).to(dev, dtype)
                for trim in range(0, (m + 1) // 2):
                    run("trimmed_mean", x, trim)
                    run("fused_median_trimmed", x, trim)
    print(f"phase 2: {checked} kernel outputs bitwise equal to the plain version "
          f"(max |err| {json.dumps(worst)})")
    return worst


def multi_leaf_sweep(dev, worst):
    """Phase 2: multi-leaf median, trimmed-mean and fused calls vs the
    per-leaf plain versions, bitwise (both of the fused kernel's outputs);
    one launch per MAX_LEAVES (32) leaves; both load paths run."""
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import select_codegen as G
    from repro_torch.kernels import selection_network as SN

    checked, paths = 0, set()

    def run(xs, trim, label, want_launches):
        nonlocal checked
        paths.update(robust_agg.plan_for(x).scalar for x in xs)
        for name in ("median", "trimmed_mean", "fused_median_trimmed"):
            before = dict(robust_agg.LAUNCHES), dict(robust_agg.LEAVES)
            if name == "median":
                got, want = robust_agg.median_many(xs), [SN.median_select(x) for x in xs]
            elif name == "trimmed_mean":
                got = robust_agg.trimmed_mean_many(xs, trim)
                want = [SN.trimmed_mean_select(x, trim) for x in xs]
            else:  # both outputs, leaf by leaf
                got = [t for pair in zip(*robust_agg.fused_median_trimmed_many(xs, trim))
                       for t in pair]
                want = [t for x in xs for t in SN.median_and_trimmed_select(x, trim)]
            torch.cuda.synchronize()
            ran = robust_agg.LAUNCHES[name] - before[0][name]
            leaves = robust_agg.LEAVES[name] - before[1][name]
            check(ran == want_launches and leaves == len(xs),
                  f"{name} {label}: {ran} launches for {leaves} leaves, want "
                  f"{want_launches} for {len(xs)}")
            per_leaf = len(got) // len(xs)  # outputs a leaf
            for i, (g, w) in enumerate(zip(got, want)):
                bad, err = compare(g, w)
                leaf = i // per_leaf
                check(bad == 0, f"{name} {label} leaf {leaf} output {i % per_leaf} "
                                f"({tuple(xs[leaf].shape)}): {bad} mismatches vs the plain "
                                f"version (max |err| {err})")
                worst[name] = max(worst[name], err)
                checked += 1

    for dtype in (torch.float32, torch.bfloat16):
        for m in MULTI_LEAF_M:
            xs = [torch.from_numpy(special_rows(m, n, seed=m * 31 + n)).to(dev, dtype)
                  for n in CNN_LEAF_SIZES]
            run(xs, sweep_trim(m), f"m={m} CNN leaves {dtype}", 1)
        cap = G.MAX_LEAVES
        xs = [torch.from_numpy(special_rows(10, 1 + 37 * i, seed=i)).to(dev, dtype)
              for i in range(2 * cap + 3)]
        run(xs, 1, f"{len(xs)} leaves {dtype}", 3)
        # misaligned inputs: a column slice made contiguous (n % 4 != 0) and a
        # view one element off; with an aligned leaf in the same launch
        base = torch.from_numpy(special_rows(10, 50176, seed=3)).to(dev, dtype)
        sliced = base[:, 1:].contiguous()
        off = torch.empty(10 * 50176 + 1, device=dev, dtype=dtype)[1:].view(10, 50176)
        off.copy_(base)
        check(robust_agg.plan_for(sliced).scalar and robust_agg.plan_for(off).scalar
              and not robust_agg.plan_for(base).scalar,
              "the misaligned leaves did not take the scalar path")
        run([sliced, off, base], 1, f"misaligned {dtype}", 1)
        run([base[:1, :4096].contiguous(), base[:1, :7].contiguous()], 0, f"m=1 {dtype}", 1)
    check(paths == {False, True}, f"the sweep missed a load path: scalar in {paths}")
    print(f"phase 2: {checked} multi-leaf kernel outputs bitwise equal to the plain version "
          f"(max |err| {json.dumps(worst)})")


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_printed(label: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with each line it prints prefixed by ``label``."""
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kwargs)
    finally:
        for line in buf.getvalue().splitlines():
            print(f"{label}: {line}" if line else f"{label}:")


def quickstart(dev):
    """Phase 3: examples/torch_quickstart.py on the card (its ``main``)."""
    out = run_printed("phase 3", load_example("torch_quickstart").main,
                      ["--device", str(dev)])
    errs = out["err"]
    check(errs["median"] < 0.2 and errs["trimmed_mean"] < 0.2,
          f"quickstart: a robust aggregator is BROKEN: {errs}")
    check(not errs["mean"] < 0.2, f"quickstart: mean is not BROKEN: {errs}")


def cnn_setup(dev):
    import torch

    from repro_torch.data.pipeline import DataConfig, make_classification_shards
    from repro_torch.models.paper_models import init_cnn

    m, n = 10, 400  # benchmarks/table3_cnn.py
    shards = make_classification_shards(DataConfig(global_batch=m * n, num_workers=m),
                                        device=dev)
    params = init_cnn(torch.Generator().manual_seed(0), device=dev)
    return shards, params


CNN_ATTACK = dict(name="sign_flip", alpha=0.1, scale=20.0)


def cnn_config(method, iters):
    from repro_torch.core.robust_gd import RobustGDConfig

    return RobustGDConfig(method=method, beta=0.1, step_size=0.05, num_iters=iters)


def main_path(dev):
    """Phase 4: Algorithm 1 on the CNN; returns the launch counts."""
    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import make_robust_gd_stages, robust_gd
    from repro_torch.kernels import ops, robust_agg
    from repro_torch.models.paper_models import cnn_loss

    shards, params = cnn_setup(dev)
    check(sum(p.numel() for p in params.values()) == 53370 and len(params) == CNN_LEAVES,
          "the CNN is not the paper's width-16 network")
    pooled = {"x": shards["x"].reshape(-1, 784), "y": shards["y"].reshape(-1)}
    loss0 = float(cnn_loss(params, pooled))
    attack = AttackConfig(**CNN_ATTACK)
    torch.cuda.synchronize()

    robust_agg.reset_launches()  # zeroed just before robust_gd's runs
    finals = {}
    for method in ("median", "trimmed_mean"):
        t0 = time.perf_counter()
        w, _ = robust_gd(cnn_loss, params, shards, cnn_config(method, CNN_ITERS), attack)
        torch.cuda.synchronize()
        loss = float(cnn_loss(w, pooled))
        print(f"phase 4: cnn {method:13s} loss {loss0:.4f} -> {loss:.4f} after "
              f"{CNN_ITERS} iterations ({time.perf_counter() - t0:.2f} s, first call included)")
        check(loss == loss and abs(loss) != float("inf"), f"cnn {method}: loss not finite")
        check(loss < loss0, f"cnn {method}: loss did not fall ({loss0} -> {loss})")
        finals[method] = w
    launches = dict(robust_agg.LAUNCHES)  # read just after robust_gd's runs
    leaves = dict(robust_agg.LEAVES)
    print(f"phase 4: launches on robust_gd's path: median {launches['median']} "
          f"({leaves['median']} leaves), trimmed_mean {launches['trimmed_mean']} "
          f"({leaves['trimmed_mean']} leaves)")
    for name in ("median", "trimmed_mean"):  # one launch a step over all 8 leaves
        check(launches[name] == CNN_ITERS and leaves[name] == CNN_ITERS * CNN_LEAVES,
              f"{name} kernel: {launches[name]} launches for {leaves[name]} leaves, want "
              f"{CNN_ITERS} for {CNN_ITERS * CNN_LEAVES}")
    check(launches["fused_median_trimmed"] == 0, "robust_gd launched the fused kernel")
    launches.update({f"{k}_leaves": v for k, v in leaves.items()})
    # Algorithm 1 never runs the fused kernel: call its entry point on the
    # ops surface directly, on the final per-worker gradients
    stages = make_robust_gd_stages(cnn_loss, shards, cnn_config("median", 1), attack)
    grads = stages.attack(stages.local_work(finals["median"], CNN_ITERS),
                          {k: torch.zeros_like(v) for k, v in params.items()}, CNN_ITERS)
    fused = {k: ops.fused_median_trimmed(g, beta=0.1) for k, g in grads.items()}
    flats = [g.reshape(g.shape[0], -1).contiguous() for g in grads.values()]
    trim = int(0.1 * flats[0].shape[0])
    many = dict(zip(grads, zip(*robust_agg.fused_median_trimmed_many(flats, trim))))
    torch.cuda.synchronize()
    launches["fused_median_trimmed"] = robust_agg.LAUNCHES["fused_median_trimmed"]
    launches["fused_median_trimmed_leaves"] = robust_agg.LEAVES["fused_median_trimmed"]
    print(f"phase 4: fused kernel: {launches['fused_median_trimmed']} launches "
          f"({launches['fused_median_trimmed_leaves']} leaves): ops.fused_median_trimmed on "
          f"each leaf and fused_median_trimmed_many over all {CNN_LEAVES}, called directly; "
          f"not on robust_gd's path")
    check(launches["fused_median_trimmed"] == CNN_LEAVES + 1
          and launches["fused_median_trimmed_leaves"] == 2 * CNN_LEAVES,
          f"fused kernel: {launches['fused_median_trimmed']} launches for "
          f"{launches['fused_median_trimmed_leaves']} leaves, want {CNN_LEAVES + 1} for "
          f"{2 * CNN_LEAVES}")
    for (k, g), flat in zip(grads.items(), flats):
        med, tm = fused[k]
        check(compare(med, robust_agg.median(flat).reshape(med.shape))[0] == 0,
              f"fused median != median kernel on leaf {k}")
        check(compare(tm, robust_agg.trimmed_mean(flat, trim).reshape(tm.shape))[0] == 0,
              f"fused trimmed mean != trimmed-mean kernel on leaf {k}")
        check(bool(torch.isfinite(med).all() and torch.isfinite(tm).all()),
              f"non-finite aggregate on leaf {k}")
        for got, want in zip(many[k], (med, tm)):
            check(compare(got, want.reshape(-1))[0] == 0,
                  f"fused_median_trimmed_many != fused_median_trimmed on leaf {k}")
    return launches


def cpu_agreement(dev):
    """Phase 4b: the first 3 iterates on the card vs the same run on the CPU.
    Tolerance: 1e-4 of each leaf's scale (f32 convolution and reduction
    orders differ between cuDNN and the CPU; the median then selects among
    values that differ by the same few ulps)."""
    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import robust_gd
    from repro_torch.models.paper_models import cnn_loss

    shards, params = cnn_setup(dev)
    attack = AttackConfig(**CNN_ATTACK)
    keys = sorted(params)
    iterate = lambda w: torch.cat([w[k].reshape(-1) for k in keys])  # every leaf, flat
    to_cpu = lambda t: {k: v.cpu() for k, v in t.items()}
    for method in ("median", "trimmed_mean"):
        _, on_card = robust_gd(cnn_loss, params, shards, cnn_config(method, 3), attack,
                               trajectory_fn=iterate)
        _, on_cpu = robust_gd(cnn_loss, to_cpu(params), to_cpu(shards),
                              cnn_config(method, 3), attack, trajectory_fn=iterate)
        on_card = on_card.cpu()
        for it in range(3):
            worst, start = 0.0, 0
            for k in keys:
                size = params[k].numel()
                g = on_card[it, start:start + size]
                c = on_cpu[it, start:start + size]
                start += size
                rel = float((g - c).abs().max()) / max(float(c.abs().max()), 1e-12)
                worst = max(worst, rel)
                check(rel <= 1e-4, f"cnn {method} iterate {it + 1} leaf {k}: card vs CPU "
                                   f"differ by {rel:.3g} of the leaf scale")
            print(f"phase 4: cnn {method:13s} iterate {it + 1}: card vs CPU max diff "
                  f"{worst:.3g} of leaf scale")


def table2_linreg(dev):
    """Phase 4c: linreg at the paper's Table 2 worker count, m=40."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import RobustGDConfig, run_linreg_experiment
    from repro_torch.kernels import robust_agg

    attack = AttackConfig("sign_flip", alpha=0.05, scale=10.0)
    for method in ("median", "trimmed_mean"):
        before = dict(robust_agg.LAUNCHES)
        cfg = RobustGDConfig(method=method, beta=0.05, step_size=0.5, num_iters=100)
        err, _ = run_linreg_experiment(1, d=20, n=300, m=40, sigma=0.5, cfg=cfg,
                                       attack=attack, device=dev)
        ran = robust_agg.LAUNCHES[method] - before[method]
        print(f"phase 4: linreg m=40 {method:13s} ||w - w*|| = {float(err):.4f} "
              f"({ran} kernel launches)")
        check(float(err) < 0.2, f"linreg m=40 {method} is BROKEN")
        check(ran == 100, f"linreg m=40 {method}: {ran} launches, want 100")


def op_count(name: str, m: int, trim: int) -> int:
    """Operations per coordinate: 2 per comparator, plus the midpoint
    (even m) and the band's adds and division."""
    from repro_torch.kernels import selection_network as SN

    prog = {"median": lambda: SN.median_program(m),
            "trimmed_mean": lambda: SN.trimmed_program(m, trim),
            "fused_median_trimmed": lambda: SN.fused_program(m, trim)}[name]()
    ops = 2 * prog.size
    if name != "trimmed_mean" and m % 2 == 0:
        ops += 2
    if name != "median":
        ops += m - 2 * trim
    return ops


def bound(name: str, m: int, n: int, trim: int, elem: int):
    outs = 2 if name == "fused_median_trimmed" else 1
    mem_ms = (m * n + outs * n) * elem / MEM_BYTES_PER_S * 1e3
    ops_ms = op_count(name, m, trim) * n / F32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def library_call(name: str, x):
    """One PyTorch call that computes the same function, or None.  Only the
    median has one: torch.median for odd m (it returns the lower middle value
    for even m), and for even m torch.quantile's midpoint, which takes f32 of
    at most 2^24 elements.  No call computes the trimmed mean."""
    import torch

    if name != "median":
        return None
    if x.shape[0] % 2:
        return lambda: torch.median(x, dim=0).values
    if x.dtype == torch.float32 and x.numel() <= 1 << 24:
        return lambda: torch.quantile(x, 0.5, dim=0, interpolation="midpoint")
    return None


def timings(dev, card: str):
    """Phase 5: kernel / plain / library times; returns the rows."""
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import selection_network as SN

    rows = []
    for label, m, n, dtype in TIMING_SHAPES:
        dtype = getattr(torch, dtype)
        x = torch.randn(m, n, device=dev).to(dtype)
        trim = int(0.1 * m)
        big = n >= 1 << 20
        fns = {
            "median": (lambda: robust_agg.median(x), lambda: SN.median_select(x)),
            "trimmed_mean": (lambda: robust_agg.trimmed_mean(x, trim),
                             lambda: SN.trimmed_mean_select(x, trim)),
            "fused_median_trimmed": (lambda: robust_agg.fused_median_trimmed(x, trim),
                                     lambda: SN.median_and_trimmed_select(x, trim)),
        }
        for name, (kernel, plain) in fns.items():
            b_ms, b_by = bound(name, m, n, trim, x.element_size())
            lib = library_call(name, x)
            row = {"shape": label, "kernel": name, "m": m, "n": n, "trim": trim,
                   "dtype": str(dtype).removeprefix("torch."),
                   "ms": time_ms(kernel, 20 if big else 200),
                   "device_ms": device_ms(kernel, 20, KERNEL_NAMES[name]),
                   "plain_ms": time_ms(plain, 3 if big else 20),
                   "library_ms": time_ms(lib, 20 if big else 200) if lib else None,
                   # the library's answer against the kernel's, same inputs
                   "library_max_abs_diff": compare(lib(), kernel())[1] if lib else None,
                   "bound_ms": b_ms, "bound_by": b_by, "card": card}
            rows.append(row)
            print(json.dumps({"timing": row}))
        del x
        torch.cuda.empty_cache()
    rows += multi_leaf_timings(dev, card)
    return rows


# the device kernels' names (torch.profiler keys contain them)
KERNEL_NAMES = {"median": "leaf_select_kernel", "trimmed_mean": "leaf_select_kernel",
                "fused_median_trimmed": "leaf_select_kernel"}


def multi_leaf_timings(dev, card: str):
    """Phase 5: the CNN's 8 leaves (m=10, f32) in one median, trimmed-mean
    or fused call, against 8 single-leaf calls of the same kernel and the
    plain versions leaf by leaf."""
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import selection_network as SN

    m, trim = 10, 1
    xs = [torch.randn(m, n, device=dev) for n in CNN_LEAF_SIZES]
    rows = []
    fns = {
        "median": (lambda: robust_agg.median_many(xs),
                   lambda: [robust_agg.median(x) for x in xs],
                   lambda: [SN.median_select(x) for x in xs]),
        "trimmed_mean": (lambda: robust_agg.trimmed_mean_many(xs, trim),
                         lambda: [robust_agg.trimmed_mean(x, trim) for x in xs],
                         lambda: [SN.trimmed_mean_select(x, trim) for x in xs]),
        "fused_median_trimmed": (lambda: robust_agg.fused_median_trimmed_many(xs, trim),
                                 lambda: [robust_agg.fused_median_trimmed(x, trim) for x in xs],
                                 lambda: [SN.median_and_trimmed_select(x, trim) for x in xs]),
    }
    for name, (many, single, plain) in fns.items():
        bounds = [bound(name, m, x.shape[1], trim, 4) for x in xs]
        ms, single_ms = time_pair(many, single, 200)
        row = {"shape": "cnn 8 leaves, one call", "kernel": name, "m": m,
               "n": sum(CNN_LEAF_SIZES), "trim": trim, "dtype": "float32", "ms": ms,
               "device_ms": device_ms(many, 20, KERNEL_NAMES[name]),
               "single_leaf_calls_ms": single_ms,
               "single_leaf_calls_device_ms": device_ms(single, 20, KERNEL_NAMES[name]),
               "plain_ms": time_ms(plain, 20), "library_ms": None,
               "bound_ms": sum(b for b, _ in bounds), "bound_by": "bytes", "card": card}
        check(all(by == "bytes" for _, by in bounds), "a CNN leaf is not bound by bytes")
        rows.append(row)
        print(json.dumps({"timing": row}))
    return rows


def cnn_step_time(dev):
    """Steady-state time of one Algorithm 1 step on the CNN (host clock
    around 10 steps ending in a synchronize, after 3 warm-up steps), then
    the top device-time rows of a torch.profiler trace of 3 more steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import make_robust_gd_stages
    from repro_torch.models.paper_models import cnn_loss
    from repro_torch.rounds import engine

    shards, params = cnn_setup(dev)
    out = {}
    for method in ("median", "trimmed_mean"):
        stages = make_robust_gd_stages(cnn_loss, shards, cnn_config(method, 10),
                                       AttackConfig(**CNN_ATTACK))
        body = engine.make_round_body(stages)
        state = engine.make_state(params)
        for r in range(3):
            state, _ = body(state, r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(3, 13):
            state, _ = body(state, r)
        torch.cuda.synchronize()
        out[method] = (time.perf_counter() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for r in range(13, 16):
                state, _ = body(state, r)
            torch.cuda.synchronize()
        # kernels (CUDA events) sum to the device time; each op's self
        # device time is that of the kernels it launched itself
        events = prof.key_averages()
        total = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA)
        ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.self_device_time_total, reverse=True)[:12]
        print(json.dumps({"profile_3_steps": method, "device_ms": total / 1e3, "top_ops": [
            {"op": e.key[:60], "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
            for e in ops]}))
    print(json.dumps({"cnn_step_ms": out}))


# ------------------------------------------------------- the sketch kernels

SKETCH_ROWS = (1, 7, 33, 256, 512, 1000)
SKETCH_N = (1, 32, 33, 4097, 50176)
SKETCH_NBINS = (2, 64, 256, 512, 4096)
# past the shared-memory budget: 2^15 bins with sums and 2^16 bins take the
# global-memory histogram, 2^15 counts only a one-column tile
SKETCH_WIDE_NBINS = (1 << 15, 1 << 16)


def sketch_rows(rows: int, n: int, seed: int):
    """3 * N(0,1) rows with adversarial columns: ±1e30 rows, a NaN, mixed
    ±0 and a constant (zero-width) column."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((rows, n))).astype(np.float32)
    if n >= 4:
        x[: max(1, rows // 4), 0] = 1e30
        x[rows // 2:, 0] = -1e30
        x[rows // 2, 1] = np.nan
        x[:, 2] = np.where(rng.random(rows) < 0.5, -0.0, 0.0)
        x[:, 3] = 1.25
    return x


def sketch_sweep(dev):
    """Phase 2b: the min/max and histogram kernels vs their plain versions,
    bitwise.  Returns the max |err| per kernel."""
    import torch

    from repro_torch.kernels import histogram_agg as H

    worst = {"minmax": 0.0, "histogram": 0.0}
    checked = 0
    plans = set()

    def run(x, label, nbins_set):
        nonlocal checked
        plans.add(H.minmax_plan_for(x))
        lo, hi = H.minmax(x)
        plo, phi = H.minmax_plain(x)
        torch.cuda.synchronize()
        for got, want in ((lo, plo), (hi, phi)):
            bad, err = compare(got, want)
            check(bad == 0, f"minmax {label}: {bad} mismatches vs the plain version "
                            f"(max |err| {err})")
            worst["minmax"] = max(worst["minmax"], err)
            checked += 1
        for nbins in nbins_set:
            lo, width = H.edges(plo, phi, nbins)
            for with_sums in (True, False):
                plans.add(H.histogram_plan(x.shape[0], x.shape[1], nbins, with_sums))
                got = H.histogram(x, lo, width, nbins, with_sums)
                want = H.histogram_plain(x, lo, width, nbins, with_sums)
                torch.cuda.synchronize()
                for part, g, w in zip(("counts", "sums"), got, want):
                    if w is None:
                        check(g is None, "histogram wrote sums with with_sums=False")
                        continue
                    bad, err = compare(g, w)
                    check(bad == 0, f"histogram {part} {label} nbins={nbins} "
                                    f"sums={with_sums}: {bad} mismatches vs the plain "
                                    f"version (max |err| {err})")
                    worst["histogram"] = max(worst["histogram"], err)
                    checked += 1
                del got, want
            if x.shape[1] == 50176 and nbins == 4096:
                torch.cuda.empty_cache()

    for dtype in (torch.float32, torch.bfloat16):
        for rows in SKETCH_ROWS:
            for n in SKETCH_N:
                x = torch.from_numpy(sketch_rows(rows, n, seed=rows * 7 + n)).to(dev, dtype)
                run(x, f"rows={rows} n={n} {dtype}", SKETCH_NBINS)
        # views the chunked sketch passes: a row slice whose pointer is not
        # 16-byte aligned (n = 33), and a wide chunk one element off
        base = torch.from_numpy(sketch_rows(34, 33, seed=34)).to(dev, dtype)
        run(base[1:], f"row slice x[1:] rows=33 n=33 {dtype}", SKETCH_NBINS)
        view = torch.empty(33 * 50176 + 1, device=dev, dtype=dtype)[1:].view(33, 50176)
        view.copy_(torch.from_numpy(sketch_rows(33, 50176, seed=5)))
        check(view.data_ptr() % 16 != 0 and H.minmax_plan_for(view).vec == 1,
              "the misaligned wide view did not take scalar loads")
        run(view, f"misaligned view rows=33 n=50176 {dtype}", (2, 512))
        # past the shared-memory budget
        x = torch.from_numpy(sketch_rows(33, 33, seed=33)).to(dev, dtype)
        run(x, f"rows=33 n=33 {dtype}", SKETCH_WIDE_NBINS)
    variants = {"minmax vec": sorted({p.vec for p in plans if isinstance(p, H.MinmaxPlan)}),
                "histogram": sorted({"shared" if p.shared else "global" for p in plans
                                     if isinstance(p, H.HistogramPlan)})}
    check(variants == {"minmax vec": [1, 4, 8], "histogram": ["global", "shared"]},
          f"the sweep missed a kernel variant: {variants}")
    print(f"phase 2b: {checked} sketch-kernel outputs bitwise equal to the plain version "
          f"(max |err| {json.dumps(worst)}; variants {json.dumps(variants)})")
    return worst


def approx_repeatable(dev):
    """Phase 2c: the approx_* aggregators on the card (through the sketch
    kernels) twice on one input: bitwise equal, and within the CPU tests'
    tolerance (rtol = atol = 1e-5, tests/test_torch_aggregators.py) of the
    same call on the CPU."""
    import numpy as np
    import torch

    from repro_torch.core import aggregators as A

    rng = np.random.default_rng(4)
    cases = [rng.standard_normal((20, 6, 7)).astype(np.float32),
             rng.standard_normal((257, 4096)).astype(np.float32)]
    for x_np in cases:
        for name in ("approx_median", "approx_trimmed_mean"):
            agg = A.get_aggregator(name, 0.2)
            x = torch.from_numpy(x_np)
            first, second = agg(x.to(dev)), agg(x.to(dev))
            torch.cuda.synchronize()
            bad, _ = compare(first, second)
            check(bad == 0, f"{name} {x_np.shape}: two card calls differ in {bad} places")
            on_cpu, first = agg(x), first.cpu()
            diff = float((first - on_cpu).abs().max())
            check(torch.allclose(first, on_cpu, rtol=1e-5, atol=1e-5),
                  f"{name} {x_np.shape}: card vs CPU beyond rtol=atol=1e-5 (max |diff| {diff})")
            print(f"phase 2c: {name} {tuple(x_np.shape)}: two card calls bitwise equal; "
                  f"card vs CPU max |diff| {diff:.3g}")


def sketch_bound(name: str, rows: int, n: int, nbins: int, elem: int, sums: bool):
    """(ms, "bytes"|"operations"): the inputs read once and the outputs
    written once over the memory rate, against ~2 (min/max) or ~6 + k
    (histogram: sub, div, floor, clip, convert, k adds) f32 operations per
    element over the f32 rate."""
    k = 2 if sums else 1
    if name == "minmax":
        nbytes, ops = rows * n * elem + 2 * n * 4, 2 * rows * n
    else:
        nbytes, ops = rows * n * elem + 2 * n * 4 + k * nbins * n * 4, (6 + k) * rows * n
    mem_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


SKETCH_SHAPES = (("fed chunk", 512, 32, 512), ("cli default", 256, 64, 256),
                 ("bandwidth", 256, 1 << 20, 128))


def sketch_time_rows(label: str, x, nbins: int, card: str, kinds=None):
    """Timing rows of min/max and the histogram (with and without sums) on
    the chunk ``x``: kernel (CUDA events, and torch.aminmax in turns for
    min/max), profiler device time, plain version, bound."""
    import torch

    from repro_torch.kernels import histogram_agg as H

    rows, n = x.shape
    lo, hi = H.minmax(x)
    lo, width = H.edges(lo, hi, nbins)
    big = n >= 1 << 20
    fns = {
        ("minmax", False): (lambda: H.minmax(x), lambda: H.minmax_plain(x),
                            lambda: torch.aminmax(x.float(), dim=0), "minmax_kernel"),
        ("histogram", True): (lambda: H.histogram(x, lo, width, nbins, True),
                              lambda: H.histogram_plain(x, lo, width, nbins, True),
                              None, "histogram_kernel"),
        ("histogram", False): (lambda: H.histogram(x, lo, width, nbins, False),
                               lambda: H.histogram_plain(x, lo, width, nbins, False),
                               None, "histogram_kernel"),
    }
    out = []
    for (name, sums), (kernel, plain, lib, kname) in fns.items():
        if kinds is not None and (name, sums) not in kinds:
            continue
        b_ms, b_by = sketch_bound(name, rows, n, nbins, x.element_size(), sums)
        reps = 20 if big else 200
        ms, lib_ms = time_pair(kernel, lib, reps) if lib else (time_ms(kernel, reps), None)
        row = {"shape": label, "kernel": name, "rows": rows, "n": n, "nbins": nbins,
               "with_sums": sums, "dtype": str(x.dtype).removeprefix("torch."),
               "ms": ms, "device_ms": device_ms(kernel, 20, kname),
               "plain_ms": time_ms(plain, 2 if big else 10),
               "library_ms": lib_ms,
               "library_device_ms": device_ms(lib, 20) if lib else None,
               "bound_ms": b_ms, "bound_by": b_by, "card": card}
        out.append(row)
        print(json.dumps({"timing": row}))
    return out


def sketch_timings(dev, card: str):
    """Phase 5b: min/max and histogram kernel / plain / library times."""
    import torch

    rows_out = []
    cases = [(label, r, n, nb, torch.float32) for label, r, n, nb in SKETCH_SHAPES]
    cases.append(("bandwidth", 256, 1 << 20, 128, torch.bfloat16))
    for label, rows, n, nbins, dtype in cases:
        x = (3 * torch.randn(rows, n, device=dev)).to(dtype)
        rows_out += sketch_time_rows(label, x, nbins, card)
        del x
        torch.cuda.empty_cache()
    for r in rows_out:
        if r["kernel"] == "minmax":
            print(f"phase 5b: minmax {r['shape']} {r['rows']} x {r['n']} {r['dtype']}: "
                  f"per call kernel {r['ms']:.5f} ms vs torch.aminmax {r['library_ms']:.5f} ms "
                  f"({r['library_ms'] / r['ms']:.2f}x); device {ms_text(r['device_ms'])} vs "
                  f"{ms_text(r['library_device_ms'])} ms; bound {r['bound_ms']:.5f} ms")
    return rows_out


# --------------------------------------------------------- the federated path

FED_POP = dict(num_clients=200_000, samples_per_client=16, dim=32, alpha=0.1, seed=0)
FED_ROUNDS = dict(cohort_size=100_000, chunk_clients=512, beta=0.15, nbins=512, lr=0.3,
                  optimizer="sgd", seed=0)
# phase 12's async rounds (30 before 24b ran mamba2's decode rank; on the
# CPU the iterate's ||w - w*|| after 10 rounds is 0.3348 / 0.1015, after 30
# 0.3701 / 0.0066: converged by round 7)
FED_NUM_ROUNDS = 10
FED_PATH_ROUNDS = 5  # phase 6's (30 before phase 23, 20 before phase 24, 10 before the
# script was cut to run well inside its time limit)
FED_METHODS = ("approx_median", "approx_trimmed_mean", "stream_mean")


def fed_attack():
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.fed.rounds import AttackMixture

    return AttackMixture((AttackConfig("sign_flip", alpha=0.1, scale=100.0),))


def fed_path(dev):
    """Phase 6: fed.rounds.run_rounds at fed_scale's configuration; returns
    the launch counts summed over the three methods' runs."""
    import math

    import torch

    from repro_torch.fed.population import ClientPopulation, PopulationConfig
    from repro_torch.fed.rounds import RoundConfig, run_rounds
    from repro_torch.kernels import histogram_agg as H

    pop = ClientPopulation(PopulationConfig(**FED_POP), device=dev)
    chunks = math.ceil(FED_ROUNDS["cohort_size"] / FED_ROUNDS["chunk_clients"])
    total = {"minmax": 0, "histogram": 0}
    errs = {}
    for method in FED_METHODS:
        rcfg = RoundConfig(num_rounds=FED_PATH_ROUNDS, method=method, **FED_ROUNDS)
        torch.cuda.synchronize()
        H.reset_launches()  # zeroed just before this method's run
        t0 = time.perf_counter()
        w, hist = run_rounds(pop, rcfg, fed_attack())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(H.LAUNCHES)  # read just after it
        errs[method] = hist[-1]["err"]
        print(json.dumps({"fed_run": method, "rounds": FED_PATH_ROUNDS,
                          "rounds_per_s": FED_PATH_ROUNDS / dt, "seconds": dt,
                          "err_first": hist[0]["err"], "err_final": errs[method],
                          "launches": launches}))
        check(all(math.isfinite(h["err"]) for h in hist) or method == "stream_mean",
              f"fed {method}: non-finite err")
        want = 0 if method == "stream_mean" else chunks * FED_PATH_ROUNDS
        for k in total:
            check(launches[k] == want, f"fed {method}: {launches[k]} {k} launches, want {want} "
                                       f"({chunks} per round)")
            total[k] += launches[k]
    print(f"phase 6: ||w - w*|| after {FED_PATH_ROUNDS} rounds: "
          + ", ".join(f"{m} {errs[m]:.4f}" for m in FED_METHODS))
    for m in ("approx_median", "approx_trimmed_mean"):
        check(errs[m] < 0.5, f"fed {m} is BROKEN: ||w - w*|| = {errs[m]}")
    check(not errs["stream_mean"] <= 10 * errs["approx_median"],
          f"fed stream_mean is not 10x worse than the median: {errs}")
    return pop, total


def fed_sketch_vs_exact(pop):
    """Phase 6: the sketch median of one attacked 10^4-client cohort vs the
    exact median of the same rows on the card (torch.median gives the
    lower middle value of the even cohort, kthvalue the upper; their
    midpoint is np.median's convention, as fed_scale.py uses)."""
    import torch

    from repro_torch.fed.rounds import (RoundConfig, _chunk_bounds, _make_chunk_fn,
                                        aggregate_cohort)

    m = 10_000
    rcfg = RoundConfig(**dict(FED_ROUNDS, cohort_size=m), method="approx_median")
    atk = fed_attack().for_round(0)
    w = torch.zeros(pop.cfg.dim, device=pop.device)
    ids = pop.sample_cohort(FED_ROUNDS["seed"] + 1, 0, m)
    got = aggregate_cohort(pop, w, ids, rcfg, atk)
    bounds = _chunk_bounds(m, rcfg.chunk_clients)
    fn = _make_chunk_fn(pop, w, ids, bounds, atk)
    full = torch.cat([fn(j) for j in range(len(bounds))])
    lower = torch.median(full, dim=0).values
    upper = torch.kthvalue(full, m // 2 + 1, dim=0).values
    exact = (lower + upper) * 0.5
    width = (full.amax(0) - full.amin(0)) / rcfg.nbins
    dev_ = (got - exact).abs()
    ok = bool((dev_ <= width * 1.0001 + 1e-6).all())
    print(f"phase 6: 10^4 cohort: sketch median vs exact: max dev {float(dev_.max()):.4g}, "
          f"max bin width {float(width.max()):.4g}, within one bin: {ok}")
    check(ok, "the sketch median is more than one bin width from the exact median")


def fed_cpu_agreement(dev):
    """Phase 6: the first 2 rounds on the card vs the same run on the CPU at
    a cohort of 4,096.  The data draws are the same integers on both; float
    sums and products differ by a few ulps, and a row near a bin edge may
    change bins.  So the round-0 aggregate is held to one bin width per
    coordinate and each round's ||w - w*|| to 1e-4 (the CPU tests' bound
    against the reference)."""
    import torch

    from repro_torch.fed.population import ClientPopulation, PopulationConfig
    from repro_torch.fed.rounds import (RoundConfig, _chunk_bounds, _make_chunk_fn,
                                        aggregate_cohort, run_rounds)

    cohort = 4096
    pops = {d: ClientPopulation(PopulationConfig(**FED_POP), device=d) for d in (dev, "cpu")}
    ids = pops["cpu"].sample_cohort(0, 0, cohort)
    x_card = pops[dev].client_batch(ids.to(dev))[0].cpu()
    x_cpu = pops["cpu"].client_batch(ids)[0]
    print(f"phase 6: client data card vs CPU: max |diff| "
          f"{float((x_card - x_cpu).abs().max()):.3g}")
    atk = fed_attack().for_round(0)
    w0 = torch.zeros(FED_POP["dim"])
    fn = _make_chunk_fn(pops["cpu"], w0, ids, _chunk_bounds(cohort, 512), atk)
    full = torch.cat([fn(j) for j in range(cohort // 512)])
    width = (full.amax(0) - full.amin(0)) / FED_ROUNDS["nbins"]
    for method in ("approx_median", "approx_trimmed_mean"):
        rcfg = RoundConfig(num_rounds=2, method=method, **dict(FED_ROUNDS, cohort_size=cohort))
        g = {d: aggregate_cohort(p, w0.to(p.device), ids.to(p.device), rcfg, atk).cpu()
             for d, p in pops.items()}
        hists = {d: run_rounds(p, rcfg, fed_attack())[1] for d, p in pops.items()}
        diff = (g[dev] - g["cpu"]).abs()
        rows = [(a["err"], b["err"]) for a, b in zip(hists[dev], hists["cpu"])]
        print(f"phase 6: {method}: round-0 aggregate card vs CPU max |diff| "
              f"{float(diff.max()):.3g}; ||w - w*|| card/CPU per round {rows}")
        check(all(abs(a - b) <= 1e-4 for a, b in rows),
              f"fed {method}: card and CPU trajectories differ: {rows}")
        check(bool((diff <= width * 1.0001 + 1e-6).all()),
              f"fed {method}: round-0 aggregates differ by more than one bin width")


def fed_cli():
    """Phase 6: python -m repro_torch.fed.run twice on the card: exit 0 and
    one sha256.  Returns the lines to print."""
    import os

    args = [sys.executable, "-m", "repro_torch.fed.run", "--clients", "20000", "--cohort",
            "4096", "--chunk", "512", "--rounds", "3", "--dim", "32", "--samples-per-client",
            "16", "--alpha", "0.1", "--nbins", "512", "--beta", "0.15", "--lr", "0.3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    digests = []
    for _ in range(2):
        out = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300,
                             cwd=ROOT)
        check(out.returncode == 0, f"fed CLI exited {out.returncode}: {out.stderr[-2000:]}")
        line = [ln for ln in out.stdout.splitlines() if "final iterate sha256" in ln]
        check(len(line) == 1, f"fed CLI printed no sha256 line: {out.stdout[-2000:]}")
        check("device=cuda" in out.stdout, "fed CLI did not run on the card")
        digests.append(line[0].split("=")[-1].strip())
    check(digests[0] == digests[1], "the fed CLI is not deterministic on the card")
    return [f"phase 6: CLI twice on the card: sha256 {digests[0]} / {digests[1]}"]


def fed_profile(pop):
    """Phase 6: a torch.profiler trace of one approx_median round at the
    full cohort (profile_summary), with the sketch kernels' device ms."""
    import torch

    from repro_torch.fed.rounds import RoundConfig, run_rounds

    rcfg = RoundConfig(num_rounds=1, method="approx_median", **FED_ROUNDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_rounds(pop, rcfg, fed_attack())  # unprofiled
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_summary(lambda: run_rounds(pop, rcfg, fed_attack()), wall_ms, top=15,
                           names=("minmax_kernel", "histogram_kernel"))
    print(json.dumps({"profile_fed_round": "approx_median", **prof}))


#: the most kernel launches whose trace profile_summary builds the event tree
#: of (the tree takes ~0.6 ms a launch to build, the raw events ~0.03 ms)
TREE_LAUNCHES = 2_000


def profile_summary(fn, wall_ms: float, top: int = 8, names=()) -> dict:
    """One torch.profiler trace of ``fn()``: the device's busy ms, as a
    share of ``wall_ms`` (the same work timed unprofiled), the traced wall
    ms, the kernel launches, the top kernels, and the device ms of the
    kernels whose name holds each of ``names``.  A trace of at most
    TREE_LAUNCHES launches also ranks the ops by the device time of the
    kernels they launched (``top_ops``), from the profiler's event tree; a
    larger one (a full-width step or round, whose tree takes seconds to
    build) sums its raw events instead and ranks the ops by their
    inclusive host ms (``top_host_ops``).  ``summary_s``:
    the host seconds the summary took after the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    profiled_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    if sum(e.device_type() == DeviceType.CUDA for e in raw) > TREE_LAUNCHES:
        return dict(_raw_profile(raw, wall_ms, profiled_ms, top, names),
                    summary_s=time.perf_counter() - t1)
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_device_time_total, reverse=True)[:top]
    out = {"wall_ms": wall_ms, "wall_ms_profiled": profiled_ms, "device_busy_ms": busy,
           "device_busy_share": busy / wall_ms if wall_ms else None,
           "launches": sum(e.count for e in kernels),
           "top_kernels": [{"kernel": e.key[:70], "device_ms": e.self_device_time_total / 1e3,
                            "calls": e.count} for e in kernels[:top]],
           "top_ops": [{"op": e.key[:60], "device_ms": e.self_device_time_total / 1e3,
                        "calls": e.count} for e in ops]}
    if names:
        out["device_ms_by_name"] = {
            name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3
            for name in names}
    out["summary_s"] = time.perf_counter() - t1
    return out


def _raw_profile(events, wall_ms, profiled_ms, top, names) -> dict:
    """profile_summary's numbers from the trace's raw events: device time
    and launches by kernel name, and the host ops' inclusive ms by name."""
    from torch.autograd import DeviceType

    kernels, host = {}, {}
    for e in events:
        table = kernels if e.device_type() == DeviceType.CUDA else host
        ms, calls = table.get(e.name(), (0.0, 0))
        table[e.name()] = (ms + e.duration_ns() / 1e6, calls + 1)
    busy = sum(ms for ms, _ in kernels.values())

    def ranked(table):
        return sorted(table.items(), key=lambda kv: kv[1][0], reverse=True)[:top]

    out = {"wall_ms": wall_ms, "wall_ms_profiled": profiled_ms, "device_busy_ms": busy,
           "device_busy_share": busy / wall_ms if wall_ms else None,
           "launches": sum(calls for _, calls in kernels.values()),
           "top_kernels": [{"kernel": k[:70], "device_ms": ms, "calls": c}
                           for k, (ms, c) in ranked(kernels)],
           "top_host_ops": [{"op": k[:60], "host_ms": ms, "calls": c}
                            for k, (ms, c) in ranked(host) if k.startswith("aten::")]}
    if names:
        out["device_ms_by_name"] = {
            name: sum(ms for k, (ms, _) in kernels.items() if name in k) for name in names}
    return out


# -------------------------------------- C1: float16, float64, empty leaves

HALF_SPECIALS = (0.0, -0.0, float("inf"), float("-inf"), 65504.0, -65504.0, 3e-5, -3e-5,
                 2.0 ** -24, -(2.0 ** -24), 2.0 ** -14, -4e-6, 1e-7)


def half_special_rows(m: int, n: int, seed: int):
    """N(0,1) rows with one value in four drawn from ±0, ±inf, ±65504 (f16's
    largest), f16 subnormals and its smallest normal; a NaN in one column, a
    column of mixed ±0 and one of subnormals only."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pool = np.array(HALF_SPECIALS, dtype=np.float32)
    x = rng.standard_normal((m, n)).astype(np.float32)
    pick = rng.random((m, n)) < 0.25
    x[pick] = pool[rng.integers(0, len(pool), int(pick.sum()))]
    if n >= 4:
        x[m // 2, 0] = np.nan
        x[:, 1] = np.where(rng.random(m) < 0.5, -0.0, 0.0)
        x[:, 2] = rng.choice(pool[6:], m)
    return x


def compare64(got, want):
    """Bit mismatches of two float64 tensors (NaN matches NaN, -0 != +0)."""
    import torch

    gn, wn = torch.isnan(got), torch.isnan(want)
    ok = torch.where(gn | wn, gn & wn, got.view(torch.int64) == want.view(torch.int64))
    return int((~ok).sum())


def c1_on_card(dev, worst):
    """Phase 7: C1 on the card.  f16 B1/B2/B3 bitwise against their plain
    versions (m in HALF_M, n in {1, 97, 4096, 4097, 50176}, special rows;
    misaligned leaves; the CNN's 8 leaves in one call of each kernel); f64
    and zero-width leaves through coordinate_median / coordinate_trimmed_mean
    on the card take their stated routes (the network; no launch), the f64
    result bitwise the plain network's."""
    import torch

    from repro_torch.core import aggregators as A
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import ops, robust_agg
    from repro_torch.kernels import selection_network as SN

    half = torch.float16
    checked, paths = 0, set()

    def check_pairs(pairs, label):
        nonlocal checked
        torch.cuda.synchronize()
        for name, got, want in pairs:
            bad, err = compare(got, want)
            check(bad == 0, f"f16 {name} {label}: {bad} mismatches vs the plain version "
                            f"(max |err| {err})")
            worst[name] = max(worst[name], err)
            checked += 1

    for m in HALF_M:
        trim = sweep_trim(m)
        for n in (1, 97, 4096, 4097, 50176):
            x = torch.from_numpy(half_special_rows(m, n, seed=m * 131 + n)).to(dev, half)
            check(ops.auto_backend(x) == "cuda", f"f16 m={m} n={n} is not routed to the kernels")
            paths.add(robust_agg.plan_for(x).scalar)
            med, tm = robust_agg.fused_median_trimmed(x, trim)
            want_med, want_tm = SN.median_and_trimmed_select(x, trim)
            check_pairs([("median", robust_agg.median(x), SN.median_select(x)),
                         ("trimmed_mean", robust_agg.trimmed_mean(x, trim),
                          SN.trimmed_mean_select(x, trim)),
                         ("fused_median_trimmed", med, want_med),
                         ("fused_median_trimmed", tm, want_tm)], f"m={m} n={n}")
    base = torch.from_numpy(half_special_rows(10, 50176, seed=7)).to(dev, half)
    sliced = base[:, 1:].contiguous()
    off = torch.empty(10 * 50176 + 1, device=dev, dtype=half)[1:].view(10, 50176)
    off.copy_(base)
    leaves = [torch.from_numpy(half_special_rows(10, n, seed=n)).to(dev, half)
              for n in CNN_LEAF_SIZES]
    for xs, label in (([sliced, off, base], "misaligned"), (leaves, "CNN leaves")):
        paths.update(robust_agg.plan_for(x).scalar for x in xs)
        before = dict(robust_agg.LAUNCHES)
        meds = robust_agg.median_many(xs)
        tms = robust_agg.trimmed_mean_many(xs, 1)
        fmeds, ftms = robust_agg.fused_median_trimmed_many(xs, 1)
        ran = {k: robust_agg.LAUNCHES[k] - before[k] for k in before}
        check(all(v == 1 for v in ran.values()), f"f16 {label}: launches {ran}, want 1 each")
        pairs = []
        for x, a, b, c, d in zip(xs, meds, tms, fmeds, ftms):
            want_med, want_tm = SN.median_and_trimmed_select(x, 1)
            pairs += [("median", a, want_med), ("trimmed_mean", b, want_tm),
                      ("fused_median_trimmed", c, want_med), ("fused_median_trimmed", d, want_tm)]
        check_pairs(pairs, label)
    check(paths == {False, True}, f"f16: the sweep missed a load path: scalar in {paths}")

    # float64 and empty leaves: the network and no launch, decided up front
    x64 = torch.from_numpy(special_rows(10, 4097, seed=64)).to(dev, torch.float64)
    x64[3, 5] = 1e300
    before_sel, before_sk = dict(robust_agg.LAUNCHES), dict(H.LAUNCHES)
    check(ops.auto_backend(x64) == "network", "f64 is not routed to the network")
    got_med, got_tm = A.coordinate_median(x64), A.coordinate_trimmed_mean(x64, 0.1)
    bad = compare64(got_med, SN.median_select(x64)) + compare64(
        got_tm, SN.trimmed_mean_select(x64, 1))
    check(bad == 0 and got_med.dtype == torch.float64,
          f"f64 on the card: {bad} mismatches vs the plain network")
    empties = {}
    for shape in ((10, 0), (10, 3, 0), (70, 0)):
        for dtype in (torch.float32, half, torch.float64):
            e = torch.zeros(shape, device=dev, dtype=dtype)
            check(ops.auto_backend(e) == "empty", f"{shape} {dtype} is not routed as empty")
            for name, out in (("median", A.coordinate_median(e)),
                              ("trimmed_mean", A.coordinate_trimmed_mean(e, 0.1))):
                check(out.shape == shape[1:] and out.dtype == dtype and out.device == e.device,
                      f"empty {name} {shape} {dtype}: got {tuple(out.shape)} {out.dtype}")
                empties[f"{name}{shape}"] = list(out.shape)
    tree = A.tree_aggregate({"e": torch.zeros(10, 0, device=dev),
                             "d": x64[:, :33].contiguous()}, "median")
    check(tree["e"].shape == (0,) and compare64(tree["d"], SN.median_select(x64[:, :33])) == 0,
          "a tree of an empty and an f64 leaf did not aggregate right")
    torch.cuda.synchronize()
    ran = {k: robust_agg.LAUNCHES[k] - before_sel[k] for k in before_sel}
    ran.update({k: H.LAUNCHES[k] - before_sk[k] for k in before_sk})
    check(not any(ran.values()), f"f64 / empty leaves launched kernels: {ran}")
    print(f"phase 7: f16: {checked} kernel outputs bitwise equal to the plain version "
          f"(m in {list(HALF_M)}, both load paths, misaligned and 8-leaf calls); f64 bitwise "
          f"the plain network with 0 launches; empty leaves "
          f"{sorted(set(map(str, empties.values())))} with 0 launches")


# ------------------------------------------------ Algorithm 2 (one round)

T4_M, T4_N = 10, 500  # benchmarks/table4_one_round.py


def table4_one_round(dev):
    """Phase 8: benchmarks/table4_one_round.py on the port at full width
    (multiclass logistic regression, d=784, 10 classes; m=10, n=500; the
    local solver 150 GD steps at lr 0.5), its five rows and its claim.
    Returns the launches of the median kernel on this path."""
    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig, make_classification_shards
    from repro_torch.data.synthetic import mnist_analog
    from repro_torch.kernels import robust_agg
    from repro_torch.models.paper_models import init_logreg, logreg_accuracy, logreg_loss
    from repro_torch.rounds import OneRoundConfig, make_gd_local_solver, one_round

    cfg = DataConfig(global_batch=T4_M * T4_N, num_workers=T4_M, seed=0)
    clean = make_classification_shards(cfg, None, device=dev)
    attacked = make_classification_shards(cfg, AttackConfig("random_label", alpha=0.1),
                                          device=dev)
    test = mnist_analog(torch.Generator().manual_seed(1234), 2000, device=dev)
    w0 = init_logreg(device=dev)
    check(tuple(w0["w"].shape) == (784, 10) and tuple(w0["b"].shape) == (10,),
          "the logistic model is not d=784 x 10 classes")
    solver = make_gd_local_solver(logreg_loss, w0, steps=150, lr=0.5)
    atk_w = AttackConfig("sign_flip", alpha=0.1, scale=15.0)
    rows = [("mean_clean", clean, "mean", None), ("mean_attacked", attacked, "mean", None),
            ("median_attacked", attacked, "median", None),
            ("mean_weights_attacked", clean, "mean", atk_w),
            ("median_weights_attacked", clean, "median", atk_w)]
    torch.cuda.synchronize()
    robust_agg.reset_launches()  # zeroed just before the one-round runs
    acc, secs = {}, {}
    t_all = time.perf_counter()
    for name, shards, method, watk in rows:
        t0 = time.perf_counter()
        w = one_round(solver, shards, OneRoundConfig(method), attack=watk)
        acc[name] = float(logreg_accuracy(w, test))
        secs[name] = time.perf_counter() - t0
        check(all(bool(torch.isfinite(v).all()) for v in w.values()), f"table4 {name}: not finite")
    total = time.perf_counter() - t_all
    launches = dict(robust_agg.LAUNCHES)  # read just after
    leaves = dict(robust_agg.LEAVES)
    ok = (acc["mean_clean"] - acc["mean_attacked"] > 0.01
          and acc["median_weights_attacked"] - acc["mean_weights_attacked"] > 0.2
          and acc["median_attacked"] > acc["mean_attacked"] - 0.03)
    for name in acc:
        print(f"phase 8: table4/{name}_acc {acc[name] * 100:.1f}% ({secs[name]:.2f} s)")
    print(json.dumps({"table4_one_round": acc, "claim_holds": ok, "seconds": total,
                      "seconds_per_row": secs, "launches": launches, "leaves": leaves}))
    prof = profile_summary(lambda: one_round(solver, attacked, OneRoundConfig("median")),
                           secs["median_attacked"] * 1e3)
    print(json.dumps({"profile_table4_row": "median_attacked", **prof}))
    check(ok, f"table4: claim_holds is False: {acc}")
    check(launches["median"] == 2 and leaves["median"] == 4,
          f"table4: median kernel {launches['median']} launches for {leaves['median']} "
          f"leaves, want 2 for 4 (one a median row, both leaves)")
    return {"median": launches["median"]}


OR_M, OR_N, OR_D, OR_SIGMA, OR_CHUNK, OR_NBINS = 100_000, 64, 32, 0.5, 512, 512


def one_round_at_scale(dev):
    """Phase 9: one_round_streaming with the quadratic solver at federated
    scale (m = 10^5 workers, n = 64, d = 32, sigma 0.5, chunks of 512, 512
    bins, sign_flip alpha 0.1 scale 100), approx_median and
    approx_trimmed_mean (beta 0.15): within one bin width of the exact
    one_round on the same 10^5 attacked solutions (the sort path), and the
    median's ||w - w*|| more than 10x below the exact mean's.  Returns the
    sketch kernels' launches on this path."""
    import math

    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.rounds import OneRoundConfig, one_round, one_round_streaming
    from repro_torch.rounds.one_round import quadratic_local_solver, solution_chunks

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(OR_M, OR_N, OR_D, generator=gen, device=dev)
    w_star = torch.randn(OR_D, generator=gen, device=dev) / OR_D ** 0.5
    y = x @ w_star + OR_SIGMA * torch.randn(OR_M, OR_N, generator=gen, device=dev)
    data = (x, y)
    atk = AttackConfig("sign_flip", alpha=0.1, scale=100.0)
    chunks = math.ceil(OR_M / OR_CHUNK)
    print(f"phase 9: data {(x.numel() + y.numel()) * 4 / 1e6:.0f} MB on the card, "
          f"{chunks} chunks of {OR_CHUNK}")
    chunk_fn, num_chunks, _, _ = solution_chunks(
        quadratic_local_solver, data, atk, chunk_workers=OR_CHUNK)
    rows = torch.cat([chunk_fn(j) for j in range(num_chunks)])  # the attacked solutions
    width = (rows.amax(0) - rows.amin(0)) / OR_NBINS
    total = {"minmax": 0, "histogram": 0}
    errs, out = {}, {}
    for method, exact_method in (("approx_median", "median"),
                                 ("approx_trimmed_mean", "trimmed_mean")):
        cfg = OneRoundConfig(method, beta=0.15)
        torch.cuda.synchronize()
        H.reset_launches()  # zeroed just before this method's run
        t0 = time.perf_counter()
        w = one_round_streaming(quadratic_local_solver, data, cfg, attack=atk,
                                chunk_workers=OR_CHUNK, nbins=OR_NBINS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(H.LAUNCHES)  # read just after
        exact = one_round(lambda r: r, rows, OneRoundConfig(exact_method, beta=0.15))
        dev_ = (w - exact).abs()
        within = bool((dev_ <= width * 1.0001 + 1e-6).all())
        errs[method] = float(torch.linalg.vector_norm(w - w_star))
        out[method] = {"seconds": dt, "err": errs[method], "launches": launches,
                       "max_dev_from_exact": float(dev_.max()),
                       "max_bin_width": float(width.max()), "within_one_bin": within}
        check(within, f"one round {method}: more than one bin width from the exact one_round")
        for k in total:
            check(launches[k] == chunks, f"one round {method}: {launches[k]} {k} launches, "
                                         f"want {chunks} (one a chunk a pass)")
            total[k] += launches[k]
    prof = profile_summary(lambda: one_round_streaming(
        quadratic_local_solver, data, OneRoundConfig("approx_median"), attack=atk,
        chunk_workers=OR_CHUNK, nbins=OR_NBINS), out["approx_median"]["seconds"] * 1e3)
    print(json.dumps({"profile_one_round_streaming": "approx_median", **prof}))
    t0 = time.perf_counter()
    w_mean = one_round(quadratic_local_solver, data, OneRoundConfig("mean"), attack=atk)
    torch.cuda.synchronize()
    out["mean (exact, vmap over 10^5)"] = {"seconds": time.perf_counter() - t0,
                                            "err": float(torch.linalg.vector_norm(w_mean - w_star))}
    err_mean = out["mean (exact, vmap over 10^5)"]["err"]
    print(json.dumps({"one_round_streaming": out}))
    print(f"phase 9: ||w - w*||: approx_median {errs['approx_median']:.4g}, approx_trimmed_mean "
          f"{errs['approx_trimmed_mean']:.4g}, mean {err_mean:.4g}")
    check(err_mean > 10 * errs["approx_median"],
          f"one round: the median does not beat the mean by 10x ({errs}, mean {err_mean})")
    return total


# ------------------------------------------------------- local-update rounds


def local_update_cnn(dev, card: str):
    """Phase 10: local-update rounds on the Table 3 CNN (phase 4's setup:
    m=10, sign_flip alpha 0.1 scale 20), median and trimmed mean.  tau = 1:
    the weights after 5 rounds bitwise robust_gd's after 5 iterations on the
    card, both run with cuDNN's deterministic algorithms (its default
    convolution backward may sum in a run-dependent order, so two robust_gd
    runs can differ in the last bits; the line says whether they did here).
    With the default algorithms too, tau = 1 must equal robust_gd bitwise
    whenever two robust_gd runs do.
    tau = 5: 10 rounds, the loss falls, one launch a round over all 8
    leaves.  Then the steady-state round time at tau = 5 and a profile of one
    round.  Returns the launches on this path."""
    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.robust_gd import robust_gd
    from repro_torch.kernels import robust_agg
    from repro_torch.models.paper_models import cnn_loss
    from repro_torch.rounds import engine
    from repro_torch.rounds.local_update import (LocalUpdateConfig, local_update_gd,
                                                 make_local_update_stages)

    shards, params = cnn_setup(dev)
    pooled = {"x": shards["x"].reshape(-1, 784), "y": shards["y"].reshape(-1)}
    attack = AttackConfig(**CNN_ATTACK)
    loss0 = float(cnn_loss(params, pooled))
    total = {"median": 0, "trimmed_mean": 0}
    lu = lambda method, tau, rounds: LocalUpdateConfig(  # noqa: E731
        method=method, beta=0.1, step_size=0.05, tau=tau, num_rounds=rounds)
    for method in ("median", "trimmed_mean"):
        w_a, _ = robust_gd(cnn_loss, params, shards, cnn_config(method, 5), attack)
        w_b, _ = robust_gd(cnn_loss, params, shards, cnn_config(method, 5), attack)
        repeat = all(torch.equal(w_a[k], w_b[k]) for k in params)
        w_lu0, _ = local_update_gd(cnn_loss, params, shards, lu(method, 1, 5), attack)
        same_default = all(torch.equal(w_a[k], w_lu0[k]) for k in params)
        torch.backends.cudnn.deterministic = True
        try:
            w_gd, _ = robust_gd(cnn_loss, params, shards, cnn_config(method, 5), attack)
            torch.cuda.synchronize()
            robust_agg.reset_launches()  # zeroed just before the tau = 1 run
            w_lu, _ = local_update_gd(cnn_loss, params, shards, lu(method, 1, 5), attack)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        ran1, leaves1 = robust_agg.LAUNCHES[method], robust_agg.LEAVES[method]
        same = all(torch.equal(w_gd[k], w_lu[k]) for k in params)
        print(f"phase 10: {method:13s} tau=1, 5 rounds: bitwise robust_gd's 5 iterations "
              f"(deterministic cuDNN): {same} ({ran1} launches, {leaves1} leaves); with "
              f"cuDNN's default algorithms: two robust_gd runs bitwise equal: {repeat}, "
              f"tau=1 bitwise the first: {same_default}")
        check(same, f"local update {method}: tau=1 is not bitwise robust_gd on the card")
        check(same_default or not repeat,
              f"local update {method}: with cuDNN's default algorithms two robust_gd runs "
              f"agree bitwise but tau=1 differs from them")
        check(ran1 == 5 and leaves1 == 5 * CNN_LEAVES, f"local update {method} tau=1: "
              f"{ran1} launches for {leaves1} leaves, want 5 for {5 * CNN_LEAVES}")
        robust_agg.reset_launches()  # zeroed just before the tau = 5 run
        t0 = time.perf_counter()
        w5, losses = local_update_gd(cnn_loss, params, shards, lu(method, 5, 10), attack,
                                     trajectory_fn=lambda w: cnn_loss(w, pooled))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ran5, leaves5 = robust_agg.LAUNCHES[method], robust_agg.LEAVES[method]
        losses = [float(v) for v in losses]
        print(f"phase 10: {method:13s} tau=5, 10 rounds: loss {loss0:.4f} -> {losses[-1]:.4f} "
              f"({dt:.2f} s, {ran5} launches, {leaves5} leaves)")
        check(all(v == v and abs(v) != float("inf") for v in losses),
              f"local update {method}: loss not finite")
        check(losses[-1] < loss0, f"local update {method}: loss did not fall")
        check(ran5 == 10 and leaves5 == 10 * CNN_LEAVES, f"local update {method} tau=5: "
              f"{ran5} launches for {leaves5} leaves, want 10 for {10 * CNN_LEAVES}")
        total[method] = ran1 + ran5
        # steady-state tau = 5 round time and one profiled round
        body = engine.make_round_body(make_local_update_stages(
            cnn_loss, shards, lu(method, 5, 10), attack))
        state = engine.make_state(params)
        state, _ = body(state, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(1, 6):
            state, _ = body(state, r)
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) / 5 * 1e3
        prof = profile_summary(lambda: body(state, 6), round_ms)
        print(json.dumps({"local_update_round_tau5": method, "card": card, **prof}))
    return total


# ------------------------------------------------ compressed federated rounds

# tests/test_compression.py's population (d=8, noise 0.5, 3 clients per
# cohort slot) and round knobs (lr 0.3, beta 0.1, 256 bins), at a 10^4 cohort
# in fed_scale's chunks of 512
COMP_POP = dict(num_clients=30_000, samples_per_client=16, dim=8, alpha=0.1, noise=0.5, seed=0)
COMP_COHORT, COMP_CHUNK, COMP_ROUNDS = 10_000, 512, 5
CONVERGED = 0.9  # a run converges when its last ||w - w*|| < CONVERGED x its first
NO_CONVERGENCE = {("topk", "approx_median")}


def compressed_fed_rounds(dev):
    """Phase 11: each codec (int8, topk, count_sketch) for 5 rounds of
    fed.rounds.run_rounds at a 10^4 cohort under sign_flip alpha 0.1, with
    tests/test_compression.py's population and round knobs (COMP_POP),
    approx_median and approx_trimmed_mean: ||w - w*|| after the last round
    below CONVERGED times the first round's.  topk with the coordinate
    median does not converge, on the card, on the CPU and in the reference
    (NO_CONVERGENCE): a top quarter leaves ~3/4 of each coordinate's
    payloads at 0, so the median sits near 0; that run is reported, held to
    finite values and its launch counts, and not counted as converging.
    Returns the sketch kernels' launches."""
    import math

    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.fed.population import ClientPopulation, PopulationConfig
    from repro_torch.fed.rounds import AttackMixture, RoundConfig, run_rounds
    from repro_torch.kernels import histogram_agg as H

    pop = ClientPopulation(PopulationConfig(**COMP_POP), device=dev)
    mix = AttackMixture((AttackConfig("sign_flip", alpha=0.1),))
    chunks = math.ceil(COMP_COHORT / COMP_CHUNK)
    total = {"minmax": 0, "histogram": 0}
    for comp in ("int8", "topk", "count_sketch"):
        for method in ("approx_median", "approx_trimmed_mean"):
            rcfg = RoundConfig(num_rounds=COMP_ROUNDS, cohort_size=COMP_COHORT,
                               chunk_clients=COMP_CHUNK, method=method, lr=0.3, seed=0,
                               compression=comp)
            torch.cuda.synchronize()
            H.reset_launches()  # zeroed just before this run
            t0 = time.perf_counter()
            _, hist = run_rounds(pop, rcfg, mix)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(H.LAUNCHES)  # read just after
            errs = [h["err"] for h in hist]
            print(json.dumps({"compressed_fed_run": comp, "method": method,
                              "rounds": COMP_ROUNDS, "seconds": dt, "err": errs,
                              "launches": launches}))
            check(all(math.isfinite(e) for e in errs), f"{comp} {method}: err not finite")
            converged = errs[-1] < CONVERGED * errs[0]
            print(f"phase 11: {comp:12s} {method:19s} ||w - w*|| {errs[0]:.4f} -> "
                  f"{errs[-1]:.4f} (x{errs[-1] / errs[0]:.3f}): "
                  f"{'converges' if converged else 'does NOT converge'}")
            if (comp, method) not in NO_CONVERGENCE:
                check(converged, f"{comp} {method}: did not converge (last ||w - w*|| not "
                                 f"below {CONVERGED} x the first): {errs}")
            for k in total:
                check(launches[k] == chunks * COMP_ROUNDS,
                      f"{comp} {method}: {launches[k]} {k} launches, want "
                      f"{chunks * COMP_ROUNDS}")
                total[k] += launches[k]
    print(f"phase 11: under sign_flip int8 and count_sketch converge for both robust "
          f"methods, topk for approx_trimmed_mean only ({chunks} chunks a round)")
    return total


# ------------------------------------------------ buffered async fed rounds

# fed_scale's population and rounds (phase 6) with benchmarks/
# async_throughput.py's knobs: half-cohort buffer, lognormal stragglers,
# damped staleness policy, its timeout 20.0 and beta 0.3, stale_exploit
ASYNC_ROUNDS = dict(FED_ROUNDS, beta=0.3)
ASYNC_K, ASYNC_TIMEOUT, ASYNC_SPEEDUP_FLOOR = 50_000, 20.0, 2.0
ASYNC_METHODS = ("approx_median", "approx_trimmed_mean")
ASYNC_CPU_COHORT, ASYNC_CPU_ROUNDS = 10_000, 2
HOST_FIELDS = ("round", "attack", "duration", "buffer", "pending", "staleness_mean", "timing")


def async_setup(k=None):
    """(AsyncConfig with a buffer of k (default ASYNC_K), ArrivalConfig,
    AttackMixture) of phase 12."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.fed.async_rounds import AsyncConfig
    from repro_torch.fed.population import ArrivalConfig
    from repro_torch.fed.rounds import AttackMixture

    return (AsyncConfig(buffer_k=ASYNC_K if k is None else k, max_staleness=4, policy="damped", timeout=ASYNC_TIMEOUT),
            ArrivalConfig(latency="lognormal", spread=1.0),
            AttackMixture((AttackConfig("stale_exploit", alpha=0.1),)))


def async_sync_pin(pop):
    """Phase 12a: buffer_k = the 10^5 cohort with zero latency under
    sign_flip (scale 100), approx_median, 3 rounds: the fast path every
    round, the iterate bitwise run_rounds's, 196 min/max and 196 histogram
    launches a round."""
    import math

    import torch

    from repro_torch.fed import async_rounds
    from repro_torch.fed.async_rounds import AsyncConfig, run_async_rounds
    from repro_torch.fed.population import ArrivalConfig
    from repro_torch.fed.rounds import RoundConfig, run_rounds
    from repro_torch.kernels import histogram_agg as H

    rounds = 3
    rcfg = RoundConfig(num_rounds=rounds, method="approx_median", **ASYNC_ROUNDS)
    w_sync, h_sync = run_rounds(pop, rcfg, fed_attack())
    calls = []
    real = async_rounds.sync_rounds.aggregate_cohort
    async_rounds.sync_rounds.aggregate_cohort = \
        lambda *a, **kw: calls.append(kw["rnd"]) or real(*a, **kw)
    try:
        torch.cuda.synchronize()
        H.reset_launches()  # zeroed just before the pinned run
        w_async, h_async = run_async_rounds(
            pop, rcfg, AsyncConfig(buffer_k=rcfg.cohort_size), ArrivalConfig(), fed_attack())
        torch.cuda.synchronize()
        launches = dict(H.LAUNCHES)  # read just after
    finally:
        async_rounds.sync_rounds.aggregate_cohort = real
    chunks = math.ceil(rcfg.cohort_size / rcfg.chunk_clients)
    same = torch.equal(w_sync, w_async) and all(
        a["err"] == b["err"] for a, b in zip(h_sync, h_async))
    print(f"phase 12a: buffer_k = cohort {rcfg.cohort_size}, zero latency, {rounds} rounds: "
          f"bitwise run_rounds {same}, fast path in rounds {calls}, launches {launches}")
    check(same, "async sync pin: the iterate is not bitwise run_rounds's on the card")
    check(calls == list(range(rounds)), f"async sync pin: the fast path ran in rounds {calls}")
    for k in launches:
        check(launches[k] == chunks * rounds, f"async sync pin: {launches[k]} {k} launches, "
                                              f"want {chunks * rounds}")


def async_cpu_agreement(dev):
    """Phase 12f: 2 async rounds at a 10^4 cohort on the card and on the CPU
    (buffer half the cohort): the buffer composition is the same bits
    (arrival times are drawn on the CPU), the host fields of the history
    are equal, and the iterates agree within one bin width per coordinate
    (the round-0 cohort's rows at w = 0 set the width; 2 steps of lr 0.3
    move the iterate by less than one bin per changed bin)."""
    import torch

    from repro_torch.fed.async_rounds import run_async_rounds
    from repro_torch.fed.population import ClientPopulation, PopulationConfig
    from repro_torch.fed.rounds import RoundConfig, _chunk_bounds, _make_chunk_fn

    pops = {d: ClientPopulation(PopulationConfig(**FED_POP), device=d) for d in (dev, "cpu")}
    acfg, arr, mix = async_setup(ASYNC_CPU_COHORT // 2)
    w0 = torch.zeros(FED_POP["dim"])
    ids = pops["cpu"].sample_cohort(0, 0, ASYNC_CPU_COHORT)
    fn = _make_chunk_fn(pops["cpu"], w0, ids, _chunk_bounds(ASYNC_CPU_COHORT, 512), None)
    full = torch.cat([fn(j) for j in range(len(_chunk_bounds(ASYNC_CPU_COHORT, 512)))])
    width = (full.amax(0) - full.amin(0)) / ASYNC_ROUNDS["nbins"]
    for method in ASYNC_METHODS:
        rcfg = RoundConfig(num_rounds=ASYNC_CPU_ROUNDS, method=method,
                           **dict(ASYNC_ROUNDS, cohort_size=ASYNC_CPU_COHORT))
        runs = {d: run_async_rounds(p, rcfg, acfg, arr, mix) for d, p in pops.items()}
        host = {d: [{k: h[k] for k in HOST_FIELDS} for h in hist]
                for d, (_, hist) in runs.items()}
        diff = (runs[dev][0].cpu() - runs["cpu"][0]).abs()
        print(f"phase 12f: {method}: host fields card == CPU: {host[dev] == host['cpu']} "
              f"({host['cpu'][-1]}); iterate max |diff| {float(diff.max()):.3g}, "
              f"min bin width {float(width.min()):.3g}")
        check(host[dev] == host["cpu"], f"async {method}: the buffer composition differs "
                                        f"between the card and the CPU")
        check(bool((diff <= width * 1.0001 + 1e-6).all()),
              f"async {method}: card and CPU iterates differ by more than one bin width")


def async_profile(pop):
    """Phase 12g: one async round with stale reports in its buffer (round
    2, resumed from a snapshot written after round 1): its wall time, a
    torch.profiler trace of it (profile_summary), then its host scheduling
    timed alone."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.fed.async_rounds import run_async_rounds
    from repro_torch.fed.rounds import RoundConfig

    acfg, arr, mix = async_setup()
    rcfg = RoundConfig(num_rounds=3, method="approx_median", **ASYNC_ROUNDS)
    ck = ROOT / "build" / "chip_smoke_async_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    run_async_rounds(pop, rcfg, acfg, arr, mix, ckpt_every=2, ckpt_dir=str(ck))
    one = lambda: run_async_rounds(pop, rcfg, acfg, arr, mix, ckpt_dir=str(ck),  # noqa: E731
                                   resume=2)
    one()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, hist = one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_summary(one, wall_ms, top=15, names=("minmax_kernel", "histogram_kernel"))
    print(json.dumps({"profile_async_round": "approx_median", "round": hist[-1]["round"],
                      "buffer": hist[-1]["buffer"], "pending": hist[-1]["pending"], **prof}))
    shutil.rmtree(ck, ignore_errors=True)
    # the round's host scheduling alone: the cohort, its arrival draws on the
    # CPU, and the stable sort of the cohort plus the steady pending queue
    # (~2.9 cohorts in phase 12's runs)
    t0 = time.perf_counter()
    ids = pop.sample_cohort(0, 2, rcfg.cohort_size)
    t1 = time.perf_counter()
    t = pop.arrival_times(0, 2, 0, ids, arr).numpy().astype(np.float64)
    t2 = time.perf_counter()
    cand = np.concatenate([t] * 4)
    np.lexsort((np.arange(len(cand)), np.zeros(len(cand), np.int64), cand))
    t3 = time.perf_counter()
    print(json.dumps({"async_round_host_ms": {
        "sample_cohort": (t1 - t0) * 1e3, "arrival_times": (t2 - t1) * 1e3,
        f"lexsort of {len(cand)} candidates": (t3 - t2) * 1e3}}))


def async_fed_rounds(dev):
    """Phase 12: fed.async_rounds.run_async_rounds at fed_scale's width
    (200,000 clients, cohorts of 10^5 in chunks of 512, d=32, n=16, 512
    bins, lr 0.3, sgd, 30 rounds) with a 5*10^4 buffer, lognormal latency
    (spread 1), the damped policy, timeout 20, beta 0.3 and stale_exploit
    at alpha 0.1, for approx_median and approx_trimmed_mean.  (a) the sync
    pin at full width; (b) each method's last ||w - w*|| < 0.5; (c) every
    buffer 5*10^4, stale rows after round 0, a pending queue; (d) 98
    min/max and 98 histogram launches a round (97 chunks of 512 rows, one of
    336), the counters zeroed just before each method's run and read just
    after; (e) the buffer closes rounds >= ASYNC_SPEEDUP_FLOOR x faster in
    simulated time than k = the cohort over 5 rounds; (f) card vs CPU; (g)
    the wall time a round, the device busy share and a profile.  Returns
    the sketch kernels' launches on the 30-round runs."""
    import math

    import torch

    from repro_torch.fed.async_rounds import run_async_rounds
    from repro_torch.fed.population import ClientPopulation, PopulationConfig
    from repro_torch.fed.rounds import RoundConfig
    from repro_torch.kernels import histogram_agg as H

    pop = ClientPopulation(PopulationConfig(**FED_POP), device=dev)
    async_sync_pin(pop)
    acfg, arr, mix = async_setup()
    chunks = math.ceil(ASYNC_K / ASYNC_ROUNDS["chunk_clients"])
    total = {"minmax": 0, "histogram": 0}
    hists = {}
    for method in ASYNC_METHODS:
        rcfg = RoundConfig(num_rounds=FED_NUM_ROUNDS, method=method, **ASYNC_ROUNDS)
        torch.cuda.synchronize()
        H.reset_launches()  # zeroed just before this method's run
        t0 = time.perf_counter()
        _, hist = run_async_rounds(pop, rcfg, acfg, arr, mix)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(H.LAUNCHES)  # read just after it
        hists[method] = hist
        print(json.dumps({"async_fed_run": method, "rounds": FED_NUM_ROUNDS,
                          "seconds": dt, "ms_per_round": dt / FED_NUM_ROUNDS * 1e3,
                          "err_first": hist[0]["err"], "err_final": hist[-1]["err"],
                          "buffer": sorted({h["buffer"] for h in hist}),
                          "staleness_mean": [round(h["staleness_mean"], 4) for h in hist],
                          "pending_max": max(h["pending"] for h in hist),
                          "sim_time": sum(h["duration"] for h in hist), "launches": launches}))
        check(all(math.isfinite(h["err"]) for h in hist), f"async {method}: err not finite")
        check(hist[-1]["err"] < 0.5, f"async {method} is BROKEN: ||w - w*|| = "
                                     f"{hist[-1]['err']}")
        check(all(h["buffer"] == ASYNC_K for h in hist), f"async {method}: a buffer is not "
                                                          f"{ASYNC_K}")
        check(all(h["staleness_mean"] > 0 for h in hist[1:]) and
              all(h["pending"] > 0 for h in hist), f"async {method}: no stale rows or no "
                                                    f"pending queue")
        for k in total:
            check(launches[k] == chunks * FED_NUM_ROUNDS,
                  f"async {method}: {launches[k]} {k} launches, want "
                  f"{chunks * FED_NUM_ROUNDS} ({chunks} a round)")
            total[k] += launches[k]
    # (e) simulated round time against a buffer of the whole cohort
    acfg_full, _, _ = async_setup(ASYNC_ROUNDS["cohort_size"])
    _, hist_full = run_async_rounds(
        pop, RoundConfig(num_rounds=5, method="approx_median", **ASYNC_ROUNDS),
        acfg_full, arr, mix)
    t_half = sum(h["duration"] for h in hists["approx_median"][:5])
    t_full = sum(h["duration"] for h in hist_full)
    print(f"phase 12e: simulated time of 5 rounds: k={ASYNC_K} {t_half:.4f}, "
          f"k={ASYNC_ROUNDS['cohort_size']} {t_full:.4f}: speedup {t_full / t_half:.2f}x")
    check(t_full >= ASYNC_SPEEDUP_FLOOR * t_half,
          f"async: the half buffer closes rounds only {t_full / t_half:.2f}x faster")
    print(f"phase 12: ||w - w*|| after {FED_NUM_ROUNDS} rounds: " + ", ".join(
        f"{m} {hists[m][-1]['err']:.4f}" for m in ASYNC_METHODS))
    async_cpu_agreement(dev)
    async_profile(pop)
    return total


# ------------------------------------------------------- robustness matrix

# B1 and B2 launches of `python -m repro_torch.attacks.matrix` at the
# default configs (ROBUSTNESS.json's): every program launches once a step
# (60 steps) when its aggregation runs the kernel: the median for 2 <= rows
# <= 64, the trimmed mean when int(0.3 * rows) >= 1.
#   sync:       (median, trimmed) x m in {16, 32}          2 programs each -> 120
#   compressed: (median, trimmed) x 4 codecs at m = 16     4 programs each -> 240
#   async:      one program per buffer size k_actual, {4, 8, 12, 13, 16} at m = 16
#               and {8, 16, 24, 26, 32} at m = 32         10 programs each -> 600
#   feedback:   (median, trimmed, mean) x m in {16, 32}    2 programs each -> 120
# The mean launches nothing.
MATRIX_LAUNCHES = {"median": 1080, "trimmed_mean": 1080}
MATRIX_KEYS = ("attack", "aggregator", "alpha", "m", "strength", "compression", "k",
               "dropout")


def matrix_programs():
    """(kind, rows, trim) of every B1/B2 program the default matrix runs."""
    from repro_torch.attacks import matrix as M

    progs = set()

    def add(agg, rows, beta):
        if agg == "median" and 2 <= rows:
            progs.add(("median", rows, 0))
        if agg == "trimmed_mean" and int(beta * rows) >= 1:
            progs.add(("trimmed_mean", rows, int(beta * rows)))

    for cfg in (M.MatrixConfig(), M.CompressedMatrixConfig(), M.FeedbackMatrixConfig()):
        for m in cfg.ms:
            for agg in cfg.aggregators:
                add(agg, m, cfg.beta)
    acfg = M.AsyncMatrixConfig()
    for m in acfg.ms:
        for agg in acfg.aggregators:
            for rec, (_, _, h_buf) in M.async_cells(acfg, m, agg):
                if h_buf >= 1:
                    add(agg, rec["k_actual"], acfg.beta)
    return progs


def robustness_matrix(dev):
    """Phase 13: python -m repro_torch.attacks.matrix on the card at the
    default configs (its per-cell lines go to build/chip_smoke_matrix.log):
    exit 0 and no violation; the committed ROBUSTNESS.json's 276 / 40 / 64
    / 42 cells with the same keys, bounds within 1e-12 relative and the
    same gated and feasible flags; the worst err / bound of each grid beside
    the committed one (reported: the data comes from other generators);
    B1 and B2 launched MATRIX_LAUNCHES times, the counters zeroed just
    before and read just after; then a profile of its largest program.
    Returns those launches."""
    import contextlib
    import io

    import torch

    from repro_torch.attacks import matrix as M
    from repro_torch.kernels import robust_agg

    out_path = ROOT / "build" / "chip_smoke_matrix.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    log = io.StringIO()
    torch.cuda.synchronize()
    robust_agg.reset_launches()  # zeroed just before the matrix
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        rc = M.main(["--json", str(out_path), "--device", str(dev)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, leaves = dict(robust_agg.LAUNCHES), dict(robust_agg.LEAVES)  # read just after
    (ROOT / "build" / "chip_smoke_matrix.log").write_text(log.getvalue())
    check(rc == 0, f"matrix exited {rc}: {log.getvalue()[-2000:]}")
    got = json.loads(out_path.read_text())
    want = json.loads((ROOT / "ROBUSTNESS.json").read_text())
    worst = {}
    for grid in ("sync", "compressed", "async", "feedback"):
        g, w = (got, want) if grid == "sync" else (got[grid], want[grid])
        check(len(g["cells"]) == len(w["cells"]),
              f"matrix {grid}: {len(g['cells'])} cells, want {len(w['cells'])}")
        check(not g["violations"], f"matrix {grid}: violations {g['violations'][:3]}")
        for a, b in zip(g["cells"], w["cells"]):
            check(tuple(a.get(k) for k in MATRIX_KEYS) == tuple(b.get(k) for k in MATRIX_KEYS),
                  f"matrix {grid}: cell {a} is not the committed {b}")
            check(a["gated"] == b["gated"] and a.get("feasible") == b.get("feasible"),
                  f"matrix {grid}: flags of {a} differ from the committed {b}")
            check((a["bound"] is None) == (b["bound"] is None) and (
                a["bound"] is None or abs(a["bound"] - b["bound"]) <= 1e-12 * abs(b["bound"])),
                f"matrix {grid}: bound of {a} differs from the committed {b}")
        ratio = lambda cells: max(c["err"] / c["bound"] for c in cells if c["gated"])  # noqa
        worst[grid] = {"cells": len(g["cells"]), "programs": g["num_traces"],
                       "worst_err_over_bound": ratio(g["cells"]),
                       "committed_worst_err_over_bound": ratio(w["cells"])}
    print(json.dumps({"robustness_matrix": worst, "seconds": dt, "launches": launches,
                      "leaves": leaves}))
    # the largest program alone (median, m = 32: 46 cells, 60 steps) and its profile
    big = M.MatrixConfig(aggregators=("median",), ms=(32,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    M.evaluate(big, device=dev)
    torch.cuda.synchronize()
    prof = profile_summary(lambda: M.evaluate(big, device=dev),
                           (time.perf_counter() - t0) * 1e3, top=10)
    print(json.dumps({"profile_matrix_program": "sync median m=32", **prof}))
    for k, n in MATRIX_LAUNCHES.items():
        check(launches[k] == n and leaves[k] == n,
              f"matrix: {launches[k]} {k} launches for {leaves[k]} leaves, want {n} for {n}")
    return {k: launches[k] for k in MATRIX_LAUNCHES}


# ------------------------------------------------------- robust serving

# tests/test_serve.py's tiny model (phase 14a) and the full-width cell
# (14b): llama3.2-3b's published widths (configs/llama3_2_3b.py) cut to 8 of
# its 28 layers, so that the m = 4 f32 gradient rows (25.5 GB), the f32
# aggregate (6.4 GB) and the served and adapted bf16 copies fit the card.
SERVE_TINY = dict(name="serve-test", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                  d_ff=128, vocab=128, dtype="float32")
SERVE_LAYERS = 8
SERVE_D = 1_593_363_456  # 2 * 128256 * 3072 + 3072 + 8 * 100,669,440
SERVE_REQUESTS = 32
SERVE_SLICE = 1 << 26  # coordinates a column slice of the plain version holds
SERVE_LOGIT_TOL = 1e-5  # tests/test_torch_serve.py's float32 logit tolerance
# serve/run.py's defaults apart from alpha (one Byzantine shard of four)
SERVE_ENGINE = dict(slots=4, prompt_len=16, max_new=16)
SERVE_TRAFFIC = dict(num_users=1_000_000, num_shards=4, alpha=0.25, attack="feedback_flip")
SERVE_ADAPT = {"median": dict(method="median", beta=0.2),
               "trimmed_mean": dict(method="trimmed_mean", beta=0.25)}


def serve_cfg(tiny: bool):
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    if tiny:
        return dataclasses.replace(get_smoke_config("llama3_2_3b"), **SERVE_TINY)
    return dataclasses.replace(get_config("llama3_2_3b"), n_layers=SERVE_LAYERS)


def serve_traffic(cfg, scfg, **over):
    from repro_torch.fed.population import ArrivalConfig
    from repro_torch.serve.traffic import TrafficConfig

    kw = dict(SERVE_TRAFFIC, prompt_len=scfg.prompt_len, min_gen=max(1, scfg.max_new // 4),
              max_gen=scfg.max_new, vocab=cfg.vocab,
              arrival=ArrivalConfig(latency="exponential", scale=2.0))
    kw.update(over)
    return TrafficConfig(**kw)


def teacher_forced_logits(params, cfg, prompt, toks, cache_len):
    """(len(toks), V) float32 logits of every generation step, fed ``toks``."""
    import torch

    from repro_torch.models import transformer as T

    dev = params["embed"].device
    with torch.no_grad():
        logits, cache = T.prefill(params, torch.as_tensor(prompt, dtype=torch.int64,
                                                          device=dev)[None],
                                  cfg, kv_block=0, cache_len=cache_len)
        out = [logits[0, -1]]
        for j, t in enumerate(toks[:-1]):
            logits, cache = T.decode_step(params, torch.tensor([[int(t)]], device=dev), cache,
                                          len(prompt) + j, cfg)
            out.append(logits[0, 0])
    return torch.stack(out).float().cpu()


def serve_parity(dev, cfg=None, label="14a"):
    """Phase 14a (and 16a with ``cfg``): the tiny model (or ``cfg``) in f32
    (TF32 off) on the card against the same run on the CPU: the engine's
    tokens on the port's own requests (equal wherever the CPU's top-2 logit
    gap exceeds 2e-5), teacher-forced logits within 1e-5, and one adaptation
    round's iterate and grad_norm; the card's round aggregate is bitwise the
    plain version on its rows."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serve.adapt import AdaptConfig, FeedbackAdapter
    from repro_torch.serve.engine import ServeConfig, ServeEngine, serve_stream
    from repro_torch.serve.traffic import VirtualUsers
    from repro_torch.tree import ravel, tree_map

    cfg = cfg or serve_cfg(tiny=True)
    scfg = ServeConfig(slots=3, prompt_len=8, max_new=6, window=16)
    tcfg = serve_traffic(cfg, scfg, num_users=64, num_shards=2, alpha=0.5, min_gen=1)
    cpu = T.init_params(cfg, seed=0, device="cpu")
    on_card = tree_map(lambda t: t.to(dev), cpu)
    reqs = VirtualUsers(tcfg).sample_requests(16)
    done = {}
    for name, params in (("card", on_card), ("cpu", cpu)):
        out = serve_stream(ServeEngine(cfg, scfg, params), reqs)
        check(len(out) == len(reqs), f"{label}: {name} served {len(out)}/{len(reqs)}")
        done[name] = {c.request.rid: c for c in out}
    flips, worst = 0, 0.0
    for req in reqs:
        a, b = done["card"][req.rid].response, done["cpu"][req.rid].response
        want = teacher_forced_logits(cpu, cfg, req.prompt, b, scfg.cache_len)
        got = teacher_forced_logits(on_card, cfg, req.prompt, b, scfg.cache_len)
        worst = max(worst, float((got - want).abs().max()))
        top2 = torch.sort(want, dim=-1).values[:, -2:]
        gap = top2[:, 1] - top2[:, 0]
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                check(float(gap[j]) <= 2 * SERVE_LOGIT_TOL,
                      f"{label}: request {req.rid} step {j}: card token {x} != CPU {y} at a "
                      f"top-2 gap of {float(gap[j])}")
                flips += 1
                break
    check(worst <= SERVE_LOGIT_TOL,
          f"{label}: card vs CPU teacher-forced logits differ by {worst}")
    # one round on the CPU's traffic, on both devices
    acfg = AdaptConfig(adapt_every=4, batch_per_shard=1, method="median")
    users = VirtualUsers(tcfg)
    per_shard = [[c for c in done["cpu"].values() if c.request.shard == s][:1] for s in range(2)]
    check(all(len(p) == 1 for p in per_shard), f"{label}: a shard served no request")
    batch = users.build_round(per_shard, 0)
    rounds = {}
    for name, params in (("card", on_card), ("cpu", cpu)):
        ad = FeedbackAdapter(cfg, acfg, users, params)
        entry = ad.run_round(batch)
        rounds[name] = (ravel(ad.state["w"])[0].float().cpu(), entry["grad_norm"])
        if name == "card":
            hold_on_rows("median", ad.round_fn.rows, ad.state["prev_agg"], 0, label)
    w_diff = float((rounds["card"][0] - rounds["cpu"][0]).abs().max())
    g_rel = abs(rounds["card"][1] - rounds["cpu"][1]) / abs(rounds["cpu"][1])
    print(f"phase {label}: {cfg.name} f32: {len(reqs)} requests, tokens card == CPU "
          f"({flips} near-tie flips), teacher-forced logits max |diff| {worst:.3g}; one "
          f"median round: iterate max |diff| {w_diff:.3g}, grad_norm rel diff {g_rel:.3g}; "
          f"the round's B1 bitwise its plain version")
    check(w_diff <= 1e-6 + 1e-4 * float(rounds["cpu"][0].abs().max()) and g_rel <= 1e-4,
          f"{label}: the card's adaptation round differs from the CPU's")
    check(flips <= 1, f"{label}: {flips} token flips")
    return {"logits_max_abs_diff": worst, "flips": flips, "iterate_max_abs_diff": w_diff,
            "grad_norm_rel_diff": g_rel}


def serve_round_split(adapter, batch):
    """Wall ms of one adaptation round on ``batch`` (not kept), and of its
    parts: the per-shard gradients, the aggregation and the update."""
    import torch

    state = adapter.state
    fn = adapter.round_fn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(state, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stages = fn.stages(state, batch)
    r = int(state["round"])
    rows = stages.local_work(state["w"], r)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    agg = stages.aggregate(rows)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    stages.update(state["w"], state["opt_state"], agg, r)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    return {"round_ms": (t1 - t0) * 1e3, "grad_rows_ms": (t2 - t1) * 1e3,
            "aggregate_ms": (t3 - t2) * 1e3, "update_ms": (t4 - t3) * 1e3}


def hold_on_rows(kind, rows, agg, trim, label="14b"):
    """The kernel's output ``agg`` against its plain version on ``rows``,
    bitwise, in column slices of SERVE_SLICE coordinates."""
    from repro_torch.kernels import selection_network as SN

    n = rows.shape[1]
    for a in range(0, n, SERVE_SLICE):
        x = rows[:, a:a + SERVE_SLICE]
        want = SN.median_select(x) if kind == "median" else SN.trimmed_mean_select(x, trim)
        bad, err = compare(agg[a:a + SERVE_SLICE], want)
        check(bad == 0, f"{label}: {kind} rows[:, {a}:{a + x.shape[1]}]: {bad} mismatches vs the "
                        f"plain version (max |err| {err})")


def serve_cell(dev, card: str, served=None):
    """Phase 14b: llama3.2-3b at full width with 8 layers on the card: three
    runs of the 32-request stream (serve only, median, trimmed mean beta
    0.25).  Returns the B1 / B2 launches; ``served`` keeps the tokens."""
    from repro_torch.serve.engine import ServeConfig

    launches = serve_runs(dev, card, serve_cfg(tiny=False), SERVE_D,
                          ("serve_only", "median", "trimmed_mean"),
                          ServeConfig(**SERVE_ENGINE), "14b", served=served)
    return {k: launches[k][k] for k in SERVE_ADAPT}


def serve_runs(dev, card: str, cfg, d_want: int, runs, scfg, label: str,
               requests: int = SERVE_REQUESTS, mesh=None, served=None, ticks: int = 0,
               kernel_timings: bool = True):
    """``cfg`` (bf16, random weights from seed 0) on the card: one run of a
    ``requests``-request stream per entry of ``runs`` ("serve_only", or an
    aggregator of SERVE_ADAPT adapting every 8 ticks) with the launch
    counters zeroed just before each and read just after; every request
    served, >= 2 rounds a robust method, one B1 / B2 launch over one leaf a
    round and no other kernel, each round's aggregate bitwise the plain
    version on its rows (column slices), the served tensors' storage kept
    across swaps; tokens/s, latency, memory, B1/B2 at (4, D) against the
    HBM bound (the median run, unless ``kernel_timings`` is off), the
    round's split and a profile of a round (every robust run), and a
    profile of 8 ticks (serve only; after the median run, of ``ticks``
    ticks when > 0).  With a ``mesh`` the engine and the adapter run on
    it.  Returns each run's launches; ``served`` (a dict) gets each run's
    tokens by request under (model name, run, model size), and with model
    1's there already the share of equal tokens is printed; under
    ("ticks", model name, run, model size) its tick profile (tick ms,
    launches a tick, busy share, the shares equal to model 1's)."""
    import numpy as np
    import torch

    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg
    from repro_torch.models import transformer as T
    from repro_torch.serve.adapt import AdaptConfig, FeedbackAdapter
    from repro_torch.serve.engine import ServeEngine, latency_stats, serve_stream
    from repro_torch.serve.traffic import VirtualUsers

    class HeldAdapter(FeedbackAdapter):
        """Holds the kernel against its plain version on every round's rows
        (the adapter's own buffer), right after the round."""

        held = 0
        last_batch = None

        def run_round(self, batch):
            entry = super().run_round(batch)
            kind = self.acfg.method
            trim = int(self.acfg.beta * self.round_fn.rows.shape[0])
            hold_on_rows(kind, self.round_fn.rows, self.state["prev_agg"], trim, label)
            self.held += 1
            self.last_batch = batch
            return entry

    check(T.count_params(cfg) == d_want, f"{label}: {T.count_params(cfg)} parameters")
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    users = VirtualUsers(serve_traffic(cfg, scfg))
    reqs = users.sample_requests(requests)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"phase {label}: {cfg.name} width, {cfg.n_layers} layers: D = {d_want:,} "
          f"{cfg.dtype} parameters made on the card in {time.perf_counter() - t0:.1f} s; "
          f"prompt {scfg.prompt_len}, max_new {scfg.max_new}")
    total_mem = torch.cuda.get_device_properties(0).total_memory
    launches_all = {}
    model = 1 if mesh is None else dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)
    for run in runs:
        t_run = time.perf_counter()
        engine = ServeEngine(cfg, scfg, params, mesh)
        adapter = None
        if run != "serve_only":
            acfg = AdaptConfig(adapt_every=8, batch_per_shard=2, optimizer="sgd", lr=0.1,
                               **SERVE_ADAPT[run])
            adapter = HeldAdapter(cfg, acfg, users, params, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        robust_agg.reset_launches()  # zeroed just before this run
        H.reset_launches()
        t0 = time.perf_counter()
        done = serve_stream(engine, reqs, adapter=adapter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {**robust_agg.LAUNCHES, **H.LAUNCHES}  # read just after it
        leaves = dict(robust_agg.LEAVES)
        peak = torch.cuda.max_memory_allocated()
        stats = latency_stats(done)
        mt = engine.metrics
        rounds = adapter.rounds_done if adapter else 0
        line = {"serve_run": run, "model": cfg.name, "layers": cfg.n_layers, "params": d_want,
                "prompt_len": scfg.prompt_len, "requests": len(done), "ticks": engine.tick,
                "tokens": mt.total_tokens, "tick_wall_s": mt.total_wall,
                "tokens_per_s": mt.total_tokens / mt.total_wall, "stream_wall_s": wall,
                "p50_latency_ticks": stats["p50_latency"],
                "p95_latency_ticks": float(np.percentile([c.latency for c in done], 95)),
                "p99_latency_ticks": stats["p99_latency"],
                "rounds": rounds, "launches": launches, "leaves": leaves,
                "max_memory_allocated_gb": peak / 1e9, "card_memory_gb": total_mem / 1e9,
                "storage_kept": engine.storage_kept(), "model_axis": model, "card": card}
        if served is not None:
            tokens = {c.request.rid: c.response.tolist() for c in done}
            served[(cfg.name, run, model)] = tokens
            ref = served.get((cfg.name, run, 1))
            if model > 1 and ref is not None:
                pairs = [(a, b) for rid, toks in tokens.items()
                         for a, b in zip(toks, ref.get(rid, []))]
                line["tokens_equal_model_1"] = sum(a == b for a, b in pairs) / max(1, len(pairs))
                line["requests_equal_model_1"] = sum(
                    toks == ref.get(rid) for rid, toks in tokens.items()) / len(tokens)
        print(json.dumps({"serve": line}))
        check(len(done) == requests, f"{label} {run}: served {len(done)}/{requests}")
        check(all(engine.storage_kept().values()), f"{label} {run}: storage not kept")
        check(peak < total_mem, f"{label} {run}: peak {peak} >= the card's {total_mem}")
        want = {k: 0 for k in launches}
        if adapter is not None:
            check(rounds >= 2, f"{label} {run}: {rounds} adaptation rounds, want >= 2")
            check(adapter.held == rounds, f"{label} {run}: {adapter.held} of {rounds} rounds "
                                          "held")
            check(engine.params_version == rounds,
                  f"{label} {run}: {engine.params_version} swaps")
            want[run] = rounds
            check(leaves[run] == rounds,
                  f"{label} {run}: {leaves[run]} leaves in {rounds} rounds")
            print(f"phase {label}: {cfg.name} {run}: {rounds} rounds, each one {run} launch "
                  f"over one leaf of {d_want:,} coordinates, bitwise the plain version on the "
                  f"round's rows in {-(-d_want // SERVE_SLICE)} column slices")
        check(launches == want, f"{label} {run}: launches {launches}, want {want}")
        launches_all[run] = launches
        if run == "median" and kernel_timings:
            serve_kernel_timings(adapter.round_fn.rows, card, cfg.name, model)
        if adapter is not None:
            split = serve_round_split(adapter, adapter.last_batch)
            print(json.dumps({"serve_round": run, "model": cfg.name, "model_axis": model,
                              **split, "card": card}))
            prof = profile_summary(lambda: adapter.round_fn(adapter.state, adapter.last_batch),
                                   split["round_ms"], top=10, names=("leaf_select_kernel",))
            print(json.dumps({"profile_serve_round": run, "model": cfg.name,
                              "model_axis": model, **prof}))
        n_ticks = 8 if adapter is None else (ticks if run == "median" else 0)
        if n_ticks:
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                engine.step()
            torch.cuda.synchronize()
            tick_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
            prof = profile_summary(lambda: [engine.step() for _ in range(n_ticks)],
                                   tick_ms * n_ticks, top=10)
            print(json.dumps({"profile_serve_ticks": n_ticks, "run": run, "model": cfg.name,
                              "model_axis": model, "tick_ms": tick_ms, **prof}))
            if served is not None:
                served[("ticks", cfg.name, run, model)] = {
                    "tick_ms": tick_ms, "launches_a_tick": prof["launches"] / n_ticks,
                    "busy_share": prof["device_busy_share"],
                    "tokens_equal_model_1": line.get("tokens_equal_model_1"),
                    "requests_equal_model_1": line.get("requests_equal_model_1")}
        del engine, adapter
        torch.cuda.empty_cache()
        print(f"phase {label}: {run}: {time.perf_counter() - t_run:.1f} s")
    del params
    torch.cuda.empty_cache()
    return launches_all


def serve_kernel_timings(rows, card: str, model: str, model_axis: int = 1):
    """B1 and B2 at the adapter's (4, D) f32 rows: CUDA-event and profiler
    device ms against the HBM bound, the plain version timed over its
    column slices; no single PyTorch call computes either (torch.quantile
    takes at most 2^24 elements; torch.median gives the lower middle value
    for even m)."""
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import selection_network as SN

    m, n = rows.shape
    for name, trim, kernel, plain in (
            ("median", 0, lambda: robust_agg.median(rows),
             lambda: [SN.median_select(rows[:, a:a + SERVE_SLICE])
                      for a in range(0, n, SERVE_SLICE)]),
            ("trimmed_mean", 1, lambda: robust_agg.trimmed_mean(rows, 1),
             lambda: [SN.trimmed_mean_select(rows[:, a:a + SERVE_SLICE], 1)
                      for a in range(0, n, SERVE_SLICE)])):
        b_ms, b_by = bound(name, m, n, trim, 4)
        row = {"shape": "serve rows", "model": model, "model_axis": model_axis, "kernel": name,
               "m": m, "n": n, "trim": trim,
               "dtype": "float32", "ms": time_ms(kernel, 5),
               "device_ms": device_ms(kernel, 5, KERNEL_NAMES[name], launches=1),
               "plain_ms": time_ms(plain, 1), "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "card": card}
        print(json.dumps({"timing": row}))
        torch.cuda.empty_cache()


def serve_cli():
    """Phase 14c: python -m repro_torch.serve.run --smoke twice on the card,
    both processes started together: exit 0, every request served, rounds
    fired, one sha256.  Returns the lines to print."""
    import os

    args = [sys.executable, "-m", "repro_torch.serve.run", "--smoke", "--arch", "llama3_2_3b",
            "--requests", "24", "--slots", "3", "--shards", "2", "--alpha", "0.5",
            "--adapt-every", "8", "--method", "median"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    digests = []
    procs = [subprocess.Popen(args, env=env, cwd=ROOT, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for _ in range(2)]
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"serve CLI exited {proc.returncode}: {stderr[-2000:]}")
            check("served 24/24 requests" in stdout and "device cuda" in stdout,
                  f"serve CLI: {stdout[-2000:]}")
            check("storage kept: {'params': True, 'pool': True}" in stdout,
                  "serve CLI: storage not kept")
            line = [ln for ln in stdout.splitlines() if "final iterate sha256" in ln]
            check(len(line) == 1, f"serve CLI printed no sha256 line: {stdout[-2000:]}")
            digests.append(line[0].split("=")[-1].strip())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rounds = [ln for ln in stdout.splitlines() if ln.startswith("adaptation rounds")]
    check(digests[0] == digests[1], "the serve CLI is not deterministic on the card")
    return [f"phase 14c: serve CLI twice on the card: {rounds[0] if rounds else '?'}; sha256 "
            f"{digests[0]} / {digests[1]}"]


def serving(dev, card: str, served=None):
    """Phase 14: 14a and 14b (14c runs in the CLI batch); returns B1's and B2's launches on the
    serving path (14b's tokens into ``served``)."""
    t0 = time.perf_counter()
    serve_parity(dev)
    print(f"phase 14a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = serve_cell(dev, card, served)
    print(f"phase 14b: {time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------- phase 15: robust LM training
#
# tests/test_trainer.py's tiny llama (15a, 15c) and the full-width cell (15b):
# llama3.2-3b's published widths (configs/llama3_2_3b.py) cut to 8 of its 28
# layers, as phase 14, so that the params (3.19 GB), AdamW's f32 moments
# (12.7 GB), the m = 4 worker-stacked bf16 gradients (12.7 GB) and an attacked
# copy of them fit the card; run settings are python -m repro.launch.train's
# defaults (4 workers, global batch 8, seq 128, AdamW), 4 steps in windows of
# 2, but lr 1e-4: at this width the default 1e-3 diverges within a few steps
# without warmup (12.3 -> 16.9 under ALIE on the card; at one layer on the
# CPU 8.94 -> 8.02 after falling to 7.71 even with no attack).
TRAIN_TINY = dict(name="trainer-test-tiny", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                  d_ff=172, vocab=128, dtype="float32")
TRAIN_TINY_DATA = dict(vocab=128, seq_len=16, global_batch=4, num_workers=4, seed=0)
TRAIN_TINY_TOL = 1e-5  # card vs CPU: losses relative, params absolute (f32, SGD 0.5)
TRAIN_WORKERS = 4
# 16 steps before phase 22 took its time, 8 in windows of 4 before phase 25
TRAIN_STEPS, TRAIN_DS = 4, 2
TRAIN_LR = 1e-4
TRAIN_DATA = dict(seq_len=128, global_batch=8, num_workers=TRAIN_WORKERS, seed=0)
# (strategy, aggregator, attack): the robust runs, then the plain data-parallel mean
TRAIN_RUNS = (("gather", "median", "alie"), ("bucketed", "median", "alie"),
              ("gather", "trimmed_mean", "alie"), ("psum", "mean", "alie"),
              ("psum", "mean", "sign_flip"), ("gather", "median", "sign_flip"))
# the runs whose step is profiled: the first of each strategy (the others
# repeat its launches; their split is still timed)
TRAIN_PROFILED = ("gather/median/alie", "bucketed/median/alie", "psum/mean/alie")
TRAIN_ALPHA, TRAIN_BETA = 0.25, 0.25
CHUNKED_N = 1 << 24  # one leaf of 2^24 coordinates: 16 sketch chunks of 2^20


class HeldAggregation:
    """Inside ``with``: every call of ``aggregators.aggregate_leaves`` on
    ``device`` with the median or the trimmed mean is held against the plain
    selection network on the same rows, bitwise, in column slices of
    SERVE_SLICE coordinates, when ``hold(call)`` says so (the call's index,
    from 0).  The check suspends the sync-debug mode (it reads the card);
    the aggregation it checks does not."""

    def __init__(self, device, hold=lambda call: True, keep=lambda call: False):
        self.device, self.hold, self.keep = device, hold, keep
        self.calls = self.held = 0
        self.kept = None

    def __enter__(self):
        from repro_torch.core import aggregators

        self._real = aggregators.aggregate_leaves

        def wrapped(leaves, method, beta=0.1):
            outs = self._real(leaves, method, beta)
            call, self.calls = self.calls, self.calls + 1
            if method in ("median", "trimmed_mean") and leaves and \
                    leaves[0].device == self.device:
                if self.keep(call):
                    self.kept = (list(leaves), method, beta)
                if self.hold(call):
                    self._check(leaves, outs, method, beta)
            return outs

        aggregators.aggregate_leaves = wrapped
        return self

    def __exit__(self, *exc):
        from repro_torch.core import aggregators

        aggregators.aggregate_leaves = self._real

    def _check(self, leaves, outs, method, beta):
        import torch

        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            for x, out in zip(leaves, outs):
                m = x.shape[0]
                hold_on_rows(method, x.reshape(m, -1), out.reshape(-1), int(beta * m), "15")
            self.held += 1
        finally:
            torch.cuda.set_sync_debug_mode(mode)


def sync_free_windows():
    """Patch ``trainer.make_window_step`` so that every window runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a micro-step that waits for
    the card raises.  Returns the function that undoes the patch."""
    import torch

    from repro_torch.launch import trainer

    real = trainer.make_window_step

    def make(*args, **kwargs):
        window = real(*args, **kwargs)

        def guarded(state, batches):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return window(state, batches)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        return guarded

    trainer.make_window_step = make
    return lambda: setattr(trainer, "make_window_step", real)


def train_tiny_cfg():
    import dataclasses

    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config("llama3.2-3b"), **TRAIN_TINY)


def train_parity(dev):
    """Phase 15a: the tiny llama in f32 (TF32 off), 4 steps of SGD 0.5 on the
    same batches on the card and on the CPU, gather and bucketed x median and
    trimmed mean (beta 0.25) under alie alpha 0.25; losses and params within
    TRAIN_TINY_TOL, every step's aggregate on the card bitwise its plain
    version, and no window waits for the card."""
    import torch

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    cfg = train_tiny_cfg()
    dcfg = DataConfig(**TRAIN_TINY_DATA)
    atk = AttackConfig("alie", TRAIN_ALPHA)
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    block = trainer.stack_window_batches(dcfg, 0, 4, mesh_lib.make_debug_mesh(4, device="cpu"),
                                         atk, cfg)
    undo = sync_free_windows()
    worst_loss = worst_param = 0.0
    try:
        for strategy in ("gather", "bucketed"):
            for method in ("median", "trimmed_mean"):
                pcfg = ParallelConfig(agg_method=method, agg_strategy=strategy,
                                      agg_beta=TRAIN_BETA, remat=False)
                runs = {}
                for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
                    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, device=d)
                    opt = get_optimizer("sgd", 0.5)
                    state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
                    state["params"] = tree_map(lambda t: t.to(d), cpu_params)
                    state["opt_state"] = opt.init(state["params"])
                    window = trainer.make_window_step(cfg, pcfg, mesh, opt, atk, 1)
                    losses = []
                    with HeldAggregation(dev) as held:
                        for i in range(4):
                            before = float(state["metrics"]["loss_sum"])
                            state = window(state, {k: v[i:i + 1].to(d) for k, v in block.items()})
                            losses.append(float(state["metrics"]["loss_sum"]) - before)
                    if name == "card":
                        check(held.held == 4, f"15a {strategy}/{method}: {held.held} of 4 "
                                              "steps' aggregates held")
                    runs[name] = (losses, [t.cpu() for t in tree_leaves(state["params"])])
                (lc, pc), (lx, px) = runs["card"], runs["cpu"]
                dl = max(abs(a - b) / abs(b) for a, b in zip(lc, lx))
                dp = max(float((a - b).abs().max()) for a, b in zip(pc, px))
                worst_loss, worst_param = max(worst_loss, dl), max(worst_param, dp)
                check(dl <= TRAIN_TINY_TOL and dp <= TRAIN_TINY_TOL,
                      f"15a {strategy}/{method}: card vs CPU losses {dl}, params {dp}")
    finally:
        undo()
    print(f"phase 15a: tiny llama f32, gather and bucketed x median and trimmed mean under "
          f"alie, 4 steps: card vs CPU losses rel {worst_loss:.3g}, params {worst_param:.3g} "
          f"(tolerance {TRAIN_TINY_TOL}); every step's aggregate bitwise its plain version; "
          f"no window waited for the card")


def train_step_split(cfg, pcfg, mesh, attack, state, batch, step):
    """Wall ms of one more step (not kept) and of its parts: the aggregation
    (aggregate_by_strategy; under fsdp the in-process robust reduce-scatter,
    ``reduce_scatter_ms``) and the update (AdamW), each closed by a
    synchronize; the per-worker gradients are the rest.  Inside the
    aggregation, the attack on the gathered rows (``attack_ms``) and the
    robust aggregation call (``b1_b2_ms``: B1 / B2 and their output
    views) are timed too."""
    import torch

    from repro_torch.core import aggregators
    from repro_torch.core import distributed as D
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import Optimizer, get_optimizer

    opt = get_optimizer("adamw", TRAIN_LR)
    parts = {"aggregate_ms": 0.0, "reduce_scatter_ms": 0.0, "update_ms": 0.0,
             "attack_ms": 0.0, "b1_b2_ms": 0.0}

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            parts[key] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    real_agg, real_rs = steps.rounds_dist.aggregate_by_strategy, D.robust_reduce_scatter_dims
    real_attack, real_leaves = D._maybe_attack, aggregators.aggregate_leaves
    steps.rounds_dist.aggregate_by_strategy = timed("aggregate_ms", real_agg)
    D.robust_reduce_scatter_dims = timed("reduce_scatter_ms", real_rs)
    D._maybe_attack = timed("attack_ms", real_attack)
    aggregators.aggregate_leaves = timed("b1_b2_ms", real_leaves)
    try:
        sb = steps.make_step_body(cfg, pcfg, mesh,
                                  Optimizer(opt.init, timed("update_ms", opt.update)), attack)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sb.body(state["params"], state["opt_state"], batch, step, 0)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        del out
    finally:
        steps.rounds_dist.aggregate_by_strategy = real_agg
        D.robust_reduce_scatter_dims = real_rs
        D._maybe_attack, aggregators.aggregate_leaves = real_attack, real_leaves
    parts["step_ms"] = total
    parts["worker_grads_ms"] = (total - parts["aggregate_ms"] - parts["reduce_scatter_ms"]
                                - parts["update_ms"])
    return parts


def train_kernel_timings(kept, card: str, shape: str = "train grads"):
    """B1 and B2 at the worker-stacked bf16 gradients (4, D) of a trained
    cell's last step, all leaves in one call (one launch a MAX_LEAVES of
    them): CUDA-event and profiler device ms against the HBM bound, the
    plain version over column slices."""
    import torch

    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import selection_network as SN

    from repro_torch.kernels import select_codegen

    leaves = [x.reshape(x.shape[0], -1) for x in kept[0]]
    m, n = leaves[0].shape[0], sum(x.shape[1] for x in leaves)
    launches = -(-len(leaves) // select_codegen.MAX_LEAVES)
    rows = []
    for name, trim, kernel, plain in (
            ("median", 0, lambda: robust_agg.median_many(leaves),
             lambda: [SN.median_select(x[:, a:a + SERVE_SLICE]) for x in leaves
                      for a in range(0, x.shape[1], SERVE_SLICE)]),
            ("trimmed_mean", 1, lambda: robust_agg.trimmed_mean_many(leaves, 1),
             lambda: [SN.trimmed_mean_select(x[:, a:a + SERVE_SLICE], 1) for x in leaves
                      for a in range(0, x.shape[1], SERVE_SLICE)])):
        b_ms, b_by = bound(name, m, n, trim, 2)
        row = {"shape": shape, "kernel": name, "m": m, "n": n, "leaves": len(leaves),
               "launches": launches, "trim": trim, "dtype": "bfloat16",
               "ms": time_ms(kernel, 5),
               "device_ms": device_ms(kernel, 5, KERNEL_NAMES[name], launches=launches),
               "plain_ms": time_ms(plain, 1), "library_ms": None,
               "bound_ms": b_ms, "bound_by": b_by, "card": card}
        print(json.dumps({"timing": row}))
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def train_cell(dev, card: str):
    """Phase 15b: llama3.2-3b's widths at 8 layers trained with 4 in-process
    workers through ``trainer.train_loop`` (TRAIN_RUNS, TRAIN_STEPS steps in windows
    of 4), every window under the sync-debug "error" mode; the counters
    zeroed just before each run and read just after.  Holds: the last
    window's aggregates bitwise their plain versions (column slices), the
    robust runs' loss falling, and under sign_flip the median's last loss
    below the mean's; B1 / B2 timed on the gather/median run's last rows.
    Returns the B1 / B2 launches."""
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer

    cfg = serve_cfg(tiny=False)
    check(T.count_params(cfg) == SERVE_D, f"15b: {T.count_params(cfg)} parameters")
    torch.cuda.empty_cache()
    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=TRAIN_STEPS, device_steps=TRAIN_DS)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    launches_all = {"median": 0, "trimmed_mean": 0}
    last_loss = {}
    undo = sync_free_windows()
    try:
        for strategy, method, attack in TRAIN_RUNS:
            run = f"{strategy}/{method}/{attack}"
            pcfg = ParallelConfig(agg_method=method, agg_strategy=strategy, agg_beta=TRAIN_BETA,
                                  remat=False, attn_chunk=0)  # 22d runs remat
            atk = AttackConfig(attack, TRAIN_ALPHA)
            keep = run == "gather/median/alie"
            first_held = TRAIN_STEPS - TRAIN_DS
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            robust_agg.reset_launches()  # zeroed just before this run
            H.reset_launches()
            t0 = time.perf_counter()
            with HeldAggregation(dev, hold=lambda c: c >= first_held,
                                 keep=lambda c: keep and c == TRAIN_STEPS - 1) as held:
                result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**robust_agg.LAUNCHES, **H.LAUNCHES}  # read just after it
            leaves = dict(robust_agg.LEAVES)
            peak = torch.cuda.max_memory_allocated()
            hist = result.history
            robust = method != "mean"
            want = {k: 0 for k in launches}
            if robust:
                want[method] = TRAIN_STEPS  # all leaves in one launch a step
                check(held.held == TRAIN_DS, f"15b {run}: {held.held} of the last window's "
                                             f"{TRAIN_DS} aggregates held")
            check(launches == want, f"15b {run}: launches {launches}, want {want}")
            for k in launches_all:
                launches_all[k] += launches[k]
            losses = [h["loss"] for h in hist]
            check(all(map(lambda v: v == v and abs(v) < 1e4, losses)), f"15b {run}: {losses}")
            if robust:
                check(losses[-1] < losses[0], f"15b {run}: the loss did not fall: {losses}")
            last_loss[(strategy, method, attack)] = losses[-1]
            batch = {k: v[0] for k, v in trainer.stack_window_batches(
                dcfg, TRAIN_STEPS, 1, mesh, atk, cfg).items()}
            split = train_step_split(cfg, pcfg, mesh, atk, result.state, batch, TRAIN_STEPS)
            prof = {"device_busy_share": None}
            if run in TRAIN_PROFILED:
                sb = steps.make_step_body(cfg, pcfg, mesh, get_optimizer("adamw", TRAIN_LR), atk)
                prof = profile_summary(lambda: sb.body(result.state["params"],
                                                       result.state["opt_state"], batch,
                                                       TRAIN_STEPS, 0),
                                       split["step_ms"], top=10, names=("leaf_select_kernel",))
                print(json.dumps({"profile_train_step": run, **prof}))
                del sb
            busy = prof["device_busy_share"]
            line = {"train_run": run, "steps": TRAIN_STEPS, "device_steps": TRAIN_DS,
                    "workers": TRAIN_WORKERS, "tokens_per_step": dcfg.global_batch * dcfg.seq_len,
                    "steps_per_s": result.steps_per_s, "tokens_per_s": result.tokens_per_s,
                    "first_window_s": result.compile_s, "window_times_s": result.window_times_s,
                    "run_wall_s": wall, "loss_first_window": losses[0],
                    "loss_last_window": losses[-1], "losses": losses,
                    "grad_norm_last_window": hist[-1]["grad_norm"],
                    "launches": launches, "leaves": leaves,
                    "b1_b2_launches_per_step": sum(launches[k] for k in launches_all) / TRAIN_STEPS,
                    "max_memory_allocated_gb": peak / 1e9, "card_memory_gb": total_mem / 1e9,
                    "split_ms": split, "device_busy_share": prof["device_busy_share"],
                    "card": card}
            print(json.dumps({"train": line}))
            print(f"phase 15b: {run}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                  f"{result.steps_per_s:.3f} steps/s, {result.tokens_per_s:.0f} tokens/s, "
                  f"step {split['step_ms']:.1f} ms (grads {split['worker_grads_ms']:.1f}, "
                  f"aggregate {split['aggregate_ms']:.1f}, update {split['update_ms']:.1f}), "
                  + (f"busy {busy:.3f}, " if busy is not None else "")
                  + f"peak {peak / 1e9:.2f} GB")
            check(peak < total_mem, f"15b {run}: peak {peak} >= the card's {total_mem}")
            if keep:
                kept = held.kept
            del result, held, batch
            torch.cuda.empty_cache()
            if keep:
                train_kernel_timings(kept, card)
                del kept
                torch.cuda.empty_cache()
    finally:
        undo()
    med, mean = (last_loss[("gather", "median", "sign_flip")],
                 last_loss[("psum", "mean", "sign_flip")])
    print(f"phase 15b: under sign_flip the last window's loss: gather/median {med:.4f}, "
          f"psum/mean {mean:.4f}")
    check(med < mean, "15b: under sign_flip the median did not end below the mean")
    return launches_all


def train_chunked(dev):
    """Phase 15c: the chunked strategy (B4 range, B5 counts and sums) on one
    2^24-coordinate leaf of 4 workers' rows, median and trimmed mean (beta
    0.25), within one bin width of the exact estimators (B1 / B2 on the same
    rows), and two steps of the tiny llama through the trainer; B4/B5 are
    held against their plain versions on the path's inputs by the caller.
    Returns the B4 / B5 launches."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core import distributed as D
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer

    rng_ = np.random.default_rng(15)
    rows = torch.from_numpy(rng_.standard_normal((TRAIN_WORKERS, CHUNKED_N))
                            .astype(np.float32)).to(dev)
    ax = D.InProcessAxes({"data": TRAIN_WORKERS}, dev)
    robust_agg.reset_launches()
    H.reset_launches()
    out = {}
    for method in ("median", "trimmed_mean"):
        out[method] = D.robust_chunked_agg({"w": rows}, ax, ("data",), method,
                                           beta=TRAIN_BETA)["w"]
    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, device=dev)
    for method in ("median", "trimmed_mean"):
        pcfg = ParallelConfig(agg_method=method, agg_strategy="chunked", agg_beta=TRAIN_BETA,
                              remat=False)
        r = trainer.train_loop(train_tiny_cfg(), pcfg,
                               TrainConfig(optimizer="adamw", lr=1e-2, steps=2, device_steps=2),
                               mesh, dcfg=DataConfig(**TRAIN_TINY_DATA))
        check(all(np.isfinite(h["loss"]) for h in r.history), "15c: tiny llama losses")
    torch.cuda.synchronize()
    launches = dict(H.LAUNCHES)
    check(sum(robust_agg.LAUNCHES.values()) == 0, "15c: an exact kernel ran on the sketch path")
    chunks = -(-CHUNKED_N // D.COORD_CHUNK)
    check(launches["minmax"] >= 2 and launches["histogram"] >= 2 * chunks,
          f"15c: launches {launches}")
    width = (rows.amax(0) - rows.amin(0)) / 256
    exact = {"median": robust_agg.median(rows), "trimmed_mean": robust_agg.trimmed_mean(rows, 1)}
    for method in out:
        dev_ = (out[method] - exact[method]).abs()
        check(bool((dev_ <= width * (1 + 1e-6)).all()),
              f"15c: {method} off the exact one by more than a bin")
        print(f"phase 15c: chunked {method} over (4, {CHUNKED_N}): max |sketch - exact| "
              f"{float(dev_.max()):.4g}, bin width {float(width.mean()):.4g} on average")
    print(f"phase 15c: {chunks} B5 launches a leaf of {CHUNKED_N} (chunks of {D.COORD_CHUNK}); "
          f"launches {launches}")
    return launches


def chunked_timings(dev, card: str):
    """B4 at 15c's leaf (4, 2^24) and B5 at its chunks (4, 2^20), 256 bins,
    with and without sums: events, device, plain, bound (after the path's
    counts were read)."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as D

    x = torch.from_numpy(np.random.default_rng(15).standard_normal((TRAIN_WORKERS, CHUNKED_N))
                         .astype(np.float32)).to(dev)
    sketch_time_rows("chunked leaf", x, 256, card, kinds={("minmax", False)})
    sketch_time_rows("chunked chunk", x[:, :D.COORD_CHUNK].contiguous(), 256, card,
                     kinds={("histogram", True), ("histogram", False)})
    del x
    torch.cuda.empty_cache()


def train_cli():
    """Phase 15d: python -m repro_torch.launch.train on the card: exit 0,
    the window lines and the done line.  Returns the lines to print."""
    import os

    args = [sys.executable, "-m", "repro_torch.launch.train", "--config", "llama3.2-3b",
            "--smoke", "--steps", "4", "--device-steps", "2", "--workers", "4", "--seq-len",
            "32", "--global-batch", "4", "--strategy", "bucketed", "--agg", "median",
            "--attack", "alie", "--attack-alpha", "0.25"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    check(out.returncode == 0, f"train CLI exited {out.returncode}: {out.stderr[-2000:]}")
    check("device cuda" in out.stdout, f"train CLI: {out.stdout[-2000:]}")
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done: 4 steps")]
    check(len(done) == 1, f"train CLI printed no done line: {out.stdout[-2000:]}")
    return [f"phase 15d: train CLI on the card: {done[0]}"]


def training(dev, card: str, on_path):
    """Phase 15: 15a-15c (15d runs in the CLI batch); returns the launches
    of 15b's and 15c's paths."""
    t0 = time.perf_counter()
    train_parity(dev)
    print(f"phase 15a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = train_cell(dev, card)
    print(f"phase 15b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    chunked = on_path("phase 15c", lambda: train_chunked(dev), lambda c: c)
    chunked_timings(dev, card)
    print(f"phase 15c: {time.perf_counter() - t0:.1f} s")
    return {"train": launches, "train_chunked": chunked}


# ------------------------------ phase 16: the MoE, SSM and hybrid families
#
# (a) each family's smoke config in f32, card against CPU; (b) three
# full-width cells, random weights from seed 0, bf16, cut in depth so that
# the adapter's (4, D) f32 rows sit beside the served and adapted copies
# (at full depth mamba2-2.7b's rows are 45.3 GB and recurrentgemma-2b's
# 56.8 GB) and so that the script runs well inside its time limit:
# granite-moe-1b-a400m at 12 of 24 layers, mamba2-2.7b at 8 of 64
# with 272-token prompts (its prefill crosses the 256-token SSD chunk and
# takes the padded path), recurrentgemma-2b at 5 of 26 (one (rec, rec,
# attn) super-block and the 2-layer rec tail, the smoke config's
# structure); phase 14b's traffic and adaptation.  grok-1-314b
# (316·10^9 parameters) is held at its smoke width only.  The cells' serve-only
# runs were dropped when phase 22 took its time (14b and 21b keep a
# serve-only run): each median run profiles FAMILY_TICKS ticks after its
# stream instead, for the tick's readings.
FAMILY_SMOKE = ("granite_moe_1b_a400m", "grok_1_314b", "mamba2_2_7b", "recurrentgemma_2b")
FAMILY_CELLS = (  # (config, layers, D, prompt length, runs)
    # the median run only (its trimmed-mean run went to pay for phase 23;
    # B2 runs on 14b's, 15b's and 20b's paths)
    # (granite at 24 layers and mamba2 at 32, then 16, before the script was
    # cut to run well inside its time limit)
    ("granite_moe_1b_a400m", 12, 742_816_768, 16, ("median",)),
    ("mamba2_2_7b", 4, 418_280_896, 272, ("median",)),  # 8 layers before phase 25
    ("recurrentgemma_2b", 5, 1_751_221_760, 16, ("median",)))
FAMILY_TICKS = 2
# phase 14b's 32 requests cut to 24 (66 ticks, 2 rounds a robust run, not
# 87 and 3) to keep phase 16 near its time budget; widths are never cut
FAMILY_REQUESTS = 24
FAMILY_TRAIN = ("granite_moe_1b_a400m", "mamba2_2_7b", "recurrentgemma_2b")


def family_parity(dev):
    """Phase 16a: serve_parity on each family's smoke config in f32."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    for arch in FAMILY_SMOKE:
        serve_parity(dev, dataclasses.replace(get_smoke_config(arch), dtype="float32"),
                     f"16a {arch}")


def family_cells(dev, card: str, served=None):
    """Phase 16b: the three full-width cells; returns each kernel's launches
    over their runs, as measured in each run (their tokens into
    ``served``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import ServeConfig

    total = {}
    for arch, layers, d, prompt, runs in FAMILY_CELLS:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        t0 = time.perf_counter()
        launches = serve_runs(dev, card, cfg, d, runs,
                              ServeConfig(slots=4, prompt_len=prompt, max_new=16),
                              f"16b {arch}", requests=FAMILY_REQUESTS, served=served,
                              ticks=FAMILY_TICKS)
        for counts in launches.values():
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        print(f"phase 16b: {arch}: {time.perf_counter() - t0:.1f} s")
    return total


def family_serve_cli():
    """Phase 16c: python -m repro_torch.serve.run --smoke --arch <family>
    twice per family, all eight processes started together on the card:
    exit 0, every request served, rounds fired, the storage kept, one
    sha256 per family.  Returns the lines to print."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    try:
        for arch in FAMILY_SMOKE:
            args = [sys.executable, "-m", "repro_torch.serve.run", "--smoke", "--arch", arch,
                    "--requests", "12", "--slots", "3", "--shards", "2", "--alpha", "0.5",
                    "--adapt-every", "6", "--batch-per-shard", "1", "--method", "median"]
            for _ in range(2):
                procs.append((arch, subprocess.Popen(args, env=env, cwd=ROOT, text=True,
                                                     stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE)))
        digests = {}
        for arch, proc in procs:
            out, err = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"16c: serve CLI {arch} exited {proc.returncode}: "
                                        f"{err[-2000:]}")
            check("served 12/12 requests" in out and "device cuda" in out,
                  f"16c: serve CLI {arch}: {out[-2000:]}")
            check("storage kept: {'params': True, 'pool': True}" in out,
                  f"16c: serve CLI {arch}: storage not kept")
            check("adaptation rounds: 0" not in out, f"16c: serve CLI {arch}: no round")
            line = [ln for ln in out.splitlines() if "final iterate sha256" in ln]
            check(len(line) == 1, f"16c: serve CLI {arch} printed no sha256: {out[-2000:]}")
            digests.setdefault(arch, []).append(line[0].split("=")[-1].strip())
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for arch, (a, b) in digests.items():
        check(a == b, f"16c: the serve CLI is not deterministic on the card for {arch}")
    return [f"phase 16c: serve CLI twice per family on the card, one sha256 each: "
            f"{json.dumps({k: v[0][:16] for k, v in digests.items()})}"]


def family_train_cli(dev):
    """Phase 16d: python -m repro_torch.launch.train --smoke --arch <family>
    (run in this process, on the card) for granite, mamba2 and
    recurrentgemma, 2 steps of gather median under alie: B1's launches
    counted per dtype group (MAX_LEAVES leaves a launch) against the
    aggregation calls' leaves, and no other kernel launched.  Returns each
    kernel's launches over the three runs."""
    return train_cli_counted(FAMILY_TRAIN, "16d")


def train_cli_counted(archs, label: str, one_launch: bool = False):
    """The train CLI in this process for each of ``archs`` (see
    family_train_cli); with ``one_launch`` every step must be one B1
    launch.  Returns each kernel's launches over the runs."""
    import contextlib
    import io

    from repro_torch.core import aggregators
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg
    from repro_torch.kernels import select_codegen as G
    from repro_torch.launch import train

    real = aggregators.aggregate_leaves
    total = {}
    for arch in archs:
        groups = []

        def counted(leaves, method, beta=0.1):
            by = {}
            for x in leaves:
                by[str(x.dtype).removeprefix("torch.")] = by.get(
                    str(x.dtype).removeprefix("torch."), 0) + 1
            groups.append(by)
            return real(leaves, method, beta)

        aggregators.aggregate_leaves = counted
        robust_agg.reset_launches()  # zeroed just before this run
        H.reset_launches()
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                rc = train.main(["--config", arch, "--smoke", "--steps", "2", "--device-steps",
                                 "1", "--workers", "4", "--seq-len", "32", "--global-batch", "4",
                                 "--strategy", "gather", "--agg", "median", "--attack", "alie",
                                 "--attack-alpha", "0.25"])
        finally:
            aggregators.aggregate_leaves = real
        launches = {**robust_agg.LAUNCHES, **H.LAUNCHES}  # read just after it
        out = buf.getvalue()
        check(rc == 0 and "device cuda" in out and "done: 2 steps" in out,
              f"{label}: train CLI {arch}: {out[-2000:]}")
        want = sum(-(-n // G.MAX_LEAVES) for g in groups for n in g.values())
        check(len(groups) == 2 and launches["median"] == want and
              sum(v for k, v in launches.items() if k != "median") == 0,
              f"{label}: {arch}: launches {launches} for groups {groups}, want {want} medians")
        check(not one_launch or want == 2, f"{label}: {arch}: {want} B1 launches in 2 steps")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"phase {label}: train CLI {arch} on the card: {out.splitlines()[0]} ... "
              f"{out.splitlines()[-1]}; per step the dtype groups {groups[0]}: {want // 2} B1 "
              f"launches a step")
    return total


def families(dev, card: str, served=None):
    """Phase 16: 16a, 16b and 16d (16c runs in the CLI batch); returns each
    kernel's launches on 16b's and 16d's paths."""
    t0 = time.perf_counter()
    family_parity(dev)
    print(f"phase 16a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serve = family_cells(dev, card, served)
    print(f"phase 16b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches = family_train_cli(dev)
    print(f"phase 16d: {time.perf_counter() - t0:.1f} s")
    return {"families_serve": serve, "families_train_cli": train_launches}


# ------------------ phase 16e: the MoE combine's kernels (kernels/moe_combine.py)
#
# Both kernels against their plain versions on the card, at granite-moe's
# training shapes (the benchmark cell's: B 4, S 2048, top-8 of 32, D 1024,
# cap 640) with the router skewed to 8 experts so that most pairs drop, at
# the same shapes as rank 1 of split="experts" at model 2 (its ``mine``
# mask: the other half of the experts' pairs are not kept and their rows
# lie outside its buffer) and at a serving decode step (B 4, S 1, cap 1),
# in bf16 (the cells') and f32 (the parity phases'); then timed at the
# training shapes in bf16 for the kernels line.  Phases 16, 20, 21 and 23,
# which run the MoE layer on the card, each zero the launch counters just
# before and read them just after, and hold the first call of each shape
# they made (CombineCalls) the same way.
MC_SHAPES = (("train", 4, 2048, False), ("train, rank 1 of split=experts", 4, 2048, True),
             ("decode", 4, 1, False))
MC_HOT = 8  # experts the router's logits favour (by 3.0) in 16e's routing
# y against the plain version over max |y|, and d_weight over each pair's
# sum_d |ye * dy|: f32 rounding of a K-term and a D-term sum; d_ye bitwise
MC_TOL = 1e-6
MC_HBM = 3.35e12  # bytes/s, the H100 SXM's HBM3 (launch/roofline.py)


def combine_inputs(dev, b: int, s: int, split: bool, dtype, seed: int):
    """(ye, rows, keep, weight, dy) as ``moe._experts`` hands them to the
    combine at granite-moe-1b-a400m's widths, the routing skewed to MC_HOT
    experts; ``split``: rank 1 of split="experts" at model 2."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite_moe_1b_a400m")
    e, k, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn(b, s, e, device=dev, generator=g)
    logits[..., :MC_HOT] += 3.0
    cap = moe.capacity(s, e, k)
    r = moe.route(torch.softmax(logits, dim=-1), k, cap)
    el = e // 2 if split else e
    e0 = e - el
    keep = r.keep & (r.expert >= e0)
    rows = ((r.expert - e0) * b + torch.arange(b, device=dev)[:, None, None]) * cap + r.slot
    ye = torch.randn(el * b * cap, d, device=dev, generator=g).to(dtype)
    dy = torch.randn(b, s, d, device=dev, generator=g)
    return ye, rows, keep, r.weight, dy


def combine_errors(label: str, ye, rows, keep, weight, dy=None) -> dict:
    """The kernels against the plain versions on one set of inputs: the
    forward's error over max |y|, or (with ``dy``) the backward's d_ye
    bitwise and d_weight's error over each kept pair's sum_d |ye * dy|
    (exactly 0 where not kept).  Returns {kernel: error}."""
    import torch

    from repro_torch.kernels import moe_combine as MC

    if dy is None:
        got, want = MC._COMBINE(ye, rows, keep, weight), MC.combine_plain(ye, rows, keep, weight)
        err = float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))
        check(err <= MC_TOL, f"{label}: the combine's y off by {err:.3g} of max |y|")
        return {"moe_combine": err}
    d_ye, d_w = MC._COMBINE_BACKWARD(dy, ye, rows, keep, weight)
    d_ye_p, d_w_p = MC.combine_backward_plain(dy, ye, rows, keep, weight)
    bits = torch.int32 if ye.dtype == torch.float32 else torch.int16
    check(torch.equal(d_ye.view(bits), d_ye_p.view(bits)),
          f"{label}: the combine's d_ye differs from the plain version's")
    check(bool(torch.all(d_w[~keep] == 0)), f"{label}: d_weight not 0 where not kept")
    picked = ye[torch.where(keep, rows, torch.zeros_like(rows))].float()
    scale = torch.sum((picked * dy[..., None, :]).abs(), dim=-1)
    err = float(((d_w - d_w_p).abs() / scale.clamp(min=1e-30))[keep].max()) if keep.any() else 0.0
    check(err <= MC_TOL, f"{label}: the combine's d_weight off by {err:.3g} of sum |ye dy|")
    return {"moe_combine_backward": err}


class CombineCalls:
    """Inside ``with``: records the first call of each shape and dtype that
    a path makes to the combine's dispatcher ops (forward and backward), as
    copies on the card (no host sync: phase 20 runs under the sync-debug
    mode); ``hold`` runs the kernels again on them against the plain
    versions (combine_errors).  Call it after the path's launches were
    read: its launches are not the path's."""

    def __enter__(self):
        from repro_torch.kernels import moe_combine as MC

        self.calls, self._orig = {}, (MC._COMBINE, MC._COMBINE_BACKWARD)

        def recording(kind, fn):
            def recorded(*args):
                key = (kind,) + tuple((tuple(a.shape), a.dtype) for a in args)
                if args[0].is_cuda and key not in self.calls:
                    self.calls[key] = [a.clone() for a in args]
                return fn(*args)
            return recorded

        MC._COMBINE = recording("forward", self._orig[0])
        MC._COMBINE_BACKWARD = recording("backward", self._orig[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import moe_combine as MC

        MC._COMBINE, MC._COMBINE_BACKWARD = self._orig

    def hold(self, label: str, worst: dict) -> None:
        import torch

        shapes = []
        for key, args in self.calls.items():
            dy = args.pop(0) if key[0] == "backward" else None
            for name, err in combine_errors(label, *args, dy=dy).items():
                worst[name] = max(worst.get(name, 0.0), err)
            shapes.append(f"{key[0]} ye {tuple(args[0].shape)} {args[0].dtype}, pairs "
                          f"{tuple(args[1].shape)}, {int(args[2].sum())} kept")
        self.calls.clear()
        torch.cuda.empty_cache()
        print(f"{label}: the combine's kernels held against their plain versions on the "
              f"path's own inputs (d_ye bitwise): {shapes}")


def combine_bound(ye, rows, keep, backward: bool):
    """(ms, bytes) the combine moves at HBM bandwidth: the forward reads the
    kept rows and the pairs' (row, keep, weight), writes y (f32); the
    backward reads dy, the kept rows and the pairs, writes every row of
    d_ye once and d_weight."""
    n, k = rows.numel() // rows.shape[-1], rows.shape[-1]
    d, s = ye.shape[1], ye.element_size()
    kept = int(keep.sum())
    by = kept * d * s + n * k * 13 + n * d * 4
    if backward:
        by += ye.shape[0] * d * s + n * k * 4
    return by / MC_HBM * 1e3, by


def combine_check(dev, card: str, worst: dict) -> list:
    """Phase 16e: returns the forward's and the backward's timing rows at
    granite's training shapes in bf16."""
    import torch

    from repro_torch.kernels import moe_combine as MC

    held = []
    for label, b, s, split in MC_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            ye, rows, keep, weight, dy = combine_inputs(dev, b, s, split, dtype, seed=b + s)
            dropped = 1 - float(keep.float().mean())
            if s > 1:
                check(dropped > 0.5, f"16e {label}: {dropped:.1%} of the pairs dropped")
            errs = {}
            for g in (None, dy):
                errs.update(combine_errors(f"16e {label}", ye, rows, keep, weight, dy=g))
            for name, err in errs.items():
                worst[name] = max(worst.get(name, 0.0), err)
            held.append({"shape": label, "dtype": str(dtype).removeprefix("torch."),
                         "rows": ye.shape[0], "dropped": round(dropped, 4), **errs})
    print(json.dumps({"moe_combine_held": held, "tolerance": MC_TOL, "d_ye": "bitwise"}))
    ye, rows, keep, weight, dy = combine_inputs(dev, 4, 2048, False, torch.bfloat16, seed=2052)
    out = []
    for name, kernel, plain, backward in (
            ("moe_combine", lambda: MC._COMBINE(ye, rows, keep, weight),
             lambda: MC.combine_plain(ye, rows, keep, weight), False),
            ("moe_combine_backward", lambda: MC._COMBINE_BACKWARD(dy, ye, rows, keep, weight),
             lambda: MC.combine_backward_plain(dy, ye, rows, keep, weight), True)):
        b_ms, b_by = combine_bound(ye, rows, keep, backward)
        row = {"shape": "granite train", "kernel": name, "b": 4, "s": 2048, "k": rows.shape[-1],
               "d": ye.shape[1], "rows": ye.shape[0], "kept": int(keep.sum()),
               "dtype": "bfloat16", "ms": time_ms(kernel, 200),
               # the backward's memset of d_ye is part of its device time
               "device_ms": device_ms(kernel, 20, "" if backward else "combine_kernel"),
               "plain_ms": time_ms(plain, 20), "library_ms": None,
               "bound_ms": b_ms, "bound_bytes": b_by, "bound_by": "bytes", "card": card}
        print(json.dumps({"timing": row}))
        out.append(row)
    del ye, rows, keep, weight, dy
    torch.cuda.empty_cache()
    return out


# ------------------ phase 17: distributed round programs and the process group
#
# (a) one_round_distributed at phase 8's Table 4 configuration and (b)
# make_local_update_round on phase 10's CNN, both over the in-process debug
# mesh at m = 10; (c) the serve CLI with the reference's CI smoke flags;
# (d) the torch.distributed process group at world size 1 under NCCL (the
# train CLI with --mesh single, and the strategies in this process).  NCCL
# refuses two ranks on one card, so 4-rank runs are held on gloo on the CPU
# (tests/test_torch_process_group.py).
DIST_STRATEGIES = ("gather", "bucketed", "chunked")
DIST_ROUNDS = 5
# 17a's local solver: phase 8's 150 GD steps cut to 50 so that the script runs
# well inside its time limit (Table 4's claim holds at 50: 84.6 / 83.3 / 81.4 /
# 0.0 / 81.2 % on the CPU, against 84.3 / 83.0 / 81.6 / 0.0 / 81.0 % at 150)
DIST_GD_STEPS = 50
# one_round_distributed vs one_round (map vs vmap solvers), the largest absolute
# difference; read at 9.9e-8 on an H100 80GB HBM3 at 700 W
DIST_ONE_ROUND_TOL = 1e-6
# a tau = 1 round vs local_update_gd's from the same iterate, of each leaf's max |w|;
# read at 2.0e-7 and 1.4e-7 (median, trimmed mean) on an H100 80GB HBM3 at 700 W
DIST_TAU1_TOL = 2e-6
PG_N = 1 << 20  # phase 17d's in-process leaf, (1, 2^20) f32
SERVE_CI_ARGS = ["--smoke", "--arch", "llama3_2_3b", "--mesh", "debug", "--workers", "2",
                 "--model-par", "1", "--requests", "24", "--alpha", "0.25", "--attack",
                 "feedback_flip"]
PG_TRAIN_ARGS = ["--config", "llama3.2-3b", "--smoke", "--steps", "4", "--seq-len", "32",
                 "--global-batch", "4", "--strategy", "gather", "--agg", "median"]


def _launches():
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg

    return {**robust_agg.LAUNCHES, **H.LAUNCHES}


def _reset_launches():
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg

    robust_agg.reset_launches()
    H.reset_launches()


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def distributed_one_round(dev):
    """Phase 17a: one_round_distributed at phase 8's configuration (logistic
    regression d = 784 x 10, m = 10, n = 500, lr 0.5) with DIST_GD_STEPS GD steps, on
    make_debug_mesh(10, 1): the median on the clean and the random_label
    alpha 0.1 shards and under the sign_flip alpha 0.1 scale 15 weight
    attack, by gather, bucketed and chunked, and the three mean rows by
    gather.  Counters zeroed before each call and read after it: gather and
    bucketed one B1 launch a call, chunked none and B4 / B5 once a leaf.
    gather and bucketed bitwise equal; both within DIST_ONE_ROUND_TOL of
    phase 8's one_round; chunked within one bin of the exact median of the
    rows it sketched; Table 4's claim_holds on the gather rows.  Returns
    the launches of every call."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig, make_classification_shards
    from repro_torch.data.synthetic import mnist_analog
    from repro_torch.kernels import selection_network as SN
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.paper_models import init_logreg, logreg_accuracy, logreg_loss
    from repro_torch.rounds import (OneRoundConfig, make_gd_local_solver, one_round,
                                    one_round_distributed)

    cfg = DataConfig(global_batch=T4_M * T4_N, num_workers=T4_M, seed=0)
    clean = make_classification_shards(cfg, None, device=dev)
    attacked = make_classification_shards(cfg, AttackConfig("random_label", alpha=0.1),
                                          device=dev)
    test = mnist_analog(torch.Generator().manual_seed(1234), 2000, device=dev)
    solver = make_gd_local_solver(logreg_loss, init_logreg(device=dev), steps=DIST_GD_STEPS,
                                  lr=0.5)
    atk_w = AttackConfig("sign_flip", alpha=0.1, scale=15.0)
    mesh = make_debug_mesh(T4_M, 1, device=dev)
    rows = {"clean": (clean, None, "median"), "attacked": (attacked, None, "median"),
            "weights_attacked": (clean, atk_w, "median")}
    total, got, secs, per_call = {}, {}, {}, {}
    runs = [(f"median_{row}", strat, *rows[row]) for row in rows for strat in DIST_STRATEGIES]
    runs += [(f"mean_{row}", "gather", shards, atk, "mean")
             for row, (shards, atk, _) in rows.items()]
    for name, strat, shards, atk, method in runs:
        torch.cuda.synchronize()
        _reset_launches()  # zeroed just before the call
        t0 = time.perf_counter()
        w = one_round_distributed(solver, shards, mesh, OneRoundConfig(method), strategy=strat,
                                  attack=atk)
        torch.cuda.synchronize()
        secs[f"{name}/{strat}"] = time.perf_counter() - t0
        counts = _launches()  # read just after it
        _add(total, counts)
        per_call[f"{name}/{strat}"] = {k: v for k, v in counts.items() if v}
        got[(name, strat)] = w
        check(all(bool(torch.isfinite(v).all()) for v in w.values()),
              f"17a: {name} {strat}: not finite")
        if method == "mean":
            want = {}
        elif strat == "chunked":
            want = {"minmax": 2, "histogram": 2}  # one a leaf: both leaves under 2^20
        else:
            want = {"median": 1}  # both leaves in one launch
        check({k: v for k, v in counts.items() if v} == want,
              f"17a: {name} {strat}: launches {counts}, want {want}")
    acc = {name: float(logreg_accuracy(got[(name, "gather")], test))
           for name in [r[0] for r in runs if r[1] == "gather"]}
    ok = (acc["mean_clean"] - acc["mean_attacked"] > 0.01
          and acc["median_weights_attacked"] - acc["mean_weights_attacked"] > 0.2
          and acc["median_attacked"] > acc["mean_attacked"] - 0.03)
    worst = {"vs_one_round": 0.0, "chunked_over_bin": 0.0}
    for row, (shards, atk, _) in rows.items():
        name = f"median_{row}"
        g, b, c = (got[(name, s)] for s in DIST_STRATEGIES)
        check(all(compare(g[k], b[k])[0] == 0 for k in g),
              f"17a: {name}: gather and bucketed differ")
        ref = one_round(solver, shards, OneRoundConfig("median"), attack=atk)
        err = max(float((g[k] - ref[k]).abs().max()) for k in g)
        worst["vs_one_round"] = max(worst["vs_one_round"], err)
        check(err <= DIST_ONE_ROUND_TOL, f"17a: {name}: {err} from one_round")
        # the rows the sketch saw: every worker's solution (vmapped: within the
        # last bits of the mapped ones), the Byzantine workers' replaced by their
        # payloads as the chunked strategy makes them
        sols = torch.func.vmap(solver)(shards)
        for k in g:
            flat = sols[k].reshape(T4_M, -1).float()
            flat = D._maybe_attack_chunked(mesh.axes, flat, atk, ("data",), T4_M)
            width = (flat.amax(0) - flat.amin(0)) / 256
            over = float(((c[k].reshape(-1) - SN.median_select(flat)).abs() - width).max())
            worst["chunked_over_bin"] = max(worst["chunked_over_bin"], over)
            check(over <= 1e-6, f"17a: {name} chunked {k}: {over} beyond one bin")
    line = {"distributed_one_round": {k: round(v * 100, 2) for k, v in acc.items()},
            "claim_holds": ok, "max_gather_vs_one_round": worst["vs_one_round"],
            "chunked_max_beyond_one_bin": worst["chunked_over_bin"], "seconds": secs,
            "launches_per_call": per_call}
    print(json.dumps(line))
    check(ok, f"17a: Table 4's claim does not hold on the gather rows: {acc}")
    return total


def distributed_local_update(dev, card: str):
    """Phase 17b: make_local_update_round on phase 10's CNN (m = 10, sign_flip
    alpha 0.1 scale 20): gather, bucketed and chunked x median and trimmed
    mean beta 0.1 x tau in {1, 5}, 5 rounds each, on make_debug_mesh(10, 1).
    Counters zeroed before each round and read after it: gather and bucketed
    one B1 (B2) launch a round at either tau, chunked no B1/B2 and one B4
    and one B5 launch a leaf a round at either tau.  tau = 1 gather against
    local_update_gd (deterministic cuDNN), each round from the same iterate:
    bitwise reported, held within DIST_TAU1_TOL of each leaf's scale (the
    workers' gradients are taken one by one here, in one vmap there, and
    differ in the last bits); the drift of the two 5-round trajectories is
    reported, not held (ReLU kinks amplify last-bit differences from round
    to round: ~1e-2 of the smallest leaf's scale after 5 rounds in a CPU
    rehearsal).  The loss falls at tau = 5; the steady-state round ms at
    tau = 5 and a profile of one gather-median round (after the path's
    counts were read).  Returns the launches."""
    import torch

    from repro_torch.core.attacks import AttackConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.paper_models import cnn_loss
    from repro_torch.rounds import LocalUpdateConfig, local_update_gd, make_local_update_round

    shards, params = cnn_setup(dev)
    pooled = {"x": shards["x"].reshape(-1, 784), "y": shards["y"].reshape(-1)}
    attack = AttackConfig(**CNN_ATTACK)
    loss0 = float(cnn_loss(params, pooled))
    mesh = make_debug_mesh(10, 1, device=dev)
    total, per_round, round_ms, losses, tau1, steps = {}, {}, {}, {}, {}, {}
    for strat in DIST_STRATEGIES:
        for method in ("median", "trimmed_mean"):
            for tau in (1, 5):
                cfg = LocalUpdateConfig(method=method, beta=0.1, step_size=0.05, tau=tau,
                                        num_rounds=DIST_ROUNDS)
                step = make_local_update_round(cnn_loss, cfg, mesh, strategy=strat,
                                               attack=attack)
                deterministic = tau == 1 and strat == "gather"
                one = dataclasses.replace(cfg, num_rounds=1)
                torch.backends.cudnn.deterministic = deterministic
                try:
                    w, counts, times, errs, bitwise = params, [], [], [], True
                    for r in range(DIST_ROUNDS):
                        torch.cuda.synchronize()
                        _reset_launches()  # zeroed just before the round
                        t0 = time.perf_counter()
                        w_new = step(w, shards, r)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                        counts.append({k: v for k, v in _launches().items() if v})
                        _add(total, counts[-1])
                        if deterministic:  # local_update_gd's round from the same iterate
                            w_lu, _ = local_update_gd(cnn_loss, w, shards, one, attack)
                            bitwise &= all(torch.equal(w_new[k], w_lu[k]) for k in params)
                            errs.append(max(float((w_new[k] - w_lu[k]).abs().max()
                                                  / w_lu[k].abs().max()) for k in params))
                        w = w_new
                    if deterministic:  # and its 5 rounds from the same start
                        w_lu, _ = local_update_gd(cnn_loss, params, shards, cfg, attack)
                        torch.cuda.synchronize()
                finally:
                    torch.backends.cudnn.deterministic = False
                key = f"{strat}/{method}/tau{tau}"
                per_round[key] = counts[0]
                check(all(c == counts[0] for c in counts), f"17b: {key}: launches vary: {counts}")
                if strat == "chunked":
                    want = {"minmax": CNN_LEAVES, "histogram": CNN_LEAVES}
                else:
                    want = {method: 1}
                check(counts[0] == want, f"17b: {key}: {counts[0]} a round, want {want}")
                loss = float(cnn_loss(w, pooled))
                losses[key] = loss
                check(loss == loss and abs(loss) != float("inf"), f"17b: {key}: loss not finite")
                if tau == 5:
                    check(loss < loss0, f"17b: {key}: loss did not fall ({loss0} -> {loss})")
                    round_ms[f"{strat}/{method}"] = sum(times[1:]) / (DIST_ROUNDS - 1) * 1e3
                    steps[f"{strat}/{method}"] = step
                if deterministic:
                    drift = max(float((w[k] - w_lu[k]).abs().max() / w_lu[k].abs().max())
                                for k in params)
                    tau1[method] = {"rounds_bitwise": bitwise, "round_max_rel_err": max(errs),
                                    "five_rounds_max_rel_err": drift}
                    check(max(errs) <= DIST_TAU1_TOL, f"17b: {method} tau=1: a round is "
                                                      f"{max(errs)} of the leaf scale from "
                                                      f"local_update_gd's")
    for strat in DIST_STRATEGIES:
        for method in ("median", "trimmed_mean"):
            a, b = (per_round[f"{strat}/{method}/tau{t}"] for t in (1, 5))
            check(a == b, f"17b: {strat} {method}: launches a round {a} at tau=1, {b} at tau=5")
    print(json.dumps({"distributed_local_update": {"loss0": loss0, "loss_after_5": losses},
                      "tau1_vs_local_update_gd": tau1, "launches_per_round": per_round}))
    print(json.dumps({"distributed_local_update_round_ms_tau5": round_ms, "card": card}))
    prof = profile_summary(lambda: steps["gather/median"](params, shards, 0),
                           round_ms["gather/median"])
    print(json.dumps({"profile_distributed_local_update_round_tau5": "gather/median",
                      "card": card, **prof}))
    return total


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def distributed_clis():
    """Phases 17c and 17d's CLI half, four processes started together on the
    card: the serve CLI twice with the reference's CI smoke flags (one
    sha256), and the train CLI with --mesh single (NCCL, world size 1) and
    --mesh debug --workers 1 (the same loss lines and params, bitwise).
    Returns the lines to print."""
    import os

    import numpy as np

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    pg_env = dict(env, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                  MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    ckpt = ROOT / "build" / "chip_smoke_17d"
    jobs = [("serve", env, ["-m", "repro_torch.serve.run"] + SERVE_CI_ARGS)] * 2
    for mesh, e, extra in (("single", pg_env, ["--mesh", "single"]),
                           ("debug", env, ["--mesh", "debug", "--workers", "1"])):
        jobs.append((mesh, e, ["-m", "repro_torch.launch.train"] + PG_TRAIN_ARGS + extra
                     + ["--ckpt", str(ckpt / mesh)]))
    procs = []
    try:
        for name, e, args in jobs:
            procs.append((name, subprocess.Popen([sys.executable] + args, env=e, cwd=ROOT,
                                                 text=True, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE)))
        outs = []
        for name, proc in procs:
            out, err = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"17c/d: {name} CLI exited {proc.returncode}: "
                                        f"{err[-2000:]}")
            outs.append((name, out))
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    digests = []
    for name, out in outs[:2]:
        check("mesh debug workers=2 model_par=1; device cuda" in out and
              "served 24/24 requests" in out, f"17c: serve CLI: {out[-2000:]}")
        digests += [ln for ln in out.splitlines() if ln.startswith("final iterate sha256")]
    check(len(digests) == 2 and digests[0] == digests[1],
          f"17c: the serve CLI with the reference's CI flags printed {digests}")
    lines_out = [f"phase 17c: serve CLI with the reference's CI smoke flags (--mesh debug "
                 f"--workers 2 --model-par 1) twice on the card: one sha256 "
                 f"{digests[0].split('=')[-1][:16]}"]
    lines = {name: [ln for ln in out.splitlines() if ln.startswith("step ")]
             for name, out in outs[2:]}
    single = dict(outs[2:])["single"]
    check("mesh={'data': 1, 'model': 1} workers=1" in single and "device cuda" in single,
          f"17d: train CLI --mesh single: {single[-2000:]}")
    check(len(lines["single"]) == 4 and lines["single"] == lines["debug"],
          f"17d: loss lines --mesh single {lines['single']} vs debug {lines['debug']}")
    files = sorted(p.name for p in (ckpt / "single").glob("*.npy"))
    check(files and files == sorted(p.name for p in (ckpt / "debug").glob("*.npy")),
          f"17d: checkpoints differ in their leaves: {files}")
    same = all(np.load(ckpt / "single" / f).tobytes() == np.load(ckpt / "debug" / f).tobytes()
               for f in files)
    check(same, "17d: --mesh single's params are not bitwise --mesh debug --workers 1's")
    return lines_out + [f"phase 17d: train CLI --mesh single under NCCL at world size 1: its 4 "
                        f"loss lines and {len(files)} param leaves bitwise --mesh debug "
                        f"--workers 1's ({lines['single'][-1]})"]


def process_group_strategies(dev):
    """Phase 17d's in-process half: a NCCL process group of world size 1 in
    this process (file:// rendezvous under build/), ProcessGroupAxes({"data":
    1}) against InProcessAxes({"data": 1}) on a (1, 2^20) f32 leaf: gather,
    bucketed and chunked median bitwise, the collectives named in
    ``calls``.  Counters zeroed before the process group's calls and read
    after them: B4 and B5 once (chunked); no B1, since the median of one
    row takes the aggregators' sort path.  Returns them."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.rounds import aggregate_by_strategy

    rdv = ROOT / "build" / f"chip_smoke_pg_{os.getpid()}"
    rdv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1,
                            device_id=dev)
    try:
        ax = D.ProcessGroupAxes({"data": 1}, dev)
        ref = D.InProcessAxes({"data": 1}, dev)
        row = torch.from_numpy(np.random.default_rng(17).standard_normal((1, PG_N))
                               .astype(np.float32)).to(dev)
        torch.cuda.synchronize()
        _reset_launches()  # zeroed just before the process group's calls
        got = {s: aggregate_by_strategy({"w": row[0]}, ax, ("data",), s, "median")["w"]
               for s in DIST_STRATEGIES}
        torch.cuda.synchronize()
        counts = _launches()  # read just after them
        for s in DIST_STRATEGIES:
            want = aggregate_by_strategy({"w": row}, ref, ("data",), s, "median")["w"]
            bad, err = compare(got[s], want)
            check(bad == 0, f"17d: {s} under the process group: {bad} mismatches ({err})")
        check(dict(ax.calls) == dict(ref.calls), f"17d: calls {dict(ax.calls)} vs "
                                                 f"{dict(ref.calls)}")
        # the median of one row takes the aggregators' sort path (m < 2), as in
        # the reference: B1 does not launch at world size 1; the sketch does
        check({k: v for k, v in counts.items() if v} == {"minmax": 1, "histogram": 1},
              f"17d: launches {counts}")
    finally:
        dist.destroy_process_group()
        rdv.unlink(missing_ok=True)
    print(f"phase 17d: ProcessGroupAxes (NCCL, world size 1) on a (1, {PG_N}) f32 leaf: "
          f"gather, bucketed and chunked medians bitwise InProcessAxes({{'data': 1}}); "
          f"collectives {json.dumps(dict(ax.calls))}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    print("phase 17d: 4 ranks on one card: NCCL refuses two ranks on one GPU (\"Duplicate GPU "
          "detected\"); 4-rank runs are held on gloo on the CPU "
          "(tests/test_torch_process_group.py, tier-1)")
    return counts


def distributed(dev, card: str, on_path):
    """Phase 17: 17a, 17b and 17d in process (17c and 17d's CLIs run in the
    CLI batch); returns the launches of 17a's, 17b's and 17d's
    paths."""
    t0 = time.perf_counter()
    one = on_path("phase 17a", lambda: distributed_one_round(dev), lambda c: c)
    print(f"phase 17a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    local = on_path("phase 17b", lambda: distributed_local_update(dev, card), lambda c: c)
    print(f"phase 17b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pg = on_path("phase 17d", lambda: process_group_strategies(dev), lambda c: c)
    print(f"phase 17d in-process: {time.perf_counter() - t0:.1f} s")
    return {"distributed_one_round": one, "distributed_local_update": local,
            "process_group": pg}


# ------------- phase 18: the audio and vision frontends, encoder, cross-attention
#
# (a) whisper-smoke and internvl2-smoke in f32, card against CPU; (b)
# whisper-small and internvl2-1b at full width AND depth in bf16, trained
# with 4 in-process workers (gather median and gather trimmed mean beta 0.25
# under alie alpha 0.25); (c) the cache paths at full width in f32 against
# the teacher-forced forward (tests/test_models_smoke.py's consistency check
# at its 2e-3); (d) the train CLI for both.
FRONTEND_ARCHS = ("whisper-small", "internvl2-1b")
FRONTEND_TOL = 1e-5  # card vs CPU at smoke width in f32 (TF32 off)
FRONTEND_CACHE_TOL = 2e-3  # tests/test_models_smoke.py's prefill/decode tolerance
FRONTEND_CELLS = (("whisper-small", 419_460_096, 31), ("internvl2-1b", 629_636_224, 12))
FRONTEND_STEPS, FRONTEND_DS = 4, 2  # 8 in windows of 4 before the script was cut
# (aggregator, attack), gather strategy: the two robust runs under alie alpha
# 0.25, then a clean control run (at m = 4 alie stalls internvl2-1b's loss)
FRONTEND_RUNS = (("median", "alie"), ("trimmed_mean", "alie"), ("median", "none"))
# the clean run's steps and window (its loss must fall from the first window
# to the second): 8 in windows of 4 before phase 22 took its time
FRONTEND_CLEAN_STEPS, FRONTEND_CLEAN_DS = 4, 2
CROSS_FFN = ("ln2", "wd", "wg", "wu")  # cross-block leaves no computation reads


def flat_tree(tree, prefix=""):
    """{path: tensor} of a params or gradient tree; per-layer tuples (the
    trainer's pieces) stacked back."""
    import torch

    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(flat_tree(v, path))
        else:
            out[path] = torch.stack(v) if isinstance(v, tuple) else v
    return out


def cross_ffn_leaves(cfg):
    """Indices, in the parameter tree's leaf order, of the cross blocks' FFN
    leaves, and their coordinates."""
    import math

    from repro_torch.models import transformer as T

    specs = T._param_specs(cfg)
    paths = list(flat_tree(T._map_specs(lambda path, spec: path, specs)).values())
    idx = [i for i, p in enumerate(paths)
           if p.startswith("cross_blocks/") and p.split("/")[-1] in CROSS_FFN]
    return idx, sum(math.prod(specs["cross_blocks"][paths[i].split("/")[-1]].shape)
                    for i in idx)


def frontend_parity(dev):
    """Phase 18a: each smoke config in f32 from one set of params and one
    frontend, card against CPU: forward logits, loss and every gradient leaf
    (the trainer's per-layer pieces; kv_block 16, the encoder's and the
    cross-attention's frames on the chunked path), the cross FFN gradients
    exactly 0 on both; whisper's prefill and 4 decode steps; internvl2's
    prefill, and its decode raising on both devices.  Then one m = 4 window
    (gather median under alie alpha 0.25, SGD 0.5) on the card: one B1
    launch, bitwise its plain version.  Returns the windows' launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_map

    worst_all, total = 0.0, {}
    for arch in FRONTEND_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        cpu_params = T.init_params(cfg, seed=0, device="cpu")
        r = np.random.default_rng(18)
        tok = torch.from_numpy(r.integers(0, cfg.vocab, (2, 12)).astype(np.int64))
        lab = torch.from_numpy(r.integers(0, cfg.vocab, (2, 12)).astype(np.int64))
        fe = torch.from_numpy(r.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model))
                              .astype(np.float32))
        out = {}
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            params = tree_map(lambda t: t.to(d), cpu_params)
            batch = {"tokens": tok.to(d), "labels": lab.to(d), "frontend": fe.to(d)}
            logits, _ = T.forward(params, batch["tokens"], cfg, frontend=batch["frontend"],
                                  kv_block=16)
            loss, grads = steps._value_and_grad(cfg, 16)(steps._pieces(params), batch)
            res = {"logits": logits, "loss": loss,
                   **{f"grad/{p}": g for p, g in flat_tree(grads).items()}}
            with torch.no_grad():
                pl, cache = T.prefill(params, batch["tokens"][:, :8], cfg,
                                      frontend=batch["frontend"], kv_block=16, cache_len=12)
                res["prefill"] = pl
                if cfg.frontend == "audio":
                    for i in range(4):
                        res[f"decode{i}"], cache = T.decode_step(
                            params, batch["tokens"][:, 8 + i:9 + i], cache, 8 + i, cfg)
                else:
                    try:
                        T.decode_step(params, batch["tokens"][:, 8:9], cache, 8, cfg)
                        raised = False
                    except ValueError:
                        raised = True
                    check(raised, f"18a {arch}: decode on a vision prefill's cache did not "
                                  f"raise on {name}")
            out[name] = {k: v.detach().cpu() for k, v in res.items()}
            if cfg.frontend == "audio":
                for leaf in CROSS_FFN:
                    check(not bool(out[name][f"grad/cross_blocks/{leaf}"].any()),
                          f"18a {arch}: cross_blocks/{leaf} gradient not 0 on {name}")
        check(set(out["card"]) == set(out["cpu"]), f"18a {arch}: output trees differ")
        worst = max(float((out["card"][k] - out["cpu"][k]).abs().max()) for k in out["cpu"])
        check(worst <= FRONTEND_TOL, f"18a {arch}: card vs CPU {worst} > {FRONTEND_TOL}")
        worst_all = max(worst_all, worst)
        # one m = 4 window on the card: its B1 launch held bitwise
        mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, device=dev)
        pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=TRAIN_BETA,
                              remat=False)
        opt = get_optimizer("sgd", 0.5)
        state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
        atk = AttackConfig("alie", TRAIN_ALPHA)
        block = trainer.stack_window_batches(DataConfig(**(TRAIN_TINY_DATA | {
            "vocab": cfg.vocab})), 0, 1, mesh, atk, cfg)
        undo = sync_free_windows()
        try:
            window = trainer.make_window_step(cfg, pcfg, mesh, opt, atk, 1)
            robust_agg.reset_launches()
            H.reset_launches()
            with HeldAggregation(dev) as held:
                state = window(state, block)
            torch.cuda.synchronize()
            launches = {**robust_agg.LAUNCHES, **H.LAUNCHES}
        finally:
            undo()
        want = {k: int(k == "median") for k in launches}
        check(launches == want and held.held == 1,
              f"18a {arch}: window launches {launches}, {held.held} held")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        check(bool(torch.isfinite(state["metrics"]["loss_sum"])), f"18a {arch}: window loss")
    print(f"phase 18a: whisper-smoke and internvl2-smoke f32, card vs CPU: forward, loss, every "
          f"gradient leaf, prefill and decode within {worst_all:.3g} (tolerance "
          f"{FRONTEND_TOL}); cross FFN gradients exactly 0 on both; decode after the vision "
          f"prefill raises on both; one m = 4 window each: one B1 launch, bitwise its plain "
          f"version")
    return total


def frontend_cell(dev, card: str, arch: str, d_want: int, n_leaves: int, firsts=None):
    """Phase 18b, one cell: ``arch`` at full width and depth in bf16 from
    seed 0, trained through ``trainer.train_loop`` with 4 in-process
    workers, FRONTEND_STEPS steps in windows of FRONTEND_DS, AdamW 1e-4,
    global batch 8, seq 128, FRONTEND_RUNS (gather median and gather
    trimmed mean beta 0.25 under alie alpha 0.25, then the median without
    an attack for FRONTEND_CLEAN_STEPS steps in windows of
    FRONTEND_CLEAN_DS); every window under the sync-debug "error" mode.
    ``firsts`` (a dict) gets each run's first-window loss under (arch,
    method, attack), the model-1 losses phase 22c holds its own to.  Holds:
    one B1 (B2) launch a step over all ``n_leaves`` leaves and no other
    kernel; the last window's aggregates bitwise their plain versions
    (column slices); the cross FFN coordinates of every aggregate exactly
    0; the loss finite, and falling in the clean run (under alie it is
    reported: alie may stall it).  The alie median run's step split and
    profile; B1 and B2 timed on its last rows.  Returns the launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer

    total_mem = torch.cuda.get_device_properties(0).total_memory
    total = {"median": 0, "trimmed_mean": 0}
    cfg = get_config(arch)
    check(T.count_params(cfg) == d_want, f"18b {arch}: {T.count_params(cfg)} parameters")
    cross_idx, cross_n = cross_ffn_leaves(cfg)
    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    undo = sync_free_windows()
    try:
        for method, attack in FRONTEND_RUNS:
            run = f"{arch} gather/{method}/{attack}"
            n_steps, ds = ((FRONTEND_CLEAN_STEPS, FRONTEND_CLEAN_DS) if attack == "none" else
                           (FRONTEND_STEPS, FRONTEND_DS))
            tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=n_steps, device_steps=ds)
            pcfg = ParallelConfig(agg_method=method, agg_strategy="gather", agg_beta=TRAIN_BETA,
                                  remat=False, attn_chunk=0)  # 22c compares with these runs
            atk = AttackConfig(attack, TRAIN_ALPHA if attack != "none" else 0.0)
            nonzero = []  # device counts of nonzero cross FFN coordinates, a step each
            first_held = n_steps - ds
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            robust_agg.reset_launches()  # zeroed just before this run
            H.reset_launches()
            t0 = time.perf_counter()
            with HeldAggregation(dev, hold=lambda c: c >= first_held,
                                 keep=lambda c: c == n_steps - 1) as held:
                unhook = count_nonzero_aggregates(cross_idx, nonzero)
                try:
                    result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk)
                finally:
                    unhook()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {**robust_agg.LAUNCHES, **H.LAUNCHES}  # read just after it
            leaves = dict(robust_agg.LEAVES)
            peak = torch.cuda.max_memory_allocated()
            want = {k: 0 for k in launches}
            want[method] = n_steps  # every leaf in one launch a step
            check(launches == want, f"18b {run}: launches {launches}, want {want}")
            check(leaves[method] == n_steps * n_leaves,
                  f"18b {run}: leaves {leaves}, want {n_steps * n_leaves}")
            check(held.held == ds, f"18b {run}: {held.held} of the last window's "
                                   f"{ds} aggregates held")
            nz = [int(v) for v in nonzero]
            check(len(nz) == n_steps and not any(nz),
                  f"18b {run}: nonzero cross FFN coordinates in the aggregates: {nz}")
            for k in total:
                total[k] += launches[k]
            hist = result.history
            losses = [h["loss"] for h in hist]
            check(all(v == v and abs(v) < 1e4 for v in losses), f"18b {run}: {losses}")
            if attack == "none":
                check(losses[-1] < losses[0], f"18b {run}: the loss did not fall: {losses}")
            if firsts is not None:
                firsts[(arch, method, attack)] = losses[0]
            line = {"frontend_run": run, "d": d_want, "leaves": n_leaves,
                    "cross_ffn_coordinates": cross_n, "steps": n_steps,
                    "device_steps": ds, "workers": TRAIN_WORKERS,
                    "tokens_per_step": dcfg.global_batch * dcfg.seq_len,
                    "frontend_tokens": cfg.n_frontend_tokens,
                    "steps_per_s": result.steps_per_s, "tokens_per_s": result.tokens_per_s,
                    "first_window_s": result.compile_s, "window_times_s": result.window_times_s,
                    "run_wall_s": wall, "losses": losses, "loss_falls": losses[-1] < losses[0],
                    "grad_norm_last_window": hist[-1]["grad_norm"], "launches": launches,
                    "leaves_aggregated": leaves, "max_memory_allocated_gb": peak / 1e9,
                    "card_memory_gb": total_mem / 1e9, "card": card}
            text = ""
            if (method, attack) == ("median", "alie"):  # the step's split and profile
                batch = {k: v[0] for k, v in trainer.stack_window_batches(
                    dcfg, FRONTEND_STEPS, 1, mesh, atk, cfg).items()}
                split = train_step_split(cfg, pcfg, mesh, atk, result.state, batch,
                                         FRONTEND_STEPS)
                sb = steps.make_step_body(cfg, pcfg, mesh, get_optimizer("adamw", TRAIN_LR),
                                          atk)
                prof = profile_summary(lambda: sb.body(result.state["params"],
                                                       result.state["opt_state"], batch,
                                                       FRONTEND_STEPS, 0),
                                       split["step_ms"], top=10, names=("leaf_select_kernel",))
                line.update(split_ms=split, device_busy_share=prof["device_busy_share"])
                print(json.dumps({"profile_frontend_step": run, **prof}))
                text = (f", step {split['step_ms']:.1f} ms (grads "
                        f"{split['worker_grads_ms']:.1f}, attack {split['attack_ms']:.1f}, "
                        f"B1/B2 {split['b1_b2_ms']:.1f}, update {split['update_ms']:.1f}), busy "
                        f"{prof['device_busy_share']:.3f}")
                del sb, batch
            print(json.dumps({"frontend_train": line}))
            print(f"phase 18b: {run}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
                  f"{result.steps_per_s:.3f} steps/s, {result.tokens_per_s:.0f} tokens/s"
                  f"{text}, peak {peak / 1e9:.2f} GB")
            check(peak < total_mem, f"18b {run}: peak {peak} >= the card's {total_mem}")
            kept = held.kept
            del result, held
            torch.cuda.empty_cache()
            if (method, attack) == ("median", "alie"):
                train_kernel_timings(kept, card, f"{arch} train grads")
            del kept
            torch.cuda.empty_cache()
    finally:
        undo()
    return total


def count_nonzero_aggregates(idx, nonzero):
    """Inside the window: after every aggregation call with the leaves of a
    parameter tree, the count of nonzero coordinates of the outputs at leaf
    indices ``idx`` appended to ``nonzero`` as a device scalar (read after
    the run: no sync in the window).  Returns the undo."""
    from repro_torch.core import aggregators

    real = aggregators.aggregate_leaves

    def wrapped(leaves, method, beta=0.1):
        outs = real(leaves, method, beta)
        nonzero.append(sum((outs[i] != 0).sum() for i in idx))
        return outs

    aggregators.aggregate_leaves = wrapped
    return lambda: setattr(aggregators, "aggregate_leaves", real)


def frontend_caches(dev):
    """Phase 18c: the cache paths at full width in f32 (params from seed 0,
    one frontend), tests/test_models_smoke.py's consistency check at its
    2e-3: whisper-small (24 layers and 12 cross blocks, 1500 frames, the
    default kv_block 1024: the chunked path), 4 prompts of 16 tokens with
    cache_len 32: the prefill's last logits equal forward's at position 15,
    and 16 decode steps with the true next tokens equal the teacher-forced
    logits; internvl2-1b: forward returns (B, S, V) with the 256-patch prefix
    stripped, the prefill's last logits equal forward's last, and decode on
    that cache raises."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    report = {}
    for arch in FRONTEND_ARCHS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        params = T.init_params(cfg, seed=0, device=dev)
        r = np.random.default_rng(1818)
        toks = torch.from_numpy(r.integers(0, cfg.vocab, (4, 32)).astype(np.int64)).to(dev)
        fe = torch.from_numpy(r.standard_normal((4, cfg.n_frontend_tokens, cfg.d_model))
                              .astype(np.float32)).to(dev)
        with torch.no_grad():
            if cfg.frontend == "audio":
                full, _ = T.forward(params, toks, cfg, frontend=fe)
                pl, cache = T.prefill(params, toks[:, :16], cfg, frontend=fe, cache_len=32)
                want = (cfg.n_layers, 4, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.hd)
                check(tuple(cache["cross"]["k"].shape) == want,
                      f"18c {arch}: cross cache {tuple(cache['cross']['k'].shape)}, want {want}")
                errs = [float((pl[:, 0] - full[:, 15]).abs().max())]
                for i in range(16, 32):
                    lg, cache = T.decode_step(params, toks[:, i:i + 1], cache, i, cfg)
                    errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
                check(all(np.isfinite(errs)) and max(errs) <= FRONTEND_CACHE_TOL,
                      f"18c {arch}: prefill / decode vs forward {errs}")
                report[arch] = {"prefill_err": errs[0], "decode_max_err": max(errs[1:]),
                                "steps": 16}
            else:
                full, _ = T.forward(params, toks[:, :16], cfg, frontend=fe)
                check(tuple(full.shape) == (4, 16, cfg.vocab), f"18c {arch}: {full.shape}")
                pl, cache = T.prefill(params, toks[:, :16], cfg, frontend=fe, cache_len=32)
                err = float((pl[:, 0] - full[:, -1]).abs().max())
                check(np.isfinite(err) and err <= FRONTEND_CACHE_TOL,
                      f"18c {arch}: prefill vs forward {err}")
                try:
                    T.decode_step(params, toks[:, 16:17], cache, 16, cfg)
                    raised = False
                except ValueError:
                    raised = True
                check(raised, f"18c {arch}: decode on the vision prefill's cache did not raise")
                report[arch] = {"prefill_err": err, "decode": "raises (reference property)"}
        del params, cache, full
        torch.cuda.empty_cache()
    print(json.dumps({"frontend_caches": report, "tolerance": FRONTEND_CACHE_TOL}))
    print(f"phase 18c: whisper-small prefill + 16 decode steps within "
          f"{report['whisper-small']['decode_max_err']:.3g} of forward, internvl2-1b prefill "
          f"within {report['internvl2-1b']['prefill_err']:.3g} (tolerance "
          f"{FRONTEND_CACHE_TOL}); decode after the vision prefill raises")


def frontends(dev, card: str, on_path, firsts=None):
    """Phase 18: 18a-18d, each training path under ``on_path``; returns the
    launches of 18a's windows, 18b's cells and 18d's CLI runs (18b's
    first-window losses into ``firsts``)."""
    t0 = time.perf_counter()
    out = {"frontends_windows": on_path("phase 18a", lambda: frontend_parity(dev),
                                        lambda c: c)}
    print(f"phase 18a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cells = {}
    for arch, d, n_leaves in FRONTEND_CELLS:
        t1 = time.perf_counter()
        for k, v in on_path(f"phase 18b {arch}",
                            lambda: frontend_cell(dev, card, arch, d, n_leaves, firsts),
                            lambda c: c).items():
            cells[k] = cells.get(k, 0) + v
        print(f"phase 18b: {arch}: {time.perf_counter() - t1:.1f} s")
    out["frontends_train"] = cells
    print(f"phase 18b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    frontend_caches(dev)
    print(f"phase 18c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["frontends_train_cli"] = on_path(
        "phase 18d", lambda: train_cli_counted(FRONTEND_ARCHS, "18d", one_launch=True),
        lambda c: c)
    print(f"phase 18d: {time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------ phase 19: FSDP, the robust reduce-scatter
#
# (a) 15a's tiny llama in f32 with param_mode='fsdp' over 4 in-process
# workers, card against CPU and against the card's replicated gather; (b)
# 15b's cell (llama3.2-3b's widths at 8 of 28 layers, D = 1,593,363,456 bf16,
# m = 4, batch 8, seq 128, AdamW 1e-4) for 2 steps in one window, each fsdp
# run beside the same run replicated; (c) the process group at world size 1
# under NCCL against InProcessAxes({"data": 1}); (d) the per-rank bytes of
# llama3.2-3b at all 28 layers over 4 ranks, from the shapes.
FSDP_TINY_STEPS = 3
# 8 in windows of 4 before the script was cut, 4 in windows of 2 before phase 25
FSDP_STEPS, FSDP_DS = 2, 2
FSDP_METHODS = ("median", "trimmed_mean")  # gather, under alie alpha 0.25, beta 0.25
FSDP_RANKS = 4  # phase 19d's process group


def window_state(holder):
    """Patch ``trainer.make_window_step`` so that ``holder["state"]`` is the
    state each window returns (a reference: the window replaces its entries
    in place).  Returns the undo."""
    from repro_torch.launch import trainer

    real = trainer.make_window_step

    def make(*args, **kwargs):
        window = real(*args, **kwargs)

        def kept(state, batches):
            holder["state"] = window(state, batches)
            return holder["state"]

        return kept

    trainer.make_window_step = make
    return lambda: setattr(trainer, "make_window_step", real)


def fsdp_pieces(cfg, mesh) -> int:
    """The aggregation leaves of one fsdp step on the in-process mesh: each
    ``blocks`` leaf once a layer, every other sharded leaf once."""
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    n = 0
    for (path, d), leaf in zip(tree_leaves_with_path(steps.fsdp_dims(cfg, mesh)),
                               tree_leaves(T.meta_params(cfg))):
        if d >= 0:
            n += leaf.shape[0] if path.startswith("blocks/") else 1
    return n


def fsdp_parity(dev):
    """Phase 19a: the tiny llama in f32 (TF32 off) with param_mode='fsdp',
    4 in-process workers, FSDP_TINY_STEPS steps of SGD 0.5 under sign_flip
    alpha 0.25 (gather median) from one set of params on one batch block,
    on the card and on the CPU (within TRAIN_TINY_TOL), and the card's run
    bitwise the card's replicated run; no window waits for the card.  The
    counters are zeroed just before the card's fsdp run and read just
    after: one B1 launch a step over all the step's leaves.  Returns
    them."""
    import torch

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import robust_agg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves, tree_map

    cfg = train_tiny_cfg()
    atk = AttackConfig("sign_flip", TRAIN_ALPHA)
    cpu_params = T.init_params(cfg, seed=0, device="cpu")
    block = trainer.stack_window_batches(DataConfig(**TRAIN_TINY_DATA), 0, FSDP_TINY_STEPS,
                                         mesh_lib.make_debug_mesh(4, device="cpu"), atk, cfg)
    runs, counts = {}, None
    undo = sync_free_windows()
    try:
        for name, d, mode in (("card", dev, "fsdp"), ("cpu", torch.device("cpu"), "fsdp"),
                              ("card replicated", dev, "replicated")):
            pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", param_mode=mode,
                                  remat=False)
            mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, device=d)
            opt = get_optimizer("sgd", 0.5)
            state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
            state["params"] = tree_map(lambda t: t.to(d), cpu_params)
            window = trainer.make_window_step(cfg, pcfg, mesh, opt, atk, 1)
            losses = []
            if name == "card":
                torch.cuda.synchronize()
                _reset_launches()  # zeroed just before the card's fsdp run
            for i in range(FSDP_TINY_STEPS):
                before = float(state["metrics"]["loss_sum"])
                state = window(state, {k: v[i:i + 1].to(d) for k, v in block.items()})
                losses.append(float(state["metrics"]["loss_sum"]) - before)
            if name == "card":
                torch.cuda.synchronize()
                counts = _launches()  # read just after it
                leaves = robust_agg.LEAVES["median"]
            runs[name] = (losses, [t.cpu() for t in tree_leaves(state["params"])])
    finally:
        undo()
    pieces = fsdp_pieces(cfg, mesh_lib.make_debug_mesh(TRAIN_WORKERS, device="cpu"))
    want = {k: 0 for k in counts}
    want["median"] = FSDP_TINY_STEPS  # every leaf of a step in one launch
    check(counts == want and leaves == FSDP_TINY_STEPS * pieces,
          f"19a: launches {counts} ({leaves} leaves), want {want} ({FSDP_TINY_STEPS * pieces})")
    (lc, pc), (lx, px), (lr, pr) = runs["card"], runs["cpu"], runs["card replicated"]
    dl = max(abs(a - b) / abs(b) for a, b in zip(lc, lx))
    dp = max(float((a - b).abs().max()) for a, b in zip(pc, px))
    check(dl <= TRAIN_TINY_TOL and dp <= TRAIN_TINY_TOL,
          f"19a: card vs CPU losses {dl}, params {dp}")
    bad = sum(compare(a, b)[0] for a, b in zip(pc, pr))
    check(bad == 0 and lc == lr, f"19a: fsdp vs replicated on the card: {bad} param mismatches, "
                                 f"losses {lc} vs {lr}")
    print(f"phase 19a: tiny llama f32, fsdp gather median under sign_flip, {FSDP_TINY_STEPS} "
          f"steps: card vs CPU losses rel {dl:.3g}, params {dp:.3g} (tolerance "
          f"{TRAIN_TINY_TOL}); bitwise the card's replicated run; B1 {counts['median']} "
          f"launches over {leaves} leaves; no window waited for the card")
    return counts


def fsdp_run(dev, card: str, cfg, mode: str, method: str, snaps: list):
    """One of phase 19b's runs: ``trainer.train_loop`` with ``mode`` and
    gather ``method`` under alie alpha 0.25, FSDP_STEPS steps in windows of
    FSDP_DS, every window under the sync-debug "error" mode, the counters
    zeroed just before and read just after.  After each window (outside the
    timed window) the fsdp run copies its params to the host (``snaps``)
    and the replicated run compares its own with them, bitwise.  Returns
    {"launches", "line", "kept"} (kept: the last step's rows on the fsdp
    median run)."""
    import math

    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import robust_agg, select_codegen
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves

    run = f"{mode} gather/{method}/alie"
    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=FSDP_STEPS, device_steps=FSDP_DS)
    pcfg = ParallelConfig(agg_method=method, agg_strategy="gather", agg_beta=TRAIN_BETA,
                          param_mode=mode, remat=False, attn_chunk=0)  # 22d runs remat
    atk = AttackConfig("alie", TRAIN_ALPHA)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    holder, mismatches = {}, []

    def on_window(w, met):
        params = tree_leaves(holder["state"]["params"])
        if mode == "fsdp":
            snaps.append([t.cpu() for t in params])
        else:
            mismatches.append(sum(compare(t, s.to(dev))[0] for t, s in zip(params, snaps[w])))

    keep = mode == "fsdp" and method == "median"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # zeroed just before this run
    undo = [sync_free_windows(), window_state(holder)]
    t0 = time.perf_counter()
    try:
        with HeldAggregation(dev, hold=lambda c: c == FSDP_STEPS - 1,
                             keep=lambda c: keep and c == FSDP_STEPS - 1) as held:
            result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk,
                                        on_window=on_window)
    finally:
        for u in reversed(undo):
            u()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()  # read just after it
    leaves = dict(robust_agg.LEAVES)
    peak = torch.cuda.max_memory_allocated()
    pieces = fsdp_pieces(cfg, mesh) if mode == "fsdp" else len(tree_leaves(result.state["params"]))
    per_step = math.ceil(pieces / select_codegen.MAX_LEAVES)
    want = {k: 0 for k in launches}
    want[method] = FSDP_STEPS * per_step
    check(launches == want and leaves[method] == FSDP_STEPS * pieces,
          f"19b {run}: launches {launches} ({leaves}), want {want} ({FSDP_STEPS * pieces} "
          f"leaves)")
    check(held.held == 1, f"19b {run}: the last step's aggregate not held")
    if mode == "replicated":
        check(len(mismatches) == FSDP_STEPS // FSDP_DS and not any(mismatches),
              f"19b {method}: fsdp vs replicated params after each window: {mismatches} "
              "mismatches")
    hist = result.history
    losses = [h["loss"] for h in hist]
    check(all(v == v and abs(v) < 1e4 for v in losses), f"19b {run}: {losses}")
    batch = {k: v[0] for k, v in trainer.stack_window_batches(
        dcfg, FSDP_STEPS, 1, mesh, atk, cfg).items()}
    split = train_step_split(cfg, pcfg, mesh, atk, result.state, batch, FSDP_STEPS)
    prof = {"device_busy_share": None}
    if mode == "fsdp":  # the replicated runs' step is 15b's, profiled there
        sb = steps.make_step_body(cfg, pcfg, mesh, get_optimizer("adamw", TRAIN_LR), atk)
        prof = profile_summary(lambda: sb.body(result.state["params"],
                                               result.state["opt_state"], batch, FSDP_STEPS, 0),
                               split["step_ms"], top=10, names=("leaf_select_kernel",))
        print(json.dumps({"profile_fsdp_step": run, **prof}))
        del sb
    busy = prof["device_busy_share"]
    line = {"fsdp_run": run, "d": SERVE_D, "steps": FSDP_STEPS, "device_steps": FSDP_DS,
            "workers": TRAIN_WORKERS, "tokens_per_step": dcfg.global_batch * dcfg.seq_len,
            "steps_per_s": result.steps_per_s, "tokens_per_s": result.tokens_per_s,
            "first_window_s": result.compile_s, "window_times_s": result.window_times_s,
            "run_wall_s": wall, "losses": losses,
            "grad_norm_last_window": hist[-1]["grad_norm"], "launches": launches,
            "leaves_aggregated": leaves, "b1_b2_launches_per_step": per_step,
            "aggregation_leaves_per_step": pieces, "window_mismatches": mismatches,
            "max_memory_allocated_gb": peak / 1e9, "card_memory_gb": total_mem / 1e9,
            "split_ms": split, "device_busy_share": prof["device_busy_share"], "card": card}
    print(json.dumps({"fsdp_train": line}))
    print(f"phase 19b: {run}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{result.steps_per_s:.3f} steps/s, {result.tokens_per_s:.0f} tokens/s, step "
          f"{split['step_ms']:.1f} ms (grads {split['worker_grads_ms']:.1f}, attack "
          f"{split['attack_ms']:.1f}, reduce-scatter {split['reduce_scatter_ms']:.1f}, "
          f"gather agg {split['aggregate_ms']:.1f}, B1/B2 {split['b1_b2_ms']:.1f}, update "
          f"{split['update_ms']:.1f}), " + (f"busy {busy:.3f}, " if busy is not None else "")
          + f"{per_step} launches a step over {pieces} leaves, peak {peak / 1e9:.2f} GB")
    check(peak < total_mem, f"19b {run}: peak {peak} >= the card's {total_mem}")
    kept = held.kept
    del result, held, batch, holder
    torch.cuda.empty_cache()
    return {"launches": launches, "line": line, "kept": kept}


def fsdp_cell(dev, card: str, on_path):
    """Phase 19b: llama3.2-3b's widths at 8 layers, each of FSDP_METHODS
    under fsdp and then replicated (:func:`fsdp_run`).  Each fsdp run is a
    path of its own: its kernels held bitwise against their plain versions
    on the run's recorded inputs (PathInputs: one copy of the (4, D) rows,
    which the card holds beside the run); every run's last aggregate is
    held in column slices (the replicated runs are 15b's path, there for
    the comparison).  B1 and B2 timed on the fsdp median run's last rows
    (three launches over its 75 leaves).  Returns the fsdp runs'
    launches."""
    import torch

    from repro_torch.models import transformer as T

    cfg = serve_cfg(tiny=False)
    check(T.count_params(cfg) == SERVE_D, f"19b: {T.count_params(cfg)} parameters")
    total = {}
    for method in FSDP_METHODS:
        snaps = []
        for mode in ("fsdp", "replicated"):
            if mode == "fsdp":
                out = on_path(f"phase 19b fsdp {method}",
                              lambda: fsdp_run(dev, card, cfg, mode, method, snaps),
                              lambda o: o["launches"])
                _add(total, out["launches"])
            else:
                out = fsdp_run(dev, card, cfg, mode, method, snaps)
            if out["kept"] is not None:
                rows = train_kernel_timings(out["kept"], card, "fsdp reduce-scatter rows")
                print(json.dumps({"fsdp_kernels": [
                    {k: r[k] for k in ("kernel", "launches", "leaves", "ms", "device_ms",
                                       "bound_ms", "plain_ms")} for r in rows], "card": card}))
            del out
            torch.cuda.empty_cache()
        del snaps
    print(f"phase 19b: fsdp params bitwise the replicated run's after each window, median and "
          f"trimmed mean beta {TRAIN_BETA} under alie")
    return total


def fsdp_process_group(dev):
    """Phase 19c: a NCCL process group of world size 1 in this process
    (file:// rendezvous under build/): the tiny llama's fsdp train_loop
    (gather median, AdamW 1e-2, FSDP_TINY_STEPS steps) over
    ``make_production_mesh`` (ProcessGroupAxes: the autograd gathers and
    their reduce-scatter backward as NCCL collectives) bitwise the same
    run over make_debug_mesh(1) (InProcessAxes({"data": 1})).  Counters
    zeroed before the process group's run and read after: no B1, the
    median of one row takes the sort path.  Returns them."""
    import os

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer
    from repro_torch.tree import tree_leaves

    cfg = train_tiny_cfg()
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", param_mode="fsdp",
                          remat=False)
    tcfg = TrainConfig(optimizer="adamw", lr=1e-2, steps=FSDP_TINY_STEPS, device_steps=1)
    dcfg = DataConfig(**dict(TRAIN_TINY_DATA, num_workers=1))
    rdv = ROOT / "build" / f"chip_smoke_fsdp_pg_{os.getpid()}"
    rdv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdv}", rank=0, world_size=1,
                            device_id=dev)
    try:
        pg = mesh_lib.make_production_mesh(device=dev)
        check(pg.per_rank and mesh_lib.num_workers(pg) == 1, f"19c: mesh {pg}")
        torch.cuda.synchronize()
        _reset_launches()  # zeroed just before the process group's run
        got = trainer.train_loop(cfg, pcfg, tcfg, pg, dcfg=dcfg)
        torch.cuda.synchronize()
        counts = _launches()  # read just after it
        calls = dict(pg.axes.calls)
    finally:
        dist.destroy_process_group()
        rdv.unlink(missing_ok=True)
    ip = mesh_lib.make_debug_mesh(1, device=dev)
    want = trainer.train_loop(cfg, pcfg, tcfg, ip, dcfg=dcfg)
    bad = sum(compare(a, b)[0] for a, b in zip(tree_leaves(got.state["params"]),
                                                tree_leaves(want.state["params"])))
    check(bad == 0, f"19c: ProcessGroupAxes vs InProcessAxes params: {bad} mismatches")
    check([h["loss"] for h in got.history] == [h["loss"] for h in want.history],
          "19c: losses differ")
    check(not any(counts.values()), f"19c: launches {counts}")
    check(calls.get("all_gather", 0) > 0 and calls.get("all_to_all", 0) > 0,
          f"19c: collectives {calls}")
    print(f"phase 19c: fsdp over ProcessGroupAxes (NCCL, world size 1), {FSDP_TINY_STEPS} "
          f"steps of the tiny llama: params and losses bitwise InProcessAxes({{'data': 1}}); "
          f"collectives {json.dumps(calls)}; no kernel launched (one row sorts)")
    return counts


def fsdp_memory():
    """Phase 19d: the bytes a rank holds of llama3.2-3b's params and AdamW
    moments at all 28 layers, fsdp over FSDP_RANKS ranks against
    replicated, from ``trainer.abstract_state`` on the meta device:
    computed from the shapes, not measured."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves

    cfg = get_config("llama3.2-3b")
    mesh = mesh_lib.Mesh(("data", "model"), (FSDP_RANKS, 1), torch.device("cpu"),
                         D.InProcessAxes({"data": FSDP_RANKS}, "cpu"), rank=0, per_rank=True)
    opt = get_optimizer("adamw", TRAIN_LR)
    out = {}
    for mode in ("fsdp", "replicated"):
        st = trainer.abstract_state(cfg, mesh, opt, ParallelConfig(param_mode=mode))
        out[mode] = {k: sum(t.numel() * t.element_size() for t in tree_leaves(st[k]))
                     for k in ("params", "opt_state")}
    d = T.count_params(cfg)
    check(out["replicated"]["params"] == 2 * d and out["replicated"]["opt_state"] == 8 * d,
          f"19d: {out}")
    check(all(out["fsdp"][k] * FSDP_RANKS == out["replicated"][k] for k in out["fsdp"]),
          f"19d: {out}")
    print(json.dumps({"fsdp_rank_bytes": out, "d": d, "layers": cfg.n_layers,
                      "ranks": FSDP_RANKS, "source": "computed from the shapes on the meta "
                                                    "device, not measured"}))
    gb = {m: (v["params"] + v["opt_state"]) / 1e9 for m, v in out.items()}
    print(f"phase 19d: llama3.2-3b at {cfg.n_layers} layers (D = {d:,}), params + AdamW "
          f"moments a rank: fsdp over {FSDP_RANKS} ranks {gb['fsdp']:.2f} GB, replicated "
          f"{gb['replicated']:.2f} GB (computed from the shapes, not measured; gradients, the "
          f"gathered weights autograd keeps and activations come on top)")


def fsdp(dev, card: str, on_path):
    """Phase 19: 19a-19d, each training path under ``on_path``; returns the
    launches of 19a's, 19b's fsdp runs and 19c's."""
    t0 = time.perf_counter()
    out = {"fsdp_tiny": on_path("phase 19a", lambda: fsdp_parity(dev), lambda c: c)}
    print(f"phase 19a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["fsdp_train"] = fsdp_cell(dev, card, on_path)
    print(f"phase 19b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["fsdp_process_group"] = on_path("phase 19c", lambda: fsdp_process_group(dev),
                                        lambda c: c)
    print(f"phase 19c: {time.perf_counter() - t0:.1f} s")
    fsdp_memory()
    return out


# ------------------- phase 20: tensor parallelism over the model axis
#
# (a) llama3.2-3b's widths at 2 layers in f32 (TF32 off): the forward, loss
# and every gradient at make_debug_mesh(4, 2)'s model axis against model 1;
# (b) 15b's cell (8 of 28 layers, D = 1,593,363,456 bf16, m = 4, batch 8,
# seq 128, AdamW 1e-4, alie alpha 0.25) at make_debug_mesh(4, 2) beside the
# same run at model 1, gather median and trimmed mean beta 0.25, 2 steps in
# one window; (c) granite-moe-1b-a400m at 12 of 24 layers, expert-parallel
# (16 experts a shard), 4 steps at (4, 2) beside model 1; (d) the per-rank
# bytes of llama3.2-3b at 28 layers over (data 4, model 2), from the shapes.
# A process group with model > 1 needs a card a rank (NCCL refuses two ranks
# on one GPU): the model ranks run in process, one after the other.
TP_MODEL = 2
TP_PARITY_LAYERS = 2
TP_PARITY_TOL = 1e-4  # f32: |model 2 - model 1| / max |model 1|, loss, logits, each gradient
# bf16, model 2 against model 1, each limit between the sound runs' largest
# reading and what a model-2 run with its split leaves frozen reads
# (scripts/tp_witness.py on the H100; PERF.md section 6):
# each window's loss, relative (sound <= 3.1e-4, frozen 1.7e-3 to 6.8e-3 at
# the last window of 8 steps); 20b's one window of 2 steps reads sound
# 2.44e-5, frozen 1.63e-4 (--steps 2 --device-steps 2), so it has its own
TP_LOSS_RTOL = 1e-3
TP_LOSS_RTOL_BY = {"20b": 8e-5}
# the run's update |u2 - u1| / |u1|, u = final - initial params (sound 0.130
# in 20b at 2 steps, 0.33 in 20c: AdamW at lr 1e-4 moves a bf16 weight by 0
# or 1 ulp; frozen 1.0);
TP_UPDATE_RTOL = 0.6
# the grad norms of the windows within the first four steps, relative: 20b's
# one window of 2 steps (sound 1.26e-4, frozen 8.86e-4; the first window of
# 4 before the cut: 4.5e-5, 5.7e-3) and 20c's four steps (sound <= 2.5e-3,
# frozen >= 0.27 after the first update).  Later norms part under ALIE's
# median without a fault (model 1's own step norms ran 62.3 -> 6.1 in 20b's
# second window of 4): printed, not held.
TP_NORM_RTOL = {"20b": 3e-4, "20c": 1e-2}
TP_NORM_STEPS = 4
# 8 in windows of 4 before the script was cut, 4 in one window before phase 25
TP_STEPS, TP_DS = 2, 2
TP_METHODS = ("median", "trimmed_mean")  # gather, under alie alpha 0.25, beta 0.25
TP_MOE_LAYERS, TP_MOE_D = 12, 742_816_768  # 16b's cell (24 layers before the cut)
TP_MOE_STEPS = 4
TP_DATA_RANKS = 4  # phase 20d's worker axis


def tp_parity(dev):
    """Phase 20a: llama3.2-3b's widths at TP_PARITY_LAYERS layers in f32
    (TF32 off), one batch (2, 128) from one set of params: the forward's
    logits, the loss and every gradient leaf over make_debug_mesh(4, 2)'s
    model axis (every rank of a layer in turn, from chunks of the global
    view) against make_debug_mesh(4, 1)'s (no model axis), each within
    TP_PARITY_TOL of the model-1 value's largest magnitude."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten_like

    cfg = dataclasses.replace(get_config("llama3_2_3b"), n_layers=TP_PARITY_LAYERS,
                              dtype="float32")
    params = T.init_params(cfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(20)
    batch = {k: torch.randint(0, cfg.vocab, (2, 128), generator=g).to(dev)
             for k in ("tokens", "labels")}
    ctxs = {1: sharding.model_ctx(mesh_lib.make_debug_mesh(4, 1, device=dev)),
            TP_MODEL: sharding.model_ctx(mesh_lib.make_debug_mesh(4, TP_MODEL, device=dev))}
    check(ctxs[1] is sharding.NULL_CTX and ctxs[TP_MODEL].model == TP_MODEL,
          f"20a: contexts {ctxs}")
    out = {}
    for model, ctx in ctxs.items():
        with torch.no_grad():
            logits, _ = T.forward(params, batch["tokens"], cfg, kv_block=0, ctx=ctx)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        loss = T.loss_fn(tree_unflatten_like(params, leaves), batch, cfg, kv_block=0, ctx=ctx)
        grads = torch.autograd.grad(loss, leaves)
        out[model] = (float(loss.detach()), logits, grads)
        del leaves, loss
    (l1, z1, g1), (l2, z2, g2) = out[1], out[TP_MODEL]
    worst = {"loss": abs(l2 - l1) / abs(l1),
             "logits": float((z2 - z1).abs().max()) / float(z1.abs().max())}
    for (path, _), a, b in zip(tree_leaves_with_path(params), g2, g1):
        worst[path] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    bad = {k: v for k, v in worst.items() if not v <= TP_PARITY_TOL}
    check(not bad, f"20a: model {TP_MODEL} vs model 1 beyond {TP_PARITY_TOL}: {bad}")
    modes = ctxs[TP_MODEL].modes(cfg)
    print(json.dumps({"tp_parity": {"layers": cfg.n_layers, "model": TP_MODEL,
                                    "modes": modes._asdict(), "rel_err": worst,
                                    "tolerance": TP_PARITY_TOL}}))
    print(f"phase 20a: llama3.2-3b widths at {cfg.n_layers} layers, f32: model {TP_MODEL} "
          f"({modes.attn} attention, F-split FFN, vocab-parallel embed and loss) against "
          f"model 1: loss {worst['loss']:.3g}, logits {worst['logits']:.3g}, worst gradient "
          f"{max(v for k, v in worst.items() if k not in ('loss', 'logits')):.3g} (relative "
          f"to the leaf's largest; tolerance {TP_PARITY_TOL})")
    del params, out, z1, z2, g1, g2
    torch.cuda.empty_cache()


def tp_step_split(cfg, pcfg, mesh, attack, state, batch, step):
    """:func:`train_step_split` of one more step with the model axis'
    partial sums, gathers and maxes timed too (``model_sums_ms``, each call
    closed by a synchronize; they are inside ``worker_grads_ms``)."""
    import torch

    ax = mesh.axes
    spent = {"model_sums_ms": 0.0, "model_calls": 0}

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent["model_sums_ms"] += (time.perf_counter() - t0) * 1e3
            spent["model_calls"] += 1
            return out
        return run

    names = ("model_sum", "model_cat", "model_max")
    for n in names:
        setattr(ax, n, timed(getattr(ax, n)))
    try:
        parts = train_step_split(cfg, pcfg, mesh, attack, state, batch, step)
    finally:
        for n in names:
            delattr(ax, n)
    parts.update(spent)
    return parts


def tp_run(dev, card: str, cfg, model: int, method: str, steps_n: int, ds: int, label: str,
           detail: bool):
    """One run of phase 20b / 20c: ``trainer.train_loop`` over
    make_debug_mesh(4, ``model``), gather ``method`` under alie alpha 0.25,
    AdamW 1e-4, batch 8, seq 128, every window under the sync-debug "error"
    mode, the counters zeroed just before and read just after.  At model >
    1 every step's aggregate is held against its plain version (column
    slices) and the last step's rows are kept; ``detail`` adds the step's
    split and a profile (at model 1 too, for a comparison within the
    call).  Returns {"losses", "launches", "line", "kept"}."""
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import robust_agg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves

    run = f"model {model} gather/{method}/alie"
    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, model, device=dev)
    # 20b's median run at model 2 is phase 23a/b's reference: its first
    # window's loss, its aggregation inputs' digests and params after it
    ref23 = label == "20b" and model == TP_MODEL and method == "median"
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=steps_n, device_steps=ds)
    pcfg = ParallelConfig(agg_method=method, agg_strategy="gather", agg_beta=TRAIN_BETA,
                          remat=False, attn_chunk=0)  # 22d runs remat
    atk = AttackConfig("alie", TRAIN_ALPHA)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    tp = model > 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # zeroed just before this run
    undo = [sync_free_windows()]
    holder, digests, on_window = {}, [], None
    if ref23:
        undo += [window_state(holder), digest_calls(digests)]

        def on_window(w, met):
            if w == 0:
                TP23_REF["params"] = [t.cpu() for t in tree_leaves(holder["state"]["params"])]
    t0 = time.perf_counter()
    try:
        with HeldAggregation(dev, hold=lambda c: tp,
                             keep=lambda c: tp and detail and method == "median"
                             and c == steps_n - 1) as held:
            result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk,
                                        on_window=on_window)
    finally:
        for u in reversed(undo):
            u()
    if ref23:
        TP23_REF.update(loss=result.history[0]["loss"],
                        digests=step_digests(digests, steps_n, ds),
                        grad_norm=result.history[0]["grad_norm"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()  # read just after it
    leaves = dict(robust_agg.LEAVES)
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(tree_leaves(result.state["params"]))
    want = {k: 0 for k in launches}
    want[method] = steps_n  # every leaf in one launch a step
    check(launches == want and leaves[method] == steps_n * n_leaves,
          f"{label} {run}: launches {launches} ({leaves}), want {want}")
    if tp:
        check(held.held == steps_n, f"{label} {run}: {held.held} of {steps_n} aggregates held")
    losses = [h["loss"] for h in result.history]
    check(all(v == v and abs(v) < 1e4 for v in losses), f"{label} {run}: {losses}")
    line = {"tp_run": run, "label": label, "layers": cfg.n_layers, "model": model,
            "steps": steps_n, "device_steps": ds, "workers": TRAIN_WORKERS,
            "tokens_per_step": dcfg.global_batch * dcfg.seq_len,
            "steps_per_s": result.steps_per_s if steps_n > ds else None,
            "tokens_per_s": result.tokens_per_s if steps_n > ds else None,
            "first_window_s": result.compile_s, "window_times_s": result.window_times_s,
            "run_wall_s": wall, "losses": losses,
            "grad_norms": [h["grad_norm"] for h in result.history], "launches": launches,
            "leaves_aggregated": leaves, "b1_b2_launches_per_step": sum(launches.values())
            / steps_n, "aggregates_held": held.held, "max_memory_allocated_gb": peak / 1e9,
            "card_memory_gb": total_mem / 1e9, "card": card}
    msg = ""
    if detail:
        batch = {k: v[0] for k, v in trainer.stack_window_batches(
            dcfg, steps_n, 1, mesh, atk, cfg).items()}
        split = tp_step_split(cfg, pcfg, mesh, atk, result.state, batch, steps_n)
        sb = steps.make_step_body(cfg, pcfg, mesh, get_optimizer("adamw", TRAIN_LR), atk)
        prof = profile_summary(lambda: sb.body(result.state["params"],
                                               result.state["opt_state"], batch, steps_n, 0),
                               split["step_ms"], top=10, names=("leaf_select_kernel",))
        line.update(split_ms=split, device_busy_share=prof["device_busy_share"],
                    launches_per_step=prof["launches"])
        print(json.dumps({"profile_tp_step": run, **prof}))
        msg = (f", step {split['step_ms']:.1f} ms (grads {split['worker_grads_ms']:.1f} with "
               f"model-axis sums {split['model_sums_ms']:.1f} over {split['model_calls']} "
               f"calls, aggregate {split['aggregate_ms']:.1f} with B1/B2 "
               f"{split['b1_b2_ms']:.1f}, AdamW {split['update_ms']:.1f}), "
               f"{prof['launches']} launches, busy {prof['device_busy_share']:.3f}")
        del sb, batch
    print(json.dumps({"tp_train": line}))
    # the trainer's steady rate leaves the first window out: none from one
    rate = (f"{result.steps_per_s:.3f} steps/s" if steps_n > ds else
            "one window (no steady steps/s)")
    print(f"phase {label}: {run}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{rate}{msg}, peak {peak / 1e9:.2f} GB")
    check(peak < total_mem, f"{label} {run}: peak {peak} >= the card's {total_mem}")
    kept = held.kept
    final = [t.cpu() for t in tree_leaves(result.state["params"])]
    del result, held
    torch.cuda.empty_cache()
    return {"losses": losses, "launches": launches, "line": line, "kept": kept,
            "final": final}


def tp_update_rel(init, final, ref, dev) -> float:
    """``|u - u_ref| / |u_ref|`` over all leaves, ``u = final - init``: the
    distance of one run's update from another's (lists of host leaves,
    compared a leaf at a time on the card)."""
    num = den = 0.0
    for a0, a, b in zip(init, final, ref):
        a0, a, b = (x.to(dev).float() for x in (a0, a, b))
        num += float((a - b).square().sum())
        den += float((b - a0).square().sum())
        del a0, a, b
    return (num / den) ** 0.5 if den else 0.0


def tp_pair(dev, card: str, cfg, method: str, steps_n: int, ds: int, label: str,
            detail: bool):
    """The same run at model 1 and at TP_MODEL, held against each other:
    each window's loss within TP_LOSS_RTOL (TP_LOSS_RTOL_BY[label] where it
    has one), the grad norms of the windows within the first TP_NORM_STEPS
    steps within TP_NORM_RTOL[label], and the update within TP_UPDATE_RTOL.  The model-2 run holds every launch
    on its own inputs (HeldAggregation, as 15b does: PathInputs' copy of
    the (4, D) rows does not fit beside the replicated run's gradient
    buffer and AdamW's moments).  Returns the model-2 run."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    init = [t.cpu() for t in tree_leaves(T.init_params(cfg, seed=0, device=dev))]
    torch.cuda.empty_cache()
    # model 1's step is read beside model 2's for the median; the trimmed
    # mean's model-1 step is 15b's
    ref = tp_run(dev, card, cfg, 1, method, steps_n, ds, label, detail and method == "median")
    got = tp_run(dev, card, cfg, TP_MODEL, method, steps_n, ds, label, detail)
    rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    loss_tol = TP_LOSS_RTOL_BY.get(label, TP_LOSS_RTOL)
    norms = {m: r["line"]["grad_norms"] for m, r in ((1, ref), (TP_MODEL, got))}
    norm_rel = [abs(a - b) / abs(b) for a, b in zip(norms[TP_MODEL], norms[1])]
    held = norm_rel[:TP_NORM_STEPS // ds]
    upd = tp_update_rel(init, got["final"], ref["final"], dev)
    del init, ref["final"], got["final"]
    print(json.dumps({"tp_losses": {"label": label, "method": method, "model_1": ref["losses"],
                                    f"model_{TP_MODEL}": got["losses"], "rel": rel,
                                    "tolerance": loss_tol, "grad_norms": norms,
                                    "grad_norm_rel": norm_rel, "grad_norms_held": len(held),
                                    "grad_norm_tolerance": TP_NORM_RTOL[label],
                                    "update_rel": upd, "update_tolerance": TP_UPDATE_RTOL,
                                    "card": card}}))
    check(len(rel) == len(ref["losses"]) and max(rel) <= loss_tol,
          f"{label} {method}: model {TP_MODEL} losses {got['losses']} against model 1 "
          f"{ref['losses']}: {rel}")
    check(held and max(held) <= TP_NORM_RTOL[label],
          f"{label} {method}: model {TP_MODEL} grad norms {norms}: {norm_rel}")
    check(upd <= TP_UPDATE_RTOL, f"{label} {method}: model {TP_MODEL}'s update {upd} from "
          f"model 1's")
    print(f"phase {label}: {method}: model {TP_MODEL} against model 1: every window's loss "
          f"within {max(rel):.3g} (tolerance {loss_tol}), the first {len(held)} "
          f"window(s)' grad norm within {max(held):.3g} ({TP_NORM_RTOL[label]}; later "
          f"{[round(v, 4) for v in norm_rel[len(held):]]}, not held), the update within "
          f"{upd:.3g} ({TP_UPDATE_RTOL})")
    return got


def tp_cell(dev, card: str):
    """Phase 20b: 15b's cell at make_debug_mesh(4, 2), TP_METHODS, beside
    model 1; B1 / B2 timed on the model-2 median run's last rows.  Returns
    the model-2 runs' launches."""
    import torch

    from repro_torch.models import transformer as T

    cfg = serve_cfg(tiny=False)
    check(T.count_params(cfg) == SERVE_D, f"20b: {T.count_params(cfg)} parameters")
    total = {}
    for method in TP_METHODS:
        out = tp_pair(dev, card, cfg, method, TP_STEPS, TP_DS, "20b", True)
        _add(total, out["launches"])
        if out["kept"] is not None:
            rows = train_kernel_timings(out["kept"], card, "tp rows (model 2, global view)")
            print(json.dumps({"tp_kernels": [
                {k: r[k] for k in ("kernel", "launches", "leaves", "ms", "device_ms",
                                   "bound_ms", "plain_ms")} for r in rows], "card": card}))
        del out
        torch.cuda.empty_cache()
    return total


def tp_moe(dev, card: str):
    """Phase 20c: granite-moe-1b-a400m at all TP_MOE_LAYERS layers (bf16, D
    = 1,384,963,072): expert-parallel at model 2 (16 of its 32 experts a
    shard), its odd vocab (49155) splitting embed and lm head on d_model;
    TP_MOE_STEPS steps of gather median under alie at model 2 beside model
    1.  Returns the model-2 run's launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m"), n_layers=TP_MOE_LAYERS)
    check(T.count_params(cfg) == TP_MOE_D, f"20c: {T.count_params(cfg)} parameters")
    modes = sharding.tp_modes(cfg, TP_MODEL)
    check((modes.moe, modes.embed, modes.lm_head) == ("experts", 1, 0), f"20c: {modes}")
    return tp_pair(dev, card, cfg, "median", TP_MOE_STEPS, 1, "20c", False)["launches"]


def tp_chunked(dev):
    """Phase 20e: the chunked strategy (B4 range, B5 counts and sums) on the
    model axis: 15a's tiny llama in f32, 2 AdamW steps of median and
    trimmed mean beta 0.25 under alie at make_debug_mesh(4, 2) (the sketch
    over the global view, the same bits as a rank's shards) against the
    same run at model 1 (losses within TP_PARITY_TOL: a coordinate may
    fall in the next bin).  B4/B5 are held on the path's inputs by the
    caller.  Returns the launches."""
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer

    losses = {}
    for model in (1, TP_MODEL):
        mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, model, device=dev)
        for method in ("median", "trimmed_mean"):
            pcfg = ParallelConfig(agg_method=method, agg_strategy="chunked",
                                  agg_beta=TRAIN_BETA, remat=False)
            if model > 1 and method == "median":
                torch.cuda.synchronize()
                _reset_launches()  # zeroed just before the model-2 runs
            r = trainer.train_loop(train_tiny_cfg(), pcfg,
                                   TrainConfig(optimizer="adamw", lr=1e-2, steps=2,
                                               device_steps=1),
                                   mesh, dcfg=DataConfig(**TRAIN_TINY_DATA),
                                   attack=AttackConfig("alie", TRAIN_ALPHA))
            losses[(model, method)] = [h["loss"] for h in r.history]
    torch.cuda.synchronize()
    launches = _launches()  # read just after them
    check(launches["minmax"] >= 4 and launches["histogram"] >= 4
          and launches["median"] == launches["trimmed_mean"] == 0,
          f"20e: launches {launches}")
    rel = max(abs(a - b) / abs(b) for method in ("median", "trimmed_mean")
              for a, b in zip(losses[(TP_MODEL, method)], losses[(1, method)]))
    check(rel <= TP_PARITY_TOL, f"20e: chunked losses at model {TP_MODEL} vs 1: {losses}")
    print(f"phase 20e: chunked median and trimmed mean of the tiny llama at (4, {TP_MODEL}): "
          f"losses within {rel:.3g} of model 1's (tolerance {TP_PARITY_TOL}); launches "
          f"{json.dumps(launches)}")
    return launches


def tp_memory():
    """Phase 20d: the bytes a rank holds of llama3.2-3b's params and AdamW
    moments at all 28 layers over (data TP_DATA_RANKS, model TP_MODEL)
    ranks against replicated, from ``trainer.abstract_state`` on the meta
    device: computed from the shapes, not measured."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves

    cfg = get_config("llama3.2-3b")
    opt = get_optimizer("adamw", TRAIN_LR)
    out = {}
    for name, model in (("tp", TP_MODEL), ("replicated", 1)):
        mesh = mesh_lib.Mesh(("data", "model"), (TP_DATA_RANKS, model), torch.device("cpu"),
                             D.InProcessAxes({"data": TP_DATA_RANKS, "model": model}, "cpu"),
                             rank=0, per_rank=True)
        st = trainer.abstract_state(cfg, mesh, opt, ParallelConfig())
        out[name] = {k: sum(t.numel() * t.element_size() for t in tree_leaves(st[k]))
                     for k in ("params", "opt_state")}
    d = T.count_params(cfg)
    check(out["replicated"]["params"] == 2 * d and out["replicated"]["opt_state"] == 8 * d,
          f"20d: {out}")
    check(all(out["replicated"][k] / TP_MODEL < out["tp"][k] < out["replicated"][k] / TP_MODEL
              * 1.001 for k in out["tp"]), f"20d: {out}")
    print(json.dumps({"tp_rank_bytes": out, "d": d, "layers": cfg.n_layers,
                      "ranks": {"data": TP_DATA_RANKS, "model": TP_MODEL},
                      "source": "computed from the shapes on the meta device, not measured"}))
    gb = {m: (v["params"] + v["opt_state"]) / 1e9 for m, v in out.items()}
    print(f"phase 20d: llama3.2-3b at {cfg.n_layers} layers (D = {d:,}), params + AdamW "
          f"moments a rank over (data {TP_DATA_RANKS}, model {TP_MODEL}): {gb['tp']:.2f} GB "
          f"against {gb['replicated']:.2f} GB replicated (19d: fsdp over 4 ranks 9.02 GB; "
          f"computed from the shapes, not measured)")


def tensor_parallel(dev, card: str, on_path):
    """Phase 20: 20a-20e; returns the launches of 20b's and 20c's model-2
    runs (each of their launches held bitwise on its own rows) and of
    20e's (held on the path's inputs by ``on_path``)."""
    t0 = time.perf_counter()
    tp_parity(dev)
    print(f"phase 20a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = {"tp_train": tp_cell(dev, card)}
    print(f"phase 20b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["tp_moe"] = tp_moe(dev, card)
    print(f"phase 20c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["tp_chunked"] = on_path("phase 20e", lambda: tp_chunked(dev), lambda c: c)
    print(f"phase 20e: {time.perf_counter() - t0:.1f} s")
    tp_memory()
    return out


# ------------------------------- phase 21: serving under tensor parallelism
#
# (a) 14a's tiny model and granite-moe-smoke in f32 at make_debug_mesh(1, 2)
# against model 1; (b) 14b's cell (llama3.2-3b widths, 8 of 28 layers,
# bf16) and (c) 16b's granite-moe-1b-a400m cell (12 of 24 layers) at
# make_debug_mesh(4, 2), the serve shim's default mesh, beside 14b's and
# 16b's model-1 runs; (d) the serve shim's defaults on the card; (e) the
# per-rank bytes of llama3.2-3b at 28 layers from the shapes.  As in phase
# 20 the model ranks run in process, one after the other.
TPS_LOGIT_TOL = 1e-5  # f32, |model 2 - model 1| / max |model 1| (tests: 1e-5 absolute)
TPS_DECODE_STEPS = 8
TPS_RUNS = ("serve_only", "median", "trimmed_mean")
TPS_MOE_RUNS = ("median",)  # 21c keeps phase 21 near its budget
TPS_SHIM_ARCHS = ("llama3.2-3b", "granite-moe-1b-a400m", "mamba2-2.7b", "recurrentgemma-2b")
TPS_POOL = dict(slots=4, cache_len=32)  # 21e: SERVE_ENGINE's pool


def tp_serve_parity(dev, cfg, label: str):
    """Phase 21a on one f32 config: teacher-forced logits of the prefill and
    TPS_DECODE_STEPS decode steps at make_debug_mesh(1, 2) against model 1,
    the engine's tokens against model 1's (the top-2 rule of 14a) and a hot
    swap at model 2 that keeps the storage."""
    import numpy as np
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeConfig, ServeEngine, serve_stream
    from repro_torch.serve.traffic import VirtualUsers
    from repro_torch.tree import tree_map

    mesh = mesh_lib.make_debug_mesh(1, TP_MODEL, device=dev)
    params = T.init_params(cfg, seed=0, device=dev)
    prompts = np.random.default_rng(21).integers(0, cfg.vocab, (2, 8))
    cache_len = 8 + TPS_DECODE_STEPS + 1

    def forced(m, prompt, toks):
        prefill = steps.make_prefill_step(cfg, kv_block=0, cache_len=cache_len, mesh=m)
        decode = steps.make_decode_step(cfg, m)
        logits, cache = prefill(params, torch.as_tensor(prompt, device=dev)[None])
        out = [logits[0, -1]]
        for j, t in enumerate(toks[:-1]):
            logits, cache = decode(params, torch.tensor([[int(t)]], device=dev), cache,
                                   len(prompt) + j)
            out.append(logits[0, 0])
        return torch.stack(out).float().cpu()

    worst = 0.0
    fed = np.random.default_rng(22).integers(0, cfg.vocab, (2, TPS_DECODE_STEPS + 1))
    for prompt, toks in zip(prompts, fed):
        one = forced(None, prompt, toks)
        two = forced(mesh, prompt, toks)
        worst = max(worst, float((two - one).abs().max() / one.abs().max()))
    check(worst <= TPS_LOGIT_TOL, f"{label}: model-2 logits differ from model 1's by {worst}")
    scfg = ServeConfig(slots=3, prompt_len=8, max_new=6, window=16)
    tcfg = serve_traffic(cfg, scfg, num_users=64, num_shards=2, alpha=0.5, min_gen=1)
    reqs = VirtualUsers(tcfg).sample_requests(12)
    done = {}
    for model, m in ((1, None), (TP_MODEL, mesh)):
        engine = ServeEngine(cfg, scfg, params, m)
        out = serve_stream(engine, reqs)
        check(len(out) == len(reqs), f"{label}: model {model} served {len(out)}/{len(reqs)}")
        done[model] = {c.request.rid: c.response for c in out}
    flips = 0
    for req in reqs:
        a, b = done[TP_MODEL][req.rid], done[1][req.rid]
        want = forced(None, req.prompt, b)
        gap = torch.sort(want, dim=-1).values[:, -2:].diff(dim=-1)[:, 0]
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                check(float(gap[j]) <= 2 * TPS_LOGIT_TOL,
                      f"{label}: request {req.rid} step {j}: model-2 token {x} != model 1's "
                      f"{y} at a top-2 gap of {float(gap[j])}")
                flips += 1
                break
    engine = ServeEngine(cfg, scfg, params, mesh)
    serve_stream(engine, reqs[:4])
    engine.swap_params(tree_map(lambda w: w * 0.5, params))
    serve_stream(engine, VirtualUsers(tcfg).sample_requests(4, stream=1))
    check(engine.storage_kept() == {"params": True, "pool": True},
          f"{label}: storage not kept across a model-2 swap")
    print(f"phase 21a: {cfg.name} f32 at make_debug_mesh(1, {TP_MODEL}): prefill + "
          f"{TPS_DECODE_STEPS} decode steps' logits within {worst:.3g} of model 1's "
          f"(relative; tolerance {TPS_LOGIT_TOL}); engine tokens equal on {len(reqs)} requests "
          f"({flips} near-tie flips); a hot swap keeps the storage")
    return worst


def tp_serve_cells(dev, card: str, served):
    """Phase 21b and 21c: 14b's and 16b's cells at make_debug_mesh(4, 2);
    returns each kernel's launches over each cell's runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve.engine import ServeConfig

    mesh = mesh_lib.make_debug_mesh(4, TP_MODEL, device=dev)
    out = {}
    for key, label, cfg, d, runs, scfg, requests in (
            ("tp_serve", "21b", serve_cfg(tiny=False), SERVE_D, TPS_RUNS,
             ServeConfig(**SERVE_ENGINE), SERVE_REQUESTS),
            ("tp_serve_moe", "21c",
             dataclasses.replace(get_config("granite_moe_1b_a400m"), n_layers=TP_MOE_LAYERS),
             TP_MOE_D, TPS_MOE_RUNS, ServeConfig(slots=4, prompt_len=16, max_new=16),
             FAMILY_REQUESTS)):
        t0 = time.perf_counter()
        # B1/B2 at these rows' shapes are timed in 14b and 16b
        launches = serve_runs(dev, card, cfg, d, runs, scfg, label, requests=requests,
                              mesh=mesh, served=served, kernel_timings=False)
        total = {}
        for counts in launches.values():
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        out[key] = total
        print(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def tp_serve_shim():
    """Phase 21d: ``python -m repro_torch.launch.serve --arch <arch> --smoke``
    with its defaults on the card, the processes started together: llama,
    granite, mamba2 and recurrentgemma (their mixers on the model axis
    since phase 22's slice) serve every request at (data 4, model 2) and
    exit 0.  Returns the lines to print."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    try:
        for arch in TPS_SHIM_ARCHS:
            procs.append((arch, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch, "--smoke"],
                env=env, cwd=ROOT, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)))
        for arch, proc in procs:
            out, err = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"21d: the shim on {arch} exited {proc.returncode}: "
                                        f"{err[-2000:]}")
            check("served 4/4 requests" in out and "device cuda" in out and
                  "mesh={'data': 4, 'model': 2}" in out, f"21d: the shim on {arch}: {out[-2000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return [f"phase 21d: the serve shim's defaults on the card: {', '.join(TPS_SHIM_ARCHS)} "
            f"served 4/4 at (data 4, model {TP_MODEL})"]


def tp_serve_memory():
    """Phase 21e: the bytes a rank holds to serve and adapt llama3.2-3b at
    all 28 layers over (data TP_DATA_RANKS, model TP_MODEL) against model
    1: the bf16 params, the slot pool and the (4, D_rank) f32 rows, from
    the shapes on the meta device: computed, not measured."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves

    cfg = get_config("llama3.2-3b")
    out = {}
    for name, model in (("tp", TP_MODEL), ("replicated", 1)):
        mesh = mesh_lib.Mesh(("data", "model"), (TP_DATA_RANKS, model), torch.device("cpu"),
                             D.InProcessAxes({"data": TP_DATA_RANKS, "model": model}, "cpu"),
                             rank=0, per_rank=True)
        params = steps.abstract_params(cfg, mesh)
        pool = T.init_cache(cfg, TPS_POOL["slots"], TPS_POOL["cache_len"], device="meta")
        if model > 1:
            from repro_torch.models import sharding

            dims = sharding.cache_dims(cfg, model, pool, steps.cache_shardings(cfg, mesh, pool))
            pool = sharding.shard_cache(pool, dims, 0, model)
        d_rank = sum(t.numel() for t in tree_leaves(params))
        out[name] = {"params": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
                     "pool": sum(t.numel() * t.element_size() for t in tree_leaves(pool)),
                     "rows": 4 * d_rank * 4}
    d = T.count_params(cfg)
    check(out["replicated"]["params"] == 2 * d and out["replicated"]["rows"] == 16 * d,
          f"21e: {out}")
    check(all(out["replicated"][k] / TP_MODEL <= out["tp"][k] < out["replicated"][k] / TP_MODEL
              * 1.001 for k in ("params", "rows")), f"21e: {out}")
    print(json.dumps({"tp_serve_rank_bytes": out, "d": d, "layers": cfg.n_layers,
                      "ranks": {"data": TP_DATA_RANKS, "model": TP_MODEL}, "pool": TPS_POOL,
                      "source": "computed from the shapes on the meta device, not measured"}))
    gb = {m: sum(v.values()) / 1e9 for m, v in out.items()}
    print(f"phase 21e: llama3.2-3b at {cfg.n_layers} layers (D = {d:,}), params + pool + (4, "
          f"D_rank) f32 rows a rank at (data {TP_DATA_RANKS}, model {TP_MODEL}): "
          f"{gb['tp']:.2f} GB against {gb['replicated']:.2f} GB at model 1 (computed from the "
          f"shapes, not measured)")


def tp_serving(dev, card: str, served):
    """Phase 21: 21a-21c and 21e (21d runs in the CLI batch); returns the
    B1/B2 launches of 21b's and 21c's model-2 runs (each round's aggregate
    held bitwise on its own rows)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config

    t0 = time.perf_counter()
    tp_serve_parity(dev, serve_cfg(tiny=True), "21a tiny")
    tp_serve_parity(dev, dataclasses.replace(get_smoke_config("granite_moe_1b_a400m"),
                                             dtype="float32"), "21a granite")
    print(f"phase 21a: {time.perf_counter() - t0:.1f} s")
    out = tp_serve_cells(dev, card, served)
    tp_serve_memory()
    return out


# --------- phase 22: tensor parallelism of the ssm / rec layers and the frontends
#
# (a) f32 parity at full widths and shallow depth: model 2 against model 1 in
# one call (make_debug_mesh(1, 2)), the logits, the loss and every gradient
# leaf; (b) 16b's mamba2-2.7b and recurrentgemma-2b cells served at (data 4,
# model 2), one median run each, beside 16b's model-1 runs; (c) 18b's
# whisper-small and internvl2-1b cells trained at (4, 2) for one window of 2
# steps, beside 18b's model-1 first window; (d) remat on 15b's cell,
# replicated and fsdp; (e) the per-rank bytes of mamba2-2.7b and
# recurrentgemma-2b at full depth from the shapes.  As in phases 20 and 21
# the model ranks run in process, one after the other.
TPF_PARITY = (("mamba2_2_7b", dict(n_layers=2)), ("recurrentgemma_2b", dict(n_layers=3)),
              ("whisper-small", dict(n_layers=2, n_enc_layers=2)),
              ("internvl2-1b", dict(n_layers=2)))
TPF_PARITY_TOL = TP_PARITY_TOL  # set before the run: 20a's limit (20a read 4.0e-6)
TPF_SERVE = ("mamba2_2_7b", "recurrentgemma_2b")  # 16b's cells (FAMILY_CELLS)
TPF_TICKS = 2
# one window: 18b's first window over the same batches (4 before the script
# was cut to run well inside its time limit)
TPF_TRAIN_STEPS = FRONTEND_DS
REMAT_STEPS = 2  # 4 before phase 24 took its time
REMAT_FULL = (("mamba2_2_7b", 64), ("recurrentgemma_2b", 26))


def tp_family_parity(dev):
    """Phase 22a: each TPF_PARITY configuration at its published widths and
    a shallow depth in f32 (TF32 off), params from seed 0, one batch (1,
    128) (and its frontend, 1500 frames or 256 patches): the logits, the
    loss and every gradient leaf over make_debug_mesh(1, 2)'s model axis
    against no model axis, each as |model 2 - model 1| over the model-1
    value's largest magnitude, within TPF_PARITY_TOL.  The leaves no
    computation reads (whisper's cross FFN) are exactly 0 at both."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten_like

    report = {}
    ctx = sharding.model_ctx(mesh_lib.make_debug_mesh(1, TP_MODEL, device=dev))
    for arch, over in TPF_PARITY:
        cfg = dataclasses.replace(get_config(arch), dtype="float32", **over)
        params = T.init_params(cfg, seed=0, device=dev)
        g = torch.Generator().manual_seed(22)
        batch = {k: torch.randint(0, cfg.vocab, (1, 128), generator=g).to(dev)
                 for k in ("tokens", "labels")}
        if cfg.frontend != "none":
            batch["frontend"] = torch.randn((1, cfg.n_frontend_tokens, cfg.d_model),
                                            generator=g).to(dev)
        out = {}
        for model, c in ((1, sharding.NULL_CTX), (TP_MODEL, ctx)):
            with torch.no_grad():
                logits, _ = T.forward(params, batch["tokens"], cfg,
                                      frontend=batch.get("frontend"), kv_block=0, ctx=c)
            leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
            loss = T.loss_fn(tree_unflatten_like(params, leaves), batch, cfg, kv_block=0, ctx=c,
                             remat=False)
            grads = [torch.zeros_like(x) if y is None else y for y, x in
                     zip(torch.autograd.grad(loss, leaves, allow_unused=True), leaves)]
            out[model] = (float(loss.detach()), logits, grads)
            del leaves, loss
        (l1, z1, g1), (l2, z2, g2) = out[1], out[TP_MODEL]
        worst = {"loss": abs(l2 - l1) / abs(l1),
                 "logits": float((z2 - z1).abs().max()) / float(z1.abs().max())}
        for (path, _), a, b in zip(tree_leaves_with_path(params), g2, g1):
            scale = float(b.abs().max())
            worst[path] = float((a - b).abs().max()) / scale if scale else float(a.abs().max())
        bad = {k: v for k, v in worst.items() if not v <= TPF_PARITY_TOL}
        check(not bad, f"22a {arch}: model {TP_MODEL} vs model 1 beyond {TPF_PARITY_TOL}: {bad}")
        modes = ctx.modes(cfg)
        grad_worst = max(v for k, v in worst.items() if k not in ("loss", "logits"))
        report[cfg.name] = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
                            "modes": modes._asdict(), "loss": worst["loss"],
                            "logits": worst["logits"], "worst_gradient": grad_worst}
        print(f"phase 22a: {cfg.name} widths at {cfg.n_layers} layers"
              + (f" + {cfg.n_enc_layers} encoder layers" if cfg.n_enc_layers else "")
              + f", f32: model {TP_MODEL} ({modes.attn} attention, ssm mixer {modes.ssm}, rec "
              f"mixer {modes.rec}, in-projections {list(modes.mixer_in)}, row-parallel "
              f"{list(modes.mixer_out)}) against model 1: "
              f"loss {worst['loss']:.3g}, logits {worst['logits']:.3g}, worst gradient "
              f"{grad_worst:.3g} (tolerance {TPF_PARITY_TOL})")
        del params, out, z1, z2, g1, g2
        torch.cuda.empty_cache()
    print(json.dumps({"tp_family_parity": report, "tolerance": TPF_PARITY_TOL}))


def tp_family_serving(dev, card: str, served):
    """Phase 22b: 16b's mamba2-2.7b cell (8 of 64 layers, 272-token
    prompts) and recurrentgemma-2b cell (5 of 26 layers) in bf16 at
    make_debug_mesh(4, 2), the serve shim's default mesh: one median run
    each of 16b's 24-request stream, held as 16b (every request served, >=
    2 rounds, one B1 launch over one leaf a round, bitwise its plain
    version on the round's rows), the round's split and profile, a
    profile of TPF_TICKS ticks (tick ms, launches a tick, busy share), peak
    memory, and the share of whole requests (and of tokens) equal to 16b's
    model-1 median run (printed: bf16 partials summed in rank order flip
    near-ties), beside 16b's model-1 tick; the mixers run on each rank's
    heads (mamba2) and channels (recurrentgemma).  Returns each kernel's
    launches over the two runs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.serve.engine import ServeConfig

    mesh = mesh_lib.make_debug_mesh(4, TP_MODEL, device=dev)
    total = {}
    for arch, layers, d, prompt, _ in FAMILY_CELLS:
        if arch not in TPF_SERVE:
            continue
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        t0 = time.perf_counter()
        launches = serve_runs(dev, card, cfg, d, ("median",),
                              ServeConfig(slots=4, prompt_len=prompt, max_new=16),
                              f"22b {arch}", requests=FAMILY_REQUESTS, mesh=mesh, served=served,
                              ticks=TPF_TICKS, kernel_timings=False)
        _add(total, launches["median"])
        got, ref = served.get((cfg.name, "median", TP_MODEL)), served.get((cfg.name, "median", 1))
        check(got is not None and ref is not None, f"22b {arch}: no model-1 tokens from 16b")
        same = sum(toks == ref.get(rid) for rid, toks in got.items()) / len(got)
        ticks = {m: served.get(("ticks", cfg.name, "median", m)) for m in (1, TP_MODEL)}
        check(ticks[TP_MODEL] is not None, f"22b {arch}: no tick profile at model {TP_MODEL}")
        t2 = ticks[TP_MODEL]
        print(f"phase 22b: {arch} at (data 4, model {TP_MODEL}): {same:.3f} of the requests "
              f"and {t2['tokens_equal_model_1']:.3f} of the tokens served the same as 16b's "
              f"model-1 median run; tick {t2['tick_ms']:.2f} ms, "
              f"{t2['launches_a_tick']:.0f} launches a tick, busy {t2['busy_share']:.3f}"
              + (f" (model 1: {ticks[1]['tick_ms']:.2f} ms, {ticks[1]['launches_a_tick']:.0f}, "
                 f"{ticks[1]['busy_share']:.3f})" if ticks[1] else "")
              + f"; {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"tp_family_ticks": cfg.name, "model_axis": TP_MODEL, **t2,
                          "model_1": ticks[1], "card": card}))
    return total


def tp_frontend_training(dev, card: str, firsts):
    """Phase 22c: 18b's whisper-small and internvl2-1b cells (full width and
    depth, bf16, 4 workers, batch 8, seq 128, AdamW 1e-4) at
    make_debug_mesh(4, 2): gather median under alie alpha 0.25 for one
    window of TPF_TRAIN_STEPS steps, every window under the sync-debug
    "error" mode.  One B1 launch a step over every leaf and no other
    kernel, each held bitwise against its plain version on its own rows
    (HeldAggregation); the window's loss within TP_LOSS_RTOL of 18b's
    model-1 first window over the same params and batches (``firsts``);
    step ms, its split (gradients with the model-axis sums, attack, B1,
    AdamW), launches a step, busy share, peak memory.  Returns the
    launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import robust_agg
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import get_optimizer

    total_mem = torch.cuda.get_device_properties(0).total_memory
    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, TP_MODEL, device=dev)
    total = {}
    for arch, d_want, n_leaves in FRONTEND_CELLS:
        t_cell = time.perf_counter()
        cfg = get_config(arch)
        check(T.count_params(cfg) == d_want, f"22c {arch}: {T.count_params(cfg)} parameters")
        want_loss = firsts.get((arch, "median", "alie"))
        check(want_loss is not None, f"22c {arch}: no model-1 loss from 18b")
        run = f"{arch} model {TP_MODEL} gather/median/alie"
        dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
        tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=TPF_TRAIN_STEPS,
                           device_steps=TPF_TRAIN_STEPS)
        pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=TRAIN_BETA,
                              remat=False, attn_chunk=0)  # 18b's settings
        atk = AttackConfig("alie", TRAIN_ALPHA)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()  # zeroed just before this run
        undo = sync_free_windows()
        t0 = time.perf_counter()
        try:
            with HeldAggregation(dev) as held:
                result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk)
        finally:
            undo()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()  # read just after it
        leaves = dict(robust_agg.LEAVES)
        peak = torch.cuda.max_memory_allocated()
        want = {k: 0 for k in launches}
        want["median"] = TPF_TRAIN_STEPS
        check(launches == want and leaves["median"] == TPF_TRAIN_STEPS * n_leaves,
              f"22c {run}: launches {launches} ({leaves}), want {want}")
        check(held.held == TPF_TRAIN_STEPS,
              f"22c {run}: {held.held} of {TPF_TRAIN_STEPS} aggregates held")
        loss = result.history[0]["loss"]
        rel = abs(loss - want_loss) / abs(want_loss)
        check(rel <= TP_LOSS_RTOL, f"22c {run}: loss {loss} against 18b's model-1 {want_loss}: "
                                   f"{rel} > {TP_LOSS_RTOL}")
        _add(total, launches)
        batch = {k: v[0] for k, v in trainer.stack_window_batches(
            dcfg, TPF_TRAIN_STEPS, 1, mesh, atk, cfg).items()}
        split = tp_step_split(cfg, pcfg, mesh, atk, result.state, batch, TPF_TRAIN_STEPS)
        sb = steps.make_step_body(cfg, pcfg, mesh, get_optimizer("adamw", TRAIN_LR), atk)
        prof = profile_summary(lambda: sb.body(result.state["params"], result.state["opt_state"],
                                               batch, TPF_TRAIN_STEPS, 0),
                               split["step_ms"], top=10, names=("leaf_select_kernel",))
        line = {"tp_frontend_run": run, "d": d_want, "leaves": n_leaves, "model": TP_MODEL,
                "steps": TPF_TRAIN_STEPS, "workers": TRAIN_WORKERS,
                "tokens_per_step": dcfg.global_batch * dcfg.seq_len,
                "frontend_tokens": cfg.n_frontend_tokens, "steps_per_s": result.steps_per_s,
                "run_wall_s": wall, "loss": loss, "loss_model_1": want_loss, "loss_rel": rel,
                "loss_tolerance": TP_LOSS_RTOL, "launches": launches, "leaves_aggregated": leaves,
                "aggregates_held": held.held, "split_ms": split,
                "launches_per_step": prof["launches"],
                "device_busy_share": prof["device_busy_share"],
                "max_memory_allocated_gb": peak / 1e9, "card_memory_gb": total_mem / 1e9,
                "card": card}
        print(json.dumps({"profile_tp_frontend_step": run, **prof}))
        print(json.dumps({"tp_frontend_train": line}))
        print(f"phase 22c: {run}: window loss {loss:.4f} against 18b's model-1 "
              f"{want_loss:.4f} ({rel:.3g}, tolerance {TP_LOSS_RTOL}); step "
              f"{split['step_ms']:.1f} ms (grads {split['worker_grads_ms']:.1f} with model-axis "
              f"sums {split['model_sums_ms']:.1f}, attack {split['attack_ms']:.1f}, B1 "
              f"{split['b1_b2_ms']:.1f}, AdamW {split['update_ms']:.1f}), {prof['launches']} "
              f"launches, busy {prof['device_busy_share']:.3f}, peak {peak / 1e9:.2f} GB; "
              f"{time.perf_counter() - t_cell:.1f} s")
        check(peak < total_mem, f"22c {run}: peak {peak} >= the card's {total_mem}")
        del result, held, sb, batch
        torch.cuda.empty_cache()
    return total


def digest_rows(x):
    """Device int64 digests of one aggregation input (m, ...): per row, the
    sums of its bit patterns (as signed integers of the element's width)
    over 16 column blocks and the sum of their wrapped squares.  Equal
    inputs give equal digests; any change of a bit changes a block sum."""
    import torch

    m = x.shape[0]
    ints = {2: torch.int16, 4: torch.int32}[x.element_size()]
    v = x.reshape(m, -1).view(ints)
    blocks = [b.sum(dim=1) for b in torch.tensor_split(v, 16, dim=1)]
    return torch.stack(blocks + [(v * v).sum(dim=1)], dim=1)


def remat_run(dev, cfg, mode: str, remat: bool, card: str):
    """One of phase 22d's runs: 15b's settings (gather median under alie
    alpha 0.25, AdamW 1e-4, 4 workers, batch 8, seq 128) with ``mode`` and
    ``remat`` for REMAT_STEPS steps in windows of one, every window under
    the sync-debug "error" mode, the counters zeroed just before and read
    just after; every aggregation call's inputs digested on the card
    (:func:`digest_rows`, read after the run) and, with remat, every call
    held bitwise against its plain version on its own rows (without remat
    the run is 15b's / 19b's path, held there); then one more step (not
    kept) timed with its split and no hold (:func:`train_step_split`).
    Returns the losses, the digests, the launches, the final params (host)
    and the readings."""
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core import aggregators
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer
    from repro_torch.tree import tree_leaves

    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=REMAT_STEPS, device_steps=1)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=TRAIN_BETA,
                          param_mode=mode, remat=remat, attn_chunk=0)
    atk = AttackConfig("alie", TRAIN_ALPHA)
    digests = []
    real = aggregators.aggregate_leaves

    def digested(leaves, method, beta=0.1):
        digests.append([digest_rows(x) for x in leaves])
        return real(leaves, method, beta)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # zeroed just before this run
    aggregators.aggregate_leaves = digested
    undo = sync_free_windows()
    t0 = time.perf_counter()
    try:
        with HeldAggregation(dev, hold=lambda c: remat) as held:
            result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk)
    finally:
        undo()
        aggregators.aggregate_leaves = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()  # read just after it
    peak = torch.cuda.max_memory_allocated()
    check(held.held == (len(digests) if remat else 0),
          f"22d {mode}: {held.held} of {len(digests)} aggregation calls held")
    losses = [h["loss"] for h in result.history]
    final = [t.cpu() for t in tree_leaves(result.state["params"])]
    batch = {k: v[0] for k, v in trainer.stack_window_batches(
        dcfg, REMAT_STEPS, 1, mesh, atk, cfg).items()}
    split = train_step_split(cfg, pcfg, mesh, atk, result.state, batch, REMAT_STEPS)
    line = {"remat_run": f"{mode} remat={remat}", "steps": REMAT_STEPS, "losses": losses,
            "launches": launches, "aggregation_calls": len(digests), "aggregates_held": held.held,
            "step_ms": split["step_ms"], "split_ms": split,
            "window_times_s": result.window_times_s, "run_wall_s": wall,
            "max_memory_allocated_gb": peak / 1e9, "card": card}
    print(json.dumps({"remat": line}))
    out = {"losses": losses, "digests": [[d.cpu() for d in call] for call in digests],
           "launches": launches, "final": final, "line": line}
    del result, digests, batch
    torch.cuda.empty_cache()
    return out


def remat_cell(dev, card: str):
    """Phase 22d: ``ParallelConfig.remat`` on 15b's cell (llama3.2-3b's
    widths at 8 layers, bf16), replicated and fsdp: REMAT_STEPS steps with
    remat off, then on.  The losses, every aggregation call's input digests
    (the B1 inputs a step) and the final params bitwise equal, the B1
    launches the same; each run's step ms and peak GB.  Returns the remat
    runs' launches."""
    from repro_torch.models import transformer as T

    cfg = serve_cfg(tiny=False)
    check(T.count_params(cfg) == SERVE_D, f"22d: {T.count_params(cfg)} parameters")
    total = {}
    for mode in ("replicated", "fsdp"):
        off = remat_run(dev, cfg, mode, False, card)
        on = remat_run(dev, cfg, mode, True, card)
        same_inputs = (len(on["digests"]) == len(off["digests"]) and all(
            len(a) == len(b) and all(bool((x == y).all()) for x, y in zip(a, b))
            for a, b in zip(on["digests"], off["digests"])))
        same_params = all(bool((a == b).all()) for a, b in zip(on["final"], off["final"]))
        check(on["losses"] == off["losses"] and same_inputs and same_params,
              f"22d {mode}: remat on is not bitwise off: losses {on['losses']} / "
              f"{off['losses']}, inputs {same_inputs}, params {same_params}")
        check(on["launches"] == off["launches"] and on["launches"]["median"] > 0,
              f"22d {mode}: launches {on['launches']} with remat, {off['launches']} without")
        _add(total, on["launches"])
        lo, ln = off["line"], on["line"]
        print(f"phase 22d: {mode}: remat on bitwise off over {REMAT_STEPS} steps (losses, "
              f"{len(on['digests'])} aggregation calls' input digests, final params), "
              f"{on['launches']['median']} B1 launches each; step {lo['step_ms']:.1f} -> "
              f"{ln['step_ms']:.1f} ms (grads {lo['split_ms']['worker_grads_ms']:.1f} -> "
              f"{ln['split_ms']['worker_grads_ms']:.1f}), peak "
              f"{lo['max_memory_allocated_gb']:.2f} -> {ln['max_memory_allocated_gb']:.2f} GB")
        del off, on
    return total


def tp_family_memory():
    """Phase 22e: the bytes a rank holds to serve and adapt mamba2-2.7b at
    64 layers and recurrentgemma-2b at 26 over (data TP_DATA_RANKS, model
    TP_MODEL) against model 1: the bf16 params, the slot pool (TPS_POOL;
    a rank's ``ssd``, ``h`` and ``rec`` ``conv`` exactly 1/TP_MODEL of the
    whole, the ``ssm`` conv window its x channels and B and C) and the (4,
    D_rank) f32 rows, from the shapes on the meta device: computed, not
    measured."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    report = {}
    for arch, layers in REMAT_FULL:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        out = {}
        for name, model in (("tp", TP_MODEL), ("replicated", 1)):
            mesh = mesh_lib.Mesh(("data", "model"), (TP_DATA_RANKS, model), torch.device("cpu"),
                                 D.InProcessAxes({"data": TP_DATA_RANKS, "model": model}, "cpu"),
                                 rank=0, per_rank=True)
            params = steps.abstract_params(cfg, mesh)
            pool = T.init_cache(cfg, TPS_POOL["slots"], TPS_POOL["cache_len"], device="meta")
            if model > 1:
                dims = sharding.cache_dims(cfg, model, pool,
                                           steps.cache_shardings(cfg, mesh, pool))
                pool = sharding.shard_cache(pool, dims, 0, model)
            d_rank = sum(t.numel() for t in tree_leaves(params))
            states = {p: t.numel() * t.element_size() for p, t in tree_leaves_with_path(pool)
                      if p.split("/")[-1] in ("ssd", "h", "conv")}
            out[name] = {"params": sum(t.numel() * t.element_size() for t in tree_leaves(params)),
                         "pool": sum(t.numel() * t.element_size() for t in tree_leaves(pool)),
                         "rows": 4 * d_rank * 4,
                         # the recurrent states split whole/model: ssd, h and rec's conv
                         "split_states": sum(b for p, b in states.items()
                                             if cfg.ssm is None or not p.endswith("conv")),
                         "ssm_conv": sum(b for p, b in states.items()
                                         if cfg.ssm is not None and p.endswith("conv"))}
        d = T.count_params(cfg)
        check(out["replicated"]["params"] < 2 * d * 1.001 and out["replicated"]["rows"] == 16 * d,
              f"22e {arch}: {out}")
        check(all(out["replicated"][k] / TP_MODEL <= out["tp"][k] < out["replicated"][k]
                  / TP_MODEL * 1.01 for k in ("params", "rows")), f"22e {arch}: {out}")
        check(out["replicated"]["split_states"] > 0 and out["tp"]["split_states"] * TP_MODEL
              == out["replicated"]["split_states"], f"22e {arch}: recurrent states {out}")
        if cfg.ssm is not None:  # a rank's x channels of the window, B and C whole
            s_cfg, di = T._ssm_dims(cfg)[:2]
            check(out["tp"]["ssm_conv"] * (di + 2 * s_cfg.d_state) == out["replicated"][
                "ssm_conv"] * (di // TP_MODEL + 2 * s_cfg.d_state), f"22e {arch}: conv {out}")
        report[cfg.name] = {"layers": layers, "d": d, **out}
        gb = {m: sum(v[k] for k in ("params", "pool", "rows")) / 1e9 for m, v in out.items()}
        print(f"phase 22e: {cfg.name} at {layers} layers (D = {d:,}), params + pool + (4, D_rank) "
              f"f32 rows a rank at (data {TP_DATA_RANKS}, model {TP_MODEL}): {gb['tp']:.2f} GB "
              f"against {gb['replicated']:.2f} GB at model 1; the recurrent states "
              f"{out['tp']['split_states'] / 1e6:.2f} MB a rank, 1/{TP_MODEL} of "
              f"{out['replicated']['split_states'] / 1e6:.2f} MB (computed from the shapes, not "
              f"measured)")
    print(json.dumps({"tp_family_rank_bytes": report, "pool": TPS_POOL,
                      "ranks": {"data": TP_DATA_RANKS, "model": TP_MODEL},
                      "source": "computed from the shapes on the meta device, not measured"}))


def tp_families(dev, card: str, served, firsts):
    """Phase 22: 22a-22e; returns the launches of 22b's, 22c's and 22d's
    runs (each launch of 22b and 22c held bitwise on its own rows)."""
    t0 = time.perf_counter()
    tp_family_parity(dev)
    print(f"phase 22a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = {"tp_families_serve": tp_family_serving(dev, card, served)}
    print(f"phase 22b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["tp_frontends_train"] = tp_frontend_training(dev, card, firsts)
    print(f"phase 22c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["remat"] = remat_cell(dev, card)
    print(f"phase 22d: {time.perf_counter() - t0:.1f} s")
    tp_family_memory()
    return out


# ------------------ phase 23: fsdp × tensor parallelism, sequence parallelism,
# the codecs and randomized attacks on the model axis
#
# Everything runs in process at make_debug_mesh(4, 2), each layer's two
# model ranks in turn on the one card: NCCL refuses two ranks on one GPU,
# so the process group (data 2, model 2) is carried by the gloo tests
# (tests/test_torch_tp_fsdp.py, test_torch_seq_parallel.py,
# test_torch_tp_codecs.py).  (a) fsdp and (b) seq_parallel on 15b's cell
# (llama3.2-3b widths, 8 of 28 layers, bf16, m = 4, batch 8, seq 128,
# AdamW 1e-4, gather median under alie 0.25, remat off), one window of 2
# steps each, held bitwise against 20b's model-2 median run's first window
# (TP23_REF); (c) the codecs and (d) gauss at 15b's widths cut to
# CODEC23_LAYERS layers (the codec's and the noise's full-width f32
# temporaries beside the step's buffers: see PERF.md section 4); (e) the
# adapter at (4, 2) on 21c's granite-moe cell cut to ADAPT23_LAYERS layers
# (the (4, D) f32 rows with int8's and gauss's temporaries do not fit at
# 21b's llama width); (f) per-rank bytes from the shapes.

TP23_REF = {}  # filled by 20b's median model-2 run
TP23_STEPS = TP_DS  # one window, 20b's first (4 steps before phase 25)
CODEC23_LAYERS, CODEC23_D = 2, 989_346_816
# 23c / 23d's steps, one window (4 before the script was cut to run well
# inside its time limit)
CODEC23_STEPS = 2
CODEC23_RUNS = ("int8", "count_sketch", "topk")
ADAPT23_LAYERS, ADAPT23_D = 4, 314_719_232
ADAPT23_REQUESTS = 24
ADAPT23_RUNS = (("int8", dict(compression="int8")),
                ("gauss", dict(grad_attack="gauss", grad_alpha=TRAIN_ALPHA)))


def digest_calls(out: list):
    """Patch ``aggregators.aggregate_leaves`` so that each call appends its
    inputs' per-row multiset digest to ``out``: each row's sum of its elements' bit patterns (as signed
    integers of the element's width) and of their wrapped squares, over
    every leaf of the call, (m, 2) int64 on the card.  Integer sums do not
    depend on the order of the columns, so two layouts of the same rows (a
    reduce-scatter's buckets, a gather's leaves) digest alike.  Returns
    the undo."""
    import torch

    from repro_torch.core import aggregators

    real = aggregators.aggregate_leaves

    def digested(leaves, method, beta=0.1):
        total = None
        for x in leaves:
            m = x.shape[0]
            v = x.reshape(m, -1).view({2: torch.int16, 4: torch.int32}[x.element_size()])
            # 16 column blocks: a sum widens its block to int64 first
            for b in torch.tensor_split(v, 16, dim=1):
                d = torch.stack([b.sum(dim=1), (b * b).sum(dim=1)], dim=1)
                total = d if total is None else total + d
        out.append(total)
        return real(leaves, method, beta)

    aggregators.aggregate_leaves = digested
    return lambda: setattr(aggregators, "aggregate_leaves", real)


def step_digests(calls: list, steps_n: int, keep: int) -> list:
    """The first ``keep`` steps' digests (host) of a run of ``steps_n``
    steps, each step's calls summed (the calls split evenly over the
    steps: the runs here make the same calls every step)."""
    check(len(calls) % steps_n == 0 and calls, f"{len(calls)} aggregation calls in "
                                               f"{steps_n} steps")
    per = len(calls) // steps_n
    return [sum(calls[i * per + j] for j in range(per)).cpu() for i in range(keep)]


def tp23_train(dev, card: str, mode: str, seq_parallel: bool, label: str, ref: dict):
    """Phase 23a / 23b: 15b's cell at make_debug_mesh(4, 2) with ``mode`` and
    ``seq_parallel``, TP23_STEPS steps in one window under the sync-debug
    "error" mode, the counters zeroed just before and read just after;
    every aggregation call held bitwise against its plain version on its
    own rows and digested; the window's loss, the digests and the params
    after it held bitwise against ``ref`` (23a: 20b's median model-2 run,
    TP23_REF; 23b: :func:`tp23_rows_reference`).  Then one more step (not
    kept) timed with its split and the model-axis sums
    (:func:`tp_step_split`), and for 23a a profile of it.  Returns the
    launches."""
    import math

    import torch

    from repro_torch.kernels import select_codegen

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves

    cfg = serve_cfg(tiny=False)
    run = f"{mode} seq_parallel={seq_parallel}"
    check(ref.get("params") is not None, f"{label}: {ref.get('name')}: the reference is missing")
    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, TP_MODEL, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=TP23_STEPS, device_steps=TP_DS)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=TRAIN_BETA,
                          param_mode=mode, seq_parallel=seq_parallel, remat=False,
                          attn_chunk=0)
    atk = AttackConfig("alie", TRAIN_ALPHA)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    digests = []
    _reset_launches()  # zeroed just before this run
    undo = [sync_free_windows(), digest_calls(digests)]
    t0 = time.perf_counter()
    try:
        with HeldAggregation(dev) as held:
            result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk)
    finally:
        for u in reversed(undo):
            u()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()  # read just after it
    peak = torch.cuda.max_memory_allocated()
    pieces = fsdp_pieces(cfg, mesh) if mode == "fsdp" else len(tree_leaves(
        result.state["params"]))
    per_step = math.ceil(pieces / select_codegen.MAX_LEAVES)
    check(held.held == held.calls == len(digests) == TP23_STEPS,
          f"{label} {run}: {held.held} of {held.calls} aggregation calls held, "
          f"{len(digests)} digested")
    check(launches["median"] == TP23_STEPS * per_step and all(
        v == 0 for k, v in launches.items() if k != "median"),
        f"{label} {run}: launches {launches}, want {per_step} a step over {pieces} leaves")
    got = step_digests(digests, TP23_STEPS, TP23_STEPS)
    same_inputs = all(torch.equal(a, b) for a, b in zip(got, ref["digests"]))
    mism = sum(int((a != b.to(dev)).sum()) for a, b in
               zip(tree_leaves(result.state["params"]), ref["params"]))
    loss = result.history[0]["loss"]
    check(loss == ref["loss"] and same_inputs and mism == 0,
          f"{label} {run}: against {ref['name']}: loss {loss} / {ref['loss']}, "
          f"aggregation inputs {same_inputs}, {mism} parameter mismatches")
    if seq_parallel:
        check(result.history[0]["grad_norm"] == ref["grad_norm"],
              f"{label}: grad norm {result.history[0]['grad_norm']} / {ref['grad_norm']}")
    batch = {k: v[0] for k, v in trainer.stack_window_batches(
        dcfg, TP23_STEPS, 1, mesh, atk, cfg).items()}
    split = tp_step_split(cfg, pcfg, mesh, atk, result.state, batch, TP23_STEPS)
    line = {"tp23_train": run, "label": label, "layers": cfg.n_layers, "steps": TP23_STEPS,
            "loss": loss, "grad_norm": result.history[0]["grad_norm"],
            "aggregation_calls": len(digests), "launches": launches,
            "aggregation_leaves_per_step": pieces,
            "b1_launches_per_step": launches["median"] / TP23_STEPS,
            "first_window_s": result.compile_s, "run_wall_s": wall, "split_ms": split,
            "max_memory_allocated_gb": peak / 1e9, "card": card}
    msg = ""
    if label == "23a":
        sb = steps.make_step_body(cfg, pcfg, mesh, get_optimizer("adamw", TRAIN_LR), atk)
        prof = profile_summary(lambda: sb.body(result.state["params"],
                                               result.state["opt_state"], batch,
                                               TP23_STEPS, 0),
                               split["step_ms"], top=10, names=("leaf_select_kernel",))
        print(json.dumps({"profile_tp23_step": run, **prof}))
        line.update(device_busy_share=prof["device_busy_share"],
                    launches_per_step=prof["launches"])
        msg = f", {prof['launches']} launches, busy {prof['device_busy_share']:.3f}"
        del sb
    if seq_parallel:  # beside 20b's run, whose norms take the whole residual
        line["against_20b"] = {"loss": TP23_REF["loss"], "grad_norm": TP23_REF["grad_norm"],
                               "loss_rel": abs(loss - TP23_REF["loss"]) / TP23_REF["loss"]}
        msg += (f"; against 20b's run (whole-residual norms) loss {TP23_REF['loss']:.6f}, "
                f"relative {line['against_20b']['loss_rel']:.2e}")
    print(json.dumps({"tp23": line}))
    print(f"phase {label}: {run} at (4, {TP_MODEL}): {TP23_STEPS} steps bitwise {ref['name']} "
          f"(loss {loss:.6f}, {len(digests)} aggregation calls' input "
          f"digests, params); step {split['step_ms']:.1f} ms (grads "
          f"{split['worker_grads_ms']:.1f} with model-axis sums {split['model_sums_ms']:.1f}, "
          f"reduce-scatter {split['reduce_scatter_ms']:.1f}, gather agg "
          f"{split['aggregate_ms']:.1f}, AdamW {split['update_ms']:.1f}){msg}, "
          f"one aggregation call a step ({per_step} B1 launch(es) over {pieces} leaves), peak "
          f"{peak / 1e9:.2f} GB")
    del result, held, batch
    torch.cuda.empty_cache()
    return launches


def rows_norms():
    """Patch the transformer's block norm so that a run without
    seq_parallel norms the blocks' residual a model rank's rows at a time
    (``transformer._rows_norm``, the form seq_parallel runs it in; the
    program's own path without seq_parallel norms the whole residual, and
    autograd then adds the residual's gradients in another order).
    Returns the undo."""
    from repro_torch.models import transformer as T

    real = T._norm
    T._norm = lambda ctx, x, w, eps: (T._rows_norm(ctx, x, w, eps) if ctx.seq_len
                                      else real(ctx, x, w, eps))
    return lambda: setattr(T, "_norm", real)


def tp23_rows_reference(dev) -> dict:
    """Phase 23b's reference: 20b's replicated model-2 run of TP23_STEPS
    steps (one window, every aggregation call held against its plain
    version and digested) with the block norms in seq_parallel's per-rank
    form (:func:`rows_norms`): its loss, grad norm, digests and params
    (host), which 23b's seq_parallel run must equal bitwise."""
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import trainer
    from repro_torch.tree import tree_leaves

    cfg = serve_cfg(tiny=False)
    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, TP_MODEL, device=dev)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=TRAIN_BETA,
                          remat=False, attn_chunk=0)
    tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=TP23_STEPS, device_steps=TP_DS)
    digests = []
    undo = [sync_free_windows(), digest_calls(digests), rows_norms()]
    try:
        with HeldAggregation(dev) as held:
            result = trainer.train_loop(cfg, pcfg, tcfg, mesh,
                                        dcfg=DataConfig(vocab=cfg.vocab, **TRAIN_DATA),
                                        attack=AttackConfig("alie", TRAIN_ALPHA))
    finally:
        for u in reversed(undo):
            u()
    check(held.held == held.calls == TP23_STEPS, f"23b reference: {held.held} of "
                                                 f"{held.calls} aggregation calls held")
    ref = {"name": "the replicated model-2 run with seq_parallel's per-rank norms",
           "loss": result.history[0]["loss"], "grad_norm": result.history[0]["grad_norm"],
           "digests": step_digests(digests, TP23_STEPS, TP23_STEPS),
           "params": [t.cpu() for t in tree_leaves(result.state["params"])]}
    del result
    torch.cuda.empty_cache()
    return ref


def _gen_copy(gen):
    """A generator in ``gen``'s state (None stays None)."""
    import torch

    if gen is None:
        return None
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _same_tree(a, b) -> bool:
    import torch

    from repro_torch.tree import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_digest(*trees):
    """Int64 digests of every tensor of ``trees`` on the card: the sums of
    its elements' bit patterns over 16 blocks and of their wrapped
    squares (:func:`digest_rows` of the tensor as one row)."""
    import torch

    from repro_torch.tree import tree_leaves

    return torch.cat([digest_rows(t.reshape(1, -1))[0] for tree in trees
                      for t in tree_leaves(tree) if t is not None])


def held_codec(name: str, label: str, counts: dict):
    """Patch ``compression.compress_tree`` (the codec of one worker's whole
    gradient, as ``compress_workers`` calls it) so that every call is held
    against a rerun of itself: ``compress_tree`` on the same rows with a
    generator in the same state, run first and digested
    (:func:`tree_digest`), its outputs freed before the call itself, whose
    decoded rows and residual must digest alike.  In process the model-2
    step's codec call is model 1's (the global view's rows are whole: no
    gather, no cut), so this holds the card's determinism, which a process
    group needs (each model rank of a worker runs the codec on the same
    gathered rows); the gather and cut over the model axis are held by the
    gloo tests (tests/test_torch_tp_codecs.py).  Returns the undo."""
    import torch

    from repro_torch.rounds import compression as comp_lib

    real = comp_lib.compress_tree

    def held(n, tree, *, generator=None, draw=None, residual=None):
        want = tree_digest(*real(n, tree, generator=_gen_copy(generator), draw=draw,
                                 residual=residual))
        torch.cuda.empty_cache()
        hat, new = real(n, tree, generator=generator, draw=draw, residual=residual)
        check(bool(torch.equal(tree_digest(hat, new), want)),
              f"{label} {name}: a worker's decoded rows differ from the codec's rerun")
        counts["held"] += 1
        return hat, new

    comp_lib.compress_tree = held
    return lambda: setattr(comp_lib, "compress_tree", real)


def held_attack(label: str, counts: dict):
    """Patch the strategies' gradient attack so that every payload is held
    bitwise against a rerun as model 1 draws it: the same attack on the
    same rows with a generator in the same state and no model shard
    (``whole=None``).  In process the model-2 payload is drawn over the
    global view's whole leaves already, so this too holds the card's
    determinism; the whole draw and its cut on a process group's ranks
    are held by the gloo tests.  Returns the undo."""
    import torch

    from repro_torch.core import distributed as D

    real = D.apply_gradient_attack

    def held(cfg, stacked, mask, *, generator=None, row_sum=None, whole=None, **kw):
        gen2 = _gen_copy(generator)
        out = real(cfg, stacked, mask, generator=generator, row_sum=row_sum, whole=whole, **kw)
        want = real(cfg, stacked, mask, generator=gen2, **kw)
        check(bool(torch.equal(out, want)), f"{label}: a payload differs from the model-1 draw")
        counts["held"] += 1
        return out

    D.apply_gradient_attack = held
    return lambda: setattr(D, "apply_gradient_attack", real)


def tp23_codec_run(dev, card: str, cfg, name: str, attack: str, label: str):
    """One run of phase 23c / 23d on ``cfg`` at make_debug_mesh(4, 2):
    CODEC23_STEPS steps of gather median (beta 0.25) under ``attack`` alpha
    0.25 with the codec ``name`` (or none), through ``make_train_step``
    (``topk``, which carries a residual, through the trainer's window), the
    counters zeroed just before and read just after; every codec call or
    payload held against a rerun of its model-1 function (:func:`held_codec`,
    :func:`held_attack`), every aggregation call against its plain version
    on its own rows.  Returns the launches."""
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps, trainer
    from repro_torch.optim.optimizers import get_optimizer

    mesh = mesh_lib.make_debug_mesh(TRAIN_WORKERS, TP_MODEL, device=dev)
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    pcfg = ParallelConfig(agg_method="median", agg_strategy="gather", agg_beta=TRAIN_BETA,
                          remat=False, attn_chunk=0, compression=name)
    atk = AttackConfig(attack, TRAIN_ALPHA)
    opt = get_optimizer("adamw", TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts = {"held": 0}
    _reset_launches()  # zeroed just before this run
    undo = [held_codec(name, label, counts) if name != "none" else held_attack(label, counts)]
    t0 = time.perf_counter()
    try:
        with HeldAggregation(dev) as held:
            if name == "topk":
                tcfg = TrainConfig(optimizer="adamw", lr=TRAIN_LR, steps=CODEC23_STEPS,
                                   device_steps=CODEC23_STEPS)
                result = trainer.train_loop(cfg, pcfg, tcfg, mesh, dcfg=dcfg, attack=atk)
                losses = [h["loss"] for h in result.history]
                del result
            else:
                state = trainer.init_state(cfg, mesh, opt, seed=0, pcfg=pcfg)
                step = steps.make_train_step(cfg, pcfg, mesh, opt, atk)
                batches = trainer.stack_window_batches(dcfg, 0, CODEC23_STEPS, mesh, atk,
                                                       cfg)
                params, opt_state, losses = state["params"], state["opt_state"], []
                for i in range(CODEC23_STEPS):
                    params, opt_state, met = step(params, opt_state,
                                                  {k: v[i] for k, v in batches.items()}, i)
                    losses.append(float(met["loss"]))
                del state, params, opt_state, batches
    finally:
        for u in reversed(undo):
            u()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()  # read just after it
    peak = torch.cuda.max_memory_allocated()
    run = f"{name}/{attack}"
    want_held = CODEC23_STEPS * TRAIN_WORKERS if name != "none" else None
    check(counts["held"] > 0 and (want_held is None or counts["held"] == want_held),
          f"{label} {run}: {counts['held']} codec calls / payloads held")
    check(held.held == held.calls == CODEC23_STEPS and launches["median"] == CODEC23_STEPS
          and all(v == 0 for k, v in launches.items() if k != "median"),
        f"{label} {run}: launches {launches}, {held.held} of {held.calls} aggregates held")
    check(all(v == v and abs(v) < 1e4 for v in losses), f"{label} {run}: {losses}")
    line = {"tp23_codec": run, "label": label, "layers": cfg.n_layers,
            "d": CODEC23_D, "steps": CODEC23_STEPS, "losses": losses,
            "held": counts["held"], "launches": launches, "run_wall_s": wall,
            "step_s": wall / CODEC23_STEPS, "max_memory_allocated_gb": peak / 1e9, "card": card}
    print(json.dumps({"tp23": line}))
    what = ("worker messages' decoded rows (and residuals) digest alike on a rerun of the "
            "codec from the same generator state" if name != "none" else
            "payloads bitwise a rerun of the draw")
    print(f"phase {label}: {run} at (4, {TP_MODEL}), {cfg.n_layers} layers: {CODEC23_STEPS} "
          f"steps in {wall:.1f} s, {counts['held']} {what} (the card's determinism: in process the "
          f"model-2 call is model 1's on whole rows; the model axis's gather / cut / whole draw "
          f"is held by the gloo tests), one B1 launch a step held on its rows, "
          f"peak {peak / 1e9:.2f} GB")
    torch.cuda.empty_cache()
    return launches


def tp23_adapter(dev, card: str):
    """Phase 23e: the adapter at make_debug_mesh(4, 2) on 21c's granite-moe
    cell cut to ADAPT23_LAYERS layers (bf16), median: one stream of
    ADAPT23_REQUESTS requests a run of ADAPT23_RUNS (int8; gauss alpha
    0.25), adapting every 8 ticks, the counters zeroed just before each
    run and read just after; >= 1 round, each round's codec or payload on
    its (4, D) f32 rows held bitwise against a rerun of the model-1
    function on the same rows (a generator in the same state: in process
    the adapter's rows are the global ones, so this holds the card's
    determinism; the gather / cut of a process group's columns is held by
    the gloo tests), and its aggregate against the plain version.  Returns
    the launches."""
    import dataclasses

    import torch

    from repro_torch.attacks import engine as atk_engine
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer as T
    from repro_torch.rounds import compression as comp_lib
    from repro_torch.serve.adapt import AdaptConfig, FeedbackAdapter
    from repro_torch.serve.engine import ServeConfig, ServeEngine, serve_stream
    from repro_torch.serve.traffic import VirtualUsers

    class HeldAdapter(FeedbackAdapter):
        """Holds each round's aggregate against the plain version on the
        payload the round aggregated (the codec's or the attack's output)."""

        last = None

        def run_round(self, batch):
            entry = super().run_round(batch)
            trim = int(self.acfg.beta * self.last.shape[0])
            hold_on_rows(self.acfg.method, self.last, self.state["prev_agg"], trim, "23e")
            self.held += 1
            self.last = None
            return entry

    cfg = dataclasses.replace(get_config("granite_moe_1b_a400m"), n_layers=ADAPT23_LAYERS)
    check(T.count_params(cfg) == ADAPT23_D, f"23e: {T.count_params(cfg)} parameters")
    mesh = mesh_lib.make_debug_mesh(4, TP_MODEL, device=dev)
    scfg = ServeConfig(slots=4, prompt_len=16, max_new=16)
    users = VirtualUsers(serve_traffic(cfg, scfg))
    reqs = users.sample_requests(ADAPT23_REQUESTS)
    params = T.init_params(cfg, seed=0, device=dev)
    total = {}
    for run, kw in ADAPT23_RUNS:
        counts = {"held": 0}
        real_c, real_a = comp_lib.compress_rows, atk_engine.apply_to_rows

        def held_c(name, rows, *, generator=None, draw=None, residual=None):
            gen2 = _gen_copy(generator)
            out, res = real_c(name, rows, generator=generator, draw=draw, residual=residual)
            want, _ = real_c(name, rows, generator=gen2, draw=draw, residual=residual)
            check(bool(torch.equal(out, want)), f"23e {run}: decoded rows differ")
            counts["held"] += 1
            adapter.last = out
            return out, res

        def held_a(attack, stacked, mask, *, generator=None, whole=None, **k):
            gen2 = _gen_copy(generator)
            out = real_a(attack, stacked, mask, generator=generator, whole=whole, **k)
            want = real_a(attack, stacked, mask, generator=gen2, **k)
            check(bool(torch.equal(out, want)), f"23e {run}: attacked rows differ")
            counts["held"] += 1
            adapter.last = out
            return out

        engine = ServeEngine(cfg, scfg, params, mesh)
        acfg = AdaptConfig(adapt_every=8, batch_per_shard=2, optimizer="sgd", lr=0.1,
                           method="median", beta=0.2, **kw)
        adapter = HeldAdapter(cfg, acfg, users, params, mesh=mesh)
        adapter.held = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()  # zeroed just before this run
        comp_lib.compress_rows, atk_engine.apply_to_rows = held_c, held_a
        t0 = time.perf_counter()
        try:
            done = serve_stream(engine, reqs, adapter=adapter)
        finally:
            comp_lib.compress_rows, atk_engine.apply_to_rows = real_c, real_a
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()  # read just after it
        peak = torch.cuda.max_memory_allocated()
        rounds = adapter.rounds_done
        check(len(done) == ADAPT23_REQUESTS and rounds >= 1 and counts["held"] == rounds
              and adapter.held == rounds and launches["median"] == rounds
              and all(v == 0 for k, v in launches.items() if k != "median"),
              f"23e {run}: {len(done)} served, {rounds} rounds, {counts['held']} held, "
              f"launches {launches}")
        _add(total, launches)
        print(json.dumps({"tp23_adapt": run, "model": cfg.name, "layers": cfg.n_layers,
                          "d": ADAPT23_D, "requests": len(done), "rounds": rounds,
                          "held": counts["held"], "launches": launches, "stream_wall_s": wall,
                          "grad_norms": [h["grad_norm"] for h in adapter.history],
                          "max_memory_allocated_gb": peak / 1e9, "card": card}))
        print(f"phase 23e: {cfg.name} ({cfg.n_layers} layers) at (4, {TP_MODEL}) with {run}: "
              f"{len(done)} requests, {rounds} round(s) in {wall:.1f} s, each round's "
              f"{'decoded' if run == 'int8' else 'attacked'} (4, {ADAPT23_D:,}) rows bitwise "
              f"a rerun of the model-1 function (the card's determinism; the columns' gather / "
              f"cut is held by the gloo tests), one B1 launch a round held, "
              f"peak {peak / 1e9:.2f} GB")
        del engine, adapter
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return total


def tp23_memory():
    """Phase 23f: the bytes a rank holds of llama3.2-3b at its 28 layers over
    (data TP_DATA_RANKS, model TP_MODEL) under fsdp × TP (params + AdamW's
    two moments) against fsdp alone (model 1) and TP alone (replicated over
    the workers), and the residual stream a rank keeps between the layers
    with and without seq_parallel at train_4k (seq 4096, 64 rows a worker,
    bf16, one residual a layer): computed from the shapes, not measured."""
    import math

    import torch

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.core import distributed as D
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.tree import tree_leaves

    cfg = get_config("llama3_2_3b")
    opt = get_optimizer("adamw", TRAIN_LR)

    def rank_bytes(model, fsdp):
        mesh = mesh_lib.Mesh(("data", "model"), (TP_DATA_RANKS, model), torch.device("cpu"),
                             D.InProcessAxes({"data": TP_DATA_RANKS, "model": model}, "cpu"),
                             rank=0, per_rank=True)
        params = (steps.abstract_params_fsdp if fsdp else steps.abstract_params)(cfg, mesh)
        state = opt.init(params)
        return sum(t.numel() * t.element_size() for t in tree_leaves((params, state)))

    out = {"fsdp_tp": rank_bytes(TP_MODEL, True), "fsdp": rank_bytes(1, True),
           "tp": rank_bytes(TP_MODEL, False), "replicated": rank_bytes(1, False)}
    check(out["fsdp"] / TP_MODEL <= out["fsdp_tp"] < out["fsdp"] / TP_MODEL * 1.01
          and out["tp"] / TP_DATA_RANKS <= out["fsdp_tp"] < out["tp"] / TP_DATA_RANKS * 1.01,
          f"23f: {out}")
    shape = INPUT_SHAPES["train_4k"]
    rows = shape.global_batch // TP_DATA_RANKS
    resid = cfg.n_layers * rows * shape.seq_len * cfg.d_model * 2
    sp = cfg.n_layers * rows * math.ceil(shape.seq_len / TP_MODEL) * cfg.d_model * 2
    gb = {k: v / 1e9 for k, v in out.items()}
    print(json.dumps({"tp23_rank_bytes": out, "residual_bytes": {"whole": resid, "seq_parallel": sp},
                      "layers": cfg.n_layers, "ranks": {"data": TP_DATA_RANKS, "model": TP_MODEL},
                      "train_4k": {"seq_len": shape.seq_len, "rows_a_worker": rows},
                      "source": "computed from the shapes on the meta device, not measured"}))
    print(f"phase 23f: llama3.2-3b (28 layers) params + AdamW moments a rank at (data "
          f"{TP_DATA_RANKS}, model {TP_MODEL}): fsdp × TP {gb['fsdp_tp']:.2f} GB against fsdp "
          f"alone {gb['fsdp']:.2f}, TP alone {gb['tp']:.2f}, replicated {gb['replicated']:.2f}; "
          f"the residual stream between layers at train_4k: {resid / 1e9:.2f} GB whole, "
          f"{sp / 1e9:.2f} GB with seq_parallel (computed from the shapes, not measured)")


def tp_step7(dev, card: str):
    """Phase 23: 23a-23f; returns the launches of each path (each launch
    held bitwise on its own rows)."""
    import dataclasses

    out = {}
    t0 = time.perf_counter()
    out["tp23_fsdp"] = tp23_train(dev, card, "fsdp", False, "23a",
                                  dict(TP23_REF, name="20b's replicated model-2 run"))
    print(f"phase 23a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ref = tp23_rows_reference(dev)
    out["tp23_seq_parallel"] = tp23_train(dev, card, "replicated", True, "23b", ref)
    del ref
    print(f"phase 23b: {time.perf_counter() - t0:.1f} s (its reference run included)")
    cfg = dataclasses.replace(serve_cfg(tiny=False), n_layers=CODEC23_LAYERS)
    from repro_torch.models import transformer as T

    check(T.count_params(cfg) == CODEC23_D, f"23c: {T.count_params(cfg)} parameters")
    t0 = time.perf_counter()
    out["tp23_codecs"] = {}
    for name in CODEC23_RUNS:
        _add(out["tp23_codecs"], tp23_codec_run(dev, card, cfg, name, "alie", "23c"))
    print(f"phase 23c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["tp23_gauss"] = tp23_codec_run(dev, card, cfg, "none", "gauss", "23d")
    print(f"phase 23d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["tp23_adapt"] = tp23_adapter(dev, card)
    print(f"phase 23e: {time.perf_counter() - t0:.1f} s")
    tp23_memory()
    return out


# --------- phase 24: serving a frontend configuration on the model axis, and
# the dry-run held against a real rank
TPFE_DECODE_STEPS = 16
TPFE_TOL = TPF_PARITY_TOL  # 22a's f32 limit for these configurations
TPFE_BATCH, TPFE_PROMPT = 4, 16
PLAN_ARCH = "llama3.2-3b"
PLAN_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
PLAN_PEAK = 70e9  # bytes a plan may peak at to run on one 80 GB card
# the shape 24b runs on the card's real tensors: prefill_32k, the rank held
# since the attention was gathered (its step then 40.4-41.0 s; phase 25c);
# train_4k, which plans under PLAN_PEAK too since the attention split, is
# planned and printed
PLAN_REAL = "prefill_32k"
PLAN_MEM_RTOL = 0.15
# the split mixers' decode on the single mesh: each rank's heads of the
# SSD state at model 16 (24b runs it beside llama's shape)
PLAN_MIXER = ("mamba2-2.7b", "decode_32k")


def tp_frontend_serving(dev):
    """Phase 24a: each frontend configuration's serving at (4, 2) against
    (4, 1), f32 at published widths and depth: the teacher-forced logits
    of the prefill (and whisper's decode steps) and the ms of each run."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    out = {}
    for arch in FRONTEND_ARCHS:
        cfg = dataclasses.replace(get_config(arch), dtype="float32")
        params = T.init_params(cfg, seed=0, device=dev)
        rng = np.random.default_rng(24)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (TPFE_BATCH, TPFE_PROMPT)),
                                 device=dev)
        fe = torch.randn((TPFE_BATCH, cfg.n_frontend_tokens, cfg.d_model),
                         generator=torch.Generator(device=dev).manual_seed(24), device=dev)
        decodes = TPFE_DECODE_STEPS if cfg.cross_attention else 0
        forced = torch.as_tensor(rng.integers(0, cfg.vocab, (decodes, TPFE_BATCH, 1)),
                                 device=dev)
        logits, ms = {}, {}
        for model in (1, TP_MODEL, 1, TP_MODEL):  # timed in turns; the second of each kept
            mesh = mesh_lib.make_debug_mesh(4, model, device=dev)
            prefill = steps.make_prefill_step(cfg, cache_len=TPFE_PROMPT + decodes, mesh=mesh)
            decode = steps.make_decode_step(cfg, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = prefill(params, tokens, fe)
            seq = [lg[:, 0]]
            for j in range(decodes):
                lg, cache = decode(params, forced[j], cache, TPFE_PROMPT + j)
                seq.append(lg[:, 0])
            torch.cuda.synchronize()
            ms[model] = (time.perf_counter() - t0) * 1e3
            logits[model] = torch.stack(seq).float()
            del cache, seq, lg
        err = float((logits[TP_MODEL] - logits[1]).abs().max() / logits[1].abs().max())
        check(bool(torch.isfinite(logits[TP_MODEL]).all()), f"24a {arch}: non-finite logits")
        check(err <= TPFE_TOL, f"24a {arch}: model-2 logits differ from model 1's by {err} "
                               f"(relative; limit {TPFE_TOL})")
        what = f"prefill + {decodes} decode steps" if decodes else "prefill"
        print(f"phase 24a: {arch} f32, {cfg.n_layers} layers, batch {TPFE_BATCH}, prompt "
              f"{TPFE_PROMPT}: {what} at make_debug_mesh(4, {TP_MODEL}) within {err:.3g} of "
              f"(4, 1)'s logits (relative; limit {TPFE_TOL}, 21a's serving limit "
              f"{TPS_LOGIT_TOL}); {ms[TP_MODEL]:.1f} ms at model {TP_MODEL}, {ms[1]:.1f} ms at "
              f"model 1")
        out[arch] = {"rel_err": err, "model2_ms": ms[TP_MODEL], "model1_ms": ms[1]}
        del params, logits
    return out


def _plan_spec(shape: str, real: bool = False, arch: str = PLAN_ARCH) -> dict:
    return {"arch": arch, "shape": shape, "mesh": "single", "real": real}


def _real_runs(specs) -> list:
    """Each (arch, shape) of ``specs`` run once on the card's real tensors
    under the fake group of 256 ranks, one after the other in one
    subprocess (one process start and CUDA context for all)."""
    import gc

    import torch

    from repro_torch.launch import dryrun

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks go back to the card
    return dryrun.plan_in_subprocess([_plan_spec(shape, real=True, arch=arch)
                                      for arch, shape in specs], timeout=600)


def _hold_rank(arch: str, shape: str, plan: dict, real: dict) -> float:
    """A real run of ``arch`` ``shape`` held against its ``plan``:
    ``max_memory_allocated`` within PLAN_MEM_RTOL of the planned peak, the
    roofline bound at most the step's time, the planned kernel launches;
    returns the memory's relative distance."""
    check(real.get("status") == "ok", f"24b: the real run of {arch} {shape} failed: "
                                      f"{real.get('error')} {real.get('trace', '')[-1500:]}")
    peak, want = real["max_memory_allocated"], plan["peak_memory_in_bytes"]
    rel = abs(peak - want) / want
    check(rel <= PLAN_MEM_RTOL, f"24b: {arch} {shape}: max_memory_allocated {peak} vs the "
                                f"plan's peak {want}: {rel:.3f} apart (limit {PLAN_MEM_RTOL})")
    check(plan["bound_s"] <= real["step_s"], f"24b: {arch} {shape}: the roofline bound "
                                             f"{plan['bound_s']} s is above the measured step "
                                             f"{real['step_s']} s")
    check(real["kernel_launches"] == plan["kernel_launches"],
          f"24b: {arch} {shape}: launches {real['kernel_launches']} != the plan's "
          f"{plan['kernel_launches']}")
    return rel


def dryrun_against_rank(card: str, plans, mixer_plan):
    """Phase 24b: PLAN_REAL's plan of PLAN_SHAPES' (``plans``, the dry-run
    records; it must peak under PLAN_PEAK), and PLAN_MIXER's plan
    (``mixer_plan``: mamba2-2.7b's decode_32k on the single mesh, the SSD on
    each rank's heads at model 16), each run once on the card's real
    tensors under the same fake group of 256 ranks and held against its
    plan (:func:`_hold_rank`); returns the real runs' kernel launches."""
    for shape, rec in zip(PLAN_SHAPES, plans):
        check(rec.get("status") == "ok", f"24b: the plan of {PLAN_ARCH} {shape} failed: "
                                         f"{rec.get('error')} {rec.get('trace', '')[-1500:]}")
        print(f"phase 24b: plan {PLAN_ARCH} {shape} single: peak "
              f"{rec['peak_memory_in_bytes'] / 1e9:.2f} GB, args "
              f"{rec['argument_size_in_bytes'] / 1e9:.2f} GB, bound {rec['bound_s']:.4f} s "
              f"({rec['dominant']}; compute {rec['compute_s']:.4f}, memory "
              f"{rec['memory_s']:.4f}, collective {rec['collective_s']:.4f} s), launches "
              f"{json.dumps(rec['kernel_launches'])}, planned in {rec['plan_s']} s")
    arch, mshape = PLAN_MIXER
    check(mixer_plan.get("status") == "ok", f"24b: the plan of {arch} {mshape} failed: "
                                            f"{mixer_plan.get('error')} "
                                            f"{mixer_plan.get('trace', '')[-1500:]}")
    chosen = PLAN_SHAPES.index(PLAN_REAL)
    shape, plan = PLAN_REAL, plans[chosen]
    check(plan["peak_memory_in_bytes"] < PLAN_PEAK,
          f"24b: {PLAN_ARCH} {shape} plans {plan['peak_memory_in_bytes'] / 1e9} GB, over "
          f"{PLAN_PEAK / 1e9} GB")
    real, mreal = _real_runs([(PLAN_ARCH, shape), PLAN_MIXER])
    rel = _hold_rank(PLAN_ARCH, shape, plan, real)
    mrel = _hold_rank(arch, mshape, mixer_plan, mreal)
    peak, want = real["max_memory_allocated"], plan["peak_memory_in_bytes"]
    skipped = [f"{s} ({p['peak_memory_in_bytes'] / 1e9:.1f} GB)"
               for s, p in zip(PLAN_SHAPES, plans) if p["peak_memory_in_bytes"] >= PLAN_PEAK]
    covered = sorted(plan["kernel_launches"]) or ["none: no kernel runs on this step"]
    print(f"phase 24b: {PLAN_ARCH} {shape} on the single mesh, rank 0 on the card under a "
          f"fake group of 256 ranks (collectives move no data; values not checked): "
          f"max_memory_allocated {peak / 1e9:.3f} GB vs planned peak {want / 1e9:.3f} GB "
          f"({rel * 100:.1f} % apart, limit {PLAN_MEM_RTOL * 100:.0f} %); step "
          f"{real['step_s']:.3f} s measured vs roofline bound {plan['bound_s']:.3f} s "
          f"({plan['bound_s'] / real['step_s'] * 100:.1f} % of it; {card}); launches "
          f"{json.dumps(real['kernel_launches'])} = planned; kernels covered: {covered}; "
          f"shapes whose plan does not fit under {PLAN_PEAK / 1e9:.0f} GB: "
          f"{skipped or 'none'}")
    print(f"phase 24b: {arch} {mshape} on the single mesh (the SSD on each rank's heads), the "
          f"same: max_memory_allocated {mreal['max_memory_allocated'] / 1e9:.3f} GB vs planned "
          f"peak {mixer_plan['peak_memory_in_bytes'] / 1e9:.3f} GB ({mrel * 100:.1f} % apart); "
          f"step {mreal['step_s']:.4f} s measured vs roofline bound "
          f"{mixer_plan['bound_s']:.4f} s; planned collectives "
          f"{json.dumps(mixer_plan['collectives'])}")
    keys = ("peak_memory_in_bytes", "argument_size_in_bytes", "bound_s", "compute_s",
            "memory_s", "collective_s", "kernel_launches", "flops", "bytes_accessed",
            "collectives")
    for name, p, r in ((shape, plan, real), (f"{arch} {mshape}", mixer_plan, mreal)):
        print(json.dumps({"dryrun_vs_rank": name, "plan": {k: p[k] for k in keys}, "real": r,
                          "card": card}))
    launches = dict(real["kernel_launches"])
    _add(launches, mreal["kernel_launches"])
    return launches, (shape, plan, real)


def frontend_tp_and_dryrun(dev, card: str, plans):
    """Phase 24: 24a, then 24b on ``plans`` (futures of PLAN_SHAPES' plans
    and PLAN_MIXER's, started on the CPU after phase 1); returns 24b's real
    runs' kernel launches and its llama3.2-3b (shape, plan, real run)."""
    t0 = time.perf_counter()
    tp_frontend_serving(dev)
    print(f"phase 24a: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    recs = [p.result() for p in plans]
    out = dryrun_against_rank(card, recs[:len(PLAN_SHAPES)], recs[len(PLAN_SHAPES)])
    print(f"phase 24b: {time.perf_counter() - t1:.1f} s")
    return out


# --------- phase 25: attention over each rank's kv-head group where the kv
# heads do not divide the model size (``padded``: the reference's uneven
# split, GSPMD's padding), in process: a layer's ranks one after the other
PAD_MODEL = 16  # 25a: llama3.2-3b's 8 kv heads over 16 ranks, ranks 8-15 holding none
PAD_LAYERS = 2
# 25a's batches: the loss and forward's 2 x 1,600 tokens outnumber d_model
# (3,072), so the all-to-alls move the weights' columns and wo's rows; the
# prompt's 2 x 64 and the decode steps move the products' columns
PAD_SEQ, PAD_PROMPT, PAD_DECODES = 1600, 64, 4
PAD_WHISPER_MODEL = 8  # 25b: whisper-small's 12 kv heads over 8 ranks (2 a rank, 6-7 none)
PAD_WHISPER_GRAD = (2, 32)  # 25b's loss batch (rows, tokens), the 1,500 frames each
# 24b's prefill_32k step with every rank computing every head from the
# gathered attention leaves (the plan before ``padded``; PERF.md section 5)
PAD_GATHERED_STEP_S = (40.4, 41.0)
# 25d: recurrentgemma-2b's one kv head at model 4 (2 x 1 < 4: ``gathered``,
# the reference's replication), its first attention layer at 3 layers
GATHER_MODEL, GATHER_LAYERS, GATHER_SEQ = 4, 3, 256


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)


def _grad_errs(params, loss_of, ctxs) -> dict:
    """The loss and every gradient leaf at each context of ``ctxs`` ({model:
    ShardCtx}, model 1 first): {"loss": relative, path: relative} of the
    last against the first, each relative to the model-1 value's largest
    magnitude."""
    import torch

    from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten_like

    got = []
    for ctx in ctxs.values():
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        loss = loss_of(tree_unflatten_like(params, leaves), ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        got.append((loss.detach(), [torch.zeros_like(x) if g is None else g
                                    for g, x in zip(grads, leaves)]))
        del leaves, loss, grads
    (l1, g1), (lm, gm) = got[0], got[-1]
    worst = {"loss": _rel(lm, l1)}
    for (path, _), a, b in zip(tree_leaves_with_path(params), gm, g1):
        worst[path] = _rel(a, b)
    return worst


def _against_model_one(dev, label: str, cfg, model: int, mode: str, seq: int, attn: str):
    """``cfg`` in process at make_debug_mesh(1, ``model``), its attention
    in ``mode``, against model 1: the loss and every gradient on 2 x
    ``seq`` tokens, the forward's logits, a prefill of PAD_PROMPT tokens
    and PAD_DECODES decode steps, and the cache of the attention layer
    ``attn``, each relative to the model-1 value's largest magnitude and
    held within TP_PARITY_TOL -> (the errors by name, the loss and
    gradients' s at both sizes, the forward and serving ms by model)."""
    import torch

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T

    mesh = mesh_lib.make_debug_mesh(1, model, device=dev)
    ctxs = {1: sharding.NULL_CTX, model: sharding.model_ctx(mesh)}
    got = ctxs[model].modes(cfg).attn
    check(got == mode, f"{label}: {cfg.name} at model {model}: {got}, not {mode}")
    params = T.init_params(cfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(25)
    batch = {k: torch.randint(0, cfg.vocab, (2, seq), generator=g).to(dev)
             for k in ("tokens", "labels")}
    prompt = torch.randint(0, cfg.vocab, (2, PAD_PROMPT), generator=g).to(dev)
    forced = torch.randint(0, cfg.vocab, (PAD_DECODES, 2, 1), generator=g).to(dev)
    t0 = time.perf_counter()
    worst = _grad_errs(params, lambda p, ctx: T.loss_fn(p, batch, cfg, kv_block=0, ctx=ctx,
                                                        remat=False), ctxs)
    grad_s = time.perf_counter() - t0
    out, ms = {}, {}
    for m, ctx in ctxs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, _ = T.forward(params, batch["tokens"], cfg, kv_block=0, ctx=ctx)
            lg, cache = T.prefill(params, prompt, cfg, kv_block=0,
                                  cache_len=PAD_PROMPT + PAD_DECODES, ctx=ctx)
            served = [lg[:, 0]]
            for j in range(PAD_DECODES):
                lg, cache = T.decode_step(params, forced[j], cache, PAD_PROMPT + j, cfg, ctx=ctx)
                served.append(lg[:, 0])
        torch.cuda.synchronize()
        ms[m] = (time.perf_counter() - t0) * 1e3
        out[m] = (logits, torch.stack(served), cache)
        del logits, served, lg
    worst["logits"] = _rel(out[model][0], out[1][0])
    worst["served logits"] = _rel(out[model][1], out[1][1])
    worst["cache"] = _rel(out[model][2]["blocks"][attn]["k"], out[1][2]["blocks"][attn]["k"])
    bad = {n: v for n, v in worst.items() if not v <= TP_PARITY_TOL}
    check(not bad, f"{label}: model {model} vs model 1 beyond {TP_PARITY_TOL}: {bad}")
    del params, out
    return worst, grad_s, ms


def _last_rank_pool_heads(dev, cfg, model: int, attn: str) -> int:
    """The kv heads of ``attn``'s cache in the slot pool of the last rank
    of a (1, ``model``) mesh (``init_slot_pool`` on that rank's view)."""
    from types import SimpleNamespace

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps

    mesh_pool = mesh_lib.Mesh(("data", "model"), (1, model), dev,
                              SimpleNamespace(coords={"data": 0, "model": model - 1}),
                              rank=model - 1, per_rank=True)
    pool = steps.init_slot_pool(cfg, 2, PAD_PROMPT, device=dev, mesh=mesh_pool)
    return pool["blocks"][attn]["k"].shape[-2]


def _worst_grad(worst: dict):
    grads = {n: v for n, v in worst.items() if n not in ("loss", "logits", "served logits",
                                                            "cache")}
    return max(grads.values()), max(grads, key=grads.get)


def padded_llama(dev):
    """Phase 25a: llama3.2-3b's widths at PAD_LAYERS layers in f32 at
    make_debug_mesh(1, PAD_MODEL) against model 1 (:func:`_against_model_one`:
    the forward's PAD_SEQ tokens a row move the weights, the prefill's and
    decode's the products); the cache a rank holds is its kv head's, none
    past rank 7."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import sharding

    cfg = dataclasses.replace(get_config("llama3_2_3b"), n_layers=PAD_LAYERS, dtype="float32")
    worst, grad_s, ms = _against_model_one(dev, "25a", cfg, PAD_MODEL, "padded", PAD_SEQ,
                                           "p0_attn")
    pool_heads = _last_rank_pool_heads(dev, cfg, PAD_MODEL, "p0_attn")
    check(pool_heads == 0, f"25a: the last rank's pool holds {pool_heads} kv heads")
    heads = [sharding.kv_heads(cfg.n_kv_heads, PAD_MODEL, r) for r in range(PAD_MODEL)]
    g_max, g_at = _worst_grad(worst)
    print(json.dumps({"padded_llama": {"layers": cfg.n_layers, "model": PAD_MODEL,
                                       "kv_heads": heads, "rel_err": worst,
                                       "tolerance": TP_PARITY_TOL}}))
    print(f"phase 25a: llama3.2-3b widths at {cfg.n_layers} layers, f32, make_debug_mesh(1, "
          f"{PAD_MODEL}) (padded attention: ranks 0-7 one kv head each, 8-15 none) "
          f"against model 1: loss {worst['loss']:.3g}, logits {worst['logits']:.3g} (2 x "
          f"{PAD_SEQ} tokens: the weights move), prefill + {PAD_DECODES} decode steps "
          f"{worst['served logits']:.3g} (the products move), cache {worst['cache']:.3g}, worst "
          f"gradient {g_max:.3g} ({g_at}; relative to the leaf's largest; tolerance "
          f"{TP_PARITY_TOL}); loss + grads {grad_s:.1f} s at both sizes, forward + serving "
          f"{ms[PAD_MODEL]:.1f} ms at model {PAD_MODEL}, {ms[1]:.1f} ms at model 1; the last "
          f"rank's slot pool holds 0 kv heads")
    torch.cuda.empty_cache()
    return worst


def gathered_recurrentgemma(dev):
    """Phase 25d: recurrentgemma-2b's widths at GATHER_LAYERS layers (rec,
    rec, attn) in f32 at make_debug_mesh(1, GATHER_MODEL) against model 1
    (:func:`_against_model_one`): one kv head over 4 ranks is ``gathered``,
    every rank computing every head from the whole leaves as the reference
    replicates them (2 x 1 < 4); the last rank's slot pool holds the kv
    head."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("recurrentgemma-2b"), n_layers=GATHER_LAYERS,
                              dtype="float32")
    worst, grad_s, ms = _against_model_one(dev, "25d", cfg, GATHER_MODEL, "gathered",
                                           GATHER_SEQ, "p2_attn")
    pool_heads = _last_rank_pool_heads(dev, cfg, GATHER_MODEL, "p2_attn")
    check(pool_heads == cfg.n_kv_heads, f"25d: the last rank's pool holds {pool_heads} kv heads")
    g_max, g_at = _worst_grad(worst)
    print(json.dumps({"gathered_recurrentgemma": {"layers": cfg.n_layers, "model": GATHER_MODEL,
                                                  "rel_err": worst,
                                                  "tolerance": TP_PARITY_TOL}}))
    print(f"phase 25d: recurrentgemma-2b widths at {cfg.n_layers} layers, f32, "
          f"make_debug_mesh(1, {GATHER_MODEL}) (gathered attention: its one kv head on every "
          f"rank) against model 1: loss {worst['loss']:.3g}, logits {worst['logits']:.3g} (2 x "
          f"{GATHER_SEQ} tokens), prefill + {PAD_DECODES} decode steps "
          f"{worst['served logits']:.3g}, cache {worst['cache']:.3g}, worst gradient "
          f"{g_max:.3g} ({g_at}; relative to the leaf's largest; tolerance {TP_PARITY_TOL}); "
          f"loss + grads {grad_s:.1f} s at both sizes, forward + serving "
          f"{ms[GATHER_MODEL]:.1f} ms at model {GATHER_MODEL}, {ms[1]:.1f} ms at model 1; the "
          f"last rank's slot pool holds {pool_heads} kv head")
    torch.cuda.empty_cache()
    return worst


def padded_whisper(dev):
    """Phase 25b: whisper-small at full depth in f32 at make_debug_mesh(1,
    PAD_WHISPER_MODEL) against model 1 (the encoder, cross-attention and
    decoder ``padded``: 12 kv heads over 8 ranks): the loss and every
    gradient on PAD_WHISPER_GRAD, and as 24a a prefill of TPFE_PROMPT tokens
    with TPFE_DECODE_STEPS teacher-forced decode steps, within TPFE_TOL
    (relative to the model-1 value's largest magnitude); each run's ms."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import sharding
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("whisper-small"), dtype="float32")
    mesh = mesh_lib.make_debug_mesh(1, PAD_WHISPER_MODEL, device=dev)
    ctxs = {1: sharding.NULL_CTX, PAD_WHISPER_MODEL: sharding.model_ctx(mesh)}
    modes = ctxs[PAD_WHISPER_MODEL].modes(cfg)
    check(modes.attn == "padded" and ctxs[PAD_WHISPER_MODEL].modes(T._enc_cfg(cfg)).attn
          == "padded", f"25b: whisper-small at model {PAD_WHISPER_MODEL}: {modes.attn}")
    params = T.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(25)
    gen = torch.Generator(device=dev).manual_seed(25)
    rows, seq = PAD_WHISPER_GRAD
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (rows, seq)), device=dev)
             for k in ("tokens", "labels")}
    batch["frontend"] = torch.randn((rows, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                                    device=dev)
    t0 = time.perf_counter()
    worst = _grad_errs(params, lambda p, ctx: T.loss_fn(p, batch, cfg, kv_block=0, ctx=ctx,
                                                        remat=False), ctxs)
    grad_s = time.perf_counter() - t0
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (TPFE_BATCH, TPFE_PROMPT)), device=dev)
    fe = torch.randn((TPFE_BATCH, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                     device=dev)
    forced = torch.as_tensor(rng.integers(0, cfg.vocab, (TPFE_DECODE_STEPS, TPFE_BATCH, 1)),
                             device=dev)
    logits, ms = {}, {}
    for model in ctxs:
        m = mesh_lib.make_debug_mesh(1, model, device=dev)
        prefill = steps.make_prefill_step(cfg, cache_len=TPFE_PROMPT + TPFE_DECODE_STEPS, mesh=m)
        decode = steps.make_decode_step(cfg, m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = prefill(params, tokens, fe)
        seq_ = [lg[:, 0]]
        for j in range(TPFE_DECODE_STEPS):
            lg, cache = decode(params, forced[j], cache, TPFE_PROMPT + j)
            seq_.append(lg[:, 0])
        torch.cuda.synchronize()
        ms[model] = (time.perf_counter() - t0) * 1e3
        logits[model] = torch.stack(seq_)
        del cache, seq_, lg
    worst["served logits"] = _rel(logits[PAD_WHISPER_MODEL], logits[1])
    check(bool(torch.isfinite(logits[PAD_WHISPER_MODEL]).all()), "25b: non-finite logits")
    bad = {n: v for n, v in worst.items() if not v <= TPFE_TOL}
    check(not bad, f"25b: model {PAD_WHISPER_MODEL} vs model 1 beyond {TPFE_TOL}: {bad}")
    grads = {n: v for n, v in worst.items() if n not in ("loss", "served logits")}
    print(json.dumps({"padded_whisper": {"model": PAD_WHISPER_MODEL, "rel_err": worst,
                                         "tolerance": TPFE_TOL, "ms": ms}}))
    print(f"phase 25b: whisper-small f32, {cfg.n_layers} + {cfg.n_enc_layers} layers at "
          f"make_debug_mesh(1, {PAD_WHISPER_MODEL}) ({modes.attn}: ranks 0-5 two kv heads "
          f"each, 6-7 none) against model 1: loss {worst['loss']:.3g}, worst gradient "
          f"{max(grads.values()):.3g} ({max(grads, key=grads.get)}) on {rows} x {seq} tokens "
          f"and {cfg.n_frontend_tokens} frames ({grad_s:.1f} s at both sizes); prefill + "
          f"{TPFE_DECODE_STEPS} decode steps {worst['served logits']:.3g} (relative; limit "
          f"{TPFE_TOL}), {ms[PAD_WHISPER_MODEL]:.1f} ms at model {PAD_WHISPER_MODEL}, "
          f"{ms[1]:.1f} ms at model 1")
    del params, logits
    torch.cuda.empty_cache()
    return worst


def padded_rank(card: str, held):
    """Phase 25c: 24b's llama3.2-3b rank (``held``: its shape, plan and real
    run, already held to the plan by 24b) replanned with the attention on
    each rank's kv head: its step and peak beside the gathered plan's
    PAD_GATHERED_STEP_S."""
    shape, plan, real = held
    check(shape == "prefill_32k", f"25c: 24b ran {shape}, not prefill_32k")
    lo, hi = PAD_GATHERED_STEP_S
    print(f"phase 25c: {PLAN_ARCH} {shape} rank 0 on the single mesh, attention on its kv "
          f"head (padded): step {real['step_s']:.3f} s against {lo}-{hi} s with every head "
          f"computed from the gathered leaves ({hi / real['step_s']:.1f}x at most), bound "
          f"{plan['bound_s']:.3f} s ({plan['bound_s'] / real['step_s'] * 100:.1f} % of the "
          f"step); max_memory_allocated {real['max_memory_allocated'] / 1e9:.3f} GB vs planned "
          f"{plan['peak_memory_in_bytes'] / 1e9:.3f} GB; planned FLOPs {plan['flops']:.4g}, "
          f"model-axis collectives {json.dumps(plan['collectives'])}; {card}")


def padded_attention(dev, card: str, held):
    """Phase 25: 25a, 25b, 25c and 25d."""
    t0 = time.perf_counter()
    padded_llama(dev)
    print(f"phase 25a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    padded_whisper(dev)
    print(f"phase 25b: {time.perf_counter() - t0:.1f} s")
    padded_rank(card, held)
    t0 = time.perf_counter()
    gathered_recurrentgemma(dev)
    print(f"phase 25d: {time.perf_counter() - t0:.1f} s")


# the CLI phases, subprocesses on the card: started after phase 1 beside
# phases 2-4 (which time nothing), CLI_GROUPS_AT_ONCE groups at a time (a
# group's own processes start together), and read before phase 5's timings
CLI_GROUPS = (("6", fed_cli), ("14c", serve_cli), ("15d", train_cli),
              ("16c", family_serve_cli), ("17c + 17d", distributed_clis),
              ("21d", tp_serve_shim))
CLI_GROUPS_AT_ONCE = 3


def cli_batch():
    """CLI_GROUPS, CLI_GROUPS_AT_ONCE at a time; returns each group's label,
    lines to print and seconds, in CLI_GROUPS' order.  A failed check in a
    group exits the script when its result is read."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        lines = fn()
        return lines, time.perf_counter() - t0

    with ThreadPoolExecutor(CLI_GROUPS_AT_ONCE) as pool:
        futures = [(label, pool.submit(timed, fn)) for label, fn in CLI_GROUPS]
        return [(label, *f.result()) for label, f in futures]


# ------------------------------------ phase 26: the examples on the card

EX_LM_STEPS = 30  # the example's 300 steps cut for the script's time
EX_LM_PARAMS = 99_496_704  # demo-100m by count_params (the reference's too)
# the last of the 30 losses below the first by at least this much: a run on
# an H100 80GB HBM3 at 700 W read 10.5347 -> 5.2326 (a drop of 5.30); a
# model whose updates were dropped stays near ln(32000) = 10.37
EX_LM_DROP = 2.0
EX_STREAM_TOL = 1e-6  # added to a bin width: the card's rows vs a rerun of the solver
EX_ONE_ROUND_GAP = 0.03  # Table 4's claim: median above mean - 0.03 under random labels


def lm_example(dev, on_path):
    """Phase 26a: examples/torch_train_lm_robust.py's ``main`` on the card at
    full width (demo-100m, 99,496,704 params, bf16) on its 4 x 2 mesh for
    EX_LM_STEPS steps, the counters zeroed just before and read just
    after.  Holds: every loss and grad norm finite, the last loss below the
    first by EX_LM_DROP, B1's launches the code's count (a step: one
    aggregation call over the bucketed strategy's super-buckets,
    ``launches_for`` of their number; nothing else launches), the
    checkpoint restored on the card bitwise.  Returns the launches."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import load_extra, restore
    from repro_torch.core import distributed as D
    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_leaves_with_path

    lm = load_example("torch_train_lm_robust")
    check(T.count_params(lm.CFG) == EX_LM_PARAMS,
          f"26a: demo-100m has {T.count_params(lm.CFG):,} params, want {EX_LM_PARAMS:,}")
    ckpt = tempfile.mkdtemp(prefix="phase26_ckpt_")
    try:
        def run():
            torch.cuda.synchronize()
            robust_agg.reset_launches()  # zeroed just before the example
            H.reset_launches()
            out = run_printed("phase 26a", lm.main, ["--steps", str(EX_LM_STEPS),
                                                     "--ckpt", ckpt, "--device", str(dev)])
            torch.cuda.synchronize()
            return out, {**robust_agg.LAUNCHES, **H.LAUNCHES}  # read just after

        t0 = time.perf_counter()
        out, launches = on_path("phase 26a", run, lambda r: r[1])
        secs = time.perf_counter() - t0
        losses, norms = out["losses"], out["grad_norms"]
        check(len(losses) == len(norms) == EX_LM_STEPS, "26a: a step's metrics are missing")
        check(all(map(math.isfinite, losses + norms)), f"26a: not finite: {losses} {norms}")
        drop = losses[0] - losses[-1]
        print(f"phase 26a: loss {losses[0]:.4f} -> {losses[-1]:.4f} (drop {drop:.4f}, "
              f"limit {EX_LM_DROP}), |g| {norms[0]:.3f} -> {norms[-1]:.3f}; "
              f"{out['s_per_step']:.4f} s/step (the example's clock, first step "
              f"included), phase {secs:.1f} s")
        check(drop > EX_LM_DROP, f"26a: the loss fell {drop:.4f}, want > {EX_LM_DROP}")
        groups = D._coalesce_groups(tree_leaves(out["params"]))
        want = EX_LM_STEPS * robust_agg.launches_for(len(groups))
        print(f"phase 26a: B1 launches {launches['median']}, derived {want} "
              f"({EX_LM_STEPS} steps x launches_for({len(groups)} super-buckets)); "
              f"launches {json.dumps(launches)}")
        check(launches["median"] == want, f"26a: B1 launched {launches['median']}, want {want}")
        check(sum(launches.values()) == want, f"26a: other kernels launched: {launches}")
        like = {"params": out["params"]}
        got, step = restore(ckpt, like)
        same = all(a.dtype == b.dtype and a.device == b.device and compare(a, b)[0] == 0
                   for (_, a), (_, b) in zip(tree_leaves_with_path(got),
                                             tree_leaves_with_path(like)))
        extra = load_extra(ckpt)
        print(f"phase 26a: checkpoint step {step}, extra {extra}, restored on the card "
              f"bitwise: {same}")
        check(same and step == EX_LM_STEPS and extra == {"arch": "demo-100m", "agg": "median"},
              "26a: the checkpoint does not restore bitwise")
        return {"median": launches["median"]}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def one_round_example(dev, on_path):
    """Phase 26b: examples/torch_one_round_federated.py's ``main`` on the card
    at its defaults (m 10, n 500, d 784, 150 GD steps), the counters zeroed
    just before and read just after.  Holds: the median within
    EX_ONE_ROUND_GAP of the mean (Table 4's claim; at these defaults the
    median does not beat the mean in either package), the streaming median
    within one bin width of the exact one on the same rows, and the
    launches the code implies: B1 one (the median's two leaves in one
    call), B4 and B5 one a chunk of ``chunk_workers`` workers each.
    Returns the launches."""
    import torch

    from repro_torch.kernels import histogram_agg as H
    from repro_torch.kernels import robust_agg

    ex = load_example("torch_one_round_federated")

    def run():
        torch.cuda.synchronize()
        robust_agg.reset_launches()  # zeroed just before the example
        H.reset_launches()
        out = run_printed("phase 26b", ex.main, ["--device", str(dev)])
        torch.cuda.synchronize()
        return out, {**robust_agg.LAUNCHES, **H.LAUNCHES}  # read just after

    t0 = time.perf_counter()
    out, launches = on_path("phase 26b", run, lambda r: r[1])
    secs = time.perf_counter() - t0
    acc = out["acc"]
    check(acc["median"] > acc["mean"] - EX_ONE_ROUND_GAP and min(acc.values()) > 0.75,
          f"26b: accuracies {acc}")
    rows = torch.func.vmap(out["solver"])(out["shards"])
    worst = float("-inf")
    for k in ("w", "b"):
        r = rows[k].reshape(rows[k].shape[0], -1)
        width = (r.amax(0) - r.amin(0)) / ex.NBINS
        dev_ = (out["w"]["median_stream"][k] - out["w"]["median"][k]).reshape(-1).abs()
        worst = max(worst, float((dev_ - width).max()))
        check(bool((dev_ <= width + EX_STREAM_TOL).all()),
              f"26b: streaming median {k} beyond a bin width by {float((dev_ - width).max())}")
    chunks = -(-ex.M // ex.CHUNK_WORKERS)
    want = {"median": robust_agg.launches_for(len(out["w"]["median"])), "minmax": chunks,
            "histogram": chunks}
    print(f"phase 26b: accuracy mean {acc['mean']:.4f}, median {acc['median']:.4f}, "
          f"streaming {acc['median_stream']:.4f}; streaming - exact - bin width at most "
          f"{worst:.3g}; launches {json.dumps(launches)}, derived {json.dumps(want)}; "
          f"phase {secs:.1f} s")
    for name, n in want.items():
        check(launches[name] == n, f"26b: {name} launched {launches[name]}, want {n}")
    check(sum(launches.values()) == sum(want.values()), f"26b: other kernels: {launches}")
    return {k: launches[k] for k in want}


def examples_on_card(dev, card: str, on_path):
    """Phase 26: the examples' entry points on the card (the quickstart is
    phase 3)."""
    t0 = time.perf_counter()
    out = {"lm_example": lm_example(dev, on_path)}
    print(f"phase 26a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["one_round_example"] = one_round_example(dev, on_path)
    print(f"phase 26b: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script drives the CUDA port")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import moe_combine as MC
    from repro_torch.kernels import robust_agg

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {torch.cuda.get_device_name(0)}")
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import histogram_agg

    specs = select_specs()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # every nvcc started together
        built = pool.submit(histogram_agg.build)
        prepared = pool.submit(robust_agg.prepare, specs)
        libs = [built.result()]
        select_libs = prepared.result()
    histogram_agg.load()
    kinds = {k: sum(s[0] == k for s in specs) for k in ("median", "trimmed_mean",
                                                         "fused_median_trimmed")}
    print(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.1f} s: "
          f"{', '.join(lib.name for lib in libs)} and {len(specs)} order-statistic "
          f"programs ({json.dumps(kinds)}) in {len(select_libs)} libraries")
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"  ptxas ({lib.name.split('-')[0]}):", line.strip())
    check_spills(libs + select_libs, "phase 1")
    print(f"phase 1: most registers a kernel by program (med_ median, tm_ trimmed mean, "
          f"fu_ fused): {json.dumps(registers_by_program_kind(select_libs))}")

    from repro_torch.launch import dryrun

    # beside phases 2-4: phase 24b's plans on the CPU and the CLI batch
    side = ThreadPoolExecutor(len(PLAN_SHAPES) + 2)
    plans = [side.submit(dryrun.plan_in_subprocess, _plan_spec(s), 600) for s in PLAN_SHAPES]
    plans.append(side.submit(dryrun.plan_in_subprocess,
                             _plan_spec(PLAN_MIXER[1], arch=PLAN_MIXER[0]), 600))
    clis = side.submit(cli_batch)
    t0 = time.perf_counter()
    worst = kernel_sweep(dev, CNN_LEAF_SIZES)
    multi_leaf_sweep(dev, worst)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    worst.update(sketch_sweep(dev))
    print(f"phase 2b: {time.perf_counter() - t0:.1f} s")
    approx_repeatable(dev)
    quickstart(dev)

    def on_path(label, fn, counts_of):
        """fn() with its kernel inputs recorded; then every kernel that
        launched on it is held against its plain version on them."""
        with PathInputs() as rec:
            out = fn()
        held = rec.hold(label, worst)
        ran = {k for k, v in counts_of(out).items() if k in worst and v}
        check(ran <= held, f"{label}: {sorted(ran - held)} launched but not held on the "
                           f"path's inputs")
        return out

    mc_paths, mc_worst = {}, {}

    def mc_counted(phase: str, fn):
        """fn() with the combine's launches zeroed just before and read just
        after, and the first call of each shape it made held (CombineCalls)."""
        with CombineCalls() as rec:
            MC.reset_launches()
            out = fn()
            mc_paths[phase] = dict(MC.LAUNCHES)
        rec.hold(f"phase {phase}", mc_worst)
        return out

    launches = on_path("phase 4", lambda: main_path(dev), lambda c: c)
    cpu_agreement(dev)
    table2_linreg(dev)
    t0 = time.perf_counter()
    for label, lines, secs in clis.result():
        print("\n".join(lines))
        print(f"phase {label}: {secs:.1f} s (in the CLI batch)")
    print(f"CLI batch: read {time.perf_counter() - t0:.1f} s after phase 4 ended")
    t0 = time.perf_counter()
    rows = timings(dev, card)
    sketch_rows_ = sketch_timings(dev, card)
    cnn_step_time(dev)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pop, fed_launches = on_path("phase 6", lambda: fed_path(dev), lambda r: r[1])
    launches.update(fed_launches)
    fed_sketch_vs_exact(pop)
    fed_cpu_agreement(dev)
    fed_profile(pop)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    c1_on_card(dev, worst)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    # launches per kernel on each path this slice added, each path's counts
    # zeroed just before it and read just after
    new_paths = {}
    for phase, (path, fn) in enumerate((("table4_one_round", table4_one_round),
                                        ("one_round_streaming", one_round_at_scale),
                                        ("local_update", lambda d: local_update_cnn(d, card)),
                                        ("compressed_fed_rounds", compressed_fed_rounds),
                                        ("async_fed_rounds", async_fed_rounds),
                                        ("robustness_matrix", robustness_matrix)), 8):
        libs_before = len(robust_agg.select_libraries())
        t0 = time.perf_counter()
        new_paths[path] = on_path(f"phase {phase}", lambda: fn(dev), lambda c: c)
        print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        if phase >= 12:  # phase 1 prepared their programs (select_specs)
            check(len(robust_agg.select_libraries()) == libs_before,
                  f"phase {phase} built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    served = {}  # the tokens of 14b's and 16b's runs, for phase 21
    new_paths["serve"] = serving(dev, card, served)
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 14 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(training(dev, card, on_path))
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 15 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(mc_counted("16", lambda: families(dev, card, served)))
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mc_rows = combine_check(dev, card, mc_worst)
    print(f"phase 16e: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 16 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(distributed(dev, card, on_path))
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 17 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    firsts = {}  # 18b's first-window losses, for phase 22c
    new_paths.update(frontends(dev, card, on_path, firsts))
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 18 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(fsdp(dev, card, on_path))
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 19 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(mc_counted("20", lambda: tensor_parallel(dev, card, on_path)))
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 20 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(mc_counted("21", lambda: tp_serving(dev, card, served)))
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 21 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(tp_families(dev, card, served, firsts))
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 22 built order-statistic programs that phase 1 did not")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(mc_counted("23", lambda: tp_step7(dev, card)))
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 23 built order-statistic programs that phase 1 did not")
    t0 = time.perf_counter()
    new_paths["dryrun_vs_rank"], held = frontend_tp_and_dryrun(dev, card, plans)
    side.shutdown()
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    padded_attention(dev, card, held)
    print(f"phase 25: {time.perf_counter() - t0:.1f} s")
    libs_before = len(robust_agg.select_libraries())
    t0 = time.perf_counter()
    new_paths.update(examples_on_card(dev, card, on_path))
    print(f"phase 26: {time.perf_counter() - t0:.1f} s")
    check(len(robust_agg.select_libraries()) == libs_before,
          "phase 26 built order-statistic programs that phase 1 did not")
    late = [p for p in robust_agg.select_libraries() if p not in select_libs]
    check_spills(late, "programs built after phase 1")
    print(f"phase 1: {len(late)} order-statistic libraries were built after phase 1")

    # the TPU kernels replaced: median_pallas, trimmed_mean_pallas and
    # fused_median_trimmed_pallas
    lines = {"median": 76, "trimmed_mean": 101, "fused_median_trimmed": 126}
    kernels = []
    for name in lines:
        row = next(r for r in rows if r["kernel"] == name and r["shape"] == "cnn fc1 leaf")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/select_program.cuh",
            "generator": "src/repro_torch/kernels/select_codegen.py",
            "replaces": f"src/repro/kernels/robust_agg.py:{lines[name]}",
            "launches": launches[name], "leaves": launches[name + "_leaves"],
            "launches_new_paths": {p: c.get(name, 0) for p, c in new_paths.items()},
            "max_abs_err": worst[name], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    # minmax_pallas and histogram_pallas, timed at the federated chunk
    # (histogram with sums, as approx_trimmed_mean runs it)
    for name, line in (("minmax", 206), ("histogram", 254)):
        row = next(r for r in sketch_rows_ if r["kernel"] == name and r["shape"] == "fed chunk"
                   and r["with_sums"] == (name == "histogram"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/histogram_agg.cu",
            "replaces": f"src/repro/kernels/histogram_agg.py:{line}",
            "launches": launches[name],
            "launches_new_paths": {p: c.get(name, 0) for p, c in new_paths.items()},
            "max_abs_err": worst[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    # the combine, no TPU kernel's port: launches a phase on 16 (16a-16d:
    # granite and grok served and adapted, granite trained), 20 (20c,
    # split="experts"), 21 (21a, 21c: served and adapted at model 2) and 23
    # (23e: served and adapted), forward and backward in each
    print(json.dumps({"moe_combine_launches": mc_paths}))
    for phase, counts in mc_paths.items():
        check(counts["forward"] > 0 and counts["backward"] > 0,
              f"phase {phase}: the combine's kernels did not launch: {counts}")
    for row in mc_rows:
        kind = "backward" if row["kernel"].endswith("backward") else "forward"
        kernels.append({
            "name": row["kernel"], "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/moe_combine.cu", "replaces": None,
            "launches": sum(c[kind] for c in mc_paths.values()),
            "launches_new_paths": {p: c[kind] for p, c in mc_paths.items()},
            "max_rel_err": mc_worst[row["kernel"]], "ms": row["ms"],
            "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None})
    print(f"chip_smoke: phases 1-26 in {time.perf_counter() - t_script:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
