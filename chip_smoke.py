"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--profile [LABEL ...]]

Phases, each printing its own lines; any failure exits non-zero before the
result line:

1. the card: its name, and its name and power limit from nvidia-smi;
2. the build: every kernel of ``src/repro_torch/kernels/csrc`` compiled by
   nvcc for sm_90a (one process per source, in parallel), with the build
   seconds and the ``-Xptxas -v`` register/spill report;
3. the kernels: each kernel against its plain PyTorch version on the card,
   at n = 100,003 and at the trainer's largest bucket (155,582,464
   elements, W = 4): codes bitwise, e' rtol 1e-6 (into a fresh buffer and
   in place, as the trainer calls it), int8_acc rtol 1e-6 / atol 1e-5;
   sign_pack bytes (pads included) and sign_unpack values bitwise on inputs
   holding +-0.0 and NaN, sign_vote bitwise with 0/1 weights and rtol 1e-6
   with general ones; terngrad codes bitwise on an input holding +-0.0 and
   noise equal to p, tern_pack bytes (pads included) bitwise on int8 codes
   with values outside {-1, 0, 1}, tern_acc on random bytes (crumb 2
   included) bitwise with 0/1 weights and rtol 1e-6 with general ones;
   threshold's masked values (int32 views) and per-block kept counts
   bitwise at tau 0.0, 0.05 and 10.0 on an input holding +-0.0, NaN and
   +-inf; each timed with CUDA events beside its byte bound; and wkv6 (the
   RWKV6 recurrence) at (B, S, H, hd) = (1, 32, 1, 16), (2, 100, 2, 32),
   (1, 1, 32, 80), in f32 and bf16, at (2, 130, 4, 80) with w holding 0.0,
   1.0 and 1e-3, at a ragged (1, 1000, 32, 80) and at the server's shapes,
   decode (8, 1, 32, 80) and prefill (8, 1024, 32, 80), with bf16 r, k, v
   and u, a nonzero s0 and w in (0.4, 0.9): y within rtol 3e-4 / atol 3e-5
   (the reference's kernel test), sT bitwise on the recurrent design (S <
   32: decode) and within rtol 1e-4 / atol 1e-5 x max|sT| on the chunked
   tensor-core design (prefill), timed at the decode shape and at the
   prefill shape (the recurrent design beside the chunked one, in turns),
   the latter beside its bound, with the chunked design's registers,
   shared memory and resident CTAs per SM; the decode shape's call also as
   the kernel's own device time from torch.profiler, beside the host-bound
   call time, and at the training shape (2, 1024, 32, 80) beside its bound;
   and wkv6_bwd (wkv6's backward, no TPU counterpart: two launches,
   wkv6_bwd_states and wkv6_bwd) against its plain versions
   ref.wkv6_backward and ref.wkv6_backward_chunked and both against
   autograd through ref.wkv6, at the training shape (2, 1024, 32, 80) in
   bf16 and f32, a ragged S = 1000, S = 20, 1, 63, 64, 65 and 37 (a chunk
   is 64 steps), hd 80 and 64, w holding 0.0, 1.0 and 1e-3, nonzero s0 and
   dsT (absent twice): each gradient within rtol 1e-4 / atol 1e-5 x its
   largest magnitude, two calls bitwise alike, the boundary states of
   wkv6_bwd_states against ref.wkv6_bwd_states at the same tolerance;
   timed at the training shape in bf16 (the whole backward, and each
   launch alone) beside its bounds (``wkv6_bwd_bound``,
   ``wkv6_bwd_states_bound``), with both launches' registers, shared
   memory and resident CTAs per SM;
4. the trainer: qwen3-0.6b at full published width and depth (bf16), random
   weights from a seed, SyntheticBatches, W = 4 stacked workers, seq 1024,
   global batch 8, twelve paths: QSGD (16 levels) on the int8 compressed wire
   with error feedback (kernels qsgd_ef + int8_acc) and without (qsgd +
   int8_acc); signsgd_packed on the 1-bit compressed wire with error
   feedback (sign_pack + sign_vote); signsgd's majority vote on the 1-bit
   compressed wire (sign_pack + sign_vote); signsgd_packed on the dense wire,
   gather-and-decompress (sign_pack + sign_unpack); terngrad_kernel on the
   2-bit compressed wire with error feedback (terngrad + tern_pack +
   tern_acc); terngrad (clip 2.5 sigma, plain codes as in the reference) on
   the 2-bit compressed wire (tern_pack + tern_acc); terngrad_kernel on the
   dense wire, gather-and-decompress (terngrad); and four sparsifier paths:
   (g) topk (ratio 0.01) with error feedback and (h) gtopk (ratio 0.01)
   with momentum correction 0.9 and error feedback, both on the dense
   wire's sparse gather and scatter-add (no port kernel: the selection is a
   stable sort, as lax.top_k orders ties); (i) threshold (tau 1e-3) with
   error feedback and (j) adaptive_threshold (proportion 0.01), both on
   the sum reduction through kernel threshold, each printing its kept share
   per step; then twelve more, two steps each: (k) the plain qsgd twin (16
   levels) on the int8 compressed wire with error feedback (its codes in
   plain PyTorch, s gathered after the norm, kernel int8_acc); (l) onebit
   with error feedback, (m) natural, (n) natural_dithering (8 levels), (o)
   size_adaptive (threshold 65,536: 8 buckets as q8 codes, 5 as f16) and
   (p) adaptive_qsgd (var_target 1.0), all gathered and decoded on the
   dense wire; (q) powersgd (rank 4) with error feedback, two f32 factor
   psums per bucket; (r) atomo_svd as per-tensor rules on the five norm
   leaves (the rest a dense f32 all-reduce); (s) the bf16 compressed wire
   (widening psum); (t) a bf16 all-reduce by the ring schedule; (u) the
   recursive halving-doubling schedule with adamw (lr 1e-4) and a global
   clip_norm of 1.0; (v) ZeRO-1 over momentum SGD with qsgd_kernel on the
   compressed wire with error feedback (qsgd_ef + int8_acc, the parameters
   regathered under tag zero1_gather); (l)-(u) launch no port kernel.
   (q) must book its two factor psums per bucket and (v) its
   zero1_gather, each to the byte.  Then the other synchronisation
   schemes, on per-worker (W, *shape) parameters and optimizer state:
   (w) local SGD (H 2, dense, 4 steps: two sync steps booked under
   local_sgd_sync, no kernel), then one eval_step; (x) post-local SGD
   (switch 2, H 2, qsgd_kernel on the int8 compressed wire with error
   feedback, 4 steps: steps 0, 1 and 3 aggregate through qsgd_ef +
   int8_acc); (y) D-PSGD on the ring (2 steps, no kernel); CHOCO-SGD with
   (z) signsgd_packed (sign_pack + sign_unpack, lr 1e-4) and (aa)
   qsgd_kernel (qsgd), 2 steps each, booked under gossip_mix; (ab) the qsgd
   EF path with 2 microbatches (2 steps).  Then the two-level layout and
   the pipelined step: (ac) pod-local SGD over 2 pods x 2 workers (H 2,
   qsgd_kernel EF on the int8 wire, 4 steps: each pod aggregates over its
   own 2 workers, qsgd_ef per worker and int8_acc once per pod and bucket,
   and the pods average every 2nd step; the pods' rows must be equal after
   each sync step and differ before it); (ad) the qsgd EF path pipelined at
   staleness 1 and (ae) the dense path pipelined at staleness 0, 2
   microbatches and 2 steps each (each round on a second CUDA stream while
   the next microbatch runs); (af) ZeRO-1 under local SGD (H 2, dense, 4
   steps: the rows must be equal after every step).  Each of (ac)-(af)
   must book its wire to the byte, by tag and by the axes it reduces over;
   (ad)'s and (ab)'s step ms are printed side by side.  Each path prints
   its losses (finite), step ms, booked wire KB by tag and by format (per
   step; for (w)-(af) per call of each program, and per step over the run;
   for (ac)-(af) by axes too) and peak memory, and the launch counts of its
   kernels: exactly its own kernels must launch, each as many times as the
   path's buckets, workers (or pods), rounds and kernel-running steps call
   it.  Then the churn and integrity paths, 4 steps each, the churn
   window over steps 1-3: (ag) the qsgd EF path under 30% dropout,
   ``reset``; (ah) the same at ``churn=True`` and dropout 0 beside its
   churn-free twin, both under deterministic algorithms: losses and
   parameters within rtol 1e-6 (bitwise printed); (ai) terngrad_kernel EF
   on the 2-bit wire under 60% bitflip corruption, ``quarantine_limit`` 2:
   it must quarantine rounds, and its tallies must agree with a recount
   from its printed per-worker flags; (aj) local SGD H 2 with qsgd_kernel
   EF under 30% dropout, ``pull_avg`` (the donors' average; local SGD
   aggregates no gradient, so no kernel runs, as in its twin); (ak)
   signsgd_packed EF on the 1-bit wire under 30% dropout; (al) the
   staleness-1 pipelined qsgd EF path (M 2) under 30% dropout; (am)
   pod-local SGD (2 pods x 2, H 2, qsgd EF) under 30% dropout.  Each prints
   its live mask and n_eff per step, its quarantine and escalation
   tallies, its booked wire by tag, format and axes, peak memory and step
   ms, and must launch exactly its churn-free twin's kernels.
   ``--profile`` adds
   one more step of the QSGD EF path, or of each path named by its label,
   under torch.profiler (device-busy share, device time by kernel, host
   time by operation), not counted as launches;
5. the checkpoint and the pipelined identity: path (w) at full width cut
   to 2 layers (the state at 28 layers is 13.3 GiB on disk), saved after
   step 1 by ``Trainer.save``
   into a temporary directory and restored by ``Trainer.restore``: every
   leaf bitwise; then one more step from the live and from the restored
   state, under deterministic algorithms, bitwise alike (loss and leaves);
   and the pipelined step against the sequential one: the dense path at
   full width cut to 2 layers, in f32 (a bf16 sequential step rounds each
   worker's microbatch mean to bf16 before the sum, the pipelined one
   does not), 2 microbatches, 2 steps from one state, staleness 0 against
   sequential: losses and every parameter within rtol 1e-5 / atol 1e-7
   (the reference's own test of this identity), with the side stream
   running for real;
6. the whole RWKV6 path, kernel against plain: rwkv6-3b at full width in
   f32, 4 layers, random weights from seed 0, batch 2, a 256-token prompt
   and 8 decode tokens, once with ``use_kernel=True`` and once through the
   plain ``wkv_scan`` fed the same tokens: the last hidden state and every
   cache leaf (each layer's wkv state, shifts) after the prefill and after
   the decode within rtol 1e-4 and an atol of 1e-5 times the leaf's largest
   magnitude; prints whether the plain path's own greedy tokens agree; then
   training: rwkv6-3b at full width, f32, 2 layers (list layout), batch 2,
   seq 256, remat="full": every leaf's gradient of ``forward_loss`` through
   kernels wkv6, wkv6_bwd_states and wkv6_bwd (exactly 2, 1 and 1
   launches a layer) against
   the plain scan's within rtol 1e-3 / atol 1e-4 x the leaf's largest
   magnitude (``TRAIN_GRAD_RTOL``), the losses within 1e-5;
7. the server: rwkv6-3b at full published width and depth (bf16), random
   weights from seed 0, ``SyntheticBatches`` prompts, batch 8, prompt 1024,
   32 greedy decode tokens, through ``launch.serve.run`` (``build_serve``):
   prefill ms (host clock ending in a synchronize), decode ms per token,
   tok/s, peak memory and the first sequence's tokens; exactly kernel wkv6
   must launch, 32 + 32 * 32 = 1,056 times.  ``--profile serve`` adds one
   more decode step under torch.profiler.

8. the convergence engine (``core/simulate.py``) and its sweep CLI, on the
   card: (E1) ``sweep_matrix_45(problem_seeds=(0, 1))``, the repo's
   documented sweep (BENCH_sweep.json's configuration): 90 cells in 5 shape
   classes, qsgd with EF, levels 4/8/16, lr 0.02/0.05/0.08, 8 workers, 60
   steps, 3 replicas: 2,160 rows of dim 64; exactly 5 class programs built,
   no port kernel launched, sweep wall, cells/s and peak memory printed,
   then a second (warm) sweep; (E2) the same cells with ``qsgd_kernel``:
   kernel ``qsgd_ef``'s row launch exactly once per class and step, 300,
   and the same engine with the kernel's plain version on the card under
   the same draws within rtol 1e-6; against E1 the bits within rtol 1e-6
   and the loss series counted within the reference's sweep tolerance
   (rtol 2e-4, atol 1e-6; see PERF.md on dither flips); (E3) BSP, 8 workers,
   300 steps, 3 replicas, one cell each of ``qsgd_kernel`` without EF
   (``qsgd`` rows), ``terngrad_kernel`` (``terngrad`` rows) and
   ``signsgd_packed`` (``sign_pack`` and ``sign_unpack`` over per-row-padded
   stacks): exactly 300 launches of each, and each series within rtol 1e-6
   of the same engine with the plain versions under the same draws; (E4)
   ``measure_engine_speedup`` on ``REFERENCE_SPEEDUP_CELL``, the batched
   engine against the per-step loop reference (same draws), the series
   compared at rtol 2e-4 / atol 1e-5; (E5) ``python -m
   repro_torch.experiments.run --substrate training`` and ``--substrate
   timeline`` on the default grid (16 workers, 120 steps), in-process, each
   table printed.  Before it the three row kernels are held against their
   plain versions at (rows, n) = (432, 64) (a class of E2: 18 cells x 3
   replicas x 8 workers; timed per call by CUDA events and as the kernel's
   own device time by torch.profiler), (2160, 64), (1, 100003) and (100003, 1),
   with per-row levels: codes bitwise, e' within rtol 1e-6.  Then the
   engine's churn legs, BENCH_churn.json's engine configurations at their
   sizes: (C1) {qsgd 4, qsgd 16, adaptive_qsgd var_target 0.5} x dropout
   {0, 0.1, 0.3}, BSP, EF, 8 workers, 250 steps, 3 replicas: 2 class
   programs, every trajectory finite and converging, adaptive below a
   static policy at 30%; (C1k) its static policies through qsgd_kernel:
   qsgd_ef rows once per class step; (C2) local SGD H 5 under 30% dropout
   in [50, 150), 200 steps, ``reset`` against ``pull_avg``: one class
   program each, the pull's download booked; (C3) corruption {none,
   bitflip, nan} x {qsgd 16, adaptive_qsgd}, BSP, EF, rate 0.1, 200 steps:
   6 class programs, tallies booked, each within 2x of its clean twin's
   final loss; and a dropout-0 churn cell against its churn-free twin
   within rtol 1e-5 / atol 1e-6 (bitwise printed).  Each prints its wall,
   cells/s, class programs, launches and peak MiB.
9. phase T, the sweep CLI's trainer and roofline substrates, on the tiny
   workload of the trainer substrate (qwen3-0.6b at d_model 128, 2 layers,
   batch 64 x seq 16, bigram data): (T1) ``measure_trainer_sweep`` on
   ``trainer_matrix_16`` (W = 4, 4 of its 24 steps, deterministic
   algorithms):
   builds shared at most the classes, per cell one per cell,
   ``max_rel_dev_loss`` < 1e-5, no kernel launched; (T2) the
   ``overlap_bench`` twin's 14 cells (W = 2, microbatch 4, 16 steps) with
   the reference's assertions, each pipelined cell's measured overlap
   saving beside the predicted one; (T3) ``run.py --substrate trainer`` on
   compressor {qsgd_kernel, terngrad_kernel, signsgd_packed, threshold} x
   wire {compressed, dense} x EF (W = 4, 3 steps): each dropped cell
   printed with its reason, each cell that runs launching exactly the
   kernels its CommConfig routes (``ROUTE_KERNELS``); (T4) the
   ``train_micro`` twin's nine cells, likewise; (T5) ``run.py --substrate
   roofline`` on the default grid: every term finite.  Nothing is written
   into the tree.
10. phase B, the paper's benchmark suite: ``python -m
   repro_torch.benchmarks.run --no-speedup`` (in-process, records into a
   temporary directory) over the ten tags that phase T does not cover
   (Tables III, IV, II / Fig. 4, Fig. 6, section VIII's convergence, the
   batched sweep, section VII's schedules, the elastic legs, the kernels
   bench and the cold start; ``sec7_overlap`` and ``train_micro`` are T2
   and T4).  ``--no-speedup`` skips the convergence and sweep modules'
   loop and per-cell denominators, which E4 and E1 time already.  Every tag
   must print its ``claims_validated`` row; one line per tag gives its wall;
   the kernels bench's byte model must equal ``BENCH_kernels.json``'s at N
   = 262,144, all eleven kernels must launch there, and its fused and
   composed times and GB/s print at both sizes (262,144 x 8 and the
   largest bucket, 155,582,464 x 8); the cold start's legs print their
   walls, ``nvcc`` builds and persistent hits and misses (the warm-cache
   legs must build nothing), and the fitted profile (alpha, beta,
   t_launch, t_step_dense) and the step-time rel-err before and after.
11. phase F, the MoE, MLA and dense-variant families through the trainer
   (``F_PATHS``): each at full published width, bf16, random weights from
   seed 0, ``SyntheticBatches``, global batch 8, momentum SGD (lr 0.01),
   3 steps, its depth cut to one whole period of its layer pattern: (an)
   qwen3-moe-30b-a3b, 2 of 48 layers (128 experts, top-8), W = 4, qsgd_kernel
   EF on the int8 wire (qsgd_ef + int8_acc); (ao) the same model,
   signsgd_packed EF on the 1-bit wire with the router leaves through
   qsgd_kernel (sign_pack, sign_vote, qsgd_ef, int8_acc); (ap)
   deepseek-v2-lite-16b, its dense layer 0 and 2 MoE layers of 27 (MLA,
   2 shared + 64 routed experts), W = 4, terngrad_kernel EF on the 2-bit
   wire (terngrad, tern_pack, tern_acc); (aq) glm4-9b, 2 of 40 (partial
   RoPE), W = 4, threshold (tau 1e-3) EF (threshold); (ar) qwen1.5-32b, 1
   of 64 (qkv bias), W = 4, qsgd_kernel EF (its 778,567,680-element
   embedding bucket); (as) gemma3-12b, 6 of 48 (one 5 local : 1 global
   period, window 1024), seq 2048, W = 2, qsgd_kernel on the int8 wire
   (qsgd + int8_acc); (az) rwkv6-3b, 16 of 32 layers (cut for memory),
   W = 4, qsgd_kernel EF (qsgd_ef, int8_acc, and its recurrence through
   wkv6, wkv6_bwd_states and wkv6_bwd: 2, 1 and 1 launches a layer,
   worker and step); (ba)
   hymba-1.5b, one pattern period (16 of 32 layers: the global layer and
   15 local; cut for the script's time), W = 4, terngrad_kernel EF
   (terngrad, tern_pack, tern_acc), its selective scan in chunks of
   ``ssm.SCAN_CHUNK`` steps; (bc) qwen2-vl-2b, all 28 layers (M-RoPE, 256
   patches through ``frontend_proj`` before 768 text tokens at seq 1024,
   only the text labelled), W = 4, qsgd_kernel EF (qsgd_ef, int8_acc);
   (bd) seamless-m4t-large-v2, all 24 decoder and 24 encoder layers (256
   audio frames through the non-causal encoder, cross-attention in every
   decoder block, the vocabulary padded to 256,256), W = 4,
   signsgd_packed EF on the 1-bit wire (sign_pack, sign_vote).  Each
   prints the aten operations its first
   step dispatched (``OpCounter``), its steps (loss, ce, aux), mean step ms
   (first step excluded), booked wire by tag, peak memory and largest
   bucket, and must launch exactly its kernels (as many times as the bucket
   plan's routes call them) and book grad_agg equal to the plan's
   prediction to the byte, under 76 GiB; (an), (ap), (as), (az), (bc) and
   (bd) hold their first bf16 loss within 2e-2 of the same forward with
   the parameters in f32 (TF32 off).  Then, at full width in f32: ``moe_ffn`` on 2,048
   tokens of one qwen3-moe layer against the plain per-expert loop of
   ``models/moe_ref.py`` (the initial router and a skewed load at the
   configured capacity factor, tokens dropped, and cf = E / k, none) within
   rtol 1e-4 / atol 1e-5 x max|y|, and each expert's gradient exactly zero
   iff it kept no token (16 experts starved); gemma3's windowed
   ``attention`` at seq 2048 (query chunks 1024 and 512) against a plain
   attention with the explicit window mask, likewise; and ``qsgd_ef``'s row
   entry and ``int8_acc`` on (4, 778,567,680) = 3,114,270,720 elements in
   one call (past 2**31) against their plain versions on the first and
   last 2**20 elements of each row and the 2**20 around flat index 2**31
   (codes bitwise, e' rtol 1e-6, the sum rtol 1e-6 / atol 1e-5), each
   timed beside its byte bound.  ``--profile`` takes phase F's labels too.
12. phase S, the attention families served (``S_PATHS``): each at full
   published width, bf16, random weights from seed 0, ``SyntheticBatches``
   prompts, batch 8, prompt 1024, 32 greedy decode tokens through
   ``launch.serve.run`` (``build_serve``: the prefill's rings hold the
   prompt, the decode runs at max_seq = prompt + 32 and writes the ring in
   place): (at) qwen3-0.6b, all 28 layers (GQA 16:8, qk-norm); (au)
   glm4-9b, all 40 (partial RoPE, 2 KV heads); (av) qwen1.5-32b, 16 of 64
   (MHA 40:40, qkv bias); (aw) gemma3-12b, all 48, prompt 2048 (5 local :
   1 global, window 1024: the prefill's window and the 1024-slot local
   rings bite); (ax) qwen3-moe-30b-a3b, 12 of 48 (128 experts, top-8); (ay)
   deepseek-v2-lite-16b, all 27 (MLA's latent cache, the dense layer 0,
   shared experts; C = 1 per expert in decode, so choices drop); (bb)
   hymba-1.5b, all 32, prompt 2048 (the 1024-slot local rings bite; the
   Mamba heads' conv and SSM state carried beside them); (be) qwen2-vl-2b,
   all 28 (256 patches then 768 text tokens, M-RoPE; the decode's three
   streams at its position); (bf) seamless-m4t-large-v2, all 24 + 24 (the
   encoder's output kept in the cache, its K and V recomputed by every
   decoder block each token).  Each
   prints prefill ms and decode ms per token (host clock ending in a
   synchronize), tok/s, peak GiB (weights included) and the cache's GiB,
   and must launch no port kernel, its tokens in [0, padded vocab) and its last
   hidden state finite.  Then, in f32 at full width, one pattern period
   each (deepseek its dense layer 0 and 2 MoE layers; the MoE at cf = E;
   the list layout: a stacked leaf is drawn at std 1/sqrt(repeats)),
   batch 2, prompt 256 (gemma3 and hymba 1024: their local rings full, so
   the decode evicts position 0, as the forward's window does; hymba's
   chunked scan against the decode's one step): ``prefill(max_seq=S +
   1)`` plus one ``decode_logits`` against the full forward's
   last-position logits over S + 1 tokens within 1e-4 of max|logits|, the
   greedy tokens equal wherever the top-2 margin exceeds the error, and one
   ``serve_step`` against ``decode_step`` from the same cache: tokens and
   cache bitwise (hymba's SSM and conv states written in place too).
   qwen2-vl-2b (2 layers) and seamless (2 + 2 encoder layers) at prompt
   256: the prompt's patches or frames come with it, and qwen2-vl's full
   forward gives the decoded index its decode positions (all three M-RoPE
   streams at S, where ``make_positions`` would put S - n_vis + side; 256
   and 257 give the same n_vis = 64).  ``--profile`` takes the tags
   at..bf (a decode step).
13. phase M, the reference's model axis in training (``M_PATHS``): data 4
   x model 2 stacked on the card, full published width, bf16, random
   weights from seed 0 (padded for 2), ``SyntheticBatches``, seq 1024,
   global batch 8, momentum SGD, 3 steps: (bg) qwen3-0.6b, all 28 layers,
   qsgd_kernel EF (qsgd_ef, int8_acc); (bh) deepseek-v2-lite-16b, 3 of 27
   layers (as (ap): its dense layer 0 and 2 MoE layers, 32 of the 64
   experts a shard), terngrad_kernel EF (terngrad, tern_pack, tern_acc).
   Each prints its mean step ms (the first step excluded), the aten
   operations of its first step (``OpCounter``), peak GiB and, from one
   more step under torch.profiler (kernels only), the device's busy share;
   and must launch exactly its kernels, W x M per shard-local bucket on the
   send side and M on the receive side, a step; book grad_agg equal to the
   shard-local plan's prediction to the byte; and book the model axis's
   records equal to the shapes' formula by tag (``predict_tp``: the two
   row-parallel psums of each layer's (b, S, d) partial, the embedding's
   psum and the loss's pmax and two psums of (b, S) f32, and the
   ``tp_grad_fixup`` psum of each replicated leaf's gradient).  Then the TP
   identity on the card, in f32 with TF32 off, 2 layers at full width
   (``M_IDENTITY``): qwen3-0.6b, deepseek-v2-lite-16b and rwkv6-3b (its
   recurrence through wkv6 / wkv6_bwd, one launch over the 2 shards' 16
   heads each) from the same padded-for-2 parameters and batch (2 x 1024):
   the objective ce + coef * aux at model-axis size 2 within 2e-4 relative
   of size 1's and the squared gradient norm within 5e-3 relative, as
   tests/test_tp_equivalence.py bounds the reference.

Then one JSON line per the kernel table (the three row kernels as
``*_rows`` entries with their bound at E2's class shape, launches from the
engine phase), the nvidia-smi line, and the result line ``{"ok": true,
"device": {...}}``.  The two ``*_past_2e31`` entries are phase F's
calls past 2**31 (launches: the kernel's on the main path).  There is no
CPU fallback.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402

from repro_torch.benchmarks import overlap_bench, train_micro  # noqa: E402
from repro_torch.benchmarks.common import deterministic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.core import aggregate  # noqa: E402
from repro_torch.core import simulate  # noqa: E402
from repro_torch.core import sync  # noqa: E402
from repro_torch.core.compression.powersgd import shape2d  # noqa: E402
from repro_torch.core.types import CommConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticBatches  # noqa: E402
from repro_torch.experiments import run as sweep_cli  # noqa: E402
from repro_torch.experiments import runner, trainer_substrate  # noqa: E402
from repro_torch.experiments.scenario import Scenario, expand  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.build import LIBRARY  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm as SM  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import make_plan, materialize  # noqa: E402
from repro_torch.utils.tree import flatten_with_paths as flat  # noqa: E402
from repro_torch.utils.tree import tree_map, unflatten_like  # noqa: E402
from repro_torch.optim.optimizers import adamw, momentum_sgd, zero1  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.train.steps import build_bundle, build_serve  # noqa: E402
from repro_torch.train.trainer import Trainer, wire_per_step  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM TF32 on the tensor cores, dense
LARGEST = 155_582_464  # embed/embedding, the largest bucket of qwen3-0.6b
W = 4

# per element: bytes moved (inputs read once, outputs written once) and f32
# operations, from each kernel's arithmetic
KERNELS = {
    "qsgd": dict(source="src/repro_torch/kernels/csrc/qsgd.cu",
                 replaces="src/repro/kernels/qsgd.py:42",
                 bytes=lambda n, w: 9 * n, ops=lambda n, w: 9 * n),
    "qsgd_ef": dict(source="src/repro_torch/kernels/csrc/qsgd_ef.cu",
                    replaces="src/repro/kernels/qsgd_ef.py:45",
                    bytes=lambda n, w: 17 * n, ops=lambda n, w: 15 * n),
    "int8_acc": dict(source="src/repro_torch/kernels/csrc/int8_acc.cu",
                     replaces="src/repro/kernels/wire_reduce.py:122",
                     bytes=lambda n, w: (w + 4) * n + 4 * w, ops=lambda n, w: 3 * w * n),
    # the 1-bit wire: padded payload bytes (ceil(n/8192)*1024) per bitmap
    "sign_pack": dict(source="src/repro_torch/kernels/csrc/sign_pack.cu",
                      replaces="src/repro/kernels/sign_pack.py:30",
                      bytes=lambda n, w: 4 * n + ops.sign_packed_bytes(n),
                      ops=lambda n, w: n),
    "sign_unpack": dict(source="src/repro_torch/kernels/csrc/sign_unpack.cu",
                        replaces="src/repro/kernels/sign_pack.py:50",
                        bytes=lambda n, w: ops.sign_packed_bytes(n) + 4 * n,
                        ops=lambda n, w: n),
    "sign_vote": dict(source="src/repro_torch/kernels/csrc/sign_vote.cu",
                      replaces="src/repro/kernels/wire_reduce.py:45",
                      bytes=lambda n, w: w * ops.sign_packed_bytes(n) + 4 * n + 4 * w,
                      ops=lambda n, w: w * n),
    # the 2-bit wire: padded payload bytes (ceil(n/4096)*1024) per row
    "terngrad": dict(source="src/repro_torch/kernels/csrc/terngrad.cu",
                     replaces="src/repro/kernels/terngrad.py:25",
                     bytes=lambda n, w: 9 * n, ops=lambda n, w: 3 * n),
    "tern_pack": dict(source="src/repro_torch/kernels/csrc/tern_pack.cu",
                      replaces="src/repro/kernels/wire_reduce.py:72",
                      bytes=lambda n, w: n + ops.tern_packed_bytes(n),
                      ops=lambda n, w: 2 * n),
    "tern_acc": dict(source="src/repro_torch/kernels/csrc/tern_acc.cu",
                     replaces="src/repro/kernels/wire_reduce.py:97",
                     bytes=lambda n, w: w * ops.tern_packed_bytes(n) + 4 * n + 4 * w,
                     ops=lambda n, w: 2 * w * n),
    # x read, the masked values written, one int32 count per 32,768 elements
    "threshold": dict(source="src/repro_torch/kernels/csrc/threshold.cu",
                      replaces="src/repro/kernels/threshold_sparsify.py:27",
                      bytes=lambda n, w: 8 * n + 4 * -(-n // ops.THRESH_BLOCK),
                      ops=lambda n, w: 2 * n),
    # timed at the prefill shape, not at n elements: see wkv6_bound
    "wkv6": dict(source="src/repro_torch/kernels/csrc/wkv6.cu",
                 replaces="src/repro/kernels/wkv6.py:73"),
    # no TPU counterpart: the gradient of wkv_scan, which XLA derives there;
    # timed at the training shape, see wkv6_bwd_bound
    "wkv6_bwd": dict(source="src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                     replaces="none: the gradient of src/repro/models/rwkv.py:87 (wkv_scan, "
                              "lax.scan), derived by XLA"),
    # wkv6_bwd's first launch (the states at the chunk boundaries), in the
    # same source; timed alone at the training shape, see wkv6_bwd_states_bound
    "wkv6_bwd_states": dict(source="src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                            replaces="none: the first pass of the gradient of "
                                     "src/repro/models/rwkv.py:87 (wkv_scan), derived by XLA"),
}
#: why a kernel's row has library_ms null
NO_LIBRARY = {
    "qsgd": "no PyTorch call quantizes with a dither",
    "qsgd_ef": "no PyTorch call quantizes with a dither",
    "int8_acc": "no single PyTorch call takes an int8 x f32 weighted row sum without a cast",
    "sign_pack": "no single PyTorch call packs bits",
    "sign_unpack": "no single PyTorch call unpacks bits",
    "sign_vote": "no single PyTorch call unpacks and sums bits",
    "terngrad": "no PyTorch call quantizes with a dither",
    "tern_pack": "no single PyTorch call packs 2-bit crumbs",
    "tern_acc": "no single PyTorch call unpacks and sums 2-bit crumbs",
    "threshold": "no single PyTorch call both masks by |x| >= tau and counts",
    "wkv6": "no single PyTorch call runs a linear recurrence with a data-dependent decay",
    "wkv6_bwd": "no single PyTorch call is the gradient of a linear recurrence with a "
                "data-dependent decay",
    "wkv6_bwd_states": "no single PyTorch call runs a linear recurrence with a data-dependent "
                       "decay",
}
#: the convergence engine's row launches (a (rows, n) stack, per-row inv and
#: levels): bytes per element as the flat kernels, plus 4 B per row for each
#: per-row scalar; timed and bounded at E2's class shape
ROW_KERNELS = {
    "qsgd_rows": dict(kernel="qsgd", bytes=lambda b, n: 9 * b * n + 8 * b,
                      ops=lambda b, n: 9 * b * n),
    "qsgd_ef_rows": dict(kernel="qsgd_ef", bytes=lambda b, n: 17 * b * n + 8 * b,
                         ops=lambda b, n: 15 * b * n),
    "terngrad_rows": dict(kernel="terngrad", bytes=lambda b, n: 9 * b * n + 4 * b,
                          ops=lambda b, n: 3 * b * n),
}
#: E1/E2: 90 cells in 5 classes of 18, 3 replicas, 8 workers, dim 64
ENGINE_ROWS, ENGINE_DIM = 18 * 3 * 8, 64
#: E3: steps of the one-cell BSP runs
E3_STEPS = 300

#: RWKV6 serving: batch, prompt, decode tokens (the server phase), and the
#: prefill shape (B, S, H, hd) of kernel wkv6 there
SERVE_B, SERVE_PROMPT, SERVE_DECODE = 8, 1024, 32
WKV6_PREFILL = (SERVE_B, SERVE_PROMPT, 32, 80)
#: kernel wkv6_bwd's shape on path (az): one worker's rows of global batch 8
#: at W = 4, seq 1024, rwkv6-3b's 32 heads of 80
WKV6_TRAIN = (2, 1024, 32, 80)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def ms_per_call(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S
           ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound(name: str, n: int, w: int) -> tuple[float, str]:
    return _bound(KERNELS[name]["bytes"](n, w), KERNELS[name]["ops"](n, w))


def wkv6_bound(B: int, S: int, H: int, hd: int, in_bytes: int,
               ops_per_s: float = TF32_OPS_PER_S) -> tuple[float, str]:
    """r, k, v (and u) read at ``in_bytes`` per element, w read and y written
    as f32, s0 read and sT written as f32.  The least operations per head
    and step: y = r^T S + (sum_i r_i u_i k_i) v is 2 hd^2 (r^T S) + 3 hd (the
    sum) + 2 hd (times v, plus), and S <- w*S + k v^T is 3 hd^2; so 5 hd^2 +
    5 hd, divided by ``ops_per_s``: the 495 TFLOP/s of TF32 on the tensor
    cores, where the chunked design runs its products (the recurrent design
    runs on the CUDA cores: 67 TFLOP/s)."""
    n = B * S * H * hd
    n_bytes = n * (3 * in_bytes + 4 + 4) + B * H * hd * hd * 8 + H * hd * in_bytes
    return _bound(n_bytes, B * S * H * (5 * hd * hd + 5 * hd), ops_per_s)


def wkv6_bwd_bound(B: int, S: int, H: int, hd: int, in_bytes: int,
                   ops_per_s: float = TF32_OPS_PER_S) -> tuple[float, str]:
    """As :func:`wkv6_bound`: r, k, v (and u) read at ``in_bytes`` per
    element, w and dy read as f32, dr, dk, dv, dw written as f32 (du as f32
    per head), s0 and dsT read and ds0 written as f32.  The least
    operations per head and step: the state rebuilt (w*P + k v^T, 3 hd^2),
    dr = P dy and dk = D v (2 hd^2 each), dw = rowsum(D * P) (2 hd^2), dv =
    D^T k (2 hd^2), D <- w*D + r dy^T (3 hd^2): 14 hd^2, plus 16 hd for the
    v . dy and r u k sums and the u terms; over ``ops_per_s``."""
    n = B * S * H * hd
    n_bytes = n * (3 * in_bytes + 4 + 4 + 16) + B * H * hd * hd * 12 + H * hd * (in_bytes + 4)
    return _bound(n_bytes, B * S * H * (14 * hd * hd + 16 * hd), ops_per_s)


def wkv6_bwd_states_bound(B: int, S: int, H: int, hd: int, in_bytes: int,
                          ops_per_s: float = TF32_OPS_PER_S) -> tuple[float, str]:
    """wkv6_bwd's first launch alone: r, k, v read at ``in_bytes`` per
    element, w and dy as f32, s0 and dsT read and ds0 written as f32, and
    the boundary states written, two f32 states per chunk of
    ops.WKV6_BWD_CHUNK steps and head.  The least operations per head and
    step: the two carries' products (k^T v and r^T dy, 2 hd^2 each), the
    decay's running product and the scaled operands (4 hd); over
    ``ops_per_s``."""
    n = B * S * H * hd
    chunks = -(-S // ops.WKV6_BWD_CHUNK)
    n_bytes = n * (3 * in_bytes + 4 + 4) + B * H * hd * hd * (12 + 8 * chunks)
    return _bound(n_bytes, B * S * H * (4 * hd * hd + 4 * hd), ops_per_s)


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> bool:
    return bool(torch.all((got - want).abs() <= atol + rtol * want.abs()))


def check_kernels(n: int, timed: bool) -> dict[str, dict]:
    """Every kernel against its plain version at n elements (W rows for
    int8_acc); returns per-kernel max_abs_err, ok and, if ``timed``, times.
    qsgd_ef runs twice: into a fresh e' buffer and in place (e' over e, as
    the trainer calls it)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(n)
    x = torch.randn(n, generator=gen, device=DEV) * 0.1
    e = torch.randn(n, generator=gen, device=DEV) * 0.05
    u = torch.rand(n, generator=gen, device=DEV)
    lv, dec = torch.tensor(16.0, device=DEV), torch.tensor(0.9, device=DEV)
    out: dict[str, dict] = {}

    inv = torch.reciprocal(torch.linalg.vector_norm(x))
    codes = torch.empty(n, dtype=torch.int8, device=DEV)
    run_q = lambda: ops.qsgd_codes_into(x, u, inv, 16.0, codes)  # noqa: E731
    run_q()
    plain = ref.qsgd_codes(x, u, inv, lv)
    err = int((codes.int() - plain.int()).abs().max())
    out["qsgd"] = {"max_abs_err": float(err), "ok": err == 0,
                   "detail": f"codes differ at {int((codes != plain).sum())} elements"}
    if timed:
        out["qsgd"].update(ms=ms_per_call(run_q, 20),
                           plain_ms=ms_per_call(lambda: ref.qsgd_codes(x, u, inv, lv), 5))
    del plain

    inv_a = torch.reciprocal(torch.linalg.vector_norm(e * 0.9 + x))
    e_new = torch.empty_like(e)
    run_ef = lambda: ops.qsgd_ef_into(x, e, u, inv_a, 16.0, 0.9, codes, e_new)  # noqa: E731
    run_ef()
    plain_c, plain_e = ref.qsgd_ef(x, e, u, inv_a, lv, dec)
    codes_ok = torch.equal(codes, plain_c)
    e_ok = _close(e_new, plain_e, rtol=1e-6, atol=0.0)
    err = float((e_new - plain_e).abs().max())
    e_in = e.clone()  # in place: the kernel reads e and writes e' over it
    ops.qsgd_ef_into(x, e_in, u, inv_a, 16.0, 0.9, codes, e_in)
    codes_ok &= torch.equal(codes, plain_c)
    e_ok &= _close(e_in, plain_e, rtol=1e-6, atol=0.0)
    err = max(err, float((e_in - plain_e).abs().max()))
    out["qsgd_ef"] = {"max_abs_err": err, "ok": codes_ok and e_ok,
                      "detail": f"codes bitwise {codes_ok}, e' (fresh and in place) "
                                f"within rtol 1e-6 {e_ok}"}
    if timed:
        out["qsgd_ef"].update(ms=ms_per_call(run_ef, 20),
                              plain_ms=ms_per_call(lambda: ref.qsgd_ef(x, e, u, inv_a, lv, dec), 5))
    del plain_c, plain_e, e_new, e_in, x, e, u

    ld = -(-n // 16) * 16  # the trainer's padded wire-stack rows
    stack = torch.randint(-16, 17, (W, ld), generator=gen, device=DEV,
                          dtype=torch.int32).to(torch.int8)[:, :n]
    wts = torch.rand(W, generator=gen, device=DEV) * 0.01
    got = ops.int8_weighted_sum(stack, wts)
    plain = ref.int8_acc(stack, wts)
    out["int8_acc"] = {"max_abs_err": float((got - plain).abs().max()),
                       "ok": _close(got, plain, rtol=1e-6, atol=1e-5),
                       "detail": "rtol 1e-6 / atol 1e-5"}
    if timed:
        out["int8_acc"].update(ms=ms_per_call(lambda: ops.int8_weighted_sum(stack, wts), 20),
                               plain_ms=ms_per_call(lambda: ref.int8_acc(stack, wts), 5))
    return out


def check_sign_kernels(n: int, timed: bool) -> dict[str, dict]:
    """The three 1-bit kernels against their plain versions at n elements
    (W rows for sign_vote): packed bytes (pads included) and unpacked values
    bitwise on an input holding +0.0, -0.0 and NaN; votes bitwise with 0/1
    weights (2-2 ties included: row 2 is row 0 inverted) and within rtol
    1e-6 with general weights."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(n + 1)
    x = torch.randn(n, generator=gen, device=DEV)
    x[::7] = 0.0
    x[3::11] = -0.0
    x[5::1001] = float("nan")
    nbytes = ops.sign_packed_bytes(n)
    out: dict[str, dict] = {}

    packed = ops.sign_pack(x)
    plain = ref.sign_pack(x, nbytes)
    diff = int((packed.int() - plain.int()).abs().max())
    out["sign_pack"] = {"max_abs_err": float(diff), "ok": torch.equal(packed, plain),
                        "detail": f"bytes differ at {int((packed != plain).sum())} of {nbytes}"}
    if timed:
        out["sign_pack"].update(ms=ms_per_call(lambda: ops.sign_pack(x, out=packed), 20),
                                plain_ms=ms_per_call(lambda: ref.sign_pack(x, nbytes), 5))
    del x

    values = ops.sign_unpack(packed, n)
    plain_v = ref.sign_unpack(plain, n)
    out["sign_unpack"] = {"max_abs_err": float((values - plain_v).abs().max()),
                          "ok": torch.equal(values, plain_v),
                          "detail": f"values differ at {int((values != plain_v).sum())}"}
    if timed:
        out["sign_unpack"].update(ms=ms_per_call(lambda: ops.sign_unpack(packed, n), 20),
                                  plain_ms=ms_per_call(lambda: ref.sign_unpack(plain, n), 5))
    del values, plain_v, plain

    stack = torch.randint(0, 256, (W, nbytes), generator=gen, device=DEV,
                          dtype=torch.int32).to(torch.uint8)
    stack[2] = stack[0] ^ 0xFF
    ok, err = True, 0.0
    for wts in ([1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 1.0]):
        wts = torch.tensor(wts, device=DEV)
        got, want = ops.sign_vote(stack, wts, n), ref.sign_vote(stack, wts, n)
        ok &= torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))
    general = torch.rand(W, generator=gen, device=DEV) * 2.0
    got, want = ops.sign_vote(stack, general, n), ref.sign_vote(stack, general, n)
    close = _close(got, want, rtol=1e-6, atol=0.0)
    out["sign_vote"] = {"max_abs_err": max(err, float((got - want).abs().max())),
                        "ok": ok and close,
                        "detail": f"0/1 weights bitwise {ok}, general within rtol 1e-6 {close}"}
    if timed:
        out["sign_vote"].update(ms=ms_per_call(lambda: ops.sign_vote(stack, general, n), 20),
                                plain_ms=ms_per_call(lambda: ref.sign_vote(stack, general, n), 5))
    return out


def check_tern_kernels(n: int, timed: bool) -> dict[str, dict]:
    """The three 2-bit kernels against their plain versions at n elements
    (W rows for tern_acc): codes bitwise on an input holding +0.0 and -0.0
    and noise equal to p = |x| * inv at every 13th element (u < p is
    strict); packed bytes (pads included) bitwise on int8 codes holding
    values outside {-1, 0, 1}; accumulated sums over random bytes (every
    crumb value, 2 included) bitwise with 0/1 weights and within rtol 1e-6
    with general weights."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(n + 2)
    x = torch.randn(n, generator=gen, device=DEV) * 0.1
    x[::97] = 0.0
    x[3::89] = -0.0
    u = torch.rand(n, generator=gen, device=DEV)
    inv = torch.reciprocal(torch.clamp_min(torch.max(torch.abs(x)), 1e-30))
    u[5::13] = torch.abs(x[5::13]) * inv
    out: dict[str, dict] = {}

    codes = torch.empty(n, dtype=torch.int8, device=DEV)
    run_t = lambda: ops.terngrad_codes_into(x, u, inv, codes)  # noqa: E731
    run_t()
    plain = ref.terngrad_codes(x, u, inv)
    err = int((codes.int() - plain.int()).abs().max())
    out["terngrad"] = {"max_abs_err": float(err), "ok": err == 0,
                       "detail": f"codes differ at {int((codes != plain).sum())} elements"}
    if timed:
        out["terngrad"].update(ms=ms_per_call(run_t, 20),
                               plain_ms=ms_per_call(lambda: ref.terngrad_codes(x, u, inv), 5))
    del x, u, plain, codes

    t = torch.randint(-3, 4, (n,), generator=gen, device=DEV, dtype=torch.int32).to(torch.int8)
    nbytes = ops.tern_packed_bytes(n)
    packed = ops.tern_pack(t)
    plain = ref.tern_pack(t, nbytes)
    diff = int((packed.int() - plain.int()).abs().max())
    out["tern_pack"] = {"max_abs_err": float(diff), "ok": torch.equal(packed, plain),
                        "detail": f"bytes differ at {int((packed != plain).sum())} of {nbytes}"}
    if timed:
        out["tern_pack"].update(ms=ms_per_call(lambda: ops.tern_pack(t, out=packed), 20),
                                plain_ms=ms_per_call(lambda: ref.tern_pack(t, nbytes), 5))
    del t, packed, plain

    stack = torch.randint(0, 256, (W, nbytes), generator=gen, device=DEV,
                          dtype=torch.int32).to(torch.uint8)
    ok, err = True, 0.0
    for wts in ([1.0, 1.0, 1.0, 1.0], [1.0, 0.0, 1.0, 1.0]):
        wts = torch.tensor(wts, device=DEV)
        got, want = ops.tern_acc(stack, wts, n), ref.tern_acc(stack, wts, n)
        ok &= torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))
    general = torch.rand(W, generator=gen, device=DEV) * 0.01
    got, want = ops.tern_acc(stack, general, n), ref.tern_acc(stack, general, n)
    close = _close(got, want, rtol=1e-6, atol=0.0)
    out["tern_acc"] = {"max_abs_err": max(err, float((got - want).abs().max())),
                       "ok": ok and close,
                       "detail": f"0/1 weights bitwise {ok}, general within rtol 1e-6 {close}"}
    if timed:
        out["tern_acc"].update(ms=ms_per_call(lambda: ops.tern_acc(stack, general, n), 20),
                               plain_ms=ms_per_call(lambda: ref.tern_acc(stack, general, n), 5))
    return out


def check_threshold_kernel(n: int, timed: bool) -> dict[str, dict]:
    """Kernel threshold against its plain version at n elements, tau 0.0,
    0.05 and 10.0 (a one-element tensor on the card, as the compressors
    pass it): masked values bitwise (int32 views: a kept -0.0 stays -0.0,
    NaN is never kept, +-inf is kept) and per-block kept counts exactly."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(n + 3)
    x = torch.randn(n, generator=gen, device=DEV) * 0.1
    x[::97] = 0.0
    x[3::89] = -0.0
    x[5::1001] = float("nan")
    x[7::1003] = float("inf")
    x[11::1009] = float("-inf")
    ok, err, detail = True, 0.0, []
    for tau in (0.0, 0.05, 10.0):
        t = torch.full((1,), tau, device=DEV)
        got, counts = ops.threshold_blocks(x, t)
        want, want_counts = ref.threshold(x, t.reshape(()), ops.THRESH_BLOCK)
        diff = got.view(torch.int32) != want.view(torch.int32)
        same = not bool(diff.any()) and torch.equal(counts, want_counts)
        ok &= same
        if diff.any():
            err = max(err, float((got[diff] - want[diff]).abs().max()))
        detail.append(f"tau {tau}: values differ at {int(diff.sum())}, counts equal "
                      f"{torch.equal(counts, want_counts)}")
    out = {"threshold": {"max_abs_err": err, "ok": ok, "detail": "; ".join(detail)}}
    if timed:
        t = torch.full((1,), 0.05, device=DEV)
        out["threshold"].update(
            ms=ms_per_call(lambda: ops.threshold_blocks(x, t), 20),
            plain_ms=ms_per_call(lambda: ref.threshold(x, t.reshape(()), ops.THRESH_BLOCK), 5))
    return out


def _wkv6_inputs(B: int, S: int, H: int, hd: int, dtype: torch.dtype, seed: int,
                 edge: bool = False):
    """``edge`` plants w = 0.0, 1.0 and 1e-3 and a run of 40 steps without
    decay in the first 8 channels (as tests/test_torch_wkv6_chunked.py)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    r, k, v = (torch.randn((B, S, H, hd), generator=gen, device=DEV).mul_(0.5).to(dtype)
               for _ in range(3))
    w = torch.sigmoid(torch.randn((B, S, H, hd), generator=gen, device=DEV)) * 0.5 + 0.4
    if edge:
        w[:, ::7, :, ::3] = 0.0
        w[:, 1::5, :, 1::3] = 1.0
        w[:, 2::3, :, 2::3] = 1e-3
        w[:, 20:60, :, :8] = 1.0
    u = (torch.randn((H, hd), generator=gen, device=DEV) * 0.1).to(dtype)
    s0 = torch.randn((B, H, hd, hd), generator=gen, device=DEV) * 0.1
    return r, k, v, w, u, s0


def device_ms(fn, iters: int, kernel: str, sessions: int = 3) -> float:
    """The own device time per launch of the kernels whose name holds
    ``kernel``, over ``iters`` calls of ``fn``, from torch.profiler (CUDA
    events around the calls time the host-bound enqueue instead).  A
    profiler session on the card has been seen to deliver no kernel record
    at all, right after a session that did: such a session is run again,
    up to ``sessions`` in all, and a kernel that none of them saw fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and kernel in e.key]
        count = sum(e.count for e in ev)
        if count:
            return sum(e.self_device_time_total for e in ev) / 1e3 / count
        print(f"  {kernel}: a profiler session saw no record of the kernel; profiling again")
    raise AssertionError(f"{kernel}: the profiler saw no device time of the kernel")


def check_wkv6() -> dict[str, dict]:
    """Kernel wkv6 against its plain version: y within rtol 3e-4 / atol 3e-5;
    sT bitwise on the recurrent design (S < ops.WKV6_CHUNK) and within rtol
    1e-4 / atol 1e-5 x max|sT| on the chunked one; at three small shapes (f32
    and bf16), the decay edge cases (2, 130, 4, 80) bf16 (also against the
    chunked twin ref.wkv6_chunked), a ragged S = 1000 at the server's head
    count, the server's decode shape (B, 1, 32, 80) and its prefill shape
    (bf16 r, k, v, u, nonzero s0).  The decode shape is timed in the
    detail; at the prefill shape the recurrent design is timed beside the
    chunked one, in turns, and the chunked one's time is the row's."""
    H, hd = WKV6_PREFILL[2:]
    cases = [((shape, dt), False) for shape in ((1, 32, 1, 16), (2, 100, 2, 32), (1, 1, 32, 80))
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(((2, 130, 4, 80), torch.bfloat16), True), (((1, 1000, H, hd), torch.bfloat16), False),
              (((SERVE_B, 1, H, hd), torch.bfloat16), False), ((WKV6_PREFILL, torch.bfloat16), False)]
    ok, err, detail = True, 0.0, []
    for i, ((shape, dt), edge) in enumerate(cases):
        args = _wkv6_inputs(*shape, dt, seed=100 + i, edge=edge)
        y, sT = ops.wkv6(*args)
        want_y, want_s = ref.wkv6(*args)
        chunked = shape[1] >= ops.WKV6_CHUNK
        if chunked:
            s_ok = _close(sT, want_s, rtol=1e-4, atol=1e-5 * float(want_s.abs().max()))
        else:
            s_ok = torch.equal(sT, want_s)
        y_ok = _close(y, want_y, rtol=3e-4, atol=3e-5)
        ok &= s_ok and y_ok
        err = max(err, float((y - want_y).abs().max()), float((sT - want_s).abs().max()))
        detail.append(f"{shape} {str(dt)[6:]}{' w edges' if edge else ''} "
                      f"{'chunked' if chunked else 'recurrent'}: sT "
                      f"{'within tolerance' if chunked else 'bitwise'} {s_ok} (max abs err "
                      f"{float((sT - want_s).abs().max()):.2e} of {float(want_s.abs().max()):.2e}), "
                      f"y within tolerance {y_ok} (max abs err "
                      f"{float((y - want_y).abs().max()):.2e})")
        if edge:
            ty, ts = ref.wkv6_chunked(*args)
            detail.append(f"  against the chunked twin: y max abs err "
                          f"{float((y - ty).abs().max()):.2e}, sT {float((sT - ts).abs().max()):.2e}")
        if shape[1] == 1 and shape[0] == SERVE_B:
            b_ms, b_by = wkv6_bound(*shape, in_bytes=2)
            call_ms = ms_per_call(lambda: ops.wkv6(*args), 20)
            dev_ms = device_ms(lambda: ops.wkv6(*args), 20, "wkv6")
            decode = dict(decode_ms=call_ms, decode_device_ms=dev_ms,
                          decode_plain_ms=ms_per_call(lambda: ref.wkv6(*args), 20))
            detail.append(f"{shape} {call_ms:.4f} ms per call (host-bound), "
                          f"{dev_ms:.4f} ms of device time per launch (profiler) (bound "
                          f"{b_ms:.4f} ms by {b_by}, nearly all of it the state)")
    out = {"max_abs_err": err, "ok": ok, "detail": "; ".join(detail), **decode}
    recurrent = lambda: ops._wkv6_launch(*args, chunked=False)  # noqa: E731
    chunked = lambda: ops._wkv6_launch(*args, chunked=True)  # noqa: E731
    turns = [ms_per_call(f, 20) for f in (recurrent, chunked, chunked, recurrent)]
    out.update(ms=min(turns[1:3]), plain_ms=ms_per_call(lambda: ref.wkv6(*args), 2),
               recurrent_ms=min(turns[0], turns[3]), turns=turns)
    # the training shape, where (az) launches the forward (chunked design)
    args = _wkv6_inputs(*WKV6_TRAIN, torch.bfloat16, seed=120)
    chunked = lambda: ops._wkv6_launch(*args, chunked=True)  # noqa: E731
    out.update(train_shape_ms=min(ms_per_call(chunked, 20), ms_per_call(chunked, 20)),
               train_shape_bound_ms=wkv6_bound(*WKV6_TRAIN, in_bytes=2)[0])
    return {"wkv6": out}


def check_wkv6_backward() -> dict[str, dict]:
    """Kernel wkv6_bwd (its launches wkv6_bwd_states and wkv6_bwd) against
    its plain versions ref.wkv6_backward and ref.wkv6_backward_chunked, and
    the plain one against autograd through ref.wkv6 (the leaves widened to
    f32, as both widen them), on the card: at the training shape WKV6_TRAIN
    in bf16 and f32, a ragged S = 1000, S = 20 (< WKV6_CHUNK: the forward's
    recurrent design), and the chunk edges S = 1, 63, 64, 65 and 37 at hd
    80 and 64; w holding 0, 1 and 1e-3 in some channels, nonzero s0, dsT
    nonzero (and absent twice).  Each gradient within rtol 1e-4 / atol 1e-5
    x its largest magnitude; two kernel calls bitwise alike;
    wkv6_bwd_states' boundary states against ref.wkv6_bwd_states at the
    same tolerance.  Timed at WKV6_TRAIN bf16 with CUDA events: the whole
    backward, and each launch alone."""
    H, hd = WKV6_TRAIN[2:]
    L = ops.WKV6_BWD_CHUNK
    cases = [(WKV6_TRAIN, torch.bfloat16, True), (WKV6_TRAIN, torch.float32, True),
             ((1, 1000, H, hd), torch.bfloat16, True), ((2, 20, H, hd), torch.float32, False),
             ((2, 1, H, hd), torch.bfloat16, True), ((2, L - 1, H, hd), torch.float32, True),
             ((2, L, H, 64), torch.bfloat16, True), ((1, L + 1, H, hd), torch.float32, False),
             ((2, L + 1, H, 64), torch.bfloat16, True), ((2, 37, 4, 64), torch.float32, True)]
    ok, err, detail = True, 0.0, []
    states = {"max_abs_err": 0.0, "ok": True}
    for i, (shape, dt, with_dsT) in enumerate(cases):
        args = _wkv6_inputs(*shape, dt, seed=300 + i, edge=True)
        gen = torch.Generator(device=DEV)
        gen.manual_seed(400 + i)
        dy = torch.randn(shape, generator=gen, device=DEV)
        dsT = (torch.randn((shape[0], shape[2], shape[3], shape[3]), generator=gen, device=DEV)
               * 0.1 if with_dsT else None)
        got = ops.wkv6_backward(*args, dy, dsT)
        again = ops.wkv6_backward(*args, dy, dsT)
        want = ref.wkv6_backward(*args, dy, dsT)
        twin = ref.wkv6_backward_chunked(*args, dy, dsT)
        leaves = [t.detach().float().requires_grad_(True) for t in args]
        y, sT = ref.wkv6(*leaves)
        loss = (y * dy).sum() + (0.0 if dsT is None else (sT * dsT).sum())
        auto = torch.autograd.grad(loss, leaves)
        del y, sT, loss, leaves
        worst = []
        for name, g, a, wv, tw, au in zip(("r", "k", "v", "w", "u", "s0"), got, again, want,
                                          twin, auto):
            top = float(wv.abs().max())
            e_ref, e_auto = float((g - wv).abs().max()), float((g - au).abs().max())
            case_ok = (torch.equal(g, a) and _close(g, wv, 1e-4, 1e-5 * top)
                       and _close(g, tw, 1e-4, 1e-5 * top) and _close(wv, au, 1e-4, 1e-5 * top))
            ok &= case_ok
            err = max(err, e_ref)
            worst.append(f"d{name} {e_ref:.1e}/{e_auto:.1e} of {top:.1e}"
                         + ("" if case_ok else " FAILED"))
        st_got = ops.wkv6_bwd_states(*args[:4], args[5], dy, dsT)
        st_want = ref.wkv6_bwd_states(*args[:4], args[5], dy, dsT)
        st = []
        for name, g, wv in zip(("P", "D", "ds0"), st_got, st_want):
            top = float(wv.abs().max())
            e = float((g - wv).abs().max())
            s_ok = _close(g, wv, 1e-4, 1e-5 * top)
            states["ok"] &= s_ok
            states["max_abs_err"] = max(states["max_abs_err"], e)
            st.append(f"{name} {e:.1e} of {top:.1e}" + ("" if s_ok else " FAILED"))
        detail.append(f"{shape} {str(dt)[6:]}{'' if with_dsT else ' dsT absent'}: "
                      f"max abs err against the plain / autograd (max|g|): {', '.join(worst)}; "
                      f"states {', '.join(st)}")
        if shape == WKV6_TRAIN and dt == torch.bfloat16:
            fn = lambda: ops.wkv6_backward(*args, dy, dsT)  # noqa: E731
            r, k, v, w, u, s0 = args
            P, G, _ = st_got
            w32, u32 = w.float().contiguous(), u.float().contiguous()
            st_fn = lambda: ops.wkv6_bwd_states(r, k, v, w, s0, dy, dsT)  # noqa: E731
            ch_fn = lambda: ops._wkv6_bwd_chunks(r, k, v, w32, u32, dy, P, G)  # noqa: E731
            turns = [ms_per_call(f, 10) for f in (fn, st_fn, ch_fn, ch_fn, st_fn, fn)]
            out = dict(ms=min(turns[0], turns[5]), states_ms=min(turns[1], turns[4]),
                       chunks_ms=min(turns[2], turns[3]), turns=turns,
                       plain_ms=ms_per_call(lambda: ref.wkv6_backward(*args, dy, dsT), 1))
            states.update(ms=out["states_ms"], plain_ms=ms_per_call(
                lambda: ref.wkv6_bwd_states(*args[:4], args[5], dy, dsT), 1))
        del got, again, want, twin, auto, st_got, st_want
    torch.cuda.empty_cache()
    states["detail"] = "boundary states within rtol 1e-4 / atol 1e-5 x max" if states["ok"] \
        else "boundary states outside tolerance"
    return {"wkv6_bwd": {"max_abs_err": err, "ok": ok, "detail": "; ".join(detail), **out},
            "wkv6_bwd_states": states}


def require(results: dict[str, dict], n: int) -> None:
    bad = {k: r["detail"] for k, r in results.items() if not r["ok"]}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at n={n}: {bad}")


QSGD16 = dict(compressor="qsgd_kernel", compressor_kwargs={"levels": 16},
              wire_format="compressed")
# signSGD moves every weight by about lr per step: a sign-sized rate
SIGN_LR = 1e-4
#: launches per step of a kernel called once per worker and bucket (13
#: buckets, W workers), and of one called once per bucket
SEND, RECV = 13 * W, 13
#: pods of path (ac)'s two-level layout (W = PODS x 2)
PODS = 2
#: the optimizer of each path: momentum SGD unless a path names another
OPTIMIZERS = {"momentum": lambda: momentum_sgd(0.9), "adamw": adamw,
              "zero1": lambda: zero1(momentum_sgd(0.9), W)}
#: (label, CommConfig fields, steps, lr, {kernel: launches per step}[, build
#: options: "opt" (a key of OPTIMIZERS), "clip_norm"]); every other kernel
#: must not launch on the path
PATHS = (
    ("qsgd ef", dict(error_feedback=True, **QSGD16), 3, 0.01,
     {"qsgd_ef": SEND, "int8_acc": RECV}),
    ("qsgd", dict(**QSGD16), 2, 0.01, {"qsgd": SEND, "int8_acc": RECV}),
    ("signsgd_packed cwire ef", dict(compressor="signsgd_packed", wire_format="compressed",
                                     error_feedback=True), 2, SIGN_LR,
     {"sign_pack": SEND, "sign_vote": RECV}),
    ("signsgd cwire majority", dict(compressor="signsgd", wire_format="compressed"), 2,
     SIGN_LR, {"sign_pack": SEND, "sign_vote": RECV}),
    ("signsgd_packed dense", dict(compressor="signsgd_packed", wire_format="dense"), 2,
     SIGN_LR, {"sign_pack": SEND, "sign_unpack": SEND}),
    ("terngrad_kernel cwire ef", dict(compressor="terngrad_kernel", wire_format="compressed",
                                      error_feedback=True), 2, 0.01,
     {"terngrad": SEND, "tern_pack": SEND, "tern_acc": RECV}),
    # the twin computes its codes in plain PyTorch, as the reference does in jnp
    ("terngrad cwire clip", dict(compressor="terngrad", compressor_kwargs={"clip_sigma": 2.5},
                                 wire_format="compressed"), 2, 0.01,
     {"tern_pack": SEND, "tern_acc": RECV}),
    ("terngrad_kernel dense", dict(compressor="terngrad_kernel", wire_format="dense"), 2, 0.01,
     {"terngrad": SEND}),
    # the top-k family selects by a stable sort (lax.top_k's tie order): no
    # port kernel; DGC's recipe is momentum correction with local accumulation
    ("topk ef", dict(compressor="topk", compressor_kwargs={"ratio": 0.01},
                     error_feedback=True), 2, 0.01, {}),
    ("gtopk momentum ef", dict(compressor="gtopk", compressor_kwargs={"ratio": 0.01},
                               momentum_correction=0.9, error_feedback=True), 2, 0.01, {}),
    ("threshold ef", dict(compressor="threshold", compressor_kwargs={"tau": 1e-3},
                          error_feedback=True), 2, 0.01, {"threshold": SEND}),
    ("adaptive_threshold", dict(compressor="adaptive_threshold",
                                compressor_kwargs={"proportion": 0.01}), 2, 0.01,
     {"threshold": SEND}),
    # (k)-(v): the rest of the BSP step's knobs; only (k) and (v) reach a
    # port kernel, the others are plain PyTorch as the reference is jnp
    ("qsgd twin cwire ef", dict(compressor="qsgd", compressor_kwargs={"levels": 16},
                                wire_format="compressed", error_feedback=True), 2, 0.01,
     {"int8_acc": RECV}),
    ("onebit ef", dict(compressor="onebit", error_feedback=True), 2, 0.01, {}),
    ("natural", dict(compressor="natural"), 2, 0.01, {}),
    ("natural_dithering", dict(compressor="natural_dithering", compressor_kwargs={"levels": 8}),
     2, 0.01, {}),
    ("size_adaptive", dict(compressor="size_adaptive", compressor_kwargs={"threshold": 65536}),
     2, 0.01, {}),
    ("adaptive_qsgd", dict(compressor="adaptive_qsgd", compressor_kwargs={"var_target": 1.0}),
     2, 0.01, {}),
    ("powersgd ef", dict(compressor="powersgd", compressor_kwargs={"rank": 4},
                         error_feedback=True), 2, 0.01, {}),
    # ATOMO's SVDs on the small leaves only (the largest is 128 x 224)
    ("atomo rules", dict(per_tensor_rules=[("norm", "atomo_svd", {}), ("ln", "atomo_svd", {})]),
     2, 0.01, {}),
    ("bf16 wire", dict(wire_format="compressed"), 2, 0.01, {}),
    ("bf16 ring", dict(agg_dtype="bfloat16", collective="ring"), 2, 0.01, {}),
    ("rhd adamw clip", dict(collective="rhd"), 2, 1e-4, {},
     {"opt": "adamw", "clip_norm": 1.0}),
    ("zero1 qsgd ef", dict(error_feedback=True, **QSGD16), 2, 0.01,
     {"qsgd_ef": SEND, "int8_acc": RECV}, {"opt": "zero1"}),
    # (w)-(ab): the other synchronisation schemes, on per-worker parameters.
    # Launches are per step that runs the path's kernels: every gossip
    # step, and every step that aggregates gradients (post-local SGD with
    # switch 2 and H 2 aggregates on steps 0, 1 and 3 of 4)
    ("local sgd", dict(sync="local", local_steps=2), 4, 0.01, {}, {"eval": True}),
    ("post-local qsgd ef", dict(sync="post_local", post_local_switch=2, local_steps=2,
                                error_feedback=True, **QSGD16), 4, 0.01,
     {"qsgd_ef": SEND, "int8_acc": RECV}),
    ("dpsgd", dict(aggregator="gossip"), 2, 0.01, {}),
    # CHOCO: each worker compresses and decodes its own payload once per
    # bucket; the neighbours' terms are the decoded rows, rolled
    ("choco signsgd_packed", dict(aggregator="gossip", gossip_compress="choco",
                                  compressor="signsgd_packed"), 2, SIGN_LR,
     {"sign_pack": SEND, "sign_unpack": SEND}),
    ("choco qsgd", dict(aggregator="gossip", gossip_compress="choco",
                        compressor="qsgd_kernel", compressor_kwargs={"levels": 16}), 2, 0.01,
     {"qsgd": SEND}),
    ("microbatch qsgd ef", dict(error_feedback=True, **QSGD16), 2, 0.01,
     {"qsgd_ef": SEND, "int8_acc": RECV}, {"microbatch": 2}),
    # (ac)-(af): the two-level layout, the pipelined step and ZeRO-1 over
    # diverging rows.  (ac): each pod's round sends per worker and reduces
    # per bucket, so int8_acc runs once per pod and bucket; (ad): M = 2
    # rounds per step
    ("pod-local qsgd ef", dict(pod_local=True, local_steps=2, error_feedback=True, **QSGD16),
     4, 0.01, {"qsgd_ef": SEND, "int8_acc": RECV * PODS}, {"pods": PODS, "rows": "pods"}),
    ("pipelined s1 qsgd ef", dict(overlap="pipelined", error_feedback=True, **QSGD16), 2, 0.01,
     {"qsgd_ef": 2 * SEND, "int8_acc": 2 * RECV}, {"microbatch": 2}),
    ("pipelined s0 dense", dict(overlap="pipelined", overlap_staleness=0), 2, 0.01, {},
     {"microbatch": 2}),
    ("zero1 local sgd", dict(sync="local", local_steps=2), 4, 0.01, {},
     {"opt": "zero1", "rows": "equal"}),
)
#: (ag)-(am), the churn and integrity paths: 4 steps, the churn window over
#: steps 1-3; each launches its churn-free twin's kernels.  build "churn"
#: prints the live masks and tallies per step; "keep" keeps the losses and
#: parameters for (ah)'s comparison, run under deterministic algorithms
WINDOW = dict(churn_start=1, churn_end=4)
DROP30 = dict(dropout_rate=0.3, **WINDOW)
QSGD_EF = dict(error_feedback=True, **QSGD16)
CHURN_PATHS = (
    ("(ag) qsgd ef dropout", dict(**QSGD_EF, **DROP30), 4, 0.01,
     {"qsgd_ef": SEND, "int8_acc": RECV}, {"churn": True}),
    ("(ah) twin qsgd ef", dict(**QSGD_EF), 4, 0.01,
     {"qsgd_ef": SEND, "int8_acc": RECV}, {"keep": True}),
    ("(ah) qsgd ef churn0", dict(**QSGD_EF, churn=True), 4, 0.01,
     {"qsgd_ef": SEND, "int8_acc": RECV}, {"churn": True, "keep": True}),
    ("(ai) terngrad ef bitflip", dict(compressor="terngrad_kernel", wire_format="compressed",
                                      error_feedback=True, corruption_rate=0.6,
                                      corruption_kind="bitflip", quarantine_limit=2), 4, 0.01,
     {"terngrad": SEND, "tern_pack": SEND, "tern_acc": RECV}, {"churn": True}),
    # local SGD aggregates no gradient: its compressor never runs, as in its twin
    ("(aj) local pull_avg", dict(sync="local", local_steps=2, rejoin_policy="pull_avg",
                                 **QSGD_EF, **DROP30), 4, 0.01, {}, {"churn": True}),
    ("(ak) signsgd_packed ef dropout", dict(compressor="signsgd_packed",
                                            wire_format="compressed", error_feedback=True,
                                            **DROP30), 4, SIGN_LR,
     {"sign_pack": SEND, "sign_vote": RECV}, {"churn": True}),
    ("(al) pipelined s1 dropout", dict(overlap="pipelined", **QSGD_EF, **DROP30), 4, 0.01,
     {"qsgd_ef": 2 * SEND, "int8_acc": 2 * RECV}, {"microbatch": 2, "churn": True}),
    ("(am) pod-local dropout", dict(pod_local=True, local_steps=2, **QSGD_EF, **DROP30), 4, 0.01,
     {"qsgd_ef": SEND, "int8_acc": RECV * PODS}, {"pods": PODS, "churn": True}),
)
#: (ah)'s twin and churn run: (losses, parameter leaves)
KEPT: dict[str, tuple] = {}

#: the wire tag each new path must book, and the program that books it
SCHEME_TAGS = {"local sgd": ("sync", "local_sgd_sync"),
               "pod-local qsgd ef": ("sync", "local_sgd_sync"),
               "zero1 local sgd": ("sync", "local_sgd_sync"),
               "post-local qsgd ef": ("sync", "local_sgd_sync"),
               "dpsgd": ("gossip", "gossip_mix"), "choco signsgd_packed": ("gossip", "gossip_mix"),
               "choco qsgd": ("gossip", "gossip_mix")}


def _psgd_wire(bundle) -> float:
    """Two f32 psums per bucket, of P (a x rank) and Q (b x rank): (a + b)
    rank 4 bytes, at 2(W-1)/W on the wire."""
    return sum(sum(shape2d(b.size)) * 4 * 4 for b in bundle.bucket_plan.buckets) * 2 * (W - 1) / W


#: booked wire bytes per step that a path must show: {label: (tag, bytes of the bundle)}
WIRE_CHECKS = {
    "powersgd ef": ("grad_agg", _psgd_wire),
    # one bf16 all-gather per leaf of each worker's padded 1/W slice
    "zero1 qsgd ef": ("zero1_gather", lambda bundle: sum(
        -(-b.size // W) * 2 * (W - 1) for b in bundle.bucket_plan.buckets)),
}


def _qsgd_round(bundle, n: int) -> float:
    """One int8 round over n workers: the codes and the f32 norm of each
    bucket all-gathered, p(n-1) each."""
    return sum((b.size + 4) * (n - 1) for b in bundle.bucket_plan.buckets)


def _dense_round(bundle, n: int) -> float:
    """One f32 all-reduce of every bucket over n workers, 2p(n-1)/n."""
    return sum(4 * b.size * 2 * (n - 1) / n for b in bundle.bucket_plan.buckets)


def _zero1_gather(bundle) -> float:
    """One all-gather of each worker's padded 1/W slice per leaf, at the
    parameters' width."""
    width = torch.empty((), dtype=bundle.cfg.pdtype).element_size()
    return sum(-(-b.size // W) * width * (W - 1) for b in bundle.bucket_plan.buckets)


#: booked bytes per call of (ac)-(af), by (program, tag): {axes: bytes of the bundle}
AXES_CHECKS = {
    "pod-local qsgd ef": {
        ("train", "grad_agg"): lambda b: {("data",): _qsgd_round(b, W // PODS)},
        ("sync", "local_sgd_sync"): lambda b: {("pod",): _dense_round(b, PODS)}},
    "pipelined s1 qsgd ef": {("train", "grad_agg"): lambda b: {("data",): 2 * _qsgd_round(b, W)}},
    "pipelined s0 dense": {("train", "grad_agg"): lambda b: {("data",): 2 * _dense_round(b, W)}},
    "zero1 local sgd": {
        ("train", "zero1_gather"): lambda b: {("data",): _zero1_gather(b)},
        ("inner", "zero1_gather"): lambda b: {("data",): _zero1_gather(b)},
        ("sync", "local_sgd_sync"): lambda b: {("data",): _dense_round(b, W)}},
}
#: mean step ms (first step excluded) of each path, for the side-by-side lines
STEP_MS: dict[str, float] = {}


def check_axes(label: str, bundle) -> None:
    """Path ``label``'s booked bytes by program, tag and axes, to the byte;
    for (ac) also the n of every tagged record (2 in a pod, 2 pods)."""
    for (prog, tag), want in AXES_CHECKS[label].items():
        got, want = bundle.logs[prog].by_axes(tag), want(bundle)
        if got.keys() != want.keys() or any(not math.isclose(got[k], want[k], rel_tol=1e-12)
                                            for k in want):
            raise AssertionError(f"path {label}: {prog} books {got} under {tag}, want {want}")
    if label == "pod-local qsgd ef":
        ns = {(r.tag, r.axes, r.n_workers) for p in ("train", "sync")
              for r in bundle.logs[p].records if r.tag}
        if ns != {("grad_agg", ("data",), W // PODS), ("local_sgd_sync", ("pod",), PODS)}:
            raise AssertionError(f"path {label}: records by tag, axes and n: {ns}")


def check_rows(label: str, how: str, comm: CommConfig, state, t: int) -> str:
    """(ac): the pods' rows equal after a sync step and apart before it;
    (af): every row equal after every step."""
    p = state["params"]["embed"]["embedding"]
    equal = all(torch.equal(p[0], p[r]) for r in range(1, p.shape[0]))
    want = sync.params_need_sync(comm, t) if how == "pods" else True
    if equal != want:
        raise AssertionError(f"path {label}: rows equal {equal} after step {t}, want {want}")
    return f"; {p.shape[0]} rows equal {equal}"


def kernel_steps(comm: CommConfig, steps: int) -> int:
    """Steps of a run that call the path's kernels: every gossip step, and
    every step whose program aggregates gradients."""
    if comm.aggregator == "gossip":
        return steps
    return sum(sync.grads_need_aggregation(comm, t) for t in range(steps))


class OpCounter(TorchDispatchMode):
    """Counts the aten operations dispatched while it is entered, forward
    and backward (each launches about one kernel on the card; the port's
    ctypes kernels are counted apart, in ops.LAUNCHES): a step's launch
    count at a fraction of torch.profiler's cost."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def profile_one_step(run, what: str, step_ms: float) -> None:
    """``run()`` once more under torch.profiler: summed device time of its
    kernels (the device-busy time) against the unprofiled mean ``step_ms``
    and the profiled wall, the kernel launches, the port's own kernels, the
    kernels that take most of the device time, and the host operations that
    take most of the host's time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    dev = lambda e: e.self_device_time_total / 1e3  # noqa: E731  (ms)
    busy = sum(dev(e) for e in kernels)
    print(f"  profiled {what}: device busy {busy:.1f} ms = {100 * busy / step_ms:.1f}% of "
          f"the unprofiled mean ({step_ms:.1f} ms), {100 * busy / wall_ms:.1f}% of the "
          f"profiled wall ({wall_ms:.1f} ms); {sum(e.count for e in kernels)} kernel launches "
          f"of {len(kernels)} names")
    for e in kernels:
        if any(f"{k}_kernel" in e.key for k in KERNELS):
            print(f"    port kernel {e.key}: {dev(e):.3f} ms x{e.count}")
    print("    device time by kernel (top 10):")
    for e in sorted(kernels, key=dev, reverse=True)[:10]:
        print(f"    {dev(e):9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    host = [e for e in events if e.device_type.name == "CPU"]
    cpu = lambda e: e.self_cpu_time_total / 1e3  # noqa: E731  (ms)
    print(f"    host self time by operation (top 8 of {sum(cpu(e) for e in host):.1f} ms, "
          f"profiler on):")
    for e in sorted(host, key=cpu, reverse=True)[:8]:
        print(f"    {cpu(e):9.3f} ms  x{e.count:<6d} {e.key[:90]}")


class ChurnRecorder:
    """The default churn draws, each (step, worker, round)'s pair kept."""

    def __init__(self):
        self.draws, self.seen = aggregate.seeded_churn_draws(0, DEV), {}

    def __call__(self, step, worker, rnd=None):
        self.seen[(step, worker, rnd)] = got = self.draws(step, worker, rnd)
        return got


def churn_line(comm: CommConfig, state, prev: dict, rec: ChurnRecorder, t: int) -> str:
    """One step's churn state: the live mask and n_eff (the live count),
    the pods' sync bits, and in the integrity program each worker's
    corruption flag (its recorded draw below the rate, alive, in the window)
    and its rounds quarantined this step (the tally's increment)."""
    c = state["comm"]
    alive = c["alive_prev"].tolist()
    out = f"; live mask {[int(a) for a in alive]} n_eff {max(sum(alive), 1.0):g}"
    if "pod_alive_prev" in c:
        out += f" pod bits {[int(a) for a in c['pod_alive_prev'].tolist()]}"
    if "quarantine_total" in c:
        window = aggregate.in_window(comm, t)
        flags = [int(window and alive[w] > 0 and float(rec.seen[(t, w, None)][1])
                     < comm.corruption_rate) for w in range(W)]
        q = [int(a - b) for a, b in zip(c["quarantine_total"].tolist(), prev.get("q", [0] * W))]
        prev["q"] = c["quarantine_total"].tolist()
        prev.setdefault("flags", []).append(flags)
        prev.setdefault("quarantined", []).append(q)
        out += (f"; corruption flags {flags} quarantined {q} qcount "
                f"{[int(x) for x in c['qcount'].tolist()]} escalations "
                f"{[int(x) for x in c['escalation_total'].tolist()]}")
    return out


def recount_quarantine(label: str, comm: CommConfig, state, prev: dict) -> None:
    """The integrity path's tallies against a recount from its printed
    per-worker flags: a quarantined round was flagged, the counter rule
    (cleared by a valid round, escalating at the limit) gives the
    escalations, and the path quarantined at least one round."""
    q_rounds = np.asarray(prev["quarantined"])
    flags = np.asarray(prev["flags"])
    count, esc = np.zeros(W), np.zeros(W)
    for qt in q_rounds:
        count = np.where(qt > 0, count + 1, 0)
        hit = count >= comm.quarantine_limit
        esc += hit
        count[hit] = 0
    c = state["comm"]
    got_q, got_e = c["quarantine_total"].tolist(), c["escalation_total"].tolist()
    print(f"  tallies: quarantined rounds {got_q}, escalations {got_e}; recount from the "
          f"printed flags: quarantined {q_rounds.sum(0).tolist()}, escalations {esc.tolist()}, "
          f"flagged {flags.sum(0).tolist()}")
    if (q_rounds > flags).any() or q_rounds.sum() == 0 or esc.tolist() != got_e \
            or q_rounds.sum(0).tolist() != got_q:
        raise AssertionError(f"path {label}: tallies {got_q} / {got_e} disagree with the "
                             f"recount or nothing was quarantined")


def run_trainer(label: str, comm_kw: dict, steps: int, lr: float, build: dict | None = None,
                profile_step: bool = False) -> dict[str, int]:
    """One trainer path; ``build`` may set "opt" (a key of OPTIMIZERS),
    "clip_norm", "microbatch", "pods", "rows" (a check of the parameter
    rows after each step: "pods" or "equal"), "eval" (one eval_step
    after the steps), "churn" (print the churn state after each step) and
    "keep" (keep the losses and parameters in KEPT; deterministic
    algorithms on).  Returns the launches of the run's steps."""
    cfg = get_config("qwen3-0.6b")
    shape = InputShape("train_1k", 1024, 8, "train")
    build = build or {}
    t0 = time.perf_counter()
    rec = ChurnRecorder()
    bundle = build_bundle(cfg, CommConfig(**comm_kw), OPTIMIZERS[build.get("opt", "momentum")](),
                          shape, n_workers=W, seed=0, device=DEV,
                          clip_norm=build.get("clip_norm", 0.0),
                          microbatch=build.get("microbatch", 1), pods=build.get("pods", 1),
                          churn_draws=rec)
    if label in SCHEME_TAGS:
        program, tag = SCHEME_TAGS[label]
        if not bundle.wire[program].get(tag):
            raise AssertionError(f"path {label}: booked nothing under {tag} in {program}")
    if label in WIRE_CHECKS:
        tag, want = WIRE_CHECKS[label][0], WIRE_CHECKS[label][1](bundle)
        got = bundle.wire["train"].get(tag, 0.0)
        if not math.isclose(got, want, rel_tol=1e-12):
            raise AssertionError(f"path {label}: booked {got} bytes under {tag}, want {want}")
    if label in AXES_CHECKS:
        check_axes(label, bundle)
    tr = Trainer(bundle, SyntheticBatches(cfg, shape, seed=0), constant(lr), log_every=1)
    state = tr.init(seed=0)
    torch.cuda.synchronize()
    print(f"trainer {label} ({comm_kw}, {bundle.opt.name}, lr {lr}"
          f"{', clip_norm %s' % bundle.clip_norm if bundle.clip_norm else ''}"
          f"{', microbatch %d' % bundle.microbatch if bundle.microbatch > 1 else ''}"
          f"{', %d pods x %d' % (bundle.pods, W // bundle.pods) if bundle.pods > 1 else ''}): "
          f"{len(bundle.bucket_plan.buckets)} buckets, "
          f"{sum(b.size for b in bundle.bucket_plan.buckets)} params, build+init "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    det = torch.are_deterministic_algorithms_enabled()
    if build.get("keep"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    ops.reset_launches()
    step_ms, churn_prev = [], {}
    for t in range(steps):
        t1 = time.perf_counter()
        state = tr.fit(state, 1, start_step=t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        loss = tr.history[-1]["loss"]
        kept = (f" kept {tr.history[-1]['kept']:.6f} of the elements"
                if "kept" in tr.history[-1] else "")
        if build.get("rows"):
            kept += check_rows(label, build["rows"], bundle.comm, state, t)
        if build.get("churn"):
            kept += churn_line(bundle.comm, state, churn_prev, rec, t)
        print(f"  step {t}: loss {loss:.6f} ce {tr.history[-1]['ce']:.6f} "
              f"step_ms {step_ms[-1]:.1f}{kept}")
        if not math.isfinite(loss):
            raise AssertionError(f"non-finite loss at step {t}: {loss}")
    launches = dict(ops.LAUNCHES)  # read before the eval and profiled steps, if any
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.use_deterministic_algorithms(det)
    if "flags" in churn_prev:
        recount_quarantine(label, bundle.comm, state, churn_prev)
    if build.get("keep"):
        KEPT[label] = ([h["loss"] for h in tr.history],
                       {k: v.detach().clone() for k, v in _tensor_leaves(state["params"]).items()})
    if build.get("eval"):
        t1 = time.perf_counter()
        ev = float(bundle.eval_step(state, tr._put(tr.data.batch(steps))))
        print(f"  eval_step on batch {steps}: loss {ev:.6f} in "
              f"{(time.perf_counter() - t1) * 1e3:.1f} ms")
        if not math.isfinite(ev):
            raise AssertionError(f"path {label}: non-finite eval loss {ev}")
    if profile_step:
        profile_one_step(lambda: tr.fit(state, 1, start_step=steps), f"step {steps}",
                         float(np.mean(step_ms[1:])))
    STEP_MS[label] = float(np.mean(step_ms[1:]))
    programs = [k for k in bundle.wire if not k.endswith("_formats")]
    if programs == ["train"]:  # the BSP paths: as printed before
        wire = {k: round(v / 1e3, 3) for k, v in bundle.wire["train"].items()}
        formats = {k: round(v / 1e3, 3) for k, v in bundle.wire["train_formats"].items()}
        booked = f"KB/step by tag {wire}, by format {formats}"
    else:
        per_call = {p: {k: round(v / 1e3, 3) for k, v in bundle.wire[p].items()}
                    for p in programs}
        formats = {p: {k: round(v / 1e3, 3) for k, v in bundle.wire[p + "_formats"].items()}
                   for p in programs}
        booked = (f"KB per call by program and tag {per_call}, by format {formats}; "
                  f"{wire_per_step(bundle, steps) / 1e3:.3f} KB/step over the run")
    if label in AXES_CHECKS or build.get("churn"):
        axes = {p: {",".join(a): round(v / 1e3, 3) for a, v in bundle.logs[p].by_axes().items()}
                for p in programs}
        booked += f"; KB per call by program and axes {axes}"
    print(f"  mean step_ms (first step excluded) {np.mean(step_ms[1:]):.1f}; booked wire "
          f"{booked}; peak memory {peak:.2f} GiB; launches {launches}")
    del state, tr, bundle
    torch.cuda.empty_cache()
    return launches


def _leaves_close(got: dict, want: dict, what: str) -> list[str]:
    """Names of the leaves outside rtol 1e-4 / atol 1e-5 x the leaf's largest
    magnitude; prints the largest max-abs error over the leaves."""
    bad, worst = [], (0.0, "", 0.0)
    for path, w in want.items():
        g, w = got[path].to(torch.float32), w.to(torch.float32)
        err, top = float((g - w).abs().max()), float(w.abs().max())
        worst = max(worst, (err, path, top))
        if not _close(g, w, rtol=1e-4, atol=1e-5 * max(1.0, top)):
            bad.append(f"{what} {path}")
    print(f"  {what}: {len(want)} leaves, largest max abs err {worst[0]:.3e} ({worst[1]}, "
          f"whose largest magnitude is {worst[2]:.3e}), {len(bad)} outside tolerance")
    return bad


#: the checkpoint phase cuts qwen3-0.6b to 2 layers at full width: the
#: whole local-SGD state at 28 layers (bf16 params and f32 momentum, W rows
#: each) is 13.3 GiB on disk, 4.2 GiB at 2
CKPT_LAYERS = 2


def _tensor_leaves(tree) -> dict:
    return {k: v for k, v in flat(tree).items() if isinstance(v, torch.Tensor)}


def check_checkpoint() -> None:
    """Path (w)'s local SGD (H 2) at full width and 2 layers: save after
    step 1 (a sync step) through ``Trainer.save``, restore through
    ``Trainer.restore``; every leaf must come back bitwise.  Then one more
    step from the live state and one from the restored one, under
    deterministic algorithms (the embedding's backward accumulates with
    atomics otherwise), must agree bitwise: loss and every leaf."""
    cfg = get_config("qwen3-0.6b").with_updates(n_layers=CKPT_LAYERS)
    shape = InputShape("train_1k", 1024, 8, "train")
    bundle = build_bundle(cfg, CommConfig(sync="local", local_steps=2), momentum_sgd(0.9),
                          shape, n_workers=W, seed=0, device=DEV)
    tr = Trainer(bundle, SyntheticBatches(cfg, shape, seed=0), constant(0.01), log_every=1)
    state = tr.fit(tr.init(seed=0), 2)
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.save(f"{d}/step2", state, 2)
        save_s = time.perf_counter() - t0
        size = sum(f.stat().st_size for f in Path(d, "step2").iterdir())
        t0 = time.perf_counter()
        back, step = tr.restore(f"{d}/step2")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    live, got = _tensor_leaves(state), _tensor_leaves(back)
    bad = [k for k in live if not torch.equal(live[k], got[k])]
    if step != 2 or back["step"] != 2 or live.keys() != got.keys() or bad:
        raise AssertionError(f"checkpoint: restored step {step}, leaves differ at {bad}")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        n = len(tr.history)
        state = tr.fit(state, 1, start_step=2)
        back = tr.fit(back, 1, start_step=2)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    live, got = _tensor_leaves(state), _tensor_leaves(back)
    after = [k for k in live if not torch.equal(live[k], got[k])]
    losses = (tr.history[n]["loss"], tr.history[n + 1]["loss"])
    print(f"checkpoint ({cfg.name}, {CKPT_LAYERS} layers at full width, local SGD H 2, W {W}): "
          f"{len(live)} leaves, {size / 2**30:.2f} GiB on disk; save {save_s:.1f} s, restore "
          f"{restore_s:.1f} s; restored leaves bitwise; the next step's loss {losses[0]:.6f} "
          f"live, {losses[1]:.6f} restored; leaves differing after it: {len(after)}")
    if losses[0] != losses[1] or after:
        raise AssertionError(f"checkpoint: the step after the restore differs: losses {losses}, "
                             f"leaves {after}")
    del state, back, tr, bundle, live, got
    torch.cuda.empty_cache()


def check_pipelined_staleness0() -> None:
    """The staleness-0 pipelined step against the sequential one, dense, 2
    microbatches, at full width cut to CKPT_LAYERS layers in f32: 2 steps of
    each from one state (one set of initial weights), losses and every
    parameter within rtol 1e-5 / atol 1e-7.  The pipelined rounds run on
    the side stream, so a missing wait or a buffer reused too early shows
    here."""
    cfg = get_config("qwen3-0.6b").with_updates(n_layers=CKPT_LAYERS, param_dtype="float32",
                                                compute_dtype="float32")
    shape = InputShape("train_1k", 1024, 8, "train")
    out = {}
    for name, kw in (("sequential", {}), ("pipelined", dict(overlap="pipelined",
                                                           overlap_staleness=0))):
        bundle = build_bundle(cfg, CommConfig(**kw), momentum_sgd(0.9), shape, n_workers=W,
                              seed=0, device=DEV, microbatch=2)
        tr = Trainer(bundle, SyntheticBatches(cfg, shape, seed=0), constant(0.01), log_every=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.fit(tr.init(seed=0), 2)
        torch.cuda.synchronize()
        out[name] = ([h["loss"] for h in tr.history],
                     {k: v.detach() for k, v in _tensor_leaves(state["params"]).items()},
                     (time.perf_counter() - t0) * 1e3 / 2)
        del bundle, tr, state
    (ls, ps, ms_s), (lp, pp, ms_p) = out["sequential"], out["pipelined"]
    bad = [k for k in ps if not _close(pp[k], ps[k], rtol=1e-5, atol=1e-7)]
    worst = max(float((pp[k] - ps[k]).abs().max()) for k in ps)
    print(f"pipelined staleness 0 vs sequential ({cfg.name} f32, {CKPT_LAYERS} layers at full "
          f"width, dense, W {W}, 2 microbatches, 2 steps): losses {lp} / {ls}; {len(ps)} "
          f"parameter leaves, largest max abs err {worst:.3e}, {len(bad)} outside rtol 1e-5 / "
          f"atol 1e-7; ms per step {ms_p:.1f} / {ms_s:.1f} (first step included)")
    if bad or not np.allclose(lp, ls, rtol=1e-5, atol=1e-7):
        raise AssertionError(f"pipelined staleness 0 differs from sequential: losses {lp} vs "
                             f"{ls}, leaves {bad}")
    del out, ps, pp
    torch.cuda.empty_cache()


def check_row_kernels(rows: int, n: int, timed: bool) -> dict[str, dict]:
    """The three row launches against their plain versions on a (rows, n)
    stack with per-row levels (4, 8, 16 and 127 in turn) and per-row inv:
    codes bitwise, e' (fresh and in place) within rtol 1e-6."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(rows * 7 + n)
    x = torch.randn((rows, n), generator=gen, device=DEV) * 0.1
    x.view(-1)[::7] = 0.0
    e = torch.randn((rows, n), generator=gen, device=DEV) * 0.05
    u = torch.rand((rows, n), generator=gen, device=DEV)
    lv = torch.tensor([4.0, 8.0, 16.0, 127.0], device=DEV).repeat(rows // 4 + 1)[:rows].contiguous()
    out: dict[str, dict] = {}

    inv = torch.reciprocal(torch.clamp_min(torch.linalg.vector_norm(x, dim=-1), 1e-30))
    codes = torch.empty((rows, n), dtype=torch.int8, device=DEV)
    run_q = lambda: ops.qsgd_codes_rows_into(x, u, inv, lv, codes)  # noqa: E731
    run_q()
    plain = ref.qsgd_codes_rows(x, u, inv, lv)
    err = int((codes.int() - plain.int()).abs().max())
    out["qsgd_rows"] = {"max_abs_err": float(err), "ok": err == 0,
                        "detail": f"codes differ at {int((codes != plain).sum())}"}
    if timed:
        out["qsgd_rows"].update(ms=ms_per_call(run_q, 50), plain_ms=ms_per_call(
            lambda: ref.qsgd_codes_rows(x, u, inv, lv), 20),
            device_ms=device_ms(run_q, 50, "qsgd_rows_kernel"))

    a = e + x
    inv_a = torch.reciprocal(torch.clamp_min(torch.linalg.vector_norm(a, dim=-1), 1e-30))
    e_new = torch.empty_like(e)
    run_ef = lambda: ops.qsgd_ef_rows_into(x, e, u, inv_a, lv, 1.0, codes, e_new)  # noqa: E731
    run_ef()
    plain_c, plain_e = ref.qsgd_ef_rows(x, e, u, inv_a, lv, torch.tensor(1.0, device=DEV))
    codes_ok = torch.equal(codes, plain_c)
    e_ok = _close(e_new, plain_e, rtol=1e-6, atol=0.0)
    e_in = e.clone()
    ops.qsgd_ef_rows_into(x, e_in, u, inv_a, lv, 1.0, codes, e_in)
    codes_ok &= torch.equal(codes, plain_c)
    e_ok &= _close(e_in, plain_e, rtol=1e-6, atol=0.0)
    out["qsgd_ef_rows"] = {"max_abs_err": max(float((e_new - plain_e).abs().max()),
                                              float((e_in - plain_e).abs().max())),
                           "ok": codes_ok and e_ok,
                           "detail": f"codes bitwise {codes_ok}, e' (fresh and in place) "
                                     f"within rtol 1e-6 {e_ok}"}
    if timed:
        out["qsgd_ef_rows"].update(ms=ms_per_call(run_ef, 50), plain_ms=ms_per_call(
            lambda: ref.qsgd_ef_rows(x, e, u, inv_a, lv, torch.tensor(1.0, device=DEV)), 20),
            device_ms=device_ms(run_ef, 50, "qsgd_ef_rows_kernel"))

    inv_t = torch.reciprocal(torch.clamp_min(torch.amax(torch.abs(x), dim=-1), 1e-30))
    u.view(-1)[5::13] = (torch.abs(x) * inv_t[:, None]).view(-1)[5::13]  # u == p: strict compare
    run_t = lambda: ops.terngrad_codes_rows_into(x, u, inv_t, codes)  # noqa: E731
    run_t()
    plain = ref.terngrad_codes_rows(x, u, inv_t)
    err = int((codes.int() - plain.int()).abs().max())
    out["terngrad_rows"] = {"max_abs_err": float(err), "ok": err == 0,
                            "detail": f"codes differ at {int((codes != plain).sum())}"}
    if timed:
        out["terngrad_rows"].update(ms=ms_per_call(run_t, 50), plain_ms=ms_per_call(
            lambda: ref.terngrad_codes_rows(x, u, inv_t), 20),
            device_ms=device_ms(run_t, 50, "terngrad_rows_kernel"))
    return out


@contextlib.contextmanager
def plain_rows():
    """Route the engine's row launches (and the flat sign pack / unpack that
    its per-row-padded stacks go through) to their plain versions on the
    card, for a comparison under the same draws; nothing is counted."""
    saved = {k: getattr(ops, k) for k in ("qsgd_codes_rows_into", "qsgd_ef_rows_into",
                                          "terngrad_codes_rows_into", "sign_pack",
                                          "sign_unpack")}

    def qsgd_plain(x, u, inv, levels, out):
        out.copy_(ref.qsgd_codes_rows(x, u, inv, levels))

    def qsgd_ef_plain(g, e, u, inv, levels, decay, codes, e_out):
        c, en = ref.qsgd_ef_rows(g, e, u, inv, levels, torch.full((), decay, device=g.device))
        codes.copy_(c)
        e_out.copy_(en)

    def tern_plain(x, u, inv, out):
        out.copy_(ref.terngrad_codes_rows(x, u, inv))

    ops.qsgd_codes_rows_into, ops.qsgd_ef_rows_into = qsgd_plain, qsgd_ef_plain
    ops.terngrad_codes_rows_into = tern_plain
    ops.sign_pack = lambda x, out=None: ref.sign_pack(x, ops.sign_packed_bytes(x.numel()))
    ops.sign_unpack = ref.sign_unpack
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


def _series_dev(a: list, b: list, rtol: float, atol: float) -> tuple[float, int]:
    """The largest |a - b| / (atol + rtol |b|) over the loss and consensus
    series of two result lists, and the number of cells above 1."""
    worst, over = 0.0, 0
    for x, y in zip(a, b):
        cell = 0.0
        for k in ("loss", "consensus"):
            d = np.abs(x.series[k] - y.series[k])
            bound = atol + rtol * np.abs(y.series[k])
            cell = max(cell, float(np.max(np.divide(d, bound, out=np.where(d > 0, np.inf, 0.0),
                                                    where=bound > 0))))
        worst, over = max(worst, cell), over + (cell > 1)
    return worst, over


def _bits_dev(a: list, b: list) -> float:
    return max(float(np.max(np.abs(x.series["bits"] - y.series["bits"])
                            / np.maximum(np.abs(y.series["bits"]), 1.0))) for x, y in zip(a, b))


def _check_finite(label: str, results: list) -> None:
    for r in results:
        if not all(np.isfinite(r.series[k]).all() for k in ("loss", "consensus", "bits")):
            raise AssertionError(f"engine {label}: non-finite series in {r.tag}")
        if not np.all(r.series["bits"][:, -1] > 0):
            raise AssertionError(f"engine {label}: no wire bits booked in {r.tag}")


def _sweep(label: str, scenarios: list, replicas: int, want: dict[str, int]) -> tuple:
    """One sweep through the runner on the card: (results, wall s, the
    sweep's peak MiB above what was allocated before it, class programs
    built); launches must equal ``want`` exactly."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launches()
    built = simulate.engine_cache_stats().compiles
    t0 = time.perf_counter()
    res = runner.run_scenarios(scenarios, "training", replicas=replicas, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"engine {label}: must launch exactly {full}: {got}")
    _check_finite(label, res)
    return (res, wall, (torch.cuda.max_memory_allocated() - base) / 2**20,
            simulate.engine_cache_stats().compiles - built)


def run_engine(card: str) -> dict[str, int]:
    """Phase 8, E1-E5; returns the engine's launches by kernel."""
    launches = {k: 0 for k in KERNELS}
    sweep = runner.sweep_matrix_45(problem_seeds=(0, 1))
    classes = {runner.training_shape_key(s) for s in sweep}
    if len(sweep) != 90 or len(classes) != 5:
        raise AssertionError(f"engine: the sweep has {len(sweep)} cells in {len(classes)} classes")
    steps = sweep[0].steps
    simulate.engine_cache_clear()
    e1, wall, peak, built = _sweep("E1", sweep, 3, {})
    if built != 5:
        raise AssertionError(f"engine E1: built {built} class programs, want 5")
    _, warm, _, rebuilt = _sweep("E1 warm", sweep, 3, {})
    print(f"engine E1 ({card}): 90 cells x 3 replicas x 8 workers (2,160 rows of dim 64), "
          f"{steps} steps, qsgd EF: sweep wall {wall:.3f} s cold ({90 / wall:.1f} cells/s), "
          f"{warm:.3f} s warm ({90 / warm:.1f} cells/s, {warm / (5 * steps) * 1e3:.3f} ms per "
          f"class step); {built} class programs built, {rebuilt} on the warm sweep; peak "
          f"memory {peak:.1f} MiB; final loss {min(r.measured['final_loss'] for r in e1):.4f}-"
          f"{max(r.measured['final_loss'] for r in e1):.4f}")

    kern = [s.replace(compressor="qsgd_kernel") for s in sweep]
    e2, wall2, peak2, built2 = _sweep("E2", kern, 3, {"qsgd_ef": 5 * steps})
    launches["qsgd_ef"] += 5 * steps
    with plain_rows():
        e2p, _, _, _ = _sweep("E2 plain", kern, 3, {})
    dev_p, over_p = _series_dev(e2, e2p, rtol=1e-6, atol=0.0)
    bits_p = _bits_dev(e2, e2p)
    bitwise = all(np.array_equal(a.series[k], b.series[k]) for a, b in zip(e2, e2p)
                  for k in ("loss", "consensus", "bits"))
    dev_1, over_1 = _series_dev(e2, e1, rtol=2e-4, atol=1e-6)
    bits_1 = _bits_dev(e2, e1)
    print(f"engine E2 qsgd_kernel ({card}): sweep wall {wall2:.3f} s ({90 / wall2:.1f} cells/s), "
          f"{built2} class programs, peak {peak2:.1f} MiB, qsgd_ef row launches "
          f"{5 * steps}; against the plain versions on the card: series bitwise {bitwise}, "
          f"largest |d| / (rtol 1e-6 |plain|) {dev_p:.3g}, bits {bits_p:.3g}; against E1's "
          f"plain qsgd: bits {bits_1:.3g}, {90 - over_1} of 90 cells within rtol 2e-4 / atol "
          f"1e-6 (largest ratio {dev_1:.3g})")
    if built2 != 5 or over_p or bits_p > 1e-6 or bits_1 > 1e-6:
        raise AssertionError(f"engine E2: built {built2}, {over_p} cells off the plain "
                             f"versions, bits off by {bits_p} / {bits_1}")

    for comp, kernels in (("qsgd_kernel", ("qsgd",)), ("terngrad_kernel", ("terngrad",)),
                          ("signsgd_packed", ("sign_pack", "sign_unpack"))):
        cell = runner.REFERENCE_SPEEDUP_CELL.replace(
            compressor=comp, error_feedback=False, steps=E3_STEPS,
            compressor_kwargs={"levels": 16} if comp == "qsgd_kernel" else ())
        want = {k: E3_STEPS for k in kernels}
        got, wall3, _, _ = _sweep(f"E3 {comp}", [cell], 3, want)
        with plain_rows():
            plain, _, _, _ = _sweep(f"E3 {comp} plain", [cell], 3, {})
        dev3, over3 = _series_dev(got, plain, rtol=1e-6, atol=0.0)
        bitwise = all(np.array_equal(got[0].series[k], plain[0].series[k])
                      for k in ("loss", "consensus", "bits"))
        print(f"engine E3 {comp} ({card}): BSP, 8 workers, {E3_STEPS} steps, 3 replicas: "
              f"{wall3 * 1e3 / E3_STEPS:.3f} ms per step, launches {want}; against the plain "
              f"versions: series bitwise {bitwise}, largest ratio {dev3:.3g}; final loss "
              f"{got[0].measured['final_loss']:.6f}")
        if over3 or _bits_dev(got, plain) > 1e-6:
            raise AssertionError(f"engine E3 {comp}: off its plain versions ({dev3})")
        for k in kernels:
            launches[k] += E3_STEPS

    ops.reset_launches()
    sp = runner.measure_engine_speedup(device=DEV)
    print(f"engine E4 ({card}): {sp['cell']}, {sp['replicas']} replicas, {sp['steps']} steps: "
          f"engine {sp['engine_s_cold']:.3f} s cold / {sp['engine_s_warm']:.3f} s warm, loop "
          f"reference {sp['reference_s']:.3f} s: speedup {sp['speedup_cold']:.2f} cold / "
          f"{sp['speedup_warm']:.2f} warm; series |d| / (1e-5 + 2e-4 |loop|) loss "
          f"{sp['max_rel_dev_loss']:.3g}, consensus {sp['max_rel_dev_consensus']:.3g}; bits "
          f"{sp['max_rel_dev_bits']:.3g}")
    if max(sp["max_rel_dev_loss"], sp["max_rel_dev_consensus"]) > 1 \
            or sp["max_rel_dev_bits"] > 1e-6:
        raise AssertionError(f"engine E4: engine and loop reference disagree: {sp}")

    with tempfile.TemporaryDirectory() as tmp:
        for substrate in ("training", "timeline"):
            path = str(Path(tmp) / f"{substrate}.json")
            t0 = time.perf_counter()
            rc = sweep_cli.main(["--substrate", substrate, "--emit-json", path, "--no-speedup"])
            torch.cuda.synchronize()
            rec = json.loads(Path(path).read_text())
            vals = [v for c in rec["cells"] for v in c["measured"].values()]
            print(f"engine E5 ({card}): --substrate {substrate}: rc {rc}, {rec['n_cells']} cells "
                  f"in {time.perf_counter() - t0:.3f} s"
                  + (f", {rec['engine']['compiles']} class programs for "
                     f"{rec['engine']['n_shape_classes']} classes" if "engine" in rec else ""))
            if rc != 0 or not rec["n_cells"] or not all(math.isfinite(v) for v in vals) \
                    or ("engine" in rec
                        and rec["engine"]["compiles"] > rec["engine"]["n_shape_classes"]):
                raise AssertionError(f"engine E5 {substrate}: rc {rc}, record {rec}")
    return launches


def check_churn_twin() -> None:
    """(ah): the dropout-0 churn path against its churn-free twin, both
    under deterministic algorithms from one seed: losses and every
    parameter within rtol 1e-6."""
    (lt, pt), (lc, pc) = KEPT.pop("(ah) twin qsgd ef"), KEPT.pop("(ah) qsgd ef churn0")
    bad = [k for k in pt if not _close(pc[k].float(), pt[k].float(), rtol=1e-6, atol=0.0)]
    bitwise = lt == lc and all(torch.equal(pc[k], pt[k]) for k in pt)
    print(f"(ah) churn=True at dropout 0 against the churn-free twin: losses {lc} / {lt}; "
          f"{len(pt)} parameter leaves, {len(bad)} outside rtol 1e-6; bitwise {bitwise}")
    if bad or not np.allclose(lc, lt, rtol=1e-6, atol=0.0):
        raise AssertionError(f"(ah): the churn path left its twin: losses {lc} / {lt}, {bad}")


#: BSP churn cells of BENCH_churn.json's engine leg (benchmarks/churn_bench.py
#: churn_matrix): 3 policies x 3 dropout rates, 8 workers, 250 steps
CHURN_POLICIES = (("qsgd", {"levels": 4}), ("qsgd", {"levels": 16}),
                  ("adaptive_qsgd", {"var_target": 0.5}))
CHURN_RATES = (0.0, 0.1, 0.3)


def _bench_cell(**kw) -> Scenario:
    base = dict(sync="bsp", n_workers=8, steps=250, lr=0.05, error_feedback=True, churn=True,
                seed=0)
    return Scenario(**{**base, **kw})


def _leg_line(label: str, card: str, cells: list, wall: float, built: int, peak: float,
              launches: dict) -> str:
    return (f"engine {label} ({card}): {len(cells)} cells x 3 replicas x "
            f"{cells[0].n_workers} workers, {cells[0].steps} steps: wall {wall:.3f} s "
            f"({len(cells) / wall:.1f} cells/s), {built} class programs, launches {launches}, "
            f"peak {peak:.1f} MiB")


def _converges(label: str, results: list) -> dict:
    """Each cell's replica-mean loss series: finite and ending below its
    start; returns them by tag."""
    out = {}
    for r in results:
        loss = r.series["loss"].mean(axis=0)
        if not (np.isfinite(loss).all() and loss[-1] < loss[0]):
            raise AssertionError(f"engine {label}: {r.tag} does not converge: {loss[[0, -1]]}")
        out[r.tag] = loss
    return out


def run_churn_engine(card: str) -> int:
    """The churn legs C1, C1k, C2, C3 and the dropout-0 twin; returns the
    qsgd_ef row launches (C1k)."""
    c1 = [_bench_cell(compressor=c, compressor_kwargs=kw, dropout_rate=r)
          for c, kw in CHURN_POLICIES for r in CHURN_RATES]
    simulate.engine_cache_clear()
    res, wall, peak, built = _sweep("C1", c1, 3, {})
    print(_leg_line("C1 churn", card, c1, wall, built, peak, {}))
    loss = _converges("C1", res)
    final = {(c.compressor, dict(c.compressor_kwargs).get("levels"), c.dropout_rate):
             float(loss[r.tag][-1]) for c, r in zip(c1, res)}
    adaptive = final[("adaptive_qsgd", None, 0.3)]
    statics = [final[("qsgd", lv, 0.3)] for lv in (4, 16)]
    print(f"  final losses at 30% dropout: adaptive_qsgd {adaptive:.6f}, static qsgd 4 / 16 "
          f"{statics[0]:.6f} / {statics[1]:.6f}; by cell {final}")
    if built != 2 or not adaptive < max(statics):
        raise AssertionError(f"engine C1: {built} class programs (want 2); adaptive {adaptive} "
                             f"against statics {statics}")

    c1k = [c.replace(compressor="qsgd_kernel") for c in c1 if c.compressor == "qsgd"]
    steps = c1k[0].steps
    res_k, wall, peak, built = _sweep("C1k", c1k, 3, {"qsgd_ef": steps})
    print(_leg_line("C1k qsgd_kernel", card, c1k, wall, built, peak, {"qsgd_ef": steps}))
    _converges("C1k", res_k)
    if built != 1:
        raise AssertionError(f"engine C1k: {built} class programs, want 1")

    twin = [c.replace(churn=False) for c in c1 if c.dropout_rate == 0.0]
    res_t, _, _, _ = _sweep("C1 churn-free twins", twin, 3, {})
    churn0 = [r for c, r in zip(c1, res) if c.dropout_rate == 0.0]
    dev, over = _series_dev(churn0, res_t, rtol=1e-5, atol=1e-6)
    bitwise = all(np.array_equal(a.series[k], b.series[k]) for a, b in zip(churn0, res_t)
                  for k in ("loss", "consensus", "bits"))
    print(f"engine dropout-0 churn cells against their churn-free twins ({card}): "
          f"{len(twin)} cells, largest |d| / (1e-6 + 1e-5 |twin|) {dev:.3g}, bitwise {bitwise}")
    if over or _bits_dev(churn0, res_t) > 1e-6:
        raise AssertionError(f"engine: a dropout-0 churn cell left its twin ({dev})")

    window = dict(sync="local", local_steps=5, steps=200, compressor="qsgd",
                  compressor_kwargs={"levels": 16}, dropout_rate=0.3, churn_start=50,
                  churn_end=150)
    c2 = [_bench_cell(**window, rejoin_policy=p) for p in ("reset", "pull_avg")]
    simulate.engine_cache_clear()
    res2, wall, peak, built = _sweep("C2", c2, 3, {})
    print(_leg_line("C2 rejoin", card, c2, wall, built, peak, {}))
    _converges("C2", res2)
    gb = {c.rejoin_policy: r.measured["gbits"] for c, r in zip(c2, res2)}
    print(f"  Gbits reset {gb['reset']:.6f}, pull_avg {gb['pull_avg']:.6f} (the pull's "
          f"download); final loss {[round(r.measured['final_loss'], 6) for r in res2]}")
    if built != 2 or not gb["pull_avg"] > gb["reset"]:
        raise AssertionError(f"engine C2: {built} class programs (want 2), Gbits {gb}")

    c3 = [_bench_cell(steps=200, compressor=c, compressor_kwargs=kw, dropout_rate=0.0,
                      corruption_rate=0.1 if kind != "none" else 0.0, corruption_kind=kind)
          for c, kw in (("qsgd", {"levels": 16}), ("adaptive_qsgd", {"var_target": 0.5}))
          for kind in ("none", "bitflip", "nan")]
    simulate.engine_cache_clear()
    res3, wall, peak, built = _sweep("C3", c3, 3, {})
    print(_leg_line("C3 integrity", card, c3, wall, built, peak, {}))
    _converges("C3", res3)
    clean = {c.compressor: r.measured["final_loss"] for c, r in zip(c3, res3)
             if c.corruption_kind == "none"}
    for c, r in zip(c3, res3):
        m = r.measured
        if c.corruption_kind == "none":
            continue
        print(f"  {r.tag}: final loss {m['final_loss']:.6f} (clean twin "
              f"{clean[c.compressor]:.6f}), quarantined rounds {m['quarantine_rounds']:g}, "
              f"quarantined Gbits {m['quarantined_gbits']:.6g}, escalations {m['escalations']:g}")
        if not (m["quarantine_rounds"] > 0 and m["quarantined_gbits"] > 0
                and m["final_loss"] <= 2.0 * clean[c.compressor]):
            raise AssertionError(f"engine C3: {r.tag}: {m}")
    if built != 6:
        raise AssertionError(f"engine C3: {built} class programs, want 6")
    return steps


def check_rwkv_path() -> None:
    """rwkv6-3b at full width, f32, 4 layers: prefill and 8 decode steps
    through kernel wkv6 against the plain wkv_scan fed the same tokens."""
    cfg = get_config("rwkv6-3b").with_updates(n_layers=4, param_dtype="float32",
                                              compute_dtype="float32")
    B, S, steps = 2, 256, 8
    params = T.init_params(cfg, 0, DEV)
    toks = torch.from_numpy(SyntheticBatches(cfg, InputShape("p", S, B, "prefill"), seed=0)
                            .batch(0)["tokens"]).to(DEV)
    with torch.inference_mode():
        last_k, cache_k = T.prefill(cfg, params, {"tokens": toks}, use_kernel=True)
        last_p, cache_p = T.prefill(cfg, params, {"tokens": toks}, use_kernel=False)
        bad = _leaves_close({"last": last_k}, {"last": last_p}, "prefill")
        bad += _leaves_close(flat(cache_k), flat(cache_p), "prefill cache")
        tok = torch.zeros((B, 1), dtype=torch.int32, device=DEV)
        agree = True
        for _ in range(steps):
            nxt, cache_k = T.decode_step(cfg, params, cache_k, tok, use_kernel=True)
            own, cache_p = T.decode_step(cfg, params, cache_p, tok, use_kernel=False)
            agree &= torch.equal(nxt, own)
            tok = nxt
        bad += _leaves_close(flat(cache_k), flat(cache_p), "decoded cache")
    print(f"rwkv path kernel vs plain ({cfg.name} {cfg.compute_dtype}, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, batch {B}, prompt {S}, {steps} decode tokens): greedy "
          f"tokens agree {agree}; last kernel tokens {tok[:, 0].tolist()}")
    if bad:
        raise AssertionError(f"rwkv path: kernel and plain disagree at {bad}")
    del params, cache_k, cache_p
    torch.cuda.empty_cache()


#: check_rwkv_train_path's gradients, kernels against the plain scan: the
#: chunked forward holds y within rtol 3e-4 / atol 3e-5 of the scan
#: (check_wkv6), so the leaves are held an order looser than a plain f32
#: comparison, at rtol 1e-3 / atol 1e-4 x the leaf's largest magnitude
TRAIN_GRAD_RTOL = 1e-3


def check_rwkv_train_path() -> None:
    """rwkv6-3b at full width, f32 (TF32 off), 2 layers, the list layout,
    batch 2, seq 256, remat="full": every leaf's gradient of forward_loss
    through kernels wkv6, wkv6_bwd_states and wkv6_bwd (exactly 2 wkv6
    launches a layer, the forward and its recomputation, and the backward's
    1 wkv6_bwd_states and 1 wkv6_bwd) against
    the plain scan's, within TRAIN_GRAD_RTOL; the losses within 1e-5."""
    cfg = get_config("rwkv6-3b").with_updates(n_layers=2, param_dtype="float32",
                                              compute_dtype="float32", scan_layers=False)
    B, S = 2, 256
    params = T.init_params(cfg, 0, DEV)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in SyntheticBatches(
        cfg, InputShape("t", S, B, "train"), seed=0).batch(0).items()}
    leaves = flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    out = {}
    for use_kernel in (True, False):
        ops.reset_launches()
        loss, _ = T.forward_loss(cfg, params, batch, use_kernel=use_kernel)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        out[use_kernel] = (float(loss.detach()), dict(zip(leaves, grads)),
                           {k: v for k, v in ops.LAUNCHES.items() if v})
    ops.reset_launches()
    want = {"wkv6": 2 * cfg.n_layers, "wkv6_bwd_states": cfg.n_layers,
            "wkv6_bwd": cfg.n_layers}
    bad, worst = [], (0.0, "")
    for path, w in out[False][1].items():
        g, top = out[True][1][path], float(w.abs().max())
        ratio = float(((g - w).abs() / (TRAIN_GRAD_RTOL * (w.abs() + 0.1 * top))).max())
        worst = max(worst, (ratio, path))
        if not _close(g, w, TRAIN_GRAD_RTOL, 0.1 * TRAIN_GRAD_RTOL * top) or not top:
            bad.append(path)
    gap = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    print(f"rwkv training kernels vs plain ({cfg.name} f32, {cfg.n_layers} layers, batch {B}, "
          f"seq {S}, remat {cfg.remat}): loss {out[True][0]:.7f} vs {out[False][0]:.7f} "
          f"(relative gap {gap:.2e}); {len(leaves)} leaves, largest error over its tolerance "
          f"{worst[0]:.3f} ({worst[1]}), {len(bad)} outside; launches {out[True][2]} "
          f"(plain {out[False][2] or 'none'})")
    if bad or gap > 1e-5 or out[True][2] != want or out[False][2]:
        raise AssertionError(f"rwkv training path: leaves {bad}, loss gap {gap}, launches "
                             f"{out[True][2]} (want {want}), plain {out[False][2]}")
    del params, leaves, out
    torch.cuda.empty_cache()


def run_server(profile_step: bool) -> int:
    """The server phase; returns the launches of kernel wkv6."""
    cfg = get_config("rwkv6-3b")
    torch.cuda.empty_cache()
    print(f"server {cfg.name} ({cfg.compute_dtype}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}): batch "
          f"{SERVE_B}, prompt {SERVE_PROMPT}, {SERVE_DECODE} decode tokens")
    ops.reset_launches()
    res = serve.run(cfg, prompt_len=SERVE_PROMPT, batch=SERVE_B, decode=SERVE_DECODE,
                    device=DEV, seed=0)
    launches = dict(ops.LAUNCHES)
    want = {k: 0 for k in launches}
    want["wkv6"] = cfg.n_layers * (1 + SERVE_DECODE)
    tokens = res["tokens"]
    print(f"  prefill {res['prefill_ms']:.1f} ms; decode {res['decode_ms'] / SERVE_DECODE:.2f} "
          f"ms per token ({res['tok_per_s']:.1f} tok/s over {SERVE_B} sequences); peak memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB (weights included); launches {launches}")
    if launches != want:
        raise AssertionError(f"server: must launch exactly {want}: {launches}")
    if tokens.shape != (SERVE_B, SERVE_DECODE) or tokens.min() < 0 \
            or tokens.max() >= cfg.vocab or not bool(torch.isfinite(res["last"]).all()):
        raise AssertionError(f"server: bad output, tokens {tokens.shape} in "
                             f"[{tokens.min()}, {tokens.max()}], last finite "
                             f"{bool(torch.isfinite(res['last']).all())}")
    if profile_step:
        step, params, cache = res["bundle"].serve_step, res["params"], res["cache"]
        tok = torch.from_numpy(tokens[:, -1:]).to(DEV)
        profile_one_step(lambda: step(params, cache, tok), "decode step",
                         res["decode_ms"] / SERVE_DECODE)
    del res
    torch.cuda.empty_cache()
    return launches["wkv6"]


# ---------------------------------------------------------------------------
# Phase T: the sweep CLI's trainer and roofline substrates.
# ---------------------------------------------------------------------------

#: T3's grid on run.py's trainer lane: 16 raw cells, of which the
#: scenario's rules drop threshold on the compressed wire (no
#: compressed-domain reduction)
T3_GRID = ("compressor=qsgd_kernel:levels=16,terngrad_kernel,signsgd_packed,threshold:tau=0.001 "
           "wire_format=compressed,dense error_feedback=true,false")
#: the kernels a bucket of each (compressor, route) launches per step that
#: runs the route: "send" once per worker, "recv" once (the rule of PATHS),
#: "decode" once per worker's gathered payload and, under error feedback,
#: once more per worker for its own residual (e' = a - C(a)); every other
#: pair launches none
ROUTE_KERNELS = {
    ("qsgd_kernel", "fused_ef"): {"qsgd_ef": "send", "int8_acc": "recv"},
    ("qsgd_kernel", "int8_acc"): {"qsgd": "send", "int8_acc": "recv"},
    ("qsgd_kernel", "gather"): {"qsgd": "send"},
    ("qsgd", "int8_acc"): {"int8_acc": "recv"},
    ("terngrad_kernel", "tern"): {"terngrad": "send", "tern_pack": "send", "tern_acc": "recv"},
    ("terngrad_kernel", "gather"): {"terngrad": "send"},
    ("terngrad", "tern"): {"tern_pack": "send", "tern_acc": "recv"},
    ("signsgd_packed", "sign"): {"sign_pack": "send", "sign_vote": "recv"},
    ("signsgd_packed", "gather"): {"sign_pack": "send", "sign_unpack": "decode"},
    ("signsgd", "sign"): {"sign_pack": "send", "sign_vote": "recv"},
    ("threshold", "sum"): {"threshold": "send"},
    ("adaptive_threshold", "sum"): {"threshold": "send"},
}


def route_launches(comm: CommConfig, plan, workers: int, steps: int) -> dict[str, int]:
    """The launches a cell's CommConfig routes: per bucket of ``plan`` its
    route's kernels (ROUTE_KERNELS), x workers for the send side, x the
    kernel-running steps of a ``steps``-step run (``kernel_steps``).  A
    gossip cell mixes parameters: its CHOCO compressors are not covered."""
    if comm.aggregator == "gossip":
        if comm.gossip_compress == "choco" and comm.compressor != "none":
            raise ValueError("route_launches: no rule for CHOCO's compressors")
        return {}
    per_step: dict[str, int] = {}
    for b in plan.buckets:
        comp = plan.compressor(b)
        route = aggregate.bucket_route(comm, comp)
        for k, side in ROUTE_KERNELS.get((b.compressor_name, route), {}).items():
            n = {"send": workers, "recv": 1,
                 "decode": workers * (2 if comm.error_feedback else 1)}[side]
            per_step[k] = per_step.get(k, 0) + n
    n = kernel_steps(comm, steps)
    return {k: v * n for k, v in per_step.items()}


@contextlib.contextmanager
def launches_per_cell():
    """Each trainer cell's launches (the counts' change over its run), as
    (scenario, workers, launches), recorded around
    ``trainer_substrate.run_trainer_scenario``, which the sweep calls per
    cell."""
    seen, real = [], trainer_substrate.run_trainer_scenario

    def counted(s, **kw):
        before = dict(ops.LAUNCHES)
        r = real(s, **kw)
        seen.append((s, kw["data_par"], {k: v - before[k] for k, v in ops.LAUNCHES.items()
                                         if v != before[k]}))
        return r

    trainer_substrate.run_trainer_scenario = counted
    try:
        yield seen
    finally:
        trainer_substrate.run_trainer_scenario = real


#: T1's steps: the matrix's 24 cut to 5 to keep the script inside its time
#: limit.  The local cells average every 4 steps and a step's loss is
#: logged before its average, so 5 is the least count whose loss series
#: (shared and per cell, held alike) reads averaged parameters (step 4)
T1_STEPS = 5
#: T3's steps: 3 (all its cells are BSP); its check (each cell's exact
#: launches) is per step
T3_STEPS = 3


def run_phase_t(card: str) -> None:
    """T1 the trainer sweep's registry record, T2 the overlap twin, T3 the
    trainer lane of run.py on kernel cells, T4 the train_micro twin's cells,
    T5 the roofline lane; nothing is written into the tree."""
    t_phase = time.perf_counter()
    tiny = trainer_substrate.make_tiny_workload()[0]

    ops.reset_launches()
    with deterministic():
        rec = trainer_substrate.measure_trainer_sweep(
            trainer_substrate.trainer_matrix_16(steps=T1_STEPS), device=DEV)
    print(f"phase T1 ({card}): trainer_matrix_16 ({rec['n_cells']} cells, W = 4 stacked, "
          f"{rec['steps']} steps, deterministic algorithms): {rec['n_shape_classes']} classes, "
          f"builds shared {rec['builds_shared']} / per cell {rec['builds_percell']}, hits "
          f"{rec['cache_hits']}; shared {rec['shared_s']:.3f} s ({rec['n_cells'] / rec['shared_s']:.2f} "
          f"cells/s), per cell {rec['percell_s']:.3f} s ({rec['n_cells'] / rec['percell_s']:.2f} "
          f"cells/s), x{rec['speedup']:.3f}; max_rel_dev_loss {rec['max_rel_dev_loss']:.3g}; "
          f"launches {dict(ops.LAUNCHES)}")
    if rec["builds_shared"] > rec["n_shape_classes"] or rec["builds_percell"] != rec["n_cells"] \
            or not rec["max_rel_dev_loss"] < 1e-5 or any(ops.LAUNCHES.values()):
        raise AssertionError(f"phase T1: {rec}, launches {dict(ops.LAUNCHES)}")

    t0 = time.perf_counter()
    with deterministic():
        ov = overlap_bench.measure(DEV)
    print(f"phase T2 ({card}): overlap matrix, {ov['n_cells']} cells in {ov['n_shape_classes']} "
          f"classes (W = {ov['n_workers_stacked']}, microbatch {ov['microbatch']}, {ov['steps']} "
          f"steps): {ov['builds']} builds, {ov['cache_hits']} hits (the re-run included), sweep "
          f"{ov['sweep_wall_clock_s']:.3f} s, worst pipelined / sequential loss "
          f"{ov['worst_pipelined_loss_ratio']:.5f} (ssp(1) reference "
          f"{ov['staleness_reference']['sim_ssp1_ratio']:.5f}); {time.perf_counter() - t0:.1f} s")
    for p in ov["pairs"]:
        print(f"  {p['tag']}: overlap_saving_s measured {p['measured_overlap_saving_s']:.6f}, "
              f"predicted {p['predicted_overlap_saving_s']:.6f}; loss / sequential "
              f"{p['loss_ratio_vs_sequential']:.5f}")

    t0 = time.perf_counter()
    raw = sweep_cli.parse_grid(T3_GRID, n_workers=W, steps=T3_STEPS)
    kept = set(expand(raw, substrate="trainer"))
    for s in raw:
        if s not in kept:
            print(f"  T3 dropped {s.tag()}: {'; '.join(s.violations('trainer'))}")
    with tempfile.TemporaryDirectory() as tmp, launches_per_cell() as seen:
        path = str(Path(tmp) / "trainer.json")
        rc = sweep_cli.main(["--substrate", "trainer", "--device", str(DEV), "--workers", str(W),
                             "--steps", str(T3_STEPS), "--grid", T3_GRID, "--emit-json", path])
        t3 = json.loads(Path(path).read_text())
    if rc != 0 or t3["n_cells"] != len(kept) or len(seen) != len(kept):
        raise AssertionError(f"phase T3: rc {rc}, {t3['n_cells']} cells, {len(seen)} runs, "
                             f"want {len(kept)}")
    for s, dp, got in seen:
        comm = trainer_substrate.to_comm_config(s)
        want = route_launches(comm, aggregate.make_bucket_plan(comm, T.param_defs(tiny)), dp,
                              s.steps)
        print(f"  T3 {s.tag()}: W = {dp}, launches {got}")
        if got != want:
            raise AssertionError(f"phase T3 {s.tag()}: must launch exactly {want}: {got}")
    vals = [v for c in t3["cells"] for v in (c["measured"]["final_loss"],
                                             c["measured"]["wire_kb_per_step"])]
    print(f"phase T3 ({card}): run.py --substrate trainer, {len(raw)} cells in the grid, "
          f"{t3['n_cells']} run, bundle {t3['bundle']}; {time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"phase T3: non-finite loss or wire in {t3['cells']}")

    t0 = time.perf_counter()
    for cell in train_micro.micro_cells(DEV):
        b = cell["bundle"]
        want = route_launches(cell["comm"], b.bucket_plan, b.n_workers, cell["steps"])
        fmt = {k: round(v / 1e3, 3) for k, v in cell["formats"].items() if v}
        print(f"  T4 train_micro/{cell['tag']}: {cell['us'] / 1e3:.3f} ms per step (median of "
              f"{train_micro.REPS}), wire {cell['wire'] / 1e3:.3f} KB per step {fmt}, "
              f"launches {cell['launches']}")
        if cell["launches"] != want:
            raise AssertionError(f"phase T4 {cell['tag']}: must launch exactly {want}: "
                                 f"{cell['launches']}")
    print(f"phase T4 ({card}): the train_micro twin's nine cells in "
          f"{time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "roofline.json")
        rc = sweep_cli.main(["--substrate", "roofline", "--emit-json", path])
        t5 = json.loads(Path(path).read_text())
    terms = [c["measured"][k] for c in t5["cells"]
             for k in ("t_compute", "t_memory", "t_collective", "iter_time_bound")]
    print(f"phase T5: run.py --substrate roofline, {t5['n_cells']} cells, bottlenecks "
          f"{sorted({c['measured']['bottleneck'] for c in t5['cells']})}, all terms finite "
          f"{all(math.isfinite(v) for v in terms)}")
    if rc != 0 or not t5["n_cells"] or not all(math.isfinite(v) for v in terms):
        raise AssertionError(f"phase T5: rc {rc}, record {t5}")
    print(f"phase T: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase B: the paper's benchmark suite (repro_torch.benchmarks.run).
# ---------------------------------------------------------------------------

#: the orchestrator's tags phase T does not run (sec7_overlap is T2,
#: train_micro T4)
B_TAGS = ("tableIII_allreduce", "tableIV_comm_cost", "tableII_fig4_sync", "fig6_compression",
          "tableIV_convergence", "sweep_batched", "sec7_schedule", "elastic", "kernels",
          "coldstart")
#: each tag's row prefix, and the prefix of its claims row (None: the
#: reference's module asserts nothing and prints no such row)
B_PREFIX = {"tableIII_allreduce": "tableIII", "tableIV_comm_cost": "tableIV",
            "tableII_fig4_sync": "tableII", "fig6_compression": "fig6",
            "tableIV_convergence": "convergence", "sweep_batched": "sweep",
            "sec7_schedule": "schedule", "elastic": "churn", "kernels": "kernels",
            "coldstart": "coldstart"}
B_CLAIMS = {**B_PREFIX, "tableIV_comm_cost": None}


def run_phase_b(card: str) -> None:
    """The ten tags through the orchestrator with ``--no-speedup``, records
    into a temporary directory; each tag's claims row, the kernels bench's
    byte model and launches, the cold start's acceptance."""
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.benchmarks import run as bench_run

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench_run.main(["--only", ",".join(B_TAGS), "--no-speedup", "--device",
                                 str(DEV), "--out-dir", tmp])
        recs = {p.stem: json.loads(p.read_text()) for p in Path(tmp).glob("*.json")}
    lines = buf.getvalue().splitlines()
    walls = {ln.split()[1]: float(ln.split()[4][:-1]) for ln in lines
             if ln.startswith("# ") and " done in " in ln}
    claims = {ln.split("/")[0] for ln in lines if ln.endswith("/claims_validated,0.00,True")}
    ok = {tag: tag in walls and (B_CLAIMS[tag] is None or B_CLAIMS[tag] in claims)
          for tag in B_TAGS}
    for tag in B_TAGS:
        n_rows = sum(1 for ln in lines if ln.startswith(B_PREFIX[tag] + "/"))
        how = (f"its {B_CLAIMS[tag]}/claims_validated row" if B_CLAIMS[tag] else
               "asserted; the reference's Table IV prints no claims row")
        print(f"phase B {tag}: {walls.get(tag, float('nan')):.1f} s, {n_rows} rows, claims "
              f"validated {ok[tag]} ({how})")
    if rc != 0 or not all(ok.values()):
        print("\n".join(lines[-60:]))
        raise AssertionError(f"phase B: rc {rc}, walls {walls}, claims {sorted(claims)}")

    kb = recs["BENCH_torch_kernels"]
    ref = json.loads((Path(__file__).resolve().parent / "BENCH_kernels.json").read_text())
    for name, fam in ref["families"].items():
        got = kb["families"][name]
        if (got["fused_bytes"], got["composed_bytes"]) != (fam["fused_bytes"],
                                                          fam["composed_bytes"]):
            raise AssertionError(f"phase B kernels {name}: byte model {got} against {fam}")
    # the bench covers the reference's kernels; wkv6's backward has no counterpart there
    if sorted(k for k, v in kb["launches"].items() if v > 0) != \
            sorted(set(ops.LAUNCHES) - {"wkv6_bwd_states", "wkv6_bwd"}):
        raise AssertionError(f"phase B kernels: every kernel must launch: {kb['launches']}")
    print(f"phase B kernels bench: byte model equal to BENCH_kernels.json at n = "
          f"{kernels_bench.N}, launches {kb['launches']}")
    for n, rec in kb["sizes"].items():
        for name, f in rec["families"].items():
            gbs = {k: f.get(k, math.nan) for k in ("fused_gb_per_s", "fused_share_of_hbm",
                                                   "composed_gb_per_s")}
            print(f"  kernels n={n} x W={kb['workers']} {name}: fused {f['fused_us'] / 1e3:.4f} "
                  f"ms ({gbs['fused_gb_per_s']:.1f} GB/s, "
                  f"{100 * gbs['fused_share_of_hbm']:.1f}% of 3.35 TB/s), composed "
                  f"{f['composed_us'] / 1e3:.4f} ms ({gbs['composed_gb_per_s']:.1f} GB/s); bytes "
                  f"{f['fused_bytes']:.0f} / {f['composed_bytes']:.0f}; max |fused - composed| "
                  f"{f['max_abs_diff']}")
        print(f"  kernels n={n} qsgd levels resweep: {rec['qsgd_levels_resweep']}")

    cs = recs["BENCH_torch_coldstart"]
    st = cs["start"]
    print(f"phase B coldstart start: cold {st['cold_build_s']:.3f} s ({st['nvcc_builds_cold']} "
          f"nvcc builds of {st['libraries']}), warm {st['warm_build_s']:.3f} s "
          f"({st['nvcc_builds_warm']} nvcc builds); build and both first sweeps, cold over "
          f"warm, x{st['wall_ratio_with_build']:.3f}")
    for layer in ("engine", "trainer"):
        c = cs[layer]
        print(f"phase B coldstart {layer}: cold cache {c['cold_cache_s']:.3f} s, warm cache "
              f"{c['warm_cache_s']:.3f} s, warm process {c['warm_process_s']:.3f} s; "
              f"x{c['disk_speedup']:.3f}; persistent cold {c['persistent_cold']['hits']} hits / "
              f"{c['persistent_cold']['misses']} misses, warm {c['persistent_warm']['hits']} / "
              f"{c['persistent_warm']['misses']}")
        if c["persistent_warm"]["misses"]:
            raise AssertionError(f"phase B coldstart {layer}: the warm cache missed: {c}")
    if st["nvcc_builds_warm"]:
        raise AssertionError(f"phase B coldstart: the warm cache built: {st}")
    cal = cs["calibration"]
    pr = cal["profile"]
    print(f"phase B calibration ({card}): alpha {pr['alpha']:.4e} s, beta {pr['beta']:.4e} s/B, "
          f"t_launch {pr['t_launch']:.4e} s, t_step_dense {pr['t_step_dense']:.4f} s; step-time "
          f"rel-err {cal['relerr_step_time_before']:.4f} -> {cal['relerr_step_time_after']:.4f}, "
          f"overlap-saving rel-err {cal['relerr_overlap_saving_before']} -> "
          f"{cal['relerr_overlap_saving_after']} ({cal['n_cells']} cells)")
    if not cal["relerr_step_time_after"] < cal["relerr_step_time_before"]:
        raise AssertionError(f"phase B calibration: rel-err did not improve: {cal}")
    print(f"phase B: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase F: the MoE, MLA and dense-variant families through the trainer.
# ---------------------------------------------------------------------------

#: (label, arch, layers kept (published), W, seq, CommConfig fields, the
#: kernels the path must launch, bf16-vs-f32 check).  Full published width,
#: bf16, global batch 8, 3 steps, momentum SGD lr 0.01; depth cut to one
#: whole period of the layer pattern so that the state fits 80 GB at W = 4:
#: qwen3-moe-30b-a3b 2 of 48 layers, deepseek-v2-lite-16b its dense layer 0
#: and 2 MoE layers of 27, glm4-9b 2 of 40, qwen1.5-32b 1 of 64 and
#: gemma3-12b one 5 local : 1 global period, 6 of 48, at seq 2048 so that
#: its window of 1024 is shorter than the sequence (W = 2: its embedding
#: bucket alone is 1,006,632,960 elements)
F_PATHS = (
    ("(an) qwen3-moe qsgd ef", "qwen3-moe-30b-a3b", 2, 4, 1024, QSGD_EF,
     ("qsgd_ef", "int8_acc"), True),
    ("(ao) qwen3-moe signsgd_packed ef, router qsgd", "qwen3-moe-30b-a3b", 2, 4, 1024,
     dict(compressor="signsgd_packed", wire_format="compressed", error_feedback=True,
          per_tensor_rules=[("router", "qsgd_kernel", {"levels": 16})]),
     ("sign_pack", "sign_vote", "qsgd_ef", "int8_acc"), False),
    ("(ap) deepseek-v2-lite terngrad ef", "deepseek-v2-lite-16b", 3, 4, 1024,
     dict(compressor="terngrad_kernel", wire_format="compressed", error_feedback=True),
     ("terngrad", "tern_pack", "tern_acc"), True),
    ("(aq) glm4 threshold ef", "glm4-9b", 2, 4, 1024,
     dict(compressor="threshold", compressor_kwargs={"tau": 1e-3}, error_feedback=True),
     ("threshold",), False),
    ("(ar) qwen1.5-32b qsgd ef", "qwen1.5-32b", 1, 4, 1024, QSGD_EF,
     ("qsgd_ef", "int8_acc"), False),
    ("(as) gemma3 qsgd", "gemma3-12b", 6, 2, 2048, QSGD16, ("qsgd", "int8_acc"), True),
    # the recurrent families: rwkv6-3b cut to 16 of 32 layers for memory (W
    # EF rows and gradients of its 2.93B parameters would need ~94 GB);
    # hymba-1.5b to one pattern period (16 of 32) for the script's time
    ("(az) rwkv6-3b qsgd ef", "rwkv6-3b", 16, 4, 1024, QSGD_EF,
     ("qsgd_ef", "int8_acc", "wkv6", "wkv6_bwd_states", "wkv6_bwd"), True),
    ("(ba) hymba terngrad ef", "hymba-1.5b", 16, 4, 1024,
     dict(compressor="terngrad_kernel", wire_format="compressed", error_feedback=True),
     ("terngrad", "tern_pack", "tern_acc"), False),
    # the vision and audio families at full depth: qwen2-vl-2b's 1.55B and
    # seamless's 1.77B parameters fit W = 4 stacked EF rows
    ("(bc) qwen2-vl qsgd ef", "qwen2-vl-2b", 28, 4, 1024, QSGD_EF, ("qsgd_ef", "int8_acc"),
     True),
    ("(bd) seamless signsgd_packed ef", "seamless-m4t-large-v2", 24, 4, 1024,
     dict(compressor="signsgd_packed", wire_format="compressed", error_feedback=True),
     ("sign_pack", "sign_vote"), True),
)
F_STEPS, F_BATCH, F_LR = 3, 8, 0.01
#: a path whose peak passes this drops to W = 2 (the card holds 80 GB)
F_PEAK_GIB = 76.0
#: the bf16 trainer's first loss against the same forward in f32 (TF32 off)
F_BF16_RTOL = 2e-2


def predict_grad_agg(bundle) -> float:
    """The bytes a train call books under grad_agg, from the bucket plan:
    per bucket, by its route, each worker's payload all-gathered, p(n-1)
    (the int8 codes and a 4-byte norm; a packed 1-bit row; a packed 2-bit
    row and a 4-byte scale), or the f32 sum all-reduced, 2p(n-1)/n."""
    n, total = bundle.n_workers, 0.0
    for b in bundle.bucket_plan.buckets:
        route = aggregate.bucket_route(bundle.comm, bundle.bucket_plan.compressor(b))
        if route in ("fused_ef", "int8_acc"):
            total += (b.size + 4) * (n - 1)
        elif route == "sign":
            total += ops.sign_packed_bytes(b.size) * (n - 1)
        elif route == "tern":
            total += (ops.tern_packed_bytes(b.size) + 4) * (n - 1)
        elif route == "sum":
            total += 4 * b.size * 2 * (n - 1) / n
        else:
            raise AssertionError(f"predict_grad_agg: no rule for route {route}")
    return total


def _f32_first_loss(cfg, params, batch: dict, workers: int) -> float:
    """The worker mean of the forward loss with the parameters upcast to
    f32 and f32 compute (TF32 off), on the first step's batch."""
    cfg32 = cfg.with_updates(param_dtype="float32", compute_dtype="float32", remat="none")
    p32 = tree_map(lambda t: t.detach().float(), params)
    rows = batch["tokens"].shape[0] // workers
    with torch.no_grad():
        losses = [float(T.forward_loss(cfg32, p32, {k: v[w * rows:(w + 1) * rows]
                                                    for k, v in batch.items()})[0])
                  for w in range(workers)]
    del p32
    torch.cuda.empty_cache()
    return float(np.mean(losses))


def run_family_path(label: str, arch: str, layers: int, workers: int, seq: int, comm_kw: dict,
                    kernels: tuple, bf16_check: bool, card: str,
                    profile_step: bool = False) -> dict[str, int]:
    """One phase F path: 3 trainer steps; its step ms (the first excluded),
    launches (exactly ``kernels``, as many times as the bucket plan's routes
    call them), booked grad_agg against the plan's prediction to the byte,
    peak memory and largest bucket; for ``bf16_check`` the first loss
    against the f32 forward; ``profile_step``: one more step under
    torch.profiler, after the launches are read.  Returns the launches of
    its steps."""
    cfg = get_config(arch).with_updates(n_layers=layers)
    shape = InputShape(f"train_{seq}", seq, F_BATCH, "train")
    comm = CommConfig(**comm_kw)
    t0 = time.perf_counter()
    bundle = build_bundle(cfg, comm, momentum_sgd(0.9), shape, n_workers=workers, seed=0,
                          device=DEV)
    tr = Trainer(bundle, SyntheticBatches(cfg, shape, seed=0), constant(F_LR), log_every=1)
    state = tr.init(seed=0)
    torch.cuda.synchronize()
    buckets = bundle.bucket_plan.buckets
    big = max(buckets, key=lambda b: b.size)
    print(f"family {label}: {arch} {layers} of {get_config(arch).n_layers} layers at full "
          f"width, W {workers}, seq {seq}, global batch {F_BATCH}, {comm_kw}: {len(buckets)} "
          f"buckets, {sum(b.size for b in buckets)} params, largest bucket {big.name} "
          f"{big.size} elements (x W = {big.size * workers}); build+init "
          f"{time.perf_counter() - t0:.2f} s ({card})")
    f32_loss = None
    if bf16_check:
        f32_loss = _f32_first_loss(cfg, state["params"], tr._put(tr.data.batch(0)), workers)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    step_ms = []
    counter = OpCounter()
    for t in range(F_STEPS):
        t1 = time.perf_counter()
        # the first step, left out of the mean, counts its operations
        with counter if t == 0 else contextlib.nullcontext():
            state = tr.fit(state, 1, start_step=t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        h = tr.history[-1]
        print(f"  step {t}: loss {h['loss']:.6f} ce {h['ce']:.6f} aux {h['aux']:.6f} "
              f"step_ms {step_ms[-1]:.1f}")
        if not all(math.isfinite(h[k]) for k in ("loss", "ce", "aux")):
            raise AssertionError(f"family {label}: non-finite metrics at step {t}: {h}")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = route_launches(comm, bundle.bucket_plan, workers, F_STEPS)
    if cfg.family == "ssm":  # under remat="full" each layer runs wkv6 twice (the
        # forward and its recomputation) and its backward's two launches once,
        # per worker and step
        want.update(wkv6=2 * layers * workers * F_STEPS,
                    wkv6_bwd_states=layers * workers * F_STEPS,
                    wkv6_bwd=layers * workers * F_STEPS)
    got = {k: v for k, v in launches.items() if v}
    booked, predicted = bundle.wire["train"].get("grad_agg", 0.0), predict_grad_agg(bundle)
    print(f"  mean step_ms (first step excluded) {np.mean(step_ms[1:]):.1f}; launches {got}; "
          f"booked wire KB/step by tag "
          f"{ {k: round(v / 1e3, 3) for k, v in bundle.wire['train'].items()} }, grad_agg "
          f"{booked:.0f} B against the plan's {predicted:.0f} B; peak memory {peak:.2f} GiB "
          f"({card})")
    if f32_loss is not None:
        gap = abs(tr.history[0]["loss"] - f32_loss) / abs(f32_loss)
        print(f"  first loss bf16 {tr.history[0]['loss']:.6f} against f32 {f32_loss:.6f}: "
              f"relative gap {gap:.3e} (bound {F_BF16_RTOL})")
        if not gap <= F_BF16_RTOL:
            raise AssertionError(f"family {label}: bf16 loss off the f32 one by {gap}")
    if got != want or sorted(got) != sorted(kernels):
        raise AssertionError(f"family {label}: must launch exactly {want} ({kernels}): {got}")
    if booked != predicted:
        raise AssertionError(f"family {label}: booked {booked} B under grad_agg, the plan "
                             f"predicts {predicted} B")
    if peak > F_PEAK_GIB:
        raise AssertionError(f"family {label}: peak {peak:.2f} GiB > {F_PEAK_GIB}: drop to W 2")
    print(f"  {counter.n} aten operations dispatched in step 0"
          + (f"; selective scan in chunks of L = {SM.SCAN_CHUNK} steps: {seq // SM.SCAN_CHUNK} "
             f"loop iterations a layer and pass" if cfg.family == "hybrid" else ""))
    if profile_step:
        profile_one_step(lambda: tr.fit(state, 1, start_step=F_STEPS), f"step {F_STEPS}",
                         float(np.mean(step_ms[1:])))
    STEP_MS[label] = float(np.mean(step_ms[1:]))
    del state, tr, bundle
    torch.cuda.empty_cache()
    return launches


#: tokens of the full-width moe_ffn check: one worker's rows of (an)
MOE_TOKENS = (2, 1024)


def check_moe_ffn() -> None:
    """``moe_ffn`` on 2,048 tokens of one qwen3-moe-30b-a3b layer at full
    width, parameters in f32 and TF32 off, against the plain per-expert
    loop (``models/moe_ref.py``) at the configured capacity factor, with the
    initial router and under a skewed load (every token routed to expert 0:
    tokens must drop), and at cf = E / k (none may): rtol 1e-4 / atol 1e-5
    x max|y|.  Then, with E / 8 experts starved (their router columns
    zeroed), an expert's wi / wg / wo gradient is exactly zero iff the loop
    kept none of its tokens."""
    from repro_torch.models import layers as L
    from repro_torch.models.moe_ref import moe_ffn_loop

    cfg = get_config("qwen3-moe-30b-a3b").with_updates(n_layers=1, param_dtype="float32",
                                                       compute_dtype="float32")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    p = materialize(L.moe_defs(cfg, make_plan(cfg)), gen, torch.float32, DEV)
    x = torch.randn((*MOE_TOKENS, cfg.d_model), generator=gen, device=DEV)
    T_, k, E = MOE_TOKENS[0] * MOE_TOKENS[1], cfg.experts_per_token, cfg.n_experts
    # a skewed load: every token shifted along u, and expert 0's router
    # column along u, so every token routes to expert 0 (T > C)
    u = torch.randn(cfg.d_model, generator=gen, device=DEV)
    router = p["router"].clone()
    router[:, 0] = u / torch.linalg.vector_norm(u)
    # (what, params, input, cf, must drop): the initial router, the skewed
    # load (the buffers overflow) and cf = E / k (C = T: nothing may drop)
    for what, pr, xx, cf, drops in (
            ("initial router", p, x, cfg.moe_capacity_factor, None),
            ("skewed load", dict(p, router=router), x + u, cfg.moe_capacity_factor, True),
            ("initial router", p, x, E / k, False)):
        with torch.no_grad():
            y, aux = L.moe_ffn(cfg, pr, xx, capacity_factor=cf)
            want, kept = moe_ffn_loop(pr, xx, k=k, capacity_factor=cf)
        err, top = float((y - want).abs().max()), float(want.abs().max())
        C = L.moe_capacity(cfg, T_, cf)
        dropped = T_ * k - int(kept.sum())
        print(f"moe_ffn qwen3-moe-30b-a3b layer at full width, {T_} tokens, {what}, cf "
              f"{cf:g} (C {C}): max abs err {err:.3e} against the plain loop (max|y| "
              f"{top:.3e}); {dropped} of {T_ * k} choices dropped; aux {float(aux):.6f}")
        if not _close(y, want, rtol=1e-4, atol=1e-5 * top):
            raise AssertionError(f"moe_ffn at cf {cf}: max abs err {err} against the loop")
        if drops is not None and (dropped > 0) != drops:
            raise AssertionError(f"moe_ffn at cf {cf}: {dropped} choices dropped")
    # a zero logit loses to the k-th largest of E - ns others unless fewer
    # than k of them are positive (odds ~1e-24 at 112 others, k = 8)
    ns = E // 8  # 16 of qwen3-moe's 128
    starved = dict(p, router=torch.cat([torch.zeros_like(p["router"][:, :ns]),
                                        p["router"][:, ns:]], dim=1))
    w = {n: starved[n].detach().requires_grad_(True) for n in ("wi", "wg", "wo")}
    y, _ = L.moe_ffn(cfg, {**starved, **w}, x)
    r = torch.randn(y.shape, generator=gen, device=DEV)
    grads = torch.autograd.grad((y * r).sum(), list(w.values()))
    with torch.no_grad():
        _, kept = moe_ffn_loop(starved, x, k=k, capacity_factor=cfg.moe_capacity_factor)
    nonzero = [torch.count_nonzero(g.reshape(E, -1), dim=1) > 0 for g in grads]
    routed = kept > 0
    print(f"moe_ffn gradients, {ns} experts starved: {int((~routed).sum())} experts kept no "
          f"token; their wi / wg / wo gradients zero "
          f"{[bool((~nz[~routed]).all()) for nz in nonzero]}, every other expert's nonzero "
          f"{[bool(nz[routed].all()) for nz in nonzero]}")
    if any(not torch.equal(nz, routed) for nz in nonzero) or routed[:ns].any():
        raise AssertionError("moe_ffn: an expert's gradient is nonzero without a kept token, "
                             "or zero with one")
    del p, starved, w, grads, y
    torch.cuda.empty_cache()


def check_windowed_attention() -> None:
    """gemma3-12b's local ``attention`` (window 1024) at full width, seq
    2048, f32 and TF32 off, at query chunks 1024 (the reference's default:
    window + chunk covers the sequence) and 512 (each chunk reads 1,536
    keys), against a plain attention with the explicit window mask:
    rtol 1e-4 / atol 1e-5 x max|o|."""
    from repro_torch.models import layers as L

    cfg = get_config("gemma3-12b").with_updates(n_layers=6, param_dtype="float32",
                                                compute_dtype="float32")
    B, S = 2, 2048
    gen = torch.Generator(device=DEV)
    gen.manual_seed(6)
    p = materialize(L.attn_defs(cfg, make_plan(cfg)), gen, torch.float32, DEV)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=DEV)
    pos = T.make_positions(cfg, B, S, DEV)
    with torch.no_grad():
        q = L.rmsnorm(p["q_norm"], torch.einsum("bsd,dhk->bshk", x, p["wq"]))
        kk = L.rmsnorm(p["k_norm"], torch.einsum("bsd,dhk->bshk", x, p["wk"]))
        vv = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        q, kk = L.apply_rope(cfg, q, pos), L.apply_rope(cfg, kk, pos)
        rep = cfg.n_heads // cfg.n_kv_heads
        kk, vv = kk.repeat_interleave(rep, 2), vv.repeat_interleave(rep, 2)
        s = torch.einsum("bqhk,bshk->bhqs", q, kk) * cfg.resolved_head_dim ** -0.5
        ar = torch.arange(S, device=DEV)
        s = s.masked_fill(~L.window_mask(ar, ar, cfg.window), -1e30)
        want = torch.einsum("bhqs,bshk,hkd->bqd", torch.softmax(s, -1), vv, p["wo"])
        del s
        top = float(want.abs().max())
        for qc in (1024, 512):
            got = L.attention(cfg, p, x, positions=pos, window=cfg.window, q_chunk=qc)
            err = float((got - want).abs().max())
            print(f"windowed attention gemma3-12b local layer at full width, seq {S}, window "
                  f"{cfg.window}, q_chunk {qc} (keys per chunk {min(S, cfg.window + qc)}): max "
                  f"abs err {err:.3e} against the plain masked attention (max|o| {top:.3e})")
            if not _close(got, want, rtol=1e-4, atol=1e-5 * top):
                raise AssertionError(f"windowed attention at q_chunk {qc}: max abs err {err}")
    del p, x, want, got
    torch.cuda.empty_cache()


#: (ar)'s embedding bucket: qwen1.5-32b's 152,064 x 5,120 embedding, W = 4
#: rows, 3,114,270,720 elements in one call (past 2**31)
BIG_N, BIG_W, BIG_SLICE = 778_567_680, 4, 2**20


def check_past_2e31() -> dict[str, dict]:
    """``qsgd_ef``'s row-batched entry and ``int8_acc`` on a (4, 778,567,680)
    stack, e' in place as the trainer writes it: against the plain versions
    on the first and last 2**20 elements of each row and on the 2**20
    around flat index 2**31 (the whole plain version does not fit beside
    the kernels' buffers): codes bitwise, e' rtol 1e-6, the sum rtol 1e-6 /
    atol 1e-5; each timed beside its byte bound."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(31)
    shape = (BIG_W, BIG_N)
    g = torch.randn(shape, generator=gen, device=DEV).mul_(0.1)
    e = torch.randn(shape, generator=gen, device=DEV).mul_(0.05)
    u = torch.rand(shape, generator=gen, device=DEV)
    decay = 0.9
    inv = torch.stack([torch.reciprocal(torch.clamp_min(torch.linalg.vector_norm(
        e[r] * decay + g[r]), 1e-30)) for r in range(BIG_W)])
    levels = torch.full((BIG_W,), 16.0, device=DEV)
    # the flat index 2**31 (row 2, column 590,348,288 here)
    row, mid = divmod(min(2**31, BIG_W * BIG_N // 2), BIG_N)
    lo = min(max(mid - BIG_SLICE // 2, 0), BIG_N - BIG_SLICE)
    cols = [(r, slice(0, BIG_SLICE)) for r in range(BIG_W)]
    cols += [(r, slice(BIG_N - BIG_SLICE, BIG_N)) for r in range(BIG_W)]
    cols += [(row, slice(lo, lo + BIG_SLICE))]
    saved = [(r, sl, g[r, sl].clone(), e[r, sl].clone(), u[r, sl].clone()) for r, sl in cols]
    codes = torch.empty(shape, dtype=torch.int8, device=DEV)
    ops.qsgd_ef_rows_into(g, e, u, inv, levels, decay, codes, e)
    torch.cuda.synchronize()
    bad, worst_e = [], 0.0
    for r, sl, gs, es, us in saved:
        c, en = ref.qsgd_ef_rows(gs[None], es[None], us[None], inv[r:r + 1], levels[r:r + 1],
                                 torch.full((), decay, device=DEV))
        worst_e = max(worst_e, float((e[r, sl] - en[0]).abs().max()))
        if not torch.equal(codes[r, sl], c[0]) or not _close(e[r, sl], en[0], 1e-6, 0.0):
            bad.append(f"qsgd_ef row {r} [{sl.start}, {sl.stop})")
    wt = torch.tensor([0.3, -1.2, 0.7, 2.0], device=DEV)
    out = ops.int8_weighted_sum(codes, wt)
    torch.cuda.synchronize()
    worst_s = 0.0
    for _, sl, *_ in saved[BIG_W:]:
        want = ref.int8_acc(codes[:, sl], wt)
        worst_s = max(worst_s, float((out[sl] - want).abs().max()))
        if not _close(out[sl], want, 1e-6, 1e-5):
            bad.append(f"int8_acc [{sl.start}, {sl.stop})")
    ms_q = ms_per_call(lambda: ops.qsgd_ef_rows_into(g, e, u, inv, levels, decay, codes, e), 3)
    ms_a = ms_per_call(lambda: ops.int8_weighted_sum(codes, wt), 5)
    dec = torch.full((), decay, device=DEV)
    # the plain qsgd_ef row by row (its temporaries for the whole stack do
    # not fit beside the buffers), the plain int8_acc on the whole stack
    plain_q = ms_per_call(lambda: [ref.qsgd_ef_rows(g[r:r + 1], e[r:r + 1], u[r:r + 1],
                                                    inv[r:r + 1], levels[r:r + 1], dec)
                                   for r in range(BIG_W)], 1)
    plain_a = ms_per_call(lambda: ref.int8_acc(codes, wt), 1)
    total = BIG_W * BIG_N
    res = {}
    for name, ms, plain, errv in (("qsgd_ef", ms_q, plain_q, worst_e),
                                  ("int8_acc", ms_a, plain_a, worst_s)):
        rk = ROW_KERNELS["qsgd_ef_rows"]
        b_ms, b_by = (_bound(rk["bytes"](BIG_W, BIG_N), rk["ops"](BIG_W, BIG_N))
                      if name == "qsgd_ef" else bound(name, BIG_N, BIG_W))
        print(f"kernel {name} past 2**31: ({BIG_W}, {BIG_N}) = {total} elements in one call, "
              f"{ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}%), plain "
              f"{plain:.4f} ms, max abs err {errv:.3e} on the compared slices")
        res[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, max_abs_err=errv)
    if bad:
        raise AssertionError(f"past 2**31: kernels disagree with their plain versions: {bad}")
    del g, e, u, codes, out
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase M: the model axis in training, data 4 x model 2 stacked on the card.
# ---------------------------------------------------------------------------

TERN_EF = dict(compressor="terngrad_kernel", wire_format="compressed", error_feedback=True)
#: (label, arch, layers kept, workers W, model shards M, comm, kernels): full
#: width, bf16, seq 1024, global batch 8, 3 steps; deepseek cut as (ap)
M_PATHS = (
    ("(bg) qwen3-0.6b qsgd ef, data 4 x model 2", "qwen3-0.6b", 28, 4, 2, QSGD_EF,
     ("qsgd_ef", "int8_acc")),
    ("(bh) deepseek-v2-lite terngrad ef, data 4 x model 2", "deepseek-v2-lite-16b", 3, 4, 2,
     TERN_EF, ("terngrad", "tern_pack", "tern_acc")),
)
#: (arch, layers) of the TP identity at full width in f32, batch 2 x 1024
M_IDENTITY = (("qwen3-0.6b", 2), ("deepseek-v2-lite-16b", 2), ("rwkv6-3b", 2))
M_LOSS_RTOL, M_GRAD2_RTOL = 2e-4, 5e-3


def predict_tp(bundle) -> dict[str, float]:
    """The model axis's booked wire of one train call by tag, from the
    shapes: each layer's two row-parallel psums (attention, then the MLP or
    the MoE) of one shard's (b, S, d) partial in the compute dtype, the
    embedding's psum of (b, S, d) in the parameter dtype, the loss's pmax
    and two psums of (b, S) f32 (untagged, as the reference's), and the
    ``tp_grad_fixup`` psum of each replicated leaf's gradient; a psum or
    pmax moves 2p(M-1)/M."""
    cfg, M = bundle.cfg, bundle.model
    b, S, d = bundle.shape.global_batch // bundle.n_workers, bundle.shape.seq_len, cfg.d_model
    act = torch.finfo(cfg.dtype).bits // 8
    par = torch.finfo(cfg.pdtype).bits // 8
    per = 2.0 * (M - 1) / M
    untagged = (2 * cfg.n_layers * b * S * d * act + b * S * d * par + 3 * b * S * 4) * per
    fix = sum(math.prod(x.shape) for x in flat(T.param_defs(cfg, M)).values()
              if x.shard is None) * par * per
    return {"untagged": untagged, "tp_grad_fixup": fix}


def device_busy(run, step_ms: float) -> tuple[float, int]:
    """``run()`` once under torch.profiler tracing the card's kernels only:
    (their summed device time over the unprofiled mean ``step_ms``, the
    kernel launches)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return busy / step_ms, sum(e.count for e in kernels)


def run_model_path(label: str, arch: str, layers: int, workers: int, model: int,
                   comm_kw: dict, kernels: tuple, card: str) -> dict[str, int]:
    """One phase M path: 3 trainer steps at W workers x M model shards; its
    step ms (the first excluded), operations, peak, busy share; launches,
    grad_agg and the model axis's booked records held to their formulas.
    Returns the launches of its steps."""
    cfg = get_config(arch).with_updates(n_layers=layers)
    shape = InputShape("train_1024", 1024, F_BATCH, "train")
    comm = CommConfig(**comm_kw)
    t0 = time.perf_counter()
    bundle = build_bundle(cfg, comm, momentum_sgd(0.9), shape, n_workers=workers, seed=0,
                          device=DEV, model=model)
    tr = Trainer(bundle, SyntheticBatches(cfg, shape, seed=0), constant(F_LR), log_every=1)
    state = tr.init(seed=0)
    torch.cuda.synchronize()
    buckets = bundle.bucket_plan.buckets
    print(f"model axis {label}: {arch} {layers} of {get_config(arch).n_layers} layers at full "
          f"width, W {workers} x M {model}, seq 1024, global batch {F_BATCH}, {comm_kw}: "
          f"{len(buckets)} shard-local buckets of {sum(b.size for b in buckets)} elements a "
          f"shard; build+init {time.perf_counter() - t0:.2f} s ({card})")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    step_ms, counter = [], OpCounter()
    for t in range(F_STEPS):
        t1 = time.perf_counter()
        with counter if t == 0 else contextlib.nullcontext():
            state = tr.fit(state, 1, start_step=t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        h = tr.history[-1]
        print(f"  step {t}: loss {h['loss']:.6f} ce {h['ce']:.6f} aux {h['aux']:.6f} "
              f"step_ms {step_ms[-1]:.1f}")
        if not all(math.isfinite(h[k]) for k in ("loss", "ce", "aux")):
            raise AssertionError(f"model axis {label}: non-finite metrics at step {t}: {h}")
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    mean_ms = float(np.mean(step_ms[1:]))
    want = {k: v * model for k, v in route_launches(comm, bundle.bucket_plan, workers,
                                                     F_STEPS).items()}
    got = {k: v for k, v in launches.items() if v}
    booked, predicted = bundle.wire["train"].get("grad_agg", 0.0), predict_grad_agg(bundle)
    tp_want = predict_tp(bundle)
    tp_got: dict[str, float] = {}
    for r in bundle.logs["train"].records:
        if r.axes == ("model",):
            key = r.tag or "untagged"
            tp_got[key] = tp_got.get(key, 0.0) + r.wire_bytes * r.mult
    busy, n_kernels = device_busy(lambda: tr.fit(state, 1, start_step=F_STEPS), mean_ms)
    print(f"  mean step_ms (first step excluded) {mean_ms:.1f}; {counter.n} aten operations "
          f"dispatched in step 0; device busy {100 * busy:.1f}% of the mean step "
          f"({n_kernels} kernel launches in a profiled step); peak memory {peak:.2f} GiB; "
          f"launches {got} ({F_STEPS} steps); booked wire KB/step by tag "
          f"{ {k: round(v / 1e3, 3) for k, v in bundle.wire['train'].items()} }, grad_agg "
          f"{booked:.0f} B against the shard-local plan's {predicted:.0f} B; model-axis records "
          f"{ {k: round(v) for k, v in tp_got.items()} } B against the shapes' "
          f"{ {k: round(v) for k, v in tp_want.items()} } B ({card})")
    if got != want or sorted(got) != sorted(kernels):
        raise AssertionError(f"model axis {label}: must launch exactly {want} ({kernels}): "
                             f"{got}")
    if booked != predicted:
        raise AssertionError(f"model axis {label}: booked {booked} B under grad_agg, the plan "
                             f"predicts {predicted} B")
    if tp_got != tp_want:
        raise AssertionError(f"model axis {label}: model-axis records {tp_got} B, the shapes "
                             f"give {tp_want} B")
    if peak > F_PEAK_GIB:
        raise AssertionError(f"model axis {label}: peak {peak:.2f} GiB > {F_PEAK_GIB}")
    STEP_MS[label] = mean_ms
    del state, tr, bundle
    torch.cuda.empty_cache()
    return launches


def check_tp_identity(arch: str, layers: int) -> None:
    """The same padded-for-2 parameters (f32, TF32 off) and batch at
    model-axis size 2 and 1: the objective and the squared gradient norm
    within the reference test's bounds; rwkv6-3b's recurrence through
    kernels wkv6 and wkv6_bwd."""
    cfg = get_config(arch).with_updates(n_layers=layers, param_dtype="float32",
                                        compute_dtype="float32", remat="none")
    params = T.init_params(cfg, 0, DEV, 2)
    shape = InputShape("train_1024", 1024, 2, "train")
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in
             SyntheticBatches(cfg, shape, seed=0).batch(0).items()}
    got = []
    for m in (2, 1):
        ps = [p.detach().clone().requires_grad_(True) for p in flat(params).values()]
        ops.reset_launches()
        loss, met = T.forward_loss(cfg, unflatten_like(params, ps), batch, msize=m)
        g2 = sum(float(torch.sum(torch.square(g.double())))
                 for g in torch.autograd.grad(loss, ps))
        got.append((float((met["ce"] + cfg.router_aux_coef * met["aux"]).detach()), g2,
                    {k: v for k, v in ops.LAUNCHES.items() if v}))
        del ps
    (l2, g2, k2), (l1, g1, _) = got
    dl, dg = abs(l2 - l1) / max(1.0, abs(l1)), abs(g2 - g1) / max(1.0, abs(g1))
    print(f"TP identity {arch} {layers} layers at full width, f32, batch 2 x 1024: objective "
          f"{l2:.7f} at model 2 against {l1:.7f} at 1 (relative {dl:.2e}, bound {M_LOSS_RTOL}); "
          f"squared gradient norm {g2:.6e} against {g1:.6e} (relative {dg:.2e}, bound "
          f"{M_GRAD2_RTOL}); launches at model 2 {k2}")
    if not (dl < M_LOSS_RTOL and dg < M_GRAD2_RTOL):
        raise AssertionError(f"TP identity {arch}: {dl} / {dg}")
    if cfg.family == "ssm" and not (k2.get("wkv6") and k2.get("wkv6_bwd")):
        raise AssertionError(f"TP identity {arch}: the recurrence did not launch wkv6 / "
                             f"wkv6_bwd: {k2}")
    del params
    torch.cuda.empty_cache()


def run_phase_m(card: str) -> dict[str, int]:
    """Paths (bg) and (bh), then the TP identity; returns the paths'
    launches (the identity's comparison launches are not counted)."""
    t_phase = time.perf_counter()
    launches = {k: 0 for k in KERNELS}
    for path in M_PATHS:
        for k, v in run_model_path(*path, card=card).items():
            launches[k] += v
    for arch, layers in M_IDENTITY:
        check_tp_identity(arch, layers)
    print(f"phase M: {time.perf_counter() - t_phase:.1f} s")
    return launches


def run_phase_f(card: str, profile: set | None = None) -> tuple[dict[str, int], dict[str, dict]]:
    """Paths (an)-(bd) (each labelled in ``profile`` with one more step under
    torch.profiler), then the full-width checks of moe_ffn, the windowed
    attention and the kernels past 2**31.  Returns the paths' launches and
    the big kernels' measurements."""
    t_phase = time.perf_counter()
    launches = {k: 0 for k in KERNELS}
    for path in F_PATHS:
        for k, v in run_family_path(*path, card=card,
                                    profile_step=path[0] in (profile or ())).items():
            launches[k] += v
    check_moe_ffn()
    check_windowed_attention()
    big = check_past_2e31()
    print(f"phase F: {time.perf_counter() - t_phase:.1f} s")
    return launches, big


# ---------------------------------------------------------------------------
# Phase S: the attention families served through build_serve.
# ---------------------------------------------------------------------------

#: (tag, arch, layers kept, prompt): full published width, bf16, random
#: weights from seed 0, SyntheticBatches prompts, batch 8, 32 greedy tokens
#: through launch.serve.run.  qwen1.5-32b and qwen3-moe-30b-a3b are cut in
#: depth to fit the card (65.5 and 61.1 GB of bf16 weights at full depth);
#: gemma3-12b's prompt of 2048 is twice its window, so the prefill's window
#: and the local rings (1024 slots against 2048 for the global layers) bite
S_PATHS = (
    ("at", "qwen3-0.6b", 28, 1024),
    ("au", "glm4-9b", 40, 1024),
    ("av", "qwen1.5-32b", 16, 1024),
    ("aw", "gemma3-12b", 48, 2048),
    ("ax", "qwen3-moe-30b-a3b", 12, 1024),
    ("ay", "deepseek-v2-lite-16b", 27, 1024),
    # hymba-1.5b at full depth: prompt 2048 is twice its window, so the
    # 1024-slot local rings bite beside the Mamba heads' carried state
    ("bb", "hymba-1.5b", 32, 2048),
    # the prompt counts qwen2-vl's 256 patches; seamless's 256 frames come
    # beside its 1024 prompt tokens
    ("be", "qwen2-vl-2b", 28, 1024),
    ("bf", "seamless-m4t-large-v2", 24, 1024),
)
S_BATCH, S_DECODE = 8, 32
#: the f32 identity at full width, one pattern period each (deepseek its
#: dense layer 0 and 2 MoE layers), batch 2, the MoE at cf = E, in the
#: per-layer list layout: (arch, layers, prompt S).  A stacked leaf
#: (scan_layers) is drawn at std 1/sqrt(its repeats), the reference's rule
#: (fan-in = shape[0]), so its scores run to thousands and the f32 sum
#: orders of the decode's and the forward's products differ by up to 2.5e-4
#: of max|logits| through the softmax; each unstacked leaf takes its own
#: fan-in.  gemma3's S = 1024 fills its local rings of 1024
#: slots: the decode at position 1024 evicts position 0, which the full
#: forward's window (a 1024-query chunk and a 1-query one) leaves out too
S_IDENTITY = (
    ("qwen3-0.6b", 2, 256),
    ("glm4-9b", 2, 256),
    ("qwen1.5-32b", 2, 256),
    ("gemma3-12b", 6, 1024),
    ("qwen3-moe-30b-a3b", 2, 256),
    ("deepseek-v2-lite-16b", 3, 256),
    ("hymba-1.5b", 16, 1024),
    ("qwen2-vl-2b", 2, 256),
    ("seamless-m4t-large-v2", 2, 256),  # and 2 of its 24 encoder layers
)
#: max |decode logits - full-forward logits| over max |logits|
S_IDENTITY_TOL = 1e-4


def run_serve_path(tag: str, arch: str, layers: int, prompt: int, card: str,
                   profile_step: bool = False) -> None:
    """One timed phase S path through ``launch.serve.run``: prefill ms, decode
    ms per token, tok/s, peak and cache GiB; no port kernel may launch; the
    tokens in [0, vocab) and the last hidden state finite."""
    from repro_torch.models import layers as L

    cfg = get_config(arch).with_updates(n_layers=layers)
    n_params = sum(int(np.prod(d.shape)) for d in flat(T.param_defs(cfg)).values())
    gc.collect()  # earlier phases' cycles, so the peak is this path's
    torch.cuda.empty_cache()
    print(f"serve ({tag}) {arch}, {layers} of {get_config(arch).n_layers} layers at full width "
          f"({n_params} params, {cfg.param_dtype}): batch {S_BATCH}, prompt {prompt}, "
          f"{S_DECODE} decode tokens"
          + (f"; MoE decode capacity C = {L.moe_capacity(cfg, S_BATCH)} per expert "
             f"(T = {S_BATCH}, k = {cfg.experts_per_token}, E = {cfg.n_experts})"
             if cfg.moe else ""))
    ops.reset_launches()
    res = serve.run(cfg, prompt_len=prompt, batch=S_BATCH, decode=S_DECODE, device=DEV, seed=0)
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    tokens, last = res["tokens"], res["last"]
    per_tok = res["decode_ms"] / S_DECODE
    peak = res["peak_bytes"] / 2**30
    print(f"  ({tag}) prefill {res['prefill_ms']:.1f} ms; decode {per_tok:.2f} ms per token "
          f"({res['tok_per_s']:.1f} tok/s over {S_BATCH} sequences); peak memory {peak:.2f} GiB "
          f"(weights included), cache {res['cache_bytes'] / 2**30:.3f} GiB; port kernel "
          f"launches {launches or 'none'} ({card})")
    if launches:
        raise AssertionError(f"serve ({tag}): must launch no port kernel: {launches}")
    # a token is a row of the embedding, which the reference pads to a
    # multiple of 128 (hymba's 32,001 to 32,128) and does not mask: random
    # weights may pick a pad row
    V = make_plan(cfg).V
    if tokens.shape != (S_BATCH, S_DECODE) or tokens.min() < 0 or tokens.max() >= V \
            or not bool(torch.isfinite(last).all()):
        raise AssertionError(f"serve ({tag}): bad output, tokens {tokens.shape} in "
                             f"[{tokens.min()}, {tokens.max()}], last finite "
                             f"{bool(torch.isfinite(last).all())}")
    if peak > F_PEAK_GIB:
        raise AssertionError(f"serve ({tag}): peak {peak:.2f} GiB > {F_PEAK_GIB}")
    if profile_step:
        step, params, cache = res["bundle"].serve_step, res["params"], res["cache"]
        tok = torch.from_numpy(tokens[:, -1:]).to(DEV)
        profile_one_step(lambda: step(params, cache, tok), f"({tag}) decode step", per_tok)
    del res, last
    torch.cuda.empty_cache()


def check_serve_identity(arch: str, layers: int, prompt: int) -> None:
    """The decode-equivalence identity at full width in f32 (TF32 off):
    ``prefill(max_seq=S+1)`` plus one ``decode_logits`` against the full
    forward's last-position logits over the S + 1 tokens, within
    S_IDENTITY_TOL of max|logits|, the greedy tokens equal wherever the
    top-2 margin exceeds the error; then one ``serve_step`` (in place)
    against ``decode_step`` from the same cache, under deterministic
    algorithms: tokens and every cache leaf bitwise.  The prompt's patches
    or frames come with it (an encoder-decoder cut to ``layers`` encoder
    layers too); under M-RoPE with patches the full forward gives the
    decoded index the decode's positions, S in all three streams."""
    from repro_torch.models import layers as L

    cfg = get_config(arch).with_updates(n_layers=layers, param_dtype="float32",
                                        compute_dtype="float32", scan_layers=False)
    if cfg.moe:  # cf = E: no (token, choice) dropped, in decode (T = 2) or forward
        cfg = cfg.with_updates(moe_capacity_factor=float(cfg.n_experts))
    if cfg.is_encoder_decoder:
        cfg = cfg.with_updates(encoder_layers=min(cfg.encoder_layers, layers))
    B, S = 2, prompt
    params = T.init_params(cfg, 0, DEV)
    full = {k: torch.from_numpy(v).to(DEV) for k, v in
            SyntheticBatches(cfg, InputShape("p", S + 1, B, "prefill"), seed=1).batch(0).items()}
    toks = full["tokens"]
    n = toks.shape[1] - 1  # the prompt's text tokens
    vision = cfg.rope_type == "mrope" and cfg.modality == "vision"
    if vision and int(S * cfg.vision_fraction) != int((S + 1) * cfg.vision_fraction):
        raise AssertionError(f"serve identity {arch}: prompts {S} and {S + 1} differ in n_vis")
    with torch.inference_mode(), deterministic():
        _, cache = T.prefill(cfg, params, {**full, "tokens": toks[:, :n]}, max_seq=S + 1)
        got, _ = T.decode_logits(cfg, params, cache, toks[:, n:], max_seq=S + 1)
        if vision:  # the decode's streams at the decoded index
            pos = T.make_positions(cfg, B, S + 1, DEV).clone()
            pos[:, :, S] = S
            h, _ = T._trunk(cfg, params, T._embed_inputs(cfg, params, full), pos, None)
        else:
            h, _ = T.forward_hidden(cfg, params, full)
        want = L.logits_local(params["embed"], h[:, -1:], softcap=cfg.logits_softcap)
        del h
        top = float(want.abs().max())
        err = float((got - want).abs().max())
        top2 = torch.topk(want[:, 0], 2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        same = torch.argmax(got[:, 0], -1) == torch.argmax(want[:, 0], -1)
        decided = margin > err
        tok_ok = bool(same[decided].all())
        # serve_step writes the ring in place: give it a copy
        sb = build_serve(cfg, InputShape("identity", S + 1, B, "decode"), DEV)
        want_tok, want_cache = T.decode_step(cfg, params, cache, toks[:, n:], max_seq=S + 1)
        tok, new_cache = sb.serve_step(params, tree_map(torch.clone, cache), toks[:, n:])
        bitwise = torch.equal(tok, want_tok) and all(
            torch.equal(a, b) for a, b in zip(flat(new_cache).values(),
                                              flat(want_cache).values()))
    print(f"serve identity {arch} f32 at full width, {layers} layers, batch {B}, prompt {S}: "
          f"decode logits vs the full forward over {S + 1} tokens, max abs err {err:.3e} on "
          f"max|logits| {top:.3e} ({err / top:.3e}, bound {S_IDENTITY_TOL}); greedy tokens "
          f"equal {same.tolist()} (top-2 margins {[f'{m:.3e}' for m in margin.tolist()]}); "
          f"serve_step vs decode_step bitwise {bitwise}")
    if not (err <= S_IDENTITY_TOL * top and tok_ok and bitwise):
        raise AssertionError(f"serve identity {arch}: err {err / top:.3e} of max|logits|, "
                             f"tokens equal {same.tolist()} where decided {decided.tolist()}, "
                             f"serve_step bitwise {bitwise}")
    del params, cache, want_cache, new_cache, got, want
    torch.cuda.empty_cache()


def run_phase_s(card: str, profile: set | None = None) -> None:
    """Paths (at)-(bf) (each tagged in ``profile`` with one more decode step
    under torch.profiler), then the f32 identity of each family."""
    t_phase = time.perf_counter()
    for tag, arch, layers, prompt in S_PATHS:
        run_serve_path(tag, arch, layers, prompt, card, profile_step=tag in (profile or ()))
    for arch, layers, prompt in S_IDENTITY:
        check_serve_identity(arch, layers, prompt)
    print(f"phase S: {time.perf_counter() - t_phase:.1f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", nargs="*", metavar="LABEL",
                    help="run one more step of the QSGD EF path (or of the paths with "
                         "these labels, phase F's included; 'serve' for a decode step of "
                         "the server; phase S's tags at-bf for a decode step of each) under "
                         "torch.profiler after the timed steps (its launches are counted "
                         "apart)")
    profile = ap.parse_args().profile
    if profile is not None:
        profile = set(profile or [PATHS[0][0]])
        unknown = profile - {p[0] for p in PATHS + CHURN_PATHS + F_PATHS + S_PATHS} - {"serve"}
        if unknown:
            ap.error(f"--profile: no path labelled {sorted(unknown)}")
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = smi()
    print(f"card: {kind}; nvidia-smi: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    records = LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(records)} kernels (parallel nvcc)")
    for name, rec in records.items():
        for line in rec.ptxas.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    checks = (check_kernels, check_sign_kernels, check_tern_kernels, check_threshold_kernel)
    small = {k: v for check in checks for k, v in check(100_003, timed=False).items()}
    require(small, 100_003)
    print("kernels at n=100003: codes, packed bytes, values, masked values, kept counts and "
          "0/1-weight sums bitwise; e', int8_acc and general-weight sums within tolerance")
    big = {k: v for check in checks for k, v in check(LARGEST, timed=True).items()}
    require(big, LARGEST)
    wkv = check_wkv6()
    wkv.update(check_wkv6_backward())
    require(wkv, 0)
    print(f"kernel wkv6_bwd: {wkv['wkv6_bwd']['detail']}")
    wb = wkv["wkv6_bwd"]
    print(f"kernel wkv6_bwd at the training shape {WKV6_TRAIN} bf16, in turns (whole, states, "
          f"chunks, chunks, states, whole): {', '.join(f'{t:.4f}' for t in wb['turns'])} ms; "
          f"whole backward {wb['ms']:.4f} ms (bound "
          f"{wkv6_bwd_bound(*WKV6_TRAIN, in_bytes=2)[0]:.4f} ms), wkv6_bwd_states "
          f"{wb['states_ms']:.4f} ms (bound "
          f"{wkv6_bwd_states_bound(*WKV6_TRAIN, in_bytes=2)[0]:.4f} ms), wkv6_bwd alone "
          f"{wb['chunks_ms']:.4f} ms")
    for bf16 in (True, False):
        for launch, res in ops.wkv6_bwd_info(WKV6_TRAIN[3], bf16).items():
            print(f"kernel {launch}, hd {WKV6_TRAIN[3]} {'bf16' if bf16 else 'f32'} r, k, v: "
                  f"{res['registers']} registers per thread, {res['dynamic_smem']} + "
                  f"{res['static_smem']} bytes of shared memory per CTA (dynamic + static), "
                  f"{res['ctas_per_sm']} CTAs resident per SM")
    print(f"kernel wkv6: {wkv['wkv6']['detail']}")
    w6 = wkv["wkv6"]
    print(f"kernel wkv6 at the decode shape ({SERVE_B}, 1, 32, 80) bf16: {w6['decode_ms']:.4f} ms "
          f"per call on the host clock, {w6['decode_device_ms']:.4f} ms of the kernel's own "
          f"device time per launch (torch.profiler); plain {w6['decode_plain_ms']:.4f} ms")
    print(f"kernel wkv6 (chunked design) at the training shape {WKV6_TRAIN} bf16: "
          f"{w6['train_shape_ms']:.4f} ms (bound {w6['train_shape_bound_ms']:.4f} ms)")
    print(f"kernel wkv6 at the prefill shape {WKV6_PREFILL} bf16, in turns (recurrent, chunked, "
          f"chunked, recurrent): {', '.join(f'{t:.4f}' for t in w6['turns'])} ms; recurrent "
          f"{w6['recurrent_ms']:.4f} ms against its CUDA-core bound "
          f"{wkv6_bound(*WKV6_PREFILL, in_bytes=2, ops_per_s=F32_OPS_PER_S)[0]:.4f} ms")
    for bf16 in (True, False):
        res = ops.wkv6_chunked_info(WKV6_PREFILL[3], bf16)
        print(f"kernel wkv6 chunked design, hd {WKV6_PREFILL[3]} {'bf16' if bf16 else 'f32'} "
              f"r, k, v: {res['registers']} registers per thread, {res['dynamic_smem']} + "
              f"{res['static_smem']} bytes of shared memory per CTA (dynamic + static), "
              f"{res['ctas_per_sm']} CTAs resident per SM")
    rows = []
    for name, r in {**big, **wkv}.items():
        if name == "wkv6":
            b_ms, b_by = wkv6_bound(*WKV6_PREFILL, in_bytes=2)
            at = f"(B, S, H, hd)={WKV6_PREFILL} bf16"
        elif name == "wkv6_bwd":
            b_ms, b_by = wkv6_bwd_bound(*WKV6_TRAIN, in_bytes=2)
            at = f"(B, S, H, hd)={WKV6_TRAIN} bf16, both launches"
        elif name == "wkv6_bwd_states":
            b_ms, b_by = wkv6_bwd_states_bound(*WKV6_TRAIN, in_bytes=2)
            at = f"(B, S, H, hd)={WKV6_TRAIN} bf16"
        else:
            b_ms, b_by = bound(name, LARGEST, W)
            at = f"n={LARGEST}"
        print(f"kernel {name} {at}: {r['ms']:.4f} ms (bound {b_ms:.4f} ms by {b_by}), "
              f"plain {r['plain_ms']:.4f} ms, max_abs_err {r['max_abs_err']}")
        rows.append({"name": name, "route": "cuda", "source": KERNELS[name]["source"],
                     "replaces": KERNELS[name]["replaces"], "launches": 0,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "library_note": NO_LIBRARY[name], "ok": r["ok"]})
        if name == "wkv6":  # the forward also at the training shape, where (az) runs it
            rows[-1].update(train_shape_ms=r["train_shape_ms"],
                            train_shape_bound_ms=r["train_shape_bound_ms"])
        if name == "wkv6_bwd":  # the whole backward is the row's ms; its second launch alone
            rows[-1].update(wkv6_bwd_alone_ms=r["chunks_ms"])

    launches = {k: 0 for k in KERNELS}
    for label, comm_kw, steps, lr, path_kernels, *build in PATHS:
        got = run_trainer(label, comm_kw, steps, lr, *build,
                          profile_step=profile is not None and label in profile)
        n_kernel = kernel_steps(CommConfig(**comm_kw), steps)
        want = {k: path_kernels.get(k, 0) * n_kernel for k in got}
        if got != want:
            raise AssertionError(f"path {label}: must launch exactly {want}: {got}")
        for k, v in got.items():
            launches[k] += v
    print(f"step ms, pipelined staleness 1 (ad) against sequential (ab), qsgd EF, 2 "
          f"microbatches: {STEP_MS['pipelined s1 qsgd ef']:.1f} / "
          f"{STEP_MS['microbatch qsgd ef']:.1f}")
    for label, comm_kw, steps, lr, path_kernels, *build in CHURN_PATHS:
        got = run_trainer(label, comm_kw, steps, lr, *build,
                          profile_step=profile is not None and label in profile)
        want = {k: path_kernels.get(k, 0) * kernel_steps(CommConfig(**comm_kw), steps)
                for k in got}
        if got != want:
            raise AssertionError(f"path {label}: must launch exactly its twin's {want}: {got}")
        for k, v in got.items():
            launches[k] += v
    check_churn_twin()
    check_checkpoint()
    check_pipelined_staleness0()
    row_checks = {}
    for b, n in ((ENGINE_ROWS, ENGINE_DIM), (2160, ENGINE_DIM), (1, 100_003), (100_003, 1)):
        res = check_row_kernels(b, n, timed=(b, n) == (ENGINE_ROWS, ENGINE_DIM))
        require(res, b * n)
        row_checks = row_checks or res
    print("row kernels at (rows, n) = (432, 64), (2160, 64), (1, 100003), (100003, 1) with per-row "
          "levels: codes bitwise, e' within rtol 1e-6")
    engine_launches = run_engine(card)
    engine_launches["qsgd_ef"] += run_churn_engine(card)
    check_rwkv_path()
    check_rwkv_train_path()
    launches["wkv6"] = run_server(profile_step=profile is not None and "serve" in profile)
    run_phase_t(card)
    run_phase_b(card)
    f_launches, f_big = run_phase_f(card, profile)
    m_launches = run_phase_m(card)
    run_phase_s(card, profile)
    for k, v in (*f_launches.items(), *m_launches.items()):
        launches[k] += v
    for name, r in row_checks.items():
        b_ms, b_by = _bound(ROW_KERNELS[name]["bytes"](ENGINE_ROWS, ENGINE_DIM),
                            ROW_KERNELS[name]["ops"](ENGINE_ROWS, ENGINE_DIM))
        kernel = ROW_KERNELS[name]["kernel"]
        print(f"kernel {name} (rows, n)=({ENGINE_ROWS}, {ENGINE_DIM}): {r['ms']:.4f} ms per call "
              f"(CUDA events), {r['device_ms']:.4f} ms of the kernel's own device time "
              f"(torch.profiler; bound {b_ms:.6f} ms by {b_by}), plain {r['plain_ms']:.4f} ms, "
              f"max_abs_err {r['max_abs_err']}; engine launches {engine_launches[kernel]}")
        rows.append({"name": name, "route": "cuda", "source": KERNELS[kernel]["source"],
                     "replaces": KERNELS[kernel]["replaces"],
                     "launches": engine_launches[kernel], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "library_note": NO_LIBRARY[kernel], "ok": r["ok"]})
    print(f"engine phase launches of the flat sign kernels (E3): sign_pack "
          f"{engine_launches['sign_pack']}, sign_unpack {engine_launches['sign_unpack']}")
    for name, r in f_big.items():
        rows.append({"name": f"{name}_past_2e31", "route": "cuda",
                     "source": KERNELS[name]["source"], "replaces": KERNELS[name]["replaces"],
                     "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "library_note": NO_LIBRARY[name], "ok": True})
    for row in rows:
        if row["name"] in KERNELS:
            row["launches"] = launches[row["name"]]
        row["ok"] = row["ok"] and row["launches"] > 0
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
