"""Drive the PyTorch/CUDA port of the Kronecker DPP sampler on one GPU.

    python3 chip_smoke.py

Phases, in order, none of them guarded by a try: any failure exits
non-zero and prints no result line.

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: nvcc compiles the five sources of
   ``src/repro_torch/kernels/csrc/`` (phase2_select, partial_trace,
   greedy_map, kron_matvec, threefry), one process each, started together,
   into ``build/kernels/``; the ``-Xptxas -v`` lines give registers and
   shared memory;
3. the phase-2 kernel against its plain PyTorch version on the card, at
   the main path's shapes (N = 100 x 100, E|Y| = 20, B = 1 and 64) and at
   the edges (m = 1, m = 3, degenerate columns), on the same uniforms, all
   on the "on_chip" route; at 300 x 300, B = 8 and at 32 x 32, E|Y| = 250
   (k_max past 238), B = 16 on the "cluster" route (a thread-block cluster
   a sample); past a 16-CTA cluster, 16 x 4096 (E|Y| = 20), B = 8 on the
   "global" route and 64 x 256, E|Y| = 250, B = 4 on the "global_basis"
   route (``phase2_select_route`` asserted for each case); the on-chip
   layout's bytes from the C side equal ``onchip_geometry``'s, and the C
   side's cluster plan equals ``cluster_geometry``'s;
4. statistics on the kernel path: singleton marginals of a (2, 3) kernel
   from 3000 draws against diag K;
5. the main path: ``dpp.random_kron(gen, (100, 100)).rescale(20.0)``,
   ``model.service(seed=0)``, tickets of 1, 4, 16, 64 and 200 samples,
   one flush; the launch counts of phase 2 and ``threefry2x32`` and the
   ``kernels.*.cuda`` counters are reset just before and read just after.
   The flush's own launch (285 rows served of one call at B = 512) is then
   held against the plain version: the flush's uniforms are replayed from
   the service key saved before it through the plain PRNG twin on the card
   (bit for bit the kernel's uniforms from the same key);
6. times of the phase-2 kernel and its plain version (``kernel_times``:
   device time from ``torch.profiler`` and CUDA events around a loop;
   each call one ``phase2_select_kernel_onchip`` and nothing else), the
   bound on the whole card and the longest row's on one SM, the time per
   step of the longest row; the cluster route's time at 300 x 300, with
   the global route's on the same inputs beside it (``global_route_ms``,
   launched through the C launcher's route argument) and the longest
   row's bound on the cluster's C SMs (``bound_cluster_ms``); the
   DPP's phase 1 alone (uniforms, phase 1 and the column gather) at B = 16
   and 64, from a generator and from a key (``keyed_*``); one
   ``svc.sample(16)`` request on the host clock;
7. the partial-trace kernels (``csrc/partial_trace.cu``) against their
   plain versions on random non-symmetric Θ, L1, L2 at N1 x N2 = 100 x 100
   (the main shape), 64 x 150 and 7 x 13;
8. data for the fit: n = 1000 subsets drawn through the (keyed) service
   of the phase-5 model (E|Y| = 20, N = 100 x 100); the init is a second
   ``random_kron(gen2, (100, 100))`` (paper §5.1);
9. at the init, on the full batch, the A and C of the dense route through
   the kernels, of the dense route through the plain versions
   (``backend="reference"``) and of the per-subset route
   (``accumulate_AC``) agree; the Θ-scatter kernel
   (``csrc/theta_scatter.cu``) at the benchmark's shape (the n = 1000
   subsets padded to k_max 46) against its plain version on the card
   (entries that differ, max |Δ| within ``TS_TOL``) and, bit for bit, in
   one CPU thread, also with repeated items; an all-padded batch gives
   zeros; the dense Θ built twice from the same batch and factors,
   bitwise (entries that differ: 0), one launch and one
   ``kernels.theta_scatter.cuda`` count a build;
10. the learning main path: ``model.fit(batch, algorithm="krk",
   use_dense_theta=True, schedule=armijo(a0=1.5), iters=5, log_every=5)``
   under an ``InMemoryTracker`` (so the health check reads CUDA factors).
   The partial-trace launch counts and the ``kernels.partial_trace_*.cuda``
   counters are reset just before and read just after: 5 sweeps make 5 A
   and 10 C launches (A once per sweep; C once per Θ build, twice with the
   block-CCCP refresh), and as many ``theta_scatter`` launches as C's,
   none of its plain version. The tracked LL never falls by more than
   ``_ASCENT_TOL``, ends above the init's, both factors stay PD, and
   ``FitReport.health`` is present. The same 5 sweeps with the plain
   partial traces give the same accepted step and backtrack count and
   factors within tolerance;
11. times of each partial trace (``kernel_times`` of the kernel, the plain
   version and the ``torch.einsum`` library call; the bound); of the
   Θ scatter at the benchmark's shape and with no padding (1000 subsets of
   20 items), beside the plain version, the ``index_put_`` call it
   replaced and the bound (Θ written once); with CUDA
   events around a loop, the Θ build and its
   steps, a factor eigh and one log-likelihood, and one sweep on the host
   clock (both fits run after a 1-sweep warm-up fit);
12. the greedy-MAP step kernel (``csrc/greedy_map.cu``) against its plain
   version at N in {1, 33, 4097, 10^4} x k in {1, 20, 200}, with C
   row-major and as the transposed (k, N) buffer the plain loop keeps; the
   fused selection (``greedy_map_kdpp_kernel``, same file) against the
   plain loop on the card at N in {1, 33, 512, 4097, 10^4} x k in {1, 20,
   120, 200} (k <= N) x H in {1, 4, 7}, and on a rank-deficient L with k
   past its rank, an L of exact zero rows past its rank, an all-equal
   diagonal and a NaN on the diagonal (``kdpp_special``): one launch a
   call, every head's picks equal or a first difference at a float64 tie
   (the rule of phase 13), identical where exact ties decide, and every head
   of a batched launch its own single launch bit for bit; the
   Kronecker matvec kernel (``csrc/kron_matvec.cu``) in float32 and
   bfloat16 at (N1, N2, batch) = (3, 4, 2), (64, 96, 7), (1, 1, 1),
   (100, 100, 64), on inputs with all-zero rows of mat(X[b]) (a one-hot
   batch of 46 and of 3, half the rows zero, an all-zero X[b]), at N1 = 1
   and N2 = 1, at 130 x 70, 300 x 8, 150 x 150, 160 x 160 and 256 x 256:
   the route of each case (``kron_matvec_route``; 300 x 8 and 256 x 256
   must take the two-pass route, 160 x 160 in float32 too, the rest the
   one-launch route), one counted launch a call, and
   the caching allocator's allocations of a call (1 on the one-launch
   route: no scratch; 2 on the two-pass route); a NaN in A and an Inf in
   B with zero rows of mat(X[b]) (one-hot and half-zero batches) on both
   routes, whose NaN must be the plain version's exactly; the HMMA (tensor-core)
   instructions of its bfloat16 one-launch kernel (``cuobjdump -sass``);
13. the MAP path at full width: ``main.map(k, max_dense=10_000)`` on the
   phase-5 model (N = 10^4, the dense L is 400 MB) for k = 20 and 200,
   every kernel's launch count and the ``kernels.greedy_map_update.*``
   counters reset before and read after each call: one fused launch, no
   step launch, ``.cuda`` 1 and ``.reference`` 0 (``map_counted``); the
   same selection through the plain loop (``backend="reference"``); where
   the two lists first differ, the float64 conditional variances of the
   two candidates given the common prefix; log det L_Y of both pick sets;
   one ``map(20)`` on a 64 x 64 model under the default guard (one
   launch); the public step op ``ops.greedy_map_update`` on map(200)'s
   first step (one step launch, against the plain step);
14. the eigenvector path at full width: ``assemble_eigvecs`` of a phase-1
   selection (k_max 46) of the phase-5 spectrum through one
   ``kron_matvec`` launch (counted), VᵀV = I on the valid columns, equal to
   the gather route run by hand on the card;
15. the k-DPP path at full width: ``main.sample(gen, 64, k=20)`` and
   ``svc.sample_kdpp(20, 16)`` (from the service key), one phase-2
   launch each (counted); every
   row 20 distinct items; the model call's own launch held against
   ``phase2_select_plain`` on its replayed phase-1 output; inclusion
   frequencies of 3000 k = 2 draws of a (2, 3) kernel through the kernel
   against the exact k-DPP marginals by enumeration;
16. times: ``kernel_times`` of each new kernel, its plain version and its
   library yardstick, beside its bound (``kron_matvec``: at 100 x 100,
   batch 64, float32 and bfloat16, and the one-hot batch of 46, each call
   one ``kron_matvec_fused_kernel`` and nothing else on the profiler, the
   route beside them as ``kernel_route``); ``kernel_times`` of the fused
   selection and the plain loop on map(20)'s and map(200)'s L, beside the
   bound of the live steps (``greedy_live_steps``, ``kdpp_bound``), each
   call one ``greedy_map_kdpp_kernel``; with CUDA events around a loop,
   one ``map(20)`` and one ``map(200)``, ``assemble_eigvecs``, the k-DPP
   call and its phase 1 (ESP table, backward draw, compaction, gather);
   ``kernel_times`` of its phase 2; ``svc.sample_kdpp(20, 16)`` on the
   host clock;
17. the inference path at full width, on the phase-5 model and the
   phase-8 batch: ``main.log_prob(batch)`` and ``log_likelihood`` on the
   card against a CPU copy of the model; ``main.marginal`` of 8 singletons
   (also against diag K off the factored spectrum) and of sets of 2, 5, 20
   and 46 items of the batch's rows; ``main.condition(A, max_dense=10_000)``
   on 5 items of one row (a ``Dense`` model of N = 9995: symmetric,
   finite), the cross-path identity ``cond.log_prob(B') = main.log_prob(B
   ∪ A) - log main.marginal(A)`` for three small B, and ``condition`` of
   the 64 x 64 phase-13 model (N = 4096) against the CPU copy in full;
   ``cond.sample(gen, 64)``: m = 1 at N = 9995 takes phase 2's "cluster"
   route (asserted), one launch (counted, reset just before and read just
   after), each row distinct and in range, the picks held against
   ``phase2_select_plain`` on the replayed uniforms; a (2, 3) model
   conditioned on two items, 3000 draws, singleton frequencies against the
   brute-force conditional marginals; with CUDA events, ``log_prob`` of the
   batch, ``marginal`` of 20 items, ``condition``, the conditioned model's
   first ``spectrum`` (eigh of 9995²) and ``cond.sample(gen, 64)``;
   ``kernel_times`` of its phase 2;
18. keyed randomness at full width: the ``threefry2x32`` kernel
   (``csrc/threefry.cu``) against the plain PRNG twin on the card, bit for
   bit, in every mode (``split``, ``fold_in``, ``bits``, ``uniform`` with
   and without bounds) for 1 and 512 keys over shapes (0,), (), (1,),
   (7,), (10^4,) and one key's (64, 10^4) and (512, 10^4); both against
   ``GOLDEN``, jax.random's own values; ``main.sample(PRNGKey(1), 64)``
   and ``(..., k=20)`` through the kernels (launches counted), their
   uniforms bit for bit the plain twin's and their picks the plain phase
   2's; ``svc.draw_keyed`` of 512 keys from a ``TenantKeyring`` (three
   tenants, tickets of 1, 4, 16, 64 and 200 rows, pad rows) in one chunk
   and in chunks of 64, the same rows (one phase-2 launch a chunk,
   counted); three ``krk-stochastic`` sweeps of minibatch 100 on the
   phase-8 batch, each sweep's minibatch key and indices the plain twin's
   on the CPU (9 ``threefry2x32`` launches); ``kernel_times`` of the kernel,
   the plain twin and ``torch.rand`` (another generator, for scale) at
   16, 64 and 512 rows of 10^4 uniforms, beside the bound; the 285-row
   flush on the host clock;
19. the rest of learning at full width, on the phase-8 batch and init
   (N = 10^4, n = 1000), with TF32 asserted off. Joint and full Picard
   start from the init rescaled to E|Y| = 20 (``start``): from the raw
   init both break down in float32 (``tools/learning_precision.py``).
   ``start.fit(batch, algorithm="joint", iters=3)`` (a ``Kron``, finite PD
   factors, a finite LL track); ``fit_picard(start.dense_kernel(10_000),
   batch, iters=3)`` (the LL never falls by more than ``_ASCENT_TOL``; the
   kernel symmetric, finite, and within 1e-5 of max |L| of the same steps
   in float64 on the card); ``init.fit(batch, algorithm="em", iters=3,
   a=1e-3, max_dense=10_000)`` (a ``Dense`` whose λ lie in (0, inf)) and
   the first E-step's row sums of q against the subset sizes; the same
   three fits at 24 x 24 (N = 576, 60 subsets, from the raw init) on the
   card and on a CPU copy, both against a float64 run on the CPU;
   the phase-10 dense-Θ Armijo fit with ``checkpoint_dir`` (under the
   gitignored ``build/``) and ``save_every=2``, 3 sweeps then resumed to
   5, against phase 10's one-shot 5-sweep fit (entries that differ and the
   largest |Δ|), its partial-trace launches counted (reset just before,
   read just after: A 2, C 4); a blocking save and a restore of the
   KrK-Picard state and of the EM state (λ, V at N = 10^4) and EM's
   first eigh (of the 400 MB L) on the host clock; with CUDA events, one sweep of each learner from the raw init
   (KrK-Picard with dense Θ and per subset, full Picard, joint Picard, EM)
   and joint Picard's from ``start``;
20. the low-rank family (``dpp.LowRank``) at the width of
   ``benchmarks/lowrank_dual.py``: N = 65536, r = 32, V = 0.7·normal, q =
   |normal| + 0.3 from seeded keys, rescaled to E|Y| = 8, every call on the
   card: one r x r eigh for each (V, q) pair and none N-sized (every
   ``torch.linalg.eigh``/``eigvalsh`` size recorded, the cache's
   ``eigh_s`` tags); ``sample(key, 16)`` and ``sample(key, 64, k=8)``
   against a CPU copy on the card's spectrum carried across; 3000 draws'
   inclusion frequencies against diag K; ``service(seed=0)``'s
   ``sample(16)`` and ``sample_kdpp(8, 16)`` against the CPU copy's
   service, ``draw_keyed`` of 512 keys in one chunk and in chunks of 64;
   ``log_prob`` of the first 1000 draws, ``marginal`` of 20 items,
   ``condition`` on 5 (a ``LowRank``; the inclusion identity for 3 more),
   ``map(20)`` in float64, each against the CPU copy; a 3-sweep Armijo
   ``fit`` at N = 65536 on the 1000 draws, and at N = 4096 on 64 subsets
   (the benchmark's fit), with and without ``item_features``, against the
   CPU copy; every call with all seven kernels' launch counts reset before
   and read after (``threefry2x32`` alone launches); CUDA-event times
   beside one read of φ a step; at N = 2^20, r = 128 (φ 512 MB) the peak
   allocation of ``sample(key, 16)`` above what was allocated before it,
   below B·N·k_max·4 bytes;
21. the async serving tier (``repro_torch.serving``) at full width:
   (a) ``benchmarks/serving_load.py``'s traffic on the phase-5 model
   (tenants t0:2, t1..t3:1, 1-4 samples a request, open-loop Poisson
   arrivals seeded 1000 + the tenant's index, deadline 25 ms, max_batch
   64) at 100 req/s x 240, 400 x 600 and 800 x 800 requests through one
   ``AsyncSamplingService`` each, after a warm-up of every power-of-two
   batch; each load's row (samples/s, rows a device call, occupancy, p50
   and p99 latency, the device call's p99, the bound deadline + that p99,
   fires, rejections, truncation rate) is printed, not gated; (b) every
   served row bit for bit the row ``svc.service.draw_keyed`` gives its
   key alone (one row a call), and the plain phase 2 of the same
   phase-1 inputs on a CPU copy, identical or a tie under phase 3's rule;
   the first flush (pad rows too) against the plain phase 2 on the card;
   no failed flush and no rejection; phase-2 launches equal to the device
   calls, ``threefry2x32`` launches to the keyring's and the draws'; (c)
   the lowest load again at deadline 1 ms: every (tenant, seq) the same
   rows; (d) three ``LowRank`` tenants over phase 20's V (N = 65536, r =
   32), their q from seeded keys, rescaled to E|Y| = 8, through
   ``tenant_models=`` on one cache: 3 misses, every eigh r x r, only
   ``threefry2x32`` launched; every row against a serial ``draw_keyed``
   and against a CPU copy on the carried dual spectrum under phase 20's
   rule, the counts printed; (e) ``KVCompactionClient`` at Mixtral-8x7B's
   attention width (8 KV heads of dimension 128), two streams of S = 1024
   cached tokens (valid 1024 and 960) from numpy with the run's seed,
   budget 256, recency 64, one flush of 16 heads: (8, 256) int32 picks on
   the card, sorted, distinct, within the valid length, the recency
   window kept; the heads drawn apart (a client a stream) bit for bit;
   each head's phase-2 picks, replayed from the
   card's eigh and the plain twin's uniforms, against the plain phase 2 on
   a CPU copy (phase 3's rule) and among the served picks; the route
   ("cluster") and one phase-2 launch a head; whether a batched eigh of
   the 16 heads is bitwise each head's own (printed); one head by
   ``method="map"`` (one fused launch, no step launch, no plain dispatch;
   its greedy order against the plain loop on a CPU copy, phase 13's
   rule); the flush's time;
   (f) the lowest load again under a ``JsonlTracker`` (rows equal to
   (a)'s), exported with ``ChromeTraceExporter``: every ticket's trace is
   ``service.request`` over ``queue-wait``, ``coalesce``, ``device-call``
   and ``scatter``, all tagged with its tenant; ``obs.report.render`` of
   the log; (g) ``close(drain=False)`` fails queued tickets with
   ``CancelledRequest``, a submit past ``max_queue_depth`` raises
   ``QueueFull`` and one after close ``ServiceClosed``. Every path is
   driven with all seven kernels' launch counts set to 0 just before and
   read just after; the ``serving`` JSON line holds it all;
22. placement: a ``Mesh`` of four shards on the card against ``Local``
   (draws, both services, the learner, ``Host``, a low-rank draw, a
   checkpoint restored with ``shardings=``);
23. LM serving: qwen2-0.5b (``src/repro/configs/qwen2_0_5b.py``) at full
   width through the port's ``models`` and ``ServeEngine``, weights from
   ``init_params(PRNGKey(0))`` (``threefry2x32`` launches only), two
   seeded prompts of 512 tokens: (1) float32 at 2 of the 24 layers, the
   card against a CPU copy (prefill logits and caches, 4 decode steps);
   (2) the config's bfloat16 against float32 on the card at full depth
   (logits; the first greedy tokens agree wherever float32's top-2 margin
   exceeds twice the row's error; ``torch.argmax`` takes the first of
   equal bfloat16 maxima); (3) decode against forward over the prompts'
   first 64 tokens, float32, full depth; (4) ``generate(max_new=32)``
   greedy four times, each with every kernel's launch count set to 0
   just before and read just after: no compaction (no kernel launched),
   inline ``kv_budget=128, kv_recency=8`` by ``"sample"`` (one
   ``phase2_select`` launch a KV head, 96, and 1 + 2 a unit + 1 a head
   ``threefry2x32`` launches) and by ``"map"`` (one fused launch a unit of
   B·KV = 4 heads, 24, no step launch, ``kernels.greedy_map_update.cuda``
   24 and ``.reference`` 0), and two tenant streams in threads through one
   ``KVCompactionClient`` (192 phase-2 launches); every compaction's
   kept positions, found by matching the compacted rows to the prefill
   cache's, sorted, distinct, below pos, the recency window kept, k and v
   gathered together; (5) four ``"sample"`` heads (and two of each client
   stream) replayed from the card's eigh and the plain twin's uniforms,
   the kernel's draw among the served positions and against the plain
   phase 2 on a CPU copy (phase 3's rule); four ``"map"`` heads' greedy
   orders against the plain loop on a CPU copy (phase 13's rule); unit
   0's four head kernels stacked and selected in one launch, each head its
   own single launch bit for bit and the kept positions its picks and the
   recency window; a head's time by part (CUDA events), phase 2's at its
   shape, and the fused selection of the unit against the plain loop; (6)
   an ``lm_serve`` JSON line, and ``launches_per_path.lm_serve`` in the
   ``kernels`` rows of phase 2, both greedy kernels and ``threefry2x32``;
24. LM training with KronDPP batch selection (qwen2-0.5b at full width,
   the port's ``data``, ``optim``, ``train`` and ``launch`` modules): (1)
   one ``make_train_step`` at 2 of the 24 layers in float32, 4 seeded
   sequences of 128 tokens, the card against a CPU copy from the same
   seeded params (loss, grad norm, every parameter leaf), with 1 and 2
   microbatches; (2) full depth in the config's bfloat16, the objects of
   ``launch.train --dpp-batch-selection``: a synthetic corpus of 1024
   documents, the KronDPP selector over 32 x 32 RBF factors of their
   features, AdamW at lr 3e-4 under the cosine schedule, 8 steps of B = 8
   x 128 tokens logged every step, with every kernel's launch count set to
   0 just before and read just after (one ``phase2_select`` launch for the
   8 batches at prefetch 16, ``threefry2x32`` for the service's keys, no
   other kernel); every loss finite; the selector's flush held against the
   plain phase 2 on its replayed inputs and against a CPU copy's flush
   (phase 3's rule), and the 8 index sets against the CPU copy's
   ``select`` on the pipeline's rng; the step's time (host clock around a
   synchronized step, median of steps 3–8), tokens/s, the peak of
   ``torch.cuda.max_memory_allocated``, ``select``'s time a batch;
   ``launch.train.main(--smoke ...)`` on the card; (3) 2 layers in
   bfloat16: 4 steps with checkpoints every 2, resumed to 6 (``try_resume``
   restores an ``OptState``, the pipeline replays its selector), against
   a one-shot 6-step run; (4) ``launch.learn.main`` at the paper's size
   (100 x 100, 1000 subsets, E|Y| = 20, dense Θ, Armijo a0 = 1.5, 5
   sweeps): 5 ``partial_trace_A`` and 10 ``partial_trace_C`` launches, the
   LL never falling by more than ``_ASCENT_TOL``; (5) greedy MAP past N:
   ``Kron.map(8)`` at N = 6 and a (4, 6, 6) batch, one launch each, the
   plain loop's picks on a CPU copy, then zeros; a ``training`` JSON line,
   and ``launches_per_path.lm_train`` / ``learn_cli`` / ``k_past_n`` in the
   ``kernels`` rows;
25. the device times of every ``kernels`` row (``fill_device_times``),
   after every host-clock time above, then phase 24's train step's device
   time, idle share and largest kernels (``fill_step_profiles``), with the
   host's time of one small launch before and after the profiler sessions;
26. the MoE, SSM, hybrid and encoder-decoder families (``models/moe.py``,
   ``models/ssm.py``, jamba's unit tail, whisper's encoder and
   cross-attention) through ``ServeEngine.generate`` (``LF_CONFIGS``):
   mixtral-8x7b at full width, 4 of its 32 layers; mamba2-2.7b whole;
   whisper-tiny whole with 1500 seeded frames; jamba-1.5-large-398b's
   layout at d_model 1024 (the cuts under ``reduced``). For each, from
   ``init_params(PRNGKey(0))``: (1) float32, the first units on the card
   against a CPU copy (mixtral 1 layer, mamba2 2, the others whole),
   prefill and 4 decode steps, the chosen experts compared first
   (``RouteLog``); (2) bfloat16 against float32, the bfloat16 run on the
   float32 run's experts: the prefill's last logits and the forward logits
   over 64 tokens at each depth of ``LF_BF16_LIMITS`` (the first units of
   the same weights) within its limit, a control on weights at 5 mantissa
   bits past it, and each block's update at full depth;
   (3) decode against forward over 64 tokens, float32, MoE at capacity
   factor 8; (4) bfloat16 greedy ``generate`` of 2 prompts of 512 tokens
   (whisper 64), 32 new, inline ``"sample"`` and ``"map"`` compaction to
   128 slots (whisper 32), recency 8, each with every kernel's launch count
   set to 0 just before and read just after (one ``phase2_select`` a unit,
   row and KV head and ``threefry2x32`` 1 + 2 a unit + 1 a head; one
   ``greedy_map_kdpp`` a unit; mamba2 one key split and no selection), the
   kept positions checked and every ``SSMCache`` bit for bit the prefill's,
   the first and last attention unit's heads replayed through the kernels
   against their plain versions on a CPU copy (``lf_kernels_vs_plain``);
   ``prefill_s``, ``compact_s``, ``decode_tok_per_s``, the peak of
   ``max_memory_allocated``; (5) one decode step's host-clock and device
   time (``torch.profiler``), idle share and top operations; an
   ``lm_families`` JSON line and ``launches_per_path.lm_families`` in the
   ``kernels`` rows;
27. sharded LM training (``repro_torch.distributed``, DTensor placements
   under ``make_train_step``, ``optim.compression``): an NCCL process
   group of world size 1 in this process (a ``FileStore`` under
   ``build/``), a (data, model) = (1, 1) ``DeviceMesh``, phase 24's
   qwen2-0.5b at full width in float32 compute, params, corpus, selector
   and B = 8 x 128, placed by ``ShardingPolicy``; 3 sharded steps, each held against the
   unsharded eager step on the same batch (phase 24's tolerances), the 3
   batches drawn with every kernel's launch count set to 0 just before
   and read just after (one ``phase2_select`` launch, ``threefry2x32``,
   no other kernel, no plain phase 2); every placed tensor's local shard
   on the card; ``_quantize``, ``int8_psum`` and ``int8_allreduce_grads``
   over the world-1 group bit for bit the local quantization; the step's
   collectives by op from ``CommDebugMode``; one sharded step in the
   config's bfloat16 compute against the unsharded bfloat16 step, with the
   float32 sharded step as its control; a ``sharded_train`` JSON
   line (the mesh, placements of named leaves, the step's host-clock time
   (median of steps 2-3) against the unsharded step's and phase 24's, the
   peak of ``max_memory_allocated``) and ``launches_per_path.
   lm_sharded_train`` in the ``kernels`` rows. The group is destroyed at
   the end of the phase.
28. the families' sharded steps and the planner (``distributed.shard_ops``:
   MoE experts, SSM heads, the dense FFN's hidden dim and decode attention
   on local shards; ``launch.dryrun``): an NCCL group of one rank, a
   (1, 1) mesh; mixtral-8x7b (4 layers), mamba2-2.7b, jamba's layout and
   whisper-tiny from ``init_params(PRNGKey(0))`` in float32 compute
   (``LP_CONFIGS``): a sharded prefill of 2 prompts of 256 tokens and 4
   greedy decode steps (outputs placed by ``ShardingPolicy``) against the
   unsharded ones, logits and every cache within ``LF_F32_TOL``; one
   sharded train step (shallower, ``LP_CONFIGS``) against the unsharded
   step under phase 24's rules; ``threefry2x32``'s launches (each
   family's init) counted from 0. Then the planner: phase 27's qwen2-0.5b
   step (float32, B = 8 x 128) on real DTensors, its trees' bytes and
   the rise of ``max_memory_allocated`` over a step, against
   ``dryrun.plan_step`` of the same step on a fake group of one rank:
   the argument bytes equal, the rise within ``LP_PEAK_BOUND`` of the
   planned peak; and ``dryrun.compile_once`` of one cell of each family
   (``LP_PLAN``) on fake CUDA shards over a fake group of 512 ranks (the
   256-rank mesh), full width, one unit of depth, each record printed as
   a ``plan`` JSON line; no kernel launch on the planner's shapes, no
   process group left. A ``sharded_families`` JSON line and
   ``launches_per_path.lm_sharded_families`` in the ``kernels`` rows.
29. the examples (``examples/port/``, the JAX package's four examples
   through the port): ``quickstart``, ``prune_ffn_dpp``,
   ``serve_kv_compaction`` and ``train_dpp_selection`` as subprocesses on
   the card at their defaults, started together; each must exit 0 and
   print its key lines (``EX_KEY_LINES``), and the KV client's two
   streams must coalesce into fewer device calls than heads. Then each
   example's ``run`` in this process with every launch count from 0
   (``sv_counted``): quickstart launches phase 2, ``threefry2x32`` and the
   fused greedy MAP (one sample, one ``map(10)``) and no partial trace;
   the KV client and the trainer (16 steps) phase 2 and
   ``threefry2x32``. The compat surface on the card:
   ``sampling.batched.phase2_select(key, ...)`` against
   ``phase2_select_reference`` on the key's uniforms, and the deprecated
   ``core.sample_krondpp_batch``. Last the prune example's steps at qwen2-0.5b's full
   width (``EX_PROBE``: 4 x 2048 probe positions, d_ff 4864 -> 2432):
   one launch of the fused greedy MAP of 2432 steps, its picks against
   the plain loop's on the same kernel (``compare_maps``), its device
   time beside ``kdpp_bound``, err_dpp and err_mag. An ``examples`` JSON
   line, ``launches_per_path.examples`` and the greedy-MAP row's
   ``prune_n4864_k2432``.
30. pruning a mixture-of-experts layer at Moonlight-16B-A3B's width
   (``MOE_PRUNE``: 64 experts of 1408 units, top-6 sigmoid routing with a
   correction bias, 2 shared experts as one MLP of 2816): one layer's
   seeded weights, one expert's bias set so low that no token reaches it,
   a probe of 16 x 2048 positions of Zipf-skewed topics, and
   ``models.prune.prune_moe_layer`` with every launch count from 0: two
   launches of the fused greedy MAP, (64, 1408, 1408) with k = 704 and
   2816² with k = 1408, and no other kernel. Each launch's kernels as the
   call passed them: every head of the batched launch equal to its own
   single launch, bit for bit; the idle expert's ridge-only kernel picks
   0 .. 703; every head and the shared matrix against the plain loop
   (``compare_maps``), where a first difference at or past a kernel's
   rank (an expert's routed rows: past them only the 1e-4 ridge is left)
   is a tie; both launches' device times beside ``kdpp_bound``. A
   ``moe_prune`` JSON line, ``launches_per_path.moe_prune`` and the
   greedy-MAP row's ``moe_prune_h64_n1408_k704`` and
   ``moe_prune_shared_n2816_k1408``.

Every row of the ``kernels`` line is timed by ``kernel_times``: ``ms``,
``plain_ms`` and ``library_ms`` are device times (the durations of the
call's kernels, copies and fills, from ``torch.profiler``), so the
column ``launches × (ms - bound_ms)`` compares like with like; the
``*_loop`` keys are CUDA events around a loop of calls, the host's
launch cost included. The profiler runs last, so that no host-clock time
is taken after a profiler session.

Tolerances: picks of kernel and plain version are compared row by row.
A differing row is accepted only when the exact chain (float64, along the
common prefix) explains its first differing step as float32 roundoff:
the draw ``r = us·total`` lies within 1e-5·total of every CDF boundary
between the two picks (the kernel's block-parallel scan rounds
differently from ``torch.cumsum``), or one version stopped where the
exact residual mass is already at or below MASS_EPS. With degenerate
columns a row may pick past the span only on such exhausted mass; those
rows are counted and printed. Marginals: atol 0.05 at 3000 draws (about 5 standard
errors). Mean |Y| of the service rows: within 1 of E|Y|.

Greedy update, kernel against plain version: rtol 1e-5 with atol
1e-5 · max |lcol| for e and 1e-5 · max |lcol|² for d_new (C · cj summed in
other orders). Greedy MAP, the fused kernel against the plain loop: the
picks in order; a first difference is accepted only as a tie, where the exact
(float64) conditional variances of the two candidates given the common
prefix differ by at most 1e-4 · max diag L (float32 roundoff of a t-step
update chain is about t · 2^-24 ≈ 1.2e-5 of max diag L at t = 200, and the
margin is 8), and the two pick sets' log det L_Y then agree to 1e-3
relative. Past a rank-deficient L's rank (phase 12) every exact
conditional variance is 0, so any order there is a tie; where exact ties
decide (zero rows, a NaN diagonal) the picks must be identical. The
``greedy_map_kdpp`` row's ``max_abs_err`` is the largest such float64 tie
gap, of max diag L (0 when every comparison is identical). Kronecker
matvec, on both routes: NaN where the plain version has NaN
and nowhere else, the same infinities, and on the finite entries rtol =
atol = 2e-4 in float32
and 3e-2 in bfloat16 (tests/test_kernels.py); past 10^4 products per output
(150 x 150 and up) the float32 atol is 2e-4 · max |Y|, because two
association orders of a float32 sum of N1·N2 products differ by roundoff
that grows with the sum (up to 4e-4 on outputs of std 256 at 256 x 256),
which a fixed atol does not hold near Y = 0. Eigenvectors: |VᵀV - I| <=
1e-4 (a float32 eigh is orthonormal to about N_f · 2^-24 ≈ 6e-6 per
factor); the kernel route against the gather route within 1e-6 (each output is a sum
with one non-zero term, so both round the same product once). k-DPP
marginals: atol 0.04 at 3000 draws (4.4 standard errors at p = 0.5).

Inference, the card against a CPU copy of the model: ``log_prob`` within
1e-4 of max(1, |ref|) a row (the float32 fold of log Z over 10^4
eigenvalues errs by about 1e-3, against |log P| near 140); K[S, S] within
2e-6 (float32 sums of 10^4 terms in other orders; 2e-7 seen); P(S ⊆ Y)
within 1e-3 relative and its log (slogdet, which does not underflow at 20
and 46 items) within 1e-3 of max(1, |ref|), since K[S, S] entries of about
1e-3 err by 2e-7; singletons within 1e-4 relative + 1e-7, also against
diag K off the spectrum; the Schur complement at N = 4096 within 1e-6 ·
max |L| (a rank-5 float32 product). The cross-path identity within 2e-4 of
max(1, |rhs|): each side holds one float32 log normalizer over about 10^4
eigenvalues, and these err by about 1e-3 against float64 (printed beside
it), for |rhs| of 20 to 40. Conditioned marginals: atol 0.045 at 3000
draws, as tests/test_dpp_facade.py.

PRNG: the kernel and the plain twin agree bit for bit, and both equal
jax.random's literal values: a slip of one bit gives draws that are
statistically fine and wrong, so no distribution stands in for them.

Partial traces, kernel against plain version on the same Θ: elementwise
``|kernel - plain| <= 1e-4 * (the same contraction over |Θ| and |L|) +
1e-7``, because the two sum N2² or N1² float32 terms in other orders.
Dense route against the per-subset route: ``max |Δ| <= 1e-4 * max |ref|``
(the same float32 terms, summed through Θ or straight into A and C). The
kernel fit against the plain fit after 5 sweeps: accepted step and
backtracks equal, LLs within rtol 1e-4, factors within
``1e-3 * max |L|``. The trajectory itself amplifies float32 noise: on the
CPU two runs of the same fit already differ by 1e-5 to 3e-5 of max |L|
after 5 sweeps (threaded sums), and taking the partial traces in float64
moves them by 2e-5 to 4e-5 (20 x 20 and 50 x 50).

The rest of learning (phase 19) at 24 x 24: the card's fit and the CPU
copy's are each held against a float64 run of the same sweeps on the CPU
(full Picard's L, EM's V diag(λ) Vᵀ, joint Picard's L1 ⊗ L2, and the LL
tracks). The card's distance may be up to 4 times the CPU copy's plus the
CPU tests' tolerance (LLs 1e-4 of max |LL|; models 1e-4, 2e-4 and 5e-4 of
max |L|, tests/test_torch_{em,picard}.py). A fixed tolerance does not hold
here: from the raw init (L + I of condition 1e5) each float32 run,
on the card, on the CPU and in the JAX package, lies 1e-3 to 8e-3 of
max |L| from float64, and the two float32 runs as far from each other
(tools/learning_precision.py). At N = 10^4: full Picard within 1e-5 of
max |L| of float64 steps on the card (8e-7 seen); the first E-step's q
rows sum to |Y_i| within 1e-3 · k_max. The resumed dense-Θ fit against
the one-shot fit: factors within 1e-5 of max |L_i| (expected bit for bit,
since two builds of Θ are), the same accepted step and backtracks.

The low-rank family (phase 20): draws of the card against the CPU copy
under the picks rule above (the exact chain on U = φΓ); a row whose
phase-1 uniform lies within 1e-6 of its threshold is a different draw (the
two devices round sigmoid(log λ) apart), counted and not compared, at
most a tenth of a batch; the k-DPP's ESP masks are held equal. ``log_prob``
within 1e-4 of max(1, |ref|), K[S, S] within 2e-6, the conditioned V
within 1e-4 of max |φ|, the identity within 2e-4 of max(1, |rhs|) (both
sides float64 log-determinants of float32 K); MAP picks in order, a first
difference a tie of the exact residual masses within 1e-4 of max ‖φ_i‖²;
fits: LLs within rtol 1e-4, V and q within 1e-3 of their max, the same
backtracks, no fall of the LL past ``_ASCENT_TOL``; inclusion frequencies
within 0.05 of diag K and the mean |Y| of 3000 draws within 0.25 of E|Y|
(about 5 standard errors).

LM serving (phase 23): the float32 card against its CPU copy within 1e-4
of max(1, max |logits|) (the same float32 ops in other orders; the logits
are sums of 896 products); bfloat16 against float32 within 5% of max
|float32| (bfloat16 rounds every product and activation, 24 layers deep);
decode against forward within 1e-3 of max |forward| (the reference's test
allows 2e-2; in float32 the two differ by summation order only).

LM training (phase 24): the float32 step on the card against its CPU copy,
loss and grad norm within 1e-4 of max(1, |CPU|) (float32 sums over 512
tokens of a logsumexp over 151936 logits, in other orders). The params
after the step (``lt_check_gap``): AdamW's update element is about
lr·g / (|g| + eps), so where a grad is within roundoff of 0 (a few eps, or
roundoff of its leaf's sums) the two updates may differ by up to 2·lr,
and elsewhere they agree to float32 roundoff: every element within 2·lr a
step of max(1, max |CPU leaf|), and at most 1% of them past 1e-6 of it
(tests/test_torch_train.py holds the JAX package to the same rule). The
resumed run against the one-shot run: bit for bit where the card's
reductions are deterministic, else the same rule over the 2 resumed
steps; the losses of steps 5 and 6 within 1e-3 relative.

Sharded LM training (phase 27): the sharded step against the unsharded
step on the same card, from the same params and batches, in float32
compute (phase 24's float32 rule; in the config's bfloat16 every grad is
a bfloat16 value, so one product summed in another order moves it by a
bfloat16 ulp and AdamW's first step turns the small ones' signs). On a
(1, 1) mesh every DTensor op runs the unsharded op on the whole tensor,
except the vocab-parallel cross entropy (a max, a sum of exps and a
masked label gather in place of ``torch.logsumexp``/``gather``: float32
sums in another order) and the embedding lookup (exact). So: loss and
grad norm within 1e-4 of max(1, |unsharded|), the params after each step
by ``lt_check_gap`` (every element within 2·lr a step, at most 1% past
1e-6). In bfloat16 compute only the first step's loss and grad norm are
held, within ``LS_BF16_TOL`` = 1e-4 of max(1, |unsharded|); the float32
sharded step (a sharded path that left every cast out) must miss that
limit. The int8 compression over the world-1 group: bit for bit.

LM families (phase 26): the float32 card against its CPU copy within 1e-4
of max(1, max |logits|), the caches too; a token whose K-th and (K+1)-th
router probabilities lie within 1e-5 may route to other experts on the two
sides (float32 roundoff of the router), is counted and its row left out,
and such near ties may be at most 1% of the routed tokens; any other
routing difference fails. bfloat16 against float32, the bfloat16 run
taking the float32 run's experts (bfloat16 moves router probabilities by
about 1e-2, and a token routed to another expert is a different
computation, not a rounding of it; the tokens whose own bfloat16 choice
differs are counted): end to end, the logits within a limit per depth
(LF_BF16_LIMITS, 0.011 to 0.099 of max |float32|: the error grows with
depth, in the JAX package too), which a control run on weights rounded to
5 mantissa bits must exceed; block by block, each layer's update within
5% of the float32 update's max. The kernels at each family's compaction
shapes against their plain versions on a CPU copy: phase 2 on the
replayed "sample" heads of the first and last attention unit, and each of
those units' batched greedy-MAP launch (mixtral H = 16, N = 512, k = 120;
whisper H = 12, N = 64, k = 24), bit for bit its heads' single launches.
Decode against forward within 1e-3 of max |forward|, positions routed
apart at a near tie left out.

The last line is ``{"ok": true, "device": {...}}``; the lines before it
are the kernel table (all seven kernels: the greedy step and the fused
selection are two rows of one source) and the timing lines as JSON,
each with the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# jax.random's own values (threefry2x32, jax_threefry_partitionable on, x64
# off), typed in because this script may not import jax;
# tests/test_torch_random.py holds them against jax.random
GOLDEN = {
    "prng_key": {0: [0, 0], -1: [0, 4294967295],
                 2 ** 31 + 5: [0, 2147483653]},
    "split_0_4": [[1797259609, 2579123966], [928981903, 3453687069],
                  [4146024105, 2718843009], [2467461003, 3840466878]],
    "fold_in_3_5": [2464363587, 131619366],
    "uniform_7_8_bits": [0x3F2C9128, 0x3F79807E, 0x3E9B0E50, 0x3EE34E88,
                         0x3F3B1B62, 0x3F21849A, 0x3EE5A864, 0x3ED2ADA8],
    "choice_2_1000_32": [135, 543, 783, 164, 965, 319, 792, 83, 387, 754,
                         107, 91, 593, 503, 52, 58, 2, 379, 450, 951, 614,
                         744, 238, 156, 719, 659, 501, 59, 984, 467, 73,
                         536],
}
FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12      # H100 SXM bf16 tensor cores, dense
HBM_BYTES_S = 3.35e12    # H100 SXM HBM3
SMS = 132                # H100 SXM streaming multiprocessors
PROFILER_MARGIN_S = 0.02  # host sleep at each edge of a profiler window
WINDOW_MARK = "spin_kernel"  # torch.cuda._sleep's kernel: a window's edges
MARK_CYCLES = 100_000    # clock cycles of one lead mark, ~50 µs
LEAD_MARKS = 16          # lead marks of a first window (~0.8 ms of them)
MAX_LEAD_MARKS = 1024    # the most they are doubled to (~50 ms)
WINDOW_TRIES = 8         # windows taken until one holds its marks
WINDOWS = {"lead_marks": LEAD_MARKS, "taken": 0, "retaken": [],
           "lead_lost": []}     # lead marks unrecorded in a counted window


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# phase 3 helpers: hold kernel picks against plain picks
# ---------------------------------------------------------------------------

def check_rows(picks: np.ndarray, k_eff: np.ndarray, N: int,
               label: str) -> None:
    """No duplicates, picks in range, a -1 tail, at most k_eff picks."""
    for b, row in enumerate(picks):
        real = row[row >= 0]
        n = len(real)
        check(len(set(real.tolist())) == n, f"{label}: row {b} repeats an "
              f"item: {row.tolist()}")
        check((row[n:] == -1).all(), f"{label}: row {b} has no -1 tail")
        check(n <= int(k_eff[b]), f"{label}: row {b} has {n} picks > "
              f"k_eff {int(k_eff[b])}")
        check(n == 0 or int(real.max()) < N, f"{label}: row {b} out of range")


def check_span(picks: np.ndarray, us, G1, Gr, span: int, label: str) -> int:
    """Rows may not pick more than ``span`` items, except on residual mass
    that the exact chain (float64) has already exhausted: float32 roundoff
    left above MASS_EPS. Returns the count of such rows."""
    from repro_torch.kernels.phase2_select import MASS_EPS, cdf_at_step
    over = 0
    for b, row in enumerate(picks):
        if int((row >= 0).sum()) <= span:
            continue
        _, _, exact = cdf_at_step(us[b], G1[b], Gr[b],
                                  [int(x) for x in row[:span]])
        check(exact <= MASS_EPS, f"{label}: row {b} picks beyond the span "
              f"{span} with exact residual mass {exact!r}")
        over += 1
    print(f"  {label}: {over} rows picked past the span {span} on float32 "
          f"roundoff mass above MASS_EPS (exact mass <= MASS_EPS)")
    return over


def compare(us, k_eff, G1, Gr, label: str, span=None,
            route: str = "on_chip") -> dict:
    """Run the kernel and the plain version on the same inputs and hold
    them against each other (``compare_picks``); the kernel's route must
    be ``route``."""
    from repro_torch.kernels.phase2_select import (phase2_select_cuda,
                                                   phase2_select_plain,
                                                   phase2_select_route)
    got = phase2_select_route(int(G1.shape[1]), int(Gr.shape[1]),
                              int(us.shape[1]))
    check(got == route, f"{label}: route {got}, not {route}")
    pk = phase2_select_cuda(us, k_eff, G1, Gr)
    pp = phase2_select_plain(us, k_eff, G1, Gr)
    torch.cuda.synchronize()
    out = compare_picks(pk.cpu().numpy(), pp.cpu().numpy(), us, k_eff, G1,
                        Gr, label, span)
    out["route"] = route
    return out


def compare_picks(pk_np, pp_np, us, k_eff, G1, Gr, label: str,
                  span=None) -> dict:
    """Check kernel picks ``pk_np`` and plain picks ``pp_np`` of the same
    inputs, and prove every differing row is a float32 roundoff tie on
    the exact chain (a CDF boundary, or the MASS_EPS stop threshold)."""
    from repro_torch.kernels.phase2_select import (first_difference,
                                                   is_roundoff_tie)
    ke = k_eff.cpu().numpy()
    N = int(G1.shape[1] * Gr.shape[1])
    check_rows(pk_np, ke, N, f"{label} kernel")
    check_rows(pp_np, ke, N, f"{label} plain")
    out = {}
    if span is not None:
        out["over_span_kernel"] = check_span(pk_np, us, G1, Gr, span,
                                             f"{label} kernel")
        out["over_span_plain"] = check_span(pp_np, us, G1, Gr, span,
                                            f"{label} plain")
    same = (pk_np == pp_np).all(axis=1)
    worst, ties = 0.0, {"boundary": 0, "collapse": 0}
    for b in np.nonzero(~same)[0]:
        t, kind, value = first_difference(us[b], G1[b], Gr[b], pk_np[b],
                                          pp_np[b])
        print(f"  {label}: row {b} differs first at step {t}: {kind} "
              f"{value!r}")
        check(is_roundoff_tie(kind, value), f"{label}: row {b} differs at "
              f"step {t} and is no roundoff tie ({kind} {value!r})")
        ties[kind] += 1
        if kind == "boundary":
            worst = max(worst, value)
    out.update({"rows": int(len(same)), "identical": int(same.sum()),
                "agree_rows": float(same.mean()), "max_boundary_gap": worst,
                "boundary_ties": ties["boundary"],
                "collapse_ties": ties["collapse"],
                "picks": int((pk_np >= 0).sum())})
    print(f"  {label}: {json.dumps(out)}")
    return out


def phase1_inputs(spec, k_max: int, B: int, gen):
    dev = spec.device
    u = torch.rand((B, spec.N), generator=gen, device=dev)
    us = torch.rand((B, k_max), generator=gen, device=dev)
    return phase1_of(spec, k_max, u, us)


def phase1_of(spec, k_max: int, u, us):
    """Phase 2's inputs (us, k_eff, G1, Gr), contiguous, from the
    uniforms u (B, N) and us (B, k_max)."""
    from repro_torch.kernels.phase2_select import canonical_pair
    from repro_torch.sampling.batched import _phase1_from_uniforms
    us, Gs, k_eff, _ = _phase1_from_uniforms(u, us, spec.lams, spec.vecs,
                                             k_max)
    G1, Gr = canonical_pair(Gs)
    return us.contiguous(), k_eff.contiguous(), G1.contiguous(), \
        Gr.contiguous()


def plain_row_uniforms(row_keys, N: int, k: int):
    """A row key's phase-1 and phase-2 uniforms through the plain twin
    (``keyed_uniforms`` with ``backend="reference"``)."""
    from repro_torch import random as prng
    sub = prng.split(row_keys, backend="reference")
    return (prng.uniform(sub[:, 0], (N,), backend="reference"),
            prng.uniform(sub[:, 1], (k,), backend="reference"))


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (floats compared as their words)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


# ---------------------------------------------------------------------------
# phase 6 helpers: time and bound
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int) -> float:
    """Wall time of one call: CUDA events around a loop of ``reps`` calls,
    so the host's launch cost and the gaps between launches are in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int, warmup: int = 3, expect: str = "",
              sole: bool = False, by_name: dict = None) -> float:
    """Device time of one call: the summed durations of every kernel, copy
    and fill that ``reps`` calls ran on the card, as ``torch.profiler``
    (CUPTI) records them, over ``reps``. Host launch cost, gaps and host
    syncs stay out of it, so it reads the same way for one hand-written
    kernel and for a plain version of many launches. ``expect``: a kernel
    name that must be among the recorded ones; with ``sole``, every
    recorded event must be that kernel, one per call.

    The profiler now and then records no device side for the first
    launches after the card has been idle: the first millisecond's worth
    or more, while the host is busy (``window_report`` tells them by their
    correlation ids). So, ``PROFILER_MARGIN_S`` into the window, a train
    of short ``torch.cuda._sleep`` kernels (``WINDOW_MARK``) keeps the
    card busy for a while before the first call, and one more runs after
    the last. A window counts only when its first and last recorded
    events are marks: it was recording before the first call and after
    the last. One that is not is printed and taken again with twice the
    train (at most ``MAX_LEAD_MARKS``, and kept for later windows), up to
    ``WINDOW_TRIES`` windows; the checks above hold on the events between
    the marks. ``by_name``: a dict that receives each recorded kernel's (or
    copy's) name and its device time a call in ms, and under "events" the
    recorded events a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(WINDOW_TRIES):
        lead = WINDOWS["lead_marks"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_MARGIN_S)
            for _ in range(lead):
                torch.cuda._sleep(MARK_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(PROFILER_MARGIN_S)
        WINDOWS["taken"] += 1
        events = prof.events()
        dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if len(dev) >= 2 and WINDOW_MARK in dev[0].name \
                and WINDOW_MARK in dev[-1].name:
            first = 0
            while first < len(dev) - 1 and WINDOW_MARK in dev[first].name:
                first += 1
            if first < lead:
                WINDOWS["lead_lost"].append(lead - first)
            dev = dev[first:-1]
            break
        report = window_report(events, dev, lead, reps, fn)
        WINDOWS["retaken"].append(report)
        print(f"  profiler window retaken: {json.dumps(report)}")
        print(f"chip_smoke: profiler window retaken: {json.dumps(report)}",
              file=sys.stderr)
        WINDOWS["lead_marks"] = min(2 * lead, MAX_LEAD_MARKS)
    else:
        fail(f"none of {WINDOW_TRIES} profiler windows recorded its marks "
             f"(up to {lead} lead marks; the last: {json.dumps(report)})")
    check(not any(WINDOW_MARK in e.name for e in dev),
          "a window mark between the calls")
    us = sum(e.time_range.elapsed_us() for e in dev)
    check(us > 0, "torch.profiler recorded no device time")
    if by_name is not None:
        by_name["events"] = len(dev) / reps
        for e in dev:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / reps
    check(not expect or any(expect in e.name for e in dev),
          f"torch.profiler recorded no {expect} launch")
    check(not sole or (len(dev) == reps and all(expect in e.name
                                                 for e in dev)),
          f"not one {expect} a call: {reps} calls ran "
          f"{sorted(e.name for e in dev)[:8]} ({len(dev)} events)")
    return us / 1e3 / reps


def window_report(events, dev, lead: int, reps: int, fn) -> dict:
    """What a profiler window that lost a mark recorded: the function, the
    lead marks launched, the device events and the marks among them, the
    first and the last one's name, and the kernel launches that the host
    side recorded with no device side (matched by correlation id): their
    count and the first few starts in ms after the window opened."""
    from torch.autograd import DeviceType
    seen = {e.id for e in dev}
    launches = sorted((e for e in events if e.device_type != DeviceType.CUDA
                       and "LaunchKernel" in e.name),
                      key=lambda e: e.time_range.start)
    lost = [e.time_range.start / 1e3 for e in launches if e.id not in seen]
    return {"fn": getattr(getattr(fn, "func", fn), "__name__", repr(fn)),
            "reps": reps, "lead_marks": lead, "events": len(dev),
            "marks": sum(WINDOW_MARK in e.name for e in dev),
            "first": dev[0].name[:48] if dev else None,
            "last": dev[-1].name[:48] if dev else None,
            "launches": len(launches), "unrecorded": len(lost),
            "unrecorded_ms": lost[:4]}


DEVICE_TIMES = []        # kernel_times rows whose device times are owed


def kernel_times(kern, plain, library, reps: int, plain_reps: int,
                 expect: str, sole: bool = False, extra: dict = None,
                 **keys) -> dict:
    """The timing keys of a ``kernels`` row, every row measured the same
    way. Now, ``ms_loop``, ``plain_ms_loop`` and ``library_ms_loop``
    (``cuda_ms``). Later, in ``fill_device_times``, once every host-clock
    time of the script is taken (so that no profiler session can slow the
    host's launches under them): ``ms``, ``plain_ms`` and ``library_ms``,
    device times (``device_ms``), the plain version and the library call
    measured before and after the kernel and the lesser kept, both
    readings in ``*_runs_ms``. ``sole``: the kernel's calls must each run
    one ``expect`` kernel and nothing else (``device_ms``). ``extra``:
    more callables by name, timed as the plain version is (``<name>_ms``;
    the global route beside the cluster route). ``keys`` (bound, shapes)
    go into the same dict."""
    out = {"ms_loop": cuda_ms(kern, reps, 3), "library_ms": None, **keys}
    extra = dict(extra or {})
    for name, fn in (("plain", plain), ("library", library),
                     *extra.items()):
        if fn is not None:
            out[f"{name}_ms_loop"] = cuda_ms(fn, plain_reps, 1)
    DEVICE_TIMES.append((out, kern, plain, library, reps, plain_reps,
                         expect, sole, extra))
    return out


def fill_device_times() -> None:
    """The device times owed to every ``kernel_times`` row."""
    for out, kern, plain, library, reps, plain_reps, expect, sole, extra \
            in DEVICE_TIMES:
        others = {k: f for k, f in (("plain", plain), ("library", library),
                                    *extra.items()) if f is not None}
        before = {k: device_ms(f, plain_reps, 1) for k, f in others.items()}
        out["ms"] = device_ms(kern, reps, 3, expect=expect, sole=sole)
        for k, f in others.items():
            after = device_ms(f, plain_reps, 0)
            out[f"{k}_ms"] = min(before[k], after)
            out[f"{k}_runs_ms"] = [before[k], after]
    DEVICE_TIMES.clear()


def host_launch_us(n: int = 2000) -> float:
    """Host time of one small PyTorch launch: ``n`` in-place adds on a
    1000-element tensor between two syncs, on the host clock."""
    x = torch.ones(1000, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def greedy_library(lcol, C, cj, dj, d):
    """The greedy update's library yardstick: ``torch.mv`` and the
    elementwise tail."""
    return d - ((lcol - torch.mv(C, cj))
                / torch.sqrt(torch.clamp_min(dj[0], 1e-12))) ** 2


def bound(picks: np.ndarray, N1: int, Nr: int, k: int):
    """Least time (ms) for this data's work and what bounds it. Operations:
    the norms init (2Nk), per live step the scan and search (2N) and CGS2
    (8k²), and per downdated step (all but a row's last) 2Nk + 3N. Bytes:
    us, k_eff, G1 and Gr read once, picks written once."""
    N = N1 * Nr
    B = picks.shape[0]
    flops = 0.0
    for row in picks:
        s = int((row >= 0).sum())
        flops += 2.0 * N * k + s * (2.0 * N + 8.0 * k * k) \
            + max(s - 1, 0) * (2.0 * N * k + 3.0 * N)
    nbytes = 4.0 * (B * k + B + B * N1 * k + B * Nr * k) + 4.0 * B * k
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_row(picks: np.ndarray, N1: int, Nr: int, k: int) -> float:
    """Least time (ms) of the longest row alone: its operations (as in
    ``bound``) on one SM, at FP32_FLOPS / 132. The steps of a sample are
    sequential and one block runs it, so no batch runs faster on a
    one-block route (on the cluster route, C SMs: ``bound_row`` / C)."""
    N = N1 * Nr
    s = int((picks >= 0).sum(axis=1).max())
    flops = 2.0 * N * k + s * (2.0 * N + 8.0 * k * k) \
        + max(s - 1, 0) * (2.0 * N * k + 3.0 * N)
    return flops / (FP32_FLOPS / SMS) * 1e3


def launch_global_route(us, ke, G1, Gr):
    """One launch of the route that the cluster route replaced, on these
    inputs: "global", or "global_basis" where the global kernel's basis
    passes a block, through the C launcher's ``route`` argument over
    ctypes (counted nowhere). Returns the picks."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import phase2_select as p2
    lib = _build.load_library("phase2_select", p2.bind)
    B, k = int(us.shape[0]), int(us.shape[1])
    N1, Nr = int(G1.shape[1]), int(Gr.shape[1])
    dev = us.device
    route = ("global" if p2.global_smem_bytes(k) <= p2._smem_optin(dev.index)
             else "global_basis")
    scratch = torch.empty(B * N1 * Nr + (route == "global_basis") * B * 2
                          * k * k, dtype=torch.float32, device=dev)
    picks = torch.empty((B, k), dtype=torch.int32, device=dev)
    rc = lib.phase2_select_launch(
        us.data_ptr(), ke.data_ptr(), G1.data_ptr(), Gr.data_ptr(),
        scratch.data_ptr(), picks.data_ptr(), B, N1, Nr, k, p2.THREADS,
        p2.ROUTES.index(route), torch.cuda.current_stream(dev).cuda_stream)
    check(rc == 0, f"the {route} route's launch failed: CUDA error {rc}")
    return picks


def cluster_row(us, ke, G1, Gr, picks: np.ndarray, label: str):
    """A cluster-route row's own keys and its ``extra`` timing: the
    route is "cluster" (asserted); ``cluster``, the C side's cluster size
    (its plan equal to ``cluster_geometry``'s); ``bound_cluster_ms``, the
    longest row's operations on C SMs; ``global_route``, the global route
    on the same inputs (``launch_global_route``), its picks held against
    the plain version once, timed beside the kernel."""
    from repro_torch.kernels import phase2_select as p2
    B, k = int(us.shape[0]), int(us.shape[1])
    N1, Nr = int(G1.shape[1]), int(Gr.shape[1])
    dev = us.device
    route = p2.phase2_select_route(N1, Nr, k)
    check(route == "cluster", f"{label}: phase 2 takes route {route}, not "
          f"cluster")
    plan = p2.cluster_plan(N1, Nr, k, B, dev.index)
    host = p2.cluster_geometry(N1, Nr, k, B, p2._smem_optin(dev.index),
                               torch.cuda.get_device_properties(
                                   dev).multi_processor_count)
    check(tuple(plan[:6]) == tuple(host), f"{label}: the C side's cluster "
          f"plan {plan} is not the host's {host}")
    pg = launch_global_route(us, ke, G1, Gr).cpu().numpy()
    pp = p2.phase2_select_plain(us, ke, G1, Gr).cpu().numpy()
    agree = compare_picks(pg, pp, us, ke, G1, Gr,
                          f"{label}, the global route vs plain")
    keys = {"cluster": plan[0], "cluster_plan": list(plan),
            "bound_cluster_ms": bound_row(picks, N1, Nr, k) / plan[0],
            "global_route_agree_rows": agree["agree_rows"]}
    return keys, {"global_route": partial(launch_global_route, us, ke, G1,
                                          Gr)}


# ---------------------------------------------------------------------------
# phases 7-11 helpers: partial traces and learning
# ---------------------------------------------------------------------------

PT_SHAPES = ((100, 100), (64, 150), (7, 13))


def pt_bound(N1: int, N2: int):
    """Least time (ms) of one partial trace and what bounds it. Bytes: Θ
    (N x N), the factor and the output, each once. Operations: one
    multiply and one add per element of Θ."""
    N = N1 * N2
    nbytes = 4.0 * (N * N + N1 * N1 + N2 * N2)
    t_ops, t_bytes = 2.0 * N * N / FP32_FLOPS, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_pt(got, want, tol, label: str) -> float:
    """Elementwise ``|got - want| <= tol``; returns max |got - want|."""
    err = (got - want).abs()
    bad = int((err > tol).sum())
    check(bad == 0, f"{label}: {bad} entries beyond tolerance, max |Δ| "
          f"{float(err.max())!r}")
    return float(err.max())


def check_partial_traces(gen, dev) -> dict:
    """Phase 7: both kernels against their plain versions on random
    non-symmetric inputs; returns max |Δ| per kernel and the main-shape
    inputs for timing."""
    from repro_torch.kernels import partial_trace as pt
    err = {"A": 0.0, "C": 0.0}
    main = None
    for N1, N2 in PT_SHAPES:
        N = N1 * N2
        t4 = torch.randn((N, N), generator=gen, device=dev).reshape(
            N1, N2, N1, N2)
        L1 = torch.randn((N1, N1), generator=gen, device=dev)
        L2 = torch.randn((N2, N2), generator=gen, device=dev)
        A = pt.partial_trace_A_cuda(t4, L2)
        C = pt.partial_trace_C_cuda(t4, L1)
        torch.cuda.synchronize()
        a4 = t4.abs()
        eA = check_pt(A, pt.partial_trace_A_plain(t4, L2),
                      1e-4 * pt.partial_trace_A_plain(a4, L2.abs()) + 1e-7,
                      f"partial_trace_A {N1}x{N2}")
        eC = check_pt(C, pt.partial_trace_C_plain(t4, L1),
                      1e-4 * pt.partial_trace_C_plain(a4, L1.abs()) + 1e-7,
                      f"partial_trace_C {N1}x{N2}")
        del a4
        print(f"  partial traces {N1}x{N2}: max |kernel - plain| A {eA!r}, "
              f"C {eC!r}")
        err["A"], err["C"] = max(err["A"], eA), max(err["C"], eC)
        if main is None:
            main = (t4, L1, L2)
    return {"err": err, "main": main}


#: |kernel - plain version on the card| <= TS_TOL · (the same sum over
#: |inv|) elementwise: the card's ``index_put_`` sums a run of 32 or more
#: equal keys as a warp tree, the kernel in subset order (float32, runs of
#: up to ~80 real terms at the GENES shape: under 5e-6 of the sum).
TS_TOL = 1e-5


def ts_bound(N: int, n: int, k: int, live: int):
    """Least time (ms) of one Θ scatter and what bounds it: bytes. Θ
    written once (4 N²), the slots' keys (4 n k) and the ``live`` real
    inverse entries (Σ|Y|², 4 bytes each) read once; one add a term."""
    t_ops = live / FP32_FLOPS
    t_bytes = 4.0 * (N * N + n * k + live) / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def ts_serial_plain(N: int, idx, mask, inv):
    """``theta_scatter_plain`` on a CPU copy in one thread, where
    ``index_put_`` adds in (s, a, b) order at any size: the kernel's
    order."""
    from repro_torch.kernels.theta_scatter import theta_scatter_plain
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return theta_scatter_plain(N, idx.cpu(), mask.cpu(), inv.cpu())
    finally:
        torch.set_num_threads(threads)


def ts_inputs(L1, L2, idx, mask):
    """The subsets' inverses at the factors L1, L2, as the Θ build makes
    them, made contiguous as ``ops.theta_scatter`` does: (idx, mask,
    inv)."""
    from repro_torch.core.dpp import (SubsetBatch, identity_padded,
                                      masked_inv_and_logdet)
    from repro_torch.core.krk_picard import _subset_blocks
    _, _, B1, B2 = _subset_blocks(L1, L2, SubsetBatch(idx, mask))
    inv, _ = masked_inv_and_logdet(identity_padded(B1 * B2, mask))
    return idx, mask, inv.contiguous()


def check_theta_scatter(L1, L2, rows, k_max: int, dev) -> dict:
    """Phase 9: the Θ-scatter kernel against its plain version at the
    benchmark's shape (the fit's n subsets padded to the service's k_max,
    inverses at L1, L2): entries that differ from the plain version on the
    card and max |Δ| against ``TS_TOL``, bitwise against the plain version
    on a CPU copy in one thread; the same with each subset's second slot
    repeating its first item (no DPP sample); an all-padded batch gives
    zeros; one launch a call. Returns the report and the inputs."""
    from repro_torch.core.dpp import SubsetBatch
    from repro_torch.kernels import theta_scatter as ts
    N = L1.shape[0] * L2.shape[0]
    b = SubsetBatch.from_lists(rows, k_max=k_max, device=dev)
    args = ts_inputs(L1, L2, b.indices, b.mask)
    before = ts.theta_scatter_cuda.launches
    got = ts.theta_scatter_cuda(N, *args)
    launches = ts.theta_scatter_cuda.launches - before
    plain = ts.theta_scatter_plain(N, *args)
    scale = ts.theta_scatter_plain(N, b.indices, b.mask, args[2].abs())
    torch.cuda.synchronize()
    diff = (got - plain).abs()
    sizes = b.sizes()
    out = {"shape": {"N": N, "n": b.n, "k_max": k_max,
                     "mean_size": float(sizes.float().mean()),
                     "padded_share": 1.0 - float(sizes.sum()) / b.mask.numel()},
           "launches": launches,
           "entries_differing": int((got.view(torch.int32)
                                     != plain.view(torch.int32)).sum()),
           "max_abs_diff": float(diff.max()),
           "max_abs": float(plain.abs().max()), "tol": TS_TOL,
           "beyond_tol": int((diff > TS_TOL * scale).sum()),
           "bitwise_plain_on_card": same_bits(got, plain),
           "bitwise_plain_cpu_serial": same_bits(
               got.cpu(), ts_serial_plain(N, *args))}
    del plain, scale, diff, got
    second = torch.arange(k_max, device=dev) == 1
    rep = torch.where(second & b.mask, b.indices[:, :1], b.indices)
    out["repeats_bitwise_plain_cpu_serial"] = same_bits(
        ts.theta_scatter_cuda(N, rep, b.mask, args[2]).cpu(),
        ts_serial_plain(N, rep, b.mask, args[2]))
    out["all_padded_nonzero"] = int(ts.theta_scatter_cuda(
        N, b.indices, torch.zeros_like(b.mask), args[2]).count_nonzero())
    print(f"theta_scatter kernel vs plain: {json.dumps(out)}")
    check(launches == 1, f"theta_scatter launched {launches} times, not 1")
    check(out["beyond_tol"] == 0, f"theta_scatter: {out['beyond_tol']} "
          f"entries beyond {TS_TOL} of the plain version on the card")
    check(out["bitwise_plain_cpu_serial"]
          and out["repeats_bitwise_plain_cpu_serial"],
          "theta_scatter differs from the plain version in one CPU thread")
    check(out["all_padded_nonzero"] == 0,
          "theta_scatter of an all-padded batch is not zero")
    return {"report": out, "args": args}


def ts_library(N: int, idx, mask, inv):
    """The ``index_put_`` library call the kernel replaced: every slot
    pair, padded ones as zeros, into a zero N x N buffer."""
    ii = idx.long()
    vals = inv * (mask[:, :, None] & mask[:, None, :])
    return torch.zeros((N, N), dtype=inv.dtype, device=inv.device
                       ).index_put_((ii[:, :, None], ii[:, None, :]), vals,
                                    accumulate=True)


def max_rel(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max())


# ---------------------------------------------------------------------------
# phases 12-16 helpers: greedy MAP, Kronecker matvec, k-DPP
# ---------------------------------------------------------------------------

GREEDY_NS = (1, 33, 4097, 10_000)
GREEDY_KS = (1, 20, 200)
KM_SHAPES = ((3, 4, 2), (64, 96, 7), (1, 1, 1), (100, 100, 64))
# inputs with all-zero rows of mat(X[b]) (which the kernel skips), the
# degenerate factor sizes, a ragged tile (N2 = 70: 3 tiles of 24 columns),
# and shapes near and past the one-launch route's shared-memory limit (227 KB
# a block on the H100: N1 = N2 up to 153 in float32, 200 in bfloat16; at
# N1 = 300, N2 = 8 mat(X[b]) and A's rows pass it)
KM_CASES = (*((*s, "dense") for s in KM_SHAPES),
            (100, 100, 46, "onehot"), (100, 100, 64, "zero_rows"),
            (64, 96, 7, "zero_entry"), (1, 100, 4, "dense"),
            (100, 1, 4, "dense"), (1, 100, 3, "onehot"),
            (130, 70, 3, "dense"), (300, 8, 3, "dense"),
            (300, 8, 5, "zero_rows"), (150, 150, 4, "dense"),
            (160, 160, 4, "dense"), (256, 256, 4, "dense"),
            (256, 256, 4, "zero_rows"))
# the dtypes whose route is two passes, by (N1, N2); every other case takes
# the one-launch route
KM_TWO_PASS = {(300, 8): ("float32", "bfloat16"), (160, 160): ("float32",),
               (256, 256): ("float32", "bfloat16")}
# a NaN in A or an Inf in B, with zero rows of mat(X[b]), on both routes
KM_NONFINITE = ((100, 100, 46, "onehot"), (100, 100, 8, "zero_rows"),
                (256, 256, 4, "onehot"), (256, 256, 4, "zero_rows"))
# past this many products per output the float32 atol is 2e-4 of max |Y|
KM_LONG_SUM = 10_000
GREEDY_TIE_TOL = 1e-4      # of max diag L, on the float64 chain
GREEDY_KDPP_NS = (1, 33, 512, 4097, 10_000)   # the fused selection, phase 12
GREEDY_KDPP_KS = (1, 20, 120, 200)
GREEDY_KDPP_HS = (1, 4, 7)


def greedy_inputs(N: int, k: int, gen, dev):
    """One step's (lcol, C, cj, dj, d), C row-major (N, k); d positive."""
    lcol = torch.randn((N,), generator=gen, device=dev)
    C = 0.3 * torch.randn((N, k), generator=gen, device=dev)
    cj = C[N // 2].clone()
    dj = 1.0 + torch.rand((1,), generator=gen, device=dev)
    d = 1.0 + 4.0 * torch.rand((N,), generator=gen, device=dev)
    return lcol, C, cj, dj, d


def greedy_bound(N: int, k: int):
    """Least time (ms) of one greedy update and what bounds it. Bytes:
    lcol, C, cj, dj and d read once, e and d_new written once.
    Operations: 2Nk for C · cj and 4N for the elementwise tail."""
    nbytes = 4.0 * (N * k + 2 * N + k + 1) + 4.0 * 2 * N
    flops = 2.0 * N * k + 4.0 * N
    t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def km_bound(A, B, X):
    """Least time (ms) of one Kronecker matvec on these inputs and what
    bounds it. Operations, counted on X's non-zeros (a one-hot batch needs
    far fewer than a dense one): T = mat(X[b]) · Bᵀ costs 2 N2 per non-zero
    of X, at the bfloat16 tensor-core rate when X and B are bfloat16 (exact
    products, float32 sums) and at the float32 rate otherwise; Y = A · T
    costs 2 N1 N2 per non-zero row of mat(X[b]), at the float32 rate (T is
    float32). Bytes: A, B and X read once, Y written once."""
    N1, N2, batch = int(A.shape[0]), int(B.shape[0]), int(X.shape[0])
    nz = X.reshape(batch, N1, N2) != 0
    rate1 = (BF16_FLOPS if X.dtype == B.dtype == torch.bfloat16
             else FP32_FLOPS)
    t_ops = (2.0 * N2 * float(nz.sum()) / rate1
             + 2.0 * N1 * N2 * float(nz.any(dim=2).sum()) / FP32_FLOPS)
    nbytes = (A.element_size() * N1 * N1 + B.element_size() * N2 * N2
              + 2.0 * X.element_size() * batch * N1 * N2)
    t_bytes = nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_greedy_update(gen, dev) -> float:
    """Phase 12a: the step kernel against its plain version; returns the
    largest |kernel - plain| over e and d_new."""
    from repro_torch.kernels import greedy_map as gm
    worst = 0.0
    for N in GREEDY_NS:
        for k in GREEDY_KS:
            lcol, C, cj, dj, d = greedy_inputs(N, k, gen, dev)
            scale = float(lcol.abs().max())
            for layout, Cv in (("row-major", C),
                               ("(k, N) buffer", C.t().contiguous().t())):
                e, dn = gm.greedy_map_update_cuda(lcol, Cv, cj, dj, d)
                torch.cuda.synchronize()
                e_p, dn_p = gm.greedy_map_update_plain(lcol, Cv, cj, dj, d)
                for got, want, atol in ((e, e_p, 1e-5 * scale),
                                        (dn, dn_p, 1e-5 * scale ** 2)):
                    err = (got - want).abs()
                    bad = int((err > atol + 1e-5 * want.abs()).sum())
                    check(bad == 0, f"greedy_map_update N={N} k={k} "
                          f"{layout}: {bad} entries beyond tolerance, max "
                          f"|Δ| {float(err.max())!r}")
                    worst = max(worst, float(err.max()))
    print(f"greedy_map_update: {len(GREEDY_NS) * len(GREEDY_KS) * 2} cases "
          f"within tolerance, max |kernel - plain| {worst!r}")
    return worst


def greedy_live_steps(L, picks) -> int:
    """Steps of the greedy order ``picks`` of L whose pick is live: its
    exact (float64) conditional variance given the prefix above the
    kernel's degeneracy eps. A dead step only scores the items; a live one
    also takes the dot over the prefix and the update."""
    d = torch.diagonal(L).double().clone()
    eps = float(1e-8 * torch.clamp_min(torch.diagonal(L).max(), 1e-30))
    CT = torch.zeros((len(picks), L.shape[0]), dtype=torch.float64,
                     device=L.device)
    live = 0
    for t, j in enumerate(int(x) for x in picks):
        dj = float(d[j])
        if not dj > eps:
            continue
        live += 1
        e = (L[:, j].double() - CT[:t].T @ CT[:t, j]) / math.sqrt(dj)
        CT[t] = e
        d -= e * e
    return live


def kdpp_bound(N: int, k: int, live: list):
    """Least time (ms) of one fused selection of a batch whose matrices
    have ``live`` live steps each (``greedy_live_steps``), what bounds it,
    and the bound of the busiest matrix alone on one SM. Operations: step
    t scores N items (2N); a live step adds the dot over the t-column
    prefix (2Nt) and the tail (4N). Bytes: the diagonal and one column of L
    a live step read once, the picks written once."""
    def flops(n_live):
        # the live steps are the first n_live (a pick goes dead only past
        # the numerical rank, and stays so)
        return 2.0 * N * k + sum(2.0 * N * t + 4.0 * N
                                 for t in range(n_live))
    total = sum(flops(x) for x in live)
    nbytes = 4.0 * sum(N + x * N for x in live) + 4.0 * len(live) * k
    t_ops, t_bytes = total / FP32_FLOPS, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes",
            max(flops(x) for x in live) / (FP32_FLOPS / SMS) * 1e3)


def kdpp_psd(N: int, k: int, H: int, gen, dev):
    """H random PSD kernels (N, N): X Xᵀ / r + 0.1 I, X (N, r) normal,
    r = min(N, k + 8)."""
    r = min(N, k + 8)
    X = torch.randn((H, N, r), generator=gen, device=dev)
    return torch.baddbmm(0.1 * torch.eye(N, device=dev).expand(H, N, N), X,
                         X.transpose(1, 2), alpha=1.0 / r)


def kdpp_special(kind: str, gen, dev):
    """(L (2, N, N), k, rule) of a phase-12 edge case. "rank_deficient":
    X Xᵀ of rank 40 at N = 512, k = 120 past the rank (every pick past the
    rank a tie: exact conditional variances 0); "rank_zero_rows": rank 30
    on 30 random items of N = 4097 and exact zero rows elsewhere, k = 120
    (past the rank every variance is exactly 0 in both versions, so the
    first index wins, across the cluster's CTAs: picks identical);
    "equal_diagonal": unit-norm keys of dimension 64 plus 1e-4 I at
    N = 4097 with the diagonal set to 1.0001 exactly (the first pick a tie
    of all items: index 0), k = 120; "nan_diagonal": a PSD L at N = 512
    with a NaN at (300, 300), k = 20 (eps is NaN, every step degenerate:
    the NaN item, then d in descending order, picks identical)."""
    if kind == "rank_deficient":
        X = torch.randn((2, 512, 40), generator=gen, device=dev)
        return X @ X.transpose(1, 2), 120, "tie_past_rank"
    if kind == "rank_zero_rows":
        L = torch.zeros((2, 4097, 4097), device=dev)
        for h in range(2):
            idx = torch.randperm(4097, generator=gen, device=dev)[:30]
            X = torch.randn((30, 30), generator=gen, device=dev)
            L[h][idx[:, None], idx[None, :]] = X @ X.T + 0.5 * torch.eye(
                30, device=dev)
        return L, 120, "identical"
    if kind == "equal_diagonal":
        X = torch.randn((2, 4097, 64), generator=gen, device=dev)
        X = X / torch.linalg.norm(X, dim=-1, keepdim=True)
        L = X @ X.transpose(1, 2) + 1e-4 * torch.eye(4097, device=dev)
        L.diagonal(dim1=1, dim2=2).fill_(1.0001)
        return L, 120, "tie"
    L = kdpp_psd(512, 20, 2, gen, dev)
    L[:, 300, 300] = float("nan")
    return L, 20, "identical"


def check_greedy_kdpp(gen, dev) -> dict:
    """Phase 12b: the fused selection against the plain loop on the card,
    at N in GREEDY_KDPP_NS x k in GREEDY_KDPP_KS (k <= N) x H in
    GREEDY_KDPP_HS and on the edge cases of ``kdpp_special``: one launch a
    call (counted), every head against the plain version under its rule
    (``compare_maps``: equal, or a first difference at a float64 tie), and
    every head of a batched launch equal to its own single launch, bit for
    bit. Returns the largest tie gap met (0 when all equal), the cases and
    the plans taken."""
    from repro_torch.kernels import greedy_map as gm
    cases, plans, worst = [], {}, 0.0

    def one(Ls, k, label, rule):
        nonlocal worst
        n0 = gm.greedy_map_kdpp_cuda.launches
        got = gm.greedy_map_kdpp_cuda(Ls, k)
        torch.cuda.synchronize()
        check(gm.greedy_map_kdpp_cuda.launches == n0 + 1,
              f"{label}: {gm.greedy_map_kdpp_cuda.launches - n0} launches")
        check(got.dtype == torch.int32 and got.is_cuda and tuple(got.shape)
              == (Ls.shape[0], k), f"{label}: picks {got.dtype} "
              f"{tuple(got.shape)} on {got.device}")
        want = gm.greedy_map_kdpp_plain(Ls, k).cpu().numpy()
        pk_all = got.cpu().numpy()
        same = 0
        for h in range(Ls.shape[0]):
            alone = gm.greedy_map_kdpp_cuda(Ls[h].contiguous(), k)
            check(torch.equal(alone, got[h]), f"{label} head {h}: the "
                  f"batched launch differs from its single launch")
            pk, pp = pk_all[h], want[h]
            check(len(set(pk.tolist())) == k and pk.min() >= 0
                  and pk.max() < Ls.shape[-1], f"{label} head {h}: picks "
                  f"not {k} distinct items: {pk.tolist()[:12]}")
            if rule == "identical":
                check(np.array_equal(pk, pp), f"{label} head {h}: picks "
                      f"{pk.tolist()[:12]} vs plain {pp.tolist()[:12]}")
            elif rule == "tie_past_rank":
                # float32 X Xᵀ is full rank in float64 by its roundoff
                # (about 1e-6 of the top eigenvalue); the rank-40 gap is
                # near 0.3 of it
                rank = int(torch.linalg.matrix_rank(
                    Ls[h].double(), rtol=1e-4, hermitian=True))
                diff = np.nonzero(pk != pp)[0]
                t = int(diff[0]) if diff.size else k
                if t < rank:
                    worst = max(worst, compare_maps(
                        Ls[h], pk[:rank], pp[:rank], f"{label} head {h}",
                        quiet=True).get("tie_gap", 0.0))
            else:
                worst = max(worst, compare_maps(
                    Ls[h], pk, pp, f"{label} head {h}", quiet=True).get(
                        "tie_gap", 0.0))
            same += int(np.array_equal(pk, pp))
        cases.append({"case": label, "identical_heads": same,
                      "heads": int(Ls.shape[0])})

    for N in GREEDY_KDPP_NS:
        for k in (k for k in GREEDY_KDPP_KS if k <= N):
            plans[f"{N}x{k}"] = gm.greedy_map_kdpp_plan(N, k, dev)
            for H in GREEDY_KDPP_HS:
                one(kdpp_psd(N, k, H, gen, dev), k, f"N={N} k={k} H={H}",
                    "tie")
    for kind in ("rank_deficient", "rank_zero_rows", "equal_diagonal",
                 "nan_diagonal"):
        Ls, k, rule = kdpp_special(kind, gen, dev)
        one(Ls, k, kind, rule)
    print(f"greedy_map_kdpp: {len(cases)} launches against the plain "
          f"version, heads identical {sum(c['identical_heads'] for c in cases)}"
          f" of {sum(c['heads'] for c in cases)}, largest tie gap {worst!r}; "
          f"plans {json.dumps(plans)}")
    return {"max_tie_gap": worst, "cases": cases, "plans": plans}


def km_inputs(N1: int, N2: int, batch: int, pattern: str, dtype, gen,
              dev):
    """A, B, X of one Kronecker matvec case. ``pattern``: "dense"; "onehot"
    (one 1 per X[b], the eigenvector path's input); "zero_rows" (about half
    the rows of each mat(X[b]) zero); "zero_entry" (X[1] all zero)."""
    A = torch.randn((N1, N1), generator=gen, device=dev)
    B = torch.randn((N2, N2), generator=gen, device=dev)
    X = torch.randn((batch, N1, N2), generator=gen, device=dev)
    if pattern == "onehot":
        X = torch.zeros((batch, N1 * N2), device=dev)
        X[torch.arange(batch, device=dev),
          torch.randint(0, N1 * N2, (batch,), generator=gen,
                        device=dev)] = 1.0
    elif pattern == "zero_rows":
        X[torch.rand((batch, N1), generator=gen, device=dev) < 0.5] = 0.0
    elif pattern == "zero_entry":
        X[1] = 0.0
    else:
        check(pattern == "dense", f"unknown pattern {pattern}")
    return (A.to(dtype), B.to(dtype),
            X.reshape(batch, N1 * N2).contiguous().to(dtype))


def sass_of(lib: Path, kernel: str, opcode: str) -> list:
    """The ``opcode`` instructions of the function whose mangled name holds
    ``kernel`` in the built library ``lib`` (``cuobjdump -sass``)."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    found, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and opcode in line:
            found.append(" ".join(line.split("/*")[1].split("*/")[1].split()))
    return found


def check_kron_matvec(gen, dev) -> dict:
    """Phase 12b: the Kronecker matvec kernel against its plain version on
    both routes; one counted launch and (allocations counted by the caching
    allocator) no scratch on the one-launch route, one on the two-pass
    route. Returns the largest |kernel - plain| per dtype and per route."""
    from repro_torch.kernels import kron_matvec as km
    worst = {"float32": 0.0, "bfloat16": 0.0}
    by_route = {"one_launch": 0.0, "two_pass": 0.0}
    cases = {"one_launch": 0, "two_pass": 0}
    for N1, N2, batch, pattern in KM_CASES:
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
            name = str(dtype).split(".")[-1]
            label = f"kron_matvec {N1}x{N2} batch {batch} {pattern} {name}"
            A, B, X = km_inputs(N1, N2, batch, pattern, dtype, gen, dev)
            route = km.kron_matvec_route(A, B, X)
            check(route == ("two_pass" if name in KM_TWO_PASS.get((N1, N2), ())
                            else "one_launch"), f"{label}: route {route}")
            torch.cuda.synchronize()
            n0 = km.kron_matvec_cuda.launches
            a0 = torch.cuda.memory_stats()["allocation.all.allocated"]
            got = km.kron_matvec_cuda(A, B, X)
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - a0
            torch.cuda.synchronize()
            check(km.kron_matvec_cuda.launches == n0 + 1,
                  f"{label}: {km.kron_matvec_cuda.launches - n0} launches")
            check(allocs == (1 if route == "one_launch" else 2),
                  f"{label}: {allocs} allocations on the {route} route")
            check(got.dtype == dtype, f"kron_matvec returned {got.dtype}")
            want = km.kron_matvec_plain(A, B, X).float()
            err = (got.float() - want).abs()
            atol = tol
            if dtype == torch.float32 and N1 * N2 > KM_LONG_SUM:
                atol = tol * float(want.abs().max())
            bad = int((err > atol + tol * want.abs()).sum())
            check(bad == 0, f"{label} ({route}): {bad} entries beyond "
                  f"tolerance, max |Δ| {float(err.max())!r}")
            if pattern == "zero_entry":
                check(bool((got[1] == 0).all()), f"{label}: Y[1] not zero")
            worst[name] = max(worst[name], float(err.max()))
            by_route[route] = max(by_route[route], float(err.max()))
            cases[route] += 1
    check(cases["two_pass"] > 0 and cases["one_launch"] > 0,
          f"kron_matvec cases per route {cases}")
    nf_routes = {}
    for (N1, N2, batch, pattern), kind in itertools.product(
            KM_NONFINITE, ("nan_A", "inf_B")):
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 3e-2)):
            name = str(dtype).split(".")[-1]
            label = (f"kron_matvec {N1}x{N2} batch {batch} {pattern} {kind} "
                     f"{name}")
            A, B, X = km_inputs(N1, N2, batch, pattern, dtype, gen, dev)
            if kind == "nan_A":
                A[N1 // 2, (N1 - 1) // 3] = float("nan")
            else:
                B[N2 // 3, N2 // 2] = float("inf")
            route = km.kron_matvec_route(A, B, X)
            got = km.kron_matvec_cuda(A, B, X).float()
            want = km.kron_matvec_plain(A, B, X).float()
            torch.cuda.synchronize()
            nan_w, nan_g = torch.isnan(want), torch.isnan(got)
            check(bool(nan_w.any()), f"{label}: the plain version has no NaN")
            check(torch.equal(nan_g, nan_w), f"{label} ({route}): NaN at "
                  f"{int((nan_g & ~nan_w).sum())} entries where the plain "
                  f"version has none, missing at {int((nan_w & ~nan_g).sum())}")
            fin = torch.isfinite(want)
            inf = ~fin & ~nan_w
            check(torch.equal(got[inf], want[inf]), f"{label}: infinities "
                  f"differ")
            err = (got[fin] - want[fin]).abs()
            atol = tol
            if dtype == torch.float32 and N1 * N2 > KM_LONG_SUM:
                atol = tol * float(want[fin].abs().max())
            bad = int((err > atol + tol * want[fin].abs()).sum())
            check(bad == 0, f"{label} ({route}): {bad} finite entries beyond "
                  f"tolerance, max |Δ| {float(err.max())!r}")
            nf_routes[route] = nf_routes.get(route, 0) + 1
    check(set(nf_routes) == {"one_launch", "two_pass"},
          f"kron_matvec non-finite cases per route {nf_routes}")
    print(f"kron_matvec: {sum(nf_routes.values())} non-finite cases spread "
          f"NaN as the plain version does ({json.dumps(nf_routes)})")
    print(f"kron_matvec: {sum(cases.values())} cases within tolerance "
          f"({json.dumps(cases)}), max |kernel - plain| {json.dumps(worst)}, "
          f"by route {json.dumps(by_route)}")
    return {**worst, "by_route": by_route, "cases": cases,
            "nonfinite_cases": nf_routes}


def conditional_variances(L, prefix) -> torch.Tensor:
    """Exact (float64) conditional variances of every item given the
    items ``prefix``: diag L - diag(L[:, P] L[P, P]^{-1} L[P, :])."""
    d = torch.diagonal(L).double()
    if len(prefix) == 0:
        return d
    P = torch.as_tensor(np.asarray(prefix, np.int64), device=L.device)
    Lp = L.index_select(0, P).double()                  # (t, N)
    X = torch.linalg.solve(Lp.index_select(1, P), Lp)
    return d - (Lp * X).sum(dim=0)


def logdet(L, picks) -> float:
    P = torch.as_tensor(np.asarray(picks, np.int64), device=L.device)
    sign, ld = torch.linalg.slogdet(L.index_select(0, P).index_select(
        1, P).double())
    check(float(sign) > 0, f"L_Y of the picks is not PD (sign {sign})")
    return float(ld)


def compare_maps(L, pk, pp, label: str, quiet: bool = False) -> dict:
    """Kernel picks ``pk`` against plain picks ``pp`` of the same L, in
    order. A first difference must be a tie on the exact chain (float64
    conditional variances of the two candidates given the common prefix
    within GREEDY_TIE_TOL · max diag L); log det L_Y of both sets.
    ``quiet``: print only a difference."""
    out = {"identical": bool((pk == pp).all())}
    ld_k, ld_p = logdet(L, pk), logdet(L, pp)
    out.update(logdet_kernel=ld_k, logdet_plain=ld_p)
    diff = np.nonzero(pk != pp)[0]
    if diff.size:
        t = int(diff[0])
        d64 = conditional_variances(L, pk[:t])
        scale = float(torch.diagonal(L).max())
        a, b = int(pk[t]), int(pp[t])
        gap = abs(float(d64[a]) - float(d64[b])) / scale
        out.update(first_difference=t, candidates=[a, b],
                   d64=[float(d64[a]), float(d64[b])], tie_gap=gap)
        check(gap <= GREEDY_TIE_TOL, f"{label}: picks differ at step {t} "
              f"({a} vs {b}) and the exact conditional variances differ by "
              f"{gap!r} of max diag L > {GREEDY_TIE_TOL}: no tie")
        check(abs(ld_k - ld_p) <= 1e-3 * abs(ld_p), f"{label}: log det "
              f"L_Y {ld_k!r} (kernel) vs {ld_p!r} (plain)")
    if not quiet or not out["identical"]:
        print(f"  {label}: {json.dumps(out)}")
    return out


def kdpp_marginals(L: np.ndarray, k: int) -> np.ndarray:
    """P(i in Y) of the k-DPP of L, by enumeration of all k-subsets."""
    N = L.shape[0]
    marg, Z = np.zeros(N), 0.0
    for Y in itertools.combinations(range(N), k):
        w = np.linalg.det(L[np.ix_(Y, Y)])
        Z += w
        marg[list(Y)] += w
    return marg / Z


# ---------------------------------------------------------------------------
# phase 17 helpers: facade inference
# ---------------------------------------------------------------------------

LOGP_RTOL = 1e-4        # log_prob, card vs CPU copy, of max(1, |ref|)
K_SUB_ATOL = 2e-6       # K[S, S] entries, card vs CPU copy
LOG_MARG_RTOL = 1e-3    # P(S ⊆ Y) and its log (of max(1, |ref|)), vs CPU
COND_ID_RTOL = 2e-4     # the cross-path identity, of max(1, |rhs|)
SCHUR_ATOL = 1e-6       # Schur complement at N = 4096, of max |L|
COND_MARG_ATOL = 0.045  # 3000 draws (as tests/test_dpp_facade.py)


def check_log_prob(main, cpu, batch) -> dict:
    """``main.log_prob`` on the card against the CPU copy, row by row, and
    ``log_likelihood`` against the mean."""
    lp = main.log_prob(batch)
    ll = main.log_likelihood(batch)
    torch.cuda.synchronize()
    check(lp.is_cuda and ll.is_cuda and tuple(lp.shape) == (batch.n,),
          f"log_prob gave {tuple(lp.shape)} on {lp.device}, log_likelihood "
          f"on {ll.device}")
    check(bool(torch.isfinite(lp).all()), "log_prob is not finite")
    ref = cpu.log_prob(batch)
    d = (lp.cpu() - ref).abs()
    ll_err = abs(float(ll) - float(lp.double().mean()))
    out = {"n": batch.n, "k_max": batch.k_max, "max_abs_diff": float(d.max()),
           "max_rel_diff": float((d / ref.abs().clamp_min(1.0)).max()),
           "mean_cpu": float(ref.mean()), "log_likelihood": float(ll),
           "log_likelihood_vs_mean": ll_err}
    print(f"log_prob, card vs CPU copy per row: {json.dumps(out)}")
    check(out["max_rel_diff"] <= LOGP_RTOL, f"log_prob differs from the CPU "
          f"copy by {out['max_rel_diff']!r} > {LOGP_RTOL} of max(1, |ref|)")
    check(ll_err <= 1e-5 * max(1.0, abs(float(ll))),
          f"log_likelihood is {float(ll)!r}, the mean {float(lp.mean())!r}")
    return out


def check_marginals(main, cpu, pool) -> dict:
    """``main.marginal`` on the card: 8 singletons against the CPU copy
    and against diag K = (P1∘P1) σ (P2∘P2)ᵀ off the factored spectrum;
    sets of 2, 5, 20 and 46 items of ``pool`` against the CPU copy (K[S,
    S] entrywise, P(S ⊆ Y) and its log by slogdet, which does not
    underflow)."""
    spec = main.spectrum()
    P1, P2 = spec.vecs
    sig = torch.sigmoid(spec.log_eigenvalues()).reshape(spec.sizes)
    diag_k = ((P1 * P1) @ sig @ (P2 * P2).T).reshape(-1)
    err = {"cpu": 0.0, "diag_k": 0.0}
    for i in pool[:8]:
        p = main.marginal(i)
        check(p.is_cuda and p.dim() == 0, f"marginal({i}) is {p.shape} on "
              f"{p.device}")
        for key, ref in (("cpu", float(cpu.marginal(i))),
                         ("diag_k", float(diag_k[i]))):
            e = abs(float(p) - ref)
            check(e <= 1e-4 * abs(ref) + 1e-7, f"marginal({i}) = "
                  f"{float(p)!r}, {key} {ref!r}")
            err[key] = max(err[key], e)
    out = {"singletons": pool[:8], "singleton_max_abs_diff": err}
    for size in (2, 5, 20, 46):
        S = pool[:size]
        K = main.marginal_kernel_submatrix(S)
        p = main.marginal(S)
        check(K.is_cuda and p.is_cuda and tuple(K.shape) == (size, size),
              f"marginal of {size} items on {p.device}, K_S {tuple(K.shape)}")
        Kc, pc = cpu.marginal_kernel_submatrix(S), float(cpu.marginal(S))
        sign, ld = torch.linalg.slogdet(K.double())
        sign_c, ld_c = torch.linalg.slogdet(Kc.double())
        rec = {"marginal": float(p), "marginal_cpu": pc,
               "log_marginal": float(ld), "log_marginal_cpu": float(ld_c),
               "K_sub_max_abs_diff": float((K.cpu() - Kc).abs().max())}
        out[f"set{size}"] = rec
        print(f"  marginal of {size} items: {json.dumps(rec)}")
        check(float(sign) > 0 and float(sign_c) > 0, f"K_S of {size} items "
              f"is not PD (signs {float(sign)}, {float(sign_c)})")
        check(rec["K_sub_max_abs_diff"] <= K_SUB_ATOL, f"K_S of {size} items "
              f"differs from the CPU copy by {rec['K_sub_max_abs_diff']!r}")
        check(abs(float(ld) - float(ld_c)) <= LOG_MARG_RTOL
              * max(1.0, abs(float(ld_c))), f"log P(S ⊆ Y) of {size} items: "
              f"{float(ld)!r} vs {float(ld_c)!r}")
        # 1e-37 covers float32's subnormals, where det loses its digits
        check(abs(float(p) - pc) <= LOG_MARG_RTOL * abs(pc) + 1e-37,
              f"P(S ⊆ Y) of {size} items: {float(p)!r} vs {pc!r}")
    return out


def check_identity(main, cond, A, Bs, dev, cache) -> dict:
    """The cross-path identity log P_cond(B′) = log P(B ∪ A) - log P(A ⊆ Y)
    on the card, B′ the items of B renumbered into the sorted complement
    of A; and where its float32 error comes from: each log normalizer
    against a float64 one (the factor spectra in float64; a float64
    Cholesky of I + L′). ``cache`` holds the conditioned spectrum."""
    from repro_torch.core.dpp import SubsetBatch
    comp = np.setdiff1d(np.arange(main.N), A)
    local = [np.searchsorted(comp, B).tolist() for B in Bs]
    lhs = cond.log_prob(SubsetBatch.from_lists(local, k_max=4, device=dev),
                        cache)
    full = SubsetBatch.from_lists([sorted(A + B) for B in Bs],
                                  k_max=len(A) + 4, device=dev)
    rhs = main.log_prob(full) - torch.log(main.marginal(A))
    check(lhs.is_cuda and rhs.is_cuda, "the identity left the card")
    d = (lhs - rhs).abs()
    ll = cond.spectrum(cache).log_eigenvalues()
    log_z_cond = float(torch.logaddexp(ll, torch.zeros_like(ll)).sum())
    eye = torch.eye(cond.N, dtype=torch.float64, device=dev)
    log_z_cond64 = float(2.0 * torch.log(torch.diagonal(
        torch.linalg.cholesky(cond.L.double() + eye))).sum())
    del eye
    lams64 = [torch.clamp_min(torch.linalg.eigvalsh(f.double()), 0.0)
              for f in main.factors]
    ll64 = (torch.log(lams64[0])[:, None] + torch.log(lams64[1])[None, :])
    ll32 = main.spectrum().log_eigenvalues()
    out = {"A": A, "B": Bs, "lhs": lhs.tolist(), "rhs": rhs.tolist(),
           "max_abs_diff": float(d.max()),
           "max_rel_diff": float((d / rhs.abs().clamp_min(1.0)).max()),
           "log_z_cond": log_z_cond, "log_z_cond_float64_cholesky":
               log_z_cond64,
           "log_z_main": float(torch.logaddexp(
               ll32, torch.zeros_like(ll32)).sum()),
           "log_z_main_float64": float(torch.logaddexp(
               ll64, torch.zeros_like(ll64)).sum())}
    print(f"cross-path identity: {json.dumps(out)}")
    check(out["max_rel_diff"] <= COND_ID_RTOL, f"log P_cond(B') and log "
          f"P(B ∪ A) - log P(A ⊆ Y) differ by {out['max_rel_diff']!r} > "
          f"{COND_ID_RTOL} of max(1, |rhs|)")
    return out


def check_schur(guard, gen, dev) -> dict:
    """``condition`` of a 64 x 64 model (N = 4096, the default guard) on 5
    items of one of its rows, on the card against the CPU copy in full."""
    from repro_torch import dpp
    A = next(r for r in guard.sample(gen, 8).to_lists() if len(r) >= 5)[:5]
    cg = guard.condition(A)
    cgc = dpp.Kron([f.cpu() for f in guard.factors],
                   device="cpu").condition(A)
    check(cg.L.is_cuda and cg.N == guard.N - 5, f"condition at N = "
          f"{guard.N} gave N = {cg.N} on {cg.L.device}")
    scale = float(guard.dense_kernel().abs().max())
    err = float((cg.L.cpu() - cgc.L).abs().max())
    out = {"A": A, "N": guard.N, "max_abs_diff": err, "max_abs_L": scale}
    print(f"condition, card vs CPU copy: {json.dumps(out)}")
    check(err <= SCHUR_ATOL * scale, f"Schur complement differs from the CPU "
          f"copy by {err!r} > {SCHUR_ATOL} * max |L|")
    return out


def check_conditioned_marginals(gen) -> float:
    """A (2, 3) model conditioned on items 0 and 3, 3000 draws on the card:
    singleton frequencies against the brute-force conditional marginals."""
    from repro_torch import dpp
    from repro_torch.core.dpp import enumerate_probabilities
    small = dpp.random_kron(gen, (2, 3))
    A = [0, 3]
    cond = small.condition(A)
    probs = enumerate_probabilities(small.dense_kernel())
    comp = [i for i in range(6) if i not in A]
    z_a = sum(p for Y, p in probs.items() if set(A) <= set(Y))
    want = np.array([sum(p for Y, p in probs.items()
                         if set(A) <= set(Y) and i in Y) / z_a for i in comp])
    mem = np.zeros((3000, cond.N))
    for b, row in enumerate(cond.sample(gen, 3000).to_lists()):
        mem[b, row] = 1.0
    err = float(np.abs(mem.mean(0) - want).max())
    print(f"conditioned (2,3) on {A}, 3000 kernel draws: max |freq - P(i in "
          f"Y | A)| = {err!r}")
    check(err <= COND_MARG_ATOL, f"conditioned marginals off by {err}")
    return err


def inference_path(main, guard, batch, fit_rows, gen, dev) -> dict:
    """Phase 17: facade inference on the phase-5 model ``main`` and the
    phase-8 batch, then the conditioned model's draw through phase 2's
    global route. Returns the checks' records (``inference``), the CUDA
    event times (``times``), the phase-2 ``kernel_times`` row
    (``phase2``), the draw's launch count and its agreement with the
    plain version."""
    t_phase = time.perf_counter()
    import repro_torch.obs as obs
    from repro_torch import dpp
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.sampling.spectral import SpectralCache
    cpu = dpp.Kron([f.cpu() for f in main.factors], device="cpu")
    pool = list(dict.fromkeys(itertools.chain.from_iterable(fit_rows)))
    inference = {"log_prob": check_log_prob(main, cpu, batch),
                 "marginal": check_marginals(main, cpu, pool)}
    A_obs = next(r for r in fit_rows if len(r) >= 5)[:5]
    cond = main.condition(A_obs, max_dense=10_000)
    torch.cuda.synchronize()
    check(isinstance(cond, dpp.Dense) and cond.L.is_cuda
          and cond.N == main.N - 5, f"condition gave {cond!r} on "
          f"{cond.L.device}")
    check(torch.equal(cond.L, cond.L.T), "the conditioned L is not symmetric")
    check(bool(torch.isfinite(cond.L).all()), "the conditioned L is not "
          "finite")
    inf_times = {"condition_9995_ms": cuda_ms(
        lambda: main.condition(A_obs, max_dense=10_000), reps=3, warmup=1)}
    cache_c = SpectralCache()
    inf_times["cond_first_spectrum_ms"] = cuda_ms(
        lambda: cond.spectrum(cache_c), reps=1, warmup=0)
    spec_c = cond.spectrum(cache_c)
    Bs = [[], [x for x in pool if x not in A_obs][:1],
          [x for x in pool if x not in A_obs][1:4]]
    inference["identity"] = check_identity(main, cond, A_obs, Bs, dev,
                                           cache_c)
    inference["schur_4096"] = check_schur(guard, gen, dev)
    # the conditioned model's draw: m = 1 at N = 9995 takes phase 2's
    # cluster route; its one launch is counted and held against the plain
    # version on the draw's replayed uniforms
    k_c = spec_c.suggested_k_max()
    route_c = p2.phase2_select_route(cond.N, 1, k_c)
    check(route_c == "cluster", f"phase 2 of the conditioned draw (N = "
          f"{cond.N}, k_max {k_c}) takes the {route_c} route, not cluster")
    gen_c = torch.Generator(device=dev).manual_seed(4)
    cond_state = gen_c.get_state()
    cond_tracker = obs.InMemoryTracker()
    p2.launches = 0
    with obs.use(cond_tracker):
        cb = cond.sample(gen_c, 64, cache=cache_c)
        torch.cuda.synchronize()
    cond_launches = p2.launches
    cond_count = int(cond_tracker.counter_value("kernels.phase2_select.cuda"))
    print(f"cond.sample(gen, 64) at N = {cond.N}, k_max {k_c}, route "
          f"{route_c}: phase-2 launches {cond_launches}, "
          f"kernels.phase2_select.cuda {cond_count}")
    check(cond_launches == 1 and cond_count == 1, f"the conditioned draw "
          f"launched phase 2 {cond_launches} times, counted {cond_count}")
    check(cb.indices.is_cuda and cb.n == 64, f"the conditioned draw gave "
          f"{cb.n} rows on {cb.indices.device}")
    for r in cb.to_lists():
        check(len(set(r)) == len(r) and all(0 <= i < cond.N for i in r),
              f"a conditioned row repeats an item or leaves [0, "
              f"{cond.N}): {r}")
    replay_c = torch.Generator(device=dev)
    replay_c.set_state(cond_state)
    us_c, ke_c, G1_c, Gr_c = phase1_inputs(spec_c, k_c, 64, replay_c)
    pk_c = torch.where(cb.mask, cb.indices, -1).cpu().numpy()
    pp_c = p2.phase2_select_plain(us_c, ke_c, G1_c, Gr_c).cpu().numpy()
    agree_cond = compare_picks(pk_c, pp_c, us_c, ke_c, G1_c, Gr_c,
                               f"conditioned m=1 N={cond.N} B=64 (cluster)")
    inference["conditioned_marginal_err"] = check_conditioned_marginals(gen)
    s20 = pool[:20]
    inf_times["log_prob_ms"] = cuda_ms(lambda: main.log_prob(batch), reps=10,
                                       warmup=2)
    inf_times["marginal20_ms"] = cuda_ms(lambda: main.marginal(s20),
                                         reps=20, warmup=2)
    inf_times["cond_sample64_ms"] = cuda_ms(
        lambda: cond.sample(gen, 64, cache=cache_c), reps=5, warmup=1)
    b_ms, b_by = bound(pk_c, cond.N, 1, k_c)
    more, extra = cluster_row(us_c, ke_c, G1_c, Gr_c, pk_c,
                              "the conditioned draw")
    times_c = kernel_times(
        partial(p2.phase2_select_cuda, us_c, ke_c, G1_c, Gr_c),
        partial(p2.phase2_select_plain, us_c, ke_c, G1_c, Gr_c), None,
        reps=5, plain_reps=2, expect="phase2_select_kernel_cluster",
        sole=True, extra=extra, **more,
        kernel_route=route_c, bound_ms=b_ms, bound_by=b_by,
        bound_row_ms=bound_row(pk_c, cond.N, 1, k_c),
        live_steps=int((pk_c >= 0).sum()),
        max_row_steps=int((pk_c >= 0).sum(axis=1).max()),
        shapes={"N1": cond.N, "Nr": 1, "k_max": k_c, "B": 64})
    inf_times["phase_s"] = time.perf_counter() - t_phase
    print(f"  inference times (ms, CUDA events; the phase on the host "
          f"clock, s): {json.dumps(inf_times)}")
    return {"inference": inference, "times": inf_times, "phase2": times_c,
            "launches": cond_launches, "agree": agree_cond}


# ---------------------------------------------------------------------------
# phase 18 helpers: keyed randomness
# ---------------------------------------------------------------------------

INT32_OPS_S = SMS * 64 * 1.98e9   # H100 SXM INT32 lanes x SMs x boost clock
TF_UNIFORM_OPS = 80      # int32 operations a uniform: 77 hash, 3 conversion
TF_COUNTERS = 10_000     # uniforms a row: N of the main model
TF_SHAPES = ((0,), (), (1,), (7,), (TF_COUNTERS,))
TF_BIG = ((64, TF_COUNTERS), (512, TF_COUNTERS))   # one key's 2-D draws
Ticket = collections.namedtuple("Ticket", "tenant seq num_samples")


def tf_bound(R: int, n: int):
    """Least time of R x n float32 uniforms: the integer operations over
    the card's INT32 issue rate, or the keys read and the floats written
    over HBM, whichever is larger."""
    t_ops = TF_UNIFORM_OPS * R * n / INT32_OPS_S
    t_bytes = (16 * R + 4 * R * n) / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def check_twin_bits(dev) -> dict:
    """Phase 18, bits: every mode of the ``threefry2x32`` kernel against
    the plain twin on the card, bit for bit, for 1 and 512 keys over
    ``TF_SHAPES`` (and one key's ``TF_BIG``); both against ``GOLDEN``.
    Returns the cases held and the largest |kernel - plain| of the
    uniforms (0 when bitwise)."""
    from repro_torch import random as prng
    cases, err = 0, 0.0
    for R in (1, 512):
        keys = prng.split(prng.PRNGKey(R, dev), R)
        data = (torch.arange(R, dtype=torch.int64, device=dev)
                * 2654435761) & 0xFFFFFFFF
        check(same_bits(prng.fold_in(keys, data),
                        prng.fold_in(keys, data, "reference")),
              f"threefry2x32 fold_in, {R} keys: kernel and plain differ")
        cases += 1
        fns = {"split": lambda b, shape: prng.split(keys, shape, b),
               "bits": lambda b, shape: prng.bits(keys, shape, b),
               "uniform": lambda b, shape: prng.uniform(keys, shape,
                                                        backend=b),
               "uniform_bounds": lambda b, shape: prng.uniform(
                   keys, shape, -3.0, 2.5, backend=b),
               "split_uniform": lambda b, shape: torch.cat(
                   prng.split_uniform(keys, math.prod(shape), 46,
                                      backend=b), dim=-1)}
        for shape in TF_SHAPES + (TF_BIG if R == 1 else ()):
            for name, fn in fns.items():
                got, want = fn(None, shape), fn("reference", shape)
                check(same_bits(got, want), f"threefry2x32 {name}, {R} keys, "
                      f"shape {shape}: kernel and plain twin differ")
                if got.is_floating_point() and got.numel():
                    err = max(err, float((got - want).abs().max()))
                cases += 1
    for b in (None, "reference"):
        def key(s):
            return prng.PRNGKey(s, dev)
        for seed, words in GOLDEN["prng_key"].items():
            check(prng.key_data(key(seed)).tolist() == words,
                  f"PRNGKey({seed}) is not JAX's {words}")
        check(prng.key_data(prng.split(key(0), 4, b)).tolist()
              == GOLDEN["split_0_4"], f"split(PRNGKey(0), 4), {b}")
        check(prng.key_data(prng.fold_in(key(3), 5, b)).tolist()
              == GOLDEN["fold_in_3_5"], f"fold_in(PRNGKey(3), 5), {b}")
        u = prng.uniform(key(7), (8,), backend=b)
        check(u.view(torch.int32).cpu().numpy().astype(np.uint32).tolist()
              == GOLDEN["uniform_7_8_bits"], f"uniform(PRNGKey(7), 8), {b}")
        check(prng.choice(key(2), 1000, (32,), replace=False, backend=b)
              .cpu().tolist() == GOLDEN["choice_2_1000_32"],
              f"choice(PRNGKey(2), 1000, 32), {b}")
        cases += 5
    out = {"cases": cases, "max_abs_err": err}
    print(f"threefry2x32, kernel vs plain twin and the golden values: "
          f"{json.dumps(out)}")
    return out


def counted(fn, tracker_name: str = ""):
    """Run ``fn`` with the phase-2 and threefry2x32 launch counts set to 0
    just before and read just after, under a fresh tracker. Returns
    (fn's result, {"phase2_select": n, "threefry2x32": n})."""
    import repro_torch.obs as obs
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.kernels import threefry as tf
    tracker = obs.InMemoryTracker()
    p2.launches = 0
    tf.threefry2x32_cuda.launches = 0
    with obs.use(tracker):
        out = fn()
        torch.cuda.synchronize()
    n = {"phase2_select": p2.launches,
         "threefry2x32": tf.threefry2x32_cuda.launches}
    for op, k in n.items():
        c = {e: int(tracker.counter_value(f"kernels.{op}.{e}"))
             for e in ("cuda", "reference")}
        check(c == {"cuda": k, "reference": 0}, f"{tracker_name}: {op} "
              f"launched {k} times, counted {c}")
    return out, n


def keyed_path(main, svc, batch, init, dev) -> dict:
    """Phase 18: keyed randomness at full width on the phase-5 model."""
    from repro_torch import random as prng
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.kernels import threefry as tf
    from repro_torch.learning import engine as eng
    from repro_torch.learning import schedules
    from repro_torch.sampling import kdpp as kd
    from repro_torch.sampling.batched import (compact_selection,
                                              gather_factor_columns,
                                              keyed_uniforms)
    from repro_torch.sampling.spectral import log_product_spectrum
    from repro_torch.serving import TenantKeyring
    out = {"bits": check_twin_bits(dev)}
    spec, k_max, N = svc.spectrum, svc.k_max, svc.spectrum.N

    # draws: model.sample(key, 64) and (key, 64, k=20) on the kernels,
    # replayed through the plain twin and the plain phase 2
    key1 = prng.PRNGKey(1, dev)
    rk_p = prng.split(key1, 64, backend="reference")
    u_p, us_p = plain_row_uniforms(rk_p, N, k_max)
    u_k, us_k = keyed_uniforms(prng.split(key1, 64), N, k_max)
    check(same_bits(u_k, u_p) and same_bits(us_k, us_p),
          "model.sample's uniforms: kernel and plain twin differ")
    b_dpp, n_dpp = counted(lambda: main.sample(key1, 64), "sample(key, 64)")
    ins = phase1_of(spec, k_max, u_p, us_p)
    pp = p2.phase2_select_plain(*ins).cpu().numpy()
    pk = torch.where(b_dpp.mask, b_dpp.indices, -1).cpu().numpy()
    out["sample64"] = {"launches": n_dpp, **compare_picks(
        pk, pp, *ins, "keyed model.sample(key, 64)")}
    check(n_dpp["phase2_select"] == 1 and n_dpp["threefry2x32"] > 0,
          f"model.sample(key, 64) launched {n_dpp}")
    b_k, n_k = counted(lambda: main.sample(key1, 64, k=20),
                       "sample(key, 64, k=20)")
    u_p, us_p = plain_row_uniforms(rk_p, N, 20)
    mask = kd._phase1_kdpp_from_uniforms(u_p, log_product_spectrum(
        spec.lams), 20)
    sel, valid, _ = compact_selection(mask, 20)
    G1, Gr = (G.contiguous() for G in p2.canonical_pair(
        gather_factor_columns(spec.vecs, spec.sizes, sel, valid)))
    ke = mask.sum(dim=1).to(torch.int32)
    pp = p2.phase2_select_plain(us_p, ke, G1, Gr).cpu().numpy()
    pk = torch.where(b_k.mask, b_k.indices, -1).cpu().numpy()
    out["sample64_k20"] = {"launches": n_k, **compare_picks(
        pk, pp, us_p, ke, G1, Gr, "keyed model.sample(key, 64, k=20)")}
    check(n_k["phase2_select"] == 1 and n_k["threefry2x32"] > 0,
          f"model.sample(key, 64, k=20) launched {n_k}")
    for r in b_k.to_lists():
        check(len(set(r)) == 20, f"a keyed k-DPP row is not 20 items: {r}")

    # draw_keyed: 512 keys of three tenants from a keyring, in one chunk
    # and in chunks of 64: the same rows, row for row
    sizes = (1, 4, 16, 64, 200)
    tickets = [Ticket(("alpha", "beta", "gamma")[i % 3], 10 + i, n)
               for i, n in enumerate(sizes)]
    ring = TenantKeyring(5, device=dev)
    keys, n_ring = counted(lambda: ring.row_keys(tickets, 512),
                           "TenantKeyring.row_keys")
    check(tuple(keys.shape) == (512, 2) and n_ring["threefry2x32"] >= 2,
          f"row_keys gave {tuple(keys.shape)}, launches {n_ring}")
    svc64 = main.service(seed=0, max_batch=64)
    (rows_1, trunc_1, col_1), n_1 = counted(lambda: svc.draw_keyed(keys),
                                            "draw_keyed, one chunk")
    (rows_64, trunc_64, col_64), n_64 = counted(
        lambda: svc64.draw_keyed(keys), "draw_keyed, chunks of 64")
    same = sum(a == b for a, b in zip(rows_1, rows_64))
    out["draw_keyed"] = {"keys": 512, "served": sum(sizes),
                         "identical_rows_vs_max_batch_64": same,
                         "launches_one_chunk": n_1,
                         "launches_chunks_of_64": n_64,
                         "truncations": [trunc_1, trunc_64],
                         "collapsed": [col_1, col_64],
                         "keyring_launches": n_ring}
    print(f"draw_keyed of 512 keys: {json.dumps(out['draw_keyed'])}")
    check(same == 512 and (trunc_1, col_1) == (trunc_64, col_64),
          f"draw_keyed is not invariant to max_batch: {same} of 512 rows")
    check(n_1["phase2_select"] == 1 and n_64["phase2_select"] == 8,
          f"draw_keyed launched phase 2 {n_1} / {n_64}, not 1 / 8")
    for r in rows_1:
        check(len(set(r)) == len(r) and all(0 <= i < N for i in r),
              f"a keyed row is not distinct items in range: {r}")

    # learning: three stochastic sweeps, minibatch 100 of the phase-8
    # batch; the key each sweep drew its minibatch from, and the indices,
    # against the plain twin's chain on the CPU
    drawn = []
    chosen = eng.select_minibatch

    def recording(key, b, size):
        drawn.append(key.clone())
        return chosen(key, b, size)

    eng.select_minibatch = recording
    try:
        rep, n_fit = counted(lambda: init.fit(
            batch, algorithm="krk-stochastic", minibatch_size=100, iters=3,
            log_every=3, seed=7, schedule=schedules.armijo(a0=1.5)),
            "krk-stochastic fit")
    finally:
        eng.select_minibatch = chosen
    key = prng.PRNGKey(7, "cpu")
    same_idx = []
    for k_sel in drawn:
        key, k_cpu = prng.split(key)
        want = prng.choice(k_cpu, batch.n, (100,), replace=False)
        got = prng.choice(k_sel, batch.n, (100,), replace=False)
        same_idx.append(bool(torch.equal(prng.as_key(k_sel).cpu(), k_cpu))
                        and bool(torch.equal(got.cpu(), want)))
    out["learning"] = {"sweeps": len(drawn), "minibatches_equal": same_idx,
                       "launches": n_fit, "lls": rep.log_likelihoods}
    print(f"krk-stochastic, 3 sweeps of 100: {json.dumps(out['learning'])}")
    check(len(drawn) == 3 and all(same_idx), "the stochastic fit's "
          f"minibatches are not the plain twin's: {same_idx}")
    check(np.isfinite(rep.log_likelihoods).all(), "stochastic LL not finite")
    check(n_fit["threefry2x32"] == 9, f"3 sweeps launched threefry2x32 "
          f"{n_fit['threefry2x32']} times, not 9 (a split, and a choice's "
          f"split and bits, each sweep)")
    out["launches"] = {"sample64": n_dpp["threefry2x32"],
                       "sample64_k20": n_k["threefry2x32"],
                       "draw_keyed_512": n_1["threefry2x32"],
                       "draw_keyed_512_by_64": n_64["threefry2x32"],
                       "keyring_512": n_ring["threefry2x32"],
                       "fit_3_sweeps": n_fit["threefry2x32"]}

    # times: the kernel, the plain twin and torch.rand (another generator,
    # for scale) at 16, 64 and 512 rows of 10^4 uniforms; the flush
    tf_times = {}
    n = TF_COUNTERS
    for R in (16, 64, 512):
        keys = prng.split(prng.PRNGKey(R, dev), R)
        b_ms, b_by = tf_bound(R, n)
        tf_times[R] = kernel_times(
            partial(tf.threefry2x32_cuda, keys, n, "uniform"),
            partial(tf.threefry2x32_plain, keys, n, "uniform"),
            partial(torch.rand, (R, n), device=dev), reps=50,
            plain_reps=5, expect="threefry2x32_kernel", sole=True,
            bound_ms=b_ms, bound_by=b_by,
            shapes={"keys": R, "counters": n, "mode": "uniform"})
        print(f"  threefry2x32 {R} x 10^4: {json.dumps(tf_times[R])}")
    # the fused split_uniform of the serving path: a request's 16 rows and
    # a flush's 512 rows of 10^4 + 46 uniforms
    for R in (16, 512):
        keys = prng.split(prng.PRNGKey(R, dev), R)
        b_ms, b_by = tf_bound(R, n + k_max)
        tf_times[f"split_uniform_{R}"] = kernel_times(
            partial(tf.threefry2x32_cuda, keys, n, "split_uniform",
                    n2=k_max),
            partial(tf.threefry2x32_plain, keys, n, "split_uniform",
                    n2=k_max),
            partial(torch.rand, (R, n + k_max), device=dev), reps=50,
            plain_reps=5, expect="threefry2x32_split_uniform_kernel",
            sole=True, bound_ms=b_ms, bound_by=b_by,
            shapes={"keys": R, "counters": [n, k_max],
                    "mode": "split_uniform"})
        print(f"  threefry2x32 split_uniform {R} x (10^4 + {k_max}): "
              f"{json.dumps(tf_times[f'split_uniform_{R}'])}")
    out["times"] = tf_times
    flush_ms = []
    for _ in range(6):
        tk = [svc.submit(n) for n in sizes]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.flush()
        torch.cuda.synchronize()
        flush_ms.append((time.perf_counter() - t0) * 1e3)
        check(sum(len(t.result()) for t in tk) == 285, "flush rows")
    out["flush285_ms"] = flush_ms[1:]
    out["flush285_median_ms"] = float(np.median(flush_ms[1:]))
    print(f"  the 285-row flush (ms, host clock): {flush_ms[1:]}")
    return out


# ---------------------------------------------------------------------------
# phase 19 helpers: the rest of learning
# ---------------------------------------------------------------------------

# the CPU tests' tolerances (tests/test_torch_{em,picard}.py): LLs, and the
# final model of each learner as a share of its max |entry|
LL_RTOL = 1e-4
MODEL_REL = {"picard": 1e-4, "em": 2e-4, "joint": 5e-4}
F32_MARGIN = 4.0        # the card's float32 error against the CPU's
PICARD_F64_REL = 1e-5   # full Picard at N = 10^4 against float64 steps
RESUME_REL = 1e-5       # resumed against one-shot factors, of max |L_i|


def float64_fits(factors, batch) -> dict:
    """The three baselines' 3 sweeps in float64 on the CPU, through the
    same step functions as the fits: {name: (LL track, model)}, the model
    L for full Picard and EM and L1 ⊗ L2 for joint Picard."""
    from repro_torch.core import em
    from repro_torch.core.dpp import log_likelihood
    from repro_torch.core.joint_picard import joint_picard_step
    from repro_torch.core.picard import picard_step
    from repro_torch.learning.objective import (log_likelihood_eig,
                                                log_likelihood_factored)
    L1, L2 = (f.detach().cpu().double() for f in factors)
    L = torch.kron(L1, L2)
    lam, V = torch.linalg.eigh(L)
    lam = torch.clamp_min(lam, 1e-6)
    lls = {"picard": [float(log_likelihood(L, batch))],
           "joint": [float(log_likelihood_factored((L1, L2), batch))],
           "em": [float(log_likelihood_eig(lam, V, batch))]}
    for _ in range(3):
        L = picard_step(L, batch, 1.0)
        lls["picard"].append(float(log_likelihood(L, batch)))
        L1, L2 = joint_picard_step(L1, L2, batch, 1.0, 50)
        lls["joint"].append(float(log_likelihood_factored((L1, L2), batch)))
        lam = em.m_step_eigvals(em.e_step(lam, V, batch))
        V = em.eigvec_ascent(lam, V, batch, 1e-3)
        lls["em"].append(float(log_likelihood_eig(lam, V, batch)))
    return {"picard": (lls["picard"], L), "joint": (lls["joint"],
                                                      torch.kron(L1, L2)),
            "em": (lls["em"], (V * lam[None, :]) @ V.T)}


def small_fits_card_vs_cpu(dev) -> dict:
    """The three fits at 24 x 24 (N = 576, 60 subsets of a rescaled model,
    the init a second random_kron), on the card and on a CPU copy, both
    held against a float64 run of the same sweeps on the CPU."""
    from repro_torch import dpp
    from repro_torch import random as prng
    from repro_torch.core.dpp import SubsetBatch
    from repro_torch.core.picard import fit_picard
    true = dpp.random_kron(prng.PRNGKey(0, dev), (24, 24)).rescale(10.0)
    rows = [r for r in true.sample(prng.PRNGKey(1, dev), 60).to_lists() if r]
    init = dpp.random_kron(prng.PRNGKey(2, dev), (24, 24))
    batches = {"card": SubsetBatch.from_lists(rows, device=dev),
               "cpu": SubsetBatch.from_lists(rows, device="cpu")}
    runs = {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        b, m = batches[where], dpp.Kron(init.factors, device=d)
        joint = m.fit(b, algorithm="joint", iters=3, device=d)
        em_fit = m.fit(b, algorithm="em", iters=3, a=1e-3, device=d)
        pic = fit_picard(m.dense_kernel(), b, iters=3, device=d)
        runs[where] = {
            "joint": (joint.log_likelihoods,
                      torch.kron(*joint.model.factors)),
            "em": (em_fit.log_likelihoods, em_fit.model.L),
            "picard": (pic.log_likelihoods, pic.L)}
    exact = float64_fits(init.factors, batches["cpu"])
    out = {"n": len(rows), "k_max": batches["cpu"].k_max}
    for name in ("joint", "em", "picard"):
        ll64, model64 = exact[name]
        ll64 = np.asarray(ll64)
        err = {}
        for where in ("card", "cpu"):
            lls, model = runs[where][name]
            err[where] = (float(np.abs(np.asarray(lls) - ll64).max()),
                          max_rel(model.cpu().double(), model64))
        row = {"lls_card": runs["card"][name][0],
               "lls_cpu": runs["cpu"][name][0], "lls_float64": ll64.tolist(),
               "ll_err_card_cpu_vs_float64": [err["card"][0],
                                              err["cpu"][0]],
               "model_err_card_cpu_vs_float64": [err["card"][1],
                                                 err["cpu"][1]],
               "model_card_vs_cpu": max_rel(runs["card"][name][1].cpu(),
                                            runs["cpu"][name][1])}
        out[name] = row
        print(f"  24 x 24 {name}: {json.dumps(row)}")
        ll_bound = F32_MARGIN * err["cpu"][0] + LL_RTOL * np.abs(ll64).max()
        model_bound = F32_MARGIN * err["cpu"][1] + MODEL_REL[name]
        check(np.isfinite(runs["card"][name][0]).all()
              and err["card"][0] <= ll_bound,
              f"24 x 24 {name}: the card's LLs miss the float64 run's by "
              f"{err['card'][0]} > {ll_bound}")
        check(err["card"][1] <= model_bound, f"24 x 24 {name}: the card's "
              f"model misses the float64 run's by {err['card'][1]} of max "
              f"|L| > {model_bound}")
    return out


def checkpointed_fit(init, batch, oneshot, fit_kw, ck_dir) -> dict:
    """The phase-10 dense-Θ Armijo fit saved every 2 sweeps: 3 sweeps,
    then resumed to 5, against phase 10's one-shot 5-sweep fit; the
    resumed run's partial-trace launches counted."""
    import repro_torch.obs as obs
    from repro_torch.kernels import partial_trace as pt
    kw = dict(fit_kw, log_every=1, checkpoint_dir=str(ck_dir), save_every=2)
    init.fit(batch, **dict(kw, iters=3))
    saved = sorted(p.name for p in ck_dir.iterdir())
    tracker = obs.InMemoryTracker()
    pt.partial_trace_A_cuda.launches = 0
    pt.partial_trace_C_cuda.launches = 0
    with obs.use(tracker):
        resumed = init.fit(batch, **dict(kw, iters=5, resume=True))
        torch.cuda.synchronize()
    launches = {"A": pt.partial_trace_A_cuda.launches,
                "C": pt.partial_trace_C_cuda.launches}
    counts = {k: int(tracker.counter_value(f"kernels.partial_trace_{k}.cuda"))
              for k in ("A", "C")}
    pairs = list(zip(resumed.model.factors, oneshot.model.factors))
    rel = [max_rel(a, b) for a, b in pairs]
    out = {"saved": saved, "ll_sweeps": resumed.ll_sweeps,
           "lls_resumed": resumed.log_likelihoods,
           "lls_oneshot": oneshot.log_likelihoods[4:],
           "entries_differing": [int((a != b).sum()) for a, b in pairs],
           "max_abs_diff": [float((a - b).abs().max()) for a, b in pairs],
           "max_rel_diff": rel, "launches": launches, "counters": counts,
           "a": [float(resumed.state.sched.a), float(oneshot.state.sched.a)],
           "backtracks": [int(resumed.state.sched.backtracks),
                          int(oneshot.state.sched.backtracks)]}
    print(f"checkpointed dense-Θ fit, resumed 3 -> 5 against one-shot 5: "
          f"{json.dumps(out)}")
    check(saved == ["step_2", "step_3"], f"saved steps {saved}")
    check(resumed.ll_sweeps == [4, 5], f"resumed at {resumed.ll_sweeps}")
    check(launches == {"A": 2, "C": 4} and counts == launches,
          f"the resumed sweeps launched the partial traces {launches} "
          f"times, counted {counts}, not A 2 and C 4")
    check(max(rel) <= RESUME_REL, f"resumed factors differ from the "
          f"one-shot fit's by {rel} of max |L_i| > {RESUME_REL}")
    check(out["a"][0] == out["a"][1] and out["backtracks"][0]
          == out["backtracks"][1], f"the resumed schedule carry differs: "
          f"{out['a']}, {out['backtracks']}")
    return out


def save_restore_ms(state, ck_dir) -> dict:
    """Host clock of a blocking save and of a restore of ``state`` (the
    device syncs included); the restored leaves equal the saved ones."""
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    mgr = CheckpointManager(CheckpointConfig(str(ck_dir), async_save=False))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(1, state, blocking=True)
    t1 = time.perf_counter()
    back = mgr.restore(target=state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for a, b in zip(back.tree_flatten(), state.tree_flatten()):
        check(np.array_equal(np.asarray(a.cpu() if hasattr(a, "cpu") else a),
                             np.asarray(b.cpu() if hasattr(b, "cpu") else b)),
              "a restored leaf differs from the saved one")
    check(back.params[0].device == state.params[0].device,
          "the restored state left the card")
    nbytes = sum(p.numel() * p.element_size() for p in state.params)
    return {"save_ms": (t1 - t0) * 1e3, "restore_ms": (t2 - t1) * 1e3,
            "param_bytes": nbytes}


def rest_of_learning(init, batch, oneshot, fit_kw, dev) -> dict:
    """Phase 19: joint Picard, full Picard and EM at N = 10^4 on the
    phase-8 batch and init, the same fits at 24 x 24 against a CPU copy,
    the checkpointed dense-Θ fit, and one sweep of each learner timed."""
    from repro_torch import dpp
    from repro_torch.core import em
    from repro_torch.core.joint_picard import joint_picard_step
    from repro_torch.core.krk_picard import krk_picard_step
    from repro_torch.core.picard import fit_picard, picard_step
    from repro_torch.learning.schedules import _ASCENT_TOL
    t_phase = time.perf_counter()
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 products would run in TF32")
    out = {}

    # joint and full Picard start from the init rescaled to the data's
    # E|Y| = 20: from the raw init (L + I of condition 2.5e7, the float32
    # dense L already indefinite) both break down in float32 at N = 10^4
    # while a float64 run ascends (tools/learning_precision.py)
    start = init.rescale(20.0)
    rj = start.fit(batch, algorithm="joint", iters=3, log_every=3)
    min_j = [float(torch.linalg.eigvalsh(f)[0]) for f in rj.model.factors]
    out["joint"] = {"lls": rj.log_likelihoods, "min_eig": min_j,
                    "chunk_s": rj.sweep_times}
    print(f"joint Picard, 3 sweeps at N = 10^4: {json.dumps(out['joint'])}")
    check(isinstance(rj.model, dpp.Kron) and all(
        bool(torch.isfinite(f).all()) for f in rj.model.factors)
        and min(min_j) > 0, f"joint Picard's factors are not finite and "
        f"PD: min eigenvalues {min_j}")
    check(len(rj.log_likelihoods) == 4
          and np.isfinite(rj.log_likelihoods).all(),
          f"joint Picard's LL track {rj.log_likelihoods}")

    # full Picard on the dense kernel, and the same steps in float64
    Ls = start.dense_kernel(10_000)
    rp = fit_picard(Ls, batch, iters=3, a=1.0)
    L64 = Ls.double()
    for _ in range(3):
        L64 = picard_step(L64, batch, 1.0)
    out["picard"] = {"lls": rp.log_likelihoods, "step_s": rp.step_times,
                     "vs_float64": max_rel(rp.L.double(), L64)}
    del L64, Ls
    print(f"full Picard, 3 steps at N = 10^4: {json.dumps(out['picard'])}")
    check(len(rp.log_likelihoods) == 4
          and np.isfinite(rp.log_likelihoods).all()
          and bool((np.diff(rp.log_likelihoods) >= -_ASCENT_TOL).all()),
          f"full Picard's LL fell by more than {_ASCENT_TOL}: "
          f"{rp.log_likelihoods}")
    check(bool(torch.isfinite(rp.L).all()) and torch.equal(rp.L, rp.L.T),
          "full Picard's kernel is not finite and symmetric")
    check(out["picard"]["vs_float64"] <= PICARD_F64_REL, f"full Picard's "
          f"kernel misses the float64 steps' by {out['picard']['vs_float64']}"
          f" of max |L| > {PICARD_F64_REL}")
    del rp

    # EM from eigh(L0) of the raw init
    L0 = init.dense_kernel(10_000)
    re = init.fit(batch, algorithm="em", iters=3, a=1e-3, max_dense=10_000,
                  log_every=3)
    lam_e = re.state.params[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam0, V0 = torch.linalg.eigh(L0)      # EM's start, as the fit takes it
    torch.cuda.synchronize()
    eigh_ms = (time.perf_counter() - t0) * 1e3
    lam0 = torch.clamp_min(lam0, 1e-6)
    q_err = float((em.e_step(lam0, V0, batch).sum(-1)
                   - batch.sizes().to(torch.float32)).abs().max())
    out["em"] = {"lls": re.log_likelihoods, "chunk_s": re.sweep_times,
                 "lam_min": float(lam_e.min()), "lam_max": float(lam_e.max()),
                 "first_q_sum_max_abs_err": q_err, "eigh_ms": eigh_ms}
    print(f"EM, 3 sweeps at N = 10^4: {json.dumps(out['em'])}")
    check(isinstance(re.model, dpp.Dense) and re.model.N == init.N,
          f"EM did not return a Dense model of N = {init.N}")
    check(bool(torch.isfinite(lam_e).all()) and bool((lam_e > 0).all()),
          f"EM's λ leave (0, inf): [{out['em']['lam_min']}, "
          f"{out['em']['lam_max']}]")
    check(np.isfinite(re.log_likelihoods).all(),
          f"EM's LL track {re.log_likelihoods}")
    check(q_err <= 1e-3 * batch.k_max, f"the first E-step's q sums miss "
          f"the subset sizes by {q_err} > {1e-3 * batch.k_max}")

    # the same fits at 24 x 24, card against a CPU copy
    out["small_card_vs_cpu"] = small_fits_card_vs_cpu(dev)

    # the checkpointed dense-Θ fit, and a save and a restore
    ck_root = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ck_root, ignore_errors=True)
    ck_root.mkdir(parents=True)
    out["checkpoint"] = checkpointed_fit(init, batch, oneshot, fit_kw,
                                         ck_root / "fit")
    out["save_restore"] = {
        "krk": save_restore_ms(oneshot.state, ck_root / "krk"),
        "em_n10000": save_restore_ms(re.state, ck_root / "em")}
    shutil.rmtree(ck_root)
    print(f"  checkpoint save and restore (ms, host clock): "
          f"{json.dumps(out['save_restore'])}")

    # one sweep of each learner at N = 10^4, n = 1000 (CUDA events), from
    # the raw init as phase 10, and joint Picard's from ``start`` too
    L1, L2 = init.factors
    S1, S2 = start.factors
    a_em = torch.tensor(1e-3, device=dev)

    def em_sweep():
        lam = em.m_step_eigvals(em.e_step(lam0, V0, batch))
        return em.eigvec_ascent(lam, V0, batch, a_em)

    sweeps = {
        "krk_dense_theta": lambda: krk_picard_step(L1, L2, batch, 1.0,
                                                   use_dense_theta=True),
        "krk_per_subset": lambda: krk_picard_step(L1, L2, batch, 1.0),
        "full_picard": lambda: picard_step(L0, batch, 1.0),
        "joint_picard": lambda: joint_picard_step(L1, L2, batch, 1.0, 50),
        "joint_picard_from_start": lambda: joint_picard_step(
            S1, S2, batch, 1.0, 50),
        "em": em_sweep}
    out["sweep_ms"] = {k: cuda_ms(f, reps=3, warmup=1)
                       for k, f in sweeps.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  one sweep at N = 10^4, n = {batch.n} (ms, CUDA events): "
          f"{json.dumps(out['sweep_ms'])}; the phase took "
          f"{out['phase_s']!r} s")
    return out


# ---------------------------------------------------------------------------
# phase 20 helpers: the low-rank family
# ---------------------------------------------------------------------------

# benchmarks/lowrank_dual.py:39-45: N = 65536, r = 32, E|Y| = 8, 16 rows a
# draw, the fit at N = 4096 on 64 subsets for 3 sweeps
LR_N, LR_RANK, LR_TARGET, LR_BATCH = 65536, 32, 8.0, 16
LR_FIT_N, LR_FIT_SUBSETS, LR_FIT_ITERS = 4096, 64, 3
LR_BIG_N, LR_BIG_RANK = 2 ** 20, 128      # the scale check: φ is 512 MB
LR_DRAWS = 3000                           # inclusion frequencies
LR_MARG_ATOL = 0.05
LR_PHASE1_TIE = 1e-6     # a uniform this close to its threshold may flip
LR_PARAM_REL = 1e-3      # fitted V and q, card vs CPU copy, of their max
LR_LL_RTOL = 1e-4


class CarriedDual:
    """A spectral cache that hands out one carried dual spectrum (the
    card's, on the CPU copy), since the two devices' eigh choose other
    signs for W."""

    def __init__(self, spec):
        self.spec = spec

    def spectrum_lowrank(self, V, q):
        return self.spec.phi, self.spec.lams, self.spec.W


def lr_normal(key, shape):
    """Standard normals from a key, built as ``jax.random.normal`` builds
    them: sqrt(2)·erfinv of ``uniform(key, shape, nextafter(-1, 0), 1)``
    (torch's erfinv rounds its own way)."""
    from repro_torch import random as prng
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return math.sqrt(2.0) * torch.erfinv(prng.uniform(key, shape, lo, 1.0))


def lr_model(N: int, r: int, dev, cache):
    """The benchmark's family on the card: V = 0.7·normal(PRNGKey(N)),
    q = |normal(PRNGKey(N + 1))| + 0.3, rescaled to E|Y| = 8."""
    from repro_torch import dpp
    from repro_torch import random as prng
    V = lr_normal(prng.PRNGKey(N, dev), (N, r)) * 0.7
    q = lr_normal(prng.PRNGKey(N + 1, dev), (N,)).abs() + 0.3
    return dpp.LowRank(V, q, device=dev).rescale(LR_TARGET, cache)


def lr_counters() -> dict:
    """Each kernel's wrapper (or module) holding its ``launches`` count."""
    from repro_torch.kernels import greedy_map as gm
    from repro_torch.kernels import kron_matvec as km
    from repro_torch.kernels import partial_trace as pt
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.kernels import threefry as tf
    return {"phase2_select": p2,
            "partial_trace_A": pt.partial_trace_A_cuda,
            "partial_trace_C": pt.partial_trace_C_cuda,
            "greedy_map_update": gm.greedy_map_update_cuda,
            "greedy_map_kdpp": gm.greedy_map_kdpp_cuda,
            "kron_matvec": km.kron_matvec_cuda,
            "threefry2x32": tf.threefry2x32_cuda}


def lr_counted(fn, label: str):
    """Run ``fn`` with every kernel's launch count set to 0 just before
    and read just after, under a fresh tracker: the low-rank path launches
    ``threefry2x32`` alone (its ``kernels.threefry2x32.cuda`` counter
    equal, nothing on the plain twin) and none of the other six.
    Returns (fn's result, the counts)."""
    import repro_torch.obs as obs
    counters = lr_counters()
    for obj in counters.values():
        obj.launches = 0
    tracker = obs.InMemoryTracker()
    with obs.use(tracker):
        out = fn()
        torch.cuda.synchronize()
    n = {k: obj.launches for k, obj in counters.items()}
    check(all(v == 0 for k, v in n.items() if k != "threefry2x32"),
          f"{label}: the low-rank path launched another kernel: {n}")
    c = {e: int(tracker.counter_value(f"kernels.threefry2x32.{e}"))
         for e in ("cuda", "reference")}
    check(c == {"cuda": n["threefry2x32"], "reference": 0},
          f"{label}: threefry2x32 launched {n['threefry2x32']} times, "
          f"counted {c}")
    return out, n


class EighSizes:
    """Records the size of every ``torch.linalg.eigh``/``eigvalsh`` call
    while it is entered."""

    def __enter__(self):
        self.sizes = []
        self._saved = (torch.linalg.eigh, torch.linalg.eigvalsh)

        def wrap(f):
            def g(A, *args, **kw):
                self.sizes.append(int(A.shape[-1]))
                return f(A, *args, **kw)
            return g

        torch.linalg.eigh, torch.linalg.eigvalsh = map(wrap, self._saved)
        return self

    def __exit__(self, *exc):
        torch.linalg.eigh, torch.linalg.eigvalsh = self._saved


def lr_rows_agree(want, got, row_keys, spec_cpu, k: int, label: str,
                  kdpp: bool = False) -> dict:
    """Picks ``got`` (B, k) against ``want`` of the same row keys and the
    same dual spectrum (on the CPU): the uniforms through the plain twin,
    the phase-1 masks equal except where a uniform lies within
    LR_PHASE1_TIE of its threshold (such a row is a different draw and
    not compared; none for the k-DPP), each differing row a float32 tie on
    the exact chain (``first_difference`` on U = φΓ in float64)."""
    from repro_torch import random as prng
    from repro_torch.kernels.phase2_select import (first_difference,
                                                   is_roundoff_tie)
    from repro_torch.lowrank.sample import _gamma
    from repro_torch.sampling.batched import compact_selection
    from repro_torch.sampling.kdpp import _phase1_kdpp_from_uniforms
    want, got = np.asarray(want), np.asarray(got)
    check(want.shape == got.shape, f"{label}: shapes {want.shape} vs "
          f"{got.shape}")
    keys = prng.as_key(row_keys, "cpu")
    u, us = prng.split_uniform(keys, spec_cpu.rank, k, backend="reference")
    ll = spec_cpu.log_eigenvalues()
    if kdpp:
        mask = _phase1_kdpp_from_uniforms(u, ll, k)
        near = np.zeros(len(want), bool)
    else:
        p = torch.sigmoid(ll)
        mask = u < p[None, :]
        near = ((u - p[None, :]).abs() <= LR_PHASE1_TIE).any(dim=1).numpy()
    sel, valid, _ = compact_selection(mask, k)
    Gamma = _gamma(spec_cpu.basis(), sel, valid).double()
    phi = spec_cpu.phi.double()
    ones = torch.ones((1, k), dtype=torch.float64)
    out = {"rows": len(want), "identical": 0, "ties": [], "phase1_near": 0}
    for b in range(len(want)):
        if (want[b] == got[b]).all():
            out["identical"] += 1
            continue
        if near[b]:
            out["phase1_near"] += 1
            continue
        step, kind, value = first_difference(us[b], phi @ Gamma[b], ones,
                                             want[b], got[b])
        check(is_roundoff_tie(kind, value), f"{label}: row {b} differs at "
              f"step {step}: {want[b].tolist()} vs {got[b].tolist()} "
              f"({kind} {value!r}), not a roundoff tie")
        out["ties"].append([b, step, kind, value])
    check(out["phase1_near"] <= len(want) // 10, f"{label}: "
          f"{out['phase1_near']} rows on a phase-1 threshold")
    print(f"  {label}: {json.dumps(out)}")
    return out


def lr_check_rows(picks, N: int, k_max: int, label: str,
                  exact=None) -> None:
    for row in np.asarray(picks):
        real = row[row >= 0]
        check(len(set(real.tolist())) == len(real), f"{label}: a row "
              f"repeats an item: {row.tolist()}")
        check(len(real) <= k_max and ((real >= 0) & (real < N)).all(),
              f"{label}: row out of range or past {k_max}: {row.tolist()}")
        check((row[len(real):] == -1).all(), f"{label}: padding is not a "
              f"-1 tail: {row.tolist()}")
        check(exact is None or len(real) == exact, f"{label}: a row of "
              f"{len(real)} items, not {exact}")


def lr_log_marginal(model, items, cache) -> float:
    """log P(items ⊆ Y) = log det K[items, items], in float64 (a det of
    8 entries near 1e-4 underflows float32's range of care)."""
    K = model.marginal_kernel_submatrix(items, cache).double()
    sign, ld = torch.linalg.slogdet(K)
    check(float(sign) > 0, f"K[S, S] of {items} is not PD")
    return float(ld)


def lr_compare_maps(phi64, pk, pp, label: str) -> dict:
    """Card picks ``pk`` against CPU picks ``pp`` of greedy MAP on the
    same φ, in order: a first difference must be a tie of the exact
    (float64) residual feature masses of the two candidates given the
    common prefix, within GREEDY_TIE_TOL · max ‖φ_i‖², and both sets'
    log det φ_Y φ_Yᵀ then agree to 1e-3 relative."""
    def logdet_of(picks):
        P = phi64[torch.as_tensor(np.asarray(picks, np.int64))]
        sign, ld = torch.linalg.slogdet(P @ P.T)
        check(float(sign) > 0, f"{label}: L_Y of the picks is not PD")
        return float(ld)

    out = {"identical": bool((pk == pp).all()),
           "logdet_card": logdet_of(pk), "logdet_cpu": logdet_of(pp)}
    diff = np.nonzero(pk != pp)[0]
    if diff.size:
        t = int(diff[0])
        P = phi64[torch.as_tensor(np.asarray(pk[:t], np.int64))]
        Q = torch.linalg.qr(P.T).Q if t else torch.zeros((phi64.shape[1], 0),
                                                          dtype=phi64.dtype)
        resid = (phi64 * phi64).sum(1) - ((phi64 @ Q) ** 2).sum(1)
        scale = float((phi64 * phi64).sum(1).max())
        a, b = int(pk[t]), int(pp[t])
        gap = abs(float(resid[a]) - float(resid[b])) / scale
        out.update(first_difference=t, candidates=[a, b], tie_gap=gap)
        check(gap <= GREEDY_TIE_TOL, f"{label}: picks differ at step {t} "
              f"({a} vs {b}) and the exact residual masses differ by "
              f"{gap!r} of max ‖φ_i‖² > {GREEDY_TIE_TOL}: no tie")
        check(abs(out["logdet_card"] - out["logdet_cpu"])
              <= 1e-3 * abs(out["logdet_cpu"]), f"{label}: log det L_Y "
              f"{out['logdet_card']!r} (card) vs {out['logdet_cpu']!r}")
    print(f"  {label}: {json.dumps(out)}")
    return out


def lr_fit_card_vs_cpu(init, batch, cpu_init, label: str, **kw) -> dict:
    """``fit_lowrank`` for LR_FIT_ITERS Armijo sweeps on the card and on a
    CPU copy: LLs within rtol LR_LL_RTOL, V and q within LR_PARAM_REL of
    their max, the same backtracks, the LL never falling by more than
    ``_ASCENT_TOL``."""
    from repro_torch.core import SubsetBatch
    from repro_torch.learning.schedules import _ASCENT_TOL
    from repro_torch.lowrank.learn import fit_lowrank
    card = fit_lowrank(init, batch, iters=LR_FIT_ITERS, **kw)
    cpu_kw = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
              for k, v in kw.items()}
    cpu = fit_lowrank(cpu_init, SubsetBatch(batch.indices.cpu(),
                                            batch.mask.cpu()),
                      iters=LR_FIT_ITERS, device="cpu", **cpu_kw)
    lls, lls_cpu = np.asarray(card.log_likelihoods), \
        np.asarray(cpu.log_likelihoods)
    out = {"lls": lls.tolist(), "lls_cpu": lls_cpu.tolist(),
           "backtracks": int(card.state.sched.backtracks),
           "backtracks_cpu": int(cpu.state.sched.backtracks)}
    check(np.isfinite(lls).all() and (np.diff(lls) >= -_ASCENT_TOL).all(),
          f"{label}: the LL falls: {lls.tolist()}")
    check(np.allclose(lls, lls_cpu, rtol=LR_LL_RTOL, atol=0.0),
          f"{label}: LLs {lls.tolist()} (card) vs {lls_cpu.tolist()} (CPU)")
    check(out["backtracks"] == out["backtracks_cpu"], f"{label}: backtracks "
          f"{out['backtracks']} vs {out['backtracks_cpu']}")
    for name in ("V", "q"):
        a = getattr(card.model, name).cpu()
        b = getattr(cpu.model, name)
        err = float((a - b).abs().max())
        out[f"{name}_err_rel"] = err / float(b.abs().max())
        check(out[f"{name}_err_rel"] <= LR_PARAM_REL, f"{label}: {name} "
              f"{err!r} from the CPU copy's > {LR_PARAM_REL} of its max")
    print(f"  {label}: {json.dumps(out)}")
    return out


def lowrank_path(dev) -> dict:
    """Phase 20: the low-rank family end to end at the benchmark's width
    (N = 65536, r = 32, E|Y| = 8), a scale check at N = 2^20, r = 128, and
    the fits; every operation against a CPU copy, launches counted."""
    from repro_torch import dpp
    from repro_torch import random as prng
    from repro_torch.core import SubsetBatch
    from repro_torch.learning.schedules import _ASCENT_TOL
    from repro_torch.lowrank.learn import _sweep_picard, _empirical_inclusion
    from repro_torch.lowrank.sample import _gamma, phase2_dual
    from repro_torch.obs import InMemoryTracker, use
    from repro_torch.sampling import SamplingService, SpectralCache
    from repro_torch.sampling.batched import compact_selection
    from repro_torch.learning import schedules
    t_phase = time.perf_counter()
    out = {"shapes": {"N": LR_N, "rank": LR_RANK, "E_size": LR_TARGET,
                      "big_N": LR_BIG_N, "big_rank": LR_BIG_RANK}}
    launches = {}
    cache = SpectralCache()
    eigh_tracker = InMemoryTracker(keep_records=True)

    # -- the model, its spectrum: one r x r eigh a (V, q) pair ---------------
    with use(eigh_tracker), EighSizes() as eighs:
        model = lr_model(LR_N, LR_RANK, dev, cache)
        spec = model.spectrum(cache)
    k_max = spec.suggested_k_max()
    spec_cpu = spec.to("cpu")
    cpu = dpp.LowRank(model.V.cpu(), model.q.cpu(), device="cpu")
    cpu_cache = CarriedDual(spec_cpu)
    out["spectrum"] = {"E_size": spec.expected_size(), "k_max": k_max,
                       "lams_max": float(spec.lams.max()),
                       "eigh_sizes": eighs.sizes}
    check(eighs.sizes == [LR_RANK, LR_RANK], f"the model's spectra ran "
          f"eighs of sizes {eighs.sizes}, not one {LR_RANK} x {LR_RANK} for "
          f"each of the raw and the rescaled (V, q)")
    check(abs(spec.expected_size() - LR_TARGET) <= 1e-3,
          f"E|Y| = {spec.expected_size()} after rescale({LR_TARGET})")

    # -- draws ---------------------------------------------------------------
    key = prng.PRNGKey(1, dev)
    with EighSizes() as eighs:
        b16, launches["sample16"] = lr_counted(
            lambda: model.sample(key, LR_BATCH, cache=cache), "sample(16)")
        kd, launches["sample64_k8"] = lr_counted(
            lambda: model.sample(key, 64, k=8, cache=cache), "sample(64, k=8)")
    check(eighs.sizes == [], f"the draws ran eighs of sizes {eighs.sizes}")
    check(launches["sample16"]["threefry2x32"] == 2
          and launches["sample64_k8"]["threefry2x32"] == 2,
          f"a keyed draw launched threefry2x32 {launches}, not 2 a call")
    p16 = np.where(b16.mask.cpu().numpy(), b16.indices.cpu().numpy(), -1)
    pkd = np.where(kd.mask.cpu().numpy(), kd.indices.cpu().numpy(), -1)
    lr_check_rows(p16, LR_N, min(k_max, LR_RANK), "sample(16)")
    lr_check_rows(pkd, LR_N, 8, "sample(64, k=8)", exact=min(8, LR_RANK))
    c16 = cpu.sample(key.cpu(), LR_BATCH, cache=cpu_cache, device="cpu")
    ckd = cpu.sample(key.cpu(), 64, k=8, cache=cpu_cache, device="cpu")
    keys16 = prng.split(key.cpu(), LR_BATCH, backend="reference")
    keys64 = prng.split(key.cpu(), 64, backend="reference")
    out["agree"] = {
        "sample16": lr_rows_agree(
            np.where(c16.mask.numpy(), c16.indices.numpy(), -1), p16,
            keys16, spec_cpu, k_max, "sample(16), card vs CPU copy"),
        "sample64_k8": lr_rows_agree(
            np.where(ckd.mask.numpy(), ckd.indices.numpy(), -1), pkd,
            keys64, spec_cpu, 8, "sample(64, k=8), card vs CPU copy",
            kdpp=True)}
    # 3000 draws: inclusion frequencies against diag K; the first 1000 are
    # the batch of the inference and learning checks below
    draws = [model.sample(k_, 1000, cache=cache)
             for k_ in prng.split(prng.PRNGKey(2, dev), LR_DRAWS // 1000)]
    batch = draws[0]
    freq = torch.zeros(LR_N, dtype=torch.float64, device=dev)
    sizes = []
    for d in draws:
        freq += torch.bincount(d.indices[d.mask].long(),
                               minlength=LR_N).double()
        sizes.append(d.sizes().double())
    freq /= LR_DRAWS
    # diag K from marginal_kernel_submatrix, 2048 items a call
    diag_k = torch.cat([torch.diagonal(model.marginal_kernel_submatrix(
        np.arange(s, min(s + 2048, LR_N)), cache)).double()
        for s in range(0, LR_N, 2048)])
    top = torch.argsort(diag_k, descending=True)[:20]
    marg_err = float((freq - diag_k).abs().max())
    mean_size = float(torch.cat(sizes).mean())
    out["marginals"] = {"draws": LR_DRAWS, "max_abs_err": marg_err,
                        "max_diag_K": float(diag_k.max()),
                        "mean_size": mean_size,
                        "max_size": int(torch.cat(sizes).max())}
    check(marg_err <= LR_MARG_ATOL, f"inclusion frequencies off diag K by "
          f"{marg_err} > {LR_MARG_ATOL}")
    check(abs(mean_size - spec.expected_size()) <= 0.25, f"mean |Y| "
          f"{mean_size} of {LR_DRAWS} draws vs E|Y| {spec.expected_size()}")
    print(f"  low-rank draws: {json.dumps(out['marginals'])}")

    # -- the service ------------------------------------------------------------
    svc = model.service(seed=0, cache=cache)
    rows_svc, launches["svc_sample16"] = lr_counted(lambda: svc.sample(16),
                                                    "svc.sample(16)")
    rows_kd, launches["svc_sample_kdpp8_16"] = lr_counted(
        lambda: svc.sample_kdpp(8, 16), "svc.sample_kdpp(8, 16)")
    cpu_svc = SamplingService(cpu, cache=cpu_cache, seed=0, device="cpu")
    pad = lambda rows, k: np.array([r + [-1] * (k - len(r)) for r in rows])
    k0, sub = prng.split(prng.PRNGKey(0, "cpu"), backend="reference")
    k0, sub_kd = prng.split(k0, backend="reference")
    out["agree"]["svc_sample16"] = lr_rows_agree(
        pad(cpu_svc.sample(16), svc.k_max), pad(rows_svc, svc.k_max),
        prng.split(sub, 16, backend="reference"), spec_cpu, svc.k_max,
        "svc.sample(16), card vs CPU copy")
    out["agree"]["svc_sample_kdpp"] = lr_rows_agree(
        pad(cpu_svc.sample_kdpp(8, 16), 8), pad(rows_kd, 8),
        prng.split(sub_kd, 16, backend="reference"), spec_cpu, 8,
        "svc.sample_kdpp(8, 16), card vs CPU copy", kdpp=True)
    lr_check_rows(pad(rows_kd, 8), LR_N, 8, "svc.sample_kdpp", exact=8)
    ring = prng.split(prng.PRNGKey(3, dev), 512)
    (one, _, _), launches["draw_keyed_512"] = lr_counted(
        lambda: svc.draw_keyed(ring), "draw_keyed, one chunk")
    svc64 = model.service(seed=0, cache=cache, max_batch=64)
    (chunked, _, _), launches["draw_keyed_512_by_64"] = lr_counted(
        lambda: svc64.draw_keyed(ring), "draw_keyed, chunks of 64")
    check(launches["svc_sample16"]["threefry2x32"] == 3
          and launches["svc_sample_kdpp8_16"]["threefry2x32"] == 3,
          f"a service call launched threefry2x32 {launches}, not 3")
    check(launches["draw_keyed_512"]["threefry2x32"] == 1
          and launches["draw_keyed_512_by_64"]["threefry2x32"] == 8,
          f"draw_keyed launched threefry2x32 {launches}, not 1 / 8")
    out["agree"]["draw_keyed_chunkings"] = lr_rows_agree(
        pad(one, svc.k_max), pad(chunked, svc.k_max), ring.cpu(), spec_cpu,
        svc.k_max, "draw_keyed, one chunk vs chunks of 64")
    out["service_stats"] = svc.stats()

    # -- inference -----------------------------------------------------------
    b_cpu = SubsetBatch(batch.indices.cpu(), batch.mask.cpu())
    lp, launches["log_prob"] = lr_counted(
        lambda: model.log_prob(batch, cache), "log_prob")
    lp = lp.cpu().double().numpy()
    lp_cpu = cpu.log_prob(b_cpu, cpu_cache).double().numpy()
    lp_err = np.abs(lp - lp_cpu) / np.maximum(1.0, np.abs(lp_cpu))
    out["log_prob"] = {"n": batch.n, "k_max": batch.k_max,
                       "max_rel_err": float(lp_err.max()),
                       "min": float(lp.min()), "max": float(lp.max())}
    check(np.isfinite(lp).all() and float(lp_err.max()) <= LOGP_RTOL,
          f"log_prob, card vs CPU copy: {out['log_prob']}")
    items = top[:20].cpu().numpy()
    m20 = float(model.marginal(items, cache))
    ks20 = model.marginal_kernel_submatrix(items, cache).cpu()
    ks20_cpu = cpu.marginal_kernel_submatrix(items, cpu_cache)
    out["marginal20"] = {"value": m20, "log_value": lr_log_marginal(
        model, items, cache), "K_err": float((ks20 - ks20_cpu).abs().max())}
    check(out["marginal20"]["K_err"] <= K_SUB_ATOL, f"K[S, S] of 20 items, "
          f"card vs CPU copy: {out['marginal20']}")
    A = [int(i) for i in items[:5]]
    Bs = [int(i) for i in items[5:8]]
    with EighSizes() as eighs:
        cond, launches["condition"] = lr_counted(lambda: model.condition(A),
                                                  "condition")
        check(type(cond) is dpp.LowRank and cond.N == LR_N - 5
              and cond.rank == LR_RANK, f"condition returned {cond!r}")
        comp = np.setdiff1d(np.arange(LR_N), A)
        B_c = np.searchsorted(comp, Bs)
        lhs = lr_log_marginal(model, A + Bs, cache) - \
            lr_log_marginal(model, A, cache)
        rhs = lr_log_marginal(cond, B_c, cache)
    check(eighs.sizes == [LR_RANK], f"conditioning ran eighs of sizes "
          f"{eighs.sizes}, not one {LR_RANK} x {LR_RANK}")
    cond_cpu = cpu.condition(A)
    v_err = float((cond.V.cpu() - cond_cpu.V).abs().max()) / float(
        model._phi().abs().max())
    out["condition"] = {"A": A, "B": Bs, "lhs": lhs, "rhs": rhs,
                        "V_err_rel": v_err}
    check(abs(lhs - rhs) <= COND_ID_RTOL * max(1.0, abs(rhs)),
          f"log P(A ∪ B) - log P(A) = {lhs!r} vs log P(B | A) = {rhs!r}")
    check(v_err <= 1e-4, f"conditioned V, card vs CPU copy: {v_err}")

    # -- MAP ---------------------------------------------------------------
    pk, launches["map20"] = lr_counted(lambda: model.map(20), "map(20)")
    pk = pk.cpu().numpy()
    pp = cpu.map(20).numpy()
    out["map20"] = lr_compare_maps(cpu._phi().double(), pk, pp,
                                   "map(20), card vs CPU copy (float64)")
    lr_check_rows(pk[None], LR_N, 20, "map(20)", exact=20)

    # -- learning ------------------------------------------------------------
    init = dpp.LowRank(lr_normal(prng.PRNGKey(5, dev), (LR_N, LR_RANK))
                       * 0.5, device=dev)
    rep, launches["fit_n65536"] = lr_counted(
        lambda: init.fit(batch, iters=LR_FIT_ITERS), "fit at N = 65536")
    lls = np.asarray(rep.log_likelihoods)
    check(type(rep.model) is dpp.LowRank and np.isfinite(lls).all()
          and (np.diff(lls) >= -_ASCENT_TOL).all(),
          f"the fit at N = 65536 does not ascend: {lls.tolist()}")
    check(launches["fit_n65536"]["threefry2x32"] == LR_FIT_ITERS,
          f"the fit's key stream launched threefry2x32 "
          f"{launches['fit_n65536']}, not once a sweep")
    out["fit_n65536"] = {"lls": lls.tolist(),
                         "backtracks": int(rep.state.sched.backtracks),
                         "sweep_times_s": rep.sweep_times}
    small_cache = SpectralCache()
    small = lr_model(LR_FIT_N, LR_RANK, dev, small_cache)
    data = small.sample(prng.PRNGKey(6, dev), LR_FIT_SUBSETS,
                        cache=small_cache)
    init_s = dpp.LowRank(lr_normal(prng.PRNGKey(7, dev),
                                   (LR_FIT_N, LR_RANK)) * 0.5, device=dev)
    init_cpu = dpp.LowRank(init_s.V.cpu(), device="cpu")
    out["fit_n4096"] = lr_fit_card_vs_cpu(init_s, data, init_cpu,
                                          "fit at N = 4096, card vs CPU")
    X = lr_normal(prng.PRNGKey(8, dev), (LR_FIT_N, 8))
    out["fit_n4096_features"] = lr_fit_card_vs_cpu(
        init_s, data, init_cpu, "fit_lowrank(item_features=) at N = 4096",
        item_features=X)

    # -- times (CUDA events around the call) -------------------------------
    phi_read_ms = LR_N * LR_RANK * 4 / HBM_BYTES_S * 1e3
    times = {"bound_phi_read_a_step_ms": phi_read_ms}
    times["sample16_ms"] = cuda_ms(
        lambda: model.sample(key, LR_BATCH, cache=cache), reps=10, warmup=2)
    rk = prng.split(key, LR_BATCH)
    u, us = prng.split_uniform(rk, LR_RANK, k_max)
    mask = u < torch.sigmoid(spec.log_eigenvalues())[None, :]
    sel, valid, _ = compact_selection(mask, k_max)
    Gam = _gamma(spec.basis(), sel, valid)
    k_eff = torch.clamp_max(mask.sum(-1), k_max).to(torch.int32)
    times["sample16_phase2_ms"] = cuda_ms(
        lambda: phase2_dual(us, spec.phi, Gam, k_eff), reps=10, warmup=2)
    times["sample16_phase2_per_step_ms"] = times["sample16_phase2_ms"] / k_max
    times["sample16_bound_ms"] = k_max * phi_read_ms
    times["k_max"] = k_max
    times["sample64_k8_ms"] = cuda_ms(
        lambda: model.sample(key, 64, k=8, cache=cache), reps=5, warmup=1)
    times["sample64_k8_bound_ms"] = 8 * phi_read_ms
    times["svc_sample16_ms"] = cuda_ms(lambda: svc.sample(16), reps=10,
                                       warmup=2)
    times["log_prob1000_ms"] = cuda_ms(lambda: model.log_prob(batch, cache),
                                       reps=10, warmup=2)
    times["condition5_ms"] = cuda_ms(lambda: model.condition(A), reps=10,
                                     warmup=2)
    times["condition5_bound_ms"] = 2 * phi_read_ms
    times["map20_ms"] = cuda_ms(lambda: model.map(20), reps=3, warmup=1)
    times["map20_bound_ms"] = 20 * 2 * phi_read_ms   # float64 φ, a read a step
    p_hat = _empirical_inclusion(
        SubsetBatch(batch.indices.long(), batch.mask), LR_N).float()
    sched = schedules.armijo()
    a0 = torch.tensor(sched.a0, device=dev)
    idx_l = batch.indices.long()
    times["sweep_n65536_ms"] = cuda_ms(
        lambda: _sweep_picard(init.V, init.q, idx_l, batch.mask, p_hat, a0,
                              sched, True, 0.1), reps=3, warmup=1)

    # -- the scale check: N = 2^20, r = 128, φ resident ---------------------
    big_cache = SpectralCache()
    with EighSizes() as eighs:
        big = lr_model(LR_BIG_N, LR_BIG_RANK, dev, big_cache)
        big_spec = big.spectrum(big_cache)
    check(eighs.sizes == [LR_BIG_RANK] * 2, f"the N = 2^20 model ran eighs "
          f"of sizes {eighs.sizes}")
    k_big = big_spec.suggested_k_max()
    key_big = prng.PRNGKey(9, dev)
    big.sample(key_big, LR_BATCH, cache=big_cache)            # warm
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bb, launches["sample16_n2p20"] = lr_counted(
        lambda: big.sample(key_big, LR_BATCH, cache=big_cache),
        "sample(16) at N = 2^20")
    peak = torch.cuda.max_memory_allocated() - before
    check(launches["sample16_n2p20"]["threefry2x32"] == 2,
          f"sample(16) at N = 2^20 launched {launches['sample16_n2p20']}")
    limit = LR_BATCH * LR_BIG_N * k_big * 4
    pb = np.where(bb.mask.cpu().numpy(), bb.indices.cpu().numpy(), -1)
    lr_check_rows(pb, LR_BIG_N, k_big, "sample(16) at N = 2^20")
    out["scale_n2p20"] = {"k_max": k_big, "peak_above_before_bytes": peak,
                          "bound_B_N_kmax_4_bytes": limit,
                          "phi_bytes": LR_BIG_N * LR_BIG_RANK * 4,
                          "allocated_before_bytes": before,
                          "mean_size": float(bb.sizes().double().mean())}
    check(peak < limit, f"sample(16) at N = 2^20 peaked {peak} bytes above "
          f"the {before} allocated before it, not below B·N·k_max·4 = "
          f"{limit}: the (B, N, k_max) transient formed")
    print(f"  N = 2^20 scale check: {json.dumps(out['scale_n2p20'])}")
    big_phi_ms = LR_BIG_N * LR_BIG_RANK * 4 / HBM_BYTES_S * 1e3
    times["sample16_n2p20_ms"] = cuda_ms(
        lambda: big.sample(key_big, LR_BATCH, cache=big_cache), reps=5,
        warmup=1)
    u, us = prng.split_uniform(prng.split(key_big, LR_BATCH), LR_BIG_RANK,
                               k_big)
    mask = u < torch.sigmoid(big_spec.log_eigenvalues())[None, :]
    sel, valid, _ = compact_selection(mask, k_big)
    Gam = _gamma(big_spec.basis(), sel, valid)
    k_eff = torch.clamp_max(mask.sum(-1), k_big).to(torch.int32)
    times["sample16_n2p20_phase2_ms"] = cuda_ms(
        lambda: phase2_dual(us, big_spec.phi, Gam, k_eff), reps=5, warmup=1)
    times["sample16_n2p20_phase2_per_step_ms"] = \
        times["sample16_n2p20_phase2_ms"] / k_big
    times["sample16_n2p20_bound_ms"] = k_big * big_phi_ms
    times["k_max_n2p20"] = k_big
    del big, big_spec, bb, big_cache, Gam, u, us
    torch.cuda.empty_cache()

    # every eigh the phase's caches ran was r x r, one a (V, q) pair
    recs = [r for r in eigh_tracker.records
            if r["name"] == "spectral_cache.eigh_s"]
    check(len(recs) == 2 and all(r["tags"]["n"] == LR_RANK for r in recs),
          f"spectral_cache.eigh_s records {recs}")
    out["cache"] = {"main": cache.stats(), "misses_tagged_n": [
        r["tags"]["n"] for r in recs]}
    check(cache.stats()["misses"] == 3, f"the main cache missed "
          f"{cache.stats()}: not once each for the raw, the rescaled and the "
          f"conditioned (V, q)")
    out["launches"] = launches
    out["times"] = times
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  low-rank times (ms, CUDA events): {json.dumps(times)}; the "
          f"phase took {out['phase_s']!r} s")
    return out


# ---------------------------------------------------------------------------
# phase 21 helpers: the async serving tier
# ---------------------------------------------------------------------------

# benchmarks/serving_load.py:39-48: four tenants, 1-4 samples a request,
# open-loop Poisson arrivals seeded 1000 + the tenant's index, a 25 ms
# deadline, flushes of up to 64 rows; (offered requests/s, requests)
SV_TENANTS = {"t0": 2, "t1": 1, "t2": 1, "t3": 1}
SV_DEADLINE_MS, SV_MAX_BATCH = 25.0, 64
SV_SAMPLE_LO, SV_SAMPLE_HI = 1, 4
SV_LOADS = ((100.0, 240), (400.0, 600), (800.0, 800))
SV_FLEET, SV_FLEET_REQUESTS = 3, 16   # LowRank tenants over phase 20's V
# Mixtral-8x7B's attention (src/repro/configs/mixtral_8x7b.py): 8 KV heads
# of dimension 4096 / 32 = 128; two streams' 1024-token caches cut to 256
# positions, 64 of them the recency window
KV_HEADS, KV_HEAD_DIM, KV_S, KV_BUDGET, KV_RECENCY = 8, 128, 1024, 256, 64
KV_VALID = (1024, 960)                # the two streams' valid lengths
SV_SEED = 0
SvTicket = collections.namedtuple("SvTicket", "tenant seq num_samples")
SPAN_OPS = {"service.request": None, "queue-wait": "service.request",
            "coalesce": "service.request", "device-call": "service.request",
            "scatter": "service.request"}


def sv_counted(fn, label: str, expect):
    """Run ``fn`` with every kernel's launch count set to 0 just before and
    read just after: each kernel of ``expect`` launched, no other one.
    Returns (fn's result, the counts)."""
    counters = lr_counters()
    for obj in counters.values():
        obj.launches = 0
    out = fn()
    torch.cuda.synchronize()
    n = {k: obj.launches for k, obj in counters.items()}
    for k, v in n.items():
        check((v > 0) == (k in expect), f"{label}: {k} launched {v} times; "
              f"the path launches {sorted(expect)}")
    return out, n


def map_counted(fn, label: str, launches: int):
    """``sv_counted`` of a greedy-MAP path under a fresh tracker: the fused
    kernel launched ``launches`` times and nothing else (no step-kernel
    launch), ``kernels.greedy_map_update.cuda`` counted once a launch and
    ``kernels.greedy_map_update.reference`` never. Returns (fn's result,
    the counts)."""
    import repro_torch.obs as obs
    tracker = obs.InMemoryTracker()
    with obs.use(tracker):
        out, n = sv_counted(fn, label, {"greedy_map_kdpp"})
    c = {e: int(tracker.counter_value(f"kernels.greedy_map_update.{e}"))
         for e in ("cuda", "reference")}
    check(n["greedy_map_kdpp"] == launches and c == {"cuda": launches,
                                                     "reference": 0},
          f"{label}: the fused kernel launched {n['greedy_map_kdpp']} "
          f"times, not {launches}; counters {c}")
    return out, {**n, "counters": c}


def sv_drive_load(model, rps: float, n_requests: int, dev,
                  deadline_ms: float = SV_DEADLINE_MS, tracker=None,
                  record=None):
    """``benchmarks/serving_load.py``'s ``_drive_load`` on the port: four
    tenant threads submit open-loop at Poisson arrivals against one
    ``AsyncSamplingService`` on the card. ``record``: a dict that gets the
    row keys and rows of the tier's first device call. Returns (the load's
    row, the tier, its tickets by (tenant, seq))."""
    import threading
    from repro_torch.serving import AsyncSamplingService, ServingConfig
    svc = AsyncSamplingService(
        model, ServingConfig(max_batch=SV_MAX_BATCH, deadline_ms=deadline_ms,
                             max_queue_depth=8192),
        tenants=SV_TENANTS, seed=SV_SEED, tracker=tracker, device=dev)
    if record is not None:
        draw = svc.service.draw_keyed

        def recording(row_keys):
            out = draw(row_keys)
            if not record:
                record.update(keys=row_keys.clone(), rows=out[0])
            return out

        svc.service.draw_keyed = recording
    names = list(SV_TENANTS)
    per_tenant = n_requests // len(names)
    rate = rps / len(names)
    tickets = []
    tlock = threading.Lock()
    start = time.perf_counter() + 0.05   # common epoch for all tenants

    def tenant_thread(idx: int, name: str):
        rng = np.random.default_rng(1000 + idx)
        offsets = np.cumsum(rng.exponential(1.0 / rate, per_tenant))
        sizes = rng.integers(SV_SAMPLE_LO, SV_SAMPLE_HI + 1, per_tenant)
        mine = []
        for off, n in zip(offsets, sizes):
            delay = start + off - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            mine.append(svc.submit(int(n), tenant=name))
        with tlock:
            tickets.extend(mine)

    threads = [threading.Thread(target=tenant_thread, args=(i, nm))
               for i, nm in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for t in tickets:
        t.result(timeout=120.0)
    duration = time.perf_counter() - start
    svc.close()
    sm, vm = svc._metrics, svc.service._metrics
    requested = sm.counter_value("serving.requested_rows")
    drawn = max(1.0, vm.counter_value("service.samples_drawn"))
    calls = max(1.0, vm.counter_value("service.device_calls"))
    dev_p99_s = vm.percentile("service.device_call_s", 99)
    p99_ms = svc.stats.p99_latency_s * 1e3
    row = {"offered_rps": rps, "deadline_ms": deadline_ms,
           "requests": len(tickets), "rows": int(requested),
           "duration_s": duration, "samples_per_s": requested / duration,
           "rows_per_call": requested / calls,
           "occupancy": requested / drawn,
           "p50_ms": svc.stats.p50_latency_s * 1e3, "p99_ms": p99_ms,
           "device_call_p50_ms":
               vm.percentile("service.device_call_s", 50) * 1e3,
           "device_call_p99_ms": dev_p99_s * 1e3,
           "p99_bound_ms": deadline_ms + dev_p99_s * 1e3,
           "p99_within_bound": bool(p99_ms <= deadline_ms + dev_p99_s * 1e3),
           "flushes": svc.stats.flushes, "device_calls": int(calls),
           "deadline_fires": svc.stats.deadline_fires,
           "batch_fires": svc.stats.batch_fires,
           "drain_fires": svc.stats.drain_fires,
           "failed_flushes": svc.stats.failed_flushes,
           "rejected": svc.stats.rejected,
           "truncation_rate": vm.counter_value("service.truncations")
           / drawn, "health": svc.service.stats.health}
    return row, svc, {(t.tenant, t.seq): t for t in tickets}


def sv_replay_serial(svc, tickets, dev) -> int:
    """Every served row against ``svc.service.draw_keyed`` of its own key,
    one row a call, bit for bit. Returns the rows replayed."""
    from repro_torch.serving import TenantKeyring
    ring = TenantKeyring(SV_SEED, device=dev)
    n = 0
    for (tenant, seq), t in sorted(tickets.items()):
        keys = ring.row_keys([t], t.num_samples)
        for j, row in enumerate(t.result()):
            again = svc.service.draw_keyed(keys[j:j + 1])[0][0]
            check(again == row, f"{tenant} seq {seq} row {j}: served "
                  f"{row}, drawn alone {again}")
            n += 1
    return n


def sv_rows_vs_plain(spec, k_max: int, row_keys, rows, label: str,
                     cpu: bool) -> dict:
    """Rows drawn on the card from ``row_keys`` against the plain phase 2
    of the same phase-1 inputs (the keys' uniforms through the plain twin,
    phase 1 on the card): on the CPU when ``cpu``, else on the card; under
    phase 3's rule (``compare_picks``)."""
    from repro_torch.kernels.phase2_select import phase2_select_plain
    u, us = plain_row_uniforms(row_keys, spec.N, k_max)
    us_m, ke_m, G1_m, Gr_m = phase1_of(spec, k_max, u, us)
    if cpu:
        us_m, ke_m, G1_m, Gr_m = (x.cpu() for x in (us_m, ke_m, G1_m, Gr_m))
    pp = phase2_select_plain(us_m, ke_m, G1_m, Gr_m).cpu().numpy()
    pk = np.full(pp.shape, -1, dtype=np.int32)
    for b, r in enumerate(rows):
        pk[b, :len(r)] = r
    return compare_picks(pk, pp, us_m, ke_m, G1_m, Gr_m, label)


def sv_check_spans(run_log: Path, tickets) -> dict:
    """Each ticket's trace in the Chrome trace exported from ``run_log``:
    ``service.request`` over ``queue-wait``, ``coalesce``, ``device-call``
    and ``scatter``, every span tagged with the ticket's tenant."""
    from repro_torch.obs.export import ChromeTraceExporter
    trace = ChromeTraceExporter().export(str(run_log),
                                         str(run_log.with_suffix(".json")))
    by_trace = collections.defaultdict(list)
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X":
            by_trace[ev["args"]["trace"]].append(ev)
    for t in tickets.values():
        evs = by_trace.get(t.trace_id, [])
        names = {e["args"]["span"]: e["name"] for e in evs}
        tree = {e["name"]: (names.get(e["args"]["parent"])
                            if e["args"]["parent"] else None) for e in evs}
        check(tree == SPAN_OPS and len(evs) == len(SPAN_OPS),
              f"ticket {t.tenant} {t.seq}: span tree {tree}")
        check(all(e["args"].get("tenant") == t.tenant for e in evs),
              f"ticket {t.tenant} {t.seq}: spans not all tagged tenant "
              f"{t.tenant}")
    return {"events": len(trace["traceEvents"]), "traces": len(by_trace),
            "tickets": len(tickets)}


def sv_lowrank_fleet(dev) -> dict:
    """(d): three ``LowRank`` tenants over phase 20's V (N = 65536, r = 32),
    each q from a seeded key, rescaled to E|Y| = 8 (on a scratch cache),
    served through ``tenant_models=`` on one shared cache: three misses,
    every eigh r x r; every row against a serial ``draw_keyed`` on the card
    and against a CPU copy on the carried dual spectrum, identical or a
    proven tie (``lr_rows_agree``)."""
    from repro_torch import dpp
    from repro_torch import random as prng
    from repro_torch.obs import InMemoryTracker, use
    from repro_torch.sampling import SamplingService, SpectralCache
    from repro_torch.serving import (AsyncSamplingService, ServingConfig,
                                     TenantKeyring)
    V = lr_normal(prng.PRNGKey(LR_N, dev), (LR_N, LR_RANK)) * 0.7
    scratch = SpectralCache()
    models = {}
    for i in range(SV_FLEET):
        q = lr_normal(prng.PRNGKey(LR_N + 10 + i, dev), (LR_N,)).abs() + 0.3
        models[f"q{i}"] = dpp.LowRank(V, q, device=dev).rescale(LR_TARGET,
                                                                scratch)
    check(all(m.V is V for m in models.values()), "the fleet's V is not "
          "one tensor")
    cache = SpectralCache()
    eigh_tracker = InMemoryTracker(keep_records=True)

    def serve():
        svc = AsyncSamplingService(
            config=ServingConfig(max_batch=SV_MAX_BATCH,
                                 deadline_ms=SV_DEADLINE_MS),
            tenant_models=models, seed=SV_SEED, cache=cache, device=dev)
        rng = np.random.default_rng(SV_SEED)
        tickets = [svc.submit(int(rng.integers(SV_SAMPLE_LO,
                                               SV_SAMPLE_HI + 1)), tenant=t)
                   for _ in range(SV_FLEET_REQUESTS) for t in models]
        for t in tickets:
            t.result(timeout=120.0)
        svc.close()
        return svc, tickets

    with use(eigh_tracker), EighSizes() as eighs:
        (svc, tickets), launches = sv_counted(serve, "LowRank fleet",
                                              {"threefry2x32"})
    misses = [r["tags"]["n"] for r in eigh_tracker.records
              if r["name"] == "spectral_cache.eigh_s"]
    out = {"tenants": SV_FLEET, "requests": len(tickets),
           "cache": cache.stats(), "eigh_sizes": eighs.sizes,
           "misses_tagged_n": misses, "launches": launches,
           "stats": svc.stats(), "agree": {}}
    check(cache.stats()["misses"] == SV_FLEET and misses == [LR_RANK] * 3
          and eighs.sizes == [LR_RANK] * SV_FLEET, f"the fleet's "
          f"spectra: {out['cache']}, eigh sizes {eighs.sizes}, eigh_s "
          f"tags {misses}, not {SV_FLEET} of {LR_RANK} x {LR_RANK}")
    check(svc.stats.failed_flushes == 0 and svc.stats.rejected == 0,
          f"the fleet's flushes: {svc.stats()}")
    ring = TenantKeyring(SV_SEED, device=dev)
    pad = lambda rows, k: np.array([r + [-1] * (k - len(r)) for r in rows])
    for name, model in models.items():
        engine = svc._services[name]
        mine = [t for t in tickets if t.tenant == name]
        keys = torch.cat([ring.row_keys([t], t.num_samples) for t in mine])
        rows = [r for t in mine for r in t.result()]
        k = engine.k_max
        serial = [engine.draw_keyed(keys[j:j + 1])[0][0]
                  for j in range(len(rows))]
        spec_cpu = engine.spectrum.to("cpu")
        cpu = SamplingService(dpp.LowRank(model.V.cpu(), model.q.cpu(),
                                          device="cpu"),
                              k_max=k, cache=CarriedDual(spec_cpu),
                              device="cpu")
        want = cpu.draw_keyed(keys.cpu())[0]
        lr_check_rows(pad(rows, k), LR_N, k, f"fleet {name}")
        out["agree"][name] = {
            "serial": lr_rows_agree(pad(serial, k), pad(rows, k),
                                    keys.cpu(), spec_cpu, k,
                                    f"fleet {name}, served vs serial"),
            "cpu": lr_rows_agree(pad(want, k), pad(rows, k), keys.cpu(),
                                 spec_cpu, k,
                                 f"fleet {name}, card vs CPU copy")}
    return out


def kv_head_replay(keys, recency: int, vl: int, row_key, served,
                   label: str):
    """One KV head's k-DPP selection replayed on the keys' card: its kernel
    (``token_kernel``) and the card's eigh, the plain twin's uniforms of
    its row key, phase 1, then ``phase2_select``'s kernel, whose picks must
    be among the ``served`` positions (budget of them). Returns phase 2's
    inputs (us, k_eff, G1, Gr), its picks, the head's kernel and its
    eigenvalues."""
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.sampling.batched import (compact_selection,
                                              gather_factor_columns)
    from repro_torch.sampling.kdpp import _phase1_kdpp_from_uniforms
    from repro_torch.sampling.spectral import FactorSpectrum
    from repro_torch.serve.kv_compaction import token_kernel
    k = len(served) - recency
    Ls = token_kernel(keys, recency, vl, "sample")[0]
    lam, vec = torch.linalg.eigh(Ls)
    spec = FactorSpectrum((torch.clamp_min(lam, 0.0),), (vec,))
    u, us = plain_row_uniforms(torch.as_tensor(row_key).to(keys.device)[None],
                               keys.shape[0], k)
    mask = _phase1_kdpp_from_uniforms(u, spec.log_eigenvalues(), k)
    sel, valid, _ = compact_selection(mask, k)
    G1, Gr = (G.contiguous() for G in p2.canonical_pair(
        gather_factor_columns(spec.vecs, spec.sizes, sel, valid)))
    ke = mask.sum(dim=-1).to(torch.int32)
    us = us.contiguous()
    raw = p2.phase2_select_cuda(us, ke, G1, Gr)
    check(set(raw[raw >= 0].tolist()) <= set(served.tolist()),
          f"{label}: the replayed draw is not among the served picks")
    return (us, ke, G1, Gr), raw, Ls, lam


def sv_kv(dev) -> dict:
    """(e): two streams' Mixtral-width caches through ``KVCompactionClient``
    in one flush, checked, drawn apart, held against the plain phase 2 on
    a CPU copy; one head's greedy-MAP selection; the global route's time
    on a head."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.sampling.kdpp import _phase1_kdpp_from_uniforms
    from repro_torch.serve.kv_compaction import (dpp_select_tokens,
                                                 token_kernel)
    from repro_torch.serving import KVCompactionClient, ServingConfig
    k = KV_BUDGET - KV_RECENCY
    caches = np.random.default_rng(SV_SEED).standard_normal(
        (2, KV_HEADS, KV_S, KV_HEAD_DIM), dtype=np.float32)
    submits = [(f"s{i}", caches[i], KV_VALID[i]) for i in range(2)]

    def run(subs):
        client = KVCompactionClient(
            KV_BUDGET, KV_RECENCY, ServingConfig(max_batch=4096,
                                                 deadline_ms=200.0),
            seed=SV_SEED, device=dev)
        tickets = [client.submit(c, valid_len=v, tenant=t)
                   for t, c, v in subs]
        picks = [t.result(timeout=120.0) for t in tickets]
        client.close()
        return picks, client

    (together, client), launches = sv_counted(
        lambda: run(submits), "KV client", {"phase2_select", "threefry2x32"})
    m = client._metrics
    out = {"shapes": {"heads": KV_HEADS, "head_dim": KV_HEAD_DIM, "S": KV_S,
                      "budget": KV_BUDGET, "recency": KV_RECENCY,
                      "valid": KV_VALID},
           "launches": launches,
           "device_calls": int(m.counter_value("serving.device_calls")),
           "heads_selected": int(m.counter_value("serving.heads_selected")),
           "flush_ms": [x * 1e3 for x in m.observations["serving.flush_s"]],
           "device_call_ms": [x * 1e3 for x in
                              m.observations["serving.device_call_s"]]}
    check(out["device_calls"] == 1 and out["heads_selected"] == 2 * KV_HEADS
          and launches["phase2_select"] == 2 * KV_HEADS,
          f"the KV flush: {out}, not one call of {2 * KV_HEADS} heads and "
          f"one phase-2 launch a head")
    for (t, _, vl), picks in zip(submits, together):
        check(picks.is_cuda and picks.dtype == torch.int32
              and tuple(picks.shape) == (KV_HEADS, KV_BUDGET),
              f"stream {t}: picks {picks.dtype} {tuple(picks.shape)} on "
              f"{picks.device}")
        for h, row in enumerate(picks.cpu().numpy()):
            check(bool((np.diff(row) > 0).all()) and row[0] >= 0
                  and row[-1] < vl, f"stream {t} head {h}: picks not "
                  f"sorted, distinct and within {vl}: {row.tolist()}")
            check(set(range(vl - KV_RECENCY, vl)) <= set(row.tolist()),
                  f"stream {t} head {h}: the recency window is not kept")
    # drawn apart: a client a stream, one flush each
    apart = [run([s])[0][0] for s in submits]
    for (t, _, _), picks, alone in zip(submits, together, apart):
        check(torch.equal(picks, alone), f"stream {t}: heads drawn "
              f"together differ from heads drawn apart")
    out["together_equals_apart"] = True
    rkeys = client._keyring.row_keys(
        [SvTicket(t, 0, KV_HEADS) for t, _, _ in submits], 2 * KV_HEADS)
    # the phase-2 picks of every head against the plain phase 2 on a CPU
    # copy of its inputs (the card's eigh, the plain twin's uniforms)
    ins, pk, Ls_all, lams = [], [], [], []
    for i, (t, c, vl) in enumerate(submits):
        for h in range(KV_HEADS):
            inputs, raw, Ls, lam = kv_head_replay(
                torch.from_numpy(c[h]).to(dev), KV_RECENCY, vl,
                rkeys[i * KV_HEADS + h], together[i][h],
                f"stream {t} head {h}")
            ins.append(inputs)
            pk.append(raw)
            Ls_all.append(Ls)
            lams.append(lam)
    route = p2.phase2_select_route(KV_S, 1, k)
    check(route == "cluster", f"a KV head's phase 2 takes route {route}")
    us_c, ke_c, G1_c, Gr_c = (torch.cat([x[j] for x in ins]).cpu()
                              for j in range(4))
    pp = p2.phase2_select_plain(us_c, ke_c, G1_c, Gr_c).numpy()
    out["heads_vs_cpu_plain"] = compare_picks(
        torch.cat(pk).cpu().numpy(), pp, us_c, ke_c, G1_c, Gr_c,
        "KV heads, kernel vs the plain phase 2 on a CPU copy")
    out["route"] = route
    # is a batched eigh of the 16 heads bitwise each head's own?
    lam_b = torch.linalg.eigh(torch.stack(Ls_all))[0]
    lam_1 = torch.stack(lams)
    out["batched_eigh_eigenvalues_bitwise"] = bool(torch.equal(lam_b, lam_1))
    out["batched_eigh_max_abs_diff"] = float((lam_b - lam_1).abs().max())
    # where a head's time goes (CUDA events around the call)
    head0 = torch.from_numpy(caches[0][0]).to(dev)
    u0, _ = plain_row_uniforms(rkeys[0][None], KV_S, k)
    ll0 = torch.log(torch.clamp_min(lams[0], 0.0))
    out["head_ms"] = {
        "select_tokens": cuda_ms(lambda: dpp_select_tokens(
            head0, KV_BUDGET, KV_RECENCY, valid_len=KV_VALID[0],
            method="sample", key=rkeys[0]), reps=3, warmup=1),
        "kernel_and_eigh": cuda_ms(lambda: torch.linalg.eigh(token_kernel(
            head0, KV_RECENCY, KV_VALID[0], "sample")[0]), reps=3,
            warmup=1),
        "esp_phase1": cuda_ms(lambda: _phase1_kdpp_from_uniforms(
            u0, ll0, k), reps=3, warmup=1)}
    # one head by greedy MAP: one launch of the fused kernel (no step
    # launch, no plain dispatch), the greedy order against the plain
    # update on a CPU copy (phase 13's rule)
    head = torch.from_numpy(caches[0][0]).to(dev)
    mp, out["map_launches"] = map_counted(
        lambda: dpp_select_tokens(head, KV_BUDGET, KV_RECENCY,
                                  valid_len=KV_VALID[0], method="map"),
        "KV map", 1)
    Lm = token_kernel(head, KV_RECENCY, KV_VALID[0], "map")[0]
    order_k = ops.greedy_map_kdpp(Lm, k).cpu().numpy()
    order_p = ops.greedy_map_kdpp(Lm.cpu(), k).numpy()
    recent = set(range(KV_VALID[0] - KV_RECENCY, KV_VALID[0]))
    check(sorted(set(order_k.tolist()) | recent) == mp.cpu().tolist(),
          "the KV map's picks are not its greedy order and the recency "
          "window")
    out["map_vs_cpu"] = compare_maps(Lm, order_k, order_p,
                                     "KV map head, card vs CPU copy")
    # the cluster route's time on a head's inputs, the global route's
    # beside it (device times later)
    us1, ke1, G11, Gr1 = ins[0]
    picks1 = p2.phase2_select_cuda(us1, ke1, G11, Gr1).cpu().numpy()
    b_ms, b_by = bound(picks1, KV_S, 1, k)
    more, extra = cluster_row(us1, ke1, G11, Gr1, picks1, "a KV head")
    out["phase2_times"] = kernel_times(
        partial(p2.phase2_select_cuda, us1, ke1, G11, Gr1),
        partial(p2.phase2_select_plain, us1, ke1, G11, Gr1), None,
        reps=5, plain_reps=2, expect="phase2_select_kernel_cluster",
        sole=True, extra=extra, **more,
        kernel_route=route, bound_ms=b_ms, bound_by=b_by,
        bound_row_ms=bound_row(picks1, KV_S, 1, k),
        max_row_steps=int((picks1 >= 0).sum(axis=1).max()),
        shapes={"N1": KV_S, "Nr": 1, "k_max": k, "B": 1})
    shown = {x: y for x, y in out.items()
             if x not in ("heads_vs_cpu_plain", "map_vs_cpu")}
    print(f"  KV client: {json.dumps(shown)}")
    return out


def serving_path(main, dev) -> dict:
    """Phase 21: the async serving tier at full width (see the module
    docstring). Returns what the ``serving`` line and the ``kernels`` rows
    print."""
    from repro_torch.obs import JsonlTracker
    from repro_torch.obs.export import read_run_log
    from repro_torch.obs.report import render
    from repro_torch.serving import (AsyncSamplingService, CancelledRequest,
                                     QueueFull, ServiceClosed, ServingConfig,
                                     TenantKeyring)
    import io
    t_phase = time.perf_counter()
    out = {"loads": [], "launches": {}}
    # warm every power-of-two batch the round-up can give (the kernels'
    # libraries, cuSOLVER and the allocator), through a throwaway tier
    warm = AsyncSamplingService(main, ServingConfig(
        max_batch=SV_MAX_BATCH, deadline_ms=1.0), seed=99, device=dev)
    b = 1
    while b <= SV_MAX_BATCH:
        warm.submit(b, tenant="warmup").result(timeout=300.0)
        b *= 2
    warm.close()

    # -- (a) + (b): the loads, their rows ---------------------------------
    ring = TenantKeyring(SV_SEED, device=dev)
    first = {}
    served = {}
    parts = collections.defaultdict(float)     # seconds by step
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        parts[name] += now - mark
        mark = now

    for i, (rps, n) in enumerate(SV_LOADS):
        (row, svc, tickets), launches = sv_counted(
            lambda: sv_drive_load(main, rps, n, dev,
                                  record=first if i == 0 else None),
            f"serving at {rps} req/s", {"phase2_select", "threefry2x32"})
        label = f"load_{int(rps)}"
        out["launches"][label] = launches
        calls = svc.service.stats.device_calls
        tf_want = 2 + len(SV_TENANTS) + 2 * svc.stats.flushes + calls
        check(row["failed_flushes"] == 0 and row["rejected"] == 0,
              f"{label}: {row}")
        check(launches["phase2_select"] == calls, f"{label}: phase 2 "
              f"launched {launches['phase2_select']} times for {calls} "
              f"device calls")
        check(launches["threefry2x32"] == tf_want, f"{label}: threefry2x32 "
              f"launched {launches['threefry2x32']} times, not the keyring's "
              f"2 + {len(SV_TENANTS)} + 2 a flush and 1 a device call = "
              f"{tf_want}")
        lap("loads")
        row["serial_rows_equal"] = sv_replay_serial(svc, tickets, dev)
        lap("serial_replay")
        order = sorted(tickets)
        keys = torch.cat([ring.row_keys([tickets[k_]],
                                        tickets[k_].num_samples)
                          for k_ in order])
        rows = [r for k_ in order for r in tickets[k_].result()]
        row["vs_cpu_plain"] = sv_rows_vs_plain(
            svc.service.spectrum, svc.service.k_max, keys, rows,
            f"{label}'s {len(rows)} rows vs the plain phase 2 on a CPU "
            f"copy", cpu=True)
        lap("cpu_plain")
        print(f"  serving {label}: {json.dumps(row)}")
        out["loads"].append(row)
        served[label] = (svc, tickets)
    svc0, tickets0 = served["load_100"]
    check(bool(first), "the first device call was not recorded")
    out["first_flush_vs_plain"] = sv_rows_vs_plain(
        svc0.service.spectrum, svc0.service.k_max, first["keys"],
        first["rows"], f"the first flush's {len(first['rows'])} rows vs "
        f"the plain phase 2 (card)", cpu=False)

    # -- (c): determinism across timing ---------------------------------------
    rps0, n0 = SV_LOADS[0]
    (row1, _, tickets1), out["launches"]["load_100_deadline_1ms"] = \
        sv_counted(lambda: sv_drive_load(main, rps0, n0, dev,
                                         deadline_ms=1.0),
                   "serving at deadline 1 ms",
                   {"phase2_select", "threefry2x32"})
    check(tickets1.keys() == tickets0.keys() and all(
        tickets1[k_].result() == tickets0[k_].result() for k_ in tickets0),
        "the same (tenant, seq) drew other rows at deadline 1 ms")
    out["deadline_1ms"] = {"row": row1, "same_rows": len(tickets0),
                           "flushes": [row1["flushes"],
                                       out["loads"][0]["flushes"]]}
    print(f"  deadline 1 ms vs 25 ms: {len(tickets0)} requests, the same "
          f"rows; flushes {row1['flushes']} vs {out['loads'][0]['flushes']}")
    lap("deadline_1ms")

    # -- (d): a LowRank fleet ---------------------------------------------------
    out["lowrank_fleet"] = sv_lowrank_fleet(dev)
    lap("lowrank_fleet")

    # -- (e): the KV client --------------------------------------------------
    out["kv"] = sv_kv(dev)
    lap("kv")

    # -- (f): observability -----------------------------------------------------
    log_dir = ROOT / "build" / "serving_obs"
    log_dir.mkdir(parents=True, exist_ok=True)
    run_log = log_dir / "run_log.jsonl"
    run_log.unlink(missing_ok=True)
    jt = JsonlTracker(str(run_log))
    try:
        (row_f, _, tickets_f), out["launches"]["load_100_traced"] = \
            sv_counted(lambda: sv_drive_load(main, rps0, n0, dev,
                                             tracker=jt),
                       "serving, traced", {"phase2_select", "threefry2x32"})
    finally:
        jt.close()
    check(all(tickets_f[k_].result() == tickets0[k_].result()
              for k_ in tickets0), "the traced rerun drew other rows")
    out["obs"] = sv_check_spans(run_log, tickets_f)
    text = io.StringIO()
    render(read_run_log(str(run_log)), traces=1, top=6, out=text)
    report = text.getvalue()
    check("serving.admitted" in report and "service.request" in report,
          f"the report of the traced run: {report[:400]}")
    out["obs"].update(traced_row=row_f, report_lines=len(
        report.splitlines()))
    print("  report of the traced run (first lines):")
    for line in report.splitlines()[:14]:
        print(f"    {line}")

    # -- (g): shutdown and admission ---------------------------------------------
    svc = AsyncSamplingService(main, ServingConfig(
        max_batch=4096, deadline_ms=60_000.0, max_queue_depth=2),
        seed=SV_SEED, device=dev)
    queued = [svc.submit(1, tenant="t"), svc.submit(2, tenant="t")]
    try:
        svc.submit(1, tenant="t")
        fail("a submit past max_queue_depth was admitted")
    except QueueFull as e:
        check(e.depth == 2 and e.limit == 2, f"QueueFull {e.depth}/{e.limit}")
    svc.close(drain=False)
    for t in queued:
        try:
            t.result(timeout=10.0)
            fail("close(drain=False) resolved a queued ticket")
        except CancelledRequest:
            pass
    try:
        svc.submit(1, tenant="late")
        fail("a submit after close was admitted")
    except ServiceClosed:
        pass
    out["admission"] = dict(svc.stats(), queue_full=True,
                            service_closed=True)
    # rejected counts the QueueFull and the submit after close
    check(svc.stats.cancelled == 2 and svc.stats.rejected == 2
          and svc.per_tenant()["t"]["rejected"] == 1
          and svc.stats.flushes == 0, f"admission: {svc.stats()}")
    lap("obs_and_admission")
    out["phase_s"] = time.perf_counter() - t_phase
    out["phase_parts_s"] = dict(parts)
    print(f"  serving phase took {out['phase_s']!r} s: "
          f"{json.dumps(out['phase_parts_s'])}")
    return out


# ---------------------------------------------------------------------------
# phase 22 helpers: placement
# ---------------------------------------------------------------------------

PL_SHARDS = 4              # Mesh(axes={"data": 4}, devices=[card] * 4)
PL_DRAWS = (("sample64", 64, None), ("sample13", 13, None),
            ("sample24_k20", 24, 20))
PL_FIT_TOL = 2e-5          # tests/test_runtime.py, Mesh vs Local: constant
PL_ARMIJO_LL_ATOL = 2e-4   # ... and Armijo LLs (rtol PL_FIT_TOL)
PL_REPLAY_TOL = 1e-4       # the stochastic sweeps against the host replay
PL_ITERS, PL_MINIBATCH = 3, 200
PL_TICKETS = 60


def pl_close(a, b, rtol: float, atol: float) -> float:
    """The largest |a - b| - (atol + rtol·|b|) over the entries (<= 0:
    within ``np.testing.assert_allclose``'s rule)."""
    a, b = (np.asarray(torch.as_tensor(x).detach().cpu(), np.float64)
            for x in (a, b))
    return float((np.abs(a - b) - (atol + rtol * np.abs(b))).max())


def pl_counted(fn, label: str):
    """Run ``fn`` with the phase-2 and ``threefry2x32`` launch counts set
    to 0 just before and read just after, under a fresh tracker (which
    also gets the ``runtime.mesh.*`` counters); each launch counted once by
    its ``kernels.*.cuda`` counter, phase 2 never on its plain version.
    Returns (fn's result, the counts, the tracker); ``threefry2x32_host``
    is the PRNG twin's plain calls, which must be none."""
    import repro_torch.obs as obs
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.kernels import threefry as tf
    p2.launches = 0
    tf.threefry2x32_cuda.launches = 0
    tracker = obs.InMemoryTracker()
    with obs.use(tracker):
        out = fn()
        torch.cuda.synchronize()
    n = {"phase2_select": p2.launches,
         "threefry2x32": tf.threefry2x32_cuda.launches}
    for op, k in n.items():
        c = int(tracker.counter_value(f"kernels.{op}.cuda"))
        check(c == k, f"{label}: {op} launched {k} times, counted {c}")
    check(tracker.counter_value("kernels.phase2_select.reference") == 0,
          f"{label}: phase 2 ran its plain version")
    n["threefry2x32_host"] = int(
        tracker.counter_value("kernels.threefry2x32.reference"))
    check(n["threefry2x32_host"] == 0, f"{label}: the PRNG twin ran its "
          f"plain version {n['threefry2x32_host']} times")
    return out, n, tracker


def pl_mesh_counters(tracker) -> dict:
    return {k.split(".")[-1]: int(v) for k, v in tracker.counters.items()
            if k.startswith("runtime.mesh.")}


def placement_path(main, batch, init, rep, dev, devices=None) -> dict:
    """Phase 22: placement on the card — a ``Mesh`` of four shards on the
    one card (``devices``, default ``[dev] * 4``; ``tools/placement_cards.py``
    passes four cards) against ``Local`` for draws, both services, the
    learner, ``Host`` and a low-rank draw, and a checkpoint restored with
    ``shardings=``. Returns what the ``placement`` line prints."""
    from repro_torch import dpp
    from repro_torch import random as prng
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core import distributed, krk_picard_step
    from repro_torch.core.dpp import SubsetBatch
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.kernels import threefry as tf
    from repro_torch.learning import LearnerState, LearningEngine, schedules
    from repro_torch.sampling import SpectralCache
    from repro_torch.serving import ServingConfig, TenantKeyring
    t_phase = time.perf_counter()
    devices = tuple(devices or (dev,) * PL_SHARDS)
    rt = dpp.Mesh(axes={"data": PL_SHARDS}, devices=devices)
    check(rt.data_devices == devices, f"{rt!r} placed its shards on "
          f"{rt.data_devices}, not {devices}")
    out = {"mesh": repr(rt), "devices": [str(d) for d in devices],
           "launches": {}}
    launches = out["launches"]
    cache = SpectralCache()
    spec = main.spectrum(cache)
    k_max = spec.suggested_k_max()
    route = p2.phase2_select_route(*spec.sizes, k_max)
    check(route == "on_chip", f"phase 2 takes route {route} at "
          f"{spec.sizes}, k_max {k_max}")

    # -- (a) draws: Mesh == Local bit for bit ------------------------------
    draws = {}
    for i, (label, n, k) in enumerate(PL_DRAWS):
        key = prng.PRNGKey(40 + i, dev)
        loc, n_l, _ = pl_counted(lambda: main.sample(
            key, n, k, dpp.Local(), cache=cache, device=dev),
            f"{label} Local")
        msh, n_m, t_m = pl_counted(lambda: main.sample(
            key, n, k, rt, cache=cache, device=dev), f"{label} Mesh")
        same = (torch.equal(loc.indices, msh.indices)
                and torch.equal(loc.mask, msh.mask)
                and (k is not None or torch.equal(loc.truncated,
                                                  msh.truncated)))
        check(same, f"{label}: the Mesh's draw differs from Local's")
        check(n_l["phase2_select"] == 1
              and n_m["phase2_select"] == PL_SHARDS,
              f"{label}: phase 2 launched {n_l} (Local), {n_m} (Mesh), "
              f"not 1 and {PL_SHARDS}")
        mc = pl_mesh_counters(t_m)
        pad = (-n) % PL_SHARDS
        check(mc.get("map_keys_calls") == 1 and mc.get("keys") == n
              and mc.get("pad_rows") == pad and
              t_m.gauges.get("runtime.mesh.data_shards") == PL_SHARDS,
              f"{label}: runtime.mesh counters {mc}")
        draws[label] = {"rows": n, "bitwise": True, "local": n_l,
                        "mesh": n_m, "mesh_counters": mc,
                        "truncated": (None if k is not None
                                      else int(msh.truncated.sum()))}
        launches[label] = n_m
    again = main.sample(prng.PRNGKey(40, dev), 64, runtime=rt, cache=cache,
                        device=dev)
    first = main.sample(prng.PRNGKey(40, dev), 64, cache=cache, device=dev)
    check(len(rt._mapped_cache) == 2 and torch.equal(again.indices,
                                                     first.indices),
          f"the mapped cache holds {list(rt._mapped_cache)} after a repeat")
    out["mapped_cache_entries"] = len(rt._mapped_cache)
    dflt = dpp.Mesh()
    got, n_d, _ = pl_counted(lambda: main.sample(
        prng.PRNGKey(43, dev), 64, runtime=dflt, cache=cache, device=dev),
        "Mesh() default")
    check(dflt.num_data_shards == torch.cuda.device_count()
          and torch.equal(got.indices, main.sample(
              prng.PRNGKey(43, dev), 64, cache=cache, device=dev).indices)
          and n_d["phase2_select"] == dflt.num_data_shards,
          f"Mesh() took {dflt.num_data_shards} shards, launches {n_d}")
    draws["default_mesh"] = {"shards": dflt.num_data_shards, **n_d}
    out["draws"] = draws
    print(f"  placement draws: {json.dumps(draws)}")

    # -- (b) services: the sync service and the async tier -----------------
    svc_l = main.service(seed=7, k_max=3, cache=cache, device=dev)
    svc_m = main.service(seed=7, k_max=3, cache=cache, runtime=rt,
                         device=dev)
    rows_l, n_l, t_l = pl_counted(lambda: svc_l.sample(20), "service Local")
    rows_m, n_m, t_m = pl_counted(lambda: svc_m.sample(20), "service Mesh")
    svc_keys = sorted(k for k in t_l.counters if k.startswith("service."))
    check(rows_l == rows_m and svc_l.stats == svc_m.stats
          and svc_m.stats.truncations > 0
          and svc_keys == sorted(k for k in t_m.counters
                                 if k.startswith("service."))
          and all(t_l.counters[k] == t_m.counters[k] for k in svc_keys),
          f"the Mesh service differs: {svc_m.stats} vs {svc_l.stats}")
    check(n_m["phase2_select"] == PL_SHARDS * svc_m.stats.device_calls,
          f"the Mesh service launched phase 2 {n_m}")
    out["service"] = {"stats": svc_m.stats(), "local": n_l, "mesh": n_m}
    launches["service"] = n_m

    def serve():
        tier = main.serving(
            ServingConfig(max_batch=SV_MAX_BATCH, deadline_ms=SV_DEADLINE_MS),
            tenants=SV_TENANTS, seed=SV_SEED, cache=cache, runtime=rt,
            device=dev)
        rng = np.random.default_rng(SV_SEED)
        names = list(SV_TENANTS)
        try:
            tickets = [tier.submit(int(rng.integers(SV_SAMPLE_LO,
                                                    SV_SAMPLE_HI + 1)),
                                   tenant=names[i % len(names)])
                       for i in range(PL_TICKETS)]
            for t in tickets:
                t.result(timeout=120.0)
        finally:
            tier.close()
        return tier, tickets

    (tier, tickets), n_s, t_s = pl_counted(serve, "async tier on the Mesh")
    calls = tier.service.stats.device_calls
    check(n_s["phase2_select"] == PL_SHARDS * calls
          and tier.stats.failed_flushes == 0 and tier.stats.rejected == 0,
          f"the tier on the Mesh: {calls} device calls, launches {n_s}, "
          f"{tier.stats.failed_flushes} failed flushes")
    alone = main.service(seed=SV_SEED, cache=cache, device=dev)
    ring = TenantKeyring(SV_SEED, device=dev)
    replayed = 0
    for t in tickets:
        keys = ring.row_keys([t], t.num_samples)
        for j, row in enumerate(t.result()):
            again = alone.draw_keyed(keys[j:j + 1])[0][0]
            check(again == row, f"{t.tenant} seq {t.seq} row {j}: served "
                  f"{row}, drawn alone (Local) {again}")
            replayed += 1
    out["serving"] = {"tickets": len(tickets), "rows": replayed,
                      "device_calls": calls, "flushes": tier.stats.flushes,
                      "launches": n_s,
                      "mesh_counters": pl_mesh_counters(t_s)}
    launches["serving"] = n_s
    print(f"  placement services: {json.dumps(out['service'])}; async "
          f"tier {json.dumps(out['serving'])}")

    # -- (c) learning: the sharded sweep against Local ----------------------
    b4 = rt.even_batch(batch)
    check(b4.n == batch.n, f"the batch of {batch.n} does not divide "
          f"{PL_SHARDS} shards")
    fits = {}
    rl = init.fit(b4, iters=PL_ITERS, a=1.0, device=dev)
    rm, n_f, _ = pl_counted(lambda: init.fit(b4, iters=PL_ITERS, a=1.0,
                                             runtime=rt, device=dev),
                            "constant-step fit on the Mesh")
    fits["constant"] = {
        "factor_excess": [pl_close(a, b, PL_FIT_TOL, PL_FIT_TOL) for a, b
                          in zip(rm.model.factors, rl.model.factors)],
        "ll_excess": pl_close(rm.log_likelihoods, rl.log_likelihoods,
                              PL_FIT_TOL, PL_FIT_TOL),
        "lls_mesh": rm.log_likelihoods, "lls_local": rl.log_likelihoods,
        "launches": n_f}
    check(max(fits["constant"]["factor_excess"]) <= 0
          and fits["constant"]["ll_excess"] <= 0
          and rm.ll_sweeps == rl.ll_sweeps, f"constant-step fit, Mesh vs "
          f"Local past rtol = atol = {PL_FIT_TOL}: {fits['constant']}")
    sched = schedules.armijo(a0=64.0, max_backtracks=12)
    al = init.fit(b4, iters=PL_ITERS, schedule=sched, device=dev)
    am = init.fit(b4, iters=PL_ITERS, schedule=sched, runtime=rt, device=dev)
    fits["armijo"] = {
        "a": [float(am.state.sched.a), float(al.state.sched.a)],
        "backtracks": [int(am.state.sched.backtracks),
                       int(al.state.sched.backtracks)],
        "ll_excess": pl_close(am.log_likelihoods, al.log_likelihoods,
                              PL_FIT_TOL, PL_ARMIJO_LL_ATOL),
        "lls_mesh": am.log_likelihoods, "lls_local": al.log_likelihoods}
    check(fits["armijo"]["a"][0] == fits["armijo"]["a"][1]
          and fits["armijo"]["backtracks"][0]
          == fits["armijo"]["backtracks"][1] > 0
          and fits["armijo"]["ll_excess"] <= 0,
          f"Armijo fit, Mesh vs Local: {fits['armijo']}")
    # the stochastic sweeps: record each sweep's per-shard selection, and
    # replay it on the host's chain of keys
    recorded = []
    select = distributed.shard_select_no_replace

    def recording(keys, n, m):
        sel = select(keys, n, m)
        recorded.append(sel.clone())
        return sel

    distributed.shard_select_no_replace = recording
    try:
        rs, n_st, _ = pl_counted(lambda: init.fit(
            b4, algorithm="krk-stochastic", iters=PL_ITERS,
            minibatch_size=PL_MINIBATCH, seed=2, runtime=rt, device=dev),
            "krk-stochastic on the Mesh")
    finally:
        distributed.shard_select_no_replace = select
    n_local, mb_local = b4.n // PL_SHARDS, PL_MINIBATCH // PL_SHARDS
    # the replay runs the chain on the host, in the twin's plain version:
    # the kernel's select mode (in the fit) held against it
    key = prng.PRNGKey(2, "cpu")
    L1, L2 = init.factors
    for sweep, sel in enumerate(recorded):
        key, k_sel = prng.split(key, backend="reference")
        rows = []
        for s in range(PL_SHARDS):
            want = select(prng.fold_in(k_sel, s, backend="reference"),
                          n_local, mb_local, backend="reference")
            check(torch.equal(sel[s].cpu(), want), f"sweep {sweep} "
                  f"shard {s}: rows {sel[s].tolist()} vs the host replay "
                  f"{want.tolist()}")
            rows.append(s * n_local + want.long())
        rows = torch.cat(rows).to(dev)
        L1, L2 = krk_picard_step(L1, L2, SubsetBatch(b4.indices[rows],
                                                     b4.mask[rows]), 1.0)
    fits["stochastic"] = {
        "sweeps_recorded": len(recorded), "rows_per_shard": mb_local,
        "factor_excess": [pl_close(a, b, PL_REPLAY_TOL, PL_REPLAY_TOL)
                          for a, b in zip(rs.model.factors, (L1, L2))],
        "launches": n_st}
    check(len(recorded) == PL_ITERS
          and max(fits["stochastic"]["factor_excess"]) <= 0
          and n_st["threefry2x32"] == 3 * PL_ITERS,
          f"krk-stochastic on the Mesh against its Local replay (a sweep "
          f"launches split, fold_in and select once): "
          f"{fits['stochastic']}")
    # the select mode alone, at the sweep's shape and at 8 x 5000 of 300:
    # kernel against the plain version on the card, bit for bit, and the
    # times of the kernel, the plain version on the card and on the host
    sel_ms = {}
    for R, n, m in ((PL_SHARDS, n_local, mb_local), (8, 5000, 300)):
        skeys = prng.split(prng.PRNGKey(R + m, dev), R)
        got = select(skeys, n, m)
        want = tf.threefry2x32_plain(skeys, n, "select", n2=m)
        check(torch.equal(got, want) and torch.equal(
            got.cpu(), tf.threefry2x32_plain(skeys.cpu(), n, "select",
                                             n2=m)),
              f"select {R} x {m} of {n}: the kernel differs from its "
              f"plain version")
        hk = skeys.cpu()
        t0 = time.perf_counter()
        for _ in range(3):
            tf.threefry2x32_plain(hk, n, "select", n2=m)
        sel_ms[f"{R}x{m}_of_{n}"] = {
            "kernel": cuda_ms(lambda: tf.threefry2x32_cuda(
                skeys, n, "select", n2=m), reps=20, warmup=2),
            "plain_card": cuda_ms(lambda: tf.threefry2x32_plain(
                skeys, n, "select", n2=m), reps=3, warmup=1),
            "plain_host": (time.perf_counter() - t0) / 3 * 1e3}
    fits["select_ms"] = sel_ms
    # one sweep's time: the sharded sweep against the engine's, CUDA events
    L1, L2 = init.factors
    a1 = torch.ones((), device=dev)
    k1 = prng.PRNGKey(3, dev)
    mesh_sweep = distributed.make_distributed_krk_sweep(
        rt, schedules.constant(1.0))
    shards = rt.shard_batch(b4)
    local_engine = LearningEngine()
    fits["sweep_ms"] = {
        "local": cuda_ms(lambda: local_engine._krk_sweep((L1, L2), b4, a1),
                         reps=5, warmup=1),
        "mesh": cuda_ms(lambda: mesh_sweep(L1, L2, shards, k1, a1),
                        reps=5, warmup=1),
        "local_again": cuda_ms(lambda: local_engine._krk_sweep(
            (L1, L2), b4, a1), reps=5, warmup=0)}
    out["learning"] = fits
    launches["krk_stochastic"] = n_st
    print(f"  placement learning: {json.dumps(fits)}")

    # -- (d) Host: the numpy oracle, card model against a CPU copy ---------
    cpu_main = dpp.Kron(tuple(f.cpu() for f in main.factors), device="cpu")
    hb, n_h, _ = pl_counted(lambda: main.sample(
        prng.PRNGKey(5, dev), 4, runtime=dpp.Host(), device=dev), "Host")
    hc = cpu_main.sample(prng.PRNGKey(5, "cpu"), 4, runtime=dpp.Host(),
                         device="cpu")
    check(hb.indices.is_cuda and hb.to_lists() == hc.to_lists()
          and n_h["phase2_select"] == 0, f"Host draws: card "
          f"{hb.to_lists()} vs CPU copy {hc.to_lists()}, launches {n_h}")
    out["host"] = {"rows": hb.to_lists(), "launches": n_h}

    # -- (e) low rank: phase 20's V on the Mesh ----------------------------
    lcache = SpectralCache()
    lr = lr_model(LR_N, LR_RANK, dev, lcache)
    lspec = lr.spectrum(lcache)
    lkey = prng.PRNGKey(21, dev)
    lw, n_lw, _ = pl_counted(lambda: lr.sample(lkey, 64, cache=lcache,
                                               device=dev), "LowRank Local")
    lg, n_lg, _ = pl_counted(lambda: lr.sample(lkey, 64, runtime=rt,
                                               cache=lcache, device=dev),
                             "LowRank Mesh")
    lk = lspec.suggested_k_max()
    agree = lr_rows_agree(
        np.where(lw.mask.cpu().numpy(), lw.indices.cpu().numpy(), -1),
        np.where(lg.mask.cpu().numpy(), lg.indices.cpu().numpy(), -1),
        prng.split(lkey.cpu(), 64, backend="reference"), lspec.to("cpu"),
        lk, "LowRank sample(64), Mesh vs Local")
    check(n_lg["phase2_select"] == 0 and n_lg["threefry2x32"]
          == 1 + PL_SHARDS, f"LowRank on the Mesh launched {n_lg}")
    out["lowrank"] = {"agree": agree, "local": n_lw, "mesh": n_lg}

    # -- (f) checkpoints: restore(shardings=) -------------------------------
    ck = ROOT / "build" / "chip_smoke_placement_checkpoint"
    shutil.rmtree(ck, ignore_errors=True)
    mgr = CheckpointManager(CheckpointConfig(str(ck), async_save=False))
    state = rep.state
    mgr.save(int(state.sweep), state, blocking=True)
    target = LearnerState.tree_unflatten(
        [x.cpu() if isinstance(x, torch.Tensor) else x
         for x in state.tree_flatten()], state, device="cpu")
    back = mgr.restore(target=target, shardings=dev)
    leaves = back.tree_flatten()
    on_card = all(t.device == dev for t in (*back.params, back.sweep,
                                            back.key, back.sched.a,
                                            back.ll))
    equal = all(np.array_equal(np.asarray(torch.as_tensor(a).cpu()),
                               np.asarray(torch.as_tensor(b).cpu()))
                for a, b in zip(leaves, state.tree_flatten()))
    check(on_card and equal, f"restore(shardings={dev}): on the card "
          f"{on_card}, equal to the saved state {equal}")
    shutil.rmtree(ck)
    out["checkpoint"] = {"leaves": len(leaves), "on_card": on_card,
                         "equal": equal}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"placement (phase 22): {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 23 helpers: LM serving
# ---------------------------------------------------------------------------

# src/repro/configs/qwen2_0_5b.py at full width: 24 layers, d_model 896, 14
# query heads and 2 KV heads of 64, d_ff 4864, vocab 151936 (152064 padded),
# QKV bias, tied embeddings; weights from init_params(PRNGKey(0)). Two
# seeded prompts of 512 tokens, 32 new tokens, inline compaction to 128
# slots with the 8 most recent kept (k = 120 diverse tokens a head).
LM_ARCH = "qwen2-0.5b"
LM_SEED = 0
LM_BATCH, LM_PROMPT, LM_NEW = 2, 512, 32
LM_BUDGET, LM_RECENCY = 128, 8
LM_CPU_LAYERS = 2          # the CPU copy's depth (float32 card vs CPU)
LM_DECODE_STEPS = 4        # decode steps held against the CPU copy
LM_DVF_TOKENS = 64         # decode against forward: the prompts' first 64
LM_F32_TOL = 1e-4          # card vs CPU copy, of max(1, max |CPU|)
LM_DVF_TOL = 1e-3          # decode vs forward (float32), of max |forward|
LM_BF16_TOL = 0.05         # bfloat16 vs float32 logits, of max |float32|
LM_REPLAY = ((0, 0, 0), (5, 1, 0), (11, 0, 1), (23, 1, 1))  # (unit, b, h)
LM_TENANTS = ("s0", "s1")


def lm_rel(got, want) -> float:
    """max |got - want| over max(1, max |want|), in float32 on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(1.0,
                                                 float(want.abs().max()))


def lm_params_slice(params, n_units: int, dev):
    """The first ``n_units`` units (and cross-attention layers) of an LM
    parameter tree, on ``dev``."""
    from repro_torch.models.transformer import tree_map
    return {k: tree_map(lambda a: (a[:n_units] if k in ("blocks", "cross")
                                   else a).to(dev), v)
            for k, v in params.items()}


def lm_capture(engine) -> list:
    """Record every ``engine.compact_kv`` call of a run as (tenant, state
    before, state after): the main path's own compaction, checked after
    the run."""
    seen, inner = [], engine.compact_kv

    def compact_kv(state, *args, **kw):
        out = inner(state, *args, **kw)
        seen.append((kw.get("tenant", "default"), state, out))
        return out
    engine.compact_kv = compact_kv
    return seen


def lm_kept_positions(before, after, label: str, budget: int = LM_BUDGET,
                      recency: int = LM_RECENCY) -> np.ndarray:
    """The positions (U, B, KV, budget) of the prefill cache ``before``
    whose rows the compacted cache ``after`` holds, k and v alike, found
    by matching each head's rows bit for bit (they are distinct: rope
    differs by position); every head sorted, distinct, below pos and with
    the recency window kept."""
    cb, ca = (s.caches["head"]["layer0"] for s in (before, after))
    kb, vb, ka, va = (x.cpu().view(torch.int16).numpy()
                      for x in (cb.k, cb.v, ca.k, ca.v))
    pos = cb.pos.cpu().numpy()
    check(ka.shape[2] == budget and torch.equal(ca.pos.cpu(),
                                                   cb.pos.cpu()),
          f"{label}: compacted cache {ka.shape}, pos {ca.pos.tolist()}")
    U, B, _, KV, _ = kb.shape
    out = np.zeros((U, B, KV, budget), np.int64)
    for u, b, h in np.ndindex(U, B, KV):
        rows = {r.tobytes(): i for i, r in enumerate(kb[u, b, :, h])}
        check(len(rows) == kb.shape[2], f"{label}: unit {u} b {b} h {h} "
              f"holds equal key rows")
        got = [rows.get(r.tobytes(), -1) for r in ka[u, b, :, h]]
        vl = int(pos[u])
        check(min(got) >= 0 and got == sorted(set(got)) and got[-1] < vl
              and set(range(vl - recency, vl)) <= set(got),
              f"{label}: unit {u} b {b} h {h} keeps {got}: not sorted, "
              f"distinct, below {vl} with the recency window")
        check(np.array_equal(va[u, b, :, h], vb[u, b, got, h]),
              f"{label}: unit {u} b {b} h {h}: v rows not gathered with k")
        out[u, b, h] = got
    return out


def lm_sample_head_keys(seed: int, n_units: int, B: int, KV: int):
    """The inline "sample" compaction's head keys (U, B, KV, 2) of a new
    engine of ``seed`` with greedy decoding, through the plain twin: one
    split of the engine key, one a unit, then ``split(sub, (B, KV))``."""
    from repro_torch import random as prng
    key = prng.split(prng.PRNGKey(seed, "cpu"), backend="reference")[1]
    out = []
    for _ in range(n_units):
        key, sub = prng.split(key, backend="reference")
        out.append(prng.split(sub, (B, KV), backend="reference"))
    return torch.stack(out)


def lm_generate(engine, prompts, label: str, expect, **kw):
    """One ``generate`` of the main path, every kernel's launch count set
    to 0 just before and read just after (``sv_counted``). Returns (the
    result, the counts, the compactions it made)."""
    seen = lm_capture(engine)
    out, n = sv_counted(lambda: engine.generate(prompts, LM_NEW, **kw),
                        label, expect)
    tok = out["tokens"]
    check(tok.shape == (LM_BATCH, LM_NEW) and (tok >= 0).all()
          and (tok < engine.lm.cfg.vocab).all(), f"{label}: tokens "
          f"{tok.shape}, range [{tok.min()}, {tok.max()}]")
    return out, n, seen


def lm_clients(engine, streams: dict, dev):
    """Two decode streams in threads through one ``KVCompactionClient``
    (as ``launch.serve --tenants``). Returns ({tenant: result}, client)."""
    import threading
    from repro_torch.serving import KVCompactionClient, ServingConfig
    client = KVCompactionClient(
        LM_BUDGET, LM_RECENCY, ServingConfig(max_batch=4096,
                                             deadline_ms=50.0),
        tenants={t: 1 for t in streams}, seed=LM_SEED, device=dev)
    results, errors = {}, {}

    def stream(name):
        try:
            results[name] = engine.generate(streams[name], LM_NEW,
                                            kv_client=client,
                                            kv_tenant=name)
        except Exception as e:            # raised after the join
            errors[name] = e
    threads = [threading.Thread(target=stream, args=(t,)) for t in streams]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        check(not th.is_alive(), "a client stream did not finish")
    client.close()
    for name, e in errors.items():
        raise RuntimeError(f"client stream {name} failed") from e
    return results, client


@torch.inference_mode()
def lm_serve_path(dev) -> dict:
    """Phase 23: qwen2-0.5b at full width through the port's LM stack and
    ``ServeEngine`` (see the module docstring). Returns what the
    ``lm_serve`` line prints and the ``kernels`` rows take."""
    import dataclasses
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.models import LM
    from repro_torch.sampling.kdpp import _phase1_kdpp_from_uniforms
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.kv_compaction import (dpp_select_tokens,
                                                 token_kernel)
    import repro_torch.obs as obs
    from repro_torch.kernels import greedy_map as gm
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lm, lm32 = LM(cfg, device=dev), LM(cfg32, device=dev)
    U, KV, k = cfg.n_layers, cfg.n_kv_heads, LM_BUDGET - LM_RECENCY
    heads = U * LM_BATCH * KV
    out = {"arch": LM_ARCH, "shapes": {
        "layers": U, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": KV, "head_dim": cfg.hd, "d_ff": cfg.d_ff,
        "vocab_padded": cfg.vocab_padded, "batch": LM_BATCH,
        "prompt": LM_PROMPT, "new": LM_NEW, "budget": LM_BUDGET,
        "recency": LM_RECENCY, "heads_a_run": heads}}
    t0 = time.perf_counter()
    params, n = sv_counted(lambda: lm.init_params(prng.PRNGKey(0, dev)),
                           "LM init", {"threefry2x32"})
    out["init_s"] = time.perf_counter() - t0
    out["init_launches"] = n
    out["params"] = sum(int(a.numel()) for a in lm_leaves(params))
    check(all(a.is_cuda and a.dtype == torch.float32
              for a in lm_leaves(params)), "the init's leaves are not float32 "
          "on the card")
    rng = np.random.default_rng(LM_SEED)
    prompts = rng.integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           dtype=np.int32)
    print(f"  LM: {LM_ARCH} at full width, {out['params']} parameters "
          f"(float32), init {out['init_s']:.1f} s")

    # (1) float32, the card against a CPU copy, at 2 of the 24 layers
    cfg2 = dataclasses.replace(cfg32, n_layers=LM_CPU_LAYERS)
    card2, cpu2 = LM(cfg2, device=dev), LM(cfg2, device="cpu")
    p_card, p_cpu = (lm_params_slice(params, LM_CPU_LAYERS, d)
                     for d in (dev, "cpu"))
    live = slice(0, cfg.vocab)            # the padded vocab is -1e30
    lg, sg = card2.prefill(p_card, prompts)
    lc, sc = cpu2.prefill(p_cpu, prompts)
    errs = [lm_rel(lg[..., live], lc[..., live])]
    errs_k = [lm_rel(sg.caches["head"]["layer0"].k,
                     sc.caches["head"]["layer0"].k)]
    for _ in range(LM_DECODE_STEPS):
        nxt = lc[:, -1].argmax(-1).to(torch.int32)[:, None].numpy()
        lg, sg = card2.decode_step(p_card, nxt, sg)
        lc, sc = cpu2.decode_step(p_cpu, nxt, sc)
        errs.append(lm_rel(lg[..., live], lc[..., live]))
    errs_k.append(lm_rel(sg.caches["head"]["layer0"].k,
                         sc.caches["head"]["layer0"].k))
    out["card_vs_cpu_f32"] = {"layers": LM_CPU_LAYERS,
                              "logits_rel": errs, "cache_k_rel": errs_k}
    check(max(errs + errs_k) <= LM_F32_TOL, f"float32 card vs CPU copy: "
          f"logits {errs}, caches {errs_k} > {LM_F32_TOL}")
    del p_cpu, lc, sc
    print(f"  LM float32 card vs CPU copy at {LM_CPU_LAYERS} layers: "
          f"prefill and {LM_DECODE_STEPS} decode steps within "
          f"{max(errs):.2e}, caches {max(errs_k):.2e}")

    # (2) bfloat16 (the config's) against float32, full depth, the card
    l16, _ = lm.prefill(params, prompts)
    l32, _ = lm32.prefill(params, prompts)
    check(l16.dtype == torch.bfloat16 and l32.dtype == torch.float32,
          f"prefill logits {l16.dtype} / {l32.dtype}")
    a, b = (x[:, 0, :cfg.vocab].float().cpu() for x in (l16, l32))
    err_row = (a - b).abs().amax(-1)
    rel = float(err_row.max()) / float(b.abs().max())
    top2 = b.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * err_row
    agree = a.argmax(-1) == b.argmax(-1)
    out["bf16_vs_f32"] = {"logits_rel": rel,
                          "max_abs_err_rows": err_row.tolist(),
                          "f32_top2_margin": margin.tolist(),
                          "first_tokens_agree": agree.tolist()}
    check(rel <= LM_BF16_TOL, f"bfloat16 vs float32 logits: {rel} of max "
          f"|float32| > {LM_BF16_TOL}")
    check(bool((agree | ~decided).all()), f"bfloat16 and float32 first "
          f"tokens differ where float32's top-2 margin {margin.tolist()} "
          f"exceeds twice the error {err_row.tolist()}")
    # argmax on the card takes the first of equal bfloat16 maxima, as the
    # CPU and jnp.argmax do
    tie = torch.zeros((2, cfg.vocab_padded), dtype=torch.bfloat16,
                      device=dev)
    tie[:, [7, cfg.vocab // 2, cfg.vocab - 1]] = 3.0
    check(tie.argmax(-1).tolist() == [7, 7] and torch.equal(
        l16[:, 0].argmax(-1).cpu(), l16[:, 0].cpu().argmax(-1)),
        "torch.argmax on the card does not take the first maximum")
    print(f"  LM bfloat16 vs float32 (full depth): {rel:.3e} of max "
          f"|float32|; first tokens agree {agree.tolist()}, float32 "
          f"margins {margin.tolist()}")
    del l32

    # (3) decode against forward, float32, full depth, the card
    toks = prompts[:, :LM_DVF_TOKENS]
    full = lm32.forward(params, toks)[..., :cfg.vocab]
    state = lm32.init_decode_state(LM_BATCH, LM_DVF_TOKENS)
    outs = []
    for t in range(LM_DVF_TOKENS):
        lg_t, state = lm32.decode_step(params, toks[:, t:t + 1], state)
        outs.append(lg_t[:, 0, :cfg.vocab])
    dvf = float((torch.stack(outs, 1) - full).abs().max()) / \
        float(full.abs().max())
    out["decode_vs_forward_rel"] = dvf
    check(dvf <= LM_DVF_TOL, f"decode vs forward: {dvf} > {LM_DVF_TOL}")
    print(f"  LM decode vs forward over {LM_DVF_TOKENS} tokens (float32): "
          f"{dvf:.2e} of max |forward|")
    del full, outs, state

    # (4) the serving path: ServeEngine.generate, greedy, four ways
    params16 = lm._cast(params)
    engine = ServeEngine(lm, params16, seed=LM_SEED, device=dev)
    engine.generate(prompts[:, :16], 2)                      # warm-up
    # a decode step and a draw (greedy, and at T = 0.7 in bfloat16) wait
    # for nothing on the host: in torch.cuda's sync debug mode "error" an
    # operation that synchronizes with the card raises
    warm = ServeEngine(lm, params16, temperature=0.7, seed=LM_SEED,
                       device=dev)
    lg0, st0 = lm.prefill(params16, prompts[:, :16])
    tok0 = engine._sample(lg0[:, -1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lg1, _ = lm.decode_step(params16, tok0[:, None], st0)
        engine._sample(lg1[:, -1])
        warm._sample(lg1[:, -1])
        synced = None
    except RuntimeError as e:
        synced = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(synced is None, f"a decode step or a draw synchronized with the "
          f"card: {synced}")
    out["decode_step_waits_for_the_card"] = synced is not None
    runs, launches = {}, {}
    res, launches["plain"], _ = lm_generate(engine, prompts, "LM generate",
                                            set())
    runs["plain"] = res
    inline, map_tracker = {}, obs.InMemoryTracker()
    for method, expect in (("sample", {"phase2_select", "threefry2x32"}),
                           ("map", {"greedy_map_kdpp"})):
        eng = ServeEngine(lm, params16, seed=LM_SEED, device=dev)
        with obs.use(map_tracker if method == "map"
                     else obs.InMemoryTracker()):
            res, launches[method], seen = lm_generate(
                eng, prompts, f"LM generate, {method} compaction", expect,
                kv_budget=LM_BUDGET, kv_recency=LM_RECENCY,
                kv_method=method)
        check(len(seen) == 1, f"{method}: {len(seen)} compactions")
        inline[method] = (seen[0][1], lm_kept_positions(
            seen[0][1], seen[0][2], f"{method} compaction"))
        runs[method] = res
        check(np.array_equal(res["tokens"][:, 0],
                              runs["plain"]["tokens"][:, 0]),
              f"{method}: the first token differs from the plain run's")
    n_s, n_m = launches["sample"], launches["map"]
    want_tf = 1 + 2 * U + heads
    check(n_s["phase2_select"] == heads and n_s["threefry2x32"] == want_tf,
          f"sample compaction launched phase 2 {n_s['phase2_select']} and "
          f"threefry2x32 {n_s['threefry2x32']} times, not {heads} (one a "
          f"head) and {want_tf} (1 + 2 a unit + 1 a head)")
    n_m["counters"] = {e: int(map_tracker.counter_value(
        f"kernels.greedy_map_update.{e}")) for e in ("cuda", "reference")}
    check(n_m["greedy_map_kdpp"] == U and n_m["greedy_map_update"] == 0
          and n_m["counters"] == {"cuda": U, "reference": 0}, f"map "
          f"compaction launched the fused kernel {n_m['greedy_map_kdpp']} "
          f"times (not {U}, one a unit of {heads // U} heads) and the step "
          f"kernel {n_m['greedy_map_update']} times; counters "
          f"{n_m['counters']}")
    # the client path: two tenant streams, one KVCompactionClient
    streams = {t: np.random.default_rng(LM_SEED + 1 + i).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int32)
        for i, t in enumerate(LM_TENANTS)}
    eng = ServeEngine(lm, params16, seed=LM_SEED, device=dev)
    seen = lm_capture(eng)
    (cres, client), launches["client"] = sv_counted(
        lambda: lm_clients(eng, streams, dev), "LM client streams",
        {"phase2_select", "threefry2x32"})
    check(launches["client"]["phase2_select"] == heads * len(streams),
          f"the client path launched phase 2 "
          f"{launches['client']['phase2_select']} times, not "
          f"{heads * len(streams)}")
    kept_client = {t: lm_kept_positions(b, a, f"client stream {t}")
                   for t, b, a in seen}
    check(sorted(kept_client) == sorted(streams), f"client compactions "
          f"{sorted(kept_client)}")
    m = client._metrics
    out["client"] = {
        "device_calls": int(m.counter_value("serving.device_calls")),
        "heads_selected": int(m.counter_value("serving.heads_selected")),
        "flush_ms": [x * 1e3 for x in m.observations["serving.flush_s"]]}
    for t, r in cres.items():
        runs[f"client_{t}"] = r

    # (5) kernel checks: heads replayed against the plain versions
    hkeys = lm_sample_head_keys(LM_SEED, U, LM_BATCH, KV)
    state0, kept = inline["sample"]
    cache0 = state0.caches["head"]["layer0"]
    ins = []
    for u, b, h in LM_REPLAY:
        ins.append(kv_head_replay(
            cache0.k[u, b, :, h], LM_RECENCY, LM_PROMPT, hkeys[u, b, h],
            kept[u, b, h], f"sample head (unit {u}, b {b}, h {h})"))
    rkeys = {t: client._keyring.row_keys([SvTicket(t, 0, heads)], heads)
             for t in streams}
    for t, before, _ in seen:
        c = before.caches["head"]["layer0"]
        for u, b, h in LM_REPLAY[:2]:
            j = (u * LM_BATCH + b) * KV + h
            ins.append(kv_head_replay(
                c.k[u, b, :, h], LM_RECENCY, LM_PROMPT, rkeys[t][j],
                kept_client[t][u, b, h],
                f"client {t} head (unit {u}, b {b}, h {h})"))
    route = p2.phase2_select_route(LM_PROMPT, 1, k)
    check(route == "cluster", f"an LM KV head's phase 2 takes route {route}")
    us_c, ke_c, G1_c, Gr_c = (torch.cat([x[0][j] for x in ins]).cpu()
                              for j in range(4))
    pp = p2.phase2_select_plain(us_c, ke_c, G1_c, Gr_c).numpy()
    out["sample_heads_vs_cpu_plain"] = compare_picks(
        torch.cat([x[1] for x in ins]).cpu().numpy(), pp, us_c, ke_c, G1_c,
        Gr_c, "LM KV heads, kernel vs the plain phase 2 on a CPU copy")
    out["phase2_route"] = route
    state_m, kept_m = inline["map"]
    recent = set(range(LM_PROMPT - LM_RECENCY, LM_PROMPT))
    out["map_heads_vs_cpu"] = []
    for u, b, h in LM_REPLAY:
        Lm = token_kernel(state_m.caches["head"]["layer0"].k[u, b, :, h],
                          LM_RECENCY, LM_PROMPT, "map")[0]
        order_k = ops.greedy_map_kdpp(Lm, k).cpu().numpy()
        order_p = ops.greedy_map_kdpp(Lm.cpu(), k).numpy()
        check(sorted(set(order_k.tolist()) | recent) ==
              kept_m[u, b, h].tolist(), f"map head (unit {u}, b {b}, h "
              f"{h}): the kept positions are not its greedy order and the "
              f"recency window")
        out["map_heads_vs_cpu"].append(compare_maps(
            Lm, order_k, order_p, f"LM map head (unit {u}, b {b}, h {h})"))
    # one unit's selection as the path runs it: the (B·KV, S, S) stack of
    # its heads' kernels in one launch, each head its own single launch bit
    # for bit, the kept positions its picks and the recency window
    cache_m = state_m.caches["head"]["layer0"]
    L_unit = torch.stack([token_kernel(cache_m.k[0, b, :, h], LM_RECENCY,
                                       LM_PROMPT, "map")[0]
                          for b in range(LM_BATCH) for h in range(KV)])
    unit_picks = gm.greedy_map_kdpp_cuda(L_unit, k)
    for i, (b, h) in enumerate(itertools.product(range(LM_BATCH),
                                                 range(KV))):
        check(torch.equal(gm.greedy_map_kdpp_cuda(L_unit[i], k),
                          unit_picks[i]), f"LM unit 0 head ({b}, {h}): the "
              f"batched launch differs from its single launch")
        check(sorted(set(unit_picks[i].tolist()) | recent) ==
              kept_m[0, b, h].tolist(), f"LM unit 0 head ({b}, {h}): the "
              f"kept positions are not the batched picks and the recency "
              f"window")

    # where a head's compaction time goes (CUDA events), and phase 2's
    # device time at the head's shape (filled in phase 24)
    head0 = cache0.k[0, 0, :, 0]
    lam0 = ins[0][3]
    u0, _ = plain_row_uniforms(hkeys[0, 0, 0].to(dev)[None], LM_PROMPT, k)
    ll0 = torch.log(torch.clamp_min(lam0, 0.0))
    out["head_ms"] = {
        "select_tokens_sample": cuda_ms(lambda: dpp_select_tokens(
            head0, LM_BUDGET, LM_RECENCY, valid_len=LM_PROMPT,
            method="sample", key=hkeys[0, 0, 0].to(dev)), reps=3, warmup=1),
        "kernel_and_eigh": cuda_ms(lambda: torch.linalg.eigh(token_kernel(
            head0, LM_RECENCY, LM_PROMPT, "sample")[0]), reps=3, warmup=1),
        "esp_phase1": cuda_ms(lambda: _phase1_kdpp_from_uniforms(
            u0, ll0, k), reps=3, warmup=1),
        "select_tokens_map": cuda_ms(lambda: dpp_select_tokens(
            head0, LM_BUDGET, LM_RECENCY, valid_len=LM_PROMPT,
            method="map"), reps=3, warmup=1)}
    (us1, ke1, G11, Gr1), raw1 = ins[0][:2]
    picks1 = raw1.cpu().numpy()
    b_ms, b_by = bound(picks1, LM_PROMPT, 1, k)
    more, extra = cluster_row(us1, ke1, G11, Gr1, picks1, "an LM KV head")
    out["phase2_times"] = kernel_times(
        partial(p2.phase2_select_cuda, us1, ke1, G11, Gr1),
        partial(p2.phase2_select_plain, us1, ke1, G11, Gr1), None,
        reps=5, plain_reps=2, expect="phase2_select_kernel_cluster",
        sole=True, extra=extra, **more,
        kernel_route=route, bound_ms=b_ms, bound_by=b_by,
        bound_row_ms=bound_row(picks1, LM_PROMPT, 1, k),
        max_row_steps=int((picks1 >= 0).sum(axis=1).max()),
        shapes={"N1": LM_PROMPT, "Nr": 1, "k_max": k, "B": 1})
    # the fused selection of one unit (4 heads, N = S, k = 120) as the
    # path launches it, against the plain loop on the same stack
    live = [greedy_live_steps(L_unit[i], unit_picks[i].tolist())
            for i in range(L_unit.shape[0])]
    b_ms, b_by, b_row = kdpp_bound(LM_PROMPT, k, live)
    out["kdpp_times"] = kernel_times(
        partial(gm.greedy_map_kdpp_cuda, L_unit, k),
        partial(gm.greedy_map_kdpp_plain, L_unit, k), None,
        reps=20, plain_reps=1, expect="greedy_map_kdpp_kernel", sole=True,
        bound_ms=b_ms, bound_by=b_by, bound_row_ms=b_row, live_steps=live,
        steps=k, plan=gm.greedy_map_kdpp_plan(LM_PROMPT, k, dev),
        shapes={"N": LM_PROMPT, "k": k, "H": int(L_unit.shape[0])})
    # the step kernel at a "map" head's shape (N = S, k = 120)
    lcol, C, cj, dj, d = greedy_inputs(
        LM_PROMPT, k, torch.Generator(device=dev).manual_seed(LM_SEED), dev)
    args = (lcol, C.t().contiguous().t(), cj, dj, d)
    b_ms, b_by = greedy_bound(LM_PROMPT, k)
    out["greedy_times"] = kernel_times(
        partial(gm.greedy_map_update_cuda, *args),
        partial(gm.greedy_map_update_plain, *args),
        partial(greedy_library, *args), reps=200, plain_reps=100,
        expect="greedy_map_update_kernel", bound_ms=b_ms, bound_by=b_by,
        shapes={"N": LM_PROMPT, "k": k})

    # (6) the numbers of the runs
    out["runs"] = {name: {key: r[key] for key in
                          ("prefill_s", "compact_s", "decode_s",
                           "decode_tok_per_s")}
                   for name, r in runs.items()}
    for name in ("sample", "map"):
        out["runs"][name]["compact_per_head_ms"] = \
            runs[name]["compact_s"] * 1e3 / heads
    out["runs"]["map"]["compact_per_unit_ms"] = \
        runs["map"]["compact_s"] * 1e3 / U
    out["launches_per_request"] = launches
    out["tokens_first_row"] = {name: r["tokens"][0, :8].tolist()
                               for name, r in runs.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  LM runs: {json.dumps(out['runs'])}")
    print(f"LM serving (phase 23): {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 24 helpers: LM training with KronDPP batch selection
# ---------------------------------------------------------------------------

# qwen2-0.5b at full width (as phase 23), trained by the port's eager train
# step: 8 steps of B = 8 sequences of 128 tokens (129 with the label),
# picked from a synthetic corpus of 1024 documents by the KronDPP selector
# (32 x 32 RBF factors over the documents' features, the service's prefetch
# 16: one phase-2 launch for the 8 batches), as
# `launch.train --dpp-batch-selection` builds them; AdamW at the
# launcher's lr 3e-4 under its cosine schedule.
LT_STEPS, LT_BATCH, LT_SEQ, LT_DOCS = 8, 8, 128, 1024
LT_CPU_BATCH = 4           # card vs CPU copy: 4 sequences, 2 layers, float32
LT_LR = 3e-4
LT_F32_TOL = 1e-4          # loss and grad norm, card vs CPU, of max(1, |CPU|)
LT_STEP_TOL = 1e-6         # params after a step, of max(1, max |CPU leaf|)
LT_PAST_SHARE = 0.01       # the share of params that may pass LT_STEP_TOL
LT_RESUME = (4, 6, 2)      # train to 4, checkpoint every 2, resume to 6
LT_TIMED = slice(2, None)  # the steps whose median is the step time: 3-8
LT_KN = (2, 3, 8, 4)       # k > N: Kron (2, 3) (N = 6), k = 8; a batch of 4
LEARN_ARGV = ["--n1", "100", "--n2", "100", "--subsets", "1000",
              "--expected-size", "20", "--algorithm", "krk", "--dense-theta",
              "--schedule", "armijo", "--a", "1.5", "--iters", "5",
              "--log-every", "5"]


def lt_params_gap(got, want) -> dict:
    """Params of two runs: the largest |Δ| of max(1, max |want leaf|), the
    elements past ``LT_STEP_TOL`` of it, and the element count."""
    from repro_torch.optim.adamw import tree_leaves
    worst, past, n = 0.0, 0, 0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = g.detach().float().cpu(), w.detach().float().cpu()
        d = (g - w).abs() / max(1.0, float(w.abs().max()))
        worst = max(worst, float(d.max()))
        past += int((d > LT_STEP_TOL).sum())
        n += d.numel()
    return {"max_rel": worst, "elements_past_step_tol": past,
            "elements": n}


def lt_check_gap(gap: dict, steps: int, label: str) -> None:
    """AdamW's rule for two runs of the same steps that part by roundoff:
    an update element is about lr·g / (|g| + eps), so where a grad is
    within roundoff of 0 the two updates may differ by up to 2·lr a step;
    everywhere else they agree to float32 roundoff. So: every element
    within 2·lr·steps, and at most ``LT_PAST_SHARE`` of them past
    ``LT_STEP_TOL``."""
    check(gap["max_rel"] <= 2 * LT_LR * steps
          and gap["elements_past_step_tol"] <= LT_PAST_SHARE
          * gap["elements"], f"{label}: params {gap}")


def lt_card_vs_cpu(cfg, dev) -> dict:
    """(1) one train step at 2 layers, float32, the card against a CPU copy
    from the same seeded params and batch, with 1 and 2 microbatches."""
    import dataclasses
    from repro_torch import random as prng
    from repro_torch.models import LM
    from repro_torch.models.transformer import tree_map
    from repro_torch.optim import AdamW
    from repro_torch.train import make_train_step
    cfg2 = dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS, dtype="float32")
    card, cpu = LM(cfg2, device=dev), LM(cfg2, device="cpu")
    params = card.init_params(prng.PRNGKey(LM_SEED, dev))
    p_cpu = tree_map(lambda a: a.cpu(), params)
    batch = {"tokens": np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab, (LT_CPU_BATCH, LT_SEQ + 1), dtype=np.int32)}
    opt = AdamW(lr=LT_LR)
    out = {"layers": LM_CPU_LAYERS, "batch": LT_CPU_BATCH, "seq": LT_SEQ}
    for mb in (1, 2):
        pc, _, mc = make_train_step(cpu, opt, mb)(p_cpu, opt.init(p_cpu),
                                                  batch)
        pg, sg, mg = make_train_step(card, opt, mb)(params,
                                                    opt.init(params), batch)
        check(all(a.is_cuda for a in lm_leaves(pg)) and sg.step.is_cuda,
              "the card's train step left the card")
        rel = {k: abs(float(mg[k]) - float(mc[k])) / max(1.0,
                                                          abs(float(mc[k])))
               for k in ("loss", "grad_norm")}
        gap = lt_params_gap(pg, pc)
        out[f"microbatches{mb}"] = {"loss": [float(mg["loss"]),
                                             float(mc["loss"])],
                                    **{f"{k}_rel": v for k, v in rel.items()},
                                    "params": gap}
        check(max(rel.values()) <= LT_F32_TOL, f"train step card vs CPU "
              f"({mb} microbatches): {rel} > {LT_F32_TOL}")
        lt_check_gap(gap, 1, f"train step card vs CPU ({mb} "
                     f"microbatches)")
        print(f"  LM train step, card vs CPU copy ({LM_CPU_LAYERS} layers, "
              f"float32, {mb} microbatches): {json.dumps(out[f'microbatches{mb}'])}")
    return out


def lt_selector(corpus, cfg, dev):
    """The selector of `launch.train --dpp-batch-selection`, on ``dev``."""
    from repro_torch.data import DPPBatchSelector
    rng = np.random.default_rng(LM_SEED)
    proj = rng.standard_normal((cfg.vocab, 16)).astype(np.float32) / 16
    feats = np.stack([proj[c].mean(0) for c in corpus])
    n1 = int(np.sqrt(LT_DOCS))
    while LT_DOCS % n1:
        n1 -= 1
    return DPPBatchSelector.from_features(feats, n1, LT_DOCS // n1,
                                          device=dev)


def lt_rows(rows, width: int) -> np.ndarray:
    out = np.full((len(rows), width), -1, dtype=np.int32)
    for b, r in enumerate(rows):
        check(len(r) <= width, f"a selector row of {len(r)} > {width}")
        out[b, :len(r)] = r
    return out


def lt_selector_vs_cpu(sel, cpu_sel, chosen) -> dict:
    """The selector's first flush on the card (the rows the 8 batches came
    from) against the plain phase 2 on its replayed inputs and against a
    CPU copy's flush, under phase 3's picks rule; then the 8 index sets of
    the training run against the CPU copy's ``select`` with the pipeline's
    rng, compared while every row so far is identical (the rng's later
    draws depend on the rows' lengths)."""
    from repro_torch import random as prng
    from repro_torch.kernels import phase2_select as p2
    seed = int(np.random.default_rng(LM_SEED).integers(2 ** 31))
    svc = sel.dpp.service(seed=seed, device=sel.device)
    rows_k = svc.sample(sel.prefetch)
    rows_c = cpu_sel.dpp.service(seed=seed, device="cpu").sample(
        cpu_sel.prefetch)
    B = svc.stats()["samples_drawn"]
    _, sub = prng.split(prng.PRNGKey(seed, sel.device), backend="reference")
    u_p, us_p = plain_row_uniforms(prng.split(sub, B, backend="reference"),
                                   svc.spectrum.N, svc.k_max)
    us, ke, G1, Gr = (x[:len(rows_k)] for x in phase1_of(
        svc.spectrum, svc.k_max, u_p, us_p))
    pk = lt_rows(rows_k, svc.k_max)
    pp = p2.phase2_select_plain(us, ke, G1, Gr).cpu().numpy()
    route = p2.phase2_select_route(int(G1.shape[1]), int(Gr.shape[1]),
                                   svc.k_max)
    check(route == "cluster", f"the selector's phase 2 takes route {route}")
    out = {"rows": len(rows_k), "k_max": svc.k_max, "samples_drawn": B,
           "route": route,
           "kernel_vs_plain": compare_picks(
               pk, pp, us, ke, G1, Gr, "LM train selector: the flush, "
               "kernel vs plain phase 2"),
           "card_vs_cpu_copy": compare_picks(
               pk, lt_rows(rows_c, svc.k_max), us, ke, G1, Gr,
               "LM train selector: the flush, card vs CPU copy")}
    rng = np.random.default_rng(LM_SEED)
    same = 0
    for i, got in enumerate(chosen):
        if pk[i].tolist() != lt_rows(rows_c[i:i + 1], svc.k_max)[0].tolist():
            break
        want = cpu_sel.select(rng, LT_BATCH)
        check(np.array_equal(got, want), f"LM train batch {i}: the card "
              f"selected {got.tolist()}, the CPU copy {want.tolist()}")
        same += 1
    # the flush's phase 2 as the service launches it (device times filled
    # in phase 25)
    b_ms, b_by = bound(pk, int(G1.shape[1]), int(Gr.shape[1]), svc.k_max)
    more, extra = cluster_row(us, ke, G1, Gr, pk, "the selector's flush")
    out["phase2_times"] = kernel_times(
        partial(p2.phase2_select_cuda, us, ke, G1, Gr),
        partial(p2.phase2_select_plain, us, ke, G1, Gr), None, reps=5,
        plain_reps=2, expect="phase2_select_kernel_cluster", sole=True,
        extra=extra, **more,
        kernel_route=route, bound_ms=b_ms, bound_by=b_by,
        bound_row_ms=bound_row(pk, int(G1.shape[1]), int(Gr.shape[1]),
                               svc.k_max),
        max_row_steps=int((pk >= 0).sum(axis=1).max()),
        shapes={"N1": int(G1.shape[1]), "Nr": int(Gr.shape[1]),
                "k_max": svc.k_max, "B": len(rows_k)})
    out["index_sets_equal_to_cpu_copy"] = same
    if out["card_vs_cpu_copy"]["identical"] == out["rows"]:
        check(same == len(chosen), f"LM train: only {same} index sets "
              f"compared")
    print(f"  LM train selector: the first {same} of {len(chosen)} index "
          f"sets equal the CPU copy's")
    return out


def lt_resume(cfg, corpus, dev) -> dict:
    """(3) 2 layers at full width, the config's bfloat16: train to 4 with
    checkpoints every 2, resume to 6 (``try_resume`` restores an
    ``OptState``; the pipeline restored to step 4 replays its selector),
    against one 6-step run from the same init."""
    import dataclasses
    import tempfile
    from repro_torch import random as prng
    from repro_torch.data import TokenPipeline
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, OptState, cosine_schedule
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    first, total, every = LT_RESUME
    lm = LM(dataclasses.replace(cfg, n_layers=LM_CPU_LAYERS), device=dev)
    params = lm.init_params(prng.PRNGKey(LM_SEED, dev))
    opt = AdamW(lr=LT_LR, schedule=cosine_schedule(1, total))
    step = make_train_step(lm, opt)
    pipe = lambda: TokenPipeline(corpus, LT_BATCH, LM_SEED,
                                 lt_selector(corpus, cfg, dev))
    with tempfile.TemporaryDirectory(prefix="lm_train_resume_") as d:
        tc = lambda n: TrainerConfig(total_steps=n, checkpoint_dir=d,
                                     checkpoint_every=every, log_every=1)
        t0 = time.perf_counter()
        r1 = Trainer(lm, opt, step, tc(first)).fit(
            params, opt.init(params), iter(pipe()))
        fit_s = time.perf_counter() - t0
        t2 = Trainer(lm, opt, step, tc(total))
        t0 = time.perf_counter()
        p2, o2, start = t2.try_resume(params, opt.init(params))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(start == first and isinstance(o2, OptState)
              and int(o2.step) == first and o2.step.is_cuda, f"resume: "
              f"start {start}, opt step {o2.step}")
        resumed = pipe()
        resumed.restore({"step": first, "seed": LM_SEED})
        r2 = t2.fit(p2, o2, iter(resumed), start_step=start)
    check(r1["final_step"] == first and r2["final_step"] == total,
          f"resume: final steps {r1['final_step']}, {r2['final_step']}")
    one = Trainer(lm, opt, step, TrainerConfig(
        total_steps=total, log_every=1)).fit(params, opt.init(params),
                                             iter(pipe()))
    gap = lt_params_gap((r2["params"], r2["opt_state"].m),
                        (one["params"], one["opt_state"].m))
    from repro_torch.optim.adamw import tree_leaves
    bitwise = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((r2["params"], r2["opt_state"])),
        tree_leaves((one["params"], one["opt_state"]))))
    losses = {"resumed": [h["loss"] for h in r2["history"]],
              "one_shot": [h["loss"] for h in one["history"][first:]]}
    out = {"layers": LM_CPU_LAYERS, "dtype": cfg.dtype,
           "steps": list(LT_RESUME), "bitwise": bitwise, "gap": gap,
           "losses": losses, "first_fit_s": fit_s, "restore_s": restore_s}
    # a resumed run may part from the one-shot run only by roundoff of the
    # card's reductions (lt_check_gap)
    lt_check_gap(gap, total - first, "resumed vs one-shot")
    check(np.allclose(losses["resumed"], losses["one_shot"], rtol=1e-3,
                      atol=0.0), f"resumed vs one-shot losses: {losses}")
    print(f"  LM train resume {first} -> {total} against one shot "
          f"({LM_CPU_LAYERS} layers, {cfg.dtype}): bitwise {bitwise}, "
          f"{json.dumps(gap)}, losses {json.dumps(losses)}")
    return out


def lt_learn_cli(dev) -> dict:
    """(4) ``launch.learn.main`` in process at the paper's size."""
    import contextlib
    import io
    from repro_torch.launch import learn
    from repro_torch.learning.schedules import _ASCENT_TOL
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        _, n = sv_counted(lambda: learn.main(LEARN_ARGV + ["--device",
                                                           str(dev)]),
                          "launch.learn", {"partial_trace_A",
                                           "partial_trace_C",
                                           "phase2_select", "threefry2x32"})
    wall = time.perf_counter() - t0
    lines = [json.loads(line) for line in buf.getvalue().splitlines()
             if line.startswith("{")]
    check(len(lines) >= 3, f"launch.learn printed {buf.getvalue()!r}")
    lls = [x["ll"] for x in lines[:-1]]
    final = lines[-1]
    check(n["partial_trace_A"] == 5 and n["partial_trace_C"] == 10,
          f"launch.learn launched A {n['partial_trace_A']} and C "
          f"{n['partial_trace_C']} times, not 5 and 10")
    check(bool((np.diff(lls) >= -_ASCENT_TOL).all()) and lls[-1] > lls[0]
          and np.isfinite(lls).all(), f"launch.learn LLs {lls}")
    check(final["sweeps"] == 5 and final["algorithm"] == "krk", f"{final}")
    out = {"argv": LEARN_ARGV, "lines": lines, "launches": n,
           "sweep_ms": 1e3 / final["sweeps_per_sec"], "wall_s": wall}
    print(f"  launch.learn: {json.dumps(lines)}; launches {n}")
    return out


def lt_k_past_n(dev) -> dict:
    """(5) greedy MAP with k > N on the card: ``Kron.map(k)`` and an (H, N,
    N) batch, each the plain loop's on a CPU copy, N picks then zeros."""
    from repro_torch import dpp
    from repro_torch.kernels import ops
    n1, n2, k, H = LT_KN
    N = n1 * n2
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    model = dpp.random_kron(gen, (n1, n2), device=dev)
    cpu = dpp.Kron(tuple(f.cpu() for f in model.factors), device="cpu")
    X = torch.rand((H, N, 3), generator=gen, device=dev)
    Ls = X @ X.transpose(1, 2) + 0.1 * torch.eye(N, device=dev)
    out = {}
    for label, fn, L in (
            ("Kron.map", lambda: model.map(k), model.dense_kernel()),
            ("(H, N, N)", lambda: ops.greedy_map_kdpp(Ls, k), Ls)):
        got, n = map_counted(fn, f"k > N: {label}", 1)
        out[f"{label} launches"] = n["greedy_map_kdpp"]
        check(got.is_cuda and got.dtype == torch.int32
              and got.shape[-1] == k, f"k > N: {label} gave {got.shape} "
              f"{got.dtype} on {got.device}")
        want = (cpu.map(k) if label == "Kron.map"
                else ops.greedy_map_kdpp(Ls.cpu(), k)).numpy()
        got = got.cpu().numpy()
        check((got[..., N:] == 0).all() and (want[..., N:] == 0).all(),
              f"k > N: {label} tails {got[..., N:]} / {want[..., N:]}")
        Lc = L.cpu().reshape(-1, N, N)
        out[label] = [compare_maps(Lc[h], a[:N], b[:N],
                                   f"k > N: {label} [{h}]")
                      for h, (a, b) in enumerate(zip(got.reshape(-1, k),
                                                     want.reshape(-1, k)))]
        print(f"  k > N, {label}: the card {got.tolist()}, the plain loop "
              f"{want.tolist()}")
    return out


STEP_PROFILES = []       # (lm_train_path's dict, one train step) owed


def fill_step_profiles() -> None:
    """The train step's device time (``device_ms``: every kernel, copy and
    fill of a step), its share of the step's host-clock time, and its
    largest kernels by device time."""
    for out, step in STEP_PROFILES:
        names = {}
        out["step_device_ms"] = device_ms(step, reps=3, warmup=1,
                                          by_name=names)
        out["step_idle_share"] = 1.0 - out["step_device_ms"] / (
            out["step_s"] * 1e3)
        out["step_device_events"] = names.pop("events")
        out["step_kernel_names"] = len(names)
        out["step_top_kernels_ms"] = dict(sorted(
            names.items(), key=lambda kv: -kv[1])[:12])
        print(f"  LM train step on the device: {out['step_device_ms']:.1f} "
              f"ms of {out['step_s'] * 1e3:.1f} ms (idle "
              f"{out['step_idle_share']:.2f}), "
              f"{out['step_device_events']:.0f} device events; top kernels "
              f"{json.dumps({k[:60]: round(v, 3) for k, v in out['step_top_kernels_ms'].items()})}")
    STEP_PROFILES.clear()


def lm_train_path(dev) -> dict:
    """Phase 24: LM training with KronDPP batch selection (see the module
    docstring). Returns what the ``training`` line prints and the
    ``kernels`` rows take."""
    import statistics
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, synthetic_corpus
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    out = {"arch": LM_ARCH, "shapes": {
        "layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "vocab_padded": cfg.vocab_padded, "batch": LT_BATCH, "seq": LT_SEQ,
        "docs": LT_DOCS, "steps": LT_STEPS, "remat": cfg.remat}}

    # (1) one step, float32, 2 layers: the card against a CPU copy
    out["card_vs_cpu"] = lt_card_vs_cpu(cfg, dev)

    # (2) full depth, the config's bfloat16, 8 DPP-selected steps (the
    # objects of `launch.train --dpp-batch-selection`, logging every step)
    lm = LM(cfg, device=dev)
    params = lm.init_params(prng.PRNGKey(LM_SEED, dev))
    opt = AdamW(lr=LT_LR, schedule=cosine_schedule(max(LT_STEPS // 10, 1),
                                                   LT_STEPS))
    opt_state = opt.init(params)
    corpus = synthetic_corpus(LT_DOCS, LT_SEQ, cfg.vocab, LM_SEED)
    sel = lt_selector(corpus, cfg, dev)
    chosen, select_ms, inner = [], [], sel.select

    def select(rng, n):
        t0 = time.perf_counter()
        idx = inner(rng, n)
        select_ms.append((time.perf_counter() - t0) * 1e3)
        chosen.append(idx)
        return idx
    sel.select = select
    trainer = Trainer(lm, opt, make_train_step(lm, opt),
                      TrainerConfig(total_steps=LT_STEPS, log_every=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out["memory_allocated_before_gb"] = torch.cuda.memory_allocated(dev) \
        / 2 ** 30
    t0 = time.perf_counter()
    res, n = sv_counted(lambda: trainer.fit(params, opt_state, iter(
        TokenPipeline(corpus, LT_BATCH, LM_SEED, sel))), "LM train",
        {"phase2_select", "threefry2x32"})
    out["fit_s"] = time.perf_counter() - t0
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(dev) \
        / 2 ** 30
    losses = [h["loss"] for h in res["history"]]
    out["losses"] = losses
    out["grad_norms"] = [h["grad_norm"] for h in res["history"]]
    out["launches"] = n
    check(res["final_step"] == LT_STEPS and len(losses) == LT_STEPS
          and np.isfinite(losses).all() and np.isfinite(
              out["grad_norms"]).all(), f"LM train: final step "
          f"{res['final_step']}, losses {losses}")
    check(n["phase2_select"] == 1, f"LM train: {n['phase2_select']} "
          f"phase-2 launches for {LT_STEPS} batches at prefetch "
          f"{sel.prefetch}, not 1")
    check(all(a.is_cuda for a in lm_leaves(res["params"])),
          "the trained params left the card")
    for i, idx in enumerate(chosen):
        check(len(idx) == LT_BATCH and len(set(idx.tolist())) == LT_BATCH
              and 0 <= idx.min() and idx.max() < LT_DOCS, f"LM train batch "
              f"{i}: {idx.tolist()}")
    times = trainer.step_times
    step_s = statistics.median(times[LT_TIMED])
    out["step_times_s"] = times
    out["step_s"] = step_s
    out["tokens_per_s"] = LT_BATCH * LT_SEQ / step_s
    out["select_ms"] = select_ms
    out["select_ms_median"] = statistics.median(select_ms)
    print(f"  LM train ({LM_ARCH}, full width, {cfg.dtype}, {LT_STEPS} "
          f"DPP-selected steps of {LT_BATCH} x {LT_SEQ}): losses {losses}, "
          f"step {step_s * 1e3:.1f} ms (median of steps 3-8), "
          f"{out['tokens_per_s']:.0f} tokens/s, peak "
          f"{out['max_memory_allocated_gb']:.2f} GiB, launches {n}")
    # the step's device time and its kernels, in phase 25 (after every
    # host-clock time): the trained state and the last batch are kept
    step_fn, last = trainer.train_step, {"tokens": corpus[chosen[-1]]}
    p_end, o_end = res["params"], res["opt_state"]
    STEP_PROFILES.append((out, lambda: step_fn(p_end, o_end, last)))
    del res, params, opt_state, trainer
    cpu_sel = lt_selector(corpus, cfg, "cpu")
    out["selector"] = lt_selector_vs_cpu(sel, cpu_sel, chosen[:LT_STEPS])

    # (2b) the launcher itself on the card, at smoke size
    import contextlib
    import io
    from repro_torch.launch import train as train_launch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r = train_launch.main(["--arch", LM_ARCH, "--smoke", "--steps", "12",
                               "--batch", "8", "--seq", "32", "--docs", "64",
                               "--dpp-batch-selection", "--device",
                               str(dev)])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    check(r["final_step"] == 12 and lines[-1]["final_step"] == 12
          and np.isfinite(lines[0]["loss"]), f"launch.train --smoke: "
          f"{lines}")
    out["launch_train_smoke"] = lines

    # (3) resume, (4) the learner CLI, (5) greedy MAP past N
    out["resume"] = lt_resume(cfg, corpus, dev)
    out["learn_cli"] = lt_learn_cli(dev)
    out["k_past_n"] = lt_k_past_n(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"LM training (phase 24): {out['phase_s']:.1f} s")
    return out


def lm_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in lm_leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# phase 26 helpers: the MoE, SSM, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

# Each family served through ServeEngine.generate, bfloat16, greedy, two
# seeded prompts, 32 new tokens, inline compaction to the budget with the 8
# most recent kept, "sample" and "map"; weights from init_params(PRNGKey(0)).
# (arch, overrides, prompt, budget, depth of the float32 card-vs-CPU check,
# the cuts listed under "reduced"): mixtral-8x7b at full width, 4 of its 32
# layers; mamba2-2.7b whole; whisper-tiny whole (1500 seeded frames);
# jamba-1.5-large-398b's layout (hybrid_period 8, unit_head 2,
# unit_tail_period 2, 16 experts top 2 every 2nd layer, SSD state 64, head
# 64, expand 2, head_dim 128, 8 : 1 heads, d_ff = 3 d) at reduced width: one
# unit at full width is 38.7 B params, 77 GB in bfloat16 alone.
LF_CONFIGS = (
    ("mixtral-8x7b", {"n_layers": 4}, 512, 128, 1,
     {"n_layers": "4 of 32"}),
    ("mamba2-2.7b", {}, 512, 128, 2, {}),
    ("whisper-tiny", {}, 64, 32, None, {}),
    ("jamba-1.5-large-398b", {"d_model": 1024, "d_ff": 3072, "n_heads": 8,
                              "n_kv_heads": 1, "n_layers": 16}, 512, 128,
     None, {"d_model": "1024 of 8192", "d_ff": "3072 of 24576",
            "n_heads": "8 of 64", "n_kv_heads": "1 of 8",
            "n_layers": "16 of 72 (2 units of 8)"}),
)
LF_SEED = 0
LF_BATCH, LF_NEW, LF_RECENCY = 2, 32, 8
LF_DECODE_STEPS = 4        # decode steps held against the CPU copy
LF_CHECK_TOKENS = 64       # bf16 vs f32 and decode vs forward: first 64
LF_F32_TOL = 1e-4          # card vs CPU copy, of max(1, max |CPU|)
LF_BF16_TOL = 0.05         # a bfloat16 block's update, of the float32 one's
LF_DVF_TOL = 1e-3          # decode vs forward (float32), of max |forward|
LF_DVF_CAPACITY = 8.0      # no token dropped (decode vs forward)
LF_TIE = 1e-5              # router probabilities this close may route apart
LF_TIE_SHARE = 0.01        # the most near-tie tokens a check may leave out
# bfloat16 against float32 end to end, max |Δ| over max |float32| logits,
# at (arch, layers): the first units of the same weights, the whole model
# last. The error grows with depth as bfloat16 rounding accumulates (the
# JAX package's too: tests/test_torch_model_families.py::
# test_bfloat16_error_grows_with_depth_as_in_jax), so each limit is 1.25
# times the larger of the two logits' readings of this phase on an NVIDIA
# H100 80GB HBM3 at 700 W, rounded up: mixtral 0.01356; mamba2 0.01727,
# 0.03827, 0.07922 at 4, 16, 64 layers; whisper 0.00833; jamba 0.04306,
# 0.06093 at 8, 16 (1 and 2 units). The control read 1.9 to 2.8 times the
# readings.
LF_BF16_LIMITS = {
    ("mixtral-8x7b", 4): 0.017,
    ("mamba2-2.7b", 4): 0.022, ("mamba2-2.7b", 16): 0.048,
    ("mamba2-2.7b", 64): 0.099,
    ("whisper-tiny", 4): 0.011,
    ("jamba-1.5-large-398b", 8): 0.054, ("jamba-1.5-large-398b", 16): 0.077,
}
LF_CONTROL_BITS = 5        # the control's weights: 5 of bfloat16's 7 bits


class RouteLog:
    """Record every ``moe.route`` call made inside the ``with``: the chosen
    experts (sorted), the gap between the K-th and (K+1)-th router
    probabilities of each token, on the host, and the choice as made (on
    the device). With ``replay`` (another log's ``chosen``), call i takes
    that log's experts instead of its own, weighted by its own router
    probabilities; ``own`` then records the experts it would have chosen
    (sorted, on the host)."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self.chosen, self.own = [], [], []
        self._moe, inner = moe, moe.route

        def route(p, h, cfg):
            probs, top_w, top_e = inner(p, h, cfg)
            if self.replay is not None:
                self.own.append(top_e.sort(-1).values.cpu())
                top_e = self.replay[len(self.chosen)]
                top_w = torch.gather(probs, -1, top_e)
                top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True),
                                                1e-9)
            srt = torch.sort(probs, dim=-1, descending=True).values
            K = cfg.experts_per_token
            self.calls.append((top_e.sort(-1).values.cpu(),
                               (srt[..., K - 1] - srt[..., K]).cpu()))
            self.chosen.append(top_e)
            return probs, top_w, top_e
        self._inner, moe.route = inner, route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._inner


def lf_route_diff(a, b, label: str):
    """Two routing records of one call (experts (B, S, K), gaps (B, S)):
    (tokens routed apart (B, S) bool, near-tie tokens (B, S) bool). Every
    token routed apart must be a near tie."""
    (ea, ga), (eb, gb) = a, b
    check(ea.shape == eb.shape, f"{label}: routing shapes {tuple(ea.shape)} "
          f"/ {tuple(eb.shape)}")
    apart = (ea != eb).any(-1)
    near = torch.minimum(ga, gb) < LF_TIE
    check(bool((~apart | near).all()), f"{label}: {int((apart & ~near).sum())}"
          f" tokens route to other experts with a router gap past {LF_TIE}")
    return apart, near


def lf_cache_leaves(tree, path=""):
    """(path, leaf) of every cache leaf (``KVCache`` or ``SSMCache``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in lf_cache_leaves(
            tree[k], f"{path}/{k}")]
    return [(path, tree)]


def lf_card_vs_cpu(cfg32, params, n_units: int, prompts, enc, dev) -> dict:
    """float32, the first ``n_units`` units on the card against a CPU copy:
    the routing first (MoE), then the prefill's and LF_DECODE_STEPS decode
    steps' logits and the caches, within LF_F32_TOL; a row with a token
    routed apart at a near tie is left out from then on."""
    import dataclasses
    from repro_torch.models import LM
    n_layers = n_units * (cfg32.hybrid_period or 1)
    cfg = dataclasses.replace(cfg32, n_layers=n_layers)
    card, cpu = LM(cfg, device=dev), LM(cfg, device="cpu")
    p_card, p_cpu = (lm_params_slice(params, n_units, d)
                     for d in (dev, "cpu"))
    live = slice(0, cfg.vocab)
    # the CPU copy picks the tokens; the card decodes the same ones
    with RouteLog() as rc:
        lc, sc = cpu.prefill(p_cpu, prompts, enc_embeds=enc)
        steps_c, toks = [lc], []
        for _ in range(LF_DECODE_STEPS):
            toks.append(lc[:, -1].argmax(-1).to(torch.int32)[:, None]
                        .numpy())
            lc, sc = cpu.decode_step(p_cpu, toks[-1], sc)
            steps_c.append(lc)
    with RouteLog() as rg:
        lg, sg = card.prefill(p_card, prompts, enc_embeds=enc)
        steps_g = [lg]
        for nxt in toks:
            lg, sg = card.decode_step(p_card, nxt, sg)
            steps_g.append(lg)
    out = {"layers": n_layers, "moe_calls": len(rc.calls)}
    apart_rows = torch.zeros(LF_BATCH, dtype=torch.bool)
    n_tok = n_near = n_apart = 0
    per_step = len(rc.calls) // (1 + LF_DECODE_STEPS)
    check(len(rg.calls) == len(rc.calls), f"card vs CPU: {len(rg.calls)} / "
          f"{len(rc.calls)} routing calls")
    errs, left_out = [], []
    for s, (g, c) in enumerate(zip(steps_g, steps_c)):
        for i in range(s * per_step, (s + 1) * per_step):
            apart, near = lf_route_diff(rg.calls[i], rc.calls[i],
                                        f"card vs CPU, routing call {i}")
            apart_rows |= apart.any(-1)
            n_tok += near.numel()
            n_near += int(near.sum())
            n_apart += int(apart.sum())
        keep = ~apart_rows
        left_out.append(int(apart_rows.sum()))
        errs.append(lm_rel(g[keep][..., live], c[keep][..., live])
                    if keep.any() else 0.0)
    out.update(logits_rel=errs, rows_left_out=left_out,
               routed_apart=n_apart, near_ties=n_near, routed_tokens=n_tok)
    if n_tok:
        check(n_near <= LF_TIE_SHARE * n_tok, f"card vs CPU: {n_near} of "
              f"{n_tok} tokens are router near-ties")
    check(left_out[-1] < LF_BATCH, "card vs CPU: every row left out")
    cache_errs = {}
    if not apart_rows.any():
        for (path, a), (_, b) in zip(lf_cache_leaves(sg.caches),
                                     lf_cache_leaves(sc.caches)):
            for name in a._fields[:-1]:
                cache_errs[f"{path}.{name}"] = lm_rel(getattr(a, name),
                                                      getattr(b, name))
            check(torch.equal(a.pos.cpu(), b.pos), f"{path}.pos differs")
    out["cache_rel"] = max(cache_errs.values()) if cache_errs else None
    check(max(errs) <= LF_F32_TOL and (out["cache_rel"] or 0.0)
          <= LF_F32_TOL, f"float32 card vs CPU copy at {n_layers} layers: "
          f"logits {errs}, caches {out['cache_rel']} > {LF_F32_TOL}")
    return out


def lf_positions_apart(fwd, dec, n_moe: int, S: int):
    """Positions (B, S) whose routing differs between a forward run's log
    (one call a MoE layer over S tokens) and a decode run's (S steps of one
    call a layer), each a near tie; (apart, near-tie count)."""
    apart = torch.zeros((LF_BATCH, S), dtype=torch.bool)
    n_near = 0
    for t in range(S):
        for lyr in range(n_moe):
            ef, gf = fwd[lyr]
            a, near = lf_route_diff(
                (ef[:, t:t + 1], gf[:, t:t + 1]), dec[t * n_moe + lyr],
                f"decode vs forward, layer {lyr} position {t}")
            apart[:, t] |= a[:, 0]
            n_near += int(near.sum())
    return apart, n_near


def lf_bf16_blocks(lm16, lm32, params16, params, toks, enc) -> dict:
    """bfloat16 (the config's) against float32, block by block at full
    depth on the card: every encoder layer, decoder layer (a unit's head
    layers and tail repeats too) and cross-attention layer is fed the
    float32 run's input (rounded to bfloat16 for the bfloat16
    block), and its update (output minus input) held within LF_BF16_TOL of
    the float32 update's max. Routing is a choice, not a rounding: the
    bfloat16 block takes the float32 block's experts (weighted by its own
    router), and the token-layers whose own bfloat16 choice differs are
    counted."""
    from repro_torch.models.transformer import (_apply_layer, _unit_split,
                                                _unstack, attention_forward,
                                                dense_ffn)
    cfg = lm32.cfg
    bf16 = torch.bfloat16

    def encoder_layer(p, h):
        return dense_ffn(p["ffn"], attention_forward(p["attn"], h, cfg,
                                                     causal=False), cfg)

    def blocks(p, enc_out):
        """(name, fn(x)) of every block in order, on params ``p``."""
        out = [(f"encoder{i}", partial(encoder_layer, q))
               for i, q in enumerate(_unstack(p["encoder"],
                                              cfg.encoder_layers))
               ] if cfg.encoder_layers else []
        head, reps, tail = _unit_split(cfg)
        for u, (pu, pc) in enumerate(lm32._units(p)):
            layers = [(f"unit{u}.head.layer{j}", pu["head"][f"layer{j}"])
                      for j in range(len(head))]
            for r, pr in enumerate(_unstack(pu["tail"], reps) if reps
                                   else []):
                layers += [(f"unit{u}.tail{r}.layer{j}", pr[f"layer{j}"])
                           for j in range(len(tail))]
            out += [(name, lambda x, q=q: _apply_layer(q, x, cfg, False)[0])
                    for name, q in layers]
            if pc is not None:
                out.append((f"cross{u}", lambda x, pc=pc: attention_forward(
                    pc["attn"], x, cfg, causal=False, kv_from=enc_out[0])))
        return out

    enc32, enc16 = [None], [None]      # the encoder states, once known
    b32, b16 = blocks(params, enc32), blocks(params16, enc16)
    x = params["embed"][torch.as_tensor(toks, device=lm32.device).long()]
    xe = None if enc is None else torch.as_tensor(enc, device=lm32.device)
    rels, apart, routed = {}, 0, 0
    for (name, f32), (_, f16) in zip(b32, b16):
        h = xe if name.startswith("encoder") else x
        with RouteLog() as r32:
            y32 = f32(h)
        with RouteLog(replay=r32.chosen) as r16:
            y16 = f16(h.to(bf16))
        check(y16.dtype == bf16 and y32.dtype == torch.float32,
              f"{name}: {y16.dtype} / {y32.dtype}")
        d32 = y32 - h
        d16 = y16.float() - h.to(bf16).float()
        rels[name] = float((d16 - d32).abs().max()) / float(d32.abs().max())
        apart += sum(int((own != e).any(-1).sum())
                     for own, (e, _) in zip(r16.own, r32.calls))
        routed += sum(int(e[..., 0].numel()) for e, _ in r32.calls)
        if name.startswith("encoder"):
            xe = y32
            if name == f"encoder{cfg.encoder_layers - 1}":
                enc32[0], enc16[0] = y32, y32.to(bf16)
        else:
            x = y32
    worst = max(rels, key=rels.get)
    out = {"blocks": len(rels), "max_update_rel": rels[worst],
           "worst_block": worst, "median_update_rel": float(
               np.median(list(rels.values()))),
           "token_layers_bf16_would_route_apart": apart,
           "routed_token_layers": routed}
    check(rels[worst] <= LF_BF16_TOL, f"bfloat16 vs float32, {worst}: its "
          f"update within {rels[worst]} of the float32 update's max, past "
          f"{LF_BF16_TOL}")
    return out


def lf_round_mantissa(t: torch.Tensor, bits: int) -> torch.Tensor:
    """A bfloat16 ``t`` rounded to nearest at ``bits`` of its 7 mantissa
    bits (other dtypes as they are): the control's coarser weights."""
    if t.dtype != torch.bfloat16:
        return t
    drop = 23 - bits
    i = t.float().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32).to(torch.bfloat16)


def lf_bf16_end_to_end(lm16, lm32, params16, params, prompts, enc,
                       limit: float) -> dict:
    """bfloat16 against float32 end to end on the card: the prefill's
    last-token logits (phase 23's comparison) and the forward logits over
    the first LF_CHECK_TOKENS tokens, each max |Δ| over max |float32|
    within ``limit``, the bfloat16 run on the float32 run's experts. The
    control, the same bfloat16 run on its weights rounded to
    LF_CONTROL_BITS mantissa bits, must read past ``limit``: the limit
    fails an error a few times bfloat16's own."""
    from repro_torch.models.transformer import tree_map
    V = lm32.cfg.vocab
    control = tree_map(partial(lf_round_mantissa, bits=LF_CONTROL_BITS),
                       params16)
    out = {"layers": lm32.cfg.n_layers, "limit": limit}
    for name, run in (
            ("prefill_last", lambda lm, p: lm.prefill(p, prompts, enc)[0]),
            ("forward_first_tokens", lambda lm, p: lm.forward(
                p, prompts[:, :LF_CHECK_TOKENS], enc_embeds=enc))):
        with RouteLog() as r32:
            l32 = run(lm32, params)
        with RouteLog(replay=r32.chosen):
            l16 = run(lm16, params16)
        with RouteLog(replay=r32.chosen):
            lc = run(lm16, control)
        check(l16.dtype == lc.dtype == torch.bfloat16
              and l32.dtype == torch.float32,
              f"{name} logits {l16.dtype} / {lc.dtype} / {l32.dtype}")
        a, c, b = (x[..., :V].float().cpu() for x in (l16, lc, l32))
        scale = float(b.abs().max())
        out[name] = {
            "positions": int(b[..., 0].numel()),
            "logits_rel": float((a - b).abs().max()) / scale,
            "control_rel": float((c - b).abs().max()) / scale,
            "argmax_agree_share": float((a.argmax(-1) == b.argmax(-1))
                                        .float().mean())}
    del control
    names = ("prefill_last", "forward_first_tokens")
    worst = max(out[n]["logits_rel"] for n in names)
    control = min(out[n]["control_rel"] for n in names)
    check(worst <= limit, f"bfloat16 vs float32 at {out['layers']} layers: "
          f"logits within {worst} of max |float32|, past {limit}")
    check(control > limit, f"bfloat16 vs float32 at {out['layers']} layers: "
          f"the control ({LF_CONTROL_BITS} mantissa bits) reads {control}, "
          f"not past the limit {limit}")
    return out


def lf_bf16_vs_f32(arch, lm16, lm32, params16, params, prompts, enc) -> dict:
    """bfloat16 (the config's) against float32 on the card at every depth
    of LF_BF16_LIMITS for ``arch`` (the first units of the same weights,
    the whole model last), end to end (``lf_bf16_end_to_end``), then block
    by block at full depth (``lf_bf16_blocks``)."""
    import dataclasses
    from repro_torch.models import LM
    cfg = lm32.cfg
    out = {"limits_at_layers": {}}
    for n in sorted(n for a, n in LF_BF16_LIMITS if a == arch):
        if n == cfg.n_layers:
            e = lf_bf16_end_to_end(lm16, lm32, params16, params, prompts,
                                   enc, LF_BF16_LIMITS[arch, n])
        else:
            units = n // (cfg.hybrid_period or 1)
            e = lf_bf16_end_to_end(*(
                LM(dataclasses.replace(x.cfg, n_layers=n), device=x.device)
                for x in (lm16, lm32)), *(
                lm_params_slice(p, units, lm32.device)
                for p in (params16, params)), prompts, enc,
                LF_BF16_LIMITS[arch, n])
        out["limits_at_layers"][n] = e
    check(cfg.n_layers in out["limits_at_layers"], f"{arch}: no bfloat16 "
          f"limit at its {cfg.n_layers} layers")
    out["blocks"] = lf_bf16_blocks(lm16, lm32, params16, params,
                                   prompts[:, :LF_CHECK_TOKENS], enc)
    return out


def lf_decode_vs_forward(lm32, params, toks, enc, dev) -> dict:
    """float32 token-by-token decode from an empty state against forward
    over the same tokens, full depth, on the card (MoE at capacity factor
    LF_DVF_CAPACITY: no token dropped), within LF_DVF_TOL of max |forward|;
    positions routed apart at a near tie are left out."""
    import dataclasses
    from repro_torch.models import LM
    cfg = lm32.cfg
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=LF_DVF_CAPACITY)
    lm = LM(cfg, device=dev)
    S = toks.shape[1]
    with RouteLog() as rf:
        full = lm.forward(params, toks, enc_embeds=enc)[..., :cfg.vocab]
    state = lm.init_decode_state(LF_BATCH, S, enc_embeds=enc, params=params)
    outs = []
    with RouteLog() as rd:
        for t in range(S):
            lg, state = lm.decode_step(params, toks[:, t:t + 1], state)
            outs.append(lg[:, 0, :cfg.vocab])
    n_moe = len(rf.calls)
    apart, n_near = lf_positions_apart(rf.calls, rd.calls, n_moe, S)
    keep = (~apart).to(full.device)
    dec = torch.stack(outs, 1)
    rel = float((dec[keep] - full[keep]).abs().max()) / \
        float(full.abs().max())
    out = {"tokens": S, "logits_rel": rel, "positions_routed_apart":
           int(apart.sum()), "near_ties": n_near}
    check(n_near <= LF_TIE_SHARE * max(1, n_moe * LF_BATCH * S),
          f"decode vs forward: {n_near} near-tie tokens")
    check(rel <= LF_DVF_TOL, f"decode vs forward: {rel} > {LF_DVF_TOL}")
    return out


def lf_ssm_kept(before, after, label: str) -> int:
    """Every ``SSMCache`` of a compacted state is the prefill state's, bit
    for bit; returns how many there are."""
    n = 0
    for (path, a), (_, b) in zip(lf_cache_leaves(before.caches),
                                 lf_cache_leaves(after.caches)):
        if hasattr(a, "conv"):
            n += 1
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"{label}: {path} changed in compaction")
    return n


def lf_kernels_vs_plain(method: str, before, kept, cfg, prompt: int,
                        budget: int, attn_units: int) -> dict:
    """The path's kernels at this family's shapes against their plain
    versions, on the first and the last attention unit's heads (every row
    and KV head) of the prefill cache ``before`` with the positions
    ``kept`` (``lm_kept_positions``). "sample": each head replayed through
    ``kv_head_replay`` (``phase2_select`` at B = 1, N = prompt, k = budget
    − recency, as compaction launches it; its picks among the kept ones),
    all of them against the plain phase 2 on a CPU copy. "map": each unit's
    (B·KV, N, N) stack of head kernels in one ``greedy_map_kdpp`` launch,
    as compaction launches it, against ``greedy_map_kdpp_plain`` on a CPU
    copy, each head's own single launch bit for bit, and the kept
    positions its picks with the recency window."""
    from repro_torch.kernels import greedy_map as gm
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.serve.kv_compaction import token_kernel
    KV, k = cfg.n_kv_heads, budget - LF_RECENCY
    cache = before.caches["head"]["layer0"]
    units = sorted({0, attn_units - 1})
    pairs = list(itertools.product(range(LF_BATCH), range(KV)))
    out = {"units": units, "heads": len(units) * len(pairs), "N": prompt,
           "k": k}
    if method == "sample":
        hkeys = lm_sample_head_keys(LF_SEED, attn_units, LF_BATCH, KV)
        ins = [kv_head_replay(cache.k[u, b, :, h], LF_RECENCY, prompt,
                              hkeys[u, b, h], kept[u, b, h],
                              f"{cfg.name} sample head (unit {u}, b {b}, "
                              f"h {h})")
               for u in units for b, h in pairs]
        us, ke, G1, Gr = (torch.cat([x[0][j] for x in ins]).cpu()
                          for j in range(4))
        pp = p2.phase2_select_plain(us, ke, G1, Gr).numpy()
        out["route"] = p2.phase2_select_route(prompt, 1, k)
        out["vs_cpu_plain"] = compare_picks(
            torch.cat([x[1] for x in ins]).cpu().numpy(), pp, us, ke, G1, Gr,
            f"{cfg.name} KV heads, phase2_select vs the plain phase 2 on a "
            f"CPU copy")
        return out
    recent = set(range(prompt - LF_RECENCY, prompt))
    out["vs_cpu_plain"] = []
    for u in units:
        L = torch.stack([token_kernel(cache.k[u, b, :, h], LF_RECENCY,
                                      prompt, "map")[0] for b, h in pairs])
        picks = gm.greedy_map_kdpp_cuda(L, k)
        plain = gm.greedy_map_kdpp_plain(L.cpu(), k).numpy()
        got = picks.cpu().numpy()
        for i, (b, h) in enumerate(pairs):
            label = f"{cfg.name} map unit {u} head ({b}, {h})"
            check(torch.equal(gm.greedy_map_kdpp_cuda(L[i], k), picks[i]),
                  f"{label}: the batched launch of {len(pairs)} differs "
                  f"from its single launch")
            check(sorted(set(got[i].tolist()) | recent) ==
                  kept[u, b, h].tolist(), f"{label}: the kept positions "
                  f"are not the batched picks and the recency window")
            out["vs_cpu_plain"].append(compare_maps(L[i].cpu(), got[i],
                                                    plain[i], label,
                                                    quiet=True))
    out["identical"] = sum(r["identical"] for r in out["vs_cpu_plain"])
    out["vs_cpu_plain"] = [r for r in out["vs_cpu_plain"]
                           if not r["identical"]]
    print(f"  {cfg.name} map: {out['identical']} of {out['heads']} heads' "
          f"batched picks (H = {len(pairs)}, N = {prompt}, k = {k}) the "
          f"plain version's on a CPU copy; the rest proven ties")
    return out


def lf_step_profile(lm, params16, prompts, enc, dev) -> dict:
    """One bfloat16 decode step after a prefill: its host-clock time (CUDA
    events around 5 steps), its device time (``torch.profiler``: every
    kernel, copy and fill), the idle share and its top operations."""
    _, state = lm.prefill(params16, prompts, enc_embeds=enc)
    tok = torch.zeros((LF_BATCH, 1), dtype=torch.int32, device=dev)

    def step():
        return lm.decode_step(params16, tok, state)
    names = {}
    wall = cuda_ms(step, reps=5, warmup=2)
    dev_ms = device_ms(step, reps=3, warmup=1, by_name=names)
    events = names.pop("events")
    return {"step_ms": wall, "step_device_ms": dev_ms,
            "step_idle_share": 1.0 - dev_ms / wall,
            "step_device_events": events,
            "step_top_ops_ms": {k[:80]: v for k, v in sorted(
                names.items(), key=lambda kv: -kv[1])[:10]}}


@torch.inference_mode()
def lm_family(arch, overrides, prompt, budget, cpu_units, reduced, dev,
              card: str, power_limit: str) -> dict:
    """One family of phase 26 (see LF_CONFIGS)."""
    import dataclasses
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.transformer import _unit_layout
    from repro_torch.serve import ServeEngine
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **overrides)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    lm, lm32 = LM(cfg, device=dev), LM(cfg32, device=dev)
    n_units, kinds = _unit_layout(cfg)
    attn_units = n_units if cfg.n_heads else 0
    heads = attn_units * LF_BATCH * cfg.n_kv_heads
    out = {"arch": arch, "reduced": reduced, "shapes": {
        "layers": cfg.n_layers, "units": n_units, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
        "d_ff": cfg.d_ff, "experts": cfg.n_experts,
        "top_k": cfg.experts_per_token, "ssm_state": cfg.ssm_state,
        "encoder_layers": cfg.encoder_layers, "encoder_seq": cfg.encoder_seq,
        "vocab_padded": cfg.vocab_padded, "dtype": cfg.dtype,
        "batch": LF_BATCH, "prompt": prompt, "new": LF_NEW,
        "budget": budget, "recency": LF_RECENCY, "kv_heads_a_run": heads},
        "card": card, "power_limit": power_limit}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(prng.PRNGKey(LF_SEED, dev))
    out["params"] = sum(int(a.numel()) for a in lm_leaves(params))
    out["init_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(LF_SEED)
    enc = None
    if cfg.encoder_layers:
        enc = rng.standard_normal((LF_BATCH, cfg.encoder_seq, cfg.d_model)
                                  ).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab, (LF_BATCH, prompt), dtype=np.int32)
    print(f"  {arch}: {out['params']} parameters (float32), init "
          f"{out['init_s']:.1f} s; {card}, {power_limit}")

    # (1) float32, the card against a CPU copy
    out["card_vs_cpu_f32"] = lf_card_vs_cpu(
        cfg32, params, cpu_units or n_units, prompts, enc, dev)
    print(f"  {arch} float32 card vs CPU copy: "
          f"{json.dumps(out['card_vs_cpu_f32'])}")

    # (2) bfloat16 against float32, (3) decode against forward
    params16 = lm._cast(params)
    out["bf16_vs_f32"] = lf_bf16_vs_f32(arch, lm, lm32, params16, params,
                                        prompts, enc)
    out["decode_vs_forward"] = lf_decode_vs_forward(
        lm32, params, prompts[:, :LF_CHECK_TOKENS], enc, dev)
    print(f"  {arch} bfloat16 vs float32: {json.dumps(out['bf16_vs_f32'])}; "
          f"decode vs forward: {json.dumps(out['decode_vs_forward'])}")
    del params
    gc.collect()

    # (4) the serving path, bfloat16, greedy: "sample" and "map"
    engine = ServeEngine(lm, params16, seed=LF_SEED, device=dev)
    engine.generate(prompts[:, :16], 2, enc_embeds=enc)          # warm-up
    runs, launches, ssm_kept, replay = {}, {}, {}, {}
    expect = {"sample": ({"phase2_select", "threefry2x32"} if heads
                         else {"threefry2x32"}),
              "map": {"greedy_map_kdpp"} if heads else set()}
    for method in ("sample", "map"):
        eng = ServeEngine(lm, params16, seed=LF_SEED, device=dev)
        seen = lm_capture(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before_gb = torch.cuda.memory_allocated(dev) / 2 ** 30
        res, n = sv_counted(lambda: eng.generate(
            prompts, LF_NEW, enc_embeds=enc, kv_budget=budget,
            kv_recency=LF_RECENCY, kv_method=method),
            f"{arch} generate, {method} compaction", expect[method])
        res["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(
            dev) / 2 ** 30
        res["memory_allocated_before_gb"] = before_gb
        tok = res.pop("tokens")
        check(tok.shape == (LF_BATCH, LF_NEW) and (tok >= 0).all()
              and (tok < cfg.vocab).all(), f"{arch} {method}: tokens "
              f"{tok.shape}, range [{tok.min()}, {tok.max()}]")
        res["tokens_first_row"] = tok[0, :8].tolist()
        check(len(seen) == 1, f"{arch} {method}: {len(seen)} compactions")
        _, before, after = seen[0]
        ssm_kept[method] = lf_ssm_kept(before, after, f"{arch} {method}")
        if heads:
            kept = lm_kept_positions(before, after, f"{arch} {method} "
                                     f"compaction", budget=budget,
                                     recency=LF_RECENCY)
            replay[method] = lf_kernels_vs_plain(method, before, kept, cfg,
                                                 prompt, budget, attn_units)
        runs[method], launches[method] = res, n
        del seen, before, after
    n_s, n_m = launches["sample"], launches["map"]
    want_tf = 1 + (2 * attn_units + heads if heads else 0)
    check(n_s["phase2_select"] == heads and n_s["threefry2x32"] == want_tf,
          f"{arch}: sample compaction launched phase 2 "
          f"{n_s['phase2_select']} and threefry2x32 {n_s['threefry2x32']} "
          f"times, not {heads} (one a unit, row and KV head) and {want_tf}")
    check(n_m["greedy_map_kdpp"] == attn_units, f"{arch}: map compaction "
          f"launched greedy_map_kdpp {n_m['greedy_map_kdpp']} times, not "
          f"{attn_units} (one a unit)")
    check(all((n > 0) == (cfg.ssm_state > 0) for n in ssm_kept.values()),
          f"{arch}: SSM caches kept bit for bit {ssm_kept}")
    out["ssm_caches_kept_bitwise"] = ssm_kept
    out["kernels_vs_plain"] = replay
    out["runs"] = runs
    out["launches_per_request"] = {
        m: {k: v for k, v in n.items() if v} for m, n in launches.items()}
    out["prefill_s"] = runs["map"]["prefill_s"]
    out["compact_s"] = {m: runs[m]["compact_s"] for m in runs}
    out["decode_s"] = runs["map"]["decode_s"]
    out["decode_tok_per_s"] = runs["map"]["decode_tok_per_s"]
    out["max_memory_allocated_gb"] = max(
        r["max_memory_allocated_gb"] for r in runs.values())

    # (5) one decode step on the device
    out.update(lf_step_profile(lm, params16, prompts, enc, dev))
    out["phase_s"] = time.perf_counter() - t0
    print(f"  {arch} ({card}, {power_limit}): prefill "
          f"{out['prefill_s']:.4f} s, compact sample "
          f"{out['compact_s']['sample']:.4f} s / map "
          f"{out['compact_s']['map']:.4f} s, decode "
          f"{out['decode_tok_per_s']:.1f} tokens/s, peak "
          f"{out['max_memory_allocated_gb']:.2f} GiB, launches "
          f"{json.dumps(out['launches_per_request'])}; a decode step "
          f"{out['step_ms']:.2f} ms, device {out['step_device_ms']:.2f} ms "
          f"(idle {out['step_idle_share']:.2f}, "
          f"{out['step_device_events']:.0f} events); top "
          f"{json.dumps({k[:40]: round(v, 3) for k, v in out['step_top_ops_ms'].items()})}")
    del engine, params16
    gc.collect()          # lm_capture's wrapper and its engine form a cycle
    torch.cuda.empty_cache()
    return out


def lm_families_path(dev, card: str, power_limit: str) -> dict:
    """Phase 26: the MoE, SSM, hybrid and encoder-decoder families through
    the port's LM stack and ``ServeEngine`` (see LF_CONFIGS). Returns what
    the ``lm_families`` line prints."""
    t0 = time.perf_counter()
    out = {arch: lm_family(arch, ov, prompt, budget, cpu_units, reduced,
                           dev, card, power_limit)
           for arch, ov, prompt, budget, cpu_units, reduced in LF_CONFIGS}
    out["phase_s"] = time.perf_counter() - t0
    print(f"LM families (phase 26): {out['phase_s']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# phase 27: sharded LM training (DTensor placements on an NCCL group)
# ---------------------------------------------------------------------------

LS_STEPS = 3               # sharded steps, each against the unsharded step
LS_TIMED = slice(1, None)  # the steps whose median is the step time: 2-3
LS_LEAVES = ("embed", "blocks/head/layer0/attn/wq",
             "blocks/head/layer0/attn/wo", "blocks/head/layer0/ffn/w_up",
             "ln_f")
# bfloat16 loss and grad norm of the first step, sharded against
# unsharded, of max(1, |unsharded|). On an NVIDIA H100 80GB HBM3 at 700 W
# they read 0 and 4.27e-5 (the same in two runs), and the float32 sharded
# step, the control, parts from the bfloat16 step by 2.09e-5 and 5.35e-4
# (PERF.md §6): the limit lies between, 2.3x the reading.
LS_BF16_TOL = 1e-4


def ls_full(tree):
    """Every DTensor leaf of a params tree as its full tensor."""
    from repro_torch.models.transformer import tree_map
    return tree_map(lambda a: a.full_tensor(), tree)


def ls_compression(dev) -> dict:
    """``_quantize``, ``int8_psum`` and ``int8_allreduce_grads`` (twice, the
    residual carried) over the world-1 group: bit for bit the local
    quantization, its residual and its int32 codes times its scale."""
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.optim import int8_allreduce_grads
    from repro_torch.optim.compression import _quantize, int8_psum
    mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(27)
    grads = {"w": torch.randn((896, 4864), generator=gen, device=dev),
             "b": torch.randn((896,), generator=gen, device=dev) * 1e-3,
             "zero": torch.zeros((7,), device=dev)}
    red, res = int8_allreduce_grads(grads, mesh, ("data",))
    red2, _ = int8_allreduce_grads(grads, mesh, ("data",), res)
    ok = {}
    for k, g in grads.items():
        q, s = _quantize(g)
        deq = q.float() * s
        q2, s2 = _quantize(g + (g - deq))
        ok[k] = (same_bits(red[k], deq) and same_bits(res[k], g - deq)
                 and same_bits(red2[k], q2.float() * s2)
                 and same_bits(int8_psum(g, mesh.get_group("data")),
                               q.to(torch.int32).float() * s))
    check(all(ok.values()), f"int8 compression over the world-1 group "
          f"against the local quantization: {ok}")
    return {"bitwise": ok, "shapes": {k: list(g.shape)
                                      for k, g in grads.items()}}


def ls_bf16_step(mesh, tokens, f32_first: dict, dev) -> dict:
    """One sharded step in the config's bfloat16 compute against the
    unsharded bfloat16 step, from phase 24's params on the first batch:
    loss and grad norm within ``LS_BF16_TOL``. The control is the float32
    sharded step on the same params and batch (``f32_first``), a sharded
    step with every cast to bfloat16 left out: it must part from the
    unsharded bfloat16 step by more than the limit."""
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, OptState, cosine_schedule
    from repro_torch.train import make_train_step
    cfg = get_config(LM_ARCH)
    lm = LM(cfg, device=dev)
    params = lm.init_params(prng.PRNGKey(LM_SEED, dev))
    opt = AdamW(lr=LT_LR, schedule=cosine_schedule(
        max(LT_STEPS // 10, 1), LT_STEPS))
    ost = opt.init(params)
    policy = ShardingPolicy(mesh, cfg)
    ps = policy.params_shardings(params)
    batch = {"tokens": tokens}
    step = make_train_step(lm, opt)
    _, _, dm = step(distribute(params, ps),
                    distribute(ost, OptState(policy.replicated(), ps, ps)),
                    distribute(batch, policy.batch_shardings(batch)))
    sharded = {k: float(dm[k].full_tensor()) for k in ("loss", "grad_norm")}
    del dm
    _, _, m = step(params, ost, batch)
    want = {k: float(m[k]) for k in ("loss", "grad_norm")}
    rel = {k: abs(sharded[k] - want[k]) / max(1.0, abs(want[k]))
           for k in want}
    control = {k: abs(f32_first[k] - want[k]) / max(1.0, abs(want[k]))
               for k in want}
    check(max(rel.values()) <= LS_BF16_TOL, f"bfloat16 sharded step against "
          f"the unsharded bfloat16 step: {rel} > {LS_BF16_TOL}")
    check(max(control.values()) > LS_BF16_TOL, f"control: the float32 "
          f"sharded step against the unsharded bfloat16 step, {control}, "
          f"within the bfloat16 limit {LS_BF16_TOL}")
    return {"dtype": cfg.dtype, "sharded": sharded, "unsharded": want,
            **{f"{k}_rel": v for k, v in rel.items()},
            "control_float32_rel": control, "tol": LS_BF16_TOL}


def lm_sharded_path(dev, phase24_step_s: float) -> dict:
    """Phase 27: sharded LM training on an NCCL group of one rank (see the
    module docstring). Returns what the ``sharded_train`` line prints."""
    import datetime
    import statistics
    import torch.distributed as dist
    import repro_torch.obs as obs
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, synthetic_corpus
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.sharding import distribute, path_leaves
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, OptState, cosine_schedule
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_train_step
    import dataclasses
    t_phase = time.perf_counter()
    store_dir = ROOT / "build" / "sharded_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    store = dist.FileStore(str(store_dir / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        # float32 compute: phase 24's float32 rule holds the two steps
        cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"))
        out = {"arch": LM_ARCH, "mesh": {"shape": list(mesh.shape),
                                         "axes": list(mesh.mesh_dim_names),
                                         "backend": dist.get_backend()},
               "shapes": {"layers": cfg.n_layers, "d_model": cfg.d_model,
                          "dtype": cfg.dtype, "batch": LT_BATCH,
                          "seq": LT_SEQ, "docs": LT_DOCS,
                          "steps": LS_STEPS}}
        lm = LM(cfg, device=dev)
        params = lm.init_params(prng.PRNGKey(LM_SEED, dev))
        opt = AdamW(lr=LT_LR, schedule=cosine_schedule(
            max(LT_STEPS // 10, 1), LT_STEPS))
        ost = opt.init(params)
        policy = ShardingPolicy(mesh, cfg)
        ps = policy.params_shardings(params)
        dparams = distribute(params, ps)
        dost = distribute(ost, OptState(policy.replicated(), ps, ps))
        placed = [*tree_leaves(dparams), *tree_leaves(dost)]
        check(all(isinstance(a, DTensor) and a.to_local().is_cuda
                  for a in placed), "a placed tensor's local shard is not "
              "on the card")
        named = dict(path_leaves(dparams))
        out["placements"] = {k: [str(p) for p in named[k].placements]
                             for k in LS_LEAVES}
        out["specs"] = {k: [str(e) for e in ps_k.spec] for k, ps_k in
                        path_leaves(ps) if k in LS_LEAVES}
        out["opt_step_placements"] = [str(p) for p in dost.step.placements]

        # the batches: phase 24's corpus and selector, counted
        corpus = synthetic_corpus(LT_DOCS, LT_SEQ, cfg.vocab, LM_SEED)
        sel = lt_selector(corpus, cfg, dev)
        pipe = TokenPipeline(corpus, LT_BATCH, LM_SEED, sel)
        tracker = obs.InMemoryTracker()
        draws = iter(pipe)
        with obs.use(tracker):
            batches, n = sv_counted(
                lambda: [next(draws) for _ in range(LS_STEPS)],
                "LM sharded train batches",
                {"phase2_select", "threefry2x32"})
        plain = int(tracker.counter_value("kernels.phase2_select.reference"))
        check(n["phase2_select"] == 1 and plain == 0, f"LM sharded train: "
              f"{n['phase2_select']} phase-2 launches for {LS_STEPS} "
              f"batches, {plain} plain calls")
        out["launches"] = n
        out["plain_phase2_calls"] = plain

        step = make_train_step(lm, opt)
        s_times, u_times, per_step = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for i, batch in enumerate(batches):
            batch = {"tokens": torch.as_tensor(batch["tokens"], device=dev)}
            dbatch = distribute(batch, policy.batch_shardings(batch))
            t0 = time.perf_counter()
            dparams, dost, dm = step(dparams, dost, dbatch)
            torch.cuda.synchronize()
            s_times.append(time.perf_counter() - t0)
            if i == 0:
                out["max_memory_allocated_gb"] = \
                    torch.cuda.max_memory_allocated(dev) / 2 ** 30
            t0 = time.perf_counter()
            params, ost, m = step(params, ost, batch)
            torch.cuda.synchronize()
            u_times.append(time.perf_counter() - t0)
            rel = {k: abs(float(dm[k].full_tensor()) - float(m[k]))
                   / max(1.0, abs(float(m[k]))) for k in ("loss",
                                                          "grad_norm")}
            gap = lt_params_gap(ls_full(dparams), params)
            check(max(rel.values()) <= LT_F32_TOL, f"sharded step {i + 1} "
                  f"against the unsharded step: {rel} > {LT_F32_TOL}")
            lt_check_gap(gap, i + 1, f"sharded step {i + 1} against the "
                         f"unsharded step")
            if i == 0:
                f32_first = {k: float(dm[k].full_tensor())
                             for k in ("loss", "grad_norm")}
                tokens0 = batch["tokens"]
            per_step.append({"loss": [float(dm["loss"].full_tensor()),
                                      float(m["loss"])],
                             **{f"{k}_rel": v for k, v in rel.items()},
                             "params": gap})
        check(all(a.to_local().is_cuda for a in [*tree_leaves(dparams),
                                                 *tree_leaves(dost)]),
              "the sharded step's state left the card")
        check(all(p.is_replicate() for p in dm["grad_norm"].placements),
              f"grad norm placed {dm['grad_norm'].placements}")
        out["per_step"] = per_step
        out["step_times_s"] = s_times
        out["unsharded_step_times_s"] = u_times
        out["step_s"] = statistics.median(s_times[LS_TIMED])
        out["unsharded_step_s"] = statistics.median(u_times[LS_TIMED])
        out["phase24_step_s"] = phase24_step_s
        out["tokens_per_s"] = LT_BATCH * LT_SEQ / out["step_s"]

        # the step's collectives: one more step, its result dropped
        comm = CommDebugMode()
        with comm:
            step(dparams, dost, dbatch)
        torch.cuda.synchronize()
        out["collectives"] = {str(k): v for k, v in
                              comm.get_comm_counts().items()}
        out["compression"] = ls_compression(dev)
        del params, ost, dparams, dost, m, dm, dbatch, batch
        out["bf16"] = ls_bf16_step(mesh, tokens0, f32_first, dev)
        out["phase_s"] = time.perf_counter() - t_phase
        print(f"  LM sharded train ({LM_ARCH}, full width, mesh (1, 1), "
              f"NCCL world 1): losses {[s['loss'] for s in per_step]}, "
              f"step {out['step_s'] * 1e3:.1f} ms against the unsharded "
              f"{out['unsharded_step_s'] * 1e3:.1f} ms (phase 24 "
              f"{phase24_step_s * 1e3:.1f} ms), peak "
              f"{out['max_memory_allocated_gb']:.2f} GiB, collectives "
              f"{out['collectives']}, launches {n}; bfloat16 step: loss "
              f"{out['bf16']['loss_rel']:.3g}, grad norm "
              f"{out['bf16']['grad_norm_rel']:.3g} (limit {LS_BF16_TOL}; "
              f"control {out['bf16']['control_float32_rel']})")
        print(f"LM sharded training (phase 27): {out['phase_s']:.1f} s")
        return out
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 28: the families' sharded steps and the planner
# ---------------------------------------------------------------------------

# (arch, overrides of the prefill and decode steps, overrides of the train
# step, the cuts listed under "reduced"): phase 26's configs in float32
# compute, on a (1, 1) mesh of an NCCL group of one rank, each step held
# against the unsharded step. A train step holds float32 params, grads and
# both AdamW moments for the sharded and the unsharded step, so it runs
# shallower where two such sets would not fit in the card: mixtral 1 of
# its 32 layers (4 layers are 5.8 B params, 23 GB a copy), mamba2 16 of 64,
# jamba's layout one unit of 8 layers.
LP_CONFIGS = (
    ("mixtral-8x7b", {"n_layers": 4}, {"n_layers": 1},
     {"n_layers": "4 of 32; the train step 1"}),
    ("mamba2-2.7b", {}, {"n_layers": 16},
     {"n_layers": "64; the train step 16"}),
    ("jamba-1.5-large-398b", dict(LF_CONFIGS[3][1]), {"n_layers": 8},
     {**LF_CONFIGS[3][5], "n_layers": "16 of 72 (2 units of 8); the train "
      "step 8 (1 unit)"}),
    ("whisper-tiny", {}, {}, {}),
)
LP_BATCH, LP_PROMPT, LP_DECODE = 2, 256, 4
# the planner's cells on fake CUDA shards over the 256-rank fake group, at
# full width and one unit of depth (as the reference's compile_once with
# n_layers 1): one cell of each family, every kind
LP_PLAN = (("qwen2-0.5b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
           ("mamba2-2.7b", "prefill_32k"),
           ("jamba-1.5-large-398b", "long_500k"),
           ("whisper-tiny", "decode_32k"))


def lp_rel(got, want, vocab=None) -> float:
    """max |got - want| over max(1, max |want|); logits cut to ``vocab``."""
    from torch.distributed.tensor import DTensor
    if isinstance(got, DTensor):
        got = got.full_tensor()
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def lp_state_rel(got, want) -> float:
    """The largest ``lp_rel`` over the leaves of two decode states."""
    from repro_torch.distributed.sharding import map_with_path
    leaves = {}
    map_with_path(lambda path, leaf: leaves.__setitem__(path, leaf), want)
    worst = 0.0

    def one(path, leaf):
        nonlocal worst
        worst = max(worst, lp_rel(leaf, leaves[path]))
    map_with_path(one, got)
    return worst


def lp_family(arch, serve_ov, train_ov, reduced, mesh, dev) -> dict:
    """One family of phase 28 (see LP_CONFIGS): a prefill of LP_BATCH x
    LP_PROMPT tokens and LP_DECODE greedy decode steps, sharded (outputs
    placed by the policy) and unsharded; then one train step of each."""
    import dataclasses
    from repro_torch import random as prng
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.sharding import distribute
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, OptState
    from repro_torch.train import make_serve_steps, make_train_step
    gen = torch.Generator(device=dev).manual_seed(28)
    out = {"arch": arch, "reduced": reduced, "batch": LP_BATCH,
           "prompt": LP_PROMPT, "decode_steps": LP_DECODE}

    def inputs(cfg, S):
        toks = torch.randint(0, cfg.vocab, (LP_BATCH, S), generator=gen,
                             device=dev, dtype=torch.int32)
        enc = None
        if cfg.encoder_layers:
            enc = torch.randn((LP_BATCH, cfg.encoder_seq, cfg.d_model),
                              generator=gen, device=dev)
        return toks, enc

    def placed(policy, **named):
        named = {k: v for k, v in named.items() if v is not None}
        return distribute(named, policy.batch_shardings(named))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # serving: prefill and decode, sharded against unsharded
    cfg = dataclasses.replace(get_config(arch), dtype="float32", **serve_ov)
    lm = LM(cfg, device=dev)
    params = lm.init_params(prng.PRNGKey(LF_SEED, dev))
    policy = ShardingPolicy(mesh, cfg)
    dparams = distribute(params, policy.params_shardings(params))
    prefill, decode = make_serve_steps(lm, policy)
    toks, enc = inputs(cfg, LP_PROMPT)
    d_in = placed(policy, tokens=toks, enc=enc)
    rel, times = {}, {"sharded": [], "unsharded": []}
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        (dl, dst), ts = timed(lambda: prefill(dparams, d_in["tokens"],
                                              d_in.get("enc")))
        (ul, ust), tu = timed(lambda: lm.prefill(params, toks, enc))
        times["sharded"].append(ts)
        times["unsharded"].append(tu)
        rel["prefill_logits"] = lp_rel(dl, ul, cfg.vocab)
        rel["prefill_state"] = lp_state_rel(dst, ust)
        for i in range(LP_DECODE):
            tok = ul[:, -1:, :cfg.vocab].argmax(-1).to(torch.int32)
            dtok = placed(policy, t=tok)["t"]
            (dl, dst), ts = timed(lambda: decode(dparams, dtok, dst))
            (ul, ust), tu = timed(lambda: lm.decode_step(params, tok, ust))
            times["sharded"].append(ts)
            times["unsharded"].append(tu)
            rel[f"decode{i}_logits"] = lp_rel(dl, ul, cfg.vocab)
        rel["decode_state"] = lp_state_rel(dst, ust)
    check(all(math.isfinite(v) for v in rel.values())
          and max(rel.values()) <= LF_F32_TOL, f"{arch}: sharded serving "
          f"against unsharded, {rel} > {LF_F32_TOL}")
    out["serve"] = {"layers": cfg.n_layers, "rel": rel,
                    "prefill_s": times["sharded"][0],
                    "unsharded_prefill_s": times["unsharded"][0],
                    "decode_s": sorted(times["sharded"][1:])[LP_DECODE // 2],
                    "unsharded_decode_s":
                        sorted(times["unsharded"][1:])[LP_DECODE // 2],
                    "peak_gib": torch.cuda.max_memory_allocated(dev)
                    / 2 ** 30}
    del params, dparams, dl, dst, ul, ust, d_in
    gc.collect()
    torch.cuda.empty_cache()

    # one train step, sharded against unsharded
    cfg = dataclasses.replace(cfg, **train_ov)
    lm = LM(cfg, device=dev)
    params = lm.init_params(prng.PRNGKey(LF_SEED, dev))
    policy = ShardingPolicy(mesh, cfg)
    ps = policy.params_shardings(params)
    toks, enc = inputs(cfg, LP_PROMPT + 1)
    batch = {"tokens": toks}
    if enc is not None:
        batch["enc_embeds"] = enc
    opt = AdamW(lr=LT_LR)
    step = make_train_step(lm, opt)
    torch.cuda.reset_peak_memory_stats(dev)
    (dp, _, dm), ts = timed(lambda: step(
        distribute(params, ps), distribute(opt.init(params), OptState(
            policy.replicated(), ps, ps)),
        distribute(batch, policy.batch_shardings(batch))))
    peak_s = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    sharded = {k: float(dm[k].full_tensor()) for k in ("loss", "grad_norm")}
    dp = ls_full(dp)
    del dm
    gc.collect()
    (p, _, m), tu = timed(lambda: step(params, opt.init(params), batch))
    rel = {k: abs(sharded[k] - float(m[k])) / max(1.0, abs(float(m[k])))
           for k in sharded}
    gap = lt_params_gap(dp, p)
    check(all(math.isfinite(v) for v in rel.values())
          and max(rel.values()) <= LT_F32_TOL, f"{arch}: sharded train step "
          f"against unsharded, {rel} > {LT_F32_TOL}")
    lt_check_gap(gap, 1, f"{arch}: sharded train step against unsharded")
    out["train"] = {"layers": cfg.n_layers, "rel": rel, "params": gap,
                    "loss": [sharded["loss"], float(m["loss"])],
                    "step_s": ts, "unsharded_step_s": tu,
                    "sharded_peak_gib": peak_s}
    del params, dp, p, m
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {arch}: sharded prefill {out['serve']['prefill_s'] * 1e3:.1f} "
          f"ms (unsharded {out['serve']['unsharded_prefill_s'] * 1e3:.1f}), "
          f"decode {out['serve']['decode_s'] * 1e3:.1f} ms (unsharded "
          f"{out['serve']['unsharded_decode_s'] * 1e3:.1f}), serving peak "
          f"{out['serve']['peak_gib']:.2f} GiB, worst rel "
          f"{max(out['serve']['rel'].values()):.3g}; train step "
          f"{ts * 1e3:.1f} ms (unsharded {tu * 1e3:.1f}), peak "
          f"{peak_s:.2f} GiB, loss/grad norm rel {rel}")
    return out


def lp_planned_vs_card(dev) -> dict:
    """Phase 27's qwen2-0.5b step (float32, B = 8 x 128, the (1, 1) mesh) on
    real DTensors in an NCCL group of one rank: the trees' bytes and the
    step's rise of ``max_memory_allocated``; then the planner's record of
    the same step on a fake group of one rank. Returns both."""
    import dataclasses
    import datetime
    import torch.distributed as dist
    from repro_torch import random as prng
    from repro_torch.config import ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed import ShardingPolicy
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, OptState
    from repro_torch.train import make_train_step
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="float32")
    shape = ShapeConfig("phase27", LT_SEQ, LT_BATCH, "train")
    store_dir = ROOT / "build" / "planner_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(store_dir / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"))
        lm = LM(cfg, device=dev)
        params = lm.init_params(prng.PRNGKey(LM_SEED, dev))
        policy = ShardingPolicy(mesh, cfg)
        ps = policy.params_shardings(params)
        opt = AdamW(lr=LT_LR)
        gen = torch.Generator(device=dev).manual_seed(27)
        batch = {"tokens": torch.randint(0, cfg.vocab, (LT_BATCH, LT_SEQ + 1),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}
        args = (distribute(params, ps),
                distribute(opt.init(params), OptState(policy.replicated(),
                                                      ps, ps)),
                distribute(batch, policy.batch_shardings(batch)))
        del params
        real_bytes = dryrun.local_bytes(args)
        step = make_train_step(lm, opt)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        result = step(*args)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated(dev) - base
        del result, args
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    with dryrun.fake_world(1):
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"),
                                      device_type="cuda")
        rec = dryrun.plan_step(cfg, shape, mesh, device=dev, microbatches=1)
    check(rec["argument_size_in_bytes"] == real_bytes, f"planned argument "
          f"bytes {rec['argument_size_in_bytes']} against the real trees' "
          f"{real_bytes}")
    ratio = rise / rec["temp_size_in_bytes"]
    check(LP_PEAK_BOUND[0] <= ratio <= LP_PEAK_BOUND[1], f"the real step's "
          f"rise of max_memory_allocated {rise} over the planned peak "
          f"{rec['temp_size_in_bytes']}: {ratio} outside {LP_PEAK_BOUND}")
    return {"arch": LM_ARCH, "dtype": cfg.dtype, "batch": LT_BATCH,
            "seq": LT_SEQ, "real_argument_bytes": real_bytes,
            "planned": rec, "real_peak_rise_bytes": rise,
            "rise_over_planned": ratio, "bound": LP_PEAK_BOUND}


# the real step's rise of max_memory_allocated over the planned
# temp_size_in_bytes: the same eager ops and lifetimes on the card,
# plus the allocator's rounding and cuBLAS's workspace. On an NVIDIA H100
# 80GB HBM3 at 700 W it read 1.0010 (10,983,815,168 against 10,972,933,144
# bytes; PERF.md §6): the bound was 0.9-1.25 before that run.
LP_PEAK_BOUND = (0.95, 1.10)


def lm_planner_path(dev, card: str, power_limit: str) -> dict:
    """Phase 28: the families' sharded train, prefill and decode steps on
    an NCCL group of one rank, the planner on fake CUDA shards, and the
    planner's record of phase 27's step held against the card."""
    import datetime
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_from_devices
    from repro_torch.kernels import threefry as tf
    t_phase = time.perf_counter()
    out = {"card": card, "power_limit": power_limit}
    tf.threefry2x32_cuda.launches = 0
    store_dir = ROOT / "build" / "families_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(store_dir / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh_from_devices([0], (1, 1), ("data", "model"))
        out["families"] = {arch: lp_family(arch, sov, tov, red, mesh, dev)
                           for arch, sov, tov, red in LP_CONFIGS}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    out["families_s"] = time.perf_counter() - t_phase
    # every family's init_params draws its weights through threefry2x32
    out["launches"] = {"threefry2x32": tf.threefry2x32_cuda.launches}
    check(out["launches"]["threefry2x32"] > 0, "phase 28's init_params "
          "launched no threefry2x32")
    tf.threefry2x32_cuda.launches = 0
    out["vs_card"] = lp_planned_vs_card(dev)
    tf.threefry2x32_cuda.launches = 0
    print(f"  planner vs card ({LM_ARCH}, B = {LT_BATCH} x {LT_SEQ}, "
          f"float32, (1, 1)): argument bytes "
          f"{out['vs_card']['real_argument_bytes']} (equal); planned peak "
          f"{out['vs_card']['planned']['temp_size_in_bytes']} B, the real "
          f"step's rise {out['vs_card']['real_peak_rise_bytes']} B, ratio "
          f"{out['vs_card']['rise_over_planned']:.4f} (bound "
          f"{LP_PEAK_BOUND})")
    records = []
    for arch, shape in LP_PLAN:
        t0 = time.perf_counter()
        with dryrun.fake_world():
            rec, _ = dryrun.compile_once(arch, shape, False, cfg_overrides={
                "n_layers": dryrun._unit_size(get_config(arch))},
                device=dev)
        check(rec["device"] == "cuda" and "error" not in rec
              and rec["flops_per_device"] > 0, f"planner {arch} {shape}: "
              f"{rec}")
        rec["wall_s"] = time.perf_counter() - t0
        records.append(rec)
        print(json.dumps({"plan": rec, "card": card,
                          "power_limit": power_limit}))
    check(not dist.is_initialized(), "a process group outlived the planner")
    # the planner's shapes are fake or meta: no kernel may launch on them
    check(tf.threefry2x32_cuda.launches == 0, f"the planner launched "
          f"threefry2x32 {tf.threefry2x32_cuda.launches} times")
    out["plans"] = [{k: r[k] for k in ("arch", "shape", "wall_s",
                                       "compile_s")} for r in records]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"LM planner and the families' sharded steps (phase 28): "
          f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 29: the examples, and DPP pruning at full width
# ---------------------------------------------------------------------------

EX_SCRIPTS = ("quickstart", "prune_ffn_dpp", "serve_kv_compaction",
              "train_dpp_selection")
# lines each script must print, as the JAX examples print them
EX_KEY_LINES = {
    "quickstart": ("ground set N = 500", "drew 80 exact samples",
                   "monotone ascent verified over 10 sweeps",
                   "conditioned on [0, 1]: new ground set of 498 items",
                   "greedy MAP-10:"),
    "prune_ffn_dpp": ("pruned d_ff 128 -> 64", "reconstruction MSE:",
                      "selection wins on this probe"),
    "serve_kv_compaction": ("plain decode:", "compacted decode:",
                            "device_calls=", "== slowest 2 of 2 traces =="),
    "train_dpp_selection": ("kernel calibration: ll",
                            '{"step": 200,', "done at step 200"),
}
EX_TIMEOUT_S = 300
# examples/port/prune_ffn_dpp.py's steps at qwen2-0.5b's full width
# (src/repro/configs/qwen2_0_5b.py: d_model 896, d_ff 4864), layer 0 of
# init_params(PRNGKey(0)) in the config's float32 param dtype, a seeded
# float32 probe of 4 x 2048 token positions (8192 rows, so the 4864 x 4864
# unit kernel has full rank; the reference's 4 x 64 gives rank <= 256),
# keep d_ff / 2 = 2432: one fused greedy-MAP launch of 2432 dependent
# steps, its C (2432 x 4864 float32, 47 MB) in the device scratch
EX_PRUNE_ARCH = "qwen2-0.5b"
EX_PROBE = (4, 2048)
EX_TRAIN_STEPS = 16        # the in-process counted run of the trainer


def ex_module(name: str):
    """``examples/port/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", ROOT / "examples" / "port" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ex_scripts(ck_dir: Path) -> dict:
    """The four example scripts as subprocesses on the card at their
    defaults (the trainer's checkpoints under ``ck_dir``), started
    together: each must exit 0 and print its key lines."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "port" / f"{name}.py"),
         *(["--checkpoint-dir", str(ck_dir)]
           if name == "train_dpp_selection" else [])],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in EX_SCRIPTS}
    out = {}
    for name, proc in procs.items():
        try:
            text, _ = proc.communicate(
                timeout=max(EX_TIMEOUT_S - (time.perf_counter() - t0), 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        lines = text.splitlines()
        keys = [ln for ln in lines
                if any(k in ln for k in EX_KEY_LINES[name])]
        for ln in keys:
            print(f"  {name}: {ln}")
        out[name] = {"exit": proc.returncode, "done_s":
                     time.perf_counter() - t0, "key_lines": keys}
        check(proc.returncode == 0, f"examples/port/{name}.py exited "
              f"{proc.returncode}:\n" + "\n".join(lines[-40:]))
        missing = [k for k in EX_KEY_LINES[name]
                   if not any(k in ln for ln in lines)]
        check(not missing, f"examples/port/{name}.py printed none of "
              f"{missing}:\n" + "\n".join(lines[-40:]))
    serve = " ".join(out["serve_kv_compaction"]["key_lines"])
    calls = [int(x) for x in serve.split("device_calls=")[1].split()[::2][:2]
             ] if "device_calls=" in serve else [0, 0]
    check(0 < calls[0] < calls[1], f"the KV client's streams did not "
          f"coalesce: device_calls {calls[0]} for {calls[1]} heads")
    out["serve_device_calls_heads"] = calls
    out["wall_s"] = time.perf_counter() - t0
    return out


def ex_counted(fn, label: str, expect) -> tuple:
    """``fn``'s in-process run with every launch count from 0 (``sv_counted``)
    and its printing kept off the log; (fn's result, the counts)."""
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        out, n = sv_counted(fn, label, expect)
    print(f"  {label}: launches {json.dumps(n)}")
    return out, n


def ex_prune_full_width(dev) -> dict:
    """The prune example's steps at qwen2-0.5b's full width on the card:
    one fused greedy-MAP launch (counted), its picks against the plain
    loop's on the same kernel (``compare_maps``), its device time beside
    its bound, err_dpp and err_mag."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import greedy_map as gm
    cfg = get_config(EX_PRUNE_ARCH)
    prune = ex_module("prune_ffn_dpp")
    t0 = time.perf_counter()
    res, n = ex_counted(
        lambda: prune.run(cfg=cfg, probe=EX_PROBE, device=dev),
        f"prune_ffn_dpp at full width ({EX_PRUNE_ARCH}, probe {EX_PROBE})",
        {"greedy_map_kdpp", "threefry2x32"})
    wall = time.perf_counter() - t0
    check(n["greedy_map_kdpp"] == 1, f"the prune's MAP launched the fused "
          f"kernel {n['greedy_map_kdpp']} times, not once")
    L, k, N = res["kernel"], res["keep"], cfg.d_ff
    pk = res["map_picks"]
    check(pk.is_cuda and pk.dtype == torch.int32 and tuple(pk.shape) == (k,),
          f"the prune's picks: {pk.dtype} {tuple(pk.shape)} on {pk.device}")
    pk = pk.cpu().numpy()
    check(len(set(pk.tolist())) == k and pk.min() >= 0 and pk.max() < N,
          "the prune's picks are not k distinct units")
    # the Gram matrix's rank: eigenvalues of L above its 1e-4 ridge
    ev = torch.linalg.eigvalsh(L)
    rank = int((ev > 2e-4).sum())
    t1 = time.perf_counter()
    pp = gm.greedy_map_kdpp_plain(L, k)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t1
    cmp = compare_maps(L, pk, pp.cpu().numpy(),
                       f"prune map({k}) at N = {N}: kernel vs plain")
    live = greedy_live_steps(L, pk)
    b_ms, b_by, b_row = kdpp_bound(N, k, [live])
    plan = gm.greedy_map_kdpp_plan(N, k, L.device)
    times = {"ms": device_ms(partial(gm.greedy_map_kdpp_cuda, L, k), 3, 1,
                             expect="greedy_map_kdpp_kernel", sole=True),
             "ms_loop": cuda_ms(partial(gm.greedy_map_kdpp_cuda, L, k), 3,
                                1),
             "plain_ms": device_ms(partial(gm.greedy_map_kdpp_plain, L, k),
                                   1, 0),
             "plain_ms_loop": plain_wall * 1e3,
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
             "bound_row_ms": b_row, "live_steps": [live], "steps": k,
             "plan": plan, "launches": n["greedy_map_kdpp"],
             "shapes": {"N": N, "k": k, "H": 1}}
    times["per_step_ms"] = times["ms"] / k
    check(np.isfinite([res["err_dpp"], res["err_mag"]]).all(),
          f"prune errors {res['err_dpp']}, {res['err_mag']}")
    out = {"arch": EX_PRUNE_ARCH, "probe": EX_PROBE, "d_ff": N, "keep": k,
           "gram_rank": rank, "kernel_min_eig": float(ev[0]),
           "err_dpp": res["err_dpp"],
           "err_mag": res["err_mag"],
           "winner": "diverse" if res["err_dpp"] <= res["err_mag"]
           else "magnitude", "wall_s": wall, "plain_wall_s": plain_wall,
           "map_vs_plain": cmp, "times": times, "launches": n}
    print(f"  prune at full width: d_ff {N} -> {k}, Gram rank {rank}, "
          f"reconstruction MSE DPP-diverse {res['err_dpp']!r} vs magnitude "
          f"{res['err_mag']!r}; the fused MAP {times['ms']!r} ms "
          f"(device), {times['per_step_ms'] * 1e3!r} µs a step, bound "
          f"{b_ms!r} ms ({b_by}), plain loop {times['plain_ms']!r} ms "
          f"(device) {times['plain_ms_loop']!r} ms (wall); plan "
          f"{json.dumps(plan)}")
    return out


def ex_compat_on_card(dev) -> dict:
    """The JAX package's single-sample compat surface on the card:
    ``sampling.batched.phase2_select(key, ...)`` (one ``threefry2x32`` and
    one phase-2 launch) against ``phase2_select_reference`` on the same
    uniforms (``compare_picks``), and the deprecated
    ``core.sample_krondpp_batch`` (the keyed batched sampler)."""
    import warnings
    from repro_torch import dpp
    from repro_torch import random as prng
    from repro_torch.core import sample_krondpp_batch
    from repro_torch.sampling import batched as tb
    gen = torch.Generator(device=dev).manual_seed(29)
    model = dpp.random_kron(gen, (100, 100), device=dev).rescale(20.0)
    spec = model.spectrum()
    k_max = spec.suggested_k_max()
    _, ke, G1, Gr = phase1_inputs(spec, k_max, 1, gen)
    key = prng.PRNGKey(29, dev)
    picks, n_sel = ex_counted(
        lambda: tb.phase2_select(key, (G1[0], Gr[0]), spec.sizes, ke[0]),
        "sampling.batched.phase2_select(key, ...)",
        {"phase2_select", "threefry2x32"})
    check(n_sel["phase2_select"] == 1 and picks.is_cuda, f"phase2_select("
          f"key, ...): {n_sel}, picks on {picks.device}")
    us = prng.uniform(key, (k_max,), backend="reference")
    ref = tb.phase2_select_reference(us, (G1[0], Gr[0]), spec.sizes, ke[0])
    agree = compare_picks(picks.cpu().numpy()[None], ref.cpu().numpy()[None],
                          us[None], ke[:1], G1[:1], Gr[:1],
                          "phase2_select(key) vs phase2_select_reference")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rows, n_batch = ex_counted(
            lambda: sample_krondpp_batch(key, model.to_krondpp(), 64),
            "core.sample_krondpp_batch", {"phase2_select", "threefry2x32"})
    check(len(rows) == 64 and all(len(set(r)) == len(r) for r in rows),
          "core.sample_krondpp_batch: rows")
    return {"phase2_select_key": agree, "launches": {
        "phase2_select_key": n_sel, "sample_krondpp_batch": n_batch}}


def examples_path(dev, card: str, power_limit: str) -> dict:
    """Phase 29: the four ``examples/port/`` scripts on the card as
    subprocesses at their defaults; each example's steps in this process
    with every launch count from 0 (quickstart's sample, condition and
    map(10); the KV client's two streams; 16 steps of the DPP-selected
    trainer); the prune example at qwen2-0.5b's full width."""
    t_phase = time.perf_counter()
    out = {"card": card, "power_limit": power_limit}
    ck = ROOT / "build" / "examples_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    ck.mkdir(parents=True)
    try:
        out["scripts"] = ex_scripts(ck / "scripts")
        quick = ex_module("quickstart")
        res, n_quick = ex_counted(
            lambda: quick.run(dev), "quickstart",
            {"phase2_select", "threefry2x32", "greedy_map_kdpp"})
        check(n_quick["greedy_map_kdpp"] == 1 and n_quick["phase2_select"]
              == 1, f"quickstart: {n_quick}, not one sample and one map")
        check(res["map"].is_cuda and res["batch"].indices.is_cuda,
              "quickstart's draws or map left the card")
        out["quickstart"] = {"lls": res["fit"].log_likelihoods,
                             "map": sorted(int(i) for i in res["map"]),
                             "cond_expected_size": res["cond_expected_size"]}
        serve = ex_module("serve_kv_compaction")
        res, n_serve = ex_counted(
            lambda: serve.run(dev, run_log=ck / "run_log.jsonl"),
            "serve_kv_compaction", {"phase2_select", "threefry2x32"})
        check(0 < res["device_calls"] < res["heads_selected"],
              f"serve: {res['device_calls']} device calls for "
              f"{res['heads_selected']} heads")
        out["serve"] = {k: res[k] for k in ("device_calls",
                                            "heads_selected")}
        train = ex_module("train_dpp_selection")
        res, n_train = ex_counted(
            lambda: train.run(train.parse_args(
                ["--steps", str(EX_TRAIN_STEPS), "--device", str(dev),
                 "--checkpoint-dir", str(ck / "train")])),
            f"train_dpp_selection "
            f"--steps {EX_TRAIN_STEPS}", {"phase2_select", "threefry2x32"})
        ll0, ll1 = res["calibration_ll"]
        check(ll1 >= ll0 and res["result"]["final_step"] == EX_TRAIN_STEPS,
              f"train: calibration {ll0} -> {ll1}, final step "
              f"{res['result']['final_step']}")
        out["train"] = {"calibration_ll": [ll0, ll1],
                        "losses": [h["loss"] for h in
                                   res["result"]["history"]]}
        del res
        gc.collect()
        out["compat"] = ex_compat_on_card(dev)
        out["prune"] = ex_prune_full_width(dev)
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    out["launches"] = {"quickstart": n_quick, "serve_kv_compaction": n_serve,
                       "train_dpp_selection": n_train,
                       "prune_ffn_dpp_full_width": out["prune"]["launches"],
                       **out["compat"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"examples and DPP pruning at full width (phase 29): "
          f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 30: pruning a mixture-of-experts layer at full width
# ---------------------------------------------------------------------------

# Moonlight-16B-A3B's MoE block (huggingface.co/moonshotai/Moonlight-16B-A3B,
# config.json): hidden 2048, 64 routed experts of 1408 units, top 6 by
# sigmoid scores with a correction bias, 2 shared experts, norm_topk_prob,
# routed_scaling_factor 2.446; one layer, its probe as the benchmark's cell
# draws it (16 documents x 2048 positions, a topic's centre plus noise, 16
# topics with Zipf weights 1/r), keep half of every expert's units
MOE_PRUNE = {"d_model": 2048, "d_ff": 1408, "n_experts": 64,
             "experts_per_token": 6, "n_shared_experts": 2,
             "routed_scaling": 2.446, "norm_eps": 1e-5, "documents": 16,
             "positions": 2048, "topics": 16, "keep_fraction": 0.5}
MOE_IDLE_EXPERT = 17       # its bias, -10, keeps every token from it


def moe_prune_inputs(gen, dev):
    """(config, one layer's weights, probe (T, d)) of phase 30, seeded:
    gate and up N(0, 1/d), router N(0, 1/d), bias N(0, 0.01²) with
    ``MOE_IDLE_EXPERT``'s at -10, norm scale 1 + 0.1 N(0, 1)."""
    from repro_torch.config import ModelConfig
    m = MOE_PRUNE
    d, f, E = m["d_model"], m["d_ff"], m["n_experts"]
    fs = m["n_shared_experts"] * f
    cfg = ModelConfig(
        name="moonlight-16b-a3b-moe", family="moe", n_layers=1, d_model=d,
        n_heads=16, n_kv_heads=16, d_ff=f, vocab=163840,
        norm_eps=m["norm_eps"], n_experts=E,
        experts_per_token=m["experts_per_token"],
        n_shared_experts=m["n_shared_experts"], router_scoring="sigmoid",
        norm_topk_prob=True, routed_scaling=m["routed_scaling"],
        dtype="float32", param_dtype="float32")

    def normal(shape, std):
        return std * torch.randn(shape, generator=gen, device=dev)

    w = d ** -0.5
    p = {"ln": 1.0 + normal((d,), 0.1), "router": normal((d, E), w),
         "router_bias": normal((E,), 0.01),
         "w_gate": normal((E, d, f), w), "w_up": normal((E, d, f), w),
         "shared_gate": normal((d, fs), w), "shared_up": normal((d, fs), w)}
    p["router_bias"][MOE_IDLE_EXPERT] = -10.0
    ranks = torch.arange(1, m["topics"] + 1, dtype=torch.float32,
                         device=dev)
    topic = torch.multinomial(1.0 / ranks, m["documents"], replacement=True,
                              generator=gen)
    centres = torch.randn((m["topics"], d), generator=gen, device=dev)
    x = centres[topic][:, None, :] + torch.randn(
        (m["documents"], m["positions"], d), generator=gen, device=dev)
    return cfg, p, x.reshape(-1, d)


def moe_map_check(L, k: int, picks: np.ndarray, ranks: list,
                  label: str) -> dict:
    """One greedy-MAP launch of the prune, as the call made it: every head
    of L (H, N, N) equal to its own single launch (for H > 1), and against
    the plain loop (``compare_maps``) up to its rank ``ranks[h]``: a first
    difference at or past it is a tie (only the ridge is left there).
    Its device time beside ``kdpp_bound``."""
    from repro_torch.kernels import greedy_map as gm
    H, N = int(L.shape[0]), int(L.shape[-1])
    for h in range(H if H > 1 else 0):
        alone = gm.greedy_map_kdpp_cuda(L[h].contiguous(), k)
        check(np.array_equal(alone.cpu().numpy(), picks[h]), f"{label} "
              f"head {h}: the batched launch differs from its single launch")
    t0 = time.perf_counter()
    plain = gm.greedy_map_kdpp_plain(L, k).cpu().numpy()
    plain_wall = time.perf_counter() - t0
    worst, same, past_rank = 0.0, 0, 0
    for h in range(H):
        pk, pp, rank = picks[h], plain[h], min(int(ranks[h]), k)
        check(len(set(pk.tolist())) == k and pk.min() >= 0 and pk.max() < N,
              f"{label} head {h}: picks not {k} distinct items")
        diff = np.nonzero(pk != pp)[0]
        t = int(diff[0]) if diff.size else k
        same += int(t == k)
        if t < k and t >= rank:
            past_rank += 1
        elif t < rank:
            worst = max(worst, compare_maps(
                L[h], pk[:rank], pp[:rank], f"{label} head {h}",
                quiet=True).get("tie_gap", 0.0))
    live = [greedy_live_steps(L[h], picks[h]) for h in range(H)]
    b_ms, b_by, b_row = kdpp_bound(N, k, live)
    Lc = L if H > 1 else L[0]
    times = {"ms": device_ms(partial(gm.greedy_map_kdpp_cuda, Lc, k), 3, 1,
                             expect="greedy_map_kdpp_kernel", sole=True),
             "ms_loop": cuda_ms(partial(gm.greedy_map_kdpp_cuda, Lc, k), 3,
                                1),
             "plain_ms": None, "plain_ms_loop": plain_wall * 1e3,
             "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
             "bound_row_ms": b_row, "live_steps_min": min(live),
             "steps": k, "plan": gm.greedy_map_kdpp_plan(N, k, L.device),
             "launches": 1, "shapes": {"N": N, "k": k, "H": H}}
    times["per_step_ms"] = times["ms"] / k
    out = {"heads": H, "identical_heads": same,
           "first_difference_past_rank": past_rank, "max_tie_gap": worst,
           "times": times}
    print(f"  {label}: heads identical {same} of {H}, {past_rank} first "
          f"differences past the rank, largest tie gap {worst!r}; "
          f"{times['ms']!r} ms (device), bound {b_ms!r} ms ({b_by}), plain "
          f"loop {plain_wall:.2f} s (wall); plan {json.dumps(times['plan'])}")
    return out


def moe_prune_path(dev, card: str, power_limit: str) -> dict:
    """Phase 30: ``prune_moe_layer`` on one Moonlight-16B-A3B MoE layer
    (``MOE_PRUNE``), counted: two fused greedy-MAP launches and no other
    kernel; each launch's kernels (as the call passed them) against single
    launches and the plain loop (``moe_map_check``); the idle expert
    picks 0 .. 703 on its ridge-only kernel."""
    from repro_torch.dpp import functional as dpp_functional
    from repro_torch.models.prune import prune_moe_layer
    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(30)
    cfg, p, x = moe_prune_inputs(gen, dev)
    keep = MOE_PRUNE["keep_fraction"]
    launched = []
    fused = dpp_functional.greedy_map_kdpp

    def recorded(L, k, *args, **kwargs):
        launched.append((L, int(k)))
        return fused(L, k, *args, **kwargs)

    dpp_functional.greedy_map_kdpp = recorded
    try:
        t0 = time.perf_counter()
        res, n = map_counted(
            lambda: prune_moe_layer(p, x, cfg, keep),
            "prune_moe_layer at Moonlight's width", 2)
        wall = time.perf_counter() - t0
    finally:
        dpp_functional.greedy_map_kdpp = fused
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del p, x
    check(len(launched) == 2, f"prune_moe_layer called greedy_map_kdpp "
          f"{len(launched)} times, not twice")
    E, K, f = cfg.n_experts, cfg.experts_per_token, cfg.d_ff
    (L_r, k_r), (L_s, k_s) = launched
    T = MOE_PRUNE["documents"] * MOE_PRUNE["positions"]
    check(tuple(L_r.shape) == (E, f, f) and k_r == int(f * keep)
          and tuple(L_s.shape) == (2 * f, 2 * f) and k_s == int(2 * f * keep),
          f"the prune's launches: {tuple(L_r.shape)} k {k_r}, "
          f"{tuple(L_s.shape)} k {k_s}")
    loads = res["tokens_per_expert"].cpu()
    check(int(loads.sum()) == T * K and int(loads[MOE_IDLE_EXPERT]) == 0
          and int(res["rows_computed"]) == T * K, f"the prune's loads: "
          f"sum {int(loads.sum())}, idle expert {int(loads[MOE_IDLE_EXPERT])}"
          f", rows computed {res['rows_computed']}")
    routed, shared = res["routed"], res["shared"]
    check(routed.dtype == torch.int32 and routed.is_cuda
          and tuple(routed.shape) == (E, k_r) and shared.dtype == torch.int32
          and tuple(shared.shape) == (k_s,), f"the prune's picks: "
          f"{routed.dtype} {tuple(routed.shape)}, {shared.dtype} "
          f"{tuple(shared.shape)}")
    pk_r = routed.cpu().numpy()
    check(pk_r[MOE_IDLE_EXPERT].tolist() == list(range(k_r)), f"the idle "
          f"expert picks {pk_r[MOE_IDLE_EXPERT].tolist()[:12]}, not 0 .. "
          f"{k_r - 1}")
    lm = loads.double() / loads.double().mean()
    out = {"card": card, "power_limit": power_limit, "shape": MOE_PRUNE,
           "idle_expert": MOE_IDLE_EXPERT, "wall_s": wall,
           "loads": {"max_over_mean": float(lm.max()),
                     "min_over_mean": float(lm.min()),
                     "experts_under_k": int((loads < k_r).sum())},
           "launches": n}
    out["routed"] = moe_map_check(L_r, k_r, pk_r, loads.tolist(),
                                  f"routed experts ({E}, {f}, {f}) k {k_r}")
    out["shared"] = moe_map_check(L_s[None], k_s, shared.cpu().numpy()[None],
                                  [T], f"shared experts {2 * f}² k {k_s}")
    del launched, L_r, L_s, res
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"pruning an MoE layer at full width (phase 30): loads "
          f"{json.dumps(out['loads'])}, {out['phase_s']:.1f} s")
    return out


def main() -> None:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.obs as obs
    from repro_torch import dpp
    from repro_torch.core.dpp import marginal_kernel
    from repro_torch.kernels import _build
    from repro_torch import random as prng
    from repro_torch.kernels import phase2_select as p2
    from repro_torch.kernels import threefry as tf
    from repro_torch.sampling.batched import (gather_factor_columns,
                                              keyed_uniforms,
                                              sample_krondpp_batched)
    from repro_torch.sampling.spectral import SpectralCache

    # -- 1. environment -----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    power_limit = smi.split(",")[-1].strip()
    dev = torch.device("cuda", 0)

    # -- 2. build: one nvcc per source, started together --------------------
    t0 = time.perf_counter()
    sources = ("phase2_select", "partial_trace", "greedy_map", "kron_matvec",
               "threefry", "theta_scatter")
    with ThreadPoolExecutor(len(sources)) as pool:
        logs = dict(zip(sources, pool.map(_build.build, sources)))
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas" in line:
                print(f"  {name}: {line.strip()}")

    # -- 3. kernel vs plain -------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = SpectralCache()
    model = dpp.random_kron(gen, (100, 100), device=dev).rescale(20.0,
                                                                 cache)
    spec = model.spectrum(cache)
    k_max = spec.suggested_k_max()
    print(f"main shapes: N = 100 x 100, E|Y| = {spec.expected_size()!r}, "
          f"k_max = {k_max}")
    inputs = {B: phase1_inputs(spec, k_max, B, gen) for B in (1, 64)}
    agree = {}
    for B, (us, ke, G1, Gr) in inputs.items():
        agree[B] = compare(us, ke, G1, Gr, f"kron 100x100 B={B}")
    edges = []
    dense = dpp.from_kernel(
        dpp.random_kron(gen, (400,), device=dev).factors[0],
        device=dev).rescale(20.0, cache)
    s1 = dense.spectrum(cache)
    edges.append(compare(*phase1_inputs(s1, s1.suggested_k_max(), 64, gen),
                         "dense m=1 N=400 B=64"))
    m3 = dpp.random_kron(gen, (20, 20, 25), device=dev).rescale(20.0, cache)
    s3 = m3.spectrum(cache)
    edges.append(compare(*phase1_inputs(s3, s3.suggested_k_max(), 64, gen),
                         "kron m=3 20x20x25 B=64"))
    # degenerate columns: one eigen-index twice per row, so the span is
    # one short of k_eff; each row must stop there with a -1 tail
    kd = 12
    sel = torch.stack([torch.randperm(spec.N, generator=gen, device=dev)[:kd]
                       for _ in range(64)]).to(torch.int32)
    sel[:, 5] = sel[:, 4]
    valid = torch.ones((64, kd), dtype=torch.bool, device=dev)
    G1d, Grd = gather_factor_columns(spec.vecs, spec.sizes, sel, valid)
    usd = torch.rand((64, kd), generator=gen, device=dev)
    ked = torch.full((64,), kd, dtype=torch.int32, device=dev)
    edges.append(compare(usd, ked, G1d.contiguous(), Grd.contiguous(),
                         "degenerate columns B=64", span=kd - 1))
    # the cluster route: 300 x 300, whose norms alone pass a block's shared
    # memory
    big = dpp.random_kron(gen, (300, 300), device=dev).rescale(20.0, cache)
    s_big = big.spectrum(cache)
    glob_in = phase1_inputs(s_big, s_big.suggested_k_max(), 8, gen)
    edges.append(compare(*glob_in, "kron 300x300 B=8", route="cluster"))
    # and 32 x 32 at E|Y| = 250 (k_max past 238, the KronDPP batch
    # selector's shape), whose k x k basis passes a block's shared memory;
    # its own generator, so that later phases draw as before
    gen_w = torch.Generator(device=dev).manual_seed(3)
    wide = dpp.random_kron(gen_w, (32, 32), device=dev).rescale(250.0, cache)
    s_wide = wide.spectrum(cache)
    edges.append(compare(*phase1_inputs(s_wide, s_wide.suggested_k_max(), 16,
                                        gen_w),
                         f"kron 32x32 k_max {s_wide.suggested_k_max()} B=16",
                         route="cluster"))
    # past a cluster of 16 CTAs (each would hold all of Grᵀ): the global
    # route at 16 x 4096, the global_basis route at 64 x 256, E|Y| = 250
    # (k_max past 238); their own generator too
    gen_g = torch.Generator(device=dev).manual_seed(5)
    for sizes, size, B, route in (((16, 4096), 20.0, 8, "global"),
                                  ((64, 256), 250.0, 4, "global_basis")):
        mg = dpp.random_kron(gen_g, sizes, device=dev).rescale(size, cache)
        sg = mg.spectrum(cache)
        kg = sg.suggested_k_max()
        edges.append(compare(*phase1_inputs(sg, kg, B, gen_g),
                             f"kron {sizes[0]}x{sizes[1]} k_max {kg} B={B}",
                             route=route))
    # the host's layout of the on-chip route against the kernel's own
    lib = _build.load_library("phase2_select", p2.bind)
    for n1, nr, kk in itertools.product((1, 4, 20, 30, 100, 300, 400, 1100),
                                        (1, 40, 100, 500), (1, 20, 46, 224)):
        nb = ctypes.c_longlong(0)
        check(lib.phase2_select_onchip_bytes(n1, nr, kk, ctypes.byref(nb))
              == 0 and nb.value == p2.onchip_geometry(n1, nr, kk)[3],
              f"on-chip bytes at {n1} x {nr}, k {kk}: kernel {nb.value}, "
              f"host {p2.onchip_geometry(n1, nr, kk)[3]}")
    print(f"phase2_select: on-chip layout bytes agree (host and kernel) at "
          f"128 shapes; the device's opt-in limit "
          f"{p2._smem_optin(dev.index)} bytes")
    # the C side's cluster plan against the host's mirror
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = 0
    for (n1, nr, kk), nb in itertools.product(
            ((1024, 1, 192), (512, 1, 120), (9995, 1, 46), (300, 300, 46),
             (32, 32, 333), (400, 1, 224), (100, 100, 239), (2000, 3, 46),
             (60, 700, 20)), (1, 8, 16, 64, 512)):
        host = p2.cluster_geometry(n1, nr, kk, nb, p2._smem_optin(dev.index),
                                   sms)
        plan = p2.cluster_plan(n1, nr, kk, nb, dev.index)
        check(host is not None and tuple(plan[:6]) == tuple(host),
              f"cluster plan at {n1} x {nr}, k {kk}, B {nb}: kernel {plan}, "
              f"host {host}")
        plans += 1
    print(f"phase2_select: cluster plans agree (host and kernel) at {plans} "
          f"shapes and batches; {sms} SMs")

    # -- 4. statistics on the kernel path -----------------------------------
    small = dpp.random_kron(gen, (2, 3), device=dev)
    K = marginal_kernel(small.dense_kernel().double().cpu().numpy())
    picks, _, _ = sample_krondpp_batched(gen, small.spectrum(cache),
                                         num_samples=3000, backend="cuda")
    mem = np.zeros((3000, 6))
    for b, row in enumerate(picks.cpu().numpy()):
        mem[b, row[row >= 0]] = 1.0
    err = float(np.abs(mem.mean(0) - np.diag(K)).max())
    print(f"marginals (2,3), 3000 kernel draws: max |freq - K_ii| = {err!r}")
    check(err <= 0.05, f"marginals off by {err} > 0.05")

    # -- 5. the main path ---------------------------------------------------
    tracker = obs.InMemoryTracker()
    gen_main = torch.Generator(device=dev).manual_seed(1)
    main = dpp.random_kron(gen_main, (100, 100)).rescale(20.0)
    svc = main.service(seed=0)
    tickets = [svc.submit(n) for n in (1, 4, 16, 64, 200)]
    with svc._lock:                     # the flush's key, replayed below
        flush_key = svc._key.clone()
    p2.launches = 0
    tf.threefry2x32_cuda.launches = 0
    with obs.use(tracker):
        svc.flush()
        torch.cuda.synchronize()
    launches = p2.launches
    tf_launches_flush = tf.threefry2x32_cuda.launches
    cuda_count = int(tracker.counter_value("kernels.phase2_select.cuda"))
    tf_counts = {e: int(tracker.counter_value(f"kernels.threefry2x32.{e}"))
                 for e in ("cuda", "reference")}
    rows = [r for t in tickets for r in t.result()]
    e_size = svc.spectrum.expected_size()
    print(f"main path: {len(rows)} rows, k_max {svc.k_max}, E|Y| "
          f"{e_size!r}, launches {launches}, kernels.phase2_select.cuda "
          f"{cuda_count}, threefry2x32 launches {tf_launches_flush}, "
          f"kernels.threefry2x32 {tf_counts}, stats {svc.stats()}")
    check(len(rows) == 285, f"service returned {len(rows)} rows, not 285")
    for r in rows:
        check(len(set(r)) == len(r), f"service row repeats an item: {r}")
        check(all(0 <= i < main.N for i in r), "service row out of range")
        check(len(r) <= svc.k_max, "service row longer than k_max")
    mean_size = float(np.mean([len(r) for r in rows]))
    print(f"main path: mean |Y| {mean_size!r} vs E|Y| {e_size!r}")
    check(abs(mean_size - e_size) <= 1.0, "mean |Y| is not within 1 of E|Y|")
    check(launches > 0, "the main path never launched the phase-2 kernel")
    check(cuda_count > 0, "kernels.phase2_select.cuda was not counted")
    check(tf_launches_flush > 0 and tf_counts["cuda"] == tf_launches_flush
          and tf_counts["reference"] == 0, f"the flush launched threefry2x32 "
          f"{tf_launches_flush} times, counted {tf_counts}")
    # the main path's own launch against the plain version: replay the
    # flush's draw (one call at the rounded-up batch) from the saved
    # service key through the plain PRNG twin on the card (its uniforms
    # bit for bit the kernel's), run phase 1 and the plain phase 2 on it,
    # and hold the served rows against the plain rows of the same uniforms
    stats = svc.stats()
    check(stats["device_calls"] == 1, f"the flush made {stats} calls, not 1")
    B_main = stats["samples_drawn"]
    _, sub_m = prng.split(flush_key, backend="reference")
    rk_plain = prng.split(sub_m, B_main, backend="reference")
    u_p, us_p = plain_row_uniforms(rk_plain, svc.spectrum.N, svc.k_max)
    u_k, us_k = keyed_uniforms(prng.split(prng.split(flush_key)[1], B_main),
                               svc.spectrum.N, svc.k_max)
    check(same_bits(u_k, u_p) and same_bits(us_k, us_p), "the flush's "
          "uniforms from the kernel and from the plain twin differ")
    print(f"main path replay: the flush's {B_main} x {svc.spectrum.N} and "
          f"{B_main} x {svc.k_max} uniforms, kernel and plain twin, equal "
          f"bit for bit")
    us_m, ke_m, G1_m, Gr_m = phase1_of(svc.spectrum, svc.k_max, u_p, us_p)
    pp_m = p2.phase2_select_plain(us_m, ke_m, G1_m, Gr_m)[:len(rows)]
    pk_m = np.full((len(rows), svc.k_max), -1, dtype=np.int32)
    for b, r in enumerate(rows):
        pk_m[b, :len(r)] = r
    n = len(rows)
    agree_main = compare_picks(pk_m, pp_m.cpu().numpy(), us_m[:n], ke_m[:n],
                               G1_m[:n], Gr_m[:n],
                               f"main path B={B_main} (rows served)")

    # -- 6. times -----------------------------------------------------------
    times = {}
    for B, (us, ke, G1, Gr) in [*inputs.items(), ("global", glob_in)]:
        N1_, Nr_, k_ = int(G1.shape[1]), int(Gr.shape[1]), int(us.shape[1])
        route = p2.phase2_select_route(N1_, Nr_, k_)
        picks_k = p2.phase2_select_cuda(us, ke, G1, Gr).cpu().numpy()
        b_ms, b_by = bound(picks_k, N1_, Nr_, k_)
        keys = dict(kernel_route=route, bound_ms=b_ms, bound_by=b_by,
                    bound_row_ms=bound_row(picks_k, N1_, Nr_, k_),
                    live_steps=int((picks_k >= 0).sum()),
                    max_row_steps=int((picks_k >= 0).sum(axis=1).max()),
                    shapes={"N1": N1_, "Nr": Nr_, "k_max": k_,
                            "B": int(us.shape[0])})
        on_chip = route == "on_chip"
        extra = None
        if not on_chip:
            more, extra = cluster_row(us, ke, G1, Gr, picks_k,
                                      f"phase2_select {B}")
            keys.update(more)
        times[B] = kernel_times(
            partial(p2.phase2_select_cuda, us, ke, G1, Gr),
            partial(p2.phase2_select_plain, us, ke, G1, Gr), None,
            reps=20 if on_chip else 5, plain_reps=5 if on_chip else 2,
            expect=f"phase2_select_kernel_{route.replace('_', '')}",
            sole=True, extra=extra, **keys)
        print(f"  phase2_select B={B}: {json.dumps(times[B])}")
    # the DPP's phase 1 alone: the request's uniforms, the Bernoulli draw
    # and compaction, the factor-column gather (svc.sample(16) runs B = 16)
    phase1_ms = {}
    key_t = prng.PRNGKey(11, dev)
    for B in (16, 64):
        phase1_ms[B] = cuda_ms(partial(phase1_inputs, spec, k_max, B, gen),
                               reps=20, warmup=2)
        # the same from a key: the service's split, the rows' keys, their
        # splits and two uniforms through threefry2x32, then phase 1
        phase1_ms[f"keyed_{B}"] = cuda_ms(
            lambda B=B: phase1_of(spec, k_max, *keyed_uniforms(
                prng.split(prng.split(key_t)[1], B), spec.N, k_max)),
            reps=20, warmup=2)
    print(f"  DPP phase 1 (ms, CUDA events): {json.dumps(phase1_ms)}")
    svc.sample(16)                              # warm the request path
    req = []
    for _ in range(5):
        t0 = time.perf_counter()
        svc.sample(16)
        torch.cuda.synchronize()
        req.append((time.perf_counter() - t0) * 1e3)

    # -- 7. partial-trace kernels vs plain ----------------------------------
    from repro_torch.core.dpp import (SubsetBatch, identity_padded,
                                      masked_inv_and_logdet, scatter_theta)
    from repro_torch.core.krk_picard import (AC_from_dense_theta,
                                             _subset_blocks, accumulate_AC,
                                             theta_matrix_kron)
    from repro_torch.learning.objective import log_likelihood_factored
    from repro_torch.kernels import partial_trace as pt
    from repro_torch.learning import schedules
    pt_check = check_partial_traces(gen, dev)

    # -- 8. data for the fit ------------------------------------------------
    fit_rows = [r for r in main.service(seed=2).sample(1000) if r]
    batch = SubsetBatch.from_lists(fit_rows, device=dev)
    init = dpp.random_kron(torch.Generator(device=dev).manual_seed(2),
                           (100, 100))
    L1, L2 = init.factors
    print(f"fit data: n = {batch.n} subsets, k_max {batch.k_max}, mean "
          f"|Y| {float(batch.sizes().float().mean())!r}")

    # -- 9. the routes agree at the init -------------------------------------
    from repro_torch.kernels import theta_scatter as ts
    ts_check = check_theta_scatter(L1, L2, fit_rows, k_max, dev)
    ts_tracker = obs.InMemoryTracker()
    ts_before = ts.theta_scatter_cuda.launches
    with obs.use(ts_tracker):
        theta = theta_matrix_kron(L1, L2, batch)
        # the dense Θ of the same batch and factors once more: bitwise
        # equal unless the scatter sums in another order
        theta_again = theta_matrix_kron(L1, L2, batch)
    theta_repeat = {
        "entries_differing": int((theta != theta_again).sum()),
        "max_abs_diff": float((theta - theta_again).abs().max()),
        "max_abs": float(theta.abs().max()), "entries": theta.numel(),
        "launches": ts.theta_scatter_cuda.launches - ts_before,
        "counted": int(ts_tracker.counter_value(
            "kernels.theta_scatter.cuda"))}
    del theta_again
    print(f"dense Θ built twice, bitwise: {json.dumps(theta_repeat)}")
    check(theta_repeat["entries_differing"] == 0, "two builds of the same "
          "dense Θ differ")
    check(theta_repeat["launches"] == theta_repeat["counted"] == 2,
          f"two Θ builds launched theta_scatter {theta_repeat['launches']} "
          f"times, counted {theta_repeat['counted']}, not 2")
    A_k, C_k = AC_from_dense_theta(theta, L1, L2)
    A_r, C_r = AC_from_dense_theta(theta, L1, L2, backend="reference")
    A_s, C_s = accumulate_AC(L1, L2, batch)
    torch.cuda.synchronize()
    N1, N2 = init.sizes
    t4a = theta.abs().reshape(N1, N2, N1, N2)
    pt_check["err"]["A"] = max(pt_check["err"]["A"], check_pt(
        A_k, A_r, 1e-4 * pt.partial_trace_A_plain(t4a, L2.abs()) + 1e-7,
        "init A: kernel vs plain"))
    pt_check["err"]["C"] = max(pt_check["err"]["C"], check_pt(
        C_k, C_r, 1e-4 * pt.partial_trace_C_plain(t4a, L1.abs()) + 1e-7,
        "init C: kernel vs plain"))
    del t4a
    routes = {"A_kernel_vs_subset": max_rel(A_k, A_s),
              "C_kernel_vs_subset": max_rel(C_k, C_s),
              "A_plain_vs_subset": max_rel(A_r, A_s),
              "C_plain_vs_subset": max_rel(C_r, C_s)}
    print(f"routes at init (max |Δ| / max |ref|): {json.dumps(routes)}")
    for k, v in routes.items():
        check(v <= 1e-4, f"routes at init: {k} {v!r} > 1e-4")

    # -- 10. the learning main path ------------------------------------------
    fit_kw = dict(algorithm="krk", use_dense_theta=True,
                  schedule=schedules.armijo(a0=1.5), iters=5, log_every=5)
    init.fit(batch, **dict(fit_kw, iters=1))   # warm-up: cuSOLVER, caches
    fit_tracker = obs.InMemoryTracker()
    pt.partial_trace_A_cuda.launches = 0
    pt.partial_trace_C_cuda.launches = 0
    ts.theta_scatter_cuda.launches = 0
    with obs.use(fit_tracker):
        rep = init.fit(batch, **fit_kw)
        torch.cuda.synchronize()
    fit_launches = {"A": pt.partial_trace_A_cuda.launches,
                    "C": pt.partial_trace_C_cuda.launches}
    ts_fit = {"launches": ts.theta_scatter_cuda.launches,
              "counted": int(fit_tracker.counter_value(
                  "kernels.theta_scatter.cuda")),
              "reference": int(fit_tracker.counter_value(
                  "kernels.theta_scatter.reference"))}
    print(f"fit: theta_scatter {json.dumps(ts_fit)}")
    check(ts_fit["launches"] == ts_fit["counted"] == fit_launches["C"]
          and not ts_fit["reference"], f"the fit's {fit_launches['C']} Θ "
          f"builds (one C each) launched theta_scatter {ts_fit}")
    fit_counts = {k: int(fit_tracker.counter_value(
        f"kernels.partial_trace_{k}.cuda")) for k in ("A", "C")}
    lls = rep.log_likelihoods
    print(f"fit: LL {lls}, accepted a {float(rep.state.sched.a)!r}, "
          f"backtracks {int(rep.state.sched.backtracks)}, launches "
          f"{fit_launches}, counters {fit_counts}, health "
          f"{rep.health and rep.health['verdict']}, sweep times "
          f"{rep.sweep_times}")
    check(fit_launches == {"A": 5, "C": 10}, f"the fit launched the "
          f"partial traces {fit_launches} times, not A 5 and C 10")
    check(fit_counts == fit_launches, f"kernels.partial_trace_*.cuda "
          f"{fit_counts} do not match the launches {fit_launches}")
    check(not any(fit_tracker.counter_value(
        f"kernels.partial_trace_{k}.reference") for k in ("A", "C")),
        "the fit took a plain partial trace on the card")
    from repro_torch.learning.schedules import _ASCENT_TOL
    steps = np.diff(lls)
    check(len(lls) == 6 and np.isfinite(lls).all(), f"LL track {lls}")
    check(bool((steps >= -_ASCENT_TOL).all()), f"the LL fell by more than "
          f"{_ASCENT_TOL} in a sweep: {lls}")
    check(lls[-1] > lls[0], f"final LL {lls[-1]} not above init {lls[0]}")
    min_eigs = [float(torch.linalg.eigvalsh(f)[0]) for f in
                rep.model.factors]
    check(min(min_eigs) > 0, f"a learned factor is not PD: {min_eigs}")
    check(rep.health is not None, "FitReport.health is missing")
    rep_p = init.fit(batch, backend="reference", **fit_kw)
    torch.cuda.synchronize()
    fit_agree = {"lls_plain": rep_p.log_likelihoods,
                 "a": [float(rep.state.sched.a), float(rep_p.state.sched.a)],
                 "backtracks": [int(rep.state.sched.backtracks),
                                int(rep_p.state.sched.backtracks)],
                 "factor_max_rel": [max_rel(f, g) for f, g in
                                    zip(rep.model.factors,
                                        rep_p.model.factors)]}
    print(f"fit with plain partial traces: {json.dumps(fit_agree)}")
    check(fit_agree["a"][0] == fit_agree["a"][1]
          and fit_agree["backtracks"][0] == fit_agree["backtracks"][1],
          f"kernel and plain fits accepted other steps: {fit_agree}")
    check(np.allclose(lls, rep_p.log_likelihoods, rtol=1e-4, atol=0.0),
          f"kernel and plain fits' LLs differ: {lls} vs "
          f"{rep_p.log_likelihoods}")
    check(max(fit_agree["factor_max_rel"]) <= 1e-3,
          f"kernel and plain fits' factors differ: {fit_agree}")

    # -- 11. times ------------------------------------------------------------
    t4, L1r, L2r = pt_check["main"]
    pt_times = {}
    for k, kern, plain, lib, L in (
            ("A", pt.partial_trace_A_cuda, pt.partial_trace_A_plain,
             "kulv,vu->kl", L2r),
            ("C", pt.partial_trace_C_cuda, pt.partial_trace_C_plain,
             "iujv,ij->uv", L1r)):
        b_ms, b_by = pt_bound(*PT_SHAPES[0])
        pt_times[k] = kernel_times(
            partial(kern, t4, L), partial(plain, t4, L),
            partial(torch.einsum, lib, t4, L), reps=20, plain_reps=5,
            expect=f"partial_trace_{k}_", bound_ms=b_ms, bound_by=b_by)
        print(f"  partial_trace_{k} {PT_SHAPES[0]}: "
              f"{json.dumps(pt_times[k])}")
    # the Θ scatter at the benchmark's shape and with no padding (n subsets
    # of 20 distinct items, k = 20), the kernel beside its bound, the plain
    # version and the index_put_ call
    N_ts = L1.shape[0] * L2.shape[0]
    pick = torch.rand((batch.n, N_ts), generator=gen, device=dev)
    full = pick.argsort(dim=1)[:, :20].to(torch.int32)
    del pick
    ts_times = {}
    for label, args in (
            ("padded", ts_check["args"]),
            ("no_padding", ts_inputs(L1, L2, full, torch.ones_like(
                full, dtype=torch.bool)))):
        n_, k_ = (int(x) for x in args[0].shape)
        live = int((args[1].sum(-1) ** 2).sum())
        b_ms, b_by = ts_bound(N_ts, n_, k_, live)
        ts_times[label] = kernel_times(
            partial(ts.theta_scatter_cuda, N_ts, *args),
            partial(ts.theta_scatter_plain, N_ts, *args),
            partial(ts_library, N_ts, *args), reps=20, plain_reps=2,
            expect="theta_scatter_kernel", bound_ms=b_ms, bound_by=b_by,
            shapes={"N": N_ts, "n": n_, "k": k_, "live_terms": live})
        print(f"  theta_scatter {label}: {json.dumps(ts_times[label])}")
    theta_ms = cuda_ms(lambda: theta_matrix_kron(L1, L2, batch), reps=5,
                       warmup=1)
    # where a sweep's time goes: the Θ build's steps, a factor eigh, and
    # one log-likelihood (each Armijo trial evaluates one)
    _, _, B1, B2 = _subset_blocks(L1, L2, batch)
    sub = identity_padded(B1 * B2, batch.mask)
    chol, _ = torch.linalg.cholesky_ex(sub)
    eye = torch.eye(batch.k_max, device=dev).expand_as(sub)
    inv, _ = masked_inv_and_logdet(sub)
    parts = {
        "gather": lambda: identity_padded(
            torch.mul(*_subset_blocks(L1, L2, batch)[2:]), batch.mask),
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(sub),
        "cholesky_solve": lambda: torch.cholesky_solve(eye, chol),
        "scatter": lambda: scatter_theta(L1.shape[0] * L2.shape[0],
                                         batch.indices, batch.mask, inv),
        "factor_eigh": lambda: torch.linalg.eigh(L1),
        "log_likelihood": lambda: log_likelihood_factored((L1, L2), batch)}
    breakdown = {k: cuda_ms(f, reps=5, warmup=1) for k, f in parts.items()}
    print(f"  breakdown (ms): {json.dumps(breakdown)}")
    learn_timing = {
        "theta_build_ms": theta_ms, "breakdown_ms": breakdown,
        "sweep_ms_kernel": rep.sweep_times[0] * 1e3 / 5,
        "sweep_ms_plain": rep_p.sweep_times[0] * 1e3 / 5,
        "fit_n": batch.n, "fit_k_max": batch.k_max,
        "backtracks": int(rep.state.sched.backtracks),
        "pt_shape": PT_SHAPES[0], "partial_trace_A": pt_times["A"],
        "partial_trace_C": pt_times["C"], "theta_repeat": theta_repeat,
        "theta_scatter": ts_times}

    # -- 12. greedy-MAP and Kronecker-matvec kernels vs plain ----------------
    from repro_torch.kernels import greedy_map as gm
    from repro_torch.kernels import kron_matvec as km
    from repro_torch.kernels import ops
    from repro_torch.sampling import kdpp as kd
    from repro_torch.sampling.batched import (assemble_eigvecs,
                                              compact_selection,
                                              split_mixed_radix)
    gm_err = check_greedy_update(gen, dev)
    kdpp_check = check_greedy_kdpp(gen, dev)
    km_err = check_kron_matvec(gen, dev)
    hmma = sass_of(_build.library_path("kron_matvec"),
                   "kron_matvec_fused_kernelI13__nv_bfloat16", "HMMA")
    print(f"kron_matvec bfloat16 one-launch kernel, SASS: {len(hmma)} HMMA "
          f"instructions, e.g. {hmma[:1]}")
    check(len(hmma) > 0, "the bfloat16 kron_matvec kernel has no HMMA "
          "(tensor-core) instruction")

    # -- 13. the MAP path ----------------------------------------------------
    L_main = main.dense_kernel(10_000)
    map_launches, map_cmp, map_picks = {}, {}, {}
    for k in (20, 200):
        picks_map, map_launches[k] = map_counted(
            lambda: main.map(k, max_dense=10_000), f"map({k})", 1)
        print(f"map({k}) at N = {main.N}: launches {map_launches[k]}")
        check(picks_map.dtype == torch.int32 and picks_map.is_cuda
              and tuple(picks_map.shape) == (k,), f"map({k}) returned "
              f"{picks_map.dtype} {tuple(picks_map.shape)} on "
              f"{picks_map.device}")
        pk = picks_map.cpu().numpy()
        check(len(set(pk.tolist())) == k and pk.min() >= 0
              and pk.max() < main.N, f"map({k}) picks invalid: {pk}")
        pp = ops.greedy_map_kdpp(L_main, k, backend="reference").cpu().numpy()
        map_cmp[k] = compare_maps(L_main, pk, pp, f"map({k}) kernel vs plain")
        map_picks[k] = pk
    guard = dpp.random_kron(gen, (64, 64)).rescale(20.0, cache)
    picks_64, map_launches["guard"] = map_counted(lambda: guard.map(20),
                                                  "map(20) of 64 x 64", 1)
    picks_64 = picks_64.cpu().numpy()
    check(len(set(picks_64.tolist())) == 20, f"map(20) of a 64 x 64 model: "
          f"{picks_64}")
    print(f"map(20) of a 64 x 64 model under the default guard: 20 distinct "
          f"picks, one launch")
    # the public step op, still the counterpart of the JAX
    # ops.greedy_map_update: map(200)'s first step through it (one step
    # launch, no fused one) against the plain step
    j0 = int(map_picks[200][0])
    d0 = torch.diagonal(L_main).contiguous()
    step_args = (L_main[:, j0].contiguous(),
                 torch.zeros((10_000, 200), device=dev),
                 torch.zeros((200,), device=dev), d0[j0:j0 + 1].clone(), d0)
    step_tracker = obs.InMemoryTracker()
    with obs.use(step_tracker):
        (e_s, dn_s), step_launches = sv_counted(
            lambda: ops.greedy_map_update(*step_args), "ops.greedy_map_update",
            {"greedy_map_update"})
    e_p, dn_p = gm.greedy_map_update_plain(*step_args)
    step_err = max(float((e_s - e_p).abs().max()),
                   float((dn_s - dn_p).abs().max()))
    scale = float(step_args[0].abs().max())
    check(step_launches["greedy_map_update"] == 1 and int(
        step_tracker.counter_value("kernels.greedy_map_update.cuda")) == 1
        and step_err <= 1e-5 * max(scale, scale ** 2), f"the step op: "
        f"launches {step_launches}, |kernel - plain| {step_err!r}")
    print(f"ops.greedy_map_update at map(200)'s first step: one step launch,"
          f" |kernel - plain| {step_err!r}")

    # -- 14. the eigenvector path ---------------------------------------------
    spec_m = svc.spectrum
    u_sel = torch.rand((spec_m.N,), generator=gen, device=dev)
    sel, valid, _ = compact_selection(
        u_sel < torch.sigmoid(spec_m.log_eigenvalues()), svc.k_max)
    eig_tracker = obs.InMemoryTracker()
    km.kron_matvec_cuda.launches = 0
    with obs.use(eig_tracker):
        V = assemble_eigvecs(spec_m.vecs, spec_m.sizes, sel, valid)
        torch.cuda.synchronize()
    eig_launches = km.kron_matvec_cuda.launches
    eig_count = int(eig_tracker.counter_value("kernels.kron_matvec.cuda"))
    Vv = V[:, valid].double()
    orth = float((Vv.T @ Vv - torch.eye(Vv.shape[1], device=dev,
                                        dtype=torch.float64)).abs().max())
    i_f, j_f = split_mixed_radix(sel, spec_m.sizes)
    P1, P2 = spec_m.vecs
    V_gather = (P1[:, i_f][:, None, :] * P2[:, j_f][None, :, :]).reshape(
        spec_m.N, svc.k_max) * valid[None, :].to(V.dtype)
    eig_err = float((V - V_gather).abs().max())
    eig = {"k_max": svc.k_max, "valid": int(valid.sum()),
           "launches": eig_launches, "counter": eig_count,
           "orthonormality_err": orth, "kernel_vs_gather": eig_err}
    print(f"assemble_eigvecs at N = {spec_m.N}: {json.dumps(eig)}")
    check(eig_launches == 1 and eig_count == 1, f"assemble_eigvecs made "
          f"{eig_launches} kron_matvec launches, counted {eig_count}, not 1")
    check(tuple(V.shape) == (spec_m.N, svc.k_max), f"V is {tuple(V.shape)}")
    check(orth <= 1e-4, f"VᵀV - I is {orth!r} > 1e-4 on the valid columns")
    check(eig_err <= 1e-6, f"kernel route vs gather route: {eig_err!r}")

    # -- 15. the k-DPP path ---------------------------------------------------
    kdpp_tracker = obs.InMemoryTracker()
    gen_k = torch.Generator(device=dev).manual_seed(3)
    kdpp_state = gen_k.get_state()
    p2.launches = 0
    with obs.use(kdpp_tracker):
        kb = main.sample(gen_k, 64, k=20)
        kdpp_rows = svc.sample_kdpp(20, 16)
        torch.cuda.synchronize()
    kdpp_launches = p2.launches
    kdpp_count = int(kdpp_tracker.counter_value("kernels.phase2_select.cuda"))
    print(f"k-DPP: model.sample(gen, 64, k=20) and svc.sample_kdpp(20, 16): "
          f"phase-2 launches {kdpp_launches}, kernels.phase2_select.cuda "
          f"{kdpp_count}")
    check(kdpp_launches == 2 and kdpp_count == 2, f"the k-DPP calls launched "
          f"phase 2 {kdpp_launches} times, counted {kdpp_count}, not 2")
    check(len(kdpp_rows) == 16, f"svc.sample_kdpp gave {len(kdpp_rows)} rows")
    for r in [*kb.to_lists(), *kdpp_rows]:
        check(len(r) == 20 and len(set(r)) == 20
              and all(0 <= i < main.N for i in r), f"a k-DPP row is not 20 "
              f"distinct items: {r}")
    replay_k = torch.Generator(device=dev)
    replay_k.set_state(kdpp_state)
    u_k = torch.rand((64, spec_m.N), generator=replay_k, device=dev)
    us_k = torch.rand((64, 20), generator=replay_k, device=dev)
    mask_k = kd._phase1_kdpp_from_uniforms(u_k, spec_m.log_eigenvalues(), 20)
    sel_k, valid_k, _ = compact_selection(mask_k, 20)
    G1_k, Gr_k = (G.contiguous() for G in p2.canonical_pair(
        gather_factor_columns(spec_m.vecs, spec_m.sizes, sel_k, valid_k)))
    ke_k = mask_k.sum(dim=1).to(torch.int32)
    pk_k = torch.where(kb.mask, kb.indices, -1).cpu().numpy()
    pp_k = p2.phase2_select_plain(us_k, ke_k, G1_k, Gr_k).cpu().numpy()
    agree_kdpp = compare_picks(pk_k, pp_k, us_k, ke_k, G1_k, Gr_k,
                               "k-DPP main path B=64 k=20")
    small_k = dpp.random_kron(gen, (2, 3))
    marg = kdpp_marginals(small_k.dense_kernel().double().cpu().numpy(), 2)
    picks_s = kd.sample_kdpp_batched(gen, small_k.spectrum(cache), 2, 3000,
                                     backend="cuda").cpu().numpy()
    check((picks_s >= 0).all() and all(len(set(r)) == 2 for r in
                                       picks_s.tolist()),
          "a (2, 3) k = 2 draw is not 2 distinct items")
    mem_k = np.zeros((3000, 6))
    mem_k[np.arange(3000)[:, None], picks_s] = 1.0
    kdpp_marg_err = float(np.abs(mem_k.mean(0) - marg).max())
    print(f"k-DPP marginals (2,3), k = 2, 3000 kernel draws: max |freq - "
          f"P(i in Y)| = {kdpp_marg_err!r}")
    check(kdpp_marg_err <= 0.04, f"k-DPP marginals off by {kdpp_marg_err}")

    # -- 16. times --------------------------------------------------------------
    sel_times = {}
    gm_times, kdpp_times = {}, {}
    for k in (20, 200):
        lcol, C, cj, dj, d = greedy_inputs(10_000, k, gen, dev)
        CTv = C.t().contiguous().t()           # the MAP loop's (k, N) layout
        b_ms, b_by = greedy_bound(10_000, k)
        args = (lcol, CTv, cj, dj, d)
        gm_times[k] = kernel_times(
            partial(gm.greedy_map_update_cuda, *args),
            partial(gm.greedy_map_update_plain, *args),
            partial(greedy_library, *args), reps=200, plain_reps=100,
            expect="greedy_map_update_kernel", bound_ms=b_ms, bound_by=b_by)
        print(f"  greedy_map_update N=10000 k={k}: "
              f"{json.dumps(gm_times[k])}")
        sel_times[f"map{k}_ms"] = cuda_ms(
            lambda: main.map(k, max_dense=10_000), reps=3, warmup=1)
        sel_times[f"map{k}_plain_ms"] = cuda_ms(
            lambda: ops.greedy_map_kdpp(L_main, k, backend="reference"),
            reps=3, warmup=1)
        # the fused selection alone on map(k)'s L (N = 10^4, one matrix)
        live = greedy_live_steps(L_main, map_picks[k])
        b_ms, b_by, b_row = kdpp_bound(10_000, k, [live])
        kdpp_times[k] = kernel_times(
            partial(gm.greedy_map_kdpp_cuda, L_main, k),
            partial(gm.greedy_map_kdpp_plain, L_main, k), None,
            reps=10, plain_reps=1, expect="greedy_map_kdpp_kernel",
            sole=True, bound_ms=b_ms, bound_by=b_by, bound_row_ms=b_row,
            live_steps=[live], steps=k,
            plan=gm.greedy_map_kdpp_plan(10_000, k, dev),
            shapes={"N": 10_000, "k": k, "H": 1})
        print(f"  greedy_map_kdpp N=10000 k={k}: "
              f"{json.dumps(kdpp_times[k])}")
    sel_times["dense_kernel_ms"] = cuda_ms(
        lambda: main.dense_kernel(10_000), reps=5, warmup=1)
    km_times = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        A = torch.randn((100, 100), generator=gen, device=dev).to(dtype)
        B = torch.randn((100, 100), generator=gen, device=dev).to(dtype)
        X = torch.randn((64, 10_000), generator=gen, device=dev).to(dtype)
        X3 = X.reshape(64, 100, 100)
        b_ms, b_by = km_bound(A, B, X)
        km_times[name] = kernel_times(
            partial(km.kron_matvec_cuda, A, B, X),
            partial(km.kron_matvec_plain, A, B, X),
            partial(torch.einsum, "ki,biu,vu->bkv", A, X3, B),
            reps=100, plain_reps=50, expect="kron_matvec_fused_kernel",
            sole=True, bound_ms=b_ms, bound_by=b_by,
            kernel_route=km.kron_matvec_route(A, B, X))
        print(f"  kron_matvec 100x100 batch 64 {name}: "
              f"{json.dumps(km_times[name])}")
    # the eigenvector path's own shape: a one-hot batch of k_max columns
    E = torch.zeros((svc.k_max, spec_m.N), device=dev)
    E[torch.arange(svc.k_max, device=dev),
      i_f.long() * spec_m.sizes[1] + j_f.long()] = 1.0
    P1c, P2c = P1.contiguous(), P2.contiguous()   # eigh's are column-major
    E3 = E.reshape(svc.k_max, *spec_m.sizes)
    b_ms, b_by = km_bound(P1c, P2c, E)
    km_times["eigvec_onehot"] = kernel_times(
        partial(km.kron_matvec_cuda, P1c, P2c, E),
        partial(km.kron_matvec_plain, P1c, P2c, E),
        partial(torch.einsum, "ki,biu,vu->bkv", P1c, E3, P2c),
        reps=100, plain_reps=50, expect="kron_matvec_fused_kernel",
        sole=True, batch=svc.k_max, bound_ms=b_ms, bound_by=b_by,
        kernel_route=km.kron_matvec_route(P1c, P2c, E))
    sel_times["assemble_eigvecs_ms"] = cuda_ms(
        lambda: assemble_eigvecs(spec_m.vecs, spec_m.sizes, sel, valid),
        reps=20, warmup=2)
    ll_m = spec_m.log_eigenvalues()
    sel_times["kdpp_sample64_ms"] = cuda_ms(
        lambda: main.sample(gen, 64, k=20), reps=5, warmup=1)
    sel_times["kdpp_esp_table_ms"] = cuda_ms(
        lambda: kd.log_esp_table(ll_m, 20), reps=5, warmup=1)
    sel_times["kdpp_phase1_ms"] = cuda_ms(
        lambda: gather_factor_columns(spec_m.vecs, spec_m.sizes,
                                      *compact_selection(kd._phase1_kdpp(
                                          gen, ll_m, 20, 64), 20)[:2]),
        reps=5, warmup=1)
    picks_kd = p2.phase2_select_cuda(us_k, ke_k, G1_k, Gr_k).cpu().numpy()
    b_ms, b_by = bound(picks_kd, *spec_m.sizes, 20)
    sel_times["kdpp_phase2"] = kernel_times(
        partial(p2.phase2_select_cuda, us_k, ke_k, G1_k, Gr_k),
        partial(p2.phase2_select_plain, us_k, ke_k, G1_k, Gr_k), None,
        reps=20, plain_reps=5, expect="phase2_select_kernel_onchip",
        sole=True, kernel_route=p2.phase2_select_route(*spec_m.sizes, 20),
        bound_ms=b_ms, bound_by=b_by,
        bound_row_ms=bound_row(picks_kd, *spec_m.sizes, 20),
        max_row_steps=int((picks_kd >= 0).sum(axis=1).max()))
    svc.sample_kdpp(20, 16)                     # warm
    kreq = []
    for _ in range(5):
        t0 = time.perf_counter()
        svc.sample_kdpp(20, 16)
        torch.cuda.synchronize()
        kreq.append((time.perf_counter() - t0) * 1e3)
    sel_times["svc_sample_kdpp16_ms"] = kreq
    sel_times["svc_sample_kdpp16_median_ms"] = float(np.median(kreq))
    print(f"  selection times: {json.dumps(sel_times)}")

    # -- 17. the inference path ----------------------------------------------
    inf = inference_path(main, guard, batch, fit_rows, gen, dev)

    # -- 18. keyed randomness -------------------------------------------------
    keyed = keyed_path(main, svc, batch, init, dev)

    # -- 19. the rest of learning ---------------------------------------------
    rest = rest_of_learning(init, batch, rep, fit_kw, dev)

    # -- 20. the low-rank family ---------------------------------------------
    lr = lowrank_path(dev)

    # -- 21. the async serving tier -----------------------------------------
    sv = serving_path(main, dev)

    # -- 22. placement ---------------------------------------------------------
    pl = placement_path(main, batch, init, rep, dev)

    # -- 23. LM serving ---------------------------------------------------------
    lms = lm_serve_path(dev)

    # -- 24. LM training with KronDPP batch selection ------------------------
    lmt = lm_train_path(dev)

    # -- 25. device times of every kernels row -------------------------------
    launch_us = [host_launch_us()]
    fill_device_times()
    fill_step_profiles()
    launch_us.append(host_launch_us())
    print(f"device times filled for every kernels row; one small launch from "
          f"the host before and after the profiler sessions: {launch_us} µs")
    print(f"profiler windows: {WINDOWS['taken']} taken, "
          f"{len(WINDOWS['retaken'])} retaken, lead marks at the end "
          f"{WINDOWS['lead_marks']}; counted windows that lost lead marks: "
          f"{len(WINDOWS['lead_lost'])}, marks lost {WINDOWS['lead_lost']}")

    # -- 26. the MoE, SSM, hybrid and encoder-decoder families -------------
    lf = lm_families_path(dev, card, power_limit)

    # -- 27. sharded LM training on an NCCL group of one rank ------------
    lsh = lm_sharded_path(dev, lmt["step_s"])

    # -- 28. the families' sharded steps and the planner ------------------
    lpl = lm_planner_path(dev, card, power_limit)

    # -- 29. the examples, and DPP pruning at full width -------------------
    ex = examples_path(dev, card, power_limit)

    # -- 30. pruning a mixture-of-experts layer at full width -------------
    moe = moe_prune_path(dev, card, power_limit)

    for t in (times[64], times[1], times["global"],
              sel_times["kdpp_phase2"], inf["phase2"],
              sv["kv"]["phase2_times"], lms["phase2_times"],
              lmt["selector"]["phase2_times"]):
        t["per_step_ms"] = t["ms"] / t["max_row_steps"]
    row = {"name": "phase2_select", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/phase2_select.cu",
           "replaces": "src/repro/kernels/phase2_select.py:172",
           "launches": launches,
           "max_abs_err": max(a["max_boundary_gap"] for a in
                              [*agree.values(), *edges, agree_main,
                               agree_kdpp, inf["agree"],
                               ex["compat"]["phase2_select_key"]]),
           **times[64], "agree_rows": agree[64]["agree_rows"],
           "b1": times[1], "agree_rows_b1": agree[1]["agree_rows"],
           "global_300x300_b8": times["global"],
           "global_dense_9995_b64": inf["phase2"],
           "global_kv_s1024_k192_b1": sv["kv"]["phase2_times"],
           "global_lm_kv_s512_k120_b1": lms["phase2_times"],
           "global_basis_selector_b16": lmt["selector"]["phase2_times"],
           "agree_rows_main_path": agree_main["agree_rows"],
           "card": card, "power_limit": power_limit}
    pt_rows = [{"name": f"partial_trace_{k}", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/partial_trace.cu",
                "replaces": f"src/repro/kernels/partial_trace.py:{line}",
                "launches": fit_launches[k],
                "launches_resumed_fit": rest["checkpoint"]["launches"][k],
                "max_abs_err": pt_check["err"][k], **pt_times[k],
                "shapes": {"N1": PT_SHAPES[0][0], "N2": PT_SHAPES[0][1]},
                "card": card, "power_limit": power_limit}
               for k, line in (("A", 51), ("C", 72))]
    ts_row = {"name": "theta_scatter", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/theta_scatter.cu",
              "replaces": "no Pallas kernel: the JAX package's mean of n "
                          "dense N x N, src/repro/core/krk_picard.py:157",
              "launches": ts_fit["launches"],
              "launches_per_build": theta_repeat["launches"] / 2,
              "max_abs_err": ts_check["report"]["max_abs_diff"],
              "check": ts_check["report"], **ts_times["padded"],
              "no_padding": ts_times["no_padding"],
              "card": card, "power_limit": power_limit}
    # the step kernel: its own entry point, ops.greedy_map_update, makes
    # its launch; no selection path launches it any more
    gm_row = {"name": "greedy_map_update", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/greedy_map.cu",
              "replaces": "src/repro/kernels/greedy_map.py:39",
              "launches": step_launches["greedy_map_update"],
              "launches_per_call": {
                  "ops.greedy_map_update": step_launches["greedy_map_update"],
                  "map20": map_launches[20]["greedy_map_update"],
                  "map200": map_launches[200]["greedy_map_update"]},
              "max_abs_err": max(gm_err, step_err), **gm_times[200],
              "shapes": {"N": 10_000, "k": 200, "C": "(k, N) buffer"},
              "k20": gm_times[20], "card": card, "power_limit": power_limit}
    for t in (kdpp_times[20], kdpp_times[200], lms["kdpp_times"]):
        t["per_step_ms"] = t["ms"] / t["steps"]
    kdpp_row = {"name": "greedy_map_kdpp", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/greedy_map.cu",
                "replaces": "src/repro/kernels/greedy_map.py:39",
                "launches": (map_launches[20]["greedy_map_kdpp"]
                             + map_launches[200]["greedy_map_kdpp"]),
                "launches_per_path": {
                    k: map_launches[k]["greedy_map_kdpp"]
                    for k in (20, 200, "guard")},
                "max_abs_err": max(
                    kdpp_check["max_tie_gap"],
                    *(c.get("tie_gap", 0.0) for c in map_cmp.values())),
                "max_abs_err_is": "largest float64 tie gap of a first "
                                  "difference, of max diag L, over phase "
                                  "12, map(k), the KV and the LM heads "
                                  "and the MoE prune",
                **kdpp_times[200],
                "k20": kdpp_times[20],
                "lm_unit_n512_k120_h4": lms["kdpp_times"],
                "map_vs_plain": map_cmp,
                "phase12": kdpp_check,
                "card": card, "power_limit": power_limit}
    km_row = {"name": "kron_matvec", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/kron_matvec.cu",
              "replaces": "src/repro/kernels/kron_matvec.py:41",
              "launches": eig_launches, "max_abs_err": km_err["float32"],
              "max_abs_err_bf16": km_err["bfloat16"],
              "max_abs_err_by_route": km_err["by_route"],
              "bf16_sass_hmma": len(hmma),
              "cases_by_route": km_err["cases"],
              **km_times["float32"],
              "shapes": {"N1": 100, "N2": 100, "batch": 64,
                         "dtype": "float32"},
              "bf16": km_times["bfloat16"],
              "eigvec_onehot": km_times["eigvec_onehot"],
              "card": card, "power_limit": power_limit}
    row["launches_kdpp"] = kdpp_launches
    row["agree_rows_kdpp"] = agree_kdpp["agree_rows"]
    row["launches_inference"] = inf["launches"]
    row["agree_rows_inference"] = inf["agree"]["agree_rows"]
    learn_timing["host_launch_us_before_after_profiler"] = launch_us
    print(json.dumps({"learning_timing": learn_timing, "card": card,
                      "power_limit": power_limit}))
    print(json.dumps({"selection_timing": sel_times, "eigvec": eig,
                      "kdpp_marginal_err": kdpp_marg_err, "card": card,
                      "power_limit": power_limit}))
    inf["times"]["phase2_global_dense_9995_b64"] = inf["phase2"]
    print(json.dumps({"inference_timing": inf["times"],
                      "inference": inf["inference"], "card": card,
                      "power_limit": power_limit}))
    row["launches_keyed"] = {k: keyed[k]["launches"]["phase2_select"]
                             for k in ("sample64", "sample64_k20")}
    row["agree_rows_keyed"] = {k: keyed[k]["agree_rows"]
                               for k in ("sample64", "sample64_k20")}
    tf_row = {"name": "threefry2x32", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/threefry.cu",
              "replaces": "no Pallas kernel: jax.random's threefry2x32, "
                          "fused by XLA, drawn at "
                          "src/repro/sampling/batched.py:240",
              "launches": tf_launches_flush,
              "launches_per_path": {"flush285": tf_launches_flush,
                                    **keyed["launches"]},
              "max_abs_err": keyed["bits"]["max_abs_err"],
              "bitwise_cases": keyed["bits"]["cases"],
              **keyed["times"][512],
              "rows16": keyed["times"][16], "rows64": keyed["times"][64],
              "split_uniform_rows16": keyed["times"]["split_uniform_16"],
              "split_uniform_rows512": keyed["times"]["split_uniform_512"],
              "card": card, "power_limit": power_limit}
    print(json.dumps({"keyed_timing": {
        "flush285_ms": keyed["flush285_ms"],
        "flush285_median_ms": keyed["flush285_median_ms"],
        "svc_sample16_ms": req, "svc_sample16_median_ms":
            float(np.median(req)), "draw_keyed": keyed["draw_keyed"],
        "learning": keyed["learning"]}, "card": card,
        "power_limit": power_limit}))
    print(json.dumps({"rest_of_learning_timing": {
        "sweep_ms": rest["sweep_ms"], "save_restore": rest["save_restore"],
        "em_eigh_ms": rest["em"]["eigh_ms"],
        "phase_s": rest["phase_s"], "fit_n": batch.n,
        "fit_k_max": batch.k_max}, "rest_of_learning": {
        k: rest[k] for k in ("joint", "picard", "em", "small_card_vs_cpu",
                             "checkpoint")},
        "card": card, "power_limit": power_limit}))
    tf_row["launches_per_path"]["lowrank"] = lr["launches"]
    row["launches_serving"] = {
        **{k: v["phase2_select"] for k, v in sv["launches"].items()},
        "kv": sv["kv"]["launches"]["phase2_select"]}
    row["agree_rows_serving"] = {
        r_["offered_rps"]: r_["vs_cpu_plain"]["agree_rows"]
        for r_ in sv["loads"]}
    tf_row["launches_per_path"]["serving"] = {
        **{k: v["threefry2x32"] for k, v in sv["launches"].items()},
        "lowrank_fleet": sv["lowrank_fleet"]["launches"]["threefry2x32"],
        "kv": sv["kv"]["launches"]["threefry2x32"]}
    gm_row["launches_per_call"]["kv_map"] = \
        sv["kv"]["map_launches"]["greedy_map_update"]
    kdpp_row["launches_per_path"]["kv_map_head"] = \
        sv["kv"]["map_launches"]["greedy_map_kdpp"]
    kdpp_row["kv_map_vs_cpu"] = sv["kv"]["map_vs_cpu"]
    kdpp_row["max_abs_err"] = max(
        kdpp_row["max_abs_err"], sv["kv"]["map_vs_cpu"].get("tie_gap", 0.0),
        *(c.get("tie_gap", 0.0) for c in lms["map_heads_vs_cpu"]))
    print(json.dumps({"serving": sv, "card": card,
                      "power_limit": power_limit}))
    print(json.dumps({"lowrank": lr, "card": card,
                      "power_limit": power_limit}))
    row["launches_placement"] = {
        k: v["phase2_select"] for k, v in pl["launches"].items()}
    tf_row["launches_per_path"]["placement"] = {
        k: v["threefry2x32"] for k, v in pl["launches"].items()}
    print(json.dumps({"placement": pl, "card": card,
                      "power_limit": power_limit}))
    lm_launch = lms["launches_per_request"]
    row["launches_per_path"] = {"lm_serve": {
        k: v["phase2_select"] for k, v in lm_launch.items()}}
    gm_row["launches_per_path"] = {"lm_serve": {
        k: v["greedy_map_update"] for k, v in lm_launch.items()}}
    kdpp_row["launches_per_path"]["lm_serve"] = {
        k: v["greedy_map_kdpp"] for k, v in lm_launch.items()}
    tf_row["launches_per_path"]["lm_serve"] = {
        "init": lms["init_launches"]["threefry2x32"],
        **{k: v["threefry2x32"] for k, v in lm_launch.items()}}
    gm_row["lm_kv_n512_k120"] = lms["greedy_times"]
    row["launches_per_path"]["lm_train"] = {
        "train8": lmt["launches"]["phase2_select"],
        "learn_cli": lmt["learn_cli"]["launches"]["phase2_select"]}
    tf_row["launches_per_path"]["lm_train"] = {
        "train8": lmt["launches"]["threefry2x32"],
        "learn_cli": lmt["learn_cli"]["launches"]["threefry2x32"]}
    for r_ in pt_rows:
        r_["launches_per_path"] = {"learn_cli": lmt["learn_cli"]["launches"][
            r_["name"]]}
    kdpp_row["launches_per_path"]["k_past_n"] = {
        k: v for k, v in lmt["k_past_n"].items() if k.endswith("launches")}
    kdpp_row["max_abs_err"] = max(kdpp_row["max_abs_err"], *(
        c.get("tie_gap", 0.0) for k, v in lmt["k_past_n"].items()
        if not k.endswith("launches") for c in v))
    print(json.dumps({"lm_serve": {k: v for k, v in lms.items()
                                   if k not in ("phase2_times",
                                                "greedy_times",
                                                "kdpp_times")},
                      "card": card, "power_limit": power_limit}))
    lt = lmt["learn_cli"]
    print(json.dumps({"training": {
        "step_ms": lmt["step_s"] * 1e3, "tokens_per_s": lmt["tokens_per_s"],
        "step_ms_all": [t * 1e3 for t in lmt["step_times_s"]],
        "max_memory_allocated_gb": lmt["max_memory_allocated_gb"],
        "memory_allocated_before_gb": lmt["memory_allocated_before_gb"],
        "select_ms_per_batch": lmt["select_ms_median"],
        "select_ms": lmt["select_ms"], "learn_sweep_ms": lt["sweep_ms"],
        "learn_wall_s": lt["wall_s"], "losses": lmt["losses"],
        "step_device_ms": lmt["step_device_ms"],
        "step_idle_share": lmt["step_idle_share"],
        "step_device_events": lmt["step_device_events"],
        "step_top_kernels_ms": lmt["step_top_kernels_ms"],
        "phase_s": lmt["phase_s"]}, "lm_train": {
            k: v for k, v in lmt.items() if k not in (
                "step_times_s", "select_ms", "losses")},
        "card": card, "power_limit": power_limit, "nvidia_smi": smi}))
    lf_launch = {a: lf[a]["launches_per_request"] for a, *_ in LF_CONFIGS}
    row["launches_per_path"]["lm_families"] = {
        a: {m: n.get("phase2_select", 0) for m, n in v.items()}
        for a, v in lf_launch.items()}
    kdpp_row["launches_per_path"]["lm_families"] = {
        a: {m: n.get("greedy_map_kdpp", 0) for m, n in v.items()}
        for a, v in lf_launch.items()}
    tf_row["launches_per_path"]["lm_families"] = {
        a: {m: n.get("threefry2x32", 0) for m, n in v.items()}
        for a, v in lf_launch.items()}
    print(json.dumps({"lm_families": lf, "card": card,
                      "power_limit": power_limit}))
    tf_row["launches_per_path"]["lm_sharded_families"] = \
        lpl["launches"]["threefry2x32"]
    row["launches_per_path"]["lm_sharded_train"] = \
        lsh["launches"]["phase2_select"]
    tf_row["launches_per_path"]["lm_sharded_train"] = \
        lsh["launches"]["threefry2x32"]
    print(json.dumps({"sharded_train": lsh, "card": card,
                      "power_limit": power_limit, "nvidia_smi": smi}))
    print(json.dumps({"sharded_families": lpl, "card": card,
                      "power_limit": power_limit, "nvidia_smi": smi}))
    ex_launch = ex["launches"]
    row["launches_per_path"]["examples"] = {
        k: v["phase2_select"] for k, v in ex_launch.items()}
    tf_row["launches_per_path"]["examples"] = {
        k: v["threefry2x32"] for k, v in ex_launch.items()}
    kdpp_row["launches_per_path"]["examples"] = {
        k: v["greedy_map_kdpp"] for k, v in ex_launch.items()}
    kdpp_row["prune_n4864_k2432"] = ex["prune"]["times"]
    kdpp_row["prune_map_vs_plain"] = ex["prune"]["map_vs_plain"]
    kdpp_row["max_abs_err"] = max(
        kdpp_row["max_abs_err"],
        ex["prune"]["map_vs_plain"].get("tie_gap", 0.0))
    print(json.dumps({"examples": {k: v for k, v in ex.items()
                                   if k != "launches"},
                      "card": card, "power_limit": power_limit,
                      "nvidia_smi": smi}))
    kdpp_row["launches_per_path"]["moe_prune"] = \
        moe["launches"]["greedy_map_kdpp"]
    kdpp_row["moe_prune_h64_n1408_k704"] = moe["routed"]["times"]
    kdpp_row["moe_prune_shared_n2816_k1408"] = moe["shared"]["times"]
    kdpp_row["max_abs_err"] = max(kdpp_row["max_abs_err"],
                                  moe["routed"]["max_tie_gap"],
                                  moe["shared"]["max_tie_gap"])
    print(json.dumps({"moe_prune": moe, "card": card,
                      "power_limit": power_limit, "nvidia_smi": smi}))
    print(json.dumps({"kernels": [row, *pt_rows, ts_row, gm_row, kdpp_row,
                                  km_row, tf_row]}))
    print(json.dumps({"timing": {"svc_sample16_ms": req,
                                 "svc_sample16_median_ms":
                                     float(np.median(req)),
                                 "phase2_select_b64": times[64],
                                 "phase2_select_b1": times[1],
                                 "dpp_phase1_ms": phase1_ms},
                      "run_s": time.perf_counter() - t_run,
                      "card": card, "power_limit": power_limit}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
