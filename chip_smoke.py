#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--old-flash SOURCE] [--old-bwd SOURCE] [--old-gossip SOURCE]
                          [--parent-flash DIR]

Phases, one result line each; any failure exits non-zero without the final
``{"ok": true, ...}`` line:

1. device   card name and power limit (nvidia-smi), torch/CUDA versions and
            both TF32 flags; TF32 is then switched off for the whole run
            (cuDNN convolutions would otherwise run f32 in TF32).
2. build    ``nvcc`` builds every kernel library from ``src/`` (five:
            fused_sgd with sgd_update and normalized_update,
            fused_transition, gossip_mix, cluster_agg, flash_attention with
            its forward and backward kernels), one process per source, all
            at once, beside the flash forward as it stood before the split
            TF32 redesign (commit db70968's ``flash_attention.cu``, from git,
            or the file ``--old-flash`` names; without either its A/B below is
            skipped and says so), the flash backward as it stood on the CUDA
            cores before its split-TF32 redesign (commit a338e16's
            ``flash_attention.cu``, or ``--old-bwd``; skipped alike) and
            gossip_mix as it took P by value in its
            launch parameters (commit 28b3742's ``gossip_mix.cu``, or
            ``--old-gossip``; skipped alike).  ptxas's report of the leaf-table kernels
            (``fused_transition_kernel``, ``sgd_update_kernel``,
            ``normalized_update_kernel``, ``cluster_agg_kernel``,
            ``gossip_mix_kernel``), of the split-TF32 kernels
            (``flash_fwd_split_tf32_kernel``,
            ``flash_bwd_dkdv_split_tf32_kernel``,
            ``flash_bwd_dq_split_tf32_kernel``) and of the wide bf16
            backward (``flash_bwd_dkdv_wide_sm90_kernel`` and the 32-key
            instantiations of ``flash_bwd_dq_sm90_kernel``): the phase
            fails if any instantiation spills registers.  ``cuobjdump -sass``
            of the flash library: the counts of ``HGMMA`` (wgmma) and
            ``UTMALDG`` (TMA load) and ``HMMA`` (mma.sync) instructions per
            kernel; the phase fails if the bf16 tensor-core forward or any of
            its four backward dK/dV and dQ kernels (hd <= 128 and wide) has
            no HGMMA or UTMALDG, or a split-TF32 kernel no HMMA.
3. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, at the leaf shapes of MnistCNN and CifarCNN stacked over
            C=20 clients in D=4 clusters, f32 and bf16.  Transition and SGD:
            the tree calls, one launch each (and a tree of 96 leaves, two
            launches); transition alpha 0/1/2, static factors and masked
            participation weights with a faulted mixing matrix (ring with one
            link down); SGD bit for bit.  The async kernels as tree calls
            (one launch a tree, every leaf bitwise its one-leaf call):
            gossip_mix D=4, alpha 0/1/2, the ring P and an eq. 22 P_t on the
            card (the kernel reads P from device memory), out of place and
            in place, every tree call also bitwise the by-value kernel on
            the same P where it was built; cluster_agg C=20 -> D=4 and the async
            g=5 -> 1, masked weights; normalized_update R=5 rows with
            1/theta per row (bitwise the plain version), and R=1; then
            ragged trees (scalar and vector leaves; gossip at D = 1, 4, 5,
            16, every register size) and 70-leaf trees (two launches).  A
            gossip or normalized-update tree that returns its input fails
            (each case moves its input by more than 10x the tolerance).
            Tolerances as the reference's kernel tests: 1e-5 f32
            transition, gossip and aggregation, 1e-6 f32 SGD and normalized
            update, 3e-2 bf16.  Then CUDA-event times of the kernel, the
            plain version and one library call computing the same function
            (where there is one), beside the bound, at the shapes of the
            path that runs the kernel (every kernel but flash as a tree
            call, against per-leaf ``torch.matmul``, one
            ``torch._foreach_add_`` for SGD, and ``torch._foreach_sub``
            plus ``torch._foreach_mul_``, two calls, for normalized_update).  Flash attention forward and backward
            against their plain versions at federated-lm-ring's (16, 64, 4,
            4, 64), granite-8b's (8, 2048, 32, 8, 128), gemma2-2b's local
            layer (1, 8192, 8, 4, 256) with window 4096 and cap 50 and its
            global layer at the gemma2-width lane's (4, 2048, 8, 4, 256)
            with cap 50, a GQA case with hd 96
            and a ragged S = 80, S = 16 (below one tile), mixtral-8x7b's
            (4, 2048, 32, 8, 128) with window 4096, pixtral-12b's hd 160,
            (2, 2048, 32, 8, 160), and two wide heads under a cap of 2,
            which bites on these unit-variance scores (hd 136 and a ragged
            hd 200 with a window), f32 and bf16
            (f32 forwards and backwards on the split-TF32 route; bf16 on
            the tensor-core route, the backwards wider
            than hd 128 on its wide kernels; 2e-5 f32 and
            3e-2 bf16 forward, as the reference's kernel tests; lse 1e-4;
            gradients 1e-4 f32 and 3e-2 bf16 relative to the largest
            reference entry),
            then timed at both LM phases' shapes, mixtral-8x7b's,
            pixtral-12b's and gemma2-2b's global layer (bf16), and the f32
            forward and backward also at granite-8b's heads, (2, 2048, 32,
            8, 128),
            against ``scaled_dot_product_attention`` (the kernel the
            profiler saw it launch is named; none under gemma2's cap, which
            no library call computes), with the achieved TFLOP/s and the
            share of the bound; the split-TF32 forward against the forward
            it replaced, built from its old source, in one process (graph
            replays, old new new old) at those two f32 shapes; the
            split-TF32 backward at those two f32 shapes and the wide bf16
            backward at pixtral's and gemma2's against the CUDA-core kernels
            that took them before, built from their old source (held within
            2e-4 f32 and 3e-2 bf16, then graph replays, old new new old),
            and their device time by kernel; and the
            device-P gossip_mix tree against the by-value one at the MNIST
            and CIFAR async shapes (graph replays, in place, by-value,
            device, device, by-value).
4. main     the main path: ``mnist-noniid-ring`` with ``tau2=2`` through
            ``build_scenario`` (which calls ``make_run``) on the default
            device, backend auto -> cuda, CUDA graphs (the default on the
            card: one graph per event kind, ``core/cuda_graph.py``), 30
            iterations (local, intra and inter events; each kind's graph
            warms up, is captured and is replayed at least twice, checked),
            run under the profiler: the kernels that ran on the device,
            counted from its records (``kernels.device_launches``), held
            exactly (one per stage, replays included: 6 transitions and 30
            SGD steps), and the wrappers' host counters, zeroed just before
            and read just after, held to each event kind's warm-up and
            capture (a replay launches nothing from the host).  The kernels
            line's ``launches`` are the device counts, ``host_launches`` the
            counters.  Held against the same run with
            the dense backend on the card (graph) and on the CPU (eager)
            (1e-4 max abs on the parameters, 1e-4 relative on the eval
            loss).  The split of one iteration into local gradient,
            ``sgd_update`` and transition (eager calls).  Then eager
            (``graph=False``) against graph in this process, three passes in
            turns eager, graph, graph, eager, every run's kernel runs and
            host launches held exactly as above: under cuDNN's deterministic
            algorithms the graph runs' parameters and eval losses are held
            to the eager-vs-eager difference of the pass; before and after
            it, under cuDNN's defaults (whose weight gradients are not
            reproducible run to run), each run's warm iterations/s, the
            profiler's busy share, busy ms and kernel launches per step, its
            peak device memory (allocated, and reserved above the turn's
            start), the bytes held in each CUDA-graph private pool (the
            three sync graphs share one), and the runs' differences,
            reported.
5. cifar    ``cifar-dirichlet-torus`` with the kernel backend: the same
            eager-vs-graph A/B over 30 iterations (6 inter events), its
            timed pass after the held one only, and the split of one
            iteration.
6. async    asynchronous SD-FEEL: ``straggler-bimodal-async`` through
            ``build_scenario`` on the default device, backend auto -> cuda,
            on its CUDA graph (the default: one ``GraphedStep`` over the
            event body, one graph for the one cluster size, ``P_t`` and the
            event's operands in its static buffers), 24 cluster events under
            the profiler, launch counters zeroed just before and read just
            after: normalized_update, cluster_agg and gossip_mix each run
            once per event on the device, replays included, and launch from
            the host at the graph's warm-up and capture only (both held
            exactly).  Held against the same run with the dense backend on
            the card (graph) and on the CPU (eager) (identical event
            sequence, 1e-4 max abs on the cluster models, 1e-4 relative on
            the eval loss).  The split of one event (the body eager and
            replayed, and its three tree calls).  Then eager against graph
            in this process, turns eager, graph, graph, eager, as the main
            phase: the held pass under deterministic cuDNN (``y`` and eval
            loss graph = eager at 0.0, the same event sequence, every run's
            device kernel runs and host launches held exactly), and timed
            passes under cuDNN's defaults: warm events/s, busy share, busy
            ms and kernel launches per event.  The held pass again for
            ``dropout-participation-async`` (masked m^, skipped events) and
            for async on a ``host-offload`` store.
7. fleet    the fleet axes, every kernel counter zeroed just before the
            phase and read just after (each of the five fleet kernels must
            have launched): ``sampled-k-ring`` (sync, C = 20 in D = 4,
            uniform-k with k = 2, ``tau2=2``, 30 iterations, one CUDA graph
            per event kind) and ``chaos-ring`` (round supersteps, R = 2, 6
            supersteps: 12 rounds under the fault trace, one graph), each
            run in turns eager, graph, eager under cuDNN's deterministic
            algorithms and the profiler: kernel runs on the device held
            exactly (graph equal to eager), host launches held to the
            graph's warm-ups and captures, parameters and losses graph
            against eager at 0.0, the kernel backend against dense (graph)
            within 1e-4; then under cuDNN's defaults warm it/s of an eager,
            a graph and an eager run.  ``dropout-participation-async``
            (graph, 24 events, masked weights in ``cluster_agg``) against
            dense on the card: the same events, ``y`` within 1e-4, one
            launch of each async kernel per cluster event.  FedAvg,
            HierFAVG and FEEL (the paper's §V baselines, C = 20), 20
            iterations each on the ``sgd_update`` kernel against their
            plain path: parameters within 1e-4, eval losses 1e-4 relative,
            wall-clock equal, 20 kernel runs each.
8. lm       federated LM training: ``federated-lm-ring`` as registered
            (reduced granite: d_model 256, 4 heads of 64, 2 layers, vocab
            512, S = 64; C = 8 in D = 4, tau1 = tau2 = 2, alpha = 2, R = 2)
            through ``build_scenario`` on the default device, backend auto
            -> cuda, attn_impl cuda: 4 supersteps (32 iterations) and one
            evaluate under the profiler, the kernels that ran on the device
            held to their exact counts (the clients fold into one attention
            launch per layer, forward and backward on the split-TF32 route;
            one SGD and one transition launch per stage
            for the 12 leaves), the supersteps replayed from one CUDA graph
            (the default; at least two replays, checked), and the launch
            counters, zeroed just before and read just after, held to the
            first two supersteps' and the evaluate's launches.  Held
            against the same run with the dense backend and plain attention
            on the card (graph) and on the CPU (eager) (1e-4 max abs on
            parameters and per-iteration losses, 1e-4 relative on the eval
            loss).  The split of one iteration, then the eager-vs-graph A/B
            of the main phase over 4 supersteps a run, its timed pass after
            the held one only (tokens/s too; the kernel runs by flash route
            held exactly on both sides).
9. lm-width eager (``graph=False``): the same scenario at granite-8b's
            published widths (d_model
            4096, d_ff 14336, 32 heads, 8 KV heads of 128, vocab 49152,
            S = 2048, bf16), cut to 2 layers, per-client batch 1 and no
            evaluate: 2 supersteps (every flash launch on the tensor-core
            route), their launches held exactly, their rate, peak device
            memory and the attention kernels' share; then one client's loss
            and gradients with the flash kernels against the plain attention;
            then the transition (the inter event: D=4, alpha=2) and SGD timed
            on the run's own 12-leaf bf16 tree in place, against the bytes
            bound and the library calls.
10. gemma2-width eager: gemma2-2b at its published widths (d_model
            2304, d_ff 9216, 8/4 heads of 256, local window 4096 on even
            layers, attention cap 50, final cap 30, post-norms, embedding
            scale, vocab 256000 tied, bf16), cut to 2 layers (local, then
            global; the window passes S = 2048, so both attend causally in
            full), C = 4 in D = 2, S = 2048, b = 1, no evaluate; on the
            round's graph its private pool took 63 GiB and the run ran out
            of memory, so eager: launches held exactly, every flash launch,
            forward and backward, on the tensor cores (the backward on the
            wide kernels), rate, peak memory, a superstep's device time by
            part with the flash backward's ms, one client's loss and
            gradients flash vs plain (1e-2 and 5e-2), and the bf16 trees
            against their plain versions.
11. families the model families at ``reduced()`` widths (f32), every LM
            counter set to 0 just before the phase and read just after:
            ``federated-lm-ring`` with ``model=CausalLM(...)`` for
            mixtral-8x7b, grok-1-314b, mamba2-780m, jamba-1.5-large-398b
            (one block of 8 layers) and pixtral-12b, 3 supersteps of one
            round each,
            an eager and a graph run under deterministic algorithms (``warn_only``; the ops without
            a deterministic implementation are named) and the profiler:
            graph = eager at 0.0, the graph replayed, kernel runs on the
            device exact (flash per attention layer, none for mamba2; the
            leaf-table kernels per table of one dtype), an eager session
            short of its host launches raising ``ShortSessionError``; the
            dense backend with plain attention within 1e-4 on parameters
            and per-iteration losses (jamba's reported, ``FAMILY_CHAOTIC``);
            one fleet iteration from the graph run's state, flash against
            plain, within 1e-4; musicgen-large's reduced model on (2, 4,
            64) codebook tokens, loss and gradients flash against plain
            within 1e-5.
12. moe-width mixtral-8x7b at its published widths (d_model 4096, d_ff
            14336, 8 experts top-2, capacity factor 1.25, 32/8 heads of
            128, window 4096, vocab 32000, bf16), cut to 1 layer, C = 4 in
            D = 2, S = 2048, b = 1, no evaluate, on the round's CUDA graph
            (its peak leaves room for the pool): host launches held to the
            graph's warm-up and capture (two leaf tables a tree call: the
            f32 router and the bf16 rest; every flash launch on the tensor
            cores), cold and warm it/s and tokens/s, peak memory, one
            replayed superstep's kernel runs held exactly and its device
            time by part from the kernels' names (GEMMs, sort, index,
            gather and scatter, flash, SGD, transition, the rest) and busy
            share, the expert GEMMs timed alone with CUDA events at the
            run's shapes (``expert_gemms_ms``), the first MoE layer's
            dropped assignments and the tokens that flash and plain
            attention route to different experts, at the initial and the
            trained state; the first layer's attention flash vs plain at
            the model's activations (output and vjp within 5e-2 in relative
            norm), one client's loss flash vs plain within 1e-2 (its
            gradients reported: a token moved across a router tie sends its
            gradients to other experts), and the mixed trees against their
            plain versions, then timed.
13. ssm-width eager: mamba2-780m at its published widths (d_model 1536,
            48 SSD heads of 64, state 128, conv 4, chunk 128, vocab 50280,
            tied, bf16), C = 8 in D = 4, S = 2048, b = 1, 2 supersteps a
            run: an A/B at 4 layers in one process, remat off (the split by
            kernel name, the SSD core and its inter-chunk loop timed alone
            with CUDA events (``ssd_ms``), the mixed trees against their
            plain versions) against remat on (peak memory, it/s), one
            client's gradients remat on against off (bitwise, or within 1e-6
            relative in f32 leaves and a bf16 ulp in bf16 ones); then remat
            on at 24 layers (at least 12 must run; 48 fitted in 40.30 GiB
            when it was tried, before the flash-rows phase took its time).
            No flash launch, the mixed SGD and transition launches held,
            finite losses.
14. offload host-offloaded client state (``repro_torch.state``), every
            kernel counter zeroed just before the phase and read just after
            (each of the five fleet kernels must have launched):
            ``million-client-ring`` as registered (10^6 procedural clients,
            a ``host-offload`` store of k_max = 32 slots in D = 8 clusters,
            uniform-k with k = 4, round supersteps of tau1 = 2) in turns
            eager, graph, graph, eager under deterministic cuDNN and the
            profiler, 6 supersteps each: graph = eager at 0.0, kernel runs on
            the device held exactly and equal, host launches held to the
            graph's warm-up and capture, the graph captured once and replayed
            for every residency; then warm supersteps/s of eager and graph
            runs, their busy ms, busy share and kernel and copy launches a
            superstep, peak memory, and the host's milliseconds a superstep
            by part (residency plan, weights, batch draw, staging, gather,
            scatter, replay).  Peak device memory at 10^6 against 10^3
            clients (10^3, then 10^6), held within 10%.  The
            transition at the lane's shapes (32 rows, D = 8: the kernel's
            MAXD = 8 instantiation, a padding slot at weight 0) against its
            plain version (1e-5) and timed against it, per-leaf matmul and
            the bound.  The main path's backend: its factors contiguous, one
            inter transition copying nothing (the allocator's count: 0
            static, 1 weighted, the product ``B * w``).
            Identity offload (k_max = N = 20) against the dense store on
            ``mnist-noniid-ring`` (sync, graphs): 0.0.  Client mode at 10^6
            clients spilled to a temporary directory: exactly the
            participants stored, and equal to cluster mode at 0.0.
            ``dropout-participation-async`` with a store against resident
            state: the same events, ``y`` at 0.0.
15. examples the port's examples (``repro_torch.examples``) through their
            ``main`` on the card, cut in run length: ``quickstart`` 20
            iterations, ``async_heterogeneous`` 12 events (its async runs on
            the graph), ``train_federated_lm`` 16 iterations at d_model 256
            and 2 layers; finite losses.
16. serve    the serving slice at reduced sizes (f32):
            ``serve_scenario("federated-lm-serving")`` and
            ``serve_scenario("lm-serving-continuous", continuous=True)`` on
            the card (the LM kernels' counters zeroed before each; the flash
            forward, SGD and transition must launch) held token for token,
            with ``ServeStats``' counts, against the same calls on the CPU;
            a mid-stream publish (in-flight requests keep their tokens, later
            ones match a fresh server on the published weights), the chunk
            graph captured once across buckets, admissions and the swap, its
            replay equal to the eager chunk at 0.0 under deterministic
            algorithms; ``generate`` on seven reduced families, audio
            included (prefill logits within 1e-3 of the CPU's, tokens in the
            vocabulary, agreement reported).
17. serve-width granite-8b at its published widths and all 36 layers,
            bf16, two random replicas made on the card:
            ``ContinuousFederatedServer`` (8 slots, buckets 512/1024/2048,
            gen_cap 256, chunks of 8 steps on one CUDA graph) on a
            32-request ``synthetic_trace`` at vocab 49,152, then
            ``FederatedServer`` on the same trace: tokens/s, TTFT p50/p95,
            ms a decode step (CUDA events around every chunk, and a full
            pool alone), decode attention's share, the span share (the
            event-spanned prefills and chunks over the wall), peak memory
            serving and at set-up, all timed in the default (not
            deterministic) mode; held: chunk graph = eager at 0.0 (the eager
            chunk under deterministic algorithms), a 2048-token prefill
            flash against plain within 5e-2 in relative norm with its 36
            flash forwards counted in an eager session, every token in the
            vocabulary; the flash forward at (1, S, 32, 8, 128) against its
            plain version at each bucket S (bf16 tolerance 3e-2, lse 1e-4),
            timed at 2048 against the plain version, SDPA and the bound.

18. collective-width one ``build_fl_train_step`` iteration with
            ``impl="gossip"`` (the collective backend: hypercube all-reduce
            and ring gossip, plain PyTorch) at lm-width's granite-8b widths,
            C = 8 in D = 4, alpha = 2, eager: the flash counters set to 0
            before it, its flash runs on the device (profiler) all on the
            tensor-core route, a finite loss, CUDA-event ms and peak memory;
            then the collective transition on the step's output tree against
            ``CudaBackend.transition`` (``fused_transition``) on the same tree,
            every element within one bf16 ulp plus 2^-20 of its leaf's
            largest input (two f32 summation orders, one cast), both timed
            (CUDA events), and the collective's transient bytes; the plain
            versions of the transition and SGD kernels timed on the tree.
19. mesh     the process-group path as one NCCL rank (one card):
            ``init_process_group("nccl", world_size=1)`` with a timeout and
            ``make_client_mesh(1)``; ``ppermute`` of one client's bf16 tree
            at lm-width's model bitwise (a rank its own partner copies),
            timed beside ``copy_`` of the same bytes and the bytes bound
            (a same-device clone: the transition never makes a rank its
            own partner), ``gather_rows`` (NCCL all-gather) bitwise and
            timed, and the schedulers' mesh reductions on the tree:
            ``fleet_weighted_sum`` (NCCL all-reduce, timed),
            ``cluster_sums_on_mesh`` (NCCL broadcast) and
            ``gather_rows_to_host``, each bitwise; the
            sharding rules for all ten configs at published widths on meta
            tensors (each at least half its bytes on ``model``), and
            ``distribute_params`` of the tree onto a 1x1 ``DeviceMesh`` and
            back, bitwise; ``make_concrete_batch`` for granite-8b at the
            four input shapes on the card.  Then 'graphs on a mesh': the
            exchanges the captured mesh steps call (``gather_rows`` into a
            fixed buffer, ``fleet_weighted_sum``, ``cluster_sums_on_mesh``,
            ``dense_transition_on_mesh``, ``ppermute`` with the rank its
            own partner, ``fleet_mean_losses``) on the tree in one
            ``GraphedStep``: warm-up, capture, three replays, each bitwise
            an eager run of the body on the same (changed) inputs; one
            replay's device records against one eager call's (NCCL kernels
            and copies by name, a padded profiler session), the host's
            launch calls at a replay (one ``cudaGraphLaunch``), the replay
            and the eager call timed (CUDA events); and
            ``core/capture_check.py``'s ``nccl-outstanding`` case in a
            process of its own, started after the phase's timed sections
            (beside the untimed input shapes).  A profiler session of the
            device records that kept none of its pad raises
            ``ShortSessionError`` (the phase runs again).  The group is
            destroyed at the end of the phase, also when it fails.
20. launch   the training CLI through ``repro_torch.launch.train.main``:
            ``--scenario list``; ``mnist-noniid-ring`` 20 iterations on the
            auto backend (SGD and transition kernels launched);
            ``federated-lm-ring --backend collective --mesh auto`` (prints
            that the mesh resolved to none) against ``--backend dense``
            within 1e-4; the LM path saved and resumed (``resumed from round
            2``, finite losses); a reduced ``build_fl_train_step`` at
            per-client batch 2, ``microbatch=2`` against 1 within 1e-5.
21. steps    the step builders of ``launch.steps`` on a ``(data=1,
            model=1)`` NCCL ``DeviceMesh`` (one rank): ``build_serve`` of
            granite-8b at its published widths and 36 layers (bf16) on
            decode_32k cut to batch 4, a full 32,768-slot cache, 4 decode
            steps through ``make_decode_impl`` (the third wraps the ring),
            bitwise ``CausalLM.decode_step`` on a copy of the cache;
            ``build_prefill`` on prefill_32k cut to batch 1, bitwise
            ``CausalLM.prefill``, its 36 flash forwards on the tensor-core
            route; ``build_train`` at lm-width's cut (C = 4 in D = 2 on the
            rank, ``impl="dense"``), its flash forward and backward and
            ``fused_transition`` run on the device, against
            ``build_fl_train_step`` within one bf16 ulp of each leaf's
            largest magnitude.  ms a decode step and a prefill (CUDA events)
            and the peak memory; each step's own peak (its operands plus
            the rise of allocated memory during it) for the dryrun phase.
22. dots     remat's ``"dots"`` policy at lm-width's cut: one vmapped
            gradient of 4 clients with remat off, ``"full"`` and
            ``"dots"``, bitwise across the three, each one's peak memory
            above the operands and warm gradients a second.
23. dryrun   the dry run in a child process that never initializes CUDA:
            granite-8b decode_32k traced on the production mesh (256 fake
            ranks, ``"cuda"``-typed), and the steps phase's three steps
            traced on a (1, 1) fake mesh, each held against that phase's
            measurement (predicted peak within 10%, measured ms at least
            0.95x ``max(compute, memory)``); the card's ``total_memory``
            held equal to ``roofline.analysis.HW["device_memory"]``.
24. mesh-serve ``ContinuousFederatedServer(mesh=)`` on one NCCL rank (D = 1:
            plumbing, no exchange between cards), the reference's check
            config (f32), then one replica of granite-8b at its published
            widths cut to ``MESH_SERVE_WIDTH["layers"]`` layers (bf16) under
            deterministic algorithms, each with ``graph=True`` (the chunk's
            token all-reduce in its graph: one capture, its replays counted)
            and ``graph=False``, the tokens of both equal to each other and
            to the off-mesh server's.
25. flash-rows sequence-parallel attention through the flash kernels'
            query-row map ('flash rows'): at gemma2-2b's published
            attention widths (8/4 heads, hd 256, bf16, cap 50, S 4096,
            512-row chunks, the model axis's 16 ranks emulated one by one;
            window 4096, 1024 and none), at hd 128 bf16 on 2 ranks and at
            f32 hd 64 (the split-TF32 route both ways), each rank's
            map call against its plain version, the ranks' rows and dQ rows
            against the full kernel's and their summed dK and dV against
            the full kernel's; launch counters zeroed before and read
            after, each route's device runs counted; the map-less calls of
            every route against the kernels before the map (built from
            ``--parent-flash DIR`` or git; skipped and said so without
            either): bitwise, but for the split-TF32 backward, whose
            arithmetic replaced the parent's CUDA-core one (within 1e-4 f32
            and 3e-2 bf16 of the parent's largest entry); the map call timed at gemma2-2b's rank-1 shape beside
            its bound from the map's live pairs, the plain version, and
            ``scaled_dot_product_attention`` with the map's boolean mask
            where no cap or window bites.
26. optim   (run after lm-width) the stateful optimizers, the transition,
            SGD and flash counters set to 0 just before and read just after
            (the transition and both flash wrappers must launch): momentum on
            ``round-superstep-ring``'s graph and eagerly (turns eager, graph,
            graph, eager; graph = eager at 0.0, one capture, the momentum
            buffers at fixed addresses, the transition's device runs a
            superstep equal to SGD's, no ``sgd_update`` run, within 1e-4 of
            the CPU); momentum on ``million-client-ring`` at 10^6 clients (the
            state zero before each superstep's body, moved after it); and
            lm-width's model on ``build_fl_round_step`` (C = 4 in D = 2)
            with SGD, momentum (f32 state) and Adam (bf16 state, per client
            from ``torch.func.vmap(opt.init)``): peak memory, warm
            supersteps/s, flash and transition device runs, and the update
            alone against its bytes bound.  ``Smoke.optim``.

The smoke's total time, build included, and each phase's are printed
before the kernels line.

A profiler session sometimes loses device records (``ROADMAP.md`` §3),
which falsifies a launch count and nothing else.
``kernels.device_kernel_names`` notes each graph replay whose every record
was lost (a recorded ``cudaGraphLaunch`` no CUDA record shares a
correlation id with), and each phase prints how many its sessions lost.  A
phase that fails after such a loss, or on ``ShortSessionError`` (an eager
session with fewer device runs than host launches), runs once more, from
the start, and is held exactly as before; a phase that fails otherwise, or
fails twice, fails the run.

``--phases NAME ...`` runs only those phases (after device and build) and
prints no kernels or result line: a development run.

The line before the last is the kernels' JSON record (the flash,
transition and SGD entries also carry, under ``width``, their granite-8b
bf16 numbers and the ``lm-width`` launches, the flash entries under
``mixtral_width``, ``hd160`` and ``gemma2_global`` those shapes' (the
wide backward's with its A/B under ``ab``, and under ``serve_width`` the
prefill's flash forwards and the forward at (1, 2048, 32, 8, 128)), the LM kernels
``families_host_launches``, ``moe_width_launches`` and
``gemma2_width_launches``, the flash entries' ``collective_width_launches``
(device runs and host launches of the collective-width step), the
transition's ``collective_width`` (the collective transition against it at
granite widths), the SGD and transition ``launch_host_launches`` (the launch
phase's mnist-noniid-ring run), the transition and SGD
``moe_width``/``ssm_width``/``gemma2_width`` (their trees) and
``ssm_width_launches``, ``fleet_host_launches`` and
``offload_host_launches`` the fleet and offload phases' host counts, the
flash and transition entries' ``steps_launches`` their device runs in the
steps phase's train step, the
transition's ``offload_maxd8`` its D = 8 numbers, gossip_mix's
``by_value_ab`` its A/B against the by-value kernel at MNIST, and the flash
entries' ``flash_rows`` (the map call timed at gemma2-2b's rank-1 shape)
and ``flash_rows_launches`` (host launches in the flash-rows phase), and
the transition and flash entries' ``optim`` (host launches in the optim
phase, device runs a superstep of each lm-width optimizer run)); the async
kernels' ``launches`` are their runs on the device in the async phase's
graphed run, ``host_launches`` the wrappers' counts there; the last line is
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data-sheet memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 peak outside the tensor cores
SPLIT_TF32_FLOPS_PER_S = 495e12 / 3  # dense TF32 peak over split TF32's 3 products
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
C, D, LR = 20, 4, 0.05
G = C // D                  # clients per cluster: the async event's rows
THETAS = (1.0, 3.0, 7.0, 8.0, 3.0)  # per-row eq. 19 factors 1/theta for R = G
ASYNC_EVENTS = 24
KERNELS = {
    "fused_transition": {
        "source": "src/repro_torch/kernels/fused_transition/csrc/fused_transition.cu",
        "replaces": "src/repro/kernels/fused_transition/kernel.py:39",
    },
    "sgd_update": {
        "source": "src/repro_torch/kernels/fused_sgd/csrc/sgd_update.cu",
        "replaces": "src/repro/kernels/fused_sgd/kernel.py:23",
    },
    "gossip_mix": {
        "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix/kernel.py:29",
    },
    "cluster_agg": {
        "source": "src/repro_torch/kernels/cluster_agg/csrc/cluster_agg.cu",
        "replaces": "src/repro/kernels/cluster_agg/kernel.py:27",
    },
    "normalized_update": {
        "source": "src/repro_torch/kernels/fused_sgd/csrc/normalized_update.cu",
        "replaces": "src/repro/kernels/fused_sgd/kernel.py:29",
    },
    "flash_attention": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_split_tf32.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
    },
    "flash_attention_backward": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd_split_tf32.cu",
        # no TPU kernel: the reference differentiates its plain attention
        "replaces": "none (gradient of src/repro/kernels/flash_attention/kernel.py:34)",
    },
}
# (B, S, Hq, Hkv, hd, window, cap): federated-lm-ring's registered shape (C*B
# = 8*2 folded), granite-8b's (C = 8, batch 1), gemma2-2b's local layer at S
# = 8192 (where its window bites) and its global layer at the gemma2-width
# lane's (C = 4 folded, S = 2048), a GQA case with hd 96 and a ragged S, S
# below one tile, mixtral-8x7b's at the moe-width lane (C = 4, its window
# 4096 past S), pixtral-12b's hd 160, and the wide backward's two tiles under a
# cap of 2: the inputs' scores have unit variance, so under cap 50 the cap's
# derivative stays above 0.99 and only a cap this small holds the kernel to it
FLASH_SHAPES = {
    "federated-lm-ring": (16, 64, 4, 4, 64, None, None),
    "granite-8b": (8, 2048, 32, 8, 128, None, None),
    "gemma2-2b": (1, 8192, 8, 4, 256, 4096, 50.0),
    "gemma2-2b-global": (4, 2048, 8, 4, 256, None, 50.0),
    "gqa-hd96-ragged": (2, 80, 8, 2, 96, None, None),
    "short-s16": (2, 16, 8, 2, 128, None, None),
    "mixtral-8x7b": (4, 2048, 32, 8, 128, 4096, None),
    "pixtral-12b": (2, 2048, 32, 8, 160, None, None),
    "cap2-hd136": (2, 80, 8, 2, 136, None, 2.0),
    "cap2-hd200-ragged": (2, 200, 8, 2, 200, 64, 2.0),
}
# the f32 forward at granite-8b's head layout (B = 2), timed beside the lm shape
GRANITE_F32 = (2, 2048, 32, 8, 128, None, None)
# 'flash rows', sequence-parallel attention: each of the model axis's ranks
# takes rl = chunk / ranks rows of every query chunk against the whole K and
# V, in one call through the query-row map.  gemma2-2b's published attention
# widths (8/4 heads, hd 256, cap 50, its 512-row chunks, S 4096, the
# production model axis's 16 ranks emulated one by one), then hd 128 bf16 on
# 2 ranks and f32 hd 64 (the split-TF32 forward and backward):
# (name, (B, S, Hq, Hkv, hd), dtype, chunk, ranks, windows, cap)
FLASH_ROWS = (
    ("gemma2-2b", (1, 4096, 8, 4, 256), "bfloat16", 512, 16, (4096, 1024, None), 50.0),
    ("hd128-m2", (1, 2048, 32, 8, 128), "bfloat16", 512, 2, (None, 1024), None),
    ("f32-hd64", (2, 1024, 8, 2, 64), "float32", 256, 4, (None, 200), None),
)
# spin kernels of no wrapper before the flash-rows phase's counted calls:
# after the smoke's other phases a session lost its first 17-39 records
FLASH_ROWS_PAD = 64
# the flash sources at the parent of the query-row map, which the map-less
# calls are held bitwise against (``--parent-flash`` or git)
PARENT_FLASH = ("29bd8ca", tuple(
    f"src/repro_torch/kernels/flash_attention/csrc/{name}.cu"
    for name in ("flash_attention", "flash_attention_sm90", "flash_attention_split_tf32")))
# the forward before the split-TF32 redesign: its source at this commit
OLD_FLASH = ("db70968", "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu")
# the CUDA-core backward before the split-TF32 redesign (f32 at every hd, bf16
# with hd % 8 != 0): its source at this commit, the launcher of today's signature
OLD_BWD = ("a338e16", "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu")
# gossip_mix as it took P by value in its launch parameters: its source at this commit
OLD_GOSSIP = ("28b3742", "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu")
# the bf16 tensor-core kernels of csrc/flash_attention_sm90.cu, which the
# build phase requires to hold wgmma and TMA-load instructions: every
# instantiation of a name, and each named instantiation (the wide dQ tiles)
FLASH_SM90 = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu"
WIDE_DQ = ("flash_bwd_dq_sm90_kernel<160, 4, 32>", "flash_bwd_dq_sm90_kernel<256, 3, 32>")
SM90_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                "flash_bwd_dq_sm90_kernel", "flash_bwd_dkdv_wide_sm90_kernel") + WIDE_DQ
# the split-TF32 kernels, which the build phase requires to hold mma.sync
# instructions (HMMA in SASS) and not to spill
SPLIT_KERNELS = ("flash_fwd_split_tf32_kernel", "flash_bwd_dkdv_split_tf32_kernel",
                 "flash_bwd_dq_split_tf32_kernel")
LM_STEPS, LM_WIDTH_STEPS = 4, 2
# the families phase: federated-lm-ring on each family's reduced() model (f32),
# supersteps a run (the graph's warm-up, capture and a replay)
FAMILIES = ("mixtral-8x7b", "grok-1-314b", "mamba2-780m", "jamba-1.5-large-398b", "pixtral-12b")
FAMILY_STEPS = 3
# layers a family lane keeps where reduced() has more: jamba's one block of 8
# (attention at offset 4, MoE every second layer), for the phase's time
FAMILY_LAYERS = {"jamba-1.5-large-398b": 8}
# the family lanes' supersteps, cut to make room for the steps phase: one
# round (4 iterations, an intra and an inter event) where the scenario takes
# two (on the H100 the phase took 177.3 s at two, jamba's
# lane 87.9 of it, and 156.5 with jamba's alone at one, jamba 58.3)
FAMILY_ROUNDS_PER_STEP = 1
# families whose training amplifies f32 rounding so fast that two runs of the
# same math drift apart within a superstep: reduced jamba (16 layers, or the
# lane's 8, at the scenario's learning rate 0.1; the CPU's plain versions
# against dense+plain over 3 supersteps: 2.3e-2 and 2.8e-2) grows a 2.4e-7 difference about 3x an
# iteration and then flips MoE routing (the CPU, one client, plain attention
# against the flash op's plain version: 1.5e-2 after 10 steps; on the card,
# 5.5e-2 over 3 supersteps).  Its full-run difference from dense+plain is
# reported; one fleet iteration from the same state is held, as for every
# family
FAMILY_CHAOTIC = ("jamba-1.5-large-398b",)
# the width lanes: a published config cut in depth, eager, supersteps a run
MOE_WIDTH = dict(num_layers=1, num_clients=4, num_clusters=2, seq_len=2048, batch_size=1)
# mamba2's depth as memory allows: a layer takes 1.26 GB of a client's
# activations at S = 2048 and the tied head 1.5 GB (a CPU trace of live
# tensors at these widths, C = 1), so C = 8 holds 4 layers in about 57 GB
SSM_WIDTH = dict(num_layers=4, num_clients=8, num_clusters=4, seq_len=2048, batch_size=1)
# with remat on, the depths ssm-width tries, deepest first, and the
# supersteps a run; 80 GB holds all 48 layers, as a CPU trace of live
# tensors (tests/test_torch_remat.py's peak_grad_bytes) puts one client's
# remat gradient at 58.6 MB a layer and 1.68 GB besides at S = 2048
# (PERF.md), and the 48-layer run showed; 24 keeps the phase's time down
SSM_DEPTHS, SSM_STEPS = (24,), 2
# the serve phase: the serving scenarios' training supersteps, requests and
# generation cap; the reduced families generate is run on
SERVE_STEPS, SERVE_REQUESTS, SERVE_GEN = 2, 12, 12
SERVE_STATS = ("requests", "batches", "tokens_generated", "decode_steps", "occupancy_sum")
SERVE_FAMILIES = ("granite-8b", "mixtral-8x7b", "gemma2-2b", "mamba2-780m",
                  "jamba-1.5-large-398b", "pixtral-12b", "musicgen-large")
# the serve-width phase: granite-8b at all 36 layers, D = 2 random replicas
SERVE_WIDTH = dict(replicas=2, max_batch=8, buckets=(512, 1024, 2048), gen_cap=256,
                   chunk_steps=8, requests=32, prompt_lens=(512, 1024, 2048))
SERVE_FULL_CHUNKS = 4  # chunk replays timed with every slot active
# mesh-serve at published widths: one granite-8b replica of this depth (bf16)
# on a cluster mesh of one NCCL rank, on a synthetic trace of these prompts
MESH_SERVE_WIDTH = dict(layers=4, max_batch=4, buckets=(128, 256, 512), gen_cap=32,
                        chunk_steps=4, requests=8, prompt_lens=(128, 256, 512))
# the steps phase: granite-8b's decode_32k cut to this batch and these decode
# steps (from position 32,766: the third wraps the ring), and lm-width's
# model in C = 4 clients, D = 2 clusters stacked on the rank
STEPS_DECODE = dict(batch=4, steps=4)
STEPS_TRAIN = dict(clients=4, clusters=2)
# the steps phase's gradient check: a local step (no transition, the update
# is the gradient alone) of lm-width's model with f32 weights and bf16
# activations, so each update spans hundreds of f32 ulps of its weight at
# this learning rate, in C = D = 2
STEPS_LOCAL = dict(clients=2, clusters=2, learning_rate=1.0)
# limits on each leaf's |update - the direct step's update| / |the direct
# step's update|: after the inter step (the transition's mixing dominates
# the update) and after the local step (the gradient alone).  On the H100
# the gaps were 1.6e-7 (the head; the transition, fused_transition against
# the dense product) and 0.0 at every leaf; a skipped update gives 1, a
# wrong gradient about as much, and 1e-2 leaves room for another GEMM
# algorithm between the per-client and the vmapped step
STEPS_UPDATE_TOL = dict(inter=1e-5, local=1e-2)
# the dots phase: lm-width's model, one vmapped local gradient of this many
# clients a call, timed this many times after a warm-up
DOTS = dict(clients=4, timed=3)
DRYRUN_TIMEOUT = 600  # seconds the dryrun phase's child may take
# the collective-width phase: lm-width's model (LM_WIDTH) in C = 8 clients,
# D = 4 clusters (g = 2, a power of two, as the hypercube needs)
COLLECTIVE_WIDTH = dict(clients=8, clusters=4)
# gemma2-2b's depth cut to one local (even) and one global layer; its window
# 4096 passes S = 2048, so both layers attend causally in full
GEMMA2_WIDTH = dict(num_layers=2, num_clients=4, num_clusters=2, seq_len=2048, batch_size=1)
WIDTH_STEPS = 3  # a graph's warm-up, capture and a replay
# a width lane's device time by part, from kernel names (first match wins)
WIDTH_PARTS = (("flash", ("flash_",)), ("sgd_update", ("sgd_update_kernel",)),
               ("fused_transition", ("fused_transition_kernel",)),
               ("gemm", ("gemm", "nvjet", "cutlass", "xmma")), ("sort", ("sort", "Sort")),
               ("index_gather_scatter", ("index", "gather", "scatter")))
# sync iterations a run is compared over: at tau1 = 5, tau2 = 2 three intra
# and three inter events, so each event kind's graph warms up on its first
# call, captures on its second and is replayed twice
SYNC_ITERS = 30
PHASE_ATTEMPTS = 2  # a phase runs again only after a session in it lost device records
# the fleet phase: chaos-ring supersteps a run (12 rounds at R = 2, past every
# fault event and server 2's rejoin), warm steps timed after the held runs,
# and each baseline's iterations
FLEET_SUPERSTEPS, FLEET_WARM, FLEET_BASELINE_ITERS = 6, 30, 20
FLEET_PROFILED = 10  # steps profiled after the warm ones (busy ms, kernel launches)
# the offload phase: million-client-ring (10^6 clients, k_max = 32 slots in D = 8
# clusters, R = 1 round of tau1 = 2 iterations a superstep); supersteps a held
# run (a graph's warm-up, capture and 4 replays), warm supersteps timed after
# it, the fleet its memory is compared at, and the host parts' timed supersteps
OFFLOAD_STEPS, OFFLOAD_WARM, OFFLOAD_SMALL, OFFLOAD_HOST_STEPS = 6, 10, 1000, 10
OFFLOAD_EVENTS = 12  # dropout-participation-async events with and without a store
OFFLOAD = "million-client-ring"
LM_WIDTH = dict(
    arch_overrides=dict(num_layers=2, d_model=4096, d_ff=14336, num_heads=32, num_kv_heads=8,
                        head_dim=128, dtype="bfloat16", attn_chunk=512),
    vocab_size=49152, seq_len=2048, batch_size=1, num_samples=16,
    graph=False,  # stays eager: 99% busy, and its 61 GiB peak leaves no room for a pool
)
ASYNC_KERNELS = ("normalized_update", "cluster_agg", "gossip_mix")
# the optim phase: round-superstep-ring with momentum (supersteps a run), and
# lm-width's model on build_fl_round_step (C clients in D clusters, one
# iteration a superstep; supersteps timed warm, and update calls timed alone)
OPTIM_ROUND, OPTIM_STEPS, OPTIM_SAMPLES = "round-superstep-ring", 3, 400
OPTIM_WIDTH = dict(clients=4, clusters=2, timed=3, update_reps=3, adam_lr=1e-4)
# the async phase's A/B: events a run, warm events timed after it, events profiled
ASYNC_WARM, ASYNC_PROFILED = 48, 12
# the examples phase: each example's arguments on the card, cut in run length
EXAMPLES = {
    "quickstart": ["--iters", "20", "--eval-every", "10"],
    "async_heterogeneous": ["--events", "12"],
    "train_federated_lm": ["--steps", "16", "--layers", "2", "--d-model", "256", "--seq", "64",
                           "--batch", "2", "--heads", "4", "--kv-heads", "2", "--vocab", "2048",
                           "--samples", "64"],
}
# the kernels that take a table of leaves (one launch per tree), by library
LEAF_TABLE_KERNELS = {"fused_transition": ("fused_transition_kernel",),
                      "fused_sgd": ("sgd_update_kernel", "normalized_update_kernel"),
                      "cluster_agg": ("cluster_agg_kernel",),
                      "gossip_mix": ("gossip_mix_kernel",)}
# the kernels the build phase fails if ptxas spills registers in, by library
# (the wide backward's hold an HD/2 accumulator of up to 128 registers a thread)
SPILL_CHECKED = {**LEAF_TABLE_KERNELS,
                 "flash_attention": SPLIT_KERNELS + ("flash_bwd_dkdv_wide_sm90_kernel",) + WIDE_DQ}


def mangled(kname: str) -> str:
    """The part of a kernel's mangled symbol that names it: ``name`` as it
    is, ``name<a, b>`` (int template arguments) as ``nameILiaELibEE``."""
    name, _, args = kname.partition("<")
    if not args:
        return name
    return name + "I" + "".join(f"Li{a.strip()}E" for a in args.rstrip(">").split(",")) + "E"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--old-flash", type=Path, default=None,
                    help="CUDA source of the flash forward before the split-TF32 redesign "
                         f"(default: {OLD_FLASH[1]} at commit {OLD_FLASH[0]}, from git)")
    ap.add_argument("--old-bwd", type=Path, default=None,
                    help="CUDA source of the flash backward on the CUDA cores, before its "
                         f"split-TF32 redesign (default: {OLD_BWD[1]} at commit {OLD_BWD[0]}, "
                         "from git)")
    ap.add_argument("--old-gossip", type=Path, default=None,
                    help="CUDA source of gossip_mix with P by value in its parameters "
                         f"(default: {OLD_GOSSIP[1]} at commit {OLD_GOSSIP[0]}, from git)")
    ap.add_argument("--parent-flash", type=Path, default=None, metavar="DIR",
                    help="a folder with the three flash sources before the query-row map "
                         f"(default: commit {PARENT_FLASH[0]}'s, from git); the flash-rows "
                         "phase holds the map-less calls bitwise against them")
    ap.add_argument("--phases", nargs="+", default=None, metavar="PHASE",
                    help="run only these phases after device and build (a partial run: it "
                         "prints no kernels line and no result line)")
    ap.add_argument("--dryrun-child", type=Path, default=None, metavar="OUT",
                    help=argparse.SUPPRESS)  # the dryrun phase's child process
    args = ap.parse_args()
    if args.dryrun_child is not None:
        dryrun_child(args.dryrun_child)
        return
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    Smoke(torch, args.old_flash, args.old_gossip, args.phases, args.parent_flash,
          args.old_bwd).run()


def dryrun_child(out: Path) -> None:
    """The dryrun phase's traces (``Smoke.dryrun``), written to ``out`` as
    JSON, in a process that never initializes CUDA: granite-8b
    ``decode_32k`` on the production mesh (``launch.dryrun.run_one``), then
    the steps phase's three steps on a ``"cuda"``-typed ``(1, 1)`` mesh of a
    fake process group, each with its predicted peak and roofline terms."""
    import dataclasses

    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, InputShape
    from repro_torch.core import FLSpec
    from repro_torch.launch import build_prefill, build_serve, build_train
    from repro_torch.launch.dryrun import _operands, run_one, trace_step
    from repro_torch.roofline import HW, roofline_terms

    res = {"production": dict(run_one("granite-8b", "decode_32k", "single"), ok=True)}
    dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1), mesh_dim_names=("data", "model"))
    cfg = get_config("granite-8b")
    tcfg = dataclasses.replace(cfg, vocab_size=LM_WIDTH["vocab_size"],
                               **LM_WIDTH["arch_overrides"])
    sc = SHAPES["decode_32k"].seq_len
    c, d = STEPS_TRAIN["clients"], STEPS_TRAIN["clusters"]
    fl = FLSpec(c, d, tau1=1, tau2=1, alpha=1, learning_rate=0.01, impl="dense")
    plans = {
        "decode": (build_serve(cfg, InputShape("decode_32k", sc, STEPS_DECODE["batch"],
                                               "decode"), mesh), sc - 1),
        "prefill": (build_prefill(cfg, InputShape("prefill_32k", SHAPES["prefill_32k"].seq_len,
                                                  1, "prefill"), mesh), 0),
        "train": (build_train(tcfg, InputShape("lm-width", LM_WIDTH["seq_len"], c, "train"),
                              mesh, fl=fl), 0),
    }
    res["steps"] = {}
    for name, ((step, abstract), pos) in plans.items():
        kind = "train" if name == "train" else name
        counter, memory, secs = trace_step(step, _operands(step, abstract, kind, mesh, pos))
        res["steps"][name] = {"peak_bytes": memory["argument_bytes"] + counter.peak_bytes,
                              "memory": memory, "roofline": roofline_terms(counter).as_dict(),
                              "trace_s": secs, "kernels": dict(counter.kernels)}
    dist.destroy_process_group()
    res["cuda_initialized"] = torch.cuda.is_initialized()
    res["hw_device_memory"] = HW["device_memory"]
    out.write_text(json.dumps(res, default=str))


class Smoke:
    def __init__(self, torch, old_flash=None, old_gossip=None, only=None, parent_flash=None,
                 old_bwd=None):
        self.torch = torch
        self.t0 = time.perf_counter()  # the smoke's total time runs from here, build included
        self.only = None if only is None else set(only) | {"device", "build"}
        self.dev = torch.device("cuda")
        self.failed: list[str] = []
        self.detail: dict = {}
        # each kernel's record; the kernels phase fills the timed fields, and
        # later phases add theirs (a partial run starts from empty records)
        self.record: dict = collections.defaultdict(dict)
        self.old_flash_src = old_flash
        self.old_flash = None  # the old forward's launcher, once built
        self.old_bwd_src = old_bwd
        self.old_bwd = None  # the CUDA-core backward's launcher, once built
        self.old_gossip_src = old_gossip
        self.old_gossip = None  # the by-value gossip_mix launcher, once built
        self.old_gossip_cases = 0  # tree calls held bitwise against it
        self.parent_flash_src = parent_flash
        self.parent_flash = None  # the parent's flash library, once built

    # -- helpers -------------------------------------------------------------
    def phase(self, name, fn):
        import gc

        if self.only is not None and name not in self.only:
            return
        t0 = time.perf_counter()
        for attempt in range(1, PHASE_ATTEMPTS + 1):
            seen = len(self.session_losses())
            try:
                fn()
            except Exception as err:  # report every phase, then fail the run
                traceback.print_exc()
                lost = self.note_losses(name, seen)
                short = type(err).__name__ == "ShortSessionError"  # records lost, by definition
                if (lost or short) and attempt < PHASE_ATTEMPTS:
                    print(f"[{name}] failed after {lost} of its profiler sessions lost graph "
                          f"replays' records{' and an eager session came back short' * short}; "
                          f"the phase runs again", flush=True)
                    self.detail.setdefault("phases_run_again", []).append(name)
                    gc.collect()
                    self.torch.cuda.synchronize()
                    continue
                self.failed.append(name)
                print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s", flush=True)
            else:
                self.note_losses(name, seen)
                print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s", flush=True)
            break
        self.detail.setdefault("phase_seconds", {})[name] = time.perf_counter() - t0
        # what a phase left (its runs, their graphs, pools and staged batches,
        # also when it failed) is freed before the next phase captures
        gc.collect()
        self.torch.cuda.synchronize()

    @staticmethod
    def session_losses() -> list:
        """``kernels.device_kernel_names.losses``: the graph replays (or an
        empty session's launches), a list for each profiler session that lost
        some, whose device records were lost (none before the kernels package
        is imported)."""
        kernels = sys.modules.get("repro_torch.kernels")
        return kernels.device_kernel_names.losses if kernels is not None else []

    def note_losses(self, name, seen) -> int:
        """Print and keep the losses of the sessions since the ``seen``-th;
        how many sessions lost records."""
        new = self.session_losses()[seen:]
        if new:
            print(f"  {name}: {len(new)} profiler sessions lost every device record of "
                  f"{[len(lost) for lost in new]} recorded launches; first "
                  f"{[lost[:3] for lost in new[:3]]}", flush=True)
            self.detail.setdefault("session_losses", {}).setdefault(name, []).extend(
                lost[:20] for lost in new)
        return len(new)

    def cuda_ms(self, fn, reps=20, warmup=3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(self, fn, reps=20) -> float:
        """Device time of ``fn``'s launches replayed from a CUDA graph: the
        same kernels without the host's per-call Python and launch cost."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return self.cuda_ms(graph.replay, reps=reps)

    def stacked_leaves(self, model_cls, dtype, seed=0, rows=C):
        torch = self.torch
        shapes = {k: tuple(v.shape) for k, v in model_cls().init(torch.Generator()).items()}
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return {k: torch.randn((rows,) + s, generator=gen, device=self.dev).to(dtype)
                for k, s in shapes.items()}

    def bound(self, byts, flops, peak=F32_FLOPS_PER_S):
        """(ms, what bounds it): the larger of bytes over the memory rate and
        flops over the peak of the inputs' type (f32 unless given)."""
        tb, to = byts / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def async_operands(self):
        """Operands of the async kernels, device f32: the ring P and an eq. 22
        P_t (gossip_mix reads P from device memory), masked (C,) weights and
        the per-row eq. 19 factors."""
        import numpy as np
        from repro_torch.core import ClusterSpec, mixing_matrix, ring, staleness_mixing_matrix

        torch = self.torch
        rng = np.random.default_rng(1)
        spec = ClusterSpec(C, tuple(i // G for i in range(C)), tuple(rng.uniform(0.5, 2.0, C)))
        f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
        gaps = np.array([3.0, 0.0, 5.0, 1.0])  # cluster 1 fires
        mixings = {"ring": f32(mixing_matrix(ring(D), spec.m_tilde())).to(self.dev),
                   "p_t": f32(staleness_mixing_matrix(ring(D), 1, gaps)).to(self.dev)}
        mask = np.ones(C, bool)
        mask[1::G] = mask[3::G] = False
        w = np.where(mask, spec.data_sizes, 0.0)
        tot = np.zeros(D)
        np.add.at(tot, list(spec.assignments), w)
        masked = f32(w / tot[list(spec.assignments)]).to(self.dev)
        m_hat = f32(spec.m_hat()).to(self.dev)
        inv = 1.0 / torch.tensor(THETAS, device=self.dev)
        return mixings, masked, m_hat, inv

    def factors(self):
        import numpy as np
        from repro_torch.core import ClusterSpec, chain, mixing_matrix, ring

        rng = np.random.default_rng(0)
        spec = ClusterSpec(C, tuple(i // (C // D) for i in range(C)),
                           tuple(rng.uniform(0.5, 2.0, C)))
        f32 = lambda a: self.torch.tensor(np.asarray(a), dtype=self.torch.float32, device=self.dev)
        vt, bt = f32(spec.V().T), f32(spec.B().T)
        p = f32(mixing_matrix(ring(D), spec.m_tilde()))
        # masked participation: drop two clients per cluster, renormalize m^
        mask = np.ones(C, bool)
        mask[1::5] = mask[3::5] = False
        w = np.where(mask, spec.data_sizes, 0.0)
        tot = np.zeros(D)
        np.add.at(tot, list(spec.assignments), w)
        vt_masked = bt.T * f32(w / tot[list(spec.assignments)])[None, :]
        # faulted mixing: the ring with link (0, 3) down is a chain
        p_fault = f32(mixing_matrix(chain(D), spec.m_tilde()))
        return {"static": (vt, p, bt), "masked+faulted": (vt_masked, p_fault, bt)}

    # -- phases --------------------------------------------------------------
    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        self.smi = smi
        print(smi, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}; "
              f"tf32 as found: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("tf32 switched off for every phase below (matmul and cuDNN)", flush=True)
        self.detail["device"] = {"nvidia_smi": smi, "torch": torch.__version__,
                                 "cuda": torch.version.cuda, "tf32": False}

    def build(self):
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        old = self.start_old(OLD_FLASH, self.old_flash_src, "old_flash", "flash forward")
        old_bwd = self.start_old(OLD_BWD, self.old_bwd_src, "old_bwd", "CUDA-core flash backward")
        old_gossip = self.start_old(OLD_GOSSIP, self.old_gossip_src, "old_gossip",
                                    "by-value gossip_mix")
        parent = self.start_parent_flash()
        libs = _build.build_all()
        self.finish_old_flash(old)
        self.finish_old_bwd(old_bwd)
        self.finish_old_gossip(old_gossip)
        self.finish_parent_flash(parent)
        dt = time.perf_counter() - t0
        print(f"built {sorted(libs)} in {dt:.2f}s (parallel nvcc, one per source; sm_90a)",
              flush=True)
        for name, log in _build.build_logs.items():
            regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
            print(f"  {name} ptxas: {' | '.join(regs)}", flush=True)
        self.detail["build_s"] = dt
        self.detail["spill_checked_ptxas"] = self.check_spills()
        self.detail["flash_sass"] = self.sass_counts(libs["flash_attention"])

    def start_old(self, at, given, key, what):
        """Start ``nvcc`` on a kernel's source as it stood at commit ``at[0]``
        (``given``, a file from the command line, else ``git show`` of
        ``at``); returns (library path, process) or None where no source is
        at hand (``self.detail[key]`` says which)."""
        from repro_torch.kernels import _build

        out_dir = _build._build_root()
        out_dir.mkdir(parents=True, exist_ok=True)
        src = given
        stem = Path(at[1]).stem
        if src is None:
            got = subprocess.run(["git", "-C", str(HERE), "show", f"{at[0]}:{at[1]}"],
                                 capture_output=True, text=True)
            if got.returncode != 0:
                print(f"{what} at {at[0]}: no source given and no git history here "
                      f"({got.stderr.strip()[:120]}): its A/B is skipped", flush=True)
                self.detail[key] = "skipped: no source"
                return None
            src = out_dir / f"{stem}_{at[0]}.cu"
            src.write_text(got.stdout)
        so = out_dir / f"lib{stem}_old_{at[0]}.so"
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.detail[key] = str(src)
        return so, proc

    def start_parent_flash(self):
        """Start ``nvcc`` on the three flash sources as they stood before the
        query-row map (``--parent-flash``, else ``git show`` of
        ``PARENT_FLASH``), one library; None where they are not at hand."""
        from repro_torch.kernels import _build

        out_dir = _build._build_root() / f"parent_flash_{PARENT_FLASH[0]}"
        out_dir.mkdir(parents=True, exist_ok=True)
        srcs = []
        for path in PARENT_FLASH[1]:
            name = Path(path).name
            if self.parent_flash_src is not None:
                srcs.append(self.parent_flash_src / name)
                continue
            got = subprocess.run(["git", "-C", str(HERE), "show", f"{PARENT_FLASH[0]}:{path}"],
                                 capture_output=True, text=True)
            if got.returncode != 0:
                print(f"flash sources at {PARENT_FLASH[0]}: none given and no git history here "
                      f"({got.stderr.strip()[:120]}): the map-less calls' bitwise hold "
                      f"against them is skipped", flush=True)
                self.detail["parent_flash"] = "skipped: no source"
                return None
            (out_dir / name).write_text(got.stdout)
            srcs.append(out_dir / name)
        so = out_dir / "libflash_attention_parent.so"
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                                 *map(str, srcs)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.detail["parent_flash"] = [str(x) for x in srcs]
        return so, proc

    def finish_parent_flash(self, started) -> None:
        """Bind the parent's launchers (its signatures: one S, no map)."""
        import ctypes

        if started is None:
            return
        so, proc = started
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's flash sources:\n{log}")
        spills = {sym[-90:]: r for sym, r in self.ptxas_report(log).items() if r["spill_stores"]}
        print(f"  the parent's flash kernels ({PARENT_FLASH[0]}) built; ptxas spills: "
              f"{spills or 'none'}", flush=True)
        lib = ctypes.CDLL(str(so))
        tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        fns = {}
        for key, sym, ptrs in (("split_tf32", "flash_attention_fwd_split_tf32_launch", 5),
                               ("tensor_core", "flash_attention_fwd_sm90_launch", 5),
                               ("cuda_core_bwd", "flash_attention_bwd_launch", 10),
                               ("tensor_core_bwd", "flash_attention_bwd_sm90_launch", 10)):
            fn = getattr(lib, sym)
            fn.argtypes = [ctypes.c_void_p] * ptrs + tail
            fn.restype = ctypes.c_int
            fns[key] = fn
        lib.flash_attention_sm90_rows.argtypes = [ctypes.c_int]
        fns["rows"] = lib.flash_attention_sm90_rows
        self.parent_flash = fns

    def finish_old_flash(self, started) -> None:
        import ctypes

        if started is None:
            return
        so, proc = started
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old flash source:\n{log}")
        fn = ctypes.CDLL(str(so)).flash_attention_fwd_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.old_flash = fn

    def finish_old_bwd(self, started) -> None:
        """Bind the CUDA-core backward's ``flash_attention_bwd_launch``: the
        arguments of today's backward launchers."""
        import ctypes

        if started is None:
            return
        so, proc = started
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the CUDA-core flash backward's source:\n{log}")
        fn = ctypes.CDLL(str(so)).flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.old_bwd = fn

    def finish_old_gossip(self, started) -> None:
        """Bind the by-value ``gossip_mix_launch``: the same arguments as
        today's, with P in host memory."""
        import ctypes

        if started is None:
            return
        so, proc = started
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the by-value gossip_mix source:\n{log}")
        spills = {s: r for s, r in self.ptxas_report(log).items() if r["spill_stores"]}
        print(f"  by-value gossip_mix ({OLD_GOSSIP[0]}) built; ptxas spills: {spills or 'none'}",
              flush=True)
        fn = ctypes.CDLL(str(so)).gossip_mix_launch
        fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        self.old_gossip = fn

    def old_gossip_tree(self, tree: dict, p, alpha: int, p_host=None, inplace=False) -> dict:
        """``gossip_mix_tree(tree, p, alpha, inplace)`` through the by-value
        kernel: the same leaf table, P copied from host memory into the
        launch parameters (``p_host``, a host copy made once, or a copy of
        ``p`` made here)."""
        import ctypes

        torch = self.torch
        from repro_torch.kernels._leaves import leaf_outputs, plan_launches

        d = p.shape[0]
        flats = [y.view(d, y.numel() // d) for y in tree.values()]
        outs = leaf_outputs([(tuple(y.shape), y.dtype) for y in flats],
                            flats if inplace else [None] * len(flats), flats[0].device)
        leaves = [(y.dtype, y.shape[1], (y.data_ptr(), o.data_ptr()))
                  for y, o in zip(flats, outs)]
        host = p_host if p_host is not None else p.detach().to("cpu", torch.float32).contiguous()
        codes = {torch.float32: 0, torch.bfloat16: 1}
        stream = torch.cuda.current_stream().cuda_stream
        for dtype, members in plan_launches(leaves):
            rows = []
            for i, vec in members:
                _, m, (y_ptr, o_ptr) = leaves[i]
                rows += (y_ptr, o_ptr, m, vec)
            rc = self.old_gossip((ctypes.c_longlong * len(rows))(*rows), len(members),
                                 host.data_ptr(), d, alpha, codes[dtype], stream)
            if rc != 0:
                raise RuntimeError(f"by-value gossip_mix launch failed: cudaError_t {rc}")
        return {k: o.view(y.shape) for (k, y), o in zip(tree.items(), outs)}

    @staticmethod
    def ptxas_report(log: str) -> dict:
        """``{kernel symbol: {"registers", "stack", "spill_stores"}}`` from a
        ``-Xptxas -v`` build log."""
        report, cur = {}, None
        for ln in log.splitlines():
            found = re.search(r"Function properties for (\S+)", ln)
            if found:
                cur = found.group(1)
                report[cur] = {"registers": None, "stack": None, "spill_stores": None}
                continue
            found = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
            if found and cur:
                report[cur]["stack"], report[cur]["spill_stores"] = map(int, found.groups())
            found = re.search(r"Used (\d+) registers", ln)
            if found and cur:
                report[cur]["registers"] = int(found.group(1))
        return report

    def check_spills(self) -> dict:
        """Every instantiation of the kernels of ``SPILL_CHECKED``, with its
        registers and spills; raises if ptxas reports a spill store in one."""
        from repro_torch.kernels import _build

        found = {}
        for lib, knames in SPILL_CHECKED.items():
            if lib not in _build.build_logs:
                raise AssertionError(f"no ptxas report for kernels/{lib}")
            report = self.ptxas_report(_build.build_logs[lib])
            for kname in knames:
                rep = {sym: r for sym, r in report.items() if mangled(kname) in sym}
                if not rep or any(r["spill_stores"] is None for r in rep.values()):
                    raise AssertionError(f"{kname}: no ptxas spill report in the build log")
                for sym, r in rep.items():
                    print(f"  ptxas {kname} {sym}: {r['registers']} registers, {r['stack']} "
                          f"bytes stack, {r['spill_stores']} bytes spill stores", flush=True)
                spilled = {sym: r for sym, r in rep.items() if r["spill_stores"]}
                if spilled:
                    raise AssertionError(f"{kname}: ptxas spills registers in {spilled}")
                found[kname] = rep
        return found

    @staticmethod
    def sass_counts(lib) -> dict:
        """``{kernel symbol: {"HGMMA": n, "UTMALDG": n, "HMMA": n}}`` from
        ``cuobjdump -sass`` of the flash library; raises unless every bf16
        tensor-core kernel holds wgmma and TMA loads (HGMMA, UTMALDG) and
        every split-TF32 kernel holds mma.sync (HMMA)."""
        from repro_torch.kernels import _build

        cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        counts, cur = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                cur = ln.split("Function :")[1].strip()
                counts[cur] = {"HGMMA": 0, "UTMALDG": 0, "HMMA": 0}
            elif cur is not None:
                for op in ("HGMMA", "UTMALDG"):
                    counts[cur][op] += op in ln
                counts[cur]["HMMA"] += re.search(r"\bHMMA\.", ln) is not None
        for sym, c in counts.items():
            print(f"  sass {sym}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}, HMMA {c['HMMA']}",
                  flush=True)
        for kname in SM90_KERNELS:
            found = {sym: c for sym, c in counts.items() if mangled(kname) in sym}
            if not found or not all(c["HGMMA"] and c["UTMALDG"] for c in found.values()):
                raise AssertionError(f"{kname}: no HGMMA/UTMALDG in the built library ({found})")
        for kname in SPLIT_KERNELS:
            found = {sym: c for sym, c in counts.items() if mangled(kname) in sym}
            if not found or not all(c["HMMA"] for c in found.values()):
                raise AssertionError(f"{kname}: no HMMA (mma.sync) in the built library ({found})")
        return counts

    def kernels(self):
        torch = self.torch
        from repro_torch.models import CifarCNN, MnistCNN

        factors = self.factors()
        worst = {"fused_transition": 0.0, "sgd_update": 0.0}
        main_err = {}
        for mname, mcls in (("mnist", MnistCNN), ("cifar", CifarCNN)):
            for dtype, t_tol, s_tol in ((torch.float32, 1e-5, 1e-6), (torch.bfloat16, 3e-2, 3e-2)):
                leaves = self.stacked_leaves(mcls, dtype)
                for fname, (vt, p, bt) in factors.items():
                    for alpha in (0, 1, 2):
                        err, _ = self.hold_transition_tree(leaves, vt, p, bt, alpha, t_tol,
                                                           f"{mname} {dtype} {fname}", 1)
                        worst["fused_transition"] = max(worst["fused_transition"], err)
                        if (mname, dtype, fname, alpha) == ("mnist", torch.float32, "static", 1):
                            main_err["fused_transition"] = err
                grads = self.stacked_leaves(mcls, dtype, seed=1)
                err = self.hold_sgd_tree(leaves, grads, s_tol, f"{mname} {dtype}", 1)
                worst["sgd_update"] = max(worst["sgd_update"], err)
                if (mname, dtype) == ("mnist", torch.float32):
                    main_err["sgd_update"] = err
                print(f"  {mname} {str(dtype)[6:]}: transition tree (2 factor sets x alpha 0-2) "
                      f"and sgd_update tree agree with their plain versions, one launch each",
                      flush=True)
        # more leaves than one table holds: CifarCNN's and MnistCNN's leaves
        # four times over (96), f32, two launches per tree
        many = {f"{i}.{k}": w for i in range(4) for mcls in (CifarCNN, MnistCNN)
                for k, w in self.stacked_leaves(mcls, torch.float32, seed=10 + i).items()}
        groups = self.launch_groups(many)
        vt, p, bt = factors["masked+faulted"]
        err, _ = self.hold_transition_tree(many, vt, p, bt, 2, 1e-5, f"{len(many)} leaves",
                                           groups)
        worst["fused_transition"] = max(worst["fused_transition"], err)
        grads = {k: torch.randn_like(w) for k, w in many.items()}
        worst["sgd_update"] = max(worst["sgd_update"], self.hold_sgd_tree(
            many, grads, 1e-6, f"{len(many)} leaves", groups))
        print(f"  {len(many)} leaves f32: {groups} launches per tree, both kernels agree with "
              f"their plain versions", flush=True)
        del many, grads
        self.check_async_kernels(worst, main_err)
        self.check_flash(worst, main_err)
        print(f"max abs err over all cases: {json.dumps(worst)}", flush=True)
        self.detail["max_abs_err_all_cases"] = worst

        timings = {}
        for mname, mcls in (("mnist", MnistCNN), ("cifar", CifarCNN)):
            timings[mname] = self.time_kernels(mcls, factors["static"])
            timings[mname].update(self.time_async_kernels(mcls))
            for kname, t in timings[mname].items():
                print(f"  time {mname} f32 {kname}: " + ", ".join(
                    f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in t.items()
                ), flush=True)
        self.detail["timings_f32"] = timings
        flash = self.time_flash()
        self.detail["timings_flash"] = flash
        for kname in KERNELS:
            t = flash["federated-lm-ring"] if kname in flash["federated-lm-ring"] else \
                timings["mnist"]
            self.record[kname] = dict(t[kname], max_abs_err=main_err[kname])
            for sname, extra in (("granite-8b", "width"), ("mixtral-8x7b", "mixtral_width"),
                                 ("pixtral-12b", "hd160"),
                                 ("gemma2-2b-global", "gemma2_global")):
                if kname in flash[sname]:
                    w = flash[sname][kname]
                    self.record[kname][extra] = {
                        "shape": w["shape"], "dtype": w["dtype"], "route": w["route"],
                        "source": FLASH_SM90 if w["route"] == "tensor_core" else
                        KERNELS["flash_attention_backward"]["source"],
                        "max_abs_err": main_err[f"{kname}@{sname}"],
                        **{f: w[f] for f in ("ms", "graph_ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "tflops",
                                             "bound_share", "ab", "kernels_ms") if f in w}}
        for kname in ("flash_attention", "flash_attention_backward"):  # split TF32 at width
            g = flash["granite-f32"][kname]
            self.record[kname]["f32_width"] = {
                "max_abs_err": main_err[f"{kname}@granite-f32"],
                **{f: g[f] for f in ("shape", "dtype", "route", "ms", "graph_ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms", "graph_library_ms",
                                     "tflops", "bound_share", "graph_bound_share",
                                     "library_kernels", "ab", "kernels_ms") if f in g}}

    @staticmethod
    def launch_groups(tree: dict) -> int:
        """Launches one call of a leaf-table kernel takes for ``tree``."""
        from repro_torch.kernels.fused_transition.ops import plan_launches

        return len(plan_launches([(w.dtype, 0, ()) for w in tree.values()]))

    def hold_transition_tree(self, leaves, vt, p, bt, alpha, tol, what, launches,
                             chunk=None) -> tuple:
        """The tree call (out of place) against the plain version leaf by
        leaf, ``chunk`` columns at a time where given (to bound the plain
        version's memory), and its launch count.  Raises unless the error is
        within ``tol`` and the transition moves its input by more than 10x
        ``tol``, so that a kernel returning its input fails; returns (max
        abs error, max abs move)."""
        torch = self.torch
        from repro_torch.kernels import (
            fused_transition, fused_transition_ref, fused_transition_tree,
        )

        n = fused_transition.launches
        out = fused_transition_tree(leaves, vt, p, bt, alpha=alpha)
        torch.cuda.synchronize()
        if fused_transition.launches - n != launches:
            raise AssertionError(f"fused_transition {what}: {fused_transition.launches - n} "
                                 f"launches, expected {launches}")
        err = moved = 0.0
        for k, w in leaves.items():
            w2, o2 = w.reshape(w.shape[0], -1), out[k].view(w.shape[0], -1)
            step = chunk or w2.shape[1]
            for a in range(0, w2.shape[1], step):
                ref = fused_transition_ref(w2[:, a:a + step], vt, p, bt, alpha).float()
                err = max(err, (o2[:, a:a + step].float() - ref).abs().max().item())
                moved = max(moved, (w2[:, a:a + step].float() - ref).abs().max().item())
        del out
        if not err <= tol:
            raise AssertionError(f"fused_transition {what} alpha={alpha}: max abs err {err} > "
                                 f"{tol}")
        if not moved > 10 * tol:
            raise AssertionError(f"fused_transition {what} alpha={alpha}: the transition moves "
                                 f"its input by {moved} at most, too little to tell a kernel "
                                 f"that returns its input at tol {tol}")
        return err, moved

    def hold_sgd_tree(self, leaves, grads, tol, what, launches, chunk=None) -> float:
        """The tree call (out of place) against the plain version, which it
        must equal bit for bit, ``chunk`` elements at a time where given,
        and its launch count; returns the max abs error."""
        torch = self.torch
        from repro_torch.kernels import sgd_update, sgd_update_ref, sgd_update_tree

        n = sgd_update.launches
        out = sgd_update_tree(leaves, grads, LR)
        torch.cuda.synchronize()
        if sgd_update.launches - n != launches:
            raise AssertionError(f"sgd_update {what}: {sgd_update.launches - n} launches, "
                                 f"expected {launches}")
        err = 0.0
        for k, w in leaves.items():
            wf, gf, of = w.reshape(-1), grads[k].reshape(-1), out[k].reshape(-1)
            step = chunk or wf.numel()
            for a in range(0, wf.numel(), step):
                ref, got = sgd_update_ref(wf[a:a + step], gf[a:a + step], LR), of[a:a + step]
                e = (got.float() - ref.float()).abs().max().item()
                if not (e <= tol and torch.equal(got, ref)):
                    raise AssertionError(f"sgd_update {what} {k}: max abs err {e}, not bitwise "
                                         f"equal")
                err = max(err, e)
        return err

    def check_async_kernels(self, worst: dict, main_err: dict) -> None:
        """gossip_mix, cluster_agg and normalized_update against their plain
        versions, as tree calls (each leaf also bitwise its one-leaf call);
        fills ``worst`` (every case) and ``main_err`` (MnistCNN f32 at the
        async path's operands: P_t with alpha 1, g -> 1, R = 5)."""
        import numpy as np
        torch = self.torch
        from repro_torch.kernels import cluster_agg, cluster_agg_ref, cluster_agg_tree
        from repro_torch.models import CifarCNN, MnistCNN

        mixings, masked, m_hat, inv = self.async_operands()
        for name in ASYNC_KERNELS:
            worst[name] = 0.0

        def hold(name, got, ref, tol, what, main):
            if got.numel() == 0:
                return
            err = (got.float() - ref.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} {what}: max abs err {err} > {tol}")
            worst[name] = max(worst[name], err)
            if main:
                main_err[name] = max(main_err.get(name, 0.0), err)

        for mname, mcls in (("mnist", MnistCNN), ("cifar", CifarCNN)):
            for dtype, tol, n_tol in ((torch.float32, 1e-5, 1e-6), (torch.bfloat16, 3e-2, 3e-2)):
                main = (mname, dtype) == ("mnist", torch.float32)
                what = f"{mname} {str(dtype)[6:]}"
                ys = self.stacked_leaves(mcls, dtype, seed=2, rows=D)
                ws = self.stacked_leaves(mcls, dtype, seed=3)
                w0s = self.stacked_leaves(mcls, dtype, seed=4)
                for pname, p in mixings.items():
                    for alpha in (0, 1, 2):
                        self.hold_gossip_tree(ys, p, alpha, tol, f"{what} {pname}", hold,
                                              main and pname == "p_t" and alpha == 1)
                wf = {k: w[:G] for k, w in ws.items()}
                w0 = {k: w[:G] for k, w in w0s.items()}
                self.hold_norm_tree(wf, w0, inv, n_tol, f"{what} R=5", hold, main)
                self.hold_norm_tree({k: w[0] for k, w in wf.items()},
                                    {k: w[0] for k, w in w0.items()}, 1.0 / 7.0, n_tol,
                                    f"{what} R=1 scalar", hold, False)
                for k in ws:
                    w = ws[k].reshape(C, -1)
                    hold("cluster_agg", cluster_agg(w, masked, D),
                         cluster_agg_ref(w, masked, D), tol, f"{what} {k} C->D", False)
                    hold("cluster_agg", cluster_agg(w[:G], masked[:G], 1),
                         cluster_agg_ref(w[:G], masked[:G], 1), tol,
                         f"{what} {k} g->1 masked", False)
                # the tree calls: one launch each, every leaf bitwise the
                # per-leaf call and within tol of the plain version
                for case, tree, wt, d in (("C->D masked", ws, masked, D), ("g->1", wf, m_hat[:G], 1)):
                    n = cluster_agg.launches
                    out = cluster_agg_tree(tree, wt, d)
                    torch.cuda.synchronize()
                    if cluster_agg.launches - n != self.launch_groups(tree):
                        raise AssertionError(f"cluster_agg tree {what} {case}: "
                                             f"{cluster_agg.launches - n} launches")
                    for k, w in tree.items():
                        flat = w.reshape(w.shape[0], -1)
                        got = out[k].reshape(d, -1)
                        if not torch.equal(got, cluster_agg(flat, wt, d)):
                            raise AssertionError(f"cluster_agg tree {what} {case} {k}: "
                                                 f"not bitwise the per-leaf call")
                        hold("cluster_agg", got, cluster_agg_ref(flat, wt, d), tol,
                             f"{what} {k} tree {case}", main and case == "g->1")
                torch.cuda.synchronize()
                print(f"  {what}: gossip_mix tree (ring, P_t x alpha 0-2, out of place and in "
                      f"place), normalized_update tree (R=5, R=1) and cluster_agg (C->D, g->1, "
                      f"masked) agree with their plain versions, one launch a tree, bitwise "
                      f"their one-leaf calls", flush=True)
        # ragged trees (an offset view and odd widths take the scalar path),
        # D on every register size of gossip_mix (MAXD 4, 8, 16)
        for dtype, tol, n_tol in ((torch.float32, 1e-5, 1e-6), (torch.bfloat16, 3e-2, 3e-2)):
            for d in (1, 4, 5, 16):
                p = np.random.default_rng(d).uniform(0.0, 1.0, (d, d))
                p = torch.tensor(0.9 * p / p.sum(axis=0), dtype=torch.float32, device=self.dev)
                self.hold_gossip_tree(self.ragged_leaves(d, dtype, d), p, 2, tol,
                                      f"ragged {str(dtype)[6:]} D={d}", hold, False)
            self.hold_norm_tree(self.ragged_leaves(G, dtype, 20), self.ragged_leaves(G, dtype, 21),
                                inv, n_tol, f"ragged {str(dtype)[6:]}", hold, False)
        # more leaves than one table holds: two launches per tree
        many = {f"l{i}": torch.randn(G, 18 + 3 * i, device=self.dev) for i in range(70)}
        self.hold_gossip_tree({k: w[:D].contiguous() for k, w in many.items()}, mixings["p_t"], 1,
                              1e-5, "70 leaves", hold, False)
        self.hold_norm_tree(many, {k: torch.randn_like(w) for k, w in many.items()}, inv, 1e-6,
                            "70 leaves", hold, False)
        torch.cuda.synchronize()
        print("  ragged trees (D = 1, 4, 5, 16; scalar and vector leaves, f32 and bf16) and "
              "70-leaf trees (two launches each): gossip_mix and normalized_update agree",
              flush=True)
        self.detail["gossip_vs_by_value"] = (
            f"bitwise in every gossip_mix tree case ({self.old_gossip_cases} trees x alpha)"
            if self.old_gossip is not None else self.detail.get("old_gossip"))
        print(f"  gossip_mix reading P from device memory against the by-value kernel of "
              f"{OLD_GOSSIP[0]} on the same P: {self.detail['gossip_vs_by_value']}", flush=True)

    def ragged_leaves(self, rows, dtype, seed) -> dict:
        """``(rows, ...)`` leaves mixing vector and scalar paths: M = 0, M =
        10 (MnistCNN's b4), an odd M, aligned M, a 3-D leaf and an offset
        view (off a 16-byte boundary)."""
        torch = self.torch
        gen = torch.Generator(device="cuda").manual_seed(seed)
        mk = lambda *shape: torch.randn(shape, generator=gen, device=self.dev).to(dtype)
        buf = mk(rows * 1024 + 2)
        return {"m0": mk(rows, 0), "m10": mk(rows, 10), "m333": mk(rows, 333),
                "m1024": mk(rows, 1024), "m16000": mk(rows, 16_000), "w3d": mk(rows, 5, 5, 8),
                "offset": buf[2:].view(rows, 1024)}

    def hold_gossip_tree(self, tree, p, alpha, tol, what, hold, main) -> None:
        """The tree call out of place (launches as ``plan_launches`` groups
        the tree), each leaf within ``tol`` of the plain version, bitwise its
        one-leaf call and, where it was built, bitwise the by-value kernel
        on the same P; then in place bitwise the same.  Raises unless the
        mixing moves the leaves by more than 10x ``tol`` (alpha > 0), so that
        a kernel returning its input fails."""
        torch = self.torch
        from repro_torch.kernels import gossip_mix, gossip_mix_ref, gossip_mix_tree

        groups = self.launch_groups(tree)
        n = gossip_mix.launches
        out = gossip_mix_tree(tree, p, alpha)
        torch.cuda.synchronize()
        if self.old_gossip is not None:
            old = self.old_gossip_tree(tree, p, alpha)
            torch.cuda.synchronize()
            for k in tree:
                if not torch.equal(out[k], old[k]):
                    raise AssertionError(f"gossip_mix tree {what} {k} alpha={alpha}: not "
                                         f"bitwise the by-value kernel on the same P")
            self.old_gossip_cases += 1
        if gossip_mix.launches - n != groups:
            raise AssertionError(f"gossip_mix tree {what}: {gossip_mix.launches - n} launches, "
                                 f"expected {groups}")
        moved = 0.0
        for k, y in tree.items():
            flat = y.reshape(y.shape[0], -1)
            got = out[k].reshape(flat.shape)
            ref = gossip_mix_ref(flat, p, alpha)
            hold("gossip_mix", got, ref, tol, f"{what} {k} alpha={alpha}", main)
            if not torch.equal(got, gossip_mix(flat, p, alpha)):
                raise AssertionError(f"gossip_mix tree {what} {k} alpha={alpha}: not bitwise "
                                     f"the one-leaf call")
            if flat.numel():
                moved = max(moved, (flat.float() - ref.float()).abs().max().item())
        if alpha and not moved > 10 * tol:
            raise AssertionError(f"gossip_mix tree {what} alpha={alpha}: the mixing moves its "
                                 f"input by {moved} at most, too little to tell a kernel that "
                                 f"returns its input at tol {tol}")
        inplace = {k: y.clone() for k, y in tree.items()}
        n = gossip_mix.launches
        res = gossip_mix_tree(inplace, p, alpha, inplace=True)
        torch.cuda.synchronize()
        if gossip_mix.launches - n != groups:
            raise AssertionError(f"gossip_mix tree {what} in place: {gossip_mix.launches - n} "
                                 f"launches, expected {groups}")
        for k in tree:
            if not (res[k] is inplace[k] and torch.equal(res[k], out[k])):
                raise AssertionError(f"gossip_mix tree {what} {k} alpha={alpha}: in place not "
                                     f"bitwise out of place")

    def hold_norm_tree(self, wf, w0, inv, tol, what, hold, main) -> None:
        """The tree call (launches as ``plan_launches`` groups the tree),
        each leaf bitwise its plain version and its one-leaf call; raises
        unless the update moves ``w_final`` by more than 10x ``tol``."""
        torch = self.torch
        from repro_torch.kernels import (
            normalized_update, normalized_update_ref, normalized_update_tree,
        )

        groups = self.launch_groups(wf)
        n = normalized_update.launches
        out = normalized_update_tree(wf, w0, inv)
        torch.cuda.synchronize()
        if normalized_update.launches - n != groups:
            raise AssertionError(f"normalized_update tree {what}: "
                                 f"{normalized_update.launches - n} launches, expected {groups}")
        moved = 0.0
        for k, a in wf.items():
            ref = normalized_update_ref(a, w0[k], inv)
            hold("normalized_update", out[k], ref, tol, f"{what} {k}", main)
            if not (torch.equal(out[k], ref)
                    and torch.equal(out[k], normalized_update(a, w0[k], inv))):
                raise AssertionError(f"normalized_update tree {what} {k}: not bitwise the plain "
                                     f"version and the one-leaf call")
            if a.numel():
                moved = max(moved, (a.float() - ref.float()).abs().max().item())
        if not moved > 10 * tol:
            raise AssertionError(f"normalized_update tree {what}: the update moves w_final by "
                                 f"{moved} at most, too little to tell a kernel that returns "
                                 f"its input at tol {tol}")

    def time_async_kernels(self, mcls) -> dict:
        """Times of the async path's three tree calls at its shapes (f32),
        as the event makes them: the (D, ...) cluster stack mixed in place
        with P_t (alpha 1), the fired cluster's (g, ...) normalized updates,
        and their reduction with m^ to (1, ...); beside each the plain
        version leaf by leaf and the yardstick: per-leaf ``torch.matmul``
        for gossip_mix and cluster_agg, ``torch._foreach_sub`` plus
        ``torch._foreach_mul_`` (two calls; no single PyTorch call computes
        it) for normalized_update."""
        torch = self.torch
        from repro_torch.kernels import (
            cluster_agg, cluster_agg_ref, cluster_agg_tree, gossip_mix, gossip_mix_ref,
            gossip_mix_tree, normalized_update, normalized_update_ref, normalized_update_tree,
        )

        mixings, _, m_hat, inv = self.async_operands()
        p_t = mixings["p_t"]
        p_dev = p_t
        m_row = m_hat[:G].contiguous()
        y = self.stacked_leaves(mcls, torch.float32, 5, rows=D)
        wf = self.stacked_leaves(mcls, torch.float32, 6, rows=G)
        w0 = self.stacked_leaves(mcls, torch.float32, 7, rows=G)
        y_flat = {k: v.view(D, -1) for k, v in y.items()}
        wf_flat = {k: v.view(G, -1) for k, v in wf.items()}
        w0_flat = {k: v.view(G, -1) for k, v in w0.items()}
        agg_out = {k: torch.empty((1, w.shape[1]), device=self.dev) for k, w in wf_flat.items()}
        norm_out = {k: torch.empty_like(w) for k, w in wf.items()}
        wf_list, w0_list = list(wf_flat.values()), [w0_flat[k] for k in wf_flat]
        inv_cols = [inv[:, None]] * len(wf_list)
        m_total = sum(w.shape[1] for w in y_flat.values())

        def foreach_two_calls():
            diffs = torch._foreach_sub(wf_list, w0_list)
            torch._foreach_mul_(diffs, inv_cols)

        calls = {
            "gossip_mix": {  # the tree call in place, as CudaBackend.inter_cluster makes it
                "ms": lambda: gossip_mix_tree(y, p_t, 1, inplace=True),
                "plain_ms": lambda: [gossip_mix_ref(v, p_dev, 1) for v in y_flat.values()],
                "library_ms": lambda: [torch.matmul(p_dev.T, v) for v in y_flat.values()],
            },
            "cluster_agg": {
                "ms": lambda: cluster_agg_tree(wf_flat, m_row, 1),
                "plain_ms": lambda: [cluster_agg_ref(v, m_row, 1) for v in wf_flat.values()],
                "library_ms": lambda: [torch.matmul(m_row[None], v) for v in wf_flat.values()],
            },
            "normalized_update": {
                "ms": lambda: normalized_update_tree(wf, w0, inv, out=norm_out),
                "plain_ms": lambda: [normalized_update_ref(v, w0[k], inv) for k, v in wf.items()],
                "foreach_two_calls_ms": foreach_two_calls,
            },
        }
        bounds = {
            "gossip_mix": self.bound(2 * D * m_total * 4, 2 * D * D * m_total),
            "cluster_agg": self.bound((G + 1) * m_total * 4 + G * 4, 2 * G * m_total),
            "normalized_update": self.bound(3 * G * m_total * 4 + G * 4, 2 * G * m_total),
        }
        # the largest leaf alone: the kernel's own rate, without the other leaves
        big = max(y_flat, key=lambda k: y_flat[k].shape[1])
        m_big = y_flat[big].shape[1]
        big_calls = {
            "gossip_mix": (lambda: gossip_mix(y_flat[big], p_t, 1, out=y_flat[big]),
                           2 * D * m_big * 4),
            "cluster_agg": (lambda: cluster_agg(wf_flat[big], m_row, 1, out=agg_out[big]),
                            (G + 1) * m_big * 4),
            "normalized_update": (lambda: normalized_update(wf_flat[big], w0_flat[big], inv,
                                                            out=norm_out[big].view(G, -1)),
                                  3 * G * m_big * 4),
        }
        out = {}
        if self.old_gossip is not None:
            calls["gossip_mix"]["by_value_ms"] = lambda: self.old_gossip_tree(
                y, p_t, 1, p_host=p_host, inplace=True)
            p_host = p_t.cpu()
        for kname, fns in calls.items():
            t = {k: self.cuda_ms(fn) for k, fn in fns.items()}
            t.update({f"graph_{k}": self.graph_ms(fn) for k, fn in fns.items()})
            t.setdefault("library_ms", None)  # one PyTorch call computing the same, where one is
            t.setdefault("graph_library_ms", None)
            bnd, by = bounds[kname]
            fn, byts = big_calls[kname]
            out[kname] = dict(t, bound_ms=bnd, bound_by=by, leaves=len(y),
                              launches_per_call=self.launch_groups(y),
                              bound_share=bnd / t["ms"], graph_bound_share=bnd / t["graph_ms"],
                              largest_leaf={"leaf": big, "m": m_big, "graph_ms": self.graph_ms(fn),
                                            "bound_ms": byts / HBM_BYTES_PER_S * 1e3})
        if self.old_gossip is not None:
            out["gossip_mix"]["by_value_ab"] = self.gossip_ab(y, p_t)
        return out

    def gossip_ab(self, y: dict, p_t) -> dict:
        """The device-P tree call against the by-value kernel, each in place
        on the same cluster stack and P and replayed from a graph of its own
        (the by-value P baked in at its capture), in turns by-value, device,
        device, by-value: ms a replay."""
        from repro_torch.kernels import gossip_mix_tree

        p_host = p_t.cpu()
        fns = {"by_value": lambda: self.old_gossip_tree(y, p_t, 1, p_host=p_host, inplace=True),
               "device_p": lambda: gossip_mix_tree(y, p_t, 1, inplace=True)}
        turns = [(label, self.graph_ms(fns[label], reps=50))
                 for label in ("by_value", "device_p", "device_p", "by_value")]
        res = {"order": [label for label, _ in turns],
               "by_value_graph_ms": [ms for label, ms in turns if label == "by_value"],
               "device_p_graph_ms": [ms for label, ms in turns if label == "device_p"]}
        res["ratio"] = sum(res["device_p_graph_ms"]) / sum(res["by_value_graph_ms"])
        return res

    def flash_inputs(self, shape, dtype, seed=0):
        """q, k, v and an output gradient at ``shape``, standard normal."""
        torch = self.torch
        b, s, hq, hkv, hd = shape[:5]
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        mk = lambda *sh: torch.randn(sh, generator=gen, device=self.dev).to(dtype)
        return mk(b, s, hq, hd), mk(b, s, hkv, hd), mk(b, s, hkv, hd), mk(b, s, hq, hd)

    def check_flash(self, worst: dict, main_err: dict) -> None:
        """Flash attention forward and backward against their plain versions
        at every shape of ``FLASH_SHAPES``, f32 and bf16; ``main_err`` at
        federated-lm-ring's f32 shape (the lm phase's)."""
        torch = self.torch
        from repro_torch.kernels import (
            flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
            flash_attention_fwd_ref,
        )
        from repro_torch.kernels.flash_attention import route

        worst["flash_attention"] = worst["flash_attention_backward"] = 0.0
        for sname, shape in FLASH_SHAPES.items():
            window, cap = shape[5:]
            for dtype, f_tol, g_tol in ((torch.float32, 2e-5, 1e-4),
                                        (torch.bfloat16, 3e-2, 3e-2)):
                q, k, v, dout = self.flash_inputs(shape, dtype)
                out, lse = flash_attention_fwd(q, k, v, window, cap)
                ref_out, ref_lse = flash_attention_fwd_ref(q, k, v, window, cap)
                torch.cuda.synchronize()
                err = (out.float() - ref_out.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                del ref_out, ref_lse
                if not (err <= f_tol and lse_err <= 1e-4):
                    raise AssertionError(f"flash_attention {sname} {dtype}: max abs err {err} "
                                         f"(tol {f_tol}), lse {lse_err} (tol 1e-4)")
                grads = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
                refs = flash_attention_bwd_ref(q, k, v, out, lse, dout, window, cap)
                torch.cuda.synchronize()
                g_err = 0.0
                for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
                    scale = max(1.0, r.float().abs().max().item())
                    e = (g.float() - r.float()).abs().max().item()
                    if not e <= g_tol * scale:
                        raise AssertionError(f"flash_attention_backward {sname} {dtype} {name}: "
                                             f"max abs err {e} > {g_tol} x {scale}")
                    g_err = max(g_err, e)
                del grads, refs, q, k, v, dout, out, lse
                torch.cuda.empty_cache()
                worst["flash_attention"] = max(worst["flash_attention"], err)
                worst["flash_attention_backward"] = max(worst["flash_attention_backward"], g_err)
                if (sname, dtype) == ("federated-lm-ring", torch.float32):
                    main_err["flash_attention"], main_err["flash_attention_backward"] = err, g_err
                if dtype == torch.bfloat16:
                    main_err[f"flash_attention@{sname}"] = err
                    main_err[f"flash_attention_backward@{sname}"] = g_err
                print(f"  flash {sname} {shape[:5]} window={window} cap={cap} "
                      f"{str(dtype)[6:]} ({route(dtype, shape[4])} forward, "
                      f"{route(dtype, shape[4], backward=True)} backward): forward max abs err "
                      f"{err:.3e} (tol {f_tol}), lse {lse_err:.3e}; backward {g_err:.3e} (tol "
                      f"{g_tol} relative)", flush=True)
        # the f32 forward and backward at granite-8b's heads, the timed
        # split-TF32 shape
        q, k, v, dout = self.flash_inputs(GRANITE_F32, torch.float32)
        out, lse = flash_attention_fwd(q, k, v)
        ref_out, ref_lse = flash_attention_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        err = (out - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref_out, ref_lse
        if not (err <= 2e-5 and lse_err <= 1e-4):
            raise AssertionError(f"flash_attention granite-f32: max abs err {err} (tol 2e-5), "
                                 f"lse {lse_err} (tol 1e-4)")
        g_err = 0.0
        for name, g, r in zip(("dq", "dk", "dv"), flash_attention_bwd(q, k, v, out, lse, dout),
                              flash_attention_bwd_ref(q, k, v, out, lse, dout)):
            e = (g - r).abs().max().item()
            scale = max(1.0, r.abs().max().item())
            if not e <= 1e-4 * scale:
                raise AssertionError(f"flash_attention_backward granite-f32 {name}: max abs err "
                                     f"{e} > 1e-4 x {scale}")
            g_err = max(g_err, e)
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
        worst["flash_attention"] = max(worst["flash_attention"], err)
        worst["flash_attention_backward"] = max(worst["flash_attention_backward"], g_err)
        main_err["flash_attention@granite-f32"] = err
        main_err["flash_attention_backward@granite-f32"] = g_err
        print(f"  flash granite-f32 {GRANITE_F32[:5]} float32 ({route(torch.float32, 128)} "
              f"forward and backward): forward max abs err {err:.3e} (tol 2e-5), lse "
              f"{lse_err:.3e}; backward {g_err:.3e} (tol 1e-4 relative)", flush=True)

    @staticmethod
    def flash_work(shape, itemsize):
        """(forward flops, backward flops, forward bytes, backward bytes) that
        the function needs: 4 hd flops per live (query, key) pair forward,
        2.5x that backward; each input read once, each output written once."""
        b, s, hq, hkv, hd, window = shape[:6]
        w = min(window or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w  # live pairs of one (b, head)
        flops = 4 * b * hq * hd * pairs
        qo, kv, lse = b * s * hq * hd * itemsize, b * s * hkv * hd * itemsize, b * hq * s * 4
        return flops, 2.5 * flops, 2 * qo + 2 * kv + lse, 4 * qo + 4 * kv + lse

    def time_flash(self) -> dict:
        """Forward and backward times at the lm phase's shape (f32), the
        lm-width phase's (granite-8b, bf16), moe-width's (mixtral), pixtral's
        hd 160 and gemma2-width's global layer (hd 256, cap 50), and the f32
        forward and backward at granite-8b's heads (``GRANITE_F32``): the kernel, the
        plain version and ``scaled_dot_product_attention`` (causal, GQA; the
        kernels the profiler saw it launch are named; none under a cap, which
        no library call computes), beside the bound.  Each also replayed from
        a CUDA graph, except the library backward: that is ``autograd.grad`` of
        one retained autograd graph.  The f32 forwards also run against the
        forward they replaced (``flash_ab``), the f32 backwards and the wide
        bf16 ones against the CUDA-core kernels that took them before
        (``flash_bwd_ab``), and those backwards' device time is split by
        kernel."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import (
            flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
            flash_attention_fwd_ref,
        )
        from repro_torch.kernels.flash_attention import route

        out = {}
        for sname, shape, dtype, backward in (
                ("federated-lm-ring", FLASH_SHAPES["federated-lm-ring"], torch.float32, True),
                ("granite-8b", FLASH_SHAPES["granite-8b"], torch.bfloat16, True),
                ("granite-f32", GRANITE_F32, torch.float32, True),
                ("mixtral-8x7b", FLASH_SHAPES["mixtral-8x7b"], torch.bfloat16, True),
                ("pixtral-12b", FLASH_SHAPES["pixtral-12b"], torch.bfloat16, True),
                ("gemma2-2b-global", FLASH_SHAPES["gemma2-2b-global"], torch.bfloat16, True)):
            window, cap = shape[5:]
            # SDPA's causal mask is the shape's where no window bites and no cap
            library = min(window or shape[1], shape[1]) == shape[1] and cap is None
            small = shape[1] <= 256
            q, k, v, dout = self.flash_inputs(shape, dtype, seed=1)
            o, lse = flash_attention_fwd(q, k, v, window, cap)
            qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, dout))  # (B, H, S, hd)
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                          enable_gqa=True)
            calls = {"flash_attention": {
                "ms": lambda: flash_attention_fwd(q, k, v, window, cap),
                "plain_ms": lambda: flash_attention_fwd_ref(q, k, v, window, cap),
                "library_ms": sdpa if library else None,
            }}
            leaves = lib_out = None
            if backward:
                if library:
                    leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
                    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                             enable_gqa=True)
                calls["flash_attention_backward"] = {
                    "ms": lambda: flash_attention_bwd(q, k, v, o, lse, dout, window, cap),
                    "plain_ms": lambda: flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                                                window, cap),
                    "library_ms": (lambda: torch.autograd.grad(lib_out, leaves, gt,
                                                               retain_graph=True))
                    if library else None,
                }
            flops_f, flops_b, bytes_f, bytes_b = self.flash_work(shape, q.element_size())
            peak = {"split_tf32": SPLIT_TF32_FLOPS_PER_S, "tensor_core": BF16_FLOPS_PER_S}
            bounds = {"flash_attention": self.bound(bytes_f, flops_f, peak[route(dtype, shape[4])]),
                      "flash_attention_backward": self.bound(
                          bytes_b, flops_b, peak[route(dtype, shape[4], backward=True)])}
            res = {}
            for kname, fns in calls.items():
                reps = 20 if small else 3
                t = {key: None if fn is None else
                     self.cuda_ms(fn, reps=reps, warmup=1 if not small else 3)
                     for key, fn in fns.items()}
                for key, fn in fns.items():
                    graphable = fn is not None and not (kname.endswith("backward") and
                                                        key == "library_ms")
                    t[f"graph_{key}"] = self.graph_ms(fn, reps=reps) if graphable else None
                bnd, by = bounds[kname]
                flops = flops_f if kname == "flash_attention" else flops_b
                res[kname] = dict(t, bound_ms=bnd, bound_by=by, shape=list(shape[:5]),
                                  window=window, cap=cap, dtype=str(dtype)[6:], flops=flops,
                                  route=route(dtype, shape[4], kname.endswith("backward")),
                                  tflops=flops / t["ms"] / 1e9, bound_share=bnd / t["ms"],
                                  graph_bound_share=bnd / t["graph_ms"])
            res["flash_attention"]["library_kernels"] = self.device_kernels(sdpa) \
                if library else None
            if dtype == torch.float32:
                res["flash_attention"]["ab"] = self.flash_ab(q, k, v, shape, flops_f, reps)
            if backward and (dtype == torch.float32 or shape[4] > 128):
                args = (q, k, v, o, lse, dout, window, cap)
                res["flash_attention_backward"]["ab"] = self.flash_bwd_ab(args, flops_b, reps)
                res["flash_attention_backward"]["kernels_ms"] = self.kernel_ms(
                    calls["flash_attention_backward"]["ms"])
            for kname, r in res.items():
                print(f"  time flash {sname} {str(dtype)[6:]} {kname}: " + ", ".join(
                    f"{key}={val:.6g}" if isinstance(val, float) else f"{key}={val}"
                    for key, val in r.items()), flush=True)
            out[sname] = res
            del q, k, v, dout, o, lse, qt, kt, vt, gt, calls, sdpa, leaves, lib_out
            torch.cuda.empty_cache()
        return out

    def device_kernels(self, fn) -> list:
        """Names of the device kernels one call of ``fn`` launches, as the
        profiler saw them."""
        from repro_torch.kernels import device_kernel_names

        fn()
        self.torch.cuda.synchronize()
        return sorted(set(device_kernel_names(fn)[1]))

    def flash_ab(self, q, k, v, shape, flops, reps) -> dict:
        """The split-TF32 forward against the forward it replaced (built from
        its old source at build time), no window or cap, on the same inputs:
        both held to each other, then graph replays in the order old new new
        old."""
        torch = self.torch
        from repro_torch.kernels import flash_attention_fwd

        if self.old_flash is None:
            return {"skipped": self.detail.get("old_flash", "no source")}
        b, s, hq, hkv, hd = shape[:5]
        o_old = torch.empty_like(q)
        l_old = torch.empty((b, hq, s), dtype=torch.float32, device=self.dev)

        def old():
            rc = self.old_flash(q.data_ptr(), k.data_ptr(), v.data_ptr(), o_old.data_ptr(),
                                l_old.data_ptr(), b, s, hq, hkv, hd, 0, 0.0, hd ** -0.5, 0,
                                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"old flash forward: cudaError_t {rc}")

        new = lambda: flash_attention_fwd(q, k, v)
        old()
        o_new, l_new = new()
        torch.cuda.synchronize()
        diff = (o_new - o_old).abs().max().item()
        ldiff = (l_new - l_old).abs().max().item()
        if not (diff <= 4e-5 and ldiff <= 2e-4):  # each within 2e-5 / 1e-4 of the plain version
            raise AssertionError(f"split-TF32 and old forward differ by {diff} (lse {ldiff})")
        ms = {"old": [], "new": []}
        for key in ("old", "new", "new", "old"):
            ms[key].append(self.graph_ms(old if key == "old" else new, reps=reps))
        return {"graph_ms": ms, "max_abs_diff": diff, "lse_max_abs_diff": ldiff,
                "tflops": {key: flops / (sum(v) / len(v)) / 1e9 for key, v in ms.items()},
                "old_source": self.detail.get("old_flash")}

    def flash_bwd_ab(self, args, flops, reps) -> dict:
        """The backward on its route (split TF32 for f32, the wide
        tensor-core kernels for bf16 past hd 128) against the CUDA-core
        kernels that took it before, built from their source at
        ``OLD_BWD``'s commit, on the same inputs: held to each other within
        2e-4 (f32: each within 1e-4 of the plain version) or 3e-2 (bf16) of
        the old gradients' largest entry, then graph replays in the order old
        new new old.  Both sides are launched directly, uncounted."""
        torch = self.torch
        from repro_torch.kernels.flash_attention import route
        from repro_torch.kernels.flash_attention.ops import _bwd_launch

        if self.old_bwd is None:
            return {"skipped": self.detail.get("old_bwd", "no source")}
        q, k, v, o, lse, dout, window, cap = args
        b, s, hq, hd = q.shape
        olds = tuple(torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((b, hq, s), dtype=torch.float32, device=self.dev)
        code = 0 if q.dtype == torch.float32 else 1

        def old():
            rc = self.old_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              *(t.data_ptr() for t in olds), b, s, s, hq, k.shape[2], hd, s, s,
                              0, window or 0, float(cap or 0.0), hd ** -0.5, code,
                              torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"CUDA-core flash backward: cudaError_t {rc}")

        way = route(q.dtype, hd, backward=True)
        new = lambda: _bwd_launch(way, *args)
        old()
        diff = 0.0
        for a, c in zip(new(), olds):
            diff = max(diff, (a.float() - c.float()).abs().max().item()
                       / max(1.0, c.float().abs().max().item()))
        tol = 2e-4 if q.dtype == torch.float32 else 3e-2
        if not diff <= tol:
            raise AssertionError(f"flash backward: {way} and CUDA-core kernels differ by {diff} "
                                 f"of the largest entry (tol {tol})")
        ms = {"old": [], "new": []}
        for key in ("old", "new", "new", "old"):
            ms[key].append(self.graph_ms(old if key == "old" else new, reps=reps))
        mean = {key: sum(v) / len(v) for key, v in ms.items()}
        return {"graph_ms": ms, "max_rel_diff": diff, "speedup": mean["old"] / mean["new"],
                "tflops": {key: flops / t / 1e9 for key, t in mean.items()}, "route": way,
                "old_source": self.detail.get("old_bwd")}

    def kernel_ms(self, fn, calls=3) -> dict:
        """Device milliseconds a call of ``fn`` by kernel name (the template
        arguments dropped): the mean over the records of ``calls`` warm calls
        in one profiler session, from its raw records, the session idling
        ``kernels.MARGIN_S`` at each end as ``device_kernel_names``'s does.
        A mean over several calls, since sessions lost the record of the
        backward's short first kernel in three of four calls."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import MARGIN_S

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(MARGIN_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(MARGIN_S)
        spans: dict = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                found = re.search(r"\w+_kernel\w*", e.name())
                name = found.group(0) if found else e.name()[:80]
                spans.setdefault(name, []).append((e.end_ns() - e.start_ns()) / 1e6)
        return {name: {"ms": sum(t) / len(t), "records": len(t)} for name, t in spans.items()}

    def time_kernels(self, mcls, factors) -> dict:
        """Times of the two leaf-table kernels over every leaf of ``mcls``
        stacked over C clients (f32), in place as the main path calls them:
        the tree call (one launch), the plain version leaf by leaf, and the
        library yardsticks, per-leaf ``torch.matmul(T^T, W)`` for the
        transition and one ``torch._foreach_add_`` for SGD; then the largest
        leaf alone."""
        torch = self.torch
        from repro_torch.kernels import (
            fused_transition, fused_transition_ref, fused_transition_tree, sgd_update,
            sgd_update_ref, sgd_update_tree,
        )

        vt, p, bt = factors
        alpha = 1  # the main path's inter event
        tree = self.stacked_leaves(mcls, torch.float32)
        grads = {k: torch.randn_like(w) for k, w in tree.items()}
        leaves = {k: w.view(C, -1) for k, w in tree.items()}
        ws, gs = list(tree.values()), [grads[k] for k in tree]
        t_full = (vt.T @ torch.linalg.matrix_power(p, alpha) @ bt.T)  # (C, C) T_k
        t_lib = t_full.T.contiguous()
        nbytes = sum(w.numel() * w.element_size() for w in leaves.values())
        m_total = sum(w.shape[1] for w in leaves.values())
        factor_bytes = 4 * (vt.numel() + p.numel() + bt.numel())

        tr_calls = {
            "ms": lambda: fused_transition_tree(tree, vt, p, bt, alpha, inplace=True),
            "plain_ms": lambda: [fused_transition_ref(w, vt, p, bt, alpha)
                                 for w in leaves.values()],
            "library_ms": lambda: [torch.matmul(t_lib, w) for w in leaves.values()],
        }
        sgd_calls = {
            "ms": lambda: sgd_update_tree(tree, grads, LR, inplace=True),
            "plain_ms": lambda: [sgd_update_ref(w, grads[k], LR) for k, w in tree.items()],
            "library_ms": lambda: torch._foreach_add_(ws, gs, alpha=-LR),
        }
        tr_bound, tr_by = self.bound(2 * nbytes + factor_bytes,
                                     2 * m_total * (2 * C * D + alpha * D * D))
        sgd_bound, sgd_by = self.bound(3 * nbytes, 2 * m_total * C)
        out = {}
        for kname, calls, bnd, by, moved in (
            ("fused_transition", tr_calls, tr_bound, tr_by, 2 * nbytes),
            ("sgd_update", sgd_calls, sgd_bound, sgd_by, 3 * nbytes),
        ):
            t = {k: self.cuda_ms(fn) for k, fn in calls.items()}
            t.update({f"graph_{k}": self.graph_ms(fn) for k, fn in calls.items()})
            out[kname] = dict(t, bound_ms=bnd, bound_by=by, leaves=len(leaves),
                              launches_per_call=self.launch_groups(tree), bytes_moved=moved,
                              bound_share=bnd / t["ms"], graph_bound_share=bnd / t["graph_ms"])
        # the largest leaf alone: the kernel's own rate at its largest shape
        big = max(leaves, key=lambda k: leaves[k].numel())
        w = leaves[big]
        out["fused_transition"]["largest_leaf"] = {
            "leaf": big, "shape": list(w.shape),
            "graph_ms": self.graph_ms(lambda: fused_transition(w, vt, p, bt, alpha, out=w)),
            "bound_ms": 2 * w.numel() * w.element_size() / HBM_BYTES_PER_S * 1e3,
        }
        out["sgd_update"]["largest_leaf"] = {
            "leaf": big, "shape": list(w.shape),
            "graph_ms": self.graph_ms(lambda: sgd_update(tree[big], grads[big], LR,
                                                         out=tree[big])),
            "bound_ms": 3 * w.numel() * w.element_size() / HBM_BYTES_PER_S * 1e3,
        }
        return out

    def run_scenario(self, name, iters, device=None, **overrides):
        """(runtime, host seconds for ``iters`` steps ending in a synchronize, eval)."""
        torch = self.torch
        from repro_torch.scenarios import build_scenario

        run = build_scenario(name, device=device, **overrides)
        src = run.batch_source()
        t0 = time.perf_counter()
        for _ in range(iters):
            run.runtime.step(src)
        if run.runtime.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return run, dt, run.runtime.evaluate(run.eval_batch)

    def warm_rate(self, run, iters) -> float:
        """Iterations/s over ``iters`` more steps, ending in a synchronize."""
        src = run.batch_source()
        t0 = time.perf_counter()
        for _ in range(iters):
            run.runtime.step(src)
        self.torch.cuda.synchronize()
        return iters / (time.perf_counter() - t0)

    def profile_steps(self, run, iters) -> dict:
        """Device busy time over ``iters`` warm steps (torch.profiler, CUPTI):
        the device's share of the host wall time and the top kernels."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        src = run.batch_source()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                run.runtime.step(src)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only, each counted once (an aten op's aggregate
        # row repeats its kernels' time); busy time is the union of intervals
        spans = {(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        busy_us, end = 0.0, float("-inf")
        for _, a, b in sorted(spans, key=lambda s: s[1]):
            if b > end:
                busy_us += b - max(a, end)
                end = b
        busy_ms = busy_us / 1e3
        per_name: dict = {}
        for name, a, b in spans:
            per_name[name] = per_name.get(name, 0.0) + (b - a) / 1e3
        top = sorted(per_name.items(), key=lambda r: -r[1])[:6]
        flash_split: dict = {}  # by kernel function, template arguments dropped
        for name, ms in per_name.items():
            found = re.search(r"(flash_\w+)", name)
            if found:
                flash_split[found.group(1)] = flash_split.get(found.group(1), 0.0) + ms
        flash_ms = sum(flash_split.values())
        leaf_table = {k: sum(ms for name, ms in per_name.items() if k in name)
                      for names in LEAF_TABLE_KERNELS.values() for k in names}
        # device launches a step: every kernel, and PyTorch's copy kernels
        # (``.contiguous()`` of a strided tensor) among them
        kernels = [name for name, _, _ in spans if not name.startswith(("Memcpy", "Memset"))]
        copies = sum("copy" in name for name in kernels)
        counts: dict = {}  # runs by full kernel name (templates tell functors apart)
        for name in kernels:
            counts[name] = counts.get(name, 0) + 1
        return {"iters": iters, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "busy_ms_per_step": busy_ms / iters, "busy_share": busy_ms / wall_ms,
                "kernel_launches_per_step": len(kernels) / iters,
                "copy_launches_per_step": copies / iters,
                "flash_kernels_ms": flash_ms, "flash_share_of_busy": flash_ms / busy_ms,
                "flash_split_ms": {k: round(ms, 4) for k, ms in flash_split.items()},
                "leaf_table_ms": {k: round(ms, 4) for k, ms in leaf_table.items()},
                "top_kernels_ms": [(k[:60], round(ms, 4)) for k, ms in top],
                "kernel_counts": counts}

    def iteration_split(self, run) -> dict:
        """CUDA-event times of the three stages of one iteration, each
        called as the scheduler calls it on its own stacked parameters."""
        torch = self.torch
        from repro_torch.core.pipeline import device_batch
        from repro_torch.kernels import sgd_update_tree

        sched = run.runtime.scheduler
        params = sched.params
        batch = device_batch(run.batch_source()(0), run.runtime.device)
        vgrad = torch.func.vmap(torch.func.grad_and_value(run.runtime.model.loss))

        def grad_fn():
            # as local_update does: vmapped grads, made contiguous for the kernel
            grads, _ = vgrad(params, batch)
            return {k: g.contiguous() for k, g in grads.items()}

        grads = grad_fn()
        return {
            "local_grad_ms": self.cuda_ms(grad_fn, reps=5, warmup=2),
            "sgd_update_ms": self.cuda_ms(
                lambda: sgd_update_tree(params, grads, 0.0, inplace=True), reps=10),
            "transition_inter_ms": self.cuda_ms(
                lambda: sched.backend.transition(params, "inter"), reps=10),
        }

    def check_finite(self, params, what):
        for k, w in params.items():
            if not bool(self.torch.isfinite(w).all()):
                raise AssertionError(f"{what}: non-finite values in {k}")

    def main_path(self):
        from repro_torch.kernels import device_launches, fused_transition, sgd_update

        fused_transition.launches = 0
        sgd_update.launches = 0
        (run, dt, (loss, acc)), ran = device_launches(
            lambda: self.run_scenario("mnist-noniid-ring", SYNC_ITERS, tau2=2))
        host = {"fused_transition": fused_transition.launches,
                "sgd_update": sgd_update.launches}
        sched = run.runtime.scheduler
        events = [sched.cfg.event_at(k) for k in range(1, SYNC_ITERS + 1)]
        if sched.backend.name != "cuda" or run.runtime.device.type != "cuda":
            raise AssertionError(f"auto resolved to {sched.backend.name} on {run.runtime.device}")
        replays = self.check_replays(sched, events, "main path")
        expected = self.sync_launches(sched, SYNC_ITERS)
        if ran != expected:
            raise AssertionError(f"main path kernel runs {ran}, expected {expected}")
        host_expected = self.sync_launches(sched, SYNC_ITERS, host=True)
        if host != host_expected:
            raise AssertionError(f"main path host launches {host}, expected {host_expected}")
        self.check_finite(sched.params, "mnist cuda run")
        print(f"main path mnist-noniid-ring tau2=2 on {run.runtime.device}, backend "
              f"{sched.backend.name}, CUDA graphs (the default): events {events}; graph "
              f"replays by event kind {json.dumps(replays)}; kernel runs on the device "
              f"{json.dumps(ran)} (the profiler's records, expected exactly: one per stage, "
              f"replays included); host launches {json.dumps(host)} (the wrappers' counters, "
              f"expected exactly: each event kind's warm-up and capture, none at a replay); "
              f"{SYNC_ITERS / dt:.3f} it/s cold under the profiler ({SYNC_ITERS} iterations, "
              f"{dt:.4f}s, warm-up and capture included); eval loss {loss:.6f} acc {acc:.4f}",
              flush=True)
        for kname, n in ran.items():
            self.record[kname]["launches"] = n
            self.record[kname]["host_launches"] = host[kname]

        ref = {}
        for label, device in (("dense on cuda (graph)", None), ("dense on cpu (eager)", "cpu")):
            r, _, (rloss, _) = self.run_scenario("mnist-noniid-ring", SYNC_ITERS, device=device,
                                                 tau2=2, backend="dense")
            err = max((w.float().cpu() - r.runtime.scheduler.params[k].float().cpu())
                      .abs().max().item() for k, w in sched.params.items())
            rel = abs(rloss - loss) / abs(rloss)
            ref[label] = {"max_abs_param_diff": err, "eval_loss": rloss, "loss_rel_diff": rel}
            print(f"  vs {label}: max abs param diff {err:.3e} (tol 1e-4), eval loss "
                  f"{rloss:.6f} rel diff {rel:.3e} (tol 1e-4)", flush=True)
            if not (err <= 1e-4 and rel <= 1e-4):
                raise AssertionError(f"kernel-backend run disagrees with {label}")

        split = self.iteration_split(run)
        host = self.host_split(run.batch_source(), 100)
        print("main path split of one iteration (eager calls): "
              + ", ".join(f"{k}={v:.4f}" for k, v in split.items())
              + "; host ms a step left beside a replay: "
              + ", ".join(f"{k}={v:.4f}" for k, v in host.items()), flush=True)
        del run, sched  # the A/B's memory peaks start without this run's graphs
        ab = self.graph_ab(
            "main", lambda graph: self.sync_values("mnist-noniid-ring", graph, tau2=2),
            lambda sched, host: self.sync_launches(sched, SYNC_ITERS, host), SYNC_ITERS,
            warm=100, profile=20)
        self.detail["main_path"] = {"launches": ran, "host_launches": host, "events": events,
                                    "graph_replays": replays,
                                    "it_per_s_cold": SYNC_ITERS / dt, "split": split,
                                    "host_split": host, "eval_loss": loss, "eval_acc": acc,
                                    "references": ref, "eager_vs_graph": ab}

    def host_split(self, producer, n) -> dict:
        """Host milliseconds per step of what a replayed step still does on
        the host: drawing its batch with numpy (``producer(k)``), and
        staging it (pinning, and queueing its copy on the copy stream), as
        ``BatchFeed`` does, after a few steps of warm-up."""
        torch = self.torch
        from repro_torch.core.pipeline import CopyStream

        copy = CopyStream(self.dev)
        for k in range(1, 6):
            copy.take(copy.stage(producer(k)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = [producer(k) for k in range(6, n + 6)]
        draw = (time.perf_counter() - t0) / n * 1e3
        t0 = time.perf_counter()
        for b in batches:
            copy.take(copy.stage(b))
        stage = (time.perf_counter() - t0) / n * 1e3
        torch.cuda.synchronize()
        return {"draw_ms": draw, "stage_ms": stage}

    def check_replays(self, sched, events, what) -> dict:
        """Graph replays of each sync event kind, which must be at least 2
        for every kind the run fired 3 times or more (warm-up, capture and
        replay, replay)."""
        if sched._graphs is None:
            raise AssertionError(f"{what}: the run is not on CUDA graphs")
        replays = {e: g.replays for e, g in sched._graphs.items()}
        short = {e: n for e, n in replays.items() if events.count(e) >= 3 and n < 2}
        if short:
            raise AssertionError(f"{what}: event kinds replayed fewer than twice: {short}")
        return replays

    def sync_values(self, name, graph, **overrides):
        """(run, host seconds, {"params", "losses"}) of ``SYNC_ITERS`` sync
        iterations; the losses of a sync run are its eval loss."""
        run, dt, (loss, _) = self.run_scenario(name, SYNC_ITERS, graph=graph, **overrides)
        params = {k: w.detach().float().cpu() for k, w in run.runtime.scheduler.params.items()}
        return run, dt, {"params": params, "losses": self.torch.tensor([loss])}

    def graph_ab(self, what, drive, expected, window, warm, profile, per_step=1,
                 timed=("before", "after")) -> dict:
        """Eager (``graph=False``) against CUDA graphs in this process.
        ``drive(graph)`` builds a run and steps it over the compared window
        of ``window`` iterations: (run, host seconds, {"params": ...,
        "losses": ...} on the host).  Every run's kernel runs over the window,
        counted on the device by the profiler, must equal ``expected(sched,
        False)``, flash routes included, and its host launches
        ``expected(sched, True)``.

        Three passes, each in turns eager, graph, graph, eager: a timed
        pass, the held pass, and the timed pass again.  The held pass runs
        under cuDNN's deterministic algorithms, where eager repeats itself:
        the graph runs' parameters and losses are held to that
        eager-vs-eager difference.  (cuDNN's default weight-gradient
        algorithms are not reproducible run to run, and the training
        compounds their last-bit differences, so under them two eager runs
        differ and no pair of runs can be held to another pair's
        difference.)  The timed passes run as users do, with cuDNN's
        defaults: each run's warm rate over ``warm`` more steps (times
        ``per_step`` iterations), its profile over ``profile`` steps, its
        peak device memory, and the differences between the runs, reported;
        one before and one after the held pass, so a rate that moves between
        them shows what the earlier runs of the process leave behind.
        ``timed`` names the timed passes to run ("before", "after" or
        neither)."""
        torch = self.torch
        order = ("eager", "graph", "graph", "eager")
        timed_before = (self.ab_timed(what, "before", drive, expected, window, warm, profile,
                                      per_step) if "before" in timed else None)
        held = {"eager": [], "graph": []}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for label in order:
                run, vals, _, _ = self.ab_turn(what, label, drive, expected)
                held[label].append(vals)
                del run
        finally:
            torch.backends.cudnn.deterministic = deterministic
        held_diff = self.ab_diffs(held)
        ee, ge = held_diff["eager_vs_eager"], held_diff["graph_vs_eager"]
        print(f"  {what}, cuDNN deterministic: eager vs eager max abs diff params "
              f"{ee['params']:.3e}, losses {ee['losses']:.3e}; graph vs eager (every pair) "
              f"{ge['params']:.3e}, {ge['losses']:.3e} (held to the eager-vs-eager "
              f"difference)", flush=True)
        if not all(ge[k] <= ee[k] for k in ee):
            raise AssertionError(f"{what}: graph runs differ from the eager ones by {ge}, "
                                 f"more than eager from eager, {ee}")
        if "after" not in timed:
            return {"order": list(order), "held_cudnn_deterministic": held_diff}
        timed_after = self.ab_timed(what, "after", drive, expected, window, warm, profile,
                                    per_step)
        return {"order": list(order), **timed_after, "before_held_pass": timed_before,
                "held_cudnn_deterministic": held_diff}

    def ab_timed(self, what, when, drive, expected, window, warm, profile, per_step) -> dict:
        """A timed pass of ``graph_ab``, ``when`` ("before" or "after") the
        held pass."""
        torch = self.torch
        sides = {"eager": [], "graph": []}
        timed = {"eager": [], "graph": []}
        for label in ("eager", "graph", "graph", "eager"):
            run, vals, ran, (start, reserved) = self.ab_turn(what, label, drive, expected)
            rate = self.warm_rate(run, warm) * per_step
            busy = self.profile_steps(run, profile)
            peak = torch.cuda.max_memory_allocated()
            peak_reserved = torch.cuda.max_memory_reserved() - reserved
            pools = self.graph_pools()
            side = {"it_per_s_warm": rate,
                    "busy_share": busy["busy_share"],
                    "busy_ms_per_step": busy["busy_ms_per_step"],
                    "kernel_launches_per_step": busy["kernel_launches_per_step"],
                    "peak_bytes": peak, "peak_above_start_bytes": peak - start,
                    "peak_reserved_above_start_bytes": peak_reserved,
                    "graph_pools_bytes": pools, "launches": ran, "profile": busy}
            sched = run.runtime.scheduler
            graphed = getattr(sched, "_graphs", getattr(sched, "_graph", None))
            if graphed is not None:
                side["replays"] = ({e: g.replays for e, g in graphed.items()}
                                   if isinstance(graphed, dict) else graphed.replays)
            sides[label].append(side)
            timed[label].append(vals)
            print(f"  {what} {label} ({when} the held pass): {rate:.3f} it/s warm over {warm} "
                  f"steps; busy {100 * busy['busy_share']:.1f}%, "
                  f"{busy['busy_ms_per_step']:.4f} ms and "
                  f"{busy['kernel_launches_per_step']:.1f} kernel launches per step "
                  f"({profile} steps profiled); peak device memory {peak / 2**20:.1f} MiB "
                  f"({(peak - start) / 2**20:.1f} above the turn's start), reserved "
                  f"{peak_reserved / 2**20:.1f} MiB above it; graph pools (MiB) "
                  f"{[round(b / 2**20, 1) for b in pools]}; kernel runs over "
                  f"the window {json.dumps(ran)} (expected exactly)", flush=True)
            del run, sched, graphed
        timed_diff = self.ab_diffs(timed)
        print(f"  {what}, cuDNN defaults ({when} the held pass; reported, not held): "
              + "; ".join(f"{k.replace('_', ' ')} params {d['params']:.3e}, losses "
                          f"{d['losses']:.3e}" for k, d in timed_diff.items()), flush=True)
        mean = lambda side, k: sum(r[k] for r in sides[side]) / len(sides[side])
        speedup = mean("graph", "it_per_s_warm") / mean("eager", "it_per_s_warm")
        print(f"  {what} graph/eager warm rate {speedup:.3f}x ({when} the held pass; means of "
              f"two runs each)", flush=True)
        return {"eager": sides["eager"], "graph": sides["graph"], "cudnn_default": timed_diff,
                "warm_rate_ratio": speedup}

    def ab_turn(self, what, label, drive, expected):
        """One run of an A/B, from a released device: (run, values, kernel
        runs over the window on the device, held to ``expected(sched,
        False)``, and the bytes allocated and reserved when it started); its
        host launches are held to ``expected(sched, True)``."""
        import gc

        torch = self.torch
        from repro_torch.kernels import check_eager_session, device_launches

        graph = label == "graph"
        gc.collect()  # a scheduler and its graphs hold each other
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        before = self.host_counts()
        (run, _, vals), ran = device_launches(lambda: drive(graph))
        host = {k: n - before[k] for k, n in self.host_counts().items() if n != before[k]}
        sched = run.runtime.scheduler
        graphed = getattr(sched, "_graphs", getattr(sched, "_graph", None))
        if (graphed is not None) != graph:
            raise AssertionError(f"{what} {label}: graph {graphed is not None}")
        if not graph:
            check_eager_session(ran, host)
        want, host_want = expected(sched, False), expected(sched, True)
        if ran != want:
            raise AssertionError(f"{what} {label}: kernel runs {ran}, expected {want}")
        if host != host_want:
            raise AssertionError(f"{what} {label}: host launches {host}, expected {host_want}")
        return run, vals, ran, start

    def graph_pools(self) -> list:
        """Bytes the caching allocator holds in each CUDA-graph private pool
        (its segments by pool id, ``torch.cuda.memory_snapshot``)."""
        pools: dict = {}
        for seg in self.torch.cuda.memory_snapshot():
            pool = tuple(seg.get("segment_pool_id", (0, 0)))
            if pool != (0, 0):
                pools[pool] = pools.get(pool, 0) + seg["total_size"]
        return sorted(pools.values(), reverse=True)

    @staticmethod
    def ab_diffs(values) -> dict:
        """Max abs differences of parameters and losses: the two eager runs,
        the two graph runs, and every graph run against every eager run."""
        def diff(a, b):
            return {"params": max((a["params"][k] - v).abs().max().item()
                                  for k, v in b["params"].items()),
                    "losses": (a["losses"] - b["losses"]).abs().max().item()}

        e, g = values["eager"], values["graph"]
        pairs = [diff(gi, ej) for gi in g for ej in e]
        return {"eager_vs_eager": diff(e[0], e[1]), "graph_vs_graph": diff(g[0], g[1]),
                "graph_vs_eager": {k: max(p[k] for p in pairs) for k in pairs[0]}}

    def sync_launches(self, sched, iters, host=False) -> dict:
        """Exact kernel runs of ``iters`` sync iterations: one SGD launch per
        iteration and one per transition, each times the tree's launch
        groups.  ``host``: the launches the wrappers count on the host, which
        on CUDA graphs are those of each event kind's first two iterations
        (warm-up, capture); a replay launches nothing from the host."""
        groups = self.launch_groups(sched.params)
        events = [sched.cfg.event_at(k) for k in range(1, iters + 1)]
        if host and sched._graphs is not None:
            events = [e for i, e in enumerate(events) if events[:i].count(e) < 2]
        transitions = sum(e != "local" for e in events)
        return {"fused_transition": transitions * groups, "sgd_update": len(events) * groups}

    @staticmethod
    def host_counts() -> dict:
        """Every wrapper's host counter, the flash ones by route too, keyed as
        ``kernels.count_kernels`` keys its device counts."""
        from repro_torch import kernels

        out = {}
        for name in ("fused_transition", "sgd_update", "normalized_update", "cluster_agg",
                     "gossip_mix", "flash_attention_fwd", "flash_attention_bwd"):
            fn = getattr(kernels, name)
            out[name] = fn.launches
            out.update({f"{name}.{r}": n for r, n in getattr(fn, "routes", {}).items()})
        return out

    @staticmethod
    def by_wrapper(n: dict, fwd: str, bwd: str) -> dict:
        """Launch counts keyed by this script's kernel names, keyed as
        ``kernels.count_kernels`` keys them, the flash ones on routes ``fwd``
        and ``bwd``; zeros left out."""
        out = {}
        for k, v in n.items():
            if k == "flash_attention":
                out["flash_attention_fwd"] = out[f"flash_attention_fwd.{fwd}"] = v
            elif k == "flash_attention_backward":
                out["flash_attention_bwd"] = out[f"flash_attention_bwd.{bwd}"] = v
            else:
                out[k] = v
        return {k: v for k, v in out.items() if v}

    def cifar(self):
        """cifar-dirichlet-torus, eager against graph: its leaves are where
        bytes matter and its device is busy most of the time already."""
        name = "cifar-dirichlet-torus"
        # one timed pass, after the held one (the one before it: PRs 18-30)
        ab = self.graph_ab("cifar", lambda graph: self.sync_values(name, graph),
                           lambda sched, host: self.sync_launches(sched, SYNC_ITERS, host),
                           SYNC_ITERS, warm=20, profile=5, timed=("after",))
        run, _, (loss, acc) = self.run_scenario(name, 1)
        sched = run.runtime.scheduler
        if sched.backend.name != "cuda":
            raise AssertionError(f"cifar path: backend {sched.backend.name}")
        self.check_finite(sched.params, "cifar run")
        split = self.iteration_split(run)
        n_params = sum(w[0].numel() for w in sched.params.values())
        print(f"cifar-dirichlet-torus on cuda: {n_params} params x {C} clients, "
              f"{len(sched.params)} leaves; split of one iteration (eager calls) "
              + ", ".join(f"{k}={v:.4f}" for k, v in split.items()), flush=True)
        self.detail["cifar"] = {"split": split, "params": n_params, "eager_vs_graph": ab}

    def run_async(self, name, events, device=None, **overrides):
        """(run, host seconds for ``events`` steps ending in a synchronize,
        [(kind, cluster, iteration)], eval)."""
        torch = self.torch
        from repro_torch.scenarios import build_scenario

        run = build_scenario(name, device=device, **overrides)
        src = run.batch_source()
        t0 = time.perf_counter()
        seq = []
        for _ in range(events):
            ev = run.runtime.step(src)
            seq.append((ev.kind, ev.cluster, ev.iteration))
        if run.runtime.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return run, dt, seq, run.runtime.evaluate(run.eval_batch)

    def event_split(self, run) -> dict:
        """CUDA-event times of one cluster event, on the next event's cluster
        and batches: the whole body eager (``_event``) and replayed from a
        graph, and each of its three kernels' tree calls at the event's
        shapes; ``y`` is put back afterwards."""
        import numpy as np
        from repro_torch.core import staleness_mixing_matrix
        from repro_torch.kernels import cluster_agg_tree, normalized_update_tree

        torch = self.torch
        sched = run.runtime.scheduler
        d = sched._queue[0][1]
        g = len(sched._members[d])
        gaps = (sched.t - sched.last_update).astype(np.float64)
        gaps[d] = 0.0
        p_t = staleness_mixing_matrix(sched.cfg.topology, d, gaps, sched.cfg.psi)
        batch = {**sched._gather(run.batch_source(), d), **sched._operands(d, None, p_t)}
        saved = {k: v.clone() for k, v in sched.y.items()}
        gen = torch.Generator(device=self.dev).manual_seed(11)
        wf = {k: torch.randn((g,) + tuple(v.shape[1:]), generator=gen, device=self.dev)
              for k, v in sched.y.items()}
        w0 = {k: torch.randn_like(v) for k, v in wf.items()}
        from repro_torch.core.runtime import INV_THETA, M_HAT, MIXING

        deltas = normalized_update_tree(wf, w0, batch[INV_THETA])
        y = {k: v.clone() for k, v in sched.y.items()}
        split = {
            "event_ms": self.cuda_ms(lambda: sched._event(batch), reps=5, warmup=2),
            "event_graph_ms": self.graph_ms(lambda: sched._event(batch), reps=10),
            "normalized_update_ms": self.cuda_ms(
                lambda: normalized_update_tree(wf, w0, batch[INV_THETA]), reps=10),
            "cluster_agg_ms": self.cuda_ms(lambda: cluster_agg_tree(deltas, batch[M_HAT], 1),
                                           reps=10),
            "gossip_mix_ms": self.cuda_ms(lambda: sched.backend.inter_cluster(y, batch[MIXING], 1),
                                          reps=10),
        }
        for k, v in sched.y.items():
            v.copy_(saved[k])
        torch.cuda.synchronize()
        return split

    def async_launches(self, sched, events, host=False) -> dict:
        """Exact kernel runs of a run's cluster events: one launch of each
        async kernel an event (times the tree's launch groups), none at a
        skipped or outage one; ``host`` on a graph: those of its warm-up and
        capture, one cluster size's first two events (every registered
        async scenario has one cluster size)."""
        fired = [k for k, _, _ in events].count("cluster")
        if host and sched._graph is not None:
            fired = min(fired, 2 * len(sched._graph._entries))
        return {k: fired * self.launch_groups(sched.y) for k in ASYNC_KERNELS if fired}

    def async_values(self, name, graph, seqs, **overrides):
        """(run, host seconds, {"params": y, "losses": eval loss}) of
        ``ASYNC_EVENTS`` events; the event sequence goes to ``seqs``."""
        run, dt, events, (loss, _) = self.run_async(name, ASYNC_EVENTS, graph=graph,
                                                    **overrides)
        seqs.append(events)
        params = {k: w.detach().float().cpu() for k, w in run.runtime.scheduler.y.items()}
        return run, dt, {"params": params, "losses": self.torch.tensor([loss])}

    def async_path(self):
        """Asynchronous SD-FEEL: straggler-bimodal-async on its CUDA graph
        (the default on the card), the launch counters set to 0 just before
        and read just after; then eager against graph in this process, and
        the same hold for dropout-participation-async and a host-offload
        store."""
        torch = self.torch
        from repro_torch.kernels import cluster_agg, device_launches, gossip_mix, normalized_update

        name = "straggler-bimodal-async"
        counters = {"normalized_update": normalized_update, "cluster_agg": cluster_agg,
                    "gossip_mix": gossip_mix}
        for fn in counters.values():
            fn.launches = 0
        (run, dt, events, (loss, acc)), ran = device_launches(
            lambda: self.run_async(name, ASYNC_EVENTS))
        launches = {k: fn.launches for k, fn in counters.items()}
        sched = run.runtime.scheduler
        if sched.backend.name != "cuda" or run.runtime.device.type != "cuda":
            raise AssertionError(f"auto resolved to {sched.backend.name} on {run.runtime.device}")
        if sched._graph is None or sched._graph.captured != 1:
            raise AssertionError(f"async path: not on one captured graph ({sched._graph})")
        leaves = len(sched.y)
        expected = self.async_launches(sched, events)
        host_expected = self.async_launches(sched, events, host=True)
        if ran != expected or launches != host_expected:
            raise AssertionError(f"async kernel runs {ran} (expected {expected}), host launches "
                                 f"{launches} (expected {host_expected})")
        self.check_finite(sched.y, "async cuda run")
        self.check_finite(run.runtime.global_params(), "async cuda run (consensus)")
        print(f"async {name} on {run.runtime.device}, backend {sched.backend.name}, CUDA graph "
              f"(the default: one graph for its one cluster size, {sched._graph.replays} "
              f"replays): {ASYNC_EVENTS} events over clusters {[c for _, c, _ in events]}; "
              f"kernel runs on the device {json.dumps(ran)} (one each per cluster event, "
              f"replays included; {leaves} leaves); host launches {json.dumps(launches)} (the "
              f"graph's warm-up and capture); {ASYNC_EVENTS / dt:.3f} events/s cold under the "
              f"profiler ({dt:.4f}s, warm-up and capture included); eval loss {loss:.6f} acc "
              f"{acc:.4f}; clock {sched.clock:.6f}", flush=True)
        for kname, n in ran.items():
            self.record[kname]["launches"] = n
            self.record[kname]["host_launches"] = launches[kname]

        ref = {}
        for label, device in (("dense on cuda (graph)", None), ("dense on cpu (eager)", "cpu")):
            r, _, revents, (rloss, _) = self.run_async(name, ASYNC_EVENTS, device=device,
                                                       backend="dense")
            err = max((v.float().cpu() - r.runtime.scheduler.y[k].float().cpu())
                      .abs().max().item() for k, v in sched.y.items())
            rel = abs(rloss - loss) / abs(rloss)
            same = revents == events
            ref[label] = {"max_abs_y_diff": err, "eval_loss": rloss, "loss_rel_diff": rel,
                          "same_events": same}
            print(f"  vs {label}: same event sequence {same}; max abs y diff {err:.3e} "
                  f"(tol 1e-4), eval loss {rloss:.6f} rel diff {rel:.3e} (tol 1e-4)", flush=True)
            if not (same and err <= 1e-4 and rel <= 1e-4):
                raise AssertionError(f"async kernel-backend run disagrees with {label}")
        split = self.event_split(run)
        print("async split of one event: " + ", ".join(f"{k}={v:.4f}" for k, v in split.items()),
              flush=True)
        del run, sched

        lanes = {}
        for lane, overrides in ((name, {}), ("dropout-participation-async", {}),
                                (f"{name}+host-offload", {"store": "host-offload"})):
            seqs = []
            scen = lane.split("+")[0]
            full = lane == name
            ab = self.graph_ab(
                f"async {lane}", lambda graph: self.async_values(scen, graph, seqs, **overrides),
                lambda sched, host: self.async_launches(sched, seqs[-1], host), ASYNC_EVENTS,
                warm=ASYNC_WARM, profile=ASYNC_PROFILED, timed=("after",) if full else ())
            if any(s != seqs[0] for s in seqs):
                raise AssertionError(f"async {lane}: the event sequences differ between turns")
            held = ab["held_cudnn_deterministic"]["graph_vs_eager"]
            if held["params"] != 0.0 or held["losses"] != 0.0:
                raise AssertionError(f"async {lane}: graph differs from eager by {held}")
            lanes[lane] = ab
        for side in ("eager", "graph"):
            rows = lanes[name][side]
            print(f"async {name} {side} (one process, turns eager, graph, graph, eager; the "
                  f"pass after the held one): warm events/s "
                  f"{[round(r['it_per_s_warm'], 3) for r in rows]}, busy share "
                  f"{[round(r['busy_share'], 4) for r in rows]}, busy ms per event "
                  f"{[round(r['busy_ms_per_step'], 4) for r in rows]}, kernel launches per "
                  f"event {[round(r['kernel_launches_per_step'], 2) for r in rows]}",
                  flush=True)
        self.detail["async"] = {"launches": ran, "host_launches": launches,
                                "expected": expected, "events": events,
                                "events_per_s_cold": ASYNC_EVENTS / dt, "split": split,
                                "eval_loss": loss, "eval_acc": acc, "references": ref,
                                "eager_vs_graph": lanes}

    # -- fleet: participation, faults, the profile, the §V baselines ------------
    def fleet(self):
        """The fleet axes' path, driven with every kernel counter set to 0
        just before it and read just after: sampled-k-ring (sync, uniform-k,
        one CUDA graph per event kind) and chaos-ring (round supersteps under
        the fault trace, one graph), held graph against eager to 0.0 under
        deterministic cuDNN and against dense; dropout-participation-async
        (on its graph) against dense; FedAvg, HierFAVG and FEEL on the SGD
        kernel against their plain path.  Each fleet kernel must have run."""
        from repro_torch import kernels

        names = ("fused_transition", "sgd_update", "normalized_update", "cluster_agg",
                 "gossip_mix")
        for k in names:
            getattr(kernels, k).launches = 0
        sync = self.fleet_lane("sampled-k-ring", SYNC_ITERS, self.sync_launches, tau2=2)
        rnd = self.fleet_lane("chaos-ring", FLEET_SUPERSTEPS, self.round_launches)
        events = self.fleet_async()
        base = self.fleet_baselines()
        host = {k: getattr(kernels, k).launches for k in names}
        if not all(host.values()):
            raise AssertionError(f"fleet path: a kernel never launched: {host}")
        print(f"fleet path host launches (counters zeroed before it, read after): "
              f"{json.dumps(host)}", flush=True)
        for k, n in host.items():
            self.record[k]["fleet_host_launches"] = n
        self.detail["fleet"] = {"sampled-k-ring": sync, "chaos-ring": rnd,
                                "dropout-participation-async": events, "baselines": base,
                                "host_launches": host,
                                "sampled_vs_main_kernels": self.kernels_vs_main(sync)}

    def kernels_vs_main(self, lane) -> dict:
        """The kernels whose runs an iteration differ between a sync fleet
        lane's eager profile and the main path's (``mnist-noniid-ring``, the
        same C, D and schedule on static weights): name -> [lane, main]."""
        try:
            main = self.detail["main_path"]["eager_vs_graph"]["eager"][0]["profile"]
        except (KeyError, IndexError):
            return {}
        ours = lane["per_iteration_profile"]["eager"]["kernel_counts_per_iteration"]
        theirs = {n: c / main["iters"] for n, c in main["kernel_counts"].items()}
        out = {n: [ours.get(n, 0.0), theirs.get(n, 0.0)] for n in sorted({*ours, *theirs})
               if abs(ours.get(n, 0.0) - theirs.get(n, 0.0)) > 1e-9}
        print(f"fleet sampled-k-ring vs main, kernel runs an iteration that differ "
              f"(eager, profiled): {json.dumps(out)}", flush=True)
        return out

    def round_launches(self, sched, steps, host=False) -> dict:
        """Exact kernel runs of ``steps`` round supersteps: one SGD launch an
        iteration, one transition per intra and inter event, each times the
        tree's launch groups; ``host`` on a graph: the first two supersteps'
        (warm-up, capture)."""
        if host and sched._graph is not None:
            steps = min(steps, 2)
        groups = self.launch_groups(sched.params)
        return {"fused_transition": steps * sched.rounds_per_step * (sched.fl.tau2 + 1) * groups,
                "sgd_update": steps * sched.iterations_per_step * groups}

    def fleet_lane(self, name, steps, expected, **overrides) -> dict:
        """One fleet lane: runs in turns eager, graph, eager under cuDNN's
        deterministic algorithms, each under the profiler (its kernel runs on
        the device held to ``expected(sched)``, its host launches to
        ``expected(sched, host=True)``); the graph run's parameters and losses
        held to the eager runs' at 0.0; the dense backend's run (graph) within
        1e-4; then, with cuDNN's defaults, an eager and a graph run each timed
        over ``FLEET_WARM`` more steps after their first ``steps`` (warm it/s),
        then profiled over ``FLEET_PROFILED`` steps (busy ms, busy share and
        kernel launches an iteration)."""
        import gc

        torch = self.torch
        from repro_torch.kernels import check_eager_session, device_launches
        from repro_torch.scenarios import build_scenario

        def drive(graph, **kw):
            before = self.host_counts()
            run = build_scenario(name, graph=graph, **overrides, **kw)
            src = run.batch_source()
            t0 = time.perf_counter()
            evs, ran = device_launches(lambda: [run.runtime.step(src) for _ in range(steps)])
            dt = time.perf_counter() - t0
            host = {k: n - before[k] for k, n in self.host_counts().items() if n != before[k]}
            sched = run.runtime.scheduler
            losses = [e.losses for e in evs if e.losses is not None]
            losses = (torch.cat(losses).float().cpu() if losses else
                      torch.tensor([run.runtime.evaluate(run.eval_batch)[0]]))
            params = {k: w.detach().float().cpu() for k, w in sched.params.items()}
            return run, {"params": params, "losses": losses}, ran, host, dt, evs

        def diff(a, b):
            return max(max((a["params"][k] - v).abs().max().item() for k, v in b["params"].items()),
                       (a["losses"] - b["losses"]).abs().max().item())

        out, vals = {}, {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for label, graph in (("eager", False), ("graph", True), ("eager2", False)):
                gc.collect()
                run, vals[label], ran, host, dt, evs = drive(graph)
                sched = run.runtime.scheduler
                if (sched.backend.name, run.runtime.device.type) != ("cuda", "cuda"):
                    raise AssertionError(f"{name}: {sched.backend.name} on {run.runtime.device}")
                if not graph:
                    check_eager_session(ran, host)
                want, host_want = expected(sched, steps), expected(sched, steps, host=True)
                if ran != want or host != host_want:
                    raise AssertionError(f"{name} {label}: kernel runs {ran} (expected {want}), "
                                         f"host launches {host} (expected {host_want})")
                graphed = getattr(sched, "_graphs", getattr(sched, "_graph", None))
                if (graphed is not None) != graph:
                    raise AssertionError(f"{name} {label}: graph {graphed is not None}")
                self.check_finite(sched.params, f"{name} {label}")
                per_step = getattr(sched, "iterations_per_step", 1)
                out[label] = {"kernel_runs": ran, "host_launches": host,
                              "it_per_s_cold": steps * per_step / dt}
                if graph:
                    replays = getattr(sched, "_graphs", None) or {"superstep": sched._graph}
                    replays = {e: g.replays for e, g in replays.items()}
                del run, sched, graphed
            ee, ge = diff(vals["eager"], vals["eager2"]), max(
                diff(vals["graph"], vals[e]) for e in ("eager", "eager2"))
        finally:
            torch.backends.cudnn.deterministic = deterministic
        if not ge == ee == 0.0:
            raise AssertionError(f"{name}: graph vs eager {ge}, eager vs eager {ee} (want 0.0)")
        dense_run, dense_vals, _, _, _, _ = drive(None, backend="dense")
        dense = diff(vals["graph"], dense_vals)
        if not dense <= 1e-4:
            raise AssertionError(f"{name}: graph on kernels vs dense {dense:.3e} (tol 1e-4)")
        del dense_run
        warm, busy = {}, {}
        for label, graph in (("eager", False), ("graph", True), ("eager2", False)):
            gc.collect()
            run = build_scenario(name, graph=graph, **overrides)
            src = run.batch_source()
            for _ in range(steps):
                run.runtime.step(src)
            warm[label] = self.warm_rate(run, FLEET_WARM) * per_step
            prof = self.profile_steps(run, FLEET_PROFILED)
            busy[label] = {k: prof[k] / (per_step if k.endswith("per_step") else 1)
                           for k in ("busy_ms_per_step", "busy_share",
                                     "kernel_launches_per_step")}
            busy[label]["kernel_counts_per_iteration"] = {
                n: c / (FLEET_PROFILED * per_step) for n, c in prof["kernel_counts"].items()}
            del run, src
        given = ", ".join(f"{k}={v}" for k, v in overrides.items()) or "as registered"
        print(f"fleet {name} ({given}"
              f"; {steps} steps): cuDNN deterministic, graph vs eager max abs diff {ge:.1e}, "
              f"eager vs eager {ee:.1e} (held to 0.0); graph on kernels vs dense {dense:.3e} "
              f"(tol 1e-4); kernel runs on the device (the profiler's records), eager "
              f"{json.dumps(out['eager']['kernel_runs'])}, graph "
              f"{json.dumps(out['graph']['kernel_runs'])} (held equal, exactly); host launches "
              f"graph {json.dumps(out['graph']['host_launches'])}; graph replays "
              f"{json.dumps(replays)}; warm it/s over {FLEET_WARM} steps, cuDNN defaults: "
              f"eager {warm['eager']:.3f}, graph {warm['graph']:.3f}, eager {warm['eager2']:.3f} "
              f"(graph/eager {2 * warm['graph'] / (warm['eager'] + warm['eager2']):.3f}x); "
              f"an iteration, {FLEET_PROFILED} steps profiled: "
              + "; ".join(f"{k} busy {b['busy_ms_per_step']:.4f} ms, "
                          f"{100 * b['busy_share']:.1f}% busy, "
                          f"{b['kernel_launches_per_step']:.2f} kernel launches"
                          for k, b in busy.items()), flush=True)
        return {**out, "graph_vs_eager": ge, "eager_vs_eager": ee, "graph_vs_dense": dense,
                "it_per_s_warm": warm, "per_iteration_profile": busy, "graph_replays": replays}

    def fleet_async(self) -> dict:
        """dropout-participation-async on the kernels (on its graph) against
        dense on the card: the same events, ``y`` within 1e-4; one run of each
        async kernel per cluster event on the device, none per skipped one."""
        from repro_torch.kernels import device_launches

        name = "dropout-participation-async"
        (run, dt, events, (loss, _)), ran = device_launches(
            lambda: self.run_async(name, ASYNC_EVENTS))
        kinds = [k for k, _, _ in events]
        fired = kinds.count("cluster") * self.launch_groups(run.runtime.scheduler.y)
        if ran != {k: fired for k in ASYNC_KERNELS}:
            raise AssertionError(f"{name}: kernel runs {ran}, events {kinds}")
        sched = run.runtime.scheduler
        # events whose weights dropped a client (weight exactly 0 in cluster_agg)
        masked = sum(not sched.axes.plan.mask(k)[sched._members[c]].all()
                     for k, (kind, c, _) in enumerate(events) if kind == "cluster")
        ref, _, revents, (rloss, _) = self.run_async(name, ASYNC_EVENTS, backend="dense")
        err = max((v.float() - ref.runtime.scheduler.y[k].float()).abs().max().item()
                  for k, v in run.runtime.scheduler.y.items())
        rel = abs(rloss - loss) / abs(rloss)
        if not (revents == events and err <= 1e-4 and rel <= 1e-4):
            raise AssertionError(f"{name}: vs dense events equal {revents == events}, "
                                 f"y diff {err:.3e}, loss rel {rel:.3e}")
        print(f"fleet {name} (graph, {ASYNC_EVENTS} events): kinds {kinds}, {masked} "
              f"cluster events with a client sampled out; kernel runs "
              f"{json.dumps(ran)} (one per cluster event, none per skipped one); vs dense on "
              f"the card: same events, max abs y diff {err:.3e} (tol 1e-4), eval loss rel diff "
              f"{rel:.3e}; {ASYNC_EVENTS / dt:.3f} events/s cold under the profiler", flush=True)
        return {"kinds": kinds, "masked_events": masked, "kernel_runs": ran,
                "max_abs_y_diff": err, "loss_rel_diff": rel}

    def fleet_baselines(self) -> dict:
        """FedAvg, HierFAVG and FEEL (the paper's §V baselines) on MNIST-like
        data, C = 20 (D = 4 for HierFAVG), 20 iterations each, the local step
        on the SGD kernel (backend auto) against the plain path (dense):
        parameters within 1e-4, eval losses 1e-4 relative, wall-clock equal."""
        import numpy as np
        from repro_torch.core import (
            FEELTrainer, FedAvgTrainer, HierFAVGTrainer, MNIST_LATENCY, ClusterSpec,
        )
        from repro_torch.data import FederatedDataset, mnist_like, skewed_label_partition
        from repro_torch.kernels import device_launches
        from repro_torch.models import MnistCNN

        train, test = mnist_like(2400, seed=0).split(0.85)
        ds = FederatedDataset(train, skewed_label_partition(train.y, C, seed=0))
        ev = {"x": test.x[:512], "y": test.y[:512]}
        makers = {
            "FedAvg": lambda b: FedAvgTrainer(MnistCNN(), C, tau=5, lr=LR, latency=MNIST_LATENCY,
                                              backend=b),
            "HierFAVG": lambda b: HierFAVGTrainer(MnistCNN(), ClusterSpec.uniform(C, D), tau1=5,
                                                  tau2=2, lr=LR, latency=MNIST_LATENCY,
                                                  backend=b),
            "FEEL": lambda b: FEELTrainer(MnistCNN(), C, schedule_size=5, tau=5, lr=LR,
                                          latency=MNIST_LATENCY, backend=b),
        }
        out = {}
        for name, make in makers.items():
            res = {}
            for backend in ("auto", "dense"):
                tr = make(backend)
                hist, ran = device_launches(lambda: tr.run(
                    FLEET_BASELINE_ITERS,
                    lambda k: ds.stacked_batch(10, np.random.default_rng(100 + k)), ev,
                    eval_every=10))
                res[tr.route] = (tr, hist, ran)
            (tr, hist, ran), (plain, phist, pran) = res["cuda"], res["dense"]
            err = max((w - plain.params[k]).abs().max().item() for k, w in tr.params.items())
            rel = max(abs(a - b) / abs(b) for a, b in zip(hist.loss, phist.loss))
            want = {"sgd_update": FLEET_BASELINE_ITERS * self.launch_groups(tr.params)}
            if not (ran == want and not pran and err <= 1e-4 and rel <= 1e-4
                    and hist.wallclock == phist.wallclock):
                raise AssertionError(f"{name}: kernel runs {ran} (want {want}), plain {pran}; "
                                     f"param diff {err:.3e}, loss rel {rel:.3e}")
            print(f"fleet baseline {name}: {FLEET_BASELINE_ITERS} iterations, kernel runs "
                  f"{json.dumps(ran)}; vs the plain path max abs param diff {err:.3e} (tol 1e-4), "
                  f"eval losses {[round(x, 6) for x in hist.loss]} (rel diff {rel:.3e}), "
                  f"wall-clock {hist.wallclock[-1]:.6f} s (§V-B, equal)", flush=True)
            out[name] = {"kernel_runs": ran, "max_abs_param_diff": err, "loss_rel_diff": rel,
                         "eval_loss": hist.loss, "wallclock": hist.wallclock}
        return out

    def lm_counters(self) -> dict:
        """The LM path's wrappers, their launch counts (and the flash
        wrappers' counts by route) set to 0."""
        counters = self.lm_counters_view()
        for fn in counters.values():
            fn.launches = 0
        for k in ("flash_attention", "flash_attention_backward"):
            counters[k].routes = dict.fromkeys(counters[k].routes, 0)
        return counters

    @staticmethod
    def lm_counters_view() -> dict:
        """The LM path's wrappers by the names the kernels line gives them."""
        from repro_torch.kernels import (
            flash_attention_bwd, flash_attention_fwd, fused_transition, sgd_update,
        )

        return {"flash_attention": flash_attention_fwd,
                "flash_attention_backward": flash_attention_bwd,
                "fused_transition": fused_transition, "sgd_update": sgd_update}

    @staticmethod
    def check_routes(counters, want: dict, what: str) -> dict:
        """Every flash launch of the run took the route ``want`` names for
        its wrapper."""
        routes = {k: dict(counters[k].routes) for k in want}
        for k, r in routes.items():
            if r[want[k]] != counters[k].launches or r[want[k]] == 0:
                raise AssertionError(f"{what}: {k} routes {r}, expected all "
                                     f"{counters[k].launches} on {want[k]}")
        return routes

    def run_lm(self, steps, device=None, **overrides):
        """(run, host seconds for ``steps`` supersteps ending in a synchronize,
        per-iteration losses on the host)."""
        torch = self.torch
        from repro_torch.scenarios import build_scenario

        run = build_scenario("federated-lm-ring", device=device, **overrides)
        src = run.batch_source()
        t0 = time.perf_counter()
        losses = [run.runtime.step(src).losses for _ in range(steps)]
        if run.runtime.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return run, dt, torch.cat(losses).float().cpu()

    def lm_launches(self, sched, cfg, steps, evaluate, host=False) -> dict:
        """Exact launches of ``steps`` supersteps: one attention launch per
        attention layer (a mamba layer has none) per iteration (clients
        folded), plus the evaluate's forward; one leaf-table launch per launch
        group (dtype, 64 leaves) per SGD step and transition.  ``host``: the
        launches the wrappers count on the host, which on a CUDA graph are
        those of the first two supersteps (warm-up, capture)."""
        if host and sched._graph is not None:
            steps = min(steps, 2)
        iters = steps * sched.iterations_per_step
        transitions = steps * sched.rounds_per_step * (sched.fl.tau2 + 1)
        groups = self.launch_groups(sched.params)
        attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
        return {"flash_attention": attn * (iters + evaluate),
                "flash_attention_backward": attn * iters,
                "fused_transition": transitions * groups, "sgd_update": iters * groups}

    def lm_path(self):
        """This slice's path: federated-lm-ring on the flash, SGD and
        transition kernels, held to the dense backend with plain attention."""
        torch = self.torch
        from repro_torch.core.pipeline import stack_window
        from repro_torch.kernels import device_launches

        def drive():
            run, dt, losses = self.run_lm(LM_STEPS)
            return run, dt, losses, run.runtime.evaluate(run.eval_batch)[0]

        counters = self.lm_counters()
        (run, dt, losses, loss), ran = device_launches(drive)
        launches = {k: fn.launches for k, fn in counters.items()}
        routes = self.check_routes(counters, {"flash_attention": "split_tf32",
                                              "flash_attention_backward": "split_tf32"},
                                   "lm (f32)")
        sched, cfg = run.runtime.scheduler, run.runtime.model.cfg
        if sched.backend.name != "cuda" or run.runtime.device.type != "cuda" \
                or cfg.attn_impl != "cuda":
            raise AssertionError(f"auto resolved to {sched.backend.name} on "
                                 f"{run.runtime.device} with attn_impl {cfg.attn_impl}")
        iters = LM_STEPS * sched.iterations_per_step
        leaves = len(sched.params)
        if sched._graph is None or sched._graph.replays < 2:
            raise AssertionError("lm: the superstep graph was not replayed at least twice")
        expected = self.lm_launches(sched, cfg, LM_STEPS, evaluate=True)
        host_expected = self.lm_launches(sched, cfg, LM_STEPS, evaluate=True, host=True)
        if self.by_wrapper(expected, "split_tf32", "split_tf32") != ran:
            raise AssertionError(f"lm kernel runs {ran}, expected {expected}")
        if launches != host_expected:
            raise AssertionError(f"lm host launches {launches}, expected {host_expected}")
        ran = expected  # the same counts, by this script's kernel names
        self.check_finite(sched.params, "lm cuda run")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("lm cuda run: non-finite losses")
        c, b, s = sched.fl.num_clients, run.batch_size, run.eval_batch["tokens"].shape[1]
        print(f"lm federated-lm-ring on {run.runtime.device}, backend {sched.backend.name}, "
              f"attn_impl {cfg.attn_impl}, CUDA graphs (the default; "
              f"{sched._graph.replays} replays): {LM_STEPS} supersteps = {iters} iterations "
              f"(C={c}, b={b}, S={s}, {cfg.num_layers} layers, {leaves} leaves); kernel runs "
              f"on the device {json.dumps(ran)} (the profiler's records), host launches "
              f"{json.dumps(launches)} (the first two supersteps' and the evaluate's; both "
              f"expected exactly); {iters / dt:.3f} it/s cold under the profiler "
              f"({dt:.4f}s); losses first {losses[0]:.6f} last {losses[-1]:.6f}; eval loss "
              f"{loss:.6f}; flash routes {json.dumps(routes)}", flush=True)
        for kname in ("flash_attention", "flash_attention_backward"):
            self.record[kname]["launches"] = ran[kname]
            self.record[kname]["host_launches"] = launches[kname]

        ref = {}
        plain = {"backend": "dense", "arch_overrides": {"attn_impl": "plain"}}
        for label, device in (("dense+plain on cuda (graph)", None),
                              ("dense+plain on cpu (eager)", "cpu")):
            r, _, rlosses = self.run_lm(LM_STEPS, device=device, **plain)
            rloss, _ = r.runtime.evaluate(r.eval_batch)
            err = max((w.float().cpu() - r.runtime.scheduler.params[k].float().cpu())
                      .abs().max().item() for k, w in sched.params.items())
            lerr = (losses - rlosses).abs().max().item()
            rel = abs(rloss - loss) / abs(rloss)
            ref[label] = {"max_abs_param_diff": err, "max_abs_loss_diff": lerr,
                          "eval_loss": rloss, "loss_rel_diff": rel}
            print(f"  vs {label}: max abs param diff {err:.3e} (tol 1e-4), per-iteration "
                  f"losses {lerr:.3e} (tol 1e-4), eval loss {rloss:.6f} rel diff {rel:.3e} "
                  f"(tol 1e-4)", flush=True)
            if not (err <= 1e-4 and lerr <= 1e-4 and rel <= 1e-4):
                raise AssertionError(f"lm kernel run disagrees with {label}")
            del r

        split = self.iteration_split(run)
        ips, replays = sched.iterations_per_step, sched._graph.replays
        src = run.batch_source()
        host = self.host_split(lambda k: stack_window(src, (k - 1) * ips + 1, ips), 20)
        print("lm split of one iteration (eager calls): "
              + ", ".join(f"{k}={v:.4f}" for k, v in split.items())
              + "; host ms a superstep left beside a replay: "
              + ", ".join(f"{k}={v:.4f}" for k, v in host.items()), flush=True)
        del run, sched, src  # the A/B's memory peaks start without this run's graph

        def drive(graph):
            r, rdt, rlosses = self.run_lm(LM_STEPS, graph=graph)
            params = {k: w.detach().float().cpu() for k, w in r.runtime.scheduler.params.items()}
            return r, rdt, {"params": params, "losses": rlosses}

        def window_launches(sched, host):
            return self.by_wrapper(self.lm_launches(sched, cfg, LM_STEPS, False, host),
                                   "split_tf32", "split_tf32")

        # one timed pass, after the held one (the one before it: PRs 18-30)
        ab = self.graph_ab("lm", drive, window_launches, LM_STEPS * ips, warm=8, profile=2,
                           per_step=ips, timed=("after",))
        for side in ab["eager"] + ab["graph"]:
            side["tokens_per_s_warm"] = side["it_per_s_warm"] * c * b * s
        print("  lm tokens/s warm, after the held pass: eager " + ", ".join(
            f"{r['tokens_per_s_warm']:.1f}" for r in ab["eager"]) + "; graph " + ", ".join(
            f"{r['tokens_per_s_warm']:.1f}" for r in ab["graph"]), flush=True)
        self.detail["lm"] = {"launches": ran, "host_launches": launches, "flash_routes": routes,
                             "graph_replays": replays,
                             "it_per_s_cold": iters / dt, "split": split,
                             "host_split": host, "eval_loss": loss, "losses": losses.tolist(),
                             "references": ref, "eager_vs_graph": ab}

    def lm_width(self):
        """federated-lm-ring at granite-8b's published widths, cut in depth."""
        torch = self.torch
        counters = self.lm_counters()
        torch.cuda.reset_peak_memory_stats()
        run, dt, losses = self.run_lm(LM_WIDTH_STEPS, **LM_WIDTH)
        peak = torch.cuda.max_memory_allocated()
        launches = {k: fn.launches for k, fn in counters.items()}
        routes = self.check_routes(counters, {"flash_attention": "tensor_core",
                                              "flash_attention_backward": "tensor_core"},
                                   "lm-width (bf16)")
        for kname in routes:
            self.record[kname]["width"]["launches"] = launches[kname]
        sched, cfg = run.runtime.scheduler, run.runtime.model.cfg
        iters = LM_WIDTH_STEPS * sched.iterations_per_step
        c, b, s = sched.fl.num_clients, run.batch_size, LM_WIDTH["seq_len"]
        expected = self.lm_launches(sched, cfg, LM_WIDTH_STEPS, evaluate=False)
        if launches != expected:
            raise AssertionError(f"lm-width launches {launches}, expected {expected}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("lm-width run: non-finite losses")
        n_params = sum(w[0].numel() for w in sched.params.values())
        print(f"lm-width federated-lm-ring at granite-8b widths, eager (graph=False: the "
              f"device is busy throughout, and its peak leaves no room for a graph's pool) "
              f"({cfg.d_model} d_model, "
              f"{cfg.d_ff} d_ff, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
              f"vocab {cfg.vocab_size}, S={s}, {cfg.dtype}); cuts: depth 36 -> "
              f"{cfg.num_layers} layers, per-client batch 2 -> {b}, no evaluate (its 64 "
              f"sequences would need 25.8 GB of f32 logits); {n_params} params per client x "
              f"{c} clients; {iters} iterations in {dt:.3f}s = {iters / dt:.4f} it/s, "
              f"{iters * c * b * s / dt:.1f} tokens/s (first-call costs included); launches "
              f"{json.dumps(launches)}, flash routes {json.dumps(routes)}; peak device "
              f"memory {peak / 2**30:.2f} GiB; losses "
              f"{[round(x, 4) for x in losses.tolist()]}", flush=True)
        warm_dt = 1.0 / self.warm_rate(run, 1)
        busy = self.profile_steps(run, 1)
        wiph = sched.iterations_per_step / warm_dt
        print(f"lm-width warm: {wiph:.4f} it/s, {wiph * c * b * s:.1f} tokens/s (1 superstep, "
              f"{warm_dt:.3f}s); profiled 1 superstep: {json.dumps(busy)}", flush=True)

        held = self.hold_client_grads(run, "lm-width")
        tree_times = self.time_width_trees(run, launches)
        self.detail["lm_width"] = {
            "launches": launches, "flash_routes": routes, "params_per_client": n_params,
            "peak_bytes": peak,
            "it_per_s_cold": iters / dt, "it_per_s_warm": wiph,
            "tokens_per_s_warm": wiph * c * b * s, "profile": busy,
            "losses": losses.tolist(), "cuts": {"num_layers": [36, cfg.num_layers],
                                                "batch_size": [2, b], "evaluate": False},
            "cuda_vs_plain": held, "leaf_table_kernels": tree_times}

    def hold_client_grads(self, run, what, p0=None, hold_grads=True) -> dict:
        """Client 0's loss and gradients on its first batch, at the run's
        state or at ``p0``, ``attn_impl`` ``cuda`` (the flash kernels)
        against ``plain``: the loss within 1e-2 relative and, with
        ``hold_grads``, every leaf's gradient within 5e-2 in relative norm
        (the three leaves furthest apart are named)."""
        import dataclasses

        torch = self.torch
        from repro_torch.models import CausalLM

        cfg = run.runtime.model.cfg
        if p0 is None:
            p0 = {k: w[0] for k, w in run.runtime.scheduler.params.items()}
        batch = {k: torch.as_tensor(v[0], device=self.dev)
                 for k, v in run.batch_source()(0).items()}
        got = {}
        for impl in ("cuda", "plain"):
            model = CausalLM(dataclasses.replace(cfg, attn_impl=impl))
            g, l = torch.func.grad_and_value(model.loss)(p0, batch)
            got[impl] = (l.item(), g)
            del g
        lrel = abs(got["cuda"][0] - got["plain"][0]) / abs(got["plain"][0])
        # per leaf: the norm of the difference over the norm of the plain
        # gradient, and the same with max norms
        rel = {k: ((got["cuda"][1][k].float() - g.float()).norm() / g.float().norm()).item()
               for k, g in got["plain"][1].items()}
        gerr = max(rel.values())
        gmax = max((got["cuda"][1][k].float() - g.float()).abs().max().item()
                   / max(g.float().abs().max().item(), 1e-30)
                   for k, g in got["plain"][1].items())
        worst = sorted(rel.items(), key=lambda r: -r[1])[:3]
        print(f"  {what}, one client, attn_impl cuda vs plain: loss {got['cuda'][0]:.6f} vs "
              f"{got['plain'][0]:.6f} (rel {lrel:.3e}, tol 1e-2); gradients |diff| / |plain| "
              f"{gerr:.3e} ({'tol 5e-2' if hold_grads else 'reported, not held'}: bf16 keeps "
              f"8 bits, and both paths round every activation to bf16, from sums taken in "
              f"different orders), max-norm {gmax:.3e}; furthest leaves "
              f"{[(k, round(v, 5)) for k, v in worst]}", flush=True)
        if not lrel <= 1e-2 or (hold_grads and not gerr <= 5e-2):
            raise AssertionError(f"{what}: flash and plain attention disagree")
        del got, p0, batch
        torch.cuda.empty_cache()
        return {"loss_rel": lrel, "grad_rel_norm": gerr, "grad_rel_max": gmax,
                "furthest_leaves": worst}

    def hold_attention_grads(self, run, what, p0) -> dict:
        """The first layer's attention (projections, RoPE, flash or plain
        attention, output projection) at client 0's first batch from ``p0``:
        its output and the vjp of a fixed random cotangent with respect to
        its input and its four weights, ``attn_impl`` ``cuda`` against
        ``plain``, each within 5e-2 in relative norm."""
        import dataclasses

        torch = self.torch
        from repro_torch.models import transformer
        from repro_torch.models.layers import rms_norm

        cfg = run.runtime.model.cfg
        names = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")
        p = {k[len("blocks.pos0."):]: w[0] for k, w in p0.items() if k.startswith("blocks.pos0.")}
        tokens = torch.as_tensor(run.batch_source()(0)["tokens"][0], device=self.dev)
        pos = torch.arange(tokens.shape[-1], device=self.dev)
        with torch.no_grad():
            h = rms_norm(run.runtime.model.embed_tokens(p0, tokens), p["ln_mix"], cfg.norm_eps)
        gen = torch.Generator(device=self.dev).manual_seed(7)
        gout = torch.randn(h.shape, generator=gen, device=self.dev).to(h.dtype)
        got = {}
        for impl in ("cuda", "plain"):
            c = dataclasses.replace(cfg, attn_impl=impl)

            def attn(hh, *ws, c=c):
                return transformer._attention(dict(zip(names, ws)), hh, c,
                                              window=cfg.window_for_layer(0), positions=pos)[0]

            out, vjp = torch.func.vjp(attn, h, *(p[k] for k in names))
            got[impl] = (out, vjp(gout))
        rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
        res = {"output": rel(got["cuda"][0], got["plain"][0])}
        res.update({k: rel(a, b) for k, a, b in zip(("input",) + names, got["cuda"][1],
                                                    got["plain"][1])})
        print(f"  {what}: the first layer's attention at client 0's state, flash vs plain, "
              f"|diff| / |plain| {json.dumps({k: round(v, 6) for k, v in res.items()})} "
              f"(tol 5e-2)", flush=True)
        del got, h, gout
        torch.cuda.empty_cache()
        if not max(res.values()) <= 5e-2:
            raise AssertionError(f"{what}: the attention's flash and plain paths disagree")
        return res

    def time_width_trees(self, run, launches) -> dict:
        """The two leaf-table kernels at the lm-width run's bf16 shapes (C = 8
        clients, 12 leaves), first out of place against their plain versions
        (the transition on random leaves, SGD on the run's), then timed on
        the run's own tree, in place: the transition as the inter event
        calls it (``CudaBackend.transition``, D = 4, alpha = 2), SGD with a
        gradient-sized buffer.  Eager and graph times against the bytes
        bound, and the library yardsticks (per-leaf ``torch.matmul`` into a
        reused buffer, one ``torch._foreach_add_``); recorded under each
        kernel's ``width``."""
        torch = self.torch
        from repro_torch.kernels import sgd_update_tree

        sched = run.runtime.scheduler
        backend, params = sched.backend, sched.params
        nbytes = sum(w.numel() * w.element_size() for w in params.values())
        m_total = sum(w[0].numel() for w in params.values())
        c, d, alpha = backend._bt.shape[0], backend._bt.shape[1], backend.alpha
        groups = self.launch_groups(params)
        chunk = 1 << 24  # columns the plain versions take at a time

        # both tree calls (out of place) against the plain versions first, on
        # random leaves of the run's shapes: the run's own clients are nearly
        # equal after its transitions, so a mix of them hardly moves them
        gen = torch.Generator(device=self.dev).manual_seed(3)
        grads = {k: torch.randn(w.shape, generator=gen, device=self.dev).to(w.dtype)
                 for k, w in params.items()}
        tr_err, tr_moved = self.hold_transition_tree(
            grads, backend._vt, backend._p, backend._bt, alpha, 3e-2, "lm-width bf16", groups,
            chunk)
        sgd_err = self.hold_sgd_tree(params, grads, 0.0, "lm-width bf16", groups, chunk * c)
        torch.cuda.empty_cache()
        print(f"  lm-width tree calls against the plain versions: fused_transition on random "
              f"bf16 leaves max abs err {tr_err:.3e} (tol 3e-2; the transition moves its input "
              f"by up to {tr_moved:.3e}), sgd_update {sgd_err:.3e} (bitwise equal)", flush=True)
        errs = {"fused_transition": tr_err, "sgd_update": sgd_err}
        t_lib = (backend._vt.T @ torch.linalg.matrix_power(backend._p, alpha)
                 @ backend._bt.T).T.to(torch.bfloat16).contiguous()
        scratch = torch.empty(max(w.numel() for w in params.values()), dtype=torch.bfloat16,
                              device=self.dev)
        flat = [w.view(c, -1) for w in params.values()]
        ws, gs = list(params.values()), [grads[k] for k in params]
        calls = {
            "fused_transition": (
                lambda: backend.transition(params, "inter"),
                lambda: [torch.matmul(t_lib, w, out=scratch[:w.numel()].view(w.shape))
                         for w in flat],
                self.bound(2 * nbytes, 2 * m_total * (2 * c * d + alpha * d * d),
                           BF16_FLOPS_PER_S)),
            "sgd_update": (
                lambda: sgd_update_tree(params, grads, 1e-6, inplace=True),
                lambda: torch._foreach_add_(ws, gs, alpha=-1e-6),
                self.bound(3 * nbytes, 2 * m_total * c, BF16_FLOPS_PER_S)),
        }
        # yardsticks of the transition: the intra event (alpha = 0, two of the
        # three transitions of a round), and the card's copy of the same tree
        # (read once, written once, as the transition)
        extra = {"fused_transition": {
            "intra_ms": self.cuda_ms(lambda: backend.transition(params, "intra"), reps=5,
                                     warmup=1),
            "intra_graph_ms": self.graph_ms(lambda: backend.transition(params, "intra"), reps=5),
            "copy_graph_ms": self.graph_ms(lambda: torch._foreach_copy_(gs, ws), reps=5)},
            "sgd_update": {}}
        out = {}
        for kname, (fn, lib, (bnd, by)) in calls.items():
            ms, lib_ms = self.cuda_ms(fn, reps=5, warmup=1), self.cuda_ms(lib, reps=5, warmup=1)
            g_ms = self.graph_ms(fn, reps=5)
            torch.cuda.empty_cache()
            out[kname] = {
                "shape": {"clients": c, "clusters": d, "alpha": alpha if kname ==
                          "fused_transition" else None, "leaves": len(params),
                          "params_per_client": m_total},
                "dtype": "bfloat16", "route": "cuda", "source": KERNELS[kname]["source"],
                "launches": launches[kname], "launches_per_call": groups,
                "max_abs_err": errs[kname], "ms": ms, "graph_ms": g_ms, "bound_ms": bnd,
                "bound_by": by,
                "bound_share": bnd / ms, "graph_bound_share": bnd / g_ms, "library_ms": lib_ms,
                **extra[kname]}
            self.record[kname]["width"] = out[kname]
            print(f"  lm-width {kname} over {len(params)} bf16 leaves ({m_total} params x {c} "
                  f"clients): " + ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else
                                            f"{k}={v}" for k, v in out[kname].items()
                                            if k not in ("shape", "source")), flush=True)
        del grads, scratch, ws, gs, flat
        torch.cuda.empty_cache()
        return out

    # -- the model families ----------------------------------------------------
    @contextlib.contextmanager
    def deterministic(self):
        """``torch.use_deterministic_algorithms(True, warn_only=True)``, with
        cuBLAS's deterministic workspace: ops that have a deterministic
        implementation take it (the index and scatter backwards), and an op
        that has none warns; yields the list of those warnings' texts."""
        import os
        import warnings

        torch = self.torch
        before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        refused: list = []
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield refused
            refused.extend(sorted({str(w.message)[:160] for w in caught
                                   if "deterministic" in str(w.message)}))
        finally:
            torch.use_deterministic_algorithms(False)
            if before is None:
                del os.environ["CUBLAS_WORKSPACE_CONFIG"]
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = before

    def families(self):
        """The model families at ``reduced()`` widths (f32) on the round's CUDA
        graph: ``federated-lm-ring`` with ``model=CausalLM(get_config(name)
        .reduced())`` for each of ``FAMILIES``, every LM counter set to 0
        just before the phase and read just after (flash forward and
        backward, SGD and transition must each have launched), each lane
        held as ``lm`` is (``family_lane``); then musicgen's codebook model,
        flash against plain (``family_audio``)."""
        counters = self.lm_counters()
        out = {name: self.family_lane(name) for name in FAMILIES}
        out["musicgen-large"] = self.family_audio()
        launches = {k: fn.launches for k, fn in counters.items()}
        if not all(launches.values()):
            raise AssertionError(f"families: a kernel of the path never launched: {launches}")
        for kname, n in launches.items():
            self.record[kname]["families_host_launches"] = n
        print(f"families: host launches over the phase {json.dumps(launches)}", flush=True)
        self.detail["families"] = out

    def family_lane(self, name) -> dict:
        """``FAMILY_STEPS`` supersteps of federated-lm-ring on ``name``'s reduced
        model (cut to ``FAMILY_LAYERS``, supersteps of ``FAMILY_ROUNDS_PER_STEP``): an
        eager and a graph run under
        deterministic algorithms
        and the profiler (kernel runs on the device exactly
        ``lm_launches``: flash per attention layer, the leaf-table kernels
        per launch group; an eager session short of its host launches raises
        ``ShortSessionError``; host launches the graph's warm-up and capture),
        graph = eager at 0.0, the graph replayed; then the dense backend with
        plain attention (graph) within 1e-4 on parameters and per-iteration
        losses."""
        import dataclasses
        import gc

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.kernels import check_eager_session, device_launches
        from repro_torch.models import CausalLM

        t0 = time.perf_counter()
        cfg = get_config(name).reduced()
        if name in FAMILY_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=FAMILY_LAYERS[name])

        def drive(graph, impl="cuda", **kw):
            gc.collect()
            kw = {"rounds_per_step": FAMILY_ROUNDS_PER_STEP, **kw}
            model = CausalLM(dataclasses.replace(cfg, attn_impl=impl))
            before = self.host_counts()
            (run, dt, losses), ran = device_launches(
                lambda: self.run_lm(FAMILY_STEPS, model=model, graph=graph, **kw))
            host = {k: n - before[k] for k, n in self.host_counts().items() if n != before[k]}
            params = {k: w.detach().float().cpu() for k, w in run.runtime.scheduler.params.items()}
            return run, dt, {"params": params, "losses": losses}, ran, host

        def diff(a, b):
            return max(max((a["params"][k] - v).abs().max().item() for k, v in b["params"].items()),
                       (a["losses"] - b["losses"]).abs().max().item())

        vals, runs = {}, {}
        with self.deterministic() as refused:
            for label, graph in (("eager", False), ("graph", True)):
                run, dt, vals[label], ran, host = drive(graph)
                sched = run.runtime.scheduler
                if (sched.backend.name, run.runtime.device.type) != ("cuda", "cuda"):
                    raise AssertionError(f"{name}: {sched.backend.name} on {run.runtime.device}")
                if (sched._graph is not None) != graph or (graph and sched._graph.replays < 1):
                    raise AssertionError(f"{name} {label}: graph {sched._graph}")
                if not graph:
                    check_eager_session(ran, host)
                want = self.by_wrapper(self.lm_launches(sched, cfg, FAMILY_STEPS, False),
                                       "split_tf32", "split_tf32")
                host_want = self.by_wrapper(
                    self.lm_launches(sched, cfg, FAMILY_STEPS, False, host=True),
                    "split_tf32", "split_tf32")
                if ran != want or host != host_want:
                    raise AssertionError(f"{name} {label}: kernel runs {ran} (expected {want}), "
                                         f"host launches {host} (expected {host_want})")
                self.check_finite(sched.params, f"{name} {label}")
                runs[label] = {"kernel_runs": ran, "host_launches": host,
                               "it_per_s_cold": FAMILY_STEPS * sched.iterations_per_step / dt}
                if graph:
                    runs[label]["replays"] = sched._graph.replays
                    batch = run.batch_source()(0)
                groups, leaves = self.launch_groups(sched.params), len(sched.params)
                del run, sched
        ge = diff(vals["graph"], vals["eager"])
        if not ge == 0.0:
            raise AssertionError(f"{name}: graph vs eager {ge} (want 0.0)")
        dense_run, _, dense_vals, _, _ = drive(None, impl="plain", backend="dense")
        dense = {"params": max((vals["graph"]["params"][k] - v).abs().max().item()
                               for k, v in dense_vals["params"].items()),
                 "losses": (vals["graph"]["losses"] - dense_vals["losses"]).abs().max().item()}
        del dense_run
        chaotic = name in FAMILY_CHAOTIC
        if not chaotic and not (dense["params"] <= 1e-4 and dense["losses"] <= 1e-4):
            raise AssertionError(f"{name}: kernels vs dense+plain {dense} (tol 1e-4)")
        step = self.fleet_step(cfg, vals["graph"]["params"], batch)
        attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
        moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        print(f"families {name} reduced ({cfg.num_layers} layers: {attn} attention, "
              f"{cfg.num_layers - attn} mamba, {moe} MoE; d_model {cfg.d_model}, f32, "
              f"{leaves} leaves = {groups} launch groups): {FAMILY_STEPS} supersteps, "
              f"deterministic algorithms, graph vs eager {ge:.1e} (held to 0.0); ops without a deterministic implementation: "
              f"{refused or 'none'}; kernel runs on the device {json.dumps(runs['graph']['kernel_runs'])} "
              f"(every turn, exactly), host launches graph "
              f"{json.dumps(runs['graph']['host_launches'])}, {runs['graph']['replays']} "
              f"replays; cold it/s eager {runs['eager']['it_per_s_cold']:.3f}, graph "
              f"{runs['graph']['it_per_s_cold']:.3f}; vs dense+plain max abs diff params "
              f"{dense['params']:.3e}, losses {dense['losses']:.3e} "
              f"({'reported, not held: see FAMILY_CHAOTIC' if chaotic else 'tol 1e-4'}); one "
              f"fleet iteration from the graph run's state, flash vs plain: losses "
              f"{step['losses']:.3e}, gradients {step['grads']:.3e} (tol 1e-4); "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        return {**runs, "graph_vs_eager": ge, "vs_dense_plain": dense,
                "vs_dense_plain_held": not chaotic, "fleet_step_flash_vs_plain": step,
                "no_deterministic_impl": refused, "launch_groups": groups, "leaves": leaves,
                "losses": vals["graph"]["losses"].tolist()}

    def fleet_step(self, cfg, params, batch) -> dict:
        """One fleet iteration's losses and gradients (``vmap(grad_and_value)``
        over the clients) from ``params`` on ``batch``, the flash kernels
        against plain attention: both within 1e-4 (a gradient leaf's of
        max(1, its largest entry)); returns the two differences."""
        import dataclasses

        torch = self.torch
        from repro_torch.models import CausalLM

        params = {k: w.to(self.dev) for k, w in params.items()}
        batch = {k: torch.as_tensor(v, device=self.dev) for k, v in batch.items()}
        got = {}
        for impl in ("cuda", "plain"):
            model = CausalLM(dataclasses.replace(cfg, attn_impl=impl))
            got[impl] = torch.func.vmap(torch.func.grad_and_value(model.loss))(params, batch)
        (g, loss), (gp, lp) = got["cuda"], got["plain"]
        out = {"losses": (loss - lp).abs().max().item(),
               "grads": max(((g[k] - r).abs().max() / max(1.0, r.abs().max().item())).item()
                            for k, r in gp.items())}
        del got, g, gp, params
        if not (out["losses"] <= 1e-4 and out["grads"] <= 1e-4):
            raise AssertionError(f"{cfg.name}: one fleet iteration, flash vs plain {out} "
                                 f"(tol 1e-4)")
        return out

    def family_audio(self) -> dict:
        """musicgen-large's reduced ``CausalLM`` (4 codebooks) on ``(B, 4, S)``
        tokens: loss and gradients with the flash kernels against plain
        attention, within 1e-5 (of a leaf's largest entry where that is
        above 1)."""
        import dataclasses

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import CausalLM

        cfg = get_config("musicgen-large").reduced()
        gen = torch.Generator().manual_seed(0)
        params = {k: w.to(self.dev) for k, w in CausalLM(cfg).init(gen).items()}
        shape = (2, cfg.num_codebooks, 64)
        batch = {k: torch.randint(0, cfg.vocab_size, shape, generator=gen).to(self.dev)
                 for k in ("tokens", "labels")}
        got = {}
        for impl in ("cuda", "plain"):
            model = CausalLM(dataclasses.replace(cfg, attn_impl=impl))
            got[impl] = torch.func.grad_and_value(model.loss)(params, batch)
        (g, loss), (gp, lp) = got["cuda"], got["plain"]
        lerr = abs(loss.item() - lp.item())
        gerr = max(((g[k] - r).abs().max() / max(1.0, r.abs().max().item())).item()
                   for k, r in gp.items())
        print(f"families musicgen-large reduced ({cfg.num_codebooks} codebooks, tokens "
              f"{shape}, {cfg.num_layers} layers, f32): loss flash {loss.item():.6f} vs plain "
              f"{lp.item():.6f} (diff {lerr:.3e}, tol 1e-5); gradients max abs diff "
              f"{gerr:.3e} of max(1, the leaf's largest entry) (tol 1e-5)", flush=True)
        if not (lerr <= 1e-5 and gerr <= 1e-5):
            raise AssertionError("musicgen-large: flash and plain attention disagree")
        return {"tokens": list(shape), "loss": loss.item(), "loss_diff": lerr, "grad_diff": gerr}

    def width_lane(self, what, model, steps, graph, **overrides):
        """federated-lm-ring at a published width, on the round's CUDA graph
        or eager (``graph``): (run, cold host seconds, losses, host launches
        by the LM counters, each set to 0 just before and held exactly to
        ``lm_launches`` (a graph's warm-up and capture), peak bytes, client
        0's initial parameters)."""
        torch = self.torch
        from repro_torch.scenarios import build_scenario

        counters = self.lm_counters()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = build_scenario("federated-lm-ring", model=model, graph=None if graph else False,
                             **overrides)
        p_init = {k: w[0].clone() for k, w in run.runtime.scheduler.params.items()}
        src = run.batch_source()
        t0 = time.perf_counter()
        losses = torch.cat([run.runtime.step(src).losses for _ in range(steps)]).float().cpu()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = {k: fn.launches for k, fn in counters.items()}
        sched = run.runtime.scheduler
        if (sched._graph is not None) != graph or (graph and sched._graph.replays < 1):
            raise AssertionError(f"{what}: graph {sched._graph}")
        expected = self.lm_launches(sched, model.cfg, steps, evaluate=False, host=True)
        if launches != expected or not launches["sgd_update"]:
            raise AssertionError(f"{what} host launches {launches}, expected {expected}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{what}: non-finite losses {losses.tolist()}")
        self.check_finite(sched.params, what)
        return run, dt, losses, launches, peak, p_init

    def width_split(self, run) -> dict:
        """Device milliseconds of one warm superstep by part, from the
        profiler's kernel names (``WIDTH_PARTS``, the first match of each
        name; the rest as ``other``), the busy share and the wall time; the
        kernel runs of the path's wrappers in it held to ``lm_launches``.  (A
        session that also records the ops' input shapes, to tell one GEMM
        from another, ran out of memory at these widths: it keeps what the
        step frees.)"""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import count_kernels

        src = run.batch_source()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run.runtime.step(src)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = {(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        busy_us, end = 0.0, float("-inf")
        for _, a, b in sorted(spans, key=lambda x: x[1]):
            if b > end:
                busy_us += b - max(a, end)
                end = b
        parts: dict = {}
        flash_bwd_ms = 0.0
        for name, a, b in spans:
            key = next((part for part, marks in WIDTH_PARTS
                        if any(m in name for m in marks)), "other")
            parts[key] = parts.get(key, 0.0) + (b - a) / 1e3
            flash_bwd_ms += (b - a) / 1e3 if "flash_bwd_" in name else 0.0
        ran = count_kernels(name for name, _, _ in spans)
        want = self.by_wrapper(self.lm_launches(run.runtime.scheduler, run.runtime.model.cfg, 1,
                                                False), "tensor_core", "tensor_core")
        if ran != want:
            raise AssertionError(f"width superstep: kernel runs {ran}, expected {want}")
        return {"kernel_runs": ran, "wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
                "busy_share": busy_us / 1e3 / wall_ms, "kernels": len(spans),
                "parts_ms": {k: round(v, 4) for k, v in sorted(parts.items())},
                "flash_backward_ms": round(flash_bwd_ms, 4)}

    def moe_width(self):
        """mixtral-8x7b at its published widths (``MOE_WIDTH``), cut in depth,
        eager: the launches held exactly, rates, peak memory, the device time
        of a superstep by part, the share of (token, expert) assignments the
        capacity drops, one client's gradients flash vs plain, and the mixed
        f32/bf16 trees against their plain versions."""
        import dataclasses
        import gc

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.kernels import flash_attention_bwd, flash_attention_fwd
        from repro_torch.models import CausalLM

        w = MOE_WIDTH
        pub = get_config("mixtral-8x7b")
        cfg = dataclasses.replace(pub, num_layers=w["num_layers"], remat=False)
        run, dt, losses, launches, peak, p_init = self.width_lane(
            "moe-width", CausalLM(cfg), WIDTH_STEPS, True, num_clients=w["num_clients"],
            num_clusters=w["num_clusters"], seq_len=w["seq_len"], batch_size=w["batch_size"],
            vocab_size=pub.vocab_size, num_samples=16)
        for kname in launches:
            self.record[kname]["moe_width_launches"] = launches[kname]
        sched = run.runtime.scheduler
        c, b, s = sched.fl.num_clients, run.batch_size, w["seq_len"]
        iters = WIDTH_STEPS * sched.iterations_per_step
        from repro_torch.models.moe import moe_capacity

        cap = moe_capacity(s, cfg.num_experts_per_tok, cfg.num_experts, cfg.moe_capacity_factor)
        routes = self.check_routes({"flash_attention": flash_attention_fwd,
                                    "flash_attention_backward": flash_attention_bwd},
                                   {"flash_attention": "tensor_core",
                                    "flash_attention_backward": "tensor_core"}, "moe-width")
        wiph = sched.iterations_per_step * self.warm_rate(run, 1)
        split = self.width_split(run)
        replays = sched._graph.replays
        # the graph and its private pool are not needed past here: the holds
        # below take copies of the 13.7 GB tree
        sched._graph = None
        gc.collect()
        torch.cuda.empty_cache()
        split["expert_gemms_ms"] = self.expert_gemms_ms(run, cap) * sched.iterations_per_step
        drop = self.moe_routing(run, cfg, cap)
        drop_init = self.moe_routing(run, cfg, cap, p_init)
        n_params = sum(w_[0].numel() for w_ in sched.params.values())
        print(f"moe-width federated-lm-ring at mixtral-8x7b's published widths, on the "
              f"round's CUDA graph ({replays} replays; peak {peak / 2**30:.2f} "
              f"GiB with its pool): "
              f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_experts} experts top-"
              f"{cfg.num_experts_per_tok}, capacity factor {cfg.moe_capacity_factor} "
              f"(capacity {cap} a sequence), {cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.head_dim}, window {cfg.sliding_window}, rope {cfg.rope_theta}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype}; cuts: depth {pub.num_layers} -> "
              f"{cfg.num_layers}, remat off, C={c} in D={sched.fl.num_clusters}, S={s}, b={b}, "
              f"no evaluate; {n_params} params per client; {iters} iterations in {dt:.3f}s "
              f"= {iters / dt:.4f} it/s, {iters * c * b * s / dt:.1f} tokens/s cold; warm "
              f"{wiph:.4f} it/s, {wiph * c * b * s:.1f} tokens/s; launches "
              f"{json.dumps(launches)}, flash routes {json.dumps(routes)}; device split of a "
              f"warm superstep {json.dumps(split)}; dropped assignments {drop['dropped']} "
              f"of {drop['assignments']} ({100 * drop['fraction']:.3f}%; at the initial "
              f"state {100 * drop_init['fraction']:.3f}%), tokens whose experts differ "
              f"between flash and plain attention {drop['tokens_routed_differently']} (at the "
              f"initial state {drop_init['tokens_routed_differently']}); losses "
              f"{[round(x, 4) for x in losses.tolist()]}", flush=True)
        # bf16's rounding of the two attentions moves a few tokens across a
        # near tie of the router (14 of 2048 in the first layer at the initial
        # state, on the card), and a moved token's gradients go to other
        # experts, and the router's with them: one client's whole gradient
        # tree flash vs plain is reported (its loss held), and the attention
        # that the flash kernels compute is held on its own, at the model's
        # activations and shapes
        held = {"attention_initial": self.hold_attention_grads(
                    run, "moe-width, initial state", p_init),
                "initial": self.hold_client_grads(run, "moe-width, initial state", p_init,
                                                  hold_grads=False),
                "trained": self.hold_client_grads(run, "moe-width, trained state",
                                                  hold_grads=False)}
        del p_init
        trees = self.hold_mixed_trees(run, "moe-width")
        self.detail["moe_width"] = {
            "launches": launches, "params_per_client": n_params, "peak_bytes": peak,
            "capacity": cap, "it_per_s_cold": iters / dt, "it_per_s_warm": wiph,
            "tokens_per_s_cold": iters * c * b * s / dt, "tokens_per_s_warm": wiph * c * b * s,
            "flash_routes": routes, "split": split, "drops": drop, "drops_initial": drop_init,
            "losses": losses.tolist(),
            "cuda_vs_plain": held, "trees": trees, "graph": True, "graph_replays": replays,
            "cuts": {"num_layers": [pub.num_layers, cfg.num_layers], "remat": [True, False],
                     "clients": c, "clusters": sched.fl.num_clusters, "seq_len": s,
                     "batch_size": b, "evaluate": False}}
        del run, sched
        torch.cuda.empty_cache()

    def expert_gemms_ms(self, run, cap) -> float:
        """CUDA-event ms of one iteration's expert GEMMs, forward and
        backward, for the fleet: ``models.moe._experts`` vmapped over the
        clients on random ``(b, E, cap, d)`` slots and the run's first MoE
        layer's expert weights (its own tensors, detached), gradients of the
        slots and the weights as the training step takes them."""
        torch = self.torch
        from repro_torch.models.moe import _experts

        params = run.runtime.scheduler.params
        ws = [params[f"blocks.pos0.ffn.{k}"][:, 0].detach().requires_grad_()
              for k in ("w_gate", "w_up", "w_down")]
        c, e, d = ws[0].shape[0], ws[0].shape[1], ws[0].shape[2]
        gen = torch.Generator(device=self.dev).manual_seed(5)
        buf = torch.randn((c, run.batch_size, e, cap, d), generator=gen, device=self.dev
                          ).to(ws[0].dtype).requires_grad_()
        gout = torch.randn(buf.shape, generator=gen, device=self.dev).to(buf.dtype)
        experts = torch.func.vmap(
            lambda bb, g, u, dn: _experts(bb, {"w_gate": g, "w_up": u, "w_down": dn}))

        def step():
            torch.autograd.grad(experts(buf, *ws), (buf, *ws), gout)

        ms = self.cuda_ms(step, reps=3, warmup=1)
        del ws, buf, gout
        torch.cuda.empty_cache()
        return ms

    def ssd_ms(self, run, cfg) -> dict:
        """CUDA-event ms of one layer's SSD core for the fleet, forward and
        backward, at the run's shapes (``models.mamba.ssd_chunked`` vmapped
        over the clients on random inputs): the whole core, and its
        inter-chunk recurrence loop alone (``_ssd_recurrence``)."""
        torch = self.torch
        from repro_torch.models.mamba import _ssd_recurrence, ssd_chunked

        c, b, s = run.runtime.scheduler.fl.num_clients, run.batch_size, SSM_WIDTH["seq_len"]
        h, p, n, q = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk
        gen = torch.Generator(device=self.dev).manual_seed(6)

        def rand(*shape, dtype=torch.float32, scale=1.0):
            return (torch.randn(shape, generator=gen, device=self.dev) * scale).to(
                dtype).requires_grad_()

        act = cfg.act_dtype
        dt = torch.nn.functional.softplus(rand(c, b, s, h)).detach().requires_grad_()
        core_in = (rand(c, b, s, h, p, dtype=act), rand(c, b, s, n, dtype=act),
                   rand(c, b, s, n, dtype=act), (-dt * 4).detach().requires_grad_(), dt,
                   torch.zeros((c, b, h, n, p), device=self.dev))
        core = torch.func.vmap(lambda *a: ssd_chunked(*a, chunk=q))
        nc = s // q
        loop_in = (rand(c, b, nc, h, n, p, scale=0.1), rand(c, b, nc, h, scale=0.1),
                   rand(c, b, nc, q, n), rand(c, b, nc, q, h, scale=0.1),
                   torch.zeros((c, b, h, n, p), device=self.dev))
        loop = torch.func.vmap(_ssd_recurrence)

        def grad(fn, inputs):
            y, hf = fn(*inputs)
            leaves = [x for x in inputs if x.requires_grad]
            torch.autograd.grad((y, hf), leaves, (torch.ones_like(y), torch.ones_like(hf)))

        out = {"ssd_core_ms": self.cuda_ms(lambda: grad(core, core_in), reps=3, warmup=1),
               "ssd_recurrence_loop_ms": self.cuda_ms(lambda: grad(loop, loop_in), reps=3,
                                                      warmup=1)}
        del core_in, loop_in, dt
        torch.cuda.empty_cache()
        return out

    def moe_routing(self, run, cfg, cap, params=None) -> dict:
        """The first MoE layer's routing at the run's state (client 0's, or
        ``params``) on client 0's first batch, through the layer's attention
        half to the router: the (token, expert) assignments past ``cap``
        dropped (flash attention), and the tokens whose chosen experts
        differ between the flash kernels and plain attention."""
        import dataclasses

        torch = self.torch
        from repro_torch.models import transformer
        from repro_torch.models.layers import rms_norm
        from repro_torch.models.moe import router_topk

        if params is None:
            params = {k: w_[0] for k, w_ in run.runtime.scheduler.params.items()}
        p = {k[len("blocks.pos0."):]: w_[0] for k, w_ in params.items()
             if k.startswith("blocks.pos0.")}
        tokens = torch.as_tensor(run.batch_source()(0)["tokens"][0], device=self.dev)
        pos = torch.arange(tokens.shape[-1], device=self.dev)
        ids = {}
        with torch.no_grad():
            x = run.runtime.model.embed_tokens(params, tokens)
            for impl in ("cuda", "plain"):
                c = dataclasses.replace(cfg, attn_impl=impl)
                y = x + transformer._attention(p, rms_norm(x, p["ln_mix"], cfg.norm_eps), c,
                                               window=cfg.window_for_layer(0), positions=pos)[0]
                h = rms_norm(y, p["ln_ffn"], cfg.norm_eps)
                ids[impl] = torch.stack([router_topk(seq, p["ffn.w_router"],
                                                     cfg.num_experts_per_tok)[0] for seq in h])
        experts = torch.arange(cfg.num_experts, device=self.dev)
        counts = (ids["cuda"].reshape(ids["cuda"].shape[0], -1)[..., None] == experts).sum(1)
        dropped = int(torch.clamp(counts - cap, min=0).sum())
        moved = int((ids["cuda"].sort(-1).values != ids["plain"].sort(-1).values).any(-1).sum())
        n = ids["cuda"].numel()
        return {"dropped": dropped, "assignments": n, "fraction": dropped / n,
                "tokens_routed_differently": moved}

    def hold_mixed_trees(self, run, what) -> dict:
        """The transition (D = the run's, alpha = the run's) and SGD on random
        leaves of the run's mixed f32/bf16 tree, out of place, against their
        plain versions (bf16 3e-2 for the transition, SGD bitwise; one launch
        a dtype group), then each timed in place on the run's own tree."""
        torch = self.torch
        from repro_torch.kernels import sgd_update_tree

        sched = run.runtime.scheduler
        backend, params = sched.backend, sched.params
        groups = self.launch_groups(params)
        dtypes = sorted({str(w_.dtype)[6:] for w_ in params.values()})
        gen = torch.Generator(device=self.dev).manual_seed(4)
        rand = {k: torch.randn(w_.shape, generator=gen, device=self.dev).to(w_.dtype)
                for k, w_ in params.items()}
        chunk = 1 << 24
        tr_err, moved = self.hold_transition_tree(rand, backend._vt, backend._p, backend._bt,
                                                  backend.alpha, 3e-2, f"{what} mixed", groups,
                                                  chunk)
        sgd_err = self.hold_sgd_tree(params, rand, 0.0, f"{what} mixed", groups,
                                     chunk * backend._bt.shape[0])
        tr_ms = self.cuda_ms(lambda: backend.transition(params, "inter"), reps=3, warmup=1)
        sgd_ms = self.cuda_ms(lambda: sgd_update_tree(params, rand, 1e-6, inplace=True),
                              reps=3, warmup=1)
        nbytes = sum(w_.numel() * w_.element_size() for w_ in params.values())
        del rand
        torch.cuda.empty_cache()
        print(f"  {what} trees ({len(params)} leaves, dtypes {dtypes}, {groups} launches a "
              f"call, {nbytes / 1e9:.3f} GB): fused_transition vs plain max abs err "
              f"{tr_err:.3e} (tol 3e-2; moves its input by up to {moved:.3e}), sgd_update "
              f"bitwise ({sgd_err:.1e}); in place on the run's tree: transition (inter) "
              f"{tr_ms:.4f} ms, sgd_update {sgd_ms:.4f} ms (bytes bound "
              f"{self.bound(2 * nbytes, 0)[0]:.4f} and {self.bound(3 * nbytes, 0)[0]:.4f} ms)",
              flush=True)
        out = {"leaves": len(params), "dtypes": dtypes, "launches_per_call": groups,
               "bytes": nbytes, "fused_transition_max_abs_err": tr_err,
               "sgd_update_max_abs_err": sgd_err, "fused_transition_ms": tr_ms,
               "sgd_update_ms": sgd_ms, "fused_transition_bound_ms": self.bound(2 * nbytes, 0)[0],
               "sgd_update_bound_ms": self.bound(3 * nbytes, 0)[0]}
        for kname in ("fused_transition", "sgd_update"):
            self.record[kname][what.replace("-", "_")] = {
                k: v for k, v in out.items() if not k.startswith(
                    "sgd" if kname == "fused_transition" else "fused")}
        return out

    def optim(self):
        """The stateful optimizers on every path that takes one, with the
        counters of the transition, SGD and flash wrappers set to 0 just
        before the phase and read just after (the transition and both flash
        wrappers must have launched): (a) ``round-superstep-ring`` with
        ``optim.momentum`` on the round's graph and eagerly, in turns eager,
        graph, graph, eager under cuDNN's deterministic algorithms: graph =
        eager at 0.0 on parameters, momentum buffers and losses, one capture
        whose buffers keep their addresses over every replay, the
        ``fused_transition`` device runs of each superstep equal to the same
        SGD run's, no ``sgd_update`` run, and the parameters within 1e-4 of
        the same run on the CPU; (b) ``million-client-ring`` at 10^6 clients
        with momentum on its graph: before every superstep's body the state
        is all zeros (the restart), after it every buffer has moved, at fixed
        addresses, one capture, finite cluster models; (c) lm-width's model
        (granite-8b widths, 2 layers, bf16, S = 2048, b = 1) on
        ``build_fl_round_step`` with C = 4 in D = 2 and the ``cuda``
        backend: SGD (the ``sgd_update`` kernel), momentum (f32 state from
        ``opt.init``) and Adam (bf16 state from ``torch.func.vmap(opt.init)``)
        in turns in this process, each with its peak memory above the turn's
        start, warm supersteps/s, device runs of flash (tensor-core route)
        and ``fused_transition``, finite parameters and state, and its
        optimizer update alone timed with CUDA events beside its bytes bound
        (each input read once, each output written once)."""
        counters = self.lm_counters()
        out, seconds = {}, {}
        for part, fn in (("round", self.optim_round), ("offload", self.optim_offload),
                         ("width", self.optim_width)):
            t0 = time.perf_counter()
            out[part] = fn()
            seconds[part] = time.perf_counter() - t0
        host = {k: fn.launches for k, fn in counters.items()}
        if not all(host[k] for k in ("fused_transition", "flash_attention",
                                     "flash_attention_backward")):
            raise AssertionError(f"optim path: a kernel never launched: {host}")
        print(f"optim path host launches (counters zeroed before it, read after; sgd_update "
              f"only in the SGD rows beside the stateful runs): {json.dumps(host)}; seconds "
              f"by part {json.dumps({k: round(v, 1) for k, v in seconds.items()})} "
              f"[{self.smi}]", flush=True)
        runs = out["width"].pop("device_runs")
        for k in ("fused_transition", "flash_attention", "flash_attention_backward"):
            self.record[k]["optim"] = {"host_launches": host[k],
                                       "lm_width_device_runs": runs[k]}
        self.record["fused_transition"]["optim"]["round_device_runs"] = \
            out["round"]["fused_transition_runs"]
        out["host_launches"], out["seconds"] = host, seconds
        self.detail["optim"] = out

    def optim_round_run(self, graph, opt, device=None, backend="cuda") -> dict:
        """``OPTIM_STEPS`` supersteps of ``OPTIM_ROUND`` with ``opt`` (on the
        card ``backend`` is "auto"'s choice; on the CPU the kernels' plain
        versions run): each superstep's kernel runs on the device (the
        profiler; none on the CPU), the momentum buffers' addresses at bind
        and after, the graph's counts, and the parameters, state and losses
        on the host."""
        from repro_torch.kernels import device_launches
        from repro_torch.scenarios import build_scenario

        run = build_scenario(OPTIM_ROUND, device=device, graph=graph, backend=backend,
                             num_samples=OPTIM_SAMPLES, optimizer=opt)
        sched, src = run.runtime.scheduler, run.batch_source()
        ptrs = {k: v.data_ptr() for k, v in (sched.opt_state or {}).items()}  # SGD's is ()
        ran, losses = [], []
        for _ in range(OPTIM_STEPS):
            if device != "cpu":
                ev, r = device_launches(lambda: run.runtime.step(src))
            else:
                ev, r = run.runtime.step(src), {}
            ran.append(r)
            losses.append(ev.losses)
        g, state = sched._graph, sched.opt_state or {}
        host = lambda t: {k: v.float().cpu() for k, v in t.items()}
        return {"ran": ran, "backend": sched.backend.name,
                "graph": None if g is None else (g.captured, len(g._entries), g.replays),
                "ptrs_fixed": {k: v.data_ptr() for k, v in state.items()} == ptrs,
                "params": host(sched.params), "state": host(state),
                "losses": self.torch.cat(losses).float().cpu()}

    def optim_round(self) -> dict:
        """(a) of the phase."""
        import gc

        torch = self.torch
        from repro_torch.optim import momentum, sgd

        runs = {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for label, graph, opt in (("eager", False, momentum(LR)), ("graph", True, momentum(LR)),
                                      ("graph2", True, momentum(LR)),
                                      ("eager2", False, momentum(LR)),
                                      ("sgd_graph", True, sgd(LR))):
                gc.collect()
                runs[label] = self.optim_round_run(graph, opt)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        cpu = {be: self.optim_round_run(False, momentum(LR), device="cpu", backend=be)
               for be in ("dense", "cuda")}

        def full(a, b):
            """Max abs difference of two runs' parameters, state and losses."""
            trees = [(a[t][k] - v).abs().max().item() for t in ("params", "state")
                     for k, v in b[t].items()]
            return max(trees + [(a["losses"] - b["losses"]).abs().max().item()])

        ee = full(runs["eager"], runs["eager2"])
        ge = max(full(runs[g], runs[e]) for g in ("graph", "graph2") for e in ("eager", "eager2"))
        params = lambda a, b: max((a["params"][k] - v).abs().max().item()
                                  for k, v in b["params"].items())
        vs_cpu = params(runs["eager"], cpu["dense"])
        # the run's own sensitivity: the same run on the CPU in two summation
        # orders (dense products, the kernels' plain versions)
        orders = params(cpu["dense"], cpu["cuda"])
        per_step = lambda run, k: [r.get(k, 0) for r in run["ran"]]
        mom = {label: per_step(runs[label], "fused_transition")
               for label in ("eager", "graph", "graph2", "eager2")}
        sgd_tr = per_step(runs["sgd_graph"], "fused_transition")
        sgd_runs = {label: sum(per_step(runs[label], "sgd_update"))
                    for label in ("eager", "graph", "graph2", "eager2")}
        problems = []
        if not ge == ee == 0.0:
            problems.append(f"graph vs eager {ge}, eager vs eager {ee} (want 0.0)")
        if any(runs[label]["backend"] != "cuda" for label in runs):
            problems.append(f"backends {[r['backend'] for r in runs.values()]}")
        for label in ("graph", "graph2"):
            if runs[label]["graph"] != (1, 1, OPTIM_STEPS - 1) or not runs[label]["ptrs_fixed"]:
                problems.append(f"{label}: graph (captures, keys, replays) "
                                f"{runs[label]['graph']}, state addresses fixed "
                                f"{runs[label]['ptrs_fixed']}")
        if any(v != sgd_tr for v in mom.values()) or not all(sgd_tr):
            problems.append(f"fused_transition runs a superstep {mom} against SGD's {sgd_tr}")
        if any(sgd_runs.values()) or not sum(per_step(runs["sgd_graph"], "sgd_update")):
            problems.append(f"sgd_update runs under momentum {sgd_runs}")
        if not vs_cpu <= 10 * max(orders, 1e-4):
            problems.append(f"card vs CPU {vs_cpu} (want <= 10x the CPU's two orders' "
                            f"{orders}, or 1e-3)")
        if not all(bool(v.abs().max() > 0) for v in runs["graph"]["state"].values()):
            problems.append("the momentum buffers never moved")
        if problems:
            raise AssertionError(f"optim {OPTIM_ROUND}: " + "; ".join(problems))
        print(f"optim {OPTIM_ROUND} with momentum({LR}) ({OPTIM_STEPS} supersteps a run, turns "
              f"eager, graph, graph, eager under deterministic cuDNN): graph vs eager {ge:.1e}, "
              f"eager vs eager {ee:.1e} (held to 0.0); graph (captures, keys, replays) "
              f"{runs['graph']['graph']}, momentum buffers at fixed addresses; fused_transition "
              f"device runs a superstep {mom['graph']} = SGD's {sgd_tr}; sgd_update device runs "
              f"{json.dumps(sgd_runs)} (SGD's graph run: "
              f"{sum(per_step(runs['sgd_graph'], 'sgd_update'))}); parameters card vs CPU "
              f"max abs {vs_cpu:.3e}, the CPU's dense vs kernels' plain versions "
              f"{orders:.3e} (held to 10x that, or 1e-3: at momentum's effective rate a "
              f"rounding difference grows about 10^3-fold a superstep) [{self.smi}]",
              flush=True)
        return {"graph_vs_eager": ge, "eager_vs_eager": ee, "card_vs_cpu": vs_cpu,
                "cpu_orders": orders,
                "graph": runs["graph"]["graph"], "fused_transition_runs": mom["graph"],
                "sgd_fused_transition_runs": sgd_tr, "sgd_update_runs": sgd_runs}

    def optim_offload(self) -> dict:
        """(b) of the phase: the restart and the buffers' addresses, checked
        around the round scheduler's ``_run`` (after its restart, before and
        after the superstep's body)."""
        torch = self.torch
        from repro_torch.optim import momentum
        from repro_torch.scenarios import build_scenario

        run = build_scenario(OFFLOAD, graph=True, optimizer=momentum(LR))
        sched, src = run.runtime.scheduler, run.batch_source()
        ptrs = {k: v.data_ptr() for k, v in sched.opt_state.items()}
        body, seen = sched._run, []

        def checked(stacked):
            zero = all(not bool(v.any()) for v in sched.opt_state.values())
            losses = body(stacked)
            moved = all(bool(v.any()) for v in sched.opt_state.values())
            seen.append((zero, moved))
            return losses

        sched._run = checked
        t0 = time.perf_counter()
        losses = torch.cat([run.runtime.step(src).losses for _ in range(OFFLOAD_STEPS)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        g = sched._graph
        fixed = {k: v.data_ptr() for k, v in sched.opt_state.items()} == ptrs
        if not (seen == [(True, True)] * OFFLOAD_STEPS and fixed
                and (g.captured, len(g._entries), g.replays) == (1, 1, OFFLOAD_STEPS - 1)
                and bool(torch.isfinite(losses).all())):
            raise AssertionError(f"optim {OFFLOAD}: (zero before, moved after) a superstep "
                                 f"{seen}, addresses fixed {fixed}, graph {g.captured} "
                                 f"captures, {len(g._entries)} keys, {g.replays} replays")
        self.check_finite(sched.store.cluster_models, f"optim {OFFLOAD}")
        print(f"optim {OFFLOAD} (10^6 clients, k_max {sched.store.k_max}) with momentum({LR}) "
              f"on its graph: the state zero before each of {OFFLOAD_STEPS} supersteps' body "
              f"and moved after it, at fixed addresses; 1 capture, {g.replays} replays; cluster "
              f"models finite; {OFFLOAD_STEPS / dt:.3f} supersteps/s cold [{self.smi}]",
              flush=True)
        return {"restarts": len(seen), "supersteps_per_s_cold": OFFLOAD_STEPS / dt}

    def optim_width(self) -> dict:
        """(c) of the phase."""
        import dataclasses
        import gc

        import numpy as np

        torch = self.torch
        from torch.utils._pytree import tree_leaves

        from repro_torch.configs import get_config
        from repro_torch.core import FLSpec, build_fl_round_step, resolve_backend
        from repro_torch.core.local_update import per_client_update
        from repro_torch.kernels import device_launches
        from repro_torch.models import CausalLM
        from repro_torch.optim import adam, momentum, sgd

        ow = LM_WIDTH["arch_overrides"]
        cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                                  vocab_size=LM_WIDTH["vocab_size"], **ow)
        model = CausalLM(cfg)
        c, d = OPTIM_WIDTH["clients"], OPTIM_WIDTH["clusters"]
        s, b = LM_WIDTH["seq_len"], LM_WIDTH["batch_size"]
        fl = FLSpec(c, d, tau1=1, tau2=1, alpha=1, learning_rate=LR)
        proto = fl.protocol()
        backend = resolve_backend("cuda", proto.clusters, proto.P(), fl.alpha, device=self.dev)
        w0 = model.init(torch.Generator().manual_seed(0))  # one client's leaves, on the host
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, c, b, s + 1))).to(self.dev)
        batch = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
        del toks
        n_params = sum(v.numel() for v in w0.values())
        out, runs = {}, {}
        for label, opt in (("sgd", sgd(LR)), ("momentum", momentum(LR)),
                           ("adam", adam(OPTIM_WIDTH["adam_lr"], state_dtype=torch.bfloat16))):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            before = {k: fn.launches for k, fn in self.lm_counters_view().items()}
            params = {k: v.to(self.dev)[None].expand((c,) + tuple(v.shape)).contiguous()
                      for k, v in w0.items()}
            if label == "adam":
                state = torch.func.vmap(opt.init)(params)
                if any(0 in x.stride() or not x.is_contiguous() for x in tree_leaves(state)):
                    raise AssertionError("optim lm-width: vmap(adam.init) gave a leaf that is "
                                         "not owned contiguous memory")
            else:
                state = opt.init(params)
            step = build_fl_round_step(model, opt, fl, backend=backend)
            params, state, _ = step(params, state, batch)  # warm-up
            (params, state, losses), ran = device_launches(lambda: step(params, state, batch))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(OPTIM_WIDTH["timed"]):
                params, state, losses = step(params, state, batch)
            torch.cuda.synchronize()
            rate = OPTIM_WIDTH["timed"] / (time.perf_counter() - t0)
            host = {k: fn.launches - before[k] for k, fn in self.lm_counters_view().items()}
            self.check_finite(params, f"optim lm-width {label}")
            if not bool(torch.isfinite(losses).all()):
                raise AssertionError(f"optim lm-width {label}: losses {losses.tolist()}")
            leaves = tree_leaves(state)
            if any(not bool(torch.isfinite(x.float()).all()) for x in leaves if x.is_floating_point()):
                raise AssertionError(f"optim lm-width {label}: non-finite state")
            upd = {}
            if leaves:
                # the update alone on the run's tree (the parameters as gradients)
                update = per_client_update(opt)
                start_ev = torch.cuda.Event(enable_timing=True)
                end_ev = torch.cuda.Event(enable_timing=True)
                update(params, params, state)
                torch.cuda.synchronize()
                start_ev.record()
                for _ in range(OPTIM_WIDTH["update_reps"]):
                    update(params, params, state)
                end_ev.record()
                torch.cuda.synchronize()
                nb = lambda ts: sum(x.numel() * x.element_size() for x in ts)
                pb, sb = nb(params.values()), nb(leaves)
                byts = (2 * pb + sb) + (pb + sb)  # read p, g, state; write p, state
                bound_ms, _ = self.bound(byts, 0)
                upd = {"ms": start_ev.elapsed_time(end_ev) / OPTIM_WIDTH["update_reps"],
                       "bound_ms": bound_ms, "bytes": byts}
            peak = torch.cuda.max_memory_allocated() - start
            want = {"flash_attention_fwd.tensor_core": cfg.num_layers,
                    "flash_attention_bwd.tensor_core": cfg.num_layers,
                    "fused_transition": (fl.tau2 + 1) * self.launch_groups(params)}
            got = {k: ran.get(k, 0) for k in want}
            sgd_runs = ran.get("sgd_update", 0)
            if got != want or (sgd_runs == 0) != (label != "sgd"):
                raise AssertionError(f"optim lm-width {label}: device runs {ran}, expected "
                                     f"{want} and sgd_update only under SGD")
            runs[label] = got
            out[label] = {"peak_bytes_above_start": peak, "supersteps_per_s_warm": rate,
                          "device_runs": dict(got, sgd_update=sgd_runs), "host_launches": host,
                          "state_bytes": sum(x.numel() * x.element_size() for x in leaves),
                          "update": upd, "losses": losses.tolist()}
            print(f"optim lm-width {label} (granite-8b widths, {cfg.num_layers} of 36 layers, "
                  f"{cfg.dtype}, S={s}, b={b}; {n_params} params a client x {c} clients, C={c} "
                  f"in D={d}, tau1=tau2=1, cuda backend; state "
                  f"{out[label]['state_bytes'] / 1e9:.2f} GB): peak {peak / 2**30:.2f} GiB "
                  f"above the turn's start; warm {rate:.4f} supersteps/s; device runs a "
                  f"superstep {json.dumps(out[label]['device_runs'])}; params finite"
                  + (f"; the update alone {upd['ms']:.3f} ms against a {upd['bound_ms']:.3f} ms "
                     f"bytes bound ({upd['bytes'] / 1e9:.2f} GB)" if upd else "")
                  + f" [{self.smi}]", flush=True)
            del params, state, step, leaves, losses
        out["device_runs"] = {
            "fused_transition": {label: r["fused_transition"] for label, r in runs.items()},
            "flash_attention": {label: r["flash_attention_fwd.tensor_core"]
                                for label, r in runs.items()},
            "flash_attention_backward": {label: r["flash_attention_bwd.tensor_core"]
                                         for label, r in runs.items()}}
        return out

    def gemma2_width(self):
        """gemma2-2b at its published widths (``GEMMA2_WIDTH``), cut in depth,
        eager (on the round's graph the private pool took 63 GiB and the
        run ran out of memory): host launches held exactly, every flash
        launch on the tensor cores (the backward on the wide hd-256 kernels),
        rates, peak memory, one superstep's kernel runs held exactly and its
        device time by part (the flash backward's apart), one client's loss
        and gradients flash vs plain, and the trees against their plain
        versions."""
        import dataclasses

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.kernels import flash_attention_bwd, flash_attention_fwd
        from repro_torch.models import CausalLM

        w = GEMMA2_WIDTH
        pub = get_config("gemma2-2b")
        cfg = dataclasses.replace(pub, num_layers=w["num_layers"], remat=False)
        run, dt, losses, launches, peak, _ = self.width_lane(
            "gemma2-width", CausalLM(cfg), LM_WIDTH_STEPS, False, num_clients=w["num_clients"],
            num_clusters=w["num_clusters"], seq_len=w["seq_len"], batch_size=w["batch_size"],
            vocab_size=pub.vocab_size, num_samples=16)
        for kname in launches:
            self.record[kname]["gemma2_width_launches"] = launches[kname]
        routes = self.check_routes({"flash_attention": flash_attention_fwd,
                                    "flash_attention_backward": flash_attention_bwd},
                                   {"flash_attention": "tensor_core",
                                    "flash_attention_backward": "tensor_core"}, "gemma2-width")
        sched = run.runtime.scheduler
        c, b, s = sched.fl.num_clients, run.batch_size, w["seq_len"]
        iters = LM_WIDTH_STEPS * sched.iterations_per_step
        wiph = sched.iterations_per_step * self.warm_rate(run, 1)
        split = self.width_split(run)
        windows = [cfg.window_for_layer(i) for i in range(cfg.num_layers)]
        n_params = sum(w_[0].numel() for w_ in sched.params.values())
        print(f"gemma2-width federated-lm-ring at gemma2-2b's published widths, eager "
              f"(graph=False; peak {peak / 2**30:.2f} GiB): d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads} heads of {cfg.head_dim}, windows by layer {windows} (4096 "
              f"passes S = {s}: both layers attend causally in full), attention cap "
              f"{cfg.attn_logit_softcap}, final cap {cfg.final_logit_softcap}, post-norms "
              f"{cfg.use_post_norm}, vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}, "
              f"{cfg.dtype}; cuts: depth {pub.num_layers} -> {cfg.num_layers}, C={c} in "
              f"D={sched.fl.num_clusters}, S={s}, b={b}, no evaluate; {n_params} params per "
              f"client; {iters} iterations in {dt:.3f}s = {iters / dt:.4f} it/s, "
              f"{iters * c * b * s / dt:.1f} tokens/s cold; warm {wiph:.4f} it/s, "
              f"{wiph * c * b * s:.1f} tokens/s; launches {json.dumps(launches)}, flash "
              f"routes {json.dumps(routes)}; device split of a warm superstep "
              f"{json.dumps(split)}; losses {[round(x, 4) for x in losses.tolist()]}",
              flush=True)
        held = self.hold_client_grads(run, "gemma2-width")
        trees = self.hold_mixed_trees(run, "gemma2-width")
        self.detail["gemma2_width"] = {
            "launches": launches, "params_per_client": n_params, "peak_bytes": peak,
            "it_per_s_cold": iters / dt, "it_per_s_warm": wiph,
            "tokens_per_s_cold": iters * c * b * s / dt, "tokens_per_s_warm": wiph * c * b * s,
            "flash_routes": routes, "split": split, "losses": losses.tolist(),
            "windows": windows, "cuda_vs_plain": held, "trees": trees, "graph": False,
            "cuts": {"num_layers": [pub.num_layers, cfg.num_layers], "remat": [pub.remat, False],
                     "clients": c, "clusters": sched.fl.num_clusters, "seq_len": s,
                     "batch_size": b, "evaluate": False}}
        del run, sched
        torch.cuda.empty_cache()

    def ssm_width(self):
        """mamba2-780m at its published widths (``SSM_WIDTH``), eager, C = 8
        in D = 4, S = 2048: first an A/B at 4 layers in one process, remat
        off (the lane as it ran without remat: rates, the split by kernel name, the
        SSD core timed alone, the mixed trees against their plain versions)
        against remat on (peak memory and it/s), with one client's gradients
        remat on against off on the same state and batch; then remat on at
        the deepest of ``SSM_DEPTHS`` that fits (a depth that runs out of
        memory is recorded and the next tried; at least 12 layers must
        run).  No flash launch; the mixed SGD and transition launches held
        exactly, finite losses."""
        import dataclasses
        import gc

        torch = self.torch
        from repro_torch.configs import get_config

        pub = get_config("mamba2-780m")
        ab_layers = SSM_WIDTH["num_layers"]
        out = {"ab": {}}
        for remat in (False, True):
            cfg = dataclasses.replace(pub, num_layers=ab_layers, remat=remat)
            res, run = self.ssm_run(cfg, pub, full=not remat)
            out["ab"]["remat_on" if remat else "remat_off"] = res
            if not remat:
                p0 = {k: w[0].clone() for k, w in run.runtime.scheduler.params.items()}
                batch = {k: torch.as_tensor(v[0], device=self.dev)
                         for k, v in run.batch_source()(0).items()}
            del run
            gc.collect()
            torch.cuda.empty_cache()
        out["ab"]["grads"] = self.remat_grads(pub, ab_layers, p0, batch)
        del p0, batch
        off, on = out["ab"]["remat_off"], out["ab"]["remat_on"]
        print(f"ssm-width A/B at {ab_layers} layers, one process: remat off peak "
              f"{off['peak_bytes'] / 2**30:.2f} GiB, warm {off['it_per_s_warm']:.4f} it/s; remat "
              f"on peak {on['peak_bytes'] / 2**30:.2f} GiB, warm {on['it_per_s_warm']:.4f} it/s "
              f"({on['it_per_s_warm'] / off['it_per_s_warm']:.3f}x); gradients "
              f"{json.dumps(out['ab']['grads'])}", flush=True)
        out["deep"], out["refused_depths"] = None, []
        for depth in SSM_DEPTHS:
            cfg = dataclasses.replace(pub, num_layers=depth, remat=True)
            try:
                res, run = self.ssm_run(cfg, pub, full=False)
            except torch.cuda.OutOfMemoryError as err:
                out["refused_depths"].append({"num_layers": depth, "error": str(err)[:200]})
                print(f"ssm-width remat on at {depth} layers ran out of memory; next depth",
                      flush=True)
                gc.collect()
                torch.cuda.empty_cache()
                continue
            out["deep"] = res
            del run
            break
        gc.collect()
        torch.cuda.empty_cache()
        if out["deep"] is None or out["deep"]["cuts"]["num_layers"][1] < 12:
            raise AssertionError(f"ssm-width: remat on reached no depth of 12 layers or more "
                                 f"({out['refused_depths']})")
        for kname in ("sgd_update", "fused_transition"):
            self.record[kname]["ssm_width_launches"] = off["launches"][kname]
        self.detail["ssm_width"] = out

    def ssm_run(self, cfg, pub, full):
        """One ``ssm-width`` run of ``SSM_STEPS`` supersteps (the first cold,
        the rest timed warm): its record and the run; ``full`` adds the split
        by kernel name, the SSD core's times and the mixed trees."""
        w = SSM_WIDTH
        from repro_torch.models import CausalLM

        run, dt, losses, launches, peak, _ = self.width_lane(
            "ssm-width", CausalLM(cfg), 1, False, num_clients=w["num_clients"],
            num_clusters=w["num_clusters"], seq_len=w["seq_len"], batch_size=w["batch_size"],
            vocab_size=pub.vocab_size, num_samples=16)
        if launches["flash_attention"] or launches["fused_transition"] == 0:
            raise AssertionError(f"ssm-width launches {launches}")
        sched = run.runtime.scheduler
        c, b, s = sched.fl.num_clients, run.batch_size, w["seq_len"]
        wiph = sched.iterations_per_step * self.warm_rate(run, SSM_STEPS - 1)
        peak = max(peak, self.torch.cuda.max_memory_allocated())
        n_params = sum(w_[0].numel() for w_ in sched.params.values())
        res = {"launches": launches, "params_per_client": n_params, "peak_bytes": peak,
               "it_per_s_cold": sched.iterations_per_step / dt, "it_per_s_warm": wiph,
               "tokens_per_s_warm": wiph * c * b * s, "losses": losses.tolist(),
               "graph": False,
               "cuts": {"num_layers": [pub.num_layers, cfg.num_layers], "remat": [True, cfg.remat],
                        "clients": c, "clusters": sched.fl.num_clusters, "seq_len": s,
                        "batch_size": b, "evaluate": False}}
        if full:
            split = self.width_split(run)
            per_layer = self.ssd_ms(run, cfg)
            split.update({k: v * cfg.num_layers * sched.iterations_per_step
                          for k, v in per_layer.items()})
            res["split"] = split
            res["trees"] = self.hold_mixed_trees(run, "ssm-width")
        print(f"ssm-width federated-lm-ring at mamba2-780m's published widths, eager, remat "
              f"{'on' if cfg.remat else 'off'} (peak {peak / 2**30:.2f} GiB): d_model "
              f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSD heads of "
              f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv {cfg.ssm_conv}, chunk "
              f"{cfg.ssm_chunk}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}), tied, "
              f"{cfg.dtype}; cuts: depth {pub.num_layers} -> {cfg.num_layers}, C={c} in "
              f"D={sched.fl.num_clusters}, S={s}, b={b}, no evaluate; {n_params} params per "
              f"client; cold {res['it_per_s_cold']:.4f} it/s, warm {wiph:.4f} it/s, "
              f"{wiph * c * b * s:.1f} tokens/s; launches {json.dumps(launches)}"
              + (f"; device split of a warm superstep {json.dumps(res['split'])}" if full
                 else "") + f"; losses {[round(x, 4) for x in losses.tolist()]}", flush=True)
        return res, run

    def remat_grads(self, pub, layers, p0, batch) -> dict:
        """One client's loss and gradients with remat on against off, at the
        same state and batch, eager: in f32 (the state cast up; TF32 off)
        held bitwise or within 1e-6 in relative norm a leaf, and in the run's
        bf16 reported (the recomputing backward takes the same formulas as
        the whole model's, so bitwise is expected in both)."""
        import dataclasses

        torch = self.torch
        from repro_torch.models import CausalLM

        out = {}
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(pub, num_layers=layers, dtype=dtype)
            p = {k: (v.float() if dtype == "float32" else v) for k, v in p0.items()}
            got = {}
            for remat in (False, True):
                model = CausalLM(dataclasses.replace(cfg, remat=remat))
                g, l = torch.func.grad_and_value(model.loss)(p, batch)
                got[remat] = (l.item(), g)
            ref = got[False][1]
            bitwise = got[True][0] == got[False][0] and all(
                torch.equal(g, ref[k]) for k, g in got[True][1].items())
            norm = {k: ((g.float() - ref[k].float()).norm()
                        / ref[k].float().norm().clamp_min(1e-30)).item()
                    for k, g in got[True][1].items()}
            peak = {k: ((g.float() - ref[k].float()).abs().max()
                        / ref[k].float().abs().max().clamp_min(1e-30)).item()
                    for k, g in got[True][1].items()}
            out[dtype] = {"bitwise": bitwise, "loss_diff": abs(got[True][0] - got[False][0]),
                          "max_rel_norm": max(norm.values()), "max_rel_peak": max(peak.values()),
                          "furthest": sorted(norm.items(), key=lambda r: -r[1])[:3]}
            del got, p
            torch.cuda.empty_cache()
        f32 = out["float32"]
        if not (f32["bitwise"] or f32["max_rel_norm"] <= 1e-6):
            raise AssertionError(f"ssm-width remat on vs off in f32: {f32}")
        return out

    # -- serving ---------------------------------------------------------------
    def serve(self):
        """The serving slice at reduced sizes (f32): both serving scenarios
        through ``launch.serve.serve_scenario`` on the card (training on the
        round's graph, then the federated servers) held token for token,
        with ``ServeStats``' counts, against the same calls on the CPU; the
        LM kernels' counters zeroed before each card call and each kernel of
        the path (flash forward, SGD, transition) required to launch; then
        a mid-stream hot swap, the chunk graph's one capture and its replay
        against the eager chunk, and ``generate`` on the reduced families."""
        torch = self.torch
        from repro_torch.launch.serve import serve_scenario

        out = {}
        for name, continuous in (("federated-lm-serving", False),
                                 ("lm-serving-continuous", True)):
            kw = dict(train_steps=SERVE_STEPS, requests=SERVE_REQUESTS, gen=SERVE_GEN,
                      continuous=continuous)
            counters = self.lm_counters()
            t0 = time.perf_counter()
            srv, done, _ = serve_scenario(name, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            if not all(launches[k] for k in ("flash_attention", "sgd_update",
                                             "fused_transition")):
                raise AssertionError(f"serve {name}: launches {launches}")
            cpu, cpu_done, _ = serve_scenario(name, device="cpu", **kw)
            toks = {r.uid: r.output.tolist() for r in done}
            ref = {r.uid: r.output.tolist() for r in cpu_done}
            stats = {f: getattr(srv.stats, f) for f in SERVE_STATS}
            ref_stats = {f: getattr(cpu.stats, f) for f in SERVE_STATS}
            if toks != ref or stats != ref_stats:
                raise AssertionError(f"serve {name}: cuda and cpu differ: tokens equal "
                                     f"{toks == ref}, stats {stats} vs {ref_stats}")
            counts = srv.compile_counts() if continuous else None
            if continuous and (counts["decode"] != 1 or srv._chunk_p.graphed is None
                               or srv._chunk_p.graphed.replays < 1):
                raise AssertionError(f"serve {name}: decode programs {counts}")
            out[name] = {"seconds": dt, "launches": launches, "stats": stats,
                         "tokens": sum(len(t) for t in toks.values()),
                         "compile_counts": counts}
            print(f"serve {name} ({'continuous' if continuous else 'static'}) on cuda: "
                  f"{SERVE_STEPS} supersteps then {SERVE_REQUESTS} requests in {dt:.2f}s "
                  f"(training included); token for token the CPU's, counts {json.dumps(stats)}; "
                  f"launches {json.dumps(launches)}; programs {counts}", flush=True)
            del srv, cpu
        out["hot_swap"] = self.serve_hot_swap()
        out["families"] = self.serve_families()
        self.detail["serve"] = out

    def serve_hot_swap(self) -> dict:
        """``lm-serving-continuous`` trained on the card, its clusters' models
        published mid-stream after one more superstep: the in-flight requests'
        tokens are a no-swap server's, the later ones a fresh server's on the
        published weights; the chunk graph, captured once across mixed
        buckets, admissions and the swap, replays equal to the eager chunk at
        0.0 (under deterministic algorithms, from a snapshot of the pool)."""
        import dataclasses

        torch = self.torch
        from repro_torch.scenarios import build_scenario
        from repro_torch.serving import ContinuousFederatedServer, synthetic_trace

        with self.deterministic() as refused:
            run = build_scenario("lm-serving-continuous")
            run.run(SERVE_STEPS)
            old_stack = run.runtime.cluster_params()
            run.run(1)
            new_stack = run.runtime.cluster_params()
            trace = synthetic_trace(run.dataset, num_requests=SERVE_REQUESTS, prompt_lens=(8, 16),
                                    max_new_tokens=(1, SERVE_GEN), seed=1)
            first = [dataclasses.replace(r, max_new_tokens=SERVE_GEN, eos_id=None)
                     for r in trace[:4]]
            later = trace[4:]
            kw = dict(length_buckets=(16, 32, 64), gen_cap=SERVE_GEN, chunk_steps=4)
            model = run.runtime.model

            def serve(stack, reqs):
                srv = ContinuousFederatedServer(model, stack, **kw)
                reqs = [dataclasses.replace(r, output=None) for r in reqs]
                for r in reqs:
                    srv.submit(r)
                srv.run()
                return {r.uid: r.output.tolist() for r in reqs}

            srv = ContinuousFederatedServer(model, old_stack, **kw)
            inflight = [dataclasses.replace(r, output=None) for r in first]
            fresh = [dataclasses.replace(r, output=None) for r in later]
            for r in inflight:
                srv.submit(r)
            srv.step()
            srv.step()  # the chunk's warm-up, then its capture and first replay
            srv.publish(new_stack)
            for r in fresh:
                srv.submit(r)
            srv.run()
            got_old = {r.uid: r.output.tolist() for r in inflight}
            got_new = {r.uid: r.output.tolist() for r in fresh}
            if got_old != serve(old_stack, first) or got_new != serve(new_stack, later):
                raise AssertionError("serve hot swap: tokens differ from the no-swap and "
                                     "fresh servers'")
            chunk = srv._chunk_p
            if (srv.swaps != 1 or chunk.graphed.captured != 1 or srv.compile_counts()["decode"]
                    != 1):
                raise AssertionError(f"serve hot swap: swaps {srv.swaps}, captures "
                                     f"{chunk.graphed.captured}")
            # replay against the eager chunk from one snapshot of a live pool
            for r in [dataclasses.replace(r, output=None) for r in trace[:8]]:
                srv.submit(r)
            srv._admit_available()
            diff = self.chunk_graph_vs_eager(srv)
            replays = chunk.graphed.replays
        print(f"serve hot swap (lm-serving-continuous on cuda): {len(first)} in-flight "
              f"requests kept their tokens, {len(later)} later ones match a fresh server on "
              f"the published weights; one chunk graph ({replays} replays) across buckets, "
              f"admissions and the swap; replay vs eager chunk max abs diff {diff} (held to "
              f"0.0); ops without a deterministic implementation: {refused}", flush=True)
        return {"inflight": len(first), "later": len(later), "captures": 1,
                "replays": replays, "graph_vs_eager": diff, "nondeterministic_ops": refused}

    def chunk_graph_vs_eager(self, srv) -> float:
        """One decode chunk replayed from the server's graph and one run
        eagerly, from the same snapshot of the pool: their largest
        difference over every state tensor, held to 0.0; the pool is left
        as the replay left it."""
        torch = self.torch
        state, weights = srv._state, srv._weights()

        def leaves():
            return [v for k, v in state.items() if k != "cache"] + list(
                state["cache"].values())

        snap = [t.clone() for t in leaves()]
        srv._chunk_p(weights, state)
        replayed = [t.clone() for t in leaves()]
        for t, s in zip(leaves(), snap):
            t.copy_(s)
        srv._chunk_p.eager(weights, state)
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(leaves(), replayed))
        for t, r in zip(leaves(), replayed):
            t.copy_(r)
        del snap, replayed
        torch.cuda.synchronize()
        if diff != 0.0:
            raise AssertionError(f"chunk graph vs eager: {diff}")
        return diff

    def serve_families(self) -> dict:
        """``generate`` on every family's reduced model (f32), card against
        CPU from the same weights and prompts: the prefill's last logits
        within 1e-3 in relative norm, every token in the vocabulary, the
        tokens' agreement reported (a token decided by a near tie may flip
        between the two roundings and change the rest of its sequence)."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import generate
        from repro_torch.models import CausalLM

        out = {}
        for name in SERVE_FAMILIES:
            cfg = get_config(name).reduced()
            model = CausalLM(cfg)
            params = model.init(torch.Generator().manual_seed(0))
            gen = torch.Generator().manual_seed(1)
            shape = ((2, cfg.num_codebooks, 32) if cfg.modality == "audio" else (2, 32))
            prompts = torch.randint(0, cfg.vocab_size, shape, generator=gen)
            dev = {k: v.to(self.dev) for k, v in params.items()}
            with torch.no_grad():
                lc, _ = model.prefill(dev, {"tokens": prompts.to(self.dev)})
                lp, _ = model.prefill(params, {"tokens": prompts})
            rel = ((lc.cpu() - lp).norm() / lp.norm()).item()
            toks = generate(model, dev, prompts.to(self.dev), 8).cpu()
            ref = generate(model, params, prompts, 8)
            if not (rel <= 1e-3 and int(toks.max()) < cfg.vocab_size and int(toks.min()) >= 0):
                raise AssertionError(f"serve families {name}: prefill rel {rel}, tokens "
                                     f"{toks.min().item()}..{toks.max().item()}")
            out[name] = {"prefill_rel": rel, "tokens": toks.numel(),
                         "agree": (toks == ref).float().mean().item(),
                         "shape": list(toks.shape)}
        print(f"serve families (reduced, f32, generate 8 tokens, cuda vs cpu): "
              f"{json.dumps(out)}", flush=True)
        return out

    def random_stack(self, cfg, replicas: int, seed: int = 0) -> dict:
        """``replicas`` random models of ``cfg`` stacked ``(D, ...)``, made on
        the card from a seed: norms 1, the embedding and head N(0, 0.02) and
        N(0, 1/d_in), every other matrix N(0, 1/d_in), as ``CausalLM.init``
        scales them; the leaves' names and shapes from a one-block model."""
        import dataclasses

        torch = self.torch
        from repro_torch.models import CausalLM

        small = dataclasses.replace(cfg, num_layers=cfg.scan_period, vocab_size=256)
        shapes = {k: tuple(v.shape) for k, v in
                  CausalLM(small).init(torch.Generator().manual_seed(0)).items()}
        v, d = cfg.padded_vocab, cfg.d_model
        shapes["embed"] = (v, d)
        if "head" in shapes:
            shapes["head"] = (d, v)
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        out = {}
        for name, shape in shapes.items():
            if name.startswith("blocks."):
                shape = (cfg.num_scan_blocks,) + shape[1:]
            full = (replicas,) + shape
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("ln_") or name == "ln_final":
                out[name] = torch.ones(full, dtype=cfg.param_dtype, device=self.dev)
                continue
            scale = 0.02 if name == "embed" else shape[-2] ** -0.5
            out[name] = torch.randn(full, generator=gen, device=self.dev,
                                    dtype=cfg.param_dtype).mul_(scale)
        return out

    def serve_width(self):
        """granite-8b at its published widths and depth (36 layers, bf16),
        two random replicas made on the card: ``ContinuousFederatedServer``
        (``SERVE_WIDTH``) on a 32-request ``synthetic_trace`` of prompts of
        512, 1024 and 2048 tokens and heavy-tailed budgets on [1, 256], then
        ``FederatedServer`` on the same trace, all in the default mode (not
        deterministic algorithms).  Tokens/s, TTFT p50/p95, ms a decode step
        (CUDA events around every chunk, and a full pool timed alone), the
        span share (CUDA-event spans of prefills and chunks over the wall; a
        span counts the host's gaps inside an eager prefill, so it is no
        device busy share), peak memory, and the flash forward's device
        launches in an eager prefill session; held: graph chunk = eager chunk
        at 0.0 (the eager chunk under deterministic algorithms), the flash
        forward against its plain version at each bucket's prefill shape,
        one request's prefill logits flash against plain attention within
        5e-2 in relative norm, every token in the vocabulary.  No publish: a
        staged copy would double the 33 GB of replicas."""
        import dataclasses
        import gc

        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data import FederatedLM
        from repro_torch.kernels import check_eager_session, device_launches
        from repro_torch.models import CausalLM
        from repro_torch.serving import ContinuousFederatedServer, FederatedServer, synthetic_trace

        w = SERVE_WIDTH
        cfg = get_config("granite-8b")
        model = CausalLM(cfg)
        ds = FederatedLM.generate_clustered(2 * w["replicas"], 2, max(w["prompt_lens"]),
                                            cfg.vocab_size, w["replicas"], seed=0)
        trace = synthetic_trace(ds, num_requests=w["requests"], prompt_lens=w["prompt_lens"],
                                max_new_tokens=(1, w["gen_cap"]), seed=0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = {}
        t0 = time.perf_counter()
        stack = self.random_stack(cfg, w["replicas"])
        n_params = sum(v[0].numel() for v in stack.values())
        srv = ContinuousFederatedServer(
            model, stack, max_batch=w["max_batch"], length_buckets=w["buckets"],
            gen_cap=w["gen_cap"], chunk_steps=w["chunk_steps"])
        del stack
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        # set-up holds the caller's stack and the server's copy at once
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        spans = self.time_programs(srv, ("_prefill_p", "_chunk_p"))
        reqs = [dataclasses.replace(r) for r in trace]
        for r in reqs:
            srv.submit(r)
        t0 = time.perf_counter()
        done = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
        st = srv.stats
        toks = [r.output for r in done]
        if not all(int(t.max()) < cfg.vocab_size and int(t.min()) >= 0 for t in toks):
            raise AssertionError("serve-width: a token outside the vocabulary")
        peak = torch.cuda.max_memory_allocated()  # serving alone, before the holds
        counts = srv.compile_counts()
        if counts["decode"] != 1 or srv._chunk_p.graphed.captured != 1:
            raise AssertionError(f"serve-width: decode programs {counts}")
        chunks = len(spans["_chunk_p"])
        out["continuous"] = {
            "requests": st.requests, "tokens": st.tokens_generated, "wall_s": wall,
            "tokens_per_s": st.tokens_per_s, "ttft_p50_s": st.ttft_p50,
            "ttft_p95_s": st.ttft_p95, "latency_p50_s": st.latency_p50,
            "latency_p95_s": st.latency_p95, "decode_steps": st.decode_steps,
            "chunks": chunks, "mean_occupancy": st.mean_occupancy,
            "prefill_ms": ms["_prefill_p"], "chunk_ms": ms["_chunk_p"],
            "ms_per_decode_step": ms["_chunk_p"] / max(st.decode_steps, 1),
            "ms_per_executed_step": ms["_chunk_p"] / max(chunks * w["chunk_steps"], 1),
            # the chunks after the first two (the graph's eager warm-up and
            # its capture), all replays
            "replay_ms_per_step": sum(a.elapsed_time(b) for a, b in spans["_chunk_p"][2:])
            / max((chunks - 2) * w["chunk_steps"], 1),
            "span_share": (ms["_prefill_p"] + ms["_chunk_p"]) / (wall * 1e3),
            "compile_counts": counts, "setup_s": setup_s}
        for name in ("_prefill_p", "_chunk_p"):
            setattr(srv, name, getattr(srv, name).program)
        out["full_pool"] = self.serve_full_pool(srv, trace)
        with self.deterministic() as refused:
            out["graph_vs_eager"] = self.chunk_graph_vs_eager(srv)
        params0 = {k: v[0] for k, v in srv.active_params.items()}
        long = next(r for r in trace if r.prompt.shape[-1] == max(w["prompt_lens"]))
        toks2k = torch.from_numpy(long.prompt[None].astype(np.int64)).to(self.dev)
        out["prefill"] = self.serve_prefill_holds(cfg, params0, toks2k)
        del params0
        holds_peak = torch.cuda.max_memory_allocated()
        # the static engine on the same trace, from the same replicas
        stack = srv.active_params
        del srv
        gc.collect()
        torch.cuda.empty_cache()
        static = FederatedServer(model, stack, max_batch=w["max_batch"],
                                 length_buckets=w["buckets"])
        del stack
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reqs_s = [dataclasses.replace(r, output=None) for r in trace]
        for r in reqs_s:
            static.submit(r)
        t0 = time.perf_counter()
        static.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        st = static.stats
        same = np.mean([np.array_equal(a.output, b.output) for a, b in
                        zip(sorted(done, key=lambda r: r.uid), reqs_s)])
        out["static"] = {"requests": st.requests, "tokens": st.tokens_generated,
                         "wall_s": wall_s, "tokens_per_s": st.tokens_per_s,
                         "ttft_p50_s": st.ttft_p50, "ttft_p95_s": st.ttft_p95,
                         "decode_steps": st.decode_steps, "batches": st.batches,
                         "mean_occupancy": st.mean_occupancy,
                         "requests_equal_to_continuous": float(same)}
        out["static"]["peak_bytes"] = torch.cuda.max_memory_allocated()
        del static
        gc.collect()
        torch.cuda.empty_cache()
        out.update({"params_per_replica": n_params, "replicas": w["replicas"],
                    "mode": "default (deterministic algorithms only for graph_vs_eager)",
                    "peak_bytes": peak, "setup_peak_bytes": setup_peak,
                    "holds_peak_bytes": holds_peak,
                    "nondeterministic_ops": refused,
                    "config": {"num_layers": cfg.num_layers, "d_model": cfg.d_model,
                               "d_ff": cfg.d_ff, "heads": [cfg.num_heads, cfg.num_kv_heads,
                                                           cfg.head_dim],
                               "vocab": cfg.vocab_size, "dtype": cfg.dtype},
                    **{k: w[k] for k in ("max_batch", "buckets", "gen_cap", "chunk_steps")}})
        c, s_ = out["continuous"], out["static"]
        print(f"serve-width granite-8b at its published widths and depth ({cfg.num_layers} "
              f"layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.num_heads}/"
              f"{cfg.num_kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}, "
              f"{cfg.dtype}), {w['replicas']} random replicas of {n_params} params; "
              f"continuous: {c['requests']} requests, {c['tokens']} tokens in {c['wall_s']:.3f}s "
              f"= {c['tokens_per_s']:.1f} tokens/s, TTFT p50 {c['ttft_p50_s']:.4f}s p95 "
              f"{c['ttft_p95_s']:.4f}s, {c['decode_steps']} decode steps in {c['chunks']} "
              f"chunks, {c['ms_per_decode_step']:.3f} ms a decode step "
              f"({c['ms_per_executed_step']:.3f} an executed one, "
              f"{c['replay_ms_per_step']:.3f} on replays alone), full pool "
              f"{out['full_pool']['ms_per_step']:.3f} ms a step (decode attention "
              f"{out['full_pool']['decode_attention_share']:.3f} of it), span share "
              f"{c['span_share']:.3f}, mean occupancy {c['mean_occupancy']:.3f}, programs "
              f"{c['compile_counts']}; static: {s_['tokens']} tokens in {s_['wall_s']:.3f}s = "
              f"{s_['tokens_per_s']:.1f} tokens/s, TTFT p50 {s_['ttft_p50_s']:.4f}s p95 "
              f"{s_['ttft_p95_s']:.4f}s, {s_['batches']} batches, {s_['decode_steps']} decode "
              f"steps (peak {s_['peak_bytes'] / 2**30:.2f} GiB); peak serving {peak / 2**30:.2f} "
              f"GiB, at set-up {setup_peak / 2**30:.2f} GiB, with the holds "
              f"{holds_peak / 2**30:.2f} GiB; chunk graph vs eager "
              f"{out['graph_vs_eager']}; prefill {json.dumps(out['prefill'])}", flush=True)
        self.record["flash_attention"]["serve_width"] = {
            "device_launches": out["prefill"]["flash_device_launches"],
            "prefill_ms": out["prefill"]["prefill_ms"], "shape": out["prefill"]["flash_shape"],
            "ms": out["prefill"]["flash_ms"], "plain_ms": out["prefill"]["flash_plain_ms"],
            "library_ms": out["prefill"]["flash_library_ms"],
            "bound_ms": out["prefill"]["flash_bound_ms"],
            "bound_by": out["prefill"]["flash_bound_by"],
            "max_abs_err": max(out["prefill"]["flash_max_abs_err"].values()),
            "max_abs_err_by_len": out["prefill"]["flash_max_abs_err"]}
        self.detail["serve_width"] = out

    def time_programs(self, srv, names) -> dict:
        """Wrap the server's slot programs ``names`` so each call is spanned
        by two CUDA events on the current stream (no synchronize); returns
        ``{name: [(start, end), ...]}``.  The wrapper keeps the program as
        ``.program`` and forwards every attribute to it."""
        torch = self.torch
        spans = {n: [] for n in names}

        class Timed:
            def __init__(self, program, log):
                self.program, self._log = program, log

            def __call__(self, *args):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                res = self.program(*args)
                b.record()
                self._log.append((a, b))
                return res

            def __getattr__(self, name):
                return getattr(self.program, name)

        for n in names:
            setattr(srv, n, Timed(getattr(srv, n), spans[n]))
        return spans

    def serve_full_pool(self, srv, trace) -> dict:
        """Every slot admitted at the longest bucket with the whole budget,
        then ``SERVE_FULL_CHUNKS`` chunk replays timed with CUDA events: ms
        a decode step with the pool full."""
        import dataclasses

        torch = self.torch
        w = SERVE_WIDTH
        longest = [r for r in trace if r.prompt.shape[-1] == max(w["prompt_lens"])]
        for i in range(w["max_batch"]):
            srv.submit(dataclasses.replace(longest[i % len(longest)], uid=10_000 + i,
                                           max_new_tokens=w["gen_cap"], eos_id=None,
                                           output=None))
        srv._admit_available()
        weights, state = srv._weights(), srv._state
        srv._chunk_p(weights, state)  # a replay before the timed ones
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(SERVE_FULL_CHUNKS):
            srv._chunk_p(weights, state)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b) / SERVE_FULL_CHUNKS
        active = int((~state["done"]).sum())
        if active != w["max_batch"]:
            raise AssertionError(f"serve-width full pool: {active} slots active")
        # decode attention (plain PyTorch, f32 scores) alone at this pool's
        # shape, once a layer a step, against the step
        from repro_torch.models.layers import decode_attention

        cfg = srv.model.cfg
        k_c, v_c, pos_c = (state["cache"][f"pos0.{n}"][0] for n in ("k", "v", "pos"))
        q = torch.randn((w["max_batch"], cfg.num_heads, cfg.head_dim), device=self.dev,
                        dtype=cfg.act_dtype)
        attn_ms = self.cuda_ms(lambda: decode_attention(q, k_c, v_c, pos_c, state["pos"]),
                               reps=20) * cfg.num_layers
        return {"chunk_ms": ms, "ms_per_step": ms / w["chunk_steps"],
                "slots": w["max_batch"], "cache_len": srv.cache_len,
                "decode_attention_ms_per_step": attn_ms,
                "decode_attention_share": attn_ms / (ms / w["chunk_steps"])}

    def serve_prefill_holds(self, cfg, params, toks) -> dict:
        """One 2048-token request's prefill on cluster 0's replica: its flash
        forward launches counted on the device in an eager profiler session
        (held to one a layer and to the wrappers' host count), the prefill
        timed with CUDA events, its last logits with ``attn_impl="cuda"``
        against ``"plain"`` within 5e-2 in relative norm; then the flash
        forward alone at each bucket's prefill shape (1, S, 32, 8, 128) held
        against its plain version (``check_flash``'s bf16 tolerance), and at
        the request's length timed against the plain version, SDPA and the
        bound."""
        import dataclasses

        torch = self.torch
        from repro_torch.kernels import (
            check_eager_session, device_launches, flash_attention_fwd, flash_attention_fwd_ref,
        )
        from repro_torch.models import CausalLM

        model = CausalLM(cfg)
        batch = {"tokens": toks}
        with torch.no_grad():
            model.prefill(params, batch)  # warm
            before = flash_attention_fwd.launches
            (logits, _), ran = device_launches(lambda: model.prefill(params, batch))
            host = {"flash_attention_fwd": flash_attention_fwd.launches - before}
            check_eager_session({"flash_attention_fwd": ran.get("flash_attention_fwd", 0)},
                                host)
            if ran.get("flash_attention_fwd.tensor_core", 0) != cfg.num_layers:
                raise AssertionError(f"serve-width prefill: flash runs {ran}")
            prefill_ms = self.cuda_ms(lambda: model.prefill(params, batch), reps=3, warmup=1)
            plain = CausalLM(dataclasses.replace(cfg, attn_impl="plain"))
            lp, _ = plain.prefill(params, batch)
        rel = ((logits.float() - lp.float()).norm() / lp.float().norm()).item()
        if not rel <= 5e-2:
            raise AssertionError(f"serve-width prefill logits flash vs plain: {rel}")
        errs = {}
        for blen in SERVE_WIDTH["buckets"]:
            shape = (1, blen, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
            q, k, v, _ = self.flash_inputs(shape, torch.bfloat16)
            out, lse = flash_attention_fwd(q, k, v)
            ref, ref_lse = flash_attention_fwd_ref(q, k, v)
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            if not (err <= 3e-2 and lse_err <= 1e-4):
                raise AssertionError(f"serve-width flash forward at {shape}: max abs err {err} "
                                     f"(tol 3e-2), lse {lse_err} (tol 1e-4)")
            errs[blen] = err
            del out, lse, ref, ref_lse
        s = toks.shape[-1]
        shape = (1, s, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        q, k, v, _ = self.flash_inputs(shape, torch.bfloat16)
        flops, _, byts, _ = self.flash_work(shape + (None,), 2)
        bound, by = self.bound(byts, flops, peak=BF16_FLOPS_PER_S)
        fwd_ms = self.cuda_ms(lambda: flash_attention_fwd(q, k, v), reps=10)
        plain_ms = self.cuda_ms(lambda: flash_attention_fwd_ref(q, k, v), reps=3, warmup=1)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_ms = self.cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
        return {"prefill_ms": prefill_ms, "prompt_len": s, "logits_rel_plain": rel,
                "flash_device_launches": ran.get("flash_attention_fwd.tensor_core", 0),
                "flash_host_launches": host["flash_attention_fwd"],
                "flash_shape": list(shape), "flash_max_abs_err": errs,
                "flash_ms": fwd_ms, "flash_plain_ms": plain_ms,
                "flash_library_ms": lib_ms, "flash_bound_ms": bound, "flash_bound_by": by,
                "prefill_tflop_counted": 2 * cfg.param_count() * s / 1e12}

    # -- the offload phase ---------------------------------------------------
    def offload(self):
        """Host-offloaded client state, driven with every kernel counter set to
        0 just before it and read just after (each of the five fleet kernels
        must have launched): ``million-client-ring`` at 10^6 clients on round
        supersteps, graph against eager in turns (graph = eager at 0.0 under
        deterministic cuDNN, equal kernel runs, one capture a run), then warm
        rates, the host's parts and device busy time; its device memory at 10^6
        against 10^3 clients; the D = 8 transition (``MAXD = 8``) against its
        plain version; the main path's transition copying nothing;
        identity offload against the dense store on the sync path; client mode
        spilled to a temporary directory against cluster mode; and
        ``dropout-participation-async`` with the store against resident state."""
        from repro_torch import kernels

        names = ("fused_transition", "sgd_update", "normalized_update", "cluster_agg",
                 "gossip_mix")
        for k in names:
            getattr(kernels, k).launches = 0
        out = {"maxd8_transition": self.hold_maxd8(),
               "main_transition_copies": self.main_transition_copies()}
        out["million"] = self.offload_ab()
        out["memory"] = self.offload_memory()
        out["identity_sync"] = self.offload_identity()
        out["client_mode"] = self.offload_client()
        out["async"] = self.offload_async()
        host = {k: getattr(kernels, k).launches for k in names}
        if not all(host.values()):
            raise AssertionError(f"offload path: a kernel never launched: {host}")
        print(f"offload path host launches (counters zeroed before it, read after): "
              f"{json.dumps(host)}", flush=True)
        for k, n in host.items():
            self.record.setdefault(k, {})["offload_host_launches"] = n
        self.record.setdefault("fused_transition", {})["offload_maxd8"] = {
            k: out["maxd8_transition"][k]
            for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        out["host_launches"] = host
        self.detail["offload"] = out

    def hold_maxd8(self) -> dict:
        """The transition at million-client-ring's shapes: MnistCNN's 8 f32
        leaves over its 32 slots in D = 8 clusters (the kernel's MAXD = 8
        instantiation), the slots' weights with a pad at 0, the ring of 8,
        alpha 1 (the inter event) and 0 (intra), against the plain version at
        1e-5; then timed (graph replays) against the plain version, per-leaf
        ``torch.matmul`` and the bytes bound."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import ClusterSpec, mixing_matrix, ring
        from repro_torch.kernels import fused_transition_ref, fused_transition_tree
        from repro_torch.models import MnistCNN

        k_max, d = 32, 8
        spec = ClusterSpec.uniform(k_max, d)
        rng = np.random.default_rng(8)
        w = rng.uniform(0.5, 2.0, k_max)
        w[3] = 0.0  # a padding slot
        tot = np.bincount(spec.assignment_array, weights=w, minlength=d)
        f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=self.dev)
        bt = f32(np.ascontiguousarray(spec.B().T))
        vt = f32(spec.B() * (w / tot[spec.assignment_array])[None, :])
        p = f32(mixing_matrix(ring(d), spec.m_tilde()))
        tree = self.stacked_leaves(MnistCNN, torch.float32, seed=8, rows=k_max)
        errs = {}
        for alpha in (1, 0):
            errs[alpha], _ = self.hold_transition_tree(tree, vt, p, bt, alpha, 1e-5,
                                                       "million-client-ring D=8", 1)
        leaves = {k: t.view(k_max, -1) for k, t in tree.items()}
        t_lib = (vt.T @ p @ bt.T).T.contiguous()
        nbytes = sum(t.numel() * 4 for t in leaves.values())
        m_total = sum(t.shape[1] for t in leaves.values())
        bound, by = self.bound(2 * nbytes + 4 * (vt.numel() + p.numel() + bt.numel()),
                               2 * m_total * (2 * k_max * d + d * d))
        times = {
            "ms": self.graph_ms(lambda: fused_transition_tree(tree, vt, p, bt, 1, inplace=True)),
            "plain_ms": self.graph_ms(lambda: [fused_transition_ref(t, vt, p, bt, 1)
                                               for t in leaves.values()]),
            "library_ms": self.graph_ms(lambda: [torch.matmul(t_lib, t)
                                                 for t in leaves.values()]),
        }
        print(f"offload transition at million-client-ring's shapes (MnistCNN, 32 slots, D=8: "
              f"the MAXD=8 instantiation; a pad slot at weight 0): vs the plain version max abs "
              f"err alpha=1 {errs[1]:.3e}, alpha=0 {errs[0]:.3e} (tol 1e-5); graph replays "
              f"{times['ms']:.5f} ms, plain {times['plain_ms']:.5f} ms, per-leaf matmul "
              f"{times['library_ms']:.5f} ms, bound {bound:.5f} ms ({by})", flush=True)
        return {"max_abs_err": max(errs.values()), "errs_by_alpha": errs, **times,
                "bound_ms": bound, "bound_by": by}

    def main_transition_copies(self) -> dict:
        """The main path's backend (``mnist-noniid-ring``) binds its factors
        contiguous, so one inter transition copies nothing: held by the
        caching allocator's count of allocations during the call, 0 static
        and 1 with runtime weights (the product ``B * w``; strided factors
        would add a copy each).  The device records of the same calls are
        printed (no copy kernel among them; ``ROADMAP.md`` §3 says why a
        session may come back empty), and the copy kernels an iteration of
        the main phase's eager profile."""
        torch = self.torch
        from repro_torch.kernels import EmptySessionError, device_kernel_names, fused_transition
        from repro_torch.scenarios import build_scenario

        run = build_scenario("mnist-noniid-ring", tau2=2)
        sched = run.runtime.scheduler
        backend, params = sched.backend, sched.params
        factors = {"_vt": backend._vt, "_bt": backend._bt, "_b": backend._b}
        if not all(t.is_contiguous() for t in factors.values()):
            raise AssertionError(f"strided factors: "
                                 f"{ {k: t.stride() for k, t in factors.items()} }")
        weights = torch.full((C,), 1.0 / G, device=self.dev)
        seen, allocs = {}, {}
        for label, kw, want in (("static", {}, 0), ("weights", {"weights": weights}, 1)):
            backend.transition(params, "inter", **kw)
            torch.cuda.synchronize()
            before = torch.cuda.memory_stats(self.dev)["allocation.all.allocated"]
            backend.transition(params, "inter", **kw)
            allocs[label] = torch.cuda.memory_stats(self.dev)["allocation.all.allocated"] - before
            if allocs[label] != want:
                raise AssertionError(f"main transition ({label}): {allocs[label]} allocations, "
                                     f"expected {want}")
            n = fused_transition.launches
            try:
                _, names = device_kernel_names(lambda: backend.transition(params, "inter", **kw))
            except EmptySessionError as lost:  # reported; the hold is the allocator's
                names = [f"(session lost its device records: {lost.host_launches})"]
            seen[label] = {"host_launches": fused_transition.launches - n,
                           "device_records": sorted(names)}
            if any("copy" in name.lower() for name in names):
                raise AssertionError(f"main transition ({label}) ran {names}")
        per_it = {}
        try:
            main = self.detail["main_path"]["eager_vs_graph"]["eager"][0]["profile"]
            per_it = {n[:120]: c / main["iters"] for n, c in main["kernel_counts"].items()
                      if "copy" in n.lower()}
        except (KeyError, IndexError):
            pass
        print(f"offload: main's transition factors contiguous; one inter transition allocates "
              f"{allocs['static']} tensors static and {allocs['weights']} weighted (held to 0 and "
              f"1: no copy); its device records "
              + "; ".join(f"{k}: {v['host_launches']} host launch, "
                          f"{[n[:60] for n in v['device_records']]}" for k, v in seen.items())
              + f"; the main phase's eager profile, copy kernels an iteration: "
              f"{json.dumps(per_it)}", flush=True)
        return {"allocations": allocs, "records": seen, "main_copy_kernels_per_iteration": per_it}

    def offload_run(self, graph, steps, **overrides):
        """(run, {"params": cluster models, "losses"}, kernel runs on the
        device, host launches, host seconds) of ``steps`` supersteps of
        million-client-ring, under the profiler."""
        torch = self.torch
        from repro_torch.kernels import device_launches
        from repro_torch.scenarios import build_scenario

        before = self.host_counts()
        run = build_scenario(OFFLOAD, graph=graph, **overrides)
        src = run.batch_source()
        t0 = time.perf_counter()
        evs, ran = device_launches(lambda: [run.runtime.step(src) for _ in range(steps)])
        dt = time.perf_counter() - t0
        host = {k: n - before[k] for k, n in self.host_counts().items() if n != before[k]}
        store = run.runtime.scheduler.store
        vals = {"params": {k: v.float().cpu() for k, v in store.cluster_models.items()},
                "losses": torch.cat([e.losses for e in evs]).float().cpu()}
        return run, vals, ran, host, dt

    def offload_ab(self) -> dict:
        """million-client-ring at 10^6 clients: eager, graph, graph, eager
        under deterministic cuDNN, each ``OFFLOAD_STEPS`` supersteps under the
        profiler; every run's kernel runs on the device held to the exact
        count, its host launches to its warm-up and capture (graph), the
        graph captured once and replayed every later superstep whoever is
        resident, graph = eager at 0.0.  Then, under cuDNN's defaults, warm
        rates of an eager and a graph run, their busy time, the host's parts
        and the peak memory."""
        import gc

        torch = self.torch
        vals, runs = {}, {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for label, graph in (("eager", False), ("graph", True), ("graph2", True),
                                 ("eager2", False)):
                gc.collect()
                run, vals[label], ran, host, dt = self.offload_run(graph, OFFLOAD_STEPS)
                sched = run.runtime.scheduler
                if (sched.backend.name, run.runtime.device.type) != ("cuda", "cuda"):
                    raise AssertionError(f"{OFFLOAD}: {sched.backend.name} on "
                                         f"{run.runtime.device}")
                if sched.store.num_clients != 1_000_000 or sched.store.k_max != 32:
                    raise AssertionError(f"{OFFLOAD}: {sched.store.num_clients} clients, "
                                         f"k_max {sched.store.k_max}")
                want = self.round_launches(sched, OFFLOAD_STEPS)
                host_want = self.round_launches(sched, OFFLOAD_STEPS, host=True)
                if ran != want or host != host_want:
                    raise AssertionError(f"{OFFLOAD} {label}: kernel runs {ran} (expected "
                                         f"{want}), host launches {host} (expected {host_want})")
                residents = {tuple(sched._residency_for_step(k).clients)
                             for k in range(1, OFFLOAD_STEPS + 1)}
                if len(residents) != OFFLOAD_STEPS:
                    raise AssertionError(f"{OFFLOAD}: residents repeat across supersteps")
                g = sched._graph
                if graph and not (g.captured == 1 and len(g._entries) == 1
                                  and g.replays == OFFLOAD_STEPS - 1):
                    raise AssertionError(f"{OFFLOAD} {label}: {g.captured} captures, "
                                         f"{len(g._entries)} keys, {g.replays} replays")
                self.check_finite(sched.store.cluster_models, f"{OFFLOAD} {label}")
                runs[label] = {"kernel_runs": ran, "host_launches": host,
                               "supersteps_per_s_cold": OFFLOAD_STEPS / dt}
                del run, sched, g
        finally:
            torch.backends.cudnn.deterministic = deterministic

        def diff(a, b):
            return max(max((a["params"][k] - v).abs().max().item()
                           for k, v in b["params"].items()),
                       (a["losses"] - b["losses"]).abs().max().item())

        ee = diff(vals["eager"], vals["eager2"])
        ge = max(diff(vals[g], vals[e]) for g in ("graph", "graph2") for e in ("eager", "eager2"))
        if not ge == ee == 0.0:
            raise AssertionError(f"{OFFLOAD}: graph vs eager {ge}, eager vs eager {ee} "
                                 f"(want 0.0)")
        from repro_torch.scenarios import build_scenario

        warm, busy, peaks = {}, {}, {}
        for label, graph in (("eager", False), ("graph", True), ("eager2", False),
                             ("graph2", True)):
            gc.collect()
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run = build_scenario(OFFLOAD, graph=graph)
            src = run.batch_source()
            for _ in range(OFFLOAD_STEPS):
                run.runtime.step(src)
            warm[label] = self.warm_rate(run, OFFLOAD_WARM)
            prof = self.profile_steps(run, FLEET_PROFILED)
            busy[label] = {k: prof[k] for k in ("busy_ms_per_step", "busy_share",
                                                "kernel_launches_per_step",
                                                "copy_launches_per_step")}
            peaks[label] = (torch.cuda.max_memory_allocated() - start) / 2**20
            if label == "graph2":
                split = self.offload_host_split(run)
            del run, src
        ips = 2  # tau1 * tau2 iterations a superstep, R = 1
        print(f"offload {OFFLOAD} (10^6 clients, k_max 32, D=8, uniform-k k=4; "
              f"{OFFLOAD_STEPS} supersteps a run): cuDNN deterministic, graph vs eager max abs "
              f"diff {ge:.1e}, eager vs eager {ee:.1e} (held to 0.0); kernel runs on the device "
              f"eager {json.dumps(runs['eager']['kernel_runs'])}, graph "
              f"{json.dumps(runs['graph']['kernel_runs'])} (held equal, exactly); host launches "
              f"graph {json.dumps(runs['graph']['host_launches'])} (warm-up and capture: one "
              f"capture a run, replayed for every residency); warm over {OFFLOAD_WARM} "
              f"supersteps, cuDNN defaults: "
              + ", ".join(f"{k} {v:.3f} supersteps/s ({ips * v:.3f} it/s)"
                          for k, v in warm.items())
              + f" (graph/eager {(warm['graph'] + warm['graph2']) / (warm['eager'] + warm['eager2']):.3f}x); "
              + "; ".join(f"{k} busy {b['busy_ms_per_step']:.4f} ms a superstep, "
                          f"{100 * b['busy_share']:.2f}% busy, "
                          f"{b['kernel_launches_per_step']:.2f} kernel and "
                          f"{b['copy_launches_per_step']:.2f} copy launches"
                          for k, b in busy.items())
              + "; peak MiB above the run's start: "
              + ", ".join(f"{k} {v:.3f}" for k, v in peaks.items()), flush=True)
        print(f"offload {OFFLOAD} host ms a superstep (graph run, {OFFLOAD_HOST_STEPS} "
              f"supersteps): " + ", ".join(f"{k}={v:.4f}" for k, v in split.items()),
              flush=True)
        return {**runs, "graph_vs_eager": ge, "eager_vs_eager": ee,
                "supersteps_per_s_warm": warm, "busy": busy, "peak_mib": peaks,
                "host_ms_per_superstep": split}

    def offload_host_split(self, run) -> dict:
        """Host milliseconds a superstep of each part of an offloaded step,
        called as the round scheduler calls them, over supersteps past the
        run's: the residency plan (the uniform-k draw over 10^6 clients and
        the slot packing), the slots' weights (the round's renormalized
        weights over 10^6, sliced), the batch draw (32 procedural generators an
        iteration), staging (pinning and queueing the copies), gather and
        scatter (queueing the device takes), and a replay."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.pipeline import CopyStream, stack_window
        from repro_torch.core.runtime import WEIGHTS, _participant_batches
        from repro_torch.state import sub_weights

        sched, src = run.runtime.scheduler, run.batch_source()
        store, n = sched.store, OFFLOAD_HOST_STEPS
        ks = range(1000, 1000 + n)
        part = {}
        t0 = time.perf_counter()
        res = [sched._draw_residency(k) for k in ks]
        part["residency_ms"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        weights = [sub_weights(sched.axes.plan.weights(k - 1), r)[None].astype(np.float32)
                   for k, r in zip(ks, res)]  # (R, k_max) at R = 1
        part["weights_ms"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        windows = [stack_window(lambda i, r=r: _participant_batches(src, i, r), 2 * k - 1, 2)
                   for k, r in zip(ks, res)]
        part["draw_ms"] = time.perf_counter() - t0
        copy = CopyStream(self.dev)
        staged = []
        t0 = time.perf_counter()
        for wdw, w in zip(windows, weights):
            staged.append(copy.stage({**wdw, WEIGHTS: w}))
        part["stage_ms"] = time.perf_counter() - t0
        for st in staged:
            copy.take(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in res:
            store.gather(r)
        part["gather_ms"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in res:
            store.scatter(r, store.buffer)
        part["scatter_ms"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        entry = next(iter(sched._graph._entries.values()))
        t0 = time.perf_counter()
        for _ in ks:
            entry.graph.replay()
        part["replay_ms"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        return {k: v / n * 1e3 for k, v in part.items()}

    def offload_memory(self) -> dict:
        """Peak device memory above a run's start (allocated), the CUDA graph's
        pool included, over ``OFFLOAD_STEPS`` graph supersteps at 10^3 and then
        10^6 clients: within 10% of each other (the reference's claim,
        ``benchmarks/state_scaling.py``)."""
        import gc

        torch = self.torch
        from repro_torch.scenarios import build_scenario

        peaks = []
        for n in (OFFLOAD_SMALL, 1_000_000):
            gc.collect()
            torch.cuda.synchronize()
            start = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run = build_scenario(OFFLOAD, num_clients=n)
            src = run.batch_source()
            for _ in range(OFFLOAD_STEPS):
                run.runtime.step(src)
            torch.cuda.synchronize()
            peaks.append((n, (torch.cuda.max_memory_allocated() - start) / 2**20,
                          run.runtime.scheduler.store.device_bytes()))
            del run, src
        small = [p for n, p, _ in peaks if n == OFFLOAD_SMALL]
        big = [p for n, p, _ in peaks if n != OFFLOAD_SMALL]
        ratio = max(big + small) / min(big + small)
        print(f"offload memory: peak MiB above the run's start, graph, {OFFLOAD_STEPS} "
              f"supersteps: "
              + ", ".join(f"N={n} {p:.3f}" for n, p, _ in peaks)
              + f"; max/min {ratio:.4f} (held to 1.10); the store's persistent device bytes "
              f"{peaks[0][2]} (32 slots + 8 cluster models)", flush=True)
        if not ratio <= 1.10:
            raise AssertionError(f"offload memory at 10^6 vs 10^3 clients: ratio {ratio}")
        if len({b for _, _, b in peaks}) != 1:
            raise AssertionError(f"store bytes depend on N: {peaks}")
        return {"peaks_mib": peaks, "ratio": ratio}

    def offload_identity(self) -> dict:
        """Identity offload (``k_max = N = 20``) against the dense store on the
        sync path: mnist-noniid-ring, ``tau2=2``, ``SYNC_ITERS`` iterations on
        graphs under deterministic cuDNN, every client's state at 0.0."""
        import numpy as np

        torch = self.torch
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            runs = [self.run_scenario("mnist-noniid-ring", SYNC_ITERS, tau2=2, store=store)[0]
                    for store in (None, {"kind": "host-offload"})]
        finally:
            torch.backends.cudnn.deterministic = deterministic
        dense, off = (r.runtime.scheduler for r in runs)
        if off.store.k_max != C or off._graphs is None:
            raise AssertionError(f"identity store k_max {off.store.k_max}, graphs {off._graphs}")
        names = sorted(dense.params)
        err = max(float(np.abs(dense.params[k][c].cpu().numpy() - x).max())
                  for c in range(C) for k, x in zip(names, off.store.state_of(c)))
        if err != 0.0:
            raise AssertionError(f"identity offload vs dense store: {err}")
        print(f"offload identity store (k_max = N = {C}) vs the dense store, sync "
              f"mnist-noniid-ring tau2=2, {SYNC_ITERS} iterations on graphs, cuDNN "
              f"deterministic: max abs client diff {err} (held to 0.0)", flush=True)
        return {"max_abs_client_diff": err}

    def offload_client(self) -> dict:
        """Client mode at 10^6 clients with its rows spilled to a temporary
        directory, 3 graph supersteps: the stored clients are exactly the
        supersteps' participants, each record a file, and (no client drawn
        twice, each cold one starting from its cluster model) the run equals
        cluster mode's at 0.0 under deterministic cuDNN."""
        import os
        import tempfile

        torch = self.torch
        steps = 3
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            with tempfile.TemporaryDirectory() as spill:
                store = {"kind": "host-offload", "k_max": 32, "mode": "client",
                         "spill_dir": spill}
                run, vals, ran, _, dt = self.offload_run(True, steps, store=store)
                sched = run.runtime.scheduler
                drawn = set()
                for k in range(1, steps + 1):
                    res = sched._residency_for_step(k)
                    drawn |= set(res.clients[res.valid].tolist())
                keys = sched.store._host.keys()
                files = len(os.listdir(spill))
                if keys != sorted(drawn) or files != len(drawn):
                    raise AssertionError(f"client mode stored {len(keys)} clients in {files} "
                                         f"files, drew {len(drawn)}")
                _, cvals, _, _, _ = self.offload_run(True, steps)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        err = max(max((vals["params"][k] - v).abs().max().item()
                      for k, v in cvals["params"].items()),
                  (vals["losses"] - cvals["losses"]).abs().max().item())
        if err != 0.0:
            raise AssertionError(f"client mode vs cluster mode: {err}")
        print(f"offload client mode (10^6 clients, spilled to a temporary directory, {steps} "
              f"graph supersteps): {len(keys)} clients stored, one file each, exactly the "
              f"participants; vs cluster mode max abs diff {err} (held to 0.0); kernel runs "
              f"{json.dumps(ran)}; {steps / dt:.3f} supersteps/s cold under the profiler",
              flush=True)
        return {"stored_clients": len(keys), "vs_cluster_mode": err, "kernel_runs": ran}

    def offload_async(self) -> dict:
        """dropout-participation-async with ``store="host-offload"`` (y held as
        one pseudo-client a cluster) against resident state, on the kernels
        and graphs under deterministic cuDNN: the same events, ``y`` and the
        store's cluster stack at 0.0, one run of each async kernel per
        cluster event; events/s."""
        from repro_torch.kernels import device_launches

        torch = self.torch
        name = "dropout-participation-async"
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            (run, dt, events, _), ran = device_launches(
                lambda: self.run_async(name, OFFLOAD_EVENTS, store="host-offload"))
            ref, _, revents, _ = self.run_async(name, OFFLOAD_EVENTS)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        sched = run.runtime.scheduler
        fired = [k for k, _, _ in events].count("cluster") * self.launch_groups(sched.y)
        if ran != {k: fired for k in ASYNC_KERNELS}:
            raise AssertionError(f"{name} offload: kernel runs {ran}")
        err = max(max((v - ref.runtime.scheduler.y[k]).abs().max().item(),
                      (sched.store.cluster_models[k] - v).abs().max().item())
                  for k, v in sched.y.items())
        if not (revents == events and err == 0.0 and sched.store.kind == "host-offload"):
            raise AssertionError(f"{name}: store vs resident events equal {revents == events}, "
                                 f"y diff {err}")
        print(f"offload {name} with a host-offload store ({OFFLOAD_EVENTS} events, graph, cuDNN "
              f"deterministic): the resident run's events, max abs y and store diff {err} "
              f"(held to 0.0); kernel runs {json.dumps(ran)}; "
              f"{OFFLOAD_EVENTS / dt:.3f} events/s cold under the profiler", flush=True)
        return {"max_abs_y_diff": err, "kernel_runs": ran, "events_per_s_cold": OFFLOAD_EVENTS / dt}

    def examples(self):
        """The port's three examples (``repro_torch.examples``) through their
        ``main`` on the card, cut in run length (``EXAMPLES``): each must
        finish with finite losses, the async one with its events on the
        graph."""
        import contextlib
        import io
        import math

        from repro_torch.examples import async_heterogeneous, quickstart, train_federated_lm

        mains = {"quickstart": quickstart.main, "async_heterogeneous": async_heterogeneous.main,
                 "train_federated_lm": train_federated_lm.main}
        out = {}
        for name, argv in EXAMPLES.items():
            t0 = time.perf_counter()
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                res = mains[name](argv + ["--device", "cuda"])
            dt = time.perf_counter() - t0
            if name == "quickstart":
                losses = res.loss
            elif name == "async_heterogeneous":
                losses = [h.loss[-1] for h in res.values()]
            else:
                losses = res["losses"] + [res["eval_loss"]]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"example {name}: losses {losses}")
            lines = printed.getvalue().strip().splitlines()
            print(f"example {name} {' '.join(argv)} on cuda: {dt:.1f}s; last lines: "
                  f"{lines[-3:]}", flush=True)
            out[name] = {"argv": argv, "seconds": dt, "losses": losses, "last_lines": lines[-3:]}
        self.detail["examples"] = out

    # -- the collective path and the training CLI -------------------------------
    def collective_width(self):
        """One ``build_fl_train_step`` iteration at granite-8b's widths (the
        lm-width model: 2 layers, bf16, S = 2048, b = 1) with ``impl="gossip"``
        (C = 8 in D = 4, ring, alpha = 2; eager): the flash counters set to 0
        just before it and read just after (every launch on the tensor-core
        route, and its device runs counted by the profiler), the loss finite,
        CUDA-event ms and peak memory, then a second (warm) step timed alike.
        Then the collective transition alone on the second step's output tree
        against ``CudaBackend.transition`` (the ``fused_transition`` kernel)
        on the same tree: both accumulate in f32 in different orders and cast
        once, so every element is held to one bf16 ulp of the larger output
        plus 2^-20 of its leaf's largest input (the f32 bound of two
        summation orders over at most 8 convex terms and 8 roundings; it
        matters only where the terms cancel), both timed with CUDA events,
        and the collective's transient bytes; last the plain versions of the
        transition and SGD kernels on the same tree, leaf by leaf, timed."""
        import dataclasses

        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core import FLSpec, build_fl_train_step, resolve_backend, stacked_init
        from repro_torch.kernels import device_launches
        from repro_torch.models import CausalLM
        from repro_torch.optim import sgd

        ow = LM_WIDTH["arch_overrides"]
        cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                                  vocab_size=LM_WIDTH["vocab_size"], **ow)
        model = CausalLM(cfg)
        c, d, s, b = COLLECTIVE_WIDTH["clients"], COLLECTIVE_WIDTH["clusters"], \
            LM_WIDTH["seq_len"], LM_WIDTH["batch_size"]
        fl = FLSpec(c, d, tau1=1, tau2=1, alpha=2, learning_rate=LR, impl="gossip")
        step = build_fl_train_step(model, sgd(LR), fl, event="inter", device=self.dev)
        params = stacked_init(model, c, 0, self.dev)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (c, b, s + 1))).to(self.dev)
        batch = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
        n_params = sum(w[0].numel() for w in params.values())
        nbytes = sum(w.numel() * w.element_size() for w in params.values())

        counters = self.lm_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def one_step():
            start.record()
            out = step(params, (), batch)
            end.record()
            return out

        (new, _, loss), ran = device_launches(one_step)
        torch.cuda.synchronize()
        step_ms, peak = start.elapsed_time(end), torch.cuda.max_memory_allocated()
        launches = {k: fn.launches for k, fn in counters.items()}
        routes = self.check_routes(counters, {"flash_attention": "tensor_core",
                                              "flash_attention_backward": "tensor_core"},
                                   "collective-width (bf16)")
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start.record()
        new2, _, loss2 = step(new, (), batch)
        end.record()
        torch.cuda.synchronize()
        warm_ms, warm_peak = start.elapsed_time(end), torch.cuda.max_memory_allocated()
        del new
        new = new2
        want = {"flash_attention_fwd.tensor_core": cfg.num_layers,
                "flash_attention_bwd.tensor_core": cfg.num_layers}
        runs = {k: ran.get(k, 0) for k in want}
        if runs != want or launches["fused_transition"] or launches["sgd_update"]:
            raise AssertionError(f"collective-width: device runs {ran}, host launches "
                                 f"{launches}; expected {want} and no transition or SGD kernel")
        loss, loss2 = loss.item(), loss2.item()
        if not (np.isfinite(loss) and np.isfinite(loss2)):
            raise AssertionError(f"collective-width: losses {loss}, {loss2}")
        for kname, key in (("flash_attention", "flash_attention_fwd.tensor_core"),
                           ("flash_attention_backward", "flash_attention_bwd.tensor_core")):
            self.record[kname]["collective_width_launches"] = {
                "device": ran[key], "host": launches[kname]}
        print(f"collective-width: build_fl_train_step(impl='gossip', event='inter') at "
              f"granite-8b widths ({cfg.num_layers} of 36 layers, {cfg.dtype}, S={s}, b={b}; "
              f"{n_params} params a client x {c} clients = {nbytes / 1e9:.2f} GB; C={c} in "
              f"D={d}, ring, alpha=2; eager): loss {loss:.4f}; {step_ms:.2f} ms (CUDA events); "
              f"peak {peak / 2**30:.2f} GiB; flash device runs {json.dumps(runs)}, host "
              f"launches {json.dumps(launches)}, routes {json.dumps(routes)}; a second step: "
              f"loss {loss2:.4f}, {warm_ms:.2f} ms, peak {warm_peak / 2**30:.2f} GiB", flush=True)
        del batch, toks
        torch.cuda.empty_cache()

        # the transition alone on the step's output tree: the collective path
        # (out of place) against the fused_transition kernel (in place)
        proto = fl.protocol()
        coll = resolve_backend("collective", proto.clusters, proto.P(), 2, device=self.dev)
        kern = resolve_backend("cuda", proto.clusters, proto.P(), 2, device=self.dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ref = coll.transition(new, "inter")
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - base
        scale = {k: w.abs().max().float().item() for k, w in new.items()}
        kern.transition(new, "inter")  # overwrites new
        err, over, beyond, differ, total = 0.0, 0, 0, 0, 0
        chunk = 1 << 26
        for k, w in new.items():
            a, o = ref[k].view(-1), w.view(-1)
            floor = 2.0 ** -20 * scale[k]
            for i in range(0, a.numel(), chunk):
                x, y = a[i:i + chunk].float(), o[i:i + chunk].float()
                diff = (x - y).abs()
                # one bf16 ulp at the larger of the two magnitudes: 2^(e - 8)
                # for |v| in [2^(e-1), 2^e)
                ulp = torch.ldexp(torch.ones_like(y), torch.frexp(torch.maximum(x.abs(),
                                                                              y.abs()))[1] - 8)
                err = max(err, diff.max().item())
                beyond += int((diff > ulp).sum().item())
                over += int((diff > ulp + floor).sum().item())
                differ += int((diff > 0).sum().item())
                total += x.numel()
                del x, y, diff, ulp
        del ref
        torch.cuda.empty_cache()
        print(f"  collective transition vs the fused_transition kernel on the step's tree: max "
              f"abs err {err:.3e}, {differ} of {total} elements differ, {beyond} by more than "
              f"one bf16 ulp, {over} by more than one ulp + 2^-20 of the leaf's largest input "
              f"(held to 0); transient {transient / 1e9:.2f} GB above the tree", flush=True)
        if over:
            raise AssertionError(f"collective-width: {over} elements beyond the tolerance")
        coll_ms = self.cuda_ms(lambda: coll.transition(new, "inter"), reps=3, warmup=1)
        kern_ms = self.cuda_ms(lambda: kern.transition(new, "inter"), reps=5, warmup=1)
        m_total = sum(w[0].numel() for w in new.values())
        bnd, by = self.bound(2 * nbytes, 2 * m_total * (2 * c * d + 2 * d * d), BF16_FLOPS_PER_S)
        print(f"  transition times (CUDA events, {nbytes / 1e9:.2f} GB tree): collective "
              f"{coll_ms:.3f} ms, fused_transition {kern_ms:.3f} ms ({coll_ms / kern_ms:.1f}x); "
              f"bound {bnd:.4f} ms ({by})", flush=True)
        # the two tree kernels' plain versions on the granite tree, leaf by
        # leaf (out of place; the SGD's gradient a random tree of the same
        # leaves): the kernel table's plain_ms at these widths
        from repro_torch.kernels import fused_transition_ref, sgd_update_ref

        vt, p, bt = kern._vt, kern._p, kern._bt
        tr_plain_ms = self.cuda_ms(lambda: [fused_transition_ref(w.view(c, -1), vt, p, bt, 2)
                                            for w in new.values()], reps=2, warmup=1)
        grads = {k: torch.randn_like(w) for k, w in new.items()}
        sgd_plain_ms = self.cuda_ms(lambda: [sgd_update_ref(w, grads[k], LR)
                                             for k, w in new.items()], reps=3, warmup=1)
        del grads
        torch.cuda.empty_cache()
        print(f"  [{self.smi}] plain versions on the same tree, leaf by leaf (CUDA events): "
              f"fused_transition_ref {tr_plain_ms:.3f} ms (alpha 2), sgd_update_ref "
              f"{sgd_plain_ms:.3f} ms", flush=True)
        self.record["sgd_update"]["collective_width"] = {"plain_ms": sgd_plain_ms,
                                                         "tree_bytes": nbytes}
        res = {"step_ms": step_ms, "loss": loss, "peak_bytes": peak, "warm_step_ms": warm_ms,
               "warm_loss": loss2, "warm_peak_bytes": warm_peak, "device_runs": runs,
               "host_launches": launches, "flash_routes": routes, "params_per_client": n_params,
               "tree_bytes": nbytes, "transition": {
                   "collective_ms": coll_ms, "fused_transition_ms": kern_ms,
                   "ratio": coll_ms / kern_ms, "bound_ms": bnd, "bound_by": by,
                   "max_abs_err": err, "elements_differ": differ, "elements": total,
                   "beyond_one_ulp": beyond, "beyond_tolerance": over,
                   "transient_bytes": transient, "plain_ms": tr_plain_ms}}
        self.record["fused_transition"]["collective_width"] = res["transition"]
        self.detail["collective_width"] = res
        del new
        torch.cuda.empty_cache()

    def mesh(self):
        """The process-group path as one NCCL rank (the machine has one card):
        ``init_process_group("nccl", world_size=1)`` on a free local port with
        a timeout, ``make_client_mesh(1)`` on ``cuda:0``; ``ppermute`` of one
        client's bf16 tree at lm-width's model (the collective-width model
        at C = 1; a rank its own partner copies, so it is a same-device clone
        and no exchange the transition makes) held bitwise to its input and
        timed beside a ``copy_`` of the same bytes and the bytes bound,
        ``gather_rows`` (an NCCL all-gather) held bitwise and timed, and the
        schedulers' consensus, cluster models and checkpoint gather on the
        tree (``fleet_weighted_sum``, an NCCL all-reduce, timed;
        ``cluster_sums_on_mesh``, an NCCL broadcast; ``gather_rows_to_host``)
        held bitwise to the row in f32 or on the host; the
        sharding rules for all ten configs at published widths on meta
        tensors (no allocation; every config at least half its bytes on the
        16-way ``model`` axis), then ``distribute_params`` of the tree onto a
        1x1 NCCL ``DeviceMesh`` and back, bitwise; ``make_concrete_batch``
        for granite-8b at each of the four shapes on the card (train at C =
        16).  The group is destroyed at the end, also when the phase fails."""
        import dataclasses
        import datetime
        import socket

        import torch.distributed as dist

        torch = self.torch
        from repro_torch.configs import ARCH_NAMES, get_config
        from repro_torch.configs.shapes import SHAPES, input_specs, make_concrete_batch
        from repro_torch.core.aggregation import (
            cluster_sums_on_mesh, fleet_weighted_sum, gather_rows, gather_rows_to_host, ppermute,
        )
        from repro_torch.launch.mesh import make_client_mesh
        from repro_torch.models import CausalLM
        from repro_torch.sharding import (
            MeshAxes, describe_sharding, distribute_params, param_pspecs,
        )

        check = None
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            res = {"nvidia_smi": self.smi}
            mesh = make_client_mesh(1)
            if (mesh.size, mesh.index, mesh.device, mesh.backend) != (
                    1, 0, torch.device("cuda", 0), "nccl"):
                raise AssertionError(f"mesh: {mesh}")
            ow = LM_WIDTH["arch_overrides"]
            cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                                      vocab_size=LM_WIDTH["vocab_size"], **ow)
            shapes = CausalLM(cfg).param_shapes()
            gen = torch.Generator(device="cuda").manual_seed(0)
            tree = {k: torch.randn((1,) + tuple(v.shape), generator=gen, device=self.dev)
                    .to(v.dtype) for k, v in shapes.items()}
            nbytes = sum(v.numel() * v.element_size() for v in tree.values())
            moved = ppermute(tree, mesh, [(0, 0)])
            gathered = gather_rows(tree, mesh)
            for k, v in tree.items():
                if not (torch.equal(moved[k], v) and torch.equal(gathered[k], v)):
                    raise AssertionError(f"mesh: ppermute or gather_rows changed {k}")
            del moved, gathered
            # the schedulers' reductions at weight 1: the row in f32, bitwise
            one = torch.ones(1, device=self.dev)
            summed = fleet_weighted_sum(tree, mesh, one)
            clustered = cluster_sums_on_mesh(tree, mesh, 1, one)
            for k, v in tree.items():
                if not (torch.equal(summed[k], v[0].float())
                        and torch.equal(clustered[k], v.float())):
                    raise AssertionError(f"mesh: fleet_weighted_sum or cluster_sums changed {k}")
            del summed, clustered
            hosted = gather_rows_to_host(tree, mesh)
            for k, v in tree.items():
                if not (hosted[k].device.type == "cpu" and torch.equal(hosted[k], v.cpu())):
                    raise AssertionError(f"mesh: gather_rows_to_host changed {k}")
            del hosted
            dst = {k: torch.empty_like(v) for k, v in tree.items()}

            def copy():
                for k, v in tree.items():
                    dst[k].copy_(v)

            perm_ms = self.cuda_ms(lambda: ppermute(tree, mesh, [(0, 0)]), reps=10)
            gather_ms = self.cuda_ms(lambda: gather_rows(tree, mesh), reps=10)
            reduce_ms = self.cuda_ms(lambda: fleet_weighted_sum(tree, mesh, one), reps=10)
            copy_ms = self.cuda_ms(copy, reps=10)
            del dst
            bnd = 2 * nbytes / HBM_BYTES_PER_S * 1e3
            print(f"mesh [{self.smi}]: one NCCL rank, ppermute of one client's "
                  f"{cfg.dtype} tree at lm-width ({len(tree)} leaves, {nbytes / 1e9:.3f} GB): "
                  f"{perm_ms:.4f} ms (CUDA events; a rank its own partner: a same-device "
                  f"clone), copy_ of the same bytes {copy_ms:.4f} ms, gather_rows (NCCL "
                  f"all-gather) {gather_ms:.4f} ms, fleet_weighted_sum (f32 cast, scale, NCCL "
                  f"all-reduce) {reduce_ms:.4f} ms; bytes bound {bnd:.4f} ms (read + write at "
                  f"3.35 TB/s); all bitwise, cluster_sums_on_mesh and gather_rows_to_host too",
                  flush=True)
            res["exchange"] = {"tree_bytes": nbytes, "leaves": len(tree), "ppermute_ms": perm_ms,
                               "copy_ms": copy_ms, "gather_rows_ms": gather_ms,
                               "fleet_weighted_sum_ms": reduce_ms,
                               "bound_ms": bnd, "bound_by": "bytes", "bitwise": True}
            res["graph"] = self.mesh_graph(tree, mesh)

            # the sharding rules at published widths, on meta tensors
            rules = {}
            for name in ARCH_NAMES:
                pcfg = get_config(name)
                pshape = CausalLM(pcfg).param_shapes()
                specs = param_pspecs(pcfg, pshape, MeshAxes())
                total = sum(v.numel() * v.element_size() for v in pshape.values())
                on_model = sum(v.numel() * v.element_size() for k, v in pshape.items()
                               if "model" in specs[k])
                rules[name] = {**describe_sharding(pcfg, specs), "bytes": total,
                               "model_share": on_model / total}
                print(f"  sharding {name}: {json.dumps(describe_sharding(pcfg, specs))}, "
                      f"{on_model / total:.4f} of {total / 1e9:.2f} GB on 'model' (16-way)",
                      flush=True)
            low = {k: v["model_share"] for k, v in rules.items() if v["model_share"] < 0.5}
            if low:
                raise AssertionError(f"mesh: configs with under half their bytes sharded: {low}")
            res["sharding"] = rules
            from torch.distributed.device_mesh import init_device_mesh

            dm = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            specs = param_pspecs(cfg, tree, MeshAxes(), client_axis="data")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            laid = distribute_params(tree, specs, dm)
            back = {k: v.full_tensor() for k, v in laid.items()}
            torch.cuda.synchronize()
            dist_s = time.perf_counter() - t0
            bad = [k for k, v in tree.items() if not torch.equal(back[k], v)]
            if bad:
                raise AssertionError(f"mesh: distribute_params round trip changed {bad}")
            print(f"  distribute_params of the tree on a 1x1 NCCL DeviceMesh (data, model) and "
                  f"back: bitwise, {dist_s:.3f} s", flush=True)
            res["distribute_round_trip"] = {"bitwise": True, "seconds": dist_s}
            del laid, back, tree
            # the capture check's nccl-outstanding case, in a process of its
            # own, after every timed section: it shares the card only with
            # the input shapes below
            check = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.core.capture_check", "--case",
                 "nccl-outstanding"], cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=dict(os.environ, PYTHONPATH=str(SRC)))

            # the input shapes at granite-8b's published widths, on the card
            gcfg = get_config("granite-8b")
            batches = {}
            for i, (sname, shape) in enumerate(SHAPES.items()):
                c = 16 if shape.step == "train" else None
                batch = make_concrete_batch(gcfg, shape, rng_seed=i, num_clients=c)
                specs_in = input_specs(gcfg, shape, c)
                for k, v in batch.items():
                    if (v.device.type != "cuda" or v.shape != specs_in[k].shape
                            or v.dtype != specs_in[k].dtype):
                        raise AssertionError(f"mesh: {sname} {k} {v.shape} {v.dtype}")
                for k in ("tokens", "labels", "token"):
                    if k in batch and not (0 <= int(batch[k].min())
                                           and int(batch[k].max()) < gcfg.vocab_size):
                        raise AssertionError(f"mesh: {sname} {k} out of the vocabulary")
                if "pos" in batch and int(batch["pos"]) != shape.seq_len - 1:
                    raise AssertionError(f"mesh: {sname} pos {int(batch['pos'])}")
                batches[sname] = {k: list(v.shape) for k, v in batch.items()}
                del batch
            print(f"  make_concrete_batch(granite-8b) on the card: {json.dumps(batches)}",
                  flush=True)
            res["shapes"] = batches
            res["nccl_outstanding"] = self.nccl_outstanding(check)
            self.detail["mesh"] = res
        finally:
            dist.destroy_process_group()
            if check is not None and check.poll() is None:
                check.kill()
                check.wait()

    def nccl_outstanding(self, check) -> dict:
        """``core/capture_check.py``'s ``nccl-outstanding`` case (started as
        ``check``): its trials printed; fails unless the port's
        ``GraphedStep`` captured with the all-reduce outstanding and replayed
        it, and a fresh step captured after it."""
        out, err = check.communicate(timeout=240)
        try:
            case = json.loads(out.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            raise AssertionError(f"mesh: the nccl-outstanding case printed no result "
                                 f"(exit {check.returncode}): {err[-2000:]}") from None
        brief = {mode: [(t["captured"], t.get("seconds"), t.get("error")) for t in case[mode]]
                 for mode in ("global", "thread_local")}
        print(f"  capture_check nccl-outstanding [{self.smi}] (torch {case['torch']}, CUDA "
              f"{case['cuda']}, NCCL {case['nccl']}): an eager all-reduce outstanding, then at "
              f"once a capture of an all-reduce held open 0.3 s; (captured, s, error) by "
              f"mode {json.dumps(brief)}; GraphedStep {json.dumps(case['graphed_step'])}; "
              f"fresh capture {case['fresh_capture']}", flush=True)
        if case["graphed_step"] != {"captured": 1, "replays": 3, "value": 6.0} or not case[
                "fresh_capture"]:
            raise AssertionError(f"mesh: nccl-outstanding {json.dumps(case)}")
        return case

    def mesh_graph(self, tree: dict, mesh) -> dict:
        """The exchanges the captured mesh steps call, in one ``GraphedStep``
        on one NCCL rank, on the one-client ``tree`` (see the module
        docstring, phase 19; ``capture_check.hold_mesh_exchanges``); returns
        the counts and times."""
        torch = self.torch
        from repro_torch.core.capture_check import hold_mesh_exchanges
        from repro_torch.kernels import ShortSessionError

        torch.cuda.empty_cache()
        # warm-up, capture (and its replay), two replays, each bitwise eager
        step, body, batch = hold_mesh_exchanges(tree, mesh, 4)
        if (step.captured, step.replays) != (1, 3):
            raise AssertionError(f"mesh: {step.captured} captures, {step.replays} replays")
        (entry,) = step._entries.values()

        def records(fn):
            """``fn``'s device records by kind in a padded session: copies (a
            ``Memcpy`` record, or in a graph sometimes a ``memcpy*`` kernel:
            CUDA may run a graph's copy node as one), the collectives'
            device annotations (``nccl:*``) and kernels; the pad's records
            kept, and the host's launch and copy calls."""
            _, names, pads, host = self.padded_kernel_names(fn)
            kinds = collections.defaultdict(collections.Counter)
            for n in names:
                kind = ("copy" if n.lower().startswith("memcpy")
                        else "annotation" if n.startswith("nccl:") else "kernel")
                kinds[kind][n] += 1
            return kinds, pads, host

        eager, eager_pads, eager_host = records(lambda: body(batch))
        replay, replay_pads, replay_host = records(entry.graph.replay)
        if not (eager_pads and replay_pads):
            # the session lost its first records past the pad: no hold made
            raise ShortSessionError({"pad, eager session": (eager_pads, FLASH_ROWS_PAD),
                                     "pad, replay session": (replay_pads, FLASH_ROWS_PAD)})
        copies = (sum(eager["copy"].values()), sum(replay["copy"].values()))
        if eager["kernel"] != replay["kernel"] or copies[0] != copies[1]:
            raise AssertionError(
                f"mesh: a replay's device work differs from the eager call's: kernels "
                f"{sorted((eager['kernel'] - replay['kernel']).items())} eager only, "
                f"{sorted((replay['kernel'] - eager['kernel']).items())} replay only; "
                f"copies {copies}")
        if replay_host != collections.Counter({"cudaGraphLaunch": 1}):
            raise AssertionError(f"mesh: a replay made host launch calls {dict(replay_host)}")
        nccl = {k: n for k, n in replay["kernel"].items() if "nccl" in k.lower()}
        # a leaf's all-gather (twice: the fixed buffer and the dense transition's
        # stack), all-reduce and broadcast, and the losses' all-gather
        collectives = 4 * len(tree) + 1
        eager_ms = self.cuda_ms(lambda: body(batch), reps=5, warmup=1)
        replay_ms = self.cuda_ms(entry.graph.replay, reps=5, warmup=1)
        print(f"mesh graph [{self.smi}]: the mesh steps' exchanges on the one-client tree in "
              f"one GraphedStep over NCCL ({collectives} collectives): warm-up, capture, 3 "
              f"replays, each bitwise its eager run; a replay ran "
              f"{sum(replay['kernel'].values())} kernels and {copies[1]} copies "
              f"{json.dumps(replay['copy'])} against the eager call's "
              f"{sum(eager['kernel'].values())} and {copies[0]} {json.dumps(eager['copy'])} "
              f"(kernels equal by name; pads kept {eager_pads}/{replay_pads} of "
              f"{FLASH_ROWS_PAD}); NCCL kernels a replay {sum(nccl.values())}; the eager "
              f"call's collective annotations {json.dumps(eager['annotation'])}; host launch "
              f"calls at a replay {json.dumps(dict(replay_host))} (eager "
              f"{json.dumps(dict(eager_host))}); replay {replay_ms:.4f} ms against the eager "
              f"call {eager_ms:.4f} ms (CUDA events)", flush=True)
        del step, entry, body, batch
        self.torch.cuda.empty_cache()
        return {"kernels_replay": dict(replay["kernel"]), "kernels_eager": dict(eager["kernel"]),
                "copies_replay": dict(replay["copy"]), "copies_eager": dict(eager["copy"]),
                "annotations_eager": dict(eager["annotation"]),
                "pads_kept": [eager_pads, replay_pads],
                "nccl_kernels_per_replay": sum(nccl.values()), "collectives_in_body": collectives,
                "host_launch_calls_replay": dict(replay_host),
                "host_launch_calls_eager": dict(eager_host), "replay_ms": replay_ms,
                "eager_ms": eager_ms, "bitwise_calls": 4}

    def steps(self):
        """The step builders of ``launch.steps`` on a ``(data=1, model=1)``
        ``DeviceMesh`` over one NCCL rank (``make_test_mesh``; the group made
        on a free local port with a timeout, destroyed at the end).
        ``build_serve``: granite-8b at its published widths and depth (36
        layers, bf16, random weights from a seed) on ``decode_32k`` cut to
        batch ``STEPS_DECODE["batch"]``, against a full cache (random K/V in
        every one of the 32,768 slots, slot i at position i), decode steps
        at positions 32,766 on, the third wrapping the ring to slot 0, each
        through ``make_decode_impl`` and held bitwise against
        ``CausalLM.decode_step`` without it on the same weights, tokens and
        a copy of the cache (logits and caches); ``build_prefill`` on
        ``prefill_32k`` cut to batch 1, held bitwise against
        ``CausalLM.prefill`` (last logits and all 36 layers' caches), every
        flash forward on the tensor-core route; ``build_train`` at
        ``lm-width``'s cut (2 layers, C = 4 in D = 2 stacked on the rank,
        ``impl="dense"``, S = 2048), its flash forward and backward and
        ``fused_transition`` counted on the device (``device_launches``,
        counters set to 0 just before and read just after), held against
        ``build_fl_train_step`` called directly: each leaf's update (result
        minus start) within ``STEPS_UPDATE_TOL["inter"]`` of the direct
        step's, relative to its norm, and the loss within 1e-3 relative;
        then the gradient alone, a local step at ``STEPS_LOCAL`` (f32
        weights, bf16 activations) within ``STEPS_UPDATE_TOL["local"]``.
        Prints ms a decode step, a prefill and a train step (CUDA events;
        the train step and the direct one both warm and unprofiled) and the
        peak memory."""
        import dataclasses
        import datetime
        import gc
        import socket

        import numpy as np
        import torch.distributed as dist

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import SHAPES, InputShape
        from repro_torch.core import FLSpec, build_fl_train_step
        from repro_torch.kernels import device_launches, flash_attention_fwd
        from repro_torch.launch import build_prefill, build_serve, build_train, make_test_mesh
        from repro_torch.models import CausalLM
        from repro_torch.optim import sgd

        def events_ms(fn):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end)

        held = {"hi": 0}  # the peak before the last reset, for serve_peak and train_peak

        def step_peak(fn, operands):
            """``fn()`` and the step's own peak: its operands' bytes plus the
            rise of allocated memory over what the process held before it
            (the dry run's prediction counts the same)."""
            torch.cuda.synchronize()
            held["hi"] = max(held["hi"], torch.cuda.max_memory_allocated())
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            nbytes = sum(t.numel() * t.element_size() for t in operands)
            return out, nbytes + torch.cuda.max_memory_allocated() - before

        def tensors(*trees):
            return [t for tree in trees for t in (tree.values() if isinstance(tree, dict)
                                                  else [tree])]

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            res = {"nvidia_smi": self.smi}
            mesh = make_test_mesh(1, 1)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            cfg = get_config("granite-8b")
            plain = CausalLM(cfg)
            params = {k: v[0] for k, v in self.random_stack(cfg, 1).items()}
            rng = np.random.default_rng(0)

            # -- serve: decode_32k cut to a small batch, through make_decode_impl
            b, sc = STEPS_DECODE["batch"], SHAPES["decode_32k"].seq_len
            serve, abstract = build_serve(cfg, InputShape("decode_32k", sc, b, "decode"), mesh)
            gen = torch.Generator(device=self.dev).manual_seed(1)
            cache = {}
            for k, v in abstract[1].items():
                if k.endswith(".pos"):
                    cache[k] = torch.arange(sc, dtype=torch.int32, device=self.dev).expand(
                        v.shape).contiguous()
                    continue
                cache[k] = torch.empty(v.shape, dtype=v.dtype, device=self.dev)
                for i in range(v.shape[0]):  # a block at a time: small f32 scratch
                    cache[k][i] = torch.randn(v.shape[1:], generator=gen, device=self.dev)
            ref = {k: v.clone() for k, v in cache.items()}
            cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
            decode_ms, plain_ms, mism = [], [], []
            for t in range(STEPS_DECODE["steps"]):
                pos = sc - 2 + t
                tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, b).astype(np.int32)).to(
                    self.dev)
                ((logits, cache), ms), decode_peak = step_peak(
                    lambda: events_ms(lambda: serve(params, cache, tok, pos)),
                    tensors(params, cache, tok))
                (want, ref), pms = events_ms(lambda: plain.decode_step(params, tok, ref, pos))
                decode_ms.append(ms)
                plain_ms.append(pms)
                got = logits.full_tensor()
                if not (torch.equal(got, want) and bool(torch.isfinite(got).all())):
                    mism.append((pos, (got - want).abs().max().item()))
            bad = [k for k, v in cache.items() if not torch.equal(v.to_local(), ref[k])]
            if mism or bad:
                raise AssertionError(f"steps: decode_impl vs decode_step: logits {mism}, "
                                     f"caches {bad[:4]}")
            wrapped = int(cache["pos0.pos"].to_local()[0, 0])
            if wrapped != sc:
                raise AssertionError(f"steps: slot 0 holds position {wrapped}, not {sc}")
            del cache, ref, logits, want, got
            gc.collect()
            print(f"steps [{self.smi}]: build_serve granite-8b (36 layers, bf16) decode_32k at "
                  f"batch {b} on a (1, 1) DeviceMesh, cache {cache_bytes / 1e9:.2f} GB: "
                  f"{STEPS_DECODE['steps']} steps at positions {sc - 2}.. (the ring wrapped to "
                  f"slot 0), bitwise CausalLM.decode_step (logits and caches); ms a step "
                  f"{json.dumps([round(x, 3) for x in decode_ms])} (plain decode_step "
                  f"{json.dumps([round(x, 3) for x in plain_ms])}; CUDA events, the first "
                  f"warm-up included)", flush=True)
            res["serve"] = {"batch": b, "cache_len": sc, "cache_bytes": cache_bytes,
                            "decode_ms": decode_ms, "plain_decode_ms": plain_ms,
                            "bitwise": True, "wrapped_slot0_pos": wrapped}

            # -- prefill: prefill_32k cut to batch 1
            s = SHAPES["prefill_32k"].seq_len
            prefill, _ = build_prefill(cfg, InputShape("prefill_32k", s, 1, "prefill"), mesh)
            batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s)).astype(
                np.int32)).to(self.dev)}
            tc = flash_attention_fwd.routes.get("tensor_core", 0)
            (out, ms_first), ran = device_launches(lambda: events_ms(
                lambda: prefill(params, batch)))
            tc_launches = flash_attention_fwd.routes.get("tensor_core", 0) - tc
            (_, ms), prefill_peak = step_peak(lambda: events_ms(lambda: prefill(params, batch)),
                                              tensors(params, batch))
            want, plain_pms = events_ms(lambda: plain.prefill(params, batch))
            logits, caches = out
            # the positions' caches come out plain (made from a plain arange)
            full = lambda v: v.full_tensor() if hasattr(v, "full_tensor") else v  # noqa: E731
            bad = [k for k, v in caches.items() if not torch.equal(full(v), want[1][k])]
            if not torch.equal(full(logits), want[0]) or bad:
                raise AssertionError(f"steps: build_prefill vs CausalLM.prefill: caches {bad[:4]}")
            n_attn = cfg.num_layers
            if ran.get("flash_attention_fwd.tensor_core") != n_attn or tc_launches != n_attn:
                raise AssertionError(f"steps: prefill flash forwards {ran} (want {n_attn} on "
                                     f"the tensor-core route)")
            del out, logits, caches, want
            gc.collect()
            print(f"  build_prefill granite-8b prefill_32k at batch 1: {ms:.1f} ms a prefill "
                  f"(first {ms_first:.1f}; plain CausalLM.prefill {plain_pms:.1f}; CUDA events), "
                  f"bitwise (last logits, 36 layers' caches); flash forwards on the device "
                  f"{ran.get('flash_attention_fwd.tensor_core')} on the tensor-core route",
                  flush=True)
            res["prefill"] = {"seq": s, "ms": ms, "first_ms": ms_first, "plain_ms": plain_pms,
                              "bitwise": True, "device_runs": ran}
            del params
            gc.collect()
            torch.cuda.empty_cache()
            serve_peak = max(held["hi"], torch.cuda.max_memory_allocated())
            held["hi"] = 0
            torch.cuda.reset_peak_memory_stats()

            # -- train: lm-width's cut, C = 4 in D = 2 stacked on the rank
            tcfg = dataclasses.replace(get_config("granite-8b"), vocab_size=LM_WIDTH["vocab_size"],
                                       **LM_WIDTH["arch_overrides"])
            c, d = STEPS_TRAIN["clients"], STEPS_TRAIN["clusters"]
            fl = FLSpec(c, d, tau1=1, tau2=1, alpha=1, learning_rate=0.01, impl="dense")
            seq = LM_WIDTH["seq_len"]
            train, _ = build_train(tcfg, InputShape("lm-width", seq, c, "train"), mesh, fl=fl)
            direct = build_fl_train_step(CausalLM(tcfg), sgd(0.01), fl, device=self.dev)
            stack = self.random_stack(tcfg, c)

            def train_batch(cfg, clients):
                toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (clients, 1, seq + 1))
                                        .astype(np.int32)).to(self.dev)
                return {"tokens": toks[..., :-1].contiguous(),
                        "labels": toks[..., 1:].contiguous()}

            def fresh(tree):
                return {k: v.clone() for k, v in tree.items()}

            def update_gaps(start, got, want):
                """Each leaf's |got - want| / |want - start|: the two steps'
                updates of the same start, held against the direct one's."""
                gaps = {}
                for k, w in want.items():
                    dw = w.float() - start[k].float()
                    dg = got[k].float() - start[k].float()
                    norm = float(dw.norm())
                    gap = float((dg - dw).norm())
                    # a leaf that neither step moves (an update under half
                    # its weight's ulp) has no gap
                    gaps[k] = gap / norm if norm else (0.0 if gap == 0 else float("inf"))
                return gaps

            tbatch = train_batch(tcfg, c)
            counters = self.lm_counters()
            (got, _, loss), ran = device_launches(lambda: train(fresh(stack), (), tbatch))
            host = {k: fn.launches for k, fn in counters.items()}
            need = ("flash_attention_fwd", "flash_attention_bwd", "fused_transition")
            if not all(ran.get(k) for k in need):
                raise AssertionError(f"steps: train kernel runs on the device {ran}")
            got = {k: v.full_tensor() for k, v in got.items()}
            want, _, want_loss = direct(fresh(stack), (), tbatch)
            inter_gap = update_gaps(stack, got, want)
            rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
            del got, want
            # both steps timed the same way: warm, CUDA events, no profiler
            p = fresh(stack)
            (_, train_ms), train_step_peak = step_peak(
                lambda: events_ms(lambda: train(p, (), tbatch)), tensors(p, tbatch))
            p = fresh(stack)
            _, direct_ms = events_ms(lambda: direct(p, (), tbatch))
            del p
            train_peak = max(held["hi"], torch.cuda.max_memory_allocated())
            del stack
            gc.collect()
            torch.cuda.empty_cache()
            # the gradient path: a local step with f32 weights, the update
            # -lr * grad alone
            lcfg = dataclasses.replace(tcfg, dtype="float32", activation_dtype="bfloat16")
            lc, lr = STEPS_LOCAL["clients"], STEPS_LOCAL["learning_rate"]
            lfl = FLSpec(lc, STEPS_LOCAL["clusters"], tau1=1, tau2=1, alpha=1,
                         learning_rate=lr, impl="dense")
            ltrain, _ = build_train(lcfg, InputShape("lm-width", seq, lc, "train"), mesh, fl=lfl,
                                    event="local")
            ldirect = build_fl_train_step(CausalLM(lcfg), sgd(lr), lfl, event="local",
                                          device=self.dev)
            lstack, lbatch = self.random_stack(lcfg, lc, seed=1), train_batch(lcfg, lc)
            lgot, _, lloss = ltrain(fresh(lstack), (), lbatch)
            lgot = {k: v.full_tensor() for k, v in lgot.items()}
            lwant, _, lwant_loss = ldirect(fresh(lstack), (), lbatch)
            local_gap = update_gaps(lstack, lgot, lwant)
            still = [k for k, w in lwant.items() if torch.equal(w, lstack[k])]
            if still:
                raise AssertionError(f"steps: the local step left leaves unchanged: {still}")
            lrel = abs(float(lloss) - float(lwant_loss)) / abs(float(lwant_loss))
            del lgot, lwant, lstack
            gc.collect()
            torch.cuda.empty_cache()
            worst_inter, worst_local = (max(g, key=g.get) for g in (inter_gap, local_gap))
            if (inter_gap[worst_inter] > STEPS_UPDATE_TOL["inter"]
                    or local_gap[worst_local] > STEPS_UPDATE_TOL["local"]
                    or not rel <= 1e-3 or not lrel <= 1e-3):
                raise AssertionError(
                    f"steps: build_train vs build_fl_train_step: update gap inter {worst_inter} "
                    f"{inter_gap[worst_inter]:.3e} (tol {STEPS_UPDATE_TOL['inter']}), local "
                    f"{worst_local} {local_gap[worst_local]:.3e} (tol "
                    f"{STEPS_UPDATE_TOL['local']}), loss rel {rel:.3e} / {lrel:.3e}")
            for kname, key in (("flash_attention", "flash_attention_fwd"),
                               ("flash_attention_backward", "flash_attention_bwd"),
                               ("fused_transition", "fused_transition")):
                self.record[kname]["steps_launches"] = ran[key]
            print(f"  build_train lm-width cut (granite widths, 2 layers, C={c} in D={d} on the "
                  f"rank, impl dense, S={seq}, bf16): {train_ms:.1f} ms a step (build_fl_train_step "
                  f"directly {direct_ms:.1f}; CUDA events, both warm, neither profiled); kernel "
                  f"runs on the device {json.dumps(ran)}, host launches {json.dumps(host)}; "
                  f"against build_fl_train_step, each leaf's update gap relative to the direct "
                  f"update: inter step worst {worst_inter} {inter_gap[worst_inter]:.3e} (tol "
                  f"{STEPS_UPDATE_TOL['inter']}), local step (f32 weights, bf16 activations, "
                  f"C={lc}, lr {lr}) worst {worst_local} {local_gap[worst_local]:.3e} (tol "
                  f"{STEPS_UPDATE_TOL['local']}); loss {float(loss):.6f} vs "
                  f"{float(want_loss):.6f}, local {float(lloss):.6f} vs {float(lwant_loss):.6f} "
                  f"(rel tol 1e-3); peak memory serve+prefill {serve_peak / 2**30:.2f} GiB, "
                  f"train {train_peak / 2**30:.2f} GiB", flush=True)
            print(f"  update gaps by leaf: inter {json.dumps(inter_gap)}; local "
                  f"{json.dumps(local_gap)}", flush=True)
            res["train"] = {"ms": train_ms, "direct_ms": direct_ms, "device_runs": ran,
                            "host_launches": host, "update_gap_inter": inter_gap,
                            "update_gap_local": local_gap, "loss": float(loss),
                            "direct_loss": float(want_loss), "local_loss": float(lloss),
                            "local_direct_loss": float(lwant_loss)}
            res["peak_bytes"] = {"serve_prefill": serve_peak, "train": train_peak}
            # each step's own peak and its warm time, which the dryrun phase
            # holds its trace's prediction against
            res["step_peak_bytes"] = {"decode": decode_peak, "prefill": prefill_peak,
                                      "train": train_step_peak}
            res["step_ms"] = {"decode": min(decode_ms[1:]), "prefill": ms, "train": train_ms}
            self.detail["steps"] = res
        finally:
            dist.destroy_process_group()

    def dots(self):
        """Remat's ``"dots"`` policy at ``lm-width``'s cut (granite-8b widths,
        2 layers, S = 2048, bf16, random weights from a seed): one vmapped
        local gradient of ``DOTS["clients"]`` clients (the round engine's
        ``vmap(grad_and_value)``) with remat off, ``"full"`` and ``"dots"``
        on the same weights and batch, in turns; the gradients held bitwise
        across the three (the dots backward takes the kept products back
        through the formulas the unsaved products' backward takes), and each
        one's peak memory above the weights and batch (``max_memory_allocated``)
        and warm gradients a second (CUDA events, ``DOTS["timed"]`` calls
        after one warm-up)."""
        import dataclasses
        import gc

        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import CausalLM

        base = dataclasses.replace(get_config("granite-8b"), vocab_size=LM_WIDTH["vocab_size"],
                                   **LM_WIDTH["arch_overrides"])
        c, seq = DOTS["clients"], LM_WIDTH["seq_len"]
        params = self.random_stack(base, c)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, base.vocab_size, (c, 1, seq + 1)).astype(
            np.int32)).to(self.dev)
        batch = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
        modes = {"off": dict(remat=False), "full": dict(remat=True, remat_policy="full"),
                 "dots": dict(remat=True, remat_policy="dots")}
        res, grads = {}, {}
        for name, over in modes.items():
            model = CausalLM(dataclasses.replace(base, **over))
            step = torch.func.vmap(torch.func.grad_and_value(model.loss))
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            g, loss = step(params, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - before
            grads[name] = (loss, g)
            del g
            times = []
            for _ in range(DOTS["timed"]):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = step(params, batch)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
                del out
            res[name] = {"peak_above_operands_bytes": peak, "ms": times,
                         "grads_per_s_warm": 1e3 / min(times)}
        ref_loss, ref = grads["off"]
        for name in ("full", "dots"):
            loss, g = grads[name]
            bad = [k for k, v in g.items() if not torch.equal(v, ref[k])]
            res[name]["bitwise_off"] = not bad and torch.equal(loss, ref_loss)
            if not res[name]["bitwise_off"]:
                raise AssertionError(f"dots: {name} gradients differ from remat off at {bad[:4]}")
        if not all(bool(torch.isfinite(v).all()) for v in ref.values()):
            raise AssertionError("dots: non-finite gradients")
        del grads, ref, params
        gc.collect()
        torch.cuda.empty_cache()
        peaks = {k: v["peak_above_operands_bytes"] for k, v in res.items()}
        print(f"dots [{self.smi}]: lm-width cut (granite-8b widths, {base.num_layers} layers, "
              f"S={seq}, bf16), vmap(grad_and_value) over {c} clients: gradients bitwise remat "
              f"off, full and dots; peak above the weights and batch "
              f"{json.dumps({k: round(v / 2**30, 3) for k, v in peaks.items()})} GiB; warm "
              f"gradients/s {json.dumps({k: round(v['grads_per_s_warm'], 4) for k, v in res.items()})}"
              f" (CUDA events, best of {DOTS['timed']}); ordering off >= dots >= full: "
              f"{peaks['off'] >= peaks['dots'] >= peaks['full']}", flush=True)
        self.detail["dots"] = res

    def dryrun(self):
        """The dry run on this machine, in a child process
        (``python3 chip_smoke.py --dryrun-child``) that imports torch and the
        port and never touches CUDA: (a) granite-8b ``decode_32k`` traced on
        the production mesh (256 ranks of a fake process group,
        ``"cuda"``-typed), its record printed; (b) the ``steps`` phase's
        decode, prefill and train steps traced on a ``(1, 1)`` mesh of a
        fake group at that phase's shapes, each prediction held against
        that phase's measurement: the peak (operands plus the peak of what
        the step makes) within 10% of the step's measured peak, and the
        measured warm ms no less than 0.95x the roofline term ``max(compute,
        memory)``; (c) the child's CUDA never initialized (no context, no
        allocation) and this process's allocated memory unchanged across
        it."""
        import tempfile

        torch = self.torch
        steps = self.detail.get("steps")
        if not steps or "step_peak_bytes" not in steps:
            raise AssertionError("dryrun: needs the steps phase's measurements (run it first)")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "dryrun.json"
            t0 = time.perf_counter()
            child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                    "--dryrun-child", str(out)], capture_output=True, text=True,
                                   timeout=DRYRUN_TIMEOUT, env=dict(os.environ,
                                                                    PYTHONPATH=str(SRC)))
            seconds = time.perf_counter() - t0
            if child.returncode != 0:
                raise AssertionError(f"dryrun child failed: {child.stderr[-4000:]}")
            got = json.loads(out.read_text())
        after = torch.cuda.memory_allocated()
        rec = got["production"]
        print(f"dryrun [{self.smi}]: child {seconds:.1f}s; (a) production mesh record (derived "
              f"from the H100 SXM's peaks, not measured): {json.dumps(rec)}", flush=True)
        total = torch.cuda.get_device_properties(0).total_memory
        print(f"  torch.cuda.get_device_properties(0).total_memory {total} bytes; "
              f"roofline.analysis.HW['device_memory'] {got['hw_device_memory']}", flush=True)
        held = {}
        for name, pred in got["steps"].items():
            peak = steps["step_peak_bytes"][name]
            ms = steps["step_ms"][name]
            bound_ms = 1e3 * max(pred["roofline"]["compute_s"], pred["roofline"]["memory_s"])
            ratio = pred["peak_bytes"] / peak
            held[name] = {"predicted_peak_bytes": pred["peak_bytes"], "measured_peak_bytes": peak,
                          "peak_ratio": ratio, "measured_ms": ms, "bound_ms": bound_ms,
                          "ms_over_bound": ms / bound_ms, "dominant": pred["roofline"]["dominant"],
                          "trace_s": pred["trace_s"], "kernels": pred["kernels"]}
            print(f"  (b) {name}: predicted peak {pred['peak_bytes'] / 2**30:.3f} GiB, measured "
                  f"{peak / 2**30:.3f} GiB, ratio {ratio:.4f} (tol 10%); measured {ms:.3f} ms, "
                  f"roofline max(compute, memory) {bound_ms:.3f} ms ({pred['roofline']['dominant']}"
                  f"), measured / bound {ms / bound_ms:.3f} (floor 0.95); traced in "
                  f"{pred['trace_s']:.1f}s, kernels {json.dumps(pred['kernels'])}", flush=True)
        print(f"  (c) the child's CUDA initialized: {got['cuda_initialized']}; this process's "
              f"allocated memory {before} -> {after} bytes", flush=True)
        self.detail["dryrun"] = {"seconds": seconds, "production": rec, "held": held,
                                 "child_cuda_initialized": got["cuda_initialized"],
                                 "allocated_before_after": [before, after],
                                 "total_memory_bytes": total}
        bad = [n for n, h in held.items()
               if not (abs(h["peak_ratio"] - 1) <= 0.10 and h["ms_over_bound"] >= 0.95)]
        if (bad or got["cuda_initialized"] or before != after
                or got["hw_device_memory"] != total):
            raise AssertionError(f"dryrun: held {bad}, child CUDA {got['cuda_initialized']}, "
                                 f"allocated {before} -> {after}")

    def mesh_serve(self):
        """``ContinuousFederatedServer(mesh=)`` on one NCCL rank (the group made
        on a free local port with a timeout, destroyed at the end): D = 1, so
        the slot pool's token exchange is an all-reduce over one rank,
        plumbing, not an exchange between cards.  Two models, one replica
        each: the reference's check (``tests/spmd_check.py``'s
        ``check_continuous_mesh_serving``: a 2-layer f32 dense model, 12
        requests, 4 slots, buckets (8, 16), chunks of 3 steps), whose
        prefills take the split-TF32 flash route, and granite-8b at its
        published widths cut to ``MESH_SERVE_WIDTH["layers"]`` layers, bf16,
        random weights from a seed, on a synthetic trace (the tensor-core
        route), under deterministic algorithms.  Each on the mesh with
        ``graph=True`` (the chunk's token all-reduce captured in its graph)
        and ``graph=False``; every request's tokens held equal across the two
        and to the off-mesh server's on the card (graphed chunk); the mesh
        chunk's graph captured once, its replays counted."""
        import dataclasses
        import datetime
        import socket

        import numpy as np
        import torch.distributed as dist

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.data import FederatedLM
        from repro_torch.kernels import flash_attention_fwd
        from repro_torch.launch.mesh import make_cluster_mesh
        from repro_torch.models import CausalLM
        from repro_torch.models.config import ArchConfig
        from repro_torch.serving import ContinuousFederatedServer, Request, synthetic_trace

        def serve(model, stack, reqs, mesh, graph, kw):
            srv = ContinuousFederatedServer(model, stack, mesh=mesh, graph=graph, **kw)
            batch = [dataclasses.replace(r, output=None) for r in reqs]
            for r in batch:
                srv.submit(r)
            srv.run()
            return [r.output for r in batch], srv

        def held(label, model, stack, reqs, kw) -> dict:
            """The requests on the mesh with ``graph=True`` and ``False`` and
            off the mesh; raises unless every token agrees."""
            n0 = flash_attention_fwd.launches
            on, srv = serve(model, stack, reqs, make_cluster_mesh(1), True, kw)
            prefill_flash = flash_attention_fwd.launches - n0  # the eager prefills'
            chunk = srv._chunk_p.graphed
            where = f"{srv.mesh.size} rank over {srv.mesh.backend}"
            captured, replays = chunk.captured, chunk.replays
            del srv, chunk
            eager, esrv = serve(model, stack, reqs, make_cluster_mesh(1), False, kw)
            if esrv._chunk_p.graphed is not None:
                raise AssertionError(f"mesh-serve {label}: graph=False replays a graph")
            del esrv
            off, _ = serve(model, stack, reqs, None, None, kw)
            same = all(np.array_equal(a, b) for a, b in zip(on, off))
            same_eager = all(np.array_equal(a, b) for a, b in zip(on, eager))
            vocab = model.cfg.vocab_size
            res = {"requests": len(on), "tokens": sum(len(t) for t in on),
                   "equal_off_mesh": same, "graph_equal_eager": same_eager,
                   "captured": captured, "replays": replays,
                   "prefill_flash_launches": prefill_flash, "mesh": where}
            print(f"  mesh-serve {label} [{self.smi}]: {res['requests']} requests, "
                  f"{res['tokens']} tokens; graph=True ({captured} capture, {replays} replays) "
                  f"equal to graph=False {same_eager} and to the off-mesh server's {same}; mesh "
                  f"{where}; the prefills' flash forward launches {prefill_flash}", flush=True)
            if not (same and same_eager):
                raise AssertionError(f"mesh-serve {label}: the graphed mesh server's tokens "
                                     f"differ from graph=False's or the off-mesh server's")
            if captured != 1 or replays < 1:
                raise AssertionError(f"mesh-serve {label}: the chunk's graph: {captured} "
                                     f"captures, {replays} replays")
            if not all(0 <= int(t.min()) and int(t.max()) < vocab for t in on if len(t)):
                raise AssertionError(f"mesh-serve {label}: a token outside the vocabulary")
            return res

        # the reference's check config
        cfg = ArchConfig(name="spmd-serve", family="dense", num_layers=2, d_model=32, d_ff=64,
                         vocab_size=64, num_heads=2, num_kv_heads=1, head_dim=16,
                         dtype="float32", remat=False, attn_chunk=16, tie_embeddings=True)
        model = CausalLM(cfg)
        stack = {k: v[None].to(self.dev) for k, v in
                 model.init(torch.Generator().manual_seed(0)).items()}
        rng = np.random.default_rng(0)
        reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, int(rng.integers(3, 17))),
                        max_new_tokens=int(rng.integers(1, 9)),
                        eos_id=int(rng.integers(0, cfg.vocab_size)),
                        cluster_id=int(rng.integers(0, 1))) for i in range(12)]
        kw = dict(max_batch=4, length_buckets=(8, 16), gen_cap=8, chunk_steps=3)
        # one granite-8b replica at its published widths, depth cut
        w = MESH_SERVE_WIDTH
        gcfg = dataclasses.replace(get_config("granite-8b"), num_layers=w["layers"])
        ds = FederatedLM.generate_clustered(2, 2, max(w["prompt_lens"]), gcfg.vocab_size, 1,
                                            seed=0)
        greqs = synthetic_trace(ds, num_requests=w["requests"], prompt_lens=w["prompt_lens"],
                                max_new_tokens=(1, w["gen_cap"]), seed=0)
        gkw = dict(max_batch=w["max_batch"], length_buckets=w["buckets"], gen_cap=w["gen_cap"],
                   chunk_steps=w["chunk_steps"])

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                                world_size=1, timeout=datetime.timedelta(seconds=60))
        out = {}
        try:
            out["check"] = held("check config (f32)", model, stack, reqs, kw)
            del stack
            gstack = self.random_stack(gcfg, 1)
            with self.deterministic() as refused:
                out["granite"] = held(
                    f"granite-8b at its published widths, {gcfg.num_layers} of 36 layers, "
                    f"{gcfg.dtype}", CausalLM(gcfg), gstack, greqs, gkw)
            del gstack
            out["granite"].update(
                config={"num_layers": gcfg.num_layers, "d_model": gcfg.d_model,
                        "d_ff": gcfg.d_ff, "heads": [gcfg.num_heads, gcfg.num_kv_heads,
                                                     gcfg.head_dim],
                        "vocab": gcfg.vocab_size, "dtype": gcfg.dtype},
                nondeterministic_ops=refused, **gkw)
        finally:
            dist.destroy_process_group()
            torch.cuda.empty_cache()
        self.detail["mesh_serve"] = out

    def launch(self):
        """The training CLI on the card through ``repro_torch.launch.train.main``:
        ``--scenario list``; ``mnist-noniid-ring`` 20 iterations on the auto
        backend (the SGD and transition kernels, their counters set to 0
        just before it and read just after); ``federated-lm-ring --backend
        collective --mesh auto`` against ``--backend dense`` within 1e-4 (it
        must print that the mesh resolved to none); the LM path with
        ``--save-dir``, then ``--resume`` (``resumed from round 2``, finite
        losses); a reduced ``build_fl_train_step`` at per-client batch 2,
        ``microbatch=2`` against 1 within 1e-5."""
        import contextlib
        import dataclasses
        import io
        import tempfile

        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core import FLSpec, build_fl_train_step, stacked_init
        from repro_torch.launch.train import main as train_main
        from repro_torch.models import CausalLM
        from repro_torch.optim import sgd

        def cli(argv):
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                out = train_main(argv + ["--device", "cuda"])
            torch.cuda.synchronize()
            text = printed.getvalue()
            print(f"launch.train {' '.join(argv)}: {time.perf_counter() - t0:.1f}s; last lines "
                  f"{text.strip().splitlines()[-2:]}", flush=True)
            return out, text

        def finite(tree):
            return all(bool(torch.isfinite(v).all()) for v in tree.values())

        res = {}
        _, text = cli(["--scenario", "list"])
        res["scenarios"] = len(text.strip().splitlines())
        counters = self.lm_counters()
        out, text = cli(["--scenario", "mnist-noniid-ring", "--steps", "20"])
        launches = {k: counters[k].launches for k in ("sgd_update", "fused_transition")}
        if not (all(launches.values()) and finite(out) and "done: steps=20" in text):
            raise AssertionError(f"launch mnist-noniid-ring: host launches {launches}")
        for kname, n in launches.items():
            self.record[kname]["launch_host_launches"] = n
        res["mnist_host_launches"] = launches
        lm = ["--scenario", "federated-lm-ring", "--steps", "4"]
        coll, text = cli(lm + ["--backend", "collective", "--mesh", "auto"])
        if "mesh=auto resolved to none" not in text:
            raise AssertionError("launch: --mesh auto did not say how it resolved")
        dense, _ = cli(lm + ["--backend", "dense"])
        err = max((coll[k] - v).abs().max().item() for k, v in dense.items())
        if not (finite(coll) and err <= 1e-4):
            raise AssertionError(f"launch: collective vs dense {err}")
        res["lm_collective_vs_dense"] = err
        with tempfile.TemporaryDirectory() as tmp:
            path = ["--arch", "granite-8b", "--tau1", "1", "--save-dir", tmp]
            _, first = cli(path + ["--steps", "2", "--save-every", "1"])
            out, text = cli(path + ["--steps", "4", "--resume"])
        losses = [float(line.split("loss=")[1].split()[0])
                  for line in (first + text).splitlines() if line.startswith("round")]
        if "resumed from round 2" not in text or not (finite(out) and np.isfinite(losses).all()):
            raise AssertionError(f"launch: resume printed {text!r}")
        res["lm_path_losses"] = losses
        # gradient accumulation: microbatch 2 against one batch of 2
        cfg = dataclasses.replace(get_config("granite-8b").reduced(), vocab_size=512)
        model = CausalLM(cfg)
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, 512, (8, 2, 65))).to(self.dev)
        batch = {"tokens": toks[..., :-1].contiguous(), "labels": toks[..., 1:].contiguous()}
        fl = FLSpec(8, 4, alpha=2, learning_rate=0.1, impl="gossip")
        params = stacked_init(model, 8, 0, self.dev)
        got = [build_fl_train_step(model, sgd(0.1), fl, microbatch=m, device=self.dev)(
            params, (), batch) for m in (1, 2)]
        mb_err = max(max((got[0][0][k] - v).abs().max().item() for k, v in got[1][0].items()),
                     abs(got[0][2].item() - got[1][2].item()))
        print(f"  build_fl_train_step (reduced granite, f32, gossip, b=2): microbatch 2 vs 1 "
              f"max abs diff {mb_err:.3e} (tol 1e-5)", flush=True)
        if not mb_err <= 1e-5:
            raise AssertionError(f"launch: microbatch 2 vs 1 {mb_err}")
        res["microbatch_2_vs_1"] = mb_err
        self.detail["launch"] = res

    def flash_rows(self):
        """'flash rows': sequence-parallel attention through the flash
        kernels' query-row map, at each shape of ``FLASH_ROWS``: each rank's
        map call (``rows = (rl, chunk, r * rl)``, its rows of every chunk,
        one launch forward and one backward) against its plain version on
        the same inputs; the ranks' rows assembled against the full kernel's,
        their dQ rows likewise, and their dK and dV summed against the full
        kernel's.  The launch counters are zeroed just before the shapes run
        and read just after (every map call and full call launches once);
        each route's device runs are counted from the profiler around one
        window's map calls, after ``FLASH_ROWS_PAD`` spin kernels of no
        wrapper (``padded_kernel_names``; held by route where the session
        kept every record, reported where it lost some, ROADMAP.md §3).  Then the map-less calls of every route held against the
        parent's kernels (``--parent-flash``, or git; ``flash_rows_parent``),
        and the map call timed at gemma2-2b's per-rank shape."""
        torch = self.torch
        from repro_torch.kernels import (
            count_kernels, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
            flash_attention_fwd_ref,
        )
        from repro_torch.kernels.flash_attention import route
        from repro_torch.kernels.flash_attention.ref import query_positions

        for w in (flash_attention_fwd, flash_attention_bwd):
            w.launches = 0
            w.routes = dict.fromkeys(w.routes, 0)
        calls, res, worst = 0, {}, {"forward": 0.0, "backward": 0.0}
        for name, shape, dt, chunk, ranks, windows, cap in FLASH_ROWS:
            dtype = getattr(torch, dt)
            f_tol, g_tol = (2e-5, 1e-4) if dtype == torch.float32 else (3e-2, 3e-2)
            b, s, hq, hkv, hd = shape
            rl = chunk // ranks
            q, k, v, dout = self.flash_inputs(shape, dtype, seed=3)
            rec = {"shape": list(shape), "dtype": dt, "chunk": chunk, "ranks": ranks,
                   "rows_a_rank": s // chunk * rl, "cap": cap,
                   "routes": [route(dtype, hd), route(dtype, hd, backward=True)], "windows": {}}
            for window in windows:
                out_f, lse_f = flash_attention_fwd(q, k, v, window, cap)
                dq_f, dk_f, dv_f = flash_attention_bwd(q, k, v, out_f, lse_f, dout, window, cap)
                calls += 1
                out_a, dq_a = torch.empty_like(out_f), torch.empty_like(dq_f)
                dk_a = torch.zeros(dk_f.shape, dtype=torch.float32, device=self.dev)
                dv_a = torch.zeros(dv_f.shape, dtype=torch.float32, device=self.dev)
                errs = {"forward": 0.0, "lse": 0.0, "backward": 0.0}
                rank_calls = []
                for r in range(ranks):
                    rows = (rl, chunk, r * rl)
                    pos = query_positions(s // chunk * rl, rows, self.dev)
                    qr, dor = q[:, pos].contiguous(), dout[:, pos].contiguous()
                    o_r, l_r = flash_attention_fwd(qr, k, v, window, cap, rows)
                    grads = flash_attention_bwd(qr, k, v, o_r, l_r, dor, window, cap, rows)
                    calls += 1
                    ref_o, ref_l = flash_attention_fwd_ref(qr, k, v, window, cap, rows)
                    refs = flash_attention_bwd_ref(qr, k, v, o_r, l_r, dor, window, cap, rows)
                    errs["forward"] = max(errs["forward"],
                                          (o_r.float() - ref_o.float()).abs().max().item())
                    errs["lse"] = max(errs["lse"], (l_r - ref_l).abs().max().item())
                    for g, ref in zip(grads, refs):
                        e = (g.float() - ref.float()).abs().max().item()
                        if not e <= g_tol * max(1.0, ref.float().abs().max().item()):
                            raise AssertionError(f"flash rows {name} window={window} rank {r}: "
                                                 f"gradient max abs err {e} (tol {g_tol} "
                                                 f"relative)")
                        errs["backward"] = max(errs["backward"], e)
                    out_a[:, pos], dq_a[:, pos] = o_r, grads[0]
                    dk_a += grads[1].float()
                    dv_a += grads[2].float()
                    rank_calls.append((qr, dor, rows))
                    del ref_o, ref_l, refs, grads, o_r, l_r
                if not (errs["forward"] <= f_tol and errs["lse"] <= 1e-4):
                    raise AssertionError(f"flash rows {name} window={window}: forward max abs "
                                         f"err {errs['forward']} (tol {f_tol}), lse "
                                         f"{errs['lse']} (tol 1e-4)")
                # the ranks' rows against the full kernel's
                full = {"rows_vs_full": (out_a.float() - out_f.float()).abs().max().item(),
                        "dq_rows_vs_full": (dq_a.float() - dq_f.float()).abs().max().item()}
                for key, got, want in (("dk_sum_vs_full", dk_a, dk_f),
                                       ("dv_sum_vs_full", dv_a, dv_f)):
                    full[key] = (got - want.float()).abs().max().item()
                    if not full[key] <= g_tol * max(1.0, want.float().abs().max().item()):
                        raise AssertionError(f"flash rows {name} window={window}: {key} "
                                             f"{full[key]} (tol {g_tol} relative)")
                for key, tol in (("rows_vs_full", f_tol), ("dq_rows_vs_full", g_tol * max(
                        1.0, dq_f.float().abs().max().item()))):
                    if not full[key] <= tol:
                        raise AssertionError(f"flash rows {name} window={window}: {key} "
                                             f"{full[key]} (tol {tol})")
                rec["windows"][str(window)] = dict(errs, **full)
                worst["forward"] = max(worst["forward"], errs["forward"])
                worst["backward"] = max(worst["backward"], errs["backward"])
                print(f"  flash rows {name} {shape} {dt} chunk {chunk} on {ranks} ranks "
                      f"({rl} rows a chunk) window={window} cap={cap}: "
                      + ", ".join(f"{key} {val:.3e}" for key, val in rec["windows"][
                          str(window)].items()), flush=True)
                if window == windows[0]:
                    def map_calls():
                        for qr, dor, rows in rank_calls:
                            o_r, l_r = flash_attention_fwd(qr, k, v, window, cap, rows)
                            flash_attention_bwd(qr, k, v, o_r, l_r, dor, window, cap, rows)

                    before = flash_attention_fwd.launches, flash_attention_bwd.launches
                    _, names, pads, _ = self.padded_kernel_names(map_calls)
                    ran = count_kernels(names)
                    host = {"flash_attention_fwd": flash_attention_fwd.launches - before[0],
                            "flash_attention_bwd": flash_attention_bwd.launches - before[1]}
                    calls += ranks
                    rec["device_runs"], rec["pad_runs"] = ran, [pads, FLASH_ROWS_PAD]
                    short = {key: (ran.get(key, 0), n) for key, n in host.items()
                             if ran.get(key, 0) < n}
                    print(f"  flash rows {name}: device runs of one window's {ranks} map calls "
                          f"(forward and backward) by route: {ran}; the session kept {pads} of "
                          f"the {FLASH_ROWS_PAD} spin kernels before them", flush=True)
                    if short:
                        # the profiler lost records (ROADMAP.md §3), the
                        # launches themselves are held by the host counts
                        rec["device_runs_short"] = short
                        print(f"  flash rows {name}: the session lost device records (device "
                              f"runs, host launches): {short}", flush=True)
                    else:
                        want = {f"flash_attention_fwd.{rec['routes'][0]}": ranks,
                                f"flash_attention_bwd.{rec['routes'][1]}": ranks}
                        if any(ran.get(key) != n for key, n in want.items()):
                            raise AssertionError(f"flash rows {name}: device runs {ran}, want "
                                                 f"{want}")
                del out_f, lse_f, dq_f, dk_f, dv_f, out_a, dq_a, dk_a, dv_a, rank_calls
            res[name] = rec
            del q, k, v, dout
            torch.cuda.empty_cache()
        host = {"forward": flash_attention_fwd.launches, "backward": flash_attention_bwd.launches,
                "forward_routes": dict(flash_attention_fwd.routes),
                "backward_routes": dict(flash_attention_bwd.routes)}
        print(f"  flash rows: host launches over the phase {host} ({calls} calls each way)",
              flush=True)
        if host["forward"] != calls or host["backward"] != calls:
            raise AssertionError(f"flash rows: {host} host launches for {calls} calls")
        res["host_launches"] = host
        res["parent_bitwise"] = self.flash_rows_parent()
        res["timed"] = self.time_flash_rows()
        self.detail["flash_rows"] = res
        for kname, part in (("flash_attention", "forward"), ("flash_attention_backward",
                                                            "backward")):
            self.record[kname]["flash_rows_launches"] = host[part]
            self.record[kname]["flash_rows"] = dict(res["timed"][part],
                                                    max_abs_err=worst[part])

    def padded_kernel_names(self, fn) -> tuple:
        """``(fn(), the device records fn made, the pad's records kept, the
        host's launch and copy calls fn made)`` from one profiler session
        (``kernels.device_records``) in which ``FLASH_ROWS_PAD`` spin
        kernels of no wrapper run first: late in the smoke a session has
        lost its first few dozen records (ROADMAP.md §3), and the pad takes
        that loss."""
        torch = self.torch
        from repro_torch.kernels import device_records

        def padded():
            for _ in range(FLASH_ROWS_PAD):
                torch.cuda._sleep(1)
            return fn()

        out, names, host = device_records(padded)
        pads = sum("spin_kernel" in n for n in names)
        host["cudaLaunchKernel"] -= FLASH_ROWS_PAD  # the pad's
        return out, [n for n in names if "spin_kernel" not in n], pads, +host

    def flash_rows_parent(self) -> dict:
        """The map-less calls of every route against the parent's kernels
        (built from its sources) on the same inputs: the tensor-core forward
        and backward at gemma2-2b's (window 4096, cap 50; the wide backward)
        and at hd 128 (the narrow one), and the split-TF32 forward, bitwise;
        the split-TF32 backward at f32 hd 64 and at bf16 hd 100 (hd % 8 !=
        0), whose arithmetic changed from the parent's CUDA-core backward,
        within 1e-4 (f32) and 3e-2 (bf16) of the parent's largest entry."""
        torch = self.torch
        from repro_torch.kernels import flash_attention_bwd, flash_attention_fwd
        from repro_torch.kernels.flash_attention import route

        if self.parent_flash is None:
            return {"skipped": self.detail.get("parent_flash", "no source")}
        fns = self.parent_flash
        stream = torch.cuda.current_stream().cuda_stream
        out = {}
        for name, shape, dtype, window, cap in (
                ("gemma2-2b", (1, 4096, 8, 4, 256), torch.bfloat16, 4096, 50.0),
                ("hd128", (1, 2048, 32, 8, 128), torch.bfloat16, 1024, None),
                ("f32-hd64", (2, 1024, 8, 2, 64), torch.float32, 200, None),
                ("bf16-hd100", (2, 640, 8, 2, 100), torch.bfloat16, None, 50.0)):
            b, s, hq, hkv, hd = shape
            q, k, v, dout = self.flash_inputs(shape, dtype, seed=4)
            o, lse = flash_attention_fwd(q, k, v, window, cap)
            grads = flash_attention_bwd(q, k, v, o, lse, dout, window, cap)
            fwd_way, bwd_way = route(dtype, hd), route(dtype, hd, backward=True)
            parent_bwd = "tensor_core" if bwd_way == "tensor_core" else "cuda_core"
            code = 0 if dtype == torch.float32 else 1
            args = (b, s, hq, hkv, hd, window or 0, float(cap or 0.0), hd ** -0.5, code, stream)
            po, pl = torch.empty_like(o), torch.empty_like(lse)
            rc = fns[fwd_way](q.data_ptr(), k.data_ptr(), v.data_ptr(), po.data_ptr(),
                              pl.data_ptr(), *args)
            pg = tuple(torch.empty_like(t) for t in (q, k, v))
            n_rows = s if parent_bwd == "cuda_core" else 2 * fns["rows"](s)
            scratch = torch.empty((b, hq, n_rows), dtype=torch.float32, device=self.dev)
            rc = rc or fns[f"{parent_bwd}_bwd"](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), scratch.data_ptr(), *(t.data_ptr() for t in pg), *args)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"the parent's flash kernels: cudaError_t {rc}")
            same = {"out": torch.equal(o, po), "lse": torch.equal(lse, pl)}
            close = {}
            if parent_bwd == bwd_way:
                same.update({n: torch.equal(g, p) for n, g, p in zip(("dq", "dk", "dv"), grads,
                                                                     pg)})
            else:  # a new arithmetic: held to the parent's gradients at the card tolerance
                tol = 1e-4 if dtype == torch.float32 else 3e-2
                close = {n: (g.float() - p.float()).abs().max().item()
                         / max(1.0, p.float().abs().max().item())
                         for n, g, p in zip(("dq", "dk", "dv"), grads, pg)}
            out[name] = {"routes": [fwd_way, bwd_way], "bitwise": same,
                         "rel_diff_to_parent": close}
            print(f"  flash map-less {name} {shape} {str(dtype)[6:]} ({fwd_way} forward, "
                  f"{bwd_way} backward) against the parent's kernels: bitwise {same}"
                  + (f"; gradients against the parent's {parent_bwd} backward, relative to its "
                     f"largest entry: {close} (tol {tol})" if close else ""), flush=True)
            if not all(same.values()) or any(not d <= tol for d in close.values()):
                raise AssertionError(f"flash map-less {name}: not the parent's: {same} {close}")
            del q, k, v, dout, o, lse, grads, po, pl, pg, scratch
        torch.cuda.empty_cache()
        return out

    def time_flash_rows(self) -> dict:
        """The map call at gemma2-2b's per-rank shape (rank 1 of 16: 256 rows
        of 4096 keys, 8/4 heads, hd 256, bf16), forward and backward, with
        window 4096 and cap 50 as the model runs it: CUDA-event ms of the
        kernel and its plain version beside the bound from the map's live
        pairs.  The library: ``scaled_dot_product_attention`` with the map's
        boolean (Sq, Sk) mask computes the call only without cap or window,
        so it is timed at that shape beside the kernel there (with a cap no
        single library call computes it)."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import (
            flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
            flash_attention_fwd_ref,
        )
        from repro_torch.kernels.flash_attention.ops import live_pairs
        from repro_torch.kernels.flash_attention.ref import _mask, query_positions

        name, shape, _, chunk, ranks, _, cap = FLASH_ROWS[0]
        b, s, hq, hkv, hd = shape
        rl = chunk // ranks
        rows = (rl, chunk, rl)
        sq = s // chunk * rl
        pos = query_positions(sq, rows, self.dev)
        q, k, v, dout = self.flash_inputs(shape, torch.bfloat16, seed=5)
        qr, dor = q[:, pos].contiguous(), dout[:, pos].contiguous()
        out = {"forward": {}, "backward": {}}
        for label, window, c in (("model", 4096, cap), ("no_cap_no_window", None, None)):
            o, lse = flash_attention_fwd(qr, k, v, window, c, rows)
            pairs = live_pairs(sq, window, rows)
            flops = 4.0 * hd * pairs * b * hq
            item = q.element_size()
            qo, kv = b * sq * hq * hd * item, b * s * hkv * hd * item
            row_b = b * hq * sq * 4
            bytes_f, bytes_b = 2 * qo + 2 * kv + row_b, 4 * qo + 4 * kv + row_b
            t = {"forward": {
                "ms": self.cuda_ms(lambda: flash_attention_fwd(qr, k, v, window, c, rows)),
                "plain_ms": self.cuda_ms(
                    lambda: flash_attention_fwd_ref(qr, k, v, window, c, rows), reps=5)},
                "backward": {
                "ms": self.cuda_ms(lambda: flash_attention_bwd(qr, k, v, o, lse, dor, window, c,
                                                               rows)),
                "plain_ms": self.cuda_ms(lambda: flash_attention_bwd_ref(
                    qr, k, v, o, lse, dor, window, c, rows), reps=5)}}
            for part, fl, by in (("forward", flops, bytes_f), ("backward", 2.5 * flops, bytes_b)):
                bnd, kind = self.bound(by, fl, BF16_FLOPS_PER_S)
                t[part].update(bound_ms=bnd, bound_by=kind, live_pairs=pairs, flops=fl,
                               tflops=fl / t[part]["ms"] / 1e9, bound_share=bnd / t[part]["ms"])
            if window is None and c is None:
                mask = _mask(pos, s, None)
                qt, kt, vt, gt = (x.transpose(1, 2) for x in (qr, k, v, dor))
                sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                              enable_gqa=True)
                leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
                lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
                t["forward"]["library_ms"] = self.cuda_ms(sdpa)
                t["forward"]["library_kernels"] = sorted(set(self.padded_kernel_names(sdpa)[1]))
                t["backward"]["library_ms"] = self.cuda_ms(
                    lambda: torch.autograd.grad(lib_out, leaves, gt, retain_graph=True))
                del qt, kt, vt, gt, leaves, lib_out, mask
            else:
                t["forward"]["library_ms"] = t["backward"]["library_ms"] = None
            for part in out:
                out[part][label] = dict(t[part], shape=[b, sq, s, hq, hkv, hd], rows=list(rows),
                                        window=window, cap=c)
                print(f"  time flash rows {name} rank 1 {label} {part}: " + ", ".join(
                    f"{key}={val:.6g}" if isinstance(val, float) else f"{key}={val}"
                    for key, val in out[part][label].items()), flush=True)
            del o, lse
        del q, k, v, dout, qr, dor
        torch.cuda.empty_cache()
        return out

    def run(self):
        torch = self.torch
        self.phase("device", self.device)
        self.phase("build", self.build)
        if not self.failed:
            self.phase("kernels", self.kernels)
            self.phase("main", self.main_path)
            self.phase("cifar", self.cifar)
            self.phase("async", self.async_path)
            self.phase("fleet", self.fleet)
            self.phase("lm", self.lm_path)
            self.phase("lm-width", self.lm_width)
            self.phase("optim", self.optim)
            self.phase("gemma2-width", self.gemma2_width)
            self.phase("families", self.families)
            self.phase("moe-width", self.moe_width)
            self.phase("ssm-width", self.ssm_width)
            self.phase("offload", self.offload)
            self.phase("examples", self.examples)
            self.phase("serve", self.serve)
            self.phase("serve-width", self.serve_width)
            self.phase("collective-width", self.collective_width)
            self.phase("mesh", self.mesh)
            self.phase("launch", self.launch)
            self.phase("steps", self.steps)
            self.phase("dots", self.dots)
            self.phase("dryrun", self.dryrun)
            self.phase("mesh-serve", self.mesh_serve)
            self.phase("flash-rows", self.flash_rows)
        if "jax" in sys.modules:
            self.failed.append("jax imported")
        self.detail["total_seconds"] = time.perf_counter() - self.t0
        print(f"smoke total {self.detail['total_seconds']:.1f}s (phases "
              f"{json.dumps({k: round(v, 1) for k, v in self.detail['phase_seconds'].items()})})",
              flush=True)
        out = HERE / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(
            {"failed": self.failed, **self.detail}, indent=1, default=str))
        if self.failed:
            fail(f"phases failed: {self.failed}")
        if self.only is not None:
            print(f"partial run of the phases {sorted(self.only)}: ok; no result line")
            return
        keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        kernels = [dict(name=k, route="cuda", **KERNELS[k], **{f: self.record[k][f] for f in keys})
                   for k in KERNELS]
        for entry in kernels:  # granite-8b's numbers (bf16; the f32 forward's too)
            for extra in ("width", "f32_width", "host_launches", "fleet_host_launches",
                          "offload_host_launches", "offload_maxd8", "by_value_ab",
                          "families_host_launches", "moe_width_launches", "moe_width",
                          "ssm_width_launches", "ssm_width", "mixtral_width", "hd160",
                          "gemma2_global", "gemma2_width_launches", "gemma2_width",
                          "serve_width", "collective_width_launches", "collective_width",
                          "launch_host_launches", "steps_launches", "flash_rows",
                          "flash_rows_launches", "optim"):
                if extra in self.record[entry["name"]]:
                    entry[extra] = self.record[entry["name"]][extra]
        print(self.smi)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
