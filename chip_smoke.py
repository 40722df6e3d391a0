#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the count-sketch optimizer on one card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with an NVIDIA H100, nvcc and
PyTorch built for CUDA.  It imports the port (``src/repro_torch``) and
nothing of the JAX package, and runs these phases, each printed on its
own line; any failure raises and the exit code is not 0:

  1. the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (into ``build/kernels/``);
  2. each kernel against its plain PyTorch version on the card:
     B1 ``cs_adam_tiled`` bit-equal on a collision-free batch, and under
     heavy collisions M and V bit-equal to the plain version on a CPU copy
     (upd within rtol 1e-6 of it: torch's CPU sqrt), within atol 2e-5 of
     it on the card and the same bits on a second run; B1 as the
     ``tiled`` path calls it (``ops.adam_rows_tiled``) on a full-width
     zipf batch, the same against a CPU copy; B4 at full width bit-equal;
     B2 ``cs_adam_fused`` bit-equal to
     ``ref.adam_fused_ref``, each with and without a first moment, and B2
     again where a bucket recurs 1, L-1, L and L+1 items back (L its
     window) and with k below one tile; the bucket CSR kernel
     (``cs_update.bucket_csr``/``bucket_prev``) integer-equal to its plain
     form (stable ``torch.sort``), prev included; B5 bit-equal to a CPU
     copy on one run of all items, with d not a multiple of 4, and on
     runs long enough for its long-run blocks;
     B3 ``cs_ema_tiled`` (signed and unsigned, the three ``ema_delta``
     forms, with and without a mask) and B5 ``cs_update`` bit-equal on a
     collision-free batch, within atol 2e-5 under heavy collisions and
     then bit-equal to the plain version on a CPU copy; B4 ``cs_query``
     bit-equal;
  3. the main path at full width: 20 steps of
     ``make_sparse_embedding_step`` on the tied embedding/softmax table of
     qwen2-0.5b (vocab 151,936 x d_model 896, from
     ``src/repro/configs/qwen2_0_5b.py:10-12``) with ``SketchHParams()``
     sketches, backend ``auto`` (= ``tiled``), 8 x 2,048 zipf ids a step;
     the loss on the first batch's ids must fall and B1, its CSR and the
     dedup sum (B5) must launch once a step.
     The per-batch loss (a fresh zipf sample each step) is printed, not
     required to fall: at this workload sketch noise on rare ids keeps it
     near its start.  Its witness: the same 20 batches from the same
     table through the plain ``xla`` backend must give the same per-batch
     losses and table (rtol 1e-4; whether they are equal to the bit is
     printed).  3f: the 20 steps again from the same start must give the
     same table and sketches to the bit, and one more step runs under
     ``torch.cuda.set_sync_debug_mode("error")``.  Five more steps under
     ``torch.profiler`` give the device's busy time a step, set against
     the unprofiled step time, and the launches a step by kernel name.
     The same 20 batches as dense gradients (``zeros.index_add_(0, ids,
     rows)``) through ``adam_from_stores`` with the same stores on
     ``auto`` (B3) must give phase 3's table (3d), and through dense Adam
     (``optimizers.adam``) show what sketching costs the loss (3e);
  4. the serve entry ``make_online_adapt_step`` (β₁=0) for 10 steps, 3
     steps of the main path on backend ``stream`` (B2), and the batch
     sketch ops ``ops.sketch_update``/``sketch_query`` (B5, B4) on one
     main-path batch;
  5. each kernel's time, its plain version's time and its byte bound at
     the shapes its path gives it: B1 alone and ``ops.adam_rows_tiled`` as
     the step calls it (time, busy time, launches); B5 as users call it
     (its CSR built in
     the call) beside the CSR alone, the scatter alone, one ``index_add_``
     and the plain version; B2 with its prev pass; the CSR kernel beside
     one stable ``torch.sort``; B3 (f32 and bf16 cells) with its column
     slices: their width, count and scratch bytes, one slice's read and
     scatter, the kernels' busy time within a call, and a call at other
     slice widths;
  6. the dense path at full width: the softmax layer of qwen2-0.5b
     (``tok_embed/table`` 151,936 x 896 and ``final_norm/scale``),
     cross-entropy of ``rmsnorm(h)*scale @ table^T`` on 1,024 zipf(1.1)
     targets a step with ``h = teacher[y] + noise``, full softmax so
     every row has a gradient, ``countsketch_adam(SketchPolicy(),
     backend auto)`` at lr 3e-5: 20 steps; the loss on batch 0's tokens
     must fall, B3 must launch twice a step, and the same batches
     through plain ``xla`` must give the same losses and table; five
     steps under the profiler.  At the main path's lr 3e-4 the sketched
     first moment makes some rows' directions reach the thousands and
     the loss rises; 6d prints that run beside the dense-first-moment
     (CS-V) and all-dense Adam runs on the same batches;
  7. phase 6's task with bf16 sketch cells (``SketchHParams(dtype=
     "bfloat16")``, 55,050,240 B a moment against 110,100,480 in f32):
     20 steps on ``auto``, B3's bf16 kernel must launch twice a step (its
     launches are counted apart, ``cs_ema_tiled_bf16``), the loss on
     batch 0's tokens must fall, and the plain ``xla`` witness must give
     the per-step losses within rtol 1e-4; printed beside phase 6's f32
     run.  7b: int8 cells on the same layer, 5 steps through the plain
     route (no B3), the loss must fall and the table stay finite.  7c:
     bf16 cells on phase 3's sparse-rows batches, backend ``tiled``: no
     B1 launch (low-precision cells run ``xla``, as in the reference,
     whose sums go through B5), the held loss must fall, and the steps
     run twice from the same start must give the same bits.  7d: the bf16 dense path with a Count-Min
     cleaned every 5 steps, 10 steps sync against ``AsyncCleaner``: the
     table and sketches must be equal to the bit.
  8. the MACH extreme-classification step (``train/extreme.py::
     make_extreme_step``) at the reference's full scale,
     ``benchmarks/extreme_scale.py:191-194``: 8,000,000 classes hashed
     into a 2,097,152 x 64 class head, a 65,536 x 64 feature table, 16
     zipf(1.05) features an example, 1,024 shared negatives, batch 1,024,
     lr 1e-2, ``SketchHParams(compression=100.0)``, backend ``auto``
     (``tiled``).  8a: ``cs_rmsprop`` (B1 without M) on both replicas, 20
     steps each, each replica's batches through its class map; the mean
     of the last w losses must be below the first w's (w = max(1,
     min(10, steps // 3)), the reference launcher's check); B1, its CSR
     and the dedup sum must launch once a table a step; five more steps
     under the profiler.  8b: replica 0's batches through ``xla`` within
     rtol 1e-4, atol 1e-5 (printed: equal to the bit).  8c: 8a's replica
     0 again: tables, V and losses to the bit; one step under
     ``set_sync_debug_mode("error")``.  8d: ``cs_adam`` (B1 with M) and
     ``dense_adam``, the same loss check, each arm's ``state_bytes``.
     8e: the peak device memory of a step of ``dense_adam`` and
     ``cs_rmsprop`` at batch 1,024 and 8,192.  8f: C1's last sites
     (the ordered table add, the dense path's plain routes, a 1-D
     ``DenseStore``) give the same bits twice and a CPU copy's; B1 at both
     tables' shapes, with and without M, held to its plain version and a
     CPU copy, and timed beside its bound (printed as phase 5 rows).
  9. planned, resumable training.  9a: phase 8's workload (replica 0's
     class map, batch 1,024, lr 1e-2) under ``plan_extreme(cfg,
     5,701,632, optimizer="cs_rmsprop", backend="auto")``, the bytes
     phase 8's compression 100 spends, which the planner splits as V
     (3, 5,376, 64) on the class head and (3, 2,048, 64) on the
     features: 20 steps; ``measure_aux_bytes`` of the state must equal
     the plan's 5,701,632 B, B1, its CSR and the dedup sum must launch
     twice a step, the loss must fall by 8a's window check; five more
     steps under the profiler; B1 timed at both planned shapes (phase 5
     rows).  9b: 10 steps from 9a's start, an async ``checkpoint.save``
     with the plan and its StoreTree in the manifest, step 11 run in
     place before the writer is joined, a restore into new tensors from
     the manifest's own plan, and steps 11..20: tables, state and losses
     equal to 9a's to the bit (the checkpoint lives under ``build/`` and
     is removed).  9e: that checkpoint restored through ``fold_sketches``
     under the manifest's fold predicate, V (3, 2,688, 64) and (3, 1,024,
     64), each the sum of the saved V's halves, then 5 steps under
     ``plan.fold()`` with a finite loss.  9c: phase 6's layer under
     ``plan_for_params(…, 200,000,000)`` (the table at (3, 9,216)),
     ``plan.make_optimizer(backend="auto")``, 5 steps: B3 twice a step,
     the loss on batch 0's tokens must fall, the plain ``xla`` witness
     within rtol 1e-4, and the state saved and restored equal to the
     bit.  9d: the CS-V floor plan of the same layer (dense m, the
     table's v a ``Rank1Store``: LR-NMF-V), 5 steps: the loss must fall,
     the state stay finite, and its ``.r``/``.c`` leaves round-trip a
     checkpoint to the bit.
 10. online-adaptation serving and its telemetry, at the reference's
     full settings (``benchmarks/serving.py:45-47, :77-80``): the
     qwen2-0.5b table, a zipf(1.1) trace of 600 requests of 8 ids x 896
     f32 from 256 users, ``ServerConfig()`` (256 id slots, 5 ms
     deadline, queue of 64, SLO p99 50 ms), lr 1e-3.  10a: two arms,
     ``make_online_adapt_step(SketchHParams(compression=5.0))`` on
     ``auto`` (B1) and ``make_dense_adapt_step``, each replayed through
     ``AdaptServer`` at 100, 500 and 5,000 requests/s with no other
     thread; prints adapt p50/p99, request p99, reads/s, batches, shed
     rate, ``state_bytes`` and the launches; B1, its CSR and the dedup
     sum (B5) must launch once a count-min batch (B5 once a dense batch);
     the cost of the copy-on-write generation copy; every ``serve``
     record goes through ``MetricsWriter`` and ``validate_file`` and
     ``obs.report`` renders the file; ``maybe_trace`` of 3 adapt batches
     must hold the ``obs.adapt`` span.  10b: after each replay the served
     table and state equal, to the bit, the same coalesced batches
     applied in order through the raw adapt step, and lie within atol
     2e-5 of the same batches through plain versions (count-min: the
     ``xla`` step on the card and the ``tiled`` step on a CPU copy;
     dense: a CPU copy); B1 at the serving shapes (k = 256, no M, the
     served V) against its plain version and timed (phase 5's
     ``at_serving_shapes``).  Each load is replayed again with a reader
     thread polling the published snapshot: the table rows and state
     sample it gathered for a version equal the raw trajectory's at that
     version (no torn snapshot); its latencies are printed apart from the
     published ones.  One coalesced batch equals its raw concatenation to
     the bit; ``dedup_coalesce`` equals a CPU copy; a held generation
     reads the same bits after two more publishes.  10c:
     phase 3's sparse step (a fresh table, 16,384 zipf ids a step), 20
     steps under ``RunObserver(log_every=5)`` with a ``TableMonitor``,
     a ``TableProbe(k=16)``, ``predicted_table_errors`` and a
     ``PhaseTimer``: the records validate, the ``table`` records carry
     occupancy, measured, predicted and ratio errors, the steps between
     boundaries run under ``set_sync_debug_mode("error")``, the table
     equals the same steps without the observer to the bit, and the step
     time with and without the observer is printed.
 11. the LM stack at qwen2-0.5b's full width (``src/repro/configs/
     qwen2_0_5b.py``: 24 layers, d_model 896, 14/2 heads, d_ff 4,864, two
     151,936 x 896 vocabulary tables, bf16 compute; nothing cut), on
     ``ZipfLM(seed)`` batches of 4 x 2,048 tokens (two attention chunks,
     four loss chunks).  11a: ``make_train_step(cfg, optimizer="cs_adam",
     kernel_backend="auto")`` at lr 1e-3 for 20 steps through ``Trainer``:
     the window check (the mean of the last w losses below the first w's,
     w = max(1, min(10, steps // 3))), which here does not test learning:
     the sketched first moment makes this arm's loss spike within the
     first window (the reference's ``cs_adam`` does the same at d_model
     896, ``tests/test_torch_lm_spike.py``), and the arms that learn are
     the gated ones of 11d and 11f; B3 exactly 4 launches a step (M
     and V of both tables), B10 (flash attention) 48 forward and 24
     backward launches a step (24 layers: the forward, remat's recompute
     and the backward), CUDA-event ms a step, peak memory, three steps
     under the profiler (busy time, idle share, launches) and one under
     ``set_sync_debug_mode("error")``.  11b: the same batches from the
     same start through plain ``xla``: losses within rtol 1e-4, params
     and state within rtol 1e-4/atol 1e-5 (printed: equal to the bit).
     11c: the ``auto`` arm again gives the same bits.  11d: ``dense_adam``
     for 5 steps: optimizer-state bytes and peak memory against
     ``cs_adam``'s; ``cs_adam_v`` for 5 steps; both must pass the window
     check (w = 1: the last loss below the first).  11e: 10 steps,
     an async save, a restore into a new ``Trainer`` and 10 more: equal
     to 11a to the bit (the checkpoint lives under ``build/`` and is
     removed).  11f: ``plan_for_config(cfg, "config")`` (4.6 GB) for 5
     steps on ``auto``: the state's bytes equal the plan's, B3 twice a
     step for each sketched table (width 29,952), the window check, and
     the same plan's 5 steps through plain ``xla`` from the same start:
     losses within rtol 1e-4, params and state within rtol 1e-4/atol
     1e-5 (printed: equal to the bit).  11g: ``make_serve_step(cfg, batch=8,
     max_seq=256)`` on 11a's params: prefill of 8 prompts of 128 tokens,
     64 greedy decode steps; each step's logits within 2^-6 of the row's
     largest |logit| of a prefill of the same prefix, and the argmax
     equal wherever the prefill's top-two margin exceeds that; prefill
     ms, decode ms a token and tokens/s.  11h: ``python -m
     repro_torch.launch.train --arch qwen2_0_5b --store-backend auto`` for
     3 steps: exit 0, B3 12 launches.  ``--phases 11,11g,11h`` runs phase
     11 alone.
 12. data parallelism (``repro_torch.distributed``) at full width.  12a:
     ``make_sparse_embedding_step(dp_axis=ReplicaGroup(4))`` on phase 3's
     table and lr, 4 replicas (threads on the one card) x 4,096 zipf(1.1)
     ids a step (phase 3's 16,384 split), 10 steps without and 10 with
     error feedback: B5 exactly 5 (6) launches a replica-step and no B1,
     the loss on the first batch's ids falls, every replica's table, m, v
     and residual equal to the bit; the 4 replicas' step time on one card
     (not a DP speed), three steps under the profiler, one under
     ``set_sync_debug_mode("error")``; the reference's byte model at 4,096
     rows and at k = n.  Under the dyadic protocol (β₁ = β₂ = 0.5, integer
     rows in [-3, 3], 3 steps) the DP first moment equals the
     single-device ``tiled`` step's (B1) on the concatenated batch to the
     bit, and after one step the DP second moment is within the modelled
     cross-replica bound.  12b: ``torch.distributed`` on NCCL at world
     size 1 (a ``file://`` rendezvous under ``build/``): 5 sparse DP steps
     equal to ``ReplicaGroup(1)``'s to the bit, each route's step time,
     and 3 qwen2-0.5b ``make_train_step(dp_axis=)`` steps (``cs_adam``,
     ``auto``) equal to the single-device steps from the same start to
     the bit, B3 4 launches a step.  12c: the serve fleet
     (``make_online_adapt_step(dp_axis=ReplicaGroup(2))``, phase 10's
     table, lr and compression, error feedback) on 50 batches of 256 zipf
     id slots: the replicas equal to the bit; the extreme step
     (``cs_rmsprop``, phase 8's shapes, MACH replica 0) at R = 2 for 5
     steps: the replicas equal to the bit, the first step's loss within
     rtol 1e-5 of the single-device loss on the concatenated batch and
     its grad norm within rtol 1e-5 of sqrt(sum of the shards' squared
     single-device norms).  ``--phases 12`` runs phase 12 alone.
 13. sharded sketches (``sketch_shards``; the replicas are
     ``ReplicaMesh`` threads on the one card, a model of the devices, not
     a speed).  13a: ``make_sparse_embedding_step(sketch_shards=)`` on
     phase 3's table, lr and 16,384 zipf ids a step, 10 steps on each of
     a 1 x 4 grid (width and hash layouts, lw 2,560: 27,525,120 B a
     moment a shard) and a 2 x 2 grid (width, with and without error
     feedback, lw 5,120): every shard's slab exactly
     ``spec.shard_nbytes()``, B5 exactly 5 (6) launches a replica-step
     and no B1, the held loss falls, every replica's table and each
     shard's slabs equal to the bit after every step, and the final
     table and joined state against the DP step at the grid's dp on
     stores stamped with the same sharding on the same general data
     (printed); ms a step, the launches, three steps under the profiler
     and one under ``set_sync_debug_mode("error")``; the reference's
     byte models.  Under the dyadic protocol (β₁ = β₂ = 0.5, integer
     rows, 3 steps) each grid equals that DP step to the bit after every
     step.  B5's slab mode (``cs_update_slab``) at a 4-shard slab (3,
     2,560, 896) and a step's deduplicated ids: bit-equal to its plain
     version on a CPU copy, within atol 2e-5 of it on the card,
     bit-equal on a collision-free batch, and timed (the kernels' line:
     ``cs_update.slab_mode``).  13b: the llama4-maverick vocab pair
     (202,048 x 5,120 each, ``CONFIG.aux_budget_bytes`` 48 MiB a device)
     under ``plan_for_tables(..., shards=8)`` (the unsharded call must
     raise ``InfeasibleBudgetError``), ``make_sparse_embedding_step(
     path="tok_embed/table", stores=plan.store_tree(), sketch_shards=8)``
     on a 1 x 8 grid for 5 steps of 4,096 zipf ids (cut from 16,384 for
     device memory: 8 replicas each hold the 4,137,943,040 B table):
     each shard's m + v bytes equal to the leaf's per-device share of
     the plan, the replicas equal, the loss falls; ms a step, peak
     memory.  13c: phase 9c's 200,000,000 B plan with
     ``with_sharding(4, "width")`` equal to the unsharded plan to the
     bit and ``with_sharding(4, "hash")`` equal to its ``xla`` witness to
     the bit, 5 steps each on ``make_optimizer(backend="auto")``: B3
     twice a step, the loss falls.  ``--phases 13`` runs phase 13 alone.
 14. placement, elastic recovery and the launcher's distributed flags,
     ``--workload sparse_embedding`` at phase 3's table (compression 5,
     width 10,240), 16,384 ids a step (``--batch 8 --seq 2048``), lr
     3e-5.  14a: ``launch.train.main`` in this process, 20 steps, a
     checkpoint every 10: B1 exactly 20 launches, ms a step printed,
     finite losses whose median over the last 10 steps is below the
     first 10's, and the exit code the launcher's own rule of its
     windows (their means also carry the spikes of rows a polluted
     count-sketch median threw off, which are counted: PERF.md §6).
     14b: ``python -m torch.distributed.run --standalone
     --nproc-per-node 1`` (NCCL at world size 1) of this script's
     ``--launcher-child``, which calls ``launch.train.main`` as ``-m
     repro_torch.launch.train`` does and prints its launches: the sparse
     workload under ``--dp --error-feedback`` for 10 steps (B5, no B1)
     and qwen2-0.5b ``--dp`` for 3 steps (B3 exactly 12); each exits 0
     with dp=True in its line.  14c: ``plan_resize(3, model_axis=1,
     old_data_axis=4)`` gives data 2 and a fold; ``elastic_restore`` of
     14a's checkpoint on the card folds M and V to width 5,120, equal to
     ``fold_sketches`` of a CPU copy to the bit, the table unchanged;
     10 steps on the folded family (B1 10) with finite losses whose
     median is below 14a's first 10's.  14d: ``recovery_loop`` around the
     launcher's ``Trainer`` failing once at step 15: one restart, the
     step-20 table and sketches equal to 14a's to the bit.  14e: the
     launcher's sparse run on ``ReplicaMesh`` threads, 1 x 4 width
     layout, 5 steps (B5 only); its global-leaf checkpoint restored with
     ``restore(shardings=)`` onto 1 x 2, each slab its block to the bit;
     5 further steps there (the re-placement message); a hash-layout
     checkpoint refused at another shard count.  ``--phases 14`` runs
     phase 14 alone.
 15. the launcher's other workloads and the MoE family (the tensors of
     earlier phases' results are dropped first).  15a:
     ``launch.train.main`` in this process, ``--workload extreme`` at
     phase 8's cell (8,000,000 classes into 2,097,152 meta rows, 2
     replicas, 65,536 x 64 features, 16 nnz, 1,024 negatives, batch
     1,024, lr 1e-2, compression 100), 20 steps a replica: exit 0 (each
     replica's window mean falls), B1 and the dedup sum (B5) once a table
     a step, ms a step printed; then with ``--aux-budget 5701632``
     (phase 9a's plan): the plan table printed, exit 0, B1 as before.
     15b: ``torch.distributed.run --standalone --nproc-per-node 1`` of
     ``--workload extreme --dp --error-feedback`` (NCCL at world size 1),
     10 steps a replica: exit 0 with dp=True in its line, B5, no B1.
     15c: ``--workload serve-replay`` at phase 10's cell (the
     qwen2-0.5b table, 600 requests of 8 ids at 500 requests/s, 256 id
     slots, 5 ms deadline, queue of 64, lr 1e-3: ``ServerConfig()``'s
     defaults): the count-min arm (B1, its CSR and the dedup sum once a
     batch and once for the warm-up) with ``--metrics-dir`` under
     ``build/`` (its ``serve`` record read back, then removed) and
     ``--optimizer dense_adam`` (B5 once a batch, no B1); both exit 0
     and print their ``[serve]`` lines.  15d: ``ops.adam_rows_fused`` at
     phase 4's shapes: B2 once, equal to ``adam_rows_stream`` to the
     bit, both timed.  15e: qwen2-moe-a2.7b (``src/repro/configs/
     qwen2_moe_a2_7b.py``: d_model 2,048, 16 heads, 60 experts top 4 of
     d_ff 1,408, a shared SwiGLU of 5,632, capacity factor 1.25, 32
     dispatch groups, two 151,936 x 2,048 tables, bf16 compute) trained
     at full width with **4 of its 24 layers** (f32 params, gradients
     and Adam's m and v of the layers take 16 B a parameter: 36.5 GB at
     4 layers, 61 GB before activations at 6), ``ZipfLM`` 4 x 2,048
     tokens a step, ``make_train_step(cfg, optimizer="cs_adam",
     kernel_backend="auto")`` at lr 1e-3 for 10 steps through
     ``Trainer``: B3 exactly 4 launches a step, finite losses and
     params; ms a step, peak memory, state bytes and the dropped
     assignments a step; 3 steps under the profiler; the first 5 of the
     same batches from the same start (drawn again from the seed) through
     plain ``xla``: losses within rtol 1e-4, params and state within rtol
     1e-4/atol 1e-5 of a host copy of the first run's state after 5
     steps (printed: equal to the bit); the ``auto`` arm again for 5
     steps: the same bits; ``dense_adam`` and
     ``cs_adam_v`` 10 steps each: state bytes and peak memory against
     ``cs_adam``'s, each passing the window check (w = 3: over the first
     steps, Adam at lr 1e-3 overshoots at this width, the loss rising
     before it falls).  15f: the
     same model at all 24 layers on fresh params (57,262,350,336 B of
     f32), ``make_serve_step(cfg, batch=8, max_seq=256)``: at the
     published capacity factor a prefill of 8 x 128 tokens (ms, dropped
     assignments by layer) and 64 greedy decode steps (ms a token,
     tokens/s, 3 under the profiler); then at capacity factor 60 (= the
     expert count: no assignment can drop; decode's 8 one-token groups
     drop nothing at any factor) 64 greedy decode steps, each step's
     logits held as in 11g to the prefill of its prefix: the causal
     forward of each row's whole decoded sequence at that position (one
     forward for the 64 prefixes; it is itself held to prefills of the
     first and last prefixes), within 2^-6 of the row's largest |logit|
     and the argmax equal wherever the top-two margin exceeds that.
     The check runs in f32 compute: in bf16 a token whose 4th and 5th
     router probabilities lie within bf16's rounding of the router's
     input is routed otherwise by decode and by the forward, and one
     such flip moves the logits past the tolerance; the bf16 run is
     printed (its ratio and the flips by layer), not gated.
     ``--phases 15`` runs phase 15 alone.
 16. the enc-dec and VLM families (the tensors of earlier phases'
     results are dropped first).  First B3 at whisper's and internvl2's
     vocabulary tables, (51,968, 1,024) and (92,672, 2,048), every row,
     as the LM step calls it: within the collision envelope of its plain
     version on the card, both timed, the byte bound.  16a:
     whisper-medium (``src/repro/configs/whisper_medium.py``: 24 encoder
     and 24 decoder layers, d_model 1,024, 16 heads of 64, d_ff 4,096,
     two 51,968 x 1,024 tables, bf16 compute) trained whole at full
     width: 8 utterances a step of 1,536 seeded normal stub frames (in bf16) and
     448 ``ZipfLM`` decoder tokens (the public models' text context),
     ``make_train_step(cfg, optimizer="cs_adam", kernel_backend="auto")``
     at lr 1e-3 for 10 steps through ``Trainer``: B3 exactly 4 launches a
     step, finite losses and params; ms a step, peak memory, state bytes;
     3 steps under the profiler; the first 5 of the same batches from
     the same start (drawn again from the seed; the first run's state
     after 5 steps waits on the host) through plain ``xla`` and through
     ``auto`` again: losses, params and state equal to the bit (the
     witness arms of 15e-17c run 5 steps, which makes room for phase
     18); ``dense_adam`` and ``cs_adam_v`` 10 steps
     each, state bytes and peak memory against ``cs_adam``'s, each
     passing the window check (w = 3); ``cs_adam``'s windows printed
     (its sketched first moment rises, ROADMAP C).  16b: whisper-medium
     served whole on fresh params, ``make_serve_step(cfg, batch=8,
     max_seq=448)``: a prefill of 1,536 stub frames and 32 prompt tokens
     (ms), 64 greedy decode steps (ms a token, tokens/s, 3 under the
     profiler), then in bf16 (printed) and in f32 (gated) compute each
     decoded step's logits held as in 15f to the forward of its row's
     whole decoded sequence at that position, that forward to the
     prefills of the first and last prefixes.  16c: internvl2-2b
     (``src/repro/configs/internvl2_2b.py``: 24 layers, d_model 2,048,
     GQA 16/8 heads of 128, d_ff 8,192, two 92,672 x 2,048 tables)
     trained whole as 16a, 4 x (256 stub patches +
     1,792 text tokens) a step: 2,048 positions, the patches counted in
     the cell's length as the reference counts them.  16d: internvl2-2b
     served as 16b: 256 patches and 128 prompt tokens, 64 decoded,
     ``max_seq`` 512.  16e:
     ``launch.train.main`` (``python -m repro_torch.launch.train``) with
     ``--workload lm --arch whisper_medium`` and ``--arch internvl2_2b``
     at full width, 3 steps each on ``--store-backend auto`` (the zero
     stub inputs the reference's launcher adds): exit 0, the ``[train]``
     line, B3 4 a step, whisper's losses finite (internvl2's loss is NaN
     from the second step in both packages: its zero patches overflow
     the gradient, ROADMAP C; printed).  ``--phases 16`` runs phase 16 alone.
 17. the RWKV6 and hybrid (Mamba2) families (the tensors of earlier
     phases' results are dropped first).  First B3 at rwkv6-7b's and
     zamba2-2.7b's vocabulary tables, (65,536, 4,096) and (32,000,
     2,560), as in phase 16.  17a: rwkv6-7b
     (``src/repro/configs/rwkv6_7b.py``: d_model 4,096, 64 heads of 64,
     d_ff 14,336, two 65,536 x 4,096 tables, bf16 compute, WKV chunks of
     64) cut to 8 of its 32 layers (dense Adam holds about 24 B a layer
     parameter at its peak: 5.25 GB a layer), ``ZipfLM`` 4 x 2,048
     tokens a step (32 chunks), with 16a's arms and checks (10 steps
     each: ``cs_adam`` on ``auto`` with B3 exactly 4 launches a step,
     finite losses and params, 3 steps under the profiler (one for
     zamba2, whose events take long to gather); plain ``xla``
     and ``auto`` again from the same start, equal to the bit;
     ``dense_adam`` and ``cs_adam_v`` against its state bytes and peak
     memory, each passing the window check; ``cs_adam``'s windows
     printed).  17b: rwkv6-7b served whole (32 layers) on fresh params,
     ``make_serve_step(cfg, batch=8, max_seq=192)``: a prefill of 128
     tokens (the chunked form), 64 greedy decode steps (ms a token,
     tokens/s, 3 under the profiler), then each step's logits held as
     in 16b to the forward of its row's decoded sequence (the chunked
     form at 192 positions), that forward to the prefills of the first
     and last prefixes (129 tokens: the scan; 192: the chunked form);
     gated in f32, printed in bf16.  17c: zamba2-2.7b
     (``src/repro/configs/zamba2_2_7b.py``: 54 Mamba2 layers, d_model
     2,560, 80 SSM heads of 64, state 64, one shared attention block of
     32 heads of 80 before every 6 layers, two 32,000 x 2,560 tables)
     cut to 24 of its 54 layers (4 of its 9 groups; whole, it took the
     smoke past its time limit once phase 18 joined it) and trained as
     17a.  17d: zamba2-2.7b served whole as 17b (the 9 sites' KV caches
     written in place).  17e: ``launch.train.main``
     with ``--workload lm --arch zamba2_2_7b`` at full width at the
     launcher's defaults, 3 steps on ``--store-backend auto`` (exit 0,
     the ``[train]`` line, B3 4 a step, finite losses), and ``--arch
     rwkv6_7b --reduced`` (whole it needs about 120 GB for dense Adam and
     the launcher, as the reference's, has no flag that cuts layers; its
     512-row tables are not sketched, so no B3): exit 0, finite losses.  ``--phases
     17`` runs phase 17 alone.
 18. the last modules (the tensors of earlier phases' results are
     dropped first).  18a: the dry run (``launch.dryrun.trace_cell``) of
     qwen2-0.5b's ``train_4k`` and ``decode_32k`` cells on the ``meta``
     device in this process: the FLOPs and argument bytes the CPU's
     trace gives (``P18_META``; the bytes printed beside the CPU's),
     ``train_4k``'s FLOPs 256 x the ``flops_per_device`` of the
     reference's record (``experiments/dryrun/single``); the real params,
     CS-Adam state and ``train_4k`` batch on the card, whose ``nbytes``
     must sum to the record's argument bytes
     (``torch.cuda.memory_allocated`` printed beside); one step of 4 x
     2,048 tokens on ``auto`` counted by ``op_cost.OpCost`` on the card:
     B3 4 launches, B10 48 forward and 24 backward launches, FLOPs equal
     to its meta trace's, and so under the span ``obs.attn`` (on the
     card the flash attention kernels report the FLOPs of the einsums
     that the meta trace runs there) above zero and equal too; its time
     (CUDA events, 3 steps) beside the roofline bound.  18b:
     ``launch.breakdown --device cuda`` on that cell at that batch: the
     heaviest rows with their device ms.  18c: A13d, the launcher's
     ``sparse_embedding`` at its default sizes on ``ReplicaMesh``
     threads, 1 x 4 in the width layout and 1 x 2 in the hash layout,
     with ``--metrics-dir``, ``--probe-rows 16``, 10 steps and
     ``--log-every 5``: exit 0, the records validate, each ``table``
     record equals to the bit what one ``TableMonitor`` in this thread
     computes on the state gathered at that boundary
     (``sharding.global_tree``), B5 in slab mode and its CSR launched,
     no B1; the gather's ms on replica 0.  18d: the four
     ``examples_torch/`` scripts as subprocesses at their smoke sizes,
     all started together (``--example-child``: the script, then its
     launch counts): each exits 0 and prints ``device: cuda``;
     quickstart, train_lm_100m and elastic_recovery launch B3 (printed).
     ``--phases 18`` runs phase 18 alone.
 19. flash attention (B10, ``kernels/flash_attn.py``) at qwen2-0.5b's
     attention of the benchmark's batch (4 x 2,048 tokens, 14 query and
     2 KV heads of 64, causal) and at head_dim 128 (16 heads, 2,048
     tokens): the kernels' f32 o, lse, dq, dk and dv within
     ``FLASH_TOL`` of their plain versions (the einsum path in the
     kernels' layouts; gap = norm of the difference over the plain
     one's), two backward calls equal to the bit, one launch counted a
     call (the kernels' line gives the launches of the paths above,
     ``launches``/``bwd_launches``, and each path's apart as the other
     rows do: the LM path 11a, 11f and 11h, 12b, 14b, 15, 16, 17, 18);
     the forward's and the backward's ms (CUDA events) beside the
     causal FLOPs at 989.4 TFLOP/s, the MMA FLOPs the design runs
     (the three-term splits), the plain versions' ms and, as a
     yardstick only, ``scaled_dot_product_attention``'s (never called
     by the port).  ``--phases 19`` runs phase 19 alone.
 20. the Mamba2 SSD's chunked-scan kernels (B14, ``kernels/ssd.py``)
     through ``ssd_chunked``'s autograd Function at zamba2-2.7b's layer
     of 17c (4 x 2,048 tokens, 80 heads of 64, state 64, chunk 64) and
     granite-4.0-h-small's of the benchmark cell (2 x 8,192 tokens, 128
     heads of 64, state 128, chunk 256), with a nonzero h0 and a
     gradient of h_final: the six gradients, the in-chunk cumsum Acs, and
     y and h_final of the plain forward fed the kernels' Acs, each within
     its limit in ``SSD_TOL`` of the plain form's (``ssd_fwd_plain`` and
     its autograd on the card; gap = norm of the difference over the
     plain one's; y and h_final against the plain form's own cumsum
     printed), two calls equal to the bit, one launch counted a call
     each way; the forward's and the backward's ms (CUDA events) beside
     their bytes at 3.35 TB/s and the plain form's ms.  The kernels' line
     gives B14's launches of the paths above (17c-e: zamba2's Mamba2
     layers; phase 17 gates that every chunked SSD of 17c's arms took
     the kernels and that 17d's chunked prefill launched the forward).
     ``--phases 20`` runs phase 20 alone.

The CUDA caching allocator runs with ``expandable_segments:True`` (set
in ``PYTORCH_CUDA_ALLOC_CONF`` unless the caller set it): phase 15's
dense_adam arm peaks within 3 GB of the card's memory, and blocks that
earlier phases left cut into pieces would not hold it; phase 16's
internvl2-2b arms hold about 45 GB.

Phase 2 also holds B3's bf16 branch to its plain version (bit-equal on a
CPU copy; within one bf16 ulp plus the f32 collision envelope of the
plain version on the card, whose index_add_ sums in atomic order), and
phase 5 times it at the dense path's shapes.  Each phase prints its wall
time.  It prints the kernels' JSON line (each path's launches beside the
total: ``launches_dp_path`` is phase 12's, ``launches_sharded_path``
phase 13's, ``launches_placement_path`` phase 14's,
``launches_a14b_path`` phase 15's, ``launches_a14b_part3_path``
phase 16's, ``launches_a14b_part4_path`` phase 17's,
``launches_slice17_path`` phase 18's; B3's row also its
times at whisper's, internvl2's, rwkv6's and zamba2's tables), the
card's name and power limit and, last, ``{"ok": true, "device":
{...}}``.  With no card it prints no result and exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

VOCAB, D_MODEL = 151_936, 896      # src/repro/configs/qwen2_0_5b.py:10-12
BATCH, SEQ = 8, 2_048              # ids per step: 16,384
STEPS, SERVE_STEPS, STREAM_STEPS = 20, 10, 3
TOKENS = 1_024                     # phase 6: targets a step
DENSE_LR = 3e-5                    # phase 6: at LR the loss rises (6d)
ZIPF_A = 1.1
LR = 3e-4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
COLLISION_ATOL = 2e-5              # reference envelope, tests/test_backends.py:207
WITNESS_TOL = dict(rtol=1e-4, atol=1e-5)   # phase 3b: tiled vs plain xla


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def clone(xs):
    return [None if x is None else x.clone() for x in xs]


def errs(want, got) -> list:
    """Max absolute difference of each output (None where both are
    None)."""
    out = []
    for a, b in zip(want, got):
        if (a is None) != (b is None):
            raise AssertionError("one side returned None")
        out.append(None if a is None else
                   float((a - b).abs().max()) if a.numel() else 0.0)
    return out


def max_err(want, got) -> float:
    return max(e for e in errs(want, got) if e is not None)


def zipf_ids(rng: np.random.RandomState, steps: int) -> list:
    k = BATCH * SEQ
    return [((rng.zipf(ZIPF_A, k) - 1) % VOCAB).astype(np.int32)
            for _ in range(steps)]


def kernel_counts():
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_adam_tiled import cs_adam_tiled
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_bf16)
    from repro_torch.kernels.cs_query import cs_query
    from repro_torch.kernels.cs_update import bucket_csr, cs_update
    from repro_torch.kernels.flash_attn import flash_attn_bwd, flash_attn_fwd
    from repro_torch.kernels.ssd import ssd_bwd, ssd_fwd
    return {"cs_adam_tiled": cs_adam_tiled, "cs_adam_fused": cs_adam_fused,
            "cs_ema_tiled": cs_ema_tiled,
            "cs_ema_tiled_bf16": cs_ema_tiled_bf16, "cs_query": cs_query,
            "cs_update": cs_update, "bucket_csr": bucket_csr,
            "flash_attn_fwd": flash_attn_fwd,
            "flash_attn_bwd": flash_attn_bwd, "ssd_fwd": ssd_fwd,
            "ssd_bwd": ssd_bwd}


def reset_counts() -> None:
    for fn in kernel_counts().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counts().items()}


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev, seed: int) -> None:
    import torch
    from repro_torch.core import sketch as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_adam_tiled import (cs_adam_tiled,
                                                   cs_adam_tiled_plain)
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(lr=1e-2, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002)

    def state(depth, width, d, track_m):
        M = torch.randn((depth, width, d), generator=gen, device=dev) \
            if track_m else None
        V = torch.randn((depth, width, d), generator=gen, device=dev).abs()
        return M, V

    for track_m in (True, False):
        b1 = 0.9 if track_m else 0.0
        tag = f"b1={b1}"
        # B1, collision-free: identity hashing, unique ids
        spec = cs.for_param((4_096, D_MODEL), identity=True)
        M, V = state(3, spec.width, D_MODEL, track_m)
        ids = torch.randperm(spec.width, generator=gen, device=dev)[:2_048]
        fam = spec.family
        b, s = fam.bucket(ids.to(torch.int32)), fam.sign(ids)
        g = torch.randn((2_048, D_MODEL), generator=gen, device=dev)
        args = (M, V, b if track_m else None, s if track_m else None, b, g)
        want = cs_adam_tiled_plain(*clone(args), b1=b1, n_valid=2_040, **kw)
        got = cs_adam_tiled(*clone(args), b1=b1, n_valid=2_040, **kw)
        torch.cuda.synchronize()
        bit = all(a is None or torch.equal(a, c) for a, c in zip(want, got))
        log(f"phase 2: B1 cs_adam_tiled collision-free k=2048 d={D_MODEL} "
            f"{tag}: bit_equal={bit} max_abs_err (M, V, upd) "
            f"{errs(want, got)}")
        if not bit:
            raise AssertionError("B1 is not bit-equal on a collision-free "
                                 "batch")
        # B1, heavy collisions: width 16, k 32
        M, V = state(3, 16, D_MODEL, track_m)
        bm = torch.randint(0, 16, (3, 32), generator=gen, device=dev,
                           dtype=torch.int32)
        bv = torch.randint(0, 16, (3, 32), generator=gen, device=dev,
                           dtype=torch.int32)
        sm = torch.randint(0, 2, (3, 32), generator=gen, device=dev
                           ).float() * 2 - 1
        g = torch.randn((32, D_MODEL), generator=gen, device=dev)
        args = (M, V, bm if track_m else None, sm if track_m else None, bv, g)
        want = cs_adam_tiled_plain(*clone(args), b1=b1, n_valid=29, **kw)
        got = cs_adam_tiled(*clone(args), b1=b1, n_valid=29, **kw)
        again = cs_adam_tiled(*clone(args), b1=b1, n_valid=29, **kw)
        host = cs_adam_tiled_plain(*on_cpu(args), b1=b1, n_valid=29, **kw)
        err = max_err(want, got)
        same = all(a is None or torch.equal(a, c) for a, c in zip(got, again))
        log(f"phase 2: B1 cs_adam_tiled collisions width=16 k=32 {tag}: "
            f"{b1_vs_cpu(host, got)}; max_abs_err (M, V, upd) vs the plain "
            f"version on the card {errs(want, got)} (atol {COLLISION_ATOL}); "
            f"a second run equal to the bit {same}")
        if not (err <= COLLISION_ATOL and same
                and torch.equal(want[2], got[2])):
            raise AssertionError(f"B1 under collisions: {err}, second run "
                                 f"equal {same}")
        # B2 against the per-item plain version, k=512, real hashing
        spec_m = cs.for_param((VOCAB, D_MODEL), signed=True, seed=seed + 1)
        spec_v = cs.for_param((VOCAB, D_MODEL), signed=False, seed=seed + 2)
        M, V = state(3, spec_v.width, D_MODEL, track_m)
        ids = torch.from_numpy(zipf_ids(np.random.RandomState(seed), 1)[0]
                               [:512]).to(dev)
        g = torch.randn((512, D_MODEL), generator=gen, device=dev)
        args = (M, V, spec_m.family.bucket(ids) if track_m else None,
                spec_m.family.sign(ids) if track_m else None,
                spec_v.family.bucket(ids), g)
        want = ref.adam_fused_ref(*clone(args), b1=b1, **kw)
        got = cs_adam_fused(*clone(args), b1=b1, **kw)
        torch.cuda.synchronize()
        bit = all(a is None or torch.equal(a, c) for a, c in zip(want, got))
        log(f"phase 2: B2 cs_adam_fused k=512 d={D_MODEL} "
            f"({len(set(ids.tolist()))} unique ids) {tag}: bit_equal={bit} "
            f"max_abs_err (M, V, upd) {errs(want, got)}")
        if not bit:
            raise AssertionError("B2 is not bit-equal to adam_fused_ref")


def b1_vs_cpu(host, got) -> str:
    """Hold B1's (M, V, upd) to a CPU copy's: M and V to the bit; upd to
    the bit or within rtol 1e-6, for torch's CPU f32 sqrt, which is not
    always correctly rounded (the values apart are counted and printed).
    Returns the line's text."""
    import torch
    for name, a, c in zip(("M", "V"), host[:2], got[:2]):
        if a is not None and not torch.equal(a, c.cpu()):
            raise AssertionError(f"B1's {name} is not bit-equal to a CPU copy "
                                 f"(max_abs_err {max_err([a], [c.cpu()])})")
    upd = got[2].cpu()
    differ = int((upd != host[2]).sum())
    rel = float(((upd - host[2]).abs() / host[2].abs()).nan_to_num().max())
    torch.testing.assert_close(upd, host[2], rtol=1e-6, atol=0.0)
    return (f"M and V bit-equal to a CPU copy; upd {differ} of "
            f"{upd.numel()} values apart from it, max rel diff {rel} "
            f"(torch's CPU sqrt)")


def phase_full_width_b1_b4(dev, seed: int) -> None:
    """B1 as the ``tiled`` path calls it (``ops.adam_rows_tiled``: dedup,
    addressing, B1 with its per-position output) on a full-width zipf
    batch into ``SketchHParams()`` sketches with random moments, against
    the same call on a CPU copy; two runs on the card equal to the bit.
    B4 on the same batch into the same sketch, bit-equal to
    ``ref.cs_query_ref``."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.cs_query import cs_query
    hp = SketchHParams()
    spec_m = hp.spec("sparse_embedding", (VOCAB, D_MODEL), signed=True)
    spec_v = hp.spec("sparse_embedding", (VOCAB, D_MODEL), signed=False)
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    M = torch.randn(spec_m.shape, generator=gen, device=dev) * 1e-3
    V = torch.rand(spec_v.shape, generator=gen, device=dev) * 1e-6
    ids = torch.from_numpy(zipf_ids(np.random.RandomState(seed + 7), 1)[0]
                           ).to(dev)
    g = torch.randn((ids.numel(), D_MODEL), generator=gen, device=dev) * 1e-3
    kw = dict(lr=-1.0, b1=0.9, b2=0.999, eps=1e-8)
    got = ops.adam_rows_tiled(spec_m, spec_v, M.clone(), V.clone(), ids, g,
                              STEPS, **kw)
    again = ops.adam_rows_tiled(spec_m, spec_v, M.clone(), V.clone(), ids, g,
                                STEPS, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    host = ops.adam_rows_tiled(spec_m, spec_v, *on_cpu([M, V, ids, g]),
                               STEPS, **kw)
    line = b1_vs_cpu(host, got)
    log(f"phase 2: B1 as the tiled path calls it, {ids.numel()} zipf ids "
        f"({len(set(ids.tolist()))} unique) into {spec_m.shape} sketches: "
        f"{line}; a second run equal to the bit {same}")
    if not same:
        raise AssertionError("two runs of the tiled path differ")
    del got, again, host
    b, s = spec_m.family.bucket(ids), spec_m.family.sign(ids)
    for signed in (True, False):
        out = cs_query(M if signed else V, b, s if signed else None)
        if not torch.equal(out, ref.cs_query_ref(M if signed else V, b,
                                                  s if signed else None)):
            raise AssertionError(f"B4 at full width is not bit-equal, "
                                 f"signed={signed}")
    log(f"phase 2: B4 cs_query k={ids.numel()} into {spec_m.shape}, signed "
        f"and unsigned: bit-equal to ref.cs_query_ref")


def hazard_buckets(k: int, dists, dev):
    """Row r puts item i in bucket i % dists[r]: each item's last earlier
    item in its bucket is exactly dists[r] places back."""
    import torch
    i = torch.arange(k, device=dev)
    return torch.stack([i % dd for dd in dists]).to(torch.int32).contiguous()


def phase_csr_and_hazards(dev, seed: int) -> None:
    """The CSR kernel integer-equal to the plain ``bucket_csr`` (order,
    starts and prev); B5 on one run of all k items (width 1) and with d
    not a multiple of 4, bit-equal to a CPU copy; B2 bit-equal to its
    plain version where a bucket recurs 1, L-1, L and L+1 items back (L
    its window), and with k below one tile."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import cs_adam, ops, ref
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_update import (bucket_csr, bucket_csr_plain,
                                               bucket_prev, cs_update)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    spec = SketchHParams().spec("sparse_embedding", (VOCAB, D_MODEL),
                                signed=True)
    ids = torch.from_numpy(zipf_ids(np.random.RandomState(seed), 1)[0]
                           ).to(dev)
    cases = {
        "zipf ids at full width": (spec.family.bucket(ids), spec.width),
        "dense rows (151,936)": (ops._cached_addressing(spec, VOCAB, dev)[0],
                                 spec.width),
        "width 1": (torch.zeros((3, 4_000), dtype=torch.int32, device=dev),
                    1),
        "one bucket": (torch.full((3, 4_000), 5, dtype=torch.int32,
                                  device=dev), 64),
        "last buckets": (torch.randint(spec.width - 2, spec.width, (3, 4_000),
                                       generator=gen, device=dev,
                                       dtype=torch.int32), spec.width),
        "k=0": (torch.zeros((3, 0), dtype=torch.int32, device=dev),
                spec.width),
    }
    for tag, (b, width) in cases.items():
        got = (*bucket_csr(b, width), bucket_prev(b, width))
        want = bucket_csr_plain(b, width)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(want, got)):
            raise AssertionError(f"bucket_csr kernel differs from the plain "
                                 f"form, {tag}")
    for width, d in ((1, D_MODEL), (spec.width, 893), (2, 893)):
        S = torch.randn((3, width, d), generator=gen, device=dev)
        b = spec.family.bucket(ids[:4_000]) % width
        s = spec.family.sign(ids[:4_000])
        x = torch.randn((4_000, d), generator=gen, device=dev)
        got = cs_update(S.clone(), b, s, x)
        if not torch.equal(ref.cs_update_ref(*on_cpu([S, b, s, x])),
                           got.cpu()):
            raise AssertionError(f"B5 width={width} d={d} is not bit-equal "
                                 f"to its plain version on a CPU copy")
    kw = dict(lr=1e-2, b2=0.999, eps=1e-8, bc1=0.19, bc2=0.002)
    window = cs_adam.WINDOW
    dists = [1, window - 1, window, window + 1]
    for k in (5, 300):
        for track_m in (True, False):
            depth = len(dists)
            M = torch.randn((depth, 64, D_MODEL), generator=gen,
                            device=dev) if track_m else None
            V = torch.randn((depth, 64, D_MODEL), generator=gen,
                            device=dev).abs()
            bm = hazard_buckets(k, dists, dev)
            sm = torch.randint(0, 2, (depth, k), generator=gen,
                               device=dev).float() * 2 - 1
            bv = hazard_buckets(k, dists[::-1], dev)
            g = torch.randn((k, D_MODEL), generator=gen, device=dev)
            args = (M, V, bm if track_m else None, sm if track_m else None,
                    bv, g)
            b1 = 0.9 if track_m else 0.0
            want = ref.adam_fused_ref(*clone(args), b1=b1, **kw)
            got = cs_adam_fused(*clone(args), b1=b1, **kw)
            torch.cuda.synchronize()
            if not all(a is None or torch.equal(a, c)
                       for a, c in zip(want, got)):
                raise AssertionError(
                    f"B2 k={k} b1={b1} distances {dists}: not bit-equal, "
                    f"max_abs_err {errs(want, got)}")
    log(f"phase 2: bucket_csr kernel integer-equal to the plain form "
        f"(order, starts, prev) on {len(cases)} cases ({', '.join(cases)}); "
        f"B5 bit-equal to a CPU copy at width 1 (one run of 4,000 items), "
        f"at d=893 (scalar path) and at width 2, d=893 (long runs, scalar); "
        f"B2 bit-equal to adam_fused_ref where a bucket recurs "
        f"{dists} items back (window {window}), k 5 and 300, b1 0.9 and 0")


EMA_FORMS = {"adam": (0.999, 1.0 - 0.999), "adagrad": (1.0, 1.0),
             "momentum": (0.9, 1.0)}


def on_cpu(xs):
    return [None if x is None else x.cpu() for x in xs]


def phase_sketch_kernels(dev, seed: int) -> None:
    """B3, B4 and B5 against their plain versions at d_model width."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    from repro_torch.kernels.cs_query import cs_query
    from repro_torch.kernels.cs_update import cs_update
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    k = 2_048

    def case(signed, width, collision_free):
        S = torch.randn((3, width, D_MODEL), generator=gen, device=dev)
        if collision_free:
            b = torch.randperm(width, generator=gen, device=dev)[:k].to(
                torch.int32)[None].expand(3, k).contiguous()
        else:
            b = torch.randint(0, width, (3, k), generator=gen, device=dev,
                              dtype=torch.int32)
        s = (torch.randint(0, 2, (3, k), generator=gen, device=dev).float()
             * 2 - 1) if signed else None
        x = torch.randn((k, D_MODEL), generator=gen, device=dev)
        mask = (torch.rand((k, 1), generator=gen, device=dev) > 0.3).float()
        return (S if signed else S.abs()), b, s, x, mask

    worst = 0.0
    for signed in (True, False):
        for form, (beta, scale) in EMA_FORMS.items():
            for masked in (False, True):
                for width, free in ((4_096, True), (64, False)):
                    S, b, s, x, mask = case(signed, width, free)
                    m = mask if masked else None
                    want = cs_ema_tiled_plain(S.clone(), b, s, x, m,
                                              beta=beta, scale=scale)
                    got = cs_ema_tiled(S.clone(), b, s, x, m, beta=beta,
                                       scale=scale)
                    torch.cuda.synchronize()
                    tag = (f"signed={signed} {form} mask={masked} "
                           f"width={width}")
                    if free:
                        if not all(torch.equal(a, c)
                                   for a, c in zip(want, got)):
                            raise AssertionError(f"B3 not bit-equal on a "
                                                 f"collision-free batch, {tag}")
                        continue
                    err = max_err(want, got)
                    worst = max(worst, err)
                    host = cs_ema_tiled_plain(*on_cpu([S, b, s, x, m]),
                                              beta=beta, scale=scale)
                    if not (err <= COLLISION_ATOL and all(
                            torch.equal(a, c.cpu())
                            for a, c in zip(host, got))):
                        raise AssertionError(f"B3 under collisions, {tag}: "
                                             f"max_abs_err {err}")
    log(f"phase 2: B3 cs_ema_tiled k={k} d={D_MODEL}, signed and unsigned x "
        f"3 ema_delta forms x mask on/off: bit-equal on collision-free "
        f"batches (width 4096); width 64 (32 rows a bucket): max_abs_err "
        f"(S, est) {worst} vs the plain version on the card (atol "
        f"{COLLISION_ATOL}), bit-equal to it on a CPU copy")
    for signed in (True, False):
        S, b, s, _, _ = case(signed, 512, False)
        if not torch.equal(cs_query(S, b, s), ref.cs_query_ref(S, b, s)):
            raise AssertionError(f"B4 not bit-equal, signed={signed}")
        for width, free in ((4_096, True), (64, False)):
            S, b, s, x, _ = case(signed, width, free)
            want = ref.cs_update_ref(S.clone(), b, s, x)
            got = cs_update(S.clone(), b, s, x)
            torch.cuda.synchronize()
            err = float((want - got).abs().max())
            host = ref.cs_update_ref(*on_cpu([S, b, s, x]))
            ok = err == 0.0 if free else (err <= COLLISION_ATOL and
                                          torch.equal(host, got.cpu()))
            if not ok:
                raise AssertionError(f"B5 signed={signed} width={width}: "
                                     f"max_abs_err {err}")
    log(f"phase 2: B4 cs_query k={k} width 512 bit-equal; B5 cs_update "
        f"bit-equal collision-free, within atol {COLLISION_ATOL} at width 64 "
        f"and bit-equal to the plain version on a CPU copy (signed and "
        f"unsigned)")


def bf16_within(got, want, atol: float) -> bool:
    """Every bf16 cell within one bf16 ulp of ``want`` plus ``atol``."""
    import torch
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8)
    return bool(((g - w).abs() <= ulp + atol).all())


def phase_bf16_kernel(dev, seed: int) -> None:
    """B3's bf16 branch against its plain version: signed and unsigned,
    collision-free (identity buckets) and colliding (width 16).  Bit-equal
    to the plain version on a CPU copy (bf16 cells and ``est``); on the
    card ``est`` is bit-equal and the cells within one bf16 ulp plus the
    f32 collision envelope (the plain version's index_add_ sums each
    cell's increments in atomic order, and a rounding may then flip)."""
    import torch
    from repro_torch.core import quantize as qz
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    k, sr = 2_048, qz.step_seed(seed, 7)
    report = []
    for signed in (True, False):
        for width, free in ((4_096, True), (16, False)):
            S = torch.randn((3, width, D_MODEL), generator=gen, device=dev)
            S = (S if signed else S.abs()).to(torch.bfloat16)
            if free:
                b = torch.randperm(width, generator=gen, device=dev)[:k].to(
                    torch.int32)[None].expand(3, k).contiguous()
            else:
                b = torch.randint(0, width, (3, k), generator=gen,
                                  device=dev, dtype=torch.int32)
            s = (torch.randint(0, 2, (3, k), generator=gen, device=dev
                               ).float() * 2 - 1) if signed else None
            x = torch.randn((k, D_MODEL), generator=gen, device=dev)
            mask = (torch.rand((k, 1), generator=gen, device=dev) > 0.3
                    ).float()
            kw = dict(beta=0.999, scale=1.0 - 0.999, sr_seed=sr)
            got = cs_ema_tiled(S.clone(), b, s, x, mask, **kw)
            want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
            torch.cuda.synchronize()
            host = cs_ema_tiled_plain(*on_cpu([S, b, s, x, mask]), **kw)
            tag = f"signed={signed} width={width}"
            if not (torch.equal(host[0].view(torch.int16),
                                got[0].cpu().view(torch.int16))
                    and torch.equal(host[1], got[1].cpu())):
                raise AssertionError(f"B3 bf16 not bit-equal to its plain "
                                     f"version on a CPU copy, {tag}")
            differ = int((want[0].view(torch.int16)
                          != got[0].view(torch.int16)).sum())
            if not torch.equal(want[1], got[1]) or (
                    free and differ) or not bf16_within(got[0], want[0],
                                                        COLLISION_ATOL):
                raise AssertionError(f"B3 bf16 against the plain version "
                                     f"on the card, {tag}: {differ} cells "
                                     f"differ")
            report.append(f"{tag}: {differ} of {S.numel()} cells differ")
    log(f"phase 2: B3 cs_ema_tiled bf16 k={k} d={D_MODEL}, Adam form, mask "
        f"on: bit-equal (cells and est) to the plain version on a CPU copy "
        f"in all four cases; against it on the card est bit-equal, cells "
        f"within one bf16 ulp + {COLLISION_ATOL}: {'; '.join(report)}")


# ---------------------------------------------------------------- phase 3
def run_steps(step_fn, table, target, state, batches, dev):
    """Drive ``step_fn`` over ``batches``; returns (table, state, losses,
    per-step ms)."""
    import torch
    losses, events = [], []
    for ids_np in batches:
        ids = torch.from_numpy(ids_np).to(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        idx = ids.long()
        rows = table[idx] - target[idx]
        losses.append(torch.mean(rows * rows))
        table, state = step_fn(table, state, ids, rows)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return (table, state, [float(x) for x in losses],
            [s.elapsed_time(e) for s, e in events])


def phase_main(dev, seed: int):
    import torch
    from repro_torch import kernels
    from repro_torch.core.optimizers import SketchHParams, adam
    from repro_torch.train.steps import make_sparse_embedding_step
    hp = SketchHParams()
    backend = kernels.resolve_backend(hp.backend, dev)
    if backend != "tiled":
        raise AssertionError(f"auto resolved to {backend!r} on the card")
    init_fn, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, hparams=hp, device=dev)
    table0 = init_fn(torch.Generator(device=dev).manual_seed(seed))
    target = init_fn(torch.Generator(device=dev).manual_seed(seed + 1))
    table = table0.clone()
    state = opt.init()
    log(f"phase 3: table {tuple(table.shape)} f32 {table.numel() * 4} B; "
        f"sketches m {tuple(state['m'].shape)} v {tuple(state['v'].shape)} "
        f"{state['v'].numel() * 4} B each; backend auto -> {backend}")
    batches = zipf_ids(np.random.RandomState(seed), STEPS)
    held = torch.from_numpy(batches[0]).to(dev).long()
    fresh = torch.from_numpy(zipf_ids(np.random.RandomState(seed + 99), 1)[0]
                             ).to(dev).long()

    def loss_on(idx, tab=None) -> float:
        rows = (table if tab is None else tab)[idx] - target[idx]
        return float(torch.mean(rows * rows))

    held_before, fresh_before = loss_on(held), loss_on(fresh)
    torch.cuda.synchronize()
    reset_counts()
    table, state, losses, ms = run_steps(step_fn, table, target, state,
                                         batches, dev)
    counts = read_counts()
    held_after, fresh_after = loss_on(held), loss_on(fresh)
    uniq = [int(np.unique(b).size) for b in batches]
    log(f"phase 3: {STEPS} steps x {BATCH * SEQ} ids; unique ids per step "
        f"{uniq}")
    log(f"phase 3: ms/step median of steps 2..{STEPS}: "
        f"{statistics.median(ms[1:])} (first step {ms[0]}); all {ms}")
    log(f"phase 3: loss on the first batch's ids before {held_before} "
        f"after {held_after}; on a fresh zipf batch before {fresh_before} "
        f"after {fresh_after}")
    log(f"phase 3: per-step batch loss (not required to fall) {losses}")
    log(f"phase 3: kernel launches {counts}")
    if counts["cs_adam_tiled"] != STEPS or counts["cs_update"] != STEPS \
            or counts["bucket_csr"] != STEPS:
        raise AssertionError(f"the main path did not launch B1, its CSR and "
                             f"the dedup sum (B5) once a step: {counts}")
    if not held_after < held_before:
        raise AssertionError("the loss did not fall")
    if not (torch.isfinite(table).all() and torch.isfinite(state["m"]).all()
            and torch.isfinite(state["v"]).all()):
        raise AssertionError("non-finite table or sketch")
    phase_witness(dev, table0, target, batches, table, losses)
    phase_repeat(dev, step_fn, opt, table0, target, batches, table, state,
                 losses)
    phase_dense_vs_sparse(dev, table0, target, batches, table, losses)
    dense_table = run_dense(adam(LR), table0, target, batches, dev)[0]
    log(f"phase 3e: dense Adam (optimizers.adam, lr {LR}) on the same "
        f"{STEPS} batches: loss on the first batch's ids {held_before} -> "
        f"{loss_on(held, dense_table)}, on a fresh zipf batch "
        f"{fresh_before} -> {loss_on(fresh, dense_table)}; CS-Adam (phase "
        f"3): {held_before} -> {held_after}, {fresh_before} -> "
        f"{fresh_after}")
    del table0, dense_table
    more = zipf_ids(np.random.RandomState(seed + 30), 5)
    table, state, _, _ = profile_steps(
        "phase 3c", lambda: run_steps(step_fn, table, target, state, more,
                                      dev), statistics.median(ms[1:]),
        by_name=True)
    return (table, target, state, batches[-1], counts,
            (held_before, held_after))


def phase_witness(dev, table0, target, batches, tiled_table, tiled_losses):
    """The main path's batches from its initial table through the plain
    ``xla`` backend: the per-batch losses and the table must agree with
    the ``tiled`` run (B1's atomics reorder colliding adds)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.steps import make_sparse_embedding_step
    _init, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, device=dev,
        hparams=SketchHParams(backend="xla"))
    table, _state, losses, ms = run_steps(step_fn, table0.clone(), target,
                                          opt.init(), batches, dev)
    rel = max(abs(a - b) / abs(b) for a, b in zip(tiled_losses, losses))
    err = float((table - tiled_table).abs().max())
    bit = losses == tiled_losses and torch.equal(table, tiled_table)
    log(f"phase 3b: plain xla, same {len(batches)} batches at full width: "
        f"ms/step median {statistics.median(ms[1:])}; per-step batch loss "
        f"{losses}")
    log(f"phase 3b: tiled vs plain xla: per-batch loss max rel diff {rel}, "
        f"table max_abs_err {err} (rtol {WITNESS_TOL['rtol']}, atol "
        f"{WITNESS_TOL['atol']}); losses and table equal to the bit {bit}")
    torch.testing.assert_close(torch.tensor(tiled_losses),
                               torch.tensor(losses), rtol=WITNESS_TOL["rtol"],
                               atol=0.0)
    torch.testing.assert_close(tiled_table, table, **WITNESS_TOL)


def phase_repeat(dev, step_fn, opt, table0, target, batches, table, state,
                 losses):
    """3f: phase 3's batches again from the same start: the table, both
    sketches and the losses must be phase 3's to the bit.  Then one more
    step of that copy under ``torch.cuda.set_sync_debug_mode("error")``:
    a step that waited for the device would raise."""
    import torch
    t2, s2, losses2, _ = run_steps(step_fn, table0.clone(), target,
                                   opt.init(), batches, dev)
    same = {"table": torch.equal(table, t2),
            "m": torch.equal(state["m"], s2["m"]),
            "v": torch.equal(state["v"], s2["v"]),
            "losses": losses == losses2}
    log(f"phase 3f: phase 3's {len(batches)} tiled steps again from the "
        f"same start: equal to the bit {same}")
    if not all(same.values()):
        raise AssertionError(f"two runs of the tiled steps differ: {same}")
    ids = torch.from_numpy(batches[0]).to(dev)
    rows = t2[ids.long()] - target[ids.long()]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_fn(t2, s2, ids, rows)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("phase 3f: one tiled step under torch.cuda.set_sync_debug_mode("
        "'error'): no host-device synchronisation")


def run_dense(opt, table0, target, batches, dev):
    """The main path's batches from ``table0`` as dense gradients: each
    step's rows ``table[ids] - target[ids]`` summed into a zero table.
    Returns (table, per-batch losses)."""
    import torch
    from repro_torch.core.optimizers import apply_updates
    params = {"table": table0.clone()}
    state = opt.init(params)
    losses = []
    for ids_np in batches:
        idx = torch.from_numpy(ids_np).to(dev).long()
        rows = params["table"][idx] - target[idx]
        losses.append(torch.mean(rows * rows))
        grad = torch.zeros_like(params["table"]).index_add_(0, idx, rows)
        updates, state = opt.update({"table": grad}, state)
        apply_updates(params, updates)
    torch.cuda.synchronize()
    return params["table"], [float(x) for x in losses]


def phase_dense_vs_sparse(dev, table0, target, batches, tiled_table,
                          tiled_losses):
    """The main path's batches as dense gradients through
    ``adam_from_stores`` with the main path's stores pinned to ``auto``
    (B3): the same step as the sparse-rows path, so the same table."""
    import torch
    from repro_torch.core.optimizers import SketchHParams, adam_from_stores
    from repro_torch.core.stores import StoreTree
    from repro_torch.train.steps import sparse_embedding_stores
    m_store, v_store = sparse_embedding_stores(VOCAB, D_MODEL,
                                               hparams=SketchHParams())
    tree = StoreTree(rules=(("table", m_store, v_store),)).with_backend(
        "auto")
    before = read_counts()["cs_ema_tiled"]
    table, losses = run_dense(adam_from_stores(LR, tree), table0, target,
                              batches, dev)
    launches = read_counts()["cs_ema_tiled"] - before
    rel = max(abs(a - b) / abs(b) for a, b in zip(tiled_losses, losses))
    err = float((table - tiled_table).abs().max())
    log(f"phase 3d: the same {len(batches)} batches as dense gradients "
        f"through adam_from_stores (B3 x{launches}): per-batch loss max rel "
        f"diff {rel}, table max_abs_err {err} vs the sparse-rows tiled run")
    if launches != 2 * len(batches):
        raise AssertionError(f"the dense check launched B3 {launches} times")
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor(tiled_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    torch.testing.assert_close(table, tiled_table, **WITNESS_TOL)


def kernel_profile(run):
    """``run()``, which synchronises, under ``torch.profiler``.  Returns
    (its result, wall ms, [(device ms, launches, name)] of every device
    operation, most time first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    # device activity only: the host's operator events would multiply the
    # events to gather (a zamba2 step launches about 61,000 kernels)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        # a profiler span (``obs.profiling.scope``) also shows on the
        # device, as the time between its first and last kernel: not work
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False) \
                or evt.key.startswith("obs."):
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        kernels.append((us / 1e3, evt.count, evt.key))
    kernels.sort(reverse=True)
    return out, wall_ms, kernels


def profile_steps(tag: str, run, step_ms: float, n: int = 5,
                  by_name: bool = False):
    """``run()``, which drives ``n`` steps and synchronises, under
    ``torch.profiler``: the device's busy time a step, its launches (device
    operations) a step, and the kernels that take the time (with
    ``by_name``, every kernel's launches a step).  The idle share is taken
    against ``step_ms``, the unprofiled step time, since the profiler slows
    the host.  Returns ``run()``'s result."""
    t0 = time.perf_counter()
    out, wall_ms, kernels = kernel_profile(run)
    log(f"{tag}: the profiled run and its events took "
        f"{time.perf_counter() - t0:.1f} s")
    busy_ms = sum(k[0] for k in kernels)
    if busy_ms <= 0.0:
        log(f"{tag}: device busy time not measured (the profiler saw no "
            f"CUDA kernels)")
        return out
    launches = sum(k[1] for k in kernels)
    log(f"{tag}: {n} steps under torch.profiler: wall {wall_ms} ms, "
        f"device busy {busy_ms} ms ({busy_ms / n} ms a step); idle share "
        f"{1.0 - busy_ms / n / step_ms} against the unprofiled step of "
        f"{step_ms} ms ({1.0 - busy_ms / wall_ms} with the profiler on); "
        f"{launches / n} launches a step")
    for ms, count, name in kernels[:10]:
        log(f"{tag}:   {ms} ms  x{count}  {name[:90]}")
    if by_name:
        per_step = {name: count / n for _ms, count, name in kernels}
        log(f"{tag}: launches a step by kernel name {json.dumps(per_step)}")
    return out


# ---------------------------------------------------------------- phase 4
def phase_serve_and_stream(dev, table, target, seed: int):
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.serve.steps import make_online_adapt_step
    from repro_torch.train.steps import make_sparse_embedding_step
    init_state, adapt = make_online_adapt_step(VOCAB, D_MODEL, lr=LR,
                                               device=dev)
    state = init_state()
    if state["m"] is not None:
        raise AssertionError("the serve step keeps a first moment")
    batches = zipf_ids(np.random.RandomState(seed + 10), SERVE_STEPS)
    reset_counts()
    table, state, losses, ms = run_steps(adapt, table, target, state,
                                         batches, dev)
    serve_counts = read_counts()
    log(f"phase 4: serve make_online_adapt_step (b1=0) {SERVE_STEPS} steps: "
        f"ms/step median {statistics.median(ms[1:])}; loss first "
        f"{losses[0]} last {losses[-1]}; launches {serve_counts}")
    if serve_counts["cs_adam_tiled"] != SERVE_STEPS:
        raise AssertionError("the serve path did not launch B1 every step")
    _init, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, device=dev,
        hparams=SketchHParams(backend="stream"))
    # stream applies every occurrence of an id (no dedup, paper Alg. 4),
    # so a zipf head moves far: run it on a copy of the table
    batches = zipf_ids(np.random.RandomState(seed + 20), STREAM_STEPS)
    reset_counts()
    table, state, losses, ms = run_steps(step_fn, table.clone(), target,
                                         opt.init(), batches, dev)
    stream_counts = read_counts()
    log(f"phase 4: backend stream {STREAM_STEPS} steps: ms/step {ms}; loss "
        f"{losses}; launches {stream_counts}")
    if stream_counts["cs_adam_fused"] != STREAM_STEPS:
        raise AssertionError("the stream path did not launch B2 every step")
    if stream_counts["bucket_csr"] != 2 * STREAM_STEPS:
        raise AssertionError("the stream path did not find prev on the "
                             "device (two bucket_csr launches a step)")
    if not torch.isfinite(table).all():
        raise AssertionError("non-finite table after phase 4")
    return stream_counts


def phase_sketch_ops(dev, ids_np, seed: int):
    """The batch sketch ops on one main-path batch: ``ops.sketch_update``
    (B5) adds its rows into a zero (3, 10,240, 896) Count-Sketch and
    ``ops.sketch_query`` (B4) reads the batch back.  Both are held to
    their plain versions to the bit, and the most frequent ids must come
    back close to the sum of their rows (heavy hitters survive the
    sketch).
    Returns (spec, sketch, ids, rows, counts)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops, ref
    spec = SketchHParams().spec("sparse_embedding", (VOCAB, D_MODEL),
                                signed=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    ids = torch.from_numpy(ids_np).to(dev)
    rows = torch.randn((ids.numel(), D_MODEL), generator=gen, device=dev)
    S = torch.zeros(spec.shape, device=dev)
    reset_counts()
    ops.sketch_update(spec, S, ids, rows)
    est = ops.sketch_query(spec, S, ids)
    torch.cuda.synchronize()
    counts = read_counts()
    b, sg = spec.family.bucket(ids), spec.family.sign(ids)
    # the zipf head sums ~1,500 rows into one cell: atomics in the card's
    # index_add_ drift there by many ulps, so B5 is held to its plain
    # version on a CPU copy, which adds in the kernel's order
    plain = ref.cs_update_ref(torch.zeros_like(S), b, sg, rows)
    upd_err = float((plain - S).abs().max())
    host = ref.cs_update_ref(torch.zeros(spec.shape), *on_cpu([b, sg, rows]))
    if not torch.equal(host, S.cpu()):
        raise AssertionError("B5 on the sketch-ops path is not bit-equal to "
                             "its plain version on a CPU copy")
    if not torch.equal(est, ref.cs_query_ref(S, b, sg)):
        raise AssertionError("B4 on the sketch-ops path is not bit-equal")
    uniq, freq = np.unique(ids_np, return_counts=True)
    top = torch.from_numpy(uniq[np.argsort(-freq)[:5]]).to(dev)
    truth = torch.zeros((VOCAB, D_MODEL), device=dev).index_add_(
        0, ids.long(), rows)[top.long()]
    rel = ((ops.sketch_query(spec, S, top) - truth).norm(dim=1)
           / truth.norm(dim=1)).tolist()
    log(f"phase 4: sketch ops on {ids.numel()} ids into {spec.shape}: "
        f"launches {counts}; B5 bit-equal to its plain version on a CPU "
        f"copy (max_abs_err {upd_err} vs it on the card), B4 bit-equal; "
        f"the 5 most frequent ids "
        f"({[int(f) for f in sorted(freq)[-5:][::-1]]} "
        f"times) read back with relative error {rel}")
    if counts["cs_update"] != 1 or counts["cs_query"] != 1 \
            or counts["bucket_csr"] != 1:
        raise AssertionError("the sketch ops did not launch B5 (and its "
                             "CSR) and B4")
    if not max(rel) < 0.5:
        raise AssertionError(f"heavy hitters lost in the sketch: {rel}")
    return spec, S, ids, rows, counts


# ---------------------------------------------------------------- phase 5
def unique_rows(buckets, n_valid: int, width: int) -> int:
    """Distinct (hash row, bucket) pairs among the first n_valid items:
    the sketch rows a step must read and write."""
    import torch
    b = buckets[:, :n_valid].long()
    rows = torch.arange(b.shape[0], device=b.device)[:, None]
    return int((b + width * rows).unique().numel())


def b1_bytes(d: int, k: int, k_u: int, rows_m: int, rows_v: int,
             depth: int, track_m: bool) -> int:
    """B1's bytes, each input read once and each output written once: the
    live gradient rows read, the output rows written, the touched M and V
    rows read and written, the live slots' addressing (M's buckets and
    signs with a first moment, V's buckets), inv, first_pos, n_valid."""
    return (4 * d * (k_u + k) + 4 * d * 2 * (rows_m + rows_v)
            + 4 * ((3 if track_m else 1) * depth * k_u + 2 * k + 1))


def longest_chain(buckets) -> int:
    """The most items of one hash row in one bucket: the longest chain of
    items that B2 must run in order through one cell."""
    import torch
    return int(max(torch.unique(row, return_counts=True)[1].max()
                   for row in buckets)) if buckets.numel() else 0


def phase_times(dev, table, target, state, ids_np, seed: int,
                sketch_ops) -> list:
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import dedup as dd, ops, ref
    from repro_torch.kernels.cs_adam import cs_adam_fused
    from repro_torch.kernels.cs_adam_tiled import (at_positions,
                                                   cs_adam_tiled,
                                                   cs_adam_tiled_plain)
    from repro_torch.kernels.cs_update import bucket_prev
    from repro_torch.train.steps import sparse_embedding_stores
    m_store, v_store = sparse_embedding_stores(VOCAB, D_MODEL,
                                               hparams=SketchHParams())
    spec_m, spec_v = m_store.spec, v_store.spec
    ids = torch.from_numpy(ids_np).to(dev)
    rows = table[ids.long()] - target[ids.long()]
    eta, bc1, bc2 = ops._adam_hypers(STEPS, -1.0, 0.9, 0.999)
    kw = dict(lr=eta, b1=0.9, b2=0.999, eps=1e-8, bc1=bc1, bc2=bc2)
    out = []
    # B1 at the inputs the tiled backend gives it
    batch = dd.dedup_rows(ids, rows)
    bm, sm, bv = ops._adam_addressing(spec_m, spec_v, batch.unique_ids)
    k_u = int(batch.n_unique)
    pos = (batch.inv, batch.first_pos)
    args = (state["m"], state["v"], bm, sm, bv, batch.rows)
    b1kw = dict(n_valid=batch.n_unique, positions=pos, **kw)
    want = cs_adam_tiled_plain(*clone(args), n_valid=batch.n_unique, **kw)
    got = cs_adam_tiled(*clone(args), **b1kw)
    err = max_err(want[:2], got[:2])
    upd_bit = torch.equal(at_positions(want[2], batch.first_pos), got[2])
    host = cs_adam_tiled(*on_cpu(args), n_valid=batch.n_unique.cpu(),
                         positions=on_cpu(pos), **kw)
    line = b1_vs_cpu(host, got)
    if not (upd_bit and err <= COLLISION_ATOL):
        raise AssertionError(f"B1 at main-path shapes: upd bit-equal to the "
                             f"plain version on the card {upd_bit}, M and V "
                             f"max_abs_err {err}")
    del want, got, host
    scratch = clone(args)
    ms = cuda_ms(lambda: cs_adam_tiled(*scratch, **b1kw), reps=20, warmup=3)
    b1_prof = kernel_profile(
        lambda: [cs_adam_tiled(*scratch, **b1kw) for _ in range(5)]
        + [torch.cuda.synchronize()])[2]
    b1_launches = sum(c for _ms, c, _n in b1_prof) / 5
    b1_parts = {name: t / 5 for t, _c, name in b1_prof}
    plain_ms = cuda_ms(lambda: cs_adam_tiled_plain(
        *scratch, n_valid=batch.n_unique, **kw), reps=5)
    # the tiled backend as the step calls it: ids and rows in, the update
    # per input position out (dedup, hashing, B1)
    def called():
        return ops.adam_rows_tiled(spec_m, spec_v, scratch[0], scratch[1],
                                   ids, rows, STEPS, lr=-1.0)
    called_ms = cuda_ms(called, reps=20, warmup=3)
    _o, _w, prof = kernel_profile(
        lambda: [called() for _ in range(5)] + [torch.cuda.synchronize()])
    called_busy = sum(p[0] for p in prof) / 5
    called_launches = sum(p[1] for p in prof) / 5
    called_top = {name: t / 5 for t, _c, name in prof[:6]}
    depth = spec_v.depth
    k = int(ids.numel())
    rows_m = unique_rows(bm, k_u, spec_m.width)
    rows_v = unique_rows(bv, k_u, spec_v.width)
    nbytes = b1_bytes(D_MODEL, k, k_u, rows_m, rows_v, depth, True)
    out.append(dict(name="cs_adam_tiled", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_adam_tiled.cu",
                    replaces="src/repro/kernels/cs_adam_tiled.py:153",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, k=k, k_unique=k_u,
                    touched_rows_m=rows_m, touched_rows_v=rows_v,
                    bytes=nbytes, launches_per_call=b1_launches,
                    device_ms_by_kernel=b1_parts, as_called_ms=called_ms,
                    as_called_busy_ms=called_busy,
                    as_called_launches=called_launches))
    log(f"phase 5: B1 k_u={k_u} (of {k}): {ms} ms ({b1_launches} device "
        f"launches a call), plain {plain_ms} ms, bound "
        f"{out[-1]['bound_ms']} ms ({nbytes} B at 3.35 TB/s: 4 B x "
        f"{D_MODEL} x (k_u + k + 2 x ({rows_m} M rows + {rows_v} V rows)) "
        f"+ 4 B x (9 k_u + 2 k + 1)); {line}; M and V max_abs_err {err} vs "
        f"the plain version on the card, upd bit-equal to it")
    log(f"phase 5: B1's device ms a call by kernel {json.dumps(b1_parts)}")
    log(f"phase 5: ops.adam_rows_tiled as called (ids and rows in, the "
        f"update per input position out): {called_ms} ms, device busy "
        f"{called_busy} ms, {called_launches} device launches a call; its "
        f"costliest kernels (ms a call) {json.dumps(called_top)}")
    # B2 at the inputs the stream backend gives it: the raw ids, in order;
    # its time includes the two CSR launches that find each item's prev
    bm, sm, bv = ops._adam_addressing(spec_m, spec_v, ids)
    args = (state["m"], state["v"], bm, sm, bv, rows.contiguous())
    got = cs_adam_fused(*clone(args), **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref.adam_fused_ref(*clone(args), **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max_err(want, got)
    if err != 0.0:
        raise AssertionError(f"B2 at main-path shapes: max_abs_err {err}")
    scratch = clone(args)
    ms = cuda_ms(lambda: cs_adam_fused(*scratch, **kw), reps=10, warmup=2)
    prev_ms = cuda_ms(lambda: (bucket_prev(bm, spec_m.width),
                               bucket_prev(bv, spec_v.width)),
                      reps=20, warmup=3)
    k = int(ids.numel())
    nbytes = (4 * D_MODEL * 2 * k
              + 4 * D_MODEL * 2 * (unique_rows(bm, k, spec_m.width)
                                   + unique_rows(bv, k, spec_v.width))
              + 4 * 3 * depth * k)
    chain = max(longest_chain(bm), longest_chain(bv))
    out.append(dict(name="cs_adam_fused", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_adam.cu",
                    replaces="src/repro/kernels/cs_adam.py:110",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, k=k,
                    k_unique=int(np.unique(ids_np).size), bytes=nbytes,
                    prev_ms=prev_ms, longest_chain=chain))
    log(f"phase 5: B2 k={k}: {ms} ms with its prev pass ({prev_ms} ms of "
        f"it), plain {plain_ms} ms (one run), bound {out[-1]['bound_ms']} "
        f"ms ({nbytes} B at 3.35 TB/s); longest same-bucket chain {chain} "
        f"items; vs plain bit-equal")
    out.append(time_ema(dev, seed))
    out.append(time_ema_bf16(dev, seed))
    out.extend(time_sketch_ops(dev, sketch_ops))
    return out


def time_ema(dev, seed: int) -> dict:
    """B3 as the dense path runs it: all 151,936 rows of the table, the
    Adam first moment (signed, mask all ones), cached addressing."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    spec = SketchHParams().spec("tok_embed/table", (VOCAB, D_MODEL),
                                signed=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    S = torch.randn(spec.shape, generator=gen, device=dev)
    x = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev)
    mask = torch.ones((VOCAB, 1), device=dev)
    b, s = ops._cached_addressing(spec, VOCAB, dev)
    csr = ops._cached_csr(spec, VOCAB, dev)
    kw = dict(beta=0.9, scale=1.0 - 0.9)
    want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
    got = cs_ema_tiled(S.clone(), b, s, x, mask, csr=csr, **kw)
    card_err = max_err(want, got)
    host = cs_ema_tiled_plain(*on_cpu([S, b, s, x, mask]), **kw)
    err = max_err(host, on_cpu(got))
    if err != 0.0 or card_err > COLLISION_ATOL:
        raise AssertionError(f"B3 at the dense path's shapes: {err} vs a "
                             f"CPU copy, {card_err} on the card")
    del want, got, host
    work = S.clone()
    ms = cuda_ms(lambda: cs_ema_tiled(work, b, s, x, mask, csr=csr, **kw),
                 reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: cs_ema_tiled_plain(work, b, s, x, mask, **kw),
                       reps=5)
    slices = time_ema_slices(work, b, s, x, mask, csr, dict(sr_seed=None,
                                                            **kw))
    depth, width, d = spec.shape
    nbytes = 4 * (2 * VOCAB * d + 2 * depth * width * d + 2 * depth * VOCAB
                  + VOCAB)
    row = dict(name="cs_ema_tiled", route="cuda",
               source="src/repro_torch/kernels/csrc/cs_ema_tiled.cu",
               replaces="src/repro/kernels/cs_ema_tiled.py:140",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None, k=VOCAB, bytes=nbytes, **slices)
    log(f"phase 5: B3 k={VOCAB} (every row, signed, mask on): {ms} ms, "
        f"plain {plain_ms} ms, bound {row['bound_ms']} ms ({nbytes} B at "
        f"3.35 TB/s); bit-equal to the plain version on a CPU copy, "
        f"max_abs_err {card_err} vs it on the card")
    log_slices("B3", ms, slices)
    return row


def device_ms(fn, n: int = 3):
    """Device time a call of the kernels that ``fn()`` launches, from
    ``torch.profiler``; None where it saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / 1e3 / n if busy > 0.0 else None


def time_ema_slices(work, b, s, x, mask, csr, kw) -> dict:
    """B3's column slices at the shapes of ``work``: the slice width the
    wrapper picks, the number of slices and the scratch bytes; the read
    launches of a call alone and its scatter launches alone, each over
    the number of slices (the time of one slice's read and scatter); the
    device time of a call's kernels (the rest of a call's time is gaps
    between launches); a copy of x into est slice by slice, the DRAM
    traffic of the reads without their work, beside one whole copy; a
    whole call at slice widths 16, 32 and 64 (through ``launch_slices``,
    which counts nothing)."""
    import torch
    from repro_torch.kernels.cs_ema_tiled import (READ, SCATTER,
                                                  launch_slices, slice_cols)
    depth, width, d = work.shape
    k = x.shape[0]
    cols = slice_cols(k, d, depth, width, work.element_size())
    order, starts = csr
    est = torch.empty((k, d), device=x.device)

    def run(c, parts=READ | SCATTER):
        scratch = torch.empty((k, c), device=x.device)
        return lambda: launch_slices(work, b, s, x, mask.reshape(k), order,
                                     starts, est, scratch, parts=parts, **kw)

    def copy_by_slices():  # the DRAM pattern of x and est, alone
        for c0 in range(0, d, cols):
            est[:, c0:c0 + cols].copy_(x[:, c0:c0 + cols])
    slices = -(-d // cols)
    return dict(
        slice_cols=cols, slices=slices, scratch_bytes=4 * k * cols,
        slice_read_ms=cuda_ms(run(cols, READ), reps=10, warmup=2) / slices,
        slice_scatter_ms=cuda_ms(run(cols, SCATTER), reps=10,
                                 warmup=2) / slices,
        busy_ms=device_ms(run(cols)),
        copy_by_slices_ms=cuda_ms(copy_by_slices, reps=5, warmup=1),
        copy_ms=cuda_ms(lambda: est.copy_(x), reps=5, warmup=1),
        call_ms_by_cols={c: cuda_ms(run(c), reps=10, warmup=2)
                         for c in (16, 32, 64)})


def log_slices(name: str, ms: float, sl: dict) -> None:
    apart = sl["slices"] * (sl["slice_read_ms"] + sl["slice_scatter_ms"])
    busy = ("not measured" if sl["busy_ms"] is None
            else f"{sl['busy_ms']} ms")
    log(f"phase 5: {name} in {sl['slices']} slices of {sl['slice_cols']} "
        f"columns, scratch {sl['scratch_bytes']} B; one slice (a call's "
        f"launches of each kind over its slices): read "
        f"{sl['slice_read_ms']} ms, scatter {sl['slice_scatter_ms']} ms "
        f"({apart} ms over all slices timed apart, against {ms} ms a "
        f"call); the call's kernels busy {busy} of it (profiler); x "
        f"copied into est slice by slice {sl['copy_by_slices_ms']} ms, in "
        f"one copy {sl['copy_ms']} ms; a call at slice widths 16/32/64: "
        f"{sl['call_ms_by_cols']}")


def time_ema_bf16(dev, seed: int) -> dict:
    """B3's bf16 branch as the dense path runs it with bf16 cells: all
    151,936 rows, the signed first moment, mask on, cached addressing.
    Its bound counts x read and est written (4 B each), the bf16 sketch
    read and written once (2 B a cell) and the addressing and mask."""
    import torch
    from repro_torch.core import quantize as qz
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    spec = SketchHParams(dtype="bfloat16").spec(
        "tok_embed/table", (VOCAB, D_MODEL), signed=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 61)
    S = torch.randn(spec.shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((VOCAB, D_MODEL), generator=gen, device=dev)
    mask = torch.ones((VOCAB, 1), device=dev)
    b, s = ops._cached_addressing(spec, VOCAB, dev)
    csr = ops._cached_csr(spec, VOCAB, dev)
    kw = dict(beta=0.9, scale=1.0 - 0.9, sr_seed=qz.step_seed(spec.seed, 3))
    got = cs_ema_tiled(S.clone(), b, s, x, mask, csr=csr, **kw)
    want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
    card_differ = int((want[0].view(torch.int16)
                       != got[0].view(torch.int16)).sum())
    card_ok = torch.equal(want[1], got[1]) and bf16_within(
        got[0], want[0], COLLISION_ATOL)
    host = cs_ema_tiled_plain(*on_cpu([S, b, s, x, mask]), **kw)
    bit = (torch.equal(host[0].view(torch.int16),
                       got[0].cpu().view(torch.int16))
           and torch.equal(host[1], got[1].cpu()))
    err = max(float((host[0].float() - got[0].cpu().float()).abs().max()),
              float((host[1] - got[1].cpu()).abs().max()))
    if not (bit and card_ok):
        raise AssertionError(f"B3 bf16 at the dense path's shapes: "
                             f"bit-equal to a CPU copy {bit}; on the card "
                             f"{card_differ} cells differ")
    del want, got, host
    work = S.clone()
    ms = cuda_ms(lambda: cs_ema_tiled(work, b, s, x, mask, csr=csr, **kw),
                 reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: cs_ema_tiled_plain(work, b, s, x, mask, **kw),
                       reps=5)
    slices = time_ema_slices(work, b, s, x, mask, csr, kw)
    depth, width, d = spec.shape
    nbytes = (4 * 2 * VOCAB * d + 2 * 2 * depth * width * d
              + 4 * (2 * depth * VOCAB + VOCAB))
    row = dict(name="cs_ema_tiled_bf16", route="cuda",
               source="src/repro_torch/kernels/csrc/cs_ema_tiled.cu",
               replaces="src/repro/kernels/cs_ema_tiled.py:140",
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=None, k=VOCAB, bytes=nbytes, **slices)
    log(f"phase 5: B3 bf16 k={VOCAB} (every row, signed, mask on): {ms} ms, "
        f"plain {plain_ms} ms, bound {row['bound_ms']} ms ({nbytes} B at "
        f"3.35 TB/s); bit-equal to the plain version on a CPU copy; "
        f"{card_differ} of {S.numel()} cells round apart from it on the "
        f"card (atomic-order sums), est bit-equal")
    log_slices("B3 bf16", ms, slices)
    return row


def time_sketch_ops(dev, sketch_ops) -> list:
    """B4 and B5 at the sketch-ops phase's shapes: 16,384 zipf ids into
    the (3, 10,240, 896) Count-Sketch.  B5's library yardstick is one
    ``index_add_`` on the flattened (depth*width, dim) sketch with the
    signed rows already formed."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.cs_query import cs_query
    from repro_torch.kernels.cs_update import (bucket_csr, bucket_csr_plain,
                                               cs_update)
    spec, S, ids, rows, counts = sketch_ops
    depth, width, d = spec.shape
    k = ids.numel()
    b, s = spec.family.bucket(ids), spec.family.sign(ids)
    touched = unique_rows(b, k, width)
    out = []
    ms = cuda_ms(lambda: cs_query(S, b, s), reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: ref.cs_query_ref(S, b, s), reps=10)
    nbytes = 4 * (k * d + touched * d + 2 * depth * k)
    out.append(dict(name="cs_query", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_query.cu",
                    replaces="src/repro/kernels/cs_query.py:58",
                    launches=counts["cs_query"], max_abs_err=0.0, ms=ms,
                    plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=None, k=k,
                    touched_rows=touched, bytes=nbytes))
    log(f"phase 5: B4 k={k} ({touched} sketch rows): {ms} ms, plain "
        f"{plain_ms} ms, bound {out[-1]['bound_ms']} ms ({nbytes} B)")
    # B5 as users call it (the CSR built in the call), then its parts
    work = S.clone()
    ms = cuda_ms(lambda: cs_update(work, b, s, rows), reps=20, warmup=3)
    csr = bucket_csr(b, width)
    scatter_ms = cuda_ms(lambda: cs_update(work, b, s, rows, csr=csr),
                         reps=20, warmup=3)
    csr_ms = cuda_ms(lambda: bucket_csr(b, width), reps=20, warmup=3)
    csr_plain_ms = cuda_ms(lambda: bucket_csr_plain(b, width), reps=20,
                           warmup=3)
    sort_ms = cuda_ms(lambda: torch.sort(b, dim=1, stable=True), reps=20,
                      warmup=3)
    plain_ms = cuda_ms(lambda: ref.cs_update_ref(work, b, s, rows), reps=10)
    flat = work.view(depth * width, d)
    idx = (b.long() + width * torch.arange(depth, device=dev)[:, None]
           ).reshape(-1)
    signed_rows = (s[:, :, None] * rows[None]).reshape(depth * k, d)
    library_ms = cuda_ms(lambda: flat.index_add_(0, idx, signed_rows),
                         reps=20, warmup=3)
    got = cs_update(S.clone(), b, s, rows)
    card_err = float((ref.cs_update_ref(S.clone(), b, s, rows) - got).abs()
                     .max())
    err = float((ref.cs_update_ref(*on_cpu([S, b, s, rows])) - got.cpu())
                .abs().max())
    if err != 0.0:
        raise AssertionError(f"B5 at the sketch ops' shapes: {err} vs a "
                             f"CPU copy")
    if not all(torch.equal(a, c) for a, c in
               zip(bucket_csr_plain(b, width)[:2], csr)):
        raise AssertionError("bucket_csr at the sketch ops' shapes differs "
                             "from the plain form")
    nbytes = 4 * (k * d + 2 * touched * d + 2 * depth * k)
    out.append(dict(name="cs_update", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_update.cu",
                    replaces="src/repro/kernels/cs_update.py:58",
                    max_abs_err=err, ms=ms,
                    plain_ms=plain_ms,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=library_ms, k=k,
                    touched_rows=touched, bytes=nbytes, csr_ms=csr_ms,
                    scatter_ms=scatter_ms))
    log(f"phase 5: B5 k={k} as called (CSR built in the call): {ms} ms "
        f"(CSR alone {csr_ms}, scatter alone {scatter_ms}), plain "
        f"{plain_ms} ms, index_add_ {library_ms} ms, bound "
        f"{out[-1]['bound_ms']} ms ({nbytes} B); bit-equal to the plain "
        f"version on a CPU copy, max_abs_err {card_err} vs it on the card")
    if not ms < library_ms:
        log(f"phase 5: B5 ({ms} ms) is not faster than one index_add_ "
            f"({library_ms} ms)")
    csr_bytes = 4 * (2 * depth * k + depth * (width + 1))
    out.append(dict(name="bucket_csr", route="cuda",
                    source="src/repro_torch/kernels/csrc/cs_csr.cu",
                    replaces=None, max_abs_err=0.0, ms=csr_ms,
                    plain_ms=csr_plain_ms,
                    bound_ms=csr_bytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=sort_ms, k=k,
                    bytes=csr_bytes))
    log(f"phase 5: bucket_csr ({depth}, {k}) buckets, width {width}: "
        f"{csr_ms} ms, plain (stable torch.sort + searchsorted) "
        f"{csr_plain_ms} ms, one stable torch.sort (order only) {sort_ms} "
        f"ms, bound {out[-1]['bound_ms']} ms ({csr_bytes} B); integer-equal "
        f"to the plain form")
    return out


# ---------------------------------------------------------------- phase 6
def softmax_batches(rng: np.random.RandomState, steps: int) -> list:
    return [((rng.zipf(ZIPF_A, TOKENS) - 1) % VOCAB).astype(np.int64)
            for _ in range(steps)]


class SoftmaxTask:
    """The softmax layer of qwen2-0.5b on the dense path (phases 6 and 7):
    ``{"tok_embed": {"table"}, "final_norm": {"scale"}}``, cross-entropy of
    ``rmsnorm(h)*scale @ table^T`` over all 151,936 classes, ``h =
    teacher[y] + noise``, 1,024 zipf(1.1) targets a step."""

    def __init__(self, dev, seed: int):
        import torch
        self.dev = dev
        gen = torch.Generator(device=dev).manual_seed(seed + 50)
        self.teacher = torch.randn((VOCAB, D_MODEL), generator=gen,
                                   device=dev)
        self.table0 = torch.randn((VOCAB, D_MODEL), generator=gen,
                                  device=dev) / D_MODEL ** 0.5
        self.batches = softmax_batches(np.random.RandomState(seed), STEPS)
        self.noise = [torch.randn((TOKENS, D_MODEL), generator=gen,
                                  device=dev) for _ in self.batches]
        self.fresh_y = softmax_batches(np.random.RandomState(seed + 99), 1)[0]
        self.fresh_noise = torch.randn((TOKENS, D_MODEL), generator=gen,
                                       device=dev)

    def loss_fn(self, params, y_np, eps_h):
        import torch
        y = torch.from_numpy(y_np).to(self.dev)
        h = self.teacher[y] + eps_h
        hn = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6) \
            * params["final_norm"]["scale"]
        return torch.nn.functional.cross_entropy(
            hn @ params["tok_embed"]["table"].t(), y)

    def run(self, opt, lr, steps: int = STEPS, before=None):
        """``steps`` steps from table0; returns (params, state, per-step
        losses, per-step ms, the step function, per-step max
        |direction|).  ``before(state, step)`` runs ahead of each step
        and returns the state (the async cleaner's hook)."""
        import torch
        from repro_torch.core.optimizers import apply_updates
        dev = self.dev
        params = {"tok_embed": {"table": self.table0.clone()
                                .requires_grad_()},
                  "final_norm": {"scale": torch.ones(
                      D_MODEL, device=dev).requires_grad_()}}
        state = opt.init(params)
        leaves = (params["tok_embed"]["table"], params["final_norm"]["scale"])
        directions = []

        def step(y_np, eps_h):
            nonlocal state
            loss = self.loss_fn(params, y_np, eps_h)
            g_table, g_scale = torch.autograd.grad(loss, leaves)
            updates, state = opt.update(
                {"tok_embed": {"table": g_table},
                 "final_norm": {"scale": g_scale}}, state)
            directions.append(updates["tok_embed"]["table"].abs().max()
                              / lr)
            apply_updates(params, updates)
            return loss.detach()

        losses, events = [], []
        for i, (y_np, eps_h) in enumerate(zip(self.batches[:steps],
                                              self.noise)):
            if before is not None:
                state = before(state, i + 1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(y_np, eps_h))
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return (params, state, [float(x) for x in losses],
                [a.elapsed_time(b) for a, b in events], step,
                [float(x) for x in directions])

    def held_fresh(self, params=None):
        """The loss on batch 0's tokens and on a fresh batch."""
        import torch
        if params is None:
            params = {"tok_embed": {"table": self.table0},
                      "final_norm": {"scale": torch.ones(D_MODEL,
                                                         device=self.dev)}}
        with torch.no_grad():
            return (float(self.loss_fn(params, self.batches[0],
                                       self.noise[0])),
                    float(self.loss_fn(params, self.fresh_y,
                                       self.fresh_noise)))


def phase_dense(dev, seed: int):
    """The dense-gradient path at full width (see the module docstring).
    Returns (the kernel launch counts of its 20 checked steps, the task,
    its per-step losses)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams, adam, \
        countsketch_adam
    from repro_torch.core.partition import SketchPolicy
    task = SoftmaxTask(dev, seed)
    noise, run, held_fresh = task.noise, task.run, task.held_fresh
    held0, fresh0 = held_fresh()
    policy = SketchPolicy()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params, state, losses, ms, step, dirs = run(
        countsketch_adam(DENSE_LR, policy=policy,
                         hparams=SketchHParams(backend="auto")), DENSE_LR)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    held, fresh = held_fresh(params)
    m = state["m"]["tok_embed"]["table"]
    log(f"phase 6: softmax layer tok_embed/table {VOCAB} x {D_MODEL}, "
        f"{TOKENS} zipf({ZIPF_A}) targets a step; sketches m "
        f"{tuple(m.shape)} v {tuple(state['v']['tok_embed']['table'].shape)}"
        f" ({m.numel() * 4} B each), final_norm/scale dense Adam; "
        f"countsketch_adam lr {DENSE_LR}")
    log(f"phase 6: ms/step median of steps 2..{STEPS}: "
        f"{statistics.median(ms[1:])} (first step {ms[0]}); all {ms}; "
        f"peak device memory {peak} B")
    log(f"phase 6: loss on batch 0's tokens {held0} -> {held}; on a fresh "
        f"batch {fresh0} -> {fresh}; per-step {losses}; max |direction| "
        f"per step {dirs}; launches {counts}")
    if counts["cs_ema_tiled"] != 2 * STEPS:
        raise AssertionError(f"B3 launched {counts['cs_ema_tiled']} times, "
                             f"not {2 * STEPS}")
    if not held < held0:
        raise AssertionError("the dense path's loss did not fall")
    if not all(torch.isfinite(t).all() for t in (
            params["tok_embed"]["table"], m,
            state["v"]["tok_embed"]["table"])):
        raise AssertionError("non-finite table or sketch")
    w_params, _, w_losses, w_ms, _, _ = run(
        countsketch_adam(DENSE_LR, policy=policy,
                         hparams=SketchHParams(backend="xla")), DENSE_LR)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses))
    table, w_table = (params["tok_embed"]["table"].detach(),
                      w_params["tok_embed"]["table"].detach())
    err = float((table - w_table).abs().max())
    log(f"phase 6b: plain xla, same batches: ms/step median "
        f"{statistics.median(w_ms[1:])}; per-step loss max rel diff {rel}, "
        f"table max_abs_err {err} (rtol {WITNESS_TOL['rtol']}, atol "
        f"{WITNESS_TOL['atol']})")
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(w_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    torch.testing.assert_close(table, w_table, **WITNESS_TOL)
    del w_params, w_table
    more = softmax_batches(np.random.RandomState(seed + 30), 5)

    def five():
        out = [step(y, eps) for y, eps in zip(more, noise)]
        torch.cuda.synchronize()
        return out
    profile_steps("phase 6c", five, statistics.median(ms[1:]))
    del params, state
    # at the main path's lr the sketched first moment diverges here; the
    # same batches with it dense (CS-V) and all-dense Adam show which part
    # of the sketch does it (printed, not required)
    for name, opt in (
            ("countsketch_adam", countsketch_adam(
                LR, policy=policy, hparams=SketchHParams(backend="auto"))),
            ("countsketch_adam sketch_first_moment=False", countsketch_adam(
                LR, policy=policy, hparams=SketchHParams(backend="auto"),
                sketch_first_moment=False)),
            ("adam (dense)", adam(LR))):
        p, _, l, _, _, d = run(opt, LR)
        h, f = held_fresh(p)
        log(f"phase 6d: {name} lr {LR}: loss on batch 0's tokens {held0} "
            f"-> {h}, fresh {fresh0} -> {f}; per-step {l}; max |direction| "
            f"per step {d}")
        del p
    return counts, task, losses, (held0, held), statistics.median(ms[1:])


# ---------------------------------------------------------------- phase 7
def sketch_bytes(state) -> int:
    """Bytes of one sketch state: its cells, and an int8 state's scales."""
    return sum(t.numel() * t.element_size()
               for t in (state if isinstance(state, tuple) else (state,)))


def phase_dense_bf16(dev, f32):
    """Phase 6's task with bf16 sketch cells: 20 steps of
    ``countsketch_adam(SketchHParams(dtype="bfloat16"))`` on ``auto``, B3's
    bf16 kernel twice a step, the plain ``xla`` witness on the same
    batches, and the losses beside phase 6's f32 run.  Returns the
    launch counts."""
    import torch
    from repro_torch.core.optimizers import SketchHParams, countsketch_adam
    from repro_torch.core.partition import SketchPolicy
    _counts6, task, losses6, (held0, held6), ms6 = f32
    hp = SketchHParams(backend="auto", dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    params, state, losses, ms, step, dirs = task.run(
        countsketch_adam(DENSE_LR, policy=SketchPolicy(), hparams=hp),
        DENSE_LR)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    held, fresh = task.held_fresh(params)
    m, v = state["m"]["tok_embed"]["table"], state["v"]["tok_embed"]["table"]
    nbytes = sketch_bytes(m)
    spec = hp.spec("tok_embed/table", (VOCAB, D_MODEL), signed=True)
    f32_bytes = SketchHParams().spec("tok_embed/table", (VOCAB, D_MODEL),
                                     signed=True).nbytes()
    log(f"phase 7: phase 6's softmax layer with bf16 sketch cells "
        f"(SketchHParams(dtype='bfloat16'), backend auto): sketches m "
        f"{tuple(m.shape)} {m.dtype} v {tuple(v.shape)} {v.dtype}, "
        f"{nbytes} B per moment (f32: {f32_bytes} B)")
    log(f"phase 7: ms/step median of steps 2..{STEPS}: "
        f"{statistics.median(ms[1:])} (f32, phase 6: {ms6}; first step "
        f"{ms[0]}); all {ms}; peak device memory {peak} B")
    log(f"phase 7: loss on batch 0's tokens {held0} -> {held} (f32: "
        f"{held0} -> {held6}); fresh batch {fresh}; per-step {losses}; f32 "
        f"per-step {losses6}; max |direction| per step {dirs}; launches "
        f"{counts}")
    if counts["cs_ema_tiled_bf16"] != 2 * STEPS or counts["cs_ema_tiled"]:
        raise AssertionError(f"bf16 dense path launches {counts}, not "
                             f"{2 * STEPS} of B3 bf16 alone")
    if nbytes != spec.nbytes() or 2 * nbytes != f32_bytes:
        raise AssertionError(f"bf16 sketch bytes {nbytes}, spec "
                             f"{spec.nbytes()}, f32 {f32_bytes}")
    if not held < held0:
        raise AssertionError("the bf16 dense path's loss did not fall")
    if not all(torch.isfinite(t.float()).all() for t in (
            params["tok_embed"]["table"], m, v)):
        raise AssertionError("non-finite table or bf16 sketch")
    w_params, _, w_losses, w_ms, _, _ = task.run(
        countsketch_adam(DENSE_LR, policy=SketchPolicy(),
                         hparams=SketchHParams(backend="xla",
                                               dtype="bfloat16")), DENSE_LR)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses))
    table, w_table = (params["tok_embed"]["table"].detach(),
                      w_params["tok_embed"]["table"].detach())
    diff = (table - w_table).abs()
    outside = int((diff > WITNESS_TOL["atol"]
                   + WITNESS_TOL["rtol"] * w_table.abs()).sum())
    log(f"phase 7: plain xla witness with bf16 cells, same batches: ms/step "
        f"median "
        f"{statistics.median(w_ms[1:])}; per-step loss max rel diff {rel} "
        f"(rtol {WITNESS_TOL['rtol']}); table max_abs_err "
        f"{float(diff.max())}, {outside} of {diff.numel()} entries outside "
        f"rtol {WITNESS_TOL['rtol']}/atol {WITNESS_TOL['atol']} (the plain "
        f"version sums each cell's increments in atomic order, so some "
        f"stochastic roundings go the other way; not asserted)")
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(w_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    del w_params, w_table, diff
    more = softmax_batches(np.random.RandomState(31), 5)

    def five():
        out = [step(y, eps) for y, eps in zip(more, task.noise)]
        torch.cuda.synchronize()
        return out
    profile_steps("phase 7 (profile)", five, statistics.median(ms[1:]))
    return counts


def phase_dense_int8(dev, task):
    """Phase 6's task with int8 sketch cells through the plain route: 5
    steps; the table stays finite, the loss on batch 0's tokens falls,
    and no B3 launches (int8 runs ``xla``, as in the reference)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams, countsketch_adam
    from repro_torch.core.partition import SketchPolicy
    hp = SketchHParams(backend="auto", dtype="int8")
    reset_counts()
    params, state, losses, ms, _, dirs = task.run(
        countsketch_adam(DENSE_LR, policy=SketchPolicy(), hparams=hp),
        DENSE_LR, steps=5)
    counts = read_counts()
    held0, _ = task.held_fresh()
    held, _ = task.held_fresh(params)
    m, v = state["m"]["tok_embed"]["table"], state["v"]["tok_embed"]["table"]
    log(f"phase 7b: int8 sketch cells (SketchHParams(dtype='int8'), backend "
        f"auto -> xla): 5 steps, ms/step {ms}; loss on batch 0's tokens "
        f"{held0} -> {held}; per-step {losses}; max |direction| {dirs}; "
        f"state bytes per moment {sketch_bytes(m)} (cells "
        f"{tuple(m.cells.shape)} int8 + scales {tuple(m.scales.shape)} f32); "
        f"launches {counts}")
    if counts["cs_ema_tiled"] or counts["cs_ema_tiled_bf16"]:
        raise AssertionError(f"int8 cells launched B3: {counts}")
    if not held < held0:
        raise AssertionError("the int8 dense path's loss did not fall")
    if not (torch.isfinite(params["tok_embed"]["table"]).all()
            and torch.isfinite(m.scales).all()
            and torch.isfinite(v.scales).all()):
        raise AssertionError("non-finite table or int8 scales")
    if sketch_bytes(m) != hp.spec("tok_embed/table", (VOCAB, D_MODEL),
                                  signed=True).nbytes():
        raise AssertionError("int8 state bytes disagree with the spec")


def phase_sparse_bf16(dev, seed: int, held3):
    """bf16 cells on phase 3's sparse-rows batches, backend ``tiled``:
    low-precision cells run the whole-batch ``xla`` form as in the
    reference, so no B1 launches; its colliding sums go through B5.
    Prints the held loss beside phase 3's.  The 20 steps run twice from
    the same start must give the same table and sketches to the bit
    (stochastic rounding turns any change of sum order into a whole
    bf16 ulp)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.steps import make_sparse_embedding_step
    init_fn, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, device=dev,
        hparams=SketchHParams(backend="tiled", dtype="bfloat16"))
    table0 = init_fn(torch.Generator(device=dev).manual_seed(seed))
    target = init_fn(torch.Generator(device=dev).manual_seed(seed + 1))
    batches = zipf_ids(np.random.RandomState(seed), STEPS)
    held = torch.from_numpy(batches[0]).to(dev).long()

    def loss_on(tab) -> float:
        rows = tab[held] - target[held]
        return float(torch.mean(rows * rows))

    before = loss_on(table0)
    reset_counts()
    table, state, losses, ms = run_steps(step_fn, table0.clone(), target,
                                         opt.init(), batches, dev)
    counts = read_counts()
    after = loss_on(table)
    table2, state2, losses2, _ = run_steps(step_fn, table0, target,
                                           opt.init(), batches, dev)
    same = {"table": torch.equal(table, table2),
            "m": torch.equal(state["m"].view(torch.int16),
                             state2["m"].view(torch.int16)),
            "v": torch.equal(state["v"].view(torch.int16),
                             state2["v"].view(torch.int16)),
            "losses": losses == losses2}
    log(f"phase 7c: phase 3's {STEPS} sparse-rows batches with bf16 sketch "
        f"cells ({state['v'].dtype}, {sketch_bytes(state['v'])} B per "
        f"moment), backend tiled: ms/step median {statistics.median(ms[1:])}; "
        f"loss on the first batch's ids {before} -> {after} (f32, phase 3: "
        f"{held3[0]} -> {held3[1]}); launches {counts}; run twice from the "
        f"same start, equal to the bit {same}")
    if counts["cs_adam_tiled"]:
        raise AssertionError(f"bf16 sparse rows launched B1: {counts}")
    if counts["cs_update"] != 3 * STEPS:
        raise AssertionError(f"bf16 sparse rows: {counts['cs_update']} B5 "
                             f"launches, not 3 a step (the dedup sum and "
                             f"both moments)")
    if not all(same.values()):
        raise AssertionError(f"two runs of the bf16 sparse steps differ: "
                             f"{same}")
    if not after < before:
        raise AssertionError("the bf16 sparse path's loss did not fall")
    if not torch.isfinite(table).all():
        raise AssertionError("non-finite table")


def phase_async_clean(dev, task):
    """The dense path with a Count-Min cleaned every 5 steps (bf16 cells),
    10 steps, sync against ``AsyncCleaner``: the table and both sketches
    must be equal to the bit."""
    import torch
    from repro_torch.core.cleaning import AsyncCleaner, CleaningSchedule
    from repro_torch.core.optimizers import (SketchHParams, adam_from_stores,
                                             stores_from_policy)
    from repro_torch.core.partition import SketchPolicy
    path = ("tok_embed", "table")

    def run(mode):
        sched = CleaningSchedule(alpha=0.5, every=5, mode=mode)
        tree = stores_from_policy(SketchPolicy(), cleaning=sched,
                                  hparams=SketchHParams(backend="auto",
                                                        dtype="bfloat16"))
        cleaner = None
        before = None
        if mode == "async":
            cleaner = AsyncCleaner(
                sched, getter=lambda st: st["v"][path[0]][path[1]])

            def before(state, step):
                return cleaner.maybe_dispatch(state, step)[0]
        params, state, losses, ms, _, _ = task.run(
            adam_from_stores(DENSE_LR, tree), DENSE_LR, steps=10,
            before=before)
        out = [params["tok_embed"]["table"].detach(),
               state["m"][path[0]][path[1]], state["v"][path[0]][path[1]]]
        return out, losses, ms, cleaner

    sync, s_losses, s_ms, _ = run("sync")
    asyn, a_losses, a_ms, cleaner = run("async")
    equal = [torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                         else a, b.view(torch.int16)
                         if b.dtype == torch.bfloat16 else b)
             for a, b in zip(sync, asyn)]
    log(f"phase 7d: bf16 dense path, CountMinStore cleaning alpha 0.5 every "
        f"5, 10 steps: sync ms/step {s_ms}; async ms/step {a_ms}; "
        f"{cleaner.dispatched} async decays, in flight after the run "
        f"{cleaner.in_flight()}; equal to the bit (table, m, v) {equal}; "
        f"losses sync {s_losses} async {a_losses}")
    if cleaner.dispatched != 2:
        raise AssertionError(f"{cleaner.dispatched} async decays, not 2")
    if not all(equal):
        again, _, _, _ = run("sync")
        repeat = [torch.equal(a, b) for a, b in zip(sync, again)]
        raise AssertionError(
            f"async cleaning differs from sync {equal}; sync against a "
            f"second sync run {repeat}: "
            + ("the dense step itself is not deterministic (autograd's "
               "matmul or cross-entropy backward)" if not all(repeat)
               else "the side-stream decay is not ordered before the step"))


# ---------------------------------------------------------------- phase 8
# the reference's full scale, benchmarks/extreme_scale.py:191-194
EXTREME = dict(n_classes=8_000_000, n_meta=1 << 21, n_features=1 << 16,
               dim=64, nnz=16, n_negatives=1_024)
X_BATCH, X_BIG_BATCH, X_LR, X_STEPS = 1_024, 8_192, 1e-2, 20


def extreme_batches(cfg, cmap, batch: int, steps: int, dev,
                    first: int = 0) -> list:
    """Replica batches ``first ..`` from the port's ``ExtremeStream``,
    labels and negatives mapped through the replica's class map, on the
    card."""
    from repro_torch.data import ExtremeStream
    from repro_torch.train.extreme import MetaStream
    stream = MetaStream(ExtremeStream(cfg.data_config(batch)), cmap, dev)
    return [stream.batch(i) for i in range(first, first + steps)]


def run_extreme(step_fn, params, state, batches):
    """Drive the extreme step over ``batches``; returns (params, state,
    losses, per-step ms)."""
    import torch
    losses, events = [], []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, metrics = step_fn(params, state, b)
        end.record()
        losses.append(metrics["loss"])
        events.append((start, end))
    torch.cuda.synchronize()
    return (params, state, [float(x) for x in losses],
            [s.elapsed_time(e) for s, e in events])


def loss_windows(losses) -> tuple:
    """The reference launcher's check (``src/repro/launch/train.py:390,
    :402``): the means of the first and the last w losses, w = max(1,
    min(10, steps // 3)); the loss fell when the second is below."""
    w = max(1, min(10, len(losses) // 3))
    return float(np.mean(losses[:w])), float(np.mean(losses[-w:]))


def tables_of(params) -> list:
    return [params["tok_embed"]["table"], params["class_head"]["table"]]


def params_from(tables) -> dict:
    return {"tok_embed": {"table": tables[0].clone()},
            "class_head": {"table": tables[1].clone()}}


def extreme_step(cfg, dev, **kw):
    """(step_fn, opts, fresh state) of ``make_extreme_step``."""
    from repro_torch.train.extreme import make_extreme_step
    _init, step_fn, opts = make_extreme_step(cfg, lr=X_LR, device=dev, **kw)
    return step_fn, opts, {p: o.init() for p, o in opts.items()}


def phase_extreme(dev, seed: int):
    """Phase 8: the MACH extreme-classification step at the reference's
    full scale (see the module docstring).  Returns what phase 5's
    extreme rows and the kernels' line need, and the peak device memory
    before 8e reset its counter."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.extreme import MachConfig, make_extreme_step
    cfg = MachConfig(**EXTREME)
    t0 = time.perf_counter()
    maps = cfg.class_maps()
    backend = kernels.resolve_backend(SketchHParams().backend, dev)
    log(f"phase 8: MachConfig {EXTREME}, {cfg.n_replicas} replicas, batch "
        f"{X_BATCH}, lr {X_LR}, SketchHParams(compression=100.0), backend "
        f"auto -> {backend}; class maps {maps.shape} {maps.dtype} hashed "
        f"on the host in {time.perf_counter() - t0:.1f} s")
    if backend != "tiled":
        raise AssertionError(f"auto resolved to {backend!r} on the card")
    counts_8a, start, final = {}, None, None
    for r in range(cfg.n_replicas):
        init_fn, step_fn, opts = make_extreme_step(
            cfg, optimizer="cs_rmsprop", lr=X_LR, device=dev)
        params = init_fn(torch.Generator(device=dev).manual_seed(seed + r))
        state = {p: o.init() for p, o in opts.items()}
        batches = extreme_batches(cfg, maps[r], X_BATCH, X_STEPS, dev)
        if r == 0:
            start, batches0 = [t.clone() for t in tables_of(params)], batches
            log(f"phase 8: tables tok_embed {tuple(start[0].shape)} "
                f"{start[0].numel() * 4} B, class_head "
                f"{tuple(start[1].shape)} {start[1].numel() * 4} B; V "
                + ", ".join(f"{p} {tuple(s['v'].shape)} "
                            f"{sketch_bytes(s['v'])} B"
                            for p, s in state.items()))
        torch.cuda.synchronize()
        reset_counts()
        params, state, losses, ms = run_extreme(step_fn, params, state,
                                                batches)
        counts = read_counts()
        for name, n in counts.items():
            counts_8a[name] = counts_8a.get(name, 0) + n
        first, last = loss_windows(losses)
        log(f"phase 8a: replica {r} cs_rmsprop {X_STEPS} steps: ms/step "
            f"median of steps 2..{X_STEPS} {statistics.median(ms[1:])} "
            f"(first {ms[0]}); loss first {losses[0]} last {losses[-1]}; "
            f"mean of the first/last {max(1, min(10, X_STEPS // 3))} "
            f"{first} -> {last}; launches {counts}")
        log(f"phase 8a: replica {r} losses {losses}")
        if counts["cs_adam_tiled"] != 2 * X_STEPS \
                or counts["cs_update"] != 2 * X_STEPS \
                or counts["bucket_csr"] != 2 * X_STEPS:
            raise AssertionError(f"the extreme step did not launch B1, its "
                                 f"CSR and the dedup sum (B5) once a table "
                                 f"a step: {counts}")
        if not last < first:
            raise AssertionError(f"replica {r}: the loss did not fall")
        if not all(torch.isfinite(t).all() for t in tables_of(params)):
            raise AssertionError(f"replica {r}: non-finite table")
        if r == 0:
            final, losses0, state0 = [t.clone() for t in tables_of(params)], \
                losses, state
        else:
            more = extreme_batches(cfg, maps[r], X_BATCH, 5, dev,
                                   first=X_STEPS)
            profile_steps("phase 8a", lambda: run_extreme(
                step_fn, params, state, more), statistics.median(ms[1:]),
                by_name=True)
        del params, state
    phase_extreme_witness(cfg, dev, start, batches0, final, losses0)
    phase_extreme_repeat(cfg, dev, start, batches0, final, losses0, state0)
    states = phase_extreme_arms(cfg, dev, start, batches0)
    peak = torch.cuda.max_memory_allocated()    # 8e resets the counter
    phase_extreme_memory(cfg, dev, maps[0], seed)
    phase_extreme_sites(cfg, dev, params_from(final), batches0[0])
    return counts_8a, {"cs_rmsprop": state0, **states}, params_from(final), \
        batches0[-1], peak, maps


def phase_extreme_witness(cfg, dev, start, batches, final, losses):
    """8b: replica 0's batches from the same start through backend
    ``xla``: losses and both tables within rtol 1e-4, atol 1e-5 of 8a."""
    import torch
    step_fn, _opts, state = extreme_step(cfg, dev, optimizer="cs_rmsprop",
                                         backend="xla")
    reset_counts()
    params, _, x_losses, ms = run_extreme(step_fn, params_from(start), state,
                                          batches)
    counts = read_counts()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, x_losses))
    errs_ = [float((a - b).abs().max())
             for a, b in zip(tables_of(params), final)]
    bit = x_losses == losses and all(
        torch.equal(a, b) for a, b in zip(tables_of(params), final))
    log(f"phase 8b: backend xla, replica 0's {len(batches)} batches: ms/step "
        f"median {statistics.median(ms[1:])}; launches {counts}; loss max rel "
        f"diff vs tiled {rel}, tables max_abs_err {errs_}; losses and tables "
        f"equal to the bit {bit}")
    if counts["cs_adam_tiled"]:
        raise AssertionError("the xla witness launched B1")
    torch.testing.assert_close(torch.tensor(x_losses), torch.tensor(losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    for a, b in zip(tables_of(params), final):
        torch.testing.assert_close(a, b, **WITNESS_TOL)


def phase_extreme_repeat(cfg, dev, start, batches, final, losses, state):
    """8c: 8a's replica-0 run again from the same start: both tables, V
    and the losses to the bit; then one step under sync-debug 'error'
    with its batch already on the card."""
    import torch
    step_fn, _opts, fresh = extreme_step(cfg, dev, optimizer="cs_rmsprop")
    params, state2, losses2, _ = run_extreme(step_fn, params_from(start),
                                             fresh, batches)
    same = {"tables": all(torch.equal(a, b)
                          for a, b in zip(tables_of(params), final)),
            "v": all(torch.equal(state[p]["v"], state2[p]["v"])
                     for p in state),
            "losses": losses2 == losses}
    log(f"phase 8c: replica 0's {len(batches)} steps again from the same "
        f"start: equal to the bit {same}")
    if not all(same.values()):
        raise AssertionError(f"two runs of the extreme step differ: {same}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step_fn(params, state2, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("phase 8c: one extreme step under torch.cuda.set_sync_debug_mode("
        "'error'): no host-device synchronisation")


def phase_extreme_arms(cfg, dev, start, batches) -> dict:
    """8d: ``cs_adam`` (B1 with M) and ``dense_adam`` on replica 0's
    batches from 8a's start; the loss must fall; each arm's
    ``state_bytes``.  Returns ``{"cs_adam": its state}``."""
    import torch
    from repro_torch.core.optimizers import state_bytes
    out = {}
    for optimizer in ("cs_rmsprop", "cs_adam", "dense_adam"):
        step_fn, opts, state = extreme_step(cfg, dev, optimizer=optimizer)
        nbytes = state_bytes(state)
        if optimizer == "cs_rmsprop":
            log(f"phase 8d: cs_rmsprop state_bytes {nbytes} (8a's arm)")
            continue
        reset_counts()
        params, state, losses, ms = run_extreme(step_fn, params_from(start),
                                                state, batches)
        counts = read_counts()
        first, last = loss_windows(losses)
        log(f"phase 8d: {optimizer} {len(batches)} steps: ms/step median "
            f"{statistics.median(ms[1:])}; loss {losses[0]} -> {losses[-1]}, "
            f"window means {first} -> {last}; state_bytes {nbytes}; launches "
            f"{counts}")
        want_b1 = 2 * len(batches) if optimizer == "cs_adam" else 0
        if counts["cs_adam_tiled"] != want_b1:
            raise AssertionError(f"{optimizer}: B1 launched "
                                 f"{counts['cs_adam_tiled']} times")
        if not last < first:
            raise AssertionError(f"{optimizer}: the loss did not fall")
        if not all(torch.isfinite(t).all() for t in tables_of(params)):
            raise AssertionError(f"{optimizer}: non-finite table")
        if optimizer == "cs_adam":
            out[optimizer] = state
        del params, state
    return out


def phase_extreme_memory(cfg, dev, cmap, seed: int) -> None:
    """8e: the peak device memory of a step of ``dense_adam`` and of
    ``cs_rmsprop`` at batch 1,024 and 8,192: the arm's tables, state and
    the step's transients, above what the card held before the arm was
    built (Tab. 8's memory story on this card)."""
    import torch
    from repro_torch.core.optimizers import state_bytes
    from repro_torch.train.extreme import make_extreme_step
    for optimizer in ("dense_adam", "cs_rmsprop"):
        for batch in (X_BATCH, X_BIG_BATCH):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            init_fn, step_fn, opts = make_extreme_step(
                cfg, optimizer=optimizer, lr=X_LR, device=dev)
            params = init_fn(torch.Generator(device=dev).manual_seed(seed))
            state = {p: o.init() for p, o in opts.items()}
            batches = extreme_batches(cfg, cmap, batch, 2, dev)
            params, state, m = step_fn(params, state, batches[0])
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            params, state, m = step_fn(params, state, batches[1])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            log(f"phase 8e: {optimizer} batch {batch}: peak device memory "
                f"of a step {peak} B above the card's {base} B before the "
                f"arm; resident after a step {resident} B (params "
                f"{state_bytes(params)} B, optimizer state "
                f"{state_bytes(state)} B); loss {float(m['loss'])}")
            del params, state, batches, m
    torch.cuda.empty_cache()


def phase_extreme_sites(cfg, dev, params, batch) -> None:
    """8f, C1's last sites at the extreme step's shapes: each gives the
    same bits twice on the card and the bits of a CPU copy.  The ordered
    table add of both tables' raw (ids, rows) gradients (every occurrence
    carries a row, as under ``stream``/``ref``), and the ``tiled``
    updates through it equal to one ``index_add_``; the dense path's
    plain routes (``ema_update_read_xla`` f32 and bf16,
    ``ema_update_read_ref`` bf16, int8 cells) over the class head's
    gradient into its (3, 7,168, 64) sketch; a 1-D ``DenseStore``."""
    import torch
    from repro_torch.core import sketch as cs
    from repro_torch.core.optimizers import (SketchHParams,
                                             apply_sparse_updates)
    from repro_torch.core.quantize import QuantState
    from repro_torch.core.stores import DenseStore
    from repro_torch.kernels import ops
    from repro_torch.train.extreme import extreme_grads
    _loss, grads = extreme_grads(params, batch)
    host_params = {k: {"table": v["table"].cpu()} for k, v in params.items()}

    def bits(xs):
        return [x.view(torch.int16) if x.dtype == torch.bfloat16 else x
                for x in xs]

    def check(name, run):
        before = read_counts()["cs_update"]
        a, b = run(dev), run(dev)
        used = read_counts()["cs_update"] - before
        h = run(torch.device("cpu"))
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(bits(a), bits(b)))
        cpu = all(torch.equal(x.cpu(), y) for x, y in zip(bits(a), bits(h)))
        log(f"phase 8f: {name}: two runs equal to the bit {same}, equal to a "
            f"CPU copy {cpu} ({used} B5 launches)")
        if not (same and cpu and used):
            raise AssertionError(f"{name}: same {same}, cpu {cpu}, B5 {used}")

    for path, g in grads.items():
        top = path.split("/")[0]

        def ordered(d, top=top, g=g):
            table = (params if d.type == "cuda" else host_params)[top]["table"]
            return [apply_sparse_updates(table.clone(), {
                "ids": g["ids"].to(d), "rows": g["rows"].to(d)})]
        check(f"apply_sparse_updates {path} ({g['ids'].numel()} "
              f"occurrences, {int(g['ids'].unique().numel())} ids)", ordered)
    step_fn, opts, state = extreme_step(cfg, dev, optimizer="cs_rmsprop")
    cost = {}
    for path, opt in opts.items():
        upd, _ = opt.update(grads[path], state[path])
        table = params[path.split("/")[0]]["table"]
        a = apply_sparse_updates(table.clone(), upd)
        b = apply_sparse_updates(table.clone(), upd, first_only=True)
        if not torch.equal(a, b):
            raise AssertionError(f"{path}: tiled updates through the ordered "
                                 f"add differ from one index_add_")
        cost[path] = [cuda_ms(lambda f=f: apply_sparse_updates(
            a, upd, first_only=f), reps=20, warmup=2) for f in (False, True)]
    log(f"phase 8f: tiled updates of both tables: the ordered add equal to "
        f"the bit to one index_add_ (later occurrences carry zeros); ms a "
        f"call [ordered, one index_add_] {json.dumps(cost)}")
    g = grads["class_head/table"]
    for name, dtype, fn in (("ema_update_read_xla f32", "float32",
                             ops.ema_update_read_xla),
                            ("ema_update_read_xla bf16", "bfloat16",
                             ops.ema_update_read_xla),
                            ("ema_update_read_ref bf16", "bfloat16",
                             ops.ema_update_read_ref),
                            ("ema_update_read_xla int8", "int8",
                             ops.ema_update_read_xla)):
        spec = SketchHParams(compression=100.0, dtype=dtype).spec(
            "class_head/table", (cfg.n_meta, cfg.dim), signed=True)

        def route(d, spec=spec, fn=fn):
            ids, rows = g["ids"].to(d), g["rows"].to(d)
            S = cs.update(spec, cs.init(spec, d), ids, rows * 3.0, sr_seed=5)
            S, est = fn(spec, S, ids, rows, beta=0.999, scale=1.0 - 0.999,
                        sr_seed=9)
            return (list(S) if isinstance(S, QuantState) else [S]) + [est]
        check(f"{name} into {spec.shape}", route)
    store = DenseStore().bind("s", (cfg.n_meta,), torch.float32)

    def dense_1d(d):
        return [store.accumulate(store.init(d) + 1.0, g["rows"][:, 0].to(d),
                                 g["ids"].to(d), scale=0.5)]
    check(f"DenseStore.accumulate 1-D ({cfg.n_meta},)", dense_1d)


def time_b1_extreme(dev, states, params, batch, specs=None,
                    tag: str = "extreme") -> list:
    """Phase 5 at the extreme step's shapes (8f for B1): B1 as the step
    calls it on both tables, without M (8a's ``cs_rmsprop`` state) and
    with M (8d's ``cs_adam`` state), on the last batch's gradient
    (``b1_case``).  ``specs`` (a plan's ``specs()``) sizes the sketches
    in place of ``SketchHParams(compression=100.0)``; ``states`` may hold
    one arm."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.extreme import extreme_grads
    _loss, grads = extreme_grads(params, batch)
    hp = SketchHParams(compression=100.0)
    rows_out = []
    for optimizer, track in (("cs_rmsprop", False), ("cs_adam", True)):
        if optimizer not in states:
            continue
        for path, g in grads.items():
            shape = tuple(params[path.split("/")[0]]["table"].shape)
            if specs is None:
                spec_m = hp.spec(path, shape, signed=True) if track else None
                spec_v = hp.spec(path, shape, signed=False)
            else:
                spec_m = specs[path]["m"] if track else None
                spec_v = specs[path]["v"]
            row = b1_case(
                states[optimizer][path], spec_m, spec_v, g["ids"], g["rows"],
                X_STEPS,
                check=f"phase {'8f' if specs is None else '9a'}: B1 at "
                      f"{path} ({optimizer}, sketches {spec_v.shape})",
                tag=f"phase 5 ({tag}): B1 {path} {optimizer}")
            rows_out.append(dict(table=path, optimizer=optimizer, **row))
    return rows_out


def b1_case(st, spec_m, spec_v, ids, g_rows, steps: int, check: str,
            tag: str) -> dict:
    """B1 as a step calls it on one batch into one table's state (``st``'s
    ``m``, None without M, and ``v``): held to the plain version on the
    card (M and V within atol 2e-5, upd bit-equal at each first position)
    and to a CPU copy (M and V bit-equal, upd within rtol 1e-6); its time
    beside its byte bound.  Returns the kernel row's fields."""
    import torch
    from repro_torch.kernels import dedup as dd, ops
    from repro_torch.kernels.cs_adam_tiled import (at_positions,
                                                   cs_adam_tiled,
                                                   cs_adam_tiled_plain)
    track = spec_m is not None
    eta, bc1, bc2 = ops._adam_hypers(steps, -1.0, 0.9, 0.999)
    kw = dict(lr=eta, b1=0.9 if track else 0.0, b2=0.999, eps=1e-8,
              bc1=bc1, bc2=bc2)
    batch_u = dd.dedup_rows(ids, g_rows)
    bm, sm, bv = ops._adam_addressing(spec_m, spec_v, batch_u.unique_ids)
    args = (st.get("m") if track else None, st["v"], bm, sm, bv,
            batch_u.rows)
    pos = (batch_u.inv, batch_u.first_pos)
    b1kw = dict(n_valid=batch_u.n_unique, positions=pos, **kw)
    want = cs_adam_tiled_plain(*clone(args), n_valid=batch_u.n_unique, **kw)
    got = cs_adam_tiled(*clone(args), **b1kw)
    err = max_err([w for w in want[:2] if w is not None],
                  [c for c in got[:2] if c is not None])
    upd_bit = torch.equal(at_positions(want[2], batch_u.first_pos), got[2])
    host = cs_adam_tiled(*on_cpu(args), n_valid=batch_u.n_unique.cpu(),
                         positions=on_cpu(pos), **kw)
    line = b1_vs_cpu(host, got)
    if not (upd_bit and err <= COLLISION_ATOL):
        raise AssertionError(f"{check}: upd bit-equal {upd_bit}, M/V err "
                             f"{err}")
    scratch = clone(args)
    ms = cuda_ms(lambda: cs_adam_tiled(*scratch, **b1kw), reps=20, warmup=3)
    parts = {name[:60]: t / 5 for t, _c, name in kernel_profile(
        lambda: [cs_adam_tiled(*scratch, **b1kw) for _ in range(5)]
        + [torch.cuda.synchronize()])[2]}
    plain_ms = cuda_ms(lambda: cs_adam_tiled_plain(
        *scratch, n_valid=batch_u.n_unique, **kw), reps=5)
    k, k_u, d = ids.numel(), int(batch_u.n_unique), g_rows.shape[1]
    rows_m = unique_rows(bm, k_u, spec_m.width) if track else 0
    rows_v = unique_rows(bv, k_u, spec_v.width)
    nbytes = b1_bytes(d, k, k_u, rows_m, rows_v, spec_v.depth, track)
    row = dict(width=spec_v.width, d=d, k=k, k_unique=k_u,
               touched_rows_m=rows_m, touched_rows_v=rows_v, bytes=nbytes,
               ms=ms, plain_ms=plain_ms, max_abs_err=err,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               device_ms_by_kernel=parts)
    log(f"{check} k_u={k_u} (of {k}): {line}; M/V max_abs_err {err} vs the "
        f"plain version on the card, upd bit-equal to it")
    log(f"{tag} d={d} width {spec_v.width}: {ms} ms, plain {plain_ms} ms, "
        f"bound {row['bound_ms']} ms ({nbytes} B at 3.35 TB/s; touched rows "
        f"M {rows_m} V {rows_v}); device ms a call by kernel "
        f"{json.dumps(parts)}")
    return row


# ---------------------------------------------------------------- phase 9
X_BUDGET = 5_701_632          # the V bytes of phase 8's compression 100
X_FOLDED = {"class_head/table": (3, 2_688, 64),     # V after 9e's fold
            "tok_embed/table": (3, 1_024, 64)}
DENSE_BUDGET, DENSE_WIDTH = 200_000_000, 9_216      # phase 6's layer
P_STEPS, P_SAVE_AT, P_DENSE_STEPS = 20, 10, 5


def moment_major(state) -> dict:
    """The extreme step's per-table states ``{path: {"step", "m", "v"}}``
    as one ``{"step", "m": {path}, "v": {path}}`` state: its leaf paths
    (``opt_state/v/<param path>``) are the ones the manifest's fold
    predicate names.  The tables' step counters are equal."""
    steps = {int(s["step"]) for s in state.values()}
    if len(steps) != 1:
        raise AssertionError(f"the tables' steps differ: {steps}")
    return {"step": next(iter(state.values()))["step"],
            "m": {p: s["m"] for p, s in state.items()},
            "v": {p: s["v"] for p, s in state.items()}}


def per_table(opt_state) -> dict:
    """The reverse of ``moment_major``."""
    return {p: {"step": opt_state["step"].clone(), "m": opt_state["m"][p],
                "v": opt_state["v"][p]} for p in opt_state["v"]}


def leaves_equal(a, b) -> bool:
    """Two trees of tensors (None, dicts, tuples) equal to the bit."""
    import torch
    from repro_torch.checkpoint.store import _flatten
    fa, fb = _flatten(a), _flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        (x is None and y is None) or (
            x is not None and y is not None and x.dtype == y.dtype
            and torch.equal(x.detach(), y.detach()))
        for (_, x), (_, y) in zip(fa, fb))


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def phase_planned_extreme(dev, seed: int, maps):
    """Phase 9a, 9b and 9e: phase 8's workload under ``plan_extreme(cfg,
    5,701,632, optimizer="cs_rmsprop", backend="auto")`` (see the module
    docstring).  Returns (9a's launch counts, the B1 rows at the planned
    shapes)."""
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.plan import measure_aux_bytes
    from repro_torch.train.extreme import (MachConfig, make_extreme_step,
                                           plan_extreme)
    cfg = MachConfig(**EXTREME)
    plan = plan_extreme(cfg, X_BUDGET, optimizer="cs_rmsprop",
                        backend="auto")
    backend = kernels.resolve_backend(plan.backend, dev)
    log(f"phase 9a: plan_extreme(MachConfig {EXTREME}, {X_BUDGET}, "
        f"optimizer='cs_rmsprop', backend='auto' -> {backend}):")
    for line in plan.table().splitlines():
        log(f"phase 9a:   {line}")
    if backend != "tiled" or plan.predicted_aux_bytes != X_BUDGET:
        raise AssertionError(f"backend {backend}, predicted "
                             f"{plan.predicted_aux_bytes} B")

    def fresh(p):
        init_fn, step_fn, opts = make_extreme_step(
            cfg, optimizer="cs_rmsprop", lr=X_LR, plan=p, device=dev)
        return init_fn, step_fn, {q: o.init() for q, o in opts.items()}

    init_fn, step_fn, state = fresh(plan)
    measured = sum(measure_aux_bytes(s) for s in state.values())
    log(f"phase 9a: measure_aux_bytes of the state {measured} B, plan "
        f"{plan.predicted_aux_bytes} B; V "
        + ", ".join(f"{p} {tuple(s['v'].shape)}" for p, s in state.items()))
    if measured != plan.predicted_aux_bytes:
        raise AssertionError("the planned state's bytes differ from the plan")
    params = init_fn(torch.Generator(device=dev).manual_seed(seed))
    start = [t.clone() for t in tables_of(params)]
    batches = extreme_batches(cfg, maps[0], X_BATCH, P_STEPS, dev)
    torch.cuda.synchronize()
    reset_counts()
    params, state, losses, ms = run_extreme(step_fn, params, state, batches)
    counts = read_counts()
    first, last = loss_windows(losses)
    step_ms = statistics.median(ms[1:])
    log(f"phase 9a: replica 0 cs_rmsprop under the plan, {P_STEPS} steps: "
        f"ms/step median of steps 2..{P_STEPS} {step_ms} (first {ms[0]}); "
        f"loss first {losses[0]} last {losses[-1]}; window means {first} -> "
        f"{last}; launches {counts} ({ {k: v / P_STEPS for k, v in counts.items()} } a step)")
    for name in ("cs_adam_tiled", "cs_update", "bucket_csr"):
        if counts[name] != 2 * P_STEPS:
            raise AssertionError(f"the planned step launched {name} "
                                 f"{counts[name]} times, not {2 * P_STEPS}")
    if not last < first:
        raise AssertionError("the planned extreme step's loss did not fall")
    if not all(torch.isfinite(t).all() for t in tables_of(params)):
        raise AssertionError("non-finite table under the plan")
    final = params_from(tables_of(params))
    final_state = {p: {"step": s["step"].clone(), "m": None,
                       "v": s["v"].clone()} for p, s in state.items()}
    more = extreme_batches(cfg, maps[0], X_BATCH, 5, dev, first=P_STEPS)
    profile_steps("phase 9a", lambda: run_extreme(step_fn, params, state,
                                                  more), step_ms,
                  by_name=True)
    del params, state
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="ckpt-") as tmp:
        like = phase_resume(cfg, dev, plan, start, batches, final,
                            final_state, losses, Path(tmp), fresh)
        phase_fold(cfg, dev, plan, batches, Path(tmp), like, fresh)
    rows = time_b1_extreme(dev, {"cs_rmsprop": final_state}, final,
                           batches[-1], specs=plan.specs(),
                           tag="planned extreme")
    return counts, rows


def phase_resume(cfg, dev, plan, start, batches, final, final_state, losses,
                 tmp: Path, fresh):
    """9b: 10 steps from 9a's start, an async save of the tables and state
    with the plan and StoreTree in the manifest, step 11 in place before
    the writer is joined; then a restore from the manifest's own plan into
    new tensors and steps 11..20: the tables, every state leaf and the
    losses must be 9a's to the bit.  Returns the restore's template."""
    import torch
    from repro_torch.checkpoint import store as ckpt
    from repro_torch.plan import Plan
    _init, step_fn, state = fresh(plan)
    params, state, first, _ = run_extreme(step_fn, params_from(start), state,
                                          batches[:P_SAVE_AT])
    saved = [t.clone() for t in tables_of(params)]
    torch.cuda.synchronize()
    extra = {"plan": plan.to_json(),
             "store_tree": plan.store_tree().to_json()}
    t0 = time.perf_counter()
    writer = ckpt.save(tmp, P_SAVE_AT,
                       {"params": params, "opt_state": moment_major(state)},
                       async_=True, extra=extra)
    block_s = time.perf_counter() - t0
    step_fn(params, state, batches[P_SAVE_AT])      # in place, mid-write
    torch.cuda.synchronize()
    writer.join()
    writer_s = time.perf_counter() - t0
    nbytes = dir_bytes(tmp / f"step-{P_SAVE_AT}")
    manifest = ckpt.read_manifest(tmp)
    rplan = Plan.from_json(manifest["extra"]["plan"])
    if rplan != plan:
        raise AssertionError("the manifest's plan differs from the run's")
    _init, r_step, r_state = fresh(rplan)
    like = {"params": params_from(start), "opt_state": moment_major(r_state)}
    t1 = time.perf_counter()
    step, tree = ckpt.restore(tmp, like, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    r_params, r_state = tree["params"], per_table(tree["opt_state"])
    at_save = [torch.equal(a, b) for a, b in zip(tables_of(r_params), saved)]
    moved = [not torch.equal(a, b)
             for a, b in zip(tables_of(r_params), tables_of(params))]
    log(f"phase 9b: async save at step {P_SAVE_AT}: blocked {block_s} s "
        f"(the copy to the host), writer {writer_s} s, {nbytes} B in "
        f"{len(manifest['leaves'])} leaves; restore {restore_s} s from the "
        f"manifest's own plan; restored tables equal to the step-{P_SAVE_AT}"
        f" tables {at_save}, differ from the live ones after the in-place "
        f"step {moved}")
    if step != P_SAVE_AT or not all(at_save) or not all(moved) or any(
            int(s["step"]) != P_SAVE_AT for s in r_state.values()):
        raise AssertionError("the checkpoint holds another step's state")
    del params, state
    r_params, r_state, rest, _ = run_extreme(r_step, r_params, r_state,
                                             batches[P_SAVE_AT:])
    same = {"tables": all(torch.equal(a, b) for a, b in
                          zip(tables_of(r_params), tables_of(final))),
            "state": leaves_equal(r_state, final_state),
            "losses": first + rest == losses}
    log(f"phase 9b: steps {P_SAVE_AT + 1}..{P_STEPS} from the restore: "
        f"equal to the bit to 9a's {P_STEPS} uninterrupted steps {same}")
    if not all(same.values()):
        raise AssertionError(f"the resumed run differs from 9a: {same}")
    return like


def phase_fold(cfg, dev, plan, batches, tmp: Path, like, fresh):
    """9e: 9b's checkpoint restored through ``fold_sketches`` under the
    manifest's fold predicate: V at half width, equal to ``S[:, :w/2] +
    S[:, w/2:]`` of the saved V, and 5 steps under ``plan.fold()``."""
    import torch
    from repro_torch.checkpoint import store as ckpt
    from repro_torch.plan import measure_aux_bytes
    manifest = ckpt.read_manifest(tmp)
    _step, tree = ckpt.restore(tmp, like, device=dev)
    folded = ckpt.fold_sketches(tree, ckpt.fold_predicate_from_manifest(
        manifest))
    fplan = plan.fold()
    shapes, halves = {}, {}
    for p, v in tree["opt_state"]["v"].items():
        w = v.shape[1]
        fv = folded["opt_state"]["v"][p]
        shapes[p] = tuple(fv.shape)
        halves[p] = torch.equal(fv, v[:, :w // 2] + v[:, w // 2:])
    want = {p: d["v"].shape for p, d in fplan.specs().items()}
    state = per_table(folded["opt_state"])
    nbytes = sum(measure_aux_bytes(s) for s in state.values())
    log(f"phase 9e: folded V {shapes} (plan.fold() {want}), each the sum of "
        f"the saved V's halves {halves}; {nbytes} B against "
        f"plan.fold()'s {fplan.predicted_aux_bytes}; tables unfolded "
        f"{[tuple(t.shape) for t in tables_of(folded['params'])]}")
    if shapes != want or shapes != X_FOLDED or not all(halves.values()) \
            or nbytes != fplan.predicted_aux_bytes:
        raise AssertionError("the folded restore is not plan.fold()'s state")
    _init, step_fn, _ = fresh(fplan)
    params, state, losses, ms = run_extreme(
        step_fn, folded["params"], state,
        batches[P_SAVE_AT:P_SAVE_AT + P_DENSE_STEPS])
    log(f"phase 9e: {len(losses)} steps under plan.fold(): losses {losses}, "
        f"ms/step {ms}")
    if not all(np.isfinite(losses)) or not all(
            torch.isfinite(t).all() for t in tables_of(params)):
        raise AssertionError("non-finite loss or table after the fold")


def softmax_shapes() -> dict:
    from repro_torch.plan import ShapeDtype
    return {"tok_embed": {"table": ShapeDtype((VOCAB, D_MODEL))},
            "final_norm": {"scale": ShapeDtype((D_MODEL,))}}


def round_trip(dev, state, tag: str) -> list:
    """Save ``state`` and restore it into new tensors on the card: equal
    to the bit, or raise.  Returns the manifest's leaf paths."""
    import tempfile
    from repro_torch.checkpoint import store as ckpt
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="ckpt-") as tmp:
        t0 = time.perf_counter()
        ckpt.save(tmp, int(state["step"]), {"opt_state": state})
        save_s = time.perf_counter() - t0
        _, back = ckpt.restore(tmp, {"opt_state": state}, device=dev)
        paths = [e["path"] for e in ckpt.read_manifest(tmp)["leaves"]]
        nbytes = dir_bytes(Path(tmp))
    same = leaves_equal(back["opt_state"], state)
    log(f"{tag}: state saved ({nbytes} B, {save_s} s) and restored: equal "
        f"to the bit {same}; leaves {paths}")
    if not same:
        raise AssertionError(f"{tag}: the restored state differs")
    return paths


def phase_planned_dense(dev, task):
    """9c and 9d on phase 6's softmax layer (see the module docstring).
    Returns 9c's launch counts."""
    import torch
    from repro_torch.plan import (measure_aux_bytes, min_budget_bytes,
                                  plan_for_params)
    shapes = softmax_shapes()
    plan = plan_for_params(shapes, DENSE_BUDGET)
    log(f"phase 9c: plan_for_params(qwen2-0.5b softmax layer, "
        f"{DENSE_BUDGET}):")
    for line in plan.table().splitlines():
        log(f"phase 9c:   {line}")
    if plan.leaf("tok_embed/table").width != DENSE_WIDTH:
        raise AssertionError(f"the {DENSE_BUDGET} B plan is not width "
                             f"{DENSE_WIDTH}")
    held0, _ = task.held_fresh()
    reset_counts()
    params, state, losses, ms, _step, _d = task.run(
        plan.make_optimizer(DENSE_LR, backend="auto"), DENSE_LR,
        steps=P_DENSE_STEPS)
    counts = read_counts()
    held, _ = task.held_fresh(params)
    nbytes = measure_aux_bytes(state)
    log(f"phase 9c: {P_DENSE_STEPS} steps at lr {DENSE_LR}, backend auto: "
        f"ms/step median of steps 2..{P_DENSE_STEPS} "
        f"{statistics.median(ms[1:])}; loss on batch 0's tokens {held0} -> "
        f"{held}; per-step {losses}; aux {nbytes} B (plan "
        f"{plan.predicted_aux_bytes}); launches {counts}")
    if counts["cs_ema_tiled"] != 2 * P_DENSE_STEPS:
        raise AssertionError(f"B3 launched {counts['cs_ema_tiled']} times, "
                             f"not {2 * P_DENSE_STEPS}")
    if not held < held0 or nbytes != plan.predicted_aux_bytes:
        raise AssertionError("the planned dense layer did not learn, or "
                             "its bytes differ from the plan")
    w_params, _, w_losses, _, _, _ = task.run(
        plan.make_optimizer(DENSE_LR, backend="xla"), DENSE_LR,
        steps=P_DENSE_STEPS)
    table, w_table = (params["tok_embed"]["table"].detach(),
                      w_params["tok_embed"]["table"].detach())
    log(f"phase 9c: plain xla witness: losses {w_losses}; table max_abs_err "
        f"{float((table - w_table).abs().max())}")
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(w_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    torch.testing.assert_close(table, w_table, **WITNESS_TOL)
    del w_params, w_table
    round_trip(dev, state, "phase 9c")
    del params, state
    floor = min_budget_bytes(shapes, sketch_first_moment=False)
    plan = plan_for_params(shapes, floor, sketch_first_moment=False)
    leaf = plan.leaf("tok_embed/table")
    log(f"phase 9d: CS-V floor {floor} B: tok_embed/table {leaf.mode}, v "
        f"{leaf.bytes_v} B beside a dense m of {leaf.bytes_m} B")
    if leaf.mode != "rank1" or leaf.bytes_v != (VOCAB + D_MODEL) * 4:
        raise AssertionError("the CS-V floor is not LR-NMF-V")
    params, state, losses, ms, _step, _d = task.run(
        plan.make_optimizer(DENSE_LR), DENSE_LR, steps=P_DENSE_STEPS)
    held, _ = task.held_fresh(params)
    v = state["v"]["tok_embed"]["table"]
    finite = all(bool(torch.isfinite(t).all()) for t in (
        v.r, v.c, state["m"]["tok_embed"]["table"],
        params["tok_embed"]["table"]))
    log(f"phase 9d: {P_DENSE_STEPS} steps: ms/step median "
        f"{statistics.median(ms[1:])}; loss on batch 0's tokens {held0} -> "
        f"{held}; per-step {losses}; state finite {finite}; aux "
        f"{measure_aux_bytes(state)} B")
    if not held < held0 or not finite \
            or measure_aux_bytes(state) != plan.predicted_aux_bytes:
        raise AssertionError("LR-NMF-V did not train, or its bytes differ")
    paths = round_trip(dev, state, "phase 9d")
    for name in (".r", ".c"):
        if f"opt_state/v/tok_embed/table/{name}" not in paths:
            raise AssertionError(f"no {name} leaf in the manifest")
    return counts


# ---------------------------------------------------------------- phase 10
# benchmarks/serving.py:45-47, :77-80 and repro/serve/server.py:99-104
SERVE_TRACE = dict(n_requests=600, n_users=256, ids_per_request=8,
                   alpha=1.1)
SERVE_LOADS = (100.0, 500.0, 5000.0)
SERVE_LR = 1e-3
OBS_EVERY, OBS_PROBE_K = 5, 16
TRACE_BATCHES = 3
TRACE_MARGIN_S = 0.05


# the plain versions a replay's batches also go through (10b): for the
# count-min arm the ``xla`` adapt step on the card (no B1, no B5) and the
# arm's own step on a CPU copy (every kernel's plain version)
SERVE_PLAINS = {"countmin": (("xla on the card", "cuda", "xla"),
                             ("a CPU copy", "cpu", None)),
                "dense": (("a CPU copy", "cpu", None),)}


def serve_arm(arm: str, dev, backend=None):
    """``(init_state_fn, adapt_fn)`` of one serving arm at full width;
    ``backend`` pins the count-min arm's kernel backend."""
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.serve import make_dense_adapt_step, make_online_adapt_step
    if arm == "countmin":
        return make_online_adapt_step(
            VOCAB, D_MODEL, lr=SERVE_LR, store_backend=backend,
            hparams=SketchHParams(compression=5.0), device=dev)
    return make_dense_adapt_step(VOCAB, D_MODEL, lr=SERVE_LR, device=dev)


def serve_table(dev, seed: int):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 40)
    return torch.randn((VOCAB, D_MODEL), generator=gen, device=dev) \
        / float(np.sqrt(D_MODEL))


def served_batches(comps):
    """The dispatched batches of a replay, in order: the requests of each
    published version, in arrival order."""
    by_version = {}
    for c in comps:
        if not c.shed:
            by_version.setdefault(c.version, []).append(c.request)
    return [by_version[v] for v in sorted(by_version)]


def equal_trees(a, b) -> bool:
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, torch.Tensor):
        return a.device == b.device and torch.equal(a, b)
    return a == b


def tree_err(a, b) -> float:
    """The largest absolute difference between two state trees' tensors,
    ``b``'s possibly on another device."""
    import torch
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"keys {sorted(a)} and {sorted(b)}")
        return max([tree_err(a[k], b[k]) for k in a], default=0.0)
    if isinstance(a, torch.Tensor):
        return float((a - b.to(a.device)).abs().max()) if a.numel() else 0.0
    if a != b:
        raise AssertionError(f"{a!r} and {b!r} differ")
    return 0.0


def state_sample(state, ids) -> list:
    """What the reader thread gathers from an optimizer state, parts that
    every adapt batch changes: the rows ``ids`` of each table-shaped
    moment, and the first 4 columns of each sketch."""
    return [x[ids] if x.shape[0] == VOCAB else x[..., :4].clone()
            for x in state.values() if x is not None and x.dim() >= 2]


def raw_steps(init_fn, adapt_fn, table0, batches, k: int, dev,
              at_version=None):
    """The dispatched batches applied in order through the raw adapt step
    from a copy of ``table0`` on ``dev``; ``at_version(v, table, state)``
    sees each version."""
    from repro_torch.serve import coalesce
    t, s = table0.to(dev, copy=True), init_fn()
    for v, reqs in enumerate(batches, start=1):
        t, s = adapt_fn(t, s, *coalesce(reqs, k, dev))
        if at_version is not None:
            at_version(v, t, s)
    return t, s


class TornReadWatch:
    """A reader thread that, during a replay, takes the published snapshot
    and gathers from it the rows ``ids`` of the table and
    ``state_sample`` of its optimizer state, keeping the first gather of
    each version.  The torn-read test is the caller's: each kept gather
    must equal the raw trajectory's at its version, which a snapshot
    whose table and state came from different generations would fail."""

    def __init__(self, server, ids, max_samples: int = 400):
        import threading
        self.server, self.ids, self.cap = server, ids, max_samples
        self.samples, self.reads = {}, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            snap = self.server.store.read()
            got = (snap.table[self.ids], state_sample(snap.opt_state,
                                                      self.ids))
            self.reads += 1
            if snap.version not in self.samples \
                    and len(self.samples) < self.cap:
                self.samples[snap.version] = got
            time.sleep(2e-4)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def serve_replay(table0, init_fn, adapt_fn, cfg, trace, arm: str,
                 watch_ids=None):
    """One replay of ``trace`` from ``table0`` (warmed up outside it), with
    a ``TornReadWatch`` on ``watch_ids`` when given.  Checks that B1 (on
    the count-min arm), its CSR and the dedup sum (B5) launched once a
    batch and that the versions count the batches.  Returns ``(server,
    batches, counts, watch)``."""
    import contextlib

    import torch
    from repro_torch.serve import AdaptServer, replay
    server = AdaptServer(table0.clone(), init_fn(), adapt_fn, cfg)
    server.warmup()
    torch.cuda.synchronize()
    reset_counts()
    with (TornReadWatch(server, watch_ids) if watch_ids is not None
          else contextlib.nullcontext()) as watch:
        comps = replay(server, trace, warmup=False)
    counts = read_counts()
    n_b = server.n_batches
    if counts["cs_adam_tiled"] != (n_b if arm == "countmin" else 0) \
            or counts["cs_update"] != n_b \
            or (arm == "countmin" and counts["bucket_csr"] != n_b):
        raise AssertionError(
            f"{arm}: {n_b} batches but launches {counts}: B1 (count-min), "
            f"its CSR and the dedup sum (B5) must launch once a batch")
    batches = served_batches(comps)
    if len(batches) != n_b or server.store.version != n_b:
        raise AssertionError("versions do not count batches")
    return server, batches, counts, watch


def latency_line(rec) -> str:
    return (f"adapt p50 {rec['adapt_ms']['p50_ms']} ms p99 "
            f"{rec['adapt_ms']['p99_ms']} ms; request p99 "
            f"{rec['request_ms']['p99_ms']} ms; reads/s {rec['reads_per_s']}")


def hold_to_plains(arm: str, snap, batches, k: int, table0) -> str:
    """10b's witnesses of one replay: its batches through ``SERVE_PLAINS``
    from the same start, the served table and state within
    ``COLLISION_ATOL`` of each.  Returns the line's text."""
    parts = []
    for name, device, backend in SERVE_PLAINS[arm]:
        t0 = time.perf_counter()
        init_fn, adapt_fn = serve_arm(arm, device, backend)
        t, s = raw_steps(init_fn, adapt_fn, table0, batches, k, device)
        e_t, e_s = tree_err(snap.table, t), tree_err(snap.opt_state, s)
        if max(e_t, e_s) > COLLISION_ATOL:
            raise AssertionError(
                f"{arm}: the served table and state differ from {name} "
                f"over the same batches: max_abs_err {e_t} and {e_s} (atol "
                f"{COLLISION_ATOL})")
        parts.append(f"{name} max_abs_err table {e_t} state {e_s} "
                     f"({time.perf_counter() - t0:.1f} s)")
        del t, s
    return "; ".join(parts)


def phase_serving(dev, seed: int):
    """10a, 10b and the trace dump (see the module docstring).  Returns
    the launch counts of the timed replays and B1's row at the serving
    shapes."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.optimizers import SketchHParams, state_bytes
    from repro_torch.obs import MetricsWriter, maybe_trace, report, \
        validate_file
    from repro_torch.serve import (ServerConfig, TraceConfig, coalesce,
                                   make_trace, timed_adapt, trace_stats)
    from repro_torch.serve.buffer import clone_tree
    cfg = ServerConfig()
    table0 = serve_table(dev, seed)
    total, b1_row = {}, None
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="serve-"))
    try:
        writer = MetricsWriter(tmp, run_meta={
            "workload": "serve-replay", "table": [VOCAB, D_MODEL],
            "lr": SERVE_LR, **SERVE_TRACE})
        for arm in ("countmin", "dense"):
            init_fn, adapt_fn = serve_arm(arm, dev)
            gen_bytes = table0.numel() * 4 + state_bytes(init_fn())
            work = clone_tree((table0, init_fn()))
            copy_ms = cuda_ms(lambda: clone_tree(work), reps=5)
            log(f"phase 10a: {arm}: one generation {gen_bytes} B; its "
                f"copy-on-write copy {copy_ms} ms (bound "
                f"{2 * gen_bytes / HBM_BYTES_PER_S * 1e3} ms: read + write "
                f"at {HBM_BYTES_PER_S / 1e12} TB/s)")
            del work
            for load in SERVE_LOADS:
                trace = make_trace(TraceConfig(
                    n_rows=VOCAB, dim=D_MODEL, offered_load=load, seed=seed,
                    **SERVE_TRACE))
                # the timed replay: the server's thread alone
                server, batches, counts, _ = serve_replay(
                    table0, init_fn, adapt_fn, cfg, trace, arm)
                for name, n in counts.items():
                    total[name] = total.get(name, 0) + n
                snap = server.store.read()
                rec = server.emit(
                    writer, arm=arm, offered_load=load,
                    state_bytes=state_bytes(snap.opt_state),
                    b1_launches=counts["cs_adam_tiled"],
                    b5_launches=counts["cs_update"],
                    csr_launches=counts["bucket_csr"],
                    **trace_stats(trace))
                n_b = server.n_batches
                log(f"phase 10a: {arm} at {load} req/s: {latency_line(rec)}; "
                    f"batches {n_b}; shed rate {rec['shed_rate']} "
                    f"({server.n_shed}/{len(trace)}); state_bytes "
                    f"{rec['state_bytes']}; launches {counts}")
                # 10b: the same coalesced batches through the raw step,
                # then through the plain versions
                t_ref, s_ref = raw_steps(init_fn, adapt_fn, table0, batches,
                                         cfg.batch_ids, dev)
                if not torch.equal(snap.table, t_ref) \
                        or not equal_trees(snap.opt_state, s_ref):
                    raise AssertionError(
                        f"{arm} at {load} req/s: the served table and "
                        f"state differ from the raw step over the same "
                        f"batches")
                del t_ref, s_ref
                plains = hold_to_plains(arm, snap, batches, cfg.batch_ids,
                                        table0)
                log(f"phase 10b: {arm} at {load} req/s: served table and "
                    f"state equal to the bit to {n_b} raw steps over the "
                    f"same batches; against the plain versions: {plains}")
                if arm == "countmin" and load == SERVE_LOADS[-1]:
                    # phase 5 at the serving shapes: B1 on the last batch
                    # into the served V
                    ids, rows = coalesce(batches[-1], cfg.batch_ids, dev)
                    spec_v = SketchHParams(compression=5.0).spec(
                        "serve_adapt", (VOCAB, D_MODEL), signed=False)
                    b1_row = dict(table="serve_adapt", optimizer=arm,
                                  **b1_case(
                        snap.opt_state, None, spec_v, ids, rows, n_b,
                        check=f"phase 10b: B1 at the serving shapes "
                              f"(sketch {spec_v.shape})",
                        tag="phase 5 (serving): B1"))
                del server, snap
                # the torn-read test: the same trace again, with a reader
                # thread (its latencies are not the published ones)
                watch_ids = torch.from_numpy(np.unique(np.concatenate(
                    [r.ids for r in trace[:8]]))).to(dev)
                server, batches, _, watch = serve_replay(
                    table0, init_fn, adapt_fn, cfg, trace, arm,
                    watch_ids=watch_ids)

                def at_version(v, t, s):
                    seen = watch.samples.get(v)
                    if seen is not None and not (
                            torch.equal(seen[0], t[watch_ids])
                            and all(torch.equal(a, b) for a, b in zip(
                                seen[1], state_sample(s, watch_ids),
                                strict=True))):
                        raise AssertionError(
                            f"a reader saw version {v}'s table rows or "
                            f"state differ from the raw trajectory's")

                t_ref, s_ref = raw_steps(init_fn, adapt_fn, table0, batches,
                                         cfg.batch_ids, dev, at_version)
                snap = server.store.read()
                if not torch.equal(snap.table, t_ref) \
                        or not equal_trees(snap.opt_state, s_ref):
                    raise AssertionError(
                        f"{arm} at {load} req/s with a reader: the served "
                        f"table and state differ from the raw step")
                log(f"phase 10b: {arm} at {load} req/s, replayed with a "
                    f"reader thread: {watch.reads} reads, "
                    f"{len(watch.samples)} versions' table rows and state "
                    f"samples equal to the raw trajectory's at their "
                    f"version, no torn snapshot; served table and state "
                    f"equal to the bit to {server.n_batches} raw steps; "
                    f"with the reader: "
                    f"{latency_line(server.metrics_record())}")
                del server, t_ref, s_ref, snap, watch
            phase_serving_bits(dev, arm, init_fn, adapt_fn, table0, trace)
        writer.close()
        recs = validate_file(writer.path)
        if sum(r["kind"] == "serve" for r in recs) != 2 * len(SERVE_LOADS):
            raise AssertionError("a serve record is missing")
        log(f"phase 10a: {len(recs)} records validate; "
            f"python -m repro_torch.obs.report (non-strict):")
        if report.main([str(writer.path)]) != 0:
            raise AssertionError("the report failed")
        # the trace dump: three adapt batches under torch.profiler
        init_fn, adapt_fn = serve_arm("countmin", dev)
        adapt, _lat = timed_adapt(adapt_fn)
        t, s = table0.clone(), init_fn()
        reqs = make_trace(TraceConfig(n_rows=VOCAB, dim=D_MODEL, seed=seed,
                                      **SERVE_TRACE))
        batches = [coalesce(reqs[32 * i:32 * (i + 1)], cfg.batch_ids, dev)
                   for i in range(TRACE_BATCHES + 1)]
        t, s = adapt(t, s, *batches[0])
        with maybe_trace(str(tmp / "trace")):
            # idle margins: the profiler drops device events that its
            # host-clock conversion places outside its window
            time.sleep(TRACE_MARGIN_S)
            for ids, rows in batches[1:]:
                t, s = adapt(t, s, ids, rows)
            time.sleep(TRACE_MARGIN_S)
        files = list((tmp / "trace").glob("*.pt.trace.json"))
        events = json.loads(files[0].read_text())["traceEvents"]
        spans = [e for e in events if e.get("name") == "obs.adapt"]
        # the port's kernels live in the csrc files' anonymous namespaces
        ours = [e["name"].split("::")[1].split("<")[0].split("(")[0]
                for e in events if e.get("cat") == "kernel"
                and "(anonymous namespace)::" in e.get("name", "")]
        log(f"phase 10a: maybe_trace of {TRACE_BATCHES} adapt batches: "
            f"{len(spans)} obs.adapt spans (host and device rows); the "
            f"port's kernels in it "
            f"{ {n: ours.count(n) for n in sorted(set(ours))} }")
        if len(spans) < TRACE_BATCHES or ours.count("tiled_read") \
                != TRACE_BATCHES:
            raise AssertionError("the trace lacks the obs.adapt spans or "
                                 "B1's read")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total, b1_row


def phase_serving_bits(dev, arm, init_fn, adapt_fn, table0, trace):
    """10b's single-batch checks for one arm: a coalesced batch against
    its raw concatenation, ``dedup_coalesce`` against a CPU copy, and a
    held generation after two more publishes."""
    import torch
    from repro_torch.serve import (DoubleBufferedStore, ServerConfig,
                                   coalesce, dedup_coalesce)
    from repro_torch.serve.buffer import clone_tree
    k = ServerConfig().batch_ids
    reqs = trace[:20]                                  # 160 of 256 slots
    raw_ids = torch.from_numpy(np.concatenate([r.ids for r in reqs])).to(dev)
    raw_rows = torch.from_numpy(np.concatenate([r.grad_rows for r in reqs]
                                               )).to(dev)
    ids, rows = coalesce(reqs, k, dev)
    t_raw, s_raw = adapt_fn(table0.clone(), init_fn(), raw_ids, raw_rows)
    t_co, s_co = adapt_fn(table0.clone(), init_fn(), ids, rows)
    if not torch.equal(t_raw, t_co) or not equal_trees(s_raw, s_co):
        raise AssertionError(f"{arm}: a coalesced batch differs from its "
                             f"raw concatenation")
    del t_raw, s_raw, t_co, s_co
    uids, sums, n_u = dedup_coalesce(ids, rows)
    c_ids, c_sums, c_n = dedup_coalesce(ids.cpu(), rows.cpu())
    if not (torch.equal(uids.cpu(), c_ids) and torch.equal(sums.cpu(), c_sums)
            and int(n_u) == int(c_n)) or bool((uids < 0).any()):
        raise AssertionError("dedup_coalesce differs from its CPU copy")
    store = DoubleBufferedStore(table0.clone(), init_fn())
    for _ in range(2):
        store.stage(*adapt_fn(*store.begin_adapt(), ids, rows))
        store.publish()
    held = store.read()
    frozen = clone_tree((held.table, held.opt_state))
    for _ in range(2):
        store.stage(*adapt_fn(*store.begin_adapt(), ids, rows))
        store.publish()
    if not (torch.equal(held.table, frozen[0])
            and equal_trees(held.opt_state, frozen[1])) \
            or store.version != held.version + 2:
        raise AssertionError("a held generation changed")
    log(f"phase 10b: {arm}: one coalesced batch (160 live of {k} slots) "
        f"equal to the bit to its raw concatenation; dedup_coalesce "
        f"({int(n_u)} unique ids) equal to the bit to a CPU copy; a held "
        f"generation reads the same bits after two more publishes")


def phase_observed(dev, seed: int):
    """10c (see the module docstring).  Returns its launch counts."""
    import shutil
    import tempfile

    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.obs import (MetricsWriter, PhaseTimer, RunObserver,
                                 StepAccumulator, TableMonitor, TableProbe,
                                 predicted_table_errors, validate_file)
    from repro_torch.train.steps import (make_sparse_embedding_step,
                                         sparse_embedding_stores)
    hp = SketchHParams()
    init_fn, step_fn, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=LR, hparams=hp, device=dev)
    m_store, v_store = sparse_embedding_stores(VOCAB, D_MODEL, hparams=hp)
    table0 = init_fn(torch.Generator(device=dev).manual_seed(seed + 50))
    target = init_fn(torch.Generator(device=dev).manual_seed(seed + 51))
    batches = [torch.from_numpy(b).to(dev)
               for b in zipf_ids(np.random.RandomState(seed + 50), STEPS)]

    def step(table, state, ids):
        idx = ids.long()
        rows = table[idx] - target[idx]
        loss = torch.mean(rows * rows)
        table, state = step_fn(table, state, ids, rows)
        return table, state, rows, loss

    def window_ms(marks):
        return [(b - a) * 1e3 / OBS_EVERY for a, b in zip(marks, marks[1:])]

    probe = TableProbe.for_table("tok_embed", VOCAB, k=OBS_PROBE_K)
    # one step, one probe update and one probe read first: the kernels
    # build, the hash parameters and probe ids reach the card, cuBLAS
    # starts
    table, state, rows, _ = step(table0.clone(), opt.init(), batches[0])
    warm = probe.update(probe.init(D_MODEL, dev), batches[0], rows)
    probe.errors(warm, m_store=m_store, m_state=state["m"], v_store=v_store,
                 v_state=state["v"])
    # the same 20 steps without the observer, synchronised where the
    # observer's windows end
    table, state = table0.clone(), opt.init()
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    for i, ids in enumerate(batches, start=1):
        table, state, _, _ = step(table, state, ids)
        if i % OBS_EVERY == 0:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
    plain = window_ms(marks)
    plain_table = table

    mon = TableMonitor("tok_embed", m_store=m_store, v_store=v_store,
                       probe=probe, predicted=predicted_table_errors(
                           m_store, v_store, VOCAB, alpha=ZIPF_A))
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build", prefix="obs-"))
    try:
        obs = RunObserver(MetricsWriter(tmp, run_meta={
            "workload": "sparse_embedding", "table": [VOCAB, D_MODEL]}),
            monitors=[mon], log_every=OBS_EVERY, phase_timer=PhaseTimer())
        acc = StepAccumulator()
        table, state = table0.clone(), opt.init()
        pstate = probe.init(D_MODEL, dev)
        torch.cuda.synchronize()
        reset_counts()
        t_win = time.perf_counter()
        marks, window_s = [t_win], 0.0
        for i, ids in enumerate(batches, start=1):
            ts = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with obs.phase("step"):
                    table, state, rows, loss = step(table, state, ids)
                    probe.update(pstate, ids, rows)
                acc.add({"loss": loss})
            finally:
                torch.cuda.set_sync_debug_mode(0)
            st = {"m": state["m"], "v": state["v"], "probe": pstate}
            if i % OBS_EVERY:
                dt = time.perf_counter() - ts
                window_s += dt
                obs.on_step(i, {"step": i, "time_s": dt})
                continue
            rec = acc.drain()                     # the window's one fetch
            now = time.perf_counter()
            obs.on_step(i, {"step": i, "time_s": (now - t_win) - window_s,
                            **rec}, st)
            t_win, window_s = time.perf_counter(), 0.0
            marks.append(t_win)
        obs.close(STEPS, st)
        observed = window_ms(marks)
        counts = read_counts()
        recs = validate_file(tmp / "metrics.jsonl")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tables = [r for r in recs if r["kind"] == "table"]
    if [t["step"] for t in tables] != list(range(OBS_EVERY, STEPS + 1,
                                                 OBS_EVERY)):
        raise AssertionError(f"table records at {[t['step'] for t in tables]}")
    for field in ("v_occupancy", "m_occupancy", "v_meas_error",
                  "m_meas_error", "v_pred_error", "m_pred_error",
                  "v_error_ratio", "m_error_ratio", "probe_rows_seen"):
        if field not in tables[-1]:
            raise AssertionError(f"the table record lacks {field}")
    if not torch.equal(table, plain_table):
        raise AssertionError("the observed steps changed the table")
    if counts["cs_adam_tiled"] != STEPS or counts["cs_update"] != STEPS \
            or counts["bucket_csr"] != STEPS:
        raise AssertionError(f"10c launches {counts}")
    last = tables[-1]
    log(f"phase 10c: {STEPS} steps under RunObserver(log_every="
        f"{OBS_EVERY}), TableProbe(k={OBS_PROBE_K}), PhaseTimer: "
        f"{len(recs)} records validate, steps between boundaries under "
        f"sync-debug 'error'; ms/step by window of {OBS_EVERY} with the "
        f"observer {observed} (mean {statistics.mean(observed)}), without "
        f"{plain} (mean {statistics.mean(plain)}), the same table to the "
        f"bit; launches {counts}")
    log("phase 10c: last table record " + json.dumps(
        {k: last[k] for k in sorted(last)
         if k not in ("table", "kind", "schema")}))
    log("phase 10c: step records " + json.dumps(
        [{k: r[k] for k in ("step", "steps_per_s", "loss") if k in r}
         for r in recs if r["kind"] == "step"]))
    return counts


# --------------------------------------------------------------- phase 11
LM_ARCH = "qwen2_0_5b"             # src/repro/configs/qwen2_0_5b.py:10-17
LM_BATCH, LM_SEQ = 4, 2_048        # two attn_chunk and four loss_chunk
LM_STEPS, LM_SHORT = 20, 5         # 11a-c and 11e; 11d and 11f
LM_LR = 1e-3
SERVE_BATCH, SERVE_MAX_SEQ, PROMPT, DECODE = 8, 256, 128, 64
# 11g: decode against the prefill of the same prefix in bf16 compute:
# within 2^-6 of the row's largest |logit| (two to four bf16 ulps of it)
DECODE_TOL = 2.0 ** -6


def lm_tree_close(got, want) -> float:
    """Every leaf within the witness envelope; returns the max abs
    difference."""
    import torch
    from repro_torch.checkpoint.store import _flatten
    worst = 0.0
    for (p, a), (q, b) in zip(_flatten(got), _flatten(want)):
        if p != q or (a is None) != (b is None):
            raise AssertionError(f"trees differ at {p!r} / {q!r}")
        if a is None or a.dim() == 0:
            continue
        torch.testing.assert_close(a, b, **WITNESS_TOL, msg=p)
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    return worst


def learns(what: str, losses) -> None:
    """Finite losses that pass the window check."""
    first, last = loss_windows(losses)
    if not (all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"phase {what}: the loss did not fall: "
                             f"{losses}")
    log(f"phase {what}: window check {first} -> {last}")


def lm_config():
    from repro_torch import configs
    return configs.get(LM_ARCH)


class LMRun:
    """The qwen2-0.5b train step at full width through ``Trainer``: the
    start params drawn once, the ``ZipfLM`` batches, per-step CUDA-event
    times, launches and peak memory of each arm."""

    def __init__(self, dev, seed: int):
        import torch
        from repro_torch.data import ZipfLM, ZipfLMConfig
        from repro_torch.train.steps import make_train_step
        self.dev, self.seed = dev, seed
        self.cfg = lm_config()
        ts = make_train_step(self.cfg, optimizer="cs_adam", device=dev)
        self.start = ts.init_fn(torch.Generator(device=dev).manual_seed(seed))
        self.data = ZipfLM(ZipfLMConfig(vocab_size=self.cfg.vocab,
                                        seq_len=LM_SEQ,
                                        global_batch=LM_BATCH, seed=seed))

    def step(self, optimizer="cs_adam", backend="auto", plan=None):
        from repro_torch.train.steps import make_train_step
        return make_train_step(self.cfg, optimizer=optimizer, lr=LM_LR,
                               kernel_backend=backend, plan=plan,
                               device=self.dev)

    def fresh(self, ts):
        from repro_torch.train.trainer import TrainState
        params = clone_tree(self.start)
        return TrainState(step=0, params=params,
                          opt_state=ts.optimizer.init(params))

    def fit(self, ts, steps: int, state=None, ckpt_dir=None, restore=False,
            snapshot=None):
        """Run ``ts`` through a ``Trainer`` to ``steps``; returns (final
        state, per-step losses, per-step device ms, launches, the arm's
        peak memory above what was allocated before it).  ``snapshot``:
        after that many steps the params and state are copied to the
        host, into ``self.snapshot``."""
        import torch
        from repro_torch.train.trainer import Trainer, TrainerConfig
        events = []

        def timed(params, opt_state, batch):
            if snapshot is not None and len(events) == snapshot:
                self.snapshot = to_host({"params": params,
                                         "opt_state": opt_state})
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = ts.step_fn(params, opt_state, batch)
            e1.record()
            events.append((e0, e1))
            return out

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(timed, self.data, TrainerConfig(
            total_steps=steps, ckpt_dir=ckpt_dir, ckpt_every=10 ** 9),
            device=self.dev)
        if state is None:
            state = self.fresh(ts)
        if restore:
            state = trainer.restore_or_init(state)
            # the second leg writes no checkpoint of its own
            trainer.tcfg = TrainerConfig(total_steps=steps)
        reset_counts()
        state = trainer.fit(state)
        counts = read_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = [a.elapsed_time(b) for a, b in events]
        self.wall_ms = [h["time_s"] * 1e3 for h in trainer.history]
        return (state, [h["loss"] for h in trainer.history], ms, counts,
                peak, trainer)


def clone_tree(tree):
    import torch
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def phase_lm(dev, seed: int):
    """Phase 11a-f: the qwen2-0.5b train step (see the module
    docstring).  Returns (11a's launch counts, 11f's, the trained params,
    the numbers logged for the kernels' line)."""
    import torch
    from repro_torch.core.optimizers import state_bytes
    from repro_torch.core.partition import leaf_paths
    from repro_torch.plan import measure_aux_bytes, plan_for_config
    run = LMRun(dev, seed)
    cfg = run.cfg
    n_params = sum(t.numel() for _p, t in leaf_paths(run.start))
    log(f"phase 11: {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads, d_ff {cfg.d_ff}, "
        f"tok_embed/table and lm_head/table {cfg.vocab} x {cfg.d_model}, "
        f"{n_params} params, {cfg.compute_dtype} compute; ZipfLM "
        f"{LM_BATCH} x {LM_SEQ} tokens a step; cs_adam lr {LM_LR}, "
        f"kernel_backend auto")

    # 11a
    ts = run.step()
    state, losses, ms, counts, peak, _ = run.fit(ts, LM_STEPS)
    first, last = loss_windows(losses)
    step_ms = statistics.median(ms[1:])
    sk = {p: tuple(t.shape) for p, t in leaf_paths(state.opt_state["v"])
          if "table" in p}
    log(f"phase 11a: {LM_STEPS} steps: ms/step (CUDA events) median of "
        f"steps 2..{LM_STEPS} {step_ms} (first {ms[0]}); all {ms}; the "
        f"Trainer's host time a step, median "
        f"{statistics.median(run.wall_ms[1:])}")
    log(f"phase 11a: losses {losses}; window check {first} -> {last}; "
        f"launches {counts} ({counts['cs_ema_tiled'] / LM_STEPS} B3 a "
        f"step); v sketches {sk}; peak memory of the arm {peak} B")
    if counts["cs_ema_tiled"] != 4 * LM_STEPS:
        raise AssertionError(f"B3 launched {counts['cs_ema_tiled']} times "
                             f"in {LM_STEPS} steps, not 4 a step (M and V "
                             f"of two tables)")
    flash = (counts["flash_attn_fwd"], counts["flash_attn_bwd"])
    if flash != (2 * cfg.n_layers * LM_STEPS, cfg.n_layers * LM_STEPS):
        raise AssertionError(f"B10 launched {flash} times (forward, "
                             f"backward) in {LM_STEPS} steps, not "
                             f"{2 * cfg.n_layers} and {cfg.n_layers} a step")
    # the sketched first moment's spike sits in the first window, so this
    # gate does not test learning here; 11d and 11f gate the arms that learn
    if not last < first:
        raise AssertionError(f"the LM loss did not fall: {first} -> {last}")
    if not all(bool(torch.isfinite(t).all())
               for _p, t in leaf_paths(state.params)):
        raise AssertionError("non-finite params")
    cs_bytes = (measure_aux_bytes(state.opt_state),
                state_bytes(state.opt_state))

    data_more = [{k: torch.as_tensor(v).to(dev) for k, v in
                  run.data.batch(LM_STEPS + i).items()} for i in range(4)]
    p, s = clone_tree(state.params), clone_tree(state.opt_state)

    def three():
        nonlocal p, s
        for b in data_more[:3]:
            p, s, _ = ts.step_fn(p, s, b)
        torch.cuda.synchronize()
    profile_steps("phase 11a (profile)", three, step_ms, n=3)
    # a step as the Trainer calls it makes no host-device synchronisation
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        p, s, m = ts.step_fn(p, s, data_more[3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"phase 11a: one more step under set_sync_debug_mode('error'): "
        f"loss {float(m['loss'])}")
    del p, s

    # 11b: the plain xla witness from the same start on the same batches
    w_state, w_losses, w_ms, w_counts, _, _ = run.fit(
        run.step(backend="xla"), LM_STEPS)
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(w_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    err_p = lm_tree_close(w_state.params, state.params)
    err_s = lm_tree_close(w_state.opt_state, state.opt_state)
    bits = (losses == w_losses and leaves_equal(w_state.params, state.params)
            and leaves_equal(w_state.opt_state, state.opt_state))
    log(f"phase 11b: plain xla: ms/step median {statistics.median(w_ms[1:])}"
        f"; launches {w_counts}; losses max rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(losses, w_losses))}, "
        f"params max_abs_err {err_p}, state {err_s} (rtol "
        f"{WITNESS_TOL['rtol']}, atol {WITNESS_TOL['atol']}); equal to the "
        f"bit: {bits}")
    del w_state

    # 11c: the auto arm again
    r_state, r_losses, _, _, _, _ = run.fit(ts, LM_STEPS)
    if not (r_losses == losses and leaves_equal(r_state.params, state.params)
            and leaves_equal(r_state.opt_state, state.opt_state)):
        raise AssertionError("the auto arm run twice gave other bits")
    log(f"phase 11c: the auto arm run again: losses, params and state equal "
        f"to the bit")
    del r_state

    # 11d: dense Adam
    d_state, d_losses, d_ms, d_counts, d_peak, _ = run.fit(
        run.step(optimizer="dense_adam", backend=None), LM_SHORT)
    d_bytes = (measure_aux_bytes(d_state.opt_state),
               state_bytes(d_state.opt_state))
    log(f"phase 11d: dense_adam {LM_SHORT} steps: losses {d_losses}; ms/step "
        f"median {statistics.median(d_ms[1:])}; optimizer state {d_bytes[0]}"
        f" B (m and v; {d_bytes[1]} with the step counter) against "
        f"cs_adam's {cs_bytes[0]} B ({cs_bytes[1]}): "
        f"{cs_bytes[0] / d_bytes[0]}"
        f"; peak memory of the arm {d_peak} B against cs_adam's {peak} B; "
        f"launches {d_counts}")
    del d_state
    learns("11d: dense_adam", d_losses)
    # which moment's sketch moves the cs_adam losses: CS-V, the first
    # moment dense
    v_state, v_losses, _, v_counts, _, _ = run.fit(
        run.step(optimizer="cs_adam_v"), LM_SHORT)
    log(f"phase 11d: cs_adam_v (dense m, sketched v) {LM_SHORT} steps: "
        f"losses {v_losses} against cs_adam's {losses[:LM_SHORT]}; launches "
        f"{v_counts}")
    del v_state
    learns("11d: cs_adam_v", v_losses)

    # 11e: 10 steps, an async save, a restore into a new Trainer, 10 more
    ckpt = ROOT / "build" / f"ckpt-lm-{seed}"
    if ckpt.exists():
        shutil.rmtree(ckpt)
    half = LM_STEPS // 2
    try:
        t0 = time.perf_counter()
        h_state, h_losses, _, _, _, _ = run.fit(ts, half, ckpt_dir=str(ckpt))
        save_s = time.perf_counter() - t0
        size = dir_bytes(ckpt)
        del h_state
        t0 = time.perf_counter()
        e_state, e_losses, _, _, _, trainer = run.fit(
            ts, LM_STEPS, ckpt_dir=str(ckpt), restore=True)
        log(f"phase 11e: {half} steps and an async save ({size} B, "
            f"{save_s} s with the steps), a restore into a new Trainer and "
            f"steps {half + 1}..{LM_STEPS} ({time.perf_counter() - t0} s)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if not (h_losses + e_losses == losses
            and leaves_equal(e_state.params, state.params)
            and leaves_equal(e_state.opt_state, state.opt_state)):
        raise AssertionError("the resumed run differs from 11a's")
    log("phase 11e: the resumed run equals 11a's to the bit (losses, params, "
        "state)")
    del e_state

    # 11f: the memory plan of the config's budget on B3
    plan = plan_for_config(cfg, "config")
    modes = {l.path: (l.mode, l.depth, l.width) for l in plan.leaves
             if "table" in l.path}
    p_state, p_losses, p_ms, p_counts, p_peak, _ = run.fit(
        run.step(plan=plan), LM_SHORT)
    measured = measure_aux_bytes(p_state.opt_state)
    n_sketch = sum(1 for m in modes.values() if m[0] == "sketch")
    log(f"phase 11f: plan_for_config(qwen2-0.5b, 'config') = "
        f"{plan.budget_bytes} B budget, predicted {plan.predicted_aux_bytes}"
        f" B, measured {measured} B; tables {modes}; {LM_SHORT} steps: "
        f"losses {p_losses}; ms/step median {statistics.median(p_ms[1:])}; "
        f"launches {p_counts}; peak memory of the arm {p_peak} B")
    if measured != plan.predicted_aux_bytes:
        raise AssertionError("the planned state's bytes differ from the plan")
    if p_counts["cs_ema_tiled"] != 2 * n_sketch * LM_SHORT:
        raise AssertionError(f"B3 launched {p_counts['cs_ema_tiled']} times "
                             f"under the plan, not {2 * n_sketch} a step")
    learns("11f: the planned run", p_losses)
    # the plain xla witness of the same plan from the same start: B3 at the
    # plan's width
    pw_state, pw_losses, pw_ms, pw_counts, _, _ = run.fit(
        run.step(plan=plan, backend="xla"), LM_SHORT)
    torch.testing.assert_close(torch.tensor(p_losses),
                               torch.tensor(pw_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    err_p = lm_tree_close(pw_state.params, p_state.params)
    err_s = lm_tree_close(pw_state.opt_state, p_state.opt_state)
    bits = (p_losses == pw_losses
            and leaves_equal(pw_state.params, p_state.params)
            and leaves_equal(pw_state.opt_state, p_state.opt_state))
    log(f"phase 11f: the plan through plain xla: ms/step median "
        f"{statistics.median(pw_ms[1:])}; launches {pw_counts}; losses max "
        f"rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(p_losses, pw_losses))}, "
        f"params max_abs_err {err_p}, state {err_s} (rtol "
        f"{WITNESS_TOL['rtol']}, atol {WITNESS_TOL['atol']}); equal to the "
        f"bit: {bits}")
    del p_state, pw_state
    lm = {"step_ms": step_ms, "peak": peak, "cs_bytes": cs_bytes,
          "dense_bytes": d_bytes, "dense_peak": d_peak}
    return counts, p_counts, state.params, lm


def phase_lm_serving(dev, seed: int, params):
    """Phase 11g: prefill and greedy decode on 11a's trained params."""
    import torch
    from repro_torch.data import ZipfLM, ZipfLMConfig
    from repro_torch.serve import make_serve_step
    cfg = lm_config()
    ss = make_serve_step(cfg, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    prompts = torch.as_tensor(ZipfLM(ZipfLMConfig(
        vocab_size=cfg.vocab, seq_len=PROMPT, global_batch=SERVE_BATCH,
        seed=seed + 1)).batch(0)["tokens"]).to(dev)
    prefill_ms = cuda_ms(lambda: ss.prefill_fn(params, {"tokens": prompts}),
                         reps=5)
    logits, cache = ss.prefill_fn(params, {"tokens": prompts})
    seq, outs = prompts, []
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(DECODE):
        tok = logits.argmax(-1).to(torch.int32)
        seq = torch.cat([seq, tok[:, None]], dim=1)
        logits, cache = ss.decode_fn(params, cache, tok)
        outs.append(logits)
    e1.record()
    torch.cuda.synchronize()
    decode_ms = e0.elapsed_time(e1) / DECODE
    more = cache

    def three():
        nonlocal more
        tok = outs[-1].argmax(-1).to(torch.int32)
        for _ in range(3):
            _, more = ss.decode_fn(params, more, tok)
        torch.cuda.synchronize()
    profile_steps("phase 11g (decode profile)", three, decode_ms, n=3)
    worst, ties, tol_used = 0.0, 0, 0.0
    for t, got in enumerate(outs):
        want, _ = ss.prefill_fn(params, {"tokens": seq[:, :PROMPT + t + 1]})
        want, got = want.float(), got.float()
        tol = DECODE_TOL * want.abs().amax(-1)
        diff = (got - want).abs().amax(-1)
        worst = max(worst, float((diff / tol).max()))
        tol_used = max(tol_used, float(tol.max()))
        top2 = want.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > tol
        same = got.argmax(-1) == want.argmax(-1)
        ties += int((~clear).sum())
        if not bool(same[clear].all()):
            raise AssertionError(f"decode step {t}: argmax differs from the "
                                 f"prefill's where its top-2 margin exceeds "
                                 f"the tolerance")
    log(f"phase 11g: make_serve_step(batch={SERVE_BATCH}, max_seq="
        f"{SERVE_MAX_SEQ}): prefill of {SERVE_BATCH} x {PROMPT} tokens "
        f"{prefill_ms} ms; {DECODE} greedy decode steps {decode_ms} ms a "
        f"token, {SERVE_BATCH * 1e3 / decode_ms} tokens/s; each step's "
        f"logits against the prefill of its prefix: max |diff| / tolerance "
        f"{worst} (tolerance {DECODE_TOL} x the row's max |logit|, at most "
        f"{tol_used}); argmax equal on every row whose top-2 margin exceeds "
        f"it, {ties} of {DECODE * SERVE_BATCH} rows within it")
    if worst > 1.0:
        raise AssertionError(f"decode logits differ from the prefill's by "
                             f"{worst} x the tolerance")
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms}


def phase_lm_launcher(dev, seed: int):
    """Phase 11h: ``python -m repro_torch.launch.train`` at full width for
    3 steps on ``--store-backend auto``."""
    import contextlib
    import io
    from repro_torch.launch import train
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        rc = train.main(["--arch", LM_ARCH, "--steps", "3", "--batch",
                         str(LM_BATCH), "--seq", str(LM_SEQ),
                         "--store-backend", "auto", "--seed", str(seed)])
    counts = read_counts()
    line = [l for l in out.getvalue().splitlines() if l.startswith("[train]")]
    log(f"phase 11h: launch.train rc {rc}: {line}; launches {counts}")
    if rc != 0 or not line or counts["cs_ema_tiled"] != 12:
        raise AssertionError("the launcher's LM run failed")
    return counts


# ---------------------------------------------------------------- phase 12
DP_R, DP_STEPS, DP_DYADIC_STEPS = 4, 10, 3
DP_NCCL_STEPS, DP_LM_STEPS = 5, 3
FLEET_R, FLEET_BATCHES, FLEET_SLOTS = 2, 50, 256
X_DP_STEPS = 5
GROUP_TIMEOUT = 600.0          # s a replica waits for the others


def dp_shards(ids_np, r: int, dev) -> list:
    """A global batch of ids cut into ``r`` replica shards on the card."""
    import torch
    return [torch.from_numpy(s).to(dev) for s in np.split(ids_np, r)]


def dp_round(group, step_fn, tables, states, shards, rows_of):
    """One data-parallel step: replica r takes ``shards[r]`` and its rows
    ``rows_of(r, ids)``, its own table and state.  Returns (tables,
    states)."""
    args = [(tables[r], states[r], ids, rows_of(r, ids))
            for r, ids in enumerate(shards)]
    outs = group.run(step_fn, args)
    return [o[0] for o in outs], [o[1] for o in outs]


def replicas_equal(tables, states) -> bool:
    """Every replica's table and state to the bit (``equal_trees``)."""
    import torch
    return all(torch.equal(t, tables[0]) and equal_trees(s, states[0])
               for t, s in zip(tables[1:], states[1:]))


def byte_model_line(hp) -> str:
    """The reference's traffic model at this slice's shapes: a replica's
    4,096 rows and k = n."""
    from repro_torch.distributed import sketched_reduce as sr
    m = hp.spec("t", (VOCAB, D_MODEL), signed=True)
    v = hp.spec("t", (VOCAB, D_MODEL), signed=False)
    k = BATCH * SEQ // DP_R
    sketched = sr.sketched_reduce_bytes(m, v)
    cross = sketched / (D_MODEL * 4 + 4)
    return (f"sketched all-reduce {sketched} B a replica (M and V gradient "
            f"sketches; {sr.sketched_reduce_bytes(m, v, v)} B with the "
            f"feedback's cross-term sketch) against dense "
            f"{sr.dense_reduce_bytes(k, D_MODEL)} B for {k} rows and ids: "
            f"traffic_ratio {sr.traffic_ratio(m, k, extra_specs=(v,))} "
            f"({sr.traffic_ratio(m, k, extra_specs=(v, v))} with feedback)"
            f"; at k = n = {VOCAB}: "
            f"{sr.traffic_ratio(m, VOCAB, extra_specs=(v,))}; the sketches "
            f"move fewer bytes past {cross:.0f} rows a replica")


def phase_dp(dev, seed: int):
    """Phase 12a: ``make_sparse_embedding_step(dp_axis=ReplicaGroup(4))``
    at full width (see the module docstring).  Returns the launches of
    the DP steps."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.distributed import ReplicaGroup
    from repro_torch.train.steps import make_sparse_embedding_step
    hp = SketchHParams()
    group = ReplicaGroup(DP_R, timeout=GROUP_TIMEOUT)
    init_fn, _, _ = make_sparse_embedding_step(VOCAB, D_MODEL, hparams=hp,
                                               device=dev)
    table0 = init_fn(torch.Generator(device=dev).manual_seed(seed))
    target = init_fn(torch.Generator(device=dev).manual_seed(seed + 1))
    batches = zipf_ids(np.random.RandomState(seed), DP_STEPS)
    held = torch.from_numpy(batches[0]).to(dev).long()
    k = BATCH * SEQ // DP_R
    log(f"phase 12a: {DP_R} replicas (ReplicaGroup threads on one card) x "
        f"{k} zipf({ZIPF_A}) ids a step, phase 3's {BATCH * SEQ} split; "
        f"table {VOCAB} x {D_MODEL}, SketchHParams() (m, v "
        f"{hp.spec('t', (VOCAB, D_MODEL), signed=True).shape}), lr {LR}")
    log(f"phase 12a: byte model: {byte_model_line(hp)}")
    totals = {}
    for fb in (False, True):
        _, step_fn, opt = make_sparse_embedding_step(
            VOCAB, D_MODEL, lr=LR, hparams=hp, dp_axis=group,
            error_feedback=fb, device=dev)
        tables = [table0.clone() for _ in range(DP_R)]
        states = [opt.init() for _ in range(DP_R)]

        def loss_on(tab) -> float:
            rows = tab[held] - target[held]
            return float(torch.mean(rows * rows))

        before = loss_on(tables[0])
        torch.cuda.synchronize()
        reset_counts()
        ms = []
        for ids_np in batches:
            t0 = time.perf_counter()
            tables, states = dp_round(
                group, step_fn, tables, states, dp_shards(ids_np, DP_R, dev),
                lambda r, ids: tables[r][ids.long()] - target[ids.long()])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        same = replicas_equal(tables, states)
        after = loss_on(tables[0])
        per_b5 = counts["cs_update"] / DP_STEPS
        log(f"phase 12a: error_feedback={fb}: {DP_STEPS} steps; the {DP_R} "
            f"replicas share one card as threads (not a DP speed): "
            f"ms/step median of steps 2..{DP_STEPS} "
            f"{statistics.median(ms[1:])} (first {ms[0]}); all {ms}")
        log(f"phase 12a: error_feedback={fb}: launches {counts}; B5 "
            f"{per_b5} a step ({per_b5 / DP_R} a replica); loss on the first "
            f"batch's ids {before} -> {after}; replicas' table, m, v and "
            f"residual equal to the bit: {same}")
        want_b5 = DP_R * (6 if fb else 5)
        if per_b5 != want_b5 or counts["cs_adam_tiled"]:
            raise AssertionError(f"the DP step launched B5 {per_b5} times a "
                                 f"step, not {want_b5} (dedup, the "
                                 f"gradient sketches, M and V), or B1")
        if not same:
            raise AssertionError("the replicas' bits differ")
        if not after < before:
            raise AssertionError("the DP loss did not fall")
        if not all(bool(torch.isfinite(x).all()) for x in
                   [tables[0]] + [s for s in states[0].values()
                                  if isinstance(s, torch.Tensor)]):
            raise AssertionError("non-finite table or sketch")
    more = zipf_ids(np.random.RandomState(seed + 31), 4)

    def three():
        nonlocal tables, states
        for ids_np in more[:3]:
            tables, states = dp_round(
                group, step_fn, tables, states, dp_shards(ids_np, DP_R, dev),
                lambda r, ids: tables[r][ids.long()] - target[ids.long()])
        torch.cuda.synchronize()
    profile_steps("phase 12a (profile)", three, statistics.median(ms[1:]),
                  n=3)
    # one more step, all four replicas, with a host sync an error
    shards = dp_shards(more[3], DP_R, dev)
    rows = [tables[r][s.long()] - target[s.long()]
            for r, s in enumerate(shards)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tables, states = dp_round(group, step_fn, tables, states, shards,
                                  lambda r, ids: rows[r])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("phase 12a: one DP step of the 4 replicas under "
        "set_sync_debug_mode('error'): no host-device synchronisation")
    del tables, states
    phase_dp_dyadic(dev, group, table0, seed)
    return totals


def phase_dp_dyadic(dev, group, table0, seed: int) -> None:
    """12a's protocol: β₁ = β₂ = 0.5 and integer rows in [-3, 3] make every
    sum exact, so the DP first moment must equal the single-device
    ``tiled`` step's (B1) on the concatenated batch to the bit, and the DP
    second moment after one step differ from it by at most the modelled
    cross-replica term."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.distributed import sketched_reduce as sr
    from repro_torch.train.steps import make_sparse_embedding_step
    hp = SketchHParams()
    kw = dict(lr=LR, b1=0.5, b2=0.5, hparams=hp, device=dev)
    _, dp_step, dp_opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, dp_axis=group, **kw)
    _, one_step, one_opt = make_sparse_embedding_step(VOCAB, D_MODEL, **kw)
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    tables = [table0.clone() for _ in range(DP_R)]
    states = [dp_opt.init() for _ in range(DP_R)]
    t1, s1 = table0.clone(), one_opt.init()
    k = BATCH * SEQ // DP_R
    reset_counts()
    for step, ids_np in enumerate(zipf_ids(np.random.RandomState(seed + 12),
                                           DP_DYADIC_STEPS), start=1):
        rows = torch.randint(-3, 4, (BATCH * SEQ, D_MODEL), generator=gen,
                             device=dev).to(torch.float32)
        shards = dp_shards(ids_np, DP_R, dev)
        v_before = states[0]["v"].clone()
        tables, states = dp_round(group, dp_step, tables, states, shards,
                                  lambda r, ids: rows[r * k:(r + 1) * k])
        ids = torch.from_numpy(ids_np).to(dev)
        t1, s1 = one_step(t1, s1, ids, rows)
        torch.cuda.synchronize()
        m_same = torch.equal(states[0]["m"], s1["m"])
        log(f"phase 12a (dyadic): step {step}: DP m equal to the single-"
            f"device tiled step's to the bit: {m_same}; replicas equal: "
            f"{replicas_equal(tables, states)}")
        if not (m_same and replicas_equal(tables, states)):
            raise AssertionError("the DP first moment is not the single-"
                                 "device one on the concatenated batch")
        if step == 1:
            if torch.count_nonzero(v_before):
                raise AssertionError("the dyadic run must start from zero")
            g_sum = torch.zeros((VOCAB, D_MODEL), dtype=torch.float64,
                                device=dev)
            g_sq = torch.zeros_like(g_sum)
            for r, s in enumerate(shards):
                gr = torch.zeros_like(g_sum).index_add_(
                    0, s.long(), rows[r * k:(r + 1) * k].double())
                g_sum += gr
                g_sq += gr * gr
            cross = g_sum * g_sum - g_sq
            del g_sum, g_sq, gr
            touched = torch.nonzero(cross.abs().sum(1) > 0)[:, 0]
            spec_v = hp.spec("sparse_embedding", (VOCAB, D_MODEL),
                             signed=False)
            bound = 0.5 * sr.local_sketch(
                spec_v, touched.to(torch.int32),
                cross[touched].abs().to(torch.float32)) + 1e-4
            del cross
            diff = (states[0]["v"] - s1["v"]).abs()
            log(f"phase 12a (dyadic): step 1: V bias max {float(diff.max())}"
                f" within the modelled cross-term bound (max "
                f"{float(bound.max())}; {int(touched.numel())} rows carry "
                f"cross-replica terms): "
                f"{bool((diff <= bound).all())}")
            if not bool((diff <= bound).all()):
                raise AssertionError("the DP V bias exceeds the bound")
    counts = read_counts()
    if counts["cs_adam_tiled"] != DP_DYADIC_STEPS:
        raise AssertionError(f"the single-device witness did not run B1: "
                             f"{counts}")
    del tables, states, t1, s1


def phase_dp_nccl(dev, seed: int):
    """Phase 12b: the DP steps over ``torch.distributed`` (NCCL, world
    size 1, a ``file://`` rendezvous under ``build/``): 5 sparse steps
    against ``ReplicaGroup(1)`` and 3 full-width qwen2-0.5b
    ``make_train_step(dp_axis=)`` steps against the single-device steps
    from the same start, each to the bit.  Returns the launches of the
    DP steps."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.distributed import ReplicaGroup
    from repro_torch.train.steps import make_sparse_embedding_step
    rdzv = ROOT / "build" / "dp-rendezvous"
    rdzv.parent.mkdir(parents=True, exist_ok=True)
    rdzv.unlink(missing_ok=True)
    # gloo only in a CPU rehearsal of the phase: main() needs a card
    backend = "nccl" if dev.type == "cuda" else "gloo"
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"file://{rdzv}", rank=0,
                            world_size=1)
    totals = {}
    try:
        log(f"phase 12b: {backend} process group, world size "
            f"{dist.get_world_size()}, up in {time.perf_counter() - t0:.1f}"
            f" s")
        hp = SketchHParams()
        one = ReplicaGroup(1, timeout=GROUP_TIMEOUT)
        init_fn, _, _ = make_sparse_embedding_step(VOCAB, D_MODEL,
                                                   hparams=hp, device=dev)
        table0 = init_fn(torch.Generator(device=dev).manual_seed(seed + 2))
        target = init_fn(torch.Generator(device=dev).manual_seed(seed + 3))
        runs = {}
        for name, axis in (("nccl", "data"), ("ReplicaGroup(1)", one)):
            _, step_fn, opt = make_sparse_embedding_step(
                VOCAB, D_MODEL, lr=LR, hparams=hp, dp_axis=axis,
                error_feedback=True, device=dev)
            table, state = table0.clone(), opt.init()

            def run(table, state, ids_np):
                ids = torch.from_numpy(ids_np).to(dev)
                rows = table[ids.long()] - target[ids.long()]
                return step_fn(table, state, ids, rows)

            reset_counts()
            ms = []
            for ids_np in zipf_ids(np.random.RandomState(seed + 2),
                                   DP_NCCL_STEPS):
                ids_np = ids_np[:BATCH * SEQ // DP_R]
                t0 = time.perf_counter()
                if axis is one:
                    table, state = one.run(run, [(table, state, ids_np)])[0]
                else:
                    table, state = run(table, state, ids_np)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            counts = read_counts()
            if axis == "data":
                totals = dict(counts)
            runs[name] = (table, state)
            log(f"phase 12b: {name}: one replica's sparse DP step (error "
                f"feedback, {BATCH * SEQ // DP_R} ids), host ms to the "
                f"card's end, median of steps 2..{DP_NCCL_STEPS} "
                f"{statistics.median(ms[1:])} (first {ms[0]})")
        same = torch.equal(runs["nccl"][0], runs["ReplicaGroup(1)"][0]) \
            and equal_trees(runs["nccl"][1], runs["ReplicaGroup(1)"][1])
        log(f"phase 12b: {DP_NCCL_STEPS} sparse DP steps (error feedback) "
            f"through NCCL and through ReplicaGroup(1): table and state "
            f"equal to the bit: {same}; launches {totals}")
        if not same:
            raise AssertionError("NCCL and ReplicaGroup(1) differ")
        del runs
        lm = phase_dp_lm(dev, seed)
        for name, n in lm.items():
            totals[name] = totals.get(name, 0) + n
    finally:
        dist.destroy_process_group()
        rdzv.unlink(missing_ok=True)
    return totals


def phase_dp_lm(dev, seed: int):
    """12b's LM half: qwen2-0.5b at full width, ``cs_adam`` on ``auto``,
    3 steps with ``dp_axis`` (the default NCCL group) against 3 without,
    from the same start on the same batches: losses, grad norms, params
    and state equal to the bit, B3 4 launches a step.  Returns the DP
    arm's launches."""
    import torch
    from repro_torch.train.steps import make_train_step
    run = LMRun(dev, seed)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in
                run.data.batch(i).items()} for i in range(DP_LM_STEPS)]
    arms = {}
    for name, axis in (("single", None), ("dp", "data")):
        ts = make_train_step(run.cfg, optimizer="cs_adam", lr=LM_LR,
                             kernel_backend="auto", dp_axis=axis,
                             device=dev)
        st = run.fresh(ts)
        params, state, metrics, events = st.params, st.opt_state, [], []
        torch.cuda.synchronize()
        reset_counts()
        for b in batches:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            params, state, m = ts.step_fn(params, state, b)
            e1.record()
            events.append((e0, e1))
            metrics.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        arms[name] = (params, state, metrics, read_counts(),
                      [a.elapsed_time(b) for a, b in events])
        del params, state, st
    one, dp = arms["single"], arms["dp"]
    same = (dp[2] == one[2] and leaves_equal(dp[0], one[0])
            and leaves_equal(dp[1], one[1]))
    counts = dp[3]
    log(f"phase 12b: qwen2-0.5b cs_adam auto, {DP_LM_STEPS} steps without "
        f"and with dp_axis (NCCL, world 1): metrics {dp[2]}; params, state "
        f"and metrics equal to the bit: {same}; ms a step (CUDA events) "
        f"{dp[4]} against {one[4]} without; launches {counts}")
    if not same:
        raise AssertionError("the DP LM step at world size 1 is not the "
                             "single-device step")
    if counts["cs_ema_tiled"] != 4 * DP_LM_STEPS:
        raise AssertionError(f"B3 launched {counts['cs_ema_tiled']} times in"
                             f" {DP_LM_STEPS} DP steps, not 4 a step")
    return counts


def phase_dp_fleet(dev, seed: int):
    """Phase 12c: the serve fleet and the extreme step at R = 2 (see the
    module docstring).  Returns the launches of the DP steps."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.distributed import ReplicaGroup
    from repro_torch.serve import make_online_adapt_step
    from repro_torch.train.extreme import (MachConfig, extreme_grads,
                                           make_extreme_step)
    group = ReplicaGroup(FLEET_R, timeout=GROUP_TIMEOUT)
    totals = {}
    init, adapt = make_online_adapt_step(
        VOCAB, D_MODEL, lr=SERVE_LR, hparams=SketchHParams(compression=5.0),
        dp_axis=group, error_feedback=True, device=dev)
    table0 = serve_table(dev, seed)
    tables = [table0.clone() for _ in range(FLEET_R)]
    states = [init() for _ in range(FLEET_R)]
    rng = np.random.RandomState(seed + 41)
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(FLEET_BATCHES):
        ids_np = ((rng.zipf(ZIPF_A, FLEET_SLOTS) - 1) % VOCAB).astype(
            np.int32)
        rows = torch.randn((FLEET_SLOTS, D_MODEL), generator=gen,
                           device=dev) / float(np.sqrt(D_MODEL))
        per = FLEET_SLOTS // FLEET_R
        tables, states = dp_round(group, adapt, tables, states,
                                  dp_shards(ids_np, FLEET_R, dev),
                                  lambda r, ids: rows[r * per:(r + 1) * per])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / FLEET_BATCHES
    counts = read_counts()
    totals.update(counts)
    same = replicas_equal(tables, states)
    log(f"phase 12c: serve fleet, {FLEET_R} replicas x "
        f"{FLEET_SLOTS // FLEET_R} of {FLEET_SLOTS} id slots, "
        f"{FLEET_BATCHES} batches, lr {SERVE_LR}, compression 5, error "
        f"feedback: replicas equal to the bit: {same}; {ms} ms a batch "
        f"(both replicas on one card); launches {counts}")
    if not same or not torch.isfinite(tables[0]).all():
        raise AssertionError("the serve fleet's replicas differ or are not "
                             "finite")
    del tables, states

    cfg = MachConfig(**EXTREME)
    cmap = cfg.class_maps()[0]
    batches = extreme_batches(cfg, cmap, X_BATCH, X_DP_STEPS, dev)
    _init, step_fn, opts = make_extreme_step(
        cfg, optimizer="cs_rmsprop", lr=X_LR, dp_axis=group, device=dev)
    start = _init(torch.Generator(device=dev).manual_seed(seed + 8))
    per = X_BATCH // FLEET_R

    def shard(b, r):
        return {"features": b["features"][r * per:(r + 1) * per],
                "labels": b["labels"][r * per:(r + 1) * per],
                "negatives": b["negatives"]}

    # the single-device metrics from the same start: the loss of the
    # concatenated batch, and each shard's gradient norm
    loss_all, _ = extreme_grads(start, batches[0])
    gn_shards = []
    for r in range(FLEET_R):
        _, grads = extreme_grads(start, shard(batches[0], r))
        gn_shards.append(float(sum(torch.sum(torch.square(g["rows"]))
                                   for g in grads.values())))
    _, grads = extreme_grads(start, batches[0])
    gn_all = float(torch.sqrt(sum(torch.sum(torch.square(g["rows"]))
                                  for g in grads.values())))
    params = [params_from(tables_of(start)) for _ in range(FLEET_R)]
    states = [{p: o.init() for p, o in opts.items()} for _ in range(FLEET_R)]
    torch.cuda.synchronize()
    reset_counts()
    metrics = []
    for b in batches:
        outs = group.run(step_fn, [(params[r], states[r], shard(b, r))
                                   for r in range(FLEET_R)])
        params, states = [o[0] for o in outs], [o[1] for o in outs]
        if not all(equal_trees(o[2], outs[0][2]) for o in outs):
            raise AssertionError("the replicas' metrics differ")
        metrics.append({k: float(v) for k, v in outs[0][2].items()})
    torch.cuda.synchronize()
    counts = read_counts()
    for name, n in counts.items():
        totals[name] = totals.get(name, 0) + n
    same = all(equal_trees(p, params[0]) and equal_trees(s, states[0])
               for p, s in zip(params[1:], states[1:]))
    gn_model = float(np.sqrt(sum(gn_shards)))
    rel_loss = abs(metrics[0]["loss"] - float(loss_all)) / float(loss_all)
    rel_gn = abs(metrics[0]["grad_norm"] - gn_model) / gn_model
    log(f"phase 12c: extreme cs_rmsprop, {FLEET_R} replicas x {per} of "
        f"batch {X_BATCH} (MACH replica 0), {X_DP_STEPS} steps: replicas "
        f"equal to the bit: {same}; metrics {metrics}; launches {counts}")
    log(f"phase 12c: step 1 against the single-device step: loss "
        f"{metrics[0]['loss']} vs {float(loss_all)} on the concatenated "
        f"batch (rel {rel_loss}); grad_norm {metrics[0]['grad_norm']} vs "
        f"sqrt of the shards' squared norms {gn_model} (rel {rel_gn}); the "
        f"concatenated batch's own grad_norm is {gn_all} (each replica's "
        f"loss is the mean over its {per} examples)")
    if not same:
        raise AssertionError("the extreme step's replicas differ")
    if rel_loss > 1e-5 or rel_gn > 1e-5:
        raise AssertionError("the DP extreme metrics are not the single-"
                             "device ones")
    return totals


# ---------------------------------------------------------------- phase 13
SH_STEPS, SH_DYADIC_STEPS = 10, 3
# (grid (dp, shards), layout, error feedback)
SH_CASES = [((1, 4), "width", False), ((1, 4), "hash", False),
            ((2, 2), "width", False), ((2, 2), "width", True)]
# src/repro/configs/llama4_maverick_400b_a17b.py: the vocab pair
L4_SHAPE, L4_SHARDS = (202_048, 5_120), 8
L4_BATCH, L4_STEPS = 4_096, 5     # batch cut from 16,384: device memory
SD_STEPS = 5


def mesh_step(mesh, step_fn, tables, states, ids_np, rows_of, dev):
    """One step of every replica of a (dp, shards) ``ReplicaMesh``: replica
    r = d·shards + s takes the d-th dp shard of ``ids_np``, its rows
    ``rows_of(r, ids)``, its own table and its shard's slabs.  Returns
    (tables, states)."""
    dp, sh = mesh.shape
    shards = dp_shards(ids_np, dp, dev)
    args = [(tables[r], states[r], shards[r // sh],
             rows_of(r, shards[r // sh])) for r in range(mesh.size)]
    outs = mesh.run(step_fn, args)
    return [o[0] for o in outs], [o[1] for o in outs]


def mesh_consistent(mesh, tables, states) -> bool:
    """Every replica's table equal to the bit, and each shard's slabs
    equal across the data axis."""
    import torch
    dp, sh = mesh.shape
    return all(torch.equal(t, tables[0]) for t in tables[1:]) and all(
        equal_trees(states[d * sh + s], states[s])
        for d in range(1, dp) for s in range(sh))


def sharded_pair(dev, grid, layout, fb, hp, **kw):
    """(mesh, sharded step, its optimizer, (group, DP step, its
    optimizer)): the sharded step on ``ReplicaMesh(grid)`` and its
    witness, the DP step at the grid's dp on stores stamped with the same
    sharding (the reference's pairing, ``tests/test_sharded.py``)."""
    from repro_torch.core.stores import StoreTree
    from repro_torch.distributed import ReplicaGroup, ReplicaMesh
    from repro_torch.train.steps import (make_sparse_embedding_step,
                                         sparse_embedding_stores)
    dp, sh = grid
    mesh = ReplicaMesh(grid, timeout=GROUP_TIMEOUT)
    _, step, opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, hparams=hp, sketch_shards=sh, shard_layout=layout,
        dp_axis=mesh.axis("data") if dp > 1 else None,
        shard_axis=mesh.axis("model"), error_feedback=fb, device=dev, **kw)
    m_st, v_st = sparse_embedding_stores(VOCAB, D_MODEL, hparams=hp,
                                         sketch_shards=sh,
                                         shard_layout=layout)
    group = ReplicaGroup(dp, timeout=GROUP_TIMEOUT)
    _, w_step, w_opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, hparams=hp,
        stores=StoreTree(rules=(("sparse_embedding", m_st, v_st),)),
        dp_axis=group, error_feedback=fb, device=dev, **kw)
    return mesh, step, opt, (group, w_step, w_opt)


def sharded_start(mesh, opt, table0):
    """Each replica's own table and its shard's contiguous slabs."""
    from repro_torch.distributed import shard_state
    sh = mesh.shape[1]
    full = opt.init()
    return ([table0.clone() for _ in range(mesh.size)],
            [shard_state(full, sh, r % sh) for r in range(mesh.size)])


def witness_steps(group, w_step, w_opt, table0, batches, rows_fn, dev):
    """The DP witness over ``batches``: returns the tables and states
    after each step."""
    tables = [table0.clone() for _ in range(group.size)]
    states = [w_opt.init() for _ in range(group.size)]
    out = []
    for b in batches:
        tables, states = dp_round(group, w_step, tables, states,
                                  dp_shards(b, group.size, dev),
                                  lambda r, ids: rows_fn(tables, r, ids))
        out.append((tables[0], states[0]))
    return out


def joined_equal(states, sh, want) -> tuple:
    """(equal to the bit, largest |difference|) of the shards' joined
    state against a full state, m, v and the residual."""
    import torch
    from repro_torch.distributed import join_slabs
    got = join_slabs(states[:sh])
    same, err = True, 0.0
    for k in ("m", "v", "residual"):
        if (got[k] is None) != (want[k] is None):
            return False, float("inf")
        if got[k] is not None:
            same &= torch.equal(got[k], want[k])
            err = max(err, float((got[k] - want[k]).abs().max()))
    return same, err


def sharded_byte_line(hp, k: int) -> str:
    """The reference's byte models at 13a's shapes."""
    from repro_torch.distributed import sketched_reduce as sr
    m = hp.spec("t", (VOCAB, D_MODEL), signed=True)
    v = hp.spec("t", (VOCAB, D_MODEL), signed=False)
    parts = [f"replicated all-reduce (12a) {sr.sketched_reduce_bytes(m, v)}"
             f" B a replica"]
    for sh in (4, 2):
        ms, vs = (dataclasses.replace(s, shards=sh) for s in (m, v))
        parts.append(
            f"{sh} shards: gradient-slab psum "
            f"{sr.sharded_reduce_bytes(ms, vs)} B a device "
            f"({sr.sharded_reduce_bytes(ms, vs, vs)} with feedback), "
            f"routing psum of the 4 query groups at {k} ids "
            f"{sr.routing_bytes(k, ms, vs, vs, ms)} B")
    return "; ".join(parts)


def phase_sharded(dev, seed: int):
    """Phase 13a: ``make_sparse_embedding_step(sketch_shards=)`` at full
    width (see the module docstring).  Returns (the launches of the
    sharded steps, B5's slab-mode row for the kernels' line)."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.train.steps import (make_sparse_embedding_step,
                                         sparse_embedding_stores)
    hp = SketchHParams()
    init_fn, _, _ = make_sparse_embedding_step(VOCAB, D_MODEL, hparams=hp,
                                               device=dev)
    table0 = init_fn(torch.Generator(device=dev).manual_seed(seed))
    target = init_fn(torch.Generator(device=dev).manual_seed(seed + 1))
    batches = zipf_ids(np.random.RandomState(seed), SH_STEPS)
    held = torch.from_numpy(batches[0]).to(dev).long()

    def loss_on(tab) -> float:
        rows = tab[held] - target[held]
        return float(torch.mean(rows * rows))

    def rows_fn(tables, r, ids):
        return tables[r][ids.long()] - target[ids.long()]

    log(f"phase 13a: table {VOCAB} x {D_MODEL}, SketchHParams() (m, v "
        f"{hp.spec('t', (VOCAB, D_MODEL), signed=True).shape}), lr {LR}, "
        f"{BATCH * SEQ} zipf({ZIPF_A}) ids a step cut into the dp shards; "
        f"replicas are ReplicaMesh threads on one card (a model of the "
        f"devices, not a speed)")
    log(f"phase 13a: byte models: "
        f"{sharded_byte_line(hp, BATCH * SEQ)}")
    totals, ms_by_case = {}, {}
    for grid, layout, fb in SH_CASES:
        dp, sh = grid
        tag = f"phase 13a: {dp} x {sh} {layout} feedback={fb}"
        mesh, step, opt, witness = sharded_pair(dev, grid, layout, fb, hp,
                                                lr=LR)
        m_st, v_st = sparse_embedding_stores(VOCAB, D_MODEL, hparams=hp,
                                             sketch_shards=sh,
                                             shard_layout=layout)
        tables, states = sharded_start(mesh, opt, table0)
        want = {"m": m_st.spec.shard_nbytes(), "v": v_st.spec.shard_nbytes(),
                "residual": v_st.spec.shard_nbytes() if fb else None}
        got = {k: None if states[0][k] is None else states[0][k].nbytes
               for k in want}
        log(f"{tag}: lw {v_st.spec.local_width}; a shard's slab bytes "
            f"{got} (spec.shard_nbytes() {want})")
        if got != want or any(tuple(st["v"].shape) != v_st.spec.slab_shape
                              for st in states):
            raise AssertionError(f"{tag}: a slab is not spec.shard_nbytes()")
        before = loss_on(tables[0])
        torch.cuda.synchronize()
        reset_counts()
        ms, consistent = [], True
        for ids_np in batches:
            t0 = time.perf_counter()
            tables, states = mesh_step(
                mesh, step, tables, states, ids_np,
                lambda r, ids: rows_fn(tables, r, ids), dev)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            consistent &= mesh_consistent(mesh, tables, states)
        counts = read_counts()
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n
        after = loss_on(tables[0])
        per_b5 = counts["cs_update"] / SH_STEPS / mesh.size
        ms_by_case[(grid, layout, fb)] = statistics.median(ms[1:])
        log(f"{tag}: {SH_STEPS} steps: ms/step median of steps "
            f"2..{SH_STEPS} {statistics.median(ms[1:])} (first {ms[0]}); "
            f"all {ms}")
        log(f"{tag}: launches {counts}; B5 {per_b5} a replica-step; loss on "
            f"the first batch's ids {before} -> {after}; every replica's "
            f"table and each shard's slabs equal at every step: "
            f"{consistent}")
        w = witness_steps(*witness, table0, batches, rows_fn, dev)[-1]
        same, err = joined_equal(states, sh, w[1])
        same &= torch.equal(tables[0], w[0])
        err = max(err, float((tables[0] - w[0]).abs().max()))
        log(f"{tag}: against the DP step at dp {dp} on the same general "
            f"data: table and state equal to the bit {same} (largest "
            f"difference {err})")
        want_b5 = 6 if fb else 5
        if per_b5 != want_b5 or counts["cs_adam_tiled"]:
            raise AssertionError(f"{tag}: B5 {per_b5} a replica-step, not "
                                 f"{want_b5} (dedup, the gradient slabs, M "
                                 f"and V), or B1 launched")
        if not consistent:
            raise AssertionError(f"{tag}: the replicas' bits differ")
        if not after < before or not torch.isfinite(tables[0]).all():
            raise AssertionError(f"{tag}: the loss did not fall, or the "
                                 f"table is not finite")
        if grid == (2, 2) and fb:
            more = zipf_ids(np.random.RandomState(seed + 33), 4)

            def three():
                nonlocal tables, states
                for ids_np in more[:3]:
                    tables, states = mesh_step(
                        mesh, step, tables, states, ids_np,
                        lambda r, ids: rows_fn(tables, r, ids), dev)
                torch.cuda.synchronize()
            profile_steps(f"{tag} (profile)", three,
                          statistics.median(ms[1:]), n=3, by_name=True)
            shards = dp_shards(more[3], dp, dev)
            rows = [rows_fn(tables, r, shards[r // sh])
                    for r in range(mesh.size)]
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                outs = mesh.run(step, [(tables[r], states[r], shards[r // sh],
                                        rows[r]) for r in range(mesh.size)])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            del outs
            log(f"{tag}: one step of the 4 replicas under "
                f"set_sync_debug_mode('error'): no host-device "
                f"synchronisation")
        del tables, states, w
    phase_sharded_dyadic(dev, hp, table0, seed)
    slab_row = phase_slab_scatter(dev, hp, batches[-1], seed)
    return totals, slab_row


def phase_sharded_dyadic(dev, hp, table0, seed: int) -> None:
    """13a's binding check: β₁ = β₂ = 0.5 and integer rows in [-3, 3]
    make every sum exact, so each case's sharded step must equal the DP
    step at its dp to the bit, after every step."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    batches = zipf_ids(np.random.RandomState(seed + 13), SH_DYADIC_STEPS)
    rows = [torch.randint(-3, 4, (BATCH * SEQ, D_MODEL), generator=gen,
                          device=dev).to(torch.float32) for _ in batches]
    for grid, layout, fb in SH_CASES:
        dp, sh = grid
        mesh, step, opt, (group, w_step, w_opt) = sharded_pair(
            dev, grid, layout, fb, hp, lr=LR, b1=0.5, b2=0.5)
        tables, states = sharded_start(mesh, opt, table0)
        w_tables = [table0.clone() for _ in range(dp)]
        w_states = [w_opt.init() for _ in range(dp)]
        k = BATCH * SEQ // dp
        same_all, err_all = True, 0.0
        for b, g in zip(batches, rows):
            tables, states = mesh_step(
                mesh, step, tables, states, b,
                lambda r, ids: g[(r // sh) * k:(r // sh + 1) * k], dev)
            w_tables, w_states = dp_round(
                group, w_step, w_tables, w_states, dp_shards(b, dp, dev),
                lambda r, ids: g[r * k:(r + 1) * k])
            same, err = joined_equal(states, sh, w_states[0])
            same_all &= same and torch.equal(tables[0], w_tables[0]) \
                and mesh_consistent(mesh, tables, states)
            err_all = max(err_all, err)
        log(f"phase 13a (dyadic): {dp} x {sh} {layout} feedback={fb}: "
            f"{SH_DYADIC_STEPS} steps, the sharded table and state equal to "
            f"the DP step's at dp {dp} to the bit after every step: "
            f"{same_all} (largest difference {err_all})")
        if not same_all:
            raise AssertionError("the sharded step is not the DP step under "
                                 "the dyadic protocol")
        del tables, states, w_tables, w_states


def phase_slab_scatter(dev, hp, ids_np, seed: int) -> dict:
    """B5 in slab mode (``cs_update_slab``) against its plain version at
    13a's shapes: a 4-shard slab (3, 2,560, 896) of the M sketch and the
    deduplicated ids of a step.  Bit-equal on a collision-free batch,
    within atol 2e-5 of the plain version on the card under collisions
    and bit-equal to it on a CPU copy; then timed.  Returns the
    ``slab_mode`` entry of B5's row in the kernels' line."""
    import torch
    from repro_torch.core import sketch as cs
    from repro_torch.kernels import dedup as dd, ref
    from repro_torch.kernels.cs_update import cs_update_slab
    spec = dataclasses.replace(
        hp.spec("sparse_embedding", (VOCAB, D_MODEL), signed=True), shards=4)
    depth, lw, d = spec.slab_shape
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    ids = torch.from_numpy(ids_np).to(dev)
    batch = dd.dedup_rows(ids, torch.zeros((ids.numel(), d), device=dev))
    uids, k = batch.unique_ids, batch.unique_ids.numel()
    # the step's slab deltas are zero at the padding slots (int32 max,
    # which all hash to one bucket)
    rows = torch.randn((k, d), generator=gen, device=dev) \
        * batch.mask[:, None]
    signs = spec.family.sign(uids)
    err, cpu_same = 0.0, True
    for s in range(spec.shards):
        local, _ = cs._slab_buckets(spec, uids, s)
        start = torch.randn(spec.slab_shape, generator=gen, device=dev)
        got = cs_update_slab(start.clone(), local, signs, rows)
        plain = ref.cs_update_slab_ref(start.clone(), local, signs, rows)
        host = ref.cs_update_slab_ref(start.cpu(), local.cpu(), signs.cpu(),
                                      rows.cpu())
        err = max(err, float((got - plain).abs().max()))
        cpu_same &= torch.equal(got.cpu(), host)
    n_free = min(2048, lw + 1)
    free = torch.stack([torch.randperm(lw + 1, generator=gen,
                                       device=dev)[:n_free]
                        for _ in range(depth)]).to(torch.int32)
    x = torch.randn((n_free, d), generator=gen, device=dev)
    start = torch.randn(spec.slab_shape, generator=gen, device=dev)
    free_same = torch.equal(cs_update_slab(start.clone(), free, None, x),
                            ref.cs_update_slab_ref(start.clone(), free, None,
                                                   x))
    log(f"phase 13a: B5 slab mode at slab {spec.slab_shape}, "
        f"{int(batch.n_unique)} unique ids of {ids.numel()} (padded to "
        f"{k}, zero rows): every shard bit-equal to the "
        f"plain version on a CPU copy {cpu_same}, max_abs_err {err} against "
        f"it on the card; a collision-free batch ({n_free} distinct local "
        f"buckets a row, some of them the drop bucket) bit-equal {free_same}")
    if not (cpu_same and free_same and err <= COLLISION_ATOL):
        raise AssertionError("B5's slab mode disagrees with its plain "
                             "version")
    local, own = cs._slab_buckets(spec, uids, 0)
    work = torch.randn(spec.slab_shape, generator=gen, device=dev)
    ms = cuda_ms(lambda: cs_update_slab(work, local, signs, rows), reps=20,
                 warmup=3)
    plain_ms = cuda_ms(lambda: ref.cs_update_slab_ref(work, local, signs,
                                                      rows), reps=5)
    flat = work.view(depth * lw, d)
    idx = (local.long() + lw * torch.arange(depth, device=dev)[:, None])[own]
    vals = (signs[:, :, None] * rows[None])[own]
    library_ms = cuda_ms(lambda: flat.index_add_(0, idx, vals), reps=20,
                         warmup=3)
    needed = int(own.any(0).sum())
    touched = int(torch.unique(idx).numel())
    nbytes = 4 * (needed * d + 2 * touched * d + 2 * depth * k)
    row = dict(shape=list(spec.slab_shape), k=k,
               k_unique=int(batch.n_unique), owned_items=int(own.sum()),
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               library_ms=library_ms, bytes=nbytes)
    log(f"phase 13a: B5 slab mode, shard 0 of 4: {ms} ms as called (its "
        f"CSR over {lw + 1} buckets built in the call), plain {plain_ms} "
        f"ms, index_add_ of the {int(own.sum())} owned rows already "
        f"compacted {library_ms} ms, bound {row['bound_ms']} ms ({nbytes} B "
        f"at 3.35 TB/s: {needed} item rows read, {touched} slab rows read "
        f"and written, buckets and signs)")
    return row


def phase_sharded_llama4(dev, seed: int):
    """Phase 13b: the llama4-maverick vocab table under its own 8-shard
    plan (see the module docstring).  Returns the launches of its
    steps."""
    import torch
    from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG
    from repro_torch.distributed import ReplicaMesh
    from repro_torch.plan import InfeasibleBudgetError, plan_for_tables
    from repro_torch.distributed import shard_state
    from repro_torch.train.steps import make_sparse_embedding_step
    tables_spec = {"tok_embed/table": L4_SHAPE, "lm_head/table": L4_SHAPE}
    budget = CONFIG.aux_budget_bytes
    try:
        plan_for_tables(tables_spec, budget, optimizer="cs_adam")
    except InfeasibleBudgetError as e:
        log(f"phase 13b: plan_for_tables(llama4 vocab pair, {budget} B, "
            f"cs_adam) without shards: InfeasibleBudgetError (floor "
            f"{e.floor} B)")
    else:
        raise AssertionError("the unsharded llama4 plan did not refuse")
    plan = plan_for_tables(tables_spec, budget, optimizer="cs_adam",
                           shards=L4_SHARDS)
    for line in plan.shard_table().splitlines():
        log(f"phase 13b:   {line}")
    n, d = L4_SHAPE
    mesh = ReplicaMesh((1, L4_SHARDS), timeout=GROUP_TIMEOUT)
    init_fn, step, opt = make_sparse_embedding_step(
        n, d, lr=LR, path="tok_embed/table", stores=plan.store_tree(),
        sketch_shards=L4_SHARDS, shard_axis=mesh.axis("model"), device=dev)
    leaf = plan.leaf("tok_embed/table")
    share = -(-leaf.bytes_m // L4_SHARDS) + -(-leaf.bytes_v // L4_SHARDS)
    full = opt.init()
    states = [shard_state(full, L4_SHARDS, s) for s in range(L4_SHARDS)]
    del full
    got = [st["m"].nbytes + st["v"].nbytes for st in states]
    log(f"phase 13b: tok_embed/table m {tuple(states[0]['m'].shape)} and v "
        f"{tuple(states[0]['v'].shape)} a shard: {got[0]} B, the plan's "
        f"per-device share of the leaf {share} B (per device in all "
        f"{plan.predicted_aux_bytes_per_device} B of {budget} B)")
    if any(g != share for g in got):
        raise AssertionError("a shard's m + v bytes are not the plan's "
                             "per-device share")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    table = init_fn(gen)
    tables = [table] + [table.clone() for _ in range(L4_SHARDS - 1)]
    del table
    rng = np.random.RandomState(seed + 13)
    batches = [((rng.zipf(ZIPF_A, L4_BATCH) - 1) % n).astype(np.int32)
               for _ in range(L4_STEPS)]
    held = torch.from_numpy(batches[0]).to(dev).long()

    def loss_on(tab) -> float:        # regression of the rows to zero
        return float(torch.mean(tab[held] * tab[held]))

    log(f"phase 13b: {L4_SHARDS} replicas (ReplicaMesh threads), each "
        f"holding the {n} x {d} table ({n * d * 4} B) as the reference's "
        f"replicated table spec does; {L4_BATCH} zipf({ZIPF_A}) ids a step "
        f"(cut from 16,384: the stacked query groups and their psum "
        f"copies in 8 threads beside 8 tables would pass 80 GB); rows = "
        f"the table's rows (the loss pulls them to zero); lr {LR}")
    before = loss_on(tables[0])
    torch.cuda.synchronize()
    reset_counts()
    ms, consistent = [], True
    for ids_np in batches:
        t0 = time.perf_counter()
        tables, states = mesh_step(mesh, step, tables, states, ids_np,
                                   lambda r, ids: tables[r][ids.long()],
                                   dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        consistent &= mesh_consistent(mesh, tables, states)
    counts = read_counts()
    after = loss_on(tables[0])
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 13b: {L4_STEPS} steps: ms/step median of steps "
        f"2..{L4_STEPS} {statistics.median(ms[1:])} (first {ms[0]}); all "
        f"{ms}; launches {counts}; peak device memory {peak} B; loss on "
        f"the first batch's ids {before} -> {after}; replicas equal "
        f"{consistent}")
    if not (consistent and after < before
            and torch.isfinite(tables[0]).all()):
        raise AssertionError("the llama4 sharded step's replicas differ, "
                             "or its loss did not fall")
    del tables, states
    return counts


def phase_sharded_dense(dev, task):
    """Phase 13c: phase 9c's plan sharded, on the dense path (see the
    module docstring).  Returns the launches of the sharded runs."""
    import torch
    from repro_torch.plan import plan_for_params
    plan = plan_for_params(softmax_shapes(), DENSE_BUDGET)
    held0, _ = task.held_fresh()
    runs = {}
    for name, p, backend in (
            ("unsharded", plan, "auto"),
            ("width", plan.with_sharding(4, "width"), "auto"),
            ("hash", plan.with_sharding(4, "hash"), "auto"),
            ("hash xla", plan.with_sharding(4, "hash"), "xla")):
        torch.cuda.synchronize()
        reset_counts()
        params, state, losses, ms, _s, _d = task.run(
            p.make_optimizer(DENSE_LR, backend=backend), DENSE_LR,
            steps=SD_STEPS)
        counts = read_counts()
        held, _ = task.held_fresh(params)
        spec = p.specs()["tok_embed/table"]["v"]
        runs[name] = (params, state, counts)
        log(f"phase 13c: {name} ({spec.shards} x {spec.layout}, v "
            f"{spec.shape}), backend {backend}: {SD_STEPS} steps, ms/step "
            f"median of steps 2..{SD_STEPS} {statistics.median(ms[1:])}; "
            f"loss on batch 0's tokens {held0} -> {held}; per-step "
            f"{losses}; launches {counts}")
        if backend == "auto" and counts["cs_ema_tiled"] != 2 * SD_STEPS:
            raise AssertionError(f"B3 launched {counts['cs_ema_tiled']} "
                                 f"times, not {2 * SD_STEPS}")
        if not held < held0:
            raise AssertionError(f"phase 13c {name}: the loss did not fall")
    for a, b in (("width", "unsharded"), ("hash", "hash xla")):
        same = leaves_equal(runs[a][0], runs[b][0]) \
            and leaves_equal(runs[a][1], runs[b][1])
        log(f"phase 13c: {a} against {b}: params and state equal to the "
            f"bit {same}")
        if not same:
            raise AssertionError(f"phase 13c: {a} differs from {b}")
    differs = not torch.equal(runs["hash"][1]["v"]["tok_embed"]["table"],
                              runs["width"][1]["v"]["tok_embed"]["table"])
    log(f"phase 13c: the hash layout's V differs from the width layout's "
        f"(it hashes otherwise): {differs}")
    return {name: runs["width"][2][name] + runs["hash"][2][name]
            for name in runs["width"][2]}


# ---------------------------------------------------------------- phase 14
# lr 3e-5: at this table the single-device step's loss trend falls for
# every lr from 1e-5 up, but an id whose count-sketch median of M is
# polluted by a head id while its count-min V is clean takes a step of
# many lr, and its row spikes the loss of every later batch that holds
# it, in proportion to lr squared (PERF.md §6); the DP route's
# dir_clip bounds such steps
P14_STEPS, P14_CKPT_EVERY, P14_LR = 20, 10, 3e-5
P14_FOLD_STEPS, P14_SH_STEPS, P14_DP_STEPS, P14_FAIL_AT = 10, 5, 10, 15
P14_TIMEOUT = 900.0            # s for one torch.distributed.run child


def p14_argv(dev, seed: int, ckpt: Path, steps: int, *extra) -> list:
    """The launcher's ``--workload sparse_embedding`` flags at qwen2-0.5b's
    full table (compression 5, depth 3: width 10,240), 16,384 ids a
    step."""
    argv = ["--workload", "sparse_embedding", "--sparse-rows", str(VOCAB),
            "--sparse-dim", str(D_MODEL), "--sparse-compression", "5",
            "--batch", str(BATCH), "--seq", str(SEQ), "--lr", str(P14_LR),
            "--seed", str(seed), "--steps", str(steps), "--ckpt-every",
            str(P14_CKPT_EVERY), "--ckpt-dir", str(ckpt), *extra]
    return argv + (["--device", "cpu"] if dev.type == "cpu" else [])


def p14_main(argv) -> tuple:
    """``(exit code, stdout lines, per-step losses)`` of
    ``launch.train.main(argv)`` in this process."""
    import contextlib
    import io
    from repro_torch.launch import train
    base, losses = train.Trainer, []

    class Kept(base):
        def fit(self, state):
            try:
                return super().fit(state)
            finally:
                losses.extend(h["loss"] for h in self.history)

    out = io.StringIO()
    train.Trainer = Kept
    try:
        with contextlib.redirect_stdout(out):
            rc = train.main(argv)
    finally:
        train.Trainer = base
    return rc, out.getvalue().splitlines(), losses


def spikes(losses) -> int:
    """Steps whose loss passes the lowest before them by more than 10%:
    batches holding a row that a polluted-median step threw off."""
    return sum(l > 1.1 * min(losses[:i]) for i, l in enumerate(losses)
               if i)


def p14_line(lines, prefix="[train] workload=") -> str:
    got = [l for l in lines if l.startswith(prefix)]
    if not got:
        raise AssertionError(f"no {prefix!r} line in {lines[-5:]}")
    return got[-1]


def p14_ms(lines) -> str:
    """The launcher's ms-a-step line."""
    got = [l for l in lines if l.startswith("[train] ") and "ms a step" in l]
    if not got:
        raise AssertionError("the launcher printed no ms a step")
    return got[-1][len("[train] "):]


def p14_leaves(ckpt: Path, step=None, device="cpu") -> dict:
    """A sparse_embedding checkpoint's global leaves."""
    from repro_torch.checkpoint import store
    like = {"params": 0, "opt_state": {"step": 0, "m": 0, "v": 0}}
    return store.restore(ckpt, like, step=step, device=device)[1]


def launcher_child(argv) -> int:
    """``--launcher-child ARGS``: ``repro_torch.launch.train.main(ARGS)``
    as ``python -m repro_torch.launch.train ARGS`` runs it (phase 14b
    starts it under ``torch.distributed.run``), then, on rank 0, the
    kernels' launch counts of the run as ``[counts] {json}``."""
    from repro_torch.launch import train
    reset_counts()
    rc = train.main(argv)
    if os.environ.get("RANK", "0") == "0":
        print("[counts] " + json.dumps(read_counts()), flush=True)
    return rc


def phase_placement(dev, seed: int):
    """Phase 14: placement, elastic recovery and the launcher's
    distributed flags (14a-e).  Returns the launches of the path."""
    import torch
    tmp = ROOT / "build" / "ckpt-14"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    totals: dict = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    try:
        counts, losses = phase_p14_launcher(dev, seed, tmp)
        add(counts)
        add(phase_p14_torchrun(dev, seed, tmp))
        add(phase_p14_fold(dev, seed, tmp, losses))
        add(phase_p14_recovery(dev, seed, tmp))
        add(phase_p14_replace(dev, seed, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(f"phase 14: launches of the path {totals}")
    return totals


def phase_p14_launcher(dev, seed: int, tmp: Path) -> tuple:
    """14a: the launcher in this process, 20 steps, a checkpoint every 10:
    B1 once a step, finite losses whose median over the last 10 steps is
    below the first 10's (the trend; the mean the exit code reads also
    carries the spikes, which are counted), the exit code the launcher's
    own rule of its windows.  Returns the launches and the losses."""
    reset_counts()
    t0 = time.perf_counter()
    rc, lines, losses = p14_main(p14_argv(dev, seed, tmp / "a", P14_STEPS))
    counts = read_counts()
    h = P14_STEPS // 2
    med = (float(np.median(losses[:h])), float(np.median(losses[h:])))
    fell = float(np.mean(losses[h:])) < float(np.mean(losses[:h]))
    log(f"phase 14a: launch.train --workload sparse_embedding rc {rc} in "
        f"{time.perf_counter() - t0:.1f} s: {p14_line(lines)}; "
        f"{p14_ms(lines)}; per-step losses {losses}; medians of the two "
        f"halves {med[0]} -> {med[1]}; {spikes(losses)} spiked steps; "
        f"launches {counts}")
    if counts["cs_adam_tiled"] != P14_STEPS or len(losses) != P14_STEPS \
            or not np.all(np.isfinite(losses)) or rc != (0 if fell else 1) \
            or not med[1] < med[0]:
        raise AssertionError("14a: the sparse_embedding launcher did not "
                             "train through B1")
    return counts, losses


def phase_p14_torchrun(dev, seed: int, tmp: Path) -> dict:
    """14b: ``torch.distributed.run --standalone --nproc-per-node 1`` (NCCL
    at world size 1): the sparse workload under ``--dp --error-feedback``
    and qwen2-0.5b under ``--dp``; each exits 0 with dp=True in its
    line."""
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()      # the children share the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    runs = [("sparse_embedding --dp --error-feedback",
             p14_argv(dev, seed, tmp / "b", P14_DP_STEPS, "--dp",
                      "--error-feedback")),
            ("lm --dp", ["--arch", LM_ARCH, "--steps", "3", "--batch",
                         str(LM_BATCH), "--seq", str(LM_SEQ),
                         "--store-backend", "auto", "--seed", str(seed),
                         "--dp"] + (["--device", "cpu", "--reduced"]
                                    if dev.type == "cpu" else []))]
    totals = {}
    for name, argv in runs:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", str(ROOT / "chip_smoke.py"),
             "--launcher-child", *argv], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=P14_TIMEOUT)
        lines = proc.stdout.splitlines()
        if proc.returncode != 0:
            log(proc.stdout[-3000:])
            log(proc.stderr[-3000:])
            raise AssertionError(f"14b: {name} exited {proc.returncode}")
        counts = json.loads(p14_line(lines, "[counts] ")[len("[counts] "):])
        line = p14_line(lines, "[train] ")
        ms = p14_ms(lines) if name.startswith("sparse") else "(3 steps)"
        log(f"phase 14b: torch.distributed.run {name}: rc 0 in "
            f"{time.perf_counter() - t0:.1f} s: {line}; {ms}; launches "
            f"{counts}")
        if "dp=True" not in line:
            raise AssertionError(f"14b: {name} did not run with dp=True")
        want_b3 = 12 if name.startswith("lm") else 0
        if counts["cs_ema_tiled"] != want_b3 or (
                name.startswith("sparse") and (counts["cs_update"] == 0
                                               or counts["cs_adam_tiled"])):
            raise AssertionError(f"14b: {name} launched {counts}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    return totals


def phase_p14_fold(dev, seed: int, tmp: Path, trained) -> dict:
    """14c: ``plan_resize`` and ``elastic_restore`` of 14a's checkpoint on
    the card: M and V folded from width 10,240 to 5,120 bit-equal to
    ``fold_sketches`` of a CPU copy, the table unchanged, then 10 steps
    on the folded family (B1) with finite losses whose median is below
    that of 14a's first 10 (``trained``: 14a's losses)."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.core.stores import StoreTree
    from repro_torch.data import ZipfLM, ZipfLMConfig
    from repro_torch.distributed import elastic_restore, plan_resize
    from repro_torch.launch import train
    from repro_torch.train.steps import (make_sparse_embedding_step,
                                         sparse_embedding_stores)
    plan = plan_resize(3, model_axis=1, old_data_axis=4)
    log(f"phase 14c: plan_resize(3, model_axis=1, old_data_axis=4) -> "
        f"{plan}")
    if (plan.data_axis, plan.fold_sketch) != (2, True):
        raise AssertionError("14c: plan_resize did not give data 2 and a "
                             "fold")
    like = {"params": 0, "opt_state": {"step": 0, "m": 0, "v": 0}}
    bare = ("opt_state/m", "opt_state/v")
    t0 = time.perf_counter()
    step, tree, folded = elastic_restore(
        tmp / "a", like, plan, device=dev,
        is_sketch=lambda path, _leaf: path in bare)
    secs = time.perf_counter() - t0
    host = p14_leaves(tmp / "a")
    want = store.fold_sketches(host, lambda path, _leaf: path in bare)
    st = tree["opt_state"]
    before = sum(sketch_bytes(host["opt_state"][k]) for k in ("m", "v"))
    after = sum(sketch_bytes(st[k]) for k in ("m", "v"))
    same = {k: torch.equal(st[k].cpu(), want["opt_state"][k])
            for k in ("m", "v")}
    table_same = torch.equal(tree["params"].cpu(), host["params"])
    log(f"phase 14c: elastic_restore of 14a's step-{step} checkpoint in "
        f"{secs:.2f} s: folded {folded}, M {tuple(host['opt_state']['m'].shape)}"
        f" -> {tuple(st['m'].shape)}, V -> {tuple(st['v'].shape)}, equal to "
        f"fold_sketches of a CPU copy to the bit {same}; table unchanged "
        f"{table_same}; sketch state {before} B -> {after} B")
    if step != P14_STEPS or not all(same.values()) or not table_same \
            or st["v"].shape[1] * 2 != host["opt_state"]["v"].shape[1] \
            or after * 2 != before:
        raise AssertionError("14c: the folded restore is wrong")
    hp = SketchHParams(compression=5.0)
    m_st, v_st = sparse_embedding_stores(VOCAB, D_MODEL, hparams=hp)
    stores = StoreTree(rules=(("sparse_embedding",
                               dataclasses.replace(m_st, spec=m_st.spec.fold()),
                               dataclasses.replace(v_st, spec=v_st.spec.fold())),))
    init_fn, step_fn, _opt = make_sparse_embedding_step(
        VOCAB, D_MODEL, lr=P14_LR, hparams=hp, stores=stores, device=dev)
    target = train.sparse_target(init_fn, seed, dev)
    data = ZipfLM(ZipfLMConfig(vocab_size=VOCAB, seq_len=SEQ,
                               global_batch=BATCH, seed=seed))
    table = tree["params"]
    reset_counts()
    losses = []
    for s in range(P14_STEPS, P14_STEPS + P14_FOLD_STEPS):
        ids = torch.from_numpy(data.batch(s)["tokens"].reshape(-1)).to(dev)
        rows = table[ids] - target[ids]
        losses.append(float(torch.mean(torch.square(rows))))
        table, st = step_fn(table, st, ids, rows)
    counts = read_counts()
    first = float(np.median(trained[:P14_STEPS // 2]))
    last = float(np.median(losses))
    log(f"phase 14c: {P14_FOLD_STEPS} steps on the folded family: losses "
        f"{losses}; median {last} against 14a's first {P14_STEPS // 2} "
        f"steps' {first}; {spikes(trained + losses)} spiked steps in 14a "
        f"and 14c; launches {counts}")
    if not np.all(np.isfinite(losses)) or not last < first \
            or counts["cs_adam_tiled"] != P14_FOLD_STEPS:
        raise AssertionError("14c: the folded family did not train on B1")
    return counts


def phase_p14_recovery(dev, seed: int, tmp: Path) -> dict:
    """14d: ``recovery_loop`` around the launcher's ``Trainer`` failing
    once at step 15 of 20: one restart (from the step-10 checkpoint), and
    the step-20 table and sketches equal to 14a's to the bit."""
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.distributed import recovery_loop
    from repro_torch.launch import train
    fail = [P14_FAIL_AT]
    base = train.Trainer

    class FailOnce(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, fail_at=fail.pop() if fail else None, **kw)

        def fit(self, state):
            try:
                return super().fit(state)
            except RuntimeError:
                if self._pending_ckpt is not None:
                    self._pending_ckpt.join()   # the step-10 write
                raise

    ckpt = tmp / "d"
    rcs, seen = [], []

    def run_steps(start, total):
        rc, lines, _losses = p14_main(p14_argv(dev, seed, ckpt, total))
        rcs.append((rc, p14_line(lines)))
        return store.latest_step(ckpt)

    def restore():
        return store.latest_step(ckpt) or 0

    reset_counts()
    train.Trainer = FailOnce
    try:
        out = recovery_loop(run_steps, restore, total_steps=P14_STEPS,
                            on_failure=lambda e: seen.append(str(e)))
    finally:
        train.Trainer = base
    counts = read_counts()
    got, want = p14_leaves(ckpt, P14_STEPS), p14_leaves(tmp / "a",
                                                        P14_STEPS)
    same = {"table": torch.equal(got["params"], want["params"]),
            **{k: torch.equal(got["opt_state"][k], want["opt_state"][k])
               for k in ("m", "v")}}
    log(f"phase 14d: recovery_loop: {out}; failures {seen}; launcher "
        f"runs {rcs}; step-20 state equal to 14a's to the bit {same}; "
        f"launches {counts}")
    if out.restarts != 1 or out.final_step != P14_STEPS \
            or not all(same.values()) \
            or counts["cs_adam_tiled"] != P14_STEPS + P14_FAIL_AT \
            - P14_CKPT_EVERY:
        raise AssertionError("14d: the recovered run is not 14a's")
    return counts


def phase_p14_replace(dev, seed: int, tmp: Path) -> dict:
    """14e: the launcher's sharded run on ``ReplicaMesh`` threads (1 x 4,
    width layout, phase 13a's table and 16,384 ids) for 5 steps, its
    global-leaf checkpoint restored onto 1 x 2 (each slab the block of
    the saved leaf, to the bit), 5 further steps there on B5's slab mode;
    a hash-layout checkpoint refused at another shard count."""
    import argparse
    import contextlib
    import io
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.distributed import ReplicaMesh
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train

    def on_mesh(shape, argv):
        """The launcher's sparse run on ``ReplicaMesh`` threads: (each
        replica's exit code or refusal, the printed lines)."""
        args = train.parser().parse_args(argv)
        size = shape[0] * shape[1]
        _shape, grid = train.grid_shapes(args, size)
        mesh = ReplicaMesh(shape, timeout=GROUP_TIMEOUT)

        def replica():
            a = argparse.Namespace(**vars(args))
            a.rank = mesh.rank
            try:
                return train.run_sparse_embedding(a, dev, mesh, grid)
            except ValueError as e:
                return f"ValueError: {e}"

        out = io.StringIO()
        with contextlib.redirect_stdout(out):   # one redirect, all threads
            rcs = mesh.run(replica, [()] * size)
        return rcs, out.getvalue().splitlines()

    reset_counts()
    t0 = time.perf_counter()
    rcs, lines = on_mesh((1, 4), p14_argv(dev, seed, tmp / "e",
                                          P14_SH_STEPS, "--sketch-shards",
                                          "4"))
    first = read_counts()
    log(f"phase 14e: 1 x 4 width-layout launcher run, {P14_SH_STEPS} steps:"
        f" exit codes {rcs} in {time.perf_counter() - t0:.1f} s: "
        f"{p14_line(lines)}; {p14_ms(lines)}; launches {first}")
    if first["cs_update"] == 0 or first["cs_adam_tiled"]:
        raise AssertionError("14e: the sharded run did not write slabs "
                             "through B5 alone")
    saved = p14_leaves(tmp / "e")
    like = {"params": 0, "opt_state": {"step": 0, "m": 0, "v": 0}}
    specs = {"params": (), "opt_state": {"step": (), "m": (None, "model"),
                                         "v": (None, "model")}}
    half = ReplicaMesh((1, 2), timeout=GROUP_TIMEOUT)

    def reread():
        _, tree = store.restore(tmp / "e", like, device=dev,
                                shardings=shd.Placement(specs, half))
        s, st = half.coords[1], tree["opt_state"]
        lw = saved["opt_state"]["v"].shape[1] // 2
        return all(torch.equal(st[k].cpu(),
                               saved["opt_state"][k][:, s * lw:(s + 1) * lw])
                   for k in ("m", "v")) and torch.equal(
            tree["params"].cpu(), saved["params"])

    blocks = half.run(reread, [()] * 2)
    log(f"phase 14e: restore(shardings=) onto 1 x 2: each replica's slabs "
        f"(3, {saved['opt_state']['v'].shape[1] // 2}, {D_MODEL}) equal to "
        f"its block of the saved global leaf to the bit {blocks}")
    if not all(blocks):
        raise AssertionError("14e: a restored slab is not its block")
    reset_counts()
    rcs2, lines = on_mesh((1, 2), p14_argv(dev, seed, tmp / "e",
                                           2 * P14_SH_STEPS,
                                           "--sketch-shards", "2"))
    second = read_counts()
    replaced = [l for l in lines if "re-placed: 4 -> 2 shards" in l]
    log(f"phase 14e: {P14_SH_STEPS} further steps on 1 x 2: exit codes "
        f"{rcs2}; {replaced[:1]}; {p14_line(lines)}; {p14_ms(lines)}; "
        f"launches {second}")
    if not replaced or second["cs_update"] == 0 \
            or second["cs_adam_tiled"] or store.latest_step(tmp / "e") \
            != 2 * P14_SH_STEPS:
        raise AssertionError("14e: the re-placed run failed")
    reset_counts()
    rcs3, _lines = on_mesh((1, 4), p14_argv(dev, seed, tmp / "h", 1,
                                            "--sketch-shards", "4",
                                            "--shard-layout", "hash"))
    third = read_counts()
    refused, _lines = on_mesh((1, 2), p14_argv(dev, seed, tmp / "h", 2,
                                               "--sketch-shards", "2",
                                               "--shard-layout", "hash"))
    log(f"phase 14e: hash layout at 4 shards, 1 step: exit codes {rcs3}; "
        f"resumed at 2 shards: {refused[0][:160]}")
    if not all(isinstance(r, str) and "bakes the shard count" in r
               for r in refused):
        raise AssertionError("14e: the hash layout was not refused")
    return {k: first[k] + second[k] + third[k] for k in first}


# ---------------------------------------------------------------- phase 15
# 15a-b: phase 8's cell through the launcher; 15c: phase 10's cell, whose
# flags equal ServerConfig()'s defaults
P15_X_STEPS, P15_DP_STEPS = 20, 10
MOE_ARCH = "qwen2_moe_a2_7b"       # src/repro/configs/qwen2_moe_a2_7b.py:11-16
# training keeps f32 params, gradients and Adam's m and v of every layer,
# 16 B a parameter: 4 layers hold 36.5 GB of them, 6 would pass 61 GB
MOE_LAYERS = 4
# every arm runs 10 steps, so the window check's w is 3: the first Adam
# steps at lr 1e-3 overshoot (the loss rises, then falls below its start)
MOE_STEPS = 10
# the witness arms of phases 15-17 (plain xla, and the auto arm again)
# run the first 5 of those steps and are held to the auto arm's state
# after them: at 10 steps each the smoke would pass its time limit
WITNESS_STEPS = 5


def p15_extreme_argv(dev, seed: int, steps: int, *extra) -> list:
    """The launcher's ``--workload extreme`` flags at phase 8's cell."""
    x = EXTREME
    argv = ["--workload", "extreme", "--classes", str(x["n_classes"]),
            "--meta-rows", str(x["n_meta"]), "--replicas", "2",
            "--features", str(x["n_features"]), "--extreme-dim",
            str(x["dim"]), "--nnz", str(x["nnz"]), "--negatives",
            str(x["n_negatives"]), "--batch", str(X_BATCH), "--lr",
            str(X_LR), "--sparse-compression", "100", "--steps",
            str(steps), "--seed", str(seed), *extra]
    return argv + (["--device", "cpu"] if dev.type == "cpu" else [])


def p15_serve_argv(dev, seed: int, *extra) -> list:
    """The launcher's ``--workload serve-replay`` flags at phase 10's
    cell (500 requests/s)."""
    argv = ["--workload", "serve-replay", "--sparse-rows", str(VOCAB),
            "--sparse-dim", str(D_MODEL), "--serve-requests",
            str(SERVE_TRACE["n_requests"]), "--serve-ids-per-request",
            str(SERVE_TRACE["ids_per_request"]), "--offered-load",
            str(SERVE_LOADS[1]), "--serve-batch-ids", "256",
            "--serve-deadline-ms", "5", "--queue-cap", "64", "--lr",
            str(SERVE_LR), "--seed", str(seed), *extra]
    return argv + (["--device", "cpu"] if dev.type == "cpu" else [])


def add_counts(totals: dict, counts: dict) -> dict:
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    return totals


def strip_tensors(x):
    """``x`` with every tensor, and every object other than a number,
    string or container, replaced by None."""
    if isinstance(x, dict):
        return {k: strip_tensors(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(strip_tensors(v) for v in x)
    return x if isinstance(x, (bool, int, float, str, type(None),
                               np.generic)) else None


def release(out: dict) -> int:
    """Drop the tensors that earlier phases' results hold (the kernels'
    line reads only their counts and times); returns the bytes still
    allocated on the card."""
    import gc
    import torch
    for k in list(out):
        out[k] = strip_tensors(out[k])
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()
    return 0


def phase_a14b(dev, seed: int, held: int = 0):
    """Phase 15: the launcher's extreme and serve-replay workloads,
    ``ops.adam_rows_fused`` and qwen2-moe-a2.7b (15a-f).  Returns the
    launches of the path and the numbers for the kernels' line."""
    import torch
    log(f"phase 15: {held} B allocated on the card as it starts")
    totals: dict = {}
    add_counts(totals, phase_p15_extreme(dev, seed))
    add_counts(totals, phase_p15_torchrun(dev, seed))
    add_counts(totals, phase_p15_serve(dev, seed))
    fused = phase_p15_fused(dev, seed)
    add_counts(totals, fused.pop("counts"))
    add_counts(totals, phase_moe_train(dev, seed))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    add_counts(totals, phase_moe_serve(dev, seed))
    log(f"phase 15: launches of the path {totals}")
    return totals, fused


def phase_p15_extreme(dev, seed: int) -> dict:
    """15a: ``--workload extreme`` in this process at phase 8's cell, 20
    steps a replica: exit 0 (each replica's window mean falls), B1 and
    the dedup sum (B5) once a table a step; then under ``--aux-budget``
    5,701,632 (phase 9a's plan): the plan table printed, exit 0."""
    runs = {}
    for name, extra in (("cs_rmsprop", ()),
                        ("--aux-budget", ("--aux-budget", str(X_BUDGET)))):
        reset_counts()
        t0 = time.perf_counter()
        rc, lines, losses = p14_main(p15_extreme_argv(dev, seed, P15_X_STEPS,
                                                      *extra))
        counts = read_counts()
        ms = [l[len("[train] "):] for l in lines if "ms a step" in l]
        log(f"phase 15a: launch.train --workload extreme {name} rc {rc} in "
            f"{time.perf_counter() - t0:.1f} s: {p14_line(lines)}; {ms}; "
            f"per-step losses {losses}; launches {counts}")
        want = 2 * 2 * P15_X_STEPS           # tables x replicas x steps
        if rc != 0 or len(losses) != 2 * P15_X_STEPS \
                or counts["cs_adam_tiled"] != want \
                or counts["cs_update"] != want:
            raise AssertionError(f"15a: the extreme launcher ({name}) did "
                                 f"not train through B1")
        if extra and not any("class_head/table" in l and "sketch" in l
                             for l in lines):
            raise AssertionError("15a: no plan table was printed")
        if extra:
            log("phase 15a: the plan table: " + " | ".join(
                l for l in lines if "/table" in l))
        runs[name] = counts
    return add_counts(dict(runs["cs_rmsprop"]), runs["--aux-budget"])


def phase_p15_torchrun(dev, seed: int) -> dict:
    """15b: ``torch.distributed.run --standalone --nproc-per-node 1`` (NCCL
    at world size 1) of ``--workload extreme --dp --error-feedback``, 10
    steps a replica: exit 0 with dp=True in its line; its sketches go
    through B5 and B1 is absent."""
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()      # the child shares the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    argv = p15_extreme_argv(dev, seed, P15_DP_STEPS, "--dp",
                            "--error-feedback")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", str(ROOT / "chip_smoke.py"),
         "--launcher-child", *argv], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=P14_TIMEOUT)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0:
        log(proc.stdout[-3000:])
        log(proc.stderr[-3000:])
        raise AssertionError(f"15b: extreme --dp exited {proc.returncode}")
    counts = json.loads(p14_line(lines, "[counts] ")[len("[counts] "):])
    line = p14_line(lines)
    ms = [l[len("[train] "):] for l in lines if "ms a step" in l]
    log(f"phase 15b: torch.distributed.run extreme --dp --error-feedback: "
        f"rc 0 in {time.perf_counter() - t0:.1f} s: {line}; {ms}; launches "
        f"{counts}")
    if "dp=True" not in line or counts["cs_adam_tiled"] \
            or (dev.type == "cuda" and counts["cs_update"] == 0):
        raise AssertionError(f"15b: extreme --dp launched {counts}: {line}")
    return counts


def phase_p15_serve(dev, seed: int) -> dict:
    """15c: ``--workload serve-replay`` at phase 10's cell: the count-min
    arm (B1, its CSR and the dedup sum once a batch and once for the
    server's warm-up) with ``--metrics-dir`` under ``build/`` (its
    ``serve`` record read back, then removed), and ``--optimizer
    dense_adam`` (B5 once a batch, no B1); both exit 0."""
    from repro_torch.obs import validate_file
    mdir = ROOT / "build" / f"metrics-15c-{seed}"
    shutil.rmtree(mdir, ignore_errors=True)
    totals: dict = {}
    try:
        for arm, extra in (("countmin", ("--metrics-dir", str(mdir))),
                           ("dense", ("--optimizer", "dense_adam"))):
            reset_counts()
            t0 = time.perf_counter()
            rc, lines, _ = p14_main(p15_serve_argv(dev, seed, *extra))
            counts = read_counts()
            line = p14_line(lines, "[serve] ")
            batches = int(line.split("batches=")[1].split()[0])
            log(f"phase 15c: launch.train --workload serve-replay rc {rc} "
                f"in {time.perf_counter() - t0:.1f} s: {line}; launches "
                f"{counts}")
            b1 = batches + 1 if arm == "countmin" else 0
            if rc != 0 or not line.startswith(f"[serve] arm={arm} ") \
                    or (dev.type == "cuda" and (
                        counts["cs_adam_tiled"] != b1
                        or counts["cs_update"] != batches + 1)):
                raise AssertionError(f"15c: the {arm} replay failed")
            if arm == "countmin":
                recs = [r for r in validate_file(mdir / "metrics.jsonl")
                        if r["kind"] == "serve"]
                if len(recs) != 1 or recs[0]["n_batches"] != batches:
                    raise AssertionError("15c: the serve record is wrong")
                log(f"phase 15c: the serve record: " + json.dumps(
                    {k: v for k, v in recs[0].items()
                     if k not in ("adapt_ms", "request_ms")}))
            add_counts(totals, counts)
    finally:
        shutil.rmtree(mdir, ignore_errors=True)
    return totals


def phase_p15_fused(dev, seed: int) -> dict:
    """15d: ``ops.adam_rows_fused`` at phase 4's shapes (16,384 zipf ids
    of 896 f32, ``SketchHParams()`` M and V (3, 10,240, 896)): B2 once
    (and its two ``bucket_prev`` CSRs), equal to ``adam_rows_stream`` to
    the bit; ms of both."""
    import torch
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops
    hp = SketchHParams()
    spec_m = hp.spec("p15d", (VOCAB, D_MODEL), signed=True)
    spec_v = hp.spec("p15d", (VOCAB, D_MODEL), signed=False)
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    M = torch.randn(spec_m.shape, generator=gen, device=dev) * 1e-3
    V = torch.rand(spec_v.shape, generator=gen, device=dev) * 1e-3
    ids = torch.from_numpy(zipf_ids(np.random.RandomState(seed + 15), 1)[0]
                           ).to(dev)
    g = torch.randn((ids.shape[0], D_MODEL), generator=gen, device=dev)
    step = torch.tensor(3, dtype=torch.int32)
    kw = dict(lr=LR, b1=0.9, b2=0.999, eps=1e-8)
    reset_counts()
    got = ops.adam_rows_fused(spec_m, spec_v, M.clone(), V.clone(), ids, g,
                              step, **kw)
    counts = read_counts()
    want = ops.adam_rows_stream(spec_m, spec_v, M.clone(), V.clone(), ids, g,
                                step, **kw)
    bits = all(torch.equal(a, b) for a, b in zip(got, want))
    work = [M.clone(), V.clone()]
    ms = cuda_ms(lambda: ops.adam_rows_fused(spec_m, spec_v, *work, ids, g,
                                             step, **kw), reps=3)
    ms_stream = cuda_ms(lambda: ops.adam_rows_stream(
        spec_m, spec_v, *work, ids, g, step, **kw), reps=3)
    log(f"phase 15d: ops.adam_rows_fused at ({ids.shape[0]}, {D_MODEL}), M "
        f"and V {tuple(spec_v.shape)}: launches {counts}; M, V and the "
        f"updates equal to adam_rows_stream's to the bit: {bits}; "
        f"{ms} ms a call (adam_rows_stream {ms_stream})")
    if dev.type == "cuda" and (counts["cs_adam_fused"] != 1
                               or counts["bucket_csr"] != 2):
        raise AssertionError(f"15d: adam_rows_fused launched {counts}")
    if not bits:
        raise AssertionError("15d: adam_rows_fused differs from "
                             "adam_rows_stream")
    return {"counts": counts, "ms": ms, "stream_ms": ms_stream}


def moe_config(layers=None):
    """qwen2-moe-a2.7b at full width, cut to ``layers`` layers if given."""
    from repro_torch import configs
    cfg = configs.get(MOE_ARCH)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


class DropCount:
    """While entered, every MoE routing call (``models.moe._route``) keeps
    its dropped assignments as a device scalar (no host sync)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.orig, self.per_call = moe, moe._route, []

        def route(*args, **kw):
            out = self.orig(*args, **kw)
            self.per_call.append((~out[2]).sum())
            return out
        moe._route = route
        return self

    def __exit__(self, *exc):
        self.mod._route = self.orig

    @property
    def calls(self) -> int:
        return len(self.per_call)

    def counts(self) -> list:
        import torch
        return torch.stack(self.per_call).tolist() if self.per_call else []

    def dropped(self) -> int:
        return int(sum(self.counts()))


class RouteLog:
    """While entered, the (T, K) expert ids of every MoE routing call
    (``models.moe.route_probs``), one entry a layer, in call order;
    ``take()`` returns them and starts a new list."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.orig, self.eids = moe, moe.route_probs, []

        def route_probs(*args, **kw):
            out = self.orig(*args, **kw)
            self.eids.append(out[2])
            return out
        moe.route_probs = route_probs
        return self

    def __exit__(self, *exc):
        self.mod.route_probs = self.orig

    def take(self) -> list:
        out, self.eids = self.eids, []
        return out


class MoERun(LMRun):
    """``LMRun`` for a model whose params and state do not fit twice on
    the card: the start params are drawn anew from the seed for every
    arm (the same bits each time), never kept."""

    def __init__(self, dev, seed: int, cfg):
        from repro_torch.data import ZipfLM, ZipfLMConfig
        self.dev, self.seed, self.cfg = dev, seed, cfg
        self.data = ZipfLM(ZipfLMConfig(vocab_size=cfg.vocab,
                                        seq_len=LM_SEQ,
                                        global_batch=LM_BATCH, seed=seed))

    def fresh(self, ts):
        import torch
        from repro_torch.train.trainer import TrainState
        params = ts.init_fn(torch.Generator(device=self.dev).manual_seed(
            self.seed))
        return TrainState(step=0, params=params,
                          opt_state=ts.optimizer.init(params))


def to_host(tree):
    """A copy of a tree of tensors in host memory."""
    import torch
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree.detach().to("cpu", copy=True) \
        if isinstance(tree, torch.Tensor) else tree


def host_compare(got, want) -> tuple:
    """(max abs difference, equal to the bit) of a tree on the card
    against its host copy, leaf by leaf (each host leaf copied back to
    the card), each within the witness envelope."""
    import torch
    from repro_torch.checkpoint.store import _flatten
    worst, bits = 0.0, True
    for (p, a), (q, b) in zip(_flatten(got), _flatten(want)):
        if p != q or (a is None) != (b is None):
            raise AssertionError(f"trees differ at {p!r} / {q!r}")
        if a is None:
            continue
        a, b = a.detach(), b.to(a.device)
        bits = bits and a.dtype == b.dtype and torch.equal(a, b)
        if a.dim() == 0:
            continue
        torch.testing.assert_close(a, b, **WITNESS_TOL, msg=p)
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        del b
    return worst, bits


def phase_moe_train(dev, seed: int) -> dict:
    """15e: qwen2-moe-a2.7b training at full width, 4 of its 24 layers
    (see the module docstring).  Returns the launches of its arms."""
    import torch
    from repro_torch.core.optimizers import state_bytes
    from repro_torch.core.partition import leaf_paths
    from repro_torch.models import transformer
    from repro_torch.plan import measure_aux_bytes
    cfg = moe_config(MOE_LAYERS)
    run = MoERun(dev, seed, cfg)
    n_params = sum(t.numel() for _p, t in leaf_paths(
        transformer.init(None, cfg, device="meta")))
    log(f"phase 15e: {cfg.name} cut to {cfg.n_layers} of "
        f"{moe_config().n_layers} layers: d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv} heads, {cfg.n_experts} experts top "
        f"{cfg.top_k} of d_ff {cfg.d_ff}, shared {cfg.shared_d_ff}, "
        f"capacity factor {cfg.capacity_factor}, {cfg.moe_groups} groups, "
        f"tables {cfg.vocab} x {cfg.d_model}; {n_params} params, "
        f"{cfg.compute_dtype} compute; ZipfLM {LM_BATCH} x {LM_SEQ} tokens "
        f"a step; cs_adam lr {LM_LR}, kernel_backend auto")
    totals: dict = {}
    ts = run.step()
    t_arm = time.perf_counter()
    with DropCount() as drops:
        state, losses, ms, counts, peak, _ = run.fit(
            ts, MOE_STEPS, snapshot=WITNESS_STEPS)
    add_counts(totals, counts)
    step_ms = statistics.median(ms[1:])
    cs_bytes = (measure_aux_bytes(state.opt_state),
                state_bytes(state.opt_state))
    # every layer routes its tokens twice a step: the forward and its
    # recompute under remat, the same inputs both times
    calls = drops.counts()
    span = 2 * cfg.n_layers
    per_step = [sum(calls[i:i + span]) / 2
                for i in range(0, len(calls), span)]
    log(f"phase 15e: {MOE_STEPS} steps: ms/step (CUDA events) median of "
        f"steps 2..{MOE_STEPS} {step_ms} (first {ms[0]}); all {ms}; losses "
        f"{losses}; launches {counts} ({counts['cs_ema_tiled'] / MOE_STEPS} "
        f"B3 a step); optimizer state {cs_bytes[0]} B ({cs_bytes[1]} with "
        f"the step counter); peak memory of the arm {peak} B; dropped "
        f"assignments a step (of {MOE_LAYERS * LM_BATCH * LM_SEQ * cfg.top_k}"
        f") {per_step}, by layer at the first step {calls[:cfg.n_layers]}; "
        f"{time.perf_counter() - t_arm:.1f} s")
    if counts["cs_ema_tiled"] != 4 * MOE_STEPS:
        raise AssertionError(f"B3 launched {counts['cs_ema_tiled']} times "
                             f"in {MOE_STEPS} steps, not 4 a step")
    if not (all(np.isfinite(losses)) and all(
            bool(torch.isfinite(t).all())
            for _p, t in leaf_paths(state.params))):
        raise AssertionError("15e: non-finite loss or params")
    host, run.snapshot = run.snapshot, None
    p, s = state.params, state.opt_state
    del state
    more = [{k: torch.as_tensor(v).to(dev) for k, v in
             run.data.batch(MOE_STEPS + i).items()} for i in range(3)]

    def three():
        nonlocal p, s
        for b in more:
            p, s, _ = ts.step_fn(p, s, b)
        torch.cuda.synchronize()
    profile_steps("phase 15e (profile)", three, step_ms, n=3)
    del p, s, more
    torch.cuda.empty_cache()
    t_arm = time.perf_counter()

    # the plain xla witness from the same start on the same batches, held
    # to the auto arm's state after as many steps
    w_state, w_losses, w_ms, w_counts, _, _ = run.fit(
        run.step(backend="xla"), WITNESS_STEPS)
    add_counts(totals, w_counts)
    head = losses[:WITNESS_STEPS]
    torch.testing.assert_close(torch.tensor(head), torch.tensor(w_losses),
                               rtol=WITNESS_TOL["rtol"], atol=0.0)
    err_p, bits_p = host_compare(w_state.params, host["params"])
    err_s, bits_s = host_compare(w_state.opt_state, host["opt_state"])
    log(f"phase 15e: plain xla: ms/step median "
        f"{statistics.median(w_ms[1:])}; launches {w_counts}; losses max "
        f"rel diff "
        f"{max(abs(a - b) / abs(b) for a, b in zip(head, w_losses))}, "
        f"params max_abs_err {err_p}, state {err_s} (rtol "
        f"{WITNESS_TOL['rtol']}, atol {WITNESS_TOL['atol']}) after "
        f"{WITNESS_STEPS} steps; equal to the bit: "
        f"{w_losses == head and bits_p and bits_s}; "
        f"{time.perf_counter() - t_arm:.1f} s with the comparison")
    del w_state
    torch.cuda.empty_cache()

    # the auto arm again, as many steps
    r_state, r_losses, _, r_counts, _, _ = run.fit(ts, WITNESS_STEPS)
    add_counts(totals, r_counts)
    _, bits_p = host_compare(r_state.params, host["params"])
    _, bits_s = host_compare(r_state.opt_state, host["opt_state"])
    if not (r_losses == head and bits_p and bits_s):
        raise AssertionError("15e: the auto arm run twice gave other bits")
    log("phase 15e: the auto arm run again: losses, params and state equal "
        "to the bit")
    del r_state, host
    torch.cuda.empty_cache()

    for mode, backend in (("dense_adam", None), ("cs_adam_v", "auto")):
        a_state, a_losses, a_ms, a_counts, a_peak, _ = run.fit(
            run.step(optimizer=mode, backend=backend), MOE_STEPS)
        add_counts(totals, a_counts)
        a_bytes = (measure_aux_bytes(a_state.opt_state),
                   state_bytes(a_state.opt_state))
        log(f"phase 15e: {mode} {MOE_STEPS} steps: losses {a_losses} "
            f"against cs_adam's {losses}; ms/step median "
            f"{statistics.median(a_ms[1:])}; optimizer state {a_bytes[0]} B "
            f"({a_bytes[1]} with the step counter) against cs_adam's "
            f"{cs_bytes[0]} B: cs_adam / {mode} {cs_bytes[0] / a_bytes[0]}; "
            f"peak memory of the arm {a_peak} B against cs_adam's {peak} B; "
            f"launches {a_counts}")
        del a_state
        torch.cuda.empty_cache()
        learns(f"15e: {mode}", a_losses)
    return totals


def causal_logits(cfg, params, tokens):
    """(b, s, vocab) f32 logits of every position of ``tokens`` from one
    causal forward of the model (no cache): position p's row is what a
    prefill of the prefix ending at p returns."""
    import torch
    from repro_torch.models import transformer as tm
    b, s = tokens.shape
    with torch.no_grad():
        x = tm.embed(cfg, params, tokens)
        x, _ = tm.backbone_train(cfg, params, x, tm._positions(b, s, x.device),
                                 remat=False)
        return tm.logits_fn(cfg, params, x).float()


def within_decode_tol(got, want) -> tuple:
    """11g's agreement of logits rows: (max |diff| / tolerance, rows whose
    top-two margin is within the tolerance, argmax equal on every other
    row); the tolerance is DECODE_TOL x the row's largest |logit|."""
    tol = DECODE_TOL * want.abs().amax(-1)
    ratio = float(((got - want).abs().amax(-1) / tol).max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    same = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    return ratio, int((~clear).sum()), same


def decode_agreement(cfg, params, prompts, dtype: str) -> dict:
    """64 greedy decode steps of ``cfg`` at capacity factor n_experts (no
    assignment can drop) in ``dtype`` compute, each step's logits held to
    the causal forward of its row's whole decoded sequence at that
    position (``causal_logits``); that forward also against prefills of
    the first and the last prefix; and the routing of every decoded token
    in every layer against the forward's."""
    import torch
    from repro_torch.serve import make_serve_step
    nd = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts),
                             compute_dtype=dtype)
    ss = make_serve_step(nd, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    with torch.no_grad(), DropCount() as drops, RouteLog() as routes:
        logits, cache = ss.prefill_fn(params, {"tokens": prompts})
        routes.take()
        seq, outs, dec = prompts, [], []
        for _ in range(DECODE):
            tok = logits.argmax(-1).to(torch.int32)
            seq = torch.cat([seq, tok[:, None]], dim=1)
            logits, cache = ss.decode_fn(params, cache, tok)
            outs.append(logits.float())
            dec.append(routes.take())
        del cache
        got = torch.stack(outs, dim=1)                 # (b, DECODE, vocab)
        want, fwd = [], []
        for r in range(SERVE_BATCH):
            want.append(causal_logits(nd, params, seq[r:r + 1])[
                0, PROMPT:PROMPT + DECODE])
            fwd.append(routes.take())
        want = torch.stack(want)
        prefix = 0.0
        for t in (0, DECODE - 1):
            for r in range(SERVE_BATCH):
                pre, _ = ss.prefill_fn(params, {
                    "tokens": seq[r:r + 1, :PROMPT + t + 1]})
                prefix = max(prefix, within_decode_tol(
                    pre.float()[0], want[r, t])[0])
    layers = len(dec[0])
    flips = [0] * layers
    for t in range(DECODE):
        for l in range(layers):
            a = torch.sort(dec[t][l].long(), -1).values
            b = torch.sort(torch.stack([fwd[r][l][PROMPT + t] for r in
                                        range(SERVE_BATCH)]).long(),
                           -1).values
            flips[l] += int((a != b).any(-1).sum())
    ratio, ties, same = within_decode_tol(got, want)
    return {"ratio": ratio, "ties": ties, "argmax_same": same,
            "prefix_ratio": prefix, "dropped": drops.dropped(),
            "calls": drops.calls, "flips_by_layer": flips}


def phase_moe_serve(dev, seed: int) -> dict:
    """15f: qwen2-moe-a2.7b served at all 24 layers on fresh params (see
    the module docstring).  Returns the launches (none: serving runs no
    optimizer)."""
    import torch
    from repro_torch.core.partition import leaf_paths
    from repro_torch.data import ZipfLM, ZipfLMConfig
    from repro_torch.models import transformer
    from repro_torch.serve import make_serve_step
    cfg = moe_config()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    params = transformer.init(torch.Generator(device=dev).manual_seed(seed),
                              cfg)
    n_bytes = sum(t.numel() * t.element_size()
                  for _p, t in leaf_paths(params))
    prompts = torch.as_tensor(ZipfLM(ZipfLMConfig(
        vocab_size=cfg.vocab, seq_len=PROMPT, global_batch=SERVE_BATCH,
        seed=seed + 1)).batch(0)["tokens"]).to(dev)
    # at the published capacity factor
    ss = make_serve_step(cfg, batch=SERVE_BATCH, max_seq=SERVE_MAX_SEQ)
    prefill_ms = cuda_ms(lambda: ss.prefill_fn(params, {"tokens": prompts}),
                         reps=3)
    with DropCount() as drops:
        logits, cache = ss.prefill_fn(params, {"tokens": prompts})
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(DECODE):
        tok = logits.argmax(-1).to(torch.int32)
        logits, cache = ss.decode_fn(params, cache, tok)
    e1.record()
    torch.cuda.synchronize()
    decode_ms = e0.elapsed_time(e1) / DECODE
    more = cache

    def three():
        nonlocal more
        tok = logits.argmax(-1).to(torch.int32)
        for _ in range(3):
            _, more = ss.decode_fn(params, more, tok)
        torch.cuda.synchronize()
    profile_steps("phase 15f (decode profile)", three, decode_ms, n=3)
    del cache, more
    per_layer = drops.counts()
    log(f"phase 15f: {cfg.name}, all {cfg.n_layers} layers, {n_bytes} B of "
        f"f32 params; make_serve_step(batch={SERVE_BATCH}, max_seq="
        f"{SERVE_MAX_SEQ}) at capacity factor {cfg.capacity_factor}: "
        f"prefill of {SERVE_BATCH} x {PROMPT} tokens {prefill_ms} ms, "
        f"{sum(per_layer)} of {SERVE_BATCH * PROMPT * cfg.top_k} assignments "
        f"a layer dropped over its {len(per_layer)} layers (by layer "
        f"{per_layer}); {DECODE} greedy decode steps {decode_ms} ms a token, "
        f"{SERVE_BATCH * 1e3 / decode_ms} tokens/s; "
        f"{time.perf_counter() - t0:.1f} s with the params' draw")

    # the agreement check where no assignment drops: in f32 compute, as
    # in bf16 a routing choice whose top-K gap is below bf16's rounding
    # of the router's input flips between decode and prefill (printed)
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        a = decode_agreement(cfg, params, prompts, dtype)
        log(f"phase 15f: {dtype} compute at capacity factor "
            f"{cfg.n_experts} ({a['dropped']} dropped in {a['calls']} "
            f"routing calls): {DECODE} decode steps against the causal "
            f"forward of each row's decoded sequence: max |diff| / "
            f"tolerance {a['ratio']} (tolerance {DECODE_TOL} x the row's "
            f"max |logit|), {a['ties']} of {DECODE * SERVE_BATCH} rows "
            f"within it, argmax equal elsewhere: {a['argmax_same']}; that "
            f"forward against the prefill of the first and last prefixes: "
            f"{a['prefix_ratio']}; decoded tokens routed otherwise than in "
            f"the forward, by layer: {a['flips_by_layer']}; "
            f"{time.perf_counter() - t0:.1f} s")
    peak = torch.cuda.max_memory_allocated() - base
    log(f"phase 15f: peak memory {peak} B above the {base} B before")
    if a["dropped"] or a["ratio"] > 1.0 or not a["argmax_same"] \
            or a["prefix_ratio"] > 1.0:
        raise AssertionError("15f: decode disagrees with the prefill of its "
                             "prefix in f32 compute")
    del params
    return read_counts()


# ---------------------------------------------------------------- phase 16
ENCDEC_ARCH = "whisper_medium"     # src/repro/configs/whisper_medium.py:11-16
VLM_ARCH = "internvl2_2b"          # src/repro/configs/internvl2_2b.py:10-14
P16_STEPS = 10
# (batch, text tokens) of a training step: 8 utterances of 1,536 stub
# frames and 448 decoder tokens (the public Whisper models' text
# context); 4 x (256 stub patches + 1,792 text tokens), the 2,048
# positions of a cell (patches count in seq_len as in the reference's
# src/repro/configs/__init__.py:102), a multiple of attn_chunk 1,024
P16_TRAIN = {ENCDEC_ARCH: (8, 448), VLM_ARCH: (4, 1_792)}
# (prompt tokens, max_seq) of the 8 served requests; 64 tokens decoded,
# then 3 more under the profiler: the VLM's cache also holds the 256
# patches (256 + 128 + 64 + 3 of 512)
P16_SERVE = {ENCDEC_ARCH: (32, 448), VLM_ARCH: (128, 512)}
RWKV_ARCH = "rwkv6_7b"             # src/repro/configs/rwkv6_7b.py:8-16
HYBRID_ARCH = "zamba2_2_7b"        # src/repro/configs/zamba2_2_7b.py:12-18
# rwkv6-7b trains at 8 of its 32 layers: dense Adam holds about 24 B a
# layer parameter at its peak (params, grads, m, v, clipped grads and
# updates), 5.25 GB a layer, so 8 layers (42.0 GB) and the two 65,536 x
# 4,096 tables (8.6 GB) fit one card where 32 (about 120 GB) do not
RWKV_TRAIN_LAYERS = 8
# zamba2-2.7b trains at 24 of its 54 layers (4 of its 9 groups, each the
# shared attention block and 6 Mamba2 layers): whole, its arms took 199 s
# of a smoke that reached 1,201 s of its 1,200 once phase 18 joined it
# (NVIDIA H100 80GB HBM3, 700 W)
HYBRID_TRAIN_LAYERS = 24
# (prompt tokens, max_seq): 128 prompt tokens (two chunks of 64: the
# chunked prefill), 64 decoded and 3 more under the profiler
P17_SERVE = {RWKV_ARCH: (128, 192), HYBRID_ARCH: (128, 192)}
# steps under the profiler after a training arm (3 unless named): a
# zamba2 step launches about 61,000 kernels, whose events took 41 s to
# gather for 3 steps
PROFILED_STEPS = {HYBRID_ARCH: 1}


def stub_normals(cfg, batch: int, dev, seed: int):
    """Seeded normal stub embeddings (batch, length, d_model) in
    ``cfg.dtype``, drawn on the card."""
    import torch
    from repro_torch.train.steps import stub_input
    _key, length = stub_input(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, length, cfg.d_model), generator=gen,
                       device=dev).to(cfg.dtype)


class StubStream:
    """``ZipfLM`` batches at the model's padded vocabulary and, a step
    each, the stub frontend's seeded normals, drawn once on the card.
    ``stub()`` is the entry of the step whose batch the trainer read
    last (it reads a step's batch just before it calls the step)."""

    def __init__(self, cfg, batch: int, seq: int, seed: int, dev):
        from repro_torch.data import ZipfLM, ZipfLMConfig
        from repro_torch.train.steps import stub_input
        self.key = stub_input(cfg)[0]
        self.data = ZipfLM(ZipfLMConfig(vocab_size=cfg.vocab, seq_len=seq,
                                        global_batch=batch, seed=seed))
        self.stubs = [stub_normals(cfg, batch, dev, seed + 1_600 + i)
                      for i in range(P16_STEPS)]
        self.last = 0

    def batch(self, step: int) -> dict:
        self.last = step
        return self.data.batch(step)

    def stub(self) -> dict:
        return {self.key: self.stubs[self.last % len(self.stubs)]}


class FamilyRun(MoERun):
    """``MoERun`` for the enc-dec or the VLM: the step adds the stream's
    stub input of the step to each batch."""

    def __init__(self, dev, seed: int, cfg, batch: int, seq: int):
        self.dev, self.seed, self.cfg = dev, seed, cfg
        self.data = StubStream(cfg, batch, seq, seed, dev)

    def step(self, optimizer="cs_adam", backend="auto", plan=None):
        ts = super().step(optimizer, backend, plan)
        inner, data = ts.step_fn, self.data

        def step_fn(params, opt_state, batch):
            return inner(params, opt_state, dict(batch, **data.stub()))
        return dataclasses.replace(ts, step_fn=step_fn)


def phase_family_train(dev, seed: int, arch: str, tag: str,
                       layers=None) -> dict:
    """16a / 16c / 17a / 17c: ``arch`` trained at full width, whole or cut
    to ``layers`` layers, ``cs_adam`` on ``auto`` (see the module
    docstring).  Returns the launches of its arms."""
    import torch
    from repro_torch import configs
    from repro_torch.core.optimizers import state_bytes
    from repro_torch.core.partition import leaf_paths
    from repro_torch.plan import measure_aux_bytes
    from repro_torch.train.steps import family_module, stub_input
    t_all = time.perf_counter()
    cfg = configs.get(arch)
    whole = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    stub = stub_input(cfg)
    if stub is None:
        batch, seq = LM_BATCH, LM_SEQ
        run = MoERun(dev, seed, cfg)
        front = ""
    else:
        batch, seq = P16_TRAIN[arch]
        run = FamilyRun(dev, seed, cfg, batch, seq)
        front = f"{stub[1]} stub {stub[0]} + "
    n_params = sum(t.numel() for _p, t in leaf_paths(
        family_module(cfg).init(None, cfg, device="meta")))
    depth = (f"{cfg.enc_layers} encoder and {cfg.n_layers} decoder"
             if cfg.family == "encdec" else str(cfg.n_layers))
    cut = "whole" if cfg.n_layers == whole else \
        f"cut to {layers} of {whole} layers"
    log(f"phase {tag}: {cfg.name} {cut}: {depth} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, tables {cfg.vocab} x "
        f"{cfg.d_model}; {n_params} params, {cfg.compute_dtype} compute; "
        f"{batch} x ({front}{seq} ZipfLM tokens) a step; cs_adam lr "
        f"{LM_LR}, kernel_backend auto")
    totals: dict = {}
    ts = run.step()
    t_arm = time.perf_counter()
    state, losses, ms, counts, peak, _ = run.fit(ts, P16_STEPS,
                                                 snapshot=WITNESS_STEPS)
    add_counts(totals, counts)
    step_ms = statistics.median(ms[1:])
    cs_bytes = (measure_aux_bytes(state.opt_state),
                state_bytes(state.opt_state))
    log(f"phase {tag}: {P16_STEPS} steps: ms/step (CUDA events) median of "
        f"steps 2..{P16_STEPS} {step_ms} (first {ms[0]}); all {ms}; losses "
        f"{losses}; launches {counts} ({counts['cs_ema_tiled'] / P16_STEPS} "
        f"B3 a step); optimizer state {cs_bytes[0]} B ({cs_bytes[1]} with "
        f"the step counter); peak memory of the arm {peak} B; "
        f"{time.perf_counter() - t_arm:.1f} s")
    if counts["cs_ema_tiled"] != 4 * P16_STEPS:
        raise AssertionError(f"{tag}: B3 launched {counts['cs_ema_tiled']} "
                             f"times in {P16_STEPS} steps, not 4 a step")
    if not (all(np.isfinite(losses)) and all(
            bool(torch.isfinite(t).all())
            for _p, t in leaf_paths(state.params))):
        raise AssertionError(f"{tag}: non-finite loss or params")
    host, run.snapshot = run.snapshot, None
    p, s = state.params, state.opt_state
    del state
    n_prof = PROFILED_STEPS.get(arch, 3)
    more = [{k: torch.as_tensor(v).to(dev) for k, v in
             run.data.batch(P16_STEPS + i).items()} for i in range(n_prof)]

    def three():
        nonlocal p, s
        for b in more:
            p, s, _ = ts.step_fn(p, s, b)
        torch.cuda.synchronize()
    profile_steps(f"phase {tag} (profile)", three, step_ms, n=n_prof)
    del p, s, more
    torch.cuda.empty_cache()

    # the plain xla witness and the auto arm again, from the same start
    # (drawn again from the seed) on the same batches: the same bits as
    # the auto arm after as many steps
    for arm, backend in (("plain xla", "xla"), ("auto again", "auto")):
        t_arm = time.perf_counter()
        w_state, w_losses, w_ms, w_counts, _, _ = run.fit(
            run.step(backend=backend), WITNESS_STEPS)
        add_counts(totals, w_counts)
        err_p, bits_p = host_compare(w_state.params, host["params"])
        err_s, bits_s = host_compare(w_state.opt_state, host["opt_state"])
        bits = w_losses == losses[:WITNESS_STEPS] and bits_p and bits_s
        log(f"phase {tag}: {arm}: ms/step median "
            f"{statistics.median(w_ms[1:])}; launches {w_counts}; params "
            f"max_abs_err {err_p}, state {err_s}; losses, params and state "
            f"after {WITNESS_STEPS} steps equal to the bit: {bits}; "
            f"{time.perf_counter() - t_arm:.1f} s with the comparison")
        del w_state
        torch.cuda.empty_cache()
        if not bits:
            raise AssertionError(f"{tag}: {arm} gave other bits than the "
                                 f"auto arm")
    del host

    for mode, backend in (("dense_adam", None), ("cs_adam_v", "auto")):
        t_arm = time.perf_counter()
        a_state, a_losses, a_ms, a_counts, a_peak, _ = run.fit(
            run.step(optimizer=mode, backend=backend), P16_STEPS)
        add_counts(totals, a_counts)
        a_bytes = (measure_aux_bytes(a_state.opt_state),
                   state_bytes(a_state.opt_state))
        log(f"phase {tag}: {mode} {P16_STEPS} steps: losses {a_losses} "
            f"against cs_adam's {losses}; ms/step median "
            f"{statistics.median(a_ms[1:])}; optimizer state {a_bytes[0]} B "
            f"({a_bytes[1]} with the step counter) against cs_adam's "
            f"{cs_bytes[0]} B: cs_adam / {mode} {cs_bytes[0] / a_bytes[0]}; "
            f"peak memory of the arm {a_peak} B against cs_adam's {peak} B; "
            f"launches {a_counts}; {time.perf_counter() - t_arm:.1f} s")
        del a_state
        torch.cuda.empty_cache()
        learns(f"{tag}: {mode}", a_losses)
    # cs_adam's own trend is printed, not gated: its sketched first
    # moment rises on a full softmax (ROADMAP C)
    first, last = loss_windows(losses)
    log(f"phase {tag}: cs_adam window means {first} -> {last} (printed, "
        f"not gated); {time.perf_counter() - t_all:.1f} s in all")
    return totals


def family_logits(cfg, params, stub, tokens):
    """(b, s, vocab) f32 logits of every text position of ``tokens`` from
    one forward of the model without a cache: position p's row is what a
    prefill of the text prefix ending at p returns."""
    import torch
    from repro_torch.models import encdec, mamba, rwkv, transformer as tm, vlm
    with torch.no_grad():
        if cfg.family in ("rwkv6", "hybrid"):
            x = tm.embed(cfg, params, tokens)
            if cfg.family == "rwkv6":
                x, _ = rwkv._run_stack(cfg, params, x, rwkv.zero_state(
                    cfg, x.shape[0], device=x.device), "chunked")
            else:
                x = mamba._run_train(cfg, params, x, remat=False)
            return tm.logits_fn(cfg, params, x).float()
        if cfg.family == "encdec":
            enc_out = encdec.encode(cfg, params, stub)
            x = encdec._embed(cfg, params, tokens)
            for lp in tm.layer_slices(params["dec_layers"]):
                x = encdec._dec_layer_full(cfg, lp, x, enc_out)
            x = encdec._ln(x, params["final_norm"])
            return (x @ params["lm_head"]["table"].to(cfg.dtype).T).float()
        x = vlm._prefix(cfg, params, stub, tokens)
        b, s, _ = x.shape
        x, _ = tm.backbone_train(cfg, params, x, tm._positions(b, s, x.device),
                                 remat=False)
        return tm.logits_fn(cfg, params, x[:, cfg.n_patches:]).float()


def serve_inputs(cfg, stub, tokens) -> dict:
    """``make_serve_step``'s batch: the tokens, and the stub frontend's
    embeddings under the family's key where it has one."""
    from repro_torch.train.steps import stub_input
    key = stub_input(cfg)
    return {"tokens": tokens} if key is None else {key[0]: stub,
                                                   "tokens": tokens}


def family_agreement(cfg, params, stub, prompts, max_seq: int,
                     dtype: str) -> dict:
    """64 greedy decode steps of ``cfg`` in ``dtype`` compute, each step's
    logits held to the forward of its row's whole decoded sequence at
    that position (``family_logits``); that forward also against the
    prefills of the first and the last prefix."""
    import torch
    from repro_torch.serve import make_serve_step
    nd = dataclasses.replace(cfg, compute_dtype=dtype)
    prompt = prompts.shape[1]
    ss = make_serve_step(nd, batch=SERVE_BATCH, max_seq=max_seq)
    with torch.no_grad():
        logits, cache = ss.prefill_fn(params, serve_inputs(cfg, stub,
                                                           prompts))
        seq, outs = prompts, []
        for _ in range(DECODE):
            tok = logits.argmax(-1).to(torch.int32)
            seq = torch.cat([seq, tok[:, None]], dim=1)
            logits, cache = ss.decode_fn(params, cache, tok)
            outs.append(logits.float())
        del cache
        got = torch.stack(outs, dim=1)                 # (b, DECODE, vocab)
        want = family_logits(nd, params, stub, seq)[:, prompt:prompt
                                                     + DECODE]
        prefix = 0.0
        for t in (0, DECODE - 1):
            pre, _ = ss.prefill_fn(params, serve_inputs(
                cfg, stub, seq[:, :prompt + t + 1]))
            prefix = max(prefix, within_decode_tol(pre.float(),
                                                   want[:, t])[0])
    ratio, ties, same = within_decode_tol(got, want)
    return {"ratio": ratio, "ties": ties, "argmax_same": same,
            "prefix_ratio": prefix}


def phase_family_serve(dev, seed: int, arch: str, tag: str) -> dict:
    """16b / 16d / 17b / 17d: ``arch`` served whole on fresh params (see
    the module docstring).  Returns the launches (none: serving runs no
    optimizer)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.partition import leaf_paths
    from repro_torch.data import ZipfLM, ZipfLMConfig
    from repro_torch.serve import make_serve_step
    from repro_torch.train.steps import family_module, stub_input
    t_all = time.perf_counter()
    cfg = configs.get(arch)
    prompt, max_seq = {**P16_SERVE, **P17_SERVE}[arch]
    key, length = stub_input(cfg) or (None, 0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    params = family_module(cfg).init(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    n_bytes = sum(t.numel() * t.element_size()
                  for _p, t in leaf_paths(params))
    stub = None if key is None else stub_normals(cfg, SERVE_BATCH, dev,
                                                 seed + 1_700)
    prompts = torch.as_tensor(ZipfLM(ZipfLMConfig(
        vocab_size=cfg.vocab, seq_len=prompt, global_batch=SERVE_BATCH,
        seed=seed + 1)).batch(0)["tokens"]).to(dev)
    inputs = serve_inputs(cfg, stub, prompts)
    ss = make_serve_step(cfg, batch=SERVE_BATCH, max_seq=max_seq)
    prefill_ms = cuda_ms(lambda: ss.prefill_fn(params, inputs), reps=3)
    logits, cache = ss.prefill_fn(params, inputs)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(DECODE):
        tok = logits.argmax(-1).to(torch.int32)
        logits, cache = ss.decode_fn(params, cache, tok)
    e1.record()
    torch.cuda.synchronize()
    decode_ms = e0.elapsed_time(e1) / DECODE
    # the 3 profiled steps go on from the 64 decoded where the cache has
    # room (17d's 192 positions hold 128 + 64: they go on from a prefill)
    more = cache if prompt + DECODE + 3 <= max_seq else \
        ss.prefill_fn(params, inputs)[1]

    def three():
        nonlocal more
        tok = logits.argmax(-1).to(torch.int32)
        for _ in range(3):
            _, more = ss.decode_fn(params, more, tok)
        torch.cuda.synchronize()
    profile_steps(f"phase {tag} (decode profile)", three, decode_ms, n=3)
    del cache, more
    log(f"phase {tag}: {cfg.name} whole, {n_bytes} B of f32 params; "
        f"make_serve_step(batch={SERVE_BATCH}, max_seq={max_seq}): prefill "
        f"of {SERVE_BATCH} x ({f'{length} stub {key} + ' if key else ''}"
        f"{prompt} tokens) "
        f"{prefill_ms} ms; {DECODE} greedy decode steps {decode_ms} ms a "
        f"token, {SERVE_BATCH * 1e3 / decode_ms} tokens/s; "
        f"{time.perf_counter() - t0:.1f} s with the params' draw")
    for dtype in ("bfloat16", "float32"):
        t0 = time.perf_counter()
        a = family_agreement(cfg, params, stub, prompts, max_seq, dtype)
        log(f"phase {tag}: {dtype} compute: {DECODE} decode steps against "
            f"the forward of each row's decoded sequence: max |diff| / "
            f"tolerance {a['ratio']} (tolerance {DECODE_TOL} x the row's max "
            f"|logit|), {a['ties']} of {DECODE * SERVE_BATCH} rows within "
            f"it, argmax equal elsewhere: {a['argmax_same']}; that forward "
            f"against the prefill of the first and last prefixes: "
            f"{a['prefix_ratio']}; {time.perf_counter() - t0:.1f} s")
    peak = torch.cuda.max_memory_allocated() - base
    log(f"phase {tag}: peak memory {peak} B above the {base} B before; "
        f"{time.perf_counter() - t_all:.1f} s in all")
    # gated in f32 compute, as 15f's check
    if a["ratio"] > 1.0 or not a["argmax_same"] or a["prefix_ratio"] > 1.0:
        raise AssertionError(f"{tag}: decode disagrees with the prefill of "
                             f"its prefix in f32 compute")
    del params
    return read_counts()


# the launcher's runs of phases 16e and 17e: (arch, further argv, B3
# launches in 3 steps, whether the losses must be finite)
P16_LAUNCHES = ((ENCDEC_ARCH, [], 12, True),
                # internvl2's zero patches stay zero through every layer,
                # where rmsnorm's backward multiplies by 1,000 a norm: the
                # gradient overflows to NaN after the first step, as in
                # the reference's launcher (tests/test_torch_vlm.py;
                # printed, not gated)
                (VLM_ARCH, [], 12, False))
# rwkv6-7b whole needs about 120 GB for dense Adam on one card and the
# launcher, as the reference's, has no flag that cuts layers: it runs
# reduced, where its 512-row tables are below min_rows 1,024 (no B3)
P17_LAUNCHES = ((HYBRID_ARCH, [], 12, True),
                (RWKV_ARCH, ["--reduced"], 0, True))


def phase_family_launcher(dev, seed: int, tag: str, runs) -> dict:
    """16e / 17e: ``python -m repro_torch.launch.train --workload lm``
    (its ``main`` in this process), 3 steps on ``--store-backend auto``
    for each ``(arch, extra argv, B3 launches, finite)`` of ``runs``:
    exit 0, the ``[train]`` line printed, B3 as given, and finite losses
    where asked."""
    totals: dict = {}
    for arch, extra, b3, finite in runs:
        reset_counts()
        t0 = time.perf_counter()
        rc, lines, losses = p14_main(
            ["--workload", "lm", "--arch", arch, "--steps", "3",
             "--store-backend", "auto", "--seed", str(seed)] + extra
            + (["--device", "cpu"] if dev.type == "cpu" else []))
        counts = read_counts()
        add_counts(totals, counts)
        line = [l for l in lines if l.startswith("[train] arch=")]
        log(f"phase {tag}: launch.train --workload lm --arch "
            f"{' '.join([arch] + extra)} rc {rc} in "
            f"{time.perf_counter() - t0:.1f} s: {line}; per-step losses "
            f"{losses}; launches {counts}")
        if rc != 0 or not line or counts["cs_ema_tiled"] != b3 or (
                finite and not all(np.isfinite(losses))):
            raise AssertionError(f"{tag}: the launcher's {arch} run failed")
    return totals


def time_ema_tables(dev, seed: int, archs=None, tag: str = "16") -> dict:
    """B3 as the LM step calls it on the vocabulary tables of ``archs``
    (whisper's and internvl2's by default; every row, signed, mask on,
    cached addressing): held to its plain version on the card within the
    collision envelope, timed against it and its byte bound."""
    import torch
    from repro_torch import configs
    from repro_torch.core.optimizers import SketchHParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.cs_ema_tiled import (cs_ema_tiled,
                                                  cs_ema_tiled_plain)
    out = {}
    for arch in archs or (ENCDEC_ARCH, VLM_ARCH):
        cfg = configs.get(arch)
        n, d = cfg.vocab, cfg.d_model
        spec = SketchHParams(compression=cfg.sketch_compression,
                             depth=cfg.sketch_depth).spec(
            "tok_embed/table", (n, d), signed=True)
        gen = torch.Generator(device=dev).manual_seed(seed + 61)
        S = torch.randn(spec.shape, generator=gen, device=dev)
        x = torch.randn((n, d), generator=gen, device=dev)
        mask = torch.ones((n, 1), device=dev)
        b, s = ops._cached_addressing(spec, n, dev)
        csr = ops._cached_csr(spec, n, dev)
        kw = dict(beta=0.9, scale=1.0 - 0.9)
        want = cs_ema_tiled_plain(S.clone(), b, s, x, mask, **kw)
        got = cs_ema_tiled(S.clone(), b, s, x, mask, csr=csr, **kw)
        err = max_err(want, got)
        del want, got
        if err > COLLISION_ATOL:
            raise AssertionError(f"B3 at {arch}'s tables: {err} against "
                                 f"its plain version")
        work = S.clone()
        ms = cuda_ms(lambda: cs_ema_tiled(work, b, s, x, mask, csr=csr,
                                          **kw), reps=10, warmup=2)
        plain_ms = cuda_ms(lambda: cs_ema_tiled_plain(work, b, s, x, mask,
                                                      **kw), reps=5)
        depth, width, _ = spec.shape
        nbytes = 4 * (2 * n * d + 2 * depth * width * d + 2 * depth * n + n)
        out[arch] = dict(n=n, d=d, sketch=list(spec.shape), ms=ms,
                         plain_ms=plain_ms, max_abs_err=err, bytes=nbytes,
                         bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        log(f"phase {tag}: B3 at {arch}'s table ({n}, {d}), sketch "
            f"{tuple(spec.shape)}: {ms} ms, plain {plain_ms} ms, bound "
            f"{out[arch]['bound_ms']} ms ({nbytes} B at 3.35 TB/s); "
            f"max_abs_err {err} against the plain version on the card")
        del S, x, mask, work
        torch.cuda.empty_cache()
    return out


def phase_a14b_part3(dev, seed: int, held: int = 0):
    """Phase 16: whisper-medium and internvl2-2b trained and served whole,
    and through the launcher (16a-e), and B3 at their tables.  Returns
    the launches of the path and B3's times at the tables."""
    import torch
    log(f"phase 16: {held} B allocated on the card as it starts")
    totals: dict = {}
    b3 = time_ema_tables(dev, seed)
    for arch, train_tag, serve_tag in ((ENCDEC_ARCH, "16a", "16b"),
                                       (VLM_ARCH, "16c", "16d")):
        add_counts(totals, phase_family_train(dev, seed, arch, train_tag))
        torch.cuda.empty_cache()
        add_counts(totals, phase_family_serve(dev, seed, arch, serve_tag))
        torch.cuda.empty_cache()
    add_counts(totals, phase_family_launcher(dev, seed, "16e",
                                             P16_LAUNCHES))
    log(f"phase 16: launches of the path {totals}")
    return totals, b3


def phase_a14b_part4(dev, seed: int, held: int = 0):
    """Phase 17: rwkv6-7b (cut to 8 layers) and zamba2-2.7b (whole)
    trained, both served whole, the launcher (17a-e), and B3 at their
    tables.  Returns the launches of the path and B3's times at the
    tables."""
    import torch
    from repro_torch.models.mamba import ssd_chunked
    log(f"phase 17: {held} B allocated on the card as it starts")
    totals: dict = {}
    b3 = time_ema_tables(dev, seed, (RWKV_ARCH, HYBRID_ARCH), tag="17")
    for arch, layers, train_tag, serve_tag in (
            (RWKV_ARCH, RWKV_TRAIN_LAYERS, "17a", "17b"),
            (HYBRID_ARCH, HYBRID_TRAIN_LAYERS, "17c", "17d")):
        chunked = (ssd_chunked.calls, ssd_chunked.kernel_calls)
        train = phase_family_train(dev, seed, arch, train_tag, layers)
        chunked = (ssd_chunked.calls - chunked[0],
                   ssd_chunked.kernel_calls - chunked[1])
        add_counts(totals, train)
        torch.cuda.empty_cache()
        serve = phase_family_serve(dev, seed, arch, serve_tag)
        add_counts(totals, serve)
        torch.cuda.empty_cache()
        check_ssd_launches(arch, train_tag, train, chunked, serve_tag,
                           serve)
    add_counts(totals, phase_family_launcher(dev, seed, "17e",
                                             P17_LAUNCHES))
    log(f"phase 17: launches of the path {totals}")
    return totals, b3


def check_ssd_launches(arch, train_tag, train, chunked, serve_tag,
                       serve) -> None:
    """Phase 17's B14 launches, counted from zero by each arm: zamba2's
    Mamba2 layers (bf16, head dim 64, chunk 64, state 64) send every
    chunked SSD of its training arms to the kernels, forward and
    backward, and its chunked prefill to the forward; rwkv6 runs none."""
    b14 = {tag: (counts["ssd_fwd"], counts["ssd_bwd"])
           for tag, counts in ((train_tag, train), (serve_tag, serve))}
    log(f"phase {train_tag}/{serve_tag}: B14 launches (forward, backward) "
        f"{b14}; ssd_chunked calls in {train_tag} {chunked[0]}, "
        f"{chunked[1]} on the kernels")
    if arch != HYBRID_ARCH:
        if any(map(any, b14.values())):
            raise AssertionError(f"{train_tag}: {arch} launched B14")
        return
    fwd, bwd = b14[train_tag]
    # the profiled steps after an arm call the SSD outside fit's counts
    if not (fwd and bwd and chunked[0] == chunked[1] >= fwd):
        raise AssertionError(f"{train_tag}: not every chunked SSD took B14 "
                             f"({chunked}, launches {fwd}, {bwd})")
    if not b14[serve_tag][0]:
        raise AssertionError(f"{serve_tag}: the chunked prefill did not "
                             f"launch B14")


# ---------------------------------------------------------------- phase 18
P18_ARCH = "qwen2_0_5b"
# (FLOPs, bytes, argument bytes) of the dry run's qwen2-0.5b cells on one
# card, traced on the CPU's meta device (tests/test_torch_dryrun.py holds
# the same numbers there)
P18_META = {"train_4k": (5_586_756_019_683_328, 269_513_461_305_048,
                         5_832_645_124),
            "decode_32k": (487_231_324_160, 503_582_576_100,
                           54_060_277_764)}
P18_STEPS, P18_LOG_EVERY = 10, 5
# the four torch examples at their smoke sizes (each a subprocess)
P18_EXAMPLES = (("quickstart", ()),
                ("train_lm_100m", ("--small", "--steps", "20")),
                ("elastic_recovery", ()),
                ("serve_decode", ("--arch", "yi_9b")),
                ("serve_decode", ("--arch", "rwkv6_7b")))
P18_TIMEOUT = 400.0            # s for one example


def example_child(argv) -> int:
    """``--example-child SCRIPT ARGS``: the example as ``python SCRIPT
    ARGS`` runs it, then the kernels' launch counts of the run as
    ``[counts] {json}``."""
    import runpy
    reset_counts()
    sys.argv = list(argv)
    rc = 0
    try:
        runpy.run_path(argv[0], run_name="__main__")
    except SystemExit as e:
        rc = 0 if e.code is None else e.code
    print("[counts] " + json.dumps(read_counts()), flush=True)
    return rc


def phase_p18_dryrun(dev, seed: int) -> None:
    """18a: the dry run in this process: qwen2-0.5b ``train_4k`` and
    ``decode_32k`` traced on ``meta`` (the same counts as on the CPU; the
    train cell's FLOPs 256 x the reference record's a device); the
    meta record's argument bytes against the real params, CS-Adam state
    and batch on the card; one step at a batch the card holds counted
    under ``op_cost`` on the card (B3 launched), equal in FLOPs to its
    meta trace, its time beside the roofline bound."""
    import torch
    from repro_torch import configs
    from repro_torch.data import ZipfLM, ZipfLMConfig
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.train.steps import make_train_step
    cfg = configs.get(P18_ARCH)
    ref = json.loads((ROOT / "experiments" / "dryrun" / "single"
                      / f"{P18_ARCH}__train_4k.json").read_text())
    for name, (flops, nbytes, args) in P18_META.items():
        t0 = time.perf_counter()
        cost, _ps, _tok, _kind, info = dryrun.trace_cell(
            cfg, configs.SHAPES[name])
        log(f"phase 18a: {P18_ARCH} {name} on meta in "
            f"{time.perf_counter() - t0:.1f} s: {cost.flops} FLOPs "
            f"(the CPU's {flops}), {cost.bytes} bytes (the CPU's {nbytes}, "
            f"equal {cost.bytes == nbytes}), argument bytes "
            f"{info['argument_bytes']} (the CPU's {args})")
        if cost.flops != flops or info["argument_bytes"] != args:
            raise AssertionError(f"18a: the {name} trace differs from the "
                                 f"CPU's")
    want = 256 * ref["roofline"]["flops_per_device"]
    log(f"phase 18a: train_4k FLOPs {P18_META['train_4k'][0]} against 256 x "
        f"the reference record's {ref['roofline']['flops_per_device']} = "
        f"{want}")
    if P18_META["train_4k"][0] != want:
        raise AssertionError("18a: train_4k FLOPs are not the reference's")

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ts = make_train_step(cfg, optimizer="cs_adam", lr=LM_LR,
                         kernel_backend="auto", device=dev)
    params = ts.init_fn(torch.Generator(device=dev).manual_seed(seed))
    state = ts.optimizer.init(params)
    full = {k: torch.zeros(tuple(v.shape), dtype=v.dtype, device=dev)
            for k, v in configs.train_batch_specs(
                cfg, configs.SHAPES["train_4k"]).items()}
    real = sum(analysis.tree_nbytes(t) for t in (params, state, full))
    log(f"phase 18a: the real params, CS-Adam state and train_4k batch on "
        f"the card: {real} B by nbytes against the meta record's "
        f"{P18_META['train_4k'][2]}; torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() - base} B above the phase's start")
    if real != P18_META["train_4k"][2]:
        raise AssertionError("18a: the meta argument bytes are not the "
                             "real tensors' nbytes")
    del full

    shape = configs.ShapeConfig("train_4k@card", "train", LM_SEQ, LM_BATCH)
    meta, ps, tokens, _kind, _info = dryrun.trace_cell(
        cfg, shape, store_backend="auto", sources=True)
    data = ZipfLM(ZipfLMConfig(vocab_size=cfg.vocab, seq_len=LM_SEQ,
                               global_batch=LM_BATCH, seed=seed))
    batch = {k: torch.as_tensor(v).to(dev) for k, v in data.batch(0).items()}
    ts.step_fn(params, state, batch)
    torch.cuda.synchronize()
    before = read_counts()
    with OpCost(sources=True) as card:
        ts.step_fn(params, state, batch)
    torch.cuda.synchronize()

    def attn_flops(cost):
        # under obs.attn: the einsums on meta; on the card the flash
        # attention kernels, which report the FLOPs of those einsums
        return sum(r.flops for r in cost.rows.values()
                   if r.source.split(" ")[0] == "obs.attn")
    after = read_counts()
    b3 = after["cs_ema_tiled"] - before["cs_ema_tiled"]
    flash = tuple(after[n] - before[n]
                  for n in ("flash_attn_fwd", "flash_attn_bwd"))
    ms = cuda_ms(lambda: ts.step_fn(params, state, batch), reps=3,
                 warmup=0)
    peak = torch.cuda.max_memory_allocated() - base
    roof = dryrun.roofline(cfg, meta, ps, tokens, "train", 1)
    log(f"phase 18a: one step of {LM_BATCH} x {LM_SEQ} tokens on the card "
        f"under op_cost: {card.flops} FLOPs, {card.bytes} bytes, B3 "
        f"{b3}, B10 {flash} (forward, backward); on meta {meta.flops} "
        f"FLOPs, {meta.bytes} bytes")
    log(f"phase 18a: the step {ms} ms (CUDA events, mean of 3) against the "
        f"roofline bound {roof.step_s * 1e3} ms ({roof.dominant}: compute "
        f"{roof.compute_s * 1e3} ms at {analysis.PEAK_FLOPS_BF16:.4g} "
        f"FLOP/s, memory {roof.memory_s * 1e3} ms of unfused bytes at "
        f"{analysis.HBM_BW:.4g} B/s); model FLOPs "
        f"{roof.model_flops_per_device}, "
        f"{roof.model_flops_per_device / (ms * 1e-3) / 1e12} TFLOP/s; "
        f"memory {json.dumps(analysis.memory_dict(real, peak))} (the peak "
        f"measured by torch.cuda.max_memory_allocated above the start)")
    log(f"phase 18a: attention's FLOPs (obs.attn) on meta "
        f"{attn_flops(meta)}, on the card {attn_flops(card)} (its kernels)")
    if (card.flops != meta.flops or attn_flops(card) != attn_flops(meta)
            or not attn_flops(meta) or b3 != 4
            or flash != (2 * cfg.n_layers, cfg.n_layers)):
        raise AssertionError(f"18a: the card's step counted {card.flops} "
                             f"FLOPs ({attn_flops(card)} under obs.attn), "
                             f"B3 {b3} and B10 {flash} times; meta "
                             f"{meta.flops} ({attn_flops(meta)} under "
                             f"obs.attn), B3 4, B10 {2 * cfg.n_layers} and "
                             f"{cfg.n_layers}")


def phase_p18_breakdown() -> None:
    """18b: ``launch.breakdown --device cuda`` on 18a's cell at 18a's
    batch."""
    import contextlib
    import io
    from repro_torch.launch import breakdown
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = breakdown.main(["--arch", P18_ARCH, "--shape", "train_4k",
                             "--device", "cuda", "--batch", str(LM_BATCH),
                             "--seq", str(LM_SEQ), "--store-backend", "auto",
                             "--kind", "all", "--top", "8"])
    for line in buf.getvalue().splitlines():
        if line.strip():
            log(f"phase 18b: {line}")
    if rc != 0:
        raise AssertionError(f"18b: breakdown exited {rc}")


def one_monitor_records(mon, gathered, steps) -> list:
    """The records one fresh copy of the launcher's ``mon`` computes in
    this thread on each gathered state at its step, through the JSON the
    writer writes."""
    out, last = [], 0
    for st, step in zip(gathered, steps):
        fresh = dataclasses.replace(mon, getter=None)
        fresh._keys = fresh._host = fresh._pending = None
        fresh._last_step = last
        fresh.collect(st, step)
        out.append(json.loads(json.dumps(fresh.flush())))
        last = step
    return out


def phase_p18_monitors(dev, seed: int) -> None:
    """18c: A13d.  The launcher's ``sparse_embedding`` at its default
    sizes on ``ReplicaMesh`` threads, 1 x 4 in the width layout and 1 x 2
    in the hash layout, with ``--metrics-dir`` and ``--probe-rows 16``,
    10 steps, ``--log-every 5``: every replica gathers the slabs at each
    boundary, replica 0 writes.  The records validate, and each ``table``
    record equals to the bit what one monitor in this thread computes
    on the gathered state; the gather's ms."""
    import argparse
    import contextlib
    import io
    import torch
    from repro_torch.distributed import ReplicaMesh
    from repro_torch.launch import train
    from repro_torch.obs import validate_file
    for shape, layout in (((1, 4), "width"), ((1, 2), "hash")):
        out_dir = ROOT / "build" / f"metrics-18c-{layout}"
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = ["--workload", "sparse_embedding", "--steps", str(P18_STEPS),
                "--log-every", str(P18_LOG_EVERY), "--probe-rows", "16",
                "--metrics-dir", str(out_dir), "--seed", str(seed),
                "--sketch-shards", str(shape[1]), "--shard-layout", layout]
        if dev.type == "cpu":
            argv += ["--device", "cpu"]
        args = train.parser().parse_args(argv)
        _shape, grid = train.grid_shapes(args, shape[0] * shape[1])
        mesh = ReplicaMesh(shape, timeout=GROUP_TIMEOUT)
        monitors, gathered, gather_ms = [], [], []
        make, gather = train.make_observer, train.shd.global_tree

        def make_observer(a, meta, mons=(), *rest, **kw):
            if mesh.rank == 0:
                monitors.extend(mons)
            return make(a, meta, mons, *rest, **kw)

        def global_tree(tree, placement):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = gather(tree, placement)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if mesh.rank == 0:
                gather_ms.append((time.perf_counter() - t0) * 1e3)
                gathered.append(clone_tree(got))
            return got

        def replica():
            a = argparse.Namespace(**vars(args))
            a.rank = mesh.rank
            return train.run_sparse_embedding(a, dev, mesh, grid)

        before = read_counts()
        buf = io.StringIO()
        train.make_observer, train.shd.global_tree = make_observer, global_tree
        try:
            with contextlib.redirect_stdout(buf):   # one redirect, all threads
                rcs = mesh.run(replica, [()] * mesh.size)
        finally:
            train.make_observer, train.shd.global_tree = make, gather
        after = read_counts()
        counts = {k: after[k] - before[k] for k in after}
        recs = [{k: v for k, v in r.items() if k not in ("schema", "kind")}
                for r in validate_file(out_dir / "metrics.jsonl")
                if r["kind"] == "table"]
        steps = [r["step"] for r in recs]
        mine = one_monitor_records(monitors[0], gathered, steps)
        lines = [l for l in buf.getvalue().splitlines()
                 if l.startswith("[train]")]
        log(f"phase 18c: {shape[0]} x {shape[1]} {layout}: exit codes {rcs}; "
            f"{lines[-1] if lines else ''}; table records at steps {steps}, "
            f"each equal to one monitor on the gathered state: "
            f"{recs == mine}; the gather's ms on replica 0 {gather_ms}; "
            f"gathered v {tuple(gathered[0]['v'].shape)}; launches {counts}")
        log(f"phase 18c: last table record {json.dumps(recs[-1])}")
        shutil.rmtree(out_dir, ignore_errors=True)
        if any(rc != 0 for rc in rcs) or recs != mine \
                or steps != [P18_LOG_EVERY, P18_STEPS]:
            raise AssertionError(f"18c: the {layout} run's table records "
                                 f"are not the gathered tables'")
        if dev.type == "cuda" and (counts["cs_update"] == 0
                                   or counts["bucket_csr"] == 0
                                   or counts["cs_adam_tiled"]):
            raise AssertionError("18c: the sharded run did not write slabs "
                                 "through B5 alone")


def phase_p18_examples(dev) -> dict:
    """18d: the four ``examples_torch/`` scripts as subprocesses on the
    card at their smoke sizes, all started together: each must exit 0
    and print its device; their kernels' launches."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    try:
        for name, extra in P18_EXAMPLES:
            cmd = [sys.executable, str(ROOT / "chip_smoke.py"),
                   "--example-child",
                   str(ROOT / "examples_torch" / f"{name}.py"), *extra]
            if dev.type == "cpu":
                cmd += ["--device", "cpu"]
            procs.append((name, extra, subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        totals: dict = {}
        failed = []
        for name, extra, p in procs:
            out, _ = p.communicate(timeout=P18_TIMEOUT)
            lines = out.splitlines()
            counts = next((json.loads(l[len("[counts] "):]) for l in lines
                           if l.startswith("[counts] ")), {})
            add_counts(totals, counts)
            first = next((l for l in lines if l.startswith("device: ")), "")
            tail = [l for l in lines if not l.startswith("[counts]")][-3:]
            log(f"phase 18d: {name} {' '.join(extra)}: exit {p.returncode}; "
                f"{first}; B3 launches {counts.get('cs_ema_tiled')}; "
                f"{' | '.join(tail)}")
            want = dev.type
            if p.returncode != 0 or not first.startswith(f"device: {want}") \
                    or (dev.type == "cuda" and name != "serve_decode"
                        and not counts.get("cs_ema_tiled")):
                failed.append(name)
                log(f"phase 18d: {name} output: {out[-3000:]}")
    finally:
        for _n, _e, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError(f"18d: {failed} failed")
    return totals


def phase_slice17(dev, seed: int, held: int = 0) -> dict:
    """Phase 18: the dry run and its cost tooling in the card's process
    (18a, 18b), the table monitors under a sharded grid (18c) and the
    torch examples (18d).  Returns the launches of the path."""
    import torch
    log(f"phase 18: {held} B allocated on the card as it starts")
    reset_counts()
    t0 = time.perf_counter()
    phase_p18_dryrun(dev, seed)
    torch.cuda.empty_cache()
    log(f"phase 18a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_p18_breakdown()
    torch.cuda.empty_cache()
    log(f"phase 18b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_p18_monitors(dev, seed)
    log(f"phase 18c: {time.perf_counter() - t0:.1f} s")
    totals = read_counts()
    t0 = time.perf_counter()
    add_counts(totals, phase_p18_examples(dev))
    log(f"phase 18d: {time.perf_counter() - t0:.1f} s")
    log(f"phase 18: launches of the path {totals}")
    return totals


FLASH_TOL = 1e-5                   # tests/test_torch_cuda.py::FLASH_TOL
BF16_PEAK = 989.4e12               # H100 SXM data sheet, dense bf16
FLASH_SHAPES = {"qwen2-0.5b": (4, 2048, 14, 2, 64),
                "hd128": (1, 2048, 16, 16, 128)}


def time_flash(dev, seed: int, name: str) -> dict:
    """Phase 19 at one shape: the kernels against their plain versions,
    then their times beside the bound, the plain versions' and SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attn as fa
    b, s, hq, hkv, hd = FLASH_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(bf)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(bf)
    v = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(bf)
    dout = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(bf)
    n_f, n_b = fa.flash_attn_fwd.launches, fa.flash_attn_bwd.launches
    out, o, lse = fa.flash_attn_fwd(q, k, v, True, 0)
    grads = fa.flash_attn_bwd(q, k, v, o, lse, dout, True, 0)
    again = fa.flash_attn_bwd(q, k, v, o, lse, dout, True, 0)
    torch.cuda.synchronize()
    if (fa.flash_attn_fwd.launches - n_f, fa.flash_attn_bwd.launches
            - n_b) != (1, 2):
        raise SystemExit(f"phase 19 ({name}): launches not counted")
    if not all(torch.equal(a, c) for a, c in zip(grads, again)):
        raise SystemExit(f"phase 19 ({name}): two backward calls differ")
    p_out, p_o, p_lse = fa.flash_attn_fwd_plain(q, k, v, True, 0)
    p_grads = fa.flash_attn_bwd_plain(q, k, v, p_o, p_lse, dout, True, 0)

    def gap(got, want):
        return float(torch.linalg.vector_norm((got - want).double())
                     / torch.linalg.vector_norm(want.double()))
    gaps = {"o": gap(o, p_o), "lse": gap(lse, p_lse)}
    for key, a, w in zip(("dq", "dk", "dv"), grads, p_grads):
        gaps[key] = gap(a, w)
    log(f"phase 19 ({name}): gaps to the plain versions {gaps}")
    if not all(x <= FLASH_TOL for x in gaps.values()):
        raise SystemExit(f"phase 19 ({name}): a gap above {FLASH_TOL}")
    del p_out, p_o, p_lse, p_grads, again
    fwd_ms = cuda_ms(lambda: fa.flash_attn_fwd(q, k, v, True, 0), 20, 2)
    bwd_ms = cuda_ms(lambda: fa.flash_attn_bwd(q, k, v, o, lse, dout,
                                               True, 0), 20, 2)
    plain_fwd_ms = cuda_ms(lambda: fa.flash_attn_fwd_plain(q, k, v, True,
                                                           0), 3)
    plain_bwd_ms = cuda_ms(lambda: fa.flash_attn_bwd_plain(
        q, k, v, o, lse, dout, True, 0), 3)
    # SDPA: a yardstick only, never called by the port
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=hq != hkv)
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(sdpa, 20, 2)
    lib_both_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dt), 20, 2)
    pairs = s * (s + 1) // 2
    flops_fwd = 4 * b * hq * hd * pairs          # S and P V
    flops_bwd = 2 * flops_fwd                    # dV, dP, dQ, dK
    row = {"name": "flash_attn", "shape": name,
           "b_s_hq_hkv_hd": [b, s, hq, hkv, hd], "causal": True,
           "ms": fwd_ms, "bwd_ms": bwd_ms,
           "bound_ms": flops_fwd / BF16_PEAK * 1e3,
           "bwd_bound_ms": flops_bwd / BF16_PEAK * 1e3, "bound_by": "flops",
           "flops": flops_fwd, "bwd_flops": flops_bwd,
           # the MMAs the design runs: S 1 + P V 3; the dK/dV kernel S 1 +
           # dP 1 + dV 3 + dK 3, the dQ kernel S 1 + dP 1 + dQ 3
           "mma_flops": 2 * flops_fwd, "bwd_mma_flops": 13 * flops_bwd // 4,
           "plain_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
           "library_ms": lib_fwd_ms, "library_bwd_ms": lib_both_ms
           - lib_fwd_ms, "gaps": gaps}
    log(f"phase 19 ({name}): forward {fwd_ms:.4f} ms (bound "
        f"{row['bound_ms']:.4f}, plain {plain_fwd_ms:.3f}, SDPA "
        f"{lib_fwd_ms:.4f}), backward {bwd_ms:.4f} ms (bound "
        f"{row['bwd_bound_ms']:.4f}, plain {plain_bwd_ms:.3f}, SDPA "
        f"{row['library_bwd_ms']:.4f}); the design's MMA rate forward "
        f"{row['mma_flops'] / fwd_ms * 1e-9:.1f} TFLOP/s, backward "
        f"{row['bwd_mma_flops'] / bwd_ms * 1e-9:.1f}")
    return row


def phase_flash(dev, seed: int) -> list:
    """Phase 19: flash attention's kernels at qwen2-0.5b's shapes and at
    head_dim 128.  Returns their rows for the kernels' line."""
    rows = [time_flash(dev, seed, name) for name in FLASH_SHAPES]
    print(json.dumps({"flash_attn": rows}), flush=True)
    return rows


# limits on each output's gap to the plain form, each a few times the
# largest of 3 seeds at both shapes (NVIDIA H100 80GB HBM3, 700 W).  Acs,
# the in-chunk cumsum, differs from the plain form's by the order of its
# f32 sums (read 6.8e-8 to 9.9e-8).  y and h_final are held to the plain
# forward fed the kernels' Acs (read 6.7e-6 to 2.3e-5, 6.0e-8 to 6.5e-8):
# against the plain form's own, a last-bit difference of Acs rounds some w
# or M entries to another bf16, and h_final read 6.0e-8 to 1.4e-4 over the
# seeds (printed, not held).  The gradients against the plain form's
# autograd: x 2.6e-3, dt 1.8e-3, la 1.5e-3, B 3.2e-3, C 3.1e-3, h0 3.2e-7
# at most
SSD_TOL = {"Acs": 5e-7, "y": 1e-4, "h_final": 3e-7, "x": 1e-2, "dt": 7e-3,
           "la": 6e-3, "B": 1e-2, "C": 1e-2, "h0": 1.5e-6}
HBM_BW = 3.35e12                   # H100 SXM data sheet, bytes/s
# (b, s, heads, state, chunk): zamba2-2.7b's Mamba2 layer at 17c's batch
# (4 x 2,048 tokens, 80 heads of 64) and granite-4.0-h-small's at the
# benchmark cell's (2 x 8,192 tokens, 128 heads of 64)
SSD_SHAPES = {"zamba2-2.7b": (LM_BATCH, LM_SEQ, 80, 64, 64),
              "granite-4.0-h-small": (2, 8192, 128, 128, 256)}


def time_ssd(dev, seed: int, name: str) -> dict:
    """Phase 20 at one shape: B14 through ``ssd_chunked``'s autograd
    Function against the plain form and its autograd, then the kernels'
    times beside their byte bound and the plain form's."""
    import torch
    from repro_torch.kernels import ssd
    from repro_torch.models import mamba
    b, s, h, n, chunk = SSD_SHAPES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    bf = torch.bfloat16
    x = randn(b, s, h, 64).to(bf)
    dt = torch.nn.functional.softplus(randn(b, s, h) - 4.6)
    ins = [x, dt, -8.0 * dt, randn(b, s, n).to(bf), randn(b, s, n).to(bf),
           randn(b, h, 64, n)]
    dy, dhT = randn(b, s, h, 64), randn(b, h, 64, n)

    def route(fn):
        xs = [t.clone().requires_grad_() for t in ins]
        y, hT = fn(*xs)
        torch.autograd.backward((y, hT), (dy, dhT))
        return [y.detach(), hT.detach()] + [t.grad for t in xs]
    n_f, n_b = ssd.ssd_fwd.launches, ssd.ssd_bwd.launches
    got = route(lambda *z: mamba._SSDKernel.apply(*z, chunk))
    again = route(lambda *z: mamba._SSDKernel.apply(*z, chunk))
    torch.cuda.synchronize()
    if (ssd.ssd_fwd.launches - n_f, ssd.ssd_bwd.launches - n_b) != (2, 2):
        raise SystemExit(f"phase 20 ({name}): launches not counted")
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise SystemExit(f"phase 20 ({name}): two calls differ")
    del again
    want = route(lambda *z: ssd.ssd_fwd_plain(*z, chunk)[:2])

    def gap(a, w):
        return float(torch.linalg.vector_norm((a - w).double())
                     / torch.linalg.vector_norm(w.double()))
    names = ("x", "dt", "la", "B", "C", "h0")
    gaps = {k: gap(a, w) for k, a, w in zip(names, got[2:], want[2:])}
    bad = [k for k, a, w in zip(names, got[2:], want[2:])
           if a.dtype != w.dtype or not bool(torch.isfinite(a).all())]
    del got, want
    with torch.no_grad():
        y, hT, states, Acs = ssd.ssd_fwd(*ins, chunk)
        p_y, p_hT, _states, p_Acs = ssd.ssd_fwd_plain(*ins, chunk)
        q_y, q_hT = ssd.ssd_fwd_plain(*ins, chunk, Acs=Acs)[:2]
    gaps.update(Acs=gap(Acs, p_Acs), y=gap(y, q_y), h_final=gap(hT, q_hT))
    own = {"y": gap(y, p_y), "h_final": gap(hT, p_hT)}
    del p_y, p_hT, _states, p_Acs, q_y, q_hT
    log(f"phase 20 ({name}): gaps to the plain form {gaps} (y and h_final "
        f"fed the kernels' Acs; against its own cumsum {own})")
    bad += [k for k in SSD_TOL if not gaps[k] <= SSD_TOL[k]]
    if bad:
        raise SystemExit(f"phase 20 ({name}): {bad} off the plain form "
                         f"(limits {SSD_TOL})")
    grads = ssd.ssd_bwd(x, dt, ins[3], ins[4], states, Acs, dy, dhT)
    fwd_bytes = sum(t.nbytes for t in (*ins, y, hT, states, Acs))
    bwd_bytes = sum(t.nbytes for t in (x, dt, ins[3], ins[4], states, Acs,
                                       dy, dhT, *grads))
    del grads
    fwd_ms = cuda_ms(lambda: ssd.ssd_fwd(*ins, chunk), 20, 2)
    bwd_ms = cuda_ms(lambda: ssd.ssd_bwd(x, dt, ins[3], ins[4], states,
                                         Acs, dy, dhT), 20, 2)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: ssd.ssd_fwd_plain(*ins, chunk), 3)
    plain_both_ms = cuda_ms(lambda: route(
        lambda *z: ssd.ssd_fwd_plain(*z, chunk)[:2]), 3)
    row = {"name": "ssd", "shape": name, "b_s_h_n_chunk": [b, s, h, n,
                                                           chunk],
           "ms": fwd_ms, "bwd_ms": bwd_ms,
           "bound_ms": fwd_bytes / HBM_BW * 1e3,
           "bwd_bound_ms": bwd_bytes / HBM_BW * 1e3, "bound_by": "bytes",
           "bytes": fwd_bytes, "bwd_bytes": bwd_bytes,
           "plain_ms": plain_ms, "plain_bwd_ms": plain_both_ms - plain_ms,
           "gaps": gaps, "gaps_own_cumsum": own}
    log(f"phase 20 ({name}): forward {fwd_ms:.4f} ms (bound "
        f"{row['bound_ms']:.4f}, plain {plain_ms:.3f}), backward "
        f"{bwd_ms:.4f} ms (bound {row['bwd_bound_ms']:.4f}, plain "
        f"{row['plain_bwd_ms']:.3f})")
    return row


def phase_ssd(dev, seed: int) -> list:
    """Phase 20: B14 at zamba2-2.7b's 17c shapes and granite-4.0-h-small's
    cell shape.  Returns their rows for the kernels' line."""
    import torch
    rows = []
    for name in SSD_SHAPES:
        rows.append(time_ssd(dev, seed, name))
        torch.cuda.empty_cache()
    print(json.dumps({"ssd": rows}), flush=True)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default="",
                        help="comma-separated phase names to run (default: "
                             "all; the kernels' line needs all)")
    argv = sys.argv[1:] if argv is None else list(argv)
    # phases 15's to 17's models fill the card: grow the allocator's
    # segments in place, so blocks freed by the phases before can be
    # reused
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if argv[:1] == ["--launcher-child"]:
        return launcher_child(argv[1:])
    if argv[:1] == ["--example-child"]:
        return example_child(argv[1:])
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"phase 1: card {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    lib_path, secs, build_log = build.build()
    build.library()
    log(f"phase 1: built {lib_path.relative_to(ROOT)} in {secs:.1f} s"
        + ("" if secs else " (already built)"))
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"phase 1:   {line.strip()}")
    phases = [
        ("2", lambda: (phase_kernels(dev, args.seed),
                       phase_full_width_b1_b4(dev, args.seed),
                       phase_csr_and_hazards(dev, args.seed),
                       phase_sketch_kernels(dev, args.seed),
                       phase_bf16_kernel(dev, args.seed))),
        ("3", lambda: phase_main(dev, args.seed)),
        ("4", lambda: phase_serve_and_stream(dev, *out["3"][:2], args.seed)),
        ("4 (sketch ops)", lambda: phase_sketch_ops(dev, out["3"][3],
                                                    args.seed)),
        ("5", lambda: phase_times(dev, *out["3"][:4], args.seed,
                                  out["4 (sketch ops)"])),
        ("6", lambda: phase_dense(dev, args.seed)),
        ("7", lambda: phase_dense_bf16(dev, out["6"])),
        ("7b", lambda: phase_dense_int8(dev, out["6"][1])),
        ("7c", lambda: phase_sparse_bf16(dev, args.seed, out["3"][5])),
        ("7d", lambda: phase_async_clean(dev, out["6"][1])),
        ("8", lambda: phase_extreme(dev, args.seed)),
        ("5 (extreme)", lambda: time_b1_extreme(dev, *out["8"][1:4])),
        ("9", lambda: phase_planned_extreme(dev, args.seed, out["8"][5])),
        ("9c", lambda: phase_planned_dense(dev, out["6"][1])),
        ("10", lambda: phase_serving(dev, args.seed)),
        ("10c", lambda: phase_observed(dev, args.seed)),
        ("11", lambda: phase_lm(dev, args.seed)),
        ("11g", lambda: phase_lm_serving(dev, args.seed, out["11"][2])),
        ("11h", lambda: phase_lm_launcher(dev, args.seed)),
        ("12", lambda: (phase_dp(dev, args.seed),
                        phase_dp_nccl(dev, args.seed),
                        phase_dp_fleet(dev, args.seed))),
        ("13", lambda: (phase_sharded(dev, args.seed),
                        phase_sharded_llama4(dev, args.seed),
                        phase_sharded_dense(
                            dev, out["6"][1] if "6" in out
                            else SoftmaxTask(dev, args.seed)))),
        ("14", lambda: phase_placement(dev, args.seed)),
        # 15 and 16 need most of the card: earlier phases' tensors go
        # first
        ("15", lambda: phase_a14b(dev, args.seed, release(out))),
        ("16", lambda: phase_a14b_part3(dev, args.seed, release(out))),
        ("17", lambda: phase_a14b_part4(dev, args.seed, release(out))),
        ("18", lambda: phase_slice17(dev, args.seed, release(out))),
        ("19", lambda: phase_flash(dev, args.seed)),
        ("20", lambda: phase_ssd(dev, args.seed)),
    ]
    if args.phases:
        keep = args.phases.split(",")
        phases = [(n, r) for n, r in phases if n in keep]
    out, peak = {}, 0
    for name, run in phases:
        t0 = time.perf_counter()
        out[name] = run()
        peak = max(peak, torch.cuda.max_memory_allocated())
        log(f"phase {name}: wall {time.perf_counter() - t0:.1f} s")
    if args.phases:
        log(f"phases {args.phases} passed; no kernels' line without all")
        return 0
    kernels = out["5"]
    extreme = out["8"][0]       # 8a's cs_rmsprop runs, both replicas
    planned, planned_dense = out["9"][0], out["9c"]     # 9a, 9c
    serving, observed = out["10"][0], out["10c"]        # 10a, 10c
    lm, lm_plan, lm_cli = out["11"][0], out["11"][1], out["11h"]  # 11a/f/h
    lm_b3 = {name: lm[name] + lm_plan[name] + lm_cli[name]
             for name in ("cs_ema_tiled", "bucket_csr")}
    flash_names = ("flash_attn_fwd", "flash_attn_bwd")
    lm_flash = {name: lm[name] + lm_plan[name] + lm_cli[name]
                for name in flash_names}
    # 12a-c's DP steps: the sparse, serve, extreme and LM dp_axis paths
    dp = {name: sum(part[name] for part in out["12"])
          for name in ("cs_update", "bucket_csr", "cs_ema_tiled")
          + flash_names}
    # 13a-c's sharded steps: the slabbed sparse step, the llama4 vocab
    # plan and the sharded plans' dense path
    (sh_a, slab_row), sh_b, sh_c = out["13"]
    sharded = {name: sh_a[name] + sh_b[name] + sh_c[name]
               for name in ("cs_update", "bucket_csr", "cs_ema_tiled")}
    # 14a-e: the launcher's sparse_embedding and --dp runs, the folded
    # restore's steps, the recovered run and the re-placed sharded runs
    placed = out["14"]
    # 15a-f: the launcher's extreme and serve-replay runs,
    # adam_rows_fused, the MoE model's training arms
    a14b, fused = out["15"]
    # 16a-e: the enc-dec and VLM training arms and launcher runs, and B3
    # at their tables
    part3, b3_tables = out["16"]
    # 17a-e: the rwkv6 and hybrid training arms and launcher runs, and B3
    # at their tables
    part4, b3_tables4 = out["17"]
    # 18a-d: the dry run's step on the card, breakdown, the sharded
    # monitors' runs and the examples
    slice17 = out["18"]
    launches = {"cs_adam_tiled": (out["3"][4]["cs_adam_tiled"]
                                  + placed["cs_adam_tiled"]
                                  + extreme["cs_adam_tiled"]
                                  + planned["cs_adam_tiled"]
                                  + serving["cs_adam_tiled"]
                                  + observed["cs_adam_tiled"]),
                "cs_adam_fused": out["4"]["cs_adam_fused"],
                "cs_ema_tiled": (out["6"][0]["cs_ema_tiled"]
                                 + planned_dense["cs_ema_tiled"]
                                 + lm_b3["cs_ema_tiled"]
                                 + dp["cs_ema_tiled"]
                                 + sharded["cs_ema_tiled"]
                                 + placed["cs_ema_tiled"]),
                "cs_ema_tiled_bf16": out["7"]["cs_ema_tiled_bf16"],
                # the main, extreme, planned, serving, observed and DP
                # paths' dedup sums and sketch writes, and the sketch
                # ops' update
                "cs_update": (out["3"][4]["cs_update"] + dp["cs_update"]
                              + sharded["cs_update"] + placed["cs_update"]
                              + extreme["cs_update"]
                              + planned["cs_update"]
                              + planned_dense["cs_update"]
                              + serving["cs_update"]
                              + observed["cs_update"]
                              + out["4 (sketch ops)"][4]["cs_update"]),
                # B1's CSR on the main, extreme, planned, serving and
                # observed paths, prev for B2, B5's CSR in the sketch ops,
                # and B3's cached dense-row CSRs
                "bucket_csr": (out["3"][4]["bucket_csr"] + dp["bucket_csr"]
                               + sharded["bucket_csr"]
                               + placed["bucket_csr"]
                               + extreme["bucket_csr"]
                               + planned["bucket_csr"]
                               + serving["bucket_csr"]
                               + observed["bucket_csr"]
                               + out["4"]["bucket_csr"]
                               + out["4 (sketch ops)"][4]["bucket_csr"]
                               + out["6"][0]["bucket_csr"]
                               + planned_dense["bucket_csr"]
                               + lm_b3["bucket_csr"]),
                # flash attention on the LM (11a, 11f, 11h), DP (12b) and
                # placement (14b) paths; the other paths' below
                **{name: lm_flash[name] + dp[name] + placed[name]
                   for name in flash_names}}
    for name in launches:
        launches[name] += (a14b.get(name, 0) + part3.get(name, 0)
                           + part4.get(name, 0) + slice17.get(name, 0))
    for row in kernels:
        row.setdefault("launches", launches.get(row["name"]))
        if row["name"] == "cs_adam_tiled":
            row["at_extreme_shapes"] = out["5 (extreme)"]
            row["at_planned_extreme_shapes"] = out["9"][1]
            row["at_serving_shapes"] = out["10"][1]
            row["launches_extreme_path"] = extreme["cs_adam_tiled"]
            row["launches_planned_extreme_path"] = planned["cs_adam_tiled"]
            row["launches_serving_path"] = serving["cs_adam_tiled"]
            row["launches_observed_path"] = observed["cs_adam_tiled"]
        if row["name"] in lm_b3:
            # the LM path (11a, 11f, 11h), in the total above as well
            row["launches_lm_path"] = lm_b3[row["name"]]
        if row["name"] in dp:
            # the DP paths (12a-c), in the total above as well
            row["launches_dp_path"] = dp[row["name"]]
        if row["name"] in sharded:
            # the sharded paths (13a-c), in the total above as well
            row["launches_sharded_path"] = sharded[row["name"]]
        if row["name"] == "cs_update":
            row["slab_mode"] = slab_row
        # the placement path (14a-e), in the total above as well
        row["launches_placement_path"] = placed.get(row["name"], 0)
        # the A14b path (15a-f), in the total above as well
        row["launches_a14b_path"] = a14b.get(row["name"], 0)
        # the A14b part 3 path (16a-e), in the total above as well
        row["launches_a14b_part3_path"] = part3.get(row["name"], 0)
        # the A14b part 4 path (17a-e), in the total above as well
        row["launches_a14b_part4_path"] = part4.get(row["name"], 0)
        # the slice 17 path (18a-d), in the total above as well
        row["launches_slice17_path"] = slice17.get(row["name"], 0)
        if row["name"] == "cs_ema_tiled":
            row["at_whisper_tables"] = b3_tables[ENCDEC_ARCH]
            row["at_internvl2_tables"] = b3_tables[VLM_ARCH]
            row["at_rwkv6_tables"] = b3_tables4[RWKV_ARCH]
            row["at_zamba2_tables"] = b3_tables4[HYBRID_ARCH]
        if row["name"] == "cs_adam_fused":
            row["adam_rows_fused_ms"] = fused["ms"]
            row["adam_rows_stream_ms"] = fused["stream_ms"]
    for row in out["19"]:
        # phase 19's own calls are not counted here: the launches of the
        # paths above, each path apart (forward, backward)
        row["launches"], row["bwd_launches"] = (launches[n]
                                                for n in flash_names)
        for path, counts in (("lm", lm_flash), ("dp", dp),
                             ("placement", placed), ("a14b", a14b),
                             ("a14b_part3", part3), ("a14b_part4", part4),
                             ("slice17", slice17)):
            row[f"launches_{path}_path"] = [counts.get(n, 0)
                                            for n in flash_names]
    kernels.extend(out["19"])
    ssd_names = ("ssd_fwd", "ssd_bwd")
    for row in out["20"]:
        # phase 20's own calls are not counted here: the launches of the
        # paths above (forward, backward), zamba2's in 17c-e alone
        row["launches"], row["bwd_launches"] = (
            sum(counts.get(n, 0) for counts in (a14b, part3, part4,
                                                 slice17))
            for n in ssd_names)
        row["launches_a14b_part4_path"] = [part4.get(n, 0)
                                           for n in ssd_names]
    kernels.extend(out["20"])
    log(f"peak device memory of the whole run {max(peak, out['8'][4])} B")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
