#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero before the result line):

  1. device   : the card's name and power limit (nvidia-smi), device count
  2. build    : nvcc every CUDA source for sm_90a, in parallel (timed as
                set-up)
  3. division : drift_depos and PhysicalDepoSet.from_mm on the card against
                the same float32 formulas evaluated by numpy on the host, bit
                for bit (the port divides where the reference divides, by a
                0-d tensor: torch on the card multiplies by the reciprocal of
                a Python float); a real allocation failure and a kernel
                wrapper's out-of-memory launch error classify as OOM
  4. kernels  : each kernel against its plain PyTorch version.
                Fused (rows 1-2) at full MicroBooNE width (2560 x 9592, 100k
                depos): dense and compact == the plain version bit for bit
                (the tolerance is printed), compact == dense bit for bit,
                two runs bit-identical, no dropped (depo, tile) entries, the
                launch order kernels == their plain version; again at a
                tile-edge config, with 32 x 128 tiles, for single depos
                straddling tile edges, and for 48 depos filling one tile's
                list at k_max = 48 (no multiple of the 32-entry chunk).
                Scatter-add (rows 5-6) on the unfused chain's fluctuated
                patches at the same configs, at 30 x 128 tiles (no list
                splits), at 72 x 40 patches, and at a list filling k_max =
                48 that runs split over 4 CTAs: dense, compact in place
                and compact blocks == their plain versions bit for bit, the
                in-place grid == the dense grid and == the placed blocks,
                two runs bit-identical, and within the parity tolerance
                of index_put_(accumulate=True); the same cases again on
                the bfloat16 patches of unfused_bf16 without fluctuation
                (the full-width case included), where each output also ==
                the float32 kernel on the widened patches bit for bit.
                Multi-plane fused (rows 3-4) at full width with 3 planes:
                == the plain version bit for bit, compact == dense bit for
                bit, and plane p == the one-plane kernel (row 1) on plane
                p's depos with fold_in(kf, p), bit for bit; entries per
                tile (max, median, p99) per plane
                Rasterize (row 8) at 100k depos (padded to 100 096), with
                fluctuation on and off: kernel == plain bit for bit, two
                runs bit-identical, zero padding
  5. main     : the launcher's event loop (launch counters reset just
                before and read just after each run): 4 full-width events
                with charge_grid_strategy=fused_pallas, then
                fused_pallas_compact (ADC equal between the two); one event
                of the default unfused strategy; 4 full-width three-plane
                events with fused_pallas_multiplane, then
                fused_pallas_multiplane_compact (ADC equal between the two,
                and equal to the per-plane loop of the one-plane kernel);
                2 full-width events of unfused with scatter_strategy=pallas,
                then pallas_compact (ADC equal between the two, launch
                counters equal to the events served, no placement of
                compact blocks: the kernel writes the grid); 4 full-width
                three-plane events with fused_pallas_multiplane and
                recon=True (deconvolve + hit_find; ADC equal to the
                sim-only run, one hit-scan launch per plane and event,
                stored and found hits per plane); unfused_bf16 at one and
                three planes, 2 events each without fluctuation and with
                scatter_strategy=pallas, then pallas_compact (every
                scatter-add launch on bfloat16 patches, ADC equal between
                the two), and 2 events with fluctuation on and pallas (the
                patches reach the kernel as float32); the library scatters
                twice with one key (unfused + xla, unfused_bf16 + xla,
                unfused + sort_segment, three-plane multiplane_xla): max
                |delta grid| and ADC mismatches, both 0 or the run fails;
                rasterize_depos at 100k depos with fluctuation on and off.
                Per plane:
                int16 ADC at the 900 baseline, finite signal, non-zero max
                dev; per-event time, depos/s, per-stage times, peak memory.
                Then the hit-scan kernel (row 7) against its plain version,
                bit for bit and run to run, on every plane's full-width
                deconvolved grid of recon event 0 (with the stored runs'
                lengths: max, median, p99) and on synthetic edge-case grids
                of 70 x 1000 and 70 x 1001 (runs across the kernel's load
                and step edges, a run as long as the wire, an 8th run
                starting in the last step) at thresholds 500 and 333.3
                and caps 8, 1 and 40 (more stored runs than lanes), and
                the plane with the most runs at cap 40
  6. stream   : the streaming launcher (stream_simulate, the batched
                executor) at full width, launch counters reset just before
                and read just after each stream: one plane fused_pallas, 8
                events 4 a batch; three planes fused_pallas_multiplane with
                recon, 8 events 4 a batch (hits); three planes
                fused_pallas_multiplane_compact, 10 events 6 a batch (18
                rows a batch: two fused launches; the last batch 4 events
                and 2 padding rows); 2 events 2 a batch each of unfused +
                pallas, fused_pallas_compact and unfused + pallas_compact.
                Every streamed row == run_events' event bit for bit (ADC,
                grid, signal, decon, hits), the fused kernel launched
                ceil(rows / 16) times a batch, and each fused stream's
                first batch (4, 12, 16 + 2 and 2 rows) run again and held
                bit for bit against the plain version of each launch on
                the same rows and seeds. Then the fault plan
                nan@1,oom@0 with a journal (survivors and the halved batch
                == the clean rows), a journalled stream stopped at batch 1
                (error@1) and resumed through the launcher's --resume (its
                digests == the clean stream's), check_finite (ADC == off;
                with validation off the sentinel trips on nan@1 alone), and
                events/s of the loop beside streams of 1 and 4 events a
                batch (and 4 without validation), one plane and three
                planes with recon, and each one's device busy share
                under torch.profiler with its top kernels
  7. tune     : the autotuner (repro_torch.tune) on a tuning cache of this
                run's own: resolve_config_with_decisions(tune=True,
                tune_explicit=True) at full width for one plane, then
                three (whose drift, scatter-add, hit-finding and induction
                transforms are cache hits), every board printed in us;
                every record's backend is "cuda", its device kind the
                card's and its timer host-paced CUDA events; every winner
                is available for its context; a second resolution is all
                cache hits with zero timer calls; one tuned event with
                recon through run_events and through stream_simulate (4
                rows a batch) dispatches every op to its decision (per
                plane kind for the transforms; calls into the registered
                strategies counted) and equals, bit for bit, the event of
                the config naming the same strategies explicitly (per plane
                kind where the kinds' winners differ) and the streamed row;
                rows 1-7 launched while tuning; events/s of the default
                and the tuned configs, one plane and three with recon, 8
                events 4 a batch, A B B A (printed, not checked). Every
                other phase runs on an empty cache of the run's own:
                today's strategies
  8. fit      : the calibration path (repro_torch.core.fit) at full width:
                the self-calibration contract, every fittable field's
                gradient, a central difference, a short fit and the fit
                launcher's gates; no kernel launched
  9. fig3 and pool : the per-depo fig3 baseline on the first 2 000 depos
                of a full-width event (after a warm-up) beside fig4
                (unfused + pallas) on the same depos and on all 100 000:
                ms, us a depo, depos/s from this one call; without
                fluctuation the fig3 grid == fig4's within the reference's
                fig3/fig4 rule. The standard normal pool on the card (its
                threefry bits == the CPU's, normals within NORMAL_ATOL);
                the scatter-add kernels (rows 5-6) on pool-fluctuated
                patches == their plain versions bit for bit; full-width
                pool events through the launcher loop, counters reset just
                before and read just after each: one plane with pallas,
                pallas_compact (== pallas bit for bit) and xla (within
                parity), with per-stage times; three planes with recon
                (row 7); unfused_bf16; and a pool stream of 4 events, 2 a
                batch, every row == run_events' bit for bit
 10. distributed : the distributed executor (repro_torch.core.distributed)
                on one NCCL group at world size 1 (a FileStore in a
                temporary directory, destroyed at the phase's end) at full
                width: one plane, psum_scatter, noise and fluctuation off,
                ADC against the reference test's card-side cyclic
                construction (rasterize, xla scatter, rfft2 x response at
                (W_pad, T), digitize) under the +-1 rule, the exact share
                printed; halo against psum_scatter on the same event (a
                ring of one); noise and fluctuation on, two runs bit for
                bit; three planes with recon, stacked == loop bit for bit,
                the hit scan (row 7) launched once a plane and event
                (counters reset just before and read just after each run),
                each plane's hits == the plain scan's on the gathered decon
                with the padding wires zeroed, bit for bit; launch.fit
                --grad-smoke --devices 1 passes; launch.distributed with
                more ranks than cards raises; the distributed event's ms
                beside run_events at the same config (printed, not checked)
 11. audit    : the static-analysis gate's programs on the card
                (repro_torch.analysis.audit): single_fused (one plane) and
                recon_kernels (three planes) at full width, two calls
                each, a stream of 4 events 4 a batch (fused_pallas), and
                distributed_psum on one NCCL rank, two calls, each under
                torch.cuda.set_sync_debug_mode("warn") and a Census: every
                wait the card reports sits at a census site with as many
                reads of card tensors there; launches == the committed
                AUDIT_torch_contracts.json's kernels (the stream: ceil(rows
                / 16) fused launches a batch), collectives too; the two
                calls have one census; host reads only at
                KNOWN_HOST_SYNCS; float64 only at ALLOWED_F64, its bytes
                an event printed per site; each host-read site printed as
                "wait" or "host tensor"; the phase's wall time
 12. serve    : LM serving (repro_torch.launch.serve.run) of gemma2-2b at
                full width (26 layers, d_model 2304, vocab 256 000, bfloat16
                activations, float32 parameters drawn on the card from
                prng.key(0)): (A) 8 requests, 4 slots, prompt 128, 32 new
                tokens, max_len 256, twice; (B) one request, prompt 4 608,
                16 new tokens, max_len 4 672 (the 4 096-token window masks
                its first 512 positions). Checks: blockwise flash ==
                direct attention at (B)'s layer-0 q/k/v; at every step of
                (A)'s first wave and of (B), decode_step's logits ==
                Model.forward's last position over the tokens fed so far
                (max |delta logit| printed); two runs of (A) bit-identical
                (tokens and final logits); the qwen3 smoke config in
                float32 gives the CPU's tokens, logits within 1e-4. Prints
                init seconds, parameter bytes, peak memory, prefill ms,
                decode ms a step (median), tokens/s and decode's bytes
                bound beside the card's name and power limit; the busy
                share of one wave under torch.profiler, its top ops
 13. families : ROADMAP item 17(b)'s LM families at full width, one model
                on the card at a time, float32 parameters drawn on the card
                from prng.key(0), bfloat16 activations: deepseek-moe-16b
                through launch.serve.run, (A) twice at capacity factor 1.25
                (each prefill's dropped (token, expert) pairs printed) and
                (A') at 64 / 6, where nothing drops; deepseek-v2's widths
                at 2 layers (a dense MLA layer and an MLA + 160-expert
                layer; 60 layers do not fit one card), (A') with 2 requests;
                mamba2-780m and recurrentgemma-2b, (A) and (B) one request
                of 3 840 (15 SSD chunks) / 2 560 (the 2 048 window masks
                its first 512 positions) + 16; seamless-m4t-large-v2
                through Model.prefill / decode_step (the engine refuses
                enc-dec, as the reference's fails on it), 2 sequences of
                1 024 encoder frames, a 64-token prompt and 16 greedy
                steps. Checks: at every step, decode_step's logits ==
                Model.forward's at that position within
                lm_bf16_atol_frac(L) (deepseek-moe on A', and deepseek-v2,
                the forward replaying the cache path's experts, each of
                its own choices that differs a near-tie; recurrentgemma;
                seamless); mamba2's forward padded at the end to its 256
                chunk, within lm_atol_frac(48) in float32 activations,
                the bfloat16 distance printed (it grows with depth past
                the square-root rule, the reference's alike); two runs of deepseek-moe (A) bit-identical (tokens, final
                logits, drops); the five smoke configs in float32 on the
                card and the CPU (logits within 1e-4, the untied deepseek
                tokens equal); 0 waits for the card in one decode_step of
                each family. Prints each model's init seconds, parameter
                bytes, peak memory, prefill ms, decode ms a step (median,
                range), tokens/s and decode bytes bounds (deepseek-moe:
                every parameter, as its dispatch reads every expert, and
                the active ones) beside the card's name and power limit,
                one MoE wave's busy share and top ops, the phase's wall
 14. timing   : each kernel's wrapper (median of 5 rounds of 20 calls
                timed with CUDA events as the host enqueues them, the
                method of every version of this script, which reads the
                host's pace where a call is shorter than its enqueueing,
                as on the main path; beside it, as ms_card, the same calls
                enqueued while the card spins on a kernel that outlasts the
                enqueueing, so the events read the card's time alone, and
                the host's enqueue time per call) and its plain version
                (3 calls; the three-plane plain
                versions 2 calls, hit scan and rasterize 1 call) timed with
                CUDA events at the main path's shapes (hit scan: one plane;
                each plane's time is printed too; compact scatter-add: the
                grid written in place, as the main path calls it),
                beside the least time the card could take (bytes or
                operations bound, from this run's inputs; for the fused
                kernels the pixels with nonzero weights, and beside it the
                bound over every in-support pixel as earlier runs had it)
                and, for the
                scatter-add kernels (float32 and bfloat16 patches, each its
                own row), the one PyTorch call that computes the same
                function (index_put_ with accumulate=True); for the
                fused kernels also the SASS instructions per pixel of the
                pixel loop (cuobjdump) and the issue-rate floor they imply
 15. train    : LM training (ROADMAP item 17(c)) of gemma2-2b at full
                width, nothing cut but the batch and the steps: float32
                parameters drawn on the card from prng.key(0), bfloat16
                activations, remat "selective", sequence 4 096
                (SHAPES["train_4k"]), a global batch of 8 in 4 microbatches
                of 2 (train_4k has 256), AdamW at lr TRAIN_LR with 2
                warmup steps over 6 cosine steps, 6 steps of
                DataPipeline(seed=0) through make_train_step, the loss read
                once a step. Prints each step's loss, forward + backward
                ms and update ms (CUDA events), step ms (host clock, ending
                in the loss read) and tokens/s; the peak memory; one
                step's busy share under torch.profiler with its top ops;
                the waits of one step by site (torch's sync debug mode;
                only the loss read expected); the step against 6 N D
                FLOPs at BF16_DENSE_PEAK. Checks: every loss finite, the
                mean of the last two below the first. Then at gemma2-2b's
                smoke config: 4 steps (2 microbatches) on the card and on
                the CPU from the same float32 parameters, the losses within
                parity.LM_GRAD_ATOL_FRAC relative, every parameter within
                it of its leaf's max|CPU value|; an unbroken 10-step Trainer.run == 8 steps, a checkpoint at 8
                and a resumed run to 10, the last losses and every
                parameter bit for bit; remat none, full and selective give
                the same loss and gradients bit for bit. No kernel
                launches; the phase's wall time
 16. parallel : the parallel layer (ROADMAP item 17(d)) on one NCCL + gloo
                group of one rank. (a) the train phase's gemma2-2b
                configuration, PAR_STEPS steps each of build_train's
                sharded step on a (1, 1) mesh and its zero1=True step,
                each from prng.key(0) with one full-width training state
                on the card at a time, against the train phase's first
                PAR_STEPS plain steps (their losses and a host copy of the
                parameters after them, TRAIN_REFERENCE): the losses bit
                for bit, the parameters bit for bit (or within
                parity.LM_GRAD_ATOL_FRAC of their leaf's max); each run's
                step ms (host clock) and peak memory, the sharded step's
                busy share (one step under torch.profiler, CUDA activity;
                the plain step's is the train phase's), and the parallel
                layer's dispatch (gathered calls and their host
                time). (b) the compressed step (int8 error
                feedback, a pod group of one) at batch PAR_DP_BATCH beside
                the exact step: its loss drift, a reading. (c) at
                gemma2-2b's smoke config in float32: the sharded step on
                the card against the CPU (4 steps, parity.LM_GRAD_ATOL_FRAC),
                the compressed step against the exact one (PAR_DP_STEPS
                steps, the reference test's drift and gap bounds),
                quantize_int8 card == CPU bit for bit, pipeline_apply on
                one stage == the sequential loop bit for bit, and the
                unsharded Trainer's checkpoint restored onto the (1, 1)
                mesh bit for bit. No kernel launches; the phase's wall time
 17. moe train : whole-batch MoE routing and a loss mask under the
                sharded step (ROADMAP item 21) on one NCCL + gloo group of
                one rank. deepseek-moe-16b at full width cut in depth to
                MOE_TRAIN_LAYERS layers (the dense layer 0 and two MoE
                layers), capacity factor 1.25, train_4k's 4 096 positions
                at batch MOE_TRAIN_BATCH in MOE_TRAIN_MICRO microbatches,
                each batch with a loss mask whose rows keep between a
                fifth and all of their tokens: MOE_TRAIN_STEPS steps of
                the plain make_train_step, then of build_train's step on
                a (1, 1) mesh (its batches placed by shard_batch for its
                microbatches), each from prng.key(0). Checks: every loss
                finite; the sharded step's losses, dropped pairs and every
                parameter == the plain step's bit for bit. Prints each
                run's losses, step ms (host clock), the pairs dropped in
                each microbatch and the peak memory, beside the card's
                name and power limit; the phase's wall time. No kernel
                launches
 18. serve mesh : serving under a mesh (ROADMAP item 17(e)) on one NCCL
                + gloo group of one rank, a (1, 1) mesh. Traffic (C):
                gemma2-2b at full width (float32 parameters drawn on the
                card from prng.key(0), bfloat16 activations), 4 slots,
                each a 4 608-token prompt (numpy seed 0), then 16 greedy
                tokens, into 32 768-slot caches (decode_32k's length, its
                batch cut from 128 to 4 to fit the card): first through
                the plain Model.prefill / decode_step (the prefill's
                logits kept on the host, its caches freed), then through
                launch.specs.build_prefill / build_decode with the
                parameters placed by model.specs and each rank's blocks
                of the caches (parallel.kvcache.init_blocks). Checks:
                every step's logits and every token == the plain path's
                bit for bit; one decode step waits 0 times for the card;
                each family's smoke config (dense, vlm, moe, MLA, ssm,
                hybrid, enc-dec) through the two builders in float32 on
                the card and on the CPU from the same parameters, tokens
                equal and logits within SERVE_CPU_ATOL. Prints the
                prefill ms, decode ms a step (median and spread of 15),
                tokens/s, decode's bytes bound (float32 parameters and the
                caches at PEAK_BYTES_S), the peak memory above what
                earlier phases hold and the cache bytes each rank holds,
                beside the card's name and power limit; the phase's wall
                time. No kernel launches
 19. dry run : the dry run (launch.dryrun, launch.op_cost; ROADMAP item
                17(f)) on one NCCL + gloo group of one rank, a (1, 1)
                mesh. For two steps, the train phase's gemma2-2b step
                (batch TRAIN_BATCH of train_4k's 4 096 positions in
                TRAIN_MICRO microbatches, AdamW) and traffic (C)'s decode
                step (4 slots of 32 768-slot caches, at position 4 608),
                then the moe train phase's step on its first batch:
                op_cost predicts the step on meta tensors, then the step
                runs on the card from prng.key(0) with only its arguments
                resident. Checks: FlopCounterMode's count on the card ==
                the prediction exactly; the predicted argument + temp bytes
                within DRY_PEAK_RTOL of max_memory_allocated (after
                reset_peak_memory_stats, above what was held before the
                arguments), both printed with their ratio. Then
                DRY_CELLS, four production cells on a fake world of 256
                and 512 ranks, one subprocess a cell, all started
                together, none seeing the card (CUDA_VISIBLE_DEVICES
                empty): each ok, its per-rank
                numbers printed, qwen3-32b's train_4k cell, whose
                products split over ``model``, at replicated compute 1,
                and its prefill_32k cell at most SPLIT_FLOPS_MAX.
                No kernel launches; the phase's wall time
 20. model split : the train step's products split over ``model``
                (ROADMAP item 22(a)), in a subprocess that sees the card.
                SPLIT_ARCH (qwen3-32b) at full width cut to SPLIT_LAYERS
                layers, train_4k's 4 096 positions at batch SPLIT_BATCH:
                build_train's step as rank 0 of a SPLIT_MESH (1, 16) mesh
                on a fake world of 16 ranks (launch.mesh.fake_world: the
                collectives move nothing, so the values are not checked
                here; the CPU tests check them on gloo ranks), only rank
                0's blocks resident, then the plain one-rank step of the
                same cut (reckoned at SPLIT_BYTES_A_PARAM bytes a
                parameter plus its activations), each predicted by
                op_cost on meta tensors and run on the card under
                FlopCounterMode, then once more timed (host clock, after
                that warm-up step). Checks: each step's FLOPs == the
                prediction exactly, each peak within DRY_PEAK_RTOL of the
                predicted argument + temp bytes, and the rank's FLOPs
                between 1 / 16 and SPLIT_FLOPS_MAX / 16 of the plain
                step's. Prints both steps' ms, FLOPs, peaks and their
                ratios beside the card's name and power limit. No kernel
                launches; the phase's wall time
 21. serve split : the serving builders' products split over ``model``
                (ROADMAP item 22(b)), in a subprocess that sees the card,
                built as the model split phase is. SPLIT_ARCH at full
                width cut to SPLIT_LAYERS layers: build_prefill on
                prefill_32k's 32 768 positions at batch
                SERVE_SPLIT_PREFILL_BATCH, and build_decode's step on
                decode_32k's 32 768-slot caches at batch
                SERVE_SPLIT_DECODE_BATCH at position SERVE_SPLIT_INDEX,
                each as rank 0 of the SPLIT_MESH (1, 16) mesh on a fake
                world of 16 ranks (the collectives move nothing: values
                are checked on gloo ranks by the CPU tests), only rank
                0's blocks resident; beside each the plain one-rank
                serving step of the same cut (Model.prefill /
                decode_step), the plain prefill's bytes reckoned first
                (float32 parameters, bfloat16 casts, the blockwise
                attention's scores, the logits). Each step is predicted
                by op_cost on meta tensors, run on the card under
                FlopCounterMode, then once more timed (host clock, after
                that warm-up step). Checks, for each of the two steps:
                the FLOPs == the prediction exactly, the peak within
                DRY_PEAK_RTOL of the predicted argument + temp bytes, the
                rank's FLOPs between 1 / 16 and SPLIT_FLOPS_MAX / 16 of
                the plain step's. Prints each step's ms, FLOPs and peak,
                their ratios and the rank's logits' shape (a sequence
                block in the prefill) beside the card's name and power
                limit. No kernel launches; the phase's wall time
 22. moe split : the MoE family's products split over ``model`` (ROADMAP
                item 22(c): routed experts, shared-expert columns, MLA
                heads), in a subprocess that sees the card, built as the
                model and serve split phases are. MOE_SPLIT_TRAIN_ARCH
                (deepseek-moe-16b) at full width cut to MOE_SPLIT_LAYERS
                layers (the dense layer and one MoE layer): build_train's
                step on train_4k's 4 096 positions at batch SPLIT_BATCH
                as rank 0 of SPLIT_MESH (1, 16) on a fake world of 16
                (4 of the 64 experts a rank), beside the plain one-rank
                step. MOE_SPLIT_SERVE_ARCH (deepseek-v2-236b, MLA) cut
                the same way: build_prefill on prefill_32k's 32 768
                positions at batch 1 and build_decode's step on
                decode_32k's 32 768-slot caches at batch 8 at position
                SERVE_SPLIT_INDEX, as rank 0 of SPLIT_MESH (8 of the 128
                heads, 10 of the 160 experts a rank), beside the plain
                decode step. Its plain train step is not run: about
                22 GB of float32 parameters, times four with their
                gradient and AdamW's moments, exceed the card. Nor is
                its plain prefill: op_cost predicts about 100 GiB of
                arguments + temp (the blockwise attention's float32
                scores of 128 heads, 16 GiB a kv block, held several
                times), which the phase checks exceeds the card, and its
                FLOPs are op_cost's (equal to FlopCounterMode's in every
                step run here). Checks, for each step run: FLOPs == the
                prediction exactly, the peak within DRY_PEAK_RTOL of the
                predicted argument + temp bytes; and each rank's FLOPs
                between 1 / 16 and SPLIT_FLOPS_MAX / 16 of its plain
                step's. Prints each step's ms, FLOPs and peak beside the
                card's name and power limit. No kernel launches; the
                phase's wall time
 23. recurrent split : SSD heads, RG-LRU channels and the audio enc-dec
                split over ``model`` (ROADMAP item 22(d)), in a
                subprocess that sees the card, built as the model, serve
                and moe split phases are, after the card libraries'
                workspaces are allocated (``warm_workspaces``: they are
                held before every step, as op_cost's prediction leaves
                them out). RECURRENT_SPLIT: mamba2-780m at full width cut
                to 2 layers, build_train's step on train_4k's 4 096
                positions at batch SPLIT_BATCH and build_prefill /
                build_decode's steps at the serve split phase's shapes;
                recurrentgemma-2b cut to 3 layers (one recurrent,
                recurrent, attention group), its prefill and decode
                steps; seamless-m4t-large-v2 cut to 2 encoder and 2
                decoder layers, its train step. Each as rank 0 of
                SPLIT_MESH (1, 16) on a fake world of 16 beside the plain
                one-rank step. Checks, for each step: FLOPs == the
                prediction exactly, the peak within DRY_PEAK_RTOL of the
                predicted argument + temp bytes; the rank's FLOPs between
                1 / 16 and SPLIT_FLOPS_MAX / 16 of its plain step's, but
                recurrentgemma-2b's, whose 10 attention heads 16 ranks do
                not divide: every rank computes its attention layer whole,
                so its bound over 16 is ``split_bound``: 16 times that
                layer's share of the plain step's FLOPs (op_cost's count
                on meta tensors, ``whole_attention_flops``) plus
                SPLIT_FLOPS_MAX times the rest (x16 3.8819 for the prefill
                and 1.6753 for the decode step, against 3.6765 and 1.2504
                predicted). Prints each step's ms, FLOPs and peak beside
                the card's name and power limit. No kernel launches; the
                phase's wall time
 24. summary  : one JSON line {"kernels": [...]} (with each kernel's
                launches over the clean streams, stream_launches, while
                tuning, tune_launches, over the pool events and stream,
                pool_launches, and over the distributed recon runs,
                dist_launches)
 25. result   : last line {"ok": true, "device": {...}}

The on-card checks live here rather than in pytest because the machine with
the card has no JAX, which the repository's test configuration imports.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): device memory bytes/s and float32
#: operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
#: operations per in-support pixel of the fused kernel: 2 mul (q*ww*wt);
#: 4 fmix32 hashes x 8 integer ops; 4 counter ops; 7 for the two uniforms;
#: 7 for Box-Muller (max, log, mul, sqrt, mul, cos, mul); 10 for the
#: binomial step; 1 accumulate. Transcendentals count as one operation,
#: so the bound stays a lower bound.
OPS_PER_PIXEL = 2 + 32 + 4 + 7 + 7 + 10 + 1
#: operations per row/column weight (two erf and their arguments)
OPS_PER_AXIS = 10
#: operations per (depo, tile) entry for its stream seed (2 mul, xor,
#: fmix32, add)
OPS_PER_ENTRY = 12
#: operations per in-support pixel of the rasterize kernel with
#: fluctuation: 2 mul (q*ww*wt); max, log, mul, sqrt, mul, cos, mul (the
#: normal); max, div, max, min (p); sub, mul, max (var); sqrt, fma, max
OPS_PER_RASTER_PIXEL = 2 + 7 + 4 + 3 + 3
#: operations per hit-scan sample (compare, two selects, mul, two adds,
#: max, the run bookkeeping)
OPS_PER_HIT_SAMPLE = 10
EVENTS = 4
#: full-width single-plane events per scatter-add strategy
SCATTER_EVENTS = 2
PLANES = 3
STRATEGIES = ("fused_pallas", "fused_pallas_compact")
MULTI_STRATEGIES = ("fused_pallas_multiplane",
                    "fused_pallas_multiplane_compact")
SCATTER_STRATEGIES = ("pallas", "pallas_compact")
#: one depo per case, straddling an interior edge of the 64x256 tiles of a
#: 96x768 grid or clipped at the detector edge
ONE_DEPO_CASES = (("straddle wire edge", (63.7, 100.2, 1.1, 1.4, 4321.0)),
                  ("straddle tick edge", (30.0, 255.4, 1.1, 1.4, 4321.0)),
                  ("straddle corner", (63.7, 255.4, 1.1, 1.4, 4321.0)),
                  ("detector edge", (0.4, 2.0, 0.8, 1.0, 999.0)))


#: synthetic hit-scan grids: 70 wires (not a multiple of the kernel's 4
#: wires per CTA) x 1000 and x 1001 ticks (1001: no multiple of 4, of the
#: 32-tick load or of the 512-tick step), the scanner's edge cases, at two
#: thresholds (333.3 is not a float32: both sides round it the same way)
#: and three per-wire capacities (40: more stored runs than a warp has
#: lanes, so a lane walks runs l and l + 32)
HIT_CASE_WIRES = 70
HIT_CASE_TICKS = (1000, 1001)
HIT_THRESHOLD = 500.0
HIT_THRESHOLDS = (HIT_THRESHOLD, 333.3)
HIT_CAPS = (8, 1, 40)
#: the hit-scan kernel's load width in ticks (one per lane of a warp)
HIT_LOAD = 32


#: depos of the case whose list fills k_max = FULL_LIST, no multiple of the
#: kernel's 32-entry chunk; (wire, tick, sigma_w, sigma_t, charge) drawn
#: uniformly between these, inside tile (0, 0) of 64 x 256 tiles
FULL_LIST = 48
FULL_LIST_LOW = (4.0, 12.0, 0.6, 0.8, 500.0)
FULL_LIST_HIGH = (56.0, 240.0, 2.5, 3.5, 8000.0)


#: (module, function) of the placement of compact blocks into the grid and
#: of the gathering of blocks from it, which the card's compact scatter-add
#: path does not call
PLACEMENT = (("repro_torch.kernels.tiles", "scatter_tiles_to_grid"),
             ("repro_torch.kernels.scatter_add.kernel",
              "scatter_tiles_to_grid"),
             ("repro_torch.kernels.scatter_add.kernel", "tiles_of_grid"))


class PhaseError(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


@contextlib.contextmanager
def count_calls(targets):
    """Count the calls of each (module, function) of ``targets`` inside the
    block: yields the list of counts, one per target."""
    import importlib

    counts = [0] * len(targets)
    saved = []
    for i, (module, fn) in enumerate(targets):
        mod = importlib.import_module(module)
        orig = getattr(mod, fn)

        def counted(*args, _i=i, _orig=orig, **kwargs):
            counts[_i] += 1
            return _orig(*args, **kwargs)

        saved.append((mod, fn, orig))
        setattr(mod, fn, counted)
    try:
        yield counts
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


@contextlib.contextmanager
def recorded_calls(module: str, names):
    """Record the (name, args, kwargs) of every call of the functions
    ``names`` of ``module`` inside the block (they still run): yields the
    list."""
    import importlib

    mod = importlib.import_module(module)
    calls = []
    saved = {name: getattr(mod, name) for name in names}

    def recording(name, orig):
        def call(*args, **kwargs):
            calls.append((name, args, kwargs))
            return orig(*args, **kwargs)
        return call

    for name, orig in saved.items():
        setattr(mod, name, recording(name, orig))
    try:
        yield calls
    finally:
        for name, orig in saved.items():
            setattr(mod, name, orig)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: spin-kernel cycles per millisecond at 2 GHz, above the H100's top SM
#: clock, so a spin of n ms worth lasts at least n ms
SPIN_CYCLES_PER_MS = 2_000_000


def primed_time(fn, iters: int = 20, attempts: int = 3):
    """(ms per call on the card, ms per call on the host): ``iters`` calls
    enqueued while the card still spins on a kernel that outlasts their
    enqueueing, so CUDA events around them read the card's time alone, not
    the host's pace. The host's pace varies on a shared machine (a pause of
    a few ms between two calls is common), so the garbage collector is off
    while the calls are enqueued, and an attempt whose enqueueing outlasted
    its spin is discarded and made again with a spin three times the
    longest enqueueing seen. Raises if every attempt's host took longer than
    its spin."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    gc_was_on = gc.isenabled()
    try:
        for _ in range(attempts):
            spun, start, end = (torch.cuda.Event(enable_timing=True)
                                for _ in range(3))
            spun.record()
            torch.cuda._sleep(int((3.0 * host_ms + 2.0) * SPIN_CYCLES_PER_MS))
            start.record()
            gc.disable()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            if gc_was_on:
                gc.enable()
            end.record()
            end.synchronize()
            spin_ms = spun.elapsed_time(start)
            if enqueue_ms < spin_ms:
                return start.elapsed_time(end) / iters, enqueue_ms / iters
            print(f"primed timing: the host took {enqueue_ms:.3f} ms to "
                  f"enqueue, longer than the {spin_ms:.3f} ms spin; "
                  f"measuring again with a longer spin", flush=True)
            host_ms = max(host_ms, enqueue_ms)
    finally:
        if gc_was_on:
            gc.enable()
    check(False, f"primed timing: in each of {attempts} attempts the host "
          f"took longer to enqueue than the spin (last {enqueue_ms:.3f} ms "
          f"against {spin_ms:.3f} ms)")


def wrapper_ms(fn):
    """(median, sorted rounds) of 5 rounds of 20 calls, ms per call, timed
    with CUDA events while the host enqueues them (the method of every
    version of this script, so rows compare across versions: a call shorter
    than its enqueueing reads the host's pace, as on the main path)."""
    rounds = sorted(cuda_time(fn, iters=20, warmup=2) for _ in range(5))
    return statistics.median(rounds), rounds


def card_ms(fn) -> float:
    """Median of 5 rounds of 20 calls, ms per call on the card alone
    (primed: the host's enqueueing does not pace the calls)."""
    fn()
    fn()
    return statistics.median(primed_time(fn)[0] for _ in range(5))


def bound_of(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def list_work(ids, k_max: int, w0, t0, pw: int, pt: int, tiles_t: int,
              tw: int, tt: int):
    """(entries, in-tile patch pixels, in-tile patch rows + columns) of the
    filled entries of dense per-tile lists: the work their data needs."""
    import torch

    pos = torch.nonzero(ids >= 0, as_tuple=True)[0]
    tile = pos // k_max
    d = ids[pos].long()
    w0, t0 = w0.long()[d], t0.long()[d]
    tw0 = (tile // tiles_t) * tw
    tt0 = (tile % tiles_t) * tt
    nr = (torch.minimum(w0 + pw, tw0 + tw)
          - torch.maximum(w0, tw0)).clamp_min(0)
    nc = (torch.minimum(t0 + pt, tt0 + tt)
          - torch.maximum(t0, tt0)).clamp_min(0)
    return int(pos.numel()), int((nr * nc).sum()), int((nr + nc).sum())


def length_stats(ids, k_max: int) -> str:
    """Entries per slot of k_max-long lists (filled from rank 0): max,
    median and p99 over all slots, and how many hold any."""
    import torch

    n = (ids.view(-1, k_max) >= 0).sum(1).to(torch.float32)
    return (f"max {int(n.max())}, median {float(n.median()):g}, p99 "
            f"{float(torch.quantile(n, 0.99)):g} over {n.numel()} tiles "
            f"({int((n > 0).sum())} occupied)")


def evaluated_pixels(case) -> int:
    """In-support pixels the fused kernel evaluates on ``case``'s dense
    lists: each entry's support trimmed to the span of its nonzero row and
    column weights (the kernel skips pixels whose mean is exactly 0)."""
    import torch

    from repro_torch.core.rasterize import SQRT2
    from repro_torch.kernels.fused_sim.ref import _axis

    wire, tick, sigma_w, sigma_t, charge, w0, t0 = case.params
    pos = torch.nonzero(case.ids >= 0, as_tuple=True)[0]
    tile = pos // case.k_max
    d = case.ids[pos].long()

    def span(origin, tile0, extent, tile_extent, center, sigma):
        idx = torch.arange(extent, device=pos.device)
        edges = origin.long()[d][:, None] + idx[None, :]
        inside = (edges >= tile0[:, None]) & (edges < (tile0
                                                       + tile_extent)[:, None])
        w = _axis(edges.to(torch.float32), center[d][:, None],
                  (sigma[d] * SQRT2)[:, None])
        nz = inside & (w != 0)
        first = torch.where(nz, idx, extent).min(1).values
        last = torch.where(nz, idx, -1).max(1).values
        return (last - first + 1).clamp_min(0)

    tw0 = (tile // case.tiles_t) * case.tw
    tt0 = (tile % case.tiles_t) * case.tt
    rows = span(w0, tw0, case.cfg.patch_wires, case.tw, wire, sigma_w)
    cols = span(t0, tt0, case.cfg.patch_ticks, case.tt, tick, sigma_t)
    return int((rows * cols).sum())


def check_division(dev) -> bool:
    """drift_depos on the card against its float32 formulas evaluated by
    numpy on the host, bit for bit. sigma_w divides by the wire pitch and
    sigma_t by drift speed x tick, neither a power of two, so a division
    turned into a multiplication by the reciprocal shows; the square roots
    come from the card (torch.sqrt of the same products), so only the
    division, the products and the sums are held against the host. The
    same for ``PhysicalDepoSet.from_mm``'s divisions by the drift speed
    and the wire pitch. Prints the mismatches; True when none."""
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.core import prng
    from repro_torch.core.depo import generate_physical_depos
    from repro_torch.core.drift import PhysicalDepoSet, drift_depos

    cfg = get_config("lartpc-uboone")
    pd = generate_physical_depos(prng.key(3), cfg, device=dev)
    got = drift_depos(pd, cfg)
    roots = [torch.sqrt(2.0 * d * pd.x).cpu().numpy()
             for d in (cfg.diffusion_long, cfg.diffusion_tran)]
    torch.cuda.synchronize()
    f32 = np.float32

    def sigma(root, metric, floor, patch):
        return np.clip(root / f32(metric) * f32(cfg.diffusion_scale)
                       + f32(floor), f32(min(0.3, floor)),
                       f32((patch / 2 - 1) / cfg.nsigma))

    want = {
        "tick": (pd.t.cpu().numpy() + pd.x.cpu().numpy())
        / f32(cfg.tick_us),
        "sigma_t": sigma(roots[0], cfg.drift_speed_mm_us * cfg.tick_us,
                         cfg.sigma_t_floor, cfg.patch_ticks),
        "sigma_w": sigma(roots[1], cfg.wire_pitch_mm, cfg.sigma_w_floor,
                         cfg.patch_wires)}
    bad = {name: int((getattr(got, name).cpu().numpy() != w).sum())
           for name, w in want.items()}
    print(f"division: drift_depos of {pd.n} depos on the card vs numpy "
          f"float32 on the host, values that differ: {bad}", flush=True)
    # PhysicalDepoSet.from_mm divides by the drift speed and the pitch
    rng = np.random.default_rng(5)
    mm = [rng.uniform(0.0, 8000.0, pd.n).astype(f32) for _ in range(5)]
    ingested = PhysicalDepoSet.from_mm(*mm, cfg, device=dev)
    ingest_bad = {
        "x": int((ingested.x.cpu().numpy()
                  != mm[0] / f32(cfg.drift_speed_mm_us)).sum()),
        "y": int((ingested.y.cpu().numpy()
                  != mm[1] / f32(cfg.wire_pitch_mm)).sum())}
    print(f"division: PhysicalDepoSet.from_mm of {pd.n} depos on the card "
          f"vs numpy float32 on the host, values that differ: {ingest_bad}",
          flush=True)
    return not any(bad.values()) and not any(ingest_bad.values())


def sass_item_instructions():
    """SASS instructions per pixel on the fast path of the dense fused
    kernel's pixel loop, from ``cuobjdump -sass`` of the built library: the
    innermost loop holding the square roots (MUFU.RSQ), less the blocks a
    forward branch skips that hold only a slow path (a CALL, local memory
    or float64: cosf's large-argument reduction, the division's and sqrt's
    special cases), over the pixels one pass computes (kItems). Returns
    (per pixel, loop instructions, kItems) or None without cuobjdump."""
    import re

    from repro_torch import kernels

    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    text = subprocess.run([str(tool), "-sass",
                           str(kernels.library_path("fused_sim"))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", text)[1:]
                if "fused_sim_kernelILb0E" in f.split("\n", 1)[0])
    insts = [(int(a, 16), op.strip()) for a, op in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    branch = re.compile(r"\bBRA\S*\s+(?:[^,;]*,\s*)?0x([0-9a-f]+)")
    targets = [(a, int(m.group(1), 16), op) for a, op in insts
               for m in [branch.search(op)] if m]
    rsq = [a for a, op in insts if "MUFU.RSQ" in op]
    lo, hi = min(((t, a) for a, t, _ in targets if t < a
                  and any(t <= x <= a for x in rsq)),
                 key=lambda loop: loop[1] - loop[0])
    skipped = set()
    for a, t, op in targets:
        if op.startswith("@") and lo <= a < t <= hi:
            block = [o for x, o in insts if a < x < t]
            slow = any(k in o for o in block for k in ("CALL", "LDL", "STL",
                                                       "DMUL"))
            if slow and not any("MUFU" in o for o in block):
                skipped.update(x for x, _ in insts if a < x < t)
    count = sum(1 for a, _ in insts if lo <= a <= hi and a not in skipped)
    src = (kernels.CSRC / kernels.SOURCES["fused_sim"]).read_text()
    items = int(re.search(r"constexpr int kItems = (\d+);", src).group(1))
    return count / items, count, items


def issue_floor_ms(per_pixel: float, pixels: int) -> float:
    """The least time the card's issue slots need for ``pixels`` pixel
    evaluations of ``per_pixel`` instructions: one warp instruction per
    clock on each of an SM's 4 schedulers, at the card's top SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    return per_pixel * pixels / 32 / (sms * 4 * mhz * 1e6) * 1e3


class KernelCase:
    """One fused-kernel problem: depos (generated from ``key`` unless
    given), binned lists and seed (the charge-grid key's words unless
    given) on the card."""

    def __init__(self, cfg, key, tw: int, tt: int, device, depos=None,
                 seed=None, k_max=None):
        import torch

        from repro_torch.core import prng
        from repro_torch.core.depo import depo_patch_origin, generate_depos
        from repro_torch.kernels.scatter_add import ops as binning

        self.cfg, self.tw, self.tt = cfg, tw, tt
        if depos is None:
            depos = generate_depos(key, cfg, device=device)
        w0, t0 = depo_patch_origin(depos, cfg)
        self.params = (*depos, w0, t0)
        self.seed = seed if seed is not None else tuple(
            int(v) for v in prng.key_data(prng.split(key)[0]))
        self.k_max = k_max or binning.default_k_max(depos.n, cfg.num_wires,
                                                    cfg.num_ticks, tw, tt)
        self.bin_args = (w0, t0, cfg.patch_wires, cfg.patch_ticks,
                         cfg.num_wires, cfg.num_ticks, tw, tt)
        self.ids, self.n_tiles, dropped = binning.bin_depos_to_tiles(
            *self.bin_args, self.k_max)
        self.n_cap = binning.active_tile_cap(
            *self.bin_args[:1], *self.bin_args[2:], t0=t0)
        self.active, self.cids, cdropped = self.compact_lists(self.n_cap)
        check(int(dropped) == 0 and int(cdropped) == 0,
              f"binning dropped {int(dropped)}/{int(cdropped)} entries")
        self.tiles_w, self.tiles_t, _ = binning.tile_counts(
            cfg.num_wires, cfg.num_ticks, tw, tt)
        self.kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks,
                       tw=tw, tt=tt, k_max=self.k_max, pw=cfg.patch_wires,
                       pt=cfg.patch_ticks, seed=self.seed, fluctuate=True)
        self._work = None
        torch.cuda.synchronize()

    def compact_lists(self, n_cap: int):
        from repro_torch.kernels.scatter_add import ops as binning

        return binning.bin_depos_to_tiles_compact(*self.bin_args, self.k_max,
                                                  n_cap)

    def dense(self):
        from repro_torch.kernels.fused_sim import kernel

        return kernel.fused_rasterize_scatter(*self.params, self.ids,
                                              **self.kw)

    def compact(self):
        from repro_torch.kernels.fused_sim import kernel

        return kernel.fused_rasterize_scatter_compact(
            *self.params, self.active, self.cids, **self.kw)

    def plain_dense(self):
        from repro_torch.kernels.fused_sim import ref

        out = ref.fused_rasterize_scatter_ref(
            self.params, self.ids, tiles_w=self.tiles_w, tiles_t=self.tiles_t,
            tw=self.tw, tt=self.tt, k_max=self.k_max,
            pw=self.cfg.patch_wires, pt=self.cfg.patch_ticks, seed=self.seed,
            fluctuate=True)
        return out[:self.cfg.num_wires, :self.cfg.num_ticks]

    def plain_compact(self):
        from repro_torch.kernels import tiles
        from repro_torch.kernels.fused_sim import ref

        blocks = ref.fused_rasterize_scatter_compact_ref(
            self.params, self.active, self.cids, tiles_t=self.tiles_t,
            tw=self.tw, tt=self.tt, k_max=self.k_max,
            pw=self.cfg.patch_wires, pt=self.cfg.patch_ticks, seed=self.seed,
            fluctuate=True)
        return tiles.scatter_tiles_to_grid(
            blocks, self.active, self.tiles_w, self.tiles_t, self.tw,
            self.tt)[:self.cfg.num_wires, :self.cfg.num_ticks]

    def work(self):
        """(entries, in-support pixels, row+column weights, pixels with
        nonzero weights) these lists need: the data-dependent work of the
        kernel."""
        if self._work is None:
            self._work = list_work(self.ids, self.k_max, self.params[5],
                                   self.params[6], self.cfg.patch_wires,
                                   self.cfg.patch_ticks, self.tiles_t,
                                   self.tw, self.tt) + (
                                       evaluated_pixels(self),)
        return self._work

    def bytes_ops(self, n_cap: int = 0, support: bool = False):
        """(bytes, operations) of the fused kernel on these lists: inputs
        read once, the grid written once, and the pixels whose weights are
        nonzero (every in-support pixel with ``support``: the count of
        earlier runs); ``n_cap`` adds the compact layout's active list."""
        entries, in_support, axes, nonzero = self.work()
        pixels = in_support if support else nonzero
        n = self.params[0].numel()
        out_bytes = 4 * self.cfg.num_wires * self.cfg.num_ticks
        nbytes = 7 * 4 * n + 4 * entries + 4 * n_cap + out_bytes
        ops = (OPS_PER_PIXEL * pixels + OPS_PER_AXIS * axes
               + OPS_PER_ENTRY * entries)
        return nbytes, ops

    def bound(self, compact: bool, support: bool = False):
        return bound_of(*self.bytes_ops(self.n_cap if compact else 0,
                                        support))


class MultiPlaneCase:
    """One three-plane fused-kernel problem: the event's physical depos
    drifted onto every plane, one ``KernelCase`` per plane seeded with
    ``fold_in(kf, p)``, and the plane-major lists of the multi-plane
    launch (compact: one shared ``n_cap``)."""

    def __init__(self, cfg, key, tw: int, tt: int, device):
        import torch

        from repro_torch.core import prng
        from repro_torch.core.depo import generate_plane_depos
        from repro_torch.core.stages import plane_fold_keys
        from repro_torch.config import plane_specs

        self.cfg = cfg
        depos = generate_plane_depos(key, cfg, device=device)
        keys = plane_fold_keys(prng.split(key)[0], plane_specs(cfg))
        self.seeds = [tuple(row) for row in keys.tolist()]
        self.planes = [KernelCase(cfg, None, tw, tt, device,
                                  depos=type(depos)(*(x[p] for x in depos)),
                                  seed=self.seeds[p])
                       for p in range(cfg.num_planes)]
        first = self.planes[0]
        self.k_max, self.tiles_w, self.tiles_t = (first.k_max, first.tiles_w,
                                                  first.tiles_t)
        self.n_cap = max(c.n_cap for c in self.planes)
        compact = [c.compact_lists(self.n_cap) for c in self.planes]
        check(all(int(d) == 0 for _, _, d in compact),
              "multi-plane compact binning dropped entries")
        self.params = tuple(torch.stack([c.params[i] for c in self.planes])
                            for i in range(7))
        self.ids = torch.cat([c.ids for c in self.planes])
        self.active = torch.cat([a for a, _, _ in compact])
        self.cids = torch.cat([i for _, i, _ in compact])
        self.kw = dict(num_planes=cfg.num_planes, num_wires=cfg.num_wires,
                       num_ticks=cfg.num_ticks, tw=tw, tt=tt,
                       k_max=self.k_max, pw=cfg.patch_wires,
                       pt=cfg.patch_ticks, seeds=self.seeds, fluctuate=True)
        self.geom = dict(tiles_t=self.tiles_t, tw=tw, tt=tt, k_max=self.k_max,
                         pw=cfg.patch_wires, pt=cfg.patch_ticks)
        torch.cuda.synchronize()

    def dense(self):
        from repro_torch.kernels.fused_sim import kernel

        return kernel.fused_rasterize_scatter_multiplane(
            *self.params, self.ids, **self.kw)

    def compact(self):
        from repro_torch.kernels.fused_sim import kernel

        return kernel.fused_rasterize_scatter_multiplane_compact(
            *self.params, self.active, self.cids, **self.kw)

    def plain_dense(self):
        from repro_torch.kernels.fused_sim import ref

        out = ref.fused_rasterize_scatter_multiplane_ref(
            self.params, self.ids, tiles_w=self.tiles_w, seeds=self.seeds,
            fluctuate=True, **self.geom)
        return out[:, :self.cfg.num_wires, :self.cfg.num_ticks]

    def plain_compact(self):
        from repro_torch.kernels import tiles
        from repro_torch.kernels.fused_sim import ref

        blocks = ref.fused_rasterize_scatter_multiplane_compact_ref(
            self.params, self.active, self.cids, seeds=self.seeds,
            fluctuate=True, **self.geom)
        return tiles.scatter_tiles_to_grid_planes(
            blocks, self.active, self.cfg.num_planes, self.tiles_w,
            self.tiles_t, self.geom["tw"], self.geom["tt"]
        )[:, :self.cfg.num_wires, :self.cfg.num_ticks]

    def bound(self, compact: bool, support: bool = False):
        """The one-plane bound's bytes and operations summed over the
        planes' lists."""
        parts = [c.bytes_ops(self.n_cap if compact else 0, support)
                 for c in self.planes]
        return bound_of(sum(b for b, _ in parts), sum(o for _, o in parts))

    def work(self):
        return tuple(sum(w) for w in zip(*(c.work() for c in self.planes)))


class ScatterCase:
    """One scatter-add problem: the unfused chain's fluctuated float32
    patches of depos generated from ``key`` (or given), fluctuated from
    the normal ``pool`` when one is given, else from the counter stream,
    or with ``bf16`` the bfloat16 patches ``unfused_bf16`` hands the
    scatter without fluctuation, with the dense and compact lists the
    ``pallas`` strategies bin them into (at ``k_max`` when given, else the
    default)."""

    def __init__(self, cfg, key, tw: int, tt: int, device, depos=None,
                 k_max=None, bf16: bool = False, pool=None):
        import torch

        from repro_torch.core import fluctuate as fl
        from repro_torch.core import prng
        from repro_torch.core.depo import generate_depos
        from repro_torch.core.rasterize import rasterize
        from repro_torch.kernels.scatter_add import ops as binning

        self.cfg = cfg
        if depos is None:
            depos = generate_depos(key, cfg, device=device)
        if bf16:
            self.patches, self.w0, self.t0 = rasterize(
                depos, dataclasses.replace(cfg, patch_dtype="bfloat16"))
        else:
            patches, self.w0, self.t0 = rasterize(depos, cfg)
            self.patches = (
                fl.fluctuate_counter(prng.split(key)[0], patches,
                                     depos.charge) if pool is None
                else fl.fluctuate_pool(pool, patches, depos.charge))
        _, pw, pt = self.patches.shape
        self.tw, self.tt = max(tw, pw), max(tt, pt)
        self.k_max = k_max or binning.default_k_max(
            depos.n, cfg.num_wires, cfg.num_ticks, self.tw, self.tt)
        args = (self.w0, self.t0, pw, pt, cfg.num_wires, cfg.num_ticks,
                self.tw, self.tt)
        self.ids, _, dropped = binning.bin_depos_to_tiles(*args, self.k_max)
        self.n_cap = binning.active_tile_cap(*args[:1], *args[2:], t0=self.t0)
        self.active, self.cids, cdropped = binning.bin_depos_to_tiles_compact(
            *args, self.k_max, self.n_cap)
        check(int(dropped) == 0 and int(cdropped) == 0,
              f"scatter binning dropped {int(dropped)}/{int(cdropped)}")
        self.tiles_w, self.tiles_t, _ = binning.tile_counts(
            cfg.num_wires, cfg.num_ticks, self.tw, self.tt)
        self.kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks,
                       tw=self.tw, tt=self.tt, k_max=self.k_max)
        from repro_torch.core.scatter import flat_pixel_indices

        self.flat_idx = flat_pixel_indices(self.w0, self.t0, pw, pt,
                                           cfg.num_ticks).reshape(-1)
        torch.cuda.synchronize()

    def widened(self):
        """This case with its patches widened to float32 (the float32
        kernel's input that the bfloat16 kernel must match bit for bit)."""
        wide = copy.copy(self)
        wide.patches = self.patches.float()
        return wide

    def _crop(self, grid):
        return grid[:self.cfg.num_wires, :self.cfg.num_ticks]

    def _place(self, blocks):
        from repro_torch.kernels.tiles import scatter_tiles_to_grid

        return self._crop(scatter_tiles_to_grid(
            blocks, self.active, self.tiles_w, self.tiles_t, self.tw,
            self.tt))

    def dense(self):
        from repro_torch.kernels.scatter_add import kernel

        return self._crop(kernel.scatter_add_pallas(
            self.patches, self.w0, self.t0, self.ids, **self.kw))

    def compact(self):
        """The compact kernel as the main path calls it: each occupied tile
        written in place into a grid zeroed once."""
        from repro_torch.kernels.scatter_add import kernel

        return self._crop(kernel.scatter_add_pallas_compact(
            self.patches, self.w0, self.t0, self.active, self.cids,
            layout="grid", **self.kw))

    def compact_blocks(self):
        """The compact kernel's reference layout, (n_cap, tw, tt) blocks."""
        from repro_torch.kernels.scatter_add import kernel

        return kernel.scatter_add_pallas_compact(
            self.patches, self.w0, self.t0, self.active, self.cids,
            layout="blocks", **self.kw)

    def plain_dense(self):
        from repro_torch.kernels.scatter_add import ref

        return self._crop(ref.scatter_add_ref(
            self.patches, self.w0, self.t0, self.ids, tiles_w=self.tiles_w,
            tiles_t=self.tiles_t, tw=self.tw, tt=self.tt, k_max=self.k_max))

    def plain_blocks(self):
        from repro_torch.kernels.scatter_add import ref

        return ref.scatter_add_compact_ref(
            self.patches, self.w0, self.t0, self.active, self.cids,
            tiles_t=self.tiles_t, tw=self.tw, tt=self.tt, k_max=self.k_max)

    def plain_compact(self):
        return self._place(self.plain_blocks())

    def library(self):
        """The one PyTorch call computing the same function:
        index_put_(accumulate=True) of every patch pixel into a zeroed
        grid (bfloat16 patches widened first: index_put_ takes the grid's
        dtype)."""
        import torch

        grid = torch.zeros(self.cfg.num_wires * self.cfg.num_ticks,
                           dtype=torch.float32, device=self.patches.device)
        grid.index_put_((self.flat_idx,),
                        self.patches.reshape(-1).to(torch.float32),
                        accumulate=True)
        return grid.reshape(self.cfg.num_wires, self.cfg.num_ticks)

    def work(self):
        """(entries, in-tile patch pixels) these lists add."""
        _, pw, pt = self.patches.shape
        return list_work(self.ids, self.k_max, self.w0, self.t0, pw, pt,
                         self.tiles_t, self.tw, self.tt)[:2]

    def bound(self, compact: bool):
        """Bytes: patches, origins and the filled list entries read once
        (plus the compact active list), the grid written once;
        operations: one add per in-tile patch pixel."""
        entries, pixels = self.work()
        nbytes = (self.patches.numel() * self.patches.element_size()
                  + 8 * self.patches.shape[0]
                  + 4 * entries + (4 * self.n_cap if compact else 0)
                  + 4 * self.cfg.num_wires * self.cfg.num_ticks)
        return bound_of(nbytes, pixels)


class RasterCase:
    """The rasterize kernel's problem on its own path: ``rasterize_depos``
    of ``cfg.num_depos`` generated depos, padded to the 256-depo block,
    with the uniform pools of ``split(key)`` over the padded shape."""

    def __init__(self, cfg, key, device, block: int = 256):
        import torch

        from repro_torch.core.depo import depo_patch_origin, generate_depos
        from repro_torch.kernels.rasterize import ops

        self.cfg = cfg
        padded, _ = ops.pad_depos(generate_depos(key, cfg, device=device),
                                  block)
        self.params = (*padded, *depo_patch_origin(padded, cfg))
        self.pw_pad = (cfg.patch_wires + 7) // 8 * 8
        self.pt_pad = cfg.pad_ticks
        self.pools = ops.uniform_pools(key, (padded.n, self.pw_pad,
                                             self.pt_pad), device)
        self.kw = dict(pw=cfg.patch_wires, pt=cfg.patch_ticks,
                       pw_pad=self.pw_pad, pt_pad=self.pt_pad)
        torch.cuda.synchronize()

    def kernel(self, fluctuate: bool = True):
        from repro_torch.kernels.rasterize import kernel

        return kernel.rasterize_pallas(*self.params, *self.pools,
                                       fluctuate=fluctuate, **self.kw)

    def plain(self, fluctuate: bool = True):
        from repro_torch.kernels.rasterize import ref

        return ref.rasterize_ref(*self.params, *self.pools,
                                 fluctuate=fluctuate, **self.kw)

    def bound(self, fluctuate: bool = True):
        """Bytes: the output written once, the depo parameters and, with
        fluctuation, the in-support part of both pools read once;
        operations: the per-pixel arithmetic of the in-support pixels and
        the axis weights."""
        n = self.params[0].numel()
        pixels = n * self.cfg.patch_wires * self.cfg.patch_ticks
        nbytes = 4 * n * (self.pw_pad * self.pt_pad + 7)
        ops = (2 * pixels + OPS_PER_AXIS * n * (self.cfg.patch_wires
                                                + self.cfg.patch_ticks))
        if fluctuate:
            nbytes += 2 * 4 * pixels
            ops += (OPS_PER_RASTER_PIXEL - 2) * pixels
        return bound_of(nbytes, ops)


def hit_edge_grids(device, t: int):
    """(label, (W, T) grid) synthetic hit-scan cases: runs at tick 0, open
    at the last tick, more runs than the per-wire capacity, samples equal
    to the threshold, all below, all above (a stored run as long as the
    wire), runs across a 32-tick load edge and a step edge, a wire
    whose 8th run starts in the last step, and noise of every run
    length."""
    import torch

    from repro_torch.kernels.hitfind.kernel import STEP as step

    w = HIT_CASE_WIRES
    gen = torch.Generator(device="cpu").manual_seed(t)
    noise = torch.randn((w, t), generator=gen) * 600.0
    g = torch.zeros((w, t))
    g[0, 0] = 700.0
    g[1, :5] = torch.tensor([600.0, 900.0, 1200.0, 800.0, 510.0])
    g[2, -3:] = torch.tensor([550.0, 2000.0, 900.0])
    g[3, :] = 1000.0 + torch.arange(t, dtype=torch.float32)
    g[4, ::2] = 800.0
    g[5, 10:20] = HIT_THRESHOLD
    g[6, 10:20] = torch.nextafter(torch.tensor(HIT_THRESHOLD),
                                  torch.tensor(1e9))
    g[7, ::3] = 2e6
    # runs across load and step edges, one ending on a step's first tick
    for lo, hi in ((HIT_LOAD - 2, HIT_LOAD + 3), (step // 2 - 1, step // 2 + 1),
                   (step - 5, step + 7)):
        g[8, lo:hi] = 900.0 + torch.arange(hi - lo, dtype=torch.float32)
    g[9, HIT_LOAD - 1] = 650.0   # one tick, the last of a load
    g[9, step - 40:step] = 650.0   # ends on the next step's first tick
    g[9, step + 1] = 660.0       # one tick, right after
    # seven short runs, then the 8th starting in the last step, open at T
    last_step = (t - 1) // step * step
    g[10, 5:40:5] = 720.0
    g[10, last_step + 17:] = 1500.0
    g[11, 1:-1] = 0.37 * noise[11, 1:-1] + 333.3   # around 333.3
    g[12:40] = noise[12:40]
    g[40:] = noise[40:].abs() * 0.5 + 450.0
    return [(f"edge cases {w}x{t}", g.to(device)),
            (f"noise {w}x{t}", noise.to(device))]


def check_hitfind(grids, cap: int, threshold: float = HIT_THRESHOLD):
    """Hit-scan kernel == its plain version bit for bit on every (label,
    grid), two runs bit-identical; returns the largest |kernel - plain|
    over the float outputs (0 when they pass)."""
    import torch

    from repro_torch.kernels.hitfind import kernel, ref

    worst = 0.0
    for label, grid in grids:
        got = kernel.hitfind_pallas(grid, threshold=threshold, cap=cap)
        again = kernel.hitfind_pallas(grid, threshold=threshold, cap=cap)
        want = ref.hitfind_ref(grid, threshold=threshold, cap=cap)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got[1:], want[1:])]
        worst = max([worst] + errs)
        counts = got[0][:, 0]
        print(f"hit scan {label}, threshold {threshold}, cap {cap}: grid "
              f"{tuple(grid.shape)}, runs found {int(counts.sum())}, stored "
              f"{int(counts.clamp_max(cap).sum())}, max |kernel - plain| "
              f"(charge, tick, peak) = {errs}", flush=True)
        for name, a, b, c in zip(("counts", "charge", "tick", "peak"), got,
                                 want, again):
            check(torch.equal(a, b), f"hit scan {label}: kernel {name} != "
                  "plain version")
            check(torch.equal(a, c), f"hit scan {label}: kernel {name} not "
                  "bit-identical run to run")
    return worst


def stored_run_lengths(grid, threshold: float, cap: int):
    """Lengths in ticks of the runs the scan stores (the first ``cap`` of
    each wire): runs found by shifted masks, ranked by a cumulative sum."""
    import torch

    above = grid > torch.tensor(threshold, dtype=torch.float32,
                                device=grid.device)
    off = torch.zeros_like(above[:, :1])
    starts = above & ~torch.cat([off, above[:, :-1]], 1)
    lasts = above & ~torch.cat([above[:, 1:], off], 1)
    rank = torch.cumsum(starts.to(torch.int32), 1) - 1
    kept = rank < cap
    lo = torch.nonzero(starts & kept)[:, 1]
    hi = torch.nonzero(lasts & kept)[:, 1]
    return hi - lo + 1


def run_length_stats(lengths) -> str:
    import torch

    n = lengths.to(torch.float32)
    if n.numel() == 0:
        return "no stored runs"
    return (f"{n.numel()} stored runs, length max {int(n.max())}, median "
            f"{float(n.median()):g}, p99 {float(torch.quantile(n, 0.99)):g} "
            f"ticks")


def hit_bound(grid, cap: int):
    """The hit scan's bound on ``grid``. Bytes: the grid read once, counts
    and candidates written once; operations: ~10 per sample."""
    w, t = grid.shape
    return bound_of(4 * (w * t + w + 3 * w * cap), OPS_PER_HIT_SAMPLE * w * t)


def check_order(ids, k_max: int, label: str) -> None:
    """The launch order kernels == their plain version on ``ids``."""
    import torch

    from repro_torch.kernels.tiles import launch_order

    got = launch_order(ids, k_max)
    check(torch.equal(got.cpu(), launch_order(ids.cpu(), k_max)),
          f"{label}: launch order kernels != their plain version")


def check_kernels(case, label: str):
    """Phase 4 checks for one fused case; returns max |kernel - plain| of
    the dense and of the compact kernel (0 when they pass)."""
    import torch

    from repro_torch.testing.parity import GRID_ATOL_FRAC, RTOL

    dense1, dense2 = case.dense(), case.dense()
    comp1, comp2 = case.compact(), case.compact()
    plain = case.plain_dense()
    plain_c = case.plain_compact()
    torch.cuda.synchronize()
    check(torch.equal(dense1, dense2), f"{label}: dense kernel not "
          "bit-identical run to run")
    check(torch.equal(comp1, comp2), f"{label}: compact kernel not "
          "bit-identical run to run")
    check(torch.equal(comp1, dense1), f"{label}: compact kernel != dense "
          "kernel")
    check(torch.equal(plain_c, plain), f"{label}: plain compact != plain "
          "dense")
    check(bool(torch.isfinite(dense1).all()), f"{label}: non-finite grid")
    atol = GRID_ATOL_FRAC * float(plain.abs().max())
    err = float((dense1 - plain).abs().max())
    err_c = float((comp1 - plain_c).abs().max())
    n_bad = int((~torch.isclose(dense1, plain, rtol=RTOL, atol=atol)).sum())
    print(f"{label}: grid {tuple(dense1.shape)}, max |kernel - plain| = "
          f"{err:.6g} (compact {err_c:.6g}; atol {atol:.6g}, rtol {RTOL}), "
          f"{n_bad} outside; max |plain| = {float(plain.abs().max()):.6g}; "
          f"compact == dense bitwise; run-to-run bitwise; n_cap "
          f"{case.n_cap}, k_max {case.k_max}, entries {case.work()[0]}; "
          f"entries per tile: {length_stats(case.ids, case.k_max)}",
          flush=True)
    check(torch.equal(dense1, plain), f"{label}: dense kernel != plain "
          "version")
    check(torch.equal(comp1, plain_c), f"{label}: compact kernel != plain "
          "version")
    check_order(case.ids, case.k_max, f"{label} dense lists")
    check_order(case.cids, case.k_max, f"{label} compact lists")
    return err, err_c


def check_scatter(case, label: str):
    """Phase 4 checks for one scatter-add case: dense, compact in place and
    compact blocks == their plain versions bit for bit, two runs
    bit-identical, the in-place grid == the dense grid and == the placed
    blocks, and for bfloat16 patches each of the three == the float32
    kernel on the widened patches bit for bit; returns max |kernel -
    plain| of the dense and of the compact kernel (0 when they pass)."""
    import torch

    from repro_torch.testing.parity import ATOL_FRAC, RTOL

    dense1, dense2 = case.dense(), case.dense()
    comp1, comp2 = case.compact(), case.compact()
    blocks1, blocks2 = case.compact_blocks(), case.compact_blocks()
    plain, plain_blocks = case.plain_dense(), case.plain_blocks()
    plain_c = case._place(plain_blocks)
    lib = case.library()
    torch.cuda.synchronize()
    err = float((dense1 - plain).abs().max())
    err_c = max(float((comp1 - plain_c).abs().max()),
                float((blocks1 - plain_blocks).abs().max()))
    atol = ATOL_FRAC * float(lib.abs().max())
    lib_err = float((dense1 - lib).abs().max())
    print(f"{label}: grid {tuple(dense1.shape)}, max |kernel - plain| = "
          f"{err:.6g} (compact, in place and blocks {err_c:.6g}), max "
          f"|kernel - index_put_| = {lib_err:.6g} (atol {atol:.6g}, rtol "
          f"{RTOL}); max |grid| = {float(plain.abs().max()):.6g}; tiles "
          f"{case.tw}x{case.tt}, n_cap {case.n_cap}, k_max {case.k_max}; "
          f"entries per tile: {length_stats(case.ids, case.k_max)}",
          flush=True)
    check(float(dense1.sum()) > 0.0, f"{label}: empty grid")
    check(torch.equal(dense1, plain), f"{label}: dense kernel != plain "
          "version")
    check(torch.equal(comp1, plain_c), f"{label}: compact kernel (in place) "
          "!= plain version")
    check(torch.equal(blocks1, plain_blocks), f"{label}: compact kernel "
          "blocks != plain version")
    check(torch.equal(dense1, dense2) and torch.equal(comp1, comp2)
          and torch.equal(blocks1, blocks2),
          f"{label}: kernel not bit-identical run to run")
    check(torch.equal(comp1, dense1), f"{label}: compact kernel (in place) "
          "!= dense kernel")
    check(torch.equal(comp1, case._place(blocks1)), f"{label}: compact "
          "kernel in place != its placed blocks")
    check(torch.allclose(dense1, lib, rtol=RTOL, atol=atol),
          f"{label}: kernel outside tolerance of index_put_")
    if case.patches.dtype == torch.bfloat16:
        wide = case.widened()
        same = [torch.equal(a, b) for a, b in (
            (dense1, wide.dense()), (comp1, wide.compact()),
            (blocks1, wide.compact_blocks()))]
        print(f"{label}: bfloat16 kernel == float32 kernel on the widened "
              f"patches (dense, in place, blocks): {same}", flush=True)
        check(all(same), f"{label}: bfloat16 kernel != float32 kernel on "
              "the widened patches")
    return err, err_c


def check_multiplane(case, label: str):
    """Phase 4 checks for the three-plane fused case; returns max |kernel -
    plain| of the dense and of the compact kernel (0 when they pass)."""
    import torch

    from repro_torch.testing.parity import GRID_ATOL_FRAC, RTOL

    dense1, dense2 = case.dense(), case.dense()
    comp = case.compact()
    plain, plain_c = case.plain_dense(), case.plain_compact()
    singles = [c.dense() for c in case.planes]
    torch.cuda.synchronize()
    atol = GRID_ATOL_FRAC * float(plain.abs().max())
    err = float((dense1 - plain).abs().max())
    err_c = float((comp - plain_c).abs().max())
    print(f"{label}: grids {tuple(dense1.shape)}, max |kernel - plain| = "
          f"{err:.6g} (compact {err_c:.6g}; atol {atol:.6g}, rtol {RTOL}); "
          f"n_cap {case.n_cap} per plane, k_max {case.k_max}, entries per "
          f"plane {[c.work()[0] for c in case.planes]}", flush=True)
    check(torch.equal(dense1, dense2), f"{label}: not bit-identical run to "
          "run")
    check(torch.equal(comp, dense1), f"{label}: compact kernel != dense "
          "kernel")
    check(torch.equal(plain_c, plain), f"{label}: plain compact != plain "
          "dense")
    check(torch.equal(dense1, plain), f"{label}: kernel != plain version")
    check(torch.equal(comp, plain_c), f"{label}: compact kernel != plain "
          "version")
    check_order(case.ids, case.k_max, f"{label} dense lists")
    check_order(case.cids, case.k_max, f"{label} compact lists")
    for p, c in enumerate(case.planes):
        print(f"{label}: plane {p} entries per tile: "
              f"{length_stats(c.ids, c.k_max)}", flush=True)
    for p, single in enumerate(singles):
        check(torch.equal(dense1[p], single),
              f"{label}: plane {p} != the one-plane kernel with "
              f"fold_in(kf, {p})")
    print(f"{label}: plane p == one-plane kernel with fold_in(kf, p), bit "
          f"for bit, p = 0..{len(singles) - 1}", flush=True)
    return err, err_c


def full_list_depos(dev):
    """FULL_LIST depos inside tile (0, 0) of 64 x 256 tiles, so its list
    fills k_max = FULL_LIST exactly."""
    import torch

    from repro_torch.core.depo import DepoSet

    gen = torch.Generator().manual_seed(3)
    lo, hi = torch.tensor(FULL_LIST_LOW), torch.tensor(FULL_LIST_HIGH)
    values = lo + (hi - lo) * torch.rand((FULL_LIST, 5), generator=gen)
    return DepoSet(*values.T.contiguous().to(dev))


def fused_cases(dev):
    """(label, case) of every fused case: full MicroBooNE width with 64 x
    256 and with 32 x 128 tiles, the tile-edge grid, four single depos on
    tile edges, and the three-plane event (last)."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.core import prng
    from repro_torch.core.depo import DepoSet

    full = get_config("lartpc-uboone")
    edge_cfg = dataclasses.replace(full, num_wires=96, num_ticks=768,
                                   num_depos=128)
    one = dataclasses.replace(edge_cfg, num_depos=1)
    key0 = prng.fold_in(prng.key(0), 0)
    cases = [
        ("full width 64x256 tiles", KernelCase(full, key0, 64, 256, dev)),
        ("tile-edge 96x768, 32x128 tiles",
         KernelCase(edge_cfg, prng.key(1), 32, 128, dev)),
        ("full width 32x128 tiles",
         KernelCase(full, prng.fold_in(prng.key(0), 1), 32, 128, dev))]
    for label, values in ONE_DEPO_CASES:
        depos = DepoSet(*(torch.tensor([v], dtype=torch.float32, device=dev)
                          for v in values))
        cases.append((f"one depo, {label}",
                       KernelCase(one, prng.key(2), 64, 256, dev, depos)))
    full_list = KernelCase(dataclasses.replace(edge_cfg,
                                               num_depos=FULL_LIST),
                           prng.key(3), 64, 256, dev, full_list_depos(dev),
                           k_max=FULL_LIST)
    check(int((full_list.ids.view(-1, FULL_LIST) >= 0).sum(1).max())
          == FULL_LIST, "k_max 48 case: no list fills k_max")
    cases.append((f"{FULL_LIST} depos, one list filling k_max {FULL_LIST}",
                  full_list))
    cases.append(("three planes, full width 64x256 tiles",
                  MultiPlaneCase(dataclasses.replace(full, num_planes=PLANES),
                                 key0, 64, 256, dev)))
    return cases


def run_main(cfg, label: str, events: int, dev, counters,
             recon: bool = False, card: str = ""):
    """One launcher run of ``events`` events, every launch counter reset
    just before and read just after (a module's launches on bfloat16
    patches under the wrapper's name with ``_bf16``); per-plane checks on
    every event; the total line names ``card``. Returns (the events' ADC,
    the counters read, the graph, event 0's output)."""
    import torch

    from repro_torch.core.pipeline import make_sim_fn
    from repro_torch.launch.sim import hit_counts, max_dev, run_events

    sim = make_sim_fn(cfg, device=dev, recon=recon)
    adcs, lines, first = [], [], []
    n_planes = cfg.num_planes
    shape = ((n_planes,) if n_planes > 1 else ()) + (cfg.num_wires,
                                                     cfg.num_ticks)

    def on_event(ev, out, dt):
        check(out.adc.dtype == torch.int16, "ADC is not int16")
        check(tuple(out.adc.shape) == shape,
              f"ADC shape {tuple(out.adc.shape)} != {shape}")
        check(bool(torch.isfinite(out.signal).all()), "non-finite signal")
        planes = out.adc.reshape(-1, cfg.num_wires, cfg.num_ticks)
        devs, medians = [], []
        for p in range(planes.shape[0]):
            medians.append(int(planes[p].flatten()[::97].median()))
            devs.append(max_dev(planes[p], cfg))
            check(medians[-1] == int(cfg.adc_baseline),
                  f"plane {p}: ADC median {medians[-1]} != baseline "
                  f"{cfg.adc_baseline}")
            check(devs[-1] > 0, f"plane {p}: max dev is 0")
        adcs.append(out.adc.clone())
        if ev == 0:
            first.append(out)
        n = cfg.num_depos * n_planes
        hits = ""
        if recon:
            check(bool(torch.isfinite(out.decon).all()), "non-finite decon")
            per_plane = [hit_counts(out.hits, p if n_planes > 1 else None)
                         for p in range(n_planes)]
            check(all(s > 0 for s, _ in per_plane), f"a plane without hits: "
                  f"{per_plane}")
            hits = f", hits (stored, found) per plane {per_plane}"
        lines.append(f"{label} event {ev}: {cfg.num_depos} depos x "
                     f"{n_planes} plane(s) -> {tuple(out.adc.shape)} ADC in "
                     f"{dt*1e3:.3f} ms ({n/dt:.4g} plane-depos/s), max dev "
                     f"per plane {devs}, median per plane {medians}, "
                     f"dropped {int(out.dropped)}{hits}")

    torch.cuda.reset_peak_memory_stats(dev)
    for module in counters:
        module.reset_launches()
    stats = run_events(cfg, events, seed=0, device=dev, sim=sim,
                       on_event=on_event)
    launches = {name: n for module in counters
                for name, n in module.LAUNCHES.items()}
    launches.update({f"{name}_bf16": n for module in counters
                     for name, n in getattr(module, "BF16_LAUNCHES",
                                            {}).items()})
    peak = torch.cuda.max_memory_allocated(dev)
    print("\n".join(lines))
    print(f"{label} total: {stats['events']} events / {stats['depos']} "
          f"depos x {n_planes} plane(s) in {stats['wall_s']:.4f} s (sim "
          f"alone: median {statistics.median(stats['event_s'])*1e3:.3f} "
          f"ms/event); launches {launches}; peak memory "
          f"{peak / 2**20:.1f} MiB; {card}", flush=True)
    return adcs, launches, sim, first[0]


#: the settings of the library-scatter determinism check: (label, config
#: overrides on the full one-plane config)
DETERMINISM_SETTINGS = (
    ("unfused + xla", {}),
    ("unfused_bf16 + xla", {"charge_grid_strategy": "unfused_bf16"}),
    ("unfused + sort_segment", {"scatter_strategy": "sort_segment"}),
    ("multiplane_xla, 3 planes", {"num_planes": PLANES,
                                  "charge_grid_strategy": "multiplane_xla"}))


def check_determinism(full, key, dev, case) -> None:
    """The library scatters run to run: each setting's full-width event
    twice with one key and one set of depos; prints max |delta grid| and
    the ADC pixels that differ, and fails on any difference. Then a
    witness that does not fail the run: the run totals that
    ``sort_segment`` summed with ``index_add_`` before it took
    ``index_put_``, twice on the full-width fluctuated patches of ``case``
    (the unfused event's own), and how far the two grids lie apart."""
    import torch

    from repro_torch.core.depo import generate_depos, generate_physical_depos
    from repro_torch.core.pipeline import make_sim_fn

    for label, overrides in DETERMINISM_SETTINGS:
        cfg = dataclasses.replace(full, **overrides)
        generate = (generate_physical_depos if cfg.num_planes > 1
                    else generate_depos)
        depos = generate(key, cfg, device=dev)
        sim = make_sim_fn(cfg, device=dev)
        first, second = sim(key, depos), sim(key, depos)
        torch.cuda.synchronize()
        dgrid = float((first.charge_grid - second.charge_grid).abs().max())
        n_grid = int((first.charge_grid != second.charge_grid).sum())
        n_adc = int((first.adc != second.adc).sum())
        print(f"determinism {label}: two runs, one key: max |delta grid| "
              f"{dgrid:.6g}, grid pixels that differ {n_grid}, ADC "
              f"mismatches {n_adc}", flush=True)
        check(n_grid == 0 and n_adc == 0,
              f"determinism {label}: two runs with one key differ")
    idx_s, order = torch.sort(case.flat_idx, stable=True)
    _, run = torch.unique_consecutive(idx_s, return_inverse=True)
    vals = case.patches.reshape(-1)[order]
    totals = [torch.zeros(int(run[-1]) + 1, device=dev).index_add_(0, run,
                                                                   vals)
              for _ in range(2)]
    torch.cuda.synchronize()
    print(f"determinism witness, index_add_ over sort_segment's runs (its "
          f"form before the repair): two runs, max |delta grid| "
          f"{float((totals[0] - totals[1]).abs().max()):.6g}, grid pixels "
          f"that differ {int((totals[0] != totals[1]).sum())} of "
          f"{totals[0].numel()}", flush=True)


#: the stream phase's full-width streams: (label, planes,
#: charge_grid_strategy, scatter_strategy, recon, events, batch events).
#: The three-plane compact stream's last batch holds 4 events and 2
#: padding rows, and each of its batches 18 rows: two fused launches
STREAMS = (
    ("fused_pallas", 1, "fused_pallas", "xla", False, 8, 4),
    ("fused_pallas_multiplane recon", PLANES, "fused_pallas_multiplane",
     "xla", True, 8, 4),
    ("fused_pallas_multiplane_compact", PLANES,
     "fused_pallas_multiplane_compact", "xla", False, 10, 6),
    ("unfused+pallas", 1, "unfused", "pallas", False, 2, 2),
    ("fused_pallas_compact", 1, "fused_pallas_compact", "xla", False, 2, 2),
    ("unfused+pallas_compact", 1, "unfused", "pallas_compact", False, 2, 2))
#: the most rows one fused launch takes (kMaxPlanes, csrc/fused_sim.cu)
FUSED_ROWS_PER_LAUNCH = 16


def output_fields(out, e=None):
    """A SimOutput's compared tensors by name (event ``e`` of a batched
    one): ADC, grid, signal, and decon and the HitSet leaves with recon."""
    named = {"adc": out.adc, "charge_grid": out.charge_grid,
             "signal": out.signal}
    if out.decon is not None:
        named["decon"] = out.decon
    if out.hits is not None:
        named.update({f"hits.{f}": v for f, v in out.hits._asdict().items()})
    return {k: (v if e is None else v[e]) for k, v in named.items()}


def loop_outputs(cfg, events: int, dev, recon: bool):
    """run_events' output of events 0 .. events-1, the loop the streams
    are held against; and its stats."""
    from repro_torch.core.pipeline import make_sim_fn
    from repro_torch.launch.sim import run_events

    outs = {}
    stats = run_events(cfg, events, seed=0, device=dev,
                       sim=make_sim_fn(cfg, device=dev, recon=recon),
                       on_event=lambda ev, out, dt: outs.update({ev: out}))
    return outs, stats


def run_stream(cfg, label: str, events: int, batch_events: int, dev,
               counters, expect=None, kept=None, rows_calls=None, **kw):
    """One stream_simulate run, every launch counter reset just before and
    read just after, and the fused kernel's launches counted. Each valid
    row is held against ``expect[id]`` (run_events' output of that event)
    bit for bit on every compared field; ``kept`` names the event ids the
    stream keeps (default all); ``rows_calls``, a list, receives the
    (args, kwargs) of every ``simulate_charge_grid_rows`` call (one a
    batch for a fused strategy). Returns (stats, launches, fused
    launches, {id: the row's ADC})."""
    import torch

    from repro_torch.launch.sim import stream_simulate

    kept = list(range(events)) if kept is None else kept
    adcs = {}

    def on_batch(b, n_valid, n_depos, dt, out):
        ids = [i for i in kept
               if b * batch_events <= i < (b + 1) * batch_events]
        check(len(ids) == n_valid, f"{label} batch {b}: {n_valid} rows for "
              f"ids {ids}")
        for e, ev in enumerate(ids):
            if expect is not None:
                want, got = output_fields(expect[ev]), output_fields(out, e)
                bad = [k for k in want if not torch.equal(got[k], want[k])]
                check(not bad, f"{label}: event {ev} differs from "
                      f"run_events in {bad}")
            adcs[ev] = out.adc[e].clone()

    for module in counters:
        module.reset_launches()
    with count_calls([("repro_torch.kernels.fused_sim.kernel",
                       "_launch")]) as fused, recorded_calls(
            "repro_torch.kernels.fused_sim.ops",
            ["simulate_charge_grid_rows"]) as calls:
        stats = stream_simulate(cfg, events, batch_events, seed=0,
                                device=dev, on_batch=on_batch, **kw)
    if rows_calls is not None:
        rows_calls.extend((a, k) for _, a, k in calls)
    torch.cuda.synchronize()
    launches = {name: n for module in counters
                for name, n in module.LAUNCHES.items() if n}
    return stats, launches, fused[0], adcs


def plain_launch(name: str, args, kw):
    """The plain version of one recorded multi-plane fused wrapper call
    (the launch's own parameters, lists, seeds and geometry), cropped as
    the wrapper crops."""
    from repro_torch.kernels import tiles
    from repro_torch.kernels.fused_sim import kernel, ref
    from repro_torch.kernels.scatter_add.ops import tile_counts

    rows, tw, tt = kw["num_planes"], kw["tw"], kw["tt"]
    tiles_w, tiles_t, _ = tile_counts(kw["num_wires"], kw["num_ticks"], tw,
                                      tt)
    common = dict(seeds=kernel._plane_seeds(kw["seeds"], rows),
                  fluctuate=kw["fluctuate"], tiles_t=tiles_t, tw=tw, tt=tt,
                  k_max=kw["k_max"], pw=kw["pw"], pt=kw["pt"])
    if name.endswith("_compact"):
        active = args[7]
        out = tiles.scatter_tiles_to_grid_planes(
            ref.fused_rasterize_scatter_multiplane_compact_ref(
                args[:7], active, args[8], **common),
            active, rows, tiles_w, tiles_t, tw, tt)
    else:
        out = ref.fused_rasterize_scatter_multiplane_ref(
            args[:7], args[7], tiles_w=tiles_w, **common)
    return out[:, :kw["num_wires"], :kw["num_ticks"]]


def check_rows_vs_plain(label: str, call, card: str):
    """Run one batch's fused charge-grid call again on the card (the rows,
    keys and valid counts the stream gave ``simulate_charge_grid_rows``),
    and hold its grids against the plain version of each of its launches
    on the same inputs, bit for bit; the launches split the rows 16 at a
    time. Returns max |kernel - plain|."""
    import torch

    from repro_torch.kernels.fused_sim import ops

    args, kw = call
    with recorded_calls("repro_torch.kernels.fused_sim.kernel",
                        ["fused_rasterize_scatter_multiplane",
                         "fused_rasterize_scatter_multiplane_compact"]
                        ) as launches:
        grid, _ = ops.simulate_charge_grid_rows(*args, **kw)
    rows = grid.shape[0]
    sizes = [k["num_planes"] for _, _, k in launches]
    plain = torch.cat([plain_launch(*launch) for launch in launches])
    torch.cuda.synchronize()
    err = float((grid - plain).abs().max())
    want = [min(FUSED_ROWS_PER_LAUNCH, rows - lo)
            for lo in range(0, rows, FUSED_ROWS_PER_LAUNCH)]
    check(sizes == want, f"{label}: launches of {sizes} rows, want {want}")
    check(torch.equal(grid, plain), f"{label}: the batch's {rows} fused "
          f"rows != the plain version (max |delta| {err:.6g})")
    print(f"stream {label}: one batch's {rows} fused rows (launches of "
          f"{sizes} rows) == the plain version on the same rows and seeds, "
          f"bit for bit (max |kernel - plain| {err:.6g}); {card}",
          flush=True)
    return err


def check_streams(full, dev, counters, card: str):
    """The stream phase: every STREAMS stream at full width against
    run_events bit for bit, with ceil(rows / 16) fused launches a batch;
    the fault plan (quarantine, a halved batch), journal resume through
    the launcher's flags, the finite sentinel; events/s beside the loop.
    Returns the launches per kernel over the clean streams."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_journals_") as tmp:
        return stream_checks(full, dev, counters, card, Path(tmp))


def stream_checks(full, dev, counters, card: str, tmp: Path):
    """``check_streams``' body; the journals go under ``tmp``."""
    import torch

    from repro_torch.core.pipeline import make_sim_fn
    from repro_torch.launch import sim as launcher
    from repro_torch.launch.journal import load_journal_records
    from repro_torch.launch.sim import run_events, stream_simulate
    from repro_torch.testing.faults import FaultPlan

    totals = {}
    clean = {}
    for (label, planes, strategy, scatter, recon, events,
         batch_events) in STREAMS:
        cfg = dataclasses.replace(full, num_planes=planes,
                                  charge_grid_strategy=strategy,
                                  scatter_strategy=scatter)
        expect, loop = loop_outputs(cfg, events, dev, recon)
        journal = str(tmp / f"{label.replace(' ', '_')}.jsonl")
        rows_calls = []
        stats, launches, fused, adcs = run_stream(
            cfg, label, events, batch_events, dev, counters, expect=expect,
            recon=recon, journal=journal, rows_calls=rows_calls)
        batches = -(-events // batch_events)
        want_fused = (batches * -(-batch_events * planes
                                  // FUSED_ROWS_PER_LAUNCH)
                      if strategy.startswith("fused") else 0)
        check(fused == want_fused, f"{label}: {fused} fused launches, want "
              f"{want_fused} (ceil(rows / 16) a batch)")
        check(stats["events"] == events
              and stats["batches"][-1]["events"]
              == events - (batches - 1) * batch_events,
              f"{label}: stream stats {stats['batches']}")
        if recon:
            check(launches.get("hitfind_pallas") == batches * batch_events
                  * planes, f"{label}: hit-scan launches {launches}")
            check(all(b["hits"] > 0 for b in stats["batches"]),
                  f"{label}: a batch without hits")
        for name, n in launches.items():
            totals[name] = totals.get(name, 0) + n
        if strategy.startswith("fused"):
            check(len(rows_calls) == batches, f"{label}: "
                  f"{len(rows_calls)} fused rows calls for {batches} batches")
            check_rows_vs_plain(label, rows_calls[0], card)
        del rows_calls
        print(f"stream {label}: {events} events, {batch_events} a batch, "
              f"every row == run_events bit for bit "
              f"({', '.join(output_fields(expect[0]))}); fused launches "
              f"{fused} ({want_fused // max(batches, 1)} a batch of "
              f"{batch_events * planes} rows); launches {launches}; stream "
              f"{stats['events'] / stats['wall_s']:.4g} events/s with the "
              f"checks, loop {loop['events'] / loop['wall_s']:.4g} "
              f"events/s; {card}", flush=True)
        if label == "fused_pallas":
            clean = dict(cfg=cfg, expect=expect, adcs=adcs,
                         shas={r["batch"]: r["adc_sha"]
                               for r in load_journal_records(journal)})
        del expect
        torch.cuda.empty_cache()

    # faults on the card: event 1 quarantined, batch 0 halved by an OOM
    cfg, expect = clean["cfg"], clean["expect"]
    stats, _, _, adcs = run_stream(
        cfg, "faults nan@1,oom@0", 8, 4, dev, counters, expect=expect,
        kept=[0, 2, 3, 4, 5, 6, 7], faults=FaultPlan.parse("nan@1,oom@0"),
        journal=str(tmp / "faults.jsonl"))
    h = stats["health"]
    check(h["quarantined"] == 1 and h["retries"] == 1 and h["halvings"] == 1
          and stats["events"] == 7, f"fault plan health {h}")
    counters_text = {k: v for k, v in h.items() if k != "dead_letters"}
    print(f"stream faults nan@1,oom@0: event 1 quarantined, batch 0 halved "
          f"(2 + 2 rows); the 7 survivors == the clean stream's rows bit "
          f"for bit; health {counters_text}", flush=True)

    # journal resume through the launcher: stopped at batch 1, resumed
    jpath = str(tmp / "resume.jsonl")
    argv = ["--events", "8", "--batch-events", "4", "--journal", jpath,
            "--set", "charge_grid_strategy=fused_pallas"]
    try:
        launcher.main(argv + ["--inject-faults", "error@1"])
        check(False, "the error@1 stream did not stop")
    except SystemExit as e:
        print(f"stream error@1: stopped: {e}", flush=True)
    check([r["batch"] for r in load_journal_records(jpath)] == [0],
          "the stopped stream's journal")
    launcher.main(argv + ["--resume"])
    resumed = {r["batch"]: r["adc_sha"] for r in load_journal_records(jpath)}
    check(resumed == clean["shas"], f"resumed digests {resumed} != clean "
          f"{clean['shas']}")
    print("stream resume (--journal, --resume): the resumed digests == the "
          "clean stream's", flush=True)

    # the finite sentinel: on == off; it trips on a NaN event unvalidated
    fin = dataclasses.replace(cfg, check_finite=True)
    stats, _, _, adcs = run_stream(fin, "check_finite", 4, 4, dev, counters)
    check(all(torch.equal(adcs[ev], clean["adcs"][ev]) for ev in range(4))
          and stats["health"]["nonfinite_events"] == 0,
          "check_finite on: ADC differs from off, or the sentinel tripped")
    stats, _, _, adcs = run_stream(
        fin, "check_finite nan@1 unvalidated", 4, 4, dev, counters,
        validate=False, faults=FaultPlan.parse("nan@1"))
    check(stats["batches"][0]["nonfinite"] == 1
          and all(torch.equal(adcs[ev], clean["adcs"][ev])
                  for ev in (0, 2, 3)),
          f"the sentinel on nan@1: {stats['batches']}")
    print("stream check_finite: ADC == off bit for bit; with validation off "
          "the sentinel trips on event 1 (nan@1) alone, and events 0, 2, 3 "
          "keep their bits", flush=True)
    del expect, clean
    torch.cuda.empty_cache()

    # events/s: the loop, and streams of 1 and 4 events a batch, each run
    # twice in the order A B C D D C B A (the host is shared: its pace
    # drifts within a call)
    for (label, planes, strategy, recon) in (
            ("1 plane fused_pallas", 1, "fused_pallas", False),
            ("3 planes fused_pallas_multiplane recon", PLANES,
             "fused_pallas_multiplane", True)):
        cfg = dataclasses.replace(full, num_planes=planes,
                                  charge_grid_strategy=strategy)
        sim = make_sim_fn(cfg, device=dev, recon=recon)

        def events_per_s(name, events=8):
            if name == "loop":
                st = run_events(cfg, events, seed=0, device=dev, sim=sim)
            else:
                st = stream_simulate(cfg, events, int(name.split()[1]),
                                     seed=0, device=dev, recon=recon,
                                     validate="unvalidated" not in name)
            return st["events"] / st["wall_s"]

        names = ("loop", "batch 1", "batch 4", "batch 4 unvalidated")
        rates = {name: [] for name in names}
        for name in names + names[::-1]:
            rates[name].append(events_per_s(name))
        print(f"events/s, {label}, 8 full-width events a run (host clock, "
              f"generation included), two runs each: " + ", ".join(
                  f"{name} {r[0]:.4f} / {r[1]:.4f} "
                  f"({1e3 / r[0]:.2f} / {1e3 / r[1]:.2f} ms/event)"
                  for name, r in rates.items()) + f"; {card}", flush=True)
        for name in names[:3]:
            wall, busy, top = profiled(lambda: events_per_s(name, 4))
            print(f"device busy, {label}, {name}, 4 events under "
                  f"torch.profiler: {busy:.3f} ms of CUDA activity in "
                  f"{wall:.3f} ms (host clock, synchronised), busy share "
                  f"{busy / wall:.4f}; ops with the most device time: "
                  + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in top)
                  + f"; {card}", flush=True)
        torch.cuda.empty_cache()
    return totals


def profiled(fn, ops: bool = True):
    """(wall ms, device ms, top ops) of one call of ``fn`` under
    torch.profiler: the host clock around the call (synchronised; the
    profiler's own host cost included, so the busy share it gives is a
    lower bound), the device time of every CUDA event (kernels, copies,
    fills), and the five host ops whose kernels took the most device
    time. ``ops=False`` records CUDA activity alone (no host ops: half
    the processing of a full-width train step) and returns no top ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if ops
                  else [ProfilerActivity.CUDA])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3
    if not ops:
        return wall, busy, []
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.self_device_time_total > 0]
    top = sorted(host, key=lambda e: -e.self_device_time_total)[:5]
    return wall, busy, [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in top]


#: the tune phase's rate cells: events a run and events a batch
TUNE_EVENTS = 8
TUNE_BATCH = 4
#: the ops a recon event dispatches whatever the decisions
TUNE_EVENT_OPS = {"drift", "charge_grid", "fft_convolve", "deconvolve",
                  "hit_find"}


@contextlib.contextmanager
def strategy_calls(ops):
    """Record (op, strategy, plane kind or None) of every call of a
    registered strategy of ``ops`` inside the block (they still run): the
    registry's entries are wrapped, so every dispatch site is seen, and so
    is the batched form of the fused charge grids
    (``charge_grid_fused_rows``, which takes the strategy's name)."""
    from repro_torch.core import pipeline
    from repro_torch.tune import registry

    calls = []
    rows = pipeline.charge_grid_fused_rows

    def fused_rows(name, *args, **kwargs):
        calls.append(("charge_grid", name, None))
        return rows(name, *args, **kwargs)

    pipeline.charge_grid_fused_rows = fused_rows
    saved = {op: registry.strategies(op) for op in ops}
    for op, table in saved.items():
        for name, strat in table.items():
            def fn(*args, _op=op, _name=name, _fn=strat.fn, **kwargs):
                plane = getattr(args[1], "plane", None) if len(args) > 1 \
                    else None
                calls.append((_op, _name,
                              plane if isinstance(plane, str) else None))
                return _fn(*args, **kwargs)

            registry._OPS[op][name] = dataclasses.replace(strat, fn=fn)
    try:
        yield calls
    finally:
        pipeline.charge_grid_fused_rows = rows
        for op, table in saved.items():
            registry._OPS[op].update(table)


def decided(decisions):
    """{(op, plane kind or None): strategy} of a resolution's decisions
    (the plane-keyed ops by the kind in their cache key)."""
    from repro_torch.tune.autotune import PLANE_KEYED_OPS

    out = {}
    for d in decisions:
        kind = None
        if d.op in PLANE_KEYED_OPS:
            dims = dict(kv.split("=") for kv in
                        d.cache_key.split("|")[3].split(";"))
            kind = dims["plane"]
        out[d.op, kind] = d.strategy
    return out


def check_dispatch(label: str, calls, want) -> None:
    """Every recorded strategy call ran its op's decision (per plane kind
    for the plane-keyed ops), and every op the event needs was called."""
    from repro_torch.tune.autotune import PLANE_KEYED_OPS

    grid = want["charge_grid", None]
    for op, name, plane in calls:
        allowed = {want[op, plane if op in PLANE_KEYED_OPS else None]}
        if op == "scatter_add" and grid == "multiplane_xla":
            allowed.add("xla")  # the flat chain names its scatter itself
        check(name in allowed, f"{label}: {op} ran {name!r} on plane "
              f"{plane}, the decision is {sorted(allowed)}")
    need = set(TUNE_EVENT_OPS)
    if grid in ("unfused", "unfused_bf16", "multiplane_xla"):
        need.add("scatter_add")
    seen = {op for op, _, _ in calls}
    check(need <= seen, f"{label}: ops {sorted(need - seen)} never "
          "dispatched")
    print(f"{label}: {len(calls)} strategy calls, each the decision of its "
          f"op (and plane kind): "
          f"{sorted({(op, n, p) for op, n, p in calls}, key=str)}",
          flush=True)


def explicit_configs(cfg, want):
    """Configs naming the tuned strategies explicitly, with the plane kinds
    each covers: one when every plane-keyed op has one winner for all
    kinds, else one per kind (a plane's bits do not depend on the planes
    beside it, so plane p of the tuned event is plane p of its kind's
    config)."""
    from repro_torch.config import plane_specs
    from repro_torch.tune.autotune import OP_FIELDS, PLANE_KEYED_OPS

    fixed = {OP_FIELDS[op]: name for (op, kind), name in want.items()
             if op not in PLANE_KEYED_OPS}
    kinds = sorted({s.kind for s in plane_specs(cfg)})
    per_kind = {k: {OP_FIELDS[op]: want[op, k] for op in PLANE_KEYED_OPS}
                for k in kinds}
    if all(per_kind[k] == per_kind[kinds[0]] for k in kinds):
        return [(dataclasses.replace(cfg, **fixed, **per_kind[kinds[0]]),
                 kinds)]
    return [(dataclasses.replace(cfg, **fixed, **per_kind[k]), [k])
            for k in kinds]


def check_tuned_event(label: str, cfg, tuned, decisions, dev) -> None:
    """One event of the tuned config through run_events and one batch of
    TUNE_BATCH rows (the event and padding) through stream_simulate: each
    dispatch ran its decision, and the event equals, bit for bit, the
    event of the config naming the same strategies explicitly (per plane
    kind where the kinds' winners differ) and the stream's row."""
    import torch

    from repro_torch.config import plane_specs
    from repro_torch.core.pipeline import make_sim_fn
    from repro_torch.launch.sim import run_events, stream_simulate
    from repro_torch.tune.autotune import OP_FIELDS

    want = decided(decisions)
    outs = {}
    with strategy_calls(OP_FIELDS) as calls:
        run_events(tuned, 1, seed=0, device=dev,
                   sim=make_sim_fn(tuned, device=dev, recon=True),
                   on_event=lambda ev, out, dt: outs.update(loop=out))
    check_dispatch(f"tune {label} run_events", calls, want)
    with strategy_calls(OP_FIELDS) as calls:
        stream_simulate(tuned, 1, TUNE_BATCH, seed=0, device=dev, recon=True,
                        on_batch=lambda b, n, d, dt, out: outs.update(
                            stream=out))
    check_dispatch(f"tune {label} stream_simulate, batch {TUNE_BATCH}",
                   calls, want)
    got = output_fields(outs["loop"])
    row = output_fields(outs["stream"], 0)
    bad = [k for k in got if not torch.equal(got[k], row[k])]
    check(not bad, f"tune {label}: the streamed row differs from "
          f"run_events in {bad}")
    specs = plane_specs(cfg)
    for explicit, kinds in explicit_configs(cfg, want):
        ref = {}
        run_events(explicit, 1, seed=0, device=dev,
                   sim=make_sim_fn(explicit, device=dev, recon=True),
                   on_event=lambda ev, out, dt: ref.update(out=out))
        ref = output_fields(ref["out"])
        planes = [s.index for s in specs if s.kind in kinds]
        for k in got:
            if cfg.num_planes > 1:
                same = all(torch.equal(got[k][p], ref[k][p])
                           for p in planes)
            else:
                same = torch.equal(got[k], ref[k])
            check(same, f"tune {label}: {k} differs from the explicit "
                  f"config's on planes {planes}")
        named = {f: getattr(explicit, f) for f in OP_FIELDS.values()}
        print(f"tune {label}: the tuned event == the event of {named} on "
              f"planes {planes}, bit for bit (ADC, grid, signal, decon, "
              f"hits), and == the streamed row", flush=True)


def check_tune(full, dev, counters, card: str):
    """The tune phase, on a tuning cache of this call's own (tuned fresh
    every run)."""
    from repro_torch.tune.autotune import CACHE_ENV

    saved = os.environ.get(CACHE_ENV)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as tmp:
        os.environ[CACHE_ENV] = str(Path(tmp) / "tune_cache.json")
        try:
            return tune_checks(full, dev, counters, card, Path(tmp))
        finally:
            if saved is None:
                del os.environ[CACHE_ENV]
            else:
                os.environ[CACHE_ENV] = saved


def tune_checks(full, dev, counters, card: str, tmp: Path):
    """``check_tune``'s body: tune every op at full width for one plane and
    for three (explicit fields included), check the records, the
    candidates and a second resolution (all cache hits, no timing), drive
    one tuned event with recon through the loop and the stream and hold
    it against the explicit names, then events/s of the default and the
    tuned configs (A B B A). Returns each kernel's launches in the
    tuning."""
    import json

    import torch

    from repro_torch.launch.sim import stream_simulate
    from repro_torch.tune import (TuneCache, available_strategies,
                                  make_context, resolve_config,
                                  resolve_config_with_decisions)

    kind = torch.cuda.get_device_name().replace(" ", "_")
    cache_path = str(tmp / "tune_cache.json")
    full3 = dataclasses.replace(full, num_planes=PLANES)
    for module in counters:
        module.reset_launches()
    tuned = {}
    for label, cfg in (("1 plane", full), ("3 planes", full3)):
        t0 = time.perf_counter()
        tcfg, decisions = resolve_config_with_decisions(
            cfg, tune=True, tune_explicit=True, cache=TuneCache(cache_path),
            device=dev)
        torch.cuda.synchronize()
        print(f"tune {label} ({time.perf_counter() - t0:.2f} s, host-paced "
              f"CUDA events, median of 3 after 1 warm-up; {card}):",
              flush=True)
        for d in decisions:
            print(f"  {d.describe()}", flush=True)
        tuned[label] = (cfg, tcfg, decisions)
    launches = {name: n for module in counters
                for name, n in module.LAUNCHES.items()}
    launches.update({f"{name}_bf16": n for module in counters
                     for name, n in getattr(module, "BF16_LAUNCHES",
                                            {}).items()})
    print(f"tune launches (both resolutions): {launches}", flush=True)

    records = json.load(open(cache_path))
    check(records, "the tune wrote no record")
    for key, rec in records.items():
        check(rec["backend"] == "cuda" and rec["device_kind"] == kind,
              f"tune record {key}: backend {rec['backend']!r}, device kind "
              f"{rec['device_kind']!r}, want 'cuda', {kind!r}")
        check(rec["timer"].startswith("median_timer: host-paced CUDA "
                                      "events"), f"tune record {key}: timer "
              f"{rec['timer']!r}")
    for label, (cfg, tcfg, decisions) in tuned.items():
        for d in decisions:
            check(d.source in ("tuned", "cache"), f"tune {label}: {d.op} "
                  f"decided by {d.source}")
            ctx = make_context(cfg, records[d.cache_key]["shape"], dev)
            check(d.strategy in available_strategies(d.op, ctx),
                  f"tune {label}: {d.op} winner {d.strategy!r} is not "
                  "available for its context")
        calls = []
        _, again = resolve_config_with_decisions(
            cfg, tune=True, tune_explicit=True, cache=TuneCache(cache_path),
            timer=lambda name, thunk: calls.append(name) or 0.0, device=dev)
        check(not calls and all(d.source == "cache" for d in again)
              and [d.strategy for d in again]
              == [d.strategy for d in decisions],
              f"tune {label}: the second resolution timed {calls} or "
              f"missed the cache: {[d.describe() for d in again]}")
        print(f"tune {label}: second resolution: {len(again)} cache hits, "
              "0 timer calls", flush=True)
    for label, (cfg, tcfg, decisions) in tuned.items():
        check_tuned_event(label, cfg, tcfg, decisions, dev)
    torch.cuda.empty_cache()

    # events/s of the default config (today's strategies: an empty cache)
    # and of the tuned one, A B B A
    empty = TuneCache(str(tmp / "empty.json"))
    for label, recon in (("1 plane", False), ("3 planes", True)):
        cfg, tcfg, _ = tuned[label]
        cells = {"default": resolve_config(cfg, cache=empty, device=dev),
                 "tuned": tcfg}
        rates = {name: [] for name in cells}
        for name in ("default", "tuned", "tuned", "default"):
            st = stream_simulate(cells[name], TUNE_EVENTS, TUNE_BATCH,
                                 seed=0, device=dev, recon=recon)
            rates[name].append(st["events"] / st["wall_s"])
        print(f"tune events/s, {label}{' recon' if recon else ''}, "
              f"{TUNE_EVENTS} full-width events {TUNE_BATCH} a batch "
              f"(stream_simulate, host clock, generation included), A B B "
              f"A: " + ", ".join(
                  f"{name} {r[0]:.4f} / {r[1]:.4f} ({1e3 / r[0]:.2f} / "
                  f"{1e3 / r[1]:.2f} ms/event)" for name, r in rates.items())
              + "; default strategies " + str({
                  f: getattr(cells["default"], f) for f in (
                      "charge_grid_strategy", "scatter_strategy",
                      "fft_strategy", "deconv_strategy",
                      "hitfind_strategy")}) + f"; {card}", flush=True)
        torch.cuda.empty_cache()
    return launches


#: the fit phase: full-width events, Adam steps of the short fit, and the
#: identity-transform fields of the finite-difference check (the
#: reference's e2e step and tolerances)
FIT_EVENTS = 2
FIT_STEPS = 20
FIT_FD_FIELDS = ("electron_lifetime_us", "recombination")
FIT_FD = dict(eps=2e-2, rtol=2e-1, atol=1e-3)


def timed_step(loss_fn, theta):
    """(loss, gradient, forward ms, backward ms) of one step, each half
    ended by a synchronise and timed on the host clock."""
    import torch

    th = theta.detach().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val = loss_fn(th)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    (grad,) = torch.autograd.grad(val, th)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return float(val.detach()), grad, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def check_fit(full, dev, counters, card: str):
    """The calibration path (``repro_torch.core.fit``) at full width: the
    launcher's smoke truth (lifetime 60 us, recombination 0.75, 150 000
    electrons a depo) on the full grid and depo count, one plane, the
    default strategies for the targets, fluctuation and noise on,
    ``FIT_EVENTS`` events. Checks the self-calibration contract, the
    gradient of every fittable field, a central difference, a short Adam
    fit and the launcher's own gates; every kernel's launch counter stays
    0 (the fit graph runs the differentiable fallbacks)."""
    import torch

    from repro_torch.core import fit, prng
    from repro_torch.core.gradcheck import gradcheck
    from repro_torch.core.stages import build_sim_graph
    from repro_torch.launch import fit as fit_launcher

    t_phase = time.perf_counter()
    truth = dataclasses.replace(full, electrons_per_depo=150_000.0,
                                **fit_launcher.SMOKE_TRUTH)
    for module in counters:
        module.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)   # earlier phases' tensors
    t0 = time.perf_counter()
    targets = fit.make_fit_targets(truth, prng.key(42),
                                   num_events=FIT_EVENTS, device=dev)
    torch.cuda.synchronize()
    targets_s = time.perf_counter() - t0
    shape = (FIT_EVENTS, full.num_wires, full.num_ticks)
    check(targets.adc.dtype == torch.int16
          and tuple(targets.adc.shape) == shape,
          f"fit targets {targets.adc.dtype} {tuple(targets.adc.shape)}")
    print(f"fit targets: {FIT_EVENTS} events x {targets.batch.max_depos} "
          f"depos -> {tuple(targets.adc.shape)} int16 ADC in "
          f"{targets_s:.3f} s (strategies {truth.charge_grid_strategy} + "
          f"{truth.scatter_strategy})", flush=True)

    # the contract: the fit graph's STE ADC == the targets' int16 ADC, and
    # the loss is exactly 0 at the truth with every field a tensor
    fgraph = build_sim_graph(fit.fit_config(truth), None, device=dev)
    with torch.no_grad():
        for e in range(FIT_EVENTS):
            soft = fgraph.run(targets.keys[e], targets.batch.event(e)).adc
            check(soft.dtype == torch.float32
                  and torch.equal(soft, targets.adc[e].to(torch.float32)),
                  f"fit event {e}: the fit graph's ADC != the targets'")
    every = fit.FitSpec(params=tuple(fit.FitParam(f)
                                     for f in fit.FITTABLE_FIELDS))
    every_loss = fit.make_fit_loss(truth, every, targets, device=dev)
    with torch.no_grad():
        at_truth = float(every_loss(every.true_theta(truth, device=dev)))
    check(at_truth == 0.0, f"fit loss at the truth {at_truth} != 0")
    two = fit.FitSpec(params=tuple(fit.FitParam(f) for f in FIT_FD_FIELDS))
    two_loss = fit.make_fit_loss(truth, two, targets, device=dev)
    off = dataclasses.replace(truth, electron_lifetime_us=90.0,
                              recombination=0.6)
    with torch.no_grad():
        at_off = float(two_loss(two.true_theta(off, device=dev)))
    check(at_off > 0.0, f"fit loss off the truth {at_off} is not > 0")
    print(f"fit contract: the fit graph's ADC == the targets' int16 ADC bit "
          f"for bit ({FIT_EVENTS} events); loss at the truth (all "
          f"{every.n} fields tensors) {at_truth!r}, at lifetime 90, "
          f"recombination 0.6: {at_off:.6g}", flush=True)

    # the gradient of every fittable field at an off-truth theta
    spec = fit.spec_from_names(fit.FITTABLE_FIELDS, truth)
    theta = spec.true_theta(dataclasses.replace(truth, **{
        f: getattr(truth, f) * 1.1 for f in fit.FITTABLE_FIELDS}),
        device=dev)
    loss_fn = fit.make_fit_loss(truth, spec, targets, device=dev)
    timed_step(loss_fn, theta)                       # warm-up
    steps = [timed_step(loss_fn, theta) for _ in range(3)]
    val, grad = steps[-1][0], steps[-1][1].cpu()
    fwd_ms = statistics.median(s[2] for s in steps)
    bwd_ms = statistics.median(s[3] for s in steps)
    check(bool(torch.isfinite(grad).all()) and bool((grad != 0).all()),
          f"fit gradient not finite and non-zero: "
          f"{dict(zip(spec.fields, grad.tolist()))}")
    print(f"fit gradient at 1.1 x truth (loss {val:.6g}), all "
          f"{spec.n} fields finite and non-zero: "
          f"{dict(zip(spec.fields, grad.tolist()))}", flush=True)
    print(f"fit step at full width ({FIT_EVENTS} events, {spec.n} "
          f"fields): forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms "
          f"(median of 3, host clock with synchronise); {card}", flush=True)
    wall, busy, top = profiled(lambda: timed_step(loss_fn, theta))
    print(f"fit step under torch.profiler: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms (share {busy / wall:.2f}, a lower bound); top ops "
          f"by device ms (calls): "
          f"{', '.join(f'{k} {ms:.1f} ({n})' for k, ms, n in top)}",
          flush=True)

    # a central difference of the full chain, the reference's e2e case
    truth2 = torch.tensor([getattr(truth, f) for f in FIT_FD_FIELDS],
                          dtype=torch.float32, device=dev)
    res = gradcheck(lambda mult: two_loss(mult * truth2),
                    torch.tensor([0.9, 1.1], device=dev),
                    name="fit/full width", fields=FIT_FD_FIELDS, **FIT_FD)
    print(f"{res}; analytic {res.analytic}, numeric {res.numeric}",
          flush=True)
    check(res.ok, f"fit finite-difference check failed: {res}")

    # a short fit from 1.5 x truth, the launcher's general fit settings
    fd_spec = fit.FitSpec(params=tuple(
        fit.FitParam(f, init=1.5 * getattr(truth, f),
                     lo=getattr(truth, f) / 8, hi=getattr(truth, f) * 8)
        for f in FIT_FD_FIELDS))
    fd_loss = fit.make_fit_loss(truth, fd_spec, targets, device=dev)
    t0 = time.perf_counter()
    result = fit.run_fit(fd_loss, fd_spec, fd_spec.init_theta(truth,
                                                              device=dev),
                         steps=FIT_STEPS, lr=0.2)
    with torch.no_grad():
        final = float(fd_loss(result.theta))
    fit_s = time.perf_counter() - t0
    start = result.history[0][1]
    errors = result.relative_errors({f: getattr(truth, f)
                                     for f in FIT_FD_FIELDS})
    print(f"fit: {FIT_STEPS} Adam steps (lr 0.2) from 1.5 x truth: loss "
          f"{start:.6g} -> {final:.6g} in {fit_s:.2f} s "
          f"({fit_s / FIT_STEPS * 1e3:.1f} ms a step); values "
          f"{result.values}; relative errors {errors}", flush=True)
    check(final < 0.5 * start, f"fit: loss {start} -> {final}, not halved")

    for argv in (["--smoke"], ["--gradcheck"]):
        t0 = time.perf_counter()
        rc = fit_launcher.main(argv)
        print(f"launch.fit {' '.join(argv)}: rc {rc} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        check(rc == 0, f"launch.fit {' '.join(argv)} failed")

    launches = {name: n for module in counters
                for name, n in module.LAUNCHES.items()}
    check(not any(launches.values()), f"the fit path launched a kernel: "
          f"{launches}")
    peak = torch.cuda.max_memory_allocated(dev) - held
    wall = time.perf_counter() - t_phase
    print(f"fit phase: peak device memory {peak / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB earlier phases still hold, wall "
          f"{wall:.1f} s, no kernel launched; {card}", flush=True)


#: the fig3 cut: the per-depo loop on this many of the event's depos (the
#: whole 100 000-depo event would take seconds at its rate), one in every
#: num_depos / FIG3_DEPOS, so the cut spans every track as the event does
#: (the first 2 000 depos are four dense tracks, whose tiles overflow the
#: k_max fig4's scatter kernel sizes for 2 000 depos), and its warm-up
FIG3_DEPOS = 2000
FIG3_WARMUP_DEPOS = 200
#: fig4 runs timed beside fig3 (median)
FIG4_TIMED = 3
#: scatter strategies of the one-plane pool event (the kernel routes first)
POOL_SCATTERS = ("pallas", "pallas_compact", "xla")
#: the pool stream: events, events a batch
POOL_STREAM = (4, 2)


def parity_check(fn, *args, what: str, **kw):
    """A ``repro_torch.testing.parity`` assertion as a phase check."""
    try:
        return fn(*args, what=what, **kw)
    except AssertionError as e:
        raise PhaseError(f"{what}: outside the parity tolerance: {e}") from e


def timed_event(fn):
    """Seconds of one call of ``fn`` on the host clock, the card synced
    before and after (as run_events times an event); returns (seconds,
    the call's result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def check_fig3_pool(full, dev, counters, card: str):
    """The fig3 per-depo baseline and the pool RNG at full width.

    fig3 (``simulate`` with pipeline fig3) on ``FIG3_DEPOS`` depos of
    event 0, after a warm-up on its first ``FIG3_WARMUP_DEPOS``
    (``max_depos``), beside fig4 (unfused + pallas, no dropped entry) on
    the same depos and on all of them: ms, us a depo, depos/s; without
    fluctuation the fig3 grid == fig4's within the reference's fig3/fig4
    rule (rtol 1e-4, atol 1e-2, ADC equal on > 99.9 % of pixels). The
    card's standard pool: threefry bits == the CPU's, normals within
    ``NORMAL_ATOL``. The scatter-add kernels (rows 5-6) on pool-fluctuated
    patches against their plain versions (``check_scatter``). One pool
    event per scatter strategy (the two kernel routes equal bit for bit,
    xla within parity), a three-plane pool event with recon (row 7), an
    unfused_bf16 pool event, and a pool stream whose rows == run_events'
    bit for bit. Returns (the launches per kernel over the pool events and
    the stream, max |kernel - plain| of the dense and compact scatter)."""
    import torch

    from repro_torch.core import fluctuate as fl
    from repro_torch.core import prng
    from repro_torch.core.depo import DepoSet, generate_depos
    from repro_torch.core.pipeline import make_sim_fn, simulate
    from repro_torch.core.response import make_response
    from repro_torch.launch.sim import max_dev
    from repro_torch.testing import parity

    t_phase = time.perf_counter()
    key0 = prng.fold_in(prng.key(0), 0)
    depos = generate_depos(key0, full, device=dev)
    cut = DepoSet(*(x[::full.num_depos // FIG3_DEPOS] for x in depos))
    check(cut.n == FIG3_DEPOS, f"fig3 cut of {cut.n} depos")
    resp = make_response(full, device=dev)
    fig3 = dataclasses.replace(full, pipeline="fig3")
    simulate(key0, depos, fig3, resp=resp, device=dev,
             max_depos=FIG3_WARMUP_DEPOS)
    fig3_s, out3 = timed_event(lambda: simulate(key0, cut, fig3, resp=resp,
                                                device=dev))
    check(out3.adc.dtype == torch.int16 and tuple(out3.adc.shape)
          == (full.num_wires, full.num_ticks), f"fig3 ADC {out3.adc.dtype} "
          f"{tuple(out3.adc.shape)}")
    check(bool(torch.isfinite(out3.signal).all()), "fig3: non-finite signal")
    check(max_dev(out3.adc, full) > 0, "fig3: max dev is 0")
    fig4_cfg = dataclasses.replace(full, scatter_strategy="pallas")
    sim4 = make_sim_fn(fig4_cfg, resp=resp, device=dev)
    rates = {}
    for label, d in (("same depos", cut), ("whole event", depos)):
        sim4(key0, d)
        runs = [timed_event(lambda d=d: sim4(key0, d))
                for _ in range(FIG4_TIMED)]
        check(all(int(out.dropped) == 0 for _, out in runs),
              f"fig4 on the {label}: the binning dropped entries")
        rates[label] = (statistics.median(sec for sec, _ in runs), d.n)
        del runs
    fig3_rate = FIG3_DEPOS / fig3_s
    ratios = {label: n / sec / fig3_rate for label, (sec, n) in rates.items()}
    print(f"fig3 (per-depo host loop, pool fluctuation, noise) on "
          f"{FIG3_DEPOS} of {full.num_depos} depos (one in "
          f"{full.num_depos // FIG3_DEPOS}): {fig3_s*1e3:.3f} ms, "
          f"{fig3_s/FIG3_DEPOS*1e6:.2f} us a depo, {fig3_rate:.6g} depos/s; "
          + "; ".join(f"fig4 unfused+pallas, {label} ({n} depos): median of "
                      f"{FIG4_TIMED} {sec*1e3:.3f} ms, {sec/n*1e6:.4f} us a "
                      f"depo, {n/sec:.6g} depos/s, {ratios[label]:.4g}x fig3"
                      for label, (sec, n) in rates.items())
          + f"; {card}", flush=True)

    quiet = dataclasses.replace(fig4_cfg, fluctuate=False)
    g3 = simulate(key0, cut, dataclasses.replace(quiet, pipeline="fig3"),
                  resp=resp, add_noise=False, device=dev)
    g4 = simulate(key0, cut, quiet, resp=resp, add_noise=False, device=dev)
    check(int(g4.dropped) == 0, "fig4 without fluctuation dropped entries")
    grid_err = float((g3.charge_grid - g4.charge_grid).abs().max())
    adc_same = float((g3.adc == g4.adc).float().mean())
    print(f"fig3 vs fig4 without fluctuation on {FIG3_DEPOS} depos: max "
          f"|delta grid| {grid_err:.6g} (max |grid| "
          f"{float(g4.charge_grid.abs().max()):.6g}), ADC equal on "
          f"{adc_same:.6f} of pixels", flush=True)
    check(torch.allclose(g3.charge_grid, g4.charge_grid, rtol=1e-4,
                         atol=1e-2), "fig3 grid != fig4 grid within rtol "
          "1e-4, atol 1e-2")
    check(adc_same > 0.999, f"fig3/fig4 ADC equal on {adc_same} <= 0.999")
    del out3, g3, g4

    pool_key = prng.key(1234)
    n_pool = 1 << 20
    bits = prng.random_bits(pool_key, (n_pool,), dev).cpu()
    check(torch.equal(bits, prng.random_bits(pool_key, (n_pool,), "cpu")),
          "the card's pool bits != the CPU's")
    pool = fl.make_pool(pool_key, device=dev)
    pool_err = float((pool.cpu() - fl.make_pool(pool_key, device="cpu"))
                     .abs().max())
    print(f"make_pool(key(1234)) on the card: {n_pool} threefry words == "
          f"the CPU's; max |normal card - CPU| {pool_err:.3g} (atol "
          f"{parity.NORMAL_ATOL})", flush=True)
    check(pool_err <= parity.NORMAL_ATOL, f"pool normals differ by "
          f"{pool_err}")
    scatter_errors = check_scatter(
        ScatterCase(full, key0, 64, 256, dev, pool=pool),
        "scatter-add pool-fluctuated full width 64x256 tiles")

    launches = {}

    def counted(cfg, label, recon=False):
        adcs, ran, sim, first = run_main(cfg, label, 1, dev, counters,
                                         recon=recon, card=card)
        for name, n in ran.items():
            launches[name] = launches.get(name, 0) + n
        return adcs, ran, sim, first

    pooled = dataclasses.replace(full, rng_strategy="pool")
    firsts = {}
    for scatter in POOL_SCATTERS:
        cfg = dataclasses.replace(pooled, scatter_strategy=scatter)
        _, ran, sim, firsts[scatter] = counted(cfg, f"pool unfused+{scatter}")
        if scatter != "xla":
            check(ran[f"scatter_add_{scatter}"] == 1, f"pool {scatter}: "
                  f"launches {ran}")
        if scatter == "pallas":
            print_stages("pool unfused+pallas", sim, key0, depos)
    kernel_routes = [firsts[s] for s in POOL_SCATTERS[:2]]
    check(torch.equal(kernel_routes[0].charge_grid,
                      kernel_routes[1].charge_grid)
          and torch.equal(kernel_routes[0].adc, kernel_routes[1].adc),
          "pool event: pallas and pallas_compact differ")
    grid_frac = parity_check(
        parity.assert_close, firsts["xla"].charge_grid.cpu().numpy(),
        firsts["pallas"].charge_grid.cpu().numpy(),
        atol_frac=parity.GRID_ATOL_FRAC, what="pool event xla vs pallas grid")
    adc_frac = parity_check(
        parity.assert_adc_close, firsts["xla"].adc.cpu().numpy(),
        firsts["pallas"].adc.cpu().numpy(),
        what="pool event xla vs pallas ADC")
    print(f"pool event: pallas == pallas_compact bit for bit (grid, ADC); "
          f"xla vs pallas: max |delta grid| {grid_frac:.6g}, ADC differs on "
          f"{adc_frac:.6g} of pixels", flush=True)
    del firsts, kernel_routes

    recon_cfg = dataclasses.replace(pooled, num_planes=PLANES,
                                    scatter_strategy="pallas")
    _, ran, _, _ = counted(recon_cfg, "pool recon", recon=True)
    check(ran["hitfind_pallas"] == PLANES
          and ran["scatter_add_pallas"] == PLANES,
          f"pool recon: launches {ran}")
    bf16_cfg = dataclasses.replace(pooled, charge_grid_strategy="unfused_bf16",
                                   scatter_strategy="pallas_compact")
    _, ran, _, _ = counted(bf16_cfg, "pool unfused_bf16+pallas_compact")
    check(ran["scatter_add_pallas_compact"] == 1
          and ran["scatter_add_pallas_compact_bf16"] == 0,
          f"pool unfused_bf16: the fluctuated patches are float32, launches "
          f"{ran}")

    events, batch = POOL_STREAM
    stream_cfg = dataclasses.replace(pooled, scatter_strategy="pallas")
    expect, _ = loop_outputs(stream_cfg, events, dev, recon=False)
    _, ran, _, adcs = run_stream(stream_cfg, "pool stream", events, batch,
                                 dev, counters, expect=expect)
    check(sorted(adcs) == list(range(events))
          and ran.get("scatter_add_pallas") == events,
          f"pool stream: rows {sorted(adcs)}, launches {ran}")
    for name, n in ran.items():
        launches[name] = launches.get(name, 0) + n
    print(f"pool stream: {events} events, {batch} a batch: every row == "
          f"run_events' event bit for bit (ADC, grid, signal); launches "
          f"{ran}", flush=True)
    print(f"fig3 and pool phase: launches {launches}, wall "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return launches, scatter_errors


#: timed runs of the distributed event and of run_events beside it
DIST_TIMED = 3


def check_distributed(full, dev, card: str):
    """The distributed executor (``repro_torch.core.distributed``) on one
    NCCL group at world size 1 (a ``FileStore`` in a temporary directory,
    destroyed at the end) at full width: one plane, ``psum_scatter``, noise
    and fluctuation off, against the reference test's card-side cyclic
    construction (rasterize, the ``xla`` scatter, ``rfft2`` x response at
    (W_pad, T), digitize) under the +-1 rule; ``halo`` against
    ``psum_scatter`` on the same event (a ring of one: the overhangs added
    back by a local copy); noise and fluctuation on, two runs bit for bit;
    three planes with recon, stacked and loop (equal bit for bit), the hit
    scan (row 7) launched once a plane in each run, each plane's hits ==
    the plain scan's on the gathered decon with the padding wires zeroed,
    bit for bit; ``launch.fit --grad-smoke --devices 1`` passes and
    ``launch.distributed`` with more ranks than cards raises. Prints the
    distributed event's ms beside ``run_events`` at the same config.
    Returns the hit-scan launches of the distributed recon runs."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import AXES

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = DeviceMesh("cuda", torch.tensor([[0]]),
                              mesh_dim_names=AXES)
            launches = distributed_checks(full, dev, mesh, card)
        finally:
            dist.destroy_process_group()
    print(f"distributed phase: hit-scan launches {launches}, wall "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return launches


def distributed_checks(full, dev, mesh, card: str):
    import torch

    from repro_torch.core import prng
    from repro_torch.core.depo import generate_depos, generate_physical_depos
    from repro_torch.core.distributed import make_distributed_sim
    from repro_torch.core.fft_conv import digitize
    from repro_torch.core.hitfind import HitSet, find_hits
    from repro_torch.core.pipeline import make_sim_fn
    from repro_torch.core.rasterize import rasterize
    from repro_torch.core.scatter import scatter_add
    from repro_torch.kernels.hitfind import kernel as hit_kernel
    from repro_torch.launch import distributed as launch_dist
    from repro_torch.launch import fit as launch_fit
    from repro_torch.launch.sim import max_dev, run_events
    from repro_torch.testing import parity

    w, t = full.num_wires, full.num_ticks
    key0 = prng.fold_in(prng.key(0), 0)
    depos = generate_depos(key0, full, device=dev)
    quiet = dataclasses.replace(full, fluctuate=False)
    resp, _ = launch_dist.event_inputs(mesh, quiet, depos)
    w_pad = resp.freq.shape[0]
    psum = launch_dist.distributed_event(mesh, quiet, key0, depos,
                                         add_noise=False)
    patches, w0, t0 = rasterize(depos, quiet)
    grid, _ = scatter_add(patches, w0, t0, quiet, strategy="xla")
    gpad = torch.zeros((w_pad, t), dtype=torch.float32, device=dev)
    gpad[:w] = grid
    sig = torch.fft.irfft2(torch.fft.rfft2(gpad) * resp.freq,
                           s=(w_pad, t))[:w]
    ref_adc = digitize(sig.to(torch.float32), quiet)
    del patches, gpad, sig
    exact = float((psum.adc[:w] == ref_adc).float().mean())
    parity_check(parity.assert_adc_close, psum.adc[:w].cpu().numpy(),
                 ref_adc.cpu().numpy(), what="distributed psum_scatter vs "
                 "the cyclic reference")
    grid_err = float((psum.charge_grid[:w] - grid).abs().max())
    print(f"distributed one plane psum_scatter (noise, fluctuation off), "
          f"grid ({w_pad}, {t}): ADC == the card-side cyclic reference on "
          f"{exact:.7f} of pixels (+-1 rule: |delta| <= "
          f"{parity.ADC_MAX_DELTA} on <= {parity.ADC_MAX_FRAC} of pixels); "
          f"max |grid - single scatter| {grid_err:.6g}; {card}", flush=True)

    halo = launch_dist.distributed_event(mesh, quiet, key0, depos, "halo",
                                         add_noise=False)
    halo_frac = parity_check(parity.assert_adc_close,
                             halo.adc.cpu().numpy(), psum.adc.cpu().numpy(),
                             what="distributed halo vs psum_scatter")
    print(f"distributed halo vs psum_scatter: ADC differs on {halo_frac:.6g} "
          f"of pixels, bit for bit: grid "
          f"{torch.equal(halo.charge_grid, psum.charge_grid)}, ADC "
          f"{torch.equal(halo.adc, psum.adc)}", flush=True)
    del psum, halo

    runs = [launch_dist.distributed_event(mesh, full, key0, depos)
            for _ in range(2)]
    check(torch.equal(runs[0].adc, runs[1].adc)
          and torch.equal(runs[0].signal, runs[1].signal)
          and torch.equal(runs[0].charge_grid, runs[1].charge_grid),
          "distributed event with noise and fluctuation: two runs differ")
    check(max_dev(runs[0].adc[:w], full) > 0, "distributed: max dev 0")
    print("distributed one plane, noise and fluctuation on: two runs bit "
          "for bit (grid, signal, ADC)", flush=True)
    del runs

    pdepos = generate_physical_depos(key0, full, device=dev)
    outs, launches = {}, {}
    for mode in ("stacked", "loop"):
        cfg3 = dataclasses.replace(full, num_planes=PLANES,
                                   plane_batching=mode)
        hit_kernel.reset_launches()
        outs[mode] = launch_dist.distributed_event(mesh, cfg3, key0, pdepos,
                                                   recon=True)
        torch.cuda.synchronize()
        launches[mode] = hit_kernel.LAUNCHES["hitfind_pallas"]
        check(launches[mode] == PLANES, f"distributed recon {mode}: "
              f"hit-scan launches {launches[mode]} != {PLANES}")
    same = all(torch.equal(a, b) for a, b in zip(
        outs["stacked"][:3] + (outs["stacked"].decon,) + tuple(
            outs["stacked"].hits),
        outs["loop"][:3] + (outs["loop"].decon,) + tuple(outs["loop"].hits)))
    check(same, "distributed recon: stacked and loop differ")
    got = outs["stacked"]
    real = (torch.arange(w_pad, device=dev) < w)[:, None]
    stored = []
    for p in range(PLANES):
        masked = torch.where(real, got.decon[p], torch.zeros_like(
            got.decon[p]))
        plain = find_hits(masked, cfg3, "scan")
        for f, a, b in zip(HitSet._fields, (x[p] for x in got.hits), plain):
            check(torch.equal(a, b), f"distributed recon plane {p}: hits."
                  f"{f} != the plain scan's on the gathered decon")
        stored.append((int(plain.mask.sum()), int(plain.n_hits)))
    print(f"distributed three planes with recon: stacked == loop bit for "
          f"bit (ADC, signal, grid, decon, hits); hit-scan launches "
          f"{launches}; every plane's hits == the plain scan's on the "
          f"gathered decon (padding wires zeroed) bit for bit; (stored, "
          f"found) per plane {stored}; {card}", flush=True)
    del outs, got

    timings = {}
    cfg3 = dataclasses.replace(full, num_planes=PLANES)
    for label, cfg, d, recon in (("one plane", full, depos, False),
                                 ("three planes + recon", cfg3, pdepos,
                                  True)):
        resp, block = launch_dist.event_inputs(mesh, cfg, d)
        sim = make_distributed_sim(mesh, cfg, resp, recon=recon)
        sim(key0, block)
        dist_s = statistics.median(timed_event(lambda: sim(key0, block))[0]
                                   for _ in range(DIST_TIMED))
        stats = run_events(cfg, DIST_TIMED, seed=0, device=dev,
                           sim=make_sim_fn(cfg, device=dev, recon=recon))
        loop_s = statistics.median(stats["event_s"])
        timings[label] = (dist_s, loop_s)
        print(f"distributed event, {label}, world size 1 (rasterize, "
              f"counter fluctuation, xla scatter, pencil FFT, noise"
              f"{', recon' if recon else ''}): median of {DIST_TIMED} "
              f"{dist_s*1e3:.3f} ms; run_events at the same config "
              f"(default strategies): median {loop_s*1e3:.3f} ms; {card}",
              flush=True)
        del sim, block

    check(launch_fit.main(["--grad-smoke", "--devices", "1"]) == 0,
          "launch.fit --grad-smoke --devices 1 failed")
    cards = torch.cuda.device_count()
    try:
        launch_dist.main(["--devices", str(cards + 1), "--device", "cuda"])
    except RuntimeError as e:
        check(f"{cards + 1} CUDA devices, but {cards}" in str(e),
              f"launch.distributed refused {cards + 1} ranks without "
              f"naming the counts: {e}")
        print(f"launch.distributed --devices {cards + 1} on {cards} card(s) "
              f"raises: {e}", flush=True)
    else:
        raise PhaseError(f"launch.distributed ran {cards + 1} ranks on "
                         f"{cards} card(s)")
    return launches


#: the audit phase's programs (``repro_torch.analysis.audit``) at full
#: width, and its stream: events, events a batch
AUDIT_RUNS = (("single_fused", 1), ("recon_kernels", 3))
AUDIT_STREAM = (4, 4)
#: the text of torch's sync debug warning
SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def card_waits():
    """Count, by site (the census's rule), every wait for the card that
    torch's sync debug mode reports inside the block: yields the Counter.
    It reports the copies and reads that synchronise a stream (``.item()``,
    ``.tolist()``, ``.cpu()``, data-sized outputs, pageable copies either
    way), not ``torch.cuda.synchronize()`` or ``Event.synchronize()``."""
    import collections
    import warnings

    import torch

    from repro_torch.analysis.census import site

    waits = collections.Counter()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            waits[site()] += 1
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield waits
        finally:
            torch.cuda.set_sync_debug_mode("default")


def audit_run(label: str, fn, events: int, runs: list, problems: list):
    """Run ``fn()`` once under ``card_waits`` and a ``Census`` and hold it
    to (a) and (c): every wait the card reports sits at a site the census
    recorded, with as many reads of card tensors there, and float64 is
    written only at ``ALLOWED_F64``'s sites. Appends (label, census,
    waits, events) to ``runs`` and what fails to ``problems``; returns the
    census."""
    import torch

    from repro_torch.analysis.audit import ALLOWED_F64
    from repro_torch.analysis.census import Census

    with card_waits() as waits, Census() as census:
        fn()
        torch.cuda.synchronize()
    reads = census.device_reads("cuda")
    differ = {where: (reads.get(where, 0), waits.get(where, 0))
              for where in set(reads) | set(waits)
              if reads.get(where, 0) != waits.get(where, 0)}
    if differ:
        problems.append(f"{label}: census reads of card tensors != the "
                        f"card's waits at {differ} (census, card)")
    bad = set(census.f64_bytes) - set(ALLOWED_F64)
    if bad:
        problems.append(f"{label}: float64 written outside ALLOWED_F64 at "
                        f"{sorted(bad)}")
    runs.append((label, census, waits, events))
    print(f"audit {label}: {sum(waits.values())} waits on the card at "
          f"{len(waits)} site(s){'' if differ else ', == the census'}; "
          f"kernels {dict(census.kernels)}; collectives "
          f"{dict(census.collectives)}", flush=True)
    return census


def check_audit(dev, card: str) -> None:
    """The "audit" phase: ``single_fused`` (one plane) and
    ``recon_kernels`` (three planes) of ``repro_torch.analysis.audit`` at
    full width, two calls each; a stream of 4 events, 4 a batch
    (``fused_pallas``); ``distributed_psum`` on one NCCL rank, two calls.
    Each run under ``torch.cuda.set_sync_debug_mode("warn")`` and a
    ``Census``: (a) every wait the card reports sits at a census site with
    the census's count of card-tensor reads there; (b) the launches equal
    the committed baseline's ``kernels`` of the program (the stream: one
    fused launch per ceil(rows / 16) a batch, nothing else), the two calls
    of a program have one census, and a program reads the host only at
    ``KNOWN_HOST_SYNCS``; (c) float64 only at ``ALLOWED_F64``, its bytes
    an event printed per site; (d) the phase's wall time. Prints every
    host-read site as "wait" or "host tensor", then fails on every
    problem found."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.analysis import audit
    from repro_torch.core.distributed import AXES
    from repro_torch.launch.sim import stream_simulate

    t_phase = time.perf_counter()
    baseline = audit.load_baseline(str(ROOT / audit.DEFAULT_BASELINE))
    runs, problems = [], []

    def program(name: str, planes: int, **kw) -> None:
        prog = audit.program_named(name)
        ctx = audit.context_for(prog, planes, device=str(dev), smoke=False,
                                **kw)
        fn, make_args = prog.build(ctx)
        label = f"p{planes}/{name}"
        want = baseline[label]
        contracts = []
        for i in range(2):
            args = make_args(i)
            contract = audit_run(f"{label} call {i}", lambda: fn(*args), 1,
                                 runs, problems).contract()
            for field in ("kernels", "collectives"):
                if contract[field] != want[field]:
                    problems.append(f"{label} call {i}: {field} "
                                    f"{contract[field]} != the baseline's "
                                    f"{want[field]}")
            unknown = set(contract["host_syncs"]) - set(
                audit.KNOWN_HOST_SYNCS)
            if unknown:
                problems.append(f"{label} call {i}: host reads at "
                                f"{sorted(unknown)}, outside "
                                "KNOWN_HOST_SYNCS")
            contracts.append(contract)
        if contracts[0] != contracts[1]:
            problems.append(f"{label}: the second call's census differs: "
                            f"{contracts}")

    for name, planes in AUDIT_RUNS:
        program(name, planes)
    events, per_batch = AUDIT_STREAM
    cfg = audit.audit_config(1, smoke=False,
                             charge_grid_strategy="fused_pallas")
    census = audit_run(f"stream {events} events {per_batch} a batch",
                       lambda: stream_simulate(cfg, events, per_batch,
                                               device=dev),
                       events, runs, problems)
    batches = -(-events // per_batch)
    want = {"fused_rasterize_scatter": batches * -(-per_batch // 16)}
    if dict(census.kernels) != want:
        problems.append(f"stream: launches {dict(census.kernels)} != "
                        f"ceil(rows / 16) a batch: {want}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_audit_") as tmp:
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = DeviceMesh("cuda", torch.tensor([[0]]),
                              mesh_dim_names=AXES)
            program("distributed_psum", 1, mesh=mesh)
        finally:
            dist.destroy_process_group()

    verdicts = {}
    for label, census, waits, n_events in runs:
        for where, ops in census.host_syncs.items():
            waited = any(op.endswith("@cuda") for op in ops)
            verdicts.setdefault(where, set()).add(
                "wait" if waited else "host tensor")
            print(f"audit {label}: {where} {dict(ops)} -> "
                  f"{'wait' if waited else 'host tensor'} (card waits "
                  f"{waits.get(where, 0)})")
        for where, nbytes in census.f64_bytes.items():
            print(f"audit {label}: float64 {nbytes / n_events:.0f} B an "
                  f"event at {where}")
    for where in sorted(verdicts):
        print(f"audit host-read site {where}: "
              f"{' / '.join(sorted(verdicts[where]))}")
    print(f"audit phase: wall {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)
    check(not problems, "audit: " + "; ".join(problems))


#: the serve phase: gemma2-2b at full width through launch.serve.run.
#: (A) waves: 8 requests, 4 slots, prompt 128, 32 new tokens, max_len 256;
#: (B) one long request: prompt 4 608, 16 new tokens, max_len 4 672 (the
#: local layers' 4 096-token window masks its first 512 positions)
SERVE_ARCH = "gemma2-2b"
SERVE_WAVES = dict(requests=8, slots=4, prompt_len=128, new_tokens=32,
                   max_len=256)
SERVE_LONG = dict(requests=1, slots=1, prompt_len=4608, new_tokens=16,
                  max_len=4672)
#: card against CPU: the qwen3 smoke config in float32, logits within this
SERVE_CPU_ATOL = 1e-4


def serve_args(arch: str, smoke: bool, device: str, **traffic):
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--smoke" if smoke else "--no-smoke",
            "--device", device]
    for name, value in traffic.items():
        argv += [f"--{name.replace('_', '-')}", str(value)]
    return serve.build_parser().parse_args(argv)


@contextlib.contextmanager
def captured_logits(model):
    """Record (tokens fed, start index, last-position logits, MoE
    ``routing_log`` entries) of every ``prefill`` and ``decode_step`` of
    ``model`` inside the block (card tensors, read after the block)."""
    from repro_torch.models import moe

    rec = []
    prefill, decode = model.prefill, model.decode_step
    saved = {k: model.__dict__[k] for k in ("prefill", "decode_step")
             if k in model.__dict__}

    def prefill_(params, batch, caches):
        with moe.routing_log() as log:
            out = prefill(params, batch, caches)
        rec.append((batch["tokens"], 0, out[0][:, -1].clone(), log))
        return out

    def decode_(params, batch, caches, index, extras=None):
        with moe.routing_log() as log:
            out = decode(params, batch, caches, index, extras)
        rec.append((batch["tokens"], index, out[0][:, -1].clone(), log))
        return out

    model.prefill, model.decode_step = prefill_, decode_
    try:
        yield rec
    finally:
        del model.prefill, model.decode_step
        for name, fn in saved.items():
            setattr(model, name, fn)


def serve_run(args, model, dev):
    """One launch.serve.run of ``model`` with its logits recorded and the
    card's peak memory of the run."""
    import torch

    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats(dev)
    with captured_logits(model) as rec:
        done, stats = serve.run(args, model=model)
    stats["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return done, stats, rec


@contextlib.contextmanager
def replayed_routing(calls, b: int, n: int):
    """Inside the block, the forward over the ``n`` positions fed so far
    takes in every MoE layer the experts the cache path chose (``calls``:
    the ``routing_log`` of the prefill and of each decode step so far); each
    position where the forward's own top-k differs must sit at a near-tie
    (``parity.moe_flips``: the two paths' bfloat16 roundings of the
    router's input cross it). Yields a one-item list: the count of such
    (position, layer) rows."""
    import numpy as np
    import torch

    from repro_torch.models import moe
    from repro_torch.testing import parity

    layers = []
    for entries in zip(*calls):
        ids = torch.cat([e["ids"].reshape(b, -1, e["ids"].shape[-1])
                         for e in entries], dim=1)[:, :n]
        probs = torch.cat([e["probs"].reshape(b, -1, e["probs"].shape[-1])
                           for e in entries], dim=1)[:, :n]
        layers.append((ids.reshape(b * n, -1), probs.reshape(b * n, -1)))
    queue = iter(layers)
    route = moe.route
    flips = [0]

    def replay(router, xf, top_k):
        probs, _, own = route(router, xf, top_k)
        ids, cache_probs = next(queue)
        flips[0] += int(np.sum(parity.moe_flips(
            ids.cpu().numpy(), own.cpu().numpy(),
            cache_probs.cpu().numpy(), probs.cpu().numpy())))
        weights = torch.gather(probs, 1, ids)
        return probs, weights / torch.sum(weights, dim=-1, keepdim=True), ids

    moe.route = replay
    try:
        yield flips
    finally:
        moe.route = route


def cache_vs_forward(model, params, rec, steps: int, tol_frac: float,
                     chunk: int = 1, extra=None, label: str = "serve"):
    """The first ``steps`` recorded calls (a prefill and the decode steps
    of its wave) against ``Model.forward`` over the tokens fed so far: the
    logits at the last fed position. ``chunk``: the forward runs over the
    tokens padded at the end to a multiple of it where they exceed it
    (mamba2's SSD chunk; the model is causal, so the padding leaves the
    earlier positions as they are); ``extra``: more batch entries (an
    enc-dec model's ``enc_embeds``). An MoE model's forward replays each
    recorded call's routing (``replayed_routing``). Returns (max
    |delta logit|, max |logit|, argmax agreements, steps, MoE rows whose
    own choice the forward replaced at a near-tie)."""
    import torch

    vocab = model.cfg.vocab_size
    routes = [r[3] for r in rec] if model.cfg.moe is not None else None
    seq = None
    worst, top, agree, flips = 0.0, 0.0, 0, 0
    for j, (tokens, _, logits, _) in enumerate(rec[:steps]):
        seq = tokens if seq is None else torch.cat([seq, tokens], dim=1)
        b, n = seq.shape
        pad = -n % chunk if n > chunk else 0
        with contextlib.ExitStack() as stack:
            if routes is not None:
                replaced = stack.enter_context(
                    replayed_routing(routes[:j + 1], b, n))
            full, _ = model.forward(params, {
                "tokens": torch.nn.functional.pad(seq, (0, pad)),
                **(extra or {})})
        if routes is not None:
            flips += replaced[0]
        ref = full[:, n - 1, :vocab].float()
        got = logits[:, :vocab].float()
        worst = max(worst, (got - ref).abs().max().item())
        top = max(top, ref.abs().max().item())
        agree += int((got.argmax(-1) == ref.argmax(-1)).all().item())
        del full
    check(worst <= tol_frac * top,
          f"{label}: decode_step logits differ from the forward's by "
          f"{worst} > {tol_frac:.4g} x max|logit| {top}")
    return worst, top, agree, min(steps, len(rec)), flips


def check_serve(dev, card: str) -> None:
    """The "serve" phase: gemma2-2b at full width (26 layers, d_model 2304,
    vocab 256 000, bfloat16 activations, float32 parameters drawn on the
    card from prng.key(0)) through ``launch.serve.run``: traffic (A) twice
    and (B) once. Checks, each failing the run: (1) at (B)'s layer-0
    q/k/v the blockwise flash attention == the direct form within
    BF16_RTOL x max|v| (a probability rounded to bfloat16 before the PV
    product moves an output by at most 2**-9 of sum p|v| on either side,
    and each side's output rounding by 2**-9 of it); (2) at every step of
    (A)'s first wave and of (B), decode_step's logits == Model.forward's
    last position over the tokens fed so far, within
    ``parity.lm_bf16_atol_frac(26)`` of max|logit|; (3) two runs of (A)
    give bit-identical tokens and final logits; (4) the qwen3 smoke config
    in float32 gives equal tokens on the card and on the CPU, logits
    within SERVE_CPU_ATOL. Prints init seconds, parameter bytes, peak
    memory, prefill ms, decode ms a step (median), tokens/s and decode's
    bytes bound, each beside the card's name and power limit, and the
    device busy share of one wave under torch.profiler."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.testing import parity

    t_phase = time.perf_counter()
    torch.zeros((), device=dev)     # the allocator's state exists from here
    held = torch.cuda.memory_allocated(dev)
    waves = serve_args(SERVE_ARCH, False, str(dev), **SERVE_WAVES)
    long_ = serve_args(SERVE_ARCH, False, str(dev), **SERVE_LONG)
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = serve.build_model(waves)
    init_peak = torch.cuda.max_memory_allocated(dev)
    params = model.params()
    cfg = model.cfg
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    print(f"serve: {cfg.name} at full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} "
          f"activations, {cfg.param_dtype} parameters): init {init_s:.2f} s "
          f"on the card, parameter bytes {param_bytes} "
          f"({param_bytes / 1e9:.3f} GB), peak memory of the draw "
          f"{(init_peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f}"
          f" GiB earlier phases hold; {card}", flush=True)

    tol = parity.lm_bf16_atol_frac(cfg.num_layers)
    runs = []
    for label, args in (("A", waves), ("B", long_), ("A again", waves)):
        done, stats, rec = serve_run(args, model, dev)
        runs.append((label, args, done, stats, rec))
        kv_bytes = (2 * cfg.num_layers * args.slots * args.max_len
                    * cfg.num_kv_heads * cfg.resolved_head_dim
                    * torch.finfo(L.dtype_of(cfg.dtype)).bits // 8)
        bound_ms = (param_bytes + kv_bytes) / PEAK_BYTES_S * 1e3
        print(f"serve ({label}): {args.requests} requests x prompt "
              f"{args.prompt_len} + {args.new_tokens} new tokens, "
              f"{args.slots} slots, max_len {args.max_len}: "
              f"{stats['tokens']} tokens in {stats['seconds']:.3f} s, "
              f"{stats['tokens_per_s']:.1f} tokens/s; prefill ms "
              f"{', '.join(f'{t:.1f}' for t in stats['prefill_ms'])}; "
              f"decode {stats['decode_ms_median']:.3f} ms a step (median "
              f"of {len(stats['decode_ms'])}; min "
              f"{min(stats['decode_ms']):.3f}, max "
              f"{max(stats['decode_ms']):.3f}); decode bytes bound "
              f"{bound_ms:.3f} ms (float32 parameters {param_bytes} B + KV "
              f"cache {kv_bytes} B at {PEAK_BYTES_S / 1e12:.2f} TB/s); peak "
              f"memory {stats['peak_bytes'] / 2**30:.2f} GiB (the "
              f"{held / 2**30:.2f} GiB of earlier phases included); {card}",
              flush=True)

    # (1) blockwise against direct at (B)'s layer-0 q/k/v
    prompt = torch.from_numpy(np.stack(
        [r.prompt for r in serve.make_requests(long_, cfg.vocab_size)])).to(
        dev)
    with torch.no_grad():
        layer = {k: v[0] for k, v in params["layers"]["mix"].items()}
        x = L.embed(params["embed"], prompt, cfg)
        h = L.apply_norm({"scale": params["layers"]["ln_mix"]["scale"][0]},
                         x, cfg.norm_kind)
        pos = torch.arange(prompt.shape[1], dtype=torch.int32,
                           device=dev)[None]
        cos, sin = L.rope_table(pos, cfg.resolved_head_dim, cfg.rope_theta)
        q = L.apply_rope(attn._project(h, layer["wq"]), cos, sin)
        k = L.apply_rope(attn._project(h, layer["wk"]), cos, sin)
        v = attn._project(h, layer["wv"])
        window = cfg.window_size
        blockwise = attn.flash_attention(
            q, k, v, pos, pos, causal=True, window=window,
            logit_cap=cfg.attn_logit_softcap)
        direct = attn._direct_attention(
            q, k, v, pos, pos, causal=True, window=window,
            logit_cap=cfg.attn_logit_softcap, kv_valid=None)
        diff = (blockwise.float() - direct.float()).abs().max().item()
        vmax = v.float().abs().max().item()
    check(diff <= parity.BF16_RTOL * vmax,
          f"serve: blockwise flash differs from direct attention by {diff} "
          f"> 2**-7 x max|v| {vmax}")
    print(f"serve check 1, blockwise == direct at (B)'s layer 0 (q "
          f"{tuple(q.shape)}, Hkv {k.shape[2]}, cap "
          f"{cfg.attn_logit_softcap}, window {window}): max |delta| {diff} "
          f"<= 2**-7 x max|v| = {parity.BF16_RTOL * vmax}", flush=True)
    del q, k, v, blockwise, direct, x, h

    # (2) cache against forward: (A)'s first wave and (B)
    with torch.no_grad():
        for (label, args, _, _, rec) in runs[:2]:
            worst, top, agree, n, _ = cache_vs_forward(
                model, params, rec, args.new_tokens, tol)
            print(f"serve check 2 ({label}, first wave): decode_step logits "
                  f"== the forward's last position at {n} steps: max "
                  f"|delta logit| {worst} <= {tol:.5f} x max|logit| {top} = "
                  f"{tol * top:.4f}; argmax equal at {agree} of {n} steps",
                  flush=True)

    # (3) repeatability: two runs of (A)
    a1, a2 = runs[0], runs[2]
    same_tokens = [r.out_tokens for r in a1[2]] == [r.out_tokens
                                                    for r in a2[2]]
    same_logits = torch.equal(a1[4][-1][2], a2[4][-1][2])
    check(same_tokens and same_logits,
          f"serve: two runs of (A) differ (tokens equal {same_tokens}, "
          f"final logits equal {same_logits})")
    print(f"serve check 3: two runs of (A) give identical tokens and final "
          f"logits (bit for bit)", flush=True)

    # where the time goes: one wave of (A)'s shape, 8 new tokens
    prof = serve_args(SERVE_ARCH, False, str(dev), requests=4, slots=4,
                      prompt_len=128, new_tokens=8, max_len=256)
    wall, busy, top = profiled(lambda: serve.run(prof, model=model))
    print(f"serve profile, one wave of 4 x (128 + 8) under torch.profiler: "
          f"{busy:.3f} ms of CUDA activity in {wall:.3f} ms (host clock, "
          f"synchronised), busy share {busy / wall:.4f}; ops with the most "
          f"device time: " + "; ".join(f"{k} {ms:.3f} ms x{n}"
                                       for k, ms, n in top) + f"; {card}",
          flush=True)
    del runs, a1, a2, params, model
    torch.cuda.empty_cache()

    # (4) card against CPU: qwen3 smoke in float32
    small = dc.replace(get_config("qwen3-32b", smoke=True), dtype="float32")
    outs = []
    for device in (str(dev), "cpu"):
        m = Model(small, device)
        m.init(prng.key(0))
        args = serve_args("qwen3-32b", True, device)
        with captured_logits(m) as rec:
            done, _ = serve.run(args, model=m)
        outs.append(([r.out_tokens for r in done],
                     torch.stack([r[2].float().cpu() for r in rec])))
    cpu_diff = (outs[0][1] - outs[1][1]).abs().max().item()
    check(outs[0][0] == outs[1][0] and cpu_diff <= SERVE_CPU_ATOL,
          f"serve: qwen3 smoke float32 on the card against the CPU: tokens "
          f"equal {outs[0][0] == outs[1][0]}, max |delta logit| {cpu_diff}")
    print(f"serve check 4: qwen3 smoke float32, {len(outs[0][0])} requests: "
          f"tokens equal on the card and the CPU, max |delta logit| "
          f"{cpu_diff} <= {SERVE_CPU_ATOL}", flush=True)
    print(f"serve phase: wall {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)


#: the families phase (ROADMAP item 17(b)): the moe (GQA and MLA), ssm,
#: hybrid and enc-dec families at full width, float32 parameters drawn on
#: the card from prng.key(0), bfloat16 activations. (A) is the serve
#: phase's waves (8 requests x 128 + 32, 4 slots, max_len 256); (A') the
#: same at capacity factor E / k, where every expert's capacity is at least
#: the token count and nothing drops; (B) one long request: mamba2's 3 840
#: prompt is 15 SSD chunks of 256, recurrentgemma's 2 560 has its 2 048
#: window mask the first 512 positions (its bulk prefill keeps the last
#: 2 048)
FAMILY_MOE = "deepseek-moe-16b"
FAMILY_LONG = {
    "mamba2-780m": dict(requests=1, slots=1, prompt_len=3840, new_tokens=16,
                        max_len=3856),
    "recurrentgemma-2b": dict(requests=1, slots=1, prompt_len=2560,
                              new_tokens=16, max_len=2576)}
#: deepseek-v2's widths at 2 of its 60 layers (a dense MLA layer and an
#: MLA + 160-expert layer; 60 layers, 240.6 G parameters, do not fit one
#: card), (A') traffic with 2 requests
V2_LAYERS = 2
V2_WAVES = dict(SERVE_WAVES, requests=2)
#: seamless, driven through Model.prefill / decode_step (the engine
#: refuses enc-dec, as the reference's fails on it): sequences, encoder
#: frames from a numpy seed, decoder prompt, greedy tokens
SEAMLESS = dict(batch=2, frames=1024, prompt=64, new=16)
#: the card-against-CPU configs, smoke size in float32
FAMILY_SMOKE = ("deepseek-moe-16b", "deepseek-v2-236b", "mamba2-780m",
                "recurrentgemma-2b", "seamless-m4t-large-v2")
def tree_bytes(tree) -> int:
    """Bytes of every tensor in a nested dict / NamedTuple tree."""
    import torch

    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def cache_bytes(cfg, slots: int, max_len: int) -> int:
    """Bytes of the decode caches of ``slots`` x ``max_len`` (meta
    tensors: nothing allocated)."""
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import init_caches

    return tree_bytes(init_caches(cfg, slots, max_len,
                                  L.dtype_of(cfg.dtype), "meta"))


def no_drop(cfg):
    """``cfg`` at capacity factor E / k: every expert's capacity is at
    least the token count, so no (token, expert) pair drops."""
    import dataclasses as dc

    m = cfg.moe
    return dc.replace(cfg, moe=dc.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def decode_waits(model, params, dev):
    """One ``decode_step`` after an 8-token prefill of 2 sequences, under
    the card's wait count (``card_waits``): the Counter of waits by
    site."""
    import torch

    batch = {"tokens": torch.zeros((2, 8), dtype=torch.int32, device=dev)}
    if model.is_encdec:
        batch["enc_embeds"] = torch.zeros((2, 16, model.cfg.d_model),
                                          device=dev)
    with torch.no_grad():
        caches = model.init_caches(2, 32)
        _, caches, extras = model.prefill(params, batch, caches)
        torch.cuda.synchronize(dev)
        with card_waits() as waits:
            model.decode_step(params, {"tokens": batch["tokens"][:, :1]},
                              caches, 8, extras)
            torch.cuda.synchronize(dev)
    return waits


def print_run(label: str, args, stats, bound_bytes, bounds, card) -> None:
    """One serve run's line: tokens/s, prefill ms, decode ms a step
    (median, range), the decode bytes bounds, peak memory."""
    dec = stats["decode_ms"]
    print(f"families {label}: {args.requests} requests x prompt "
          f"{args.prompt_len} + {args.new_tokens} new tokens, {args.slots} "
          f"slots, max_len {args.max_len}: {stats['tokens']} tokens in "
          f"{stats['seconds']:.3f} s, {stats['tokens_per_s']:.1f} tokens/s;"
          f" prefill ms {', '.join(f'{t:.1f}' for t in stats['prefill_ms'])}"
          f"; decode {statistics.median(dec):.3f} ms a step (median of "
          f"{len(dec)}; min {min(dec):.3f}, max {max(dec):.3f}); decode "
          f"bytes bound " + "; ".join(
              f"{name} {nbytes / PEAK_BYTES_S * 1e3:.3f} ms ({nbytes} B)"
              for name, nbytes in bounds) + f" at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s (caches {bound_bytes} B "
          f"included); peak memory {stats['peak_bytes'] / 2**30:.2f} GiB; "
          f"{card}", flush=True)


def print_model(model, init_s, init_peak, held, card) -> int:
    cfg = model.cfg
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    print(f"families {cfg.name}: {cfg.family}, {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} "
          f"activations, {cfg.param_dtype} parameters: init {init_s:.2f} s "
          f"on the card, parameter bytes {param_bytes} "
          f"({param_bytes / 1e9:.3f} GB), peak memory of the draw "
          f"{(init_peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB held before; {card}", flush=True)
    return param_bytes


def drawn(cfg, dev):
    """(Model of ``cfg`` on ``dev`` with parameters from prng.key(0), draw
    seconds, peak bytes of the draw)."""
    import torch

    from repro_torch.core import prng
    from repro_torch.models.model import Model

    torch.cuda.reset_peak_memory_stats(dev)
    model = Model(cfg, dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    model.init(prng.key(0))
    torch.cuda.synchronize(dev)
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated(dev)


def check_cache(label, model, params, rec, args, chunk=1, extra=None,
                tol=None):
    """Check 1 on one recorded wave, printed: within ``tol`` of max|logit|
    (default ``parity.lm_bf16_atol_frac(L)``; inf prints the distance
    without a check)."""
    import torch

    from repro_torch.testing import parity

    if tol is None:
        tol = parity.lm_bf16_atol_frac(model.cfg.num_layers)
    with torch.no_grad():
        worst, top, agree, n, flips = cache_vs_forward(
            model, params, rec, args.new_tokens, tol, chunk=chunk,
            extra=extra, label=f"families {label}")
    print(f"families check 1 ({label}, first wave, {model.cfg.dtype}): "
          f"decode_step logits == the forward's at the same position at {n} "
          f"steps"
          + (f" (the forward over the tokens padded at the end to a "
             f"multiple of {chunk}: the model is causal, so the padding "
             f"leaves the earlier positions as they are)" if chunk > 1
             else "")
          + (f": max |delta logit| {worst} = {worst / top:.4g} x max|logit| "
             f"{top} (printed, not checked)" if tol == float("inf") else
             f": max |delta logit| {worst} <= {tol:.5g} x max|logit| {top} = "
             f"{tol * top:.4g}") + f"; argmax equal at {agree} of {n} steps"
          + (f"; the forward replays the cache path's experts (its own "
             f"top-k differed at {flips} (position, layer) rows, each a "
             f"near-tie)" if model.cfg.moe is not None else ""), flush=True)


def check_waits(label, model, params, dev) -> None:
    """Check 4: 0 waits inside one decode_step."""
    waits = decode_waits(model, params, dev)
    check(not waits, f"families {label}: decode_step waits for the card "
          f"at {dict(waits)}")
    print(f"families check 4 ({label}): one decode_step under "
          f"set_sync_debug_mode: 0 waits", flush=True)


def family_serve(label, model, args, dev):
    """One launch.serve.run of ``model``: (requests, stats with the run's
    peak memory, recorded calls, each prefill's dropped MoE pairs)."""
    from repro_torch.models import moe

    done, stats, rec = serve_run(args, model, dev)
    drops = [int(sum(moe.dropped_pairs(e) for e in log))
             for _, index, _, log in rec if index == 0 and log]
    if drops:
        print(f"families {label}: dropped (token, expert) pairs of each "
              f"prefill: {drops} (capacity factor "
              f"{model.cfg.moe.capacity_factor:.6g})", flush=True)
    return done, stats, rec, drops


def drive_encdec(model, params, dev, batch, frames, prompt, new, seed=0):
    """seamless through ``Model.prefill`` / ``decode_step``: ``batch``
    sequences of ``frames`` encoder frames and ``prompt`` decoder tokens
    from a numpy seed, ``new`` greedy tokens. Returns (tokens per sequence,
    recorded calls, stats as ``launch.serve.run`` gives them but the peak
    memory, the batch's enc_embeds)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import greedy_sample

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt),
                                         dtype=np.int32)).to(dev)
    enc = torch.from_numpy(rng.standard_normal(
        (batch, frames, cfg.d_model)).astype(np.float32)).to(dev)
    out, prefill_s, decode_s = [], [], []
    t_all = time.perf_counter()
    with torch.no_grad(), captured_logits(model) as rec:
        caches = model.init_caches(batch, prompt + new)
        logits, caches, extras = model.prefill(
            params, {"tokens": toks, "enc_embeds": enc}, caches)
        tok = greedy_sample(logits)
        out.append(tok.tolist())
        prefill_s.append(time.perf_counter() - t_all)
        for i in range(new - 1):
            t0 = time.perf_counter()
            logits, caches = model.decode_step(
                params, {"tokens": tok[:, None]}, caches, prompt + i, extras)
            tok = greedy_sample(logits)
            out.append(tok.tolist())
            decode_s.append(time.perf_counter() - t0)
    seconds = time.perf_counter() - t_all
    stats = {"seconds": seconds, "tokens": batch * new,
             "tokens_per_s": batch * new / seconds,
             "prefill_ms": [1e3 * t for t in prefill_s],
             "decode_ms": [1e3 * t for t in decode_s]}
    return [list(t) for t in zip(*out)], rec, stats, enc


def families_moe(dev, card, held):
    """deepseek-moe-16b at full width: (A) twice and (A') through
    launch.serve.run; checks 1 (on A'), 2 and 4; the profile of a wave."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models.model import Model, count_params_analytic

    arch = FAMILY_MOE
    waves = serve_args(arch, False, str(dev), **SERVE_WAVES)
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = serve.build_model(waves)
    param_bytes = print_model(model, init_s,
                              torch.cuda.max_memory_allocated(dev), held, card)
    params = model.params()
    cfg = model.cfg
    active = count_params_analytic(cfg, active_only=True) * 4
    runs = {}
    kv = cache_bytes(cfg, waves.slots, waves.max_len)
    flat = no_drop(cfg)
    flat_model = Model(flat, dev)
    flat_model.load_params(params)      # the same tensors, no copy
    for label, m in (("A", model), ("A again", model), ("A'", flat_model)):
        runs[label] = family_serve(f"{arch} ({label})", m, waves, dev)
        stats = runs[label][1]
        print_run(f"{arch} ({label}, capacity factor "
                  f"{m.cfg.moe.capacity_factor:.6g})", waves, stats, kv,
                  [("every parameter (the dispatch multiplies every expert "
                    "at capacity >= 8)", param_bytes + kv),
                   ("active parameters only", active + kv)], card)
    flat_drops = runs["A'"][3]
    check(not any(flat_drops), f"families {arch} (A'): pairs dropped at "
          f"capacity factor E / k: {flat_drops}")
    a1, a2 = runs["A"], runs["A again"]
    same = ([r.out_tokens for r in a1[0]] == [r.out_tokens for r in a2[0]],
            torch.equal(a1[2][-1][2], a2[2][-1][2]), a1[3] == a2[3])
    check(all(same), f"families {arch}: two runs of (A) differ (tokens, "
          f"final logits, drops equal: {same})")
    print(f"families check 2 ({arch}): two runs of (A) give identical "
          f"tokens, final logits (bit for bit) and drops {a1[3]}",
          flush=True)
    check_cache(f"{arch} (A')", flat_model, params, runs["A'"][2], waves)
    prof = serve_args(arch, False, str(dev), requests=4, slots=4,
                      prompt_len=128, new_tokens=8, max_len=256)
    wall, busy, top = profiled(lambda: serve.run(prof, model=model))
    print(f"families profile ({arch}), one MoE wave of 4 x (128 + 8) "
          f"under torch.profiler: {busy:.3f} ms of CUDA activity in "
          f"{wall:.3f} ms (host clock, synchronised), busy share "
          f"{busy / wall:.4f}; ops with the most device time: "
          + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in top)
          + f"; {card}", flush=True)
    check_waits(arch, model, params, dev)


def families_v2(dev, card, held):
    """deepseek-v2's widths at V2_LAYERS layers, (A') with 2 requests;
    checks 1 and 4."""
    import dataclasses as dc

    from repro_torch.config import get_config

    arch = "deepseek-v2-236b"
    cfg = no_drop(dc.replace(get_config(arch), num_layers=V2_LAYERS))
    model, init_s, init_peak = drawn(cfg, dev)
    param_bytes = print_model(model, init_s, init_peak, held, card)
    params = model.params()
    args = serve_args(arch, False, str(dev), **V2_WAVES)
    kv = cache_bytes(cfg, args.slots, args.max_len)
    done, stats, rec, drops = family_serve(f"{arch} (A')", model, args, dev)
    check(not any(drops), f"families {arch} (A'): pairs dropped: {drops}")
    print_run(f"{arch} ({V2_LAYERS} layers, A', capacity factor "
              f"{cfg.moe.capacity_factor:.6g})", args, stats, kv,
              [("every parameter", param_bytes + kv)], card)
    check_cache(f"{arch} ({V2_LAYERS} layers, A')", model, params, rec, args)
    check_waits(arch, model, params, dev)


def families_recurrent(arch, dev, card, held):
    """mamba2 or recurrentgemma at full width: (A) and (B) through
    launch.serve.run; checks 1 and 4. mamba2's check 1 runs on the same
    parameters with float32 activations, within ``parity.lm_atol_frac(L)``,
    and prints the bfloat16 distance: in bfloat16 the departure of its
    cache path from its forward grows about linearly with depth, in the
    reference's as in the port's, past the square-root rule of
    ``lm_bf16_atol_frac`` (``tests/torch_ssm_drift.py`` measures both at
    full width and cut depths; ROADMAP queue 3)."""
    import dataclasses as dc

    import torch

    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.testing import parity

    waves = serve_args(arch, False, str(dev), **SERVE_WAVES)
    long_ = serve_args(arch, False, str(dev), **FAMILY_LONG[arch])
    torch.cuda.reset_peak_memory_stats(dev)
    model, init_s = serve.build_model(waves)
    param_bytes = print_model(model, init_s,
                              torch.cuda.max_memory_allocated(dev), held, card)
    params = model.params()
    cfg = model.cfg
    ssm = cfg.ssm is not None
    chunk = cfg.ssm.chunk if ssm else 1
    for label, args in (("A", waves), ("B", long_)):
        done, stats, rec, _ = family_serve(f"{arch} ({label})", model, args,
                                           dev)
        kv = cache_bytes(cfg, args.slots, args.max_len)
        print_run(f"{arch} ({label})", args, stats, kv,
                  [("every parameter", param_bytes + kv)], card)
        check_cache(f"{arch} ({label})", model, params, rec, args,
                    chunk=chunk, tol=float("inf") if ssm else None)
        del rec
    if ssm:
        exact = Model(dc.replace(cfg, dtype="float32"), dev)
        exact.load_params(params)       # the same tensors, no copy
        first = serve_args(arch, False, str(dev),
                           **dict(SERVE_WAVES, requests=SERVE_WAVES["slots"]))
        for label, args in (("A", first), ("B", long_)):
            _, _, rec, _ = family_serve(f"{arch} float32 ({label})", exact,
                                        args, dev)
            check_cache(f"{arch} ({label})", exact, params, rec, args,
                        chunk=chunk, tol=parity.lm_atol_frac(cfg.num_layers))
            del rec
        del exact
    check_waits(arch, model, params, dev)


def families_encdec(dev, card, held):
    """seamless at full width through Model.prefill / decode_step; checks
    1 and 4."""
    import argparse

    import torch

    from repro_torch.config import get_config

    arch = "seamless-m4t-large-v2"
    model, init_s, init_peak = drawn(get_config(arch), dev)
    param_bytes = print_model(model, init_s, init_peak, held, card)
    params = model.params()
    cfg = model.cfg
    t = SEAMLESS
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    tokens, rec, stats, enc = drive_encdec(model, params, dev, t["batch"],
                                           t["frames"], t["prompt"],
                                           t["new"])
    stats["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    args = argparse.Namespace(requests=t["batch"], slots=t["batch"],
                              prompt_len=t["prompt"], new_tokens=t["new"],
                              max_len=t["prompt"] + t["new"])
    kv = cache_bytes(cfg, t["batch"], t["prompt"] + t["new"])
    enc_bytes = t["batch"] * t["frames"] * cfg.d_model * 2
    print_run(f"{arch} ({t['batch']} x {t['frames']} frames, "
              f"Model.prefill / decode_step)", args, stats, kv + enc_bytes,
              [("every parameter + the encoder states",
                param_bytes + kv + enc_bytes)], card)
    check_cache(arch, model, params, rec, args, extra={"enc_embeds": enc})
    check_waits(arch, model, params, dev)


def families_card_vs_cpu(dev) -> None:
    """Check 3: each FAMILY_SMOKE config at smoke size in float32 on the
    card and on the CPU: logits within SERVE_CPU_ATOL, equal tokens for the
    untied deepseek configs."""
    import dataclasses as dc

    import torch

    from repro_torch.config import get_config
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    for arch in FAMILY_SMOKE:
        small = dc.replace(get_config(arch, smoke=True), dtype="float32")
        outs = []
        for device in (str(dev), "cpu"):
            m = Model(small, device)
            params = m.init(prng.key(0))
            if m.is_encdec:
                toks, rec, _, _ = drive_encdec(m, params,
                                               torch.device(device), 2, 24,
                                               12, 8)
            else:
                with captured_logits(m) as rec:
                    done, _ = serve.run(serve_args(arch, True, device),
                                        model=m)
                toks = [r.out_tokens for r in done]
            outs.append((toks, torch.stack([r[2].float().cpu()
                                            for r in rec])))
        diff = (outs[0][1] - outs[1][1]).abs().max().item()
        untied = not small.tie_embeddings and not small.is_encoder_decoder
        same = outs[0][0] == outs[1][0]
        check(diff <= SERVE_CPU_ATOL and (same or not untied),
              f"families {arch} smoke float32, card against CPU: tokens "
              f"equal {same}, max |delta logit| {diff}")
        print(f"families check 3 ({arch} smoke, float32): card against CPU "
              f"max |delta logit| {diff} <= {SERVE_CPU_ATOL}; tokens equal "
              f"{same}" + (" (required: untied)" if untied else ""),
              flush=True)


def check_families(dev, card: str) -> None:
    """The "families" phase: ROADMAP item 17(b)'s families at full width
    (module constants above), one model on the card at a time. Checks,
    each failing the run: (1) at every decode step, decode_step's logits
    == Model.forward's at that position over the tokens fed so far,
    within ``parity.lm_bf16_atol_frac(L)`` of max|logit| (deepseek-moe on
    (A') and deepseek-v2, the forward replaying the experts the cache
    path chose, each of its own choices that differs a near-tie;
    recurrentgemma (A) and (B); seamless); mamba2 (A) and (B), the forward
    padded to the SSD chunk, within ``parity.lm_atol_frac(L)`` with
    float32 activations, the bfloat16 distance printed
    (``families_recurrent``); (2) two runs of
    deepseek-moe (A) give bit-identical tokens, final logits and drops;
    (3) the five smoke configs in float32 on the card and on the CPU
    (logits within SERVE_CPU_ATOL, the untied deepseek configs' tokens
    equal); (4) one decode_step of each family waits 0 times for the card.
    Prints each model's init seconds, parameter bytes, peak memory,
    prefill ms, decode ms a step, tokens/s and decode bytes bound beside
    the card's name and power limit, the dropped pairs of each MoE
    prefill, one MoE wave's busy share and top ops, and the phase's wall
    time."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.zeros((), device=dev)
    held = torch.cuda.memory_allocated(dev)
    steps = (("deepseek-moe-16b", lambda: families_moe(dev, card, held)),
             ("deepseek-v2-236b", lambda: families_v2(dev, card, held)),
             ("mamba2-780m", lambda: families_recurrent(
                 "mamba2-780m", dev, card, held)),
             ("recurrentgemma-2b", lambda: families_recurrent(
                 "recurrentgemma-2b", dev, card, held)),
             ("seamless-m4t-large-v2", lambda: families_encdec(dev, card,
                                                                held)),
             ("card against CPU", lambda: families_card_vs_cpu(dev)))
    for name, step in steps:
        t0 = time.perf_counter()
        step()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"families {name}: wall {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"families phase: wall {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)


#: the train phase: gemma2-2b at full width, SHAPES["train_4k"]'s sequence,
#: the batch and the steps cut (the chip's time, not its memory: 4 x 8.25
#: GB of parameters, gradients and moments fit)
TRAIN_ARCH = "gemma2-2b"
TRAIN_BATCH = 8
TRAIN_MICRO = 4
TRAIN_STEPS = 6
TRAIN_LR = 1e-3
#: the step profiled and the step whose waits are counted (0-based)
TRAIN_PROFILED = 4
TRAIN_WAITS = 5
#: NVIDIA's H100 SXM data sheet: dense bfloat16 tensor-core peak at 700 W
BF16_DENSE_PEAK = 989e12
#: the smoke checks' shape: sequence, batch
TRAIN_SMOKE = (64, 4)
#: the train phase's first PAR_STEPS losses and the parameters after them
#: (host copies in tree order): the parallel phase's plain step
TRAIN_REFERENCE: dict = {}


@contextlib.contextmanager
def update_events(records):
    """Inside the block each ``adamw_update`` of a train step records a
    CUDA event before and one after it into ``records`` (no host wait)."""
    import torch

    from repro_torch.train import train_step

    update = train_step.adamw_update

    def timed(*args, **kwargs):
        before = torch.cuda.Event(enable_timing=True)
        before.record()
        out = update(*args, **kwargs)
        after = torch.cuda.Event(enable_timing=True)
        after.record()
        records.append((before, after))
        return out

    train_step.adamw_update = timed
    try:
        yield records
    finally:
        train_step.adamw_update = update


def train_full(dev, card: str) -> None:
    """Check and measure 1 of the train phase: gemma2-2b at full width."""
    import numpy as np
    import torch

    from repro_torch.config import (OptimizerConfig, ParallelConfig, SHAPES,
                                    ShapeConfig, get_config)
    from repro_torch.core import prng
    from repro_torch.data.tokens import DataPipeline
    from repro_torch.models.model import Model, count_params_analytic
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves

    torch.zeros((), device=dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_4k cut to a batch of 8", "train",
                        SHAPES["train_4k"].seq_len, TRAIN_BATCH)
    model = Model(cfg, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(prng.key(0), trainable=True)
    state = init_opt_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)
    step_fn = make_train_step(model, opt,
                              ParallelConfig(microbatches=TRAIN_MICRO))
    n_params = count_params_analytic(cfg)
    tokens = shape.global_batch * shape.seq_len
    flops = 6.0 * n_params * tokens
    print(f"train: {cfg.name} at full width ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} "
          f"activations, {cfg.param_dtype} parameters, remat {cfg.remat}), "
          f"sequence {shape.seq_len}, global batch {shape.global_batch} in "
          f"{TRAIN_MICRO} microbatches, AdamW lr {opt.lr} warmup "
          f"{opt.warmup_steps} {opt.schedule} over {opt.total_steps} steps; "
          f"N = {n_params} (count_params_analytic), D = {tokens} tokens a "
          f"step, 6 N D = {flops:.4e} FLOPs; parameters and optimizer "
          f"state drawn in {init_s:.2f} s; {card}", flush=True)

    pipe = DataPipeline(cfg, shape, seed=0, device=dev)
    losses, rows, updates = [], [], []
    try:
        with update_events(updates):
            for i in range(TRAIN_STEPS):
                def one_step():
                    nonlocal params, state
                    batch = next(pipe)
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                    params, state, metrics = step_fn(params, state, batch)
                    loss = float(metrics["loss"])   # the step's host read
                    return start, loss, metrics

                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == TRAIN_PROFILED:
                    out = []
                    wall, busy, top = profiled(lambda: out.append(
                        one_step()))
                    start, loss, metrics = out[0]
                elif i == TRAIN_WAITS:
                    with card_waits() as waits:
                        start, loss, metrics = one_step()
                else:
                    start, loss, metrics = one_step()
                step_ms = (time.perf_counter() - t0) * 1e3
                if i + 1 == PAR_STEPS:      # the parallel phase's reference
                    TRAIN_REFERENCE["params"] = [
                        p.detach().to("cpu", copy=True)
                        for p in tree_leaves(params)]
                before, after = updates[-1]
                fb_ms = start.elapsed_time(before)
                up_ms = before.elapsed_time(after)
                losses.append(loss)
                rows.append((step_ms, fb_ms, up_ms))
                note = (" (under torch.profiler)" if i == TRAIN_PROFILED
                        else " (sync debug mode on)" if i == TRAIN_WAITS
                        else "")
                print(f"train step {i + 1}: loss {loss:.6f}, forward + "
                      f"backward {fb_ms:.1f} ms, update {up_ms:.1f} ms "
                      f"(CUDA events), step {step_ms:.1f} ms (host clock, "
                      f"ending in the loss read){note}, "
                      f"{tokens / step_ms * 1e3:.0f} tokens/s, lr "
                      f"{float(metrics['lr']):.3e}, grad norm "
                      f"{float(metrics['grad_norm']):.4e}", flush=True)
    finally:
        pipe.close()
    peak = torch.cuda.max_memory_allocated(dev)
    steady = [r for i, r in enumerate(rows)
              if i not in (0, TRAIN_PROFILED, TRAIN_WAITS)]
    step_ms = statistics.median(r[0] for r in steady)
    bound_ms = flops / BF16_DENSE_PEAK * 1e3
    print(f"train: steady step (median of steps "
          f"{[i + 1 for i in range(TRAIN_STEPS) if i not in (0, TRAIN_PROFILED, TRAIN_WAITS)]}) "
          f"{step_ms:.1f} ms, forward + backward "
          f"{statistics.median(r[1] for r in steady):.1f} ms, update "
          f"{statistics.median(r[2] for r in steady):.1f} ms; first step "
          f"{rows[0][0]:.1f} ms; 6 N D at {BF16_DENSE_PEAK / 1e12:.0f} "
          f"TFLOP/s (dense bfloat16, NVIDIA H100 SXM data sheet) "
          f"{bound_ms:.1f} ms, {bound_ms / step_ms:.4f} of the step "
          f"({flops / step_ms * 1e3 / 1e12:.1f} TFLOP/s of model FLOPs); "
          f"peak memory {peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} "
          f"GiB above the {held / 2**30:.2f} GiB earlier phases hold); "
          f"{card}", flush=True)
    print(f"train: step {TRAIN_PROFILED + 1} under torch.profiler: wall "
          f"{wall:.1f} ms, device busy {busy:.1f} ms, busy share "
          f"{busy / wall:.3f}; top ops by device time: "
          + "; ".join(f"{k} {ms:.1f} ms x{n}" for k, ms, n in top),
          flush=True)
    print(f"train: waits for the card in step {TRAIN_WAITS + 1} (next "
          f"batch, step, loss read): {sum(waits.values())} "
          f"{dict(waits)}", flush=True)
    TRAIN_REFERENCE["losses"] = losses[:PAR_STEPS]
    TRAIN_REFERENCE["ms"] = [r[0] for r in rows[:PAR_STEPS]]
    check(all(np.isfinite(losses)), f"train: a loss is not finite: {losses}")
    check(np.mean(losses[-2:]) < losses[0],
          f"train: the mean of the last two losses is not below the first: "
          f"{losses}")
    del params, state, step_fn, model


def train_card_vs_cpu(dev) -> None:
    """Check 2a: gemma2-2b's smoke config in float32, 4 steps (2
    microbatches) on the card and on the CPU from the same parameters."""
    import dataclasses as dc

    import torch

    from repro_torch.config import (OptimizerConfig, ParallelConfig,
                                    ShapeConfig, get_config)
    from repro_torch.core import prng
    from repro_torch.data.tokens import make_batch, to_device
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.testing import parity
    from repro_torch.train.train_step import make_train_step

    cfg = dc.replace(get_config(TRAIN_ARCH, smoke=True), dtype="float32")
    shape = ShapeConfig("smoke", "train", *TRAIN_SMOKE)
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=6)
    drawn = Model(cfg, "cpu").init(prng.key(0))
    runs = []
    for device in (dev, torch.device("cpu")):
        model = Model(cfg, device)
        params = model.load_params(tree_map(
            lambda t: t.detach().to(device, copy=True), drawn),
            trainable=True)
        state = init_opt_state(params)
        step = make_train_step(model, opt, ParallelConfig(microbatches=2))
        losses = []
        for i in range(4):
            params, state, metrics = step(
                params, state, to_device(make_batch(cfg, shape, 0, i),
                                         device))
            losses.append(float(metrics["loss"]))
        runs.append((losses, [p.detach().cpu() for p in tree_leaves(params)]))
    (card_l, card_p), (cpu_l, cpu_p) = runs
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    check(rel <= parity.LM_GRAD_ATOL_FRAC,
          f"train card against CPU: losses {card_l} against {cpu_l}")
    worst = 0.0
    for a, b in zip(card_p, cpu_p):
        frac = float((a - b).abs().max()) / float(b.abs().max())
        check(frac <= parity.LM_GRAD_ATOL_FRAC,
              f"train card against CPU: a parameter differs by {frac:.3e} "
              f"of its leaf's max")
        worst = max(worst, frac)
    print(f"train check 2a (smoke, float32, 4 steps): card against CPU "
          f"losses max relative difference {rel:.3e}, parameters max "
          f"|delta| {worst:.3e} of their leaf's max, both <= "
          f"{parity.LM_GRAD_ATOL_FRAC} (parity.LM_GRAD_ATOL_FRAC)",
          flush=True)


def train_resume(dev, tmp: Path) -> None:
    """Check 2b: an unbroken 10-step Trainer.run == 8 steps + resume."""
    import torch

    from repro_torch.config import (CheckpointConfig, OptimizerConfig,
                                    ShapeConfig, TrainConfig, get_config)
    from repro_torch.tree import tree_leaves
    from repro_torch.train.trainer import Trainer

    def cfg(d):
        return TrainConfig(
            model=get_config(TRAIN_ARCH, smoke=True),
            shape=ShapeConfig("smoke", "train", *TRAIN_SMOKE),
            optimizer=OptimizerConfig(lr=3e-3, warmup_steps=2,
                                      total_steps=10),
            checkpoint=CheckpointConfig(directory=str(tmp / d),
                                        every_steps=4, keep=2,
                                        async_save=True),
            log_every=1000)

    whole = Trainer(cfg("whole"), dev)
    r1 = whole.run(max_steps=10)
    Trainer(cfg("split"), dev).run(max_steps=8)
    resumed = Trainer(cfg("split"), dev)
    r2 = resumed.run(max_steps=10)
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(whole.model.params()),
                   tree_leaves(resumed.model.params())))
    check(r2.resumed_from == 8 and r1.losses[-2:] == r2.losses and same,
          f"train resume: resumed from {r2.resumed_from}, losses "
          f"{r1.losses[-2:]} against {r2.losses}, parameters equal {same}")
    print(f"train check 2b (smoke, {whole.model.cfg.dtype}): Trainer.run "
          f"10 steps == 8 steps + checkpoint + resume to 10, bit for bit "
          f"(last losses {r2.losses}, every parameter)", flush=True)


def train_remat(dev) -> None:
    """Check 2c: remat none, full and selective give the same bits."""
    import dataclasses as dc

    import torch

    from repro_torch.config import ShapeConfig, get_config
    from repro_torch.core import prng
    from repro_torch.data.tokens import make_batch, to_device
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves
    from repro_torch.train.train_step import make_loss_fn

    out = []
    for remat in ("none", "full", "selective"):
        cfg = dc.replace(get_config(TRAIN_ARCH, smoke=True), remat=remat)
        model = Model(cfg, dev)
        params = model.init(prng.key(0), trainable=True)
        batch = to_device(make_batch(cfg, ShapeConfig(
            "smoke", "train", *TRAIN_SMOKE), 0, 0), dev)
        total, _ = make_loss_fn(model)(params, batch)
        grads = torch.autograd.grad(total, tree_leaves(params))
        out.append((total.detach(), grads))
    same = all(torch.equal(loss, out[0][0]) and
               all(torch.equal(a, b) for a, b in zip(grads, out[0][1]))
               for loss, grads in out[1:])
    check(same, "train remat: none, full and selective differ")
    print(f"train check 2c (smoke, {cfg.dtype}): remat none, full and "
          f"selective give the same loss ({float(out[0][0]):.6f}) and "
          f"gradients, bit for bit", flush=True)


def check_train(dev, card: str) -> None:
    """The "train" phase (docstring): full-width steps, then the smoke
    checks; each check fails the run."""
    import gc

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    train_full(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_card_vs_cpu(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_resume(dev, Path(tmp))
    train_remat(dev)
    print(f"train smoke checks: wall {time.perf_counter() - t0:.1f} s; "
          f"train phase: wall {time.perf_counter() - t_phase:.1f} s; {card}",
          flush=True)


#: the parallel phase: the train phase's gemma2-2b configuration, 3 steps
#: of each step (sharded on a (1, 1) mesh, ZeRO-1; the plain step's are the
#: train phase's first 3), the step profiled (0-based, the sharded run only)
#: and the compressed step's batch (one microbatch's sequences: it takes no
#: microbatches, as the reference's)
PAR_STEPS = 3
PAR_PROFILED = 2
PAR_DP_BATCH = 2
#: the compressed step's smoke run (the reference test's 10 steps) and its
#: bounds against the exact run (tests/test_compressed_dp.py)
PAR_DP_STEPS = 10
PAR_DP_DRIFT = 0.08
PAR_DP_GAP = 0.05


def par_run(label, make, dev, card, profile=True, keep=True,
            steps=PAR_STEPS):
    """``steps`` steps of the step ``make()`` builds -> (step, params,
    state, next_batch, close) at full width; prints each step's loss and
    host ms, the profiled step's busy share and the peak memory. Returns
    (losses, host copies of the parameters in tree order (``keep``) or
    None, step ms)."""
    import torch

    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats(dev)
    step, params, state, next_batch, close = make()
    losses, rows = [], []
    try:
        for i in range(steps):
            batch = next_batch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profile and i == PAR_PROFILED:
                out = []
                t_prof = time.perf_counter()
                wall, busy, _ = profiled(lambda: out.append(
                    step(params, state, batch)), ops=False)
                t_prof = time.perf_counter() - t_prof
                params, state, metrics = out[0]
                loss = float(metrics["loss"])
            else:
                params, state, metrics = step(params, state, batch)
                loss = float(metrics["loss"])   # the step's host read
            rows.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
    finally:
        close()
    peak = torch.cuda.max_memory_allocated(dev)
    host = ([p.detach().to("cpu", copy=True) for p in tree_leaves(params)]
            if keep else None)
    prof = (f" (step {PAR_PROFILED + 1} under torch.profiler, CUDA "
            f"activity: busy {busy:.1f} of {wall:.1f} ms, busy share "
            f"{busy / wall:.3f}; the profiler's processing {t_prof:.1f} s)"
            if profile else "")
    print(f"parallel {label}: losses {losses}, step ms (host clock, ending "
          f"in the loss read) {[round(r, 1) for r in rows]}{prof}, peak "
          f"{peak / 2**30:.2f} GiB; {card}", flush=True)
    del params, state, metrics, step
    return losses, host, rows


def par_compare(label, got, want) -> str:
    """Bit for bit, or else the worst |delta| over a leaf's max (must be
    within parity.LM_GRAD_ATOL_FRAC)."""
    import torch

    from repro_torch.testing import parity

    if all(torch.equal(a, b) for a, b in zip(got, want)):
        return "bit for bit"
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, want))
    check(worst <= parity.LM_GRAD_ATOL_FRAC,
          f"parallel {label}: parameters differ by {worst:.3e} of a leaf's "
          "max")
    return f"within {worst:.3e} of a leaf's max"


def parallel_full(dev, card, mesh) -> None:
    """Check (a) and (b) of the parallel phase: gemma2-2b at full width."""
    import gc

    import torch

    from repro_torch.config import (OptimizerConfig, ParallelConfig, SHAPES,
                                    ShapeConfig, get_config)
    from repro_torch.core import prng
    from repro_torch.data.tokens import DataPipeline
    from repro_torch.launch.specs import build_train
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel import fsdp, sharding
    from repro_torch.train.compressed_dp import (init_compressed_state,
                                                 make_compressed_train_step)
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(TRAIN_ARCH)
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)
    par = ParallelConfig(microbatches=TRAIN_MICRO)

    def plain(batch=TRAIN_BATCH, micro=par):
        def make():
            shape = ShapeConfig("train_4k cut", "train",
                                SHAPES["train_4k"].seq_len, batch)
            model = Model(cfg, dev)
            params = model.init(prng.key(0), trainable=True)
            pipe = DataPipeline(cfg, shape, seed=0, device=dev)
            return (make_train_step(model, opt, micro), params,
                    init_opt_state(params), lambda: next(pipe), pipe.close)
        return make

    def sharded(zero1):
        def make():
            shape = ShapeConfig("train_4k cut", "train",
                                SHAPES["train_4k"].seq_len, TRAIN_BATCH)
            step, _, (psh, osh, _), _ = build_train(cfg, shape, mesh, opt,
                                                    par, zero1=zero1)
            full = Model(cfg, dev).init(prng.key(0), trainable=True)
            params = fsdp.place(full, psh)
            state = fsdp.place(init_opt_state(params), osh)
            del full
            pipe = DataPipeline(cfg, shape, seed=0, device=dev, mesh=mesh)
            return step, params, state, lambda: next(pipe), pipe.close
        return make

    def compressed():
        shape = ShapeConfig("train_4k cut", "train",
                            SHAPES["train_4k"].seq_len, PAR_DP_BATCH)
        model = Model(cfg, dev)
        params = model.init(prng.key(0), trainable=True)
        state = init_compressed_state(params, init_opt_state(params))
        pipe = DataPipeline(cfg, shape, seed=0, device=dev)
        pod = mesh_1d("pod")
        return (make_compressed_train_step(model, opt, pod), params, state,
                lambda: next(pipe), pipe.close)

    def settle():
        gc.collect()
        torch.cuda.empty_cache()

    check(len(TRAIN_REFERENCE.get("losses", ())) == PAR_STEPS,
          "parallel: the train phase left no plain steps to compare with")
    base_l, base_p, base_ms = (TRAIN_REFERENCE[k]
                               for k in ("losses", "params", "ms"))
    settle()
    with sharding.use_mesh(mesh, sharding.act_rules_for(cfg, mesh)):
        for zero1 in (False, True):
            label = f"build_train (1, 1) zero1={zero1}"
            with gathers_counted() as calls:
                losses, params, ms = par_run(label, sharded(zero1), dev,
                                             card, profile=not zero1)
            settle()
            check(losses == base_l, f"parallel {label}: losses {losses} "
                  f"against the plain step's {base_l}")
            print(f"parallel {label}: losses equal the train phase's plain "
                  f"steps bit for bit, parameters after step {PAR_STEPS} "
                  f"{par_compare(label, params, base_p)}; step 2 "
                  f"{ms[1]:.1f} ms against the train phase's "
                  f"{base_ms[1]:.1f} ms ({ms[1] - base_ms[1]:+.1f} ms); "
                  f"{describe_calls(calls)}; {card}", flush=True)
            del params
    TRAIN_REFERENCE.clear()
    del base_p
    settle()
    exact_l, _, _ = par_run(f"plain make_train_step, batch {PAR_DP_BATCH}",
                            plain(PAR_DP_BATCH, None), dev, card, False,
                            False)
    settle()
    dp_l, _, _ = par_run(f"compressed (int8 EF, pod group of 1), batch "
                         f"{PAR_DP_BATCH}", compressed, dev, card, False, False)
    settle()
    drift = [abs(a - b) for a, b in zip(dp_l, exact_l)]
    print(f"parallel compressed at full width: loss drift against the exact "
          f"step {drift} (a reading, no bound); {card}", flush=True)


@contextlib.contextmanager
def gathers_counted():
    """Count the parallel layer's dispatch calls inside the block
    (``fsdp.gathered``, wherever the model imports it) and time them on the
    host; a call made inside another (a tuple's elements) is neither
    counted nor timed again."""
    import collections

    from repro_torch.models import encdec, transformer
    from repro_torch.parallel import fsdp

    calls = collections.Counter()
    spent = collections.Counter()
    depth = [0]
    fn = fsdp.gathered

    def counted(*args, **kwargs):
        if depth[0]:
            return fn(*args, **kwargs)
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent["gathered"] += time.perf_counter() - t0
            calls["gathered"] += 1
            depth[0] -= 1

    owners = [m for m in (transformer, encdec, fsdp)
              if getattr(m, "gathered", None) is fn]
    for m in owners:
        m.gathered = counted
    try:
        yield calls, spent
    finally:
        for m in owners:
            m.gathered = fn


def describe_calls(counted) -> str:
    calls, spent = counted
    return ("parallel-layer dispatch over the run's steps: " + ", ".join(
        f"{n} {calls[n]} calls, {spent[n] * 1e3:.1f} ms on the host"
        for n in sorted(calls)))


def mesh_1d(axis: str):
    from torch.distributed.device_mesh import DeviceMesh
    import torch

    return DeviceMesh("cuda", torch.tensor([0]), mesh_dim_names=(axis,))


def parallel_smoke(dev, card, mesh, tmp: Path) -> None:
    """Check (c) of the parallel phase: gemma2-2b's smoke config in float32
    on the card against the CPU, the compressed step against the exact
    one, ``quantize_int8``, a one-stage pipeline and an elastic restore."""
    import dataclasses as dc

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core.distributed import mesh_device
    from repro_torch.config import (CheckpointConfig, OptimizerConfig,
                                    ParallelConfig, ShapeConfig, TrainConfig,
                                    get_config)
    from repro_torch.core import prng
    from repro_torch.data.tokens import make_batch, shard_batch, to_device
    from repro_torch.launch.specs import build_train
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel import fsdp, sharding
    from repro_torch.parallel.collectives import quantize_int8
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.testing import parity
    from repro_torch.train.compressed_dp import (init_compressed_state,
                                                 make_compressed_train_step)
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_items, tree_leaves, tree_map

    cfg = dc.replace(get_config(TRAIN_ARCH, smoke=True), dtype="float32")
    shape = ShapeConfig("smoke", "train", *TRAIN_SMOKE)
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=6)
    drawn = Model(cfg, "cpu").init(prng.key(0))

    def copy_to(device):
        return tree_map(lambda t: t.detach().to(device, copy=True)
                        .requires_grad_(True), drawn)

    # the sharded step, card against CPU
    cpu_mesh = DeviceMesh("cpu", torch.tensor([[0]]),
                          mesh_dim_names=("data", "model"))
    runs = []
    for m in (mesh, cpu_mesh):
        with sharding.use_mesh(m, sharding.act_rules_for(cfg, m)):
            step, _, (psh, osh, _), _ = build_train(
                cfg, shape, m, opt, ParallelConfig(microbatches=2))
            full = copy_to(mesh_device(m))
            params = fsdp.place(full, psh)
            state = fsdp.place(init_opt_state(params), osh)
            losses = []
            for i in range(4):
                params, state, metrics = step(
                    params, state, shard_batch(make_batch(cfg, shape, 0, i),
                                               m))
                losses.append(float(metrics["loss"]))
            runs.append((losses, [p.detach().cpu()
                                  for p in tree_leaves(params)]))
    (card_l, card_p), (cpu_l, cpu_p) = runs
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
    worst = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(card_p, cpu_p))
    check(rel <= parity.LM_GRAD_ATOL_FRAC
          and worst <= parity.LM_GRAD_ATOL_FRAC,
          f"parallel sharded step card against CPU: losses {card_l} "
          f"against {cpu_l}, parameters within {worst:.3e}")
    print(f"parallel check (c) sharded step (smoke, float32, 4 steps, (1, 1) "
          f"meshes): card against CPU losses within {rel:.3e} relative, "
          f"parameters within {worst:.3e} of their leaf's max (rule "
          f"{parity.LM_GRAD_ATOL_FRAC})", flush=True)

    # the compressed step against the exact one, on the card
    pod = mesh_1d("pod")
    out = {}
    for name in ("exact", "compressed"):
        model = Model(cfg, dev)
        params = copy_to(dev)
        if name == "exact":
            step = make_train_step(model, opt)
            state = init_opt_state(params)
        else:
            step = make_compressed_train_step(model, opt, pod)
            state = init_compressed_state(params, init_opt_state(params))
        losses = []
        for t in range(PAR_DP_STEPS):
            params, state, metrics = step(params, state, to_device(
                make_batch(cfg, shape, 0, t), dev))
            losses.append(float(metrics["loss"]))
        out[name] = losses
    drift = max(abs(a - b) for a, b in zip(out["exact"], out["compressed"]))
    gap = abs(out["exact"][-1] - out["compressed"][-1])
    check(out["exact"][-1] < out["exact"][0] and drift < PAR_DP_DRIFT
          and gap < PAR_DP_GAP,
          f"parallel compressed (smoke): drift {drift}, final gap {gap}, "
          f"exact {out['exact']}, compressed {out['compressed']}")
    g = torch.randn(1 << 20, generator=torch.Generator().manual_seed(5))
    g[::4099] *= 37.0
    qc, sc = quantize_int8(g.to(dev))
    qh, sh = quantize_int8(g)
    check(torch.equal(qc.cpu(), qh) and torch.equal(sc.cpu(), sh),
          "parallel quantize_int8: the card differs from the CPU")
    print(f"parallel check (c) compressed step (smoke, float32, "
          f"{PAR_DP_STEPS} steps, pod group of 1): drift {drift:.4e} < "
          f"{PAR_DP_DRIFT}, final gap {gap:.4e} < {PAR_DP_GAP} against the "
          f"exact step (tests/test_compressed_dp.py's bounds); "
          f"quantize_int8 of 2**20 values card == CPU bit for bit",
          flush=True)

    # GPipe on one stage == the sequential loop
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(1, 16, 16, generator=gen) * 0.3).to(dev)
    b = (torch.randn(1, 16, generator=gen) * 0.1).to(dev)
    x = torch.randn(8, 2, 16, generator=gen).to(dev)
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]),
                       {"w": w, "b": b}, x, mesh_1d("stage"), "stage")
    seq = torch.stack([torch.tanh(x[i] @ w[0] + b[0]) for i in range(8)])
    check(torch.equal(y, seq), "parallel pipeline_apply (one stage) differs "
          "from the sequential loop")

    # a checkpoint of the unsharded Trainer restored onto the (1, 1) mesh
    tcfg = TrainConfig(model=get_config(TRAIN_ARCH, smoke=True), shape=shape,
                       optimizer=opt, log_every=1000,
                       checkpoint=CheckpointConfig(directory=str(tmp / "ck"),
                                                   every_steps=2,
                                                   async_save=False))
    trainer = Trainer(tcfg, dev)
    trainer.run(max_steps=2)
    with sharding.use_mesh(mesh):
        _, (pshape, oshape, _), (psh, osh, _), _ = build_train(
            tcfg.model, shape, mesh, opt)
        restored, _ = CheckpointManager(str(tmp / "ck")).restore(
            2, {"params": pshape, "opt": oshape},
            shardings={"params": psh, "opt": osh})
    whole, _ = CheckpointManager(str(tmp / "ck")).restore(
        2, tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                    {"params": pshape, "opt": oshape}))
    same = all(torch.equal(a.cpu(), b.cpu()) for (_, a), (_, b) in
               zip(tree_items(restored), tree_items(whole)))
    same &= all(torch.equal(a.cpu(), b.detach().cpu()) for (_, a), (_, b) in
                zip(tree_items(restored["params"]),
                    tree_items(trainer.model.params())))
    check(same, "parallel restore onto the (1, 1) mesh differs from the "
          "Trainer's state")
    print("parallel check (c): pipeline_apply on one stage == the sequential "
          "loop bit for bit; the unsharded Trainer's checkpoint (step 2) "
          "restored onto the (1, 1) mesh == its parameters and the whole "
          "restore, bit for bit", flush=True)

    # launch.train --mesh: one NCCL rank runs; more ranks than cards raise
    from repro_torch.launch import train as launch_train

    args = ["--arch", TRAIN_ARCH, "--smoke", "--steps", "3", "--batch", "4",
            "--seq", "64", "--device", "cuda"]
    one = launch_train.main(args + ["--mesh", "1x1", "--ckpt-dir",
                                    str(tmp / "mesh")])
    try:
        launch_train.main(args + ["--mesh", "2x1", "--ckpt-dir",
                                  str(tmp / "two")])
        check(False, "launch.train --mesh 2x1 ran on one card")
    except RuntimeError as e:
        print(f"parallel: launch.train --mesh 1x1 ran 3 steps on one NCCL "
              f"rank (losses {one.losses}); --mesh 2x1 raised: {e}",
              flush=True)


def check_parallel(dev, card: str) -> None:
    """The "parallel" phase (docstring): one NCCL + gloo group of one rank
    (a FileStore in a temporary directory, destroyed at the end)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        torch.cuda.set_device(dev)
        dist.init_process_group("cuda:nccl,cpu:gloo",
                                init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = DeviceMesh("cuda", torch.tensor([[0]]),
                              mesh_dim_names=("data", "model"))
            parallel_full(dev, card, mesh)
            t0 = time.perf_counter()
            parallel_smoke(dev, card, mesh, Path(tmp))
            print(f"parallel smoke checks: wall "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
    print(f"parallel phase: wall {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)


#: the "moe train" phase: deepseek-moe-16b at full width, cut in depth to
#: its dense layer 0 and two MoE layers (3 of 28), train_4k's sequence
MOE_TRAIN_ARCH = "deepseek-moe-16b"
MOE_TRAIN_LAYERS = 3
MOE_TRAIN_BATCH = 4
MOE_TRAIN_MICRO = 2
MOE_TRAIN_STEPS = 3


def moe_train_cfg():
    """The phase's config: ``MOE_TRAIN_ARCH`` at ``MOE_TRAIN_LAYERS``
    layers, capacity factor 1.25 (the config's)."""
    from repro_torch.config import get_config

    return dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                               num_layers=MOE_TRAIN_LAYERS)


def moe_train_shape():
    from repro_torch.config import SHAPES, ShapeConfig

    return ShapeConfig("train_4k cut to a batch of 4", "train",
                       SHAPES["train_4k"].seq_len, MOE_TRAIN_BATCH)


def masked_batches(cfg, shape, steps: int):
    """``steps`` numpy batches (``data.tokens.make_batch``, seed 0), each
    with a loss mask whose rows keep between a fifth and all of their
    tokens (numpy seed 0), so the microbatches' mask sums differ."""
    import numpy as np

    from repro_torch.data.tokens import make_batch

    rng = np.random.default_rng(0)
    b, s = shape.global_batch, shape.seq_len - 1
    out = []
    for i in range(steps):
        batch = make_batch(cfg, shape, 0, i)
        keep = rng.permutation(np.linspace(0.2, 1.0, b))
        batch["loss_mask"] = (rng.random((b, s)) < keep[:, None]).astype(
            np.float32)
        out.append(batch)
    return out


def moe_train_run(label, make, dev, card):
    """``MOE_TRAIN_STEPS`` steps of the step ``make()`` builds -> (step,
    params, state, place): losses, host copies of the parameters after
    them, step ms (host clock, ending in the loss read), the (token,
    expert) pairs dropped in each microbatch and the peak memory."""
    import torch

    from repro_torch.models import moe
    from repro_torch.tree import tree_leaves

    cfg, shape = moe_train_cfg(), moe_train_shape()
    batches = masked_batches(cfg, shape, MOE_TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats(dev)
    step, params, state, place = make()
    losses, rows = [], []
    with moe.routing_log() as log:
        for batch in batches:
            batch = place(batch)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))   # the step's host read
            rows.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    # remat "selective" checkpoints the FFN segment: a microbatch records
    # its MoE layers' forward calls, then their recomputations in reverse
    drops = [int(moe.dropped_pairs(e)) for e in log]
    layers = MOE_TRAIN_LAYERS - cfg.moe.first_moe_layer
    groups = [drops[i:i + 2 * layers] for i in range(0, len(drops),
                                                       2 * layers)]
    check(len(groups) == MOE_TRAIN_STEPS * MOE_TRAIN_MICRO
          and all(g[:layers] == g[layers:][::-1] for g in groups),
          f"moe train {label}: routing log {drops} is not each "
          "microbatch's forward calls and their recomputations")
    per_micro = [sum(g[:layers]) for g in groups]
    pairs = (shape.global_batch // MOE_TRAIN_MICRO * shape.seq_len
             * cfg.moe.top_k * layers)
    host = [p.detach().to("cpu", copy=True) for p in tree_leaves(params)]
    print(f"moe train {label}: losses {losses}, step ms (host clock, ending "
          f"in the loss read) {[round(r, 1) for r in rows]}, dropped pairs "
          f"a microbatch (of {pairs} in its {layers} MoE layers) "
          f"{per_micro}, peak {peak / 2**30:.2f} GiB; {card}", flush=True)
    del params, state, metrics, step
    return losses, host, rows, per_micro


def check_moe_train(dev, card: str) -> None:
    """The "moe train" phase (docstring): one NCCL + gloo group of one
    rank (a FileStore in a temporary directory, destroyed at the end)."""
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.core import prng
    from repro_torch.data.tokens import shard_batch, to_device
    from repro_torch.launch.specs import build_train
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel import fsdp, sharding
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, shape = moe_train_cfg(), moe_train_shape()
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=MOE_TRAIN_STEPS)
    par = ParallelConfig(microbatches=MOE_TRAIN_MICRO)
    n_params = sum(p.numel() for p in
                   tree_leaves(Model(cfg, "cpu").shapes()))
    print(f"moe train: {cfg.name} at full width, {MOE_TRAIN_LAYERS} of 28 "
          f"layers, {n_params} parameters ({20 * n_params / 1e9:.1f} GB at "
          f"20 B a parameter: float32 parameters, gradient sums, both AdamW "
          f"moments and a step's gradients), {shape.name} in "
          f"{MOE_TRAIN_MICRO} microbatches, capacity factor "
          f"{cfg.moe.capacity_factor}, a loss mask", flush=True)

    def plain():
        model = Model(cfg, dev)
        params = model.init(prng.key(0), trainable=True)
        return (make_train_step(model, opt, par), params,
                init_opt_state(params), lambda b: to_device(b, dev))

    def settle():
        gc.collect()
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        torch.cuda.set_device(dev)
        dist.init_process_group("cuda:nccl,cpu:gloo",
                                init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = DeviceMesh("cuda", torch.tensor([[0]]),
                              mesh_dim_names=("data", "model"))

            def sharded():
                step, _, (psh, osh, _), _ = build_train(cfg, shape, mesh,
                                                        opt, par)
                full = Model(cfg, dev).init(prng.key(0), trainable=True)
                params = fsdp.place(full, psh)
                state = fsdp.place(init_opt_state(full), osh)
                del full
                return step, params, state, lambda b: shard_batch(
                    b, mesh, dev, MOE_TRAIN_MICRO)

            base_l, base_p, base_ms, base_d = moe_train_run(
                "plain make_train_step", plain, dev, card)
            settle()
            check(all(math.isfinite(x) for x in base_l),
                  f"moe train: plain losses {base_l}")
            with sharding.use_mesh(mesh, sharding.act_rules_for(cfg, mesh)):
                losses, params, ms, drops = moe_train_run(
                    "build_train (1, 1)", sharded, dev, card)
            settle()
        finally:
            dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(params, base_p))
    check(losses == base_l and drops == base_d and same,
          f"moe train: the (1, 1) step's losses {losses} and drops {drops} "
          f"against the plain step's {base_l} and {base_d}; parameters "
          f"equal: {same}")
    print(f"moe train: build_train on (1, 1) == the plain step bit for bit "
          f"over {MOE_TRAIN_STEPS} steps (losses, drops, every parameter); "
          f"step 3 {ms[-1]:.1f} ms against the plain step's "
          f"{base_ms[-1]:.1f} ms; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


#: the "serve mesh" phase's traffic (C): gemma2-2b at full width
MESH_ARCH = "gemma2-2b"
MESH_TRAFFIC = dict(slots=4, prompt=4608, new_tokens=16, max_len=32768)
#: check 3: each family's smoke config on the card and on the CPU
MESH_FAMILIES = ("gemma2-2b", "internvl2-1b", "deepseek-moe-16b",
                 "deepseek-v2-236b", "mamba2-780m", "recurrentgemma-2b",
                 "seamless-m4t-large-v2")
MESH_SMOKE = dict(slots=2, prompt=16, new_tokens=4, max_len=32)


def mesh_prompt(cfg, slots: int, prompt: int, seed: int = 0):
    """A prompt batch of ``slots`` x ``prompt`` positions from a numpy
    seed: ``tokens``, and a vlm's ``frontend_embeds`` or an enc-dec
    model's ``enc_embeds``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    text = prompt - (cfg.frontend_tokens if cfg.frontend == "vision"
                     else 0)
    out["tokens"] = rng.integers(0, cfg.vocab_size, (slots, text),
                                 dtype=np.int32)
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        out["frontend_embeds"] = rng.standard_normal(
            (slots, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = (rng.standard_normal(
            (slots, prompt, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def mesh_serve(cfg, mesh, params, prompt_np, max_len: int, new: int,
               timed: bool = False):
    """``prompt_np`` through build_prefill's step and ``new - 1`` greedy
    steps of build_decode's on ``mesh`` (this rank's device), the
    parameters placed by their shardings and the caches allocated as this
    rank's blocks. Returns (the prefill's logits, each decode step's
    logits, the tokens (B, new), the caches, the seconds of the prefill
    and of each decode step (CUDA events where ``timed``))."""
    import torch

    from repro_torch.config import ShapeConfig
    from repro_torch.core.distributed import mesh_device
    from repro_torch.launch.specs import build_decode, build_prefill
    from repro_torch.models.encdec import encode
    from repro_torch.parallel import kvcache, sharding
    from repro_torch.serve.engine import greedy_sample

    dev = mesh_device(mesh)
    b, prompt = prompt_np["tokens"].shape[0], sum(
        v.shape[1] for k, v in prompt_np.items() if k != "enc_embeds")
    with sharding.use_mesh(mesh, sharding.act_rules_for(cfg, mesh)):
        pre, _, (psh, bsh, _), _ = build_prefill(
            cfg, ShapeConfig("p", "prefill", prompt, b), mesh)
        dec, _, dsh, _ = build_decode(
            cfg, ShapeConfig("d", "decode", max_len, b), mesh)
    placed = kvcache.place(params, psh)
    batch = kvcache.place({k: torch.from_numpy(v).to(dev)
                           for k, v in prompt_np.items()}, bsh)
    caches = kvcache.init_blocks(cfg, b, max_len, dsh[2], dev)
    extra = ()
    if cfg.is_encoder_decoder:
        with torch.no_grad():
            extra = (kvcache.place(encode(placed, batch["enc_embeds"], cfg),
                                   dsh[4]),)
    marks = []

    def mark():
        if timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

    mark()
    logits, caches = pre(placed, batch, caches)
    mark()
    first = logits
    tok = greedy_sample(logits)[:, None]
    toks, steps = [tok], []
    for i in range(new - 1):
        logits, caches = dec(placed, kvcache.place(tok, dsh[1]), caches,
                             prompt + i, *extra)
        mark()
        steps.append(logits)
        tok = greedy_sample(logits)[:, None]
        toks.append(tok)
    seconds = []
    if timed:
        torch.cuda.synchronize(dev)
        seconds = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    return first, steps, torch.cat(toks, dim=1), caches, seconds


def plain_serve(model, params, prompt_np, max_len: int, new: int, dev):
    """The same traffic through the plain ``Model.prefill`` /
    ``decode_step``: (prefill logits, decode logits, tokens, caches,
    seconds as ``mesh_serve``'s)."""
    import torch

    from repro_torch.serve.engine import greedy_sample

    batch = {k: torch.from_numpy(v).to(dev) for k, v in prompt_np.items()}
    prompt = sum(v.shape[1] for k, v in prompt_np.items()
                 if k != "enc_embeds")
    b = batch["tokens"].shape[0]
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(new + 1)]
    with torch.no_grad():
        caches = model.init_caches(b, max_len)
        marks[0].record()
        first, caches, extras = model.prefill(params, batch, caches)
        marks[1].record()
        tok = greedy_sample(first)[:, None]
        toks, steps = [tok], []
        for i in range(new - 1):
            logits, caches = model.decode_step(params, {"tokens": tok},
                                               caches, prompt + i, extras)
            marks[i + 2].record()
            steps.append(logits)
            tok = greedy_sample(logits)[:, None]
            toks.append(tok)
    torch.cuda.synchronize(dev)
    seconds = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    return first, steps, torch.cat(toks, dim=1), caches, seconds


def serve_mesh_full(dev, card: str, mesh, held: int) -> None:
    """Traffic (C) through the plain path, then through the builders on
    ``mesh``; checks 1 and 2 (phase docstring)."""
    import gc

    import torch

    from repro_torch.config import get_config
    from repro_torch.parallel import kvcache

    cfg = get_config(MESH_ARCH)
    t = MESH_TRAFFIC
    model, init_s, _ = drawn(cfg, dev)
    params = model.params()
    param_bytes = tree_bytes(params)
    prompt = mesh_prompt(cfg, t["slots"], t["prompt"])

    plain_first, plain_steps, plain_toks, caches, plain_s = plain_serve(
        model, params, prompt, t["max_len"], t["new_tokens"], dev)
    want_first = plain_first.cpu()
    del plain_first, caches
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    first, steps, toks, caches, mesh_s = mesh_serve(
        cfg, mesh, params, prompt, t["max_len"], t["new_tokens"],
        timed=True)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    same_steps = all(torch.equal(a, b) for a, b in zip(steps, plain_steps))
    same_first = all(torch.equal(first[i].cpu(), want_first[i])
                     for i in range(first.shape[0]))
    check(same_first and same_steps and torch.equal(toks, plain_toks),
          f"serve mesh (C): the (1, 1) mesh's logits or tokens differ from "
          f"the plain path's (prefill {same_first}, decode {same_steps}, "
          f"tokens {torch.equal(toks, plain_toks)})")
    held_bytes = tree_bytes(caches)
    whole = cache_bytes(cfg, t["slots"], t["max_len"])
    print(f"serve mesh check 1 ({MESH_ARCH}, traffic C): the prefill's "
          f"logits {tuple(first.shape)}, {len(steps)} decode steps' logits "
          f"and the tokens {toks.cpu().tolist()} == the plain path's bit "
          f"for bit", flush=True)

    # check 2: one more decode step of the mesh path under the wait count
    from repro_torch.config import ShapeConfig
    from repro_torch.launch.specs import build_decode
    from repro_torch.parallel import sharding

    with sharding.use_mesh(mesh, sharding.act_rules_for(cfg, mesh)):
        dec, _, dsh, _ = build_decode(cfg, ShapeConfig(
            "d", "decode", t["max_len"], t["slots"]), mesh)
    placed = kvcache.place(params, dsh[0])
    tok = kvcache.place(toks[:, -1:].contiguous(), dsh[1])
    torch.cuda.synchronize(dev)
    with card_waits() as waits:
        dec(placed, tok, caches, t["prompt"] + t["new_tokens"] - 1)
        torch.cuda.synchronize(dev)
    check(not waits, f"serve mesh: a decode step waits for the card at "
          f"{dict(waits)}")
    print("serve mesh check 2: one build_decode step under "
          "set_sync_debug_mode: 0 waits", flush=True)

    dec_ms = [1e3 * s for s in mesh_s[1:]]
    plain_ms = [1e3 * s for s in plain_s[1:]]
    served = t["slots"] * t["new_tokens"]
    bound = param_bytes + whole
    print(f"serve mesh (C) {MESH_ARCH}: {t['slots']} slots x prompt "
          f"{t['prompt']} + {t['new_tokens']} new tokens into "
          f"{t['max_len']}-slot caches on the (1, 1) mesh: prefill "
          f"{1e3 * mesh_s[0]:.1f} ms (plain {1e3 * plain_s[0]:.1f}); decode "
          f"{statistics.median(dec_ms):.3f} ms a step (median of "
          f"{len(dec_ms)}; min {min(dec_ms):.3f}, max {max(dec_ms):.3f}; "
          f"plain median {statistics.median(plain_ms):.3f}); "
          f"{served / sum(mesh_s):.1f} tokens/s ({served} tokens in "
          f"{sum(mesh_s):.3f} s of the card's time, {wall:.3f} s wall); "
          f"decode bytes bound {bound / PEAK_BYTES_S * 1e3:.3f} ms "
          f"({param_bytes} B float32 parameters + {whole} B caches at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s); peak memory "
          f"{peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB earlier "
          f"phases hold; cache bytes each rank holds {held_bytes} "
          f"({held_bytes / 1e9:.3f} GB, of {whole}); parameters drawn in "
          f"{init_s:.2f} s; {card}", flush=True)
    del model, params, placed, caches, first, steps, want_first


def serve_mesh_families(dev, card: str, mesh, cpu_mesh) -> None:
    """Check 3: each MESH_FAMILIES smoke config in float32 through the
    builders on the card's mesh and on the CPU's, from the same
    parameters (drawn on the CPU)."""
    import dataclasses as dc

    import torch

    from repro_torch.config import get_config
    from repro_torch.core import prng
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    s = MESH_SMOKE
    for arch in MESH_FAMILIES:
        cfg = dc.replace(get_config(arch, smoke=True), dtype="float32")
        params = Model(cfg, "cpu").init(prng.key(0))
        prompt = mesh_prompt(cfg, s["slots"], s["prompt"])
        outs = []
        for m, d in ((mesh, dev), (cpu_mesh, torch.device("cpu"))):
            first, steps, toks, _, _ = mesh_serve(
                cfg, m, tree_map(lambda p, d=d: p.to(d), params), prompt,
                s["max_len"], s["new_tokens"])
            outs.append((toks.cpu(), torch.stack(
                [first[:, -1].float().cpu()]
                + [x[:, -1].float().cpu() for x in steps])))
        diff = (outs[0][1] - outs[1][1])[..., :cfg.vocab_size].abs().max()
        same = torch.equal(outs[0][0], outs[1][0])
        check(same and float(diff) <= SERVE_CPU_ATOL,
              f"serve mesh {arch} smoke float32, card against CPU: tokens "
              f"equal {same}, max |delta logit| {float(diff)}")
        print(f"serve mesh check 3 ({arch} smoke, {cfg.family}, float32): "
              f"build_prefill / build_decode on the card against the CPU: "
              f"tokens equal, max |delta logit| {float(diff):.3g} <= "
              f"{SERVE_CPU_ATOL}", flush=True)


def check_serve_mesh(dev, card: str) -> None:
    """The "serve mesh" phase (docstring): one NCCL + gloo group of one
    rank (a FileStore in a temporary directory, destroyed at the end)."""
    import gc

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_smesh_") as tmp:
        torch.cuda.set_device(dev)
        dist.init_process_group("cuda:nccl,cpu:gloo",
                                init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = DeviceMesh("cuda", torch.tensor([[0]]),
                              mesh_dim_names=("data", "model"))
            cpu_mesh = DeviceMesh("cpu", torch.tensor([[0]]),
                                  mesh_dim_names=("data", "model"))
            t0 = time.perf_counter()
            serve_mesh_full(dev, card, mesh, held)
            gc.collect()
            torch.cuda.empty_cache()
            print(f"serve mesh traffic C: wall {time.perf_counter() - t0:.1f}"
                  f" s", flush=True)
            t0 = time.perf_counter()
            serve_mesh_families(dev, card, mesh, cpu_mesh)
            print(f"serve mesh families: wall "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
    print(f"serve mesh phase: wall {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)


#: production cells the dry-run phase runs on a fake world; the last two
#: split their products over ``model``: the train step reads replicated
#: compute 1, the prefill at most SPLIT_FLOPS_MAX
DRY_CELLS = (("gemma2-2b", "train_4k", False), ("gemma2-2b", "decode_32k",
                                                True),
             ("qwen3-32b", "train_4k", False),
             ("qwen3-32b", "prefill_32k", False))
#: the predicted argument + temp bytes against the card's peak
DRY_PEAK_RTOL = 0.10
#: the position of the dry-run phase's decode step (traffic C's prompt)
DRY_INDEX = MESH_TRAFFIC["prompt"]


def dry_step(label, build, meta_args, real_args, dev, card,
             timed: int = 0):
    """One step ``build`` returns, predicted by op_cost on ``meta_args``
    (a function of the builder's arguments and shardings), then run on the
    card on ``real_args`` (likewise; called with nothing else resident)
    under FlopCounterMode. Checks the FLOPs equal and the peak within
    DRY_PEAK_RTOL. ``timed``: so many more steps after the counted one
    (its warm-up), each timed on the host clock to a synchronize. Returns
    {"flops", "peak" (bytes above what was held), "predicted" (argument +
    temp bytes), "ms" (the timed steps'), "first_shape" (the shape of the
    step's first output where that is a tensor, else None)}. ``real_args``
    None: a step whose predicted arguments + temp exceed the card's
    memory, which is checked, is predicted only (the FLOPs op_cost's,
    "peak" None)."""
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import op_cost

    fn, meta, shs = build()
    t0 = time.perf_counter()
    _, pred = op_cost.analyze(fn, meta_args(meta, shs))
    predict_s = time.perf_counter() - t0
    if real_args is None:
        mem = pred["memory"]
        want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        total = torch.cuda.get_device_properties(dev).total_memory
        print(f"dry run {label}: FLOPs predicted {pred['flops']} (meta "
              f"tensors, {predict_s:.1f} s); arguments + temp {want} "
              f"({want / 2**30:.3f} GiB) against the card's {total} B: not "
              f"run; {card}", flush=True)
        check(want > total, f"dry run {label}: predicted to fit the card "
              f"({want} of {total} B), but not run")
        return {"flops": pred["flops"], "peak": None, "predicted": want,
                "ms": [], "first_shape": None}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    args = real_args(meta, shs)
    torch.cuda.synchronize(dev)
    resident = torch.cuda.memory_allocated(dev) - held
    torch.cuda.reset_peak_memory_stats(dev)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops:
        out = fn(*args)
    torch.cuda.synchronize(dev)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - held
    ms = []
    for _ in range(timed):
        del out
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    first = (tuple(out[0].shape) if isinstance(out, tuple)
             and isinstance(out[0], torch.Tensor) else None)
    del out, args
    mem = pred["memory"]
    want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    got_flops = int(flops.get_total_flops())
    print(f"dry run {label}: FLOPs predicted {pred['flops']} (meta tensors, "
          f"{predict_s:.1f} s), on the card {got_flops} (FlopCounterMode, "
          f"{run_s:.1f} s); bytes predicted: arguments "
          f"{mem['argument_size_in_bytes']} ({resident} resident on the "
          f"card), temp {mem['temp_size_in_bytes']}, output "
          f"{mem['output_size_in_bytes']}, arguments + temp {want} "
          f"({want / 2**30:.3f} GiB); max_memory_allocated above the "
          f"{held} B held before {peak} ({peak / 2**30:.3f} GiB); "
          f"predicted / measured {want / peak:.4f}; bytes accessed "
          f"{pred['bytes_accessed']}; {card}", flush=True)
    check(got_flops == pred["flops"],
          f"dry run {label}: the card's FLOPs {got_flops} != the "
          f"prediction {pred['flops']}")
    check(abs(want / peak - 1) <= DRY_PEAK_RTOL,
          f"dry run {label}: predicted arguments + temp {want} B against "
          f"the card's peak {peak} B: ratio {want / peak:.4f}, beyond "
          f"{DRY_PEAK_RTOL}")
    return {"flops": got_flops, "peak": peak, "predicted": want, "ms": ms,
            "first_shape": first}


def dry_cells() -> None:
    """DRY_CELLS through launch.dryrun.run_cell, one subprocess a cell,
    all started together, none seeing the card; each must be ok."""
    code = ("import json, sys\n"
            "from repro_torch.launch import dryrun\n"
            "arch, shape, pod2 = json.loads(sys.argv[2])\n"
            "r = dryrun.run_cell(arch, shape, pod2, force=True, "
            "out_dir=sys.argv[1])\n"
            "print(dryrun.summary(r), flush=True)\n"
            "r.pop('traceback', None)\n"
            "print('CELL ' + json.dumps(r), flush=True)\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as tmp:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code, tmp,
                                   json.dumps(cell)], env=env, cwd=ROOT,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cell in DRY_CELLS]
        try:
            outs = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    cells = [json.loads(line[5:]) for out, _ in outs
             for line in out.splitlines() if line.startswith("CELL ")]
    check(all(p.returncode == 0 for p in procs)
          and len(cells) == len(DRY_CELLS),
          "dry run cells: a subprocess failed "
          f"({[p.returncode for p in procs]}): "
          + " ".join(f"{out[-1000:]} {err[-1500:]}" for out, err in outs))
    for r in cells:
        check(r["status"] == "ok", f"dry run {r['cell']}: {r['status']} "
              f"{r.get('error', r.get('reason'))}")
        if r["arch"] == "qwen3-32b":
            most = 1 if r["shape"] == "train_4k" else SPLIT_FLOPS_MAX
            check(r["replicated_compute"] <= most,
                  f"dry run {r['cell']}: replicated compute x"
                  f"{r['replicated_compute']}, above {most}: its products "
                  "do not split over model")
        m, c = r["memory"], r["collectives"]
        print(f"dry run cell {r['cell']} on a fake world of "
              f"{r['n_devices']} ranks (no card): per rank {r['flops']} "
              f"FLOPs, {r['bytes_accessed']} B accessed, arguments "
              f"{m['argument_size_in_bytes']} B, temp "
              f"{m['temp_size_in_bytes']} B, output "
              f"{m['output_size_in_bytes']} B, collectives "
              f"{c['total_bytes']} B {c['bytes_by_kind']} in "
              f"{c['counts']}; replicated compute x"
              f"{r['replicated_compute']} (one rank's step "
              f"{r['flops_one_rank']} FLOPs); traced in {r['trace_s']} s",
              flush=True)
    print(f"dry run cells: subprocess wall {time.perf_counter() - t0:.1f} s",
          flush=True)


def dry_moe_step(mesh, dev, card) -> None:
    """The "moe train" phase's step (its first batch, with its loss mask)
    through ``dry_step`` on ``mesh``."""
    import torch

    from repro_torch.config import OptimizerConfig, ParallelConfig
    from repro_torch.core import prng
    from repro_torch.data.tokens import shard_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_train
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel import fsdp, sharding

    cfg, shape = moe_train_cfg(), moe_train_shape()
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=MOE_TRAIN_STEPS)
    batch = masked_batches(cfg, shape, 1)[0]

    def build():
        fn, meta, shs, _ = build_train(
            cfg, shape, mesh, opt,
            ParallelConfig(microbatches=MOE_TRAIN_MICRO))
        return fn, meta, shs

    def meta_args(meta, shs):
        params, state, tokens = dryrun.step_args("train", meta, shs)
        mask = torch.empty(batch["loss_mask"].shape, dtype=torch.float32,
                           device="meta")
        tokens["loss_mask"] = fsdp.mark(mask, fsdp.spec_of(tokens["tokens"]))
        return params, state, tokens

    def real_args(meta, shs):
        full = Model(cfg, dev).init(prng.key(0), trainable=True)
        return (fsdp.place(full, shs[0]),
                fsdp.place(init_opt_state(full), shs[1]),
                shard_batch(batch, mesh, dev, MOE_TRAIN_MICRO))

    with sharding.use_mesh(mesh, sharding.act_rules_for(cfg, mesh)):
        dry_step(f"{cfg.name} {MOE_TRAIN_LAYERS}-layer train step "
                 f"({shape.name}, {MOE_TRAIN_MICRO} microbatches, a loss "
                 f"mask)", build, meta_args, real_args, dev, card)


def check_dryrun(dev, card: str) -> None:
    """The "dry run" phase (docstring): one NCCL + gloo group of one rank
    (a FileStore in a temporary directory, destroyed at the end)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.config import (OptimizerConfig, ParallelConfig, SHAPES,
                                    ShapeConfig, get_config)
    from repro_torch.core import prng
    from repro_torch.data.tokens import make_batch, shard_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import build_decode, build_train
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel import fsdp, kvcache
    from repro_torch.parallel import sharding

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    train_shape = ShapeConfig("train_4k cut to a batch of 8", "train",
                              SHAPES["train_4k"].seq_len, TRAIN_BATCH)
    dec_shape = ShapeConfig("decode_32k cut to 4 slots", "decode",
                            MESH_TRAFFIC["max_len"], MESH_TRAFFIC["slots"])
    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2,
                          total_steps=TRAIN_STEPS)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as tmp:
        torch.cuda.set_device(dev)
        dist.init_process_group("cuda:nccl,cpu:gloo",
                                init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh((1, 1), ("data", "model"), "cuda")
            rules = sharding.act_rules_for(cfg, mesh)

            def train_build():
                fn, meta, shs, _ = build_train(
                    cfg, train_shape, mesh, opt,
                    ParallelConfig(microbatches=TRAIN_MICRO))
                return fn, meta, shs

            def train_real(meta, shs):
                full = Model(cfg, dev).init(prng.key(0), trainable=True)
                return (fsdp.place(full, shs[0]),
                        fsdp.place(init_opt_state(full), shs[1]),
                        shard_batch(make_batch(cfg, train_shape, 0, 0),
                                    mesh))

            def dec_build():
                fn, meta, shs, _ = build_decode(cfg, dec_shape, mesh)
                return fn, meta, shs

            def dec_meta(meta, shs):
                args = dryrun.step_args("decode", meta, shs)
                return args[:3] + (DRY_INDEX,)

            def dec_real(meta, shs):
                b = dec_shape.global_batch
                return (kvcache.place(Model(cfg, dev).init(prng.key(0)),
                                      shs[0]),
                        kvcache.place(torch.zeros((b, 1), dtype=torch.int32,
                                                  device=dev), shs[1]),
                        kvcache.init_blocks(cfg, b, dec_shape.seq_len,
                                            shs[2], dev),
                        DRY_INDEX)

            with sharding.use_mesh(mesh, rules):
                t0 = time.perf_counter()
                dry_step(f"{cfg.name} train step ({train_shape.name}, "
                         f"{TRAIN_MICRO} microbatches)", train_build,
                         lambda m, s: dryrun.step_args("train", m, s),
                         train_real, dev, card)
                gc.collect()
                torch.cuda.empty_cache()
                print(f"dry run train step: wall "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                t0 = time.perf_counter()
                dry_step(f"{cfg.name} decode step (traffic C, "
                         f"{dec_shape.name}, position {DRY_INDEX})",
                         dec_build, dec_meta, dec_real, dev, card)
                gc.collect()
                torch.cuda.empty_cache()
                print(f"dry run decode step: wall "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            dry_moe_step(mesh, dev, card)
            gc.collect()
            torch.cuda.empty_cache()
            print(f"dry run moe train step: wall "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
    dry_cells()
    print(f"dry run phase: wall {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)


#: the "model split" phase: qwen3-32b at full width cut in depth, rank 0
#: of a (1, 16) mesh on a fake world, beside the plain step of the same cut
SPLIT_ARCH = "qwen3-32b"
SPLIT_LAYERS = 2
SPLIT_BATCH = 2
SPLIT_MESH = (1, 16)
#: a rank's FLOPs over the plain step's: at least 1 / 16, at most this / 16
SPLIT_FLOPS_MAX = 1.25
#: bytes a parameter of the plain step: float32 parameter, its gradient,
#: both AdamW moments and a gradient sum
SPLIT_BYTES_A_PARAM = 20


def split_cfg():
    from repro_torch.config import get_config

    return dataclasses.replace(get_config(SPLIT_ARCH),
                               num_layers=SPLIT_LAYERS)


def split_shape():
    from repro_torch.config import SHAPES, ShapeConfig

    return ShapeConfig(f"train_4k cut to a batch of {SPLIT_BATCH}", "train",
                       SHAPES["train_4k"].seq_len, SPLIT_BATCH)


def split_bound(n: int, whole: int, plain: int) -> float:
    """The most a rank of n may compute of a plain step's ``plain`` FLOPs,
    times n, where ``whole`` of them every rank computes whole (op_cost's
    count): n whole / plain, plus SPLIT_FLOPS_MAX of the rest."""
    share = whole / plain
    return n * share + SPLIT_FLOPS_MAX * (1 - share)


def split_train_pair(name: str, cfg, shape, dev, card: str) -> None:
    """Phase ``name``'s train steps: ``cfg`` at ``shape``, build_train's
    step as rank 0 of SPLIT_MESH on a fake world, then the plain one-rank
    step, each through ``dry_step``; checks the rank's FLOPs between 1 / n
    and SPLIT_FLOPS_MAX / n of the plain step's."""
    import torch

    from repro_torch.config import OptimizerConfig
    from repro_torch.core import prng
    from repro_torch.data.tokens import make_batch, shard_batch, to_device
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.launch.specs import build_train, input_specs
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.parallel import fsdp, sharding
    from repro_torch.train.train_step import make_train_step
    from repro_torch.tree import tree_leaves

    opt = OptimizerConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=3)
    batch = make_batch(cfg, shape, 0, 0)
    n = math.prod(SPLIT_MESH)
    model = Model(cfg, dev)
    params = sum(t.numel() for t in tree_leaves(model.shapes()))
    print(f"{name}: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, {cfg.num_kv_heads} kv heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}"
          + ("" if cfg.moe is None else
             f", {cfg.moe.num_experts} experts of {cfg.moe.expert_ff}, "
             f"top {cfg.moe.top_k}, {cfg.moe.num_shared} shared")
          + f") cut to {cfg.num_layers} layers, {params} parameters; "
          f"{shape.name} ({shape.seq_len} positions); the plain step "
          f"reckoned at {SPLIT_BYTES_A_PARAM} B a parameter, "
          f"{params * SPLIT_BYTES_A_PARAM / 2**30:.2f} GiB, plus its "
          "activations (op_cost's temp below)", flush=True)

    with fake_world(n):
        mesh = make_mesh(SPLIT_MESH, ("data", "model"), "cuda")
        with sharding.use_mesh(mesh, sharding.act_rules_for(cfg, mesh)):
            def build():
                fn, meta, shs, _ = build_train(cfg, shape, mesh, opt)
                return fn, meta, shs

            def real(meta, shs):
                full = Model(cfg, dev).init(prng.key(0), trainable=True)
                return (fsdp.place(full, shs[0]),
                        fsdp.place(init_opt_state(full), shs[1]),
                        shard_batch(batch, mesh, dev))

            split = dry_step(f"{cfg.name} {cfg.num_layers}-layer train step, "
                             f"rank 0 of {SPLIT_MESH} on a fake world of "
                             f"{n}", build,
                             lambda m, s: dryrun.step_args("train", m, s),
                             real, dev, card, timed=1)
    gc.collect()
    torch.cuda.empty_cache()

    def build_plain():
        return (make_train_step(model, opt),
                (model.shapes(), None, input_specs(cfg, shape)), None)

    def plain_meta(meta, shs):
        params = dryrun.meta_blocks(meta[0], None, grad=True)
        return params, init_opt_state(params), dryrun.meta_blocks(meta[2],
                                                                  None)

    def plain_real(meta, shs):
        full = Model(cfg, dev).init(prng.key(0), trainable=True)
        return full, init_opt_state(full), to_device(batch, dev)

    plain = dry_step(f"{cfg.name} {cfg.num_layers}-layer plain train step "
                     "(one rank)", build_plain, plain_meta, plain_real, dev,
                     card, timed=1)
    ratio = split["flops"] / plain["flops"]
    print(f"{name}: rank 0 of {SPLIT_MESH}: {split['flops']} FLOPs, "
          f"step {split['ms'][0]:.1f} ms (host clock, after a warm-up step), "
          f"peak {split['peak'] / 2**30:.3f} GiB; the plain step: "
          f"{plain['flops']} FLOPs, step {plain['ms'][0]:.1f} ms, peak "
          f"{plain['peak'] / 2**30:.3f} GiB; the rank's FLOPs x {n} over the "
          f"plain step's {ratio * n:.4f}, step ms ratio "
          f"{split['ms'][0] / plain['ms'][0]:.4f}, peak ratio "
          f"{split['peak'] / plain['peak']:.4f}; {card}", flush=True)
    check(1 / n <= ratio <= SPLIT_FLOPS_MAX / n,
          f"{name}: the rank computes {ratio:.5f} of the plain step's "
          f"FLOPs, outside [1/{n}, {SPLIT_FLOPS_MAX}/{n}]")


def model_split_child() -> None:
    """The "model split" phase's subprocess (docstring): one card, and no
    process group running, so that it can start the fake world."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    split_train_pair("model split", split_cfg(), split_shape(),
                     torch.device("cuda", 0), card_line())


def check_model_split(dev, card: str) -> None:
    """The "model split" phase (docstring), in a subprocess that sees the
    card (``model_split_child``)."""
    run_child_phase("model split", "model_split_child", dev, card)


#: the "serve split" phase (docstring): the batches of its prefill and of
#: its decode step, and the decode step's position. One prompt: the plain
#: prefill's float32 scores of a kv block (8.6 GB a prompt) and its
#: logits (10 GB a prompt in bfloat16) take most of the card; eight decode
#: rows, decode_32k's 128 over the 16 ranks of ``data`` of the production
#: mesh; the position past three quarters of the 32 768 slots
SERVE_SPLIT_PREFILL_BATCH = 1
SERVE_SPLIT_DECODE_BATCH = 8
SERVE_SPLIT_INDEX = 3 * 32768 // 4


def serve_split_steps(dev, mesh, cfg, plain_prefill: bool = True):
    """The four steps of a serving split phase of ``cfg`` on ``mesh``
    (rank 0's steps; a (1, 16) mesh of a fake world) and on one rank:
    {label: (kind, build, meta_args, real_args)} as ``dry_step`` takes
    them, and the prefill and decode shapes. Tokens from a numpy seed.
    ``plain_prefill`` False: the plain prefill is predicted only (its
    real_args None)."""
    import numpy as np
    import torch

    from repro_torch.config import SHAPES, ShapeConfig
    from repro_torch.core import prng
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import (build_decode, build_prefill,
                                          cache_specs, input_specs)
    from repro_torch.models.model import Model
    from repro_torch.parallel import kvcache

    shapes = {
        "prefill": ShapeConfig(
            f"prefill_32k cut to a batch of {SERVE_SPLIT_PREFILL_BATCH}",
            "prefill", SHAPES["prefill_32k"].seq_len,
            SERVE_SPLIT_PREFILL_BATCH),
        "decode": ShapeConfig(
            f"decode_32k cut to a batch of {SERVE_SPLIT_DECODE_BATCH}",
            "decode", SHAPES["decode_32k"].seq_len,
            SERVE_SPLIT_DECODE_BATCH)}
    rng = np.random.default_rng(0)
    pre, dec = shapes["prefill"], shapes["decode"]
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (pre.global_batch, pre.seq_len), dtype=np.int32))
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (dec.global_batch, 1), dtype=np.int32))
    model = Model(cfg, dev)

    def at(args):
        # the decode step's host position in place of the builder's 0
        return args[:3] + (SERVE_SPLIT_INDEX,) + args[4:]

    def split_build(builder, shape):
        def build():
            fn, meta, shs, _ = builder(cfg, shape, mesh)
            return fn, meta, shs
        return build

    def split_real(shape, batch):
        def real(meta, shs):
            params = kvcache.place(Model(cfg, dev).init(prng.key(0)),
                                   shs[0])
            caches = kvcache.init_blocks(cfg, shape.global_batch,
                                         shape.seq_len, shs[2], dev)
            args = (params, kvcache.place(batch(), shs[1]), caches, 0)
            return at(args) if shape.kind == "decode" else args[:3]
        return real

    def plain_prefill_step(params, batch, caches):
        with torch.no_grad():
            return model.prefill(params, batch, caches)[:2]

    def plain_decode(params, tok, caches, index):
        with torch.no_grad():
            return model.decode_step(params, {"tokens": tok}, caches, index)

    def plain_build(fn, shape):
        def build():
            inputs = ({"tokens": input_specs(cfg, shape)["tokens"]}
                      if shape.kind == "prefill" else tok.to("meta"))
            return fn, (model.shapes(), inputs, cache_specs(
                cfg, shape.global_batch, shape.seq_len), 0), None
        return build

    def plain_meta(kind):
        def meta_args(meta, shs):
            args = tuple(dryrun.meta_blocks(a, None) for a in meta)
            return at(args) if kind == "decode" else args[:3]
        return meta_args

    def plain_real(shape, batch):
        def real(meta, shs):
            args = (Model(cfg, dev).init(prng.key(0)), batch(),
                    model.init_caches(shape.global_batch, shape.seq_len), 0)
            return at(args) if shape.kind == "decode" else args[:3]
        return real

    steps = {
        "prefill split": ("prefill", split_build(build_prefill, pre),
                          lambda m, s: dryrun.step_args("prefill", m, s),
                          split_real(pre, lambda: {"tokens": tokens.to(dev)})),
        "prefill plain": ("prefill", plain_build(plain_prefill_step, pre),
                          plain_meta("prefill"),
                          plain_real(pre, lambda: {"tokens": tokens.to(dev)})
                          if plain_prefill else None),
        "decode split": ("decode", split_build(build_decode, dec),
                         lambda m, s: at(dryrun.step_args("decode", m, s)),
                         split_real(dec, lambda: tok.to(dev))),
        "decode plain": ("decode", plain_build(plain_decode, dec),
                         plain_meta("decode"),
                         plain_real(dec, lambda: tok.to(dev))),
    }
    return steps, shapes


def serve_split_reckoning(cfg, shape) -> str:
    """The plain prefill's bytes, reckoned from the config: the float32
    parameters, the bfloat16 casts of one layer and of the unembedding
    table, one kv block's float32 scores of the blockwise attention (every
    query head against ``kv_block`` = 1 024 keys) and the logits."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(Model(cfg, "cpu").shapes())
    params = sum(t.numel() for t in leaves)
    act = dtype_of(cfg.dtype).itemsize
    table = cfg.padded_vocab * cfg.d_model
    layer = (params - table * (1 if cfg.tie_embeddings else 2)) // \
        cfg.num_layers
    b, s = shape.global_batch, shape.seq_len
    scores = b * cfg.num_heads * s * min(1024, s) * 4
    logits = b * s * cfg.padded_vocab * act
    parts = {"float32 parameters": params * 4,
             f"{cfg.dtype} casts of a layer": layer * act,
             f"{cfg.dtype} cast of the unembedding table": table * act,
             "float32 scores of one kv block": scores,
             f"{cfg.dtype} logits ({b} x {s} x {cfg.padded_vocab})": logits}
    return ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in parts.items())


def split_serve_pairs(name: str, cfg, dev, card: str,
                      plain_prefill: bool = True, whole=None) -> None:
    """Phase ``name``'s serving steps of ``cfg`` (``serve_split_steps``),
    each through ``dry_step``; checks each split step's FLOPs between 1 / n
    and SPLIT_FLOPS_MAX / n of its plain step's, or, with ``whole`` (a
    function of the step's kind and shape: the FLOPs of it that every rank
    computes whole), ``split_bound`` / n."""
    import torch

    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.parallel import sharding

    n = math.prod(SPLIT_MESH)
    res = {}
    with fake_world(n):
        mesh = make_mesh(SPLIT_MESH, ("data", "model"), "cuda")
        steps, shapes = serve_split_steps(dev, mesh, cfg, plain_prefill)
        print(f"{name}: {cfg.name} at full width cut to "
              f"{cfg.num_layers} layers; {shapes['prefill'].name} "
              f"({shapes['prefill'].seq_len} positions), "
              f"{shapes['decode'].name} ({shapes['decode'].seq_len} slots, "
              f"position {SERVE_SPLIT_INDEX}); the plain prefill reckoned: "
              f"{serve_split_reckoning(cfg, shapes['prefill'])}", flush=True)
        with sharding.use_mesh(mesh, sharding.act_rules_for(cfg, mesh)):
            for label, (kind, build, meta_args, real_args) in steps.items():
                where = (f"rank 0 of {SPLIT_MESH} on a fake world of {n}"
                         if label.endswith("split") else "one rank")
                res[label] = dry_step(
                    f"{cfg.name} {cfg.num_layers}-layer {kind} step, "
                    f"{where}", build, meta_args, real_args, dev, card,
                    timed=1)
                gc.collect()
                torch.cuda.empty_cache()
    for kind in ("prefill", "decode"):
        split, plain = res[f"{kind} split"], res[f"{kind} plain"]
        ratio = split["flops"] / plain["flops"]
        most = SPLIT_FLOPS_MAX
        if whole is not None:
            counted = whole(kind, shapes[kind])
            most = split_bound(n, counted, plain["flops"])
            print(f"{name} {kind}: every rank computes {counted} of the "
                  f"plain step's {plain['flops']} FLOPs whole (op_cost): "
                  f"the rank's bound x{n} {most:.4f}", flush=True)
        if plain["peak"] is None:
            versus = (f"the plain step (predicted only): {plain['flops']} "
                      f"FLOPs, arguments + temp "
                      f"{plain['predicted'] / 2**30:.3f} GiB")
        else:
            versus = (f"the plain step: {plain['flops']} FLOPs, step "
                      f"{plain['ms'][0]:.1f} ms, peak "
                      f"{plain['peak'] / 2**30:.3f} GiB, logits "
                      f"{plain['first_shape']}; step ms ratio "
                      f"{split['ms'][0] / plain['ms'][0]:.4f}, peak ratio "
                      f"{split['peak'] / plain['peak']:.4f}")
        print(f"{name} {kind}: rank 0 of {SPLIT_MESH}: "
              f"{split['flops']} FLOPs, step {split['ms'][0]:.1f} ms (host "
              f"clock, after a warm-up step), peak "
              f"{split['peak'] / 2**30:.3f} GiB, logits block "
              f"{split['first_shape']}; {versus}; the rank's FLOPs x {n} "
              f"over the plain step's {ratio * n:.4f}; {card}", flush=True)
        check(1 / n <= ratio <= most / n,
              f"{name} {kind}: the rank computes {ratio:.5f} of the "
              f"plain step's FLOPs, outside [1/{n}, {most:.4f}/{n}]")


def serve_split_child() -> None:
    """The "serve split" phase's subprocess (docstring): one card, and no
    process group running, so that it can start the fake world."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    split_serve_pairs("serve split", split_cfg(), torch.device("cuda", 0),
                      card_line())


def check_serve_split(dev, card: str) -> None:
    """The "serve split" phase (docstring), in a subprocess that sees the
    card (``serve_split_child``)."""
    run_child_phase("serve split", "serve_split_child", dev, card)


#: the "moe split" phase (docstring): the MoE family at full width cut to
#: MOE_SPLIT_LAYERS layers (a dense layer and an MoE layer): the train
#: step of MOE_SPLIT_TRAIN_ARCH, the serving steps of
#: MOE_SPLIT_SERVE_ARCH (MLA), each as rank 0 of SPLIT_MESH beside the
#: plain one-rank step
MOE_SPLIT_LAYERS = 2
MOE_SPLIT_TRAIN_ARCH = "deepseek-moe-16b"
MOE_SPLIT_SERVE_ARCH = "deepseek-v2-236b"


def moe_split_cfg(arch: str):
    from repro_torch.config import get_config

    return dataclasses.replace(get_config(arch), num_layers=MOE_SPLIT_LAYERS)


def moe_split_child() -> None:
    """The "moe split" phase's subprocess (docstring): one card, and no
    process group running, so that it can start the fake world."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev, card = torch.device("cuda", 0), card_line()
    t0 = time.perf_counter()
    split_train_pair("moe split", moe_split_cfg(MOE_SPLIT_TRAIN_ARCH),
                     split_shape(), dev, card)
    print(f"moe split: the train steps' wall {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    split_serve_pairs("moe split", moe_split_cfg(MOE_SPLIT_SERVE_ARCH), dev,
                      card, plain_prefill=False)


def check_moe_split(dev, card: str) -> None:
    """The "moe split" phase (docstring), in a subprocess that sees the
    card (``moe_split_child``)."""
    run_child_phase("moe split", "moe_split_child", dev, card)


#: the "recurrent split" phase (docstring): each arch at full width cut
#: in depth (seamless's encoder too), with the shapes its steps run
RECURRENT_SPLIT = (("mamba2-780m", 2, ("train", "serve")),
                   ("recurrentgemma-2b", 3, ("serve",)),
                   ("seamless-m4t-large-v2", 2, ("train",)))


def recurrent_split_cfg(arch: str, layers: int):
    from repro_torch.config import get_config

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, num_encoder_layers=layers)
    return cfg


def whole_attention_flops(cfg):
    """recurrentgemma-2b's bound: a function of a serving step's kind and
    shape giving op_cost's FLOPs (meta tensors) of the step's local MQA
    attention layers on one rank, Model.prefill's bulk prefill into a
    window of slots, or a decode step at SERVE_SPLIT_INDEX. Its 10 heads
    do not divide 16, so every rank computes those layers whole (its
    slots split in a decode step, so that bound is loose there)."""
    import torch

    from repro_torch.launch import op_cost
    from repro_torch.models import attention as attn
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.params import param_shapes
    from repro_torch.models.transformer import layer_slice, positions_for

    layers = sum(kind == "attention" for kind in
                 (cfg.rglru.block_pattern * cfg.num_layers)[:cfg.num_layers])

    def count(kind, shape):
        b = shape.global_batch
        sq = shape.seq_len if kind == "prefill" else 1
        start = 0 if kind == "prefill" else SERVE_SPLIT_INDEX
        params = param_shapes(lambda make: attn.make_gqa(make, "mix", cfg),
                              dtype=dtype_of(cfg.param_dtype))
        x = torch.empty((b, sq, cfg.d_model), dtype=dtype_of(cfg.dtype),
                        device="meta")
        cache = layer_slice(attn.init_kv_cache(
            cfg, b, min(shape.seq_len, cfg.window_size), 1,
            dtype_of(cfg.dtype), "meta"), 0)._replace(index=start)

        def layer(params, x, cache):
            return attn.gqa_attention(
                params, x, positions_for(b, sq, start, "meta"), cfg,
                causal=True, window=cfg.window_size, cache=cache)

        with torch.no_grad():
            flops = op_cost.analyze(layer, (params, x, cache))[1]["flops"]
        return layers * flops

    return count


def warm_workspaces(dev) -> int:
    """Allocate the card libraries' workspaces (cuBLAS and cuBLASLt, held
    for the process once the first products run, one for each thread that
    runs them: this one and autograd's device thread) with a few small
    products of each dtype, forward and backward, so that ``dry_step``
    counts them as held before its step: its prediction is the step's own
    tensors. Returns the bytes they took."""
    import torch

    before = torch.cuda.memory_allocated(dev)
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.ones((4, 64, 64), dtype=dtype, device=dev,
                       requires_grad=True)
        out = (a @ a).sum() + (a[0] @ a[0]).sum() + torch.addmm(
            a[0], a[0], a[0]).sum()
        torch.autograd.grad(out, a)
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev) - before


def recurrent_split_child() -> None:
    """The "recurrent split" phase's subprocess (docstring): one card, and
    no process group running, so that it can start the fake world."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev, card = torch.device("cuda", 0), card_line()
    print(f"recurrent split: the libraries' workspaces take "
          f"{warm_workspaces(dev)} B, held before every step", flush=True)
    for arch, layers, kinds in RECURRENT_SPLIT:
        t0 = time.perf_counter()
        cfg = recurrent_split_cfg(arch, layers)
        if "train" in kinds:
            split_train_pair("recurrent split", cfg, split_shape(), dev, card)
            gc.collect()
            torch.cuda.empty_cache()
        if "serve" in kinds:
            whole = (whole_attention_flops(cfg) if cfg.rglru is not None
                     else None)
            split_serve_pairs("recurrent split", cfg, dev, card,
                              whole=whole)
            gc.collect()
            torch.cuda.empty_cache()
        print(f"recurrent split: {arch} wall "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def check_recurrent_split(dev, card: str) -> None:
    """The "recurrent split" phase (docstring), in a subprocess that sees
    the card (``recurrent_split_child``)."""
    run_child_phase("recurrent split", "recurrent_split_child", dev, card)


def run_child_phase(name: str, child: str, dev, card: str) -> None:
    """Phase ``name``: ``chip_smoke.<child>()`` in a subprocess that sees
    the card, its output printed; fails where the child does."""
    import torch

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{name}: this process holds "
          f"{torch.cuda.memory_allocated(dev)} B allocated, "
          f"{torch.cuda.memory_reserved(dev)} B reserved", flush=True)
    code = ("import sys\n"
            "import chip_smoke\n"
            "try:\n"
            f"    chip_smoke.{child}()\n"
            "except chip_smoke.PhaseError as e:\n"
            f"    print(f'{name}: FAILED: {{e}}', flush=True)\n"
            "    sys.exit(1)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=900)
    print(res.stdout, end="", flush=True)
    check(res.returncode == 0,
          f"{name}: the subprocess failed ({res.returncode}): "
          f"{res.stdout[-1500:]} {res.stderr[-3000:]}")
    print(f"{name} phase: wall {time.perf_counter() - t0:.1f} s; {card}",
          flush=True)


def check_oom_classification(dev) -> None:
    """A real allocation failure on the card, and a kernel wrapper's launch
    error for cudaErrorMemoryAllocation, both classify as OOM (the
    stream's retry policy halves the batch for them)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.validate import is_oom_error

    try:
        torch.empty(1 << 50, dtype=torch.uint8, device=dev)
        check(False, "a 1 PiB allocation succeeded")
    except torch.cuda.OutOfMemoryError as e:
        check(is_oom_error(e), f"torch OOM not classified: {e}")
    try:
        kernels.raise_on(2, "fused_sim_dense")
    except RuntimeError as e:
        check(is_oom_error(e), f"launch error not classified: {e}")
        print(f"OOM classification: torch.cuda.OutOfMemoryError and "
              f"'{e}' both OOM-class", flush=True)
    torch.cuda.empty_cache()


def print_stages(label: str, sim, key, depos) -> None:
    _, timings = sim.timed(key, depos, warmup=1, iters=5)
    total = sum(timings.values())
    print(f"{label} stages (CUDA events, median of 5): " + ", ".join(
        f"{n} {s*1e3:.3f} ms ({100*s/total:.1f}%)"
        for n, s in timings.items()) + f"; sum {total*1e3:.3f} ms",
        flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bfloat16 products sum in float32, as the reference's XLA sums them
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from repro_torch import kernels
    from repro_torch.config import get_config
    from repro_torch.core import prng
    from repro_torch.core.depo import (DepoSet, generate_depos,
                                       generate_physical_depos)
    from repro_torch.kernels.fused_sim import kernel
    from repro_torch.kernels.hitfind import kernel as hit_kernel
    from repro_torch.kernels.hitfind import ref as hit_ref
    from repro_torch.kernels.rasterize import kernel as raster_kernel
    from repro_torch.kernels.rasterize.ops import rasterize_depos
    from repro_torch.kernels.scatter_add import kernel as scatter_kernel
    from repro_torch.launch.sim import max_dev, run_events

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    phase("device")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}; device 0: {kind}; devices: {count}")
    print(card, flush=True)

    phase("build")
    t0 = time.perf_counter()
    logs = kernels.build_all()
    for name, log in logs.items():
        print(f"[nvcc {name}]\n{log.strip()}")
    print(f"build: {time.perf_counter() - t0:.2f} s set-up "
          f"({', '.join(logs) or 'cached'})", flush=True)

    phase("division")
    check(check_division(dev), "drift_depos or from_mm on the card differs "
          "from its float32 formulas")
    check_oom_classification(dev)

    phase("kernels vs plain")
    full = get_config("lartpc-uboone")
    full3 = dataclasses.replace(full, num_planes=PLANES)
    key0 = prng.fold_in(prng.key(0), 0)
    edge_cfg = dataclasses.replace(full, num_wires=96, num_ticks=768,
                                   num_depos=128)
    one = dataclasses.replace(edge_cfg, num_depos=1)
    cases = fused_cases(dev)
    fused_errors = [(check_multiplane if isinstance(case, MultiPlaneCase)
                     else check_kernels)(case, label)
                    for label, case in cases]
    main_case, multi_case = cases[0][1], cases[-1][1]
    errors, multi_errors = fused_errors[0], fused_errors[-1]

    scatter_case = ScatterCase(full, key0, 64, 256, dev)
    scatter_errors = check_scatter(scatter_case,
                                   "scatter-add full width 64x256 tiles")
    # the bfloat16 patches of unfused_bf16 without fluctuation
    bf16_case = ScatterCase(full, key0, 64, 256, dev, bf16=True)
    bf16_errors = check_scatter(bf16_case, "scatter-add bfloat16 full width "
                                "64x256 tiles")
    for bf16 in (False, True):
        tag = "scatter-add bfloat16" if bf16 else "scatter-add"
        check_scatter(ScatterCase(edge_cfg, prng.key(1), 32, 128, dev,
                                  bf16=bf16),
                      f"{tag} tile-edge 96x768, 32x128 tiles")
        # tiles of 30 wires (no multiple of the 4 row parts: no list
        # splits), and patches of 72 x 40 (wider than a 64-wire tile, two
        # 32-column blocks a row)
        check_scatter(ScatterCase(edge_cfg, prng.key(4), 30, 128, dev,
                                  bf16=bf16),
                      f"{tag} tile-edge 96x768, 30x128 tiles")
        check_scatter(ScatterCase(dataclasses.replace(
            edge_cfg, patch_wires=72, patch_ticks=40), prng.key(4), 64, 128,
            dev, bf16=bf16),
            f"{tag} tile-edge 96x768, 72x40 patches, 64x128 tiles")
        for label, values in ONE_DEPO_CASES:
            depos = DepoSet(*(torch.tensor([v], dtype=torch.float32,
                                           device=dev) for v in values))
            check_scatter(ScatterCase(one, prng.key(2), 64, 256, dev, depos,
                                      bf16=bf16),
                          f"{tag} one depo, {label}")
        # a list filling k_max = 48 (no multiple of the 32-entry chunk);
        # the launch expects ~67 entries over >= 132 resident CTAs, so its
        # long-list threshold is 0 and the tile runs split over 4 CTAs by
        # row
        full_scatter = ScatterCase(
            dataclasses.replace(edge_cfg, num_depos=FULL_LIST), prng.key(3),
            64, 256, dev, full_list_depos(dev), k_max=FULL_LIST, bf16=bf16)
        check(int((full_scatter.ids.view(-1, FULL_LIST) >= 0).sum(1).max())
              == FULL_LIST, "scatter k_max 48 case: no list fills k_max")
        check_scatter(full_scatter, f"{tag} {FULL_LIST} depos, one list "
                      f"filling k_max {FULL_LIST}, split over 4 CTAs")

    raster_case = RasterCase(full, key0, dev)
    raster_err = 0.0
    for fluct in (True, False):
        got, again = raster_case.kernel(fluct), raster_case.kernel(fluct)
        want = raster_case.plain(fluct)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = float((got == want).float().mean())
        print(f"rasterize fluctuate={fluct}: patches {tuple(got.shape)}, max "
              f"|kernel - plain| = {err:.6g}, bitwise-equal share {same}; "
              f"max |patch| {float(want.abs().max()):.6g}", flush=True)
        check(torch.equal(got, want), f"rasterize fluctuate={fluct}: kernel "
              "!= plain version")
        check(torch.equal(got, again), f"rasterize fluctuate={fluct}: not "
              "bit-identical run to run")
        check(bool((got[:, full.patch_wires:] == 0).all()
                   and (got[:, :, full.patch_ticks:] == 0).all()),
              "rasterize: non-zero padding")
        check(bool((got >= 0).all()) and float(got.sum()) > 0,
              f"rasterize fluctuate={fluct}: negative or empty patches")
        raster_err = max(raster_err, err)
        del got, again, want

    phase("main path")
    adcs = {}
    launches = {}
    for strategy in STRATEGIES:
        cfg = dataclasses.replace(full, charge_grid_strategy=strategy)
        adcs[strategy], launches[strategy], sim, _ = run_main(
            cfg, strategy, EVENTS, dev, [kernel], card=card)
        print_stages(strategy, sim, key0, generate_depos(key0, full,
                                                         device=dev))
    check(launches["fused_pallas"]["fused_rasterize_scatter"] == EVENTS,
          f"dense kernel launches {launches['fused_pallas']}")
    check(launches["fused_pallas_compact"]["fused_rasterize_scatter_compact"]
          == EVENTS, f"compact kernel launches "
          f"{launches['fused_pallas_compact']}")
    for ev in range(EVENTS):
        check(torch.equal(adcs[STRATEGIES[0]][ev], adcs[STRATEGIES[1]][ev]),
              f"event {ev}: fused_pallas and fused_pallas_compact ADC differ")
    print(f"ADC of all {EVENTS} events identical between {STRATEGIES}")

    unfused = run_events(full, 1, seed=0, device=dev, on_event=lambda ev,
                         out, dt: print(f"unfused event {ev}: {dt*1e3:.3f} "
                                        f"ms, max dev {max_dev(out.adc, full)}"
                                        f"; {card}"))
    check(unfused["events"] == 1, "unfused run")

    for strategy in MULTI_STRATEGIES:
        cfg = dataclasses.replace(full3, charge_grid_strategy=strategy)
        adcs[strategy], launches[strategy], sim, _ = run_main(
            cfg, strategy, EVENTS, dev, [kernel], card=card)
        print_stages(strategy, sim, key0, generate_physical_depos(
            key0, full3, device=dev))
        name = strategy.replace("fused_pallas", "fused_rasterize_scatter")
        check(launches[strategy][name] == EVENTS,
              f"{strategy}: kernel launches {launches[strategy]}")
    for ev in range(EVENTS):
        check(torch.equal(adcs[MULTI_STRATEGIES[0]][ev],
                          adcs[MULTI_STRATEGIES[1]][ev]),
              f"event {ev}: {MULTI_STRATEGIES} ADC differ")
    print(f"ADC of all {EVENTS} three-plane events identical between "
          f"{MULTI_STRATEGIES}")
    loop_cfg = dataclasses.replace(full3, charge_grid_strategy="fused_pallas",
                                   plane_batching="loop")
    loop_adcs, loop_launches, _, _ = run_main(loop_cfg, "fused_pallas loop",
                                              1, dev, [kernel], card=card)
    check(loop_launches["fused_rasterize_scatter"] == PLANES,
          f"per-plane loop launches {loop_launches}")
    check(torch.equal(loop_adcs[0], adcs[MULTI_STRATEGIES[0]][0]),
          "event 0: the multi-plane launch differs from the per-plane loop "
          "of the one-plane kernel")
    print("event 0: multi-plane stacked ADC == per-plane loop of the "
          "one-plane kernel, bit for bit")

    for scatter in SCATTER_STRATEGIES:
        cfg = dataclasses.replace(full, scatter_strategy=scatter)
        with count_calls(PLACEMENT) as placements:
            adcs[scatter], launches[scatter], sim, _ = run_main(
                cfg, f"unfused+{scatter}", SCATTER_EVENTS, dev,
                [scatter_kernel], card=card)
        print_stages(f"unfused+{scatter}", sim, key0,
                     generate_depos(key0, full, device=dev))
        name = f"scatter_add_{scatter}"
        check(launches[scatter][name] == SCATTER_EVENTS,
              f"{scatter}: kernel launches {launches[scatter]}")
        check(placements == [0] * len(PLACEMENT), f"unfused+{scatter}: the "
              f"blocks were placed on the card {placements}")
    print(f"unfused+pallas_compact: the kernel wrote the grid in place (no "
          f"call of {', '.join(m + '.' + f for m, f in PLACEMENT)})")
    for ev in range(SCATTER_EVENTS):
        check(torch.equal(adcs["pallas"][ev], adcs["pallas_compact"][ev]),
              f"event {ev}: unfused pallas and pallas_compact ADC differ")
    print(f"ADC of all {SCATTER_EVENTS} unfused events identical between "
          f"{SCATTER_STRATEGIES}")

    # unfused_bf16, config (a): no fluctuation, so the bfloat16 patches
    # reach the scatter kernel; config (b): fluctuation on (the physics
    # default), so float32 patches reach it
    bf16_a = dataclasses.replace(full, charge_grid_strategy="unfused_bf16",
                                 fluctuate=False)
    for n_planes in (1, PLANES):
        for scatter in SCATTER_STRATEGIES:
            cfg = dataclasses.replace(bf16_a, num_planes=n_planes,
                                      scatter_strategy=scatter)
            label = f"unfused_bf16 (a) {n_planes} plane(s) +{scatter}"
            adcs[label], launches[label], sim, _ = run_main(
                cfg, label, SCATTER_EVENTS, dev, [scatter_kernel], card=card)
            name = f"scatter_add_{scatter}"
            want = SCATTER_EVENTS * n_planes
            check(launches[label][name + "_bf16"] == want
                  == launches[label][name],
                  f"{label}: bfloat16 kernel launches {launches[label]}")
            if n_planes == 1:
                print_stages(label, sim, key0, generate_depos(key0, full,
                                                              device=dev))
        pair = [f"unfused_bf16 (a) {n_planes} plane(s) +{scatter}"
                for scatter in SCATTER_STRATEGIES]
        for ev in range(SCATTER_EVENTS):
            check(torch.equal(adcs[pair[0]][ev], adcs[pair[1]][ev]),
                  f"event {ev}: {pair} ADC differ")
        print(f"unfused_bf16 (a), {n_planes} plane(s): every scatter-add "
              f"launch took bfloat16 patches; ADC of all {SCATTER_EVENTS} "
              f"events identical between {SCATTER_STRATEGIES}", flush=True)
        cfg = dataclasses.replace(bf16_a, num_planes=n_planes, fluctuate=True,
                                  scatter_strategy="pallas")
        label = f"unfused_bf16 (b) {n_planes} plane(s) +pallas"
        _, launches[label], sim, _ = run_main(
            cfg, label, SCATTER_EVENTS, dev, [scatter_kernel], card=card)
        check(launches[label]["scatter_add_pallas"] == SCATTER_EVENTS
              * n_planes and launches[label]["scatter_add_pallas_bf16"] == 0,
              f"{label}: the fluctuated patches are float32, launches "
              f"{launches[label]}")
        if n_planes == 1:
            print_stages(label, sim, key0, generate_depos(key0, full,
                                                          device=dev))

    check_determinism(full, key0, dev, scatter_case)

    recon_cfg = dataclasses.replace(full3,
                                    charge_grid_strategy=MULTI_STRATEGIES[0])
    recon_adcs, launches["recon"], sim, recon0 = run_main(
        recon_cfg, "recon", EVENTS, dev, [kernel, hit_kernel], recon=True,
        card=card)
    print_stages("recon", sim, key0, generate_physical_depos(
        key0, full3, device=dev))
    check(launches["recon"]["hitfind_pallas"] == PLANES * EVENTS,
          f"recon: hit-scan launches {launches['recon']} != planes x events")
    check(launches["recon"]["fused_rasterize_scatter_multiplane"] == EVENTS,
          f"recon: charge-grid launches {launches['recon']}")
    for ev in range(EVENTS):
        check(torch.equal(recon_adcs[ev], adcs[MULTI_STRATEGIES[0]][ev]),
              f"event {ev}: the recon graph's ADC differs from the sim-only "
              "graph's")
    print(f"ADC of all {EVENTS} recon events identical to the sim-only run")

    depos0 = generate_depos(key0, full, device=dev)
    raster_kernel.reset_launches()
    for fluct in (True, False):
        patches, _, _ = rasterize_depos(key0, depos0, full, fluctuate=fluct,
                                        device=dev)
        torch.cuda.synchronize()
        check(tuple(patches.shape) == (full.num_depos, raster_case.pw_pad,
                                       raster_case.pt_pad)
              and bool(torch.isfinite(patches).all()),
              f"rasterize_depos fluctuate={fluct}: {tuple(patches.shape)}")
        print(f"rasterize_depos fluctuate={fluct}: {tuple(patches.shape)} "
              f"patches, total charge {float(patches.sum()):.6g}", flush=True)
    launches["rasterize"] = dict(raster_kernel.LAUNCHES)
    check(launches["rasterize"]["rasterize_pallas"] == 2,
          f"rasterize_depos launches {launches['rasterize']}")
    del patches

    planes0 = [(f"recon event 0 plane {p}", recon0.decon[p].contiguous())
               for p in range(PLANES)]
    cap = full.max_hits_per_wire
    hit_err = check_hitfind(planes0, cap)
    # the plane with the most runs at HIT_CAPS[-1] stored runs per wire
    hit_err = max(hit_err, check_hitfind(planes0[-1:], HIT_CAPS[-1]))
    for label, grid in planes0:
        print(f"hit scan {label}: "
              f"{run_length_stats(stored_run_lengths(grid, HIT_THRESHOLD, cap))}",
              flush=True)
    edge_grids = [g for t in HIT_CASE_TICKS for g in hit_edge_grids(dev, t)]
    for threshold in HIT_THRESHOLDS:
        for edge_cap in HIT_CAPS:
            hit_err = max(hit_err, check_hitfind(edge_grids, edge_cap,
                                                 threshold))
    print("hit scan: kernel == plain version bit for bit on every plane and "
          f"edge case (thresholds {HIT_THRESHOLDS}, caps {HIT_CAPS})",
          flush=True)

    phase("stream")
    stream_launches = check_streams(full, dev, [kernel, scatter_kernel,
                                                hit_kernel], card)
    on_path = ("fused_rasterize_scatter", "fused_rasterize_scatter_compact",
               "fused_rasterize_scatter_multiplane",
               "fused_rasterize_scatter_multiplane_compact",
               "scatter_add_pallas", "scatter_add_pallas_compact",
               "hitfind_pallas")
    check(all(stream_launches.get(name, 0) > 0 for name in on_path),
          f"a kernel of the stream path never launched: {stream_launches}")
    print(f"stream launches over the clean streams: {stream_launches}",
          flush=True)

    phase("tune")
    tune_launches = check_tune(full, dev, [kernel, scatter_kernel,
                                           hit_kernel, raster_kernel], card)
    check(all(tune_launches.get(name, 0) > 0 for name in on_path),
          f"a kernel candidate never launched in the tuning: {tune_launches}")

    phase("fit")
    check_fit(full, dev, [kernel, scatter_kernel, hit_kernel, raster_kernel],
              card)

    phase("fig3 and pool")
    pool_launches, pool_errors = check_fig3_pool(
        full, dev, [kernel, scatter_kernel, hit_kernel, raster_kernel], card)
    pool_path = ("scatter_add_pallas", "scatter_add_pallas_compact",
                 "hitfind_pallas")
    check(all(pool_launches.get(name, 0) > 0 for name in pool_path),
          f"a kernel of the pool path never launched: {pool_launches}")
    scatter_errors = [max(a, b) for a, b in zip(scatter_errors, pool_errors)]

    phase("distributed")
    dist_launches = check_distributed(full, dev, card)

    phase("audit")
    check_audit(dev, card)

    phase("serve")
    check_serve(dev, card)

    phase("families")
    check_families(dev, card)

    phase("kernel timing")
    rows = []
    fused_src = "src/repro_torch/csrc/fused_sim.cu"
    scatter_src = "src/repro_torch/csrc/scatter_add.cu"
    grid0 = planes0[0][1]
    # (name, wrapper call, plain call, plain calls timed, bound, library
    # call or None, source, replaced TPU kernel, main-path run, max error)
    timed = (
        ("fused_rasterize_scatter", main_case.dense, main_case.plain_dense, 3,
         main_case.bound(False), None, fused_src,
         "src/repro/kernels/fused_sim/kernel.py:262", "fused_pallas",
         errors[0]),
        ("fused_rasterize_scatter_compact", main_case.compact,
         main_case.plain_compact, 3, main_case.bound(True), None, fused_src,
         "src/repro/kernels/fused_sim/kernel.py:300", "fused_pallas_compact",
         errors[1]),
        ("fused_rasterize_scatter_multiplane", multi_case.dense,
         multi_case.plain_dense, 2, multi_case.bound(False), None, fused_src,
         "src/repro/kernels/fused_sim/kernel.py:340",
         "fused_pallas_multiplane", multi_errors[0]),
        ("fused_rasterize_scatter_multiplane_compact", multi_case.compact,
         multi_case.plain_compact, 2, multi_case.bound(True), None,
         fused_src, "src/repro/kernels/fused_sim/kernel.py:392",
         "fused_pallas_multiplane_compact", multi_errors[1]),
        ("scatter_add_pallas", scatter_case.dense, scatter_case.plain_dense,
         3, scatter_case.bound(False), scatter_case.library, scatter_src,
         "src/repro/kernels/scatter_add/kernel.py:97", "pallas",
         scatter_errors[0]),
        ("scatter_add_pallas_compact", scatter_case.compact,
         scatter_case.plain_compact, 3, scatter_case.bound(True),
         scatter_case.library, scatter_src,
         "src/repro/kernels/scatter_add/kernel.py:140", "pallas_compact",
         scatter_errors[1]),
        ("scatter_add_pallas_bf16", bf16_case.dense, bf16_case.plain_dense,
         3, bf16_case.bound(False), bf16_case.library, scatter_src,
         "src/repro/kernels/scatter_add/kernel.py:97",
         "unfused_bf16 (a) 1 plane(s) +pallas", bf16_errors[0]),
        ("scatter_add_pallas_compact_bf16", bf16_case.compact,
         bf16_case.plain_compact, 3, bf16_case.bound(True), bf16_case.library,
         scatter_src, "src/repro/kernels/scatter_add/kernel.py:140",
         "unfused_bf16 (a) 1 plane(s) +pallas_compact", bf16_errors[1]),
        ("hitfind_pallas",
         lambda: hit_kernel.hitfind_pallas(grid0, threshold=HIT_THRESHOLD,
                                           cap=cap),
         lambda: hit_ref.hitfind_ref(grid0, threshold=HIT_THRESHOLD,
                                     cap=cap),
         1, hit_bound(grid0, cap), None, "src/repro_torch/csrc/hitfind.cu",
         "src/repro/kernels/hitfind/kernel.py:40", "recon", hit_err),
        ("rasterize_pallas", raster_case.kernel, raster_case.plain, 1,
         raster_case.bound(), None, "src/repro_torch/csrc/rasterize.cu",
         "src/repro/kernels/rasterize/kernel.py:78", "rasterize",
         raster_err))
    # the fused rows' bound over every in-support pixel, as earlier
    # versions of this script counted it (rows compare across versions)
    support_bounds = {
        "fused_rasterize_scatter": main_case.bound(False, True)[0],
        "fused_rasterize_scatter_compact": main_case.bound(True, True)[0],
        "fused_rasterize_scatter_multiplane": multi_case.bound(False, True)[0],
        "fused_rasterize_scatter_multiplane_compact":
            multi_case.bound(True, True)[0]}
    for (name, fn, plain, plain_iters, (bound_ms, bound_by), library,
         source, replaces, run, err) in timed:
        ms, rounds = wrapper_ms(fn)
        on_card_ms = card_ms(fn)
        host_ms = primed_time(fn)[1]
        plain_ms = cuda_time(plain, iters=plain_iters, warmup=1)
        library_ms = wrapper_ms(library)[0] if library else None
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[run][name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_card": on_card_ms,
            "host_ms": host_ms,
            "stream_launches": stream_launches.get(name, 0),
            "tune_launches": tune_launches.get(name, 0),
            "pool_launches": pool_launches.get(name, 0),
            "dist_launches": (sum(dist_launches.values())
                              if name == "hitfind_pallas" else 0)})
        support_text = ""
        if name in support_bounds:
            rows[-1]["bound_all_support_ms"] = support_bounds[name]
            support_text = (f" (pixels with nonzero weights; every in-support "
                            f"pixel {support_bounds[name]:.4f} ms)")
        lib_text = (f"library call index_put_(accumulate=True) "
                    f"{library_ms:.4f} ms" if library else
                    "library call: none (no single PyTorch call computes "
                    "this function)")
        print(f"{name}: {ms:.4f} ms/call of the wrapper (median of 5 rounds "
              f"of 20 calls, CUDA events, host-paced; rounds "
              f"{rounds[0]:.4f}..{rounds[-1]:.4f} ms); on the card alone "
              f"(primed) {on_card_ms:.4f} ms/call; host enqueue "
              f"{host_ms:.4f} ms/call; "
              f"plain {plain_ms:.3f} ms (mean of "
              f"{plain_iters}); bound {bound_ms:.4f} ms ({bound_by})"
              f"{support_text}; "
              f"{lib_text}; launches on the main path "
              f"{launches[run][name]}", flush=True)
    for label, grid in planes0:
        def scan(grid=grid):
            return hit_kernel.hitfind_pallas(grid, threshold=HIT_THRESHOLD,
                                             cap=cap)

        print(f"hitfind_pallas on {label}: {wrapper_ms(scan)[0]:.4f} "
              f"ms/call host-paced, {card_ms(scan):.4f} on the card alone, "
              f"bound {hit_bound(grid, cap)[0]:.4f} ms", flush=True)
    unfluct_ms = wrapper_ms(lambda: raster_case.kernel(False))[0]
    print(f"rasterize_pallas without fluctuation: {unfluct_ms:.4f} ms/call, "
          f"bound {raster_case.bound(False)[0]:.4f} ms "
          f"({raster_case.bound(False)[1]})", flush=True)
    print(f"fused work (entries, in-support pixels, row+column weights, "
          f"pixels with nonzero weights): "
          f"one plane {main_case.work()}, three planes {multi_case.work()}; "
          f"scatter-add (entries, in-tile pixels) {scatter_case.work()}")
    sass = sass_item_instructions()
    if sass is None:
        print("fused kernel SASS: cuobjdump not found, instructions per "
              "pixel not measured")
    else:
        per_pixel, loop, items = sass
        for label, cases_ in (("one plane", [main_case]),
                              ("three planes", multi_case.planes)):
            support = sum(c.work()[1] for c in cases_)
            evaluated = sum(c.work()[3] for c in cases_)
            print(f"fused kernel SASS: {loop} instructions on the fast path "
                  f"of the pixel loop for {items} pixels, {per_pixel:g} per "
                  f"pixel; {label}: {evaluated} of {support} in-support "
                  f"pixels evaluated (nonzero weights), issue floor "
                  f"{issue_floor_ms(per_pixel, evaluated):.4f} ms at the top "
                  f"SM clock ({issue_floor_ms(per_pixel, support):.4f} ms "
                  f"for every in-support pixel)", flush=True)

    phase("train")
    check_train(dev, card)

    phase("parallel")
    check_parallel(dev, card)

    phase("moe train")
    check_moe_train(dev, card)

    phase("serve mesh")
    check_serve_mesh(dev, card)

    phase("dry run")
    check_dryrun(dev, card)

    phase("model split")
    check_model_split(dev, card)

    phase("serve split")
    check_serve_split(dev, card)

    phase("moe split")
    check_moe_split(dev, card)

    phase("recurrent split")
    check_recurrent_split(dev, card)

    print(f"chip_smoke wall: {time.perf_counter() - t_all:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as tmp:
            # every phase but the tune phase runs today's strategies: "auto"
            # resolves through an empty tuning cache of this run's own
            os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tmp)
                                                       / "empty.json")
            sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
