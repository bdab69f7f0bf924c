#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --flags-ab    # a measurement, see ``flags_ab``
    python3 chip_smoke.py --flash       # build and the flash checks only
    python3 chip_smoke.py --gmm         # build and the MoE work only
    python3 chip_smoke.py --pin         # build and the layout pin's check
    python3 chip_smoke.py --norm        # build and the norm backward's check
    python3 chip_smoke.py --quant       # build and the quantization checks
    python3 chip_smoke.py --repairs     # build, the grouped-matmul checks
                                        # and the padded-head-dim flash checks
    python3 chip_smoke.py --fit         # build and the elastic loop
    python3 chip_smoke.py --elastic     # build and the launcher's crash,
                                        # restart and resume (elastic_run)
    python3 chip_smoke.py --dp          # build, train, the elastic loop at
                                        # world 1 and the world of two
    python3 chip_smoke.py --mp          # build and the fsdp/tensor world
    python3 chip_smoke.py --ep          # build and the expert-axis world
    python3 chip_smoke.py --sp          # build and the seq-axis world
                                        # (train_sp2, Ulysses)
    python3 chip_smoke.py --serve-tp    # build and tensor-parallel serving
                                        # (serve_tp2)
    python3 chip_smoke.py --ring        # build and ring attention on the
                                        # seq axis (train_ring2)
    python3 chip_smoke.py --pp          # build and the pipeline on the
                                        # pipe axis (train_pp2)
    python3 chip_smoke.py --digest      # build and the digest kernel check
    python3 chip_smoke.py --serve       # build and the serving phases (serve,
                                        # serve_faults, serve_spec,
                                        # serve_fleet, serve_moe)
    python3 chip_smoke.py --measure     # build and the measurement planes'
                                        # phases (serve, train, train_fit,
                                        # train_dp2, then ``measure``)
    python3 chip_smoke.py --ab DIR ... [--only NAME,...]
                                        # K2a, K4, K6-K9 (and, asked for by
                                        # name, the train step) against
                                        # other trees

Drives the port's main paths, serving, training (with Adafactor, and
with the fused norm backward, the layout pin and the low-bit Adam
optimizers) and mixture-of-experts training, at the full width of GPT-2
1.5B and of its MoE variant (full depth but for the MoE run) with random
weights from a seed, and the CTR loop on the embedding plane at MLPerf
DLRM width, saves and restores the GPT-2 1.5B training state through Flash
Checkpoint, trains and resumes it through ``ElasticTrainer.fit`` (in a
one-process NCCL group, through the mesh), trains it data-parallel in a
world of two processes (replicated, ZeRO-1, the overlap engine, the int8
wires on K5a/K5b) with a live re-layout and a sharded save, trains
Llama-2 7B's width on the fsdp and tensor axes in a world of two
processes with a sharded save, trains the MoE entry's width on the expert
axis (the a2a and int8 a2a dispatch) and on the data axis (the grouped
dispatch) in a world of two processes, trains Llama-2 7B's width on the
seq axis (Ulysses, and ring attention), on the pipe axis (GPipe and the
circular schedule) and serves it tensor-parallel, with a fold 2 -> 1 ->
2 mid-serve, in the same world, serves
under an injected admission fault plan, speculates with a draft, serves a
replica fleet (failover, drain, disaggregated prefill, a live weight
swap, the front door) and the MoE entry, and holds
every CUDA kernel of those paths against its plain PyTorch version.  Imports nothing of JAX or
of the JAX package.  Phases, each one JSON line on stdout:

1. ``device``  the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``   nvcc builds every kernel under ``dlrover_tpu_torch/ops/csrc``
               into ``build/kernels/`` (seconds, ptxas register report).
3. ``kernel_checks``  the flash-attention forward at the serving shapes
               (B=1, H=25, D=64, S in 16/128/512/1000, causal; q/k/v as
               strided views of one fused projection), at the training
               shape (B=16, S=1024), at Ulysses' shape in ``train_sp2``
               (B=1, S=4096, H=16, D=128, causal) and at GQA, segment,
               non-causal and fully-masked-row shapes: error against
               ``mha_reference``
               computed in fp32 from the same bf16 inputs (TF32 off),
               tolerance |o - ref| <= 1e-2 + 1e-2 |ref| and
               |lse - ref| <= 1e-3; kernel, plain and
               ``F.scaled_dot_product_attention`` (yardstick only, never
               called by the port) device times from CUDA events around
               CUDA-graph replays (``eager_*``: back-to-back eager calls,
               host launch gaps included); the roofline bound from this
               call's bytes and unmasked FLOPs.
4. ``bwd_kernel_checks``  the three backward kernels (fused, and the
               split dq + dkv pair) at the training shape B=16, H=25,
               D=64, S=1024 (fused, and split as ``block_kv=512`` takes
               it), GQA 32/8 D=128 S=2048, segments with a pad segment,
               non-causal S=512, fully masked rows, ragged GQA S=900
               (causal, D=64 and D=128) and S=1000 (non-causal, D=128),
               and Ulysses' B=1 S=4096 H=16 D=128 causal (fused);
               every case through both paths against
               ``mha_backward_reference`` in fp32 from the same bf16
               inputs and the kernel's own o and lse.  Each
               of dq, dk, dv: every row (one (b, s, h) vector) within
               ``BWD_ROW_TOL`` of that row's largest |ref| and the tensor
               within ``BWD_NORM_TOL`` in norm-relative error (the limits'
               reasons are where they are set), and exactly 0 where no
               (q, kv) pair is live.  At the training shape the check is
               also shown to fail on planted faults: the diagonal tiles of
               the second half of the sequence dropped or halved in one
               tensor at a time.  Times as in phase 3, each kernel beside
               its own plain version; the yardstick, at the training shape,
               is the backward of ``F.scaled_dot_product_attention``
               through ``torch.autograd.grad`` (device time: forward and
               backward replayed as one CUDA graph, less the forward's;
               the eager time beside it).  Two runs of the fused kernel
               must give bit-equal dk and dv and dq within one bf16 ulp
               of each row's largest value; two runs of the split dkv
               kernel bit-equal dk and dv, equal to the fused kernel's;
               two runs of the split dq kernel (the split path's, on its
               shared pre-pass, and ``flash_bwd_dq``'s own) bit-equal dq.
               On the split cases K2a's time is also read without its
               pre-pass (``prep_share``).
3b. ``pad_flash_checks``  ``mha`` at head dims the kernels have no build
               for (``PAD_CASES``: D 80 with the fused backward, D 96 GQA
               with the split one): q, k and v zero-padded to 128, forward
               and backward through autograd, against the plain versions at
               the true head dim (the phase 3 and 4 tolerances); the
               padding copies (3 forward, 4 backward) and launches a call
               makes.  Then, at the full width of public configs with those
               head dims (``PAD_TIMED_CASES``: Phi-2's 32 x D 80 and
               Phi-3-mini's 32 x D 96 at B16 S1024), the padded call's
               device time beside the kernels alone on inputs padded
               beforehand.
4b. ``gmm_kernel_checks``  the grouped-matmul kernels K8 (forward, and
               dx with w read transposed) and K9 (dw) on every grouped
               product of one MoE layer routed by a real gate (uneven
               groups, one expert empty, padding rows at the tail): the
               MoE step's shape (16 x 1024 tokens, top-2 of 8 experts,
               d_model 1600, d_ff 3200: 33,792 rows), a small ragged one
               with the last expert empty, a swiglu one, and 65, 512 and
               1,536 experts at small widths, many of them empty (the first
               two on the tables the kernels build in shared memory, the
               last on the wrapper's global tables); against
               ``grouped_matmul_reference`` / ``grouped_matmul_dw_reference``
               in fp32 from the same bf16 inputs, each output row within
               ``GMM_ROW_TOL`` of its largest |ref| and the tensor within
               ``GMM_NORM_TOL``, padding rows and empty experts exactly 0;
               three planted faults (a row block times the wrong expert,
               the last K tile (``grouped_matmul.BLOCK_K`` wide) skipped,
               one expert's dw zeroed) must each fail the check.  Every
               product run twice must give bit-equal outputs.  At the MoE
               step's shape: kernel, plain and ``torch._grouped_mm``
               (yardstick only) times, and the host microseconds a wrapper
               call costs.
               Then ``moe_sync_check``:
               one ``MoEMlp`` forward and backward at full width under
               ``torch.cuda.set_sync_debug_mode("error")``.
4c. ``norm_kernel_checks``  the fused norm backward K4 at the training
               step's [16384, 1600] bf16 (LayerNorm with bias, RMSNorm), a
               ragged shape whose width is no multiple of 8, an fp32 one
               and a wide one, against ``layernorm_backward_reference`` in
               fp32 from the same inputs and saved statistics: dx by row
               and by norm (``NORM_ROW_TOL``, ``NORM_NORM_TOL``), dscale
               and dbias by norm (``NORM_PARAM_TOL``); two runs bit-equal
               (dx, dscale, dbias); two planted faults (the mean(g) term
               dropped, the first block's partial row lost) must fail.
               Yardstick ``aten.native_layer_norm_backward``.  ``--norm``
               runs the build and this phase alone.
4d. ``quant_kernel_checks``  K5a and K5b (round trip, and codes and values
               equal to the plain versions'), K6 and K7 on the largest
               leaf's shape [48, 1600, 6400] bf16, one layer of it and two
               ragged shapes, from a state K5a made of a random m and a
               plain-made v, against the plain updates: codes equal but
               for ``QUANT_CODE_SHARE`` of them one level off, scales
               within ``QUANT_SCALE_RTOL``, updates within
               ``QUANT_UPD_NORM_TOL``; two planted faults (v decoded
               linearly, the high nibble dropped) must fail.  No one
               PyTorch call computes these functions: no yardstick.
               Then ``quant_code_check``: K7's codes by its own path (one
               reciprocal a block, a corrected product, thresholds)
               against the IEEE chain (correctly rounded division and
               roots) for every float32 x in [0, s], at every power of
               two s from 2^-126 to 1, FLT_MIN's neighbours and
               ``QUANT_CHECK_RANDOM_SCALES`` seeded scales in [1e-30,
               1e3]: no m level and no v code may differ; one threshold
               of m and one of v moved by an ulp (two planted faults)
               must each be caught.  ``--quant`` runs the build and this
               phase alone.
4e. ``pin_kernel_check``  K11 on [16, 1024, 1600] bf16 contiguous and
               transposed, and on sliced, expanded and byte-sized views:
               contiguous and bit-equal.  Yardstick ``clone()``, timed
               against the kernel in ``PIN_PAIRS`` alternating pairs
               (medians and spreads).  ``--pin`` runs the build and this
               phase alone.
4f. ``embed_kernel_checks``  the hot-row cache's gather K10a and scatter
               K10b (``EMBED_CASES``): the CTR loop's shape (cache
               [4,194,304, 128] fp32, 32,768 slots with a padded tail at
               slot 0), dim 16, the unaligned dim 129, one slot, and a
               scatter whose only duplicates are slot 0 with zero rows, each
               bit-equal to the plain versions; a gather that reads
               ``slots[i] + 1`` and a scatter that drops the last real row
               must fail.  Times over ``EMBED_TIMED_SETS`` slot sets (L2
               cold); yardsticks ``index_select`` and ``index_copy_``.
4g. ``digest_kernel_check``  the SDC digest's byte-sum kernel
               (``ops/csrc/byte_sums.cu``, one launch for every leaf)
               against its plain version (int16 row sums) on GPT-2 1.5B's
               parameter leaves in bf16 and on odd leaves (misaligned,
               empty, one byte, 0-d, bool, transposed, an int): equal
               exactly, two runs equal, a dropped last chunk caught; device
               ms of each and the wrapper's host ms.  ``--digest`` runs the
               build and this phase.
5. ``dispatch``  host microseconds per flash forward under ``no_grad``
               at the S=16 and S=512 prefill shapes, through the custom
               op against the bare kernel call, and the op's first call.
6. ``serve``   ``ServingEngine`` on ``gpt2_config("1.5b",
               attention_impl="flash", param_dtype=bfloat16)``, 8 slots, 16
               requests over every prefill bucket (half greedy, half
               temperature 0.8 / top-k 8): every request returns exactly
               its ``max_new_tokens`` with finite logprobs, and the flash
               kernel launched 48 times (one per layer) per prefill.
               Prefill ms per bucket, decode-step p50/p95, generated
               tokens/s, peak device memory.
6b. ``serve_faults``  the same engine, its 8 greedy requests run plan-free
               and then under a ``serve.admit`` plan failing admission
               attempts ``SERVE_FAULT_HITS`` with a ``RetryPolicy``: every
               request finishes, the streams equal the plan-free run's
               token for token, the telemetry ring holds one fault event
               per fired hit.
6c. ``serve_spec``  speculative decoding on GPT-2 1.5B (full depth and
               width, bf16, flash) damped by ``make_draft(draft_layers=1,
               damp=0.05)`` with its 1-layer draft, γ = 4, 8 slots: the
               same ``SPEC_GREEDY`` and ``SPEC_SAMPLED`` requests through a
               plain and a speculating engine on the damped target.  Every
               request finishes with finite logprobs and tokens in the
               vocab, sampled tokens in their top-k (within ``LOGIT_ATOL``
               of the k-th logit of a no-cache forward); accepted > 0; K1
               launched 48 times a prefill in the plain leg and 48 + 1 in
               the speculating one, none inside propose or verify.  Greedy
               streams equal the plain ones up to a near-tie: the plain
               streams are teacher-forced through the target one token a
               step and in chunks of γ+1 (the largest |verify - plain|
               logit gap is printed), and where a spec stream first
               differs the plain step's top-2 gap must be at most
               ``SPEC_TIE_TOL``.  A planted verify accepting one proposal
               past the first mismatch must fail that check.  Acceptance,
               tokens a verify round, decode-step p50/p95 and tokens/s of
               both legs.
6d. ``serve_fleet``  replicas of GPT-2 1.5B's width at ``FLEET_LAYERS``
               layers, 8 slots each: (a) two mixed replicas under a
               ``replica.death`` plan killing one mid-run: zero lost,
               greedy streams bit-equal to a single engine's, one death, no
               step failure, breakers closed; (b) ``drain`` retires a
               replica without loss, ``maybe_scale`` scales out through
               ``spawn`` and back in; (c) a prefill and a decode replica
               against a colocated one: streams bit-equal, one page a
               request, page bytes as counted from the shapes, decode-step
               p95 of both; (d) a seed-1 bf16 state saved through
               ``CheckpointEngine`` swapped in between two steps with slots
               live: one digest launch, the KV pool, slots and queue
               untouched, no request lost, new streams bit-equal to a
               fresh seed-1 engine's; a ``serve.swap`` plan rolls back; (e)
               ``ServeFrontend``: submit/poll/cancel, ``queue_full``,
               ``shed``, a ``serve.rpc`` fault failing exactly one RPC.
               K1 ``FLEET_LAYERS`` times a prefill, the digest twice.
6e. ``serve_moe``  ``bench.py``'s MoE entry (grouped) at
               ``MOE_TRAIN_LAYERS`` layers, bf16, 8 slots, 8 requests: all
               finish; K8 launched (2 gelu products) x layers x (prefills +
               decode steps), K9 never; one decode step under
               ``set_sync_debug_mode("error")``; prefill logits through K8
               against the plain grouped matmul and a decode step against
               a no-cache forward within ``LOGIT_ATOL``, argmax equal; K8
               at the decode step's 1,152 rows against its plain version
               (``gmm_errors``), and rows routed to the wrong expert must
               fail that check.
7. ``profile`` device time by kernel for one 512-token prefill and one
               decode step (``torch.profiler``).
8. ``parity``  prefill logits through the kernel vs the same model with
               ``mha_reference`` in its place, and one decode step's logits
               vs a no-cache forward of the same prefix, both bf16, within
               atol 0.1 (the logits' std is about 0.8) and the same argmax.
9. ``train``   ``build_train`` on ``gpt2_config("1.5b",
               attention_impl="flash", remat="flash_only",
               param_dtype=bfloat16)`` as ``bench.py`` builds it: batch 16
               x seq 1024, Adafactor lr 1e-4 behind a global-norm clip of
               1.0, full logits (no chunked CE); 1 warm-up then 3 measured
               steps re-fed with one batch (tokens from numpy seed 0).  The
               loss is finite at every step and lower at the end; every
               step launches the flash forward 48 times, the fused backward
               48 times and the split kernels never.  Step time, tokens/s,
               MFU and HFU against 989 TFLOP/s (``bench.py``'s FLOP
               formulas), peak memory, and one profiled step's device-busy
               share and top kernels: the step is captured by the port's
               ``utils.profiler.capture`` (``measure`` (a)).
9b. ``flash_ckpt``  the ``train`` phase's model and step at
               ``FLASH_CKPT_LAYERS`` of 48 layers (cut further if
               ``/dev/shm`` cannot hold the arena: the cut is printed), 1 + 2 steps, then ``Checkpointer.save_checkpoint``
               MEMORY and DISK with ``AsyncCheckpointSaver`` in a spawned
               process, then 2 more steps (the uninterrupted run).  A fresh
               state restored from shm, and one from storage through a
               ``StorageStepReader``, each equal the saved state leaf for
               leaf bit for bit; each then takes the 2 steps, the first
               loss equal to the uninterrupted run's (the forward is
               deterministic: two evaluations of one state give one loss),
               the second within ``CKPT_LOSS_ATOL`` (K3's dq atomics).
               The trainer's state right after ``Train.restore`` must
               equal the saved state bit for bit too.  Three planted
               faults must be caught: the shm restore's params with a
               fresh optimizer state (that check sees it; the losses
               cannot); the saver's
               ``storage.write`` plan fails a third persist (the tracker
               keeps the second step), and one flipped byte in the second
               step's data makes the restore fall back to the first.
               ``df -B1`` of ``/dev/shm`` and the checkpoint disk, arena
               bytes, the memory save's blocking seconds and GB/s, the
               persist seconds, the restore seconds from shm and storage.
9c. ``train_fit``  ``ElasticTrainer`` on the ``train`` phase's model
               (``FIT_CONFIG``: batch 16 x 1024, Adafactor lr 1e-4,
               ``ckpt_every=4``, ``report_every=2``, ``metrics_lag=2``,
               ``prefetch_to_device=2``, ``sdc_check_every=2``,
               ``eval_every=4`` with one eval batch, a checkpoint directory
               under ``build/``), ``fit`` over an ``ElasticDataLoader`` of
               ``synthetic_lm_sample_fn(50304, 1024)`` with a shuffled
               ``ElasticDistributedSampler`` (seed 0; the eval loader seed
               1), 6 steps.  Every step, and every batch the prefetcher
               places and hands out, runs under
               ``torch.cuda.set_sync_debug_mode("error")``; each step
               launches the flash forward and the fused backward 48 times
               each and the split kernels never; the eval batch launches
               the forward 48 times; losses and grad norms finite, no
               numeric anomaly; the batches the prefetcher hands out equal
               the host batches bit for bit; the pipeline counters hold no
               sync block and exactly the ring's 3 flushes (steps 1-2
               after step 3's dispatch, which leaves step 3 running; 3-4
               at the eval; 5-6 at the step-6 save), 1 eval fetch
               and, when the step-6 save found the saver still persisting
               step 4 (and was skipped), the end-of-fit barrier's one wait
               for the saver before it saves step 6.  No wait is added
               for the cadence: the last save is at step 6 and storage
               commits step 6 by ``close()``.
               Two digests of the final state are equal and equal the
               step-6 check's; a planted ``sdc.flip`` changes it (and
               flipping back restores it).  A new trainer on the directory
               resumes at step 6 with the state bit-equal (byte views) and
               the booked ``grad_accum_ref``, and ``fit`` to step 8 takes 2
               finite steps.  Once the step times and the digest's cost
               are taken, the phase starts (``_after_fit_measured``) the
               elastic run in a thread (phase ``elastic_run``, read after
               ``train_dp2``) and spawns the world of two with its warm-up
               (``_warm_rank``), both beside the rest of this phase.  Printed: the
               device time between step starts (CUDA events) and its median
               beside tokens/s and MFU, each checkpoint call's blocking
               seconds and whether it saved, ``close()``'s wait, the restore's
               seconds and source, each host block's seconds by label, and
               the digest's device and host ms and temporary bytes.
               ``--fit`` runs the build and this phase alone;
               ``--fit-gate`` runs ``train`` and then this phase
               ``FIT_GATE_RUNS`` times, reading every run's gate.  The phase
               runs in a one-process NCCL group, its trainer built with
               ``parallel=ParallelConfig(data=-1)`` and ``zero1``,
               ``overlap`` and ``reduce_quant="int8"`` asked for: all three
               must report themselves inactive, and the pipelined step
               (the median of the intervals after steps 2, 3 and 5) must
               be within ``FIT_STEP_RTOL`` (1%) of the ``train`` phase's
               median in the same call.  Printed beside it: the loop's
               timeline (host and device time at each step's start and
               end of dispatch, around the digest, the metrics flush, the
               eval and the save), the host beside it (``host``: each
               garbage collection in the loop and the longest once the
               first step started, each thread's CPU seconds over the fit,
               what a full collection costs after it), and the digest's
               device time queued behind a sleeping kernel and its host
               time by function (cProfile); the digest must equal the
               plain fold of per-leaf byte sums.
9d. ``train_dp2``  two processes on ``cuda:0`` joined in a gloo group
               (every collective staged through host memory,
               ``parallel/wire.py``; the copies counted; the world's
               warm-up read and printed first): GPT-2 1.5B's
               width at ``DP2_LAYERS`` of 48 layers (printed), global
               batch 16 x 1024, 8 rows a rank.  For Adafactor and q8_adam
               (clip 1.0, lr 1e-4), ``DP2_STEPS`` steps each of the
               replicated step, ZeRO-1, ZeRO-1 with the overlap engine and
               two microbatches, and ZeRO-1 with the int8 reduce-scatter
               and all-gather: each held against the world-1 run of the
               same model, batch and seed (``DP2_*`` limits and their
               reasons; the int8 runs' step 1 also against the
               reference's step-1 parameters through the same block
               rounding, and the reference's init checked as a run's
               must fail), both replicas' parameters equal, every step's
               launches (K1, K3; K5a/K5b on the int8 wire; K6 on shards)
               and tokens as stated.  K5a's codes and scales on one real
               wire payload equal the plain version's.  Then the live
               re-layout: 2 steps at world 2, ``apply_world_change(1)``,
               1 step, back to 2, 1 step: never rewound, tokens/step
               unchanged, losses within the fp limit of 4 unresized
               steps (the Adafactor ZeRO-1 run, carried on).  Then a
               sharded save at world 2 and a restore into this one
               process, bit-equal to the state the ranks held.
               Printed: launches, wire bytes and host staging copies per
               step and leg beside the model's count, the overlap plan's
               buckets, step seconds (gloo over loopback: for the record,
               not a speed claim).  ``--dp`` runs the build, ``train``,
               ``train_fit`` and this phase.
9e. ``train_mp2``  two processes on ``cuda:0`` in a gloo group, the fsdp
               and tensor axes (``parallel/sharding.py``; every collective
               through the axes' wires, staged through the host): the
               dense Llama step at Llama-2 7B's width (``MP2_LAYERS`` of
               32 layers, bf16, ``flash_only``), global batch 16 x 1024,
               Adafactor and q8_adam (clip 1.0, lr 1e-4), ``MP2_STEPS``
               steps at ``fsdp=2`` (Adafactor, q8_adam) and ``tensor=2``
               (Adafactor), each held against the world-1 run of the same
               config, init and batch (``MP2_*`` limits: losses, grad
               norms, every leaf by norm-relative error, each limit below
               the smallest update the reference makes), every step's
               launches (K1, K3 on the local heads; K6 on fsdp shards) and
               tokens as stated, the wire bytes by axis and leg equal to
               ``_mp2_predicted_wire``'s count from the shapes, and each
               rank's resident bytes at ``fsdp=2`` at most
               ``MP2_RESIDENT_SHARE`` of the world-1 run's.  Three
               planted faults must fail: one rank's shards left at the
               init (the fsdp run's check with rank 1's boxes unchanged),
               the first block's row-parallel sum skipped and the tensor
               group's whole leaves counted twice in the global norm (one
               step each at ``tensor=2``).  Then a sharded save at
               ``fsdp=2`` through ``ElasticTrainer`` restored into this
               one process, bit-equal.  Printed: step seconds, wire bytes
               and host staging copies, resident and peak bytes a rank,
               losses.  ``--mp`` runs the build and this phase.
9f. ``train_ep2``  two processes on ``cuda:0`` in a gloo group, the
               expert axis (``models/moe.py``'s a2a exchange on the
               expert axis's wire, staged through the host): bench.py's
               MoE entry at full width (8 experts top-2 of d_ff 3200,
               capacity factor 1.25, gelu, bf16, ``flash_only``) at
               ``EP2_LAYERS`` of 48 layers, global batch 16 x 1024,
               Adafactor lr 1e-4, ``EP2_STEPS`` steps at ``expert=2``
               with the a2a and the a2a_int8 dispatch (each rank holding
               4 experts), each against the world-1 einsum run, and at
               ``data=2`` with the grouped dispatch (K8, K9) against the
               world-1 grouped run, both world-1 runs in this process:
               losses, grad norms, aux losses, every leaf and the router
               statistics (``build_moe_stats_fn``) within ``EP2_*`` (the
               int8 run to its derived bound), every step's launches (K1,
               K3; K5a/K5b a leg on the int8 wire; K8/K9) and wire bytes
               by axis and leg equal to ``_ep2_per_step`` and
               ``_ep2_predicted_wire``.  Two planted faults, one step each
               at ``expert=2``, must fail: the dispatch leg sending each
               chunk back to its own rank, and the top-1 density left
               unreduced over the batch group.  ``--ep`` runs the build
               and this phase.
9h. ``train_sp2``  two processes on ``cuda:0`` in a gloo group, the seq
               axis (Ulysses' all-to-alls on its wire, staged through
               the host): Llama-2 7B's width at ``SP2_LAYERS`` of 32
               layers, bf16, ``flash_only``, flash blocks 4096 (the fused
               backward), batch 1 x 4096, Adafactor lr 1e-4,
               ``SP2_STEPS`` steps at ``seq=2`` against the world-1 run
               of the same batch in this process: losses, grad norms and
               every leaf within the larger of ``SP2_NOISE_FACTOR`` x the
               world-1 run's own noise (run twice) and ``train_mp2``'s
               limits; every step's K1/K3 launches (one each a layer and
               rank, 16 heads at S 4096) and wire bytes and calls by axis
               and leg equal to ``_sp2_predicted_wire``.  A planted
               offset (every rank's tokens at positions from 0) must
               fail.  ``--sp`` runs the build and this phase.
9i. ``serve_tp2``  the same world serving Llama-2 7B's width at
               ``SERVE_TP_LAYERS`` of 32 layers (``max_seq_len``
               ``SERVE_TP_MAX_SEQ``), bf16, flash prefill, 8 slots, at
               tp=2 against a tp=1 engine of the same weights in this
               process: every request finishes; greedy streams equal the
               tp=1 ones up to a near-tie judged by the tp=1 logits of a
               teacher-forced replay (within ``SERVE_TP_TIE_TOL``); the
               tp=2 decode of that replay within ``SERVE_TP_REPLAY_ATOL``
               of tp=1's at every position; both ranks emit the same
               streams; K1 ``SERVE_TP_LAYERS`` a prefill and rank; per
               step 2 sums a layer, the lookup's sum and one logits
               gather, bytes and calls as counted from the shapes; a
               rank's KV pool at most ``SERVE_TP_KV_SHARE`` of tp=1's; a
               fold 2 -> 1 -> 2 mid-serve (rank 1 parked at 1) keeps
               every request and stream.  Planted, each must fail: the
               first block's MLP ``wi`` slices swapped between the
               ranks; rank 1's decode attention reading its KV heads
               rolled by one (the prefill untouched: it must fail both
               the replay and the streams, at a decode position).  ``--serve-tp`` runs the build and this phase.
9j. ``train_ring2``  the same world, ``train_sp2``'s model and batch
               under ring attention (``RING_RULES``, ``full`` remat) at
               ``seq=2``, against a world-1 ring of one within
               ``SP2_FLOOR``; the ring of one itself within the same
               floors of ``train_sp2``'s first world-1 run (flash, the
               same function), and its attention at ``[1, 4096, 32,
               128]`` within ``RING_OP_RTOL`` of plain fp32 attention
               (output and q/k/v gradients); every step's seq-wire bytes
               and calls equal to ``_ring2_predicted_wire``, no kernel
               launched (the ring, not flash, computes the attention),
               the backward keeping less than one chunk's scores and a
               call's device peak under n of them.  Planted, each must
               fail: every chunk's key positions from the next rank's
               chunk (a forward at the init); every tile's scores scaled
               1% too much in the ring of one (the plain-attention
               check).
               ``--ring`` runs the build and this phase.
9k. ``train_pp2``  the same world, Llama-2 7B's width at ``PP2_LAYERS``
               of 32 layers, batch ``PP2_BATCH`` x 4096 in
               ``PP2_MICRO`` microbatches, ``flash_only``, at ``pipe=2``:
               GPipe and the circular schedule (``pipeline_interleave``
               2), each against the world-1 run of the same model (run
               twice for its noise): ticks, useful ticks, handoff and
               relayout bytes, the pipe wire's bytes and calls and K1/K3
               a step and rank equal to ``_pp2_predicted``, each stage
               holding its own layers and at most ``PP2_RESIDENT_SHARE``
               of world 1's bytes.  Planted: the first stage's
               microbatches rotated a slot (a forward at the init) must
               fail.  ``--pp`` runs the build and this phase.  In the
               whole script the world-1 runs of ``train_sp2``,
               ``train_ring2`` and ``train_pp2`` run in this process
               while ``train_dp2``'s ranks do
               (``world1_references_start``).
9l. ``elastic_run``  the control plane's main path: a ``JobMaster(port=0,
               num_nodes=1)`` in this process and ``python -m
               dlrover_tpu_torch.run --master localhost:P --nnodes 1
               --max-restarts 1 --monitor-interval 1`` running ``python -m
               dlrover_tpu_torch.examples.train_lm`` with
               ``ELASTIC_TRAINER_ARGV`` (GPT-2 1.5B's width at 2 layers,
               flash attention, Adafactor, 12 steps, saves every 4, a crash
               at step 10, a profiled step every 4, the memory report).
               Nothing here sets the restart count or relaunches: the
               agent does.  Held: the launcher exits 0; the master saw one
               failure of node 0, exit code 17, its log tail holding
               "crashing at step 10"; one restart (2 worker starts) and
               rendezvous round 2; the restarted trainer restored step 8
               from shm; storage's committed step and the speed monitor's
               last step are 12 and ``job_phase()`` is ``succeeded``; the
               shards the crashed trainer held head the queue after the
               recovery; the calibration ledger holds the profiled windows
               (routed through the servicer), the memory ledger the
               ``params`` pool, and the windows count K1 and K3 launches
               (and no K2a).  Printed: the goodput split as the master
               holds it (productive seconds, the restart from the crash's
               ``process_exit`` to the next first step span, the
               rendezvous, restore and checkpoint spans, the compile
               ledger) and the wall times.  Started by
               ``_after_fit_measured`` beside ``train_fit``'s end and
               ``train_dp2``; ``--fit``, ``--fit-gate``, ``--dp`` and
               ``--measure`` run it too.
9g. ``train_opts``  the training options at GPT-2 1.5B's width
               (``OPTS_LAYERS`` of 48 layers, fp32 parameters, bf16,
               flash, 16 x 1024), one model and one batch: every remat
               policy of the registry, ``OPTS_OFFLOAD`` and its save-only
               twin, one step each against ``none``'s: the loss bit for
               bit, gradients within ``OPTS_GRAD_RTOL``, K1/K3 launches,
               the bytes kept on the device by site name and the bytes
               moved through pinned host memory, all equal to
               ``_opts_predicted``, the offload run's device peak below
               the twin's by ``OPTS_OFFLOAD_PEAK_SHARE`` of what it
               moves; Lion, AGD and AdamW from ``make_optimizer`` (AdamW
               then µP) stepped by ``build_train``'s step, and WSAM over
               AdamW, 3 steps each, every update and the state after it
               against a float64 shadow that starts from the same init
               and advances by the float64 formula on the step's own
               gradients; ``wo_transposed`` on the same weights against
               the untransposed model.  Planted: a replay handing back
               the other site's tensor, a Lion step with the sign taken
               before the interpolation, a Lion moment decayed by b1 in
               place of b2.  The local-SGD job runs at the end of
               ``train_dp2``'s ranks (``LSGD_*``).  ``--opts`` runs the
               build and this phase.
10. ``train_split``  full width, 4 layers, ``flash_block_kv=512``, 1
               warm-up then 3 measured steps: every step launches
               ``flash_bwd_dq`` and ``flash_bwd_dkv`` 4 times each and the
               fused kernel never.  Step time (median).
11. ``train_parity``  full width, 4 layers, bf16, batch 4: one step's loss
               and gradients through the kernels against the same model
               with the plain forward and backward swapped in: loss gap,
               global grad-norm gap, and every parameter's gradient cosine
               and norm-relative error, within the ``PARITY_*`` limits;
               the same check must fail on the planted backward faults of
               ``PARITY_FAULTS``.

12. ``train_moe``  ``build_train`` on ``bench.py``'s MoE entry with the
               dropless grouped dispatch (``moe_config``: 8 experts,
               top-2, expert d_ff 3200) at 24 of its 48 layers (cut for
               the script's time; about 2.3B parameters), batch 16 x 1024,
               Adafactor, 1 warm-up then 3 measured steps: finite, falling
               loss, finite aux loss > 0, and per step and layer 1 flash
               forward, 1 fused backward, 6 K8 and 2 K9 launches and no
               split kernel.  Step time, tokens/s,
               MFU/HFU by ``bench.py``'s activated-FLOP rule, peak memory
               (also split before and inside the optimizer update), and
               one profiled step.
    (``--gmm`` runs the build, ``gmm_kernel_checks``, ``train_moe``,
    ``train_moe_parity`` and then ``train_moe_48``: the same at all 48
    layers, 1 warm-up then 2 measured steps and one profiled.)
13. ``train_moe_parity``  4 layers, batch 4: one step through K8/K9
               against the plain grouped matmuls swapped in, within the
               ``MOE_PARITY_*`` limits, with the kernel leg's own rerun
               as the noise floor; two planted faults (one expert's dw
               dropped, one expert's dx halved) must fail the same check.
               Every leg replays the kernel leg's top-k choices, so a
               rounding difference cannot reroute a token between legs.

14. ``train_lowbit``  ``build_train`` on ``lowbit_config()``: the train
               phase's model with ``fused_ln=True`` and
               ``pin_attn_layouts=True``, at full width and depth, with
               ``make_optimizer("q8_adam", learning_rate=1e-4,
               grad_clip=1.0)``, 1 warm-up then 3 measured steps, then
               again from seed 0 with ``"q4_adam"`` (1 + 2 steps):
               finite, falling loss; per step the launches derived in
               ``_lowbit_per_step`` (48 + 48 flash, 96 K4, 288 K11, one K6
               or K7 per quantized leaf); step time, tokens/s, MFU/HFU,
               peak memory, optimizer-state bytes beside Adafactor's, one
               profiled step each (with K6's or K7's device time summed
               over the step's launches); then a q8 first moment is read
               back through K5b (finite, non-zero) and requantized
               through K5a.
15. ``train_lowbit_parity``  4 layers, batch 4: one step's loss and
               gradients through K4 and K11 against their plain versions
               swapped in (``LOWBIT_PARITY_*``), and the same step's
               update through K6, and through K7 from a one-step-old q4
               state, against the plain updates from the same gradients
               and state (codes, scales, updates); one planted fault per
               kernel must fail.
16. ``train_rec``  ``dlrover_tpu_torch.examples.train_rec.run`` at MLPerf
               DLRM width (``REC_ARGV``: batch 8,192, 26 fields, dim 128,
               40M ids, hidden 1024, world 4 folding to 3 after step 16,
               4,194,304 cached rows), 1 + 30 steps: after every step the
               cache's rows of the batch's keys, gathered through K10a,
               equal the plane's bit for bit; finite loss, lower at the end;
               per step one K10a and 1 + (fetches) K10b launches, equal to
               the cache's own counts; hit rate above 0; the reshard moved
               rows and lost none.  Step time, examples/s, rows/s, one
               profiled step's device-busy share, one step's host profile
               (cProfile).  Then 3 steps with a K10b that drops the last
               real row must fail the invariant.

``--ab DIR [DIR ...]`` times K2a, K4, K6, K7, K8 and K9 (``time_kernels``;
``--only NAME,...`` keeps the readings whose names start with one of the
NAMEs, e.g. ``q4_adam,q8_adam`` or ``gmm``) of each tree at DIR (a ``git archive`` of a
parent commit under ``build/``, or a copy of this tree with one constant
changed; named by its directory) and of this one, each reading in a
process of its own, in turns: DIR, change, change, DIR for each DIR,
twice.

17. ``measure``  the measurement planes' checks, each made in the phase
               named: (a) ``train``'s profiled step through
               ``utils.profiler.capture``: the parsed device total within
               ``MEASURE_TOTAL_RTOL`` of ``key_averages()``' device self
               time, exactly 48 launches each of K1 and K3 in the trace,
               all of them given ``blocks/attn`` (K3 by the backward rule),
               4 GEMM launches a layer under each of ``qkv``, ``out``
               and ``wi`` (forward, recompute, dgrad, wgrad) and 3 under
               ``wo`` (the recompute stops before it), the
               modules summing to the device total (the top modules
               and the unattributed share printed); (b) ``train_fit``'s
               resumed fit (steps 7-8) with ``profile_every=2`` and
               ``memory_report=True``: one window, at step 8, its measured
               rows, calibration event and ``profile-sync`` block, a
               ``memory`` event whose ``params`` and ``opt_state`` pools
               are the state's tensor bytes and whose allocator bytes are
               at least their sum, the agent's metrics file; (c) a tensor
               larger than the card: the allocator's
               ``torch.OutOfMemoryError`` and its postmortem's pools equal
               to (b)'s; (d) ``serve``'s ``kv_pool`` and ``params`` pools
               against the pool's shapes and the weights; (e)
               ``train_dp2``'s ``MEASURE_DP2`` run, its last step captured
               on rank 0: the window's collective legs are the legs the
               wire booked for the step, with collective time above 0
               (gloo through the host; the overlap fraction printed).

Then the ``{"kernels": [...]}`` line (launches summed over the counted
runs of the serve, serve_faults, serve_spec, serve_fleet, serve_moe,
train, flash_ckpt, train_fit, train_dp2, elastic_run (the launches its
profiled windows saw), train_mp2, train_ep2,
train_split, train_moe, train_lowbit and train_rec paths,
each driven with the counts set to 0 just before it and read just after),
the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Any failed check
raises: the script exits non-zero and prints no result.  Without a GPU,
or without the package beside it, it exits non-zero before any phase.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
PEAK_FP32_FLOPS = 67e12        # H100 SXM fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
O_ATOL = O_RTOL = 1e-2
LSE_ATOL = 1e-3
LOGIT_ATOL = 0.1
# Backward kernels, for each of dq, dk and dv (see ``bwd_errors``): the
# worst row's error over that row's scale, and the tensor's norm-relative
# error.  One scale per tensor would not do: a causal dk/dv is about 100x
# larger in its first kv rows, which every q row attends, than in its
# last.  Sound kernels read at most 0.0077 (row) and 0.0024 (norm) at
# every shape here on an H100, from the bf16 rounding of p, ds and the
# outputs (the fused dq's atomic order moves it by fp32 rounding only);
# the limits are about 2.5x that.  Planted faults (``planted_faults``)
# read 0.49 and more by row.
BWD_ROW_TOL, BWD_NORM_TOL, BWD_ROW_FLOOR = 0.02, 0.006, 1e-3
# Two runs of the fused backward: dq's fp32 reductions land in another
# order, so its bf16 values may differ by one rounding, at most one bf16
# ulp (2^-7) of a row's largest value; dk and dv must be bit-equal.
REPRO_DQ_ROW_TOL = 2.0 ** -7
# Grouped-matmul kernels (K8, K9; see ``gmm_errors``): the worst row's
# error over that row's scale and the tensor's norm-relative error.
# Sound kernels read at most 0.0039 (row) and 0.0017 (norm) over every
# product of the three cases on an H100: the bf16 rounding of the output
# (half an ulp, 2^-9 of the row's largest value); the limits are about 3x
# that.  The planted faults (``_gmm_planted_faults``) read 0.27 and more
# by row, 0.088 and more by norm.
GMM_ROW_TOL, GMM_NORM_TOL, GMM_ROW_FLOOR = 0.012, 0.005, 1e-3
SLOTS = 8
TRAIN_BATCH, TRAIN_SEQ = 16, 1024     # bench.py:35-36
# bench.py's MoE entry (MOE_* constants, bench.py:367-376): 8 experts,
# top-2, capacity 1.25, expert d_ff = the dense 6400 // top_k.
MOE_EXPERTS, MOE_TOP_K, MOE_CAPACITY, MOE_D_FF = 8, 2, 1.25, 3200
GMM_BLOCK = 128                       # MoEMlp.gmm_block_rows
TRAIN_WARMUP, TRAIN_STEPS = 1, 3
TRAIN_LR = 1e-4                       # bench.py:383
SPLIT_LAYERS, SPLIT_BLOCK_KV = 4, 512
PARITY_LAYERS, PARITY_BATCH = 4, 4
# Kernels against plain versions over one 4-layer step.  Sound kernels
# read (H100): loss gap 5.6e-5, grad-norm gap 1.5e-4, lowest cosine
# 0.999945 and worst per-parameter error 0.0105 (``pos_embedding``); the
# limits are about 3x that.  The planted faults read grad-norm gaps of
# 0.011 and 0.076, cosines of 0.993 and 0.952 and errors of 0.12 and 0.32.
PARITY_LOSS_ATOL, PARITY_NORM_RTOL = 2e-4, 5e-4
PARITY_MIN_COSINE, PARITY_PARAM_RTOL = 0.99985, 0.03
# Planted backward faults the parity must catch: (name, first row of the
# diagonal tiles hit (``diagonal_tiles``), share of their contribution lost).
PARITY_FAULTS = [("late_diagonal_dropped", TRAIN_SEQ // 2, 1.0),
                 ("every_diagonal_halved", 0, 0.5)]
# An eighth of the 48 layers, cut for the script's time (24 until PR 16,
# 12 until PR 17); the widths are whole.
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 6, 3
# K8/K9 against their plain versions over one 4-layer MoE step (the flash
# kernels in both legs, every leg routed as the kernel leg was).  Sound
# kernels read (H100): loss gap 4.3e-5, grad-norm gap 7.7e-5, lowest
# cosine 0.999979 and worst per-parameter error 0.0065, both in the last
# layer's ``moe.wi``; the kernel leg's rerun reads 0.9999968 and 0.0026.
# The limits are about 3x the readings.  The planted faults read cosines
# of 0.437 and 0.949 and errors of 0.90 and 0.45.
MOE_PARITY_LOSS_ATOL, MOE_PARITY_NORM_RTOL = 1.5e-4, 2.5e-4
MOE_PARITY_MIN_COSINE, MOE_PARITY_PARAM_RTOL = 0.99993, 0.02
MOE_PARITY_FAULTS = ("expert_dw_dropped", "expert_dx_halved")
MOE_PARITY_FAULT_EXPERT = 0
# Fused norm backward (K4; see ``check_norm_case``): dx by row and by norm
# as the grouped products are held, dscale and dbias by norm-relative
# error against the fp32 plain version from the same inputs and saved
# statistics.  Sound kernels read at most 0.0039 (row) and 0.00166 (norm)
# in bf16 on an H100, the rounding of dx to bf16, and 2.3e-7 on dscale and
# dbias (fp32 sums in another order); the limits are about 3x that.  The
# planted faults read 0.098 by row and 0.24 by norm (mean(g) dropped) and
# 0.045 on dscale (a partial row lost).
NORM_ROW_TOL, NORM_NORM_TOL, NORM_ROW_FLOOR = 0.012, 0.005, 1e-3
NORM_PARAM_TOL = 1e-6
# Low-bit Adam (K6, K7; see ``_adam_errors``) and block quantization (K5a,
# K5b).  The kernels do the plain versions' fp32 operations one IEEE
# rounding at a time and in their order, so codes, scales and updates are
# expected equal, and read equal at every shape on an H100 (no code, scale
# or update off); the limits leave room for a value an ulp from a .5
# boundary.  K5a's codes and K5b's values must be equal.  The planted
# faults read 0.56 and 0.71 on the update's norm.
QUANT_CODE_SHARE, QUANT_SCALE_RTOL, QUANT_UPD_NORM_TOL = 1e-4, 1e-6, 1e-3
# Seeded scales in [1e-30, 1e3], beside the powers of two, at which
# ``quant_code_check`` holds K7's codes to the IEEE chain.
QUANT_CHECK_RANDOM_SCALES = 16
LOWBIT_STEPS, LOWBIT_Q4_STEPS = 3, 2
PIN_PAIRS = 10  # K11 against clone(), alternating (``pin_kernel_check``)
# K4 and K11 against their plain versions over one 4-layer step (the flash
# kernels in both legs).  Sound kernels read (H100): loss gap 0 (neither
# kernel changes a forward value), lowest cosine 0.9999877 and worst
# per-parameter error 0.0049 (``pos_embedding``); the kernel leg's rerun
# reads 0.9999937 and 0.0036 (the fused flash dq's atomic order).  The
# grad-norm gap varies more from run to run: 5.9e-6, 4.0e-6, 1.49e-5,
# 1.72e-5 and 2.60e-5 over five runs.  The limits are about 3x the largest
# readings.  The planted faults read cosines of 0.9934 and 0.8555, errors
# of 0.18 and 0.53 and grad-norm gaps of 0.063 and 0.034.
LOWBIT_PARITY_LOSS_ATOL, LOWBIT_PARITY_NORM_RTOL = 1e-5, 8e-5
LOWBIT_PARITY_MIN_COSINE, LOWBIT_PARITY_PARAM_RTOL = 0.99996, 0.015
#: ``serve_faults``: the admission attempts (``serve.admit`` hits) that
#: fail, among the 8 greedy requests' (the engine's policy retries each).
SERVE_FAULT_HITS = (1, 3, 4, 9)
# (prompt length, max_new_tokens): every bucket 16..512, one prompt > 256.
SERVE_REQUESTS = [
    (5, 16), (16, 24), (12, 64), (20, 32), (32, 40), (40, 16), (64, 48),
    (70, 20), (100, 64), (128, 16), (200, 32), (256, 24), (300, 40),
    (400, 16), (480, 56), (500, 64),
]


_T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        # Seconds since the script started: where its time goes.
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _event_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of ``iters`` back-to-back eager calls (CUDA
    events): device time plus any gap the host leaves between launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _event_ms(lambda: [fn() for _ in range(iters)]) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph and replayed, so no host launch gap is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _event_ms(lambda: [graph.replay() for _ in range(replays)])
    del graph
    return ms / (iters * replays)


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# -- kernel checks -------------------------------------------------------------

KERNEL_CASES = [
    dict(case="serve_s16", b=1, s=16, hq=25, hkv=25, d=64, causal=True,
         fused=True),
    dict(case="serve_s128", b=1, s=128, hq=25, hkv=25, d=64, causal=True,
         fused=True),
    dict(case="serve_s512", b=1, s=512, hq=25, hkv=25, d=64, causal=True,
         fused=True),
    dict(case="serve_s1000", b=1, s=1000, hq=25, hkv=25, d=64, causal=True,
         fused=True),
    dict(case="train_b16_s1024", b=16, s=1024, hq=25, hkv=25, d=64,
         causal=True, fused=True),
    dict(case="gqa_32_8_d128", b=1, s=512, hq=32, hkv=8, d=128,
         causal=True),
    dict(case="segments", b=2, s=512, hq=25, hkv=25, d=64, causal=True,
         seg="packed"),
    dict(case="noncausal", b=1, s=512, hq=25, hkv=25, d=64, causal=False,
         fused=True),
    dict(case="masked_rows", b=1, s=256, hq=8, hkv=8, d=64, causal=True,
         seg="masked"),
    # Ulysses' attention in ``train_sp2``: Llama-2 7B's 32 heads split
    # over seq=2, the whole 4096-token sequence.
    dict(case="ulysses_s4096", b=1, s=4096, hq=16, hkv=16, d=128,
         causal=True),
]
SERVE_CASE = "serve_s512"  # the largest serving bucket
TRAIN_CASE = "train_b16_s1024"  # the training step's shape


def _case_inputs(c, gen):
    b, s, hq, hkv, d = c["b"], c["s"], c["hq"], c["hkv"], c["d"]
    dev = "cuda"
    if c.get("fused"):
        # The main path's layout: views of one [B, S, H, 3*D] projection.
        qkv = torch.randn((b, s, hq, 3 * d), generator=gen, device=dev)
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q, k, v = (
            torch.randn((b, s, h, d), generator=gen, device=dev).to(
                torch.bfloat16)
            for h in (hq, hkv, hkv)
        )
    seg_q = seg_kv = None
    if c.get("seg") == "packed":
        seg_q = (torch.arange(s, device=dev) // 100).repeat(b, 1).int()
        seg_kv = seg_q
    elif c.get("seg") == "pad":
        # Packed segments of 100 and a pad tail of segment -1.
        seg_q = (torch.arange(s, device=dev) // 100).repeat(b, 1).int()
        seg_q[:, -40:] = -1
        seg_kv = seg_q
    elif c.get("seg") == "masked":
        # q rows of segment 0 find no kv of their segment: o = 0 and
        # lse = -1e30 there.
        seg_q = (torch.arange(s, device=dev) // 40).repeat(b, 1).int()
        seg_kv = seg_q.clone()
        seg_kv[:, :40] = 7
    return q, k, v, seg_q, seg_kv


def check_kernel_case(c, gen):
    from dlrover_tpu_torch.ops import flash_attention as fa

    q, k, v, seg_q, seg_kv = _case_inputs(c, gen)
    b, s, hq, hkv, d, causal = (c[x] for x in
                                ("b", "s", "hq", "hkv", "d", "causal"))
    o, lse = fa.flash_fwd(q, k, v, causal=causal, seg_q=seg_q,
                          seg_kv=seg_kv)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.mha_reference(
        q.float(), k.float(), v.float(), causal=causal, seg_q=seg_q,
        seg_kv=seg_kv,
    )
    o_err = (o.float() - ref_o).abs()
    lse_err = (lse - ref_lse).abs()
    o_ok = bool((o_err <= O_ATOL + O_RTOL * ref_o.abs()).all())
    lse_ok = bool((lse_err <= LSE_ATOL).all())
    masked = ref_lse <= -1e29
    masked_ok = bool(
        (lse[masked] == ref_lse[masked]).all()
        and (o.float().permute(0, 2, 1, 3)[masked] == 0).all()
    )

    # Unmasked (q, k) pairs of this input: the work the function needs.
    allowed = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if causal:
        allowed = torch.tril(allowed)
    allowed = allowed[None]
    if seg_q is not None:
        allowed = allowed & (seg_q[:, :, None] == seg_kv[:, None, :])
    pairs = int(allowed.expand(b, s, s).sum())
    flops = 4.0 * pairs * hq * d
    nbytes = 2.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
    bound_ms, bound_by = bound(nbytes, flops)

    def kernel():
        fa.flash_fwd(q, k, v, causal=causal, seg_q=seg_q, seg_kv=seg_kv,
                     return_lse=False)

    def plain():
        fa.mha_reference(q, k, v, causal=causal, seg_q=seg_q,
                         seg_kv=seg_kv)

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_mask = None if seg_q is None else allowed[:, None]

    def library():
        F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask,
            is_causal=causal and sdpa_mask is None,
            enable_gqa=hq != hkv,
        )

    ms, library_ms = device_ms(kernel), device_ms(library)
    out = dict(
        case=c["case"], b=b, s=s, hq=hq, hkv=hkv, d=d, causal=causal,
        seg=c.get("seg"), strided_views=bool(c.get("fused")),
        max_abs_err=float(o_err.max()), lse_max_abs_err=float(
            lse_err.max()),
        masked_rows=int(masked.sum()),
        ms=ms, plain_ms=device_ms(plain, iters=5), library_ms=library_ms,
        tflops=flops / ms / 1e9, library_ratio=ms / library_ms,
        eager_ms=eager_ms(kernel), eager_library_ms=eager_ms(library),
        bound_ms=bound_ms, bound_by=bound_by,
        bytes=nbytes, flops=flops,
        ok=o_ok and lse_ok and masked_ok,
    )
    return out


# -- backward kernel checks ---------------------------------------------------

BWD_CASES = [
    dict(case="train_fused", b=16, s=1024, hq=25, hkv=25, d=64, causal=True,
         fused=True, kernel="fused", plant=True),
    dict(case="train_split", b=16, s=1024, hq=25, hkv=25, d=64, causal=True,
         fused=True, kernel="split", plant=True),
    dict(case="gqa_32_8_d128_s2048", b=1, s=2048, hq=32, hkv=8, d=128,
         causal=True, kernel="split"),
    dict(case="segments_pad", b=2, s=512, hq=25, hkv=25, d=64, causal=True,
         seg="pad", kernel="fused"),
    dict(case="noncausal_s512", b=1, s=512, hq=25, hkv=25, d=64,
         causal=False, fused=True, kernel="fused"),
    dict(case="masked_rows", b=1, s=256, hq=8, hkv=8, d=64, causal=True,
         seg="masked", kernel="fused"),
    # Ragged sequences, the last q and kv tiles running past S, on each of
    # K2a's builds that the main-path cases leave out: its 64-row blocks at
    # D 64 (causal) and D 128 (non-causal), and its 128-row blocks at D
    # 128, the last one's second warpgroup wholly past S.
    dict(case="ragged_gqa_s900", b=8, s=900, hq=8, hkv=2, d=64,
         causal=True, kernel="split"),
    dict(case="ragged_small_s1000_d128", b=1, s=1000, hq=4, hkv=2, d=128,
         causal=False, kernel="split"),
    dict(case="ragged_gqa_s900_d128", b=2, s=900, hq=8, hkv=2, d=128,
         causal=True, kernel="split"),
    dict(case="ulysses_s4096", b=1, s=4096, hq=16, hkv=16, d=128,
         causal=True, kernel="fused", library=True),
]
BWD_FUSED_CASE, BWD_SPLIT_CASE = "train_fused", "train_split"


def _live_pairs(c, seg_q, seg_kv):
    """``[B, Sq, Skv]`` bool: the (q, kv) pairs the mask leaves live."""
    b, s = c["b"], c["s"]
    allowed = torch.ones((s, s), dtype=torch.bool, device="cuda")
    if c["causal"]:
        allowed = torch.tril(allowed)
    allowed = allowed[None].expand(b, s, s)
    if seg_q is not None:
        allowed = allowed & (seg_q[:, :, None] == seg_kv[:, None, :])
    return allowed


def _bwd_bound(c, pairs, products, outputs):
    """Least time for a backward function that does ``products`` S x S x D
    products over the live pairs and writes ``outputs`` (of dq, dk, dv):
    q, k, v, o, do and lse read once, the outputs written once."""
    b, s, hq, hkv, d = (c[x] for x in ("b", "s", "hq", "hkv", "d"))
    q_bytes, kv_bytes = 2.0 * b * s * hq * d, 2.0 * b * s * hkv * d
    nbytes = 3 * q_bytes + 2 * kv_bytes + 4.0 * b * hq * s
    nbytes += sum(q_bytes if o == "dq" else kv_bytes for o in outputs)
    flops = 2.0 * products * pairs * hq * d
    return bound(nbytes, flops) + (nbytes, flops)


def bwd_errors(g, r, dead):
    """Errors of one gradient ``g`` ``[B, S, H, D]`` against its fp32
    reference ``r``, a row being one (b, s, h) vector of D values:
    ``row`` the worst row's largest error over that row's scale,
    ``norm`` ``||g - r|| / ||r||`` over the tensor, ``max_abs`` the
    largest error, and ``dead_rows_exact``: the rows ``dead`` ``[B, S]``
    marks (no live (q, kv) pair) are exactly 0.  A row's scale is its
    largest |ref| plus ``BWD_ROW_FLOOR`` of the tensor's: a row whose exact
    value cancels to 0 (the first q row of a causal dq, whose one key has
    p = 1 and dp - delta = 0) holds only rounding noise, which a scale of
    its own would turn into an error of order 1."""
    diff = g.float() - r
    err = diff.abs().amax(-1)
    row_max = r.abs().amax(-1)
    scale = row_max + BWD_ROW_FLOOR * row_max.max()
    return dict(
        row=float((err / scale.clamp_min(1e-30)).max()),
        norm=float(torch.linalg.vector_norm(diff)
                   / torch.linalg.vector_norm(r).clamp_min(1e-30)),
        max_abs=float(err.max()),
        dead_rows_exact=bool((g[dead] == 0).all()),
        finite=bool(torch.isfinite(g).all()),
    )


def bwd_ok(e) -> bool:
    return (e["row"] <= BWD_ROW_TOL and e["norm"] <= BWD_NORM_TOL
            and e["dead_rows_exact"] and e["finite"])


def diagonal_tiles(q, k, v, o, lse, do, *, causal, first_tile):
    """``(dq, dk, dv)`` over the (q, kv) pairs of the diagonal ``MASK_TILE``
    square blocks (a warpgroup's tile in the kernels, inside which they
    mask) from tile ``first_tile`` on, in fp32: what a backward kernel that
    skipped those blocks would lose.  The plain backward with segment ids
    that keep exactly those pairs (p from the full lse, delta from the full
    o)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    b, s = q.shape[:2]
    idx = torch.arange(s, device=q.device) // fa.MASK_TILE
    late = idx >= first_tile
    seg_q = torch.where(late, idx, -1).int().expand(b, s)
    seg_kv = torch.where(late, idx, -2).int().expand(b, s)
    return fa.mha_backward_reference(
        q.float(), k.float(), v.float(), o.float(), lse, do.float(),
        causal=causal, seg_q=seg_q, seg_kv=seg_kv)


def planted_faults(grads, ref, dead, lost):
    """The check applied to ``grads`` with planted faults: each region's
    ``lost`` contribution (``diagonal_tiles``) dropped, as a kernel that
    skipped those tiles would give, or halved, in one of dq, dk, dv at a
    time.  Each must fail.  ``old_check_passes``: whether the earlier
    tolerance of one scale per tensor (|err| <= 1e-2 max|ref| + 1e-2 |ref|)
    lets it through."""
    out = {}
    for region, region_lost in lost.items():
        for frac_name, frac in (("drop", 1.0), ("halve", 0.5)):
            for i, name in enumerate(("dq", "dk", "dv")):
                g = (grads[i].float() - frac * region_lost[i]).to(
                    grads[i].dtype)
                e = bwd_errors(g, ref[i], dead[i])
                old = bool(((g.float() - ref[i]).abs() <= 1e-2 * float(
                    ref[i].abs().max()) + 1e-2 * ref[i].abs()).all())
                out[f"{region}_{frac_name}_{name}"] = dict(
                    row=e["row"], norm=e["norm"], caught=not bwd_ok(e),
                    old_check_passes=old)
    return out


def check_bwd_case(c, gen):
    from dlrover_tpu_torch.ops import flash_attention as fa

    q, k, v, seg_q, seg_kv = _case_inputs(c, gen)
    causal = c["causal"]
    do = torch.randn(q.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    kw = dict(causal=causal, seg_q=seg_q, seg_kv=seg_kv)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    ref = fa.mha_backward_reference(q.float(), k.float(), v.float(),
                                    o.float(), lse, do.float(), **kw)
    live = _live_pairs(c, seg_q, seg_kv)
    dead_q, dead_kv = ~live.any(2), ~live.any(1)    # [B, S]: no live pair
    dead = (dead_q, dead_kv, dead_kv)
    out = dict(case=c["case"], b=c["b"], s=c["s"], hq=c["hq"],
               hkv=c["hkv"], d=c["d"], causal=causal, seg=c.get("seg"),
               strided_views=bool(c.get("fused")), timed=c["kernel"],
               dead_q_rows=int(dead_q.sum()), dead_kv_rows=int(dead_kv.sum()))
    ok = True
    fused_dkv = None
    for path in ("fused", "split"):
        grads = fa.flash_bwd(q, k, v, o, lse, do, fused=path == "fused",
                             **kw)
        torch.cuda.synchronize()
        for name, g, r, dd in zip(("dq", "dk", "dv"), grads, ref, dead):
            e = bwd_errors(g, r, dd)
            out[f"{path}_{name}"] = e
            ok = ok and bwd_ok(e)
        if path == "fused":
            # Two runs: dk and dv bit for bit, dq within the rounding of
            # its reductions' order.
            again = fa.flash_bwd(q, k, v, o, lse, do, fused=True, **kw)
            torch.cuda.synchronize()
            repro = dict(
                dk_dv_bit_equal=bool(torch.equal(grads[1], again[1])
                                     and torch.equal(grads[2], again[2])),
                dq_row=bwd_errors(again[0], grads[0].float(), dead_q)["row"])
            out["fused_repro"] = repro
            ok = ok and repro["dk_dv_bit_equal"] and (
                repro["dq_row"] <= REPRO_DQ_ROW_TOL)
            fused_dkv = grads[1:]
            del again
        else:
            # Two runs of K2b bit for bit; and K2b is K3 without dq: each
            # kv row's dk and dv are summed over the same q tiles, in the
            # same order and with the same instructions, whichever block
            # holds the row, so they equal K3's bit for bit.
            again = fa.flash_bwd_dkv(q, k, v, o, lse, do, **kw)
            dq_again = fa.flash_bwd_dq(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            # K2a's dq accumulates in registers and is written once: two
            # runs (the split path's, on its shared pre-pass, and one with
            # its own) are bit-equal.
            repro = dict(
                dq_bit_equal=bool(torch.equal(grads[0], dq_again)),
                dk_dv_bit_equal=bool(torch.equal(grads[1], again[0])
                                     and torch.equal(grads[2], again[1])),
                dk_dv_equal_fused=bool(torch.equal(grads[1], fused_dkv[0])
                                       and torch.equal(grads[2],
                                                       fused_dkv[1])))
            out["split_repro"] = repro
            ok = ok and all(repro.values())
            del again, dq_again, fused_dkv
        if c.get("plant") and path == ("fused" if c["kernel"] == "fused"
                                       else "split"):
            tiles = c["s"] // fa.MASK_TILE
            lost = {region: diagonal_tiles(q, k, v, o, lse, do,
                                           causal=causal, first_tile=first)
                    for region, first in (("late_half", tiles // 2),
                                          ("last_tile", tiles - 1))}
            faults = planted_faults(grads, ref, dead, lost)
            del lost
            out["planted_faults"] = faults
            ok = ok and all(f["caught"] for f in faults.values())
        del grads
    out["ok"] = ok
    out["max_abs_err"] = max(out[f"{p}_{n}"]["max_abs"]
                             for p in ("fused", "split")
                             for n in ("dq", "dk", "dv"))

    pairs = int(live.sum())

    def run(fn):
        return lambda: fn(q, k, v, o, lse, do, **kw)

    if c["kernel"] == "fused":
        timed = {"fused": (fa.flash_bwd_fused, fa.mha_backward_reference, 5,
                           ("dq", "dk", "dv"))}
    else:
        timed = {"dq": (fa.flash_bwd_dq, fa.mha_backward_dq_reference, 3,
                        ("dq",)),
                 "dkv": (fa.flash_bwd_dkv, fa.mha_backward_dkv_reference, 4,
                         ("dk", "dv"))}
    for name, (kernel, plain, products, outputs) in timed.items():
        b_ms, b_by, nbytes, flops = _bwd_bound(c, pairs, products, outputs)
        ms = device_ms(run(kernel))
        out[name] = dict(ms=ms, tflops=flops / ms / 1e9,
                         eager_ms=eager_ms(run(kernel)),
                         plain_ms=device_ms(run(plain), iters=2, replays=2),
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         flops=flops)
    if "dq" in out:
        # The pre-pass's share of K2a's launch: K2a on rows filled once.
        rows, scale = fa._rows(q), c["d"] ** -0.5
        fa._dq_launch(q, k, v, o, lse, do, rows, prep=True, scale=scale,
                      **kw)
        main_ms = device_ms(lambda: fa._dq_launch(
            q, k, v, o, lse, do, rows, prep=False, scale=scale, **kw))
        plan = fa.dq_launch_plan(c["b"], c["s"], c["s"], c["hq"], c["hkv"],
                                 c["d"], torch.cuda.get_device_properties(
                                     0).multi_processor_count)
        out["dq"].update(
            without_prep_ms=main_ms, prep_share=1.0 - main_ms / out["dq"]["ms"],
            plan={key: plan[key] for key in ("block_m", "stages",
                                             "blocks_per_sm", "smem_bytes",
                                             "grid")})

    # Yardstick: SDPA's backward (dq, dk and dv together), at the training
    # shape only (its first call at a new shape takes 1 to 7 s of set-up).
    # Device time: forward and backward captured in one CUDA graph, less
    # the forward alone on the same inputs (a backward alone does not
    # capture: its kernels follow the stream of a forward run outside the
    # graph).  Its eager time, host gaps included, read 0.69 to 5.1 ms over
    # the runs of one day at this shape; it is kept beside.
    out["library_ms"] = None
    if c.get("plant") or c.get("library"):
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdpa_mask = None if seg_q is None else live[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=sdpa_mask,
                is_causal=causal and sdpa_mask is None,
                enable_gqa=c["hq"] != c["hkv"],
            )

        dot = do.transpose(1, 2)
        fwd_bwd_ms = device_ms(
            lambda: torch.autograd.grad(sdpa(), (qt, kt, vt), dot), iters=5)
        out["library_ms"] = fwd_bwd_ms - device_ms(sdpa, iters=5)
        out["library_fwd_bwd_ms"] = fwd_bwd_ms
        sdpa_out = sdpa()
        out["library_eager_ms"] = eager_ms(lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), dot, retain_graph=True), warmup=10)
        if "fused" in out:
            out["fused"]["library_ratio"] = (out["fused"]["ms"]
                                             / out["library_ms"])
    return out


# -- head dims padded to a kernel's (ROADMAP Queue 3 item 7) ------------------

PAD_CASES = [
    # One kv block: the fused backward (K3).
    dict(case="pad_d80", b=2, s=512, hq=8, hkv=8, d=80, causal=True,
         block_kv=512),
    # GQA, two kv blocks: the split backward (K2a and K2b).
    dict(case="pad_d96_gqa", b=2, s=1024, hq=8, hkv=2, d=96, causal=True,
         block_kv=512),
]


def check_pad_case(c, gen):
    """``mha`` at a head dim the kernels have no build for, forward and
    backward through autograd: q, k and v zero-padded to 128, the kernels
    at D 128, the output and the gradients sliced back.  Held against the
    plain versions at the true head dim in fp32 from the same bf16 inputs
    (the forward as ``check_kernel_case`` holds K1, the gradients as
    ``check_bwd_case`` holds K3, K2a and K2b, from the kernel's own o and
    lse).  Records the padding copies and the launches a call makes
    (``time_pad_case`` times the padded path at full width)."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = (c[x] for x in ("b", "s", "hq", "hkv", "d"))
    causal, block_kv = c["causal"], c["block_kv"]
    width = fa.padded_head_dim(d)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_() for h in (hq, hkv, hkv))
    do = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    fused = fa.uses_fused_backward(s, block_kv)
    before, pads_before = _counts(), fa.PAD_COPIES["flash_pad"]
    o = fa.mha(q, k, v, causal=causal, block_kv=block_kv)
    grads = torch.autograd.grad(o, (q, k, v), do)
    o = o.detach()
    torch.cuda.synchronize()
    after = _counts()
    launched = {key: after[key] - before[key] for key in after
                if after[key] != before[key]}
    pads = fa.PAD_COPIES["flash_pad"] - pads_before
    want = ({"flash_fwd": 1, "flash_bwd_fused": 1} if fused else
            {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1})

    q32, k32, v32 = (x.detach().float() for x in (q, k, v))
    ref_o, _ = fa.mha_reference(q32, k32, v32, causal=causal)
    o_err = (o.float() - ref_o).abs()
    fwd_ok = bool((o_err <= O_ATOL + O_RTOL * ref_o.abs()).all())
    padded = [torch.nn.functional.pad(x.detach(), (0, width - d))
              for x in (q, k, v)]
    scale = d ** -0.5  # the true head dim's, as mha passes it
    o_p, lse_p = fa.flash_fwd(*padded, causal=causal, scale=scale)
    ref = fa.mha_backward_reference(q32, k32, v32, o_p[..., :d].float(),
                                    lse_p, do.float(), causal=causal)
    dead = torch.zeros((b, s), dtype=torch.bool, device="cuda")
    out = dict(case=c["case"], b=b, s=s, hq=hq, hkv=hkv, d=d,
               padded_to=width, causal=causal,
               backward="fused" if fused else "split",
               launches=launched, launches_wanted=want,
               pad_copies_counted=pads, fwd_ok=fwd_ok,
               max_abs_err=float(o_err.max()))
    ok = fwd_ok and launched == want and pads == 7
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        e = bwd_errors(g, r, dead)
        e["shape_ok"] = tuple(g.shape) == tuple(r.shape)
        out[name] = e
        ok = ok and bwd_ok(e) and e["shape_ok"]
        out["max_abs_err"] = max(out["max_abs_err"], e["max_abs"])
    del o, grads, o_p, lse_p, ref
    out["ok"] = ok
    return out


#: The padded path timed at the full width of public configs with those
#: head dims, at the ``train`` phase's batch (B16 S1024) and the model's
#: default kv block (one block: the fused backward, as the train step
#: runs it).
PAD_TIMED_CASES = [
    dict(case="phi2_d80", config="microsoft/phi-2: d_model 2560, 32 heads "
         "x D 80", b=16, s=1024, hq=32, hkv=32, d=80, causal=True,
         block_kv=1024),
    dict(case="phi3_mini_d96", config="microsoft/Phi-3-mini-4k-instruct: "
         "hidden 3072, 32 heads x D 96", b=16, s=1024, hq=32, hkv=32, d=96,
         causal=True, block_kv=1024),
]


def time_pad_case(c, gen):
    """Device time of ``mha`` at a padded head dim, forward alone (no
    grad) and forward with backward, beside the kernels alone on inputs
    padded beforehand: what the padding copies cost at that width."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    b, s, hq, hkv, d = (c[x] for x in ("b", "s", "hq", "hkv", "d"))
    causal, block_kv = c["causal"], c["block_kv"]
    width = fa.padded_head_dim(d)
    scale = d ** -0.5  # the true head dim's, as mha passes it
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(
        torch.bfloat16) for h in (hq, hkv, hkv))
    do = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    padded = [torch.nn.functional.pad(x, (0, width - d)).requires_grad_()
              for x in (q, k, v)]
    dop = torch.nn.functional.pad(do, (0, width - d))
    for x in (q, k, v):
        x.requires_grad_()

    def fwd_padded():
        with torch.no_grad():
            fa.mha(q, k, v, causal=causal, block_kv=block_kv)

    def fwd_kernel():
        with torch.no_grad():
            fa.flash_fwd(*padded, causal=causal, scale=scale,
                         return_lse=False)

    def fwd_bwd_padded():
        torch.autograd.grad(fa.mha(q, k, v, causal=causal,
                                   block_kv=block_kv), (q, k, v), do)

    def fwd_bwd_kernel():
        torch.autograd.grad(fa.mha(*padded, causal=causal, scale=scale,
                                   block_kv=block_kv), padded, dop)

    timed = dict(fwd_ms=device_ms(fwd_padded),
                 fwd_kernel_only_ms=device_ms(fwd_kernel),
                 fwd_bwd_ms=device_ms(fwd_bwd_padded, iters=5),
                 fwd_bwd_kernel_only_ms=device_ms(fwd_bwd_kernel, iters=5))
    timed["fwd_padding_share"] = 1.0 - (timed["fwd_kernel_only_ms"]
                                        / timed["fwd_ms"])
    timed["fwd_bwd_padding_share"] = 1.0 - (
        timed["fwd_bwd_kernel_only_ms"] / timed["fwd_bwd_ms"])
    out = {key: c[key] for key in ("case", "config", "b", "s", "hq", "hkv",
                                   "d")}
    out.update(padded_to=width,
               backward="fused" if fa.uses_fused_backward(s, block_kv)
               else "split", **timed)
    del q, k, v, do, padded, dop
    torch.cuda.empty_cache()
    return out


def pad_flash_checks(gen):
    cases = [check_pad_case(c, gen) for c in PAD_CASES]
    timed = [time_pad_case(c, gen) for c in PAD_TIMED_CASES]
    emit({"phase": "pad_flash_checks",
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "row": BWD_ROW_TOL, "norm": BWD_NORM_TOL},
          "cases": cases, "timed": timed})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"padded flash path disagrees on {bad}")
    torch.cuda.empty_cache()
    return cases


# -- grouped matmul kernel checks (K8, K9) ------------------------------------

GMM_CASES = [
    # The MoE step's shape: 16 x 1024 tokens, top-2 of 8 experts, d_model
    # 1600, expert d_ff 3200 (33,792 rows); expert 5 gets no token, the
    # last expert owns the padding rows at the tail.
    dict(case="slice", tokens=TRAIN_BATCH * TRAIN_SEQ, d=1600, f=3200,
         activation="gelu", empty=5, timed=True, plant=True),
    # Ragged widths (not multiples of the 32-wide reduction step or the
    # 128-wide tiles) and an empty last expert, whose dw must stay 0 though
    # the padding rows are its.
    dict(case="ragged_small", tokens=200, d=40, f=72, activation="gelu",
         empty=MOE_EXPERTS - 1),
    # swiglu: three grouped products in each direction.
    dict(case="swiglu", tokens=2048, d=1600, f=3200, activation="swiglu",
         empty=2),
    # Past the 64 experts the kernels once refused, at small widths: 65
    # experts with the last one empty, 512 (as many public MoEs route)
    # with many empty, and 1536, which K9's pre-pass ranks four to a
    # thread.
    dict(case="experts_65", tokens=1024, d=64, f=128, activation="gelu",
         empty=64, experts=65),
    dict(case="experts_512", tokens=2048, d=40, f=72, activation="swiglu",
         empty=7, experts=512),
    dict(case="experts_1536", tokens=1024, d=64, f=64, activation="gelu",
         empty=3, experts=1536),
]
GMM_SLICE_CASE = "slice"
GMM_PRODUCTS = tuple(f"{kind}_{w}" for kind in ("fwd", "dx", "dw")
                     for w in ("wi", "wg", "wo"))


def moe_layer(d, f, activation, gen, param_dtype=torch.bfloat16,
              experts=MOE_EXPERTS):
    """A grouped-dispatch ``MoEMlp`` on the card with weights drawn as
    ``init_params`` draws them (router N(0, 1/d), experts N(0, 1/(E in)))."""
    from dlrover_tpu_torch.models import layers
    from dlrover_tpu_torch.models.moe import MoEMlp

    layer = MoEMlp(d, experts, f, top_k=MOE_TOP_K,
                   capacity_factor=MOE_CAPACITY, activation=activation,
                   dtype=torch.bfloat16, param_dtype=param_dtype,
                   dispatch="grouped", device="cuda")
    layers.normal_(layer.router.kernel, d ** -0.5, gen)
    for p in layer.expert_params():
        layers.normal_(p, (p.shape[0] * p.shape[1]) ** -0.5, gen)
    return layer


def row_errors(g, r, row_floor):
    """Errors of ``g`` against its fp32 reference ``r``, a row being one
    vector along the last axis: ``row`` the worst row's largest error over
    that row's scale (its max |ref| plus ``row_floor`` of the tensor's),
    ``norm`` ``||g - r|| / ||r||``."""
    r2 = r.reshape(-1, r.shape[-1])
    diff = g.float().reshape(r2.shape) - r2
    err = diff.abs().amax(-1)
    row_max = r2.abs().amax(-1)
    scale = row_max + row_floor * row_max.max()
    return dict(
        row=float((err / scale.clamp_min(1e-30)).max()),
        norm=float(torch.linalg.vector_norm(diff)
                   / torch.linalg.vector_norm(r2).clamp_min(1e-30)),
        max_abs=float(err.max()), finite=bool(torch.isfinite(g).all()))


def gmm_errors(g, r):
    """``row_errors`` of a grouped-matmul output with ``GMM_ROW_FLOOR``."""
    return row_errors(g, r, GMM_ROW_FLOOR)


def gmm_ok(e) -> bool:
    return (e["row"] <= GMM_ROW_TOL and e["norm"] <= GMM_NORM_TOL
            and e["finite"] and e.get("exact_zeros", True))


def _gmm_products(activation, rows, h, g, dh, dg, dout, layer):
    """The grouped products of one MoE layer's forward and backward, as
    ``name -> (kind, a, b)``: kind ``fwd`` (K8, b = w), ``dx`` (K8 against
    w transposed) or ``dw`` (K9, b = dy)."""
    wi, wo = layer.wi.detach(), layer.wo.detach()
    act = (torch.nn.functional.silu(g) * h if g is not None
           else torch.nn.functional.gelu(h, approximate="tanh"))
    out = {"fwd_wi": ("fwd", rows, wi), "fwd_wo": ("fwd", act, wo),
           "dx_wi": ("dx", dh, wi), "dx_wo": ("dx", dout, wo),
           "dw_wi": ("dw", rows, dh), "dw_wo": ("dw", act, dout)}
    if activation == "swiglu":
        wg = layer.wg.detach()
        out.update({"fwd_wg": ("fwd", rows, wg), "dx_wg": ("dx", dg, wg),
                    "dw_wg": ("dw", rows, dg)})
    return out


def _gmm_runner(kind, a, b, gs):
    """The kernel for one product."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    if kind == "dw":
        return lambda: gm.gmm_dw(a, b, gs)
    return lambda: gm.gmm_fwd(a, b, gs, transpose_w=kind == "dx")


def _gmm_bound(kind, a, b, rows_used):
    """Least time for one product: each operand read once and the output
    written once; FLOPs over every row the function multiplies (K8: all
    N rows, the tail padding rows included, as it defines out for them;
    K9: the rows of the experts that own rows)."""
    n, red = a.shape
    if kind == "dw":
        m = b.shape[1]
        nbytes = 2.0 * (rows_used * (red + m) + MOE_EXPERTS * red * m)
        flops = 2.0 * rows_used * red * m
    else:
        cols = b.shape[1] if kind == "dx" else b.shape[2]
        nbytes = 2.0 * (n * red + b.numel() + n * cols) + 4 * MOE_EXPERTS
        flops = 2.0 * n * red * cols
    return bound(nbytes, flops) + (nbytes, flops)


def _library_gmm(kind, a, b, gs):
    """The yardstick for one product, timed and never called by the port:
    ``torch._grouped_mm`` over the groups' end offsets (it leaves the
    tail padding rows out)."""
    ends = torch.cumsum(gs, 0).to(torch.int32)
    if kind == "dw":
        return lambda: torch._grouped_mm(a.t(), b, offs=ends)
    bb = b.transpose(1, 2) if kind == "dx" else b
    return lambda: torch._grouped_mm(a, bb, offs=ends)


def check_gmm_case(c, gen):
    """K8 and K9 on every grouped product of one MoE layer, routed by a
    real gate, against the plain versions in fp32 from the same bf16
    inputs."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    d, f = c["d"], c["f"]
    experts = c.get("experts", MOE_EXPERTS)
    layer = moe_layer(d, f, c["activation"], gen, experts=experts)
    x = torch.randn((c["tokens"], d), generator=gen, device="cuda").to(
        torch.bfloat16)
    # Uneven loads from a bias on the router logits; one expert shut out.
    bias = torch.linspace(-1.0, 1.0, experts, device="cuda")
    bias[c["empty"]] = -1e4
    with torch.no_grad():
        logits = layer.router(x.float()) + bias
        routing = layer.route(x, logits)
        rows, gs = routing.rows, routing.group_sizes
        h = gm.gmm_fwd(rows, layer.wi.detach(), gs)
        g = (gm.gmm_fwd(rows, layer.wg.detach(), gs)
             if layer.wg is not None else None)
    sizes = [int(v) for v in gs.tolist()]
    n = rows.shape[0]
    ranges = gm._row_ranges(gs, n)
    zero_rows = rows.abs().amax(-1) == 0   # padding: output exactly 0
    rows_used = sum(t - s for (s, t), size in zip(ranges, sizes) if size)

    def rand(cols):
        return torch.randn((n, cols), generator=gen, device="cuda").to(
            torch.bfloat16)

    products = _gmm_products(c["activation"], rows, h, g, rand(f),
                             rand(f) if g is not None else None, rand(d),
                             layer)
    out = dict(case=c["case"], tokens=c["tokens"], d=d, f=f, rows=n,
               activation=c["activation"], experts=experts,
               empty_experts=sizes.count(0),
               group_sizes=sizes if experts <= MOE_EXPERTS else None,
               padding_rows=int(zero_rows.sum()), rows_used_by_k9=rows_used)
    ok = True
    results = {}
    for name, (kind, a, b) in products.items():
        run = _gmm_runner(kind, a, b, gs)
        got = run()
        if kind == "dw":
            ref = gm.grouped_matmul_dw_reference(a.float(), b.float(), gs)
        else:
            ref = gm.grouped_matmul_reference(a.float(), b.float(), gs,
                                              transpose_w=kind == "dx")
        torch.cuda.synchronize()
        e = gmm_errors(got, ref)
        if kind == "dw":
            e["exact_zeros"] = all(bool((got[i] == 0).all())
                                   for i, size in enumerate(sizes)
                                   if size == 0)
        elif kind == "fwd":
            e["exact_zeros"] = bool((got[zero_rows] == 0).all())
        # No atomics, a fixed order of sums: a second run is bit-equal.
        e["bit_equal_rerun"] = bool(torch.equal(run(), got))
        ok = ok and gmm_ok(e) and e["bit_equal_rerun"]
        out[name] = e
        results[name] = (got, ref)
    out["max_abs_err"] = max(out[p]["max_abs"] for p in products)

    if c.get("plant"):
        out["planted_faults"] = _gmm_planted_faults(products, results, gs,
                                                    sizes, ranges)
        ok = ok and all(v["caught"] for v in out["planted_faults"].values())
    del results
    out["ok"] = ok

    if c.get("timed"):
        timed = {}
        for name, (kind, a, b) in products.items():
            run = _gmm_runner(kind, a, b, gs)
            if kind == "dw":
                def plain(a=a, b=b):
                    gm.grouped_matmul_dw_reference(a, b, gs)
            else:
                def plain(a=a, b=b, kind=kind):
                    gm.grouped_matmul_reference(a, b, gs,
                                                transpose_w=kind == "dx")
            library = _library_gmm(kind, a, b, gs)
            b_ms, b_by, nbytes, flops = _gmm_bound(kind, a, b, rows_used)
            m = b.shape[1] if kind == "dx" else b.shape[-1]
            plan = gm.gmm_launch_plan(kind, n, a.shape[1], m, MOE_EXPERTS)
            ms = device_ms(run)
            timed[name] = dict(
                ms=ms, eager_ms=eager_ms(run),
                # The wrapper's host cost, its two tensor maps encoded.
                host_us=host_us(run, iters=50),
                grid=plan["grid"], tiles=plan["tiles"],
                # The plain versions read the group sizes back to the host
                # (no graph capture): eager, back to back.
                plain_ms=eager_ms(plain, iters=3, warmup=1),
                library_ms=device_ms(library),
                library_eager_ms=eager_ms(library),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                tflops=flops / ms / 1e9)
        out["timed"] = timed
    del layer, products
    torch.cuda.empty_cache()
    return out


def _gmm_planted_faults(products, results, gs, sizes, ranges):
    """The check applied to planted faults, each of which must fail it: one
    row block of the largest expert multiplied by another expert's
    weights, the last reduction step (the kernels' K tile, ``BLOCK_K``
    wide) skipped, and the largest expert's dw zeroed."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    big = max(range(len(sizes)), key=lambda i: sizes[i])
    other = next(i for i in range(len(sizes)) if i != big and sizes[i])
    faults = {}
    _, a, w = products["fwd_wi"]
    got, ref = results["fwd_wi"]
    s = ranges[big][0]
    blk = slice(s, s + GMM_BLOCK)
    wrong = got.clone()
    wrong[blk] = (a[blk].float() @ w[other].float()).to(got.dtype)
    a_last = torch.zeros_like(a)
    a_last[:, -gm.BLOCK_K:] = a[:, -gm.BLOCK_K:]
    skipped = (got.float() - gm.grouped_matmul_reference(
        a_last.float(), w.float(), gs)).to(got.dtype)
    dw, dw_ref = results["dw_wi"]
    zeroed = dw.clone()
    zeroed[big] = 0
    for name, g, r in (("wrong_expert_block", wrong, ref),
                       ("last_k_tile_skipped", skipped, ref),
                       ("expert_dw_zeroed", zeroed, dw_ref)):
        e = gmm_errors(g, r)
        faults[name] = dict(row=e["row"], norm=e["norm"],
                            caught=not gmm_ok(e))
    return faults


def moe_sync_check(gen):
    """One ``MoEMlp`` forward and backward at full width (d 1600, 8
    experts of d_ff 3200, 4 x 1024 tokens) under
    ``torch.cuda.set_sync_debug_mode("error")``: the grouped dispatch and
    the kernels' wrappers must not make the host wait for the card."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    layer = moe_layer(1600, MOE_D_FF, "gelu", gen)
    x = torch.randn((4, 1024, 1600), generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()

    def run():
        out, aux = layer(x)
        (out.float().square().mean() + aux).backward()

    run()  # first call: the op's registration and the library load
    torch.cuda.synchronize()
    before = dict(gm.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    got = {k: gm.LAUNCHES[k] - before[k] for k in before}
    want = {"gmm_fwd": 4, "gmm_dw": 2}
    res = {"phase": "moe_sync_check", "sync_debug_mode": "error",
           "tokens": 4 * 1024, "launches": got, "launches_wanted": want,
           "router_grad_nonzero": bool(layer.router.kernel.grad.abs().max()
                                       > 0)}
    emit(res)
    if got != want or not res["router_grad_nonzero"]:
        raise AssertionError(f"MoE sync check: {res}")
    del layer, x
    torch.cuda.empty_cache()


def gmm_kernel_checks(gen):
    cases = [check_gmm_case(c, gen) for c in GMM_CASES]
    emit({"phase": "gmm_kernel_checks",
          "tolerance": {"row": GMM_ROW_TOL, "norm": GMM_NORM_TOL,
                        "row_floor": GMM_ROW_FLOOR},
          "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"grouped matmul kernels disagree on {bad}")
    moe_sync_check(gen)
    return cases


def host_us(fn, iters: int = 200) -> float:
    """Host microseconds per call of ``iters`` back-to-back calls, not
    waiting for the card: what a launch costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e6


def mha_dispatch():
    """The flash forward's host cost under ``no_grad`` at two prefill
    shapes of the serve phase: through the custom op
    ``dlrover_tpu_torch::flash_fwd`` (``mha``'s differentiable path)
    against the bare kernel call, and the op's first call in the
    process."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {"phase": "dispatch"}
    with torch.no_grad():
        for s in (16, 512):
            c = dict(b=1, s=s, hq=25, hkv=25, d=64, fused=True)
            q, k, v, _, _ = _case_inputs(c, gen)
            fused = fa.uses_fused_backward(s, 1024)

            def op():
                fa.flash_fwd_op(q, k, v, None, None, True, 0.125, fused)

            def bare():
                fa.flash_fwd(q, k, v, causal=True, scale=0.125,
                             return_lse=False)

            if "op_first_call_s" not in out:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                op()
                torch.cuda.synchronize()
                out["op_first_call_s"] = time.perf_counter() - t0
            op_us, bare_us = host_us(op), host_us(bare)
            out[f"s{s}"] = {"op_host_us": op_us, "bare_host_us": bare_us,
                            "op_extra_ms_per_48_calls":
                                48 * (op_us - bare_us) / 1e3}
    emit(out)


# -- training -----------------------------------------------------------------


def num_params(cfg) -> int:
    """The JAX config's ``num_params`` (dense model), copied: parameter
    count for the MFU/HFU accounting."""
    d, v, layers = cfg.d_model, cfg.vocab_size, cfg.num_layers
    h = cfg.resolved_head_dim * cfg.num_heads
    hkv = cfg.resolved_head_dim * cfg.resolved_kv_heads
    attn = d * h + 2 * d * hkv + h * d
    ff = (3 if cfg.activation == "swiglu" else 2) * d * cfg.resolved_d_ff
    embed = v * d + (cfg.max_seq_len * d if cfg.position == "learned" else 0)
    head = 0 if cfg.tie_embeddings else v * d
    return layers * (attn + ff) + embed + head


def flops_per_token(cfg, seq: int) -> float:
    """``bench.py``'s model FLOPs per token: 6 N plus attention."""
    return 6 * num_params(cfg) + 12 * cfg.num_layers * cfg.d_model * seq


def recompute_flops_per_token(cfg, remat: str, seq: int) -> float:
    """``bench.py``'s extra hardware FLOPs per token the backward re-runs
    under ``remat`` (``none``, ``full`` and ``flash_only`` here)."""
    if remat == "none":
        return 0.0
    d = cfg.d_model
    hd = cfg.resolved_head_dim * cfg.num_heads
    ff = cfg.resolved_d_ff
    qkv, wi, wo = 2 * d * 3 * hd, 2 * d * ff, 2 * ff * d
    attn_fwd, out_proj = 4 * d * seq, 2 * hd * d
    per_layer = {
        "full": qkv + wi + wo + attn_fwd + out_proj,
        "flash_only": qkv + wi + wo + out_proj,
    }[remat]
    return per_layer * cfg.num_layers


def _launch_dicts():
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import fused_norm as fn
    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.ops import layout_pin as lp
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.embedding import kernels as ek
    from dlrover_tpu_torch.trainer import state_digest as sd

    return (fa.LAUNCHES, gm.LAUNCHES, fn.LAUNCHES, lp.LAUNCHES, tq.LAUNCHES,
            ek.LAUNCHES, sd.LAUNCHES)


def _counts():
    return {k: v for launches in _launch_dicts() for k, v in launches.items()}


def _zero_counts():
    for launches in _launch_dicts():
        for name in launches:
            launches[name] = 0


def _per_step(**launched):
    """A step's wanted launches: ``launched`` and 0 for every other
    kernel."""
    want = dict.fromkeys(_counts(), 0)
    unknown = set(launched) - set(want)
    if unknown:
        raise KeyError(f"no such launch counter: {sorted(unknown)}")
    want.update(launched)
    return want


def _train_batch(vocab: int, batch: int):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(batch, TRAIN_SEQ + 1),
                          dtype=np.int64)
    return {"inputs": torch.as_tensor(tokens[:, :-1], device="cuda"),
            "targets": torch.as_tensor(tokens[:, 1:], device="cuda")}


def _train_steps(train, state, batch, steps, want_per_step, aux_out=None):
    """Run ``steps`` steps, each asserted to launch ``want_per_step``;
    returns the state, per-step losses and synchronised seconds (and
    appends each step's ``aux_loss`` to ``aux_out`` when given)."""
    losses, seconds = [], []
    for i in range(steps):
        before = _counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train.step(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        after = _counts()
        got = {k: after[k] - before[k] for k in after}
        if got != want_per_step:
            raise AssertionError(
                f"step {i}: kernel launches {got}, want {want_per_step}")
        if not np.isfinite(loss):
            raise AssertionError(f"step {i}: non-finite loss {loss}")
        losses.append(loss)
        if aux_out is not None:
            aux_out.append(float(metrics["aux_loss"]))
    return state, losses, seconds


#: The ``train`` phase's median synchronised step (the yardstick of
#: ``train_fit``'s pipelined step in the same call).
TRAIN_STEP_S = {}
#: ``train_fit``'s pipelined step may be at most this much slower than
#: the ``train`` phase's (PERF.md §6: +0.23% and -0.17% in PR 12).
FIT_STEP_RTOL = 0.01


def train_and_check():
    """The training path at full width and depth; returns its counts and
    the bytes of its (Adafactor) optimizer state."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib

    cfg = gpt2_config("1.5b", attention_impl="flash", remat="flash_only",
                      param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, ce_chunks=0,
        device="cuda",
    )
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    per_step = _per_step(flash_fwd=cfg.num_layers,
                         flash_bwd_fused=cfg.num_layers)

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    state, warm_losses, warm_s = _train_steps(train, state, batch,
                                              TRAIN_WARMUP, per_step)
    state, losses, seconds = _train_steps(train, state, batch, TRAIN_STEPS,
                                          per_step)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    state_bytes = _state_bytes(state.opt_state)
    all_losses = warm_losses + losses
    if not all_losses[-1] < all_losses[0]:
        raise AssertionError(f"loss did not fall: {all_losses}")

    step_s = statistics.median(seconds)
    TRAIN_STEP_S["train"] = step_s
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tokens_per_s = tokens / step_s
    ftok = flops_per_token(cfg, TRAIN_SEQ)
    ftok_hw = ftok + recompute_flops_per_token(cfg, "flash_only", TRAIN_SEQ)
    # One step in the port's own capture (the profile the phase printed
    # before, and ``measure`` (a): the step by module).
    prof, MEASURE["a"] = _step_by_module(train, state, batch, cfg)
    busy = prof.get("device_busy_ms")
    emit({
        "phase": "train",
        "model": "gpt2-1.5b (48 layers, d_model 1600, 25 heads x 64, vocab "
                 "50304, bf16 params and compute, random weights seed 0)",
        "remat": cfg.remat, "optimizer": "adafactor lr 1e-4, clip 1.0",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "ce_chunks": 0,
        "losses": all_losses, "warmup_step_s": warm_s, "step_s": seconds,
        "step_s_median": step_s, "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * ftok / PEAK_BF16_FLOPS,
        "hfu": tokens_per_s * ftok_hw / PEAK_BF16_FLOPS,
        "model_flops_per_token": ftok, "hardware_flops_per_token": ftok_hw,
        "launches": counts, "launches_per_step": per_step,
        "peak_memory_allocated_bytes": peak, "setup_s": setup_s,
        "optimizer_state_bytes": state_bytes,
        "profiled_step": prof,
        "device_busy_share_of_median_step": (
            busy / (step_s * 1e3) if isinstance(busy, float) else
            "not measured"),
    })
    del state, train, batch
    torch.cuda.empty_cache()
    return counts, state_bytes


# -- the measurement planes (``measure``) -----------------------------------------

#: ``measure``: what each of its checks found, (a) to (e), read by
#: :func:`measure_report`.
MEASURE = {}
#: (a): the parsed device total of the captured step against the sum of
#: ``key_averages()``' device self time for the same window.  Both read the
#: same CUPTI records; the parse counts each kernel, copy and set once by
#: its trace row, so they differ only by rounding of the trace's
#: microsecond timestamps.
MEASURE_TOTAL_RTOL = 0.01
#: (a): the kernels of K1 and K3 as the trace names them (K3's pre-pass
#: and its dq cast are launches of their own, not counted).
MEASURE_K1, MEASURE_K3 = "flash_fwd_kernel", "flash_bwd_kv_tile_kernel"
#: (a): the module K1 and K3 must be given (K3 runs on autograd's thread,
#: so this holds the backward rule: a kernel takes its forward op's module).
MEASURE_ATTN = "blocks/attn"
#: (a): the GEMM launches a layer under each of a block's linear layers.
#: Each has its forward and its backward's two (dgrad and wgrad); under
#: ``flash_only`` the backward recomputes the block's forward, and the
#: recompute stops once the block's last saved tensors are saved again:
#: ``wo``'s operands, before ``wo``'s own GEMM (torch's checkpoint stops
#: early), so ``wo`` has no recompute.
MEASURE_GEMMS_PER_LAYER = {"blocks/attn/qkv": 4, "blocks/attn/out": 4,
                           "blocks/mlp/wi": 4, "blocks/mlp/wo": 3}
#: (b): the resumed fit's capture cadence: steps 7 and 8 run, 8 captured.
MEASURE_PROFILE_EVERY = 2
#: (e): the ``train_dp2`` run whose last step rank 0 captures (the overlap
#: engine: its legs are asynchronous, so the overlap fraction can be read).
MEASURE_DP2 = ("adafactor", "zero1_overlap_accum2")


def _step_by_module(train, state, batch, cfg):
    """``measure`` (a): one train step in ``utils.profiler.capture``; its
    kernels by module, held against ``key_averages()`` of the same
    window, with K1's and K3's launches counted from the trace.  Returns
    the ``train`` phase's profile summary and the part's record."""
    from dlrover_tpu_torch.utils import profiler as step_profiler

    seen = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = step_profiler.capture(
        train.step, (state, batch), steps=1, warmup=0, module=state.model,
        on_profile=lambda p: seen.update(p=p))
    capture_s = time.perf_counter() - t0
    summary = _profile_summary(seen.pop("p"), step.wall_s * 1e3, top=16)
    busy = summary.get("device_busy_ms")
    if not isinstance(busy, float):
        raise AssertionError(f"measure (a): key_averages() shows no device "
                             f"time: {summary}")
    total_ms = step.device_total_s * 1e3
    by_module = step.by_module()
    module_ms = sum(by_module.values()) * 1e3
    launches = {name: sum(op.count for op in step.ops if name in op.name)
                for name in (MEASURE_K1, MEASURE_K3)}
    # Each module's kernels by class of name (GEMM, flash, elementwise,
    # reduce, copy): where the step's elementwise time sits; and the
    # modules K1's and K3's launches were given.
    classes = collections.defaultdict(lambda: collections.defaultdict(float))
    class_launches = collections.defaultdict(collections.Counter)
    flash_modules = {name: collections.Counter()
                     for name in (MEASURE_K1, MEASURE_K3)}
    for op in step.ops:
        kind = step_profiler._classify(op.name)
        classes[op.module][kind] += op.time_s * 1e3
        class_launches[op.module][kind] += op.count
        for name, where in flash_modules.items():
            if name in op.name:
                where[op.module if op.module_path else "unattributed"] += \
                    op.count
    gemms = {m: class_launches[m]["matmul"] for m in MEASURE_GEMMS_PER_LAYER}
    gemms_want = {m: n * cfg.num_layers
                  for m, n in MEASURE_GEMMS_PER_LAYER.items()}
    out = {
        "device_ms": total_ms, "key_averages_device_ms": busy,
        "gap": abs(total_ms - busy) / busy, "gap_limit": MEASURE_TOTAL_RTOL,
        "k1_launches": launches[MEASURE_K1],
        "k3_launches": launches[MEASURE_K3],
        "k1_modules": dict(flash_modules[MEASURE_K1]),
        "k3_modules": dict(flash_modules[MEASURE_K3]),
        "gemm_launches": gemms,
        "gemm_launches_want": gemms_want,
        "module_sum_ms": module_ms,
        "unattributed_share": step.unattributed_s() / step.device_total_s,
        "by_module_ms": {m: t * 1e3 for m, t in by_module.items()},
        "by_module_class_ms": {m: dict(c) for m, c in classes.items()},
        "top_ops": [{"ms": op.time_s * 1e3, "count": op.count,
                     "module": op.module, "name": op.name[:70]}
                    for op in sorted(step.ops, key=lambda o: -o.time_s)[:12]],
        "wall_ms": step.wall_s * 1e3, "capture_s": capture_s}
    print("measure (a) the dense step by module, ms: " + ", ".join(
        f"{m} {t * 1e3:.3f}" for m, t in list(by_module.items())[:10])
        + f"; unattributed share {out['unattributed_share']:.4f}; parsed "
        f"{total_ms:.3f} ms against key_averages {busy:.3f} ms (gap "
        f"{out['gap']:.5f}); K1 by module {out['k1_modules']}, K3 by module "
        f"{out['k3_modules']}; GEMM launches {gemms} (want {gemms_want})",
        flush=True)
    if out["gap"] > MEASURE_TOTAL_RTOL:
        raise AssertionError(f"measure (a): parsed device total {total_ms} "
                             f"ms against key_averages {busy} ms")
    if (out["k1_launches"], out["k3_launches"]) != (cfg.num_layers,
                                                    cfg.num_layers):
        raise AssertionError(f"measure (a): {launches} launches of K1/K3 in "
                             f"the step, want {cfg.num_layers} each")
    if abs(module_ms - total_ms) > 1e-9 * total_ms:
        raise AssertionError(f"measure (a): modules sum to {module_ms} ms, "
                             f"the device total is {total_ms} ms")
    for name, where in flash_modules.items():
        if dict(where) != {MEASURE_ATTN: cfg.num_layers}:
            raise AssertionError(f"measure (a): {name} launches by module "
                                 f"{dict(where)}, want all {cfg.num_layers} "
                                 f"under {MEASURE_ATTN}")
    if gemms != gemms_want:
        raise AssertionError(f"measure (a): GEMM launches by module {gemms}, "
                             f"want {gemms_want}")
    return summary, out


def measure_report():
    """The ``measure`` phase: (a) the dense step by module, (b) ``fit``
    with both planes on, (c) a real OOM's postmortem, (d) serving's KV
    pool, (e) the wire's legs in a captured ``train_dp2`` step."""
    missing = [k for k in "abcde" if k not in MEASURE]
    emit({"phase": "measure", **{k: MEASURE.get(k) for k in "abcde"},
          "missing": missing})
    if missing:
        raise AssertionError(f"measure: parts {missing} did not run")


# -- Flash Checkpoint on the training state --------------------------------------

#: ``flash_ckpt``: the saver process's fault plan.  Each committed persist
#: makes five storage writes (meta, data, digest, done marker, tracker), so
#: hit 12 is the data write of the third persist.
CKPT_WRITE_FAULT_HIT = 12
#: ``flash_ckpt``: the loss of the second step after a restore against the
#: uninterrupted run's.  Both start from bit-equal states and take the
#: same first step bit for bit; the fused backward's dq atomics then make
#: the updates differ by fp32 rounding.  Sound readings (H100, GPT-2 1.5B,
#: loss 11.147): 1.08e-4 and 2.9e-6 against the uninterrupted run, 1.05e-4
#: between the two restored runs; the limit is about 3x the largest.  The
#: losses cannot show a restore that drops the optimizer state (the
#: planted fault read 9.5e-6 on an H100): the restored trainer's state is
#: held to the saved one bit for bit instead.
CKPT_LOSS_ATOL = 3.5e-4


def _wait_persist_attempt(ckpt, timeout=600.0):
    """Wait for the saver to take the arena's lock for a persist and to
    give it back, whether the persist committed or failed (a failure is
    only logged in the saver's process)."""
    lock = ckpt._engine._lock
    deadline = time.monotonic() + 60.0
    while not lock.locked() and time.monotonic() < deadline:
        time.sleep(0.02)
    deadline = time.monotonic() + timeout
    while lock.locked() and time.monotonic() < deadline:
        time.sleep(0.1)


def _saver_main(ckpt_dir, ready, stop, report):
    """The saver process (started with ``spawn``): an ``AsyncCheckpointSaver``
    for host 0 that persists the trainer's arena until ``stop`` is set,
    then removes the arena; it reads shm and writes storage only, and
    never touches the card.  Puts the faults it fired on ``report`` before
    it exits."""
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common import faults

    saver = AsyncCheckpointSaver(ckpt_dir, host_index=0, num_hosts=1)
    saver.start()
    ready.set()
    stop.wait()
    saver.stop(unlink_shm=True)
    plan = faults.active()
    report.put(list(plan.fired) if plan is not None else [])


def _df(path):
    out = subprocess.run(["df", "-B1", path], capture_output=True,
                         text=True)
    lines = out.stdout.strip().splitlines()
    fields = lines[-1].split() if lines else []
    return {"line": lines[-1] if lines else out.stderr.strip(),
            "available_bytes": int(fields[3]) if len(fields) > 3 else None}


def _tree_nbytes(tree):
    from dlrover_tpu_torch.checkpoint import shm_handler as sh

    return sum(leaf.numel() * leaf.element_size()
               for _, leaf in sh.tree_flatten_with_path(tree)
               if isinstance(leaf, torch.Tensor))


def _tree_snapshot(tree):
    """A copy of every tensor of ``tree`` on the card (the saved state, to
    hold restores against after training moves on)."""
    from dlrover_tpu_torch.checkpoint import shm_handler as sh

    return sh.tree_map_with_path(
        lambda _, x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _same_bits(got, want):
    """Whether two tensors have one dtype, shape and device and the same
    bytes (so -0.0 differs from 0.0 and a NaN equals its own bits)."""
    if not (isinstance(got, torch.Tensor) and got.dtype == want.dtype
            and got.shape == want.shape and got.device == want.device):
        return False
    return torch.equal(got.reshape(-1).view(torch.uint8),
                       want.reshape(-1).view(torch.uint8))


def _trees_bit_equal(got, want):
    """Paths whose leaves differ (dtype, shape or any bit)."""
    from dlrover_tpu_torch.checkpoint import shm_handler as sh

    gl, wl = (sh.tree_flatten_with_path(t) for t in (got, want))
    if [p for p, _ in gl] != [p for p, _ in wl]:
        return ["<structure>"]
    bad = []
    for (path, g), (_, w) in zip(gl, wl):
        if isinstance(w, torch.Tensor):
            same = _same_bits(g, w)
        else:
            same = g == w and type(g) is type(w)
        if not same:
            bad.append("".join(path))
    return bad


#: ``flash_ckpt``'s depth: 6 of GPT-2 1.5B's 48 layers (48 until PR 15,
#: 24 until PR 17, each cut for the script's time: the phase took
#: 79.7–90.9 s at 48 and 49.3 s at 24; PR 17 added ``train_opts`` and the
#: local-SGD job).
FLASH_CKPT_LAYERS = 6


def flash_ckpt_and_check():
    """Flash Checkpoint on the ``train`` phase's GPT-2 1.5B state (full
    width; full depth unless ``/dev/shm`` cannot hold the arena), with the
    saver in a process of its own (``spawn``)."""
    import multiprocessing
    import shutil
    import tempfile

    from dlrover_tpu_torch.checkpoint import Checkpointer, StorageType
    from dlrover_tpu_torch.checkpoint.engine import StorageStepReader
    from dlrover_tpu_torch.common.storage import (
        CheckpointDirLayout,
        PosixDiskStorage,
    )
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib

    shm_df = _df("/dev/shm")
    ckpt_dir = os.path.join(REPO, "build", "flash_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    disk_df = _df(ckpt_dir)
    sock_dir = tempfile.mkdtemp(prefix="ckpt_socks_")
    os.environ["DLROVER_TPU_SOCKET_DIR"] = sock_dir
    os.environ["DLROVER_TPU_JOB"] = f"smoke{os.getpid()}"

    def build(layers):
        cfg = gpt2_config("1.5b", attention_impl="flash",
                          remat="flash_only", param_dtype=torch.bfloat16,
                          num_layers=layers)
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer("adafactor",
                                          learning_rate=TRAIN_LR),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, ce_chunks=0,
            device="cuda")
        return cfg, train

    # The arena is the state's bytes (and the meta) rounded up to a power
    # of two; cut the depth further only if /dev/shm cannot hold it.
    depth = FLASH_CKPT_LAYERS
    cfg, train = build(depth)
    state = train.init(seed=0)
    full_bytes = _tree_nbytes(state.checkpoint_tree())
    per_layer = (full_bytes - _tree_nbytes({"params": {
        k: v for k, v in state.params().items()
        if not k.startswith("blocks.")}})) / depth
    layers = depth
    avail = shm_df["available_bytes"]

    def arena(nbytes):
        return 1 << (int(nbytes * 1.001) + (1 << 20) - 1).bit_length()

    while avail is not None and layers > 1 and arena(
            full_bytes - (depth - layers) * per_layer) > avail:
        layers -= 1
    emit({"phase": "flash_ckpt_setup", "dev_shm": shm_df,
          "checkpoint_disk": disk_df, "uncut_state_bytes": full_bytes,
          "layers": layers})
    if layers != depth:
        del state, train
        torch.cuda.empty_cache()
        cfg, train = build(layers)
        state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    per_step = _per_step(flash_fwd=cfg.num_layers,
                         flash_bwd_fused=cfg.num_layers)

    ctx = multiprocessing.get_context("spawn")
    ready, stop, report = ctx.Event(), ctx.Event(), ctx.Queue()
    saved_env = {k: os.environ.get(k) for k in ("DLROVER_TPU_FAULTS",
                                                "DLROVER_TPU_FAULTS_SEED")}
    os.environ["DLROVER_TPU_FAULTS"] = (
        f"storage.write:error@{CKPT_WRITE_FAULT_HIT}")
    os.environ["DLROVER_TPU_FAULTS_SEED"] = "0"
    saver = ctx.Process(target=_saver_main,
                        args=(ckpt_dir, ready, stop, report), daemon=True)
    saver.start()
    for k, v in saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    out = {"phase": "flash_ckpt", "layers": cfg.num_layers,
           "depth_cut_for_dev_shm": cfg.num_layers != FLASH_CKPT_LAYERS,
           "dev_shm": shm_df, "checkpoint_disk": disk_df}
    try:
        if not ready.wait(120):
            raise AssertionError("the saver process did not start")
        ckpt = Checkpointer(ckpt_dir, host_index=0, num_hosts=1,
                            device="cuda")
        layout, storage = CheckpointDirLayout(ckpt_dir), PosixDiskStorage()

        # -- the main path, counted: 1 + 2 steps, save, step on -------------
        _zero_counts()
        state, warm, _ = _train_steps(train, state, batch, 1, per_step)
        state, losses, _ = _train_steps(train, state, batch, 2, per_step)
        # The forward is deterministic: the same state gives the same loss
        # bit for bit, so a restored state's next loss must equal.
        evals = [float(train.eval_step(state, batch)["loss"])
                 for _ in range(2)]
        saved_step = state.step
        tree = state.checkpoint_tree()
        saved = _tree_snapshot(tree)
        nbytes = _tree_nbytes(tree)
        if not ckpt.save_checkpoint(saved_step, tree, StorageType.MEMORY):
            raise AssertionError("memory save skipped")
        memory_s = ckpt._engine.last_save_seconds
        arena_bytes = ckpt._engine._shm.size
        t0 = time.perf_counter()
        if not ckpt.save_checkpoint(saved_step, tree, StorageType.DISK):
            raise AssertionError("disk save skipped")
        disk_memory_s = ckpt._engine.last_save_seconds
        if not ckpt.wait(timeout=600):
            raise AssertionError("persist did not commit")
        persist_s = time.perf_counter() - t0
        del tree
        state, after, _ = _train_steps(train, state, batch, 2, per_step)
        counts = _counts()
        del state
        torch.cuda.empty_cache()
        # A restarted trainer on another host: no arena, storage only.
        reader = StorageStepReader(ckpt_dir, num_hosts=1, device="cuda")

        def restored_run(label, load, fresh_opt=False):
            """Restore into a fresh state's tree (another seed), check it
            bit for bit against the saved state, then take the two steps
            the uninterrupted run took; returns the record and the state
            two steps on.  ``fresh_opt`` plants a fault: the restored
            params with the fresh state's optimizer state, which the
            trainer's state after ``Train.restore`` must show."""
            fresh = train.init(seed=1)
            template = fresh.checkpoint_tree()
            torch.cuda.synchronize()
            t = time.perf_counter()
            step, tree = load(template)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            opt = fresh.opt_state
            del template, fresh
            differ = _trees_bit_equal(tree, saved)
            res = {"step": step, "restore_s": seconds,
                   "leaves_differing": differ[:8]}
            if step != saved_step or differ:
                raise AssertionError(f"{label}: {res}")
            restored = train.restore(
                step, dict(tree, opt_state=opt) if fresh_opt else tree)
            del tree, opt
            res["state_differing"] = _trees_bit_equal(
                restored.checkpoint_tree(), saved)[:8]
            restored, got, _ = _train_steps(train, restored, batch, 2,
                                            per_step)
            res["losses"] = got
            res["step3_loss_equal"] = got[0] == after[0]
            res["step4_loss_diff"] = abs(got[1] - after[1])
            sound = (not res["state_differing"] and res["step3_loss_equal"]
                     and res["step4_loss_diff"] <= CKPT_LOSS_ATOL)
            if fresh_opt:
                res["caught"] = not sound
            if sound == fresh_opt:
                raise AssertionError(f"{label}: {res}")
            return res, restored

        def from_arena(template):
            return ckpt.load_checkpoint(state_template=template)

        from_shm, state = restored_run("restore from shm", from_arena)
        del state
        torch.cuda.empty_cache()
        fresh_opt, state = restored_run("fresh optimizer state (planted)",
                                        from_arena, fresh_opt=True)
        del state
        torch.cuda.empty_cache()
        from_storage, state = restored_run(
            "restore from storage",
            lambda template: reader.load_from_storage(template=template))

        # -- planted faults ------------------------------------------------
        # A second committed step (the restored state two steps on), then
        # a third whose data write the saver's plan fails: the tracker keeps
        # the second.  Then one flipped byte in the second's data: the crc
        # and digest chain rejects it and the restore falls back to the
        # first.
        later_step = state.step
        later = _tree_snapshot(state.checkpoint_tree())
        if not ckpt.save_checkpoint(later_step, later, StorageType.DISK):
            raise AssertionError("second disk save skipped")
        if not ckpt.wait(timeout=600):
            raise AssertionError("second persist did not commit")
        state, _, _ = _train_steps(train, state, batch, 1, per_step)
        t0 = time.perf_counter()
        if not ckpt.save_checkpoint(state.step, state.checkpoint_tree(),
                                    StorageType.DISK):
            raise AssertionError("third disk save skipped")
        _wait_persist_attempt(ckpt)
        committed = ckpt.wait(timeout=2.0)
        tracker = layout.latest_step(storage)
        write_fault = {"step": state.step, "committed": committed,
                       "tracker": tracker, "wait_s": time.perf_counter() - t0,
                       "caught": not committed and tracker == later_step}
        del state
        torch.cuda.empty_cache()
        step, tree = reader.load_from_storage(template=later)
        write_fault["restored_step"] = step
        write_fault["restored_equal"] = (
            step == later_step and not _trees_bit_equal(tree, later))
        del tree
        data_path = layout.data_path(later_step, 0, 1)
        flip_at = os.path.getsize(data_path) // 3
        with open(data_path, "r+b") as f:
            f.seek(flip_at)
            byte = f.read(1)
            f.seek(flip_at)
            f.write(bytes([byte[0] ^ 0x40]))
        step, tree = reader.load_from_storage(template=later)
        flip = {"step": later_step, "offset": flip_at, "restored_step": step,
                "caught": step == saved_step
                and not _trees_bit_equal(tree, saved)}
        del tree, later
        ckpt.close()
    finally:
        stop.set()
        saver.join(120)
        fired = report.get(timeout=30) if saver.exitcode == 0 else None
        if saver.is_alive():
            saver.terminate()
            saver.join(30)
        shutil.rmtree(sock_dir, ignore_errors=True)
    write_fault["saver_fired"] = fired
    write_fault["caught"] = write_fault["caught"] and fired == [
        ("storage.write", "error", CKPT_WRITE_FAULT_HIT)]
    out.update({
        "state_bytes": nbytes, "uncut_state_bytes": full_bytes,
        "arena_bytes": arena_bytes, "saved_step": saved_step,
        "losses": warm + losses, "uninterrupted_after_save": after,
        "forward_deterministic": evals[0] == evals[1], "eval_losses": evals,
        "memory_save_s": memory_s,
        "memory_save_gbytes_per_s": nbytes / memory_s / 1e9,
        "disk_call_memory_save_s": disk_memory_s,
        "persist_s": persist_s,
        "restore_shm": from_shm, "restore_storage": from_storage,
        "restore_shm_s": from_shm["restore_s"],
        "restore_storage_s": from_storage["restore_s"],
        "planted_fresh_optimizer_state": fresh_opt,
        "planted_write_fault": write_fault, "planted_byte_flip": flip,
        "launches": counts,
    })
    emit(out)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not (out["forward_deterministic"] and write_fault["caught"]
            and write_fault["restored_equal"] and flip["caught"]):
        raise AssertionError(f"flash_ckpt failed: {out}")
    del train, batch, saved
    torch.cuda.empty_cache()
    return counts


# -- the elastic loop at world 1 ---------------------------------------------------

#: ``train_fit``: ``TrainerConfig`` of the run (PERF.md §4).
FIT_CONFIG = dict(global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                  optimizer="adafactor", learning_rate=TRAIN_LR,
                  ckpt_every=4, report_every=2, metrics_lag=2,
                  prefetch_to_device=2, sdc_check_every=2, eval_every=4,
                  eval_batches=1)
FIT_STEPS, FIT_MORE_STEPS = 6, 8
#: ``--fit-gate``: runs of the ``train_fit`` phase after one ``train``.
FIT_GATE_RUNS = 3
#: ``train_fit`` asks for the data-parallel options; at one data rank they
#: deactivate, as the reference's do.
FIT_DP_OPTIONS = dict(zero1=True, overlap=True, reduce_quant="int8")
#: The sampler's dataset (indices; each sample is made from its index).
FIT_DATASET = 100_000
#: ``elastic_run``: the trainer the launcher runs, GPT-2 1.5B's width at 2
#: of its 48 layers (``--vocab 50257``: the published vocabulary), flash
#: attention, Adafactor (its state stays near the parameters' 0.57 GB in
#: fp32), saves at 4, 8 and 12, a crash at 10 on the first run, a profiled
#: step every 4 and the classified memory snapshot on the report cadence.
#: ``--step-sleep`` (the example's test hook) spaces the saves: a step takes
#: about 40 ms, and without it step 8's save finds the saver still
#: persisting step 4 and is skipped, so the restart resumes at 4.
ELASTIC_TRAINER_ARGV = [
    "--device", "cuda", "--attention-impl", "flash", "--layers", "2",
    "--d-model", "1600", "--heads", "25", "--vocab", "50257",
    "--seq-len", "1024", "--batch-size", "4", "--optimizer", "adafactor",
    "--steps", "12", "--ckpt-every", "4", "--fail-at-step", "10",
    "--profile-every", "4", "--memory-report", "--step-sleep", "1.5"]
ELASTIC_CRASH_RC, ELASTIC_RESUME_STEP, ELASTIC_STEPS = 17, 8, 12
#: The launcher's limit (both trainer runs, the restart and the agent's
#: exit).
ELASTIC_TIMEOUT_S = 420
#: The launcher's niceness (its agent and trainers inherit it).
ELASTIC_NICE = 10


#: About 0.1 s of the card's clock: the host dispatches the digest while
#: the device sleeps, and the events around it read the device's own time.
DIGEST_SLEEP_CYCLES = 200_000_000


def _plain_digest(leaves) -> int:
    """The digest's construction on the host, leaf by leaf: each leaf's
    raw-byte sum (an int64 sum of its byte view; the reference's int32
    step counter for an int), folded as ``acc * 1000003 + sum`` mod
    2^32."""
    acc = 0
    for leaf in leaves:
        if isinstance(leaf, int):
            total = int(np.asarray(leaf, np.int32).reshape(1).view(np.uint8)
                        .sum(dtype=np.int64))
        else:
            t = leaf.detach()
            if t.dtype == torch.bool:
                t = t.view(torch.uint8)
            total = int(t.reshape(-1).contiguous().view(torch.uint8)
                        .sum(dtype=torch.int64))
        acc = (acc * 1000003 + total) & 0xFFFFFFFF
    return acc


class _RecordedLoader:
    """An ``ElasticDataLoader`` whose host batches are kept in the order
    the prefetcher takes them (``batches_with_acks`` is what it reads)."""

    def __init__(self, loader):
        self.loader = loader
        self.host = []

    def batches_with_acks(self):
        for batch, ack in self.loader.batches_with_acks():
            self.host.append(batch)
            yield batch, ack


def _fit_loader(vocab, seed):
    from dlrover_tpu_torch.data.loader import (
        ElasticDataLoader,
        ElasticDistributedSampler,
        synthetic_lm_sample_fn,
    )

    return ElasticDataLoader(
        synthetic_lm_sample_fn(vocab, TRAIN_SEQ, seed=seed),
        batch_size=TRAIN_BATCH,
        source=ElasticDistributedSampler(FIT_DATASET, shuffle=True,
                                         seed=seed))


@contextlib.contextmanager
def _captured_log(pattern):
    """Messages of the port's logger that match ``pattern``, while the
    block runs."""
    import logging

    from dlrover_tpu_torch.common.log import default_logger

    found = []

    class Grab(logging.Handler):
        def emit(self, record):
            message = record.getMessage()
            if re.search(pattern, message):
                found.append(message)

    handler = Grab()
    default_logger.addHandler(handler)
    try:
        yield found
    finally:
        default_logger.removeHandler(handler)


def _elastic_spies(master):
    """Wraps four of ``master``'s entry points to keep what they saw:
    each failure report (node, exit code, error), for each recovery the
    shards the node held (task ids) and the queue's head after it, and a
    node's timeline and memory snapshot as they were when the master
    evicted them (a node that succeeds leaves the job's observability
    series, as in the reference)."""
    seen = {"failures": [], "recoveries": [], "evicted_events": {},
            "evicted_memory": {}}
    report_failure = master.node_manager.report_failure
    recover = master.task_manager.recover_tasks
    evict_node = master.timeline.evict_node
    evict_memory = master.memory_ledger.evict

    def timeline_evict(node_id):
        seen["evicted_events"].setdefault(node_id, []).extend(
            master.timeline.events(node_id).get(node_id, []))
        evict_node(node_id)

    def memory_evict(node_id):
        snap = master.memory_ledger.per_node().get(node_id)
        if snap is not None:
            seen["evicted_memory"][node_id] = snap
        evict_memory(node_id)

    def failure(node_id, error, exit_code, level):
        seen["failures"].append({"node": node_id, "exit_code": exit_code,
                                 "level": level, "error": error})
        return report_failure(node_id, error, exit_code, level)

    def recover_tasks(node_id):
        tm = master.task_manager
        with tm._lock:
            held = {name: [tid for tid, (owner, _, _) in dm.doing.items()
                           if owner == node_id]
                    for name, dm in tm._datasets.items()}
        recover(node_id)
        with tm._lock:
            head = {name: [t.task_id for t in list(dm.pending)[:len(
                held.get(name, ()))]] for name, dm in tm._datasets.items()}
        seen["recoveries"].append({"node": node_id, "held": held,
                                   "queue_head": head})

    master.node_manager.report_failure = failure
    master.task_manager.recover_tasks = recover_tasks
    master.timeline.evict_node = timeline_evict
    master.memory_ledger.evict = memory_evict
    return seen


def _node_events(master, seen, node_id=0):
    """Node ``node_id``'s timeline events: those the master evicted when
    the node finished, then those it holds now."""
    return seen["evicted_events"].get(node_id, []) + \
        master.timeline.events(node_id).get(node_id, [])


def _goodput_split(master, events):
    """The goodput ledger's split as the master holds it: productive
    seconds (the speed monitor's), the restart (the agent's
    ``process_exit`` of the crash to the next trainer's first step span
    on the merged timeline), the rendezvous spans, the restore spans and
    the checkpoint spans, over one node's timeline ``events``."""

    def spans(name):
        return [(t, d, a) for n, _, t, d, a in events if n == name]

    exits = [t for t, _, a in spans("process_exit") if a.get("code")]
    steps = sorted(t for t, _, _ in spans("step"))
    restart_s = None
    if exits:
        after = [t for t in steps if t > exits[0]]
        restart_s = after[0] - exits[0] if after else None
    sm = master.speed_monitor
    return {
        "productive_s": sm._productive_s,
        "goodput": sm.goodput(),
        "restart_s": restart_s,
        "rendezvous_s": [d for _, d, _ in spans("rendezvous")],
        "restore_s": [d for _, d, _ in spans("restore")],
        "checkpoint_s": sum(d for _, d, _ in spans("checkpoint")),
        "checkpoint_spans": len(spans("checkpoint")),
        "compile": sm.compile_ledger(),
    }


def elastic_run(scratch, trainer_argv=None, on_card=True):
    """``python -m dlrover_tpu_torch.run`` against a ``JobMaster`` in this
    process: the agent rendezvouses, runs ``train_lm`` (a subprocess of a
    subprocess), reports its crash, restarts it; the master's ledgers are
    read after the launcher exits.  ``on_card=False`` (a CPU rehearsal)
    skips the profiled window's kernel counts."""
    from dlrover_tpu_torch.common.storage import (
        CheckpointDirLayout,
        PosixDiskStorage,
    )
    from dlrover_tpu_torch.master.job_master import JobMaster

    trainer_argv = ELASTIC_TRAINER_ARGV if trainer_argv is None \
        else trainer_argv

    def flag(name):
        return int(trainer_argv[trainer_argv.index(name) + 1])

    steps, crash_step = flag("--steps"), flag("--fail-at-step")
    resume_step = crash_step - crash_step % flag("--ckpt-every")
    ckpt_dir = os.path.join(scratch, "ckpt")
    job = f"elastic{os.getpid()}"
    env = dict(os.environ,
               DLROVER_TPU_JOB=job,
               DLROVER_TPU_SOCKET_DIR=os.path.join(scratch, "socks"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    for key in ("DLROVER_TPU_RESTART_COUNT", "DLROVER_TPU_MASTER_ADDR",
                "DLROVER_TPU_COORDINATOR"):
        env.pop(key, None)
    t0 = time.perf_counter()
    master = JobMaster(port=0, num_nodes=1)
    seen = _elastic_spies(master)
    port = master.start()
    argv = [sys.executable, "-m", "dlrover_tpu_torch.run",
            "--master", f"localhost:{port}", "--nnodes", "1",
            "--node-id", "0", "--max-restarts", "1",
            "--monitor-interval", "1", "--checkpoint-dir", ckpt_dir, "--",
            sys.executable, "-m", "dlrover_tpu_torch.examples.train_lm",
            *trainer_argv, "--checkpoint-dir", ckpt_dir]
    out = {"argv": argv[2:]}
    try:
        proc = subprocess.Popen(argv, env=env, cwd=REPO,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        _ELASTIC["proc"] = proc
        # Niced (the agent's trainers inherit it): the run has slack
        # beside ``train_fit``'s end and ``train_dp2``, whose host-bound
        # steps it must not slow.
        os.setpriority(os.PRIO_PROCESS, proc.pid, ELASTIC_NICE)
        try:
            log, _ = proc.communicate(timeout=ELASTIC_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
        out["launcher_rc"] = proc.returncode
        out["launcher_s"] = time.perf_counter() - t0
        with open(os.path.join(REPO, "build", "elastic_run.log"), "w") as f:
            f.write(log)
        out["saves_s"] = [[int(st), float(x)] for st, x in re.findall(
            r"step (\d+): saved to shm in ([\d.]+)s", log)]
        out["persists_s"] = [[int(st), float(x)] for st, x in re.findall(
            r"persisted step (\d+) in ([\d.]+)s", log)]
        out["skipped_saves"] = [int(st) for st in re.findall(
            r"step (\d+): checkpoint skipped", log)]
        resumed = re.findall(r"resumed from checkpoint at step (\d+)", log)
        source = re.findall(r"restoring step (\d+) from (shm)", log)
        out["resumed_at"] = [int(r) for r in resumed]
        out["restored_from_shm"] = [int(r) for r, _ in source]
        out["committed_step"] = CheckpointDirLayout(ckpt_dir).latest_step(
            PosixDiskStorage())
        rdzv = master.rdzv_managers["elastic-training"]
        out["rdzv_round"] = rdzv._rdzv_round
        out["job_phase"] = master.job_phase()
        out["last_step"] = master.speed_monitor.global_step
        out["failures"] = [
            {**f, "error": f["error"][-400:],
             "tail_has_crash": f"crashing at step {crash_step}" in f["error"]}
            for f in seen["failures"]]
        out["recoveries"] = seen["recoveries"]
        events = _node_events(master, seen)
        out["restarts"] = sum(1 for e in events if e[0] == "restart")
        out["worker_starts"] = master.timeline.counter("worker_starts")
        windows = [a for n, _, _, _, a in events if n == "calibration"]
        out["windows"] = [
            {k: v for k, v in a.items()
             if k in ("step", "wall_s", "device_total_s", "measured_compute")
             or k.startswith("kernel_")} for a in windows]
        out["calibration"] = master.calibration.state()
        out["memory_pools"] = {
            str(node): {k: v for k, v in snap.items()
                        if k.startswith("pool_") or k in ("step",
                                                          "bytes_in_use")}
            for node, snap in {**seen["evicted_memory"],
                               **master.memory_ledger.per_node()}.items()}
        out["goodput_split"] = _goodput_split(master, events)
        if out["launcher_rc"] != 0:
            out["log_tail"] = log[-3000:]
    finally:
        master.stop()
        arena = f"/dev/shm/dlrover_tpu_ckpt_{job}_h0"
        if os.path.exists(arena):
            os.unlink(arena)
    out["wall_s"] = time.perf_counter() - t0
    held = [tid for r in out["recoveries"] if r["node"] == 0
            for tids in r["held"].values() for tid in tids]
    requeued = all(r["queue_head"].get(name) == tids
                   for r in out["recoveries"]
                   for name, tids in r["held"].items() if tids)
    kernels = {}
    for w in out["windows"]:
        for k, v in w.items():
            if k.startswith("kernel_"):
                kernels[k[len("kernel_"):]] = kernels.get(
                    k[len("kernel_"):], 0) + v
    out["window_launches"] = kernels
    pools = next(iter(out["memory_pools"].values()), {})
    checks = {
        "launcher_exit_0": out["launcher_rc"] == 0,
        "one_failure_exit_17": [
            (f["node"], f["exit_code"], f["tail_has_crash"])
            for f in out["failures"]] == [(0, ELASTIC_CRASH_RC, True)],
        "restarted_once": out["restarts"] == 1
        and out["worker_starts"] == 2,
        "rdzv_round_2": out["rdzv_round"] == 2,
        "resumed_from_shm": out["resumed_at"] == [resume_step]
        and out["restored_from_shm"] == [resume_step],
        "committed_last_step": out["committed_step"] == steps,
        "job_succeeded": out["job_phase"] == "succeeded",
        "speed_monitor_last_step": out["last_step"] == steps,
        "shards_requeued": bool(held) and requeued,
        "calibration_windows": bool(out["windows"])
        and bool(out["calibration"]["counts"]),
        "memory_params_pool": pools.get("pool_params_b", 0) > 0,
    }
    if on_card:
        # The profiled steps' kernels: K1 forward and K3 (the kv-tile
        # kernel without K2a's dq kernel beside it is the fused backward).
        checks["window_k1_k3"] = (
            kernels.get("flash_fwd_kernel", 0) > 0
            and kernels.get("flash_bwd_kv_tile_kernel", 0) > 0
            and kernels.get("flash_bwd_dq_kernel", 0) == 0)
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


#: The elastic run's thread, its launcher process and its result
#: (``elastic_start``, ``elastic_run_and_check``).
_ELASTIC = {}


def elastic_start():
    """Starts the elastic run in a thread: its processes (the agent and
    the trainer, host-bound but for the trainer's steps) run while this
    process goes on with the next phases, and ``elastic_run_and_check``
    reads the result."""
    import shutil
    import threading

    scratch = os.path.join(REPO, "build", "elastic_run")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)

    def run():
        try:
            _ELASTIC["out"] = elastic_run(scratch)
        except BaseException as e:  # noqa: BLE001 - read by the check
            _ELASTIC["out"] = {"ok": False, "error": repr(e)}

    thread = threading.Thread(target=run, daemon=True)
    _ELASTIC.update(thread=thread, scratch=scratch, t0=time.perf_counter())
    thread.start()


def elastic_run_and_check():
    """Phase ``elastic_run``: waits for the elastic run (started now when
    nothing started it) and holds it to its checks; returns the launches
    of the flash kernels seen in its profiled windows."""
    if "thread" not in _ELASTIC:
        elastic_start()
    _ELASTIC["thread"].join(timeout=ELASTIC_TIMEOUT_S + 60)
    out = {"phase": "elastic_run",
           **_ELASTIC.get("out", {"ok": False, "error": "did not finish"}),
           "phase_wall_s": time.perf_counter() - _ELASTIC["t0"]}
    _elastic_stop()
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"elastic_run: {out.get('checks', out)}")
    seen = out["window_launches"]
    return _per_step(flash_fwd=seen.get("flash_fwd_kernel", 0),
                     flash_bwd_fused=seen.get("flash_bwd_kv_tile_kernel", 0))


def _elastic_stop():
    """Kills the launcher's process group if it still runs."""
    import shutil

    proc = _ELASTIC.get("proc")
    if proc is not None and proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()
    if "scratch" in _ELASTIC:
        shutil.rmtree(_ELASTIC["scratch"], ignore_errors=True)
    _ELASTIC.clear()


def _thread_cpu_ticks():
    """{native thread id: user + system clock ticks} of each thread of this
    process, read from ``/proc`` (Linux)."""
    base = f"/proc/{os.getpid()}/task"
    out = {}
    for tid in os.listdir(base):
        try:
            with open(f"{base}/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[int(tid)] = int(fields[11]) + int(fields[12])
    return out


def _thread_names():
    """{native thread id: name}: Python's names, else the kernel's."""
    import threading

    names = {t.native_id: t.name for t in threading.enumerate()}
    base = f"/proc/{os.getpid()}/task"
    for tid in os.listdir(base):
        if int(tid) not in names:
            try:
                with open(f"{base}/{tid}/comm") as f:
                    names[int(tid)] = f.read().strip()
            except OSError:
                pass
    return names


def train_fit_and_check(on_measured=None):
    """``ElasticTrainer.fit`` on the ``train`` phase's GPT-2 1.5B at full
    width and depth: the data tier, the CUDA-stream prefetcher, the
    deferred metrics, the numeric monitor, the SDC digest, Flash
    Checkpoint at the cadence and a restore on a new trainer.
    ``on_measured()`` is called once the fit's step times and the
    digest's cost are taken (before ``close()``): work started there runs
    beside the rest of the phase without touching what it times.
    Returns the counted launches of the fit."""
    import gc
    import shutil
    import tempfile
    import threading

    from dlrover_tpu_torch.checkpoint import shm_handler as sh
    from dlrover_tpu_torch.common import faults
    from dlrover_tpu_torch.common.storage import (
        CheckpointDirLayout,
        PosixDiskStorage,
    )
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import state_digest
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        ElasticTrainer,
        TrainerConfig,
    )
    from dlrover_tpu_torch.utils.profiler import pipeline_counters

    scratch = os.path.join(REPO, "build", "train_fit")
    shutil.rmtree(scratch, ignore_errors=True)
    os.makedirs(scratch)
    ckpt_dir = os.path.join(scratch, "ckpt")
    sock_dir = tempfile.mkdtemp(prefix="fit_socks_")
    saved_env = {k: os.environ.get(k) for k in ("DLROVER_TPU_JOB",
                                                "DLROVER_TPU_SOCKET_DIR")}
    os.environ["DLROVER_TPU_SOCKET_DIR"] = sock_dir
    os.environ["DLROVER_TPU_JOB"] = f"fit{os.getpid()}"
    arena = f"/dev/shm/{sh.SharedMemoryHandler('h0').name}"
    import torch.distributed as dist

    from dlrover_tpu_torch.runtime.mesh import ParallelConfig

    cfg = gpt2_config("1.5b", attention_impl="flash", remat="flash_only",
                      param_dtype=torch.bfloat16)
    tcfg = TrainerConfig(checkpoint_dir=ckpt_dir, **FIT_CONFIG,
                         **FIT_DP_OPTIONS)
    per_step = _per_step(flash_fwd=cfg.num_layers,
                         flash_bwd_fused=cfg.num_layers)
    per_eval = _per_step(flash_fwd=cfg.num_layers)
    out = {"phase": "train_fit",
           "model": "gpt2-1.5b (48 layers, bf16 params and compute, "
                    "flash_only, random weights seed 0)",
           "trainer_config": dict(FIT_CONFIG, **FIT_DP_OPTIONS),
           "max_steps": FIT_STEPS}
    # A world of one process over NCCL: the mesh through
    # ParallelConfig(data=-1), where ZeRO-1, the overlap engine and the
    # int8 reduce must all report themselves inactive.
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer = ElasticTrainer(cfg, tcfg, parallel=ParallelConfig(data=-1),
                                 device="cuda")
        torch.cuda.synchronize()
        out["construct_s"] = time.perf_counter() - t0
        if trainer.step != 0:
            raise AssertionError(f"a fresh directory restored {trainer.step}")
        out["world"] = {
            "backend": dist.get_backend(), "processes":
                dist.get_world_size(), "mesh": dict(zip(
                    trainer.mesh.mesh_dim_names, trainer.mesh.shape)),
            "zero1_active": trainer.train.zero1,
            "overlap_active": trainer.train.overlap,
            "data_ranks": trainer.train.dp,
            "int8_wire": trainer.train.wire is not None}
        if (trainer.train.zero1 or trainer.train.overlap
                or trainer.train.wire is not None or trainer.train.dp != 1):
            raise AssertionError(f"data-parallel options active at world "
                                 f"1: {out['world']}")

        # -- instrumentation: none of it reads the device inside a step ----
        step_log = []     # (step, per-step launch deltas)
        placed_log = []   # clones of what each step was handed
        starts = []       # a CUDA event at the start of each step
        # The loop's timeline: (label, step, host time, CUDA event) at each
        # step's start and end of dispatch, around the digest, the metrics
        # flush, the eval and the save.  Read after the fit against one
        # calibration event: where the device reaches a mark about when
        # the host recorded it, the device had run out of work there.
        timeline = []
        train_step = trainer.train_step

        def mark(label):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            timeline.append((label, trainer.step, time.perf_counter(), ev))
            return ev

        # The host beside the device: every collection of Python's garbage
        # collector while the loop runs (start, seconds, generation, step).
        main_tid = threading.get_native_id()
        gc_log, gc_open = [], {}

        def on_gc(phase, info):
            if phase == "start":
                gc_open["t"] = time.perf_counter()
            elif "t" in gc_open:
                t = gc_open.pop("t")
                gc_log.append((t, time.perf_counter() - t,
                               info["generation"], trainer.step))

        def checked_step(batch):
            placed_log.append({k: batch[k].clone()
                               for k in ("inputs", "targets")})
            starts.append(mark("step"))
            before = _counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                metrics = train_step(batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            mark("dispatched")
            after = _counts()
            step_log.append((trainer.step,
                             {k: after[k] - before[k] for k in after}))
            return metrics

        def marked(label, fn):
            def run(*args, **kwargs):
                mark(label)
                try:
                    return fn(*args, **kwargs)
                finally:
                    mark(label + "_done")
            return run

        sdc_check, flush_metrics = trainer._sdc_check, trainer._flush_metrics
        trainer._sdc_check = marked("digest", sdc_check)
        trainer._flush_metrics = marked("flush", flush_metrics)

        def nonzero(launched):
            return {k: v for k, v in launched.items() if v}

        trainer.train_step = checked_step
        batch_stream = trainer._batch_stream

        def checked_stream(loader):
            # The prefetcher places batches N+1..N+depth and hands out N
            # inside each next(): the same sync check as the step.
            it = iter(batch_stream(loader))
            while True:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                yield batch

        trainer._batch_stream = checked_stream
        evaluate = trainer.evaluate
        eval_log = []

        def counted_eval(*args, **kwargs):
            before = _counts()
            t = time.perf_counter()
            res = evaluate(*args, **kwargs)
            after = _counts()
            eval_log.append({"step": trainer.step,
                             "seconds": time.perf_counter() - t,
                             "launches": {k: after[k] - before[k]
                                          for k in after}, **res})
            return res

        trainer.evaluate = marked("eval", counted_eval)
        save = trainer.save_checkpoint
        saves = []

        def timed_save(**kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            saved = save(**kwargs)
            saves.append({
                "step": trainer.step, "saved": saved,
                "barrier": kwargs.get("wait_for_saver", False),
                "blocking_s": time.perf_counter() - t,
                "memory_save_s": trainer._ckpt._engine.last_save_seconds
                if saved else None,
                "in_arena": trainer._ckpt._engine.latest_memory_step()
                == trainer.step})
            return saved

        trainer.save_checkpoint = marked("save", timed_save)
        losses = []
        train_loader = _RecordedLoader(_fit_loader(cfg.vocab_size, 0))
        torch.cuda.synchronize()
        calibration = torch.cuda.Event(enable_timing=True)
        calibration.record()
        torch.cuda.synchronize()
        calibration_host = time.perf_counter()
        gc_before = {"counts": gc.get_count(), "frozen": gc.get_freeze_count(),
                     "enabled": gc.isenabled()}
        names = _thread_names()
        ticks0 = _thread_cpu_ticks()

        # -- the main path, counted ----------------------------------------
        pipeline_counters().reset()
        _zero_counts()
        gc.callbacks.append(on_gc)
        t0 = time.perf_counter()
        try:
            final = trainer.fit(
                train_loader, max_steps=FIT_STEPS,
                on_step=lambda step, m: losses.append((step, m["loss"],
                                                       m["grad_norm"])),
                eval_loader=_fit_loader(cfg.vocab_size, 1))
        finally:
            gc.callbacks.remove(on_gc)
        fit_s = time.perf_counter() - t0
        ticks1 = _thread_cpu_ticks()
        counts = _counts()
        names.update(_thread_names())
        tick_s = 1.0 / os.sysconf("SC_CLK_TCK")
        busy = sorted(((ticks1[t] - ticks0.get(t, 0)) * tick_s,
                       names.get(t, str(t)), t == main_tid)
                      for t in ticks1 if ticks1[t] - ticks0.get(t, 0) > 0)
        out["host"] = {
            "cpus": len(os.sched_getaffinity(0)),
            "loadavg": os.getloadavg(),
            "threads": len(ticks1),
            "cpu_s_by_thread_over_fit": [[n, s, m] for s, n, m in
                                         reversed(busy)],
            "gc_before": gc_before,
            # [host ms on the timeline's clock, ms, generation, step]
            "gc_during_fit": [[(t - calibration_host) * 1e3, s * 1e3, g,
                               step] for t, s, g, step in gc_log],
        }
        # The longest collection once the first step started (the fit's
        # own full collection runs before it).
        first = next(host for label, _, host, _ in timeline
                     if label == "step")
        out["host"]["gc_longest_in_steps_ms"] = max(
            [s * 1e3 for t, s, _, _ in gc_log if t >= first], default=0.0)
        # What one full collection costs in this process (after the fit).
        t = time.perf_counter()
        gc.collect()
        out["host"]["full_gc_s"] = time.perf_counter() - t
        out["host"]["gc_objects"] = len(gc.get_objects())
        summary = pipeline_counters().summary()
        blocks = pipeline_counters().blocks()
        torch.cuda.synchronize()
        trainer._sdc_check, trainer._flush_metrics = sdc_check, flush_metrics
        intervals = [starts[i].elapsed_time(starts[i + 1]) / 1e3
                     for i in range(len(starts) - 1)]
        # [label, step, host ms, device ms, device ms behind the host]
        out["timeline"] = [
            [label, step, (host - calibration_host) * 1e3,
             calibration.elapsed_time(ev),
             calibration.elapsed_time(ev) - (host - calibration_host) * 1e3]
            for label, step, host, ev in timeline]
        out.update({"final_step": final, "fit_s": fit_s,
                    "losses": losses, "launches": counts,
                    "step_launches": [(s, nonzero(got))
                                      for s, got in step_log],
                    "eval": [dict(e, launches=nonzero(e["launches"]))
                             for e in eval_log],
                    "checkpoints": saves,
                    "pipeline": summary,
                    "host_blocks": [{"label": b.label, "steps": b.steps,
                                     "seconds": b.duration_s}
                                    for b in blocks]})
        if final != FIT_STEPS or [s for s, _, _ in losses] != list(
                range(1, FIT_STEPS + 1)):
            raise AssertionError(f"fit ran steps {losses}, final {final}")
        bad = [s for s, loss, g in losses
               if not (np.isfinite(loss) and np.isfinite(g))]
        if bad or trainer.numeric_monitor.anomalies:
            raise AssertionError(
                f"non-finite steps {bad}, anomalies "
                f"{[a.encode() for a in trainer.numeric_monitor.anomalies]}")
        # A step that ends with the SDC digest launches its byte-sum kernel
        # once more.
        wrong = [(s, got) for s, got in step_log if got != dict(
            per_step, digest_sums=int(s % tcfg.sdc_check_every == 0))]
        if wrong:
            raise AssertionError(f"step launches {wrong}, want {per_step} "
                                 f"(and 1 digest_sums every "
                                 f"{tcfg.sdc_check_every} steps)")
        if len(eval_log) != 1 or eval_log[0]["launches"] != per_eval:
            raise AssertionError(f"eval launches {eval_log}, want {per_eval}")
        # Saved at step 4, and the last save is step 6's: by the cadence
        # or, when the saver was still persisting step 4, by the
        # end-of-fit barrier after its wait.
        made = [s["step"] for s in saves if s["saved"]]
        skipped = [s for s in saves if not s["saved"]]
        if made[:1] != [4] or made[-1] != FIT_STEPS or not all(
                s["in_arena"] for s in saves if s["saved"]) or any(
                s["barrier"] for s in skipped):
            raise AssertionError(f"checkpoints {saves}")
        # No hidden host sync: every step ran under sync-debug "error";
        # the blocks booked are the ring's flushes and the eval fetch.
        by_label = {}
        for b in blocks:
            by_label.setdefault(b.label, []).append(b.duration_s)
        out["host_block_seconds"] = by_label
        want_blocks = {"metrics-flush": FIT_STEPS // tcfg.metrics_lag,
                       "eval-fetch": 1}
        if skipped:
            want_blocks["checkpoint-wait"] = 1
        got_blocks = {k: len(v) for k, v in by_label.items()}
        if (summary["sync_block_count"] != 0 or got_blocks != want_blocks
                or summary["host_block_count"] != sum(want_blocks.values())):
            raise AssertionError(
                f"host blocks {got_blocks} (sync {summary['sync_block_count']}"
                f"), want {want_blocks} and 0")
        # The ring's flushes: steps 1-2 after step 3's dispatch (step 3
        # left running), 3-4 at the eval's barrier, 5-6 at step 6's save.
        out["flushed_steps"] = [list(b.steps) for b in blocks
                                if b.label == "metrics-flush"]
        lagged = [step for label, step, _, _ in timeline
                  if label == "flush"]
        if out["flushed_steps"] != [[1, 2], [3, 4], [5, 6]] or (
                3 not in lagged):
            raise AssertionError(
                f"ring flushes {out['flushed_steps']} (flush marks at steps "
                f"{lagged}), want steps 1-2 after step 3, 3-4, 5-6")
        # Placed batches: bit for bit the host batches, in order.
        mismatched = []
        for i, placed in enumerate(placed_log):
            host = train_loader.host[i]
            for key in ("inputs", "targets"):
                got = placed[key].cpu().numpy()
                if got.dtype != np.int64 or not np.array_equal(
                        got, host[key].astype(np.int64)):
                    mismatched.append((i, key))
        out["placed_batches_bit_equal"] = not mismatched
        if mismatched:
            raise AssertionError(f"placed batches differ: {mismatched}")

        # Step time: device time between step starts (CUDA events); the
        # median of the intervals after steps 2, 3 and 5 (the one after
        # step 1 holds the first step's warm-up, the one after step 4 the
        # eval and the checkpoint), against the train phase's.
        quiet = [intervals[i] for i in range(1, len(intervals))
                 if (i + 1) % tcfg.eval_every != 0]
        step_s = statistics.median(quiet)
        tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / step_s
        ftok = flops_per_token(cfg, TRAIN_SEQ)
        out.update({
            "step_intervals_s": intervals, "step_s_median": step_s,
            "step_s_median_of": "device time between step starts, after "
                                "steps 2, 3 and 5 (after step 1: warm-up; "
                                "after step 4: the eval and the "
                                "checkpoint)",
            "tokens_per_s": tokens_per_s,
            "mfu": tokens_per_s * ftok / PEAK_BF16_FLOPS,
        })
        train_s = TRAIN_STEP_S.get("train")
        out["vs_train_phase"] = (step_s / train_s - 1 if train_s else
                                 "not measured (no train phase in this "
                                 "call)")
        if train_s and step_s / train_s - 1 > FIT_STEP_RTOL:
            raise AssertionError(
                f"fit step {step_s:.4f} s is more than {FIT_STEP_RTOL:.0%} "
                f"slower than the train phase's {train_s:.4f} s "
                f"(intervals {intervals})")

        # -- digests and the planted flip (outside the checked window) -----
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        t0 = time.perf_counter()
        value = state_digest.digest_state(trainer.state)
        host_s = time.perf_counter() - t0
        marks[1].record()
        d1 = int(value)
        temp_bytes = torch.cuda.max_memory_allocated() - base
        # The device's own time: the digest queued behind a sleeping
        # kernel, so the host's dispatch is done before the device starts.
        torch.cuda._sleep(DIGEST_SLEEP_CYCLES)
        queued = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        queued[0].record()
        t0 = time.perf_counter()
        state_digest.digest_state(trainer.state)
        queued_host_s = time.perf_counter() - t0
        queued[1].record()
        torch.cuda.synchronize()
        # Where the digest's host time goes: one more digest under cProfile
        # (its own overhead included; Python 3.12's cProfile also sees the
        # other threads, here the saver's), the functions by their own
        # time.
        import cProfile
        import pstats

        profile = cProfile.Profile()
        profile.enable()
        state_digest.digest_state(trainer.state)
        profile.disable()
        torch.cuda.synchronize()
        host_top = [[f"{os.path.basename(f)}:{line}:{fn}", calls,
                     own * 1e3, cum * 1e3]
                    for (f, line, fn), (_, calls, own, cum, _) in
                    pstats.Stats(profile).stats.items()]
        host_top.sort(key=lambda row: -row[2])
        state_bytes = _tree_nbytes(trainer.state.checkpoint_tree())
        leaves = [trainer.state.step] + [
            leaf for _, leaf in sh.tree_flatten_with_path(
                trainer.state.checkpoint_tree())]
        plain = _plain_digest(leaves)
        out["digest_cost"] = {
            "ms": marks[0].elapsed_time(marks[1]), "host_ms": host_s * 1e3,
            "device_ms": queued[0].elapsed_time(queued[1]),
            "device_ms_host_ms": queued_host_s * 1e3,
            # [file:line:function, calls, own ms, cumulative ms]
            "host_profile_top": host_top[:12],
            "leaves": len(leaves), "temp_bytes": temp_bytes,
            "state_bytes": state_bytes,
            "bound_ms": state_bytes / PEAK_BYTES_PER_S * 1e3,
            "row_bytes": state_digest.ROW_BYTES,
            "group_rows": state_digest.GROUP_ROWS,
            "direct_rows": state_digest.DIRECT_ROWS,
            "equals_plain_fold": d1 == plain}
        if d1 != plain:
            raise AssertionError(f"digest {d1:08x} != the plain fold of "
                                 f"per-leaf byte sums {plain:08x}")
        d2 = int(state_digest.digest_state(trainer.state))
        pending = [(s, int(v)) for s, v in trainer._pending_digests]
        faults.configure("sdc.flip:error@1", seed=0)
        try:
            trainer._sdc_check()
        finally:
            faults.reset()
        flipped = int(trainer._pending_digests[-1][1])
        state_digest.flip_mantissa_bit(trainer.state)  # flip it back
        d3 = int(state_digest.digest_state(trainer.state))
        out["digest"] = {
            "repeat": [state_digest.format_digest(d) for d in (d1, d2)],
            "pending": [(s, state_digest.format_digest(v))
                        for s, v in pending],
            "after_planted_flip": state_digest.format_digest(flipped),
            "after_flip_back": state_digest.format_digest(d3),
            "flip_caught": flipped != d1}
        if not (d1 == d2 == d3 and pending and pending[-1] ==
                (FIT_STEPS, d1) and flipped != d1):
            raise AssertionError(f"digest checks failed: {out['digest']}")
        if on_measured is not None:
            on_measured()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.close()
        out["close_wait_s"] = time.perf_counter() - t0
        out["committed_step"] = CheckpointDirLayout(ckpt_dir).latest_step(
            PosixDiskStorage())
        if out["committed_step"] != FIT_STEPS:
            raise AssertionError(
                f"storage committed step {out['committed_step']}")

        # -- restore on a new trainer ----------------------------------------
        old = trainer
        del trainer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ``measure`` (b): the resumed trainer runs with both planes on
        # (the gate's fit above keeps them off).
        planes = dataclasses.replace(
            tcfg, profile_every=MEASURE_PROFILE_EVERY, memory_report=True)
        with _captured_log(r"from shm|resumed from") as restore_log:
            resumed = ElasticTrainer(cfg, planes,
                                     parallel=ParallelConfig(data=-1),
                                     device="cuda")
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t0
        out["restored_from"] = ("shm" if any("from shm" in m for m in
                                             restore_log) else "storage")
        differ = _trees_bit_equal(resumed.state.checkpoint_tree(),
                                  old.state.checkpoint_tree())
        extra = resumed._ckpt.last_extra
        out["restore"] = {"step": resumed.step, "leaves_differing": differ[:8],
                          "grad_accum_ref": extra.get("grad_accum_ref")}
        del old
        torch.cuda.empty_cache()
        if (resumed.step != FIT_STEPS or differ or extra.get(
                "grad_accum_ref") != {"accum": 1, "world": 1}):
            raise AssertionError(f"restore: {out['restore']}")
        more = []
        _zero_counts()
        with _planes_recorded(resumed, scratch) as planes_seen:
            resumed.fit(_fit_loader(cfg.vocab_size, 0),
                        max_steps=FIT_MORE_STEPS,
                        on_step=lambda step, m: more.append((step,
                                                             m["loss"])))
        more_counts = _counts()
        MEASURE["b"] = _fit_planes_check(resumed, planes_seen)
        MEASURE["c"] = _oom_check(resumed, scratch, MEASURE["b"])
        resumed.close()
        out["resumed_losses"] = more
        if [s for s, _ in more] != list(range(FIT_STEPS + 1,
                                              FIT_MORE_STEPS + 1)) or not all(
                np.isfinite(loss) for _, loss in more):
            raise AssertionError(f"resumed fit: {more}")
        counts = {k: counts[k] + more_counts[k] for k in counts}
        del resumed
        torch.cuda.empty_cache()
        out["launches"] = counts
    finally:
        emit(out)
        dist.destroy_process_group()
        if os.path.exists(arena):
            os.unlink(arena)
        shutil.rmtree(sock_dir, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(scratch, ignore_errors=True)
    return counts


@contextlib.contextmanager
def _planes_recorded(trainer, scratch):
    """``measure`` (b): around the resumed fit, the telemetry recorder on,
    the agent's metrics file set, and the profiler window's own host time
    (arm and finish) taken."""
    from dlrover_tpu_torch.common import telemetry
    from dlrover_tpu_torch.utils.profiler import pipeline_counters

    rec = telemetry.recorder()
    was = rec.enabled
    rec.configure(enabled=True)
    rec.drain()
    metrics_file = os.path.join(scratch, "device_metrics.json")
    saved = os.environ.get("DLROVER_TPU_METRICS_FILE")
    os.environ["DLROVER_TPU_METRICS_FILE"] = metrics_file
    prof = trainer._device_profiler
    seen = {"window_host_s": 0.0, "metrics_file": metrics_file,
            "syncs_before": len(pipeline_counters().blocks("profile-sync"))}

    def timed(fn):
        def run(*args):
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                seen["window_host_s"] += time.perf_counter() - t
        return run

    prof.arm, prof.finish = timed(prof.arm), timed(prof.finish)
    t0 = time.perf_counter()
    try:
        yield seen
    finally:
        seen["fit_s"] = time.perf_counter() - t0
        seen["events"] = rec.drain()
        rec.configure(enabled=was)
        if saved is None:
            os.environ.pop("DLROVER_TPU_METRICS_FILE", None)
        else:
            os.environ["DLROVER_TPU_METRICS_FILE"] = saved


def _fit_planes_check(trainer, seen):
    """``measure`` (b): one window at the last step, its measured rows and
    calibration event, its ``profile-sync`` block, a memory event whose
    pools are the state's own bytes, and the agent's metrics file."""
    from dlrover_tpu_torch.utils.profiler import pipeline_counters

    step = FIT_MORE_STEPS
    events = seen["events"]
    prof = trainer._device_profiler
    measured = [(e[0], e[4]["step"], e[3]) for e in events
                if e[4].get("source") == "measured"]
    calib = [e[4] for e in events if e[0] == "calibration"]
    memory = [e[4] for e in events if e[0] == "memory"]
    syncs = [(b.steps, b.duration_s) for b in
             pipeline_counters().blocks("profile-sync")[seen["syncs_before"]:]]
    params_b = _state_bytes(trainer.state.params())
    opt_b = _state_bytes(trainer.state.opt_state)
    with open(seen["metrics_file"]) as f:
        metrics = json.load(f)
    mem = memory[-1] if memory else {}
    out = {
        "windows": prof.windows, "failed_windows": prof.failed_windows,
        "measured_rows": measured, "calibration": calib,
        "profile_sync": syncs, "memory_events": len(memory),
        "memory": {k: mem.get(k) for k in (
            "step", "bytes_in_use", "peak_bytes", "limit_bytes",
            "reserved_bytes", "headroom_frac", "source", "pool_params_b",
            "pool_opt_state_b", "pool_prefetch_b", "pool_kv_pool_b",
            "pool_embed_cache_b", "pool_other_b")},
        "state_params_b": params_b, "state_opt_state_b": opt_b,
        "metrics_file": metrics, "fit_s": seen["fit_s"],
        "window_host_s": seen["window_host_s"]}
    ok = (prof.windows == 1 and prof.failed_windows == 0
          and measured and all(s == step for _, s, _ in measured)
          and [c["step"] for c in calib] == [step]
          and [st for st, _ in syncs] == [(step,)]
          and mem.get("step") == step and mem.get("source") == "allocator"
          and mem.get("pool_params_b") == params_b
          and mem.get("pool_opt_state_b") == opt_b
          and mem.get("bytes_in_use", 0) >= params_b + opt_b
          and metrics.get("device_mem_gb", 0.0) > 0.0)
    if not ok:
        raise AssertionError(f"measure (b): fit with both planes: {out}")
    return out


def _oom_check(trainer, scratch, planes):
    """``measure`` (c): a tensor larger than the card, while the resumed
    trainer's state is registered: the allocator's own
    ``torch.OutOfMemoryError``, and its postmortem's pools against (b)'s
    memory event."""
    from dlrover_tpu_torch.utils import memory_profile

    _, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    try:
        torch.empty(total + (1 << 30), dtype=torch.uint8, device="cuda")
    except torch.OutOfMemoryError as e:
        error = e
    else:
        raise AssertionError("measure (c): a tensor larger than the card "
                             "was allocated")
    path = memory_profile.dump_oom_postmortem(
        os.path.join(scratch, "oom"), error=error)
    seconds = time.perf_counter() - t0
    with open(path) as f:
        report = json.load(f)
    out = {"is_oom_error": memory_profile.is_oom_error(error),
           "error": report["error"][:160], "pools_b": report["pools_b"],
           "unclassified_live_b": report["unclassified_live_b"],
           "device": report["device"], "rows_total": report["rows_total"],
           "top": report["top"][:3], "seconds": seconds}
    mem = planes["memory"]
    if not (out["is_oom_error"]
            and report["pools_b"]["params"] == mem["pool_params_b"]
            and report["pools_b"]["opt_state"] == mem["pool_opt_state_b"]):
        raise AssertionError(f"measure (c): the OOM postmortem: {out}")
    return out


# -- the data-parallel world ----------------------------------------------------

#: ``train_dp2``: GPT-2 1.5B at full width (d_model 1600, 25 heads of 64,
#: vocab 50304, bf16) with its depth cut to this many layers so that two
#: processes on one card run every case within the script's time (it
#: was 4; on an H100 at 700 W the workers took 112.9 s at 4 and 102.6 s
#: at 2 on one slow host, 64.9-65.9 s at 2 on faster ones, and the whole
#: script 542.4 s at 4 against 524.3 s at 2 there: the bounds are per
#: leaf and step, so depth enters none of them).
DP2_LAYERS = 2
DP2_STEPS = 3
#: The runs, each for Adafactor (clip 1.0) and q8_adam (clip 1.0), lr 1e-4.
DP2_OPTIMIZERS = ("adafactor", "q8_adam")
DP2_MODES = (
    ("replicated", {}),
    ("zero1", dict(zero1=True)),
    ("zero1_overlap_accum2", dict(zero1=True, overlap=True, grad_accum=2)),
    ("zero1_int8", dict(zero1=True, overlap=True, reduce_quant="int8",
                        allgather_quant="int8")),
)
# Each run against the world-1 run of the same model, batch and seed in
# one process, both in bf16 parameters.
# fp (reassociation): the world-1 step takes each weight gradient from
# one product over 16 rows, the world-2 step from two products over 8
# rows, each rounded to bf16 and summed on the wire in bf16, so gradient
# elements differ by about an ulp (2^-8 relative).  Adafactor and Adam
# normalise the update, so an update moves by about that share of
# itself, and at lr 1e-4 an update is at or below a bf16 weight's own
# ulp: a weight differs only where its rounding sat on a boundary, by one
# ulp.  Limits: loss 5e-4 (CE sums over 16,384 tokens in another order;
# the sound runs read at most 1.6e-4, and Adafactor's reference moves
# 2.3e-3 in three steps), grad norm 5e-3 relative, every
# leaf drawn at init within ``DP2_FP_PARAM_RTOL`` of its norm: for
# Adafactor 3e-5 (the sound runs read 8.9e-6; its update, scaled by the
# parameter's RMS, moves a leaf by about 1e-4 of its norm a step), for
# q8_adam 1e-3 (sound 7.4e-4 to 8.9e-4; Adam moves a weight drawn at std
# 0.02 by about lr / 0.02 = 5e-3 of itself a step).  So a run that
# leaves the parameters unchanged fails, and the phase shows it: the
# reference's own parameters at init, checked as a run's, must fail.  A
# leaf that starts at zero (the biases) is all update after three steps,
# and where its gradient is at the level of rounding noise a normalised
# update takes either sign: such a leaf within 0.25 of its norm (the key
# slice of the fused qkv bias, whose gradient is zero in exact
# arithmetic, is left out, ``_leaf_errors``).
DP2_FP_LOSS_ATOL, DP2_FP_NORM_RTOL = 5e-4, 5e-3
DP2_FP_PARAM_RTOL = {"adafactor": 3e-5, "q8_adam": 1e-3}
DP2_FP_ZERO_INIT_RTOL = 0.25
# int8 (block quantization): the all-gather quantizes each updated
# parameter shard in blocks of 256, a step of max|p| / 127 a block, and
# rounds every value to it.  An update smaller than half a step is
# rounded away (Adam at lr 1e-4 moves a weight by about 1e-4, half a step
# is about 3e-4 for weights drawn at std 0.02), so the run may keep as
# little as none of the reference's updates; and where a gradient sits
# at the level of the reduce-scatter's rounding, a normalised update may
# take the other sign.  Limits after the last step, each leaf:
#
#   max|p - p_ref| <= U + P + steps * B / 254 + 2^-7 B
#
# U is the reference's largest total update of the leaf (no value of
# p_ref is further than U from the init); P bounds how far any value of
# the run travels from the init; the rounding terms are the all-gather's
# half block step a step and a bf16 ulp, of B, the largest value either
# run can hold (max|p_ref|, or max|init| + P).  P is U where nothing
# better is known (a factored Adafactor leaf, Adam), which is the first
# derivation's 2U.  That derivation took each run's travel to be at most
# the reference's net displacement U, and a zero-init leaf broke it: at 4
# layers ``blocks.0.ln_attn.bias`` read 1.019 of 2U + rounding on an
# H100 (PERF.md has the run).  The term it lacked: an Adafactor update of an unfactored leaf
# (1-D, or no two dimensions of 128; optax's rule) is ``g_t / sqrt(v_t)``
# with ``v_t = beta_t v_{t-1} + (1 - beta_t) (g_t^2 + eps)`` and
# ``beta_t = 1 - t^-0.8``, so ``|g_t| / sqrt(v_t) <= (1 - beta_t)^-1/2 =
# t^0.4``, with equality where the earlier gradients were small next to
# g_t; the block-rms clip only shrinks it, then it is scaled by lr and by
# max(rms(p_{t-1}), 1e-3).  So each value travels at most
#
#   P = lr * sum_t max(rms(p_ref,t-1), 1e-3) * t^0.4
#
# (1 + 1.32 + 1.55 = 3.87 lr-sized steps at 3 steps, rms at its 1e-3
# floor for a leaf that starts at zero), while the reference's value that
# moved most, its gradient about steady, travels about 3 such steps.  An
# int8 run's gradient at the rounding level (rounded to zero on one step,
# or of changing sign) takes the longer path, in the port and in the
# reference's ``build_sharded_train`` alike: on the CPU, both move some
# zero-init value further than the fp run's U, and none further than P
# (``tests/test_torch_zero1.py::test_int8_zero_init_leaves_travel_alike_
# within_the_path_bound``).  The run's rms differs from the reference's
# by far less than a part in 10^3.  A planted run whose updates are four
# times the reference's (3U from it) must fail this bound.
#
# The loss within |ref_t - ref_0| + 0.05 and the grad norm within
# |g_t - g_0| + 5% of the reference's, the distance the reference itself
# moved plus the rounding's own effect.
# Those limits pass a run that drops its updates, so step 1 is held
# closer: each rank's shards of every split leaf drawn at init, against
# the reference's step-1 parameters put through the same block
# quantize/dequantize (``_wire_roundtrip``).  Where the reference's
# update moved a value into another quantization bin, a run that dropped
# the update sits in the old bin; a sound run differs from the
# reference's rounded value only where its own update differs, by the
# gradient's int8 rounding (about 1% of an update).  Limit: the values
# in another bin than the reference's rounded ones (more than half a
# block step away) at most ``DP2_INT8_STEP1_SHARE`` (0.25) of those the
# dropped update leaves in another bin (the reference's init rounded the
# same way; there must be some).  A bound on each value's distance alone
# would not do: a dropped update smaller than a step is within a step
# too.  The largest distance, in block steps, is printed.
DP2_INT8_LOSS_ATOL, DP2_INT8_NORM_RTOL = 0.05, 0.05
DP2_INT8_STEP1_SHARE = 0.25
#: The resize run: 2 steps at world 2, ``apply_world_change(1)``, 1 step,
#: ``apply_world_change(2)``, 1 step, against 4 unresized steps: the run
#: ``DP2_UNRESIZED`` (the re-layout's own config: Adafactor, ZeRO-1, the
#: same batch and seed) carried on after its checks to 4 steps.
DP2_RESIZE_STEPS = (2, 1, 1)
DP2_UNRESIZED = ("adafactor", "zero1")


#: The local-SGD job of ``train_dp2``'s two processes: each trains its own
#: world-1 replica (``single_device_mesh()``) of GPT-2 1.5B's width at
#: ``LSGD_LAYERS`` layers, fp32 parameters (the deltas travel in fp32),
#: Adafactor, on its own batch of ``TRAIN_BATCH // 2`` rows, with an outer
#: sync every ``LSGD_SYNC_EVERY`` steps on the world's wire: plain average
#: with outer momentum on the fp transport, GTA on the int8 one (K5a a
#: leaf, K5b a leaf and process).  Each sync is held against the
#: reduction computed in the parent process from both ranks' dumped
#: deltas, bit for bit (the int8 one through the plain quantize and
#: dequantize; each rank also holds its K5a codes to the plain ones, at
#: most ``LSGD_CODE_LEVELS`` off).  Planted: rank 1 sends its anchor in
#: place of its delta; the check must fail.
LSGD_LAYERS = 1
LSGD_SYNC_EVERY = 2
LSGD_STEPS = 4
LSGD_CODE_LEVELS = 1
LSGD_RUNS = (
    ("average_fp", dict(method="average", outer_momentum=0.9)),
    ("gta_int8", dict(method="gta", outer_momentum=0.0,
                      quantized_comm=True)),
    ("planted_anchor", dict(method="average", outer_momentum=0.9)),
)


def _lsgd_config():
    return dataclasses.replace(_dp2_config(LSGD_LAYERS),
                               param_dtype=torch.float32)


def _lsgd_rank(rank, out_dir):
    """The local-SGD job of one rank: per run and sync, its delta (dumped
    to ``out_dir``), the digest of its parameters after the sync, the
    sync's wire bytes and K5a/K5b launches."""
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.parallel import local_sgd as ls
    from dlrover_tpu_torch.parallel import quantized_collectives as qc
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.runtime.mesh import single_device_mesh
    from dlrover_tpu_torch.trainer import state_digest, train_lib

    cfg = _lsgd_config()
    mesh = single_device_mesh()
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH // 2, seq_len=TRAIN_SEQ, mesh=mesh,
        device="cuda")
    rng = np.random.default_rng(100 + rank)
    tokens = rng.integers(0, cfg.vocab_size,
                          size=(TRAIN_BATCH // 2, TRAIN_SEQ + 1))
    batch = {"inputs": torch.as_tensor(tokens[:, :-1], device="cuda"),
             "targets": torch.as_tensor(tokens[:, 1:], device="cuda")}
    world = wire_lib.Wire()
    codes = {"max_levels": 0, "scales_equal": True, "leaves": 0}
    block_quant = qc._block_quant

    def held(x, block):
        q, s = block_quant(x, block)
        qr, sr = tq.quantize_reference(x)
        codes["max_levels"] = max(codes["max_levels"], int(
            (q.int() - qr.reshape(-1).int()).abs().max()))
        codes["scales_equal"] &= bool(torch.equal(s, sr))
        codes["leaves"] += 1
        return q, s

    out = {"runs": {}, "world_of_train": train.dp}
    for name, kw in LSGD_RUNS:
        state = train.init(seed=0)
        model = state.model
        planted = name.startswith("planted")
        outer = None

        def send_anchor(delta):
            return qc.process_allgather(
                outer._anchor if rank == 1 else delta, world)

        outer = ls.LocalSGD(ls.LocalSGDConfig(sync_every=LSGD_SYNC_EVERY,
                                              **kw),
                            allgather_fn=send_anchor if planted else None)
        outer.init(dict(model.named_parameters()))
        steps, syncs = [], []
        for step in range(2 if planted else LSGD_STEPS):
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train.step(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            steps.append({"loss": loss, "s": time.perf_counter() - t0,
                          "launches": {k: v for k, v in _counts().items()
                                       if v}})
            params = {k: p.detach() for k, p in model.named_parameters()}
            if (step + 1) % LSGD_SYNC_EVERY:
                outer.maybe_sync(params)
                continue
            delta = {k: (p - outer._anchor[k]).cpu() for k, p in
                     params.items()}
            torch.save(delta, os.path.join(
                out_dir, f"lsgd_{name}_{len(syncs)}_r{rank}.pt"))
            del delta
            _zero_counts()
            wire_lib.reset_counts()
            qc._block_quant = held
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                new, synced = outer.maybe_sync(params)
            finally:
                qc._block_quant = block_quant
            torch.cuda.synchronize()
            sync_s = time.perf_counter() - t0
            assert synced
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(new[k])
            launched = {k: v for k, v in _counts().items() if v}
            digest = int(state_digest.digest_leaves(
                [p.detach() for _, p in model.named_parameters()]))
            syncs.append({"digest": digest, "sync_s": sync_s,
                          "launches": launched,
                          "wire_bytes": dict(wire_lib.COUNTS["bytes"])})
            del new
        out["runs"][name] = {"steps": steps, "syncs": syncs}
        out["names"] = list(params)
        del state, model, outer, params
        torch.cuda.empty_cache()
    out["codes"] = codes
    return out


def _lsgd_check(results, out_dir):
    """The parent's reduction from both ranks' dumped deltas, sync by
    sync, against both ranks' parameters (digests), and the counts."""
    from dlrover_tpu_torch.models.transformer import init_params, param_shapes
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.parallel import local_sgd as ls
    from dlrover_tpu_torch.parallel import quantized_collectives as qc
    from dlrover_tpu_torch.trainer import state_digest

    cfg = _lsgd_config()
    names = results[0]["names"]
    shapes = param_shapes(cfg)
    numels = [int(np.prod(shapes[k])) for k in names]
    step_launches = _per_step(flash_fwd=LSGD_LAYERS,
                              flash_bwd_fused=LSGD_LAYERS)
    step_launches = {k: v for k, v in step_launches.items() if v}

    def plain_int8(delta):
        out = {}
        for k, d in delta.items():
            flat = d.reshape(-1)
            padded = -(-flat.numel() // tq.BLOCK) * tq.BLOCK
            q, s = tq.quantize_reference(F.pad(flat, (0, padded
                                                      - flat.numel())))
            out[k] = tq.dequantize_reference(q, s, (padded,))[
                :flat.numel()].reshape(d.shape)
        return out

    report, bad = {}, []
    for name, kw in LSGD_RUNS:
        anchor = init_params(cfg, seed=0, device="cuda")
        anchor = {k: anchor[k] for k in names}
        velocity = None
        rows = []
        syncs = [r["runs"][name]["syncs"] for r in results]
        for i in range(len(syncs[0])):
            deltas = [{k: v.to("cuda") for k, v in torch.load(os.path.join(
                out_dir, f"lsgd_{name}_{i}_r{r}.pt")).items()}
                for r in range(2)]
            if kw.get("quantized_comm"):
                deltas = [plain_int8(d) for d in deltas]
            reduced = (ls.gta_reduce(deltas) if kw["method"] == "gta"
                       else ls.average_reduce(deltas))
            if kw["outer_momentum"]:
                if velocity is None:
                    velocity = {k: torch.zeros_like(d)
                                for k, d in reduced.items()}
                velocity = {k: kw["outer_momentum"] * velocity[k] + d
                            for k, d in reduced.items()}
                applied = velocity
            else:
                applied = reduced
            anchor = {k: a + 1.0 * applied[k] for k, a in anchor.items()}
            want = int(state_digest.digest_leaves([anchor[k]
                                                   for k in names]))
            got = [s[i]["digest"] for s in syncs]
            quant = "int8" if kw.get("quantized_comm") else "none"
            leaves = len(names)
            launches_ok = all(
                s[i]["launches"] == ({"quantize": leaves,
                                      "dequantize": 2 * leaves}
                                     if quant == "int8" else {})
                for s in syncs)
            bytes_ok = all(s[i]["wire_bytes"] == {
                "all_gather": qc.process_allgather_bytes(numels, quant)}
                for s in syncs)
            rows.append({"ranks_equal": got[0] == got[1],
                         "equals_reduction": got[0] == want == got[1],
                         "launches": syncs[0][i]["launches"],
                         "launches_ok": launches_ok,
                         "wire_bytes": syncs[0][i]["wire_bytes"],
                         "bytes_ok": bytes_ok,
                         "sync_s": [s[i]["sync_s"] for s in syncs]})
            del deltas, reduced
        steps = results[0]["runs"][name]["steps"]
        ok = (all(r["ranks_equal"] and r["equals_reduction"]
                  and r["launches_ok"] and r["bytes_ok"] for r in rows)
              and all(s["launches"] == step_launches for r in results
                      for s in r["runs"][name]["steps"]))
        report[name] = {"syncs": rows, "ok": ok,
                        "losses": [[s["loss"] for s in r["runs"][name]
                                    ["steps"]] for r in results],
                        "step_s": [s["s"] for s in steps]}
        if name.startswith("planted"):
            report[name]["fails"] = not ok
            if ok:
                bad.append(name)
        elif not ok or len(rows) < 2:
            bad.append(name)
        torch.cuda.empty_cache()
    codes = [r["codes"] for r in results]
    report["k5a_codes"] = codes
    if not all(c["max_levels"] <= LSGD_CODE_LEVELS and c["scales_equal"]
               and c["leaves"] > 0 for c in codes):
        bad.append("k5a_codes")
    return report, bad


#: The script's world of two: two processes on ``cuda:0`` joined in one
#: gloo group (``tcp://127.0.0.1``), started by the first phase that needs
#: it and kept for the others (``train_dp2``, ``train_mp2``,
#: ``train_ep2``), so their spawns, imports, CUDA contexts and first
#: kernel loads are paid once (PR 17; each phase spawned its own until
#: then).  A phase hands both ranks a task, the name of its rank function;
#: each rank writes its result (or its traceback) to the task's file.
_WORLD = {}
#: What a phase keeps for a later one: ``train_sp2``'s first world-1 run
#: (``sp2_world1``), ``train_ring2``'s flash twin.
_SHARED = {}
#: The environment a task carries to the ranks (the job tag and socket
#: directory of its Flash Checkpoint saves).
_WORLD_ENV = ("DLROVER_TPU_JOB", "DLROVER_TPU_SOCKET_DIR")


def _world_main(rank, port, tasks, done):
    import traceback

    import torch.distributed as dist

    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, out_dir, result_file, env = task
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        path = os.path.join(out_dir, result_file.format(rank=rank))
        try:
            result = globals()[fn](rank, out_dir)
        except BaseException:  # noqa: BLE001 - reported, then the rank ends
            torch.save({"error": traceback.format_exc()}, path)
            done.put((rank, False))
            raise
        torch.save(result, path)
        del result
        torch.cuda.empty_cache()
        dist.barrier()
        done.put((rank, True))
    dist.barrier()
    dist.destroy_process_group()


def _world_submit(fn, out_dir, result_file):
    """Hands both ranks ``fn(rank, out_dir)`` (spawning the world when it
    is not running); :func:`_world_collect` waits for it."""
    import multiprocessing

    if not _WORLD:
        ctx = multiprocessing.get_context("spawn")
        tasks = [ctx.Queue() for _ in range(2)]
        done = ctx.Queue()
        port = _free_port()
        procs = [ctx.Process(target=_world_main,
                             args=(r, port, tasks[r], done))
                 for r in range(2)]
        for p in procs:
            p.start()
        _WORLD.update(procs=procs, tasks=tasks, done=done)
    env = {k: os.environ.get(k) for k in _WORLD_ENV}
    for q in _WORLD["tasks"]:
        q.put((fn, out_dir, result_file, env))


def _world_run(fn, out_dir, result_file, timeout):
    """Both ranks of the world run ``fn(rank, out_dir)``; their results
    (``{"error": ...}`` for a rank that failed or gave none) and exit
    codes (None while a rank lives)."""
    _world_submit(fn, out_dir, result_file)
    return _world_collect(out_dir, result_file, timeout)


def _world_collect(out_dir, result_file, timeout):
    """The results and exit codes of the task handed to the ranks last
    (the world is stopped when a rank failed or timed out)."""
    import queue

    finished, deadline = {}, time.perf_counter() + timeout
    while len(finished) < 2:
        try:
            rank, ok = _WORLD["done"].get(timeout=5.0)
            finished[rank] = ok
        except queue.Empty:
            if time.perf_counter() > deadline or any(
                    not p.is_alive() for p in _WORLD["procs"]):
                break
        if not all(finished.values()):
            break
    paths = [os.path.join(out_dir, result_file.format(rank=r))
             for r in range(2)]
    results = [torch.load(p, weights_only=False) if os.path.exists(p)
               and r in finished else {"error": "no result"}
               for r, p in enumerate(paths)]
    codes = [p.exitcode for p in _WORLD["procs"]]
    if len(finished) < 2 or not all(finished.values()):
        _world_stop()
    return results, codes


#: Where the world's warm-up task writes (``world_warm_start``).
WORLD_WARM_DIR = os.path.join(REPO, "build", "world_warm")


def _warm_rank(rank, out_dir):
    """The world's warm-up: two replicated Adafactor steps of GPT-2 1.5B's
    width at one layer on the data axis of both ranks, so that a fresh
    process's first CUDA, cuBLAS, kernel-library and gloo calls are paid
    before ``train_dp2`` times its steps (its first step took 10.9-12.1 s
    against 1.1 s for the next without it; my chip runs, PR 17)."""
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_lib

    t0 = time.perf_counter()
    cfg = _dp2_config(1)
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
        mesh=build_mesh(ParallelConfig(data=-1), device_type="cuda"),
        device="cuda")
    state = train.init(seed=0)
    placed = train_lib.shard_batch(_train_batch(cfg.vocab_size,
                                                TRAIN_BATCH), train)
    steps = []
    for _ in range(2):
        t = time.perf_counter()
        state, m = train.step(state, placed)
        steps.append({"loss": float(m["loss"]),
                      "s": time.perf_counter() - t})
    del train, state, placed
    return {"s": time.perf_counter() - t0, "steps": steps}


def world_warm_start():
    """Spawns the world and hands it the warm-up (``_warm_rank``); the
    first phase of the world reads it with :func:`_world_warm_result`."""
    import shutil

    shutil.rmtree(WORLD_WARM_DIR, ignore_errors=True)
    os.makedirs(WORLD_WARM_DIR)
    _world_submit("_warm_rank", WORLD_WARM_DIR, "warm{rank}.pt")
    _WORLD["warm"] = time.perf_counter()


def _world_warm_result():
    """The warm-up's results (None when no warm-up is pending); raises if
    a rank failed it."""
    import shutil

    t0 = _WORLD.pop("warm", None)
    if t0 is None:
        return None
    results, codes = _world_collect(WORLD_WARM_DIR, "warm{rank}.pt", 600)
    shutil.rmtree(WORLD_WARM_DIR, ignore_errors=True)
    errors = [r.get("error") for r in results if "error" in r]
    if errors or codes != [None, None]:
        raise AssertionError(f"the world's warm-up failed (exit codes "
                             f"{codes}): {errors}")
    return {"ranks": results, "waited_from_start_s": time.perf_counter() - t0}


def _world_stop():
    """Ends the world's ranks (a rank stuck in a collective is killed)."""
    if not _WORLD:
        return
    for q in _WORLD["tasks"]:
        q.put(None)
    for p in _WORLD["procs"]:
        p.join(timeout=60)
    for p in _WORLD["procs"]:
        if p.is_alive():
            p.kill()
            p.join()
    _WORLD.clear()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp2_config(layers=DP2_LAYERS):
    from dlrover_tpu_torch.models import gpt2_config

    return gpt2_config("1.5b", num_layers=layers, attention_impl="flash",
                       remat="flash_only", param_dtype=torch.bfloat16)


def _leaf_errors(got, want, init, head_dim=64):
    """Per leaf: the norm-relative error ``|got - want| / |want|``, the
    largest difference, the reference's largest total update ``U`` and
    largest value ``A``, whether the leaf started at zero, the
    reference's update relative to its norm and the init's largest
    value.  The key
    slice of the fused qkv bias is left out: its gradient is exactly zero
    in exact arithmetic (a shift of every key leaves the softmax
    unchanged), so each run updates it from rounding noise that the
    optimizer's normalisation amplifies (``tests/test_torch_train.py``
    leaves it out for the same reason).  Computed on the card (on the
    host it held rank 0, and so both ranks, about a second a run)."""
    out = {}
    for name, w in want.items():
        w32, g32, i32 = (t[name].to("cuda", torch.float32)
                         for t in (want, got, init))
        if name.endswith("attn.qkv.bias"):
            keep = torch.ones(w32.shape, dtype=torch.bool, device="cuda")
            keep[..., head_dim:2 * head_dim] = False
            w32, g32, i32 = w32[keep], g32[keep], i32[keep]
        norm = w32.norm().clamp_min(1e-30)
        out[name] = (
            float((g32 - w32).norm() / norm),
            float((g32 - w32).abs().max()), float((w32 - i32).abs().max()),
            float(w32.abs().max()), bool((i32 == 0).all()),
            float((w32 - i32).norm() / norm), float(i32.abs().max()))
    return out


def _int8_bound(name, v, paths):
    """The int8 limit of one leaf's stats (see ``DP2_*``): ``U + P +
    steps * B / 254 + 2^-7 B``, ``P`` the stacked leaf's path bound where
    ``paths`` has one, else ``U``."""
    from dlrover_tpu_torch.trainer.train_lib import _block_leaf

    moved, big, init_max = v[2], v[3], v[6]
    path = max(moved, (paths or {}).get(_block_leaf(name), moved))
    b = max(big, init_max + path)
    return moved + path + DP2_STEPS * b / 254 + 2.0 ** -7 * b


def _params_ok(stats, int8, opt, paths=None):
    """The parameter limits of ``train_dp2`` (see ``DP2_*``)."""
    for name, v in stats.items():
        rel, diff, _, _, zero_init, _, _ = v
        if int8:
            if diff > _int8_bound(name, v, paths):
                return False
        elif rel > (DP2_FP_ZERO_INIT_RTOL if zero_init
                    else DP2_FP_PARAM_RTOL[opt]):
            return False
    return True


def _stacked_rms(params):
    """Each layer-stacked leaf's rms, from a per-layer state dict."""
    from dlrover_tpu_torch.trainer.train_lib import _block_leaf

    sums, counts = collections.Counter(), collections.Counter()
    for name, v in params.items():
        key = _block_leaf(name)
        sums[key] += float(v.float().square().sum())
        counts[key] += v.numel()
    return {k: (sums[k] / counts[k]) ** 0.5 for k in sums}


def _adafactor_paths(cfg, rms_per_step):
    """``P`` of each unfactored stacked leaf (see ``DP2_*``): ``lr * sum_t
    max(rms(p_{t-1}), 1e-3) * t^0.4`` from the reference's rms before each
    step."""
    from dlrover_tpu_torch.optimizers.optax_ports import _factored_dims
    from dlrover_tpu_torch.trainer import train_lib

    out = {}
    for name, shape in train_lib._stacked_shapes(cfg).items():
        if _factored_dims(shape, True, 128) is not None:
            continue
        out[name] = TRAIN_LR * sum(
            max(rms[name], 1e-3) * t ** 0.4
            for t, rms in enumerate(rms_per_step, start=1))
    return out


def _wire_roundtrip(x, dim):
    """``x`` as the int8 all-gather re-replicates it (``parallel/
    quantized_collectives.quantized_all_gather``): moved to ``dim`` 0,
    flattened, block-quantized and dequantized by the plain versions of
    K5a/K5b, in ``x``'s dtype; and each value's block step (its scale)."""
    from dlrover_tpu_torch.ops import quantization as tq

    moved = torch.movedim(x, dim, 0)
    flat = moved.float().reshape(-1)
    q, scales = tq.quantize_reference(flat)
    values = tq.dequantize_reference(q, scales, tuple(flat.shape))
    steps = scales[:, None].expand(-1, tq.BLOCK).reshape(-1)[:flat.numel()]

    def back(t):
        return torch.movedim(t.reshape(moved.shape), 0, dim)

    return back(values).to(x.dtype), back(steps)


def _int8_step1(train, state, ref1, init, rank):
    """The int8 run's step 1 on this rank: each of its shards of a split
    leaf drawn at init against the reference's step-1 parameters through
    ``_wire_roundtrip``; the values in another quantization bin (more
    than half a block step away), those a dropped update leaves in
    another bin (the init through the same rounding), and the largest
    distance in block steps."""
    from dlrover_tpu_torch.optimizers import optax_ports as ox
    from dlrover_tpu_torch.trainer import train_lib

    got = train_lib._param_tree(state.model)
    device = next(state.model.parameters()).device
    ref = ox.stack_layers({k: v.to(device) for k, v in ref1.items()})
    base = ox.stack_layers({k: v.to(device) for k, v in init.items()})
    differ = dropped = values = leaves = 0
    worst = 0.0
    for name, leaf in train.shards.leaves.items():
        if leaf.dim is None or not bool(base[name].any()):
            continue
        shard = leaf.take(got[name], rank)
        want, steps = _wire_roundtrip(leaf.take(ref[name], rank), leaf.dim)
        drop, _ = _wire_roundtrip(leaf.take(base[name], rank), leaf.dim)
        off = (shard.float() - want.float()).abs() / steps
        differ += int((off > 0.5).sum())
        dropped += int(((drop.float() - want.float()).abs() / steps
                        > 0.5).sum())
        worst = max(worst, float(off.max()))
        values += shard.numel()
        leaves += 1
    return {"leaves": leaves, "values": values, "differ": differ,
            "differ_if_dropped": dropped,
            "share_of_dropped": differ / dropped if dropped else None,
            "max_steps_off": worst}


def _dp2_reference(opt, out_dir):
    """The world-1 run: one process, the whole batch, no mesh."""
    from dlrover_tpu_torch.trainer import train_lib

    cfg = _dp2_config()
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer(opt, learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    losses, norms, params1, rms = [], [], None, []
    for _ in range(DP2_STEPS):
        rms.append(_stacked_rms(state.params()))
        state, m = train.step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if params1 is None:
            params1 = {k: v.cpu() for k, v in state.params().items()}
    params = {k: v.cpu() for k, v in state.params().items()}
    torch.save({"losses": losses, "grad_norms": norms, "params": params,
                "params1": params1},
               os.path.join(out_dir, f"ref_{opt}.pt"))
    del state, train, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": norms,
            "path_bound": (_adafactor_paths(cfg, rms) if opt == "adafactor"
                           else {})}


def _dp2_rank(rank, out_dir):
    import torch.distributed as dist

    from dlrover_tpu_torch.checkpoint import shm_handler as sh
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import state_digest, train_lib
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        ElasticTrainer,
        TrainerConfig,
    )
    from dlrover_tpu_torch.utils.device_profile import DeviceProfiler

    mesh = build_mesh(ParallelConfig(data=-1), device_type="cuda")
    cfg = _dp2_config()
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    out = {"rank": rank, "runs": [], "backend": dist.get_backend(),
           "torch": torch.__version__}
    captured = {}
    out["planted_unchanged"] = {}
    for opt in DP2_OPTIMIZERS:
        ref = torch.load(os.path.join(out_dir, f"ref_{opt}.pt"),
                         weights_only=False)
        for mode, kw in DP2_MODES:
            t_run = time.perf_counter()
            train = train_lib.build_train(
                cfg, train_lib.make_optimizer(opt, learning_rate=TRAIN_LR),
                global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                mesh=mesh, device="cuda", **kw)
            state = train.init(seed=0)
            if "init" not in captured:
                captured["init"] = {k: v.cpu().clone()
                                   for k, v in state.params().items()}
            if rank == 0 and opt not in out["planted_unchanged"]:
                # A run that applied no update: its parameters are the
                # init's.  The checks must fail it.
                out["planted_unchanged"][opt] = _leaf_errors(
                    captured["init"], ref["params"], captured["init"])
                # A run whose updates are four times the reference's.
                out.setdefault("planted_update_x4", {})[opt] = _leaf_errors(
                    {k: (4 * ref["params"][k].float() - 3 * v.float()).to(
                        v.dtype) for k, v in captured["init"].items()},
                    ref["params"], captured["init"])
            placed = train_lib.shard_batch(batch, train)
            quantize = tq.quantize
            if mode == "zero1_int8" and opt == DP2_OPTIMIZERS[0]:
                def first_payload(x, _q=quantize):
                    captured.setdefault("x", x.detach().clone())
                    return _q(x)
                tq.quantize = first_payload
            steps = []
            try:
                for _ in range(DP2_STEPS):
                    _zero_counts()
                    wire_lib.reset_counts()
                    dist.barrier()
                    torch.cuda.synchronize()
                    # ``measure`` (e): rank 0 captures the run's last step.
                    prof = None
                    if (rank == 0 and (opt, mode) == MEASURE_DP2
                            and len(steps) == DP2_STEPS - 1):
                        prof = DeviceProfiler(1, device=torch.device("cuda"))
                        if not prof.arm(0):
                            raise AssertionError("measure (e): the window "
                                                 "did not open")
                    t0 = time.perf_counter()
                    state, m = train.step(state, placed)
                    loss, norm = float(m["loss"]), float(m["grad_norm"])
                    torch.cuda.synchronize()
                    step_s = time.perf_counter() - t0
                    if prof is not None:
                        window = prof.finish()
                        out["wire_window"] = _wire_window(
                            window, step_s, time.perf_counter() - t0)
                    steps.append({
                        "s": step_s, "loss": loss,
                        "grad_norm": norm, "tokens": float(m["tokens"]),
                        "launches": {k: v for k, v in _counts().items()
                                     if v},
                        "wire_bytes": dict(wire_lib.COUNTS["bytes"]),
                        "staged": wire_lib.COUNTS["staged"]})
                    if mode == "zero1_int8" and len(steps) == 1:
                        step1 = _int8_step1(train, state, ref["params1"],
                                            captured["init"], rank)
            finally:
                tq.quantize = quantize
            params = state.params()
            # Replicas identical: this rank's parameter digest against the
            # other rank's.
            digest = torch.tensor([int(state_digest.digest_leaves(
                list(params.values())))], dtype=torch.int64)
            both = [torch.zeros_like(digest) for _ in range(2)]
            dist.all_gather(both, digest)
            run = {"optimizer": opt, "mode": mode, "steps": steps,
                   "step1": step1 if mode == "zero1_int8" else None,
                   "zero1": train.zero1, "overlap": train.overlap,
                   "grad_accum": train.grad_accum,
                   "replicas_equal": bool(both[0] == both[1]),
                   "zero1_stats": train.zero1_stats,
                   "overlap_plan": train.overlap_plan,
                   # Buckets the overlap engine sent from a gradient hook,
                   # before the backward ended, over the run.
                   "early_buckets": (train._issuer.early
                                     if train._issuer is not None else None)}
            if rank == 0:
                run["leaf_stats"] = _leaf_errors(params, ref["params"],
                                                 captured["init"])
            if (opt, mode) == DP2_UNRESIZED:
                # The re-layout's reference: this run (the re-layout's
                # config) carried on to its step count.
                out["unresized_losses"] = [st["loss"] for st in steps]
                t_more = time.perf_counter()
                for _ in range(sum(DP2_RESIZE_STEPS) - len(steps)):
                    state, m = train.step(state, placed)
                    out["unresized_losses"].append(float(m["loss"]))
                out["unresized_more_s"] = time.perf_counter() - t_more
            run["seconds"] = time.perf_counter() - t_run
            out["runs"].append(run)
            del state, train, placed, params
            torch.cuda.empty_cache()
    captured.pop("init", None)
    if rank == 0 and "x" in captured:
        x = captured["x"]
        before = _counts()
        q, s = tq.quantize(x)
        _restore_counts(before)
        qr, sr = tq.quantize_reference(x)
        out["k5a_payload"] = {
            "values": x.numel(), "dtype": str(x.dtype),
            "codes_equal": bool(torch.equal(q.cpu(), qr.cpu())),
            "scales_equal": bool(torch.equal(s.cpu(), sr.cpu())),
            "codes_max_diff": int((q.int() - qr.int().to(q.device)).abs()
                                  .max())}

    # -- Local SGD: each rank a world-1 replica, the outer sync on the world
    t_part = time.perf_counter()
    out["local_sgd"] = _lsgd_rank(rank, out_dir)
    torch.cuda.empty_cache()
    out["local_sgd_s"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # -- live re-layout and the sharded save --------------------------------
    ckpt_dir = os.path.join(out_dir, "ckpt")
    base = dict(global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                optimizer="adafactor", learning_rate=TRAIN_LR, zero1=True,
                report_every=1000, ckpt_every=1000)
    unresized = out.pop("unresized_losses")
    trainer = ElasticTrainer(cfg, TrainerConfig(checkpoint_dir=ckpt_dir,
                                                **base),
                             parallel=ParallelConfig(data=-1), device="cuda")
    resized, tokens, details = [], [], []
    for i, (n, world) in enumerate(zip(DP2_RESIZE_STEPS, (2, 1, 2))):
        if i:
            details.append(trainer.apply_world_change(world))
        for _ in range(n):
            m = trainer.train_step(batch)
            resized.append(float(m["loss"]))
            tokens.append(float(m["tokens"]))
    out["resize"] = {
        "unresized_losses": unresized, "resized_losses": resized,
        "loss_gap": max(abs(a - b) for a, b in zip(unresized, resized)),
        "tokens_per_step": tokens, "final_step": trainer.step,
        "details": [{k: d[k] for k in ("ok", "fallback", "old_world",
                                       "new_world", "grad_accum", "fold",
                                       "relayout_s") if k in d}
                    for d in details]}
    t0 = time.perf_counter()
    saved = trainer.save_checkpoint(wait_for_saver=True)
    out["save"] = {"saved": saved, "step": trainer.step,
                   "seconds": time.perf_counter() - t0}
    layout = trainer._layout()
    pieces = {path: leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
              else leaf for path, leaf in
              sh.tree_flatten_with_path(trainer.state.checkpoint_tree())}
    torch.save({"layout": {p: (s.global_shape, s.index, s.replica_id)
                           for p, s in layout.items()},
                "pieces": pieces},
               os.path.join(out_dir, f"pieces_r{rank}.pt"))
    t0 = time.perf_counter()
    trainer.close()
    out["save"]["close_s"] = time.perf_counter() - t0
    out["resize_and_save_s"] = time.perf_counter() - t_part
    return out


def _wire_window(window, step_s, with_parse_s):
    """``measure`` (e), in rank 0: the captured step's window beside the
    legs the wire's own counters booked for that step."""
    from dlrover_tpu_torch.parallel import wire as wire_lib

    calls = {k: v for k, v in wire_lib.COUNTS["calls"].items() if v}
    return {
        "parsed": window is not None,
        "legs": ({leg: list(v) for leg, v in window.legs.items()}
                 if window else {}),
        "compute_s": window.seconds("compute") if window else 0.0,
        "collective_s": window.seconds("collective") if window else 0.0,
        "overlap_fraction": window.overlap_fraction if window else 0.0,
        "device_total_s": window.device_total_s if window else 0.0,
        "op_count": window.op_count if window else 0,
        "wire_calls": calls,
        "wire_legs": sorted({k.split("/", 1)[1] for k in calls}),
        "step_s": step_s, "with_export_and_parse_s": with_parse_s}


def _wire_legs_check(r0):
    """``measure`` (e), in the parent: the window's collective legs are
    the legs the wire booked for the step, with collective time."""
    got = r0.get("wire_window")
    out = dict(got or {}, run=list(MEASURE_DP2),
               transport="gloo through the host (two processes on one "
                         "card): the overlap is of host ranges with the "
                         "card's kernels, not of a link")
    if not (got and got["parsed"] and got["collective_s"] > 0.0
            and sorted(got["legs"]) == got["wire_legs"]
            and got["wire_legs"]):
        raise AssertionError(f"measure (e): the wire's legs: {out}")
    print(f"measure (e): legs {got['wire_legs']}, collective "
          f"{got['collective_s'] * 1e3:.3f} ms, overlap fraction "
          f"{got['overlap_fraction']:.4f} (gloo through the host)",
          flush=True)
    return out


def _restore_counts(counts):
    for launches in _launch_dicts():
        for name in launches:
            launches[name] = counts[name]


def _assemble_pieces(dumps):
    """The whole state from the ranks' dumped pieces, by plain indexing
    (independent of the checkpoint code): each piece a rank holds as
    replica 0 lands at its index."""
    whole = {}
    for dump in dumps:
        for path, (shape, index, replica) in dump["layout"].items():
            if replica != 0:
                continue
            piece = dump["pieces"][path]
            if not isinstance(piece, torch.Tensor):
                whole[path] = piece
                continue
            if path not in whole:
                whole[path] = torch.zeros(shape, dtype=piece.dtype)
            whole[path][tuple(slice(b, e) for b, e in index)] = piece
    return whole


def train_dp2_and_check(world1_refs=False):
    """Two processes on ``cuda:0`` over a gloo group: the data-parallel
    step (replicated, ZeRO-1, the overlap engine with two microbatches,
    the int8 wires) at GPT-2 1.5B's width, each held against the world-1
    run; a live re-layout 2 -> 1 -> 2; a sharded save at world 2 and a
    restore into one process on the card.  With ``world1_refs`` the later
    world phases' world-1 references run in this process while the ranks
    do (:func:`world1_references_start`).  Returns the counted launches
    of the main-path runs (both ranks)."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.checkpoint import Checkpointer
    from dlrover_tpu_torch.checkpoint import shm_handler as sh
    from dlrover_tpu_torch.trainer import train_lib

    out_dir = os.path.join(REPO, "build", "train_dp2")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    sock_dir = tempfile.mkdtemp(prefix="dp2_socks_")
    saved_env = {k: os.environ.get(k) for k in ("DLROVER_TPU_JOB",
                                                "DLROVER_TPU_SOCKET_DIR")}
    os.environ["DLROVER_TPU_SOCKET_DIR"] = sock_dir
    job = f"dp2{os.getpid()}"
    out = {"phase": "train_dp2",
           "model": f"gpt2-1.5b width (d_model 1600, 25 heads x 64, vocab "
                    f"50304, bf16 params and compute, flash_only), depth "
                    f"cut to {DP2_LAYERS} of 48 layers, random weights "
                    f"seed 0",
           "world": "2 processes on cuda:0, gloo (collectives staged "
                    "through the host)",
           "batch": f"global {TRAIN_BATCH} x {TRAIN_SEQ}, "
                    f"{TRAIN_BATCH // 2} rows a rank, one batch re-fed",
           "steps": DP2_STEPS,
           "tolerance": {
               "fp": {"loss_atol": DP2_FP_LOSS_ATOL,
                      "grad_norm_rtol": DP2_FP_NORM_RTOL,
                      "param_rel": DP2_FP_PARAM_RTOL,
                      "zero_init_param_rel": DP2_FP_ZERO_INIT_RTOL},
               "int8": {"loss": "|ref_t - ref_0| + "
                                f"{DP2_INT8_LOSS_ATOL}",
                        "grad_norm": "|g_t - g_0| / g_t + "
                                     f"{DP2_INT8_NORM_RTOL}",
                        "param": "max|p - p_ref| <= U + P + steps * B "
                                 "/ 254 + 2^-7 B (P: Adafactor's path "
                                 "bound of an unfactored leaf, else U)",
                        "step1_share_of_dropped": DP2_INT8_STEP1_SHARE}}}
    t_start = time.perf_counter()
    try:
        out["reference"] = {opt: _dp2_reference(opt, out_dir)
                            for opt in DP2_OPTIMIZERS}
        out["reference_s"] = time.perf_counter() - t_start
        out["world_warmup"] = _world_warm_result()
        os.environ["DLROVER_TPU_JOB"] = job
        if world1_refs:
            world1_references_start()
        try:
            results, codes = _world_run("_dp2_rank", out_dir,
                                        "rank{rank}.pt", 900)
        finally:
            world1_references_join()
        errors = [r.get("error") for r in results if "error" in r]
        if errors or codes != [None, None]:
            raise AssertionError(f"train_dp2 ranks failed (exit codes "
                                 f"{codes}): {errors}")
        out["workers_s"] = time.perf_counter() - t_start
        r0, r1 = results
        out["backend"], out["worker_torch"] = r0["backend"], r0["torch"]
        out["rank_parts_s"] = {k: [r0[k], r1[k]] for k in (
            "local_sgd_s", "resize_and_save_s", "unresized_more_s")}
        MEASURE["e"] = _wire_legs_check(r0)
        cfg = _dp2_config()
        elements = sum(int(np.prod(v)) for v in
                       train_lib._stacked_shapes(cfg).values())
        out["model_elements"] = elements
        out["model_wire_bytes"] = {
            "fp_bf16_per_leg": elements * 2,
            "int8_per_phase": elements * (1 + 4 / 256)}
        runs, counts, bad = [], dict.fromkeys(_counts(), 0), []
        shapes = train_lib._stacked_shapes(cfg)
        n_leaves = len(shapes)
        n_quant = sum(int(np.prod(v)) >= 4096 for v in shapes.values())
        for a, b in zip(r0["runs"], r1["runs"]):
            int8 = a["mode"] == "zero1_int8"
            ref = out["reference"][a["optimizer"]]
            losses = [s["loss"] for s in a["steps"]]
            norms = [s["grad_norm"] for s in a["steps"]]
            gaps = [abs(x - r) for x, r in zip(losses, ref["losses"])]
            ngaps = [abs(x - r) / r for x, r in zip(norms, ref["grad_norms"])]
            if int8:
                loss_ok = all(g <= abs(r - ref["losses"][0])
                              + DP2_INT8_LOSS_ATOL
                              for g, r in zip(gaps, ref["losses"]))
                norm_ok = all(g <= abs(r - ref["grad_norms"][0]) / r
                              + DP2_INT8_NORM_RTOL
                              for g, r in zip(ngaps, ref["grad_norms"]))
            else:
                loss_ok = max(gaps) <= DP2_FP_LOSS_ATOL
                norm_ok = max(ngaps) <= DP2_FP_NORM_RTOL
            stats = a["leaf_stats"]
            drawn = {k: v for k, v in stats.items() if not v[4]}
            zero = {k: v for k, v in stats.items() if v[4]}
            step1_ok = not int8 or all(
                x["step1"]["differ_if_dropped"] > 0
                and x["step1"]["share_of_dropped"] <= DP2_INT8_STEP1_SHARE
                for x in (a, b))
            worst = {
                "drawn_rel": max(((v[0], k) for k, v in drawn.items()),
                                 default=None),
                "drawn_update_rel": min(((v[5], k)
                                         for k, v in drawn.items()
                                         if v[5] > 0), default=None),
                "zero_init_rel": max(((v[0], k) for k, v in zero.items()),
                                     default=None),
                "max_diff_over_bound": max(
                    (v[1] / _int8_bound(k, v, ref["path_bound"]), k)
                    for k, v in stats.items()),
                "max_diff_over_2u_bound": max(
                    (v[1] / (2 * v[2] + DP2_STEPS * v[3] / 254
                             + 2.0 ** -7 * v[3]), k)
                    for k, v in stats.items())}
            step = a["steps"][-1]
            per_step = {k: v for k, v in step["launches"].items()}
            accum = a["grad_accum"]
            want = {"flash_fwd": DP2_LAYERS * accum,
                    "flash_bwd_fused": DP2_LAYERS * accum}
            if a["optimizer"] == "q8_adam":
                # One K6 launch a quantized leaf, on its shard or whole.
                want["q8_adam"] = n_quant
            if int8:
                # A leaf's two int8 phases: one K5a each, and one K5b a
                # member each (its dequantized contributions).
                want["quantize"] = 2 * n_leaves
                want["dequantize"] = 2 * 2 * n_leaves
            ok = (loss_ok and norm_ok and step1_ok
                  and _params_ok(stats, int8, a["optimizer"],
                                 ref["path_bound"])
                  and a["replicas_equal"] and b["replicas_equal"]
                  and a["zero1"] == (a["mode"] != "replicated")
                  and a["overlap"] == ("overlap" in a["mode"] or int8)
                  and all(s["launches"] == per_step for s in a["steps"])
                  and all(s["tokens"] == TRAIN_BATCH * TRAIN_SEQ
                          for s in a["steps"])
                  and per_step == want)
            for x in (a, b):
                for s in x["steps"]:
                    for k, v in s["launches"].items():
                        counts[k] += v
            runs.append({
                "optimizer": a["optimizer"], "mode": a["mode"], "ok": ok,
                "losses": losses, "loss_gap": max(gaps),
                "grad_norm_rgap": max(ngaps), "worst_leaf": worst,
                "int8_step1": [a["step1"], b["step1"]] if int8 else None,
                "launches_per_step": per_step,
                "wire_bytes_per_step": step["wire_bytes"],
                "staged_copies_per_step": step["staged"],
                "step_s": [s["s"] for s in a["steps"]],
                "run_s": [a["seconds"], b["seconds"]],
                "zero1_stats": a["zero1_stats"],
                "overlap_buckets": (a["overlap_plan"] or {}).get(
                    "num_buckets"),
                "early_buckets": a["early_buckets"],
                "overlap_bucket_mb": (a["overlap_plan"] or {}).get(
                    "bucket_mb")})
            if not ok:
                bad.append(f"{a['optimizer']}/{a['mode']}")
        out["runs"] = runs
        # The planted fault: a run that left the parameters at init fails
        # the fp limits (and its int8 rounding is the step-1 check's
        # ``differ_if_dropped``).
        out["planted_unchanged_fails"] = {
            opt: not _params_ok(stats, False, opt)
            for opt, stats in r0["planted_unchanged"].items()}
        if not all(out["planted_unchanged_fails"].values()):
            bad.append("planted_unchanged")
        # ... and a run whose updates are four times the reference's fails
        # the int8 bound (with its path term).
        out["planted_update_x4_fails_int8"] = {
            opt: not _params_ok(stats, True, opt,
                                out["reference"][opt]["path_bound"])
            for opt, stats in r0["planted_update_x4"].items()}
        if not all(out["planted_update_x4_fails_int8"].values()):
            bad.append("planted_update_x4")
        out["overlap_plan"] = next(
            (a["overlap_plan"] for a in r0["runs"] if a["overlap_plan"]),
            None)
        out["k5a_payload"] = r0.get("k5a_payload")
        if not (out["k5a_payload"] and out["k5a_payload"]["codes_equal"]
                and out["k5a_payload"]["scales_equal"]):
            bad.append("k5a_payload")
        rs = r0["resize"]
        out["resize"] = rs
        if not (rs["final_step"] == sum(DP2_RESIZE_STEPS)
                and rs["loss_gap"] <= DP2_FP_LOSS_ATOL
                and all(t == TRAIN_BATCH * TRAIN_SEQ
                        for t in rs["tokens_per_step"])
                and [d["grad_accum"] for d in rs["details"]] == [2, 1]
                and all(d["ok"] and not d["fallback"]
                        for d in rs["details"])):
            bad.append("resize")
        out["save"] = [r0["save"], r1["save"]]
        if not (r0["save"]["saved"] and r1["save"]["saved"]):
            bad.append("save")
        t0 = time.perf_counter()
        out["local_sgd"], failed = _lsgd_check(
            [r0["local_sgd"], r1["local_sgd"]], out_dir)
        out["local_sgd"]["check_s"] = time.perf_counter() - t0
        out["local_sgd"]["world_of_train"] = r0["local_sgd"]["world_of_train"]
        bad += failed
        for r in (r0, r1):
            for name, run in r["local_sgd"]["runs"].items():
                if name.startswith("planted"):
                    continue
                for s in run["steps"] + run["syncs"]:
                    for k, v in s["launches"].items():
                        counts[k] += v

        # -- restore into one process on the card ----------------------
        dumps = [torch.load(os.path.join(out_dir, f"pieces_r{r}.pt"),
                            weights_only=False)
                 for r in range(2)]
        whole = _assemble_pieces(dumps)
        os.environ["DLROVER_TPU_JOB"] = f"{job}_restore"
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer("adafactor",
                                          learning_rate=TRAIN_LR),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
        template = train.init(seed=0).checkpoint_tree()
        t0 = time.perf_counter()
        ckpt = Checkpointer(os.path.join(out_dir, "ckpt"), host_index=0,
                            num_hosts=1, device="cuda")
        step, tree = ckpt.load_checkpoint(state_template=template)
        restore_s = time.perf_counter() - t0
        ckpt.close()
        differ = [
            "".join(path) for path, leaf in sh.tree_flatten_with_path(tree)
            if not (_same_bits(leaf.cpu(), whole[path])
                    if isinstance(leaf, torch.Tensor)
                    else leaf == whole[path])]
        out["restore"] = {"step": step, "seconds": restore_s,
                          "leaves": len(whole), "leaves_differing":
                          differ[:8], "saved_by_hosts": 2,
                          "restored_into_hosts": 1}
        if step != sum(DP2_RESIZE_STEPS) or differ:
            bad.append("restore")
        del tree, template, train
        torch.cuda.empty_cache()
        out["launches"] = counts
        out["phase_s"] = time.perf_counter() - t_start
        if bad:
            raise AssertionError(f"train_dp2 checks failed: {bad}")
    finally:
        emit(out)
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrover_tpu_ckpt_{job}"):
                os.unlink(os.path.join("/dev/shm", name))
        shutil.rmtree(sock_dir, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts


# -- the training options: remat policies, host offload, the optimizers -----------

#: ``train_opts``: GPT-2 1.5B's width (d_model 1600, 25 heads of 64, vocab
#: 50304, fp32 parameters, bf16 compute, flash) with its depth cut to
#: this many of 48 layers, batch 16 x 1024, one init for every run.
OPTS_LAYERS = 4
OPTS_LR = 1e-4
OPTS_WD = 0.1
OPTS_OFFLOAD = "offload:attn_out,mlp_wo"
#: µP's tuning width: the updates of matrix-like leaves divided by
#: 1600 / 256.
OPTS_MUP_BASE = 256
OPTS_OPT_STEPS = 3
# Limits (PERF.md §6, PR 17, has the readings).  A policy's gradients
# against ``none``'s: each leaf's largest difference over its largest
# value at most what two runs of K3 give (dq is summed by atomics, so two
# runs differ: ``none`` run twice read 7.1e-3, on the embedding; every
# policy 6.7e-3 to 7.3e-3), about 3x that; the loss bit for bit (the
# forward is the same kernels on the same inputs).  The planted replay
# fault read 1.84.
OPTS_GRAD_RTOL = 0.02
#: Offload lowers the step's device peak by at least this share of the
#: bytes it moves, against the save-only twin that keeps the same sites.
OPTS_OFFLOAD_PEAK_SHARE = 0.8
#: An optimizer step against its float64 shadow (the same init, advanced
#: by the float64 formula on the gradients the step handed the
#: optimizer): per leaf, the largest difference over the largest update
#: (values where Lion's sign flips excluded and counted instead), about
#: 3x the card's readings: Lion 1.20e-7, AGD 5.8e-7, AdamW+µP 5.9e-7
#: (WSAM's AdamW 5.6e-7).  The planted Lion faults read the same here and
#: fail on the flips or the state.
OPTS_UPDATE_RTOL = {"lion": 4e-7, "agd": 2e-6, "adamw_mup": 2e-6}
#: The state after each step against the shadow's, per moment leaf the
#: largest difference over its largest value, about 3x the readings:
#: Lion's mu 1.6e-7, AGD's moments 3.9e-7-6.5e-7, Adam's 2.0e-7 (WSAM's
#: 1.7e-7); a Lion moment decayed by b1 read 8.5-9.0.
OPTS_STATE_RTOL = {"lion": 5e-7, "agd": 2e-6, "adamw_mup": 6e-7}
#: Lion: the share of values whose sign differs from the float64 one
#: (at most 9.4e-6 on the card, 0 against the shadow state; the planted
#: faults 0.22-0.43).
OPTS_LION_FLIP_SHARE = 3e-5
#: WSAM over AdamW: the base update (recorded) against its float64
#: formula at ``OPTS_UPDATE_RTOL["adamw_mup"]``, and the new parameters
#: bit for bit against the reference's composition evaluated from the
#: recorded gradients and update (``p + u``, then less ``lr * alpha *
#: (g2 - g1)``, in fp32).
#: ``wo_transposed`` against the untransposed model on the same weights
#: (the loss read equal, the gradients 7.1e-3, K3's own noise; the
#: transposed operand may take another GEMM algorithm).
OPTS_WOT_LOSS_ATOL, OPTS_WOT_GRAD_RTOL = 1e-4, 0.02


def _opts_config(**overrides):
    from dlrover_tpu_torch.models import gpt2_config

    return gpt2_config("1.5b", num_layers=OPTS_LAYERS,
                       attention_impl="flash", **overrides)


def _opts_batch(vocab, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(TRAIN_BATCH, TRAIN_SEQ + 1),
                          dtype=np.int64)
    return (torch.as_tensor(tokens[:, :-1], device="cuda"),
            torch.as_tensor(tokens[:, 1:], device="cuda"))


def _opts_site_bytes(cfg):
    """Each remat site's bytes a layer at the phase's shapes (bf16
    activations, the flash lse fp32)."""
    t, d = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model
    return {"qkv_proj": t * 3 * d * 2, "attn_out": t * d * 2,
            "mlp_wo": t * d * 2, "mlp_out": t * d * 2,
            "flash_out": t * d * 2,
            "flash_lse": TRAIN_BATCH * cfg.num_heads * TRAIN_SEQ * 4,
            "dot": t * cfg.resolved_d_ff * 2}


def _opts_predicted(cfg, name):
    """From the shapes: the bytes a step keeps on the device by site name,
    the bytes it moves to and from host memory, and its K1/K3 launches."""
    from dlrover_tpu_torch.ops import remat_policy as rp

    policy = rp.resolve(name)
    site = _opts_site_bytes(cfg)
    layers = cfg.num_layers
    if policy.dots:
        # Under flash every product left is a DenseGeneral: no batch dots.
        kept = {"qkv_proj": site["qkv_proj"], "attn_out": site["attn_out"],
                "dot": site["dot"], "mlp_wo": site["mlp_wo"]}
    else:
        kept = {n: site[n] for n in policy.saved_names}
    moved = sum(site[n] for n in policy.offload_names) * layers
    flash_kept = set(policy.saved_names + policy.offload_names) >= {
        "flash_out", "flash_lse"}
    return ({n: b * layers for n, b in kept.items()}, moved,
            _per_step(flash_fwd=layers * (1 if name == "none" or flash_kept
                                          else 2),
                      flash_bwd_fused=layers))


def _opts_step(model, cfg, name, tokens, targets):
    """One forward and backward under ``name``: the loss, the gradients
    (copies), launches, remat counts, device peak and seconds."""
    from dlrover_tpu_torch.ops import remat_policy as rp
    from dlrover_tpu_torch.trainer import train_lib

    model.config = dataclasses.replace(cfg, remat=name)
    for p in model.parameters():
        p.grad = None
    _zero_counts()
    rp.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, aux = model.forward_aux(tokens)
    loss, _ = train_lib.cross_entropy_loss(logits, targets)
    del logits
    (loss + aux).backward()
    loss = float(loss)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    counts = {k: (dict(v) if isinstance(v, dict) else v)
              for k, v in rp.COUNTS.items()}
    return {"loss": loss, "grads": grads, "launches": _counts(),
            "remat": counts, "peak": peak, "s": seconds}


def _opts_grad_gap(grads, ref):
    """The worst leaf: its largest difference over its largest value."""
    worst = (0.0, None)
    for k, g in grads.items():
        r = ref[k].float()
        scale = float(r.abs().max())
        gap = float((g.float() - r).abs().max()) / max(scale, 1e-30)
        if worst[1] is None or gap > worst[0]:
            worst = (gap, k)
    return worst


def _opts_policies(model, cfg, tokens, targets):
    """Every registered policy and ``OPTS_OFFLOAD`` (and its save-only
    twin), one step each against ``none``'s; the planted replay fault."""
    from dlrover_tpu_torch.ops import remat_policy as rp

    names = ["none"] + sorted(rp.available()) + [OPTS_OFFLOAD]
    # The offload list's save-only twin: the same sites kept on the card.
    listed = rp.resolve(OPTS_OFFLOAD).offload_names
    twin = rp.register(rp.RematPolicy(name="save:" + ",".join(listed),
                                      saved_names=listed))
    launched = collections.Counter()
    base = _opts_step(model, cfg, "none", tokens, targets)
    launched.update(base["launches"])
    again = _opts_step(model, cfg, "none", tokens, targets)
    runs, bad = {}, []
    runs["none_rerun"] = {"grad_gap": _opts_grad_gap(again["grads"],
                                                      base["grads"]),
                          "loss_equal": again["loss"] == base["loss"]}
    del again
    t_units = TRAIN_BATCH * TRAIN_SEQ * cfg.num_layers * cfg.d_model * 2
    # "offload" twice: its first step also allocates the pinned buffers.
    for name in ([n for n in names if n != "none"] + ["offload"]
                 + [twin.name]):
        r = _opts_step(model, cfg, name, tokens, targets)
        launched.update(r["launches"])
        kept, moved, want = _opts_predicted(cfg, name)
        gap = _opts_grad_gap(r["grads"], base["grads"])
        policy = rp.resolve(name)
        rc = r["remat"]
        row = {
            "loss_equal": r["loss"] == base["loss"], "grad_gap": gap,
            "launches": {k: v for k, v in r["launches"].items() if v},
            "launches_ok": r["launches"] == want,
            "kept_bytes": rc["kept"], "kept_predicted": kept,
            "d2h": rc["d2h"], "h2d": rc["h2d"], "moved_predicted": moved,
            "host_copies": rc["host"], "pinned": rc["pinned"],
            "peak_bytes": r["peak"], "step_s": r["s"],
            "hbm_act_per_token_layer": {
                "registry": policy.hbm_act_per_token_layer,
                "kept_reading": sum(rc["kept"].values()) / t_units}}
        row["ok"] = (row["loss_equal"] and gap[0] <= OPTS_GRAD_RTOL
                     and row["launches_ok"] and rc["kept"] == kept
                     and rc["d2h"] == rc["h2d"] == moved
                     and rc["pinned"] == rc["host"])
        if name in runs:
            row["first_step_s"] = runs[name]["step_s"]
        runs[name] = row
        if not row["ok"]:
            bad.append(name)
        del r
    offload, saved = runs[OPTS_OFFLOAD], runs[twin.name]
    lowered = saved["peak_bytes"] - offload["peak_bytes"]
    runs["offload_peak"] = {
        "moved": offload["d2h"], "peak_lowered": lowered,
        "share": lowered / offload["d2h"]}
    if lowered < OPTS_OFFLOAD_PEAK_SHARE * offload["d2h"]:
        bad.append("offload_peak")
    del rp._REGISTRY[twin.name]

    # Planted: a replay that hands back the other site's tensor (under
    # branch_out each layer keeps attn_out then mlp_out, of one shape).
    replay = rp.KeptSites.replay

    def swapped(self):
        at = self.at
        self.at = at ^ 1
        out = replay(self)
        self.at = at + 1
        return out

    rp.KeptSites.replay = swapped
    try:
        r = _opts_step(model, cfg, "branch_out", tokens, targets)
    finally:
        rp.KeptSites.replay = replay
    gap = _opts_grad_gap(r["grads"], base["grads"])
    runs["planted_swapped_replay"] = {"grad_gap": gap,
                                      "fails": gap[0] > OPTS_GRAD_RTOL}
    if not runs["planted_swapped_replay"]["fails"]:
        bad.append("planted_swapped_replay")
    return runs, base, bad, launched


def _f64(tree):
    return {k: v.double() for k, v in tree.items()}


def _opts_clip64(g, max_norm=1.0):
    """``make_optimizer``'s global-norm clip in float64."""
    norm = math.sqrt(sum(float(x.square().sum()) for x in g.values()))
    if norm < max_norm:
        return g
    return {k: x / norm * max_norm for k, x in g.items()}


def _opts_zeros64(g):
    return {k: torch.zeros_like(x) for k, x in g.items()}


def _opts_lion64(g, p, s, b1=0.9, b2=0.99):
    """One float64 Lion step (optax's b1, b2): the update and the new
    shadow state ``{"count", "mu"}`` (None: the init)."""
    s = s or {"count": 0, "mu": _opts_zeros64(g)}
    u = {k: -OPTS_LR * (torch.sign((1 - b1) * g[k] + b1 * s["mu"][k])
                        + OPTS_WD * p[k]) for k in g}
    mu = {k: (1 - b2) * g[k] + b2 * s["mu"][k] for k in g}
    return u, {"count": s["count"] + 1, "mu": mu}


def _opts_agd64(g, p, s, b1=0.9, b2=0.95, delta=1e-5):
    """One float64 AGD step (``amsgrad`` off, decoupled decay) and the new
    shadow state ``{"count", "exp_avg", "exp_avg_sq"}``."""
    s = s or {"count": 0, "exp_avg": _opts_zeros64(g),
              "exp_avg_sq": _opts_zeros64(g)}
    count = s["count"] + 1
    bc1, bc1_old = 1 - b1 ** count, 1 - b1 ** (count - 1)
    bc2 = 1 - b2 ** count
    u, ms, vs = {}, {}, {}
    for k in g:
        m_old = s["exp_avg"][k]
        m = b1 * m_old + (1 - b1) * g[k]
        diff = m / bc1 if count == 1 else m / bc1 - m_old / bc1_old
        v = b2 * s["exp_avg_sq"][k] + (1 - b2) * diff * diff
        denom = torch.clamp(v.sqrt(), min=delta * bc2 ** 0.5)
        u[k] = -(OPTS_LR * bc2 ** 0.5 / bc1 * (m / denom)
                 + OPTS_LR * OPTS_WD * p[k])
        ms[k], vs[k] = m, v
    return u, {"count": count, "exp_avg": ms, "exp_avg_sq": vs}


def _opts_adam64(g, p, s, b1=0.9, b2=0.95, eps=1e-8):
    """One float64 AdamW step and the new shadow state ``{"count", "mu",
    "nu"}``."""
    s = s or {"count": 0, "mu": _opts_zeros64(g), "nu": _opts_zeros64(g)}
    count = s["count"] + 1
    c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    mu = {k: (1 - b1) * g[k] + b1 * s["mu"][k] for k in g}
    nu = {k: (1 - b2) * g[k] ** 2 + b2 * s["nu"][k] for k in g}
    u = {k: -OPTS_LR * ((mu[k] / c1) / ((nu[k] / c2).sqrt() + eps)
                        + OPTS_WD * p[k]) for k in g}
    return u, {"count": count, "mu": mu, "nu": nu}


def _opts_moments(state):
    """The moments of a (chained) optimizer state: ``{moment: {leaf:
    tensor}}``."""
    from dlrover_tpu_torch.optimizers.agd import AGDState

    if isinstance(state, AGDState):
        return {"exp_avg": state.exp_avg, "exp_avg_sq": state.exp_avg_sq}
    if isinstance(state, dict) and "mu" in state:
        return {k: state[k] for k in ("mu", "nu") if k in state}
    if isinstance(state, tuple):
        for part in state:
            found = _opts_moments(part)
            if found:
                return found
    return {}


def _opts_update_gap(u, u64, lion=False):
    """The worst leaf's largest difference over its largest update.  For
    Lion the values whose sign differs from the float64 one (an update
    more than ``lr / 2`` away, a sign of 0 against +-1 included: rounding
    moves it by about 1e-7 lr) are left out and their share returned."""
    worst, flipped, total = (0.0, None), 0, 0
    for k, ref in u64.items():
        d = (u[k].double() - ref).abs()
        if lion:
            differ = d > OPTS_LR / 2
            flipped += int(differ.sum())
            total += differ.numel()
            d = torch.where(differ, torch.zeros_like(d), d)
        gap = float(d.max()) / max(float(ref.abs().max()), 1e-300)
        if worst[1] is None or gap > worst[0]:
            worst = (gap, k)
    return worst, (flipped / max(total, 1) if lion else None)


def _opts_state_gap(moments, s64):
    """The worst moment leaf of the port's state against the float64
    shadow state: its largest difference over its largest value."""
    worst = (0.0, None)
    for name, tree in moments.items():
        for k, t in tree.items():
            ref = s64[name][k]
            gap = float((t.double() - ref).abs().max()) / max(
                float(ref.abs().max()), 1e-300)
            if worst[1] is None or gap > worst[0]:
                worst = (gap, f"{name}/{k}")
    if not moments or set(moments) != set(s64) - {"count"}:
        worst = (math.inf, "moments missing")
    return worst


def _opts_train_run(cfg, tx, step64, lion=False, mup_width=None):
    """``OPTS_OPT_STEPS`` steps of ``build_train(cfg, tx)`` on batches 1..,
    each update and the state after it held against a float64 shadow that
    starts from the same init and advances by ``step64`` on the gradients
    the step handed the optimizer (clipped as ``make_optimizer`` clips);
    the decay reads the step's own parameters."""
    from dlrover_tpu_torch.optimizers import mup
    from dlrover_tpu_torch.trainer import train_lib

    seen = {}

    def recording(grads, state, params):
        seen["g"], seen["p"] = _f64(grads), _f64(params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        updates, state = tx.update(grads, state, params)
        torch.cuda.synchronize()
        seen.update(u=updates, state=state, s=time.perf_counter() - t0)
        return updates, state

    train = train_lib.build_train(
        cfg, tx._replace(update=recording), global_batch_size=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, device="cuda")
    state = train.init(seed=0)
    s64, steps = None, []
    for step in range(OPTS_OPT_STEPS):
        tokens, targets = _opts_batch(cfg.vocab_size, 1 + step)
        state, m = train.step(state, {"inputs": tokens, "targets": targets})
        loss = float(m["loss"])
        u64, s64 = step64(_opts_clip64(seen.pop("g")), seen.pop("p"), s64)
        if mup_width is not None:
            u64 = {k: u / mup_width if mup.is_matrix_like(k, u.dim())
                   else u for k, u in u64.items()}
        gap, flipped = _opts_update_gap(seen["u"], u64, lion)
        steps.append({"loss": loss, "update_gap": gap,
                      "state_gap": _opts_state_gap(
                          _opts_moments(seen["state"]), s64),
                      "flip_share": flipped, "update_s": seen["s"]})
        seen.clear()
        del u64
    del train, state, s64
    torch.cuda.empty_cache()
    return steps


def _opts_optimizers(model, cfg):
    """Lion and AGD from ``make_optimizer``, AdamW (``make_optimizer``)
    then µP, each stepped by ``build_train``'s step, and WSAM over AdamW:
    ``OPTS_OPT_STEPS`` steps each on batches 1.. (flash_only), every
    update and state held against a float64 shadow; two planted Lion
    faults."""
    from dlrover_tpu_torch.optimizers import mup, wsam
    from dlrover_tpu_torch.optimizers import optax_ports as ox
    from dlrover_tpu_torch.trainer import train_lib

    fcfg = dataclasses.replace(cfg, remat="flash_only")
    model.config = fcfg
    init = {k: p.detach().clone() for k, p in model.named_parameters()}
    width = cfg.d_model / OPTS_MUP_BASE

    def land(new):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(new[k])

    def sign_first(b1=0.9, b2=0.99):
        # The sign taken before the interpolation.
        def update(updates, state, params=None):
            out = {k: torch.sign((1.0 - b1) * torch.sign(g)
                                 + b1 * torch.sign(state["mu"][k]))
                   for k, g in updates.items()}
            mu = {k: (1 - b2) * g + b2 * state["mu"][k]
                  for k, g in updates.items()}
            return out, {"count": state["count"] + 1, "mu": mu}

        return ox.GradientTransformation(lion_moment(b1, b2).init, update)

    def mu_b1(b1=0.9, b2=0.99):
        # The moment decays by b1 in place of b2.
        return lion_moment(b1, b1)

    def make(name, moment=None):
        if moment is None:
            return train_lib.make_optimizer(name, learning_rate=OPTS_LR,
                                            weight_decay=OPTS_WD)
        ox.scale_by_lion = moment
        try:
            return train_lib.make_optimizer(name, learning_rate=OPTS_LR,
                                            weight_decay=OPTS_WD)
        finally:
            ox.scale_by_lion = lion_moment

    lion_moment = ox.scale_by_lion
    runs, bad = {}, []
    for name, tx, step64, kw in (
            ("lion", make("lion"), _opts_lion64, dict(lion=True)),
            ("agd", make("agd"), _opts_agd64, {}),
            ("adamw_mup", ox.chain(make("adamw"), mup.mup_scale(width)),
             _opts_adam64, dict(mup_width=width)),
            ("planted_lion_sign_first", make("lion", sign_first),
             _opts_lion64, dict(lion=True)),
            ("planted_lion_mu_b1", make("lion", mu_b1), _opts_lion64,
             dict(lion=True))):
        steps = _opts_train_run(fcfg, tx, step64, **kw)
        limit = OPTS_UPDATE_RTOL["lion" if kw.get("lion") else name]
        slimit = OPTS_STATE_RTOL["lion" if kw.get("lion") else name]

        def sound(st):
            return (st["update_gap"][0] <= limit
                    and st["state_gap"][0] <= slimit
                    and (st["flip_share"] is None
                         or st["flip_share"] <= OPTS_LION_FLIP_SHARE))

        if name.startswith("planted"):
            fails = not all(sound(st) for st in steps)
            runs[name] = {"steps": steps, "fails": fails}
            if not fails:
                bad.append(name)
            continue
        ok = all(sound(st) and np.isfinite(st["loss"]) for st in steps)
        runs[name] = {"steps": steps, "ok": ok}
        if not ok:
            bad.append(name)

    # WSAM over AdamW (the decoupled branch): both gradients recorded.
    land(init)
    recorded = []
    grad_fn = wsam._grad

    def recording(loss_fn, params, batch):
        out = grad_fn(loss_fn, params, batch)
        recorded.append(out[1])
        return out

    def loss_fn(params, tokens, targets):
        logits = torch.func.functional_call(model, params, (tokens,))
        loss, _ = train_lib.cross_entropy_loss(logits, targets)
        return loss

    wcfg = wsam.WSAMConfig(learning_rate=OPTS_LR)
    adamw = ox.adamw(OPTS_LR, b1=0.9, b2=0.95, weight_decay=OPTS_WD)
    applied = []

    def recorded_update(updates, state, params):
        u, state = adamw.update(updates, state, params)
        applied.append(u)
        return u, state

    stepper = wsam.make_wsam_step(loss_fn, adamw._replace(
        update=recorded_update), wcfg)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = adamw.init(params)
    alpha = wcfg.gamma / (1 - wcfg.gamma)
    s64, steps = None, []
    wsam._grad = recording
    try:
        for step in range(OPTS_OPT_STEPS):
            tokens, targets = _opts_batch(cfg.vocab_size, 1 + step)
            recorded.clear()
            applied.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, state, loss = stepper(params, state, tokens, targets)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            u64, s64 = _opts_adam64(_f64(recorded[0]), _f64(params), s64)
            gap, _ = _opts_update_gap(applied[0], u64)
            (u,) = applied
            composed = all(torch.equal(new[k], (params[k] + u[k]).to(
                params[k].dtype) - OPTS_LR * alpha * (recorded[1][k]
                                                      - recorded[0][k]))
                           for k in new)
            steps.append({"loss": float(loss), "update_gap": gap,
                          "state_gap": _opts_state_gap(
                              _opts_moments(state), s64),
                          "composed_bit_equal": composed,
                          "step_s": step_s, "gradients": len(recorded)})
            params = new
            del u64, u
    finally:
        wsam._grad = grad_fn
    ok = all(s["update_gap"][0] <= OPTS_UPDATE_RTOL["adamw_mup"]
             and s["state_gap"][0] <= OPTS_STATE_RTOL["adamw_mup"]
             and s["composed_bit_equal"] and s["gradients"] == 2
             for s in steps)
    runs["wsam_adamw"] = {"steps": steps, "ok": ok}
    if not ok:
        bad.append("wsam_adamw")
    del s64, params, state
    land(init)
    return runs, bad


def _opts_wo_transposed(model, cfg, tokens, targets, base):
    """The same weights with ``wo`` stored transposed: the loss and the
    gradients of ``none``, ``wo``'s transposed."""
    from dlrover_tpu_torch.models.transformer import TransformerLM

    wcfg = dataclasses.replace(cfg, wo_transposed=True, remat="none")
    moved = TransformerLM(wcfg, device="cuda")
    moved.load_state_dict({k: (v.t().contiguous()
                               if k.endswith("mlp.wo.kernel") else v)
                           for k, v in model.state_dict().items()})
    r = _opts_step(moved, wcfg, "none", tokens, targets)
    grads = {k: (g.t() if k.endswith("mlp.wo.kernel") else g)
             for k, g in r["grads"].items()}
    gap = _opts_grad_gap(grads, base["grads"])
    out = {"loss_gap": abs(r["loss"] - base["loss"]), "grad_gap": gap,
           "wo_kernel_shape": list(moved.blocks[0].mlp.wo.kernel.shape)}
    out["ok"] = (out["loss_gap"] <= OPTS_WOT_LOSS_ATOL
                 and gap[0] <= OPTS_WOT_GRAD_RTOL)
    del moved, r
    return out


def train_opts_and_check():
    """The training options at GPT-2 1.5B's width (``OPTS_LAYERS`` of 48
    layers), one model and one batch: every remat policy and an offload
    list against ``none`` (gradients, launches, kept and moved bytes,
    pinned copies, the device peak against the save-only twin), Lion,
    AGD, AdamW with µP and WSAM against their float64 formulas,
    ``wo_transposed`` against the untransposed weights, and two planted
    faults.  Returns the counted launches of the policy steps."""
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.models.transformer import init_params

    cfg = _opts_config()
    out = {"phase": "train_opts",
           "model": f"gpt2-1.5b width (d_model 1600, 25 heads x 64, vocab "
                    f"50304, fp32 params, bf16 compute, flash), depth cut "
                    f"to {OPTS_LAYERS} of 48 layers, random weights seed 0",
           "batch": f"{TRAIN_BATCH} x {TRAIN_SEQ}",
           "tolerance": {"grad_rtol": OPTS_GRAD_RTOL,
                         "offload_peak_share": OPTS_OFFLOAD_PEAK_SHARE,
                         "update_rtol": OPTS_UPDATE_RTOL,
                         "state_rtol": OPTS_STATE_RTOL,
                         "lion_flip_share": OPTS_LION_FLIP_SHARE,
                         "wo_transposed": [OPTS_WOT_LOSS_ATOL,
                                           OPTS_WOT_GRAD_RTOL]}}
    t_start = time.perf_counter()
    bad = []
    counts = dict.fromkeys(_counts(), 0)
    try:
        model = TransformerLM(cfg, device="cuda")
        model.load_state_dict(init_params(cfg, seed=0, device="cuda"))
        model.train()
        tokens, targets = _opts_batch(cfg.vocab_size, 0)
        runs, base, failed, launched = _opts_policies(model, cfg, tokens,
                                                      targets)
        for k, v in launched.items():
            counts[k] += v
        out["policies"] = runs
        bad += failed
        out["wo_transposed"] = _opts_wo_transposed(model, cfg, tokens,
                                                   targets, base)
        if not out["wo_transposed"]["ok"]:
            bad.append("wo_transposed")
        del base
        torch.cuda.empty_cache()
        out["optimizers"], failed = _opts_optimizers(model, cfg)
        bad += failed
        out["phase_s"] = time.perf_counter() - t_start
        if bad:
            raise AssertionError(f"train_opts checks failed: {bad}")
    finally:
        emit(out)
        torch.cuda.empty_cache()
    return counts


# -- the fsdp and tensor axes ----------------------------------------------------

#: ``train_mp2``: Llama-2 7B at full width (d_model 4096, 32 heads of 128
#: and 32 KV heads, d_ff 11008 SwiGLU, vocab 32000, untied head; bf16
#: parameters and compute, flash_only) with its depth cut to this many
#: layers (2 until PR 17, 666,914,816 parameters; cut for the script's
#: time: 95.6 s at 2), trained on two processes of the one card at each
#: mesh of ``MP2_RUNS``, each against the world-1 run of the same config,
#: init and batch in one process.
MP2_LAYERS = 1
# Cut from 3 to 2 steps: at 3 the phase took 153.9 s of its 120 (PR 15).
MP2_STEPS = 2
MP2_RUNS = (
    ("fsdp2_adafactor", dict(fsdp=2), "adafactor"),
    ("tensor2_adafactor", dict(tensor=2), "adafactor"),
    ("fsdp2_q8_adam", dict(fsdp=2), "q8_adam"),
)
# Limits, each about 3x the sound readings and below the smallest update
# a run's steps make (the printed ``smallest_update_rel``; a run that
# drops an update must fail); PERF.md §6 (PR 15) has the readings.  At
# 3 steps the sound runs read loss gaps of at most 1.13e-4 (the bf16
# reductions in another order; Adafactor's loss moves 4.2e-3 a step),
# grad-norm gaps of at most 1.76e-5 (the replicated leaves counted twice
# read 9.75e-5), Adafactor's leaves at most 7.9e-6 of their norm (its
# smallest kept update 5.3e-5; one rank's shards left at the init read
# 6.0e-5) and q8_adam's 1.01e-3 (smallest update 8.5e-3).
MP2_LOSS_ATOL, MP2_NORM_RTOL = 3.5e-4, 5e-5
MP2_PARAM_RTOL = {"adafactor": 2e-5, "q8_adam": 2e-3}
#: Under fsdp=2 each rank holds at most this share of the world-1 run's
#: parameters and optimizer state between steps.
MP2_RESIDENT_SHARE = 0.55


def _mp2_config():
    from dlrover_tpu_torch.models import llama_config

    return llama_config("7b", num_layers=MP2_LAYERS, attention_impl="flash",
                        remat="flash_only", param_dtype=torch.bfloat16)


def _resident_bytes(state) -> int:
    """Parameters, gradients and optimizer state a rank holds between
    steps (the gradients are released by the step: counted where
    present)."""
    params = list(state.model.parameters())
    return (sum(p.numel() * p.element_size() for p in params)
            + sum(_state_bytes(p.grad) for p in params)
            + _state_bytes(state.opt_state))


def _mp2_predicted_wire(cfg, parallel, opt, rows, seq):
    """The bytes one step of one rank hands to each axis's wire, by leg
    (``"fsdp/all_gather"``...), from the shapes alone: the fsdp gathers
    (the leaves outside the blocks once, each block's twice: its forward
    and flash_only's recompute) and reduce-scatters, the tensor axis's
    activation all-reduces (the embedding lookup; each block's two
    row-parallel sums in the forward, the attention's again in the
    recompute, which stops after the last tensor the backward saves, so
    before the MLP's sum, and the two column-parallel gradient sums; the
    head's gradient sum) and the
    vocab-parallel cross entropy's three ``[rows, seq]`` fp32 sums, and
    the small fp32 sums: the batch group's token and loss sums, the
    gradients of the leaves fsdp leaves whole, and the optimizer's
    reductions over split leaves (two global norms, and for Adafactor
    its factored means over split dimensions, its row factor's mean and
    two block mean squares)."""
    from dlrover_tpu_torch.models.transformer import (
        TransformerLM,
        param_logical_axes,
        param_shapes,
        stacked_logical_axes,
    )
    from dlrover_tpu_torch.parallel import rules as lr
    from dlrover_tpu_torch.parallel import sharding
    from dlrover_tpu_torch.runtime import mesh as mesh_lib
    from dlrover_tpu_torch.trainer import train_lib

    sizes = dict.fromkeys(mesh_lib.MESH_AXES, 1)
    sizes.update(parallel)
    f, t = sizes["fsdp"], sizes["tensor"]
    axes = param_logical_axes(TransformerLM(cfg, device="meta"))
    layers = sharding.leaf_layouts(axes, param_shapes(cfg),
                                   lr.DEFAULT_RULES, sizes)
    stacked = sharding.leaf_layouts(
        stacked_logical_axes(axes), train_lib._stacked_shapes(cfg),
        lr.DEFAULT_RULES, sizes)
    item = torch.empty((), dtype=cfg.param_dtype).element_size()
    out = collections.Counter()

    def local(lay):
        return int(np.prod(lay.local_shape(sizes)))

    if f > 1:
        def split(n):
            return layers[n].dim_of("fsdp") is not None

        root = sum(local(layers[n]) for n in layers
                   if not n.startswith("blocks.") and split(n)) * item
        block = sum(local(layers[n]) for n in layers
                    if n.startswith("blocks.0.") and split(n)) * item
        out["fsdp/all_gather"] += root + 2 * cfg.num_layers * block
        out["fsdp/reduce_scatter"] += f * (root + cfg.num_layers * block)
        whole = sum(local(lay) for lay in stacked.values()
                    if lay.dim_of("fsdp") is None)
        out["fsdp/all_reduce"] += whole * item + 4 + 8
    if t > 1:
        act = rows * seq * cfg.d_model * 2
        out["tensor/all_reduce"] += act * (2 + 5 * cfg.num_layers)
        out["tensor/all_reduce"] += 3 * rows * seq * 4
    _optimizer_wire(stacked, sizes, opt, out)
    return dict(out)


def _mp2_leaf_sums(train, state, ref, init):
    """Per parameter, over this rank's boxes it writes (replica 0): the
    squared distance to the reference's parameters, the reference's
    squared norm, the reference's squared update (from ``init``, this
    rank's boxes at the init) and the squared distance of the init's box
    (a rank whose update was dropped), as one fp64 CPU tensor ``[names,
    4]`` to be summed over the world."""
    layout = train.param_layout()
    params = state.params()
    # Every leaf of the model, in one order on every rank (a pipe stage
    # holds its own layers: the others' rows stay 0 here).
    names = sorted(layout)
    out = torch.zeros((len(names), 4), dtype=torch.float64, device="cuda")
    for i, name in enumerate(names):
        spot = layout[name]
        if name not in params or spot.replica_id != 0:
            continue
        box = tuple(slice(b, e) for b, e in spot.index)
        w = ref[name][box].to("cuda").double()
        i0, g = init[name].double(), params[name].double()
        out[i] = torch.stack([(g - w).square().sum(), w.square().sum(),
                              (w - i0).square().sum(),
                              (i0 - w).square().sum()])
    return names, out.cpu()


def _mp2_reference(opt, out_dir):
    """The world-1 run: one process, the whole batch, no mesh; its
    parameters after step 1 and after the last, and what it holds."""
    from dlrover_tpu_torch.trainer import train_lib

    cfg = _mp2_config()
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer(opt, learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    losses, norms, params1, seconds = [], [], None, []
    for _ in range(MP2_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train.step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        seconds.append(time.perf_counter() - t0)
        if params1 is None and opt == "adafactor":
            # The planted faults' one step is held against this.
            params1 = {k: v.to("cpu", copy=True)
                       for k, v in state.params().items()}
    resident = _resident_bytes(state)
    params = {k: v.cpu() for k, v in state.params().items()}
    torch.save({"losses": losses, "grad_norms": norms, "params": params,
                "params1": params1},
               os.path.join(out_dir, f"mp_ref_{opt}.pt"))
    out = {"losses": losses, "grad_norms": norms, "step_s": seconds,
           "resident_bytes": resident,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    del state, train, batch, params, params1
    torch.cuda.empty_cache()
    return out


def _mp2_summed(names, sums):
    """The world's per-leaf sums (fp64 on the host, never a CUDA tensor
    handed to the group)."""
    import torch.distributed as dist

    dist.all_reduce(sums)
    return {n: [float(x) for x in row] for n, row in zip(names, sums)}


def _mp2_planted(train, state, placed, fault):
    """One step with a planted fault: ``row_sum_skipped`` (the first
    block's attention output projection keeps its partial product: its
    sum over the tensor group is skipped), ``replicated_counted_twice``
    (the global norm counts every leaf the tensor group holds whole once
    per rank).  Returns the step's loss and grad norm."""
    from dlrover_tpu_torch.optimizers import optax_ports as ox

    out_proj = state.model.blocks[0].attn.out
    reduce, norm = out_proj.reduce, ox.global_norm
    if fault == "row_sum_skipped":
        out_proj.reduce = lambda x: x.clone()
    else:
        def twice(tree):
            total = norm(tree).square()
            whole = [x for n, x in tree.items() if not ox._leaf_axes(n)]
            total = total + sum(x.float().square().sum() for x in whole)
            return torch.sqrt(total)
        ox.global_norm = twice
    try:
        state, m = train.step(state, placed)
        return state, float(m["loss"]), float(m["grad_norm"])
    finally:
        out_proj.reduce, ox.global_norm = reduce, norm


def _mp2_rank(rank, out_dir):
    import torch.distributed as dist

    from dlrover_tpu_torch.checkpoint import shm_handler as sh
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_lib
    from dlrover_tpu_torch.trainer.elastic_trainer import (
        ElasticTrainer,
        TrainerConfig,
    )

    cfg = _mp2_config()
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    meshes = {}
    out = {"rank": rank, "runs": [], "planted": {},
           "backend": dist.get_backend(), "torch": torch.__version__}
    refs = {}
    for key, par, opt in MP2_RUNS:
        if opt not in refs:
            refs.clear()
            refs[opt] = torch.load(os.path.join(out_dir, f"mp_ref_{opt}.pt"),
                                   weights_only=False)
        ref = refs[opt]
        name = "x".join(f"{a}{n}" for a, n in par.items())
        if name not in meshes:
            meshes[name] = build_mesh(ParallelConfig(data=1, **par),
                                      device_type="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_build = time.perf_counter()
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer(opt, learning_rate=TRAIN_LR),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            mesh=meshes[name], device="cuda")
        state = train.init(seed=0)
        build_s = time.perf_counter() - t_build
        init = {k: v.clone() for k, v in state.params().items()}
        placed = train_lib.shard_batch(batch, train)
        steps = []
        for _ in range(MP2_STEPS):
            _zero_counts()
            wire_lib.reset_counts()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train.step(state, placed)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            steps.append({
                "s": time.perf_counter() - t0, "loss": loss,
                "grad_norm": norm, "tokens": float(m["tokens"]),
                "launches": {k: v for k, v in _counts().items() if v},
                "wire_bytes": dict(wire_lib.COUNTS["axes"]),
                "staged": dict(wire_lib.COUNTS["staged_axes"])})
        names, sums = _mp2_leaf_sums(train, state, ref["params"], init)
        run = {"key": key, "optimizer": opt, "parallel": par,
               "steps": steps, "build_s": build_s,
               "resident_bytes": _resident_bytes(state),
               "memory_allocated": torch.cuda.memory_allocated(),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(),
               "batch": (train.batch_rank, train.batch_ranks),
               "leaf_sums": _mp2_summed(names, sums)}
        # The planted fault of a dropped update on one rank: rank 1's
        # boxes at the init's values, rank 0's at the run's.
        if opt == "adafactor" and "fsdp" in par:
            mixed = sums.clone()
            if rank == 1:
                mixed[:, 0] = mixed[:, 3]
            run["planted_unchanged_shard"] = _mp2_summed(names, mixed)
        out["runs"].append(run)
        if key == "tensor2_adafactor":
            for fault in ("row_sum_skipped", "replicated_counted_twice"):
                state = train.init(seed=0)
                state, loss, norm = _mp2_planted(train, state, placed,
                                                 fault)
                names, sums = _mp2_leaf_sums(train, state, ref["params1"],
                                             init)
                out["planted"][fault] = {
                    "loss": loss, "grad_norm": norm,
                    "leaf_sums": _mp2_summed(names, sums)}
        del state, train, placed, init
        torch.cuda.empty_cache()

    # -- the sharded save at fsdp=2 --------------------------------------
    ckpt_dir = os.path.join(out_dir, "mp_ckpt")
    trainer = ElasticTrainer(
        cfg, TrainerConfig(global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                           optimizer="adafactor", learning_rate=TRAIN_LR,
                           report_every=1000, ckpt_every=1000,
                           checkpoint_dir=ckpt_dir),
        parallel=ParallelConfig(data=1, fsdp=2), device="cuda")
    m = trainer.train_step(batch)
    t0 = time.perf_counter()
    saved = trainer.save_checkpoint(wait_for_saver=True)
    out["save"] = {"saved": saved, "step": trainer.step,
                   "loss": float(m["loss"]),
                   "seconds": time.perf_counter() - t0}
    layout = trainer._layout()
    pieces = {path: leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
              else leaf for path, leaf in
              sh.tree_flatten_with_path(trainer.state.checkpoint_tree())}
    torch.save({"layout": {p: (s.global_shape, s.index, s.replica_id)
                           for p, s in layout.items()},
                "pieces": pieces},
               os.path.join(out_dir, f"mp_pieces_r{rank}.pt"))
    trainer.close()
    return out


def _mp2_leaf_stats(leaf_sums):
    """Per leaf: the norm-relative error against the reference and the
    reference's update relative to its norm."""
    return {n: (float(np.sqrt(s[0] / max(s[1], 1e-60))),
                float(np.sqrt(s[2] / max(s[1], 1e-60))))
            for n, s in leaf_sums.items()}


def train_mp2_and_check():
    """Two processes on ``cuda:0`` over a gloo group: the dense Llama step
    at Llama-2 7B's width on an fsdp=2 mesh (Adafactor, q8_adam) and a
    tensor=2 mesh (Adafactor), each held against the world-1 run; three
    planted faults; a sharded save at fsdp=2 restored into one process.
    Returns the counted launches of the runs (both ranks)."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.checkpoint import Checkpointer
    from dlrover_tpu_torch.checkpoint import shm_handler as sh
    from dlrover_tpu_torch.trainer import train_lib

    out_dir = os.path.join(REPO, "build", "train_mp2")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    sock_dir = tempfile.mkdtemp(prefix="mp2_socks_")
    saved_env = {k: os.environ.get(k) for k in ("DLROVER_TPU_JOB",
                                                "DLROVER_TPU_SOCKET_DIR")}
    os.environ["DLROVER_TPU_SOCKET_DIR"] = sock_dir
    job = f"mp2{os.getpid()}"
    cfg = _mp2_config()
    out = {"phase": "train_mp2",
           "model": f"llama-2 7b width (d_model 4096, 32 heads x 128, 32 KV "
                    f"heads, d_ff 11008 swiglu, vocab 32000, untied head, "
                    f"bf16 params and compute, flash_only), depth cut to "
                    f"{MP2_LAYERS} of 32 layers, random weights seed 0",
           "params": sum(int(np.prod(s)) for s in
                         train_lib._stacked_shapes(cfg).values()),
           "world": "2 processes on cuda:0, gloo (every collective staged "
                    "through the host by the axes' wires)",
           "batch": f"global {TRAIN_BATCH} x {TRAIN_SEQ}, one batch re-fed",
           "steps": MP2_STEPS,
           "tolerance": {"loss_atol": MP2_LOSS_ATOL,
                         "grad_norm_rtol": MP2_NORM_RTOL,
                         "param_rel": MP2_PARAM_RTOL,
                         "resident_share": MP2_RESIDENT_SHARE}}
    t_start = time.perf_counter()
    try:
        out["reference"] = {opt: _mp2_reference(opt, out_dir)
                            for opt in ("adafactor", "q8_adam")}
        os.environ["DLROVER_TPU_JOB"] = job
        results, codes = _world_run("_mp2_rank", out_dir,
                                    "mp_rank{rank}.pt", 600)
        errors = [r.get("error") for r in results if "error" in r]
        if errors or codes != [None, None]:
            for e in errors:
                print(e, flush=True)
            raise AssertionError(f"train_mp2 ranks failed (exit codes "
                                 f"{codes})")
        out["workers_s"] = time.perf_counter() - t_start
        r0, r1 = results
        out["backend"], out["worker_torch"] = r0["backend"], r0["torch"]
        shapes = train_lib._stacked_shapes(cfg)
        n_quant = sum(int(np.prod(v)) >= 4096 for v in shapes.values())
        runs, counts, bad = [], dict.fromkeys(_counts(), 0), []
        for a, b in zip(r0["runs"], r1["runs"]):
            ref = out["reference"][a["optimizer"]]
            losses = [s["loss"] for s in a["steps"]]
            norms = [s["grad_norm"] for s in a["steps"]]
            gaps = [abs(x - r) for x, r in zip(losses, ref["losses"])]
            ngaps = [abs(x - r) / r for x, r in zip(norms, ref["grad_norms"])]
            stats = _mp2_leaf_stats(a["leaf_sums"])
            limit = MP2_PARAM_RTOL[a["optimizer"]]
            worst = max((v[0], k) for k, v in stats.items())
            # Updates under half a bf16 ulp round away: the smallest
            # update a leaf keeps.
            smallest = min(((v[1], k) for k, v in stats.items() if v[1] > 0),
                           default=(0.0, None))
            rows = TRAIN_BATCH // a["batch"][1]
            predicted = _mp2_predicted_wire(cfg, a["parallel"],
                                            a["optimizer"], rows, TRAIN_SEQ)
            step = a["steps"][-1]
            want = {"flash_fwd": MP2_LAYERS, "flash_bwd_fused": MP2_LAYERS}
            if a["optimizer"] == "q8_adam":
                want["q8_adam"] = n_quant
            both = [s["launches"] for s in a["steps"] + b["steps"]]
            resident_share = max(a["resident_bytes"], b["resident_bytes"]) \
                / ref["resident_bytes"]
            ok = (max(gaps) <= MP2_LOSS_ATOL and max(ngaps) <= MP2_NORM_RTOL
                  and worst[0] <= limit and limit < smallest[0]
                  and all(x == want for x in both)
                  and all(s["tokens"] == TRAIN_BATCH * TRAIN_SEQ
                          for s in a["steps"])
                  and all(s["loss"] == t["loss"] for s, t in zip(
                      a["steps"], b["steps"]))
                  and step["wire_bytes"] == predicted
                  and b["steps"][-1]["wire_bytes"] == predicted
                  and ("fsdp" not in a["parallel"]
                       or resident_share <= MP2_RESIDENT_SHARE))
            for x in (a, b):
                for s in x["steps"]:
                    for k, v in s["launches"].items():
                        counts[k] += v
            run = {"key": a["key"], "ok": ok, "losses": losses,
                   "reference_losses": ref["losses"], "loss_gap": max(gaps),
                   "grad_norms": norms, "grad_norm_rgap": max(ngaps),
                   "worst_leaf_rel": worst, "smallest_update_rel": smallest,
                   "step_s": [[s["s"] for s in x["steps"]] for x in (a, b)],
                   "reference_step_s": ref["step_s"],
                   "build_s": [a["build_s"], b["build_s"]],
                   "launches_per_step_rank": step["launches"],
                   "wire_bytes_per_step": step["wire_bytes"],
                   "wire_bytes_predicted": predicted,
                   "staged_copies_per_step": step["staged"],
                   "resident_bytes": [a["resident_bytes"],
                                      b["resident_bytes"]],
                   "reference_resident_bytes": ref["resident_bytes"],
                   "resident_share": resident_share,
                   "memory_allocated": [a["memory_allocated"],
                                        b["memory_allocated"]],
                   "peak_memory_bytes": [a["peak_memory_bytes"],
                                         b["peak_memory_bytes"]],
                   "reference_peak_memory_bytes": ref["peak_memory_bytes"]}
            if "planted_unchanged_shard" in a:
                planted = _mp2_leaf_stats(a["planted_unchanged_shard"])
                run["planted_unchanged_shard_worst"] = max(
                    (v[0], k) for k, v in planted.items())
                if run["planted_unchanged_shard_worst"][0] <= limit:
                    bad.append(f"{a['key']}: planted unchanged shard passed")
            runs.append(run)
            if not ok:
                bad.append(a["key"])
        out["runs"] = runs
        ref = out["reference"]["adafactor"]
        planted = {}
        for fault, got in r0["planted"].items():
            stats = _mp2_leaf_stats(got["leaf_sums"])
            worst = max((v[0], k) for k, v in stats.items())
            loss_gap = abs(got["loss"] - ref["losses"][0])
            norm_gap = abs(got["grad_norm"] - ref["grad_norms"][0]) \
                / ref["grad_norms"][0]
            caught = (loss_gap > MP2_LOSS_ATOL or norm_gap > MP2_NORM_RTOL
                      or worst[0] > MP2_PARAM_RTOL["adafactor"])
            planted[fault] = {"loss_gap": loss_gap, "grad_norm_rgap":
                              norm_gap, "worst_leaf_rel": worst,
                              "caught": caught}
            if not caught:
                bad.append(f"planted {fault} passed")
        out["planted"] = planted
        out["save"] = [r0["save"], r1["save"]]
        if not (r0["save"]["saved"] and r1["save"]["saved"]):
            bad.append("save")

        # -- restore into one process on the card ----------------------
        dumps = [torch.load(os.path.join(out_dir, f"mp_pieces_r{r}.pt"),
                            weights_only=False) for r in range(2)]
        whole = _assemble_pieces(dumps)
        del dumps
        os.environ["DLROVER_TPU_JOB"] = f"{job}_restore"
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer("adafactor",
                                          learning_rate=TRAIN_LR),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
        template = train.init(seed=0).checkpoint_tree()
        t0 = time.perf_counter()
        ckpt = Checkpointer(os.path.join(out_dir, "mp_ckpt"), host_index=0,
                            num_hosts=1, device="cuda")
        step, tree = ckpt.load_checkpoint(state_template=template)
        restore_s = time.perf_counter() - t0
        ckpt.close()
        differ = [
            "".join(path) for path, leaf in sh.tree_flatten_with_path(tree)
            if not (_same_bits(leaf.cpu(), whole[path])
                    if isinstance(leaf, torch.Tensor)
                    else leaf == whole[path])]
        out["restore"] = {"step": step, "seconds": restore_s,
                          "leaves": len(whole), "leaves_differing":
                          differ[:8], "saved_by_ranks": 2,
                          "restored_into_processes": 1}
        if step != 1 or differ:
            bad.append("restore")
        del tree, template, train, whole
        torch.cuda.empty_cache()
        out["launches"] = counts
        out["phase_s"] = time.perf_counter() - t_start
        if bad:
            raise AssertionError(f"train_mp2 checks failed: {bad}")
    finally:
        emit(out)
        for name in os.listdir("/dev/shm"):
            if name.startswith(f"dlrover_tpu_ckpt_{job}"):
                os.unlink(os.path.join("/dev/shm", name))
        shutil.rmtree(sock_dir, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts


def train_split_and_check():
    """Reduced depth, ``flash_block_kv=512``: the split backward path."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib

    cfg = gpt2_config("1.5b", num_layers=SPLIT_LAYERS, attention_impl="flash",
                      remat="flash_only", param_dtype=torch.bfloat16,
                      flash_block_kv=SPLIT_BLOCK_KV)
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda",
    )
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    per_step = _per_step(flash_fwd=SPLIT_LAYERS, flash_bwd_dq=SPLIT_LAYERS,
                         flash_bwd_dkv=SPLIT_LAYERS)
    _zero_counts()
    state, warm_losses, warm_s = _train_steps(train, state, batch,
                                              TRAIN_WARMUP, per_step)
    state, losses, seconds = _train_steps(train, state, batch, TRAIN_STEPS,
                                          per_step)
    counts = _counts()
    emit({"phase": "train_split", "layers": SPLIT_LAYERS,
          "flash_block_kv": SPLIT_BLOCK_KV,
          "losses": warm_losses + losses, "warmup_step_s": warm_s,
          "step_s": seconds, "step_s_median": statistics.median(seconds),
          "launches": counts, "launches_per_step": per_step})
    del state, train, batch
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def _flash_through_reference():
    """Swap the flash forward and backward kernels for their plain
    versions (fp32 math from the same bf16 inputs) while the block runs:
    the training model's op calls these module functions."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    kernel_fwd, kernel_bwd = fa.flash_fwd, fa.flash_bwd

    def reference_fwd(q, k, v, *, causal=True, seg_q=None, seg_kv=None,
                      scale=None, **_):
        return fa.mha_reference(q, k, v, causal=causal, seg_q=seg_q,
                                seg_kv=seg_kv, scale=scale)

    def reference_bwd(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                      seg_kv=None, scale=None, **_):
        return fa.mha_backward_reference(q, k, v, o, lse, do, causal=causal,
                                         seg_q=seg_q, seg_kv=seg_kv,
                                         scale=scale)

    fa.flash_fwd, fa.flash_bwd = reference_fwd, reference_bwd
    try:
        yield
    finally:
        fa.flash_fwd, fa.flash_bwd = kernel_fwd, kernel_bwd


@contextlib.contextmanager
def _planted_backward_fault(first_tile, fraction):
    """Swap in a faulty backward while the block runs: the kernels'
    gradients less ``fraction`` of the diagonal tiles' share from tile
    ``first_tile`` on (``diagonal_tiles``), as a kernel that skipped or
    half-counted them would give."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    kernel_bwd = fa.flash_bwd

    def faulty_bwd(q, k, v, o, lse, do, *, causal=True, seg_q=None,
                   seg_kv=None, scale=None, fused=True):
        if seg_q is not None:
            raise ValueError("the planted fault takes no segment ids")
        grads = kernel_bwd(q, k, v, o, lse, do, causal=causal, scale=scale,
                           fused=fused)
        lost = diagonal_tiles(q, k, v, o, lse, do, causal=causal,
                              first_tile=first_tile)
        return tuple((g.float() - fraction * x).to(g.dtype)
                     for g, x in zip(grads, lost))

    fa.flash_bwd = faulty_bwd
    try:
        yield
    finally:
        fa.flash_bwd = kernel_bwd


def _grad_gap(grads, ref):
    """How far ``grads`` is from ``ref``: the global norms' relative gap,
    and per parameter the cosine and ``||g - r|| / ||r||``, worst each."""
    def norm(tree):
        return float(torch.sqrt(sum(g.square().sum() for g in tree.values())))

    g_norm, r_norm = norm(grads), norm(ref)
    names = [n for n in ref if float(ref[n].abs().max()) > 0]
    cos = {n: float(F.cosine_similarity(grads[n].flatten(),
                                        ref[n].flatten(), dim=0))
           for n in names}
    rel = {n: float(torch.linalg.vector_norm(grads[n] - ref[n])
                    / torch.linalg.vector_norm(ref[n])) for n in names}
    worst_cos, worst_rel = min(cos, key=cos.get), max(rel, key=rel.get)
    return {
        "grad_norm": g_norm, "grad_norm_reference": r_norm,
        "grad_norm_rel_diff": abs(g_norm - r_norm) / r_norm,
        "min_grad_cosine": cos[worst_cos], "min_grad_cosine_param": worst_cos,
        "max_grad_rel_err": rel[worst_rel],
        "max_grad_rel_err_param": worst_rel,
        "params_compared": len(names),
    }


def _parity_ok(loss_diff, gap, limits=None) -> bool:
    """``limits``: (loss atol, grad-norm rtol, lowest cosine, per-parameter
    rtol); the dense parity's by default."""
    loss_atol, norm_rtol, min_cosine, param_rtol = limits or (
        PARITY_LOSS_ATOL, PARITY_NORM_RTOL, PARITY_MIN_COSINE,
        PARITY_PARAM_RTOL)
    return (loss_diff <= loss_atol
            and gap["grad_norm_rel_diff"] <= norm_rtol
            and gap["min_grad_cosine"] >= min_cosine
            and gap["max_grad_rel_err"] <= param_rtol)


def train_parity():
    from dlrover_tpu_torch.models import gpt2_config, init_params
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.trainer import train_lib

    cfg = gpt2_config("1.5b", num_layers=PARITY_LAYERS,
                      attention_impl="flash", remat="flash_only",
                      param_dtype=torch.bfloat16)
    model = TransformerLM(cfg, device="cuda")
    model.load_state_dict(init_params(cfg, seed=0, device="cuda"))
    batch = _train_batch(cfg.vocab_size, PARITY_BATCH)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        logits, aux = model.forward_aux(batch["inputs"])
        loss, _ = train_lib.cross_entropy_loss(logits, batch["targets"])
        (loss + aux).backward()
        return loss.item(), {n: p.grad.float().clone()
                             for n, p in model.named_parameters()}

    before = _counts()
    k_loss, k_grads = loss_and_grads()
    after = _counts()
    if after["flash_fwd"] == before["flash_fwd"] or (
            after["flash_bwd_fused"] == before["flash_bwd_fused"]):
        raise AssertionError("the kernel leg of the parity ran no kernel")
    with _flash_through_reference():
        r_loss, r_grads = loss_and_grads()
    if _counts() != after:
        raise AssertionError("the reference leg launched a kernel")
    gap = _grad_gap(k_grads, r_grads)
    out = {
        "phase": "train_parity", "layers": PARITY_LAYERS,
        "batch": PARITY_BATCH, "seq": TRAIN_SEQ,
        "loss_kernel": k_loss, "loss_reference": r_loss,
        "loss_abs_diff": abs(k_loss - r_loss), **gap,
        "limits": {"loss_atol": PARITY_LOSS_ATOL,
                   "grad_norm_rtol": PARITY_NORM_RTOL,
                   "min_grad_cosine": PARITY_MIN_COSINE,
                   "max_grad_rel_err": PARITY_PARAM_RTOL},
    }
    out["ok"] = _parity_ok(out["loss_abs_diff"], gap)
    # The same check on planted backward faults: each must fail it.
    faults = {}
    for name, first_row, fraction in PARITY_FAULTS:
        with _planted_backward_fault(first_row // fa.MASK_TILE, fraction):
            f_loss, f_grads = loss_and_grads()
        f_gap = _grad_gap(f_grads, r_grads)
        faults[name] = {k_: f_gap[k_] for k_ in (
            "grad_norm_rel_diff", "min_grad_cosine", "max_grad_rel_err",
            "max_grad_rel_err_param")}
        faults[name]["caught"] = not _parity_ok(abs(f_loss - r_loss), f_gap)
        del f_grads
    out["planted_faults"] = faults
    emit(out)
    if not out["ok"] or not all(f["caught"] for f in faults.values()):
        raise AssertionError(f"train parity failed: {out}")
    del model
    torch.cuda.empty_cache()


# -- MoE training ---------------------------------------------------------------


# -- the expert axis -------------------------------------------------------------

#: ``train_ep2``: ``bench.py``'s MoE entry at full width (``moe_config``:
#: d_model 1600, 25 heads of 64, vocab 50304, 8 experts top-2 of d_ff
#: 3200, capacity factor 1.25, gelu, bf16 parameters and compute,
#: flash_only) with its depth cut to this many of 48 layers, trained on two
#: processes of the one card at each mesh of ``EP2_RUNS``, each run against
#: the world-1 run of the same config, init and batch in one process.
EP2_LAYERS = 2
EP2_STEPS = 2
#: (key, mesh, the run's dispatch, the world-1 run's dispatch): the a2a
#: exchanges re-transport the einsum dispatch's math; the grouped
#: dispatch at data=2 is held to its own world-1 run.
EP2_RUNS = (
    ("expert2_a2a", dict(data=1, expert=2), "a2a", "einsum"),
    ("expert2_a2a_int8", dict(data=1, expert=2), "a2a_int8", "einsum"),
    ("data2_grouped", dict(data=2), "grouped", "grouped"),
)
#: Planted on the expert2_a2a run, one step each: the dispatch leg sends
#: each chunk back to its own rank (every slot of a rank's experts holds
#: its own rows), and the router's top-1 density is left unreduced over
#: the batch group (each rank's aux loss from its own rows).
EP2_FAULTS = ("dispatch_to_self", "density_local")
# fp limits (the a2a and grouped runs): a rank gates its own 8 rows, so
# the router's means are the group's average of two halves (fp32, another
# order), and the trunk's bf16 products run at 8 rows, not 16: a product
# may round its last bit otherwise, and a token near a tie may take
# another expert (a capacity slot moves with it), which moves the expert
# gradients by a whole token's share.  The first limits (loss 5e-4, grad
# norm 5e-4, aux 1e-4, leaves 3e-5, statistics 2e-3) were set before any
# reading; two sound runs of the phase on an H100 then read (PERF.md)
# loss gaps of at most 8.5e-5, grad-norm gaps of 2.1e-3 (the second
# step: rerouted tokens; the flash backward's atomic sums make the bits
# of a step, and so the ties, vary from call to call), aux gaps of
# 2.9e-4, leaves drawn at init 1.1e-5 of their norm (smallest kept
# update 4.2e-5) and statistics 3.6e-7 apart.  Limits about 3x those:
# loss 2.5e-4, grad norm 6.5e-3, aux 1e-3, leaves 3e-5 (below the
# smallest update: a dropped one fails), statistics 5e-5 (below one
# rerouted choice's share of a layer's load, 3e-5 a layer over two).
# The key slice of the fused qkv bias is left out of the leaves, as
# ``_leaf_errors`` leaves it out.  And each rank's own aux loss at init
# (its forward, before the batch group's sum of the step's metrics) must
# be the group's: bit-equal on both ranks and within the aux limit of
# the world-1 run's; a rank whose density is its own fails that (the
# step's metric, the ranks' mean, cannot show it: the aux is linear in
# the density).
EP2_LOSS_ATOL, EP2_NORM_RTOL, EP2_AUX_RTOL = 2.5e-4, 6.5e-3, 1e-3
EP2_PARAM_RTOL, EP2_STATS_ATOL = 3e-5, 5e-5
# int8 (a2a_int8): each leg rounds a value to its block's step (absmax /
# 127, at most half of it off), forward and backward, so the expert
# inputs, outputs and their gradients move by up to 0.4% of their block's
# largest value, and a token's routing in the next layer may change.
# Limits: the loss within |ref_t - ref_0| + 0.05 and the grad norm within
# |g_t - g_0| / g_t + 5% (the distance the reference itself moved plus
# the rounding's own effect, as ``DP2_INT8_*``); the aux loss within 1e-2
# relative and the statistics within 1e-2 (a few percent of the second
# layer's tokens rerouted); every leaf within ``U + P + 2^-7 B`` of the
# reference's (``DP2_*``: U its largest total update, P Adafactor's path
# bound of an unfactored leaf, else U; the parameters' own bf16 rounding,
# no all-gather here).
EP2_INT8_LOSS_ATOL, EP2_INT8_NORM_RTOL = 0.05, 0.05
EP2_INT8_AUX_RTOL, EP2_INT8_STATS_ATOL = 1e-2, 1e-2


def _ep2_config(dispatch, layers=EP2_LAYERS):
    return moe_config(num_layers=layers, moe_dispatch=dispatch)


def _optimizer_wire(stacked, sizes, opt, out):
    """The fp32 sums ``optax_ports.sharded_update`` completes over the
    axes that split a leaf, into ``out`` by axis: the step's grad norm and
    the clip's, and for Adafactor its factored means over split
    dimensions, its row factor's mean and two block mean squares."""
    from dlrover_tpu_torch.optimizers.optax_ports import _factored_dims

    def reduce_many(parts):
        for axes_of, numel in parts:
            for a in axes_of:
                out[f"{a}/all_reduce"] += 4 * numel

    groups = collections.Counter()
    for lay in stacked.values():
        if lay.axes:
            groups[lay.axes] += 1
    reduce_many([(a, 1) for a in groups] * 2)
    if opt != "adafactor":
        return
    means, rows_mean = [], []
    for lay in stacked.values():
        dims = _factored_dims(lay.shape, True, 128)
        if dims is None:
            continue
        d1, d0 = dims
        shape = lay.local_shape(sizes)
        for d in (d0, d1):
            if lay.dim_axes(d):
                means.append((lay.dim_axes(d),
                              int(np.prod(shape)) // shape[d]))
        if lay.dim_axes(d1):
            rows_mean.append((lay.dim_axes(d1), int(np.prod(shape))
                              // shape[d0] // shape[d1]))
    for parts in (means, rows_mean):
        merged = collections.Counter()
        for a, n in parts:
            merged[a] += n
        reduce_many(list(merged.items()))
    reduce_many(list(groups.items()) * 2)


def _ep2_predicted_wire(cfg, parallel, rows, seq):
    """The bytes one Adafactor step of one rank (one microbatch,
    ``flash_only``) hands to each axis's wire, by leg, from the shapes
    alone: on the expert axis, per layer six all-to-all legs of the rank's
    ``[E, rows, C, D]`` expert inputs (dispatch and combine in the
    forward, again in the recompute, and the backward's two inverse
    exchanges), in the compute dtype or, for ``a2a_int8``, as
    ``a2a_wire_bytes`` prices them; on each batch axis, the router's
    means (density and mean probability, ``2 E`` fp32) per layer in the
    forward and in the recompute, the token count (4 bytes) and the loss
    and aux sums (8), and the gradients of the leaves the axis leaves
    whole in the parameter dtype (the expert axis: the trunk and the
    routers; the data axis: every leaf); and the optimizer's sums over the
    expert leaves (:func:`_optimizer_wire`)."""
    from dlrover_tpu_torch.models.transformer import (
        TransformerLM,
        param_logical_axes,
        stacked_logical_axes,
    )
    from dlrover_tpu_torch.parallel import quantized_collectives as qc
    from dlrover_tpu_torch.parallel import rules as lr
    from dlrover_tpu_torch.parallel import sharding
    from dlrover_tpu_torch.runtime import mesh as mesh_lib
    from dlrover_tpu_torch.trainer import train_lib

    sizes = dict.fromkeys(mesh_lib.MESH_AXES, 1)
    sizes.update(parallel)
    stacked = sharding.leaf_layouts(
        stacked_logical_axes(param_logical_axes(
            TransformerLM(cfg, device="meta"))),
        train_lib._stacked_shapes(cfg), lr.DEFAULT_RULES, sizes)
    item = torch.empty((), dtype=cfg.param_dtype).element_size()
    out = collections.Counter()
    e, layers = cfg.num_experts, cfg.num_layers
    cap = max(1, int(cfg.capacity_factor * seq * cfg.top_k / e))
    if sizes["expert"] > 1:
        leg = e * rows * cap * cfg.d_model
        per = (qc.a2a_wire_bytes(leg, "int8") if cfg.moe_dispatch ==
               "a2a_int8" else leg * torch.empty(
                   (), dtype=cfg.dtype).element_size())
        out["expert/all_to_all"] += 6 * layers * per
    for axis in ("data", "expert"):
        if sizes[axis] <= 1:
            continue
        out[f"{axis}/all_reduce"] += 2 * layers * 2 * e * 4 + 4 + 8
        whole = sum(int(np.prod(lay.local_shape(sizes)))
                    for lay in stacked.values() if axis not in lay.axes)
        out[f"{axis}/all_reduce"] += whole * item
    _optimizer_wire(stacked, sizes, "adafactor", out)
    return dict(out)


def _ep2_per_step(cfg):
    """Launches a step and rank (``flash_only``): the flash forward once a
    layer (saved) and the fused backward once; on the int8 wire one K5a
    and one K5b a leg (six legs a layer); the grouped dispatch's K8 and
    K9 as ``_moe_per_step``."""
    n = cfg.num_layers
    want = {"flash_fwd": n, "flash_bwd_fused": n}
    if cfg.moe_dispatch == "a2a_int8":
        want.update(quantize=6 * n, dequantize=6 * n)
    if cfg.moe_dispatch == "grouped":
        want.update(gmm_fwd=6 * n, gmm_dw=2 * n)
    return want


def _ep2_reference(dispatch, out_dir):
    """The world-1 run: one process, the whole batch, no mesh; the router
    statistics at init, its parameters after step 1 and after the last,
    and each stacked leaf's rms before each step."""
    from dlrover_tpu_torch.trainer import train_lib

    cfg = _ep2_config(dispatch)
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    stats = train_lib.build_moe_stats_fn(train)(state, batch).tolist()
    losses, norms, auxes, seconds, rms, params1 = [], [], [], [], [], None
    for _ in range(EP2_STEPS):
        rms.append(_stacked_rms(state.params()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train.step(state, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        auxes.append(float(m["aux_loss"]))
        seconds.append(time.perf_counter() - t0)
        if params1 is None:
            params1 = {k: v.to("cpu", copy=True)
                       for k, v in state.params().items()}
    params = {k: v.cpu() for k, v in state.params().items()}
    torch.save({"params": params, "params1": params1},
               os.path.join(out_dir, f"ep_ref_{dispatch}.pt"))
    out = {"losses": losses, "grad_norms": norms, "aux_losses": auxes,
           "stats": stats, "step_s": seconds,
           "path_bound": _adafactor_paths(cfg, rms)}
    del state, train, batch, params, params1
    torch.cuda.empty_cache()
    return out


def _ep2_leaf_stats(train, state, ref, init):
    """Per parameter, over this rank's boxes it writes (replica 0), summed
    over the world: the squared distance to the reference's parameters,
    the reference's squared norm and squared update; and maxed over it:
    the largest distance, the reference's largest total update, its
    largest value and the init's.  ``{name: [7 floats]}``."""
    import torch.distributed as dist

    layout = train.param_layout()
    params = state.params()
    names = sorted(params)
    sums = torch.zeros((len(names), 3), dtype=torch.float64)
    maxes = torch.zeros((len(names), 4), dtype=torch.float64)
    for i, name in enumerate(names):
        spot = layout[name]
        if spot.replica_id != 0:
            continue
        box = tuple(slice(b, e) for b, e in spot.index)
        w = ref[name][box].to("cuda").double()
        i0, g = init[name].double(), params[name].double()
        if name.endswith("attn.qkv.bias"):
            # The key slice: its gradient is zero in exact arithmetic
            # (``_leaf_errors``).
            keep = torch.ones(w.shape, dtype=torch.bool, device=w.device)
            keep[..., 64:128] = False
            w, i0, g = w[keep], i0[keep], g[keep]
        sums[i] = torch.stack([(g - w).square().sum(), w.square().sum(),
                               (w - i0).square().sum()]).cpu()
        maxes[i] = torch.stack([(g - w).abs().max(), (w - i0).abs().max(),
                                w.abs().max(), i0.abs().max()]).cpu()
    dist.all_reduce(sums)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX)
    return {n: [float(x) for x in s] + [float(x) for x in m]
            for n, s, m in zip(names, sums, maxes)}


@contextlib.contextmanager
def _ep2_planted(fault):
    """``dispatch_to_self``: the dispatch leg gives every member's slot of
    this rank's experts its own chunk; ``density_local``: the top-1
    density is not reduced over the batch group."""
    from dlrover_tpu_torch.models import moe

    exchange, means = moe._exchange, moe._group_means

    def to_self(x, wire, split_axis, concat_axis, int8):
        if split_axis != 0:
            return exchange(x, wire, split_axis, concat_axis, int8)
        own = x.reshape((wire.size, x.shape[0] // wire.size)
                        + tuple(x.shape[1:]))[wire.rank]
        return torch.cat([own] * wire.size, dim=concat_axis)

    def local_density(density, proxy, group):
        return density, group.mean(proxy)

    if fault == "dispatch_to_self":
        moe._exchange = to_self
    else:
        moe._group_means = local_density
    try:
        yield
    finally:
        moe._exchange, moe._group_means = exchange, means


def _ep2_rank_aux(state, placed):
    """This rank's own aux loss at ``state``: a forward of its rows with
    no gradient (the step's metric is the batch group's mean)."""
    with torch.no_grad():
        _, aux = state.model.forward_aux(placed["inputs"])
    return float(aux)


def _ep2_rank(rank, out_dir):
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_lib

    out = {"rank": rank, "runs": [], "planted": {},
           "backend": dist.get_backend(), "torch": torch.__version__}
    refs, meshes = {}, {}
    for key, par, dispatch, ref_dispatch in EP2_RUNS:
        if ref_dispatch not in refs:
            refs.clear()
            refs[ref_dispatch] = torch.load(
                os.path.join(out_dir, f"ep_ref_{ref_dispatch}.pt"),
                weights_only=False)
        ref = refs[ref_dispatch]
        name = "x".join(f"{a}{n}" for a, n in par.items())
        if name not in meshes:
            meshes[name] = build_mesh(ParallelConfig(**par),
                                      device_type="cuda")
        cfg = _ep2_config(dispatch)
        batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
        t_build = time.perf_counter()
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer("adafactor",
                                          learning_rate=TRAIN_LR),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
            mesh=meshes[name], device="cuda")
        state = train.init(seed=0)
        build_s = time.perf_counter() - t_build
        init = {k: v.clone() for k, v in state.params().items()}
        placed = train_lib.shard_batch(batch, train)
        stats_fn = train_lib.build_moe_stats_fn(train)
        stats = stats_fn(state, placed).tolist()
        aux_init = _ep2_rank_aux(state, placed)
        steps = []
        for _ in range(EP2_STEPS):
            _zero_counts()
            wire_lib.reset_counts()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train.step(state, placed)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            steps.append({
                "s": time.perf_counter() - t0, "loss": loss,
                "grad_norm": norm, "aux_loss": float(m["aux_loss"]),
                "tokens": float(m["tokens"]),
                "launches": {k: v for k, v in _counts().items() if v},
                "wire_bytes": dict(wire_lib.COUNTS["axes"]),
                "staged": dict(wire_lib.COUNTS["staged_axes"])})
        run = {"key": key, "parallel": par, "dispatch": dispatch,
               "steps": steps, "build_s": build_s, "stats": stats,
               "aux_init": aux_init,
               "batch": (train.batch_rank, train.batch_ranks),
               "expert_shape": tuple(state.model.blocks[0].moe.wi.shape),
               "leaf_stats": _ep2_leaf_stats(train, state, ref["params"],
                                             init)}
        out["runs"].append(run)
        if key == "expert2_a2a":
            for fault in EP2_FAULTS:
                state = train.init(seed=0)
                with _ep2_planted(fault):
                    got = stats_fn(state, placed).tolist()
                    aux = _ep2_rank_aux(state, placed)
                    state, m = train.step(state, placed)
                out["planted"][fault] = {
                    "aux_init": aux, "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "aux_loss": float(m["aux_loss"]), "stats": got,
                    "leaf_stats": _ep2_leaf_stats(train, state,
                                                  ref["params1"], init)}
        del state, train, placed, init
        torch.cuda.empty_cache()
    return out


def _ep2_leaf_errors(leaf_stats):
    """Per leaf: the norm-relative error against the reference, the
    reference's update relative to its norm, and whether it started at
    zero (its init's largest value 0)."""
    return {n: (float(np.sqrt(s[0] / max(s[1], 1e-60))),
                float(np.sqrt(s[2] / max(s[1], 1e-60))), s[6] == 0.0)
            for n, s in leaf_stats.items()}


def _ep2_int8_ok(leaf_stats, paths):
    """The a2a_int8 run's parameter bound (see ``EP2_*``): each leaf's
    largest distance within ``U + P + 2^-7 B``; and the worst ratio."""
    from dlrover_tpu_torch.trainer.train_lib import _block_leaf

    worst = (0.0, None)
    for name, s in leaf_stats.items():
        diff, moved, big, init_max = s[3:]
        path = max(moved, paths.get(_block_leaf(name), moved))
        b = max(big, init_max + path)
        ratio = diff / max(moved + path + 2.0 ** -7 * b, 1e-30)
        worst = max(worst, (ratio, name))
    return worst[0] <= 1.0, worst


def _ep2_fp_ok(stats, limit):
    """The fp runs' parameter limit: every leaf drawn at init within
    ``limit`` of its norm (a leaf that starts at zero is all update, at
    rounding-noise level where its gradient is: within ``DP2_FP_ZERO_
    INIT_RTOL``, as ``train_dp2``'s); and the worst leaf."""
    worst = max(((v[0], k) for k, v in stats.items() if not v[2]),
                default=(0.0, None))
    zero = max(((v[0], k) for k, v in stats.items() if v[2]),
               default=(0.0, None))
    return (worst[0] <= limit and zero[0] <= DP2_FP_ZERO_INIT_RTOL,
            worst, zero)


def train_ep2_and_check():
    """Two processes on ``cuda:0`` over a gloo group: the MoE step at
    bench.py's MoE width on an ``expert=2`` mesh with the a2a and the
    a2a_int8 dispatch and on a ``data=2`` mesh with the grouped dispatch,
    each held against the world-1 run (einsum for the exchanges, grouped
    for grouped), with the router statistics; two planted faults.
    Returns the counted launches of the runs (both ranks)."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.trainer import train_lib

    out_dir = os.path.join(REPO, "build", "train_ep2")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    sock_dir = tempfile.mkdtemp(prefix="ep2_socks_")
    saved_env = {k: os.environ.get(k) for k in ("DLROVER_TPU_JOB",
                                                "DLROVER_TPU_SOCKET_DIR")}
    os.environ["DLROVER_TPU_SOCKET_DIR"] = sock_dir
    job = f"ep2{os.getpid()}"
    cfg = _ep2_config("einsum")
    out = {"phase": "train_ep2",
           "model": f"gpt2-1.5b MoE width (bench.py's moe entry: d_model "
                    f"1600, 25 heads x 64, vocab 50304, {MOE_EXPERTS} "
                    f"experts top-{MOE_TOP_K} of d_ff {MOE_D_FF}, capacity "
                    f"factor {MOE_CAPACITY}, gelu, bf16 params and compute, "
                    f"flash_only), depth cut to {EP2_LAYERS} of 48 layers, "
                    f"random weights seed 0",
           "params": sum(int(np.prod(s)) for s in
                         train_lib._stacked_shapes(cfg).values()),
           "world": "2 processes on cuda:0, gloo (every collective staged "
                    "through the host by the axes' wires)",
           "batch": f"global {TRAIN_BATCH} x {TRAIN_SEQ}, one batch re-fed",
           "optimizer": f"adafactor lr {TRAIN_LR}, clip 1.0",
           "steps": EP2_STEPS,
           "tolerance": {
               "fp": {"loss_atol": EP2_LOSS_ATOL,
                      "grad_norm_rtol": EP2_NORM_RTOL,
                      "aux_rtol": EP2_AUX_RTOL,
                      "param_rel": EP2_PARAM_RTOL,
                      "zero_init_param_rel": DP2_FP_ZERO_INIT_RTOL,
                      "stats_atol": EP2_STATS_ATOL},
               "int8": {"loss": f"|ref_t - ref_0| + {EP2_INT8_LOSS_ATOL}",
                        "grad_norm": "|g_t - g_0| / g_t + "
                                     f"{EP2_INT8_NORM_RTOL}",
                        "aux_rtol": EP2_INT8_AUX_RTOL,
                        "stats_atol": EP2_INT8_STATS_ATOL,
                        "param": "max|p - p_ref| <= U + P + 2^-7 B"}}}
    t_start = time.perf_counter()
    try:
        out["reference"] = {d: _ep2_reference(d, out_dir)
                            for d in ("einsum", "grouped")}
        os.environ["DLROVER_TPU_JOB"] = job
        results, codes = _world_run("_ep2_rank", out_dir,
                                    "ep_rank{rank}.pt", 600)
        errors = [r.get("error") for r in results if "error" in r]
        if errors or codes != [None, None]:
            for e in errors:
                print(e, flush=True)
            raise AssertionError(f"train_ep2 ranks failed (exit codes "
                                 f"{codes})")
        out["workers_s"] = time.perf_counter() - t_start
        r0, r1 = results
        out["backend"], out["worker_torch"] = r0["backend"], r0["torch"]
        runs, counts, bad = [], dict.fromkeys(_counts(), 0), []
        for a, b in zip(r0["runs"], r1["runs"]):
            ref_dispatch = next(r[3] for r in EP2_RUNS if r[0] == a["key"])
            ref = out["reference"][ref_dispatch]
            int8 = a["dispatch"] == "a2a_int8"
            losses = [s["loss"] for s in a["steps"]]
            norms = [s["grad_norm"] for s in a["steps"]]
            auxes = [s["aux_loss"] for s in a["steps"]]
            gaps = [abs(x - r) for x, r in zip(losses, ref["losses"])]
            ngaps = [abs(x - r) / r for x, r in zip(norms, ref["grad_norms"])]
            agaps = [abs(x - r) / r for x, r in zip(auxes, ref["aux_losses"])]
            sgap = max(abs(x - r) for x, r in zip(a["stats"], ref["stats"]))
            stats = _ep2_leaf_errors(a["leaf_stats"])
            smallest = min(((v[1], k) for k, v in stats.items() if v[1] > 0),
                           default=(0.0, None))
            if int8:
                loss_ok = all(g <= abs(r - ref["losses"][0])
                              + EP2_INT8_LOSS_ATOL
                              for g, r in zip(gaps, ref["losses"]))
                norm_ok = all(g <= abs(r - ref["grad_norms"][0]) / r
                              + EP2_INT8_NORM_RTOL
                              for g, r in zip(ngaps, ref["grad_norms"]))
                aux_ok = max(agaps) <= EP2_INT8_AUX_RTOL
                stats_ok = sgap <= EP2_INT8_STATS_ATOL
                params_ok, worst = _ep2_int8_ok(a["leaf_stats"],
                                                ref["path_bound"])
                zero = None
            else:
                loss_ok = max(gaps) <= EP2_LOSS_ATOL
                norm_ok = max(ngaps) <= EP2_NORM_RTOL
                aux_ok = max(agaps) <= EP2_AUX_RTOL
                stats_ok = sgap <= EP2_STATS_ATOL
                params_ok, worst, zero = _ep2_fp_ok(stats, EP2_PARAM_RTOL)
            aux_init_ok = (a["aux_init"] == b["aux_init"] and abs(
                a["aux_init"] - ref["aux_losses"][0]) <= (
                    EP2_INT8_AUX_RTOL if int8 else EP2_AUX_RTOL)
                * ref["aux_losses"][0])
            rcfg = _ep2_config(a["dispatch"])
            rows = TRAIN_BATCH // a["batch"][1]
            predicted = _ep2_predicted_wire(rcfg, a["parallel"], rows,
                                            TRAIN_SEQ)
            want = _ep2_per_step(rcfg)
            both = [s["launches"] for s in a["steps"] + b["steps"]]
            experts = MOE_EXPERTS // a["parallel"].get("expert", 1)
            ok = (loss_ok and norm_ok and aux_ok and stats_ok and params_ok
                  and aux_init_ok and all(x == want for x in both)
                  and all(s["tokens"] == TRAIN_BATCH * TRAIN_SEQ
                          for s in a["steps"])
                  and all(s["loss"] == t["loss"] for s, t in zip(
                      a["steps"], b["steps"]))
                  and a["stats"] == b["stats"]
                  and a["expert_shape"][0] == experts
                  and all(s["wire_bytes"] == predicted
                          for s in a["steps"] + b["steps"]))
            for x in (a, b):
                for s in x["steps"]:
                    for k, v in s["launches"].items():
                        counts[k] += v
            runs.append({
                "key": a["key"], "ok": ok, "losses": losses,
                "reference_losses": ref["losses"], "loss_gap": max(gaps),
                "grad_norms": norms, "grad_norm_rgap": max(ngaps),
                "aux_losses": auxes, "aux_rgap": max(agaps),
                "aux_init_ranks": [a["aux_init"], b["aux_init"]],
                "stats": a["stats"], "reference_stats": ref["stats"],
                "stats_gap": sgap,
                "worst_leaf": worst, "worst_zero_init_leaf": zero,
                "smallest_update_rel": smallest,
                "experts_a_rank": a["expert_shape"][0],
                "step_s": [[s["s"] for s in x["steps"]] for x in (a, b)],
                "reference_step_s": ref["step_s"],
                "build_s": [a["build_s"], b["build_s"]],
                "launches_per_step_rank": a["steps"][-1]["launches"],
                "launches_predicted": want,
                "wire_bytes_per_step": a["steps"][-1]["wire_bytes"],
                "wire_bytes_predicted": predicted,
                "staged_copies_per_step": a["steps"][-1]["staged"]})
            if not ok:
                bad.append(a["key"])
        out["runs"] = runs
        ref = out["reference"]["einsum"]
        planted = {}
        for fault, got in r0["planted"].items():
            other = r1["planted"][fault]["aux_init"]
            aux_init_ok = (got["aux_init"] == other and abs(
                got["aux_init"] - ref["aux_losses"][0])
                <= EP2_AUX_RTOL * ref["aux_losses"][0])
            stats = _ep2_leaf_errors(got["leaf_stats"])
            loss_gap = abs(got["loss"] - ref["losses"][0])
            norm_gap = abs(got["grad_norm"] - ref["grad_norms"][0]) \
                / ref["grad_norms"][0]
            aux_gap = abs(got["aux_loss"] - ref["aux_losses"][0]) \
                / ref["aux_losses"][0]
            sgap = max(abs(x - r) for x, r in zip(got["stats"],
                                                  ref["stats"]))
            params_ok, worst, _ = _ep2_fp_ok(stats, EP2_PARAM_RTOL)
            caught = (loss_gap > EP2_LOSS_ATOL or norm_gap > EP2_NORM_RTOL
                      or aux_gap > EP2_AUX_RTOL or sgap > EP2_STATS_ATOL
                      or not params_ok or not aux_init_ok)
            planted[fault] = {"aux_init_ranks": [got["aux_init"], other],
                              "loss_gap": loss_gap, "grad_norm_rgap":
                              norm_gap, "aux_rgap": aux_gap,
                              "stats_gap": sgap, "worst_leaf": worst,
                              "caught": caught}
            if not caught:
                bad.append(f"planted {fault} passed")
        out["planted"] = planted
        out["launches"] = counts
        out["phase_s"] = time.perf_counter() - t_start
        if bad:
            raise AssertionError(f"train_ep2 checks failed: {bad}")
    finally:
        emit(out)
        shutil.rmtree(sock_dir, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts


def moe_config(**overrides):
    """``bench.py``'s MoE entry on the port (bench.py:367-376) with the
    dropless grouped dispatch in place of its einsum (``overrides`` may
    name another)."""
    from dlrover_tpu_torch.models import gpt2_config

    return gpt2_config(
        "1.5b", attention_impl="flash", remat="flash_only",
        param_dtype=torch.bfloat16, num_experts=MOE_EXPERTS,
        top_k=MOE_TOP_K, capacity_factor=MOE_CAPACITY, d_ff=MOE_D_FF,
        **{"moe_dispatch": "grouped", **overrides})


def _moe_per_step(cfg):
    """Launches per MoE step under ``flash_only``: per layer the flash
    forward once (saved) and the fused backward once; K8 for each of the
    two expert products (gelu: wi, wo) in the forward, again in the
    recompute and once for dx; K9 once per product."""
    n_layers, products = cfg.num_layers, 3 if cfg.activation == "swiglu" else 2
    return _per_step(flash_fwd=n_layers, flash_bwd_fused=n_layers,
                     gmm_fwd=3 * products * n_layers,
                     gmm_dw=products * n_layers)


def _memory_split(train, state, batch):
    """One step with the peak read twice: up to the optimizer update
    (forward, backward, the stacked gradients) and inside it."""
    update = train.optimizer.update
    marks = {}

    def spy(grads, opt_state, params):
        marks["forward_backward_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = update(grads, opt_state, params)
        marks["update_peak_bytes"] = torch.cuda.max_memory_allocated()
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train.optimizer = train.optimizer._replace(update=spy)
    try:
        state, _ = train.step(state, batch)
    finally:
        train.optimizer = train.optimizer._replace(update=update)
    torch.cuda.synchronize()
    return state, marks


def train_moe_and_check(layers=MOE_TRAIN_LAYERS, steps=MOE_TRAIN_STEPS,
                        phase="train_moe"):
    """The MoE training path at full width and ``layers`` layers (48 is
    the whole model); returns its counts."""
    from dlrover_tpu_torch.trainer import train_lib

    cfg = moe_config(num_layers=layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, ce_chunks=0,
        device="cuda",
    )
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated()
    n_params = sum(p.numel() for p in state.model.parameters())
    per_step = _moe_per_step(cfg)

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    aux = []
    state, warm_losses, warm_s = _train_steps(train, state, batch,
                                              TRAIN_WARMUP, per_step, aux)
    state, losses, seconds = _train_steps(train, state, batch, steps,
                                          per_step, aux)
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    allocator = {k: torch.cuda.memory_stats()[k] for k in (
        "num_alloc_retries", "num_device_alloc", "num_device_free")}
    allocator["max_memory_reserved_bytes"] = torch.cuda.max_memory_reserved()
    all_losses = warm_losses + losses
    if not all_losses[-1] < all_losses[0]:
        raise AssertionError(f"MoE loss did not fall: {all_losses}")
    if not all(np.isfinite(a) and a > 0 for a in aux):
        raise AssertionError(f"MoE aux loss not finite and > 0: {aux}")

    step_s = statistics.median(seconds)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tokens_per_s = tokens / step_s
    # bench.py:418-426: MoE FLOPs counted at the activated dense shape
    # (top_k experts of d_ff each per token; the router and the padding
    # rows of the grouped products are not counted).
    flops_cfg = dataclasses.replace(cfg, num_experts=0,
                                    d_ff=cfg.resolved_d_ff * cfg.top_k)
    ftok = flops_per_token(flops_cfg, TRAIN_SEQ)
    ftok_hw = ftok + recompute_flops_per_token(flops_cfg, "flash_only",
                                               TRAIN_SEQ)
    choices = tokens * cfg.top_k
    n_pad = ((choices + GMM_BLOCK - 1) // GMM_BLOCK + cfg.num_experts) * \
        GMM_BLOCK
    state, memory = _memory_split(train, state, batch)
    prof = _profile(lambda: train.step(state, batch), top=16)
    busy = prof.get("device_busy_ms")
    emit({
        "phase": phase,
        "model": f"gpt2-1.5b MoE ({cfg.num_layers} of 48 layers, d_model "
                 "1600, 25 heads x 64, "
                 "vocab 50304, 8 experts top-2 of d_ff 3200, grouped "
                 "dispatch, bf16 params and compute, random weights seed 0)",
        "params": n_params, "remat": cfg.remat,
        "optimizer": "adafactor lr 1e-4, clip 1.0",
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "ce_chunks": 0,
        "losses": all_losses, "aux_losses": aux, "warmup_step_s": warm_s,
        "step_s": seconds, "step_s_median": step_s,
        "tokens_per_s": tokens_per_s,
        "mfu": tokens_per_s * ftok / PEAK_BF16_FLOPS,
        "hfu": tokens_per_s * ftok_hw / PEAK_BF16_FLOPS,
        "model_flops_per_token": ftok, "hardware_flops_per_token": ftok_hw,
        "grouped_rows": n_pad, "token_choices": choices,
        "padding_row_share_not_counted": (n_pad - choices) / n_pad,
        "launches": counts, "launches_per_step": per_step,
        "peak_memory_allocated_bytes": peak,
        "resident_after_setup_bytes": resident, **memory,
        "allocator": allocator,
        "setup_s": setup_s, "profiled_step": prof,
        "device_busy_share_of_median_step": (
            busy / (step_s * 1e3) if isinstance(busy, float) else
            "not measured"),
    })
    del state, train, batch
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def _gmm_swapped(fwd=None, dw=None):
    """Swap the grouped-matmul wrappers that the MoE op calls (module
    globals) while the block runs."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    kernel_fwd, kernel_dw = gm.gmm_fwd, gm.gmm_dw
    gm.gmm_fwd, gm.gmm_dw = fwd or kernel_fwd, dw or kernel_dw
    try:
        yield kernel_fwd, kernel_dw
    finally:
        gm.gmm_fwd, gm.gmm_dw = kernel_fwd, kernel_dw


def _gmm_reference_fns():
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    def fwd(x, w, group_sizes, block_rows=GMM_BLOCK, transpose_w=False):
        return gm.grouped_matmul_reference(x, w, group_sizes, transpose_w)

    def dw(x, dy, group_sizes, block_rows=GMM_BLOCK):
        return gm.grouped_matmul_dw_reference(x, dy, group_sizes)

    return fwd, dw


def _gmm_fault_fns(name, kernel_fwd, kernel_dw):
    """A planted fault in the kernels' results: expert
    ``MOE_PARITY_FAULT_EXPERT``'s dw dropped, or its rows of every dx
    halved."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm

    e = MOE_PARITY_FAULT_EXPERT
    if name == "expert_dw_dropped":
        def dw(x, dy, group_sizes, block_rows=GMM_BLOCK):
            out = kernel_dw(x, dy, group_sizes, block_rows)
            out[e] = 0
            return out

        return None, dw

    def fwd(x, w, group_sizes, block_rows=GMM_BLOCK, transpose_w=False):
        out = kernel_fwd(x, w, group_sizes, block_rows, transpose_w)
        if transpose_w:
            s, t = gm._row_ranges(group_sizes, out.shape[0])[e]
            out[s:t] *= 0.5
        return out

    return fwd, None


@contextlib.contextmanager
def _routing_recorded(record):
    """Append every top-k index tensor the MoE gate computes to
    ``record`` while the block runs."""
    from dlrover_tpu_torch.models import moe

    kernel_gate = moe.gate

    def recording_gate(logits, k, group=None):
        out = kernel_gate(logits, k, group)
        record.append(out[1].detach())
        return out

    moe.gate = recording_gate
    try:
        yield
    finally:
        moe.gate = kernel_gate


@contextlib.contextmanager
def _routing_replayed(record):
    """Make the MoE gate choose, call by call, the experts of ``record``
    (filled by ``_routing_recorded`` on a run of the same step) while the
    block runs; the gate values and the aux loss are computed as
    ``moe.gate`` computes them, from this call's logits at those choices.
    A rounding difference upstream then cannot move a choice to another
    expert, so two legs differ only by their products."""
    from dlrover_tpu_torch.models import moe

    kernel_gate = moe.gate
    calls = iter(record)

    def replaying_gate(logits, k, group=None):
        # At one rank: no batch group to take the means over.
        gate_idx = next(calls)
        e = logits.shape[-1]
        probs = torch.softmax(logits.float(), dim=-1)
        gate_vals = probs.gather(-1, gate_idx)
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
        density = moe._one_hot(gate_idx[..., 0], e).mean(dim=(0, 1))
        aux_loss = (density * probs.mean(dim=(0, 1))).sum() * (e ** 2) / k
        return gate_vals, gate_idx, aux_loss

    moe.gate = replaying_gate
    try:
        yield
    finally:
        moe.gate = kernel_gate
    if next(calls, None) is not None:
        raise AssertionError("the replayed step made fewer gate calls than "
                             "the recorded one")


def train_moe_parity():
    """One MoE step's loss and gradients through K8/K9 against the same
    model with the plain grouped matmuls swapped in (the flash kernels
    run in both legs), and the same check on two planted faults.  Every
    leg after the first routes as the first did (``_routing_replayed``),
    so the gaps measure the grouped products alone."""
    from dlrover_tpu_torch.models import init_params
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.trainer import train_lib

    cfg = moe_config(num_layers=PARITY_LAYERS)
    model = TransformerLM(cfg, device="cuda")
    model.load_state_dict(init_params(cfg, seed=0, device="cuda"))
    batch = _train_batch(cfg.vocab_size, PARITY_BATCH)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        logits, aux = model.forward_aux(batch["inputs"])
        loss, _ = train_lib.cross_entropy_loss(logits, batch["targets"])
        (loss + aux).backward()
        return loss.item(), {n: p.grad.float().clone()
                             for n, p in model.named_parameters()}

    before = _counts()
    route = []
    with _routing_recorded(route):
        k_loss, k_grads = loss_and_grads()
    after = _counts()
    want = _moe_per_step(cfg)
    got = {k: after[k] - before[k] for k in after}
    if got != want:
        raise AssertionError(f"MoE parity kernel leg launched {got}, want "
                             f"{want}")
    # The gate runs in each layer's forward, then in its recompute (last
    # layer first): choices the recompute routed elsewhere, per layer.
    layers = cfg.num_layers
    recompute_moved = [int((f != r).sum()) for f, r in
                       zip(route[:layers], route[layers:][::-1])]
    ref_fwd, ref_dw = _gmm_reference_fns()
    with _gmm_swapped(ref_fwd, ref_dw), _routing_replayed(route):
        r_loss, r_grads = loss_and_grads()
    end = _counts()
    if (end["gmm_fwd"], end["gmm_dw"]) != (after["gmm_fwd"],
                                           after["gmm_dw"]):
        raise AssertionError("the reference leg launched a grouped kernel")
    moe_names = [n for n in r_grads if ".moe." in n]
    dead = [n for n in moe_names if float(r_grads[n].abs().max()) == 0]
    if dead or not moe_names:
        raise AssertionError(f"MoE parameters without gradient: {dead}")
    gap = _grad_gap(k_grads, r_grads)
    # The noise floor: the kernel leg again (the atomic order of the
    # combine's index_add and of the fused flash dq differs run to run).
    with _routing_replayed(route):
        k2_loss, k2_grads = loss_and_grads()
    rerun = _grad_gap(k2_grads, k_grads)
    del k2_grads
    out = {
        "phase": "train_moe_parity", "layers": PARITY_LAYERS,
        "batch": PARITY_BATCH, "seq": TRAIN_SEQ,
        "loss_kernel": k_loss, "loss_reference": r_loss,
        "loss_abs_diff": abs(k_loss - r_loss), **gap,
        "moe_params_compared": len(moe_names),
        "token_choices_per_layer": PARITY_BATCH * TRAIN_SEQ * cfg.top_k,
        "routing": "every leg replays the kernel leg's top-k choices",
        "kernel_leg_recompute_choices_moved_by_layer": recompute_moved,
        "kernel_rerun": {"loss_abs_diff": abs(k2_loss - k_loss),
                         **{k_: rerun[k_] for k_ in (
                             "grad_norm_rel_diff", "min_grad_cosine",
                             "min_grad_cosine_param", "max_grad_rel_err",
                             "max_grad_rel_err_param")}},
        "limits": {"loss_atol": MOE_PARITY_LOSS_ATOL,
                   "grad_norm_rtol": MOE_PARITY_NORM_RTOL,
                   "min_grad_cosine": MOE_PARITY_MIN_COSINE,
                   "max_grad_rel_err": MOE_PARITY_PARAM_RTOL},
    }
    out["ok"] = _moe_parity_ok(out["loss_abs_diff"], gap)
    faults = {}
    for name in MOE_PARITY_FAULTS:
        with _gmm_swapped() as (kernel_fwd, kernel_dw):
            fwd, dw = _gmm_fault_fns(name, kernel_fwd, kernel_dw)
            with _gmm_swapped(fwd, dw), _routing_replayed(route):
                f_loss, f_grads = loss_and_grads()
        f_gap = _grad_gap(f_grads, r_grads)
        faults[name] = {k_: f_gap[k_] for k_ in (
            "grad_norm_rel_diff", "min_grad_cosine", "min_grad_cosine_param",
            "max_grad_rel_err", "max_grad_rel_err_param")}
        faults[name]["caught"] = not _moe_parity_ok(abs(f_loss - r_loss),
                                                    f_gap)
        del f_grads
    out["planted_faults"] = faults
    emit(out)
    if not out["ok"] or not all(f["caught"] for f in faults.values()):
        raise AssertionError(f"MoE train parity failed: {out}")
    del model
    torch.cuda.empty_cache()


def gmm_only():
    """``--gmm``: the MoE work alone, to repeat it cheaply on the card: the
    grouped-matmul checks, the 24-layer MoE step, its parity, and the
    whole 48-layer MoE step (1 warm-up, 2 measured steps, one profiled),
    each step's launches asserted as in the whole run."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    gmm_kernel_checks(gen)
    train_moe_and_check()
    train_moe_parity()
    train_moe_and_check(48, 2, "train_moe_48")


def _moe_parity_ok(loss_diff, gap) -> bool:
    return _parity_ok(loss_diff, gap, (
        MOE_PARITY_LOSS_ATOL, MOE_PARITY_NORM_RTOL, MOE_PARITY_MIN_COSINE,
        MOE_PARITY_PARAM_RTOL))


# -- the dense step's opt-in kernels (K4, K5a, K5b, K6, K7, K11) --------------


def _norm_rel(g, r) -> float:
    return float(torch.linalg.vector_norm(g.float() - r.float())
                 / torch.linalg.vector_norm(r.float()).clamp_min(1e-30))


NORM_CASES = [
    # The block norms of the training step: 16 x 1024 rows of d_model 1600.
    dict(case="train_layernorm", n=TRAIN_BATCH * TRAIN_SEQ, d=1600,
         dtype="bf16", center=True, bias=True, timed=True, plant=True),
    dict(case="train_rmsnorm", n=TRAIN_BATCH * TRAIN_SEQ, d=1600,
         dtype="bf16", center=False, bias=False, timed=True),
    # Rows no multiple of a block's run, a width no multiple of 8 (loads
    # element by element behind a mask).
    dict(case="ragged_bf16", n=1237, d=1001, dtype="bf16", center=True,
         bias=False),
    dict(case="fp32", n=4099, d=1600, dtype="fp32", center=True, bias=True),
    # More than one chunk per thread (5120 / 8 = 640 chunks on 256 threads).
    dict(case="wide_bf16", n=515, d=5120, dtype="bf16", center=False,
         bias=False),
]
NORM_TRAIN_CASE = "train_layernorm"
NORM_EPS = 1e-5


def norm_ok(e) -> bool:
    return (e["dx"]["row"] <= NORM_ROW_TOL and e["dx"]["norm"] <= NORM_NORM_TOL
            and e["dx"]["finite"] and e["dscale"] <= NORM_PARAM_TOL
            and e["dbias"] <= NORM_PARAM_TOL)


def check_norm_case(c, gen):
    """K4 against ``layernorm_backward_reference`` in fp32 from the same
    inputs and the same saved statistics."""
    from dlrover_tpu_torch.ops import fused_norm as fn

    n, d, center = c["n"], c["d"], c["center"]
    dtype = torch.bfloat16 if c["dtype"] == "bf16" else torch.float32

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = (rand(n, d) * 2.0 + 0.5).to(dtype)
    # A cotangent with a mean, as a loss gives it: the mean(g) term counts.
    dy = (rand(n, d) + 0.25).to(dtype)
    scale = (rand(d) * 0.3 + 1.0).to(dtype)
    bias = (rand(d) * 0.1).to(dtype) if c["bias"] else None
    with torch.no_grad():
        _, mean, rstd = fn.norm_forward(x, scale, bias, NORM_EPS, center)
        got = fn.layernorm_backward(x, dy, scale, mean, rstd, center)
        again = fn.layernorm_backward(x, dy, scale, mean, rstd, center)
        torch.cuda.synchronize()
        ref = fn.layernorm_backward_reference(
            x.float(), dy.float(), scale.float(), mean, rstd, center)
    # Two runs: dscale and dbias are summed in a fixed order, dx row by
    # row, so all three are bit-equal.
    repro = dict(dscale_dbias_bit_equal=bool(torch.equal(got[1], again[1])
                                             and torch.equal(got[2],
                                                             again[2])),
                 dx_bit_equal=bool(torch.equal(got[0], again[0])))
    del again

    def errors(dx, dscale, dbias):
        return {"dx": row_errors(dx, ref[0], NORM_ROW_FLOOR),
                "dscale": _norm_rel(dscale, ref[1]),
                "dbias": _norm_rel(dbias, ref[2])}

    e = errors(*got)
    plan = fn.norm_launch_plan(n, d, torch.cuda.get_device_properties(
        0).multi_processor_count, x.element_size(), d % fn.CHUNK == 0)
    out = dict(case=c["case"], n=n, d=d, dtype=c["dtype"], center=center,
               dx_dtype=str(got[0].dtype), max_abs_err=e["dx"]["max_abs"],
               repro=repro, plan={k: plan[k] for k in (
                   "warps_per_row", "rows_per_group", "stages",
                   "blocks_per_sm", "blocks", "smem_bytes")},
               **e)
    ok = (norm_ok(e) and got[0].dtype == dtype and got[0].shape == x.shape
          and all(repro.values()))

    if c.get("plant"):
        # The check on planted faults, each of which must fail it: the
        # mean(g) term left out of dx; the first block's partial row of
        # dscale lost.
        g32 = dy.float() * scale.float()
        no_mean = (got[0].float()
                   + rstd[:, None] * g32.mean(-1, keepdim=True)).to(dtype)
        run = plan["rows_per_block"]
        xhat = (x[:run].float() - mean[:run, None]) * rstd[:run, None]
        lost = got[1] - (dy[:run].float() * xhat).sum(0)
        faults = {}
        for name, f in (("mean_g_term_dropped", (no_mean, got[1], got[2])),
                        ("first_partial_row_lost", (got[0], lost, got[2]))):
            fe = errors(*f)
            faults[name] = dict(dx_row=fe["dx"]["row"],
                                dx_norm=fe["dx"]["norm"],
                                dscale=fe["dscale"], caught=not norm_ok(fe))
        out["planted_faults"] = faults
        ok = ok and all(f["caught"] for f in faults.values())
    out["ok"] = ok

    if c.get("timed"):
        item = x.element_size()
        nbytes = 3.0 * n * d * item + 8.0 * n + item * d + 8.0 * d
        flops = 14.0 * n * d
        b_ms, b_by = bound(nbytes, flops, PEAK_FP32_FLOPS)

        def kernel():
            fn.layernorm_backward(x, dy, scale, mean, rstd, center)

        def plain():
            fn.layernorm_backward_reference(x, dy, scale, mean, rstd, center)

        timed = dict(ms=device_ms(kernel), eager_ms=eager_ms(kernel),
                     plain_ms=device_ms(plain, iters=5, replays=3),
                     bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                     library_ms=None)
        if center:
            # The yardstick, never called by the port: ATen's layer-norm
            # backward on its own forward's statistics.
            w = scale
            b = bias if bias is not None else torch.zeros_like(scale)
            _, l_mean, l_rstd = torch.ops.aten.native_layer_norm(
                x, [d], w, b, NORM_EPS)

            def library():
                torch.ops.aten.native_layer_norm_backward(
                    dy, x, [d], l_mean, l_rstd, w, b, [True, True, True])

            timed["library_ms"] = device_ms(library)
            timed["library"] = "torch.ops.aten.native_layer_norm_backward"
        out["timed"] = timed
    return out


def norm_kernel_checks(gen):
    cases = [check_norm_case(c, gen) for c in NORM_CASES]
    emit({"phase": "norm_kernel_checks",
          "tolerance": {"dx_row": NORM_ROW_TOL, "dx_norm": NORM_NORM_TOL,
                        "dscale_dbias_norm": NORM_PARAM_TOL,
                        "row_floor": NORM_ROW_FLOOR},
          "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"fused norm backward kernel disagrees on {bad}")
    return cases


QUANT_CASES = [
    # The largest leaf of GPT-2 1.5B's layer-stacked tree (mlp.wi / mlp.wo).
    dict(case="largest_leaf", shape=(48, 1600, 6400), dtype="bf16",
         timed=True),
    # One layer's share of it: the planted faults.
    dict(case="one_layer", shape=(1600, 6400), dtype="bf16", plant=True),
    # Tails: 5005 = 19 x 256 + 141 and 4099 = 16 x 256 + 3.
    dict(case="ragged_bf16", shape=(5, 1001), dtype="bf16"),
    dict(case="ragged_fp32", shape=(4099,), dtype="fp32"),
]
QUANT_LEAF_CASE = "largest_leaf"


def _code_diff(bits, which, got, want):
    """Share of codes that differ and the largest difference in levels."""
    from dlrover_tpu_torch.ops import quantization as tq

    if bits == 8:
        diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
        return float((diff > 0).float().mean()), int(diff.max())
    unpack = (tq.unpack_nibbles_signed if which == "m"
              else tq.unpack_nibbles_unsigned)
    share, worst = 0.0, 0
    rows = 1 << 16   # unpacked in slabs: the codes widen 8x to fp32
    for r0 in range(0, got.shape[0], rows):
        diff = (unpack(got[r0:r0 + rows]) - unpack(want[r0:r0 + rows])).abs()
        share += float((diff > 0).sum())
        worst = max(worst, int(diff.max()))
    return share / (got.shape[0] * 256), worst


def _adam_errors(bits, got, ref):
    """A low-bit Adam result ``(upd, m, v)`` against the plain version's:
    the update by norm and by the share of values that differ at all, the
    codes by the share off and the largest difference in levels, the
    scales by their largest relative difference."""
    out = {"upd_norm": _norm_rel(got[0], ref[0]),
           "upd_differ_share": float((got[0] != ref[0]).float().mean()),
           "finite": bool(torch.isfinite(got[0].float()).all())}
    for which, g, r in (("m", got[1], ref[1]), ("v", got[2], ref[2])):
        share, worst = _code_diff(bits, which, g.q, r.q)
        out[f"{which}_codes_off_share"] = share
        out[f"{which}_codes_max_levels_off"] = worst
        out[f"{which}_scales_rel"] = float(
            ((g.scales - r.scales).abs() / r.scales.abs()).max())
    return out


def adam_ok(e) -> bool:
    return (e["finite"] and e["upd_norm"] <= QUANT_UPD_NORM_TOL
            and all(e[f"{w}_codes_off_share"] <= QUANT_CODE_SHARE
                    and e[f"{w}_codes_max_levels_off"] <= 1
                    and e[f"{w}_scales_rel"] <= QUANT_SCALE_RTOL
                    for w in ("m", "v")))


def _clone_moment(mom):
    return type(mom)(mom.q.clone(), mom.scales.clone())


def check_quant_case(c, gen):
    """K5a and K5b against their plain versions and as a round trip, then
    K6 and K7 against theirs from a state K5a made of a random first
    moment and a plain-made second moment (random codes and scales)."""
    from dlrover_tpu_torch.ops import quantization as tq

    shape = c["shape"]
    dtype = torch.bfloat16 if c["dtype"] == "bf16" else torch.float32
    n = int(np.prod(shape))
    rows = tq.num_blocks(n)

    def rand(*s):
        return torch.randn(s, generator=gen, device="cuda")

    def randint(lo, hi, *s):
        return torch.randint(lo, hi, s, generator=gen, device="cuda",
                             dtype=torch.int8)

    p = (rand(*shape) * 0.02).to(dtype)
    g = (rand(*shape) * 1e-3).to(dtype)
    m_true = rand(*shape) * 1e-3
    # The first 64th of the blocks all zero: scale 1, codes 0.
    m_true.reshape(-1)[: (n // (64 * 256)) * 256] = 0.0
    h = tq.adam_hyper(3, TRAIN_LR, 0.9, 0.95, 1e-8, 0.1)
    out = dict(case=c["case"], shape=list(shape), dtype=c["dtype"], n=n,
               blocks=rows, hyper=h._asdict())

    # -- K5a, K5b ---------------------------------------------------------------
    q, scales = tq.quantize(m_true)
    back = tq.dequantize(q, scales, shape)
    torch.cuda.synchronize()
    q_ref, s_ref = tq.quantize_reference(m_true)
    share, worst = _code_diff(8, "m", q, q_ref)
    half_level = scales.repeat_interleave(256)[:n].reshape(shape) * 0.5
    out["quantize"] = dict(
        codes_off_share=share, codes_max_levels_off=worst,
        scales_rel=float(((scales - s_ref).abs() / s_ref).max()),
        zero_blocks=int((scales == 1.0).sum()))
    out["dequantize"] = dict(
        max_abs_err=float((back - tq.dequantize_reference(
            q, scales, shape)).abs().max()),
        round_trip_within_half_a_level=bool(
            # x / scale is off by up to an ulp of 127: 1.5e-5 of a level.
            ((back - m_true).abs() <= half_level * (1 + 1e-4)).all()))
    ok = (share == 0.0 and out["quantize"]["scales_rel"] <= QUANT_SCALE_RTOL
          and out["dequantize"]["max_abs_err"] == 0.0
          and out["dequantize"]["round_trip_within_half_a_level"]
          and q.shape == (rows, 256) and back.shape == tuple(shape))
    del back, q_ref, s_ref, half_level

    # -- K6, K7 -------------------------------------------------------------------
    states = {
        8: (tq.QMoment(q, scales),
            tq.QMoment(randint(0, 128, rows, 256),
                       torch.rand((rows,), generator=gen, device="cuda")
                       * 1e-6 + 1e-9)),
        4: (tq.QMoment(tq.pack_nibbles(randint(-7, 8, rows, 256)),
                       torch.rand((rows,), generator=gen, device="cuda")
                       * 1e-3 + 1e-6),
            tq.QMoment(tq.pack_nibbles(randint(0, 16, rows, 256)),
                       torch.rand((rows,), generator=gen, device="cuda")
                       * 1e-6 + 1e-9)),
    }
    del m_true
    updates = {8: (tq.q8_adam_update, tq.q8_adam_update_reference),
               4: (tq.q4_adam_update, tq.q4_adam_update_reference)}
    max_err = 0.0
    for bits, (kernel, plain) in updates.items():
        m0, v0 = states[bits]
        ref = plain(g, p, m0, v0, h)
        got = kernel(g, p, _clone_moment(m0), _clone_moment(v0), h)
        torch.cuda.synchronize()
        e = _adam_errors(bits, got, ref)
        e["upd_max_abs_err"] = float(
            (got[0].float() - ref[0].float()).abs().max())
        max_err = max(max_err, e["upd_max_abs_err"])
        out[f"q{bits}_adam"] = e
        ok = ok and adam_ok(e) and got[0].dtype == dtype
        if c.get("plant"):
            out[f"q{bits}_planted_fault"] = _quant_planted_fault(
                bits, g, p, m0, v0, h, ref)
            ok = ok and out[f"q{bits}_planted_fault"]["caught"]
        del got, ref
    out["max_abs_err"] = max_err
    out["ok"] = ok

    if c.get("timed"):
        item = p.element_size()
        timed = {}

        def add(name, kernel, plain, nbytes, flops):
            b_ms, b_by = bound(nbytes, flops, PEAK_FP32_FLOPS)
            # The median of three readings: one reading of K7 here has
            # read 5% above its readings in turns (``--ab``).
            ms = statistics.median(device_ms(kernel, iters=5, replays=3)
                                   for _ in range(3))
            timed[name] = dict(
                ms=ms, eager_ms=eager_ms(kernel, iters=5),
                # Eager, back to back: passes over gigabytes, where launch
                # gaps count for nothing and a graph's private pool would
                # double the temporaries.
                plain_ms=eager_ms(plain, iters=2, warmup=1),
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                gbytes_per_s=nbytes / ms / 1e6,
                # No one PyTorch call computes a block quantization or a
                # quantized Adam step.
                library_ms=None)
            torch.cuda.empty_cache()

        m32 = tq.dequantize(q, scales, shape)
        add("quantize", lambda: tq.quantize(m32),
            lambda: tq.quantize_reference(m32), 5.0 * n + 4.0 * rows, 4.0 * n)
        add("dequantize", lambda: tq.dequantize(q, scales, shape),
            lambda: tq.dequantize_reference(q, scales, shape),
            5.0 * n + 4.0 * rows, 1.0 * n)
        del m32
        for bits, (kernel, plain) in updates.items():
            m0, v0 = states[bits]
            mk, vk = _clone_moment(m0), _clone_moment(v0)
            # g and p read and the update written; both moments' codes
            # and scales read and written.
            nbytes = 3.0 * item * n + 4.0 * n * bits / 8 + 16.0 * rows
            add(f"q{bits}_adam",
                lambda kernel=kernel, mk=mk, vk=vk: kernel(g, p, mk, vk, h),
                lambda plain=plain, m0=m0, v0=v0: plain(g, p, m0, v0, h),
                nbytes, 40.0 * n)
        out["timed"] = timed
    del states, p, g
    torch.cuda.empty_cache()
    return out


def _quant_planted_fault(bits, g, p, m, v, h, ref):
    """The check on a planted fault, which must fail it.  q8: the second
    moment decoded linearly (code / 127 times the scale) where the map is
    the 4th root.  q4: the high nibble of every byte of m and v dropped
    (the odd elements' moments read as 0)."""
    from dlrover_tpu_torch.ops import quantization as tq

    if bits == 8:
        m32 = m.q.float() * m.scales[:, None]
        v32 = v.q.float() * (1.0 / 127.0) * v.scales[:, None]
        upd, m32, v32 = tq._adam(h, tq._to_blocks(g), tq._to_blocks(p), m32,
                                 v32)
        v_codes, v_scale = tq._root4_codes(v32, 127.0)
        got = (tq._from_blocks(upd, p), tq.QMoment(*tq._absmax_int8(m32)),
               tq.QMoment(v_codes.to(torch.int8), v_scale))
        name = "v_decoded_linearly"
    else:
        def low(mom):
            return tq.QMoment((mom.q.view(torch.uint8) & 0xF).view(
                torch.int8), mom.scales)

        got = tq.q4_adam_update_reference(g, p, low(m), low(v), h)
        name = "high_nibble_dropped"
    e = _adam_errors(bits, got, ref)
    return dict(fault=name, upd_norm=e["upd_norm"],
                m_codes_off_share=e["m_codes_off_share"],
                v_codes_off_share=e["v_codes_off_share"],
                caught=not adam_ok(e))


def quant_kernel_checks(gen):
    cases = [check_quant_case(c, gen) for c in QUANT_CASES]
    emit({"phase": "quant_kernel_checks",
          "tolerance": {"codes_off_share": QUANT_CODE_SHARE,
                        "codes_max_levels_off": 1,
                        "scales_rtol": QUANT_SCALE_RTOL,
                        "upd_norm": QUANT_UPD_NORM_TOL,
                        "quantize_codes": "equal"},
          "library": None, "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"quantization kernels disagree on {bad}")
    return cases


def _code_check_scales():
    """The scales ``quant_code_check`` takes: every power of two from
    2^-126 to 1, FLT_MIN's two neighbours (the largest subnormal and the
    float above FLT_MIN), and ``QUANT_CHECK_RANDOM_SCALES`` seeded ones,
    log-uniform in [1e-30, 1e3]."""
    rng = np.random.default_rng(0)
    bits = np.array([0x007FFFFF, 0x00800001], dtype=np.uint32)
    return np.concatenate([
        np.ldexp(np.float32(1.0), np.arange(-126, 1)).astype(np.float32),
        bits.view(np.float32),
        (10.0 ** rng.uniform(-30, 3, QUANT_CHECK_RANDOM_SCALES)).astype(
            np.float32)])


def planted_threshold_faults(maps):
    """Two copies of K7's maps, each with one threshold moved up by one
    ulp: m's level 3 and v's code 5."""
    def up(t, k):
        moved = np.nextafter(np.float32(t[k]), np.float32(np.inf))
        return t[:k] + (float(moved),) + t[k + 1:]

    return {"m_threshold_3_up_an_ulp": maps._replace(
                m_thresholds=up(maps.m_thresholds, 2)),
            "v_threshold_5_up_an_ulp": maps._replace(
                v_thresholds=up(maps.v_thresholds, 4))}


def quant_code_check():
    """K7's codes by its own path against the IEEE chain, for every float32
    x in [0, s] at each of ``_code_check_scales``: mismatching m levels and
    v codes must be 0, and each planted threshold fault must give some."""
    from dlrover_tpu_torch.ops import quantization as tq

    scales_np = _code_check_scales()
    scales = torch.from_numpy(scales_np).cuda()
    want_seen = scales_np.view(np.uint32).astype(np.int64) + 1

    def run(maps=None):
        t0 = time.perf_counter()
        counts = tq.q4_code_check(scales, maps)
        torch.cuda.synchronize()
        counts = counts.cpu().numpy()
        return counts, time.perf_counter() - t0

    counts, seconds = run()
    bad = [dict(scale=float(s), m=int(c[0]), v=int(c[1]))
           for s, c in zip(scales_np, counts) if c[0] or c[1]]
    out = {"phase": "quant_code_check", "scales": len(scales_np),
           "values_checked": int(counts[:, 2].sum()),
           "all_values_checked": bool((counts[:, 2] == want_seen).all()),
           "m_level_mismatches": int(counts[:, 0].sum()),
           "v_code_mismatches": int(counts[:, 1].sum()),
           "mismatching_scales": bad[:8], "seconds": seconds,
           "thresholds": {"m": tq.q4_maps().m_thresholds,
                          "v": tq.q4_maps().v_thresholds}}
    faults = {}
    for name, maps in planted_threshold_faults(tq.q4_maps()).items():
        f_counts, _ = run(maps)
        faults[name] = dict(m_level_mismatches=int(f_counts[:, 0].sum()),
                            v_code_mismatches=int(f_counts[:, 1].sum()))
        faults[name]["caught"] = (faults[name]["m_level_mismatches"]
                                  + faults[name]["v_code_mismatches"]) > 0
    out["planted_faults"] = faults
    out["ok"] = (out["all_values_checked"] and not bad
                 and all(f["caught"] for f in faults.values()))
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"K7's codes differ from the IEEE chain: {out}")
    return out


def pin_kernel_check(gen):
    """K11 on the attention's input at the training shape, contiguous and
    as a transposed view, and on a sliced, expanded odd-sized view: the
    result is contiguous and bit-equal to its input."""
    from dlrover_tpu_torch.ops import layout_pin as lp

    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, 1600), generator=gen,
                    device="cuda").to(torch.bfloat16)
    odd = torch.randn((7, 1, 33), generator=gen, device="cuda")
    views = {
        "contiguous": x,
        "transposed": x.transpose(1, 2),
        "sliced_expanded_fp32": odd.expand(7, 5, 33)[1:, :, 2::3],
        "bytes": (x[0, :77, :13].contiguous().view(torch.uint8))[:, 3:],
    }
    results, ok = {}, True
    for name, view in views.items():
        out = lp.pin_copy(view)
        torch.cuda.synchronize()
        res = dict(shape=list(view.shape), strides=list(view.stride()),
                   merged_dims=lp.merged_dims(view),
                   contiguous_in=view.is_contiguous(),
                   contiguous_out=out.is_contiguous(),
                   bit_equal=bool(torch.equal(out, view)),
                   new_storage=out.data_ptr() != view.data_ptr())
        results[name] = res
        ok = (ok and res["contiguous_out"] and res["bit_equal"]
              and res["new_storage"] and out.dtype == view.dtype)
    nbytes = 2.0 * x.numel() * x.element_size()
    b_ms, b_by = bound(nbytes, 0.0)
    xt = views["transposed"]
    # The kernel against clone() in PIN_PAIRS alternating pairs: one
    # reading of each is within a few per cent of the other.
    pairs = [(device_ms(lambda: lp.pin_copy(x)),
              device_ms(lambda: x.clone())) for _ in range(PIN_PAIRS)]
    kernel_ms, clone_ms = ([p[i] for p in pairs] for i in (0, 1))
    timed = dict(
        ms=statistics.median(kernel_ms),
        eager_ms=eager_ms(lambda: lp.pin_copy(x)),
        transposed_ms=device_ms(lambda: lp.pin_copy(xt)),
        plain_ms=device_ms(lambda: lp.pin_layout_reference(x)),
        plain_transposed_ms=device_ms(lambda: lp.pin_layout_reference(xt)),
        library_ms=statistics.median(clone_ms), library="Tensor.clone()",
        pairs=dict(kernel_ms=kernel_ms, clone_ms=clone_ms,
                   kernel_spread_ms=max(kernel_ms) - min(kernel_ms),
                   clone_spread_ms=max(clone_ms) - min(clone_ms),
                   kernel_faster_in=sum(a < b for a, b in pairs)),
        share_of_bound=b_ms / statistics.median(kernel_ms),
        bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    res = {"phase": "pin_kernel_check", "views": results, "timed": timed,
           "max_abs_err": 0.0 if ok else float("nan"), "ok": ok}
    emit(res)
    if not ok:
        raise AssertionError(f"pin_layout kernel disagrees: {results}")
    return res


#: Rounds of ``--ab``: other, change, change, other each.
AB_ROUNDS = 2
#: Causal grids beside the split ``BWD_CASES`` at which ``time_kernels``
#: reads K2a, from about 1 to 12 waves of its 128-row blocks on 132 SMs:
#: D 64 at the training step's heads and length, and GQA 32/8 at D 128.
DQ_GRID_CASES = [
    dict(case=f"grid_b{b}_s1024", b=b, s=1024, hq=25, hkv=25, d=64,
         causal=True) for b in (1, 2, 4, 8)
] + [
    dict(case=f"grid_d128_b{b}_s{s}", b=b, s=s, hq=32, hkv=8, d=128,
         causal=True) for b, s in ((1, 512), (1, 1024), (4, 1024))
]


def _adam_states(gen, rows):
    """A seeded q8 and q4 state of ``rows`` blocks from the functions every
    tree since the kernels' port has (random codes, random scales)."""
    from dlrover_tpu_torch.ops import quantization as tq

    def codes(lo, hi):
        return torch.randint(lo, hi, (rows, 256), generator=gen,
                             device="cuda", dtype=torch.int8)

    def scales(lo, span):
        return torch.rand((rows,), generator=gen, device="cuda") * span + lo

    return {
        8: (tq.QMoment(codes(-127, 128), scales(1e-6, 1e-3)),
            tq.QMoment(codes(0, 128), scales(1e-9, 1e-6))),
        4: (tq.QMoment(tq.pack_nibbles(codes(-7, 8)), scales(1e-6, 1e-3)),
            tq.QMoment(tq.pack_nibbles(codes(0, 16)), scales(1e-9, 1e-6))),
    }


def _gmm_timed_inputs(gen):
    """The six grouped products of one MoE layer at the MoE step's shape
    (``GMM_SLICE_CASE``: 33,792 rows, d 1600, f 3200, 8 experts), from
    seeded bf16 operands and the group sizes its routed gate gave on an
    H100 (one expert empty, 640 padding rows at the tail), as ``name ->
    (kind, a, b)`` and the group sizes: what ``time_kernels`` reads K8 and
    K9 at."""
    n, d, f = 33792, 1600, 3200
    gs = torch.tensor([896, 1536, 2176, 3584, 4992, 0, 8960, 11008],
                      dtype=torch.int32, device="cuda")

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    x, h, dh, dout = rand(n, d), rand(n, f), rand(n, f), rand(n, d)
    wi, wo = rand(MOE_EXPERTS, d, f, scale=d ** -0.5), rand(
        MOE_EXPERTS, f, d, scale=f ** -0.5)
    return {"fwd_wi": ("fwd", x, wi), "fwd_wo": ("fwd", h, wo),
            "dx_wi": ("dx", dh, wi), "dx_wo": ("dx", dout, wo),
            "dw_wi": ("dw", x, dh), "dw_wo": ("dw", h, dout)}, gs


def time_kernels(only=None):
    """K2a, K4, K6, K7, K8 and K9 of whichever package is first on
    ``sys.path``, through the public wrappers (whose signatures have not
    changed since the kernels were first ported), at the main paths'
    shapes: K2a at the split ``BWD_CASES`` and at ``DQ_GRID_CASES``, K4 at
    the timed ``NORM_CASES``, K6 and K7 at the largest leaf
    (``QUANT_LEAF_CASE``), each reading from fresh clones of one seeded
    state, and K8 (four products) and K9 (two) at the MoE step's shape
    (``_gmm_timed_inputs``).  Device ms, the median of three CUDA-graph
    readings.  ``only``: name prefixes of the readings to take (all when
    None).  ``train_step`` (only when asked for by name) is the ``train``
    phase's step, GPT-2 1.5B at full size through ``build_train``: the
    median of three synchronised steps after one warm-up, host ms."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.ops import fused_norm as fn
    from dlrover_tpu_torch.ops import quantization as tq

    def wanted(name):
        return only is None or any(name.startswith(k) for k in only)

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    if only is not None and wanted("train_step"):
        from dlrover_tpu_torch.models import gpt2_config
        from dlrover_tpu_torch.trainer import train_lib

        cfg = gpt2_config("1.5b", attention_impl="flash", remat="flash_only",
                          param_dtype=torch.bfloat16)
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer("adafactor",
                                          learning_rate=TRAIN_LR),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
        state = train.init(seed=0)
        batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
        seconds = []
        for _ in range(1 + TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = train.step(state, batch)
            float(metrics["loss"])
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        out["train_step/gpt2_1.5b"] = 1e3 * statistics.median(seconds[1:])
        del state, train, batch
        torch.cuda.empty_cache()
    if wanted("gmm"):
        products, gs = _gmm_timed_inputs(gen)
        for name, (kind, a, b) in products.items():
            label = f"gmm_{'dw' if kind == 'dw' else 'fwd'}/{name}"
            out[label] = statistics.median(
                device_ms(_gmm_runner(kind, a, b, gs), iters=10)
                for _ in range(3))
        del products, gs
    for c in [c for c in BWD_CASES if c["kernel"] == "split"] + \
            DQ_GRID_CASES:
        if not wanted("flash_bwd_dq"):
            break
        q, k, v, _, _ = _case_inputs(c, gen)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(
            torch.bfloat16)
        o, lse = fa.flash_fwd(q, k, v, causal=c["causal"])
        out[f"flash_bwd_dq/{c['case']}"] = statistics.median(
            device_ms(lambda: fa.flash_bwd_dq(q, k, v, o, lse, do,
                                              causal=c["causal"]))
            for _ in range(3))
        del q, k, v, o, lse, do
    for c in NORM_CASES:
        if not c.get("timed") or not wanted("norm_bwd"):
            continue
        n, d, center = c["n"], c["d"], c["center"]
        x = (torch.randn((n, d), generator=gen, device="cuda") * 2.0
             + 0.5).bfloat16()
        dy = (torch.randn((n, d), generator=gen, device="cuda")
              + 0.25).bfloat16()
        scale = torch.randn((d,), generator=gen, device="cuda") * 0.3 + 1.0
        _, mean, rstd = fn.norm_forward(x, scale, None, NORM_EPS, center)
        out[f"norm_bwd/{c['case']}"] = statistics.median(
            device_ms(lambda: fn.layernorm_backward(x, dy, scale, mean, rstd,
                                                    center))
            for _ in range(3))
        del x, dy
    leaf = next(c for c in QUANT_CASES if c["case"] == QUANT_LEAF_CASE)
    n = int(np.prod(leaf["shape"]))
    wrappers = {8: tq.q8_adam_update, 4: tq.q4_adam_update}
    if any(wanted(f"q{bits}_adam") for bits in wrappers):
        p = (torch.randn(leaf["shape"], generator=gen, device="cuda")
             * 0.02).bfloat16()
        g = (torch.randn(leaf["shape"], generator=gen, device="cuda")
             * 1e-3).bfloat16()
        states = _adam_states(gen, tq.num_blocks(n))
        h = tq.adam_hyper(3, TRAIN_LR, 0.9, 0.95, 1e-8, 0.1)
        for bits, update in wrappers.items():
            if not wanted(f"q{bits}_adam"):
                continue
            readings = []
            for _ in range(3):
                m, v = (_clone_moment(x) for x in states[bits])
                readings.append(device_ms(
                    lambda: update(g, p, m, v, h), iters=5, replays=3))
                del m, v
            out[f"q{bits}_adam/{QUANT_LEAF_CASE}"] = statistics.median(
                readings)
        del p, g, states
    torch.cuda.empty_cache()
    return out


def ab_in_turns(others, only=None):
    """``time_kernels(only)`` of each tree in ``others`` (a ``git archive``
    of the parent commit, or a copy of this tree with one constant
    changed, each of which builds its own kernels there; named by its
    directory) and of this tree, each reading in a process of its own, in
    turns: other, change, change, other for each tree, ``AB_ROUNDS``
    times.  The first reading of each tree also brings its quantization
    library's ptxas report."""
    trees = {os.path.basename(os.path.normpath(t)): os.path.abspath(t)
             for t in others}
    for name, path in trees.items():
        if name == "change" or not os.path.isdir(
                os.path.join(path, "dlrover_tpu_torch")):
            raise FileNotFoundError(f"no other tree at {path}")
    order = [who for _ in range(AB_ROUNDS) for name in trees
             for who in (name, "change", "change", name)]
    trees["change"] = REPO
    readings = {name: [] for name in trees}
    ptxas = {}
    for who in order:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-tree",
             trees[who]] + ([",".join(only)] if only else []),
            capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"--time-tree {trees[who]} failed "
                               f"(rc {res.returncode}):\n{res.stderr[-4000:]}")
        reading = json.loads(res.stdout.splitlines()[-1])
        readings[who].append(reading["ms"])
        if reading["ptxas"]:
            ptxas.setdefault(who, reading["ptxas"])
    names = sorted(readings["change"][0])
    median = {who: {n: statistics.median(r[n] for r in rs) for n in names}
              for who, rs in readings.items()}
    emit({"phase": "ab_in_turns", "order": order, "readings": readings,
          "ptxas": ptxas, "median_ms": median,
          "over_change": {who: {n: median[who][n] / median["change"][n]
                                for n in names}
                          for who in trees if who != "change"}})


def _state_bytes(obj) -> int:
    """Bytes of every tensor in a nested optimizer state."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_state_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(_state_bytes(v) for v in obj)
    return 0


def lowbit_config(**overrides):
    """The dense step with its opt-in kernels on."""
    from dlrover_tpu_torch.models import gpt2_config

    return gpt2_config("1.5b", attention_impl="flash", remat="flash_only",
                       param_dtype=torch.bfloat16, fused_ln=True,
                       pin_attn_layouts=True, **overrides)


def _lowbit_per_step(cfg, opt_state, bits):
    """Launches per step, from the config and the optimizer state: per
    layer the flash forward once (saved) and the fused backward once; K4
    once per block norm (two) in the backward, ``ln_final`` staying
    unfused; K11 twice in the forward, twice in the ``flash_only``
    recompute and twice on the cotangents; K6 (or K7) once per quantized
    leaf of the layer-stacked tree."""
    from dlrover_tpu_torch.ops import quantization as tq

    quantized = sum(isinstance(m, tq.QMoment) for m in opt_state[-1].m.values())
    n_layers = cfg.num_layers
    return _per_step(flash_fwd=n_layers, flash_bwd_fused=n_layers,
                     norm_bwd=2 * n_layers, pin_copy=6 * n_layers,
                     **{f"q{bits}_adam": quantized}), quantized


def train_lowbit_and_check(adafactor_state_bytes):
    """The dense step with ``fused_ln``, ``pin_attn_layouts`` and
    ``q8_adam``, then ``q4_adam``, at full width and depth; returns each
    run's counts."""
    from dlrover_tpu_torch.ops import quantization as tq
    from dlrover_tpu_torch.trainer import train_lib

    cfg = lowbit_config()
    batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ftok = flops_per_token(cfg, TRAIN_SEQ)
    ftok_hw = ftok + recompute_flops_per_token(cfg, "flash_only", TRAIN_SEQ)
    counts = {}
    for bits, warmup, steps in ((8, TRAIN_WARMUP, LOWBIT_STEPS),
                                (4, 1, LOWBIT_Q4_STEPS)):
        name = f"q{bits}_adam"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer(name, learning_rate=TRAIN_LR,
                                          grad_clip=1.0),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, ce_chunks=0,
            device="cuda",
        )
        state = train.init(seed=0)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in state.model.parameters())
        per_step, quantized = _lowbit_per_step(cfg, state.opt_state, bits)
        state_bytes = _state_bytes(state.opt_state)

        # -- the main path, counted --------------------------------------------
        _zero_counts()
        state, warm_losses, warm_s = _train_steps(train, state, batch,
                                                  warmup, per_step)
        state, losses, seconds = _train_steps(train, state, batch, steps,
                                              per_step)
        # Read a first moment back in fp32 (K5b) and requantize it (K5a),
        # as a caller that inspects or re-blocks the state does.
        leaf = "blocks.mlp.wi.kernel"
        mom = state.opt_state[-1].m[leaf]
        shape = (cfg.num_layers, cfg.d_model, cfg.resolved_d_ff)
        readback = {"leaf": leaf, "shape": list(shape)}
        if bits == 8:
            m32 = tq.dequantize(mom.q, mom.scales, shape)
            q2, s2 = tq.quantize(m32)
            readback.update(
                finite=bool(torch.isfinite(m32).all()),
                abs_max=float(m32.abs().max()),
                requantized_codes_off_share=float(
                    (q2 != mom.q).float().mean()),
                requantized_scales_rel=float(
                    ((s2 - mom.scales).abs() / mom.scales).max()))
            del m32, q2, s2
            if not (readback["finite"] and readback["abs_max"] > 0
                    and readback["requantized_codes_off_share"] <= 1e-3
                    and readback["requantized_scales_rel"] <= 1e-6):
                raise AssertionError(f"q8 state read-back: {readback}")
        run_counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        all_losses = warm_losses + losses
        if not all_losses[-1] < all_losses[0]:
            raise AssertionError(f"{name}: loss did not fall: {all_losses}")
        step_s = statistics.median(seconds)
        tokens_per_s = tokens / step_s
        res = {
            "phase": "train_lowbit", "optimizer": f"{name} lr 1e-4, clip "
            "1.0 (b1 0.9, b2 0.95, weight decay 0.1)",
            "model": "gpt2-1.5b (48 layers, d_model 1600, 25 heads x 64, "
                     "vocab 50304, bf16 params and compute), fused_ln, "
                     "pin_attn_layouts, random weights seed 0",
            "params": n_params, "remat": cfg.remat,
            "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "ce_chunks": 0,
            "losses": all_losses, "warmup_step_s": warm_s,
            "step_s": seconds, "step_s_median": step_s,
            "tokens_per_s": tokens_per_s,
            "mfu": tokens_per_s * ftok / PEAK_BF16_FLOPS,
            "hfu": tokens_per_s * ftok_hw / PEAK_BF16_FLOPS,
            "launches": run_counts, "launches_per_step": per_step,
            "quantized_leaves": quantized,
            "optimizer_state_bytes": state_bytes,
            "optimizer_state_bytes_per_param": state_bytes / n_params,
            "adafactor_state_bytes": adafactor_state_bytes,
            "peak_memory_allocated_bytes": peak, "setup_s": setup_s,
            "state_read_back": readback,
        }
        kernel = f"q{bits}_adam_kernel"
        prof = _profile(lambda: train.step(state, batch), top=28,
                        match=(kernel,))
        busy = prof.get("device_busy_ms")
        res["profiled_step"] = prof
        res["device_busy_share_of_median_step"] = (
            busy / (step_s * 1e3) if isinstance(busy, float) else
            "not measured")
        # K6's or K7's device time over the profiled step's launches.
        res["adam_kernel_step"] = prof.get("matched", {}).get(
            kernel, "not measured")
        emit(res)
        counts[f"train_lowbit_q{bits}"] = run_counts
        del state, train
        torch.cuda.empty_cache()
    return counts


def flags_ab():
    """``python3 chip_smoke.py --flags-ab``: what each opt-in flag costs or
    saves per step with the optimizer held fixed.  The train phase's step
    (Adafactor) under flags off, ``fused_ln``, ``pin_attn_layouts`` and
    both, each setting run twice in mirrored order (off, ln, pin, both,
    both, pin, ln, off), 1 warm-up and 3 measured steps a run."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.trainer import train_lib

    settings = {"off": {}, "fused_ln": {"fused_ln": True},
                "pin_attn_layouts": {"pin_attn_layouts": True},
                "both": {"fused_ln": True, "pin_attn_layouts": True}}
    order = list(settings) + list(settings)[::-1]
    runs = {name: [] for name in settings}
    for name in order:
        flags = settings[name]
        cfg = gpt2_config("1.5b", attention_impl="flash", remat="flash_only",
                          param_dtype=torch.bfloat16, **flags)
        train = train_lib.build_train(
            cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
            global_batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, device="cuda")
        state = train.init(seed=0)
        batch = _train_batch(cfg.vocab_size, TRAIN_BATCH)
        n = cfg.num_layers
        per_step = _per_step(
            flash_fwd=n, flash_bwd_fused=n,
            norm_bwd=2 * n if flags.get("fused_ln") else 0,
            pin_copy=6 * n if flags.get("pin_attn_layouts") else 0)
        state, _, _ = _train_steps(train, state, batch, 1, per_step)
        state, losses, seconds = _train_steps(train, state, batch, 3,
                                              per_step)
        runs[name].append({"step_s": seconds,
                           "step_s_median": statistics.median(seconds),
                           "last_loss": losses[-1]})
        del state, train, batch
        torch.cuda.empty_cache()
    medians = {name: [r["step_s_median"] for r in rs]
               for name, rs in runs.items()}
    base = statistics.mean(medians["off"])
    emit({"phase": "flags_ab", "optimizer": "adafactor lr 1e-4, clip 1.0",
          "order": order, "runs": runs,
          "mean_of_medians_s": {k: statistics.mean(v)
                                for k, v in medians.items()},
          "ms_per_step_against_off": {
              k: (statistics.mean(v) - base) * 1e3
              for k, v in medians.items()},
          "off_spread_ms": (max(medians["off"]) - min(medians["off"])) * 1e3})


@contextlib.contextmanager
def _lowbit_swapped(norm_bwd=None, pin=None, adam=None):
    """Swap the wrappers the dense step's opt-in ops call (module globals
    read at call time) while the block runs; yields the kernels'."""
    from dlrover_tpu_torch.ops import fused_norm as fn
    from dlrover_tpu_torch.ops import layout_pin as lp
    from dlrover_tpu_torch.ops import quantization as tq

    kernels = (fn.layernorm_backward, lp.pin_copy, tq._low_bit_update)
    fn.layernorm_backward = norm_bwd or kernels[0]
    lp.pin_copy = pin or kernels[1]
    tq._low_bit_update = adam or kernels[2]
    try:
        yield kernels
    finally:
        fn.layernorm_backward, lp.pin_copy, tq._low_bit_update = kernels


def _lowbit_reference_fns():
    from dlrover_tpu_torch.ops import fused_norm as fn
    from dlrover_tpu_torch.ops import layout_pin as lp
    from dlrover_tpu_torch.ops import quantization as tq

    def adam(bits, g, p, m, v, h):
        plain = (tq.q8_adam_update_reference if bits == 8
                 else tq.q4_adam_update_reference)
        return plain(g, p, m, v, h)

    return fn.layernorm_backward_reference, lp.pin_layout_reference, adam


def _lowbit_grad_ok(loss_diff, gap) -> bool:
    return _parity_ok(loss_diff, gap, (
        LOWBIT_PARITY_LOSS_ATOL, LOWBIT_PARITY_NORM_RTOL,
        LOWBIT_PARITY_MIN_COSINE, LOWBIT_PARITY_PARAM_RTOL))


def _tree_adam_errors(bits, got, ref):
    """The worst of ``_adam_errors`` over the quantized leaves of two
    q``bits`` optimizer results ``(updates, state)``, and the small
    leaves' update error."""
    from dlrover_tpu_torch.ops import quantization as tq

    (g_upd, g_state), (r_upd, r_state) = got, ref
    worst, small = {}, 0.0
    for name, r_m in r_state.m.items():
        if not isinstance(r_m, tq.QMoment):
            small = max(small, _norm_rel(g_upd[name], r_upd[name]))
            continue
        e = _adam_errors(bits,
                         (g_upd[name], g_state.m[name], g_state.v[name]),
                         (r_upd[name], r_m, r_state.v[name]))
        for k, val in e.items():
            worst[k] = (min if k == "finite" else max)(worst.get(k, val),
                                                       val)
    worst["small_leaves_upd_norm"] = small
    return worst


def train_lowbit_parity():
    """4 layers, batch 4.  One step's loss and gradients through K4 and
    K11 against the same model with their plain versions swapped in (the
    flash kernels run in both legs), and the same step's optimizer update
    through K6, and through K7, against the plain update from the same
    gradients and the same non-trivial state (one step old: the q8 run's
    own, and a q4 state one update from its initial one).  One planted
    fault per kernel must fail its check."""
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.optimizers import optax_ports as ox
    from dlrover_tpu_torch.trainer import train_lib

    cfg = lowbit_config(num_layers=PARITY_LAYERS)
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("q8_adam", learning_rate=TRAIN_LR,
                                      grad_clip=1.0),
        global_batch_size=PARITY_BATCH, seq_len=TRAIN_SEQ, device="cuda")
    state = train.init(seed=0)
    batch = _train_batch(cfg.vocab_size, PARITY_BATCH)
    state, _ = train.step(state, batch)   # the state the step starts from

    # -- K4, K11: loss and gradients ----------------------------------------------
    model = TransformerLM(cfg, device="cuda")
    model.load_state_dict(state.model.state_dict())

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        logits, aux = model.forward_aux(batch["inputs"])
        loss, _ = train_lib.cross_entropy_loss(logits, batch["targets"])
        (loss + aux).backward()
        return loss.item(), {n: p.grad.float().clone()
                             for n, p in model.named_parameters()}

    before = _counts()
    k_loss, k_grads = loss_and_grads()
    after = _counts()
    got = {k: after[k] - before[k] for k in after}
    want = _per_step(flash_fwd=PARITY_LAYERS, flash_bwd_fused=PARITY_LAYERS,
                     norm_bwd=2 * PARITY_LAYERS, pin_copy=6 * PARITY_LAYERS)
    if got != want:
        raise AssertionError(f"lowbit parity kernel leg launched {got}, "
                             f"want {want}")
    ref_norm, ref_pin, ref_adam = _lowbit_reference_fns()
    with _lowbit_swapped(ref_norm, ref_pin):
        r_loss, r_grads = loss_and_grads()
    end = _counts()
    if (end["norm_bwd"], end["pin_copy"]) != (after["norm_bwd"],
                                              after["pin_copy"]):
        raise AssertionError("the reference leg launched K4 or K11")
    gap = _grad_gap(k_grads, r_grads)
    k2_loss, k2_grads = loss_and_grads()
    rerun = _grad_gap(k2_grads, k_grads)
    del k2_grads
    out = {
        "phase": "train_lowbit_parity", "layers": PARITY_LAYERS,
        "batch": PARITY_BATCH, "seq": TRAIN_SEQ,
        "loss_kernel": k_loss, "loss_reference": r_loss,
        "loss_abs_diff": abs(k_loss - r_loss), **gap,
        "kernel_rerun": {"loss_abs_diff": abs(k2_loss - k_loss),
                         **{k_: rerun[k_] for k_ in (
                             "grad_norm_rel_diff", "min_grad_cosine",
                             "max_grad_rel_err")}},
        "limits": {"loss_atol": LOWBIT_PARITY_LOSS_ATOL,
                   "grad_norm_rtol": LOWBIT_PARITY_NORM_RTOL,
                   "min_grad_cosine": LOWBIT_PARITY_MIN_COSINE,
                   "max_grad_rel_err": LOWBIT_PARITY_PARAM_RTOL,
                   "adam": {"codes_off_share": QUANT_CODE_SHARE,
                            "scales_rtol": QUANT_SCALE_RTOL,
                            "upd_norm": QUANT_UPD_NORM_TOL}},
    }
    grads_ok = _lowbit_grad_ok(out["loss_abs_diff"], gap)

    faults = {}
    with _lowbit_swapped() as (kernel_norm, kernel_pin, _):
        def faulty_norm(x, dy, scale, mean, rstd, center=True):
            # The second half of the rows' dx a tenth short.
            dx, dscale, dbias = kernel_norm(x, dy, scale, mean, rstd, center)
            half = dx.reshape(-1, dx.shape[-1])
            half[half.shape[0] // 2:] *= 0.9
            return dx, dscale, dbias

        def faulty_pin(x):
            # The last 64 features never copied.
            out_ = kernel_pin(x)
            out_[..., -64:] = 0
            return out_

        for name, fns in (("norm_dx_late_rows_short", (faulty_norm, None)),
                          ("pin_tail_not_copied", (None, faulty_pin))):
            with _lowbit_swapped(*fns):
                f_loss, f_grads = loss_and_grads()
            f_gap = _grad_gap(f_grads, r_grads)
            faults[name] = {k_: f_gap[k_] for k_ in (
                "grad_norm_rel_diff", "min_grad_cosine", "max_grad_rel_err",
                "max_grad_rel_err_param")}
            faults[name]["loss_abs_diff"] = abs(f_loss - r_loss)
            faults[name]["caught"] = not _lowbit_grad_ok(abs(f_loss - r_loss),
                                                         f_gap)
            del f_grads
    del r_grads, model

    # -- K6, K7: the update, from the kernel leg's gradients ----------------------
    grad_tree = ox.stack_layers(
        {n: g.to(torch.bfloat16) for n, g in k_grads.items()})
    del k_grads
    params = train_lib._param_tree(state.model)

    def clone_state(s):
        clip, adam = s
        def moments(tree):
            return {k: (_clone_moment(v) if hasattr(v, "q") else v.clone())
                    for k, v in tree.items()}
        return clip, type(adam)(adam.count, moments(adam.m), moments(adam.v))

    def update(optimizer, opt_state, adam_fn=None):
        with _lowbit_swapped(adam=adam_fn):
            upd, (_, new) = optimizer.update(grad_tree, clone_state(opt_state),
                                             params)
        return upd, new

    # K6 from the q8 run's state, K7 from a q4 state one update old.
    q4 = train_lib.make_optimizer("q4_adam", learning_rate=TRAIN_LR,
                                  grad_clip=1.0)
    q4_state = q4.update(grad_tree, q4.init(params), params)[1]
    legs = {8: (train.optimizer, state.opt_state), 4: (q4, q4_state)}
    adam_fine = True
    for bits, (optimizer, opt_state) in legs.items():
        name = f"q{bits}_adam"
        before = _counts()[name]
        k_out = update(optimizer, opt_state)
        launched = _counts()[name] - before
        r_out = update(optimizer, opt_state, ref_adam)
        if _counts()[name] != before + launched or launched == 0:
            raise AssertionError(f"the {name} update legs launched its "
                                 f"kernel {_counts()[name] - before} times")
        adam_e = _tree_adam_errors(bits, k_out, r_out)
        out[f"adam_q{bits}"] = {"launches": launched, **adam_e}
        adam_fine = (adam_fine and adam_ok(adam_e)
                     and adam_e["small_leaves_upd_norm"] <= 1e-6)

        with _lowbit_swapped() as (_, _, kernel_adam):
            def faulty_adam(bits_, g, p, m, v, h):
                # The first moment's scales written at half their value.
                upd, m, v = kernel_adam(bits_, g, p, m, v, h)
                m.scales.mul_(0.5)
                return upd, m, v

            f_e = _tree_adam_errors(bits, update(optimizer, opt_state,
                                                 faulty_adam), r_out)
        faults[f"adam_q{bits}_m_scales_halved"] = {
            "m_scales_rel": f_e["m_scales_rel"], "upd_norm": f_e["upd_norm"],
            "caught": not adam_ok(f_e)}
        del k_out, r_out
    out["planted_faults"] = faults
    out["ok"] = grads_ok and adam_fine
    emit(out)
    if not out["ok"] or not all(f["caught"] for f in faults.values()):
        raise AssertionError(f"lowbit train parity failed: {out}")
    del state, train, grad_tree, params, legs, q4_state
    torch.cuda.empty_cache()


# -- embedding plane -----------------------------------------------------------

# The hot-row cache's kernels K10a/K10b (``embedding/kernels.py``).  Cases:
# (name, capacity, dim, slots, real slots).  Real slots are distinct and
# nonzero; the rest of the padded array points at the scratch slot 0, whose
# scattered rows are zero, as the cache pads them.  The slice case is the
# CTR loop's: a 4,194,304-row cache of dim 128 (2.15 GB), 32,768 padded
# slots, about as many real ones as a batch there has unique keys.
EMBED_CASES = [
    ("slice", 4_194_304, 128, 32_768, 17_300),
    ("dim16", 8_192, 16, 4_096, 2_500),
    ("dim129_unaligned", 8_192, 129, 4_096, 2_500),
    ("single_slot", 64, 128, 1, 1),
    ("scratch_duplicates", 1_024, 128, 8, 3),
]
EMBED_SLICE_CASE = "slice"
# ``train_rec`` at MLPerf DLRM width (Criteo 1TB: 26 categorical features,
# embedding dim 128, max_ind_range 40M, top MLP opening at 1024, 8,192
# examples per chip of the 65,536 global batch): 1 warm-up + 30 measured
# steps, a 4 -> 3 fold after step 16, 4,194,304 cached rows on the card.
REC_ARGV = [
    "--steps", "31", "--batch-size", "8192", "--fields", "26", "--dim",
    "128", "--id-space", "40000000", "--hidden", "1024", "--lr", "0.01",
    "--world", "4", "--num-buckets", "64", "--cache-rows", "4194304",
    "--max-unique", "32768", "--prefetch-depth", "2", "--sparse-optimizer",
    "adam", "--reshard-at", "16:3",
]
REC_WARMUP, REC_PROFILED_STEP, REC_HOST_PROFILED_STEP = 1, 21, 23
REC_FAULT_STEPS = 3
REC_CHECK_GATHERS = 1  # K10a launches a step made by the invariant check
EMBED_TIMED_SETS = 8


def _embed_case(name, capacity, dim, n, real, rng, gen):
    slots = np.zeros(n, np.int32)
    chosen = rng.choice(capacity - 1, size=real, replace=False) + 1
    if name == "scratch_duplicates":
        slots[0::2][:real] = chosen  # [a, 0, b, 0, c, 0, 0, 0]
    else:
        slots[:real] = chosen
    rows = rng.standard_normal((n, dim)).astype(np.float32)
    rows[slots == 0] = 0.0
    cache = torch.randn((capacity, dim), generator=gen, device="cuda")
    return cache, slots, rows


def _gather_fault(gather):
    """A gather that reads ``slots[i] + 1``."""
    def faulty(cache, slots):
        return gather(cache, (np.asarray(slots, np.int64) + 1)
                      % cache.shape[0])
    return faulty


def _scatter_fault(scatter):
    """A scatter that drops the last real (nonzero) slot's row."""
    def faulty(cache, slots, rows):
        slots = np.asarray(slots)
        keep = np.ones(slots.shape, bool)
        real = np.nonzero(slots)[0]
        if real.size:
            keep[real[-1]] = False
        return scatter(cache, slots[keep], np.asarray(rows)[keep])
    return faulty


def _embed_check(gather, scatter, cache, slots, rows):
    """Bit-equality of a gather and a scatter with the plain versions."""
    from dlrover_tpu_torch.embedding import kernels as ek

    s_dev = torch.from_numpy(slots).cuda()
    got = gather(cache, slots)
    want = ek.gather_rows_reference(cache, s_dev)
    kc, rc = cache.clone(), cache.clone()
    scatter(kc, slots, rows)
    ek.scatter_rows_reference_(rc, s_dev, torch.from_numpy(rows).cuda())
    torch.cuda.synchronize()
    return {
        "gather_bit_equal": bool(torch.equal(got, want)),
        "gather_max_abs_err": float((got - want).abs().max()),
        "scatter_bit_equal": bool(torch.equal(kc, rc)),
        "scatter_max_abs_err": float((kc - rc).abs().max()),
        "new_storage": got.data_ptr() != cache.data_ptr(),
    }


def embed_kernel_checks(gen):
    """K10a and K10b against their plain versions, bit for bit, at the CTR
    loop's shape, at dim 16, at the unaligned dim 129, for one slot and
    for a scatter whose only duplicates are slot 0 with zero rows; two
    planted faults must fail.  Times at the slice case."""
    from dlrover_tpu_torch.embedding import kernels as ek

    rng = np.random.default_rng(0)
    results, ok, timed = {}, True, {}
    for name, capacity, dim, n, real in EMBED_CASES:
        cache, slots, rows = _embed_case(name, capacity, dim, n, real, rng,
                                         gen)
        res = dict(capacity=capacity, dim=dim, slots=n, real=real,
                   **_embed_check(ek.gather_rows, ek.scatter_rows, cache,
                                  slots, rows))
        ok = ok and res["gather_bit_equal"] and res["scatter_bit_equal"] \
            and res["new_storage"]
        if name == EMBED_SLICE_CASE:
            faults = _embed_check(_gather_fault(ek.gather_rows),
                                  _scatter_fault(ek.scatter_rows), cache,
                                  slots, rows)
            res["faults"] = {
                "gather_reads_next_slot_caught":
                    not faults["gather_bit_equal"],
                "scatter_drops_last_row_caught":
                    not faults["scatter_bit_equal"],
            }
            ok = ok and all(res["faults"].values())
            timed = _embed_times(cache, slots, rows, rng)
        results[name] = res
        del cache
    torch.cuda.empty_cache()
    res = {"phase": "embed_kernel_checks", "cases": results, "timed": timed,
           "max_abs_err": max(max(r["gather_max_abs_err"],
                                  r["scatter_max_abs_err"])
                              for r in results.values()),
           "ok": ok}
    emit(res)
    if not ok:
        raise AssertionError(f"embedding row kernels disagree: {results}")
    return res


def _queued_ms(fn, reps: int = 5) -> float:
    """Device milliseconds of ``fn``'s work alone: the median of ``reps``
    runs, each queued behind a sleeping kernel so the host's dispatch is
    done before the device starts."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(DIGEST_SLEEP_CYCLES)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
        fn()
        marks[1].record()
        torch.cuda.synchronize()
        times.append(marks[0].elapsed_time(marks[1]))
    return statistics.median(times)


def digest_kernel_check(gen):
    """The SDC digest's byte-sum kernel (``ops/csrc/byte_sums.cu``) against
    its plain version (``state_digest.byte_sums_reference``, the int16 row
    sums) on the card: GPT-2 1.5B's parameter leaves in bf16 (random
    bytes), and odd leaves (a view one byte off a 16-byte boundary, an
    empty leaf, one byte, a 0-d fp32, a bool, a transposed view, the int32
    step counter); the sums equal, exactly, and equal across two runs; a
    planted fault (the table's last chunk dropped) must differ.  Device
    ms of each (queued behind a sleeping kernel, so the host's dispatch is
    not in it) and the wrapper's host ms, at the parameter leaves."""
    from dlrover_tpu_torch.models import gpt2_config
    from dlrover_tpu_torch.models.transformer import param_shapes
    from dlrover_tpu_torch.trainer import state_digest as sd

    dev = torch.device("cuda")
    leaves = [torch.randint(0, 256, (int(np.prod(s)) * 2,),
                            dtype=torch.uint8, device=dev, generator=gen)
              for s in param_shapes(gpt2_config("1.5b")).values()]
    big = torch.randint(0, 256, (10_000_019,), dtype=torch.uint8,
                        device=dev, generator=gen)
    odd = [big[1:], big[3:1_000_003], big[:0], big[7:8],
           torch.tensor(3.5, device=dev), big[:4099] > 128,
           big[:6_000_000].view(2000, 3000).t(), 7]
    out = {"phase": "digest_kernel_check", "leaves": len(leaves),
           "bytes": sum(t.numel() for t in leaves)}
    try:
        for name, case in (("params", leaves), ("odd", odd)):
            before = dict(sd.LAUNCHES)
            got = sd.byte_sums(case, dev)
            again = sd.byte_sums(case, dev)
            launched = sd.LAUNCHES["digest_sums"] - before["digest_sums"]
            sd.LAUNCHES.update(before)
            want = sd.byte_sums_reference(case, dev)
            out[name] = {"equal": bool(torch.equal(got, want)),
                         "repeat_equal": bool(torch.equal(got, again)),
                         "launches": launched,
                         "max_abs_err": float((got - want).abs().max())}
        table = sd.chunk_table
        sd.chunk_table = lambda *a, **k: table(*a, **k)[:-1]
        try:
            before = dict(sd.LAUNCHES)
            dropped = sd.byte_sums(leaves, dev)
            sd.LAUNCHES.update(before)
        finally:
            sd.chunk_table = table
        out["planted_last_chunk_dropped_caught"] = not bool(torch.equal(
            dropped, sd.byte_sums_reference(leaves, dev)))
        before = dict(sd.LAUNCHES)
        t0 = time.perf_counter()
        for _ in range(5):
            sd.byte_sums(leaves, dev)
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
        ms = _queued_ms(lambda: sd.byte_sums(leaves, dev))
        plain_ms = _queued_ms(lambda: sd.byte_sums_reference(leaves, dev))
        sd.LAUNCHES.update(before)
        out["timed"] = {
            "ms": ms, "plain_ms": plain_ms, "host_ms": host_ms,
            # One integer add a byte, on the CUDA cores.
            "bound_ms": bound(out["bytes"], out["bytes"],
                              PEAK_FP32_FLOPS)[0],
            "bound_by": bound(out["bytes"], out["bytes"],
                              PEAK_FP32_FLOPS)[1],
            "library_ms": None,
            "library": "none: no one PyTorch call sums many leaves apart"}
        out["ok"] = (all(out[c]["equal"] and out[c]["repeat_equal"]
                         and out[c]["launches"] == 2
                         for c in ("params", "odd"))
                     and out["planted_last_chunk_dropped_caught"])
    finally:
        emit(out)
    del leaves, big, odd
    torch.cuda.empty_cache()
    if not out["ok"]:
        raise AssertionError(f"digest byte-sum kernel disagrees: {out}")
    return out


def _embed_times(cache, slots, rows, rng):
    """Kernel, plain and library device times at one case, and the bound
    from the bytes this case's slots need, 4 bytes a slot besides: the
    gather reads each distinct cache row once and writes every slot's row;
    the scatter writes each distinct slot once, from the one row of
    ``rows`` that lands there (the last of a run of equal slots), so it
    reads and writes ``distinct`` rows.
    The timed calls cycle through ``EMBED_TIMED_SETS`` slot and row sets,
    as many bytes as twice the 50 MB L2, so each call finds its rows in
    device memory as a training step does."""
    from dlrover_tpu_torch.embedding import kernels as ek

    n, dim = rows.shape
    capacity = cache.shape[0]
    real = int(np.count_nonzero(slots))
    sets = []
    for _ in range(EMBED_TIMED_SETS):
        s = np.zeros_like(slots)
        s[:real] = rng.choice(capacity - 1, size=real, replace=False) + 1
        r = rng.standard_normal(rows.shape).astype(np.float32)
        r[s == 0] = 0.0
        s_dev = torch.from_numpy(s).cuda()
        sets.append((s, s_dev, s_dev.long(), torch.from_numpy(r).cuda(), r))
    distinct = len(np.unique(slots))
    row_bytes = dim * 4
    kc, rc = cache.clone(), cache.clone()

    def cycled(fn):
        it = itertools.cycle(sets)
        return lambda: fn(*next(it))

    out = {}
    for kind, nbytes, kernel, plain, library, wrapper in (
            ("gather", (distinct + n) * row_bytes + 4 * n,
             lambda s, sd, s64, rd, r: ek.gather_kernel(cache, sd),
             lambda s, sd, s64, rd, r: ek.gather_rows_reference(cache, sd),
             lambda s, sd, s64, rd, r: cache.index_select(0, s64),
             lambda s, sd, s64, rd, r: ek.gather_rows(cache, s)),
            ("scatter", 2 * distinct * row_bytes + 4 * n,
             lambda s, sd, s64, rd, r: ek.scatter_kernel(kc, sd, rd),
             lambda s, sd, s64, rd, r: ek.scatter_rows_reference_(rc, sd,
                                                                  rd),
             lambda s, sd, s64, rd, r: rc.index_copy_(0, s64, rd),
             lambda s, sd, s64, rd, r: ek.scatter_rows(kc, s, r))):
        b_ms, b_by = bound(nbytes, 0.0)
        out[kind] = dict(
            ms=device_ms(cycled(kernel)), plain_ms=device_ms(cycled(plain)),
            library_ms=device_ms(cycled(library)),
            library="Tensor.index_select" if kind == "gather"
            else "Tensor.index_copy_",
            # The wrapper from host slots (and host rows): range check,
            # uploads and the launch, as the cache calls it.
            wrapper_eager_ms=eager_ms(cycled(wrapper)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
            distinct_rows=distinct)
    del kc, rc, sets
    return out


def _rec_invariant_holds(cache, uniq) -> bool:
    """The cache's invariant: the rows of ``uniq`` gathered through K10a
    equal ``plane.peek(uniq)`` bit for bit.  The gather is one counted
    K10a launch (``REC_CHECK_GATHERS`` a step)."""
    from dlrover_tpu_torch.embedding import kernels as ek

    got = ek.gather_rows(cache.memory_buffers()[0], cache.slots_of(uniq))
    got = got[: len(uniq)].cpu().numpy()
    return bool(np.array_equal(got, cache.plane.peek(uniq)))


def _host_profile(prof, top: int = 14):
    """The functions a cProfile window spent most time in, by own time."""
    import pstats

    stats = pstats.Stats(prof)
    rows = []
    for (path, line, func), (_, ncalls, tottime, cumtime, _) in \
            stats.stats.items():
        rows.append((tottime, cumtime, ncalls,
                     f"{os.path.basename(path)}:{line}({func})"))
    rows.sort(reverse=True)
    return [{"own_ms": t * 1e3, "cum_ms": c * 1e3, "calls": n, "name": f}
            for t, c, n, f in rows[:top]]


def train_rec_and_check():
    """``train_rec.run`` at MLPerf DLRM width on the card: after every step
    the cache's rows (through K10a) equal the plane's bit for bit, across
    the 4 -> 3 reshard; the loss is finite and falls; the launches equal
    the counts the cache's code gives (one K10a per lookup, one K10b per
    ensure that fetched misses and one per refresh); the hit rate is above
    0; the reshard moved rows and lost none.  Then 3 steps with a K10b that
    drops the last real row must fail the invariant."""
    import cProfile

    from torch.profiler import ProfilerActivity, profile

    from dlrover_tpu_torch.embedding import kernels as ek
    from dlrover_tpu_torch.examples import train_rec

    args = train_rec.parse_args(REC_ARGV)
    state = {"bad": [], "per_step": [], "prev": None}
    window = {}

    def on_step(step, cache, uniq):
        if step == REC_PROFILED_STEP:
            torch.cuda.synchronize()
            window["prof"].__exit__(None, None, None)
            window["wall_ms"] = (time.perf_counter() - window["t0"]) * 1e3
        if step == REC_HOST_PROFILED_STEP:
            window["host"].disable()
        if not _rec_invariant_holds(cache, uniq):
            state["bad"].append(step)
        now = dict(cache.stats(), **ek.LAUNCHES)
        prev = state["prev"] or dict.fromkeys(now, 0)
        d = {k: now[k] - prev[k] for k in now}
        state["prev"] = now
        want = {"embed_gather": 1, "embed_scatter": 1 + d["fetches"]}
        got = {"embed_gather": d["embed_gather"] - REC_CHECK_GATHERS,
               "embed_scatter": d["embed_scatter"]}
        calls = {"embed_gather": d["gathers"],
                 "embed_scatter": d["scatters"]}
        state["per_step"].append(dict(step=step, unique=len(uniq),
                                      fetches=d["fetches"], **got))
        if got != want or calls != want:
            raise AssertionError(
                f"step {step}: launches {got}, cache calls {calls}, "
                f"derived {want}")
        if step == REC_PROFILED_STEP - 1:
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            window["prof"].__enter__()
            window["t0"] = time.perf_counter()
        if step == REC_HOST_PROFILED_STEP - 1:
            window["host"] = cProfile.Profile()
            window["host"].enable()

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train_rec.run(args, device="cuda", on_step=on_step)
    total_s = time.perf_counter() - t0
    counts = _counts()
    # The path's own launches: take out the invariant check's gathers.
    counts["embed_gather"] -= REC_CHECK_GATHERS * args.steps
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    losses = result["losses"]
    cache, plane = result["cache"], result["plane"]
    (reshard,) = result["reshards"]
    measured = result["step_s"][REC_WARMUP:]
    step_s = statistics.median(measured)
    prof = _profile_summary(window["prof"], window["wall_ms"], top=10)
    busy = prof.get("device_busy_ms")
    checks = {
        "invariant_every_step": not state["bad"],
        "losses_finite": bool(np.isfinite(losses).all()),
        "loss_falls": float(np.mean(losses[-5:])) < min(
            float(np.mean(losses[:5])), losses[0]),
        "launches_derived": (
            counts["embed_gather"] == cache["gathers"] == args.steps
            and counts["embed_scatter"] == cache["scatters"]
            == args.steps + cache["fetches"]),
        "hit_rate_above_0": cache["hit_rate"] > 0,
        "reshard_moved_rows_lost_none": (
            reshard["moved_rows"] > 0
            and reshard["rows_before"] == reshard["rows_after"]),
        "no_eviction": cache["evictions"] == 0,
    }

    # -- the invariant check must catch a faulty scatter ---------------------
    fault_args = train_rec.parse_args(
        REC_ARGV[:1] + [str(REC_FAULT_STEPS)] + REC_ARGV[2:-2])
    caught = []
    kernel_scatter = ek.scatter_rows
    ek.scatter_rows = _scatter_fault(kernel_scatter)
    try:
        train_rec.run(fault_args, device="cuda", on_step=lambda s, c, u: (
            caught.append(s) if not _rec_invariant_holds(c, u) else None))
    finally:
        ek.scatter_rows = kernel_scatter
    torch.cuda.empty_cache()
    checks["scatter_fault_caught"] = bool(caught)

    emit({
        "phase": "train_rec",
        "config": "MLPerf Training DLRM, Criteo 1TB: 26 categorical "
                  "features, dim 128, max_ind_range 40M, top MLP 1024, "
                  "8192 examples per chip; zipf(1.3) ids, numpy seed 0",
        "argv": REC_ARGV,
        "losses": losses, "step_s": result["step_s"],
        "step_s_median": step_s,
        "examples_per_s": args.batch_size / step_s,
        "rows_per_s": args.batch_size * args.fields / step_s,
        "examples_per_s_whole_run": result["examples_per_s"],
        "run_s": total_s,
        "reshard": reshard,
        "reshard_step_s": result["step_s"][reshard["step"] - 1],
        "cache": cache, "plane": plane,
        "launches": {k: counts[k] for k in ek.LAUNCHES},
        "per_step": state["per_step"],
        "peak_memory_allocated_bytes": peak,
        "profiled_step": prof,
        "device_busy_share_of_profiled_step": (
            busy / prof["wall_ms_under_profiler"]
            if isinstance(busy, float) else "not measured"),
        "host_profile_step": _host_profile(window["host"]),
        "fault_run": {"steps": REC_FAULT_STEPS, "failed_at_steps": caught},
        "checks": checks,
    })
    if not all(checks.values()):
        raise AssertionError(f"train_rec failed its checks: {checks} "
                             f"(invariant broken at steps {state['bad']})")
    return counts


# -- serving --------------------------------------------------------------------


def _requests(vocab: int):
    from dlrover_tpu_torch.rl.generation import SamplingParams
    from dlrover_tpu_torch.serving import Request

    gen = torch.Generator().manual_seed(1)
    out = []
    for i, (n, m) in enumerate(SERVE_REQUESTS):
        prompt = torch.randint(1, vocab, (n,), generator=gen).numpy()
        sampling = (
            SamplingParams(temperature=0.0, max_new_tokens=m) if i % 2 == 0
            else SamplingParams(temperature=0.8, top_k=8, max_new_tokens=m)
        )
        out.append(Request(f"r{i:02d}", prompt, sampling))
    return out


def _profile(fn, top: int = 8, match=()):
    """Device time by kernel for one call of ``fn``; ``match``: see
    ``_profile_summary``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _profile_summary(prof, wall_ms, top, match)


def _profile_summary(prof, wall_ms: float, top: int = 8, match=()):
    """Device busy time and the top kernels of a finished profile, and for
    each name in ``match`` the device ms and launches of the kernels whose
    names hold it."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        # Kernels and copies only: a CPU op's row repeats its kernels'
        # device time, and so does a host range's mirror on the device's
        # timeline (as torch's own table leaves it out).
        if getattr(evt, "device_type", None) != DeviceType.CUDA or \
                getattr(evt, "is_user_annotation", False) or \
                evt.key.startswith(("module:", "wire:", "dlrover.")):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    out = {
        "wall_ms_under_profiler": wall_ms,
        "device_busy_ms": busy,
        "kernels": len(rows),
        "top": [{"ms": ms, "count": n, "name": name[:70]}
                for ms, n, name in rows[:top]],
    }
    if match:
        out["matched"] = {
            m: {"ms": sum(r[0] for r in rows if m in r[2]),
                "launches": sum(r[1] for r in rows if m in r[2])}
            for m in match}
    return out


@contextlib.contextmanager
def _attention_through_reference():
    """Swap the model's flash call for ``mha_reference`` (fp32 math from
    the same bf16 inputs) while the block runs."""
    from dlrover_tpu_torch.ops import flash_attention as fa

    kernel_mha = fa.mha

    def reference_mha(q, k, v, *, causal=True, segment_ids=None, **_):
        o, _ = fa.mha_reference(q, k, v, causal=causal, seg_q=segment_ids,
                                seg_kv=segment_ids)
        return o

    fa.mha = reference_mha
    try:
        yield
    finally:
        fa.mha = kernel_mha


def serve_and_check():
    from dlrover_tpu_torch.models import gpt2_config, init_params
    from dlrover_tpu_torch.models.transformer import TransformerLM
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.serving import ServingEngine, pad_to_bucket

    # bf16 weights: no fp32 master copy and no per-step cast.
    cfg = gpt2_config("1.5b", attention_impl="flash",
                      param_dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    engine = ServingEngine(cfg, params, slots=SLOTS, device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warmup_s = engine.aot_compile()
    requests = _requests(cfg.vocab_size)

    # -- the main path, counted ----------------------------------------------
    _zero_counts()
    t0 = time.perf_counter()
    results = engine.run(requests)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts["flash_fwd"]
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()

    for req in requests:
        res = results[req.uid]
        want = req.sampling.max_new_tokens
        if len(res.tokens) != want or len(res.logprobs) != want:
            raise AssertionError(
                f"{req.uid}: {len(res.tokens)} tokens, wanted {want}"
            )
        if not np.isfinite(res.logprobs).all():
            raise AssertionError(f"{req.uid}: non-finite logprobs")
        if ((res.tokens < 0) | (res.tokens >= cfg.vocab_size)).any():
            raise AssertionError(f"{req.uid}: token outside the vocab")
    prefills = int(stats["prefills"])
    if prefills != len(requests) or launches != prefills * cfg.num_layers:
        raise AssertionError(
            f"flash launches {launches} != prefills {prefills} x "
            f"{cfg.num_layers} layers"
        )
    if any(counts[k] for k in counts if k != "flash_fwd"):
        raise AssertionError(f"serving launched a backward kernel: {counts}")
    tokens = int(stats["tokens"])
    MEASURE["d"] = _kv_pool_check(engine, cfg)

    # -- prefill time per bucket (after the counted run) ---------------------
    programs, model = engine.programs, engine.model
    gen = torch.Generator(device="cuda").manual_seed(2)
    prefill_ms = {}
    for bucket in programs.buckets:
        toks = torch.randint(1, cfg.vocab_size, (1, bucket), generator=gen,
                             device="cuda")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            programs.prefill_logits(model, toks, bucket)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        prefill_ms[str(bucket)] = statistics.median(times[1:])
    emit({
        "phase": "serve",
        "model": "gpt2-1.5b (48 layers, d_model 1600, 25 heads x 64, vocab "
                 "50304, bf16, random weights seed 0)",
        "slots": SLOTS, "requests": len(requests), "prefills": prefills,
        "flash_launches": launches,
        "flash_launches_per_prefill": launches / prefills,
        "generated_tokens": tokens, "run_s": run_s,
        "generated_tokens_per_s": tokens / run_s,
        "decode_step_p50_s": stats["decode_step_p50_s"],
        "decode_step_p95_s": stats["decode_step_p95_s"],
        "decode_steps": stats["decode_step_n"],
        "request_p50_s": stats["p50_s"], "request_p95_s": stats["p95_s"],
        "occupancy": stats["occupancy"],
        "prefill_ms_by_bucket": prefill_ms,
        "peak_memory_allocated_bytes": peak,
        "setup_s": setup_s, "warmup_s": warmup_s,
    })

    # -- where the device time goes ------------------------------------------
    toks512 = torch.randint(1, cfg.vocab_size, (1, 512), generator=gen,
                            device="cuda")
    pool = programs.init_cache()
    step_tokens = torch.randint(1, cfg.vocab_size, (SLOTS,), generator=gen,
                                device="cuda")
    step_pos = torch.full((SLOTS,), 600, device="cuda")
    programs.decode_logits(model, pool, step_tokens, step_pos)
    emit({
        "phase": "profile",
        "prefill_512": _profile(
            lambda: programs.prefill_logits(model, toks512, 512)),
        "decode_step_8_slots": _profile(
            lambda: programs.decode_logits(model, pool, step_tokens,
                                           step_pos)),
    })
    del pool

    # -- parity on the card ---------------------------------------------------
    prompt = requests[8].prompt  # greedy, 100 tokens -> bucket 128
    padded, n = pad_to_bucket(prompt, programs.buckets)
    padded = torch.as_tensor(padded[None], device="cuda")
    before = fa.LAUNCHES["flash_fwd"]
    row, kernel_logits = programs.prefill_logits(model, padded, n)
    if fa.LAUNCHES["flash_fwd"] != before + cfg.num_layers:
        raise AssertionError("parity prefill did not run the kernel")
    with _attention_through_reference():
        _, ref_logits = programs.prefill_logits(model, padded, n)
    prefill_err = float((kernel_logits - ref_logits).abs().max())
    first = kernel_logits.argmax(-1)
    step_logits = programs.decode_logits(
        model, row, first, torch.tensor([n], device="cuda")
    )
    twin = TransformerLM(dataclasses.replace(cfg, decode=False),
                         device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    full = torch.cat([torch.as_tensor(prompt, device="cuda"), first])
    with torch.no_grad():
        full_logits = twin(full[None])[:, -1]
    decode_err = float((step_logits - full_logits).abs().max())
    parity = {
        "phase": "parity",
        "prompt_len": n, "bucket": int(padded.shape[1]),
        "logits_std": float(ref_logits.std()),
        "prefill_kernel_vs_reference_max_abs": prefill_err,
        "prefill_argmax_equal": bool(
            kernel_logits.argmax() == ref_logits.argmax()),
        "decode_vs_full_forward_max_abs": decode_err,
        "decode_argmax_equal": bool(
            step_logits.argmax() == full_logits.argmax()),
        "atol": LOGIT_ATOL,
    }
    emit(parity)
    if not (prefill_err <= LOGIT_ATOL and decode_err <= LOGIT_ATOL
            and parity["prefill_argmax_equal"]
            and parity["decode_argmax_equal"]):
        raise AssertionError(f"parity failed: {parity}")
    del programs, model, twin, row
    fault_counts = serve_faults_and_check(engine, requests)
    del engine
    torch.cuda.empty_cache()
    return counts, fault_counts


def _kv_pool_check(engine, cfg):
    """``measure`` (d): after the requests, the registry's ``kv_pool``
    bytes against the pool's shapes (K and V, ``[layers, slots, max_seq,
    kv heads, head dim]`` each, in the config's dtype)."""
    from dlrover_tpu_torch.utils import memory_profile

    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    want = (2 * cfg.num_layers * SLOTS * cfg.max_seq_len
            * cfg.resolved_kv_heads * cfg.resolved_head_dim * itemsize)
    pools = memory_profile.registry().pool_bytes()
    out = {"kv_pool_b": pools["kv_pool"], "kv_from_shapes_b": want,
           "engine_kv_device_bytes": engine.kv_device_bytes(),
           "params_pool_b": pools["params"],
           "params_b": _state_bytes(dict(engine.model.state_dict()))}
    if not (pools["kv_pool"] == want == out["engine_kv_device_bytes"]
            and pools["params"] == out["params_b"]):
        raise AssertionError(f"measure (d): serving's pools: {out}")
    return out


def serve_faults_and_check(engine, requests):
    """The serve phase's engine with a ``serve.admit`` plan that fires on
    ``SERVE_FAULT_HITS`` and a ``RetryPolicy``: the greedy requests of
    ``SERVE_REQUESTS``, first plan-free, then (counted as this phase's
    path) under the plan.  Every request finishes, the greedy streams
    equal the plan-free run's token for token, and the telemetry ring holds
    one fault event per fired hit.  Returns the path's launch counts."""
    from dlrover_tpu_torch.common import faults, telemetry
    from dlrover_tpu_torch.common.retry import RetryPolicy

    greedy = [r for r in requests if r.sampling.temperature == 0.0]

    def run(tag):
        got = engine.run([dataclasses.replace(r, uid=f"{tag}{r.uid}")
                          for r in greedy])
        return {r.uid: got[f"{tag}{r.uid}"] for r in greedy}

    faults.reset()
    clean = run("clean_")
    rec = telemetry.recorder()
    rec.configure(enabled=True)
    rec.drain()
    plan = "serve.admit:error@" + ",".join(map(str, SERVE_FAULT_HITS))
    engine.admit_policy = RetryPolicy(
        max_attempts=4, base_delay_s=0.01, max_delay_s=0.05, jitter=False,
        retryable=(faults.FaultInjected,), name="serve.admit", quiet=True)
    faults.configure(plan, seed=0)
    _zero_counts()
    t0 = time.perf_counter()
    try:
        faulted = run("fault_")
    finally:
        fired = list(faults.active().fired)
        faults.reset()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _counts()
    events = rec.drain()
    fault_events = [e for e in events if e[0] == "fault"
                    and e[4].get("seam") == "serve.admit"]
    retries = [e for e in events if e[0] == "retry"]
    finished = all(len(faulted[r.uid].tokens) == r.sampling.max_new_tokens
                   for r in greedy)
    equal = all(np.array_equal(faulted[r.uid].tokens, clean[r.uid].tokens)
                for r in greedy)
    out = {
        "phase": "serve_faults", "plan": plan, "requests": len(greedy),
        "fired": fired, "fault_events": len(fault_events),
        "fault_event_hits": [e[4]["hit"] for e in fault_events],
        "retry_events": len(retries), "every_request_finished": finished,
        "streams_equal_plan_free": equal, "run_s": run_s,
        "flash_launches": counts["flash_fwd"],
    }
    emit(out)
    if not (finished and equal and len(fired) == len(SERVE_FAULT_HITS)
            and len(fault_events) == len(fired)
            and out["fault_event_hits"] == list(SERVE_FAULT_HITS)):
        raise AssertionError(f"serve_faults failed: {out}")
    return counts


# -- serving, the rest: speculation, the fleet, MoE ---------------------------

#: ``serve_spec``: γ, the draft's layers and the damping of the target's
#: later blocks (``serving/draft.make_draft``).
SPEC_GAMMA, SPEC_DRAFT_LAYERS, SPEC_DAMP = 4, 1, 0.05
#: Greedy requests (prompt length, max_new_tokens): as many as the slots,
#: one length of stream, so the teacher-forced replay covers every
#: position a stream can split at; then the sampled ones.
SPEC_GREEDY = [(5, 24), (16, 24), (20, 24), (40, 24), (64, 24), (100, 24),
               (128, 24), (200, 24)]
SPEC_SAMPLED = [(12, 16), (30, 16), (70, 16), (150, 16)]
#: A greedy spec stream may leave the plain stream only at a near-tie the
#: verify chunk's other GEMM shapes can flip: where the plain step's logit
#: of the plain token exceeds its logit of the spec token by at most this
#: (bf16 logits).  About 3x the largest |verify - plain| logit gap at the
#: same positions, 0.046875 on an H100 (two streams of eight split, both
#: at exact bf16 ties, gap 0); the planted fault's splits read 0.66-0.86.
SPEC_TIE_TOL = 0.14
#: ``serve_fleet``: GPT-2 1.5B's width at this many of its 48 layers (a
#: cut for the script's time; the widths are whole), 8 slots an engine.
FLEET_LAYERS = 4
FLEET_REQUESTS = [(5, 16), (16, 12), (20, 16), (33, 12), (40, 16), (64, 12),
                  (70, 16), (100, 12), (128, 16), (9, 12), (50, 16),
                  (90, 12)]
#: The ``replica.death`` hit that kills a replica: the fleet probes its
#: two replicas in order every tick, so hit 6 is replica-1 in tick 3, with
#: every one of its requests still decoding.
FLEET_DEATH_HIT = 6
#: ``serve_moe``: the MoE entry at ``MOE_TRAIN_LAYERS`` layers.
MOE_SERVE_REQUESTS = [(5, 16), (16, 12), (40, 16), (64, 12), (100, 16),
                      (128, 12), (200, 16), (300, 12)]


def _request_list(vocab, shapes, seed, prefix, sampled_from=None):
    """Requests of the given (prompt length, max_new_tokens) shapes,
    prompts drawn from ``seed``; greedy, or from index ``sampled_from``
    on temperature 0.8 / top-k 8."""
    from dlrover_tpu_torch.rl.generation import SamplingParams
    from dlrover_tpu_torch.serving import Request

    gen = torch.Generator().manual_seed(seed)
    out = []
    for i, (n, m) in enumerate(shapes):
        prompt = torch.randint(1, vocab, (n,), generator=gen).numpy()
        sampled = sampled_from is not None and i >= sampled_from
        sampling = (SamplingParams(temperature=0.8, top_k=8,
                                   max_new_tokens=m) if sampled
                    else SamplingParams(temperature=0.0, max_new_tokens=m))
        out.append(Request(f"{prefix}{i:02d}", prompt, sampling))
    return out


def _check_finished(results, requests, vocab):
    for req in requests:
        res = results.get(req.uid)
        want = req.sampling.max_new_tokens
        if res is None or len(res.tokens) != want or len(res.logprobs) != want:
            raise AssertionError(f"{req.uid}: did not finish its {want} "
                                 f"tokens")
        if not np.isfinite(res.logprobs).all():
            raise AssertionError(f"{req.uid}: non-finite logprobs")
        if ((res.tokens < 0) | (res.tokens >= vocab)).any():
            raise AssertionError(f"{req.uid}: token outside the vocab")


def _in_top_k(model, requests, results, k):
    """The sampled tokens outside the top ``k`` of a no-cache forward's
    logits for their prefixes (one forward over a request's whole
    stream): a token passes when its logit is within ``LOGIT_ATOL`` (the
    decode-vs-full-forward limit) of the k-th largest."""
    bad = []
    with torch.no_grad():
        for req in requests:
            toks = torch.as_tensor(results[req.uid].tokens, device="cuda")
            full = torch.cat([torch.as_tensor(req.prompt, device="cuda"),
                              toks])[None]
            logits = model(full)[0, len(req.prompt) - 1:-1].float()
            kth = torch.topk(logits, k, dim=-1).values[:, -1]
            mine = logits.gather(-1, toks[:, None])[:, 0]
            bad += [(req.uid, int(j)) for j in torch.nonzero(
                mine < kth - LOGIT_ATOL)[:, 0].tolist()]
    return bad


def _twin(cfg, model):
    """The no-cache model over the same tensors."""
    from dlrover_tpu_torch.models.transformer import TransformerLM

    twin = TransformerLM(dataclasses.replace(cfg, decode=False),
                         device="meta")
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin.eval()


def _spec_replay(programs, model, requests, plain, gamma):
    """The plain greedy streams teacher-forced through the target, one
    slot a request, twice from the same prefilled rows: one token a step
    (the plain path) and chunks of γ+1 (the verify path).  Returns both
    logits ``[slots, K, V]`` (position k predicts token k+1) and the
    largest |verify - plain| gap."""
    from dlrover_tpu_torch.serving import pad_to_bucket

    slots, steps = len(requests), len(plain[requests[0].uid].tokens) - 1
    pool_a, pool_b = programs.init_cache(), programs.init_cache()
    lens = []
    for slot, req in enumerate(requests):
        padded, n = pad_to_bucket(req.prompt, programs.buckets)
        row, _ = programs.prefill_logits(
            model, torch.as_tensor(padded[None], device="cuda"), n)
        programs.insert(pool_a, row, slot)
        programs.insert(pool_b, row, slot)
        lens.append(n)
    toks = torch.as_tensor(np.stack([plain[r.uid].tokens for r in requests]),
                           device="cuda")
    start = torch.as_tensor(lens, device="cuda")
    plain_logits = torch.stack([
        programs.decode_logits(model, pool_b, toks[:, k], start + k).float()
        for k in range(steps)], dim=1)
    chunks = []
    for k in range(0, steps, gamma + 1):
        width = min(gamma + 1, steps - k)
        chunks.append(programs.chunk_logits(
            model, pool_a, toks[:, k:k + width], start + k).float())
    verify_logits = torch.cat(chunks, dim=1)
    gap = float((verify_logits - plain_logits).abs().max())
    replayed = bool((plain_logits.argmax(-1) == toks[:, 1:]).all())
    return plain_logits, gap, replayed


def _spec_stream_check(requests, plain, spec, plain_logits, tie_tol):
    """Each greedy spec stream against the plain one: equal, or equal up
    to the first differing token, where the plain step's logit of the
    plain token may exceed its logit of the spec token by at most
    ``tie_tol`` (a near-tie between the two; for a flip between the top
    two, their gap); the stream's check stops there."""
    out = []
    for slot, req in enumerate(requests):
        a, b = plain[req.uid].tokens, spec[req.uid].tokens
        differ = np.nonzero(a[:len(b)] != b[:len(a)])[0]
        row = {"uid": req.uid, "len": [int(len(a)), int(len(b))]}
        if len(a) != len(b):
            row.update(status="length", ok=False)
        elif not len(differ):
            row.update(status="equal", ok=True)
        else:
            j = int(differ[0])
            row["first_diff"] = j
            if j == 0 or j - 1 >= plain_logits.shape[1]:
                row.update(status="outside the replay", ok=False)
            else:
                logits = plain_logits[slot, j - 1]
                gap = float(logits[int(a[j])] - logits[int(b[j])])
                row.update(status="near tie" if gap <= tie_tol else "split",
                           logit_gap=gap, ok=gap <= tie_tol)
        out.append(row)
    return out


def _accept_one_past(accept):
    """The planted verify fault: a greedy row accepts one proposal past
    its first mismatch."""

    def faulty(logits, chunk, generator, temps, topks, max_top_k):
        emitted, emit_len, logps, accepted = accept(
            logits, chunk, generator, temps, topks, max_top_k)
        gamma = chunk.shape[1] - 1
        more = (temps <= 0.0) & (accepted < gamma)
        accepted = torch.where(more, accepted + 1, accepted)
        idx = torch.arange(chunk.shape[1], device=chunk.device)[None, :]
        bonus = logits.float().argmax(-1).gather(1, accepted[:, None])
        prop = torch.cat([chunk[:, 1:], chunk[:, :1]], dim=1)
        emitted = torch.where(idx < accepted[:, None], prop, bonus)
        logps = torch.log_softmax(logits.float(), -1).gather(
            -1, emitted[..., None])[..., 0]
        return emitted, accepted + 1, logps, accepted

    return faulty


def serve_spec_and_check():
    """``serve_spec``: speculative decoding at GPT-2 1.5B (full depth and
    width, bf16, flash) on a target damped by ``make_draft``, its
    1-layer draft, γ = ``SPEC_GAMMA``, 8 slots.  Returns the counted
    path's launches."""
    from dlrover_tpu_torch.models import gpt2_config, init_params
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.serving import ServingEngine, decode, make_draft

    cfg = gpt2_config("1.5b", attention_impl="flash",
                      param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    draft_cfg, draft, damped = make_draft(cfg, params, SPEC_DRAFT_LAYERS,
                                          SPEC_DAMP)
    del params
    plain_engine = ServingEngine(cfg, damped, slots=SLOTS, device="cuda")
    spec_engine = ServingEngine(cfg, damped, slots=SLOTS, device="cuda",
                                draft_config=draft_cfg, draft_params=draft,
                                spec_tokens=SPEC_GAMMA)
    del damped, draft
    spec_engine.aot_compile()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    greedy = _request_list(cfg.vocab_size, SPEC_GREEDY, 3, "g")
    sampled = _request_list(cfg.vocab_size, SPEC_SAMPLED, 4, "s",
                            sampled_from=0)

    def leg(engine):
        _zero_counts()
        t = time.perf_counter()
        results = engine.run(greedy + sampled)
        torch.cuda.synchronize()
        return results, time.perf_counter() - t, _counts(), engine.stats()

    plain, plain_s, plain_counts, plain_stats = leg(plain_engine)
    # The counted path: K1 launches inside propose and verify are
    # counted apart (none may happen there).
    spec_programs = spec_engine.spec
    inside = {"propose": 0, "verify": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            before = fa.LAUNCHES["flash_fwd"]
            out = fn(*args, **kwargs)
            inside[name] += fa.LAUNCHES["flash_fwd"] - before
            return out
        return run

    spec_programs.propose = counted("propose", spec_programs.propose)
    spec_programs.verify = counted("verify", spec_programs.verify)
    try:
        spec, spec_s, counts, stats = leg(spec_engine)
    finally:
        del spec_programs.propose, spec_programs.verify
    for results in (plain, spec):
        _check_finished(results, greedy + sampled, cfg.vocab_size)
    # The phase's path is both legs.
    path_counts = {k: v + plain_counts[k] for k, v in counts.items()}
    prefills, plain_prefills = int(stats["prefills"]), int(
        plain_stats["prefills"])
    want_k1 = prefills * (cfg.num_layers + draft_cfg.num_layers)
    k1_ok = (counts["flash_fwd"] == want_k1
             and plain_counts["flash_fwd"] == plain_prefills * cfg.num_layers
             and inside == {"propose": 0, "verify": 0}
             and not any(v for k, v in counts.items() if k != "flash_fwd"))
    # Where greedy streams may split: the verify-vs-plain logit gap on the
    # plain streams, teacher-forced.
    t = time.perf_counter()
    plain_logits, gap, replayed = _spec_replay(
        spec_engine.programs, spec_engine.model, greedy, plain, SPEC_GAMMA)
    rows = _spec_stream_check(greedy, plain, spec, plain_logits,
                              SPEC_TIE_TOL)
    replay_s = time.perf_counter() - t
    top_k_bad = _in_top_k(_twin(cfg, spec_engine.model), sampled, spec, 8)
    # The planted fault: one proposal past the first mismatch accepted.
    kernel_accept = decode.accept_chunk
    decode.accept_chunk = _accept_one_past(kernel_accept)
    try:
        planted = spec_engine.run([dataclasses.replace(r, uid=f"p_{r.uid}")
                                   for r in greedy])
    finally:
        decode.accept_chunk = kernel_accept
    planted = {r.uid: planted[f"p_{r.uid}"] for r in greedy}
    planted_rows = _spec_stream_check(greedy, plain, planted, plain_logits,
                                      SPEC_TIE_TOL)
    greedy_rounds = stats["spec_proposed"] / SPEC_GAMMA
    out = {
        "phase": "serve_spec",
        "model": "gpt2-1.5b target (48 layers, bf16, flash, random weights "
                 f"seed 0) damped by make_draft(draft_layers="
                 f"{SPEC_DRAFT_LAYERS}, damp={SPEC_DAMP}); draft "
                 f"{draft_cfg.num_layers} layer",
        "gamma": SPEC_GAMMA, "slots": SLOTS,
        "requests": {"greedy": len(greedy), "sampled": len(sampled)},
        "accept_rate": stats["spec_accept_rate"],
        "accepted": stats["spec_accepted"],
        "proposed": stats["spec_proposed"],
        "verify_rounds": stats["spec_rounds"],
        "tokens_per_greedy_row_round": (
            1 + stats["spec_accepted"] / greedy_rounds
            if greedy_rounds else None),
        "tokens_per_round": (stats["tokens"] - prefills) / stats[
            "spec_rounds"],
        "plain": {"decode_step_p50_s": plain_stats["decode_step_p50_s"],
                  "decode_step_p95_s": plain_stats["decode_step_p95_s"],
                  "steps": plain_stats["decode_step_n"],
                  "generated_tokens_per_s": plain_stats["tokens"] / plain_s,
                  "run_s": plain_s},
        "spec": {"decode_step_p50_s": stats["decode_step_p50_s"],
                 "decode_step_p95_s": stats["decode_step_p95_s"],
                 "steps": stats["decode_step_n"],
                 "generated_tokens_per_s": stats["tokens"] / spec_s,
                 "run_s": spec_s},
        "verify_vs_plain_logit_gap": gap, "tie_tol": SPEC_TIE_TOL,
        "replay_reproduces_plain": replayed, "replay_s": replay_s,
        "streams": rows,
        "flash_launches": counts["flash_fwd"], "flash_wanted": want_k1,
        "plain_flash_launches": plain_counts["flash_fwd"],
        "flash_in_propose_verify": inside,
        "sampled_outside_top_k": top_k_bad,
        "planted_one_past_mismatch": {
            "caught": not all(r["ok"] for r in planted_rows),
            "splits": sum(not r["ok"] for r in planted_rows),
            "largest_logit_gap": max(
                (r.get("logit_gap", 0.0) for r in planted_rows),
                default=0.0),
            "streams": [r for r in planted_rows if not r["ok"]][:3]},
        "setup_s": setup_s,
    }
    emit(out)
    if not (k1_ok and all(r["ok"] for r in rows) and stats[
            "spec_accepted"] > 0 and not top_k_bad
            and out["planted_one_past_mismatch"]["caught"]):
        raise AssertionError(f"serve_spec failed: {out}")
    del plain_engine, spec_engine
    torch.cuda.empty_cache()
    return path_counts


def _fleet_run(fleet, budget=2000):
    for _ in range(budget):
        if fleet.pending() == 0:
            return True
        fleet.step()
    return fleet.pending() == 0


def _fleet_tokens(results, uids):
    return {u: results[u].tokens for u in uids}


def _same_streams(got, want):
    return sorted(got) == sorted(want) and all(
        np.array_equal(got[u], want[u]) for u in want)


def _fleet_swap(cfg, engine_fn, requests, params_seed1):
    """(d): a live swap to seed-1 weights between two steps, then one
    under a ``serve.swap`` plan."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common import faults
    from dlrover_tpu_torch.trainer import state_digest as sd

    ckpt_dir = os.path.join(REPO, "build", "serve_swap")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    saved_env = {k: os.environ.get(k) for k in ("DLROVER_TPU_JOB",
                                                "DLROVER_TPU_SOCKET_DIR")}
    sock_dir = tempfile.mkdtemp(prefix="swap_socks_")
    os.environ["DLROVER_TPU_SOCKET_DIR"] = sock_dir
    os.environ["DLROVER_TPU_JOB"] = f"swap{os.getpid()}"
    saver = AsyncCheckpointSaver(ckpt_dir, host_index=0, num_hosts=1)
    saver.start()
    ckpt = CheckpointEngine(ckpt_dir, host_index=0, num_hosts=1,
                            agree_step_fn=lambda c: c, device="cuda")
    try:
        if not (ckpt.save_to_storage(7, {"params": params_seed1})
                and ckpt.wait_saver(timeout=300)):
            raise AssertionError("serve_fleet: the seed-1 checkpoint was "
                                 "not committed")
        engine = engine_fn(0)
        first, after, again = requests[:4], requests[4:8], requests[8:]
        for r in first:
            engine.submit(r)
        engine.step()
        engine.step()
        live, queue = engine._live_slots(), list(engine._queue)
        pool = [t.data_ptr() for t in engine.cache]
        model = engine.model
        before = sd.LAUNCHES["digest_sums"]
        report = engine.swap_weights(ckpt_dir)
        digests = sd.LAUNCHES["digest_sums"] - before
        untouched = (engine._live_slots() == live
                     and list(engine._queue) == queue
                     and [t.data_ptr() for t in engine.cache] == pool
                     and engine.model is model)
        kept = engine.drain()
        lost = [r.uid for r in first if r.uid not in kept]
        fresh = engine_fn(0, params_seed1)
        want = _fleet_tokens(fresh.run(after), [r.uid for r in after])
        got = _fleet_tokens(engine.run(after), [r.uid for r in after])
        faults.configure("serve.swap:error@1", seed=0)
        try:
            before = sd.LAUNCHES["digest_sums"]
            rolled = engine.swap_weights(ckpt_dir)
            rolled_digests = sd.LAUNCHES["digest_sums"] - before
        finally:
            faults.reset()
        want2 = _fleet_tokens(fresh.run(again), [r.uid for r in again])
        got2 = _fleet_tokens(engine.run(again), [r.uid for r in again])
    finally:
        ckpt._shm.close(unlink=True)
        saver.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = {
        "ok": report["ok"], "version": report["version"],
        "step": report["step"], "swap_s": report["seconds"],
        "digest_launches": digests, "untouched": untouched,
        "lost": lost, "streams_equal_fresh_seed1": _same_streams(got, want),
        "rollback": {"ok": rolled["ok"], "rolled_back":
                     rolled["rolled_back"], "version": rolled["version"],
                     "digest_launches": rolled_digests,
                     "streams_equal_fresh_seed1": _same_streams(got2,
                                                                want2)},
    }
    return out


def _fleet_frontend(engine_fn, vocab):
    """(e): the front door over a one-replica fleet."""
    from dlrover_tpu_torch.common import faults
    from dlrover_tpu_torch.master import messages as msg
    from dlrover_tpu_torch.serving import ReplicaFleet, ServeFrontend

    fleet = ReplicaFleet()
    engine = engine_fn(0)
    fleet.add_replica(engine)
    front = ServeFrontend(fleet, max_pending=4)
    gen = torch.Generator().manual_seed(9)

    def submit(uid, deadline_s=30.0):
        prompt = tuple(int(t) for t in torch.randint(1, vocab, (12,),
                                                     generator=gen))
        t = front.submit(msg.ServeSubmit(uid=uid, prompt=prompt,
                                         max_new_tokens=8,
                                         deadline_s=deadline_s))
        return t.accepted, t.reason

    out = {"first": submit("f0")}
    out["pending"] = front.poll(msg.ServePoll(uid="f0")).state
    _fleet_run(fleet)
    done = front.poll(msg.ServePoll(uid="f0"))
    out["done"] = [done.state, len(done.tokens)]
    out["fill"] = [submit(f"q{i}") for i in range(5)]
    out["cancel_queued"] = front.cancel(msg.ServeCancel(uid="q3")).state
    _fleet_run(fleet)
    front.max_pending = 64
    out["backlog"] = [submit(f"b{i}")[0] for i in range(10)]
    out["tight"] = submit("tight", deadline_s=1e-9)
    _fleet_run(fleet)
    faults.configure("serve.rpc:error@2", seed=0)
    try:
        rpc = [submit("rpc0")]
        try:
            front.poll(msg.ServePoll(uid="rpc0"))
            rpc.append("no fault")
        except faults.FaultInjected:
            rpc.append("fault")
        rpc.append(front.poll(msg.ServePoll(uid="rpc0")).state)
        fired = list(faults.active().fired)
    finally:
        faults.reset()
    _fleet_run(fleet)
    out["rpc"] = rpc
    out["rpc_fired"] = [list(f) for f in fired]
    out["counts"] = [front.submitted, front.shed_count, front.rejected_full]
    out["ok"] = (out["first"] == (True, "") and out["pending"] == "pending"
                 and out["done"] == ["done", 8]
                 and out["fill"][:4] == [(True, "")] * 4
                 and out["fill"][4] == (False, "queue_full")
                 and out["cancel_queued"] == "cancelled"
                 and all(out["backlog"])
                 and out["tight"][0] is False and out["tight"][1] == "shed"
                 and rpc == [(True, ""), "fault", "pending"]
                 and out["rpc_fired"] == [["serve.rpc", "error", 2]])
    return out


def serve_fleet_and_check():
    """``serve_fleet``: replicas of GPT-2 1.5B's width at
    ``FLEET_LAYERS`` layers, 8 slots each: failover under a
    ``replica.death`` plan, drain and scale, disaggregated prefill, a live
    weight swap and the front door.  Returns the counted path's
    launches."""
    from dlrover_tpu_torch.common import faults
    from dlrover_tpu_torch.master.auto_scaler import ServeScalePolicy
    from dlrover_tpu_torch.models import gpt2_config, init_params
    from dlrover_tpu_torch.serving import ReplicaFleet, ServingEngine

    cfg = gpt2_config("1.5b", attention_impl="flash",
                      param_dtype=torch.bfloat16, num_layers=FLEET_LAYERS)
    params = init_params(cfg, seed=0, device="cuda")
    params1 = init_params(cfg, seed=1, device="cuda")
    engines = []

    def engine_fn(seed, weights=None, role="mixed"):
        engine = ServingEngine(cfg, params if weights is None else weights,
                               slots=SLOTS, seed=seed, role=role,
                               device="cuda")
        engines.append(engine)
        return engine

    requests = _request_list(cfg.vocab_size, FLEET_REQUESTS, 5, "f")
    uids = [r.uid for r in requests]
    t_phase = time.perf_counter()
    _zero_counts()
    single = _fleet_tokens(engine_fn(0).run(requests), uids)
    # (a) failover: two mixed replicas, one killed mid-run.
    fleet = ReplicaFleet()
    fleet.add_replica(engine_fn(0))
    fleet.add_replica(engine_fn(1))
    assigned = [fleet.submit(r) for r in requests]
    faults.configure(f"replica.death:error@{FLEET_DEATH_HIT}", seed=0)
    try:
        done = _fleet_run(fleet)
        fired = list(faults.active().fired)
    finally:
        faults.reset()
    failover = {
        "assigned": collections.Counter(assigned), "done": done,
        "deaths": fleet.deaths, "resubmitted": fleet.resubmitted,
        "step_failures": fleet.step_failures,
        "breakers": [r.breaker.state for r in fleet._replicas.values()],
        "fired": [list(f) for f in fired],
        "zero_lost": sorted(fleet.results) == sorted(uids),
        "streams_equal_single": done and _same_streams(
            _fleet_tokens(fleet.results, uids), single),
    }
    failover["ok"] = (failover["zero_lost"] and failover[
        "streams_equal_single"] and fleet.deaths == 1
        and fleet.step_failures == 0
        and set(failover["breakers"]) == {"closed"}
        and failover["fired"] == [["replica.death", "error",
                                   FLEET_DEATH_HIT]])
    # (b) drain, then scale out through spawn and back in.
    fleet = ReplicaFleet(spawn=lambda: engine_fn(5))
    fleet.add_replica(engine_fn(0))
    fleet.add_replica(engine_fn(1))
    for r in requests[:8]:
        fleet.submit(r)
    fleet.step()
    fleet.step()
    fleet.drain("replica-0")
    drained = {"retired": fleet.retired, "replicas": fleet.replica_ids()}
    drained["done"] = _fleet_run(fleet)
    drained["streams_equal_single"] = _same_streams(
        _fleet_tokens(fleet.results, uids[:8]),
        {u: single[u] for u in uids[:8]})
    drained["out"] = fleet.maybe_scale(ServeScalePolicy(
        slo_p95_s=1e-9, min_samples=1))
    drained["after_out"] = len(fleet.replica_ids())
    for r in requests[8:]:
        fleet.submit(r)
    drained["done_after_out"] = _fleet_run(fleet)
    drained["in"] = fleet.maybe_scale(ServeScalePolicy(
        slo_p95_s=1e9, occupancy_high=2.0, occupancy_low=1.1,
        min_samples=1))
    drained["after_in"] = len(fleet.replica_ids())
    drained["retired_total"] = fleet.retired
    drained["zero_lost"] = sorted(fleet.results) == sorted(uids)
    drained["ok"] = (drained["retired"] == 1 and drained["done"]
                     and drained["streams_equal_single"]
                     and drained["out"] == "out"
                     and drained["after_out"] == 2
                     and drained["in"] == "in" and drained["after_in"] == 1
                     and drained["retired_total"] == 2
                     and drained["zero_lost"])
    # (c) disaggregated prefill against a colocated replica.
    colocated = ReplicaFleet()
    colocated.add_replica(engine_fn(0))
    for r in requests:
        colocated.submit(r)
    _fleet_run(colocated)
    disagg = ReplicaFleet()
    disagg.add_replica(engine_fn(0, role="prefill"))
    disagg.add_replica(engine_fn(0, role="decode"))
    for r in requests:
        disagg.submit(r)
    disagg_done = _fleet_run(disagg)
    page_bytes = 2 * cfg.num_layers * cfg.max_seq_len * cfg.num_heads * (
        cfg.d_model // cfg.num_heads) * 2
    d_stats, c_stats = disagg.stats(), colocated.stats()
    pages = {
        "done": disagg_done,
        "streams_equal_colocated": _same_streams(
            _fleet_tokens(disagg.results, uids),
            _fleet_tokens(colocated.results, uids)),
        "pages_streamed": d_stats["pages_streamed"],
        "page_bytes_streamed": d_stats["page_bytes_streamed"],
        "page_bytes_predicted": len(requests) * page_bytes,
        "bytes_per_page_layer": page_bytes // cfg.num_layers,
        "decode_step_p95_s": {"disaggregated": d_stats["decode_step_p95_s"],
                              "colocated": c_stats["decode_step_p95_s"]},
    }
    pages["ok"] = (disagg_done and pages["streams_equal_colocated"]
                   and pages["pages_streamed"] == len(requests)
                   and pages["page_bytes_streamed"]
                   == pages["page_bytes_predicted"])
    swap = _fleet_swap(cfg, engine_fn, requests, params1)
    swap["ok"] = (swap["ok"] and swap["version"] == 1
                  and swap["digest_launches"] == 1 and swap["untouched"]
                  and not swap["lost"] and swap["streams_equal_fresh_seed1"]
                  and swap["rollback"]["rolled_back"]
                  and not swap["rollback"]["ok"]
                  and swap["rollback"]["version"] == 1
                  and swap["rollback"]["digest_launches"] == 1
                  and swap["rollback"]["streams_equal_fresh_seed1"])
    front = _fleet_frontend(engine_fn, cfg.vocab_size)
    torch.cuda.synchronize()
    counts = _counts()
    phase_s = time.perf_counter() - t_phase
    prefills = sum(int(e.stats()["prefills"]) for e in engines)
    want = _per_step(flash_fwd=prefills * cfg.num_layers, digest_sums=2)
    out = {
        "phase": "serve_fleet",
        "model": f"gpt2-1.5b width at {cfg.num_layers} of 48 layers (bf16, "
                 "flash, random weights seed 0; seed 1 for the swap)",
        "slots": SLOTS, "requests": len(requests), "engines": len(engines),
        "failover": failover, "drain_scale": drained, "pages": pages,
        "swap": swap, "frontend": front,
        "prefills": prefills, "launches": {k: v for k, v in counts.items()
                                           if v},
        "launches_wanted": {k: v for k, v in want.items() if v},
        "seconds": phase_s,
    }
    emit(out)
    if not (failover["ok"] and drained["ok"] and pages["ok"] and swap["ok"]
            and front["ok"] and counts == want):
        raise AssertionError(f"serve_fleet failed: {out}")
    del engines, params, params1
    torch.cuda.empty_cache()
    return counts


def _moe_decode_routing(programs, model, pool, tokens, positions):
    """Block 0's grouped dispatch at a decode step: ``(rows [n_pad, d],
    group_sizes, counts)`` of the step's token choices (the layer's
    ``route`` on the step's own input, captured by a hook)."""
    seen = {}
    moe = model.blocks[0].moe
    hook = moe.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0].detach().clone()))
    try:
        programs.decode_logits(model, pool, tokens, positions)
    finally:
        hook.remove()
    x = seen["x"]
    x_flat = x.reshape(-1, x.shape[-1]).to(moe.dtype)
    with torch.no_grad():
        r = moe.route(x_flat, moe.router(x.float()).reshape(
            x_flat.shape[0], -1))
    return r


def serve_moe_and_check():
    """``serve_moe``: ``bench.py``'s MoE entry (grouped dispatch) at
    ``MOE_TRAIN_LAYERS`` layers, bf16, 8 slots, serving
    ``MOE_SERVE_REQUESTS``: K8 for every expert product of every prefill
    and decode step.  Returns the counted path's launches."""
    from dlrover_tpu_torch.models import init_params
    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.serving import ServingEngine, pad_to_bucket

    cfg = moe_config(num_layers=MOE_TRAIN_LAYERS)
    products = 3 if cfg.activation == "swiglu" else 2
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    engine = ServingEngine(cfg, params, slots=SLOTS, device="cuda")
    del params
    engine.aot_compile()
    requests = _request_list(cfg.vocab_size, MOE_SERVE_REQUESTS, 6, "m",
                             sampled_from=len(MOE_SERVE_REQUESTS) // 2)
    _zero_counts()
    t = time.perf_counter()
    results = engine.run(requests)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    counts = _counts()
    stats = engine.stats()
    _check_finished(results, requests, cfg.vocab_size)
    prefills, steps = int(stats["prefills"]), int(stats["decode_step_n"])
    want = _per_step(flash_fwd=prefills * cfg.num_layers,
                     gmm_fwd=products * cfg.num_layers * (prefills + steps))
    programs, model = engine.programs, engine.model
    gen = torch.Generator(device="cuda").manual_seed(7)
    # One decode step under sync debug mode "error" (inputs made first).
    pool = programs.init_cache()
    step_tokens = torch.randint(1, cfg.vocab_size, (SLOTS,), generator=gen,
                                device="cuda")
    step_pos = torch.full((SLOTS,), 300, device="cuda")
    programs.decode_logits(model, pool, step_tokens, step_pos)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        programs.decode_logits(model, pool, step_tokens, step_pos)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # Prefill through K8 against the plain grouped matmul swapped in.
    prompt = requests[4].prompt
    padded, n = pad_to_bucket(prompt, programs.buckets)
    padded = torch.as_tensor(padded[None], device="cuda")
    row, kernel_logits = programs.prefill_logits(model, padded, n)
    with _gmm_swapped(fwd=_gmm_reference_fns()[0]):
        _, ref_logits = programs.prefill_logits(model, padded, n)
    prefill_err = float((kernel_logits - ref_logits).abs().max())
    # A decode step against a no-cache forward of the same prefix.
    first = kernel_logits.argmax(-1)
    step_logits = programs.decode_logits(
        model, row, first, torch.tensor([n], device="cuda"))
    full = torch.cat([torch.as_tensor(prompt, device="cuda"), first])
    with torch.no_grad():
        full_logits = _twin(cfg, model)(full[None])[:, -1]
    decode_err = float((step_logits - full_logits).abs().max())
    # K8 at the decode step's shape: 8 slots x top-2 choices in
    # (ceil(16 / 128) + 8) x 128 rows, most of them padding.
    routing = _moe_decode_routing(programs, model, pool, step_tokens,
                                  step_pos)
    moe = model.blocks[0].moe
    wi = moe.wi.detach().to(moe.dtype)
    wo = moe.wo.detach().to(moe.dtype)
    gs = routing.group_sizes
    with torch.no_grad():
        h = gm.gmm_fwd(routing.rows, wi, gs, GMM_BLOCK)
        h_ref = gm.grouped_matmul_reference(routing.rows, wi, gs)
        act = torch.nn.functional.gelu(h, approximate="tanh")
        o = gm.gmm_fwd(act, wo, gs, GMM_BLOCK)
        o_ref = gm.grouped_matmul_reference(act, wo, gs)
        # Planted: the step's rows routed to the wrong expert (each block
        # times the next expert's weights).
        wrong = gm.gmm_fwd(routing.rows, wi.roll(1, dims=0).contiguous(),
                           gs, GMM_BLOCK)
    decode_gmm = {"fwd_wi": gmm_errors(h, h_ref),
                  "fwd_wo": gmm_errors(o, o_ref)}
    planted = gmm_errors(wrong, h_ref)
    out = {
        "phase": "serve_moe",
        "model": f"bench.py moe entry (8 experts, top-2, d_ff 3200, gelu, "
                 f"grouped) at {cfg.num_layers} of 48 layers, bf16, random "
                 "weights seed 0",
        "slots": SLOTS, "requests": len(requests), "prefills": prefills,
        "decode_steps": steps, "run_s": run_s,
        "generated_tokens_per_s": stats["tokens"] / run_s,
        "decode_step_p50_s": stats["decode_step_p50_s"],
        "decode_step_p95_s": stats["decode_step_p95_s"],
        "launches": {k: v for k, v in counts.items() if v},
        "launches_wanted": {k: v for k, v in want.items() if v},
        "sync_debug_decode_step": "error mode, passed",
        "prefill_kernel_vs_plain_gmm_max_abs": prefill_err,
        "prefill_argmax_equal": bool(kernel_logits.argmax()
                                     == ref_logits.argmax()),
        "decode_vs_full_forward_max_abs": decode_err,
        "decode_argmax_equal": bool(step_logits.argmax()
                                    == full_logits.argmax()),
        "atol": LOGIT_ATOL,
        "decode_gmm": {"rows": int(routing.rows.shape[0]),
                       "group_sizes": gs.tolist(),
                       "choices": routing.counts.tolist(),
                       **decode_gmm},
        "planted_wrong_expert": {**planted, "caught": not gmm_ok(planted)},
        "seconds": time.perf_counter() - t0,
    }
    emit(out)
    if not (counts == want and prefill_err <= LOGIT_ATOL
            and decode_err <= LOGIT_ATOL and out["prefill_argmax_equal"]
            and out["decode_argmax_equal"]
            and all(gmm_ok(e) for e in decode_gmm.values())
            and out["planted_wrong_expert"]["caught"]):
        raise AssertionError(f"serve_moe failed: {out}")
    del engine, programs, model, pool, row
    torch.cuda.empty_cache()
    return counts, out["decode_gmm"]


# -- the seq axis (Ulysses) ------------------------------------------------------

#: ``train_sp2``: Llama-2 7B at full width (as ``train_mp2``) with its depth
#: cut to this many of 32 layers, batch 1 x ``SP2_SEQ`` (its
#: ``max_seq_len``), flash_only; ``flash_block_*`` at the whole sequence,
#: so the backward is the fused kernel (K3) as the reference's dispatch
#: picks it for one block.  Two processes at ``seq=2``: each rank runs 2048
#: tokens, its attention 4096 tokens on 16 of the 32 heads.
SP2_LAYERS = 2
SP2_STEPS = 2
SP2_SEQ = 4096
#: Limits: the larger of ``SP2_NOISE_FACTOR`` x the world-1 run's own
#: noise (two runs of the same batch from the same init; K3's atomics
#: make them differ) and ``SP2_FLOOR``, about 3-4x the largest noise read
#: in four runs on an H100 (PERF.md: loss 1.7e-5 to 2.44e-4, grad norm
#: 4.2e-6 to 4.86e-5, leaves 4.88e-6 to 4.95e-6; the seq=2 run's own gaps
#: to world 1 fell in the same ranges, its loss gap up to 2.6e-4, so the
#: run is as near world 1 as world 1 is to itself); and every leaf nearer
#: the reference than half its own update.  The loss moves 6.4e-3 a step,
#: so a dropped step still fails.  The embedding's update is the smallest
#: (1.94e-5 of its norm at B1 x 4096: 4,096 of 32,000 rows see a token),
#: so the leaf-wise rule, not the smallest update, is what a dropped
#: update of a leaf fails.
SP2_NOISE_FACTOR = 3.0
SP2_FLOOR = {"loss": 1e-3, "norm": 1.5e-4, "param": 2e-5}


def _sp2_config():
    from dlrover_tpu_torch.models import llama_config

    return llama_config("7b", num_layers=SP2_LAYERS, attention_impl="flash",
                        remat="flash_only", param_dtype=torch.bfloat16,
                        flash_block_q=SP2_SEQ, flash_block_kv=SP2_SEQ)


def _sp2_batch(vocab: int):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, vocab, size=(1, SP2_SEQ + 1), dtype=np.int64)
    return {"inputs": torch.as_tensor(tokens[:, :-1], device="cuda"),
            "targets": torch.as_tensor(tokens[:, 1:], device="cuda")}


def _sp2_predicted_wire(cfg, n_params):
    """Bytes one step of one rank hands the seq axis's wire, by leg, and
    the calls: Ulysses' four legs a layer (q, k and v in, the output back)
    in the forward, again in flash_only's recompute (it replays the block
    up to the MLP's input of ``wo``, the last tensor the backward saves;
    the flash forward itself is kept, not replayed), and their four
    inverse exchanges in the backward, each leg a rank's ``[1, S / 2, 32,
    128]`` bf16 (half of it stays on the rank); then one all-reduce of
    every gradient (bf16) and the token and loss sums (fp32 scalars, one
    and two)."""
    leg = 1 * (SP2_SEQ // 2) * cfg.num_heads * cfg.resolved_head_dim * 2
    legs = 12 * cfg.num_layers
    return ({"seq/all_to_all": legs * leg,
             "seq/all_reduce": 2 * n_params + 4 + 8},
            {"seq/all_to_all": legs, "seq/all_reduce": 3})


def _sp2_run(cfg, batch, steps):
    """The world-1 run: losses, grad norms, per-step launches, the
    parameters after step 1 and after the last (copies on the card), the
    bytes the state holds and the device peak."""
    from dlrover_tpu_torch.trainer import train_lib

    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=int(batch["inputs"].shape[0]), seq_len=SP2_SEQ,
        device="cuda")
    torch.cuda.reset_peak_memory_stats()
    state = train.init(seed=0)
    out = {"losses": [], "grad_norms": [], "launches": [], "step_s": []}
    for _ in range(steps):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train.step(state, batch)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"].append({k: v for k, v in _counts().items() if v})
        if "params1" not in out:
            out["params1"] = {k: v.clone() for k, v in state.params().items()}
    out["params"] = {k: v.clone() for k, v in state.params().items()}
    out["resident_bytes"] = _resident_bytes(state)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del state, train
    torch.cuda.empty_cache()
    return out


def _sp2_reference(out_dir, cfg=None, ref_file="sp_ref.pt", batch=None,
                   twin=None):
    """Two world-1 runs of the same batch from the same init: the first is
    the reference (saved for the ranks as ``ref_file``), the gaps between
    the two are the noise the limits are derived from.  ``train_sp2``'s
    model and batch unless given; the second run is ``twin`` when given
    (the same function computed another way: a run's ``losses``,
    ``grad_norms`` and ``params``).  Returns the summary and the saved
    run (``losses``, ``grad_norms``, ``params`` and ``params1`` on the
    host)."""
    cfg = cfg or _sp2_config()
    batch = batch or _sp2_batch(cfg.vocab_size)
    a = _sp2_run(cfg, batch, SP2_STEPS)
    b = twin or _sp2_run(cfg, batch, SP2_STEPS)
    rel = 0.0
    for name, w in a["params"].items():
        w = w.double()
        rel = max(rel, float((b["params"][name].to(w.device).double() - w)
                             .norm() / max(float(w.norm()), 1e-30)))
    kept = {"losses": a["losses"], "grad_norms": a["grad_norms"],
            "params": {k: v.cpu() for k, v in a["params"].items()},
            "params1": {k: v.cpu() for k, v in a["params1"].items()}}
    torch.save(kept, os.path.join(out_dir, ref_file))
    noise = {"loss": max(abs(x - y) for x, y in zip(a["losses"],
                                                      b["losses"])),
             "norm": max(abs(x - y) / x for x, y in zip(a["grad_norms"],
                                                          b["grad_norms"])),
             "param": rel}
    return {"losses": a["losses"], "grad_norms": a["grad_norms"],
            "launches": a["launches"], "step_s": a["step_s"],
            "second_losses": b["losses"], "noise": noise,
            "resident_bytes": a["resident_bytes"],
            "peak_memory_bytes": a["peak_memory_bytes"]}, kept


def _sp2_rank(rank, out_dir):
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel import sharding
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_lib

    cfg = _sp2_config()
    ref = torch.load(os.path.join(out_dir, "sp_ref.pt"), weights_only=False)
    mesh = build_mesh(ParallelConfig(data=1, seq=2), device_type="cuda")
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=1, seq_len=SP2_SEQ, mesh=mesh, device="cuda")
    state = train.init(seed=0)
    init = {k: v.clone() for k, v in state.params().items()}
    placed = train_lib.shard_batch(_sp2_batch(cfg.vocab_size), train)
    out = {"rank": rank, "local_tokens": list(placed["inputs"].shape),
           "steps": []}
    for _ in range(SP2_STEPS):
        _zero_counts()
        wire_lib.reset_counts()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train.step(state, placed)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        out["steps"].append({
            "s": time.perf_counter() - t0, "loss": loss, "grad_norm": norm,
            "tokens": float(m["tokens"]),
            "launches": {k: v for k, v in _counts().items() if v},
            "wire_bytes": dict(wire_lib.COUNTS["axes"]),
            "wire_calls": dict(wire_lib.COUNTS["calls"])})
    names, sums = _mp2_leaf_sums(train, state, ref["params"], init)
    out["leaf_sums"] = _mp2_summed(names, sums)
    out["n_params"] = sum(v.numel() for v in state.params().values())
    # The planted fault: every rank's tokens at positions from 0.
    offset = sharding.SeqGroup.offset
    sharding.SeqGroup.offset = lambda self, local_len: 0
    try:
        state = train.init(seed=0)
        state, m = train.step(state, placed)
    finally:
        sharding.SeqGroup.offset = offset
    names, sums = _mp2_leaf_sums(train, state, ref["params1"], init)
    out["planted"] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "leaf_sums": _mp2_summed(names, sums)}
    del state, train, placed, init
    torch.cuda.empty_cache()
    return out


def _fresh_dir(phase):
    import shutil

    out_dir = os.path.join(REPO, "build", phase)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    return out_dir


def _sp2_world1():
    ref, kept = _sp2_reference(_fresh_dir("train_sp2"))
    # train_ring2's twin: the same model and batch under flash.
    _SHARED["sp2_world1"] = kept
    return ref


def _ring2_world1():
    # The second world-1 run computes the attention with the flash
    # kernels (K1/K3): the ring of one must match it within the floors,
    # a gap held to no limit taken from this run.  It is train_sp2's
    # first world-1 run (the same model and batch; its remat changes no
    # value), run here when train_sp2's reference did not run before.
    cfg = _ring2_config()
    twin = _SHARED.pop("sp2_world1", None) or _sp2_run(
        _sp2_config(), _sp2_batch(cfg.vocab_size), SP2_STEPS)
    ref, _ = _sp2_reference(_fresh_dir("train_ring2"), cfg, "ring_ref.pt",
                            twin=twin)
    ref["twin_gap"] = ref.pop("noise")
    ref["ring_op"] = _ring_op_check(cfg)
    return ref


def _pp2_world1():
    cfg = _pp2_config()
    return _sp2_reference(_fresh_dir("train_pp2"), cfg, "pp_ref.pt",
                          _pp2_batch(cfg.vocab_size))[0]


#: Each world phase's world-1 reference: the runs it holds its world's
#: against, into a fresh ``build/<phase>`` directory (the ranks read it
#: there), in the order the phases run.
_WORLD1 = {"train_sp2": _sp2_world1, "train_ring2": _ring2_world1,
           "train_pp2": _pp2_world1}
#: The references computed ahead (:func:`world1_references_start`).
_REFS = {}


def world1_references_start():
    """Computes every ``_WORLD1`` reference in a thread of this process
    while ``train_dp2``'s ranks run: the parent only waits on them there
    (about 100 s, the card mostly idle: their steps are bound by the
    host's staging) and launches no kernel, nor reads the launch
    counters or the device peak, until it joins the thread
    (:func:`world1_references_join`, as soon as the ranks are done)."""
    import threading

    def run():
        try:
            for phase, fn in _WORLD1.items():
                _REFS[phase] = fn()
        except BaseException as e:  # noqa: BLE001 - raised at the join
            _REFS["error"] = e

    _REFS["thread"] = threading.Thread(target=run, daemon=True)
    _REFS["thread"].start()


def world1_references_join():
    thread = _REFS.pop("thread", None)
    if thread is not None:
        thread.join()
    if "error" in _REFS:
        raise _REFS.pop("error")


def _world1_reference(phase):
    """``phase``'s world-1 reference: computed ahead, or now."""
    world1_references_join()
    if phase in _REFS:
        return _REFS.pop(phase)
    return _WORLD1[phase]()


def train_sp2_and_check():
    """Two processes on ``cuda:0`` over a gloo group: the dense Llama step
    at Llama-2 7B's width on a ``seq=2`` mesh (Ulysses), held against the
    world-1 run of the same batch; a planted wrong position offset.
    Returns the counted launches of the runs (both ranks)."""
    import shutil

    out_dir = os.path.join(REPO, "build", "train_sp2")
    cfg = _sp2_config()
    out = {"phase": "train_sp2",
           "model": f"llama-2 7b width (d_model 4096, 32 heads x 128, 32 KV "
                    f"heads, d_ff 11008 swiglu, vocab 32000, untied head, "
                    f"bf16 params and compute, flash_only, flash blocks "
                    f"{SP2_SEQ}), depth cut to {SP2_LAYERS} of 32 layers, "
                    f"random weights seed 0",
           "world": "2 processes on cuda:0, gloo, seq=2 (Ulysses' "
                    "all-to-alls staged through the host)",
           "batch": f"1 x {SP2_SEQ}, one batch re-fed", "steps": SP2_STEPS}
    t_start = time.perf_counter()
    try:
        ref = _world1_reference("train_sp2")
        out["reference"] = ref
        noise = ref["noise"]
        limits = {k: max(SP2_FLOOR[k], SP2_NOISE_FACTOR * noise[k])
                  for k in SP2_FLOOR}
        out["limits"] = limits
        results, codes = _world_run("_sp2_rank", out_dir, "sp_rank{rank}.pt",
                                    600)
        errors = [r.get("error") for r in results if "error" in r]
        if errors or codes != [None, None]:
            for e in errors:
                print(e, flush=True)
            raise AssertionError(f"train_sp2 ranks failed (exit codes "
                                 f"{codes})")
        out["workers_s"] = time.perf_counter() - t_start
        r0, r1 = results
        bad = []
        run = _noise_checks(ref, r0, limits)
        stats = _mp2_leaf_stats(r0["leaf_sums"])
        smallest = min(((v[1], k) for k, v in stats.items() if v[1] > 0),
                       default=(0.0, None))
        wire, calls = _sp2_predicted_wire(cfg, r0["n_params"])
        want = {"flash_fwd": SP2_LAYERS, "flash_bwd_fused": SP2_LAYERS}
        launches = [s["launches"] for s in r0["steps"] + r1["steps"]]
        checks = {
            "loss": run["loss_gap"] <= limits["loss"],
            "grad_norm": run["grad_norm_rgap"] <= limits["norm"],
            "params": run["worst_leaf_rel"][0] <= limits["param"]
            and not run["leaves_nearer_init"],
            "ranks_agree": all(a["loss"] == b["loss"] for a, b in zip(
                r0["steps"], r1["steps"])),
            "tokens": all(s["tokens"] == SP2_SEQ for s in r0["steps"]),
            "local_tokens": r0["local_tokens"] == [1, SP2_SEQ // 2],
            "launches": all(x == want for x in launches)
            and all(x == want for x in ref["launches"]),
            "wire_bytes": all(s["wire_bytes"] == wire and
                              s["wire_calls"] == calls
                              for s in r0["steps"] + r1["steps"]),
        }
        bad += [k for k, ok in checks.items() if not ok]
        planted = _planted_caught(ref, r0["planted"], limits)
        if not planted["caught"]:
            bad.append("planted wrong offset passed")
        counts = dict.fromkeys(_counts(), 0)
        for x in launches:
            for k, v in x.items():
                counts[k] += v
        out.update(
            checks=checks, **{k: v for k, v in run.items() if k != "ok"},
            smallest_update_rel=smallest, leaf_stats=stats,
            step_s=[[s["s"] for s in r["steps"]] for r in (r0, r1)],
            launches_per_step_rank=r0["steps"][-1]["launches"],
            wire_bytes_per_step=r0["steps"][-1]["wire_bytes"],
            wire_calls_per_step=r0["steps"][-1]["wire_calls"],
            wire_bytes_predicted=wire, wire_calls_predicted=calls,
            params=r0["n_params"], planted=planted, launches=counts)
        out["phase_s"] = time.perf_counter() - t_start
        if bad:
            raise AssertionError(f"train_sp2 checks failed: {bad}")
    finally:
        emit(out)
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts


# -- serving TP --------------------------------------------------------------------

#: ``serve_tp2``: Llama-2 7B at full width, bf16 weights from seed 0,
#: flash prefill, with its depth cut to this many of 32 layers and its
#: ``max_seq_len`` to ``SERVE_TP_MAX_SEQ`` (the KV pool's rows, which the
#: folds move through the host); 8 slots.
SERVE_TP_LAYERS = 4
SERVE_TP_MAX_SEQ = 1024
#: Greedy requests, one length of stream (the teacher-forced replay
#: covers every position a stream can split at), then sampled ones.
SERVE_TP_GREEDY = [(5, 16), (16, 16), (20, 16), (40, 16), (64, 16),
                   (100, 16), (128, 16), (200, 16)]
SERVE_TP_SAMPLED = [(12, 12), (30, 12), (70, 12), (150, 12)]
#: The tp=2 decode held to tp=1's: over the teacher-forced replay of the
#: tp=1 greedy streams (every decode position of every stream), the
#: largest |tp2 - tp1| logit (the row-parallel bf16 sums in another
#: order) may be at most this: ``LOGIT_ATOL``, the decode-vs-full-forward
#: limit (0.0645 read on an H100).
SERVE_TP_REPLAY_ATOL = LOGIT_ATOL
#: A tp=2 greedy stream may leave the tp=1 stream only at a near-tie:
#: where the tp=1 step's logit of its token exceeds its logit of the tp=2
#: token by at most this.  Twice the replay limit: with both steps'
#: logits within ``SERVE_TP_REPLAY_ATOL`` of each other, no wider gap can
#: flip (the splits read on an H100 were at 0.015625, one bf16 step).
SERVE_TP_TIE_TOL = 2 * SERVE_TP_REPLAY_ATOL
#: Per-rank KV-pool bytes against tp=1's, at most (the reference's test
#: bound; the port's pool holds no replicated scalars, so 0.5 is
#: expected).
SERVE_TP_KV_SHARE = 0.5 * 1.15
#: The planted shard fault: the first block's MLP wi kernel slice of each
#: rank swapped for the other rank's.
SERVE_TP_PLANTED = "blocks.0.mlp.wi.kernel"


def _serve_tp_config():
    from dlrover_tpu_torch.models import llama_config

    return llama_config("7b", num_layers=SERVE_TP_LAYERS,
                        max_seq_len=SERVE_TP_MAX_SEQ, attention_impl="flash",
                        param_dtype=torch.bfloat16)


def _serve_tp_requests(vocab):
    greedy = _request_list(vocab, SERVE_TP_GREEDY, 11, "g")
    sampled = _request_list(vocab, SERVE_TP_SAMPLED, 12, "s", sampled_from=0)
    return greedy, sampled


def _tp_replay(programs, model, requests, tokens):
    """The given greedy streams teacher-forced one token a step through
    ``programs`` (one slot a request, from their own prefill): the logits
    ``[slots, K, V]`` (fp32, CPU), position k predicting token k+1."""
    from dlrover_tpu_torch.serving import pad_to_bucket

    pool = programs.init_cache()
    lens = []
    for slot, req in enumerate(requests):
        padded, n = pad_to_bucket(req.prompt, programs.buckets)
        row, _ = programs.prefill_logits(
            model, torch.as_tensor(padded[None], device="cuda"), n)
        programs.insert(pool, row, slot)
        lens.append(n)
    toks = torch.as_tensor(np.stack([tokens[r.uid] for r in requests]),
                           device="cuda")
    start = torch.as_tensor(lens, device="cuda")
    steps = toks.shape[1] - 1
    return torch.stack([
        programs.decode_logits(model, pool, toks[:, k], start + k).float()
        for k in range(steps)], dim=1).cpu()


def _tokens_of(results, uids):
    return {u: np.asarray(results[u].tokens) for u in uids}


def _serve_tp_rank(rank, out_dir):
    import dataclasses as dc

    import torch.distributed as dist

    from dlrover_tpu_torch.models import init_params
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.serving import ServingEngine, pick_bucket

    cfg = _serve_tp_config()
    plain = torch.load(os.path.join(out_dir, "plain_tokens.pt"),
                       weights_only=False)
    greedy, sampled = _serve_tp_requests(cfg.vocab_size)
    params = init_params(cfg, seed=0, device="cuda")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, tp=2, slots=SLOTS, device="cuda")
    engine.aot_compile()
    torch.cuda.synchronize()
    out = {"rank": rank, "setup_s": time.perf_counter() - t0,
           "local_kv_heads": int(engine.cache[0].shape[-2])}

    # -- the main path, counted -------------------------------------------
    _zero_counts()
    wire_lib.reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    results = engine.run(greedy + sampled)
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    stats = engine.stats()
    out.update(
        launches={k: v for k, v in _counts().items() if v},
        wire_bytes=dict(wire_lib.COUNTS["axes"]),
        wire_calls=dict(wire_lib.COUNTS["calls"]),
        prefills=int(stats["prefills"]),
        decode_steps=int(stats["decode_step_n"]),
        decode_step_p50_s=stats["decode_step_p50_s"],
        prefill_rows=sum(pick_bucket(len(r.prompt), engine.buckets)
                         for r in greedy + sampled),
        results={u: (r.tokens.tolist(), r.logprobs.tolist())
                 for u, r in results.items()})
    out["kv_bytes"] = engine.kv_device_bytes()
    out["own_kv_bytes"] = sum(t.numel() * t.element_size()
                              for t in engine.cache)
    # The tp=1 greedy streams teacher-forced through this fold.
    replay = _tp_replay(engine.programs, engine.model, greedy, plain)
    if rank == 0:
        torch.save(replay, os.path.join(out_dir, "tp2_replay.pt"))
    del replay

    # -- a fold 2 -> 1 -> 2 mid-serve --------------------------------------
    fold_reqs = [dc.replace(r, uid="f" + r.uid[1:]) for r in greedy]
    for r in fold_reqs:
        engine.submit(r)
    for _ in range(3):
        engine.step()
    wire_lib.reset_counts()
    t0 = time.perf_counter()
    engine.fold_tp(1)
    torch.cuda.synchronize()
    fold = {"down_s": time.perf_counter() - t0,
            "down_wire_bytes": dict(wire_lib.COUNTS["axes"]),
            "parked": engine.parked, "holds_model": engine.model is not None,
            "kv_bytes": engine.kv_device_bytes(),
            "live_at_fold": len(engine._live_slots())}
    for _ in range(4):
        engine.step()
    wire_lib.reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    engine.fold_tp(2)
    torch.cuda.synchronize()
    fold.update(up_s=time.perf_counter() - t0,
                up_wire_bytes=dict(wire_lib.COUNTS["axes"]),
                physical=engine.tp.physical_tp,
                local_kv_heads=int(engine.cache[0].shape[-2]))
    done = engine.drain()
    fold["results"] = {u: done[u].tokens.tolist() for u in done
                       if u.startswith("f")}
    out["fold"] = fold
    del engine
    torch.cuda.empty_cache()

    # -- the planted faults -------------------------------------------------
    engine = ServingEngine(cfg, params, tp=2, slots=SLOTS, device="cuda")
    out["planted"] = {"decode": _serve_tp_plant(
        engine, rank, greedy, plain, "d", out_dir, _rolled_decode_heads)}
    other = engine.tp.split_params(params, engine.programs.config,
                                   rank=1 - rank)[SERVE_TP_PLANTED]
    with torch.no_grad():
        engine.model.get_parameter(SERVE_TP_PLANTED).copy_(other)
    out["planted"]["shard"] = _serve_tp_plant(
        engine, rank, greedy, plain, "p", out_dir, None)
    del engine, params
    torch.cuda.empty_cache()
    return out


def _rolled_decode_heads(rank, real):
    """The planted decode fault: on rank 1, attention over the cache with
    one query a slot (decode; the prefill runs K1) reads the rank's KV
    heads rolled by one."""
    if rank != 1:
        return real

    def rolled(q, k, v, q_positions):
        if q.shape[1] == 1:
            k, v = k.roll(1, dims=-2), v.roll(1, dims=-2)
        return real(q, k, v, q_positions)

    return rolled


def _serve_tp_plant(engine, rank, greedy, plain, prefix, out_dir, plant):
    """The greedy requests (uids under ``prefix``) served by the planted
    ``engine`` and the tp=1 streams teacher-forced through it (rank 0
    saves the replay as ``planted_<prefix>.pt``); ``plant(rank, real)``,
    when given, stands in for ``models.attention.cached_attention``
    meanwhile.  Returns this rank's streams."""
    import dataclasses as dc

    from dlrover_tpu_torch.models import attention as attn

    real = attn.cached_attention
    if plant is not None:
        attn.cached_attention = plant(rank, real)
    try:
        results = engine.run([dc.replace(r, uid=prefix + r.uid[1:])
                              for r in greedy])
        replay = _tp_replay(engine.programs, engine.model, greedy, plain)
    finally:
        attn.cached_attention = real
    if rank == 0:
        torch.save(replay, os.path.join(out_dir, f"planted_{prefix}.pt"))
    return {u: r.tokens.tolist() for u, r in results.items()
            if u.startswith(prefix)}


def serve_tp_and_check():
    """``serve_tp2``: two processes on ``cuda:0`` over a gloo group serving
    Llama-2 7B's width at tp=2 against a tp=1 engine of the same weights in
    this process; a fold 2 -> 1 -> 2 mid-serve; two planted faults (a
    swapped shard, a decode-only fault).  Returns the counted launches
    (both ranks)."""
    import shutil
    from types import SimpleNamespace

    from dlrover_tpu_torch.models import init_params
    from dlrover_tpu_torch.serving import ServingEngine

    out_dir = os.path.join(REPO, "build", "serve_tp2")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    cfg = _serve_tp_config()
    greedy, sampled = _serve_tp_requests(cfg.vocab_size)
    out = {"phase": "serve_tp2",
           "model": f"llama-2 7b width (d_model 4096, 32 heads x 128, 32 KV "
                    f"heads, d_ff 11008, vocab 32000), depth cut to "
                    f"{SERVE_TP_LAYERS} of 32 layers, max_seq_len "
                    f"{SERVE_TP_MAX_SEQ}, bf16 weights seed 0, flash "
                    f"prefill, {SLOTS} slots",
           "world": "2 processes on cuda:0, gloo, tp=2 (the sums and the "
                    "logits gather staged through the host)",
           "requests": {"greedy": SERVE_TP_GREEDY,
                        "sampled": SERVE_TP_SAMPLED}}
    t_start = time.perf_counter()
    try:
        # -- tp=1 in this process -----------------------------------------
        params = init_params(cfg, seed=0, device="cuda")
        plain = ServingEngine(cfg, params, slots=SLOTS, device="cuda")
        del params
        t0 = time.perf_counter()
        plain_res = plain.run(greedy + sampled)
        torch.cuda.synchronize()
        out["plain_run_s"] = time.perf_counter() - t0
        plain_tokens = _tokens_of(plain_res, [r.uid for r in greedy])
        torch.save(plain_tokens, os.path.join(out_dir, "plain_tokens.pt"))
        plain_logits = _tp_replay(plain.programs, plain.model, greedy,
                                  plain_tokens)
        plain_kv = plain.kv_device_bytes()
        del plain
        torch.cuda.empty_cache()

        results, codes = _world_run("_serve_tp_rank", out_dir,
                                    "tp_rank{rank}.pt", 600)
        errors = [r.get("error") for r in results if "error" in r]
        if errors or codes != [None, None]:
            for e in errors:
                print(e, flush=True)
            raise AssertionError(f"serve_tp2 ranks failed (exit codes "
                                 f"{codes})")
        r0, r1 = results
        bad = []

        def as_results(toks):
            return {u: SimpleNamespace(tokens=np.asarray(t))
                    for u, t in toks.items()}

        plain_g = as_results({u: t.tolist() for u, t in plain_tokens.items()})

        def judged(replay_file, toks):
            """A tp=2 run against tp=1: its replay's largest logit gap, its
            greedy streams (uids under any prefix) judged at near-ties,
            and whether both pass."""
            logits = torch.load(os.path.join(out_dir, replay_file))
            gap = float((logits - plain_logits).abs().max())
            streams = _spec_stream_check(greedy, plain_g, as_results(
                {"g" + u[1:]: t for u, t in toks.items()}), plain_logits,
                SERVE_TP_TIE_TOL)
            return gap, streams, (gap <= SERVE_TP_REPLAY_ATOL
                                  and all(x["ok"] for x in streams))

        gap, streams, _ = judged("tp2_replay.pt", {
            u: r0["results"][u][0] for u in plain_tokens})
        fold_streams = _spec_stream_check(greedy, plain_g, as_results(
            {"g" + u[1:]: t for u, t in r0["fold"]["results"].items()}),
            plain_logits, SERVE_TP_TIE_TOL)
        planted = {}
        for name, prefix in (("shard", "p"), ("decode", "d")):
            p_gap, p_streams, p_ok = judged(f"planted_{prefix}.pt",
                                            r0["planted"][name])
            planted[name] = {"replay_max_logit_gap": p_gap,
                             "streams": p_streams, "caught": not p_ok}
        # The decode plant leaves the prefill whole: every first token
        # is tp=1's, and both the replay and the streams must see it.
        dec = planted["decode"]
        dec.update(
            prefill_kept=all(x.get("first_diff") != 0
                             for x in dec["streams"]),
            streams_split=any(x["status"] == "split"
                              for x in dec["streams"]),
            replay_over=dec["replay_max_logit_gap"] > SERVE_TP_REPLAY_ATOL)
        dec["caught"] = (dec["prefill_kept"] and dec["streams_split"]
                         and dec["replay_over"])
        _check_finished({u: SimpleNamespace(tokens=np.asarray(t),
                                            logprobs=np.asarray(lp))
                         for u, (t, lp) in r0["results"].items()},
                        greedy + sampled, cfg.vocab_size)
        rows = r0["prefill_rows"]
        steps, prefills = r0["decode_steps"], r0["prefills"]
        act = cfg.d_model * 2
        wire = {"tensor/all_reduce": (2 * cfg.num_layers + 1) * act
                * (rows + SLOTS * steps),
                "tensor/all_gather": cfg.vocab_size // 2 * 4
                * (prefills + SLOTS * steps)}
        calls = {"tensor/all_reduce": (2 * cfg.num_layers + 1)
                 * (prefills + steps),
                 "tensor/all_gather": prefills + steps}
        kv_share = r0["kv_bytes"] / plain_kv
        checks = {
            "replay_gap": gap <= SERVE_TP_REPLAY_ATOL,
            "greedy_streams": all(s["ok"] for s in streams),
            "ranks_agree": r0["results"] == r1["results"]
            and r0["fold"]["results"] == r1["fold"]["results"],
            "prefills": prefills == len(greedy) + len(sampled),
            "launches": all(r["launches"] == {"flash_fwd": cfg.num_layers
                                              * prefills}
                            for r in (r0, r1)),
            "wire": all(r["wire_bytes"] == wire and r["wire_calls"] == calls
                        for r in (r0, r1)),
            "kv_share": kv_share <= SERVE_TP_KV_SHARE
            and r0["kv_bytes"] == max(r0["own_kv_bytes"],
                                      r1["own_kv_bytes"])
            and r0["local_kv_heads"] == cfg.resolved_kv_heads // 2,
            "fold_down": (r0["fold"]["parked"], r1["fold"]["parked"],
                          r0["fold"]["holds_model"],
                          r1["fold"]["holds_model"],
                          r0["fold"]["kv_bytes"]) == (False, True, True,
                                                      False, plain_kv)
            and r0["fold"]["live_at_fold"] > 0,
            "fold_up": all((r["fold"]["physical"],
                            r["fold"]["local_kv_heads"]) == (
                                2, cfg.resolved_kv_heads // 2)
                           for r in (r0, r1)),
            "fold_streams": len(r0["fold"]["results"]) == len(greedy)
            and all(s["ok"] for s in fold_streams),
        }
        bad += [k for k, ok in checks.items() if not ok]
        bad += [f"planted {name} fault passed"
                for name, p in planted.items() if not p["caught"]]
        counts = dict.fromkeys(_counts(), 0)
        for r in (r0, r1):
            for k, v in r["launches"].items():
                counts[k] += v
        out.update(
            checks=checks, streams=streams, fold_streams=fold_streams,
            planted=dict(planted, faults={
                "shard": f"{SERVE_TP_PLANTED} slices swapped between the "
                         f"ranks",
                "decode": "rank 1's decode attention on its KV heads "
                          "rolled by one"}),
            replay_max_logit_gap=gap, replay_atol=SERVE_TP_REPLAY_ATOL,
            tie_tol=SERVE_TP_TIE_TOL,
            plain_run_s=out["plain_run_s"], tp2_run_s=[r0["run_s"],
                                                       r1["run_s"]],
            setup_s=[r0["setup_s"], r1["setup_s"]],
            decode_steps=steps, prefills=prefills,
            decode_step_p50_s=[r0["decode_step_p50_s"],
                               r1["decode_step_p50_s"]],
            wire_bytes=r0["wire_bytes"], wire_bytes_predicted=wire,
            wire_calls=r0["wire_calls"], wire_calls_predicted=calls,
            kv_bytes=[r0["own_kv_bytes"], r1["own_kv_bytes"]],
            plain_kv_bytes=plain_kv, kv_share=kv_share,
            fold={k: v for k, v in r0["fold"].items() if k != "results"},
            fold_rank1={k: v for k, v in r1["fold"].items()
                        if k != "results"},
            launches=counts)
        out["phase_s"] = time.perf_counter() - t_start
        if bad:
            raise AssertionError(f"serve_tp2 checks failed: {bad}")
    finally:
        emit(out)
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts


# -- ring attention on the seq axis --------------------------------------------------

#: ``train_ring2``: ``train_sp2``'s model and batch (Llama-2 7B's width at
#: ``SP2_LAYERS`` of 32 layers, bf16, batch 1 x ``SP2_SEQ``) under ring
#: attention (``RING_RULES``): each rank of ``seq=2`` holds 2048 tokens
#: and its queries, and K, V and the segment ids ``[1, 2048, 32, 128]``
#: hop to the other rank.  ``full`` remat (``flash_only`` keeps flash's
#: names, which the ring has not): the block is replayed in the backward,
#: the ring's hop with it.  Held against the world-1 run of the same
#: config (a ring of one) within ``SP2_FLOOR``; that run is held within
#: the same floors to its twin under flash attention (K1/K3), and its
#: attention at the world-1 shape to plain fp32 attention
#: (``RING_OP_RTOL``), so a fault of the chunk math that the ring of one
#: shares with the seq=2 ring still fails.
RING2_REMAT = "full"
#: The ring of one against ``mha_reference`` / ``mha_backward_reference``
#: in fp32 on the same bf16 inputs (``[1, 4096, 32, 128]``, causal): the
#: output and the gradients of q, k and v, each within this share of the
#: reference's norm.  On the CPU at ``[1, 1024, 4, 128]`` the ring reads
#: 1.7e-3 to 2.0e-3 and the planted 1% scale 1.05e-2 (``tests/
#: test_torch_ring_attention.py``, which holds both sides of this limit).
RING_OP_RTOL = 4e-3


def _ring2_config():
    from dlrover_tpu_torch.models import llama_config

    return llama_config("7b", num_layers=SP2_LAYERS, attention_impl="ring",
                        remat=RING2_REMAT, param_dtype=torch.bfloat16)


def _ring2_predicted_wire(cfg, n_params):
    """Bytes and calls one step of one rank hands the seq axis's wire:
    per layer one hop of K, V (bf16) and the segment ids (int32) in the
    forward, one in the remat replay and one in the backward, and two
    hops of the fp32 dK/dV accumulators in the backward (after the
    other rank's chunk, and home); then the gradients' all-reduce (bf16)
    and the token and loss sums, as ``train_sp2``'s."""
    tokens = SP2_SEQ // 2
    kv = 2 * tokens * cfg.num_heads * cfg.resolved_head_dim * 2 + tokens * 4
    acc = 2 * tokens * cfg.num_heads * cfg.resolved_head_dim * 4
    layers = cfg.num_layers
    return ({"seq/send": layers * (3 * kv + 2 * acc),
             "seq/all_reduce": 2 * n_params + 4 + 8},
            {"seq/send": 5 * layers, "seq/all_reduce": 3})


def _shifted_chunk(orig):
    """The planted ring fault: each chunk's key positions taken from the
    next rank's chunk (a wrong source for ``k_pos``)."""
    def chunk(q, k_c, v_c, q_pos, k_pos, *rest):
        return orig(q, k_c, v_c, q_pos, k_pos + k_pos.numel(), *rest)
    return chunk


def _scaled_scores(orig):
    """The planted shared fault: every tile's scores scaled 1% too much,
    in the forward and the backward, as a wrong scale would be on every
    rank of a ring and in the ring of one alike."""
    def scores(q, k_t, q_pos, k_pos, seg_q, seg_k, scale, causal):
        return orig(q, k_t, q_pos, k_pos, seg_q, seg_k, scale * 1.01,
                    causal)
    return scores


def _ring_op_check(cfg):
    """A ring of one at the world-1 run's shape against plain fp32
    attention on the same bf16 inputs: the norm-relative error of the
    output and of the gradients of q, k and v, then the same with the
    planted scale (``_scaled_scores``), which must fail."""
    from dlrover_tpu_torch.ops import flash_attention as fa
    from dlrover_tpu_torch.parallel import ring_attention as ra

    shape = (1, SP2_SEQ, cfg.num_heads, cfg.resolved_head_dim)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    q32, k32, v32 = q.float(), k.float(), v.float()
    o32, lse = fa.mha_reference(q32, k32, v32, causal=True)
    ref = (o32,) + tuple(fa.mha_backward_reference(
        q32, k32, v32, o32, lse, do.float(), causal=True))
    del q32, k32, v32, lse

    def errors():
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = ra.ring_attention(*leaves, causal=True)
        o.backward(do)
        got = (o.detach(),) + tuple(x.grad for x in leaves)
        return {name: float((g.float() - r).norm() / r.norm())
                for name, g, r in zip(("o", "dq", "dk", "dv"), got, ref)}

    out = {"shape": list(shape), "rtol": RING_OP_RTOL, "errors": errors()}
    scores = ra._scores
    ra._scores = _scaled_scores(scores)
    try:
        out["planted_errors"] = errors()
    finally:
        ra._scores = scores
    out["ok"] = max(out["errors"].values()) <= RING_OP_RTOL
    out["planted_caught"] = max(out["planted_errors"].values()) > RING_OP_RTOL
    del q, k, v, do, ref
    torch.cuda.empty_cache()
    return out


def _ring2_memory(group, cfg):
    """One ring attention call at the main path's shapes on this rank,
    outside remat: the bytes its backward keeps (held after the forward,
    the output aside) and the transient peak of the forward and backward
    over what the inputs take, against one chunk's fp32 scores."""
    from dlrover_tpu_torch.parallel.ring_attention import ring_attention

    shape = (1, SP2_SEQ // 2, cfg.num_heads, cfg.resolved_head_dim)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    o = ring_attention(q, k, v, causal=True, group=group)
    held = torch.cuda.memory_allocated() - base - o.numel() * o.element_size()
    o.backward(torch.ones_like(o))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    scores = 4 * shape[0] * shape[2] * shape[1] * shape[1]
    del q, k, v, o
    torch.cuda.empty_cache()
    return {"held_bytes": held, "peak_bytes": peak,
            "chunk_scores_bytes": scores, "ring_size": group.size}


def _ring2_rank(rank, out_dir):
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel import ring_attention as ra
    from dlrover_tpu_torch.parallel import rules as lr
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_lib

    cfg = _ring2_config()
    ref = torch.load(os.path.join(out_dir, "ring_ref.pt"), weights_only=False)
    mesh = build_mesh(ParallelConfig(data=1, seq=2), device_type="cuda")
    train = train_lib.build_train(
        cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
        global_batch_size=1, seq_len=SP2_SEQ, mesh=mesh, rules=lr.RING_RULES,
        device="cuda")
    state = train.init(seed=0)
    init = {k: v.clone() for k, v in state.params().items()}
    placed = train_lib.shard_batch(_sp2_batch(cfg.vocab_size), train)
    out = {"rank": rank, "local_tokens": list(placed["inputs"].shape),
           "steps": []}
    # The planted fault, in a forward at the init (step 1's loss): every
    # chunk's key positions from the next rank's chunk.
    chunk = ra._chunk_attention
    ra._chunk_attention = _shifted_chunk(chunk)
    try:
        out["planted"] = {"loss": float(train.eval_step(state,
                                                        placed)["loss"])}
    finally:
        ra._chunk_attention = chunk
    for _ in range(SP2_STEPS):
        _zero_counts()
        wire_lib.reset_counts()
        dist.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = train.step(state, placed)
        loss, norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        out["steps"].append({
            "s": time.perf_counter() - t0, "loss": loss, "grad_norm": norm,
            "tokens": float(m["tokens"]),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: v for k, v in _counts().items() if v},
            "wire_bytes": dict(wire_lib.COUNTS["axes"]),
            "wire_calls": dict(wire_lib.COUNTS["calls"])})
    out["resident_bytes"] = _resident_bytes(state)
    names, sums = _mp2_leaf_sums(train, state, ref["params"], init)
    out["leaf_sums"] = _mp2_summed(names, sums)
    out["n_params"] = sum(v.numel() for v in state.params().values())
    out["memory"] = _ring2_memory(train.parallel.sp, cfg)
    del state, train, placed, init
    torch.cuda.empty_cache()
    return out


def _noise_checks(ref, runs, limits):
    """A world-2 run (rank 0's steps and leaf sums) against the world-1
    reference: loss gaps, grad-norm gaps, the worst leaf, and the leaves
    nearer their init than half their update (a leaf whose update was
    dropped sits at its update's distance from the reference)."""
    losses = [s["loss"] for s in runs["steps"]]
    norms = [s["grad_norm"] for s in runs["steps"]]
    gaps = [abs(x - r) for x, r in zip(losses, ref["losses"])]
    ngaps = [abs(x - r) / r for x, r in zip(norms, ref["grad_norms"])]
    stats = _mp2_leaf_stats(runs["leaf_sums"])
    worst = max((v[0], k) for k, v in stats.items())
    dropped = [k for k, (err, upd) in stats.items()
               if upd > 0 and err >= 0.5 * upd]
    return {"losses": losses, "grad_norms": norms, "loss_gap": max(gaps),
            "grad_norm_rgap": max(ngaps), "worst_leaf_rel": worst,
            "leaves_nearer_init": dropped,
            "ok": (max(gaps) <= limits["loss"]
                   and max(ngaps) <= limits["norm"]
                   and worst[0] <= limits["param"] and not dropped)}


def _planted_caught(ref, planted, limits):
    """A planted run against the reference's first step: caught when its
    loss (a forward at the init: step 1's loss) or, for a planted step,
    its grad norm or a leaf after it is outside the limits."""
    out = {"loss_gap": abs(planted["loss"] - ref["losses"][0])}
    out["caught"] = out["loss_gap"] > limits["loss"]
    if "leaf_sums" in planted:
        pstats = _mp2_leaf_stats(planted["leaf_sums"])
        out["worst_leaf_rel"] = max((v[0], k) for k, v in pstats.items())
        out["grad_norm_rgap"] = abs(planted["grad_norm"]
                                    - ref["grad_norms"][0]) \
            / ref["grad_norms"][0]
        out["caught"] = (out["caught"]
                         or out["grad_norm_rgap"] > limits["norm"]
                         or out["worst_leaf_rel"][0] > limits["param"])
    return out


def train_ring2_and_check():
    """Two processes on ``cuda:0`` over a gloo group: the Llama step at
    Llama-2 7B's width on a ``seq=2`` mesh under ring attention, held
    against the world-1 run of the same config, which is held to its
    flash twin and its attention to plain fp32 attention; two planted
    faults, a wrong source of the key positions and a wrong scale.
    Returns the counted launches (none: the ring runs no kernel of the
    port)."""
    import shutil

    out_dir = os.path.join(REPO, "build", "train_ring2")
    cfg = _ring2_config()
    out = {"phase": "train_ring2",
           "model": f"llama-2 7b width (d_model 4096, 32 heads x 128, 32 KV "
                    f"heads, d_ff 11008 swiglu, vocab 32000, untied head, "
                    f"bf16 params and compute, ring attention, remat "
                    f"{RING2_REMAT}), depth cut to {SP2_LAYERS} of 32 "
                    f"layers, random weights seed 0",
           "world": "2 processes on cuda:0, gloo, seq=2 (ring attention's "
                    "hops staged through the host), RING_RULES",
           "batch": f"1 x {SP2_SEQ}, one batch re-fed", "steps": SP2_STEPS}
    t_start = time.perf_counter()
    try:
        ref = _world1_reference("train_ring2")
        out["reference"] = ref
        limits = dict(SP2_FLOOR)
        out["limits"] = limits
        results, codes = _world_run("_ring2_rank", out_dir,
                                    "ring_rank{rank}.pt", 600)
        errors = [r.get("error") for r in results if "error" in r]
        if errors or codes != [None, None]:
            for e in errors:
                print(e, flush=True)
            raise AssertionError(f"train_ring2 ranks failed (exit codes "
                                 f"{codes})")
        out["workers_s"] = time.perf_counter() - t_start
        r0, r1 = results
        run = _noise_checks(ref, r0, limits)
        wire, calls = _ring2_predicted_wire(cfg, r0["n_params"])
        launches = [s["launches"] for s in r0["steps"] + r1["steps"]]
        memory = [r["memory"] for r in (r0, r1)]
        checks = {
            # The ring of one against flash (K1/K3) and plain attention.
            "world1_matches_flash": all(ref["twin_gap"][k] <= SP2_FLOOR[k]
                                        for k in SP2_FLOOR),
            "world1_matches_plain": ref["ring_op"]["ok"],
            "matches_world1": run["ok"],
            "ranks_agree": all(a["loss"] == b["loss"] for a, b in zip(
                r0["steps"], r1["steps"])),
            "tokens": all(s["tokens"] == SP2_SEQ for s in r0["steps"]),
            "local_tokens": r0["local_tokens"] == [1, SP2_SEQ // 2],
            # The ring, not flash, computed the attention: no K1, no K3.
            "no_kernel_launched": all(x == {} for x in launches)
            and all(x == {} for x in ref["launches"]),
            "wire_bytes": all(s["wire_bytes"] == wire and
                              s["wire_calls"] == calls
                              for s in r0["steps"] + r1["steps"]),
            # The backward keeps no chunk's scores, and the device peak
            # of a call holds fewer than the ring's n of them.
            "scores_not_kept": all(m["held_bytes"] < m["chunk_scores_bytes"]
                                   for m in memory),
            "peak_below_n_chunks": all(
                m["peak_bytes"] < m["ring_size"] * m["chunk_scores_bytes"]
                for m in memory),
        }
        bad = [k for k, ok in checks.items() if not ok]
        planted = _planted_caught(ref, r0["planted"], limits)
        if not planted["caught"]:
            bad.append("planted wrong key positions passed")
        if not ref["ring_op"]["planted_caught"]:
            bad.append("planted wrong scale passed")
        out.update(
            checks=checks, run=run, planted=planted,
            step_s=[[s["s"] for s in r["steps"]] for r in (r0, r1)],
            step_peak_memory_bytes=[[s["peak_memory_bytes"] for s in
                                     r["steps"]] for r in (r0, r1)],
            resident_bytes=[r0["resident_bytes"], r1["resident_bytes"]],
            ring_memory=memory,
            wire_bytes_per_step=r0["steps"][-1]["wire_bytes"],
            wire_calls_per_step=r0["steps"][-1]["wire_calls"],
            wire_bytes_predicted=wire, wire_calls_predicted=calls,
            params=r0["n_params"])
        out["phase_s"] = time.perf_counter() - t_start
        if bad:
            raise AssertionError(f"train_ring2 checks failed: {bad}")
    finally:
        emit(out)
    shutil.rmtree(out_dir, ignore_errors=True)
    return dict.fromkeys(_counts(), 0)


# -- the pipe axis and the pipeline ---------------------------------------------------

#: ``train_pp2``: Llama-2 7B's width at ``PP2_LAYERS`` of 32 layers, bf16,
#: ``flash_only``, flash blocks 4096 (K1 and the fused K3), batch
#: ``PP2_BATCH`` x 4096 in ``PP2_MICRO`` microbatches of one row (M = 2S,
#: the reference's best operating point, ``pipeline.py:45-48``), at
#: ``pipe=2``: GPipe (2 layers a stage) and the circular schedule
#: (``pipeline_interleave=2``, 1 layer a chunk), ``SP2_STEPS`` steps each,
#: both held against one pair of world-1 runs of the same model (its
#: stages all on one process).  Limits as ``train_sp2``'s.
PP2_LAYERS = 4
PP2_BATCH = 4
PP2_MICRO = 4
PP2_SCHEDULES = (("gpipe", 1), ("circular", 2))
#: A stage's resident bytes against the world-1 run's: its parameters
#: alone are 666,914,816 of 1,071,681,536 (0.6223: two of four layers,
#: and the embedding, the head and the final norm whole); Adafactor's
#: factored state adds about 0.0002 of either.
PP2_RESIDENT_SHARE = 0.63


def _pp2_config(interleave=1):
    from dlrover_tpu_torch.models import llama_config

    return llama_config("7b", num_layers=PP2_LAYERS, attention_impl="flash",
                        remat="flash_only", param_dtype=torch.bfloat16,
                        flash_block_q=SP2_SEQ, flash_block_kv=SP2_SEQ,
                        pipeline_stages=2, num_microbatches=PP2_MICRO,
                        pipeline_interleave=interleave)


def _pp2_batch(vocab: int):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, vocab, size=(PP2_BATCH, SP2_SEQ + 1),
                          dtype=np.int64)
    return {"inputs": torch.as_tensor(tokens[:, :-1], device="cuda"),
            "targets": torch.as_tensor(tokens[:, 1:], device="cuda")}


def _pp2_predicted(cfg, train, stage):
    """What one step of stage ``stage`` does, from the shapes: ticks,
    useful ticks, handoff bytes (a microbatch's ``[1, 4096, 4096]`` bf16
    activation forward, its gradient backward), the circular relayout's
    bytes (each stage lends the layer the other runs and gets its
    gradient back), the pipe wire's bytes and calls (every hop and
    exchange one send; the replicated leaves' gradients summed, the loss
    sums, and the sums ``optax_ports.sharded_update`` completes over the
    stages' leaves), and the K1/K3 launches (one each a layer and
    microbatch: ``flash_only`` keeps flash's output)."""
    stages, v, micro = cfg.pipeline_stages, cfg.pipeline_interleave, \
        cfg.num_microbatches
    act = (PP2_BATCH // micro) * SP2_SEQ * cfg.d_model * 2
    last = stage == stages - 1
    hops = (v - 1 if last else v) * micro + (v * micro if stage else
                                             (v - 1) * micro)
    from dlrover_tpu_torch.trainer import train_lib

    shapes = train_lib._stacked_shapes(cfg)
    layer = sum(int(np.prod(s[1:])) for n, s in shapes.items()
                if n.startswith("blocks.")) * 2
    relayout = 2 * layer if v > 1 else 0
    replicated = sum(int(np.prod(s)) for n, s in shapes.items()
                     if not n.startswith("blocks.")) * 2
    wire = collections.Counter({"pipe/send": hops * act + relayout,
                                "pipe/all_reduce": replicated + 8})
    _optimizer_wire(train.layouts, train.parallel.sizes, "adafactor", wire)
    per_stage = cfg.num_layers // stages
    return {"ticks": v * micro + stages - 1, "useful_ticks": v * micro,
            "handoff_bytes": hops * act, "relayout_bytes": relayout,
            "wire_bytes": dict(wire),
            "send_calls": hops + (2 if v > 1 else 0),
            "launches": {"flash_fwd": per_stage * micro,
                         "flash_bwd_fused": per_stage * micro}}


def _rotated_microbatches(orig):
    """The planted pipeline fault: the first stage hands its microbatches
    on one tick late, each in the slot of the one before it (the last
    wraps to the first), so stage 1 works on the wrong microbatch."""
    def split(self, x, rows):
        parts = list(orig(self, x, rows))
        return parts[-1:] + parts[:-1]
    return split


def _pp2_rank(rank, out_dir):
    import torch.distributed as dist

    from dlrover_tpu_torch.parallel import pipeline
    from dlrover_tpu_torch.parallel import wire as wire_lib
    from dlrover_tpu_torch.runtime.mesh import ParallelConfig, build_mesh
    from dlrover_tpu_torch.trainer import train_lib

    ref = torch.load(os.path.join(out_dir, "pp_ref.pt"), weights_only=False)
    mesh = build_mesh(ParallelConfig(data=1, pipe=2), device_type="cuda")
    out = {"rank": rank, "runs": {}}

    def build(cfg):
        return train_lib.build_train(
            cfg, train_lib.make_optimizer("adafactor", learning_rate=TRAIN_LR),
            global_batch_size=PP2_BATCH, seq_len=SP2_SEQ, mesh=mesh,
            device="cuda")

    for name, interleave in PP2_SCHEDULES:
        cfg = _pp2_config(interleave)
        train = build(cfg)
        state = train.init(seed=0)
        init = {k: v.clone() for k, v in state.params().items()}
        placed = train_lib.shard_batch(_pp2_batch(cfg.vocab_size), train)
        run = {"steps": [], "predicted": _pp2_predicted(cfg, train, rank),
               "held_layers": sorted(int(k) for k in state.model.blocks)}
        if name == "gpipe":
            # The planted fault, in a forward at the init (step 1's
            # loss): the first stage's microbatches rotated by one slot.
            split = pipeline.PipelinedBlocks._microbatches
            pipeline.PipelinedBlocks._microbatches = _rotated_microbatches(
                split)
            try:
                out["planted"] = {"loss": float(train.eval_step(
                    state, placed)["loss"])}
            finally:
                pipeline.PipelinedBlocks._microbatches = split
        for _ in range(SP2_STEPS):
            _zero_counts()
            wire_lib.reset_counts()
            pipeline.reset_counts()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = train.step(state, placed)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            run["steps"].append({
                "s": time.perf_counter() - t0, "loss": loss,
                "grad_norm": norm, "tokens": float(m["tokens"]),
                "launches": {k: v for k, v in _counts().items() if v},
                "pipeline": dict(pipeline.COUNTS),
                "wire_bytes": dict(wire_lib.COUNTS["axes"]),
                "wire_calls": dict(wire_lib.COUNTS["calls"])})
        run["resident_bytes"] = _resident_bytes(state)
        names, sums = _mp2_leaf_sums(train, state, ref["params"], init)
        run["leaf_sums"] = _mp2_summed(names, sums)
        out["runs"][name] = run
        del state, placed, train, init
        torch.cuda.empty_cache()
    return out


def train_pp2_and_check():
    """Two processes on ``cuda:0`` over a gloo group: the Llama step at
    Llama-2 7B's width on a ``pipe=2`` mesh, GPipe and the circular
    schedule, each held against the world-1 run of the same model; a
    planted off-by-one handoff.  Returns the counted launches of the runs
    (both ranks)."""
    import shutil

    out_dir = os.path.join(REPO, "build", "train_pp2")
    cfg = _pp2_config()
    out = {"phase": "train_pp2",
           "model": f"llama-2 7b width (d_model 4096, 32 heads x 128, 32 KV "
                    f"heads, d_ff 11008 swiglu, vocab 32000, untied head, "
                    f"bf16 params and compute, flash_only, flash blocks "
                    f"{SP2_SEQ}), depth cut to {PP2_LAYERS} of 32 layers, "
                    f"2 stages, {PP2_MICRO} microbatches, random weights "
                    f"seed 0",
           "world": "2 processes on cuda:0, gloo, pipe=2 (the handoffs and "
                    "the relayout staged through the host)",
           "batch": f"{PP2_BATCH} x {SP2_SEQ}, one batch re-fed",
           "steps": SP2_STEPS}
    t_start = time.perf_counter()
    try:
        ref = _world1_reference("train_pp2")
        out["reference"] = ref
        limits = {k: max(SP2_FLOOR[k], SP2_NOISE_FACTOR * ref["noise"][k])
                  for k in SP2_FLOOR}
        out["limits"] = limits
        results, codes = _world_run("_pp2_rank", out_dir, "pp_rank{rank}.pt",
                                    600)
        errors = [r.get("error") for r in results if "error" in r]
        if errors or codes != [None, None]:
            for e in errors:
                print(e, flush=True)
            raise AssertionError(f"train_pp2 ranks failed (exit codes "
                                 f"{codes})")
        out["workers_s"] = time.perf_counter() - t_start
        r0, r1 = results
        checks, runs = {}, {}
        counts = dict.fromkeys(_counts(), 0)
        world1 = {"flash_fwd": PP2_LAYERS * PP2_MICRO,
                  "flash_bwd_fused": PP2_LAYERS * PP2_MICRO}
        checks["world1_launches"] = all(x == world1
                                        for x in ref["launches"])
        for name, _ in PP2_SCHEDULES:
            a, b = r0["runs"][name], r1["runs"][name]
            run = _noise_checks(ref, {"steps": a["steps"],
                                      "leaf_sums": a["leaf_sums"]}, limits)
            share = [r["resident_bytes"] / ref["resident_bytes"]
                     for r in (a, b)]
            for x in (a, b):
                for s in x["steps"]:
                    for k, n in s["launches"].items():
                        counts[k] += n
            counted = all(
                s["pipeline"] == dict(
                    passes=1, **{k: x["predicted"][k] for k in (
                        "ticks", "useful_ticks", "handoff_bytes",
                        "relayout_bytes")})
                and s["wire_bytes"] == x["predicted"]["wire_bytes"]
                and s["wire_calls"].get("pipe/send")
                == x["predicted"]["send_calls"]
                and s["launches"] == x["predicted"]["launches"]
                for x in (a, b) for s in x["steps"])
            checks.update({
                f"{name}.matches_world1": run["ok"],
                f"{name}.ranks_agree": all(
                    p["loss"] == q["loss"] for p, q in zip(a["steps"],
                                                           b["steps"])),
                f"{name}.stages_hold_their_layers": (
                    a["held_layers"], b["held_layers"]) == ([0, 1], [2, 3]),
                f"{name}.counts_as_predicted": counted,
                f"{name}.resident_share": max(share) <= PP2_RESIDENT_SHARE,
            })
            runs[name] = dict(
                run, step_s=[[s["s"] for s in x["steps"]] for x in (a, b)],
                resident_share=share,
                counts=[x["steps"][-1]["pipeline"] for x in (a, b)],
                wire_bytes=[x["steps"][-1]["wire_bytes"] for x in (a, b)],
                wire_calls=[x["steps"][-1]["wire_calls"] for x in (a, b)],
                launches=[x["steps"][-1]["launches"] for x in (a, b)],
                predicted=[x["predicted"] for x in (a, b)])
        bad = [k for k, ok in checks.items() if not ok]
        planted = _planted_caught(ref, r0["planted"], limits)
        if not planted["caught"]:
            bad.append("planted off-by-one handoff passed")
        out.update(checks=checks, runs=runs, planted=planted)
        out["phase_s"] = time.perf_counter() - t_start
        if bad:
            raise AssertionError(f"train_pp2 checks failed: {bad}")
    finally:
        emit(out)
    shutil.rmtree(out_dir, ignore_errors=True)
    return counts


def _ptxas_report(kernel_lib):
    """Per kernel of each library built in this process (its mangled name,
    template arguments included): the registers, the stack frame and
    spills, and any warning."""
    return {
        name: re.findall(r"Compiling entry function '[^']*'"
                         r"|Used \d+ registers[^\n]*|\d+ bytes stack[^\n]*"
                         r"|Performance Loss[^\n]*", log)
        for name, log in kernel_lib.BUILD_LOGS.items()
    }


def _after_fit_measured():
    """Once ``train_fit`` has taken its timings: the elastic run and the
    world's spawn and warm-up start beside the rest of the phase and
    ``train_dp2``'s reference (the world's first step took 10.9-12.1 s on
    the script's path)."""
    elastic_start()
    world_warm_start()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "dlrover_tpu_torch")):
        print(f"chip_smoke: the dlrover_tpu_torch package is not beside "
              f"{__file__}", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--time-tree"] and len(sys.argv) in (3, 4):
        # One reading of ``ab_in_turns``: the tree's own package, whose
        # kernels build (once) into its own build directory.
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        from dlrover_tpu_torch.ops import kernel_lib

        torch.backends.cuda.matmul.allow_tf32 = False
        only = sys.argv[3].split(",") if len(sys.argv) == 4 else None
        emit({"phase": "time_tree", "tree": sys.argv[2],
              "ms": time_kernels(only), "ptxas": _ptxas_report(kernel_lib)})
        return 0
    sys.path.insert(0, REPO)
    from dlrover_tpu_torch.ops import kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "allow_tf32": False,
    })

    build_s = kernel_lib.build_all()
    for name in kernel_lib.sources():
        kernel_lib.load(name)
    emit({"phase": "build", "seconds": build_s,
          "ptxas": _ptxas_report(kernel_lib),
          "build_dir": os.path.relpath(kernel_lib.BUILD_DIR, REPO)})

    if sys.argv[1:] == ["--flags-ab"]:
        flags_ab()
        print(smi, flush=True)
        return 0
    flash_only = sys.argv[1:] == ["--flash"]
    if sys.argv[1:] == ["--gmm"]:
        gmm_only()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--elastic"]:
        elastic_run_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--fit"]:
        train_fit_and_check()
        elastic_run_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--fit-gate"]:
        # The train phase's yardstick, then the elastic loop's phase
        # FIT_GATE_RUNS times: every run's gate is read.
        train_and_check()
        failed = []
        for run in range(FIT_GATE_RUNS):
            try:
                train_fit_and_check()
            except AssertionError as e:
                failed.append((run, str(e)))
        emit({"phase": "fit_gate", "runs": FIT_GATE_RUNS, "failed": failed})
        elastic_run_and_check()
        print(smi, flush=True)
        return 1 if failed else 0
    if sys.argv[1:] == ["--dp"]:
        train_and_check()
        train_fit_and_check(on_measured=_after_fit_measured)
        train_dp2_and_check()
        elastic_run_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--measure"]:
        serve_and_check()
        train_and_check()
        train_fit_and_check(on_measured=_after_fit_measured)
        train_dp2_and_check()
        elastic_run_and_check()
        measure_report()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--mp"]:
        train_mp2_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--ep"]:
        train_ep2_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--sp"]:
        train_sp2_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--serve-tp"]:
        serve_tp_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--ring"]:
        train_ring2_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--pp"]:
        train_pp2_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--opts"]:
        train_opts_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--serve"]:
        serve_and_check()
        serve_spec_and_check()
        serve_fleet_and_check()
        serve_moe_and_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--digest"]:
        digest_kernel_check(torch.Generator(device="cuda").manual_seed(0))
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--repairs"]:
        gen = torch.Generator(device="cuda").manual_seed(0)
        gmm_kernel_checks(gen)
        pad_flash_checks(gen)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--pin"]:
        pin_kernel_check(torch.Generator(device="cuda").manual_seed(0))
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--norm"]:
        norm_kernel_checks(torch.Generator(device="cuda").manual_seed(0))
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--quant"]:
        quant_kernel_checks(torch.Generator(device="cuda").manual_seed(0))
        quant_code_check()
        print(smi, flush=True)
        return 0
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) >= 3:
        trees, only = sys.argv[2:], None
        if "--only" in trees:
            at = trees.index("--only")
            trees, only = trees[:at], trees[at + 1].split(",")
        ab_in_turns(trees, only)
        print(smi, flush=True)
        return 0
    if sys.argv[1:] and not flash_only:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [check_kernel_case(c, gen) for c in KERNEL_CASES]
    emit({"phase": "kernel_checks",
          "tolerance": {"o_atol": O_ATOL, "o_rtol": O_RTOL,
                        "lse_atol": LSE_ATOL},
          "cases": cases})
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"flash kernel disagrees on {bad}")

    bwd_cases = [check_bwd_case(c, gen) for c in BWD_CASES]
    emit({"phase": "bwd_kernel_checks",
          "tolerance": {"row": BWD_ROW_TOL, "norm": BWD_NORM_TOL,
                        "repro_dq_row": REPRO_DQ_ROW_TOL},
          "library": "F.scaled_dot_product_attention backward via "
                     "torch.autograd.grad: forward and backward in one "
                     "CUDA graph less the forward's graph replay",
          "cases": bwd_cases})
    bad = [c["case"] for c in bwd_cases if not c["ok"]]
    if bad:
        raise AssertionError(f"flash backward kernels disagree on {bad}")
    if flash_only:
        print(smi, flush=True)
        return 0

    pad_flash_checks(gen)
    gmm_cases = gmm_kernel_checks(gen)
    norm_cases = norm_kernel_checks(gen)
    quant_cases = quant_kernel_checks(gen)
    quant_code_check()
    pin_check = pin_kernel_check(gen)
    embed_check = embed_kernel_checks(gen)
    digest_check = digest_kernel_check(gen)

    mha_dispatch()
    paths = {}
    paths["serve"], paths["serve_faults"] = serve_and_check()
    paths["serve_spec"] = serve_spec_and_check()
    paths["serve_fleet"] = serve_fleet_and_check()
    paths["serve_moe"], moe_decode_gmm = serve_moe_and_check()
    paths["train"], adafactor_state_bytes = train_and_check()
    paths["flash_ckpt"] = flash_ckpt_and_check()
    paths["train_fit"] = train_fit_and_check(on_measured=_after_fit_measured)
    paths["train_dp2"] = train_dp2_and_check(world1_refs=True)
    paths["elastic_run"] = elastic_run_and_check()
    paths["train_mp2"] = train_mp2_and_check()
    paths["train_ep2"] = train_ep2_and_check()
    paths["train_sp2"] = train_sp2_and_check()
    paths["serve_tp2"] = serve_tp_and_check()
    paths["train_ring2"] = train_ring2_and_check()
    paths["train_pp2"] = train_pp2_and_check()
    _world_stop()
    paths["train_opts"] = train_opts_and_check()
    paths["train_split"] = train_split_and_check()
    train_parity()
    paths["train_moe"] = train_moe_and_check()
    train_moe_parity()
    paths.update(train_lowbit_and_check(adafactor_state_bytes))
    train_lowbit_parity()
    paths["train_rec"] = train_rec_and_check()
    measure_report()

    def launches(name):
        return sum(p[name] for p in paths.values())

    def by_path(name):
        return {path: p[name] for path, p in paths.items()}

    for name in _counts():
        if launches(name) == 0:
            raise AssertionError(f"{name} was never launched on a path")

    def shape(c):
        return {k: c[k] for k in ("b", "s", "hq", "hkv", "d", "causal")}

    fwd = next(c for c in cases if c["case"] == TRAIN_CASE)
    fused = next(c for c in bwd_cases if c["case"] == BWD_FUSED_CASE)
    split = next(c for c in bwd_cases if c["case"] == BWD_SPLIT_CASE)
    src = "dlrover_tpu_torch/ops/csrc/"
    entries = [dict(
        name="flash_fwd", route="cuda", source=src + "flash_attention.cu",
        replaces="dlrover_tpu/ops/flash_attention.py:58",
        launches=launches("flash_fwd"),
        launches_by_path=by_path("flash_fwd"),
        max_abs_err=max(c["max_abs_err"] for c in cases),
        ms=fwd["ms"], plain_ms=fwd["plain_ms"], bound_ms=fwd["bound_ms"],
        bound_by=fwd["bound_by"], library_ms=fwd["library_ms"],
        shape=shape(fwd),
    )]
    for name, replaces, case, key in (
            ("flash_bwd_fused", 318, fused, "fused"),
            ("flash_bwd_dq", 246, split, "dq"),
            ("flash_bwd_dkv", 278, split, "dkv")):
        path = "fused" if key == "fused" else "split"
        outs = {"fused": ("dq", "dk", "dv"), "dq": ("dq",),
                "dkv": ("dk", "dv")}[key]
        entries.append(dict(
            name=name, route="cuda", source=src + "flash_attention_bwd.cu",
            replaces=f"dlrover_tpu/ops/flash_attention.py:{replaces}",
            launches=launches(name), launches_by_path=by_path(name),
            max_abs_err=max(c[f"{path}_{o}"]["max_abs"]
                            for c in bwd_cases for o in outs),
            ms=case[key]["ms"], plain_ms=case[key]["plain_ms"],
            bound_ms=case[key]["bound_ms"], bound_by=case[key]["bound_by"],
            # SDPA's backward computes dq, dk and dv in one call: no
            # library call computes dq or (dk, dv) alone.
            library_ms=case["library_ms"] if key == "fused" else None,
            sdpa_whole_backward_ms=case["library_ms"], shape=shape(case),
        ))
    gmm = next(c for c in gmm_cases if c["case"] == GMM_SLICE_CASE)
    for name, replaces, product, kinds in (
            ("gmm_fwd", 31, "fwd_wi", ("fwd", "dx")),
            ("gmm_dw", 90, "dw_wi", ("dw",))):
        t = gmm["timed"][product]
        entries.append(dict(
            name=name, route="cuda", source=src + "grouped_matmul.cu",
            replaces=f"dlrover_tpu/ops/grouped_matmul.py:{replaces}",
            launches=launches(name), launches_by_path=by_path(name),
            max_abs_err=max(c[p]["max_abs"] for c in gmm_cases
                            for p in GMM_PRODUCTS
                            if p in c and p.split("_")[0] in kinds),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library="torch._grouped_mm (CUDA-graph replay)",
            shape={"product": product, "rows": gmm["rows"], "d": gmm["d"],
                   "f": gmm["f"], "experts": MOE_EXPERTS,
                   "group_sizes": gmm["group_sizes"]},
            products={p: {k: v[k] for k in (
                "ms", "plain_ms", "bound_ms", "library_ms",
                "library_eager_ms", "host_us")}
                for p, v in gmm["timed"].items()},
            **({"serve_decode_step": moe_decode_gmm} if name == "gmm_fwd"
               else {}),
        ))
    norm = next(c for c in norm_cases if c["case"] == NORM_TRAIN_CASE)
    t = norm["timed"]
    entries.append(dict(
        name="norm_bwd", route="cuda", source=src + "fused_norm.cu",
        replaces="dlrover_tpu/ops/fused_norm.py:43",
        launches=launches("norm_bwd"), launches_by_path=by_path("norm_bwd"),
        max_abs_err=max(c["max_abs_err"] for c in norm_cases),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        library=t.get("library"),
        shape={k: norm[k] for k in ("n", "d", "dtype", "center")},
        rmsnorm_ms=next(c for c in norm_cases
                        if c["case"] == "train_rmsnorm")["timed"]["ms"],
    ))
    quant = next(c for c in quant_cases if c["case"] == QUANT_LEAF_CASE)
    for name, replaces, err in (
            ("quantize", 53, lambda c: c["quantize"]["codes_max_levels_off"]),
            ("dequantize", 61, lambda c: c["dequantize"]["max_abs_err"]),
            ("q8_adam", 120, lambda c: c["q8_adam"]["upd_max_abs_err"]),
            ("q4_adam", 309, lambda c: c["q4_adam"]["upd_max_abs_err"])):
        t = quant["timed"][name]
        entries.append(dict(
            name=name, route="cuda", source=src + "quantization.cu",
            replaces=f"dlrover_tpu/ops/quantization.py:{replaces}",
            launches=launches(name), launches_by_path=by_path(name),
            max_abs_err=float(max(err(c) for c in quant_cases)),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"],
            # No one PyTorch call computes this function.
            library_ms=None, gbytes_per_s=t["gbytes_per_s"],
            shape={"leaf": quant["shape"], "dtype": quant["dtype"],
                   "blocks": quant["blocks"]},
        ))
    t = pin_check["timed"]
    entries.append(dict(
        name="pin_copy", route="cuda", source=src + "layout_pin.cu",
        replaces="dlrover_tpu/ops/layout_pin.py:30",
        launches=launches("pin_copy"), launches_by_path=by_path("pin_copy"),
        max_abs_err=pin_check["max_abs_err"],
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        library=t["library"], transposed_ms=t["transposed_ms"],
        pairs=t["pairs"],
        shape={"x": [TRAIN_BATCH, TRAIN_SEQ, 1600], "dtype": "bf16"},
    ))
    for name, replaces, kind in (("embed_gather", 67, "gather"),
                                 ("embed_scatter", 72, "scatter")):
        t = embed_check["timed"][kind]
        _, capacity, dim, n, real = next(
            c for c in EMBED_CASES if c[0] == EMBED_SLICE_CASE)
        entries.append(dict(
            name=name, route="cuda", source=src + "embedding_rows.cu",
            replaces=f"dlrover_tpu/embedding/kernels.py:{replaces}",
            launches=launches(name), launches_by_path=by_path(name),
            max_abs_err=embed_check["max_abs_err"],
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
            library=t["library"], wrapper_eager_ms=t["wrapper_eager_ms"],
            shape={"cache": [capacity, dim], "slots": n, "real": real,
                   "dtype": "fp32"},
        ))
    t = digest_check["timed"]
    entries.append(dict(
        name="digest_sums", route="cuda", source=src + "byte_sums.cu",
        # The reference's jit-fused reduction (no Pallas kernel).
        replaces="dlrover_tpu/trainer/state_digest.py:39",
        launches=launches("digest_sums"),
        launches_by_path=by_path("digest_sums"),
        max_abs_err=max(digest_check[c]["max_abs_err"]
                        for c in ("params", "odd")),
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t["library_ms"],
        library=t["library"], host_ms=t["host_ms"],
        shape={"leaves": digest_check["leaves"],
               "bytes": digest_check["bytes"]},
    ))
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        _elastic_stop()
        _world_stop()
    sys.exit(code)
